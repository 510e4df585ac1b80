"""The Mamba2 SSD chunk scan (K6) in the port against the reference.

The port's wrapper on CPU tensors runs its plain version
(``ssd_chunk_scan_torch``, the chunked einsum form in float32); it is
held against the reference's ``ops.ssd_chunk_scan`` (the Pallas kernel
in interpret mode, as ``tests/test_kernels.py`` runs it) and its
sequential oracle ``ref.ssd_scan_ref`` on the same numpy inputs, at the
reference test's shapes and tolerance: 5e-5 of max |y| (the same float32
sums in another order, and the chunked form's decays against the
oracle's step-by-step products).  The CUDA kernel itself runs only on
the card, where ``chip_smoke.py`` holds it against the plain version.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.kernels import ref
from repro.kernels import ssd_chunk_scan as ref_ssd_chunk_scan
from repro_torch.kernels import ssd_scan as K6

TOL = 5e-5       # of max |y|, the reference test's


def _inputs(B, S, H, hd, G, N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    B_ = (rng.standard_normal((B, S, G, N)) * 0.5).astype(np.float32)
    C_ = (rng.standard_normal((B, S, G, N)) * 0.5).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((B, S, H)), 0).astype(np.float32)
    A_log = np.zeros(H, np.float32)      # a = -1, as the reference's test
    return x, B_, C_, dt, A_log


def _oracle(x, B_, C_, dt, A_log):
    """ref.ssd_scan_ref over (B*H) rows, groups expanded, dt folded in."""
    B, S, H, hd = x.shape
    G, N = B_.shape[2:]
    a = -np.exp(A_log)
    xdt = (x * dt[..., None]).transpose(0, 2, 1, 3).reshape(B * H, S, hd)
    Bf = np.repeat(B_, H // G, 2).transpose(0, 2, 1, 3).reshape(B * H, S, N)
    Cf = np.repeat(C_, H // G, 2).transpose(0, 2, 1, 3).reshape(B * H, S, N)
    da = (dt * a).transpose(0, 2, 1).reshape(B * H, S)
    y = ref.ssd_scan_ref(*(jnp.asarray(v) for v in (xdt, Bf, Cf, da)))
    return np.asarray(y).reshape(B, H, S, hd).transpose(0, 2, 1, 3)


def _port(inputs, chunk, **kw):
    return K6.ssd_chunk_scan(*(torch.from_numpy(a) for a in inputs),
                             chunk=chunk, **kw)


def _rel(got, want):
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("chunk", [32, 64, 128])
@pytest.mark.parametrize("B,S,H,hd,G,N", [
    (2, 256, 4, 32, 2, 16),
    (1, 128, 2, 64, 1, 32),
])
def test_plain_version_matches_pallas_and_oracle(B, S, H, hd, G, N, chunk):
    inputs = _inputs(B, S, H, hd, G, N)
    want = _oracle(*inputs)
    pallas = np.asarray(ref_ssd_chunk_scan(*(jnp.asarray(a) for a in inputs),
                                           chunk=chunk))
    got = _port(inputs, chunk)
    assert got.dtype == torch.float32 and got.shape == (B, S, H, hd)
    assert _rel(got.numpy(), want) < TOL
    assert _rel(got.numpy(), pallas) < TOL


def test_chunk_invariance():
    """The same scan whatever the chunk (associativity of the scan)."""
    inputs = _inputs(1, 256, 2, 32, 1, 16, seed=1)
    assert _rel(_port(inputs, 32).numpy(), _port(inputs, 256).numpy()) < TOL


def test_chunk_256_with_a_log_zero_stays_finite():
    """FULL's chunk with ``A_log = 0`` (a = -1) and dt = softplus(N(0, 1)):
    cum falls by about 200 within a chunk, so exp(cum_t - cum_s) above
    the diagonal is inf.  The masked half is never used: the output is
    finite and still the sequential scan's."""
    inputs = _inputs(1, 512, 2, 64, 1, 32, seed=2)
    x, B_, C_, dt, A_log = inputs
    assert (dt[0, :256, 0] * np.exp(A_log[0])).sum() > 120
    got = _port(inputs, 256).numpy()
    assert np.isfinite(got).all()
    assert _rel(got, _oracle(*inputs)) < TOL


def test_ragged_chunk_and_out_dtype():
    """S < chunk takes the whole sequence as one chunk (``min(chunk, S)``);
    ``out_dtype`` gives the float32 sums of bf16 inputs before the final
    rounding; a chunk that does not divide S raises."""
    inputs = _inputs(1, 100, 2, 64, 1, 32, seed=3)
    want = _oracle(*inputs)
    assert _rel(_port(inputs, 256).numpy(), want) < TOL
    bf = [torch.from_numpy(a).bfloat16() for a in inputs]
    y16 = K6.ssd_chunk_scan(*bf, chunk=256)
    y32 = K6.ssd_chunk_scan(*bf, chunk=256, out_dtype=torch.float32)
    assert y16.dtype == torch.bfloat16 and y32.dtype == torch.float32
    assert torch.equal(y32.bfloat16(), y16)
    with pytest.raises(ValueError, match="does not divide"):
        _port(inputs, 64)


def test_gradient_guard_raises():
    """Neither the reference's kernel nor the port's has a gradient: the
    wrapper refuses a call autograd would have to differentiate, and runs
    one under ``torch.no_grad()``."""
    ts = [torch.from_numpy(a) for a in _inputs(1, 128, 2, 32, 1, 16)]
    for t in ts:
        t.requires_grad_(True)
        with pytest.raises(RuntimeError, match="no gradient"):
            K6.ssd_chunk_scan(*ts, chunk=64)
        with torch.no_grad():
            K6.ssd_chunk_scan(*ts, chunk=64)
        t.requires_grad_(False)
    K6.ssd_chunk_scan(*ts, chunk=64)


def test_cpu_tensors_take_the_plain_path(monkeypatch):
    def no_kernel(*a):
        raise AssertionError("the CUDA kernel was reached from CPU tensors")
    monkeypatch.setattr(K6, "_launch", no_kernel)
    before = K6.ssd_chunk_scan.launches
    _port(_inputs(1, 128, 2, 32, 1, 16), 64)
    assert K6.ssd_chunk_scan.launches == before


def _fake_cuda(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="cuda")


@pytest.mark.parametrize("dtype,hd,N,chunk,error,match", [
    # passes the checks, then cannot build the kernel here
    (torch.bfloat16, 64, 128, 256, RuntimeError, "nvcc"),
    (torch.float32, 64, 128, 256, RuntimeError, "nvcc"),
    (torch.float16, 64, 128, 256, TypeError, "bfloat16"),
    (torch.bfloat16, 96, 128, 256, ValueError, "head_dim"),
    (torch.bfloat16, 64, 256, 256, ValueError, "d_state"),
    (torch.bfloat16, 64, 128, 96, ValueError, "does not divide"),
])
def test_cuda_request_launches_or_raises_never_falls_back(
        monkeypatch, dtype, hd, N, chunk, error, match):
    """On a CUDA tensor the wrapper goes to the kernel and nowhere else:
    with no card and no nvcc that is an error, never the plain path."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without a card")

    def no_fallback(*a, **kw):
        raise AssertionError("fell back to the plain version")
    monkeypatch.setattr(K6, "ssd_chunk_scan_torch", no_fallback)
    monkeypatch.setattr(K6, "ssd_chunked", no_fallback)
    before = K6.ssd_chunk_scan.launches
    B, S, H, G = 2, 512, 8, 2
    with FakeTensorMode():
        args = (_fake_cuda((B, S, H, hd), dtype),
                _fake_cuda((B, S, G, N), dtype),
                _fake_cuda((B, S, G, N), dtype),
                _fake_cuda((B, S, H), dtype), _fake_cuda((H,), dtype))
        with pytest.raises(error, match=match):
            K6.ssd_chunk_scan(*args, chunk=chunk)
    assert K6.ssd_chunk_scan.launches == before
