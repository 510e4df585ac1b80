"""The Mamba2 SSD chunk scan (K6) in the port against the reference.

The port's wrapper on CPU tensors runs its plain version
(``ssd_chunk_scan_torch``, the chunked einsum form in float32); it is
held against the reference's ``ops.ssd_chunk_scan`` (the Pallas kernel
in interpret mode, as ``tests/test_kernels.py`` runs it) and its
sequential oracle ``ref.ssd_scan_ref`` on the same numpy inputs, at the
reference test's shapes and tolerance: 5e-5 of max |y| (the same float32
sums in another order, and the chunked form's decays against the
oracle's step-by-step products).  The CUDA kernel itself runs only on
the card, where ``chip_smoke.py`` holds it against the plain version;
here its arithmetic -- every product taken on bf16 parts, as the tensor
cores take it -- is emulated in torch and held against float64, and its
wrapper's arguments are checked through a stand-in kernel.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

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


# ---------------------------------------------------------------------------
# The kernel's arithmetic: bf16 operand parts on the tensor cores
# ---------------------------------------------------------------------------


def _parts(t, n):
    """t (float32) as n bf16 parts, each the rounding of what the earlier
    parts leave (the kernel's ``put_parts`` / ``split_words``)."""
    out, rest = [], t.float()
    for _ in range(n):
        p = rest.bfloat16().float()
        out.append(p)
        rest = rest - p
    return out


def _products(eq, a_parts, b_parts, n_split):
    """sum of einsum(a_i, b_j) over i + j < n_split, in float32 (the
    products of bf16 parts are exact in the tensor cores' float32
    accumulator)."""
    acc = 0
    for k in reversed(range(n_split)):
        for i, a in enumerate(a_parts):
            if 0 <= k - i < len(b_parts):
                acc = acc + torch.einsum(eq, a, b_parts[k - i])
    return acc


def _kernel_emulated(x, B_, C_, dt, A_log, c, n_split=None):
    """The kernel's three phases in torch, with every product taken as it
    takes it: inputs arriving in bf16 as one part, float32 inputs and the
    float32 operands the kernel forms (x dt decay, W, prev) in
    ``n_split`` parts (2 for bf16 inputs, 3 for float32, as ``Prec`` in
    ``csrc/ssd_scan.cu``).  G = 1."""
    Bsz, S, H, hd = x.shape
    N = B_.shape[-1]
    nc = S // c
    bf16_in = x.dtype == torch.bfloat16
    n_split = n_split or (2 if bf16_in else 3)
    n_in = 1 if bf16_in else n_split
    xf = x.float().reshape(Bsz, nc, c, H, hd)
    Bf = B_.float().reshape(Bsz, nc, c, 1, N)
    Cf = C_.float().reshape(Bsz, nc, c, 1, N)
    dtf = dt.float().reshape(Bsz, nc, c, H)
    cum = torch.cumsum(dtf * -torch.exp(A_log.float()), 2)
    Bp, Cp, xp = _parts(Bf, n_in), _parts(Cf, n_in), _parts(xf, n_in)
    # phase 1: chunk states
    dec = dtf * torch.exp(cum[:, :, -1:] - cum)
    s_chunk = _products("bzshd,bzsgn->bzhdn", _parts(xf * dec[..., None],
                                                     n_split), Bp, n_split)
    # phase 3, intra-chunk: exp only where s <= t
    S_ = _products("bztgn,bzsgn->bzts", Cp, Bp, n_split)
    tri = torch.ones(c, c, dtype=torch.bool).tril()
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    W = torch.where(tri[None, None, :, :, None],
                    S_[..., None] * torch.exp(torch.where(
                        tri[None, None, :, :, None], diff, 0.0))
                    * dtf[:, :, None], 0.0)
    y = _products("bztsh,bzshd->bzthd", _parts(W, n_split), xp, n_split)
    # phase 2, then the inter-chunk term
    prev = torch.zeros(Bsz, H, hd, N)
    for z in range(1, nc):
        prev = prev * torch.exp(cum[:, z - 1, -1])[..., None, None] \
            + s_chunk[:, z - 1]
        inter = _products("btgn,bhdn->bthd", [p[:, z] for p in Cp],
                          _parts(prev, n_split), n_split)
        y[:, z] += inter * torch.exp(cum[:, z])[..., None]
    return y.reshape(Bsz, S, H, hd)


def _float64_scan(x, B_, C_, dt, A_log):
    """The sequential scan in float64 (``ref.ssd_scan_ref``'s recurrence)."""
    Bsz, S, H, hd = x.shape
    a = -np.exp(A_log.double().numpy())
    xd, Bd, Cd, dtd = (t.double().numpy() for t in (x, B_, C_, dt))
    state = np.zeros((Bsz, H, hd, B_.shape[-1]))
    y = np.zeros((Bsz, S, H, hd))
    for t in range(S):
        state = (state * np.exp(dtd[:, t] * a)[..., None, None]
                 + (xd[:, t] * dtd[:, t, :, None])[..., None]
                 * Bd[:, t, 0][:, None, None, :])
        y[:, t] = np.einsum("bhdn,bn->bhd", state, Cd[:, t, 0])
    return y


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_operand_split_holds_the_tolerance(dtype):
    """The kernel's products on bf16 tensor cores, emulated: with a
    float32 operand split into two bf16 parts (bf16 inputs) or every
    operand into three (float32 inputs), the scan holds 5e-5 of max |y|
    against float64 at FULL's chunk 256 and A_log = 0 (cum falls by about
    180 within a chunk).  One part -- plain bf16, no better than plain
    TF32 -- misses it by far, which is why the kernel splits."""
    x, B_, C_, dt, A_log = (torch.from_numpy(a).to(dtype) if i < 4
                            else torch.from_numpy(a)
                            for i, a in enumerate(_inputs(1, 768, 2, 64, 1,
                                                          128, seed=4)))
    want = _float64_scan(x, B_, C_, dt, A_log)
    got = _kernel_emulated(x, B_, C_, dt, A_log, 256).double().numpy()
    assert np.isfinite(got).all()
    assert _rel(got, want) < TOL
    one_part = _kernel_emulated(x, B_, C_, dt, A_log, 256, n_split=1)
    assert _rel(one_part.double().numpy(), want) > 10 * TOL


class _Stream:
    cuda_stream = 0


class _ScalarReads(TorchDispatchMode):
    """Records every device-to-host scalar read: each is an
    ``aten._local_scalar_dense`` call."""

    def __init__(self):
        super().__init__()
        self.reads = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.reads += func is torch.ops.aten._local_scalar_dense.default
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("S,chunk", [(512, 128), (200, 256)])
def test_launch_passes_a_workspace_sized_from_shapes(monkeypatch, S, chunk):
    """The wrapper hands the kernel one float32 workspace of
    ``workspace_floats`` (a state and a cum_end for every chunk but each
    sequence's last; none for a single chunk), allocated without a host
    sync, and counts one launch a call."""
    calls = []

    def fake_kernel(*args):
        calls.append(args)
        return 0
    monkeypatch.setattr(K6, "_kernel", lambda: fake_kernel)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: _Stream())
    monkeypatch.setattr(K6.ssd_chunk_scan, "launches", 0)
    B, H, hd, G, N = 2, 4, 64, 2, 128
    ts = [torch.from_numpy(a).bfloat16() if i < 4 else torch.from_numpy(a)
          for i, a in enumerate(_inputs(B, S, H, hd, G, N))]
    with _ScalarReads() as syncs:
        K6._launch(*ts, min(chunk, S), torch.bfloat16)
    assert syncs.reads == 0 and K6.ssd_chunk_scan.launches == 1
    (args,) = calls
    nc = S // min(chunk, S)
    want = B * H * (nc - 1) * (hd * N + 1)
    assert K6.workspace_floats(B, S, H, hd, N, min(chunk, S)) == want
    assert args[7] == want and (args[6] != 0) == (want > 0)
    assert args[8:15] == (B, S, H, hd, G, N, min(chunk, S))
