"""Flash-decode in the port against the reference.

The port's wrapper on CPU tensors runs its plain version
(``flash_decode_torch``); it is held against the reference's
``ops.flash_decode`` (the Pallas kernel in interpret mode, as
``tests/test_flash_decode.py`` runs it) and its ``ref.flash_decode_ref``
oracle on the same numpy inputs.  The CUDA kernel itself runs only on
the card, where ``chip_smoke.py`` holds it against the plain version.
"""
import torch_threads  # noqa: F401  (caps torch's threads under xdist)
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.kernels import flash_decode as ref_flash_decode
from repro.kernels import ref
from repro_torch.kernels import flash_decode as fd

# float32 throughout; the sums run in another order in each version
TOL = 1e-5


def _inputs(B, L, H, Hkv, D, seed=0, lengths=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((B, L, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, L, Hkv, D)).astype(np.float32)
    if lengths is None:
        # ragged, with the 1 and full-L extremes
        lengths = np.linspace(1, L, B).round()
    return q, k, v, np.asarray(lengths, np.int32)


def _oracle(q, k, v, lengths):
    """ref.flash_decode_ref over (B*H) rows with the GQA heads expanded."""
    B, H, D = q.shape
    L, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    kf = np.repeat(k, G, 2).transpose(0, 2, 1, 3).reshape(B * H, L, D)
    vf = np.repeat(v, G, 2).transpose(0, 2, 1, 3).reshape(B * H, L, D)
    lf = np.repeat(lengths, H)
    out = ref.flash_decode_ref(jnp.asarray(q.reshape(B * H, D)),
                               jnp.asarray(kf), jnp.asarray(vf),
                               jnp.asarray(lf))
    return np.asarray(out).reshape(B, H, D)


def _port(q, k, v, lengths):
    return fd.flash_decode(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v),
                           torch.from_numpy(lengths)).numpy()


@pytest.mark.parametrize("B,L,H,Hkv,D", [
    (3, 128, 4, 4, 64),      # G = 1 (the qwen family)
    (4, 96, 8, 2, 64),       # G = 4, L not a multiple of the 128 block
    (2, 100, 8, 2, 128),     # G = 4, head_dim 128, ragged tail
    (3, 64, 6, 1, 128),      # MQA, G = 6
])
def test_plain_version_matches_pallas_and_oracle(B, L, H, Hkv, D):
    q, k, v, lens = _inputs(B, L, H, Hkv, D)
    got = _port(q, k, v, lens)
    pallas = np.asarray(ref_flash_decode(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), jnp.asarray(lens)))
    np.testing.assert_allclose(got, pallas, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, _oracle(q, k, v, lens), rtol=TOL,
                               atol=TOL)


def test_length_one_and_stale_tail_are_ignored():
    """A slot attends over exactly [0, length): garbage past it (a freed
    slot's stale tail) changes nothing, and length 1 (or a clamped 0)
    attends to position 0 alone."""
    q, k, v, _ = _inputs(2, 64, 4, 2, 64, seed=1)
    lens = np.array([1, 40], np.int32)
    base = _port(q, k, v, lens)
    k2, v2 = k.copy(), v.copy()
    k2[0, 1:], v2[0, 1:] = 7.0, -3.0
    k2[1, 40:], v2[1, 40:] = 1e4, -1e4
    np.testing.assert_array_equal(_port(q, k2, v2, lens), base)
    # length 1: the output is position 0's value row, per query head
    np.testing.assert_allclose(base[0], np.repeat(v[0, 0], 2, 0),
                               rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(
        _port(q, k, v, np.array([0, 40], np.int32)), base)


def test_cpu_tensors_take_the_plain_path(monkeypatch):
    def no_kernel(*a):
        raise AssertionError("the CUDA kernel was reached from CPU tensors")
    monkeypatch.setattr(fd, "_launch", no_kernel)
    before = fd.flash_decode.launches
    q, k, v, lens = _inputs(2, 32, 4, 4, 64)
    _port(q, k, v, lens)
    assert fd.flash_decode.launches == before


def _fake_cuda(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="cuda")


@pytest.mark.parametrize("dtype,head_dim,error,match", [
    # passes the checks, then cannot build the kernel here
    (torch.bfloat16, 128, RuntimeError, "nvcc"),
    (torch.float32, 128, TypeError, "bfloat16"),     # bf16 only
    (torch.bfloat16, 96, ValueError, "head_dim"),    # 64 and 128 only
])
def test_cuda_request_launches_or_raises_never_falls_back(
        monkeypatch, dtype, head_dim, error, match):
    """On a CUDA tensor the wrapper goes to the kernel and nowhere else:
    with no card and no nvcc that is an error, never the plain path."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without a card")

    def no_fallback(*a):
        raise AssertionError("fell back to the plain version")
    monkeypatch.setattr(fd, "flash_decode_torch", no_fallback)
    before = fd.flash_decode.launches
    with FakeTensorMode():
        q = _fake_cuda((2, 4, head_dim), dtype)
        k = _fake_cuda((2, 16, 4, head_dim), dtype)
        lens = torch.ones(2, dtype=torch.int32, device="cuda")
        with pytest.raises(error, match=match):
            fd.flash_decode(q, k, k, lens)
    assert fd.flash_decode.launches == before
