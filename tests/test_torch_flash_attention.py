"""Flash attention (K4) in the port against the reference.

The port's wrapper on CPU tensors runs its plain version
(``flash_attention_torch``); it is held against the reference's
``ops.flash_attention`` (the Pallas kernel in interpret mode, as
``tests/test_kernels.py`` runs it) and its ``ref.flash_attention_ref``
oracle on the same numpy inputs.  The CUDA kernel itself runs only on
the card, where ``chip_smoke.py`` holds it against the plain version.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as ref_config
from repro.kernels import flash_attention as ref_flash_attention
from repro.kernels import ref
from repro.models import build_model as ref_build
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import build_model
from repro_torch.models import layers as L

# float32: the same sums in another order; bfloat16: the output's
# rounding (one bf16 step at |out| ~ 2) on top of it, the tolerance of K1
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _inputs(B, Sq, Skv, H, Hkv, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, D)).astype(np.float32),
            rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32))


def _oracle(q, k, v, causal):
    """ref.flash_attention_ref over (B*H) rows with the GQA heads
    expanded."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qf = q.transpose(0, 2, 1, 3).reshape(B * H, Sq, D)
    kf = np.repeat(k, G, 2).transpose(0, 2, 1, 3).reshape(B * H, Skv, D)
    vf = np.repeat(v, G, 2).transpose(0, 2, 1, 3).reshape(B * H, Skv, D)
    out = ref.flash_attention_ref(jnp.asarray(qf), jnp.asarray(kf),
                                  jnp.asarray(vf), causal=causal)
    return np.asarray(out).reshape(B, H, Sq, D).transpose(0, 2, 1, 3)


def _port(q, k, v, causal, dtype=torch.float32):
    out = fa.flash_attention(*(torch.from_numpy(a).to(dtype)
                               for a in (q, k, v)), causal=causal)
    assert out.dtype == dtype
    return out.float().numpy()


@pytest.mark.parametrize("S,H,Hkv,D,causal", [
    (128, 4, 4, 64, True),      # G = 1, the qwen family
    (256, 4, 4, 128, True),
    (128, 8, 4, 128, True),     # G = 2
    (256, 8, 2, 64, True),      # G = 4
    (128, 4, 4, 128, False),
    (256, 8, 4, 64, False),
    (128, 8, 2, 128, False),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_pallas_and_oracle(S, H, Hkv, D, causal,
                                                 dtype):
    q, k, v = _inputs(2, S, S, H, Hkv, D)
    tdt = getattr(torch, dtype)
    got = _port(q, k, v, causal, tdt)
    # both packages see the same bf16-rounded inputs
    q, k, v = (torch.from_numpy(a).to(tdt).float().numpy() for a in (q, k, v))
    jdt = getattr(jnp, dtype)
    pallas = np.asarray(ref_flash_attention(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), causal=causal), np.float32)
    tol = TOL[dtype]
    np.testing.assert_allclose(got, pallas, rtol=tol, atol=tol)
    np.testing.assert_allclose(got, _oracle(q, k, v, causal), rtol=tol,
                               atol=tol)


def test_sq_different_from_skv_matches_oracle():
    """Causal by index from 0 on both sides, as the reference's mask."""
    for Sq, Skv in ((40, 72), (72, 40)):
        q, k, v = _inputs(1, Sq, Skv, 4, 2, 64, seed=Sq)
        for causal in (True, False):
            np.testing.assert_allclose(_port(q, k, v, causal),
                                       _oracle(q, k, v, causal),
                                       rtol=1e-5, atol=1e-5)


def test_gradient_guard_raises():
    """Neither the kernel nor the reference's has a gradient: the wrapper
    refuses a call autograd would have to differentiate, and runs one
    under ``torch.no_grad()``."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 128, 128, 4, 4, 64))
    for t in (q, k, v):
        t.requires_grad_(True)
        with pytest.raises(RuntimeError, match="no gradient"):
            fa.flash_attention(q, k, v)
        with torch.no_grad():
            fa.flash_attention(q, k, v)
        t.requires_grad_(False)
    fa.flash_attention(q, k, v)


def test_cpu_tensors_take_the_plain_path(monkeypatch):
    def no_kernel(*a):
        raise AssertionError("the CUDA kernel was reached from CPU tensors")
    monkeypatch.setattr(fa, "_launch", no_kernel)
    before = fa.flash_attention.launches
    _port(*_inputs(1, 128, 128, 4, 4, 64), causal=True)
    assert fa.flash_attention.launches == before


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

    def no_fallback(*a, **kw):
        raise AssertionError("fell back to the plain version")
    monkeypatch.setattr(fa, "flash_attention_torch", no_fallback)
    before = fa.flash_attention.launches
    with FakeTensorMode():
        q = _fake_cuda((2, 128, 4, head_dim), dtype)
        k = _fake_cuda((2, 128, 2, head_dim), dtype)
        with pytest.raises(error, match=match):
            fa.flash_attention(q, k, k)
    assert fa.flash_attention.launches == before


@pytest.mark.parametrize("layout", ["bshd", "bhsd_view"])
def test_launch_arguments_follow_the_c_signature(layout):
    """``_args`` gives the C function ``B, H, Hkv, Sq, Skv, D, causal``,
    then the (batch, seq, head) element strides of q, k, v and out (the
    kernel's tensor maps and stores read them) and 1/sqrt(D): 20 values
    between the 4 pointers and the stream."""
    B, Sq, Skv, H, Hkv, D = 2, 96, 160, 8, 2, 64
    if layout == "bshd":
        q = torch.zeros(B, Sq, H, D)
        k = torch.zeros(B, Skv, Hkv, D)
    else:   # (B, H, S, D) storage seen as (B, S, H, D): strides in place
        q = torch.zeros(B, H, Sq, D).transpose(1, 2)
        k = torch.zeros(B, Hkv, Skv, D).transpose(1, 2)
    out = torch.empty(q.shape)
    args = fa._args(q, k, k, out, causal=True)
    assert len(args) == 20
    assert args[:7] == (B, H, Hkv, Sq, Skv, D, 1)
    assert args[7:10] == q.stride()[:3] and args[10:13] == k.stride()[:3]
    assert args[13:16] == k.stride()[:3]
    assert args[16:19] == out.stride()[:3]
    assert args[19] == pytest.approx(D ** -0.5)
    assert fa._args(q, k, k, out, causal=False)[6] == 0


def test_cuda_request_with_unaligned_strides_raises():
    """TMA copies need 16-byte aligned strides: a row stride that is not a
    multiple of 8 elements raises before any build."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without a card")
    before = fa.flash_attention.launches
    with FakeTensorMode():
        q = torch.empty_strided((2, 128, 4, 64), (128 * 4 * 68, 4 * 68, 68, 1),
                                dtype=torch.bfloat16, device="cuda")
        k = _fake_cuda((2, 128, 4, 64), torch.bfloat16)
        with pytest.raises(ValueError, match="TMA"):
            fa.flash_attention(q, k, k)
    assert fa.flash_attention.launches == before


def _model_pair(**kw):
    rc = dataclasses.replace(ref_config("qwen1.5-32b", "smoke"),
                             dtype="float32", **kw)
    tc = dataclasses.replace(get_config("qwen1.5-32b", "smoke"),
                             dtype="float32", **kw)
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, 0.02, a.shape).astype(
            np.float32), ref_build(rc).init(jax.random.PRNGKey(0)))
    return (ref_build(rc), jax.tree_util.tree_map(jnp.asarray, params),
            build_model(tc), params_from_numpy(params, device="cpu"))


def test_train_logits_with_flash_attention_match_reference():
    """qwen SMOKE, float32, S = 128: both packages' layers take their
    flash attention path (Pallas in interpret mode; the plain version)."""
    rm, rp, tm, tp = _model_pair(use_pallas_attention=True)
    toks = np.random.default_rng(1).integers(
        4, rm.cfg.vocab_size, size=(2, 128)).astype(np.int32)
    want, _ = jax.jit(rm.train_logits)(rp, {"tokens": jnp.asarray(toks)})
    got, _ = tm.train_logits(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("use_pallas_attention,S,calls", [
    (True, 128, 2),      # every layer of the 2-layer SMOKE model
    (True, 96, 0),       # S % 128 != 0: the plain attention
    (False, 128, 0),
])
def test_layers_take_flash_attention_under_the_reference_condition(
        monkeypatch, use_pallas_attention, S, calls):
    seen = []
    real = L.flash_attention

    def spy(q, k, v, *, causal=True):
        seen.append((q.shape, causal))
        return real(q, k, v, causal=causal)
    monkeypatch.setattr(L, "flash_attention", spy)
    _, _, tm, tp = _model_pair(use_pallas_attention=use_pallas_attention)
    tm.train_logits(tp, {"tokens": torch.ones(1, S, dtype=torch.int64)})
    assert len(seen) == calls and all(c for _, c in seen)
