"""The port's decoder families against the reference at SMOKE size:
``dbrx-132b`` (mixture of experts), ``jamba-1.5-large-398b`` (Mamba +
attention + MoE), ``command-r-35b`` (GQA, G = 4 at SMOKE, 8 at FULL) and
``gemma3-12b`` (sliding-window local layers beside global ones, the
ring cache, the logit softcap).

Weights come from the reference's ``Model.init`` plus seeded numpy noise,
carried across by ``repro_torch.bridge``, as in
``tests/test_torch_model.py``.  Prefill plus 8 greedy decode steps feed
both packages the same tokens; the reference runs with its dense
attention (``use_flash_decode=False``) and with its Pallas flash-decode
kernel in interpret mode (``True``); the port always decodes through its
flash-decode wrapper, the plain version on CPU tensors.  Float32: logits
within 1e-4 (the same sums in another order), greedy tokens identical.

gemma3 SMOKE's window (32) does not bind at those lengths, so its own
tests shrink it to 8, as the reference's ``tests/test_transformer.py``
does, and decode 16 positions past a 9-token prompt: the local layers
then attend to a window that excludes the prompt's start.
"""
import torch_threads  # noqa: F401  (caps torch's threads under xdist)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import build_model as ref_build
from repro.models import transformer as RT
from repro.serving.continuous import ContinuousEngine as RefEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models import transformer as T
from repro_torch.serving.continuous import ContinuousEngine
from test_torch_engine import _prompts
from test_torch_model import F32_TOL, _ref_params, _run_both

FAMILIES = ["dbrx-132b", "jamba-1.5-large-398b", "command-r-35b",
            "gemma3-12b"]
GEMMA = "gemma3-12b"
# gemma3 SMOKE with a window that binds within the tests' lengths
BINDING = dict(sliding_window=8)


def _configs(arch, dtype="float32", **kw):
    return (dataclasses.replace(ref_config(arch, "smoke"), dtype=dtype, **kw),
            dataclasses.replace(get_config(arch, "smoke"), dtype=dtype, **kw))


@pytest.mark.parametrize("use_flash_decode", [False, True])
@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_decode_logits_match_reference(arch, use_flash_decode):
    rc, tc = _configs(arch)
    rc = dataclasses.replace(rc, use_flash_decode=use_flash_decode)
    steps = _run_both(rc, tc)
    assert len(steps) == 9
    for want, got in steps:
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
        np.testing.assert_array_equal(got[:, -1].argmax(-1),
                                      want[:, -1].argmax(-1))


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_train_logits_and_aux_match_reference(arch):
    rc, tc = _configs(arch)
    p = _ref_params(ref_build(rc))
    toks = np.random.default_rng(2).integers(
        4, rc.vocab_size, size=(2, 16)).astype(np.int32)
    want, wx = jax.jit(lambda p, x: RT.forward_train(p, rc, x))(
        jax.tree_util.tree_map(jnp.asarray, p), {"tokens": jnp.asarray(toks)})
    got, gx = build_model(tc).train_logits(
        params_from_numpy(p, device="cpu"), {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(float(gx["aux_loss"]), float(wx["aux_loss"]),
                               rtol=1e-6)
    assert (float(gx["aux_loss"]) > 0) == (rc.moe is not None)


def test_embed_one_hot_matches_reference():
    """``embed_one_hot``: the embedding as a one-hot product, on qwen
    SMOKE: prefill + decode and the training forward."""
    rc, tc = _configs("qwen1.5-32b", embed_one_hot=True)
    for want, got in _run_both(rc, tc, steps=4):
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
        np.testing.assert_array_equal(got[:, -1].argmax(-1),
                                      want[:, -1].argmax(-1))
    p = _ref_params(ref_build(rc))
    toks = np.random.default_rng(4).integers(
        4, rc.vocab_size, size=(2, 12)).astype(np.int32)
    tp = params_from_numpy(p, device="cpu")
    got = T._embed_lookup(tp, tc, torch.from_numpy(toks))
    want = RT._embed_lookup(jax.tree_util.tree_map(jnp.asarray, p), rc,
                            jnp.asarray(toks))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), tp["embed"][torch.from_numpy(toks).long()].numpy())


# ---------------------------------------------------------------------------
# gemma3-12b: a window that binds, the ring cache, the softcap
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_flash_decode", [False, True])
@pytest.mark.parametrize("kw", [
    dict(), dict(window_ring_cache=True), dict(attn_logit_softcap=30.0),
    dict(window_ring_cache=True, attn_logit_softcap=30.0),
    dict(kv_quant_int8=True)],
    ids=["full", "ring", "softcap", "ring-softcap", "int8"])
def test_gemma3_binding_window_matches_reference(kw, use_flash_decode):
    """Prefill of 9 and 16 decode steps (positions to 24) under a window
    of 8: logits within 1e-4 and greedy tokens identical, with the
    full-length cache, the reference's ring cache, the logit softcap and
    the int8 cache.  The reference decodes its global layers through its
    Pallas kernel in interpret mode (``True``) or its dense attention;
    its gate keeps the local ones on the dense attention either way, as
    the port's keeps them off K1."""
    rc, tc = _configs(GEMMA, **BINDING, **kw)
    rc = dataclasses.replace(rc, use_flash_decode=use_flash_decode)
    steps = _run_both(rc, tc, S=9, max_len=30, steps=16)
    assert len(steps) == 17
    for want, got in steps:
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
        np.testing.assert_array_equal(got[:, -1].argmax(-1),
                                      want[:, -1].argmax(-1))


def test_gemma3_ring_cache_matches_full_cache():
    """The port's ring cache (``window_ring_cache``: a local layer keeps
    ``window`` rows, position p in row p % window) against its full-length
    cache, as the reference's ``test_window_ring_cache_equivalence``
    holds its own: the same logits at every step, the ring's local
    leaves window-sized."""
    _, tc = _configs(GEMMA, **BINDING)
    full, ring = build_model(tc), build_model(
        dataclasses.replace(tc, window_ring_cache=True))
    params = full.init(seed=0, device="cpu")
    B, T_ = 2, 24
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, tc.vocab_size, size=(B, T_)))
    cf, cr = full.init_cache(B, T_, device="cpu"), ring.init_cache(
        B, T_, device="cpu")
    assert cr["blocks"]["p0"]["k"].shape[2] == 8     # (nblk, B, W, Hkv, Dh)
    assert cr["blocks"]["p1"]["k"].shape[2] == T_    # the global layer
    lf, cf = full.prefill(params, {"tokens": toks[:, :12]}, cf)
    lr, cr = ring.prefill(params, {"tokens": toks[:, :12]}, cr)
    np.testing.assert_allclose(lr.numpy(), lf.numpy(), rtol=F32_TOL,
                               atol=F32_TOL)
    for t in range(12, T_):
        lf, cf = full.decode(params, {"tokens": toks[:, t:t + 1]}, cf)
        lr, cr = ring.decode(params, {"tokens": toks[:, t:t + 1]}, cr)
        np.testing.assert_allclose(lr.numpy(), lf.numpy(), rtol=F32_TOL,
                                   atol=F32_TOL, err_msg=f"t={t}")


@pytest.mark.parametrize("kw", [BINDING, dict(attn_logit_softcap=30.0)],
                         ids=["window8", "softcap"])
def test_gemma3_forward_train_matches_reference(kw):
    """The training forward with a window that binds (16 tokens against
    a window of 8) and with the softcap."""
    rc, tc = _configs(GEMMA, **kw)
    p = _ref_params(ref_build(rc))
    toks = np.random.default_rng(3).integers(
        4, rc.vocab_size, size=(2, 16)).astype(np.int32)
    want, _ = jax.jit(lambda p, x: RT.forward_train(p, rc, x))(
        jax.tree_util.tree_map(jnp.asarray, p), {"tokens": jnp.asarray(toks)})
    got, _ = build_model(tc).train_logits(
        params_from_numpy(p, device="cpu"), {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)


def test_gemma3_sliding_window_masks_the_past():
    """The reference's ``test_sliding_window_masks_past``: two local
    layers of window 4, 16 tokens; changing the first 4 leaves the last
    position's logits as they were (it sees at most 2 x 4 back), in the
    port and in the reference alike."""
    rc, tc = _configs(GEMMA, sliding_window=4, attn_pattern=("L",),
                      n_layers=2)
    p = _ref_params(ref_build(rc))
    tp = params_from_numpy(p, device="cpu")
    rp = jax.tree_util.tree_map(jnp.asarray, p)
    toks = np.random.default_rng(1).integers(
        0, rc.vocab_size, size=(1, 16)).astype(np.int32)
    toks2 = toks.copy()
    toks2[:, :4] = (toks[:, :4] + 7) % rc.vocab_size
    model = build_model(tc)
    got = [model.train_logits(tp, {"tokens": torch.from_numpy(t)})[0]
           [:, -1].numpy() for t in (toks, toks2)]
    np.testing.assert_allclose(got[1], got[0], rtol=F32_TOL, atol=F32_TOL)
    want = RT.forward_train(rp, rc, {"tokens": jnp.asarray(toks)})[0]
    np.testing.assert_allclose(got[0], np.asarray(want[:, -1]),
                               rtol=F32_TOL, atol=F32_TOL)
    # and the window is what hides them: with full attention they show
    full = build_model(dataclasses.replace(tc, sliding_window=0))
    a, b = (full.train_logits(tp, {"tokens": torch.from_numpy(t)})[0]
            [:, -1] for t in (toks, toks2))
    assert (a - b).abs().max() > 1e-3


def _gemma3_models(**kw):
    rc, tc = _configs(GEMMA, **BINDING, **kw)
    np_params = _ref_params(ref_build(rc))
    return (ref_build(rc), jax.tree_util.tree_map(jnp.asarray, np_params),
            build_model(tc), params_from_numpy(np_params, device="cpu"))


ENGINE_KW = dict(num_slots=3, max_len=40, max_new_cap=14, sync_every=4,
                 prefill_batch=2)


@pytest.mark.parametrize("engine", ["dense", "ring", "paged"])
def test_gemma3_engine_tokens_match_reference(engine):
    """``ContinuousEngine`` on gemma3 SMOKE with a window of 8: 7 prompts
    of 6-11 tokens on 3 slots (slots reused), 14 new tokens each, past
    the window: the port's greedy tokens and step counts are the
    reference engine's, on the dense engine, the dense engine with the
    ring cache (the reference's engine runs it too) and the paged engine
    (page 8; its local layers read through the reference's gathered
    row).  The ring engine's tokens are also the port's full-cache
    engine's."""
    ring = engine == "ring"
    rm, rp, tm, tp = _gemma3_models(window_ring_cache=ring)
    kw = dict(ENGINE_KW, **(dict(paged=True, page_size=8)
                            if engine == "paged" else {}))
    prompts = _prompts(7, [6, 11, 6, 9])
    want = RefEngine(rm, rp, **kw).generate_many(prompts, max_new_tokens=14)
    port = ContinuousEngine(tm, tp, **kw)
    got = port.generate_many(prompts, max_new_tokens=14)
    assert [list(g.tokens) for g in got] == [list(w.tokens) for w in want]
    assert [g.n_steps for g in got] == [w.n_steps for w in want]
    assert max(len(p) + g.n_steps for p, g in zip(prompts, got)) > 16
    if ring:
        assert port.executor._cache["blocks"]["p0"]["k"].shape[2] == 8
        _, _, full, fp = _gemma3_models()
        again = ContinuousEngine(full, fp, **kw).generate_many(
            prompts, max_new_tokens=14)
        assert [list(g.tokens) for g in got] == \
            [list(a.tokens) for a in again]
