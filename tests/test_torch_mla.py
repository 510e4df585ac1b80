"""The port's multi-head latent attention against the reference, at SMOKE
size: ``minicpm3-4b`` (MLA, dense) and ``deepseek-v3-671b`` (MLA, a
dense first layer, MoE with a shared expert, multi-token prediction).

Weights come from the reference's ``Model.init`` plus seeded numpy noise,
carried across by ``repro_torch.bridge``, as in
``tests/test_torch_families.py``.  Float32: logits within 1e-4 (the same
sums in another order), greedy tokens identical, with the naive decode
(``mla_absorb=False``, the reference's default) and the absorbed one
(``True``) on both sides.  The port's absorbed against its naive logits
at the reference's own 2e-3 (``tests/test_transformer.py``: the same
function, the latent products in another association).  Training loss
1e-5 relative and gradients 1e-4 of each leaf's largest entry, as in
``tests/test_torch_moe.py``.  No kernel is on this path (the reference's
MLA has no kernel branch), so nothing here runs one.
"""
import torch_threads  # noqa: F401  (caps torch's threads under xdist)
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import build_model as ref_build
from repro.models import transformer as RT
from repro.serving.continuous import ContinuousEngine as RefEngine
from repro.serving.engine import Engine as RefPaddedEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.schema import tree_leaves
from repro_torch.serving.continuous import ContinuousEngine
from repro_torch.serving.engine import Engine as PaddedEngine
from test_torch_engine import _prompts
from test_torch_model import F32_TOL, _ref_params, _run_both

MINICPM, DEEPSEEK = "minicpm3-4b", "deepseek-v3-671b"
ARCHS = [MINICPM, DEEPSEEK]
ABSORB_TOL = 2e-3
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4


def _configs(arch, dtype="float32", **kw):
    return (dataclasses.replace(ref_config(arch, "smoke"), dtype=dtype, **kw),
            dataclasses.replace(get_config(arch, "smoke"), dtype=dtype, **kw))


def _tokens(rc, B=2, S=16, seed=2):
    return np.random.default_rng(seed).integers(
        4, rc.vocab_size, size=(B, S)).astype(np.int32)


@pytest.mark.parametrize("absorb", [False, True], ids=["naive", "absorbed"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_reference(arch, absorb):
    """Prefill of 9 and 8 greedy decode steps through the compressed
    cache: logits within 1e-4, greedy tokens identical."""
    rc, tc = _configs(arch)
    steps = _run_both(rc, tc, mla_absorb=absorb)
    assert len(steps) == 9
    for want, got in steps:
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
        np.testing.assert_array_equal(got[:, -1].argmax(-1),
                                      want[:, -1].argmax(-1))


@pytest.mark.parametrize("arch", ARCHS)
def test_absorbed_matches_naive(arch):
    """The reference's ``test_mla_absorb_equivalence`` on the port: the
    latent-space decode gives the naive expansion's logits (2e-3),
    prefill of 8 then 4 decode steps."""
    _, tc = _configs(arch)
    model = build_model(tc)
    params = model.init(seed=0, device="cpu")
    B, T_ = 2, 12
    toks = torch.from_numpy(_tokens(tc, B, T_, seed=1).astype(np.int64))
    caches = [model.init_cache(B, T_, device="cpu") for _ in range(2)]
    logits = [model.prefill(params, {"tokens": toks[:, :8]}, c,
                            mla_absorb=a)[0]
              for c, a in zip(caches, (False, True))]
    np.testing.assert_allclose(logits[1].numpy(), logits[0].numpy(),
                               rtol=ABSORB_TOL, atol=ABSORB_TOL)
    for t in range(8, T_):
        logits = [model.decode(params, {"tokens": toks[:, t:t + 1]}, c,
                               mla_absorb=a)[0]
                  for c, a in zip(caches, (False, True))]
        np.testing.assert_allclose(logits[1].numpy(), logits[0].numpy(),
                                   rtol=ABSORB_TOL, atol=ABSORB_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_logits_aux_and_mtp_match_reference(arch):
    """The training forward: logits, the MoE aux loss and (deepseek) the
    multi-token-prediction logits, which minicpm3 does not have."""
    rc, tc = _configs(arch)
    p = _ref_params(ref_build(rc))
    toks = _tokens(rc)
    want, wx = jax.jit(lambda p, x: RT.forward_train(p, rc, x))(
        jax.tree_util.tree_map(jnp.asarray, p), {"tokens": jnp.asarray(toks)})
    got, gx = build_model(tc).train_logits(
        params_from_numpy(p, device="cpu"), {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(float(gx["aux_loss"]), float(wx["aux_loss"]),
                               rtol=1e-6)
    assert sorted(gx) == sorted(wx)
    assert ("mtp_logits" in gx) == bool(tc.mtp_depth)
    if tc.mtp_depth:
        assert gx["mtp_logits"].shape == (2, 15, tc.padded_vocab)
        np.testing.assert_allclose(gx["mtp_logits"].numpy(),
                                   np.asarray(wx["mtp_logits"]),
                                   rtol=F32_TOL, atol=F32_TOL)


def _batch(rc, B=2, S=16, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(4, rc.vocab_size, size=(B, S)).astype(np.int32)
    labels = rng.integers(4, rc.vocab_size, size=(B, S)).astype(np.int32)
    labels[0, :3] = -1
    return {"tokens": toks, "labels": labels}


@pytest.mark.parametrize("arch,remat", [(DEEPSEEK, "none"),
                                        (DEEPSEEK, "full"),
                                        (MINICPM, "full")])
def test_training_loss_and_gradients_match_jax_grad(arch, remat):
    """``forward_train_loss`` (chunked CE, the aux loss and, on deepseek,
    0.3 x the MTP CE) and its gradient on every leaf against
    ``jax.grad`` of the reference's: the MLA projections, the MoE
    experts and the MTP layer included."""
    rc, tc = _configs(arch, remat=remat)
    p = _ref_params(ref_build(rc))
    b = _batch(rc)
    jb = jax.tree_util.tree_map(jnp.asarray, b)
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p: RT.forward_train_loss(p, rc, jb)))(
            jax.tree_util.tree_map(jnp.asarray, p))
    tp = params_from_numpy(p, device="cpu")
    leaves = tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    loss = T.forward_train_loss(tp, tc, {k: torch.from_numpy(v.copy())
                                         for k, v in b.items()})
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=LOSS_RTOL)
    want_leaves = jax.tree_util.tree_leaves(want)
    assert len(want_leaves) == len(grads)
    for got, w in zip(grads, want_leaves):
        w = np.asarray(w)
        np.testing.assert_allclose(got.numpy(), w, rtol=0,
                                   atol=GRAD_TOL * max(np.abs(w).max(),
                                                       1e-30))
    if tc.mtp_depth:
        g_comb = grads[[id(t) for t in leaves].index(
            id(tp["mtp"]["w_comb"]))]
        assert g_comb.abs().max() > 0      # the MTP term reaches its leaves


def test_loss_fn_with_mtp_logits_matches_reference():
    """``loss_fn`` with ``extras["mtp_logits"]`` (labels shifted by one,
    no z-loss on the MTP term) on deepseek's training forward."""
    rc, tc = _configs(DEEPSEEK)
    p = _ref_params(ref_build(rc))
    b = _batch(rc, seed=3)
    rl, rx = jax.jit(lambda p, x: RT.forward_train(p, rc, x))(
        jax.tree_util.tree_map(jnp.asarray, p),
        {"tokens": jnp.asarray(b["tokens"])})
    want = RT.loss_fn(rl, jnp.asarray(b["labels"]), extras=rx)
    tl, tx = T.forward_train(params_from_numpy(p, device="cpu"), tc,
                             {"tokens": torch.from_numpy(b["tokens"])})
    labels = torch.from_numpy(b["labels"])
    got = T.loss_fn(tl, labels, extras=tx)
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    without = T.loss_fn(tl, labels, extras={"aux_loss": tx["aux_loss"]})
    assert float(got) > float(without)


def test_mtp_term_changes_the_loss():
    """The reference's ``test_mtp_loss_included``: with and without
    ``mtp_depth`` the loss differs and is finite, in both packages, and
    each equals the reference's."""
    rc, tc = _configs(DEEPSEEK)
    p = _ref_params(ref_build(rc))
    toks = _tokens(rc, seed=1)
    rp = jax.tree_util.tree_map(jnp.asarray, p)
    tp = params_from_numpy(p, device="cpu")
    got, want = [], []
    for depth in (1, 0):
        r = dataclasses.replace(rc, mtp_depth=depth)
        t = dataclasses.replace(tc, mtp_depth=depth)
        want.append(float(jax.jit(
            lambda p, b, r=r: RT.forward_train_loss(p, r, b))(
                rp, {"tokens": jnp.asarray(toks),
                     "labels": jnp.asarray(toks)})))
        got.append(float(T.forward_train_loss(
            tp, t, {"tokens": torch.from_numpy(toks),
                    "labels": torch.from_numpy(toks)})))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert np.isfinite(got).all()
    assert got[0] != pytest.approx(got[1])


ENGINE_KW = dict(num_slots=3, max_len=40, max_new_cap=10, sync_every=4,
                 prefill_batch=2)


@pytest.mark.parametrize("arch,absorb", [(MINICPM, False), (MINICPM, True),
                                         (DEEPSEEK, False)],
                         ids=["minicpm3-naive", "minicpm3-absorbed",
                              "deepseek-naive"])
def test_engine_tokens_match_reference(arch, absorb):
    """``ContinuousEngine`` with ``mla_absorb`` on both sides: 7 prompts
    of two lengths on 3 slots (slots reused, idle slots holding their
    positions), the reference engine's greedy tokens and step counts."""
    rc, tc = _configs(arch)
    p = _ref_params(ref_build(rc))
    prompts = _prompts(7, [6, 11, 6, 9], vocab=rc.vocab_size)
    want = RefEngine(ref_build(rc), jax.tree_util.tree_map(jnp.asarray, p),
                     mla_absorb=absorb, **ENGINE_KW).generate_many(
                         prompts, max_new_tokens=10)
    port = ContinuousEngine(build_model(tc), params_from_numpy(p, device="cpu"),
                            mla_absorb=absorb, **ENGINE_KW)
    assert port.executor.mla_absorb is absorb
    got = port.generate_many(prompts, max_new_tokens=10)
    assert [list(g.tokens) for g in got] == [list(w.tokens) for w in want]
    assert [g.n_steps for g in got] == [w.n_steps for w in want]


@pytest.mark.parametrize("absorb", [False, True], ids=["naive", "absorbed"])
def test_padded_engine_tokens_match_reference(absorb):
    """The padded ``Engine`` with ``mla_absorb`` on both sides, minicpm3
    SMOKE: 5 right-padded prompts of three lengths in one bucket, the
    reference engine's greedy tokens and step count."""
    rc, tc = _configs(MINICPM)
    p = _ref_params(ref_build(rc))
    prompts = _prompts(5, [6, 11, 9], vocab=rc.vocab_size)
    want = RefPaddedEngine(ref_build(rc),
                           jax.tree_util.tree_map(jnp.asarray, p),
                           max_len=64, mla_absorb=absorb).generate(
                               prompts, max_new_tokens=10)
    model = build_model(tc)
    port = PaddedEngine(model, params_from_numpy(p, device="cpu"),
                        max_len=64, mla_absorb=absorb)
    with mock.patch.object(model, "prefill", wraps=model.prefill) as pre, \
            mock.patch.object(model, "decode", wraps=model.decode) as dec:
        got = port.generate(prompts, max_new_tokens=10)
    assert got.tokens.tolist() == np.asarray(want.tokens).tolist()
    assert got.n_steps == want.n_steps
    assert dec.call_count == got.n_steps - 1
    assert {c.kwargs["mla_absorb"] for c in pre.call_args_list
            + dec.call_args_list} == {absorb}


@pytest.mark.parametrize("package", ["reference", "port"])
def test_paged_engine_refuses_mla(package):
    """The paged pool holds position-addressed GQA pages only: both
    packages refuse an MLA stack with ``ValueError``."""
    rc, tc = _configs(MINICPM)
    kw = dict(ENGINE_KW, paged=True, page_size=8)
    with pytest.raises(ValueError, match="paged KV cache"):
        if package == "reference":
            m = ref_build(rc)
            RefEngine(m, m.init(jax.random.PRNGKey(0)), **kw)
        else:
            m = build_model(tc)
            ContinuousEngine(m, m.init(seed=0, device="cpu"), **kw)


def test_idle_slot_write_at_max_len_is_dropped():
    """An idle slot's held position may sit at max_len: its ``c_kv`` /
    ``k_rope`` write is dropped (the reference's out-of-bounds scatter),
    not raised, and every other row is written at its own position."""
    _, tc = _configs(MINICPM)
    p = build_model(tc).init(seed=0, device="cpu")["blocks"]["p0"]["attn"]
    p = {k: v[0] for k, v in p.items()}
    m = tc.mla
    Lmax = 4
    cache = {"c_kv": torch.zeros(3, Lmax, m.kv_lora_rank),
             "k_rope": torch.zeros(3, Lmax, m.qk_rope_head_dim)}
    x = torch.randn(3, 1, tc.d_model, generator=torch.Generator().manual_seed(0))
    pos = torch.tensor([[0], [3], [Lmax]], dtype=torch.int32)
    out, cache = L.mla_apply(p, x, tc, positions=pos, cache=cache)
    assert torch.isfinite(out).all()
    for leaf in cache.values():
        assert leaf[0, 0].abs().sum() > 0 and leaf[1, 3].abs().sum() > 0
        assert leaf[2].abs().sum() == 0
        assert leaf[0, 1:].abs().sum() == 0 and leaf[1, :3].abs().sum() == 0


@pytest.mark.parametrize("kv_quant_int8", [False, True], ids=["plain",
                                                               "int8"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_mla_cache_leaves(dtype, kv_quant_int8):
    """The compressed cache: ``c_kv`` (B, L, kv_lora_rank) and ``k_rope``
    (B, L, qk_rope_head_dim) a layer, in the config's dtype, stacked as
    the reference stacks them; ``kv_quant_int8`` leaves them as they are,
    as it does in the reference."""
    rc, tc = _configs(DEEPSEEK, dtype=dtype, kv_quant_int8=kv_quant_int8)
    tcache = build_model(tc).init_cache(3, 20, device="cpu")
    rcache = ref_build(rc).init_cache(3, 20)
    m = tc.mla
    assert tcache["prefix"][0]["c_kv"].shape == (3, 20, m.kv_lora_rank)
    assert tcache["blocks"]["p0"]["k_rope"].shape == (
        1, 3, 20, m.qk_rope_head_dim)
    for layer in tcache["prefix"] + [tcache["blocks"]["p0"]]:
        assert sorted(layer) == ["c_kv", "k_rope"]
        assert all(v.dtype == getattr(torch, dtype) for v in layer.values())
    got = [(tuple(t.shape), str(t.dtype).removeprefix("torch."))
           for t in tree_leaves(tcache)]
    want = [(tuple(a.shape), str(a.dtype))
            for a in jax.tree_util.tree_leaves(rcache)]
    assert got == want


def test_bridge_carries_mla_and_mtp_leaves():
    """``params_from_numpy`` is generic: deepseek's MLA leaves and its
    ``mtp`` subtree cross leaf for leaf into the port's schema tree,
    bit for bit in bf16."""
    rc, tc = _configs(DEEPSEEK, dtype="bfloat16")
    np_params = _ref_params(ref_build(rc))
    ported = params_from_numpy(np_params, device="cpu")
    schema = build_model(tc).schema
    assert sorted(ported["mtp"]) == sorted(schema["mtp"]) == [
        "final_norm", "layer", "norm_e", "norm_h", "w_comb"]
    assert sorted(ported["mtp"]["layer"]["attn"]) == sorted(
        L.mla_schema(tc))
    assert [tuple(t.shape) for t in tree_leaves(ported)] == \
        [tuple(s.shape) for s in tree_leaves(schema)]
    for a, t in zip(jax.tree_util.tree_leaves(np_params),
                    tree_leaves(ported)):
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      a.view(np.int16))

