"""The port's mixture-of-experts block against the reference, on dbrx SMOKE
(and the block alone on deepseek SMOKE).

Both compute ``moe_apply_ragged`` over the routed rows sorted by expert:
the reference with ``jax.lax.ragged_dot``, the port with its grouped
GEMM (``kernels/grouped_gemm.py``: on CPU tensors its plain version).
Weights come from the
reference's ``init_from_schema`` / ``Model.init`` plus seeded numpy
noise, carried across by ``repro_torch.bridge``; activations and tokens
are numpy draws.  The reference runs jitted on the CPU, the port eagerly
on CPU tensors.

Tolerances, float32: the block's output 1e-6 (the same products summed
in another order; outputs of magnitude ~1e-2), its aux loss 1e-6
relative; the training loss 1e-5 relative and its gradients 1e-4 of each
leaf's largest entry, as in ``tests/test_torch_training.py``.  Expert
choices are exact, ties included.
"""
import torch_threads  # noqa: F401  (caps torch's threads under xdist)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.core.config import MoEConfig as RefMoEConfig
from repro.models import build_model as ref_build
from repro.models import moe as ref_moe
from repro.models import transformer as RT
from repro.models.schema import init_from_schema as ref_init_from_schema
from repro.serving.continuous import ContinuousEngine as RefEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core.config import MoEConfig
from repro_torch.models import build_model
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.models.schema import tree_leaves, tree_map
from repro_torch.serving.continuous import ContinuousEngine

MOE_TOL = 1e-6
AUX_RTOL = 1e-6
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
ARCH = "dbrx-132b"


def _configs(dtype="float32", arch=ARCH, **moe_kw):
    rc, tc = ref_config(arch, "smoke"), get_config(arch, "smoke")
    return (dataclasses.replace(rc, dtype=dtype, moe=dataclasses.replace(
                rc.moe, **moe_kw)),
            dataclasses.replace(tc, dtype=dtype, moe=dataclasses.replace(
                tc.moe, **moe_kw)))


def _noisy(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a, np.float32)
                   + rng.normal(0, 0.02, a.shape).astype(np.float32)
                   ).astype(a.dtype), tree)


def _block_params(rc, seed=0):
    schema = RT._retag_dtype(ref_moe.moe_schema(rc), rc.dtype)
    return _noisy(ref_init_from_schema(jax.random.PRNGKey(seed), schema),
                  seed)


def _x(rc, B=2, S=16, seed=1):
    return (np.random.default_rng(seed).standard_normal(
        (B, S, rc.d_model)) * 0.5).astype(np.float32)


def _block_against_reference(rc, tc, p, x):
    want, want_aux = jax.jit(lambda p, x: ref_moe.moe_apply_ragged(
        p, x, rc))(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))
    got, got_aux = M.moe_apply_ragged(params_from_numpy(p, device="cpu"),
                                      torch.from_numpy(x), tc)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=MOE_TOL)
    assert float(np.abs(np.asarray(want)).max()) > 1e-3   # not a null test
    np.testing.assert_allclose(float(got_aux), float(want_aux),
                               rtol=AUX_RTOL)


@pytest.mark.parametrize("arch", [ARCH, "deepseek-v3-671b"])
@pytest.mark.parametrize("n_shared", [0, 1], ids=["routed", "shared"])
def test_moe_block_matches_reference(n_shared, arch):
    rc, tc = _configs(arch=arch, n_shared_experts=n_shared)
    p = _block_params(rc)
    assert ("shared" in p) == bool(n_shared)
    _block_against_reference(rc, tc, p, _x(rc))


@pytest.mark.parametrize("expert", [0, 1, 3], ids=["first", "middle", "last"])
def test_moe_block_with_an_empty_group_matches_reference(expert):
    """The router sends no token to one expert (positive activations
    against a negative router column): that group is empty, and the
    block still computes the reference's function."""
    rc, tc = _configs()
    p = _block_params(rc)
    p["router"][:, expert] = -np.abs(p["router"][:, expert]) - 0.5
    x = np.abs(_x(rc))
    _, idx, _ = M.router_probs({"router": torch.from_numpy(p["router"])},
                               torch.from_numpy(x.reshape(-1, rc.d_model)),
                               tc.moe)
    assert expert not in idx.unique().tolist()
    assert len(idx.unique()) == tc.moe.n_experts - 1
    _block_against_reference(rc, tc, p, x)


def test_router_choices_match_reference():
    """Every token's top-k experts and renormalised weights."""
    rc, tc = _configs()
    p = _block_params(rc)
    xf = _x(rc).reshape(-1, rc.d_model)
    wv, wi, wa = ref_moe.router_probs({"router": jnp.asarray(p["router"])},
                                      jnp.asarray(xf), rc.moe)
    gv, gi, ga = M.router_probs({"router": torch.from_numpy(p["router"])},
                                torch.from_numpy(xf), tc.moe)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=0,
                               atol=MOE_TOL)
    np.testing.assert_allclose(float(ga), float(wa), rtol=AUX_RTOL)
    # not every token goes to the same experts
    assert len({tuple(r) for r in gi.tolist()}) > 1


def test_router_ties_go_to_the_lower_expert_id():
    """A zero router gives every expert the same probability: the
    reference's ``jax.lax.top_k`` takes experts 0 and 1, and so must the
    port (``torch.topk`` would not)."""
    rc, tc = _configs()
    p = _block_params(rc)
    p["router"] = np.zeros_like(p["router"])
    x = _x(rc)
    _, wi, _ = ref_moe.router_probs({"router": jnp.asarray(p["router"])},
                                    jnp.asarray(x.reshape(-1, rc.d_model)),
                                    rc.moe)
    _, gi, _ = M.router_probs({"router": torch.from_numpy(p["router"])},
                              torch.from_numpy(x.reshape(-1, rc.d_model)),
                              tc.moe)
    np.testing.assert_array_equal(np.asarray(wi), [[0, 1]] * wi.shape[0])
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    want, want_aux = jax.jit(lambda p, x: ref_moe.moe_apply_ragged(
        p, x, rc))(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))
    got, got_aux = M.moe_apply_ragged(params_from_numpy(p, device="cpu"),
                                      torch.from_numpy(x), tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=MOE_TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux),
                               rtol=AUX_RTOL)


def test_router_load_balance_loss_uniform_is_low():
    """The twin of ``tests/test_moe.py::
    test_router_load_balance_loss_uniform_is_low``: a uniform router's
    aux loss is ~coef (E * E * (1/E^2) = 1), and the reference's."""
    e = MoEConfig(n_experts=8, top_k=2, d_ff_expert=64)
    T_, d = 512, 32
    x = np.random.default_rng(0).standard_normal((T_, d)).astype(np.float32)
    _, _, aux = M.router_probs({"router": torch.zeros(d, 8)},
                               torch.from_numpy(x), e)
    _, _, want = ref_moe.router_probs(
        {"router": jnp.zeros((d, 8))}, jnp.asarray(x),
        RefMoEConfig(n_experts=8, top_k=2, d_ff_expert=64))
    assert float(aux) == pytest.approx(e.load_balance_coef, rel=0.3)
    assert float(aux) == pytest.approx(float(want), rel=AUX_RTOL)


def test_moe_block_bf16_keeps_the_reference_dtypes():
    """bf16 activations and weights: the router in float32, the output in
    bf16, within a bf16-scale tolerance of the reference."""
    rc, tc = _configs(dtype="bfloat16")
    p = _block_params(rc)
    x = _x(rc).astype(jnp.bfloat16)
    want, want_aux = jax.jit(lambda p, x: ref_moe.moe_apply_ragged(
        p, x, rc))(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))
    xt = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    got, got_aux = M.moe_apply_ragged(params_from_numpy(p, device="cpu"),
                                      xt, tc)
    assert got.dtype == torch.bfloat16 and got_aux.dtype == torch.float32
    want = np.asarray(want, np.float32)
    rel = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert rel <= 2e-2, rel
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-5)


def test_moe_layers_follow_the_reference_structure():
    """Layer signatures, the ``first_k_dense`` prefix and the parameter
    tree (an MoE layer has ``moe`` and no ``mlp``) as the reference's."""
    for arch, kw in (("dbrx-132b", {}),
                     ("jamba-1.5-large-398b", {}),
                     ("dbrx-132b", dict(first_k_dense=1, moe_period=2,
                                        n_shared_experts=1))):
        rc, tc = ref_config(arch, "smoke"), get_config(arch, "smoke")
        n = rc.n_layers + kw.get("first_k_dense", 0) + (
            2 if kw.get("moe_period") else 0)
        rc = dataclasses.replace(rc, n_layers=n, moe=dataclasses.replace(
            rc.moe, **kw))
        tc = dataclasses.replace(tc, n_layers=n, moe=dataclasses.replace(
            tc.moe, **kw))
        want = RT.layer_structure(rc)
        got = T.layer_structure(tc)
        assert [[dataclasses.astuple(s) for s in part] for part in got[:2]] \
            == [[dataclasses.astuple(s) for s in part] for part in want[:2]]
        assert got[2] == want[2]
        ref_tree = jax.tree_util.tree_map(
            lambda s: s.shape, ref_build(rc).schema,
            is_leaf=lambda s: hasattr(s, "axes"))
        port_tree = tree_map(lambda s: s.shape, build_model(tc).schema)
        assert port_tree == ref_tree


def test_broken_moe_period_raises():
    _, tc = _configs()
    tc = dataclasses.replace(tc, n_layers=3, moe=dataclasses.replace(
        tc.moe, moe_period=2))
    with pytest.raises(ValueError, match="period"):
        build_model(tc)


# ---------------------------------------------------------------------------
# the whole model: training loss and gradients, the engine
# ---------------------------------------------------------------------------


def _model_params(rc, seed=0):
    return _noisy(jax.tree_util.tree_map(
        np.asarray, ref_build(rc).init(jax.random.PRNGKey(0))), seed)


def _batch(rc, B=2, S=16, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(4, rc.vocab_size, size=(B, S)).astype(np.int32)
    labels = rng.integers(4, rc.vocab_size, size=(B, S)).astype(np.int32)
    labels[0, :3] = -1
    return {"tokens": toks, "labels": labels}


@pytest.mark.parametrize("remat", ["none", "full"])
def test_training_loss_and_gradients_match_jax_grad(remat):
    """``forward_train_loss`` (chunked CE + the summed aux loss) and its
    gradient on the router and an expert leaf against ``jax.grad`` of the
    reference's."""
    rc, tc = _configs()
    rc, tc = (dataclasses.replace(rc, remat=remat),
              dataclasses.replace(tc, remat=remat))
    p = _model_params(rc)
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
    moe = tp["blocks"]["p0"]["moe"]
    g_router, g_up = torch.autograd.grad(loss, [moe["router"], moe["w_up"]])
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=LOSS_RTOL)
    wm = want["blocks"]["p0"]["moe"]
    for got, w in ((g_router, wm["router"]), (g_up, wm["w_up"])):
        w = np.asarray(w)
        assert np.abs(w).max() > 0
        np.testing.assert_allclose(got.numpy(), w, rtol=0,
                                   atol=GRAD_TOL * np.abs(w).max())


KW = dict(num_slots=3, max_len=40, max_new_cap=12, sync_every=4)


@pytest.mark.parametrize("prefill_batch", [1, 2])
def test_engine_tokens_identical_to_reference(prefill_batch):
    """``ContinuousEngine`` on dbrx SMOKE: 7 prompts on 3 slots of two
    lengths, the same greedy tokens and engine counts as the reference's
    engine."""
    rc, tc = _configs()
    p = _model_params(rc)
    rng = np.random.default_rng(3)
    prompts = [list(rng.integers(4, rc.vocab_size, size=n))
               for n in (6, 11, 6, 9, 6, 11, 9)]
    ref = RefEngine(ref_build(rc), jax.tree_util.tree_map(jnp.asarray, p),
                    prefill_batch=prefill_batch, **KW)
    port = ContinuousEngine(build_model(tc),
                            params_from_numpy(p, device="cpu"),
                            prefill_batch=prefill_batch, **KW)
    want = ref.generate_many(prompts, max_new_tokens=10)
    got = port.generate_many(prompts, max_new_tokens=10)
    assert [list(g.tokens) for g in got] == [list(w.tokens) for w in want]
    for f in ("n_admitted", "n_completed", "n_prefills", "n_decode_chunks",
              "n_decode_steps"):
        assert getattr(port.stats, f) == getattr(ref.stats, f), f
