"""The port's sharded train and eval steps against the reference's
single-device steps.

The reference's sharded (GSPMD) path is red on this jax, so, as the
sharded serving tests do, the port's steps over gloo worlds are held
against the reference's single-device ``make_train_step`` (jitted on the
CPU) on the same weights (the reference's ``Model.init`` plus seeded
numpy noise, carried across by the bridge) and the same global batch,
for 3 AdamW steps at lr 1e-3:

* qwen SMOKE in float32 at dp = 2, dp = 4, mp = 2 and dp = 2 x mp = 2,
  and on the multi-pod layout at pod = 2 x dp = 2 and pod = 2 x mp = 2
  (the rows over pod x data, the FSDP shards' gradients summed over
  pod);
  at dp = 2 also with labels ignored in one rank's rows only (the loss
  is still the global mean) and at ``microbatches=2``;
* dbrx SMOKE at dp = 3, which does not divide its 4 experts: the
  non-EP path, whose aux loss takes the global batch's means as the
  reference's does; and with no ``moe_fn`` at mp = 2, the experts'
  d_ff split over the model ranks (``moe_apply_ragged`` under ``tp``);
* dbrx SMOKE with the expert-parallel ``moe_fn`` at dp = 2, dp = 2 x
  mp = 2 and pod = 2 x dp = 2 (EP within a pod), capacity 2.0 = E / k (no row drops), against the reference's
  step with ``load_balance_coef = 0`` in both packages (EP averages the
  ranks' aux losses, GSPMD takes the global one); separately the EP aux
  against the mean of the reference's aux over each rank's rows.

Bars: loss and grad norm each step within 1e-5 relative, lr equal; the
first moments, gathered from the shards, within 1e-5 relative and 1e-5
absolute (``tests/test_torch_training.py``'s moment bar); every
parameter element, gathered from the shards, within 1e-5 of its leaf's
largest entry, or, where Adam amplifies float32 noise past that, within
what the noise can move it.  Adam's step is lr * m / sqrt(v): a change
of e in an element's gradient g moves the step by about lr * e / |g|.
Two packages that sum in different orders differ by e of a few ulps of
the leaf's largest gradient G, so an element is held to lr *
NOISE_ULPS * eps * G / min|g| when that is the larger, with min|g| the
smallest |gradient| the reference took over the steps (``jax.grad`` on
its own trajectory), capped at 2 lr a step.  The test prints how many
elements that widens and how many it caps (the gradients at summation
noise, a few ulps of G).

Also: the FSDP gather's peak of live gathered bytes at dp = 2 is one
block's weights; the collectives a step; the sharded eval step against
``make_eval_step``; the EP ``moe_fn`` in the cached forward (prefill and
4 greedy decode steps, dbrx SMOKE at dp = 2) against the reference's
single-device logits (1e-5 of max |logit|) and tokens (identical);
mamba2 and whisper refused at mp = 2 with ``check_tensor_parallel``'s
error, minicpm3's MLA accepted there (its gradients:
``tests/test_torch_mla_tp.py``).

The ``head_dim`` route (kv heads, or heads too, that mp does not
divide): one step's loss and every parameter's gradient over the mesh
(the sharded step's loss on the rank's shards, its unsplit leaves'
gradients summed over data, every leaf gathered whole) against the
port's single-device ``value_and_grads`` of ``forward_train_loss`` on
the same seeded weights and batch (4 x 48 tokens, past gemma3 SMOKE's
window of 32): a qwen SMOKE variant with 6 heads and 6 kv heads,
command-r SMOKE and gemma3 SMOKE at dp = 1 x mp = 4, command-r SMOKE
with one kv head at dp = 2 x mp = 2.  Bars: the loss within
``LOSS_RTOL``; each gradient within ``HEAD_DIM_GRAD_TOL`` of its leaf's
largest |gradient| (float32, the partial sums in another order; up to
1.3e-6 seen).
"""
import torch_threads  # noqa: F401  (caps torch's threads under xdist)
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_training as W
from repro.configs import get_config as ref_config
from repro.models import build_model as ref_build
from repro.models import transformer as RT
from repro.models.schema import init_from_schema as ref_init_from_schema
from repro.training import optimizer as ref_opt
from repro.training import steps as ref_steps
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.sharding import named_specs, specs_for_schema
from torch_dist import run_world

QWEN, DBRX = "qwen1.5-32b", "dbrx-132b"
LOSS_RTOL = 1e-5
PARAM_TOL = 1e-5          # of the leaf's largest entry
# the gradient noise Adam may amplify, in ulps of the leaf's largest
# gradient (about 43 the most these cases need, at microbatches=2)
NOISE_ULPS = 64
MOMENT_TOL = 1e-5
LOGIT_TOL = 1e-5
NO_COEF = {"moe": {"load_balance_coef": 0.0}}
HEAD_DIM_GRAD_TOL = 1e-5
HEAD_DIM = {
    "dp=1,mp=4": {"qwen6": (QWEN, {"n_heads": 6, "n_kv_heads": 6}),
                  "command-r": ("command-r-35b", {}),
                  "gemma3": ("gemma3-12b", {})},
    "dp=2,mp=2": {"command-r_kv1": ("command-r-35b", {"n_kv_heads": 1})},
}
HEAD_DIM_CASES = [(spec, key) for spec, cases in HEAD_DIM.items()
                  for key in cases]


def _ref_cfg(arch, over=None):
    rc = dataclasses.replace(ref_config(arch, "smoke"), dtype="float32")
    moe = dict((over or {}).get("moe", {}))
    return dataclasses.replace(rc, moe=dataclasses.replace(rc.moe, **moe)) \
        if moe else rc


def _np_params(rc, seed=0):
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        np.asarray, ref_build(rc).init(jax.random.PRNGKey(0)))
    return jax.tree_util.tree_map(
        lambda a: (a + rng.normal(0, 0.02, a.shape)).astype(a.dtype), params)


def _batch(rc, B, S=32, seed=0, ignore_rows=None):
    rng = np.random.default_rng(seed)
    toks = rng.integers(4, rc.vocab_size, size=(B, S)).astype(np.int32)
    labels = rng.integers(4, rc.vocab_size, size=(B, S)).astype(np.int32)
    if ignore_rows is None:
        labels[0, :3] = -1
        labels[-1, -2:] = -1
    else:
        labels[ignore_rows, :10] = -1
    return {"tokens": toks, "labels": labels}


def _ref_steps(rc, np_params, batch, microbatches=1):
    """The reference's STEPS train steps: the metrics of each, the params
    and first moments after the last, and each element's smallest |grad|
    over the steps (``jax.grad`` of the step's loss, averaged over its
    microbatches, on the reference's own trajectory)."""
    model = ref_build(rc)
    cfg = ref_opt.OptConfig(lr=W.LR, warmup_steps=1, total_steps=10)
    step = jax.jit(ref_steps.make_train_step(model, cfg,
                                             microbatches=microbatches))
    grad = jax.jit(jax.grad(lambda p, b: RT.forward_train_loss(p, rc, b)))
    p = jax.tree_util.tree_map(jnp.asarray, np_params)
    st = ref_init_from_schema(jax.random.PRNGKey(0),
                              ref_opt.adamw_init_schema(model.schema))
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    n = next(iter(batch.values())).shape[0] // microbatches
    mbs = [{k: v[i * n:(i + 1) * n] for k, v in b.items()}
           for i in range(microbatches)]
    metrics, gmin, gmax = [], None, None
    for _ in range(W.STEPS):
        g = jax.tree_util.tree_map(
            lambda *gs: np.abs(np.asarray(sum(gs) / len(gs))),
            *[grad(p, mb) for mb in mbs])
        gmin = g if gmin is None else jax.tree_util.tree_map(
            np.minimum, gmin, g)
        gmax = g if gmax is None else jax.tree_util.tree_map(
            np.maximum, gmax, g)
        p, st, m = step(p, st, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics,
            "params": jax.tree_util.tree_map(np.asarray, p),
            "m": jax.tree_util.tree_map(np.asarray, st["m"]),
            "gmin": gmin, "gmax": gmax}


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _paths(t, f"{prefix}/{i}")
    else:
        yield prefix, tree


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded")
    qc, dc, dc0 = (_ref_cfg(QWEN), _ref_cfg(DBRX), _ref_cfg(DBRX, NO_COEF))
    qp, dp_ = _np_params(qc), _np_params(dc)
    qb = _batch(qc, 4)
    qb_one = _batch(qc, 4, seed=1, ignore_rows=[2, 3])
    db4, db6 = _batch(dc, 4, seed=2), _batch(dc, 6, seed=3)
    ref = {
        "qwen": _ref_steps(qc, qp, qb),
        "qwen_one_rank_ignored": _ref_steps(qc, qp, qb_one),
        "qwen_mb2": _ref_steps(qc, qp, qb, microbatches=2),
        "dbrx_global_aux": _ref_steps(dc, dp_, db6),
        "dbrx_ep": _ref_steps(dc0, dp_, db4),
    }
    jb = {k: jnp.asarray(v) for k, v in qb.items()}
    ref["eval"] = float(jax.jit(ref_steps.make_eval_step(ref_build(qc)))(
        jax.tree_util.tree_map(jnp.asarray, qp), jb))
    ref["cached"] = _ref_cached(dc, dp_, db4["tokens"])
    ref["ep_aux"] = float(np.mean([
        RT.forward_train(jax.tree_util.tree_map(jnp.asarray, dp_), dc,
                         {"tokens": jnp.asarray(db4["tokens"][r:r + 2])})[1]
        ["aux_loss"] for r in (0, 2)]))

    def steps(key, arch, over, params, batch, kind="steps"):
        return (key, arch, over, params, batch, kind)
    worlds = {
        "dp=2": [steps("qwen", QWEN, {}, qp, qb),
                 steps("qwen_one_rank_ignored", QWEN, {}, qp, qb_one),
                 steps("qwen_mb2", QWEN, {}, qp, qb, "mb2"),
                 steps("dbrx_ep", DBRX, NO_COEF, dp_, db4, "ep"),
                 steps("eval", QWEN, {}, qp, qb, "eval"),
                 steps("cached", DBRX, {}, dp_, db4, "ep_cached"),
                 steps("ep_aux", DBRX, {}, dp_, db4, "ep_aux")],
        "dp=4": [steps("qwen", QWEN, {}, qp, qb)],
        "dp=1,mp=2": [steps("qwen", QWEN, {}, qp, qb),
                      steps("dbrx_global_aux", DBRX, {}, dp_, db6)] + [
            steps(f"refuse/{a}", a, {}, None, None, "refuse")
            for a in ("minicpm3-4b", "mamba2-130m", "whisper-large-v3")],
        "dp=2,mp=2": [steps("qwen", QWEN, {}, qp, qb),
                      steps("dbrx_ep", DBRX, NO_COEF, dp_, db4, "ep")],
        "dp=3": [steps("dbrx_global_aux", DBRX, {}, dp_, db6)],
        "pod=2,dp=2": [steps("qwen", QWEN, {}, qp, qb),
                       steps("dbrx_ep", DBRX, NO_COEF, dp_, db4, "ep")],
        "pod=2,mp=2": [steps("qwen", QWEN, {}, qp, qb)],
    }
    port = {}
    for spec, cases in worlds.items():
        n = int(np.prod([int(kv.split("=")[1]) for kv in spec.split(",")]))
        port[spec] = run_world(W.train_layout, n, tmp, spec, cases)
    return ref, port


def _ref_cached(rc, np_params, tokens):
    """The reference's single-device prefill and 4 greedy decode steps."""
    model = ref_build(rc)
    p = jax.tree_util.tree_map(jnp.asarray, np_params)
    B, S = tokens.shape
    cache = model.init_cache(B, S + 8)
    logits, cache = model.prefill(p, {"tokens": jnp.asarray(tokens)}, cache)
    got, toks = [np.asarray(logits)], []
    for _ in range(4):
        nxt = jnp.argmax(logits[:, -1], -1)
        toks.append(np.asarray(nxt))
        logits, cache = model.decode(p, {"tokens": nxt[:, None]}, cache)
        got.append(np.asarray(logits))
    return {"logits": got, "tokens": toks}


STEP_CASES = [("dp=2", "qwen"), ("dp=4", "qwen"), ("dp=1,mp=2", "qwen"),
              ("dp=2,mp=2", "qwen"), ("dp=2", "qwen_one_rank_ignored"),
              ("dp=2", "qwen_mb2"), ("dp=3", "dbrx_global_aux"),
              ("dp=1,mp=2", "dbrx_global_aux"),
              ("dp=2", "dbrx_ep"), ("dp=2,mp=2", "dbrx_ep"),
              ("pod=2,dp=2", "qwen"), ("pod=2,dp=2", "dbrx_ep"),
              ("pod=2,mp=2", "qwen")]
IDS = [f"{s}-{k}" for s, k in STEP_CASES]


@pytest.mark.parametrize("spec,key", STEP_CASES, ids=IDS)
def test_losses_and_grad_norms_match_reference(runs, spec, key):
    ref, port = runs
    want = ref[key]["metrics"]
    for r in port[spec]:
        got = r[key]["metrics"]
        for w, g in zip(want, got):
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(g[k], w[k], rtol=LOSS_RTOL,
                                           err_msg=f"{spec} {key} {k}")
            assert g["lr"] == pytest.approx(w["lr"], rel=1e-7)
        assert got[-1]["loss"] < got[0]["loss"]
        assert not r[key]["requires_grad"]


def _param_bars(w, gmin, gmax):
    """Each element's bar (see the module docstring) and the counts of
    elements it widens past PARAM_TOL and caps at 2 lr a step."""
    base = PARAM_TOL * np.abs(w).max()
    cap = 2 * W.LR * W.STEPS
    noise = NOISE_ULPS * np.finfo(np.float32).eps * gmax.max()
    amp = W.LR * noise / np.maximum(gmin, np.finfo(np.float32).tiny)
    bar = np.minimum(np.maximum(base, amp), cap)
    return bar, int((bar > base).sum()), int((bar == cap).sum())


@pytest.mark.parametrize("spec,key", STEP_CASES, ids=IDS)
def test_params_and_moments_match_reference(runs, spec, key):
    ref, port = runs
    want_p = dict(_paths(ref[key]["params"]))
    want_m = dict(_paths(ref[key]["m"]))
    gmin = dict(_paths(ref[key]["gmin"]))
    gmax = dict(_paths(ref[key]["gmax"]))
    bars = {name: _param_bars(w, gmin[name], gmax[name])
            for name, w in want_p.items()}
    n = sum(w.size for w in want_p.values())
    widened = sum(b[1] for b in bars.values())
    capped = sum(b[2] for b in bars.values())
    print(f"{spec} {key}: {widened} of {n} elements past {PARAM_TOL} of "
          f"their leaf's max, {capped} at 2 lr a step")
    for r in port[spec]:
        got_p = dict(_paths(r[key]["params"]))
        got_m = dict(_paths(r[key]["m"]))
        assert sorted(got_p) == sorted(want_p)
        for name, w in want_p.items():
            diff = np.abs(got_p[name] - w)
            bar = bars[name][0]
            worst = np.unravel_index(np.argmax(diff - bar), diff.shape)
            assert (diff <= bar).all(), (spec, key, name, worst,
                                         diff[worst], bar[worst])
            wm = want_m[name]
            np.testing.assert_allclose(got_m[name], wm, rtol=MOMENT_TOL,
                                       atol=MOMENT_TOL,
                                       err_msg=f"{spec} {key} m {name}")


def test_ignored_labels_on_one_rank_keep_the_global_mean(runs):
    """The mean of the two ranks' local means would differ from the
    global mean here: rank 1's rows have 20 fewer valid labels."""
    ref, port = runs
    loss = port["dp=2"][0]["qwen_one_rank_ignored"]["metrics"][0]["loss"]
    assert loss == pytest.approx(
        ref["qwen_one_rank_ignored"]["metrics"][0]["loss"], rel=LOSS_RTOL)


def _stub(dp, mp=1):
    return types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.empty((dp, mp), object))


def test_fsdp_holds_one_block_of_gathered_weights(runs):
    """At dp = 2 the peak of live gathered bytes is one block's leaves
    split over data, not every block's; a step gathers each such leaf
    twice a block (the forward and the rematerialized forward) and
    reduce-scatters its gradient once."""
    _, port = runs
    model = build_model(dataclasses.replace(get_config(QWEN, "smoke"),
                                            dtype="float32"))
    specs = specs_for_schema(model.schema, _stub(2), fsdp=True)
    # float32 bytes of one block's slice of each stacked leaf split over
    # data
    gathered = [4 * int(np.prod(ps.shape[1:]))
                for name, ps, spec in named_specs(model.schema, specs)
                if name.startswith("blocks/") and "data" in spec]
    n_blocks = model.schema["blocks"]["p0"]["ln1"].shape[0]
    assert gathered and n_blocks > 1
    one_block = sum(gathered)
    for r in port["dp=2"]:
        res = r["qwen"]
        assert res["peak"] == one_block, (res["peak"], one_block)
        for issued in res["issued"]:
            assert issued["reduce_scatter"] == len(gathered) * n_blocks
            assert issued["all_gather"] == 2 * len(gathered) * n_blocks
            # the loss's sums, the unsplit leaves' gradients, the norm
            assert issued["all_reduce"] == 3


def test_sharded_eval_step_matches_make_eval_step(runs):
    ref, port = runs
    for r in port["dp=2"]:
        assert r["eval"] == pytest.approx(ref["eval"], rel=LOSS_RTOL)


def test_ep_moe_fn_in_the_cached_forward(runs):
    ref, port = runs
    want = ref["cached"]
    for rank, r in enumerate(port["dp=2"]):
        got = r["cached"]
        rows = slice(2 * r["coords"]["data"], 2 * r["coords"]["data"] + 2)
        for g, w in zip(got["logits"], want["logits"]):
            w = w[rows]
            assert np.abs(g - w).max() <= LOGIT_TOL * np.abs(w).max()
        for g, w in zip(got["tokens"], want["tokens"]):
            np.testing.assert_array_equal(g, w[rows])


def test_ep_aux_is_the_mean_of_the_ranks_aux(runs):
    ref, port = runs
    for r in port["dp=2"]:
        assert r["ep_aux"] == pytest.approx(ref["ep_aux"], abs=1e-6)


@pytest.mark.parametrize("arch", ["minicpm3-4b", "mamba2-130m",
                                  "whisper-large-v3"])
def test_mp2_refuses_mla_mamba2_whisper(runs, arch):
    """Mamba2 and Whisper are refused; MLA's route builds the step."""
    _, port = runs
    for r in port["dp=1,mp=2"]:
        msg = r[f"refuse/{arch}"]
        if arch == "minicpm3-4b":
            assert msg is None, msg
            continue
        assert msg is not None, f"{arch} trained at mp=2"
        assert "at mp=2 has no collective" in msg, msg
        assert "ROADMAP.md queue 1, item 9" in msg


@pytest.fixture(scope="module")
def head_dim_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("head_dim")
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(4, 512, size=(4, 48)).astype(np.int32)
             for k in ("tokens", "labels")}
    batch["labels"][0, :5] = -1
    return {spec: run_world(W.grads_head_dim, 4, tmp, spec,
                            [(k, a, o, batch) for k, (a, o) in
                             cases.items()])
            for spec, cases in HEAD_DIM.items()}


@pytest.mark.parametrize("spec,key", HEAD_DIM_CASES,
                         ids=[f"{s}-{k}" for s, k in HEAD_DIM_CASES])
def test_head_dim_split_loss_and_gradients_match_one_device(head_dim_runs,
                                                            spec, key):
    arch, over = HEAD_DIM[spec][key]
    cfg = dataclasses.replace(get_config(arch, "smoke"), **over)
    mp = int(spec.split("mp=")[1])
    # the route is taken: the kv heads do not divide mp
    assert cfg.n_kv_heads % mp
    for r in head_dim_runs[spec]:
        loss, sloss = r[key]["loss"]
        assert sloss == pytest.approx(loss, rel=LOSS_RTOL)
        grads = r[key]["grads"]
        assert len(grads) == len(list(_paths(build_model(cfg).schema)))
        for name, (g, s) in grads.items():
            assert s.shape == g.shape, name
            bar = HEAD_DIM_GRAD_TOL * np.abs(g).max()
            assert np.abs(s - g).max() <= bar, (name, np.abs(s - g).max(),
                                                bar)
        assert np.abs(grads["blocks/p0/attn/wk"][0]).max() > 0


def test_pod_sums_the_fsdp_shards_gradients_over_pod(runs):
    """On the multi-pod layout a step adds one all-reduce a dtype: the
    FSDP shards' reduce-scattered gradients summed over pod (the loss's
    sums and the unsplit leaves' gradients go over pod x data in the
    same all-reduces as on one pod)."""
    _, port = runs
    for r in port["pod=2,dp=2"]:
        for issued in r["qwen"]["issued"]:
            assert issued["all_reduce"] == 4, issued
    coords = sorted(tuple(r["coords"][a] for a in ("pod", "data", "model"))
                    for r in port["pod=2,dp=2"])
    assert coords == [(0, 0, 0), (0, 1, 0), (1, 0, 0), (1, 1, 0)]
