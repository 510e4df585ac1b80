"""The port's training path against the reference, on qwen SMOKE.

Weights come from the reference's ``Model.init`` plus seeded numpy noise
(so biases and norm weights are not trivially 0 and 1), carried across
by ``repro_torch.bridge``; tokens and labels are numpy draws with some
labels set to the ignore id.  The reference's functions run jitted on
the CPU; the port's run eagerly on CPU tensors.

Tolerances, float32 unless stated: forward logits 1e-4 (the same sums
in another order); losses 1e-5 relative; gradients 1e-4 of each leaf's
largest entry (the backward sums run in another order, and the tied
embedding adds the lookup's and the unembedding's parts in another
order); one AdamW update 1e-6; three train steps: losses 1e-5 relative,
moments 1e-5, params 1e-5 for all but one in 10,000 elements and within
``2 * lr`` a step for every element.  Adam divides m by sqrt(v): an
element whose gradient is as small as the summation noise can move by
a different fraction of ``lr``, up to a sign flip, in either package.
"""
import torch_threads  # noqa: F401  (caps torch's threads under xdist)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as ref_config
from repro.data.lm_dataset import LMDataset as RefLMDataset
from repro.models import build_model as ref_build
from repro.models import transformer as RT
from repro.models.schema import init_from_schema as ref_init_from_schema
from repro.training import checkpoint as ref_ckpt
from repro.training import optimizer as ref_opt
from repro.training import steps as ref_steps
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.data.lm_dataset import LMDataset
from repro_torch.launch import train as train_cli
from repro_torch.models import build_model
from repro_torch.models import transformer as T
from repro_torch.models.schema import tree_leaves, tree_map, zeros_from_schema
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optimizer as opt
from repro_torch.training import steps

LOGIT_TOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
ADAM_TOL = 1e-6
MOMENT_TOL = 1e-5
PARAM_TOL = 1e-5
PARAM_OUTLIERS = 1e-4     # share of elements allowed past PARAM_TOL


def _configs(dtype="float32", **kw):
    rc = dataclasses.replace(ref_config("qwen1.5-32b", "smoke"), dtype=dtype,
                             **kw)
    tc = dataclasses.replace(get_config("qwen1.5-32b", "smoke"), dtype=dtype,
                             **kw)
    return rc, tc


def _np_params(rc, seed=0):
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        np.asarray, ref_build(rc).init(jax.random.PRNGKey(0)))
    return jax.tree_util.tree_map(
        lambda a: (a.astype(np.float32)
                   + rng.normal(0, 0.02, a.shape).astype(np.float32)
                   ).astype(a.dtype), params)


def _both_params(rc, seed=0):
    p = _np_params(rc, seed)
    return (jax.tree_util.tree_map(jnp.asarray, p),
            params_from_numpy(p, device="cpu"))


def _batch(rc, B=2, S=32, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(4, rc.vocab_size, size=(B, S)).astype(np.int32)
    labels = rng.integers(4, rc.vocab_size, size=(B, S)).astype(np.int32)
    labels[0, :3] = -1                     # ignored positions
    labels[-1, -2:] = -1
    return {"tokens": toks, "labels": labels}


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _torch(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def _np(t):
    return t.detach().float().numpy()


def _paths(tree, prefix=""):
    """(key, leaf) pairs of a dict/list tree, dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _paths(t, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _assert_trees_close(got, want, rtol, atol_frac=None):
    """Leaf by leaf; ``atol_frac`` scales the absolute tolerance by each
    reference leaf's largest entry."""
    want = dict(_paths(jax.tree_util.tree_map(np.asarray, want)))
    got = dict(_paths(got))
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        w = np.asarray(w, np.float32)
        atol = rtol if atol_frac is None else atol_frac * np.abs(w).max()
        np.testing.assert_allclose(_np(got[key]), w, rtol=rtol, atol=atol,
                                   err_msg=key)


def _assert_adam_params_close(got, want, bound, tol=PARAM_TOL):
    """Params after Adam steps: all but PARAM_OUTLIERS of the elements
    within ``tol``, every element within ``bound`` (see the module's
    docstring)."""
    want = dict(_paths(jax.tree_util.tree_map(np.asarray, want)))
    got = dict(_paths(got))
    assert sorted(got) == sorted(want)
    n = past = 0
    for key, w in want.items():
        diff = np.abs(_np(got[key]) - np.asarray(w, np.float32))
        assert diff.max() <= bound, (key, diff.max(), bound)
        n, past = n + diff.size, past + int((diff > tol).sum())
    assert past <= PARAM_OUTLIERS * n, (past, n)


# ---------------------------------------------------------------------------
# forward and losses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_kv_heads", [4, 2], ids=["G1", "G2"])
def test_forward_train_logits_match_reference(n_kv_heads):
    rc, tc = _configs(n_kv_heads=n_kv_heads)
    rp, tp = _both_params(rc)
    b = _batch(rc)
    want, wx = jax.jit(lambda p, x: RT.forward_train(p, rc, x))(
        rp, {"tokens": jnp.asarray(b["tokens"])})
    got, gx = build_model(tc).train_logits(
        tp, {"tokens": torch.from_numpy(b["tokens"])})
    assert got.dtype == torch.float32 and float(gx["aux_loss"]) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)


def test_loss_fn_and_forward_train_loss_match_reference():
    rc, tc = _configs()
    rp, tp = _both_params(rc)
    b = _batch(rc)
    logits, extras = RT.forward_train(rp, rc, {"tokens": jnp.asarray(
        b["tokens"])})
    want_ce = RT.loss_fn(logits, jnp.asarray(b["labels"]), extras=extras)
    want_fused = RT.forward_train_loss(rp, rc, _jnp(b))
    tb = _torch(b)
    tl, tx = T.forward_train(tp, tc, {"tokens": tb["tokens"]})
    got_ce = T.loss_fn(tl, tb["labels"], extras=tx)
    got_fused = T.forward_train_loss(tp, tc, tb)
    np.testing.assert_allclose(float(got_ce), float(want_ce), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(got_fused), float(want_fused),
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("S,chunk", [(96, 512), (96, 40), (96, 7), (60, 16)])
def test_chunked_ce_matches_reference(S, chunk):
    """The chunk is ``min(chunk, S)`` lowered until it divides S (96, 32,
    6 and 15 here), with the ignore mask and the z-loss."""
    rng = np.random.default_rng(S + chunk)
    B, d, V = 2, 16, 40
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    w = rng.standard_normal((V, d)).astype(np.float32)
    lab = rng.integers(0, V, size=(B, S)).astype(np.int32)
    lab[:, ::5] = -1
    wt, wn = RT.chunked_ce(jnp.asarray(x), jnp.asarray(w), jnp.asarray(lab),
                           chunk=chunk)
    gt, gn = T.chunked_ce(torch.from_numpy(x), torch.from_numpy(w),
                          torch.from_numpy(lab), chunk=chunk)
    assert gn.dtype == torch.int32 and int(gn) == int(wn)
    np.testing.assert_allclose(float(gt), float(wt), rtol=LOSS_RTOL)


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------


def _port_grads(tc, tp, batch):
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    loss = T.forward_train_loss(tp, tc, _torch(batch))
    grads = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    flat = iter(grads)
    return loss.detach(), tree_map(lambda _: next(flat), tp)


def test_gradients_match_jax_grad_leaf_by_leaf():
    """Every leaf, the stacked ``blocks`` ones (their per-block views)
    and the tied embedding (lookup plus unembedding) included."""
    rc, tc = _configs(remat="full")
    rp, tp = _both_params(rc)
    b = _batch(rc)
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p: RT.forward_train_loss(p, rc, _jnp(b))))(rp)
    loss, got = _port_grads(tc, tp, b)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_RTOL)
    _assert_trees_close(got, want, 0.0, atol_frac=GRAD_TOL)
    assert got["blocks"]["p0"]["mlp"]["w_up"].shape[0] == tc.n_layers


def test_remat_modes_give_equal_gradients():
    """``none``, ``full`` and ``dots`` recompute the same values, so the
    gradients are the same, bit for bit, on the host."""
    rc, _ = _configs()
    np_params = _np_params(rc)
    b = _batch(rc)
    out = {}
    for remat in ("none", "full", "dots"):
        _, tc = _configs(remat=remat)
        out[remat] = _port_grads(tc, params_from_numpy(np_params,
                                                       device="cpu"), b)
    for remat in ("full", "dots"):
        assert float(out[remat][0]) == float(out["none"][0])
        for g, w in zip(tree_leaves(out[remat][1]),
                        tree_leaves(out["none"][1])):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


class _CountMatmuls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def test_remat_dots_saves_the_weight_products():
    """``dots`` keeps the weight products' outputs: its backward pass runs
    as many matrix products as ``none``'s (the gradients' alone), while
    ``full`` recomputes the forward's products as well."""
    rc, _ = _configs()
    np_params = _np_params(rc)
    b = _torch(_batch(rc))
    counts = {}
    for remat in ("none", "full", "dots"):
        _, tc = _configs(remat=remat)
        tp = params_from_numpy(np_params, device="cpu")
        leaves = tree_leaves(tp)
        for p in leaves:
            p.requires_grad_(True)
        loss = T.forward_train_loss(tp, tc, b)
        with _CountMatmuls() as mode:
            torch.autograd.grad(loss, leaves)
        counts[remat] = mode.n
    assert counts["dots"] == counts["none"] < counts["full"], counts


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


def test_lr_schedule_matches_reference():
    cfg = dict(lr=3e-4, warmup_steps=7, total_steps=40, min_lr_frac=0.1)
    rcfg, tcfg = ref_opt.OptConfig(**cfg), opt.OptConfig(**cfg)
    steps_ = np.arange(0, 46, dtype=np.int32)
    want = np.asarray(jax.vmap(lambda s: ref_opt.lr_at(rcfg, s))(
        jnp.asarray(steps_)))
    got = opt.lr_at(tcfg, torch.from_numpy(steps_)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


def _opt_state_np(rc, seed):
    """A reference AdamW state with nonzero moments at step 5."""
    rng = np.random.default_rng(seed)
    schema = ref_opt.adamw_init_schema(ref_build(rc).schema)
    st = jax.tree_util.tree_map(
        np.asarray, ref_init_from_schema(jax.random.PRNGKey(0), schema))
    st["m"] = jax.tree_util.tree_map(
        lambda a: rng.normal(0, 1e-3, a.shape).astype(np.float32), st["m"])
    st["v"] = jax.tree_util.tree_map(
        lambda a: rng.uniform(0, 1e-6, a.shape).astype(np.float32), st["v"])
    st["step"] = np.asarray(5, np.int32)
    return st


def test_adamw_update_matches_reference():
    rc, tc = _configs()
    rng = np.random.default_rng(3)
    np_params = _np_params(rc)
    np_grads = jax.tree_util.tree_map(
        lambda a: rng.normal(0, 1e-2, a.shape).astype(np.float32), np_params)
    st = _opt_state_np(rc, 4)
    cfg = dict(lr=1e-2, warmup_steps=3, total_steps=20, clip_norm=0.5)
    want_p, want_st, want_m = jax.jit(
        lambda g, s, p: ref_opt.adamw_update(g, s, p, ref_opt.OptConfig(
            **cfg)))(_jnp(np_grads), _jnp(st), _jnp(np_params))
    tst = params_from_numpy(st, device="cpu")
    tp = params_from_numpy(np_params, device="cpu")
    got_p, got_st, got_m = opt.adamw_update(
        params_from_numpy(np_grads, device="cpu"), tst, tp,
        opt.OptConfig(**cfg))
    assert got_p is tp and got_st is tst          # updated in place
    assert got_st["step"].dtype == torch.int32 and int(got_st["step"]) == 6
    assert int(want_st["step"]) == 6
    for key in ("m", "v"):
        _assert_trees_close(got_st[key], want_st[key], ADAM_TOL)
    _assert_trees_close(got_p, want_p, ADAM_TOL)
    for key in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(got_m[key]), float(want_m[key]),
                                   rtol=1e-6)


def test_bridge_carries_the_optimizer_state():
    """The reference's AdamW state crosses with ``params_from_numpy``:
    float32 moments shaped as the params and the int32 scalar step."""
    rc, tc = _configs(dtype="bfloat16")
    st = _opt_state_np(rc, 0)
    got = params_from_numpy(st, device="cpu")
    assert got["step"].shape == () and got["step"].dtype == torch.int32
    assert int(got["step"]) == 5
    want = zeros_from_schema(opt.adamw_init_schema(build_model(tc).schema),
                             device="cpu")
    for (k, g), (_, w) in zip(_paths(got), _paths(want)):
        assert g.shape == w.shape and g.dtype == w.dtype, k
    np.testing.assert_array_equal(_np(got["m"]["embed"]), st["m"]["embed"])


# ---------------------------------------------------------------------------
# train and eval steps
# ---------------------------------------------------------------------------


def _run_steps(rc, tc, *, n=3, fused_loss=True, microbatches=1, lr=1e-3,
               B=4, S=32):
    cfg = dict(lr=lr, warmup_steps=1, total_steps=10)
    np_params = _np_params(rc)
    rp = jax.tree_util.tree_map(jnp.asarray, np_params)
    tp = params_from_numpy(np_params, device="cpu")
    rst = ref_init_from_schema(jax.random.PRNGKey(0),
                               ref_opt.adamw_init_schema(ref_build(rc).schema))
    tst = zeros_from_schema(opt.adamw_init_schema(build_model(tc).schema),
                            device="cpu")
    rstep = jax.jit(ref_steps.make_train_step(
        ref_build(rc), ref_opt.OptConfig(**cfg), microbatches=microbatches,
        fused_loss=fused_loss))
    tstep = steps.make_train_step(build_model(tc), opt.OptConfig(**cfg),
                                  microbatches=microbatches,
                                  fused_loss=fused_loss)
    want, got = [], []
    b = _batch(rc, B=B, S=S, seed=10)     # one batch: its loss must fall
    for _ in range(n):
        rp, rst, rm = rstep(rp, rst, _jnp(b))
        tp, tst, tm = tstep(tp, tst, _torch(b))
        want.append({k: float(v) for k, v in rm.items()})
        got.append({k: float(v) for k, v in tm.items()})
    return want, got, (rp, rst), (tp, tst)


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("fused_loss", [True, False], ids=["fused", "logits"])
def test_train_steps_match_reference(fused_loss, microbatches):
    rc, tc = _configs()
    want, got, (rp, rst), (tp, tst) = _run_steps(
        rc, tc, fused_loss=fused_loss, microbatches=microbatches)
    for w, g in zip(want, got):
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(g[key], w[key], rtol=LOSS_RTOL,
                                       err_msg=key)
    assert got[-1]["loss"] < got[0]["loss"]
    assert int(tst["step"]) == 3
    _assert_adam_params_close(tp, rp, bound=2 * 1e-3 * 3)
    _assert_trees_close(tst["m"], rst["m"], MOMENT_TOL)
    assert all(not p.requires_grad for p in tree_leaves(tp))


def test_bf16_train_step_within_stated_tolerance():
    """bf16 params and gradients: each framework rounds products, bias
    adds and the tied embedding's two gradient parts at its own points,
    so a bf16 gradient differs in its last bits.  The loss agrees within
    1e-2 relative and the gradient norm within 5e-2.  After one step (lr
    1e-3) every param is within one Adam sign flip (2 lr) plus one bf16
    rounding step at its leaf's largest entry (1/128 of its power of
    two), and all but a 1e-2 share round to the same bf16 value."""
    rc, tc = _configs(dtype="bfloat16")
    want, got, (rp, _), (tp, _) = _run_steps(rc, tc, n=1)
    np.testing.assert_allclose(got[0]["loss"], want[0]["loss"], rtol=1e-2)
    np.testing.assert_allclose(got[0]["grad_norm"], want[0]["grad_norm"],
                               rtol=5e-2)
    assert all(p.dtype == torch.bfloat16 for p in tree_leaves(tp))
    n = differ = 0
    for (k, g), (_, w) in zip(_paths(tp), _paths(jax.tree_util.tree_map(
            np.asarray, rp))):
        w = np.asarray(w, np.float32)
        ulp = 2.0 ** (np.floor(np.log2(np.abs(w).max())) - 7)
        diff = np.abs(_np(g) - w)
        assert diff.max() <= 2e-3 + ulp, (k, diff.max(), 2e-3 + ulp)
        n, differ = n + diff.size, differ + int((diff > 0).sum())
    assert differ <= 1e-2 * n, (differ, n)


@pytest.mark.parametrize("use_pallas_attention", [False, True])
def test_eval_step_matches_reference(use_pallas_attention):
    """S = 128: with ``use_pallas_attention`` the layers take the flash
    attention path (the reference's Pallas kernel in interpret mode, the
    port's plain version on the host)."""
    rc, tc = _configs(use_pallas_attention=use_pallas_attention)
    rp, tp = _both_params(rc)
    b = _batch(rc, B=2, S=128)
    want = jax.jit(ref_steps.make_eval_step(ref_build(rc)))(rp, _jnp(b))
    got = steps.make_eval_step(build_model(tc))(tp, _torch(b))
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)


def test_train_step_with_flash_attention_raises():
    """The reference cannot differentiate through its flash attention
    kernel; the port's guard refuses the same step, and leaves the
    params' flags as they were."""
    rc, tc = _configs(use_pallas_attention=True)
    _, tp = _both_params(rc)
    tm = build_model(tc)
    tst = zeros_from_schema(opt.adamw_init_schema(tm.schema), device="cpu")
    step = steps.make_train_step(tm, opt.OptConfig())
    with pytest.raises(RuntimeError, match="no gradient"):
        step(tp, tst, _torch(_batch(rc, B=1, S=128)))
    assert all(not p.requires_grad for p in tree_leaves(tp))
    assert int(tst["step"]) == 0
    # 96 is not a multiple of 128: the plain attention, which trains
    step(tp, tst, _torch(_batch(rc, B=1, S=96)))
    assert int(tst["step"]) == 1


# ---------------------------------------------------------------------------
# data, checkpoints, command line
# ---------------------------------------------------------------------------


def test_lm_dataset_draws_the_reference_batches():
    rc, tc = _configs()
    rit = RefLMDataset(rc, 64, seed=3).batches(4)
    tit = LMDataset(tc, 64, seed=3).batches(4)
    for _ in range(5):
        w, g = next(rit), next(tit)
        assert sorted(g) == sorted(w) == ["labels", "tokens"]
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoints_cross_between_the_packages(tmp_path, dtype):
    rc, tc = _configs(dtype=dtype)
    rm, tm = ref_build(rc), build_model(tc)
    np_params = _np_params(rc)
    st = _opt_state_np(rc, 1)
    rp = jax.tree_util.tree_map(jnp.asarray, np_params)
    rst = jax.tree_util.tree_map(jnp.asarray, st)
    tmpl_p = tm.init(seed=1, device="cpu")
    tmpl_st = zeros_from_schema(opt.adamw_init_schema(tm.schema),
                                device="cpu")

    # reference -> port
    ref_ckpt.save_checkpoint(tmp_path / "ref", 7, rp, rst)
    step, got_p, got_st = ckpt.load_checkpoint(tmp_path / "ref", tmpl_p,
                                               tmpl_st)
    assert step == 7
    for (k, g), (_, w) in zip(_paths(got_p), _paths(tmpl_p)):
        assert g.dtype == w.dtype and g.shape == w.shape, k
    _assert_trees_close(got_p, rp, 0.0)
    _assert_trees_close(got_st, rst, 0.0)
    assert got_st["step"].dtype == torch.int32 and int(got_st["step"]) == 5

    # port -> reference
    ckpt.save_checkpoint(tmp_path / "port", 9, got_p, got_st)
    assert (sorted(np.load(tmp_path / "port" / "params_9.npz").files)
            == sorted(np.load(tmp_path / "ref" / "params_7.npz").files))
    step, back_p, back_st = ref_ckpt.load_checkpoint(
        tmp_path / "port", rm.init(jax.random.PRNGKey(1)),
        ref_init_from_schema(jax.random.PRNGKey(0),
                             ref_opt.adamw_init_schema(rm.schema)))
    assert step == 9
    for a, b in zip(jax.tree_util.tree_leaves(back_p),
                    jax.tree_util.tree_leaves(rp)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))
    for a, b in zip(jax.tree_util.tree_leaves(back_st),
                    jax.tree_util.tree_leaves(rst)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_load_checks_shapes(tmp_path):
    _, tc = _configs()
    tm = build_model(tc)
    params = tm.init(seed=0, device="cpu")
    ckpt.save_checkpoint(tmp_path, 1, params)
    wrong = dataclasses.replace(tc, d_ff=2 * tc.d_ff)
    with pytest.raises(ValueError, match="shape"):
        ckpt.load_checkpoint(tmp_path, build_model(wrong).init(
            seed=0, device="cpu"))


def test_train_cli_on_the_host(tmp_path, capsys):
    losses = train_cli.main(["--arch", "qwen1.5-32b", "--variant", "smoke",
                             "--steps", "5", "--batch", "2", "--seq", "32",
                             "--log-every", "2", "--device", "cpu",
                             "--ckpt", str(tmp_path)])
    out = capsys.readouterr().out
    assert len(losses) == 5 and np.isfinite(losses).all()
    assert "final loss" in out and "saved" in out
    tm = build_model(get_config("qwen1.5-32b", "smoke"))
    step, params, st = ckpt.load_checkpoint(
        tmp_path, tm.init(seed=1, device="cpu"),
        zeros_from_schema(opt.adamw_init_schema(tm.schema), device="cpu"))
    assert step == 5 and int(st["step"]) == 5
    fresh = tm.init(seed=0, device="cpu")
    assert not torch.equal(params["embed"], fresh["embed"])  # it trained


def test_train_cli_default_arch_trains(capsys):
    """The reference's default ``--arch``, mamba2-130m (SMOKE, chunk 64),
    trains on the host."""
    losses = train_cli.main(["--device", "cpu", "--steps", "2"])
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert "final loss" in capsys.readouterr().out
