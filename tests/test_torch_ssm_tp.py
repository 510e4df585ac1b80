"""Mamba2 under tensor parallelism, on gloo worlds.

The resolver splits a Mamba2 layer's ``d_inner`` over ``model``: ``w_z``
/ ``w_x``'s columns, ``conv_x``, ``norm``, ``w_out``'s rows and the
cache's ``conv_x``; ``w_B``, ``w_C``, ``w_dt``, ``dt_bias``, ``A_log``,
``D``, ``conv_B``, ``conv_C`` and the cache's ``state`` stay whole.  The
port's route (``models/ssm.py::ssm_apply`` with ``tp``) computes each
rank's channels as sub-heads of width ``gcd(d_inner / mp, head_dim)``,
writes only the rank's rows of ``state``, and all-reduces the gated
norm's sum of squares and ``w_out``'s output.  The reference's own
sharded path is red on this jax, so the port's tensor parallelism is
held against the single-device port, and one layer against the
reference's ``ssm_apply``; the single-device port is held against the
reference in ``tests/test_torch_ssm.py``.

Float32 SMOKE configs, seeded weights, one spawned gloo world a layout
(``tests/torch_dist.py::ssm_tp``):

* ``mp4``: mamba2 SMOKE at ``d_model`` = 192 (``d_inner`` 384, 6 heads
  of 64): 96 columns a rank, 1.5 heads, sub-heads of 32 (mamba2-130m's
  shape at mp = 16); jamba SMOKE (2 kv heads on the head_dim route, its
  MoE layer on ``d_ff_expert``, 2 heads of 64 a rank).
* ``dp2mp2``: mamba2 SMOKE at dp = 2 x mp = 2 (4 whole heads a rank).

Checks: the dense engine's greedy tokens (6 prompts of 20-40 tokens, 12
new ones) equal the single-device engine's; the logits of a prefill
and 3 greedy decode steps within ``LOGIT_RTOL``; each rank's ``conv_x``
columns and owned ``state`` rows of its slots within ``CACHE_RTOL`` of
the single-device cache's, its other ``state`` rows zero; one layer (a
prefill of 12 rows and 3 decode steps, ``n_groups`` 1, 2 and 3) within
``LAYER_RTOL`` of the reference's ``ssm_apply``, its cache too; the
sharded train step's loss (``LOSS_RTOL``) and every leaf's gradient
(``GRAD_TOL`` of the leaf's largest |gradient|) against the
single-device ``forward_train_loss`` at SMOKE's chunk of 64; the
sharded eval loss with ``use_pallas_ssd`` (K6's plain version here, on
the rank's sub-heads) against ``make_eval_step``.  Without a world: the
sub-head map at mamba2-130m's mp = 16, each rank's sub-heads through
``ssd_chunk_scan_torch`` reassembled into the whole call.
"""
import torch_threads  # noqa: F401  (caps torch's threads under xdist)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist as W
from repro.configs import get_config as ref_config
from repro.models.ssm import ssm_apply as ref_ssm_apply
from repro_torch.configs import get_config
from repro_torch.kernels.ssd_scan import ssd_chunk_scan_torch
from repro_torch.models import build_model
from repro_torch.models.schema import tree_map_with_path
from repro_torch.models.ssm import ssm_dims, ssm_schema, sub_heads

LOGIT_RTOL = 1e-4   # of max |logit|: float32, the norm's and the output's
#                     partial sums added in another order
CACHE_RTOL = 1e-5   # of the leaf's max |value|: the same rows
LAYER_RTOL = 1e-5   # of max |out|: one layer, float32
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-5     # of the leaf's largest |gradient|
SCAN_RTOL = 1e-5    # of max |y|: the same channels, other batch shapes

MAMBA, JAMBA = "mamba2-130m", "jamba-1.5-large-398b"
# key -> (arch, config fields, ssm fields)
CASES = {"mamba_uneven": (MAMBA, {"d_model": 192}, {}),
         "mamba": (MAMBA, {}, {}),
         "jamba": (JAMBA, {}, {})}
# layout -> (mesh spec, world size, mp, its cases)
LAYOUTS = {"mp4": ("dp=1,mp=4", 4, 4, ("mamba_uneven", "jamba")),
           "dp2mp2": ("dp=2,mp=2", 4, 2, ("mamba",))}
CASE_IDS = [(lay, key) for lay, (*_, keys) in LAYOUTS.items()
            for key in keys]
IDS = [f"{lay}-{k}" for lay, k in CASE_IDS]
# one layer against the reference: (layout, case, n_groups)
LAYER_CASES = [("mp4", "mamba_uneven", g) for g in (1, 2, 3)] + [
    ("dp2mp2", "mamba", 2)]
LAYER_IDS = [f"{lay}-{k}-g{g}" for lay, k, g in LAYER_CASES]


def _cfg(key, **ssm_over):
    arch, over, so = CASES[key]
    cfg = dataclasses.replace(get_config(arch, "smoke"), dtype="float32",
                              **over)
    return dataclasses.replace(cfg, ssm=dataclasses.replace(
        cfg.ssm, **so, **ssm_over))


def _prompts():
    rng = np.random.default_rng(0)
    return [list(map(int, rng.integers(4, 500, size=int(n))))
            for n in (20, 33, 40, 27, 24, 36)]


def _layer_weights(cfg, rng):
    """Seeded numpy weights of one Mamba2 layer: normal of 1 / sqrt(fan
    in); the ``ones`` leaves 1 + noise, the ``zeros`` and ``small`` ones
    noise of 0.1."""
    out = {}
    for k, ps in ssm_schema(cfg).items():
        if ps.init == "ones":
            v = 1.0 + rng.normal(0, 0.02, ps.shape)
        elif ps.init in ("zeros", "small"):
            v = rng.normal(0, 0.1, ps.shape)
        else:
            v = rng.normal(0, ps.shape[0] ** -0.5, ps.shape)
        out[k] = v.astype(np.float32)
    return out


def _reference_layer(key, groups, p, x, steps):
    """The reference's ``ssm_apply``: a prefill of ``x``, then a decode
    step a column of ``steps``; each output and the final cache."""
    arch, over, so = CASES[key]
    rc = dataclasses.replace(ref_config(arch, "smoke"), dtype="float32",
                             **over)
    rc = dataclasses.replace(rc, ssm=dataclasses.replace(
        rc.ssm, **so, n_groups=groups))
    cfg = _cfg(key, n_groups=groups)
    d_inner, H = ssm_dims(cfg)
    s, B = cfg.ssm, x.shape[0]
    gn = s.n_groups * s.d_state
    cache = {"state": jnp.zeros((B, H, s.head_dim, s.d_state), jnp.float32),
             "conv_x": jnp.zeros((B, s.d_conv - 1, d_inner), jnp.float32),
             "conv_B": jnp.zeros((B, s.d_conv - 1, gn), jnp.float32),
             "conv_C": jnp.zeros((B, s.d_conv - 1, gn), jnp.float32)}
    pj = jax.tree_util.tree_map(jnp.asarray, p)
    y, cache = ref_ssm_apply(pj, jnp.asarray(x), rc, cache=cache)
    outs = [np.asarray(y)]
    for i in range(steps.shape[1]):
        y, cache = ref_ssm_apply(pj, jnp.asarray(steps[:, i:i + 1]), rc,
                                 cache=cache)
        outs.append(np.asarray(y))
    return outs, {k: np.asarray(v) for k, v in cache.items()}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """One world a layout; the reference's layers beside them."""
    tmp = tmp_path_factory.mktemp("ssm_tp")
    rng = np.random.default_rng(1)
    ref, layer = {}, {lay: [] for lay in LAYOUTS}
    for lay, key, g in LAYER_CASES:
        cfg = _cfg(key, n_groups=g)
        p = _layer_weights(cfg, rng)
        x = rng.normal(size=(2, 12, cfg.d_model)).astype(np.float32)
        steps = rng.normal(size=(2, 3, cfg.d_model)).astype(np.float32)
        ref[(lay, key, g)] = _reference_layer(key, g, p, x, steps)
        arch, over, so = CASES[key]
        layer[lay].append(((key, g), arch, over, {**so, "n_groups": g}, p,
                           x, steps))
    drng = np.random.default_rng(0)
    train = {k: drng.integers(4, 512, size=(4, 32)).astype(np.int32)
             for k in ("tokens", "labels")}
    train["labels"][0, :5] = -1
    evals = {k: drng.integers(4, 512, size=(4, 128)).astype(np.int32)
             for k in ("tokens", "labels")}
    port = {}
    for lay, (spec, n, _, keys) in LAYOUTS.items():
        port[lay] = W.run_world(
            W.ssm_tp, n, tmp, spec,
            [(k, *CASES[k]) for k in keys], layer[lay],
            [(k, CASES[k][0], CASES[k][1], train) for k in keys],
            [(k, CASES[k][0], CASES[k][1], evals) for k in keys],
            _prompts(), 12)
    return ref, port


@pytest.mark.parametrize("layout,key", CASE_IDS, ids=IDS)
def test_ssm_split_serves_the_single_device_tokens(worlds, layout, key):
    for rank in worlds[1][layout]:
        single, got = rank["serve"][key]["tokens"]
        assert len(single) == 6 and all(len(t) == 12 for t in single)
        assert got == single


@pytest.mark.parametrize("layout,key", CASE_IDS, ids=IDS)
def test_ssm_split_logits_match_one_device(worlds, layout, key):
    for rank in worlds[1][layout]:
        want = rank["serve"][key][("logits", "single")]
        got = rank["serve"][key][("logits", "sharded")]
        assert len(got) == 4
        for g, w in zip(got, want):
            assert g.shape == w.shape
            err = np.abs(g - w).max() / np.abs(w).max()
            assert err <= LOGIT_RTOL, err


@pytest.mark.parametrize("layout,key", CASE_IDS, ids=IDS)
def test_ssm_split_leaves_and_cache_rows_on_each_rank(worlds, layout, key):
    """``w_z`` / ``w_x`` / ``conv_x`` / ``norm`` hold the rank's columns
    of ``d_inner``, ``w_out`` its rows, the rest whole; the slot cache's
    and the scratch's ``conv_x`` the rank's columns, ``state`` whole;
    after the serve, the rank's ``conv_x`` columns and owned ``state``
    rows of its slots equal the single-device cache's, its other
    ``state`` rows are zero, ``conv_B`` / ``conv_C`` equal whole."""
    cfg = _cfg(key)
    mp = LAYOUTS[layout][2]
    d_inner, H = ssm_dims(cfg)
    c, hd, N = d_inner // mp, cfg.ssm.head_dim, cfg.ssm.d_state
    for rank in worlds[1][layout]:
        res = rank["serve"][key]
        sh = res["shapes"]
        for w in ("w_z", "w_x"):
            assert sh[w][-2:] == (cfg.d_model, c), sh[w]
        assert sh["conv_x"][-1] == c and sh["norm"][-1] == c
        assert sh["w_out"][-2:] == (c, cfg.d_model)
        assert sh["w_B"][-1] == cfg.ssm.n_groups * N
        assert sh["A_log"][-1] == H
        for shapes in (sh["cache"], sh["scratch"]):
            assert shapes["conv_x"][-1] == c
            assert shapes["state"][-3:] == (H, hd, N)
        r = rank["coords"]["model"]
        want, got = res["cache"]["conv_x"]
        cols = want[..., r * c:(r + 1) * c]
        assert got.shape == cols.shape
        assert np.abs(got - cols).max() <= CACHE_RTOL * np.abs(want).max()
        want, got = res["cache"]["state"]
        assert got.shape == want.shape
        nb, B = want.shape[:2]
        flat_w = want.reshape(nb, B, H * hd, N)
        flat_g = got.reshape(nb, B, H * hd, N)
        own = slice(r * c, (r + 1) * c)
        assert np.abs(flat_w[:, :, own]).max() > 0
        assert np.abs(flat_g[:, :, own] - flat_w[:, :, own]).max() <= (
            CACHE_RTOL * np.abs(want).max())
        rest = np.delete(flat_g, np.arange(r * c, (r + 1) * c), axis=2)
        assert not rest.any()
        for leaf in ("conv_B", "conv_C"):
            want, got = res["cache"][leaf]
            assert np.abs(got - want).max() <= CACHE_RTOL * np.abs(
                want).max()


@pytest.mark.parametrize("layout,key,groups", LAYER_CASES, ids=LAYER_IDS)
def test_ssm_split_layer_matches_the_reference(worlds, layout, key, groups):
    ref, port = worlds
    want, cache = ref[(layout, key, groups)]
    mp = LAYOUTS[layout][2]
    cfg = _cfg(key, n_groups=groups)
    d_inner, H = ssm_dims(cfg)
    c, N = d_inner // mp, cfg.ssm.d_state
    for rank in port[layout]:
        got = rank["layer"][(key, groups)]
        assert len(got["out"]) == 4
        for g, w in zip(got["out"], want):
            assert g.shape == w.shape
            assert np.abs(g - w).max() <= LAYER_RTOL * np.abs(w).max()
        r = rank["coords"]["model"]
        own = slice(r * c, (r + 1) * c)
        st = cache["state"].reshape(2, d_inner, N)
        assert np.abs(got["state"].reshape(2, d_inner, N)[:, own]
                      - st[:, own]).max() <= LAYER_RTOL * np.abs(st).max()
        cx = cache["conv_x"]
        assert np.abs(got["conv_x"] - cx[..., own]).max() <= (
            LAYER_RTOL * np.abs(cx).max())


@pytest.mark.parametrize("layout,key", CASE_IDS, ids=IDS)
def test_ssm_split_loss_and_gradients_match_one_device(worlds, layout, key):
    cfg = _cfg(key)
    names = []
    tree_map_with_path(lambda path, ps: names.append("/".join(
        map(str, path))), build_model(cfg).schema)
    for rank in worlds[1][layout]:
        res = rank["train"][key]
        loss, sloss = res["loss"]
        assert sloss == pytest.approx(loss, rel=LOSS_RTOL)
        grads = res["grads"]
        assert sorted(grads) == sorted(names)
        for name, (g, s) in grads.items():
            assert s.shape == g.shape, name
            bar = GRAD_TOL * np.abs(g).max()
            assert np.abs(s - g).max() <= bar, (name, np.abs(s - g).max(),
                                                bar)
        # the whole leaves a rank uses on its channels get every part
        for leaf in ("w_B", "w_C", "w_dt", "dt_bias", "A_log", "D",
                     "conv_B", "conv_C", "w_z", "norm"):
            assert np.abs(grads[f"blocks/p0/ssm/{leaf}"][0]).max() > 0, leaf


@pytest.mark.parametrize("layout,key", CASE_IDS, ids=IDS)
def test_ssm_split_eval_takes_k6_on_the_sub_heads(worlds, layout, key):
    """``make_sharded_eval_step`` with ``use_pallas_ssd``: the loss of
    ``make_eval_step``, K6 (its plain version here) called once a Mamba2
    layer on the rank's sub-heads."""
    cfg = _cfg(key)
    _, n, mp, _ = LAYOUTS[layout]
    _, c, g, heads = sub_heads(cfg, mp, 0)
    n_m = sum(cfg.layer_kind(i) == "M" for i in range(cfg.n_layers))
    for rank in worlds[1][layout]:
        res = rank["eval"][key]
        loss, sloss = res["loss"]
        assert np.isfinite(loss)
        assert sloss == pytest.approx(loss, rel=LOSS_RTOL)
        assert res["calls"] == [(4 // (n // mp), 128, len(heads), g)] * n_m


def test_sub_heads_at_mamba2_130m_mp16_reassemble_the_scan():
    """Every rank of mamba2-130m at mp = 16: 96 columns as three
    sub-heads of 32 (heads (0, 0, 1) on rank 0, (1, 2, 2) on rank 1),
    each rank's sub-heads through the scan reassembled into the whole
    call."""
    cfg = get_config(MAMBA, "full")
    d_inner, H = ssm_dims(cfg)
    hd, N = cfg.ssm.head_dim, 16
    assert sub_heads(cfg, 16, 0)[1:4] == (96, 32, (0, 0, 1))
    assert sub_heads(cfg, 16, 1)[1:4] == (96, 32, (1, 2, 2))
    rng = np.random.default_rng(0)
    B, S = 1, 256
    x = torch.from_numpy(rng.normal(size=(B, S, H, hd)).astype(np.float32))
    Bm, Cm = (torch.from_numpy(rng.normal(size=(B, S, 1, N)).astype(
        np.float32)) for _ in range(2))
    dt = torch.from_numpy(rng.uniform(0.01, 0.1, (B, S, H)).astype(
        np.float32))
    A_log = torch.from_numpy(rng.normal(0, 0.5, H).astype(np.float32))
    whole = ssd_chunk_scan_torch(x, Bm, Cm, dt, A_log, chunk=128)
    parts, seen = [], []
    for r in range(16):
        lo, c, g, heads = sub_heads(cfg, 16, r)
        idx = torch.tensor(heads)
        xr = x.reshape(B, S, d_inner)[..., lo:lo + c].reshape(
            B, S, c // g, g)
        y = ssd_chunk_scan_torch(xr, Bm, Cm, dt[..., idx], A_log[idx],
                                 chunk=128)
        parts.append(y.reshape(B, S, c))
        seen += heads
    assert sorted(set(seen)) == list(range(H))
    got = torch.cat(parts, -1).reshape(B, S, H, hd)
    err = (got - whole).abs().max() / whole.abs().max()
    assert err <= SCAN_RTOL, err
