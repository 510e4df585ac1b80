"""Multi-head latent attention under tensor parallelism, on gloo worlds.

The resolver splits an MLA layer's up-projections ``wq_b`` / ``wk_b`` /
``wv_b`` and ``wo`` on heads where mp divides them (deepseek-v3's 128 at
mp = 16), else on ``head_dim`` (minicpm3's 40), and the cached latent
``c_kv`` on ``kv_lora``; ``wq_a``, ``wkv_a``, the norms and ``k_rope``
stay whole.  The port's route (``models/layers.py::_mla_split``) attends
whole heads over the whole latent on every rank.  The reference's own
sharded path is red on this jax, so the port's tensor parallelism is
held against the single-device port, and one layer against the
reference's ``mla_apply``; the single-device port is held against the
reference in ``tests/test_torch_mla.py``.

Float32 SMOKE configs, seeded weights, in spawned gloo worlds
(``tests/torch_dist.py``, ``tests/torch_dist_training.py``):

* minicpm3 SMOKE with 6 heads at dp = 1 x mp = 4 (the head_dim
  placement: 12 of 48 query columns a rank, rank 2's straddling the
  nope / rope boundary at 32, 8 of 32 key and value columns), with 8
  heads there (heads), and with 5 heads at dp = 2 x mp = 2 (head_dim,
  rank 1's query columns straddling); deepseek SMOKE (a dense first
  layer, MoE with a shared expert, MTP) at mp = 4, mp = 2 and dp = 2 x
  mp = 2 (heads).
* The dense engine's greedy tokens (6 prompts of 20-40 tokens, 12 new
  ones) equal the single-device engine's, naive and absorbed; the
  logits of a prefill and 3 greedy decode steps within ``LOGIT_RTOL``;
  each rank's leaves (its heads or columns, its 16 / 32 of 64 kv_lora
  columns of the slot cache and the prefill scratch, ``k_rope`` whole)
  and its slot cache's rows equal to the single-device cache's columns
  within ``CACHE_RTOL``.
* One layer (prefill of 12 rows, 3 decode steps) against the
  reference's ``mla_apply`` within ``LAYER_RTOL``.
* The sharded train step's loss (within ``LOSS_RTOL``) and every
  parameter's gradient (within ``GRAD_TOL`` of the leaf's largest
  |gradient|; the MTP layer's included) against the single-device
  ``value_and_grads`` of ``forward_train_loss``.
"""
import torch_threads  # noqa: F401  (caps torch's threads under xdist)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist as W
import torch_dist_training as TW
from repro.configs import get_config as ref_config
from repro.models.layers import mla_apply as ref_mla_apply
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models.layers import mla_schema

LOGIT_RTOL = 1e-4   # of max |logit|: float32, the tensor-parallel partial
#                     sums added in another order (up to 6e-7 seen)
CACHE_RTOL = 1e-5   # of max |c_kv|: the latent of the same rows
LAYER_RTOL = 1e-5   # of max |out|: one layer, float32
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-5     # of the leaf's largest |gradient| (up to 1.6e-6 seen)

MINI, DS = "minicpm3-4b", "deepseek-v3-671b"
CASES = {"mini_h6": (MINI, {"n_heads": 6, "n_kv_heads": 6}),
         "mini_h5": (MINI, {"n_heads": 5, "n_kv_heads": 5}),
         "mini": (MINI, {}),
         "deepseek": (DS, {})}
# layout -> (mesh spec, mp, its cases); a world of dp x mp processes
LAYOUTS = {"mp4": ("dp=1,mp=4", 4, ("mini_h6", "mini", "deepseek")),
           "mp2": ("dp=1,mp=2", 2, ("deepseek",)),
           "dp2mp2": ("dp=2,mp=2", 2, ("mini_h5", "deepseek"))}
WORLD = {"mp4": 4, "mp2": 2, "dp2mp2": 4}
ROUTES = (False, True)      # mla_absorb
CASE_IDS = [(lay, key) for lay, (_, _, keys) in LAYOUTS.items()
            for key in keys]
ROUTE_CASES = [(lay, key, absorb) for lay, key in CASE_IDS
               for absorb in ROUTES]
ROUTE_IDS = [f"{lay}-{key}-{'absorbed' if a else 'naive'}"
             for lay, key, a in ROUTE_CASES]


def _cfg(key):
    arch, over = CASES[key]
    return dataclasses.replace(get_config(arch, "smoke"), **over)


def _prompts():
    rng = np.random.default_rng(0)
    return [list(map(int, rng.integers(4, 500, size=int(n))))
            for n in (20, 33, 40, 27, 24, 36)]


@pytest.fixture(scope="module")
def serve_worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mla_serve")
    return {lay: W.run_world(W.serve_mla, WORLD[lay], tmp, spec,
                             [(k, *CASES[k]) for k in keys], _prompts(), 12)
            for lay, (spec, _, keys) in LAYOUTS.items()}


@pytest.mark.parametrize("layout,key,absorb", ROUTE_CASES, ids=ROUTE_IDS)
def test_mla_split_serves_the_single_device_tokens(serve_worlds, layout,
                                                   key, absorb):
    for rank in serve_worlds[layout]:
        single, got = rank[key][("tokens", absorb)]
        assert len(single) == 6 and all(len(t) == 12 for t in single)
        assert got == single


@pytest.mark.parametrize("layout,key,absorb", ROUTE_CASES, ids=ROUTE_IDS)
def test_mla_split_logits_match_one_device(serve_worlds, layout, key,
                                           absorb):
    for rank in serve_worlds[layout]:
        want = rank[key][("logits", absorb, "single")]
        got = rank[key][("logits", absorb, "sharded")]
        assert len(got) == 4
        for g, w in zip(got, want):
            assert g.shape == w.shape
            err = np.abs(g - w).max() / np.abs(w).max()
            assert err <= LOGIT_RTOL, err


@pytest.mark.parametrize("layout,key", CASE_IDS,
                         ids=[f"{lay}-{k}" for lay, k in CASE_IDS])
def test_mla_split_leaves_on_each_rank(serve_worlds, layout, key):
    """The up-projections and ``wo`` hold this rank's heads where mp
    divides them, else its head_dim columns of every head; the slot
    cache's and the prefill scratch's ``c_kv`` its kv_lora columns,
    ``k_rope`` whole; the slot cache's rows of this rank's slots equal
    the single-device cache's columns."""
    cfg = _cfg(key)
    m, H, mp = cfg.mla, cfg.n_heads, LAYOUTS[layout][1]
    widths = {"wq_b": m.qk_nope_head_dim + m.qk_rope_head_dim,
              "wk_b": m.qk_nope_head_dim, "wv_b": m.v_head_dim}
    for rank in serve_worlds[layout]:
        sh = rank[key]["shapes"]
        for w, width in widths.items():
            assert sh[w][-2:] == ((H // mp, width) if H % mp == 0
                                  else (H, width // mp)), (w, sh[w])
        assert sh["wo"][-3:-1] == ((H // mp, m.v_head_dim) if H % mp == 0
                                   else (H, m.v_head_dim // mp))
        for shapes in (sh["cache"], sh["scratch"]):
            assert shapes["c_kv"][-1] == m.kv_lora_rank // mp
            assert shapes["k_rope"][-1] == m.qk_rope_head_dim
        r, rl = rank["coords"]["model"], m.kv_lora_rank // mp
        for absorb in ROUTES:
            (want, got), (rwant, rgot) = (
                rank[key][("cache", absorb)][c] for c in ("c_kv", "k_rope"))
            cols = want[..., r * rl:(r + 1) * rl]
            assert got.shape == cols.shape
            assert np.abs(got - cols).max() <= CACHE_RTOL * np.abs(
                want).max()
            assert np.abs(rgot - rwant).max() <= CACHE_RTOL * np.abs(
                rwant).max()


# one layer against the reference: (layout, case) pairs, each route
LAYER_CASES = [(lay, key, absorb) for lay, key in
               (("mp4", "mini_h6"), ("mp4", "deepseek"),
                ("dp2mp2", "mini_h5")) for absorb in ROUTES]


@pytest.fixture(scope="module")
def layer_worlds(tmp_path_factory):
    """The reference's ``mla_apply`` on one layer's seeded numpy weights
    (normal, 1 / sqrt(fan-in); the norms 1 + noise), a prefill of 12
    rows and 3 decode steps into a 24-row cache; the same on each
    layout's world."""
    tmp = tmp_path_factory.mktemp("mla_layer")
    rng = np.random.default_rng(1)
    ref, cases = {}, {}
    for lay, key, absorb in LAYER_CASES:
        arch, over = CASES[key]
        rc = dataclasses.replace(ref_config(arch, "smoke"),
                                 dtype="float32", **over)
        p = {k: (1.0 + rng.normal(0, 0.02, ps.shape) if ps.init == "ones"
                 else rng.normal(0, ps.shape[0] ** -0.5, ps.shape)
                 ).astype(np.float32)
             for k, ps in mla_schema(_cfg(key)).items()}
        x = rng.normal(size=(2, 12, rc.d_model)).astype(np.float32)
        steps = rng.normal(size=(2, 3, rc.d_model)).astype(np.float32)
        m = rc.mla
        cache = {"c_kv": jnp.zeros((2, 24, m.kv_lora_rank), jnp.float32),
                 "k_rope": jnp.zeros((2, 24, m.qk_rope_head_dim),
                                     jnp.float32)}
        pj = jax.tree_util.tree_map(jnp.asarray, p)
        y, cache = ref_mla_apply(
            pj, jnp.asarray(x), rc, cache=cache, absorb=absorb,
            positions=jnp.tile(jnp.arange(12, dtype=jnp.int32), (2, 1)))
        outs = [np.asarray(y)]
        for i in range(3):
            y, cache = ref_mla_apply(
                pj, jnp.asarray(steps[:, i:i + 1]), rc, cache=cache,
                absorb=absorb,
                positions=jnp.full((2, 1), 12 + i, jnp.int32))
            outs.append(np.asarray(y))
        ref[(lay, key, absorb)] = outs
        cases.setdefault(lay, []).append(
            ((key, absorb), arch, over, p, x, steps, absorb, 24))
    port = {lay: W.run_world(W.mla_layer, WORLD[lay], tmp, LAYOUTS[lay][0],
                             c)
            for lay, c in cases.items()}
    return ref, port


@pytest.mark.parametrize("layout,key,absorb", LAYER_CASES,
                         ids=[f"{lay}-{k}-{'absorbed' if a else 'naive'}"
                              for lay, k, a in LAYER_CASES])
def test_mla_split_layer_matches_the_reference(layer_worlds, layout, key,
                                               absorb):
    ref, port = layer_worlds
    want = ref[(layout, key, absorb)]
    for rank in port[layout]:
        got = rank[(key, absorb)]
        assert len(got) == 4
        for g, w in zip(got, want):
            assert g.shape == w.shape
            assert np.abs(g - w).max() <= LAYER_RTOL * np.abs(w).max()


@pytest.fixture(scope="module")
def train_worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mla_train")
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(4, 512, size=(4, 32)).astype(np.int32)
             for k in ("tokens", "labels")}
    batch["labels"][0, :5] = -1
    return {lay: W.run_world(TW.grads_head_dim, WORLD[lay], tmp, spec,
                             [(k, *CASES[k], batch) for k in keys])
            for lay, (spec, _, keys) in LAYOUTS.items()}


@pytest.mark.parametrize("layout,key", CASE_IDS,
                         ids=[f"{lay}-{k}" for lay, k in CASE_IDS])
def test_mla_split_loss_and_gradients_match_one_device(train_worlds, layout,
                                                       key):
    cfg = _cfg(key)
    n_leaves = len(_leaf_names(cfg))
    for rank in train_worlds[layout]:
        loss, sloss = rank[key]["loss"]
        assert sloss == pytest.approx(loss, rel=LOSS_RTOL)
        grads = rank[key]["grads"]
        assert len(grads) == n_leaves
        for name, (g, s) in grads.items():
            assert s.shape == g.shape, name
            bar = GRAD_TOL * np.abs(g).max()
            assert np.abs(s - g).max() <= bar, (name, np.abs(s - g).max(),
                                                bar)
        # the whole leaves get every head's part; the MTP layer trains
        for name in ["blocks/p0/attn/wkv_a", "blocks/p0/attn/wk_b"] + (
                ["mtp/layer/attn/wk_b", "mtp/w_comb"] if cfg.mtp_depth
                else []):
            assert np.abs(grads[name][0]).max() > 0, name


def _leaf_names(cfg):
    from repro_torch.models.schema import tree_map_with_path
    names = []
    tree_map_with_path(lambda path, ps: names.append(path),
                       build_model(cfg).schema)
    return names
