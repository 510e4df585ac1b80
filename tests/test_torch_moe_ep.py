"""The port's expert-parallel MoE block against the reference's.

The reference's ``make_ep_moe_fn`` (``shard_map`` over ``all_to_all``)
runs on a forced 8-device host mesh in a subprocess, as
``tests/test_moe_multidevice.py`` runs it: its outputs, aux loss, the
mask of the routed choices each data shard keeps within capacity, and
``jax.grad`` of ``sum(y * c) + aux`` through the block.  The port's
``make_ep_moe_fn`` runs in gloo worlds on the same weights and inputs,
each rank on its own rows and weight shards: dp = 4 x mp = 2 (8 ranks)
and dp = 2 x mp = 1.  Cases: dbrx SMOKE (E = 4, k = 2) and deepseek-v3
SMOKE (a shared expert) in float32; capacity 1.25 (rows drop) and 8.0;
``scatter_down`` off and on; the send buffer in float32 and in bfloat16.

Bars: the same kept choices, exactly; float32 ``y`` within 1e-5 of max
|y| and the aux within 1e-6; gradients within 1e-5 of each leaf's
largest entry (the router and the shared expert summed over the data
ranks, whose rows each hold a part).  With the bf16 send buffer both
packages round the buffer and the expert outputs to bf16 and combine in
bf16: ``y`` within 2^-9 of max |y|, half a bf16 step at max |y| (where
both round the same values ``y`` agrees to float32; an element within
a rounding of a bf16 boundary may round either way, times its router
weight), and the port's float32 send of the same case must miss that
bar, so the bar sees the bf16 send; gradients within 1e-2 (the
cotangents pass through bf16 too, and the router weights' gradient is
a sum of bf16 products over d that the two packages round apart).  At
capacity 8.0, where no row drops, ``y`` also meets the reference's
``moe_apply_ragged`` at the reference's own bars (2e-3, aux 1e-3).
"""
import torch_threads  # noqa: F401  (caps torch's threads under xdist)
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import torch_dist_training as W
from torch_dist import run_world

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("dbrx-132b", "deepseek-v3-671b")
# (layout, capacity, scatter_down, send dtype)
SETTINGS = [("dp=4,mp=2", 1.25, False, None), ("dp=4,mp=2", 1.25, True, None),
            ("dp=4,mp=2", 8.0, False, None), ("dp=4,mp=2", 8.0, True, None),
            ("dp=4,mp=2", 1.25, False, "bf16"),
            ("dp=4,mp=2", 8.0, True, "bf16"),
            ("dp=2", 1.25, False, None), ("dp=2", 8.0, False, None)]
CASES = [(f"{a}|{lay}|{cap}|{int(sc)}|{comm}", a, lay, cap, sc, comm)
         for a in ARCHS for lay, cap, sc, comm in SETTINGS]
Y_TOL, Y_TOL_BF16 = 1e-5, 2.0 ** -9
AUX_TOL = 1e-6
GRAD_TOL, GRAD_TOL_BF16 = 1e-5, 1e-2

REF = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, json, sys
import jax, numpy as np
import jax.numpy as jnp
from jax.sharding import Mesh

from repro.configs import get_config
from repro.launch.moe_parallel import make_ep_moe_fn
from repro.models.moe import moe_apply_ragged, router_probs

inp = dict(np.load(sys.argv[1]))
cases = json.loads(sys.argv[2])
out = {}


def params(arch):
    pre = arch + "/p/"
    p = {}
    for k, v in inp.items():
        if k.startswith(pre):
            *head, leaf = k[len(pre):].split("/")
            d = p
            for h in head:
                d = d.setdefault(h, {})
            d[leaf] = jnp.asarray(v)
    return p


def keep_mask(p, x, cfg, dp, cap_factor):
    # the reference's slotting (models/moe.py:131-138) on each data shard
    e = cfg.moe
    rows = []
    for xs in np.split(np.asarray(x), dp):
        B, S, d = xs.shape
        T = B * S
        _, top_idx, _ = router_probs(p, jnp.asarray(xs).reshape(T, d), e)
        cap = max(1, int(-(-cap_factor * e.top_k * T // e.n_experts)))
        flat_e = top_idx.reshape(-1)
        sort_idx = jnp.argsort(flat_e)
        sorted_e = flat_e[sort_idx]
        seg_pos = jnp.arange(T * e.top_k) - jnp.searchsorted(
            sorted_e, sorted_e, side="left")
        keep = jnp.zeros(T * e.top_k, bool).at[sort_idx].set(seg_pos < cap)
        rows.append(np.asarray(keep).reshape(T, e.top_k))
    return np.concatenate(rows)


def flat(prefix, tree):
    for k, v in tree.items():
        if isinstance(v, dict):
            flat(f"{prefix}/{k}", v)
        else:
            out[f"{prefix}/{k}"] = np.asarray(v, np.float32)


for key, arch, dp, mp, cap, scat, comm in cases:
    cfg = dataclasses.replace(get_config(arch, "smoke"), dtype="float32")
    p, x, c = params(arch), jnp.asarray(inp[arch + "/x"]), inp[arch + "/c"]
    mesh = Mesh(np.array(jax.devices()[:dp * mp]).reshape(dp, mp),
                ("data", "model"))
    fn = make_ep_moe_fn(mesh, capacity_factor=cap, scatter_down=bool(scat),
                        comm_dtype=jnp.bfloat16 if comm == "bf16" else None)

    def loss(p, x):
        y, aux = fn(p, x, cfg)
        return jnp.sum(y * c) + aux, (y, aux)

    with mesh:
        (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(p, x)
    out[key + "/y"] = np.asarray(y, np.float32)
    out[key + "/aux"] = np.asarray(aux, np.float32)
    out[key + "/keep"] = keep_mask(p, x, cfg, dp, cap)
    flat(key + "/grads", gp)
    out[key + "/grads/x"] = np.asarray(gx, np.float32)
    if cap == 8.0 and arch + "/ragged/y" not in out:
        y, aux = moe_apply_ragged(p, x, cfg)
        out[arch + "/ragged/y"] = np.asarray(y, np.float32)
        out[arch + "/ragged/aux"] = np.asarray(aux, np.float32)
np.savez(sys.argv[3], **out)
print("EP-REF-OK")
"""


def _inputs():
    """Each arch's MoE block weights (the reference's schema; seeded
    numpy draws, the router wide enough that no top-k choice sits
    within float noise of a tie), the input and the cotangent.  The
    input's rows share a mean, which skews the routing towards some
    experts, so that capacity 1.25 drops rows."""
    from repro.configs import get_config
    from repro.models.moe import moe_schema
    rng = np.random.default_rng(0)
    out = {}
    for arch in ARCHS:
        schema = moe_schema(get_config(arch, "smoke"))

        def draw(name, ps):
            scale = 0.1 if name == "router" else 0.05
            out[f"{arch}/p/{name}"] = rng.normal(
                0, scale, ps.shape).astype(np.float32)
        for k, ps in schema.items():
            if isinstance(ps, dict):
                for j, q in ps.items():
                    draw(f"{k}/{j}", q)
            else:
                draw(k, ps)
        d = get_config(arch, "smoke").d_model
        out[f"{arch}/x"] = rng.normal(0.3, 0.5, (4, 16, d)).astype(np.float32)
        out[f"{arch}/c"] = rng.normal(0, 1.0, (4, 16, d)).astype(np.float32)
    return out


def _tree(inp, arch):
    p = {}
    for k, v in inp.items():
        if k.startswith(f"{arch}/p/"):
            *head, leaf = k[len(arch) + 3:].split("/")
            d = p
            for h in head:
                d = d.setdefault(h, {})
            d[leaf] = v
    return p


def _dims(layout):
    parts = dict(kv.split("=") for kv in layout.split(","))
    return int(parts.get("dp", 1)), int(parts.get("mp", 1))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ep")
    inp = _inputs()
    np.savez(tmp / "in.npz", **inp)
    cases = [[key, a, *_dims(lay), cap, int(sc), comm]
             for key, a, lay, cap, sc, comm in CASES]
    r = subprocess.run(
        [sys.executable, "-c", REF, str(tmp / "in.npz"), json.dumps(cases),
         str(tmp / "ref.npz")],
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "HOME": str(tmp), "JAX_PLATFORMS": "cpu"},
        capture_output=True, text=True, timeout=300)
    assert "EP-REF-OK" in r.stdout, r.stderr[-3000:]
    ref = dict(np.load(tmp / "ref.npz"))
    port = {}
    for layout in sorted({lay for _, _, lay, *_ in CASES}):
        dp, mp = _dims(layout)
        world = [(key, a, _tree(inp, a), inp[f"{a}/x"], inp[f"{a}/c"], cap,
                  sc, comm) for key, a, lay, cap, sc, comm in CASES
                 if lay == layout]
        res = run_world(W.ep_block, dp * mp, tmp, layout, world)
        port[layout] = res
    return ref, port


def _gathered(port, key, layout):
    """The ranks' results of ``key`` on their rows, in row order (the
    model ranks of a data rank hold the same rows: the first is taken,
    the others must agree)."""
    res = port[layout]
    dp, mp = _dims(layout)
    by_data = {}
    for r in res:
        c = r["coords"]
        by_data.setdefault(c["data"], []).append(r[key])
    return [by_data[i] for i in range(dp)]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_ep_forward_matches_reference(runs, case):
    key, arch, layout, cap, scatter, comm = case
    ref, port = runs
    ranks = _gathered(port, key, layout)
    for same in ranks:
        for r in same[1:]:
            np.testing.assert_array_equal(r["y"], same[0]["y"])
    keep = np.concatenate([s[0]["keep"] for s in ranks])
    np.testing.assert_array_equal(keep, ref[key + "/keep"])
    if cap == 1.25:
        assert not keep.all(), "capacity 1.25 drops no row"
    else:
        assert keep.all()
    y = np.concatenate([s[0]["y"] for s in ranks])
    want = ref[key + "/y"]
    tol = Y_TOL_BF16 if comm else Y_TOL
    assert np.abs(y - want).max() <= tol * np.abs(want).max()
    for s in ranks:
        for r in s:
            assert abs(r["aux"] - float(ref[key + "/aux"])) <= AUX_TOL


BF16_CASES = [c for c in CASES if c[5]]


@pytest.mark.parametrize("case", BF16_CASES, ids=[c[0] for c in BF16_CASES])
def test_float32_send_misses_the_bf16_bar(runs, case):
    """The port's float32 send of a bf16 case's settings, held against
    the reference's bf16 send: the bf16 bar must tell them apart."""
    key, arch, layout, cap, scatter, comm = case
    ref, port = runs
    f32 = next(k for k, a, lay, c, sc, cm in CASES if a == arch
               and lay == layout and c == cap and sc == scatter and not cm)
    want = ref[key + "/y"]
    y = np.concatenate([s[0]["y"] for s in _gathered(port, f32, layout)])
    assert np.abs(y - want).max() > Y_TOL_BF16 * np.abs(want).max()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_ep_gradients_match_reference(runs, case):
    key, arch, layout, cap, scatter, comm = case
    ref, port = runs
    dp, mp = _dims(layout)
    tol = GRAD_TOL_BF16 if comm else GRAD_TOL
    rows = _gathered(port, key, layout)
    gx = np.concatenate([s[0]["grads"]["x"] for s in rows])
    want = ref[key + "/grads/x"]
    assert np.abs(gx - want).max() <= tol * np.abs(want).max(), "x"
    # each leaf: this rank's shard of the reference's gradient
    split = {"w_gate": (0, 2), "w_up": (0, 2), "w_down": (0, 1),
             "router": (None, None), "shared/w_gate": (None, 1),
             "shared/w_up": (None, 1), "shared/w_down": (None, 0)}
    for r in port[layout]:
        c = r["coords"]
        for name, g in r[key]["grads"].items():
            if name == "x":
                continue
            w = ref[f"{key}/grads/{name}"]
            ddim, mdim = split[name]
            if ddim is not None:
                w = np.split(w, dp, axis=ddim)[c["data"]]
            if mdim is not None:
                w = np.split(w, mp, axis=mdim)[c["model"]]
            full = np.abs(ref[f"{key}/grads/{name}"]).max()
            assert np.abs(g - w).max() <= tol * full, (name, c)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("layout", ["dp=4,mp=2", "dp=2"])
def test_ep_matches_ragged_without_drops(runs, arch, layout):
    ref, port = runs
    key = next(k for k, a, lay, cap, sc, comm in CASES
               if a == arch and lay == layout and cap == 8.0 and not comm)
    y = np.concatenate([s[0]["y"] for s in _gathered(port, key, layout)])
    assert np.abs(y - ref[arch + "/ragged/y"]).max() < 2e-3
    aux = _gathered(port, key, layout)[0][0]["aux"]
    assert abs(aux - float(ref[arch + "/ragged/aux"])) < 1e-3
