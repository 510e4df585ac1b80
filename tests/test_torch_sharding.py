"""The port's sharding resolver and serving-mesh checks against the
reference's (``repro.sharding``, ``repro.launch.mesh``), on stub meshes
of ``axis_names`` and ``devices.shape`` only, as the reference's own
``check_mp_divisibility`` builds them.

For every config the port serves, FULL and SMOKE, on every stub mesh of
the grid and with ``fsdp`` and ``ep`` on and off: ``resolve_spec`` over
the parameter schema and the dense and paged cache schemas, leaf by leaf
(through ``specs_for_schema``), ``model_axis_fallbacks`` and the
``FALLBACK_LOG`` entries each call appends; ``input_sharding``; the
configs and leaves ``check_mp_divisibility`` names; the parse errors of
``make_serving_mesh``; and ``local_shape`` / ``local_shard`` cutting a
tensor into shards that make it whole again.
"""
import torch_threads  # noqa: F401  (caps torch's threads under xdist)
import dataclasses
import itertools
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import repro.sharding as RS
from repro.configs import get_config as ref_config
from repro.launch import mesh as ref_mesh
from repro.models import transformer as RT
from repro.models.schema import ParamSpec as RefParamSpec
from repro_torch import sharding as PS
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import mesh as port_mesh
from repro_torch.models import transformer as PT
from repro_torch.models.schema import ParamSpec

MESHES = {
    "1x1": (("data", "model"), (1, 1)),
    "8x1": (("data", "model"), (8, 1)),
    "4x2": (("data", "model"), (4, 2)),
    "2x4": (("data", "model"), (2, 4)),
    "1x8": (("data", "model"), (1, 8)),
    "16x16": (("data", "model"), (16, 16)),
    "pod2x16x16": (("pod", "data", "model"), (2, 16, 16)),
}
FLAGS = list(itertools.product((False, True), (False, True)))  # fsdp, ep


def _stub(name):
    axes, shape = MESHES[name]
    return SimpleNamespace(axis_names=axes, devices=np.empty(shape, object))


def _ref_specs(schema, mesh, **kw):
    """{leaf name: spec tuple} of the reference's resolver."""
    out = {}
    jax.tree_util.tree_map_with_path(
        lambda path, spec: out.__setitem__(RS.leaf_name(path), tuple(spec)),
        RS.specs_for_schema(schema, mesh, **kw),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return out


def _port_specs(schema, mesh, **kw):
    specs = PS.specs_for_schema(schema, mesh, **kw)
    return {name: spec for name, _, spec in PS.named_specs(schema, specs)}


def _schemas(pkg, arch, variant):
    """The parameter schema and the dense and paged cache schemas
    (paged only where the config pages)."""
    cfg = (ref_config if pkg is RT else get_config)(arch, variant)
    out = {"params": pkg.decoder_param_schema(cfg),
           "cache": pkg.init_cache_schema(cfg, 16, 256)}
    try:
        out["paged"] = pkg.paged_cache_schema(cfg, 16, 512, 16, 17)
    except ValueError:
        pass
    return out


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("variant", ["smoke", "full"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_resolver_matches_the_reference(arch, variant, mesh):
    stub = _stub(mesh)
    ref_schemas = _schemas(RT, arch, variant)
    port_schemas = _schemas(PT, arch, variant)
    assert ref_schemas.keys() == port_schemas.keys()
    for what in ref_schemas:
        for fsdp, ep in FLAGS:
            n_ref, n_port = len(RS.FALLBACK_LOG), len(PS.FALLBACK_LOG)
            want = _ref_specs(ref_schemas[what], stub, fsdp=fsdp, ep=ep)
            got = _port_specs(port_schemas[what], stub, fsdp=fsdp, ep=ep)
            assert got == want, (what, fsdp, ep)
            assert PS.FALLBACK_LOG[n_port:] == RS.FALLBACK_LOG[n_ref:]
        for fsdp in (False, True):
            n_ref, n_port = len(RS.FALLBACK_LOG), len(PS.FALLBACK_LOG)
            assert PS.model_axis_fallbacks(
                port_schemas[what], stub, fsdp=fsdp) == \
                RS.model_axis_fallbacks(ref_schemas[what], stub, fsdp=fsdp)
            assert PS.FALLBACK_LOG[n_port:] == RS.FALLBACK_LOG[n_ref:]


@pytest.mark.parametrize("mesh", MESHES)
def test_resolve_spec_and_input_sharding_match_the_reference(mesh):
    """One ParamSpec at a time, over batch / expert / model / FSDP
    placements and divisibility fallbacks; ``input_sharding`` for every
    batch and rank; ``opt_state_spec_like``."""
    stub = _stub(mesh)
    cases = [((8, 64, 40, 128), ("batch", "seq", "kv_heads", "head_dim")),
             ((3, 64, 40, 128), ("batch", "seq", "kv_heads", "head_dim")),
             ((16, 5120, 10752), ("experts", "d_model", "d_ff_expert")),
             ((64, 5120, 40, 128), ("layers", "d_model", "heads",
                                    "head_dim")),
             ((152064, 5120), ("vocab", "d_model")),
             ((6, 63), ("heads", "head_dim")),
             ((1 << 18,), ("d_model",)), ((7, 5), ("", "")),
             ((24, 1536, 64, 128), ("batch", "d_inner", "", "kv_lora"))]
    for (shape, axes), (fsdp, ep) in itertools.product(cases, FLAGS):
        n_ref, n_port = len(RS.FALLBACK_LOG), len(PS.FALLBACK_LOG)
        want = RS.resolve_spec(RefParamSpec(shape, axes), stub, fsdp=fsdp,
                               ep=ep, log_name="x")
        got = PS.resolve_spec(ParamSpec(shape, axes), stub, fsdp=fsdp,
                              ep=ep, log_name="x")
        assert got == tuple(want), (shape, axes, fsdp, ep)
        assert PS.FALLBACK_LOG[n_port:] == RS.FALLBACK_LOG[n_ref:]
        assert PS.opt_state_spec_like(got, None, stub) == got
    # the reference's input_sharding wraps P(entry, None, ...) in a
    # NamedSharding of a real mesh; its entry is _batch_entry's
    for batch, rank in itertools.product((1, 2, 3, 8, 16, 32, 512),
                                         (1, 2, 3)):
        entry, _ = RS._batch_entry(batch, stub)
        assert PS.input_sharding(stub, batch, rank) == \
            (entry,) + (None,) * (rank - 1)


def test_input_sharding_on_a_real_mesh_matches_the_reference():
    real = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    for batch, rank in itertools.product((1, 3, 8), (1, 2, 3)):
        assert PS.input_sharding(real, batch, rank) == tuple(
            RS.input_sharding(real, batch, rank).spec)


def _check_both(fn_ref, fn_port):
    """Both raise a ValueError with the same text, or neither raises."""
    texts = []
    for fn in (fn_ref, fn_port):
        try:
            fn()
            texts.append(None)
        except ValueError as exc:
            texts.append(str(exc))
    assert texts[0] == texts[1]
    return texts[0]


@pytest.mark.parametrize("mp, over, spec", [
    (2, {}, ""), (1, {}, ""),
    (4, dict(n_heads=6, n_kv_heads=6), ""),
    (4, dict(n_heads=6, n_kv_heads=6, head_dim=63), "dp=2,mp=4"),
    (8, dict(d_ff=500), ""),
    (16, {}, "dp=1,mp=16"),
])
def test_mp_divisibility_names_the_same_config_and_leaves(mp, over, spec):
    """The reference test's cases (tests/test_sharded_executor.py) and a
    model axis wider than SMOKE's heads."""
    rc = dataclasses.replace(ref_config("qwen1.5-32b", "smoke"), **over)
    pc = dataclasses.replace(get_config("qwen1.5-32b", "smoke"), **over)
    msg = _check_both(
        lambda: ref_mesh.check_mp_divisibility(rc, mp, spec=spec),
        lambda: port_mesh.check_mp_divisibility(pc, mp, spec=spec))
    if "head_dim" in over or "d_ff" in over:
        assert msg is not None and "qwen-smoke" in msg


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_mp_divisibility_on_full_configs(arch):
    for mp in (2, 4, 8, 16):
        _check_both(
            lambda: ref_mesh.check_mp_divisibility(
                ref_config(arch, "full"), mp),
            lambda: port_mesh.check_mp_divisibility(
                get_config(arch, "full"), mp))


@pytest.mark.parametrize("spec", ["dp=2,xp=3", "tp=2", "dp=1,mp=2,ep=2"])
def test_make_serving_mesh_parse_errors_match(spec):
    """A bad axis is refused before any device or process group."""
    msg = _check_both(lambda: ref_mesh.make_serving_mesh(spec),
                      lambda: port_mesh.make_serving_mesh(spec,
                                                          device="cpu"))
    assert msg.startswith("unknown mesh axes")


def test_make_serving_mesh_checks_mp_before_any_device():
    cfg = dataclasses.replace(get_config("qwen1.5-32b", "smoke"),
                              n_heads=6, n_kv_heads=6, head_dim=63)
    with pytest.raises(ValueError, match="cannot tensor-parallel"):
        port_mesh.make_serving_mesh("dp=2,mp=4", cfg, device="cuda")


class _Mesh(SimpleNamespace):
    def coord(self, axis):
        return self.coords[axis]


@pytest.mark.parametrize("spec", [
    (None, "data", "model"), (("data", "model"), None, None),
    ("model", None, "data"), (None, None, None)])
def test_local_shards_make_the_tensor_whole(spec):
    """Every (data, model) coordinate's shard, put back where
    ``local_shape`` says it goes, rebuilds the tensor; a dim over two
    axes splits row-major (the last axis fastest)."""
    t = torch.arange(8 * 6 * 4).reshape(8, 6, 4)
    dp, mp = 2, 2
    back = torch.full_like(t, -1)
    for d, m in itertools.product(range(dp), range(mp)):
        mesh = _Mesh(axis_names=("data", "model"),
                     devices=np.empty((dp, mp), object),
                     coords={"data": d, "model": m})
        shard = PS.local_shard(t, spec, mesh)
        assert tuple(shard.shape) == PS.local_shape(t.shape, spec, mesh)
        idx = []
        for dim, entry in enumerate(spec):
            axes = () if entry is None else (
                entry if isinstance(entry, tuple) else (entry,))
            k = 0
            for a in axes:
                k = k * 2 + mesh.coords[a]
            step = shard.shape[dim]
            idx.append(slice(k * step, (k + 1) * step))
        back[tuple(idx)] = shard
    assert torch.equal(back, t)
    mesh = _Mesh(axis_names=("data", "model"),
                 devices=np.empty((dp, mp), object),
                 coords={"data": 1, "model": 1})
    assert PS.local_shape(t.shape, spec, mesh, axes=("model",)) == tuple(
        n // (2 if e == "model" or (isinstance(e, tuple) and "model" in e)
              else 1) for n, e in zip(t.shape, spec))


def test_tensor_parallel_check_names_the_leaf():
    """At mp > 1 every leaf the apply splits must split on its own axis
    and no other leaf may split; mp = 1 checks nothing.  Whisper's cross
    and encoder leaves split as a block's attention leaves do."""
    ps = ParamSpec((4, 64, 8), ("kv_heads", "head_dim", "d_model"))
    good = [("blocks/p0/attn/wk", ParamSpec((64, 4, 64), (
        "d_model", "kv_heads", "head_dim")), (None, "model", None))]
    PT.check_tensor_parallel(good, 2)
    PT.check_tensor_parallel([("blocks/p0/cross/wk", ps,
                               (None, "model", None)),
                              ("encoder/attn/wk", good[0][1],
                               (None, "model", None))], 2)
    for name, spec in (("blocks/p0/attn/wk", ("model", None, None)),
                       ("blocks/p0/cross/wk", (None, None, "model")),
                       ("encoder/attn/wk", ("model", None, None)),
                       ("blocks/p0/attn/wk", (None, None, None))):
        bad = [(name, ps if "cross" in name else good[0][1], spec)]
        with pytest.raises(ValueError, match="ROADMAP.md queue 3"):
            PT.check_tensor_parallel(bad, 2)
        PT.check_tensor_parallel(bad, 1)
