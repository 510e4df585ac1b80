"""``repro_torch.launch.specs`` against the reference's
``launch/specs.py``, leaf for leaf.

The reference runs in a subprocess on a forced 512-device host platform,
as its dry run does (its stand-ins carry a ``NamedSharding``, which
needs a real mesh of devices; the subprocess takes about a second).  It
lists, for both production layouts (16 x 16 and 2 x 16 x 16), every
arch and every input shape ``shape_supported`` allows, each leaf of
``batch_specs``, ``param_specs``, ``opt_specs`` and ``cache_specs``
(with ``ep=use_ep(cfg, mesh)``) as its path, shape, dtype, spec and
per-device shard shape.  The port's stand-ins, resolved on the
layout-only ``make_production_mesh``, must give the same list.
"""
import torch_threads  # noqa: F401  (caps torch's threads under xdist)
import json
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.configs import (ARCH_IDS, INPUT_SHAPES, get_config,
                                 shape_supported)
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_production_mesh

ROOT = Path(__file__).resolve().parents[1]
LAYOUTS = (False, True)         # multi_pod

REF = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import json
import jax
from repro.configs import ARCH_IDS, INPUT_SHAPES, get_config, shape_supported
from repro.launch.mesh import make_production_mesh
from repro.launch import specs as S


def entry(e):
    return list(e) if isinstance(e, tuple) else e


def leaves(tree):
    out = []
    for path, s in jax.tree_util.tree_flatten_with_path(tree)[0]:
        spec = list(s.sharding.spec) + [None] * (len(s.shape)
                                                 - len(s.sharding.spec))
        out.append(["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                             for k in path), list(s.shape), s.dtype.name,
                    [entry(e) for e in spec],
                    list(s.sharding.shard_shape(s.shape))])
    return out


res = {}
for multi in (False, True):
    mesh = make_production_mesh(multi_pod=multi)
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        ep = S.use_ep(cfg, mesh)
        key = f"{int(multi)}|{arch}"
        res[key + "|use_ep"] = ep
        res[key + "|params"] = leaves(S.param_specs(cfg, mesh, ep=ep))
        res[key + "|opt"] = leaves(S.opt_specs(cfg, mesh, ep=ep))
        for shape in INPUT_SHAPES:
            if shape_supported(arch, shape):
                res[f"{key}|batch|{shape}"] = leaves(
                    S.batch_specs(cfg, shape, mesh))
                res[f"{key}|cache|{shape}"] = leaves(
                    S.cache_specs(cfg, shape, mesh))
print(json.dumps(res))
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    r = subprocess.run(
        [sys.executable, "-c", REF],
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "HOME": str(tmp_path_factory.mktemp("specs_home")),
             "JAX_PLATFORMS": "cpu"},
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.splitlines()[-1])


def _paths(tree, prefix=()):
    """(path, leaf) in JAX's flattening order: dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (k,))
    elif isinstance(tree, list):
        for i, t in enumerate(tree):
            yield from _paths(t, prefix + (i,))
    else:
        yield prefix, tree


def _leaves(tree):
    return [["/".join(map(str, p)), list(s.shape), s.dtype,
             [list(e) if isinstance(e, tuple) else e for e in s.spec],
             list(s.local)] for p, s in _paths(tree)]


@pytest.mark.parametrize("multi_pod", LAYOUTS, ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_reference_leaf_for_leaf(ref, arch, multi_pod):
    mesh = make_production_mesh(multi_pod=multi_pod)
    cfg = get_config(arch)
    key = f"{int(multi_pod)}|{arch}"
    ep = S.use_ep(cfg, mesh)
    assert ep == ref[key + "|use_ep"]
    assert _leaves(S.param_specs(cfg, mesh, ep=ep)) == ref[key + "|params"]
    assert _leaves(S.opt_specs(cfg, mesh, ep=ep)) == ref[key + "|opt"]
    shapes = [s for s in INPUT_SHAPES if shape_supported(arch, s)]
    assert shapes and all(f"{key}|batch|{s}" in ref for s in shapes)
    for shape in shapes:
        assert (_leaves(S.batch_specs(cfg, shape, mesh))
                == ref[f"{key}|batch|{shape}"]), shape
        assert (_leaves(S.cache_specs(cfg, shape, mesh))
                == ref[f"{key}|cache|{shape}"]), shape


def test_production_mesh_layouts():
    one, two = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert one.axis_names == ("data", "model")
    assert one.devices.shape == (16, 16)
    assert two.axis_names == ("pod", "data", "model")
    assert two.devices.shape == (2, 16, 16)
