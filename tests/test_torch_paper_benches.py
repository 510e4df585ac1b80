"""The paper's ten bench drivers and the four root examples through the
port, on the host.

Each bench's ``main`` runs in both packages (the repository's
``benchmarks/`` and ``repro_torch.benchmarks``) at the same small sizes,
patched through each package's ``common.TestbedConfig`` and, for the
seeds ablation, its own ``TestbedConfig`` / ``RouterConfig`` names and
``N_SEEDS``.  The port trains from the reference's initial draw (its
``init_policy(PRNGKey(seed), router_cfg)``, crossed by the bridge); the
returned dicts and the artifact JSONs are then identical, byte for
byte: every number in them is computed on the host from the eval
actions and the logged sweep, and the actions agree.  Both packages
write their artifacts under ``tmp_path``.  The example twins run with
``--device cpu`` (their testbeds at the same small size) and, without a
card, raise on the default device.
"""
import torch_threads  # noqa: F401  (caps torch's threads under xdist)
import dataclasses
import importlib
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core.config import RouterConfig as RefRouterConfig
from repro.core.config import TestbedConfig as RefTestbedConfig
from repro.core.policy import init_policy as ref_init_policy
from repro_torch.bridge import params_from_numpy
from repro_torch.core.config import RouterConfig, TestbedConfig

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

SIZE = dict(n_train=60, n_eval=40, n_paragraphs=60)
EPOCHS = 8
SEEDS_SIZE = dict(n_train=40, n_eval=20, n_paragraphs=40)
SEEDS_EPOCHS = 4
N_SEEDS = 2

BENCHES = {"table1": "table1_slo_grid", "fig1": "fig1_action_dist",
           "fig2": "fig2_cost_quality", "fig3": "fig3_reward",
           "mitigation": "mitigation", "objectives": "objectives_ablation",
           "ope": "ope", "conditioned": "conditioned_policy",
           "pareto": "pareto_sweep", "seeds": "seeds_ablation"}


def _ref_init_numpy(rc):
    return {k: np.asarray(v) for k, v in
            ref_init_policy(jax.random.PRNGKey(rc.seed), rc).items()}


def _ref_init(rc):
    """The reference's initial draw for ``rc``, as the port's tensors;
    one function object, so ``canonical_results`` caches one entry."""
    return params_from_numpy(_ref_init_numpy(rc), device="cpu")


def _sized(cls, router_cls, size, epochs):
    """A ``TestbedConfig`` constructor that keeps the caller's other
    fields (seeds) but takes ``size`` and ``epochs``."""
    def make(**kw):
        router = kw.pop("router", None) or router_cls()
        return cls(**{**kw, **size},
                   router=dataclasses.replace(router, n_epochs=epochs))
    return make


@pytest.fixture(scope="module")
def packages(tmp_path_factory):
    """Both packages' bench modules with their sizes and artifact
    directories patched; each package's canonical caches emptied before
    and after."""
    pkgs = {}
    with pytest.MonkeyPatch.context() as mp:
        for pkg, tc, rc in (("benchmarks", RefTestbedConfig, RefRouterConfig),
                            ("repro_torch.benchmarks", TestbedConfig,
                             RouterConfig)):
            common = importlib.import_module(f"{pkg}.common")
            mods = {name: importlib.import_module(f"{pkg}.{mod}")
                    for name, mod in BENCHES.items()}
            mp.setattr(common, "TestbedConfig", _sized(tc, rc, SIZE, EPOCHS))
            mp.setattr(common, "ART_DIR", tmp_path_factory.mktemp(
                pkg.replace(".", "_")))
            seeds = mods["seeds"]
            mp.setattr(seeds, "N_SEEDS", N_SEEDS)
            mp.setattr(seeds, "TestbedConfig",
                       _sized(tc, rc, SEEDS_SIZE, SEEDS_EPOCHS))
            common.canonical_results.cache_clear()
            common.canonical_hybrid9_logs.cache_clear()
            pkgs[pkg] = (common, mods)
        yield pkgs
        for common, _ in pkgs.values():
            common.canonical_results.cache_clear()
            common.canonical_hybrid9_logs.cache_clear()


@pytest.mark.parametrize("name", list(BENCHES))
def test_bench_matches_the_reference(packages, name, capsys):
    ref_common, ref_mods = packages["benchmarks"]
    common, mods = packages["repro_torch.benchmarks"]
    want = ref_mods[name].main()
    got = mods[name].main(device="cpu", init_params=_ref_init)
    assert got == want
    assert json.dumps(got) == json.dumps(want)
    artifact = f"{BENCHES[name]}.json"
    text = (common.ART_DIR / artifact).read_text()
    assert text == (ref_common.ART_DIR / artifact).read_text()
    assert json.loads(text)
    # the port writes only under its own artifact directory
    assert common.ART_DIR != ref_common.ART_DIR
    assert capsys.readouterr().out.strip()
    if name == "objectives":
        _check_objectives_grid(json.loads(text), got, mods[name].OBJECTIVES)


def _check_objectives_grid(rows, derived, objectives):
    """Both spaces' grids: per profile the best fixed action and the four
    objectives, hybrid9's rows over its 9 actions."""
    assert [r["space"] for r in rows] == ["paper5"] * 10 + ["hybrid9"] * 10
    methods = [r["method"] for r in rows[:5]]
    assert methods[0].startswith("best-fixed")
    assert methods[1:] == list(objectives)
    assert all(len(r["action_dist"]) == 9 for r in rows[10:])
    assert all(np.isfinite(r["reward"]) for r in rows)
    assert set(derived) >= {"hybrid9_cheap_argmax_ce_refusal",
                            "cheap_constrained_refusal"}


def test_run_prints_the_csv_and_takes_the_device(packages, capsys):
    from repro_torch.benchmarks import run
    rows = run.main(["seeds", "--device", "cpu"])
    assert [r[0] for r in rows] == ["seeds"]
    out = capsys.readouterr().out.splitlines()
    head = out.index("name,us_per_call,derived")
    (line,) = out[head + 1:]
    name, us, derived = line.split(",", 2)
    assert name == "seeds" and int(us) > 0
    assert json.loads(derived) == rows[0][2]
    # the ten paper benches, then the dry run's before/after table
    assert list(run.BENCHMARKS) == list(BENCHES) + ["perf"]
    with pytest.raises(SystemExit):
        run.main(["roofline", "--device", "cpu"])


def test_benches_default_to_the_card(monkeypatch):
    from repro_torch.benchmarks import common, run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.main(["table1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        common.canonical_hybrid9_logs()


# -- the example twins -------------------------------------------------------

@pytest.fixture
def small_examples(monkeypatch):
    """The example twins' testbeds at the benches' small size."""
    for name in ("quickstart", "adaptive_serving",
                 "refusal_collapse_and_mitigation"):
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        monkeypatch.setattr(mod, "TestbedConfig",
                            _sized(TestbedConfig, RouterConfig, SIZE, EPOCHS))

def test_quickstart_on_the_host(small_examples, capsys):
    from repro_torch.examples import quickstart
    res, stats = quickstart.main(["--device", "cpu"])
    assert len(res.rows) == 2 * 4 and stats.served == 60
    out = capsys.readouterr().out
    assert "Refusal collapse under cheap SLO" in out
    assert "Gateway served 60 requests" in out


def test_adaptive_serving_tightens_the_refusal_share(small_examples):
    from repro_torch.examples import adaptive_serving
    shares = adaptive_serving.main(["--device", "cpu"])
    (plain, plain_share), (adaptive, adaptive_share) = \
        shares[False], shares[True]
    assert plain.served == adaptive.served == 100
    assert adaptive_share <= plain_share


def test_refusal_collapse_and_mitigation_on_the_host(small_examples,
                                                       capsys):
    from repro_torch.examples import refusal_collapse_and_mitigation as ex
    rep, repc, bf = ex.main(["--device", "cpu"])
    assert np.isfinite([rep.reward, repc.reward, bf.reward]).all()
    assert "final lambda" in capsys.readouterr().out


def test_train_tiny_lm_on_the_host(monkeypatch):
    from repro_torch.examples import train_tiny_lm
    from repro_torch.launch import train
    losses = train_tiny_lm.main(["--device", "cpu", "--steps", "3",
                                 "--batch", "2", "--seq", "32"])
    assert len(losses) == 3 and np.isfinite(losses).all()
    seen = []
    monkeypatch.setattr(train, "main", seen.append)
    train_tiny_lm.main(["--device", "cpu"])
    assert seen == [["--device", "cpu", "--steps", "200"]]


@pytest.mark.parametrize("example", ["quickstart", "adaptive_serving",
                                     "refusal_collapse_and_mitigation",
                                     "train_tiny_lm"])
def test_examples_default_to_the_card(monkeypatch, example):
    mod = importlib.import_module(f"repro_torch.examples.{example}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["--steps", "1"] if example == "train_tiny_lm" else [])
