"""The paper experiment, off-policy evaluation and the simulator Gateway
of the port against the reference.

``core/experiment.py::run_experiment`` (testbed, six trainings, the
Table 1 rows), ``core/ope.py`` and ``serving/scheduler.py`` over the
simulator backend, each on the same inputs in both packages.  With the
reference's initial params injected (its ``init_policy(PRNGKey(seed))``
draw crossed through ``bridge.params_from_numpy``) the Table 1 rows are
identical; the estimators and the Gateway's stats are host code and are
identical too.  Last, the port's own seeded training (a torch generator)
shows the paper's failure mode at ``tests/test_paper_core.py``'s size
and with its assertions.
"""
import torch_threads  # noqa: F401  (caps torch's threads under xdist)
import jax
import numpy as np
import pytest

from repro.core.config import RouterConfig as RefRouterConfig
from repro.core.config import TestbedConfig as RefTestbedConfig
from repro.core.experiment import run_experiment as ref_run_experiment
from repro.core.metrics import best_fixed_action as ref_best
from repro.core.metrics import evaluate_actions as ref_eval_acts
from repro.core.metrics import fixed_action_report as ref_fixed
from repro.core.ope import estimator_suite as ref_estimator_suite
from repro.core.policy import init_policy as ref_init_policy
from repro.routing import Gateway as RefGateway
from repro.routing import MLPPolicy as RefMLP
from repro.routing import Request as RefRequest
from repro.routing import SimulatorBackend as RefSimBackend
from repro.routing import get_slo_profile as ref_profile
from repro.serving.scheduler import Scheduler as RefScheduler
from repro_torch.bridge import params_from_numpy
from repro_torch.core.actions import REFUSE_ACTION, SLO_PROFILES
from repro_torch.core.config import RouterConfig, TestbedConfig
from repro_torch.core.experiment import run_experiment
from repro_torch.core.metrics import (best_fixed_action, evaluate_actions,
                                      fixed_action_report)
from repro_torch.core.offline_log import build_testbed
from repro_torch.core.ope import estimator_suite
from repro_torch.core.policy import policy_actions, train_policy
from repro_torch.routing import (Gateway, MLPPolicy, Request,
                                 SimulatorBackend)
from repro_torch.serving.scheduler import Scheduler, SchedulerStats

SIZE = dict(n_train=120, n_eval=60, n_paragraphs=120)
EPOCHS = 8


def _ref_init_numpy(rc):
    return {k: np.asarray(v) for k, v in
            ref_init_policy(jax.random.PRNGKey(rc.seed), rc).items()}


@pytest.fixture(scope="module")
def experiments():
    """``run_experiment`` at the SMOKE size in both packages, with
    mitigation, the port trained from the reference's initial params."""
    kw = dict(include_mitigation=True, refusal_cap=0.45, verbose=False)
    ref = ref_run_experiment(RefTestbedConfig(
        **SIZE, router=RefRouterConfig(n_epochs=EPOCHS)), **kw)
    port = run_experiment(
        TestbedConfig(**SIZE, router=RouterConfig(n_epochs=EPOCHS)),
        init_params=lambda rc: params_from_numpy(_ref_init_numpy(rc),
                                                 device="cpu"),
        device="cpu", **kw)
    return ref, port


def test_run_experiment_rows_identical(experiments, tmp_path):
    (ref_res, ref_extras, _), (res, extras, (train_log, eval_log)) = \
        experiments
    assert len(res.rows) == len(ref_res.rows) == 2 * (2 + 3)
    assert res.rows == ref_res.rows
    assert extras["action_dists"] == ref_extras["action_dists"]
    assert sorted(extras["train_hist"]) == sorted(ref_extras["train_hist"])
    for key, h in extras["train_hist"].items():
        want = ref_extras["train_hist"][key]
        assert h["epoch"] == want["epoch"] == EPOCHS - 1
        assert h["loss"] == pytest.approx(want["loss"], rel=1e-5)
    assert res.table() == ref_res.table()
    res.save(tmp_path / "rows.json")
    ref_res.save(tmp_path / "ref_rows.json")
    assert (tmp_path / "rows.json").read_text() == \
        (tmp_path / "ref_rows.json").read_text()
    assert train_log.n == SIZE["n_train"] and eval_log.n == SIZE["n_eval"]
    secs = extras["seconds"]
    assert sorted(secs) == sorted(["build_testbed", *extras["train_hist"]])
    assert all(s > 0 for s in secs.values())


def test_metrics_reports_identical(experiments):
    (_, _, (_, ref_eval)), (_, _, (_, eval_log)) = experiments
    rng = np.random.default_rng(0)
    acts = rng.integers(0, 5, eval_log.n)
    for name in ("quality_first", "cheap"):
        p, rp = SLO_PROFILES[name], ref_profile(name)
        assert evaluate_actions(eval_log, acts, p, "x").row() == \
            ref_eval_acts(ref_eval, acts, rp, "x").row()
        assert fixed_action_report(eval_log, 2, p).row() == \
            ref_fixed(ref_eval, 2, rp).row()
        a, rep = best_fixed_action(eval_log, p)
        ra, ref_rep = ref_best(ref_eval, rp)
        assert a == ra and rep.row() == ref_rep.row()
        assert len(rep.action_dist) == eval_log.n_actions


@pytest.mark.parametrize("kind", ["uniform", "eps_anchor"])
def test_estimator_suite_identical(experiments, kind):
    _, (_, _, (_, eval_log)) = experiments
    rewards = eval_log.rewards(SLO_PROFILES["quality_first"])
    target = np.argmax(rewards, axis=1)
    target[::4] = 1
    got = estimator_suite(rewards, eval_log.states, target, kind=kind,
                          seeds=6)
    want = ref_estimator_suite(rewards, eval_log.states, target, kind=kind,
                               seeds=6)
    assert got == want
    assert sorted(got) == ["dr", "ips", "snips", "truth"]


def _requests(data, n, slo, cls):
    return [cls(qid=q.qid, question=q, slo=slo) for q in data.questions[-n:]]


def _stats_tuple(st):
    return (st.served, dict(st.action_counts), st.total_reward,
            st.refusal_cap_history, st.rejected, st.degraded,
            st.retrieval_cache_hits, st.retrieval_cache_lookups,
            [list(d.actions) for d in st.decisions],
            [dict(d.constraints) for d in st.decisions])


def test_scheduler_and_gateway_give_the_reference_stats(experiments):
    """A cheap policy trained by the reference, its params bridged: the
    port's Scheduler, and its Gateway over SimulatorBackend and over the
    raw pipeline, give the reference's GatewayStats."""
    (_, ref_extras, (ref_train, _)), (_, extras, _) = experiments
    ref_data, ref_index, ref_pipe = ref_extras["testbed"]
    data, index, pipe = extras["testbed"]
    ref_cfg, cfg = RefRouterConfig(n_epochs=EPOCHS), RouterConfig(
        n_epochs=EPOCHS)
    ref_pol = RefMLP.train(ref_train, ref_train.rewards(ref_profile("cheap")),
                           ref_cfg, objective="argmax_ce")
    params = params_from_numpy(
        {k: np.asarray(v) for k, v in ref_pol.params.items()}, device="cpu")
    pol = MLPPolicy(params, cfg, name="argmax_ce")
    kw = dict(max_batch=16, adaptive_refusal=True, base_refusal_share=0.5)

    ref_sched = RefScheduler(ref_pipe, ref_pol.params, ref_cfg, **kw)
    ref_sched.submit(_requests(ref_data, 60, "cheap", RefRequest))
    want = _stats_tuple(ref_sched.drain())
    sched = Scheduler(pipe, params, cfg, **kw)
    sched.submit(_requests(data, 60, "cheap", Request))
    st = sched.drain()
    assert isinstance(st, SchedulerStats)
    assert _stats_tuple(st) == want
    assert st.served == 60 and min(st.refusal_cap_history) < 0.5
    assert sched.queue == [] and sched.stats is st and sched.budget

    ref_gw = RefGateway(ref_pol, RefSimBackend(ref_pipe), router_cfg=ref_cfg,
                        index=ref_index, **kw)
    ref_st = ref_gw.serve(_requests(ref_data, 60, "cheap", RefRequest))
    for backend in (SimulatorBackend(pipe), pipe):
        gw = Gateway(pol, backend, router_cfg=cfg, index=index, **kw)
        got = gw.serve(_requests(data, 60, "cheap", Request))
        assert _stats_tuple(got) == _stats_tuple(ref_st) == want
        assert gw.refusal_share == ref_gw.refusal_share


@pytest.fixture(scope="module")
def paper_testbed():
    cfg = TestbedConfig(n_train=300, n_eval=100, n_paragraphs=300,
                        router=RouterConfig(n_epochs=15))
    return cfg, build_testbed(cfg)


def _train_eval(paper_testbed, profile, objective, **kw):
    cfg, (_, _, _, train_log, eval_log) = paper_testbed
    p = SLO_PROFILES[profile]
    tr = train_policy(train_log, train_log.rewards(p), cfg.router,
                      objective=objective, device="cpu", **kw)
    acts = policy_actions(tr.params, eval_log.states, cfg.router)
    _, bf = best_fixed_action(eval_log, p)
    return evaluate_actions(eval_log, acts, p, objective), bf


def test_seeded_training_collapses_under_cheap(paper_testbed):
    """Paper §6.2 with the port's own initial draw: cheap Argmax-CE
    collapses to refusal, and the collapse is harmful."""
    rep, bf = _train_eval(paper_testbed, "cheap", "argmax_ce")
    assert rep.refusal_rate > 0.5, rep
    assert rep.acc < 0.2
    assert rep.reward < bf.reward


def test_seeded_training_competitive_under_quality_first(paper_testbed):
    rep, bf = _train_eval(paper_testbed, "quality_first", "argmax_ce")
    assert rep.reward > bf.reward - 0.1
    assert rep.refusal_rate < 0.8


def test_seeded_constrained_objective_caps_refusal(paper_testbed):
    un, _ = _train_eval(paper_testbed, "cheap", "argmax_ce")
    con, _ = _train_eval(paper_testbed, "cheap", "constrained",
                         refusal_cap=0.3)
    assert con.action_dist[REFUSE_ACTION] < un.action_dist[REFUSE_ACTION]
    assert con.acc > un.acc
