"""Router training in the port against the reference.

``core/policy.py`` (targets, the minibatch Adam loop under every
objective), ``core/conditioned.py`` and the policy adapters of
``routing/policy.py``, each trained on the same offline log in both
packages from the same initial params: the reference's
``init_policy(PRNGKey(seed))`` draw, crossed into the port through
``bridge.params_from_numpy`` (the port's own draw comes from a torch
generator and cannot reproduce it).

Tolerances: targets are identical (the same numpy calls).  Trained
params agree within 1e-5 absolute (the gradients come from XLA's and
torch's float32 kernels, which sum in other orders; observed at most
1.5e-6 over 8 epochs, with params of magnitude up to 0.7); each epoch's
mean loss and refusal probability within 1e-5 relative; the Lagrange
multiplier within 1e-5 absolute (it integrates dual_lr x (p_refuse -
cap), a difference that cancels most of p_refuse's digits: observed
2.4e-7); eval actions identical.
"""
import torch_threads  # noqa: F401  (caps torch's threads under xdist)
import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core.conditioned import train_conditioned as ref_train_conditioned
from repro.core.actions import SLO_PROFILES as REF_PROFILES
from repro.core.config import RouterConfig as RefRouterConfig
from repro.core.policy import init_policy as ref_init_policy
from repro.core.policy import make_targets as ref_make_targets
from repro.core.policy import policy_actions as ref_policy_actions
from repro.core.policy import train_policy as ref_train_policy
from repro.routing import ConditionedPolicy as RefConditioned
from repro.routing import ConstrainedPolicy as RefConstrained
from repro.routing import RoutingContext as RefContext
from repro_torch.bridge import params_from_numpy
from repro_torch.core.actions import SLO_PROFILES
from repro_torch.core.conditioned import (conditioned_actions,
                                          train_conditioned)
from repro_torch.core.config import RouterConfig, TestbedConfig
from repro_torch.core.experiment import run_experiment
from repro_torch.core.offline_log import build_testbed
from repro_torch.core.policy import (init_policy, make_targets,
                                     policy_actions, train_policy)
from repro_torch.routing import (ConditionedPolicy, ConstrainedPolicy,
                                 MLPPolicy, RoutingContext)

EPOCHS = 8
PARAM_ATOL = 1e-5
HIST_RTOL = 1e-5
LAMBDA_ATOL = 1e-5


@pytest.fixture(scope="module")
def logs():
    """The SMOKE-size paper5 testbed's train and eval logs (host numpy;
    ``tests/test_torch_simulator.py`` shows them identical to the
    reference's)."""
    cfg = TestbedConfig(n_train=120, n_eval=60, n_paragraphs=120)
    _, _, _, train_log, eval_log = build_testbed(cfg)
    return train_log, eval_log


def _configs(**kw):
    return (RefRouterConfig(n_epochs=EPOCHS, **kw),
            RouterConfig(n_epochs=EPOCHS, **kw))


def _ref_init(ref_cfg):
    """The reference's initial draw, as numpy and as port tensors."""
    init = {k: np.asarray(v) for k, v in
            ref_init_policy(jax.random.PRNGKey(ref_cfg.seed), ref_cfg).items()}
    return init, params_from_numpy(init, device="cpu")


def test_make_targets_identical_with_ties(logs):
    train_log, _ = logs
    cheap = train_log.rewards(SLO_PROFILES["cheap"])
    ties = np.array([[0.1, 0.1, 0.1, -0.2, 0.1],
                     [-0.5, -0.5, -0.5, -0.5, -0.5],
                     [0.3, 0.2, 0.3, 0.2, 0.0]], np.float32)
    for rewards in (cheap, ties, np.vstack([cheap, ties])):
        for objective in ("argmax_ce", "argmax_ce_wt", "soft_reward",
                          "constrained"):
            for temp in (1.0, 0.5):
                got = make_targets(rewards, objective, temp)
                want = ref_make_targets(rewards, objective, temp)
                for g, w in zip(got, want):
                    if w is None:
                        assert g is None
                    else:
                        assert g.dtype == w.dtype and np.array_equal(g, w)
    # a tied row's best action is numpy's pick, not the first index
    assert make_targets(ties, "argmax_ce")[0][1] == \
        ref_make_targets(ties, "argmax_ce")[0][1]
    with pytest.raises(ValueError):
        make_targets(ties, "nope")


def _check_result(got, want, init):
    for k in init:
        np.testing.assert_allclose(got.params[k].numpy(),
                                   np.asarray(want.params[k]),
                                   rtol=0, atol=PARAM_ATOL, err_msg=k)
        assert got.params[k].dtype == torch.float32
        assert not got.params[k].requires_grad
    assert len(got.history) == len(want.history) == EPOCHS
    for g, w in zip(got.history, want.history):
        assert g["epoch"] == w["epoch"]
        assert g["loss"] == pytest.approx(w["loss"], rel=HIST_RTOL)
        assert g["p_refuse"] == pytest.approx(w["p_refuse"], rel=HIST_RTOL)
        assert g["lambda"] == pytest.approx(w["lambda"], rel=0,
                                            abs=LAMBDA_ATOL)
    assert got.lagrange == pytest.approx(want.lagrange, rel=0,
                                         abs=LAMBDA_ATOL)


@pytest.mark.parametrize("objective,profile,refuse", [
    ("argmax_ce", "quality_first", 4),
    ("argmax_ce_wt", "cheap", 4),
    ("soft_reward", "cheap", 4),
    ("constrained", "cheap", 4),
    ("constrained", "cheap", None),      # a log with no refuse action
])
def test_train_policy_matches_reference(logs, objective, profile, refuse):
    train_log, eval_log = logs
    train_log = dataclasses.replace(train_log, refuse_action=refuse)
    rewards = train_log.rewards(SLO_PROFILES[profile])
    ref_cfg, cfg = _configs()
    init, init_t = _ref_init(ref_cfg)
    kw = dict(objective=objective, refusal_cap=0.3)
    want = ref_train_policy(train_log, rewards, ref_cfg, **kw)
    got = train_policy(train_log, rewards, cfg, init_params=init_t,
                       device="cpu", **kw)
    _check_result(got, want, init)
    # the injected tree is copied, never trained in place
    assert all(torch.equal(init_t[k], torch.tensor(init[k])) for k in init)
    if objective == "constrained" and refuse is not None:
        assert got.lagrange > 0          # the dual update was exercised
    if refuse is None:
        assert all(h["p_refuse"] == 0.0 and h["lambda"] == 0.0
                   for h in got.history)
    np.testing.assert_array_equal(
        policy_actions(got.params, eval_log.states, cfg),
        ref_policy_actions(want.params, eval_log.states, ref_cfg))


def test_constrained_policy_decisions_match_reference(logs):
    train_log, eval_log = logs
    rewards = train_log.rewards(SLO_PROFILES["cheap"])
    ref_cfg, cfg = _configs()
    _, init_t = _ref_init(ref_cfg)
    want = RefConstrained.train(train_log, rewards, ref_cfg, refusal_cap=0.3)
    got = ConstrainedPolicy.train(train_log, rewards, cfg, refusal_cap=0.3,
                                  init_params=init_t, device="cpu")
    assert got.name == want.name == "constrained"
    assert got.lagrange == pytest.approx(want.lagrange, rel=0,
                                         abs=LAMBDA_ATOL)
    for ctx, ref_ctx in ((None, None), (RoutingContext(refusal_cap=0.2),
                                        RefContext(refusal_cap=0.2))):
        d, w = (got.route(eval_log.states, "cheap", ctx),
                want.route(eval_log.states, "cheap", ref_ctx))
        np.testing.assert_array_equal(d.actions, w.actions)
        assert sorted(d.constraints) == sorted(w.constraints)
        for k, v in w.constraints.items():
            assert d.constraints[k] == pytest.approx(v, rel=0,
                                                     abs=LAMBDA_ATOL)
        np.testing.assert_allclose(d.confidences, w.confidences, atol=1e-5)
    with pytest.raises(ValueError, match="constrained"):
        ConstrainedPolicy.train(train_log, rewards, cfg,
                                objective="argmax_ce", device="cpu")


def test_conditioned_policy_decisions_match_reference(logs):
    train_log, eval_log = logs
    profiles = [SLO_PROFILES["quality_first"], SLO_PROFILES["cheap"]]
    ref_cfg, cfg = _configs()
    ref_ccfg = dataclasses.replace(ref_cfg, state_dim=ref_cfg.state_dim + 5,
                                   condition_on_slo=True)
    _, init_t = _ref_init(ref_ccfg)
    want = RefConditioned.train(train_log, profiles, ref_cfg)
    got = ConditionedPolicy.train(train_log, profiles, cfg,
                                  init_params=init_t, device="cpu")
    assert got.cfg.state_dim == 277 and got.cfg.condition_on_slo
    mixed = ["cheap", "quality_first"] * (eval_log.n // 2)
    for slo, ref_slo in (("quality_first", "quality_first"),
                         ("cheap", "cheap"),
                         (SLO_PROFILES["cheap"], REF_PROFILES["cheap"]),
                         (mixed, mixed)):
        np.testing.assert_array_equal(
            got.route(eval_log.states, slo).actions,
            want.route(eval_log.states, ref_slo).actions)
    with pytest.raises(ValueError, match="requires an SLO"):
        got.route(eval_log.states)
    with pytest.raises(ValueError, match="SLOs for"):
        got.route(eval_log.states, ["cheap"])
    # the functional form agrees with the adapter, and with the reference
    tr, ccfg = train_conditioned(train_log, profiles, cfg, n_interp=1,
                                 init_params=init_t, device="cpu")
    ref_tr, ref_ccfg2 = ref_train_conditioned(train_log, profiles, ref_cfg,
                                              n_interp=1)
    assert ccfg.state_dim == ref_ccfg2.state_dim
    for p in profiles:
        acts = conditioned_actions(tr, ccfg, eval_log, p)
        ref_acts = ref_policy_actions(
            ref_tr.params, np.concatenate(
                [eval_log.states, np.tile(np.array(
                    [p.w_acc, p.w_cost, p.w_hall, p.w_ref, p.w_ref_wrong],
                    np.float32)[None], (eval_log.n, 1))], axis=1), ref_ccfg2)
        np.testing.assert_array_equal(acts, ref_acts)


def test_mlp_policy_train_threads_init_and_device(logs):
    train_log, eval_log = logs
    rewards = train_log.rewards(SLO_PROFILES["quality_first"])
    ref_cfg, cfg = _configs()
    init, init_t = _ref_init(ref_cfg)
    pol = MLPPolicy.train(train_log, rewards, cfg, init_params=init_t,
                          device="cpu")
    direct = train_policy(train_log, rewards, cfg, init_params=init_t,
                          device="cpu")
    assert pol.name == "argmax_ce" and pol.train_result.history
    for k in init:
        assert pol.params[k].device.type == "cpu"
        assert torch.equal(pol.params[k], direct.params[k])
    np.testing.assert_array_equal(
        pol.actions(eval_log.states),
        policy_actions(direct.params, eval_log.states, cfg))


def test_seeded_init_is_deterministic(logs):
    train_log, _ = logs
    rewards = train_log.rewards(SLO_PROFILES["cheap"])
    cfg = RouterConfig(n_epochs=2)
    a = train_policy(train_log, rewards, cfg, device="cpu")
    b = train_policy(train_log, rewards, cfg, device="cpu")
    c = train_policy(train_log, rewards, cfg, seed=1, device="cpu")
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k])
    assert not torch.equal(a.params["w0"], c.params["w0"])
    assert a.history == b.history


class _ScalarReads(TorchDispatchMode):
    """Counts every device-to-host scalar read: each is an
    ``aten._local_scalar_dense`` call."""

    def __init__(self):
        super().__init__()
        self.reads = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.reads += func is torch.ops.aten._local_scalar_dense.default
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("objective", ["constrained", "soft_reward"])
def test_training_reads_no_scalar_inside_an_epoch(logs, objective):
    """The step's loss and refusal probability stay on the device; the
    epoch's values come back in one copy, never as scalar reads.  (The
    control: the mode does see ``float`` of a tensor.)"""
    train_log, _ = logs
    rewards = train_log.rewards(SLO_PROFILES["cheap"])
    cfg = RouterConfig(n_epochs=3)
    with _ScalarReads() as mode:
        tr = train_policy(train_log, rewards, cfg, objective=objective,
                          refusal_cap=0.3, device="cpu")
    assert mode.reads == 0
    assert len(tr.history) == 3
    with _ScalarReads() as mode:
        float(tr.params["b0"].sum())
    assert mode.reads == 1


def test_default_device_is_the_card(logs, monkeypatch):
    """No card: every training entry point raises instead of falling
    back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    train_log, _ = logs
    rewards = train_log.rewards(SLO_PROFILES["cheap"])
    cfg = RouterConfig(n_epochs=1)
    calls = [
        lambda: init_policy(0, cfg),
        lambda: train_policy(train_log, rewards, cfg),
        lambda: MLPPolicy.train(train_log, rewards, cfg),
        lambda: ConstrainedPolicy.train(train_log, rewards, cfg),
        lambda: ConditionedPolicy.train(train_log, [SLO_PROFILES["cheap"]],
                                        cfg),
        lambda: run_experiment(TestbedConfig(n_train=4, n_eval=2,
                                             n_paragraphs=8)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
