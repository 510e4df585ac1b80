"""One host clock for a serving mesh's ranks.

Every rank of a mesh runs the whole host scheduler on the same inputs,
and a clock reading is one of them.  The reference serves a mesh from
one controller, so it has one clock; the port runs a process a rank, so
every clock reading that feeds a host decision must be rank 0's
(``ServingMesh.agreed_clock``), and the real-time open loop pumps in
lockstep with rank 0's.  Each world below gives its ranks clocks that
disagree (rank ``r`` reads a :class:`~torch_dist.ScriptedClock` of
``dt * (1 + r)``, a slow host and a fast one, or its own
``perf_counter``) and holds every rank's decisions to one device's
under rank 0's clock, on qwen SMOKE in float32 over spawned gloo worlds
(``tests/torch_dist.py``):

* (a) a world of one and ``mesh=None``: the agreed clock is the injected
  callable, and serving issues no host-group collective;
* (b) the engine's deadlines at dp=2 and dp=1 x mp=2: every
  ``CompletedGeneration`` is one device's under rank 0's clock, which is
  the reference engine's under the same clock;
* (c) ``Gateway.serve``'s closed-loop retries under ``deadline_ms``;
* (d) the same with a latency budget target and adaptive refusal: the
  refusal caps, routed actions and budgets;
* (e) the real-time open loop (``AsyncGateway.start`` and
  ``LoadGenerator.run_realtime``) at dp=2: the same handles, report and
  pumps on both ranks, and a world that exits 0 with no teardown
  message.

Each world has its own bound of ``CLOCK_WORLD_TIMEOUT_S`` (120 s).
"""
import torch_threads  # noqa: F401  (caps torch's threads under xdist)
import dataclasses
from unittest import mock

import jax
import numpy as np
import pytest
import torch.distributed as dist

import torch_dist as W
from repro.configs import get_config as ref_config
from repro.models import build_model as ref_build
from repro.serving.continuous import ContinuousEngine as RefEngine

DT = 0.01
# engine-clock deadlines of the eight prompts (0 = none): under rank 0's
# clock requests 0, 4 (resident) and 5 (queued) time out; at rank 1's
# rate 2 and 7 would too
DEADLINES = [0.05, 0.0, 0.12, 0.0, 0.04, 0.14, 0.0, 0.2]
RETRY_DEADLINE_MS = 200.0   # rank 0 retries all 8, rank 1's rate 4
LATENCY_DEADLINE_MS = 100.0
LATENCY_TARGET_MS = 150.0
ENGINE_LAYOUTS = {"dp2": "dp=2", "mp2": "dp=1,mp=2"}
OPEN_LOOP = dict(n_requests=16, rate=40.0, deadline_ms=4000.0)


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [list(map(int, rng.integers(4, vocab, size=n)))
            for n in (10, 7, 10, 5, 7, 9, 12, 6)]


@pytest.fixture(scope="module")
def ref():
    cfg = dataclasses.replace(ref_config(W.QWEN, "smoke"), dtype="float32")
    rm = ref_build(cfg)
    rp = rm.init(jax.random.PRNGKey(0))
    prompts = _prompts(cfg.vocab_size)
    eng = RefEngine(rm, rp, clock=W.ScriptedClock(DT), **W.DENSE_KW)
    rids = [eng.reserve_rid() for _ in prompts]
    for rid, p, dl in zip(rids, prompts, DEADLINES):
        eng.submit(rid, p, 12, deadline_at=dl)
    done = eng.run()
    return {"np": jax.tree_util.tree_map(np.asarray, rp), "prompts": prompts,
            "engine": [(r, [int(t) for t in done[r].tokens],
                        bool(done[r].timed_out), done[r].failed,
                        float(done[r].admitted_at),
                        float(done[r].finished_at)) for r in rids]}


@pytest.fixture(scope="module")
def port(ref):
    """The port on one device (``mesh=None``) under rank 0's clock."""
    cfg, model, params = W._model(W.QWEN, ref["np"])
    out = {"engine": W.engine_deadlines(model, params, ref["prompts"],
                                        DEADLINES, W.ScriptedClock(DT)),
           "engine_fast": W.engine_deadlines(model, params, ref["prompts"],
                                             DEADLINES,
                                             W.ScriptedClock(2 * DT))}
    for key, dl, lat, dt in (("retry", RETRY_DEADLINE_MS, 0.0, DT),
                             ("retry_fast", RETRY_DEADLINE_MS, 0.0, 2 * DT),
                             ("latency", LATENCY_DEADLINE_MS,
                              LATENCY_TARGET_MS, DT),
                             ("latency_fast", LATENCY_DEADLINE_MS,
                              LATENCY_TARGET_MS, 2 * DT)):
        clock = W.ScriptedClock(dt)
        with W.gateway_perf_counter(clock):
            out[key] = W.gateway_deadlines(
                model, params, cfg, 12 if lat else 8, mesh=None, clock=clock,
                deadline_ms=dl, latency_ms=lat)
    return out


@pytest.fixture(scope="module")
def worlds(ref, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_clock")
    out = {}
    for name, spec in ENGINE_LAYOUTS.items():
        out[("engine", name)] = W.run_world(
            W.clock_engine, 2, tmp, spec, ref["np"], ref["prompts"],
            DEADLINES, DT, timeout=W.CLOCK_WORLD_TIMEOUT_S)
    out["retry"] = W.run_world(W.clock_gateway, 2, tmp, "dp=2", ref["np"], 8,
                               RETRY_DEADLINE_MS, DT, 0.0,
                               timeout=W.CLOCK_WORLD_TIMEOUT_S)
    out["latency"] = W.run_world(W.clock_gateway, 2, tmp, "dp=2", ref["np"],
                                 12, LATENCY_DEADLINE_MS, DT,
                                 LATENCY_TARGET_MS,
                                 timeout=W.CLOCK_WORLD_TIMEOUT_S)
    return out


# -- (a) a world of one, and no mesh ---------------------------------------

@pytest.fixture
def mesh_of_one():
    from repro_torch.launch.mesh import make_serving_mesh
    assert not dist.is_initialized()
    try:
        yield make_serving_mesh("dp=1", device="cpu")
    finally:
        dist.destroy_process_group()


def test_world_of_one_takes_the_callable_itself(mesh_of_one):
    clock = W.ScriptedClock(DT)
    assert mesh_of_one.host is not None and mesh_of_one.n_ranks == 1
    assert mesh_of_one.agreed_clock(clock) is clock
    assert mesh_of_one.leader


def _open_loop_virtual(model, params, cfg, mesh):
    """``LoadGenerator.run_virtual`` on a seeded Poisson trace: each
    handle's outcome and stamps, the report and the pumps."""
    from repro_torch.core.config import RetrievalConfig, RouterConfig
    from repro_torch.data import HashTokenizer, SyntheticSquad
    from repro_torch.retrieval import BM25Index
    from repro_torch.routing import ContinuousEngineBackend, FixedPolicy
    from repro_torch.serving.streaming import AsyncGateway
    from repro_torch.serving.traffic import (LoadGenerator, PoissonProcess,
                                             VirtualClock, build_trace)
    data = SyntheticSquad(n_paragraphs=40, n_questions=8, seed=0)
    index = BM25Index.build([p.text for p in data.paragraphs],
                            RetrievalConfig(vocab_hash_dim=1024))
    clock = VirtualClock()
    backend = ContinuousEngineBackend.create(
        model, params, HashTokenizer(cfg.vocab_size), index, num_slots=4,
        max_prompt_len=48, max_new_tokens=8, sync_every=2, mesh=mesh,
        clock=clock.now)
    gw = AsyncGateway(FixedPolicy(2), backend, router_cfg=RouterConfig(),
                      index=index, deadline_ms=300.0, route_batch=4,
                      clock=clock.now)
    trace = build_trace(data.questions, PoissonProcess(40.0, seed=0), 12,
                        deadline_ms=300.0)
    gen = LoadGenerator(gw, trace)
    rep = gen.run_virtual(clock, service_quantum_s=0.02)
    return ([(h.shed, h.outcome.answer, h.arrival_t, h.completed_t,
              h.first_token_t) for h in gen.last_handles], rep.as_dict(),
            gw.pumps)


@pytest.mark.parametrize("kind", ["engine", "closed_loop", "open_loop"])
def test_world_of_one_issues_no_host_collective(ref, mesh_of_one, kind):
    """Without a mesh, and over a mesh of one (host group made), the
    engine's deadlines, the closed loop with retries and a latency
    target, and the virtual-time open loop give the same run and issue
    no host-group collective."""
    from repro_torch.launch.mesh import ServingMesh
    cfg, model, params = W._model(W.QWEN, ref["np"])
    calls = []
    real = ServingMesh.agree

    def agree(self, *a, **kw):
        calls.append(a)
        return real(self, *a, **kw)

    def run(mesh):
        if kind == "engine":
            return W.engine_deadlines(model, params, ref["prompts"],
                                      DEADLINES, W.ScriptedClock(DT), mesh)
        if kind == "closed_loop":
            clock = W.ScriptedClock(DT)
            with W.gateway_perf_counter(clock):
                return W.gateway_deadlines(
                    model, params, cfg, 12, mesh=mesh, clock=clock,
                    deadline_ms=LATENCY_DEADLINE_MS,
                    latency_ms=LATENCY_TARGET_MS)
        return _open_loop_virtual(model, params, cfg, mesh)

    with mock.patch.object(ServingMesh, "agree", agree), \
            mock.patch.object(dist, "broadcast",
                              side_effect=AssertionError("broadcast")):
        want = run(None)
        got = run(mesh_of_one)
    assert calls == []
    assert got == want


def test_without_a_mesh_every_clock_is_the_injected_one(ref):
    from repro_torch.core.config import RetrievalConfig, RouterConfig
    from repro_torch.data import HashTokenizer, SyntheticSquad
    from repro_torch.retrieval import BM25Index
    from repro_torch.routing import ContinuousEngineBackend, FixedPolicy
    from repro_torch.routing import gateway
    from repro_torch.serving.streaming import AsyncGateway
    cfg, model, params = W._model(W.QWEN, ref["np"])
    data = SyntheticSquad(n_paragraphs=40, n_questions=2, seed=0)
    index = BM25Index.build([p.text for p in data.paragraphs],
                            RetrievalConfig(vocab_hash_dim=1024))
    clock = W.ScriptedClock(DT)
    backend = ContinuousEngineBackend.create(
        model, params, HashTokenizer(cfg.vocab_size), index, num_slots=4,
        max_prompt_len=48, max_new_tokens=8, clock=clock)
    assert backend.mesh is None and backend.engine._clock is clock
    gw = AsyncGateway(FixedPolicy(2), backend, router_cfg=RouterConfig(),
                      index=index, clock=clock)
    assert gw.clock is clock and gw.local_clock is clock
    assert gw._retry_clock is gateway._perf_counter
    assert gw._mesh is None and gw.is_leader


# -- (b) the engine's deadlines ---------------------------------------------

def test_one_device_engine_is_the_reference_under_a_scripted_clock(ref, port):
    got = [(g[0], g[1], g[2], g[3], g[5], g[6]) for g in port["engine"]["gens"]]
    assert got == ref["engine"]
    timed_out = [g[0] for g in port["engine"]["gens"] if g[2]]
    fast = [g[0] for g in port["engine_fast"]["gens"] if g[2]]
    # the scenario decides: some time out, and rank 1's rate would time
    # out others
    assert timed_out == [0, 4, 5] and fast != timed_out


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("layout", list(ENGINE_LAYOUTS))
def test_engine_deadlines_are_rank0s_on_every_rank(worlds, port, layout,
                                                   rank):
    got = worlds[("engine", layout)][rank]
    assert got["gens"] == port["engine"]["gens"]
    assert got["timed_out"] == port["engine"]["timed_out"] == 3
    # only rank 0 reads its own clock
    assert (got["own_reads"] > 0) == (rank == 0)


# -- (c) closed-loop retries, (d) latency budgets ---------------------------

@pytest.mark.parametrize("rank", [0, 1])
def test_closed_loop_retries_are_rank0s_on_every_rank(worlds, port, rank):
    want = port["retry"]
    assert (want["retries"], want["faulted"]) == (8, 0)
    assert (port["retry_fast"]["retries"], port["retry_fast"]["faulted"]) \
        == (4, 4)
    assert worlds["retry"][rank] == want


@pytest.mark.parametrize("rank", [0, 1])
def test_latency_budget_and_refusal_caps_are_rank0s_on_every_rank(
        worlds, port, rank):
    want, got = port["latency"], worlds["latency"][rank]
    assert want["refusal_cap_history"] != \
        port["latency_fast"]["refusal_cap_history"]
    assert any(4 in a for a in want["actions"])
    for key in ("refusal_cap_history", "actions", "budgets",
                "latency_events", "retries", "faulted", "latency"):
        assert got[key] == want[key], key
    assert got == want


# -- (e) the real-time open loop -------------------------------------------

def test_realtime_open_loop_pumps_in_lockstep(ref, tmp_path, capfd):
    ranks = W.run_world(W.clock_open_loop, 2, tmp_path, "dp=2", ref["np"],
                        OPEN_LOOP["n_requests"], OPEN_LOOP["rate"],
                        OPEN_LOOP["deadline_ms"],
                        timeout=W.CLOCK_WORLD_TIMEOUT_S)
    err = capfd.readouterr().err
    for msg in ("terminate called", "SIGABRT", "Traceback"):
        assert msg not in err, err[-2000:]
    a, b = ranks
    assert len(a["handles"]) == OPEN_LOOP["n_requests"]
    assert a["report"]["completed"] == OPEN_LOOP["n_requests"]
    assert a["handles"] == b["handles"]
    assert a["report"] == b["report"]
    assert a["pumps"] == b["pumps"] > 0
    assert not a["alive"] and not b["alive"]
