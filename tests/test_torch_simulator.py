"""The simulator testbed of the port against the reference.

The calibrated generator (``generation/simulator.py``), the RAG pipeline
(``serving/pipeline.py::RAGPipeline``), the simulator backend and its
stream protocol (``routing/backends.py``), and the offline action-sweep
log (``core/offline_log.py``), each run on the same inputs in both
packages.  Everything here is host code (stdlib and numpy), so every
comparison is exact: outcomes, sweeps, stream completions, log arrays,
reward matrices and saved files are identical.
"""
import dataclasses
import itertools

import numpy as np
import pytest

from repro.core.actions import SLO_PROFILES as REF_PROFILES
from repro.core.config import RouterConfig as RefRouterConfig
from repro.core.config import TestbedConfig as RefTestbedConfig
from repro.core.offline_log import OfflineLog as RefLog
from repro.core.offline_log import build_testbed as ref_build_testbed
from repro.data.synthetic_squad import SyntheticSquad as RefSquad
from repro.data.tokenizer import HashTokenizer as RefTokenizer
from repro.generation.simulator import SimulatedGenerator as RefGenerator
from repro.retrieval.bm25 import BM25Index as RefBM25
from repro.retrieval.dense import DenseIndex as RefDense
from repro.retrieval.hybrid import build_retriever_suite as ref_suite
from repro.routing import FixedPolicy as RefFixed
from repro.routing import Gateway as RefGateway
from repro.routing import Request as RefRequest
from repro.routing import SimulatorBackend as RefSimBackend
from repro.routing import get_action_space as ref_space
from repro.serving.pipeline import RAGPipeline as RefPipeline
from repro_torch.core.actions import SLO_PROFILES
from repro_torch.core.config import RouterConfig, TestbedConfig
from repro_torch.core.offline_log import OfflineLog, build_testbed
from repro_torch.data import HashTokenizer, SyntheticSquad
from repro_torch.generation import SimulatedGenerator
from repro_torch.retrieval import (BM25Index, DenseIndex,
                                   build_retriever_suite)
from repro_torch.routing import (FixedPolicy, Gateway, Request,
                                 SimulatorBackend, as_backend,
                                 get_action_space)
from repro_torch.serving.pipeline import RAGPipeline

LOG_ARRAYS = ("states", "correct", "refused", "hallucinated", "cost", "hit",
              "answerable", "qids")
SMALL = dict(n_train=40, n_eval=20, n_paragraphs=60)


@pytest.fixture(scope="module")
def pipelines():
    """The same 60-paragraph corpus in both packages, each with the bm25
    pipeline (paper5) and the full retriever suite (hybrid9)."""
    ref_data = RefSquad(n_paragraphs=60, n_questions=24, seed=1)
    data = SyntheticSquad(n_paragraphs=60, n_questions=24, seed=1)
    texts = [p.text for p in data.paragraphs]
    assert texts == [p.text for p in ref_data.paragraphs]
    ref_index, index = RefBM25.build(texts), BM25Index.build(texts)
    ref_gen = RefGenerator(RefTokenizer(32768), seed=1)
    gen = SimulatedGenerator(HashTokenizer(32768), seed=1)
    return {
        "data": (ref_data, data), "index": (ref_index, index),
        "paper5": (RefPipeline(ref_index, ref_gen),
                   RAGPipeline(index, gen)),
        "hybrid9": (RefPipeline(ref_index, ref_gen, ref_suite(
                        ref_index, RefDense.build(texts))),
                    RAGPipeline(index, gen, build_retriever_suite(
                        index, DenseIndex.build(texts)))),
    }


def test_simulated_generator_outcomes_identical():
    ref = {s: RefGenerator(RefTokenizer(32768), seed=s) for s in (0, 7)}
    port = {s: SimulatedGenerator(HashTokenizer(32768), seed=s)
            for s in (0, 7)}
    passages = [["the answer is 1912 in paris", "nothing here"],
                ["nothing here"], []]
    grid = itertools.product((0, 7), range(0, 60, 7), range(9),
                             ("guarded", "auto"), (True, False),
                             ("1912", None), range(len(passages)))
    n = 0
    for seed, qid, action, mode, answerable, gold, pi in grid:
        kw = dict(answerable=answerable, gold_answer=gold)
        q = f"when did question {qid} happen ?"
        want = ref[seed].generate(qid, action, mode, q, passages[pi], **kw)
        got = port[seed].generate(qid, action, mode, q, passages[pi], **kw)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.cost_tokens == want.cost_tokens
        n += 1
    for seed, qid in itertools.product((0, 7), range(5)):
        assert dataclasses.asdict(port[seed].refuse(qid, "who ?")) == \
            dataclasses.asdict(ref[seed].refuse(qid, "who ?"))
    assert n == 2 * 9 * 9 * 2 * 2 * 2 * 3


@pytest.mark.parametrize("space", ["paper5", "hybrid9"])
def test_pipeline_sweep_identical(pipelines, space):
    (ref_pipe, pipe) = pipelines[space]
    ref_data, data = pipelines["data"]
    for rq, q in zip(ref_data.questions, data.questions):
        want = [o.to_row() for o in ref_pipe.sweep(rq, ref_space(space))]
        got = [o.to_row() for o in pipe.sweep(q, get_action_space(space))]
        assert got == want
    assert len(want) == len(get_action_space(space))
    # the default space is paper5
    assert [o.to_row() for o in pipe.sweep(data.questions[0])] == \
        [o.to_row() for o in ref_pipe.sweep(ref_data.questions[0])]


def test_pipeline_retrieve_identical(pipelines):
    ref_pipe, pipe = pipelines["hybrid9"]
    ref_data, data = pipelines["data"]
    for rq, q in zip(ref_data.questions[:6], data.questions[:6]):
        for name, k in itertools.product(("bm25", "dense", "hybrid"),
                                         (0, 2, 5)):
            assert pipe.retrieve(q.text, k, name) == \
                ref_pipe.retrieve(rq.text, k, name)
            assert pipe.retrieve_degradable(q.text, k, name) == \
                ref_pipe.retrieve_degradable(rq.text, k, name)
    with pytest.raises(KeyError, match="not configured"):
        pipelines["paper5"][1].retrieve("who ?", 2, "dense")
    with pytest.raises(KeyError, match="not configured"):
        pipelines["paper5"][1].retrieve_degradable("who ?", 2, "dense")


def _fake_clock():
    ticks = itertools.count()
    return lambda: 0.25 * next(ticks)


def test_simulator_backend_stream_identical(pipelines):
    """Submissions and polls interleaved under a fake clock: every
    immediate outcome, rid, backlog and completion (with its stamps) is
    the reference's."""
    ref_pipe, pipe = pipelines["paper5"]
    ref_data, data = pipelines["data"]
    ref_b = RefSimBackend(ref_pipe, stream_slots=3, service_polls=2,
                          clock=_fake_clock())
    b = SimulatorBackend(pipe, stream_slots=3, service_polls=2,
                         clock=_fake_clock())
    ref_space5, space5 = ref_space(), get_action_space()

    def completions(done):
        return [(c.rid, c.outcome.to_row(), c.admitted_at, c.finished_at)
                for c in done]

    n_done = 0
    for i, (rq, q) in enumerate(zip(ref_data.questions, data.questions)):
        a = (i * 3) % 5
        rid_w, out_w = ref_b.stream_submit(rq, ref_space5[a])
        rid, out = b.stream_submit(q, space5[a], deadline_at=1.0)
        assert rid == rid_w
        assert (out is None) == (out_w is None)
        if out is not None:
            assert out.to_row() == out_w.to_row() and out.refused
        assert b.stream_backlog == ref_b.stream_backlog
        if i % 3 == 2:
            got, want = b.stream_poll(), ref_b.stream_poll()
            assert completions(got) == completions(want)
            n_done += len(got)
    while ref_b.stream_backlog:
        got, want = b.stream_poll(), ref_b.stream_poll()
        assert completions(got) == completions(want)
        n_done += len(got)
    assert b.stream_backlog == 0 and n_done > 0
    assert b.execute_batch(data.questions[:3], space5[1])[0].to_row() == \
        ref_b.execute_batch(ref_data.questions[:3], ref_space5[1])[0].to_row()


def test_as_backend_and_gateway_over_a_raw_pipeline(pipelines):
    ref_pipe, pipe = pipelines["paper5"]
    ref_data, data = pipelines["data"]
    ref_index, index = pipelines["index"]
    backend = as_backend(pipe)
    assert isinstance(backend, SimulatorBackend) and backend.pipeline is pipe
    assert as_backend(backend) is backend
    assert backend.index is index and backend.retrieval_cache is None
    gw = Gateway(FixedPolicy(1), pipe, router_cfg=RouterConfig(),
                 adaptive_refusal=False)
    assert isinstance(gw.backend, SimulatorBackend)
    ref_gw = RefGateway(RefFixed(1), ref_pipe, router_cfg=RefRouterConfig(),
                        adaptive_refusal=False)
    st = gw.serve([Request(qid=q.qid, question=q, slo="cheap")
                   for q in data.questions])
    ref_st = ref_gw.serve([RefRequest(qid=q.qid, question=q, slo="cheap")
                           for q in ref_data.questions])
    assert st.served == ref_st.served == len(data.questions)
    assert dict(st.action_counts) == dict(ref_st.action_counts)
    assert st.total_reward == ref_st.total_reward
    assert gw.refusal_share == ref_gw.refusal_share


@pytest.fixture(scope="module")
def testbeds():
    """The paper5 testbed at the SMOKE sizes and a hybrid9 one, built by
    both packages."""
    cfg = dict(n_train=120, n_eval=60, n_paragraphs=120)
    return {
        "paper5": (ref_build_testbed(RefTestbedConfig(**cfg)),
                   build_testbed(TestbedConfig(**cfg))),
        "hybrid9": (ref_build_testbed(RefTestbedConfig(**SMALL),
                                      ref_space("hybrid9")),
                    build_testbed(TestbedConfig(**SMALL),
                                  get_action_space("hybrid9"))),
    }


@pytest.mark.parametrize("space", ["paper5", "hybrid9"])
def test_build_testbed_logs_identical(testbeds, space):
    ref, port = testbeds[space]
    assert [p.text for p in port[0].paragraphs] == \
        [p.text for p in ref[0].paragraphs]
    assert np.array_equal(port[1].tf, ref[1].tf)
    for ref_log, log in zip(ref[3:], port[3:]):
        assert isinstance(log, OfflineLog)
        for k in LOG_ARRAYS:
            got, want = getattr(log, k), getattr(ref_log, k)
            assert got.dtype == want.dtype and np.array_equal(got, want), k
        assert log.refuse_action == ref_log.refuse_action
        assert log.n == ref_log.n and log.n_actions == ref_log.n_actions
        for name in ("quality_first", "cheap"):
            got = log.rewards(SLO_PROFILES[name])
            want = ref_log.rewards(REF_PROFILES[name])
            assert got.dtype == want.dtype and np.array_equal(got, want)
    assert port[3].n_actions == len(get_action_space(space))
    idx = np.arange(0, port[3].n, 3)
    sub, ref_sub = port[3].subset(idx), ref[3].subset(idx)
    for k in LOG_ARRAYS:
        assert np.array_equal(getattr(sub, k), getattr(ref_sub, k))
    assert sub.refuse_action == ref_sub.refuse_action


def _assert_logs_equal(a, b):
    for k in LOG_ARRAYS:
        assert np.array_equal(getattr(a, k), getattr(b, k)), k
    assert a.refuse_action == b.refuse_action


def test_log_save_load_round_trips(testbeds, tmp_path):
    (ref, port) = testbeds["paper5"]
    log, ref_log = port[4], ref[4]
    log.save(tmp_path / "port.npz")
    _assert_logs_equal(OfflineLog.load(tmp_path / "port.npz"), log)
    _assert_logs_equal(RefLog.load(tmp_path / "port.npz"), ref_log)
    # a file the reference saved loads in the port
    ref_log.save(tmp_path / "ref.npz")
    _assert_logs_equal(OfflineLog.load(tmp_path / "ref.npz"), log)
    # no refuse action: saved as -1, loaded as None, in both packages
    none = dataclasses.replace(log, refuse_action=None)
    none.save(tmp_path / "none.npz")
    assert int(np.load(tmp_path / "none.npz")["refuse_action"]) == -1
    assert OfflineLog.load(tmp_path / "none.npz").refuse_action is None
    assert RefLog.load(tmp_path / "none.npz").refuse_action is None
    # a file without the key is a paper5 log: refuse at 4
    np.savez_compressed(tmp_path / "legacy.npz",
                        **{k: getattr(log, k) for k in LOG_ARRAYS})
    legacy = OfflineLog.load(tmp_path / "legacy.npz")
    assert legacy.refuse_action == 4
    _assert_logs_equal(legacy, dataclasses.replace(log, refuse_action=4))
    # hybrid9's refuse action (8) survives the round trip
    h = testbeds["hybrid9"][1][3]
    h.save(tmp_path / "h9.npz")
    assert OfflineLog.load(tmp_path / "h9.npz").refuse_action == \
        get_action_space("hybrid9").refuse_action == 8
