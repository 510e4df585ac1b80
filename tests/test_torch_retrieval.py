"""The retrieval plane of the port against the reference.

Dense retrieval (``retrieval/dense.py``), fusion, the shared LRU, the
circuit breakers and the bm25 fallback (``retrieval/hybrid.py``), and
their wiring into the engine backend, each run on the same inputs in
both packages: the embedding is bitwise the same, ids and fused scores
identical, cache counters, breaker state walks and fallback outcomes
identical, and ``hybrid9`` served through both packages'
``ContinuousEngineBackend`` on qwen SMOKE float32 gives identical
routed actions, answers, rewards and ``GatewayStats``.
"""
import torch_threads  # noqa: F401  (caps torch's threads under xdist)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.core.errors as ref_errors
import repro.retrieval.hybrid as ref_hybrid
import repro_torch.core.errors as port_errors
import repro_torch.retrieval.hybrid as port_hybrid
from repro.configs import get_config as ref_config
from repro.core.config import RetrievalConfig as RefRetrievalConfig
from repro.core.config import RouterConfig as RefRouterConfig
from repro.data.synthetic_squad import SyntheticSquad as RefSquad
from repro.data.tokenizer import HashTokenizer as RefTokenizer
from repro.models import build_model as ref_build
from repro.obs import MetricsRegistry as RefRegistry
from repro.obs import Tracer as RefTracer
from repro.retrieval.bm25 import BM25Index as RefBM25
from repro.retrieval.dense import DenseIndex as RefDense
from repro.retrieval.dense import embed_text as ref_embed
from repro.routing import ContinuousEngineBackend as RefBackend
from repro.routing import FixedPolicy as RefFixed
from repro.routing import Gateway as RefGateway
from repro.routing import Request as RefRequest
from repro.routing import get_action_space as ref_space
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core.config import RetrievalConfig, RouterConfig
from repro_torch.data import HashTokenizer, SyntheticSquad
from repro_torch.models import build_model
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.retrieval import BM25Index, DenseIndex, embed_text
from repro_torch.routing import (ContinuousEngineBackend, FixedPolicy,
                                 Gateway, Request, get_action_space)

RCFG = dict(vocab_hash_dim=1024, dense_embed_dim=128)
TOL = 1e-5
PACKAGES = {"reference": (ref_hybrid, ref_errors),
            "port": (port_hybrid, port_errors)}


@pytest.fixture(scope="module")
def corpus():
    ref_data = RefSquad(n_paragraphs=128, n_questions=16, seed=2)
    data = SyntheticSquad(n_paragraphs=128, n_questions=16, seed=2)
    texts = [p.text for p in data.paragraphs]
    assert texts == [p.text for p in ref_data.paragraphs]
    rcfg, cfg = RefRetrievalConfig(**RCFG), RetrievalConfig(**RCFG)
    return dict(
        questions=[q.text for q in data.questions], texts=texts,
        ref=(RefBM25.build(texts, rcfg), RefDense.build(texts, rcfg)),
        port=(BM25Index.build(texts, cfg), DenseIndex.build(texts, cfg)))


# ---------------------------------------------------------------------------
# dense index
# ---------------------------------------------------------------------------


def test_embedding_bitwise_equal(corpus):
    odd = ["", "a", "A a a", "the the the", "?!.,;", "naïve café über",
           "x" * 500, " ".join(f"w{i}" for i in range(300)),
           "river0001 of the length val123 is"]
    for text in corpus["texts"] + corpus["questions"] + odd:
        for dim in (128, 256, 96):
            got, want = embed_text(text, dim), ref_embed(text, dim)
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)


def test_dense_index_emb_and_topk_identical(corpus):
    ref, port = corpus["ref"][1], corpus["port"][1]
    np.testing.assert_array_equal(port.emb, ref.emb)
    assert port.emb.dtype == np.float32
    for qtext in corpus["questions"]:
        for k in (0, 1, 5, 10, 200):
            ids, s = port.topk(qtext, k)
            want_ids, want_s = ref.topk(qtext, k)
            np.testing.assert_array_equal(ids, want_ids)
            np.testing.assert_array_equal(s, want_s)


def test_topk_batch_matches_the_reference_kernel_path(corpus):
    ref, port = corpus["ref"][1], corpus["port"][1]
    for k in (1, 10, 200):
        ids, s = port.topk_batch(corpus["questions"], k, device="cpu")
        want_ids, want_s = ref.topk_batch(corpus["questions"], k)
        assert ids.dtype == np.int64 and s.dtype == np.float32
        np.testing.assert_array_equal(ids, want_ids)
        np.testing.assert_allclose(s, want_s, rtol=TOL, atol=TOL)
    # and the host path, question by question, at the reference test's
    # depth (deeper, 1-ulp near-ties between the numpy and the batched
    # sums swap neighbours in the reference as well)
    ids, _ = port.topk_batch(corpus["questions"], 10, device="cpu")
    for qi, qtext in enumerate(corpus["questions"]):
        np.testing.assert_array_equal(ids[qi], port.topk(qtext, 10)[0])
    assert port.device_emb("cpu") is port.device_emb("cpu")   # one copy


def test_empty_dense_index():
    port = DenseIndex.build([], RetrievalConfig(**RCFG))
    ref = RefDense.build([], RefRetrievalConfig(**RCFG))
    np.testing.assert_array_equal(port.emb, ref.emb)
    assert port.emb.shape == (0, 128)
    ids, s = port.topk_batch(["any question"], 5, device="cpu")
    assert ids.shape == s.shape == (1, 0)


# ---------------------------------------------------------------------------
# fusion and the cache
# ---------------------------------------------------------------------------


def _suite(mod, indexes, **kw):
    return mod.build_retriever_suite(*indexes, **kw)


@pytest.mark.parametrize("method", ["rrf", "weighted"])
def test_hybrid_fusion_identical(corpus, method):
    ref = _suite(ref_hybrid, corpus["ref"], method=method)["hybrid"]
    port = _suite(port_hybrid, corpus["port"], method=method)["hybrid"]
    assert port.method == method and port.weights == ref.weights
    for qtext in corpus["questions"]:
        for k in (0, 2, 5, 10):
            ids, s = port.topk(qtext, k)
            want_ids, want_s = ref.topk(qtext, k)
            np.testing.assert_array_equal(ids, want_ids)
            np.testing.assert_array_equal(s, want_s)
            assert port.passages(qtext, k) == ref.passages(qtext, k)
            assert (np.diff(s) <= 1e-9).all() and len(set(ids)) == len(ids)


def test_weighted_fusion_alpha_and_ties(corpus):
    """Weighted fusion at other bm25 weights (all dense, mixed, all
    bm25) ranks identically, fused-score ties to the lower id."""
    for alpha in (0.0, 0.3, 1.0):
        ref = _suite(ref_hybrid, corpus["ref"], method="weighted",
                     alpha=alpha)["hybrid"]
        port = _suite(port_hybrid, corpus["port"], method="weighted",
                      alpha=alpha)["hybrid"]
        for qtext in corpus["questions"][:6]:
            for got, want in zip(port.topk(qtext, 7), ref.topk(qtext, 7)):
                np.testing.assert_array_equal(got, want)


def _cache_walk(mod, bm25):
    cache = mod.RetrievalCache(maxsize=2)
    r = mod.CachedRetriever(mod.IndexRetriever("bm25", bm25), cache)
    log = []
    for query, k in [("the length of the river", 3),
                     ("the length of the river", 3),
                     ("the founder of the empire", 3),
                     ("the founder of the empire", 5),
                     ("the length of the river", 3)]:
        log.append((r.passages(query, k), cache.hits, cache.lookups,
                    len(cache)))
    log.append([tuple(map(list, r.topk("the river", 4)))
                for _ in range(2)] + [cache.hits, cache.lookups])
    return log, list(cache._d)


def test_retrieval_cache_lru_and_counters_identical(corpus):
    got, keys = _cache_walk(port_hybrid, corpus["port"][0])
    want, ref_keys = _cache_walk(ref_hybrid, corpus["ref"][0])
    assert got == want and keys == ref_keys
    # maxsize 2 evicts the least recently used entry: river@3 missed
    # again after two newer keys (the reference test's counts)
    assert [row[1:] for row in got[:5]] == [(0, 1, 1), (1, 2, 1),
                                            (1, 3, 2), (1, 4, 2), (1, 5, 2)]


def test_one_shared_cache_over_the_suite(corpus):
    out = {}
    for name, mod, idx in (("ref", ref_hybrid, corpus["ref"]),
                           ("port", port_hybrid, corpus["port"])):
        wrapped, cache = mod.resolve_retrievers(_suite(mod, idx), idx[0],
                                                cache_size=8)
        seq = [wrapped[n].passages("the river", 2)
               for n in ("bm25", "dense", "hybrid", "dense")]
        out[name] = (seq, cache.hits, cache.lookups, sorted(wrapped),
                     sorted(mod.collect_breakers(wrapped)))
    assert out["port"] == out["ref"]
    assert out["port"][1:3] == (1, 4)


# ---------------------------------------------------------------------------
# circuit breakers
# ---------------------------------------------------------------------------


def _breaker_walk(mod, seed, clock_mode):
    rng = np.random.default_rng(seed)
    t = [0.0]
    kw = dict(window=8, min_calls=4, failure_threshold=0.5, cooldown=3,
              half_open_probes=2)
    if clock_mode:
        kw.update(clock=lambda: t[0], cooldown_s=2.5)
    b = mod.CircuitBreaker(**kw)
    trace = []
    for _ in range(400):
        t[0] += float(rng.choice([0.0, 0.25, 1.0]))
        allowed = b.allow()
        probed = b.state
        if allowed:
            (b.record_failure if rng.random() < 0.45
             else b.record_success)()
        elif rng.random() < 0.02:
            b.reset()
        trace.append((allowed, probed, b.state, b.n_trips, b.n_denied,
                      b.failure_rate()))
    return trace


@pytest.mark.parametrize("clock_mode", [False, True],
                         ids=["call-count", "clock"])
@pytest.mark.parametrize("seed", [0, 3, 11])
def test_breaker_walks_the_same_states(seed, clock_mode):
    got = _breaker_walk(port_hybrid, seed, clock_mode)
    assert got == _breaker_walk(ref_hybrid, seed, clock_mode)
    assert {s for _, s, *_ in got} == {"closed", "open", "half_open"}
    assert got[-1][3] > 0                        # it tripped


def test_breaker_validation_identical():
    for kw in (dict(clock=lambda: 0.0), dict(cooldown_s=1.0),
               dict(clock=lambda: 0.0, cooldown_s=0.0)):
        with pytest.raises(ValueError) as want:
            ref_hybrid.CircuitBreaker(**kw)
        with pytest.raises(ValueError) as got:
            port_hybrid.CircuitBreaker(**kw)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# fallback and cache guard on a flaky stub index (test_faults.py's idiom)
# ---------------------------------------------------------------------------


class FlakyIndex:
    """Index stub whose topk raises while ``broken``."""

    def __init__(self, texts, error):
        self.texts = texts
        self.error = error
        self.broken = False
        self.calls = 0

    def topk(self, query, k):
        self.calls += 1
        if self.broken:
            raise self.error(f"flaky down ({query!r})")
        ids = np.arange(min(k, len(self.texts)))
        return ids, np.ones(len(ids), np.float32)


def _flaky_suite(mod, errors, cache_size=8):
    texts = [f"passage {i}" for i in range(6)]
    flaky = FlakyIndex(texts, errors.TransientFaultError)
    retrievers = {"bm25": mod.IndexRetriever(
                      "bm25", FlakyIndex(texts, errors.TransientFaultError)),
                  "dense": mod.IndexRetriever("dense", flaky)}
    wrapped, cache = mod.resolve_retrievers(
        retrievers, None, cache_size=cache_size,
        breaker_kw=dict(window=4, min_calls=2, failure_threshold=0.5,
                        cooldown=2))
    return wrapped, cache, flaky


def _on_both(scenario):
    out = {name: scenario(*pkg) for name, pkg in PACKAGES.items()}
    assert out["port"] == out["reference"]
    return out["port"]


def test_fallback_degrades_and_trips_breaker():
    def scenario(mod, errors):
        wrapped, _, flaky = _flaky_suite(mod, errors)
        flaky.broken = True
        first = [mod.retrieve_with_fallback(wrapped, "dense", f"q{i}", 2)
                 for i in range(2)]
        brk = mod.collect_breakers(wrapped)["dense"]
        calls = flaky.calls
        ps, degraded = mod.retrieve_with_fallback(wrapped, "dense",
                                                  "q-open", 2)
        return (first, brk.state, brk.n_trips, ps, degraded,
                flaky.calls - calls, brk.n_denied)
    first, state, trips, _, degraded, new_calls, denied = _on_both(scenario)
    assert all(d and len(ps) == 2 for ps, d in first)
    assert (state, trips, degraded, new_calls) == ("open", 1, True, 0)
    assert denied >= 1


def test_failed_lookup_never_cached_fallback_under_own_key():
    def scenario(mod, errors):
        wrapped, cache, flaky = _flaky_suite(mod, errors)
        flaky.broken = True
        mod.retrieve_with_fallback(wrapped, "dense", "q0", 2)
        keys = list(cache._d)
        flaky.broken = False
        for i in range(8):
            mod.retrieve_with_fallback(wrapped, "dense", f"r{i}", 2)
        state = mod.collect_breakers(wrapped)["dense"].state
        _, degraded = mod.retrieve_with_fallback(wrapped, "dense", "fresh",
                                                 2)
        return keys, state, degraded, list(cache._d)
    keys, state, degraded, later = _on_both(scenario)
    assert all(k[1] != "dense" for k in keys)
    assert any(k[1] == "bm25" for k in keys)
    assert state == "closed" and not degraded
    assert any(k[1] == "dense" for k in later)


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_fallback_missing_or_self_raises_transient(pkg):
    mod, errors = PACKAGES[pkg]
    wrapped, _, flaky = _flaky_suite(mod, errors, cache_size=0)
    flaky.broken = True
    for fallback in ("dense", "nope"):
        with pytest.raises(errors.TransientFaultError):
            mod.retrieve_with_fallback(wrapped, "dense", "q", 2,
                                       fallback=fallback)


def test_retrieval_cache_hits_bypass_open_breaker():
    def scenario(mod, errors):
        wrapped, _, flaky = _flaky_suite(mod, errors)
        warm = wrapped["dense"].passages("warm", 2)
        flaky.broken = True
        raised = []
        for i in range(3):
            try:
                wrapped["dense"].passages(f"cold{i}", 2)
            except errors.TransientFaultError as exc:
                raised.append(type(exc).__name__)
        return (warm, raised, mod.collect_breakers(wrapped)["dense"].state,
                wrapped["dense"].passages("warm", 2))
    warm, raised, state, again = _on_both(scenario)
    # the failure trips the breaker (min_calls 2, rate 1/2); the next
    # call is refused, the one after is the half-open probe, and fails
    assert raised == ["TransientFaultError", "CircuitOpenError",
                      "TransientFaultError"]
    assert state == "open" and again == warm


def test_fallback_notes_and_metrics_identical():
    """The retrieval span noted for the gateway and the retrieval-plane
    metrics (cache counters, breaker trips / denials / state) read the
    same in both packages' ``obs``."""
    def scenario(mod, errors, tracer, registry):
        wrapped, cache, flaky = _flaky_suite(mod, errors)
        mod.bind_retrieval_metrics(registry, mod.collect_breakers(wrapped),
                                   cache)
        mod.retrieve_with_fallback(wrapped, "dense", "ok", 2, tracer=tracer)
        flaky.broken = True
        for i in range(3):
            mod.retrieve_with_fallback(wrapped, "dense", f"q{i}", 2,
                                       tracer=tracer)
        notes = [(sp.name, sp.attrs) for sp in tracer._pending]
        return notes, registry.exposition()
    clock = lambda: 0.0
    got = scenario(port_hybrid, port_errors, Tracer(clock),
                   MetricsRegistry(clock))
    want = scenario(ref_hybrid, ref_errors, RefTracer(clock),
                    RefRegistry(clock))
    assert got == want
    assert got[0][-1] == ("retrieval", dict(retriever="dense", k=2,
                                            degraded=True, fallback="bm25"))
    assert "breaker_dense_open 1" in got[1]


# ---------------------------------------------------------------------------
# the engine backend and Gateway.serve under hybrid9
# ---------------------------------------------------------------------------

ENGINE = dict(num_slots=4, max_prompt_len=96, max_new_tokens=4,
              prefill_batch=2)


@pytest.fixture(scope="module")
def served():
    ref_data = RefSquad(n_paragraphs=100, n_questions=20, seed=0)
    data = SyntheticSquad(n_paragraphs=100, n_questions=20, seed=0)
    texts = [p.text for p in data.paragraphs]
    rcfg, cfg = RefRetrievalConfig(**RCFG), RetrievalConfig(**RCFG)
    rindex, tindex = RefBM25.build(texts, rcfg), BM25Index.build(texts, cfg)
    rm = ref_build(dataclasses.replace(ref_config("qwen1.5-32b", "smoke"),
                                       dtype="float32"))
    tc = dataclasses.replace(get_config("qwen1.5-32b", "smoke"),
                             dtype="float32")
    np_params = jax.tree_util.tree_map(np.asarray,
                                       rm.init(jax.random.PRNGKey(0)))
    ref_backend = RefBackend.create(
        rm, jax.tree_util.tree_map(jnp.asarray, np_params),
        RefTokenizer(tc.vocab_size), rindex,
        retrievers=ref_hybrid.build_retriever_suite(
            rindex, RefDense.build(texts, rcfg)),
        retrieval_cache_size=32, **ENGINE)
    port_backend = ContinuousEngineBackend.create(
        build_model(tc), params_from_numpy(np_params, device="cpu"),
        HashTokenizer(tc.vocab_size), tindex,
        retrievers=port_hybrid.build_retriever_suite(
            tindex, DenseIndex.build(texts, cfg)),
        retrieval_cache_size=32, **ENGINE)
    runs = {}
    for name, gw_cls, req_cls, fixed, backend, index, qs, space, router in (
            ("ref", RefGateway, RefRequest, RefFixed, ref_backend, rindex,
             ref_data.questions, ref_space("hybrid9"),
             RefRouterConfig(n_actions=9)),
            ("port", Gateway, Request, FixedPolicy, port_backend, tindex,
             data.questions, get_action_space("hybrid9"),
             RouterConfig(n_actions=9))):
        rows, stats = [], []
        for idx in (3, 7, 8):      # dense, hybrid, refuse
            gw = gw_cls(fixed(idx), backend, router_cfg=router, index=index,
                        action_space=space,
                        on_outcome=lambda r, a, o, rew: rows.append(
                            (r.qid, a.idx, a.retriever, o.answer,
                             o.cost_tokens, o.refused, o.hallucinated,
                             o.hit, o.degraded, rew)))
            st = gw.serve([req_cls(qid=q.qid, question=q)
                           for q in qs[:3] * 2])     # repeats: cache hits
            stats.append(st)
        runs[name] = (rows, stats, backend)
    return runs


def test_hybrid9_gateway_serves_identically(served):
    (rrows, rstats, rb), (trows, tstats, tb) = served["ref"], served["port"]
    assert trows == rrows
    for idx, rst, tst in zip((3, 7, 8), rstats, tstats):
        assert dict(tst.action_counts) == dict(rst.action_counts) == \
            {idx: 6}
        for f in ("served", "rejected", "degraded", "faulted",
                  "retrieval_cache_hits", "retrieval_cache_lookups",
                  "total_reward", "avg_reward", "refusal_cap_history"):
            assert getattr(tst, f) == getattr(rst, f), f
    assert tstats[-1].retrieval_cache_hits > 0
    assert tstats[-1].degraded == 0
    assert tb.retrieval_cache.hits == rb.retrieval_cache.hits
    assert sorted(tb.breakers) == sorted(rb.breakers) == \
        ["bm25", "dense", "hybrid"]


def test_backend_turns_a_dead_retrieval_path_into_a_transient_outcome():
    """A retriever that fails with no working fallback makes THAT
    request a transient outcome; the rest of the micro-batch serves."""
    texts = [f"passage {i}" for i in range(6)]
    out = {}
    for name, (mod, errors) in PACKAGES.items():
        flaky = FlakyIndex(texts, errors.TransientFaultError)
        flaky.broken = True
        backend = (RefBackend if name == "reference"
                   else ContinuousEngineBackend)(
            _NoEngine(), None, None,
            retrievers={"bm25": mod.IndexRetriever("bm25", flaky)})
        space = (ref_space if name == "reference" else get_action_space)()
        qs = (RefSquad if name == "reference" else SyntheticSquad)(
            n_paragraphs=4, n_questions=2, seed=0).questions
        outs = backend.execute_mixed(qs, [space[0], space[4]])
        out[name] = [(o.transient, o.refused, o.answer) for o in outs]
    assert out["port"] == out["reference"]
    # the retriever's own transient error, re-raised as it was
    assert out["port"][0][0] and out["port"][0][2].startswith(
        "<transient fault: flaky down")
    assert not out["port"][1][0] and out["port"][1][1]


class _NoEngine:
    """Stands in for an engine no request reaches."""


def test_bm25_host_scores_identical_across_repeats():
    """The host BM25 (``topk``, ``score_stats``, ``cooccurrence_stats``)
    keeps its (D, V) saturation and the last query's scores: queries
    repeated, interleaved and new give the reference's numbers bit for
    bit, and ``scores_np`` stays a fresh array per call."""
    data = SyntheticSquad(n_paragraphs=96, n_questions=12, seed=5)
    texts = [p.text for p in data.paragraphs]
    cfg = dict(vocab_hash_dim=512)
    ref = RefBM25.build(texts, RefRetrievalConfig(**cfg))
    idx = BM25Index.build(texts, RetrievalConfig(**cfg))
    qs = [q.text for q in data.questions]
    for query in [qs[0], qs[1], qs[0], qs[0], *qs[2:], qs[1]]:
        for k in (2, 5, 10):
            got, want = idx.topk(query, k), ref.topk(query, k)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(idx.score_stats(query),
                                      ref.score_stats(query))
        np.testing.assert_array_equal(idx.cooccurrence_stats(query),
                                      ref.cooccurrence_stats(query))
    qv = idx.query_vector(qs[3])
    a, b = idx.scores_np(qv), idx.scores_np(qv)
    assert a is not b
    np.testing.assert_array_equal(a, ref.scores_np(qv))
