"""The Retriever protocol, hybrid fusion, and the serving-side cache.

Everything that executes a routed action's retrieval step goes through
one protocol: ``topk(query, k) -> (ids, scores)`` plus
``passages(query, k) -> texts``.  ``EngineBackend._prep`` consumes it,
and ``Action.retriever`` names which registered retriever an action
uses — retriever choice is a routing action, the same cost/quality
lever as depth ("Cost-Aware Query Routing in RAG").

* :class:`IndexRetriever` — adapts any index with ``topk`` + ``texts``
  (:class:`~repro_torch.retrieval.bm25.BM25Index`,
  :class:`~repro_torch.retrieval.dense.DenseIndex`);
* :class:`HybridRetriever` — weighted / reciprocal-rank fusion of two
  or more candidate sets, deterministic (ties break by doc id);
* :class:`RetrievalCache` + :class:`CachedRetriever` — a bounded LRU
  keyed by (query, retriever, k) in front of any retriever; repeated
  queries in a serving stream stop re-scoring the whole corpus, and
  hit counters surface in ``GatewayStats``;
* :class:`CircuitBreaker` + :class:`BreakerRetriever` — per-retriever
  closed → open → half-open breaker on a windowed failure rate, so a
  browning-out retriever is cut off instead of hammered, and
  :func:`retrieve_with_fallback` rewrites the lookup to a bm25
  fallback as a *degraded* outcome the gateway accounts separately.

Wrapping order (see :func:`resolve_retrievers`) is
``CachedRetriever(BreakerRetriever(raw))``: cache hits bypass open
breakers, failures propagate before ``cache.put`` so a
failed lookup is never cached, and fallback results are produced by a
*different* retriever so they land under the fallback's own cache key,
never the original (query, retriever, k) key.
"""
from __future__ import annotations

from collections import OrderedDict, deque
from typing import (Dict, List, Mapping, Optional, Protocol, Sequence,
                    Tuple, runtime_checkable)

import numpy as np

from repro_torch.core.errors import CircuitOpenError, TransientFaultError


@runtime_checkable
class Retriever(Protocol):
    """One named way to turn a query into ranked passages."""

    name: str

    def topk(self, query: str, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """(doc ids, scores), scores descending."""
        ...

    def passages(self, query: str, k: int) -> List[str]:
        """The top-k passage texts (what the prompt builder consumes)."""
        ...


class IndexRetriever:
    """Adapter over any index exposing ``topk(query, k)`` + ``texts``."""

    def __init__(self, name: str, index):
        self.name = name
        self.index = index

    def topk(self, query: str, k: int):
        return self.index.topk(query, k)

    def passages(self, query: str, k: int) -> List[str]:
        if k <= 0:
            return []
        idx, _ = self.index.topk(query, k)
        return [self.index.texts[i] for i in idx]


class HybridRetriever:
    """Fuse candidate sets from several retrievers into one ranking.

    Each sub-retriever contributes its top-``k * candidate_mult`` docs;
    fusion is either

    * ``rrf`` — reciprocal rank fusion, score(d) = Σ_r w_r / (c + rank)
      [Cormack et al. 2009]: rank-only, so BM25's unbounded scores and
      the dense retriever's cosines need no calibration; or
    * ``weighted`` — min-max normalize each candidate list's scores to
      [0, 1], then a weighted sum.

    Deterministic: fused ties break toward the lower doc id, and
    iteration order over sub-retrievers is fixed by construction.
    """

    def __init__(self, retrievers: Sequence[Retriever], texts: List[str],
                 *, name: str = "hybrid", method: str = "rrf",
                 weights: Optional[Sequence[float]] = None,
                 rrf_c: int = 60, candidate_mult: int = 2):
        if method not in ("rrf", "weighted"):
            raise ValueError(f"unknown fusion method {method!r}")
        self.name = name
        self.retrievers = list(retrievers)
        self.texts = texts
        self.method = method
        self.weights = (list(weights) if weights is not None
                        else [1.0] * len(self.retrievers))
        assert len(self.weights) == len(self.retrievers)
        self.rrf_c = rrf_c
        self.candidate_mult = candidate_mult

    def _fused(self, query: str, k: int) -> Dict[int, float]:
        depth = max(k * self.candidate_mult, k)
        fused: Dict[int, float] = {}
        for r, w in zip(self.retrievers, self.weights):
            ids, scores = r.topk(query, depth)
            if len(ids) == 0:
                continue
            if self.method == "rrf":
                contrib = [w / (self.rrf_c + rank + 1)
                           for rank in range(len(ids))]
            else:
                s = np.asarray(scores, np.float64)
                span = float(s.max() - s.min())
                norm = (s - s.min()) / span if span > 0 \
                    else np.ones_like(s)
                contrib = (w * norm).tolist()
            for d, c in zip(np.asarray(ids).tolist(), contrib):
                fused[int(d)] = fused.get(int(d), 0.0) + c
        return fused

    def topk(self, query: str, k: int):
        if k <= 0:
            return np.zeros(0, np.int64), np.zeros(0, np.float32)
        fused = self._fused(query, k)
        # sort by fused score desc, then doc id asc (deterministic)
        order = sorted(fused.items(), key=lambda kv: (-kv[1], kv[0]))[:k]
        ids = np.array([d for d, _ in order], np.int64)
        scores = np.array([s for _, s in order], np.float32)
        return ids, scores

    def passages(self, query: str, k: int) -> List[str]:
        idx, _ = self.topk(query, k)
        return [self.texts[i] for i in idx]


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------


class RetrievalCache:
    """Bounded LRU over retrieval results, shared across retrievers.

    Keys are ``(query, retriever_name, k)``; values are whatever the
    wrapped call returned (passage lists / topk tuples are immutable in
    practice — treat them as frozen).  ``hits``/``lookups`` feed
    ``GatewayStats.retrieval_cache_{hits,lookups}``.
    """

    def __init__(self, maxsize: int = 1024):
        assert maxsize > 0, maxsize
        self.maxsize = maxsize
        self._d: OrderedDict = OrderedDict()
        self.hits = 0
        self.lookups = 0

    def __len__(self) -> int:
        return len(self._d)

    def get(self, key):
        self.lookups += 1
        if key in self._d:
            self.hits += 1
            self._d.move_to_end(key)
            return self._d[key]
        return None

    def put(self, key, value) -> None:
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.maxsize:
            self._d.popitem(last=False)


class CachedRetriever:
    """LRU front for any :class:`Retriever` (keyed query × name × k)."""

    def __init__(self, inner: Retriever, cache: RetrievalCache):
        self.inner = inner
        self.name = inner.name
        self.cache = cache

    def topk(self, query: str, k: int):
        key = (query, self.name, k, "topk")
        out = self.cache.get(key)
        if out is None:
            out = self.inner.topk(query, k)
            self.cache.put(key, out)
        return out

    def passages(self, query: str, k: int) -> List[str]:
        key = (query, self.name, k, "passages")
        out = self.cache.get(key)
        if out is None:
            out = self.inner.passages(query, k)
            self.cache.put(key, out)
        return out


# ---------------------------------------------------------------------------
# Circuit breakers
# ---------------------------------------------------------------------------


class CircuitBreaker:
    """Closed → open → half-open breaker on a windowed failure rate.

    Deterministic by default and clock-free: the window is the last
    ``window`` *calls* (a bounded deque, so old outcomes age out), and
    the open-state cooldown is counted in *denied calls* rather than
    wall time — the same call sequence always walks the same state
    path, so a recorded call sequence replays exactly.

    Passing ``clock`` (a ``perf_counter``-style callable; a virtual
    clock keeps runs replayable) with
    ``cooldown_s`` switches the open→half-open transition to wall-clock
    pacing: a sparse caller no longer has to burn ``cooldown`` denied
    calls to reach a probe, and a hot caller cannot probe a still-down
    service early just by hammering it.  Runs stay replayable when the
    clock is virtual.  On a serving mesh the engine backend hands the
    breaker the mesh's agreed clock, so every rank's breaker cools on
    rank 0's reading and admits the same probes.

    * **closed** — calls flow; each outcome lands in the window.  When
      the window holds ≥ ``min_calls`` outcomes and the failure rate
      reaches ``failure_threshold``, the breaker trips open.
    * **open** — call-count mode: ``allow()`` refuses the next
      ``cooldown - 1`` calls; the ``cooldown``-th attempted call moves
      the breaker to half-open and becomes its first probe.  Clock
      mode: calls are refused until ``cooldown_s`` seconds after the
      trip; the first call at or past that instant is the probe.
    * **half-open** — up to ``half_open_probes`` trial calls pass; one
      success closes the breaker (window cleared — the service is
      deemed recovered), one failure reopens it.
    """

    def __init__(self, *, window: int = 32, failure_threshold: float = 0.5,
                 min_calls: int = 8, cooldown: int = 16,
                 half_open_probes: int = 1, clock=None,
                 cooldown_s: Optional[float] = None):
        assert window >= min_calls >= 1, (window, min_calls)
        assert 0.0 < failure_threshold <= 1.0, failure_threshold
        assert cooldown >= 1 and half_open_probes >= 1
        if (clock is None) != (cooldown_s is None):
            raise ValueError("clock and cooldown_s come together: both "
                             "set (wall-clock cooldown) or neither "
                             "(call-count cooldown)")
        if cooldown_s is not None and cooldown_s <= 0:
            raise ValueError(f"cooldown_s must be > 0, got {cooldown_s}")
        self.window = window
        self.failure_threshold = failure_threshold
        self.min_calls = min_calls
        self.cooldown = cooldown
        self.half_open_probes = half_open_probes
        self.clock = clock
        self.cooldown_s = cooldown_s
        self.state = "closed"
        self._events: deque = deque(maxlen=window)   # True = failure
        self._denied_since_open = 0
        self._opened_at = 0.0
        self._probes_out = 0
        self.n_trips = 0
        self.n_denied = 0

    def failure_rate(self) -> float:
        if not self._events:
            return 0.0
        return sum(self._events) / len(self._events)

    def allow(self) -> bool:
        """May a call proceed right now?  (Counts cooldown progress.)"""
        if self.state == "closed":
            return True
        if self.state == "open":
            if self.clock is not None:
                cooled = (self.clock() - self._opened_at
                          >= self.cooldown_s)
            else:
                self._denied_since_open += 1
                cooled = self._denied_since_open >= self.cooldown
            if cooled:
                self.state = "half_open"
                self._probes_out = 0
            else:
                self.n_denied += 1
                return False
        # half-open: admit a bounded number of probes
        if self._probes_out < self.half_open_probes:
            self._probes_out += 1
            return True
        self.n_denied += 1
        return False

    def record_success(self) -> None:
        if self.state == "half_open":
            self.state = "closed"
            self._events.clear()
            self._probes_out = 0
        elif self.state == "closed":
            self._events.append(False)

    def record_failure(self) -> None:
        if self.state == "half_open":
            self._trip()
        elif self.state == "closed":
            self._events.append(True)
            if (len(self._events) >= self.min_calls
                    and self.failure_rate() >= self.failure_threshold):
                self._trip()

    def _trip(self) -> None:
        self.state = "open"
        self.n_trips += 1
        self._denied_since_open = 0
        self._opened_at = self.clock() if self.clock is not None else 0.0
        self._probes_out = 0

    def reset(self) -> None:
        self.state = "closed"
        self._events.clear()
        self._denied_since_open = 0
        self._probes_out = 0


class BreakerRetriever:
    """Per-retriever breaker seam: refuses calls while the breaker is
    open (:class:`~repro_torch.core.errors.CircuitOpenError`) and records
    success/failure of every call that does pass."""

    def __init__(self, inner: Retriever,
                 breaker: Optional[CircuitBreaker] = None):
        self.inner = inner
        self.name = inner.name
        self.breaker = breaker if breaker is not None else CircuitBreaker()

    def _call(self, fn, *args):
        if not self.breaker.allow():
            raise CircuitOpenError(self.name)
        try:
            out = fn(*args)
        except Exception:
            self.breaker.record_failure()
            raise
        self.breaker.record_success()
        return out

    def topk(self, query: str, k: int):
        return self._call(self.inner.topk, query, k)

    def passages(self, query: str, k: int) -> List[str]:
        return self._call(self.inner.passages, query, k)


def collect_breakers(retrievers: Mapping[str, Retriever]
                     ) -> Dict[str, CircuitBreaker]:
    """Find the breaker for each named retriever by unwrapping the
    ``CachedRetriever(BreakerRetriever(...))`` chain (empty entries for
    retrievers without one)."""
    out: Dict[str, CircuitBreaker] = {}
    for name, r in retrievers.items():
        node = r
        while node is not None:
            brk = getattr(node, "breaker", None)
            if isinstance(brk, CircuitBreaker):
                out[name] = brk
                break
            node = getattr(node, "inner", None)
    return out


def retrieve_with_fallback(retrievers: Mapping[str, Retriever],
                           name: str, query: str, k: int, *,
                           fallback: str = "bm25", tracer=None
                           ) -> Tuple[List[str], bool]:
    """Fetch passages from ``name``, degrading to ``fallback`` when the
    primary fails (open breaker, injected fault, any exception).

    Returns ``(passages, degraded)``.  The fallback lookup goes through
    the fallback retriever's *own* wrapped entry, so its result is
    cached (if at all) under the fallback's key — never the primary's.
    If the primary *is* the fallback, or the fallback is missing or
    also fails, the original failure is re-raised wrapped as a
    :class:`~repro_torch.core.errors.TransientFaultError` for the
    gateway's retry path.

    ``tracer`` (a :class:`repro_torch.obs.Tracer`, or None/``NULL_TRACER``)
    records the lookup as an anonymous ``retrieval`` span — this layer
    doesn't know the request qid, so the gateway adopts the note onto
    the request it is submitting (see ``Tracer.note``/``adopt``).
    """
    primary = retrievers[name]
    t0 = tracer.now() if tracer is not None else 0.0
    try:
        passages = primary.passages(query, k)
    except Exception as exc:
        fb = retrievers.get(fallback)
        if fb is None or name == fallback:
            if tracer is not None:
                tracer.note("retrieval", t0, tracer.now(),
                            retriever=name, k=k, failed=True)
            if isinstance(exc, TransientFaultError):
                raise
            raise TransientFaultError(
                f"retriever {name!r} failed with no fallback: {exc}") from exc
        try:
            out = fb.passages(query, k), True
        except Exception as fb_exc:
            if tracer is not None:
                tracer.note("retrieval", t0, tracer.now(),
                            retriever=name, k=k, failed=True)
            raise TransientFaultError(
                f"retriever {name!r} and fallback {fallback!r} both "
                f"failed: {exc}; {fb_exc}") from fb_exc
        if tracer is not None:
            tracer.note("retrieval", t0, tracer.now(),
                        retriever=name, k=k, degraded=True,
                        fallback=fallback)
        return out
    if tracer is not None:
        tracer.note("retrieval", t0, tracer.now(), retriever=name, k=k)
    return passages, False


def bind_retrieval_metrics(registry, breakers: Mapping[str, CircuitBreaker],
                           cache: Optional[RetrievalCache]) -> None:
    """Register retrieval-plane stats (shared LRU hit counters, per-
    retriever breaker state/trips/denials) as scrape-time views over a
    :class:`repro_torch.obs.MetricsRegistry`."""
    insts = {}
    if cache is not None:
        insts["hits"] = registry.counter(
            "retrieval_cache_hits_total", "shared retrieval LRU hits")
        insts["lookups"] = registry.counter(
            "retrieval_cache_lookups_total",
            "shared retrieval LRU lookups")
    for bname in sorted(breakers):
        insts[f"trips_{bname}"] = registry.counter(
            f"breaker_{bname}_trips_total",
            f"circuit-breaker trips for retriever {bname}")
        insts[f"denied_{bname}"] = registry.counter(
            f"breaker_{bname}_denied_total",
            f"calls denied by the {bname} breaker")
        insts[f"open_{bname}"] = registry.gauge(
            f"breaker_{bname}_open",
            f"1 when the {bname} breaker is not closed")

    def scrape() -> None:
        if cache is not None:
            insts["hits"].set_total(cache.hits)
            insts["lookups"].set_total(cache.lookups)
        for bname, brk in breakers.items():
            insts[f"trips_{bname}"].set_total(brk.n_trips)
            insts[f"denied_{bname}"].set_total(brk.n_denied)
            insts[f"open_{bname}"].set(0.0 if brk.state == "closed"
                                       else 1.0)

    registry.register_collector(scrape)


# ---------------------------------------------------------------------------
# Construction helpers (used by the engine backends)
# ---------------------------------------------------------------------------


def build_retriever_suite(index, dense_index=None, *,
                          method: Optional[str] = None,
                          alpha: Optional[float] = None
                          ) -> Dict[str, Retriever]:
    """The standard named-retriever set over one corpus.

    ``bm25`` always; ``dense`` and ``hybrid`` (bm25 + dense fusion)
    when a :class:`~repro_torch.retrieval.dense.DenseIndex` is given.  Fusion
    method/weights default from the index's ``RetrievalConfig``.
    """
    bm25 = IndexRetriever("bm25", index)
    suite: Dict[str, Retriever] = {"bm25": bm25}
    if dense_index is not None:
        dense = IndexRetriever("dense", dense_index)
        cfg = getattr(dense_index, "cfg", None)
        method = method or getattr(cfg, "hybrid_method", "rrf")
        a = alpha if alpha is not None else getattr(cfg, "hybrid_alpha", 0.5)
        suite["dense"] = dense
        suite["hybrid"] = HybridRetriever(
            [bm25, dense], dense_index.texts, method=method,
            weights=[a, 1.0 - a])
    return suite


def resolve_retrievers(retrievers: Optional[Mapping[str, Retriever]],
                       index, *, cache_size: int = 0,
                       breakers: bool = True,
                       breaker_kw: Optional[Dict] = None,
                       chaos=None
                       ) -> Tuple[Dict[str, Retriever],
                                  Optional[RetrievalCache]]:
    """Normalize an executor's retriever config.

    ``retrievers=None`` gives the bm25-only default over ``index`` (the
    seed behaviour, bit-for-bit); ``cache_size > 0`` wraps every
    retriever behind ONE shared bounded LRU and returns it so serving
    stats can report hit rates.  ``breakers`` (default on — a closed
    breaker is a pass-through, so healthy behaviour is unchanged) adds
    a per-retriever :class:`CircuitBreaker` (``breaker_kw`` forwarded
    to each); ``chaos`` (a
    :class:`~repro_torch.serving.faults.ChaosInjector`) installs fault
    seams innermost, so injected failures trip breakers and never reach
    the cache.  Recover the breakers afterwards with
    :func:`collect_breakers`.
    """
    if retrievers is None:
        retrievers = {"bm25": IndexRetriever("bm25", index)}
    retrievers = dict(retrievers)
    if chaos is not None and getattr(chaos, "armed", False):
        from repro_torch.serving.faults import chaos_wrap_retrievers
        retrievers = chaos_wrap_retrievers(retrievers, chaos)
    if breakers:
        retrievers = {
            name: BreakerRetriever(r, CircuitBreaker(**(breaker_kw or {})))
            for name, r in retrievers.items()}
    cache = None
    if cache_size > 0:
        cache = RetrievalCache(cache_size)
        retrievers = {name: CachedRetriever(r, cache)
                      for name, r in retrievers.items()}
    return retrievers, cache
