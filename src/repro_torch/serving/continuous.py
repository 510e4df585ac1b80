"""Continuous-batching serving: a device-agnostic host scheduler over a
pluggable device executor.

The engine is split into two layers:

* **Host scheduler** (this module, pure numpy — no torch import): request
  queue, admission grouping, slot ownership, host mirrors of the tiny
  control arrays, and harvest of finished generations.  It talks to the
  device exclusively through the executor protocol (``admit`` /
  ``decode_chunk`` / ``sync_control`` / ``fetch_outputs``), so it can be
  unit-tested with a pure numpy fake executor.
* **Device executor** (:mod:`repro_torch.serving.executor`): prefill,
  insert+commit and the K-step decode chunk over the once-per-lifetime
  slot cache — dense rows, or (``paged=True``) a page pool with block
  tables, whose host-side allocator and prefix cache
  (:class:`~repro_torch.serving.paged.PagePool`) the engine owns.

With an armed :class:`~repro_torch.serving.faults.ChaosInjector`
(``chaos=``) the executor is wrapped in a
:class:`~repro_torch.serving.faults.ChaosExecutor` fault seam; unarmed,
nothing is installed.  With a ``mesh`` (:func:`repro_torch.launch.mesh.
make_serving_mesh`) the executor is a
:class:`~repro_torch.serving.executor.ShardedExecutor`: every process
of the mesh runs this scheduler on the same inputs, and the clock is
one of them, so the engine reads the mesh's agreed clock (rank 0's
reading on every rank, ``ServingMesh.agreed_clock``): a deadline that
expires on one rank expires on all of them.

**Prefill/decode overlap.**  Executor calls are async dispatch; the
scheduler exploits that by dispatching the decode chunk for resident
slots FIRST, then planning and dispatching the next admission groups'
prefills while that chunk is in flight, and only then blocking on the
control-array sync.  Admission therefore no longer stalls the decode
stream: the prefill program (which touches only the scratch cache)
overlaps with the chunk, and the insert/commit serializes behind it via
its data dependency on the slot cache.  Newly admitted slots join the
next chunk — greedy outputs are row-independent, so outputs are
token-identical to the serial schedule.

**Admission grouping.**  Up to ``prefill_batch`` queued prompts with
the same padded length prefill as one dispatch (JetStream's batched
prefill->insert pattern).  Grouping scans a bounded
``admission_lookahead`` window of the queue, so one odd-length prompt
at the head no longer degrades batched prefill to singletons
(head-of-line blocking); skipped prompts keep their relative order.  A
paged engine also groups by the previewed prefix-hit depth ``p0``, so
a group prefills one uniform suffix.

Greedy semantics match the padded engine exactly: prefill emits the
first token (argmax of the last prompt logit), decode feeds the
previous token back, and a request stops after emitting EOS or
``max_new_tokens`` tokens.  ``prefill_pad_multiple`` right-pads prompts
to a length bucket with PAD tokens that attend — the same quirk as the
padded engine's right-padded buckets — trading exactness-of-trace-count
for numerics; the default (1) prefills at the exact prompt length.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Sequence, Set

import numpy as np

from repro_torch.core.errors import TransientFaultError
from repro_torch.data.tokenizer import PAD
from repro_torch.obs import NULL_TRACER
from repro_torch.serving.paged import PagePlan, PagePool


@dataclass
class SlotRequest:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    # engine-clock instant after which the request is worthless; 0 = no
    # deadline.  Enforced mid-stream: a resident slot past its deadline
    # is cancelled and freed at the next control sync.
    deadline_at: float = 0.0


@dataclass
class CompletedGeneration:
    rid: int
    tokens: np.ndarray        # (n,) generated tokens, incl. EOS if emitted
    n_steps: int              # == len(tokens)
    prompt_len: int
    finished_at: float = 0.0  # engine clock at harvest (latency)
    # engine clock when the prefill was dispatched — the prefill emits
    # the request's first token, so this is the time-to-first-token
    # stamp open-loop serving reports against per-request deadlines
    admitted_at: float = 0.0
    failed: str = ""          # non-empty: not served (reason)
    # failed on a retryable fault (quarantined slot, executor fault) —
    # the gateway may resubmit within the request's deadline
    transient: bool = False
    # cancelled mid-stream because its deadline passed (distinct from
    # transient: retrying a timed-out request cannot help)
    timed_out: bool = False


@dataclass
class EngineStats:
    n_admitted: int = 0
    n_completed: int = 0
    n_rejected: int = 0       # refused at submit (over-length / empty)
    n_prefills: int = 0
    n_decode_chunks: int = 0
    n_decode_steps: int = 0
    cache_allocations: int = 0
    max_concurrent: int = 0
    # fault-tolerance counters (all zero on a healthy run)
    n_quarantined: int = 0    # slots pulled from service (nan + watchdog)
    n_nan_trips: int = 0      # quarantines from device NaN/inf detection
    n_watchdog_trips: int = 0  # quarantines from the no-progress watchdog
    n_exec_faults: int = 0    # executor admit/decode calls that raised
    n_requeued: int = 0       # faulted requests re-admitted by the engine
    n_timed_out: int = 0      # requests cancelled past their deadline
    # paged-KV-cache counters (all zero on dense engines)
    n_deferred_admissions: int = 0   # page pool exhausted -> retried later
    n_pages_evicted: int = 0         # prefix-cache LRU evictions
    n_cow_forks: int = 0             # mid-page suffix copy-on-write forks
    prefill_tokens_avoided: int = 0  # prompt tokens served from shared pages
    prompt_tokens_total: int = 0     # all admitted (padded) prompt tokens
    # recent per-admission concurrency trace (bounded) — lets tests
    # assert requests from different action buckets were in flight
    # together without growing in long serving runs
    concurrency_trace: Deque[int] = field(
        default_factory=lambda: deque(maxlen=512))


class ContinuousEngine:
    """Slot-based continuous-batching greedy decoder (host scheduler).

    Construct either from ``(model, params)`` — which builds a
    :class:`~repro_torch.serving.executor.SingleDeviceExecutor` on the
    params' device, or a :class:`~repro_torch.serving.executor.
    ShardedExecutor` when ``mesh`` is given — or from an explicit
    ``executor`` (any object implementing the executor protocol).  An armed ``chaos`` injector
    wraps the executor in a
    :class:`~repro_torch.serving.faults.ChaosExecutor`.
    """

    # telemetry: the Gateway's tracer lands here via the backend's
    # install_tracer (engine decode-chunk / prefill-dispatch spans);
    # the default is the zero-overhead no-op
    tracer = NULL_TRACER

    def __init__(self, model=None, params=None, *, num_slots: int = 8,
                 max_len: int = 512, max_new_cap: int = 64,
                 sync_every: int = 4, prefill_pad_multiple: int = 1,
                 prefill_batch: int = 1, admission_lookahead: int = 16,
                 mla_absorb: bool = False, mesh=None, executor=None,
                 clock=None,
                 watchdog_syncs: int = 8, max_requeues: int = 0,
                 chaos=None, paged: bool = False, page_size: int = 16,
                 num_pages: Optional[int] = None,
                 prefix_sharing: bool = True, metrics=None):
        if executor is None:
            if model is None:
                raise ValueError("ContinuousEngine needs model+params or "
                                 "an explicit executor")
            from repro_torch.serving.executor import (ShardedExecutor,
                                                      SingleDeviceExecutor)
            kw = dict(num_slots=num_slots, max_len=max_len,
                      max_new_cap=max_new_cap, sync_every=sync_every,
                      prefill_batch=prefill_batch, mla_absorb=mla_absorb,
                      paged=paged, page_size=page_size, num_pages=num_pages,
                      metrics=metrics)
            executor = (ShardedExecutor(model, params, mesh=mesh, **kw)
                        if mesh is not None
                        else SingleDeviceExecutor(model, params, **kw))
        # the serving mesh the executor runs on (None: one device)
        self.mesh = mesh if mesh is not None else getattr(executor, "mesh",
                                                          None)
        if chaos is not None and getattr(chaos, "armed", False):
            from repro_torch.serving.faults import ChaosExecutor
            executor = ChaosExecutor(executor, chaos)
        self.executor = executor
        self.model = model
        # the weights the executor holds: a sharded executor's own shards
        # (so the engine keeps no whole copy alive beside them)
        self.params = getattr(executor, "params", params)
        self.num_slots = executor.num_slots
        self.max_len = executor.max_len
        self.max_new_cap = executor.max_new_cap
        self.sync_every = executor.sync_every
        self.prefill_batch = executor.prefill_batch
        self.prefill_pad_multiple = max(1, prefill_pad_multiple)
        self.admission_lookahead = max(0, admission_lookahead)
        # timestamp source for admitted_at / finished_at.  Injectable so
        # the open-loop traffic harness can drive the engine on a
        # virtual clock (deterministic latency accounting); default is
        # the host monotonic clock.  On a mesh every read is rank 0's
        # (deadlines expire on every rank at once); the reference's one
        # controller has one clock.
        self._clock = clock if clock is not None else time.perf_counter
        if self.mesh is not None:
            self._clock = self.mesh.agreed_clock(self._clock)
        # watchdog: quarantine a slot after this many consecutive syncs
        # with an active slot making zero token progress (0 = off)
        self.watchdog_syncs = max(0, watchdog_syncs)
        # how many times a faulted (quarantined / executor-fault)
        # request is re-admitted before failing as transient (0 = fail
        # immediately; the gateway layer owns deadline-aware retries)
        self.max_requeues = max(0, max_requeues)
        self.stats = EngineStats()
        self.stats.cache_allocations = executor.cache_allocations

        # paged KV cache: host-side allocator + prefix cache mirroring
        # the executor's device page pool.  `_slot_plan[s]` holds the
        # resident request's PagePlan (its page references) until the
        # slot is released on harvest / quarantine / expiry / abort.
        self._pages = None
        self._slot_plan: List[Optional[PagePlan]] = [None] * self.num_slots
        if getattr(executor, "paged", False):
            self._pages = PagePool(
                executor.num_pages, executor.page_size,
                partitions=getattr(executor, "page_partitions", 1),
                prefix_sharing=prefix_sharing)

        S = self.num_slots
        # host mirrors of the device control arrays (refreshed at sync)
        self._active = np.zeros(S, bool)
        self._gen = np.zeros(S, np.int32)
        self._plen = np.zeros(S, np.int32)
        self._rid: List[Optional[int]] = [None] * S
        # the resident request per slot (needed to requeue on fault and
        # to enforce its deadline mid-stream)
        self._slot_req: List[Optional[SlotRequest]] = [None] * S
        # slots admitted since the last sync: their host mirrors are
        # stale, so harvest must not touch them until the next sync
        self._dirty: Set[int] = set()
        # poisoned slots pulled from service — never re-admitted until
        # reset_quarantine() clears their fault flags
        self._quarantined: Set[int] = set()
        self._stall = np.zeros(S, np.int32)      # consecutive no-progress
        self._last_gen = np.full(S, -1, np.int32)  # -1 = just admitted
        self._requeues: Dict[int, int] = {}
        self._free: Deque[int] = deque(range(S))
        self._queue: Deque[SlotRequest] = deque()
        self._results: Dict[int, CompletedGeneration] = {}
        self._admitted_at: Dict[int, float] = {}
        self._auto_rid = 0
        self._bound_registries: Set[int] = set()
        if metrics is not None:
            self.bind_metrics(metrics)

    def bind_metrics(self, registry) -> None:
        """Register :class:`EngineStats` (and the page pool, when
        paged) as scrape-time views over ``registry``.  Idempotent per
        registry so the Gateway's bind and a constructor-passed
        registry don't double-register the names."""
        if id(registry) in self._bound_registries:
            return
        self._bound_registries.add(id(registry))
        fields = ("n_admitted", "n_completed", "n_rejected", "n_prefills",
                  "n_decode_chunks", "n_decode_steps", "n_quarantined",
                  "n_nan_trips", "n_watchdog_trips", "n_exec_faults",
                  "n_requeued", "n_timed_out", "n_deferred_admissions",
                  "n_pages_evicted", "n_cow_forks",
                  "prefill_tokens_avoided", "prompt_tokens_total")
        counters = {f: registry.counter(f"engine_{f}_total")
                    for f in fields}
        concur_g = registry.gauge("engine_concurrent_slots",
                                  "resident requests right now")
        max_concur_g = registry.gauge("engine_max_concurrent",
                                      "peak resident requests")
        queue_g = registry.gauge("engine_queue_depth",
                                 "requests queued for admission")

        def scrape() -> None:
            st = self.stats
            for f, inst in counters.items():
                inst.set_total(getattr(st, f))
            concur_g.set(self.n_resident)
            max_concur_g.set(st.max_concurrent)
            queue_g.set(len(self._queue))

        registry.register_collector(scrape)
        if self._pages is not None:
            self._pages.bind_metrics(registry)

    # -- submission ----------------------------------------------------

    def reserve_rid(self) -> int:
        """Fresh request id, unique for this engine's lifetime."""
        rid = self._auto_rid
        self._auto_rid += 1
        return rid

    def submit(self, rid: int, prompt: Sequence[int],
               max_new_tokens: int = 16, *, strict: bool = True,
               deadline_at: float = 0.0) -> bool:
        """Enqueue one request.  Returns True when accepted.

        An over-length prompt (padded length + generation budget beyond
        ``max_len``) or an empty prompt cannot be admitted.  With
        ``strict=True`` (default) that raises ``ValueError``; with
        ``strict=False`` the request is rejected PER-REQUEST instead:
        it completes immediately as a failed :class:`CompletedGeneration`
        (``failed`` holds the reason) returned by the next ``run()``,
        and the rest of the stream — other requests' resident slots
        included — keeps serving.  The serving Gateway uses the
        non-strict path so one long prompt in a routed batch can't kill
        the whole micro-batch mid-flight.
        """
        reason = ""
        plen = len(prompt)
        if not prompt:
            reason = "empty prompt"
        else:
            max_new = min(max_new_tokens, self.max_new_cap)
            plen = self._padded_len(len(prompt))
            if plen + max_new > self.max_len:
                reason = (f"prompt len {plen} + max_new {max_new} exceeds "
                          f"max_len {self.max_len}")
        if reason:
            if strict:
                raise ValueError(reason)
            self.stats.n_rejected += 1
            now = self._clock()
            self._results[rid] = CompletedGeneration(
                rid=rid, tokens=np.zeros(0, np.int32), n_steps=0,
                prompt_len=plen, finished_at=now, admitted_at=now,
                failed=reason)
            return False
        self._queue.append(SlotRequest(rid, list(prompt), max_new,
                                       deadline_at=deadline_at))
        return True

    def _padded_len(self, n: int) -> int:
        m = self.prefill_pad_multiple
        return ((n + m - 1) // m) * m

    # -- admission planning --------------------------------------------

    def _partition(self, slot: int) -> int:
        """Page-pool partition owning ``slot``'s pages: slots and pages
        both shard contiguously over the mesh data axis (one partition
        on a single device)."""
        return slot * self._pages.partitions // self.num_slots

    def _preview_p0(self, req: SlotRequest, slot: int, plen: int) -> int:
        row = list(req.prompt) + [PAD] * (plen - len(req.prompt))
        return self._pages.preview_hit_tokens(row, self._partition(slot))

    def _next_group(self) -> List[SlotRequest]:
        """Pop the next admission group off the queue: the head plus up
        to ``prefill_batch - 1`` more prompts with the same padded
        length from a bounded lookahead window (skipped prompts keep
        their relative queue order).  A paged engine additionally
        requires the same previewed prefix-hit depth ``p0`` — the whole
        group prefills one uniform suffix ``[p0, plen)`` — previewing
        each candidate against the partition of the free slot it would
        actually receive (members take free slots in deque order)."""
        cap = min(self.prefill_batch, len(self._free))
        head = self._queue.popleft()
        group = [head]
        if cap > 1 and self.admission_lookahead > 0:
            plen = self._padded_len(len(head.prompt))
            head_p0 = (self._preview_p0(head, self._free[0], plen)
                       if self._pages is not None else 0)
            picked: List[int] = []
            for i in range(min(len(self._queue), self.admission_lookahead)):
                if 1 + len(picked) >= cap:
                    break
                req = self._queue[i]
                if self._padded_len(len(req.prompt)) != plen:
                    continue
                if (self._pages is not None and self._preview_p0(
                        req, self._free[1 + len(picked)], plen) != head_p0):
                    continue
                picked.append(i)
            group += [self._queue[i] for i in picked]
            for i in reversed(picked):
                del self._queue[i]
        return group

    def _plan_group(self, toks: np.ndarray, group: List[SlotRequest],
                    slots: List[int]) -> Optional[List[PagePlan]]:
        """Reserve pages for every row of an admission group.  Returns
        the plans, or ``None`` — with every reserved reference released
        — when the pool cannot serve the group (back-pressure) or an
        eviction during planning changed a later row's hit depth (the
        deferred group re-previews consistently on the next step)."""
        plans: List[PagePlan] = []
        p0: Optional[int] = None
        for row, req, slot in zip(toks, group, slots):
            pl = self._pages.plan([int(t) for t in row],
                                  int(req.max_new_tokens),
                                  self._partition(slot))
            if pl is None or (p0 is not None and pl.p0 != p0):
                if pl is not None:
                    self._pages.release(pl)
                for q in plans:
                    self._pages.release(q)
                return None
            p0 = pl.p0
            plans.append(pl)
        return plans

    def _dispatch_paged(self, toks: np.ndarray, slot_idx: np.ndarray,
                        limits: np.ndarray, plans: List[PagePlan]) -> None:
        """Build the device-side admission arrays from the plans and
        dispatch the gather + suffix-prefill + paged commit."""
        ex = self.executor
        PB = self.prefill_batch
        MB, MBs, NP = ex.max_blocks, ex.mb_scratch, ex.num_pages
        p0 = plans[0].p0
        tables = np.zeros((PB, MB), np.int32)
        wmask = np.zeros((PB, MBs), bool)
        gsrc = np.full((PB, MBs), NP, np.int32)
        pos0 = np.zeros(PB, np.int32)
        for i, pl in enumerate(plans):
            tables[i, :len(pl.pages)] = pl.pages
            wm = pl.write_mask[:MBs]
            wmask[i, :len(wm)] = wm
            gsrc[i, :len(pl.gather_src)] = pl.gather_src
            pos0[i] = pl.p0
        ex.admit_paged(np.ascontiguousarray(toks[:, p0:]), slot_idx,
                       limits, pos0, tables, wmask, gsrc)

    def _start_admissions(self) -> None:
        """Dispatch prefill+insert for every admittable group — async,
        no host sync; the admitted slots stay ``dirty`` until the next
        control sync reveals their device state.

        A transient executor fault on ``admit`` fails (or requeues)
        only that group's requests, returns its slots to the free pool,
        and stops admitting for this step — the decode stream and the
        rest of the queue keep serving."""
        PB = self.prefill_batch
        while self._free and self._queue:
            group = self._next_group()
            slots = [self._free.popleft() for _ in group]
            plen = self._padded_len(len(group[0].prompt))
            toks = np.full((PB, plen), PAD, np.int32)
            for i, req in enumerate(group):
                toks[i, :len(req.prompt)] = req.prompt
            # unused scratch rows scatter to index num_slots -> dropped
            slot_idx = np.full(PB, self.num_slots, np.int32)
            slot_idx[:len(group)] = slots
            limits = np.zeros(PB, np.int32)
            limits[:len(group)] = [req.max_new_tokens for req in group]
            plans = None
            if self._pages is not None:
                plans = self._plan_group(toks, group, slots)
                if plans is None:
                    # pool exhausted (or plan/preview divergence): put
                    # the group back and retry after decode frees pages
                    for slot in reversed(slots):
                        self._free.appendleft(slot)
                    for req in reversed(group):
                        self._queue.appendleft(req)
                    self.stats.n_deferred_admissions += 1
                    break
            t_adm0 = self.tracer.now()
            try:
                if plans is not None:
                    self._dispatch_paged(toks, slot_idx, limits, plans)
                else:
                    self.executor.admit(toks, slot_idx, limits)
            except TransientFaultError as exc:
                self.stats.n_exec_faults += 1
                if plans is not None:
                    for pl in plans:
                        self._pages.release(pl)
                for slot in reversed(slots):
                    self._free.appendleft(slot)
                for req in reversed(group):
                    self._fail_or_requeue(req, f"admit fault: {exc}",
                                          prompt_len=plen)
                break
            if plans is not None:
                # register AFTER the successful dispatch: pages become
                # sharable only once the commit that fills them is in
                # stream order (same-group twins never share)
                for slot, pl in zip(slots, plans):
                    self._pages.commit(pl)
                    self._slot_plan[slot] = pl
                self.stats.prefill_tokens_avoided += plans[0].p0 * len(group)
                self.stats.prompt_tokens_total += plen * len(group)
                self.stats.n_cow_forks = self._pages.n_cow_forks
                self.stats.n_pages_evicted = self._pages.n_evicted
            self.stats.n_prefills += 1
            self.tracer.engine_span("prefill_dispatch", t_adm0,
                                    self.tracer.now(), n=len(group),
                                    plen=int(plen))
            now = self._clock()
            for req, slot in zip(group, slots):
                self.stats.n_admitted += 1
                self._rid[slot] = req.rid
                self._slot_req[slot] = req
                self._plen[slot] = plen
                self._admitted_at[req.rid] = now
                self._dirty.add(slot)
                self._stall[slot] = 0
                self._last_gen[slot] = -1
            n_live = sum(r is not None for r in self._rid)
            self.stats.concurrency_trace.append(n_live)
            self.stats.max_concurrent = max(self.stats.max_concurrent,
                                            n_live)

    # -- sync + harvest ------------------------------------------------

    def _sync(self) -> None:
        self._active, self._gen = self.executor.sync_control()
        self._dirty.clear()

    def _harvest(self) -> None:
        done_slots = [s for s in range(self.num_slots)
                      if self._rid[s] is not None and not self._active[s]
                      and s not in self._dirty]
        if not done_slots:
            return
        # fetch the output buffer only when something actually finished
        out = self.executor.fetch_outputs()
        now = self._clock()
        for slot in done_slots:
            n = int(self._gen[slot])
            rid = self._rid[slot]
            self._results[rid] = CompletedGeneration(
                rid=rid, tokens=out[slot, :n].copy(),
                n_steps=n, prompt_len=int(self._plen[slot]),
                finished_at=now,
                admitted_at=self._admitted_at.pop(rid, now))
            self.stats.n_completed += 1
            self._requeues.pop(rid, None)
            self._rid[slot] = None
            self._slot_req[slot] = None
            self._release_slot_pages(slot)
            self._free.append(slot)

    # -- fault tolerance -----------------------------------------------

    def _release_slot_pages(self, slot: int) -> None:
        """Drop a released slot's page references (paged engines only).
        Safe at harvest/quarantine/expiry: any queued work that could
        read the pages was enqueued before the commit that may later
        overwrite them, and an idle slot's decode write parks at a
        sentinel position past its block table."""
        if self._pages is None:
            return
        pl = self._slot_plan[slot]
        if pl is not None:
            self._pages.release(pl)
            self._slot_plan[slot] = None

    def _fail_or_requeue(self, req: SlotRequest, reason: str, *,
                         prompt_len: int = 0) -> None:
        """A request hit a transient fault: put it back at the queue
        head (up to ``max_requeues`` times) or complete it failed with
        ``transient=True`` so the gateway's retry path can take over."""
        self._admitted_at.pop(req.rid, None)
        if self._requeues.get(req.rid, 0) < self.max_requeues:
            self._requeues[req.rid] = self._requeues.get(req.rid, 0) + 1
            self.stats.n_requeued += 1
            self._queue.appendleft(req)
            return
        self._requeues.pop(req.rid, None)
        now = self._clock()
        self._results[req.rid] = CompletedGeneration(
            rid=req.rid, tokens=np.zeros(0, np.int32), n_steps=0,
            prompt_len=prompt_len or self._padded_len(len(req.prompt)),
            finished_at=now, admitted_at=now, failed=reason,
            transient=True)

    def _quarantine(self, slot: int, reason: str) -> None:
        """Pull a poisoned slot from service: deactivate it on device,
        fail/requeue ONLY its request, and keep the slot out of the
        free pool until :meth:`reset_quarantine` — its peers in the
        batch keep decoding untouched."""
        self._quarantined.add(slot)
        self.stats.n_quarantined += 1
        deact = getattr(self.executor, "deactivate", None)
        if deact is not None:
            deact([slot])
        self._active[slot] = False
        req = self._slot_req[slot]
        self._rid[slot] = None
        self._slot_req[slot] = None
        self._release_slot_pages(slot)
        if req is not None:
            self._fail_or_requeue(req, reason)

    def _check_health(self) -> None:
        """Post-sync health pass: device-detected NaN/inf poison flags,
        then the no-progress watchdog.  Runs BEFORE harvest so a
        poisoned slot (deactivated on device by the executor) is
        quarantined rather than harvested as a normal completion."""
        sf = getattr(self.executor, "slot_faults", None)
        if sf is not None:
            bad = sf()
            if bad is not None:
                for s in np.flatnonzero(bad):
                    s = int(s)
                    if (self._rid[s] is not None and s not in self._dirty
                            and s not in self._quarantined):
                        self.stats.n_nan_trips += 1
                        self._quarantine(s, "nan/inf decode logits")
        if self.watchdog_syncs <= 0:
            return
        for s in range(self.num_slots):
            if (self._rid[s] is None or s in self._dirty
                    or not self._active[s]):
                continue
            if self._last_gen[s] >= 0 and self._gen[s] == self._last_gen[s]:
                self._stall[s] += 1
                if self._stall[s] >= self.watchdog_syncs:
                    self.stats.n_watchdog_trips += 1
                    self._quarantine(s, "watchdog: no token progress")
                    continue
            else:
                self._stall[s] = 0
            self._last_gen[s] = self._gen[s]

    def _expire_residents(self) -> None:
        """Cancel resident requests whose deadline has passed: the slot
        is deactivated and freed immediately (a slow generation cannot
        hold a slot past its SLO) and the request completes as a
        distinct timed-out failure.  Queued requests past deadline are
        timed out before wasting a prefill."""
        now = self._clock()
        expired = [s for s in range(self.num_slots)
                   if self._slot_req[s] is not None and s not in self._dirty
                   and s not in self._quarantined
                   and 0 < self._slot_req[s].deadline_at < now]
        if expired:
            deact = getattr(self.executor, "deactivate", None)
            if deact is not None:
                deact(expired)
        for s in expired:
            req = self._slot_req[s]
            self._time_out(req, admitted_at=self._admitted_at.pop(
                req.rid, now))
            self._active[s] = False
            self._rid[s] = None
            self._slot_req[s] = None
            self._release_slot_pages(s)
            self._free.append(s)
        if self._queue:
            keep = deque()
            for req in self._queue:
                if 0 < req.deadline_at < now:
                    self._time_out(req, admitted_at=now)
                else:
                    keep.append(req)
            self._queue = keep

    def _time_out(self, req: SlotRequest, *, admitted_at: float) -> None:
        self.stats.n_timed_out += 1
        self._requeues.pop(req.rid, None)
        self._results[req.rid] = CompletedGeneration(
            rid=req.rid, tokens=np.zeros(0, np.int32), n_steps=0,
            prompt_len=self._padded_len(len(req.prompt)),
            finished_at=self._clock(), admitted_at=admitted_at,
            failed="deadline exceeded", timed_out=True)

    def _abort_residents(self, reason: str) -> None:
        """A decode chunk raised: every resident request aborts (requeue
        or transient failure), slots return to the free pool, and the
        serving loop stays alive."""
        slots = [s for s in range(self.num_slots)
                 if self._rid[s] is not None]
        deact = getattr(self.executor, "deactivate", None)
        if deact is not None and slots:
            deact(slots)
        for s in slots:
            req = self._slot_req[s]
            self._rid[s] = None
            self._slot_req[s] = None
            self._active[s] = False
            self._stall[s] = 0
            self._last_gen[s] = -1
            self._release_slot_pages(s)
            self._free.append(s)
            if req is not None:
                self._fail_or_requeue(req, reason)
        self._dirty.clear()

    @property
    def quarantined_slots(self) -> Set[int]:
        return set(self._quarantined)

    def reset_quarantine(self) -> List[int]:
        """Return quarantined slots to service (operator/bench action
        after the underlying fault clears): fault flags are reset on
        the device and the slots rejoin the free pool."""
        slots = sorted(self._quarantined)
        if not slots:
            return []
        clear = getattr(self.executor, "clear_slot_faults", None)
        if clear is not None:
            clear(slots)
        for s in slots:
            self._stall[s] = 0
            self._last_gen[s] = -1
            self._free.append(s)
        self._quarantined.clear()
        return slots

    # -- driver --------------------------------------------------------

    @property
    def has_work(self) -> bool:
        """Queued or slot-resident requests exist (rejected/finished
        results awaiting a ``poll``/``run`` don't count as work)."""
        return bool(self._queue) or any(r is not None for r in self._rid)

    @property
    def n_queued(self) -> int:
        return len(self._queue)

    @property
    def n_resident(self) -> int:
        return sum(r is not None for r in self._rid)

    def step(self) -> None:
        """ONE scheduling iteration: harvest, then either a decode
        chunk (with the next admission groups' prefills overlapped) or,
        with no resident work, just admissions.  This is ``run()``'s
        loop body split out so an always-on serving thread can
        interleave engine progress with new submissions instead of
        draining to empty.

        Fault handling: a transient executor fault on the decode chunk
        aborts (requeues or fails) the resident requests and returns —
        the loop survives and keeps admitting.  After every control
        sync a health pass quarantines poisoned slots (device NaN/inf
        flags, no-progress watchdog) and a deadline pass cancels
        expired requests, both BEFORE harvest."""
        self._harvest()
        if self._active.any():
            # decode chunk first (async), then overlap the next
            # admission groups' prefills with it; block only at the
            # control sync
            tr = self.tracer
            t_chunk0 = tr.now()
            try:
                self.executor.decode_chunk()
            except TransientFaultError as exc:
                self.stats.n_exec_faults += 1
                self._abort_residents(f"decode fault: {exc}")
                return
            self.stats.n_decode_chunks += 1
            self.stats.n_decode_steps += self.sync_every
            self._start_admissions()
            self._sync()
            # dispatch→post-sync wall of this K-step chunk (the prefills
            # overlapped above render as nested engine-track spans)
            tr.engine_span("decode_chunk", t_chunk0, tr.now(),
                           steps=self.sync_every)
            self._check_health()
            self._expire_residents()
            self._harvest()
        else:
            self._start_admissions()
            if self._dirty:
                self._sync()
                self._check_health()
                self._expire_residents()
                self._harvest()
            elif self._queue:
                self._expire_residents()
                if not self._free and self.n_resident == 0:
                    # every slot is quarantined: nothing can ever be
                    # admitted — fail the queue transiently rather than
                    # spinning forever (callers see resolved requests)
                    while self._queue:
                        req = self._queue.popleft()
                        now = self._clock()
                        self._requeues.pop(req.rid, None)
                        self._results[req.rid] = CompletedGeneration(
                            rid=req.rid, tokens=np.zeros(0, np.int32),
                            n_steps=0,
                            prompt_len=self._padded_len(len(req.prompt)),
                            finished_at=now, admitted_at=now,
                            failed="all slots quarantined",
                            transient=True)

    def poll(self) -> Dict[int, CompletedGeneration]:
        """Advance the engine by one ``step`` (when it has work) and
        return every request completed since the last ``poll``/``run``
        — including submit-time rejections.  Never blocks waiting for
        the stream to drain: the open-loop serving thread calls this
        between submission bursts."""
        if self.has_work:
            self.step()
        done, self._results = self._results, {}
        return done

    def run(self) -> Dict[int, CompletedGeneration]:
        """Drain the queue; returns {rid: CompletedGeneration} for every
        request completed since the last call."""
        while self.has_work:
            self.step()
        done, self._results = self._results, {}
        return done

    def generate_many(self, prompts: Sequence[Sequence[int]],
                      max_new_tokens: int = 16) -> List[CompletedGeneration]:
        """Batch convenience API (aligned with `prompts` order)."""
        rids = [self.reserve_rid() for _ in prompts]
        for rid, p in zip(rids, prompts):
            self.submit(rid, p, max_new_tokens)
        done = self.run()
        return [done[rid] for rid in rids]
