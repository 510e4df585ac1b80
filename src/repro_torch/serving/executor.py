"""Device executor for the continuous engine: the dense slot cache or
the paged pool.

The host scheduler in :mod:`repro_torch.serving.continuous` is
device-agnostic: it plans admissions, tracks slot ownership, and
harvests finished requests — all in numpy.  Everything that touches
device buffers lives behind the executor protocol implemented here by
:class:`SingleDeviceExecutor`: the slot cache (dense per-slot rows, or
the global page pool + block tables) and the dense prefill scratch,
allocated once, plus prefill, insert+state-commit and the K-step decode
chunk; and by :class:`ShardedExecutor`, the same over a
``torch.distributed`` mesh of one process per card (slots and prefill
rows on ``pod`` x ``data``, params on ``model``).

PyTorch runs eagerly on the card's current stream: ``admit`` and
``decode_chunk`` enqueue their kernels and return without waiting, and
the host blocks only in ``sync_control`` / ``fetch_outputs`` /
``slot_faults``, whose device-to-host copies wait for the stream.  A
decode chunk issues its ``sync_every`` steps back to back with no host
sync in between: the done mask, the idle-slot hold, the output write and
the NaN latch are all tensor ops on the device.

Protocol (duck-typed, the reference's):

    admit(tokens (PB, plen) i32, slot_idx (PB,) i32, limits (PB,) i32)
        prefill the padded prompt rows, scatter them into their slots,
        and commit first-token / active / limit state.  Rows whose
        ``slot_idx == num_slots`` are unused scratch rows and dropped.
    decode_chunk()
        advance every slot ``sync_every`` greedy steps (async).
    sync_control() -> (active (S,) bool, gen (S,) i32)
        block and download the two tiny control arrays.
    fetch_outputs() -> (S, max_new_cap) i32
        block and download the output buffer.
    attrs: num_slots, max_len, max_new_cap, sync_every, prefill_batch,
        cache_allocations.

    admit_paged(tokens, slot_idx, limits, pos0, tables, write_mask,
                gather_src)
        the paged engine's admission (``paged=True``; ``admit`` then
        raises): gather shared prefix pages into the scratch, prefill
        only the suffix from ``pos0``, scatter the written blocks into
        their pages and install the block tables.

    Health extensions: ``slot_faults() -> (S,) bool`` per-slot poison
    flags (a slot whose decode logits turn NaN/inf is deactivated on the
    device in the same step and stays flagged until cleared);
    ``deactivate(slots)``; ``clear_slot_faults(slots)``.

    Health checks are on by default; ``health_checks=False`` removes
    the isfinite test from the decode chunk entirely.
"""
from __future__ import annotations

import math
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.data.tokenizer import EOS, PAD
from repro_torch.launch.mesh import BATCH
from repro_torch.models.collectives import _all_to_all
from repro_torch.models.schema import (tree_leaves, tree_map,
                                       tree_map_with_path, zeros_from_schema)
from repro_torch.models.transformer import check_tensor_parallel
from repro_torch.sharding import (local_params, local_schema, local_shape,
                                  named_specs, specs_for_schema)


class SingleDeviceExecutor:
    """Slot cache + prefill/commit/decode on the device holding the
    params (``params["embed"].device``)."""

    # the slots and pool pages this executor holds are the global ones
    # from slot_base / page_base on (all of them on one device); the
    # host allocator partitions its pages page_partitions ways
    slot_base = 0
    page_base = 0
    page_partitions = 1
    # the rows of an admission group this executor prefills
    prefill_rows = slice(None)

    def __init__(self, model, params, *, num_slots: int = 8,
                 max_len: int = 512, max_new_cap: int = 64,
                 sync_every: int = 4, prefill_batch: int = 1,
                 mla_absorb: bool = False,
                 health_checks: bool = True, paged: bool = False,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 metrics=None):
        self.model = model
        self.params = params
        # the MLA layers' absorbed attention, for every prefill and decode
        self.mla_absorb = mla_absorb
        self.device = params["embed"].device
        self.num_slots = num_slots
        self.max_len = max_len
        self.max_new_cap = max_new_cap
        self.sync_every = sync_every
        self.prefill_batch = max(1, min(prefill_batch, num_slots))
        self.health_checks = health_checks
        self.paged = paged

        # the ONLY cache allocations in the executor's lifetime: the
        # slot cache (dense per-slot rows, or the global page pool +
        # block tables) and the dense prefill scratch (reused forever)
        if paged:
            if max_len % page_size != 0:
                raise ValueError(f"max_len={max_len} must be a multiple "
                                 f"of page_size={page_size}")
            self.page_size = page_size
            # scratch rows reshape to mb_scratch pages; tables carry one
            # extra write-overflow block (an idle slot's held-position
            # write may land one past max_len - 1)
            self.mb_scratch = max_len // page_size
            self.max_blocks = self.mb_scratch + 1
            self.num_pages = (num_pages if num_pages is not None
                              else num_slots * self.max_blocks)
            self._validate_pages()
            # slots and pages shard contiguously, in lockstep
            self._pages_here = self.num_pages // self.page_partitions
            self.page_base = self.slot_base * self.num_pages // num_slots
        self._cache, self._pcache = self._alloc_caches()
        self.cache_allocations = 2

        # the control arrays cover the slots this executor holds
        S, cap, dev = self._cache["pos"].shape[0], max_new_cap, self.device
        i32 = dict(dtype=torch.int32, device=dev)
        self._dtok = torch.zeros(S, **i32)      # next input token
        self._dactive = torch.zeros(S, dtype=torch.bool, device=dev)
        self._dgen = torch.zeros(S, **i32)      # tokens generated so far
        self._dlimit = torch.zeros(S, **i32)    # per-slot max_new_tokens
        self._dout = torch.zeros((S, cap), **i32)
        self._dbad = torch.zeros(S, dtype=torch.bool, device=dev)
        self._sidx = torch.arange(S, device=dev)

        # device-dispatch wall histograms (repro_torch.obs) — None keeps
        # the hot path at a single attribute check per dispatch
        self._m_admit = None
        self._m_decode = None
        if metrics is not None:
            self.bind_metrics(metrics)

    def _validate_pages(self) -> None:
        per = self.num_pages // self.page_partitions
        if per < self.max_blocks:
            raise ValueError(
                f"num_pages={self.num_pages} over {self.page_partitions} "
                f"partition(s) leaves {per} pages per partition — fewer "
                f"than the {self.max_blocks} blocks one max_len request "
                f"needs; admission could never make progress")

    def _alloc_caches(self):
        """The slot cache (dense rows or page pool) and the prefill
        scratch."""
        m, dev = self.model, self.device
        if self.paged:
            cache = m.init_paged_cache(self.num_slots, self.num_pages,
                                       self.page_size, self.max_blocks,
                                       device=dev)
        else:
            cache = m.init_cache(self.num_slots, self.max_len, device=dev)
        return cache, m.init_cache(self.prefill_batch, self.max_len,
                                   device=dev)

    def _model_kw(self) -> dict:
        return {"mla_absorb": self.mla_absorb}

    def _local_rows(self, slot_idx: np.ndarray):
        """The rows of an admission group whose slots this executor
        holds, and those slots' indices into its slot arrays; rows of
        other slots (``num_slots``: unused scratch rows) are dropped."""
        loc = slot_idx - self.slot_base
        rows = np.flatnonzero((loc >= 0) & (loc < self._dactive.shape[0]))
        return rows, loc[rows]

    def _local_pages(self, pages: np.ndarray):
        """Global pool page ids -> (ids in this executor's pool, whether
        it holds them); the ``num_pages`` sentinel is never held."""
        loc = pages - self.page_base
        return loc, (loc >= 0) & (loc < self._pages_here)

    def bind_metrics(self, registry) -> None:
        """Register admit / decode-chunk host dispatch walls.  These
        are wall-clock measurements of the host's enqueueing (not
        virtual time), hence perf_counter rather than the engine
        clock."""
        bounds = (0.05, 0.1, 0.2, 0.5, 1.0, 2.0, 5.0,
                  10.0, 20.0, 50.0, 100.0)
        self._m_admit = registry.histogram(
            "executor_admit_dispatch_ms",
            "host wall of one prefill+commit dispatch", bounds)
        self._m_decode = registry.histogram(
            "executor_decode_dispatch_ms",
            "host wall of one K-step decode-chunk dispatch", bounds)

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(
            self.device, non_blocking=True)

    # -- device bodies --------------------------------------------------

    def _prefill(self, tokens: torch.Tensor, pos0=None) -> torch.Tensor:
        inputs = {"tokens": tokens}
        if pos0 is not None:
            inputs["pos0"] = pos0
        logits, _ = self.model.prefill(self.params, inputs, self._pcache,
                                       **self._model_kw())
        return logits[:, -1].argmax(dim=-1).to(torch.int32)

    def _scratch_rows(self, firsts, slot_idx: np.ndarray):
        """Where the admission group's prefilled rows are: ``(scratch,
        first tokens, the group's rows it holds in order)`` — here all
        of them, in the prefill scratch."""
        return [(self._pcache, firsts, slice(None))]

    def _commit(self, firsts, slot_idx: np.ndarray, limits: np.ndarray):
        for pc, f, rows in self._scratch_rows(firsts, slot_idx):
            self._insert(pc, f, slot_idx[rows], limits[rows])

    def _insert(self, pc, firsts, slot_idx: np.ndarray,
                limits: np.ndarray) -> None:
        """Scatter the prefilled rows of ``pc`` into their slots and
        write their slot state, in place.  Unused scratch rows carry
        slot index ``num_slots`` and are dropped — here on the host,
        where the indices come from."""
        rows, loc = self._local_rows(slot_idx)
        if rows.size == 0:
            return
        r = self._to_device(rows)
        s = self._to_device(loc.astype(np.int64))
        cache = self._cache
        cache["pos"][s] = pc["pos"][r]
        # prefix leaves are (B, ...); block leaves are (n_blocks, B, ...)
        for big, small in zip(tree_leaves(cache["prefix"]),
                              tree_leaves(pc["prefix"])):
            big[s] = small[r]
        for big, small in zip(tree_leaves(cache["blocks"]),
                              tree_leaves(pc["blocks"])):
            big[:, s] = small[:, r]
        self._commit_state(firsts[r], s, limits[rows])

    def _commit_state(self, f, s, limits: np.ndarray) -> None:
        """Write the admitted slots ``s``' first tokens ``f`` and their
        slot state."""
        lim = self._to_device(limits.astype(np.int32))
        self._dtok[s] = f
        self._dactive[s] = (f != EOS) & (lim > 1)
        self._dgen[s] = 1
        self._dlimit[s] = lim
        self._dout[s, 0] = f

    # -- paged bodies ---------------------------------------------------

    def _page_views(self, pc):
        """Per layer and leaf: the pool ``(num_pages, ps, ...)`` and the
        prefill scratch ``pc`` seen as pages ``(PB * mb_scratch, ps,
        ...)`` — both views, so copies into them land in the caches."""
        for key in ("prefix", "blocks"):
            for pool, scr in zip(tree_leaves(self._cache[key]),
                                 tree_leaves(pc[key])):
                # prefix leaves are (B, ...); block leaves (n_blocks, B, ...)
                for pl, sc in (zip(pool, scr) if key == "blocks"
                               else [(pool, scr)]):
                    yield pl, sc.reshape(-1, self.page_size, *sc.shape[2:])

    def _gather(self, src: np.ndarray) -> None:
        """Copy shared prefix pages from the pool into the prefill
        scratch (the copy-on-write borrow).  ``src`` is ``(PB,
        mb_scratch)`` pool page ids; the sentinel ``num_pages`` leaves
        that scratch block untouched — filtered here, on the host.  The
        copies queue on the stream behind any decode chunk in flight, so
        shared pages are never read mid-write."""
        flat, held = self._local_pages(src.reshape(-1))
        blocks = np.flatnonzero(held)
        if blocks.size == 0:
            return
        dst = self._to_device(blocks)
        pages = self._to_device(flat[blocks].astype(np.int64))
        for pool, scr in self._page_views(self._pcache):
            scr.index_copy_(0, dst, pool.index_select(0, pages))

    def _commit_paged(self, firsts, slot_idx: np.ndarray,
                      limits: np.ndarray, tables: np.ndarray,
                      wmask: np.ndarray) -> None:
        for pc, f, rows in self._scratch_rows(firsts, slot_idx):
            self._insert_paged(pc, f, slot_idx[rows], limits[rows],
                               tables[rows], wmask[rows])

    def _insert_paged(self, pc, firsts, slot_idx: np.ndarray,
                      limits: np.ndarray, tables: np.ndarray,
                      wmask: np.ndarray) -> None:
        """Scatter the prefilled blocks of ``pc``'s rows into their
        allocated pages and write their slot state and block tables.
        ``wmask`` marks the freshly written blocks: shared (borrowed)
        blocks and unused rows go to the ``num_pages`` sentinel and are
        dropped — here on the host."""
        rows, loc = self._local_rows(slot_idx)
        if rows.size == 0:
            return
        r = self._to_device(rows)
        s = self._to_device(loc.astype(np.int64))
        self._cache["pos"][s] = pc["pos"][r]
        # a slot's pages all lie in its own partition; a table's unused
        # entries (0) keep pointing at page 0 of the pool held here
        tbl, held = self._local_pages(tables[rows])
        self._cache["table"][s] = self._to_device(
            np.where(held, tbl, 0).astype(np.int32))
        pages, held = self._local_pages(np.where(
            wmask, tables[:, :self.mb_scratch], self.num_pages).reshape(-1))
        blocks = np.flatnonzero(held)
        if blocks.size:
            src = self._to_device(blocks)
            dst = self._to_device(pages[blocks].astype(np.int64))
            for pool, scr in self._page_views(pc):
                pool.index_copy_(0, dst, scr.index_select(0, src))
        self._commit_state(firsts[r], s, limits[rows])

    @torch.no_grad()
    def decode_chunk(self) -> None:
        """`sync_every` decode steps over all slots, done-mask on device.

        With ``health_checks`` on, each step tests the step's final
        logits row for NaN/inf: a poisoned slot is deactivated in the
        same step (its garbage token is never written, ``gen`` does not
        advance) and its ``bad`` flag latches until the scheduler clears
        it — the rest of the batch decodes on untouched."""
        t0 = time.perf_counter() if self._m_decode is not None else 0.0
        cache, out, sidx, limit = self._cache, self._dout, self._sidx, \
            self._dlimit
        tok, active, gen, bad = self._dtok, self._dactive, self._dgen, \
            self._dbad
        for _ in range(self.sync_every):
            pos0 = cache["pos"]
            if self.paged:
                # idle slots must not scribble into pages that may have
                # been released and reassigned: park them at a position
                # past the block table so the paged write drops
                cache["pos"] = torch.where(
                    active, pos0, self.max_blocks * self.page_size)
            inp = torch.where(active, tok, PAD)
            logits, _ = self.model.decode(self.params,
                                          {"tokens": inp[:, None]}, cache,
                                          **self._model_kw())
            last = logits[:, -1]
            nxt = last.argmax(dim=-1).to(torch.int32)
            if self.health_checks:
                row_bad = active & ~torch.isfinite(last).all(dim=-1)
                bad = bad | row_bad
                active = active & ~row_bad
            # hold position for idle slots (their kv write lands one past
            # their valid length and is masked / overwritten on admit)
            cache["pos"] = torch.where(active, cache["pos"], pos0)
            # only active slots write a token; an idle slot rewrites
            # column 0 with its own value
            col = torch.where(active, gen, 0).long()
            out[sidx, col] = torch.where(active, nxt, out[sidx, col])
            gen = gen + active.to(torch.int32)
            active = active & (nxt != EOS) & (gen < limit)
            tok = torch.where(active, nxt, tok)
        self._dtok, self._dactive, self._dgen, self._dbad = \
            tok, active, gen, bad
        if self._m_decode is not None:
            self._m_decode.observe((time.perf_counter() - t0) * 1e3)

    # -- protocol -------------------------------------------------------

    @torch.no_grad()
    def admit(self, tokens: np.ndarray, slot_idx: np.ndarray,
              limits: np.ndarray) -> None:
        """Prefill + insert + state commit for one admission group,
        enqueued on the stream behind any decode chunk in flight."""
        if self.paged:
            raise RuntimeError("paged executor: use admit_paged()")
        t0 = time.perf_counter() if self._m_admit is not None else 0.0
        rows = self.prefill_rows
        firsts = self._prefill(self._to_device(
            tokens[rows].astype(np.int64)))
        self._commit(firsts, np.asarray(slot_idx), np.asarray(limits))
        if self._m_admit is not None:
            self._m_admit.observe((time.perf_counter() - t0) * 1e3)

    @torch.no_grad()
    def admit_paged(self, tokens: np.ndarray, slot_idx: np.ndarray,
                    limits: np.ndarray, pos0: np.ndarray,
                    tables: np.ndarray, write_mask: np.ndarray,
                    gather_src: np.ndarray) -> None:
        """Paged admission: optional shared-page gather, suffix-only
        prefill from ``pos0``, then scatter the written pages into the
        pool and install the block tables.  ``tokens`` holds only the
        unique suffixes ``(PB, plen - p0)``; ``tables`` is ``(PB,
        max_blocks)``; ``write_mask`` ``(PB, mb_scratch)`` marks freshly
        written blocks; ``gather_src`` ``(PB, mb_scratch)`` holds source
        pool pages (sentinel ``num_pages`` = no gather)."""
        if not self.paged:
            raise RuntimeError("dense executor: use admit()")
        t0 = time.perf_counter() if self._m_admit is not None else 0.0
        rows = self.prefill_rows
        self._gather(np.asarray(gather_src))
        firsts = self._prefill(
            self._to_device(tokens[rows].astype(np.int64)),
            self._to_device(np.asarray(pos0, np.int32)[rows]))
        self._commit_paged(firsts, np.asarray(slot_idx), np.asarray(limits),
                           np.asarray(tables, np.int32),
                           np.asarray(write_mask, bool))
        if self._m_admit is not None:
            self._m_admit.observe((time.perf_counter() - t0) * 1e3)

    def _host(self, t: torch.Tensor) -> np.ndarray:
        """A host copy of a per-slot array."""
        return np.array(t.cpu())

    def sync_control(self):
        """The every-K host sync: only the two tiny control arrays come
        back (host copies)."""
        return self._host(self._dactive), self._host(self._dgen)

    def fetch_outputs(self) -> np.ndarray:
        return self._host(self._dout)

    # -- health / quarantine control ------------------------------------

    def slot_faults(self) -> np.ndarray:
        """Per-slot NaN/inf poison flags (host copy)."""
        return self._host(self._dbad)

    def _clear(self, flags: torch.Tensor, slots) -> None:
        loc = np.asarray([int(s) for s in slots], np.int64) - self.slot_base
        idx = loc[(loc >= 0) & (loc < flags.shape[0])]
        if idx.size:
            flags[self._to_device(idx)] = False

    def deactivate(self, slots) -> None:
        """Clear active bits for the given slots (quarantine or
        mid-stream cancel) without touching their cache rows."""
        self._clear(self._dactive, slots)

    def clear_slot_faults(self, slots) -> None:
        self._clear(self._dbad, slots)


def _row_leaves(tree) -> list:
    """``(leaf, its row dim)`` of a cache tree in tree order: a prefix
    leaf (and ``pos``) is ``(B, ...)``, a block leaf ``(n_blocks, B,
    ...)``."""
    out: list = []
    tree_map_with_path(lambda path, t: out.append(
        (t, int(path[0] == "blocks"))), tree)
    return out


def _segments(leaves, k: int):
    """Where ``k`` rows of each leaf sit in one rank's chunk of an
    exchange: ``(byte offset, shape)`` a leaf, each 16-byte aligned so
    that it views as its dtype, and the chunk's bytes."""
    segs, at = [], 0
    for t, d in leaves:
        shape = (*t.shape[:d], k, *t.shape[d + 1:])
        segs.append((at, shape))
        at += -(-math.prod(shape) * t.element_size() // 16) * 16
    return segs, at


def _row_routes(slot_idx: np.ndarray, num_slots: int, shards: int,
                row_shards: int, prefill_batch: int):
    """The rows of an admission group that another rank prefills than
    the one holding their slot: ``(rows, source, destination)`` batch
    indices.  The rank at batch index ``q`` prefills share ``q %
    row_shards`` of the rows and holds slots ``[q, q + 1) * num_slots /
    shards``; a row comes from the rank of its destination's pod (the
    block of ``row_shards`` batch indices) whose share holds it."""
    per = prefill_batch // row_shards
    rows = np.flatnonzero(slot_idx < num_slots)
    dst = slot_idx[rows] // (num_slots // shards)
    src = dst - dst % row_shards + rows // per
    x = src != dst
    return rows[x], src[x], dst[x]


def _page_routes(gather_src: np.ndarray, shards: int, row_shards: int,
                 num_pages: int):
    """Each rank's borrowed pages ``(shards, rows a share x blocks)``,
    flat over (row, block) as its prefill scratch is seen as pages; the
    rank holding each page (the sentinel ``num_pages``'s is ``shards``,
    no rank); and which of them another rank holds."""
    per = gather_src.shape[0] // row_shards
    q = np.arange(shards)
    pages = gather_src[(q % row_shards * per)[:, None]
                       + np.arange(per)].reshape(shards, -1)
    owner = pages // (num_pages // shards)
    return pages, owner, (pages < num_pages) & (owner != q[:, None])


def _view(buf, at: int, like, shape):
    """``buf``'s bytes from ``at`` seen as a ``like.dtype`` tensor."""
    n = math.prod(shape) * like.element_size()
    return buf[at:at + n].view(like.dtype).view(shape)


class ShardedExecutor(SingleDeviceExecutor):
    """pod x dp x mp executor: slots and prefill rows on the batch axes
    (``pod`` x ``data``), params on ``model``.

    SPMD, one process per card over ``torch.distributed``: the
    counterpart of the reference's single-controller GSPMD executor
    (``serving/executor.py::ShardedExecutor``, which lays one program's
    arrays out over the mesh and lets the compiler insert the
    collectives).  Here every rank runs the same host plane — Gateway,
    router, retrieval and the :class:`~repro_torch.serving.continuous.
    ContinuousEngine` scheduler — on the same inputs; deterministic
    under the same seeds, the ranks make the same host decisions and
    call this executor the same way.  Ranks talk only through
    collectives: the model apply's over ``model``, and over the batch
    axes the row exchange, the paged borrow and the gathers of the slot
    state here.

    * **Slots** split contiguously over the batch axes, pod-major: the
      rank at batch index ``b`` (``mesh.batch_index``) of ``n =
      mesh.batch_shards`` holds slots ``[b * S / n, (b + 1) * S / n)``
      of the slot cache (or, paged, the page partition ``b`` of
      ``num_pages / n`` pages, which the engine's
      :class:`~repro_torch.serving.paged.PagePool` allocates from with
      ``page_partitions = n``), and decodes them through K1 / K2.
    * **Prefill rows** split as the resolver splits the scratch's batch
      dim (the reference's ``_batch_entry``): over ``pod`` x ``data``
      where ``prefill_batch`` divides ``n``, else over ``data`` (each
      pod repeats it) where it divides dp, else not at all.  A rank
      prefills only its rows (``prefill_rows``) into a scratch of that
      many rows.  Then each row goes whole — every cache leaf and its
      first token — to the rank holding its slot, in one
      ``all_to_all`` over the batch group on a packed buffer (the
      reference all-gathers every row to every device instead), and
      the commit writes only local slots.  Paged, a row's shared prefix
      pages lie in its slot's partition: the pages held on another rank
      than the one prefilling the row come over in one more
      ``all_to_all`` before the prefill, copied bit for bit.  With one
      row shard, or where no row or page crosses ranks, neither is
      issued.
    * **Weights** resolve through ``specs_for_schema(schema, mesh,
      fsdp=False)``: the attention heads and kv heads (their
      ``head_dim`` columns where mp does not divide them; MLA's cached
      latent on its ``kv_lora`` columns, which a prefilled row carries
      to its slot's rank as it carries every leaf), the FFN and expert
      columns and the vocab split over ``model``
      (:data:`repro_torch.models.transformer.TP_AXES`); the apply takes
      the model axis's group as ``tp``.  A placement the apply has no
      collective for raises here (:func:`~repro_torch.models.
      transformer.check_tensor_parallel`).  ``params`` may come whole —
      at mp = 1 each leaf is kept as it is, a view; at mp > 1 the rank
      copies its shard — or already as this rank's shards
      (:func:`repro_torch.sharding.init_local_params`).
    * **Host reads** (``sync_control``, ``fetch_outputs``,
      ``slot_faults``) all-gather the per-slot arrays over the batch
      group in batch order, so they return every slot, as on one
      device; the decode chunk itself has no host sync.

    Greedy decode is row-independent, so every layout gives the
    single-device executor's tokens (the same sums, in float32 up to
    the order of the tensor-parallel partial sums).
    """

    def __init__(self, model, params, *, mesh, num_slots: int = 8,
                 **kw):
        n = mesh.batch_shards
        if num_slots % n != 0:
            raise ValueError(
                f"num_slots={num_slots} must be divisible by the mesh "
                f"data-axis size {n} to shard the slot dimension")
        self.mesh = mesh
        self.tp = mesh.group("model")
        self.slot_base = mesh.batch_index * (num_slots // n)
        if kw.get("paged"):
            # the pool's page dim shards over the batch axes with the
            # slots: a slot's pages stay on the rank that holds its row
            self.page_partitions = n
        specs = specs_for_schema(model.schema, mesh, fsdp=False)
        check_tensor_parallel(named_specs(model.schema, specs), mesh.mp)
        super().__init__(model, local_params(model.schema, params, mesh,
                                             specs),
                         num_slots=num_slots, **kw)

    def _validate_pages(self) -> None:
        n = self.mesh.batch_shards
        if self.num_pages % n != 0:
            raise ValueError(
                f"num_pages={self.num_pages} must be divisible by the mesh "
                f"data-axis size {n} to shard the pool")
        super()._validate_pages()

    def _alloc_caches(self):
        """This rank's slots (or page partition) and kv heads of the slot
        cache; this rank's rows and kv heads of the prefill scratch."""
        m, mesh = self.model, self.mesh
        if self.paged:
            schema = m.paged_cache_schema(self.num_slots, self.num_pages,
                                          self.page_size, self.max_blocks)
        else:
            schema = m.cache_schema(self.num_slots, self.max_len)
        scratch = m.cache_schema(self.prefill_batch, self.max_len)
        specs = specs_for_schema(schema, mesh)
        sspecs = specs_for_schema(scratch, mesh)
        check_tensor_parallel(named_specs(schema, specs)
                              + named_specs(scratch, sspecs), mesh.mp)
        per = local_shape((self.prefill_batch,), sspecs["pos"], mesh)[0]
        self._row_shards = self.prefill_batch // per
        lo = mesh.batch_index % self._row_shards * per
        self.prefill_rows = slice(lo, lo + per)
        return (zeros_from_schema(local_schema(schema, specs, mesh),
                                  device=self.device),
                zeros_from_schema(local_schema(scratch, sspecs, mesh),
                                  device=self.device))

    def _model_kw(self) -> dict:
        return {"mla_absorb": self.mla_absorb, "tp": self.tp}

    # -- the row split ---------------------------------------------------

    def _exchange(self, leaves, sends, counts):
        """One ``all_to_all`` over the batch group: to rank ``q`` the
        rows ``sends[q]`` (indices into each leaf's row dim) of every
        ``(leaf, row dim)`` of ``leaves``, packed into one buffer; from
        rank ``o`` ``counts[o]`` rows.  Returns ``(o, the received
        leaves)`` for each ``o`` that sends, views of the buffer shaped
        as the leaves with ``counts[o]`` rows."""
        send_sizes = [_segments(leaves, len(ix))[1] for ix in sends]
        buf = torch.empty(sum(send_sizes), dtype=torch.uint8,
                          device=self.device)
        at = 0
        for ix, size in zip(sends, send_sizes):
            if len(ix):
                idx = self._to_device(ix.astype(np.int64))
                for (t, d), (off, shape) in zip(
                        leaves, _segments(leaves, len(ix))[0]):
                    torch.index_select(t, d, idx,
                                       out=_view(buf, at + off, t, shape))
            at += size
        recv_sizes = [_segments(leaves, k)[1] for k in counts]
        got = _all_to_all(buf, self.mesh.group(BATCH), send_sizes,
                          recv_sizes)
        out, at = [], 0
        for o, (k, size) in enumerate(zip(counts, recv_sizes)):
            if k:
                out.append((o, [_view(got, at + off, t, shape)
                                for (t, _), (off, shape) in zip(
                                    leaves, _segments(leaves, k)[0])]))
            at += size
        return out

    def _scratch_rows(self, firsts, slot_idx: np.ndarray):
        """This rank's prefilled rows in the scratch, and each row that
        another rank prefilled for a slot held here, received whole."""
        here = [(self._pcache, firsts, self.prefill_rows)]
        if self._row_shards == 1:
            return here
        rows, src, dst = _row_routes(slot_idx, self.num_slots,
                                     self.mesh.batch_shards,
                                     self._row_shards, self.prefill_batch)
        if not rows.size:
            return here
        me, n = self.mesh.batch_index, self.mesh.batch_shards
        lo = self.prefill_rows.start
        sends = [rows[(src == me) & (dst == q)] - lo for q in range(n)]
        recvs = [rows[(dst == me) & (src == o)] for o in range(n)]
        for o, got in self._exchange(_row_leaves(self._pcache)
                                     + [(firsts, 0)], sends,
                                     [r.size for r in recvs]):
            it = iter(got)
            pc = tree_map(lambda _: next(it), self._pcache)
            here.append((pc, next(it), recvs[o]))
        return here

    def _gather(self, src: np.ndarray) -> None:
        """The borrow into this rank's rows: the shared pages held here
        copied locally, the others received from their ranks."""
        super()._gather(src[self.prefill_rows])
        if self._row_shards == 1:
            return
        n, me = self.mesh.batch_shards, self.mesh.batch_index
        pages, owner, cross = _page_routes(src, n, self._row_shards,
                                           self.num_pages)
        if not cross.any():
            return
        sends = [pages[q][cross[q] & (owner[q] == me)] - self.page_base
                 for q in range(n)]
        recvs = [np.flatnonzero(cross[me] & (owner[me] == o))
                 for o in range(n)]
        pool = _row_leaves({k: self._cache[k] for k in ("prefix",
                                                        "blocks")})
        scratch = _row_leaves({k: self._pcache[k] for k in ("prefix",
                                                            "blocks")})
        ps = self.page_size
        for o, got in self._exchange(pool, sends, [r.size for r in recvs]):
            dst = self._to_device(recvs[o])
            for (scr, d), g in zip(scratch, got):
                scr.reshape(*scr.shape[:d], -1, ps, *scr.shape[d + 2:]
                            ).index_copy_(d, dst, g)

    def _host(self, t: torch.Tensor) -> np.ndarray:
        """Every slot's value, gathered over the batch group in batch
        order (the slots' order), then copied to the host."""
        x = t.to(torch.int32)
        parts = [torch.empty_like(x) for _ in range(self.mesh.batch_shards)]
        dist.all_gather(parts, x, group=self.mesh.group(BATCH))
        return np.array(torch.cat(parts).to(t.dtype).cpu())
