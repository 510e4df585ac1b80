"""Device executor for the continuous engine: the dense slot cache or
the paged pool.

The host scheduler in :mod:`repro_torch.serving.continuous` is
device-agnostic: it plans admissions, tracks slot ownership, and
harvests finished requests — all in numpy.  Everything that touches
device buffers lives behind the executor protocol implemented here by
:class:`SingleDeviceExecutor`: the slot cache (dense per-slot rows, or
the global page pool + block tables) and the dense prefill scratch,
allocated once, plus prefill, insert+state-commit and the K-step decode
chunk.

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
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.data.tokenizer import EOS, PAD
from repro_torch.models.schema import tree_leaves


class SingleDeviceExecutor:
    """Slot cache + prefill/commit/decode on the device holding the
    params (``params["embed"].device``)."""

    def __init__(self, model, params, *, num_slots: int = 8,
                 max_len: int = 512, max_new_cap: int = 64,
                 sync_every: int = 4, prefill_batch: int = 1,
                 paged: bool = False, page_size: int = 16,
                 num_pages: Optional[int] = None):
        self.model = model
        self.params = params
        self.device = params["embed"].device
        self.num_slots = num_slots
        self.max_len = max_len
        self.max_new_cap = max_new_cap
        self.sync_every = sync_every
        self.prefill_batch = max(1, min(prefill_batch, num_slots))
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
            if self.num_pages < self.max_blocks:
                raise ValueError(
                    f"num_pages={self.num_pages} leaves {self.num_pages} "
                    f"pages per partition — fewer than the "
                    f"{self.max_blocks} blocks one max_len request needs; "
                    f"admission could never make progress")
            self._cache = model.init_paged_cache(
                num_slots, self.num_pages, page_size, self.max_blocks,
                device=self.device)
        else:
            self._cache = model.init_cache(num_slots, max_len,
                                           device=self.device)
        self._pcache = model.init_cache(self.prefill_batch, max_len,
                                        device=self.device)
        self.cache_allocations = 2

        S, cap, dev = num_slots, max_new_cap, self.device
        i32 = dict(dtype=torch.int32, device=dev)
        self._dtok = torch.zeros(S, **i32)      # next input token
        self._dactive = torch.zeros(S, dtype=torch.bool, device=dev)
        self._dgen = torch.zeros(S, **i32)      # tokens generated so far
        self._dlimit = torch.zeros(S, **i32)    # per-slot max_new_tokens
        self._dout = torch.zeros((S, cap), **i32)
        self._dbad = torch.zeros(S, dtype=torch.bool, device=dev)
        self._sidx = torch.arange(S, device=dev)

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(
            self.device, non_blocking=True)

    # -- device bodies --------------------------------------------------

    def _prefill(self, tokens: torch.Tensor, pos0=None) -> torch.Tensor:
        inputs = {"tokens": tokens}
        if pos0 is not None:
            inputs["pos0"] = pos0
        logits, _ = self.model.prefill(self.params, inputs, self._pcache)
        return logits[:, -1].argmax(dim=-1).to(torch.int32)

    def _commit(self, firsts, slot_idx: np.ndarray, limits: np.ndarray):
        """Scatter the prefilled scratch rows into their slots and write
        the admission group's slot state, in place.  Unused scratch rows
        carry slot index ``num_slots`` and are dropped — here on the
        host, where the indices come from."""
        rows = np.flatnonzero(slot_idx < self.num_slots)
        if rows.size == 0:
            return
        r = self._to_device(rows)
        s = self._to_device(slot_idx[rows].astype(np.int64))
        cache, pc = self._cache, self._pcache
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

    def _page_views(self):
        """Per layer and leaf: the pool ``(num_pages, ps, ...)`` and the
        prefill scratch seen as pages ``(PB * mb_scratch, ps, ...)`` —
        both views, so copies into them land in the caches."""
        for key in ("prefix", "blocks"):
            for pool, scr in zip(tree_leaves(self._cache[key]),
                                 tree_leaves(self._pcache[key])):
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
        flat = src.reshape(-1)
        blocks = np.flatnonzero(flat < self.num_pages)
        if blocks.size == 0:
            return
        dst = self._to_device(blocks)
        pages = self._to_device(flat[blocks].astype(np.int64))
        for pool, scr in self._page_views():
            scr.index_copy_(0, dst, pool.index_select(0, pages))

    def _commit_paged(self, firsts, slot_idx: np.ndarray,
                      limits: np.ndarray, tables: np.ndarray,
                      wmask: np.ndarray) -> None:
        """Scatter the prefilled scratch blocks into their allocated
        pages and write the admission group's slot state and block
        tables.  ``wmask`` marks the freshly written blocks: shared
        (borrowed) blocks and unused rows go to the ``num_pages``
        sentinel and are dropped — here on the host."""
        rows = np.flatnonzero(slot_idx < self.num_slots)
        if rows.size == 0:
            return
        r = self._to_device(rows)
        s = self._to_device(slot_idx[rows].astype(np.int64))
        self._cache["pos"][s] = self._pcache["pos"][r]
        self._cache["table"][s] = self._to_device(tables[rows])
        pages = np.where(wmask, tables[:, :self.mb_scratch],
                         self.num_pages).reshape(-1)
        blocks = np.flatnonzero(pages < self.num_pages)
        if blocks.size:
            src = self._to_device(blocks)
            dst = self._to_device(pages[blocks].astype(np.int64))
            for pool, scr in self._page_views():
                pool.index_copy_(0, dst, scr.index_select(0, src))
        self._commit_state(firsts[r], s, limits[rows])

    @torch.no_grad()
    def decode_chunk(self) -> None:
        """`sync_every` decode steps over all slots, done-mask on device.

        Each step tests the step's final logits row for NaN/inf: a
        poisoned slot is deactivated in the same step (its garbage token
        is never written, ``gen`` does not advance) and its ``bad`` flag
        latches until the scheduler clears it — the rest of the batch
        decodes on untouched."""
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
                                          {"tokens": inp[:, None]}, cache)
            last = logits[:, -1]
            nxt = last.argmax(dim=-1).to(torch.int32)
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

    # -- protocol -------------------------------------------------------

    @torch.no_grad()
    def admit(self, tokens: np.ndarray, slot_idx: np.ndarray,
              limits: np.ndarray) -> None:
        """Prefill + insert + state commit for one admission group,
        enqueued on the stream behind any decode chunk in flight."""
        if self.paged:
            raise RuntimeError("paged executor: use admit_paged()")
        firsts = self._prefill(self._to_device(tokens.astype(np.int64)))
        self._commit(firsts, np.asarray(slot_idx), np.asarray(limits))

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
        self._gather(np.asarray(gather_src))
        firsts = self._prefill(self._to_device(tokens.astype(np.int64)),
                               self._to_device(np.asarray(pos0, np.int32)))
        self._commit_paged(firsts, np.asarray(slot_idx), np.asarray(limits),
                           np.asarray(tables, np.int32),
                           np.asarray(write_mask, bool))

    def sync_control(self):
        """The every-K host sync: only the two tiny control arrays come
        back (host copies)."""
        return np.array(self._dactive.cpu()), np.array(self._dgen.cpu())

    def fetch_outputs(self) -> np.ndarray:
        return np.array(self._dout.cpu())

    # -- health / quarantine control ------------------------------------

    def slot_faults(self) -> np.ndarray:
        """Per-slot NaN/inf poison flags (host copy)."""
        return np.array(self._dbad.cpu())

    def _clear(self, flags: torch.Tensor, slots) -> None:
        idx = [int(s) for s in slots if 0 <= int(s) < self.num_slots]
        if idx:
            flags[self._to_device(np.asarray(idx, np.int64))] = False

    def deactivate(self, slots) -> None:
        """Clear active bits for the given slots (quarantine or
        mid-stream cancel) without touching their cache rows."""
        self._clear(self._dactive, slots)

    def clear_slot_faults(self, slots) -> None:
        self._clear(self._dbad, slots)
