#!/usr/bin/env python3
"""Time qwen1.5-32b FULL's dense decode step on one CUDA card, and count
the host syncs of a decode chunk, for the checkout at ``--root``.

    python3 scripts/decode_step_ab.py [--root DIR]

``DIR`` (default: this checkout) is a checkout of the repository; its
``chip_smoke.py`` and ``src/`` are imported, so two checkouts (say, an
unpacked ``git archive`` of a parent commit and the working tree) can be
compared in one run on one card: parent, change, change, parent.
It serves chip_smoke's main-path closed loop on the dense slot cache
(8 slots, prefill batch 4, prompts of 384, 8 new tokens; 16 requests
under ``FixedPolicy(0)`` in two batches of 8, seeded bf16 weights) with
chip_smoke's ``_drive``, and prints the decode step (median of the
chunks' per-step device time, CUDA events), the host wall of the serve
a decode step, and the synchronising CUDA calls one more decode chunk
makes (``torch.cuda.set_sync_debug_mode("warn")``, each warning
counted).  Imports nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import statistics
import sys
import time
import warnings
from pathlib import Path


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent
                                          .parent))
    root = Path(ap.parse_args().root).resolve()
    sys.path[:0] = [str(root), str(root / "src")]
    import torch

    import chip_smoke as smoke
    from repro_torch.configs import get_config
    from repro_torch.data import HashTokenizer, SyntheticSquad
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.paged_flash_decode import paged_flash_decode
    from repro_torch.models import build_model
    from repro_torch.retrieval import BM25Index
    from repro_torch.routing import ContinuousEngineBackend, FixedPolicy

    card = smoke.device_phase()
    smoke.build_phase()
    cfg = get_config("qwen1.5-32b", "full")
    model = build_model(cfg)
    params = model.init(seed=0, device="cuda")
    data = SyntheticSquad(n_paragraphs=600, n_questions=1000, seed=0)
    index = BM25Index.build([p.text for p in data.paragraphs])
    backend = ContinuousEngineBackend.create(
        model, params, HashTokenizer(cfg.vocab_size), index,
        num_slots=smoke.NUM_SLOTS, prefill_batch=smoke.PREFILL_BATCH,
        max_prompt_len=smoke.MAX_PROMPT_LEN,
        max_new_tokens=smoke.MAX_NEW_TOKENS)
    counters = {"flash_decode": flash_decode,
                "paged_flash_decode": paged_flash_decode}
    label = f"decode a/b {root.name}"
    run = smoke._drive(label, backend, index, data.questions[-16:], 2, card,
                       cfg.n_layers, counters, FixedPolicy(0))
    smoke._check_launches(label, run["launches"], "flash_decode",
                          run["steps"], cfg.n_layers)
    ex = backend.engine.executor
    per_step = [s.elapsed_time(e) / ex.sync_every
                for s, e in run["rec"]["chunks"]]
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        t0 = time.perf_counter()
        try:
            ex.decode_chunk()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    # the mode's own notice that it is a prototype is not a sync
    syncs = sum("called a synchronizing" in str(w.message) for w in caught)
    smoke.say(f"== {label}: decode step median {statistics.median(per_step):.2f}"
              f" ms ({[round(x, 2) for x in per_step]}, CUDA events); serve "
              f"wall {run['wall']:.2f} s = {run['wall'] / run['steps'] * 1e3:.2f}"
              f" ms a decode step; one more chunk of {ex.sync_every} steps: "
              f"{syncs} synchronising CUDA call(s), {host_ms:.2f} ms on the "
              f"host clock [{card}]")


if __name__ == "__main__":
    main()
