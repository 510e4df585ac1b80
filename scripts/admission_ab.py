#!/usr/bin/env python3
"""Time one admission group (prefill + commit) of qwen1.5-32b FULL on
one CUDA card through ``SingleDeviceExecutor`` and through
``ShardedExecutor`` on a serving mesh of one NCCL rank, dense and paged,
for the checkout at ``--root``.

    python3 scripts/admission_ab.py [--root DIR] [--turns 4] [--reps 5]

``DIR`` (default: this checkout) is a checkout of the repository whose
``src/`` is imported, so two checkouts (say, an unpacked ``git
archive`` of a parent commit and the working tree) can be compared on
one card in one call, each in its own process: parent, change, change,
parent.  The executors take chip_smoke's serving shapes (8 slots, a
prefill batch of 4, max_len 392, 8 new tokens; paged: pages of 8, a
pool of 400) and seeded bf16 weights, which the sharded executor views.
Each admits 4 seeded prompts of 384 tokens into slots 0-3; paged, rows
1-3 first borrow two pages of row 0's (the copy-on-write gather) and
every row writes its 48 blocks.  Each turn builds one executor, admits
once to warm it, times ``--reps`` admissions with CUDA events from an
idle stream (host enqueueing and card work together) and frees it, then
the other, the order alternating by turn.  Prints one JSON line: the
card, every call's ms, the medians and sharded / single.  Imports
nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import gc
import json
import statistics
import subprocess
import sys
from pathlib import Path

PB, PLEN, MAX_LEN, NEW = 4, 384, 392, 8
PAGE_SIZE, NUM_PAGES = 8, 400


def _admit_args(kind: str, vocab: int):
    import numpy as np
    toks = np.random.default_rng(0).integers(
        4, vocab, (PB, PLEN)).astype(np.int32)
    args = (toks, np.arange(PB, dtype=np.int32), np.full(PB, NEW, np.int32))
    if kind == "dense":
        return args
    mb, blocks = MAX_LEN // PAGE_SIZE, PLEN // PAGE_SIZE
    tables = np.zeros((PB, mb + 1), np.int32)
    tables[:, :mb] = np.arange(PB * mb).reshape(PB, mb)
    wmask = np.zeros((PB, mb), bool)
    wmask[:, :blocks] = True
    gsrc = np.full((PB, mb), NUM_PAGES, np.int32)
    gsrc[1:, :2] = tables[0, :2]
    return args + (np.zeros(PB, np.int32), tables, wmask, gsrc)


def measure(turns: int, reps: int) -> dict:
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models import build_model
    from repro_torch.serving.executor import (ShardedExecutor,
                                              SingleDeviceExecutor)
    cfg = get_config("qwen1.5-32b", "full")
    model = build_model(cfg)
    params = model.init(seed=0, device="cuda")
    mesh = make_serving_mesh("dp=1", cfg, device="cuda")
    out = {"card": torch.cuda.get_device_name(0)}
    try:
        for kind in ("dense", "paged"):
            kw = dict(num_slots=8, max_len=MAX_LEN, max_new_cap=NEW,
                      sync_every=4, prefill_batch=PB)
            if kind == "paged":
                kw.update(paged=True, page_size=PAGE_SIZE,
                          num_pages=NUM_PAGES)
            make = {"single": lambda: SingleDeviceExecutor(model, params,
                                                           **kw),
                    "sharded": lambda: ShardedExecutor(model, params,
                                                       mesh=mesh, **kw)}
            args = _admit_args(kind, cfg.vocab_size)
            ms = {name: [] for name in make}
            firsts = {name: set() for name in make}
            for turn in range(turns):
                order = list(make) if turn % 2 == 0 else list(make)[::-1]
                for name in order:
                    # one executor at a time: two beside 64 GB of weights
                    # and a prefill's activations do not fit the card
                    ex = make[name]()
                    call = ex.admit if kind == "dense" else ex.admit_paged
                    call(*args)
                    torch.cuda.synchronize()
                    for _ in range(reps):
                        a, b = (torch.cuda.Event(enable_timing=True)
                                for _ in range(2))
                        a.record()
                        call(*args)
                        b.record()
                        b.synchronize()
                        ms[name].append(round(a.elapsed_time(b), 3))
                    firsts[name].add(tuple(ex._host(ex._dtok)[:PB]))
                    del ex, call
                    gc.collect()
                    torch.cuda.empty_cache()
            if len(firsts["single"] | firsts["sharded"]) != 1:
                raise AssertionError(f"{kind}: first tokens {firsts}")
            med = {name: statistics.median(v) for name, v in ms.items()}
            out[kind] = {"ms": ms, "median": med,
                         "sharded_over_single": round(
                             med["sharded"] / med["single"], 4)}
        return out
    finally:
        dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent
                                          .parent))
    ap.add_argument("--turns", type=int, default=4)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("admission_ab: torch sees no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.splitlines()[0]
    res = measure(args.turns, args.reps)
    print(json.dumps({"root": root.name, "smi": smi, **res}), flush=True)


if __name__ == "__main__":
    main()
