"""The decode step of qwen1.5-32b FULL through ``SingleDeviceExecutor``
and through ``ShardedExecutor`` on a serving mesh of one NCCL rank, in
turns, on the card.

    python3 scripts/sharded_step_overhead.py [--turns 4] [--chunks 5]

Both executors hold the same seeded weights (the sharded one views
them) and a dense slot cache of 8 slots, each filled by two admissions
of 4 prompts of 384 tokens; then each turn times ``--chunks`` decode
chunks (4 steps each) of one executor and then of the other, the order
alternating, by the host's clock to a synchronize (a decode step is
host-bound, so this is its time).  The sharded step issues 129
all-reduces and one all-gather.  Child processes repeat it with NCCL's
flight recorder off (``TORCH_FR_BUFFER_SIZE=0``) and with
``TORCH_NCCL_AVOID_RECORD_STREAMS=1``.  Prints one JSON line a process:
every turn's ms a step for each executor, their medians and the ratio.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

VARIANTS = ({}, {"TORCH_FR_BUFFER_SIZE": "0",
                 "TORCH_NCCL_TRACE_BUFFER_SIZE": "0"},
            {"TORCH_NCCL_AVOID_RECORD_STREAMS": "1"})


def measure(turns: int, chunks: int) -> dict:
    import numpy as np
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
    try:
        kw = dict(num_slots=8, max_len=392, max_new_cap=8, sync_every=4,
                  prefill_batch=4)
        execs = {"single": SingleDeviceExecutor(model, params, **kw),
                 "sharded": ShardedExecutor(model, params, mesh=mesh, **kw)}
        rng = np.random.default_rng(0)
        toks = rng.integers(4, cfg.vocab_size, size=(8, 384)).astype(np.int32)
        for ex in execs.values():
            for g in range(2):
                ex.admit(toks[4 * g:4 * g + 4],
                         np.arange(4 * g, 4 * g + 4, dtype=np.int32),
                         np.full(4, 8, np.int32))
            ex.decode_chunk()
        torch.cuda.synchronize()
        ms = {name: [] for name in execs}
        for turn in range(turns):
            order = list(execs) if turn % 2 == 0 else list(execs)[::-1]
            for name in order:
                ex = execs[name]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(chunks):
                    ex.decode_chunk()
                torch.cuda.synchronize()
                ms[name].append(round((time.perf_counter() - t0) * 1e3
                                      / (chunks * ex.sync_every), 2))
        med = {name: statistics.median(v) for name, v in ms.items()}
        return {"env": {k: os.environ[k] for v in VARIANTS for k in v
                        if k in os.environ},
                "card": torch.cuda.get_device_name(0),
                "ms_a_step": ms, "median": med,
                "sharded_over_single": round(med["sharded"]
                                             / med["single"], 3)}
    finally:
        dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--turns", type=int, default=4)
    ap.add_argument("--chunks", type=int, default=5)
    ap.add_argument("--child", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("sharded_step_overhead: torch sees no CUDA device")
    if args.child:
        print(json.dumps(measure(args.turns, args.chunks)), flush=True)
        return
    for env in VARIANTS:
        subprocess.run([sys.executable, __file__, "--child", "--turns",
                        str(args.turns), "--chunks", str(args.chunks)],
                       env=dict(os.environ, **env), check=True)


if __name__ == "__main__":
    main()
