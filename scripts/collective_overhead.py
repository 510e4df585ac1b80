"""The host and device cost of one collective on a serving mesh of one
NCCL rank, on the card.

    python3 scripts/collective_overhead.py [--calls 2000]

A tensor-parallel decode step of qwen1.5-32b issues 129 all-reduces of
a (8, 1, 5120) bf16 activation and one all-gather of the (8, 1, 152064)
float32 logits (``chip_smoke.py`` counts them).  This script times each
kind alone, back to back on the model axis's group of a
``make_serving_mesh("dp=1")`` mesh: the host's clock per call (what a
host-bound decode step pays) and CUDA events per call (the card's
time), beside a plain in-place ``add_`` of the same tensor as the floor
of one eager launch.  It runs itself again in a child process with
NCCL's flight recorder off (``TORCH_FR_BUFFER_SIZE=0``, and its older
name) to show that recorder's share.  Prints one JSON line per run.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def _time(fn, calls: int):
    """(host µs a call, device µs a call) over ``calls`` calls."""
    import torch
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    s.record()
    for _ in range(calls):
        fn()
    e.record()
    host = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return host, s.elapsed_time(e) / calls * 1e3


def measure(calls: int) -> dict:
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_serving_mesh
    mesh = make_serving_mesh("dp=1", device="cuda")
    try:
        tp = mesh.group("model")
        x = torch.randn((8, 1, 5120), device="cuda").to(torch.bfloat16)
        logits = torch.randn((8, 1, 152064), device="cuda")
        parts = [torch.empty_like(logits)]
        out = {"flight_recorder": os.environ.get("TORCH_FR_BUFFER_SIZE",
                                                 "default"),
               "torch": torch.__version__,
               "nccl": ".".join(map(str, torch.cuda.nccl.version())),
               "card": torch.cuda.get_device_name(0)}
        for name, fn in (
                ("add_", lambda: x.add_(0)),
                ("all_reduce", lambda: dist.all_reduce(x, group=tp)),
                ("all_gather", lambda: dist.all_gather(parts, logits,
                                                       group=tp))):
            host, dev = _time(fn, calls)
            out[name] = {"host_us": round(host, 2), "device_us": round(dev, 2)}
        return out
    finally:
        dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=2000)
    ap.add_argument("--child", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("collective_overhead: torch sees no CUDA device")
    print(json.dumps(measure(args.calls)), flush=True)
    if not args.child:
        env = dict(os.environ, TORCH_FR_BUFFER_SIZE="0",
                   TORCH_NCCL_TRACE_BUFFER_SIZE="0")
        subprocess.run([sys.executable, __file__, "--child", "--calls",
                        str(args.calls)], env=env, check=True)


if __name__ == "__main__":
    main()
