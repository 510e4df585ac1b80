#!/usr/bin/env python3
"""The cost of calling K1 (dense flash-decode) through its
``torch.library`` op, on one CUDA card.

    python3 scripts/flash_decode_op_cost.py

K1's wrapper sends a CUDA tensor to the op
``torch.ops.repro_torch.flash_decode`` (its CUDA kernel is the launch,
its fake kernel the dry run's fake rule).  At the main path's shape
(B=8, L=392, H=40, Hkv=8, D=128, bf16; ragged lengths as in
``chip_smoke.kernel_phase``) this prints, for the wrapper and for the
launch called directly, in turns (wrapper, direct, direct, wrapper),
the warm device time a call (``chip_smoke.cuda_ms``) and the host's
time to issue a call (``chip_smoke.host_us``), and the card's name and
power limit.  Both outputs are held against ``flash_decode_torch``
within ``chip_smoke.KERNEL_TOL``.  Imports nothing of the JAX package.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as smoke  # noqa: E402


def main() -> dict:
    import torch
    from repro_torch.kernels.flash_decode import (_launch, flash_decode,
                                                  flash_decode_torch)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    B, L, H, Hkv, D = 8, 392, 40, 8, 128
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(B, H, D, device="cuda", generator=g).bfloat16()
    k = torch.randn(B, L, Hkv, D, device="cuda", generator=g).bfloat16()
    v = torch.randn(B, L, Hkv, D, device="cuda", generator=g).bfloat16()
    lengths = torch.tensor([392, 1, 120, 250, 37, 299, 180, 64],
                           dtype=torch.int32, device="cuda")
    want = flash_decode_torch(q, k, v, lengths).float()
    calls = {"wrapper": lambda: flash_decode(q, k, v, lengths),
             "direct": lambda: _launch(q, k, v, lengths)}
    for name, fn in calls.items():
        err = float((fn().float() - want).abs().max())
        if err > smoke.KERNEL_TOL:
            raise AssertionError(f"{name}: max |err| {err}")
    rows = {name: {"ms": [], "host_us": []} for name in calls}
    for name in ("wrapper", "direct", "direct", "wrapper"):
        rows[name]["ms"].append(smoke.cuda_ms(calls[name], 200))
        rows[name]["host_us"].append(smoke.host_us(calls[name], 500))
    out = {n: {"ms": sum(r["ms"]) / 2, "host_us": sum(r["host_us"]) / 2,
               "turns": r} for n, r in rows.items()}
    out["wrapper_minus_direct_host_us"] = (out["wrapper"]["host_us"]
                                           - out["direct"]["host_us"])
    out["wrapper_minus_direct_us"] = 1e3 * (out["wrapper"]["ms"]
                                            - out["direct"]["ms"])
    out["card"] = card
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
