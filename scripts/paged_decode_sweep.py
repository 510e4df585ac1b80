#!/usr/bin/env python3
"""Time K2 (paged flash-decode) beside K1 on the same rows, over length
profiles and partition counts, on one CUDA card.

    python3 scripts/paged_decode_sweep.py

At the paged main path's shape (B=8, H=Hkv=40, D=128, page size 8,
50-block tables into 400 pages) and under five length profiles -- the
main path's ragged lengths, the same rows spread evenly, all slots full,
short slots, and one full slot among length-1 slots -- it prints, for
each profile, the K/V bytes and their bound at 3.35 TB/s, K1 over the
rows gathered into a dense cache, and K2 with 1, 2 and 4 partitions (the
module's partition rule replaced by a fixed count; at this shape the
rule itself picks 1).  Every K2 output is held against the plain
version.  Times are ``chip_smoke.cuda_ms``'s, on the card.  Imports
nothing of the JAX package.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as smoke  # noqa: E402

PROFILES = (
    ("ragged (the main path's)", [1, 401, 392, 283, 235, 75, 200, 259]),
    ("even, the same rows", [231] * 8),
    ("all full", [400] * 8),
    ("even, short", [100] * 8),
    ("one full slot", [400] + [1] * 7),
)


def main() -> None:
    smoke.device_phase()
    smoke.build_phase()
    import torch
    from repro_torch.kernels import paged_flash_decode as pfd
    from repro_torch.kernels.flash_decode import flash_decode
    g = torch.Generator(device="cuda").manual_seed(1)
    B, H, Hkv, D = 8, 40, 40, 128
    ps, MB, NP = smoke.PAGE_SIZE, 50, smoke.NUM_PAGES

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda",
                           dtype=torch.bfloat16)
    q, kp, vp = rnd(B, H, D), rnd(NP, ps, Hkv, D), rnd(NP, ps, Hkv, D)
    table = torch.randperm(NP, generator=g, device="cuda")[:B * MB]
    table = table.reshape(B, MB).to(torch.int32)
    tab = table.long()
    kd = kp[tab].reshape(B, MB * ps, Hkv, D)
    vd = vp[tab].reshape(B, MB * ps, Hkv, D)
    rule = pfd.partitions
    try:
        for label, lengths in PROFILES:
            lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
            n = lens.clamp(1, MB * ps)
            want = pfd.paged_flash_decode_torch(q, kp, vp, table, lens)
            times = [f"K1 {smoke.cuda_ms(lambda: flash_decode(q, kd, vd, n)) * 1e3:.2f}"]
            for parts in (1, 2, 4):
                pages = -(-MB // parts)
                pfd.partitions = (lambda *shape, parts=parts, pages=pages:
                                  (parts, pages))
                out = pfd.paged_flash_decode(q, kp, vp, table, lens)
                err = (out.float() - want.float()).abs().max().item()
                if not err <= smoke.KERNEL_TOL:
                    raise AssertionError(f"[{label}, {parts} partitions] "
                                         f"max_abs_err {err}")
                ms = smoke.cuda_ms(
                    lambda: pfd.paged_flash_decode(q, kp, vp, table, lens))
                times.append(f"K2 {parts} partition(s) {ms * 1e3:.2f}")
            nbytes = int(n.long().sum()) * Hkv * D * 2 * 2
            smoke.say(f"{label}: {nbytes / 1e6:.1f} MB of K/V, bound "
                      f"{nbytes / smoke.HBM_BYTES_PER_S * 1e6:.2f} us | "
                      + " | ".join(times) + " (us)")
    finally:
        pfd.partitions = rule


if __name__ == "__main__":
    main()
