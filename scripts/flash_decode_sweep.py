#!/usr/bin/env python3
"""Time K1 (dense flash-decode) over partition counts and variants of its
source, on one CUDA card.

    python3 scripts/flash_decode_sweep.py

At the shapes of ``chip_smoke.kernel_phase`` (B=8, D=128: the qwen main
path H=Hkv=40, GQA H=40 / Hkv=8, dbrx-132b H=48 / 8, command-r-35b H=64
/ 8, all L=392, and command-r's heads over one 4096-row slot among short
ones) and at the rows of ``chip_smoke.paged_kernel_phase``'s long slot
(H=40 / 8, L=4096, two full slots), it prints for each shape the K/V
bytes' bound at 3.35 TB/s and K1's time, warm (``chip_smoke.cuda_ms``:
back-to-back calls on the same K/V, which then sit in the 50 MB L2) and
cold (``chip_smoke.cuda_ms_cold``: L2 flushed before each call, as a
served step finds each layer's K/V):

* under the module's partition rule, and with the rule replaced by a
  fixed count of 1, 2, 4, ... runs;
* under the rule, cycling through copies of K/V whose rows read
  together span more than 256 MB (5 x L2), back to back: a second
  reading of the cold time, with no flush;
* under the rule, for variants of ``csrc/flash_decode.cu`` (``VARIANTS``:
  a constant or a line replaced), each built from its own copy of the
  source into ``kernels/_build/sweep/``, one ``nvcc`` each, all started
  together.

Every output is held against ``flash_decode_torch`` within
``chip_smoke.KERNEL_TOL``.  Imports nothing of the JAX package.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as smoke  # noqa: E402

SHAPES = (  # label, L, H, Hkv, lengths (None: ragged as in kernel_phase)
    ("main path G=1", 392, 40, 40, None),
    ("GQA G=5", 392, 40, 8, None),
    ("dbrx-132b G=6", 392, 48, 8, None),
    ("command-r-35b G=8", 392, 64, 8, None),
    ("long slot G=8", 4096, 64, 8, [4096, 1, 120, 250, 37, 299, 180, 64]),
    ("K2's long-slot rows G=5", 4096, 40, 8,
     [4096, 1, 4096, 120, 250, 37, 299, 180]),
)
# name: (text of the source, its replacement), each found exactly once
_PL = ("      mma(o[nt], pl0, pl2, vf[0], vf[1]);\n"
       "      mma(o[nt + 1], pl0, pl2, vf[2], vf[3]);\n")
VARIANTS = {
    "stages 3": [("constexpr int kStages = 2;", "constexpr int kStages = 3;")],
    "always 8 warps": [("constexpr int kNarrowWarps = 4;",
                        "constexpr int kNarrowWarps = 8;")],
    "always 4 warps": [("constexpr int kWideWarps = 8;",
                        "constexpr int kWideWarps = 4;")],
    "P in bf16, one product": [(_PL, "")],
}
COPIES_BYTES = 256e6  # K/V read by the copies of one cycle, at least


def build_variants() -> dict:
    """``{name: library path}``: each variant's source written beside its
    library in ``kernels/_build/sweep/`` and built there."""
    from repro_torch.kernels import build
    out_dir = build.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC / "flash_decode.cu").read_text()
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise SystemExit(f"variant {name}: the source no longer has "
                                 f"one {old.strip()[:60]!r}")
            text = text.replace(old, new)
        stem = "".join(ch if ch.isalnum() else "_" for ch in name)
        cu, lib = out_dir / f"{stem}.cu", out_dir / f"lib{stem}.so"
        cu.write_text(text)
        procs[name] = lib, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
             "-o", str(lib), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"variant {name} failed to build:\n{out}")
        for line in smoke.ptxas_lines(out):
            if "registers" in line or "spill" in line:
                smoke.say(f"   [{name}] {line}")
        libs[name] = lib
    return libs


def bind(lib: Path):
    """A variant's ``flash_decode_bf16``, with the argument types that
    ``flash_decode._kernel`` gives this checkout's own build."""
    from repro_torch.kernels import flash_decode as fd
    own = fd._kernel()
    fn = ctypes.CDLL(str(lib)).flash_decode_bf16
    fn.argtypes, fn.restype = own.argtypes, own.restype
    return fn


def main() -> None:
    smoke.device_phase()
    smoke.build_phase()
    libs = build_variants()
    import torch
    from repro_torch.kernels import flash_decode as fd
    g = torch.Generator(device="cuda").manual_seed(0)
    B, D = 8, 128

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda",
                           dtype=torch.bfloat16)
    for label, L, H, Hkv, lengths in SHAPES:
        q, k, v = rnd(B, H, D), rnd(B, L, Hkv, D), rnd(B, L, Hkv, D)
        if lengths is None:
            lens = torch.randint(1, L + 1, (B,), generator=g,
                                 device="cuda", dtype=torch.int32)
            lens[0], lens[1] = 1, L
        else:
            lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        want = fd.flash_decode_torch(q, k, v, lens).float()
        n = lens.clamp(1, L).long()
        nbytes = int(n.sum()) * Hkv * D * 2 * 2
        parts, rows = fd.partitions(L)
        smoke.say(f"== {label}: L={L} H={H} Hkv={Hkv}, lengths "
                  f"{lens.tolist()}; {nbytes / 1e6:.2f} MB of K/V, "
                  f"bound {nbytes / smoke.HBM_BYTES_PER_S * 1e6:.2f} us;"
                  f" the rule: {parts} partition(s) of {rows} rows")

        def timed(name, call):
            err = (call().float() - want).abs().max().item()
            if not err <= smoke.KERNEL_TOL:
                raise AssertionError(f"[{label}, {name}] max_abs_err {err}")
            smoke.say(f"   {name}: warm {smoke.cuda_ms(call) * 1e3:.2f} us, "
                      f"cold {smoke.cuda_ms_cold(call) * 1e3:.2f} us "
                      f"(max_abs_err {err:.2e})")
        timed("the rule", lambda: fd.flash_decode(q, k, v, lens))
        tiles = -(-L // fd.TILE_ROWS)
        count = 1
        while count <= min(tiles, fd.MAX_PARTITIONS, 64):
            per = -(-tiles // count)
            fixed = (-(-tiles // per), per * fd.TILE_ROWS)
            with mock.patch.object(fd, "partitions", lambda L, f=fixed: f):
                timed(f"{fixed[0]} partition(s) of {fixed[1]} rows",
                      lambda: fd.flash_decode(q, k, v, lens))
            count *= 2
        copies = [(k, v)] + [(rnd(B, L, Hkv, D), rnd(B, L, Hkv, D))
                             for _ in range(int(COPIES_BYTES // nbytes))]
        turn = iter(range(1 << 62))

        def cycled():
            kc, vc = copies[next(turn) % len(copies)]
            return fd.flash_decode(q, kc, vc, lens)
        smoke.say(f"   the rule over {len(copies)} copies of K/V in turn: "
                  f"{smoke.cuda_ms(cycled) * 1e3:.2f} us")
        del copies
        for name, lib in libs.items():
            with mock.patch.object(fd, "_kernel", lambda f=bind(lib): f):
                timed(f"variant {name}",
                      lambda: fd.flash_decode(q, k, v, lens))
        del q, k, v
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
