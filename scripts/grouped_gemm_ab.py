#!/usr/bin/env python3
"""Time K7 / K8 (the MoE layers' grouped GEMM) on one CUDA card for the
checkout at ``--root``.

    python3 scripts/grouped_gemm_ab.py [--root DIR] [--label NAME] [--serve]

``DIR`` (default: this checkout) is a checkout of the repository; its
``chip_smoke.py`` and ``src/`` are imported and its
``csrc/grouped_gemm.cu`` is built, so two checkouts (say, an unpacked
``git archive`` of a parent commit and the working tree) can be compared
in one run on one card: parent, change, change, parent.  At
``chip_smoke``'s shapes (``GG_SHAPES``: dbrx-132b's and
deepseek-v3-671b's prefill and decode products, K7; ``GG_TRAIN_SHAPE``:
dbrx's training shape, K8) with its seeded routing, it prints one JSON
line: each shape's warm device time a call (``chip_smoke.cuda_ms``) and
the host's time to issue one call through the wrapper
(``chip_smoke.host_us``: checks, tensor maps, launch), the output held
against the plain version within ``chip_smoke.GG_TOL``, and the card's
name and power limit.  With ``--serve`` it then serves dbrx-132b FULL
cut to 10 layers (seeded bf16 weights, chip_smoke's MoE phase) on the
dense engine at chip_smoke's main-path settings, 16 requests under
``FixedPolicy(0)`` (``chip_smoke._drive``), and adds the median decode
step (per-step device time of the chunks, CUDA events) and the median
prefill of an admission group (device time of prefill + commit).
Imports nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent
                                          .parent))
    ap.add_argument("--label", default="")
    ap.add_argument("--serve", action="store_true")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root), str(root / "src")]
    import torch

    import chip_smoke as smoke
    from repro_torch.kernels import build
    from repro_torch.kernels.grouped_gemm import (grouped_gemm,
                                                  grouped_gemm_dw_torch,
                                                  grouped_gemm_torch)
    if not torch.cuda.is_available():
        raise SystemExit("grouped_gemm_ab: torch sees no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    build.build_all(["grouped_gemm"])
    k8 = torch.ops.repro_torch.grouped_gemm_dw
    g = torch.Generator(device="cuda").manual_seed(7)
    rows = {}
    for label, T, k, E, d, f in smoke.GG_SHAPES + (smoke.GG_TRAIN_SHAPE,):
        offsets, _ = smoke._gg_routing(T, k, E, g)
        M = T * k
        x = torch.randn(M, d, generator=g, device="cuda").bfloat16()
        if label == smoke.GG_TRAIN_SHAPE[0]:
            dy = torch.randn(M, f, generator=g, device="cuda").bfloat16()

            def call():
                return k8(x, dy, offsets)
            want = grouped_gemm_dw_torch(x, dy, offsets, T)
        else:
            w = (torch.randn(E, d, f, generator=g, device="cuda")
                 * d ** -0.5).bfloat16()

            def call():
                return grouped_gemm(x, w, offsets, T)
            want = grouped_gemm_torch(x, w, offsets, T)
        err = smoke._gg_rel_err(call(), want)
        if not err <= smoke.GG_TOL:
            raise AssertionError(f"{label}: max |err| / max |want| {err}")
        rows[label] = {"ms": smoke.cuda_ms(call, 20),
                       "host_us": smoke.host_us(call, 50), "err": err}
        del x, want
        torch.cuda.empty_cache()
    out = {"label": args.label, "root": str(root), "card": card,
           "rows": rows}
    if args.serve:
        del w
        torch.cuda.empty_cache()
        out["dbrx"] = serve_dbrx(smoke, card)
    print(json.dumps(out), flush=True)


def serve_dbrx(smoke, card: str) -> dict:
    """dbrx-132b (10 layers) on the dense engine: the median decode step
    and admission group's prefill, ms (device time, CUDA events)."""
    import statistics

    from repro_torch.data import HashTokenizer, SyntheticSquad
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.grouped_gemm import grouped_gemm
    from repro_torch.retrieval import BM25Index
    from repro_torch.routing import ContinuousEngineBackend, FixedPolicy
    smoke.build_phase()
    cfg, model, params = smoke._build_family(smoke.DBRX, 10, card, "a/b")
    data = SyntheticSquad(n_paragraphs=600, n_questions=1000, seed=0)
    index = BM25Index.build([p.text for p in data.paragraphs])
    backend = ContinuousEngineBackend.create(
        model, params, HashTokenizer(cfg.vocab_size), index,
        num_slots=smoke.NUM_SLOTS, prefill_batch=smoke.PREFILL_BATCH,
        max_prompt_len=smoke.MAX_PROMPT_LEN,
        max_new_tokens=smoke.MAX_NEW_TOKENS)
    counters = {"flash_decode": flash_decode, "grouped_gemm": grouped_gemm}
    run = smoke._drive("a/b dbrx-132b dense", backend, index,
                       data.questions[-16:], 2, card, cfg.n_layers,
                       counters, FixedPolicy(0))
    sync_every = backend.engine.executor.sync_every
    rec = run["rec"]
    return {"decode_step_ms": statistics.median(
                s.elapsed_time(e) / sync_every for s, e in rec["chunks"]),
            "prefill_ms": statistics.median(
                s.elapsed_time(e) for s, e in rec["admits"]),
            "launches": run["launches"]}


if __name__ == "__main__":
    main()
