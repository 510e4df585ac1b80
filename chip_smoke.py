#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each on its own lines; any failure exits nonzero:

1. device    — the card's name and power limit (``nvidia-smi``); no CUDA
               device is a failure.
2. build     — compile every hand-written kernel from ``src/`` (one
               ``nvcc`` per source, concurrently) and print the build
               seconds and the ``-Xptxas -v`` report.
3. kernels   — hold each decode kernel against its plain PyTorch version
               in bf16 at the main path's shapes and time the kernel, the
               plain version, the bound and a library yardstick: K1
               flash_decode (dense slot cache), K2 paged_flash_decode
               (block table into a page pool, with a parked slot; the
               main path, GQA and one 4096-row slot among short ones,
               each also through K1 on the same rows gathered, with each
               wrapper's host time a call).
4. retrieval — the batched retrieval path at the SQuAD scale (20,000
               synthetic paragraphs, 64 questions, k = 10):
               ``DenseIndex.topk_batch`` (K3 dense_topk) and
               ``BM25Index.scores_batch`` (K5 on the index's nonzeros,
               ``device_csr``, uploaded once and timed) once each,
               counted; each held against its plain version in float32
               and the host's numpy retrieval (ids identical but for ties
               within 1e-5), and timed; K5's whole call (its row's time)
               and its kernel alone (``kernel_ms``), also on a dense
               ``tf`` (its compaction timed with it), beside two
               yardsticks (cuBLAS ``wq @ sat.T`` and ``torch.sparse.mm``
               on a CSR of the saturated values) and three bounds (what
               the batch's terms need, every nonzero, the dense matrix);
               K3 again on 1,048,576 seeded unit rows (1 GiB).  K3's
               HGMMA (wgmma) count in its SASS first (none is a failure);
               each K3 row with its bound on the TF32 tensor cores it
               feeds beside the float32 CUDA-core basis of the kernel it
               replaced, the wrapper's time a call on the host's clock
               and the kernels one call launches (one); then K3 across
               its contract against the plain version: k = 64 (timed
               beside k = 10), Q = 5 and 200, D < 64, E = 768, and rows
               duplicated into other tiles and blocks (ids exact).
5. small     — the SMOKE decoder in bf16: prefill + decode on the card
               against the same weights on the host; then every weight
               NaN, 2 requests on 2 slots: the executor's isfinite test
               on the card trips both and the scheduler quarantines them;
               with ``health_checks=False`` nothing trips.
6. router    — the paper's router on the FULL testbed
               (``configs/paper_slo_router.py``: 800 / 200 questions over
               600 paragraphs, 30 epochs): ``run_experiment`` builds the
               offline log on the host (its seconds printed) and trains
               the six policies of Table 1 on the card (each training's
               wall and ms an epoch), prints the grid and checks the
               paper's failure mode (cheap Argmax-CE refuses > 0.5 with
               acc < 0.2 and a reward under best-fixed's; quality_first
               Argmax-CE within 0.1 of best-fixed, refusing < 0.8; the
               constrained objective (cap 0.45) refusing less with a
               higher acc, on the mean over the draws of seeds 0..19,
               each draw printed: at this cap one draw decides it); then
               quality_first Argmax-CE trained from one host-drawn init on
               the card and on the host (at most 2 of 200 eval actions
               may disagree; the largest parameter difference and each
               disagreeing action's top-two logit margin printed) and the
               time to route a micro-batch; one ``ConditionedPolicy`` for
               both profiles (cheap must refuse more); the quickstart's
               ``Gateway`` + ``SimulatorBackend`` under cheap, 60 requests.
7. main      — ``qwen1.5-32b`` FULL (64 layers, d_model 5120, seeded
               bf16 weights) served through ``Gateway.serve`` on the
               dense slot cache, with the bm25, dense and hybrid
               retrievers behind a shared retrieval cache: 8 requests
               under ``FixedPolicy(0)``, 8 routed by the quality_first
               router trained in phase 6 (both bm25).  Checks that K1
               was launched 64 times per decode step, that no slot was
               quarantined, that every generating request produced a
               token and that at least one of the router's 8 generated.
8. profile   — 8 more requests under ``torch.profiler``: the card's busy
               and idle share and the kernels that take its time.
9. hybrid    — the same engine under the ``hybrid9`` action space:
               ``FixedPolicy(3)`` (dense retrieval) and ``FixedPolicy(7)``
               (bm25 + dense fusion), 4 questions twice each; checks
               cache hits, no degraded lookup, K1 launches, and prints
               this phase's decode steps on their own lines.
9a. open loop — the closed loop's served rate c and request-latency
               p50 set deadline_ms = 2 x p50 rounded up to 100 ms; seeded
               Poisson traces (24 requests, quality_first, questions of
               their own) at 0.5, 0.75, 1.0 and 1.5 x c replayed in real
               time through ``AsyncGateway`` + the stream protocol on the
               same engine, served by the gateway's background thread:
               per rate the nominal, trace and submitted rates, served,
               shed, forced refusals, depth clamps, goodput, latency
               p50/p99, first-token p50, K1 launches; the highest rate
               whose goodput fraction meets the latency objective (0.90).
               Checks every request resolved, the thread on cuda:0's
               default stream and stopped, K1 64 times a decode step.
9b. chaos    — the dense engine freed; ``benchmarks/chaos_bench.py``'s
               four plans (no faults, retriever brownout, executor fault
               burst, NaN storm) in virtual time, 24 requests each on a
               fresh engine of the main path's shape: counters printed;
               every request resolves, no_faults counts nothing and its
               tokens equal a features-off run's, the brownout degrades
               and fails none, the burst's transient completions are
               retried or counted faulted, the storm quarantines its
               plan's slots; K1 64 times a decode step.
9c. padded   — ``Engine.generate`` (per-call cache, K1) against
               ``ContinuousEngine.generate_many`` on 8 prompts of 384
               tokens: tokens identical, walls and decode steps; then a
               batch of 8 through ``Gateway.serve`` over ``EngineBackend``.
10. paged    — the dense engine's buffers freed, the same 16 requests
               on the paged engine (page size 8, 400 pages, prefix
               sharing): K2 launched 64 times per decode step, K1 only
               64 times for each admission group whose suffix is one
               token (every page of its prompts but the last token a
               prefix hit: that prefill's single query takes the decode
               branch over the dense scratch), every request served,
               prompt tokens served from shared pages, no deferral;
               prints the prefix-hit rate, forks, peak pages, ms per
               decode step and the greedy tokens that agree with the
               dense phase's; then the 1.0 x c trace of 9a on the paged
               engine (the same launch accounting), with its prefix-hit
               rate.
11. int8     — the paged engine with the int8 KV cache, 8 requests under
               ``FixedPolicy(0)``: K2 launches, no quarantine, tokens.
12. train    — the serving weights freed, ``make_train_step`` (fused
               loss, plain attention, AdamW) for 8 steps on
               ``qwen1.5-32b`` at full width with its depth cut 64 -> 4
               (seeded bf16 weights, ``remat="full"``), over the port's
               ``LMDataset`` at batch 4 x seq 1024: finite loss and
               gradient norm, params moved, the loss falling, no K4
               launch; ms per step, tokens/s, model FLOPs/s, peak
               memory, the AdamW update and the forward timed alone, the
               device time of one step by kernel, and one loss and
               gradient under each of remat none / full / dots (the
               same numbers, each mode's peak memory).
13. eval     — on the trained params, a held batch through
               ``make_eval_step`` with K4 and with the plain attention:
               K4 launched 4 times (once a layer), the losses agreeing;
               ``forward_train_loss`` under ``no_grad`` with K4; a train
               step through K4 raising the gradient guard.
14. mamba serve — ``mamba2-130m`` FULL (24 layers, d_model 768, seeded
               bf16 weights, not cut) through ``Gateway.serve`` on the
               dense slot engine, 8 + 8 requests as in phase 7 (the
               trained router routes the second 8): no kernel launched
               (the cached prefill and the O(1) decode step never take
               K6), every request served, each engine token the greedy
               choice of a per-request prefill/decode loop on the card;
               decode step and prefill ms, peak memory.
15. mamba eval — a held batch of 4 x 2048 through ``make_eval_step``
               with K6 (24 launches a call) and with the plain scan: the
               losses agreeing; both timed.
16. mamba train — ``make_train_step`` for 8 steps at 4 x 2048 with the
               chunk cut 256 -> 64: finite, falling losses, no K6
               launch; ms per step, tokens/s, peak memory; the gradient
               norm at chunk 256 (NaN, as the reference's); a train step
               through K6 raising the gradient guard.
17. cli      — ``python -m repro_torch.launch.train`` twice at once, in
               subprocesses on the card: qwen SMOKE and the defaults
               (mamba2-130m SMOKE), 20 steps each: each loss falls, and
               each npz checkpoint loads back equal through
               ``load_checkpoint``.

The kernel checks (phase 3) include K4 flash_attention: first the count
of HGMMA (wgmma) instructions in its SASS (``cuobjdump -sass``; none is a
failure) and its ``-Xptxas -v`` lines; then the training shape (B=4,
S=1024, H=Hkv=40, D=128, causal), GQA G=2, a non-causal ragged case,
D=64 and a causal Sq != Skv case, each against its plain version; the
training shape is timed beside its bound and SDPA.  Kernel times are
CUDA-event means of back-to-back calls after the card has been given a
head start (a spin longer than the host's enqueueing), so that they time
the card and not the host's launch rate.  And K6
ssd_chunk_scan: mamba2-130m's evaluation shape (B=4, S=2048, H=24,
hd=64, N=128, chunk 256, bf16, A_log = 0), G=2 H=8, chunks 64 and 128,
S < chunk, the reference test's shape and rows off 16-byte boundaries
(strided x, B, C; N=18), each against its plain
version in float32 within 5e-5 of max |y|; first the count of HMMA
(mma.sync) instructions in its SASS (none is a failure); the evaluation
shape is timed beside its bound -- bytes, or its operations on the bf16
tensor cores it feeds, with the float32 CUDA-core basis printed beside
-- and the device time of each of its three launches (no PyTorch call
computes the scan: no library time).

The last three lines are the JSON kernel table, the card's name and
power limit (``nvidia-smi``), and the ``{"ok": true, ...}`` device
record.  Imports nothing of the JAX package.
"""
from __future__ import annotations

import ctypes
import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 tensor cores
TF32_OPS_PER_S = 495e12        # H100 SXM dense TF32 tensor cores
FP32_OPS_PER_S = 67e12         # H100 SXM float32 on CUDA cores
NUM_SLOTS, PREFILL_BATCH = 8, 4
MAX_PROMPT_LEN, MAX_NEW_TOKENS = 384, 8
PAGE_SIZE, NUM_PAGES = 8, 400  # max_len 392 = 49 pages; tables of 50
KERNEL_TOL = 2e-2  # bf16 output: |out| <~ 3 rounds at 2^-8 relative, plus
#                    the kernel's fp32 sums in another order
RETRIEVAL_TOL = 1e-5  # float32 scores: the same sums in another order
SQUAD_PARAGRAPHS, SQUAD_QUESTIONS, TOP_K = 20000, 64, 10
BIG_DOCS = 1 << 20    # 1 GiB of float32 rows at E = 256
BM25_HOST_QUESTIONS = 8  # BM25Index.topk saturates all of tf per question
# training: full width, depth cut so params, gradients and AdamW moments
# (12 B a param) fit one 80 GB card beside the activations
TRAIN_LAYERS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 4, 1024, 4, 8
EVAL_RTOL = 5e-3  # bf16 activations: K4 rounds P to bf16 and sums in
#                   another order than the plain float32 attention
REMAT_RTOL = 1e-3  # the same forward; bf16 gradients summed by atomics in
#                    an order that may change from run to run
SSD_RTOL = 5e-5   # of max |y|, float32 before the final rounding: the same
#                   sums in another order (the reference's kernel test's)
MAMBA = "mamba2-130m"
MAMBA_EVAL_SEQ, MAMBA_BATCH = 2048, 4
MAMBA_TRAIN_CHUNK, MAMBA_TRAIN_STEPS = 64, 8
MAMBA_EVAL_RTOL = 1e-3  # bf16 activations; both scans sum in float32
TOKEN_GAP_RTOL = 2e-2   # of max |logit|: bf16 rounding of a batch of 8
#                         against a batch of 1
ROUTER_CAP = 0.45        # the constrained objective's refusal cap
ROUTER_SEEDS = 20        # draws the constrained objective is held over
ROUTER_MAX_DISAGREE = 2  # of 200 eval actions, card vs host training: the
#                          same float32 steps, sums in another order
# the open loop: Poisson traces at these multiples of the closed loop's
# served rate, replayed in real time through AsyncGateway's thread
OPEN_LOOP_RATES, OPEN_LOOP_REQUESTS = (0.5, 0.75, 1.0, 1.5), 24
# chaos: benchmarks/chaos_bench.py's rate, deadline and pump quantum (all
# virtual time), retry policy and breaker settings
CHAOS_REQUESTS, CHAOS_RATE = 24, 120.0
CHAOS_DEADLINE_MS, CHAOS_QUANTUM_S = 800.0, 0.01
CHAOS_BREAKER = dict(window=8, min_calls=4, failure_threshold=0.5,
                     cooldown=4)


def say(*a) -> None:
    print(*a, flush=True)


def device_phase():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    say(f"== device: {torch.cuda.get_device_name(0)} "
        f"(count {torch.cuda.device_count()}), torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    say(f"   nvidia-smi: {card}")
    # float32 comparisons run in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def ptxas_lines(compiler_output: str) -> list:
    """The ``-Xptxas -v`` lines of one source's build (registers, shared
    memory, spills) and its warnings."""
    return [line.strip() for line in compiler_output.splitlines()
            if any(w in line for w in ("register", "smem", "spill",
                                       "arning", "Performance"))]


def build_phase() -> dict:
    """Builds every kernel source; returns ``build.build_all``'s report,
    ``{source: {"seconds", "compiler_output"}}``."""
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    report = build.build_all()
    say(f"== build: {len(report)} kernel source(s) in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, r in report.items():
        say(f"   {name}: nvcc {r['seconds']:.2f} s")
        for line in ptxas_lines(r["compiler_output"]):
            say(f"     {line}")
    return report


def sass_count(name: str, opcode: str) -> int:
    """How many instructions of the built ``csrc/<name>.cu`` library's
    SASS (``cuobjdump -sass``) carry ``opcode``."""
    from repro_torch.kernels import build
    cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass",
                           str(build.library_path(name))],
                          capture_output=True, text=True, check=True).stdout
    return sum(opcode in line for line in sass.splitlines())


def cuda_ms(fn, iters: int = 100) -> float:
    """Mean device time of one ``fn()`` call, by CUDA events around
    ``iters`` back-to-back calls after a warm-up.  The card first spins
    for longer than the host takes to enqueue the calls, so the events
    time the calls back to back on the card and not the host's launch
    rate."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = (time.perf_counter() - t0) * iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # 2e9 cycles a second bounds the SM clock from above; at most 2 s
    torch.cuda._sleep(int(min(2.0, 1.5 * host_s + 1e-3) * 2e9))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_phase() -> dict:
    """K1 flash_decode against its plain version at the main path's
    shape and a GQA shape.  Returns the main-path row of the table."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_torch)
    tol = KERNEL_TOL
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for label, B, L, H, Hkv, D in (
            ("main path", 8, 392, 40, 40, 128),
            ("GQA", 8, 392, 40, 8, 128)):
        def rnd(*shape):
            return torch.randn(shape, generator=g, device="cuda",
                               dtype=torch.bfloat16)
        q, k, v = rnd(B, H, D), rnd(B, L, Hkv, D), rnd(B, L, Hkv, D)
        lens = torch.randint(1, L + 1, (B,), generator=g, device="cuda",
                             dtype=torch.int32)
        lens[0], lens[1] = 1, L          # ragged, with both extremes
        out = flash_decode(q, k, v, lens)
        want = flash_decode_torch(q, k, v, lens)
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs().max().item()
        # the yardstick: one library call computing the same function
        mask = (torch.arange(L, device="cuda")[None, :]
                < lens[:, None])[:, None, None, :]
        kt, vt, q4 = k.transpose(1, 2), v.transpose(1, 2), q[:, :, None]

        def library():
            return F.scaled_dot_product_attention(q4, kt, vt, attn_mask=mask,
                                                  enable_gqa=True)
        lib_err = (library()[:, :, 0].float() - want.float()).abs().max()
        ms = cuda_ms(lambda: flash_decode(q, k, v, lens))
        plain_ms = cuda_ms(lambda: flash_decode_torch(q, k, v, lens))
        library_ms = cuda_ms(library)
        n = lens.clamp(1, L).long()
        nbytes = (q.numel() * 2 + int(n.sum()) * Hkv * D * 2 * 2
                  + B * 4 + B * H * D * 2)
        nops = int(n.sum()) * H * D * 4
        bound_ms = max(nbytes / HBM_BYTES_PER_S,
                       nops / BF16_OPS_PER_S) * 1e3
        say(f"== kernel flash_decode [{label}: B={B} L={L} H={H} "
            f"Hkv={Hkv} D={D}, lengths {lens.tolist()}]")
        say(f"   max_abs_err {err:.3e} (tol {tol:.0e}); library "
            f"max_abs_err {float(lib_err):.3e}")
        say(f"   kernel {ms * 1e3:.2f} us | plain {plain_ms * 1e3:.2f} us | "
            f"library {library_ms * 1e3:.2f} us | bound "
            f"{bound_ms * 1e3:.2f} us ({nbytes / 1e6:.2f} MB)")
        if not err <= tol:
            raise AssertionError(f"flash_decode [{label}] disagrees with "
                                 f"its plain version: {err} > {tol}")
        rows.append(dict(name="flash_decode", route="cuda",
                         source="src/repro_torch/kernels/csrc/flash_decode.cu",
                         replaces="src/repro/kernels/flash_decode.py:138",
                         max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by="bytes",
                         library_ms=library_ms))
        del q, k, v, out, want
    torch.cuda.empty_cache()
    return rows[0]


def host_us(fn, calls: int = 200) -> float:
    """The host's time to issue one ``fn()`` call (wrapper, checks and
    launch), by the host clock around ``calls`` back-to-back calls that
    the card does not hold up."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def paged_kernel_phase() -> dict:
    """K2 paged_flash_decode against its plain version at the paged main
    path's shape (page size 8, 50-block tables into 400 pages), a GQA
    shape, and a long slot (page size 16, 256-block tables, one slot of
    4096 rows among short ones), through a shuffled table whose entries
    past each slot's length are stale out-of-range ids, with a slot
    parked at max_blocks * page_size + 1 as an idle slot is.  Each case
    is also timed through K1 on the same rows gathered into a dense cache,
    and the wrappers' host time a call is printed.  Returns the main-path
    row of the table."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.paged_flash_decode import (
        paged_flash_decode, paged_flash_decode_torch, partitions)
    g = torch.Generator(device="cuda").manual_seed(1)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    B, H, D = 8, 40, 128
    rows = []
    for label, Hkv, ps, MB, NP in (
            ("main path", 40, PAGE_SIZE, 50, NUM_PAGES),
            ("GQA", 8, PAGE_SIZE, 50, NUM_PAGES),
            ("long slot", 8, 16, 256, 2048)):
        def rnd(*shape):
            return torch.randn(shape, generator=g, device="cuda",
                               dtype=torch.bfloat16)
        q, kp, vp = rnd(B, H, D), rnd(NP, ps, Hkv, D), rnd(NP, ps, Hkv, D)
        table = torch.randperm(NP, generator=g, device="cuda")[:B * MB]
        table = table.reshape(B, MB).to(torch.int32)
        if label == "long slot":
            lens = torch.randint(1, 300, (B,), generator=g, device="cuda",
                                 dtype=torch.int32)
            lens[0], lens[1], lens[2] = MB * ps, 1, MB * ps + 1
        else:
            lens = torch.randint(1, MB * ps - ps + 1, (B,), generator=g,
                                 device="cuda", dtype=torch.int32)
            lens[0], lens[1], lens[2] = 1, MB * ps + 1, MB * ps - ps
        n = lens.clamp(1, MB * ps)
        # stale ids past each slot's allocation: clamped, never read
        past = (torch.arange(MB, device="cuda")[None, :] * ps
                >= n[:, None])
        table[past] = NP + 7
        out = paged_flash_decode(q, kp, vp, table, lens)
        want = paged_flash_decode_torch(q, kp, vp, table, lens)
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs().max().item()
        # the yardstick: SDPA over the rows already gathered (the
        # gather is excluded: no single PyTorch call reads a table); K1
        # over the same gathered rows
        tab = table.long().clamp(0, NP - 1)
        kd = kp[tab].reshape(B, MB * ps, Hkv, D)
        vd = vp[tab].reshape(B, MB * ps, Hkv, D)
        kt, vt = kd.transpose(1, 2), vd.transpose(1, 2)
        mask = (torch.arange(MB * ps, device="cuda")[None, :]
                < n[:, None])[:, None, None, :]
        q4 = q[:, :, None]

        def library():
            return F.scaled_dot_product_attention(q4, kt, vt, attn_mask=mask,
                                                  enable_gqa=True)
        lib_err = (library()[:, :, 0].float() - want.float()).abs().max()
        k1_err = (flash_decode(q, kd, vd, n).float()
                  - want.float()).abs().max().item()
        ms = cuda_ms(lambda: paged_flash_decode(q, kp, vp, table, lens))
        plain_ms = cuda_ms(
            lambda: paged_flash_decode_torch(q, kp, vp, table, lens))
        library_ms = cuda_ms(library)
        k1_ms = cuda_ms(lambda: flash_decode(q, kd, vd, n))
        k2_host = host_us(lambda: paged_flash_decode(q, kp, vp, table, lens))
        k1_host = host_us(lambda: flash_decode(q, kd, vd, n))
        parts, part_pages = partitions(MB, ps, B, Hkv, sms)
        nbytes = (q.numel() * 2 + int(n.long().sum()) * Hkv * D * 2 * 2
                  + table.numel() * 4 + B * 4 + B * H * D * 2)
        nops = int(n.long().sum()) * H * D * 4
        bound_ms = max(nbytes / HBM_BYTES_PER_S,
                       nops / BF16_OPS_PER_S) * 1e3
        say(f"== kernel paged_flash_decode [{label}: B={B} H={H} Hkv={Hkv} "
            f"D={D} page_size={ps} max_blocks={MB} num_pages={NP}, lengths "
            f"{lens.tolist()}; {parts} partition(s) of {part_pages} pages "
            f"on {sms} SMs]")
        say(f"   max_abs_err {err:.3e} (tol {KERNEL_TOL:.0e}); library "
            f"max_abs_err {float(lib_err):.3e}; K1 on the gathered rows "
            f"max_abs_err {k1_err:.3e}")
        say(f"   kernel {ms * 1e3:.2f} us | plain {plain_ms * 1e3:.2f} us | "
            f"library (SDPA on pre-gathered rows) {library_ms * 1e3:.2f} us "
            f"| bound {bound_ms * 1e3:.2f} us ({nbytes / 1e6:.2f} MB) | K1 "
            f"on the same rows, gathered {k1_ms * 1e3:.2f} us")
        say(f"   host time a call: paged_flash_decode {k2_host:.2f} us, "
            f"flash_decode {k1_host:.2f} us")
        if not (err <= KERNEL_TOL and k1_err <= KERNEL_TOL):
            raise AssertionError(f"paged_flash_decode [{label}] disagrees "
                                 f"with its plain version: {err}")
        rows.append(dict(
            name="paged_flash_decode", route="cuda",
            source="src/repro_torch/kernels/csrc/paged_flash_decode.cu",
            replaces="src/repro/kernels/flash_decode.py:84",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by="bytes", library_ms=library_ms, host_us=k2_host))
        del q, kp, vp, out, want, kd, vd, kt, vt
    torch.cuda.empty_cache()
    return rows[0]


def attention_kernel_phase(build_report: dict) -> dict:
    """K4 flash_attention against its plain version in bf16: the training
    shape (B=4, S=1024, H=Hkv=40, D=128, causal), then GQA G=2, a
    non-causal case with Sq != Skv and ragged tiles, D=64 (SMOKE), and a
    causal Sq != Skv case.  The training shape is timed beside its bound
    and SDPA; its HGMMA count and its ptxas lines (from ``build_report``,
    ``build_phase``'s) are printed first.  Returns the training shape's
    row of the table."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_torch)
    hgmma = sass_count("flash_attention", "HGMMA")
    ptxas = ptxas_lines(build_report["flash_attention"]["compiler_output"])
    say(f"== kernel flash_attention: {hgmma} HGMMA instruction(s) in its "
        f"SASS; ptxas: {' | '.join(ptxas)}")
    if not hgmma:
        raise AssertionError("flash_attention's SASS has no HGMMA: the "
                             "products do not run on wgmma")
    g = torch.Generator(device="cuda").manual_seed(2)
    row = None
    for label, B, Sq, Skv, H, Hkv, D, causal in (
            ("training shape", 4, 1024, 1024, 40, 40, 128, True),
            ("GQA G=2", 2, 512, 512, 16, 8, 128, True),
            ("non-causal, G=4, ragged", 2, 320, 448, 8, 2, 128, False),
            ("SMOKE D=64", 2, 256, 256, 4, 4, 64, True),
            ("causal Sq != Skv", 1, 200, 136, 4, 4, 64, True)):
        def rnd(*shape):
            return torch.randn(shape, generator=g, device="cuda",
                               dtype=torch.bfloat16)
        q, k, v = rnd(B, Sq, H, D), rnd(B, Skv, Hkv, D), rnd(B, Skv, Hkv, D)
        with torch.no_grad():
            out = flash_attention(q, k, v, causal=causal)
            want = flash_attention_torch(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs().max().item()
        say(f"== kernel flash_attention [{label}: B={B} Sq={Sq} Skv={Skv} "
            f"H={H} Hkv={Hkv} D={D} causal={causal}]: max_abs_err "
            f"{err:.3e} (tol {KERNEL_TOL:.0e})")
        if not err <= KERNEL_TOL:
            raise AssertionError(f"flash_attention [{label}] disagrees with "
                                 f"its plain version: {err}")
        if row is None:
            # the yardstick: SDPA on (B, H, S, D) views of the same tensors
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

            def library():
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=True)
            lib_err = (library().transpose(1, 2).float()
                       - want.float()).abs().max().item()
            with torch.no_grad():
                ms = cuda_ms(lambda: flash_attention(q, k, v))
                plain_ms = cuda_ms(lambda: flash_attention_torch(q, k, v),
                                   10)
            library_ms = cuda_ms(library)
            nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2
            pairs = Sq * (Sq + 1) // 2          # (q, kv) pairs attended
            nops = 4 * B * H * D * pairs
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / BF16_OPS_PER_S
            bound_ms = max(t_bytes, t_ops) * 1e3
            bound_by = "bytes" if t_bytes >= t_ops else "operations"
            say(f"   kernel {ms * 1e3:.2f} us | plain {plain_ms * 1e3:.2f} us"
                f" | library (SDPA, is_causal) {library_ms * 1e3:.2f} us, "
                f"max_abs_err {lib_err:.3e} | bound {bound_ms * 1e3:.2f} us "
                f"({nbytes / 1e6:.1f} MB: {t_bytes * 1e6:.2f} us; "
                f"{nops / 1e9:.2f} GFLOP: {t_ops * 1e6:.2f} us; {bound_by}); "
                f"kernel at {nops / ms / 1e9:.1f} TFLOP/s")
            row = dict(
                name="flash_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:63",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)
        del q, k, v, out, want
    torch.cuda.empty_cache()
    return row


def ssd_ops(B, S, H, hd, N, c) -> int:
    """The float32 operations an SSD scan needs: the causal half of the
    two intra-chunk products in every chunk, and the inter-chunk term
    and the state update in every chunk with a state before or after it
    (the first chunk's state is zero, the last one's is not returned)."""
    nc = S // c
    pairs = c * (c + 1) // 2
    return B * H * (nc * pairs * 2 * (N + hd) + (nc - 1) * 2 * 2 * c * hd * N)


def ssd_kernel_phase() -> dict:
    """K6 ssd_chunk_scan against its plain version: the evaluation shape
    of mamba2-130m FULL (B=4, S=2048, H=24, hd=64, G=1, N=128, chunk 256,
    bf16 inputs, A_log = 0 so that exp(cum_t - cum_s) overflows above the
    diagonal), G=2 H=8, chunks 64 and 128, S < chunk, the reference
    test's shape, and x, B and C read through strides that split their
    rows off 16-byte boundaries.  Compared in float32 before the final rounding, within
    SSD_RTOL of max |y|; the bf16 output must be the float32 one rounded.
    The evaluation shape is timed beside its bound: the larger of its
    bytes and its operations on the bf16 tensor cores that the kernel
    feeds, with the float32 CUDA-core basis of the kernel it replaced
    printed beside it, and the device time of each of its three
    launches.  The count of tensor-core (HMMA) instructions in its SASS
    is printed first; none is a failure.  Returns its row."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.ssd_scan import (ssd_chunk_scan,
                                              ssd_chunk_scan_torch)
    hmma = sass_count("ssd_scan", "HMMA")
    say(f"== kernel ssd_chunk_scan: {hmma} HMMA (mma.sync) instruction(s) "
        f"in its SASS")
    if not hmma:
        raise AssertionError("ssd_scan's SASS has no HMMA: the products do "
                             "not run on the tensor cores")
    g = torch.Generator(device="cuda").manual_seed(3)
    row = None
    for label, B, S, H, hd, G, N, chunk, dtype in (
            ("eval shape", 4, 2048, 24, 64, 1, 128, 256, torch.bfloat16),
            ("G=2 H=8", 2, 1024, 8, 64, 2, 64, 256, torch.float32),
            ("chunk 64", 2, 1024, 24, 64, 1, 128, 64, torch.bfloat16),
            ("chunk 128", 2, 1024, 24, 64, 1, 128, 128, torch.bfloat16),
            ("S < chunk", 2, 200, 8, 64, 1, 128, 256, torch.float32),
            ("reference test shape", 2, 256, 4, 32, 2, 16, 32,
             torch.float32),
            # rows that are not whole 16-byte pieces: the staging's
            # element-by-element path
            ("strided rows", 2, 256, 4, 40, 1, 18, 64, torch.bfloat16)):
        pad = 3 if label == "strided rows" else 0

        def rnd(*shape, scale=1.0):
            wide = (*shape[:-1], shape[-1] + pad)
            return (torch.randn(wide, generator=g, device="cuda")
                    * scale).to(dtype)[..., :shape[-1]]
        x = rnd(B, S, H, hd)
        Bm, Cm = rnd(B, S, G, N, scale=0.5), rnd(B, S, G, N, scale=0.5)
        dt = F.softplus(torch.randn((B, S, H), generator=g,
                                    device="cuda")).to(dtype)
        A_log = (torch.zeros(H, device="cuda") if G == 1 else
                 torch.randn(H, generator=g, device="cuda") * 0.3).to(dtype)
        args = (x, Bm, Cm, dt, A_log)
        with torch.no_grad():
            y32 = ssd_chunk_scan(*args, chunk=chunk, out_dtype=torch.float32)
            y = ssd_chunk_scan(*args, chunk=chunk)
            want = ssd_chunk_scan_torch(*args, chunk=chunk,
                                        out_dtype=torch.float32)
        torch.cuda.synchronize()
        c = min(chunk, S)
        err = (y32 - want).abs().max().item()
        rel = err / want.abs().max().item()
        fall = float((dt.float() * -torch.exp(A_log.float())).reshape(
            B, S // c, c, H).sum(2).min())
        rounded = torch.equal(y, y32.to(dtype))
        say(f"== kernel ssd_chunk_scan [{label}: B={B} S={S} H={H} hd={hd} "
            f"G={G} N={N} chunk {c}, {str(dtype)[6:]}]: max_abs_err "
            f"{err:.3e}, relative to max |y| {rel:.3e} (tol "
            f"{SSD_RTOL:.0e}); cum falls to {fall:.1f} within a chunk; "
            f"finite {bool(torch.isfinite(y32).all())}; {str(dtype)[6:]} "
            f"output = float32 output rounded: {rounded}")
        if not (rel <= SSD_RTOL and torch.isfinite(y32).all() and rounded
                and y.dtype == dtype):
            raise AssertionError(f"ssd_chunk_scan [{label}] disagrees with "
                                 f"its plain version: {rel}")
        if row is None:
            with torch.no_grad():
                ms = cuda_ms(lambda: ssd_chunk_scan(*args, chunk=chunk), 20)
                plain_ms = cuda_ms(
                    lambda: ssd_chunk_scan_torch(*args, chunk=chunk), 5)
            nbytes = sum(t.numel() * t.element_size()
                         for t in (*args, y))
            nops = ssd_ops(B, S, H, hd, N, c)
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / BF16_OPS_PER_S
            fp32_bound_ms = nops / FP32_OPS_PER_S * 1e3
            bound_ms = max(t_bytes, t_ops) * 1e3
            bound_by = "bytes" if t_bytes >= t_ops else "operations"
            say(f"   kernel {ms * 1e3:.2f} us | plain {plain_ms * 1e3:.2f} us"
                f" | library: none (no single PyTorch call computes the SSD "
                f"scan) | bound {bound_ms * 1e3:.2f} us ({nbytes / 1e6:.1f} "
                f"MB: {t_bytes * 1e6:.2f} us; {nops / 1e9:.2f} GFLOP on the "
                f"bf16 tensor cores: {t_ops * 1e6:.2f} us; {bound_by}; the "
                f"float32 CUDA-core basis: {fp32_bound_ms * 1e3:.2f} us); "
                f"kernel at {nops / ms / 1e9:.2f} TFLOP/s")
            say(f"   device time by kernel, one call: "
                f"{device_split(lambda: ssd_chunk_scan(*args, chunk=chunk))}")
            row = dict(name="ssd_chunk_scan", route="cuda",
                       source="src/repro_torch/kernels/csrc/ssd_scan.cu",
                       replaces="src/repro/kernels/ssd_scan.py:60",
                       max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                       fp32_bound_ms=fp32_bound_ms, hmma=hmma)
        del x, Bm, Cm, dt, args, y, y32, want
    torch.cuda.empty_cache()
    return row


def cuda_ms_cold(fn, iters: int = 20) -> float:
    """Mean device time of one ``fn()`` call with the 50 MB L2 cache
    flushed before each (a 64 MiB write between the timed launches)."""
    import torch
    flush = torch.empty(16 << 20, dtype=torch.float32, device="cuda")
    fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def device_split(fn, top: int = 0) -> str:
    """The device time of each kernel of one ``fn()`` call (the ``top``
    largest when ``top`` > 0), by ``torch.profiler`` (self device time,
    us)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    items = sorted(((e.self_device_time_total, e.key)
                    for e in prof.key_averages()
                    if e.self_device_time_total > 0), reverse=True)
    if not items:
        return "not measured (the profiler saw no device activity)"
    total = sum(us for us, _ in items)
    items = items[:top] if top else items
    return f"{total:.2f} us in all: " + ", ".join(
        f"{key[:48]} {us:.2f} us" for us, key in items)


def _tie_swaps(ids, want_ids, rows, tol: float, label: str) -> int:
    """Hold a top-k against a reference top-k of the same queries: the
    ids are the same at every position except where the reference's
    own scores (``rows``, (Q, D)) of the two ids tie within ``tol``,
    and no id repeats in a row.  Returns the number of such swaps."""
    import numpy as np
    ids, want_ids = np.asarray(ids), np.asarray(want_ids)
    if ids.shape != want_ids.shape:
        raise AssertionError(f"[{label}] ids {ids.shape} vs reference "
                             f"{want_ids.shape}")
    swaps = 0
    for qi in range(ids.shape[0]):
        if len(set(ids[qi].tolist())) != ids.shape[1]:
            raise AssertionError(f"[{label}] query {qi}: repeated ids "
                                 f"{ids[qi].tolist()}")
        for j in np.flatnonzero(ids[qi] != want_ids[qi]):
            a, b = rows[qi][ids[qi, j]], rows[qi][want_ids[qi, j]]
            if not abs(float(a) - float(b)) <= tol:
                raise AssertionError(
                    f"[{label}] query {qi} position {j}: id {ids[qi, j]} "
                    f"(score {a}) where the reference has id "
                    f"{want_ids[qi, j]} (score {b})")
            swaps += 1
    return swaps


def kernel_launches(fn, calls: int = 5) -> dict:
    """``{kernel name: launches a call}`` of ``fn()`` by ``torch.profiler``
    over ``calls`` calls; empty when the profiler saw no device
    activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.count / calls for e in prof.key_averages()
            if e.self_device_time_total > 0}


def _k3_row(label, q, docs, counted, reference=None) -> dict:
    """Hold the K3 result ``counted`` (the main path's launch) against
    the plain version on the same inputs and time kernel, plain version
    and library yardstick; the bound on the TF32 tensor cores the kernel
    feeds (three products per float32 product) beside the float32
    CUDA-core basis of the kernel it replaced; the wrapper's time a call
    on the host's clock and the kernels one call launches.
    ``reference``: (ids, (Q, D) scores) of a host-side reference to hold
    the ids against as well."""
    import torch
    from repro_torch.kernels.dense_topk import dense_topk, dense_topk_torch
    Q, E = q.shape
    D, k = docs.shape[0], TOP_K
    got_s, got_i = counted
    want_s, want_i = dense_topk_torch(q, docs, k=k)
    rows = (q @ docs.T).cpu().numpy()   # the plain version's scores
    torch.cuda.synchronize()
    err = (got_s - want_s).abs().max().item()
    swaps = _tie_swaps(got_i.cpu().numpy(), want_i.cpu().numpy(), rows,
                       RETRIEVAL_TOL, f"dense_topk {label}")
    host = ""
    if reference is not None:
        host_swaps = _tie_swaps(got_i.cpu().numpy(), reference[0],
                                reference[1], RETRIEVAL_TOL,
                                f"dense_topk {label} vs DenseIndex.topk")
        host = (f"; ids vs DenseIndex.topk (numpy) for all {Q} questions: "
                f"{host_swaps} tie swap(s)")
    del rows

    def library():
        return torch.topk(q @ docs.T, k, dim=1)
    iters = 100 if D < BIG_DOCS else 10
    ms = cuda_ms(lambda: dense_topk(q, docs, k=k), iters)
    plain_ms = cuda_ms(lambda: dense_topk_torch(q, docs, k=k), iters)
    library_ms = cuda_ms(library, iters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        dense_topk(q, docs, k=k)
    torch.cuda.synchronize()
    host_us = (time.perf_counter() - t0) / iters * 1e6
    cold = ""
    if D * E * 4 < 50e6:
        cold = (f" | kernel, L2 flushed before each launch "
                f"{cuda_ms_cold(lambda: dense_topk(q, docs, k=k)) * 1e3:.2f}"
                f" us")
    nbytes = (Q * E + D * E) * 4 + Q * k * 8
    nops = 2 * Q * D * E
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_tc = 3 * nops / TF32_OPS_PER_S
    bound_ms = max(t_bytes, t_tc) * 1e3
    bound_by = "bytes" if t_bytes >= t_tc else "operations"
    fp32_bound_ms = max(t_bytes, nops / FP32_OPS_PER_S) * 1e3
    launched = kernel_launches(lambda: dense_topk(q, docs, k=k))
    say(f"== kernel dense_topk [{label}: Q={Q} D={D} E={E} k={k}, float32]")
    say(f"   max_abs_err {err:.3e} (tol {RETRIEVAL_TOL:.0e}); ids vs the "
        f"plain version: {swaps} tie swap(s){host}")
    say(f"   kernel {ms * 1e3:.2f} us | plain {plain_ms * 1e3:.2f} us | "
        f"library yardstick torch.topk(q @ docs.T) {library_ms * 1e3:.2f} us "
        f"| wrapper {host_us:.2f} us a call on the host's clock{cold}")
    say(f"   bound {bound_ms * 1e3:.2f} us, {bound_by} ({nbytes / 1e6:.2f} "
        f"MB: {t_bytes * 1e6:.2f} us; 3 x {nops / 1e9:.2f} GFLOP on the TF32 "
        f"tensor cores: {t_tc * 1e6:.2f} us) | the float32 CUDA-core basis "
        f"of the kernel it replaced: {fp32_bound_ms * 1e3:.2f} us | kernel "
        f"at {bound_ms / ms:.1%} of the bound")
    say(f"   kernels a call (torch.profiler, 5 calls): "
        f"{launched or 'not measured (the profiler saw no device activity)'}")
    say(f"   device time by kernel, one call: "
        f"{device_split(lambda: dense_topk(q, docs, k=k))}")
    if not err <= RETRIEVAL_TOL:
        raise AssertionError(f"dense_topk [{label}] scores disagree with "
                             f"its plain version: {err}")
    # the profiler may drop a call's events on this machine, never add one
    if launched and (len(launched) != 1 or max(launched.values()) > 1.0):
        raise AssertionError(f"dense_topk [{label}]: one call launched "
                             f"{launched}, want one kernel")
    return dict(name="dense_topk", route="cuda",
                source="src/repro_torch/kernels/csrc/dense_topk.cu",
                replaces="src/repro/kernels/dense_topk.py:100",
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms, fp32_bound_ms=fp32_bound_ms,
                host_us=host_us)


def k3_contract_phase(hgmma: int) -> None:
    """K3 across its contract, each against its plain version on seeded
    unit rows (scores within RETRIEVAL_TOL, ids equal but for tie swaps
    within it): k = 64 at the main-path shape (timed beside k = 10),
    ragged Q (5 and 200), D < 64, E = 768, and a corpus of 4,000 rows
    each placed five times at random positions (other tiles, other
    blocks), whose ids must equal the plain version's exactly (equal rows
    score bitwise-equal, exact ties to the lower id)."""
    import torch
    from repro_torch.kernels.dense_topk import dense_topk, dense_topk_torch
    g = torch.Generator(device="cuda").manual_seed(5)

    def unit(n, e):
        x = torch.randn((n, e), generator=g, device="cuda")
        return x / x.norm(dim=1, keepdim=True)
    say(f"== kernel dense_topk across its contract ({hgmma} HGMMA (wgmma) "
        f"instruction(s) in its SASS)")
    times = {}
    for label, Q, D, E, k in (("k = 64", 64, SQUAD_PARAGRAPHS, 256, 64),
                              ("k = 10", 64, SQUAD_PARAGRAPHS, 256, 10),
                              ("Q = 5", 5, SQUAD_PARAGRAPHS, 256, TOP_K),
                              ("Q = 200", 200, SQUAD_PARAGRAPHS, 256, TOP_K),
                              ("D < 64", 64, 37, 256, TOP_K),
                              ("E = 768", 64, SQUAD_PARAGRAPHS, 768, TOP_K),
                              ("duplicated rows", 64, SQUAD_PARAGRAPHS, 256,
                               TOP_K)):
        q = unit(Q, E)
        if label == "duplicated rows":
            base = unit(D // 5, E)
            perm = torch.randperm(D, generator=g, device="cuda")
            docs = base.repeat(5, 1)[perm]
        else:
            docs = unit(D, E)
        got_s, got_i = dense_topk(q, docs, k=k)
        want_s, want_i = dense_topk_torch(q, docs, k=k)
        torch.cuda.synchronize()
        err = (got_s - want_s).abs().max().item()
        if label == "duplicated rows":
            exact = torch.equal(got_i, want_i)
            note = f"ids equal to the plain version's: {exact}"
            if not exact:
                raise AssertionError(f"dense_topk [{label}]: ids differ from "
                                     f"the plain version's")
        else:
            swaps = _tie_swaps(got_i.cpu().numpy(), want_i.cpu().numpy(),
                               (q @ docs.T).cpu().numpy(), RETRIEVAL_TOL,
                               f"dense_topk {label}")
            note = f"{swaps} tie swap(s)"
        if label.startswith("k = "):
            times[label] = cuda_ms(lambda: dense_topk(q, docs, k=k))
            note += f"; kernel {times[label] * 1e3:.2f} us"
        say(f"   [{label}: Q={Q} D={D} E={E} k={min(k, D)}] max_abs_err "
            f"{err:.3e}; {note}")
        if not (err <= RETRIEVAL_TOL and got_s.shape == (Q, min(k, D))):
            raise AssertionError(f"dense_topk [{label}] disagrees with its "
                                 f"plain version: {err}")
        del q, docs
    say(f"   k = 64 takes {times['k = 64'] / times['k = 10']:.2f} x the time "
        f"of k = 10")
    torch.cuda.empty_cache()


def _k5_row(bm25, questions, qtf, csr, doc_len, idf, bm, bm_i,
            csr_s: float) -> dict:
    """Hold K5's result ``bm`` (the main path's launch, through
    ``BM25Index.scores_batch`` on the index's ``BM25Csr``) against the
    plain version on the same inputs and its top-k ``bm_i`` against the
    host's ``BM25Index.topk``; time the call (the row's ``ms``), the
    kernel alone (``kernel_ms``), the plain version, the call on a dense
    ``tf`` (compaction included) and two library yardsticks; compute the
    bound of what this run's data needs, beside the bounds of every
    nonzero and of the dense input."""
    import numpy as np
    import torch
    from repro_torch.kernels import bm25 as k5
    from repro_torch.kernels.bm25 import bm25_scores, bm25_scores_torch
    tf = torch.from_numpy(bm25.tf).cuda()
    want = bm25_scores_torch(qtf, csr, doc_len, idf)
    dense_want = bm25_scores_torch(qtf, tf, doc_len, idf)
    scale = want.abs().max()
    rel = ((bm - want).abs().max() / scale).item()
    dense_in = bm25_scores(qtf, tf, doc_len, idf)
    dense_rel = ((dense_in - want).abs().max() / scale).item()
    plain_rel = ((dense_want - want).abs().max() / scale).item()
    n_host = BM25_HOST_QUESTIONS
    t0 = time.perf_counter()
    host_ids = np.stack([bm25.topk(t, TOP_K)[0]
                         for t in questions[:n_host]])
    host_s = (time.perf_counter() - t0) / n_host
    host_rows = np.stack([bm25.scores_np(bm25.query_vector(t))
                          for t in questions[:n_host]])
    bm25_swaps = _tie_swaps(bm_i[:n_host].cpu().numpy(), host_ids,
                            host_rows,
                            RETRIEVAL_TOL * float(np.abs(host_rows).max()),
                            "bm25_scores top-k vs BM25Index.topk")
    # the yardsticks' inputs, prep untimed: the saturated matrix, dense
    # and as a CSR tensor of the same nonzeros
    k1, b = bm25.cfg.k1, bm25.cfg.b
    norm = k1 * (1 - b + b * doc_len / (doc_len.mean() + 1e-6))
    wq = qtf * idf[None, :]
    sat = tf * (k1 + 1.0) / (tf + norm[:, None])
    sat_csr = torch.sparse_csr_tensor(
        csr.row_ptr.long(), csr.cols.long(),
        csr.vals * (k1 + 1.0) / (csr.vals + norm[k5._csr_rows(csr)]),
        csr.shape)
    wqT = wq.T.contiguous()

    def cublas():
        return wq @ sat.T

    def sparse():
        return torch.sparse.mm(sat_csr, wqT)
    cublas_rel = ((cublas() - want).abs().max() / scale).item()
    sparse_rel = ((sparse().T - want).abs().max() / scale).item()
    # the whole call (the row's time, as every row's), its time on the
    # host's clock back to back, and the kernel alone on the wrapper's
    # prep (untimed, as the yardsticks' prep is)
    ms = cuda_ms(lambda: bm25_scores(qtf, csr, doc_len, idf))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        bm25_scores(qtf, csr, doc_len, idf)
    torch.cuda.synchronize()
    call_wall_ms = (time.perf_counter() - t0) * 10
    kernel = k5._kernel()
    prep = k5._kernel_prep(qtf, doc_len, idf, k1, b)
    kernel_ms = cuda_ms(
        lambda: k5._launch(kernel, *prep[:2], csr, prep[2], k1))
    plain_ms = cuda_ms(lambda: bm25_scores_torch(qtf, csr, doc_len, idf),
                       20)
    dense_ms = cuda_ms(lambda: bm25_scores(qtf, tf, doc_len, idf), 20)
    cublas_ms = cuda_ms(cublas, 20)
    library_ms = cuda_ms(sparse, 20)
    Q, V = qtf.shape
    D, nnz = csr.shape[0], csr.vals.numel()
    used = prep[1]
    n_terms = int(used.sum().item())
    n_used = int(used[csr.cols.long()].sum().item())
    # what this run's data needs: row_ptr, every col (to find the used
    # ones), norm, the used flags and the output; vals and the weights
    # only of the used terms; the saturation (3) and the Q products (2 Q)
    # of each used nonzero.  Beside it the same count over every nonzero
    # and all of wq.
    fixed = (D + 1) * 4 + nnz * 4 + D * 4 + V + Q * D * 4
    nbytes = fixed + n_used * 4 + n_terms * Q * 4
    nops = (2 * Q + 3) * n_used
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / FP32_OPS_PER_S
    bound_ms = max(t_bytes, t_ops) * 1e3
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    all_bytes = fixed + nnz * 4 + Q * V * 4
    all_ms = max(all_bytes / HBM_BYTES_PER_S,
                 (2 * Q + 3) * nnz / FP32_OPS_PER_S) * 1e3
    dense_bytes = (Q * V + D * V + D + V + Q * D) * 4
    say(f"== kernel bm25 [SQuAD scale: Q={Q} D={D} V={V}, float32, "
        f"{nnz} nonzero tf ({nnz / D:.1f} a document), {n_used} of them "
        f"in the {n_terms} terms of the batch]")
    say(f"   BM25Index.device_csr: compacted on the host and copied with "
        f"doc_len and idf ({(D + 1) * 4 + nnz * 8 + D * 4 + V * 4} bytes) "
        f"in {csr_s * 1e3:.2f} ms, once")
    say(f"   max relative err {rel:.3e} (tol {RETRIEVAL_TOL:.0e}); dense-"
        f"input call {dense_rel:.3e}; plain dense version {plain_rel:.3e}; "
        f"cuBLAS {cublas_rel:.3e}; torch.sparse.mm {sparse_rel:.3e}; "
        f"top-{TOP_K} vs BM25Index.topk (numpy, {host_s:.2f} s a question "
        f"on the host) for the first {n_host} questions: {bm25_swaps} tie "
        f"swap(s)")
    say(f"   call {ms * 1e3:.2f} us on the card (torch prep + kernel; "
        f"{call_wall_ms * 1e3:.2f} us a call on the host's clock) | kernel "
        f"alone {kernel_ms * 1e3:.2f} us | plain (CSR) "
        f"{plain_ms * 1e3:.2f} us | dense-input call, compaction included "
        f"{dense_ms * 1e3:.2f} us | library torch.sparse.mm (CSR of the "
        f"saturated values, prep untimed) {library_ms * 1e3:.2f} us | "
        f"cuBLAS wq @ sat.T (prep untimed) {cublas_ms * 1e3:.2f} us")
    say(f"   bound {bound_ms * 1e3:.2f} us ({nbytes / 1e6:.2f} MB: "
        f"{t_bytes * 1e6:.2f} us; {nops / 1e6:.1f} MFLOP: "
        f"{t_ops * 1e6:.2f} us; {bound_by}): call "
        f"{ms / bound_ms:.1f} x, kernel {kernel_ms / bound_ms:.1f} x | "
        f"counting every nonzero and all of wq {all_ms * 1e3:.2f} us "
        f"({all_bytes / 1e6:.2f} MB) | dense-input bound "
        f"{dense_bytes / HBM_BYTES_PER_S * 1e6:.2f} us "
        f"({dense_bytes / 1e6:.2f} MB)")
    say(f"   device time by kernel, one call: "
        f"{device_split(lambda: bm25_scores(qtf, csr, doc_len, idf))}")
    if not (rel <= RETRIEVAL_TOL and dense_rel <= RETRIEVAL_TOL):
        raise AssertionError(f"bm25 disagrees with its plain version: "
                             f"{rel}, dense input {dense_rel}")
    return dict(name="bm25_scores", route="cuda",
                source="src/repro_torch/kernels/csrc/bm25.cu",
                replaces="src/repro/kernels/bm25.py:40",
                max_abs_err=(bm - want).abs().max().item(), ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms, kernel_ms=kernel_ms)


def retrieval_kernel_phase() -> tuple:
    """K3 and K5 on the batched retrieval path at the SQuAD scale (a
    synthetic corpus of 20,000 paragraphs, 64 questions, k = 10): the
    path's entry points (``DenseIndex.topk_batch``,
    ``BM25Index.scores_batch``) run once with the launch counts set to 0
    just before and read just after; then each kernel is held against its plain version and the
    host's numpy retrieval, and timed.  K3 is held and timed again on
    1,048,576 seeded random unit rows (1 GiB).  Returns the table's
    main-path rows and the path's launch counts."""
    import numpy as np
    import torch
    from repro_torch.data import SyntheticSquad
    from repro_torch.kernels.bm25 import bm25_scores
    from repro_torch.kernels.dense_topk import dense_topk
    from repro_torch.retrieval import BM25Index, DenseIndex
    hgmma = sass_count("dense_topk", "HGMMA")
    say(f"== kernel dense_topk: {hgmma} HGMMA (wgmma) instruction(s) in its "
        f"SASS")
    if not hgmma:
        raise AssertionError("dense_topk's SASS has no HGMMA: the products "
                             "do not run on the tensor cores")
    t0 = time.perf_counter()
    data = SyntheticSquad(n_paragraphs=SQUAD_PARAGRAPHS,
                          n_questions=SQUAD_QUESTIONS, seed=0)
    texts = [p.text for p in data.paragraphs]
    questions = [q.text for q in data.questions]
    t1 = time.perf_counter()
    bm25 = BM25Index.build(texts)
    t2 = time.perf_counter()
    dense = DenseIndex.build(texts)
    t3 = time.perf_counter()
    say(f"== retrieval kernels: SyntheticSquad {len(texts)} paragraphs, "
        f"{len(questions)} questions ({t1 - t0:.1f} s); BM25Index "
        f"{bm25.tf.shape} ({t2 - t1:.1f} s, {(bm25.tf > 0).mean():.4f} "
        f"nonzero); DenseIndex {dense.emb.shape} ({t3 - t2:.1f} s) "
        f"on the host")
    qtf = torch.from_numpy(np.stack([bm25.query_vector(t)
                                     for t in questions])).cuda()
    emb = dense.device_emb("cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    csr = bm25.device_csr("cuda")     # compacted on the host, copied once
    torch.cuda.synchronize()
    csr_s = time.perf_counter() - t0
    doc_len, idf = (torch.from_numpy(a).cuda()
                    for a in (bm25.doc_len, bm25.idf))
    if bm25.device_csr("cuda") is not csr:
        raise AssertionError("[retrieval] device_csr was built twice")

    # -- the batched retrieval path, counted -----------------------------
    counters = (dense_topk, bm25_scores)
    for fn in counters:
        fn.launches = 0
    ids, scores = dense.topk_batch(questions, TOP_K)
    bm = bm25.scores_batch(qtf)
    bm_i = torch.topk(bm, TOP_K, dim=1).indices
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters}
    if bm25.device_csr(qtf.device) is not csr:
        raise AssertionError(f"[retrieval] scores_batch on {qtf.device} "
                             f"uploaded the index again")
    say(f"   path: DenseIndex.topk_batch + BM25Index.scores_batch -> "
        f"top-{TOP_K}: launches {launches}")
    if launches != {"dense_topk": 1, "bm25_scores": 1}:
        raise AssertionError(f"[retrieval] launches {launches}: want one "
                             f"of each kernel")

    # -- K3: against the plain version and DenseIndex.topk ---------------
    qe = torch.from_numpy(np.stack([dense.encode(t) for t in questions]))
    host_ids = np.stack([dense.topk(t, TOP_K)[0] for t in questions])
    host_rows = np.stack([dense.scores_np(e) for e in qe.numpy()])
    host_err = max(float(np.abs(scores[i] - host_rows[i][host_ids[i]]).max())
                   for i in range(len(questions)))
    if not host_err <= RETRIEVAL_TOL:
        raise AssertionError(f"topk_batch scores vs DenseIndex.topk: "
                             f"{host_err}")
    qe = qe.cuda()
    counted = (torch.from_numpy(scores).cuda(),
               torch.from_numpy(ids).cuda())
    k3 = _k3_row(f"SQuAD scale, topk_batch; scores vs DenseIndex.topk "
                 f"{host_err:.2e}", qe, emb, counted, (host_ids, host_rows))

    # -- K5: against the plain version and BM25Index.topk ----------------
    k5 = _k5_row(bm25, questions, qtf, csr, doc_len, idf, bm, bm_i, csr_s)
    del csr, bm, emb, dense, bm25
    gc.collect()
    torch.cuda.empty_cache()

    # -- K3 at 1,048,576 docs ----------------------------------------------
    g = torch.Generator(device="cuda").manual_seed(2)
    docs = torch.randn((BIG_DOCS, 256), generator=g, device="cuda")
    docs.div_(docs.norm(dim=1, keepdim=True))
    qb = torch.randn((SQUAD_QUESTIONS, 256), generator=g, device="cuda")
    qb.div_(qb.norm(dim=1, keepdim=True))
    k3_1m = _k3_row("1M seeded unit rows", qb, docs,
                    dense_topk(qb, docs, k=TOP_K))
    k3.update(ms_1m=k3_1m["ms"], bound_ms_1m=k3_1m["bound_ms"],
              plain_ms_1m=k3_1m["plain_ms"],
              library_ms_1m=k3_1m["library_ms"], hgmma=hgmma)
    del docs, qb
    torch.cuda.empty_cache()
    k3_contract_phase(hgmma)
    return [k3, k5], launches


def small_model_phase() -> None:
    """The SMOKE decoder in bf16, prefill + 4 decode steps, card (kernel)
    against host (plain attention) on the same weights and tokens."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.schema import tree_map
    cfg = get_config("qwen1.5-32b", "smoke")
    model = build_model(cfg)
    host = model.init(seed=0, device="cpu")
    card = tree_map(lambda t: t.cuda(), host)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(4, cfg.vocab_size, size=(3, 12)))

    def run(dev, params, feed=None):
        """Prefill + 4 greedy decode steps; ``feed`` replays the host's
        tokens so both sides decode the same sequence."""
        cache = model.init_cache(3, 20, device=dev)
        lg, _ = model.prefill(params, {"tokens": toks.to(dev)}, cache)
        out, fed = [lg.cpu()], []
        for i in range(4):
            nxt = (feed[i] if feed is not None
                   else lg[:, -1].argmax(-1).to(torch.int32).cpu())
            fed.append(nxt)
            lg, _ = model.decode(params, {"tokens": nxt[:, None].to(dev)},
                                 cache)
            out.append(lg.cpu())
        return out, fed

    host_logits, fed = run("cpu", host)
    card_logits, _ = run("cuda", card, fed)
    worst = max(((a - b).abs().max() / a.abs().max()).item()
                for a, b in zip(host_logits, card_logits))
    say(f"== small: SMOKE bf16 prefill + 4 decode steps, card vs host: "
        f"max |dlogit| / max |logit| = {worst:.3e} (tol 5e-2)")
    if not worst <= 5e-2:
        raise AssertionError(f"SMOKE decoder on the card disagrees with the "
                             f"host: {worst}")
    nan_phase(model, tree_map(lambda t: t * float("nan"), card))


def nan_phase(model, bad) -> None:
    """A real on-device NaN: with every weight NaN, 2 requests on 2
    slots; the executor's isfinite test on the card must trip both slots
    and the scheduler quarantine them (each request failing transiently,
    nothing hanging); with ``health_checks=False`` nothing trips."""
    import torch
    from repro_torch.serving.continuous import ContinuousEngine
    from repro_torch.serving.executor import SingleDeviceExecutor
    for checks in (True, False):
        ex = SingleDeviceExecutor(model, bad, num_slots=2, max_len=32,
                                  max_new_cap=8, sync_every=2,
                                  health_checks=checks)
        eng = ContinuousEngine(executor=ex)
        t0 = time.perf_counter()
        outs = eng.generate_many([[5, 6, 7], [9, 4, 11, 2]],
                                 max_new_tokens=8)
        torch.cuda.synchronize()
        failed = [bool(o.failed and o.transient) for o in outs]
        say(f"== nan: SMOKE with NaN weights on the card, health checks "
            f"{'on' if checks else 'off'}: nan trips "
            f"{eng.stats.n_nan_trips}, quarantined "
            f"{sorted(eng.quarantined_slots)}, failed transiently "
            f"{failed}, {time.perf_counter() - t0:.2f} s")
        want = (2, {0, 1}, [True, True]) if checks else (0, set(),
                                                         [False, False])
        if (eng.stats.n_nan_trips, eng.quarantined_slots, failed) != want:
            raise AssertionError(f"[nan] health checks {checks}: "
                                 f"{eng.stats}, {eng.quarantined_slots}")


def router_phase(card: str):
    """The paper's router, trained on the card at the FULL testbed
    (``configs/paper_slo_router.py``: 800 train / 200 eval questions
    over 600 paragraphs, the 5-action paper space, 30 epochs): the
    Table 1 grid through ``run_experiment``, the refusal collapse under
    ``cheap``, the card's training against the host's from one initial
    draw, one SLO-conditioned policy routing both profiles, and the
    quickstart's Gateway over the simulator backend.  Returns the
    quality_first Argmax-CE policy trained on the card, which routes the
    serving phases."""
    import numpy as np
    import torch
    from repro_torch.configs import paper_slo_router
    from repro_torch.core.actions import REFUSE_ACTION, SLO_PROFILES
    from repro_torch.core.experiment import run_experiment
    from repro_torch.core.metrics import evaluate_actions
    from repro_torch.core.policy import (init_policy, policy_actions,
                                         train_policy)
    from repro_torch.routing import (ConditionedPolicy, Gateway, MLPPolicy,
                                     Request, SimulatorBackend)
    cfg = paper_slo_router.FULL
    rc = cfg.router
    steps = -(-cfg.n_train // rc.batch_size)
    say(f"== router: paper_slo_router.FULL, {cfg.n_train} train / "
        f"{cfg.n_eval} eval questions over {cfg.n_paragraphs} paragraphs, "
        f"MLP {rc.state_dim} -> {rc.hidden_dims} -> {rc.n_actions}, "
        f"{rc.n_epochs} epochs of {steps} steps (batch {rc.batch_size}), "
        f"float32")
    res, extras, (train_log, eval_log) = run_experiment(
        cfg, include_mitigation=True, refusal_cap=ROUTER_CAP, verbose=False,
        device="cuda")
    secs = extras["seconds"]
    say(f"   offline log (host, one question at a time): "
        f"{secs['build_testbed']:.2f} s for {train_log.n + eval_log.n} "
        f"questions x {train_log.n_actions} actions")
    for key, hist in extras["train_hist"].items():
        say(f"   train {key:28s} {secs[key]:.3f} s wall, "
            f"{secs[key] / rc.n_epochs * 1e3:.2f} ms an epoch; last epoch "
            f"loss {hist['loss']:.4f}, p_refuse {hist['p_refuse']:.3f}, "
            f"lambda {hist['lambda']:.3f} [{card}]")
    for line in res.table().splitlines():
        say("   " + line)
    say(f"   action distributions: {extras['action_dists']}")
    rows = {(r["slo"], r["method"]): r for r in res.rows}
    best = {r["slo"]: r for r in res.rows
            if r["method"].startswith("best-fixed")}
    ce, con = rows[("cheap", "argmax_ce")], rows[("cheap", "constrained")]
    qf = rows[("quality_first", "argmax_ce")]
    say(f"   Table 1's draw (seed {rc.seed}): cheap constrained refuse "
        f"share {con['action_dist'][REFUSE_ACTION]} and acc {con['acc']} "
        f"against argmax_ce's {ce['action_dist'][REFUSE_ACTION]} and "
        f"{ce['acc']}")
    # At this cap the constraint on the mean refusal probability barely
    # binds (Argmax-CE's own is about 0.5 in training), so one draw
    # decides whether the eval refusals fall; the objective's effect is
    # held on the mean over the draws of seeds 0 .. ROUTER_SEEDS - 1.
    cheap = SLO_PROFILES["cheap"]
    cheap_rewards = train_log.rewards(cheap)
    draws = {"argmax_ce": [], "constrained": []}
    t0 = time.perf_counter()
    for seed in range(ROUTER_SEEDS):
        for obj, out in draws.items():
            tr = train_policy(train_log, cheap_rewards, rc, objective=obj,
                              refusal_cap=ROUTER_CAP, seed=seed,
                              device="cuda")
            rep = evaluate_actions(
                eval_log, policy_actions(tr.params, eval_log.states, rc),
                cheap, obj)
            out.append((float(rep.action_dist[REFUSE_ACTION]), rep.acc))
    ref_share = {o: float(np.mean([d[0] for d in v]))
                 for o, v in draws.items()}
    acc = {o: float(np.mean([d[1] for d in v])) for o, v in draws.items()}
    held = sum(c[0] < a[0] and c[1] > a[1] for a, c in
               zip(draws["argmax_ce"], draws["constrained"]))
    say(f"   cheap over seeds 0..{ROUTER_SEEDS - 1} "
        f"({2 * ROUTER_SEEDS} trainings, {time.perf_counter() - t0:.1f} s): "
        f"mean refuse share {ref_share}, mean acc {acc}; constrained "
        f"refuses less with a higher acc in {held} of {ROUTER_SEEDS} "
        f"draws; argmax_ce refuse share > 0.5 in "
        f"{sum(d[0] > 0.5 for d in draws['argmax_ce'])} of them")
    say(f"     (refuse share, acc) by seed: {draws}")
    checks = {
        "cheap argmax_ce refuses > 0.5": ce["refuse"] > 0.5,
        "cheap argmax_ce acc < 0.2": ce["acc"] < 0.2,
        "cheap argmax_ce reward < best-fixed's":
            ce["reward"] < best["cheap"]["reward"],
        "cheap constrained mean refuse share < argmax_ce's":
            ref_share["constrained"] < ref_share["argmax_ce"],
        "cheap constrained mean acc > argmax_ce's":
            acc["constrained"] > acc["argmax_ce"],
        "quality_first argmax_ce reward > best-fixed's - 0.1":
            qf["reward"] > best["quality_first"]["reward"] - 0.1,
        "quality_first argmax_ce refuses < 0.8": qf["refuse"] < 0.8,
    }
    say(f"   failure mode: {checks}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"[router] the paper's failure mode does not "
                             f"show at FULL size: {failed}")

    # the card's training against the host's, from one host-drawn init
    profile = SLO_PROFILES["quality_first"]
    rewards = train_log.rewards(profile)
    init = init_policy(rc.seed, rc, device="cpu")
    trained = {}
    for dev in ("cuda", "cpu"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trained[dev] = MLPPolicy.train(
            train_log, rewards, rc, init_params=init, device=dev,
            name="MLPPolicy(trained, quality_first argmax_ce)")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        say(f"   quality_first argmax_ce on {dev}, one host-drawn init: "
            f"{wall:.3f} s wall, {wall / rc.n_epochs * 1e3:.2f} ms an epoch")
    card_pol, host_pol = trained["cuda"], trained["cpu"]
    diff = max((card_pol.params[k].cpu() - host_pol.params[k]).abs().max()
               .item() for k in init)
    card_logits = card_pol.logits(eval_log.states)
    host_logits = host_pol.logits(eval_log.states)
    card_acts = card_logits.argmax(-1)
    host_acts = host_logits.argmax(-1)
    off = np.nonzero(card_acts != host_acts)[0]
    top2 = np.sort(host_logits, axis=-1)[:, -2:]
    margins = {int(i): float(top2[i, 1] - top2[i, 0]) for i in off}
    rep = evaluate_actions(eval_log, card_acts, profile, "card")
    say(f"   card vs host: largest param difference {diff:.3e}; "
        f"{len(off)} of {eval_log.n} eval actions disagree (tol "
        f"{ROUTER_MAX_DISAGREE}), host top-two logit margins there "
        f"{margins}; the card's policy: {rep.row()}")
    if len(off) > ROUTER_MAX_DISAGREE:
        raise AssertionError(f"[router] the card's training disagrees with "
                             f"the host's on {len(off)} eval actions")
    us = {n: host_us(lambda n=n: card_pol.route(eval_log.states[:n]),
                     calls=100) for n in (8, 20)}
    say(f"   route a micro-batch on the card (host clock, logits back to "
        f"the host): {us[8]:.1f} us for 8 requests, {us[20]:.1f} us for "
        f"20 [{card}]")

    # one SLO-conditioned policy for both profiles
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cond = ConditionedPolicy.train(
        train_log, [SLO_PROFILES["quality_first"], SLO_PROFILES["cheap"]],
        rc, device="cuda")
    wall = time.perf_counter() - t0
    shares = {slo: float(np.mean(cond.route(eval_log.states, slo).actions
                                 == REFUSE_ACTION))
              for slo in ("quality_first", "cheap")}
    say(f"   conditioned policy (state_dim {cond.cfg.state_dim}, "
        f"{len(cond.train_result.history)} epochs over 5 profiles x "
        f"{train_log.n}): {wall:.3f} s wall; refuse share {shares}")
    if not shares["cheap"] > shares["quality_first"]:
        raise AssertionError(f"[router] the conditioned policy does not "
                             f"refuse more under cheap: {shares}")

    # the quickstart's serving step
    data, index, pipe = extras["testbed"]
    cheap = MLPPolicy.train(train_log,
                            train_log.rewards(SLO_PROFILES["cheap"]), rc,
                            objective="argmax_ce", device="cuda")
    gw = Gateway(cheap, SimulatorBackend(pipe), router_cfg=rc, index=index,
                 max_batch=20, adaptive_refusal=True, base_refusal_share=0.5)
    t0 = time.perf_counter()
    st = gw.serve([Request(qid=q.qid, question=q, slo="cheap")
                   for q in data.questions[-60:]])
    say(f"   Gateway + SimulatorBackend under cheap: served {st.served}, "
        f"avg reward {st.avg_reward:+.4f}, refusal share "
        f"{gw.refusal_share:.2f} (cap history {st.refusal_cap_history}), "
        f"{time.perf_counter() - t0:.2f} s host wall")
    if st.served != 60 or not np.isfinite(st.avg_reward):
        raise AssertionError(f"[router] the simulator Gateway served "
                             f"{st.served} of 60: {st}")
    return card_pol


def profile_phase(gw, reqs, plain_wall_s: float) -> None:
    """One more micro-batch, after the counted main path, under the
    profiler (device activity only): device busy time (the kernels' self
    device time) against the device window between two CUDA events, and
    the kernels that take most of it.  The profiler slows the host's
    launches, so the idle share it shows is an upper bound; the host
    wall beside the unprofiled micro-batch's shows by how much."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        gw.serve(reqs)
        end.record()
        end.synchronize()
        wall_s = time.perf_counter() - t0
    window_ms = start.elapsed_time(end)
    avgs = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in avgs) / 1e3
    say(f"== profile: one more micro-batch of the trained router, "
        f"{len(reqs)} requests "
        f"(host wall {wall_s:.2f} s profiled vs {plain_wall_s:.2f} s "
        f"unprofiled)")
    if busy_ms <= 0:
        say(f"   device time not measured (the profiler saw no device "
            f"activity in the {window_ms:.1f} ms window)")
        return
    say(f"   device busy {busy_ms:.1f} ms of a {window_ms:.1f} ms device "
        f"window, idle share {1 - busy_ms / window_ms:.3f}")
    for e in sorted(avgs, key=lambda e: -e.self_device_time_total)[:10]:
        say(f"     {e.self_device_time_total / 1e3:8.2f} ms  x{e.count:<6d} "
            f"{e.key[:90]}")


def _instrument(engine) -> dict:
    """Record, for one engine: CUDA events around each decode chunk and
    each admission (prefill + commit) of the dense executor, the greedy
    tokens of every finished request keyed by its prompt, and (on a
    paged engine) the peak pages in use after each admission round and
    the admission groups whose suffix is one token."""
    import torch
    rec = {"chunks": [], "admits": [], "tokens": {}, "peak_pages": 0,
           "short_prefills": 0}
    prompts = {}
    ex = engine.executor
    run_chunk, admit_group, submit, run = (ex.decode_chunk, ex.admit,
                                           engine.submit, engine.run)

    def timed(fn, key):
        def call(*a, **kw):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*a, **kw)
            e.record()
            rec[key].append((s, e))
            return out
        return call

    def recording_submit(rid, prompt, *a, **kw):
        prompts[rid] = tuple(prompt)
        return submit(rid, prompt, *a, **kw)

    def recording_run():
        done = run()
        for rid, gen in done.items():
            if not gen.failed:
                rec["tokens"][prompts[rid]] = [int(t) for t in gen.tokens]
        return done
    ex.decode_chunk = timed(run_chunk, "chunks")
    ex.admit = timed(admit_group, "admits")
    engine.submit, engine.run = recording_submit, recording_run
    if engine._pages is not None:
        admit = engine._start_admissions
        admit_paged = ex.admit_paged

        def counting_admit_paged(tokens, *a):
            rec["short_prefills"] += tokens.shape[1] == 1
            return admit_paged(tokens, *a)
        ex.admit_paged = counting_admit_paged

        def counting_admit():
            admit()
            rec["peak_pages"] = max(rec["peak_pages"],
                                    engine._pages.pages_in_use)
        engine._start_admissions = counting_admit
    return rec


def _gateways(backend, index, served, n: int, policy):
    """The first ``n`` of: a FixedPolicy(0) gateway, a gateway routing
    with ``policy`` (the router trained in the router phase), both over
    ``backend``."""
    from repro_torch.core.config import RouterConfig
    from repro_torch.routing import FixedPolicy, Gateway
    router = RouterConfig()
    gws = [("FixedPolicy(0)", lambda: Gateway(
                FixedPolicy(0), backend, router_cfg=router, index=index,
                max_batch=8, adaptive_refusal=False,
                on_outcome=lambda *a: served.append(a))),
           (policy.name, lambda: Gateway(
               policy, backend, router_cfg=router, index=index, max_batch=8,
               on_outcome=lambda *a: served.append(a)))]
    return [(name, make()) for name, make in gws[:n]]


def _requests(qs, i):
    from repro_torch.routing import Request
    return [Request(qid=q.qid, question=q, slo="quality_first")
            for q in qs[8 * i: 8 * i + 8]]


def _step_ms(chunks, steps: int) -> float:
    """Device time per decode step over CUDA-event pairs around chunks."""
    return sum(s.elapsed_time(e) for s, e in chunks) / max(steps, 1)


def _check_served(label, served, n_req: int, engine) -> None:
    """Every request served, every generating request produced its
    tokens, no slot quarantined."""
    if len(served) != n_req:
        raise AssertionError(f"[{label}] {len(served)} of {n_req} requests "
                             f"served")
    for req, action, out, _ in served:
        if out.rejected or (not out.refused
                            and out.cost_tokens < MAX_PROMPT_LEN + 1):
            raise AssertionError(f"[{label}] request {req.qid} "
                                 f"(a{action.idx}) did not generate: {out}")
    if engine.stats.n_quarantined or engine.quarantined_slots:
        raise AssertionError(f"[{label}] {engine.stats.n_quarantined} "
                             f"slot(s) quarantined (NaN/inf logits or no "
                             f"progress)")


def _zero(counters) -> None:
    for fn in counters.values():
        fn.launches = 0


def _drive(label, backend, index, qs, n_batches, card, n_layers,
           counters, policy) -> dict:
    """Serve ``n_batches`` micro-batches of 8 through ``Gateway.serve``
    with every kernel launch count set to 0 just before and read just
    after, then check: every request served, every generating request
    produced its tokens, at least one request of the trained router's
    batch generated, no slot quarantined.  Returns the launch counts, the
    decode steps, the engine record and the gateways."""
    import torch
    from repro_torch.models.schema import tree_leaves
    engine = backend.engine
    rec = _instrument(engine)
    served = []
    gateways = _gateways(backend, index, served, n_batches, policy)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    _zero(counters)
    t0 = time.perf_counter()
    for i, (name, gw) in enumerate(gateways):
        t_batch = time.perf_counter()
        st = gw.serve(_requests(qs, i))
        torch.cuda.synchronize()
        rec["batch_wall"] = time.perf_counter() - t_batch
        say(f"   {name}: served {st.served}, actions "
            f"{dict(sorted(st.action_counts.items()))}, avg_reward "
            f"{st.avg_reward:+.4f}, rejected {st.rejected}, refusal cap "
            f"history {st.refusal_cap_history}, host wall "
            f"{rec['batch_wall']:.2f} s, latency {st.latency_percentiles()}")
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}

    es = engine.stats
    steps = es.n_decode_steps
    step_ms = _step_ms(rec["chunks"], steps)
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in tree_leaves(engine.params))
    bound_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    rec["step_ms"] = step_ms
    say(f"   engine: admitted {es.n_admitted}, completed {es.n_completed}, "
        f"prefills {es.n_prefills}, decode chunks {es.n_decode_chunks} "
        f"({steps} steps), max concurrent {es.max_concurrent}, "
        f"quarantined {es.n_quarantined}")
    say(f"   decode [{label}]: {step_ms:.2f} ms per step (device time of the "
        f"chunks) beside the weight-read bound {bound_ms:.2f} ms "
        f"({weight_bytes / 1e9:.1f} GB / 3.35 TB/s); serve wall "
        f"{wall:.2f} s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    say(f"   launches {launches} for {n_layers} layers x {steps} decode "
        f"steps")

    _check_served(label, served, 8 * n_batches, engine)
    if n_batches > 1 and all(out.refused for _, _, out, _ in served[8:16]):
        raise AssertionError(f"[{label}] no request of the trained "
                             f"router's batch generated")
    return {"launches": launches, "steps": steps, "rec": rec,
            "gateways": gateways, "wall": wall}


def _check_launches(label, launches, kernel, steps, n_layers,
                    absent=()) -> None:
    if steps == 0 or launches[kernel] != n_layers * steps:
        raise AssertionError(f"[{label}] {kernel} launched "
                             f"{launches[kernel]} times for {steps} decode "
                             f"steps of {n_layers} layers")
    for other in absent:
        if launches[other]:
            raise AssertionError(f"[{label}] {other} launched "
                                 f"{launches[other]} times on this path")


def _check_paged_launches(label, launches, steps, n_layers,
                          short: int) -> None:
    """The paged engine: K2 once a layer per decode step; K1 only for
    admission groups whose suffix is one token (a prompt whose pages but
    its last token were all prefix hits: that token's prefill has a
    single query and takes the decode branch over the dense prefill
    scratch), once a layer each."""
    _check_launches(label, launches, "paged_flash_decode", steps, n_layers)
    if launches["flash_decode"] != n_layers * short:
        raise AssertionError(f"[{label}] flash_decode launched "
                             f"{launches['flash_decode']} times for {short} "
                             f"one-token prefills of {n_layers} layers")


def _free_gpu_memory(label: str) -> None:
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    say(f"== {label}: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"allocated after freeing the previous engine")


def hybrid_phase(backend, index, data, rec, n_layers, counters) -> None:
    """The retriever-choice action space ``hybrid9`` on the dense
    engine's backend: ``FixedPolicy(3)`` (dense, k=5, guarded), then
    ``FixedPolicy(7)`` (hybrid, k=5, auto), each over 4 questions twice
    (repeats hit the shared retrieval cache).  Checks: every request
    served on its action, cache hits, nothing degraded, no slot
    quarantined, K1 launched 64 times per decode step of this phase."""
    import torch
    from repro_torch.core.config import RouterConfig
    from repro_torch.routing import (FixedPolicy, Gateway, Request,
                                     get_action_space)
    engine, cache = backend.engine, backend.retrieval_cache
    space = get_action_space("hybrid9")
    steps0, chunks0 = engine.stats.n_decode_steps, len(rec["chunks"])
    hits0, lookups0 = cache.hits, cache.lookups
    qs = data.questions[:4] * 2
    served = []
    say(f"== hybrid: hybrid9 space on the dense engine, retrievers "
        f"{sorted(backend.retrievers)}, shared retrieval cache of "
        f"{cache.maxsize}")
    _zero(counters)
    t0 = time.perf_counter()
    for idx in (3, 7):
        a = space[idx]
        gw = Gateway(FixedPolicy(idx), backend, router_cfg=RouterConfig(),
                     index=index, max_batch=8, adaptive_refusal=False,
                     action_space=space,
                     on_outcome=lambda *o: served.append(o))
        st = gw.serve([Request(qid=q.qid, question=q, slo="quality_first")
                       for q in qs])
        torch.cuda.synchronize()
        say(f"   FixedPolicy({idx}) [{a.retriever}, k={a.k}, {a.mode}]: "
            f"served {st.served}, actions "
            f"{dict(sorted(st.action_counts.items()))}, degraded "
            f"{st.degraded}, retrieval cache hits / lookups "
            f"{st.retrieval_cache_hits} / {st.retrieval_cache_lookups}, "
            f"latency {st.latency_percentiles()}")
        if st.served != len(qs) or dict(st.action_counts) != {idx: len(qs)}:
            raise AssertionError(f"[hybrid] FixedPolicy({idx}): served "
                                 f"{st.served}, actions {st.action_counts}")
        if st.degraded:
            raise AssertionError(f"[hybrid] {st.degraded} degraded "
                                 f"lookups")
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    steps = engine.stats.n_decode_steps - steps0
    chunks = rec["chunks"][chunks0:]
    step_ms = _step_ms(chunks, steps)
    hits, lookups = cache.hits - hits0, cache.lookups - lookups0
    say(f"   hybrid: {steps} decode steps in {len(chunks)} chunks, "
        f"{step_ms:.2f} ms per step (device time of the chunks); serve "
        f"wall {wall:.2f} s; cache hits {hits} of {lookups} lookups in "
        f"this phase; launches {launches}")
    _check_served("hybrid", served, 2 * len(qs), engine)
    if hits <= 0:
        raise AssertionError("[hybrid] no retrieval cache hit")
    _check_launches("hybrid", launches, "flash_decode", steps, n_layers,
                    absent=("paged_flash_decode",))


def _closed_loop_rate(dense: dict) -> tuple:
    """The closed-loop dense run's served requests per second and its
    request-latency p50 (ms), over both of its gateways."""
    import numpy as np
    lat = [v for _, gw in dense["gateways"]
           for v in gw.stats.latency._samples]
    return len(lat) / dense["wall"], float(np.percentile(lat, 50))


def _open_loop(label, backend, index, qs, policy, rate, deadline_ms,
               counters) -> dict:
    """One seeded Poisson trace (seed 0, OPEN_LOOP_REQUESTS requests,
    quality_first) replayed in real time through ``AsyncGateway`` over
    ``backend``'s stream protocol, served by the gateway's background
    thread on the engine's perf_counter clock, every launch count 0 just
    before and read just after.  Checks: every offered request resolved;
    the serving thread ran on cuda:0's default stream and was stopped
    before the engine is freed.  The row carries the run's launches and
    decode steps for the caller to check."""
    import threading
    import torch
    from repro_torch.core.config import RouterConfig
    from repro_torch.serving.streaming import AsyncGateway
    from repro_torch.serving.traffic import (LoadGenerator, PoissonProcess,
                                             build_trace)
    engine = backend.engine
    es = engine.stats
    gw = AsyncGateway(policy, backend, router_cfg=RouterConfig(),
                      index=index, deadline_ms=deadline_ms)
    trace = build_trace(qs, PoissonProcess(rate, seed=0),
                        OPEN_LOOP_REQUESTS, slo="quality_first",
                        deadline_ms=deadline_ms)
    seen, threads = {}, []
    poll, start = backend.stream_poll, gw.start

    def probing_poll():
        if not seen:
            seen.update(thread=threading.current_thread().name,
                        device=torch.cuda.current_device(),
                        default=torch.cuda.current_stream()
                        == torch.cuda.default_stream(0))
        return poll()

    def recording_start(**kw):
        out = start(**kw)
        threads.append(gw._thread)
        return out
    backend.stream_poll, gw.start = probing_poll, recording_start
    steps0, hit0, tok0 = (es.n_decode_steps, es.prefill_tokens_avoided,
                          es.prompt_tokens_total)
    torch.cuda.synchronize()
    _zero(counters)
    t0 = time.perf_counter()
    gen = LoadGenerator(gw, trace)
    try:
        rep = gen.run_realtime(timeout_s=180.0)
    finally:
        del backend.stream_poll
    # stop(drain=False) has joined the thread; nothing of it may still be
    # enqueueing when the caller frees the engine
    if any(t is not None and t.is_alive() for t in threads):
        raise AssertionError(f"[{label}] the serving thread outlived stop()")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    steps = es.n_decode_steps - steps0
    handles = gen.last_handles
    # arrivals are stamped on the gateway's perf_counter clock: each
    # one's lag behind its trace time, from the replay's start
    lags = [h.arrival_t - (t0 + a.t) for h, a in zip(handles, trace)]
    row = {"rate": rate, "trace_rate": rep.offered_rate,
           "submitted_rate": len(handles) / (handles[-1].arrival_t - t0),
           "max_lag_ms":
           max(lags) * 1e3, "rep": rep, "served": gw.stats.served,
           "steps": steps, "launches": launches, "wall": wall,
           "prefix_hits": es.prefill_tokens_avoided - hit0,
           "prompt_tokens": es.prompt_tokens_total - tok0}
    if rep.completed != rep.offered:
        raise AssertionError(f"[{label}] {rep.completed} of {rep.offered} "
                             f"offered requests resolved")
    if (seen.get("device") != 0 or not seen.get("default")
            or seen.get("thread") == threading.main_thread().name):
        raise AssertionError(f"[{label}] serving thread {seen}: not on "
                             f"cuda:0's default stream off the main thread")
    return row


def _say_open_loop(label, row, deadline_ms, extra="") -> None:
    rep = row["rep"]
    lat, ft = rep.latency, rep.first_token
    say(f"   {label} {row['rate']:6.3f}/s nominal, {row['trace_rate']:6.3f} "
        f"trace, {row['submitted_rate']:6.3f} submitted (largest arrival "
        f"lag {row['max_lag_ms']:.1f} ms): served {row['served']}, shed "
        f"{rep.shed}, forced refusals {rep.forced_refusals}, depth clamps "
        f"{rep.depth_clamped}, timed out {rep.timed_out}; goodput "
        f"{rep.goodput:.3f}/s ({rep.goodput_fraction:.4f} within "
        f"{deadline_ms:.0f} ms); latency p50 {lat.percentile(50):.1f} p99 "
        f"{lat.percentile(99):.1f} ms, first token p50 "
        f"{ft.percentile(50):.1f} ms; {row['steps']} decode steps, "
        f"launches {row['launches']}; wall {row['wall']:.2f} s{extra}")


def open_loop_phase(backend, index, qs_per_rate, policy, c, deadline_ms,
                    card, n_layers, counters) -> list:
    """The dense engine (K1) under open-loop Poisson traffic at
    OPEN_LOOP_RATES x ``c`` (each rate over questions of its own, so no
    rate finds another's lookups in the retrieval cache): one row per
    rate, then the highest offered rate whose goodput fraction meets the
    latency target's objective."""
    from repro_torch.serving.slo_budget import latency_target
    t0 = time.perf_counter()
    target = latency_target(deadline_ms).objective
    say(f"== open loop, dense (K1): {OPEN_LOOP_REQUESTS} requests a rate, "
        f"Poisson seed 0, deadline {deadline_ms:.0f} ms, goodput target "
        f"{target:.2f} [{card}]")
    rows = []
    for mult, qs in zip(OPEN_LOOP_RATES, qs_per_rate):
        row = _open_loop("open loop dense", backend, index, qs, policy,
                         mult * c, deadline_ms, counters)
        _say_open_loop(f"{mult:4.2f} x c =", row, deadline_ms)
        _check_launches("open loop dense", row["launches"], "flash_decode",
                        row["steps"], n_layers,
                        absent=("paged_flash_decode",))
        rows.append(row)
    ok = [r for r in rows if r["rep"].goodput_fraction >= target]
    best = max(ok, key=lambda r: r["rate"]) if ok else None
    say(f"   highest offered rate meeting the SLO (goodput fraction >= "
        f"{target:.2f}): " + (
            f"{best['rate']:.3f}/s nominal, {best['submitted_rate']:.3f}/s "
            f"submitted" if best else "none of the rates")
        + f"; open loop {time.perf_counter() - t0:.1f} s")
    return rows


def chaos_plans(n_requests: int) -> dict:
    """``benchmarks/chaos_bench.py``'s four seeded plans (name ->
    FaultPlan); windows in site-invocation counts."""
    from repro_torch.serving.faults import FaultPlan, FaultSpec
    brown = max(4, n_requests // 6)
    return {
        "no_faults": FaultPlan(),
        "retriever_brownout": FaultPlan(specs=(
            FaultSpec(site="retriever.dense", kind="raise", start=4,
                      count=brown),), seed=0),
        "executor_fault_burst": FaultPlan(specs=(
            FaultSpec(site="executor.decode", kind="raise", start=6,
                      count=3),), seed=0),
        "nan_storm": FaultPlan(specs=(
            FaultSpec(site="executor.decode", kind="nan", start=5, count=2,
                      slots=(0, 1)),), seed=0),
    }


def _chaos_run(model, params, tok, index, qs, plan, n_layers, counters, *,
               hardened: bool = True) -> dict:
    """One seeded Poisson trace through AsyncGateway over a fresh dense
    engine with ``plan`` armed, entirely in virtual time
    (``benchmarks/chaos_bench.py::run_scenario`` at the main path's
    engine shape).  ``hardened=False`` is the features-off twin: an
    executor without health checks, no breakers, no retries."""
    import numpy as np
    import torch
    from repro_torch.retrieval.hybrid import (IndexRetriever,
                                              collect_breakers,
                                              resolve_retrievers)
    from repro_torch.routing import ContinuousEngineBackend, FixedPolicy
    from repro_torch.routing.registry import Action, ActionSpace
    from repro_torch.serving.executor import SingleDeviceExecutor
    from repro_torch.serving.faults import ChaosInjector, RetryPolicy
    from repro_torch.serving.streaming import AdmissionConfig, AsyncGateway
    from repro_torch.serving.traffic import (LoadGenerator, PoissonProcess,
                                             VirtualClock, build_trace)
    space = ActionSpace("chaos4", (
        Action(0, 0, "refuse"), Action(1, 1, "guarded", "dense"),
        Action(2, 3, "guarded", "dense"), Action(3, 5, "auto", "dense")))
    clock = VirtualClock()
    injector = ChaosInjector(plan, clock=clock.now, sleep=clock.advance)
    retrievers = {"bm25": IndexRetriever("bm25", index),
                  "dense": IndexRetriever("dense", index)}
    max_len = MAX_PROMPT_LEN + MAX_NEW_TOKENS
    executor = None if hardened else SingleDeviceExecutor(
        model, params, num_slots=NUM_SLOTS, max_len=max_len,
        max_new_cap=MAX_NEW_TOKENS, sync_every=4,
        prefill_batch=PREFILL_BATCH, health_checks=False)
    backend = ContinuousEngineBackend.create(
        model, params, tok, index, num_slots=NUM_SLOTS,
        prefill_batch=PREFILL_BATCH, max_prompt_len=MAX_PROMPT_LEN,
        max_new_tokens=MAX_NEW_TOKENS, sync_every=4, clock=clock.now,
        retrievers=retrievers, chaos=injector, breaker_kw=CHAOS_BREAKER,
        executor=executor)
    if not hardened:
        backend.retrievers, backend.retrieval_cache = resolve_retrievers(
            retrievers, index, breakers=False)
        backend.breakers = collect_breakers(backend.retrievers)
    engine = backend.engine
    tokens, prompts, transient = {}, {}, [0]
    submit, poll, stream_poll = (engine.submit, engine.poll,
                                 backend.stream_poll)

    def recording_submit(rid, prompt, *a, **kw):
        prompts[rid] = tuple(prompt)
        return submit(rid, prompt, *a, **kw)

    def recording_poll():
        done = poll()
        for rid, g in done.items():
            if not g.failed:
                tokens[prompts[rid]] = [int(t) for t in g.tokens]
        return done

    def counting_stream_poll():
        done = stream_poll()
        transient[0] += sum(c.outcome.transient and not c.outcome.timed_out
                            for c in done)
        return done
    engine.submit, engine.poll = recording_submit, recording_poll
    backend.stream_poll = counting_stream_poll
    gw = AsyncGateway(
        FixedPolicy(2), backend, action_space=space,
        state_fn=lambda q: np.zeros((len(q), 1)), clock=clock.now,
        deadline_ms=CHAOS_DEADLINE_MS,
        admission=AdmissionConfig(max_backlog=4 * NUM_SLOTS),
        retry=(RetryPolicy(max_retries=2, backoff_s=0.02) if hardened
               else None))
    trace = build_trace(qs, PoissonProcess(CHAOS_RATE, seed=0),
                        CHAOS_REQUESTS, deadline_ms=CHAOS_DEADLINE_MS)
    gen = LoadGenerator(gw, trace)
    torch.cuda.synchronize()
    _zero(counters)
    t0 = time.perf_counter()
    rep = gen.run_virtual(clock, service_quantum_s=CHAOS_QUANTUM_S)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    recovery = None
    last = injector.last_fire_t()
    if last is not None:
        after = [h.completed_t for h in gen.last_handles
                 if h.outcome is not None and not h.outcome.refused
                 and not getattr(h.outcome, "degraded", False)
                 and h.completed_t is not None and h.completed_t >= last]
        recovery = round(min(after) - last, 4) if after else None
    es = engine.stats
    row = {"rep": rep, "fired": len(injector.fire_log),
           "retries": gw.stats.retries, "faulted": gw.stats.faulted,
           "degraded": gw.stats.degraded, "timed_out": gw.stats.timed_out,
           "shed": gw.stats.shed, "quarantined": es.n_quarantined,
           "nan_trips": es.n_nan_trips, "exec_faults": es.n_exec_faults,
           "watchdog": es.n_watchdog_trips,
           "breaker_trips": sum(b.n_trips for b in backend.breakers.values()),
           "recovery_s": recovery, "tokens": tokens,
           "transient": transient[0], "steps": es.n_decode_steps,
           "launches": launches, "wall": wall,
           "handles": gen.last_handles}
    _check_launches("chaos", launches, "flash_decode", row["steps"],
                    n_layers, absent=("paged_flash_decode",))
    del backend, engine, gw, gen
    return row


def chaos_phase(model, params, tok, index, qs, card, n_layers,
                counters) -> None:
    """The chaos bench's four scenarios on the dense engine (K1) in
    virtual time, each on a fresh engine freed after it, plus the
    features-off twin of ``no_faults``; prints each scenario's counters
    and holds the invariants."""
    t0 = time.perf_counter()
    say(f"== chaos (K1): {CHAOS_REQUESTS} requests a scenario, Poisson "
        f"{CHAOS_RATE:.0f}/s, deadline {CHAOS_DEADLINE_MS:.0f} ms, pump "
        f"quantum {CHAOS_QUANTUM_S * 1e3:.0f} ms (virtual time), chaos4 "
        f"space, FixedPolicy(2), retries 2 x 20 ms, backlog "
        f"{4 * NUM_SLOTS} [{card}]")
    rows = {}
    for name, plan in chaos_plans(CHAOS_REQUESTS).items():
        r = rows[name] = _chaos_run(model, params, tok, index, qs, plan,
                                    n_layers, counters)
        _free_gpu_memory(f"chaos {name}")
        rep = r["rep"]
        say(f"   {name:22s} fired {r['fired']}, retries {r['retries']}, "
            f"faulted {r['faulted']}, degraded {r['degraded']}, quarantined "
            f"{r['quarantined']}, nan trips {r['nan_trips']}, exec faults "
            f"{r['exec_faults']}, timed out {r['timed_out']}, breaker trips "
            f"{r['breaker_trips']}, shed {r['shed']}, recovery "
            f"{r['recovery_s']} s; goodput {rep.goodput:.2f}/s (virtual), "
            f"completed {rep.completed}/{rep.offered}; {r['steps']} decode "
            f"steps, {r['launches']['flash_decode']} K1 launches, wall "
            f"{r['wall']:.2f} s")
        if rep.completed != rep.offered:
            raise AssertionError(f"[chaos {name}] {rep.completed} of "
                                 f"{rep.offered} requests resolved")
    base = rows["no_faults"]
    counts = ("fired", "retries", "faulted", "degraded", "quarantined",
              "nan_trips", "exec_faults", "timed_out", "breaker_trips",
              "watchdog")
    if any(base[k] for k in counts):
        raise AssertionError(f"[chaos no_faults] counters "
                             f"{ {k: base[k] for k in counts} }")
    off = _chaos_run(model, params, tok, index, qs,
                     chaos_plans(CHAOS_REQUESTS)["no_faults"], n_layers,
                     counters, hardened=False)
    _free_gpu_memory("chaos features-off")
    same = off["tokens"] == base["tokens"] and len(base["tokens"]) > 0
    say(f"   no_faults vs features off (no health checks, no breakers, no "
        f"retries): {len(base['tokens'])} requests, greedy tokens "
        f"{'identical' if same else 'DIFFERENT'}")
    if not same:
        raise AssertionError("[chaos no_faults] tokens differ from the "
                             "features-off run")
    brown = rows["retriever_brownout"]
    if brown["degraded"] < 1 or brown["faulted"]:
        raise AssertionError(f"[chaos brownout] degraded "
                             f"{brown['degraded']}, faulted "
                             f"{brown['faulted']}")
    burst = rows["executor_fault_burst"]
    if burst["exec_faults"] != 3 or burst["fired"] != 3 or \
            burst["transient"] != burst["retries"] + burst["faulted"] or \
            not burst["transient"]:
        raise AssertionError(
            f"[chaos burst] exec faults {burst['exec_faults']}, fired "
            f"{burst['fired']}, transient completions {burst['transient']} "
            f"!= retries {burst['retries']} + faulted {burst['faulted']}")
    storm = rows["nan_storm"]
    slots = chaos_plans(CHAOS_REQUESTS)["nan_storm"].specs[0].slots
    if not storm["quarantined"] == storm["nan_trips"] == len(slots):
        raise AssertionError(f"[chaos nan storm] quarantined "
                             f"{storm['quarantined']}, nan trips "
                             f"{storm['nan_trips']}, plan slots {slots}")
    say(f"   burst: {burst['transient']} transient completions = "
        f"{burst['retries']} retried inside the deadline + "
        f"{burst['faulted']} faulted; chaos {time.perf_counter() - t0:.1f} "
        f"s")


class _TimedDecode:
    """A model whose ``decode`` calls are bracketed by CUDA events."""

    def __init__(self, model):
        self.model = model
        self.events = []

    def __getattr__(self, name):
        return getattr(self.model, name)

    def decode(self, *a, **kw):
        import torch
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        out = self.model.decode(*a, **kw)
        e.record()
        self.events.append((s, e))
        return out


def padded_phase(model, params, tok, index, qs, card, n_layers,
                 counters) -> None:
    """The padded-bucket ``Engine`` (K1) on the served params: 8 seeded
    prompts of MAX_PROMPT_LEN tokens, MAX_NEW_TOKENS new, through
    ``Engine.generate`` and ``ContinuousEngine.generate_many`` (8 slots,
    prefill batch 8: the same shapes), greedy tokens identical per
    request trimmed at EOS; then one closed-loop batch of 8 through
    ``Gateway.serve`` over ``EngineBackend`` (one bucket, one
    ``generate`` call).  Each run's wall, decode step (device time of the
    decode calls) and K1 launches."""
    import numpy as np
    import torch
    from repro_torch.core.config import RouterConfig
    from repro_torch.data.tokenizer import trim_at_eos
    from repro_torch.routing import EngineBackend, FixedPolicy, Gateway
    from repro_torch.serving.continuous import ContinuousEngine
    from repro_torch.serving.engine import Engine
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(4, model.cfg.vocab_size,
                                 size=MAX_PROMPT_LEN)) for _ in range(8)]
    max_len = MAX_PROMPT_LEN + MAX_NEW_TOKENS
    say(f"== padded (K1): Engine vs ContinuousEngine, 8 prompts of "
        f"{MAX_PROMPT_LEN} tokens, {MAX_NEW_TOKENS} new [{card}]")

    ce = ContinuousEngine(model, params, num_slots=8, max_len=max_len,
                          max_new_cap=MAX_NEW_TOKENS, sync_every=4,
                          prefill_batch=8)
    rec = _instrument(ce)
    torch.cuda.synchronize()
    _zero(counters)
    t1 = time.perf_counter()
    outs = ce.generate_many(prompts, max_new_tokens=MAX_NEW_TOKENS)
    torch.cuda.synchronize()
    ce_wall = time.perf_counter() - t1
    ce_k1 = counters["flash_decode"].launches
    ce_steps = ce.stats.n_decode_steps
    ce_step_ms = _step_ms(rec["chunks"], ce_steps)
    del ce, rec
    _free_gpu_memory("padded")

    timed = _TimedDecode(model)
    eng = Engine(timed, params, max_len=max_len)
    _zero(counters)
    t1 = time.perf_counter()
    res = eng.generate(prompts, max_new_tokens=MAX_NEW_TOKENS)
    torch.cuda.synchronize()
    pad_wall, pad_k1 = time.perf_counter() - t1, \
        counters["flash_decode"].launches
    pad_step_ms = _step_ms(timed.events, len(timed.events))
    agree = sum(trim_at_eos(res.tokens[i]) == trim_at_eos(outs[i].tokens)
                for i in range(8))
    say(f"   Engine.generate: {res.n_steps} steps, wall {pad_wall:.2f} s, "
        f"decode step {pad_step_ms:.2f} ms, {pad_k1} K1 launches; "
        f"ContinuousEngine.generate_many: {ce_steps} decode steps, wall "
        f"{ce_wall:.2f} s, decode step {ce_step_ms:.2f} ms, {ce_k1} K1 "
        f"launches; {agree} of 8 requests' greedy tokens identical")
    if agree != 8:
        raise AssertionError(f"[padded] {8 - agree} requests' greedy tokens "
                             f"differ from the continuous engine's")
    _check_launches("padded", {"flash_decode": pad_k1}, "flash_decode",
                    len(timed.events), n_layers)

    timed.events = []
    served = []
    gw = Gateway(FixedPolicy(0), EngineBackend(
        Engine(timed, params, max_len=max_len), tok, index,
        max_prompt_len=MAX_PROMPT_LEN, max_new_tokens=MAX_NEW_TOKENS),
        router_cfg=RouterConfig(), index=index, max_batch=8,
        adaptive_refusal=False, on_outcome=lambda *a: served.append(a))
    torch.cuda.synchronize()
    _zero(counters)
    t1 = time.perf_counter()
    st = gw.serve(_requests(qs, 0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = {name: fn.launches for name, fn in counters.items()}
    steps = len(timed.events)
    say(f"   Gateway.serve over EngineBackend: served {st.served}, actions "
        f"{dict(sorted(st.action_counts.items()))}, wall {wall:.2f} s, "
        f"{steps} decode steps at {_step_ms(timed.events, steps):.2f} ms, "
        f"launches {launches}; latency {st.latency_percentiles()}; padded "
        f"{time.perf_counter() - t0:.1f} s")
    if st.served != 8 or any(out.refused for _, _, out, _ in served):
        raise AssertionError(f"[padded] served {st.served}: {served}")
    _check_launches("padded gateway", launches, "flash_decode", steps,
                    n_layers, absent=("paged_flash_decode",))
    del gw, eng, timed


def main_path_phases(card: str, policy) -> dict:
    """qwen1.5-32b FULL behind Gateway.serve, on the dense slot cache
    (then the same engine under open-loop traffic), the chaos scenarios
    and the padded engine on engines of their own, then the paged pool
    (closed and open loop), then the paged int8 pool; ``policy`` (the
    trained router) routes the second batch of each closed loop and the
    open loops.  Returns each kernel's launches on its own closed-loop
    path."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import HashTokenizer, SyntheticSquad
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.paged_flash_decode import paged_flash_decode
    from repro_torch.models import build_model
    from repro_torch.retrieval import (BM25Index, DenseIndex,
                                       build_retriever_suite)
    from repro_torch.routing import ContinuousEngineBackend

    cfg = get_config("qwen1.5-32b", "full")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed=0, device="cuda")
    torch.cuda.synchronize()
    say(f"== main: {cfg.name} FULL, {cfg.n_layers} layers x d_model "
        f"{cfg.d_model}, {model.n_params() / 1e9:.2f} B params bf16, "
        f"seeded init {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    data = SyntheticSquad(n_paragraphs=600, n_questions=1000, seed=0)
    texts = [p.text for p in data.paragraphs]
    index = BM25Index.build(texts)
    counters = {"flash_decode": flash_decode,
                "paged_flash_decode": paged_flash_decode}
    # 8 + 8 counted requests, then 8 for the profiled micro-batch
    qs = data.questions[-16:] + data.questions[-24:-16]
    L = cfg.n_layers

    def backend_for(m, retrieval=None, **engine_kw):
        b = ContinuousEngineBackend.create(
            m, params, HashTokenizer(cfg.vocab_size), index,
            num_slots=NUM_SLOTS, prefill_batch=PREFILL_BATCH,
            max_prompt_len=MAX_PROMPT_LEN, max_new_tokens=MAX_NEW_TOKENS,
            **(retrieval or {}), **engine_kw)
        e = b.engine
        say(f"   engine: num_slots {NUM_SLOTS}, prefill_batch "
            f"{PREFILL_BATCH}, max_len {e.max_len}, {engine_kw or 'dense'}, "
            f"cache allocations {e.stats.cache_allocations}, "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
        return b

    # -- dense slot cache: K1; bm25, dense and hybrid retrievers --------
    backend = backend_for(model, retrieval=dict(
        retrievers=build_retriever_suite(index, DenseIndex.build(texts)),
        retrieval_cache_size=64))
    dense = _drive("dense", backend, index, qs, 2, card, L, counters,
                   policy)
    _check_launches("dense", dense["launches"], "flash_decode",
                    dense["steps"], L, absent=("paged_flash_decode",))
    # read before the profiled batch adds to the gateways' latencies
    c, p50 = _closed_loop_rate(dense)
    profile_phase(dense["gateways"][1][1], _requests(qs, 2),
                  dense["rec"]["batch_wall"])
    hybrid_phase(backend, index, data, dense["rec"], L, counters)
    dense_tokens, dense_step_ms = dense["rec"]["tokens"], \
        dense["rec"]["step_ms"]
    launches = {"flash_decode": dense["launches"]["flash_decode"]}

    # -- open loop on the dense engine: K1 ------------------------------
    deadline_ms = math.ceil(2 * p50 / 100.0) * 100.0
    say(f"== open loop: the closed loop above served c = {c:.3f} "
        f"requests/s, request latency p50 {p50:.1f} ms -> deadline_ms = "
        f"{deadline_ms:.0f} (2 x p50, rounded up to 100 ms)")
    open_qs = [data.questions[100 + 24 * i: 124 + 24 * i]
               for i in range(len(OPEN_LOOP_RATES) + 1)]
    open_loop_phase(backend, index, open_qs[:-1], policy, c, deadline_ms,
                    card, L, counters)
    del dense, backend
    _free_gpu_memory("chaos")

    # -- chaos and the padded engine, each on engines of their own: K1 --
    tok = HashTokenizer(cfg.vocab_size)
    chaos_phase(model, params, tok, index, data.questions[300:324], card,
                L, counters)
    padded_phase(model, params, tok, index, data.questions[400:408], card,
                 L, counters)
    _free_gpu_memory("paged")

    # -- paged pool with prefix sharing: K2 -----------------------------
    paged_kw = dict(paged=True, page_size=PAGE_SIZE, num_pages=NUM_PAGES)
    backend = backend_for(model, **paged_kw)
    paged = _drive("paged", backend, index, qs, 2, card, L, counters,
                   policy)
    _check_paged_launches("paged", paged["launches"], paged["steps"], L,
                          paged["rec"]["short_prefills"])
    es = backend.engine.stats
    tokens = paged["rec"]["tokens"]
    common = [k for k in tokens if k in dense_tokens]
    agree = sum(a == b for k in common
                for a, b in zip(tokens[k], dense_tokens[k]))
    total = sum(min(len(tokens[k]), len(dense_tokens[k])) for k in common)
    say(f"   paged: prefix-hit rate {es.prefill_tokens_avoided} / "
        f"{es.prompt_tokens_total} prompt tokens = "
        f"{es.prefill_tokens_avoided / max(es.prompt_tokens_total, 1):.4f}, "
        f"copy-on-write forks {es.n_cow_forks}, evictions "
        f"{es.n_pages_evicted}, deferred admissions "
        f"{es.n_deferred_admissions}, peak pages in use "
        f"{paged['rec']['peak_pages']} of {NUM_PAGES}")
    say(f"   paged: {agree} of {total} greedy tokens agree with the dense "
        f"phase's, over {len(common)} common prompts; decode step "
        f"{paged['rec']['step_ms']:.2f} ms = "
        f"{paged['rec']['step_ms'] / dense_step_ms:.3f} x the dense step's")
    if es.n_deferred_admissions:
        raise AssertionError(f"[paged] {es.n_deferred_admissions} deferred "
                             f"admissions")
    if es.prefill_tokens_avoided <= 0:
        raise AssertionError("[paged] no prompt token was served from a "
                             "shared page")
    launches["paged_flash_decode"] = paged["launches"]["paged_flash_decode"]

    # -- open loop on the paged engine: K2 ------------------------------
    t0 = time.perf_counter()
    say(f"== open loop, paged (K2): 1.00 x c, {OPEN_LOOP_REQUESTS} requests, "
        f"deadline {deadline_ms:.0f} ms [{card}]")
    short0 = paged["rec"]["short_prefills"]
    row = _open_loop("open loop paged", backend, index, open_qs[-1], policy,
                     c, deadline_ms, counters)
    _say_open_loop("1.00 x c =", row, deadline_ms, extra=(
        f"; prefix-hit rate {row['prefix_hits']} / {row['prompt_tokens']} = "
        f"{row['prefix_hits'] / max(row['prompt_tokens'], 1):.4f}; "
        f"{time.perf_counter() - t0:.1f} s"))
    short = paged["rec"]["short_prefills"] - short0
    say(f"   paged open loop: {short} admission group(s) with a one-token "
        f"suffix (K1 on the prefill scratch)")
    _check_paged_launches("open loop paged", row["launches"], row["steps"],
                          L, short)
    del paged, backend
    _free_gpu_memory("int8")

    # -- paged int8 pool: K2 over the dequantized pool ------------------
    model8 = build_model(dataclasses.replace(cfg, kv_quant_int8=True))
    int8 = _drive("paged int8", backend_for(model8, **paged_kw), index, qs,
                  1, card, L, counters, policy)
    _check_paged_launches("paged int8", int8["launches"], int8["steps"], L,
                          int8["rec"]["short_prefills"])
    return launches


def train_phase(card: str) -> dict:
    """``make_train_step`` (fused loss, the plain attention: the
    reference's only trainable setting) on qwen1.5-32b at full width, 4
    layers, bf16, ``remat="full"``, over the port's ``LMDataset`` at seq
    1024 and batch 4.  Checks finite loss and gradient norm every step,
    params moved, the loss falling, and no K4 launch; prints ms per step
    (CUDA events), tokens/s, peak memory and model FLOPs/s.  Returns the
    trained params and the model."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.lm_dataset import LMDataset
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import build_model
    from repro_torch.models.schema import tree_leaves, zeros_from_schema
    from repro_torch.models.transformer import forward_train_loss
    from repro_torch.training import (OptConfig, adamw_init_schema,
                                      adamw_update, make_train_step)
    full = get_config("qwen1.5-32b", "full")
    model = build_model(dataclasses.replace(full, n_layers=TRAIN_LAYERS))
    cfg = model.cfg
    n = model.n_params()
    say(f"== train: {cfg.name} at full width (d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads = {cfg.n_kv_heads} kv heads, head_dim "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, QKV bias, "
        f"tied embeddings, {cfg.dtype}, remat={cfg.remat!r}), "
        f"{n / 1e9:.3f} B params")
    n_full = build_model(full).n_params()
    say(f"   reduced: n_layers {full.n_layers} -> {cfg.n_layers} (params, "
        f"gradients and AdamW moments of the {full.n_layers}-layer model "
        f"need {n_full / 1e9:.1f} B x 12 B = {n_full * 12 / 1e9:.0f} GB)")
    _free_gpu_memory("train")
    params = model.init(seed=0, device="cuda")
    opt_state = zeros_from_schema(adamw_init_schema(model.schema),
                                  device="cuda")
    ds = LMDataset(cfg, TRAIN_SEQ)
    batches = ds.batches(TRAIN_BATCH)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    say(f"   data: LMDataset stream of {len(ds.stream)} tokens, batch "
        f"{TRAIN_BATCH} x seq {TRAIN_SEQ} = {tokens} tokens a step; "
        f"{TRAIN_STEPS} steps, lr 3e-4, warmup 2")
    step_fn = make_train_step(model, OptConfig(lr=3e-4, warmup_steps=2,
                                               total_steps=TRAIN_STEPS))
    def watched():
        # bf16 weights of ~0.02 move by more than half a rounding step;
        # the norms' ones would not (3e-4 against 2^-8)
        return (params["blocks"]["p0"]["mlp"]["w_down"][0],
                params["blocks"]["p0"]["attn"]["bq"], params["embed"][:4096])
    before = [t.float().clone() for t in watched()]
    events, metrics = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    for _ in range(TRAIN_STEPS):
        batch = {k: torch.from_numpy(v).cuda() for k, v in
                 next(batches).items()}
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        params, opt_state, m = step_fn(params, opt_state, batch)
        end.record()
        events.append((start, end))
        metrics.append(m)
    torch.cuda.synchronize()
    k4_launches = flash_attention.launches
    peak = torch.cuda.max_memory_allocated()
    ms = [s.elapsed_time(e) for s, e in events]
    losses = [float(m["loss"]) for m in metrics]
    gnorms = [float(m["grad_norm"]) for m in metrics]
    say(f"   losses {[round(x, 4) for x in losses]}")
    say(f"   grad_norm {[round(x, 4) for x in gnorms]}")
    say(f"   lr {[float(m['lr']) for m in metrics]}")
    steady = ms[1:]
    step_ms = sum(steady) / len(steady)
    mfu = 6 * n * tokens / (step_ms / 1e3)
    say(f"   ms per step {[round(x, 2) for x in ms]} (CUDA events); steady "
        f"(steps 2..{TRAIN_STEPS}) {step_ms:.2f} ms = "
        f"{tokens / step_ms * 1e3:.0f} tokens/s; model FLOPs/s "
        f"(6 N tokens / step) {mfu / 1e12:.1f} T = {mfu / BF16_OPS_PER_S:.3f}"
        f" of 989 TFLOP/s; peak memory {peak / 2**30:.2f} GiB [{card}]")
    moved = [(t.float() - b).abs().max().item()
             for t, b in zip(watched(), before)]
    say(f"   params moved (max |delta| of w_down[0, 0], bq[0], embed[:4096]): "
        f"{moved}; K4 launches during the train steps: {k4_launches}")
    if not all(math.isfinite(x) for x in losses + gnorms):
        raise AssertionError(f"[train] non-finite loss or grad_norm: "
                             f"{losses}, {gnorms}")
    if not all(x > 0 for x in moved):
        raise AssertionError(f"[train] params did not move: {moved}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"[train] the loss did not fall: {losses}")
    if k4_launches:
        raise AssertionError(f"[train] K4 launched {k4_launches} times in "
                             f"train steps")
    if any(t.requires_grad for t in tree_leaves(params)):
        raise AssertionError("[train] params left requiring grad")
    # where a step's time goes: the optimizer alone (on zero gradients:
    # the same arithmetic) and the forward alone, against the whole step
    zero = [torch.zeros_like(p) for p in tree_leaves(params)]
    opt_ms = cuda_ms(lambda: adamw_update(zero, opt_state, params,
                                          OptConfig()), 3)
    del zero
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: forward_train_loss(params, cfg, batch), 3)
    say(f"   split: AdamW update {opt_ms:.2f} ms, forward_train_loss "
        f"without autograd {fwd_ms:.2f} ms, so forward + backward with the "
        f"recompute about {step_ms - opt_ms:.2f} ms of the {step_ms:.2f} ms "
        f"step")
    say(f"   device time by kernel, one more step (top 10): "
        f"{device_split(lambda: step_fn(params, opt_state, batch), 10)}")
    del opt_state, metrics, before
    remat_check(params, cfg, batch)
    return {"params": params, "model": model, "step_ms": step_ms}


def remat_check(params, cfg, batch) -> None:
    """The three remat modes on the card, one loss and gradient each on
    the same params and batch: the same loss, gradient norms within
    REMAT_RTOL, and the peak memory of each."""
    import torch
    from repro_torch.models.schema import tree_leaves
    from repro_torch.models.transformer import forward_train_loss
    from repro_torch.training.optimizer import global_norm
    leaves = tree_leaves(params)
    out = {}
    for remat in ("full", "dots", "none"):
        c = dataclasses.replace(cfg, remat=remat)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss = forward_train_loss(params, c, batch)
            grads = torch.autograd.grad(loss, leaves)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        out[remat] = (float(loss.detach()), float(global_norm(grads)),
                      torch.cuda.max_memory_allocated() / 2**30)
        del loss, grads
    say("   remat modes, one loss + gradient each on the same batch: "
        + "; ".join(f"{k}: loss {v[0]:.6f}, grad_norm {v[1]:.6f}, peak "
                    f"{v[2]:.2f} GiB" for k, v in out.items()))
    ref_loss, ref_norm, _ = out["full"]
    for k, (loss, norm, _) in out.items():
        if (abs(loss - ref_loss) > REMAT_RTOL * abs(ref_loss)
                or abs(norm - ref_norm) > REMAT_RTOL * ref_norm):
            raise AssertionError(f"[train] remat {k} disagrees with full: "
                                 f"{out}")


def eval_phase(trained: dict, card: str) -> dict:
    """On the trained params, one held batch: ``make_eval_step`` with K4
    (``use_pallas_attention=True``) and with the plain attention, counted
    and timed; ``forward_train_loss`` under ``torch.no_grad()`` with K4;
    a train step with K4 raises the gradient guard.  Returns K4's
    launches on this path."""
    import torch
    from repro_torch.data.lm_dataset import LMDataset
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import build_model
    from repro_torch.models.schema import zeros_from_schema
    from repro_torch.models.transformer import forward_train_loss
    from repro_torch.training import (OptConfig, adamw_init_schema,
                                      make_eval_step, make_train_step)
    params, model = trained["params"], trained["model"]
    k4_model = build_model(dataclasses.replace(model.cfg,
                                               use_pallas_attention=True))
    L = model.cfg.n_layers
    held = {k: torch.from_numpy(v).cuda() for k, v in next(
        LMDataset(model.cfg, TRAIN_SEQ, seed=1).batches(TRAIN_BATCH)).items()}
    plain_eval, k4_eval = make_eval_step(model), make_eval_step(k4_model)
    say(f"== eval: held batch {TRAIN_BATCH} x {TRAIN_SEQ} (LMDataset seed "
        f"1) on the trained params")
    torch.cuda.synchronize()
    flash_attention.launches = 0
    k4_loss = k4_eval(params, held)
    torch.cuda.synchronize()
    launches = flash_attention.launches
    plain_loss = plain_eval(params, held)
    flash_attention.launches = 0
    with torch.no_grad():
        fused = forward_train_loss(params, k4_model.cfg, held)
    torch.cuda.synchronize()
    fused_launches = flash_attention.launches
    k4_ms = cuda_ms(lambda: k4_eval(params, held), 5)
    plain_ms = cuda_ms(lambda: plain_eval(params, held), 5)
    a, b, c = float(k4_loss), float(plain_loss), float(fused)
    rel = abs(a - b) / abs(b)
    say(f"   eval loss with K4 {a:.6f}, plain attention {b:.6f}: relative "
        f"difference {rel:.2e} (tol {EVAL_RTOL:.0e}); forward_train_loss "
        f"under no_grad with K4 {c:.6f}")
    say(f"   K4 launches: {launches} per eval call, {fused_launches} per "
        f"forward_train_loss, for {L} layers; eval step {k4_ms:.2f} ms "
        f"with K4, {plain_ms:.2f} ms plain [{card}]")
    if launches != L or fused_launches != L:
        raise AssertionError(f"[eval] K4 launched {launches} / "
                             f"{fused_launches} times for {L} layers")
    if not (math.isfinite(a) and math.isfinite(c) and rel <= EVAL_RTOL
            and abs(c - b) / abs(b) <= EVAL_RTOL):
        raise AssertionError(f"[eval] losses disagree: K4 {a}, plain {b}, "
                             f"fused {c}")
    opt_state = zeros_from_schema(adamw_init_schema(model.schema),
                                  device="cuda")
    flash_attention.launches = 0
    try:
        make_train_step(k4_model, OptConfig())(params, opt_state, held)
    except RuntimeError as e:
        if "no gradient" not in str(e):
            raise
        say(f"   train step with K4 raises: {e}")
    else:
        raise AssertionError("[eval] a train step through K4 did not raise")
    if int(opt_state["step"]) != 0 or flash_attention.launches:
        raise AssertionError("[eval] the refused train step changed state")
    return {"flash_attention": launches}


def _greedy_gaps(model, params, rec) -> tuple:
    """Each served prompt again, alone, through ``prefill`` and
    ``decode`` on a batch-1 cache, fed the engine's tokens: how many of
    the engine's greedy tokens are the loop's argmax too, and the largest
    gap (max logit - the engine token's logit) over max |logit|."""
    import torch
    agree = total = 0
    worst = 0.0
    with torch.no_grad():
        for prompt, toks in rec["tokens"].items():
            cache = model.init_cache(1, len(prompt) + len(toks), device="cuda")
            lg, _ = model.prefill(params, {"tokens": torch.tensor(
                [prompt], dtype=torch.int64, device="cuda")}, cache)
            for i, t in enumerate(toks):
                row = lg[0, -1]
                gap = (row.max() - row[t]) / row.abs().max()
                agree += int(row.argmax()) == t
                worst = max(worst, float(gap))
                total += 1
                if i + 1 < len(toks):
                    lg, _ = model.decode(params, {"tokens": torch.tensor(
                        [[t]], dtype=torch.int32, device="cuda")}, cache)
    return agree, total, worst


def mamba_serve_phase(card: str, policy) -> None:
    """``mamba2-130m`` FULL (24 layers, d_model 768, seeded bf16 weights,
    not cut) through ``Gateway.serve`` on the dense slot engine: 8 slots,
    prefill batch 4, prompts of 384 tokens, 8 new tokens; 8 requests
    under ``FixedPolicy(0)``, 8 routed by ``policy`` (the trained
    router), every
    launch count 0 just before and read just after.  Checks every request
    served with its tokens, no quarantine, no kernel launched (the cached
    prefill and the O(1) decode step never take K6, as in the
    reference), and each engine token is the greedy choice of the same
    model run per request within TOKEN_GAP_RTOL."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import HashTokenizer, SyntheticSquad
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.paged_flash_decode import paged_flash_decode
    from repro_torch.kernels.ssd_scan import ssd_chunk_scan
    from repro_torch.models import build_model
    from repro_torch.models.ssm import ssm_dims
    from repro_torch.retrieval import BM25Index
    from repro_torch.routing import ContinuousEngineBackend
    cfg = get_config(MAMBA, "full")
    model = build_model(cfg)
    params = model.init(seed=0, device="cuda")
    torch.cuda.synchronize()
    say(f"== mamba serve: {cfg.name} FULL, {cfg.n_layers} layers x d_model "
        f"{cfg.d_model} (d_state {cfg.ssm.d_state}, head_dim "
        f"{cfg.ssm.head_dim}, {ssm_dims(cfg)[1]} heads, chunk "
        f"{cfg.ssm.chunk_size}), {model.n_params() / 1e6:.1f} M params "
        f"{cfg.dtype}, seeded")
    data = SyntheticSquad(n_paragraphs=600, n_questions=1000, seed=0)
    index = BM25Index.build([p.text for p in data.paragraphs])
    backend = ContinuousEngineBackend.create(
        model, params, HashTokenizer(cfg.vocab_size), index,
        num_slots=NUM_SLOTS, prefill_batch=PREFILL_BATCH,
        max_prompt_len=MAX_PROMPT_LEN, max_new_tokens=MAX_NEW_TOKENS)
    counters = {"flash_decode": flash_decode,
                "paged_flash_decode": paged_flash_decode,
                "flash_attention": flash_attention,
                "ssd_chunk_scan": ssd_chunk_scan}
    run = _drive("mamba dense", backend, index, data.questions[-16:], 2,
                 card, cfg.n_layers, counters, policy)
    rec = run["rec"]
    admits = [s_.elapsed_time(e) for s_, e in rec["admits"]]
    say(f"   prefill: {len(admits)} admission groups (prefill batch "
        f"{PREFILL_BATCH}, {sum(map(len, rec['tokens']))} prompt tokens), "
        f"{sum(admits) / max(len(admits), 1):.2f} ms each (device time of "
        f"prefill + commit), {[round(a, 2) for a in admits]}")
    if any(run["launches"].values()):
        raise AssertionError(f"[mamba serve] kernels launched on the "
                             f"serving path: {run['launches']}")
    agree, total, worst = _greedy_gaps(model, params, rec)
    say(f"   {agree} of {total} greedy tokens of {len(rec['tokens'])} "
        f"requests agree with a per-request prefill/decode loop on the "
        f"card; largest gap to that loop's top logit {worst:.2e} of max "
        f"|logit| (tol {TOKEN_GAP_RTOL:.0e}) [{card}]")
    if not total or worst > TOKEN_GAP_RTOL:
        raise AssertionError(f"[mamba serve] engine tokens are not the "
                             f"per-request greedy choice: {worst}")


def mamba_eval_phase(card: str) -> dict:
    """``mamba2-130m`` FULL (seeded bf16 weights) on a held batch of 4 x
    2048 tokens through ``make_eval_step`` with K6 (``use_pallas_ssd``:
    every layer's scan, 24 launches a call) and with the plain chunked
    scan; the losses within MAMBA_EVAL_RTOL.  Returns K6's launches on
    this path."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.lm_dataset import LMDataset
    from repro_torch.kernels.ssd_scan import ssd_chunk_scan
    from repro_torch.models import build_model
    from repro_torch.training import make_eval_step
    cfg = get_config(MAMBA, "full")
    model = build_model(cfg)
    k6_model = build_model(dataclasses.replace(cfg, use_pallas_ssd=True))
    params = model.init(seed=0, device="cuda")
    held = {k: torch.from_numpy(v).cuda() for k, v in next(
        LMDataset(cfg, MAMBA_EVAL_SEQ, seed=1).batches(MAMBA_BATCH)).items()}
    plain_eval, k6_eval = make_eval_step(model), make_eval_step(k6_model)
    say(f"== mamba eval: {cfg.name} FULL, held batch {MAMBA_BATCH} x "
        f"{MAMBA_EVAL_SEQ} (LMDataset seed 1), chunk {cfg.ssm.chunk_size}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ssd_chunk_scan.launches = 0
    k6_loss = k6_eval(params, held)
    torch.cuda.synchronize()
    launches = ssd_chunk_scan.launches
    plain_loss = plain_eval(params, held)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    k6_ms = cuda_ms(lambda: k6_eval(params, held), 3)
    plain_ms = cuda_ms(lambda: plain_eval(params, held), 3)
    a, b = float(k6_loss), float(plain_loss)
    rel = abs(a - b) / abs(b)
    say(f"   eval loss with K6 {a:.6f}, plain scan {b:.6f}: relative "
        f"difference {rel:.2e} (tol {MAMBA_EVAL_RTOL:.0e}); K6 launches "
        f"{launches} per eval call for {cfg.n_layers} layers")
    say(f"   eval step {k6_ms:.2f} ms with K6, {plain_ms:.2f} ms plain; "
        f"peak memory {peak:.2f} GiB [{card}]")
    say(f"   device time by kernel, one eval call with K6 (top 8): "
        f"{device_split(lambda: k6_eval(params, held), 8)}")
    if launches != cfg.n_layers:
        raise AssertionError(f"[mamba eval] K6 launched {launches} times for "
                             f"{cfg.n_layers} layers")
    if not (math.isfinite(a) and rel <= MAMBA_EVAL_RTOL):
        raise AssertionError(f"[mamba eval] losses disagree: K6 {a}, plain "
                             f"{b}")
    return {"ssd_chunk_scan": launches}


def mamba_train_phase(card: str) -> None:
    """``make_train_step`` (fused loss, the plain chunked scan, AdamW) for
    8 steps on ``mamba2-130m`` FULL with ``ssm.chunk_size = 64`` (the
    chunk at which the reference's FULL gradient is finite), seeded bf16
    weights, ``remat="full"``, over ``LMDataset`` at batch 4 x seq 2048.
    Checks finite losses and gradient norms, the last loss below the
    first, no K6 launch, and a train step with ``use_pallas_ssd`` raising
    the gradient guard; prints ms per step, tokens/s, peak memory, and
    the gradient norm at FULL's chunk of 256 (NaN in the reference)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.lm_dataset import LMDataset
    from repro_torch.kernels.ssd_scan import ssd_chunk_scan
    from repro_torch.models import build_model
    from repro_torch.models.schema import tree_leaves, zeros_from_schema
    from repro_torch.models.transformer import forward_train_loss
    from repro_torch.training import (OptConfig, adamw_init_schema,
                                      make_train_step)
    from repro_torch.training.optimizer import global_norm
    full = get_config(MAMBA, "full")
    cfg = dataclasses.replace(full, ssm=dataclasses.replace(
        full.ssm, chunk_size=MAMBA_TRAIN_CHUNK))
    model = build_model(cfg)
    params = model.init(seed=0, device="cuda")
    opt_state = zeros_from_schema(adamw_init_schema(model.schema),
                                  device="cuda")
    batches = LMDataset(cfg, MAMBA_EVAL_SEQ).batches(MAMBA_BATCH)
    tokens = MAMBA_BATCH * MAMBA_EVAL_SEQ
    # the qwen train phase's schedule; at lr 1e-3 dt grows until cum
    # falls by more than 88 within 64 rows, and the gradient turns NaN
    # as at chunk 256 (PERF.md, the Mamba2 findings)
    opt_cfg = OptConfig(lr=3e-4, warmup_steps=2,
                        total_steps=MAMBA_TRAIN_STEPS)
    step_fn = make_train_step(model, opt_cfg)
    say(f"== mamba train: {cfg.name} FULL with chunk_size "
        f"{full.ssm.chunk_size} -> {MAMBA_TRAIN_CHUNK}, remat "
        f"{cfg.remat!r}, batch {MAMBA_BATCH} x seq {MAMBA_EVAL_SEQ} = "
        f"{tokens} tokens a step, {MAMBA_TRAIN_STEPS} steps, lr "
        f"{opt_cfg.lr}, warmup {opt_cfg.warmup_steps}")
    events, metrics = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ssd_chunk_scan.launches = 0
    for _ in range(MAMBA_TRAIN_STEPS):
        batch = {k: torch.from_numpy(v).cuda() for k, v in
                 next(batches).items()}
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        params, opt_state, m = step_fn(params, opt_state, batch)
        end.record()
        events.append((start, end))
        metrics.append(m)
    torch.cuda.synchronize()
    launches = ssd_chunk_scan.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    ms = [s_.elapsed_time(e) for s_, e in events]
    losses = [float(m["loss"]) for m in metrics]
    gnorms = [float(m["grad_norm"]) for m in metrics]
    step_ms = sum(ms[1:]) / len(ms[1:])
    say(f"   losses {[round(x, 4) for x in losses]}")
    say(f"   grad_norm {[round(x, 4) for x in gnorms]}")
    say(f"   ms per step {[round(x, 2) for x in ms]} (CUDA events); steady "
        f"{step_ms:.2f} ms = {tokens / step_ms * 1e3:.0f} tokens/s; peak "
        f"memory {peak:.2f} GiB; K6 launches in the train steps {launches} "
        f"[{card}]")
    say(f"   device time by kernel, one more step (top 8): "
        f"{device_split(lambda: step_fn(params, opt_state, batch), 8)}")
    if not all(math.isfinite(x) for x in losses + gnorms):
        raise AssertionError(f"[mamba train] non-finite loss or grad_norm: "
                             f"{losses}, {gnorms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"[mamba train] the loss did not fall: {losses}")
    if launches:
        raise AssertionError(f"[mamba train] K6 launched {launches} times in "
                             f"train steps")
    # FULL's own chunk of 256: exp(cum_t - cum_s) is inf above the
    # diagonal, and its gradient through the mask is NaN (the reference's
    # too); shown, not trained
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss = forward_train_loss(params, full, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        gn = float(global_norm([g for g in grads if g is not None]))
    finally:
        for p in leaves:
            p.requires_grad_(False)
    say(f"   at chunk {full.ssm.chunk_size}: loss {float(loss.detach()):.6f}, "
        f"gradient norm {gn} (NaN in the reference as well)")
    del loss, grads
    k6_step = make_train_step(build_model(dataclasses.replace(
        cfg, use_pallas_ssd=True)), opt_cfg)
    step0 = int(opt_state["step"])
    try:
        k6_step(params, opt_state, batch)
    except RuntimeError as e:
        if "no gradient" not in str(e):
            raise
        say(f"   train step with K6 raises: {e}")
    else:
        raise AssertionError("[mamba train] a train step through K6 did not "
                             "raise")
    if int(opt_state["step"]) != step0 or ssd_chunk_scan.launches != launches:
        raise AssertionError("[mamba train] the refused step changed state")


def cli_phase(card: str) -> None:
    """``python -m repro_torch.launch.train`` on the card, twice at once
    in two subprocesses: qwen SMOKE (``--arch qwen1.5-32b``) and the
    defaults (``mamba2-130m`` SMOKE), 20 steps each.  Each final loss must
    be finite and below its first, and each checkpoint must load back
    through ``load_checkpoint`` with every leaf equal to the saved
    arrays."""
    import os
    import re
    import tempfile

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.schema import zeros_from_schema
    from repro_torch.training import adamw_init_schema
    from repro_torch.training.checkpoint import _paths, load_checkpoint
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    with tempfile.TemporaryDirectory() as tmp:
        runs = []
        for arch, flags in (("qwen1.5-32b", ["--arch", "qwen1.5-32b",
                                             "--variant", "smoke"]),
                            (MAMBA, [])):
            ckpt = str(Path(tmp) / arch)
            cmd = [sys.executable, "-m", "repro_torch.launch.train", *flags,
                   "--steps", "20", "--ckpt", ckpt]
            runs.append((arch, ckpt, cmd, time.perf_counter(),
                         subprocess.Popen(cmd, cwd=ROOT, env=env,
                                          stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True)))
        for arch, ckpt, cmd, t0, proc in runs:
            out, err = proc.communicate(timeout=600)
            say(f"== cli: {' '.join(cmd[1:-1])} <tmpdir>: exit "
                f"{proc.returncode} in {time.perf_counter() - t0:.1f} s "
                f"(both runs at once)")
            for line in out.splitlines():
                say(f"   | {line}")
            if proc.returncode != 0:
                raise AssertionError(f"[cli {arch}] exit {proc.returncode}: "
                                     f"{err}")
            got = re.search(r"final loss (\S+) \(start (\S+)\)", out)
            final, start = float(got.group(1)), float(got.group(2))
            if not (math.isfinite(final) and final < start):
                raise AssertionError(f"[cli {arch}] final loss {final}, "
                                     f"start {start}")
            model = build_model(get_config(arch, "smoke"))
            step, params, opt = load_checkpoint(
                ckpt, model.init(seed=1, device="cuda"),
                zeros_from_schema(adamw_init_schema(model.schema),
                                  device="cuda"))
            n = 0
            for name, tree in (("params", params), ("opt", opt)):
                with np.load(Path(ckpt) / f"{name}_{step}.npz") as z:
                    for key, leaf in _paths(tree):
                        if not np.array_equal(leaf.float().cpu().numpy(),
                                              z[key].astype(np.float32)):
                            raise AssertionError(
                                f"[cli {arch}] {name} leaf {key} differs "
                                f"from the checkpoint")
                        n += 1
            fresh = model.init(seed=0, device="cuda")
            if step != 20 or int(opt["step"]) != 20 or torch.equal(
                    params["embed"], fresh["embed"]):
                raise AssertionError(f"[cli {arch}] checkpoint step {step}, "
                                     f"opt step {int(opt['step'])}, or "
                                     f"untrained params")
            say(f"   {arch} checkpoint step {step}: {n} leaves loaded back "
                f"equal to the saved arrays [{card}]")


K3_PROFILE_SHAPES = (("main path", SQUAD_PARAGRAPHS, TOP_K),
                     ("main path, k = 64", SQUAD_PARAGRAPHS, 64),
                     ("1M docs", BIG_DOCS, TOP_K))
K3_PROFILE_PHASES = ("products start", "copy issue", "copy wait", "barrier",
                     "split", "products wait", "accumulate", "selection",
                     "query fragments", "proxy fence", "barrier")
K3_PROFILE_STAMPS = ("start", "first stage", "stream end", "grid barrier",
                     "merged")


def _k3_sub(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise SystemExit(f"dense_topk_profile: the source no longer has "
                         f"one {old[:60]!r}; update _k3_probes/_k3_variants")
    return text.replace(old, new)


def _k3_probes(src: str) -> str:
    """The source with per-phase cycle counters and per-block stamps,
    written to two device arrays read back by ``read_probes``."""
    src = _k3_sub(src, "namespace {\n\nconstexpr int kWG", """\
__device__ long long g_cyc[8192][12];
__device__ unsigned long long g_ns[8192][5];
extern "C" int read_k3_probes(void* cyc, void* ns, int n) {
  cudaError_t e = cudaMemcpyFromSymbol(cyc, g_cyc, (size_t)n * 96);
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(ns, g_ns, (size_t)n * 40);
  return (int)e;
}
__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
namespace {

constexpr int kWG""")
    blk = "blockIdx.y * gridDim.x + blockIdx.x"
    src = _k3_sub(src, "  const auto doc0 = ", f"""\
  unsigned long long* const NS = g_ns[{blk}];
  if (tid == 0) {{ NS[0] = now_ns(); NS[1] = NS[2] = NS[3] = NS[4] = 0; }}
  long long P[11] = {{0}}, c0 = 0, c1 = 0;
#define TICK(i) do {{ c1 = clock64(); P[i] += c1 - c0; c0 = c1; }} while (0)
  const auto doc0 = """)
    src = _k3_sub(src, "  if (steps > 0) {\n    split_stage(0);",
                  "  if (tid == 0) NS[1] = now_ns();\n"
                  "  if (steps > 0) {\n    split_stage(0);")
    src = _k3_sub(src, "    start_products(it);\n",
                  "    c0 = clock64();\n    start_products(it);\n"
                  "    TICK(0);\n")
    src = _k3_sub(src, "    const bool more = it + 1 < steps;\n",
                  "    TICK(1);\n    const bool more = it + 1 < steps;\n")
    src = _k3_sub(src, "      cp_async_wait_dyn(p.stages - 2);\n"
                  "      wg_sync(wg);  // stage it + 1 landed, every thread's"
                  " copies\n"
                  "      split_stage(it + 1);\n",
                  "      cp_async_wait_dyn(p.stages - 2);\n      TICK(2);\n"
                  "      wg_sync(wg);\n      TICK(3);\n"
                  "      split_stage(it + 1);\n      TICK(4);\n")
    src = _k3_sub(src, "    fence_regs(alo);\n    const int chunk",
                  "    fence_regs(alo);\n    TICK(5);\n    const int chunk")
    src = _k3_sub(src, "    if (chunk == n_ec - 1) {\n",
                  "    TICK(6);\n    if (chunk == n_ec - 1) {\n")
    src = _k3_sub(src, "    if (more) {\n      load_a(it + 1);\n"
                  "      asm volatile(\"fence.proxy.async.shared::cta;"
                  "\\n\" ::: \"memory\");\n      wg_sync(wg);\n    }\n  }\n",
                  "    TICK(7);\n    if (more) {\n      load_a(it + 1);\n"
                  "      TICK(8);\n"
                  "      asm volatile(\"fence.proxy.async.shared::cta;"
                  "\\n\" ::: \"memory\");\n      TICK(9);\n"
                  "      wg_sync(wg);\n"
                  "      TICK(10);\n    }\n  }\n"
                  f"  if (tid == 0) {{\n    for (int z = 0; z < 11; ++z) "
                  f"g_cyc[{blk}][z] = P[z];\n"
                  f"    g_cyc[{blk}][11] = steps;\n  }}\n")
    src = _k3_sub(src,
                  "  cp_async_wait<0>();\n  __syncthreads();  // the rings",
                  "  cp_async_wait<0>();\n  if (tid == 0) NS[2] = now_ns();\n"
                  "  __syncthreads();  // the rings")
    src = _k3_sub(src, "  grid_barrier(p.bar, p.S * gridDim.y);\n",
                  "  grid_barrier(p.bar, p.S * gridDim.y);\n"
                  "  if (tid == 0) NS[3] = now_ns();\n")
    src = _k3_sub(src,
                  "          p.out_i[(int64_t)(q0 + j) * p.k + pos] = mi[r];"
                  "\n        }\n      }\n  }\n}",
                  "          p.out_i[(int64_t)(q0 + j) * p.k + pos] = mi[r];"
                  "\n        }\n      }\n    if (tid == 0) NS[4] = now_ns();"
                  "\n  }\n}")
    return src


def _k3_variants(src: str) -> dict:
    wg = "      wgmma_tf32(acc, "
    return {
        "no selection": _k3_sub(src, "    if (chunk == n_ec - 1) {\n",
                                "    if (chunk == n_ec - 1 && p.k < 0) {\n"),
        "no products": src.replace(wg, "      if (p.k < 0) wgmma_tf32(acc, "),
        "32-column stages": _k3_sub(src, "int cc = 64, n_wg = 2",
                                    "int cc = 32, n_wg = 2"),
        "one warpgroup, 32-column stages": _k3_sub(
            src, "    if (stages >= 3 && (cc == 32 || slots == 16)) break;",
            "    if (false) break;"),
        "probes": _k3_probes(src),
    }


def _k3_build_variants(variants: dict) -> dict:
    """One ``nvcc`` per variant, all started together, into ``_build``."""
    from repro_torch.kernels import build
    out_dir = build.BUILD_DIR / "profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in variants.items():
        stem = "".join(ch if ch.isalnum() else "_" for ch in name)
        cu, so = out_dir / f"{stem}.cu", out_dir / f"lib{stem}.so"
        cu.write_text(text)
        procs[name] = (so, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-I",
             str(build.CSRC), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"dense_topk_profile: {name} failed to build:"
                             f"\n{log[-4000:]}")
        lib = ctypes.CDLL(str(so))
        lib.dense_topk_f32.argtypes = ([ctypes.c_void_p] * 7
                                       + [ctypes.c_int] * 5
                                       + [ctypes.c_void_p])
        lib.dense_topk_f32.restype = ctypes.c_int
        libs[name] = lib
    return libs


def _k3_call(lib, q, docs, k):
    """The wrapper's launch, through another build of the kernel."""
    import torch
    from repro_torch.kernels import dense_topk as dt
    Q, E = q.shape
    D = docs.shape[0]
    p = dt.plan(D, Q, torch.cuda.get_device_properties(
        q.device).multi_processor_count)
    out_s, out_i = dt._empty(q, k)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    bar, ls, li = dt._scratch(q.device, stream, dt.scratch_sizes(p, k))
    rc = lib.dense_topk_f32(q.data_ptr(), docs.data_ptr(), ls.data_ptr(),
                            li.data_ptr(), bar.data_ptr(), out_s.data_ptr(),
                            out_i.data_ptr(), Q, D, E, k, p.slices, stream)
    if rc:
        raise RuntimeError(f"dense_topk_profile: launch failed: {rc}")
    return out_s, out_i, p


def dense_topk_profile() -> None:
    """Where K3 spends its time (not part of ``main``; run it with
    ``python3 -c "import chip_smoke as c; c.device_phase();
    c.dense_topk_profile()"``).  At the batched retrieval path's shape
    (Q=64 seeded unit queries against D=20,000 unit rows, E=256, k=10),
    the same at k=64, and at D=1,048,576 it times the kernel as built and
    variants of its source built beside it, each with one part taken out
    or changed: ``no selection`` (the tiles' scores never offered),
    ``no products`` (the wgmma products skipped, the lists fed whatever
    the accumulators hold), ``32-column stages`` (the stage width of
    k > 16 for every k), ``one warpgroup, 32-column stages`` (one
    consumer warpgroup a block; 64-column stages need two).  Then, on
    the kernel built with two probes: the cycles a stage of warpgroup 0
    spends in each phase of its loop (``clock64``, the median over
    blocks) and each block's start, first stage, end of its stream, grid
    barrier and merge (``%globaltimer``, us after the first block
    starts).  The variants that compute the same function (the last
    two) are held against the plain version."""
    import numpy as np
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.dense_topk import dense_topk, dense_topk_torch
    build.build_all(["dense_topk"])
    libs = _k3_build_variants(
        _k3_variants((build.CSRC / "dense_topk.cu").read_text()))
    g = torch.Generator(device="cuda").manual_seed(7)

    def unit(n):
        x = torch.randn((n, 256), generator=g, device="cuda")
        return x / x.norm(dim=1, keepdim=True)
    for label, D, k in K3_PROFILE_SHAPES:
        q, docs = unit(64), unit(D)
        iters = 100 if D < BIG_DOCS else 10
        want_s, want_i = dense_topk_torch(q, docs, k=k)
        ms = cuda_ms(lambda: dense_topk(q, docs, k=k), iters)
        line = [f"kernel {ms * 1e3:.2f}"]
        for name in ("no selection", "no products", "32-column stages",
                     "one warpgroup, 32-column stages"):
            lib = libs[name]
            if "stages" in name:
                s, i, _ = _k3_call(lib, q, docs, k)
                err = (s - want_s).abs().max().item()
                if not err <= RETRIEVAL_TOL:
                    raise AssertionError(f"[{label}] {name}: {err}")
            ms = cuda_ms(lambda: _k3_call(lib, q, docs, k), iters)
            line.append(f"{name} {ms * 1e3:.2f}")
        say(f"== dense_topk [{label}: Q=64 D={D} E=256 k={k}] us: "
            + " | ".join(line))
        _, _, p = _k3_call(libs["probes"], q, docs, k)
        torch.cuda.synchronize()
        n = p.slices * p.q_tiles
        cyc = (ctypes.c_longlong * (n * 12))()
        ns = (ctypes.c_ulonglong * (n * 5))()
        if libs["probes"].read_k3_probes(cyc, ns, n):
            raise RuntimeError("dense_topk_profile: probes not read")
        c = np.array(cyc, dtype=np.float64).reshape(n, 12)
        per = np.median(c[:, :11] / np.maximum(c[:, 11:], 1), axis=0)
        say("   cycles a stage, warpgroup 0 (median over blocks): "
            + ", ".join(f"{a} {v:.0f}"
                        for a, v in zip(K3_PROFILE_PHASES, per)))
        t = np.array(ns, dtype=np.float64).reshape(n, 5)
        t0 = t[:, 0].min()
        parts = []
        for col, name in enumerate(K3_PROFILE_STAMPS):
            v = (t[:, col][t[:, col] > 0] - t0) / 1e3
            if len(v):
                parts.append(f"{name} {np.median(v):.2f} (max {v.max():.2f},"
                             f" {len(v)} blocks)")
        say("   us after the first block starts, median: "
            + "; ".join(parts))
        del q, docs
        torch.cuda.empty_cache()


def main() -> None:
    t0 = time.perf_counter()
    card = device_phase()
    report = build_phase()
    rows = [kernel_phase(), paged_kernel_phase(),
            attention_kernel_phase(report)]
    k6 = ssd_kernel_phase()
    retrieval_rows, launches = retrieval_kernel_phase()
    rows += retrieval_rows + [k6]
    small_model_phase()
    router = router_phase(card)
    launches.update(main_path_phases(card, router))
    trained = train_phase(card)
    launches.update(eval_phase(trained, card))
    del trained
    _free_gpu_memory("mamba")
    mamba_serve_phase(card, router)
    launches.update(mamba_eval_phase(card))
    mamba_train_phase(card)
    _free_gpu_memory("cli")
    cli_phase(card)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for row in rows:
        row["launches"] = launches[row["name"]]
    say(f"== total: {time.perf_counter() - t0:.1f} s, every phase passed "
        f"[{card}]")
    # every row has the keys above, in that order; K5's adds kernel_ms
    print(json.dumps({"kernels": [{**{k: row[k] for k in keys}, **row}
                                  for row in rows]}))
    print(card)
    import torch
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
