#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each on its own lines; any failure exits nonzero:

1. device   — the card's name and power limit (``nvidia-smi``); no CUDA
              device is a failure.
2. build    — compile every hand-written kernel from ``src/`` (one
              ``nvcc`` per source, concurrently) and print the build
              seconds and the ``-Xptxas -v`` report.
3. kernels  — hold each kernel against its plain PyTorch version in
              bf16 at the main path's shapes and time the kernel, the
              plain version, the bound and a library yardstick: K1
              flash_decode (dense slot cache), K2 paged_flash_decode
              (block table into a page pool, with a parked slot).
4. small    — the SMOKE decoder in bf16: prefill + decode on the card
              against the same weights on the host.
5. main     — ``qwen1.5-32b`` FULL (64 layers, d_model 5120, seeded
              bf16 weights) served through ``Gateway.serve`` on the
              dense slot cache: 8 requests under ``FixedPolicy(0)``, 8
              under a seeded ``MLPPolicy``.  Checks that K1 was launched
              64 times per decode step, that no slot was quarantined and
              that every generating request produced a token.
6. profile  — 8 more requests under ``torch.profiler``: the card's busy
              and idle share and the kernels that take its time.
7. paged    — the dense engine's buffers freed, the same 16 requests
              on the paged engine (page size 8, 400 pages, prefix
              sharing): K2 launched 64 times per decode step, K1 never,
              every request served, prompt tokens served from shared
              pages, no deferral; prints the prefix-hit rate, forks,
              peak pages, ms per decode step and the greedy tokens that
              agree with the dense phase's.
8. int8     — the paged engine with the int8 KV cache, 8 requests under
              ``FixedPolicy(0)``: K2 launches, no quarantine, tokens.

The last two lines are the JSON kernel table and the device record.
Imports nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 tensor cores
NUM_SLOTS, PREFILL_BATCH = 8, 4
MAX_PROMPT_LEN, MAX_NEW_TOKENS = 384, 8
PAGE_SIZE, NUM_PAGES = 8, 400  # max_len 392 = 49 pages; tables of 50
KERNEL_TOL = 2e-2  # bf16 output: |out| <~ 3 rounds at 2^-8 relative, plus
#                    the kernel's fp32 sums in another order


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


def build_phase() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    report = build.build_all()
    say(f"== build: {len(report)} kernel source(s) in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, r in report.items():
        say(f"   {name}: nvcc {r['seconds']:.2f} s")
        for line in r["compiler_output"].splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                say(f"     {line.strip()}")


def cuda_ms(fn, iters: int = 100) -> float:
    """Mean device time of one ``fn()`` call, by CUDA events around
    ``iters`` back-to-back calls after a warm-up."""
    import torch
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
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


def paged_kernel_phase() -> dict:
    """K2 paged_flash_decode against its plain version at the paged main
    path's shape (page size 8, 50-block tables into 400 pages) and a GQA
    shape, through a shuffled table whose entries past each slot's
    length are stale out-of-range ids, with one slot parked at
    max_blocks * page_size + 1 as an idle slot is.  Returns the
    main-path row of the table."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_flash_decode import (
        paged_flash_decode, paged_flash_decode_torch)
    g = torch.Generator(device="cuda").manual_seed(1)
    B, H, D, ps, MB, NP = 8, 40, 128, PAGE_SIZE, 50, NUM_PAGES
    rows = []
    for label, Hkv in (("main path", 40), ("GQA", 8)):
        def rnd(*shape):
            return torch.randn(shape, generator=g, device="cuda",
                               dtype=torch.bfloat16)
        q, kp, vp = rnd(B, H, D), rnd(NP, ps, Hkv, D), rnd(NP, ps, Hkv, D)
        table = torch.randperm(NP, generator=g, device="cuda")[:B * MB]
        table = table.reshape(B, MB).to(torch.int32)
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
        # gather is excluded: no single PyTorch call reads a table)
        tab = table.long().clamp(0, NP - 1)
        kt = kp[tab].reshape(B, MB * ps, Hkv, D).transpose(1, 2)
        vt = vp[tab].reshape(B, MB * ps, Hkv, D).transpose(1, 2)
        mask = (torch.arange(MB * ps, device="cuda")[None, :]
                < n[:, None])[:, None, None, :]
        q4 = q[:, :, None]

        def library():
            return F.scaled_dot_product_attention(q4, kt, vt, attn_mask=mask,
                                                  enable_gqa=True)
        lib_err = (library()[:, :, 0].float() - want.float()).abs().max()
        ms = cuda_ms(lambda: paged_flash_decode(q, kp, vp, table, lens))
        plain_ms = cuda_ms(
            lambda: paged_flash_decode_torch(q, kp, vp, table, lens))
        library_ms = cuda_ms(library)
        nbytes = (q.numel() * 2 + int(n.long().sum()) * Hkv * D * 2 * 2
                  + table.numel() * 4 + B * 4 + B * H * D * 2)
        nops = int(n.long().sum()) * H * D * 4
        bound_ms = max(nbytes / HBM_BYTES_PER_S,
                       nops / BF16_OPS_PER_S) * 1e3
        say(f"== kernel paged_flash_decode [{label}: B={B} H={H} Hkv={Hkv} "
            f"D={D} page_size={ps} max_blocks={MB} num_pages={NP}, lengths "
            f"{lens.tolist()}]")
        say(f"   max_abs_err {err:.3e} (tol {KERNEL_TOL:.0e}); library "
            f"max_abs_err {float(lib_err):.3e}")
        say(f"   kernel {ms * 1e3:.2f} us | plain {plain_ms * 1e3:.2f} us | "
            f"library (SDPA on pre-gathered rows) {library_ms * 1e3:.2f} us "
            f"| bound {bound_ms * 1e3:.2f} us ({nbytes / 1e6:.2f} MB)")
        if not err <= KERNEL_TOL:
            raise AssertionError(f"paged_flash_decode [{label}] disagrees "
                                 f"with its plain version: {err}")
        rows.append(dict(
            name="paged_flash_decode", route="cuda",
            source="src/repro_torch/kernels/csrc/paged_flash_decode.cu",
            replaces="src/repro/kernels/flash_decode.py:84",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by="bytes", library_ms=library_ms))
        del q, kp, vp, out, want, kt, vt
    torch.cuda.empty_cache()
    return rows[0]


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
    say(f"== profile: one more MLPPolicy micro-batch of {len(reqs)} requests "
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
    """Record, for one engine: CUDA events around each decode chunk, the
    greedy tokens of every finished request keyed by its prompt, and (on
    a paged engine) the peak pages in use after each admission round."""
    import torch
    rec = {"chunks": [], "tokens": {}, "peak_pages": 0}
    prompts = {}
    run_chunk, submit, run = (engine.executor.decode_chunk, engine.submit,
                              engine.run)

    def timed_chunk():
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        run_chunk()
        e.record()
        rec["chunks"].append((s, e))

    def recording_submit(rid, prompt, *a, **kw):
        prompts[rid] = tuple(prompt)
        return submit(rid, prompt, *a, **kw)

    def recording_run():
        done = run()
        for rid, gen in done.items():
            if not gen.failed:
                rec["tokens"][prompts[rid]] = [int(t) for t in gen.tokens]
        return done
    engine.executor.decode_chunk = timed_chunk
    engine.submit, engine.run = recording_submit, recording_run
    if engine._pages is not None:
        admit = engine._start_admissions

        def counting_admit():
            admit()
            rec["peak_pages"] = max(rec["peak_pages"],
                                    engine._pages.pages_in_use)
        engine._start_admissions = counting_admit
    return rec


def _gateways(backend, index, served, n: int):
    """The first ``n`` of: a FixedPolicy(0) gateway, a seeded MLPPolicy
    gateway (quality_first), both over ``backend``."""
    from repro_torch.core.config import RouterConfig
    from repro_torch.core.policy import init_policy
    from repro_torch.routing import FixedPolicy, Gateway, MLPPolicy
    router = RouterConfig()
    gws = [("FixedPolicy(0)", lambda: Gateway(
                FixedPolicy(0), backend, router_cfg=router, index=index,
                max_batch=8, adaptive_refusal=False,
                on_outcome=lambda *a: served.append(a))),
           ("MLPPolicy(seed 0)", lambda: Gateway(
               MLPPolicy(init_policy(0, router, device="cuda"), router),
               backend, router_cfg=router, index=index, max_batch=8,
               on_outcome=lambda *a: served.append(a)))]
    return [(name, make()) for name, make in gws[:n]]


def _requests(qs, i):
    from repro_torch.routing import Request
    return [Request(qid=q.qid, question=q, slo="quality_first")
            for q in qs[8 * i: 8 * i + 8]]


def _drive(label, backend, index, qs, n_batches, card, n_layers,
           counters) -> dict:
    """Serve ``n_batches`` micro-batches of 8 through ``Gateway.serve``
    with every kernel launch count set to 0 just before and read just
    after, then check: every request served, every generating request
    produced its tokens, no slot quarantined.  Returns the launch
    counts, the decode steps, the engine record and the gateways."""
    import torch
    from repro_torch.models.schema import tree_leaves
    engine = backend.engine
    rec = _instrument(engine)
    served = []
    gateways = _gateways(backend, index, served, n_batches)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
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
    step_ms = sum(s.elapsed_time(e) for s, e in rec["chunks"]) / max(steps, 1)
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

    n_req = 8 * n_batches
    if len(served) != n_req:
        raise AssertionError(f"[{label}] {len(served)} of {n_req} requests "
                             f"served")
    for req, action, out, _ in served:
        if out.rejected or (not out.refused
                            and out.cost_tokens < MAX_PROMPT_LEN + 1):
            raise AssertionError(f"[{label}] request {req.qid} "
                                 f"(a{action.idx}) did not generate: {out}")
    if es.n_quarantined or engine.quarantined_slots:
        raise AssertionError(f"[{label}] {es.n_quarantined} slot(s) "
                             f"quarantined (NaN/inf logits or no progress)")
    return {"launches": launches, "steps": steps, "rec": rec,
            "gateways": gateways}


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


def _free_gpu_memory(label: str) -> None:
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    say(f"== {label}: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"allocated after freeing the previous engine")


def main_path_phases(card: str) -> dict:
    """qwen1.5-32b FULL behind Gateway.serve, on the dense slot cache,
    then the paged pool, then the paged int8 pool.  Returns each
    kernel's launches on its own path."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import HashTokenizer, SyntheticSquad
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.paged_flash_decode import paged_flash_decode
    from repro_torch.models import build_model
    from repro_torch.retrieval import BM25Index
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
    index = BM25Index.build([p.text for p in data.paragraphs])
    counters = {"flash_decode": flash_decode,
                "paged_flash_decode": paged_flash_decode}
    # 8 + 8 counted requests, then 8 for the profiled micro-batch
    qs = data.questions[-16:] + data.questions[-24:-16]
    L = cfg.n_layers

    def backend_for(m, **engine_kw):
        b = ContinuousEngineBackend.create(
            m, params, HashTokenizer(cfg.vocab_size), index,
            num_slots=NUM_SLOTS, prefill_batch=PREFILL_BATCH,
            max_prompt_len=MAX_PROMPT_LEN, max_new_tokens=MAX_NEW_TOKENS,
            **engine_kw)
        e = b.engine
        say(f"   engine: num_slots {NUM_SLOTS}, prefill_batch "
            f"{PREFILL_BATCH}, max_len {e.max_len}, {engine_kw or 'dense'}, "
            f"cache allocations {e.stats.cache_allocations}, "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
        return b

    # -- dense slot cache: K1 -------------------------------------------
    dense = _drive("dense", backend_for(model), index, qs, 2, card, L,
                   counters)
    _check_launches("dense", dense["launches"], "flash_decode",
                    dense["steps"], L, absent=("paged_flash_decode",))
    profile_phase(dense["gateways"][1][1], _requests(qs, 2),
                  dense["rec"]["batch_wall"])
    dense_tokens, dense_step_ms = dense["rec"]["tokens"], \
        dense["rec"]["step_ms"]
    launches = {"flash_decode": dense["launches"]["flash_decode"]}
    del dense
    _free_gpu_memory("paged")

    # -- paged pool with prefix sharing: K2 -----------------------------
    paged_kw = dict(paged=True, page_size=PAGE_SIZE, num_pages=NUM_PAGES)
    backend = backend_for(model, **paged_kw)
    paged = _drive("paged", backend, index, qs, 2, card, L, counters)
    _check_launches("paged", paged["launches"], "paged_flash_decode",
                    paged["steps"], L, absent=("flash_decode",))
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
    del paged, backend
    _free_gpu_memory("int8")

    # -- paged int8 pool: K2 over the dequantized pool ------------------
    model8 = build_model(dataclasses.replace(cfg, kv_quant_int8=True))
    int8 = _drive("paged int8", backend_for(model8, **paged_kw), index, qs,
                  1, card, L, counters)
    _check_launches("paged int8", int8["launches"], "paged_flash_decode",
                    int8["steps"], L, absent=("flash_decode",))
    return launches


def main() -> None:
    card = device_phase()
    build_phase()
    rows = [kernel_phase(), paged_kernel_phase()]
    small_model_phase()
    launches = main_path_phases(card)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for row in rows:
        row["launches"] = launches[row["name"]]
    print(json.dumps({"kernels": [{k: row[k] for k in keys}
                                  for row in rows]}))
    print(card)
    import torch
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
