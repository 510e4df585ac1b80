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
              plain version, the bound and a library yardstick.
4. small    — the SMOKE decoder in bf16: prefill + decode on the card
              against the same weights on the host.
5. main     — ``qwen1.5-32b`` FULL (64 layers, d_model 5120, seeded
              bf16 weights) served through ``Gateway.serve``: 8 requests
              under ``FixedPolicy(0)``, 8 under a seeded ``MLPPolicy``.
              Checks that each kernel of the path was launched (64 per
              decode step), that no slot was quarantined and that every
              generating request produced a token.
6. profile  — 8 more requests under ``torch.profiler``: the card's busy
              and idle share and the kernels that take its time.

The last two lines are the JSON kernel table and the device record.
Imports nothing of the JAX package.
"""
from __future__ import annotations

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
    tol = 2e-2   # bf16 output: |out| <~ 3 rounds at 2^-8 relative, plus
    #              the kernel's fp32 sums in another order
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


def main_path_phase(card: str) -> int:
    """qwen1.5-32b FULL behind Gateway.serve.  Returns K1's launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.config import RouterConfig
    from repro_torch.core.policy import init_policy
    from repro_torch.data import HashTokenizer, SyntheticSquad
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.models import build_model
    from repro_torch.retrieval import BM25Index
    from repro_torch.routing import (ContinuousEngineBackend, FixedPolicy,
                                     Gateway, MLPPolicy, Request)

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
    backend = ContinuousEngineBackend.create(
        model, params, HashTokenizer(cfg.vocab_size), index,
        num_slots=NUM_SLOTS, prefill_batch=PREFILL_BATCH,
        max_prompt_len=MAX_PROMPT_LEN, max_new_tokens=MAX_NEW_TOKENS)
    engine = backend.engine
    say(f"   engine: num_slots {NUM_SLOTS}, prefill_batch {PREFILL_BATCH}, "
        f"max_len {engine.max_len}, cache allocations "
        f"{engine.stats.cache_allocations}, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")

    # device time of each decode chunk, by CUDA events around it
    chunks = []
    run_chunk = engine.executor.decode_chunk

    def timed_chunk():
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        run_chunk()
        e.record()
        chunks.append((s, e))
    engine.executor.decode_chunk = timed_chunk

    served = []
    router = RouterConfig()
    # 8 + 8 counted requests, then 8 for the profiled micro-batch
    qs = data.questions[-16:] + data.questions[-24:-16]
    gateways = (
        ("FixedPolicy(0)", Gateway(FixedPolicy(0), backend,
                                   router_cfg=router, index=index,
                                   max_batch=8, adaptive_refusal=False,
                                   on_outcome=lambda *a: served.append(a))),
        ("MLPPolicy(seed 0)", Gateway(
            MLPPolicy(init_policy(0, router, device="cuda"), router),
            backend, router_cfg=router, index=index, max_batch=8,
            on_outcome=lambda *a: served.append(a))))

    def requests(i):
        return [Request(qid=q.qid, question=q, slo="quality_first")
                for q in qs[8 * i: 8 * i + 8]]

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    flash_decode.launches = 0
    t0 = time.perf_counter()
    for i, (name, gw) in enumerate(gateways):
        t_batch = time.perf_counter()
        st = gw.serve(requests(i))
        torch.cuda.synchronize()
        batch_wall = time.perf_counter() - t_batch
        say(f"   {name}: served {st.served}, actions "
            f"{dict(sorted(st.action_counts.items()))}, avg_reward "
            f"{st.avg_reward:+.4f}, rejected {st.rejected}, refusal cap "
            f"history {st.refusal_cap_history}, host wall "
            f"{batch_wall:.2f} s, latency {st.latency_percentiles()}")
    wall = time.perf_counter() - t0
    launches = flash_decode.launches

    es = engine.stats
    steps = es.n_decode_steps
    step_ms = sum(s.elapsed_time(e) for s, e in chunks) / max(steps, 1)
    weight_bytes = model.n_params() * 2
    bound_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    say(f"   engine: admitted {es.n_admitted}, completed {es.n_completed}, "
        f"prefills {es.n_prefills}, decode chunks {es.n_decode_chunks} "
        f"({steps} steps), max concurrent {es.max_concurrent}, "
        f"quarantined {es.n_quarantined}")
    say(f"   decode: {step_ms:.2f} ms per step (device time of the chunks) "
        f"beside the weight-read bound {bound_ms:.2f} ms "
        f"({weight_bytes / 1e9:.1f} GB / 3.35 TB/s); serve wall "
        f"{wall:.2f} s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"[{card}]")
    say(f"   flash_decode launches {launches} = {cfg.n_layers} layers x "
        f"{steps} decode steps")

    if len(served) != 16:
        raise AssertionError(f"{len(served)} of 16 requests served")
    for req, action, out, _ in served:
        if out.rejected or (not out.refused
                            and out.cost_tokens < MAX_PROMPT_LEN + 1):
            raise AssertionError(f"request {req.qid} (a{action.idx}) did not "
                                 f"generate: {out}")
    if es.n_quarantined or engine.quarantined_slots:
        raise AssertionError(f"{es.n_quarantined} slot(s) quarantined "
                             f"(NaN/inf logits or no progress)")
    if steps == 0 or launches != cfg.n_layers * steps:
        raise AssertionError(f"flash_decode launched {launches} times for "
                             f"{steps} decode steps of {cfg.n_layers} layers")
    profile_phase(gateways[1][1], requests(2), batch_wall)
    return launches


def main() -> None:
    card = device_phase()
    build_phase()
    row = kernel_phase()
    small_model_phase()
    row["launches"] = main_path_phase(card)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: row[k] for k in keys}]}))
    print(card)
    import torch
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
