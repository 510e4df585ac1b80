"""End-to-end serving example: batched requests through the full stack.

 request batch -> Gateway (unified routing API)
               -> RoutingPolicy (trained Argmax-CE MLP)
               -> retrieval at the routed depth
               -> a decoder (qwen SMOKE, seeded weights) generating
                  answers token by token through a KV-cache engine:
                  the continuous engine's shared decode stream, or
                  (``--engine padded``) one padded ``Engine.generate``
                  call per action bucket
               -> per-SLO reward + error-budget accounting.

The generation quality of the small local model is irrelevant — the
point is the full serving path through the one ``Gateway`` entry point.
Runs on the card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.examples.serve_rag_slo \\
        --slo quality_first [--engine padded] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

from repro_torch.configs import get_config
from repro_torch.core.config import TestbedConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.offline_log import build_testbed
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.models import build_model
from repro_torch.routing import (ContinuousEngineBackend, EngineBackend,
                                 Gateway, MLPPolicy, Request,
                                 get_slo_profile, list_slo_profiles)
from repro_torch.serving.continuous import ContinuousEngine
from repro_torch.serving.engine import Engine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--slo", default="quality_first",
                    choices=list_slo_profiles())
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--engine", default="continuous",
                    choices=("continuous", "padded"),
                    help="continuous = slot-based shared decode stream; "
                         "padded = serial per-bucket engine")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    profile = get_slo_profile(args.slo)

    print("# building testbed + routing policy ...")
    cfg = TestbedConfig(n_train=300, n_eval=100, n_paragraphs=200)
    data, index, pipe, train_log, eval_log = build_testbed(cfg)
    policy = MLPPolicy.train(train_log, train_log.rewards(profile),
                             cfg.router, objective="argmax_ce",
                             device=device)

    print(f"# loading the generation backend (qwen SMOKE) on {device}")
    mcfg = get_config("qwen1.5-32b", "smoke")
    model = build_model(mcfg)
    params = model.init(seed=0, device=device)
    tok = HashTokenizer(mcfg.vocab_size)
    # slot caches must hold the padded prompt plus the generation
    # budget; the backend pads every prompt to max_prompt_len
    max_prompt_len = 384
    max_len = max_prompt_len + args.max_new_tokens
    if args.engine == "continuous":
        engine = ContinuousEngine(model, params, num_slots=args.batch,
                                  max_len=max_len,
                                  max_new_cap=args.max_new_tokens,
                                  prefill_batch=args.batch)
        backend_cls = ContinuousEngineBackend
    else:
        engine = Engine(model, params, max_len=max_len)
        backend_cls = EngineBackend

    def report(req, action, out, rew):
        status = "REFUSED(pre)" if out.refused else out.answer
        print(f"  a{action.idx} (k={action.k:2d},{action.mode:7s}) "
              f"cost={out.cost_tokens:6.0f}  {status:22s} "
              f"q: {req.question.text[:44]}")

    gateway = Gateway(
        policy,
        backend_cls(engine, tok, index, max_prompt_len=max_prompt_len,
                    max_new_tokens=args.max_new_tokens),
        router_cfg=cfg.router, index=index, max_batch=args.batch,
        adaptive_refusal=False, on_outcome=report)

    reqs = [Request(qid=q.qid, question=q, slo=args.slo)
            for q in data.questions[-args.batch:]]
    print(f"# serving {args.batch} requests under SLO={args.slo} "
          f"({args.engine} engine)\n")
    t0 = time.perf_counter()
    stats = gateway.serve(reqs)
    dt = time.perf_counter() - t0

    print(f"\nbatch served in {dt:.1f}s; avg SLO reward "
          f"{stats.avg_reward:+.4f}; actions {dict(stats.action_counts)}")
    return stats


if __name__ == "__main__":
    main()
