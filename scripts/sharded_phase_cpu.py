"""CPU rehearsal of ``chip_smoke.py``'s multi-GPU serving phases.

    PYTHONPATH=src python scripts/sharded_phase_cpu.py      # ~30 s

Runs ``distributed_retrieval_phase`` and ``sharded_serve_phase`` at
SMOKE size on the host: the serving mesh is a gloo world of one (its
device resolved to the CPU), the decode and retrieval wrappers are
swapped for their plain versions that add to the wrappers' launch
counts, ``torch.cuda``'s events, synchronisation and memory counters are
stand-ins, and the serve CLI builds a small testbed.  It finds wrong
paths, shapes and control flow before a card run; every time it prints
is the host's, not a device measurement.
"""
from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as c  # noqa: E402
import repro_torch.launch.mesh as mesh_mod  # noqa: E402
import repro_torch.launch.serve as serve  # noqa: E402
import repro_torch.models.layers as layers  # noqa: E402
import repro_torch.retrieval.distributed as distributed  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.config import RouterConfig, TestbedConfig  # noqa: E402
from repro_torch.data import HashTokenizer, SyntheticSquad  # noqa: E402
from repro_torch.kernels import bm25 as k5  # noqa: E402
from repro_torch.kernels import dense_topk as k3  # noqa: E402
from repro_torch.kernels import flash_decode as k1  # noqa: E402
from repro_torch.kernels import paged_flash_decode as k2  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.retrieval import BM25Index, DenseIndex  # noqa: E402
from repro_torch.routing import (ContinuousEngineBackend,  # noqa: E402
                                 FixedPolicy)


class _Event:
    """``torch.cuda.Event`` on the host's clock."""

    def __init__(self, **kw):
        self.t = 0.0

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3

    def synchronize(self):
        pass


def _counted(wrapper, plain):
    def call(*a, **kw):
        wrapper.launches += 1
        return plain(*a, **kw)
    return call


def main() -> None:
    cpu = torch.device("cpu")
    small = TestbedConfig(n_train=60, n_eval=40, n_paragraphs=60,
                          router=RouterConfig(n_epochs=4))
    patches = [
        mock.patch.object(torch.cuda, "Event", _Event),
        *(mock.patch.object(torch.cuda, name, lambda *a: None) for name in
          ("synchronize", "empty_cache", "reset_peak_memory_stats",
           "set_sync_debug_mode", "_sleep")),
        *(mock.patch.object(torch.cuda, name, lambda *a: 0) for name in
          ("memory_allocated", "max_memory_allocated")),
        mock.patch.object(torch.cuda.nccl, "version", lambda: (0, 0, 0)),
        mock.patch.object(mesh_mod, "resolve_device", lambda d="cuda": cpu),
        mock.patch.object(serve, "resolve_device", lambda d="cuda": cpu),
        mock.patch.object(serve, "TestbedConfig", lambda: small),
        mock.patch.object(layers, "flash_decode",
                          _counted(k1.flash_decode, k1.flash_decode_torch)),
        mock.patch.object(layers, "paged_flash_decode",
                          _counted(k2.paged_flash_decode,
                                   k2.paged_flash_decode_torch)),
        mock.patch.object(distributed, "dense_topk",
                          _counted(k3.dense_topk, k3.dense_topk_torch)),
        mock.patch.object(distributed, "bm25_scores",
                          _counted(k5.bm25_scores, k5.bm25_scores_torch)),
        mock.patch.object(c, "MAX_PROMPT_LEN", 56),
    ]
    for p in patches:
        p.start()

    # distributed retrieval over 200 paragraphs and 16 questions
    data = SyntheticSquad(n_paragraphs=200, n_questions=16, seed=0)
    texts = [p.text for p in data.paragraphs]
    questions = [q.text for q in data.questions]
    bm25, dense = BM25Index.build(texts), DenseIndex.build(texts)
    qtf = torch.from_numpy(np.stack([bm25.query_vector(t)
                                     for t in questions]))
    ids, _ = dense.topk_batch(questions, c.TOP_K, device="cpu")
    launches = c.distributed_retrieval_phase(dense, bm25, questions, qtf,
                                             ids, bm25.scores_batch(qtf))

    # qwen SMOKE on one device, then through ShardedExecutor
    cfg = dataclasses.replace(get_config("qwen1.5-32b", "smoke"),
                              dtype="float32")
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu")
    data = SyntheticSquad(n_paragraphs=60, n_questions=40, seed=0)
    index = BM25Index.build([p.text for p in data.paragraphs])
    qs = data.questions[-16:]
    counters = {"flash_decode": k1.flash_decode,
                "paged_flash_decode": k2.paged_flash_decode}
    paged_kw = dict(paged=True, page_size=8, num_pages=64)
    single = {}
    for kind, kw in (("dense", {}), ("paged", paged_kw)):
        backend = ContinuousEngineBackend.create(
            model, params, HashTokenizer(cfg.vocab_size), index,
            num_slots=c.NUM_SLOTS, prefill_batch=c.PREFILL_BATCH,
            max_prompt_len=c.MAX_PROMPT_LEN,
            max_new_tokens=c.MAX_NEW_TOKENS, **kw)
        run = c._drive(kind, backend, index, qs, 1, "cpu", cfg.n_layers,
                       counters, FixedPolicy(0))
        single[kind] = (run["rec"]["tokens"], run["rec"]["step_ms"])
    c.sharded_serve_phase("cpu", model, params, index, qs, FixedPolicy(0),
                          single, paged_kw, launches)
    print("sharded phases rehearsed on the CPU: every check passed")


if __name__ == "__main__":
    main()
