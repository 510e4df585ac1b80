"""Batched generation engine: prefill + decode loop over a KV cache.

The padded-bucket baseline the continuous engine replaced: one call
serves one bucket of prompts, right-padded to the bucket's longest, on
a dense cache allocated for that call on the params' device; greedy
prefill, then one decode step at a time until every row has emitted EOS
or the token budget is spent.  On a CUDA device each decode step's
attention is the K1 kernel (``models/layers.py``'s single-query branch).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from repro_torch.data.tokenizer import EOS, PAD
from repro_torch.models.schema import tree_leaves


@dataclass
class GenerationResult:
    tokens: np.ndarray       # (B, T_out)
    n_steps: int


class Engine:
    """Greedy generation for one bucket of prompts a call, on the device
    holding ``params``."""

    def __init__(self, model, params, *, max_len: int = 512):
        self.model = model
        self.params = params
        self.max_len = max_len
        leaves = tree_leaves(params)
        if not leaves:
            raise ValueError("Engine needs params (their device is where "
                             "it allocates the cache)")
        self.device = leaves[0].device

    @staticmethod
    def _argmax(logits: torch.Tensor) -> torch.Tensor:
        return logits[:, -1].argmax(dim=-1).to(torch.int32)

    @torch.no_grad()
    def generate(self, prompts: List[List[int]], max_new_tokens: int = 16
                 ) -> GenerationResult:
        B = len(prompts)
        plen = max(len(p) for p in prompts)
        toks = np.full((B, plen), PAD, np.int64)
        for i, p in enumerate(prompts):
            toks[i, :len(p)] = p  # right-pad; simple bucket
        cache = self.model.init_cache(B, plen + max_new_tokens,
                                      device=self.device)
        logits, cache = self.model.prefill(
            self.params, {"tokens": torch.from_numpy(toks).to(self.device)},
            cache)
        nxt = self._argmax(logits)
        out = [nxt.cpu().numpy()]
        # per-sequence finished flags: a sequence is done once it has
        # emitted EOS at least once; stop when every sequence has
        done = out[0] == EOS
        steps = 1
        for _ in range(max_new_tokens - 1):
            if done.all():
                break
            logits, cache = self.model.decode(
                self.params, {"tokens": nxt[:, None]}, cache)
            nxt = self._argmax(logits)
            out.append(nxt.cpu().numpy())
            done |= out[-1] == EOS
            steps += 1
        return GenerationResult(np.stack(out, axis=1), steps)
