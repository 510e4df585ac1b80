"""Model façade: bundle schema + forward fns for a ModelConfig."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

from repro_torch.core.config import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.schema import (init_from_schema, n_params,
                                       zeros_from_schema)


@dataclass
class Model:
    cfg: ModelConfig
    schema: Dict[str, Any]

    def init(self, seed: int = 0, *, device="cuda") -> Dict[str, Any]:
        """Seeded random weights in ``cfg.dtype``, made on ``device``."""
        return init_from_schema(self.schema, seed=seed,
                                device=resolve_device(device))

    def n_params(self) -> int:
        return n_params(self.schema)

    def cache_schema(self, batch: int, max_len: int):
        return T.init_cache_schema(self.cfg, batch, max_len)

    def init_cache(self, batch: int, max_len: int, *, device="cuda"):
        return zeros_from_schema(self.cache_schema(batch, max_len),
                                 device=resolve_device(device))

    # forward passes --------------------------------------------------
    def prefill(self, params, inputs, cache):
        return T.forward_prefill(params, self.cfg, inputs, cache)

    def decode(self, params, inputs, cache):
        return T.forward_decode(params, self.cfg, inputs, cache)


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg=cfg, schema=T.decoder_param_schema(cfg))
