"""Shape stand-ins for every (arch x input shape) pair on a mesh.

An own copy of the reference's ``launch/specs.py``.  The reference's
stand-in is a ``jax.ShapeDtypeStruct`` carrying a ``NamedSharding``,
ready for ``jax.jit(...).lower(...)``; the port's is :class:`ShardedShape`,
which carries the global ``(shape, dtype, spec)`` and the shape of one
rank's shard.  Nothing here allocates memory or touches a device: the
specs resolve on a layout-only mesh as well
(:func:`repro_torch.launch.mesh.make_production_mesh`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

from repro_torch.configs import INPUT_SHAPES
from repro_torch.core.config import ModelConfig
from repro_torch.models.schema import ParamSpec
from repro_torch.models.transformer import (decoder_param_schema,
                                            init_cache_schema)
from repro_torch.sharding import (input_sharding, local_shape,
                                  mesh_axis_sizes, specs_for_schema)
from repro_torch.training.optimizer import adamw_init_schema


@dataclass(frozen=True)
class ShardedShape:
    """A global array's shape, dtype name and spec on a mesh, and the
    shape of one rank's shard (``local``)."""
    shape: Tuple[int, ...]
    dtype: str
    spec: tuple
    local: Tuple[int, ...]


def _sds(shape, dtype, mesh, spec) -> ShardedShape:
    shape = tuple(shape)
    return ShardedShape(shape, dtype, tuple(spec),
                        local_shape(shape, spec, mesh))


def _batch_sds(shape, dtype, mesh, batch) -> ShardedShape:
    return _sds(shape, dtype, mesh, input_sharding(mesh, batch, len(shape)))


def batch_specs(cfg: ModelConfig, shape_name: str, mesh) -> Dict[str, Any]:
    """Train / prefill / decode batch stand-ins (tokens, labels, the
    modality inputs)."""
    sh = INPUT_SHAPES[shape_name]
    B, S = sh["global_batch"], sh["seq_len"]
    kind = sh["kind"]

    specs: Dict[str, Any] = {}
    if kind == "decode":
        specs["tokens"] = _batch_sds((B, 1), "int32", mesh, B)
        return specs

    s_txt = S - cfg.n_modality_tokens if cfg.modality == "vision" else S
    specs["tokens"] = _batch_sds((B, s_txt), "int32", mesh, B)
    if kind == "train":
        specs["labels"] = _batch_sds((B, s_txt), "int32", mesh, B)
    if cfg.modality == "vision":
        specs["image_emb"] = _batch_sds(
            (B, cfg.n_modality_tokens, cfg.modality_embed_dim), cfg.dtype,
            mesh, B)
    if cfg.modality == "audio":
        specs["audio_emb"] = _batch_sds(
            (B, cfg.encoder_seq_len, cfg.d_model), cfg.dtype, mesh, B)
    return specs


def _schema_sds(schema, mesh, *, fsdp: bool, ep: bool = False):
    return _zip_specs(schema, specs_for_schema(schema, mesh, fsdp=fsdp,
                                               ep=ep), mesh)


def _zip_specs(schema, specs, mesh):
    """The stand-ins of a ParamSpec tree and its spec tree."""
    if isinstance(schema, ParamSpec):
        return _sds(schema.shape, schema.dtype, mesh, specs)
    if isinstance(schema, dict):
        return {k: _zip_specs(v, specs[k], mesh) for k, v in schema.items()}
    return [_zip_specs(v, s, mesh) for v, s in zip(schema, specs)]


def param_specs(cfg: ModelConfig, mesh, *, ep: bool = False):
    """The decoder's parameters under FSDP (and EP with ``ep``)."""
    return _schema_sds(decoder_param_schema(cfg), mesh, fsdp=True, ep=ep)


def opt_specs(cfg: ModelConfig, mesh, *, ep: bool = False):
    """The AdamW state, sharded as the parameters (ZeRO)."""
    return _schema_sds(adamw_init_schema(decoder_param_schema(cfg)), mesh,
                       fsdp=True, ep=ep)


def cache_specs(cfg: ModelConfig, shape_name: str, mesh):
    """The decode cache at the shape's batch and length."""
    sh = INPUT_SHAPES[shape_name]
    B, S = sh["global_batch"], sh["seq_len"]
    return _schema_sds(init_cache_schema(cfg, B, S), mesh, fsdp=False)


def use_ep(cfg: ModelConfig, mesh) -> bool:
    """Expert parallelism: only when the experts divide the data axis."""
    if cfg.moe is None:
        return False
    return cfg.moe.n_experts % mesh_axis_sizes(mesh)["data"] == 0
