"""Three-term roofline per (arch x input shape x mesh) on the H100.

An own copy of the reference's ``analysis/roofline.py``.  Terms
(seconds per training / serving step, whole mesh):

    compute    = FLOPs / (cards x 989e12 bf16 FLOP/s)
    memory     = HBM bytes / (cards x 3.35e12 B/s)
    collective = collective bytes per card / 450e9 B/s (NVLink)

with the card's rates from :mod:`repro_torch.launch.mesh`.  The terms
come from the closed-form workload models below; the dry run's records
(:mod:`repro_torch.launch.dryrun`) give the counted FLOPs beside them.
MODEL_FLOPS = 6 N(active) D is the "useful work" yardstick; its ratio to
the counted FLOPs exposes remat and redundant work.

Unlike the reference, the counted FLOPs are not scaled by microbatches
x blocks: XLA's cost analysis counts a while body once, but the dry
run's ``FlopCounterMode`` counts every op it executes, every layer and
microbatch, on one rank; the whole mesh's count is that x cards.

``python -m repro_torch.analysis.roofline [--mesh single|multi]`` prints
the table of the records in ``experiments/dryrun_torch/``.
"""
from __future__ import annotations

import argparse
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional

from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.core.config import ModelConfig
from repro_torch.launch.mesh import HBM_BW, LINK_BW, PEAK_FLOPS_BF16
from repro_torch.models.transformer import layer_structure

DRYRUN_DIR = Path(__file__).resolve().parents[3] / "experiments" / \
    "dryrun_torch"


# ---------------------------------------------------------------------------
# Parameter counts (the reference's ModelConfig.n_params / n_active_params)
# ---------------------------------------------------------------------------


def _attn_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    if cfg.attn_type == "mla":
        m = cfg.mla
        qd = m.qk_nope_head_dim + m.qk_rope_head_dim
        q_in = m.q_lora_rank or d
        p = (d * m.q_lora_rank if m.q_lora_rank else 0)
        p += q_in * cfg.n_heads * qd
        p += d * (m.kv_lora_rank + m.qk_rope_head_dim)
        p += m.kv_lora_rank * cfg.n_heads * (m.qk_nope_head_dim
                                             + m.v_head_dim)
        p += cfg.n_heads * m.v_head_dim * d
        return p
    hd = cfg.head_dim
    return (d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
            + cfg.n_heads * hd * d)


def _ssm_params(cfg: ModelConfig) -> int:
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nheads = d_inner // s.head_dim
    p = cfg.d_model * (2 * d_inner + 2 * s.n_groups * s.d_state + nheads)
    return p + d_inner * cfg.d_model  # out proj


def _layer_params(cfg: ModelConfig, i: int, active_only: bool = False) -> int:
    d = cfg.d_model
    kind = cfg.layer_kind(i)
    p = _ssm_params(cfg) if kind == "M" else _attn_params(cfg)
    if cfg.is_moe_layer(i):
        e = cfg.moe
        n_e = e.top_k if active_only else e.n_experts
        p += 3 * d * e.d_ff_expert * (n_e + e.n_shared_experts)
        p += d * e.n_experts  # router
    elif kind == "A" or cfg.arch_type != "ssm":
        p += 3 * d * cfg.d_ff
    return p


def n_params(cfg: ModelConfig) -> int:
    """Approximate parameter count (for roofline 6ND napkin math)."""
    d, v = cfg.d_model, cfg.padded_vocab
    total = v * d  # embed
    if not cfg.tie_embeddings:
        total += v * d
    for i in range(cfg.n_layers):
        total += _layer_params(cfg, i)
    if cfg.is_encoder_decoder:
        for _ in range(cfg.n_encoder_layers):
            total += _attn_params(cfg) + 3 * d * cfg.d_ff
    return total


def n_active_params(cfg: ModelConfig) -> int:
    """Active params per token (MoE top-k only)."""
    total = cfg.padded_vocab * cfg.d_model
    for i in range(cfg.n_layers):
        total += _layer_params(cfg, i, active_only=True)
    return total


# ---------------------------------------------------------------------------
# Closed-form workload models (per global step, whole job)
# ---------------------------------------------------------------------------


def _attn_layer_flops(cfg: ModelConfig, Tq: int, Skv: int,
                      causal_frac: float) -> float:
    """One attention layer, one sequence: projections + scores + AV."""
    d, H, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if cfg.attn_type == "mla":
        m = cfg.mla
        qd = m.qk_nope_head_dim + m.qk_rope_head_dim
        q_in = m.q_lora_rank or d
        proj = 2 * Tq * (d * (m.q_lora_rank or 0) + q_in * H * qd
                         + d * (m.kv_lora_rank + m.qk_rope_head_dim))
        # latent -> per-head k/v expansion over the whole kv span
        proj += 2 * Skv * m.kv_lora_rank * H * (m.qk_nope_head_dim
                                                + m.v_head_dim)
        proj += 2 * Tq * H * m.v_head_dim * d
        att = 2 * Tq * Skv * H * (qd + m.v_head_dim) * causal_frac
        return proj + att
    proj = 2 * Tq * d * (2 * H * Dh + 2 * Hkv * Dh)
    att = 2 * Tq * Skv * H * Dh * 2 * causal_frac
    return proj + att


def _ssm_layer_flops(cfg: ModelConfig, T: int) -> float:
    s = cfg.ssm
    d = cfg.d_model
    d_inner = s.expand * d
    H = d_inner // s.head_dim
    gn = s.n_groups * s.d_state
    proj = 2 * T * d * (2 * d_inner + 2 * gn + H) + 2 * T * d_inner * d
    c = s.chunk_size
    # intra-chunk: CB^T (c·N) + masked matmul (c·hd); inter: state ops
    ssd = 2 * T * H * (c * s.d_state + c * s.head_dim
                       + 2 * s.d_state * s.head_dim)
    return proj + ssd


def _moe_layer_flops(cfg: ModelConfig, T: int) -> float:
    e = cfg.moe
    active = e.top_k + e.n_shared_experts
    return 2 * T * cfg.d_model * 3 * e.d_ff_expert * active \
        + 2 * T * cfg.d_model * e.n_experts  # router


def _mlp_layer_flops(cfg: ModelConfig, T: int) -> float:
    return 2 * T * cfg.d_model * 3 * cfg.d_ff


def forward_flops(cfg: ModelConfig, B: int, Tq: int, Skv: int,
                  causal_frac: float = 0.5) -> float:
    """Whole-model forward FLOPs for B sequences."""
    prefix, block, n_blocks = layer_structure(cfg)
    sigs = prefix + block * n_blocks
    total = 0.0
    for s in sigs:
        if s.kind == "M":
            total += _ssm_layer_flops(cfg, Tq)
        else:
            skv_eff = min(Skv, s.window) if s.window else Skv
            cf = causal_frac if (Tq == Skv and not s.window) else 1.0
            total += _attn_layer_flops(cfg, Tq, skv_eff, cf)
            if s.cross:
                total += _attn_layer_flops(cfg, Tq, cfg.encoder_seq_len, 1.0)
        if s.is_moe:
            total += _moe_layer_flops(cfg, Tq)
        elif s.kind == "A" or cfg.d_ff:
            total += _mlp_layer_flops(cfg, Tq)
    if cfg.is_encoder_decoder:
        enc = cfg.encoder_seq_len
        total += cfg.n_encoder_layers * (_attn_layer_flops(cfg, enc, enc, 1.0)
                                         + _mlp_layer_flops(cfg, enc))
    total += 2 * Tq * cfg.d_model * cfg.padded_vocab      # unembed
    return total * B


def _shape(shape) -> tuple:
    """``(kind, B, S)`` of an ``INPUT_SHAPES`` name or of a dict with its
    keys (a shape of one's own)."""
    sh = INPUT_SHAPES[shape] if isinstance(shape, str) else shape
    return sh["kind"], sh["global_batch"], sh["seq_len"]


def model_flops(cfg: ModelConfig, shape_name) -> Dict[str, float]:
    """MODEL_FLOPS (6·N·D convention) and the full analytic estimate."""
    kind, B, S = _shape(shape_name)
    n_act = n_active_params(cfg)
    if kind == "train":
        toks = B * S
        simple = 6.0 * n_act * toks
        full = 3.0 * forward_flops(cfg, B, S, S)   # fwd + ~2x bwd
        if cfg.remat != "none":
            full += forward_flops(cfg, B, S, S)    # recompute pass
    elif kind == "prefill":
        toks = B * S
        simple = 2.0 * n_act * toks
        full = forward_flops(cfg, B, S, S)
    else:  # decode: one token against an S-long cache
        toks = B
        simple = 2.0 * n_act * toks
        full = forward_flops(cfg, B, 1, S, causal_frac=1.0)
    return {"model_flops": simple, "analytic_flops": full, "tokens": toks}


def hbm_bytes(cfg: ModelConfig, shape_name, n_chips: int,
              microbatches: int = 1) -> float:
    """Whole-job HBM traffic model per step."""
    kind, B, S = _shape(shape_name)
    P = n_params(cfg)
    d = cfg.d_model
    L = cfg.n_layers
    if kind == "train":
        # weights fwd+bwd (+recompute) + fp32 grads + adam m/v rw + params rw
        w = P * 2 * (3 if cfg.remat != "none" else 2) * microbatches
        opt = P * 4 * 5
        act = B * S * d * L * 2 * 6     # residual stream traffic, both passes
        return w + opt + act
    if kind == "prefill":
        return P * 2 + B * S * d * L * 2 * 3
    # decode: full weights + full KV cache read per token
    cache = _cache_bytes(cfg, B, S)
    return P * 2 + cache + B * d * L * 2 * 4


def _cache_bytes(cfg: ModelConfig, B: int, S: int) -> float:
    prefix, block, n_blocks = layer_structure(cfg)
    sigs = prefix + block * n_blocks
    total = 0.0
    for s in sigs:
        if s.kind == "M":
            ss = cfg.ssm
            d_inner = ss.expand * cfg.d_model
            H = d_inner // ss.head_dim
            total += B * H * ss.head_dim * ss.d_state * 4
        elif cfg.attn_type == "mla":
            total += B * S * (cfg.mla.kv_lora_rank
                              + cfg.mla.qk_rope_head_dim) * 2
        else:
            span = min(S, s.window) if s.window else S
            total += B * span * cfg.n_kv_heads * cfg.head_dim * 2 * 2
    return total


def collective_bytes_model(cfg: ModelConfig, shape_name,
                           mesh: Dict[str, int],
                           microbatches: int = 1) -> float:
    """Per-card collective traffic model (FSDP AG + TP AR + MoE a2a)."""
    kind, B, S = _shape(shape_name)
    data = mesh.get("data", 1) * mesh.get("pod", 1)
    model = mesh.get("model", 1)
    P = n_params(cfg)
    p_shard = P * 2 / model                       # bytes after TP shard
    T_loc = B * (S if kind != "decode" else 1) / data
    d = cfg.d_model
    L = cfg.n_layers

    fsdp = 0.0
    if kind == "train":
        # all-gather weights fwd+bwd per microbatch + reduce-scatter grads
        fsdp = p_shard * (1 - 1 / data) * (2 * microbatches + 2)
    elif data > 1:
        fsdp = p_shard * (1 - 1 / data)           # weights gathered once
    # TP all-reduce of activations: ~2 per layer, ring factor ~2
    tp = 2 * L * T_loc * d * 2 * 2 * (1 - 1 / model) * \
        (3 if kind == "train" else 1)
    a2a = 0.0
    if cfg.moe is not None:
        n_moe = sum(cfg.is_moe_layer(i) for i in range(L))
        trips = 2 * (2 if kind == "train" else 1)
        a2a = n_moe * trips * T_loc * cfg.moe.top_k * d * 2 / data
    return fsdp + tp + a2a


# ---------------------------------------------------------------------------
# Report assembly
# ---------------------------------------------------------------------------


@dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    hlo_flops_scaled: float
    useful_ratio: float
    note: str

    def as_dict(self):
        return {k: (round(v, 6) if isinstance(v, float) else v)
                for k, v in self.__dict__.items()}


_NOTES = {
    "compute": "compute-bound: raise tensor-core utilization (wgmma tiles "
               "that fill the SMs, fuse pointwise work into the products, "
               "cut remat recompute)",
    "memory": "memory-bound: cut HBM traffic (KV-cache sharding / window "
              "ring buffer, fused CE, an int8 or fp8 cache)",
    "collective": "collective-bound: reshard to cut NVLink traffic (head "
                  "padding instead of head_dim TP, overlap the FSDP "
                  "gathers with compute, bigger microbatches)",
}


def analyse(arch: str, shape, mesh_kind: str = "single",
            record: Optional[dict] = None, tag: str = "", *, cfg=None,
            mesh: Optional[Dict[str, int]] = None) -> RooflineRow:
    """One row from a dry-run record: the closed forms' three terms at
    the card's rates, and the record's counted FLOPs (one rank's, x
    cards; no scan scaling) beside MODEL_FLOPS.  ``cfg``, a ``shape``
    dict (``kind``, ``global_batch``, ``seq_len``) and ``mesh`` (axis
    sizes) take a configuration of one's own; by default the FULL
    config on the production mesh of ``mesh_kind``."""
    cfg = cfg or get_config(arch, "full")
    if record is None:
        p = DRYRUN_DIR / f"{arch}__{shape}__{mesh_kind}{tag}.json"
        record = json.loads(p.read_text())
    chips = record["n_devices"]
    if mesh is None:
        mesh = {"data": 16, "model": 16}
        if mesh_kind == "multi":
            mesh["pod"] = 2
    n_mb = record.get("info", {}).get("microbatches", 1)

    mf = model_flops(cfg, shape)
    comp_s = mf["analytic_flops"] / (chips * PEAK_FLOPS_BF16)
    mem_s = hbm_bytes(cfg, shape, chips, n_mb) / (chips * HBM_BW)
    coll_per_chip = collective_bytes_model(cfg, shape, mesh, n_mb)
    coll_s = coll_per_chip / LINK_BW

    counted = record.get("flops", 0.0) * chips
    useful = mf["model_flops"] / counted if counted > 0 else 0.0

    terms = {"compute": comp_s, "memory": mem_s, "collective": coll_s}
    dom = max(terms, key=terms.get)
    return RooflineRow(
        arch=arch, shape=shape if isinstance(shape, str) else
        f"{shape['kind']}_{shape['global_batch']}x{shape['seq_len']}",
        mesh=mesh_kind, chips=chips,
        compute_s=comp_s, memory_s=mem_s, collective_s=coll_s,
        dominant=dom, model_flops=mf["model_flops"],
        hlo_flops_scaled=counted, useful_ratio=useful,
        note=_NOTES[dom])


def full_table(mesh_kind: str = "single"):
    from repro_torch.configs import ARCH_IDS, shape_supported
    rows = []
    for arch in ARCH_IDS:
        for shape in INPUT_SHAPES:
            if not shape_supported(arch, shape):
                continue
            p = DRYRUN_DIR / f"{arch}__{shape}__{mesh_kind}.json"
            if not p.exists():
                continue
            rows.append(analyse(arch, shape, mesh_kind))
    return rows


def main(argv=None) -> dict:
    """Print the table of the root ``benchmarks/roofline.py`` over the
    port's dry-run records."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    args = ap.parse_args(argv)
    rows = full_table(args.mesh)
    hdr = (f"{'arch':>22s} {'shape':>12s} {'compute_s':>10s} {'memory_s':>10s}"
           f" {'coll_s':>10s} {'dominant':>10s} {'useful':>7s}")
    print(hdr)
    for r in rows:
        print(f"{r.arch:>22s} {r.shape:>12s} {r.compute_s:10.4f} "
              f"{r.memory_s:10.4f} {r.collective_s:10.4f} {r.dominant:>10s} "
              f"{r.useful_ratio:7.3f}")
    doms: Dict[str, int] = {}
    for r in rows:
        doms[r.dominant] = doms.get(r.dominant, 0) + 1
    out = {"n_pairs": len(rows), "dominant_histogram": doms}
    print(out)
    return out


if __name__ == "__main__":
    main()
