"""The tensor-parallel apply's ``head_dim`` route, on the CPU, no world.

Where a mesh's mp does not divide a GQA layer's kv heads (or its heads)
the resolver splits those leaves on ``head_dim`` instead; the port's
apply then attends through ``models/layers.py::_gqa_head_dim``.  Here:

* the split-score attention (:func:`repro_torch.models.layers.attention`
  with ``reduce``) on each rank's head_dim slice of q, k and v, the
  float32 partial scores summed over the ranks by hand (one thread a
  rank, a barrier between them), gives each rank its slice of the
  whole attention's output: the port's and the reference's (JAX), with
  the causal mask, a window, the softcap, ``kv_len`` and query chunks;
* int8 rows quantized whole and then sliced give the single-device
  codes of each slice and its scales (the reference's and the port's
  ``quantize``), where a slice's own absmax would not;
* the heads a rank attends at S > 1 (:func:`_heads_of`) and the kv
  heads they read (:func:`_kv_of`);
* ``check_tensor_parallel`` on the production mesh's mp = 16 accepts
  qwen1.5-32b, command-r-35b, dbrx-132b, gemma3-12b, minicpm3-4b and
  deepseek-v3-671b (its MTP layer included) as published (serving's
  params and caches, dense, int8 and paged where the family pages;
  training's FSDP specs) and still refuses Mamba2, jamba and Whisper's
  cross and encoder leaves; the MLA leaves' placements there (heads at
  deepseek-v3, head_dim at minicpm3, the cached latent on kv_lora);
* ``local_params`` cuts a bridged reference leaf on head_dim as the
  resolver places it, so no converter is new: GQA's, and MLA's
  ``wq_b`` / ``wk_b`` / ``wv_b`` / ``wo`` and cached ``c_kv`` at
  minicpm3's widths over 16 ranks (rank 10's query columns straddle
  the nope / rope boundary).
"""
import torch_threads  # noqa: F401  (caps torch's threads under xdist)
import dataclasses
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import build_model as ref_build
from repro.models.layers import attention as ref_attention
from repro.serving import kv_quant as RKQ
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.launch.mesh import LayoutMesh
from repro_torch.models import layers as L
from repro_torch.models.transformer import (check_tensor_parallel,
                                            decoder_param_schema,
                                            init_cache_schema,
                                            paged_cache_schema)
from repro_torch.serving import kv_quant as KQ
from repro_torch.sharding import (local_params, named_specs,
                                  specs_for_schema)

ATOL = 2e-6     # float32: the partial scores summed in another order

# (name, Sq, Skv, kv_len, causal, window, softcap, q_chunk)
CASES = [
    ("decode_kv_len", 1, 40, (17, 40), True, 0, 0.0, 1024),
    ("prefill_causal", 16, 16, None, True, 0, 0.0, 1024),
    ("window", 16, 16, None, True, 5, 0.0, 1024),
    ("softcap", 16, 24, (24, 19), True, 0, 7.5, 1024),
    ("q_chunk", 16, 16, None, True, 6, 0.0, 4),
    ("non_causal", 8, 12, (12, 9), False, 0, 0.0, 1024),
]


def _hand_sum(n):
    """One ``reduce`` a rank: each rank's partial scores summed with the
    others' in rank order, once every rank has handed its part in."""
    barrier = threading.Barrier(n)
    parts = [None] * n

    def make(r):
        def reduce(s):
            parts[r] = s
            barrier.wait()
            total = parts[0].clone()
            for p in parts[1:]:
                total = total + p
            barrier.wait()
            return total
        return reduce
    return make


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_split_score_attention_is_each_ranks_slice(case):
    _, Sq, Skv, kv_len, causal, window, softcap, q_chunk = case
    B, H, Hkv, Dh, n = 2, 4, 2, 32, 4
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=s).astype(np.float32) for s in
               ((B, Sq, H, Dh), (B, Skv, Hkv, Dh), (B, Skv, Hkv, Dh)))
    q_pos = np.tile(np.arange(Skv - Sq, Skv, dtype=np.int32), (B, 1))
    kl = None if kv_len is None else np.asarray(kv_len, np.int32)
    kw = dict(causal=causal, window=window, softcap=softcap,
              q_chunk=q_chunk)
    t = torch.from_numpy
    whole = L.attention(t(q), t(k), t(v), q_pos=t(q_pos),
                        kv_len=None if kl is None else t(kl), **kw).numpy()
    ref = np.asarray(ref_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_pos=jnp.asarray(
            q_pos), kv_len=None if kl is None else jnp.asarray(kl), **kw))
    np.testing.assert_allclose(whole, ref, atol=ATOL)

    Dl = Dh // n
    outs, calls = [None] * n, [0] * n
    make = _hand_sum(n)

    def rank(r):
        dims = slice(r * Dl, (r + 1) * Dl)
        reduce = make(r)

        def counted(s):
            calls[r] += 1
            return reduce(s)
        outs[r] = L.attention(
            t(q[..., dims].copy()), t(k[..., dims].copy()),
            t(v[..., dims].copy()), q_pos=t(q_pos),
            kv_len=None if kl is None else t(kl), head_dim=Dh,
            reduce=counted, **kw).numpy()
    threads = [threading.Thread(target=rank, args=(r,)) for r in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    # one all-reduce a query block
    assert calls == [Sq // q_chunk if Sq > q_chunk else 1] * n
    got = np.concatenate(outs, -1)
    np.testing.assert_allclose(got, whole, atol=ATOL)
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_int8_rows_are_quantized_whole_then_sliced():
    rng = np.random.default_rng(1)
    k = rng.normal(size=(3, 5, 4, 64)).astype(np.float32)
    k[..., 7] *= 9.0        # one column holds each row's absmax
    v = rng.normal(size=k.shape).astype(np.float32)
    kq, ks = KQ.quantize(torch.from_numpy(k))
    rq, rs = RKQ.quantize(jnp.asarray(k))
    np.testing.assert_array_equal(kq.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(ks.numpy(), np.asarray(rs))
    n, Dl = 4, 16
    own = []
    for r in range(n):
        dims = slice(r * Dl, (r + 1) * Dl)
        rows = L._cache_rows(torch.from_numpy(k), torch.from_numpy(v),
                             True, dims)
        np.testing.assert_array_equal(rows["k_q"].numpy(),
                                      kq.numpy()[..., dims])
        np.testing.assert_array_equal(rows["k_s"].numpy(), ks.numpy())
        assert rows["v_s"].shape == ks.shape
        own.append(KQ.quantize(torch.from_numpy(k[..., dims]))[1])
        plain = L._cache_rows(torch.from_numpy(k), torch.from_numpy(v),
                              False, dims)
        np.testing.assert_array_equal(plain["k"].numpy(), k[..., dims])
    # a slice's own absmax would give other scales on the other ranks
    assert not all(torch.equal(s, ks) for s in own)


def test_heads_a_rank_attends():
    for H, n in ((40, 16), (6, 4), (20, 16)):
        starts, counts = zip(*[L._heads_of(H, n, r) for r in range(n)])
        counts = counts[0]
        assert sum(counts) == H and max(counts) - min(counts) <= 1
        assert list(starts) == [sum(counts[:r]) for r in range(n)]
    assert L._heads_of(40, 16, 0)[1] == [3] * 8 + [2] * 8


@pytest.mark.parametrize("Hkv,G,start,count,n_kv", [
    (40, 1, 9, 3, 3),      # qwen at mp = 16: every q head its own kv head
    (8, 8, 4, 4, 1),       # command-r at mp = 16: 4 q heads in one group
    (8, 6, 3, 3, 1),       # dbrx at mp = 16
    (4, 2, 2, 4, 2),       # whole groups
    (4, 3, 2, 4, 4),       # across a group boundary: one kv head a q head
])
def test_kv_heads_of_a_block_of_query_heads(Hkv, G, start, count, n_kv):
    k = torch.arange(2 * 3 * Hkv * 2, dtype=torch.float32).reshape(
        2, 3, Hkv, 2)
    ks, vs = L._kv_of(k, k + 1, start, count, G)
    assert ks.shape[2] == n_kv and count % n_kv == 0
    g = count // n_kv
    for i in range(count):
        assert torch.equal(ks[:, :, i // g], k[:, :, (start + i) // G])
        assert torch.equal(vs[:, :, i // g], k[:, :, (start + i) // G] + 1)


PROD = LayoutMesh(("data", "model"), np.empty((16, 16)))
ACCEPTED = ("qwen1.5-32b", "command-r-35b", "dbrx-132b", "gemma3-12b",
            "minicpm3-4b", "deepseek-v3-671b")
REFUSED = ("mamba2-130m", "jamba-1.5-large-398b", "whisper-large-v3")


def _named(cfg, *, fsdp=False, caches=True):
    out = named_specs(decoder_param_schema(cfg), specs_for_schema(
        decoder_param_schema(cfg), PROD, fsdp=fsdp))
    if caches:
        for schema in (init_cache_schema(cfg, 128, 1024),
                       init_cache_schema(dataclasses.replace(
                           cfg, kv_quant_int8=True), 128, 1024)):
            out += named_specs(schema, specs_for_schema(schema, PROD))
        try:
            schema = paged_cache_schema(cfg, 128, 512, 16, 64)
        except ValueError:      # a ring or non-GQA layer never pages
            pass
        else:
            out += named_specs(schema, specs_for_schema(schema, PROD))
    return out


@pytest.mark.parametrize("arch", ACCEPTED)
def test_the_four_families_pass_the_check_at_mp16(arch):
    """The GQA families of the head_dim route and the two MLA families
    pass as published."""
    cfg = get_config(arch, "full")
    named = _named(cfg)
    placed = {ps.axes[spec.index("model")] for _, ps, spec in named
              if "model" in spec}
    # the published heads do not all divide 16 (deepseek-v3's 128 do):
    # some leaf falls back
    assert ("head_dim" in placed) == (arch != "deepseek-v3-671b")
    assert ("kv_lora" in placed) == (cfg.attn_type == "mla")
    check_tensor_parallel(named, 16)
    check_tensor_parallel(_named(cfg, fsdp=True, caches=False), 16)
    if cfg.sliding_window:
        ring = dataclasses.replace(cfg, window_ring_cache=True)
        check_tensor_parallel(_named(ring), 16)


@pytest.mark.parametrize("arch", REFUSED)
def test_the_rest_are_still_refused_at_mp16(arch):
    cfg = get_config(arch, "full")
    with pytest.raises(ValueError) as exc:
        check_tensor_parallel(_named(cfg, caches=False), 16)
    msg = str(exc.value)
    assert "tensor parallelism at mp=16 has no collective" in msg
    assert "ROADMAP.md queue 1, item 9, next 2" in msg
    if arch.startswith("whisper"):
        # its decoder self-attention takes the head_dim route now
        leaf = msg.split(" for ")[1].split(" ")[0]
        assert "/cross/" in leaf or leaf.startswith("encoder/"), leaf


class _Mesh(types.SimpleNamespace):
    def coord(self, axis):
        return self.coords[axis]


def test_local_params_cut_bridged_reference_leaves_on_head_dim():
    """qwen SMOKE with 6 heads at mp = 4: wq, bq, wk, wo split on
    head_dim; each rank's shard of the bridged reference leaf is the
    reference's columns [16 r, 16 r + 16)."""
    rc = dataclasses.replace(ref_config("qwen1.5-32b", "smoke"),
                             dtype="float32", n_heads=6, n_kv_heads=6)
    cfg = dataclasses.replace(get_config("qwen1.5-32b", "smoke"),
                              dtype="float32", n_heads=6, n_kv_heads=6)
    ref = jax.tree_util.tree_map(
        np.asarray, ref_build(rc).init(jax.random.PRNGKey(0)))
    params = params_from_numpy(ref, device="cpu")
    schema = decoder_param_schema(cfg)
    for r in range(4):
        mesh = _Mesh(axis_names=("data", "model"),
                     devices=np.empty((1, 4), object),
                     coords={"data": 0, "model": r})
        specs = specs_for_schema(schema, mesh, fsdp=False)
        local = local_params(schema, params, mesh, specs)
        attn, want = local["blocks"]["p0"]["attn"], ref["blocks"]["p0"][
            "attn"]
        cols = slice(16 * r, 16 * r + 16)
        for name in ("wq", "wk", "wv", "bq", "bk", "bv"):
            np.testing.assert_array_equal(attn[name].numpy(),
                                          want[name][..., cols])
        np.testing.assert_array_equal(attn["wo"].numpy(),
                                      want["wo"][:, :, cols])


# (arch, the model axis's logical axis on wq_b / wk_b / wv_b / wo, the
# local width there of wq_b, wk_b, wv_b, wo, and of the cached c_kv)
MLA_PLACEMENTS = [
    ("deepseek-v3-671b", "heads", (8, 8, 8, 8), 32),
    ("minicpm3-4b", "head_dim", (6, 4, 4, 4), 16),
]


@pytest.mark.parametrize("arch,axis,widths,lora", MLA_PLACEMENTS,
                         ids=[c[0] for c in MLA_PLACEMENTS])
def test_mla_placements_at_mp16(arch, axis, widths, lora):
    """The resolver's placements the MLA route follows on 16 x 16: the
    up-projections and ``wo`` on heads (deepseek-v3) or head_dim
    (minicpm3), the same in the MTP layer, whose MLP splits on d_ff; the
    cached latent on kv_lora; ``wq_a``, ``wkv_a``, the norms and
    ``k_rope`` whole; serving's placement and training's FSDP one."""
    cfg = get_config(arch, "full")
    for fsdp in (False, True):
        specs = dict((n, (ps, s)) for n, ps, s in
                     _named(cfg, fsdp=fsdp, caches=not fsdp))
        layers = ["blocks/p0/attn"] + (["mtp/layer/attn"]
                                       if cfg.mtp_depth else [])
        for layer in layers:
            for w, width in zip(("wq_b", "wk_b", "wv_b", "wo"), widths):
                ps, spec = specs[f"{layer}/{w}"]
                i = spec.index("model")
                assert ps.axes[i] == axis
                assert ps.shape[i] // 16 == width, (layer, w)
            for w in ("wq_a", "q_norm", "wkv_a", "kv_norm"):
                assert "model" not in specs[f"{layer}/{w}"][1], (layer, w)
        if cfg.mtp_depth:
            ps, spec = specs["mtp/layer/mlp/w_gate"]
            assert ps.axes[spec.index("model")] == "d_ff"
        if not fsdp:
            ps, spec = specs["blocks/p0/c_kv"]
            assert ps.axes[spec.index("model")] == "kv_lora"
            assert ps.shape[-1] // 16 == lora
            assert "model" not in specs["blocks/p0/k_rope"][1]


def test_local_params_cut_bridged_mla_leaves_at_minicpm3_widths():
    """minicpm3's MLA widths (40 heads of 64 + 32 query columns, 64 value
    columns, kv_lora 256) on a narrow SMOKE body over 16 ranks: each
    rank's cut of the bridged reference ``wq_b`` is its 6 query columns
    (rank 10's [60, 66) straddle the nope / rope boundary at 64),
    ``wk_b`` / ``wv_b`` / ``wo`` its 4 columns, and of a cached ``c_kv``
    its 16 kv_lora columns."""
    full = ref_config("minicpm3-4b", "full")
    over = dict(dtype="float32", n_heads=full.n_heads,
                n_kv_heads=full.n_kv_heads, head_dim=full.head_dim,
                mla=full.mla)
    rc = dataclasses.replace(ref_config("minicpm3-4b", "smoke"), **over)
    cfg = dataclasses.replace(get_config("minicpm3-4b", "smoke"), **over)
    ref = jax.tree_util.tree_map(
        np.asarray, ref_build(rc).init(jax.random.PRNGKey(0)))
    params = params_from_numpy(ref, device="cpu")
    schema = decoder_param_schema(cfg)
    cschema = init_cache_schema(cfg, 2, 8)
    ckv = np.random.default_rng(0).normal(
        size=cschema["blocks"]["p0"]["c_kv"].shape).astype(np.float32)
    cache = {"pos": torch.zeros(2, dtype=torch.int32), "prefix": [],
             "blocks": {"p0": {"c_kv": torch.from_numpy(ckv),
                               "k_rope": torch.zeros(
                                   cschema["blocks"]["p0"]["k_rope"].shape)}}}
    straddle = None
    for r in range(16):
        mesh = _Mesh(axis_names=("data", "model"),
                     devices=np.empty((1, 16), object),
                     coords={"data": 0, "model": r})
        local = local_params(schema, params, mesh,
                             specs_for_schema(schema, mesh, fsdp=False))
        attn, want = local["blocks"]["p0"]["attn"], ref["blocks"]["p0"][
            "attn"]
        q = slice(6 * r, 6 * r + 6)
        np.testing.assert_array_equal(attn["wq_b"].numpy(),
                                      want["wq_b"][..., q])
        if q.start < 64 < q.stop:
            straddle = r
        cols = slice(4 * r, 4 * r + 4)
        for name in ("wk_b", "wv_b"):
            np.testing.assert_array_equal(attn[name].numpy(),
                                          want[name][..., cols])
        np.testing.assert_array_equal(attn["wo"].numpy(),
                                      want["wo"][:, :, cols])
        for name in ("wq_a", "wkv_a", "kv_norm", "q_norm"):
            np.testing.assert_array_equal(attn[name].numpy(), want[name])
        lc = local_params(cschema, cache, mesh,
                          specs_for_schema(cschema, mesh))
        np.testing.assert_array_equal(
            lc["blocks"]["p0"]["c_kv"].numpy(),
            ckv[..., 16 * r:16 * r + 16])
        assert lc["blocks"]["p0"]["k_rope"].shape[-1] == cfg.mla.qk_rope_head_dim
    assert straddle == 10
