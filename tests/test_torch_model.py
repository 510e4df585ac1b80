"""The port's dense GQA decoder against the reference, on qwen SMOKE;
and every port config against the reference's (its fields, its SMOKE
forward logits), with no architecture of the reference left unported.

Weights come from the reference's ``Model.init`` plus seeded numpy
noise (so biases and norm weights are not trivially 0 and 1), carried
across by ``repro_torch.bridge``.  Prefill plus 8 greedy decode steps
feed both packages the same tokens.  The reference runs with its dense
attention (``use_flash_decode=False``) and with its Pallas flash-decode
kernel in interpret mode (``True``); the port always decodes through its
flash-decode wrapper, the plain version on CPU tensors.
"""
import torch_threads  # noqa: F401  (caps torch's threads under xdist)
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import build_model as ref_build
from repro.models import layers as ref_layers
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models.schema import tree_leaves

# float32: the same function summed in another order
F32_TOL = 1e-4


def _configs(dtype="float32", **kw):
    rc = dataclasses.replace(ref_config("qwen1.5-32b", "smoke"), dtype=dtype,
                             **kw)
    tc = dataclasses.replace(get_config("qwen1.5-32b", "smoke"), dtype=dtype,
                             **kw)
    return rc, tc


def _ref_params(model, seed=0):
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(np.asarray, model.init(jax.random.PRNGKey(0)))
    return jax.tree_util.tree_map(
        lambda a: (a.astype(np.float32)
                   + rng.normal(0, 0.02, a.shape).astype(np.float32)
                   ).astype(a.dtype), params)


def _run_both(rc, tc, *, B=3, S=9, max_len=24, steps=8, seed=0, extra=None,
              **forward_kw):
    """(ref logits, port logits) per step, both fed the reference's
    greedy tokens; ``extra`` (numpy arrays: ``image_emb``, ``audio_emb``)
    joins the prefill's inputs; ``forward_kw`` (``mla_absorb``) goes to
    both packages' prefill and decode."""
    rm, tm = ref_build(rc), build_model(tc)
    np_params = _ref_params(rm, seed)
    rp = jax.tree_util.tree_map(jnp.asarray, np_params)
    tp = params_from_numpy(np_params, device="cpu")
    toks = np.random.default_rng(seed).integers(
        4, rc.vocab_size, size=(B, S)).astype(np.int32)
    rcache, tcache = rm.init_cache(B, max_len), tm.init_cache(B, max_len,
                                                              device="cpu")
    inputs = {"tokens": toks, **(extra or {})}
    rl, rcache = jax.jit(functools.partial(rm.prefill, **forward_kw))(
        rp, {k: jnp.asarray(v) for k, v in inputs.items()}, rcache)
    tl, tcache = tm.prefill(tp, {k: torch.from_numpy(v)
                                 for k, v in inputs.items()}, tcache,
                            **forward_kw)
    out = [(np.asarray(rl, np.float32), tl.float().numpy())]
    decode = jax.jit(functools.partial(rm.decode, **forward_kw))
    for _ in range(steps):
        nxt = np.asarray(rl[:, -1], np.float32).argmax(-1).astype(np.int32)
        rl, rcache = decode(rp, {"tokens": jnp.asarray(nxt)[:, None]}, rcache)
        tl, tcache = tm.decode(tp, {"tokens": torch.from_numpy(nxt)[:, None]},
                               tcache, **forward_kw)
        out.append((np.asarray(rl, np.float32), tl.float().numpy()))
    assert np.array_equal(np.asarray(rcache["pos"]), tcache["pos"].numpy())
    return out


@pytest.mark.parametrize("use_flash_decode", [False, True])
@pytest.mark.parametrize("n_kv_heads", [4, 2], ids=["G1", "G2"])
def test_prefill_and_decode_logits_match_reference(n_kv_heads,
                                                   use_flash_decode):
    rc, tc = _configs(n_kv_heads=n_kv_heads)
    rc = dataclasses.replace(rc, use_flash_decode=use_flash_decode)
    for want, got in _run_both(rc, tc):
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
        np.testing.assert_array_equal(got[:, -1].argmax(-1),
                                      want[:, -1].argmax(-1))


def test_bf16_logits_within_stated_tolerance():
    """bf16 weights and caches: each framework rounds its bf16 matmul
    outputs, bias adds and residual sums at its own points, so logits
    agree to a bf16-scale relative tolerance, not bit for bit."""
    rc, tc = _configs(dtype="bfloat16")
    for want, got in _run_both(rc, tc):
        rel = np.abs(got - want).max() / np.abs(want).max()
        assert rel <= 2e-2, rel


def test_no_cache_gqa_matches_reference():
    rc, tc = _configs(n_kv_heads=2)
    rm = ref_build(rc)
    p = _ref_params(rm)["blocks"]["p0"]["attn"]
    p = {k: v[0] for k, v in p.items()}
    x = np.random.default_rng(1).standard_normal((2, 11, rc.d_model)
                                                 ).astype(np.float32)
    pos = np.broadcast_to(np.arange(11, dtype=np.int32), (2, 11))
    want, _ = ref_layers.gqa_apply(jax.tree_util.tree_map(jnp.asarray, p),
                                   jnp.asarray(x), rc,
                                   positions=jnp.asarray(pos))
    got, cache = L.gqa_apply(params_from_numpy(p, device="cpu"),
                             torch.from_numpy(x), tc,
                             positions=torch.from_numpy(pos.copy()))
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_decode_write_past_the_row_is_dropped():
    """An idle slot's held position may sit at max_len: its k/v write is
    dropped (the reference's out-of-bounds scatter), every other row is
    written at its own position."""
    cache = torch.zeros(3, 4, 2, 8)
    rows = torch.arange(1.0, 4.0)[:, None, None].expand(3, 2, 8)
    L._write_step(cache, rows, torch.tensor([0, 3, 4], dtype=torch.int32))
    assert (cache[0, 0] == 1).all() and (cache[1, 3] == 2).all()
    assert cache[2].abs().sum() == 0
    assert cache[0, 1:].abs().sum() == 0 and cache[1, :3].abs().sum() == 0


def test_every_reference_architecture_is_ported():
    """The port's registry is the reference's: no architecture left to
    port, and every one builds."""
    from repro.configs import ARCH_IDS as REF_ARCH_IDS
    from repro_torch.configs import ARCH_IDS, UNPORTED_ARCH_IDS
    assert UNPORTED_ARCH_IDS == []
    assert sorted(ARCH_IDS) == sorted(REF_ARCH_IDS)
    for arch in ARCH_IDS:
        build_model(get_config(arch, "smoke"))


def _smoke_inputs(rc, seed=0):
    """Seeded tokens, and the stub frontend's embeddings for a vision or
    audio config (numpy arrays)."""
    rng = np.random.default_rng(seed)
    inputs = {"tokens": rng.integers(4, rc.vocab_size, size=(2, 12)
                                     ).astype(np.int32)}
    if rc.modality == "vision":
        inputs["image_emb"] = rng.standard_normal(
            (2, rc.n_modality_tokens, rc.modality_embed_dim)
        ).astype(np.float32)
    if rc.is_encoder_decoder:
        inputs["audio_emb"] = rng.standard_normal(
            (2, rc.encoder_seq_len, rc.d_model)).astype(np.float32)
    return inputs


@pytest.mark.parametrize("arch", [
    "qwen1.5-32b", "mamba2-130m", "command-r-35b", "dbrx-132b",
    "jamba-1.5-large-398b", "gemma3-12b", "minicpm3-4b", "deepseek-v3-671b",
    "phi-3-vision-4.2b", "whisper-large-v3"])
def test_every_smoke_config_forward_matches_reference(arch):
    """Every port config at SMOKE size, float32, the reference's weights
    carried across: ``forward_train`` logits within 1e-4 (with an image
    or audio frames where the family takes them)."""
    from repro.models import transformer as RT
    from repro_torch.models import transformer as T
    rc = dataclasses.replace(ref_config(arch, "smoke"), dtype="float32")
    tc = dataclasses.replace(get_config(arch, "smoke"), dtype="float32")
    p = _ref_params(ref_build(rc))
    inputs = _smoke_inputs(rc)
    want, _ = jax.jit(lambda p, x: RT.forward_train(p, rc, x))(
        jax.tree_util.tree_map(jnp.asarray, p),
        {k: jnp.asarray(v) for k, v in inputs.items()})
    got, _ = T.forward_train(params_from_numpy(p, device="cpu"), tc,
                             {k: torch.from_numpy(v)
                              for k, v in inputs.items()})
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)


def test_seeded_init_in_config_dtype_on_requested_device():
    _, tc = _configs(dtype="bfloat16")
    model = build_model(tc)
    a, b = model.init(seed=3, device="cpu"), model.init(seed=3, device="cpu")
    c = model.init(seed=4, device="cpu")
    w = a["blocks"]["p0"]["mlp"]["w_up"]
    assert w.dtype == torch.bfloat16 and w.shape == (2, 256, 512)
    assert abs(float(w.float().std()) - 0.02) < 2e-3
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))
    assert not torch.equal(w, c["blocks"]["p0"]["mlp"]["w_up"])
    assert torch.equal(a["blocks"]["p0"]["attn"]["bq"],
                       torch.zeros_like(a["blocks"]["p0"]["attn"]["bq"]))
    assert sum(t.numel() for t in tree_leaves(a)) == model.n_params()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            model.init(seed=0)          # device defaults to "cuda"


def test_bridge_carries_bf16_bit_exactly():
    rc, _ = _configs(dtype="bfloat16")
    np_params = _ref_params(ref_build(rc))
    ported = params_from_numpy(np_params, device="cpu")
    ref_leaves = jax.tree_util.tree_leaves(np_params)
    port_leaves = tree_leaves(ported)
    assert len(ref_leaves) == len(port_leaves)
    for a, t in zip(ref_leaves, port_leaves):
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == a.shape
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      a.view(np.int16))


# the qwen cases keep their ids; the other families' are new
@pytest.mark.parametrize("arch,variant", [
    pytest.param("qwen1.5-32b", v, id=v) for v in ("full", "smoke")] + [
    pytest.param(a, v, id=f"{a}-{v}")
    for a in ("command-r-35b", "dbrx-132b", "jamba-1.5-large-398b",
              "gemma3-12b", "minicpm3-4b", "deepseek-v3-671b",
              "phi-3-vision-4.2b", "whisper-large-v3")
    for v in ("full", "smoke")])
def test_configs_are_the_reference_configs(arch, variant):
    from repro.core import config as ref_cfg
    from repro.routing import registry as ref_registry
    from repro_torch.core import config as port_cfg
    from repro_torch.routing import registry as port_registry
    assert dataclasses.asdict(get_config(arch, variant)) == \
        dataclasses.asdict(ref_config(arch, variant))
    for name in ("RouterConfig", "RetrievalConfig", "TestbedConfig"):
        assert dataclasses.asdict(getattr(port_cfg, name)()) == \
            dataclasses.asdict(getattr(ref_cfg, name)()), name
    for slo in ("quality_first", "cheap"):
        assert dataclasses.asdict(port_registry.get_slo_profile(slo)) == \
            dataclasses.asdict(ref_registry.get_slo_profile(slo))
    assert [dataclasses.astuple(a) for a in port_registry.get_action_space()] \
        == [dataclasses.astuple(a) for a in ref_registry.get_action_space()]
