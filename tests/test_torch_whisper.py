"""whisper in the port against the reference, on whisper SMOKE.

The encoder (``enc_pos`` plus non-causal layers over the stub frame
embeddings), the decoder's cross-attention sublayer and its cross cache,
the training loss and its gradients, and the served path: the
reference's executor prefills tokens alone, so a served request attends
over the zero cross cache, in both packages alike.  Weights come from
the reference's ``Model.init`` plus seeded numpy noise, carried across by
``repro_torch.bridge``; the frames are seeded numpy arrays given to
both.  Float32: logits within 1e-4 (the same sums in another order),
tokens identical.  The reference decodes with its dense attention
(``use_flash_decode=False``) and with its Pallas flash-decode kernel in
interpret mode (``True``).
"""
import torch_threads  # noqa: F401  (caps torch's threads under xdist)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import build_model as ref_build
from repro.models import layers as ref_layers
from repro.models import transformer as RT
from repro.serving.continuous import ContinuousEngine as RefEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.schema import tree_leaves
from repro_torch.serving.continuous import ContinuousEngine
from test_torch_engine import _prompts
from test_torch_model import F32_TOL, _ref_params

WHISPER = "whisper-large-v3"
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4   # of each leaf's largest gradient: float32 sums reordered


def _configs(dtype="float32", **kw):
    return (dataclasses.replace(ref_config(WHISPER, "smoke"), dtype=dtype,
                                **kw),
            dataclasses.replace(get_config(WHISPER, "smoke"), dtype=dtype,
                                **kw))


def _frames(rc, B, seed=0):
    return np.random.default_rng(seed + 100).standard_normal(
        (B, rc.encoder_seq_len, rc.d_model)).astype(np.float32)


def _both(p):
    return (jax.tree_util.tree_map(jnp.asarray, p),
            params_from_numpy(p, device="cpu"))


def test_encoder_matches_reference():
    """``_encode``: the frames plus ``enc_pos``, the non-causal layers
    (rope on, as in the reference) and the final norm."""
    rc, tc = _configs()
    rp, tp = _both(_ref_params(ref_build(rc)))
    frames = _frames(rc, 2)
    want = RT._encode(rp, rc, jnp.asarray(frames))
    got = T._encode(tp, tc, torch.from_numpy(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)


def test_cross_attention_layer_matches_reference():
    """``gqa_apply`` with ``cross_kv``: the query alone (no rope), every
    encoder row unmasked, and the cache returned untouched."""
    rc, tc = _configs()
    p = _ref_params(ref_build(rc))["blocks"]["p0"]["cross"]
    p = {k: v[0] for k, v in p.items()}
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, rc.d_model)).astype(np.float32)
    kv = [rng.standard_normal((2, rc.encoder_seq_len, rc.n_kv_heads,
                               rc.head_dim)).astype(np.float32)
          for _ in range(2)]
    pos = np.broadcast_to(np.arange(3, 8, dtype=np.int32), (2, 5)).copy()
    want, _ = ref_layers.gqa_apply(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x), rc,
        positions=jnp.asarray(pos),
        cross_kv=tuple(jnp.asarray(a) for a in kv))
    cache = {"k": torch.zeros(1)}
    got, out_cache = L.gqa_apply(
        params_from_numpy(p, device="cpu"), torch.from_numpy(x), tc,
        positions=torch.from_numpy(pos), cache=cache,
        cross_kv=tuple(torch.from_numpy(a) for a in kv))
    assert out_cache is cache
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_forward_train_logits_match_reference():
    """The training forward: encoder over the frames, decoder layers
    with cross-attention over its output."""
    rc, tc = _configs()
    rp, tp = _both(_ref_params(ref_build(rc)))
    toks = np.random.default_rng(1).integers(
        4, rc.vocab_size, size=(2, 12)).astype(np.int32)
    frames = _frames(rc, 2)
    want, _ = jax.jit(lambda p, x: RT.forward_train(p, rc, x))(
        rp, {"tokens": jnp.asarray(toks), "audio_emb": jnp.asarray(frames)})
    got, _ = T.forward_train(tp, tc, {"tokens": torch.from_numpy(toks),
                                      "audio_emb": torch.from_numpy(frames)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("use_flash_decode", [False, True])
def test_prefill_with_audio_and_decode_through_cross_cache(use_flash_decode):
    """A prefill with the frames writes every decoder layer's cross cache
    from the encoder (the reference's values); 8 greedy decode steps with
    tokens alone read it back: logits within 1e-4 at every step, tokens
    identical, and the cross cache never changes while decoding."""
    rc, tc = _configs(use_flash_decode=use_flash_decode)
    rm, tm = ref_build(rc), build_model(tc)
    rp, tp = _both(_ref_params(rm))
    B, S, max_len = 3, 9, 24
    toks = np.random.default_rng(0).integers(
        4, rc.vocab_size, size=(B, S)).astype(np.int32)
    frames = _frames(rc, B)
    rl, rcache = jax.jit(rm.prefill)(
        rp, {"tokens": jnp.asarray(toks), "audio_emb": jnp.asarray(frames)},
        rm.init_cache(B, max_len))
    tl, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(toks),
                                 "audio_emb": torch.from_numpy(frames)},
                            tm.init_cache(B, max_len, device="cpu"))
    for name in ("cross_k", "cross_v"):
        want = np.asarray(rcache["blocks"]["p0"][name])
        got = tcache["blocks"]["p0"][name]
        assert got.shape == (rc.n_layers, B, rc.encoder_seq_len,
                             rc.n_kv_heads, rc.head_dim)
        assert got.abs().max() > 0
        np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL,
                                   atol=F32_TOL)
    written = tcache["blocks"]["p0"]["cross_k"].clone()
    decode = jax.jit(rm.decode)
    for _ in range(9):
        np.testing.assert_allclose(tl.numpy(), np.asarray(rl), rtol=F32_TOL,
                                   atol=F32_TOL)
        nxt = np.asarray(rl[:, -1]).argmax(-1).astype(np.int32)
        np.testing.assert_array_equal(tl[:, -1].numpy().argmax(-1), nxt)
        rl, rcache = decode(rp, {"tokens": jnp.asarray(nxt)[:, None]},
                            rcache)
        tl, tcache = tm.decode(tp, {"tokens": torch.from_numpy(nxt)[:, None]},
                               tcache)
    assert torch.equal(tcache["blocks"]["p0"]["cross_k"], written)
    assert tcache["pos"].tolist() == [S + 9] * B


def test_training_loss_and_gradients_match_jax_grad():
    """``forward_train_loss`` and its gradient on every leaf, the
    encoder's, ``enc_pos`` and the cross sublayers' included, against
    ``jax.grad`` of the reference's (remat full)."""
    rc, tc = _configs(remat="full")
    p = _ref_params(ref_build(rc))
    rng = np.random.default_rng(0)
    b = {"tokens": rng.integers(4, rc.vocab_size, size=(2, 12)
                                ).astype(np.int32),
         "labels": rng.integers(4, rc.vocab_size, size=(2, 12)
                                ).astype(np.int32),
         "audio_emb": _frames(rc, 2)}
    b["labels"][0, :3] = -1
    jb = jax.tree_util.tree_map(jnp.asarray, b)
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p: RT.forward_train_loss(p, rc, jb)))(
            jax.tree_util.tree_map(jnp.asarray, p))
    tp = params_from_numpy(p, device="cpu")
    leaves = tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    loss = T.forward_train_loss(tp, tc, {k: torch.from_numpy(v.copy())
                                         for k, v in b.items()})
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=LOSS_RTOL)
    want_leaves = jax.tree_util.tree_leaves(want)
    assert len(want_leaves) == len(grads)
    for got, w in zip(grads, want_leaves):
        w = np.asarray(w)
        np.testing.assert_allclose(got.numpy(), w, rtol=0,
                                   atol=GRAD_TOL * max(np.abs(w).max(),
                                                       1e-30))
    ids = [id(t) for t in leaves]
    for leaf in (tp["enc_pos"], tp["encoder"]["attn"]["wq"],
                 tp["blocks"]["p0"]["cross"]["wk"]):
        assert grads[ids.index(id(leaf))].abs().max() > 0


ENGINE_KW = dict(num_slots=3, max_len=40, max_new_cap=10, sync_every=4,
                 prefill_batch=2)


def test_dense_engine_tokens_match_reference():
    """``ContinuousEngine`` on 7 prompts of 6-11 tokens over 3 slots
    (slots reused), 10 new tokens each: the executor prefills tokens
    alone, as the reference's does, so every request attends over the
    zero cross cache; greedy tokens and step counts are the reference
    engine's."""
    rc, tc = _configs()
    rp, tp = _both(_ref_params(ref_build(rc)))
    prompts = _prompts(7, [6, 11, 6, 9])
    want = RefEngine(ref_build(rc), rp, **ENGINE_KW).generate_many(
        prompts, max_new_tokens=10)
    port = ContinuousEngine(build_model(tc), tp, **ENGINE_KW)
    got = port.generate_many(prompts, max_new_tokens=10)
    assert [list(g.tokens) for g in got] == [list(w.tokens) for w in want]
    assert [g.n_steps for g in got] == [w.n_steps for w in want]
    cross = port.executor._cache["blocks"]["p0"]["cross_k"]
    assert cross.shape[1] == ENGINE_KW["num_slots"] and not cross.any()


@pytest.mark.parametrize("package", ["reference", "port"])
def test_paged_pool_refuses_cross_attention(package):
    """The paged pool holds position-addressed self-attention pages
    only: both packages refuse the decoder's cross layers with
    ``ValueError``."""
    rc, tc = _configs()
    kw = dict(ENGINE_KW, paged=True, page_size=8)
    with pytest.raises(ValueError, match="cross=True"):
        if package == "reference":
            m = ref_build(rc)
            RefEngine(m, m.init(jax.random.PRNGKey(0)), **kw)
        else:
            m = build_model(tc)
            ContinuousEngine(m, m.init(seed=0, device="cpu"), **kw)


def test_cache_and_param_schemas_match_reference():
    """The parameter tree (``enc_pos`` small-initialised, the encoder
    stack, ``ln_cross`` / ``cross`` in every decoder layer) and the decode
    cache (``cross_k`` / ``cross_v`` of ``encoder_seq_len`` rows beside
    ``k`` / ``v``) have the reference's leaves, shapes and dtypes."""
    rc, tc = _configs(dtype="bfloat16")
    rm, tm = ref_build(rc), build_model(tc)
    for ref_tree, port_tree in ((rm.param_shapes(), tm.schema),
                                (rm.cache_schema(2, 16),
                                 tm.cache_schema(2, 16))):
        want = jax.tree_util.tree_flatten_with_path(
            ref_tree, is_leaf=lambda x: hasattr(x, "shape"))[0]
        got = tree_leaves(port_tree)
        assert len(want) == len(got)
        for (path, w), g in zip(want, got):
            assert tuple(w.shape) == tuple(g.shape), path
            assert str(np.dtype(w.dtype)) == g.dtype, path
    assert tm.schema["enc_pos"].init == "small"
    assert tm.n_params() == rm.n_params()


def test_frames_cast_to_the_weights_dtype():
    """bf16 weights take float32 frames: the port casts them to the
    weights' dtype on the way into the encoder (its products take one
    dtype), and the prefill writes a bf16 cross cache."""
    _, tc = _configs(dtype="bfloat16")
    model = build_model(tc)
    params = model.init(seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        4, tc.vocab_size, size=(2, 5)))
    frames = torch.from_numpy(_frames(tc, 2))
    logits, cache = model.prefill(params, {"tokens": toks,
                                           "audio_emb": frames},
                                  model.init_cache(2, 8, device="cpu"))
    assert torch.isfinite(logits).all()
    ck = cache["blocks"]["p0"]["cross_k"]
    assert ck.dtype == torch.bfloat16 and ck.abs().max() > 0
    enc = T._encode(params, tc, frames)
    assert enc.dtype == torch.bfloat16
    torch.testing.assert_close(enc, T._encode(params, tc,
                                              frames.bfloat16()))
