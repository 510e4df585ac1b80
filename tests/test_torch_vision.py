"""phi-3-vision in the port against the reference, at SMOKE size.

Every test runs on phi-3-vision SMOKE (head_dim 64) and on SMOKE with
``head_dim=96``, FULL's head dim, so that D = 96 passes through the
model and through K1 / K2's plain versions.  Weights come from the
reference's ``Model.init`` plus seeded numpy noise, carried across by
``repro_torch.bridge``; the stub frontend's patch embeddings are seeded
numpy arrays given to both packages.  Float32: logits within 1e-4 (the
same sums in another order), greedy and engine tokens identical.  The
reference decodes with its dense attention (``use_flash_decode=False``)
and with its Pallas kernels in interpret mode (``True``).
"""
import torch_threads  # noqa: F401  (caps torch's threads under xdist)
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.data.lm_dataset import LMDataset as RefLMDataset
from repro.models import build_model as ref_build
from repro.models import transformer as RT
from repro.serving.continuous import ContinuousEngine as RefEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.data.lm_dataset import LMDataset
from repro_torch.models import build_model
from repro_torch.models import transformer as T
from repro_torch.models.schema import tree_leaves
from repro_torch.serving.continuous import ContinuousEngine
from test_torch_engine import _prompts
from test_torch_model import F32_TOL, _ref_params, _run_both

PHI3 = "phi-3-vision-4.2b"
# SMOKE as it is (head_dim 64) and at FULL's head_dim
VARIANTS = {"smoke": {}, "hd96": {"head_dim": 96}}
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4   # of each leaf's largest gradient: float32 sums reordered


def _configs(variant, dtype="float32", arch=PHI3, **kw):
    kw = dict(VARIANTS[variant], **kw)
    return (dataclasses.replace(ref_config(arch, "smoke"), dtype=dtype, **kw),
            dataclasses.replace(get_config(arch, "smoke"), dtype=dtype, **kw))


def _image(rc, B, seed=0):
    return np.random.default_rng(seed + 100).standard_normal(
        (B, rc.n_modality_tokens, rc.modality_embed_dim)).astype(np.float32)


def _both(p):
    return (jax.tree_util.tree_map(jnp.asarray, p),
            params_from_numpy(p, device="cpu"))


@pytest.mark.parametrize("image", [False, True], ids=["text", "image"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_forward_train_logits_match_reference(variant, image):
    """The training forward, text only and with the image's projected
    patches before the text (positions over both)."""
    rc, tc = _configs(variant)
    rp, tp = _both(_ref_params(ref_build(rc)))
    inputs = {"tokens": np.random.default_rng(1).integers(
        4, rc.vocab_size, size=(2, 12)).astype(np.int32)}
    if image:
        inputs["image_emb"] = _image(rc, 2)
    want, _ = jax.jit(lambda p, x: RT.forward_train(p, rc, x))(
        rp, {k: jnp.asarray(v) for k, v in inputs.items()})
    got, _ = T.forward_train(tp, tc, {k: torch.from_numpy(v)
                                      for k, v in inputs.items()})
    assert got.shape == (2, 12 + image * rc.n_modality_tokens,
                         rc.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("use_flash_decode", [False, True])
@pytest.mark.parametrize("variant", VARIANTS)
def test_prefill_with_image_and_decode_match_reference(variant,
                                                       use_flash_decode):
    """A prefill with the image (16 patches + 9 tokens: the cache counts
    25 positions) and 8 greedy decode steps: logits within 1e-4, tokens
    identical; the port decodes through K1's plain version at D = 64 and
    96."""
    rc, tc = _configs(variant)
    rc = dataclasses.replace(rc, use_flash_decode=use_flash_decode)
    steps = _run_both(rc, tc, S=9, max_len=40,
                      extra={"image_emb": _image(rc, 3)})
    assert len(steps) == 9
    for want, got in steps:
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
        np.testing.assert_array_equal(got[:, -1].argmax(-1),
                                      want[:, -1].argmax(-1))


def test_image_positions_are_cached():
    """After a prefill with the image, ``cache["pos"]`` counts the image's
    positions, and the image changes the next token's logits."""
    _, tc = _configs("smoke")
    model = build_model(tc)
    params = model.init(seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        4, tc.vocab_size, size=(2, 9)))
    img = torch.from_numpy(_image(tc, 2))
    with_img, c1 = model.prefill(params, {"tokens": toks, "image_emb": img},
                                 model.init_cache(2, 32, device="cpu"))
    text, c2 = model.prefill(params, {"tokens": toks},
                             model.init_cache(2, 32, device="cpu"))
    assert c1["pos"].tolist() == [9 + tc.n_modality_tokens] * 2
    assert c2["pos"].tolist() == [9, 9]
    assert (with_img - text).abs().max() > 1e-4


def test_projector_uses_the_tanh_gelu():
    """``jax.nn.gelu``'s default is the tanh approximation; the port's
    projector uses it, not torch's erf default."""
    _, tc = _configs("smoke")
    params = build_model(tc).init(seed=0, device="cpu")
    img = torch.from_numpy(_image(tc, 2)) * 40   # where the two differ
    got = T._project_image(params, img, torch.float32)
    pj = params["projector"]
    h = img @ pj["w1"]
    tanh = 0.5 * h * (1 + torch.tanh(math.sqrt(2 / math.pi)
                                     * (h + 0.044715 * h ** 3)))
    torch.testing.assert_close(got, tanh @ pj["w2"], rtol=1e-5, atol=1e-6)
    erf = torch.nn.functional.gelu(h) @ pj["w2"]
    assert (got - erf).abs().max() > 1e-4
    want = jax.nn.gelu(jnp.asarray(h.numpy())) @ jnp.asarray(
        pj["w2"].numpy())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _batch(rc, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(4, rc.vocab_size, size=(2, 12)).astype(np.int32)
    labels = rng.integers(4, rc.vocab_size, size=(2, 12)).astype(np.int32)
    labels[0, :3] = -1
    return {"tokens": toks, "labels": labels, "image_emb": _image(rc, 2)}


@pytest.mark.parametrize("variant", VARIANTS)
def test_training_loss_and_gradients_match_jax_grad(variant):
    """``forward_train_loss`` with an image (its CE over the last S_txt
    positions only) and its gradient on every leaf, the projector's
    included, against ``jax.grad`` of the reference's; and the loss is
    ``loss_fn`` on the training forward's logits, which drops exactly
    the image's positions."""
    rc, tc = _configs(variant, remat="full")
    p = _ref_params(ref_build(rc))
    b = _batch(rc)
    jb = jax.tree_util.tree_map(jnp.asarray, b)
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p: RT.forward_train_loss(p, rc, jb)))(
            jax.tree_util.tree_map(jnp.asarray, p))
    tp = params_from_numpy(p, device="cpu")
    leaves = tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    tb = {k: torch.from_numpy(v.copy()) for k, v in b.items()}
    loss = T.forward_train_loss(tp, tc, tb)
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
    g_w1 = grads[[id(t) for t in leaves].index(id(tp["projector"]["w1"]))]
    assert g_w1.abs().max() > 0       # the loss reaches the projector
    with torch.no_grad():
        logits, extras = T.forward_train(tp, tc, tb)
        n_img = rc.n_modality_tokens
        assert logits.shape[1] == n_img + 12
        via_logits = T.loss_fn(logits, tb["labels"], extras=extras)
        text_only = T.loss_fn(logits[:, n_img:], tb["labels"],
                              extras=extras)
    np.testing.assert_allclose(float(via_logits), float(loss.detach()),
                               rtol=LOSS_RTOL)
    assert float(via_logits) == float(text_only)


ENGINE_KW = dict(num_slots=3, max_len=40, max_new_cap=10, sync_every=4,
                 prefill_batch=2)


@pytest.mark.parametrize("engine", ["dense", "paged"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_engine_tokens_match_reference(variant, engine):
    """``ContinuousEngine`` on 7 text prompts of 6-11 tokens over 3 slots
    (slots reused), 10 new tokens each: the port's greedy tokens and step
    counts are the reference engine's, on the dense slot cache (K1's
    plain version) and on the paged pool (page 8; K2's)."""
    rc, tc = _configs(variant)
    np_params = _ref_params(ref_build(rc))
    rp, tp = _both(np_params)
    kw = dict(ENGINE_KW, **(dict(paged=True, page_size=8)
                            if engine == "paged" else {}))
    prompts = _prompts(7, [6, 11, 6, 9])
    want = RefEngine(ref_build(rc), rp, **kw).generate_many(
        prompts, max_new_tokens=10)
    got = ContinuousEngine(build_model(tc), tp, **kw).generate_many(
        prompts, max_new_tokens=10)
    assert [list(g.tokens) for g in got] == [list(w.tokens) for w in want]
    assert [g.n_steps for g in got] == [w.n_steps for w in want]


@pytest.mark.parametrize("arch", [PHI3, "whisper-large-v3"],
                         ids=["vision", "audio"])
def test_lm_dataset_batches_match_reference(arch):
    """``LMDataset`` for a vision config (text over seq_len - 16
    positions, then the image's patch embeddings) and an audio one (the
    frames after the text), drawn from one generator in the reference's
    order: three batches equal, key for key, for one seed."""
    rc, tc = ref_config(arch, "smoke"), get_config(arch, "smoke")
    want = RefLMDataset(rc, seq_len=48, seed=3, n_paragraphs=20).batches(2)
    got = LMDataset(tc, seq_len=48, seed=3, n_paragraphs=20).batches(2)
    for _ in range(3):
        w, g = next(want), next(got)
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
            np.testing.assert_array_equal(g[k], w[k])
    if arch == PHI3:
        assert g["tokens"].shape == (2, 48 - tc.n_modality_tokens)
        assert g["image_emb"].shape == (2, tc.n_modality_tokens,
                                        tc.modality_embed_dim)
    else:
        assert g["tokens"].shape == (2, 48)
        assert g["audio_emb"].shape == (2, tc.encoder_seq_len, tc.d_model)
