"""The port's decoder families against the reference at SMOKE size:
``dbrx-132b`` (mixture of experts), ``jamba-1.5-large-398b`` (Mamba +
attention + MoE) and ``command-r-35b`` (GQA, G = 4 at SMOKE, 8 at FULL).

Weights come from the reference's ``Model.init`` plus seeded numpy noise,
carried across by ``repro_torch.bridge``, as in
``tests/test_torch_model.py``.  Prefill plus 8 greedy decode steps feed
both packages the same tokens; the reference runs with its dense
attention (``use_flash_decode=False``) and with its Pallas flash-decode
kernel in interpret mode (``True``); the port always decodes through its
flash-decode wrapper, the plain version on CPU tensors.  Float32: logits
within 1e-4 (the same sums in another order), greedy tokens identical.
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
from repro.models import transformer as RT
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models import transformer as T
from test_torch_model import F32_TOL, _ref_params, _run_both

FAMILIES = ["dbrx-132b", "jamba-1.5-large-398b", "command-r-35b"]


def _configs(arch, dtype="float32", **kw):
    return (dataclasses.replace(ref_config(arch, "smoke"), dtype=dtype, **kw),
            dataclasses.replace(get_config(arch, "smoke"), dtype=dtype, **kw))


@pytest.mark.parametrize("use_flash_decode", [False, True])
@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_decode_logits_match_reference(arch, use_flash_decode):
    rc, tc = _configs(arch)
    rc = dataclasses.replace(rc, use_flash_decode=use_flash_decode)
    steps = _run_both(rc, tc)
    assert len(steps) == 9
    for want, got in steps:
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
        np.testing.assert_array_equal(got[:, -1].argmax(-1),
                                      want[:, -1].argmax(-1))


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_train_logits_and_aux_match_reference(arch):
    rc, tc = _configs(arch)
    p = _ref_params(ref_build(rc))
    toks = np.random.default_rng(2).integers(
        4, rc.vocab_size, size=(2, 16)).astype(np.int32)
    want, wx = jax.jit(lambda p, x: RT.forward_train(p, rc, x))(
        jax.tree_util.tree_map(jnp.asarray, p), {"tokens": jnp.asarray(toks)})
    got, gx = build_model(tc).train_logits(
        params_from_numpy(p, device="cpu"), {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(float(gx["aux_loss"]), float(wx["aux_loss"]),
                               rtol=1e-6)
    assert (float(gx["aux_loss"]) > 0) == (rc.moe is not None)


def test_embed_one_hot_matches_reference():
    """``embed_one_hot``: the embedding as a one-hot product, on qwen
    SMOKE: prefill + decode and the training forward."""
    rc, tc = _configs("qwen1.5-32b", embed_one_hot=True)
    for want, got in _run_both(rc, tc, steps=4):
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
        np.testing.assert_array_equal(got[:, -1].argmax(-1),
                                      want[:, -1].argmax(-1))
    p = _ref_params(ref_build(rc))
    toks = np.random.default_rng(4).integers(
        4, rc.vocab_size, size=(2, 12)).astype(np.int32)
    tp = params_from_numpy(p, device="cpu")
    got = T._embed_lookup(tp, tc, torch.from_numpy(toks))
    want = RT._embed_lookup(jax.tree_util.tree_map(jnp.asarray, p), rc,
                            jnp.asarray(toks))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), tp["embed"][torch.from_numpy(toks).long()].numpy())
