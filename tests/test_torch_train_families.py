"""The port's train step against the reference's on every served family,
at SMOKE size in float32.

``make_train_step`` (fused loss, AdamW) runs 2 steps in both packages on
the same params (the reference's ``Model.init`` plus seeded numpy noise,
carried across by ``repro_torch.bridge``) and the same numpy batch, for
``dbrx-132b`` (MoE), ``minicpm3-4b`` (MLA), ``deepseek-v3-671b`` (MLA, a
dense first layer, MoE with a shared expert, MTP), ``gemma3-12b``
(sliding window over a sequence past the window), ``phi-3-vision-4.2b``
(with ``image_emb``) and ``whisper-large-v3`` (with ``audio_emb``); dbrx
and deepseek also with ``microbatches=2``, where the reference averages
the aux and MTP losses per microbatch in its scan.  The reference's step
runs jitted.  Tolerances, those of ``tests/test_torch_training.py``:
loss, grad_norm and lr within 1e-5 relative, the moments within 1e-5,
the params within 1e-5 for all but one in 10,000 elements and within
``2 * lr`` a step for every element (Adam divides by sqrt(v): an element
whose gradient is as small as the summation noise can move by another
fraction of lr in either package).
"""
import torch_threads  # noqa: F401  (caps torch's threads under xdist)
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as ref_config
from repro.models import build_model as ref_build
from repro.models.schema import init_from_schema as ref_init_from_schema
from repro.training import optimizer as ref_opt
from repro.training import steps as ref_steps
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models.schema import tree_leaves, zeros_from_schema
from repro_torch.models.transformer import forward_train_loss
from repro_torch.training import optimizer as opt
from repro_torch.training import steps
from test_torch_training import (LOSS_RTOL, MOMENT_TOL, _assert_adam_params_close,
                                 _assert_trees_close, _np_params)

LR, N_STEPS = 1e-3, 2
# arch -> (batch, text positions); gemma3 SMOKE's window is 32, so 64
# positions make the local layer mask
FAMILIES = {
    "dbrx-132b": (4, 32),
    "minicpm3-4b": (4, 32),
    "deepseek-v3-671b": (4, 32),
    "gemma3-12b": (2, 64),
    "phi-3-vision-4.2b": (4, 32),
    "whisper-large-v3": (4, 32),
}


def _configs(arch):
    return (dataclasses.replace(ref_config(arch, "smoke"), dtype="float32"),
            dataclasses.replace(get_config(arch, "smoke"), dtype="float32"))


def _batch(rc, B, S, seed=10):
    """Tokens and labels (some ignored), and the stub frontend's
    embeddings where the config takes them: image patches (B,
    n_modality_tokens, modality_embed_dim) or frames (B,
    encoder_seq_len, d_model), at 0.02 as ``LMDataset`` draws them."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(4, rc.vocab_size, (B, S)).astype(np.int32),
             "labels": rng.integers(4, rc.vocab_size, (B, S)).astype(np.int32)}
    batch["labels"][0, :3] = -1
    batch["labels"][-1, -2:] = -1
    if rc.modality == "vision":
        batch["image_emb"] = 0.02 * rng.standard_normal(
            (B, rc.n_modality_tokens, rc.modality_embed_dim)).astype(np.float32)
    if rc.modality == "audio":
        batch["audio_emb"] = 0.02 * rng.standard_normal(
            (B, rc.encoder_seq_len, rc.d_model)).astype(np.float32)
    return batch


def _run(arch, microbatches=1):
    """Both packages' train steps, N_STEPS of them on one batch: (ref
    metrics, port metrics, (ref params, ref state), (port params, port
    state))."""
    rc, tc = _configs(arch)
    B, S = FAMILIES[arch]
    cfg = dict(lr=LR, warmup_steps=1, total_steps=10)
    np_params = _np_params(rc)
    rp = jax.tree_util.tree_map(jnp.asarray, np_params)
    tp = params_from_numpy(np_params, device="cpu")
    rst = ref_init_from_schema(jax.random.PRNGKey(0),
                               ref_opt.adamw_init_schema(ref_build(rc).schema))
    tst = zeros_from_schema(opt.adamw_init_schema(build_model(tc).schema),
                            device="cpu")
    rstep = jax.jit(ref_steps.make_train_step(
        ref_build(rc), ref_opt.OptConfig(**cfg), microbatches=microbatches))
    tstep = steps.make_train_step(build_model(tc), opt.OptConfig(**cfg),
                                  microbatches=microbatches)
    b = _batch(rc, B, S)
    want, got = [], []
    for _ in range(N_STEPS):
        rp, rst, rm = rstep(rp, rst, {k: jnp.asarray(v) for k, v in b.items()})
        tp, tst, tm = tstep(tp, tst, {k: torch.from_numpy(v.copy())
                                      for k, v in b.items()})
        want.append({k: float(v) for k, v in rm.items()})
        got.append({k: float(v) for k, v in tm.items()})
    return want, got, (rp, rst), (tp, tst)


@pytest.mark.parametrize("arch,microbatches", [
    *((a, 1) for a in FAMILIES),
    ("dbrx-132b", 2),
    ("deepseek-v3-671b", 2),
])
def test_train_steps_match_reference(arch, microbatches):
    want, got, (rp, rst), (tp, tst) = _run(arch, microbatches)
    for w, g in zip(want, got):
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(g[key], w[key], rtol=LOSS_RTOL,
                                       err_msg=f"{arch} {key}")
    assert got[-1]["loss"] < got[0]["loss"]
    assert int(tst["step"]) == N_STEPS
    _assert_adam_params_close(tp, rp, bound=2 * LR * N_STEPS)
    _assert_trees_close(tst["m"], rst["m"], MOMENT_TOL)
    _assert_trees_close(tst["v"], rst["v"], MOMENT_TOL)
    assert all(not p.requires_grad for p in tree_leaves(tp))


class _Float32Copies(TorchDispatchMode):
    """Records the shapes of the float32 copies that ``aten._to_copy``
    makes."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if (func is torch.ops.aten._to_copy.default
                and out.dtype == torch.float32):
            self.shapes.append(tuple(out.shape))
        return out


def test_microbatch_accumulation_makes_no_float32_copy_of_a_gradient():
    """The float32 accumulators take each microbatch's bf16 gradients by
    an in-place add that widens inside the sum: no float32 copy of a
    gradient (the embedding's would be 3.1 GB at qwen1.5-32b's widths)
    is made before the update, and the accumulated gradients are those
    of ``acc + g.float()``."""
    tc = dataclasses.replace(get_config("qwen1.5-32b", "smoke"),
                             dtype="bfloat16")
    model = build_model(tc)
    b = _batch(tc, 4, 32)
    batch = {k: torch.from_numpy(v) for k, v in b.items()}
    seen = {}

    def capture(grads, opt_state, params, cfg):
        seen["grads"] = grads
        return params, opt_state, {}
    params = model.init(seed=0, device="cpu")
    state = zeros_from_schema(opt.adamw_init_schema(model.schema),
                              device="cpu")
    step = steps.make_train_step(model, opt.OptConfig(), microbatches=2)
    with mock.patch.object(steps, "adamw_update", capture), \
            _Float32Copies() as copies:
        step(params, state, batch)
    acc = seen["grads"]
    embed = tuple(params["embed"].shape)
    assert embed not in copies.shapes
    assert all(g.dtype == torch.float32 for g in acc)
    # the same accumulation, written out over the two halves' gradients
    leaves = tree_leaves(params)
    want = [torch.zeros(p.shape, dtype=torch.float32) for p in leaves]
    for half in steps._split_microbatches(batch, 2):
        for p in leaves:
            p.requires_grad_(True)
        g = torch.autograd.grad(forward_train_loss(params, tc, half), leaves,
                                allow_unused=True)
        for p in leaves:
            p.requires_grad_(False)
        for w, gi in zip(want, g):
            if gi is not None:
                w.copy_(w + gi.float())
    for a, w in zip(acc, want):
        torch.testing.assert_close(a, w.div_(2), rtol=0, atol=0)
