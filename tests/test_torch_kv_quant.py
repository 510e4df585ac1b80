"""The port's int8 KV cache against the reference, on qwen SMOKE float32.

``kv_quant.quantize`` gives the reference's codes and scales bit for bit
(float32 arithmetic, the float16 scale with its ``+ 1e-8``, round half
to even); the dense int8 cache and the paged int8 pool decode the
reference's logits and serve the reference's int8 engines' tokens.
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
from repro.serving import kv_quant as ref_kq
from repro.serving.continuous import ContinuousEngine as RefEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models.schema import tree_leaves
from repro_torch.serving import kv_quant as KQ
from repro_torch.serving.continuous import ContinuousEngine

# float32 logits: the same function summed in another order
LOGIT_TOL = 1e-4


@pytest.mark.parametrize("shape,scale", [
    ((3, 5, 4, 64), 1.0), ((2, 7, 2, 128), 40.0), ((4, 1, 64), 1e-3)])
def test_quantize_gives_the_reference_codes_and_scales(shape, scale):
    x = (np.random.default_rng(0).standard_normal(shape) * scale).astype(
        np.float32)
    q, s = KQ.quantize(torch.from_numpy(x))
    rq, rs = ref_kq.quantize(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float16
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(
        KQ.dequantize(q, s, torch.float32).numpy(),
        np.asarray(ref_kq.dequantize(rq, rs, jnp.float32)))


def test_rounding_is_half_to_even_like_the_reference():
    # amax 127 -> scale 1 in float16: x / scale lands on the halves
    x = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -126.5, 3.49]],
                 np.float32)
    q, s = KQ.quantize(torch.from_numpy(x))
    rq, rs = ref_kq.quantize(jnp.asarray(x))
    assert float(s) == 1.0
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert q.tolist() == [[127, 0, 2, 2, 0, -2, -126, 3]]


def test_schema_and_bytes_are_the_reference_ones():
    got, want = KQ.quant_kv_cache_schema(2, 8, 4, 64), \
        ref_kq.quant_kv_cache_schema(2, 8, 4, 64)
    assert {k: (v.shape, v.axes, v.dtype) for k, v in got.items()} == \
        {k: (v.shape, v.axes, v.dtype) for k, v in want.items()}
    for quantized in (False, True):
        assert KQ.cache_bytes(8, 392, 40, 128, quantized) == \
            ref_kq.cache_bytes(8, 392, 40, 128, quantized)
    # the full-width int8 pool: 665,600 B per position over 64 layers
    assert 64 * KQ.cache_bytes(1, 1, 40, 128, True) == 665_600


@pytest.fixture(scope="module")
def models():
    rc = dataclasses.replace(ref_config("qwen1.5-32b", "smoke"),
                             dtype="float32", kv_quant_int8=True)
    tc = dataclasses.replace(get_config("qwen1.5-32b", "smoke"),
                             dtype="float32", kv_quant_int8=True)
    rm, tm = ref_build(rc), build_model(tc)
    np_params = jax.tree_util.tree_map(np.asarray,
                                       rm.init(jax.random.PRNGKey(0)))
    return (rm, jax.tree_util.tree_map(jnp.asarray, np_params), tm,
            params_from_numpy(np_params, device="cpu"))


def test_int8_cache_prefill_and_decode_logits_match_reference(models):
    """Prefill + 6 greedy decode steps on the dense int8 cache: logits
    within the float32 tolerance, and the same int8 codes in the cache
    except where a k/v value (itself a float32 sum in another order)
    sits within rounding of a code boundary: one code step, rarely."""
    rm, rp, tm, tp = models
    toks = np.random.default_rng(0).integers(4, 512, size=(3, 9)).astype(
        np.int32)
    rcache, tcache = rm.init_cache(3, 24), tm.init_cache(3, 24, device="cpu")
    assert sorted(tcache["blocks"]["p0"]) == ["k_q", "k_s", "v_q", "v_s"]
    rl, rcache = jax.jit(rm.prefill)(rp, {"tokens": jnp.asarray(toks)},
                                     rcache)
    tl, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tcache)
    decode = jax.jit(rm.decode)
    for _ in range(6):
        np.testing.assert_allclose(tl.numpy(), np.asarray(rl),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
        nxt = np.asarray(rl[:, -1]).argmax(-1).astype(np.int32)[:, None]
        rl, rcache = decode(rp, {"tokens": jnp.asarray(nxt)}, rcache)
        tl, tcache = tm.decode(tp, {"tokens": torch.from_numpy(nxt)}, tcache)
    codes = [(np.asarray(a), t.numpy()) for a, t in zip(
        jax.tree_util.tree_leaves(rcache["blocks"]),
        tree_leaves(tcache["blocks"])) if t.dtype == torch.int8]
    assert len(codes) == 2
    for a, t in codes:
        diff = np.abs(t.astype(np.int32) - a.astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3


def _prompts(seed):
    """``tests/test_paged_engine.py::_mixed_prompts``."""
    rng = np.random.default_rng(seed)
    mixed = [list(rng.integers(4, 512, size=n)) for n in (10, 7, 10, 5)]
    base = list(rng.integers(4, 512, size=16))
    return mixed + [base + list(rng.integers(4, 512, size=4))
                    for _ in range(3)]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_int8_engines_serve_the_reference_tokens(models, paged):
    """Dense-int8 and paged-int8 engines, two waves (the second
    cache-hot on the paged pool): the reference int8 engines' tokens."""
    rm, rp, tm, tp = models
    kw = dict(num_slots=3, max_len=64, max_new_cap=16, sync_every=4,
              prefill_batch=2)
    if paged:
        kw.update(paged=True, page_size=8)
    want = RefEngine(rm, rp, **kw)
    got = ContinuousEngine(tm, tp, **kw)
    prompts = _prompts(1)
    for wave in range(2):
        a = want.generate_many(prompts, max_new_tokens=10)
        b = got.generate_many(prompts, max_new_tokens=10)
        assert [list(g.tokens) for g in b] == \
            [list(w.tokens) for w in a], wave
    assert got.stats.prefill_tokens_avoided == \
        want.stats.prefill_tokens_avoided
    assert (got.stats.prefill_tokens_avoided > 0) == paged
