"""The port's Mamba2 family against the reference, on mamba2 SMOKE.

Weights come from the reference's ``Model.init(PRNGKey(0))`` plus seeded
numpy noise (so ``dt_bias``, ``A_log``, ``D`` and the norms are not
trivially 0 and 1), carried across by ``repro_torch.bridge``; tokens are
numpy draws.  The reference runs jitted (or eagerly, for one layer) on
the CPU, its Pallas SSD kernel in interpret mode; the port runs eagerly
on CPU tensors, K6's wrapper taking its plain version.

Tolerances, float32 unless stated: the scan's output and final state
1e-5 of their largest entry; one layer 1e-5; logits 1e-4 (the same sums
in another order over two layers and the unembedding), greedy tokens
identical; losses 1e-5 relative; gradients 1e-4 of each leaf's largest
entry; one AdamW step 1e-5, every element within ``2 * lr`` (an element
whose gradient is as small as the summation noise may move by a
different fraction of ``lr``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as ref_config
from repro.models import build_model as ref_build
from repro.models import ssm as ref_ssm
from repro.models import transformer as RT
from repro.models.schema import init_from_schema as ref_init_from_schema
from repro.serving.continuous import ContinuousEngine as RefEngine
from repro.training import optimizer as ref_opt
from repro.training import steps as ref_steps
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.configs import mamba2_130m
from repro_torch.models import build_model
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.models.schema import tree_leaves, tree_map, zeros_from_schema
from repro_torch.serving.continuous import ContinuousEngine
from repro_torch.training import optimizer as opt
from repro_torch.training import steps

SCAN_TOL = 1e-5
LAYER_TOL = 1e-5
LOGIT_TOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
PARAM_TOL = 1e-5
ARCH = "mamba2-130m"


def _configs(dtype="float32", **kw):
    rc = dataclasses.replace(ref_config(ARCH, "smoke"), dtype=dtype, **kw)
    tc = dataclasses.replace(get_config(ARCH, "smoke"), dtype=dtype, **kw)
    return rc, tc


def _np_params(rc, seed=0):
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        np.asarray, ref_build(rc).init(jax.random.PRNGKey(0)))
    return jax.tree_util.tree_map(
        lambda a: (a.astype(np.float32)
                   + rng.normal(0, 0.02, a.shape).astype(np.float32)
                   ).astype(a.dtype), params)


def _both(rc, tc, seed=0):
    p = _np_params(rc, seed)
    return (ref_build(rc), jax.tree_util.tree_map(jnp.asarray, p),
            build_model(tc), params_from_numpy(p, device="cpu"))


@pytest.fixture(scope="module")
def models():
    return _both(*_configs())


def _tokens(rc, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        4, rc.vocab_size, size=(B, S)).astype(np.int32)


def _batch(rc, B=2, S=64, seed=0):
    toks = _tokens(rc, B, S, seed)
    labels = _tokens(rc, B, S, seed + 1)
    labels[0, :3] = -1                     # ignored positions
    return {"tokens": toks, "labels": labels}


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _paths(t, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _close(got, want, tol, key=""):
    """Within ``tol`` of the reference's largest entry."""
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=key)


# ---------------------------------------------------------------------------
# config and weights
# ---------------------------------------------------------------------------


def test_configs_copy_the_reference_field_for_field():
    from repro.configs import mamba2_130m as ref_mod
    for v in ("FULL", "SMOKE"):
        assert (dataclasses.asdict(getattr(mamba2_130m, v))
                == dataclasses.asdict(getattr(ref_mod, v))), v
    assert get_config(ARCH, "full").source == "arXiv:2405.21060"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_init_crosses_leaf_for_leaf(dtype):
    """The reference's ``Model.init(PRNGKey(0))`` tree converts bit for
    bit, on the port's schema (the same leaves, shapes and dtypes; bf16
    through ``ml_dtypes``)."""
    rc, tc = _configs(dtype)
    want = jax.tree_util.tree_map(np.asarray,
                                  ref_build(rc).init(jax.random.PRNGKey(0)))
    got = params_from_numpy(want, device="cpu")
    schema = dict(_paths(build_model(tc).schema))
    assert sorted(schema) == sorted(dict(_paths(want)))
    for key, w in _paths(want):
        g = dict(_paths(got))[key]
        assert tuple(g.shape) == schema[key].shape == w.shape, key
        assert str(g.dtype) == f"torch.{schema[key].dtype}", key
        np.testing.assert_array_equal(g.float().numpy(),
                                      w.astype(np.float32), err_msg=key)
    assert "mlp" not in dict(want["blocks"]["p0"])        # d_ff = 0
    assert set(want["blocks"]["p0"]) == {"ln1", "ssm", "ln2"}


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("c", [32, 64])
def test_ssd_chunked_output_and_final_state_match_reference(c):
    rng = np.random.default_rng(c)
    B, L, H, hd, G, N = 2, 128, 4, 32, 2, 16
    x = rng.standard_normal((B, L, H, hd)).astype(np.float32)
    Bm = (rng.standard_normal((B, L, G, N)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((B, L, G, N)) * 0.5).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((B, L, H)), 0).astype(np.float32)
    A_log = (rng.standard_normal(H) * 0.3).astype(np.float32)
    args = (x, Bm, Cm, dt, A_log)
    wy, ws = ref_ssm.ssd_chunked(*(jnp.asarray(a) for a in args), c)
    gy, gs = S.ssd_chunked(*(torch.from_numpy(a) for a in args), c)
    assert gs.dtype == torch.float32 and tuple(gs.shape) == (B, H, hd, N)
    _close(gy, wy, SCAN_TOL)
    _close(gs, ws, SCAN_TOL)


def _layer(np_params):
    p = np_params["blocks"]["p0"]["ssm"]
    return {k: v[0] for k, v in p.items()}


@pytest.mark.parametrize("branch", ["train", "prefill", "decode"])
def test_ssm_apply_branches_match_reference(models, branch):
    """No cache (train / eval); a cache and S > 1 (prefill from a zero
    state); a cache and S == 1 (the state update, from the prefill's
    cache).  The port writes the cache's tensors in place."""
    rc, tc = models[0].cfg, models[2].cfg
    p = _layer(_np_params(rc))
    rp, tp = _jnp(p), params_from_numpy(p, device="cpu")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 24, rc.d_model)).astype(np.float32)
    if branch == "train":
        want, wc = ref_ssm.ssm_apply(rp, jnp.asarray(x), rc)
        got, gc = S.ssm_apply(tp, torch.from_numpy(x), tc)
        assert wc is None and gc is None
        _close(got, want, LAYER_TOL)
        return
    schema = S.ssm_cache_schema(tc, 2)
    rcache = {k: jnp.zeros(s.shape, s.dtype) for k, s in schema.items()}
    tcache = zeros_from_schema(schema, device="cpu")
    _, rcache = ref_ssm.ssm_apply(rp, jnp.asarray(x), rc, cache=rcache)
    views = dict(tcache)
    _, out = S.ssm_apply(tp, torch.from_numpy(x), tc, cache=tcache)
    assert out is tcache and all(tcache[k] is views[k] for k in views)
    if branch == "decode":
        x1 = rng.standard_normal((2, 1, rc.d_model)).astype(np.float32)
        want, rcache = ref_ssm.ssm_apply(rp, jnp.asarray(x1), rc,
                                         cache=rcache)
        got, _ = S.ssm_apply(tp, torch.from_numpy(x1), tc, cache=tcache)
        _close(got, want, LAYER_TOL)
    for k in schema:
        assert tcache[k].dtype == torch.float32
        _close(tcache[k], rcache[k], LAYER_TOL, k)
    assert float(tcache["state"].abs().max()) > 0


# ---------------------------------------------------------------------------
# the model: no-cache forward, prefill + decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_pallas_ssd", [False, True])
def test_train_logits_match_reference(use_pallas_ssd):
    """S = 128: with ``use_pallas_ssd`` both packages' layers take their
    SSD kernel path (Pallas in interpret mode; K6's plain version)."""
    rc, tc = _configs(use_pallas_ssd=use_pallas_ssd)
    rm, rp, tm, tp = _both(rc, tc)
    toks = _tokens(rc, 2, 128, seed=1)
    want, wx = jax.jit(rm.train_logits)(rp, {"tokens": jnp.asarray(toks)})
    got, gx = tm.train_logits(tp, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32 and float(gx["aux_loss"]) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)


def _run_both(rm, rp, tm, tp, *, B=3, L=9, max_len=24, steps_=8, seed=0):
    """(ref logits, port logits) per step, both fed the reference's
    greedy tokens."""
    toks = _tokens(rm.cfg, B, L, seed)
    rcache, tcache = rm.init_cache(B, max_len), tm.init_cache(B, max_len,
                                                              device="cpu")
    rl, rcache = jax.jit(rm.prefill)(rp, {"tokens": jnp.asarray(toks)},
                                     rcache)
    tl, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tcache)
    out = [(np.asarray(rl, np.float32), tl.float().numpy())]
    decode = jax.jit(rm.decode)
    for _ in range(steps_):
        nxt = np.asarray(rl[:, -1], np.float32).argmax(-1).astype(np.int32)
        rl, rcache = decode(rp, {"tokens": jnp.asarray(nxt)[:, None]}, rcache)
        tl, tcache = tm.decode(tp, {"tokens": torch.from_numpy(nxt)[:, None]},
                               tcache)
        out.append((np.asarray(rl, np.float32), tl.float().numpy()))
    assert np.array_equal(np.asarray(rcache["pos"]), tcache["pos"].numpy())
    return out


def test_prefill_and_decode_logits_match_reference(models):
    for want, got in _run_both(*models):
        np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)
        np.testing.assert_array_equal(got[:, -1].argmax(-1),
                                      want[:, -1].argmax(-1))


def test_bf16_logits_within_stated_tolerance():
    """bf16 weights and conv caches: each framework rounds its bf16
    products, conv taps and residual sums at its own points (the scan
    and the state run in float32 in both), so the logits of the
    no-cache forward and of prefill + decode agree to a bf16-scale
    relative tolerance, 2e-2 of the largest, not bit for bit."""
    rc, tc = _configs(dtype="bfloat16")
    rm, rp, tm, tp = _both(rc, tc)
    toks = _tokens(rc, 2, 64, seed=2)
    want, _ = jax.jit(rm.train_logits)(rp, {"tokens": jnp.asarray(toks)})
    got, _ = tm.train_logits(tp, {"tokens": torch.from_numpy(toks)})
    pairs = [(np.asarray(want, np.float32), got.float().numpy())]
    pairs += _run_both(rm, rp, tm, tp, steps_=4)
    for w, g in pairs:
        rel = np.abs(g - w).max() / np.abs(w).max()
        assert rel <= 2e-2, rel


@pytest.mark.parametrize("use_pallas_ssd,L,cached,calls", [
    (True, 128, False, 2),     # every layer of the 2-layer SMOKE model
    (True, 96, False, 0),      # S % 128 != 0: the plain scan
    (False, 128, False, 0),
    (True, 128, True, 0),      # prefill into a cache: never the kernel
])
def test_layers_take_k6_under_the_reference_condition(
        monkeypatch, use_pallas_ssd, L, cached, calls):
    seen = []
    real = S.ssd_chunk_scan

    def spy(*a, chunk, **kw):
        seen.append(chunk)
        return real(*a, chunk=chunk, **kw)
    monkeypatch.setattr(S, "ssd_chunk_scan", spy)
    _, tc = _configs(use_pallas_ssd=use_pallas_ssd)
    tm = build_model(tc)
    tp = tm.init(device="cpu")
    toks = {"tokens": torch.ones(1, L, dtype=torch.int64)}
    if cached:
        tm.prefill(tp, toks, tm.init_cache(1, L, device="cpu"))
    else:
        tm.train_logits(tp, toks)
    assert seen == [64] * calls    # SMOKE's chunk_size


def test_paged_cache_raises_for_mamba_layers(models):
    """The reference pages full-attention GQA stacks only; so does the
    port."""
    tm = models[2]
    with pytest.raises(ValueError, match="full-attention"):
        tm.paged_cache_schema(2, 8, 4, 3)


# ---------------------------------------------------------------------------
# the engine and the Gateway
# ---------------------------------------------------------------------------


KW = dict(num_slots=3, max_len=40, max_new_cap=12, sync_every=4)


def _prompts(n, lengths, seed=0, vocab=512):
    rng = np.random.default_rng(seed)
    return [list(rng.integers(4, vocab, size=lengths[i % len(lengths)]))
            for i in range(n)]


@pytest.mark.parametrize("prefill_batch", [1, 2])
def test_generate_many_tokens_identical_to_reference(models, prefill_batch):
    """7 prompts on 3 slots (slot reuse: a reused slot's state and conv
    tails are overwritten at admission), mixed lengths."""
    rm, rp, tm, tp = models
    prompts = _prompts(7, [6, 11, 6, 9])
    ref = RefEngine(rm, rp, prefill_batch=prefill_batch, **KW)
    port = ContinuousEngine(tm, tp, prefill_batch=prefill_batch, **KW)
    want = ref.generate_many(prompts, max_new_tokens=10)
    got = port.generate_many(prompts, max_new_tokens=10)
    assert [list(g.tokens) for g in got] == [list(w.tokens) for w in want]
    for f in ("n_admitted", "n_completed", "n_prefills", "n_decode_chunks",
              "n_decode_steps", "max_concurrent"):
        assert getattr(port.stats, f) == getattr(ref.stats, f), f
    assert port.stats.max_concurrent == 3
    assert port.stats.cache_allocations == 2


class _ScalarReads(TorchDispatchMode):
    """Counts device-to-host scalar reads (``aten._local_scalar_dense``),
    including the ones PyTorch makes inside its own C++."""

    def __init__(self):
        super().__init__()
        self.reads = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.reads += func is torch.ops.aten._local_scalar_dense.default
        return func(*args, **(kwargs or {}))


def test_decode_chunk_issues_no_host_sync(models, monkeypatch):
    """The Mamba2 dense engine's decode chunk: the conv tails, the state
    update and the slot bookkeeping stay tensor ops."""
    _, _, tm, tp = models
    eng = ContinuousEngine(tm, tp, prefill_batch=3, **KW)
    for rid, p in enumerate(_prompts(2, [8], seed=2)):
        eng.submit(rid, p, 8)
    eng.step()                       # admit + first sync: one slot idle
    reads = []
    for name in ("item", "tolist", "numpy", "cpu", "__bool__"):
        orig = getattr(torch.Tensor, name)

        def spy(self, *a, _orig=orig, _name=name, **kw):
            reads.append(_name)
            return _orig(self, *a, **kw)
        monkeypatch.setattr(torch.Tensor, name, spy)
    with _ScalarReads() as scalar:
        eng.executor.decode_chunk()
    monkeypatch.undo()
    assert reads == [] and scalar.reads == 0


def test_gateway_serves_like_reference(models):
    """FixedPolicy(0) (k=2, guarded) over the dense engine backend:
    outcomes and GatewayStats equal the reference's."""
    from repro.core.config import RetrievalConfig as RefRetrievalConfig
    from repro.core.config import TestbedConfig
    from repro.data import SyntheticSquad as RefSquad
    from repro.data.tokenizer import HashTokenizer as RefTokenizer
    from repro.retrieval.bm25 import BM25Index as RefBM25
    from repro.routing import ContinuousEngineBackend as RefBackend
    from repro.routing import FixedPolicy as RefFixed
    from repro.routing import Gateway as RefGateway
    from repro.routing import Request as RefRequest
    from repro_torch.core.config import RetrievalConfig, RouterConfig
    from repro_torch.data import HashTokenizer, SyntheticSquad
    from repro_torch.retrieval import BM25Index
    from repro_torch.routing import (ContinuousEngineBackend, FixedPolicy,
                                     Gateway, Request)
    rm, rp, tm, tp = models
    tb = TestbedConfig()
    kw = dict(n_paragraphs=40, n_questions=24,
              answerable_frac=tb.answerable_frac, seed=tb.seed)
    engine = dict(num_slots=4, max_prompt_len=96, max_new_tokens=4,
                  prefill_batch=2)
    runs = []
    for squad, bm25, rcfg, tok, backend, gateway, fixed, request, params, \
            model, router in (
            (RefSquad, RefBM25, RefRetrievalConfig, RefTokenizer, RefBackend,
             RefGateway, RefFixed, RefRequest, rp, rm, tb.router),
            (SyntheticSquad, BM25Index, RetrievalConfig, HashTokenizer,
             ContinuousEngineBackend, Gateway, FixedPolicy, Request, tp, tm,
             RouterConfig(**dataclasses.asdict(tb.router)))):
        data = squad(**kw)
        index = bm25.build([p.text for p in data.paragraphs], rcfg())
        be = backend.create(model, params, tok(model.cfg.vocab_size), index,
                            **engine)
        rows = []
        gw = gateway(fixed(0), be, router_cfg=router, index=index,
                     max_batch=6, adaptive_refusal=False,
                     on_outcome=lambda r, a, o, rew, rows=rows: rows.append(
                         (r.qid, a.idx, o.answer, o.cost_tokens, o.refused,
                          o.hallucinated, o.hit, rew)))
        st_ = gw.serve([request(qid=q.qid, question=q, slo="quality_first")
                        for q in data.questions[-12:]])
        runs.append((rows, st_, be.engine.stats))
    (rrows, rst, res), (trows, tst, tes) = runs
    assert trows == rrows
    for f in ("served", "rejected", "refusal_cap_history", "total_reward",
              "avg_reward"):
        assert getattr(tst, f) == getattr(rst, f), f
    assert dict(tst.action_counts) == dict(rst.action_counts) == {0: 12}
    for f in ("n_admitted", "n_completed", "n_prefills", "n_decode_steps"):
        assert getattr(tes, f) == getattr(res, f), f


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def test_forward_train_loss_and_gradients_match_jax_grad():
    """Every leaf, the stacked ``blocks`` ones and the tied embedding
    included; ``ln2`` (no MLP reads it) has a zero gradient in both."""
    rc, tc = _configs(remat="full")
    _, rp, _, tp = _both(rc, tc)
    b = _batch(rc)
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p: RT.forward_train_loss(p, rc, _jnp(b))))(rp)
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    loss = T.forward_train_loss(tp, tc, _torch(b))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    for p in leaves:
        p.requires_grad_(False)
    flat = iter(grads)
    got = tree_map(lambda _: next(flat), tp)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=LOSS_RTOL)
    want = dict(_paths(jax.tree_util.tree_map(np.asarray, want)))
    got = dict(_paths(got))
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        if got[key] is None:
            assert key.endswith("/ln2") and not np.asarray(w).any(), key
            continue
        _close(got[key], w, GRAD_TOL, key)
    assert got["/blocks/p0/ssm/A_log"].abs().max() > 0


def test_one_train_step_matches_reference():
    """``make_train_step`` (fused loss, AdamW) once: loss, gradient norm
    and every param as the reference's step leaves them."""
    rc, tc = _configs()
    cfg = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    rm, rp, tm, tp = _both(rc, tc)
    rst = ref_init_from_schema(jax.random.PRNGKey(0),
                               ref_opt.adamw_init_schema(rm.schema))
    tst = zeros_from_schema(opt.adamw_init_schema(tm.schema), device="cpu")
    b = _batch(rc, B=2, S=64, seed=10)
    rp, rst, rmet = jax.jit(ref_steps.make_train_step(
        rm, ref_opt.OptConfig(**cfg)))(rp, rst, _jnp(b))
    tp, tst, tmet = steps.make_train_step(tm, opt.OptConfig(**cfg))(
        tp, tst, _torch(b))
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tmet[key]), float(rmet[key]),
                                   rtol=LOSS_RTOL, err_msg=key)
    assert int(tst["step"]) == 1
    n = past = 0
    for key, w in _paths(jax.tree_util.tree_map(np.asarray, rp)):
        diff = np.abs(dict(_paths(tp))[key].numpy() - w)
        assert diff.max() <= 2 * cfg["lr"], (key, diff.max())
        n, past = n + diff.size, past + int((diff > PARAM_TOL).sum())
    assert past <= 1e-4 * n, (past, n)
    assert all(not p.requires_grad for p in tree_leaves(tp))


def test_train_step_with_use_pallas_ssd_raises():
    """The reference cannot differentiate through its SSD kernel; the
    port's guard refuses the same step and changes nothing."""
    rc, tc = _configs(use_pallas_ssd=True)
    _, _, tm, tp = _both(rc, tc)
    tst = zeros_from_schema(opt.adamw_init_schema(tm.schema), device="cpu")
    step = steps.make_train_step(tm, opt.OptConfig())
    with pytest.raises(RuntimeError, match="no gradient"):
        step(tp, tst, _torch(_batch(rc, B=1, S=128)))
    assert all(not p.requires_grad for p in tree_leaves(tp))
    assert int(tst["step"]) == 0
    # 96 is not a multiple of 128: the plain scan, which trains
    step(tp, tst, _torch(_batch(rc, B=1, S=96)))
    assert int(tst["step"]) == 1


@pytest.mark.parametrize("chunk,dt_bias", [(256, 0.0), (64, 2.5)])
def test_where_of_inf_gradient_is_nan_in_both_packages(chunk, dt_bias):
    """Once cum falls by more than 88 within a chunk, exp(cum_t - cum_s)
    is inf above the diagonal.  At a chunk of 256 (FULL's) seeded
    weights do it (dt = softplus(~0) = 0.69, a = -1: about 177); at 64 a
    dt of about 2.6 does it (``dt_bias`` 2.5: about 163), as training at
    a high learning rate can make it.  The forward selects 0 there and
    stays finite; the gradient multiplies that inf by the mask's 0 and
    is NaN, in the reference as in the port (not repaired: the port adds
    nothing the reference lacks).  Seeded weights train at a chunk of 64
    (``test_forward_train_loss_and_gradients_match_jax_grad``)."""
    rc, tc = _configs()
    rc = dataclasses.replace(rc, ssm=dataclasses.replace(
        rc.ssm, chunk_size=chunk))
    tc = dataclasses.replace(tc, ssm=dataclasses.replace(
        tc.ssm, chunk_size=chunk))
    p = _np_params(rc)
    p["blocks"]["p0"]["ssm"]["dt_bias"] += np.float32(dt_bias)
    rp, tp = _jnp(p), params_from_numpy(p, device="cpu")
    b = _batch(rc, B=1, S=256)
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p: RT.forward_train_loss(p, rc, _jnp(b))))(rp)
    leaves = tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    loss = T.forward_train_loss(tp, tc, _torch(b))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    for t in leaves:
        t.requires_grad_(False)
    assert np.isfinite(float(want_loss)) and torch.isfinite(loss)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=LOSS_RTOL)
    want_a = np.asarray(want["blocks"]["p0"]["ssm"]["A_log"])
    leaf = tp["blocks"]["p0"]["ssm"]["A_log"]
    got_a = grads[[i for i, t in enumerate(leaves) if t is leaf][0]]
    assert np.isnan(want_a).all() and torch.isnan(got_a).all()
