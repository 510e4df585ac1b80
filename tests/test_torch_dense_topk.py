"""Fused dense top-k (K3) in the port against the reference.

The port's wrapper on CPU tensors runs its plain version
(``dense_topk_torch``); it is held against the reference's
``ops.dense_topk`` (the Pallas kernel in interpret mode, as
``tests/test_dense_retrieval.py`` runs it) and its
``ref.dense_topk_ref`` oracle on the same numpy inputs, k up to 64: ids
identical, ties included, and scores within 1e-5 (the float32 sums run
in another order).  The CUDA kernel itself runs only on the card, where
``chip_smoke.py`` holds it against the plain version; here its products
(three TF32 products per float32 product, a fresh tensor-core
accumulator a 32-column chunk) are emulated against float64, and its
plan of the work (tiles, slices, merges) and launch arguments are
checked.
"""
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.core.config import RetrievalConfig as RefRetrievalConfig
from repro.kernels import dense_topk as ref_dense_topk
from repro.kernels.ref import dense_topk_ref
from repro.retrieval.dense import DenseIndex as RefDenseIndex
from repro_torch.core.config import RetrievalConfig
from repro_torch.kernels import dense_topk as dt
from repro_torch.retrieval.dense import DenseIndex

TOL = 1e-5


def _inputs(Q, D, E, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((Q, E)).astype(np.float32),
            rng.standard_normal((D, E)).astype(np.float32))


def _port(q, d, k):
    s, i = dt.dense_topk(torch.from_numpy(q), torch.from_numpy(d), k=k)
    assert s.dtype == torch.float32 and i.dtype == torch.int32
    return s.numpy(), i.numpy()


def _assert_matches(q, d, k):
    gs, gi = _port(q, d, k)
    for ws, wi in (ref_dense_topk(jnp.asarray(q), jnp.asarray(d), k=k),
                   dense_topk_ref(jnp.asarray(q), jnp.asarray(d),
                                  min(k, d.shape[0]))):
        np.testing.assert_array_equal(gi, np.asarray(wi))
        np.testing.assert_allclose(gs, np.asarray(ws), rtol=TOL, atol=TOL)
    return gs, gi


@pytest.mark.parametrize("Q,D,E,k", [
    (8, 256, 128, 10),
    (8, 200, 128, 10),     # D not a block multiple
    (4, 64, 32, 5),
    (1, 37, 64, 3),        # D < block and not a multiple of anything
    (5, 96, 32, 4),        # Q not a block multiple
    (16, 512, 256, 1),
    (8, 256, 128, 64),     # the kernel's largest k
    (4, 100, 32, 64),      # k = 64, D not a block multiple
    (3, 64, 32, 64),       # k = D = 64
])
def test_plain_version_matches_pallas_and_oracle(Q, D, E, k):
    gs, _ = _assert_matches(*_inputs(Q, D, E), k)
    assert (np.diff(gs, axis=1) <= 0).all()          # descending


def test_duplicate_rows_tie_to_the_lower_id():
    """Every doc twice: exact score ties resolve to the lower doc id."""
    rng = np.random.default_rng(4)
    base = rng.standard_normal((8, 32)).astype(np.float32)
    d = np.concatenate([base, base], axis=0)
    q = rng.standard_normal((1, 32)).astype(np.float32)
    _, gi = _assert_matches(q, d, 4)
    # each of the 4 best docs' twin (id + 8) ranks right after it
    assert gi[0, 1] == gi[0, 0] + 8 and gi[0, 3] == gi[0, 2] + 8


def test_boundary_ties_resolve_to_the_lower_ids():
    """Exact ties straddling the k boundary (duplicate docs): the lower
    doc ids, in the numpy host path and the batched path alike."""
    doc = "the length of river0001 is val11111"
    docs = [doc] * 6 + ["unrelated treaty text"]
    cfg = RetrievalConfig(vocab_hash_dim=1024, dense_embed_dim=128)
    rcfg = RefRetrievalConfig(vocab_hash_dim=1024, dense_embed_dim=128)
    idx, ref = DenseIndex.build(docs, cfg), RefDenseIndex.build(docs, rcfg)
    ids, scores = idx.topk("length of river0001", 3)
    assert ids.tolist() == [0, 1, 2]
    assert scores[0] == scores[1] == scores[2]
    want_ids, want_s = ref.topk("length of river0001", 3)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(scores, want_s)
    bids, bscores = idx.topk_batch(["length of river0001"], 3, device="cpu")
    rids, rscores = ref.topk_batch(["length of river0001"], 3)
    np.testing.assert_array_equal(bids, rids)
    assert bids.dtype == np.int64 and bids[0].tolist() == [0, 1, 2]
    np.testing.assert_allclose(bscores, rscores, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("k,D", [(0, 16), (-3, 16), (4, 0), (40, 7)])
def test_edge_cases_follow_the_reference_wrapper(k, D):
    """k <= 0 and an empty corpus give empty (Q, 0) rows; k clamps to
    the corpus size."""
    q, d = _inputs(3, D, 16, seed=5)
    gs, gi = _port(q, d, k)
    ws, wi = ref_dense_topk(jnp.asarray(q), jnp.asarray(d), k=k)
    assert gs.shape == gi.shape == np.asarray(ws).shape == (3, min(max(k, 0), D))
    np.testing.assert_array_equal(gi, np.asarray(wi))
    np.testing.assert_allclose(gs, np.asarray(ws), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n_docs,n_queries,n_sms", [
    (1, 1, 132), (64, 64, 132), (65, 8, 132), (20000, 64, 132),
    (1 << 20, 64, 132), (1 << 20, 200, 132), (5000, 1000, 8),
    (37, 5, 132), (20000, 200, 132)])
def test_splits_cover_the_doc_axis_exactly(n_docs, n_queries, n_sms):
    """The kernel's plan: every 64-doc tile in exactly one slice (and one
    of its two warpgroups, which take the slice's tiles in turn), slices
    within one tile of each other, the grid resident at once when it has
    to meet at the merge's barrier, and every slice's list of every query
    merged exactly once (query j of a query tile by slice j % slices)."""
    p = dt.plan(n_docs, n_queries, n_sms)
    n_tiles = -(-n_docs // dt.TILE)
    assert p.q_tiles == -(-n_queries // dt.QUERY_TILE)
    assert 1 <= p.slices <= n_tiles
    assert p.slices == 1 or p.q_tiles * p.slices <= n_sms
    seen, sizes = [], []
    for s in range(p.slices):
        tiles = list(dt.tile_range(s, p.slices, n_tiles))
        assert tiles, "an empty slice"
        assert sorted(tiles[0::2] + tiles[1::2]) == tiles
        seen += tiles
        sizes.append(len(tiles))
    assert seen == list(range(n_tiles))
    assert max(sizes) - min(sizes) <= 1
    if p.slices > 1:
        merged = Counter((j, src) for s in range(p.slices)
                         for j in dt.merged_queries(s, p.slices)
                         for src in range(p.slices))
        assert merged == Counter({(j, src): 1 for j in range(dt.QUERY_TILE)
                                  for src in range(p.slices)})


@pytest.mark.parametrize("k,slots", [(1, 16), (10, 16), (16, 16), (17, 32),
                                     (32, 32), (33, 64), (64, 64)])
def test_list_slots_and_scratch_follow_k(k, slots):
    """A running list holds 16, 32 or 64 entries; the merge keeps every
    block's list of each of its 64 queries in rows of slots + 4, and a
    single slice needs none."""
    assert dt.list_slots(k) == slots
    p = dt.plan(20000, 200, 132)
    assert dt.scratch_sizes(p, k) == 4 * 33 * 64 * (slots + 4)
    assert dt.scratch_sizes(dt.plan(37, 5, 132), k) == 0


class _Stream:
    cuda_stream = 0


@pytest.mark.parametrize("Q,D,k", [(64, 20000, 10), (200, 20000, 64),
                                   (5, 37, 3)])
def test_launch_passes_the_plan_and_its_scratch(monkeypatch, Q, D, k):
    """One launch a call, with the plan's slice count, the output and,
    for more than one slice, lists of ``scratch_sizes`` entries and two
    zeroed barrier counters; a single slice passes no scratch."""
    calls = []

    def fake_kernel(*args):
        calls.append(args)
        return 0
    monkeypatch.setattr(dt, "_kernel", lambda: fake_kernel)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: _Stream())
    monkeypatch.setitem(dt._num_sms, torch.device("cpu"), 132)
    monkeypatch.setattr(dt, "_scratches", {})
    monkeypatch.setattr(dt.dense_topk, "launches", 0)
    q, d = (torch.from_numpy(a) for a in _inputs(Q, D, 256))
    s, i = dt._launch(q, d, k)
    assert s.shape == i.shape == (Q, k) and dt.dense_topk.launches == 1
    (args,) = calls
    p = dt.plan(D, Q, 132)
    assert args[7:13] == (Q, D, 256, k, p.slices, 0)
    if p.slices == 1:
        assert args[2:5] == (None, None, None)
        return
    bar, ls, li = dt._scratches[(torch.device("cpu"), 0)]
    assert args[2:5] == (ls.data_ptr(), li.data_ptr(), bar.data_ptr())
    assert ls.numel() == li.numel() == dt.scratch_sizes(p, k)
    assert bar.tolist() == [0, 0]


def test_cpu_tensors_take_the_plain_path(monkeypatch):
    def no_kernel(*a):
        raise AssertionError("the CUDA kernel was reached from CPU tensors")
    monkeypatch.setattr(dt, "_launch", no_kernel)
    before = dt.dense_topk.launches
    _port(*_inputs(4, 64, 32), 5)
    assert dt.dense_topk.launches == before


@pytest.mark.parametrize("E,k,error,match", [
    (256, 10, RuntimeError, "nvcc"),   # passes the checks, cannot build
    (256, 33, RuntimeError, "nvcc"),   # k <= 64 since the redesign
    (256, 64, RuntimeError, "nvcc"),
    (256, 65, ValueError, "k=65"),     # a quad holds at most 64 entries
    (30, 10, ValueError, "width 30"),  # 16-byte row loads
])
def test_cuda_request_launches_or_raises_never_falls_back(
        monkeypatch, E, k, error, match):
    """On a CUDA tensor the wrapper goes to the kernel and nowhere else:
    with no card and no nvcc that is an error, never the plain path."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without a card")

    def no_fallback(*a, **kw):
        raise AssertionError("fell back to the plain version")
    monkeypatch.setattr(dt, "dense_topk_torch", no_fallback)
    before = dt.dense_topk.launches
    with FakeTensorMode():
        q = torch.empty((4, E), dtype=torch.float32, device="cuda")
        d = torch.empty((100, E), dtype=torch.float32, device="cuda")
        with pytest.raises(error, match=match):
            dt.dense_topk(q, d, k=k)
    assert dt.dense_topk.launches == before


# ---------------------------------------------------------------------------
# The kernel's products, emulated: three TF32 products per float32 product
# ---------------------------------------------------------------------------


def _tf32(x):
    """x with the low 13 mantissa bits cleared (the kernel's ``tf32_hi``)."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _toward_zero(x64):
    """float64 to float32, rounded toward zero."""
    r = x64.float()
    over = r.double().abs() > x64.abs()
    return torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)


def _kernel_scores(q, d, products=("lo_hi", "hi_lo", "hi_hi")):
    """(Q, D) scores as the kernel forms them: every operand split into
    hi = tf32(x) and lo = tf32(x - hi); each 32-column chunk summed in a
    fresh accumulator over its 8-column steps, each step adding the
    products smallest first, every product of a step exact and added to
    the accumulator rounded toward zero to float32 (the tensor core); the
    chunk then added to the running float32 sum."""
    parts = {}
    for name, x in (("q", q), ("d", d)):
        hi = _tf32(x)
        parts[name] = {"hi": hi, "lo": _tf32(x - hi)}
    run = None
    for c0 in range(0, q.shape[1], 32):
        acc = torch.zeros(q.shape[0], d.shape[0], dtype=torch.float32)
        for k0 in range(c0, min(c0 + 32, q.shape[1]), 8):
            for prod in products:
                a, b = prod.split("_")
                step = (parts["q"][a][:, k0:k0 + 8].double()
                        @ parts["d"][b][:, k0:k0 + 8].double().T)
                acc = _toward_zero(acc.double() + step)
        run = acc if run is None else run + acc
    return run


def _rows(kind, n, E, rng):
    x = (rng.uniform(-1.0, 1.0, (n, E)) if kind == "uniform"
         else rng.standard_normal((n, E)))
    return torch.from_numpy((x / np.linalg.norm(x, axis=1,
                                                keepdims=True)).astype(
        np.float32))


@pytest.mark.parametrize("E", [256, 768])
@pytest.mark.parametrize("kind", ["uniform", "normal"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kernel_products_hold_the_tolerance(E, kind, seed):
    """On unit rows the emulated kernel scores are within 1e-5 of float64
    (by a wide margin), and equal doc rows get bitwise-equal scores
    wherever they sit; one TF32 product alone misses 1e-5 by far, which
    is why the kernel splits."""
    rng = np.random.default_rng(seed)
    q, d = _rows(kind, 16, E, rng), _rows(kind, 96, E, rng)
    d[70] = d[3]                       # a duplicate in another tile half
    want = q.double() @ d.double().T
    got = _kernel_scores(q, d)
    assert (got.double() - want).abs().max().item() < TOL / 10
    assert torch.equal(got[:, 70], got[:, 3])
    one = _kernel_scores(q, d, products=("hi_hi",))
    assert (one.double() - want).abs().max().item() > TOL
