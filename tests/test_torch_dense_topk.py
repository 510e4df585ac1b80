"""Fused dense top-k (K3) in the port against the reference.

The port's wrapper on CPU tensors runs its plain version
(``dense_topk_torch``); it is held against the reference's
``ops.dense_topk`` (the Pallas kernel in interpret mode, as
``tests/test_dense_retrieval.py`` runs it) and its
``ref.dense_topk_ref`` oracle on the same numpy inputs: ids identical,
ties included, and scores within 1e-5 (the float32 sums run in another
order).  The CUDA kernel itself runs only on the card, where
``chip_smoke.py`` holds it against the plain version.
"""
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
    (1 << 20, 64, 132), (1 << 20, 200, 132), (5000, 1000, 8)])
def test_splits_cover_the_doc_axis_exactly(n_docs, n_queries, n_sms):
    """The kernel's split of the doc axis: every 64-doc tile in exactly
    one split, no split empty, about two blocks per SM."""
    per, S = dt.splits(n_docs, n_queries, n_sms)
    n_tiles = -(-n_docs // dt.TILE)
    assert per >= 1 and (S - 1) * per < n_tiles <= S * per
    q_tiles = -(-n_queries // dt.TILE)
    assert S <= max(1, dt.BLOCKS_PER_SM * n_sms // q_tiles)


def test_cpu_tensors_take_the_plain_path(monkeypatch):
    def no_kernel(*a):
        raise AssertionError("the CUDA kernel was reached from CPU tensors")
    monkeypatch.setattr(dt, "_launch", no_kernel)
    before = dt.dense_topk.launches
    _port(*_inputs(4, 64, 32), 5)
    assert dt.dense_topk.launches == before


@pytest.mark.parametrize("E,k,error,match", [
    (256, 10, RuntimeError, "nvcc"),   # passes the checks, cannot build
    (256, 33, ValueError, "k=33"),     # one warp holds the top-k
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
