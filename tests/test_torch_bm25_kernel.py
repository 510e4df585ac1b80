"""BM25 scoring (K5) in the port against the reference.

The port's wrapper on CPU tensors runs its plain version
(``bm25_scores_torch``), for a dense ``tf`` and for its nonzeros (a
``BM25Csr`` from ``compact_tf``); both are held against the reference's
``ops.bm25_scores`` (the Pallas kernel in interpret mode, as
``tests/test_kernels.py`` runs it) on the same numpy inputs, and
against the port's numpy ``BM25Index.scores_np`` on a corpus.  The CUDA
kernel itself runs only on the card, where ``chip_smoke.py`` holds it
against the plain version.  Tolerance 1e-5: float32, the same sums in
another order.
"""
import torch_threads  # noqa: F401  (caps torch's threads under xdist)
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from repro.kernels import bm25_scores as ref_bm25_scores
from repro.kernels import ref
from repro_torch.core.config import RetrievalConfig
from repro_torch.data import SyntheticSquad
from repro_torch.kernels import bm25 as k5
from repro_torch.retrieval import bm25 as bm25_mod
from repro_torch.retrieval.bm25 import BM25Index


def _inputs(Q, D, V, seed=0):
    rng = np.random.default_rng(seed)
    qtf = (rng.random((Q, V)) < 0.02).astype(np.float32)
    tf = np.round(rng.random((D, V)) * 4).astype(np.float32)
    return qtf, tf, tf.sum(1), (rng.random(V) + 0.1).astype(np.float32)


def _port(qtf, tf, dl, idf, csr=False, **kw):
    tf = torch.from_numpy(tf)
    if csr:
        tf = k5.compact_tf(tf)
    out = k5.bm25_scores(torch.from_numpy(qtf), tf, torch.from_numpy(dl),
                         torch.from_numpy(idf), **kw)
    assert out.dtype == torch.float32
    return out.numpy()


@pytest.mark.parametrize("Q,D,V", [(8, 128, 512), (16, 256, 1024),
                                   (8, 64, 512), (1, 128, 512),
                                   (3, 100, 300)])   # ragged Q, D and V
def test_plain_version_matches_pallas_and_oracle(Q, D, V):
    _hold_against_pallas_and_oracle(*_inputs(Q, D, V), csr=False)


def _hold_against_pallas_and_oracle(qtf, tf, dl, idf, csr):
    got = _port(qtf, tf, dl, idf, csr)
    pallas = ref_bm25_scores(jnp.asarray(qtf), jnp.asarray(tf),
                             jnp.asarray(dl), jnp.asarray(idf))
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=1e-5,
                               atol=1e-5)
    k1, b = 1.2, 0.75
    norm = (k1 * (1 - b + b * dl / (dl.mean() + 1e-6)))[:, None]
    want = ref.bm25_ref(jnp.asarray(qtf * idf[None]), jnp.asarray(tf),
                        jnp.asarray(norm))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k1,b", [(0.9, 0.4), (2.0, 1.0)])
def test_bm25_parameters_reach_the_prep(k1, b):
    _hold_parameters(k1, b, csr=False)


def _hold_parameters(k1, b, csr):
    qtf, tf, dl, idf = _inputs(4, 64, 256, seed=3)
    got = _port(qtf, tf, dl, idf, csr, k1=k1, b=b)
    want = ref_bm25_scores(jnp.asarray(qtf), jnp.asarray(tf),
                           jnp.asarray(dl), jnp.asarray(idf), k1=k1, b=b)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("Q,D,V", [(8, 128, 512), (16, 256, 1024),
                                   (8, 64, 512), (1, 128, 512),
                                   (3, 100, 300)])
def test_csr_plain_version_matches_pallas_and_oracle(Q, D, V):
    """The plain version on the nonzeros of tf (saturation per nonzero,
    ``index_add_`` per document) == the reference on the dense matrix."""
    _hold_against_pallas_and_oracle(*_inputs(Q, D, V), csr=True)


def test_csr_plain_version_empty_documents_and_zero_queries():
    qtf, tf, dl, idf = _inputs(6, 96, 256, seed=4)
    tf[[0, 5, 95]] = 0          # documents with no term (first and last)
    tf[40:48] = 0
    dl = tf.sum(1)
    qtf[[1, 4]] = 0             # queries with no term
    _hold_against_pallas_and_oracle(qtf, tf, dl, idf, csr=True)
    got = _port(qtf, tf, dl, idf, csr=True)
    assert not got[[1, 4]].any() and not got[:, [0, 5, 95]].any()


@pytest.mark.parametrize("Q,D,V", [(3, 5, 0), (0, 5, 7), (3, 0, 7)])
def test_csr_plain_version_empty_axes(Q, D, V):
    """V = 0 scores 0; Q = 0 or D = 0 give an empty result; the dense and
    the CSR forms agree with the reference's oracle."""
    qtf, tf, dl, idf = _inputs(Q, D, V)
    dl = dl + 1.0
    got = _port(qtf, tf, dl, idf, csr=True)
    assert got.shape == (Q, D) and not got.any()
    np.testing.assert_array_equal(got, _port(qtf, tf, dl, idf))
    with np.errstate(invalid="ignore"):    # D = 0: the mean of nothing
        norm = (1.2 * (1 - 0.75 + 0.75 * dl / (dl.mean() + 1e-6)))[:, None]
    want = ref.bm25_ref(jnp.asarray(qtf * idf[None]), jnp.asarray(tf),
                        jnp.asarray(norm))
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("k1,b", [(0.9, 0.4), (2.0, 1.0)])
def test_csr_bm25_parameters_reach_the_prep(k1, b):
    _hold_parameters(k1, b, csr=True)


@pytest.mark.parametrize("D,V", [(50, 97), (1, 1), (0, 4), (4, 0)])
def test_compact_tf_round_trips_with_ascending_cols(D, V):
    rng = np.random.default_rng(D + V)
    tf = np.round(rng.random((D, V)) * 3 - 1.5).clip(0).astype(np.float32)
    if D > 2:
        tf[D // 2] = 0
    csr = k5.compact_tf(torch.from_numpy(tf))
    assert (csr.row_ptr.dtype, csr.cols.dtype, csr.vals.dtype) == (
        torch.int32, torch.int32, torch.float32)
    assert csr.shape == (D, V) and csr.row_ptr.shape == (D + 1,)
    assert csr.row_ptr[0] == 0 and csr.row_ptr[-1] == (tf != 0).sum()
    dense = np.zeros((D, V), np.float32)
    ptr, cols = csr.row_ptr.numpy(), csr.cols.numpy()
    for d in range(D):
        row = cols[ptr[d]:ptr[d + 1]]
        assert (np.diff(row) > 0).all()
        dense[d, row] = csr.vals.numpy()[ptr[d]:ptr[d + 1]]
    np.testing.assert_array_equal(dense, tf)
    assert (csr.vals.numpy() != 0).all()


class _ScalarReads(TorchDispatchMode):
    """Records every device-to-host scalar read, including the ones
    PyTorch makes inside its own C++: each is an
    ``aten._local_scalar_dense`` call."""

    def __init__(self):
        super().__init__()
        self.reads = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.reads += func is torch.ops.aten._local_scalar_dense.default
        return func(*args, **(kwargs or {}))


def test_csr_scoring_reads_nothing_back_to_the_host():
    """With a BM25Csr the kernel's prep and the plain version are tensor
    ops only: on the card the wrapper never syncs.  (The control: the
    mode does see a read of the index's size.)"""
    qtf, tf, dl, idf = (torch.from_numpy(a) for a in _inputs(4, 64, 256))
    csr = k5.compact_tf(tf)
    with _ScalarReads() as mode:
        wqT, used, norm = k5._kernel_prep(qtf, dl, idf, 1.2, 0.75)
        k5.bm25_scores_torch(qtf, csr, dl, idf)
    assert mode.reads == 0
    assert wqT.shape == (256, 4) and wqT.is_contiguous()
    assert torch.equal(wqT, (qtf * idf).T)
    assert used.element_size() == 1
    assert torch.equal(used.bool(), (qtf * idf != 0).any(0))
    with _ScalarReads() as mode:
        int(csr.row_ptr[-1])
    assert mode.reads == 1


def _count_uploads(monkeypatch, onto=None):
    """Records the device of every ``Tensor.to(device)`` call (casts to
    a dtype pass through); ``onto`` stands in for the device the copy
    lands on."""
    moves, to = [], torch.Tensor.to

    def counting(self, *args, **kw):
        dev = args[0] if args else kw.get("device")
        if not isinstance(dev, (str, torch.device)):
            return to(self, *args, **kw)
        moves.append(torch.device(dev))
        return to(self, onto) if onto is not None else to(self, *args, **kw)
    monkeypatch.setattr(torch.Tensor, "to", counting)
    return moves


def _small_index(seed=5):
    data = SyntheticSquad(n_paragraphs=32, n_questions=2, seed=seed)
    idx = BM25Index.build([p.text for p in data.paragraphs],
                          RetrievalConfig(vocab_hash_dim=256))
    qv = torch.from_numpy(np.stack([idx.query_vector(q.text)
                                    for q in data.questions]))
    return idx, qv


def test_device_csr_is_built_once_per_device(monkeypatch):
    """One compaction, and one upload of the index (row_ptr, cols, vals,
    doc_len and idf), however often the device is asked for."""
    calls = []

    def counting(tf):
        calls.append(tf.shape)
        return k5.compact_tf(tf)
    monkeypatch.setattr(bm25_mod, "compact_tf", counting)
    idx, qv = _small_index()
    moves = _count_uploads(monkeypatch)
    csr = idx.device_csr("cpu")
    assert idx.device_csr(torch.device("cpu")) is csr
    idx.scores_batch(qv)
    idx.scores_batch(qv)
    assert calls == [(32, 256)]
    assert moves == [torch.device("cpu")] * 5
    assert csr.vals.numel() == (idx.tf != 0).sum() < idx.tf.size // 4


def test_device_csr_keys_one_card_once(monkeypatch):
    """``"cuda"``, ``"cuda:0"`` and a tensor's ``cuda:0`` name one card:
    the index goes there once.  (No card here: the copies stay on the
    host, and the current card is 0.)"""
    monkeypatch.setattr(bm25_mod, "resolve_device", torch.device)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    idx, _ = _small_index()
    moves = _count_uploads(monkeypatch, onto="cpu")
    csr = idx.device_csr("cuda")
    assert idx.device_csr("cuda:0") is csr
    assert idx.device_csr(torch.device("cuda", 0)) is csr
    assert moves == [torch.device("cuda", 0)] * 5
    idx.device_csr("cuda:1")
    assert moves[5:] == [torch.device("cuda:1")] * 5


def test_plain_version_matches_the_index_oracle():
    """The batched path == the port's BM25Index numpy scoring on a
    corpus (the tolerance of the reference's own test)."""
    data = SyntheticSquad(n_paragraphs=128, n_questions=8, seed=1)
    idx = BM25Index.build([p.text for p in data.paragraphs],
                          RetrievalConfig(vocab_hash_dim=1024))
    qv = np.stack([idx.query_vector(q.text) for q in data.questions])
    got = _port(qv, idx.tf, idx.doc_len, idx.idf)
    want = np.stack([idx.scores_np(v) for v in qv])
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_index_scores_batch_goes_through_the_wrapper(monkeypatch):
    """``BM25Index.scores_batch`` scores through ``bm25_scores`` (the
    plain version here, K5 on the card) with the index's k1 and b."""
    calls, forms = [], []

    def recording(*a, **kw):
        calls.append(kw)
        forms.append(type(a[1]))
        return k5.bm25_scores(*a, **kw)
    monkeypatch.setattr(bm25_mod, "bm25_scores", recording)
    cfg = RetrievalConfig(vocab_hash_dim=512, k1=1.5, b=0.6)
    data = SyntheticSquad(n_paragraphs=64, n_questions=4, seed=2)
    idx = BM25Index.build([p.text for p in data.paragraphs], cfg)
    qv = np.stack([idx.query_vector(q.text) for q in data.questions])
    got = idx.scores_batch(torch.from_numpy(qv)).numpy()
    assert calls == [{"k1": 1.5, "b": 0.6}]
    assert forms == [k5.BM25Csr]     # the index's nonzeros, not dense tf
    want = np.stack([idx.scores_np(v) for v in qv])
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_cpu_tensors_take_the_plain_path(monkeypatch):
    def no_kernel(*a):
        raise AssertionError("the CUDA kernel was reached from CPU tensors")
    monkeypatch.setattr(k5, "_launch", no_kernel)
    before = k5.bm25_scores.launches
    _port(*_inputs(2, 16, 64))
    assert k5.bm25_scores.launches == before


@pytest.mark.parametrize("V_idf,error,match", [
    (64, RuntimeError, "nvcc"),     # passes the checks, cannot build
    (63, ValueError, "want"),       # idf does not match tf's vocab
])
def test_cuda_request_launches_or_raises_never_falls_back(
        monkeypatch, V_idf, error, match):
    """On a CUDA tensor the wrapper goes to the kernel and nowhere else:
    with no card and no nvcc that is an error, never the plain path."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without a card")

    def no_fallback(*a, **kw):
        raise AssertionError("fell back to the plain version")
    monkeypatch.setattr(k5, "bm25_scores_torch", no_fallback)
    before = k5.bm25_scores.launches
    with FakeTensorMode():
        qtf = torch.empty((4, 64), dtype=torch.float32, device="cuda")
        tf = torch.empty((100, 64), dtype=torch.float32, device="cuda")
        dl = torch.empty((100,), dtype=torch.float32, device="cuda")
        idf = torch.empty((V_idf,), dtype=torch.float32, device="cuda")
        with pytest.raises(error, match=match):
            k5.bm25_scores(qtf, tf, dl, idf)
    assert k5.bm25_scores.launches == before


@pytest.mark.parametrize("vals_dtype,error,match", [
    (torch.float32, RuntimeError, "nvcc"),    # passes the checks
    (torch.float64, ValueError, "BM25Csr"),   # vals must be float32
])
def test_cuda_csr_request_launches_or_raises_never_falls_back(
        monkeypatch, vals_dtype, error, match):
    """A BM25Csr on the card goes to the kernel and nowhere else."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without a card")

    def no_fallback(*a, **kw):
        raise AssertionError("fell back to the plain version")
    monkeypatch.setattr(k5, "bm25_scores_torch", no_fallback)
    before = k5.bm25_scores.launches
    with FakeTensorMode():
        def cuda(shape, dtype=torch.float32):
            return torch.empty(shape, dtype=dtype, device="cuda")
        csr = k5.BM25Csr(cuda((101,), torch.int32), cuda((300,), torch.int32),
                         cuda((300,), vals_dtype), (100, 64))
        with pytest.raises(error, match=match):
            k5.bm25_scores(cuda((4, 64)), csr, cuda((100,)), cuda((64,)))
    assert k5.bm25_scores.launches == before
