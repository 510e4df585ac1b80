"""BM25 scoring (K5) in the port against the reference.

The port's wrapper on CPU tensors runs its plain version
(``bm25_scores_torch``); it is held against the reference's
``ops.bm25_scores`` (the Pallas kernel in interpret mode, as
``tests/test_kernels.py`` runs it) on the same numpy inputs, and
against the port's numpy ``BM25Index.scores_np`` on a corpus.  The CUDA
kernel itself runs only on the card, where ``chip_smoke.py`` holds it
against the plain version.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

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


def _port(*arrays, **kw):
    out = k5.bm25_scores(*(torch.from_numpy(a) for a in arrays), **kw)
    assert out.dtype == torch.float32
    return out.numpy()


@pytest.mark.parametrize("Q,D,V", [(8, 128, 512), (16, 256, 1024),
                                   (8, 64, 512), (1, 128, 512),
                                   (3, 100, 300)])   # ragged Q, D and V
def test_plain_version_matches_pallas_and_oracle(Q, D, V):
    qtf, tf, dl, idf = _inputs(Q, D, V)
    got = _port(qtf, tf, dl, idf)
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
    qtf, tf, dl, idf = _inputs(4, 64, 256, seed=3)
    got = _port(qtf, tf, dl, idf, k1=k1, b=b)
    want = ref_bm25_scores(jnp.asarray(qtf), jnp.asarray(tf),
                           jnp.asarray(dl), jnp.asarray(idf), k1=k1, b=b)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


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
    calls = []

    def recording(*a, **kw):
        calls.append(kw)
        return k5.bm25_scores(*a, **kw)
    monkeypatch.setattr(bm25_mod, "bm25_scores", recording)
    cfg = RetrievalConfig(vocab_hash_dim=512, k1=1.5, b=0.6)
    data = SyntheticSquad(n_paragraphs=64, n_questions=4, seed=2)
    idx = BM25Index.build([p.text for p in data.paragraphs], cfg)
    qv = np.stack([idx.query_vector(q.text) for q in data.questions])
    got = idx.scores_batch(torch.from_numpy(qv)).numpy()
    assert calls == [{"k1": 1.5, "b": 0.6}]
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
