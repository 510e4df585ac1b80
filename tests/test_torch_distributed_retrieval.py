"""The port's distributed retrieval on spawned gloo worlds
(``tests/torch_dist.py``) against the reference's on a forced 8-device
host mesh (a subprocess, as ``tests/test_distributed_retrieval.py`` runs
it).

At dp = 2 and 4: ``distributed_bm25_topk`` and ``distributed_dense_topk``
over the whole corpus, and ``DistributedBM25`` / ``DistributedDenseIndex``
over their shards, give the reference's ids exactly and its scores within
``SCORE_RTOL``.  The corpus duplicates documents across every shard
boundary of both layouts, and some queries are those documents' own
text, so exact ties straddle shards: they must resolve to the lower
global id, as ``lax.top_k`` does.
"""
import torch_threads  # noqa: F401  (caps torch's threads under xdist)
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import torch_dist as W
from repro_torch.core.config import RetrievalConfig
from repro_torch.data import SyntheticSquad
from repro_torch.retrieval import BM25Index, DenseIndex

SCORE_RTOL = 1e-5  # float32: the same sums, in another order (BM25 sums
#                    a term at a time here, a matrix product there)
K = 10
DPS = (2, 4)
# rows copied over their neighbours: each run of equal rows crosses the
# shard boundaries at 64, 128 and 192 of the 256 documents
DUPLICATED = {62: (63, 64, 65), 126: (127, 128, 129), 191: (192,)}

SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.retrieval.distributed import (DistributedBM25,
    DistributedDenseIndex, distributed_bm25_topk, distributed_dense_topk)

d = np.load(sys.argv[1])
out = {}
for dp in (2, 4):
    mesh = Mesh(np.array(jax.devices()[:dp]).reshape(dp, 1),
                ("data", "model"))
    qv = jnp.asarray(d["qtf"] * d["idf"][None, :])
    with mesh:
        s, i = distributed_bm25_topk(mesh, jnp.asarray(d["tf"]),
                                     jnp.asarray(d["doc_len"]), qv, k=%d)
        out[f"bm25_{dp}"] = (np.asarray(i), np.asarray(s))
        s, i = distributed_dense_topk(mesh, jnp.asarray(d["emb"]),
                                      jnp.asarray(d["qe"]), k=%d)
        out[f"dense_{dp}"] = (np.asarray(i), np.asarray(s))
    out[f"bm25_class_{dp}"] = DistributedBM25(
        mesh, d["tf"], d["doc_len"], d["idf"]).topk(d["qtf"], k=%d)
    out[f"dense_class_{dp}"] = DistributedDenseIndex(
        mesh, d["emb"]).topk(d["qe"], k=%d)
np.savez(sys.argv[2], **{f"{k}_{j}": v[j] for k, v in out.items()
                         for j in (0, 1)})
print("REF-DIST-OK")
""" % (K, K, K, K)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    data = SyntheticSquad(n_paragraphs=256, n_questions=12, seed=3)
    texts = [p.text for p in data.paragraphs]
    for src, dsts in DUPLICATED.items():
        for d in dsts:
            texts[d] = texts[src]
    bm25 = BM25Index.build(texts, RetrievalConfig(vocab_hash_dim=1024))
    dense = DenseIndex.build(texts)
    queries = [q.text for q in data.questions] + [texts[s]
                                                  for s in DUPLICATED]
    arrays = dict(
        tf=bm25.tf.astype(np.float32),
        doc_len=bm25.doc_len.astype(np.float32),
        idf=bm25.idf.astype(np.float32),
        qtf=np.stack([bm25.query_vector(q) for q in queries]),
        emb=dense.emb, qe=np.stack([dense.encode(q) for q in queries]))
    tmp = tmp_path_factory.mktemp("dist_retrieval")
    np.savez(tmp / "in.npz", **arrays)
    root = Path(__file__).resolve().parents[1]
    env = {"PYTHONPATH": str(root / "src"), "PATH": "/usr/bin:/bin",
           "HOME": str(tmp), "JAX_PLATFORMS": "cpu"}
    run = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp / "in.npz"),
                          str(tmp / "ref.npz")], env=env,
                         capture_output=True, text=True, timeout=300)
    assert "REF-DIST-OK" in run.stdout, run.stderr[-2000:]
    ref = dict(np.load(tmp / "ref.npz"))
    port = {dp: W.run_world(W.retrieval, dp, tmp, f"dp={dp}",
                            arrays["tf"], arrays["doc_len"], arrays["idf"],
                            arrays["qtf"], arrays["emb"], arrays["qe"], K)
            for dp in DPS}
    return arrays, ref, port


@pytest.mark.parametrize("what", ["bm25", "dense", "bm25_class",
                                  "dense_class"])
@pytest.mark.parametrize("dp", DPS)
def test_ids_and_scores_match_the_reference(corpus, dp, what):
    _, ref, port = corpus
    want_i, want_s = ref[f"{what}_{dp}_0"], ref[f"{what}_{dp}_1"]
    for rank in port[dp]:
        got_i, got_s = rank[what]
        assert np.array_equal(got_i, want_i)
        np.testing.assert_allclose(got_s, want_s, rtol=SCORE_RTOL, atol=0)


@pytest.mark.parametrize("dp", DPS)
def test_ties_across_shards_go_to_the_lower_id(corpus, dp):
    """A duplicated document's own text ranks every copy at one score:
    the copies come back in ascending global id, across the shards."""
    arrays, _, port = corpus
    n_q = len(arrays["qe"]) - len(DUPLICATED)
    for rank in port[dp]:
        for what in ("bm25", "dense", "bm25_class", "dense_class"):
            ids, scores = rank[what]
            for j, (src, dsts) in enumerate(DUPLICATED.items()):
                copies = (src,) + dsts
                row = list(ids[n_q + j])
                at = [row.index(c) for c in copies]
                assert at == sorted(at) and at == list(
                    range(at[0], at[0] + len(copies))), (what, row)
                assert len(set(scores[n_q + j][at])) == 1


def test_uneven_shards_are_refused():
    """The reference's ``D % n_axis == 0`` check."""
    from types import SimpleNamespace

    from repro_torch.retrieval.distributed import _shard
    mesh = SimpleNamespace(axis_names=("data", "model"),
                           devices=np.empty((4, 1), object),
                           coord=lambda axis: 0)
    assert _shard(mesh, "data", 256) == (0, 64)
    with pytest.raises(ValueError, match="do not split evenly"):
        _shard(mesh, "data", 254)
