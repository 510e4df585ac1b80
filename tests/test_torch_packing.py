"""The port's sequence packing (``repro_torch.data.packing``) against the
reference's on the inputs of ``tests/test_substrate.py``'s two packing
tests: every batch's rows, labels, segments and occupancy identical, and
the reference test's own checks (no label across a document boundary,
labels the next token where unmasked) on the port's batches."""
import torch_threads  # noqa: F401  (caps torch's threads under xdist)
import numpy as np
import pytest

from repro.data.packing import pack_documents as ref_pack
from repro_torch.data.packing import pack_documents


def _docs(seed, n, hi):
    rng = np.random.default_rng(seed)
    return [list(rng.integers(10, 90, size=rng.integers(5, hi)))
            for _ in range(n)]


@pytest.mark.parametrize("seed,n,hi", [(0, 200, 60), (1, 100, 40)],
                         ids=["occupancy_and_masks", "vs_padding"])
def test_pack_documents_matches_reference(seed, n, hi):
    docs = _docs(seed, n, hi)
    want = list(ref_pack(docs, seq_len=64, batch_size=4))
    got = list(pack_documents(docs, seq_len=64, batch_size=4))
    assert got and len(got) == len(want)
    for g, w in zip(got, want):
        for f in ("tokens", "labels", "segments"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f), f)
            assert getattr(g, f).dtype == np.int32
        assert g.occupancy == w.occupancy
        cross = (g.segments[:, :-1] != g.segments[:, 1:]) & \
            (g.labels[:, :-1] != -1)
        assert not cross.any()
        m = g.labels[:, :-1] != -1
        np.testing.assert_array_equal(g.labels[:, :-1][m], g.tokens[:, 1:][m])
