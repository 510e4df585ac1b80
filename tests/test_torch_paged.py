"""The port's paged KV cache against the reference, on qwen SMOKE float32.

* K2's plain version (``paged_flash_decode_torch``) against the
  reference's ``ref.paged_flash_decode_ref`` oracle and its
  ``ops.paged_flash_decode`` (the Pallas kernel in interpret mode, as
  ``tests/test_flash_decode.py`` runs it), and the wrapper's routing:
  CPU tensors take the plain version, CUDA tensors launch or raise.
  The kernel's split of long slots, emulated (per-partition softmax
  states merged in partition order), against the plain version; its
  partition count and launch arguments depend on shapes only.
* The model: a suffix prefill from ``pos0`` and a paged decode step
  give the reference's logits and pools.
* The engine: the port's paged engine is token-identical to the
  reference's paged engine and to the port's dense engine, with equal
  paged ``EngineStats``, through prefix hits, copy-on-write forks and
  pool exhaustion; a shared prefix page is never written by the slots
  that borrow it; ``Gateway.serve`` over a paged backend matches.
* The host allocator: the port's ``PagePool`` copy makes the
  reference's plans for any sequence of plan / commit / release.

The CUDA kernel itself runs only on the card, where ``chip_smoke.py``
holds it against the plain version.
"""
import torch_threads  # noqa: F401  (caps torch's threads under xdist)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as ref_config
from repro.kernels import paged_flash_decode as ref_paged_flash_decode
from repro.kernels import ref
from repro.models import build_model as ref_build
from repro.serving.continuous import ContinuousEngine as RefEngine
from repro.serving.paged import PagePool as RefPagePool
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import paged_flash_decode as pfd
from repro_torch.models import build_model
from repro_torch.models.schema import tree_leaves
from repro_torch.serving.continuous import ContinuousEngine
from repro_torch.serving.executor import SingleDeviceExecutor
from repro_torch.serving.paged import PagePool

# float32 throughout; the sums run in another order in each version
KERNEL_TOL = 1e-5
LOGIT_TOL = 1e-4
STATS = ("n_prefills", "prefill_tokens_avoided", "prompt_tokens_total",
         "n_cow_forks", "n_deferred_admissions", "n_pages_evicted")


# ---------------------------------------------------------------------------
# K2: the plain version and the wrapper
# ---------------------------------------------------------------------------


def _kernel_inputs(B, MB, ps, H, Hkv, D, seed=0):
    """Pools, a shuffled table and lengths 1, full and parked (one past
    the table, as an idle slot is); entries past each slot's length are
    stale page ids."""
    rng = np.random.default_rng(seed)
    NP = B * MB + 3
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kp = rng.standard_normal((NP, ps, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((NP, ps, Hkv, D)).astype(np.float32)
    table = rng.permutation(NP)[:B * MB].reshape(B, MB).astype(np.int32)
    lens = rng.integers(1, MB * ps, size=B).astype(np.int32)
    lens[:3] = 1, MB * ps, MB * ps + 1
    for b in range(B):
        used = -(-min(int(lens[b]), MB * ps) // ps)
        table[b, used:] = rng.integers(0, NP, size=MB - used)
    return q, kp, vp, table, lens


def _port_k2(q, kp, vp, table, lens):
    return pfd.paged_flash_decode(*(torch.from_numpy(a) for a in
                                    (q, kp, vp, table, lens))).numpy()


@pytest.mark.parametrize("ps", [8, 16])
@pytest.mark.parametrize("G", [1, 2])
def test_plain_version_matches_pallas_and_oracle(G, ps):
    Hkv = 2
    q, kp, vp, table, lens = _kernel_inputs(5, 4, ps, G * Hkv, Hkv, 64)
    got = _port_k2(q, kp, vp, table, lens)
    args = [jnp.asarray(a) for a in (q, kp, vp, table, lens)]
    pallas = np.asarray(ref_paged_flash_decode(*args))
    np.testing.assert_allclose(got, pallas, rtol=KERNEL_TOL, atol=KERNEL_TOL)
    np.testing.assert_allclose(got, np.asarray(ref.paged_flash_decode_ref(
        *args)), rtol=KERNEL_TOL, atol=KERNEL_TOL)


@pytest.mark.parametrize("G", [1, 2])
def test_plain_version_matches_pallas_and_oracle_at_head_dim_256(G):
    """gemma3-12b's head_dim 256 (its G = 2), page size 8."""
    _check_plain_version(G, 256)


@pytest.mark.parametrize("G", [1, 2])
def test_plain_version_matches_pallas_and_oracle_at_head_dim_96(G):
    """phi-3-vision's head_dim 96 (its G = 1), page size 8."""
    _check_plain_version(G, 96)


def _check_plain_version(G, D):
    Hkv = 2
    q, kp, vp, table, lens = _kernel_inputs(4, 5, 8, G * Hkv, Hkv, D,
                                            seed=G)
    got = _port_k2(q, kp, vp, table, lens)
    args = [jnp.asarray(a) for a in (q, kp, vp, table, lens)]
    pallas = np.asarray(ref_paged_flash_decode(*args))
    np.testing.assert_allclose(got, pallas, rtol=KERNEL_TOL, atol=KERNEL_TOL)
    np.testing.assert_allclose(got, np.asarray(ref.paged_flash_decode_ref(
        *args)), rtol=KERNEL_TOL, atol=KERNEL_TOL)


def test_stale_entries_and_unread_pages_change_nothing():
    """Only the pages a slot's length reaches are read: rewriting every
    other page, and out-of-range stale ids past the length (clamped into
    the pool), leave the output bit for bit; a parked length reads
    exactly the whole table."""
    q, kp, vp, table, lens = _kernel_inputs(4, 4, 8, 4, 2, 64, seed=3)
    base = _port_k2(q, kp, vp, table, lens)
    kp2, vp2, table2 = kp.copy(), vp.copy(), table.copy()
    read = set()
    for b in range(4):
        used = -(-min(int(lens[b]), 32) // 8)
        read |= set(table[b, :used].tolist())
        table2[b, used:] = 10_000 + b
    unread = sorted(set(range(len(kp))) - read)
    kp2[unread], vp2[unread] = 1e4, -1e4
    np.testing.assert_array_equal(_port_k2(q, kp2, vp2, table2, lens), base)
    parked = lens.copy()
    parked[0] = 32 + 1
    full = lens.copy()
    full[0] = 32
    np.testing.assert_array_equal(_port_k2(q, kp, vp, table, parked),
                                  _port_k2(q, kp, vp, table, full))


def test_cpu_tensors_take_the_plain_path(monkeypatch):
    def no_kernel(*a):
        raise AssertionError("the CUDA kernel was reached from CPU tensors")
    monkeypatch.setattr(pfd, "_launch", no_kernel)
    before = pfd.paged_flash_decode.launches
    _port_k2(*_kernel_inputs(3, 3, 8, 4, 4, 64))
    assert pfd.paged_flash_decode.launches == before


def _fake_cuda(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="cuda")


@pytest.mark.parametrize("dtype,head_dim,table_dtype,error,match", [
    # passes the checks, then cannot build the kernel here
    (torch.bfloat16, 128, torch.int32, RuntimeError, "nvcc"),
    (torch.float32, 128, torch.int32, TypeError, "bfloat16"),   # bf16 only
    (torch.bfloat16, 96, torch.int32, RuntimeError, "nvcc"),    # phi-3
    (torch.bfloat16, 128, torch.int64, ValueError, "int32"),    # i32 table
    (torch.bfloat16, 256, torch.int32, RuntimeError, "nvcc"),   # gemma3
    (torch.bfloat16, 80, torch.int32, ValueError, "head_dim"),  # none
])
def test_cuda_request_launches_or_raises_never_falls_back(
        monkeypatch, dtype, head_dim, table_dtype, error, match):
    """On a CUDA tensor the wrapper goes to the kernel and nowhere else:
    with no card and no nvcc that is an error, never the plain path."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without a card")

    def no_fallback(*a):
        raise AssertionError("fell back to the plain version")
    monkeypatch.setattr(pfd, "paged_flash_decode_torch", no_fallback)
    before = pfd.paged_flash_decode.launches
    with FakeTensorMode():
        q = _fake_cuda((2, 4, head_dim), dtype)
        pages = _fake_cuda((6, 8, 4, head_dim), dtype)
        table = torch.zeros(2, 3, dtype=table_dtype, device="cuda")
        lens = torch.ones(2, dtype=torch.int32, device="cuda")
        with pytest.raises(error, match=match):
            pfd.paged_flash_decode(q, pages, pages, table, lens)
    assert pfd.paged_flash_decode.launches == before


def _partitioned_decode(q, kp, vp, table, lens, parts, part_pages):
    """K2's split in torch: each (slot, kv head) cut into ``parts`` runs
    of ``part_pages`` table entries; each run's softmax state (m, l, acc)
    over its rows below the clamped length -- an empty run gives m =
    -1e30, l = 0, acc = 0 -- merged in run order as the kernel's last
    block merges them."""
    B, H, D = q.shape
    NP, ps, Hkv = kp.shape[:3]
    MB = table.shape[1]
    G = H // Hkv
    n = lens.long().clamp(1, MB * ps)
    tab = table.long().clamp(0, NP - 1)
    k = kp[tab].reshape(B, MB * ps, Hkv, D).float()
    v = vp[tab].reshape(B, MB * ps, Hkv, D).float()
    qg = q.float().reshape(B, Hkv, G, D) / D ** 0.5
    out = torch.empty(B, Hkv, G, D)
    for b in range(B):
        for j in range(Hkv):
            ms, ls, accs = [], [], []
            for part in range(parts):
                lo = part * part_pages * ps
                hi = min(int(n[b]), min((part + 1) * part_pages, MB) * ps)
                if hi <= lo:
                    ms.append(torch.full((G,), pfd_NEG_INF))
                    ls.append(torch.zeros(G))
                    accs.append(torch.zeros(G, D))
                    continue
                s = qg[b, j] @ k[b, lo:hi, j].T
                m = s.max(-1).values
                e = torch.exp(s - m[:, None])
                ms.append(m)
                ls.append(e.sum(-1))
                accs.append(e @ v[b, lo:hi, j])
            m_all = torch.stack(ms)                      # (parts, G)
            c = torch.exp(m_all - m_all.max(0).values)
            den = (torch.stack(ls) * c).sum(0).clamp(min=1e-30)
            out[b, j] = (torch.stack(accs) * c[..., None]).sum(0) \
                / den[:, None]
    return out.reshape(B, H, D)


pfd_NEG_INF = -1e30


@pytest.mark.parametrize("MB,ps,parts", [
    (8, 8, 3),     # 3 + 3 + 2 pages
    (8, 8, 8),     # a page a run: most runs past the short slots
    (5, 16, 2),
    (50, 8, None),  # the main path's table, split as on a 132-SM card
])
@pytest.mark.parametrize("G", [1, 2])
def test_partition_merge_matches_the_plain_version(MB, ps, parts, G):
    """Per-run softmax states merged in run order give the plain
    version's output: with empty runs (a length-1 slot, short slots
    under many runs), a full slot and a parked one (length max_blocks *
    page_size + 1, clamped)."""
    Hkv = 2
    q, kp, vp, table, lens = (torch.from_numpy(a) for a in _kernel_inputs(
        5, MB, ps, G * Hkv, Hkv, 64, seed=MB + ps))
    if parts is None:
        parts, part_pages = pfd.partitions(MB, ps, 5, Hkv, 132)
    else:
        part_pages = -(-MB // parts)
    assert (parts - 1) * part_pages < MB <= parts * part_pages
    assert lens[0] == 1 and lens[2] == MB * ps + 1
    got = _partitioned_decode(q, kp, vp, table, lens, parts, part_pages)
    want = pfd.paged_flash_decode_torch(q, kp, vp, table, lens)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=KERNEL_TOL,
                               atol=KERNEL_TOL)


@pytest.mark.parametrize("MB,ps", [(50, 8), (256, 8)])
def test_partition_merge_matches_the_plain_version_at_head_dim_256(MB, ps):
    """gemma3-12b's head_dim 256 and G = 2 through the main path's
    50-block tables and a 2048-row one, split as on a 132-SM card."""
    _check_partition_merge(MB, ps, 2, 256)


def test_partition_merge_matches_the_plain_version_at_head_dim_96():
    """phi-3-vision's head_dim 96 and G = 1 through the main path's
    50-block tables, split as on a 132-SM card."""
    _check_partition_merge(50, 8, 1, 96)


def _check_partition_merge(MB, ps, G, D):
    Hkv = 2
    q, kp, vp, table, lens = (torch.from_numpy(a) for a in _kernel_inputs(
        4, MB, ps, G * Hkv, Hkv, D, seed=MB))
    parts, part_pages = pfd.partitions(MB, ps, 4, Hkv, 132)
    assert parts > 1
    got = _partitioned_decode(q, kp, vp, table, lens, parts, part_pages)
    want = pfd.paged_flash_decode_torch(q, kp, vp, table, lens)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=KERNEL_TOL,
                               atol=KERNEL_TOL)


def test_partition_count_depends_on_shapes_only():
    """The split is a function of the table's shape, the batch, the kv
    heads and the SM count -- ``lengths`` is not among its inputs, so
    choosing it never reads the card -- and its runs cover the table,
    none empty of entries, none shorter than MIN_PARTITION_ROWS rows
    unless the table is."""
    import inspect
    assert list(inspect.signature(pfd.partitions).parameters) == [
        "max_blocks", "page_size", "B", "Hkv", "num_sms"]
    for MB in (1, 4, 50, 256, 4096):
        for ps in (8, 16):
            for B, Hkv in ((1, 1), (8, 8), (8, 40), (64, 40)):
                parts, pages = pfd.partitions(MB, ps, B, Hkv, 132)
                assert 1 <= parts <= min(MB, pfd.MAX_PARTITIONS)
                assert (parts - 1) * pages < MB <= parts * pages
                assert (parts == 1 or pages * ps
                        >= pfd.MIN_PARTITION_ROWS * 0.5)
    assert pfd.partitions(50, 8, 8, 40, 132) == pfd.partitions(50, 8, 8, 40,
                                                               132)


class _Stream:
    cuda_stream = 0


@pytest.mark.parametrize("B,Hkv,MB", [(8, 40, 50), (3, 1, 64)])
def test_launch_arguments_depend_on_shapes_only(monkeypatch, B, Hkv, MB):
    """The wrapper's kernel arguments, through a stand-in kernel: the
    partition count and the scratch (tickets left at zero, partials
    sized B * H * parts * (D + 2)) are the same for any lengths -- a
    long slot among short ones, or all of length 1 -- none is read back
    to the host, and one launch is counted a call."""
    _check_launch_arguments(monkeypatch, B, Hkv, MB, 128)


@pytest.mark.parametrize("B,Hkv,MB", [(8, 8, 50), (8, 8, 256)])
def test_launch_arguments_at_head_dim_256(monkeypatch, B, Hkv, MB):
    """The same at gemma3-12b's head_dim 256 over its 8 kv heads."""
    _check_launch_arguments(monkeypatch, B, Hkv, MB, 256)


@pytest.mark.parametrize("B,Hkv,MB", [(8, 32, 50)])
def test_launch_arguments_at_head_dim_96(monkeypatch, B, Hkv, MB):
    """The same at phi-3-vision's head_dim 96 over its 32 kv heads."""
    _check_launch_arguments(monkeypatch, B, Hkv, MB, 96)


def _check_launch_arguments(monkeypatch, B, Hkv, MB, D):
    calls = []

    def fake_kernel(*args):
        calls.append(args)
        return 0
    monkeypatch.setattr(pfd, "_kernel", lambda: fake_kernel)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: _Stream())
    # the scratch and the SM count are flash_decode's, shared by K1 and K2
    monkeypatch.setattr(fd, "_num_sms", {torch.device("cpu"): 132})
    monkeypatch.setattr(fd, "_scratches", {})
    monkeypatch.setattr(pfd.paged_flash_decode, "launches", 0)
    G, ps = 2, 8
    q, kp, vp, table, lens = (torch.from_numpy(a) for a in _kernel_inputs(
        B, MB, ps, G * Hkv, Hkv, D))
    q, kp, vp = q.bfloat16(), kp.bfloat16(), vp.bfloat16()
    ones = torch.ones_like(lens)
    with _ScalarReads() as syncs:
        pfd._launch(q, kp, vp, table, lens)
        pfd._launch(q, kp, vp, table, ones)
    assert syncs.reads == 0 and pfd.paged_flash_decode.launches == 2
    a, b = calls
    # the same but for the lengths (and the output, allocated anew)
    assert a[:4] == b[:4] and a[6:] == b[6:] and a[4] != b[4]
    parts, part_pages = pfd.partitions(MB, ps, B, Hkv, 132)
    assert a[14:17] == (D, parts, part_pages)
    if parts == 1:
        assert a[6] is None and a[7] is None
    else:
        ((tickets, part),) = fd._scratches.values()
        assert a[6] == part.data_ptr() and a[7] == tickets.data_ptr()
        assert tickets.numel() == B * Hkv and not tickets.any()
        assert part.numel() == B * G * Hkv * parts * (D + 2)


# ---------------------------------------------------------------------------
# The model: suffix prefill from pos0, paged decode
# ---------------------------------------------------------------------------


def _models(**kw):
    rc = dataclasses.replace(ref_config("qwen1.5-32b", "smoke"),
                             dtype="float32", **kw)
    tc = dataclasses.replace(get_config("qwen1.5-32b", "smoke"),
                             dtype="float32", **kw)
    rm, tm = ref_build(rc), build_model(tc)
    np_params = jax.tree_util.tree_map(np.asarray,
                                       rm.init(jax.random.PRNGKey(0)))
    return (rm, jax.tree_util.tree_map(jnp.asarray, np_params), tm,
            params_from_numpy(np_params, device="cpu"))


@pytest.fixture(scope="module")
def models():
    return _models()


def _to_torch(tree):
    return jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)), tree)


def test_suffix_prefill_from_pos0_matches_reference(models):
    """Prefill [0, p0) into the scratch, then the suffix [p0, S) from
    ``pos0``: both steps' logits and the scratch rows match."""
    rm, rp, tm, tp = models
    toks = np.random.default_rng(0).integers(4, 512, size=(3, 13)).astype(
        np.int32)
    p0 = 5
    rcache, tcache = rm.init_cache(3, 24), tm.init_cache(3, 24, device="cpu")
    pos0 = np.full(3, p0, np.int32)
    for tk, extra in ((toks[:, :p0], {}), (toks[:, p0:], {"pos0": pos0})):
        rl, rcache = jax.jit(rm.prefill)(
            rp, {"tokens": jnp.asarray(tk),
                 **{k: jnp.asarray(v) for k, v in extra.items()}}, rcache)
        tl, tcache = tm.prefill(
            tp, {"tokens": torch.from_numpy(tk),
                 **{k: torch.from_numpy(v) for k, v in extra.items()}},
            tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(rl),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
    np.testing.assert_array_equal(tcache["pos"].numpy(), [13] * 3)
    for a, t in zip(jax.tree_util.tree_leaves(rcache["blocks"]),
                    tree_leaves(tcache["blocks"])):
        np.testing.assert_allclose(t[:, :, :13].numpy(),
                                   np.asarray(a)[:, :, :13],
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize("use_flash_decode", [False, True])
def test_paged_decode_step_matches_reference(models, use_flash_decode):
    """Three decode steps through a shuffled block table into filled
    pools: the reference's logits (its gather path, or its Pallas
    kernel in interpret mode) and pools; the parked slot's write is
    dropped and never lands in another slot's page."""
    rm, rp, tm, tp = models
    rm = ref_build(dataclasses.replace(rm.cfg,
                                       use_flash_decode=use_flash_decode))
    B, NP, ps, MB = 3, 16, 8, 5
    rng = np.random.default_rng(1)
    rcache = rm.init_paged_cache(B, NP, ps, MB)
    rcache = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape).astype(a.dtype))
        if a.dtype == jnp.float32 else a, rcache)
    table = rng.permutation(NP)[:B * MB].reshape(B, MB).astype(np.int32)
    # the parked slot's stale last entry names a page slot 1 writes into
    table[2, MB - 1] = table[1, 2]
    rcache["table"] = jnp.asarray(table)
    rcache["pos"] = jnp.asarray(np.array([4, 16, MB * ps], np.int32))
    tcache = _to_torch(rcache)
    for _ in range(3):
        tok = rng.integers(4, 512, size=(B, 1)).astype(np.int32)
        rl, rcache = jax.jit(rm.decode)(rp, {"tokens": jnp.asarray(tok)},
                                        rcache)
        tl, tcache = tm.decode(tp, {"tokens": torch.from_numpy(tok)}, tcache)
        # the parked slot's logits are an idle slot's, never read; the
        # reference's gather path reads one block fewer for it than its
        # kernel (and the port) do
        rows = slice(None) if use_flash_decode else slice(0, 2)
        np.testing.assert_allclose(tl.numpy()[rows], np.asarray(rl)[rows],
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
        # the engine holds the idle slot parked; hold it here too
        rcache["pos"] = rcache["pos"].at[2].set(MB * ps)
        tcache["pos"][2] = MB * ps
    for a, t in zip(jax.tree_util.tree_leaves(rcache["blocks"]),
                    tree_leaves(tcache["blocks"])):
        np.testing.assert_allclose(t.numpy(), np.asarray(a),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_paged_cache_schema_matches_reference(models):
    rm, _, tm, _ = models
    want = rm.paged_cache_schema(4, 20, 8, 6)
    got = tm.paged_cache_schema(4, 20, 8, 6)
    w = jax.tree_util.tree_leaves(
        want, is_leaf=lambda x: hasattr(x, "axes"))
    g = tree_leaves(got)
    assert [(s.shape, s.axes, s.dtype) for s in g] == \
        [(s.shape, s.axes, s.dtype) for s in w]


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


def _mixed_prompts(seed=0, vocab=512):
    """``tests/test_paged_engine.py::_mixed_prompts`` (mixed lengths;
    three prompts sharing a 16-token prefix) plus that 16-token prefix
    alone, page-aligned: served cache-hot, its suffix starts mid-page
    (p0 = 15), which takes a copy-on-write fork."""
    rng = np.random.default_rng(seed)
    mixed = [list(rng.integers(4, vocab, size=n)) for n in (10, 7, 10, 5)]
    base = list(rng.integers(4, vocab, size=16))
    shared = [base + list(rng.integers(4, vocab, size=4)) for _ in range(3)]
    return mixed + shared + [base]


KW = dict(num_slots=3, max_len=64, max_new_cap=16, sync_every=4)


def _tokens(gens):
    return [list(g.tokens) for g in gens]


@pytest.mark.parametrize("prefill_batch", [1, 3])
def test_paged_engine_matches_reference_and_dense(models, prefill_batch):
    """Two waves (the second cache-hot): the port's paged engine gives
    the reference paged engine's tokens and paged counters, and the
    port's dense engine's tokens."""
    rm, rp, tm, tp = models
    prompts = _mixed_prompts()
    kw = dict(KW, prefill_batch=prefill_batch)
    want = RefEngine(rm, rp, paged=True, page_size=8, **kw)
    got = ContinuousEngine(tm, tp, paged=True, page_size=8, **kw)
    dense = ContinuousEngine(tm, tp, **kw)
    for wave in range(2):
        a = want.generate_many(prompts, max_new_tokens=12)
        b = got.generate_many(prompts, max_new_tokens=12)
        c = dense.generate_many(prompts, max_new_tokens=12)
        assert _tokens(b) == _tokens(a), wave
        assert _tokens(b) == _tokens(c), wave
    for f in STATS + ("n_decode_steps", "max_concurrent"):
        assert getattr(got.stats, f) == getattr(want.stats, f), f
    assert got.stats.prefill_tokens_avoided > 0
    assert got.stats.n_cow_forks > 0
    assert got.stats.cache_allocations == 2


def test_pool_exhaustion_defers_and_recovers_like_reference(models):
    """A pool too small for two concurrent requests defers admissions
    and serves everything once decode frees pages, with the
    reference's deferral count and tokens."""
    rm, rp, tm, tp = models
    rng = np.random.default_rng(2)
    prompts = [list(rng.integers(4, 512, size=24)) for _ in range(3)]
    kw = dict(num_slots=2, max_len=64, max_new_cap=16, sync_every=4,
              prefill_batch=1, paged=True, page_size=8, num_pages=9,
              prefix_sharing=False)
    want = RefEngine(rm, rp, **kw)
    got = ContinuousEngine(tm, tp, **kw)
    a = want.generate_many(prompts, max_new_tokens=16)
    b = got.generate_many(prompts, max_new_tokens=16)
    assert _tokens(b) == _tokens(a)
    assert all(o.failed == "" and o.n_steps > 0 for o in b)
    assert got.stats.n_deferred_admissions > 0
    for f in STATS:
        assert getattr(got.stats, f) == getattr(want.stats, f), f


def test_shared_prefix_pages_unchanged_after_borrowers_decode(models):
    """Pages registered for prefix sharing hold the same bytes after a
    second wave of slots has borrowed them and decoded to the end."""
    _, _, tm, tp = models
    rng = np.random.default_rng(4)
    base = list(rng.integers(4, 512, size=16))
    prompts = [base + list(rng.integers(4, 512, size=5)) for _ in range(3)]
    eng = ContinuousEngine(tm, tp, paged=True, page_size=8,
                           **dict(KW, prefill_batch=1))
    first = eng.generate_many(prompts[:1], max_new_tokens=10)
    shared = sorted(eng._pages._prefix[0].values())[:2]
    pools = [t for t in tree_leaves(eng.executor._cache["blocks"])]
    before = [t[:, shared].clone() for t in pools]
    again = eng.generate_many(prompts, max_new_tokens=10)
    assert eng.stats.prefill_tokens_avoided >= 2 * 8 * 3
    assert _tokens(again)[0] == _tokens(first)[0]
    for t, b in zip(pools, before):
        assert torch.equal(t[:, shared], b)


class _ScalarReads(TorchDispatchMode):
    """Records every device-to-host scalar read, including the ones
    PyTorch makes inside its own C++ (indexing with a 0-dim tensor):
    each is an ``aten._local_scalar_dense`` call."""

    def __init__(self):
        super().__init__()
        self.reads = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.reads += func is torch.ops.aten._local_scalar_dense.default
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_decode_chunk_issues_no_host_sync(models, monkeypatch, paged, int8):
    """A decode chunk's steps never read a device value back to the host,
    from Python or from inside PyTorch: the parking, the page lookup and
    the dropped writes stay tensor ops."""
    _, _, tm, tp = models
    if int8:
        tm = build_model(dataclasses.replace(tm.cfg, kv_quant_int8=True))
    eng = ContinuousEngine(tm, tp, **dict(KW, prefill_batch=3),
                           **(dict(paged=True, page_size=8) if paged else {}))
    for rid, p in enumerate(_mixed_prompts()[:2]):
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


def test_paged_config_validation(models):
    _, _, tm, tp = models
    with pytest.raises(ValueError, match="multiple"):
        SingleDeviceExecutor(tm, tp, num_slots=2, max_len=60, paged=True,
                             page_size=16)
    with pytest.raises(ValueError, match="pages per partition"):
        SingleDeviceExecutor(tm, tp, num_slots=2, max_len=64, paged=True,
                             page_size=16, num_pages=3)
    ex = SingleDeviceExecutor(tm, tp, num_slots=2, max_len=64, paged=True,
                              page_size=16)
    assert (ex.mb_scratch, ex.max_blocks, ex.num_pages) == (4, 5, 10)
    with pytest.raises(RuntimeError, match="admit_paged"):
        ex.admit(np.zeros((1, 4), np.int32), np.zeros(1, np.int32),
                 np.ones(1, np.int32))


# ---------------------------------------------------------------------------
# The host allocator
# ---------------------------------------------------------------------------


_op = st.one_of(
    st.tuples(st.just("plan"), st.integers(0, 3), st.integers(1, 30),
              st.integers(1, 12)),
    st.tuples(st.just("release"), st.integers(0, 7)))


@settings(max_examples=60, deadline=None)
@given(ops=st.lists(_op, max_size=25),
       sharing=st.booleans(), ps=st.sampled_from([4, 8]))
def test_page_pool_plans_like_the_reference(ops, sharing, ps):
    """The same sequence of plan (+ commit) / release on both pools
    gives equal plans, refcounts, free counts and counters."""
    pools = [RefPagePool(24, ps, prefix_sharing=sharing),
             PagePool(24, ps, prefix_sharing=sharing)]
    heads = [[1, 2, 3, 4, 5, 6, 7, 8, 9], [1, 2, 3, 9, 9, 9, 9, 9],
             [5] * 12, [7, 8]]
    live = [[], []]
    for op in ops:
        if op[0] == "plan":
            _, h, extra, limit = op
            toks = heads[h] + list(range(10, 10 + extra))
            plans = [pool.plan(toks, limit) for pool in pools]
            assert (plans[0] is None) == (plans[1] is None)
            if plans[0] is None:
                continue
            assert dataclasses.asdict(plans[0]) == dataclasses.asdict(
                plans[1])
            for pool, plan, held in zip(pools, plans, live):
                pool.commit(plan)
                held.append(plan)
        elif live[0]:
            i = op[1] % len(live[0])
            for pool, held in zip(pools, live):
                pool.release(held.pop(i))
        ref_pool, port_pool = pools
        assert [ref_pool.refcount(p) for p in range(24)] == \
            [port_pool.refcount(p) for p in range(24)]
        assert ref_pool.n_free() == port_pool.n_free()
        assert ref_pool.cached_pages() == port_pool.cached_pages()
        assert (ref_pool.n_evicted, ref_pool.n_cow_forks) == \
            (port_pool.n_evicted, port_pool.n_cow_forks)


# ---------------------------------------------------------------------------
# Gateway.serve over a paged backend
# ---------------------------------------------------------------------------


def test_gateway_serves_paged_backend_like_reference(models):
    """FixedPolicy(0) (k=2, guarded) over paged backends: every prompt
    starts with the guarded template, so later admissions share its
    pages; outcomes and GatewayStats equal the reference's."""
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
                  prefill_batch=2, paged=True, page_size=4)
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
    for f in STATS:
        assert getattr(tes, f) == getattr(res, f), f
    assert tes.prefill_tokens_avoided > 0
