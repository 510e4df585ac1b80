"""Flash-decode in the port against the reference.

The port's wrapper on CPU tensors runs its plain version
(``flash_decode_torch``); it is held against the reference's
``ops.flash_decode`` (the Pallas kernel in interpret mode, as
``tests/test_flash_decode.py`` runs it) and its ``ref.flash_decode_ref``
oracle on the same numpy inputs.  The CUDA kernel itself runs only on
the card, where ``chip_smoke.py`` holds it against the plain version.
"""
import torch_threads  # noqa: F401  (caps torch's threads under xdist)
import inspect
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from repro.kernels import flash_decode as ref_flash_decode
from repro.kernels import ref
from repro_torch.kernels import flash_decode as fd

# float32 throughout; the sums run in another order in each version
TOL = 1e-5
# bf16 output (chip_smoke.KERNEL_TOL)
KERNEL_TOL = 2e-2
KERNEL_SOURCE = (Path(fd.__file__).resolve().parent / "csrc"
                 / "flash_decode.cu")


def _inputs(B, L, H, Hkv, D, seed=0, lengths=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((B, L, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, L, Hkv, D)).astype(np.float32)
    if lengths is None:
        # ragged, with the 1 and full-L extremes
        lengths = np.linspace(1, L, B).round()
    return q, k, v, np.asarray(lengths, np.int32)


def _oracle(q, k, v, lengths):
    """ref.flash_decode_ref over (B*H) rows with the GQA heads expanded."""
    B, H, D = q.shape
    L, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    kf = np.repeat(k, G, 2).transpose(0, 2, 1, 3).reshape(B * H, L, D)
    vf = np.repeat(v, G, 2).transpose(0, 2, 1, 3).reshape(B * H, L, D)
    lf = np.repeat(lengths, H)
    out = ref.flash_decode_ref(jnp.asarray(q.reshape(B * H, D)),
                               jnp.asarray(kf), jnp.asarray(vf),
                               jnp.asarray(lf))
    return np.asarray(out).reshape(B, H, D)


def _port(q, k, v, lengths):
    return fd.flash_decode(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v),
                           torch.from_numpy(lengths)).numpy()


@pytest.mark.parametrize("B,L,H,Hkv,D", [
    (3, 128, 4, 4, 64),      # G = 1 (the qwen family)
    (4, 96, 8, 2, 64),       # G = 4, L not a multiple of the 128 block
    (2, 100, 8, 2, 128),     # G = 4, head_dim 128, ragged tail
    (3, 64, 6, 1, 128),      # MQA, G = 6
    (2, 80, 64, 8, 64),      # G = 8 (command-r-35b's H 64 over 8)
    (2, 100, 16, 8, 256),    # gemma3-12b: G = 2, head_dim 256
    (3, 48, 8, 1, 256),      # head_dim 256 at G = 8
    (3, 100, 8, 8, 96),      # phi-3-vision: G = 1, head_dim 96
    (2, 64, 8, 2, 96),       # head_dim 96 at G = 4
])
def test_plain_version_matches_pallas_and_oracle(B, L, H, Hkv, D):
    q, k, v, lens = _inputs(B, L, H, Hkv, D)
    got = _port(q, k, v, lens)
    pallas = np.asarray(ref_flash_decode(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), jnp.asarray(lens)))
    np.testing.assert_allclose(got, pallas, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, _oracle(q, k, v, lens), rtol=TOL,
                               atol=TOL)


def test_length_one_and_stale_tail_are_ignored():
    """A slot attends over exactly [0, length): garbage past it (a freed
    slot's stale tail) changes nothing, and length 1 (or a clamped 0)
    attends to position 0 alone."""
    q, k, v, _ = _inputs(2, 64, 4, 2, 64, seed=1)
    lens = np.array([1, 40], np.int32)
    base = _port(q, k, v, lens)
    k2, v2 = k.copy(), v.copy()
    k2[0, 1:], v2[0, 1:] = 7.0, -3.0
    k2[1, 40:], v2[1, 40:] = 1e4, -1e4
    np.testing.assert_array_equal(_port(q, k2, v2, lens), base)
    # length 1: the output is position 0's value row, per query head
    np.testing.assert_allclose(base[0], np.repeat(v[0, 0], 2, 0),
                               rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(
        _port(q, k, v, np.array([0, 40], np.int32)), base)


def test_cpu_tensors_take_the_plain_path(monkeypatch):
    def no_kernel(*a):
        raise AssertionError("the CUDA kernel was reached from CPU tensors")
    monkeypatch.setattr(fd, "_launch", no_kernel)
    before = fd.flash_decode.launches
    q, k, v, lens = _inputs(2, 32, 4, 4, 64)
    _port(q, k, v, lens)
    assert fd.flash_decode.launches == before


def _fake_cuda(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="cuda")


class _Stream:
    cuda_stream = 0


@pytest.mark.parametrize("B,L,H,Hkv", [
    (2, 16, 4, 4),        # G = 1
    (8, 392, 48, 8),      # dbrx-132b, G = 6
    (8, 392, 64, 8),      # command-r-35b, G = 8
    (8, 4096, 64, 8),     # a 4096-row slot at G = 8
])
@pytest.mark.parametrize("dtype,head_dim,error,match", [
    # passes the checks, then cannot build the kernel here
    (torch.bfloat16, 128, RuntimeError, "nvcc"),
    (torch.float32, 128, TypeError, "bfloat16"),     # bf16 only
    (torch.bfloat16, 96, RuntimeError, "nvcc"),      # phi-3's head_dim
    (torch.bfloat16, 256, RuntimeError, "nvcc"),     # gemma3's head_dim
    (torch.bfloat16, 80, ValueError, "head_dim"),    # 64, 96, 128, 256 only
])
def test_cuda_request_launches_or_raises_never_falls_back(
        monkeypatch, dtype, head_dim, error, match, B, L, H, Hkv):
    """On a CUDA tensor the wrapper goes to the kernel and nowhere else:
    with no card and no nvcc that is an error, never the plain path.
    Tensors of a request within the contract reach the build having
    chosen the partitions and sized the merge's scratch -- fake tensors,
    whose values cannot be read, so neither reads ``lengths``.  The
    wrapper sends a CUDA tensor to the op ``repro_torch::flash_decode``,
    whose CUDA kernel is ``_launch``; a fake tensor would take the op's
    fake rule (``tests/test_torch_dryrun.py``), so these fake tensors,
    standing for real ones, are given to ``_launch`` itself."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without a card")

    def no_fallback(*a):
        raise AssertionError("fell back to the plain version")
    monkeypatch.setattr(fd, "flash_decode_torch", no_fallback)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: _Stream())
    monkeypatch.setattr(fd, "_num_sms", {torch.device("cuda:0"): 132})
    monkeypatch.setattr(fd, "_scratches", {})
    before = fd.flash_decode.launches
    with FakeTensorMode():
        q = _fake_cuda((B, H, head_dim), dtype)
        k = _fake_cuda((B, L, Hkv, head_dim), dtype)
        lens = torch.ones(B, dtype=torch.int32, device="cuda")
        with pytest.raises(error, match=match):
            fd._launch(q, k, k, lens)
    assert fd.flash_decode.launches == before
    assert torch._C._dispatch_has_kernel_for_dispatch_key(
        "repro_torch::flash_decode", "CUDA")
    if error is not RuntimeError:
        return
    parts, _ = fd.partitions(L)
    if parts == 1:
        assert not fd._scratches
    else:
        ((tickets, part),) = fd._scratches.values()
        assert tickets.numel() == B * Hkv
        assert part.numel() == B * H * parts * (head_dim + 2)


def _runs(L, parts, part_rows):
    return [(i * part_rows, min((i + 1) * part_rows, L))
            for i in range(parts)]


@pytest.mark.parametrize("L", [1, 15, 16, 17, 100, 392, 400, 512, 513,
                               4096, 32768, 200000])
def test_partition_rule_covers_the_slot_from_shapes_only(L):
    """The dense rule is a function of the cache's length L alone -- not
    of ``lengths``, so choosing it never reads the card, and not of the
    batch, the kv heads or the SM count either (slots are not split to
    fill SMs).  Its runs are whole tiles, cover [0, L) with no gap or
    overlap, none empty of rows, at most the kernel's maximum, one run
    up to MAX_PARTITION_ROWS rows and none longer than that unless the
    runs are as many as the kernel takes."""
    assert list(inspect.signature(fd.partitions).parameters) == ["L"]
    parts, rows = fd.partitions(L)
    assert rows % fd.TILE_ROWS == 0
    assert 1 <= parts <= fd.MAX_PARTITIONS
    runs = _runs(L, parts, rows)
    assert runs[0][0] == 0 and runs[-1][1] == L
    assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))
    assert all(hi > lo for lo, hi in runs)
    assert (parts == 1) == (L <= fd.MAX_PARTITION_ROWS)
    assert rows <= fd.MAX_PARTITION_ROWS or parts == fd.MAX_PARTITIONS
    assert fd.partitions(L) == fd.partitions(L)


def test_constants_are_the_kernel_sources():
    """The wrapper's tile, group and partition bounds are the ones the
    CUDA source checks."""
    src = KERNEL_SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)
                   .group(1))
    assert const("kTile") == fd.TILE_ROWS
    assert const("kMaxGroup") == fd.MAX_GROUP
    assert const("kMaxParts") == fd.MAX_PARTITIONS
    assert const("kNarrowWarps") == NARROW_WARPS
    assert const("kWideWarps") == WIDE_WARPS


# csrc/flash_decode.cu's kNarrowWarps and kWideWarps: the warps of a
# block, as fd.wide_blocks picks them
NARROW_WARPS, WIDE_WARPS = 4, 8


def _kernel_emulation(q, k, v, lengths, parts, part_rows, num_sms,
                      split_p):
    """K1's arithmetic in torch: each (slot, kv head) cut into runs of
    ``part_rows`` rows; a run at or past the clamped length is skipped
    (the empty state); in a run, warp w of W (8 or 4, as
    ``fd.wide_blocks`` picks for ``num_sms`` SMs) takes tiles w, w + W,
    ... of 16 rows and runs an online softmax in the log2 domain over
    them; when ``split_p``, P V is the sum of two products, P's bf16
    part and the bf16 part of what it leaves; the warps merge, then the
    runs, online in run order."""
    B, H, D = q.shape
    L, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    c = torch.log2(torch.tensor(torch.e)).item() / D ** 0.5
    qg, kf, vf = q.float().reshape(B, Hkv, G, D), k.float(), v.float()
    n = lengths.long().clamp(1, L)
    out = torch.empty(B, Hkv, G, D)
    warps = (WIDE_WARPS if fd.wide_blocks(B, Hkv, parts, num_sms, D)
             else NARROW_WARPS)

    def merge(states):
        m = torch.stack([s[0] for s in states])          # (S, G)
        w = torch.exp2(m - m.max(0).values)
        den = (torch.stack([s[1] for s in states]) * w).sum(0)
        num = (torch.stack([s[2] for s in states]) * w[..., None]).sum(0)
        return m.max(0).values, den, num

    for b in range(B):
        for j in range(Hkv):
            run_states = []
            for part in range(parts):
                lo = part * part_rows
                if lo >= n[b]:
                    continue
                hi = min(int(n[b]), lo + part_rows)
                tiles = list(range(lo, hi, fd.TILE_ROWS))
                warp_states = []
                for w in range(min(warps, len(tiles))):
                    m = torch.full((G,), fd.NEG_INF)
                    l, acc = torch.zeros(G), torch.zeros(G, D)
                    for t0 in tiles[w::warps]:
                        t1 = min(t0 + fd.TILE_ROWS, hi)
                        x = (qg[b, j] @ kf[b, t0:t1, j].T) * c
                        m_new = torch.maximum(m, x.max(-1).values)
                        alpha = torch.exp2(m - m_new)
                        p = torch.exp2(x - m_new[:, None])
                        l = l * alpha + p.sum(-1)
                        vt = vf[b, t0:t1, j]
                        if split_p:
                            p_hi = p.bfloat16().float()
                            p_lo = (p - p_hi).bfloat16().float()
                            pv = p_hi @ vt + p_lo @ vt
                        else:
                            pv = p @ vt
                        acc = acc * alpha[:, None] + pv
                        m = m_new
                    warp_states.append((m, l, acc))
                run_states.append(merge(warp_states))
            mx, den, num = run_states[0]
            for m_k, l_k, a_k in run_states[1:]:
                m_new = torch.maximum(mx, m_k)
                c_old, c_k = torch.exp2(mx - m_new), torch.exp2(m_k - m_new)
                den = den * c_old + l_k * c_k
                num = num * c_old[:, None] + a_k * c_k[:, None]
                mx = m_new
            out[b, j] = num / den.clamp(min=1e-30)[:, None]
    return out.reshape(B, H, D)


@pytest.mark.parametrize("L,parts,part_rows", [
    (96, 1, 96),       # one run: the block writes the output itself
    (96, 3, 32),       # runs of two tiles; short slots skip the later runs
    (100, 2, 64),      # a ragged last tile
    (392, None, None),  # the rule, at the main path's L on a 132-SM card
])
@pytest.mark.parametrize("G", [1, 8])
@pytest.mark.parametrize("num_sms", [132, 8])  # wide blocks, narrow ones
def test_split_and_merge_match_the_plain_version(L, parts, part_rows, G,
                                                 num_sms):
    """The kernel's split of slots, its warps' online softmax over tiles
    and the in-order merges give the plain version's output: exactly
    (1e-5) in float32; on bf16 inputs, with P split into two bf16 parts
    as the tensor cores take it (16 bits of P kept), still within 1e-5
    of float32 P before the output's rounding, and within the card's
    tolerance after it."""
    B, Hkv, D = 5, 2, 64
    if parts is None:
        parts, part_rows = fd.partitions(L)
    q, k, v, lens = (torch.from_numpy(a) for a in _inputs(
        B, L, G * Hkv, Hkv, D, seed=L + G))
    got = _kernel_emulation(q, k, v, lens, parts, part_rows, num_sms,
                            False)
    want = fd.flash_decode_torch(q, k, v, lens)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL,
                               atol=TOL)
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    got = _kernel_emulation(qb, kb, vb, lens, parts, part_rows, num_sms,
                            True)
    exact = fd.flash_decode_torch(qb.float(), kb.float(), vb.float(), lens)
    assert (got - exact).abs().max() <= TOL
    want = fd.flash_decode_torch(qb, kb, vb, lens).float()
    assert (got.bfloat16().float() - want).abs().max() <= KERNEL_TOL


@pytest.mark.parametrize("L", [392, 2048])
def test_split_and_merge_match_the_plain_version_at_head_dim_256(L):
    """gemma3-12b's head_dim 256 and G = 2, at the main path's slot and
    at a 2048-row one (4 runs of 512 rows): the kernel's arithmetic,
    always in narrow blocks at this head dim, gives the plain version's
    output, in float32 and on bf16 inputs with P split in two parts."""
    B, Hkv, G, D = 3, 2, 2, 256
    parts, part_rows = fd.partitions(L)
    assert (parts, part_rows) == ((1, 400) if L == 392 else (4, 512))
    assert not fd.wide_blocks(B, Hkv, parts, 132, D)
    q, k, v, lens = (torch.from_numpy(a) for a in _inputs(
        B, L, G * Hkv, Hkv, D, seed=L, lengths=[L, 1, L // 2 + 3]))
    got = _kernel_emulation(q, k, v, lens, parts, part_rows, 132, False)
    want = fd.flash_decode_torch(q, k, v, lens)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL,
                               atol=TOL)
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    got = _kernel_emulation(qb, kb, vb, lens, parts, part_rows, 132, True)
    exact = fd.flash_decode_torch(qb.float(), kb.float(), vb.float(), lens)
    assert (got - exact).abs().max() <= TOL
    want = fd.flash_decode_torch(qb, kb, vb, lens).float()
    assert (got.bfloat16().float() - want).abs().max() <= KERNEL_TOL


def _row_chunks(D):
    """16-byte chunks a shared K/V row of K1 takes: D / 8 where that is a
    power of two (rows swizzled), else one pad chunk more (D = 96: 13)."""
    n = D // 8
    return n if n & (n - 1) == 0 else n + 1


@pytest.mark.parametrize("num_sms", [132, 8])  # narrow blocks, wide ones
def test_split_and_merge_match_the_plain_version_at_head_dim_96(num_sms):
    """phi-3-vision's head_dim 96 at G = 1 on the main path's 392-row
    slots (one run): the kernel's arithmetic, over 6 k-steps and 12
    n-tiles, gives the plain version's output, in float32 and on bf16
    inputs with P split in two parts."""
    B, Hkv, G, D, L = 3, 2, 1, 96, 392
    parts, part_rows = fd.partitions(L)
    assert parts == 1
    q, k, v, lens = (torch.from_numpy(a) for a in _inputs(
        B, L, G * Hkv, Hkv, D, seed=96, lengths=[L, 1, 173]))
    got = _kernel_emulation(q, k, v, lens, parts, part_rows, num_sms, False)
    want = fd.flash_decode_torch(q, k, v, lens)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL,
                               atol=TOL)
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    got = _kernel_emulation(qb, kb, vb, lens, parts, part_rows, num_sms,
                            True)
    exact = fd.flash_decode_torch(qb.float(), kb.float(), vb.float(), lens)
    assert (got - exact).abs().max() <= TOL
    want = fd.flash_decode_torch(qb, kb, vb, lens).float()
    assert (got.bfloat16().float() - want).abs().max() <= KERNEL_TOL


@pytest.mark.parametrize("D", fd.HEAD_DIMS)
def test_block_width_fits_shared_memory(D):
    """Wide blocks are picked only at a head dim where 8 warps' rings of
    two 16-row K + V tiles (rows padded at D = 96) fit the shared memory
    a block may have (the source's kMaxSmem); narrow ones fit at every
    head dim."""
    src = KERNEL_SOURCE.read_text()
    most = eval(re.search(r"constexpr int kMaxSmem = ([\d *]+);",
                          src).group(1))
    assert int(re.search(r"constexpr int kStages = (\d+);", src)
               .group(1)) == 2
    assert f"if (D == {D}) return launch<{D}>" in src
    assert "return swizzled(D) ? D / 8 : D / 8 + 1;" in src

    def ring(warps):
        return warps * 2 * 2 * fd.TILE_ROWS * _row_chunks(D) * 16
    assert ring(NARROW_WARPS) <= most
    can_be_wide = any(fd.wide_blocks(B, Hkv, parts, sms, D)
                      for B, Hkv, parts, sms in ((1, 1, 1, 132),
                                                 (8, 8, 4, 132)))
    assert can_be_wide == (ring(WIDE_WARPS) <= most) == (D <= 128)


class _ScalarReads(TorchDispatchMode):
    """Counts device-to-host scalar reads (``aten._local_scalar_dense``)."""

    def __init__(self):
        super().__init__()
        self.reads = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.reads += func is torch.ops.aten._local_scalar_dense.default
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("B,L,H,Hkv", [(8, 392, 40, 40), (8, 392, 64, 8),
                                       (8, 4096, 64, 8), (3, 16, 2, 1)])
def test_launch_arguments_depend_on_shapes_only(monkeypatch, B, L, H, Hkv):
    """The wrapper's kernel arguments, through a stand-in kernel: the
    partition count and the scratch (tickets left at zero, partials
    sized B * H * parts * (D + 2)) are the same for any lengths -- a
    long slot among short ones, or all of length 1 -- none is read back
    to the host, and one launch is counted a call."""
    _check_launch_arguments(monkeypatch, B, L, H, Hkv, 128)


@pytest.mark.parametrize("B,L,H,Hkv", [(8, 392, 16, 8), (8, 2048, 16, 8),
                                       (1, 16, 8, 1)])
def test_launch_arguments_at_head_dim_256(monkeypatch, B, L, H, Hkv):
    """The same at gemma3-12b's head_dim 256 (its slots of 392 and 2048
    rows, G = 2): narrow blocks whatever the grid, and partials sized
    for D + 2 = 258 floats a head."""
    _check_launch_arguments(monkeypatch, B, L, H, Hkv, 256)


@pytest.mark.parametrize("B,L,H,Hkv", [(8, 392, 32, 32), (3, 16, 4, 4)])
def test_launch_arguments_at_head_dim_96(monkeypatch, B, L, H, Hkv):
    """The same at phi-3-vision's head_dim 96 (its 32 heads = kv heads
    on the main path's slots): blocks as wide as the grid allows, and
    partials sized for D + 2 = 98 floats a head."""
    _check_launch_arguments(monkeypatch, B, L, H, Hkv, 96)


def _check_launch_arguments(monkeypatch, B, L, H, Hkv, D):
    calls = []

    def fake_kernel(*args):
        calls.append(args)
        return 0
    monkeypatch.setattr(fd, "_kernel", lambda: fake_kernel)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: _Stream())
    monkeypatch.setattr(fd, "_num_sms", {torch.device("cpu"): 132})
    monkeypatch.setattr(fd, "_scratches", {})
    monkeypatch.setattr(fd.flash_decode, "launches", 0)
    q, k, v, lens = (torch.from_numpy(a) for a in _inputs(
        B, L, H, Hkv, D, lengths=[L] + [1] * (B - 1)))
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    ones = torch.ones_like(lens)
    with _ScalarReads() as syncs:
        fd._launch(q, k, v, lens)
        fd._launch(q, k, v, ones)
    assert syncs.reads == 0 and fd.flash_decode.launches == 2
    a, b = calls
    # the same but for the lengths and the output, allocated anew
    assert a[:3] == b[:3] and a[5:] == b[5:] and a[3] != b[3]
    parts, part_rows = fd.partitions(L)
    assert a[7:15] == (B, H, Hkv, L, D, parts, part_rows,
                       fd.wide_blocks(B, Hkv, parts, 132, D))
    assert a[14] == (D <= 128 and (parts > 1 or B * Hkv <= 132))
    if parts == 1:
        assert a[5] is None and a[6] is None
    else:
        ((tickets, part),) = fd._scratches.values()
        assert a[5] == part.data_ptr() and a[6] == tickets.data_ptr()
        assert tickets.numel() == B * Hkv and not tickets.any()
        assert part.numel() == B * H * parts * (D + 2)
