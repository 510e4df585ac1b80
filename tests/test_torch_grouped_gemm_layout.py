"""K7 / K8's bf16 design (``csrc/grouped_gemm.cu``) modelled in numpy.

The kernels run only on the card, where ``chip_smoke.py`` holds them
against their plain versions.  These tests hold the design itself, with
the tile constants read from the kernel source:

* the persistent scheduler: over seeded random splits and the ragged
  edges (empty first / middle / last groups, every row in one group,
  M = 0, groups under 64 rows), every output tile of every group is
  visited exactly once across the grid's blocks, the grid bound from the
  shapes covers the tiles the offsets make, and K8's zeroing of its last
  stage leaves exactly the group's own rows;
* the shared-memory layouts: a 128-byte-swizzled TMA box written into a
  stage and read back through the ``desc_sw128`` descriptor as wgmma
  reads a K-major or MN-major operand, at the offsets the kernel steps
  by, gives numpy's product for each of the three operand layouts (X W,
  dY W^T, X^T dY), the scheduler and the edge zeroing included.

Small integers keep every sum exact, so the products compare equal.
"""
import re
from pathlib import Path

import numpy as np
import pytest

from repro_torch.kernels import grouped_gemm as gg

SOURCE = (Path(gg.__file__).resolve().parent / "csrc"
          / "grouped_gemm.cu").read_text()


def _const(name: str) -> int:
    m = re.search(rf"constexpr int {name} = ([^;]+);", SOURCE)
    assert m, name
    return int(eval(m.group(1), {}, dict(CONSTS)))  # noqa: S307


CONSTS: dict = {}
for _name in ("kBM", "kBN", "kBK", "kStages", "kBlock", "kATile", "kBTile",
              "kMaxGroups"):
    CONSTS[_name] = _const(_name)
BM, BN, BK = CONSTS["kBM"], CONSTS["kBN"], CONSTS["kBK"]
BLOCK, ATILE, BTILE = CONSTS["kBlock"], CONSTS["kATile"], CONSTS["kBTile"]
HALF = BM // 2  # rows a consumer warpgroup

# the descriptor steps a consumer takes through a stage, k-step by k-step
_STEP = {
    "a_mn": int(re.search(r"A_MN \? desc_sw128\(a \+ kk \* (\d+), kBlock\)",
                          SOURCE).group(1)),
    "a_k": int(re.search(r": desc_sw128\(a \+ kk \* (\d+)\)",
                         SOURCE).group(1)),
    "b_mn": int(re.search(r"B_MN \? desc_sw128\(b \+ kk \* (\d+), kBlock\)",
                          SOURCE).group(1)),
    "b_k": int(re.search(r": desc_sw128\(b \+ kk \* (\d+)\)",
                         SOURCE).group(1)),
}

SPLITS = {
    "empty_first": [0, 70, 150, 9],
    "empty_middle": [130, 0, 0, 257, 4],
    "empty_last": [64, 128, 1, 0],
    "one_group": [0, 0, 300, 0],
    "under_64": [5, 63, 1, 0, 17, 40, 2, 33],
    "m0": [0, 0, 0],
}


def _random_splits():
    rng = np.random.default_rng(33)
    out = {}
    for i, E in enumerate((1, 4, 16, 256)):
        M = int(rng.integers(1, 40 * E + 600))
        cuts = np.sort(rng.integers(0, M + 1, E - 1))
        out[f"random_E{E}"] = list(np.diff(np.concatenate([[0], cuts, [M]])))
    return out


SPLITS.update(_random_splits())


def _cdiv(a, b):
    return -(-a // b)


# ---------------------------------------------------------------------------
# the scheduler: a mirror of work_at and the warp scan's prefix
# ---------------------------------------------------------------------------

def _prefix(offs, M, nc):
    """K7's shared-memory prefix of tile counts and clamped offsets."""
    lo = np.clip(offs, 0, M)
    pre = [0]
    for g in range(len(offs) - 1):
        rows = max(lo[g], lo[g + 1]) - lo[g]
        pre.append(pre[-1] + _cdiv(rows, BM) * nc)
    return pre, lo


def _work_at(t, group_red, offs, pre, lo, E, M, O, R, nc):
    """(g, ot, ohi, c0, r0, r1) of tile t."""
    if group_red:
        rt = _cdiv(O, BM)
        g, l = divmod(t, rt * nc)
        r0 = min(max(offs[g], 0), M)
        r1 = max(r0, min(max(offs[g + 1], 0), M))
        return g, (l % rt) * BM, O, (l // rt) * BN, r0, r1
    a, b = 0, E - 1
    while a < b:  # the first g with pre[g + 1] > t
        mid = (a + b) // 2
        if pre[mid + 1] > t:
            b = mid
        else:
            a = mid + 1
    l = t - pre[a]
    rt = _cdiv(lo[a + 1] - lo[a], BM)
    ot = lo[a] + (l % rt) * BM
    return a, ot, min(lo[a + 1], ot + BM), (l // rt) * BN, 0, R


def _walk(sizes, C, group_red, O=None, R=64, sms=132):
    """Every block's tiles, in its order: the launch's grid (min(tiles
    bound, SMs)) walking tile indices blockIdx.x, + grid, ..."""
    E, M = len(sizes), int(sum(sizes))
    offs = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    nc = _cdiv(C, BN)
    if group_red:
        bound = E * _cdiv(O, BM) * nc
        total, pre, lo = bound, None, None
    else:
        O = M
        bound = (_cdiv(M, BM) + min(E, M)) * nc
        pre, lo = _prefix(offs, M, nc)
        total = pre[E]
    assert total <= bound
    grid = min(bound, sms)
    return offs, [[_work_at(t, group_red, offs, pre, lo, E, M, O, R, nc)
                   for t in range(b, total, grid)] for b in range(grid)]


@pytest.mark.parametrize("sms", [132, 7])
@pytest.mark.parametrize("split", list(SPLITS))
def test_k7_scheduler_visits_every_tile_once(split, sms):
    sizes, C = SPLITS[split], 520
    offs, blocks = _walk(sizes, C, group_red=False, sms=sms)
    seen = [w for blk in blocks for w in blk]
    assert len(seen) == len(set(seen))
    want = {(g, int(offs[g]) + i * BM, c)
            for g, n in enumerate(sizes) for i in range(_cdiv(n, BM))
            for c in range(0, C, BN)}
    assert {(g, ot, c0) for g, ot, _, c0, _, _ in seen} == want
    covered = np.zeros((sum(sizes), C), np.int32)
    for g, ot, ohi, c0, r0, r1 in seen:
        assert offs[g] <= ot < ohi <= min(offs[g + 1], ot + BM)
        assert (r0, r1) == (0, 64)
        covered[ot:ohi, c0:c0 + BN] += 1
        # the consumers with a row of the tile are the active ones
        active = [ot + HALF * c < ohi for c in (0, 1)]
        assert active[0] and active[1] == (ohi - ot > HALF)
    assert (covered == 1).all()
    # row tiles run fastest within a group's column tile
    by_index = [blocks[b][r] for r in range(max(map(len, blocks), default=0))
                for b in range(len(blocks)) if r < len(blocks[b])]
    order = [(g, c0, ot) for g, ot, _, c0, _, _ in by_index]
    assert order == sorted(order)


@pytest.mark.parametrize("split", list(SPLITS))
def test_k8_scheduler_visits_every_tile_once_and_zeroes_the_edge(split):
    sizes, K, N = SPLITS[split], 264, 520
    offs, blocks = _walk(sizes, N, group_red=True, O=K)
    seen = [w for blk in blocks for w in blk]
    assert len(seen) == len(set(seen))
    assert {(g, ot, c0) for g, ot, _, c0, _, _ in seen} == {
        (g, o, c) for g in range(len(sizes)) for o in range(0, K, BM)
        for c in range(0, N, BN)}
    for g, ot, ohi, c0, r0, r1 in seen:
        assert (r0, r1) == (offs[g], offs[g + 1]) and ohi == K
        nk = _cdiv(r1 - r0, BK)
        kept = []
        for kt in range(nk):
            box = np.arange(r0 + kt * BK, r0 + (kt + 1) * BK)
            keep = np.ones(BK, bool)
            if kt == nk - 1:  # the consumers zero reduction rows from v on
                v = r1 - (r0 + kt * BK)
                keep[v:] = False
            own = (box >= offs[g]) & (box < offs[g + 1])
            assert (keep == own).all()
            kept += list(box[keep])
        assert kept == list(range(offs[g], offs[g + 1]))


def test_grid_depends_on_the_shapes_alone():
    """Two splits of the same shapes launch the same grid; the launch's
    tile bound covers the most tiles any split makes."""
    E, M, C = 16, 384, 2048
    grids = set()
    for sizes in ([M] + [0] * (E - 1), [M // E] * E, [1] * (E - 1) + [M - E + 1]):
        offs, blocks = _walk(sizes, C, group_red=False)
        grids.add(len(blocks))
    assert grids == {min(132, (_cdiv(M, BM) + min(E, M)) * _cdiv(C, BN))}


# ---------------------------------------------------------------------------
# the layouts: TMA's 128-byte swizzle and wgmma's descriptor, emulated
# ---------------------------------------------------------------------------

def _swizzle(addr):
    """The 128-byte swizzle: 16-byte chunk j of a 128-byte row r lands at
    chunk j ^ (r % 8), as a function of the shared-memory address."""
    return addr ^ (((addr >> 7) & 7) << 4)


def _desc_sw128(addr, lbo=1024, sbo=1024):
    return (((addr & 0x3FFFF) >> 4) | ((lbo >> 4) << 16)
            | ((sbo >> 4) << 32) | (1 << 62))


def _decode(desc):
    assert desc >> 62 == 1  # 128-byte swizzle
    return ((desc & 0x3FFF) << 4, ((desc >> 16) & 0x3FFF) << 4,
            ((desc >> 32) & 0x3FFF) << 4)


def _tma_box(smem, dst, plane, inner0, outer0, rows):
    """A box of 64 contiguous elements x ``rows`` rows of ``plane``
    (rows, contiguous) from (outer0, inner0) into ``smem`` (an element
    per 2 bytes) at byte ``dst``, 128-byte swizzled; out of range reads 0."""
    assert dst % 1024 == 0
    y, x = np.meshgrid(np.arange(rows), np.arange(64), indexing="ij")
    gy, gx = outer0 + y, inner0 + x
    ok = (gy >= 0) & (gy < plane.shape[0]) & (gx >= 0) & (gx < plane.shape[1])
    vals = np.where(ok, plane[np.clip(gy, 0, plane.shape[0] - 1),
                              np.clip(gx, 0, plane.shape[1] - 1)], 0)
    smem[_swizzle(dst + y * 128 + x * 2) // 2] = vals


def _operand(smem, desc, rows, mn_major, depth=16):
    """The (rows x 16) operand a wgmma reads through ``desc``: row i
    (M of A, N of B), reduction k."""
    start, lbo, sbo = _decode(desc)
    i, k = np.meshgrid(np.arange(rows), np.arange(depth), indexing="ij")
    if mn_major:  # 64-column blocks lbo apart, 8 reduction rows sbo apart
        addr = start + (i // 64) * lbo + (k // 8) * sbo + (k % 8) * 128 \
            + (i % 64) * 2
    else:  # 8-row groups sbo apart, the reduction along a 128-byte row
        addr = start + (i // 8) * sbo + (i % 8) * 128 + k * 2
    return smem[_swizzle(addr) // 2]


def _emulate(kind, sizes, x, w=None, dy=None, O=None):
    """The kernel's output computed through the emulated stages: the
    scheduler's tiles, the producer's boxes, K8's edge zeroing and each
    consumer's k-steps through the descriptors."""
    E, M = len(sizes), int(sum(sizes))
    base = 0x2000  # a stage's A tile; B after the ring's A tiles
    a_at, b_at = base, base + CONSTS["kStages"] * ATILE
    a_mn, b_mn, group_red = {"fwd": (False, True, False),
                             "dx": (False, False, False),
                             "dw": (True, True, True)}[kind]
    if kind == "fwd":
        A, R, C = x, x.shape[1], w.shape[2]
        b_plane = lambda g: w[g]                      # (R, C): C contiguous
    elif kind == "dx":
        A, R, C = dy, dy.shape[1], w.shape[1]
        b_plane = lambda g: w[g]                      # (C, R): R contiguous
    else:
        A, R, C = x, M, dy.shape[1]
        b_plane = lambda g: dy
    O = O if group_red else M
    out = np.full((E, O, C) if group_red else (M, C), np.nan)
    offs, blocks = _walk(sizes, C, group_red, O=O, R=R)
    for g, ot, ohi, c0, r0, r1 in (wk for blk in blocks for wk in blk):
        acc = np.zeros((BM, BN))
        nk = _cdiv(r1 - r0, BK)
        for kt in range(nk):
            smem = np.full((a_at + CONSTS["kStages"] * (ATILE + BTILE)) // 2,
                           np.nan)
            r = r0 + kt * BK
            if a_mn:  # X^T: 64 rows of the reduction x 64 columns a block
                for j in range(2):
                    _tma_box(smem, a_at + j * BLOCK, A, ot + 64 * j, r, 64)
            else:
                _tma_box(smem, a_at, A, r, ot, BM)
            if b_mn:
                for j in range(BN // 64):
                    _tma_box(smem, b_at + j * BLOCK, b_plane(g), c0 + 64 * j,
                             r, BK)
            else:
                _tma_box(smem, b_at, b_plane(g), r, c0, BN)
            if group_red and kt == nk - 1:
                v = r1 - r
                chunks = (BK - v) * 8
                for c in (0, 1):
                    for i in range(3 * chunks):
                        blk, q = divmod(i, chunks)
                        off = (a_at + c * BLOCK if blk == 0 else
                               b_at + (2 * c + blk - 1) * BLOCK)
                        off += (v + q // 8) * 128 + (q % 8) * 16
                        smem[off // 2:off // 2 + 8] = 0
            for c in (0, 1):
                if not (group_red or ot + HALF * c < ohi):
                    continue
                for kk in range(BK // 16):
                    a = a_at + c * BLOCK
                    da = (_desc_sw128(a + kk * _STEP["a_mn"], BLOCK) if a_mn
                          else _desc_sw128(a + kk * _STEP["a_k"]))
                    db = (_desc_sw128(b_at + kk * _STEP["b_mn"], BLOCK)
                          if b_mn else _desc_sw128(b_at + kk * _STEP["b_k"]))
                    acc[HALF * c:HALF * (c + 1)] += (
                        _operand(smem, da, HALF, a_mn)
                        @ _operand(smem, db, BN, b_mn).T)
        # the epilogue stores the tile's rows below ohi, columns below C
        rows = slice(ot, min(ohi, ot + BM))
        cols = slice(c0, min(C, c0 + BN))
        tile = acc[:rows.stop - ot, :cols.stop - c0]
        if group_red:
            out[g, rows, cols] = tile
        else:
            out[rows, cols] = tile
    return out


def _ints(rng, *shape):
    return rng.integers(-3, 4, shape).astype(np.float64)


LAYOUT_SPLITS = {"edges": [70, 0, 150], "under_64": [5, 63, 1, 0, 17]}


@pytest.mark.parametrize("split", list(LAYOUT_SPLITS))
@pytest.mark.parametrize("kind", ["fwd", "dx", "dw"])
def test_swizzled_stages_through_descriptors_give_the_product(kind, split):
    """X W (K-major A, MN-major B), dY W^T (both K-major) and X^T dY
    (both MN-major) through the emulated ring equal numpy's product,
    reductions not a multiple of the stage depth and columns not a
    multiple of the tile width included."""
    sizes = LAYOUT_SPLITS[split]
    rng = np.random.default_rng(len(kind) + len(sizes))
    E, M, K, N = len(sizes), sum(sizes), 136, 264
    x, dy = _ints(rng, M, K), _ints(rng, M, N)
    w = _ints(rng, E, K, N)
    offs = np.concatenate([[0], np.cumsum(sizes)])
    g_of = np.searchsorted(offs[1:], np.arange(M), side="right")
    if kind == "fwd":
        got = _emulate(kind, sizes, x, w=w)
        want = np.einsum("mk,mkn->mn", x, w[g_of])
    elif kind == "dx":
        got = _emulate(kind, sizes, None, w=w, dy=dy)
        want = np.einsum("mn,mkn->mk", dy, w[g_of])
    else:
        got = _emulate(kind, sizes, x, dy=dy, O=K)
        want = np.stack([x[offs[g]:offs[g + 1]].T @ dy[offs[g]:offs[g + 1]]
                         for g in range(E)])
    np.testing.assert_array_equal(got, want)


def test_descriptor_fields_round_trip():
    """desc_sw128's start address, leading and stride offsets, as the
    emulation decodes them (the address field keeps 18 bits)."""
    for addr in (0, 1024, 0x2000 + 3 * 32, 0x3FC00):
        for lbo in (1024, BLOCK):
            assert _decode(_desc_sw128(addr, lbo)) == (addr & 0x3FFFF, lbo,
                                                      1024)
    assert _decode(_desc_sw128(0x40000 + 64)) == (64, 1024, 1024)
