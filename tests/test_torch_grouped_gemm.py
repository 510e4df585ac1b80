"""The grouped GEMM of the port's MoE layers against ``jax.lax.ragged_dot``.

The port's wrapper on CPU tensors runs its plain version
(``grouped_gemm_torch``, and ``grouped_gemm_dw_torch`` for K8); both are
held against the reference's product, ``jax.lax.ragged_dot``, and its
gradients under ``jax.grad``, on the same numpy inputs.  K7 and K8
themselves run only on the card, where ``chip_smoke.py`` holds them
against these plain versions.

Tolerances: float32 1e-5 of max |y| (the same products summed in
another order); bf16 1e-2 of max |y| (both sum in float32 and round the
output to bf16 once: a sum in another order can cross a rounding
boundary, 2^-8 of |y| <= max |y|, and the bf16 rows of the gradients
carry one more rounding).
"""
import torch_threads  # noqa: F401  (caps torch's threads under xdist)
import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import grouped_gemm as gg
from repro_torch.launch.dryrun import Census

F32_TOL = 1e-5
BF16_TOL = 1e-2
KERNEL_SOURCE = (Path(gg.__file__).resolve().parent / "csrc"
                 / "grouped_gemm.cu")

# group sizes: random, empty groups first / in the middle / last, every
# row in one group, one row
CASES = {
    "random": [5, 17, 3, 11, 8, 20],
    "empty_first": [0, 9, 14, 7],
    "empty_middle": [12, 0, 0, 9, 6],
    "empty_last": [8, 13, 5, 0],
    "one_group": [0, 0, 37, 0],
    "one_row": [0, 1, 0],
}
DTYPES = {"float32": (jnp.float32, torch.float32, F32_TOL),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}


def _inputs(sizes, K=24, N=40, seed=0):
    rng = np.random.default_rng(seed)
    M, E = sum(sizes), len(sizes)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((E, K, N)) / np.sqrt(K)).astype(np.float32)
    dy = rng.standard_normal((M, N)).astype(np.float32)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    return x, w, dy, np.asarray(sizes, np.int32), offsets


def _ref(x, w, sizes, jdt):
    return jax.lax.ragged_dot(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                              jnp.asarray(sizes))


def _ref_grads(x, w, dy, sizes, jdt):
    """dX and dW of sum(ragged_dot(x, w) * dy) under ``jax.grad``."""
    def loss(x, w):
        y = jax.lax.ragged_dot(x, w, jnp.asarray(sizes))
        return jnp.sum(y.astype(jnp.float32) * jnp.asarray(dy))
    return jax.grad(loss, argnums=(0, 1))(jnp.asarray(x, jdt),
                                          jnp.asarray(w, jdt))


def _t(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _close(got, want, tol):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_matches_ragged_dot(case, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    x, w, _, sizes, offsets = _inputs(CASES[case])
    want = _ref(x, w, sizes, jdt)
    got = gg.grouped_gemm(_t(x, tdt), _t(w, tdt), torch.from_numpy(offsets),
                          max(CASES[case]))
    assert got.shape == want.shape and got.dtype == tdt
    _close(got, want, tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_gradients_match_jax_grad(case, dtype):
    """dX and dW of the plain version (autograd through it), and K8's
    plain version, against ``jax.grad`` of ``ragged_dot``; an empty
    group's dW is zero."""
    jdt, tdt, tol = DTYPES[dtype]
    x, w, dy, sizes, offsets = _inputs(CASES[case], seed=1)
    want_dx, want_dw = _ref_grads(x, w, dy, sizes, jdt)
    xt = _t(x, tdt).requires_grad_(True)
    wt = _t(w, tdt).requires_grad_(True)
    offs = torch.from_numpy(offsets)
    y = gg.grouped_gemm(xt, wt, offs, max(CASES[case]))
    dx, dw = torch.autograd.grad(y, (xt, wt), _t(dy, tdt))
    _close(dx, want_dx, tol)
    _close(dw, want_dw, tol)
    k8 = gg.grouped_gemm_dw_torch(_t(x, tdt), _t(dy, tdt), offs,
                                  max(CASES[case]))
    assert k8.shape == w.shape and k8.dtype == tdt
    _close(k8, want_dw, tol)
    for g, n in enumerate(CASES[case]):
        if n == 0:
            assert not k8[g].any() and not dw[g].any()


def test_transposed_weight_is_dx():
    """The dX product (K7 with ``trans_w``) as its CPU stand-in computes
    it, the plain version on the weights' transposed view: ``dy w[g]^T``
    row by row."""
    x, w, dy, sizes, offsets = _inputs(CASES["empty_middle"], seed=2)
    got = gg.grouped_gemm_torch(torch.from_numpy(dy),
                                torch.from_numpy(w).transpose(1, 2),
                                torch.from_numpy(offsets), 12)
    g = np.repeat(np.arange(len(sizes)), sizes)
    want = np.einsum("mn,mkn->mk", dy, w[g])
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=F32_TOL * np.abs(want).max())


class _ScalarReads(TorchDispatchMode):
    """Counts device-to-host scalar reads (``aten._local_scalar_dense``)."""

    def __init__(self):
        super().__init__()
        self.reads = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.reads += func is torch.ops.aten._local_scalar_dense.default
        return func(*args, **(kwargs or {}))


def test_plain_version_reads_nothing_back():
    """The plain versions, forward and backward, read no device value
    back to the host: the group of each row comes from ``searchsorted``
    on the device, the buffer's size from ``max_group``."""
    x, w, dy, _, offsets = _inputs(CASES["random"])
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    with _ScalarReads() as reads:
        y = gg.grouped_gemm(xt, wt, torch.from_numpy(offsets), 20)
        torch.autograd.grad(y, (xt, wt), torch.from_numpy(dy))
        gg.grouped_gemm_dw_torch(xt.detach(), torch.from_numpy(dy),
                                 torch.from_numpy(offsets), 20)
    assert reads.reads == 0


def test_cpu_tensors_take_the_plain_path(monkeypatch):
    def no_kernel(*a):
        raise AssertionError("a CUDA kernel was reached from CPU tensors")
    monkeypatch.setattr(gg, "_launch", no_kernel)
    monkeypatch.setattr(gg, "_launch_dw", no_kernel)
    before = gg.grouped_gemm.launches, gg.grouped_gemm.dw_launches
    x, w, dy, _, offsets = _inputs(CASES["random"])
    xt = torch.from_numpy(x).requires_grad_(True)
    y = gg.grouped_gemm(xt, torch.from_numpy(w), torch.from_numpy(offsets),
                        20)
    y.backward(torch.from_numpy(dy))
    assert (gg.grouped_gemm.launches, gg.grouped_gemm.dw_launches) == before


@pytest.mark.parametrize("M,K,N,E", [(6144, 6144, 10752, 16),   # dbrx
                                     (64, 7168, 2048, 256),     # deepseek
                                     (7, 24, 40, 3)])
def test_fake_rules_give_shapes_and_routed_flops(M, K, N, E):
    """On fake CUDA tensors (the dry run's card route) the wrapper reaches
    the op's fake rule -- nothing runs, nothing is counted as launched
    -- with the output's shape and ``FlopCounterMode`` counting 2 M K N;
    the census counts one would-be launch of K7.  ``GroupedGemm``'s
    backward (on fake CPU tensors: a CPU-only torch has no CUDA device
    guard for autograd's graph) reaches K7 for dX and K8 for dW, 2 M K N
    each."""
    before = gg.grouped_gemm.launches, gg.grouped_gemm.dw_launches
    with FakeTensorMode():
        x = torch.empty(M, K, dtype=torch.bfloat16, device="cuda")
        w = torch.empty(E, K, N, dtype=torch.bfloat16, device="cuda")
        offsets = torch.empty(E + 1, dtype=torch.int32, device="cuda")
        census = Census()
        with FlopCounterMode(display=False) as fc, census:
            y = gg.grouped_gemm(x, w, offsets, M)
        assert y.shape == (M, N) and y.dtype == torch.bfloat16
        assert y.device.type == "cuda"
        assert fc.get_total_flops() == 2 * M * K * N
        assert census.launches["grouped_gemm"] == 1

        x = torch.empty(M, K, dtype=torch.bfloat16).requires_grad_(True)
        w = torch.empty(E, K, N, dtype=torch.bfloat16).requires_grad_(True)
        offsets = torch.empty(E + 1, dtype=torch.int32)
        census = Census()
        with FlopCounterMode(display=False) as fc, census:
            y = gg.GroupedGemm.apply(x, w, offsets)
            dx, dw = torch.autograd.grad(y, (x, w), torch.empty_like(y))
        assert dx.shape == x.shape and dw.shape == w.shape
        assert fc.get_total_flops() == 3 * 2 * M * K * N
        assert census.launches["grouped_gemm"] == 2
        assert census.launches["grouped_gemm_dw"] == 1
    assert (gg.grouped_gemm.launches, gg.grouped_gemm.dw_launches) == before


def _fake_cuda(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="cuda")


class _Stream:
    cuda_stream = 0


@pytest.mark.parametrize("dtype,K,trans_w,error,match", [
    # passes the checks, then cannot build the kernel here
    (torch.bfloat16, 64, False, RuntimeError, "nvcc"),
    (torch.bfloat16, 64, True, RuntimeError, "nvcc"),
    (torch.float32, 64, False, RuntimeError, "nvcc"),
    (torch.float32, 12, False, RuntimeError, "nvcc"),   # any width in f32
    (torch.bfloat16, 12, False, ValueError, "multiple of 8"),
    (torch.float16, 64, False, TypeError, "kernels take"),
])
def test_cuda_request_launches_or_raises_never_falls_back(
        monkeypatch, dtype, K, trans_w, error, match):
    """On a CUDA tensor the op's CUDA kernels (``_launch``, ``_launch_dw``)
    go to the hand-written kernels and nowhere else: with no card and no
    nvcc that is an error, never the plain path.  A fake tensor would
    take the op's fake rule, so these fake tensors, standing for real
    ones, are given to the CUDA kernels themselves."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without a card")

    def no_fallback(*a, **kw):
        raise AssertionError("fell back to the plain version")
    monkeypatch.setattr(gg, "grouped_gemm_torch", no_fallback)
    monkeypatch.setattr(gg, "grouped_gemm_dw_torch", no_fallback)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: _Stream())
    before = gg.grouped_gemm.launches, gg.grouped_gemm.dw_launches
    E, N, M = 4, 32, 50
    with FakeTensorMode():
        w = _fake_cuda((E, K, N), dtype)
        offsets = torch.zeros(E + 1, dtype=torch.int32, device="cuda")
        x = _fake_cuda((M, N if trans_w else K), dtype)
        with pytest.raises(error, match=match):
            gg._launch(x, w, offsets, trans_w)
        with pytest.raises(error, match=match):
            gg._launch_dw(_fake_cuda((M, K), dtype), _fake_cuda((M, N), dtype),
                          offsets)
    assert (gg.grouped_gemm.launches, gg.grouped_gemm.dw_launches) == before
    for op in ("grouped_gemm", "grouped_gemm_dw"):
        assert torch._C._dispatch_has_kernel_for_dispatch_key(
            f"repro_torch::{op}", "CUDA")


def test_cuda_request_with_bad_operands_raises():
    """Offsets of the wrong length or type, strided rows and mismatched
    widths raise before any build."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without a card")
    with FakeTensorMode():
        w = _fake_cuda((4, 64, 32), torch.bfloat16)
        x = _fake_cuda((10, 64), torch.bfloat16)
        good = torch.zeros(5, dtype=torch.int32, device="cuda")
        for offsets in (torch.zeros(4, dtype=torch.int32, device="cuda"),
                        torch.zeros(5, dtype=torch.int64, device="cuda")):
            with pytest.raises(ValueError, match="offsets"):
                gg._launch(x, w, offsets, False)
        with pytest.raises(ValueError, match="strides"):
            gg._launch(_fake_cuda((64, 10), torch.bfloat16).t(), w, good,
                       False)
        with pytest.raises(ValueError, match="want x"):
            gg._launch(_fake_cuda((10, 32), torch.bfloat16), w, good, False)
        with pytest.raises(TypeError, match="first operand"):
            gg._launch(x, w.float(), good, False)
        with pytest.raises(ValueError, match="same rows"):
            gg._launch_dw(x, _fake_cuda((9, 32), torch.bfloat16), good)


def _stand_in(monkeypatch):
    calls = []

    def kernel(*args):
        calls.append(args)
        return 0
    monkeypatch.setattr(gg, "_fn", lambda name, n_int, n_long: kernel)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: _Stream())
    return calls


@pytest.mark.parametrize("trans_w", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_launch_arguments_follow_the_c_signature(monkeypatch, trans_w, dtype):
    """K7's C function takes 4 pointers (x, w, offsets, y), ``M, R, C, E,
    is_f32``, the strides ``sx, sw_e, sw_r, sw_c, sy`` in elements and
    the stream: 15 values.  The product's right operand ``w[g](r, c)``
    is w's (K, N) matrix, or with ``trans_w`` its transpose (the strides
    swapped), read in place from a strided view.  One launch counted a
    call, none for no rows."""
    calls = _stand_in(monkeypatch)
    E, K, N = 3, 24, 40
    base = torch.zeros(E, K, 2 * N, dtype=dtype)
    w = base[:, :, 8:8 + N]                       # a strided view
    x = torch.zeros(11, N if trans_w else K, dtype=dtype)
    offsets = torch.tensor([0, 4, 4, 11], dtype=torch.int32)
    before = gg.grouped_gemm.launches
    y = gg._launch(x, w, offsets, trans_w)
    assert gg.grouped_gemm.launches == before + 1
    (args,) = calls
    assert len(args) == 15
    assert args[:4] == (x.data_ptr(), w.data_ptr(), offsets.data_ptr(),
                        y.data_ptr())
    R, C = (N, K) if trans_w else (K, N)
    assert y.shape == (11, C)
    sw_r, sw_c = (1, 2 * N) if trans_w else (2 * N, 1)
    assert args[4:14] == (11, R, C, E, int(dtype == torch.float32),
                          x.stride(0), K * 2 * N, sw_r, sw_c, C)
    assert args[14] == 0
    gg._launch(x[:0], w, offsets, trans_w)
    assert gg.grouped_gemm.launches == before + 1 and len(calls) == 1


def test_dw_launch_arguments_follow_the_c_signature(monkeypatch):
    """K8's C function takes 4 pointers (x, dy, offsets, dw), ``M, K, N,
    E, is_f32``, the row strides ``sx, sdy`` and the stream: 12 values;
    dw is a fresh contiguous (E, K, N).  It launches for no rows too:
    every group is empty and its zeros must be written."""
    calls = _stand_in(monkeypatch)
    x = torch.zeros(9, 64, dtype=torch.bfloat16)
    dy = torch.zeros(9, 48, dtype=torch.bfloat16)
    offsets = torch.tensor([0, 0, 9], dtype=torch.int32)
    before = gg.grouped_gemm.dw_launches
    dw = gg._launch_dw(x, dy, offsets)
    assert dw.shape == (2, 64, 48) and dw.is_contiguous()
    (args,) = calls
    assert len(args) == 12
    assert args[:4] == (x.data_ptr(), dy.data_ptr(), offsets.data_ptr(),
                        dw.data_ptr())
    assert args[4:11] == (9, 64, 48, 2, 0, 64, 48) and args[11] == 0
    gg._launch_dw(x[:0], dy[:0], torch.zeros(3, dtype=torch.int32))
    assert gg.grouped_gemm.dw_launches == before + 2


def test_c_signatures_are_the_kernel_source():
    """The ctypes bindings' argument counts are the C functions'."""
    src = KERNEL_SOURCE.read_text()
    for name, n in (("grouped_gemm", 15), ("grouped_gemm_dw", 12)):
        m = re.search(rf'extern "C" int {name}\(([^)]*)\)', src)
        assert m and len(m.group(1).split(",")) == n, name


def test_bf16_group_limit_is_the_kernel_source():
    """K7's bf16 kernel takes at most kMaxGroups groups (its shared-memory
    prefix); the wrapper refuses more before any build, float32 not."""
    m = re.search(r"constexpr int kMaxGroups = (\d+);",
                  KERNEL_SOURCE.read_text())
    assert m and int(m.group(1)) == gg.MAX_BF16_GROUPS
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without a card")
    E = gg.MAX_BF16_GROUPS + 1
    with FakeTensorMode():
        offsets = torch.zeros(E + 1, dtype=torch.int32, device="cuda")
        with pytest.raises(ValueError, match="at most"):
            gg._launch(_fake_cuda((10, 64), torch.bfloat16),
                       _fake_cuda((E, 64, 32), torch.bfloat16), offsets,
                       False)
        with pytest.raises(RuntimeError, match="nvcc"):
            gg._launch(_fake_cuda((10, 64), torch.float32),
                       _fake_cuda((E, 64, 32), torch.float32), offsets,
                       False)


@pytest.fixture
def cpu_stand_ins():
    """The ops given CPU kernels for the length of a test: the plain
    versions, counting launches as K7 and K8 do, so that
    ``GroupedGemm``'s forward and backward run on CPU tensors."""
    def k7(x, w, offsets, trans_w):
        gg.grouped_gemm.launches += 1
        return gg.grouped_gemm_torch(
            x, w.transpose(1, 2) if trans_w else w, offsets, x.shape[0])

    def k8(x, dy, offsets):
        gg.grouped_gemm.dw_launches += 1
        return gg.grouped_gemm_dw_torch(x, dy, offsets, x.shape[0])
    with torch.library._scoped_library("repro_torch", "IMPL") as lib:
        lib.impl("grouped_gemm", k7, "CPU")
        lib.impl("grouped_gemm_dw", k8, "CPU")
        yield


def test_autograd_function_sends_dx_to_k7_and_dw_to_k8(cpu_stand_ins,
                                                       monkeypatch):
    """dbrx SMOKE's MoE block with its three products through
    ``GroupedGemm`` (the card's route): the plain route's output and
    gradients (x, router, every expert leaf), the forward launching K7
    three times and the backward K7 three times more (dX) and K8 three
    times (dW)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models import moe
    cfg = dataclasses.replace(get_config("dbrx-132b", "smoke"),
                              dtype="float32")
    p = build_model(cfg).init(seed=0, device="cpu")["blocks"]["p0"]["moe"]
    p = {k: v[0].detach().clone() for k, v in p.items()}
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32))

    def run():
        leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        xg = x.clone().requires_grad_(True)
        y, aux = moe.moe_apply_ragged(leaves, xg, cfg)
        grads = torch.autograd.grad((y * y).sum() + aux,
                                    [xg, *leaves.values()])
        return y.detach(), grads
    want_y, want = run()
    monkeypatch.setattr(moe, "grouped_gemm",
                        lambda x, w, o, m: gg.GroupedGemm.apply(x, w, o))
    before = gg.grouped_gemm.launches, gg.grouped_gemm.dw_launches
    got_y, got = run()
    assert (gg.grouped_gemm.launches - before[0],
            gg.grouped_gemm.dw_launches - before[1]) == (6, 3)
    np.testing.assert_allclose(got_y.numpy(), want_y.numpy(), rtol=0,
                               atol=F32_TOL * want_y.abs().max().item())
    for a, b in zip(got, want):
        assert b.abs().max() > 0
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=F32_TOL * b.abs().max().item())
