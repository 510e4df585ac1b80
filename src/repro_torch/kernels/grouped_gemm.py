"""Grouped GEMM: a mixture-of-experts layer's products over rows sorted
by expert, each expert's rows against its own weights.

Replaces ``jax.lax.ragged_dot`` at ``repro/models/moe.py:91-93`` (the
reference's ``moe_apply_ragged``; an XLA op, not a ``pallas_call``) and
its transpose under ``jax.grad``.  On the card it runs the hand-written
kernels of ``csrc/grouped_gemm.cu`` (the design notes are at the top of
that file): K7 computes ``Y[rows of g] = X[rows of g] W[g]`` and, on the
same weights read transposed, ``dX = dY W[g]^T``; K8 computes ``dW[g] =
X[rows of g]^T dY[rows of g]``, zeros for a group with no row.  Both
read the group offsets on the card and size their grids from the shapes
alone, so a decode step never waits on the host; neither uses atomics,
so a call repeats bit for bit.  bf16 on the tensor cores by ``wgmma``
(float32 sums) in a persistent, warp-specialised block: one producer
thread copies both operands by TMA, as they lie in memory, into a
4-stage ring of 128-byte-swizzled stages, and two consumer warpgroups
each multiply 64 rows of a 128 x 256 output tile; tiles are walked a
group at a time, row tiles fastest, so a group's weights are read from
device memory about once.  At dbrx-132b's prefill product K7 runs at
~515 TFLOP/s (1.09 x ``torch._grouped_mm``; the bound is 820.78 us of
operations), K8 at its training shape at ~489 (1.37 x); where the bytes
of the experts bound it, within 1.11-1.31 x that bound (``PERF.md``).
float32 runs in full float32 on the CUDA cores.

* :func:`grouped_gemm` -- the wrapper.  CPU tensors take the plain
  version; CUDA tensors go through :class:`GroupedGemm` (forward K7,
  backward K7 for dX and K8 for dW) and the ops
  ``torch.ops.repro_torch.grouped_gemm`` / ``grouped_gemm_dw``, whose
  CUDA kernels (:func:`_launch`, :func:`_launch_dw`) launch the
  hand-written kernels or raise (there is no fallback).
  ``grouped_gemm.launches`` counts K7's launches,
  ``grouped_gemm.dw_launches`` K8's (reached through the gradient).
* :func:`grouped_gemm_torch` / :func:`grouped_gemm_dw_torch` -- the plain
  PyTorch versions.  They read nothing back to the host: each row is
  scattered to ``[group, position in its group]`` of a zero
  ``(E, max_group, K)`` buffer, one ``torch.bmm`` runs against the
  stacked weights, and the rows are gathered back.  Every group must
  hold at most ``max_group`` rows.
* The fake rules: on a fake CUDA tensor (``FakeTensorMode``, the dry
  run of :mod:`repro_torch.launch.dryrun`) the ops give the output's
  shape and dtype and compute nothing; ``FlopCounterMode`` counts each
  at ``2 M K N``, the routed operations.

Contract (that of ``jax.lax.ragged_dot`` with ``group_sizes`` as
offsets): x ``(M, K)`` rows sorted by group; w ``(E, K, N)``; offsets
``(E + 1,)`` int32 on x's device, ``0 = offsets[0] <= ... <= offsets[E]
= M``, group g being rows ``[offsets[g], offsets[g + 1])``.  Returns
``(M, N)`` in x's dtype, row i ``x[i] @ w[g(i)]``.
"""
from __future__ import annotations

import ctypes

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build

DTYPES = (torch.bfloat16, torch.float32)
# K7's bf16 kernel keeps the prefix of its groups' tile counts in shared
# memory: at most this many groups (kMaxGroups in csrc/grouped_gemm.cu)
MAX_BF16_GROUPS = 2048


def _row_groups(offsets, M: int, device):
    """Each row's group and its position in the group, on the device."""
    rows = torch.arange(M, device=device)
    offsets = offsets.long()
    g = torch.searchsorted(offsets[1:].contiguous(), rows, right=True)
    return g, rows - offsets[g]


def grouped_gemm_torch(x, w, offsets, max_group: int):
    """Plain version: ``x (M, K) -> (M, N)``, row i times ``w[g(i)]``."""
    g, pos = _row_groups(offsets, x.shape[0], x.device)
    buf = x.new_zeros((w.shape[0], max_group, x.shape[1])).index_put(
        (g, pos), x)
    return torch.bmm(buf, w)[g, pos]


def grouped_gemm_dw_torch(x, dy, offsets, max_group: int):
    """Plain version of K8: ``dW[g] = x[rows of g]^T dy[rows of g]``,
    ``(E, K, N)``; zeros for an empty group."""
    E = offsets.shape[0] - 1
    g, pos = _row_groups(offsets, x.shape[0], x.device)
    xb = x.new_zeros((E, max_group, x.shape[1])).index_put((g, pos), x)
    db = dy.new_zeros((E, max_group, dy.shape[1])).index_put((g, pos), dy)
    return torch.bmm(xb.transpose(1, 2), db)


class GroupedGemm(torch.autograd.Function):
    """K7 forward; backward dX by K7 on the transposed weight, dW by K8."""

    @staticmethod
    def forward(ctx, x, w, offsets):
        ctx.save_for_backward(x, w, offsets)
        return torch.ops.repro_torch.grouped_gemm(x, w, offsets, False)

    @staticmethod
    def backward(ctx, dy):
        x, w, offsets = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.ops.repro_torch.grouped_gemm(dy, w, offsets, True)
        if ctx.needs_input_grad[1]:
            dw = torch.ops.repro_torch.grouped_gemm_dw(x, dy, offsets)
        return dx, dw, None


def grouped_gemm(x, w, offsets, max_group: int):
    """The grouped product: the plain version for CPU tensors (bounded
    by ``max_group`` rows a group), K7 (and its gradient, K7 and K8) for
    CUDA tensors, which need no bound."""
    if x.device.type == "cpu":
        return grouped_gemm_torch(x, w, offsets, max_group)
    if x.device.type != "cuda":
        raise ValueError(f"grouped_gemm: unsupported device {x.device}")
    return GroupedGemm.apply(x, w, offsets)


grouped_gemm.launches = 0
grouped_gemm.dw_launches = 0


_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("grouped_gemm(Tensor x, Tensor w, Tensor offsets, bool trans_w) "
            "-> Tensor")
_LIB.define("grouped_gemm_dw(Tensor x, Tensor dy, Tensor offsets) -> Tensor")


@torch.library.register_fake("repro_torch::grouped_gemm", lib=_LIB)
def _grouped_gemm_fake(x, w, offsets, trans_w):
    return x.new_empty((x.shape[0], w.shape[1] if trans_w else w.shape[2]))


@torch.library.register_fake("repro_torch::grouped_gemm_dw", lib=_LIB)
def _grouped_gemm_dw_fake(x, dy, offsets):
    return x.new_empty((offsets.shape[0] - 1, x.shape[1], dy.shape[1]))


@register_flop_formula(torch.ops.repro_torch.grouped_gemm)
def _grouped_gemm_flops(x_shape, w_shape, offsets_shape, trans_w,
                        out_shape=None, **kwargs) -> int:
    M, K = x_shape
    return 2 * M * K * (w_shape[1] if trans_w else w_shape[2])


@register_flop_formula(torch.ops.repro_torch.grouped_gemm_dw)
def _grouped_gemm_dw_flops(x_shape, dy_shape, offsets_shape,
                           out_shape=None, **kwargs) -> int:
    return 2 * x_shape[0] * x_shape[1] * dy_shape[1]


def _check_rows(name, t, dtype, device) -> None:
    """A (rows, columns) operand: the kernels' dtype and device, unit
    column stride; bf16 rows start on 16 bytes (TMA's tensor maps)."""
    if t.dim() != 2:
        raise ValueError(f"grouped_gemm: {name} is {tuple(t.shape)}; want "
                         f"(rows, columns)")
    _check_layout(name, t, dtype, device)


def _check_layout(name, t, dtype, device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"grouped_gemm: {name} is {t.dtype}, the first "
                        f"operand {dtype}")
    if t.device != device:
        raise ValueError(f"grouped_gemm: {name} on {t.device}, the first "
                         f"operand on {device}")
    if t.stride(-1) != 1 or (dtype == torch.bfloat16 and (
            t.shape[-1] % 8 or any(s % 8 for s in t.stride()[:-1])
            or t.data_ptr() % 16)):
        raise ValueError(f"grouped_gemm: {name} {tuple(t.shape)} strides "
                         f"{t.stride()} / alignment: want unit column "
                         f"strides and, in bf16, 16-byte aligned rows of a "
                         f"multiple of 8 columns")


def _check_offsets(offsets, E: int, device) -> None:
    if (offsets.dtype != torch.int32 or offsets.shape != (E + 1,)
            or offsets.device != device or not offsets.is_contiguous()):
        raise ValueError(f"grouped_gemm: offsets must be a contiguous "
                         f"({E + 1},) int32 tensor on the operands' device")


def _check(x, w, offsets, trans_w: bool) -> None:
    if x.dtype not in DTYPES:
        raise TypeError(f"grouped_gemm: x is {x.dtype}; the kernels take "
                        f"{DTYPES}")
    _check_rows("x", x, x.dtype, x.device)
    if w.dim() != 3 or x.shape[1] != w.shape[2 if trans_w else 1]:
        raise ValueError(f"grouped_gemm: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}{' transposed' * trans_w}: want "
                         f"x (M, K) and w (E, K, N)")
    _check_layout("w", w, x.dtype, x.device)
    if x.dtype == torch.bfloat16 and w.shape[1] % 8:
        raise ValueError(f"grouped_gemm: w {tuple(w.shape)}: in bf16 both "
                         f"of its matrix dimensions must be multiples of 8")
    if x.dtype == torch.bfloat16 and w.shape[0] > MAX_BF16_GROUPS:
        raise ValueError(f"grouped_gemm: {w.shape[0]} groups; the bf16 "
                         f"kernel takes at most {MAX_BF16_GROUPS}")
    _check_offsets(offsets, w.shape[0], x.device)


def _check_dw(x, dy, offsets) -> None:
    if x.dtype not in DTYPES:
        raise TypeError(f"grouped_gemm_dw: x is {x.dtype}; the kernels take "
                        f"{DTYPES}")
    _check_rows("x", x, x.dtype, x.device)
    _check_rows("dy", dy, x.dtype, x.device)
    if dy.shape[0] != x.shape[0]:
        raise ValueError(f"grouped_gemm_dw: x {tuple(x.shape)}, dy "
                         f"{tuple(dy.shape)}: want the same rows")
    _check_offsets(offsets, offsets.shape[0] - 1, x.device)


def _args(x, w, y, trans_w: bool) -> tuple:
    """K7's C arguments after the four pointers and before the stream:
    ``M, R, C, E, is_f32`` and the strides in elements ``sx, sw_e, sw_r,
    sw_c, sy``, where ``w[g](r, c)`` is the product's right operand (w's
    own (K, N) matrix, or with ``trans_w`` its transpose)."""
    E = w.shape[0]
    sw_r, sw_c = w.stride(1), w.stride(2)
    if trans_w:
        sw_r, sw_c = sw_c, sw_r
    return (x.shape[0], x.shape[1], y.shape[1], E,
            int(x.dtype == torch.float32), x.stride(0), w.stride(0), sw_r,
            sw_c, y.stride(0))


def _dw_args(x, dy, E: int) -> tuple:
    """K8's C arguments after the four pointers and before the stream:
    ``M, K, N, E, is_f32, sx, sdy``."""
    return (x.shape[0], x.shape[1], dy.shape[1], E,
            int(x.dtype == torch.float32), x.stride(0), dy.stride(0))


def _fn(name: str, n_int: int, n_long: int):
    fn = getattr(build.load("grouped_gemm"), name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * n_int
                       + [ctypes.c_longlong] * n_long + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(x, w, offsets, trans_w: bool):
    _check(x, w, offsets, trans_w)
    y = torch.empty((x.shape[0], w.shape[1] if trans_w else w.shape[2]),
                    dtype=x.dtype, device=x.device)
    if x.shape[0] == 0:
        return y
    kernel = _fn("grouped_gemm", 5, 5)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = kernel(x.data_ptr(), w.data_ptr(), offsets.data_ptr(), y.data_ptr(),
                *_args(x, w, y, trans_w), stream)
    if rc != 0:
        raise RuntimeError(f"grouped_gemm kernel launch failed: CUDA error "
                           f"{rc}")
    grouped_gemm.launches += 1
    return y


def _launch_dw(x, dy, offsets):
    _check_dw(x, dy, offsets)
    E = offsets.shape[0] - 1
    dw = torch.empty((E, x.shape[1], dy.shape[1]), dtype=x.dtype,
                     device=x.device)
    kernel = _fn("grouped_gemm_dw", 5, 2)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = kernel(x.data_ptr(), dy.data_ptr(), offsets.data_ptr(),
                dw.data_ptr(), *_dw_args(x, dy, E), stream)
    if rc != 0:
        raise RuntimeError(f"grouped_gemm_dw kernel launch failed: CUDA "
                           f"error {rc}")
    grouped_gemm.dw_launches += 1
    return dw


_LIB.impl("grouped_gemm", _launch, "CUDA")
_LIB.impl("grouped_gemm_dw", _launch_dw, "CUDA")
