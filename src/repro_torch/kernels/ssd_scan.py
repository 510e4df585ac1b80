"""Mamba2 SSD chunk scan: the state-space-duality form of the selective
scan, chunk by chunk with a state carried across chunks.

Replaces the TPU kernel ``repro/kernels/ssd_scan.py::ssd_scan_pallas``
(body ``_ssd_kernel``, wrapper ``repro/kernels/ops.py::ssd_chunk_scan``,
oracle ``repro/kernels/ref.py::ssd_scan_ref``).  On the card it runs the
hand-written CUDA kernel in ``csrc/ssd_scan.cu``; the design notes are at
the top of that file.  In short: the call is bound by its bytes (16.4 us
at the evaluation shape; its 15.3 GFLOP take 15.5 us on the bf16 tensor
cores), so every chunk runs at once instead of one walk per (batch,
head): chunk states, a pass over the chunks in order, then each chunk's
output, three launches of one C entry point.  Every product runs on the
tensor cores (``mma.sync`` bf16, float32 accumulator); a float32 operand
is split into bf16 parts (two for bf16 inputs, three for float32), which
holds float32 accuracy.  x, B, C and dt are read in place in the model's
layouts (head ``h`` reads group ``h // (H // G)``).  The wrapper
allocates the float32 workspace of chunk states
(:func:`workspace_floats`) through PyTorch's caching allocator; nothing
syncs with the host.

* :func:`ssd_chunk_scan` — the wrapper.  CPU tensors take the plain
  version; CUDA tensors launch the kernel or raise (there is no
  fallback).  ``ssd_chunk_scan.launches`` counts calls of the kernel's
  entry point (its three launches count once): a Mamba2 evaluation pass
  with ``use_pallas_ssd`` makes one a layer, 24 for mamba2-130m.
* :func:`ssd_chunk_scan_torch` — the plain PyTorch version: the chunked
  einsum form of :func:`ssd_chunked`, in float32.
* :func:`ssd_chunked` — that chunked form with its final state: the
  model's scan where the kernel is not taken (training, prefill), as
  the reference's ``models/ssm.py::ssd_chunked``.

Contract (that of the reference's ``ops.ssd_chunk_scan``): x
``(B, S, H, hd)``, B_/C_ ``(B, S, G, N)``, dt ``(B, S, H)``, A_log
``(H,)``; ``chunk = min(chunk, S)`` must divide S.  With ``a =
-exp(A_log)`` and per chunk ``cum = cumsum(dt * a)``:

    y_t = sum_{s <= t in the chunk} (C_t . B_s) exp(cum_t - cum_s) dt_s x_s
          + exp(cum_t) C_t . state
    state <- exp(cum_end) state + sum_s exp(cum_end - cum_s) dt_s x_s (x) B_s

Returns y ``(B, S, H, hd)`` in x's dtype, or in ``out_dtype`` (float32
gives the sums before the final rounding).

Neither version has a gradient, as the reference's Pallas kernel has
none: the wrapper raises when autograd would need one.  A train step
takes :func:`ssd_chunked` (``use_pallas_ssd=False``), the reference's
only trainable setting.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

MAX_HEAD_DIM = 64      # one 64-column tile of the output
MAX_D_STATE = 128
MAX_CHUNK = 1024       # a chunk's dt and cum live in shared memory
DTYPES = (torch.float32, torch.bfloat16)


def expand_groups(t, H: int):
    """(B, ..., G, N) -> (B, ..., H, N) by repeating groups."""
    G = t.shape[-2]
    return t.repeat_interleave(H // G, dim=-2) if G != H else t


def ssd_chunked(x, B_, C_, dt, A_log, c: int, *, out_dtype=None):
    """The chunked SSD scan in float32 (the reference's ``ssd_chunked``).

    x: (B, S, H, hd), B_/C_: (B, S, G, N), dt: (B, S, H).  Returns y
    (B, S, H, hd) in ``out_dtype`` (x's dtype by default) and the final
    state (B, H, hd, N) float32.

    Above the diagonal of a chunk ``exp(cum_t - cum_s)`` may overflow to
    inf (cum falls by about 180 over a chunk of 256 at FULL's seeded
    weights); ``torch.where`` selects 0 there, as the reference's
    ``jnp.where`` does, so the forward is finite.  Its gradient is not:
    inf times the mask's 0 is NaN, in the reference as here, which is
    why a train step takes a chunk of 64.
    """
    Bsz, S, H, hd = x.shape
    N = B_.shape[-1]
    if S % c:
        raise ValueError(f"ssd_chunked: chunk {c} does not divide S={S}")
    nc = S // c
    a = -torch.exp(A_log.float())                      # (H,)

    xf = x.float().reshape(Bsz, nc, c, H, hd)
    Bc = expand_groups(B_.float(), H).reshape(Bsz, nc, c, H, N)
    Cc = expand_groups(C_.float(), H).reshape(Bsz, nc, c, H, N)
    dtc = dt.float().reshape(Bsz, nc, c, H)

    da = dtc * a                                       # (B, nc, c, H) <= 0
    cum = torch.cumsum(da, dim=2)

    # intra-chunk quadratic term
    att = torch.einsum("bzthn,bzshn->bztsh", Cc, Bc)   # (B, nc, c, c, H)
    L = torch.exp(cum[:, :, :, None, :] - cum[:, :, None, :, :])
    tri = torch.ones((c, c), dtype=torch.bool, device=x.device).tril()
    w = torch.where(tri[None, None, :, :, None], att * L, 0.0) \
        * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bztsh,bzshd->bzthd", w, xf)

    # chunk summaries -> inter-chunk recurrence
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)  # (B, nc, c, H)
    s_chunk = torch.einsum("bzsh,bzshn,bzshd->bzhdn",
                           dtc * decay_to_end, Bc, xf)  # (B, nc, H, hd, N)
    chunk_decay = torch.exp(cum[:, :, -1, :])          # (B, nc, H)
    state = torch.zeros((Bsz, H, hd, N), dtype=torch.float32,
                        device=x.device)
    prevs = []
    for z in range(nc):
        prevs.append(state)
        state = state * chunk_decay[:, z, :, None, None] + s_chunk[:, z]
    states_prev = torch.stack(prevs, dim=1)            # (B, nc, H, hd, N)

    y_inter = torch.einsum("bzthn,bzhdn,bzth->bzthd",
                           Cc, states_prev, torch.exp(cum))
    y = (y_intra + y_inter).reshape(Bsz, S, H, hd)
    return y.to(out_dtype or x.dtype), state


def _chunk(chunk: int, S: int) -> int:
    """The reference's ``chunk = min(chunk, S)``, which must divide S."""
    chunk = min(chunk, S)
    if chunk <= 0 or S % chunk:
        raise ValueError(f"ssd_chunk_scan: chunk {chunk} does not divide "
                         f"S={S}")
    return chunk


def ssd_chunk_scan_torch(x, B_, C_, dt, A_log, *, chunk: int = 128,
                         out_dtype=None):
    """Plain PyTorch version: :func:`ssd_chunked` without its state."""
    c = _chunk(chunk, x.shape[1])
    return ssd_chunked(x, B_, C_, dt, A_log, c, out_dtype=out_dtype)[0]


def ssd_chunk_scan(x, B_, C_, dt, A_log, *, chunk: int = 128,
                   out_dtype=None):
    """The SSD scan without a state in or out: the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors.  Raises if a gradient
    would be needed."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, B_, C_, dt, A_log)):
        raise RuntimeError(
            "ssd_chunk_scan has no gradient (neither has the reference's "
            "Pallas kernel): call it under torch.no_grad(), or train with "
            "use_pallas_ssd=False")
    if x.device.type == "cpu":
        return ssd_chunk_scan_torch(x, B_, C_, dt, A_log, chunk=chunk,
                                    out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunk_scan: unsupported device {x.device}")
    return _launch(x, B_, C_, dt, A_log, _chunk(chunk, x.shape[1]),
                   out_dtype or x.dtype)


ssd_chunk_scan.launches = 0


def _check(x, B_, C_, dt, A_log, chunk: int, out_dtype) -> None:
    if x.dim() != 4 or B_.dim() != 4:
        raise ValueError(f"ssd_chunk_scan: x {tuple(x.shape)}, B_ "
                         f"{tuple(B_.shape)}: want (B, S, H, hd) and "
                         f"(B, S, G, N)")
    Bsz, S, H, hd = x.shape
    G, N = B_.shape[2], B_.shape[3]
    if (B_.shape[:2] != (Bsz, S) or C_.shape != B_.shape
            or dt.shape != (Bsz, S, H) or A_log.shape != (H,)
            or G == 0 or H % G):
        raise ValueError(f"ssd_chunk_scan: x {tuple(x.shape)}, B_ "
                         f"{tuple(B_.shape)}, C_ {tuple(C_.shape)}, dt "
                         f"{tuple(dt.shape)}, A_log {tuple(A_log.shape)}: "
                         f"want (B, S, H, hd), (B, S, G, N) twice, (B, S, H), "
                         f"(H,) with G dividing H")
    if not 0 < hd <= MAX_HEAD_DIM or not 0 < N <= MAX_D_STATE:
        raise ValueError(f"ssd_chunk_scan: head_dim {hd} / d_state {N}: the "
                         f"kernel takes head_dim <= {MAX_HEAD_DIM} and "
                         f"d_state <= {MAX_D_STATE}")
    if chunk > MAX_CHUNK:
        raise ValueError(f"ssd_chunk_scan: chunk {chunk} > {MAX_CHUNK}")
    if out_dtype not in DTYPES:
        raise TypeError(f"ssd_chunk_scan: out_dtype {out_dtype}; the kernel "
                        f"writes {DTYPES}")
    for name, t in (("x", x), ("B_", B_), ("C_", C_), ("dt", dt),
                    ("A_log", A_log)):
        if t.dtype not in DTYPES or (name != "A_log"
                                     and t.dtype != x.dtype):
            raise TypeError(f"ssd_chunk_scan: {name} is {t.dtype}; the "
                            f"kernel takes x, B_, C_ and dt all float32 or "
                            f"all bfloat16")
        if t.device != x.device:
            raise ValueError(f"ssd_chunk_scan: {name} on {t.device}, x on "
                             f"{x.device}")
    for name, t in (("x", x), ("B_", B_), ("C_", C_)):
        if t.stride(-1) != 1:
            raise ValueError(f"ssd_chunk_scan: {name} strides {t.stride()}: "
                             f"the last dim must be contiguous")


def workspace_floats(Bsz: int, S: int, H: int, hd: int, N: int,
                     chunk: int) -> int:
    """The kernel's float32 workspace: a (hd, N) state and a cum_end for
    every (batch, head, chunk) but each sequence's last chunk."""
    return Bsz * H * (S // chunk - 1) * (hd * N + 1)


def _kernel():
    fn = build.load("ssd_scan").ssd_scan
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 9 + [ctypes.c_longlong] * 12
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(x, B_, C_, dt, A_log, chunk: int, out_dtype):
    _check(x, B_, C_, dt, A_log, chunk, out_dtype)
    kernel = _kernel()
    Bsz, S, H, hd = x.shape
    G, N = B_.shape[2], B_.shape[3]
    out = torch.empty((Bsz, S, H, hd), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    a_log = A_log.float().contiguous()       # (H,): a = -exp(A_log) in-kernel
    ws_floats = workspace_floats(Bsz, S, H, hd, N, chunk)
    ws = torch.empty(ws_floats, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    strides = [s for t in (x, B_, C_, dt) for s in t.stride()[:3]]
    rc = kernel(x.data_ptr(), B_.data_ptr(), C_.data_ptr(), dt.data_ptr(),
                a_log.data_ptr(), out.data_ptr(), ws.data_ptr(), ws_floats,
                Bsz, S, H, hd, G, N, chunk, int(x.dtype == torch.bfloat16),
                int(out_dtype == torch.bfloat16), *strides, stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {rc}")
    ssd_chunk_scan.launches += 1
    return out
