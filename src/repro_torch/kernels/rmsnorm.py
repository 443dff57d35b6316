"""Fused RMSNorm: the wrappers around ``csrc/rmsnorm.cu`` (K4 forward, K5
backward) and the autograd Function that joins them.

The port of ``repro/kernels/rmsnorm.py``: ``fused_rmsnorm_fwd`` launches K4
(``_fwd_kernel``) and returns ``(out, rinv)`` with the per-row inverse RMS
in fp32; ``fused_rmsnorm_bwd`` launches K5 (``_bwd_kernel``: dx, and dscale
summed over the rows without atomics, in a fixed order).
:class:`FusedRMSNorm` is the port of the reference's custom VJP
(``_rms_fwd``/``_rms_bwd``): its forward is K4 and saves x, scale and rinv,
its backward is K5, so gradients never come from autograd through the
forward. On a CUDA tensor each wrapper launches its hand-written kernel or
raises; only tensors on the CPU take the plain versions,
``kernels/ref.py::ref_rmsnorm_fwd`` and ``ref_rmsnorm_bwd``.

Each wrapper's ``.launches`` counts kernel calls (CPU calls do not count;
K5's two launches, the row pass and the dscale reduction, count as one).
The kernels take x and dy as (rows, D) with one row stride and a unit
stride on the last dim; ``row_layout.copies`` counts the inputs that had
another layout and were therefore copied.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ref_rmsnorm_bwd, ref_rmsnorm_fwd

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_D = 32768               # K5: a row in 1024 threads x 8 units of 4 fp32
_ROWS_MAX = 2 ** 31 - 1     # K4's grid.x
# K5's CTA count for large inputs (16 rows each at the decoder's 4096 rows,
# one wave of two 512-thread CTAs an SM on an H100): fixed, so that how rows
# are blocked, and so the order dscale is summed in, depends on the shape
# only
BWD_BLOCKS = 256


def _lib():
    lib = build.load("rmsnorm")
    if lib.repro_rmsnorm_fwd.argtypes is None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.repro_rmsnorm_fwd.argtypes = (
            [i32] + [ptr] * 4 + [i64, i32, i64, i64, ctypes.c_float, ptr])
        lib.repro_rmsnorm_bwd.argtypes = (
            [i32] + [ptr] * 7 + [i64, i32, i64, i64, i64, i32, i32, ptr])
        for fn in (lib.repro_rmsnorm_fwd, lib.repro_rmsnorm_bwd):
            fn.restype = i32
        lib.repro_cuda_error_string.argtypes = [i32]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check_shapes(x, scale):
    """Shape and dtype rules shared by the kernels and their plain
    versions: x (..., D) in bf16 or fp32, scale (D,) in fp32."""
    if x.ndim < 1 or scale.shape != x.shape[-1:]:
        raise ValueError(f"rmsnorm wants x (..., D) and scale (D,); got "
                         f"{tuple(x.shape)}, {tuple(scale.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"x must be float32 or bfloat16; got {x.dtype}")
    if scale.dtype != torch.float32:
        raise ValueError(f"scale must be float32; got {scale.dtype}")


def row_layout(x):
    """x as a (rows, D) view with a unit last stride, which the kernels
    take, else a contiguous copy (a copy, not a fallback: the kernels still
    run), counted in ``row_layout.copies``."""
    d = x.shape[-1]
    try:
        x2 = x.view(-1, d)
        if x2.stride(-1) == 1:
            return x2
    except RuntimeError:        # leading dims that no one stride spans
        pass
    row_layout.copies += 1
    return x.reshape(-1, d).clone(memory_format=torch.contiguous_format)


row_layout.copies = 0


def check_kernel_inputs(x2, scale):
    """What the CUDA kernels take, for x as (rows, D) and scale (D,);
    anything else raises (never falls back)."""
    rows, d = x2.shape
    if not 1 <= d <= MAX_D or not 1 <= rows <= _ROWS_MAX:
        raise ValueError(f"kernel shapes are 1 <= D <= {MAX_D} and 1 <= "
                         f"rows <= {_ROWS_MAX}; got rows={rows}, D={d}")
    if x2.stride(-1) != 1 or scale.stride(-1) != 1:
        raise ValueError(f"the kernels need a unit stride on the last dim; "
                         f"got {x2.stride()} and {scale.stride()}")


def _check_device(*xs):
    dev = xs[0].device
    if dev.type != "cuda" or any(x.device != dev for x in xs):
        raise ValueError(f"rmsnorm runs on cuda (kernel) or cpu (plain); "
                         f"got {[str(x.device) for x in xs]}")


def _launch(fn, name, device, args):
    """Call ``fn`` of the library on the current stream of ``device``;
    tensors pass as their pointers."""
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, fn)(*[a.data_ptr() if isinstance(a, torch.Tensor)
                                 else a for a in args], stream)
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           + lib.repro_cuda_error_string(err).decode())


def fused_rmsnorm_fwd(x, scale, eps=1e-6):
    """K4: x (..., D) -> (out (..., D) in x's dtype, rinv (rows,) fp32)."""
    check_shapes(x, scale)
    if x.device.type == "cpu" and scale.device.type == "cpu":
        return ref_rmsnorm_fwd(x, scale, eps)
    _check_device(x, scale)
    x2, scale = row_layout(x), row_layout(scale)[0]
    check_kernel_inputs(x2, scale)
    rows, d = x2.shape
    out = torch.empty((rows, d), dtype=x.dtype, device=x.device)
    rinv = torch.empty((rows,), dtype=torch.float32, device=x.device)
    _launch("repro_rmsnorm_fwd", "rmsnorm_fwd", x.device, (
        _DTYPE_CODE[x.dtype], x2, scale, out, rinv, rows, d, x2.stride(0),
        out.stride(0), float(eps)))
    fused_rmsnorm_fwd.launches += 1
    return out.view(x.shape), rinv


def bwd_blocks(rows):
    """K5's (rows per CTA, CTAs): the fewest rows per CTA that need at most
    ``BWD_BLOCKS`` CTAs; each CTA's dscale partial is one row of the
    (CTAs, D) fp32 workspace that the reduction launch sums in order."""
    per = -(-rows // BWD_BLOCKS)
    return per, -(-rows // per)


def fused_rmsnorm_bwd(x, scale, rinv, dy):
    """K5: (dx (..., D) in x's dtype, dscale (D,) in scale's dtype) from
    the forward's fp32 ``rinv``."""
    check_shapes(x, scale)
    rows = math.prod(x.shape[:-1])
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"dy must be {tuple(x.shape)} {x.dtype}; got "
                         f"{tuple(dy.shape)} {dy.dtype}")
    if rinv.shape != (rows,) or rinv.dtype != torch.float32:
        raise ValueError(f"rinv must be float32 ({rows},); got "
                         f"{rinv.dtype} {tuple(rinv.shape)}")
    if x.device.type == "cpu" and all(t.device.type == "cpu"
                                      for t in (scale, rinv, dy)):
        return ref_rmsnorm_bwd(x, scale, rinv, dy)
    _check_device(x, scale, rinv, dy)
    x2, dy2, scale = row_layout(x), row_layout(dy), row_layout(scale)[0]
    check_kernel_inputs(x2, scale)
    if not rinv.is_contiguous():
        raise ValueError("rinv must be contiguous, as K4 writes it")
    d = x2.shape[1]
    per, n_blocks = bwd_blocks(rows)
    dx = torch.empty((rows, d), dtype=x.dtype, device=x.device)
    ws = torch.empty((n_blocks, d), dtype=torch.float32, device=x.device)
    dscale = torch.empty((d,), dtype=scale.dtype, device=x.device)
    _launch("repro_rmsnorm_bwd", "rmsnorm_bwd", x.device, (
        _DTYPE_CODE[x.dtype], x2, scale, rinv, dy2, dx, ws, dscale, rows, d,
        x2.stride(0), dy2.stride(0), dx.stride(0), per, n_blocks))
    fused_rmsnorm_bwd.launches += 1
    return dx.view(x.shape), dscale


fused_rmsnorm_fwd.launches = 0
fused_rmsnorm_bwd.launches = 0


class FusedRMSNorm(torch.autograd.Function):
    """``out = rmsnorm(x) * scale`` with the K4 forward and the K5 backward
    (the reference's ``_rms_fwd``/``_rms_bwd``). The forward saves x, scale
    and the fp32 rinv; the backward returns dx in x's dtype and dscale in
    scale's."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        out, rinv = fused_rmsnorm_fwd(x, scale, eps)
        ctx.save_for_backward(x, scale, rinv)
        return out

    @staticmethod
    def backward(ctx, dy):
        x, scale, rinv = ctx.saved_tensors
        dx, dscale = fused_rmsnorm_bwd(x, scale, rinv, dy)
        return dx, dscale, None


def fused_rmsnorm(x, scale, *, eps=1e-6):
    """x (..., D) -> rmsnorm(x) * scale in x's dtype, differentiable
    through :class:`FusedRMSNorm`."""
    return FusedRMSNorm.apply(x, scale, eps)
