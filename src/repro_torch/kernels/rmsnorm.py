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

The split row (tensor parallelism's Mamba2 inner norm: each rank of a
model group holds D of a row's W columns) cuts each whole-row pass in two
around an all-reduce of a per-row fp32 sum: ``fused_rmsnorm_sumsq`` (the
rows' sums of squares) and ``fused_rmsnorm_fwd_split`` (K4 in its split
mode, from the whole rows' sums) in the forward, ``fused_rmsnorm_bwd_dot``
(the rows' ``rowsum(dy∘s∘x)``) and ``fused_rmsnorm_bwd_split`` (K5 in its
split mode) in the backward; :class:`SplitRMSNorm` joins them with the
caller's all-reduce. Their plain versions are ``kernels/ref.py``'s
``ref_rmsnorm_sumsq``, ``_apply``, ``_bwd_dot`` and ``_bwd_apply``.

Each wrapper's ``.launches`` counts kernel calls (CPU calls do not count;
K5's two launches, the row pass and the dscale reduction, count as one).
The kernels take x and dy as (rows, D) with one row stride and a unit
stride on the last dim; ``row_layout.copies`` counts the inputs that had
another layout and were therefore copied. On ``meta`` tensors (the dry
run) a wrapper returns empty outputs of the kernel's shapes, launching
nothing; there and on the card it charges an active op counter with its
kernel's work (``launch/op_count.py::rms_work``; the split row's partial
pass is counted with its apply, as the kernel table's bound counts the
pair).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.launch import op_count
from repro_torch.kernels.ref import ref_rmsnorm_apply, ref_rmsnorm_bwd, \
    ref_rmsnorm_bwd_apply, ref_rmsnorm_bwd_dot, ref_rmsnorm_fwd, \
    ref_rmsnorm_sumsq

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
        f32 = ctypes.c_float
        lib.repro_rmsnorm_rowdot.argtypes = (
            [i32] + [ptr] * 4 + [i64, i32, i64, i64, ptr])
        lib.repro_rmsnorm_fwd_split.argtypes = (
            [i32] + [ptr] * 5 + [i64, i32, i64, i64, f32, f32, ptr])
        lib.repro_rmsnorm_bwd_split.argtypes = (
            [i32] + [ptr] * 8 + [i64, i32, i64, i64, i64, f32, i32, i32,
                                 ptr])
        for fn in (lib.repro_rmsnorm_fwd, lib.repro_rmsnorm_bwd,
                   lib.repro_rmsnorm_rowdot, lib.repro_rmsnorm_fwd_split,
                   lib.repro_rmsnorm_bwd_split):
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


def check_kernel_inputs(x2, scale=None):
    """What the CUDA kernels take, for x as (rows, D) and scale (D,);
    anything else raises (never falls back)."""
    rows, d = x2.shape
    if not 1 <= d <= MAX_D or not 1 <= rows <= _ROWS_MAX:
        raise ValueError(f"kernel shapes are 1 <= D <= {MAX_D} and 1 <= "
                         f"rows <= {_ROWS_MAX}; got rows={rows}, D={d}")
    if x2.stride(-1) != 1 or scale is not None and scale.stride(-1) != 1:
        raise ValueError(f"the kernels need a unit stride on the last dim; "
                         f"got {x2.stride()} and "
                         f"{None if scale is None else scale.stride()}")


def _check_device(*xs):
    dev = xs[0].device
    if dev.type not in ("cuda", "meta") or any(x.device != dev for x in xs):
        raise ValueError(f"rmsnorm runs on cuda (kernel) or cpu (plain); "
                         f"got {[str(x.device) for x in xs]}")


def _launch(fn, name, device, args):
    """Call ``fn`` of the library on the current stream of ``device``;
    tensors pass as their pointers. Returns 1 (a launch), or 0 on
    ``meta``, where nothing runs."""
    if device.type == "meta":
        return 0
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, fn)(*[a.data_ptr() if isinstance(a, torch.Tensor)
                                 else a for a in args], stream)
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           + lib.repro_cuda_error_string(err).decode())
    return 1


def _charge(name, part, x2, split=False):
    """Charge an active op counter with ``op_count.rms_work``'s ``part``
    at x2's (rows, D)."""
    op_count.charge(name, lambda: op_count.rms_work(
        x2.shape[0], x2.shape[1], x2.element_size(), split)[part])


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
    _charge("rmsnorm_fwd", "fwd", x2)
    fused_rmsnorm_fwd.launches += _launch(
        "repro_rmsnorm_fwd", "rmsnorm_fwd", x.device, (
        _DTYPE_CODE[x.dtype], x2, scale, out, rinv, rows, d, x2.stride(0),
        out.stride(0), float(eps)))
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
    _charge("rmsnorm_bwd", "bwd", x2)
    fused_rmsnorm_bwd.launches += _launch(
        "repro_rmsnorm_bwd", "rmsnorm_bwd", x.device, (
        _DTYPE_CODE[x.dtype], x2, scale, rinv, dy2, dx, ws, dscale, rows, d,
        x2.stride(0), dy2.stride(0), dx.stride(0), per, n_blocks))
    return dx.view(x.shape), dscale


def _check_sums(t, rows, what):
    if t.shape != (rows,) or t.dtype != torch.float32 or \
            not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous float32 ({rows},); "
                         f"got {t.dtype} {tuple(t.shape)}")


def fused_rmsnorm_sumsq(x):
    """The split row's forward partial pass: x (..., D) in bf16 or fp32 ->
    each row's fp32 sum of squares over its D columns (rows,)."""
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"x must be float32 or bfloat16; got {x.dtype}")
    if x.device.type == "cpu":
        return ref_rmsnorm_sumsq(x)
    _check_device(x)
    x2 = row_layout(x)
    check_kernel_inputs(x2)
    rows, d = x2.shape
    out = torch.empty((rows,), dtype=torch.float32, device=x.device)
    fused_rmsnorm_sumsq.launches += _launch(
        "repro_rmsnorm_rowdot", "rmsnorm_sumsq", x.device, (
        _DTYPE_CODE[x.dtype], x2, None, None, out, rows, d, x2.stride(0), 0))
    return out


def fused_rmsnorm_fwd_split(x, scale, sumsq, width, eps=1e-6):
    """K4's split mode: x (..., D), this part's scale (D,) fp32 and the
    whole rows' fp32 sums of squares (rows,) over their ``width`` columns
    -> (out (..., D) in x's dtype, rinv (rows,) fp32)."""
    check_shapes(x, scale)
    rows = math.prod(x.shape[:-1])
    _check_sums(sumsq, rows, "sumsq")
    if x.device.type == "cpu" and scale.device.type == "cpu" and \
            sumsq.device.type == "cpu":
        return ref_rmsnorm_apply(x, scale, sumsq, width, eps)
    _check_device(x, scale, sumsq)
    x2, scale = row_layout(x), row_layout(scale)[0]
    check_kernel_inputs(x2, scale)
    d = x2.shape[1]
    out = torch.empty((rows, d), dtype=x.dtype, device=x.device)
    rinv = torch.empty((rows,), dtype=torch.float32, device=x.device)
    _charge("rmsnorm_fwd_split", "fwd", x2, split=True)
    fused_rmsnorm_fwd_split.launches += _launch(
        "repro_rmsnorm_fwd_split", "rmsnorm_fwd_split", x.device, (
        _DTYPE_CODE[x.dtype], x2, scale, sumsq, out, rinv, rows, d,
        x2.stride(0), out.stride(0), float(width), float(eps)))
    return out.view(x.shape), rinv


def fused_rmsnorm_bwd_dot(x, scale, dy):
    """The split row's backward partial pass: each row's fp32
    ``rowsum(dy∘s∘x)`` over its D columns (rows,)."""
    check_shapes(x, scale)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"dy must be {tuple(x.shape)} {x.dtype}; got "
                         f"{tuple(dy.shape)} {dy.dtype}")
    if x.device.type == "cpu" and scale.device.type == "cpu" and \
            dy.device.type == "cpu":
        return ref_rmsnorm_bwd_dot(x, scale, dy)
    _check_device(x, scale, dy)
    x2, dy2, scale = row_layout(x), row_layout(dy), row_layout(scale)[0]
    check_kernel_inputs(x2, scale)
    rows, d = x2.shape
    out = torch.empty((rows,), dtype=torch.float32, device=x.device)
    fused_rmsnorm_bwd_dot.launches += _launch(
        "repro_rmsnorm_rowdot", "rmsnorm_bwd_dot", x.device, (
        _DTYPE_CODE[x.dtype], x2, scale, dy2, out, rows, d, x2.stride(0),
        dy2.stride(0)))
    return out


def fused_rmsnorm_bwd_split(x, scale, rinv, dy, dot, width):
    """K5's split mode: (dx (..., D) in x's dtype, this part's dscale (D,))
    from the forward's fp32 ``rinv`` and the whole rows' fp32
    ``rowsum(dy∘s∘x)`` (rows,) over their ``width`` columns."""
    check_shapes(x, scale)
    rows = math.prod(x.shape[:-1])
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"dy must be {tuple(x.shape)} {x.dtype}; got "
                         f"{tuple(dy.shape)} {dy.dtype}")
    _check_sums(rinv, rows, "rinv")
    _check_sums(dot, rows, "dot")
    if all(t.device.type == "cpu" for t in (x, scale, rinv, dy, dot)):
        return ref_rmsnorm_bwd_apply(x, scale, rinv, dy, dot, width)
    _check_device(x, scale, rinv, dy, dot)
    x2, dy2, scale = row_layout(x), row_layout(dy), row_layout(scale)[0]
    check_kernel_inputs(x2, scale)
    d = x2.shape[1]
    per, n_blocks = bwd_blocks(rows)
    dx = torch.empty((rows, d), dtype=x.dtype, device=x.device)
    ws = torch.empty((n_blocks, d), dtype=torch.float32, device=x.device)
    dscale = torch.empty((d,), dtype=scale.dtype, device=x.device)
    _charge("rmsnorm_bwd_split", "bwd", x2, split=True)
    fused_rmsnorm_bwd_split.launches += _launch(
        "repro_rmsnorm_bwd_split", "rmsnorm_bwd_split", x.device, (
        _DTYPE_CODE[x.dtype], x2, scale, rinv, dy2, dot, dx, ws, dscale,
        rows, d, x2.stride(0), dy2.stride(0), dx.stride(0), float(width),
        per, n_blocks))
    return dx.view(x.shape), dscale


for _fn in (fused_rmsnorm_fwd, fused_rmsnorm_bwd, fused_rmsnorm_sumsq,
            fused_rmsnorm_fwd_split, fused_rmsnorm_bwd_dot,
            fused_rmsnorm_bwd_split):
    _fn.launches = 0
del _fn


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


class SplitRMSNorm(torch.autograd.Function):
    """RMSNorm over a row split by columns: this part's ``out = x · rinv ·
    scale`` with ``rinv`` from the whole row's sum of squares. The forward
    takes this part's sums (``sumsq``), has ``reduce`` sum them over the
    parts (an all-reduce over the ranks that hold the row), then applies;
    the backward likewise sums ``rowsum(dy∘s∘x)`` before dx. dscale is
    this part's. ``kernels``: the split-row K4/K5 wrappers (the kernels
    on the card), else their plain versions on any device."""

    @staticmethod
    def forward(ctx, x, scale, eps, width, reduce, kernels):
        sumsq, apply = (fused_rmsnorm_sumsq, fused_rmsnorm_fwd_split) \
            if kernels else (ref_rmsnorm_sumsq, ref_rmsnorm_apply)
        out, rinv = apply(x, scale, reduce(sumsq(x)), width, eps)
        ctx.save_for_backward(x, scale, rinv)
        ctx.width, ctx.reduce, ctx.kernels = width, reduce, kernels
        return out

    @staticmethod
    def backward(ctx, dy):
        x, scale, rinv = ctx.saved_tensors
        dot, apply = (fused_rmsnorm_bwd_dot, fused_rmsnorm_bwd_split) \
            if ctx.kernels else (ref_rmsnorm_bwd_dot, ref_rmsnorm_bwd_apply)
        dy = dy.to(x.dtype)
        dx, dscale = apply(x, scale, rinv, dy, ctx.reduce(dot(x, scale, dy)),
                           ctx.width)
        return dx, dscale, None, None, None, None


def split_rmsnorm(x, scale, *, eps, width, reduce, kernels=True):
    """x (..., D), this part of rows ``width`` wide -> rmsnorm(x) * scale
    in x's dtype, through :class:`SplitRMSNorm`; ``reduce`` maps a
    (rows,) fp32 tensor to its sum over the parts."""
    return SplitRMSNorm.apply(x, scale, eps, width, reduce, kernels)
