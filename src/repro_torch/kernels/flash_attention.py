"""Flash attention: the wrappers around ``csrc/flash_fwd.cu`` (K1) and
``csrc/flash_bwd.cu`` (K2, K3), and the autograd Function that joins them.

The port of ``repro/kernels/flash_attention.py``: ``flash_attention_fwd``
launches K1 (``_fwd_kernel``), ``flash_attention_bwd_dq`` K2
(``_dq_kernel``) and ``flash_attention_bwd_dkv`` K3 (``_dkv_kernel``).
:class:`FlashAttention` is the port of the reference's custom-VJP harness
(``kernels/vjp.py``, ``_flash_fwd``/``_flash_bwd``): its forward is K1 and
saves the fp32 lse, its backward is K2 then K3, so gradients never come
from autograd through the forward. On a CUDA tensor each wrapper launches
its hand-written kernel or raises; only tensors on the CPU take the plain
versions, ``kernels/ref.py::ref_attention`` and ``ref_attention_bwd``.

Each kernel takes two routes by dtype: bf16 runs on the tensor cores
(``mma.sync``), fp32 on the CUDA cores (the fp32 gate of 1e-4 rules out
TF32). Each wrapper's ``.launches`` counts one per call that launched its
kernel (CPU calls do not count), so a run can show that its attention went
through the kernels.
``kernel_layout.copies`` counts the output gradients whose strides the
backward kernels do not take and that were therefore copied to a
contiguous buffer.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ref_attention, ref_attention_bwd

HEAD_DIMS = (32, 64, 128)
KEY_TILE = 64               # keys per K3 CTA where no library is loaded
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_GRID_MAX = 65535           # grid.y (heads) and grid.z (batch)
_ALIGN = 8                  # element strides: the kernel moves 8-element chunks


def _lib_bwd():
    lib = build.load("flash_bwd")
    if lib.repro_flash_bwd_dq.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        common = ([i32, i32] + [ptr] * 8 + [i32] * 5
                  + [ctypes.POINTER(ctypes.c_longlong)]
                  + [i32, i32, ctypes.c_float])
        lib.repro_flash_bwd_dq.argtypes = common + [ptr]
        lib.repro_flash_bwd_dkv.argtypes = common + [i32, ptr, ptr]
        for fn in (lib.repro_flash_bwd_dq, lib.repro_flash_bwd_dkv):
            fn.restype = i32
        for fn in (lib.repro_flash_key_tile, lib.repro_flash_query_tile):
            fn.argtypes = []
            fn.restype = i32
        lib.repro_cuda_error_string.argtypes = [i32]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _lib():
    lib = build.load("flash_fwd")
    if lib.repro_flash_fwd.argtypes is None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.repro_flash_fwd.argtypes = (
            [i32, i32] + [ptr] * 5 + [i32] * 5 + [i64] * 12
            + [i32, i32, ctypes.c_float, ptr])
        lib.repro_flash_fwd.restype = i32
        lib.repro_cuda_error_string.argtypes = [i32]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check_shapes(q, k, v):
    """Shape rules shared by the kernel and its plain version."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash attention wants q (B,H,S,D), k/v (B,KH,T,D)")
    b, h, _, d = q.shape
    if k.shape[0] != b or v.shape[0] != b or k.shape[1] != v.shape[1] \
            or k.shape[2] != v.shape[2] or k.shape[3] != d:
        raise ValueError(f"mismatched q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if h % k.shape[1]:
        raise ValueError(f"{h} query heads not divisible by {k.shape[1]} "
                         f"kv heads")


def _check_strides(name, x):
    if x.stride(-1) != 1 or any(st % _ALIGN for st in x.stride()[:3]) \
            or x.data_ptr() % 16:
        raise ValueError(
            f"{name}: the kernel needs a contiguous last dim, the other "
            f"strides multiples of {_ALIGN} elements and a 16-byte "
            f"aligned start; got strides {x.stride()}")


def check_kernel_inputs(q, k, v):
    """What the CUDA kernels take; anything else raises (never falls back)."""
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise ValueError(f"kernel dtypes are float32 or bfloat16, all equal;"
                         f" got {q.dtype}, {k.dtype}, {v.dtype}")
    d, dv = q.shape[-1], v.shape[-1]
    if d not in HEAD_DIMS or dv != d:
        raise ValueError(f"kernel head dims are D = Dv in {HEAD_DIMS}; got "
                         f"D={d}, Dv={dv}")
    if q.shape[0] > _GRID_MAX or q.shape[1] > _GRID_MAX:
        raise ValueError(f"batch and heads must be <= {_GRID_MAX}")
    if min(q.shape[2], k.shape[2]) < 1:
        raise ValueError("empty sequence")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_strides(name, x)


def _check_device(*xs):
    dev = xs[0].device
    if dev.type != "cuda" or any(x.device != dev for x in xs):
        raise ValueError(f"flash attention runs on cuda (kernel) or cpu "
                         f"(plain); got {[str(x.device) for x in xs]}")


def flash_attention_fwd(q, k, v, *, causal=True, window=0):
    """q (B,H,S,D), k/v (B,KH,T,D) -> (out (B,H,S,D) in q's dtype, lse
    (B,H,S) fp32). ``out`` keeps q's memory layout, so a (B,S,H,D) view in
    gives a (B,S,H,D) buffer out."""
    check_shapes(q, k, v)
    if q.device.type == "cpu":
        out, lse = ref_attention(q, k, v, causal=causal, window=window)
        return out.to(q.dtype), lse
    _check_device(q, k, v)
    check_kernel_inputs(q, k, v)
    b, h, s, d = q.shape
    kh, t = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_flash_fwd(
            _DTYPE_CODE[q.dtype], d, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), lse.data_ptr(), b, h, kh, s, t,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], int(bool(causal)), int(window), d ** -0.5,
            stream)
    if err:
        raise RuntimeError("flash_fwd launch failed: "
                           + lib.repro_cuda_error_string(err).decode())
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def _bwd_inputs(q, k, v, lse, do):
    """Checks shared by K2 and K3; returns dO in a layout they take."""
    check_shapes(q, k, v)
    _check_device(q, k, v, lse, do)
    check_kernel_inputs(q, k, v)
    if do.shape != q.shape or lse.shape != q.shape[:3]:
        raise ValueError(f"dO must be {tuple(q.shape)} and lse "
                         f"{tuple(q.shape[:3])}; got {tuple(do.shape)}, "
                         f"{tuple(lse.shape)}")
    if do.dtype != q.dtype or lse.dtype != torch.float32 or \
            not lse.is_contiguous():
        raise ValueError(f"dO in q's dtype {q.dtype}, lse contiguous "
                         f"float32; got {do.dtype}, {lse.dtype}")
    return kernel_layout(do)


def kernel_layout(do):
    """``do`` itself when K2/K3 take its strides, else a contiguous copy
    (a copy, not a fallback: the kernels still run), counted in
    ``kernel_layout.copies``."""
    try:
        _check_strides("dO", do)
        return do
    except ValueError:
        kernel_layout.copies += 1
        # a fresh buffer: contiguous and aligned (``contiguous()`` would
        # hand back a contiguous view with a misaligned start as it is)
        return do.clone(memory_format=torch.contiguous_format)


kernel_layout.copies = 0


def _launch(fn, name, args):
    """Call ``fn`` of the K2/K3 library on the current stream of the
    tensors' card (``args[2]`` is q); tensors pass as their pointers."""
    lib = _lib_bwd()
    with torch.cuda.device(args[2].device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, fn)(*[a.data_ptr() if isinstance(a, torch.Tensor)
                                 else a for a in args], stream)
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           + lib.repro_cuda_error_string(err).decode())


def _strides(*xs):
    vals = [st for x in xs for st in x.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def flash_attention_bwd_dq(q, k, v, out, lse, do, *, causal=True, window=0):
    """K2: (dq (B,H,S,D) in q's dtype and memory layout, Δ = rowsum(dO∘O)
    (B,H,S) fp32) from the forward's ``out`` and fp32 ``lse``."""
    if q.device.type == "cpu":
        dq, _, _, delta = ref_attention_bwd(q, k, v, out, lse, do,
                                            causal=causal, window=window)
        return dq, delta
    do = _bwd_inputs(q, k, v, lse, do)
    _check_device(q, out)
    if out.shape != q.shape or out.dtype != q.dtype:
        raise ValueError(f"out must be {tuple(q.shape)} {q.dtype}; got "
                         f"{tuple(out.shape)} {out.dtype}")
    _check_strides("out", out)
    b, h, s, d = q.shape
    dq = torch.empty_like(q)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    _launch("repro_flash_bwd_dq", "flash_bwd_dq", (
        _DTYPE_CODE[q.dtype], d, q, k, v, out, do, lse, dq, delta, b, h,
        k.shape[1], s, k.shape[2], _strides(q, k, v, do, out, dq),
        int(bool(causal)), int(window), d ** -0.5))
    flash_attention_bwd_dq.launches += 1
    return dq, delta


class DkvSplit(NamedTuple):
    gs: int                 # CTAs that share one GQA group's query heads
    scratch_shape: tuple    # fp32 partials (gs, 2, B, KH, T, D); () if none


def dkv_group_split(b, kh, t, d, group, n_sm, key_tile=KEY_TILE):
    """How K3's bf16 kernel splits each GQA group of ``group`` query heads:
    over ``gs`` CTAs, the smallest divisor of ``group`` that gives at least
    two CTAs per SM (``n_sm`` SMs), or the whole group where none does; 1
    where the unsplit grid of ceil(T/key_tile) x KH x B CTAs already does.
    The wrapper passes the built kernel's own ``key_tile``. With ``gs`` > 1
    each CTA writes fp32 partial dk, dv that a second launch sums in a
    fixed order, into scratch of ``scratch_shape``."""
    ctas = -(-t // key_tile) * kh * b
    gs = next((g for g in range(1, group + 1)
               if group % g == 0 and ctas * g >= 2 * n_sm), group)
    return DkvSplit(gs, (gs, 2, b, kh, t, d) if gs > 1 else ())


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, *, causal=True,
                            window=0):
    """K3: (dk, dv), each in its primal's dtype and memory layout, summed
    over the GQA group, from the fp32 ``lse`` and K2's ``delta``. In bf16
    the group may be split over CTAs (:func:`dkv_group_split`); the kernel's
    two launches then count as one."""
    if q.device.type == "cpu":
        _, dk, dv, _ = ref_attention_bwd(q, k, v, None, lse, do,
                                         causal=causal, window=window,
                                         delta=delta)
        return dk, dv
    do = _bwd_inputs(q, k, v, lse, do)
    if delta.shape != lse.shape or delta.dtype != torch.float32 or \
            not delta.is_contiguous() or delta.device != q.device:
        raise ValueError("delta must be a contiguous float32 (B,H,S) "
                         "tensor on q's device")
    b, h, s, d = q.shape
    kh, t = k.shape[1], k.shape[2]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    split, scratch = DkvSplit(1, ()), None
    if q.dtype == torch.bfloat16:   # fp32 takes the CUDA-core kernel, unsplit
        split = dkv_group_split(b, kh, t, d, h // kh, torch.cuda
                                .get_device_properties(q.device)
                                .multi_processor_count,
                                _lib_bwd().repro_flash_key_tile())
        if split.gs > 1:
            scratch = torch.empty(split.scratch_shape, dtype=torch.float32,
                                  device=q.device)
    _launch("repro_flash_bwd_dkv", "flash_bwd_dkv", (
        _DTYPE_CODE[q.dtype], d, q, k, v, do, lse, delta, dk, dv, b, h,
        kh, s, t, _strides(q, k, v, do, dk, dv),
        int(bool(causal)), int(window), d ** -0.5, split.gs, scratch))
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0


class FlashAttention(torch.autograd.Function):
    """``out = attention(q, k, v)`` with K1 forward and the K2, K3
    backward (the reference's ``_flash_fwd``/``_flash_bwd``,
    ``flash_attention.py:617-629``). The forward saves (q, k, v, out, lse);
    the backward returns dq, dk and dv in the primals' dtypes."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        kw = {"causal": ctx.causal, "window": ctx.window}
        dq, delta = flash_attention_bwd_dq(q, k, v, out, lse, do, **kw)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal=True, window=0):
    """q (B,H,S,D), k/v (B,KH,T,D) -> (B,H,S,D) in q's dtype,
    differentiable through :class:`FlashAttention`."""
    return FlashAttention.apply(q, k, v, causal, window)
