"""K1, the flash-attention forward: the wrapper around ``csrc/flash_fwd.cu``.

The port of ``repro/kernels/flash_attention.py:_fwd_kernel`` (public
``flash_attention_fwd`` / ``flash_attention``). On a CUDA tensor the
wrapper launches the hand-written kernel or raises; only tensors on the CPU
take the plain version, ``kernels/ref.py::ref_attention``. The backward
kernels (K2, K3) come with the training slice.

``flash_attention_fwd.launches`` counts kernel launches (CPU calls do not
count), so a run can show that its attention went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ref_attention

HEAD_DIMS = (32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_GRID_MAX = 65535           # grid.y (heads) and grid.z (batch)
_ALIGN = 8                  # element strides: the kernel moves 8-element chunks


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


def check_kernel_inputs(q, k, v):
    """What the CUDA kernel takes; anything else raises (never falls back)."""
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
        if x.stride(-1) != 1 or any(st % _ALIGN for st in x.stride()[:3]) \
                or x.data_ptr() % 16:
            raise ValueError(
                f"{name}: the kernel needs a contiguous last dim, the other "
                f"strides multiples of {_ALIGN} elements and a 16-byte "
                f"aligned start; got strides {x.stride()}")


def flash_attention_fwd(q, k, v, *, causal=True, window=0):
    """q (B,H,S,D), k/v (B,KH,T,D) -> (out (B,H,S,D) in q's dtype, lse
    (B,H,S) fp32). ``out`` keeps q's memory layout, so a (B,S,H,D) view in
    gives a (B,S,H,D) buffer out."""
    check_shapes(q, k, v)
    if q.device.type == "cpu":
        out, lse = ref_attention(q, k, v, causal=causal, window=window)
        return out.to(q.dtype), lse
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash attention runs on cuda (kernel) or cpu "
                         f"(plain); got {q.device}, {k.device}, {v.device}")
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


def flash_attention(q, k, v, *, causal=True, window=0):
    """q (B,H,S,D), k/v (B,KH,T,D) -> (B,H,S,D) in q's dtype."""
    return flash_attention_fwd(q, k, v, causal=causal, window=window)[0]
