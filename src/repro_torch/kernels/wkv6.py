"""WKV6: the wrappers around ``csrc/wkv6.cu`` (K6 forward, K7 backward) and
the autograd Function that joins them.

The port of ``repro/kernels/wkv6.py``: ``wkv6_fwd`` launches K6
(``_fwd_kernel``) and returns ``(o, s_end, states)``, with the fp32 state
entering every chunk when ``with_states`` (the backward's residual) and
``None`` otherwise (the reference's primal-only variant); ``wkv6_bwd``
launches K7 (``_bwd_kernel``: dr, dk, dv, dwlog, du, ds0). Each is two CUDA
launches behind one call: a scan over the chunks carries the only serial
quantity (K6: the state S, writing every S_c; K7: the state gradient,
writing every G_c to a scratch, :func:`bwd_scratch_shapes`), then every
chunk's outputs are computed in parallel. K6's primal-only call writes its
S_c to a scratch of the states' shape (:func:`fwd_scratch_shapes`) and
returns no states. :class:`WKV6` is the port of the
reference's custom VJP (``_wkv_fwd``/``_wkv_bwd``): its forward is K6 with
states and its backward is K7, so gradients never come from autograd
through the forward; ``wkv6`` takes the primal-only K6 when no gradient is
wanted.
On a CUDA tensor each wrapper launches its hand-written kernel or raises;
only tensors on the CPU take the plain versions,
``kernels/ref.py::ref_wkv6_fwd`` and ``ref_wkv6_bwd``.

Each wrapper's ``.launches`` counts one per call that launched its kernel
(CPU calls do not count). The kernels read r/k/v/wlog and dO through their
(B,S,H,P) strides, with a unit stride on the last dim; ``kernel_layout.copies``
counts the inputs that had another layout and were therefore copied.
``pad_to_chunk.pads`` counts the calls of ``ops.wkv6`` whose sequence was
padded to a chunk multiple. ``ops.wkv6`` also runs a head size P outside
``HEAD_DIMS`` at the next built one (:func:`pad_head_dim`: zero r, k, v,
u and s0 columns and a zero log-decay, whose rows and columns of the
state stay 0 and add exact zeros; P above 64 still raises, ROADMAP F2),
counted in ``pad_head_dim.pads``, and a chunk outside ``CHUNKS`` at a
built one (:func:`built_chunk`). The kernels then do, and the op counter
is charged with, the padded work. On ``meta`` tensors (the dry run) a wrapper
returns empty outputs of the kernel's shapes, launching nothing; there and
on the card it charges an active op counter with its kernel's work
(``launch/op_count.py::wkv6_work``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ref_wkv6_bwd, ref_wkv6_fwd
from repro_torch.launch import op_count

HEAD_DIMS = (32, 64)
CHUNKS = (16, 32)
WKV_CHUNK_MAX = 32          # repro/kernels/vjp.py:41, the largest chunk
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_BLOCKS_MAX = 2 ** 31 - 1   # grid.x: B * H * S / chunk (K6, K7)


def _lib():
    lib = build.load("wkv6")
    if lib.repro_wkv6_fwd.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        strides = ctypes.POINTER(ctypes.c_longlong)
        lib.repro_wkv6_fwd.argtypes = (
            [i32] * 3 + [ptr] * 9 + [i32] * 4 + [strides, ptr])
        lib.repro_wkv6_bwd.argtypes = (
            [i32] * 3 + [ptr] * 15 + [i32] * 4 + [strides, ptr])
        for fn in (lib.repro_wkv6_fwd, lib.repro_wkv6_bwd):
            fn.restype = i32
        lib.repro_cuda_error_string.argtypes = [i32]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check_inputs(r, k, v, wlog, u, s0, chunk):
    """Shape, dtype and size rules shared by the kernels and their plain
    versions: r/k/v (B,S,H,P) in one of bf16/fp32, wlog (B,S,H,P) in
    bf16/fp32, u (H,P) and s0 (B,H,P,P) in fp32, P in ``HEAD_DIMS``, chunk
    in ``CHUNKS`` and S a positive multiple of the chunk."""
    if r.ndim != 4 or any(x.shape != r.shape for x in (k, v, wlog)):
        raise ValueError(f"wkv6 wants r/k/v/wlog of one (B,S,H,P) shape; got "
                         f"{[tuple(x.shape) for x in (r, k, v, wlog)]}")
    b, s, h, p = r.shape
    if u.shape != (h, p) or s0.shape != (b, h, p, p):
        raise ValueError(f"wkv6 wants u {(h, p)} and s0 {(b, h, p, p)}; got "
                         f"{tuple(u.shape)}, {tuple(s0.shape)}")
    if not (r.dtype == k.dtype == v.dtype) or r.dtype not in _DTYPE_CODE \
            or wlog.dtype not in _DTYPE_CODE:
        raise ValueError(f"r/k/v share one dtype and wlog has its own, each "
                         f"float32 or bfloat16; got {r.dtype}, {k.dtype}, "
                         f"{v.dtype}, {wlog.dtype}")
    if u.dtype != torch.float32 or s0.dtype != torch.float32:
        raise ValueError(f"u and s0 must be float32; got {u.dtype}, "
                         f"{s0.dtype}")
    if p not in HEAD_DIMS or chunk not in CHUNKS:
        raise ValueError(f"the kernels take P in {HEAD_DIMS} and chunk in "
                         f"{CHUNKS}; got P={p}, chunk={chunk}")
    if s < chunk or s % chunk:
        raise ValueError(f"S={s} must be a positive multiple of the chunk "
                         f"{chunk} (ops.wkv6 pads)")
    if b * h * (s // chunk) > _BLOCKS_MAX:
        raise ValueError(f"B*H*S/chunk must be <= {_BLOCKS_MAX}")


def kernel_layout(x, dense=False):
    """``x`` itself when the kernels take it (a unit last stride, or dense
    when ``dense``), else a contiguous copy (a copy, not a fallback: the
    kernels still run), counted in ``kernel_layout.copies``."""
    if (x.is_contiguous() if dense else x.stride(-1) == 1):
        return x
    kernel_layout.copies += 1
    return x.contiguous()


kernel_layout.copies = 0


def pad_to_chunk(xs, chunk):
    """Each x (B,S,H,P) of ``xs`` with S zero-padded up to a chunk multiple
    (zero r/k/v and a zero log-decay: the padded steps neither add to the
    state nor decay it); a call that pads counts once in
    ``pad_to_chunk.pads``."""
    pad = -xs[0].shape[1] % chunk
    if not pad:
        return xs
    pad_to_chunk.pads += 1
    return tuple(torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
                 for x in xs)


pad_to_chunk.pads = 0


def built_chunk(chunk: int) -> int:
    """The built chunk a requested ``chunk`` runs at: ``WKV_CHUNK_MAX``
    (32) at 32 and above (the reference's clamp, ``vjp.py:124-130``), else
    16. The tile size is not part of the function: any chunk gives the same
    arithmetic."""
    return WKV_CHUNK_MAX if chunk >= WKV_CHUNK_MAX else min(CHUNKS)


def pad_head_dim(r, k, v, wlog, u, s0):
    """r/k/v/wlog (B,S,H,P), u (H,P) and s0 (B,H,P,P) zero-padded from a P
    outside ``HEAD_DIMS`` up to the next built one: the padded rows of the
    state (k's zero columns, decay e^0 = 1) and its columns (v's zero
    columns) stay 0, so o, s_end and the gradients on the true columns
    are exact. Raises above the largest (P > 64); a call that pads counts
    once in ``pad_head_dim.pads``."""
    p = r.shape[-1]
    if p in HEAD_DIMS:
        return r, k, v, wlog, u, s0
    if p > max(HEAD_DIMS):
        raise ValueError(f"the kernels take P up to {max(HEAD_DIMS)}; got "
                         f"P={p}")
    pad_head_dim.pads += 1
    extra = next(d for d in HEAD_DIMS if d > p) - p
    pad = torch.nn.functional.pad
    return (*(pad(x, (0, extra)) for x in (r, k, v, wlog, u)),
            pad(s0, (0, extra, 0, extra)))


pad_head_dim.pads = 0


def _check_device(*xs):
    dev = xs[0].device
    if dev.type not in ("cuda", "meta") or any(x.device != dev for x in xs):
        raise ValueError(f"wkv6 runs on cuda (kernel) or cpu (plain); got "
                         f"{[str(x.device) for x in xs]}")


def _strides(*xs):
    vals = [st for x in xs for st in x.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _launch(fn, name, device, args):
    """Call ``fn`` of the library on the current stream of ``device``;
    tensors pass as their pointers, None as a null pointer. On ``meta``
    nothing runs."""
    if device.type == "meta":
        return
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, fn)(*[
            a.data_ptr() if isinstance(a, torch.Tensor) else a
            for a in args], stream)
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           + lib.repro_cuda_error_string(err).decode())


def wkv6_fwd(r, k, v, wlog, u, s0, *, chunk, with_states):
    """K6: ``(o (B,S,H,P) fp32, s_end (B,H,P,P) fp32, states (B,H,NC,P,P)
    fp32 or None)``; ``states`` holds the state entering each chunk and is
    written only ``with_states``."""
    check_inputs(r, k, v, wlog, u, s0, chunk)
    xs = (r, k, v, wlog, u, s0)
    if all(x.device.type == "cpu" for x in xs):
        return ref_wkv6_fwd(*xs, chunk=chunk, with_states=with_states)
    _check_device(*xs)
    op_count.charge("wkv6_fwd", lambda: op_count.wkv6_work(
        (*r.shape, chunk), r.element_size(), wlog.element_size())[
            "fwd" if with_states else "primal"])
    out = _fwd_kernel(*xs, chunk, with_states)
    wkv6_fwd.launches += r.device.type == "cuda"
    return out


def _fwd_kernel(r, k, v, wlog, u, s0, chunk, with_states):
    """Launch K6 on checked inputs."""
    r, k, v, wlog = (kernel_layout(x) for x in (r, k, v, wlog))
    u, s0 = kernel_layout(u, dense=True), kernel_layout(s0, dense=True)
    b, s, h, p = r.shape
    f32 = {"dtype": torch.float32, "device": r.device}
    o = torch.empty((b, s, h, p), **f32)
    s_end = torch.empty((b, h, p, p), **f32)
    states = torch.empty(fwd_scratch_shapes(b, s, h, p, chunk), **f32)
    _launch("repro_wkv6_fwd", "wkv6_fwd", r.device, (
        _DTYPE_CODE[r.dtype], _DTYPE_CODE[wlog.dtype], p, r, k, v, wlog, u,
        s0, o, s_end, states, b, s, h, chunk, _strides(r, k, v, wlog)))
    return o, s_end, (states if with_states else None)


def fwd_scratch_shapes(b, s, h, p, chunk):
    """The fp32 buffer K6's scan writes the state entering every chunk to,
    (B,H,NC,P,P), and its chunk launch reads: the ``states`` output with
    states, else a scratch of the same shape (134.2 MB at B 4, S 1024, H 64,
    P 64, chunk 32), so that both variants run the same launches and give
    the same o and s_end."""
    return (b, h, s // chunk, p, p)


def bwd_scratch_shapes(b, s, h, p, chunk):
    """K7's fp32 buffers beside its outputs: ``(G scratch (B,H,NC,P,P), du
    partials (B,H,NC,P))``. The scan writes G_c = dLoss/dS_out of every
    chunk c to the scratch, the size of K6's ``states``; each chunk's CTA
    writes its du partial, which the wrapper sums over chunks, then over
    B."""
    nc = s // chunk
    return (b, h, nc, p, p), (b, h, nc, p)


def wkv6_bwd(r, k, v, wlog, u, states, do, ds_end, *, chunk):
    """K7: ``(dr, dk, dv, dwlog, du, ds0)`` from the forward's entering
    ``states`` and the fp32 cotangents ``do`` (B,S,H,P) and ``ds_end``
    (B,H,P,P): dr/dk/dv/dwlog in their primals' dtypes and layout (B,S,H,P),
    du (H,P) fp32 (K7's (B,H,NC,P) partials summed over chunks and then B
    here, in a fixed order) and ds0 (B,H,P,P) fp32."""
    b, s, h, p = r.shape
    check_inputs(r, k, v, wlog, u, ds_end, chunk)
    if states.shape != (b, h, s // chunk, p, p) or do.shape != r.shape or \
            not states.dtype == do.dtype == ds_end.dtype == torch.float32:
        raise ValueError(f"states must be float32 {(b, h, s // chunk, p, p)} "
                         f"and dO float32 {tuple(r.shape)}; got "
                         f"{states.dtype} {tuple(states.shape)}, {do.dtype} "
                         f"{tuple(do.shape)}")
    xs = (r, k, v, wlog, u, states, do, ds_end)
    if all(x.device.type == "cpu" for x in xs):
        return ref_wkv6_bwd(*xs, chunk=chunk)
    _check_device(*xs)
    op_count.charge("wkv6_bwd", lambda: op_count.wkv6_work(
        (b, s, h, p, chunk), r.element_size(), wlog.element_size())["bwd"])
    out = _bwd_kernel(*xs, chunk)
    wkv6_bwd.launches += r.device.type == "cuda"
    return out


def _bwd_kernel(r, k, v, wlog, u, states, do, ds_end, chunk):
    """Launch K7 on checked inputs; du summed over chunks and B here."""
    b, s, h, p = r.shape
    r, k, v, wlog, do = (kernel_layout(x) for x in (r, k, v, wlog, do))
    u, states, ds_end = (kernel_layout(x, dense=True)
                         for x in (u, states, ds_end))
    dr, dk, dv = (torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
                  for x in (r, k, v))
    dw = torch.empty((b, s, h, p), dtype=wlog.dtype, device=r.device)
    f32 = {"dtype": torch.float32, "device": r.device}
    ds0 = torch.empty((b, h, p, p), **f32)
    g_shape, du_shape = bwd_scratch_shapes(b, s, h, p, chunk)
    scratch, du = torch.empty(g_shape, **f32), torch.empty(du_shape, **f32)
    _launch("repro_wkv6_bwd", "wkv6_bwd", r.device, (
        _DTYPE_CODE[r.dtype], _DTYPE_CODE[wlog.dtype], p, r, k, v, wlog, u,
        states, do, ds_end, dr, dk, dv, dw, ds0, du, scratch, b, s, h, chunk,
        _strides(r, k, v, wlog, do)))
    return dr, dk, dv, dw, du.sum(2).sum(0), ds0


wkv6_fwd.launches = 0
wkv6_bwd.launches = 0


class WKV6(torch.autograd.Function):
    """``(o, s_end) = wkv6(r, k, v, wlog, u, s0)`` with the K6 forward and
    the K7 backward (the reference's ``_wkv_fwd``/``_wkv_bwd``,
    ``wkv6.py:355-365``). The forward writes the entering chunk states and
    saves them with the inputs. The backward casts dO and dS_end to fp32 (a
    None cotangent, as for the s_end the training path never reads, is
    taken as zeros) and returns each gradient in its primal's dtype."""

    @staticmethod
    def forward(ctx, r, k, v, wlog, u, s0, chunk):
        o, s_end, states = wkv6_fwd(r, k, v, wlog, u, s0, chunk=chunk,
                                    with_states=True)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, wlog, u, states)
        ctx.chunk, ctx.s0_meta = chunk, (s0.shape, s0.dtype)
        return o, s_end

    @staticmethod
    def backward(ctx, do, ds_end):
        r, k, v, wlog, u, states = ctx.saved_tensors
        s0_shape, s0_dtype = ctx.s0_meta
        f32 = {"dtype": torch.float32, "device": r.device}
        do = torch.zeros(r.shape, **f32) if do is None else do.to(
            torch.float32)
        ds_end = torch.zeros(s0_shape, **f32) if ds_end is None else \
            ds_end.to(torch.float32)
        dr, dk, dv, dw, du, ds0 = wkv6_bwd(r, k, v, wlog, u, states, do,
                                           ds_end, chunk=ctx.chunk)
        return dr, dk, dv, dw, du.to(u.dtype), ds0.to(s0_dtype), None


def wkv6(r, k, v, wlog, u, s0, *, chunk):
    """r/k/v/wlog (B,S,H,P) with S a chunk multiple, u (H,P), s0 (B,H,P,P)
    -> (o (B,S,H,P) fp32, s_end (B,H,P,P) fp32), differentiable through
    :class:`WKV6` when grad mode is on and an input needs a gradient;
    otherwise the primal-only K6, which writes no states (the reference's
    ``_wkv_primal``)."""
    xs = (r, k, v, wlog, u, s0)
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        return WKV6.apply(*xs, chunk)
    o, s_end, _ = wkv6_fwd(*xs, chunk=chunk, with_states=False)
    return o, s_end
