"""The model layer's entry to the kernels (``repro/kernels/ops.py``)."""
from __future__ import annotations

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rmsnorm import fused_rmsnorm as _fused_rmsnorm
from repro_torch.kernels.rmsnorm import split_rmsnorm as _split_rmsnorm
from repro_torch.kernels.wkv6 import built_chunk, pad_head_dim, \
    pad_to_chunk
from repro_torch.kernels.wkv6 import wkv6 as _wkv6


def flash_mha(q, k, v, *, causal=True, window=0):
    """q (B,S,H,D), k (B,T,KH,D), v (B,T,KH,Dv) in the model layout ->
    (B,S,H,Dv) (Dv = D but for MLA's (192, 128)).

    The (B,H,S,D) views handed to the kernels are transposes without a
    copy; K1 reads them through their strides and writes its output in q's
    layout, so the result is a contiguous (B,S,H,Dv) buffer on the card.
    Differentiable through ``FlashAttention``: K2 and K3 read dO through
    its strides too and write dq, dk, dv in the primals' layouts, so the
    transposes cost no copy on the way back either."""
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=causal, window=window)
    return out.transpose(1, 2)


def fused_rmsnorm(x, scale, *, eps=1e-6):
    """x (..., D) -> rmsnorm(x) * scale in x's dtype. Differentiable
    through ``FusedRMSNorm``: K4 forward saving the fp32 rinv, K5 backward
    for dx and dscale."""
    return _fused_rmsnorm(x, scale, eps=eps)


def split_rmsnorm(x, scale, *, eps, width, reduce, kernels=True):
    """RMSNorm of x (..., D), this part's D columns of rows ``width``
    wide, in x's dtype; ``reduce`` sums a per-row fp32 (rows,) tensor over
    the parts (an all-reduce over the model group). Differentiable
    through ``SplitRMSNorm``: with ``kernels`` the split-row K4 forward
    and K5 backward, each after a partial pass, else their plain
    versions."""
    return _split_rmsnorm(x, scale, eps=eps, width=width, reduce=reduce,
                          kernels=kernels)


def wkv6(r, k, v, wlog, u, s0, *, chunk):
    """r/k/v/wlog (B,S,H,P), u (H,P), s0 (B,H,P,P) -> (o (B,S,H,P) fp32,
    s_end (B,H,P,P) fp32). The chunk goes to a built one
    (``wkv6.built_chunk``: clamped to 32 as ``repro/kernels/vjp.py:124-130``
    clamps it, else 16), S is padded to a chunk multiple with zero r/k/v
    and a zero log-decay, so the state and the gradients pass the padded
    steps untouched, and a P outside {32, 64} is padded to the next
    (``wkv6.pad_head_dim``); o, s_end and, through autograd, the gradients
    are sliced back. Differentiable through ``WKV6``: K6 forward, K7
    backward."""
    chunk = built_chunk(int(chunk))
    s, p = r.shape[1], r.shape[3]
    r, k, v, wlog, u, s0 = pad_head_dim(r, k, v, wlog, u, s0)
    r, k, v, wlog = pad_to_chunk((r, k, v, wlog), chunk)
    o, s_end = _wkv6(r, k, v, wlog, u, s0, chunk=chunk)
    return o[:, :s, :, :p], s_end[..., :p, :p]
