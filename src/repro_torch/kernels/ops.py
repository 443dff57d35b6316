"""The model layer's entry to the kernels (``repro/kernels/ops.py``)."""
from __future__ import annotations

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rmsnorm import fused_rmsnorm as _fused_rmsnorm
from repro_torch.kernels.wkv6 import WKV_CHUNK_MAX, pad_to_chunk
from repro_torch.kernels.wkv6 import wkv6 as _wkv6


def flash_mha(q, k, v, *, causal=True, window=0):
    """q (B,S,H,D), k/v (B,T,KH,D) in the model layout -> (B,S,H,D).

    The (B,H,S,D) views handed to the kernels are transposes without a
    copy; K1 reads them through their strides and writes its output in q's
    layout, so the result is a contiguous (B,S,H,D) buffer on the card.
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


def wkv6(r, k, v, wlog, u, s0, *, chunk):
    """r/k/v/wlog (B,S,H,P), u (H,P), s0 (B,H,P,P) -> (o (B,S,H,P) fp32,
    s_end (B,H,P,P) fp32). The chunk is clamped to ``WKV_CHUNK_MAX``
    (``repro/kernels/vjp.py:124-130``) and S padded to a chunk multiple
    with zero r/k/v and a zero log-decay, so the state and the gradients
    pass the padded steps untouched. Differentiable through ``WKV6``: K6
    forward, K7 backward."""
    chunk = min(int(chunk), WKV_CHUNK_MAX)
    s = r.shape[1]
    r, k, v, wlog = pad_to_chunk((r, k, v, wlog), chunk)
    o, s_end = _wkv6(r, k, v, wlog, u, s0, chunk=chunk)
    return o[:, :s], s_end
