"""The model layer's entry to the kernels (``repro/kernels/ops.py``)."""
from __future__ import annotations

from repro_torch.kernels.flash_attention import flash_attention


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
