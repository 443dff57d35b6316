"""Plain PyTorch versions of the hand-written kernels.

``ref_attention`` is the plain version of K1 (``csrc/flash_fwd.cu``): the
CPU path of ``flash_attention_fwd`` and the oracle ``chip_smoke.py``
holds the kernel against on the card. It follows
``repro/kernels/ref.py::ref_attention`` and also returns the fp32 lse.
"""
from __future__ import annotations

import torch

NEG_INF = -2.0 ** 30
LSE_BIG = 2.0 ** 30     # lse of a fully-masked row


def ref_attention(q, k, v, *, causal=True, window=0):
    """Exact softmax attention. q (B,H,S,D), k/v (B,KH,T,D|Dv), GQA
    internal (``kv_head = h // (H // KH)``). window: 0 = full, > 0 keeps
    ``q_pos - k_pos < window``.

    Returns ``(out (B,H,S,Dv) in v's dtype, lse (B,H,S) fp32)``: lse is
    the logsumexp of the masked, scaled fp32 scores. A row with no live key
    (only possible with a window and S > T) gets out 0 and lse ``2**30``,
    as the kernel and the reference's pruned Pallas grid give it."""
    b, h, s, d = q.shape
    kh, t = k.shape[1], k.shape[2]
    g = h // kh
    qg = q.reshape(b, kh, g, s, d)
    scores = torch.einsum("bkgsd,bktd->bkgst", qg.to(torch.float32),
                          k.to(torch.float32)) * (d ** -0.5)
    qp = torch.arange(s, device=q.device)[:, None]
    kp = torch.arange(t, device=q.device)[None, :]
    ok = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kp <= qp
    if window:
        ok &= (qp - kp) < window
    scores = torch.where(ok, scores, NEG_INF)
    lse = torch.logsumexp(scores, dim=-1)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,bktd->bkgsd", w.to(v.dtype), v)
    live = ok.any(dim=-1)                                   # (S,)
    lse = torch.where(live, lse, LSE_BIG)
    out = torch.where(live[:, None], out, 0)
    return out.reshape(b, h, s, v.shape[-1]), lse.reshape(b, h, s)
