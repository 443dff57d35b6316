"""Plain PyTorch versions of the hand-written kernels.

``ref_attention`` is the plain version of K1 (``csrc/flash_fwd.cu``): the
CPU path of ``flash_attention_fwd`` and the oracle ``chip_smoke.py``
holds the kernel against on the card. It follows
``repro/kernels/ref.py::ref_attention`` and also returns the fp32 lse.
``ref_attention_bwd`` is the plain version of K2 and K3
(``csrc/flash_bwd.cu``), in the same two roles for the backward.
"""
from __future__ import annotations

import torch

NEG_INF = -2.0 ** 30
LSE_BIG = 2.0 ** 30     # lse of a fully-masked row


def _live_mask(s, t, *, causal, window, device):
    """(S, T) bool mask of the live (query, key) pairs."""
    qp = torch.arange(s, device=device)[:, None]
    kp = torch.arange(t, device=device)[None, :]
    ok = torch.ones((s, t), dtype=torch.bool, device=device)
    if causal:
        ok &= kp <= qp
    if window:
        ok &= (qp - kp) < window
    return ok


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
    ok = _live_mask(s, t, causal=causal, window=window, device=q.device)
    scores = torch.where(ok, scores, NEG_INF)
    lse = torch.logsumexp(scores, dim=-1)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,bktd->bkgsd", w.to(v.dtype), v)
    live = ok.any(dim=-1)                                   # (S,)
    lse = torch.where(live, lse, LSE_BIG)
    out = torch.where(live[:, None], out, 0)
    return out.reshape(b, h, s, v.shape[-1]), lse.reshape(b, h, s)


def ref_attention_bwd(q, k, v, out, lse, do, *, causal=True, window=0,
                      delta=None):
    """The attention backward from the forward's saved fp32 ``lse``, by
    the formulas of the Pallas ``_dq_kernel``/``_dkv_kernel``, all in fp32:
    Δ = rowsum(dO∘O), P = exp(S·scale − lse), dS = P∘(dO·Vᵀ − Δ)·scale,
    dq = dS·K, dk = dSᵀ·Q and dv = Pᵀ·dO summed over each GQA group.
    Masked pairs give P = dS = 0, so a fully-masked row (lse ``2**30``)
    contributes nothing.

    Returns ``(dq, dk, dv, delta)``: each gradient in its primal's dtype,
    delta (B,H,S) fp32. A given ``delta`` (K2's, for the plain K3) is used
    as it is, and ``out`` is then not read."""
    b, h, s, d = q.shape
    kh, t, dv_dim = k.shape[1], k.shape[2], v.shape[-1]
    g = h // kh
    f32 = torch.float32
    scale = d ** -0.5
    qf = q.to(f32).reshape(b, kh, g, s, d)
    dof = do.to(f32).reshape(b, kh, g, s, dv_dim)
    kf, vf = k.to(f32), v.to(f32)
    if delta is None:
        delta = (dof * out.to(f32).reshape(b, kh, g, s, dv_dim)).sum(-1)
    else:
        delta = delta.to(f32).reshape(b, kh, g, s)
    ok = _live_mask(s, t, causal=causal, window=window, device=q.device)
    scores = torch.einsum("bkgsd,bktd->bkgst", qf, kf) * scale
    lse = lse.to(f32).reshape(b, kh, g, s, 1)
    p = torch.where(ok, torch.exp(scores - lse), 0.0)
    dp = torch.einsum("bkgsd,bktd->bkgst", dof, vf)
    ds = torch.where(ok, p * (dp - delta[..., None]), 0.0) * scale
    dq = torch.einsum("bkgst,bktd->bkgsd", ds, kf)
    dk = torch.einsum("bkgst,bkgsd->bktd", ds, qf)
    dv = torch.einsum("bkgst,bkgsd->bktd", p, dof)
    return (dq.reshape(b, h, s, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype), delta.reshape(b, h, s))
