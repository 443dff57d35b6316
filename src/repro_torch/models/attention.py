"""Multi-head attention on (B, S, H, hd) tensors (``repro.models.attention``).

``attention_block`` projects with ``x @ w`` (weights stored (in, out)),
adds the qkv bias and rotates q and k (the decoders; ViT has neither),
then sends the product to the flash kernels (``kernels.ops.flash_mha``,
which take causal masks and GQA) when ``cfg.use_kernels`` is set, else to
the naive :func:`sdpa`. Decode caches and the logit softcap are not ported.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ops import flash_mha
from repro_torch.models.rope import apply_rope

NEG_INF = -2.0 ** 30   # finite: keeps fully-masked rows NaN-free


def _mask(s, t, *, causal, window, device):
    """(S, T) bool mask of the live (query, key) pairs."""
    qp = torch.arange(s, device=device)[:, None]
    kp = torch.arange(t, device=device)[None, :]
    ok = torch.ones((s, t), dtype=torch.bool, device=device)
    if causal:
        ok &= kp <= qp
    if window > 0:
        ok &= (qp - kp) < window
    return ok


def sdpa(q, k, v, mask):
    """q (B,S,H,hd), k/v (B,T,KH,hd), mask broadcastable to (B,KH,G,S,T).

    Scores and softmax in fp32; the weights are cast to the compute dtype
    before P·V, as the reference does (``attention.py:89``)."""
    b, s, h, hd = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh
    qg = q.reshape(b, s, kh, g, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.to(torch.float32),
                          k.to(torch.float32)) * (hd ** -0.5)
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w, v)
    return out.reshape(b, s, h, v.shape[-1])


def attention_block(p, x, cfg, *, window, positions=None):
    """p: this layer's {wq, wk, wv, wo} (and {bq, bk, bv} with
    ``cfg.qkv_bias``); x (B,S,D) in the compute dtype; positions (B,S) for
    the rope (unused when ``cfg.rope_style`` is "none")."""
    b, s, _ = x.shape
    h, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = x.dtype
    q, k, v = (x @ p[w].to(dt) for w in ("wq", "wk", "wv"))
    if cfg.qkv_bias:
        q, k, v = (t + p[bias].to(dt)
                   for t, bias in zip((q, k, v), ("bq", "bk", "bv")))
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, kh, hd)
    v = v.reshape(b, s, kh, hd)
    if cfg.rope_style != "none":
        q, k = apply_rope(q, k, positions, style=cfg.rope_style,
                          theta=cfg.rope_theta)
    if cfg.use_kernels:
        out = flash_mha(q, k, v, causal=cfg.causal, window=window)
    else:
        mask = _mask(s, s, causal=cfg.causal, window=window, device=x.device)
        out = sdpa(q, k, v, mask)
    return out.reshape(b, s, h * hd) @ p["wo"].to(dt)
