"""Blockwise (flash) attention in plain PyTorch (``repro.models.blockwise``).

The reference's XLA-lowerable flash: an online softmax over key blocks in
the forward, and the standard flash backward that recomputes P from the
saved fp32 lse block by block (``_bw_bwd``), so no (S, T) score matrix is
ever held and gradients never come from autograd through the loop. The
reference scans with ``lax.scan``; here Python loops run the key blocks
and, in :func:`blockwise_attention_qchunked`, the query tiles. It holds no
TPU kernel: it is the ``attn_impl="blockwise"`` path of
``models/attention.py``, taken only where the flash kernels are off.

Layouts as ``models/attention.py``: q (B,S,H,D), k (B,T,KH,D), v
(B,T,KH,Dv), GQA folded inside; causal mask and sliding window (0 = full).
As the reference's ``_prep`` does, the key block shrinks until it divides
T, and q is pre-scaled by D^-0.5 in its own dtype (a bf16 q is rounded
after the scaling, before any product); the products accumulate in fp32.
"""
from __future__ import annotations

import torch

from repro_torch.launch import op_count

NEG_INF = -2.0 ** 30


def _mask_block(q0, k0, bq, bk, *, causal, window, device):
    """(bq, bk) bool mask of the live pairs of a tile at offsets q0, k0."""
    qp = q0 + torch.arange(bq, device=device)[:, None]
    kp = k0 + torch.arange(bk, device=device)[None, :]
    ok = torch.ones((bq, bk), dtype=torch.bool, device=device)
    if causal:
        ok &= kp <= qp
    if window > 0:
        ok &= (qp - kp) < window
    return ok


def _prep(q, k, block_k):
    """(q pre-scaled in its dtype as (B,S,KH,G,D), the key block)."""
    b, s, h, d = q.shape
    kh, t = k.shape[2], k.shape[1]
    bk = min(block_k, t)
    while t % bk:
        bk -= 1
    scale = torch.tensor(d ** -0.5, dtype=q.dtype, device=q.device)
    return (q * scale).reshape(b, s, kh, h // kh, d), bk


def _fwd_scan(qg, k, v, *, causal, window, block_k, q_offset):
    """qg (B,S,KH,G,D) pre-scaled -> (out (B,S,KH,G,Dv), lse (B,S,KH,G)),
    both fp32."""
    b, s, kh, g, _ = qg.shape
    t, dv = k.shape[1], v.shape[-1]
    qf = qg.float()
    m = torch.full((b, kh, g, s), NEG_INF, device=qg.device)
    l = torch.zeros((b, kh, g, s), device=qg.device)
    acc = torch.zeros((b, kh, g, s, dv), device=qg.device)
    for k0 in op_count.repeat(range(0, t, block_k)):
        kblk = k[:, k0:k0 + block_k].float()
        vblk = v[:, k0:k0 + block_k]
        scores = torch.einsum("bskgd,btkd->bkgst", qf, kblk)
        mb = _mask_block(q_offset, k0, s, block_k, causal=causal,
                         window=window, device=qg.device)
        scores = torch.where(mb, scores, NEG_INF)
        m_new = torch.maximum(m, scores.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgst,btkd->bkgsd", p.to(v.dtype).float(), vblk.float())
        m = m_new
    lse = m + torch.log(torch.clamp_min(l, 1e-30))
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4), lse.permute(0, 3, 1, 2)


class BlockwiseAttention(torch.autograd.Function):
    """The reference's ``blockwise_attention`` custom VJP: the forward
    saves (q, k, v, out, fp32 lse); the backward recomputes P per key
    block and returns dq, dk, dv in the primals' dtypes."""

    @staticmethod
    def forward(ctx, q, k, v, window, q_offset, causal, block_k):
        qg, bk = _prep(q, k, block_k)
        out, lse = _fwd_scan(qg, k, v, causal=causal, window=window,
                             block_k=bk, q_offset=q_offset)
        b, s, kh, g, dv = out.shape
        o = out.reshape(b, s, kh * g, dv).to(q.dtype)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.window, ctx.q_offset = window, q_offset
        ctx.causal, ctx.block_k = causal, block_k
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        qg, bk = _prep(q, k, ctx.block_k)
        b, s, kh, g, d = qg.shape
        t, dv = k.shape[1], v.shape[-1]
        qf = qg.float()
        do_f = do.float().reshape(b, s, kh, g, dv)
        delta = (do_f * o.float().reshape(b, s, kh, g, dv)).sum(-1)
        lse_t = lse.permute(0, 2, 3, 1)[..., None]          # (B,KH,G,S,1)
        delta_t = delta.permute(0, 2, 3, 1)[..., None]
        dq = torch.zeros((b, s, kh, g, d), device=q.device)
        dks, dvs = [], []
        for k0 in op_count.repeat(range(0, t, bk)):
            kblk = k[:, k0:k0 + bk].float()
            vblk = v[:, k0:k0 + bk].float()
            scores = torch.einsum("bskgd,btkd->bkgst", qf, kblk)
            mb = _mask_block(ctx.q_offset, k0, s, bk, causal=ctx.causal,
                             window=ctx.window, device=q.device)
            scores = torch.where(mb, scores, NEG_INF)
            p = torch.exp(scores - lse_t)
            dvs.append(torch.einsum("bkgst,bskgd->btkd", p, do_f))
            dp = torch.einsum("bskgd,btkd->bkgst", do_f, vblk)
            ds = p * (dp - delta_t)
            dq += torch.einsum("bkgst,btkd->bskgd", ds, kblk)
            dks.append(torch.einsum("bkgst,bskgd->btkd", ds, qf))
        # the blocks a counter skipped (their gradients as the first's)
        dks += dks[-1:] * (t // bk - len(dks))
        dvs += dvs[-1:] * (t // bk - len(dvs))
        dq = (dq * d ** -0.5).reshape(b, s, kh * g, d).to(q.dtype)
        dk = torch.cat(dks, dim=1).to(k.dtype)
        dvv = torch.cat(dvs, dim=1).to(v.dtype)
        return dq, dk, dvv, None, None, None, None


def blockwise_attention(q, k, v, window=0, q_offset=0, causal=True,
                        block_k=512):
    """q (B,S,H,D), k (B,T,KH,D), v (B,T,KH,Dv) -> (B,S,H,Dv) in q's dtype.
    ``window`` 0 = full; ``q_offset`` is the absolute position of q[0] (the
    query tiles of :func:`blockwise_attention_qchunked`)."""
    return BlockwiseAttention.apply(q, k, v, int(window), int(q_offset),
                                    bool(causal), int(block_k))


def blockwise_attention_qchunked(q, k, v, window=0, causal=True,
                                 block_k=512, block_q=512):
    """:func:`blockwise_attention` over query tiles of ``block_q`` rows
    (shrunk until it divides S), so the accumulator carried across key
    blocks is (bq, Dv) rather than (S, Dv); dk and dv sum over the tiles
    through autograd."""
    s = q.shape[1]
    bq = min(block_q, s)
    while s % bq:
        bq -= 1
    if bq == s:
        return blockwise_attention(q, k, v, window, 0, causal, block_k)
    return torch.cat([blockwise_attention(q[:, q0:q0 + bq], k, v, window,
                                          q0, causal, block_k)
                      for q0 in range(0, s, bq)], dim=1)
