"""Multi-head attention on (B, S, H, hd) tensors (``repro.models.attention``).

``attention_block`` projects with ``x @ w`` (weights stored (in, out)),
adds the qkv bias and rotates q and k (the decoders; ViT has neither),
then routes as the reference does (``attention.py:150-165``): to the flash
kernels (``kernels.ops.flash_mha``, which take causal and window masks and
GQA) when ``cfg.use_kernels`` is set, to the blockwise flash in PyTorch
(``models/blockwise.py``) when ``cfg.attn_impl`` is "blockwise", else to
the naive :func:`sdpa`; a logit softcap takes the naive path whatever the
other settings, so the kernels never see one. ``mla_block`` is DeepSeek's
multi-head latent attention, its train/prefill branch: queries and keys of
``qk_nope_head_dim + qk_rope_head_dim`` (192 in DeepSeek-V3), values of
``v_head_dim`` (128), routed the same way. Decode caches (MLA's latent
cache and its absorbed decode among them) are not ported.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ops import flash_mha
from repro_torch.models.blockwise import blockwise_attention_qchunked
from repro_torch.models.norms import rmsnorm
from repro_torch.models.rope import apply_rope, apply_rope_1d

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


def sdpa(q, k, v, mask, *, softcap=0.0):
    """q (B,S,H,hd), k/v (B,T,KH,hd), mask broadcastable to (B,KH,G,S,T).

    Scores and softmax in fp32, the ``softcap`` (> 0) applied to the
    scaled scores before the mask; the weights are cast to the compute
    dtype before P·V, as the reference does (``attention.py:80-89``)."""
    b, s, h, hd = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh
    qg = q.reshape(b, s, kh, g, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.to(torch.float32),
                          k.to(torch.float32)) * (hd ** -0.5)
    if softcap > 0.0:
        scores = softcap * torch.tanh(scores / softcap)
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
    softcap = cfg.attn_logit_softcap
    if cfg.use_kernels and softcap == 0.0:
        out = flash_mha(q, k, v, causal=cfg.causal, window=window)
    elif cfg.attn_impl == "blockwise" and softcap == 0.0:
        out = blockwise_attention_qchunked(
            q, k, v, window, causal=cfg.causal, block_k=cfg.attn_block_k,
            block_q=cfg.attn_block_q)
    else:
        mask = _mask(s, s, causal=cfg.causal, window=window, device=x.device)
        out = sdpa(q, k, v, mask, softcap=softcap)
    return out.reshape(b, s, h * hd) @ p["wo"].to(dt)


def mla_block(p, x, cfg, *, positions, cache=None):
    """DeepSeek's multi-head latent attention, the train/prefill branch of
    the reference's ``mla_block`` (``attention.py:181-256``). p: this
    layer's {w_dq, q_norm, w_uq, w_dkv, kv_norm, w_uk, w_uv, wo}; x (B,S,D)
    in the compute dtype; positions (B,S).

    The query goes down to ``q_lora_rank``, through RMSNorm (``q_norm``)
    and up to H heads of nope + rope; ``w_dkv`` gives the key-value latent
    (its first ``kv_lora_rank`` columns, through ``kv_norm``: rows read at
    the projection's row stride) and one shared rope key (its last
    ``qk_rope_head_dim``), which ``apply_rope_1d`` rotates and every head
    shares; the latent goes up to the heads' nope keys and values. Both
    norms take K4/K5 with ``cfg.use_kernels``. Attention is causal with no
    window, scaled by q's width ** -0.5 on every route: the kernels at
    (D, Dv) = (nope + rope, v), the blockwise flash, or the naive
    :func:`sdpa`. The latent cache and the absorbed decode are not ported:
    a ``cache`` raises."""
    if cache is not None:
        raise NotImplementedError(
            "MLA's latent cache and absorbed decode are not yet ported to "
            "repro_torch")
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.num_heads
    nope, rope_d, vd = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    dt = x.dtype
    cq = rmsnorm(x @ p["w_dq"].to(dt), p["q_norm"], cfg.norm_eps,
                 use_kernels=cfg.use_kernels)
    q = (cq @ p["w_uq"].to(dt)).reshape(b, s, h, nope + rope_d)
    dkv = x @ p["w_dkv"].to(dt)
    c_kv = rmsnorm(dkv[..., :m.kv_lora_rank], p["kv_norm"], cfg.norm_eps,
                   use_kernels=cfg.use_kernels)
    # the "full" rope of apply_rope and apply_rope_1d are one rotation
    q_rope = apply_rope_1d(q[..., nope:], positions, theta=cfg.rope_theta)
    k_rope = apply_rope_1d(dkv[..., m.kv_lora_rank:][:, :, None], positions,
                           theta=cfg.rope_theta)
    k_nope = (c_kv @ p["w_uk"].to(dt)).reshape(b, s, h, nope)
    v = (c_kv @ p["w_uv"].to(dt)).reshape(b, s, h, vd)
    k = torch.cat([k_nope, k_rope.expand(b, s, h, rope_d)], dim=-1)
    q = torch.cat([q[..., :nope], q_rope], dim=-1)
    if cfg.use_kernels:
        out = flash_mha(q, k, v, causal=True, window=0)
    elif cfg.attn_impl == "blockwise":
        out = blockwise_attention_qchunked(
            q, k, v, 0, causal=True, block_k=cfg.attn_block_k,
            block_q=cfg.attn_block_q)
    else:
        out = sdpa(q, k, v, _mask(s, s, causal=True, window=0,
                                  device=x.device))
    return out.reshape(b, s, h * vd) @ p["wo"].to(dt)
