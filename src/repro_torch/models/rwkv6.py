"""The RWKV6 "Finch" block (``repro.models.rwkv6``): token shift with the
data-dependent lerp, the WKV6 recurrence with a data-dependent decay, and
the squared-ReLU channel mix [arXiv:2404.05892].

Per head (state S is (P, P), P = head_dim):
    o_t = r_t · (S_{t-1} + diag(u) k_tᵀ v_t),
    S_t = diag(w_t) S_{t-1} + k_tᵀ v_t,
with the per-channel decay w_t = exp(wlog_t), wlog_t = -exp(wraw_t) < 0.
With ``cfg.use_kernels`` the recurrence runs through ``ops.wkv6`` (K6
forward, K7 backward); otherwise through ``wkv6_chunked``, the reference's
chunked form in plain PyTorch, each chunk's body checkpointed as the
reference's ``jax.checkpoint(body)``. Only the training branch is ported:
a decode cache raises.

Casts follow the reference: the projections run in the compute dtype, the
decay LoRA in fp32, ``bonus_u`` enters WKV6 in fp32, and o leaves it in
fp32 and is cast to the compute dtype before the group norm.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.ops import wkv6
from repro_torch.models.norms import groupnorm_heads
from repro_torch.models.params import dense_init, ones, zeros

MIX_STREAMS = 5     # r, k, v, w, g
MIX_LORA = 32       # the token-shift LoRA's rank (rwkv6.py:29-30)


def init_rwkv6(cfg, layers, **kw):
    """The time-mix params of ``layers`` layers, stacked on a leading L
    axis, keyed as the reference's ``init_rwkv6`` (``rwkv6.py:23-50``)."""
    d, lo = cfg.d_model, cfg.ssm.decay_lora
    h, p = cfg.num_heads, cfg.head_dim
    L, dev = layers, kw["device"]
    return {
        "mu_base": zeros((L, d), device=dev),
        "mu": zeros((L, MIX_STREAMS, d), device=dev),
        "lora_w1": dense_init((L, d, MIX_STREAMS * MIX_LORA), scale=0.01,
                              **kw),
        "lora_w2": dense_init((L, MIX_STREAMS, MIX_LORA, d), scale=0.01,
                              **kw),
        "w_r": dense_init((L, d, h * p), **kw),
        "w_k": dense_init((L, d, h * p), **kw),
        "w_v": dense_init((L, d, h * p), **kw),
        "w_g": dense_init((L, d, h * p), **kw),
        "decay_base": torch.full((L, h * p), -0.6, device=dev),
        "decay_w1": dense_init((L, d, lo), scale=0.01, **kw),
        "decay_w2": dense_init((L, lo, h * p), scale=0.01, **kw),
        "bonus_u": dense_init((L, h, p), scale=0.3, **kw),
        "ln_scale": ones((L, h * p), device=dev),
        "ln_bias": zeros((L, h * p), device=dev),
        "w_o": dense_init((L, h * p, d), **kw),
    }


def init_rwkv6_channel_mix(cfg, layers, **kw):
    """The channel-mix params, stacked on L (``rwkv6.py:53-62``)."""
    d, f, L, dev = cfg.d_model, cfg.d_ff, layers, kw["device"]
    return {
        "mu_k": zeros((L, d), device=dev),
        "mu_r": zeros((L, d), device=dev),
        "w_k": dense_init((L, d, f), **kw),
        "w_v": dense_init((L, f, d), **kw),
        "w_r": dense_init((L, d, d), **kw),
    }


def _token_shift(x, last):
    """x (B,S,D) shifted one step later, ``last`` (B,D) in front."""
    return torch.cat([last[:, None], x[:, :-1]], dim=1)


def _ddlerp(p, x, xx):
    """The data-dependent lerp -> the 5 mixed streams (B,S,5,D)."""
    dt = x.dtype
    delta = xx - x
    base = x + delta * p["mu_base"].to(dt)
    b, s, _ = x.shape
    lora = torch.tanh(base @ p["lora_w1"].to(dt)).reshape(
        b, s, MIX_STREAMS, -1)
    lora = torch.einsum("bsml,mld->bsmd", lora, p["lora_w2"].to(dt))
    mix = p["mu"].to(dt)[None, None] + lora
    return x[:, :, None] + delta[:, :, None] * mix


def _wkv6_chunk(s_in, rk, kk, vk, wk, u):
    """One chunk of ``wkv6_chunked``: (B,chunk,H,P) fp32 inputs and the
    entering state -> (state out, o of the chunk)."""
    L = torch.cumsum(wk, dim=1)
    lprev = L - wk
    o = torch.einsum("bthp,bhpq->bthq", rk * torch.exp(lprev), s_in)
    # exp(lprev_t - L_j) <= 1 on j < t; min(., 0) guards the masked
    # upper triangle against overflow
    pair = torch.exp(torch.clamp_max(lprev[:, :, None] - L[:, None], 0.0))
    att = torch.einsum("bthp,btjhp,bjhp->bhtj", rk, pair, kk)
    cs = rk.shape[1]
    causal = torch.tril(torch.ones((cs, cs), dtype=torch.bool,
                                   device=rk.device), diagonal=-1)
    att = torch.where(causal, att, 0.0)
    o = o + torch.einsum("bhtj,bjhq->bthq", att, vk)
    o = o + torch.einsum("bthp,hp,bthp->bth", rk, u, kk)[..., None] * vk
    l_end = L[:, -1]                                        # (B,H,P)
    s_out = torch.exp(l_end)[..., None] * s_in + torch.einsum(
        "bjhp,bjhq->bhpq", kk * torch.exp(l_end[:, None] - L), vk)
    return s_out, o


def wkv6_chunked(r, k, v, wlog, u, chunk, s0):
    """The reference's chunked WKV6 (``rwkv6.py:79-148``) in fp32:
    r/k/v/wlog (B,S,H,P), u (H,P), s0 (B,H,P,P) ->
    (o (B,S,H,P), s_end). S is padded to a chunk multiple with zero r/k/v
    and a zero log-decay. Each chunk's body is checkpointed, so autograd
    keeps no (chunk, chunk, P) pairwise tensor per chunk."""
    b, s, h, p = r.shape
    pad = -s % chunk
    f32 = torch.float32
    r, k, v, wlog = (F.pad(t.to(f32), (0, 0, 0, 0, 0, pad))
                     for t in (r, k, v, wlog))
    u = u.to(f32)
    state, outs = s0.to(f32), []
    for c in range(0, s + pad, chunk):
        sl = slice(c, c + chunk)
        state, o = checkpoint(_wkv6_chunk, state, r[:, sl], k[:, sl],
                              v[:, sl], wlog[:, sl], u, use_reentrant=False)
        outs.append(o)
    return torch.cat(outs, dim=1)[:, :s], state


def rwkv6_time_mix(p, x, cfg, *, cache=None):
    """x (B,S,D) -> (B,S,D), the training branch of the reference's
    ``rwkv6_time_mix`` (``rwkv6.py:151-212``)."""
    if cache is not None:
        raise NotImplementedError("the RWKV6 decode cache is not yet "
                                  "ported to repro_torch")
    b, s, d = x.shape
    h, pd, dt = cfg.num_heads, cfg.head_dim, x.dtype
    xx = _token_shift(x, x.new_zeros((b, d)))
    xr, xk, xv, xw, xg = _ddlerp(p, x, xx).unbind(2)
    r = (xr @ p["w_r"].to(dt)).reshape(b, s, h, pd)
    k = (xk @ p["w_k"].to(dt)).reshape(b, s, h, pd)
    v = (xv @ p["w_v"].to(dt)).reshape(b, s, h, pd)
    g = xg @ p["w_g"].to(dt)
    f = torch.float32
    wraw = p["decay_base"].to(f) + torch.tanh(
        xw.to(f) @ p["decay_w1"].to(f)) @ p["decay_w2"].to(f)
    wlog = -torch.exp(wraw).reshape(b, s, h, pd)            # log decay < 0
    s0 = torch.zeros((b, h, pd, pd), dtype=f, device=x.device)
    u = p["bonus_u"].to(f)
    if cfg.use_kernels:
        o, _ = wkv6(r, k, v, wlog, u, s0, chunk=cfg.ssm.chunk_size)
    else:
        o, _ = wkv6_chunked(r, k, v, wlog, u, min(cfg.ssm.chunk_size, s),
                            s0)
    o = groupnorm_heads(o.to(dt), p["ln_scale"], p["ln_bias"], cfg.norm_eps)
    o = o.reshape(b, s, h * pd) * F.silu(g)
    return o @ p["w_o"].to(dt)


def rwkv6_channel_mix(p, x, cfg, *, cache=None):
    """x (B,S,D) -> (B,S,D): ``sigmoid(xr@w_r) * (relu(xk@w_k)² @ w_v)``
    on token-shifted mixes (``rwkv6.py:215-231``)."""
    if cache is not None:
        raise NotImplementedError("the RWKV6 decode cache is not yet "
                                  "ported to repro_torch")
    b, s, d = x.shape
    dt = x.dtype
    delta = _token_shift(x, x.new_zeros((b, d))) - x
    xk = x + delta * p["mu_k"].to(dt)
    xr = x + delta * p["mu_r"].to(dt)
    hidden = torch.square(F.relu(xk @ p["w_k"].to(dt)))
    return torch.sigmoid(xr @ p["w_r"].to(dt)) * (hidden @ p["w_v"].to(dt))
