"""The Mamba2 (SSD) block (``repro.models.mamba2``) [arXiv:2405.21060].

Per head h with state (P, N):
    h_t = a_t h_{t-1} + dt_t x_t B_tᵀ,    y_t = h_t C_t + D x_t,
with a_t = exp(dt_t A), A = -exp(A_log), dt_t = softplus(dt_raw + dt_bias).
The in-projection is split ``[z | x | B | C | dt]``; a depthwise causal
conv with SiLU runs over ``x | B | C``; the output ``y`` is gated by
``silu(z)``, normalised by an RMSNorm over the inner width (K4/K5 with
``cfg.use_kernels``) and projected back to d_model.

The recurrence runs in the reference's chunked SSD form, all in fp32:
within a chunk a causal-masked product, across chunks the (B, H, P, N)
state carried from chunk to chunk. The reference scans the chunks one at
a time (``lax.scan`` of a checkpointed body); here every chunk's
intra-chunk product and its state contribution run at once, batched over
the chunks, and only the carry (one multiply-add of the state a chunk)
loops, with the whole scan of a layer under one ``torch.utils.checkpoint``
(autograd keeps no (chunk, chunk, H) decay tensor; the backward computes
them again). A loop of checkpointed chunk bodies left Zamba2's training
step host-bound on the card: thousands of small launches a layer. The
reference has no Pallas kernel here; the products are ``torch.einsum``
(the three-operand ones split in two, so no (B, chunk, H, P, N) product is
formed). The masked pairs' exponent is set to -inf before the exp: above
the diagonal exp(L_i - L_j) overflows fp32 at chunk 128, and an inf there
would meet the gradient (0 · inf, ROADMAP caveat R5); below it every value
is the reference's.

Serving (``mamba2.py:140-201``): with a cache, the conv reads the cached
last k-1 rows (``conv``) and the scan starts from the cached state
(``ssd``); decode (S == 1 with a cache) is one step of the recurrence.
Both are written back in place, cast to the cache's dtype.

Tensor parallelism (``models/shardctx.py``; ROADMAP deviation D7): the
columns of ``w_in`` are ``[z | x | B | C | dt]``, so a contiguous chunk
of them is not a set of whole heads. Under a model group of M ranks
``w_in``, ``conv_w``, ``conv_b``, ``A_log``, ``dt_bias``, ``D`` and the
inner ``norm`` come whole, and rank m takes, on use, the z, x and dt
columns (and the x conv channels, head vectors and norm columns) of its
heads ``[m·H/M, (m+1)·H/M)`` and the shared B and C (one group) whole:
its input goes through ``copy_to_model``, the scan runs on its heads, the
inner RMSNorm spans the row over the group (the split-row K4/K5), and
``w_out``'s row chunk is followed by ``reduce_from_model``. The engine
sums the whole leaves' gradients over the group. Serving under a model
group caches this rank's heads of the SSD state, (B, H/M, P, N), as the
reference does, and its conv channels in ``_rank_params``' order, (B,
k-1, d_in/M + 2N): its heads' x channels, then B and C whole (ROADMAP
deviations D7, D9; the reference splits the conv state contiguously).
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import shardctx
from repro_torch.models.norms import rmsnorm
from repro_torch.models.params import dense_init, ones, zeros


def dims(cfg):
    """(inner width d_in, heads, conv channels d_in + 2N)."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    return d_in, d_in // s.head_dim, d_in + 2 * s.state_dim


def init_mamba2(cfg, layers, **kw):
    """The params of ``layers`` Mamba2 blocks, stacked on a leading L axis,
    keyed as the reference's ``init_mamba2`` (``mamba2.py:29-45``)."""
    s, d, L, dev = cfg.ssm, cfg.d_model, layers, kw["device"]
    d_in, nheads, conv_ch = dims(cfg)
    return {
        # order of the in-projection's columns: [z | x | B | C | dt]
        "w_in": dense_init((L, d, 2 * d_in + 2 * s.state_dim + nheads), **kw),
        "conv_w": dense_init((L, s.conv_kernel, conv_ch), scale=0.3, **kw),
        "conv_b": zeros((L, conv_ch), device=dev),
        "A_log": zeros((L, nheads), device=dev),         # A = -exp(0) = -1
        "dt_bias": torch.full((L, nheads), 0.5, device=dev),
        "D": ones((L, nheads), device=dev),
        "norm": ones((L, d_in), device=dev),
        "w_out": dense_init((L, d_in, d), **kw),
    }


def _split_proj(proj, d_in, n):
    """``proj`` (B,S,·) of ``d_in`` inner columns and state ``n`` -> (z,
    x | B | C, dt_raw)."""
    return proj[..., :d_in], proj[..., d_in:2 * d_in + 2 * n], \
        proj[..., 2 * d_in + 2 * n:]


def _rank_params(cfg, p, rank, size):
    """One layer's params as rank ``rank`` of a model group of ``size``
    uses them (D7): ``w_in``'s z, x and dt columns of its heads and the
    B and C columns; the conv's x channels of its heads and the B and C
    channels; its heads' ``A_log``, ``dt_bias``, ``D`` and ``norm``
    columns; ``w_out`` is its row chunk already."""
    d_in, nheads, _ = dims(cfg)
    n = cfg.ssm.state_dim
    w, h = d_in // size, nheads // size
    c0, h0 = rank * w, rank * h
    dev = p["w_in"].device
    ar = functools.partial(torch.arange, device=dev)
    bc = ar(2 * d_in, 2 * d_in + 2 * n)
    cols = torch.cat([ar(c0, c0 + w), d_in + ar(c0, c0 + w), bc,
                      2 * d_in + 2 * n + ar(h0, h0 + h)])
    chans = torch.cat([ar(c0, c0 + w), bc - d_in])
    return dict(p, w_in=p["w_in"].index_select(-1, cols),
                conv_w=p["conv_w"].index_select(-1, chans),
                conv_b=p["conv_b"].index_select(-1, chans),
                A_log=p["A_log"][h0:h0 + h], dt_bias=p["dt_bias"][h0:h0 + h],
                D=p["D"][h0:h0 + h], norm=p["norm"][c0:c0 + w])


def _causal_conv(xbc, conv_w, conv_b, conv_state=None):
    """Depthwise causal conv1d with SiLU: xbc (B,S,C), conv_w (k,C), the
    last k-1 rows before it in ``conv_state`` (B,k-1,C) (zeros when None)
    -> (out (B,S,C), the new last k-1 rows). A cached state in a wider
    dtype promotes, as the reference's concatenate does."""
    k, s = conv_w.shape[0], xbc.shape[1]
    if conv_state is None:
        conv_state = xbc.new_zeros((xbc.shape[0], k - 1, xbc.shape[-1]))
    wide = torch.promote_types(conv_state.dtype, xbc.dtype)
    full = torch.cat([conv_state.to(wide), xbc.to(wide)], dim=1)
    w, b = conv_w.to(xbc.dtype), conv_b.to(xbc.dtype)
    out = sum(full[:, i:i + s] * w[i] for i in range(k))
    return F.silu(out + b), full[:, -(k - 1):]


def _ssd_chunks(h0, xk, bk, ck, dtk, lak):
    """Every chunk of ``_ssd_chunk_scan`` at once: (B,NC,c,...) fp32 inputs
    and the state entering the first chunk (B,H,P,N) -> (y (B,NC,c,H,P),
    the state leaving the last). Each chunk is the reference's ``body``:
    its intra-chunk product, the entering state's part, and the state it
    passes on, ``exp(L_end) h_in + sum_j exp(L_end - L_j) dtx_j B_jᵀ``."""
    L = torch.cumsum(lak, dim=2)                        # (B,NC,c,H)
    dtx = xk * dtk[..., None]                           # (B,NC,c,H,P)
    # intra-chunk: M[i,j] = (C_i·B_j) exp(L_i - L_j) [j <= i]
    c = L.shape[2]
    causal = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                   device=L.device))[:, :, None]
    expo = torch.where(causal, L[:, :, :, None] - L[:, :, None], -torch.inf)
    m = torch.einsum("bkin,bkjn->bkij", ck, bk)[..., None] * torch.exp(expo)
    y = torch.einsum("bkijh,bkjhp->bkihp", m, dtx)
    # each chunk's own contribution to the state it passes on
    l_end = L[:, :, -1]                                 # (B,NC,H)
    w = torch.exp(l_end[:, :, None] - L)                # (B,NC,c,H)
    own = torch.einsum("bkjhp,bkjn->bkhpn", w[..., None] * dtx, bk)
    # the carry: the state entering each chunk
    decay = torch.exp(l_end)[..., None, None]           # (B,NC,H,1,1)
    h, h_in = h0, []
    for k in range(L.shape[1]):
        h_in.append(h)
        h = decay[:, k] * h + own[:, k]
    y = y + torch.einsum("bkin,bkhpn->bkihp", ck, torch.stack(h_in, 1)) * \
        torch.exp(L)[..., None]
    return y, h


def _ssd_chunk_scan(xh, bmat, cmat, dt, a_log, chunk, h0):
    """The chunked SSD (``mamba2.py:71-137``): xh (B,S,H,P) head inputs,
    bmat/cmat (B,S,N), dt (B,S,H) after the softplus, a_log (H,), h0
    (B,H,P,N) -> (y (B,S,H,P), h_end), in fp32. S is padded to a chunk
    multiple with zeros, and the padding's dt and log-decay are zero, so
    it leaves the state as it was."""
    b, s, h, p = xh.shape
    f32 = torch.float32
    pad = -s % chunk
    xh, bmat, cmat, dt = (F.pad(t.to(f32), (0, 0) * (t.ndim - 2) + (0, pad))
                          for t in (xh, bmat, cmat, dt))
    la = dt * -torch.exp(a_log.to(f32))                 # log a_t (B,S,H)
    if pad:
        valid = (torch.arange(s + pad, device=dt.device) < s)[None, :, None]
        la = torch.where(valid, la, 0.0)
        dt = torch.where(valid, dt, 0.0)
    nc = (s + pad) // chunk
    y, h_end = checkpoint(
        _ssd_chunks, h0.to(f32),
        *(t.reshape((b, nc, chunk) + t.shape[2:])
          for t in (xh, bmat, cmat, dt, la)), use_reentrant=False)
    return y.reshape(b, nc * chunk, h, p)[:, :s], h_end


def ssd_step(xh, bmat, cmat, dt, a_log, h0):
    """One step of the recurrence in fp32 (``mamba2.py:172-183``): xh
    (B,H,P), bmat/cmat (B,N), dt (B,H), h0 (B,H,P,N) -> (y (B,H,P),
    h_end)."""
    f32 = torch.float32
    a = torch.exp(dt * -torch.exp(a_log.to(f32)))       # (B,H)
    dtx = xh.to(f32) * dt[..., None]
    h_end = a[..., None, None] * h0 + \
        torch.einsum("bhp,bn->bhpn", dtx, bmat.to(f32))
    return torch.einsum("bhpn,bn->bhp", h_end, cmat.to(f32)), h_end


def mamba2_block(p, x, cfg, *, cache=None):
    """x (B,S,D) -> (B,S,D), the reference's ``mamba2_block``
    (``mamba2.py:140-193``). p: one layer's params (``init_mamba2``'s keys
    without the L axis). ``cache``: this layer's {"conv" (B,k-1,C), "ssd"
    (B,H,P,N)}, read, then written in place."""
    s_cfg = cfg.ssm
    b, s, _ = x.shape
    d_in, nheads, _ = dims(cfg)
    n, pdim = s_cfg.state_dim, s_cfg.head_dim
    dt_, f32 = x.dtype, torch.float32
    tp = shardctx.active()
    if tp is not None:
        p = _rank_params(cfg, p, tp.rank, tp.size)
        d_in, nheads = d_in // tp.size, nheads // tp.size
        x = shardctx.copy_to_model(x)
    z, xbc, dt_raw = _split_proj(x @ p["w_in"].to(dt_), d_in, n)
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"],
                                 cache["conv"] if cache is not None else None)
    xc = xbc[..., :d_in].reshape(b, s, nheads, pdim)
    bmat, cmat = xbc[..., d_in:d_in + n], xbc[..., d_in + n:]
    dt = F.softplus(dt_raw.to(f32) + p["dt_bias"].to(f32))
    h0 = cache["ssd"].to(f32) if cache is not None else \
        torch.zeros((b, nheads, pdim, n), dtype=f32, device=x.device)
    if cache is not None and s == 1:
        y, h_end = ssd_step(xc[:, 0], bmat[:, 0], cmat[:, 0], dt[:, 0],
                            p["A_log"], h0)
        y = y[:, None]
    else:
        y, h_end = _ssd_chunk_scan(xc, bmat, cmat, dt, p["A_log"],
                                   min(s_cfg.chunk_size, s), h0)
    y = y + p["D"].to(f32)[:, None] * xc.to(f32)
    y = y.reshape(b, s, d_in).to(dt_) * F.silu(z)
    y = rmsnorm(y, p["norm"], cfg.norm_eps, use_kernels=cfg.use_kernels,
                split=True)
    if cache is not None:
        cache["conv"].copy_(new_conv)
        cache["ssd"].copy_(h_end)
    return shardctx.reduce_from_model(y @ p["w_out"].to(dt_))


def init_mamba2_cache(cfg, batch, *, dtype, device):
    """One layer's zero cache (``mamba2.py:196-201``): the conv's last k-1
    input rows (B,k-1,C) and the SSD state (B,H,P,N)."""
    s = cfg.ssm
    _, nheads, conv_ch = dims(cfg)
    kw = {"dtype": dtype, "device": device}
    return {"conv": torch.zeros((batch, s.conv_kernel - 1, conv_ch), **kw),
            "ssd": torch.zeros((batch, nheads, s.head_dim, s.state_dim),
                               **kw)}
