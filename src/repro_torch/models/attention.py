"""Multi-head attention on (B, S, H, hd) tensors (``repro.models.attention``).

``attention_block`` projects with ``x @ w`` (weights stored (in, out)),
adds the qkv bias and rotates q and k (the decoders; ViT has neither),
then routes as the reference does (``attention.py:150-165``): to the flash
kernels (``kernels.ops.flash_mha``, which take causal and window masks and
GQA) when ``cfg.use_kernels`` is set, to the blockwise flash in PyTorch
(``models/blockwise.py``) when ``cfg.attn_impl`` is "blockwise", else to
the naive :func:`sdpa`; a logit softcap takes the naive path whatever the
other settings, so the kernels never see one. ``mla_block`` is DeepSeek's
multi-head latent attention: queries and keys of ``qk_nope_head_dim +
qk_rope_head_dim`` (192 in DeepSeek-V3), values of ``v_head_dim`` (128),
routed the same way.

Serving (``repro/models/attention.py:98-256``): given this layer's cache,
prefill (S > 1) writes the block at row 0 and attends over the whole cache
(T = its Smax rows, the unwritten tail hidden by the causal mask) on the
routes above; decode (S == 1) writes one row at ``cache_index`` and runs
the naive :func:`sdpa` over the keys at or before it (within the window),
whatever ``use_kernels`` says, as the reference does. A GQA layer caches
its rotated K and V; MLA caches the normalised latent ``c_kv`` and the
rotated shared rope key, and decodes absorbed: the query goes into the
latent space through ``w_uk`` and the context out through ``w_uv``, so no
per-head K or V is formed. The cache is written in place. Its dtype must be
the compute dtype: another one raises (K1 takes no mixed dtypes, and a cast
would hide the mismatch).

Tensor parallelism (``models/shardctx.py``): with a model group of M
ranks installed, ``attention_block`` gets this rank's column chunk of
``wq`` (and ``bq``), so H/M query heads, and its row chunk of ``wo``,
whose partial output is summed over the group (Megatron's column/row
split; the input goes through ``copy_to_model``). The KV projections come
as KH/M heads, or, where M does not divide KH (ROADMAP deviation D6),
whole: the rank then takes only the one KV head its query heads use (a
column slice of ``wk``/``wv``/``bk``/``bv``), so the kernel's ``h // g``
sees its own group, and the engine sums those leaves' gradients over the
group. Rope, the masks and the kernels are per head and unchanged.
Serving under a model group (ROADMAP deviation D9) caches this rank's
KV heads, (B, Smax, KH/M, hd), or under D6 the one KV head its query
heads use, (B, Smax, 1, hd): prefill and decode attend over the rank's
own heads, so no softmax spans ranks, and ``wo``'s row chunk is summed
over the group as in training.

MLA under a model group: every rank computes the down-projections, both
latent norms and the shared rope key whole (``w_dq``, ``q_norm``,
``w_dkv``, ``kv_norm`` are replicated), takes its H/M heads through its
column chunks of ``w_uq``, ``w_uk`` and ``w_uv`` (whole heads: the
reference's contiguous columns) and ends with ``wo``'s row chunk and the
sum over the group. ``copy_to_model`` sits on the three latents (``cq``,
``c_kv``, the rotated rope key: q_lora + kv_lora + rope columns, 2112 in
DeepSeek-V3) rather than on x (7168): the backward's all-reduce moves
those, and the replicated leaves' gradients come out whole on every rank.
Serving under a model group splits the latent cache on the sequence
where the model axis divides its rows (``core/sharding.py::
latents_split``, the reference's ``cache_specs``): rank m holds rows
``[m·Tm, (m+1)·Tm)``. Prefill writes the prompt's rows of its range and
attends over the fresh whole latents (every rank computes them); decode
writes the new row on the rank that holds it and runs the absorbed
decode over its own rows for every head, then merges the ranks' partial
softmaxes (:func:`_split_decode`, a distributed flash-decoding). Where
the model axis does not divide the rows the latents stay whole on every
rank, and prefill and the absorbed decode run this rank's heads of
``w_uk`` and ``w_uv`` over them.

Ulysses (``core/ulysses.py``): given the forward's ``seq`` split,
``attention_block`` gets this rank's S_m rows and whole weights. It
projects and rotates them (at their global positions), moves q, k and v
from rows to heads (``shardctx.seq_to_heads``: H/M query heads and the
KH/M KV heads they use, so the kernel's ``h // g`` holds), attends over
the whole sequence on the usual routes (windows and softcap as on one
rank), moves the output back to rows (``heads_to_seq``) and applies the
whole ``wo``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ops import flash_mha
from repro_torch.models import shardctx
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


def _decode_mask(t, index, window, device):
    """(T,) bool: the cached keys a query at ``index`` sees, those at or
    before it and, with a window, fewer than ``window`` behind it."""
    kp = torch.arange(t, device=device)
    ok = kp <= index
    if window > 0:
        ok &= (index - kp) < window
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


def write_cache(cache, key, x, at, lo=0, rows=None):
    """Write ``x`` (B, S, ...) into ``cache[key]`` (B, Smax, ...) at rows
    ``at``..``at + S`` in place and return the whole cache tensor. Raises
    when the cache's dtype is not ``x``'s (the compute dtype). A cache
    split on the sequence holds global rows ``lo``..``lo + Smax`` of
    ``rows`` in all: only the rows of ``x`` in that range are written."""
    c = cache[key]
    if c.dtype != x.dtype:
        raise ValueError(f"cache {key!r} is {c.dtype}, the compute dtype "
                         f"{x.dtype}: make the cache in the compute dtype")
    rows = c.shape[1] if rows is None else rows
    if at + x.shape[1] > rows:
        raise ValueError(f"cache {key!r} holds {rows} rows; writing "
                         f"{x.shape[1]} at row {at} overflows it")
    a, b = max(at, lo), min(at + x.shape[1], lo + c.shape[1])
    if a < b:
        c[:, a - lo:b - lo] = x[:, a - at:b - at]
    return c


def _attend(q, k, v, cfg, window, causal, softcap=0.0):
    """The training/prefill routes: the kernels, the blockwise flash, or
    the naive :func:`sdpa` (the only route that takes a softcap)."""
    if cfg.use_kernels and softcap == 0.0:
        return flash_mha(q, k, v, causal=causal, window=window)
    if cfg.attn_impl == "blockwise" and softcap == 0.0:
        return blockwise_attention_qchunked(
            q, k, v, window, causal=causal, block_k=cfg.attn_block_k,
            block_q=cfg.attn_block_q)
    mask = _mask(q.shape[1], k.shape[1], causal=causal, window=window,
                 device=q.device)
    return sdpa(q, k, v, mask, softcap=softcap)


def attention_block(p, x, cfg, *, window, positions=None, cache=None,
                    cache_index=0, seq=None):
    """p: this layer's {wq, wk, wv, wo} (and {bq, bk, bv} with
    ``cfg.qkv_bias``); x (B,S,D) in the compute dtype; positions (B,S), or
    (B,S,3) for M-RoPE, for the rope (unused when ``cfg.rope_style`` is
    "none"). ``cache``: this layer's {"k", "v"} (B, Smax, KH, hd), written
    in place (prefill at row 0, decode at ``cache_index``). ``seq``: the
    forward's ``shardctx.SeqSplit`` under Ulysses (x and positions are
    this rank's rows), else None."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    # this rank's query and KV heads (all of them without a model group)
    h, kh = p["wq"].shape[-1] // hd, p["wk"].shape[-1] // hd
    dt = x.dtype
    proj = {w: p[w] for w in ("wq", "wk", "wv", "bq", "bk", "bv") if w in p}
    tp = shardctx.active()
    if tp is not None:
        x = shardctx.copy_to_model(x)
        if kh == cfg.num_kv_heads:
            # D6: whole KV projections; this rank's query heads all use
            # KV head `first // group` (check_model_axis)
            kv = tp.rank * h // (cfg.num_heads // cfg.num_kv_heads)
            cols = slice(kv * hd, (kv + 1) * hd)
            proj.update({w: proj[w][..., cols] for w in ("wk", "wv", "bk",
                                                         "bv") if w in proj})
            kh = 1
    q, k, v = (x @ proj[w].to(dt) for w in ("wq", "wk", "wv"))
    if cfg.qkv_bias:
        q, k, v = (t + proj[bias].to(dt)
                   for t, bias in zip((q, k, v), ("bq", "bk", "bv")))
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, kh, hd)
    v = v.reshape(b, s, kh, hd)
    if cfg.rope_style != "none":
        q, k = apply_rope(q, k, positions, style=cfg.rope_style,
                          theta=cfg.rope_theta, sections=cfg.mrope_sections)
    softcap = cfg.attn_logit_softcap
    if seq is not None:
        q, k, v = (shardctx.seq_to_heads(t, seq) for t in (q, k, v))
        out = shardctx.heads_to_seq(
            _attend(q, k, v, cfg, window, cfg.causal, softcap), seq)
        return out.reshape(b, s, h * hd) @ p["wo"].to(dt)
    if cache is None:
        out = _attend(q, k, v, cfg, window, cfg.causal, softcap)
    elif s == 1:
        k = write_cache(cache, "k", k, cache_index)
        v = write_cache(cache, "v", v, cache_index)
        mask = _decode_mask(k.shape[1], cache_index, window, x.device)
        out = sdpa(q, k, v, mask, softcap=softcap)
    else:
        k = write_cache(cache, "k", k, 0)
        v = write_cache(cache, "v", v, 0)
        out = _attend(q, k, v, cfg, window, cfg.causal, softcap)
    return shardctx.reduce_from_model(out.reshape(b, s, h * hd)
                                      @ p["wo"].to(dt))


def mla_block(p, x, cfg, *, positions, cache=None, cache_index=0):
    """DeepSeek's multi-head latent attention (the reference's
    ``mla_block``, ``attention.py:181-256``). p: this layer's {w_dq,
    q_norm, w_uq, w_dkv, kv_norm, w_uk, w_uv, wo} (under a model group the
    up-projections' and ``wo``'s chunks of this rank's heads); x (B,S,D)
    in the compute
    dtype; positions (B,S). ``cache``: this layer's {"c_kv" (B, Smax,
    kv_lora_rank), "k_rope" (B, Smax, qk_rope_head_dim)}, written in place.

    The query goes down to ``q_lora_rank``, through RMSNorm (``q_norm``)
    and up to H heads of nope + rope; ``w_dkv`` gives the key-value latent
    (its first ``kv_lora_rank`` columns, through ``kv_norm``: rows read at
    the projection's row stride) and one shared rope key (its last
    ``qk_rope_head_dim``), which ``apply_rope_1d`` rotates and every head
    shares. Training and prefill take the latent (prefill: the whole
    cached latent) up to the heads' nope keys and values and attend
    causally with no window, scaled by q's width ** -0.5, on the kernels at
    (D, Dv) = (nope + rope, v), the blockwise flash, or the naive
    :func:`sdpa`. Decode is absorbed: scores ``(q_nope w_uk) c_kvᵀ +
    q_rope k_ropeᵀ`` in fp32 over the cached rows at or before
    ``cache_index``, the context in latent space, then ``w_uv``. Both
    norms take K4/K5 with ``cfg.use_kernels``. With the latents split on
    the sequence over the model group (``shardctx.latent_group``) prefill
    attends over the fresh latents (T = S) and decode is
    :func:`_split_decode`; ``cache_index`` stays global."""
    m = cfg.mla
    b, s, _ = x.shape
    nope, rope_d, vd = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    # this rank's heads (all of them without a model group)
    h = p["w_uq"].shape[-1] // (nope + rope_d)
    dt = x.dtype
    cq = rmsnorm(x @ p["w_dq"].to(dt), p["q_norm"], cfg.norm_eps,
                 use_kernels=cfg.use_kernels)
    q = (shardctx.copy_to_model(cq) @ p["w_uq"].to(dt)).reshape(
        b, s, h, nope + rope_d)
    dkv = x @ p["w_dkv"].to(dt)
    c_kv = rmsnorm(dkv[..., :m.kv_lora_rank], p["kv_norm"], cfg.norm_eps,
                   use_kernels=cfg.use_kernels)
    # the "full" rope of apply_rope and apply_rope_1d are one rotation
    q_rope = apply_rope_1d(q[..., nope:], positions, theta=cfg.rope_theta)
    k_rope = apply_rope_1d(dkv[..., m.kv_lora_rank:][:, :, None], positions,
                           theta=cfg.rope_theta)
    q_nope = q[..., :nope]
    split = shardctx.latent_group() if cache is not None else None
    if split is not None:
        # this rank's rows of the latents split on the sequence; prefill
        # attends over the fresh whole latents (rows past S are causally
        # masked in the whole-cache route: the same arithmetic)
        tm = cache["c_kv"].shape[1]
        at, lo = (cache_index if s == 1 else 0), split.rank * tm
        write_cache(cache, "c_kv", c_kv, at, lo, split.size * tm)
        write_cache(cache, "k_rope", k_rope[:, :, 0], at, lo,
                    split.size * tm)
    elif cache is not None:
        at = cache_index if s == 1 else 0
        c_kv = write_cache(cache, "c_kv", c_kv, at)
        k_rope = write_cache(cache, "k_rope", k_rope[:, :, 0], at)[:, :,
                                                                  None]
    t = c_kv.shape[1]
    if split is not None and s == 1:
        out = _split_decode(p, cfg, q_nope, q_rope, cache, cache_index,
                            split)
    elif cache is not None and s == 1:
        f32 = torch.float32
        w_uk = p["w_uk"].to(dt).reshape(m.kv_lora_rank, h, nope)
        q_lat = torch.einsum("bshd,rhd->bshr", q_nope, w_uk)
        scores = (torch.einsum("bshr,btr->bhst", q_lat.to(f32),
                               c_kv.to(f32))
                  + torch.einsum("bshd,btd->bhst", q_rope.to(f32),
                                 k_rope[:, :, 0].to(f32))) \
            * (nope + rope_d) ** -0.5
        scores = torch.where(_decode_mask(t, cache_index, 0, x.device),
                             scores, NEG_INF)
        w = torch.softmax(scores, dim=-1).to(dt)
        ctx = torch.einsum("bhst,btr->bshr", w, c_kv)
        w_uv = p["w_uv"].to(dt).reshape(m.kv_lora_rank, h, vd)
        out = torch.einsum("bshr,rhd->bshd", ctx, w_uv)
    else:
        c_kv = shardctx.copy_to_model(c_kv)
        k_rope = shardctx.copy_to_model(k_rope)
        k_nope = (c_kv @ p["w_uk"].to(dt)).reshape(b, t, h, nope)
        v = (c_kv @ p["w_uv"].to(dt)).reshape(b, t, h, vd)
        k = torch.cat([k_nope, k_rope.expand(b, t, h, rope_d)], dim=-1)
        out = _attend(torch.cat([q_nope, q_rope], dim=-1), k, v, cfg, 0,
                      True)
    return shardctx.reduce_from_model(out.reshape(b, s, h * vd)
                                      @ p["wo"].to(dt))


def _split_decode(p, cfg, q_nope, q_rope, cache, cache_index, group):
    """MLA's absorbed decode over latents split on the sequence (a
    distributed flash-decoding): this rank holds global rows ``[m·Tm,
    (m+1)·Tm)`` of ``c_kv`` (B, Tm, R) and ``k_rope`` (B, Tm, rope) and
    its H/M heads of ``w_uk``/``w_uv``. ``q_lat = q_nope·w_uk`` and the
    rotated ``q_rope`` of its heads are gathered to every head; the fp32
    scores over its rows (NEG_INF past ``cache_index``) give its partial
    softmax, accumulated in fp32 (the row max, Σ exp(s − max) and
    Σ exp(s − max)·c_kv), which ``shardctx.combine_softmax`` merges over
    the group and scatters to the rank's heads; ``ctx / den``, cast to the
    compute dtype, goes through its heads of ``w_uv``. Returns (B, 1,
    H/M, v). The reference casts the softmax weights to the compute dtype
    before ``w·c_kv`` (``attention.py:229-230``); here the weighted sum
    stays in fp32 until the division. In fp32 the two agree to rounding;
    in bf16 they differ by the weights' rounding (the bf16 gate is the
    cosine's)."""
    m = cfg.mla
    nope, rope_d, vd = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    h, dt, f32 = q_nope.shape[2], q_nope.dtype, torch.float32
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    w_uk = p["w_uk"].to(dt).reshape(m.kv_lora_rank, h, nope)
    q_lat = torch.einsum("bshd,rhd->bshr", q_nope, w_uk)
    q_lat, q_rope = shardctx.gather_heads([q_lat, q_rope], group)
    scores = (torch.einsum("bshr,btr->bsht", q_lat.to(f32), c_kv.to(f32))
              + torch.einsum("bshd,btd->bsht", q_rope.to(f32),
                             k_rope.to(f32))) * (nope + rope_d) ** -0.5
    tm = c_kv.shape[1]
    live = torch.arange(tm, device=c_kv.device) + group.rank * tm <= \
        cache_index
    scores = torch.where(live, scores, NEG_INF)
    mx = scores.amax(-1)
    e = torch.exp(scores - mx[..., None])
    ctx, den = shardctx.combine_softmax(
        mx, e.sum(-1), torch.einsum("bsht,btr->bshr", e, c_kv.to(f32)),
        group)
    w_uv = p["w_uv"].to(dt).reshape(m.kv_lora_rank, h, vd)
    return torch.einsum("bshr,rhd->bshd", (ctx / den[..., None]).to(dt),
                        w_uv)
