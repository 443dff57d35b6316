"""Every branch of ``repro.models.transformer`` (the ViT, the dense,
MoE (with DeepSeek's MLA and MTP head) and vision-language decoders,
RWKV6, the HuBERT audio encoder and the Mamba2 / Zamba2 hybrid): init,
forward, the training loss and the eval counts.

Parameters keep the reference's layout so weights cross without
transposes: dense weights are (in, out) and applied as ``x @ w``, the
per-layer params are stacked on a leading L axis under ``stack`` (an MoE
decoder: ``dense_stack`` for its ``moe.first_dense_layers`` leading dense
layers and ``moe_stack`` for the rest, whose layers hold ``moe.*`` where a
dense layer holds ``mlp.*``), and the flat keys are the reference
pytree's dotted paths (``embed.patch_w``, ``embed.tok``,
``stack.attn.wq``, ``stack.mlp.w_gate``, ``moe_stack.moe.experts.w_up``,
``head.w``, ...). A decoder with ``tie_embeddings`` has no ``head.w``: its
head is ``embed.tok`` transposed, so the embedding's gradient sums both
uses. Params are fp32; each is cast to ``cfg.dtype`` where it is used.
The reference scans over layers; here a Python loop runs them, with each
layer's window a Python int, and ``cfg.remat`` checkpoints each layer's
body as the reference's ``_remat`` does. The ViT normalises with
LayerNorm, the decoders with RMSNorm (through K4/K5 when
``cfg.use_kernels``). The RWKV6 branch (``block_kind == "rwkv6"``)
replaces attention and MLP by the time mix and the channel mix
(``models/rwkv6.py``; WKV6 through K6/K7 when ``cfg.use_kernels``), under
``stack.time_mix.*`` and ``stack.channel_mix.*``, and takes no positions.
An MoE layer's feed-forward is ``models/moe.py`` (``cfg.moe_impl``: GShard
einsums or the gather slot table); its load-balance aux, summed over the
layers, is added to the loss and reported as ``moe_aux``. With
``block_kind="mla"`` each layer's attention is ``mla_block`` (its params
the reference's ``init_mla`` keys under ``attn.``); with ``mtp_depth > 0``
one multi-token prediction module (``mtp.proj``, the unstacked dense layer
``mtp.block.*`` and the norms ``mtp.norm_h``, ``mtp.norm_e``,
``mtp.final_norm``) predicts the token two ahead in training. A
vision-language decoder (``arch_type="vlm"``, Qwen2-VL) is the dense one
with M-RoPE: a batch's ``image_embeds`` (B, n_img, D) replace the first
n_img token embeddings, its ``positions`` (B, S, 3) give the rope grid (by
default every section takes 0..S-1), and the loss skips the image
positions. The audio encoder (``arch_type="audio"``, HuBERT) embeds a
batch's ``features`` (B, S, audio_feat_dim) through ``embed.feat_proj``
and ``embed.feat_b``, puts ``embed.mask_emb`` where ``batch["mask"]`` is
set and adds a sinusoidal position table; its pre-LN blocks (LayerNorm
with a bias, as the ViT's) attend non-causally, and the loss is the
cross-entropy over the masked frames only. With ``block_kind="mamba2"``
each layer is ``h += mamba2(norm(h))`` (``models/mamba2.py``; params
``stack.ln.scale`` and ``stack.mamba.*``); a hybrid (Zamba2,
``hybrid_group`` > 0) applies the one unstacked attention + MLP block
``shared_attn.*`` (window 0) after every ``hybrid_group`` of them, so its
gradient sums over every use.

Serving: ``init_cache`` makes the reference's cache tree (``{"layers":
...}``, or an MoE decoder's ``{"dense": ..., "moe": ...}``; per layer a
GQA layer's ``k``/``v`` (L, B, Smax, KH, hd), MLA's ``c_kv``/``k_rope``, or
RWKV6's ``att_shift``/``ffn_shift``/``wkv``; a Mamba2 model's ``{"mamba":
{"conv", "ssd"}}``, and a hybrid's ``"attn"`` ``k``/``v`` (G, B, Smax,
KH, hd), one slot per group of the shared block), and ``forward(...,
mode="prefill"|"decode", cache=...)`` threads it layer by layer, each layer
writing its slice in place. Across ranks ``init_cache(..., data=, model=)``
makes one rank's part (``core/sharding.py::cache_dims``: heads, D9, or
MLA's latents' rows) and the forward runs under the installed model group
as in training (installed with ``latents=True`` where the latents are
split on the sequence; ``cache_index`` stays global).

Tensor parallelism (``models/shardctx.py``): under an installed model
group the params are this rank's model chunks (``core/sharding.py::
model_dims``). The layers split as ``attention_block`` and ``mlp`` say; a
decoder's ``embed.tok`` is vocab-parallel (a token outside this rank's
rows looks up zeros, then the rows are summed over the group, before the
Gemma3 scale and the vlm splice); the LM head (``head.w``'s column chunk,
or the tied ``embed.tok`` chunk transposed) leaves the logits
vocab-sharded, and the loss takes them through ``vocab_parallel_nll``
(HuBERT's masked-frame loss too). Under ``embed_sharding`` "dmodel"
``embed.tok`` holds this rank's feature columns: the lookup is local and
its rows are gathered whole on the features (before the scale and the
splice), and a tied head is row-parallel (this rank's columns of the
hidden state against its columns of the table, the partial logits
summed over the group in fp32), so the logits are whole and the loss is
the plain NLL; an untied ``head.w`` stays vocab-parallel. The ViT's
``head.w``, split on the classes where M divides them, gives logits
gathered whole before the
replicated ``head.b``, so its loss, accuracy and eval counts see whole
logits. A leaf the model axis does not divide comes whole and is used as
on one rank (Granite-MoE's tied embedding at vocabulary 49,155: a whole
lookup, a whole head with no ``copy_to_model`` before it, whole logits).
The Mamba2 layers (D7), the MoE's experts (expert parallelism) and
RWKV6's mixes (heads) read the installed group as the attention does
(``mamba2.py``, ``moe.py``, ``rwkv6.py``); a hybrid's shared block is the
split attention + MLP. MLA splits by heads (``mla_block``), and the MTP
head takes the vocab-parallel lookup, head and loss as the main head
does.

Ulysses (``core/ulysses.py``, D8): under an installed sequence group the
training and eval forwards embed whole, then keep this rank's rows of the
hidden state and the positions (``shardctx.split_sequence``; the vlm
splice, M-RoPE's grid and HuBERT's mask and sinusoidal rows are taken
whole first); every layer runs on those rows with whole params, attention
moving them to heads and back (Granite-MoE's MoE gathers the rows, runs
the rank's E/M experts and reduce-scatters its partial sums back,
``models/moe.py``). A decoder's and HuBERT's logits are this
rank's rows, and :func:`loss_from_logits` divides their loss by the whole
microbatch's count (a partial sum: the engine sums it over the group);
the ViT gathers its final rows first, so its logits and loss are whole on
every rank. The families of ``core/ulysses.py::applies`` only.
"""
from __future__ import annotations

import contextlib
import functools
import math

import torch
import torch.nn as nn
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, \
    create_selective_checkpoint_contexts

from repro_torch.core import ulysses
from repro_torch.core.sharding import cache_dims, cache_shape, \
    is_stacked, whole_blocks
from repro_torch.models import shardctx
from repro_torch.models.attention import attention_block, mla_block
from repro_torch.models.mamba2 import init_mamba2, init_mamba2_cache, \
    mamba2_block
from repro_torch.models.mlp import is_gated, mlp
from repro_torch.models.moe import init_moe, moe_ffn, moe_ffn_gather
from repro_torch.models.norms import layernorm, rmsnorm
from repro_torch.models.params import dense_init, embed_init, ones, zeros
from repro_torch.models.rwkv6 import init_rwkv6, init_rwkv6_cache, \
    init_rwkv6_channel_mix, rwkv6_channel_mix, rwkv6_time_mix

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def compute_dtype(cfg) -> torch.dtype:
    if cfg.dtype not in _DTYPES:
        raise ValueError(f"compute dtype {cfg.dtype!r} not in {tuple(_DTYPES)}")
    return _DTYPES[cfg.dtype]


def _is_vit(cfg) -> bool:
    """The ViT branch; the audio encoder is :func:`_is_audio`, the rest are
    decoders."""
    return cfg.arch_type == "vit"


def _is_audio(cfg) -> bool:
    return cfg.arch_type == "audio"


def _is_rwkv(cfg) -> bool:
    return cfg.block_kind == "rwkv6"


def _is_mamba(cfg) -> bool:
    return cfg.block_kind == "mamba2"


def _layer_norm(cfg) -> bool:
    """LayerNorm (with a bias) for the ViT and the audio encoder, RMSNorm
    for the rest (the reference's ``_norm_kind``)."""
    return cfg.arch_type in ("vit", "audio")


def _stacks(cfg):
    """``[(prefix, layers, use_moe)]`` in the order the layers run: one
    ``stack.`` group, or an MoE decoder's ``dense_stack.`` (when it has
    leading dense layers) and ``moe_stack.``."""
    if not cfg.has_moe:
        return [("stack.", cfg.num_layers, False)]
    nd = cfg.moe.first_dense_layers
    return ([("dense_stack.", nd, False)] if nd > 0 else []) + \
        [("moe_stack.", cfg.num_layers - nd, True)]


# each stack's group in the cache tree (the reference's init_cache)
_CACHE_GROUP = {"stack.": "layers", "dense_stack.": "dense",
                "moe_stack.": "moe"}


def _attn_layer_cache(cfg, batch, max_len, kw):
    """One attention layer's zero cache (``transformer.py:174-183``):
    MLA's latent and shared rope key, else the rotated K and V."""
    if cfg.block_kind == "mla":
        m = cfg.mla
        return {"c_kv": torch.zeros((batch, max_len, m.kv_lora_rank), **kw),
                "k_rope": torch.zeros((batch, max_len, m.qk_rope_head_dim),
                                      **kw)}
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, **kw), "v": torch.zeros(shape, **kw)}


def init_cache(cfg, batch, max_len, *, dtype=torch.bfloat16, device="cuda",
               data=1, model=1):
    """The zero serving cache of ``batch`` sequences of up to ``max_len``
    tokens in ``dtype`` on ``device`` (``transformer.py:186-217``): every
    leaf of one layer's cache stacked on a leading L axis, under
    ``"layers"`` (``"dense"`` and ``"moe"`` for an MoE decoder, ``"dense"``
    only with leading dense layers). An attention cache's dtype must be
    the compute dtype (``attention.write_cache`` raises otherwise); RWKV6's
    and Mamba2's are cast to and from as the reference does. A Mamba2
    model's is ``{"mamba": ...}``, a hybrid's with ``"attn"``: the shared
    block's K and V, one slot per group (G = num_layers / hybrid_group).

    ``data`` and ``model``: one rank's part of the cache of a layout of
    ``data`` data ranks and ``model`` model ranks
    (``core/sharding.py::cache_dims``): ``batch / data`` rows, and on the
    model axis this rank's heads (D9) or, for MLA's latents where the
    model axis divides ``max_len``, this rank's ``max_len / model`` rows
    of the sequence. The defaults give the whole cache."""
    if not cfg.supports_decode():
        raise ValueError(f"{cfg.name} has no decode step")
    meta = {"dtype": dtype, "device": "meta"}       # one layer's shapes

    def stacked(layer, n):
        return {k: (n,) + tuple(v.shape) for k, v in layer.items()}
    if _is_mamba(cfg):
        whole = {"mamba": stacked(init_mamba2_cache(cfg, batch, **meta),
                                  cfg.num_layers)}
        if cfg.hybrid_group > 0:
            whole["attn"] = stacked(
                _attn_layer_cache(cfg, batch, max_len, meta),
                cfg.num_layers // cfg.hybrid_group)
    else:
        layer = init_rwkv6_cache(cfg, batch, **meta) if _is_rwkv(cfg) \
            else _attn_layer_cache(cfg, batch, max_len, meta)
        whole = {_CACHE_GROUP[prefix]: stacked(layer, n)
                 for prefix, n, _ in _stacks(cfg)}
    dims = cache_dims(cfg, whole, data, model)
    return {group: {k: torch.zeros(
        cache_shape(cfg, k, shape, dims[group][k], data, model),
        dtype=dtype, device=device) for k, shape in leaves.items()}
        for group, leaves in whole.items()}


def init_params(cfg, *, seed=0, device="cuda", draw_on="cpu"):
    """Flat {dotted key: fp32 tensor} params, drawn from a generator on
    ``draw_on`` seeded with ``seed`` in a fixed order, then moved to
    ``device``. The CPU's (the default) gives the same weights wherever
    they go; a card's gives other values from the same seed, many times
    faster."""
    gen = None if torch.device(device).type == "meta" else \
        torch.Generator(device=draw_on).manual_seed(seed)
    kw = {"generator": gen, "device": device}
    d, L = cfg.d_model, cfg.num_layers
    vit = _is_vit(cfg)
    if vit:
        n_patch = (cfg.image_size // cfg.patch_size) ** 2
        p = {
            "embed.patch_w": dense_init((cfg.patch_size ** 2 * 3, d), **kw),
            "embed.patch_b": zeros((d,), device=device),
            "embed.cls": zeros((1, 1, d), device=device),
            "embed.pos": embed_init((n_patch + 1, d), **kw),
        }
    elif _is_audio(cfg):
        p = {
            "embed.feat_proj": dense_init((cfg.audio_feat_dim, d), **kw),
            "embed.feat_b": zeros((d,), device=device),
            "embed.mask_emb": embed_init((d,), **kw),
        }
    else:
        p = {"embed.tok": embed_init((cfg.vocab_size, d), **kw)}
    if _is_rwkv(cfg):
        for ln in ("ln1", "ln2"):
            p[f"stack.{ln}.scale"] = ones((L, d), device=device)
        for name, group in (("time_mix", init_rwkv6(cfg, L, **kw)),
                            ("channel_mix", init_rwkv6_channel_mix(cfg, L,
                                                                   **kw))):
            p.update({f"stack.{name}.{k}": v for k, v in group.items()})
        p["final_norm.scale"] = ones((d,), device=device)
        p["head.w"] = dense_init((d, cfg.vocab_size), **kw)
        return p
    if _is_mamba(cfg):
        p["stack.ln.scale"] = ones((L, d), device=device)
        p.update({f"stack.mamba.{k}": v
                  for k, v in init_mamba2(cfg, L, **kw).items()})
        if cfg.hybrid_group > 0:
            # Zamba2's one weight-shared attention + MLP block, unstacked
            p.update(_init_layer(cfg, "shared_attn.", (), False, kw))
    else:
        for prefix, n, use_moe in _stacks(cfg):
            p.update(_init_layer(cfg, prefix, (n,), use_moe, kw))
    p["final_norm.scale"] = ones((d,), device=device)
    if _layer_norm(cfg):
        p["final_norm.bias"] = zeros((d,), device=device)
    if vit:
        p["head.w"] = dense_init((d, cfg.num_classes), **kw)
        p["head.b"] = zeros((cfg.num_classes,), device=device)
    elif not cfg.tie_embeddings:
        p["head.w"] = dense_init((d, cfg.vocab_size), **kw)
    if cfg.mtp_depth > 0:
        # one MTP module for any depth, as the reference builds
        # (transformer.py:161-167): its block is a dense layer, unstacked
        p["mtp.proj"] = dense_init((2 * d, d), **kw)
        p.update(_init_layer(cfg, "mtp.block.", (), False, kw))
        for norm in ("norm_h", "norm_e", "final_norm"):
            p[f"mtp.{norm}.scale"] = ones((d,), device=device)
    return p


def _init_layer(cfg, prefix, lead, use_moe, kw):
    """One attention (or MLA) layer's params under ``prefix``, each with
    the leading dims ``lead``: ``(n,)`` for a stack of n layers, ``()``
    for the MTP head's one block and Zamba2's shared block. LayerNorm (the
    ViT, the audio encoder) has a bias, RMSNorm only a scale (the
    reference's ``_init_norm``); an MLA layer's
    ``attn.*`` are the reference's ``init_mla`` keys, its two latent norms
    ones."""
    device = kw["device"]
    d, h, kh, hd, ff = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                        cfg.head_dim, cfg.d_ff)
    p = {}
    for ln in ("ln1", "ln2"):
        p[f"{prefix}{ln}.scale"] = ones(lead + (d,), device=device)
        if _layer_norm(cfg):
            p[f"{prefix}{ln}.bias"] = zeros(lead + (d,), device=device)
    if cfg.block_kind == "mla":
        m = cfg.mla
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        p.update({
            f"{prefix}attn.w_dq": dense_init(lead + (d, m.q_lora_rank), **kw),
            f"{prefix}attn.q_norm": ones(lead + (m.q_lora_rank,),
                                         device=device),
            f"{prefix}attn.w_uq": dense_init(lead + (m.q_lora_rank, h * qk),
                                             **kw),
            f"{prefix}attn.w_dkv": dense_init(
                lead + (d, m.kv_lora_rank + m.qk_rope_head_dim), **kw),
            f"{prefix}attn.kv_norm": ones(lead + (m.kv_lora_rank,),
                                          device=device),
            f"{prefix}attn.w_uk": dense_init(
                lead + (m.kv_lora_rank, h * m.qk_nope_head_dim), **kw),
            f"{prefix}attn.w_uv": dense_init(
                lead + (m.kv_lora_rank, h * m.v_head_dim), **kw),
            f"{prefix}attn.wo": dense_init(lead + (h * m.v_head_dim, d),
                                           **kw),
        })
    else:
        p[f"{prefix}attn.wq"] = dense_init(lead + (d, h * hd), **kw)
        p[f"{prefix}attn.wk"] = dense_init(lead + (d, kh * hd), **kw)
        p[f"{prefix}attn.wv"] = dense_init(lead + (d, kh * hd), **kw)
        p[f"{prefix}attn.wo"] = dense_init(lead + (h * hd, d), **kw)
        if cfg.qkv_bias:
            p[f"{prefix}attn.bq"] = zeros(lead + (h * hd,), device=device)
            p[f"{prefix}attn.bk"] = zeros(lead + (kh * hd,), device=device)
            p[f"{prefix}attn.bv"] = zeros(lead + (kh * hd,), device=device)
    if use_moe:
        p.update({f"{prefix}moe.{k}": v
                  for k, v in init_moe(cfg, lead[0], **kw).items()})
        return p
    gated = is_gated(cfg.act)
    if gated:
        p[f"{prefix}mlp.w_gate"] = dense_init(lead + (d, ff), **kw)
    p[f"{prefix}mlp.w_up"] = dense_init(lead + (d, ff), **kw)
    p[f"{prefix}mlp.w_out"] = dense_init(lead + (ff, d), **kw)
    if not gated:
        p[f"{prefix}mlp.b_up"] = zeros(lead + (ff,), device=device)
        p[f"{prefix}mlp.b_out"] = zeros(lead + (d,), device=device)
    return p


def _apply_norm(cfg, params, prefix, h):
    """LayerNorm for the ViT and the audio encoder, RMSNorm for the rest,
    with the params under ``prefix`` (``final_norm.`` or one layer's
    ``ln1.``/``ln2.``/``ln.``)."""
    if _layer_norm(cfg):
        return layernorm(h, params[prefix + "scale"], params[prefix + "bias"],
                         cfg.norm_eps)
    return rmsnorm(h, params[prefix + "scale"], cfg.norm_eps,
                   use_kernels=cfg.use_kernels)


def _layer(params, prefix, i):
    """The params under ``prefix`` with the prefix dropped: layer ``i``'s
    slice of each stacked param, or the params themselves for ``i`` None."""
    n = len(prefix)
    return {k[n:]: v if i is None else v[i] for k, v in params.items()
            if k.startswith(prefix)}


def _sinusoidal_pos(s, d, device):
    """The (S, D) fp32 sinusoidal position table (``transformer.py:
    373-381``): sin at the even columns, cos at the odd ones."""
    pos = torch.arange(s, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / d))
    pe = torch.zeros((s, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def _embed(cfg, params, batch, mode="train"):
    """``(h (B,S,D) in the compute dtype, rope positions or None)``
    (``transformer.py:362-430``). ViT: NHWC patchify (reshape + transpose,
    then a matmul — not a conv), a zero CLS token in front, and learned
    positions. Audio: ``features @ feat_proj + feat_b``, ``mask_emb`` at
    the frames ``batch["mask"]`` sets (when it has one), plus the
    sinusoidal table; no positions. Decoder: the embedding of
    ``batch["tokens"]`` (B,S), or in decode of ``batch["token"]`` (B,1)
    (times sqrt(d_model) rounded to the compute dtype first, with
    ``embed_scale``, as the reference's
    ``jnp.asarray(math.sqrt(d), dtype)``: 62.0 in bf16 at d 3840). A vlm
    batch's ``image_embeds`` (B, n_img, D) replace the first n_img rows
    (not in decode). Positions (None for RWKV6, which has none): in
    decode ``batch["index"]`` (an int) for every row; else 0..S-1, as
    (B,S), or for M-RoPE ``batch["positions"]`` (B,S,3) when given, else
    0..S-1 in each of the three sections."""
    dt = compute_dtype(cfg)
    if _is_audio(cfg):
        h = batch["features"].to(dt) @ params["embed.feat_proj"].to(dt) + \
            params["embed.feat_b"].to(dt)
        if "mask" in batch:                 # masked prediction
            h = torch.where(batch["mask"][..., None],
                            params["embed.mask_emb"].to(dt), h)
        return h + _sinusoidal_pos(h.shape[1], cfg.d_model,
                                   h.device).to(dt)[None], None
    if not _is_vit(cfg):
        decode = mode == "decode"
        tokens = (batch["token"] if decode else batch["tokens"]).long()
        h = _lookup(cfg, params["embed.tok"], tokens, dt)
        if cfg.embed_scale:
            h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=dt,
                                 device=h.device)
        if cfg.arch_type == "vlm" and not decode and "image_embeds" in batch:
            img = batch["image_embeds"]
            h = torch.cat([img.to(dt), h[:, img.shape[1]:]], dim=1)
        if _is_rwkv(cfg):
            return h, None
        b, s = tokens.shape
        mrope = cfg.rope_style == "mrope"
        if decode:
            positions = torch.full((b, 1, 3) if mrope else (b, 1),
                                   int(batch["index"]), dtype=torch.int64,
                                   device=tokens.device)
        elif mrope and batch.get("positions") is not None:
            positions = batch["positions"].long()
        else:
            positions = torch.arange(s, device=tokens.device)[None].expand(
                b, s)
            if mrope:
                positions = positions[..., None].expand(b, s, 3)
        return h, positions
    images = batch["images"]
    b = images.shape[0]
    ps = cfg.patch_size
    n = cfg.image_size // ps
    patches = images.reshape(b, n, ps, n, ps, 3).permute(0, 1, 3, 2, 4, 5)
    patches = patches.reshape(b, n * n, ps * ps * 3).to(dt)
    h = patches @ params["embed.patch_w"].to(dt) + params["embed.patch_b"].to(dt)
    cls = params["embed.cls"].to(dt).expand(b, 1, cfg.d_model)
    h = torch.cat([cls, h], dim=1)
    return h + params["embed.pos"].to(dt)[None], None


def _lookup(cfg, table, tokens, dtype):
    """``table[tokens]`` in ``dtype``. Where a model group splits the
    table's vocabulary rows ("vocab"), this rank's rows looked up (zeros
    for the others' tokens) and summed over the group (an exact sum: one
    rank holds each row). Where it splits the feature columns ("dmodel"),
    this rank's columns looked up and gathered whole on the features.
    That gather's backward keeps this rank's columns of the gradient with
    no collective: right because the residual stream's gradient is the
    same on every model rank (each split product's input passes
    ``copy_to_model``, whose backward sums over the group)."""
    tp = shardctx.active()
    n, d = table.shape
    if tp is None or (n, d) == (cfg.vocab_size, cfg.d_model):
        return table[tokens].to(dtype)
    if d != cfg.d_model:
        return shardctx.gather_from_model(table[tokens].to(dtype))
    local = tokens - tp.rank * n
    mine = (local >= 0) & (local < n)
    rows = table[torch.where(mine, local, 0)]
    return shardctx.reduce_from_model(
        torch.where(mine[..., None], rows, 0)).to(dtype)


def _head(cfg, params, h):
    """The final norm, then the CLS row's classifier (ViT) or the LM head
    over every position (the embedding transposed when tied). Under a
    model group the ViT's logits come gathered whole; a decoder's stay
    vocab-sharded where ``head.w`` (``embed.tok``) is split."""
    h = _apply_norm(cfg, params, "final_norm.", h)
    if _is_vit(cfg):
        cls, w = h[:, 0], params["head.w"]
        if shardctx.active() is not None and w.shape[1] != cfg.num_classes:
            logits = shardctx.gather_from_model(
                shardctx.copy_to_model(cls) @ w.to(h.dtype))
        else:
            logits = cls @ w.to(h.dtype)
        return logits + params["head.b"].to(h.dtype)
    return _lm_head(cfg, params, h)


def _lm_head(cfg, params, h):
    """``h @ head.w`` (the embedding transposed when tied); where a model
    group splits the vocabulary, this rank's chunk of the logits. A tied
    embedding split on its features ("dmodel") is a row-parallel product:
    this rank's columns of ``h`` against its columns of the table, summed
    over the group into whole logits. The partial logits are summed in
    fp32 and rounded to ``h``'s dtype once: a bf16 sum would round at
    every step of the reduction, an error that grows with the group's
    size."""
    w = params["embed.tok"].T if cfg.tie_embeddings else params["head.w"]
    if w.shape[0] != cfg.d_model:
        n = w.shape[0]
        lo = shardctx.active().rank * n
        x = shardctx.copy_to_model(h)[..., lo:lo + n]
        return shardctx.reduce_from_model(
            (x @ w.to(h.dtype)).float()).to(h.dtype)
    if w.shape[1] != cfg.vocab_size:
        h = shardctx.copy_to_model(h)
    return h @ w.to(h.dtype)


def _whole_if(cfg, kind):
    """The model group lifted around a block of ``kind`` that runs whole on
    every model rank because the model axis does not divide its split
    count (``core/sharding.py::whole_blocks``, ROADMAP F2): inside it the
    block's collectives are the identity. Else nothing changes. Under a
    sequence group (Ulysses) no model group is installed: an MoE whose
    experts M does not divide holds them whole, runs every one on the
    gathered rows and keeps its own rows of the output, with no
    reduce-scatter (``models/moe.py``)."""
    tp = shardctx.active()
    if tp is not None and kind in whole_blocks(cfg, tp.size):
        return shardctx.use(None)
    return contextlib.nullcontext()


def _block(cfg, layer, h, window, positions, use_moe=False, reduce=None,
           cache=None, cache_index=0, seq=None):
    """One pre-norm layer on ``layer``'s params (its stack's slice with the
    prefix dropped): ``h += attn(norm1 h)``, then ``h += mlp(norm2 h)`` (or
    the MoE's output with ``use_moe``); for RWKV6 the time mix and the
    channel mix. ``cache``: this layer's slice of the serving cache,
    written in place; ``seq``: the Ulysses split (``h`` is this rank's
    rows). Returns ``(h, the layer's MoE aux or None)``."""
    a_in = _apply_norm(cfg, layer, "ln1.", h)
    if _is_rwkv(cfg):
        tc = cc = None
        if cache is not None:
            tc = {"shift": cache["att_shift"], "wkv": cache["wkv"]}
            cc = {"shift": cache["ffn_shift"]}
        with _whole_if(cfg, "time_mix"):
            h = h + rwkv6_time_mix(_layer(layer, "time_mix.", None), a_in,
                                   cfg, cache=tc)
        with _whole_if(cfg, "channel_mix"):
            return h + rwkv6_channel_mix(
                _layer(layer, "channel_mix.", None),
                _apply_norm(cfg, layer, "ln2.", h), cfg, cache=cc), None
    with _whole_if(cfg, "attn"):
        if cfg.block_kind == "mla":
            h = h + mla_block(_layer(layer, "attn.", None), a_in, cfg,
                              positions=positions, cache=cache,
                              cache_index=cache_index)
        else:
            h = h + attention_block(_layer(layer, "attn.", None), a_in, cfg,
                                    window=window, positions=positions,
                                    cache=cache, cache_index=cache_index,
                                    seq=seq)
    m_in = _apply_norm(cfg, layer, "ln2.", h)
    if not use_moe:
        with _whole_if(cfg, "mlp"):
            return h + mlp(_layer(layer, "mlp.", None), m_in, cfg.act), None
    moe = moe_ffn_gather if cfg.moe_impl == "gather" else moe_ffn
    with _whole_if(cfg, "moe"):
        ff, aux = moe(_layer(layer, "moe.", None), m_in, cfg, reduce, seq)
    return h + ff, aux


def _step(cfg, gather, reduce, positions, index, seq, h, shards, prefix,
          window, use_moe, layer_cache=None):
    """One layer of a stack, the body :func:`forward` and
    :func:`stack_forward` share: ``shards`` (its slice of each stacked
    param, gathered whole through ``gather`` when given), then a Mamba2
    layer or :func:`_block` (``seq``: the Ulysses split, or None). Returns
    ``(h, the layer's MoE aux or None)``."""
    layer = _layer(shards if gather is None else gather(shards), prefix,
                   None)
    if _is_mamba(cfg):
        with _whole_if(cfg, "mamba"):
            return h + mamba2_block(_layer(layer, "mamba.", None),
                                    _apply_norm(cfg, layer, "ln.", h), cfg,
                                    cache=layer_cache), None
    return _block(cfg, layer, h, window, positions, use_moe, reduce,
                  layer_cache, index, seq)


def _dots_policy(ctx, op, *args, **kwargs):
    """``remat="dots"``: save the outputs of ``x @ w`` (activations, folded
    to 2-D, against a weight: ``aten.mm``) and recompute the rest, batched
    products (``bmm``, the naive attention's einsums) included, as
    ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable`` does."""
    return CheckpointPolicy.MUST_SAVE if op is torch.ops.aten.mm.default \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg, fn):
    """``fn`` as the reference's ``_remat`` wraps a layer (``transformer.py:
    242-248``): "block" saves only its inputs and recomputes the body in
    the backward (as far as the backward needs), "dots" also saves the
    outputs of its projection products (torch's selective checkpoint; the
    experts' batched products are recomputed), "none" saves everything.
    Every output of ``fn`` (a layer's ``(h, aux)``) comes out of the
    checkpointed body."""
    if cfg.remat == "none":
        return fn
    kw = {"use_reentrant": False}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    return lambda *args: checkpoint(fn, *args, **kw)


def forward(cfg, params, batch, gather=None, reduce=None, *, mode="train",
            cache=None):
    """``(logits, aux)`` in ``mode`` "train" and "eval", and ``(logits,
    cache, aux)`` in "prefill" and "decode" (the reference's ``forward``
    returns the three in every mode; the training and eval callers keep
    the two). "eval" is "train" without the MTP head. Logits in the compute dtype, (B, num_classes) for a
    preprocessed float ``batch["images"]`` (B, H, W, 3), (B, S, vocab) for
    ``batch["tokens"]`` (B, S) (with ``image_embeds`` and ``positions`` for
    a vlm); ``aux`` ``{"moe_aux": fp32 scalar}``, the MoE layers'
    load-balance losses summed (0 without experts), and with
    ``cfg.mtp_depth > 0`` in mode "train" ``"mtp_logits"``
    (B, S, vocab) of the MTP head (:func:`_mtp_logits`). Pre-norm blocks:
    ``h += attn(norm1 h)`` (MLA with ``block_kind="mla"``), then ``h +=
    mlp(norm2 h)`` or the MoE; for RWKV6 ``h += time_mix(norm1 h)``, then
    ``h += channel_mix(norm2 h)``; for Mamba2 ``h += mamba2(norm h)``,
    and in a hybrid the shared block (window 0) after every
    ``hybrid_group`` layers (the reference's ``_group_body``). The layers
    run stack by stack (``_stacks``), each with its window of
    ``cfg.layer_windows()``. The audio encoder's ``batch`` brings
    ``features`` (B, S, audio_feat_dim) and ``mask`` (B, S); its logits
    are (B, S, vocab).

    Serving (``transformer.py:452-528``): "prefill" runs the prompt
    ``batch["tokens"]`` (B, S) and writes it into ``cache`` (from
    :func:`init_cache`) at rows 0..S-1; "decode" runs ``batch["token"]``
    (B, 1) at position ``batch["index"]`` (an int) and writes that row.
    Each layer writes its slice of the cache in place, and the same cache
    comes back. Serving runs on whole params: no ``gather``, no remat, no
    MTP head.

    ``gather``, when given, maps ``{key: param}`` to the tensors the model
    computes with where they are used: the non-stacked params (``mtp.*``
    among them) once before the embed, the stacked ones a layer's slices
    at a time in the layer loop (ZeRO-3 gathers its shards there). The
    gather of a layer runs inside its checkpointed body under
    ``cfg.remat``, so the backward's recompute gathers the layer again
    rather than keeping it whole (the reference checkpoints a hybrid's
    whole group; here each Mamba2 layer and each use of the shared block,
    the same arithmetic). ``reduce`` is the MoE's hook for its
    routed fractions (``models/moe.py``): their mean over the
    data-parallel ranks."""
    if mode not in ("train", "eval", "prefill", "decode"):
        raise ValueError(
            f"mode {mode!r} not in (train, eval, prefill, decode)")
    serving = mode in ("prefill", "decode")
    if serving and (cache is None or gather is not None):
        raise ValueError(f"mode {mode!r} needs a cache and whole params "
                         f"(no gather)")
    if not serving and cache is not None:
        raise ValueError("a cache is for the prefill and decode modes")
    stacked = {k: v for k, v in params.items() if is_stacked(k)}
    if gather is not None:
        params = gather({k: v for k, v in params.items()
                         if k not in stacked})
    h, positions = _embed(cfg, params, batch, mode)
    seq = None if serving else shardctx.split_sequence(h.shape[1])
    if seq is not None:
        if not ulysses.supports(cfg):
            raise ValueError(f"{cfg.name}: the Ulysses layout runs plain "
                             f"attention families only (ROADMAP D8)")
        # the rank's rows in a buffer of their own (the norms take them
        # as a matrix of rows)
        h = h[:, seq.rows].contiguous()
        if positions is not None:
            positions = positions[:, seq.rows]
    index = int(batch["index"]) if mode == "decode" else 0
    step = functools.partial(_step, cfg, gather, reduce, positions, index,
                             seq)

    def shared_step(h, layer_cache=None):
        # the hybrid's shared block, on params gathered before the embed
        return _block(cfg, _layer(params, "shared_attn.", None), h, 0,
                      positions, cache=layer_cache, cache_index=index)[0]

    if not serving:
        step, shared_step = _remat(cfg, step), _remat(cfg, shared_step)
    windows = iter(cfg.layer_windows())
    moe_aux = torch.zeros((), dtype=torch.float32, device=h.device)
    g = cfg.hybrid_group
    for prefix, n, use_moe in _stacks(cfg):
        group = {k: v for k, v in stacked.items() if k.startswith(prefix)}
        caches = cache["mamba" if _is_mamba(cfg) else _CACHE_GROUP[prefix]] \
            if serving else None
        for i in range(n):
            layer_cache = {k: v[i] for k, v in caches.items()} \
                if serving else None
            h, aux = step(h, {k: v[i] for k, v in group.items()}, prefix,
                          next(windows), use_moe, layer_cache)
            if aux is not None:
                moe_aux = moe_aux + aux
            if g and (i + 1) % g == 0:
                h = shared_step(h, {k: v[i // g] for k, v in
                                    cache["attn"].items()}
                                if serving else None)
    aux = {"moe_aux": moe_aux}
    if cfg.mtp_depth > 0 and mode == "train":
        aux["mtp_logits"] = _mtp_logits(cfg, params, batch, h, positions)
    if seq is not None and _is_vit(cfg):
        h = shardctx.gather_seq(h, seq)
    logits = _head(cfg, params, h)
    return (logits, cache, aux) if serving else (logits, aux)


def embed(cfg, params, batch):
    """The pipeline's first stage (``transformer.py:642-644``): ``(h in
    the compute dtype, rope positions or None)`` of a training batch."""
    return _embed(cfg, params, batch)


def stack_forward(cfg, stack, h, positions, windows, gather=None):
    """A contiguous slice of an attention (or MLA) stack in train mode, no
    cache: the pipeline's unit of work (``transformer.py:652-660``).
    ``stack``: ``{"stack.<name>": (n, ...)}`` (each leaf's rows of the
    slice), ``windows``: the n layers' windows. Each layer takes its row
    through one ``unbind`` of each leaf (one backward for the slice, not a
    whole-leaf select per layer), runs :func:`forward`'s layer body, and is
    checkpointed under ``cfg.remat``; ``gather`` as :func:`forward`'s, for
    the stacked leaves."""
    if cfg.block_kind not in ("attn", "mla") or cfg.has_moe:
        raise ValueError(f"{cfg.name}: stack_forward runs dense attn/mla "
                         f"stacks only")
    step = _remat(cfg, functools.partial(_step, cfg, gather, None,
                                         positions, 0, None))
    rows = {k: v.unbind(0) for k, v in stack.items()}
    for i, window in enumerate(windows):
        h, _ = step(h, {k: r[i] for k, r in rows.items()}, "stack.",
                    window, False)
    return h


def apply_head(cfg, params, h):
    """The pipeline's last stage before the loss: the final norm and the
    classifier or LM head (``transformer.py:647-649``)."""
    return _head(cfg, params, h)


def _mtp_logits(cfg, params, batch, h, positions):
    """The multi-token prediction head (reference ``transformer.py:
    511-526``): the next tokens ``concat(tok[:, 1:], tok[:, -1:])``
    embedded (no embedding scale), ``concat(norm_h(h), norm_e(e_next)) @
    mtp.proj`` on the last layer's output ``h`` (before the final norm),
    one dense block (window 0, never checkpointed, as in the reference),
    ``mtp.final_norm`` and the LM head (the embedding transposed when
    tied). Its logits feed the loss's 0.3-weighted term for the token two
    ahead (:func:`loss_from_logits`). Under a model group the next tokens
    take the main lookup's path (vocab-parallel, or gathered on the
    features under "dmodel"), ``mtp.proj`` is replicated, the block
    splits as a dense layer and the logits take the main head's path."""
    tok = batch["tokens"].long()
    nxt = torch.cat([tok[:, 1:], tok[:, -1:]], dim=1)
    e_next = _lookup(cfg, params["embed.tok"], nxt, h.dtype)
    mh = torch.cat([_apply_norm(cfg, params, "mtp.norm_h.", h),
                    _apply_norm(cfg, params, "mtp.norm_e.", e_next)],
                   dim=-1) @ params["mtp.proj"].to(h.dtype)
    mh, _ = _block(cfg, _layer(params, "mtp.block.", None), mh, 0,
                   positions)
    return _lm_head(cfg, params,
                    _apply_norm(cfg, params, "mtp.final_norm.", mh))


def _nll(logits, labels, vocab_parallel=False):
    """Per-position ``-log softmax(logits)[label]`` in fp32; with
    ``vocab_parallel`` the logits are this rank's vocabulary chunk
    (``shardctx.vocab_parallel_nll``)."""
    if vocab_parallel:
        return shardctx.vocab_parallel_nll(logits, labels)
    logits = logits.to(torch.float32)
    return torch.logsumexp(logits, dim=-1) - \
        logits.gather(-1, labels.long()[..., None])[..., 0]


def _xent(logits, labels, mask=None, vocab_parallel=False,
          rows=slice(None)):
    """Mean hard-label cross-entropy in fp32, masked when ``mask`` is given
    (the logits vocab-sharded with ``vocab_parallel``). With a mask the
    logits are the positions ``rows`` of the labels' and mask's last
    dimension (a Ulysses rank's, else all), and their sum is divided by
    the whole mask's count."""
    if mask is None:
        return _nll(logits, labels, vocab_parallel).mean()
    mask = mask.to(torch.float32)
    nll = _nll(logits, labels[..., rows], vocab_parallel)
    return (nll * mask[..., rows]).sum() / mask.sum().clamp_min(1.0)


def _soft_xent(logits, labels, *, smoothing=0.0):
    """Mean cross-entropy against a soft (B, C) target, with optional
    uniform label smoothing ``y <- (1 - eps) * y + eps / C``. Hard int
    labels are one-hotted first (the smoothing-only case)."""
    logits = logits.to(torch.float32)
    num_classes = logits.shape[-1]
    if labels.ndim == logits.ndim - 1:
        y = torch.nn.functional.one_hot(labels.long(), num_classes).to(
            torch.float32)
    else:
        y = labels.to(torch.float32)
    if smoothing:
        y = y * (1.0 - smoothing) + smoothing / num_classes
    logp = logits - torch.logsumexp(logits, dim=-1, keepdim=True)
    return (-(y * logp).sum(dim=-1)).mean()


def loss_from_logits(cfg, logits, batch, aux=None, reduce=None):
    """``(loss, metrics)`` of the reference's ``loss_from_logits``
    (``transformer.py:592-627``). ViT: ``_soft_xent`` for soft labels or
    label smoothing, else ``_xent``; metrics ``acc``, ``moe_aux`` and
    ``loss``. Decoder: next-token ``_xent`` with the labels shifted by one
    and the last position masked (a vlm's image positions too,
    ``transformer.py:617-619``); with ``aux["mtp_logits"]`` (the MTP
    head) plus 0.3 times its ``_xent`` against the labels shifted by two,
    the last two positions masked (reference ``transformer.py:622-625``);
    metrics ``moe_aux`` and ``loss``. Audio: ``_xent`` of every frame
    against ``batch["labels"]`` over the frames ``batch["mask"]`` sets
    (``transformer.py:612-613``): the mean over the masked frames of the
    whole microbatch, whose count ``reduce`` (the data-parallel mean over
    the ranks, each holding its rows) makes the global one, so the ranks'
    mean loss is the reference's at any world (rows mask different
    numbers of frames). The loss adds ``aux["moe_aux"]``
    (``forward``'s; 0 when ``aux`` is None). Under a sequence group a
    decoder's and HuBERT's logits are this rank's rows (``forward``): the
    labels and masks are built whole and sliced, and the count stays the
    whole microbatch's, so the loss is this rank's share of the sum."""
    moe_aux = aux["moe_aux"] if aux is not None else torch.zeros(
        (), dtype=torch.float32, device=logits.device)
    # a decoder's or the audio encoder's logits hold this rank's chunk of
    # the vocabulary where a model group splits the head (a tied head
    # under "dmodel" gives them whole: the plain NLL)
    sharded = not _is_vit(cfg) and shardctx.active() is not None and \
        logits.shape[-1] != cfg.vocab_size
    seq = None if _is_vit(cfg) else shardctx.split_sequence(
        (batch["labels"] if _is_audio(cfg) else batch["tokens"]).shape[1])
    rows = seq.rows if seq is not None else slice(None)
    if _is_audio(cfg):
        mask = batch["mask"].to(torch.float32)
        nll = _nll(logits, batch["labels"][:, rows], sharded)
        count = mask.sum() if reduce is None else reduce(mask.sum())
        # a whole count of 0 leaves the sum 0: max(count, 1) as the
        # reference's, at the ranks' mean count too
        loss = (nll * mask[:, rows]).sum() / torch.where(count > 0, count,
                                                          1.0) + moe_aux
        return loss, {"moe_aux": moe_aux, "loss": loss}
    if not _is_vit(cfg):
        tok = batch["tokens"]
        mask = torch.ones(tok.shape, dtype=torch.bool, device=tok.device)
        mask[:, -1] = False
        if cfg.arch_type == "vlm" and "image_embeds" in batch:
            mask[:, :batch["image_embeds"].shape[1]] = False
        labels = torch.cat([tok[:, 1:], tok[:, -1:]], dim=1)
        loss = _xent(logits, labels, mask, sharded, rows)
        if aux is not None and "mtp_logits" in aux:
            l2 = torch.cat([labels[:, 1:], labels[:, -1:]], dim=1)
            m2 = mask.clone()
            m2[:, -2:] = False
            loss = loss + 0.3 * _xent(aux["mtp_logits"], l2, m2, sharded)
        loss = loss + moe_aux
        return loss, {"moe_aux": moe_aux, "loss": loss}
    labels = batch["labels"]
    soft = labels.ndim == 2             # Mixup/CutMix soft-label batches
    if soft or cfg.label_smoothing > 0.0:
        loss = _soft_xent(logits, labels, smoothing=cfg.label_smoothing)
    else:
        loss = _xent(logits, labels)
    hard = labels.argmax(-1) if soft else labels.long()
    loss = loss + moe_aux
    acc = (logits.argmax(-1) == hard).to(torch.float32).mean()
    return loss, {"acc": acc, "moe_aux": moe_aux, "loss": loss}


def metric_names(cfg) -> tuple:
    """The keys of :func:`loss_from_logits`' metrics for ``cfg``, known
    before any loss is taken (a pipeline stage without the head reduces
    zeros under them)."""
    return ("acc", "moe_aux", "loss") if _is_vit(cfg) else ("moe_aux", "loss")


def loss_fn(cfg, params, batch, gather=None, reduce=None):
    """Scalar training loss and its metrics for a preprocessed batch."""
    logits, aux = forward(cfg, params, batch, gather, reduce)
    return loss_from_logits(cfg, logits, batch, aux, reduce)


def classification_counts(logits, labels, mask=None, *, topk=5):
    """Integer top-1/top-5/count plus the fp32 NLL sum of one eval batch.

    Counts, not means, are the reduction unit, so eval accuracy does not
    depend on batching. ``mask`` (B,) zeroes the padded tail. Ties go to
    the lower index, as ``jnp.argmax`` and ``lax.top_k`` break them."""
    logits = logits.to(torch.float32)
    labels = labels.long()
    if mask is None:
        mask = torch.ones(labels.shape[:1], dtype=torch.float32,
                          device=logits.device)
    maski = mask.to(torch.int64)
    pred = logits.argmax(dim=-1)
    k = min(topk, logits.shape[-1])
    # a stable sort puts equal logits in index order, as lax.top_k does
    topi = logits.sort(dim=-1, descending=True, stable=True).indices[:, :k]
    in_topk = (topi == labels[:, None]).any(dim=-1)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[:, None])[:, 0]
    return {
        "top1": ((pred == labels).to(torch.int64) * maski).sum(),
        "top5": (in_topk.to(torch.int64) * maski).sum(),
        "count": maski.sum(),
        "loss_sum": ((lse - gold) * mask.to(torch.float32)).sum(),
    }


class Transformer(nn.Module):
    """Holds the params of any family as nested submodules, so
    ``state_dict()`` keys are the reference's dotted paths. The params are
    trainable fp32 leaves; eval runs under ``torch.inference_mode()`` and
    records no graph. Calling it gives the logits alone; training reads
    the MoE aux through ``loss_fn``."""

    def __init__(self, cfg, params):
        super().__init__()
        self.cfg = cfg
        for key, value in params.items():
            *path, leaf = key.split(".")
            mod = self
            for name in path:
                if name not in mod._modules:
                    mod.add_module(name, nn.Module())
                mod = mod._modules[name]
            mod.register_parameter(leaf, nn.Parameter(value))

    def params(self):
        return dict(self.named_parameters())

    def forward(self, batch):
        return forward(self.cfg, self.params(), batch, mode="eval")[0]


ViT = Transformer       # the name the eval and training callers use
