"""The ViT, dense-decoder and RWKV6 branches of
``repro.models.transformer``: init, forward, the training loss and the
eval counts.

Parameters keep the reference's layout so weights cross without
transposes: dense weights are (in, out) and applied as ``x @ w``, the
per-layer params are stacked on a leading L axis under ``stack``, and the
flat keys are the reference pytree's dotted paths (``embed.patch_w``,
``embed.tok``, ``stack.attn.wq``, ``stack.mlp.w_gate``, ``head.w``, ...).
Params are fp32; each is cast to ``cfg.dtype`` where it is used. The
reference scans over layers; here a Python loop runs them, with each
layer's window a Python int. The ViT normalises with LayerNorm, the
decoders with RMSNorm (through K4/K5 when ``cfg.use_kernels``). The RWKV6
branch (``block_kind == "rwkv6"``) replaces attention and MLP by the time
mix and the channel mix (``models/rwkv6.py``; WKV6 through K6/K7 when
``cfg.use_kernels``), under ``stack.time_mix.*`` and
``stack.channel_mix.*``, and takes no positions.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from repro_torch.models.attention import attention_block
from repro_torch.models.mlp import is_gated, mlp
from repro_torch.models.norms import layernorm, rmsnorm
from repro_torch.models.params import dense_init, embed_init, ones, zeros
from repro_torch.models.rwkv6 import init_rwkv6, init_rwkv6_channel_mix, \
    rwkv6_channel_mix, rwkv6_time_mix

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def compute_dtype(cfg) -> torch.dtype:
    if cfg.dtype not in _DTYPES:
        raise ValueError(f"compute dtype {cfg.dtype!r} not in {tuple(_DTYPES)}")
    return _DTYPES[cfg.dtype]


def _is_vit(cfg) -> bool:
    """The ViT branch, else a decoder: dense or RWKV6 (the config admits no
    other family: ``ModelConfig`` raises on one)."""
    return cfg.arch_type == "vit"


def _is_rwkv(cfg) -> bool:
    return cfg.block_kind == "rwkv6"


def init_params(cfg, *, seed=0, device="cuda"):
    """Flat {dotted key: fp32 tensor} params, drawn from a CPU generator
    seeded with ``seed`` in a fixed order, then moved to ``device``."""
    gen = None if torch.device(device).type == "meta" else \
        torch.Generator().manual_seed(seed)
    kw = {"generator": gen, "device": device}
    d, L = cfg.d_model, cfg.num_layers
    h, kh, hd, ff = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_ff
    vit = _is_vit(cfg)
    if vit:
        n_patch = (cfg.image_size // cfg.patch_size) ** 2
        p = {
            "embed.patch_w": dense_init((cfg.patch_size ** 2 * 3, d), **kw),
            "embed.patch_b": zeros((d,), device=device),
            "embed.cls": zeros((1, 1, d), device=device),
            "embed.pos": embed_init((n_patch + 1, d), **kw),
        }
    else:
        p = {"embed.tok": embed_init((cfg.vocab_size, d), **kw)}
    # LayerNorm has a bias, RMSNorm only a scale (_init_norm)
    for ln in ("ln1", "ln2"):
        p[f"stack.{ln}.scale"] = ones((L, d), device=device)
        if vit:
            p[f"stack.{ln}.bias"] = zeros((L, d), device=device)
    if _is_rwkv(cfg):
        for name, group in (("time_mix", init_rwkv6(cfg, L, **kw)),
                            ("channel_mix", init_rwkv6_channel_mix(cfg, L,
                                                                   **kw))):
            p.update({f"stack.{name}.{k}": v for k, v in group.items()})
        p["final_norm.scale"] = ones((d,), device=device)
        p["head.w"] = dense_init((d, cfg.vocab_size), **kw)
        return p
    p["stack.attn.wq"] = dense_init((L, d, h * hd), **kw)
    p["stack.attn.wk"] = dense_init((L, d, kh * hd), **kw)
    p["stack.attn.wv"] = dense_init((L, d, kh * hd), **kw)
    p["stack.attn.wo"] = dense_init((L, h * hd, d), **kw)
    if cfg.qkv_bias:
        p["stack.attn.bq"] = zeros((L, h * hd), device=device)
        p["stack.attn.bk"] = zeros((L, kh * hd), device=device)
        p["stack.attn.bv"] = zeros((L, kh * hd), device=device)
    gated = is_gated(cfg.act)
    if gated:
        p["stack.mlp.w_gate"] = dense_init((L, d, ff), **kw)
    p["stack.mlp.w_up"] = dense_init((L, d, ff), **kw)
    p["stack.mlp.w_out"] = dense_init((L, ff, d), **kw)
    if not gated:
        p["stack.mlp.b_up"] = zeros((L, ff), device=device)
        p["stack.mlp.b_out"] = zeros((L, d), device=device)
    p["final_norm.scale"] = ones((d,), device=device)
    if vit:
        p["final_norm.bias"] = zeros((d,), device=device)
        p["head.w"] = dense_init((d, cfg.num_classes), **kw)
        p["head.b"] = zeros((cfg.num_classes,), device=device)
    else:
        p["head.w"] = dense_init((d, cfg.vocab_size), **kw)
    return p


def _apply_norm(cfg, params, prefix, h):
    """LayerNorm for the ViT, RMSNorm for the decoder, with the params
    under ``prefix`` (``final_norm.`` or one layer's ``ln1.``/``ln2.``)."""
    if _is_vit(cfg):
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


def _embed(cfg, params, batch):
    """``(h (B,S,D) in the compute dtype, rope positions (B,S) or None)``.
    ViT: NHWC patchify (reshape + transpose, then a matmul — not a conv),
    a zero CLS token in front, and learned positions. Decoder: the token
    embedding, positions 0..S-1 (None for RWKV6, which has none)."""
    dt = compute_dtype(cfg)
    if not _is_vit(cfg):
        tokens = batch["tokens"].long()
        h = params["embed.tok"][tokens].to(dt)
        if _is_rwkv(cfg):
            return h, None
        b, s = tokens.shape
        positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
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


def _head(cfg, params, h):
    """The final norm, then the CLS row's classifier (ViT) or the untied
    LM head over every position."""
    h = _apply_norm(cfg, params, "final_norm.", h)
    if _is_vit(cfg):
        cls = h[:, 0]
        return cls @ params["head.w"].to(h.dtype) + \
            params["head.b"].to(h.dtype)
    return h @ params["head.w"].to(h.dtype)


def forward(cfg, params, batch, gather=None):
    """Logits in the compute dtype: (B, num_classes) for a preprocessed
    float ``batch["images"]`` (B, H, W, 3), (B, S, vocab) for
    ``batch["tokens"]`` (B, S). Pre-norm blocks: ``h += attn(norm1 h)``,
    then ``h += mlp(norm2 h)``; for RWKV6 ``h += time_mix(norm1 h)``, then
    ``h += channel_mix(norm2 h)`` (``_run_rwkv_stack``).

    ``gather``, when given, maps ``{key: param}`` to the tensors the model
    computes with where they are used: the non-stacked params once before
    the embed, the stacked ones a layer's slices at a time in the layer
    loop (ZeRO-3 gathers its shards there)."""
    if gather is not None:
        stacked = {k: v for k, v in params.items() if k.startswith("stack.")}
        params = gather({k: v for k, v in params.items()
                         if k not in stacked})
    h, positions = _embed(cfg, params, batch)
    for i, window in enumerate(cfg.layer_windows()):
        layer = _layer(params, "stack.", i) if gather is None else \
            _layer(gather({k: v[i] for k, v in stacked.items()}), "stack.",
                   None)
        a_in = _apply_norm(cfg, layer, "ln1.", h)
        if _is_rwkv(cfg):
            h = h + rwkv6_time_mix(_layer(layer, "time_mix.", None), a_in,
                                   cfg)
            h = h + rwkv6_channel_mix(_layer(layer, "channel_mix.", None),
                                      _apply_norm(cfg, layer, "ln2.", h), cfg)
            continue
        h = h + attention_block(_layer(layer, "attn.", None), a_in, cfg,
                                window=window, positions=positions)
        m_in = _apply_norm(cfg, layer, "ln2.", h)
        h = h + mlp(_layer(layer, "mlp.", None), m_in, cfg.act)
    return _head(cfg, params, h)


def _xent(logits, labels, mask=None):
    """Mean hard-label cross-entropy in fp32, masked when ``mask`` is given."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is None:
        return nll.mean()
    mask = mask.to(torch.float32)
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


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


def loss_from_logits(cfg, logits, batch):
    """``(loss, metrics)`` of the reference's ``loss_from_logits``
    (``transformer.py:600-640``). ViT: ``_soft_xent`` for soft labels or
    label smoothing, else ``_xent``; metrics ``acc``, ``moe_aux`` and
    ``loss``. Decoder: next-token ``_xent`` with the labels shifted by one
    and the last position masked; metrics ``moe_aux`` and ``loss``.
    ``moe_aux`` is 0: no ported model has an MoE."""
    moe_aux = torch.zeros((), dtype=torch.float32, device=logits.device)
    if not _is_vit(cfg):
        tok = batch["tokens"]
        mask = torch.ones(tok.shape, dtype=torch.bool, device=tok.device)
        mask[:, -1] = False
        labels = torch.cat([tok[:, 1:], tok[:, -1:]], dim=1)
        loss = _xent(logits, labels, mask) + moe_aux
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


def loss_fn(cfg, params, batch, gather=None):
    """Scalar training loss and its metrics for a preprocessed batch."""
    return loss_from_logits(cfg, forward(cfg, params, batch, gather), batch)


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
    """Holds the params of either family as nested submodules, so
    ``state_dict()`` keys are the reference's dotted paths. The params are
    trainable fp32 leaves; eval runs under ``torch.inference_mode()`` and
    records no graph."""

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
        return forward(self.cfg, self.params(), batch)


ViT = Transformer       # the name the eval and training callers use
