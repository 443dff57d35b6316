"""The ViT branches of ``repro.models.transformer``: init, forward, loss and
eval counts.

Parameters keep the reference's layout so weights cross without
transposes: dense weights are (in, out) and applied as ``x @ w``, the
per-layer params are stacked on a leading L axis under ``stack``, and the
flat keys are the reference pytree's dotted paths (``embed.patch_w``,
``stack.attn.wq``, ``head.b``, ...). Params are fp32; each is cast to
``cfg.dtype`` where it is used. The reference scans over layers; here a
Python loop runs them, with each layer's window a Python int.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from repro_torch.models.attention import attention_block
from repro_torch.models.mlp import mlp
from repro_torch.models.norms import layernorm
from repro_torch.models.params import dense_init, embed_init, ones, zeros

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def compute_dtype(cfg) -> torch.dtype:
    if cfg.dtype not in _DTYPES:
        raise ValueError(f"compute dtype {cfg.dtype!r} not in {tuple(_DTYPES)}")
    return _DTYPES[cfg.dtype]


def _check_vit(cfg):
    if cfg.arch_type != "vit":
        raise NotImplementedError(
            f"{cfg.name}: only the vit branch is ported (arch_type "
            f"{cfg.arch_type!r})")


def init_params(cfg, *, seed=0, device="cuda"):
    """Flat {dotted key: fp32 tensor} params, drawn from a CPU generator
    seeded with ``seed`` in a fixed order, then moved to ``device``."""
    _check_vit(cfg)
    gen = None if torch.device(device).type == "meta" else \
        torch.Generator().manual_seed(seed)
    kw = {"generator": gen, "device": device}
    d, L = cfg.d_model, cfg.num_layers
    h, kh, hd, ff = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_ff
    n_patch = (cfg.image_size // cfg.patch_size) ** 2
    p = {
        "embed.patch_w": dense_init((cfg.patch_size ** 2 * 3, d), **kw),
        "embed.patch_b": zeros((d,), device=device),
        "embed.cls": zeros((1, 1, d), device=device),
        "embed.pos": embed_init((n_patch + 1, d), **kw),
    }
    for ln in ("ln1", "ln2"):
        p[f"stack.{ln}.scale"] = ones((L, d), device=device)
        p[f"stack.{ln}.bias"] = zeros((L, d), device=device)
    p["stack.attn.wq"] = dense_init((L, d, h * hd), **kw)
    p["stack.attn.wk"] = dense_init((L, d, kh * hd), **kw)
    p["stack.attn.wv"] = dense_init((L, d, kh * hd), **kw)
    p["stack.attn.wo"] = dense_init((L, h * hd, d), **kw)
    p["stack.mlp.w_up"] = dense_init((L, d, ff), **kw)
    p["stack.mlp.b_up"] = zeros((L, ff), device=device)
    p["stack.mlp.w_out"] = dense_init((L, ff, d), **kw)
    p["stack.mlp.b_out"] = zeros((L, d), device=device)
    p["final_norm.scale"] = ones((d,), device=device)
    p["final_norm.bias"] = zeros((d,), device=device)
    p["head.w"] = dense_init((d, cfg.num_classes), **kw)
    p["head.b"] = zeros((cfg.num_classes,), device=device)
    return p


def _layer(params, prefix, i):
    """Layer ``i``'s slice of the stacked params under ``prefix``."""
    n = len(prefix)
    return {k[n:]: v[i] for k, v in params.items() if k.startswith(prefix)}


def _embed(cfg, params, images):
    """NHWC patchify (reshape + transpose, then a matmul — not a conv),
    a zero CLS token in front, and learned positions."""
    dt = compute_dtype(cfg)
    b = images.shape[0]
    ps = cfg.patch_size
    n = cfg.image_size // ps
    patches = images.reshape(b, n, ps, n, ps, 3).permute(0, 1, 3, 2, 4, 5)
    patches = patches.reshape(b, n * n, ps * ps * 3).to(dt)
    h = patches @ params["embed.patch_w"].to(dt) + params["embed.patch_b"].to(dt)
    cls = params["embed.cls"].to(dt).expand(b, 1, cfg.d_model)
    h = torch.cat([cls, h], dim=1)
    return h + params["embed.pos"].to(dt)[None]


def _head(cfg, params, h):
    h = layernorm(h, params["final_norm.scale"], params["final_norm.bias"],
                  cfg.norm_eps)
    cls = h[:, 0]
    return cls @ params["head.w"].to(h.dtype) + params["head.b"].to(h.dtype)


def forward(cfg, params, batch):
    """Logits (B, num_classes) in the compute dtype for a preprocessed
    float ``batch["images"]`` (B, H, W, 3). Pre-LN blocks:
    ``h += attn(LN1 h)``, then ``h += mlp(LN2 h)``."""
    _check_vit(cfg)
    h = _embed(cfg, params, batch["images"])
    for i, window in enumerate(cfg.layer_windows()):
        ln1 = _layer(params, "stack.ln1.", i)
        ln2 = _layer(params, "stack.ln2.", i)
        a_in = layernorm(h, ln1["scale"], ln1["bias"], cfg.norm_eps)
        h = h + attention_block(_layer(params, "stack.attn.", i), a_in, cfg,
                                window=window)
        m_in = layernorm(h, ln2["scale"], ln2["bias"], cfg.norm_eps)
        h = h + mlp(_layer(params, "stack.mlp.", i), m_in)
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


class ViT(nn.Module):
    """Holds the params as nested submodules, so ``state_dict()`` keys are
    the reference's dotted paths. Eval-only for now: the params do not
    require grad."""

    def __init__(self, cfg, params):
        super().__init__()
        _check_vit(cfg)
        self.cfg = cfg
        for key, value in params.items():
            *path, leaf = key.split(".")
            mod = self
            for name in path:
                if name not in mod._modules:
                    mod.add_module(name, nn.Module())
                mod = mod._modules[name]
            mod.register_parameter(leaf, nn.Parameter(value,
                                                      requires_grad=False))

    def params(self):
        return dict(self.named_parameters())

    def forward(self, batch):
        return forward(self.cfg, self.params(), batch)
