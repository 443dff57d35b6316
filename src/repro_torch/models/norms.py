"""LayerNorm, with its math in fp32 (``repro.models.norms.layernorm``)."""
from __future__ import annotations

import torch


def layernorm(x, scale, bias, eps):
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    out = (xf - mu) / torch.sqrt(var + eps)
    return (out * scale.to(torch.float32)
            + bias.to(torch.float32)).to(x.dtype)
