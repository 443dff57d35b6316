"""RMSNorm, LayerNorm and the per-head GroupNorm of RWKV6, with their math
in fp32 (``repro.models.norms``).

``rmsnorm`` is the dispatch point for the fused kernels: with
``use_kernels`` it runs ``kernels.ops.fused_rmsnorm`` (K4 forward, K5
backward), otherwise the reference's plain form (``kernels/ref.py::
ref_rmsnorm``), differentiated by autograd.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ops import fused_rmsnorm
from repro_torch.kernels.ref import ref_rmsnorm


def rmsnorm(x, scale, eps, *, use_kernels=False):
    if use_kernels:
        # the kernels take an fp32 scale; a bf16 view (cast_params_bf16)
        # is upcast here and its gradient cast back by autograd
        return fused_rmsnorm(x, scale.to(torch.float32), eps=eps)
    return ref_rmsnorm(x, scale, eps)


def layernorm(x, scale, bias, eps):
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    out = (xf - mu) / torch.sqrt(var + eps)
    return (out * scale.to(torch.float32)
            + bias.to(torch.float32)).to(x.dtype)


def groupnorm_heads(x, scale, bias, eps):
    """Per-head group norm: x (B, S, H, P) normalised over P, then scaled
    and shifted by scale/bias (H*P,); fp32 math."""
    b, s, h, p = x.shape
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    out = ((xf - mu) / torch.sqrt(var + eps)).reshape(b, s, h * p)
    out = out * scale.to(torch.float32) + bias.to(torch.float32)
    return out.reshape(b, s, h, p).to(x.dtype)
