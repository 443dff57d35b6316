"""Parameter initialisation: truncated normal (±2σ) with σ = 1/√fan_in,
and σ = 0.02 for embeddings, as ``repro.models.params``.

Draws come from an explicit CPU ``torch.Generator`` and are then moved to
the target device, so one seed gives the same weights on every device.
Torch's generator is not JAX's threefry: the same seed gives other values
than the reference, which is why parity tests carry the reference's own
weights across (``models/convert.py``). On the ``meta`` device only the
shapes are made.
"""
from __future__ import annotations

import math

import torch


def _trunc_normal(shape, std, generator, device):
    device = torch.device(device)
    if device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device=device)
    t = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (t * std).to(device)


def dense_init(shape, *, generator, device, scale=None):
    """Fan-in truncated normal; fan_in is ``shape[-2]``, so a stacked
    (L, in, out) weight gets the per-layer fan-in."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return _trunc_normal(shape, std, generator, device)


def embed_init(shape, *, generator, device):
    return _trunc_normal(shape, 0.02, generator, device)


def zeros(shape, *, device):
    return torch.zeros(shape, dtype=torch.float32, device=device)


def ones(shape, *, device):
    return torch.ones(shape, dtype=torch.float32, device=device)
