"""The ViT feed-forward block: ``gelu(x@w_up+b_up)@w_out+b_out``.

``jax.nn.gelu`` defaults to the tanh approximation, so the port uses
``approximate="tanh"`` (``repro/models/mlp.py:31``).
"""
from __future__ import annotations

import torch.nn.functional as F


def mlp(p, x):
    dt = x.dtype
    h = F.gelu(x @ p["w_up"].to(dt) + p["b_up"].to(dt), approximate="tanh")
    return h @ p["w_out"].to(dt) + p["b_out"].to(dt)
