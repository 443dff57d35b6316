"""Feed-forward blocks (``repro.models.mlp``): the gated SwiGLU
``silu(x@w_gate)·(x@w_up)@w_out`` of the decoders, and the ViT's
``gelu(x@w_up+b_up)@w_out+b_out``.

``jax.nn.gelu`` defaults to the tanh approximation, so the port uses
``approximate="tanh"`` (``repro/models/mlp.py:31``).
"""
from __future__ import annotations

import torch.nn.functional as F


def is_gated(act: str) -> bool:
    return act in ("swiglu", "geglu")


def mlp(p, x, act):
    dt = x.dtype
    if act == "swiglu":
        h = F.silu(x @ p["w_gate"].to(dt)) * (x @ p["w_up"].to(dt))
        return h @ p["w_out"].to(dt)
    if act != "gelu":
        raise NotImplementedError(f"act {act!r} is not yet ported")
    h = F.gelu(x @ p["w_up"].to(dt) + p["b_up"].to(dt), approximate="tanh")
    return h @ p["w_out"].to(dt) + p["b_out"].to(dt)
