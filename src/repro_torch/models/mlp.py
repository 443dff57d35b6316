"""Feed-forward blocks (``repro.models.mlp``): the gated SwiGLU
``silu(x@w_gate)·(x@w_up)@w_out`` and GeGLU ``gelu(x@w_gate)·(x@w_up)@w_out``
of the decoders, and the ViT's ``gelu(x@w_up+b_up)@w_out+b_out``.

``jax.nn.gelu`` defaults to the tanh approximation, so the port uses
``approximate="tanh"`` in both GELU forms (``repro/models/mlp.py:31``).

With a model group installed (``models/shardctx.py``) ``p`` holds this
rank's chunks: ``w_gate``/``w_up`` (and ``b_up``) column-parallel,
``w_out`` row-parallel, its partial output summed over the group before
the replicated ``b_out`` is added once.
"""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.models import shardctx


def is_gated(act: str) -> bool:
    return act in ("swiglu", "geglu")


def mlp(p, x, act):
    dt = x.dtype
    x = shardctx.copy_to_model(x)
    if is_gated(act):
        gate = x @ p["w_gate"].to(dt)
        gate = F.silu(gate) if act == "swiglu" else \
            F.gelu(gate, approximate="tanh")
        return shardctx.reduce_from_model(
            (gate * (x @ p["w_up"].to(dt))) @ p["w_out"].to(dt))
    if act != "gelu":
        raise NotImplementedError(f"act {act!r} is not yet ported")
    h = F.gelu(x @ p["w_up"].to(dt) + p["b_up"].to(dt), approximate="tanh")
    return shardctx.reduce_from_model(h @ p["w_out"].to(dt)) + \
        p["b_out"].to(dt)
