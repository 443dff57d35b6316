"""Which dimension of each leaf ZeRO shards: the data-parallel half of
``repro/core/sharding.py``.

The reference maps DeepSpeed's stages to GSPMD PartitionSpecs over a
``data`` and a ``model`` mesh axis. The port has data parallelism only, so
its table is the reference's with the model axis left out (``tp=None``),
and a spec reduces to one number per leaf: the dimension split over the
ranks, or ``None`` (replicated). Rank r holds the r-th contiguous chunk of
that dimension, as ``NamedSharding`` lays it out, so a checkpoint can use
the reference's shard index maps.

  stage 0: params and optimizer state replicated (DDP, the paper's).
  stage 1: optimizer state sharded (``for_opt_state``), params replicated.
  stage 2: stage 1, and the gradients reduce-scattered into the shard.
  stage 3: the params sharded too, gathered a layer at a time on use.
"""
from __future__ import annotations

import re

_F = "data"         # the data-parallel axis in the table below


def _rules(fsdp):
    """``repro/core/sharding.py:32-76`` with ``tp=None``: (pattern on the
    slash-joined key, spec of the unstacked leaf), first match wins."""
    return [
        # --- MoE experts ---
        (r"experts/w_(gate|up)$", (None, fsdp, None)),
        (r"experts/w_out$", (None, None, fsdp)),
        (r"/router$", (fsdp, None)),
        # --- attention projections ---
        (r"attn/w?[qkvg]$|attn/w_(uq|uk|uv)$", (fsdp, None)),
        (r"attn/(wo|w_o)$", (None, fsdp)),
        (r"attn/w_(dq|dkv)$", (fsdp, None)),
        (r"attn/b[qkv]$", (None,)),
        # --- dense mlp ---
        (r"mlp/w_(gate|up)$|shared/w_(gate|up)$", (fsdp, None)),
        (r"mlp/w_out$|shared/w_out$", (None, fsdp)),
        (r"mlp/b_up$", (None,)),
        # --- mamba2 ---
        (r"mamba/w_in$", (fsdp, None)),
        (r"mamba/w_out$", (None, fsdp)),
        (r"mamba/conv_w$", (None, None)),
        (r"mamba/conv_b$", (None,)),
        # --- rwkv6 ---
        (r"time_mix/w_[rkvg]$", (fsdp, None)),
        (r"time_mix/w_o$", (None, fsdp)),
        (r"time_mix/decay_w1$", (fsdp, None)),
        (r"time_mix/decay_w2$", (None, None)),
        (r"time_mix/lora_w1$", (fsdp, None)),
        (r"time_mix/lora_w2$", (None, None, fsdp)),
        (r"time_mix/(ln_scale|ln_bias|decay_base)$", (None,)),
        (r"time_mix/bonus_u$", (None, None)),
        (r"channel_mix/w_[k]$", (fsdp, None)),
        (r"channel_mix/w_v$", (None, fsdp)),
        (r"channel_mix/w_r$", (fsdp, None)),
        # --- embeddings / head (the reference's default "vocab" layout) ---
        (r"embed/tok$", (None, fsdp)),
        (r"head/w$", (fsdp, None)),
        (r"embed/(patch_w|feat_proj)$", (None, fsdp)),
        (r"embed/pos$", (None, fsdp)),
        # --- mtp projection ---
        (r"mtp/proj$", (fsdp, None)),
    ]


_STACKED = re.compile(r"(^|/)(stack|dense_stack|moe_stack)(/|$)")


def _sanitize(spec, shape, world):
    """Replicate any dimension the world does not divide (the reference
    prefers that predictable layout to GSPMD's padding)."""
    return tuple(ax if ax is not None and shape[i] % world == 0 else None
                 for i, ax in enumerate(spec))


def _spec(key, shape, fsdp, world):
    """``param_specs``' ``spec_one`` for one leaf of ``shape``."""
    ks = key.replace(".", "/")
    stacked = bool(_STACKED.search(ks))
    base = next((spec for pat, spec in _rules(fsdp) if re.search(pat, ks)),
                None)
    if base is None:
        # norms, scalars, small vectors: sharded where the world divides
        if stacked:
            base = (None, fsdp) if len(shape) >= 2 else (None,)
        else:
            base = (fsdp,) if len(shape) >= 1 else ()
    elif stacked:
        base = (None,) + base
    base = base + (None,) * (len(shape) - len(base))
    return _sanitize(base, shape, world)


def shard_dims(shapes: dict, *, zero_stage: int, world: int,
               for_opt_state: bool = False) -> dict:
    """``{key: sharded dimension or None}`` for ``{key: shape}`` (flat
    dotted keys, e.g. ``stack.attn.wq``), as ``param_specs(...,
    tensor_parallel=False)`` gives on a ``data`` axis of ``world`` ranks.

    ``for_opt_state``: stages 1 and 2 shard the optimizer state while the
    params stay replicated; stage 3 shards both."""
    shard = zero_stage >= 3 or for_opt_state and zero_stage >= 1
    fsdp = _F if shard else None
    out = {}
    for key, shape in shapes.items():
        spec = _spec(key, tuple(shape), fsdp, world)
        out[key] = spec.index(_F) if _F in spec else None
    return out
