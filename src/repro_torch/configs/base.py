"""Model and engine configuration (the ViT subset of ``repro.configs.base``).

Field names and defaults follow the JAX package, so a config can be
compared field by field with its reference. Fields the ported path does
not read (rope, MoE, SSM, serving knobs) are left out until a slice needs
them; ``use_kernels`` stands in for the reference's ``use_pallas``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                  # only "vit" is ported
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    head_dim: int = 0               # 0 -> d_model // num_heads
    causal: bool = True
    sliding_window: int = 0         # 0 = full attention
    global_every: int = 0           # every Nth layer full, the rest local
    norm_eps: float = 1e-5

    # --- ViT ------------------------------------------------------------
    image_size: int = 0
    patch_size: int = 0
    num_classes: int = 0

    # --- numerics -------------------------------------------------------
    dtype: str = "bfloat16"         # compute dtype; params stay fp32
    use_kernels: bool = True        # hand-written CUDA kernels on the card

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_heads % self.num_kv_heads:
            raise ValueError(
                f"{self.name}: num_heads {self.num_heads} not divisible by "
                f"kv heads {self.num_kv_heads}")

    def layer_windows(self):
        """Per-layer sliding window (0 = full), gemma3-style local:global."""
        if self.sliding_window == 0:
            return [0] * self.num_layers
        if self.global_every <= 0:
            return [self.sliding_window] * self.num_layers
        return [0 if (i + 1) % self.global_every == 0 else self.sliding_window
                for i in range(self.num_layers)]

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class EngineConfig:
    """The engine knobs the eval path reads. ``cast_params_bf16`` casts
    the fp32 matrices (ndim >= 2) to bf16 before compute, as the
    reference's ZeRO-3 gather optimisation does."""
    cast_params_bf16: bool = False
