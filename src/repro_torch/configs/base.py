"""Model and engine configuration (the ViT subset of ``repro.configs.base``).

Field names and defaults follow the JAX package, so a config can be
compared field by field with its reference. Fields the ported path does
not read (rope, MoE, SSM, serving knobs; ZeRO, pipeline and checkpoint
settings) are left out until a slice needs them; ``use_kernels`` stands in
for the reference's ``use_pallas``.
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
    label_smoothing: float = 0.0

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
    """The single-card engine knobs (``repro/configs/base.py:167-229``,
    same names and defaults). Invariant, as DeepSpeed's:
    ``train_batch_size == micro_batch_per_gpu * gradient_accumulation_steps
    * dp_world``. ``cast_params_bf16`` casts the fp32 matrices (ndim >= 2)
    to bf16 before compute, as the reference's ZeRO-3 gather optimisation
    does; the master params and the optimizer stay fp32."""
    train_batch_size: int = 32
    micro_batch_per_gpu: int = 0        # 0 -> derived
    gradient_accumulation_steps: int = 1
    optimizer: str = "adamw"            # adamw | sgd | lamb
    lr: float = 3e-4
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    warmup_steps: int = 100
    lr_schedule: str = "cosine"
    total_steps: int = 1000
    seed: int = 0
    cast_params_bf16: bool = False
    # anomaly guard: a non-finite loss or global grad-norm skips the update
    # (params, optimizer state and step unchanged, step_ok 0); the host
    # loop retries the same batch and aborts after guard_max_skips
    guard_anomalies: bool = True
    guard_max_skips: int = 3

    def derived_micro_batch(self, dp_world: int) -> int:
        if self.micro_batch_per_gpu:
            return self.micro_batch_per_gpu
        mb, rem = divmod(self.train_batch_size,
                         self.gradient_accumulation_steps * dp_world)
        if rem:
            raise ValueError(
                f"train_batch_size={self.train_batch_size} not divisible by "
                f"accum={self.gradient_accumulation_steps} * dp={dp_world}")
        return mb

    def validate(self, dp_world: int) -> None:
        mb = self.derived_micro_batch(dp_world)
        got = mb * self.gradient_accumulation_steps * dp_world
        if got != self.train_batch_size:
            raise ValueError(
                "DeepSpeed batch invariant violated: "
                f"{mb} * {self.gradient_accumulation_steps} * {dp_world} "
                f"= {got} != train_batch_size={self.train_batch_size}")
