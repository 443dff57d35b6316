"""Model and engine configuration (the ViT, dense-decoder and RWKV6 subset
of ``repro.configs.base``).

Field names and defaults follow the JAX package, so a config can be
compared field by field with its reference. Fields the ported paths do
not read (MoE, MLA, softcap, M-RoPE, serving knobs; tensor, sequence and
pipeline parallelism, checkpoint settings) are left out until a slice
needs them; ``use_kernels``
stands in for the reference's ``use_pallas``. A config that asks for a
branch no slice has ported (tied embeddings, the embedding scale, M-RoPE,
the mamba2, hybrid or MLA blocks, another family or activation) raises
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


_ARCH_TYPES = ("vit", "dense", "ssm")
_BLOCK_KINDS = ("attn", "rwkv6")
_ROPE_STYLES = ("full", "half", "none")
_ACTS = ("swiglu", "gelu", "sqrelu")


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) / RWKV6 recurrent-block dimensions
    (``repro/configs/base.py:41-49``, same fields and defaults; only the
    RWKV6 block is ported)."""
    state_dim: int = 64             # N (mamba2) / head_size (rwkv6)
    head_dim: int = 64              # P per-head channel dim (mamba2)
    expand: int = 2                 # d_inner = expand * d_model (mamba2)
    conv_kernel: int = 4            # mamba2 short conv
    chunk_size: int = 128           # chunked-scan block length
    decay_lora: int = 64            # rwkv6 data-dependent decay bottleneck


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                  # vit | dense | ssm are ported
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads

    # --- block structure -------------------------------------------------
    block_kind: str = "attn"        # attn | rwkv6 (mla, mamba2 not ported)
    causal: bool = True

    # --- attention flavour ------------------------------------------------
    qkv_bias: bool = False
    rope_style: str = "full"        # full | half | none (mrope not ported)
    rope_theta: float = 10000.0
    sliding_window: int = 0         # 0 = full attention
    global_every: int = 0           # every Nth layer full, the rest local

    # --- sub-configs -------------------------------------------------------
    ssm: Optional[SSMConfig] = None

    # --- embeddings / head --------------------------------------------
    tie_embeddings: bool = False    # not ported
    norm_eps: float = 1e-5
    act: str = "swiglu"             # swiglu | gelu | sqrelu
    embed_scale: bool = False       # not ported

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
        unported = [
            (self.arch_type not in _ARCH_TYPES,
             f"arch_type {self.arch_type!r}"),
            (self.block_kind not in _BLOCK_KINDS,
             f"block_kind {self.block_kind!r}"),
            ((self.arch_type == "ssm") != (self.block_kind == "rwkv6"),
             f"arch_type {self.arch_type!r} with block_kind "
             f"{self.block_kind!r}"),
            (self.tie_embeddings, "tied embeddings"),
            (self.embed_scale, "the embedding scale"),
            (self.rope_style not in _ROPE_STYLES,
             f"rope_style {self.rope_style!r}"),
            (self.act not in _ACTS, f"act {self.act!r}"),
        ]
        for needed, what in unported:
            if needed:
                raise NotImplementedError(
                    f"{self.name}: {what} is not yet ported to repro_torch")
        if self.block_kind == "rwkv6" and self.ssm is None:
            raise ValueError(f"{self.name}: an rwkv6 block needs ssm")

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
    """The engine knobs (``repro/configs/base.py:167-229``, same names and
    defaults). Invariant, as DeepSpeed's:
    ``train_batch_size == micro_batch_per_gpu * gradient_accumulation_steps
    * dp_world``. ``zero_stage`` 0-3 picks what the data-parallel engine
    shards (``core/sharding.py``). ``cast_params_bf16`` casts the fp32 matrices (ndim >= 2)
    to bf16 before compute, as the reference's ZeRO-3 gather optimisation
    does; the master params and the optimizer stay fp32."""
    train_batch_size: int = 32
    micro_batch_per_gpu: int = 0        # 0 -> derived
    gradient_accumulation_steps: int = 1
    zero_stage: int = 0                 # 0=DDP (paper), 1, 2, 3(FSDP)
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

    def __post_init__(self):
        if self.zero_stage not in (0, 1, 2, 3):
            raise ValueError(f"zero_stage must be 0, 1, 2 or 3: "
                             f"{self.zero_stage}")

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
