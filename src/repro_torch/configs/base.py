"""Model and engine configuration (``repro.configs.base``): every model
family of the JAX package.

Field names and defaults follow the JAX package, so a config can be
compared field by field with its reference. Fields the ported paths do
not read (sequence parallelism; ``tensor_parallel``: the port splits the
layers whenever the ``Trainer``'s model axis is above 1, the extent the
reference reads off its mesh) are left out until a slice needs them; ``use_kernels`` stands in for the reference's
``use_pallas``. A config that asks for a branch the port does not have
(another activation, a multi-token prediction head on a recurrent or an
encoder model) raises ``NotImplementedError``; an arch type and block
kind that do not go together raise ``ValueError``: RWKV6 blocks make an
``ssm`` model, Mamba2 blocks an ``ssm`` model or, with ``hybrid_group``
> 0, a ``hybrid`` one (Zamba2: one weight-shared attention block after
every ``hybrid_group`` Mamba2 layers), attention blocks the rest. The
audio family (``arch_type="audio"``, HuBERT: an encoder fed
``audio_feat_dim``-wide precomputed frame features, masked prediction
over its codebook) is ported for training; it has no decode step. The
vision-language family (``arch_type="vlm"``:
Qwen2-VL's decoder with M-RoPE, ``rope_style="mrope"`` split by
``mrope_sections``, fed ``vision_tokens`` precomputed image embeddings)
is ported, and so is serving: ``supports_decode`` says which configs have
a decode step. The MoE family (``arch_type="moe"`` with a
``MoEConfig``) is ported: GShard or gather dispatch (``moe_impl``), shared
experts and leading dense layers. So are DeepSeek's multi-head latent
attention (``block_kind="mla"`` with an ``MLAConfig``) and its
multi-token prediction head: as in the reference
(``repro/models/transformer.py:161,511``), any ``mtp_depth > 0`` builds
one MTP module, which predicts the token two ahead.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


_ARCH_TYPES = ("vit", "dense", "moe", "ssm", "vlm", "audio", "hybrid")
_BLOCK_KINDS = ("attn", "mla", "rwkv6", "mamba2")
_ROPE_STYLES = ("full", "half", "mrope", "none")
_ACTS = ("swiglu", "geglu", "gelu", "sqrelu")
_ATTN_IMPLS = ("naive", "blockwise")
_REMATS = ("none", "block", "dots")
_MOE_IMPLS = ("gshard", "gather")


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-style multi-head latent attention dimensions
    (``repro/configs/base.py:20-27``, same fields and defaults)."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) / RWKV6 recurrent-block dimensions
    (``repro/configs/base.py:41-49``, same fields and defaults)."""
    state_dim: int = 64             # N (mamba2) / head_size (rwkv6)
    head_dim: int = 64              # P per-head channel dim (mamba2)
    expand: int = 2                 # d_inner = expand * d_model (mamba2)
    conv_kernel: int = 4            # mamba2 short conv
    chunk_size: int = 128           # chunked-scan block length
    decay_lora: int = 64            # rwkv6 data-dependent decay bottleneck


@dataclass(frozen=True)
class MoEConfig:
    """Routed and shared experts (``repro/configs/base.py:30-38``, same
    fields and defaults)."""
    num_experts: int = 0            # routed experts
    num_shared_experts: int = 0     # always-on shared experts
    top_k: int = 0
    d_ff_expert: int = 0            # per-expert FFN width
    first_dense_layers: int = 0     # leading dense layers (DeepSeek-V3: 3)
    router_aux_coef: float = 0.001  # load-balance loss coefficient
    capacity_factor: float = 1.25   # dropless in math; capacity for dispatch


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                  # dense|moe|vlm|audio|hybrid|ssm|vit
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads

    # --- block structure -------------------------------------------------
    block_kind: str = "attn"        # attn | mla | mamba2 | rwkv6
    # hybrid (zamba2): `hybrid_group` mamba layers share one attention block
    hybrid_group: int = 0           # 0 = not hybrid
    causal: bool = True             # False for encoder-only (hubert)

    # --- attention flavour ------------------------------------------------
    qkv_bias: bool = False
    rope_style: str = "full"        # full | half | mrope | none
    rope_theta: float = 10000.0
    sliding_window: int = 0         # 0 = full attention
    global_every: int = 0           # every Nth layer full, the rest local
    attn_logit_softcap: float = 0.0  # > 0: softcap * tanh(scores / softcap)

    # --- sub-configs -------------------------------------------------------
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None

    # --- embeddings / head --------------------------------------------
    tie_embeddings: bool = False    # the LM head is embed.tok^T
    norm_eps: float = 1e-5
    act: str = "swiglu"             # swiglu | geglu | gelu | sqrelu
    mtp_depth: int = 0              # > 0: one multi-token prediction head
    embed_scale: bool = False       # gemma-style sqrt(d) embedding scale

    # --- audio: the conv frontend is stubbed; a batch brings (B, S,
    # audio_feat_dim) precomputed frame features -------------------------
    audio_feat_dim: int = 0
    # --- vlm: the vision tower is stubbed; a batch brings (B, n_img,
    # d_model) patch embeddings and a (B, S, 3) M-RoPE position grid --------
    vision_tokens: int = 0          # image tokens per sample
    mrope_sections: Tuple[int, int, int] = (0, 0, 0)   # t/h/w rope pairs

    # --- ViT ------------------------------------------------------------
    image_size: int = 0
    patch_size: int = 0
    num_classes: int = 0
    label_smoothing: float = 0.0

    # --- numerics -------------------------------------------------------
    dtype: str = "bfloat16"         # compute dtype; params stay fp32
    use_kernels: bool = True        # hand-written CUDA kernels on the card
    attn_impl: str = "naive"        # naive | blockwise (flash in PyTorch)
    moe_impl: str = "gshard"        # gshard (einsum) | gather (slot table)
    attn_block_k: int = 512
    attn_block_q: int = 512
    remat: str = "none"             # none | block | dots (activation
    #                                 checkpointing of each layer)

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
            (self.rope_style not in _ROPE_STYLES,
             f"rope_style {self.rope_style!r}"),
            (self.act not in _ACTS, f"act {self.act!r}"),
            (self.arch_type == "vit" and self.block_kind == "mla",
             "an mla block in a ViT"),
            (self.mtp_depth > 0 and (self.is_attention_free or
                                     self.arch_type in ("vit", "audio")),
             f"mtp_depth {self.mtp_depth} on a {self.block_kind} "
             f"{self.arch_type} model"),
        ]
        for needed, what in unported:
            if needed:
                raise NotImplementedError(
                    f"{self.name}: {what} is not yet ported to repro_torch")
        # the pairs the reference's forward dispatches (transformer.py:
        # 452-492): a recurrent block in an ssm model, or mamba2 grouped
        # around a shared attention block in a hybrid one
        recurrent = self.arch_type in ("ssm", "hybrid")
        if recurrent != self.is_attention_free or \
                (self.block_kind == "rwkv6" and self.arch_type != "ssm") or \
                (self.arch_type == "hybrid") != (self.hybrid_group > 0):
            raise ValueError(
                f"{self.name}: arch_type {self.arch_type!r} with block_kind "
                f"{self.block_kind!r} and hybrid_group {self.hybrid_group}: "
                f"rwkv6 blocks make an ssm model, mamba2 blocks an ssm one "
                f"or, with hybrid_group > 0, a hybrid one")
        if self.hybrid_group > 0 and self.num_layers % self.hybrid_group:
            raise ValueError(
                f"{self.name}: num_layers {self.num_layers} is not a whole "
                f"number of groups of {self.hybrid_group}")
        if self.attn_impl not in _ATTN_IMPLS:
            raise ValueError(f"{self.name}: attn_impl {self.attn_impl!r} "
                             f"not in {_ATTN_IMPLS}")
        if self.moe_impl not in _MOE_IMPLS:
            raise ValueError(f"{self.name}: moe_impl {self.moe_impl!r} not "
                             f"in {_MOE_IMPLS}")
        if self.remat not in _REMATS:
            raise ValueError(f"{self.name}: remat {self.remat!r} not in "
                             f"{_REMATS}")
        if self.rope_style == "mrope" and \
                sum(self.mrope_sections) != self.head_dim // 2:
            raise ValueError(
                f"{self.name}: mrope_sections {self.mrope_sections} must "
                f"split the {self.head_dim // 2} rope pairs of head_dim "
                f"{self.head_dim}")
        if self.is_attention_free and self.ssm is None:
            raise ValueError(f"{self.name}: an {self.block_kind} block needs "
                             f"ssm")
        if self.block_kind == "mla" and self.mla is None:
            raise ValueError(f"{self.name}: an mla block needs mla")
        if self.moe is not None and \
                self.num_layers < self.moe.first_dense_layers:
            # the reference fails inside jax.random.split on this input
            raise ValueError(
                f"{self.name}: num_layers {self.num_layers} < "
                f"moe.first_dense_layers {self.moe.first_dense_layers}")

    @property
    def is_encoder_only(self) -> bool:
        return not self.causal

    @property
    def is_attention_free(self) -> bool:
        return self.block_kind in ("mamba2", "rwkv6")

    def supports_long_decode(self) -> bool:
        """True if the decode state is sub-linear in the context (a
        recurrent block, or a hybrid whose shared attention is a few
        layers) or the attention is windowed (bounded local KV): the
        dry run's ``configs/shapes.py::applicable`` reads it to choose a
        config's long-context shapes."""
        return self.is_attention_free or self.hybrid_group > 0 or \
            self.sliding_window > 0

    def supports_decode(self) -> bool:
        return not self.is_encoder_only and self.arch_type != "vit"

    @property
    def has_moe(self) -> bool:
        """Routed experts in the layers after ``moe.first_dense_layers``
        (the reference's ``cfg.moe and cfg.moe.num_experts > 0``)."""
        return self.moe is not None and self.moe.num_experts > 0

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


SEQUENCE_PARALLEL = ("none", "ulysses")
EMBED_SHARDING = ("vocab", "dmodel")


def check_embed_sharding(value: str) -> None:
    """Refuse an embedding layout other than "vocab" or "dmodel" (the
    reference reads any value but "vocab" as "dmodel": ROADMAP caveat
    R7)."""
    if value not in EMBED_SHARDING:
        raise ValueError(f"embed_sharding must be one of {EMBED_SHARDING}: "
                         f"{value!r}")


@dataclass(frozen=True)
class EngineConfig:
    """The engine knobs (``repro/configs/base.py:167-229``, same names and
    defaults). Invariant, as DeepSpeed's:
    ``train_batch_size == micro_batch_per_gpu * gradient_accumulation_steps
    * dp_world``. ``zero_stage`` 0-3 picks what the data-parallel engine
    shards (``core/sharding.py``). ``cast_params_bf16`` casts the fp32 matrices (ndim >= 2)
    to bf16 before compute, as the reference's ZeRO-3 gather optimisation
    does; the master params and the optimizer stay fp32.
    ``pipeline_stages`` S > 1 trains through the 1F1B pipeline
    (``core/pipeline.py``) over the gradient-accumulation microbatches, so
    accum >= S; ``pipeline_interleave`` v > 1 gives each stage v chunks
    (Megatron's interleaved schedule) and needs accum % S == 0. The
    layer count must divide into S * v chunks (checked where the model is
    known, ``pipeline.stage_partition``). ``sequence_parallel`` "ulysses"
    runs DeepSpeed-Ulysses on the model axis where the model allows it
    (``core/ulysses.py::applies``); it does not compose with a pipeline,
    and a value other than "none" or "ulysses" is refused (the reference
    reads any other value as "none": ROADMAP caveat R6).
    ``embed_sharding`` lays out a decoder's token embedding over the model
    axis (``core/sharding.py``): "vocab" splits ``embed.tok``'s rows
    (Megatron's vocab-parallel), "dmodel" its feature columns, with no
    ZeRO split; any other value is refused (the reference reads any value
    other than "vocab" as "dmodel": ROADMAP caveat R7)."""
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
    sequence_parallel: str = "none"     # none | ulysses
    embed_sharding: str = "vocab"       # vocab | dmodel
    pipeline_stages: int = 1
    pipeline_interleave: int = 1
    # elastic checkpointing (repro_torch.checkpoint): cadence in optimizer
    # steps (0 = end-of-run only), async saves and their bounded in-flight
    # count, and retention (keep the newest K, 0 = all; the GC never
    # deletes the newest step that passes verification)
    ckpt_every: int = 0
    ckpt_async: bool = True
    ckpt_max_in_flight: int = 2
    ckpt_keep_last: int = 0
    # anomaly guard: a non-finite loss or global grad-norm skips the update
    # (params, optimizer state and step unchanged, step_ok 0); the host
    # loop retries the same batch and aborts after guard_max_skips
    guard_anomalies: bool = True
    guard_max_skips: int = 3

    def __post_init__(self):
        if self.zero_stage not in (0, 1, 2, 3):
            raise ValueError(f"zero_stage must be 0, 1, 2 or 3: "
                             f"{self.zero_stage}")
        check_embed_sharding(self.embed_sharding)

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

    def check_sequence_parallel(self) -> None:
        """Refuse an unknown ``sequence_parallel`` and Ulysses with a
        pipeline (``repro/configs/base.py:243-246``)."""
        if self.sequence_parallel not in SEQUENCE_PARALLEL:
            raise ValueError(f"sequence_parallel must be one of "
                             f"{SEQUENCE_PARALLEL}: "
                             f"{self.sequence_parallel!r}")
        if self.pipeline_stages > 1 and self.sequence_parallel != "none":
            raise ValueError("pipeline_stages > 1 does not compose with "
                             "Ulysses sequence parallelism yet")

    def validate(self, dp_world: int) -> None:
        mb = self.derived_micro_batch(dp_world)
        got = mb * self.gradient_accumulation_steps * dp_world
        if got != self.train_batch_size:
            raise ValueError(
                "DeepSpeed batch invariant violated: "
                f"{mb} * {self.gradient_accumulation_steps} * {dp_world} "
                f"= {got} != train_batch_size={self.train_batch_size}")
        if self.pipeline_stages < 1:
            raise ValueError(f"pipeline_stages must be >= 1: "
                             f"{self.pipeline_stages}")
        self.check_sequence_parallel()
        if self.pipeline_stages > 1 and \
                self.gradient_accumulation_steps < self.pipeline_stages:
            # 1F1B fill/drain needs at least one microbatch per stage
            raise ValueError(
                "1F1B needs microbatch count >= pipeline depth: "
                f"gradient_accumulation_steps="
                f"{self.gradient_accumulation_steps} < pipeline_stages="
                f"{self.pipeline_stages}")
        if self.pipeline_interleave < 1:
            raise ValueError(
                f"pipeline_interleave must be >= 1: "
                f"{self.pipeline_interleave}")
        if self.pipeline_interleave > 1:
            if self.pipeline_stages <= 1:
                raise ValueError(
                    "pipeline_interleave > 1 requires pipeline_stages > 1")
            if self.gradient_accumulation_steps % self.pipeline_stages:
                # Megatron's interleaved 1F1B groups microbatches in runs
                # of S per chunk round
                raise ValueError(
                    "interleaved 1F1B needs microbatch count divisible by "
                    "pipeline depth: gradient_accumulation_steps="
                    f"{self.gradient_accumulation_steps} % pipeline_stages="
                    f"{self.pipeline_stages} != 0")
        if self.ckpt_every < 0:
            raise ValueError(
                f"ckpt_every must be >= 0 (0 = end-of-run only): "
                f"{self.ckpt_every}")
        if self.ckpt_max_in_flight < 1:
            raise ValueError(
                f"ckpt_max_in_flight must be >= 1: "
                f"{self.ckpt_max_in_flight}")
        if self.ckpt_keep_last < 0:
            raise ValueError(
                f"ckpt_keep_last must be >= 0 (0 = keep all): "
                f"{self.ckpt_keep_last}")
        if self.guard_max_skips < 1:
            raise ValueError(
                f"guard_max_skips must be >= 1: {self.guard_max_skips}")
