"""Qwen2.5-14B: a dense decoder with full RoPE (theta 1e6), qkv bias and
GQA with 8 KV heads [hf:Qwen/Qwen2.5-14B].

The same widths as ``repro.configs.qwen2_5_14b``: 48 layers, d 5120, 40
query heads and 8 KV heads of 128, SwiGLU MLP 13824, vocabulary 152064,
RMSNorm with eps 1e-6. The training CLI's ``--layers`` cuts the depth.
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "qwen2.5-14b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="dense",
        num_layers=48,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        d_ff=13824,
        vocab_size=152064,
        qkv_bias=True,
        rope_style="full",
        rope_theta=1000000.0,
        norm_eps=1e-6,
        act="swiglu",
    )


def smoke() -> ModelConfig:
    return config().replace(
        name=ARCH_ID + "-smoke", num_layers=2, d_model=256, num_heads=8,
        num_kv_heads=2, head_dim=32, d_ff=512, vocab_size=512)
