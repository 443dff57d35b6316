"""GLM-4-9B: a dense decoder with RoPE on half of each head, qkv bias and
GQA with 2 KV heads [hf:THUDM/glm-4-9b].

The same widths as ``repro.configs.glm4_9b``: 40 layers, d 4096, 32 query
heads and 2 KV heads of 128, SwiGLU MLP 13696, vocabulary 151552, RMSNorm
with eps 1.5625e-7 (1e-6 in the smoke config). The training CLI's
``--layers`` cuts the depth.
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "glm4-9b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="dense",
        num_layers=40,
        d_model=4096,
        num_heads=32,
        num_kv_heads=2,
        head_dim=128,
        d_ff=13696,
        vocab_size=151552,
        qkv_bias=True,
        rope_style="half",
        rope_theta=10000.0,
        norm_eps=1.5625e-7,
        act="swiglu",
    )


def smoke() -> ModelConfig:
    return config().replace(
        name=ARCH_ID + "-smoke", num_layers=2, d_model=256, num_heads=8,
        num_kv_heads=2, head_dim=32, d_ff=512, vocab_size=512,
        norm_eps=1e-6)
