"""ChatGLM3-6B: a dense decoder with 2d (half) RoPE, qkv bias and GQA with
2 KV heads [arXiv:2406.12793].

The same widths as ``repro.configs.chatglm3_6b``: 28 layers, d 4096, 32
query heads and 2 KV heads of 128, SwiGLU MLP 13696, vocabulary 65024,
RMSNorm with eps 1e-5. The training CLI's ``--layers`` cuts the depth.
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "chatglm3-6b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="dense",
        num_layers=28,
        d_model=4096,
        num_heads=32,
        num_kv_heads=2,
        head_dim=128,
        d_ff=13696,
        vocab_size=65024,
        qkv_bias=True,
        rope_style="half",
        rope_theta=10000.0,
        norm_eps=1e-5,
        act="swiglu",
    )


def smoke() -> ModelConfig:
    return config().replace(
        name=ARCH_ID + "-smoke", num_layers=2, d_model=256, num_heads=8,
        num_kv_heads=2, head_dim=32, d_ff=512, vocab_size=512)
