"""Qwen2-VL-72B's language backbone: a dense decoder with M-RoPE, qkv bias
and GQA with 8 KV heads [arXiv:2409.12191].

The same fields as ``repro.configs.qwen2_vl_72b``: 80 layers, d 8192, 64
query heads and 8 KV heads of 128, SwiGLU MLP 29568, an untied vocabulary
of 152064, RMSNorm with eps 1e-6, and M-RoPE with theta 1e6 whose 64
rotary pairs split (16, 24, 24) over the (temporal, height, width) grid.
The vision tower and projector are stubbed as in the reference: a batch
brings ``vision_tokens`` patch embeddings (B, n_img, d_model), which
replace the first n_img token embeddings, and optionally the (B, S, 3)
position grid. The training CLI's ``--layers`` cuts the depth.
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "qwen2-vl-72b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="vlm",
        num_layers=80,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=29568,
        vocab_size=152064,
        qkv_bias=True,
        rope_style="mrope",
        mrope_sections=(16, 24, 24),
        rope_theta=1000000.0,
        vision_tokens=1024,
        norm_eps=1e-6,
        act="swiglu",
    )


def smoke() -> ModelConfig:
    return config().replace(
        name=ARCH_ID + "-smoke", num_layers=2, d_model=256, num_heads=8,
        num_kv_heads=2, head_dim=32, d_ff=512, vocab_size=512,
        mrope_sections=(4, 6, 6), vision_tokens=16)
