"""Zamba2-2.7B: a hybrid of Mamba2 layers and one weight-shared attention
block [arXiv:2411.15242].

The same widths as ``repro.configs.zamba2_2_7b``: 54 Mamba2 layers at d
2560 (inner width 5120 in 80 heads of 64, state 64, a depthwise conv of
4, SSD chunks of 128), and after every ``hybrid_group`` = 6 of them the
same attention + SwiGLU block (32 heads of 80, MLP 10240, full RoPE) is
applied again; vocabulary 32000, RMSNorm with eps 1e-5. The SSM state
makes decode O(1) per token in the Mamba2 layers; the shared block keeps
one KV cache per group. The training CLI's ``--layers`` cuts the depth to
whole groups.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

ARCH_ID = "zamba2-2.7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="hybrid",
        num_layers=54,
        d_model=2560,
        num_heads=32,
        num_kv_heads=32,
        head_dim=80,
        d_ff=10240,
        vocab_size=32000,
        block_kind="mamba2",
        hybrid_group=6,
        ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_kernel=4,
                      chunk_size=128),
        rope_style="full",
        norm_eps=1e-5,
        act="swiglu",
    )


def smoke() -> ModelConfig:
    return config().replace(
        name=ARCH_ID + "-smoke", num_layers=4, d_model=128, num_heads=4,
        num_kv_heads=4, head_dim=32, d_ff=256, vocab_size=512,
        hybrid_group=2,
        ssm=SSMConfig(state_dim=16, head_dim=32, expand=2, conv_kernel=4,
                      chunk_size=32))
