"""RWKV6-7B "Finch": attention-free, with a data-dependent decay
[arXiv:2404.05892].

The same widths as ``repro.configs.rwkv6_7b``: 32 layers, d 4096, 64 heads
of 64, channel-mix width 14336 with squared ReLU, vocabulary 65536, RMSNorm
with eps 1e-5, no RoPE, and the WKV6 recurrence in chunks of 32 with a
decay LoRA of rank 64. The training CLI's ``--layers`` cuts the depth.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

ARCH_ID = "rwkv6-7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="ssm",
        num_layers=32,
        d_model=4096,
        num_heads=64,
        num_kv_heads=64,
        head_dim=64,
        d_ff=14336,
        vocab_size=65536,
        block_kind="rwkv6",
        ssm=SSMConfig(state_dim=64, head_dim=64, chunk_size=32,
                      decay_lora=64),
        rope_style="none",
        norm_eps=1e-5,
        act="sqrelu",
    )


def smoke() -> ModelConfig:
    return config().replace(
        name=ARCH_ID + "-smoke", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=4, head_dim=32, d_ff=256, vocab_size=512,
        ssm=SSMConfig(state_dim=32, head_dim=32, chunk_size=32,
                      decay_lora=16))
