"""Granite-MoE 3B-A800M: a decoder whose every layer routes each token to
8 of 40 experts [hf:ibm-granite/granite-3.0-1b-a400m-base family].

The same widths as ``repro.configs.granite_moe_3b``: 32 layers, d 1536, 24
query heads and 8 KV heads of 64, 40 SwiGLU experts of width 512 with top-8
routing and no shared expert, vocabulary 49155 with a tied embedding,
RMSNorm with eps 1e-6, load-balance coefficient 0.01. As in the reference,
IBM's embedding, residual, attention and logit multipliers are left out.
The training CLI's ``--layers`` cuts the depth.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

ARCH_ID = "granite-moe-3b-a800m"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="moe",
        num_layers=32,
        d_model=1536,
        num_heads=24,
        num_kv_heads=8,
        head_dim=64,
        d_ff=512,                    # per-expert FFN width (assigned)
        vocab_size=49155,
        rope_style="full",
        rope_theta=10000.0,
        moe=MoEConfig(num_experts=40, num_shared_experts=0, top_k=8,
                      d_ff_expert=512, first_dense_layers=0,
                      router_aux_coef=0.01),
        tie_embeddings=True,
        norm_eps=1e-6,
        act="swiglu",
    )


def smoke() -> ModelConfig:
    return config().replace(
        name=ARCH_ID + "-smoke", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=2, head_dim=32, d_ff=64, vocab_size=512,
        moe=MoEConfig(num_experts=4, num_shared_experts=0, top_k=2,
                      d_ff_expert=64, first_dense_layers=0))
