"""DeepSeek-V3 671B: multi-head latent attention, one shared and 256
routed experts with top-8 routing, and a multi-token prediction head
[arXiv:2412.19437].

The same widths as ``repro.configs.deepseek_v3_671b``: 61 layers, d 7168,
128 heads whose queries and keys are 128 wide without rope plus 64 with
it (192) and whose values are 128 wide, query and key-value latents of
1536 and 512, the three leading dense layers with a SwiGLU of 18,432 and
256 routed experts of 2048 after them, an untied vocabulary of 129,280,
RMSNorm with eps 1e-6 and one MTP module. As in the reference, parts of
DeepSeek's published config are left out: the sigmoid, group-limited
router with its bias, ``routed_scaling_factor`` and the YaRN rope scaling;
the router is the softmax top-k of the other MoE configs. The training
CLI's ``--layers`` cuts the depth.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

ARCH_ID = "deepseek-v3-671b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="moe",
        num_layers=61,
        d_model=7168,
        num_heads=128,
        num_kv_heads=128,          # MLA: all heads read the shared latent
        head_dim=128,              # v head dim; qk = nope128 + rope64
        d_ff=18432,                # dense-layer FFN (first 3 layers)
        vocab_size=129280,
        block_kind="mla",
        rope_style="full",
        rope_theta=10000.0,
        mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                      qk_nope_head_dim=128, qk_rope_head_dim=64,
                      v_head_dim=128),
        moe=MoEConfig(num_experts=256, num_shared_experts=1, top_k=8,
                      d_ff_expert=2048, first_dense_layers=3,
                      router_aux_coef=0.001),
        mtp_depth=1,
        norm_eps=1e-6,
        act="swiglu",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        arch_type="moe",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        block_kind="mla",
        mla=MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                      qk_nope_head_dim=32, qk_rope_head_dim=16,
                      v_head_dim=32),
        moe=MoEConfig(num_experts=4, num_shared_experts=1, top_k=2,
                      d_ff_expert=64, first_dense_layers=1),
        mtp_depth=1,
        norm_eps=1e-6,
        act="swiglu",
    )
