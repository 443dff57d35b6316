"""Gemma3-12B: a dense decoder whose layers attend 5:1 local:global, with
a tied embedding scaled by sqrt(d) and a GeGLU MLP [hf:google/gemma-3-12b-pt].

The same widths as ``repro.configs.gemma3_12b``: 48 layers, d 3840, 16
query heads and 8 KV heads of 256 (the head dim is not d / H), GeGLU MLP
15360, vocabulary 262144, full RoPE (theta 1e6), RMSNorm with eps 1e-6.
Every 6th layer attends globally; the other five see a sliding window of
1024 keys (``layer_windows``). The training CLI's ``--layers`` cuts the
depth: six layers are five local and one global.
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "gemma3-12b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="dense",
        num_layers=48,
        d_model=3840,
        num_heads=16,
        num_kv_heads=8,
        head_dim=256,
        d_ff=15360,
        vocab_size=262144,
        rope_style="full",
        rope_theta=1000000.0,
        sliding_window=1024,
        global_every=6,
        attn_logit_softcap=0.0,
        tie_embeddings=True,
        embed_scale=True,
        norm_eps=1e-6,
        act="geglu",
    )


def smoke() -> ModelConfig:
    return config().replace(
        name=ARCH_ID + "-smoke", num_layers=2, d_model=256, num_heads=4,
        num_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512,
        sliding_window=64, global_every=2)
