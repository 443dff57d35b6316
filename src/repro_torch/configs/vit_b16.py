"""ViT-B/16 — the paper's own model [Dosovitskiy et al., 2021].

The same widths as ``repro.configs.vit_b16``: 12 layers, d 768, 12 heads of
64, MLP 3072, 224 px images in 16 px patches (197 tokens with CLS).
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "vit-b16"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="vit",
        num_layers=12,
        d_model=768,
        num_heads=12,
        num_kv_heads=12,
        head_dim=64,
        d_ff=3072,
        vocab_size=0,
        causal=False,
        rope_style="none",
        image_size=224,
        patch_size=16,
        num_classes=10,              # CIFAR-10 default; overridden per dataset
        norm_eps=1e-6,
        act="gelu",
    )


def smoke() -> ModelConfig:
    return config().replace(
        name=ARCH_ID + "-smoke", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=4, head_dim=32, d_ff=256,
        image_size=32, patch_size=4, num_classes=10)
