"""Architecture registry for the port: ``--arch <id>`` resolution.

Only the paper's ViT-B/16 is ported so far; the other architectures of
``repro.configs`` raise a clear error until their slice lands.
"""
from __future__ import annotations

from repro_torch.configs import vit_b16
from repro_torch.configs.base import EngineConfig, ModelConfig

REGISTRY = {vit_b16.ARCH_ID: vit_b16}

# the reference registry's other archs (repro/configs/__init__.py)
NOT_YET_PORTED = (
    "deepseek-v3-671b", "qwen2.5-14b", "qwen2-vl-72b", "hubert-xlarge",
    "glm4-9b", "zamba2-2.7b", "chatglm3-6b", "gemma3-12b", "rwkv6-7b",
    "granite-moe-3b-a800m",
)


def _module(arch: str):
    if arch in REGISTRY:
        return REGISTRY[arch]
    if arch in NOT_YET_PORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not yet ported to repro_torch; ported: "
            f"{tuple(REGISTRY)}")
    raise KeyError(f"unknown arch {arch!r}; choose from {tuple(REGISTRY)}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).config()


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke()


__all__ = ["EngineConfig", "ModelConfig", "NOT_YET_PORTED", "REGISTRY",
           "get_config", "get_smoke_config"]
