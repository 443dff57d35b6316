"""Architecture registry for the port: ``--arch <id>`` resolution.

The paper's ViT-B/16, the dense decoder ChatGLM3-6B and the recurrent
RWKV6-7B are ported; the other architectures of ``repro.configs`` raise a clear error until their
slice lands.
"""
from __future__ import annotations

from repro_torch.configs import chatglm3_6b, rwkv6_7b, vit_b16
from repro_torch.configs.base import EngineConfig, ModelConfig, SSMConfig

REGISTRY = {m.ARCH_ID: m for m in (vit_b16, chatglm3_6b, rwkv6_7b)}

# the reference registry's other archs (repro/configs/__init__.py)
NOT_YET_PORTED = (
    "deepseek-v3-671b", "qwen2.5-14b", "qwen2-vl-72b", "hubert-xlarge",
    "glm4-9b", "zamba2-2.7b", "gemma3-12b", "granite-moe-3b-a800m",
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
           "SSMConfig", "get_config", "get_smoke_config"]
