"""Architecture registry for the port: ``--arch <id>`` resolution.

Every architecture of ``repro.configs`` is ported: the paper's ViT-B/16,
the dense decoders ChatGLM3-6B, Qwen2.5-14B, GLM-4-9B and Gemma3-12B, the
MoE decoders Granite-MoE 3B-A800M and DeepSeek-V3 671B (multi-head latent
attention and the multi-token prediction head), the vision-language
Qwen2-VL-72B (M-RoPE, stubbed vision tower), the recurrent RWKV6-7B, the
audio encoder HuBERT-XLarge (stubbed conv frontend) and the Mamba2 hybrid
Zamba2-2.7B, each for training and, but for the two encoders (ViT,
HuBERT), for serving. ``NOT_YET_PORTED`` is empty; it stays, so a later
registry entry can be named there before its slice lands.
"""
from __future__ import annotations

from repro_torch.configs import chatglm3_6b, deepseek_v3_671b, gemma3_12b, \
    glm4_9b, granite_moe_3b, hubert_xlarge, qwen2_5_14b, qwen2_vl_72b, \
    rwkv6_7b, vit_b16, zamba2_2_7b
from repro_torch.configs.base import EngineConfig, MLAConfig, ModelConfig, \
    MoEConfig, SSMConfig
from repro_torch.configs.shapes import SHAPES, InputShape, applicable, \
    get_shape

REGISTRY = {m.ARCH_ID: m for m in (vit_b16, chatglm3_6b, rwkv6_7b,
                                   qwen2_5_14b, glm4_9b, gemma3_12b,
                                   granite_moe_3b, deepseek_v3_671b,
                                   qwen2_vl_72b, hubert_xlarge,
                                   zamba2_2_7b)}
# the ten assigned architectures in the reference's order (its
# ``ASSIGNED_ARCHS``: every one but the paper's ViT-B/16), then all eleven
ASSIGNED_ARCHS = ("deepseek-v3-671b", "qwen2.5-14b", "qwen2-vl-72b",
                  "hubert-xlarge", "glm4-9b", "zamba2-2.7b", "chatglm3-6b",
                  "gemma3-12b", "rwkv6-7b", "granite-moe-3b-a800m")
ALL_ARCHS = ASSIGNED_ARCHS + ("vit-b16",)

# the reference registry's archs that have no port yet
# (repro/configs/__init__.py): none
NOT_YET_PORTED = ()


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


__all__ = ["ALL_ARCHS", "ASSIGNED_ARCHS", "EngineConfig", "InputShape",
           "MLAConfig", "ModelConfig", "MoEConfig", "NOT_YET_PORTED",
           "REGISTRY", "SHAPES", "SSMConfig", "applicable", "get_config",
           "get_shape", "get_smoke_config"]
