"""The assigned input shapes (the counterpart of
``repro/configs/shapes.py``): one training, one prefill and two decode
shapes, each a sequence length, a global batch and a kind; and which
(config, shape) pairs run."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str           # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


TRAIN_4K = InputShape("train_4k", 4_096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32_768, 128, "decode")
LONG_500K = InputShape("long_500k", 524_288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def get_shape(name: str) -> InputShape:
    return SHAPES[name]


def applicable(cfg, shape: InputShape) -> tuple[bool, str]:
    """(runs?, reason): no decode shape for an encoder or a classifier,
    and the 524k decode only where the decode state is sub-linear in the
    context (``ModelConfig.supports_long_decode``)."""
    if shape.is_decode and not cfg.supports_decode():
        return False, f"{cfg.name} is encoder-only: no autoregressive decode"
    if shape.name == "long_500k" and not cfg.supports_long_decode():
        return False, (f"{cfg.name} is pure full-attention: 524k decode KV "
                       "cache is super-HBM and attention is not sub-quadratic")
    return True, ""
