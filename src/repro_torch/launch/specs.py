"""Concrete model inputs drawn on the host (``repro/launch/specs.py``).

``concrete_batch`` gives a small batch with the structure of the
reference's (``specs.py:46-74``): token ids for a decoder, and for a
vision-language decoder also the stubbed vision tower's patch embeddings
(B, n_img, d_model), n_img = min(vision_tokens, seq // 2). The reference
draws with threefry; here numpy's generator, seeded with ``seed``, draws
the same shapes and dtypes, other values (ROADMAP deviation D5). The
dry-run's ``input_specs`` is not ported.
"""
from __future__ import annotations

import numpy as np


def concrete_batch(cfg, batch: int, seq: int, *, seed: int = 0) -> dict:
    """{name: numpy array} for a token or vlm decoder: ``tokens`` int32
    (batch, seq) uniform over the vocabulary, and for a vlm
    ``image_embeds`` fp32 (batch, n_img, d_model) standard normal."""
    rng = np.random.default_rng(seed)
    if cfg.arch_type in ("vit", "audio"):
        raise ValueError(f"{cfg.name}: concrete_batch is for token and vlm "
                         f"decoders; a {cfg.arch_type} batch comes from "
                         f"its data pipeline")
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, seq),
                                  dtype=np.int32)}
    if cfg.arch_type == "vlm":
        n_img = min(cfg.vision_tokens, seq // 2)
        out["image_embeds"] = rng.standard_normal(
            (batch, n_img, cfg.d_model), dtype=np.float32)
    return out
