"""Model inputs (``repro/launch/specs.py``).

``input_specs`` gives the dry run's inputs of an (arch, shape) pair as
``meta`` tensors, the counterpart of the reference's ``ShapeDtypeStruct``
stand-ins: shapes and dtypes, no storage. ``concrete_batch`` gives a small batch with the structure of the
reference's (``specs.py:46-74``): token ids for a decoder, and for a
vision-language decoder also the stubbed vision tower's patch embeddings
(B, n_img, d_model), n_img = min(vision_tokens, seq // 2); for the audio
encoder the stubbed frontend's frame features, the mask of the frames to
predict and their codebook labels. The reference
draws with threefry; here numpy's generator, seeded with ``seed``, draws
the same shapes and dtypes, other values (ROADMAP deviation D5).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.transformer import compute_dtype


def input_specs(cfg, shape, device="meta") -> dict:
    """The training or prefill batch of ``shape`` (a
    ``configs.shapes.InputShape``: global batch x sequence) as empty
    tensors on ``device``, with the reference's names, shapes and dtypes
    (``specs.py:21-43``): audio frame features in the compute dtype, the
    mask and the codebook labels; a vlm's tokens, patch embeddings
    (B, vision_tokens, d_model) and M-RoPE grid (B, S, 3); a ViT's fp32
    NHWC images and labels; else the tokens."""
    b, s = shape.global_batch, shape.seq_len
    act = compute_dtype(cfg)

    def empty(size, dtype):
        return torch.empty(size, dtype=dtype, device=device)
    if cfg.arch_type == "audio":
        return {"features": empty((b, s, cfg.audio_feat_dim), act),
                "mask": empty((b, s), torch.bool),
                "labels": empty((b, s), torch.int32)}
    if cfg.arch_type == "vlm":
        return {"tokens": empty((b, s), torch.int32),
                "image_embeds": empty((b, cfg.vision_tokens, cfg.d_model),
                                      act),
                "positions": empty((b, s, 3), torch.int32)}
    if cfg.arch_type == "vit":
        return {"images": empty((b, cfg.image_size, cfg.image_size, 3),
                                torch.float32),
                "labels": empty((b,), torch.int32)}
    return {"tokens": empty((b, s), torch.int32)}


def concrete_batch(cfg, batch: int, seq: int, *, seed: int = 0) -> dict:
    """{name: numpy array} for a token or vlm decoder: ``tokens`` int32
    (batch, seq) uniform over the vocabulary, and for a vlm
    ``image_embeds`` fp32 (batch, n_img, d_model) standard normal; for the
    audio encoder ``features`` fp32 (batch, seq, audio_feat_dim) standard
    normal, ``mask`` bool (batch, seq), each frame set with probability
    0.2, and ``labels`` int32 (batch, seq) uniform over the codebook."""
    rng = np.random.default_rng(seed)
    if cfg.arch_type == "vit":
        raise ValueError(f"{cfg.name}: concrete_batch is for the decoders "
                         f"and the audio encoder; a vit batch comes from "
                         f"its data pipeline")
    if cfg.arch_type == "audio":
        return {"features": rng.standard_normal(
                    (batch, seq, cfg.audio_feat_dim), dtype=np.float32),
                "mask": rng.random((batch, seq)) < 0.2,
                "labels": rng.integers(0, cfg.vocab_size, (batch, seq),
                                       dtype=np.int32)}
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, seq),
                                  dtype=np.int32)}
    if cfg.arch_type == "vlm":
        n_img = min(cfg.vision_tokens, seq // 2)
        out["image_embeds"] = rng.standard_normal(
            (batch, n_img, cfg.d_model), dtype=np.float32)
    return out
