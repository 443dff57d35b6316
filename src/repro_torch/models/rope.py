"""Rotary position embeddings, the ``full`` and ``half`` (GLM 2d) styles of
``repro.models.rope``. M-RoPE and the single-stream ``apply_rope_1d`` wait
for the models that use them (Qwen2-VL, DeepSeek's MLA)."""
from __future__ import annotations

import torch


def _rope_angles(positions, dim, theta):
    """positions (...) -> angles (..., dim//2) in fp32."""
    inv_freq = 1.0 / (theta ** (torch.arange(
        0, dim, 2, dtype=torch.float32, device=positions.device) / dim))
    return positions[..., None].to(torch.float32) * inv_freq


def _rotate(x, cos, sin):
    """Rotate-half convention. x (..., d); cos/sin (..., d//2)."""
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(q, k, positions, *, style, theta):
    """q (B,S,H,hd), k (B,T,KH,hd), positions (B,S) int, shared by q and k.
    ``full`` rotates the whole head, ``half`` its first half. The rotation
    is computed in fp32 and cast back to each input's dtype."""
    if style == "none":
        return q, k
    if style not in ("full", "half"):
        raise NotImplementedError(f"rope style {style!r} is not yet ported")
    hd = q.shape[-1]
    rot_dim = hd if style == "full" else hd // 2
    ang = _rope_angles(positions, rot_dim, theta)[:, :, None]  # (B,S,1,rd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)

    def _apply(x):
        if rot_dim == hd:
            return _rotate(x, cos, sin)
        head, tail = x[..., :rot_dim], x[..., rot_dim:]
        return torch.cat([_rotate(head, cos, sin), tail], dim=-1)

    return _apply(q).to(q.dtype), _apply(k).to(k.dtype)
