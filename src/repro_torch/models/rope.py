"""Rotary position embeddings, the ``full``, ``half`` (GLM 2d) and
``mrope`` (Qwen2-VL) styles of ``repro.models.rope`` and its single-stream
``apply_rope_1d`` (the shared rope key of DeepSeek's MLA)."""
from __future__ import annotations

import torch


def _inv_freq(dim, theta, device):
    return 1.0 / (theta ** (torch.arange(
        0, dim, 2, dtype=torch.float32, device=device) / dim))


def _rope_angles(positions, dim, theta):
    """positions (...) -> angles (..., dim//2) in fp32."""
    return positions[..., None].to(torch.float32) * \
        _inv_freq(dim, theta, positions.device)


def _rotate(x, cos, sin):
    """Rotate-half convention. x (..., d); cos/sin (..., d//2)."""
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def mrope_angles(positions, dim, theta, sections):
    """M-RoPE (``repro/models/rope.py:22-33``): positions (B, S, 3) hold
    the (t, h, w) grid; each of the dim//2 frequency bands takes the
    position of its section, the first ``sections[0]`` bands t, the next
    ``sections[1]`` h, the last ``sections[2]`` w. Returns angles
    (B, S, dim//2) in fp32."""
    n = dim // 2
    if sum(sections) != n:
        raise ValueError(f"mrope sections {tuple(sections)} must sum to "
                         f"{n}")
    sec_ids = torch.repeat_interleave(
        torch.arange(3, device=positions.device),
        torch.tensor(sections, device=positions.device), output_size=n)
    pos = positions.to(torch.float32)[..., sec_ids]           # (B, S, n)
    return pos * _inv_freq(dim, theta, positions.device)


def apply_rope(q, k, positions, *, style, theta, sections=(0, 0, 0)):
    """q (B,S,H,hd), k (B,T,KH,hd); positions (B,S) int, or (B,S,3) for
    ``mrope``, shared by q and k, or a ``(q_pos, k_pos)`` tuple when they
    differ. ``full`` rotates the whole head, ``half`` its first half,
    ``mrope`` the whole head by the section-assigned angles
    (:func:`mrope_angles`). The rotation is computed in fp32 and cast back
    to each input's dtype."""
    if style == "none":
        return q, k
    if style not in ("full", "half", "mrope"):
        raise NotImplementedError(f"rope style {style!r} is not yet ported")
    q_pos, k_pos = positions if isinstance(positions, tuple) else \
        (positions, positions)
    hd = q.shape[-1]
    if style == "mrope":
        out = []
        for x, pos in ((q, q_pos), (k, k_pos)):
            ang = mrope_angles(pos, hd, theta, sections)[:, :, None]
            out.append(_rotate(x, torch.cos(ang), torch.sin(ang)).to(x.dtype))
        return tuple(out)
    rot_dim = hd if style == "full" else hd // 2

    def _apply(x, pos):
        ang = _rope_angles(pos, rot_dim, theta)[:, :, None]  # (B,S,1,rd/2)
        cos, sin = torch.cos(ang), torch.sin(ang)
        if rot_dim == hd:
            return _rotate(x, cos, sin).to(x.dtype)
        head, tail = x[..., :rot_dim], x[..., rot_dim:]
        return torch.cat([_rotate(head, cos, sin), tail], dim=-1).to(x.dtype)

    return _apply(q, q_pos), _apply(k, k_pos)


def apply_rope_1d(x, positions, *, theta):
    """RoPE for a single (B,S,1,rd) stream (MLA's shared rope key): the
    whole width rotated in fp32 and cast back to x's dtype
    (``repro/models/rope.py:65-68``)."""
    ang = _rope_angles(positions, x.shape[-1], theta)[:, :, None]
    return _rotate(x, torch.cos(ang), torch.sin(ang)).to(x.dtype)
