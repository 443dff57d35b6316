"""LR schedules: linear warmup, then cosine, linear or constant decay to a
floor of ``final_frac * base_lr`` (``repro/optim/schedule.py``), in fp32."""
from __future__ import annotations

import math

import torch


def make_schedule(kind: str, base_lr: float, warmup_steps: int,
                  total_steps: int, final_frac: float = 0.1):
    if kind not in ("cosine", "linear", "constant"):
        raise ValueError(kind)

    def sched(step) -> float:
        step = torch.tensor(float(step), dtype=torch.float32)
        if step < warmup_steps:
            return float(base_lr * (step + 1.0) / max(1.0, warmup_steps))
        frac = (step - warmup_steps) / max(1.0, total_steps - warmup_steps)
        frac = torch.clamp(frac, 0.0, 1.0)
        if kind == "cosine":
            decay = base_lr * (final_frac + (1 - final_frac) * 0.5
                               * (1 + torch.cos(math.pi * frac)))
        elif kind == "linear":
            decay = base_lr * (1 - (1 - final_frac) * frac)
        else:
            decay = torch.tensor(base_lr, dtype=torch.float32)
        return float(decay)
    return sched
