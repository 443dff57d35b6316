#!/usr/bin/env python3
"""K4 and K5 (the fused RMSNorm, ``csrc/rmsnorm.cu``) on the card at the
decoders' shape (rows 4096 = micro-batch 4 x seq 1024, D 4096, bf16): K5 by
its CTA count (``rmsnorm.BWD_BLOCKS``, the cap that sets the rows per CTA,
and so dscale's summation order), and K4 against ``F.rms_norm`` (a yardstick
the port never calls), each timed in turns (A, B, ..., B, A).

    python3 scripts/rmsnorm_timing.py

Needs one CUDA card and nvcc.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

BLOCKS = (256, 128, 512, 1024)      # rmsnorm.BWD_BLOCKS first


def main():
    card = cs.phase_card().split(",")[0]
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import rmsnorm as rms

    gen = torch.Generator(device="cuda").manual_seed(4)
    rows, d = cs.RMS_CASES[0][1]
    x, dy = (torch.randn(rows, d, device="cuda", generator=gen).bfloat16()
             for _ in range(2))
    scale = torch.randn(d, device="cuda", generator=gen)
    _, rinv = rms.fused_rmsnorm_fwd(x, scale, cs.LM_EPS)

    chosen = rms.BWD_BLOCKS
    k5 = {n: [] for n in BLOCKS}
    for n in BLOCKS + BLOCKS[::-1]:
        rms.BWD_BLOCKS = n
        k5[n].append(cs.time_ms(
            lambda: rms.fused_rmsnorm_bwd(x, scale, rinv, dy)))
    rms.BWD_BLOCKS = chosen
    print(f"[rms timing] K5 at ({rows}, {d}) bf16 on {card} by CTA cap "
          f"(the port's: {chosen}), median CUDA-event ms of each turn: "
          + "; ".join(f"{n} CTAs of {-(-rows // n)} rows: "
                      f"{[round(t, 4) for t in ts]}"
                      for n, ts in k5.items()), flush=True)

    wl = scale.to(x.dtype)
    k4, lib = [], []
    for turn in ("k4", "lib", "lib", "k4", "k4", "lib"):
        if turn == "k4":
            k4.append(cs.time_ms(
                lambda: rms.fused_rmsnorm_fwd(x, scale, cs.LM_EPS)))
        else:
            with torch.no_grad():
                lib.append(cs.time_ms(
                    lambda: F.rms_norm(x, (d,), wl, cs.LM_EPS), calls=10))
    print(f"[rms timing] K4 at ({rows}, {d}) bf16 on {card}: "
          f"{[round(t, 4) for t in k4]} ms; F.rms_norm "
          f"{[round(t, 4) for t in lib]} ms (turns K4, F, F, K4, K4, F)",
          flush=True)


if __name__ == "__main__":
    main()
