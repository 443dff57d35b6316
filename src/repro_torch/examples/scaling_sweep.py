"""The paper's experiment end to end (``examples/scaling_sweep.py`` of the
JAX package): a strong-scaling sweep of data-parallel training across
device counts through the port's training CLI, then the analytic
projection of ``core/comm_model.py``.

    PYTHONPATH=src python -m repro_torch.examples.scaling_sweep \\
        --counts 1 2 4 --device cpu            # gloo worlds on the CPU
    PYTHONPATH=src python -m repro_torch.examples.scaling_sweep \\
        --counts 1 [--zero 3] [--accum 2]      # NCCL, one rank per card

Each run is a child process whose ``--metrics-out`` JSON (the step-level
loss and wall-clock history) it reads instead of scraping stdout; runs are
seeded, so sweeps repeat. On ``cuda`` a count above the number of cards
raises before any run. The reference's dp x pp ``--layouts`` need pipeline
parallelism, which the port does not have yet, and are refused.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

from repro_torch.core.comm_model import H100_SXM, strong_scaling_times, \
    weak_scaling_times

SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run_train(devices: int, batch: int, steps: int = 8, *, accum: int = 1,
              zero: int = 0, seed: int = 0, device: str = "cuda") -> dict:
    """One trainer child process -> {"wall_s", "final_loss", "history"}."""
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=SRC + (os.pathsep + path if path
                                             else ""))
    with tempfile.NamedTemporaryFile(mode="r", suffix=".json",
                                     prefix="repro_torch_sweep_") as f:
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch",
             "vit-b16", "--smoke", "--steps", str(steps), "--batch",
             str(batch), "--devices", str(devices), "--log-every",
             str(steps), "--accum", str(accum), "--zero", str(zero),
             "--seed", str(seed), "--device", device, "--metrics-out",
             f.name],
            env=env, capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"trainer with --devices {devices} exited "
                               f"{out.returncode}:\n{out.stderr[-2000:]}")
        hist = json.load(f)
    if not hist:
        raise RuntimeError("trainer wrote no metrics history")
    return {"wall_s": hist[-1]["wall_s"], "final_loss": hist[-1]["loss"],
            "history": hist}


def main(argv=None) -> dict:
    """Run the sweep and the projection; returns the results it wrote."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--counts", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--layouts", nargs="*", default=[],
                    help="dp x pp pipeline layouts (not ported yet)")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--zero", type=int, default=0, choices=[0, 1, 2, 3])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--json-out", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_scaling.json"))
    args = ap.parse_args(argv)
    if args.layouts:
        raise SystemExit("[sweep] --layouts needs pipeline parallelism, "
                         "which is not yet ported to repro_torch (item 16)")
    if args.device == "cuda":
        import torch
        cards = torch.cuda.device_count()
        if max(args.counts) > cards:
            raise SystemExit(f"[sweep] --counts {max(args.counts)} needs as "
                             f"many cards; torch sees {cards}")

    results = {}
    print(f"== measured strong scaling ({args.device}, fixed global batch "
          f"{args.batch}, accum {args.accum}, ZeRO {args.zero}, seed "
          f"{args.seed}) ==")
    for n in args.counts:
        r = run_train(n, args.batch, accum=args.accum,
                      zero=args.zero, seed=args.seed, device=args.device)
        results[f"dp{n}"] = r["wall_s"]
        base = results[f"dp{args.counts[0]}"]
        print(f"  {n} devices: {r['wall_s']:6.1f}s  speedup "
              f"{base / r['wall_s']:.2f}x  final_loss {r['final_loss']:.4f}")

    # the paper's T4 cluster, and one node of eight H100s over NVLink
    for label, bw, counts in (
            ("the paper's T4 cluster", 3.125e9, [1, 2, 4, 8, 16, 32]),
            (f"one {H100_SXM.name} node (NVLink)", H100_SXM.nvlink_bw,
             [1, 2, 4, 8])):
        print(f"\n== analytic projection to {label} ==")
        t = strong_scaling_times(2.0, 344e6, counts, comm_bw=bw)
        for n, ti in zip(counts, t):
            print(f"  {n:3d} GPUs: {ti:.3f}s/step  speedup {t[0] / ti:.2f}x")
        w = weak_scaling_times(2.0, 344e6, [1, 2, 4, 8], comm_bw=bw)
        print(f"  weak scaling flatness: {max(w) / min(w):.2f}x")
    with open(args.json_out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"  results -> {args.json_out}")
    return results


if __name__ == "__main__":
    main()
