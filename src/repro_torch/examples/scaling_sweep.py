"""The paper's experiment end to end (``examples/scaling_sweep.py`` of the
JAX package): a strong-scaling sweep of data-parallel training across
device counts, and dp x pp (x v) pipeline layouts, through the port's
training CLI, then the analytic projection of ``core/comm_model.py``.

    PYTHONPATH=src python -m repro_torch.examples.scaling_sweep \\
        --counts 1 2 4 --device cpu            # gloo worlds on the CPU
    PYTHONPATH=src python -m repro_torch.examples.scaling_sweep \\
        --counts 1 --layouts 1x2 2x2x2 --device cpu
    PYTHONPATH=src python -m repro_torch.examples.scaling_sweep \\
        --counts 1 [--zero 3] [--accum 2]      # NCCL, one rank per card

Each run is a child process whose ``--metrics-out`` JSON (the step-level
loss and wall-clock history) it reads instead of scraping stdout; runs are
seeded, so sweeps repeat. A layout ``DPxPP[xV]`` runs on dp * pp ranks at
accum max(2, pp), the smoke stack padded to pp * v layers where it has
fewer, and records its wall time and the simulated schedule's bubble, as
the reference's does. On ``cuda`` a count or layout above the number of
cards raises before any run.
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
from repro_torch.core.pipeline import simulated_bubble_fraction

SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run_train(devices: int, batch: int, steps: int = 8, *, accum: int = 1,
              zero: int = 0, seed: int = 0, device: str = "cuda",
              pp: int = 1, interleave: int = 1, layers: int = 0) -> dict:
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
             "--pp", str(pp), "--pp-interleave", str(interleave),
             "--layers", str(layers), "--seed", str(seed), "--device",
             device, "--metrics-out", f.name],
            env=env, capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"trainer with --devices {devices} exited "
                               f"{out.returncode}:\n{out.stderr[-2000:]}")
        hist = json.load(f)
    if not hist:
        raise RuntimeError("trainer wrote no metrics history")
    return {"wall_s": hist[-1]["wall_s"], "final_loss": hist[-1]["loss"],
            "history": hist}


def parse_layout(layout: str) -> tuple:
    """``"DPxPP[xV]"`` -> (dp, pp, v)."""
    try:
        parts = [int(x) for x in layout.split("x")]
    except ValueError:
        parts = []
    if len(parts) not in (2, 3) or min(parts) < 1:
        raise SystemExit(f"[sweep] layout {layout!r} is not DPxPP[xV]")
    return parts[0], parts[1], parts[2] if len(parts) > 2 else 1


def main(argv=None) -> dict:
    """Run the sweep and the projection; returns the results it wrote."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--counts", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--layouts", nargs="*", default=[],
                    help="dp x pp (x interleave) pipeline layouts: '2x1', "
                         "'1x2', '2x2x2' (= dp2_pp2_v2); dp * pp ranks, "
                         "accum max(2, pp), layers padded to pp * v")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--zero", type=int, default=0, choices=[0, 1, 2, 3])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--json-out", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_scaling.json"))
    args = ap.parse_args(argv)
    layouts = [parse_layout(x) for x in args.layouts]
    if args.device == "cuda":
        import torch
        cards = torch.cuda.device_count()
        need = max(args.counts + [dp * pp for dp, pp, _ in layouts])
        if need > cards:
            raise SystemExit(f"[sweep] {need} ranks need as many cards; "
                             f"torch sees {cards}")

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

    if layouts:
        print("\n== dp x pp (x v) pipeline layouts (1F1B, fixed global "
              "batch) ==")
        ref_loss = None
        for dp, pp, v in layouts:
            accum = max(2, pp)
            # the smoke stack splits into pp * v chunks only when that
            # divides it: pad the stack otherwise
            layers = pp * v if pp * v > 2 else 0
            r = run_train(dp * pp, args.batch, accum=accum, zero=args.zero,
                          seed=args.seed, device=args.device, pp=pp,
                          interleave=v, layers=layers)
            name = f"dp{dp}_pp{pp}" + (f"_v{v}" if v > 1 else "")
            results[name] = r["wall_s"]
            # the bubble read off the simulated schedule, which differs
            # from the flat formula once v > 1
            bubble = simulated_bubble_fraction(accum, pp, v) \
                if pp > 1 else 0.0
            results[f"{name}_bubble"] = bubble
            ref_loss = r["final_loss"] if ref_loss is None else ref_loss
            print(f"  {name}: {r['wall_s']:6.1f}s  bubble {bubble:.3f}  "
                  f"final_loss {r['final_loss']:.4f} (|d| vs first layout "
                  f"{abs(r['final_loss'] - ref_loss):.1e})")

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
