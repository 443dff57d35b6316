"""The paper's workload end to end (``examples/train_vit_cifar.py`` of the
JAX package): ViT-B/16 (86 M params) trained on CIFAR-10/100 with data
parallelism, on-device augmentation, periodic held-out evaluation, elastic
checkpoints and a metrics log, through the port's training CLI.

Full size, on eight cards with the real data:

    PYTHONPATH=src python -m repro_torch.examples.train_vit_cifar --full \\
        --steps 300 --devices 8 --batch 64 --accum 2 --data-dir /data/cifar \\
        --augment --eval-every 50

By default it runs the reduced ViT through the same code on the
deterministic procedural CIFAR stream, with no download; ``--device cpu``
runs it on the CPU:

    PYTHONPATH=src python -m repro_torch.examples.train_vit_cifar --device cpu

``--data-dir`` holds the pickle distribution (``cifar-10-batches-py/`` or
``cifar-100-python/``); without it the procedural generator stands in,
batch for batch addressable by the same ``(seed, epoch, index)`` cursor.

Preemption and resume: the whole state (params, optimizer moments, step,
data cursor, rng) is saved by the async saver every ``--ckpt-every`` steps
under ``--ckpt-dir``. Stop the run at any point and run it again with
``--resume`` to continue the same loss trajectory, in the same layout or
another one (the restore reshards; e.g. a ``--devices 8`` run resumed
under ``--devices 4 --zero 3``).
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def command(argv=None) -> list:
    """The ``repro_torch.launch.train`` command of these options."""
    tmp = tempfile.gettempdir()
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="the true ViT-B/16 at 224 px (slow on the CPU)")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--accum", type=int, default=2)
    ap.add_argument("--devices", type=int, default=0)
    ap.add_argument("--dataset", default="cifar10",
                    choices=["cifar10", "cifar100"])
    ap.add_argument("--data-dir", default="",
                    help="real CIFAR pickle batches; unset -> the "
                         "deterministic procedural CIFAR")
    ap.add_argument("--augment", action="store_true",
                    help="on-device random crop, flip and Mixup/CutMix")
    ap.add_argument("--eval-every", type=int, default=40,
                    help="held-out eval cadence in steps (0 = end only)")
    ap.add_argument("--zero", type=int, default=0)
    ap.add_argument("--ckpt-every", type=int, default=20,
                    help="async save cadence (steps)")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the newest checkpoint (any saved "
                         "layout restores into this run's layout)")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tmp, "repro_torch_vit_ckpt"))
    ap.add_argument("--metrics-out",
                    default=os.path.join(tmp, "repro_torch_vit_metrics.json"))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    cmd = [sys.executable, "-m", "repro_torch.launch.train",
           "--arch", "vit-b16",
           "--steps", str(args.steps), "--batch", str(args.batch),
           "--accum", str(args.accum), "--zero", str(args.zero),
           "--dataset", args.dataset,
           "--eval-every", str(args.eval_every),
           "--label-smoothing", "0.1",
           "--ckpt-dir", args.ckpt_dir,
           "--ckpt-every", str(args.ckpt_every),
           "--metrics-out", args.metrics_out,
           "--log-every", "20", "--device", args.device]
    if not args.full:
        cmd.append("--smoke")
    if args.devices:
        cmd += ["--devices", str(args.devices)]
    if args.data_dir:
        cmd += ["--data-dir", args.data_dir]
    if args.augment:
        cmd.append("--augment")
    if args.resume:
        cmd.append("--resume")
    return cmd


def main(argv=None) -> int:
    """Run the training CLI as a child process; returns its exit code."""
    cmd = command(argv)
    print("->", " ".join(cmd), flush=True)
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=SRC + (os.pathsep + path if path
                                             else ""))
    return subprocess.call(cmd, env=env)


if __name__ == "__main__":
    sys.exit(main())
