"""Train/eval CLI of the port — the eval-only subset of ``repro.launch.train``.

Final-state eval of a freshly initialised ViT on CIFAR (the real pickle
batches under ``--data-dir``, else the procedural split):

    PYTHONPATH=src python -m repro_torch.launch.train --arch vit-b16 \\
        --steps 0 --eval-every 1 --eval-batch 128

prints the reference's ``[eval ] step ... top1=... top5=... loss=...
(n/N)`` line and, with ``--metrics-out``, writes the same metrics rows.
There is no JAX on the card, so the params are initialised here from
``--seed``. Training (``--steps > 0``) lands with the next slice of the
port. Runs on ``cuda`` unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
import time

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.engine import Evaluator, resolve_device
from repro_torch.data.datasets import CIFARSource
from repro_torch.models.transformer import ViT, init_params


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="vit-b16")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--dataset", default="cifar10",
                    choices=["cifar10", "cifar100"])
    ap.add_argument("--data-dir", default="",
                    help="directory holding the CIFAR pickle batches; unset "
                         "-> the deterministic procedural split")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=20,
                    help="training steps; only 0 is ported so far")
    ap.add_argument("--eval-every", type=int, default=0,
                    help="evaluate every N steps and at the end (0 = never)")
    ap.add_argument("--eval-batch", type=int, default=16,
                    help="eval batch; the last non-divisible batch is "
                         "mask-padded")
    ap.add_argument("--eval-size", type=int, default=0,
                    help="truncate the eval split to N examples (0 = all)")
    ap.add_argument("--dtype", default="",
                    help="override the compute dtype (bfloat16 | float32)")
    ap.add_argument("--metrics-out", default="")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--no-kernels", action="store_true",
                    help="naive attention instead of the CUDA flash kernel")
    return ap.parse_args(argv)


def main(argv=None):
    """Run the CLI; returns the metrics rows it wrote."""
    args = parse_args(argv)
    if args.steps > 0:
        raise SystemExit(
            f"[train] --steps {args.steps}: training lands in slice 2 of the "
            f"PyTorch port; this slice runs the final-state eval only "
            f"(--steps 0 --eval-every 1)")
    device = resolve_device(args.device)

    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    cfg = cfg.replace(use_kernels=not args.no_kernels)
    if args.dtype:
        cfg = cfg.replace(dtype=args.dtype)
    source = CIFARSource(args.dataset, data_dir=args.data_dir or None,
                         seed=args.seed, resolution=cfg.image_size,
                         eval_size=args.eval_size or None)
    cfg = cfg.replace(num_classes=source.spec.num_classes)
    vit = ViT(cfg, init_params(cfg, seed=args.seed, device=device))
    ev = Evaluator(cfg, vit, preproc=source.preproc, device=device)
    n_params = sum(p.numel() for p in vit.parameters())
    print(f"[train] arch={cfg.name} params={n_params / 1e6:.1f}M "
          f"device={device} dtype={cfg.dtype} kernels="
          f"{'on' if cfg.use_kernels else 'off'}")
    print(f"[train] dataset={source.name} "
          f"{'procedural' if source.procedural else 'disk'} "
          f"eval={source.eval_size}")

    hist = []
    t0 = time.time()
    if args.eval_every:
        step = 0            # final-state eval of the (untrained) state
        em = ev.evaluate(source.eval_batches(args.eval_batch))
        em["step"] = step
        em["wall_s"] = round(time.time() - t0, 2)
        hist.append(em)
        print(f"[eval ] step {step:5d} "
              f"top1={em['eval_acc']:.4f} top5={em['eval_top5_acc']:.4f} "
              f"loss={em['eval_loss']:.4f} "
              f"({em['eval_top1_count']}/{em['eval_count']})")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(hist, f, indent=1)
    print(f"[train] done in {time.time() - t0:.1f}s; no steps run "
          f"(start=0, end={args.steps})")
    return hist


if __name__ == "__main__":
    main()
