"""Quickstart: train a reduced ViT-B/16 on CIFAR-10 with the port's engine
(gradient accumulation and on-device augmentation, batches from the
two-stage prefetcher), then evaluate on the held-out split
(``examples/quickstart.py`` of the JAX package):

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Without a downloaded dataset it runs the deterministic procedural CIFAR
stream (same shapes and statistics, no network); point ``REPRO_DATA_DIR``
at a directory holding ``cifar-10-batches-py/`` to train on the real
batches through the same code. It runs on ``cuda`` unless ``--device cpu``
is given.
"""
from __future__ import annotations

import argparse
import os

from repro_torch.configs import EngineConfig, get_smoke_config
from repro_torch.core.engine import Evaluator, Trainer, resolve_device
from repro_torch.data.augment import AugmentConfig
from repro_torch.data.datasets import CIFARSource
from repro_torch.data.pipeline import DataPipeline
from repro_torch.models.transformer import Transformer, init_params

STEPS = 40


def main(argv=None):
    """Train and evaluate; returns (the logged train metrics, the eval
    metrics)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_smoke_config("vit-b16").replace(dtype="float32",
                                              label_smoothing=0.1)
    # the paper's Appendix-B style config
    ecfg = EngineConfig(
        train_batch_size=32,
        gradient_accumulation_steps=2,   # paper §IV: the micro-batching knob
        zero_stage=0,                    # paper-faithful DDP
        optimizer="adamw",
        lr=1e-3, total_steps=STEPS, warmup_steps=4,
    )
    # real CIFAR-10 if REPRO_DATA_DIR has it, procedural otherwise; the
    # source ships uint8 batches, which the step upsamples and normalises
    # on the device (preproc)
    source = CIFARSource("cifar10", data_dir=os.environ.get("REPRO_DATA_DIR"),
                         resolution=cfg.image_size)
    pipe = DataPipeline(global_batch=32, source=source)
    # crop, flip and Mixup/CutMix on the device, drawn from the state's rng
    aug = AugmentConfig(num_classes=cfg.num_classes)
    trainer = Trainer(cfg, ecfg, preproc=source.preproc, device=device,
                      aug=aug)
    params = init_params(cfg, seed=0, device=device)
    n_params = sum(p.numel() for p in params.values())
    state = trainer.init_state(params)      # params + opt + step + rng

    print(f"model={cfg.name} params={n_params / 1e6:.2f}M devices=1 "
          f"device={device} "
          f"data={'procedural' if source.procedural else 'disk'} "
          f"train={source.train_size} eval={source.eval_size}")
    logged = []
    with pipe.prefetch(0, 0, device=device) as batches:
        for step in range(STEPS):
            _, batch, _ = next(batches)
            state, m = trainer.train_step(state, batch)
            if step % 10 == 0 or step == STEPS - 1:
                row = {k: float(m[k]) for k in ("loss", "acc", "lr")}
                logged.append(dict(row, step=step))
                print(f"step {step:3d}  loss {row['loss']:.4f}  "
                      f"acc {row['acc']:.3f}  lr {row['lr']:.1e}")

    # eval over the held-out split: integer top-1/top-5 counts and the
    # NLL, the padded final batch masked out
    ev = Evaluator(cfg, Transformer(cfg, state.params), ecfg=ecfg,
                   preproc=trainer.preproc, device=device)
    res = ev.evaluate(source.eval_batches(32))
    print(f"eval: top1 {res['eval_acc']:.3f} "
          f"({res['eval_top1_count']}/{res['eval_count']})  "
          f"top5 {res['eval_top5_acc']:.3f}  loss {res['eval_loss']:.4f}")
    print("done — loss should be well below the initial ~2.3")
    return logged, res


if __name__ == "__main__":
    main()
