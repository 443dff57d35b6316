"""Training CLI of the port: the single-card subset of ``repro.launch.train``.

Trains a freshly initialised ViT with gradient accumulation, the
hand-written AdamW/SGD/LAMB and the warmup-cosine schedule, on CIFAR (the
real pickle batches under ``--data-dir``, else the procedural stream) or the
legacy fp32 synthetic stream, and evaluates on the held-out split:

    PYTHONPATH=src python -m repro_torch.launch.train --arch vit-b16 \\
        --steps 10 --batch 128 --accum 2 --eval-every 10 --eval-batch 128

A decoder (``--arch chatglm3-6b``, or the recurrent ``--arch rwkv6-7b``)
trains on the synthetic token stream of ``--seq`` tokens per sequence (an
epoch of ``--batch`` x ``--steps`` sequences, as the reference sizes it);
``--layers`` cuts the depth:

    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-7b \\
        --layers 4 --seq 1024 --batch 8 --accum 2 --steps 10

prints the reference's ``[train] step ... loss= gnorm= lr=`` and
``[eval ] step ... top1=... top5=... loss=... (n/N)`` lines and, with
``--metrics-out``, writes the same metrics rows (train rows every
``--log-every`` steps, ``eval_*`` rows, each with ``step`` and ``wall_s``).
``--steps 0 --eval-every 1`` evaluates the initial state only. There is no
JAX on the card, so the params are initialised here from ``--seed``. The
anomaly guard retries a batch whose loss or grad-norm is non-finite and
aborts after ``--guard-max-skips`` skips in a row. Runs on ``cuda`` unless
``--device cpu`` is given.

Data parallelism: ``--devices N`` starts N ranks (one per card over NCCL
on ``cuda``; gloo processes on ``--device cpu``) that train the same global
batches under ``--zero 0..3``; under ``torchrun`` the ranks are its
processes. Rank 0 prints and writes ``--metrics-out``. ``--augment`` adds
the on-device crop, flip and Mixup/CutMix (ViT only):

    PYTHONPATH=src python -m repro_torch.launch.train --arch vit-b16 \\
        --devices 8 --zero 3 --batch 64 --accum 2 --augment

Options of the reference that are not ported yet (pipelines, checkpoints,
resilience) are refused, never ignored.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from repro_torch.configs import EngineConfig, get_config, get_smoke_config
from repro_torch.core import distributed
from repro_torch.core.engine import Evaluator, Trainer, resolve_device, \
    to_device
from repro_torch.data.augment import AugmentConfig
from repro_torch.data.datasets import make_source
from repro_torch.data.pipeline import DataPipeline
from repro_torch.data.synthetic import DATASETS
from repro_torch.models.transformer import Transformer, init_params

# the reference's options that wait for a later slice: flag -> (argparse
# kwargs, what it needs)
NOT_YET_PORTED = {
    "--pp": ({"type": int}, "pipeline parallelism (item 16)"),
    "--shard-dir": ({}, "streaming shards (item 11)"),
    "--ckpt-dir": ({}, "checkpointing (item 10)"),
    "--ckpt-every": ({"type": int}, "checkpointing (item 10)"),
    "--ckpt-sync": ({"action": "store_true"}, "checkpointing (item 10)"),
    "--resume": ({"action": "store_true"}, "checkpointing (item 10)"),
    "--resume-step": ({"type": int}, "checkpointing (item 10)"),
    "--stop-after": ({"type": int}, "checkpointing (item 10)"),
    "--keep-last": ({"type": int}, "checkpointing (item 10)"),
    "--supervise": ({"action": "store_true"}, "resilience (item 12)"),
    "--max-restarts": ({"type": int}, "resilience (item 12)"),
    "--inject-faults": ({}, "resilience (item 12)"),
}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="vit-b16")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "sgd", "lamb"])
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dataset", default="cifar10",
                    choices=["cifar10", "cifar100", "synthetic"],
                    help="real/procedural CIFAR or the legacy fp32 "
                         "synthetic stream")
    ap.add_argument("--data-dir", default="",
                    help="directory holding the CIFAR pickle batches; unset "
                         "-> the deterministic procedural split")
    ap.add_argument("--train-size", type=int, default=0,
                    help="truncate the train split to N examples (0 = all; "
                         "sizes the procedural stream's epoch)")
    ap.add_argument("--eval-every", type=int, default=0,
                    help="evaluate every N steps and at the end (0 = never; "
                         "needs --dataset cifar10|cifar100)")
    ap.add_argument("--eval-batch", type=int, default=0,
                    help="eval batch (0 -> --batch); the last non-divisible "
                         "batch is mask-padded")
    ap.add_argument("--eval-size", type=int, default=0,
                    help="truncate the eval split to N examples (0 = all)")
    ap.add_argument("--label-smoothing", type=float, default=0.0)
    ap.add_argument("--seq", type=int, default=128,
                    help="tokens per sequence (decoder archs)")
    ap.add_argument("--layers", type=int, default=0,
                    help="override cfg.num_layers (0 = config default)")
    ap.add_argument("--dtype", default="",
                    help="override the compute dtype (bfloat16 | float32)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics-out", default="")
    ap.add_argument("--no-guard", action="store_true",
                    help="disable the anomaly guard (a non-finite loss or "
                         "grad-norm then corrupts the params)")
    ap.add_argument("--guard-max-skips", type=int, default=3,
                    help="abort after this many consecutive skipped "
                         "updates of the same batch")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--no-kernels", action="store_true",
                    help="naive attention, plain norms and the chunked "
                         "WKV6 instead of the CUDA kernels")
    ap.add_argument("--devices", type=int, default=0,
                    help="data-parallel ranks to start (one per card on "
                         "cuda); 0 = one device, no process group")
    ap.add_argument("--zero", type=int, default=0, choices=[0, 1, 2, 3],
                    help="ZeRO stage of the data-parallel run")
    ap.add_argument("--augment", action="store_true",
                    help="random crop, flip and Mixup/CutMix (vit archs)")
    for flag, (kw, _) in NOT_YET_PORTED.items():
        ap.add_argument(flag, default=None, help="not yet ported", **kw)
    args = ap.parse_args(argv)
    for flag, (_, needs) in NOT_YET_PORTED.items():
        if getattr(args, flag[2:].replace("-", "_")) not in (None, False):
            raise SystemExit(f"[train] {flag} is not yet ported to "
                             f"repro_torch: it needs {needs}")
    return args


def _torchrun() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def main(argv=None):
    """Run the CLI; returns the metrics rows it wrote (rank 0's)."""
    argv = sys.argv[1:] if argv is None else argv
    args = parse_args(argv)
    if args.devices < 0:
        raise SystemExit(f"[train] --devices must be >= 0: {args.devices}")
    if _torchrun():
        world = distributed.init_world(args.device)
        if args.devices not in (0, world.size):
            raise SystemExit(f"[train] --devices {args.devices} under a "
                             f"torchrun world of {world.size}")
        try:
            return run(args, world)
        finally:
            distributed.close_world()
    if args.devices:
        return distributed.spawn(_rank_main, args.devices, argv,
                                 device=args.device)[0]
    if args.zero:
        raise SystemExit("[train] --zero needs a data-parallel world: "
                         "--devices N, or torchrun")
    return run(args, None)


def _rank_main(world, argv):
    """One spawned rank of ``--devices N``."""
    return run(parse_args(argv), world)


def run(args, world):
    """Train (and evaluate) on one device, or as one rank of ``world``."""
    device = resolve_device(args.device) if world is None else world.device
    dp = world.size if world is not None else 1
    lead = world is None or world.rank == 0

    def say(*a, **kw):
        if lead:
            print(*a, **kw)

    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    cfg = cfg.replace(use_kernels=not args.no_kernels)
    if args.dtype:
        cfg = cfg.replace(dtype=args.dtype)
    if args.layers:
        cfg = cfg.replace(num_layers=args.layers)
    vit = cfg.arch_type == "vit"
    if args.augment and not vit:
        raise SystemExit(f"[train] --augment is for the vit archs, not "
                         f"{cfg.name}")
    source = None
    if vit:
        source = make_source(args.dataset, data_dir=args.data_dir or None,
                             seed=args.seed, resolution=cfg.image_size,
                             train_size=args.train_size or None,
                             eval_size=args.eval_size or None)
        spec = source.spec if source is not None else DATASETS["cifar10"]
        cfg = cfg.replace(num_classes=spec.num_classes,
                          label_smoothing=args.label_smoothing)
    if args.eval_every and source is None:
        raise SystemExit("[train] --eval-every needs a real dataset "
                         "(--dataset cifar10|cifar100 on a vit arch)")
    eval_batch = args.eval_batch or args.batch
    if args.eval_every and eval_batch % dp:
        raise SystemExit(f"[train] eval batch {eval_batch} not divisible "
                         f"by the {dp} data-parallel ranks")
    ecfg = EngineConfig(
        train_batch_size=args.batch, gradient_accumulation_steps=args.accum,
        zero_stage=args.zero, optimizer=args.optimizer, lr=args.lr,
        total_steps=args.steps, warmup_steps=max(1, args.steps // 10),
        seed=args.seed, guard_anomalies=not args.no_guard,
        guard_max_skips=args.guard_max_skips)
    preproc = source.preproc if source is not None else None
    aug = AugmentConfig(num_classes=cfg.num_classes) if args.augment \
        else None
    trainer = Trainer(cfg, ecfg, preproc=preproc, device=device, aug=aug,
                      world=world)
    params = init_params(cfg, seed=args.seed, device=device)
    n_params = sum(p.numel() for p in params.values())
    state = trainer.init_state(params)
    del params          # ZeRO-3 keeps only this rank's chunks
    model = Transformer(cfg, state.params)
    say(f"[train] arch={cfg.name} params={n_params / 1e6:.1f}M "
        f"layers={cfg.num_layers} device={device} dtype={cfg.dtype} "
        f"kernels={'on' if cfg.use_kernels else 'off'} dp={dp} "
        f"micro_batch={ecfg.derived_micro_batch(dp)} accum={args.accum} "
        f"zero={args.zero} opt={args.optimizer} "
        f"aug={'on' if aug else 'off'}")
    if not vit:
        say(f"[train] tokens: seq={args.seq} vocab={cfg.vocab_size}")
        pipe = DataPipeline(kind="token", global_batch=args.batch,
                            vocab=max(cfg.vocab_size, 2), seq_len=args.seq,
                            epoch_size=args.batch * args.steps,
                            seed=args.seed)
    elif source is not None:
        say(f"[train] dataset={source.name} "
            f"{'procedural' if source.procedural else 'disk'} "
            f"train={source.train_size} eval={source.eval_size}")
        pipe = DataPipeline(global_batch=args.batch, source=source,
                            seed=args.seed)
    else:
        pipe = DataPipeline(global_batch=args.batch, dataset=spec,
                            resolution=cfg.image_size, seed=args.seed)

    hist = []
    t0 = time.time()
    ev = Evaluator(cfg, model, ecfg=ecfg, preproc=preproc, device=device,
                   world=world, gather=trainer.forward_gather) \
        if args.eval_every else None
    last_eval_step = -1

    def run_eval(at_step):
        nonlocal last_eval_step
        em = ev.evaluate(source.eval_batches(eval_batch))
        em["step"] = at_step
        em["wall_s"] = round(time.time() - t0, 2)
        hist.append(em)
        last_eval_step = at_step
        say(f"[eval ] step {at_step:5d} "
            f"top1={em['eval_acc']:.4f} top5={em['eval_top5_acc']:.4f} "
            f"loss={em['eval_loss']:.4f} "
            f"({em['eval_top1_count']}/{em['eval_count']})")

    for step in range(state.step, args.steps):
        batch = to_device(pipe.batch_at(state.epoch, state.batch_index),
                          device)
        nxt = pipe.next_cursor(state.epoch, state.batch_index)
        # a guard-skipped step leaves the state as it was: retry the SAME
        # cursor batch, and escalate after guard_max_skips skips in a row
        skips = 0
        while True:
            state, metrics = trainer.train_step(state, batch)
            if not ecfg.guard_anomalies or metrics["step_ok"]:
                break
            skips += 1
            say(f"[guard] step {step}: non-finite loss/grad-norm — "
                f"update skipped ({skips}/{ecfg.guard_max_skips})",
                flush=True)
            if skips >= ecfg.guard_max_skips:
                raise RuntimeError(
                    f"anomaly guard: {skips} consecutive skipped updates "
                    f"at step {step}; aborting (persistent data/numerics "
                    f"problem)")
        state = state.replace(epoch=nxt[0], batch_index=nxt[1])
        if step % args.log_every == 0 or step == args.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step
            m["wall_s"] = round(time.time() - t0, 2)
            hist.append(m)
            say(f"[train] step {step:5d} loss={m['loss']:.4f} "
                f"gnorm={m['grad_norm']:.3f} lr={m['lr']:.2e} "
                f"({m['wall_s']:.1f}s)")
        if args.eval_every and (step + 1) % args.eval_every == 0:
            run_eval(step + 1)

    if args.eval_every and state.step != last_eval_step:
        run_eval(state.step)            # final-state eval
    if args.metrics_out and lead:
        with open(args.metrics_out, "w") as f:
            json.dump(hist, f, indent=1)
    tr = [h for h in hist if "loss" in h]
    if len(tr) >= 2 and not (tr[-1]["loss"] < tr[0]["loss"]):
        say("[train] WARNING: loss did not decrease")
    final = f"final loss {tr[-1]['loss']:.4f}" if tr \
        else f"no steps run (start=0, end={args.steps})"
    say(f"[train] done in {time.time() - t0:.1f}s; {final}")
    return hist


if __name__ == "__main__":
    main()
