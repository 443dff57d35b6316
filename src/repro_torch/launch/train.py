"""Training CLI of the port: the single-card subset of ``repro.launch.train``.

Trains a freshly initialised ViT with gradient accumulation, the
hand-written AdamW/SGD/LAMB and the warmup-cosine schedule, on CIFAR (the
real pickle batches under ``--data-dir``, a ``repro-shards/v1`` directory
under ``--shard-dir``, else the procedural stream) or the legacy fp32
synthetic stream, and evaluates on the held-out split:

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

Host data (``data/pipeline.py``): the batches come from a two-stage
prefetcher (``--prefetch-depth`` batches in flight at each stage; on
``cuda`` pinned copies on a side stream) started at the restored cursor,
which retries a transient data-source error (a planned ``data@k`` fault
included); ``--no-prefetch`` builds each batch in the step loop and copies
it from pageable memory, and a data fault then ends the attempt. A shard
directory is written by ``python -m repro_torch.data.streaming --out D``.

Data parallelism: ``--devices N`` starts N ranks (one per card over NCCL
on ``cuda``; gloo processes on ``--device cpu``) that train the same global
batches under ``--zero 0..3``; under ``torchrun`` the ranks are its
processes. Rank 0 prints and writes ``--metrics-out``. ``--augment`` adds
the on-device crop, flip and Mixup/CutMix (ViT only):

    PYTHONPATH=src python -m repro_torch.launch.train --arch vit-b16 \\
        --devices 8 --zero 3 --batch 64 --accum 2 --augment

Checkpoints and resume (``repro_torch.checkpoint``, the reference's
``repro-elastic-ckpt/v2``): ``--ckpt-dir D --ckpt-every N`` saves the whole
state every N steps (async unless ``--ckpt-sync``) and once more at the
end; each rank writes its chunks. ``--resume`` restores the newest valid
step of ``D`` (``--resume-step`` a given one) into THIS run's world and ZeRO
stage, whatever wrote it, and continues the trajectory; ``--stop-after K``
ends the loop at step K while the LR schedule keeps ``--steps``:

    train --steps 6 --stop-after 3 --ckpt-dir D          # preempted
    train --steps 6 --resume --ckpt-dir D                # same trajectory

Fault tolerance (``repro_torch.resilience``): ``--supervise`` runs the
command as a child process, relaunched with ``--resume`` after a failure up
to ``--max-restarts`` times; SIGTERM/SIGINT make the ranks agree on a step,
save it (unless the cadence just did) and exit 75; ``--keep-last K`` keeps
the newest K steps (never the newest valid one);
``--inject-faults "nan_grad@3,preempt@5"`` (or ``seeded``) installs a
deterministic chaos schedule whose firings land once in
``<ckpt-dir>/faults.jsonl``.

Options of the reference that are not ported yet (pipeline parallelism)
are refused, never ignored.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time

from repro_torch.checkpoint import latest_step, save_checkpoint
from repro_torch.configs import EngineConfig, get_config, get_smoke_config
from repro_torch.core import distributed
from repro_torch.core.engine import Evaluator, Trainer, resolve_device, \
    to_device
from repro_torch.data.augment import AugmentConfig
from repro_torch.data.datasets import make_source
from repro_torch.data.pipeline import DataPipeline
from repro_torch.data.synthetic import DATASETS
from repro_torch.models.transformer import Transformer, init_params
from repro_torch.resilience import RESTARTABLE_EXIT, FaultPlan, child_argv, \
    install_preemption_handler, supervise
from repro_torch.resilience import faults as _faults

# the reference's options that wait for a later slice: flag -> (argparse
# kwargs, what it needs)
NOT_YET_PORTED = {
    "--pp": ({"type": int}, "pipeline parallelism (item 16)"),
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
    ap.add_argument("--shard-dir", default="",
                    help="stream from a repro-shards/v1 shard directory "
                         "(data/streaming.py; write one with `python -m "
                         "repro_torch.data.streaming --out DIR`) instead of "
                         "an in-RAM split; overrides --dataset/--data-dir")
    ap.add_argument("--train-size", type=int, default=0,
                    help="truncate the train split to N examples (0 = all; "
                         "bounds disk and shard splits and sizes the "
                         "procedural stream's epoch)")
    ap.add_argument("--prefetch-depth", type=int, default=2,
                    help="batches in flight at EACH prefetch stage "
                         "(synthesis and host->device transfer run in "
                         "separate threads)")
    ap.add_argument("--no-prefetch", action="store_true",
                    help="synchronous host data path (bench baseline)")
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
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="save the whole state every N steps (0 = at the "
                         "end only); async unless --ckpt-sync")
    ap.add_argument("--ckpt-sync", action="store_true",
                    help="blocking saves")
    ap.add_argument("--resume", action="store_true",
                    help="restore the newest valid step of --ckpt-dir into "
                         "this run's layout and continue the trajectory")
    ap.add_argument("--resume-step", type=int, default=-1,
                    help="restore this step instead of the newest valid")
    ap.add_argument("--stop-after", type=int, default=0,
                    help="stop at this absolute step while the LR schedule "
                         "keeps --steps as its horizon")
    ap.add_argument("--keep-last", type=int, default=0,
                    help="keep the newest K checkpoints (0 = all); never "
                         "deletes the newest one that passes verification")
    ap.add_argument("--supervise", action="store_true",
                    help="run as a child process, relaunched with --resume "
                         "after a failure")
    ap.add_argument("--max-restarts", type=int, default=3,
                    help="the supervisor's restart budget")
    ap.add_argument("--inject-faults", default="",
                    help="chaos schedule 'kind@step[:mode[:count]],...' "
                         "(kinds: nan_grad ckpt_write ckpt_corrupt data "
                         "preempt; '@rand' draws a seeded step) or 'seeded'")
    for flag, (kw, _) in NOT_YET_PORTED.items():
        ap.add_argument(flag, default=None, help="not yet ported", **kw)
    args = ap.parse_args(argv)
    if args.prefetch_depth < 1:
        raise SystemExit(f"[train] --prefetch-depth must be >= 1: "
                         f"{args.prefetch_depth}")
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
    if args.supervise:
        # the supervisor only starts children; it never touches the card
        raise SystemExit(supervise(child_argv(argv),
                                   max_restarts=args.max_restarts,
                                   seed=args.seed))
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
    try:
        return _run(args, world)
    finally:
        plan = _faults.active()
        if plan is not None:
            plan.uninstall()


def _run(args, world):
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
                             eval_size=args.eval_size or None,
                             shard_dir=args.shard_dir or None)
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
        seed=args.seed, ckpt_every=args.ckpt_every,
        ckpt_async=not args.ckpt_sync, ckpt_keep_last=args.keep_last,
        guard_anomalies=not args.no_guard,
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
        backing = "shards" if args.shard_dir else \
            "procedural" if source.procedural else "disk"
        say(f"[train] dataset={source.name} {backing} "
            f"train={source.train_size} eval={source.eval_size}")
        pipe = DataPipeline(global_batch=args.batch, source=source,
                            seed=args.seed)
    else:
        pipe = DataPipeline(global_batch=args.batch, dataset=spec,
                            resolution=cfg.image_size, seed=args.seed)

    if args.inject_faults:
        # every rank installs the same plan and reads the log; rank 0
        # alone appends to it
        kw = {"log_path": os.path.join(args.ckpt_dir, "faults.jsonl")
              if args.ckpt_dir else None, "writer": lead}
        plan = FaultPlan.seeded(args.seed, max_step=args.steps, **kw) \
            if args.inject_faults == "seeded" else FaultPlan.parse(
                args.inject_faults, seed=args.seed, max_step=args.steps, **kw)
        plan.install()
        if world is not None:
            world.any(False)    # no rank fires before every rank has read
        say(f"[faults] installed {plan!r}"
            + (f" log={kw['log_path']}" if kw["log_path"] else ""))

    saved_step = -1     # the newest step this run wrote or restored
    if args.resume and args.ckpt_dir and latest_step(args.ckpt_dir) >= 0:
        try:
            state = trainer.restore_state(
                args.ckpt_dir, state=state,
                step=args.resume_step if args.resume_step >= 0 else None)
            saved_step = state.step
            say(f"[train] resumed step={state.step} cursor=(epoch "
                f"{state.epoch}, batch {state.batch_index}) from "
                f"{args.ckpt_dir}")
        except FileNotFoundError as e:
            say(f"[train] --resume: no checkpoint survives verification "
                f"({e}); starting fresh")
    elif args.resume:
        say(f"[train] --resume: no checkpoint in "
            f"{args.ckpt_dir or '<unset>'}; starting fresh")
    start_step = state.step
    end_step = min(args.steps, args.stop_after) if args.stop_after \
        else args.steps

    hist = []
    t0 = time.time()
    ev = Evaluator(cfg, model, ecfg=ecfg, preproc=trainer.preproc,
                   device=device, world=world, gather=trainer.forward_gather) \
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

    def save(step):
        tree = trainer.checkpoint_tree(state)
        if saver is not None:
            return saver.save(args.ckpt_dir, step, tree)
        return save_checkpoint(args.ckpt_dir, step, tree,
                               keep_last_k=ecfg.ckpt_keep_last)

    saver = trainer.make_checkpointer() \
        if args.ckpt_dir and ecfg.ckpt_async else None
    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM,
                                                 signal.SIGINT)}
    preempted = install_preemption_handler()
    prefetcher = None

    def fetch():
        """-> (device batch, the cursor after it): from the prefetcher, or
        under --no-prefetch built at the state's cursor and copied here."""
        if prefetcher is not None:
            _, batch, nxt = next(prefetcher)
            return batch, nxt
        e, i = state.epoch, state.batch_index
        return to_device(pipe.batch_at(e, i), device), pipe.next_cursor(e, i)

    try:
        if not args.no_prefetch and start_step < end_step:
            prefetcher = pipe.prefetch(state.epoch, state.batch_index,
                                       device=device,
                                       depth=args.prefetch_depth)
        for step in range(start_step, end_step):
            batch, nxt = fetch()
            # a guard-skipped step leaves the state as it was: retry the
            # SAME cursor batch (a planned NaN poisons it once), and
            # escalate after guard_max_skips skips in a row
            skips = 0
            while True:
                fed = _faults.poison_batch(batch, step,
                                           resolution=cfg.image_size)
                state, metrics = trainer.train_step(state, fed)
                if not ecfg.guard_anomalies or metrics["step_ok"]:
                    break
                skips += 1
                say(f"[guard] step {step}: non-finite loss/grad-norm — "
                    f"update skipped ({skips}/{ecfg.guard_max_skips})",
                    flush=True)
                if skips >= ecfg.guard_max_skips:
                    raise RuntimeError(
                        f"anomaly guard: {skips} consecutive skipped "
                        f"updates at step {step}; aborting (persistent "
                        f"data/numerics problem)")
            state = state.replace(epoch=nxt[0], batch_index=nxt[1])
            if step % args.log_every == 0 or step == end_step - 1:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = step
                m["wall_s"] = round(time.time() - t0, 2)
                hist.append(m)
                say(f"[train] step {step:5d} loss={m['loss']:.4f} "
                    f"gnorm={m['grad_norm']:.3f} lr={m['lr']:.2e} "
                    f"({m['wall_s']:.1f}s)")
            if args.ckpt_dir and ecfg.ckpt_every and \
                    (step + 1) % ecfg.ckpt_every == 0:
                save(step + 1)
                saved_step = step + 1
            if args.eval_every and (step + 1) % args.eval_every == 0:
                run_eval(step + 1)
            # a planned preemption signals this process here; a real
            # SIGTERM/SIGINT lands in the same flag. The ranks agree on the
            # step (any rank's flag stops all), so every rank takes part in
            # the emergency save
            _faults.preempt_due(step)
            stop = preempted.triggered
            if world is not None:
                stop = world.any(stop)
            if stop:
                if saver is not None:
                    saver.wait()        # drain before the emergency save
                if args.ckpt_dir and saved_step != state.step:
                    path = trainer.save_state(args.ckpt_dir, state)
                    say(f"[train] preempted (signal {preempted.signum}) — "
                        f"emergency checkpoint -> {path}", flush=True)
                elif args.ckpt_dir:
                    say(f"[train] preempted (signal {preempted.signum}) — "
                        f"step {state.step} is saved already", flush=True)
                # EX_TEMPFAIL: the supervisor relaunches with --resume
                raise SystemExit(RESTARTABLE_EXIT)

        if args.eval_every and state.step != last_eval_step:
            run_eval(state.step)            # final-state eval
        if saver is not None:
            saver.wait()                    # drain in-flight async saves
        if args.ckpt_dir and saved_step != state.step:
            path = save_checkpoint(args.ckpt_dir, state.step,
                                   trainer.checkpoint_tree(state),
                                   keep_last_k=ecfg.ckpt_keep_last)
            say(f"[train] checkpoint -> {path}")
    finally:
        if prefetcher is not None:
            prefetcher.close()
        if saver is not None:
            saver.close()
        for s, h in handlers.items():
            signal.signal(s, h)
    if args.metrics_out and lead:
        with open(args.metrics_out, "w") as f:
            json.dump(hist, f, indent=1)
    tr = [h for h in hist if "loss" in h]
    if len(tr) >= 2 and not (tr[-1]["loss"] < tr[0]["loss"]):
        say("[train] WARNING: loss did not decrease")
    final = f"final loss {tr[-1]['loss']:.4f}" if tr \
        else f"no steps run (start={start_step}, end={end_step})"
    say(f"[train] done in {time.time() - t0:.1f}s; {final}")
    return hist


if __name__ == "__main__":
    main()
