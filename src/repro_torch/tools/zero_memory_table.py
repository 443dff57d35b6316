"""The paper's §V future work, "evaluate each ZeRO stage to measure memory
savings and overhead" (the counterpart of ``scripts/zero_memory_table.py``).

By default the dry run's table per ZeRO stage 0-3 for one pair on the
production layout (16 data x 16 model, on ``meta``): a rank's argument
bytes (params, optimizer state, batch), its counted peak, its collective
bytes a step and the bound step time (modelled on H100 SXM5 datasheet
constants, not measured); each row is also appended to
``results/torch/zero_memory.jsonl``:

    PYTHONPATH=src python -m repro_torch.tools.zero_memory_table \\
        [--arch qwen2.5-14b] [--shape train_4k]

``--ckpt-sizes`` measures the elastic checkpoint's footprint instead: 8
spawned CPU ranks (gloo) each train one step of the smoke ViT at each
stage and save the state shard-locally; the table gives the logical and
saved bytes (equal: no replica written twice, no shard missing), the most
any one rank owns, and the most any rank's same-layout restore reads.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

from repro_torch.tools import RESULTS

STAGES = (0, 1, 2, 3)


def _ckpt_rank(world, root):
    """One rank: a step and a save of the smoke ViT at every stage; rank 0
    returns the byte accounting of each."""
    import numpy as np
    import torch

    from repro_torch.checkpoint import checkpoint_size_report, \
        per_process_restore_bytes
    from repro_torch.configs import EngineConfig, get_smoke_config
    from repro_torch.core.engine import Trainer
    from repro_torch.models.transformer import init_params

    cfg = get_smoke_config("vit-b16").replace(dtype="float32")
    rng = np.random.default_rng(0)
    batch = {"images": torch.from_numpy(rng.standard_normal(
                 (8, cfg.image_size, cfg.image_size, 3), dtype=np.float32)),
             "labels": torch.from_numpy(rng.integers(
                 0, cfg.num_classes, 8, dtype=np.int64))}
    out = {}
    for zero in STAGES:
        trainer = Trainer(cfg, EngineConfig(
            train_batch_size=8, zero_stage=zero, total_steps=10,
            warmup_steps=1), device="cpu", world=world)
        state = trainer.init_state(init_params(cfg, seed=0, device="cpu"))
        state, _ = trainer.train_step(state, batch)
        d = os.path.join(root, f"zero{zero}")
        trainer.save_state(d, state)
        if world.rank == 0:
            rep = checkpoint_size_report(d, state.step)
            restore = per_process_restore_bytes(d, state.step)
            out[zero] = {"zero": zero, "logical": rep["logical_bytes"],
                         "saved": rep["saved_bytes"],
                         "max_rank": max(rep["per_process_bytes"].values()),
                         "ranks": len(rep["per_process_bytes"]),
                         "restore_rank": max(restore.values())}
    return out


def ckpt_sizes(ranks: int = 8) -> list:
    from repro_torch.core import distributed

    root = tempfile.mkdtemp(prefix="repro_torch_ckpt_sizes_")
    try:
        recs = distributed.spawn(_ckpt_rank, ranks, root, device="cpu")[0]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"Checkpoint size per ZeRO stage: vit-b16 smoke state, {ranks} "
          f"CPU ranks (shard-local elastic v2 format)\n")
    print(f"{'stage':>6s} {'logical MiB':>12s} {'saved MiB':>10s} "
          f"{'max/rank MiB':>13s} {'owning ranks':>13s} "
          f"{'restore/rank MiB':>17s}")
    mib = 2 ** 20
    rows = []
    for zero in STAGES:
        r = recs[zero]
        print(f"{zero:6d} {r['logical'] / mib:12.2f} {r['saved'] / mib:10.2f}"
              f" {r['max_rank'] / mib:13.2f} {r['ranks']:13d} "
              f"{r['restore_rank'] / mib:17.2f}")
        if r["saved"] != r["logical"]:
            raise SystemExit(f"stage {zero}: saved {r['saved']} != logical "
                             f"{r['logical']} (a replica written twice or a "
                             f"shard missing)")
        rows.append(r)
    return rows


def dryrun_table(arch: str, shape: str, out=None) -> list:
    from repro_torch.launch.dryrun import run_pair

    print(f"ZeRO memory table: {arch} x {shape}, 256 ranks (16 data x 16 "
          f"model), counted on meta; times modelled on H100 SXM5 "
          f"datasheet constants, not measured\n")
    print(f"{'stage':>6s} {'args GiB/dev':>14s} {'peak GiB/dev':>14s} "
          f"{'coll GB/step':>14s} {'bound s':>10s}")
    rows = []
    for stage in STAGES:
        try:
            rec = run_pair(arch, shape, zero=stage, verbose=False,
                           tag=f"zero{stage}")
        except Exception as e:  # noqa: BLE001 - a stage may be refused
            print(f"{stage:6d}  FAIL: {type(e).__name__}: {str(e)[:70]}")
            continue
        if rec["status"] != "ok":
            print(f"{stage:6d}  {rec['status']}: {rec.get('reason', '')[:70]}")
            continue
        coll = sum(rec["collectives"].values()) / 1e9
        print(f"{stage:6d} {rec['argument_bytes_per_dev'] / 2 ** 30:14.2f} "
              f"{rec['peak_bytes_per_dev'] / 2 ** 30:14.2f} {coll:14.1f} "
              f"{rec['roofline']['bound_step_s']:10.3f}")
        rows.append(rec)
        if out:
            with open(out, "a") as f:
                f.write(json.dumps(rec) + "\n")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2.5-14b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--results", default=RESULTS)
    ap.add_argument("--ckpt-sizes", action="store_true",
                    help="measure shard-local checkpoint bytes per ZeRO "
                         "stage instead of the dry run's table")
    args = ap.parse_args(argv)
    if args.ckpt_sizes:
        ckpt_sizes()
    else:
        os.makedirs(args.results, exist_ok=True)
        dryrun_table(args.arch, args.shape,
                     os.path.join(args.results, "zero_memory.jsonl"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
