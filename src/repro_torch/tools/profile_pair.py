"""The dry run's profiler: the aten ops (by the ``repro_torch`` function
that ran them) and kernels with the most bytes or FLOPs in one pair's
counted step, trip counts applied (the counterpart of
``scripts/profile_pair.py``):

    PYTHONPATH=src python -m repro_torch.tools.profile_pair \\
        --arch qwen2.5-14b --shape train_4k [--by flops] [--n 25] \\
        [--embed dmodel]
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.configs.base import EMBED_SHARDING
from repro_torch.launch.dryrun import count_pair


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--by", default="bytes", choices=["bytes", "flops"])
    ap.add_argument("--n", type=int, default=25)
    ap.add_argument("--zero", type=int, default=None)
    ap.add_argument("--seq-parallel", default=None)
    ap.add_argument("--moe-impl", default=None)
    ap.add_argument("--bf16-gather", action="store_true")
    ap.add_argument("--use-pallas", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--embed", default=None, choices=EMBED_SHARDING)
    args = ap.parse_args(argv)
    counter = count_pair(args.arch, args.shape, multi_pod=args.multi_pod,
                         where=True, zero=args.zero,
                         seq_parallel=args.seq_parallel,
                         moe_impl=args.moe_impl,
                         bf16_gather=args.bf16_gather,
                         use_pallas=args.use_pallas,
                         embed=args.embed)[0]
    t = counter.totals
    print(f"flops/dev={t.flops:.3e}  bytes/dev={t.hbm_bytes:.3e}  coll="
          f"{ {k: f'{v / 1e9:.2f}GB' for k, v in t.coll.items()} }")
    print(f"\ntop {args.n} by {args.by}:")
    for score, calls, op in counter.top_contributors(args.n, args.by):
        print(f"  {score / 1e9:10.2f}G x{calls:8.0f}  {op[:120]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
