"""The roofline report: one CSV row ``name,us_per_call,derived`` a pair of
a dry run's JSONL (``python -m repro_torch.launch.dryrun --all --out
results/torch/baseline_singlepod.jsonl``), the bound step time and its
three terms (modelled on ``core/comm_model.py``'s ``H100_SXM`` datasheet
constants, not measured), then a summary row:

    PYTHONPATH=src python -m repro_torch.tools.roofline_report \\
        [--results DIR] [FILE ...]
"""
from __future__ import annotations

import argparse
import os
import sys

from repro_torch.tools import RESULTS, load


def emit(rows, name, us, derived):
    rows.append(f"{name},{us:.2f},{derived}")


def roofline_rows(rows, path, prefix="roofline"):
    n_ok = n_skip = 0
    for (arch, shape), r in sorted(load(path).items()):
        if r["status"] == "skip":
            n_skip += 1
            continue
        if r["status"] != "ok":
            emit(rows, f"{prefix}_{arch}_{shape}", 0.0,
                 f"FAIL:{r.get('error', '?')[:60]}")
            continue
        n_ok += 1
        rl = r["roofline"]
        emit(rows, f"{prefix}_{arch}_{shape}",
             rl["bound_step_s"] * 1e6,
             f"dom={rl['dominant'][:-2]};compute={rl['compute_s']*1e3:.1f}ms"
             f";mem={rl['memory_s']*1e3:.1f}ms"
             f";coll={rl['collective_s']*1e3:.1f}ms"
             f";useful={min(rl['useful_flops_frac'], 9.99):.2f}"
             f";mem_dev={r['peak_bytes_per_dev']/2**30:.1f}GiB")
    emit(rows, f"{prefix}_summary", 0.0, f"ok={n_ok};skip={n_skip}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--results", default=RESULTS)
    ap.add_argument("files", nargs="*",
                    default=["baseline_singlepod.jsonl"])
    args = ap.parse_args(argv)
    rows = ["name,us_per_call,derived"]
    for i, name in enumerate(args.files):
        roofline_rows(rows, os.path.join(args.results, name),
                      "roofline" if i == 0 else
                      f"roofline_{os.path.splitext(name)[0]}")
    print("\n".join(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
