"""Render the dry run's tables (markdown) from ``results/torch/*.jsonl``:
the single-layout roofline table, then the multi-pod one where a file
holds it. Every time in them is modelled on ``core/comm_model.py``'s
``H100_SXM`` datasheet constants, not measured:

    PYTHONPATH=src python -m repro_torch.tools.render_experiments \\
        [--results DIR] [--single FILE] [--multi FILE]
"""
from __future__ import annotations

import argparse
import os
import sys

from repro_torch.tools import RESULTS, load


def fmt_bytes(b):
    return f"{b / 2 ** 30:.2f}"


def roofline_table(recs):
    hdr = ("| arch | shape | params | mem/dev GiB | compute s | memory s | "
           "collective s | dominant | MODEL/counted flops | "
           "coll GB (ar/ag/rs/a2a/cp) | count s |")
    rows = [hdr, "|" + "---|" * 11]
    for (arch, shape), r in sorted(recs.items()):
        if r["status"] == "skip":
            rows.append(f"| {arch} | {shape} | — | — | — | — | — | SKIP | "
                        f"— | {r['reason'][:48]} | — |")
            continue
        if r["status"] != "ok":
            rows.append(f"| {arch} | {shape} | — | — | — | — | — | FAIL | "
                        f"— | {r.get('error', '')[:48]} | — |")
            continue
        rl, c = r["roofline"], r["collectives"]
        coll = "/".join(f"{c[k] / 1e9:.1f}" for k in (
            "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
            "collective-permute"))
        rows.append(
            f"| {arch} | {shape} | {r['params'] / 1e9:.1f}B "
            f"| {fmt_bytes(r['peak_bytes_per_dev'])} "
            f"| {rl['compute_s']:.3f} | {rl['memory_s']:.3f} "
            f"| {rl['collective_s']:.3f} | **{rl['dominant'][:-2]}** "
            f"| {rl['useful_flops_frac']:.2f} | {coll} "
            f"| {r.get('count_s', '—')} |")
    return "\n".join(rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--results", default=RESULTS)
    ap.add_argument("--single", default="baseline_singlepod.jsonl")
    ap.add_argument("--multi", default="baseline_multipod.jsonl")
    args = ap.parse_args(argv)
    single = load(os.path.join(args.results, args.single))
    multi = load(os.path.join(args.results, args.multi))
    print("### Single layout (16 data x 16 model = 256 ranks), modelled on "
          "H100 SXM5 700 W datasheet constants, not measured\n")
    print(roofline_table(single))
    if multi:
        n_ok = sum(r["status"] == "ok" for r in multi.values())
        n_skip = sum(r["status"] == "skip" for r in multi.values())
        print(f"\n### Multi-pod (32 data x 16 model = 512 ranks): {n_ok} "
              f"pairs counted, {n_skip} skips, "
              f"{len(multi) - n_ok - n_skip} failures\n")
        print(roofline_table(multi))
    return 0


if __name__ == "__main__":
    sys.exit(main())
