#!/usr/bin/env python3
"""Where K6 and K7 (the WKV6 forward and backward, ``csrc/wkv6.cu``) spend
their time on the card: each whole kernel beside variants of the source
with one launch, or one phase of the chunk launch, taken out, timed in
turns at the RWKV6 slice's shape (B 4, S 1024, H 64, P 64, chunk 32; bf16
r/k/v, fp32 wlog); K6 with states, as the training path runs it.

    python3 scripts/wkv6_bwd_phases.py [k6|k7]

(both kernels without an argument). Each variant is a copy of ``csrc/``
under the git-ignored ``build/`` with the parts of K6 or K7 that
``wkv6.cu`` tags ``// phase: NAME`` taken out: a tagged loop runs no times,
a tagged launch is dropped. The variants are built with the same flags, one
``nvcc`` each, all started together, and the wrapper is pointed at each in
turn through ``build.CSRC``, in the order A, B, ..., B, A. A variant
computes wrong outputs: it is timed, never checked. A tag that names no
line of the source stops the script. Needs one CUDA card and nvcc.
"""
from __future__ import annotations

import re
import shutil
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

TAG = re.compile(r"^\s*// phase: ([\w-]+)\s*$")
CHUNK = ["scan-launch"]             # every chunk-launch variant drops the scan
VARIANTS = {                        # K7
    "whole backward": [],
    "scan launch only": ["chunk-launch"],
    "chunk launch only": CHUNK,
    "chunk launch, no pair loops (dr_att, dk_att)": CHUNK + ["pair-loops"],
    "chunk launch, no att/dA pass": CHUNK + ["att-pass"],
    "chunk launch, no products (dO S^T, v G^T, kadv G)":
        CHUNK + ["products"],
    "chunk launch, none of the three":
        CHUNK + ["pair-loops", "att-pass", "products"],
}
FWD_CHUNK = ["fwd-scan-launch"]
FWD_VARIANTS = {                    # K6
    "whole forward": [],
    "scan launch only": ["fwd-chunk-launch"],
    "chunk launch only": FWD_CHUNK,
    "chunk launch, no att pass": FWD_CHUNK + ["fwd-att-pass"],
    "chunk launch, no products ((r e^lprev) S_c, att v)":
        FWD_CHUNK + ["fwd-products"],
    "chunk launch, neither": FWD_CHUNK + ["fwd-att-pass", "fwd-products"],
}


def without(source, tags):
    """``source`` with the code line after each ``// phase: TAG`` line of
    ``tags`` (preprocessor lines skipped) taken out: a ``for`` header's
    condition becomes ``false``, any other line is dropped."""
    lines, found, pending = source.split("\n"), set(), None
    for i, line in enumerate(lines):
        tag = TAG.match(line)
        if tag:
            pending = tag.group(1) if tag.group(1) in tags else None
            found.add(tag.group(1))
        elif pending and not line.lstrip().startswith("#"):
            if line.lstrip().startswith("for ("):
                init, _, step = line.split(";", 2)
                lines[i] = f"{init}; false;{step}"
            else:
                lines[i] = ""
            pending = None
    missing = set(tags) - found
    if missing:
        cs.fail(f"no line of wkv6.cu is tagged {sorted(missing)}")
    return "\n".join(lines)


def variant_dir(csrc, tags):
    """A copy of ``csrc`` under ``build/`` without the ``tags`` parts of
    ``wkv6.cu``, named by the tags."""
    d = ROOT / "build" / "wkv6_phases" / "".join(
        ch if ch.isalnum() else "_" for ch in " ".join(tags))
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(csrc, d)
    (d / "wkv6.cu").write_text(without((d / "wkv6.cu").read_text(), tags))
    return d


def main():
    which = sys.argv[1:] or ["k6", "k7"]
    card = cs.phase_card().split(",")[0]
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import wkv6 as wk

    kernels = {"k6": ("K6", FWD_VARIANTS), "k7": ("K7", VARIANTS)}
    real = build.CSRC
    dirs = {}
    for key in which:
        for name, tags in kernels[key][1].items():
            dirs[key, name] = variant_dir(real, tags) if tags else real
    with ThreadPoolExecutor(len(set(dirs.values()))) as pool:
        for got in [pool.submit(build.build, ["wkv6"], d)
                    for d in set(dirs.values())]:
            got.result()

    gen = torch.Generator(device="cuda").manual_seed(5)
    b, s, h, p, c = cs.WKV_SHAPE

    def randn(*shape):
        return torch.randn(shape, device="cuda", generator=gen)
    r, k, v = (randn(b, s, h, p).bfloat16() for _ in range(3))
    w = -torch.exp(randn(b, s, h, p) - 0.5)
    u, s0 = 0.3 * randn(h, p), 0.1 * randn(b, h, p, p)
    do, dse = randn(b, s, h, p), randn(b, h, p, p)
    _, _, st = wk.wkv6_fwd(r, k, v, w, u, s0, chunk=c, with_states=True)
    calls = {"k6": lambda: wk.wkv6_fwd(r, k, v, w, u, s0, chunk=c,
                                       with_states=True),
             "k7": lambda: wk.wkv6_bwd(r, k, v, w, u, st, do, dse, chunk=c)}

    for key in which:
        tag, variants = kernels[key]
        times = {name: [] for name in variants}
        for name in list(variants) + list(variants)[::-1]:
            build.CSRC = dirs[key, name]
            times[name].append(cs.time_ms(calls[key]))
        build.CSRC = real
        print(f"[{key} phases] {tag} at {cs.WKV_SHAPE} bf16 r/k/v, fp32 wlog "
              f"on {card} (median CUDA-event ms of each turn):", flush=True)
        full = times["chunk launch only"]
        for name, ts in times.items():
            mean = sum(ts) / len(ts)
            extra = ""
            if name.startswith("chunk launch, "):
                saved = sum(full) / len(full) - mean
                extra = f" (the removed part: {saved:.4f} ms)"
            print(f"[{key} phases] {name}: {[round(t, 4) for t in ts]} ms"
                  f"{extra}", flush=True)


if __name__ == "__main__":
    main()
