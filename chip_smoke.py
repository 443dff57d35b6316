#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: builds the CUDA kernels
from this checkout, holds each against its plain PyTorch version, drives
the port's main path at full width through its CLI, and checks the result.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no ``ok`` line):

1. card: a CUDA device must be present; prints its name and power limit.
2. build: compiles every kernel (``kernels/build.py``), timed.
3. K1 against ``ref_attention`` on the card, at the ViT-B/16 eval shape
   (bf16 and fp32), the smoke shape, ragged S, causal, GQA and windowed
   cases; then times the kernel, the plain version and PyTorch's
   ``scaled_dot_product_attention`` (a yardstick the port never calls) at
   the ViT-B/16 shape, beside the card's bound for the same work.
4. the slice: ``repro_torch.launch.train --arch vit-b16 --steps 0
   --eval-every 1 --eval-batch 128`` on procedural CIFAR-10 (500 examples,
   4 batches, the last mask-padded) with the launch counter reset just
   before and read just after (12 layers x 4 batches = 48 launches); then
   the same params and batches through the naive attention path for the
   logits' agreement, and the smoke config through the CLI as well.

The last lines are one JSON object per kernel run, the card's
``nvidia-smi`` name and power limit, and the ``ok`` line.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published dense peaks (NVIDIA data sheets) by card: HBM bytes/s and bf16
# tensor-core FLOP/s. The SXM part is the H100 80GB HBM3.
PEAKS = {
    "H100 PCIe": (2.0e12, 756e12),
    "H100 NVL": (3.9e12, 835e12),
    "H100": (3.35e12, 989e12),
    "H200": (4.8e12, 989e12),
}
VIT_SHAPE = (128, 12, 12, 197, 197, 64)      # B, H, KH, S, T, D
TOL_OUT = {"float32": 1e-4, "bfloat16": 2e-2}  # tests/test_flash_grad.py
TOL_LSE = 1e-4
TOL_LOGITS = {"float32": 1e-3, "bfloat16": 0.1}
EVAL_BATCH = 128


def fail(msg):
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode:
        fail(f"nvidia-smi exit {r.returncode}: {r.stderr}")
    return r.stdout.strip().splitlines()[0]


def peaks(name):
    for key, val in PEAKS.items():
        if key in name:
            return key, val
    fail(f"no peak rates known for card {name!r}")


def time_ms(fn, warmup=5, reps=25):
    """Median CUDA-event time of ``fn`` over ``reps`` runs after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_card():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    smi = smi_line()
    print(f"[card] {smi}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; devices {torch.cuda.device_count()}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build():
    from repro_torch.kernels import build
    t0 = time.time()
    logs = build.build()
    print(f"[build] {sorted(logs) or 'cached'} in {time.time() - t0:.2f}s",
          flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")


def phase_k1(card):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.ref import ref_attention

    gen = torch.Generator(device="cuda").manual_seed(0)

    def inputs(b, h, kh, s, t, d, dtype):
        mk = lambda *shape: torch.randn(shape, device="cuda",  # noqa: E731
                                        generator=gen).to(dtype)
        return mk(b, h, s, d), mk(b, kh, t, d), mk(b, kh, t, d)

    cases = [
        ("vit-b16", VIT_SHAPE, torch.bfloat16, False, 0),
        ("vit-b16", VIT_SHAPE, torch.float32, False, 0),
        ("smoke", (16, 4, 4, 65, 65, 32), torch.bfloat16, False, 0),
        ("smoke", (16, 4, 4, 65, 65, 32), torch.float32, False, 0),
        ("S=1", (4, 4, 4, 1, 1, 64), torch.float32, False, 0),
        ("S=63", (4, 4, 4, 63, 63, 64), torch.float32, False, 0),
        ("S=130", (4, 4, 4, 130, 130, 64), torch.float32, False, 0),
        ("causal", (4, 4, 4, 130, 130, 64), torch.float32, True, 0),
        ("gqa", (4, 8, 2, 197, 197, 64), torch.float32, False, 0),
        ("window", (4, 4, 4, 130, 130, 64), torch.float32, True, 40),
        ("D=128", (4, 4, 4, 130, 130, 128), torch.bfloat16, False, 0),
    ]
    vit_err = None
    for label, shape, dtype, causal, window in cases:
        q, k, v = inputs(*shape, dtype)
        out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        ref_out, ref_lse = ref_attention(q, k, v, causal=causal,
                                         window=window)
        d_out = (out.float() - ref_out.float()).abs().max().item()
        d_lse = (lse - ref_lse).abs().max().item()
        dname = str(dtype).removeprefix("torch.")
        tol = TOL_OUT[dname]
        ok = d_out <= tol and d_lse <= TOL_LSE and \
            bool(torch.isfinite(out).all())
        print(f"[k1] {label:8s} {shape} {dname:8s} causal={causal} "
              f"window={window}: max|dout|={d_out:.3e} (tol {tol}) "
              f"max|dlse|={d_lse:.3e} (tol {TOL_LSE}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"K1 disagrees with ref_attention on {label} {dname}")
        if label == "vit-b16" and dtype == torch.bfloat16:
            vit_err = d_out

    b, h, kh, s, t, d = VIT_SHAPE
    q, k, v = inputs(*VIT_SHAPE, torch.bfloat16)
    ms = time_ms(lambda: flash_attention_fwd(q, k, v, causal=False))
    plain_ms = time_ms(lambda: ref_attention(q, k, v, causal=False))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v))
    n_bytes = (q.numel() + k.numel() + v.numel() + q.numel()) \
        * q.element_size() + b * h * s * 4          # q, k, v, o, fp32 lse
    flops = 4 * b * h * s * t * d                   # QK^T and PV
    part, (bw, peak) = peaks(card)
    t_bytes, t_ops = n_bytes / bw * 1e3, flops / peak * 1e3
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    print(f"[k1] timing at {VIT_SHAPE} bf16 on {card}: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, sdpa (yardstick) {library_ms:.4f} ms; "
          f"bound {bound_ms:.4f} ms by {bound_by} ({n_bytes / 1e6:.1f} MB "
          f"at {bw / 1e12:.2f} TB/s = {t_bytes:.4f} ms; {flops / 1e9:.2f} "
          f"GFLOP at {peak / 1e12:.0f} TFLOP/s bf16 = {t_ops:.4f} ms; "
          f"peaks of the {part} data sheet)", flush=True)
    return {"name": "flash_fwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_fwd.cu",
            "replaces": "src/repro/kernels/flash_attention.py:239",
            "launches": None, "max_abs_err": vit_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def run_cli(argv, expect_launches, label):
    """Drive the CLI with the K1 counter reset just before and read just
    after; returns (launches, metrics rows)."""
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.launch.train import main as cli
    flash_attention_fwd.launches = 0
    hist = cli(argv)
    launches = flash_attention_fwd.launches
    print(f"[slice] {label}: flash_fwd launches {launches} "
          f"(expected {expect_launches})", flush=True)
    if launches != expect_launches:
        fail(f"{label}: K1 launched {launches} times, not {expect_launches}")
    if len(hist) != 1 or hist[0]["eval_count"] != 500:
        fail(f"{label}: unexpected eval rows {hist}")
    return launches, hist[0]


def eval_rate(ev, source):
    """Images/s of one warm eval pass over the whole split (host clock
    around work that ends in a synchronize)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    em = ev.evaluate(source.eval_batches(EVAL_BATCH))
    torch.cuda.synchronize()
    return em["eval_count"] / (time.perf_counter() - t0)


def compare_paths(cfg_name, dtype, n_batches):
    """Logits of the kernel path against the naive ``sdpa`` path on the
    same params and batches; returns (max |dlogits|, top-1 agreement,
    images/s of the kernel path's and the naive path's eval loops, timed
    kernel, naive, naive, kernel and averaged)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.engine import Evaluator
    from repro_torch.data.datasets import CIFARSource
    from repro_torch.models.transformer import ViT, init_params

    cfg = get_config(cfg_name).replace(dtype=dtype)
    source = CIFARSource("cifar10", seed=0, resolution=cfg.image_size)
    params = init_params(cfg, seed=0, device="cuda")
    ev_k = Evaluator(cfg, ViT(cfg, params), preproc=source.preproc)
    ev_n = Evaluator(cfg.replace(use_kernels=False), ViT(cfg, params),
                     preproc=source.preproc)
    d_max, agree, n = 0.0, 0, 0
    for i, host in enumerate(source.eval_batches(EVAL_BATCH)):
        if i == n_batches:
            break
        batch = ev_k.to_device(host)
        lk, ln = ev_k.logits(batch), ev_n.logits(batch)
        if lk.shape != (EVAL_BATCH, cfg.num_classes) or \
                not bool(torch.isfinite(lk).all()):
            fail(f"bad logits {tuple(lk.shape)} / non-finite")
        real = batch["mask"] > 0
        d_max = max(d_max, (lk.float() - ln.float())[real].abs().max().item())
        agree += int((lk.argmax(-1) == ln.argmax(-1))[real].sum())
        n += int(real.sum())
    rates = [eval_rate(ev, source) for ev in (ev_k, ev_n, ev_n, ev_k)]
    return d_max, agree / n, (rates[0] + rates[3]) / 2, \
        (rates[1] + rates[2]) / 2


def phase_slice():
    base = ["--steps", "0", "--eval-every", "1", "--eval-batch",
            str(EVAL_BATCH)]
    launches, row = run_cli(["--arch", "vit-b16"] + base, 12 * 4,
                            "vit-b16 eval")
    print(f"[slice] vit-b16 counts top1={row['eval_top1_count']} "
          f"top5={row['eval_top5_count']} count={row['eval_count']} "
          f"loss={row['eval_loss']:.4f} (cold eval {row['wall_s']} s)",
          flush=True)
    for dtype, n_batches in (("bfloat16", 4), ("float32", 1)):
        d, agree, ips_k, ips_n = compare_paths("vit-b16", dtype, n_batches)
        tol = TOL_LOGITS[dtype]
        print(f"[slice] vit-b16 {dtype} kernel vs naive over {n_batches} "
              f"batch(es): max|dlogits|={d:.3e} (tol {tol}), top-1 "
              f"agreement {agree:.4f}; warm eval of 500 images: kernel "
              f"path {ips_k:.1f} images/s, naive path {ips_n:.1f} "
              f"images/s", flush=True)
        if not d <= tol:
            fail(f"vit-b16 {dtype}: kernel and naive logits differ by {d}")
    run_cli(["--arch", "vit-b16", "--smoke"] + base, 2 * 4, "smoke eval")
    return launches


def main():
    card = phase_card()
    sys.path.insert(0, str(ROOT / "src"))
    phase_build()
    k1 = phase_k1(card.split(",")[0])
    k1["launches"] = phase_slice()
    print(json.dumps({"kernels": [k1]}))
    print(card)
    import torch
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
