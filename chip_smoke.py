#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: builds the CUDA kernels
from this checkout, holds each against its plain PyTorch version, drives
the port's main paths (eval, then training) at full width through its CLI,
and checks the results.

    python3 chip_smoke.py [--profile]

Phases (any failure exits non-zero and prints no ``ok`` line):

1. card: a CUDA device must be present; prints its name and power limit.
2. build: compiles every kernel (``kernels/build.py``), timed.
3. K1 against ``ref_attention`` on the card, at the ViT-B/16 eval shape
   (bf16 and fp32), the smoke shape, ragged S, causal, GQA and windowed
   cases; then times the kernel, the plain version and PyTorch's
   ``scaled_dot_product_attention`` (a yardstick the port never calls) at
   the ViT-B/16 shape, beside the card's bound for the same work.
4. K2 and K3 against ``ref_attention_bwd`` at the same cases, with the
   ViT-B/16 training micro-shape (B 64) in place of the eval shape and the
   model's (B,S,H,D) layout there; ``torch.autograd.grad`` through
   ``flash_mha`` against the plain backward; then K2, K3, the plain
   backward and SDPA's backward (its forward+backward less its forward,
   the one yardstick both kernels share) timed at the micro-shape.
5. the eval slice: ``repro_torch.launch.train --arch vit-b16 --steps 0
   --eval-every 1 --eval-batch 128`` on procedural CIFAR-10 (500 examples,
   4 batches, the last mask-padded) with the launch counters reset just
   before and read just after (12 layers x 4 batches = 48 K1 launches);
   then the same params and batches through the naive attention path for
   the logits' agreement, and the smoke config through the CLI as well.
6. the training slice: ``--arch vit-b16 --steps 10 --batch 128 --accum 2
   --eval-every 10 --eval-batch 128`` in bf16 with the counters reset
   just before and read just after (K1 10 x 2 x 12 + 48 = 288, K2 and K3
   240 each); every loss and grad-norm finite and ``step_ok`` 1; then the
   loss and all parameter gradients of one full-width microbatch through
   the kernel and the naive path (fp32 within 2e-4; bf16 cosine >= 0.99),
   and warm training images/s of both paths. ``--profile`` adds a
   ``torch.profiler`` table of one warm training step.

The last lines are one JSON object for the kernels, the card's
``nvidia-smi`` name and power limit, and the ``ok`` line.
"""
from __future__ import annotations

import json
import re
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
TRAIN_SHAPE = (64, 12, 12, 197, 197, 64)     # batch 128 / accum 2
TOL_OUT = {"float32": 1e-4, "bfloat16": 2e-2}  # tests/test_flash_grad.py
TOL_LSE = 1e-4
TOL_DELTA = 1e-4
TOL_LOGITS = {"float32": 1e-3, "bfloat16": 0.1}
TOL_GRADS_F32 = 2e-4                           # tests/test_flash_grad.py:170
MIN_COSINE_BF16 = 0.99
EVAL_BATCH = 128
TRAIN_ARGS = ["--arch", "vit-b16", "--steps", "10", "--batch", "128",
              "--accum", "2", "--eval-every", "10", "--eval-batch", "128",
              "--log-every", "1"]
# label, shape (None: the ViT-B/16 one), dtype, causal, window
CASES = [
    ("vit-b16", None, "bfloat16", False, 0),
    ("vit-b16", None, "float32", False, 0),
    ("smoke", (16, 4, 4, 65, 65, 32), "bfloat16", False, 0),
    ("smoke", (16, 4, 4, 65, 65, 32), "float32", False, 0),
    ("S=1", (4, 4, 4, 1, 1, 64), "float32", False, 0),
    ("S=63", (4, 4, 4, 63, 63, 64), "float32", False, 0),
    ("S=130", (4, 4, 4, 130, 130, 64), "float32", False, 0),
    ("causal", (4, 4, 4, 130, 130, 64), "float32", True, 0),
    ("gqa", (4, 8, 2, 197, 197, 64), "float32", False, 0),
    ("window", (4, 4, 4, 130, 130, 64), "float32", True, 40),
    ("D=128", (4, 4, 4, 130, 130, 128), "bfloat16", False, 0),
]


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


def time_ms(fn, warmup=5, reps=25, calls=1):
    """Median CUDA-event time of ``fn`` over ``reps`` runs after warm-up.
    With ``calls`` > 1 each run is that many calls back to back, divided:
    for a call whose host-side cost (autograd, many small launches) is
    near its device time, the host then runs ahead of the card instead of
    adding its own time to every run."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
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
        # ptxas -v: "Compiling entry function '<mangled>'", then its spill
        # and register lines; name each kernel by function, dtype and D
        kernel = name
        for line in log.splitlines():
            m = re.search(r"(flash_(?:fwd|bwd_dq|bwd_dkv)_kernel)"
                          r"I(f|13__nv_bfloat16)Li(\d+)E", line)
            if m:
                dtype = "fp32" if m.group(2) == "f" else "bf16"
                kernel = f"{m.group(1)}<{dtype}, D={m.group(3)}>"
            elif "registers" in line or "spill" in line:
                print(f"[build] {kernel}: {line.strip()}")


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

    vit_err = None
    for label, shape, dname, causal, window in CASES:
        shape = shape or VIT_SHAPE
        dtype = getattr(torch, dname)
        q, k, v = inputs(*shape, dtype)
        out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        ref_out, ref_lse = ref_attention(q, k, v, causal=causal,
                                         window=window)
        d_out = (out.float() - ref_out.float()).abs().max().item()
        d_lse = (lse - ref_lse).abs().max().item()
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
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v),
                         calls=10)
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


def phase_k23(card):
    """K2 and K3 against the plain backward, the autograd Function end to
    end, and their timing at the training micro-shape."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ops import flash_mha
    from repro_torch.kernels.ref import ref_attention_bwd

    gen = torch.Generator(device="cuda").manual_seed(1)

    def inputs(b, h, kh, s, t, d, dtype, model_layout):
        """q, k, v, dO; in the model's (B,S,H,D) buffers seen as (B,H,S,D)
        when ``model_layout``, as the training path hands them over."""
        def mk(bb, hh, n):
            if model_layout:
                return torch.randn((bb, n, hh, d), device="cuda",
                                   generator=gen).to(dtype).transpose(1, 2)
            return torch.randn((bb, hh, n, d), device="cuda",
                               generator=gen).to(dtype)
        return mk(b, h, s), mk(b, kh, t), mk(b, kh, t), mk(b, h, s)

    def close(got, want, tol):
        err = (got.float() - want.float()).abs()
        ok = bool((err <= tol + tol * want.float().abs()).all()) and \
            bool(torch.isfinite(got).all())
        return err.max().item(), ok

    errs = {}
    for label, shape, dname, causal, window in CASES:
        vit = shape is None
        shape = shape or TRAIN_SHAPE
        dtype, tol = getattr(torch, dname), TOL_OUT[dname]
        q, k, v, do = inputs(*shape, dtype, model_layout=vit)
        kw = {"causal": causal, "window": window}
        out, lse = fa.flash_attention_fwd(q, k, v, **kw)
        dq, delta = fa.flash_attention_bwd_dq(q, k, v, out, lse, do, **kw)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
        torch.cuda.synchronize()
        want = ref_attention_bwd(q, k, v, out, lse, do, **kw)
        res = [close(g, w, tol) for g, w in zip((dq, dk, dv), want[:3])]
        res.append(close(delta, want[3], TOL_DELTA))
        ok = all(r[1] for r in res)
        print(f"[k23] {label:8s} {shape} {dname:8s} causal={causal} "
              f"window={window}: max|ddq|={res[0][0]:.3e} "
              f"max|ddk|={res[1][0]:.3e} max|ddv|={res[2][0]:.3e} (tol "
              f"{tol}, rtol {tol}) max|ddelta|={res[3][0]:.3e} (tol "
              f"{TOL_DELTA}) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"K2/K3 disagree with ref_attention_bwd on {label} {dname}")
        if vit and dtype == torch.bfloat16:
            errs = {"dq": max(res[0][0], res[3][0]),
                    "dkv": max(res[1][0], res[2][0])}

    # the autograd Function end to end, in the model layout at the
    # micro-shape: torch.autograd.grad through flash_mha against the plain
    # backward; the gradients keep the primals' layout, with no dO copy
    for dname in ("bfloat16", "float32"):
        dtype, tol = getattr(torch, dname), TOL_OUT[dname]
        q, k, v, w = (x.transpose(1, 2) for x in inputs(
            *TRAIN_SHAPE, dtype, model_layout=True))
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        fa.kernel_layout.copies = 0
        got = torch.autograd.grad(flash_mha(*leaves, causal=False), leaves,
                                  grad_outputs=w)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        out, lse = fa.flash_attention_fwd(qt, kt, vt, causal=False)
        want = ref_attention_bwd(qt, kt, vt, out, lse, w.transpose(1, 2),
                                 causal=False)
        res = [close(g.transpose(1, 2), r, tol)
               for g, r in zip(got, want[:3])]
        layout = [g.stride() == x.stride() for g, x in zip(got, leaves)]
        ok = all(r[1] for r in res) and all(layout) and fa.kernel_layout.copies == 0
        print(f"[k23] autograd.grad(flash_mha) {dname}: max|dgrad|="
              f"{max(r[0] for r in res):.3e} (tol {tol}); grads in the "
              f"primals' layout {layout}; dO copies {fa.kernel_layout.copies} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"the autograd Function disagrees in {dname}")

    b, h, kh, s, t, d = TRAIN_SHAPE
    q, k, v, do = inputs(*TRAIN_SHAPE, torch.bfloat16, model_layout=True)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=False)
    _, delta = fa.flash_attention_bwd_dq(q, k, v, out, lse, do, causal=False)
    ms = {
        "fwd": time_ms(lambda: fa.flash_attention_fwd(q, k, v,
                                                      causal=False)),
        "dq": time_ms(lambda: fa.flash_attention_bwd_dq(
            q, k, v, out, lse, do, causal=False)),
        "dkv": time_ms(lambda: fa.flash_attention_bwd_dkv(
            q, k, v, do, lse, delta, causal=False)),
    }
    plain_ms = time_ms(lambda: ref_attention_bwd(q, k, v, out, lse, do,
                                                 causal=False), reps=10)
    qc, kc, vc, doc = (x.contiguous().detach().requires_grad_()
                       for x in (q, k, v, do))

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qc, kc, vc)
        torch.autograd.grad(o, (qc, kc, vc), grad_outputs=doc)
    with torch.no_grad():
        sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(qc, kc,
                                                                  vc),
                           calls=10)
    library_ms = time_ms(sdpa_fwd_bwd, calls=10) - sdpa_fwd
    part, (bw, peak) = peaks(card)
    el, n = q.element_size(), b * h * s * d
    work = {    # bytes moved once, operations of the products
        "dq": (6 * n * el + 2 * b * h * s * 4, 6 * b * h * s * t * d),
        "dkv": (6 * n * el + 2 * b * h * s * 4, 8 * b * h * s * t * d),
    }
    rows = []
    for key, name, line in (("dq", "flash_bwd_dq", 399),
                            ("dkv", "flash_bwd_dkv", 445)):
        n_bytes, flops = work[key]
        t_bytes, t_ops = n_bytes / bw * 1e3, flops / peak * 1e3
        bound_ms = max(t_bytes, t_ops)
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        print(f"[k23] {name} timing at {TRAIN_SHAPE} bf16 on {card}: kernel "
              f"{ms[key]:.4f} ms, plain backward (dq, dk, dv and delta "
              f"together) {plain_ms:.4f} ms, SDPA backward (yardstick, "
              f"shared by K2 and K3) {library_ms:.4f} ms; bound "
              f"{bound_ms:.4f} ms by {bound_by} ({n_bytes / 1e6:.1f} MB at "
              f"{bw / 1e12:.2f} TB/s = {t_bytes:.4f} ms; {flops / 1e9:.2f} "
              f"GFLOP at {peak / 1e12:.0f} TFLOP/s bf16 = {t_ops:.4f} ms; "
              f"peaks of the {part} data sheet)", flush=True)
        rows.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/flash_bwd.cu",
                     "replaces": f"src/repro/kernels/flash_attention.py:"
                                 f"{line}",
                     "launches": None, "max_abs_err": errs[key],
                     "ms": ms[key], "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": library_ms})
    print(f"[k23] K1 at the training micro-shape: {ms['fwd']:.4f} ms; SDPA "
          f"forward {sdpa_fwd:.4f} ms", flush=True)
    return rows, ms


def counters():
    from repro_torch.kernels import flash_attention as fa
    return {"flash_fwd": fa.flash_attention_fwd,
            "flash_bwd_dq": fa.flash_attention_bwd_dq,
            "flash_bwd_dkv": fa.flash_attention_bwd_dkv}


def run_cli(argv, expect, label):
    """Drive the CLI with every launch counter reset just before and read
    just after; fails unless the counts are ``expect``. Returns (launches,
    metrics rows)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.train import main as cli
    for fn in counters().values():
        fn.launches = 0
    fa.kernel_layout.copies = 0
    hist = cli(argv)
    launches = {name: fn.launches for name, fn in counters().items()}
    print(f"[slice] {label}: launches {launches} (expected {expect}); dO "
          f"copies {fa.kernel_layout.copies}", flush=True)
    if launches != expect or fa.kernel_layout.copies:
        fail(f"{label}: launches {launches}, dO copies {fa.kernel_layout.copies}; "
             f"expected {expect} and no copy")
    return launches, hist


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
    eval_only = {"flash_fwd": 12 * 4, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    _, hist = run_cli(["--arch", "vit-b16"] + base, eval_only,
                      "vit-b16 eval")
    row = hist[0]
    if len(hist) != 1 or row["eval_count"] != 500:
        fail(f"vit-b16 eval: unexpected rows {hist}")
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
    _, hist = run_cli(["--arch", "vit-b16", "--smoke"] + base,
                      dict(eval_only, flash_fwd=2 * 4), "smoke eval")
    if len(hist) != 1 or hist[0]["eval_count"] != 500:
        fail(f"smoke eval: unexpected rows {hist}")


def train_setup(dtype, use_kernels, *, batch=128, accum=2):
    """A full-width ViT-B/16 trainer with the CLI's engine settings for 10
    steps, on procedural CIFAR-10, and its data pipeline."""
    from repro_torch.configs import EngineConfig, get_config
    from repro_torch.core.engine import Trainer
    from repro_torch.data.datasets import CIFARSource
    from repro_torch.data.pipeline import DataPipeline

    cfg = get_config("vit-b16").replace(dtype=dtype, use_kernels=use_kernels)
    source = CIFARSource("cifar10", resolution=cfg.image_size)
    ecfg = EngineConfig(train_batch_size=batch,
                        gradient_accumulation_steps=accum, total_steps=10,
                        warmup_steps=1)
    return Trainer(cfg, ecfg, preproc=source.preproc), \
        DataPipeline(global_batch=batch, source=source)


def new_vit(trainer):
    from repro_torch.models.transformer import ViT, init_params
    return ViT(trainer.cfg, init_params(trainer.cfg, seed=0, device="cuda"))


def compare_train_paths(dtype):
    """Loss and every parameter gradient of one full-width microbatch (64
    images) through the kernel and the naive attention path, on the same
    params and batch. Returns (|dloss|, max |dgrad|, cosine of the
    flattened gradients)."""
    import torch
    from repro_torch.core.engine import to_device

    trainer_k, pipe = train_setup(dtype, True, batch=64, accum=1)
    trainer_n, _ = train_setup(dtype, False, batch=64, accum=1)
    params = new_vit(trainer_k).params()
    batch = to_device(pipe.batch_at(0, 0), "cuda")
    gk, mk = trainer_k.grads(params, batch)
    gn, mn = trainer_n.grads(params, batch)
    flat_k = torch.cat([g.flatten() for g in gk.values()])
    flat_n = torch.cat([gn[k].flatten() for k in gk])
    if not bool(torch.isfinite(flat_k).all()):
        fail(f"{dtype}: non-finite kernel-path gradients")
    cos = torch.nn.functional.cosine_similarity(flat_k, flat_n, dim=0)
    return (abs(float(mk["loss"]) - float(mn["loss"])),
            (flat_k - flat_n).abs().max().item(), float(cos))


def train_rate(trainer, pipe, steps=4, warmup=2):
    """Images/s and ms per optimizer step of warm training steps (host
    clock around steps that end in a synchronize)."""
    import torch
    from repro_torch.core.engine import to_device

    state = trainer.init_state(new_vit(trainer).params())
    batches = [to_device(pipe.batch_at(0, i), "cuda")
               for i in range(warmup + steps)]
    for batch in batches[:warmup]:
        state, _ = trainer.train_step(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch in batches[warmup:]:
        state, m = trainer.train_step(state, batch)
        if not m["step_ok"]:
            fail("a timed training step was skipped by the guard")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return steps * pipe.global_batch / dt, dt / steps * 1e3


def profile_step():
    """One warm training step of the kernel path under torch.profiler:
    device time by kernel, the largest first."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.engine import to_device

    trainer, pipe = train_setup("bfloat16", True)
    state = trainer.init_state(new_vit(trainer).params())
    batches = [to_device(pipe.batch_at(0, i), "cuda") for i in range(3)]
    for batch in batches[:2]:
        state, _ = trainer.train_step(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, _ = trainer.train_step(state, batches[2])
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="self_device_time_total",
                                      row_limit=25)
    print("[profile] one warm vit-b16 training step, bf16, batch 128, "
          "accum 2:\n" + table, flush=True)


def phase_train(profile):
    import math
    expect = {"flash_fwd": 10 * 2 * 12 + 12 * 4, "flash_bwd_dq": 240,
              "flash_bwd_dkv": 240}
    launches, hist = run_cli(TRAIN_ARGS, expect, "vit-b16 train")
    train = [r for r in hist if "loss" in r]
    evals = [r for r in hist if "eval_count" in r]
    if [r["step"] for r in train] != list(range(10)) or len(evals) != 1:
        fail(f"vit-b16 train: unexpected rows {hist}")
    for r in train:
        if not (math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
                and r["step_ok"] == 1):
            fail(f"vit-b16 train: bad step row {r}")
    print(f"[train] vit-b16 losses {[round(r['loss'], 4) for r in train]}; "
          f"grad norms {[round(r['grad_norm'], 3) for r in train]}; "
          f"step_ok all 1; eval after 10 steps: top1="
          f"{evals[0]['eval_top1_count']}/{evals[0]['eval_count']} loss="
          f"{evals[0]['eval_loss']:.4f}; wall {evals[0]['wall_s']} s "
          f"(cold, build and first steps included)", flush=True)

    for dtype in ("float32", "bfloat16"):
        d_loss, d_grad, cos = compare_train_paths(dtype)
        ok = d_grad <= TOL_GRADS_F32 if dtype == "float32" \
            else cos >= MIN_COSINE_BF16
        print(f"[train] vit-b16 {dtype} kernel vs naive, one microbatch of "
              f"64: |dloss|={d_loss:.3e}, max|dgrad|={d_grad:.3e}"
              f"{f' (tol {TOL_GRADS_F32})' if dtype == 'float32' else ''}, "
              f"gradient cosine {cos:.6f}"
              f"{f' (min {MIN_COSINE_BF16})' if dtype == 'bfloat16' else ''}"
              f" {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"vit-b16 {dtype}: kernel and naive gradients disagree")

    rates = {}
    for label in ("kernel", "naive", "naive", "kernel"):
        trainer, pipe = train_setup("bfloat16", label == "kernel")
        rates.setdefault(label, []).append(train_rate(trainer, pipe))
    for label, rs in rates.items():
        ips = sum(r[0] for r in rs) / len(rs)
        ms = sum(r[1] for r in rs) / len(rs)
        print(f"[train] vit-b16 bf16 warm training, {label} attention: "
              f"{ips:.1f} images/s, {ms:.2f} ms per optimizer step (batch "
              f"128, accum 2; runs {[round(r[0], 1) for r in rs]} "
              f"images/s)", flush=True)
    if profile:
        profile_step()
    return launches


def main():
    card = phase_card()
    sys.path.insert(0, str(ROOT / "src"))
    phase_build()
    k1 = phase_k1(card.split(",")[0])
    k23, _ = phase_k23(card.split(",")[0])
    phase_slice()
    launches = phase_train("--profile" in sys.argv[1:])
    kernels = [k1] + k23
    for row in kernels:
        row["launches"] = launches[row["name"]]
    print(json.dumps({"kernels": kernels}))
    print(card)
    import torch
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
