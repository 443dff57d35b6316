#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: builds the CUDA kernels
from this checkout, holds each against its plain PyTorch version, drives
the port's main paths (ViT-B/16 eval and training, ChatGLM3-6B training) at
full width through its CLI, and checks the results.

    python3 chip_smoke.py [--profile]

Phases (any failure exits non-zero and prints no ``ok`` line):

1. card: a CUDA device must be present; prints its name and power limit.
2. build: compiles every kernel (``kernels/build.py``), timed, and prints
   each kernel's ``-Xptxas -v`` registers and spills.
3. K1 against ``ref_attention`` on the card, at the ViT-B/16 eval shape
   (bf16 and fp32), the smoke shape, ragged S, causal, GQA and windowed
   cases; then times the kernel, the plain version and PyTorch's
   ``scaled_dot_product_attention`` (a yardstick the port never calls) at
   the ViT-B/16 shape, beside the card's bound for the same work.
4. K2 and K3 against ``ref_attention_bwd`` at the same cases, with the
   ViT-B/16 training micro-shape (B 64) in place of the eval shape and the
   model's (B,S,H,D) layout there; ``torch.autograd.grad`` through
   ``flash_mha`` against the plain backward; then K1-K3, the plain forward
   and backward and SDPA's forward and backward (its forward+backward less
   its forward, the one yardstick K2 and K3 share) timed at the
   micro-shape.
5. K4 and K5 against ``ref_rmsnorm_fwd``/``ref_rmsnorm_bwd`` at the
   decoder's shape (4096 x 4096), the smoke shape, the reference's
   RMS_CASES, one row and odd D, in bf16 and fp32 (out, dx, dscale within
   1e-4 / 6e-2, rinv within 1e-4 relative), K5 twice for a bitwise equal
   dscale; ``torch.autograd.grad`` through ``ops.fused_rmsnorm``; then
   both timed at the decoder's shape beside the plain versions and
   ``F.rms_norm`` (a yardstick the port never calls).
6. K1-K3 at the decoder's attention shape (B 4, H 32, KH 2, S = T = 1024,
   D 128, causal) against their plain versions in bf16 and fp32, then
   timed as in phase 4 (SDPA with ``enable_gqa``).
7. the eval slice: ``repro_torch.launch.train --arch vit-b16 --steps 0
   --eval-every 1 --eval-batch 128`` on procedural CIFAR-10 (500 examples,
   4 batches, the last mask-padded) with the launch counters reset just
   before and read just after (12 layers x 4 batches = 48 K1 launches);
   then the same params and batches through the naive attention path for
   the logits' agreement, and the smoke config through the CLI as well.
8. the ViT training slice: ``--arch vit-b16 --steps 10 --batch 128 --accum
   2 --eval-every 10 --eval-batch 128`` in bf16 with the counters reset
   just before and read just after (K1 10 x 2 x 12 + 48 = 288, K2 and K3
   240 each); every loss and grad-norm finite and ``step_ok`` 1; then the
   loss and all parameter gradients of one full-width microbatch through
   the kernel and the naive path (fp32 within 2e-4; bf16 cosine >= 0.99),
   and warm training images/s of both paths.
9. the decoder training slice: ``--arch chatglm3-6b --layers 4 --seq 1024
   --batch 8 --accum 2 --steps 10`` in bf16 with the counters reset just
   before and read just after (K1-K3 10 x 2 x 4 = 80 each, K4 and K5
   10 x 2 x (2 x 4 + 1) = 180 each, no layout copy); every loss and
   grad-norm finite and ``step_ok`` 1; the peak of allocated device
   memory; kernel against naive path (plain RMSNorm, naive attention) on
   one microbatch of 4 x 1024 (fp32 within 2e-4; bf16 cosine >= 0.99);
   warm training tokens/s of both paths.

``--profile`` adds a ``torch.profiler`` table of one warm training step of
each training slice. The last lines are one JSON object for the kernels
(K1-K3 with the decoder's numbers and the ViT's under ``vit``), the card's
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

# Published dense peaks (NVIDIA data sheets) by card: HBM bytes/s, bf16
# tensor-core FLOP/s and fp32 FLOP/s outside the tensor cores. The SXM part
# is the H100 80GB HBM3.
PEAKS = {
    "H100 PCIe": (2.0e12, {"bf16": 756e12, "fp32": 51e12}),
    "H100 NVL": (3.9e12, {"bf16": 835e12, "fp32": 60e12}),
    "H100": (3.35e12, {"bf16": 989e12, "fp32": 67e12}),
    "H200": (4.8e12, {"bf16": 989e12, "fp32": 67e12}),
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
SPIN_CYCLES = 20_000_000                       # ~10 ms at the H100's clock
# the decoder slice: chatglm3-6b at full width, cut to 4 layers, sequences
# of 1024 tokens in micro-batches of 4
LM_LAYERS, LM_SEQ = 4, 1024
LM_ATTN_SHAPE = (4, 32, 2, LM_SEQ, LM_SEQ, 128)   # B, H, KH, S, T, D
LM_EPS = 1e-5                                   # chatglm3-6b norm_eps
LM_TRAIN_ARGS = ["--arch", "chatglm3-6b", "--layers", str(LM_LAYERS),
                 "--seq", str(LM_SEQ), "--batch", "8", "--accum", "2",
                 "--steps", "10", "--log-every", "1"]
RMS_TOL = {"float32": 1e-4, "bfloat16": 6e-2}  # tests/test_kernel_grads.py
TOL_RINV = 1e-4                                # relative
# label, shape, row width (None: contiguous rows); the first is the
# decoder's (micro-batch 4 x seq 1024, d 4096), then the smoke config's
# (4 x 64, d 256), the reference's RMS_CASES, one row, an odd D (rows not
# 16-byte aligned: scalar loads) and an odd D in wider rows (16-byte
# vectors and a scalar tail)
RMS_CASES = [
    ("decoder", (4096, 4096), None),
    ("smoke", (4, 64, 256), None),
    ("ref", (64, 256), None),
    ("ragged", (3, 37, 128), None),
    ("ref", (2, 2, 2, 512), None),
    ("ref", (1024, 512), None),
    ("one row", (1, 4096), None),
    ("odd D", (37, 1001), None),
    ("strided", (37, 1001), 1008),
]
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


def bound(card, n_bytes, flops, rate="bf16"):
    """(bound_ms, bound_by, how): the least time the card could take to
    move ``n_bytes`` (each input read once, each output written once) and
    to do ``flops`` at the published ``rate`` peak, the larger of the two."""
    part, (bw, rates) = peaks(card)
    t_bytes, t_ops = n_bytes / bw * 1e3, flops / rates[rate] * 1e3
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    how = (f"{n_bytes / 1e6:.1f} MB at {bw / 1e12:.2f} TB/s = {t_bytes:.4f} "
           f"ms; {flops / 1e9:.2f} GFLOP at {rates[rate] / 1e12:.0f} "
           f"TFLOP/s {rate} = {t_ops:.4f} ms; peaks of the {part} data "
           f"sheet")
    return max(t_bytes, t_ops), bound_by, how


def attn_work(shape, el, causal):
    """Bytes each attention kernel must move and the FLOPs of its products
    at ``shape`` (B, H, KH, S, T, D) with ``el``-byte elements, counting
    the live (query, key) pairs only (the causal triangle with S == T)."""
    b, h, kh, s, t, d = shape
    pairs = b * h * (s * (s + 1) // 2 if causal else s * t)
    q, kv, rows = b * h * s * d * el, b * kh * t * d * el, b * h * s * 4
    return {    # K1: q, k, v, o, lse; K2: + dO, dq, delta; K3: dk, dv
        "fwd": (2 * q + 2 * kv + rows, 4 * pairs * d),
        "dq": (4 * q + 2 * kv + 2 * rows, 6 * pairs * d),
        "dkv": (2 * q + 4 * kv + 2 * rows, 8 * pairs * d),
    }


def close(got, want, tol):
    """(max |got - want|, every element within tol + tol * |want| and
    finite)."""
    import torch
    err = (got.float() - want.float()).abs()
    ok = bool((err <= tol + tol * want.float().abs()).all()) and \
        bool(torch.isfinite(got).all())
    return err.max().item(), ok


def time_ms(fn, warmup=5, reps=25, calls=1):
    """Median CUDA-event time of ``fn`` over ``reps`` runs after warm-up,
    each run ``calls`` calls back to back, divided. Before each run a spin
    kernel of about 10 ms (``torch.cuda._sleep``) is queued, so the host
    enqueues the whole run while the card is still busy and the events
    time the card's work, not the host's launch overhead (which is near
    the device time of a small kernel, or of a call with autograd in it)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
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
            m = re.search(r"(flash_(?:fwd|bwd_dq|bwd_dkv)_kernel|rmsnorm_"
                          r"(?:fwd|bwd)_kernel|dscale_reduce_kernel)(?:I(f|"
                          r"13__nv_bfloat16)(?:Li(\d+)E)?)?", line)
            if m and "Compiling entry" in line:
                args = [] if m.group(2) is None else \
                    ["fp32" if m.group(2) == "f" else "bf16"]
                args += [f"D={m.group(3)}"] if m.group(3) else []
                kernel = m.group(1) + (f"<{', '.join(args)}>" if args else "")
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

    q, k, v = inputs(*VIT_SHAPE, torch.bfloat16)
    ms = time_ms(lambda: flash_attention_fwd(q, k, v, causal=False))
    plain_ms = time_ms(lambda: ref_attention(q, k, v, causal=False))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v),
                         calls=10)
    bound_ms, bound_by, how = bound(
        card, *attn_work(VIT_SHAPE, q.element_size(), False)["fwd"])
    print(f"[k1] timing at {VIT_SHAPE} bf16 on {card}: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, sdpa (yardstick) {library_ms:.4f} ms; "
          f"bound {bound_ms:.4f} ms by {bound_by} ({how})", flush=True)
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
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ops import flash_mha
    from repro_torch.kernels.ref import ref_attention_bwd

    inputs = model_layout_inputs(torch.Generator(device="cuda").manual_seed(1))

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

    t = attention_times(card, TRAIN_SHAPE, False, inputs, "k23")
    rows = []
    for key, name, line in (("dq", "flash_bwd_dq", 399),
                            ("dkv", "flash_bwd_dkv", 445)):
        rows.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/flash_bwd.cu",
                     "replaces": f"src/repro/kernels/flash_attention.py:"
                                 f"{line}",
                     "launches": None, "max_abs_err": errs[key],
                     **t[key]})
    return rows


def attention_times(card, shape, causal, inputs, tag):
    """K1, K2 and K3 at ``shape`` in bf16 in the model layout (``inputs``
    gives q, k, v, dO), beside the plain forward and backward, SDPA's
    forward and backward (its forward+backward less its forward, the one
    yardstick K2 and K3 share) and each kernel's bound. Returns {"fwd",
    "dq", "dkv": {ms, plain_ms, bound_ms, bound_by, library_ms}}."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import ref_attention, ref_attention_bwd

    kw = {"causal": causal}
    q, k, v, do = inputs(*shape, torch.bfloat16, model_layout=True)
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    _, delta = fa.flash_attention_bwd_dq(q, k, v, out, lse, do, **kw)
    ms = {
        "fwd": time_ms(lambda: fa.flash_attention_fwd(q, k, v, **kw)),
        "dq": time_ms(lambda: fa.flash_attention_bwd_dq(
            q, k, v, out, lse, do, **kw)),
        "dkv": time_ms(lambda: fa.flash_attention_bwd_dkv(
            q, k, v, do, lse, delta, **kw)),
    }
    plain = {"fwd": time_ms(lambda: ref_attention(q, k, v, **kw), reps=10)}
    plain["dq"] = plain["dkv"] = time_ms(
        lambda: ref_attention_bwd(q, k, v, out, lse, do, **kw), reps=10)
    qc, kc, vc, doc = (x.contiguous().detach().requires_grad_()
                       for x in (q, k, v, do))
    sdpa_kw = {"is_causal": causal}
    if shape[1] != shape[2]:
        sdpa_kw["enable_gqa"] = True

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qc, kc, vc, **sdpa_kw)
        torch.autograd.grad(o, (qc, kc, vc), grad_outputs=doc)
    with torch.no_grad():
        sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(
            qc, kc, vc, **sdpa_kw), calls=10)
    library = {"fwd": sdpa_fwd}
    library["dq"] = library["dkv"] = \
        time_ms(sdpa_fwd_bwd, calls=10) - sdpa_fwd
    work = attn_work(shape, q.element_size(), causal)
    rows = {}
    for key, name in (("fwd", "K1 flash_fwd"), ("dq", "K2 flash_bwd_dq"),
                      ("dkv", "K3 flash_bwd_dkv")):
        bound_ms, bound_by, how = bound(card, *work[key])
        print(f"[{tag}] {name} timing at {shape} bf16 causal={causal} on "
              f"{card}: kernel {ms[key]:.4f} ms, plain "
              f"{'forward' if key == 'fwd' else 'backward (dq, dk, dv and delta together)'} "
              f"{plain[key]:.4f} ms, SDPA "
              f"{'forward' if key == 'fwd' else 'backward (shared by K2 and K3)'} "
              f"(yardstick) {library[key]:.4f} ms; bound {bound_ms:.4f} ms "
              f"by {bound_by} ({how})", flush=True)
        rows[key] = {"ms": ms[key], "plain_ms": plain[key],
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": library[key]}
    return rows


def model_layout_inputs(gen):
    """``inputs(b, h, kh, s, t, d, dtype, model_layout)`` -> q, k, v, dO;
    in the model's (B,S,H,D) buffers seen as (B,H,S,D) when
    ``model_layout``, as the training path hands them over."""
    import torch

    def inputs(b, h, kh, s, t, d, dtype, model_layout):
        def mk(bb, hh, n):
            if model_layout:
                return torch.randn((bb, n, hh, d), device="cuda",
                                   generator=gen).to(dtype).transpose(1, 2)
            return torch.randn((bb, hh, n, d), device="cuda",
                               generator=gen).to(dtype)
        return mk(b, h, s), mk(b, kh, t), mk(b, kh, t), mk(b, h, s)
    return inputs


def phase_lm_attention(card):
    """K1, K2 and K3 at the decoder's attention shape (causal, GQA 32:2,
    head dim 128, S = T = 1024), where no earlier slice ran them: against
    their plain versions in bf16 and fp32, then timed."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import ref_attention, ref_attention_bwd

    inputs = model_layout_inputs(torch.Generator(device="cuda").manual_seed(3))
    errs = {}
    for dname in ("bfloat16", "float32"):
        dtype, tol = getattr(torch, dname), TOL_OUT[dname]
        q, k, v, do = inputs(*LM_ATTN_SHAPE, dtype, model_layout=True)
        kw = {"causal": True}
        out, lse = fa.flash_attention_fwd(q, k, v, **kw)
        dq, delta = fa.flash_attention_bwd_dq(q, k, v, out, lse, do, **kw)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
        torch.cuda.synchronize()
        ref_out, ref_lse = ref_attention(q, k, v, **kw)
        want = ref_attention_bwd(q, k, v, out, lse, do, **kw)
        res = {"out": close(out, ref_out, tol),
               "lse": close(lse, ref_lse, TOL_LSE),
               "dq": close(dq, want[0], tol), "dk": close(dk, want[1], tol),
               "dv": close(dv, want[2], tol),
               "delta": close(delta, want[3], TOL_DELTA)}
        ok = all(r[1] for r in res.values())
        print(f"[lm-attn] {LM_ATTN_SHAPE} {dname} causal: " + " ".join(
            f"max|d{key}|={r[0]:.3e}" for key, r in res.items())
            + f" (tol {tol}, rtol {tol}; lse and delta {TOL_LSE}) "
            f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"K1-K3 disagree with their plain versions at the decoder "
                 f"shape in {dname}")
        if dtype == torch.bfloat16:
            errs = {"fwd": res["out"][0],
                    "dq": max(res["dq"][0], res["delta"][0]),
                    "dkv": max(res["dk"][0], res["dv"][0])}
    t = attention_times(card, LM_ATTN_SHAPE, True, inputs, "lm-attn")
    return {key: dict(t[key], max_abs_err=errs[key]) for key in t}


def phase_rms(card):
    """K4 and K5 against ``ref_rmsnorm_fwd``/``ref_rmsnorm_bwd`` at every
    shape of RMS_CASES in fp32 and bf16, K5 run twice for bitwise equality,
    ``torch.autograd.grad`` through ``ops.fused_rmsnorm``, then both kernels
    timed at the decoder's shape beside their plain versions and
    ``F.rms_norm`` (a yardstick the port never calls)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import rmsnorm as rms
    from repro_torch.kernels.ops import fused_rmsnorm
    from repro_torch.kernels.ref import ref_rmsnorm_bwd, ref_rmsnorm_fwd

    gen = torch.Generator(device="cuda").manual_seed(4)

    def inputs(shape, dtype, width=None):
        """x, dy (shape; rows ``width`` apart when given) and an fp32
        scale."""
        full = shape[:-1] + (width or shape[-1],)
        x, dy = (torch.randn(full, device="cuda", generator=gen).to(dtype)
                 [..., :shape[-1]] for _ in range(2))
        scale = torch.randn(shape[-1], device="cuda", generator=gen)
        return x, dy, scale

    rms.row_layout.copies = 0
    errs = {}
    for label, shape, width in RMS_CASES:
        for dname in ("bfloat16", "float32"):
            dtype, tol = getattr(torch, dname), RMS_TOL[dname]
            x, dy, scale = inputs(shape, dtype, width)
            out, rinv = rms.fused_rmsnorm_fwd(x, scale, LM_EPS)
            dx, dscale = rms.fused_rmsnorm_bwd(x, scale, rinv, dy)
            dx2, dscale2 = rms.fused_rmsnorm_bwd(x, scale, rinv, dy)
            torch.cuda.synchronize()
            want_out, want_rinv = ref_rmsnorm_fwd(x, scale, LM_EPS)
            want_dx, want_ds = ref_rmsnorm_bwd(x, scale, want_rinv, dy)
            res = {"out": close(out, want_out, tol),
                   "dx": close(dx, want_dx, tol),
                   "dscale": close(dscale, want_ds, tol)}
            d_rinv = ((rinv - want_rinv).abs() / want_rinv).max().item()
            same = torch.equal(dx, dx2) and torch.equal(dscale, dscale2)
            types = (out.dtype, dx.dtype, rinv.dtype, dscale.dtype) == \
                (dtype, dtype, torch.float32, torch.float32)
            ok = all(r[1] for r in res.values()) and same and types and \
                d_rinv <= TOL_RINV and bool(torch.isfinite(rinv).all())
            print(f"[rms] {label:9s} {shape} {dname:8s}: " + " ".join(
                f"max|d{key}|={r[0]:.3e}" for key, r in res.items())
                + f" (tol {tol}, rtol {tol}) rel|drinv|={d_rinv:.3e} (tol "
                f"{TOL_RINV}); K5 bitwise repeatable {same}; dtypes {types} "
                f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                fail(f"K4/K5 disagree with their plain versions on {label} "
                     f"{dname}")
            if label == "decoder" and dtype == torch.bfloat16:
                errs = {"fwd": res["out"][0],
                        "bwd": max(res["dx"][0], res["dscale"][0])}

    for dname in ("bfloat16", "float32"):
        dtype, tol = getattr(torch, dname), RMS_TOL[dname]
        x, dy, scale = inputs(RMS_CASES[0][1], dtype)
        leaves = [x.detach().requires_grad_(), scale.detach().requires_grad_()]
        got = torch.autograd.grad(fused_rmsnorm(*leaves, eps=LM_EPS), leaves,
                                  grad_outputs=dy)
        want = ref_rmsnorm_bwd(x, scale, ref_rmsnorm_fwd(x, scale,
                                                         LM_EPS)[1], dy)
        res = [close(g, w, tol) for g, w in zip(got, want)]
        ok = all(r[1] for r in res)
        print(f"[rms] autograd.grad(ops.fused_rmsnorm) {dname}: max|ddx|="
              f"{res[0][0]:.3e} max|ddscale|={res[1][0]:.3e} (tol {tol}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"the FusedRMSNorm Function disagrees in {dname}")
    print(f"[rms] row layout copies in this phase: {rms.row_layout.copies}",
          flush=True)
    if rms.row_layout.copies:
        fail("K4/K5 copied an input they should take as it is")

    shape = RMS_CASES[0][1]
    rows, d = shape
    x, dy, scale = inputs(shape, torch.bfloat16)
    out, rinv = rms.fused_rmsnorm_fwd(x, scale, LM_EPS)
    ms = {"fwd": time_ms(lambda: rms.fused_rmsnorm_fwd(x, scale, LM_EPS)),
          "bwd": time_ms(lambda: rms.fused_rmsnorm_bwd(x, scale, rinv, dy))}
    plain = {"fwd": time_ms(lambda: ref_rmsnorm_fwd(x, scale, LM_EPS)),
             "bwd": time_ms(lambda: ref_rmsnorm_bwd(x, scale, rinv, dy))}
    xl = x.detach().requires_grad_()
    wl = scale.to(x.dtype).requires_grad_()

    def lib_fwd_bwd():
        o = F.rms_norm(xl, (d,), wl, LM_EPS)
        torch.autograd.grad(o, (xl, wl), grad_outputs=dy)
    with torch.no_grad():
        lib_fwd = time_ms(lambda: F.rms_norm(xl, (d,), wl, LM_EPS), calls=10)
    library = {"fwd": lib_fwd,
               "bwd": time_ms(lib_fwd_bwd, calls=10) - lib_fwd}
    el, n = x.element_size(), rows * d
    work = {    # bytes moved once; about 4 and 10 fp32 operations a value
        "fwd": (2 * n * el + 4 * d + 4 * rows, 4 * n),
        "bwd": (3 * n * el + 8 * d + 4 * rows, 10 * n),
    }
    out_rows = []
    for key, name, line in (("fwd", "rmsnorm_fwd", 49),
                            ("bwd", "rmsnorm_bwd", 94)):
        bound_ms, bound_by, how = bound(card, *work[key], rate="fp32")
        print(f"[rms] {name} timing at {shape} bf16 on {card}: kernel "
              f"{ms[key]:.4f} ms, plain {plain[key]:.4f} ms, F.rms_norm "
              f"{'forward' if key == 'fwd' else 'backward'} (yardstick) "
              f"{library[key]:.4f} ms; bound {bound_ms:.4f} ms by "
              f"{bound_by} ({how})", flush=True)
        out_rows.append({"name": name, "route": "cuda",
                         "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
                         "replaces": f"src/repro/kernels/rmsnorm.py:{line}",
                         "launches": None, "max_abs_err": errs[key],
                         "ms": ms[key], "plain_ms": plain[key],
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "library_ms": library[key]})
    return out_rows


def counters():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rms
    return {"flash_fwd": fa.flash_attention_fwd,
            "flash_bwd_dq": fa.flash_attention_bwd_dq,
            "flash_bwd_dkv": fa.flash_attention_bwd_dkv,
            "rmsnorm_fwd": rms.fused_rmsnorm_fwd,
            "rmsnorm_bwd": rms.fused_rmsnorm_bwd}


def run_cli(argv, expect, label):
    """Drive the CLI with every launch counter reset just before and read
    just after; fails unless the counts are ``expect``. Returns (launches,
    metrics rows)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rms
    from repro_torch.launch.train import main as cli
    for fn in counters().values():
        fn.launches = 0
    fa.kernel_layout.copies = rms.row_layout.copies = 0
    hist = cli(argv)
    launches = {name: fn.launches for name, fn in counters().items()}
    copies = {"dO": fa.kernel_layout.copies, "rows": rms.row_layout.copies}
    print(f"[slice] {label}: launches {launches} (expected {expect}); "
          f"layout copies {copies}", flush=True)
    if launches != expect or any(copies.values()):
        fail(f"{label}: launches {launches}, layout copies {copies}; "
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
    eval_only = {"flash_fwd": 12 * 4, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                 "rmsnorm_fwd": 0, "rmsnorm_bwd": 0}
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


def grad_agreement(trainer_k, trainer_n, params, batch, dtype):
    """Loss and every parameter gradient of one device batch through the
    kernel path (``trainer_k``) and the naive path (``trainer_n``) on the
    same params. Returns (|dloss|, max |dgrad|, cosine of the flattened
    gradients, summed key by key in float64)."""
    import torch

    gk, mk = trainer_k.grads(params, batch)
    gn, mn = trainer_n.grads(params, batch)
    d_max, dot, nk, nn = 0.0, 0.0, 0.0, 0.0
    for key, a in gk.items():
        b = gn[key]
        if not bool(torch.isfinite(a).all()):
            fail(f"{dtype}: non-finite kernel-path gradient {key}")
        d_max = max(d_max, (a - b).abs().max().item())
        a, b = a.double(), b.double()
        dot += float((a * b).sum())
        nk += float((a * a).sum())
        nn += float((b * b).sum())
    return (abs(float(mk["loss"]) - float(mn["loss"])), d_max,
            dot / (nk * nn) ** 0.5)


def compare_train_paths(dtype):
    """``grad_agreement`` on one full-width ViT-B/16 microbatch (64
    images)."""
    from repro_torch.core.engine import to_device

    trainer_k, pipe = train_setup(dtype, True, batch=64, accum=1)
    trainer_n, _ = train_setup(dtype, False, batch=64, accum=1)
    params = new_vit(trainer_k).params()
    batch = to_device(pipe.batch_at(0, 0), "cuda")
    return grad_agreement(trainer_k, trainer_n, params, batch, dtype)


def report_agreement(label, dtype, result):
    d_loss, d_grad, cos = result
    ok = d_grad <= TOL_GRADS_F32 if dtype == "float32" \
        else cos >= MIN_COSINE_BF16
    print(f"[train] {label} {dtype} kernel vs naive: |dloss|={d_loss:.3e}, "
          f"max|dgrad|={d_grad:.3e}"
          f"{f' (tol {TOL_GRADS_F32})' if dtype == 'float32' else ''}, "
          f"gradient cosine {cos:.6f}"
          f"{f' (min {MIN_COSINE_BF16})' if dtype == 'bfloat16' else ''}"
          f" {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"{label} {dtype}: kernel and naive gradients disagree")


def train_rate(trainer, pipe, params, steps=4, warmup=2):
    """Sequences (images) per second and ms per optimizer step of warm
    training steps from a copy of ``params`` (host clock around steps that
    end in a synchronize)."""
    import torch
    from repro_torch.core.engine import to_device

    state = trainer.init_state({k: v.clone() for k, v in params.items()})
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


def profile_step(label, trainer, pipe, params):
    """One warm training step of the kernel path under torch.profiler:
    device time by kernel, the largest first."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.engine import to_device

    state = trainer.init_state({k: v.clone() for k, v in params.items()})
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
    print(f"[profile] one warm {label} training step:\n" + table, flush=True)


def phase_train(profile):
    import math
    expect = {"flash_fwd": 10 * 2 * 12 + 12 * 4, "flash_bwd_dq": 240,
              "flash_bwd_dkv": 240, "rmsnorm_fwd": 0, "rmsnorm_bwd": 0}
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
        report_agreement("vit-b16, one microbatch of 64,", dtype,
                         compare_train_paths(dtype))

    rates = {}
    for label in ("kernel", "naive", "naive", "kernel"):
        trainer, pipe = train_setup("bfloat16", label == "kernel")
        rates.setdefault(label, []).append(
            train_rate(trainer, pipe, new_vit(trainer).params()))
    for label, rs in rates.items():
        ips = sum(r[0] for r in rs) / len(rs)
        ms = sum(r[1] for r in rs) / len(rs)
        print(f"[train] vit-b16 bf16 warm training, {label} attention: "
              f"{ips:.1f} images/s, {ms:.2f} ms per optimizer step (batch "
              f"128, accum 2; runs {[round(r[0], 1) for r in rs]} "
              f"images/s)", flush=True)
    if profile:
        trainer, pipe = train_setup("bfloat16", True)
        profile_step("vit-b16 (bf16, batch 128, accum 2)", trainer, pipe,
                     new_vit(trainer).params())
    return launches


def lm_setup(dtype, use_kernels, *, batch=8, accum=2):
    """A full-width ChatGLM3-6B trainer cut to LM_LAYERS layers with the
    CLI's engine settings for 10 steps, and its token pipeline."""
    from repro_torch.configs import EngineConfig, get_config
    from repro_torch.core.engine import Trainer
    from repro_torch.data.pipeline import DataPipeline

    cfg = get_config("chatglm3-6b").replace(
        num_layers=LM_LAYERS, dtype=dtype, use_kernels=use_kernels)
    ecfg = EngineConfig(train_batch_size=batch,
                        gradient_accumulation_steps=accum, total_steps=10,
                        warmup_steps=1)
    return Trainer(cfg, ecfg), DataPipeline(
        kind="token", global_batch=batch, vocab=cfg.vocab_size,
        seq_len=LM_SEQ, epoch_size=batch * 10)


def phase_lm_train(profile):
    """The decoder slice: ``--arch chatglm3-6b --layers 4 --seq 1024
    --batch 8 --accum 2 --steps 10`` in bf16 through the CLI with the
    launch counters reset just before and read just after (per step and
    microbatch: K1-K3 once a layer, K4/K5 twice a layer and once for the
    final norm); then kernel against naive path on one microbatch, and
    warm training tokens/s of both paths."""
    import math
    import torch
    from repro_torch.core.engine import to_device
    from repro_torch.models.transformer import init_params

    attn, norms = 10 * 2 * LM_LAYERS, 10 * 2 * (2 * LM_LAYERS + 1)
    expect = {"flash_fwd": attn, "flash_bwd_dq": attn, "flash_bwd_dkv": attn,
              "rmsnorm_fwd": norms, "rmsnorm_bwd": norms}
    torch.cuda.reset_peak_memory_stats()
    launches, hist = run_cli(LM_TRAIN_ARGS, expect, "chatglm3-6b train")
    peak = torch.cuda.max_memory_allocated()
    if [r["step"] for r in hist] != list(range(10)):
        fail(f"chatglm3-6b train: unexpected rows {hist}")
    for r in hist:
        if not (math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
                and r["step_ok"] == 1):
            fail(f"chatglm3-6b train: bad step row {r}")
    print(f"[lm] chatglm3-6b ({LM_LAYERS} layers, full width) losses "
          f"{[round(r['loss'], 4) for r in hist]}; grad norms "
          f"{[round(r['grad_norm'], 3) for r in hist]}; step_ok all 1; "
          f"wall {hist[-1]['wall_s']} s (cold, init and first steps "
          f"included); torch.cuda.max_memory_allocated "
          f"{peak / 1e9:.2f} GB", flush=True)

    trainer, pipe = lm_setup("bfloat16", True)
    params = init_params(trainer.cfg, seed=0, device="cuda")
    for dtype in ("float32", "bfloat16"):
        trainer_k, pipe = lm_setup(dtype, True, batch=4, accum=1)
        trainer_n, _ = lm_setup(dtype, False, batch=4, accum=1)
        batch = to_device(pipe.batch_at(0, 0), "cuda")
        report_agreement(f"chatglm3-6b, one microbatch of 4 x {LM_SEQ},",
                         dtype, grad_agreement(trainer_k, trainer_n, params,
                                               batch, dtype))
    rates = {}
    for label in ("kernel", "naive", "naive", "kernel"):
        trainer, pipe = lm_setup("bfloat16", label == "kernel")
        rates.setdefault(label, []).append(train_rate(trainer, pipe, params))
    for label, rs in rates.items():
        tps = sum(r[0] for r in rs) / len(rs) * LM_SEQ
        ms = sum(r[1] for r in rs) / len(rs)
        print(f"[lm] chatglm3-6b bf16 warm training, {label} path: "
              f"{tps:.1f} tokens/s, {ms:.2f} ms per optimizer step (batch "
              f"8 x {LM_SEQ}, accum 2; runs "
              f"{[round(r[0] * LM_SEQ, 1) for r in rs]} tokens/s)",
              flush=True)
    if profile:
        trainer, pipe = lm_setup("bfloat16", True)
        profile_step(f"chatglm3-6b ({LM_LAYERS} layers, bf16, batch 8 x "
                     f"{LM_SEQ}, accum 2)", trainer, pipe, params)
    return launches


def main():
    card = phase_card()
    sys.path.insert(0, str(ROOT / "src"))
    phase_build()
    k1 = phase_k1(card.split(",")[0])
    vit_rows = [k1] + phase_k23(card.split(",")[0])
    rms_rows = phase_rms(card.split(",")[0])
    lm_attn = phase_lm_attention(card.split(",")[0])
    profile = "--profile" in sys.argv[1:]
    phase_slice()
    vit_launches = phase_train(profile)
    lm_launches = phase_lm_train(profile)
    # K1-K3 run on both training paths: the row's numbers are the
    # decoder's (this slice's path), with the ViT's beside them under "vit"
    kernels = []
    for row, key in zip(vit_rows, ("fwd", "dq", "dkv")):
        vit = {k: v for k, v in row.items()
               if k not in ("name", "route", "source", "replaces")}
        vit["launches"] = vit_launches[row["name"]]
        kernels.append(dict(row, **lm_attn[key],
                            launches=lm_launches[row["name"]], vit=vit))
    for row in rms_rows:
        kernels.append(dict(row, launches=lm_launches[row["name"]]))
    print(json.dumps({"kernels": kernels}))
    print(card)
    import torch
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
