#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: builds the CUDA kernels
from this checkout, holds each against its plain PyTorch version, drives
the port's main paths (ViT-B/16 eval and training, one card and
data-parallel under ZeRO 0-3 with augmentation, preempted and resumed from
checkpoints and supervised under injected faults, ChatGLM3-6B and RWKV6-7B
training) at full width through its CLI, and checks the results.

    python3 chip_smoke.py [--profile]

Phases (any failure exits non-zero and prints no ``ok`` line):

1. card: a CUDA device must be present; prints its name and power limit.
2. build: compiles every kernel (``kernels/build.py``), timed, and prints
   each kernel's ``-Xptxas -v`` registers and spills.
3. K1 against ``ref_attention`` on the card, at the ViT-B/16 eval shape,
   the smoke shape, ragged S (1, 63, 130, 197), causal, GQA, windowed
   (also with S > T, rows with no live key) and D 32 and 128 cases, each
   in bf16 (the tensor-core route) and fp32 (the CUDA-core route), some in
   the model's strided (B,S,H,D) layout; then times the kernel, the plain
   version and PyTorch's
   ``scaled_dot_product_attention`` (a yardstick the port never calls) at
   the ViT-B/16 shape, beside the card's bound for the same work.
4. K2 and K3 against ``ref_attention_bwd`` at the same cases (bf16 on
   their tensor-core routes, fp32 on the CUDA cores), with the ViT-B/16
   training micro-shape (B 64) in place of the eval shape and the model's
   (B,S,H,D) layout there; ``torch.autograd.grad`` through
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
   ``F.rms_norm`` (a yardstick the port never calls); K5 is its row pass
   (each row read once into registers, the next row's loads in flight)
   and the fixed-order dscale reduction.
6. K1-K3 at the decoder's attention shape (B 4, H 32, KH 2, S = T = 1024,
   D 128, causal) against their plain versions in bf16 and fp32, K2 run
   twice for bitwise equal dq and delta and K3 for bitwise equal dk and
   dv, K2's grid printed from the built kernel's query tile, then timed as
   in phase 4 (SDPA with ``enable_gqa``).
6b. K6 (with and without states) and K7 against ``ref_wkv6_fwd``/
   ``ref_wkv6_bwd`` at the RWKV6 slice's shape (B 4, S 1024, H 64, P 64,
   chunk 32; bf16 r/k/v with fp32 wlog, and fp32), the smoke shape, the
   reference's WKV_CASES and strong decay (o and s_end within 5e-4 / 5e-2,
   gradients 1e-3 / 0.3 with bf16 against the fp32 oracle, states 5e-4,
   o also against the sequential ``ref_wkv6`` where S <= 128), K7 twice for
   bitwise equal gradients, ``torch.autograd.grad`` through ``ops.wkv6``
   (ragged, padded; and the slice's shape with no copy or pad); then both
   timed at the slice's shape beside their plain versions and bounds,
   with the bytes each kernel's two launches (K6: the state scan, then
   the chunks' outputs; K7: the state-gradient scan, then the chunks'
   adjoints) move as designed.
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
   and warm training images/s of both paths, every kernel-path run faster
   than every naive-path run.
8b. the data-parallel slice, on NCCL at world size 1 (one card): the CLI
   with ``--devices 1`` as rank 0 of a torchrun world in this process (so
   its launch counters are read): fp32 ``--steps 3 --batch 16 --accum 2``
   at ``--zero 0..3`` and once through its own spawned rank, losses and
   grad norms within 2e-4 of the one-card CLI run; bf16 at the training
   slice's size at every stage (K1-K3 288/240/240 launches, every loss and
   grad-norm finite, ``step_ok`` 1, the largest loss difference from the
   one-card run printed), and with ``--augment --zero 0``; one augmented
   microbatch on the card against the CPU apply of the same draws (1e-6);
   warm images/s of the one-card Trainer and each stage in turns (recorded,
   not gated); ``--devices 2`` on one card raises its clear error.
8c. checkpoints, resume and faults, in a directory under ``build/`` that is
   removed afterwards: phase 8's command with ``--stop-after 5 --ckpt-dir
   D --ckpt-every 5``, then again with ``--resume`` (counters read around
   each: K1 5 x 2 x 12 + 48 = 168, K2 and K3 120), losses and grad norms of
   every step within 1e-5 of phase 8's run and the step-10 eval counts
   equal to its; an fp32 ``--devices 1 --zero 3 --steps 3 --stop-after 2``
   run in the torchrun world of one resumed by the one-card CLI, its
   step-2 loss within 1e-5 of phase 8b's one-card fp32 run; phase 8's
   command under ``--supervise --max-restarts 2 --ckpt-every 2 --ckpt-sync
   --keep-last 3 --inject-faults nan_grad@1,preempt@7,ckpt_corrupt@8`` in
   its own processes (exit 0, a second attempt, the guard's skip, step 8
   failing verification and the resume from step 6, the last attempt's
   losses within 1e-5 and every printed loss at its 4 decimals, the eval
   counts, each fault once in ``faults.jsonl``; its log in
   ``chiprun_out/chaos.log``); then the checkpoint's logical and saved
   bytes and the host time of an async save's snapshot, its background
   write, a sync save and a restore of the bf16 training state, recorded
   beside the card's name and power limit, not gated.
8d. the host data layer, in a directory under ``build/`` that is removed
   afterwards (every CLI run before it already takes its batches from the
   two-stage prefetcher at depth 2, pinned copies on a side stream):
   phase 8's command with ``--no-prefetch``, and with ``--inject-faults
   data@3`` under the default prefetch (the retry printed, the plan
   uninstalled after), each run's losses and grad norms bitwise equal to
   phase 8's and its eval counts equal, 288/240/240 launches; procedural
   CIFAR-10 written by ``python -m repro_torch.data.streaming`` at the
   published split sizes (50,000 train in 49 shards of 1,024, 10,000 eval;
   the write timed) and phase 8's command with ``--shard-dir`` on it and a
   500-example eval (288/240/240 launches, finite losses, ``step_ok`` 1);
   the prefetcher's pinned copies above zero in the last two runs; then,
   recorded, not gated: host ms of one batch at batch 128 from procedural
   CIFAR-10, the shards and the fp32 synthetic stream at 224 px, the
   shards each batch loads, the host-to-device copy of the 77 MB fp32
   batch from pageable and pinned memory, and warm training images/s fed
   by ``pipe.prefetch`` (every tensor on the card) and by ``batch_at`` +
   ``to_device`` in turns. Then the port's quickstart
   (``python -m repro_torch.examples.quickstart``, smoke size) exits 0
   with its eval line.
9. the decoder training slice: ``--arch chatglm3-6b --layers 4 --seq 1024
   --batch 8 --accum 2 --steps 10`` in bf16 with the counters reset just
   before and read just after (K1-K3 10 x 2 x 4 = 80 each, K4 and K5
   10 x 2 x (2 x 4 + 1) = 180 each, no layout copy); every loss and
   grad-norm finite and ``step_ok`` 1; the peak of allocated device
   memory; kernel against naive path (plain RMSNorm, naive attention) on
   one microbatch of 4 x 1024 (fp32 within 2e-4; bf16 cosine >= 0.99);
   warm training tokens/s of both paths, every kernel-path run faster
   than every naive-path run.
10. the RWKV6 slice, after the decoder's tensors are freed: ``--arch
   rwkv6-7b --layers 4 --seq 1024 --batch 8 --accum 2 --steps 10`` in bf16
   with the counters reset just before and read just after (K6 and K7
   10 x 2 x 4 = 80 each, K4 and K5 180 each, no attention, no layout copy
   and no pad); every loss and grad-norm finite and ``step_ok`` 1; the
   peak of allocated device memory; kernel against naive path (plain
   RMSNorm, the chunked WKV6) on one microbatch of 4 x 1024 (bf16 cosine
   >= 0.99; fp32 within 2e-4 with the group norm's eps raised to 1e-3,
   and at the model's eps printed as a reading); warm training tokens/s of
   both paths, every kernel-path run faster than every naive-path run;
   then the run's first two steps replayed in process, and at
   the params after each K6/K7 against their plain versions on the
   model's own WKV6 inputs and cotangent and fp32 kernel against naive
   gradients with the norm eps at 1e-3 (2e-4), with the bf16 and fp32
   gradients' norms and cosines printed as readings.

``--profile`` adds a ``torch.profiler`` table of one warm training step of
each training slice (and of the ZeRO-3 step at world 1), and at the end (after every timed phase) of one warm
bf16 eval pass of the eval slice.
The last lines are one JSON object for the kernels (K1-K3 with the
decoder's numbers and the ViT's under ``vit``, the data-parallel runs'
launches there under ``dp_launches``, the preempted and resumed runs'
under ``resume_launches`` and phase 8d's under ``data_launches``, K4/K5
with the RWKV6 run's launches and the decoder's beside them, K6/K7; each
redesigned kernel with its ``routes``), the card's
``nvidia-smi`` name and power limit, and the ``ok`` line.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import socket
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
# the RWKV6 slice: rwkv6-7b at full width, cut to 4 layers, sequences of
# 1024 tokens in micro-batches of 4; one WKV6 call there is B 4, S 1024,
# H 64, P 64 in chunks of 32
RWKV_LAYERS = 4
RWKV_TRAIN_ARGS = ["--arch", "rwkv6-7b", "--layers", str(RWKV_LAYERS),
                   "--seq", str(LM_SEQ), "--batch", "8", "--accum", "2",
                   "--steps", "10", "--log-every", "1"]
WKV_SHAPE = (4, LM_SEQ, 64, 64, 32)            # B, S, H, P, chunk
WKV_TOL = {"float32": 5e-4, "bfloat16": 5e-2}  # tests/test_kernels.py:51-53
WKV_GRAD_TOL = {"float32": 1e-3, "bfloat16": 0.3}  # test_kernel_grads.py
WKV_STATES_TOL = 5e-4
# K6/K7 on the model's own inputs, against the plain version on the same
# (bf16) inputs, relative to each output's largest value: both sides sum in
# fp32, and a bf16 output (dr, dk, dv) carries its own rounding, up to 2^-8
# of an element
WKV_REL_TOL = {"float32": 1e-3, "bfloat16": 1e-2}
# the norm eps of the fp32 kernel-vs-naive gate on RWKV6: at the model's
# 1e-5 the per-head group norm amplifies fp32 rounding where a head-row's
# variance is near eps, and two fp32 evaluations disagree beyond 2e-4
RWKV_GATE_EPS = 1e-3
# label, (B, S, H, P, chunk), r/k/v dtype, wlog dtype (None: r's): the
# slice's shape with the model's fp32 wlog, the smoke config's (micro-batch
# 4 x 64), the reference's WKV_CASES, and strong decay (wlog -8)
WKV_CASES = [
    ("rwkv6-7b", WKV_SHAPE, "bfloat16", "float32"),
    ("rwkv6-7b", WKV_SHAPE, "float32", None),
    ("smoke", (4, 64, 4, 32, 32), "bfloat16", "float32"),
    ("smoke", (4, 64, 4, 32, 32), "float32", None),
    ("ref", (1, 64, 2, 32, 16), "float32", None),
    ("ref", (1, 64, 2, 32, 16), "bfloat16", None),
    ("ref", (2, 128, 4, 64, 32), "float32", None),
    ("ref", (2, 128, 4, 64, 32), "bfloat16", None),
    ("ref", (1, 96, 2, 64, 32), "float32", None),
    ("ref", (1, 96, 2, 64, 32), "bfloat16", None),
    ("strong", (1, 128, 2, 32, 32), "float32", None),
    ("strong", (1, 128, 2, 64, 32), "bfloat16", "float32"),
]
WKV_RAGGED = (2, 57, 3, 32, 16)
TRAIN_ARGS = ["--arch", "vit-b16", "--steps", "10", "--batch", "128",
              "--accum", "2", "--eval-every", "10", "--eval-batch", "128",
              "--log-every", "1"]
# label, shape (None: the ViT-B/16 one), dtype, causal, window, and whether
# q, k, v (and dO) come as the model's (B,S,H,D) buffers seen as (B,H,S,D)
# (the ViT cases always do in phase 4). bf16 takes the tensor-core kernels
# and fp32 the CUDA-core ones, so every ragged, causal, windowed, GQA and
# head-dim case runs in both.
CASES = [
    ("vit-b16", None, "bfloat16", False, 0, False),
    ("vit-b16", None, "float32", False, 0, False),
    ("smoke", (16, 4, 4, 65, 65, 32), "bfloat16", False, 0, False),
    ("smoke", (16, 4, 4, 65, 65, 32), "float32", False, 0, False),
    ("S=1", (4, 4, 4, 1, 1, 64), "float32", False, 0, False),
    ("S=1", (4, 4, 4, 1, 1, 64), "bfloat16", False, 0, False),
    ("S=63", (4, 4, 4, 63, 63, 64), "float32", False, 0, False),
    ("S=63", (4, 4, 4, 63, 63, 64), "bfloat16", False, 0, False),
    ("S=130", (4, 4, 4, 130, 130, 64), "float32", False, 0, False),
    ("S=130", (4, 4, 4, 130, 130, 64), "bfloat16", False, 0, False),
    ("causal", (4, 4, 4, 130, 130, 64), "float32", True, 0, False),
    ("causal", (4, 4, 4, 130, 130, 64), "bfloat16", True, 0, False),
    ("gqa", (4, 8, 2, 197, 197, 64), "float32", False, 0, False),
    ("gqa", (4, 8, 2, 197, 197, 64), "bfloat16", False, 0, False),
    ("gqa", (4, 8, 2, 197, 197, 64), "bfloat16", False, 0, True),
    ("window", (4, 4, 4, 130, 130, 64), "float32", True, 40, False),
    ("window", (4, 4, 4, 130, 130, 64), "bfloat16", True, 40, False),
    ("S>T win", (2, 4, 2, 200, 70, 64), "float32", False, 30, False),
    ("S>T win", (2, 4, 2, 200, 70, 64), "bfloat16", False, 30, True),
    ("D=32", (2, 4, 2, 197, 197, 32), "float32", True, 0, False),
    ("D=32", (2, 4, 2, 197, 197, 32), "bfloat16", True, 0, True),
    ("D=128", (4, 4, 4, 130, 130, 128), "bfloat16", False, 0, False),
    ("D=128", (2, 32, 2, 197, 197, 128), "float32", True, 0, False),
    ("D=128", (2, 32, 2, 197, 197, 128), "bfloat16", True, 0, True),
]
# The redesigned kernels and the routes each takes; their rows say so, and
# PERF.md's kernel table keeps the earlier design's times
ROUTES = {
    "flash_fwd": "bf16: tensor cores (mma.sync m16n8k16: S = Q K^T, O += "
                 "P V; cp.async double buffering); fp32: CUDA cores",
    "flash_bwd_dq": "bf16: tensor cores (mma.sync m16n8k16: S = Q K^T, dP = "
                    "dO V^T, dq += dS K; cp.async double buffering); fp32: "
                    "CUDA cores",
    "flash_bwd_dkv": "bf16: tensor cores (mma.sync m16n8k16: S^T = K Q^T, "
                     "dP^T = V dO^T, dV += P^T dO, dK += dS^T Q; cp.async "
                     "double buffering; GQA group split); fp32: CUDA cores",
    "rmsnorm_bwd": "fp32 CUDA cores in both dtypes: each row read once "
                   "into registers (16-byte units, fixed columns a thread, "
                   "scale and dscale partials in registers), the next "
                   "row's loads in flight, one barrier a row, 16 rows a "
                   "CTA at 4096 rows; then the fixed-order dscale "
                   "reduction",
    "wkv6_fwd": "fp32 CUDA cores in both dtypes, two launches: the state "
                "scan over 32-row slices of S (next chunk prefetched), then "
                "one CTA per (b, h, chunk) with register-tiled products and "
                "16-byte staging loads",
    "wkv6_bwd": "fp32 CUDA cores in both dtypes, two launches: the reverse "
                "scan of the state gradient over 16-row slices of it, then "
                "one CTA per (b, h, chunk) with register-tiled products",
}
REDESIGNED = tuple(ROUTES)


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
            m = re.search(r"(flash_(?:fwd|bwd_dq|bwd_dkv)(?:_tc)?_kernel|"
                          r"dkv_reduce_kernel|rmsnorm_(?:fwd|bwd)_kernel|"
                          r"dscale_reduce_kernel|"
                          r"wkv6_(?:fwd|bwd)_(?:scan|chunk)_kernel)"
                          r"(?:I((?:f|13__nv_bfloat16|S\d*_)*)"
                          r"((?:Li\d+E)*))?", line)
            if m and "Compiling entry" in line:
                # a repeated type is mangled as a back-reference (S_, S0_)
                types = re.findall(r"f|13__nv_bfloat16|S\d*_", m.group(2) or "")
                args = ["fp32" if t == "f" else "bf16" for t in types]
                if "_tc_" in m.group(1):    # the bf16 tensor-core route
                    args = ["bf16"]
                names = ("P", "cs") if "wkv6" in m.group(1) else \
                    ("units",) if "rmsnorm_bwd" in m.group(1) else ("D",)
                args += [f"{n}={v}" for n, v in zip(
                    names, re.findall(r"Li(\d+)E", m.group(3) or ""))]
                kernel = m.group(1) + (f"<{', '.join(args)}>" if args else "")
            elif "registers" in line or "spill" in line:
                print(f"[build] {kernel}: {line.strip()}")


def phase_k1(card):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.ref import ref_attention

    inputs = model_layout_inputs(torch.Generator(device="cuda").manual_seed(0))

    vit_err = None
    for label, shape, dname, causal, window, layout in CASES:
        shape = shape or VIT_SHAPE
        dtype = getattr(torch, dname)
        q, k, v, _ = inputs(*shape, dtype, model_layout=layout)
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
              f"window={window} model layout={layout}: "
              f"max|dout|={d_out:.3e} (tol {tol}) "
              f"max|dlse|={d_lse:.3e} (tol {TOL_LSE}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"K1 disagrees with ref_attention on {label} {dname}")
        if label == "vit-b16" and dtype == torch.bfloat16:
            vit_err = d_out

    q, k, v, _ = inputs(*VIT_SHAPE, torch.bfloat16, model_layout=False)
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
    for label, shape, dname, causal, window, layout in CASES:
        vit = shape is None
        shape = shape or TRAIN_SHAPE
        dtype, tol = getattr(torch, dname), TOL_OUT[dname]
        q, k, v, do = inputs(*shape, dtype, model_layout=vit or layout)
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
              f"window={window} model layout={vit or layout}: "
              f"max|ddq|={res[0][0]:.3e} "
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
    head dim 128, S = T = 1024): against their plain versions in bf16 and
    fp32, K2 run twice for bitwise equal dq and delta, K3 run twice for
    bitwise equal dk and dv (its bf16 route splits each GQA group over 4
    CTAs and sums their partials in a fixed order), then timed."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import ref_attention, ref_attention_bwd

    inputs = model_layout_inputs(torch.Generator(device="cuda").manual_seed(3))
    b, h, _, s, _, _ = LM_ATTN_SHAPE
    tile = fa._lib_bwd().repro_flash_query_tile()
    print(f"[lm-attn] K2 grid: ceil({s} / {tile}) q tiles x {h} heads x {b} "
          f"= {-(-s // tile) * h * b} CTAs", flush=True)
    errs = {}
    for dname in ("bfloat16", "float32"):
        dtype, tol = getattr(torch, dname), TOL_OUT[dname]
        q, k, v, do = inputs(*LM_ATTN_SHAPE, dtype, model_layout=True)
        kw = {"causal": True}
        out, lse = fa.flash_attention_fwd(q, k, v, **kw)
        dq, delta = fa.flash_attention_bwd_dq(q, k, v, out, lse, do, **kw)
        dq2, delta2 = fa.flash_attention_bwd_dq(q, k, v, out, lse, do, **kw)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
        dk2, dv2 = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
        torch.cuda.synchronize()
        same_dq = torch.equal(dq, dq2) and torch.equal(delta, delta2)
        same = torch.equal(dk, dk2) and torch.equal(dv, dv2)
        ref_out, ref_lse = ref_attention(q, k, v, **kw)
        want = ref_attention_bwd(q, k, v, out, lse, do, **kw)
        res = {"out": close(out, ref_out, tol),
               "lse": close(lse, ref_lse, TOL_LSE),
               "dq": close(dq, want[0], tol), "dk": close(dk, want[1], tol),
               "dv": close(dv, want[2], tol),
               "delta": close(delta, want[3], TOL_DELTA)}
        ok = all(r[1] for r in res.values()) and same and same_dq
        print(f"[lm-attn] {LM_ATTN_SHAPE} {dname} causal: " + " ".join(
            f"max|d{key}|={r[0]:.3e}" for key, r in res.items())
            + f" (tol {tol}, rtol {tol}; lse and delta {TOL_LSE}); K2 run "
            f"twice bitwise equal dq and delta {same_dq}; K3 run twice "
            f"bitwise equal {same} {'ok' if ok else 'FAIL'}", flush=True)
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


def wkv6_work(shape, el, w_el):
    """Bytes each WKV6 kernel must move (each input read once, each output
    written once) and its fp32 operations at ``shape`` (B, S, H, P, chunk)
    with ``el``-byte r/k/v and ``w_el``-byte wlog; an exp counts as one
    operation, a multiply-add as two. Per (b, h) and chunk of cs rows and
    its cs (cs - 1) / 2 live pairs (t, j), each pairwise decay
    exp(lprev_t - L_j) counted once (a subtraction and an exp): K6 takes
    4 cs P^2 + 2 P^2 for the carried state and its update, 7 per pair and
    column (the decay 2, the att dot 3, att·v 2) and ~9 cs P elementwise;
    K7 takes 8 cs P^2 + 4 P^2 for its four state products, 14 per pair and
    column (the decay 2, att 3, dr_att 3, dk_att 2 with dA·decay shared,
    dA 2, dv 2) and ~20 cs P elementwise. Returns {"fwd": with states,
    "primal": without, "bwd", "fwd_design": the bytes K6's two launches
    move as designed, with or without states: the scan reads k, v, wlog and
    s0 and writes every S_c (the states, or a scratch of their size) and
    s_end; the chunk launch reads r, k, v, wlog, u and the S_c and writes
    o; "bwd_design": the bytes K7's two launches move as designed, each
    reading dO once: the scan reads r, wlog, dO and dS_end and writes every
    G_c (the size of the states) and ds0; the chunk launch reads r, k, v,
    wlog, u, dO, the states and the G_c and writes the gradients and the du
    partials}."""
    b, s, h, p, cs = shape
    n, pp, bh = b * s * h * p, b * h * p * p, b * h
    nc, pairs = s // cs, cs * (cs - 1) // 2
    ins = 3 * n * el + n * w_el + h * p * 4
    states = bh * nc * p * p * 4
    fwd_ops = bh * nc * (4 * cs * p * p + 2 * p * p + 7 * pairs * p
                         + 9 * cs * p)
    bwd_ops = bh * nc * (8 * cs * p * p + 4 * p * p + 14 * pairs * p
                         + 20 * cs * p)
    primal = ins + 2 * pp * 4 + n * 4               # + s0, s_end, o
    outs = 3 * n * el + n * w_el                    # dr/dk/dv, dwlog
    fwd_scan = 2 * n * el + n * w_el + pp * 4 + states + pp * 4
    fwd_chunks = ins + states + n * 4
    scan = n * el + n * w_el + n * 4 + pp * 4 + states + pp * 4
    chunks = ins + n * 4 + 2 * states + outs + bh * nc * p * 4
    return {"fwd": (primal + states, fwd_ops), "primal": (primal, fwd_ops),
            "fwd_design": (fwd_scan + fwd_chunks, fwd_ops),
            # + states, dO, dS_end; dr/dk/dv, dwlog, ds0, du per (b, h)
            "bwd": (ins + states + n * 4 + pp * 4 + outs + pp * 4
                    + bh * p * 4, bwd_ops),
            "bwd_design": (scan + chunks, bwd_ops)}


def phase_wkv6(card):
    """K6 (with and without states) and K7 against ``ref_wkv6_fwd``/
    ``ref_wkv6_bwd`` at every case of WKV_CASES, o against the sequential
    ``ref_wkv6`` where it is small, K7 twice for bitwise equal du and ds0,
    the ragged case and the slice's shape through ``torch.autograd.grad``
    of ``ops.wkv6``; then both kernels timed at the slice's shape beside
    their plain versions and their bounds (no PyTorch call computes
    WKV6)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import wkv6 as wk
    from repro_torch.kernels.ref import ref_wkv6, ref_wkv6_bwd, ref_wkv6_fwd

    gen = torch.Generator(device="cuda").manual_seed(5)

    def randn(*shape):
        return torch.randn(shape, device="cuda", generator=gen)

    def inputs(b, s, h, p, dtype, w_dtype, strong=False):
        """r, k, v, wlog, u, s0 and fixed cotangents dO, dS_end, as the
        reference's tests draw them."""
        r, k, v = (randn(b, s, h, p).to(dtype) for _ in range(3))
        wlog = torch.full((b, s, h, p), -8.0, device="cuda") if strong \
            else -torch.exp(randn(b, s, h, p) - 0.5)
        return (r, k, v, wlog.to(w_dtype), 0.3 * randn(h, p),
                0.1 * randn(b, h, p, p), randn(b, s, h, p), randn(b, h, p, p))

    wk.kernel_layout.copies = wk.pad_to_chunk.pads = 0
    errs = {}
    for label, (b, s, h, p, cs), dname, wname in WKV_CASES:
        dtype = getattr(torch, dname)
        w_dtype = getattr(torch, wname or dname)
        r, k, v, w, u, s0, do, dse = inputs(b, s, h, p, dtype, w_dtype,
                                            strong=label == "strong")
        o, se, st = wk.wkv6_fwd(r, k, v, w, u, s0, chunk=cs,
                                with_states=True)
        o1, se1, st1 = wk.wkv6_fwd(r, k, v, w, u, s0, chunk=cs,
                                   with_states=False)
        g = wk.wkv6_bwd(r, k, v, w, u, st, do, dse, chunk=cs)
        g2 = wk.wkv6_bwd(r, k, v, w, u, st, do, dse, chunk=cs)
        torch.cuda.synchronize()
        strong = label == "strong"
        # strong decay in fp32 within 1e-3 (tests/test_kernel_grads.py:82-93)
        tol, gtol = (1e-3, 1e-3) if strong and dname == "float32" else \
            (WKV_TOL[dname], WKV_GRAD_TOL[dname])
        want_o, want_se, want_st = ref_wkv6_fwd(r, k, v, w, u, s0, chunk=cs,
                                                with_states=True)
        # bf16 gradients against the fp32 oracle on the same (quantized)
        # inputs, as tests/test_kernel_grads.py:72-79
        f32 = [x.float() for x in (r, k, v, w)]
        want_g = ref_wkv6_bwd(*f32, u, want_st, do, dse, chunk=cs)
        res = {"o": close(o, want_o, tol), "s_end": close(se, want_se, tol),
               "states": close(st, want_st, WKV_STATES_TOL)}
        res.update({f"d{n}": close(x, y, gtol)
                    for n, x, y in zip(("r", "k", "v", "wlog", "u", "s0"),
                                       g, want_g)})
        if s <= 128:        # the sequential oracle, a step at a time
            res["o_seq"] = close(o, ref_wkv6(r, k, v, w, u, s0)[0], tol)
        same = torch.equal(o, o1) and torch.equal(se, se1) and st1 is None
        repeat = all(torch.equal(x, y) for x, y in zip(g, g2))
        types = [x.dtype for x in g] == [dtype] * 3 + [
            w_dtype, torch.float32, torch.float32] and \
            o.dtype == se.dtype == st.dtype == torch.float32
        ok = all(x[1] for x in res.values()) and same and repeat and types
        print(f"[wkv6] {label:8s} {(b, s, h, p, cs)} {dname:8s} wlog "
              f"{wname or dname}: " + " ".join(
                  f"max|d{key}|={x[0]:.3e}" for key, x in res.items())
              + f" (tol {tol} out, {gtol} grads, {WKV_STATES_TOL} states; "
              f"rtol alike); "
              f"primal-only K6 equal {same}; K7 bitwise repeatable {repeat}; "
              f"dtypes {types} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"K6/K7 disagree with their plain versions on {label} "
                 f"{dname}")
        if label == "rwkv6-7b" and dtype == torch.bfloat16:
            errs = {"fwd": max(res["o"][0], res["s_end"][0]),
                    "bwd": max(res[f"d{n}"][0] for n in
                               ("r", "k", "v", "wlog", "u", "s0"))}

    # torch.autograd.grad through ops.wkv6: the ragged case (padded inside)
    # against autograd of the sequential oracle in fp32, then the slice's
    # shape in the model's dtypes against the plain backward
    def grads(fn, xs, do, dse):
        leaves = [x.detach().requires_grad_() for x in xs]
        o, se = fn(*leaves)
        return torch.autograd.grad((o.float() * do).sum()
                                   + (se.float() * dse).sum(), leaves)

    b, s, h, p, cs = WKV_RAGGED
    xs = inputs(b, s, h, p, torch.float32, torch.float32)
    got = grads(lambda *a: ops.wkv6(*a, chunk=cs), xs[:6], *xs[6:])
    want = grads(ref_wkv6, xs[:6], *xs[6:])
    res = [close(x, y, WKV_GRAD_TOL["float32"]) for x, y in zip(got, want)]
    ok = all(x[1] for x in res) and wk.pad_to_chunk.pads == 1
    print(f"[wkv6] autograd.grad(ops.wkv6) ragged {WKV_RAGGED} fp32 against "
          f"autograd of ref_wkv6: max|dgrad|={max(x[0] for x in res):.3e} "
          f"(tol {WKV_GRAD_TOL['float32']}); pads {wk.pad_to_chunk.pads} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("autograd through ops.wkv6 disagrees on the ragged case")
    b, s, h, p, cs = WKV_SHAPE
    wk.pad_to_chunk.pads = 0
    xs = inputs(b, s, h, p, torch.bfloat16, torch.float32)
    got = grads(lambda *a: ops.wkv6(*a, chunk=cs), xs[:6], *xs[6:])
    st = ref_wkv6_fwd(*xs[:6], chunk=cs, with_states=True)[2]
    want = ref_wkv6_bwd(*[x.float() for x in xs[:4]], xs[4], st, *xs[6:],
                        chunk=cs)
    res = [close(x, y, WKV_GRAD_TOL["bfloat16"]) for x, y in zip(got, want)]
    ok = all(x[1] for x in res) and wk.pad_to_chunk.pads == 0 and \
        wk.kernel_layout.copies == 0
    print(f"[wkv6] autograd.grad(ops.wkv6) {WKV_SHAPE} bf16 r/k/v, fp32 "
          f"wlog: max|dgrad|={max(x[0] for x in res):.3e} (tol "
          f"{WKV_GRAD_TOL['bfloat16']}); layout copies "
          f"{wk.kernel_layout.copies}, pads {wk.pad_to_chunk.pads} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("autograd through ops.wkv6 disagrees at the slice's shape, or "
             "copied or padded")

    r, k, v, w, u, s0, do, dse = inputs(b, s, h, p, torch.bfloat16,
                                        torch.float32)
    _, _, st = wk.wkv6_fwd(r, k, v, w, u, s0, chunk=cs, with_states=True)
    ms = {"fwd": time_ms(lambda: wk.wkv6_fwd(r, k, v, w, u, s0, chunk=cs,
                                             with_states=True)),
          "primal": time_ms(lambda: wk.wkv6_fwd(r, k, v, w, u, s0, chunk=cs,
                                                with_states=False)),
          "bwd": time_ms(lambda: wk.wkv6_bwd(r, k, v, w, u, st, do, dse,
                                             chunk=cs))}
    plain = {"fwd": time_ms(lambda: ref_wkv6_fwd(r, k, v, w, u, s0, chunk=cs,
                                                 with_states=True), reps=10),
             "bwd": time_ms(lambda: ref_wkv6_bwd(r, k, v, w, u, st, do, dse,
                                                 chunk=cs), reps=10)}
    plain["primal"] = plain["fwd"]
    work = wkv6_work(WKV_SHAPE, r.element_size(), w.element_size())
    rows = {}
    for key, name in (("fwd", "K6 wkv6_fwd (with states)"),
                      ("primal", "K6 wkv6_fwd (primal only)"),
                      ("bwd", "K7 wkv6_bwd")):
        bound_ms, bound_by, how = bound(card, *work[key], rate="fp32")
        print(f"[wkv6] {name} timing at {WKV_SHAPE} bf16 r/k/v, fp32 wlog "
              f"on {card}: kernel {ms[key]:.4f} ms, plain {plain[key]:.4f} "
              f"ms, no library call; bound {bound_ms:.4f} ms by {bound_by} "
              f"({how})", flush=True)
        rows[key] = {"ms": ms[key], "plain_ms": plain[key],
                     "bound_ms": bound_ms, "bound_by": bound_by}
    for key, name in (("fwd", "K6"), ("bwd", "K7")):
        design_ms, _, how = bound(card, *work[f"{key}_design"], rate="fp32")
        print(f"[wkv6] {name}'s two launches as designed move "
              f"{work[f'{key}_design'][0] / 1e6:.1f} MB, {design_ms:.4f} ms "
              f"at the card's memory rate ({how}); the function's own bound "
              f"is {rows[key]['bound_ms']:.4f} ms", flush=True)
    out = []
    for key, line in (("fwd", 57), ("bwd", 184)):
        out.append({"name": f"wkv6_{key}", "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/wkv6.cu",
                    "replaces": f"src/repro/kernels/wkv6.py:{line}",
                    "launches": None, "max_abs_err": errs[key], **rows[key],
                    "library_ms": None})
    out[0]["primal_only_ms"] = rows["primal"]["ms"]
    return out


def counters():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rms
    from repro_torch.kernels import wkv6 as wk
    return {"flash_fwd": fa.flash_attention_fwd,
            "flash_bwd_dq": fa.flash_attention_bwd_dq,
            "flash_bwd_dkv": fa.flash_attention_bwd_dkv,
            "rmsnorm_fwd": rms.fused_rmsnorm_fwd,
            "rmsnorm_bwd": rms.fused_rmsnorm_bwd,
            "wkv6_fwd": wk.wkv6_fwd, "wkv6_bwd": wk.wkv6_bwd}


def run_cli(argv, expect, label):
    """Drive the CLI with every launch counter reset just before and read
    just after; fails unless the counts are ``expect`` (counters it does not
    name must read 0) and nothing was copied or padded. Returns (launches,
    metrics rows)."""
    from repro_torch.data.pipeline import pinned_copy
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rms
    from repro_torch.kernels import wkv6 as wk
    from repro_torch.launch.train import main as cli
    expect = dict({name: 0 for name in counters()}, **expect)
    for fn in counters().values():
        fn.launches = 0
    fa.kernel_layout.copies = rms.row_layout.copies = 0
    wk.kernel_layout.copies = wk.pad_to_chunk.pads = 0
    pinned_copy.copies = 0
    hist = cli(argv)
    launches = {name: fn.launches for name, fn in counters().items()}
    copies = {"dO": fa.kernel_layout.copies, "rows": rms.row_layout.copies,
              "wkv6": wk.kernel_layout.copies,
              "wkv6 pads": wk.pad_to_chunk.pads}
    print(f"[slice] {label}: launches {launches} (expected {expect}); "
          f"layout copies and pads {copies}; the prefetcher's pinned "
          f"copies {pinned_copy.copies}", flush=True)
    if launches != expect or any(copies.values()):
        fail(f"{label}: launches {launches}, layout copies and pads "
             f"{copies}; expected {expect} and no copy or pad")
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


def profile_eval():
    """One warm bf16 eval pass of the kernel path over the 500-example
    split at batch EVAL_BATCH under torch.profiler: device time by kernel,
    the largest first. It runs after every timed phase: a profiler session
    slows the small-kernel ViT steps timed after it in the same process."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.core.engine import Evaluator
    from repro_torch.data.datasets import CIFARSource
    from repro_torch.models.transformer import ViT, init_params

    cfg = get_config("vit-b16").replace(dtype="bfloat16")
    source = CIFARSource("cifar10", seed=0, resolution=cfg.image_size)
    ev = Evaluator(cfg, ViT(cfg, init_params(cfg, seed=0, device="cuda")),
                   preproc=source.preproc)
    ev.evaluate(source.eval_batches(EVAL_BATCH))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ev.evaluate(source.eval_batches(EVAL_BATCH))
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="self_device_time_total",
                                      row_limit=15)
    print(f"[profile] one warm vit-b16 (bf16, batch {EVAL_BATCH}) eval "
          f"pass:\n" + table, flush=True)


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


def compare_grads(ga, gb, label):
    """(max |ga - gb|, cosine of the flattened gradients, |ga|, |gb|), the
    sums taken key by key in float64; fails if ``ga`` is not finite."""
    import torch
    d_max, dot, na, nb = 0.0, 0.0, 0.0, 0.0
    for key, a in ga.items():
        b = gb[key]
        if not bool(torch.isfinite(a).all()):
            fail(f"{label}: non-finite gradient {key}")
        d_max = max(d_max, (a - b).abs().max().item())
        a, b = a.double(), b.double()
        dot += float((a * b).sum())
        na += float((a * a).sum())
        nb += float((b * b).sum())
    return d_max, dot / (na * nb) ** 0.5, na ** 0.5, nb ** 0.5


def grad_agreement(trainer_k, trainer_n, params, batch, dtype):
    """Loss and every parameter gradient of one device batch through the
    kernel path (``trainer_k``) and the naive path (``trainer_n``) on the
    same params. Returns (|dloss|, max |dgrad|, cosine of the flattened
    gradients, summed key by key in float64)."""
    gk, mk = trainer_k.grads(params, batch)
    gn, mn = trainer_n.grads(params, batch)
    d_max, cos, _, _ = compare_grads(gk, gn, f"{dtype} kernel path")
    return abs(float(mk["loss"]) - float(mn["loss"])), d_max, cos


def compare_train_paths(dtype):
    """``grad_agreement`` on one full-width ViT-B/16 microbatch (64
    images)."""
    from repro_torch.core.engine import to_device

    trainer_k, pipe = train_setup(dtype, True, batch=64, accum=1)
    trainer_n, _ = train_setup(dtype, False, batch=64, accum=1)
    params = new_vit(trainer_k).params()
    batch = to_device(pipe.batch_at(0, 0), "cuda")
    return grad_agreement(trainer_k, trainer_n, params, batch, dtype)


def report_agreement(label, dtype, result, tol=TOL_GRADS_F32, why=""):
    """Gate one ``grad_agreement``: fp32 max |dgrad| within ``tol``, bf16
    cosine at least MIN_COSINE_BF16."""
    d_loss, d_grad, cos = result
    ok = d_grad <= tol if dtype == "float32" else cos >= MIN_COSINE_BF16
    print(f"[train] {label} {dtype} kernel vs naive: |dloss|={d_loss:.3e}, "
          f"max|dgrad|={d_grad:.3e}"
          f"{f' (tol {tol:.3e}{why})' if dtype == 'float32' else ''}, "
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
                                      row_limit=40)
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
    require_kernel_wins("vit-b16", rates)
    if profile:
        trainer, pipe = train_setup("bfloat16", True)
        profile_step("vit-b16 (bf16, batch 128, accum 2)", trainer, pipe,
                     new_vit(trainer).params())
    return launches, hist


DP_STAGES = (0, 1, 2, 3)
# the fp32 check of the data-parallel path: 3 full-width steps at a batch
# the fp32 CUDA-core attention route runs in seconds
DP_F32_ARGS = ["--arch", "vit-b16", "--dtype", "float32", "--steps", "3",
               "--batch", "16", "--accum", "2", "--log-every", "1"]
DP_TOL = 2e-4                       # tests/test_engine_distributed.py:43
AUG_TOL = 1e-6


@contextlib.contextmanager
def torchrun_env():
    """This process as rank 0 of a torchrun world of one: the variables
    ``torchrun`` sets, with a free port on the loopback for the store, so
    the CLI's data-parallel path runs here (NCCL) and its launch counters
    can be read."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def train_rows(hist, label, steps):
    """The train rows of a CLI run; fails unless there is one per step,
    each with a finite loss and grad-norm and ``step_ok`` 1."""
    import math
    rows = [r for r in hist if "loss" in r]
    if [r["step"] for r in rows] != list(range(steps)):
        fail(f"{label}: unexpected rows {hist}")
    for r in rows:
        if not (math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
                and r["step_ok"] == 1):
            fail(f"{label}: bad step row {r}")
    return rows


def max_diff(rows, ref, key):
    return max(abs(a[key] - b[key]) for a, b in zip(rows, ref))


def phase_dp(vit_hist, profile):
    """The data-parallel path on one card, over NCCL at world size 1
    (NCCL refuses two ranks on one device; the multi-rank semantics are
    held on gloo worlds in the CPU tests): the CLI with ``--devices 1`` as
    rank 0 of a torchrun world in this process, so its launch counters are
    read, and once through its own spawned rank. Returns ({stage: K1-K3
    launches of the bf16 run}, the augmented run's launches, the one-card
    fp32 run's train rows)."""
    import gc
    import torch

    def free():
        gc.collect()
        torch.cuda.empty_cache()
    free()
    t0 = time.time()
    # 1. fp32, 3 steps: every stage within DP_TOL of the one-card run
    f32 = {"flash_fwd": 3 * 2 * 12, "flash_bwd_dq": 3 * 2 * 12,
           "flash_bwd_dkv": 3 * 2 * 12}
    _, hist = run_cli(DP_F32_ARGS, f32, "vit-b16 fp32 one card")
    ref = f32_ref = train_rows(hist, "vit-b16 fp32 one card", 3)
    for zero in DP_STAGES:
        label = f"vit-b16 fp32 --devices 1 --zero {zero}"
        with torchrun_env():
            _, hist = run_cli(DP_F32_ARGS + ["--devices", "1", "--zero",
                                             str(zero)], f32, label)
        rows = train_rows(hist, label, 3)
        d_loss, d_norm = max_diff(rows, ref, "loss"), \
            max_diff(rows, ref, "grad_norm")
        print(f"[dp] {label}: max |dloss| {d_loss:.3e}, max |dgnorm| "
              f"{d_norm:.3e} against the one-card run (tol {DP_TOL})",
              flush=True)
        if not (d_loss <= DP_TOL and d_norm <= DP_TOL):
            fail(f"{label} disagrees with the one-card run")
    # ... and once through the CLI's own spawned rank (launches not
    # readable from here: the rank is another process)
    from repro_torch.launch.train import main as cli
    rows = train_rows(cli(DP_F32_ARGS + ["--devices", "1", "--zero", "3"]),
                      "spawned rank", 3)
    d_loss = max_diff(rows, ref, "loss")
    print(f"[dp] vit-b16 fp32 --devices 1 --zero 3, spawned rank: max "
          f"|dloss| {d_loss:.3e} (tol {DP_TOL})", flush=True)
    if not d_loss <= DP_TOL:
        fail("the spawned rank disagrees with the one-card run")
    # 2. bf16 at the training slice's size, every stage
    expect = {"flash_fwd": 10 * 2 * 12 + 12 * 4, "flash_bwd_dq": 240,
              "flash_bwd_dkv": 240}
    ref = train_rows(vit_hist, "vit-b16 train", 10)
    launches = {}
    for zero in DP_STAGES:
        label = f"vit-b16 bf16 --devices 1 --zero {zero}"
        with torchrun_env():
            launches[zero], hist = run_cli(
                TRAIN_ARGS + ["--devices", "1", "--zero", str(zero)],
                expect, label)
        rows = train_rows(hist, label, 10)
        evals = [r for r in hist if "eval_count" in r]
        if len(evals) != 1 or evals[0]["eval_count"] != 500:
            fail(f"{label}: unexpected eval rows {evals}")
        print(f"[dp] {label}: losses {[round(r['loss'], 4) for r in rows]}; "
              f"step_ok all 1; eval top1={evals[0]['eval_top1_count']}/500; "
              f"largest |dloss| from the one-card run "
              f"{max_diff(rows, ref, 'loss'):.3e}, |dgnorm| "
              f"{max_diff(rows, ref, 'grad_norm'):.3e}", flush=True)
        free()
    # 3. augmented, ZeRO-0
    label = "vit-b16 bf16 --devices 1 --zero 0 --augment"
    with torchrun_env():
        aug_launches, hist = run_cli(
            TRAIN_ARGS + ["--devices", "1", "--zero", "0", "--augment"],
            expect, label)
    rows = train_rows(hist, label, 10)
    print(f"[dp] {label}: losses {[round(r['loss'], 4) for r in rows]}; "
          f"step_ok all 1", flush=True)
    augment_on_card()
    free()
    # 4. warm images/s by stage beside the one-card Trainer, in turns
    dp_rates(profile)
    # 5. two ranks on one card: a clear error before any process starts
    if torch.cuda.device_count() < 2:
        try:
            cli(TRAIN_ARGS + ["--devices", "2"])
        except RuntimeError as e:
            print(f"[dp] --devices 2 on {torch.cuda.device_count()} card: "
                  f"{e}", flush=True)
        else:
            fail("--devices 2 on one card did not raise")
    print(f"[dp] phase done in {time.time() - t0:.1f}s", flush=True)
    return launches, aug_launches, f32_ref


RESUME_TOL = 1e-5                   # tests/test_resilience.py's resume parity
CHAOS_FAULTS = "nan_grad@1,preempt@7,ckpt_corrupt@8"


def resumed_rows(hist, label, steps, ref):
    """The train rows of ``steps`` in a resumed or chaos run, each within
    RESUME_TOL of the uninterrupted run's loss and grad-norm (``ref``, rows
    by step); returns the largest differences."""
    rows = [r for r in hist if "loss" in r]
    if [r["step"] for r in rows] != list(steps):
        fail(f"{label}: rows for steps {[r['step'] for r in rows]}, "
             f"expected {list(steps)}")
    d_loss = max_diff(rows, [ref[r["step"]] for r in rows], "loss")
    d_norm = max_diff(rows, [ref[r["step"]] for r in rows], "grad_norm")
    print(f"[ckpt] {label}: steps {list(steps)}, max |dloss| {d_loss:.3e}, "
          f"max |dgnorm| {d_norm:.3e} against the uninterrupted run (tol "
          f"{RESUME_TOL})", flush=True)
    if not (d_loss <= RESUME_TOL and d_norm <= RESUME_TOL):
        fail(f"{label} does not reproduce the uninterrupted run")
    return d_loss, d_norm


def eval_counts(hist, label, want):
    """Fails unless the run's eval at step 10 has ``want``'s counts."""
    keys = ("eval_top1_count", "eval_top5_count", "eval_count")
    got = [r for r in hist if "eval_count" in r and r["step"] == 10]
    if len(got) != 1 or [got[0][k] for k in keys] != [want[k] for k in keys]:
        fail(f"{label}: eval at step 10 {got}, expected the counts of "
             f"{want}")


def phase_ckpt(vit_hist, f32_ref):
    """Checkpoints, resume and faults at full width (phase 8c), in a
    directory under the git-ignored ``build/`` that is removed afterwards:
    the training slice preempted after 5 steps and resumed, against phase
    8's run; an fp32 ZeRO-3 world of one resumed by the one-card CLI,
    against phase 8b's; phase 8's command supervised under injected
    faults; then the save and restore readings. Returns the K1-K3
    launches of the preempted and the resumed run."""
    import shutil
    import tempfile
    t0 = time.time()
    ref = {r["step"]: r for r in train_rows(vit_hist, "vit-b16 train", 10)}
    evals = [r for r in vit_hist if "eval_count" in r]
    (ROOT / "build").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="ckpt-", dir=ROOT / "build"))
    try:
        # 1. preempt after 5 steps, then resume (K1 5 x 2 x 12 + the eval)
        d = root / "resume"
        expect = {"flash_fwd": 5 * 2 * 12 + 12 * 4, "flash_bwd_dq": 120,
                  "flash_bwd_dkv": 120}
        launches = {}
        launches["preempted"], hist = run_cli(
            TRAIN_ARGS + ["--stop-after", "5", "--ckpt-dir", str(d),
                          "--ckpt-every", "5"], expect, "vit-b16 --stop-after 5")
        resumed_rows(hist, "vit-b16 preempted at 5", range(5), ref)
        sizes = checkpoint_sizes(d, 5)
        launches["resumed"], hist = run_cli(
            TRAIN_ARGS + ["--resume", "--ckpt-dir", str(d), "--ckpt-every",
                          "5"], expect, "vit-b16 --resume")
        resumed_rows(hist, "vit-b16 resumed at 5", range(5, 10), ref)
        eval_counts(hist, "vit-b16 resumed", evals[0])
        shutil.rmtree(d)
        # 2. elastic: fp32 ZeRO-3 at world 1 for 2 steps, resumed on one card
        d = root / "elastic"
        per_step = {k: 2 * 12 for k in ("flash_fwd", "flash_bwd_dq",
                                        "flash_bwd_dkv")}
        with torchrun_env():
            run_cli(DP_F32_ARGS + ["--devices", "1", "--zero", "3",
                                   "--stop-after", "2", "--ckpt-dir", str(d)],
                    {k: 2 * n for k, n in per_step.items()},
                    "vit-b16 fp32 --devices 1 --zero 3 --stop-after 2")
        _, hist = run_cli(DP_F32_ARGS + ["--resume", "--ckpt-dir", str(d)],
                          per_step, "vit-b16 fp32 one card --resume")
        resumed_rows(hist, "fp32 ZeRO-3 world 1 resumed on one card",
                     range(2, 3), {r["step"]: r for r in f32_ref})
        shutil.rmtree(d)
        # 3. the chaos run under the supervisor, in its own processes
        chaos_run(root / "chaos", ref, evals[0])
        # 4. the readings: blocked time of an async save, its write, a sync
        # save and a restore
        save_readings(root / "timing", sizes)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"[ckpt] phase done in {time.time() - t0:.1f}s", flush=True)
    return launches


def checkpoint_sizes(d, step):
    from repro_torch.checkpoint import checkpoint_size_report
    rep = checkpoint_size_report(str(d), step)
    files = sum(rep["file_bytes"].values())
    print(f"[ckpt] vit-b16 AdamW state at step {step}: logical "
          f"{rep['logical_bytes']} bytes, saved {rep['saved_bytes']} bytes, "
          f"files {files} bytes", flush=True)
    if rep["saved_bytes"] != rep["logical_bytes"]:
        fail(f"checkpoint saved {rep['saved_bytes']} bytes of a "
             f"{rep['logical_bytes']}-byte state")
    return rep


def chaos_run(d, ref, want_eval):
    """Phase 8's command under the supervisor with NaN gradients at step 1,
    a preemption after step 7 and step 8's checkpoint corrupted: attempt 1
    saves steps 2, 4, 6 and 8 (corrupted) and exits 75 at step 8; attempt
    2 falls back to step 6 and replays steps 6 and 7."""
    metrics = d / "metrics.json"
    cmd = [sys.executable, "-m", "repro_torch.launch.train"] + TRAIN_ARGS + [
        "--ckpt-dir", str(d), "--ckpt-every", "2", "--ckpt-sync",
        "--keep-last", "3", "--supervise", "--max-restarts", "2",
        "--inject-faults", CHAOS_FAULTS, "--metrics-out", str(metrics)]
    t0 = time.time()
    r = subprocess.run(cmd, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                       capture_output=True, text=True, timeout=600)
    out = r.stdout
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "chaos.log").write_text(out + r.stderr)
    print(f"[ckpt] chaos run: exit {r.returncode} in {time.time() - t0:.1f} "
          f"s (log in chiprun_out/chaos.log)", flush=True)
    for line in out.splitlines():
        if line.startswith(("[supervisor]", "[guard]", "[ckpt]",
                            "[faults]")) or "preempted" in line:
            print(f"[ckpt]   {line}", flush=True)
    needed = ["launch attempt 2/3", "update skipped",
              "[ckpt] step 8 failed verification", "resumed step=6"]
    if r.returncode != 0 or any(n not in out for n in needed):
        print(r.stderr[-4000:], file=sys.stderr)
        fail(f"chaos run: exit {r.returncode}, missing "
             f"{[n for n in needed if n not in out]}")
    hist = json.loads(metrics.read_text())
    resumed_rows(hist, "chaos run, last attempt", range(6, 10), ref)
    eval_counts(hist, "chaos run", want_eval)
    # every attempt's printed loss (4 decimals) against the reference run
    printed = re.findall(r"\[train\] step +(\d+) loss=(\S+)", out)
    worst = max(abs(float(v) - ref[int(s)]["loss"]) for s, v in printed)
    if sorted({int(s) for s, _ in printed}) != list(range(10)) or \
            worst > 5e-5 + RESUME_TOL:
        fail(f"chaos run printed {printed}")
    kinds = sorted(json.loads(line)["kind"]
                   for line in (d / "faults.jsonl").read_text().splitlines())
    if kinds != ["ckpt_corrupt", "nan_grad", "preempt"]:
        fail(f"chaos run fault log holds {kinds}")
    print(f"[ckpt] chaos run: {len(printed)} printed step losses within "
          f"{worst:.1e} of the uninterrupted run's 4-decimal values; "
          f"faults.jsonl {kinds}", flush=True)


def save_readings(d, sizes):
    """Host time the training loop is blocked by one async save (the
    device-to-host snapshot), the background write behind it, one sync
    save and one restore of the full-width bf16 training state; recorded,
    not gated."""
    import shutil
    import torch
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.core.engine import to_device

    trainer, pipe = train_setup("bfloat16", True)
    state = trainer.init_state(new_vit(trainer).params())
    state, _ = trainer.train_step(state, to_device(pipe.batch_at(0, 0),
                                                   "cuda"))
    saver = trainer.make_checkpointer()
    readings = {}
    for rep in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        saver.save(str(d), 10 + rep, trainer.checkpoint_tree(state))
        t1 = time.perf_counter()
        saver.wait()
        t2 = time.perf_counter()
        save_checkpoint(str(d), 20 + rep, trainer.checkpoint_tree(state))
        t3 = time.perf_counter()
        trainer.restore_state(str(d), step=20 + rep, state=state)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        readings[rep] = (t1 - t0, t2 - t1, t3 - t2, t4 - t3)
        for step in (10 + rep, 20 + rep):
            shutil.rmtree(d / f"step_{step:08d}")
    gib = sizes["logical_bytes"] / 2 ** 30
    for rep, (blocked, write, sync, restore) in readings.items():
        print(f"[ckpt] {'cold' if rep == 0 else 'warm'} save and restore of "
              f"the {gib:.3f} GiB state: async save blocks the loop "
              f"{blocked * 1e3:.1f} ms (device-to-host snapshot), its "
              f"background write {write * 1e3:.1f} ms, a sync save "
              f"{sync * 1e3:.1f} ms, a restore {restore * 1e3:.1f} ms; "
              f"{smi_line()}", flush=True)


# phase 8d: CIFAR-10's published split sizes for the shard cell
SHARD_TRAIN, SHARD_EVAL = 50_000, 10_000


class _Tee:
    """Copies what is written to it to ``stream`` and keeps it."""

    def __init__(self, stream):
        self.stream, self.parts = stream, []

    def write(self, text):
        self.parts.append(text)
        return self.stream.write(text)

    def flush(self):
        self.stream.flush()


def bitwise_rows(hist, label, ref, want_eval):
    """Fails unless every step's loss and grad norm equal ``ref``'s (phase
    8's rows by step) bit for bit, and the step-10 eval counts
    ``want_eval``'s."""
    rows = train_rows(hist, label, 10)
    diff = [r["step"] for r in rows
            if (r["loss"], r["grad_norm"]) != (ref[r["step"]]["loss"],
                                              ref[r["step"]]["grad_norm"])]
    print(f"[data] {label}: losses and grad norms of steps 0-9 "
          f"{'bitwise equal to' if not diff else 'DIFFER from'} phase 8's"
          + (f" at steps {diff}" if diff else ""), flush=True)
    if diff:
        fail(f"{label}: the stream differs from phase 8's at steps {diff}")
    eval_counts(hist, label, want_eval)


def need_pinned(label):
    from repro_torch.data.pipeline import pinned_copy
    if pinned_copy.copies <= 0:
        fail(f"{label}: the prefetcher made no pinned copy")
    return pinned_copy.copies


def phase_data(vit_hist):
    """The host data layer (phase 8d), in a directory under the
    git-ignored ``build/`` that is removed afterwards: phase 8's command
    with ``--no-prefetch`` and with a transient data fault under the
    default prefetch, both bitwise equal to phase 8's run; procedural
    CIFAR-10 written as shards at the published split sizes and trained
    from with ``--shard-dir``; then the readings. Returns the K1-K3
    launches of the three runs."""
    import shutil
    import tempfile
    from repro_torch.resilience import faults
    t0 = time.time()
    ref = {r["step"]: r for r in train_rows(vit_hist, "vit-b16 train", 10)}
    want_eval = [r for r in vit_hist if "eval_count" in r][0]
    expect = {"flash_fwd": 10 * 2 * 12 + 12 * 4, "flash_bwd_dq": 240,
              "flash_bwd_dkv": 240}
    (ROOT / "build").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="data-", dir=ROOT / "build"))
    launches = {}
    try:
        # (a) the synchronous path: the same stream
        launches["no_prefetch"], hist = run_cli(
            TRAIN_ARGS + ["--no-prefetch"], expect, "vit-b16 --no-prefetch")
        bitwise_rows(hist, "vit-b16 --no-prefetch", ref, want_eval)
        # (b) a transient data fault at batch 3, retried by the prefetcher
        tee = _Tee(sys.stdout)
        with contextlib.redirect_stdout(tee):
            launches["data_fault"], hist = run_cli(
                TRAIN_ARGS + ["--inject-faults", "data@3"], expect,
                "vit-b16 --inject-faults data@3")
        copies = need_pinned("vit-b16 --inject-faults data@3")
        retries = [line for line in "".join(tee.parts).splitlines()
                   if line.startswith("[data] transient source error")]
        if not retries or faults.active() is not None:
            fail(f"data@3: retries {retries}, plan still installed: "
                 f"{faults.active()!r}")
        bitwise_rows(hist, "vit-b16 data@3 (retried)", ref, want_eval)
        print(f"[data] data@3: {len(retries)} retries printed, "
              f"{copies} pinned copies", flush=True)
        # (c) procedural CIFAR-10 as shards at the published split sizes
        d = root / "shards"
        w0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.data.streaming", "--out",
             str(d), "--train-size", str(SHARD_TRAIN), "--eval-size",
             str(SHARD_EVAL)], env=dict(os.environ,
                                        PYTHONPATH=str(ROOT / "src")),
            capture_output=True, text=True, timeout=300)
        write_s = time.perf_counter() - w0
        if r.returncode:
            print(r.stderr[-4000:], file=sys.stderr)
            fail(f"shard write exit {r.returncode}")
        n_bytes = sum(f.stat().st_size for f in d.iterdir())
        print(f"[data] {r.stdout.strip()}; {n_bytes} bytes on disk; "
              f"{write_s:.2f} s with the process start", flush=True)
        launches["shards"], hist = run_cli(
            TRAIN_ARGS + ["--shard-dir", str(d), "--eval-size", "500"],
            expect, "vit-b16 --shard-dir")
        copies = need_pinned("vit-b16 --shard-dir")
        train_rows(hist, "vit-b16 --shard-dir", 10)
        evals = [r for r in hist if "eval_count" in r]
        print(f"[data] --shard-dir: losses "
              f"{[round(r['loss'], 4) for r in hist if 'loss' in r]}; "
              f"step_ok all 1; eval after 10 steps top1="
              f"{evals[0]['eval_top1_count']}/{evals[0]['eval_count']}; "
              f"{copies} pinned copies", flush=True)
        data_readings(d)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"[data] phase done in {time.time() - t0:.1f}s", flush=True)
    return launches


def host_ms(fn, reps=5):
    """Median host ms of ``fn()`` after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def data_readings(shard_dir):
    """Host ms of one batch at batch 128 from each source, the shard
    source's loads per batch, the host-to-device copy of the fp32 batch
    from pageable and pinned memory, and warm training images/s fed
    through the prefetcher and through ``batch_at`` + ``to_device`` in
    turns; recorded, not gated. Fails if a prefetched tensor is not on
    the card."""
    import numpy as np
    import torch
    from repro_torch.data.datasets import CIFARSource
    from repro_torch.data.pipeline import DataPipeline, batch_seed
    from repro_torch.data.streaming import DEFAULT_SHARD_SIZE, ShardedSource
    from repro_torch.data.synthetic import DATASETS

    card = smi_line()
    shards = ShardedSource(str(shard_dir))
    pipes = {
        "procedural CIFAR-10": DataPipeline(
            global_batch=128, source=CIFARSource("cifar10", resolution=224)),
        f"shards ({shards.train_size} examples)": DataPipeline(
            global_batch=128, source=shards),
        "fp32 synthetic at 224 px": DataPipeline(
            global_batch=128, dataset=DATASETS["cifar10"], resolution=224),
    }
    for label, pipe in pipes.items():
        step = iter(range(10 ** 6))
        ms = host_ms(lambda: pipe.batch_at(0, next(step) % 8))
        batch = pipe.batch_at(0, 0)
        n = sum(v.nbytes for v in batch.values())
        print(f"[data] one batch_at at batch 128, {label}: {ms:.2f} host ms "
              f"for {n} bytes; {card}", flush=True)
    # the shard source's read amplification: loads per with-replacement
    # batch through its LRU of 4 shards
    pipe = pipes[f"shards ({shards.train_size} examples)"]
    shard_bytes = (shard_dir / "train-00000.npz").stat().st_size
    loads, touched = [], []
    for i in range(8):
        before = shards.shard_loads
        batch = pipe.batch_at(1, i)
        loads.append(shards.shard_loads - before)
        idx = np.random.default_rng(batch_seed(pipe.seed, 1, i)).integers(
            0, shards.train_size, (128,))
        touched.append(len(np.unique(idx // DEFAULT_SHARD_SIZE)))
    print(f"[data] shard source: shards loaded per batch of 128 {loads} "
          f"(distinct shards touched {touched}; 49 shards of 1024, LRU 4), "
          f"about {statistics.mean(loads) * shard_bytes / 1e6:.1f} MB read "
          f"for a {batch['images'].nbytes + batch['labels'].nbytes}-byte "
          f"batch", flush=True)
    # the host-to-device copy of the fp32 batch
    x = pipes["fp32 synthetic at 224 px"].batch_at(0, 0)["images"]
    pageable = torch.from_numpy(x)
    pinned = pageable.pin_memory()

    def copy(src, **kw):
        y = src.to("cuda", **kw)
        torch.cuda.synchronize()
        return y

    t_page = host_ms(lambda: copy(pageable))
    t_pin = host_ms(lambda: copy(pinned, non_blocking=True))
    t_pin_copy = host_ms(lambda: copy(pageable.pin_memory(),
                                      non_blocking=True))
    print(f"[data] host-to-device copy of the {x.nbytes}-byte fp32 batch: "
          f"pageable {t_page:.2f} ms ({x.nbytes / t_page / 1e6:.2f} GB/s), "
          f"pinned {t_pin:.2f} ms ({x.nbytes / t_pin / 1e6:.2f} GB/s), "
          f"pin then copy {t_pin_copy:.2f} ms; {card}", flush=True)
    # warm training images/s by how the loop is fed, in turns: procedural
    # CIFAR-10 through pipe.prefetch, through batch_at + to_device, and
    # from batches built and copied before the timed steps (phase 8's
    # train_rate, the ceiling); the shards through pipe.prefetch
    feeds = {"prefetch": "pipe.prefetch", "sync": "batch_at + to_device",
             "prebuilt": "batches built before the timed steps",
             "shards": "pipe.prefetch from the shards"}
    rates = {}
    for label in ("prefetch", "sync", "prebuilt", "shards", "shards",
                  "prebuilt", "sync", "prefetch"):
        trainer, pipe = train_setup("bfloat16", True)
        if label == "shards":
            pipe = DataPipeline(global_batch=128, source=shards)
        rates.setdefault(label, []).append(fed_train_rate(
            trainer, pipe, new_vit(trainer).params(), label))
    for label, rs in rates.items():
        print(f"[data] vit-b16 bf16 warm training fed by {feeds[label]}: "
              f"{statistics.mean(r[0] for r in rs):.1f} images/s, "
              f"{statistics.mean(r[1] for r in rs):.2f} ms per optimizer "
              f"step (runs {[round(r[0], 1) for r in rs]} images/s); "
              f"{card}", flush=True)


def fed_train_rate(trainer, pipe, params, feed, steps=4, warmup=2):
    """``train_rate`` with the batches fetched inside the timed loop:
    ``feed`` "prefetch" or "shards" takes them from ``pipe.prefetch``
    (every tensor checked to be on the card), "sync" builds each by
    ``batch_at`` and copies it by ``to_device``, "prebuilt" builds and
    copies them all before the first step, as ``train_rate`` does."""
    import torch
    from repro_torch.core.engine import to_device

    state = trainer.init_state({k: v.clone() for k, v in params.items()})
    cursor = [0, 0]
    prefetcher = pipe.prefetch(0, 0, device="cuda") \
        if feed in ("prefetch", "shards") else None
    built = iter([to_device(pipe.batch_at(0, i), "cuda")
                  for i in range(warmup + steps)]) \
        if feed == "prebuilt" else None

    def fetch():
        if prefetcher is not None:
            _, batch, _ = next(prefetcher)
            if not all(t.is_cuda for t in batch.values()):
                fail("the prefetcher yielded a tensor off the card")
            return batch
        if built is not None:
            return next(built)
        batch = to_device(pipe.batch_at(*cursor), "cuda")
        cursor[:] = pipe.next_cursor(*cursor)
        return batch

    try:
        for _ in range(warmup):
            state, _ = trainer.train_step(state, fetch())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            state, m = trainer.train_step(state, fetch())
            if not m["step_ok"]:
                fail("a timed training step was skipped by the guard")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        if prefetcher is not None:
            prefetcher.close()
    return steps * pipe.global_batch / dt, dt / steps * 1e3


def phase_quickstart():
    """The port's quickstart on the card at its smoke size, in its own
    process: it must exit 0 and print its eval line."""
    t0 = time.time()
    r = subprocess.run([sys.executable, "-m",
                        "repro_torch.examples.quickstart"],
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                       capture_output=True, text=True, timeout=600)
    lines = r.stdout.strip().splitlines()
    for line in lines:
        if line.startswith(("model=", "eval:")):
            print(f"[quickstart] {line}", flush=True)
    if r.returncode or not any(line.startswith("eval: top1")
                               for line in lines):
        print(r.stdout[-2000:] + r.stderr[-4000:], file=sys.stderr)
        fail(f"quickstart exit {r.returncode}")
    print(f"[quickstart] exit 0 in {time.time() - t0:.1f}s", flush=True)


def augment_on_card():
    """One augmented global microbatch of the training slice (64 images of
    step 0, microbatch 0, every recipe step drawn, mixing forced on) on
    the card against the CPU apply of the same draws."""
    import torch
    from repro_torch.data.augment import AugmentConfig, augment_batch, \
        draw_augment, step_seed
    from repro_torch.data.datasets import CIFARSource
    from repro_torch.data.pipeline import DataPipeline

    source = CIFARSource("cifar10", resolution=224)
    host = DataPipeline(global_batch=64, source=source).batch_at(0, 0)
    worst = 0.0
    for mixup, cutmix in ((0.2, 0.0), (0.0, 1.0)):
        acfg = AugmentConfig(num_classes=10, mixup_alpha=mixup,
                             cutmix_alpha=cutmix, mix_prob=1.0)
        draws = draw_augment(torch.Generator().manual_seed(
            step_seed(0, 0, 0)), 64, 224, acfg)
        out = {}
        for dev in ("cuda", "cpu"):
            batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
            out[dev] = augment_batch(draws, batch, acfg,
                                     preproc=source.preproc, resolution=224)
        for k in ("images", "labels"):
            err, ok = close(out["cuda"][k].cpu(), out["cpu"][k], 0.0)
            worst = max(worst, err)
    print(f"[dp] one augmented microbatch (64 x 224 px, Mixup and CutMix) "
          f"on the card against the CPU apply of the same draws: max "
          f"|diff| {worst:.3e} (tol {AUG_TOL})", flush=True)
    if not worst <= AUG_TOL:
        fail("the augmentation apply on the card disagrees with the CPU's")


def dp_rates(profile):
    """Warm training images/s of the one-card Trainer and of the
    data-parallel Trainer at world 1 by ZeRO stage, bf16, batch 128, accum
    2, timed in turns (one card, stages 0-3, 3-0, one card); with
    ``profile``, one warm ZeRO-3 step under torch.profiler."""
    import torch
    from repro_torch.core import distributed
    from repro_torch.core.engine import Trainer

    order = [None] + list(DP_STAGES) + list(reversed(DP_STAGES)) + [None]
    rates = {}
    trainer, pipe = train_setup("bfloat16", True)
    params = new_vit(trainer).params()

    def stage(zero):
        return trainer if zero is None else Trainer(
            trainer.cfg, dataclasses.replace(trainer.ecfg, zero_stage=zero),
            preproc=trainer.preproc, world=world)
    with torchrun_env():
        world = distributed.init_world("cuda")
        try:
            for zero in order:
                rates.setdefault(zero, []).append(
                    train_rate(stage(zero), pipe, params))
                torch.cuda.empty_cache()
            if profile:
                profile_step("vit-b16 --devices 1 --zero 3 (bf16, batch "
                             "128, accum 2)", stage(3), pipe, params)
        finally:
            distributed.close_world()
    for zero, rs in rates.items():
        label = "one card, no process group" if zero is None else \
            f"--devices 1 --zero {zero}"
        ips = sum(r[0] for r in rs) / len(rs)
        ms = sum(r[1] for r in rs) / len(rs)
        print(f"[dp] vit-b16 bf16 warm training, {label}: {ips:.1f} "
              f"images/s, {ms:.2f} ms per optimizer step (batch 128, accum "
              f"2; runs {[round(r[0], 1) for r in rs]} images/s; "
              f"{smi_line()})", flush=True)


def lm_setup(dtype, use_kernels, *, arch, layers, batch=8, accum=2,
             **cfg_kw):
    """A full-width ``arch`` decoder trainer cut to ``layers`` layers (and
    any other config field in ``cfg_kw`` replaced) with the CLI's engine
    settings for 10 steps, and its token pipeline."""
    from repro_torch.configs import EngineConfig, get_config
    from repro_torch.core.engine import Trainer
    from repro_torch.data.pipeline import DataPipeline

    cfg = get_config(arch).replace(
        num_layers=layers, dtype=dtype, use_kernels=use_kernels, **cfg_kw)
    ecfg = EngineConfig(train_batch_size=batch,
                        gradient_accumulation_steps=accum, total_steps=10,
                        warmup_steps=1)
    return Trainer(cfg, ecfg), DataPipeline(
        kind="token", global_batch=batch, vocab=cfg.vocab_size,
        seq_len=LM_SEQ, epoch_size=batch * 10)


def phase_lm_train(profile):
    """The decoder slice: ``--arch chatglm3-6b --layers 4 --seq 1024
    --batch 8 --accum 2 --steps 10`` (per step and microbatch: K1-K3 once a
    layer, K4/K5 twice a layer and once for the final norm)."""
    attn, norms = 10 * 2 * LM_LAYERS, 10 * 2 * (2 * LM_LAYERS + 1)
    return decoder_train("chatglm3-6b", LM_LAYERS, LM_TRAIN_ARGS, {
        "flash_fwd": attn, "flash_bwd_dq": attn, "flash_bwd_dkv": attn,
        "rmsnorm_fwd": norms, "rmsnorm_bwd": norms}, "lm", profile)


def phase_rwkv_train(profile):
    """The RWKV6 slice: ``--arch rwkv6-7b --layers 4 --seq 1024 --batch 8
    --accum 2 --steps 10`` (per step and microbatch: K6 and K7 once a
    layer, K4/K5 twice a layer and once for the final norm, no attention),
    with the fp32 gradient gate taken at the group norm's eps raised to
    RWKV_GATE_EPS; then ``rwkv_after_steps``."""
    wkv, norms = 10 * 2 * RWKV_LAYERS, 10 * 2 * (2 * RWKV_LAYERS + 1)
    launches, hist = decoder_train(
        "rwkv6-7b", RWKV_LAYERS, RWKV_TRAIN_ARGS, {
            "wkv6_fwd": wkv, "wkv6_bwd": wkv, "rmsnorm_fwd": norms,
            "rmsnorm_bwd": norms}, "rwkv", profile, fp32_eps=RWKV_GATE_EPS)
    rwkv_after_steps(hist)
    return launches


def require_kernel_wins(tag, rates):
    """Fail unless every timed kernel-path run of ``rates`` ({"kernel":
    [...], "naive": [...]}, each run (rate, ms)) was faster than every
    naive-path run."""
    if min(r[0] for r in rates["kernel"]) <= \
            max(r[0] for r in rates["naive"]):
        fail(f"{tag}: a timed kernel-path run was not faster than every "
             f"naive-path run")


def decoder_train(arch, layers, argv, expect, tag, profile, fp32_eps=None):
    """A decoder's training slice at full width cut to ``layers`` layers:
    ``argv`` (bf16, batch 8 x LM_SEQ, accum 2, 10 steps) through the CLI
    with the launch counters reset just before and read just after
    (``expect``), every loss and grad-norm finite and ``step_ok`` 1, the
    peak of allocated device memory; then kernel against naive path (plain
    RMSNorm and the naive attention or the chunked WKV6) on one
    microbatch of 4 x LM_SEQ (fp32 within 2e-4; with ``fp32_eps`` the fp32
    agreement at the model's own norm eps is printed ungated and the gate
    holds a copy of the config with ``norm_eps=fp32_eps``; bf16 cosine >=
    0.99), and warm training tokens/s of both paths (every kernel-path run
    faster than every naive-path run, or the phase fails). The previous
    phase's
    tensors are freed first, so two models never stand together. Returns
    (launches, the CLI's metrics rows)."""
    import gc
    import math
    import torch
    from repro_torch.core.engine import to_device
    from repro_torch.models.transformer import init_params

    def free():
        gc.collect()
        torch.cuda.empty_cache()
    free()
    torch.cuda.reset_peak_memory_stats()
    launches, hist = run_cli(argv, expect, f"{arch} train")
    peak = torch.cuda.max_memory_allocated()
    if [r["step"] for r in hist] != list(range(10)):
        fail(f"{arch} train: unexpected rows {hist}")
    for r in hist:
        if not (math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
                and r["step_ok"] == 1):
            fail(f"{arch} train: bad step row {r}")
    print(f"[{tag}] {arch} ({layers} layers, full width) losses "
          f"{[round(r['loss'], 4) for r in hist]}; grad norms "
          f"{[round(r['grad_norm'], 3) for r in hist]}; step_ok all 1; "
          f"wall {hist[-1]['wall_s']} s (cold, init and first steps "
          f"included); torch.cuda.max_memory_allocated "
          f"{peak / 1e9:.2f} GB", flush=True)
    free()

    kw = {"arch": arch, "layers": layers}
    trainer, pipe = lm_setup("bfloat16", True, **kw)
    params = init_params(trainer.cfg, seed=0, device="cuda")
    for dtype in ("float32", "bfloat16"):
        trainer_k, pipe = lm_setup(dtype, True, batch=4, accum=1, **kw)
        trainer_n, _ = lm_setup(dtype, False, batch=4, accum=1, **kw)
        batch = to_device(pipe.batch_at(0, 0), "cuda")
        result = grad_agreement(trainer_k, trainer_n, params, batch, dtype)
        label = f"{arch}, one microbatch of 4 x {LM_SEQ},"
        if fp32_eps is not None and dtype == "float32":
            d_loss, d_grad, cos = result
            print(f"[train] {label} float32 kernel vs naive at the model's "
                  f"norm eps {trainer_k.cfg.norm_eps:g} (a reading, not "
                  f"gated: the group norm amplifies fp32 rounding on "
                  f"head-rows whose variance is near eps): |dloss|="
                  f"{d_loss:.3e}, max|dgrad|={d_grad:.3e}, gradient cosine "
                  f"{cos:.6f}", flush=True)
            trainer_k, _ = lm_setup(dtype, True, batch=4, accum=1,
                                    norm_eps=fp32_eps, **kw)
            trainer_n, _ = lm_setup(dtype, False, batch=4, accum=1,
                                    norm_eps=fp32_eps, **kw)
            result = grad_agreement(trainer_k, trainer_n, params, batch,
                                    dtype)
            label += f" norm eps {fp32_eps:g},"
        report_agreement(label, dtype, result)
        free()
    rates = {}
    for label in ("kernel", "naive", "naive", "kernel"):
        trainer, pipe = lm_setup("bfloat16", label == "kernel", **kw)
        rates.setdefault(label, []).append(train_rate(trainer, pipe, params))
        free()
    for label, rs in rates.items():
        tps = sum(r[0] for r in rs) / len(rs) * LM_SEQ
        ms = sum(r[1] for r in rs) / len(rs)
        print(f"[{tag}] {arch} bf16 warm training, {label} path: "
              f"{tps:.1f} tokens/s, {ms:.2f} ms per optimizer step (batch "
              f"8 x {LM_SEQ}, accum 2; runs "
              f"{[round(r[0] * LM_SEQ, 1) for r in rs]} tokens/s)",
              flush=True)
    require_kernel_wins(arch, rates)
    if profile:
        trainer, pipe = lm_setup("bfloat16", True, **kw)
        profile_step(f"{arch} ({layers} layers, bf16, batch 8 x {LM_SEQ}, "
                     f"accum 2)", trainer, pipe, params)
    return launches, hist


def rwkv_after_steps(hist, steps=(1, 2)):
    """The RWKV6 CLI run's first optimizer steps replayed in process (the
    kernel path in bf16 with RWKV_TRAIN_ARGS' seed, stream and settings).
    At the params after each of ``steps`` steps, on the first microbatch
    (4 x LM_SEQ) of the next step's batch:
    - K6/K7 against ``ref_wkv6_fwd``/``ref_wkv6_bwd`` on the WKV6 inputs
      the bf16 kernel path gave K6 and the output cotangent its backward
      gave K7, each output within WKV_REL_TOL of its largest plain value;
    - fp32 kernel against naive path with the norm eps at RWKV_GATE_EPS,
      max |dgrad| within 2e-4 (the gate);
    - as readings: the smallest group-norm input variance of the bf16
      forward beside the model's eps, the gradient norms and cosines of
      bf16 kernel against bf16 naive path, bf16 against fp32 kernel path,
      and fp32 kernel against naive path at the model's eps; the CLI run's
      grad norm of that step (``hist``, the whole batch) beside them."""
    import gc
    import torch
    from repro_torch.core.engine import to_device
    from repro_torch.core.grad_accum import split_microbatches
    from repro_torch.kernels import wkv6 as wk
    from repro_torch.kernels.ref import ref_wkv6_bwd, ref_wkv6_fwd
    from repro_torch.models import rwkv6
    from repro_torch.models.transformer import init_params

    kw = {"arch": "rwkv6-7b", "layers": RWKV_LAYERS}
    trainer, pipe = lm_setup("bfloat16", True, **kw)
    state = trainer.init_state(init_params(trainer.cfg, seed=0,
                                           device="cuda"))
    trainers = {"bfloat16": {}, "float32": {}, "gate": {}}
    for dtype, paths in trainers.items():
        for kernels in (True, False):
            paths[kernels] = lm_setup(
                "float32" if dtype == "gate" else dtype, kernels, batch=4,
                accum=1, **kw,
                **({"norm_eps": RWKV_GATE_EPS} if dtype == "gate" else {}))[0]
    wkv6, groupnorm = rwkv6.wkv6, rwkv6.groupnorm_heads
    calls, variances = [], []

    def spy_wkv6(r, k, v, wlog, u, s0, *, chunk):
        o, s_end = wkv6(r, k, v, wlog, u, s0, chunk=chunk)
        rec = {"xs": [x.detach().clone() for x in (r, k, v, wlog, u, s0)],
               "chunk": chunk}
        o.register_hook(lambda g: rec.update(do=g.detach().clone()))
        calls.append(rec)
        return o, s_end

    def spy_groupnorm(x, *a):
        var = x.detach().float().var(-1, unbiased=False)      # (B,S,H)
        at = int(var.argmin())
        variances.append((var.min().item(),
                          at // var.shape[2] % var.shape[1]))
        return groupnorm(x, *a)

    names = ("o", "s_end", "states", "dr", "dk", "dv", "dwlog", "du", "ds0")
    for step in range(max(steps)):
        state, m = trainer.train_step(
            state, to_device(pipe.batch_at(0, step), "cuda"))
        if not m["step_ok"]:
            fail(f"rwkv6-7b replay: step {step} was skipped by the guard")
        n = step + 1
        if n not in steps:
            continue
        batch = split_microbatches(
            to_device(pipe.batch_at(0, n), "cuda"), 2)[0]
        label = f"rwkv6-7b after {n} replayed step(s), microbatch 4 x {LM_SEQ}"
        calls.clear()
        variances.clear()
        rwkv6.wkv6, rwkv6.groupnorm_heads = spy_wkv6, spy_groupnorm
        try:
            g16, _ = trainers["bfloat16"][True].grads(state.params, batch)
        finally:
            rwkv6.wkv6, rwkv6.groupnorm_heads = wkv6, groupnorm
        worst = dict.fromkeys(names, 0.0)
        ok = len(calls) == RWKV_LAYERS and all("do" in c for c in calls)
        for rec in calls:
            r, k, v, w, u, s0 = rec["xs"]
            cs, do, dse = rec["chunk"], rec["do"], torch.zeros_like(s0)
            o, se, st = wk.wkv6_fwd(r, k, v, w, u, s0, chunk=cs,
                                    with_states=True)
            got = (o, se, st) + tuple(wk.wkv6_bwd(r, k, v, w, u, st, do, dse,
                                                  chunk=cs))
            want = ref_wkv6_fwd(r, k, v, w, u, s0, chunk=cs,
                                with_states=True)
            want = tuple(want) + tuple(ref_wkv6_bwd(
                *[x.float() for x in (r, k, v, w)], u, want[2], do, dse,
                chunk=cs))
            for name, a, b in zip(names, got, want):
                top = b.float().abs().max().item()
                rel = (a.float() - b.float()).abs().max().item() / top \
                    if top > 0 else a.float().abs().max().item()
                worst[name] = max(worst[name], rel)
                ok = ok and rel <= WKV_REL_TOL[str(a.dtype)[6:]] and \
                    bool(torch.isfinite(a).all())
        calls.clear()
        print(f"[rwkv] {label}: K6/K7 on the bf16 kernel path's own WKV6 "
              f"inputs and output cotangent ({RWKV_LAYERS} calls), max "
              f"|got - plain| / max |plain|: "
              + " ".join(f"{key} {x:.3e}" for key, x in worst.items())
              + f" (tol {WKV_REL_TOL} by the output's dtype) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"K6/K7 disagree with their plain versions on the model's "
                 f"inputs after {n} step(s)")
        var, pos = min(variances)
        g32, _ = trainers["float32"][True].grads(state.params, batch)
        readings = {"bf16 kernel vs fp32 kernel": compare_grads(
            g16, g32, "bf16 kernel path")}
        gn, _ = trainers["bfloat16"][False].grads(state.params, batch)
        readings["bf16 kernel vs bf16 naive"] = compare_grads(
            g16, gn, "bf16 kernel path")
        del g16, gn
        gn, _ = trainers["float32"][False].grads(state.params, batch)
        readings["fp32 kernel vs fp32 naive"] = compare_grads(
            g32, gn, "fp32 kernel path")
        del g32, gn
        print(f"[rwkv] {label} (readings, not gated): smallest group-norm "
              f"input variance {var:.3e} at position {pos} (norm eps "
              f"{trainer.cfg.norm_eps:g}); " + "; ".join(
                  f"{key}: cosine {c:.6f}, max|dgrad| {d:.3e}, grad norms "
                  f"{na:.3f} / {nb:.3f}"
                  for key, (d, c, na, nb) in readings.items())
              + f"; the CLI run's grad norm at step {n} (batch 8 x "
              f"{LM_SEQ}): {hist[n]['grad_norm']:.3f}", flush=True)
        report_agreement(f"{label}, norm eps {RWKV_GATE_EPS:g},", "float32",
                         grad_agreement(trainers["gate"][True],
                                        trainers["gate"][False],
                                        state.params, batch, "float32"))
    del state
    gc.collect()
    torch.cuda.empty_cache()


def main():
    card = phase_card()
    sys.path.insert(0, str(ROOT / "src"))
    phase_build()
    k1 = phase_k1(card.split(",")[0])
    vit_rows = [k1] + phase_k23(card.split(",")[0])
    rms_rows = phase_rms(card.split(",")[0])
    lm_attn = phase_lm_attention(card.split(",")[0])
    wkv_rows = phase_wkv6(card.split(",")[0])
    profile = "--profile" in sys.argv[1:]
    phase_slice()
    vit_launches, vit_hist = phase_train(profile)
    dp_launches, aug_launches, f32_ref = phase_dp(vit_hist, profile)
    resume_launches = phase_ckpt(vit_hist, f32_ref)
    data_launches = phase_data(vit_hist)
    phase_quickstart()
    lm_launches, _ = phase_lm_train(profile)
    rwkv_launches = phase_rwkv_train(profile)
    if profile:
        profile_eval()
    # K1-K3 run on both training paths: the row's numbers are the
    # decoder's (this slice's path), with the ViT's beside them under "vit"
    kernels = []
    for row, key in zip(vit_rows, ("fwd", "dq", "dkv")):
        vit = {k: v for k, v in row.items()
               if k not in ("name", "route", "source", "replaces")}
        vit["launches"] = vit_launches[row["name"]]
        # the same training slice data-parallel (one rank, NCCL) by ZeRO
        # stage, and augmented at stage 0
        vit["dp_launches"] = {f"zero{z}": n[row["name"]]
                              for z, n in dp_launches.items()}
        vit["dp_launches"]["zero0_augment"] = aug_launches[row["name"]]
        # the training slice preempted after 5 steps and resumed (phase 8c)
        vit["resume_launches"] = {run: n[row["name"]]
                                  for run, n in resume_launches.items()}
        # the training slice without the prefetcher, with a retried data
        # fault, and from shards (phase 8d)
        vit["data_launches"] = {run: n[row["name"]]
                                for run, n in data_launches.items()}
        if row["name"] in REDESIGNED:
            row = dict(row, redesigned=True, routes=ROUTES[row["name"]])
        kernels.append(dict(row, **lm_attn[key],
                            launches=lm_launches[row["name"]], vit=vit))
    # K4-K7's launches are the RWKV6 run's; K4/K5 run on both decoder
    # paths, so their rows carry the ChatGLM3 run's beside them
    for row in rms_rows + wkv_rows:
        extra = {"launches": rwkv_launches[row["name"]]}
        if row in rms_rows:
            extra["chatglm3_launches"] = lm_launches[row["name"]]
        if row["name"] in REDESIGNED:
            extra.update(redesigned=True, routes=ROUTES[row["name"]])
        kernels.append(dict(row, **extra))
    print(json.dumps({"kernels": kernels}))
    print(card)
    import torch
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
