#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: builds the CUDA kernels
from this checkout, holds each against its plain PyTorch version, drives
the port's main paths (ViT-B/16 eval and training, one card and
data-parallel under ZeRO 0-3 with augmentation, preempted and resumed from
checkpoints and supervised under injected faults, ChatGLM3-6B, RWKV6-7B,
Gemma3-12B, Qwen2.5-14B, GLM-4-9B and Granite-MoE 3B-A800M training, and
serving Qwen2.5-14B, HuBERT-XLarge and Zamba2-2.7B training and Zamba2
serving, ViT-B/16 and ChatGLM3-6B through the 1F1B pipeline and
tensor-parallel, ranks sharing the card) at full width through its CLI,
and DeepSeek-V3 (MLA and the multi-token
prediction head) and Qwen2-VL-72B training and six models' prefill and
decode at full width in process, and checks the results.

    python3 chip_smoke.py [--profile]

Phases (any failure exits non-zero and prints no ``ok`` line):

1. card: a CUDA device must be present; prints its name and power limit.
2. build: compiles every kernel (``kernels/build.py``), timed, and prints
   each kernel's ``-Xptxas -v`` registers and spills. From here on a draw
   of params onto the card that repeats the draw before it (the same seed
   and ordered param shapes, whatever the dtype or routes) copies that
   draw's host tensors (``share_draws``; the same values, without a
   second host draw of up to 3.5 B params); each fresh draw prints its
   time.
   DeepSeek-V3's and Qwen2-VL-72B's params (3.5 and 3.4 B, each drawn once
   and used by gates that compare two paths on the same params) are drawn
   on the card (``init_params(draw_on="cuda")``) and copied to the host,
   and so, since PR 29, are ChatGLM3-6B's, Gemma3-12B's, Qwen2.5-14B's and
   GLM-4-9B's (``CARD_DRAWS``: every gate on them compares two paths, or
   ranks, on one draw); RWKV6's, whose fp32 gate failed on a card's draw,
   and every other model's stay on the host.
3. K1 against ``ref_attention`` on the card, at the ViT-B/16 eval shape,
   the smoke shape, ragged S (1, 63, 130, 197), causal, GQA (groups of 4
   and of 5, the odd one also at D 256), windowed (also with S > T, rows
   with no live key) and D 32, 128 and 256 cases (D 256 ragged, causal
   with a window of 100 and with S > T), each
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
   decoder's shape (4096 x 4096), Gemma3's (4096 x 3840), Qwen2.5's
   (4096 x 5120), Granite-MoE's (4096 x 1536) and DeepSeek-V3's (2048 x
   7168, 2048 x 1536, and 2048 x 512 in rows 576 apart: kv_norm's slice
   of the w_dkv output) and Zamba2-2.7B's (8192 x 2560 and 5120 in
   training, 2048 x 2560 and 5120 in its serve prefill) rows, the smoke
   shape, the reference's
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
6a. K1-K3 at Gemma3-12B's attention shape (B 1, H 16, KH 8, S = T = 4096,
   D 256, causal) with a local layer's window of 1024 and with the global
   layer's none, against their plain versions in bf16 and fp32, K2 and K3
   each run twice for bitwise equal results, then timed at the window as in
   phase 4 (SDPA with ``enable_gqa`` and the window's boolean mask; the
   bounds count the live pairs under the window).
6b. K6 (with and without states) and K7 against ``ref_wkv6_fwd``/
   ``ref_wkv6_bwd`` at the RWKV6 slice's shape (B 4, S 1024, H 64, P 64,
   chunk 32; bf16 r/k/v with fp32 wlog, and fp32), the smoke shape, the
   reference's WKV_CASES and strong decay (o and s_end within 5e-4 / 5e-2,
   gradients 1e-3 / 0.3 with bf16 against the fp32 oracle, states 5e-4,
   o also against the sequential ``ref_wkv6`` where S <= 128), K7 twice for
   bitwise equal gradients, ``torch.autograd.grad`` through ``ops.wkv6``
   (ragged, padded; P 48 with chunk 24, padded to P 64 and run at chunk
   16, ROADMAP F2; and the slice's shape with no copy or pad); then both
   timed at the slice's shape beside their plain versions and bounds,
   with the bytes each kernel's two launches (K6: the state scan, then
   the chunks' outputs; K7: the state-gradient scan, then the chunks'
   adjoints) move as designed.
6c. K1-K3 at head dim 80 (HuBERT-XLarge's and Zamba2-2.7B's) and at the
   smoke MLA pair (D 48, Dv 32) against their plain versions in bf16 and
   fp32 (phase 3's gates), K2 and K3 each run twice for bitwise equal
   results: HuBERT's attention (B 8, H = KH 16, S = T 781 = 12 x 64 + 13,
   non-causal, the model's layout), Zamba2's shared block (B 2, H = KH
   32, S = T 4096, causal) and (48, 32) at B 2, H 4, KH 2, S 300 causal
   and non-causal; (D, Dv) = (40, 24) and (96, 96), pairs no kernel is
   built for, which the wrappers pad to (48, 32) and (128, 128) (ROADMAP
   F2); then K1-K3 timed at both D 80 shapes beside their plain
   versions, SDPA and the bounds.
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
   the kernel and the naive path (fp32 within 2e-4; bf16 cosine >= 0.99);
   the 1-bit AdamW (``optim/onebit.py``): 5 updates of that fp32
   microbatch from the engine's gradients, the loss falling, the last
   update within 1e-6 of the same update on host copies; and warm
   training images/s of both paths, every kernel-path run faster than
   every naive-path run. (a) One more step of each path, not timed, the
   guard off, under the dry run's op counter (``launch/op_count.py``; the
   kernels charge their analytic work): its FLOPs and bytes equal, exactly,
   the same step counted on ``meta`` as the dry run counts it (the
   microbatches by their trip count); the dry run's bound on one rank
   printed beside the measured ms a step, and its peak beside the card's
   (``max_memory_allocated`` less what else the card held), the ratio
   within COUNT_PEAK_RATIO.
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
   its own processes, started first and run beside the two runs above
   (exit 0, a second attempt, the guard's skip, step 8
   failing verification and the resume from step 6, the last attempt's
   losses within 1e-5 and every printed loss at its 4 decimals, the eval
   counts, each fault once in ``faults.jsonl``; its log in
   ``chiprun_out/chaos.log``); then the checkpoint's logical and saved
   bytes and the host time of an async save's snapshot, its background
   write, a sync save and a restore of the bf16 training state, recorded
   beside the card's name and power limit, not gated, once the chaos run
   has ended. Each part's seconds print.
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
   ``to_device`` in turns. The port's quickstart (``python -m
   repro_torch.examples.quickstart``, smoke size, in its own process,
   started beside phase 8c and waited for before this phase) exits 0
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
11. the dense-decoder family's slice: ``--arch gemma3-12b --layers 6 --seq
   4096 --batch 2 --accum 2 --steps 10`` in bf16 (five local layers with a
   window of 1024 and one global, head dim 256, the tied 262,144-token
   embedding) with the counters reset just before and read just after
   (K1-K3 10 x 2 x 6 = 120 each, K4 and K5 10 x 2 x 13 = 260 each); every
   loss and grad-norm finite and ``step_ok`` 1; the peak of allocated
   device memory; kernel against naive path on one microbatch of 1 x 2048
   (past the window; fp32 within 2e-4, bf16 cosine >= 0.99); warm
   training tokens/s of both paths in turns in micro-batches of 1 x 2048
   (the naive path does not fit at 4096 beside the AdamW state), every
   kernel-path run faster, and of the kernel path at 4096; then three
   steps with ``remat="block"`` and
   with ``"dots"`` against ``"none"`` from the same params and batches
   (losses within 1e-5, peak memory of each, K1 72 and K4 150 launches
   with the recompute against 36 and 78 without).
12. Qwen2.5-14B and GLM-4-9B at full width, two layers each: ``--layers 2
   --seq 1024 --batch 8 --accum 2 --steps 3`` (K1-K3 12 launches each,
   K4/K5 30), finite losses, ``step_ok`` 1, peak memory; K1-K3 at
   Qwen2.5's attention shape (B 4, H 40, KH 8, S = T = 1024, D 128,
   causal: a GQA group of 5, K3's unsplit grid) against their plain
   versions in bf16 and fp32, K2 and K3 run twice for bitwise equality
   (GLM-4's shape is phase 6's); kernel against naive path of each model
   on one microbatch of 4 x 1024 (fp32 within 2e-4, bf16 cosine >= 0.99).
13. Granite-MoE 3B-A800M, the MoE decoder, at full width: K1-K3 at its
   attention shape (B 4, H 24, KH 8, S = T = 1024, D 64, causal: a GQA
   group of 3) against their plain versions in bf16 and fp32, K2 and K3
   run twice for bitwise equality, timed beside SDPA (``enable_gqa``) and
   the bounds; ``--arch granite-moe-3b-a800m --layers 8 --seq 1024 --batch
   8 --accum 2 --steps 10`` in bf16 with the GShard dispatch (K1-K3 10 x 2
   x 8 = 160 each, K4/K5 10 x 2 x 17 = 340 each), every loss, grad norm
   and ``moe_aux`` finite, ``moe_aux`` > 0, ``step_ok`` 1, the peak of
   allocated device memory; kernel against naive path on one microbatch
   of 4 x 1024, each path routing on its own first, the (token, choice)
   routings and kept slots that differ printed by layer (a flip is a
   discontinuity, not a fault); fp32: where any differ, the naive path
   again with the kernel path's expert indices forced, its kept slots
   then equal in every layer, and max |dgrad| within 2e-4; bf16: cosine
   >= 0.99 on the paths' own routings; warm tokens/s
   of both paths in turns, every kernel-path run faster; gather against
   GShard dispatch on one fp32 microbatch at capacity factor 8 on two
   layers (logits within 2e-5, grads 5e-5); warm tokens/s of the GShard
   and gather dispatch in turns (recorded, not gated); one MoE layer's
   routing, dispatch, expert products and combine timed alone (a
   reading).
14. DeepSeek-V3's multi-head latent attention and MTP head: K1-K3 at its
   attention shape (B 2, H = KH = 128, S = T = 1024, q/k head dim 192,
   v head dim 128, causal; V not padded) against their plain versions in
   bf16 and fp32 in the model's layout, K2 and K3 run twice for bitwise
   equality, then ragged (S = T = 197, 1000), non-causal (contiguous
   tensors), windowed and GQA (K3's group split) cases at (192, 128),
   ``torch.autograd.grad`` through ``flash_mha`` at the MLA shape, and
   the three timed beside SDPA (its backends that take Dv != D named) and
   the bounds; then ``deepseek-v3-671b`` at full width cut to one MoE
   layer of 16 routed experts (3.476 B params; the CLI has no flag for the
   expert count, so the port's ``Trainer`` runs in process): 10 steps in
   bf16 at batch 2 x 1024, accum 1, GShard, with the counters reset just
   before and read just after (K1-K3 10 x 2 = 20 each: the layer and the
   MTP block; K4/K5 10 x 12 = 120 each: ln1, q_norm, kv_norm, ln2, the
   final norm and the MTP head's seven), no layout copy (the kv_norm rows
   are read at their 576-element stride), every loss, grad norm and
   ``moe_aux`` finite, ``moe_aux`` > 0, ``step_ok`` 1, the MTP term
   printed (the first batch's next-token and MTP cross-entropies against
   step 0's loss less ``moe_aux``), the peak of allocated device memory
   beside the prediction; kernel against naive path on one microbatch of
   1 x 1024 from the initial params, routing differences printed (fp32
   within 2e-4 on the kernel path's forced routing, every ``mtp.*`` leaf
   included; bf16 cosine >= 0.99); warm tokens/s of both paths in turns
   (a reading, not gated).

15. serving and Qwen2-VL: K1 at the prefill shapes, where the prompt's S
   queries attend over a cache of T > S rows whose tail is zeros (causal,
   upper-left aligned: Qwen2.5's serve run, B 4, H 40, KH 8, S 512, T 576,
   D 128; Gemma3's local layers past the window, B 1, H 16, KH 8, S 1100,
   T 1104, D 256, window 1024; MLA's, B 2, H = KH = 128, S 1024, T 1032,
   D 192, Dv 128; Zamba2's serve run, B 4, H = KH 32, S 512, T 576, D
   80) against ``ref_attention`` in bf16 and fp32 (phase 3's gates), K4
   at a decode step's rows (4 x 5120, 1 x 8192, 2 x 7168; Zamba2's 4 x
   2560, 2 x 2560 and 2 x 5120) against ``ref_rmsnorm_fwd``, and K1 timed at Qwen2.5's prefill beside
   SDPA and the bound over the live pairs; then ``python -m
   repro_torch.launch.serve --arch qwen2.5-14b --layers 4 --batch 4
   --prompt-len 512 --gen 64`` (fp32) in process with the counters reset
   just before and read just after (K1 4: the prefill's layers, the
   decode steps take the naive sdpa; K4 (2 x 4 + 1) x 64 = 576; nothing
   else), its two ``[serve]`` lines; then, at full width,
   Qwen2-VL-72B (one layer, batch 2, a prompt of 1024 with
   512 image embeddings and a (t, h, w) grid), DeepSeek-V3 as phase 14
   cuts it (no MTP head, capacity factor 8: the absorbed decode),
   Gemma3-12B (six layers, a prompt of 1100 past the window), Granite-MoE
   (two layers, capacity factor 8) and RWKV6-7B (two layers; its fp32
   gate at norm eps 1e-3, its fp32 reading at the model's eps printed,
   ungated): train-mode logits of the whole sequence against the
   prefill's and four decode steps' (fp32 max |d| within 5e-4, bf16
   cosine >= 0.99;
   the prefill through K1 once a layer, K6 for RWKV6 from the cache's
   state, the decode steps through neither); then Qwen2-VL-72B training
   at full width cut to one layer (3.369 B params) through the ``Trainer``:
   3 bf16 steps at batch 2 x 1024 with 512 image embeddings (K1-K3 3
   launches each, K4/K5 9 each), losses finite, ``step_ok`` 1, the peak
   beside its prediction, warm tokens/s, and kernel against naive
   gradients on the first batch (fp32 within 2e-4, bf16 cosine >= 0.99);
   then readings, not gated: warm prefill ms and decode tokens/s of
   Qwen2.5-14B at four layers in process (bf16 at batch 4 and 32, fp32 at
   4), one decode step's device time (CUDA events), host time and busy
   share of the decode loop in each dtype, and one bf16 step under
   ``torch.profiler``.

16. HuBERT-XLarge at full width cut to 12 of 48 layers (0.24 B params;
   the time limit's cut) through the CLI: ``--arch hubert-xlarge --layers
   12 --seq 781 --batch 16 --accum 2 --steps 4`` in bf16 (the audio
   batches drawn each step by ``concrete_batch``) with the counters reset
   just before and read just after (K1-K3 4 x 2 x 12 = 96 each, no
   K4/K5: LayerNorm), every loss
   and grad norm finite, ``step_ok`` 1, the peak; then, from params of
   seed 0, kernel against naive path on one microbatch of 8 x 781 (fp32
   within 2e-4, bf16 cosine >= 0.99) and warm frames/s of both paths in
   turns, every kernel-path run faster (the decoders' training harness,
   fed the CLI's audio batches).
17. Zamba2-2.7B at full width cut to 12 of 54 layers (two groups of 6, the
   shared block used twice): ``--arch zamba2-2.7b --layers 12 --seq 4096
   --batch 4 --accum 2 --steps 3`` in bf16 (K1-K3 3 x 2 x 2 = 12 each, K4
   and K5 3 x 2 x (12 x 2 + 2 x 2 + 1) = 174 each: each layer's norm and
   its inner RMSNorm at 5120, the shared block's two norms a use, the
   final norm), finite, ``step_ok`` 1, the peak; then from params of seed
   0 (the decoders' training harness, the kernel path's rate alone): kernel
   against naive path on one microbatch of 2 x 4096 (``shared_attn.*`` included; the gates above), warm
   tokens/s, one warm step's device time under ``torch.profiler`` beside
   the eager SSD scan's forward and backward alone (also profiled) times
   the layers and microbatches (a reading), prefill of 300 tokens and 4
   decode steps against train-mode logits (fp32 5e-4, bf16 cosine 0.99;
   K1 once a group in the prefill, none in decode), and ``python -m
   repro_torch.launch.serve --arch zamba2-2.7b --layers 12 --batch 4
   --prompt-len 512 --gen 64`` (fp32) on the same params with the counters
   read around it (K1 2, K4 64 x 29 = 1,856).
18. pipeline parallelism (run after phase 8d and the quickstart): the
   1F1B executor with every stage in this process on the one card,
   ViT-B/16 at full width (12 layers). (a) ``--batch 128 --accum 4
   --steps 6`` in bf16 at ``--pp 1`` (K1-K3 6 x 4 x 12 = 288 each) and at
   ``--pp 2``, ``--pp 4`` and ``--pp 2 --pp-interleave 3`` (K1 576: the
   forward slot and the backward slot's recompute; K2/K3 288), finite,
   ``step_ok`` 1, the largest loss difference from ``--pp 1`` printed; (b)
   fp32 ``--batch 32 --accum 4 --steps 3`` at the same layouts and as rank
   0 of a torchrun world of one (``--devices 1 --pp 2``) at ZeRO 0 and 3,
   losses and grad norms within 3e-4 of ``--pp 1``; (c) an fp32 ``--pp 2
   --stop-after 2`` checkpoint under ``build/`` (removed after) resumed at
   ``--pp 1``, step 2 within 1e-5 of the uninterrupted ``--pp 2`` run;
   (d) one bf16 step at a microbatch of 32 with 2 stages at M = 4 and 8:
   the peak of allocated memory at M = 8 at most 1.05 times M = 4's; the
   executor alone on the next batch: its growth over the memory allocated
   before it at M = 8 less than one residual (a chunk input) above M =
   4's, and its live residuals per stage at the caps [2, 1]; (e) warm
   images/s of ``--pp 1/2/4`` and the interleaved layout, one turn each
   (the median of 3 steps timed alone, and their spread), beside the
   analytic bubble, and one profiled step of ``--pp 1`` and of the
   interleaved layout: its device time against its wall time (recorded:
   the step is host-bound, and on one card the stages share the device,
   so the bubble is no idle time); (f) ``--arch chatglm3-6b --layers 4
   --seq 1024 --batch 8 --accum 4 --steps 3 --pp 2`` in bf16 (K1 96, K2
   and K3 48, K4 3 x 4 x 2 x 9 = 216, K5 108), finite, ``step_ok`` 1; (g)
   ``--devices 2 --pp 2`` on one card raises its clear error.
19. tensor parallelism (run last, after phase 17, on the training phases'
   host draws), every rank on the one card:
   ranks spawned over gloo (``distributed.spawn(backend="gloo")``: NCCL
   refuses two ranks on one card, so each collective is staged through
   host memory), each running the training CLI's ``run``. (d) K1-K3 at a
   model-axis-4 rank's shape of ChatGLM3-6B (B 2, H 8, one KV head
   sliced from the (B, S, 2, D) projection, S = T = 1024, D 128, causal)
   against their plain versions in bf16 and fp32 (phase 3's gates, K2 and
   K3 twice for bitwise equality); ``--arch chatglm3-6b --layers 4 --seq
   1024 --batch 2 --accum 1 --steps 2 --dtype float32`` at ``--model-axis
   1`` in process (K1-K3 8, K4/K5 18); then a world of 2 (its ranks and
   those of the world of 4 read the parent's draws from
   ``build/tp-draw.pt``, memory-mapped, and copy only their chunks to the
   card): ViT-B/16 fp32
   (phase 8b's ``--steps 3 --batch 16 --accum 2``) at ``--model-axis 2``,
   bf16 ``--steps 3 --batch 128 --accum 2 --eval-every 3`` at
   ``--model-axis 2`` (K1 72 + 48, K2/K3 72 a rank; the eval counts equal
   on both ranks) and ChatGLM3-6B at ``--model-axis 2``; and a world of 4:
   the fp32 ViT at data 2 x ``--model-axis 2 --zero 3`` and ChatGLM3-6B at
   ``--model-axis 4`` (D6: the KV projections whole, each rank slicing the
   KV head its 8 query heads use). (f)-(h), in both worlds at model axis
   2 and 4, fp32, ``--seq 1024 --batch 2 --accum 1 --steps 2``, each
   against its own run at ``--model-axis 1`` in process (one reference
   for both axes), on the training phases' seed-0 host draws cut to their
   layers (Zamba2's from phase 17, Granite's and RWKV6's as phase 15
   decodes them; the ranks copy them from ``build/tp-draw.pt``, removed
   after): (f) Zamba2-2.7B at 6 layers, one group (D7: ``w_in``, the conv
   and the head vectors whole, each rank slicing its heads'; K1-K3 2 at
   D 80 with 16 or 8 heads a rank, K4/K5 18, the split-row K4/K5 and
   their partial passes 12 at the inner norm, 2048 rows of 2560 or 1280
   columns a rank); (g) Granite-MoE 3B-A800M at 2 layers, GShard and
   gather (``moe_impl``, which the CLI has no flag for, set on its
   config): 20 or 10 experts a rank, K1-K3 4 with (12, 4) or (6, 2)
   heads, K4/K5 10, the (token, choice) routings that differ from one
   rank's printed; (h) RWKV6-7B at 2 layers with the group norm's eps at
   1e-3 (phase 10's fp32 gate condition) and ``--optimizer sgd`` (AdamW's
   first step is lr·sign(g), and near-zero entries flip sign between two
   orders of summation): K6/K7 4 at 32 or 16 heads a rank, K4/K5 10. (i)
   the split-row K4/K5 at Zamba2's inner norm (2048 x 5120 split 2 and 4
   ways, each part a column slice of the whole rows), bf16 and fp32,
   against their plain split versions and the whole-row K4/K5 (phase 5's
   gates), then timed at a model-axis-2 rank's part beside the plain
   versions and bounds. (j) DeepSeek-V3 at full width, cut as phase 14
   cuts it (one MoE layer of 16 routed experts, the shared expert, the
   MTP head; 3.476 B params), fp32, ``--seq 1024 --batch 2 --accum 1
   --steps 2 --optimizer sgd`` (one fp32 moment), at ``--model-axis 1`` in
   process and at model axis 2 and 4 in the two worlds, on phase 14's
   draw: MLA's H/M heads (64 or 32) through K1-K3 at (D 192, Dv 128), 4
   each, K4/K5 24 (``q_norm`` and ``kv_norm`` whole on every rank), the
   routings that differ from one rank's printed; a rank's state on the
   card after init must be its own chunks (no rank holds the whole draw);
   the two DeepSeek runs never share the card with a large job (the world
   of 4 runs its own first while the world of 2 runs its fp32 ViT job,
   then the world of 2 its own while the world of 4 runs its ViT jobs); K1-K3 at MLA's shape at a
   rank's 64 and 32 heads checked against their plain versions (phase 3's
   gates) and timed beside SDPA and the bounds. (k) pipeline x tensor
   parallelism in the world of 4 (pipe 2 x model 2): the fp32 ViT run and
   ChatGLM3-6B at 4 layers, ``--batch 2 --accum 2``, flat and
   ``--pp-interleave 2``, against their one-rank runs; each rank runs its
   stage's layers only (ViT: K1 72, K2/K3 36; ChatGLM3: K1 16, K2/K3 8,
   K4 32 and K5 16 on stage 0, 40 and 20 with the final norm on stage 1).
   On every rank the K1-K7 and split-row launches
   are exact (the ViT's fp32 72 each, ChatGLM3's K1-K3 8 and K4/K5 18),
   no layout copy, the (query, KV) heads ``flash_mha`` sees ((6, 6), (16,
   1) or (8, 1), and the families' above) and the heads ``wkv6`` sees,
   every loss and grad norm finite, ``step_ok`` 1, the fp32 losses and
   grad norms within 3e-4 of one rank's (phase 8b's run for the ViT),
   and a rank's peak memory printed. The bf16 run's warm images/s is
   printed as a host-staged reading, not gated. (l) Ulysses sequence
   parallelism (``--seq-parallel ulysses``): the fp32 ViT run at model
   axis 2 (197 rows split 99/98, 6 heads a rank) in the world of 2 and 4
   (50/49/49/49, 3 heads) in the world of 4, and ChatGLM3-6B's fp32 run at
   model axis 2 (16 query heads and 1 KV head a rank; after the DeepSeek-V3
   model-2 job, the world of 4 waiting for it), each against its one-rank
   run (3e-4), a rank's K1-K5 launches and heads exact; a rank's peak
   printed beside the tensor-parallel job's at the same model axis. (b)
   For COUNTED_JOBS (the ViT at data 2 x model 2 under ZeRO 3, ChatGLM3-6B
   under Ulysses at model 2 and at pipe 2 x model 2) each rank's
   ``count_collectives()`` of the job's first step equals, exactly, a
   recording world's count of the same step for the same rank and layout
   (``core/distributed.py::RecordingWorld`` on ``meta``, the dry run's).
   (e) ``--devices 2 --model-axis 2`` through the CLI on one card raises
   its clear error. (m) serving across ranks (``serve_jobs``, at the end
   of each world); (m4) DeepSeek-V3's decode at model 2 and 4, and at
   model 4 with a cache of 2 x 1024 rows (rank 3 holds no live row): its
   latent cache split on the sequence (a distributed flash-decoding),
   every rank's fp32 logits within 3e-4 of one rank's, a rank's latent
   cache 1/M of the whole and the first decode step's collective bytes
   equal to a recording world's. (o) ``embed_sharding="dmodel"`` (each
   model rank its feature columns of ``embed.tok``; a tied head a
   row-parallel product) at model axis 2, at the end of the world of 2:
   Gemma3-12B's 19m2 decode (fp32 logits within 5e-4 of one rank's, the
   same greedy tokens), and Gemma3-12B (tied) and Qwen2.5-14B (untied) at
   full width, 2 layers, fp32, 2 SGD steps of 2 x 256 through the
   ``Trainer`` on the card's seed-0 draw: every rank's losses and grad
   norms within 5e-5 of the parent's one-rank run, its gradient columns
   of ``embed.tok`` within 5e-5 and 1e-2 of their largest magnitude of
   the one-rank gradient's (taken before the counts are set to 0), its
   K1-K5 launches and heads exact.

``--profile`` adds a ``torch.profiler`` table of one warm training step of
each training slice (DeepSeek-V3's included, and the ZeRO-3 step at world
1), and at the end (after every timed phase) of one warm bf16 eval pass of
the eval slice.
The last lines are one JSON object for the kernels (K1-K3 with the
decoder's numbers and the ViT's under ``vit``, Gemma3's attention times and
its training run's launches under ``gemma3`` and ``gemma3_launches``, the
Qwen2.5 and GLM-4 runs' under ``dense_launches``, Granite-MoE's attention times and
its training run's launches under ``granite`` and ``granite_launches``,
DeepSeek-V3's MLA attention times and its training run's launches under
``deepseek`` and ``deepseek_launches``, K1's time at the serve run's
prefill and that run's launches under ``serve`` and ``serve_launches``,
Qwen2-VL training's under ``qwen2vl_launches``, HuBERT's and Zamba2's
attention times at head dim 80 with their training runs' launches under
``hubert`` and ``zamba2`` and Zamba2's serve run's under
``zamba2_serve_launches``, the ``--pp 2`` ChatGLM3 run's under
``pipeline_chatglm3_launches`` (K1-K5), phase 19's runs at model axis 2
and 4 (and ChatGLM3's at pipe 2 x model 2, each stage's) under
``tp_chatglm3_launches``, ``tp_zamba2_launches``, ``tp_granite_launches``
(GShard and gather), ``tp_rwkv6_launches`` and ``tp_deepseek_launches``
(a rank's, on every kernel's row; the Ulysses runs among them, their
labels naming ``--seq-parallel ulysses``), 19o's "dmodel" training runs'
under ``tp_embed_dmodel_launches`` and K1-K3's errors at a model-axis-4
rank's shape under ``tp_rank_shape``, and at MLA's shape at a rank's 64
and 32 heads (times, bounds, plain, SDPA, errors) under ``tp_mla``,
the data-parallel runs' launches there under ``dp_launches``, the ``--pp
2`` ViT run's under ``pipeline_launches``, the phase's warm rates under
``pipeline_images_per_s`` and phase 19's ViT runs' under
``tp_launches``, the preempted and resumed runs'
under ``resume_launches`` and phase 8d's under ``data_launches``, K4/K5
with the RWKV6 run's launches and the decoder's, Gemma3's, Qwen2.5's,
GLM-4's, Granite-MoE's, DeepSeek-V3's, the serve run's, Qwen2-VL's,
HuBERT's and Zamba2's (training and serving) beside them, K6/K7, then
the split-row K4/K5 (``rmsnorm_fwd_split``, ``rmsnorm_bwd_split``: phase
19i's errors and times, their launches and their partial passes' on the
Zamba2 runs); each redesigned kernel with its ``routes``), then one
``[chip_smoke] phases`` line with every phase's seconds, the whole
script's time, the card's ``nvidia-smi`` name and power limit, and the
``ok`` line.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import math
import os
import re
import socket
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# the kernels' work and bound formulas, the dry run's own
# (launch/op_count.py)
from repro_torch.launch.op_count import attn_work, bound, head_dims, \
    live_keys, live_pairs, rms_work, wkv6_work  # noqa: E402

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
# decoder's (micro-batch 4 x seq 1024, d 4096), then Gemma3-12B's
# (micro-batch 1 x 4096, d 3840), Qwen2.5-14B's (4 x 1024, d 5120),
# Granite-MoE's (4 x 1024, d 1536), DeepSeek-V3's (2 x 1024: d 7168 for
# ln1, ln2, the final and the MTP norms, q_norm's 1536, and kv_norm's 512
# in rows of w_dkv's 576 columns), Zamba2-2.7B's (2 x 4096: d 2560 for
# the Mamba2 and shared-block norms and the final norm, the inner norm's
# 5120; its serve prefill's 4 x 512 at both), the smoke config's (4 x 64,
# d 256), the
# reference's RMS_CASES, one row, an odd D (rows not 16-byte aligned:
# scalar loads) and an odd D in wider rows (16-byte vectors and a scalar
# tail)
RMS_CASES = [
    ("decoder", (4096, 4096), None),
    ("gemma3", (4096, 3840), None),
    ("qwen2.5", (4096, 5120), None),
    ("granite", (4096, 1536), None),
    ("deepseek", (2048, 7168), None),
    ("ds q_norm", (2048, 1536), None),
    ("ds kv_norm", (2048, 512), 576),
    ("zamba2", (8192, 2560), None),
    ("zamba2 inner", (8192, 5120), None),
    ("zamba2 prefill", (4, 512, 2560), None),
    ("zamba2 prefill inner", (4, 512, 5120), None),
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
# the rate runs' timed and warm-up steps: 3 and 1 (the other decoders
# take 4 and 2), which leaves the time of phase 19o to the script: two
# steps fewer in each of the four rate runs (kernel, naive, naive,
# kernel): 9.2 to 13.2 s at the per-step times the phase has read, the
# kernel path's 0.30 s and the naive path's 2.0 to 3.0 s (NVIDIA H100
# 80GB HBM3, 700 W)
RWKV_TIMED = (3, 1)
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
# ops.wkv6 at a head size and a chunk no kernel is built for (ROADMAP F2):
# P 48 padded to 64, chunk 24 run at 16, S 100 padded to 112
WKV_PADDED = (2, 100, 4, 48, 24)
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
    ("gqa 5", (2, 10, 2, 130, 130, 128), "float32", True, 0, False),
    ("gqa 5", (2, 10, 2, 130, 130, 128), "bfloat16", True, 0, True),
    ("D256 gqa5", (1, 10, 2, 197, 197, 256), "float32", True, 0, True),
    ("D256 gqa5", (1, 10, 2, 197, 197, 256), "bfloat16", True, 0, True),
    ("window", (4, 4, 4, 130, 130, 64), "float32", True, 40, False),
    ("window", (4, 4, 4, 130, 130, 64), "bfloat16", True, 40, False),
    ("S>T win", (2, 4, 2, 200, 70, 64), "float32", False, 30, False),
    ("S>T win", (2, 4, 2, 200, 70, 64), "bfloat16", False, 30, True),
    ("D=32", (2, 4, 2, 197, 197, 32), "float32", True, 0, False),
    ("D=32", (2, 4, 2, 197, 197, 32), "bfloat16", True, 0, True),
    ("D=128", (4, 4, 4, 130, 130, 128), "bfloat16", False, 0, False),
    ("D=128", (2, 32, 2, 197, 197, 128), "float32", True, 0, False),
    ("D=128", (2, 32, 2, 197, 197, 128), "bfloat16", True, 0, True),
    ("D=256", (2, 4, 2, 197, 197, 256), "float32", False, 0, False),
    ("D=256", (2, 4, 2, 197, 197, 256), "bfloat16", False, 0, False),
    ("D=256", (2, 4, 2, 197, 197, 256), "bfloat16", True, 0, True),
    ("D256 win", (1, 4, 2, 300, 300, 256), "float32", True, 100, True),
    ("D256 win", (1, 4, 2, 300, 300, 256), "bfloat16", True, 100, True),
    ("D256 S>T", (2, 4, 2, 200, 70, 256), "float32", False, 30, False),
    ("D256 S>T", (2, 4, 2, 200, 70, 256), "bfloat16", False, 30, True),
]
# the dense-decoder family's slice: gemma3-12b at full width, cut to six
# layers (five local with a window of 1024, one global), sequences of 4096
# tokens in micro-batches of 1; its attention is B 1, H 16, KH 8, D 256
GEMMA_LAYERS, GEMMA_SEQ, GEMMA_WINDOW = 6, 4096, 1024
GEMMA_ATTN_SHAPE = (1, 16, 8, GEMMA_SEQ, GEMMA_SEQ, 256)
GEMMA_TRAIN_ARGS = ["--arch", "gemma3-12b", "--layers", str(GEMMA_LAYERS),
                    "--seq", str(GEMMA_SEQ), "--batch", "2", "--accum", "2",
                    "--steps", "10", "--log-every", "1"]
# the fp32 kernel-vs-naive gradients at a sequence that still exceeds the
# window, so the local layers' masks bite
GEMMA_AGREE_SEQ = 2048
# K1-K3 at head dim 80 (HuBERT-XLarge's and Zamba2-2.7B's) and at the smoke
# MLA pair (D 48, Dv 32), shapes (B, H, KH, S, T, D[, Dv]): HuBERT's
# attention (a microbatch of 8, 16 heads, S 781 = 12 x 64 + 13 frames,
# non-causal, in the model's layout), Zamba2's shared block (2 x 4096
# tokens, 32 heads, causal) and a small (48, 32) case with a GQA group of 2
HUBERT_ATTN_SHAPE = (8, 16, 16, 781, 781, 80)
ZAMBA_ATTN_SHAPE = (2, 32, 32, 4096, 4096, 80)
MLA_SMOKE_SHAPE = (2, 4, 2, 300, 300, 48, 32)
# K1-K3 at (D, Dv) pairs no kernel is built for (ROADMAP F2): the wrappers
# pad to (48, 32) and (128, 128) and slice back
PAD_ATTN_SHAPES = [(2, 4, 2, 300, 300, 40, 24), (2, 8, 4, 300, 300, 96)]
REMAT_TOL = 1e-5
# qwen2.5-14b and glm4-9b at full width (vocabularies 152,064 and 151,552;
# GLM's norm eps 1.5625e-7), two layers each
DENSE_LAYERS = 2
# Qwen2.5-14B's attention on one microbatch (4 x 1024): a GQA group of 5,
# where K3 takes its unsplit grid (512 CTAs)
QWEN_ATTN_SHAPE = (4, 40, 8, LM_SEQ, LM_SEQ, 128)
DENSE_ARGS = ["--layers", str(DENSE_LAYERS), "--seq", str(LM_SEQ),
              "--batch", "8", "--accum", "2", "--steps", "3",
              "--log-every", "1"]
# the MoE decoder's slice: granite-moe-3b-a800m at full width (d 1536, 40
# experts of 512, top-8, vocabulary 49,155 tied), cut to eight layers,
# sequences of 1024 tokens in micro-batches of 4; its attention is B 4,
# H 24, KH 8 (a GQA group of 3), D 64
GRANITE = "granite-moe-3b-a800m"
GRANITE_LAYERS = 8
GRANITE_ATTN_SHAPE = (4, 24, 8, LM_SEQ, LM_SEQ, 64)
GRANITE_ARGS = ["--arch", GRANITE, "--layers", str(GRANITE_LAYERS), "--seq",
                str(LM_SEQ), "--batch", "8", "--accum", "2", "--steps", "10",
                "--log-every", "1"]
# gather against GShard: tests/test_perf_options.py:29-47's gates, at a
# capacity factor of 8 (nothing dropped, so both compute one function), on
# two layers: GShard's fp32 (B,S,E,C) dispatch and combine and (E,B,C,D)
# expert tensors at that capacity hold ~7 GB a layer
IMPL_CF, IMPL_LAYERS = 8.0, 2
IMPL_LOGITS_TOL, IMPL_GRAD_TOL = 2e-5, 5e-5
# the MLA slice: deepseek-v3-671b at full width (d 7168, 128 heads, q and
# k heads of 128 + 64, v heads of 128, latents of 1536 and 512, vocabulary
# 129,280 untied, experts of 2048 with top-8 and a shared one, the MTP
# head with its dense block of 18,432), cut to one MoE layer (of 61, three
# of them dense) and 16 routed experts (of 256): 3.476 B params, whose
# fp32 params, grads and AdamW moments take 55.6 GB of the card's 80
DEEPSEEK = "deepseek-v3-671b"
DS_LAYERS, DS_EXPERTS, DS_BATCH, DS_STEPS = 1, 16, 2, 10
DS_PEAK_GB = (66.0, 74.0)       # the predicted peak (PERF.md, §6)
# its attention on one batch of 2 x 1024: B, H, KH, S, T, D, Dv
MLA_ATTN_SHAPE = (2, 128, 128, LM_SEQ, LM_SEQ, 192, 128)
# label, shape, causal, window, model layout: ragged S = T, non-causal in
# contiguous (B,H,S,D) tensors, a window, and a GQA group of 4 (K3's bf16
# group split and its fp32 partials with rows of D holding Dv)
MLA_CASES = [
    ("ragged 197", (2, 8, 8, 197, 197, 192, 128), True, 0, True),
    ("ragged 1000", (1, 8, 8, 1000, 1000, 192, 128), True, 0, True),
    ("non-causal", (2, 8, 8, 197, 197, 192, 128), False, 0, False),
    ("window 256", (1, 8, 8, 1000, 1000, 192, 128), True, 256, True),
    ("gqa 4", (2, 8, 2, 300, 300, 192, 128), True, 0, True),
]
# phase 15, serving and Qwen2-VL. The serve CLI's run: qwen2.5-14b at full
# width cut to four layers, fp32, a batch of 4 prompts of 512 tokens and
# 64 generated (one prefill and 63 decode steps)
QWEN = "qwen2.5-14b"
SERVE_LAYERS, SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 4, 512, 64
SERVE_ARGS = ["--arch", QWEN, "--layers", str(SERVE_LAYERS), "--batch",
              str(SERVE_BATCH), "--prompt-len", str(SERVE_PROMPT), "--gen",
              str(SERVE_GEN)]
# K1 where prefill attends over the whole cache (T = prompt + generated
# rows, causal, S < T): label, shape (B, H, KH, S, T, D[, Dv]), window.
# Qwen2.5's serve run, Gemma3's local layers with a prompt past the
# window, DeepSeek-V3's MLA, Zamba2's serve run (head dim 80)
PREFILL_CASES = [
    ("qwen2.5", (SERVE_BATCH, 40, 8, SERVE_PROMPT,
                 SERVE_PROMPT + SERVE_GEN, 128), 0),
    ("gemma3 local", (1, 16, 8, 1100, 1104, 256), GEMMA_WINDOW),
    ("mla", (2, 128, 128, LM_SEQ, LM_SEQ + 8, 192, 128), 0),
    ("zamba2", (SERVE_BATCH, 32, 32, SERVE_PROMPT, SERVE_PROMPT + SERVE_GEN,
                80), 0),
]
# K4 at a decode step's rows (B x d_model): Qwen2.5's serve run (and a
# data rank's half of it, phase 19m), Qwen2-VL, DeepSeek-V3, Zamba2's serve
# run and its decode against training (d 2560; the inner norm at 5120)
DECODE_ROWS = [("qwen2.5", (SERVE_BATCH, 5120)),
               ("qwen2.5 data 2", (SERVE_BATCH // 2, 5120)),
               ("qwen2-vl", (1, 8192)),
               ("deepseek", (2, 7168)), ("zamba2", (SERVE_BATCH, 2560)),
               ("zamba2", (2, 2560)), ("zamba2 inner", (2, 5120))]
DECODE_TOL = 5e-4                   # tests/test_arch_smoke.py:80-85
DECODE_STEPS = 4
# decode against training at full width: tag, arch, layers, batch, prompt
# tokens, cache rows, config fields replaced, the norm eps of the fp32 gate
# (None: the model's). MoE configs at capacity factor 8 (prefill counts
# capacity over the prompt, training over the whole sequence). RWKV6's
# fp32 gate runs with the group norm's eps at 1e-3 (phase 10's); its fp32
# reading at the model's eps is printed beside it, ungated, and its bf16
# gate runs at the model's eps
VL = "qwen2-vl-72b"
VL_IMAGE = 512
DECODE_MODELS = [
    ("qwen2-vl", VL, 1, 2, LM_SEQ, LM_SEQ + DECODE_STEPS, {}, None),
    ("deepseek", DEEPSEEK, 1, 2, LM_SEQ, LM_SEQ + 8, {"mtp_depth": 0},
     None),
    ("gemma3", "gemma3-12b", GEMMA_LAYERS, 1, 1100, 1100 + DECODE_STEPS, {},
     None),
    ("granite", GRANITE, 2, 2, 512, 512 + DECODE_STEPS, {}, None),
    ("rwkv6", "rwkv6-7b", 2, 2, 512, 512 + DECODE_STEPS, {}, RWKV_GATE_EPS),
]
# Qwen2-VL-72B training at full width cut to one layer (3.37 B params),
# batch 2 x 1024 with 512 image embeddings, accum 1, three steps
VL_LAYERS, VL_BATCH, VL_STEPS = 1, 2, 3
VL_PEAK_GB = (58.0, 64.0)       # the predicted peak (PERF.md, §6)
SERVE_RATE_BATCHES = (SERVE_BATCH, 32)

# HuBERT-XLarge at full width through the CLI, cut to 12 of 48 layers
# (0.24 B params; at 48 the whole script read 1,127 s of its 1,200 s on a
# slow host, at 24 with the pipeline phase 1,144.5 s), 16 x 781 frames a
# step in microbatches of 8 (phase 6c's attention shape), 4 steps
HUBERT = "hubert-xlarge"
HUBERT_LAYERS, HUBERT_SEQ, HUBERT_BATCH, HUBERT_ACCUM, HUBERT_STEPS = \
    12, 781, 16, 2, 4
HUBERT_ARGS = ["--arch", HUBERT, "--layers", str(HUBERT_LAYERS), "--seq",
               str(HUBERT_SEQ), "--batch", str(HUBERT_BATCH), "--accum",
               str(HUBERT_ACCUM), "--steps", str(HUBERT_STEPS),
               "--log-every", "1"]
# Zamba2-2.7B at full width cut to two groups of 6 Mamba2 layers (12 of
# 54), so the shared block runs twice: its gradient summed over its uses,
# one KV cache a group (~0.9 B params), 4 x 4096 tokens a step in
# microbatches of 2 (phase 6c's attention shape), 3 steps; then its
# prefill (300 tokens, across two SSD chunk boundaries) and 4 decode
# steps, and the serve CLI in fp32 as the reference's
ZAMBA = "zamba2-2.7b"
ZAMBA_LAYERS, ZAMBA_SEQ, ZAMBA_BATCH, ZAMBA_ACCUM, ZAMBA_STEPS = \
    12, 4096, 4, 2, 3
ZAMBA_ARGS = ["--arch", ZAMBA, "--layers", str(ZAMBA_LAYERS), "--seq",
              str(ZAMBA_SEQ), "--batch", str(ZAMBA_BATCH), "--accum",
              str(ZAMBA_ACCUM), "--steps", str(ZAMBA_STEPS), "--log-every",
              "1"]
ZAMBA_DECODE = [("zamba2", ZAMBA, ZAMBA_LAYERS, 2, 300, 300 + DECODE_STEPS,
                 {}, None)]
ZAMBA_SERVE_ARGS = ["--arch", ZAMBA, "--layers", str(ZAMBA_LAYERS),
                    "--batch", str(SERVE_BATCH), "--prompt-len",
                    str(SERVE_PROMPT), "--gen", str(SERVE_GEN)]

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


# the models whose seed-0 draws feed only gates that compare two paths (or
# ranks) on the same params: drawn on the card and copied to the host,
# many times faster than the host's draw (ROADMAP item 2). RWKV6's fp32
# gate failed on a card's draw: its draws, and the rest, stay on the host
CARD_DRAWS = ("chatglm3-6b", "gemma3-12b", "qwen2.5-14b", "glm4-9b")


def share_draws():
    """Let every later draw of ``init_params`` onto the card that repeats
    the one before it (the same seed and the same ordered param shapes,
    which alone set the drawn values: configs that differ only in dtype,
    kernels, remat or routing draw the same tensors) copy that draw's host
    tensors instead of drawing again: a phase draws its full-width params
    several times (its CLI run, its agreement, its rates), each a host
    draw of up to 3.5 B params. A CARD_DRAWS model's draw is made on the
    card and copied to the host. Each fresh draw prints its size and
    time.
    Draws to the host or ``meta`` are made as before. Returns the counts
    ``{"draws": n, "shared": n}``."""
    import torch
    from repro_torch.launch import serve, train
    from repro_torch.models import transformer

    draw, held, counts = transformer.init_params, {}, {"draws": 0,
                                                       "shared": 0}

    def init_params(cfg, *, seed=0, device="cuda", draw_on="cpu"):
        if torch.device(device).type != "cuda" or draw_on != "cpu":
            return draw(cfg, seed=seed, device=device, draw_on=draw_on)
        key = (seed, tuple((k, tuple(v.shape)) for k, v in
                           draw(cfg, device="meta").items()))
        if key in held:
            counts["shared"] += 1
        else:
            held.clear()
            t0 = time.time()
            on = "cuda" if cfg.name in CARD_DRAWS else "cpu"
            held[key] = draw(cfg, seed=seed, device="cpu", draw_on=on)
            counts["draws"] += 1
            n = sum(v.numel() for v in held[key].values())
            print(f"[draws] {cfg.name} ({cfg.num_layers} layers, "
                  f"{n / 1e9:.3f} B params) drawn on the "
                  f"{'card' if on == 'cuda' else 'host'} for the host in "
                  f"{time.time() - t0:.1f}s", flush=True)
        return {k: v.to(device, copy=True) for k, v in held[key].items()}
    for module in (transformer, train, serve):
        module.init_params = init_params
    share_draws.held = held         # the last draw's host tensors
    return counts


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
                    ("units",) if "rmsnorm_bwd" in m.group(1) else \
                    ("D", "Dv")
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

    check_autograd("k23", TRAIN_SHAPE, inputs, causal=False)
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


def check_autograd(tag, shape, inputs, causal):
    """The autograd Function end to end, in the model layout at ``shape``:
    torch.autograd.grad through ``flash_mha`` against the plain backward
    in bf16 and fp32; the gradients keep the primals' layout, with no dO
    copy."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ops import flash_mha
    from repro_torch.kernels.ref import ref_attention_bwd

    for dname in ("bfloat16", "float32"):
        dtype, tol = getattr(torch, dname), TOL_OUT[dname]
        q, k, v, w = (x.transpose(1, 2) for x in shape_inputs(
            inputs, shape, dtype, True))
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        fa.kernel_layout.copies = 0
        got = torch.autograd.grad(flash_mha(*leaves, causal=causal), leaves,
                                  grad_outputs=w)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        out, lse = fa.flash_attention_fwd(qt, kt, vt, causal=causal)
        want = ref_attention_bwd(qt, kt, vt, out, lse, w.transpose(1, 2),
                                 causal=causal)
        res = [close(g.transpose(1, 2), r, tol)
               for g, r in zip(got, want[:3])]
        layout = [g.stride() == x.stride() for g, x in zip(got, leaves)]
        ok = all(r[1] for r in res) and all(layout) and \
            fa.kernel_layout.copies == 0
        print(f"[{tag}] autograd.grad(flash_mha) at {shape} {dname} causal="
              f"{causal}: max|dgrad|={max(r[0] for r in res):.3e} (tol "
              f"{tol}); grads in the primals' layout {layout}; dO copies "
              f"{fa.kernel_layout.copies} {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            fail(f"the autograd Function disagrees at {shape} in {dname}")


def sdpa_backends(q, k, v, **kw):
    """The names of the SDPA backends that take these inputs (each forced
    alone in turn): the one that serves Dv != D is named so."""
    import warnings
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    names = []
    for be in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
               SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with warnings.catch_warnings(), sdpa_kernel([be]):
                warnings.simplefilter("ignore")
                F.scaled_dot_product_attention(q, k, v, **kw)
            names.append(be.name)
        except RuntimeError:
            pass
    return names


def attention_times(card, shape, causal, inputs, tag, window=0):
    """K1, K2 and K3 at ``shape`` in bf16 in the model layout (``inputs``
    gives q, k, v, dO), beside the plain forward and backward, SDPA's
    forward and backward (its forward+backward less its forward, the one
    yardstick K2 and K3 share; with ``enable_gqa`` under GQA and, with a
    ``window``, an explicit boolean mask of the live pairs) and each
    kernel's bound. Returns {"fwd", "dq", "dkv": {ms, plain_ms, bound_ms,
    bound_by, library_ms}}."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import _live_mask, ref_attention, \
        ref_attention_bwd

    kw = {"causal": causal, "window": window}
    q, k, v, do = shape_inputs(inputs, shape, torch.bfloat16, True)
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
    if window:
        sdpa_kw = {"attn_mask": _live_mask(shape[3], shape[4], causal=causal,
                                           window=window, device="cuda")}
    if shape[1] != shape[2]:
        sdpa_kw["enable_gqa"] = True
    if len(set(head_dims(shape))) > 1:
        with torch.no_grad():
            names = sdpa_backends(qc, kc, vc, **sdpa_kw)
        print(f"[{tag}] SDPA backends that take D {head_dims(shape)[0]}, Dv "
              f"{head_dims(shape)[1]}: {names} (the default dispatch, timed "
              f"below, takes the first of them in its own order)",
              flush=True)

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qc, kc, vc, **sdpa_kw)
        torch.autograd.grad(o, (qc, kc, vc), grad_outputs=doc)
    with torch.no_grad():
        sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(
            qc, kc, vc, **sdpa_kw), calls=10)
    library = {"fwd": sdpa_fwd}
    library["dq"] = library["dkv"] = \
        time_ms(sdpa_fwd_bwd, calls=10) - sdpa_fwd
    work = attn_work(shape, q.element_size(), causal, window)
    rows = {}
    for key, name in (("fwd", "K1 flash_fwd"), ("dq", "K2 flash_bwd_dq"),
                      ("dkv", "K3 flash_bwd_dkv")):
        bound_ms, bound_by, how = bound(card, *work[key])
        print(f"[{tag}] {name} timing at {shape} bf16 causal={causal} "
              f"window={window} on "
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
    """``inputs(b, h, kh, s, t, d, dtype, model_layout, dv=None)`` -> q, k,
    v, dO (v and dO Dv = ``dv`` wide, D by default); in the model's
    (B,S,H,D) buffers seen as (B,H,S,D) when ``model_layout``, as the
    training path hands them over."""
    import torch

    def inputs(b, h, kh, s, t, d, dtype, model_layout, dv=None):
        def mk(bb, hh, n, w):
            if model_layout:
                return torch.randn((bb, n, hh, w), device="cuda",
                                   generator=gen).to(dtype).transpose(1, 2)
            return torch.randn((bb, hh, n, w), device="cuda",
                               generator=gen).to(dtype)
        dv = dv or d
        return mk(b, h, s, d), mk(b, kh, t, d), mk(b, kh, t, dv), \
            mk(b, h, s, dv)
    return inputs


def shape_inputs(inputs, shape, dtype, model_layout):
    """``inputs`` at an attention shape (B, H, KH, S, T, D[, Dv])."""
    return inputs(*shape[:6], dtype, model_layout, dv=head_dims(shape)[1])


def phase_lm_attention(card):
    """K1, K2 and K3 at the decoder's attention shape (causal, GQA 32:2,
    head dim 128, S = T = 1024): against their plain versions in bf16 and
    fp32, K2 run twice for bitwise equal dq and delta, K3 run twice for
    bitwise equal dk and dv (its bf16 route splits each GQA group over 4
    CTAs and sums their partials in a fixed order), then timed."""
    import torch
    from repro_torch.kernels import flash_attention as fa

    inputs = model_layout_inputs(torch.Generator(device="cuda").manual_seed(3))
    b, h, _, s, _, _ = LM_ATTN_SHAPE
    tile = fa._lib_bwd().repro_flash_query_tile()
    print(f"[lm-attn] K2 grid: ceil({s} / {tile}) q tiles x {h} heads x {b} "
          f"= {-(-s // tile) * h * b} CTAs", flush=True)
    errs = check_attention("lm-attn", "the decoder", LM_ATTN_SHAPE, inputs)
    t = attention_times(card, LM_ATTN_SHAPE, True, inputs, "lm-attn")
    return {key: dict(t[key], max_abs_err=errs[key]) for key in t}


def phase_gemma_attention(card):
    """K1, K2 and K3 at Gemma3-12B's attention shape (causal, GQA 16:8,
    head dim 256, S = T = 4096), with the local layers' window of 1024 and
    the global layer's none: against their plain versions in bf16 and fp32,
    K2 and K3 run twice for bitwise equal dq, delta, dk and dv, then timed
    at the local layers' window (SDPA with ``enable_gqa`` and the window's
    boolean mask)."""
    import torch

    inputs = model_layout_inputs(torch.Generator(device="cuda").manual_seed(5))
    errs = check_attention("gemma-attn", "Gemma3's", GEMMA_ATTN_SHAPE, inputs,
                           windows=(GEMMA_WINDOW, 0))
    t = attention_times(card, GEMMA_ATTN_SHAPE, True, inputs, "gemma-attn",
                        window=GEMMA_WINDOW)
    return {key: dict(t[key], max_abs_err=errs[key]) for key in t}


def phase_d80_attention(card):
    """Phase 6c: K1, K2 and K3 at head dim 80 and at (D 48, Dv 32) against
    their plain versions in bf16 and fp32 (phase 3's gates), K2 and K3
    each run twice for bitwise equal results: HuBERT's shape (non-causal,
    ragged S 781, the model's layout), Zamba2's (causal, S 4096), and the
    (48, 32) case causal in the model's layout and non-causal in
    contiguous tensors; K1-K3 at the unbuilt pairs of PAD_ATTN_SHAPES,
    which the wrappers pad (ROADMAP F2); then K1-K3 timed at both D 80
    shapes beside their plain versions, SDPA and the bounds. Returns
    {"hubert", "zamba2": {"fwd", "dq", "dkv": timing row with the bf16
    error}}."""
    import torch

    inputs = model_layout_inputs(
        torch.Generator(device="cuda").manual_seed(13))
    errs = {"hubert": check_attention("d80-attn", "HuBERT's",
                                      HUBERT_ATTN_SHAPE, inputs,
                                      causal=False),
            "zamba2": check_attention("d80-attn", "Zamba2's",
                                      ZAMBA_ATTN_SHAPE, inputs)}
    check_attention("d80-attn", "the smoke MLA pair's", MLA_SMOKE_SHAPE,
                    inputs)
    check_attention("d80-attn", "the smoke MLA pair's", MLA_SMOKE_SHAPE,
                    inputs, causal=False, layout=False)
    # unbuilt pairs, padded by the wrappers: each check calls them five
    # times a dtype (K1 once, K2 and K3 twice)
    from repro_torch.kernels import flash_attention as fa
    fa.pad_head_dims.pads = 0
    for shape in PAD_ATTN_SHAPES:
        check_attention("d80-attn", "an unbuilt pair's (padded)", shape,
                        inputs)
    print(f"[d80-attn] the padded pairs {PAD_ATTN_SHAPES}: "
          f"{fa.pad_head_dims.pads} wrapper calls padded (expected "
          f"{10 * len(PAD_ATTN_SHAPES)})", flush=True)
    if fa.pad_head_dims.pads != 10 * len(PAD_ATTN_SHAPES):
        fail("K1-K3 at unbuilt pairs did not pad once a wrapper call")
    out = {}
    for tag, shape, causal in (("hubert", HUBERT_ATTN_SHAPE, False),
                               ("zamba2", ZAMBA_ATTN_SHAPE, True)):
        t = attention_times(card, shape, causal, inputs, "d80-attn")
        out[tag] = {key: dict(t[key], max_abs_err=errs[tag][key])
                    for key in t}
    return out


def check_attention(tag, what, shape, inputs, windows=(0,), causal=True,
                    layout=True):
    """K1-K3 at ``shape`` (B, H, KH, S, T, D[, Dv]) (causal or not, with
    each window of ``windows``; in the model's layout or contiguous (B,H,S,D)
    tensors) against their plain versions in bf16 and fp32, K2 and K3 each
    run twice for bitwise equal outputs; fails on any disagreement. Returns
    the bf16 errors at the first window: {"fwd", "dq", "dkv": max
    |error|}."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import ref_attention, ref_attention_bwd

    errs = {}
    for window in windows:
        for dname in ("bfloat16", "float32"):
            dtype, tol = getattr(torch, dname), TOL_OUT[dname]
            q, k, v, do = shape_inputs(inputs, shape, dtype, layout)
            kw = {"causal": causal, "window": window}
            out, lse = fa.flash_attention_fwd(q, k, v, **kw)
            dq, delta = fa.flash_attention_bwd_dq(q, k, v, out, lse, do, **kw)
            dq2, delta2 = fa.flash_attention_bwd_dq(q, k, v, out, lse, do,
                                                    **kw)
            dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
            dk2, dv2 = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                  **kw)
            torch.cuda.synchronize()
            same_dq = torch.equal(dq, dq2) and torch.equal(delta, delta2)
            same = torch.equal(dk, dk2) and torch.equal(dv, dv2)
            ref_out, ref_lse = ref_attention(q, k, v, **kw)
            want = ref_attention_bwd(q, k, v, out, lse, do, **kw)
            res = {"out": close(out, ref_out, tol),
                   "lse": close(lse, ref_lse, TOL_LSE),
                   "dq": close(dq, want[0], tol),
                   "dk": close(dk, want[1], tol),
                   "dv": close(dv, want[2], tol),
                   "delta": close(delta, want[3], TOL_DELTA)}
            del ref_out, ref_lse, want
            ok = all(r[1] for r in res.values()) and same and same_dq
            print(f"[{tag}] {shape} {dname} causal={causal} window={window} "
                  f"model layout={layout}: "
                  + " ".join(f"max|d{key}|={r[0]:.3e}"
                             for key, r in res.items())
                  + f" (tol {tol}, rtol {tol}; lse and delta {TOL_LSE}); K2 "
                  f"run twice bitwise equal dq and delta {same_dq}; K3 run "
                  f"twice bitwise equal {same} {'ok' if ok else 'FAIL'}",
                  flush=True)
            if not ok:
                fail(f"K1-K3 disagree with their plain versions at {what} "
                     f"shape in {dname} (window {window})")
            if dtype == torch.bfloat16 and window == windows[0]:
                errs = {"fwd": res["out"][0],
                        "dq": max(res["dq"][0], res["delta"][0]),
                        "dkv": max(res["dk"][0], res["dv"][0])}
    return errs


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
    work = rms_work(rows, d, x.element_size())
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


def phase_wkv6(card):
    """K6 (with and without states) and K7 against ``ref_wkv6_fwd``/
    ``ref_wkv6_bwd`` at every case of WKV_CASES, o against the sequential
    ``ref_wkv6`` where it is small, K7 twice for bitwise equal du and ds0,
    the ragged case, an unbuilt head size and chunk (WKV_PADDED, padded
    by ``ops.wkv6``) and the slice's shape through ``torch.autograd.grad``
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
    # the unbuilt head size and chunk: o, s_end and the gradients of
    # ops.wkv6 (K6/K7 at P 64, chunk 16) against the sequential oracle
    b, s, h, p, cs = WKV_PADDED
    wk.pad_to_chunk.pads = wk.pad_head_dim.pads = 0
    xs = inputs(b, s, h, p, torch.float32, torch.float32)
    before = (wk.wkv6_fwd.launches, wk.wkv6_bwd.launches)
    outs = ops.wkv6(*xs[:6], chunk=cs)
    want_outs = ref_wkv6(*xs[:6])
    res = [close(x, y, WKV_TOL["float32"]) for x, y in zip(outs, want_outs)]
    got = grads(lambda *a: ops.wkv6(*a, chunk=cs), xs[:6], *xs[6:])
    want = grads(ref_wkv6, xs[:6], *xs[6:])
    res += [close(x, y, WKV_GRAD_TOL["float32"]) for x, y in zip(got, want)]
    launched = (wk.wkv6_fwd.launches - before[0],
                wk.wkv6_bwd.launches - before[1])
    ok = all(x[1] for x in res) and wk.pad_head_dim.pads == 2 and \
        wk.pad_to_chunk.pads == 2 and launched == (2, 1)
    print(f"[wkv6] ops.wkv6 at P {p}, chunk {cs} {WKV_PADDED} fp32 (padded "
          f"to P 64, run at chunk 16) against ref_wkv6 and its autograd: "
          f"max|do, ds_end|={max(x[0] for x in res[:2]):.3e} (tol "
          f"{WKV_TOL['float32']}), max|dgrad|="
          f"{max(x[0] for x in res[2:]):.3e} (tol "
          f"{WKV_GRAD_TOL['float32']}); head-size pads "
          f"{wk.pad_head_dim.pads}, chunk pads {wk.pad_to_chunk.pads}, "
          f"K6/K7 launches {launched} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("ops.wkv6 at an unbuilt head size and chunk disagrees, or did "
             "not pad and launch")
    b, s, h, p, cs = WKV_SHAPE
    wk.pad_to_chunk.pads = wk.kernel_layout.copies = 0
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
            "wkv6_fwd": wk.wkv6_fwd, "wkv6_bwd": wk.wkv6_bwd,
            # the split-row K4/K5 (tensor parallelism's Mamba2 inner
            # norm), each after its partial pass
            "rmsnorm_sumsq": rms.fused_rmsnorm_sumsq,
            "rmsnorm_fwd_split": rms.fused_rmsnorm_fwd_split,
            "rmsnorm_bwd_dot": rms.fused_rmsnorm_bwd_dot,
            "rmsnorm_bwd_split": rms.fused_rmsnorm_bwd_split}


def reset_counters():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rms
    for fn in counters().values():
        fn.launches = 0
    fa.kernel_layout.copies = rms.row_layout.copies = 0


def read_counters():
    return {name: fn.launches for name, fn in counters().items()}


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
    reset_counters()
    wk.kernel_layout.copies = wk.pad_to_chunk.pads = 0
    pinned_copy.copies = 0
    hist = cli(argv)
    launches = read_counters()
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


def train_setup(dtype, use_kernels, *, batch=128, accum=2, device="cuda",
                **fields):
    """A full-width ViT-B/16 trainer with the CLI's engine settings for 10
    steps (and the engine ``fields``), on procedural CIFAR-10, and its
    data pipeline."""
    from repro_torch.configs import EngineConfig, get_config
    from repro_torch.core.engine import Trainer
    from repro_torch.data.datasets import CIFARSource
    from repro_torch.data.pipeline import DataPipeline

    cfg = get_config("vit-b16").replace(dtype=dtype, use_kernels=use_kernels)
    source = CIFARSource("cifar10", resolution=cfg.image_size)
    ecfg = EngineConfig(train_batch_size=batch,
                        gradient_accumulation_steps=accum, total_steps=10,
                        warmup_steps=1, **fields)
    return Trainer(cfg, ecfg, preproc=source.preproc, device=device), \
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


# the 1-bit AdamW (optim/onebit.py) on the card: updates of one full-width
# fp32 microbatch, and one update held against the CPU's on the same values
ONEBIT_STEPS = 5
ONEBIT_LR = 1e-4
ONEBIT_TOL = 1e-6                   # tests/test_torch_onebit.py


def onebit_check():
    """ViT-B/16 at full width, fp32, on the kernel path: ONEBIT_STEPS
    updates of ``make_onebit_optimizer("adamw")`` on one microbatch of 64
    from the engine's gradients (``Trainer.grads``); the loss must fall.
    The last update also runs on host copies of the params, gradients and
    state: params, error buffer and moments within ONEBIT_TOL."""
    import torch
    from repro_torch.core.engine import to_device
    from repro_torch.optim import make_onebit_optimizer

    t0 = time.time()
    trainer, pipe = train_setup("float32", True, batch=64, accum=1)
    params = {k: p.detach() for k, p in new_vit(trainer).params().items()}
    batch = to_device(pipe.batch_at(0, 0), "cuda")
    opt = make_onebit_optimizer("adamw", weight_decay=0.0)
    state = opt.init(params)
    losses, err = [], None
    for i in range(ONEBIT_STEPS + 1):
        grads, m = trainer.grads(params, batch)
        losses.append(float(m["loss"]))
        if i == ONEBIT_STEPS:
            break
        if i == ONEBIT_STEPS - 1:
            def host(t):
                return {k: v.cpu() for k, v in t.items()}
            inner = state.inner
            on_host = opt.update(host(grads), type(state)(
                host(state.error), inner._replace(
                    mu=host(inner.mu), nu=host(inner.nu))), host(params),
                ONEBIT_LR)
        params, state, _ = opt.update(grads, state, params, ONEBIT_LR)
        if i == ONEBIT_STEPS - 1:
            pairs = [(params, on_host[0]), (state.error, on_host[1].error),
                     (state.inner.mu, on_host[1].inner.mu),
                     (state.inner.nu, on_host[1].inner.nu)]
            err = max((a[k].cpu() - b[k]).abs().max().item()
                      for a, b in pairs for k in a)
    print(f"[onebit] vit-b16 fp32, one microbatch of 64, 1-bit AdamW at lr "
          f"{ONEBIT_LR}: losses {[round(x, 5) for x in losses]}; the last "
          f"update against the CPU's on the same values: max |d| {err:.3e} "
          f"(params, error buffer, moments; tol {ONEBIT_TOL}); "
          f"{time.time() - t0:.1f}s", flush=True)
    if not losses[-1] < losses[0]:
        fail(f"1-bit AdamW: the loss did not fall: {losses}")
    if not err <= ONEBIT_TOL:
        fail(f"1-bit AdamW: the card's update is {err:.3e} off the CPU's")


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

    state = trainer.init_state({k: v.to("cuda", copy=True)
                                for k, v in params.items()})
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

    state = trainer.init_state({k: v.to("cuda", copy=True)
                                for k, v in params.items()})
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


# phase 8 (a): the dry run's count of a vit-train step on meta against the
# same step counted on the card; its peak against the card's, within
# COUNT_PEAK_RATIO (the card read 0.94-0.95 on both paths, PERF.md)
COUNT_PEAK_RATIO = (0.8, 1.25)


def count_check(card, step_ms):
    """Phase 8 (a): one extra vit-train step (bf16, batch 128, accum 2, the
    guard off: the dry run cannot read a meta tensor), not timed, under
    ``launch/op_count.py``'s counter on the card, with the kernels (each
    charging its analytic work) and without; the same step counted on
    ``meta`` as the dry run counts it (the microbatches by their trip
    count) must give the same FLOPs and bytes, exactly. Prints the dry
    run's ``bound_step_s`` on one rank beside the measured ms a step
    (``step_ms``: {path: ms}), and its peak beside the step's
    ``torch.cuda.max_memory_allocated`` (less what else the card held),
    with their ratio, gated at COUNT_PEAK_RATIO. Returns the readings."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.comm_model import roofline
    from repro_torch.core.engine import to_device
    from repro_torch.launch import op_count
    from repro_torch.models.transformer import init_params

    out = {}
    for label in ("kernel", "naive"):
        counted = {}
        for device in ("cuda", "meta"):
            trainer, pipe = train_setup("bfloat16", label == "kernel",
                                        device=device, guard_anomalies=False)
            params = new_vit(trainer).params() if device == "cuda" else \
                init_params(trainer.cfg, device="meta")
            state = trainer.init_state(params)
            batch = to_device(pipe.batch_at(0, 0), "cuda")
            if device == "meta":
                batch = {k: torch.empty(v.shape, dtype=v.dtype,
                                        device="meta")
                         for k, v in batch.items()}
            moments = [state.opt_state.mu] + (
                [state.opt_state.nu] if state.opt_state.nu != () else [])
            args = list(state.params.values()) + [
                t for m in moments for t in m.values()] + list(batch.values())
            args_bytes = sum(op_count.tensor_bytes(t) for t in args)
            if device == "cuda":
                torch.cuda.synchronize()
                other = torch.cuda.memory_allocated() - args_bytes
                torch.cuda.reset_peak_memory_stats()
            with op_count.OpCounter(skip_repeats=device == "meta",
                                    args_bytes=args_bytes,
                                    arg_tensors=args) as c:
                trainer.train_step(state, batch)
            if device == "cuda":
                torch.cuda.synchronize()
                card_peak = torch.cuda.max_memory_allocated() - other
            counted[device] = c
            del trainer, state, params, batch, args
        got, want = counted["cuda"], counted["meta"]
        same = (got.totals.flops, got.totals.hbm_bytes) == \
            (want.totals.flops, want.totals.hbm_bytes)
        if not same:
            diff = {k: (got.by_op.get(k), want.by_op.get(k))
                    for k in set(got.by_op) | set(want.by_op)
                    if got.by_op.get(k) != want.by_op.get(k)}
            print(f"[count] vit-b16 {label}: ops whose counts differ "
                  f"(card, meta): {diff}", flush=True)
        n_params = sum(p.numel() for p in init_params(
            get_config("vit-b16"), device="meta").values())
        rl = roofline(want.totals, chips=1,
                      model_flops=6.0 * n_params * 128 * 197)
        ratio = want.peak_bytes / card_peak
        out[label] = {"flops": want.totals.flops,
                      "bytes": want.totals.hbm_bytes,
                      "bound_step_s": rl["bound_step_s"],
                      "dominant": rl["dominant"],
                      "measured_ms": step_ms[label],
                      "peak_gb": want.peak_bytes / 1e9,
                      "card_peak_gb": card_peak / 1e9,
                      "peak_ratio": ratio}
        print(f"[count] vit-b16 bf16 train step (batch 128, accum 2), "
              f"{label} path: the card's count {got.totals.flops:.6e} "
              f"FLOPs, {got.totals.hbm_bytes:.6e} bytes; on meta "
              f"{want.totals.flops:.6e} FLOPs, {want.totals.hbm_bytes:.6e} "
              f"bytes ({'equal' if same else 'DIFFERENT'}); the dry run's "
              f"bound on one rank {rl['bound_step_s'] * 1e3:.3f} ms "
              f"({rl['dominant']}; compute {rl['compute_s'] * 1e3:.3f}, "
              f"memory {rl['memory_s'] * 1e3:.3f} ms) beside "
              f"{step_ms[label]:.2f} ms measured a step; its peak "
              f"{want.peak_bytes / 1e9:.3f} GB beside the card's "
              f"{card_peak / 1e9:.3f} GB (ratio {ratio:.3f}, gate "
              f"{COUNT_PEAK_RATIO}; {card})", flush=True)
        if not same:
            fail(f"vit-b16 {label}: the card's counted step differs from "
                 f"the dry run's on meta")
        if not COUNT_PEAK_RATIO[0] <= ratio <= COUNT_PEAK_RATIO[1]:
            fail(f"vit-b16 {label}: the dry run's peak is {ratio:.3f} of "
                 f"the card's")
    return out


def phase_train(profile, card):
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
    onebit_check()

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
    counts = count_check(card, {label: sum(r[1] for r in rs) / len(rs)
                                for label, rs in rates.items()})
    if profile:
        trainer, pipe = train_setup("bfloat16", True)
        profile_step("vit-b16 (bf16, batch 128, accum 2)", trainer, pipe,
                     new_vit(trainer).params())
    return launches, hist, counts


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
    faults, in its own processes, started first and run beside the two
    before (their gates compare values, not times); then the save and
    restore readings, after the chaos run has ended. Each part's seconds
    print. Returns the K1-K3 launches of the preempted and the resumed
    run."""
    import shutil
    import tempfile
    t0 = last = time.time()

    def lap(part):
        nonlocal last
        now = time.time()
        print(f"[ckpt] ({part}) in {now - last:.1f}s", flush=True)
        last = now
    ref = {r["step"]: r for r in train_rows(vit_hist, "vit-b16 train", 10)}
    evals = [r for r in vit_hist if "eval_count" in r]
    (ROOT / "build").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="ckpt-", dir=ROOT / "build"))
    chaos = None
    try:
        # 3. the chaos run under the supervisor, in its own processes
        chaos = start_chaos(root / "chaos")
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
        lap("1: preempted and resumed")
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
        lap("2: elastic")
        finish_chaos(chaos, ref, evals[0])
        chaos = None
        lap("3: the chaos run's wait")
        # 4. the readings: blocked time of an async save, its write, a sync
        # save and a restore
        save_readings(root / "timing", sizes)
        lap("4: save and restore readings")
    finally:
        if chaos is not None:
            chaos["proc"].kill()
            chaos["proc"].wait()
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


def start_chaos(d):
    """Start phase 8's command under the supervisor with NaN gradients at
    step 1, a preemption after step 7 and step 8's checkpoint corrupted:
    attempt 1 saves steps 2, 4, 6 and 8 (corrupted) and exits 75 at step
    8; attempt 2 falls back to step 6 and replays steps 6 and 7. Its
    output goes to ``chiprun_out/chaos.log``; :func:`finish_chaos` waits
    for it and checks it."""
    d.mkdir(parents=True)
    metrics = d / "metrics.json"
    cmd = [sys.executable, "-m", "repro_torch.launch.train"] + TRAIN_ARGS + [
        "--ckpt-dir", str(d), "--ckpt-every", "2", "--ckpt-sync",
        "--keep-last", "3", "--supervise", "--max-restarts", "2",
        "--inject-faults", CHAOS_FAULTS, "--metrics-out", str(metrics)]
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    log = ROOT / "chiprun_out" / "chaos.log"
    with open(log, "w") as f:
        proc = subprocess.Popen(
            cmd, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
            stdout=f, stderr=subprocess.STDOUT, text=True)
    return {"proc": proc, "t0": time.time(), "d": d, "metrics": metrics,
            "log": log}


def finish_chaos(chaos, ref, want_eval):
    """Wait for the chaos run of :func:`start_chaos` and hold it: exit 0,
    the restart, the skipped update, the fallback past the corrupt step,
    the last attempt's rows against the uninterrupted run (``ref``), the
    eval counts, every printed loss and the fault log."""
    proc, d, metrics = chaos["proc"], chaos["d"], chaos["metrics"]
    try:
        rc = proc.wait(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        fail("chaos run: no exit in 600 s")
    out = chaos["log"].read_text()
    print(f"[ckpt] chaos run: exit {rc} in {time.time() - chaos['t0']:.1f} "
          f"s, started before parts 1-2 and run beside them (log in "
          f"chiprun_out/chaos.log)", flush=True)
    for line in out.splitlines():
        if line.startswith(("[supervisor]", "[guard]", "[ckpt]",
                            "[faults]")) or "preempted" in line:
            print(f"[ckpt]   {line}", flush=True)
    needed = ["launch attempt 2/3", "update skipped",
              "[ckpt] step 8 failed verification", "resumed step=6"]
    if rc != 0 or any(n not in out for n in needed):
        print(out[-4000:], file=sys.stderr)
        fail(f"chaos run: exit {rc}, missing "
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


def start_quickstart():
    """Start the port's quickstart on the card at its smoke size, in its
    own process (main starts it beside phase 8c, whose gates compare
    values, not times)."""
    return time.time(), subprocess.Popen(
        [sys.executable, "-m", "repro_torch.examples.quickstart"],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def phase_quickstart(started):
    """The quickstart of :func:`start_quickstart`: it must exit 0 and print
    its eval line."""
    t0, proc = started
    try:
        stdout, stderr = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        stdout, stderr = proc.communicate()
    lines = stdout.strip().splitlines()
    for line in lines:
        if line.startswith(("model=", "eval:")):
            print(f"[quickstart] {line}", flush=True)
    if proc.returncode or not any(line.startswith("eval: top1")
                                  for line in lines):
        print(stdout[-2000:] + stderr[-4000:], file=sys.stderr)
        fail(f"quickstart exit {proc.returncode}")
    print(f"[quickstart] exit 0 in {time.time() - t0:.1f}s since its start "
          f"beside phase 8c", flush=True)


# phase 18, pipeline parallelism: ViT-B/16 at full width (12 layers, K1-K3
# non-causal at D 64) through the 1F1B executor, every stage in this
# process on the one card
PP_ARGS = ["--arch", "vit-b16", "--batch", "128", "--accum", "4", "--steps",
           "6", "--log-every", "1"]
PP_F32_ARGS = ["--arch", "vit-b16", "--dtype", "float32", "--batch", "32",
               "--accum", "4", "--steps", "3", "--log-every", "1"]
PP_LAYOUTS = {"--pp 2": ["--pp", "2"], "--pp 4": ["--pp", "4"],
              "--pp 2 --pp-interleave 3": ["--pp", "2", "--pp-interleave",
                                           "3"]}
PP_TOL = 3e-4                       # tests/test_pipeline.py's pp-vs-dp bound
PP_MEM_MICRO = 32                   # the memory reading's fixed microbatch
PP_MEM_RATIO = 1.05
PP_RATE_LAYOUTS = [(1, 1), (2, 1), (4, 1), (2, 3)]
PP_LM_ARGS = ["--arch", "chatglm3-6b", "--layers", str(LM_LAYERS), "--seq",
              str(LM_SEQ), "--batch", "8", "--accum", "4", "--steps", "3",
              "--log-every", "1", "--pp", "2"]


def vit_pp_launches(steps, micro, pp):
    """K1-K3 of a ViT-B/16 run: each layer's attention once a microbatch
    forward and backward, and under the pipeline (``pp`` > 1) once more
    forward in the backward slot's recompute."""
    fwd = steps * micro * 12
    return {"flash_fwd": fwd * (2 if pp > 1 else 1), "flash_bwd_dq": fwd,
            "flash_bwd_dkv": fwd}


def pp_setup(dtype, batch, accum, pp, v=1):
    """A full-width ViT-B/16 trainer through the pipeline (``pp`` stages,
    ``v`` chunks a stage, every stage in this process) on procedural
    CIFAR-10, and its data pipeline."""
    from repro_torch.configs import EngineConfig, get_config
    from repro_torch.core.engine import Trainer
    from repro_torch.data.datasets import CIFARSource
    from repro_torch.data.pipeline import DataPipeline

    cfg = get_config("vit-b16").replace(dtype=dtype)
    source = CIFARSource("cifar10", resolution=cfg.image_size)
    ecfg = EngineConfig(train_batch_size=batch,
                        gradient_accumulation_steps=accum, total_steps=10,
                        warmup_steps=1, pipeline_stages=pp,
                        pipeline_interleave=v)
    return Trainer(cfg, ecfg, preproc=source.preproc), \
        DataPipeline(global_batch=batch, source=source)


def pp_memory(card):
    """Peak memory with 2 stages at a microbatch of 32, at M = 4 and at
    M = 8 (after one warm step each). (1) One bf16 step, the peak of
    allocated memory reset before it: at most PP_MEM_RATIO times M = 4's.
    (2) The executor alone (``Trainer.grads``) on the next batch, its
    growth over the memory allocated before it, so that activations and
    not the params, grads and moments make the number: the 1F1B model
    keeps that flat in M, so the growth at M = 8 may exceed M = 4's by
    less than one residual (a chunk input, 32 x 197 x 768 bf16), where an
    executor that kept every microbatch's input (GPipe) would add four.
    Returns the step's peaks in GB."""
    import gc
    import torch
    from repro_torch.core.engine import to_device
    from repro_torch.models.transformer import init_params

    host = init_params(pp_setup("bfloat16", 128, 4, 2)[0].cfg, seed=0,
                       device="cpu")
    peaks_gb, growth, residuals = {}, {}, {}
    for micro in (4, 8):
        trainer, pipe = pp_setup("bfloat16", PP_MEM_MICRO * micro, micro, 2)
        state = trainer.init_state({k: v.to("cuda", copy=True)
                                    for k, v in host.items()})
        batches = [to_device(pipe.batch_at(0, i), "cuda") for i in range(3)]
        state, _ = trainer.train_step(state, batches[0])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state, m = trainer.train_step(state, batches[1])
        torch.cuda.synchronize()
        peaks_gb[micro] = torch.cuda.max_memory_allocated() / 1e9
        if not m["step_ok"]:
            fail(f"pipeline memory step at M={micro} was skipped")
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        grads, _ = trainer.grads(state.params, batches[2])
        torch.cuda.synchronize()
        growth[micro] = torch.cuda.max_memory_allocated() - base
        residuals[micro] = trainer.schedule_out["in_flight"]
        cfg = trainer.cfg
        del trainer, pipe, state, batches, m, grads
        gc.collect()
        torch.cuda.empty_cache()
    ratio = peaks_gb[8] / peaks_gb[4]
    tokens = (cfg.image_size // cfg.patch_size) ** 2 + 1
    residual = PP_MEM_MICRO * tokens * cfg.d_model * 2
    more = growth[8] - growth[4]
    print(f"[pipeline] memory, bf16, S=2, microbatch {PP_MEM_MICRO}: one "
          f"step's peak allocated {peaks_gb[4]:.3f} GB at M=4 and "
          f"{peaks_gb[8]:.3f} GB at M=8 (ratio {ratio:.4f}, gate "
          f"{PP_MEM_RATIO}); the executor's own growth over the memory "
          f"allocated before it {growth[4] / 1e6:.2f} MB at M=4 and "
          f"{growth[8] / 1e6:.2f} MB at M=8, {more / 1e6:+.2f} MB (gate: "
          f"less than one residual, {residual / 1e6:.2f} MB; GPipe would "
          f"add {4 * residual / 1e6:.2f}); the executor's largest live "
          f"residuals per stage {residuals[4]} at M=4, {residuals[8]} at "
          f"M=8 (caps S - d = [2, 1]); on {card}", flush=True)
    if not ratio <= PP_MEM_RATIO:
        fail(f"pipeline peak memory grows with M: {peaks_gb}")
    if not more < residual:
        fail(f"the executor's memory grows with M: {growth} bytes, one "
             f"residual {residual}")
    if residuals[4] != [2, 1] or residuals[8] != [2, 1]:
        fail(f"pipeline residuals {residuals} off the 1F1B caps")
    return peaks_gb


def pp_rates(card):
    """Warm bf16 images/s (batch 128, accum 4) of the plain accumulation
    (pp 1) and the pipelined layouts, one turn each in order (each
    layout's trainer and state built once, on the same pre-built batches;
    1 warm-up step, then 3 steps each timed alone, ending in a
    synchronize), each beside its analytic flat bubble; for ``--pp 1``
    and the interleaved layout (the fewest and the most slots) one more
    step under ``torch.profiler``: its wall time and the device time the
    union of its kernels covers. Recorded, not gated: the step is
    host-bound, so the rate moves with the host, and each line gives the
    spread of its steps."""
    import gc
    import statistics
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.engine import to_device
    from repro_torch.core.pipeline import bubble_fraction, \
        simulated_bubble_fraction
    from repro_torch.models.transformer import init_params

    out, batches = {}, None
    for pp, v in PP_RATE_LAYOUTS:
        trainer, pipe = pp_setup("bfloat16", 128, 4, pp, v)
        if batches is None:
            host = init_params(trainer.cfg, seed=0, device="cpu")
            batches = [to_device(pipe.batch_at(0, j), "cuda")
                       for j in range(4)]
        state = trainer.init_state({k: t.to("cuda", copy=True)
                                    for k, t in host.items()})
        state, _ = trainer.train_step(state, batches[0])
        torch.cuda.synchronize()
        steps = []
        for batch in batches[1:]:
            t0 = time.perf_counter()
            state, m = trainer.train_step(state, batch)
            torch.cuda.synchronize()
            steps.append(time.perf_counter() - t0)
            if not m["step_ok"]:
                fail("a timed pipeline step was skipped by the guard")
        busy = "not profiled"
        if pp == 1 or v > 1:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                state, _ = trainer.train_step(state, batches[0])
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            dev = device_spans(prof)[1] / 1e3
            busy = (f"{dev:.1f} ms of device time in {wall:.1f} ms of "
                    f"wall time (busy {dev / wall:.1%})")
            del prof
        del trainer, pipe, state
        ips = 128 / statistics.median(steps)
        rates = [round(128 / t, 1) for t in steps]
        bubble = bubble_fraction(4, pp) if pp > 1 else 0.0
        sim = simulated_bubble_fraction(4, pp, v) if pp > 1 else 0.0
        out[f"pp{pp}" + (f"_v{v}" if v > 1 else "")] = ips
        print(f"[pipeline] warm bf16 training, --pp {pp}"
              + (f" --pp-interleave {v}" if v > 1 else "")
              + f": {ips:.1f} images/s (median of 3 steps; the steps' "
              f"{rates}, spread {max(rates) - min(rates):.1f}); one "
              f"profiled step: {busy}; analytic bubble (S-1)/(M+S-1) = "
              f"{bubble:.3f}, the simulated schedule's {sim:.3f}; on one "
              f"card the stages share the device and run one after "
              f"another, so the bubble is no idle time here and the "
              f"pipelined rate pays the backward slot's recompute; on "
              f"{card}", flush=True)
    del batches
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_pipeline(card):
    """Pipeline parallelism (phase 18) on one card: the 1F1B executor runs
    every stage in this process. (a) bf16 CLI runs of ViT-B/16 at
    ``--pp 1/2/4`` and interleaved, exact K1-K3 counts; (b) fp32 parity
    with ``--pp 1`` (3e-4), also as rank 0 of a torchrun world of one at
    ZeRO 0 and 3; (c) a ``--pp 2`` checkpoint resumed at ``--pp 1``
    (1e-5); (d) peak memory flat in M; (e) warm rates (recorded); (f)
    ChatGLM3-6B at 4 layers through the pipeline, exact K1-K5 counts; (g)
    ``--devices 2 --pp 2`` on one card refused. Returns the launches of
    the ``--pp 2`` ViT and ChatGLM3 runs."""
    import gc
    import shutil
    import torch

    t0 = last = time.time()

    def lap(part):
        nonlocal last
        now = time.time()
        print(f"[pipeline] ({part}) in {now - last:.1f}s", flush=True)
        last = now
    # (a) bf16 through the CLI, 6 steps at batch 128 in 4 microbatches
    _, hist = run_cli(PP_ARGS, vit_pp_launches(6, 4, 1),
                      "vit-b16 bf16 --pp 1")
    ref = train_rows(hist, "vit-b16 bf16 --pp 1", 6)
    launches = {}
    for label, extra in PP_LAYOUTS.items():
        tag = f"vit-b16 bf16 {label}"
        launches[label], hist = run_cli(PP_ARGS + extra,
                                        vit_pp_launches(6, 4, 2), tag)
        rows = train_rows(hist, tag, 6)
        print(f"[pipeline] {tag}: losses {[round(r['loss'], 4) for r in rows]}"
              f"; step_ok all 1; largest |dloss| from --pp 1 "
              f"{max_diff(rows, ref, 'loss'):.3e}, |dgnorm| "
              f"{max_diff(rows, ref, 'grad_norm'):.3e} (bf16, not gated)",
              flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    lap("a")
    # (b) fp32 parity with --pp 1 at batch 32, 3 steps
    _, hist = run_cli(PP_F32_ARGS, vit_pp_launches(3, 4, 1),
                      "vit-b16 fp32 --pp 1")
    f32 = {"--pp 1": train_rows(hist, "vit-b16 fp32 --pp 1", 3)}
    runs = [(label, extra, False) for label, extra in PP_LAYOUTS.items()] + \
        [(f"--devices 1 --pp 2 --zero {z}",
          ["--devices", "1", "--pp", "2", "--zero", str(z)], True)
         for z in (0, 3)]
    for label, extra, torchrun in runs:
        tag = f"vit-b16 fp32 {label}"
        with torchrun_env() if torchrun else contextlib.nullcontext():
            _, hist = run_cli(PP_F32_ARGS + extra, vit_pp_launches(3, 4, 2),
                              tag)
        rows = f32[label] = train_rows(hist, tag, 3)
        d_loss = max_diff(rows, f32["--pp 1"], "loss")
        d_norm = max_diff(rows, f32["--pp 1"], "grad_norm")
        print(f"[pipeline] {tag}: max |dloss| {d_loss:.3e}, max |dgnorm| "
              f"{d_norm:.3e} against --pp 1 (tol {PP_TOL})", flush=True)
        if not (d_loss <= PP_TOL and d_norm <= PP_TOL):
            fail(f"{tag} disagrees with --pp 1")
    lap("b")
    # (c) a --pp 2 checkpoint resumed at --pp 1
    d = ROOT / "build" / "ckpt-pipeline"
    shutil.rmtree(d, ignore_errors=True)
    try:
        ck = ["--ckpt-dir", str(d), "--ckpt-sync"]
        run_cli(PP_F32_ARGS + ["--pp", "2", "--stop-after", "2"] + ck,
                vit_pp_launches(2, 4, 2), "vit-b16 fp32 --pp 2 stop-after 2")
        _, hist = run_cli(PP_F32_ARGS + ["--resume"] + ck,
                          vit_pp_launches(1, 4, 1),
                          "vit-b16 fp32 --pp 1 resumed")
        resumed_rows(hist, "pipeline: --pp 2 saved, --pp 1 resumed", [2],
                     {r["step"]: r for r in f32["--pp 2"]})
    finally:
        shutil.rmtree(d, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    lap("c")
    # (d) memory, (e) rates
    pp_memory(card)
    lap("d")
    rates = pp_rates(card)
    lap("e")
    # (f) a decoder through the pipeline: K1-K3 causal GQA at D 128, K4/K5
    # (per microbatch: each layer's two norms forward in both slots and
    # backward once, the final norm forward in both and backward once)
    attn = 3 * 4 * LM_LAYERS
    lm_expect = {"flash_fwd": 2 * attn, "flash_bwd_dq": attn,
                 "flash_bwd_dkv": attn,
                 "rmsnorm_fwd": 3 * 4 * 2 * (2 * LM_LAYERS + 1),
                 "rmsnorm_bwd": 3 * 4 * (2 * LM_LAYERS + 1)}
    lm_launches, hist = run_cli(PP_LM_ARGS, lm_expect,
                                "chatglm3-6b bf16 --pp 2")
    rows = train_rows(hist, "chatglm3-6b bf16 --pp 2", 3)
    print(f"[pipeline] chatglm3-6b (4 layers, 8 x 1024, accum 4) --pp 2: "
          f"losses {[round(r['loss'], 4) for r in rows]}; step_ok all 1",
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    lap("f")
    # (g) two ranks on one card
    if torch.cuda.device_count() < 2:
        from repro_torch.launch.train import main as cli
        try:
            cli(PP_ARGS + ["--pp", "2", "--devices", "2"])
        except RuntimeError as e:
            print(f"[pipeline] --devices 2 --pp 2 on "
                  f"{torch.cuda.device_count()} card: {e}", flush=True)
        else:
            fail("--devices 2 --pp 2 on one card did not raise")
    print(f"[pipeline] phase 18 in {time.time() - t0:.1f}s on {card}",
          flush=True)
    return launches["--pp 2"], lm_launches, rates


# Phase 19, tensor parallelism on the one card: ranks spawned over gloo
# (each collective staged through host memory), every rank on the card,
# each running the training CLI's ``run``. The fp32 gate is the
# reference's tensor-parallel bound (tests/test_engine_distributed.py:
# 92-101); the ViT's fp32 runs are held against phase 8b's one-card fp32
# run (DP_F32_ARGS)
TP_TOL = 3e-4
TP_VIT_BF16_ARGS = ["--arch", "vit-b16", "--steps", "3", "--batch", "128",
                    "--accum", "2", "--eval-every", "3", "--eval-batch",
                    "128", "--log-every", "1"]
# ChatGLM3-6B at full width, 4 of 28 layers, fp32, 2 steps of 2 x 1024
TP_LM_ARGS = ["--arch", "chatglm3-6b", "--layers", str(LM_LAYERS), "--seq",
              str(LM_SEQ), "--batch", "2", "--accum", "1", "--steps", "2",
              "--dtype", "float32", "--log-every", "1"]
TP_LM_STEPS = 2
# ChatGLM3-6B's attention on one rank of model axis 4 (one microbatch of 2
# x 1024): 8 of its 32 query heads and the one KV head of its 2 they use,
# a head slice of the whole KV projection (D6)
TP_RANK_SHAPE = (2, 8, 1, LM_SEQ, LM_SEQ, 128)
# 19f-h: the families of ROADMAP item 16.1b at full width, fp32, 2 steps
# of 2 x 1024 (accum 1): Zamba2-2.7B at 6 layers (one group: the shared
# block once), Granite-MoE 3B-A800M at 2 layers, GShard and gather (the
# config's moe_impl, which the CLI has no flag for, as the reference's),
# RWKV6-7B at 2 layers with the group norm's eps at RWKV_GATE_EPS (phase
# 10's fp32 gate condition) and SGD (AdamW's first step is lr·sign(g),
# and near-zero gradient entries take either sign under two orders of
# summation). Their params are the training phases' seed-0 draws on the
# host (phases 10, 13 and 17), cut to these layers: no new draw
TP_FAMILY_STEPS = 2
TP_ZAMBA_LAYERS = 6
TP_FAMILY_RUN = ["--seq", str(LM_SEQ), "--batch", "2", "--accum", "1",
                 "--steps", str(TP_FAMILY_STEPS), "--dtype", "float32",
                 "--log-every", "1"]
# tag -> (arch, layers, extra CLI flags, config fields without a flag)
TP_FAMILIES = {
    "zamba2": (ZAMBA, TP_ZAMBA_LAYERS, [], {}),
    "granite": (GRANITE, 2, [], {}),
    "granite-gather": (GRANITE, 2, [], {"moe_impl": "gather"}),
    "rwkv6": ("rwkv6-7b", 2, ["--optimizer", "sgd"],
              {"norm_eps": RWKV_GATE_EPS}),
}
# 19j: DeepSeek-V3 at full width, cut as phase 14 cuts it (one MoE layer
# of DS_EXPERTS routed experts, the shared expert, the MTP head: fields
# the CLI has no flag for), fp32, 2 steps of 2 x 1024, SGD (one fp32
# moment, not AdamW's two, over 3.476 B params), on phase 14's draw
TP_DS_STEPS = 2
TP_DS_ARGS = ["--arch", DEEPSEEK, "--seq", str(LM_SEQ), "--batch", "2",
              "--accum", "1", "--steps", str(TP_DS_STEPS), "--dtype",
              "float32", "--optimizer", "sgd", "--log-every", "1"]
# 19k: pipeline x tensor parallelism in the world of 4 (pipe 2 x model 2):
# the ViT's fp32 run (DP_F32_ARGS, 2 microbatches) and ChatGLM3-6B's
# TP_LM_ARGS at 2 microbatches of 1 x 1024, flat and interleaved, each
# held against the one-rank run of the same batches (the loss and the
# grad norm are the microbatches' mean)
TP_PP = ["--pp", "2", "--model-axis", "2", "--devices", "4"]
TP_PP_LM_ARGS = ["--arch", "chatglm3-6b", "--layers", str(LM_LAYERS),
                 "--seq", str(LM_SEQ), "--batch", "2", "--accum", "2",
                 "--steps", str(TP_LM_STEPS), "--dtype", "float32",
                 "--log-every", "1"]
# 19i: the split-row K4/K5 at Zamba2's inner norm in 19f: 2 x 1024 rows of
# its 5120 columns, split 2 and 4 ways
TP_SPLIT_ROWS, TP_SPLIT_WIDTH = 2 * LM_SEQ, 5120
SPLIT_NAMES = ("rmsnorm_sumsq", "rmsnorm_fwd_split", "rmsnorm_bwd_dot",
               "rmsnorm_bwd_split")
# 19l: Ulysses sequence parallelism (the label's prefix before the model
# axis): the fp32 ViT at model axis 2 and 4 and ChatGLM3-6B's TP_LM_ARGS at
# 2, each held against its one-rank run; a rank's peak beside the
# tensor-parallel job's at the same model axis (TP_PEAK_PAIRS)
ULYSSES = "--seq-parallel ulysses --model-axis"
# 19n: Granite-MoE under Ulysses (ROADMAP 16.2b), the TP_FAMILIES runs
# (GShard and gather) at model 2 and 4 on the same host draw: a rank's
# 1,024 / M rows of each sequence, its H/M query and KH/M KV heads over
# every row inside attention, E/M routed experts on the gathered rows;
# against the one-rank runs (losses, grad norms and moe_aux within
# TP_TOL), the routings that differ printed
GRANITE_ULYSSES = ("granite", "granite-gather")
TP_PEAK_PAIRS = [(f"vit-b16 fp32 {ULYSSES} 2", "vit-b16 fp32 --model-axis 2"),
                 (f"vit-b16 fp32 {ULYSSES} 4", None),
                 (f"chatglm3-6b fp32 {ULYSSES} 2",
                  "chatglm3-6b fp32 --model-axis 2")] + [
    (f"{tag} fp32 {ULYSSES} {m}", f"{tag} fp32 --model-axis {m}")
    for tag in GRANITE_ULYSSES for m in (2, 4)]
# 19m: serving across ranks (ROADMAP item 16.3, deviation D9), in the two
# worlds above after their training jobs. (m1) the serve CLI's run
# (SERVE_ARGS) at model axis 2 in the world of 2 and at data 2 x model 2
# in the world of 4, on phase 15's host draw; (m2) a prefill and
# DECODE_STEPS teacher-forced decode steps through ``Server`` for each
# TP_SERVE_MODELS entry at model axis 2 (the world of 2) and ChatGLM3-6B at
# TP_LM_ARGS' width and depth at model axis 4 (the world of 4; D6: one KV
# head a rank), fp32 (RWKV6 at its gate eps), each step's logits gathered
# whole against the one-rank decode's (SERVE_ONE_RANK: phases 15 and 17,
# and ChatGLM3-6B's in phase 19's parent)
TP_SERVE_MODELS = DECODE_MODELS + ZAMBA_DECODE
# (m4) DeepSeek-V3's latent cache split on the sequence over the model
# group (ROADMAP 16.3b, a distributed flash-decoding): its DECODE_MODELS
# entry at model 2 (the world of 2, above) and 4, and at model 4 with a
# cache of 2·LM_SEQ rows (the prompt fills ranks 0-1, the decode rows land
# on rank 2, rank 3 holds no live row); each against the one-rank decode,
# its latent cache a 1/M share of the whole, its decode step's collective
# bytes against a recording world's
TP_DS_DECODE = next(e for e in DECODE_MODELS if e[0] == "deepseek")
TP_DS_DECODE_LONG = TP_DS_DECODE[:5] + (2 * LM_SEQ,) + TP_DS_DECODE[6:]
TP_SERVE_LM = ("chatglm3", "chatglm3-6b", LM_LAYERS, 2, LM_SEQ,
               LM_SEQ + DECODE_STEPS, {}, None)
TP_SERVE_CLI = {2: ["--devices", "2", "--model-axis", "2"],
                4: ["--devices", "4", "--model-axis", "2"]}
# (m3) K1 at a model-axis-2 rank's prefill shapes: label, shape (B, H, KH,
# S, T, D[, Dv]), window, the one-rank shape it is timed beside (None: not
# timed). Qwen2.5's serve run (phase 15 times its one-rank shape), Zamba2's
# at 16 heads of D 80, Gemma3's local layers past the window, MLA
TP_PREFILL_CASES = [
    ("qwen2.5 model 2", (SERVE_BATCH, 20, 4, SERVE_PROMPT,
                         SERVE_PROMPT + SERVE_GEN, 128), 0,
     PREFILL_CASES[0][1]),
    ("zamba2 model 2", (SERVE_BATCH, 16, 16, SERVE_PROMPT,
                        SERVE_PROMPT + SERVE_GEN, 80), 0,
     PREFILL_CASES[3][1]),
    ("gemma3 local model 2", (1, 8, 4, 1100, 1104, 256), GEMMA_WINDOW, None),
    ("mla model 2", (2, 64, 64, LM_SEQ, LM_SEQ + 8, 192, 128), 0, None),
]
# K6 at RWKV6's prefill on a model-axis-2 rank (B, S, H, P, chunk), from a
# nonzero state; the split-row K4 at Zamba2's inner norm of a decode step
# (rows, width) split 2 ways
TP_WKV_PREFILL = (2, 512, 32, 64, 32)
TP_SPLIT_DECODE = (2, 5120)
# tag -> (the one-rank decode's fp32 logits, numpy (B, 1 + DECODE_STEPS,
# vocab): the prefill's last position, then each step's; its cache's GB)
SERVE_ONE_RANK = {}
# (config name, layers) -> the fingerprint of phase 15's card draw of
# Qwen2.5 (the serve CLI's), Qwen2-VL and Gemma3: 19m's ranks draw them
# again on the card (``serve_params``), not from phase 19's file (the
# chip machine takes ~45 GiB of disk writes a call, and its host 96 GiB
# of memory: neither holds their 33.5 GB besides)
SERVE_PRINTS = {}
# 19o: ``embed_sharding="dmodel"`` (ROADMAP item 18) in the world of 2 at
# model axis 2, after its serving jobs: Gemma3-12B (tied: the head a
# row-parallel product over the split features) and Qwen2.5-14B (untied:
# the lookup alone changes) at full width cut to EMBED_LAYERS layers,
# fp32, EMBED_STEPS steps of 2 x EMBED_SEQ (accum 1), SGD, through the
# ``Trainer``; each rank draws the seed-0 params again on the card
# (CARD_DRAWS: the parent's one-rank run draws the same), takes the
# one-rank loss's gradient of ``embed.tok`` on them whole (no model group)
# and keeps its own columns of it on the host, all before its counts are
# set to 0; then the main path: the first batch's gradient of its columns
# against those, its steps' losses and grad norms against the parent's
# one-rank run, all within EMBED_TOL; and Gemma3's
# decode of 19m2 under "dmodel", its fp32 logits within EMBED_SERVE_TOL
# of the one-rank decode's and the same greedy tokens
EMBED_TRAIN = {"gemma3": "gemma3-12b", "qwen2.5": QWEN}
EMBED_LAYERS, EMBED_SEQ, EMBED_STEPS = 2, 256, 2
EMBED_TOL, EMBED_SERVE_TOL = 5e-5, 5e-4
# 19o's gradient columns: also within this share of their largest
# magnitude (the loss is a mean over 512 tokens, so the entries are small)
EMBED_GRAD_REL = 1e-2


def family_argv(tag):
    arch, layers, extra, _ = TP_FAMILIES[tag]
    return ["--arch", arch, "--layers", str(layers)] + extra + TP_FAMILY_RUN


def family_expect(tag, m):
    """(launches a rank, the (query, KV) heads ``flash_mha`` sees, the
    heads ``wkv6`` sees) of a TP_FAMILIES run at model axis ``m`` (1: one
    rank, the inner norm whole-row)."""
    from repro_torch.configs import get_config

    arch, layers, _, _ = TP_FAMILIES[tag]
    cfg, s = get_config(arch), TP_FAMILY_STEPS
    # a KV head a rank where the model axis does not divide them (D6)
    heads = [(cfg.num_heads // m, cfg.num_kv_heads // m
              if cfg.num_kv_heads % m == 0 else 1)]
    if tag == "zamba2":
        groups = layers // cfg.hybrid_group
        attn = s * groups
        inner = s * layers
        norms = s * (layers + 2 * groups + 1) + (inner if m == 1 else 0)
        out = dict(dict.fromkeys(("flash_fwd", "flash_bwd_dq",
                                  "flash_bwd_dkv"), attn),
                   rmsnorm_fwd=norms, rmsnorm_bwd=norms)
        if m > 1:
            out.update(dict.fromkeys(SPLIT_NAMES, inner))
        return out, heads, []
    norms = s * (2 * layers + 1)
    if tag == "rwkv6":
        return {"wkv6_fwd": s * layers, "wkv6_bwd": s * layers,
                "rmsnorm_fwd": norms, "rmsnorm_bwd": norms}, [], \
            [cfg.num_heads // m]
    attn = s * layers
    return dict(dict.fromkeys(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
                              attn), rmsnorm_fwd=norms,
                rmsnorm_bwd=norms), heads, []


# one job of a phase-19 world: ``expect`` the launches a rank (a list by
# rank where the ranks' stages differ), ``heads`` the (query, KV) heads
# ``flash_mha`` sees and ``wkv`` the heads ``wkv6`` sees, ``ref`` the
# one-rank rows' key (None: no fp32 reference), ``fields`` config fields
# without a CLI flag; ``after`` a marker the ranks wait for before the
# job and ``then`` one they leave after it (once every rank has freed its
# memory), so the other world's jobs keep off the card's memory; ``kind``
# "train" (the training CLI's ``run``), "serve" (the serve CLI's ``run``),
# "decode" (``rank_decode`` of ``case``: (a TP_SERVE_MODELS entry, model
# axis)) or "embed" (``rank_embed_train`` of ``case``: (an EMBED_TRAIN
# tag,)); ``embed`` the embedding's layout (``embed_sharding``)
TPJob = collections.namedtuple(
    "TPJob",
    "label argv expect heads wkv ref fields after then kind case embed",
    defaults=({}, None, None, "train", None, "vocab"))


def ds_expect(steps):
    """DeepSeek-V3's launches a rank a run (the cut of phase 14): per
    step K1-K3 twice (the MoE layer, the MTP block), K4/K5 12 times."""
    return dict({k: 2 * steps for k in ("flash_fwd", "flash_bwd_dq",
                                        "flash_bwd_dkv")},
                rmsnorm_fwd=12 * steps, rmsnorm_bwd=12 * steps)


def pp_tp_expect(layers, micro, norms):
    """A pipe-2 x model-2 run's launches by rank (rank ``(d * 2 + p) * 2 +
    m`` is stage p): each of the stage's ``layers`` layers runs K1 in the
    forward slot and again in the backward slot's recompute, K2/K3 once,
    its ``norms`` norms K4 in both slots and K5 once, the last stage's
    final norm too (decoders only), over ``micro`` microbatches."""
    out = []
    for p in (0, 0, 1, 1):
        n = layers * norms + (p == 1 and norms > 0)
        out.append(dict({"flash_fwd": 2 * layers * micro,
                         "flash_bwd_dq": layers * micro,
                         "flash_bwd_dkv": layers * micro},
                        **({"rmsnorm_fwd": 2 * n * micro,
                            "rmsnorm_bwd": n * micro} if norms else {})))
    return out


def serve_cfg(entry):
    """The fp32 config of a TP_SERVE_MODELS entry (or TP_SERVE_LM), at
    its gate's norm eps: the one-rank decode's gated fp32 run."""
    _, arch, layers, _, _, _, kw, gate_eps = entry
    return decode_cfg(arch, layers, kw).replace(
        dtype="float32", **({"norm_eps": gate_eps} if gate_eps else {}))


def serve_expect(entry, m):
    """(launches a rank, the (query, KV) heads ``flash_mha`` sees, the
    heads ``wkv6`` sees) of a prefill and DECODE_STEPS decode steps of
    ``entry`` at model axis ``m``: K1 once an attention layer (a hybrid's:
    once a group) in the prefill only, K6 once an RWKV6 layer in the
    prefill only, K4 on every norm of every forward (MLA's two latent
    norms too); under a model group Mamba2's inner norm is the split-row
    K4 (its partial pass, then its split mode)."""
    cfg = serve_cfg(entry)
    L, n = cfg.num_layers, 1 + DECODE_STEPS
    h, kh = cfg.num_heads // m, cfg.num_kv_heads
    kh = kh // m if kh % m == 0 else 1
    if cfg.block_kind == "rwkv6":
        return {"wkv6_fwd": L, "rmsnorm_fwd": n * (2 * L + 1)}, [], [h]
    if cfg.block_kind == "mamba2":
        g = L // cfg.hybrid_group
        out = {"flash_fwd": g, "rmsnorm_fwd": n * (L + 2 * g + 1)}
        if m > 1:
            out.update(rmsnorm_sumsq=n * L, rmsnorm_fwd_split=n * L)
        else:
            out["rmsnorm_fwd"] += n * L
        return out, [(h, kh)], []
    if cfg.block_kind == "mla":
        return {"flash_fwd": L, "rmsnorm_fwd": n * (4 * L + 1)}, \
            [(h, h)], []
    return {"flash_fwd": L, "rmsnorm_fwd": n * (2 * L + 1)}, [(h, kh)], []


def serve_jobs(size):
    """19m's jobs in the world of ``size``: the serve CLI (m1) and the
    teacher-forced decodes (m2). The serve CLI's prefill runs K1 once a
    layer at 20 query and 4 KV heads a rank, K4 twice a layer and once
    more a forward, in the prefill and each of the SERVE_GEN - 1 steps.
    The jobs whose ranks each draw a whole model on the card
    (``serve_params``: the serve CLI's Qwen2.5, Qwen2-VL, Gemma3) keep
    off each other through markers: the world of 2 runs its small decodes
    first, then its card-drawn jobs once the world of 4 has left "w4-idle"
    (after ChatGLM3-6B's decode), and leaves "w2-served"; the world of 4
    then runs its serve CLI (4 ranks, a whole Qwen2.5 each for a moment).
    The world of 4 first runs (m4), DeepSeek-V3 at model 4 with its
    latents split on the sequence, at both cache lengths."""
    from repro_torch.configs import get_config

    qwen = get_config(QWEN)

    def cli(**kw):
        return TPJob(f"serve CLI {' '.join(TP_SERVE_CLI[size])}",
                     SERVE_ARGS + TP_SERVE_CLI[size],
                     {"flash_fwd": SERVE_LAYERS,
                      "rmsnorm_fwd": (2 * SERVE_LAYERS + 1) * SERVE_GEN},
                     [(qwen.num_heads // 2, qwen.num_kv_heads // 2)], [],
                     "serve", kind="serve", **kw)

    def decode(entry, m, embed="vocab", **kw):
        expect, heads, wkv = serve_expect(entry, m)
        rows = f" (cache {entry[5]} rows)" \
            if entry is TP_DS_DECODE_LONG else ""
        if embed != "vocab":
            rows += f" ({embed})"
        return TPJob(f"serve {entry[0]} --model-axis {m}{rows}",
                     ["--arch", entry[1]], expect, heads, wkv, entry[0],
                     kind="decode", case=(entry, m), embed=embed, **kw)
    if size == 4:
        return [decode(TP_DS_DECODE, 4), decode(TP_DS_DECODE_LONG, 4),
                decode(TP_SERVE_LM, 4, then="w4-idle"),
                cli(after="w2-served")]
    drawn = ("qwen2-vl", "gemma3")      # card draws, as phase 15's
    gemma = next(e for e in TP_SERVE_MODELS if e[0] == "gemma3")
    return [decode(e, 2) for e in TP_SERVE_MODELS if e[0] not in drawn] + \
        [cli(after="w4-idle")] + \
        [decode(e, 2) for e in TP_SERVE_MODELS if e[0] in drawn] + \
        [decode(gemma, 2, "dmodel")] + embed_jobs(then="w2-served")


def embed_expect(tag):
    """(launches a rank, the (query, KV) heads ``flash_mha`` sees) of a
    19o training job's main path at model axis 2: the first batch's
    gradients and EMBED_STEPS steps, each a forward and a backward: K1-K3
    once a layer, K4/K5 twice a layer and once for the final norm, at a
    rank's heads (the one-rank reference gradient runs before the counts
    are set to 0)."""
    from repro_torch.configs import get_config

    cfg = get_config(EMBED_TRAIN[tag])
    passes = 1 + EMBED_STEPS
    attn, norms = passes * EMBED_LAYERS, passes * (2 * EMBED_LAYERS + 1)
    return dict(dict.fromkeys(("flash_fwd", "flash_bwd_dq",
                               "flash_bwd_dkv"), attn),
                rmsnorm_fwd=norms, rmsnorm_bwd=norms), \
        [(cfg.num_heads // 2, cfg.num_kv_heads // 2)]


def embed_jobs(then=None):
    """19o's training jobs (``rank_embed_train``), the last leaving the
    marker ``then``."""
    out = []
    for i, tag in enumerate(EMBED_TRAIN):
        expect, heads = embed_expect(tag)
        out.append(TPJob(f"{tag} fp32 --model-axis 2 (dmodel)",
                         ["--arch", EMBED_TRAIN[tag]], expect, heads, [],
                         tag, kind="embed", case=(tag,), embed="dmodel",
                         then=then if i == len(EMBED_TRAIN) - 1 else None))
    return out


def embed_setup(tag, embed, world=None):
    """(the config, the ``Trainer``) of a 19o run: ``EMBED_TRAIN[tag]`` at
    full width cut to EMBED_LAYERS layers, fp32, batch 2 (accum 1), SGD,
    the embedding laid out by ``embed``; on one card, or at model axis 2
    of ``world``."""
    from repro_torch.configs import EngineConfig, get_config
    from repro_torch.core.engine import Trainer

    cfg = get_config(EMBED_TRAIN[tag]).replace(num_layers=EMBED_LAYERS,
                                               dtype="float32")
    ecfg = EngineConfig(train_batch_size=2, optimizer="sgd", lr=1e-2,
                        warmup_steps=1, total_steps=10,
                        embed_sharding=embed)
    return cfg, Trainer(cfg, ecfg, device="cuda", world=world,
                        model_axis=1 if world is None else 2)


def embed_batch(cfg, step):
    """Batch ``step`` of a 19o run: 2 x EMBED_SEQ tokens on the card."""
    from repro_torch.core.engine import to_device
    from repro_torch.launch.specs import concrete_batch

    return to_device(concrete_batch(cfg, 2, EMBED_SEQ, seed=step), "cuda")


def embed_steps(trainer, state):
    """EMBED_STEPS steps of a 19o run: the rows (loss, grad norm,
    step_ok)."""
    rows = []
    for i in range(EMBED_STEPS):
        state, m = trainer.train_step(state, embed_batch(trainer.cfg, i))
        rows.append({k: float(m[k]) for k in ("loss", "grad_norm",
                                              "step_ok")})
    return rows


def embed_one_rank(tag):
    """19o's one-rank run in the parent, on the card's seed-0 draw: (its
    rows, the draw's fingerprint)."""
    from repro_torch.models.transformer import init_params

    cfg, trainer = embed_setup(tag, "vocab")
    params = init_params(cfg, seed=0, device="cuda", draw_on="cuda")
    prints = fingerprint(params)
    return embed_steps(trainer, trainer.init_state(params)), prints


def rank_embed_ref(world, tag):
    """19o's check on one rank of model axis 2, run before the rank's
    counts are set to 0: the ``Trainer`` under "dmodel"; the card's
    seed-0 draw whole; the one-rank loss's gradient of ``embed.tok`` on
    it (no model group installed), this rank's columns of it on the host,
    their largest magnitude, and the largest difference between this
    rank's columns and the other rank's (what a gradient sliced from the
    wrong rank would miss by). Returns ``rank_embed_train``'s argument:
    {"trainer", "params", "check"}."""
    import torch
    from repro_torch.models import shardctx, transformer

    cfg, trainer = embed_setup(tag, "dmodel", world)
    params = transformer.init_params(cfg, seed=0, device=world.device,
                                     draw_on="cuda")
    tok = params["embed.tok"].requires_grad_()
    with shardctx.use(None):
        loss, _ = transformer.loss_fn(cfg, params, embed_batch(cfg, 0))
    whole, = torch.autograd.grad(loss, [tok])
    tok.requires_grad_(False)
    parts, rank = whole.chunk(trainer.tp.size, 1), trainer.tp.rank
    mine, other = parts[rank], parts[(rank + 1) % trainer.tp.size]
    check = {"print": fingerprint(params),
             "ref_max": float(mine.abs().max()),
             "swap_err": float((mine - other).abs().max()),
             "ref": mine.cpu()}
    del whole, parts, mine, other, tok, loss
    return {"trainer": trainer, "params": params, "check": check}


def rank_embed_train(pre):
    """19o's main path on one rank of model axis 2 under "dmodel": the
    rank's chunks of the draw (``init_state``), the first batch's
    gradient of its columns of ``embed.tok`` against the one-rank
    gradient's, then EMBED_STEPS steps. ``pre``: ``rank_embed_ref``'s
    result, emptied (the whole draw goes once the chunks are made)."""
    trainer, check = pre.pop("trainer"), pre.pop("check")
    state = trainer.init_state(pre.pop("params"))
    grads, _ = trainer.grads(state.params, embed_batch(trainer.cfg, 0))
    ref = check.pop("ref")
    err = float((grads["embed.tok"].cpu() - ref).abs().max())
    del grads, ref
    return dict(check, rows=embed_steps(trainer, state), grad_err=err,
                embed_dim=trainer.model_dims["embed.tok"])


def embed_gates(job, ranks, one_rank):
    """19o's gates on every rank of a training job: the main path's
    launches exact, no layout copy, the heads ``flash_mha`` saw (a rank's
    alone); ``embed.tok`` split on its columns; the rank's draw the
    parent's; its losses and grad norms within EMBED_TOL of one rank's,
    ``step_ok`` 1; its gradient columns within EMBED_TOL of one rank's and
    within EMBED_GRAD_REL of their largest magnitude, a bound that zeroed
    columns and the other rank's columns would both miss (checked on the
    reference: its largest magnitude and the two ranks' columns'
    largest difference above it). Returns rank 0's launches."""
    import numpy as np

    want, prints = one_rank
    for rank, got in enumerate(r[job.label] for r in ranks):
        expect = dict({name: 0 for name in counters()}, **job.expect)
        res = got["hist"]
        rows = res["rows"]
        d_loss = max_diff(rows, want, "loss")
        d_norm = max_diff(rows, want, "grad_norm")
        bound = min(EMBED_TOL, EMBED_GRAD_REL * res["ref_max"])
        print(f"[tp-embed] {job.label} rank {rank}/{len(ranks)}: launches "
              f"{got['launches']} (expected {expect}); layout copies "
              f"{got['copies']}; (query, KV) heads {got['heads']} (expected "
              f"{job.heads}); embed.tok split on dimension "
              f"{res['embed_dim']}; losses "
              f"{[round(r['loss'], 5) for r in rows]}; max |dloss| "
              f"{d_loss:.3e}, |dgnorm| {d_norm:.3e}, the embedding's "
              f"gradient columns max |d| {res['grad_err']:.3e} against one "
              f"rank's (tol {EMBED_TOL} and {EMBED_GRAD_REL} x their max "
              f"|g| {res['ref_max']:.3e}: {bound:.3e}; the other rank's "
              f"columns differ by {res['swap_err']:.3e}); "
              f"{got['s']:.1f}s (waited "
              f"{got['waited']:.1f}s before it); peak {got['peak_gb']:.2f} "
              f"GB", flush=True)
        if got["launches"] != expect or got["copies"] or \
                got["heads"] != job.heads:
            fail(f"{job.label} rank {rank}: launches, copies or heads off")
        if res["print"] != prints or res["embed_dim"] != 1:
            fail(f"{job.label} rank {rank}: not the parent's draw, or "
                 f"embed.tok not split on its columns")
        finite = all(np.isfinite([r["loss"], r["grad_norm"]]).all()
                     for r in rows)
        if not (finite and all(r["step_ok"] == 1 for r in rows)
                and d_loss <= EMBED_TOL and d_norm <= EMBED_TOL
                and res["grad_err"] <= bound):
            fail(f"{job.label} rank {rank} disagrees with one rank")
        if not (res["ref_max"] > bound and res["swap_err"] > bound):
            fail(f"{job.label} rank {rank}: the gradient gate would pass "
                 f"zeroed columns or the other rank's")
    return ranks[0][job.label]["launches"]


def tp_jobs():
    """{world size: [TPJob]}: the ranks of a world run its jobs in turn,
    the two worlds at once. The DeepSeek-V3 runs and ChatGLM3-6B under
    Ulysses (every leaf whole on both ranks: ~22 GB a rank with AdamW)
    never share the card with a large job: the world of 4 runs its
    model-4 DeepSeek job first while the world of 2 runs only its fp32 ViT
    jobs (3.4 GB); the world of 2 runs its model-2 DeepSeek job and then
    ChatGLM3 under Ulysses once that has ended, while the world of 4 runs
    only its ViT jobs (4.3 GB) and waits for both before the rest. Each
    world ends with 19m's serving jobs (``serve_jobs``)."""
    from repro_torch.configs import get_config

    vit_f32 = dict.fromkeys(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
                            3 * 2 * 12)
    vit_bf16 = dict(vit_f32, flash_fwd=3 * 2 * 12 + 4 * 12)
    lm = dict(dict.fromkeys(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
                            TP_LM_STEPS * LM_LAYERS),
              rmsnorm_fwd=TP_LM_STEPS * (2 * LM_LAYERS + 1),
              rmsnorm_bwd=TP_LM_STEPS * (2 * LM_LAYERS + 1))
    ds_fields = {"num_layers": DS_LAYERS, "moe": deepseek_kw()["moe"]}
    ds_heads = get_config(DEEPSEEK).num_heads

    def ds(m, **kw):
        return TPJob(f"deepseek-v3 fp32 --model-axis {m}",
                     TP_DS_ARGS + ["--devices", str(m), "--model-axis",
                                   str(m)], ds_expect(TP_DS_STEPS),
                     [(ds_heads // m, ds_heads // m)], [], "deepseek",
                     ds_fields, **kw)

    def families(m):
        out = []
        for tag, (_, _, _, fields) in TP_FAMILIES.items():
            expect, heads, wkv = family_expect(tag, m)
            out.append(TPJob(f"{tag} fp32 --model-axis {m}",
                             family_argv(tag) + ["--devices", str(m),
                                                 "--model-axis", str(m)],
                             expect, heads, wkv, tag, fields))
        return out
    def uly(m):
        return ["--devices", str(m), "--model-axis", str(m),
                "--seq-parallel", "ulysses"]

    def granite_ulysses(m):
        # 19n: K1-K3 at (24/M, 8/M) heads over all 1,024 rows, K4/K5 on
        # a rank's 1,024/M rows of each sequence: the TP runs' counts
        out = []
        for tag in GRANITE_ULYSSES:
            expect, heads, wkv = family_expect(tag, m)
            out.append(TPJob(f"{tag} fp32 {ULYSSES} {m}",
                             family_argv(tag) + uly(m), expect, heads, wkv,
                             tag, TP_FAMILIES[tag][3]))
        return out
    lm_pp = pp_tp_expect(LM_LAYERS // 2, TP_LM_STEPS * 2, 2)
    return {
        2: [TPJob("vit-b16 fp32 --model-axis 2",
                  DP_F32_ARGS + ["--devices", "2", "--model-axis", "2"],
                  vit_f32, [(6, 6)], [], "vit"),
            # 19l: Ulysses, the ViT's 197 rows split 99/98, 6 heads a rank
            TPJob(f"vit-b16 fp32 {ULYSSES} 2", DP_F32_ARGS + uly(2),
                  vit_f32, [(6, 6)], [], "vit"),
            ds(2, after="ds-m4"),
            # 19l: ChatGLM3 under Ulysses at its full width: 512 rows of
            # each 1,024-token sequence a rank, 16 query heads and the one
            # KV head of 2 they use
            TPJob(f"chatglm3-6b fp32 {ULYSSES} 2", TP_LM_ARGS + uly(2), lm,
                  [(16, 1)], [], "lm", then="ds-m2"),
            TPJob("vit-b16 bf16 --model-axis 2",
                  TP_VIT_BF16_ARGS + ["--devices", "2", "--model-axis", "2"],
                  vit_bf16, [(6, 6)], [], None)] + families(2) + \
            granite_ulysses(2) + [
            TPJob("chatglm3-6b fp32 --model-axis 2",
                  TP_LM_ARGS + ["--devices", "2", "--model-axis", "2"], lm,
                  [(16, 1)], [], "lm")] + serve_jobs(2),
        4: [ds(4, then="ds-m4"),
            TPJob("vit-b16 fp32 data 2 x --model-axis 2 --zero 3",
                  DP_F32_ARGS + ["--devices", "4", "--model-axis", "2",
                                 "--zero", "3"], vit_f32, [(6, 6)], [],
                  "vit"),
            TPJob("vit-b16 fp32 --pp 2 --model-axis 2", DP_F32_ARGS + TP_PP,
                  pp_tp_expect(6, 3 * 2, 0), [(6, 6)], [], "vit"),
            # 19l: Ulysses, 197 rows split 50/49/49/49, 3 heads a rank
            TPJob(f"vit-b16 fp32 {ULYSSES} 4", DP_F32_ARGS + uly(4),
                  vit_f32, [(3, 3)], [], "vit"),
            TPJob("chatglm3-6b fp32 --model-axis 4 (D6)",
                  TP_LM_ARGS + ["--devices", "4", "--model-axis", "4"], lm,
                  [(8, 1)], [], "lm", after="ds-m2"),
            TPJob("chatglm3-6b fp32 --pp 2 --model-axis 2",
                  TP_PP_LM_ARGS + TP_PP, lm_pp, [(16, 1)], [], "lm"),
            TPJob("chatglm3-6b fp32 --pp 2 --pp-interleave 2 --model-axis 2",
                  TP_PP_LM_ARGS + TP_PP + ["--pp-interleave", "2"], lm_pp,
                  [(16, 1)], [], "lm")]
        + families(4) + granite_ulysses(4) + serve_jobs(4)}


def held_params(draws, cfg):
    """The held host draw of seed 0 for ``cfg`` from ``draws`` ({(config
    name, layers): params}): the one of its depth, or a deeper one of the
    same config cut to its first layers (as the training phases cut
    theirs), with only the keys ``cfg`` has; None when none is held. Fails
    when the leaves do not fit the config."""
    from repro_torch.core.sharding import is_stacked
    from repro_torch.models.transformer import init_params as meta_init

    depths = sorted(n for name, n in draws
                    if name == cfg.name and n >= cfg.num_layers)
    if not depths:
        return None
    held, cut = draws[cfg.name, depths[0]], depths[0] > cfg.num_layers
    want = {k: tuple(v.shape) for k, v in
            meta_init(cfg, device="meta").items()}
    out = {k: held[k][:cfg.num_layers] if cut and is_stacked(k) else held[k]
           for k in want if k in held}
    if {k: tuple(v.shape) for k, v in out.items()} != want:
        fail(f"{cfg.name}: the held params do not fit the config")
    return out


@contextlib.contextmanager
def held_draws(draws, on_host=False):
    """The CLI's ``init_params`` (``launch.train``) copies the held host
    params ``draws`` ({(config name, layers): params}; ``held_params``)
    for a seed-0 draw of those configs instead of drawing again; any other
    draw as before. ``on_host``: hand out the host tensors themselves (in
    a rank, the pages of the parent's memory-mapped files), of which the
    ``Trainer``'s ``init_state`` copies only the rank's chunks to the
    card."""
    from repro_torch.launch import train

    real = train.init_params

    def init_params(cfg, *, seed=0, device="cuda", draw_on="cpu"):
        held = held_params(draws, cfg) if seed == 0 and draw_on == "cpu" \
            else None
        if held is None:
            return real(cfg, seed=seed, device=device, draw_on=draw_on)
        return held if on_host else \
            {k: v.to(device, copy=True) for k, v in held.items()}
    train.init_params = init_params
    try:
        yield
    finally:
        train.init_params = real


def serve_params(cfg, draws, prints, device):
    """A 19m rank's seed-0 params of ``cfg``: drawn again on ``device``
    (the rank's card) where phase 15's was a card draw (``prints`` holds
    its fingerprint, checked: a card's draw repeats from its seed), else
    the held host draw (``held_params``)."""
    from repro_torch.models.transformer import init_params

    key = (cfg.name, cfg.num_layers)
    if key in prints:
        params = init_params(cfg, seed=0, device=device, draw_on="cuda")
        if fingerprint(params) != prints[key]:
            fail(f"{key}: the card's draw again is not phase 15's")
        return params
    held = held_params(draws, cfg)
    if held is None:
        fail(f"{cfg.name}: no held draw for a serving job")
    return held


@contextlib.contextmanager
def held_serve(draws, prints, device):
    """The serve CLI's ``init_params`` hands out ``serve_params``: a rank
    never draws on the host, and ``Server`` keeps only its parts."""
    from repro_torch.launch import serve

    real = serve.init_params

    def init_params(cfg, *, seed=0, **_):
        if seed != 0:
            fail(f"{cfg.name}: the serve CLI drew seed {seed}")
        return serve_params(cfg, draws, prints, device)
    serve.init_params = init_params
    try:
        yield
    finally:
        serve.init_params = real


def serve_decode(server, entry):
    """A prefill of ``entry``'s prompt (``decode_batch``, seed 1, as phase
    15's) and DECODE_STEPS teacher-forced decode steps through ``server``
    (one rank, or this rank of its layout): (the prefill's last logits and
    each step's, whole, a numpy array (B, 1 + DECODE_STEPS, vocab), the
    rank's cache's GB)."""
    import torch

    tag, _, _, batch, s, max_len, _, _ = entry
    full = decode_batch(server.cfg, tag, batch, s + DECODE_STEPS, seed=1)
    prompt = {k: v[:, :s] if k != "image_embeds" else v
              for k, v in full.items()}
    cache = server.init_cache(batch, max_len, torch.float32)
    last, cache = server.prefill(prompt, cache)
    outs = [last[:, 0]]
    for i in range(DECODE_STEPS):
        logits, cache = server.decode_logits(
            cache, full["tokens"][:, s + i:s + i + 1], s + i)
        outs.append(logits[:, 0])
    # numpy: a rank's result crosses to the parent pickled
    logits = server.gather_rows(torch.stack(outs, 1)).cpu().numpy()
    return logits, nbytes(cache) / 1e9


def rank_decode(world, draws, prints, entry, m, embed="vocab"):
    """19m2 on one rank: ``serve_decode`` of ``entry`` through a
    ``Server`` at model axis ``m`` on ``serve_params``, its embedding laid
    out by ``embed`` (19o: "dmodel"). For MLA (19m4) also
    whether the Server split the latents, and the collective bytes by
    kind of the first decode step (``count_collectives``, reset just
    before it) beside a recording world's count of the same step
    (``recorded_decode``)."""
    from repro_torch.core import distributed
    from repro_torch.core.engine import Server

    cfg = serve_cfg(entry)
    t0 = time.time()
    server = Server(cfg, serve_params(cfg, draws, prints, world.device),
                    world=world, model_axis=m, embed_sharding=embed)
    init_s = time.time() - t0
    step = {}
    real = server.decode_logits

    def decode_logits(cache, token, index):
        if step:
            return real(cache, token, index)
        distributed.reset_collectives()
        out = real(cache, token, index)
        step.update(counts=distributed.count_collectives(), index=index)
        return out
    server.decode_logits = decode_logits
    logits, cache_gb = serve_decode(server, entry)
    out = {"logits": logits, "cache_gb": cache_gb, "init_s": init_s,
           "embed_dim": server.model_dims.get("embed.tok")}
    if cfg.block_kind == "mla":
        out.update(latents=server.latents, collectives=(
            step["counts"], recorded_decode(cfg, entry, world, m,
                                            step["index"])))
    return out


def recorded_decode(cfg, entry, world, m, index):
    """The collective bytes by kind of one decode step of ``entry`` at
    ``index``, taken again by rank ``world.rank`` of a recording world of
    ``world.size`` on ``meta`` (a ``Server`` at model axis ``m`` with a
    cache of the entry's rows)."""
    import torch
    from repro_torch.core import distributed
    from repro_torch.core.engine import Server
    from repro_torch.models.transformer import init_params

    _, _, _, batch, _, max_len, _, _ = entry
    server = Server(cfg, init_params(cfg, device="meta"), device="meta",
                    world=distributed.recording_world(world.rank,
                                                      world.size),
                    model_axis=m)
    cache = server.init_cache(batch, max_len, torch.float32)
    distributed.reset_collectives()
    server.decode_logits(cache, torch.empty((batch, 1), dtype=torch.int32,
                                            device="meta"), index)
    return distributed.count_collectives()


@contextlib.contextmanager
def init_spy(seen):
    """Appends to ``seen``, for each ``Trainer.init_state``, the bytes of
    the state's params, those of its params and optimizer moments, and the
    peak of allocated device memory when it returns (the job's peak is
    reset before it): what the rank put on the card of a draw it holds on
    the host."""
    import torch
    from repro_torch.core.engine import Trainer

    real = Trainer.init_state

    def init_state(self, params):
        state = real(self, params)
        torch.cuda.synchronize()

        def nbytes(tree):
            return sum(t.numel() * t.element_size() for t in tree.values())
        moments = [state.opt_state.mu] + ([state.opt_state.nu]
                                          if state.opt_state.nu != () else [])
        own = nbytes(state.params)
        seen.append((own, own + sum(nbytes(m) for m in moments),
                     torch.cuda.max_memory_allocated()))
        return state
    Trainer.init_state = init_state
    try:
        yield
    finally:
        Trainer.init_state = real


def marker_wait(markers, name, timeout_s=600):
    """Block until the marker ``name`` (of the parent or the other world)
    exists; raise at the marker "abort", which the parent leaves when it
    stops early."""
    path, abort = Path(markers) / name, Path(markers) / "abort"
    t0 = time.time()
    while not path.exists():
        if abort.exists() or time.time() - t0 > timeout_s:
            raise RuntimeError(f"phase 19: no marker {name} (the parent "
                               f"stopped, or {timeout_s} s passed)")
        time.sleep(0.1)
    return time.time() - t0


@contextlib.contextmanager
def cli_fields(fields):
    """The CLI's config (``launch.train._config``) with ``fields``
    replaced: the config fields the CLI has no flag for."""
    from repro_torch.launch import train

    real = train._config
    train._config = lambda args: real(args).replace(**fields)
    try:
        yield
    finally:
        train._config = real


@contextlib.contextmanager
def head_spies(routes):
    """Records the (query, KV) heads of every ``flash_mha`` call and the
    heads of every ``wkv6`` call, and appends each MoE routing's expert
    indices (``moe.top_k``, one call a layer and microbatch) to
    ``routes``: yields (attention heads, WKV6 heads)."""
    from repro_torch.models import attention, moe, rwkv6

    attn, wkv = [], []
    real_mha, real_wkv, real_top_k = attention.flash_mha, rwkv6.wkv6, \
        moe.top_k

    def mha(q, k, v, **kw):
        attn.append((q.shape[2], k.shape[2]))
        return real_mha(q, k, v, **kw)

    def wkv6(r, *a, **kw):
        wkv.append(r.shape[2])
        return real_wkv(r, *a, **kw)

    def top_k(probs, k):
        out = real_top_k(probs, k)
        if probs.device.type != "meta":     # not a recording world's step
            routes.append(out[1].detach().cpu().numpy())
        return out
    attention.flash_mha, rwkv6.wkv6, moe.top_k = mha, wkv6, top_k
    try:
        yield attn, wkv
    finally:
        attention.flash_mha, rwkv6.wkv6, moe.top_k = real_mha, real_wkv, \
            real_top_k


def write_draws(draws, path):
    """Write the host draws ``{(config name, layers): {key: tensor}}`` raw
    into ``path`` (each tensor's bytes at a 64-byte aligned offset) and
    their index into ``path``.json: no archive, no checksum, and the
    writes release the interpreter, so a thread writes it beside the
    one-rank runs. Returns the seconds it took."""
    import torch

    t0 = time.time()
    index, off = [], 0
    with open(path, "wb") as f:
        for (name, layers), params in draws.items():
            for key, t in params.items():
                t = t.detach().contiguous()
                pad = -off % 64
                f.write(b"\0" * pad)
                off += pad
                f.write(t.reshape(-1).view(torch.uint8).numpy())
                index.append([name, layers, key, str(t.dtype).split(".")[-1],
                              list(t.shape), off])
                off += t.numel() * t.element_size()
    Path(f"{path}.json").write_text(json.dumps(index))
    return time.time() - t0


def fingerprint(params):
    """The first values of every leaf: enough to tell two draws apart."""
    return {k: v.reshape(-1)[:8].tolist() for k, v in params.items()}


def read_draws(path):
    """The draws of :func:`write_draws`, each tensor a view of the file
    mapped copy-on-write: a page is read when a rank first touches it."""
    import numpy as np
    import torch

    buf = torch.from_numpy(np.memmap(path, dtype=np.uint8, mode="c"))
    draws = {}
    for name, layers, key, dtype, shape, off in json.loads(
            Path(f"{path}.json").read_text()):
        dt = getattr(torch, dtype)
        n = math.prod(shape) * dt.itemsize
        draws.setdefault((name, layers), {})[key] = \
            buf[off:off + n].view(dt).view(shape)
    return draws


# phase 19 (b): the jobs whose first step's collective bytes a rank holds
# against a recording world's count of the same step (the dry run's world)
COUNTED_JOBS = ("vit-b16 fp32 data 2 x --model-axis 2 --zero 3",
                f"chatglm3-6b fp32 {ULYSSES} 2",
                "chatglm3-6b fp32 --pp 2 --model-axis 2")


@contextlib.contextmanager
def step_spy(seen):
    """Fills ``seen`` at the first ``Trainer.train_step``: the collective
    bytes by kind of that step alone (``count_collectives``, reset just
    before it) and what a recording world needs to take the same step
    (the config, the engine config, the preprocessing, the model axis, the
    batch's shapes and dtypes)."""
    from repro_torch.core import distributed
    from repro_torch.core.engine import Trainer

    real = Trainer.train_step

    def train_step(self, state, batch):
        if seen:
            return real(self, state, batch)
        distributed.reset_collectives()
        out = real(self, state, batch)
        seen.update(counts=distributed.count_collectives(), cfg=self.cfg,
                    ecfg=self.ecfg, preproc=self.preproc,
                    model_axis=self.tp.size if self.tp is not None else 1,
                    batch={k: (tuple(v.shape), v.dtype)
                           for k, v in batch.items()})
        return out
    Trainer.train_step = train_step
    try:
        yield
    finally:
        Trainer.train_step = real


def recorded_collectives(seen, world):
    """The collective bytes by kind of the step ``step_spy`` saw, taken
    again by rank ``world.rank`` of a recording world of ``world.size`` on
    ``meta`` (the guard off: it cannot read a meta tensor)."""
    import torch
    from repro_torch.core import distributed
    from repro_torch.core.engine import Trainer
    from repro_torch.models.transformer import init_params

    trainer = Trainer(seen["cfg"], dataclasses.replace(
        seen["ecfg"], guard_anomalies=False), preproc=seen["preproc"],
        device="meta", world=distributed.recording_world(world.rank,
                                                          world.size),
        model_axis=seen["model_axis"])
    state = trainer.init_state(init_params(seen["cfg"], device="meta"))
    batch = {k: torch.empty(shape, dtype=dtype, device="meta")
             for k, (shape, dtype) in seen["batch"].items()}
    distributed.reset_collectives()
    trainer.train_step(state, batch)
    return distributed.count_collectives()


def tp_rank(world, jobs, draw=(), markers=None, prints=None):
    """One spawned rank of phase 19: each job's CLI ``run`` on this
    rank's share of the world (its config fields replaced as the job
    says), the launch counters reset just before and read just after, the
    heads ``flash_mha`` and ``wkv6`` saw, the MoE routings, the layout
    copies, the bytes its state took on the card at init and the peak of
    allocated memory. ``draw``: the files of the parent's host draws
    ``{(config name, layers): params}`` (:func:`write_draws`), mapped
    once the marker "draws" says it is whole (before the rank's first job
    that is not the ViT's, whose params are drawn in the job), which the
    CLI's
    ``init_params`` hands out for a seed-0 draw of those configs
    (``held_draws``) instead of drawing again (the same values).
    ``markers``: the directory of the markers, "draws" and the jobs'
    ``after``/``then``. ``prints``: SERVE_PRINTS, for ``serve_params``.
    A "serve" job runs the serve CLI's ``run``, a
    "decode" job ``rank_decode`` (19m); their result stands under
    "hist"."""
    import gc
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rms
    from repro_torch.launch import serve, train

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(2)        # six ranks share the host's cores
    draws, out, mapped = {}, {"draws_waited": 0.0}, False
    with held_draws(draws, on_host=True):
        for job in jobs:
            # the ViT draws its own params: its jobs run before the draws'
            # file is whole
            if not mapped and \
                    job.argv[job.argv.index("--arch") + 1] != "vit-b16":
                out["draws_waited"] = marker_wait(markers, "draws")
                mapped = True
                for path in draw or ():
                    draws.update(read_draws(path))
            waited = marker_wait(markers, job.after) if job.after else 0.0
            # 19o's one-rank reference gradient runs outside the counted
            # window: its launches, heads, time and peak are not the job's
            pre = rank_embed_ref(world, *job.case) \
                if job.kind == "embed" else None
            routes, seen, step = [], [], {}
            torch.cuda.reset_peak_memory_stats()
            reset_counters()
            t0 = time.time()
            spy = step_spy(step) if job.label in COUNTED_JOBS else \
                contextlib.nullcontext()
            with cli_fields(job.fields), init_spy(seen), spy, \
                    head_spies(routes) as (attn, wkv):
                if job.kind == "serve":
                    with held_serve(draws, prints, world.device):
                        hist = serve.run(serve.parse_args(job.argv), world)
                elif job.kind == "decode":
                    hist = rank_decode(world, draws, prints, *job.case,
                                       embed=job.embed)
                elif job.kind == "embed":
                    hist = rank_embed_train(pre)
                else:
                    hist = train.run(train.parse_args(job.argv), world)
            torch.cuda.synchronize()
            out[job.label] = {
                "hist": hist, "launches": read_counters(),
                "copies": fa.kernel_layout.copies + rms.row_layout.copies,
                "copies_rms": rms.row_layout.copies,
                "heads": sorted(set(attn)), "wkv_heads": sorted(set(wkv)),
                "routes": routes, "s": time.time() - t0, "waited": waited,
                "init_gb": [tuple(n / 1e9 for n in r) for r in seen],
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
            if step:
                out[job.label]["collectives"] = (
                    step["counts"], recorded_collectives(step, world))
            gc.collect()
            torch.cuda.empty_cache()
            if job.then:
                world.all_reduce(torch.zeros(1, device=world.device), "sum")
                if world.rank == 0:
                    (Path(markers) / job.then).touch()
    return out


def sliced_kv_inputs(seed):
    """``model_layout_inputs``' signature, but K and V one head sliced
    from the model's (B, T, 2, D) projections (the second head: a view
    whose start is D elements in), as a rank of model axis 4 hands
    ChatGLM3-6B's attention to the kernels; drawn on the card from
    ``seed``."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def inputs(b, h, kh, s, t, d, dtype, model_layout, dv=None):
        assert kh == 1 and model_layout and dv in (None, d)

        def mk(n, hh):
            return torch.randn((b, n, hh, d), device="cuda",
                               generator=gen).to(dtype)
        q, do = mk(s, h), mk(s, h)
        k, v = (mk(t, 2)[:, :, 1:2] for _ in range(2))
        return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), \
            do.transpose(1, 2)
    return inputs


def split_row_norms(card):
    """19i: the split-row K4/K5 at Zamba2's inner norm (TP_SPLIT_ROWS rows
    of TP_SPLIT_WIDTH, each part a strided column slice of the whole
    rows), split 2 and 4 ways, in bf16 and fp32: each part's partial sums
    (``fused_rmsnorm_sumsq``, ``fused_rmsnorm_bwd_dot``) summed over the
    parts as the model group's all-reduce sums them, then K4's and K5's
    split modes; out, dx and dscale joined over the parts against the
    plain split-row versions and against the whole-row K4/K5 on the whole
    rows (phase 5's gates: 1e-4 / 6e-2; rinv 1e-4 relative), K5's split
    mode twice for a bitwise equal dscale, no layout copy. Then both
    routes timed at a model-axis-2 rank's part (2048 x 2560), bf16 and
    fp32, beside their plain versions and bounds (no PyTorch call
    computes a row's norm from another rank's sums: no library time).
    Returns the kernel rows of the JSON line (bf16)."""
    import torch
    from repro_torch.kernels import rmsnorm as rms
    from repro_torch.kernels.ref import ref_rmsnorm_apply, \
        ref_rmsnorm_bwd_apply, ref_rmsnorm_bwd_dot, ref_rmsnorm_sumsq

    gen = torch.Generator(device="cuda").manual_seed(29)
    rows, width = TP_SPLIT_ROWS, TP_SPLIT_WIDTH

    def draw(dtype):
        x, dy = (torch.randn((rows, width), device="cuda",
                             generator=gen).to(dtype) for _ in range(2))
        return x, dy, torch.randn(width, device="cuda", generator=gen)

    def split(x, dy, scale, parts, sumsq, apply, dot, bwd):
        ss = sum(sumsq(x[:, c]) for c in parts)
        fwd = [apply(x[:, c], scale[c], ss, width, LM_EPS) for c in parts]
        dots = sum(dot(x[:, c], scale[c], dy[:, c]) for c in parts)
        grads = [bwd(x[:, c], scale[c], r, dy[:, c], dots, width)
                 for c, (_, r) in zip(parts, fwd)]
        return (torch.cat([o for o, _ in fwd], 1), fwd[0][1],
                torch.cat([g for g, _ in grads], 1),
                torch.cat([d for _, d in grads]))
    kernel = (rms.fused_rmsnorm_sumsq, rms.fused_rmsnorm_fwd_split,
              rms.fused_rmsnorm_bwd_dot, rms.fused_rmsnorm_bwd_split)
    plain = (ref_rmsnorm_sumsq, ref_rmsnorm_apply, ref_rmsnorm_bwd_dot,
             ref_rmsnorm_bwd_apply)
    rms.row_layout.copies = 0
    errs = {}
    for m in (2, 4):
        parts = [slice(i * width // m, (i + 1) * width // m)
                 for i in range(m)]
        for dname in ("bfloat16", "float32"):
            dtype, tol = getattr(torch, dname), RMS_TOL[dname]
            x, dy, scale = draw(dtype)
            got = split(x, dy, scale, parts, *kernel)
            again = split(x, dy, scale, parts, *kernel)
            want = split(x, dy, scale, parts, *plain)
            w_out, w_rinv = rms.fused_rmsnorm_fwd(x, scale, LM_EPS)
            whole = (w_out, w_rinv) + rms.fused_rmsnorm_bwd(x, scale, w_rinv,
                                                            dy)
            torch.cuda.synchronize()
            res, ok = {}, True
            for name, ref in (("plain", want), ("whole-row K4/K5", whole)):
                r = [close(g, w, tol) for g, w in zip(got[::2], ref[::2])] \
                    + [close(got[3], ref[3], tol)]
                d_rinv = ((got[1] - ref[1]).abs() / ref[1]).max().item()
                res[name] = (r, d_rinv)
                ok &= all(v[1] for v in r) and d_rinv <= TOL_RINV
            same = torch.equal(got[2], again[2]) and \
                torch.equal(got[3], again[3])
            types = tuple(t.dtype for t in got) == \
                (dtype, torch.float32, dtype, torch.float32)
            ok &= same and types and bool(torch.isfinite(got[1]).all())
            print(f"[tp] split-row K4/K5 {m} parts of ({rows}, {width}) "
                  f"{dname}: " + "; ".join(
                      f"against {name} max|dout|={r[0][0]:.3e} "
                      f"max|ddx|={r[1][0]:.3e} max|ddscale|={r[2][0]:.3e} "
                      f"rel|drinv|={dr:.3e}"
                      for name, (r, dr) in res.items())
                  + f" (tol {tol}, rinv {TOL_RINV}); K5 split bitwise "
                  f"repeatable {same}; dtypes {types} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                fail(f"the split-row K4/K5 disagree at {m} parts {dname}")
            if m == 2 and dtype == torch.bfloat16:
                r = res["plain"][0]
                errs = {"fwd": r[0][0], "bwd": max(r[1][0], r[2][0])}
    if rms.row_layout.copies:
        fail("the split-row K4/K5 copied a column slice they should take "
             "as it is")

    out_rows = []
    d = width // 2
    for dname in ("bfloat16", "float32"):
        x, dy, scale = draw(getattr(torch, dname))
        x, dy, scale = x[:, :d], dy[:, :d], scale[:d].contiguous()
        ss = rms.fused_rmsnorm_sumsq(x)
        _, rinv = rms.fused_rmsnorm_fwd_split(x, scale, ss, width, LM_EPS)
        dot = rms.fused_rmsnorm_bwd_dot(x, scale, dy)
        ms = {"fwd": time_ms(lambda: rms.fused_rmsnorm_fwd_split(
                  x, scale, rms.fused_rmsnorm_sumsq(x), width, LM_EPS)),
              "bwd": time_ms(lambda: rms.fused_rmsnorm_bwd_split(
                  x, scale, rinv, dy, rms.fused_rmsnorm_bwd_dot(x, scale,
                                                                dy),
                  width))}
        plain_ms = {"fwd": time_ms(lambda: ref_rmsnorm_apply(
                        x, scale, ref_rmsnorm_sumsq(x), width, LM_EPS)),
                    "bwd": time_ms(lambda: ref_rmsnorm_bwd_apply(
                        x, scale, rinv, dy, ref_rmsnorm_bwd_dot(
                            x, scale, dy), width))}
        del ss, dot
        # the per-row partials written and the whole rows' sums read back
        work = rms_work(rows, d, x.element_size(), split=True)
        for key, name, line in (("fwd", "rmsnorm_fwd_split", 49),
                                ("bwd", "rmsnorm_bwd_split", 94)):
            bound_ms, bound_by, how = bound(card, *work[key], rate="fp32")
            print(f"[tp] {name} (with its partial pass) timing at a "
                  f"model-axis-2 rank's part ({rows}, {d}) of rows {width} "
                  f"wide, {dname}, on {card}: kernel {ms[key]:.4f} ms, "
                  f"plain {plain_ms[key]:.4f} ms; bound {bound_ms:.4f} ms "
                  f"by {bound_by} ({how})", flush=True)
            if dname == "bfloat16":
                out_rows.append({
                    "name": name, "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
                    "replaces": f"src/repro/kernels/rmsnorm.py:{line}",
                    "shape": [rows, d, width], "launches": None,
                    "max_abs_err": errs[key], "ms": ms[key],
                    "plain_ms": plain_ms[key], "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": None})
    return out_rows


def serve_rank_kernels(card, one_rank_row):
    """19m3: the kernels of serving at a model-axis-2 rank's shapes
    against their plain versions: K1 at each TP_PREFILL_CASES shape
    (``check_prefill_k1``; Qwen2.5's and Zamba2's timed, ``time_prefill_k1``,
    beside the one-rank shape's row: phase 15's ``one_rank_row`` for
    Qwen2.5, Zamba2's timed here); K6 at RWKV6's prefill from a nonzero
    state in fp32, primal only (TP_WKV_PREFILL, phase 6b's gate); the
    split-row K4 forward at Zamba2's inner norm of a decode step
    (TP_SPLIT_DECODE, 2 parts, fp32: the partial sums summed as the model
    group sums them, phase 5's gates). Returns {label: K1's row at the
    rank's shape, with "one_rank": the one-rank shape's}."""
    import torch
    from repro_torch.kernels import rmsnorm as rms
    from repro_torch.kernels import wkv6 as wk
    from repro_torch.kernels.ref import ref_rmsnorm_apply, \
        ref_rmsnorm_sumsq, ref_wkv6_fwd

    inputs = model_layout_inputs(
        torch.Generator(device="cuda").manual_seed(32))
    rows = {}
    for label, shape, window, one_shape in TP_PREFILL_CASES:
        err = check_prefill_k1("tp-serve", label, shape, window, inputs)
        if one_shape is None:
            continue
        row = time_prefill_k1(card, "tp-serve", label, shape, inputs)
        one = one_rank_row if one_shape == PREFILL_CASES[0][1] else \
            time_prefill_k1(card, "tp-serve", label.replace(
                "model 2", "one rank"), one_shape, inputs)
        print(f"[tp-serve] K1 at {label}'s prefill {shape}: "
              f"{row['ms']:.4f} ms against {one['ms']:.4f} ms at the "
              f"one-rank shape {tuple(one['shape'])} (bound "
              f"{row['bound_ms']:.4f} / {one['bound_ms']:.4f} ms; {card})",
              flush=True)
        rows[label] = dict(row, max_abs_err=err, one_rank=one)
    gen = torch.Generator(device="cuda").manual_seed(33)
    b, s, h, p, cs = TP_WKV_PREFILL

    def randn(*shape):
        return torch.randn(shape, device="cuda", generator=gen)
    r, k, v = (randn(b, s, h, p) for _ in range(3))
    wlog = -torch.exp(randn(b, s, h, p) - 0.5)
    u, s0 = 0.3 * randn(h, p), 0.1 * randn(b, h, p, p)
    o, se, _ = wk.wkv6_fwd(r, k, v, wlog, u, s0, chunk=cs,
                           with_states=False)
    torch.cuda.synchronize()
    want_o, want_se, _ = ref_wkv6_fwd(r, k, v, wlog, u, s0, chunk=cs,
                                      with_states=False)
    tol = WKV_TOL["float32"]
    res = {"o": close(o, want_o, tol), "s_end": close(se, want_se, tol)}
    ok = all(x[1] for x in res.values())
    print(f"[tp-serve] K6 at RWKV6's prefill on a model-axis-2 rank "
          f"{TP_WKV_PREFILL} fp32 from a nonzero state: " + " ".join(
              f"max|d{key}|={x[0]:.3e}" for key, x in res.items())
          + f" (tol {tol}, rtol {tol}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("K6 disagrees with its plain version at a rank's prefill")
    rows_, width = TP_SPLIT_DECODE
    x = randn(rows_, width)
    scale = randn(width)
    parts = [slice(0, width // 2), slice(width // 2, width)]
    outs = {}
    for name, sumsq, apply in (
            ("kernel", rms.fused_rmsnorm_sumsq, rms.fused_rmsnorm_fwd_split),
            ("plain", ref_rmsnorm_sumsq, ref_rmsnorm_apply)):
        ss = sum(sumsq(x[:, c]) for c in parts)
        outs[name] = torch.cat([apply(x[:, c], scale[c], ss, width,
                                      LM_EPS)[0] for c in parts], 1)
    err, ok = close(outs["kernel"], outs["plain"], RMS_TOL["float32"])
    print(f"[tp-serve] split-row K4 at Zamba2's inner norm of a decode "
          f"step {TP_SPLIT_DECODE}, 2 parts, fp32: max|dout|={err:.3e} (tol "
          f"{RMS_TOL['float32']}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("the split-row K4 disagrees at a decode step's rows")
    return rows


def serve_gates(job, ranks, cli_tokens):
    """19m's gates on every rank of a world's serving ``job``: the
    launches exact, no row layout copy, the heads ``flash_mha`` and
    ``wkv6`` saw; the serve CLI's tokens (SERVE_BATCH, SERVE_GEN) the same
    on every rank, their agreement with phase 15's one-rank ``cli_tokens``
    and its milliseconds printed (host-staged gloo: a reading); a decode
    job's gathered fp32 logits finite and within TP_TOL of the one-rank
    decode's (SERVE_ONE_RANK), each rank's cache's GB beside one rank's;
    an MLA decode's split latents and collectives (``mla_split_gates``).
    Returns rank 0's launches."""
    import numpy as np

    for rank, got in enumerate(r[job.label] for r in ranks):
        expect = dict({name: 0 for name in counters()}, **job.expect)
        msg = (f"[tp-serve] {job.label} rank {rank}/{len(ranks)}: launches "
               f"{got['launches']} (expected {expect}); layout copies "
               f"{got['copies']}; (query, KV) heads {got['heads']} "
               f"(expected {job.heads}), WKV6 heads {got['wkv_heads']} "
               f"(expected {job.wkv}); {got['s']:.1f}s (waited "
               f"{got['waited']:.1f}s before it); peak {got['peak_gb']:.2f} "
               f"GB")
        res = got["hist"]
        if job.kind == "serve":
            tokens = res["tokens"]
            same = int((tokens == cli_tokens).sum()) \
                if tokens.shape == cli_tokens.shape else -1
            msg += (f"; tokens {tokens.shape}, {same} of {cli_tokens.size} "
                    f"equal to phase 15's one-rank run; prefill "
                    f"{res['prefill_ms']:.1f} ms, decode "
                    f"{res['decode_ms']:.1f} ms ({res['tok_s']:.1f} "
                    f"tokens/s: host-staged gloo collectives between ranks "
                    f"on one card, a reading, not the model axis's rate)")
            ok = tokens.shape == (SERVE_BATCH, SERVE_GEN) and \
                np.array_equal(tokens, ranks[0][job.label]["hist"]["tokens"])
        else:
            want, one_gb = SERVE_ONE_RANK[job.ref]
            logits = res["logits"]
            d = float(np.abs(logits - want).max()) \
                if logits.shape == want.shape else float("inf")
            # 19o: the decode under "dmodel", embed.tok split on its
            # columns, the greedy tokens one rank's
            dmodel = job.embed == "dmodel"
            tol = EMBED_SERVE_TOL if dmodel else TP_TOL
            msg += (f"; logits {logits.shape} max|d| {d:.3e} against one "
                    f"rank's (tol {tol}); cache {res['cache_gb']:.4f} GB "
                    f"a rank, {one_gb:.4f} GB on one rank; the Server's "
                    f"init (its chunks of the host params to the card) "
                    f"{res['init_s']:.1f}s")
            ok = d <= tol and bool(np.isfinite(logits).all())
            if dmodel:
                same = d < float("inf") and np.array_equal(
                    logits.argmax(-1), want.argmax(-1))
                msg += (f"; embed.tok split on dimension "
                        f"{res['embed_dim']}; greedy tokens "
                        f"{'equal to' if same else 'NOT'} one rank's")
                ok = ok and same and res["embed_dim"] == 1
            if "latents" in res:
                ok = mla_split_gates(job, rank, res, one_gb, msg) and ok
                msg = None
        if msg:
            print(msg, flush=True)
        if got["launches"] != expect or got["copies_rms"] or \
                got["heads"] != job.heads or got["wkv_heads"] != job.wkv:
            fail(f"{job.label} rank {rank}: launches, copies or heads off")
        if not ok:
            fail(f"{job.label} rank {rank} disagrees with one rank")
    return ranks[0][job.label]["launches"]


def mla_split_gates(job, rank, res, one_gb, msg):
    """19m4's gates on one rank of an MLA decode job at model axis M: the
    latents split on the sequence (M divides the cache's rows), a rank's
    latent cache exactly 1/M of the whole (D9 kept it whole on every rank:
    L x B x rows x (kv_lora_rank + rope) fp32), and the first decode
    step's collective bytes by kind equal to a recording world's and not
    empty. Prints ``msg`` with the readings; returns whether all hold."""
    entry, m = job.case
    cfg = serve_cfg(entry)
    _, _, layers, batch, _, rows, _, _ = entry
    whole = layers * batch * rows * (cfg.mla.kv_lora_rank
                                     + cfg.mla.qk_rope_head_dim) * 4
    card_b, rec_b = res["collectives"]
    share = abs(res["cache_gb"] * 1e9 - whole / m) < 0.5
    same = card_b == rec_b and sum(card_b.values()) > 0
    print(f"{msg}; latents split on the sequence {res['latents']}: "
          f"{res['cache_gb']:.4f} GB a rank against D9's whole "
          f"{whole / 1e9:.4f} GB on every rank ({one_gb:.4f} GB on one rank "
          f"at {TP_DS_DECODE[5]} rows), 1/{m} {share}; the first decode "
          f"step's collective bytes by kind on the card {card_b}, a "
          f"recording world's count of the same step on meta {rec_b} "
          f"({'equal' if same else 'DIFFERENT'})", flush=True)
    return res["latents"] and share and same


def routing_flips(label, got, want):
    """Print the (token, choice) routings of each MoE call that differ
    from the one-rank run's (a discontinuity to report, not an error)."""
    if len(got) != len(want):
        fail(f"{label}: {len(got)} MoE routings, one rank made {len(want)}")
    flips = [int((g != w).sum()) for g, w in zip(got, want)]
    print(f"[tp] {label}: (token, choice) routings that differ from one "
          f"rank's, by layer and step: {flips} of {want[0].size} each",
          flush=True)


def granite_ulysses_gates(job, rank, size, rows, ref, state_gb):
    """19n's gates on one rank of a Granite-MoE Ulysses job: ``moe_aux``
    within TP_TOL of the one-rank run's at every step (the aux counted
    once over the model group), and the rank's params on the card after
    init its E/M routed experts and every other leaf whole (counted from
    their bytes)."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params as meta_init

    m = int(job.argv[job.argv.index("--model-axis") + 1])
    cfg = get_config(GRANITE).replace(
        num_layers=TP_FAMILIES[job.ref][1], **job.fields)
    e = cfg.moe.num_experts
    params = meta_init(cfg, device="meta")
    experts = sum(p.numel() * 4 for k, p in params.items()
                  if ".experts." in k)
    rest = sum(p.numel() * 4 for k, p in params.items()
               if ".experts." not in k)
    held = (state_gb * 1e9 - rest) / (experts / e)
    d_aux = max_diff(rows, ref, "moe_aux")
    ok = d_aux <= TP_TOL and abs(held - e // m) < 1e-3
    print(f"[tp] {job.label} rank {rank}/{size}: moe_aux "
          f"{[round(r['moe_aux'], 6) for r in rows]}, max |dmoe_aux| "
          f"{d_aux:.3e} against one rank (tol {TP_TOL}); routed experts on "
          f"the card after init {held:.3f} of {e} (expected E/M = "
          f"{e // m}), every other leaf whole ({rest / 1e9:.3f} GB) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"{job.label} rank {rank}: moe_aux or the experts held off")


def phase_tp(card, f32_ref, family_params, serving):
    """Phase 19, tensor parallelism with every rank on the one card (gloo,
    collectives staged through host memory; NCCL refuses two ranks on one
    card): (d) K1-K3 at a model-axis-4 rank's shape of ChatGLM3-6B (a KV
    head sliced from the whole projection) against their plain versions;
    (i) the split-row K4/K5 (``split_row_norms``); ChatGLM3-6B, each
    TP_FAMILIES run and (j) DeepSeek-V3 fp32 at ``--model-axis 1`` in
    process (the families on ``family_params``, the training phases' host
    draws cut to their layers; DeepSeek-V3 on phase 14's); then a world of
    2 (model axis 2: (j) DeepSeek-V3, the ViT in fp32 and in bf16 with its
    eval, (f) Zamba2-2.7B, (g) Granite-MoE GShard and gather, (h)
    RWKV6-7B, ChatGLM3) and a world of 4 (the ViT at data 2 x model 2
    under ZeRO 3, (k) the ViT at pipe 2 x model 2, (j) DeepSeek-V3 at
    model axis 4, ChatGLM3 at model axis 4, the D6 path, (k) ChatGLM3 at
    pipe 2 x model 2, flat and interleaved, and (f)-(h) at model axis 4;
    (l) the Ulysses jobs: the fp32 ViT at model 2 and 4, ChatGLM3 at 2),
    each rank running the CLI's ``run`` on the parent's draws, memory-
    mapped (a rank copies only its chunks to the card): every rank's
    K1-K7 and split-row launches exact (a pipeline stage's layers only),
    no layout copy, the heads ``flash_mha`` and ``wkv6`` see the expected
    ones, every loss and grad norm finite and ``step_ok`` 1, the fp32 runs
    within 3e-4 of one rank, the MoE routings that differ from one rank's
    printed, a Ulysses rank's peak beside the TP job's at its model axis, DeepSeek-V3's state on the card after init this rank's
    chunks alone (no rank holds the whole draw), a rank's peak printed,
    the bf16 eval counts equal on both ranks; (e) ``--devices 2
    --model-axis 2`` through the training and serve CLIs on one card
    refused. The rates read
    here are host-staged gloo's, not the model axis's: printed, not gated.
    (j)'s attention: K1-K3 at MLA's shape at 64 and 32 heads (a rank's at
    model axis 2 and 4) checked against their plain versions and timed.
    (m) serving across ranks: the kernels at a rank's shapes
    (``serve_rank_kernels``), ChatGLM3-6B's one-rank decode in the parent
    beside the one-rank references, then each world's ``serve_jobs``
    (``serve_gates``; (m4) DeepSeek-V3's latents split on the sequence at
    model 2 and 4, ``mla_split_gates``). (o) ``embed_sharding="dmodel"``
    at model 2 in the world of 2, after its serving jobs: Gemma3-12B's
    decode, and Gemma3-12B and Qwen2.5-14B training (``embed_jobs``,
    ``rank_embed_train``, ``embed_gates``) against the parent's one-rank
    runs (``embed_one_rank``). ``serving``: phase 15's
    {"prefill": K1's one-rank prefill row, "tokens": the serve CLI's}; the
    ranks draw Qwen2.5,
    Qwen2-VL and Gemma3 again on the card (``serve_params``, against
    SERVE_PRINTS). Returns ({label: rank 0's launches; a pipeline
    run's stage 1 under "<label> stage 1"}, the sliced-KV check's bf16
    errors, 19i's kernel rows, {"model_axis_2"/"_4": K1-K3's rows at MLA's
    per-rank shape}, {19m label: rank 0's launches}, 19m3's K1 rows, the
    recorded collectives, {19o training label: rank 0's launches})."""
    import concurrent.futures
    import gc
    import shutil
    import tempfile
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import distributed
    from repro_torch.core.engine import Server
    from repro_torch.launch.serve import main as serve_cli
    from repro_torch.launch.train import main as cli

    def free():
        gc.collect()
        torch.cuda.empty_cache()
    t0 = last = time.time()

    def lap(part):
        nonlocal last
        now = time.time()
        print(f"[tp] ({part}) in {now - last:.1f}s", flush=True)
        last = now
    free()
    errs = check_attention("tp-attn", "a model-axis-4 rank's",
                           TP_RANK_SHAPE, sliced_kv_inputs(19))
    split_rows = split_row_norms(card)
    # (j)'s attention: K1-K3 at MLA's shape at a model rank's H/M heads,
    # checked and timed (phase 14 times the whole 128 heads)
    mla_tp = {}
    inputs = model_layout_inputs(torch.Generator(device="cuda").manual_seed(
        30))
    for m in (2, 4):
        shape = (MLA_ATTN_SHAPE[0], MLA_ATTN_SHAPE[1] // m,
                 MLA_ATTN_SHAPE[2] // m) + MLA_ATTN_SHAPE[3:]
        e = check_attention("tp-mla", f"MLA at model axis {m}'s", shape,
                            inputs)
        t = attention_times(card, shape, True, inputs, "tp-mla")
        mla_tp[f"model_axis_{m}"] = {key: dict(t[key], shape=list(shape),
                                               max_abs_err=e[key])
                                     for key in t}
    serve_rows = serve_rank_kernels(card, serving["prefill"])
    lap("d, i, j, m: kernel checks")
    jobs = tp_jobs()
    by_label = {job.label: job for w in jobs.values() for job in w}
    # both worlds start now, beside the one-rank runs, and wait for the
    # draws' file (the marker "draws")
    (ROOT / "build").mkdir(exist_ok=True)
    markers = tempfile.mkdtemp(prefix="tp-markers-", dir=ROOT / "build")
    draw = ROOT / "build" / "tp-draw.bin"
    pool = concurrent.futures.ThreadPoolExecutor(len(jobs) + 1)
    t_worlds = time.time()
    runs = {size: pool.submit(
        distributed.spawn, tp_rank, size, world_jobs,
        [str(draw)], markers, dict(SERVE_PRINTS), device="cuda",
        backend="gloo", deadline_s=600)
        for size, world_jobs in jobs.items()}

    try:
        _, hist = run_cli(TP_LM_ARGS, by_label[
            "chatglm3-6b fp32 --model-axis 4 (D6)"].expect,
            "chatglm3-6b fp32 --model-axis 1")
        refs = {"vit": f32_ref,
                "lm": train_rows(hist, "chatglm3-6b fp32 --model-axis 1",
                                 TP_LM_STEPS)}
        # the ranks read the parent's host draws from a file rather than
        # each drawing them again: ChatGLM3's (1.35 B params, the run
        # above), the families' and DeepSeek-V3's (phase 14's, drawn on
        # the card), written by a thread beside the one-rank runs below
        ds_name = get_config(DEEPSEEK).name
        # Zamba2's is phase 17's whole draw: its training runs take its
        # first layers (``held_params``), its decode job all of them
        depth = {"zamba2": ZAMBA_LAYERS}
        draws = {(get_config(arch).name, depth.get(tag, layers)):
                 family_params[tag.split("-")[0]]
                 for tag, (arch, layers, _, _) in TP_FAMILIES.items()}
        draws[ds_name, DS_LAYERS] = family_params["deepseek"]
        for lm_params in getattr(share_draws, "held", {}).values():
            draws[get_config("chatglm3-6b").name, LM_LAYERS] = lm_params
        n = sum(p.numel() for d in draws.values() for p in d.values())
        whole_ds = sum(p.numel() * p.element_size()
                       for p in draws[ds_name, DS_LAYERS].values()) / 1e9
        t_save = time.time()
        writer = pool.submit(write_draws, draws, draw)
        ds = by_label["deepseek-v3 fp32 --model-axis 2"]
        one_rank_routes = {}
        one_rank = [(tag, family_argv(tag), family_expect(tag, 1)[0],
                     fields, TP_FAMILY_STEPS)
                    for tag, (_, _, _, fields) in TP_FAMILIES.items()] + \
            [("deepseek", TP_DS_ARGS, ds.expect, ds.fields, TP_DS_STEPS)]
        with held_draws(draws):
            for tag, argv, expect, fields, steps in one_rank:
                free()
                routes = []
                with cli_fields(fields), head_spies(routes):
                    _, hist = run_cli(argv, expect,
                                      f"{tag} fp32 --model-axis 1")
                refs[tag] = train_rows(hist, f"{tag} fp32 --model-axis 1",
                                       steps)
                one_rank_routes[tag] = routes
        free()
        # 19o: the one-rank runs of the "dmodel" training jobs, each on
        # the card's seed-0 draw, which the ranks draw again
        embed_refs = {}
        for tag in EMBED_TRAIN:
            embed_refs[tag] = embed_one_rank(tag)
            free()
        # 19m2: ChatGLM3-6B's one-rank decode on the same draw
        lm_cfg = serve_cfg(TP_SERVE_LM)
        reset_counters()
        SERVE_ONE_RANK["chatglm3"] = serve_decode(
            Server(lm_cfg, held_params(draws, lm_cfg), device="cuda"),
            TP_SERVE_LM)
        torch.cuda.synchronize()
        expect = dict({name: 0 for name in counters()},
                      **serve_expect(TP_SERVE_LM, 1)[0])
        if read_counters() != expect:
            fail(f"ChatGLM3-6B's one-rank decode: launches "
                 f"{read_counters()} (expected {expect})")
        free()
        lap("one-rank references")
        print(f"[tp] the parent's host draws ({n / 1e9:.2f} B params, "
              f"DeepSeek-V3's {whole_ds:.2f} GB of them) written for the "
              f"ranks in {writer.result():.1f}s, beside the one-rank runs "
              f"(done {time.time() - t_save:.1f}s after their start)",
              flush=True)
        (Path(markers) / "draws").touch()
        lap("the draws' file, after the one-rank references")
        # the host copies go: the ranks read the file's pages
        del draws
        family_params.clear()
        gc.collect()
        results = {size: run.result() for size, run in runs.items()}
    finally:
        # ranks still waiting for a marker stop (after the worlds' end, no
        # rank reads it)
        (Path(markers) / "abort").touch()
        pool.shutdown(wait=True)
        draw.unlink(missing_ok=True)
        Path(f"{draw}.json").unlink(missing_ok=True)
        shutil.rmtree(markers, ignore_errors=True)
    print(f"[tp] worlds of {sorted(jobs)} side by side on one card (gloo, "
          f"host-staged): {time.time() - t_worlds:.1f}s with the ranks' "
          f"start (beside the one-rank runs); the ranks waited "
          f"{max(r['draws_waited'] for w in results.values() for r in w):.1f}"
          f"s for the draws", flush=True)
    launches, peaks, serve_launches, collectives = {}, {}, {}, {}
    embed_launches = {}
    for size, world_jobs in jobs.items():
        ranks = results[size]
        for job in world_jobs:
            label, ref = job.label, job.ref
            if job.kind == "embed":
                embed_launches[label] = embed_gates(job, ranks,
                                                    embed_refs[ref])
                continue
            if job.kind != "train":
                serve_launches[label] = serve_gates(job, ranks,
                                                    serving["tokens"])
                continue
            evals = []
            for rank, got in enumerate(r[label] for r in ranks):
                expect = job.expect[rank] if isinstance(job.expect, list) \
                    else job.expect
                expect = dict({name: 0 for name in counters()}, **expect)
                rows = train_rows(got["hist"], f"{label} rank {rank}",
                                  len(refs[ref]) if ref else 3)
                evals.append([(e["eval_top1_count"], e["eval_top5_count"],
                               e["eval_count"]) for e in got["hist"]
                              if "eval_count" in e])
                (state_gb, with_opt_gb, init_peak_gb), = got["init_gb"]
                msg = (f"[tp] {label} rank {rank}/{size}: launches "
                       f"{got['launches']} (expected {expect}); layout "
                       f"copies {got['copies']}; (query, KV) heads "
                       f"{got['heads']} (expected {job.heads}), WKV6 heads "
                       f"{got['wkv_heads']} (expected {job.wkv}); losses "
                       f"{[round(r['loss'], 5) for r in rows]}; "
                       f"{got['s']:.1f}s (waited {got['waited']:.1f}s "
                       f"before it); params {state_gb:.2f} GB on the card "
                       f"after init, {with_opt_gb:.2f} GB with the optimizer "
                       f"moments (peak then {init_peak_gb:.2f} GB); peak "
                       f"{got['peak_gb']:.2f} GB")
                if ref:
                    d_loss = max_diff(rows, refs[ref], "loss")
                    d_norm = max_diff(rows, refs[ref], "grad_norm")
                    msg += (f"; max |dloss| {d_loss:.3e}, |dgnorm| "
                            f"{d_norm:.3e} against one rank (tol {TP_TOL})")
                print(msg, flush=True)
                if got["launches"] != expect or got["copies"] or \
                        got["heads"] != job.heads or \
                        got["wkv_heads"] != job.wkv:
                    fail(f"{label} rank {rank}: launches, copies or heads "
                         f"off")
                if ref and not (d_loss <= TP_TOL and d_norm <= TP_TOL):
                    fail(f"{label} rank {rank} disagrees with one rank")
                if ULYSSES in label and ref in GRANITE_ULYSSES:
                    granite_ulysses_gates(job, rank, size, rows, refs[ref],
                                          state_gb)
                # the card held no more than the rank's own params and
                # moments at any time of the init: never the whole draw
                if ref == "deepseek" and not (
                        init_peak_gb <= 1.02 * with_opt_gb + 0.05
                        and state_gb < 0.6 * whole_ds):
                    fail(f"{label} rank {rank}: {init_peak_gb:.2f} GB on "
                         f"the card after init for a {state_gb:.2f} GB "
                         f"share of the {whole_ds:.2f} GB draw "
                         f"({with_opt_gb:.2f} GB with the moments)")
                if ref in one_rank_routes and one_rank_routes[ref]:
                    routing_flips(f"{label} rank {rank}", got["routes"],
                                  one_rank_routes[ref])
                if label in COUNTED_JOBS:
                    card_b, rec_b = got["collectives"]
                    collectives[label, rank] = card_b
                    print(f"[tp] (b) {label} rank {rank}/{size}: one "
                          f"step's collective bytes by kind on the card "
                          f"{card_b}; a recording world's count of the same "
                          f"step on meta {rec_b} ("
                          f"{'equal' if card_b == rec_b else 'DIFFERENT'})",
                          flush=True)
                    if card_b != rec_b or not sum(card_b.values()):
                        fail(f"{label} rank {rank}: the recording world's "
                             f"collective bytes differ from the card's")
            if ref is None:
                if len(evals[0]) != 1 or evals[0][0][2] != 500 or \
                        any(e != evals[0] for e in evals):
                    fail(f"{label}: eval counts {evals} not one 500-example "
                         f"pass equal on every rank")
                w = [r["wall_s"] for r in ranks[0][label]["hist"]
                     if "loss" in r]
                print(f"[tp] {label}: eval counts (top1, top5, count) "
                      f"{evals[0][0]} on every rank; warm steps 2-3 "
                      f"{2 * 128 / (w[2] - w[0]):.1f} images/s "
                      f"(host-staged gloo collectives between two ranks "
                      f"on one card: not the model axis's rate, not "
                      f"gated; {smi_line()})", flush=True)
            launches[label] = ranks[0][label]["launches"]
            peaks[label] = max(r[label]["peak_gb"] for r in ranks)
            if isinstance(job.expect, list):
                # a pipeline run: the last stage's launches too
                launches[f"{label} stage 1"] = ranks[-1][label]["launches"]
    del results
    for uly, tp in TP_PEAK_PAIRS:
        print(f"[tp] a rank's peak under Ulysses, {uly}: "
              f"{peaks[uly]:.2f} GB (every leaf whole); under tensor "
              f"parallelism at the same model axis: "
              + (f"{peaks[tp]:.2f} GB ({tp})" if tp else "no such job")
              + f" (readings, not gated; {smi_line()})", flush=True)
    free()
    lap("the worlds' gates")
    if torch.cuda.device_count() < 2:
        try:
            cli(TRAIN_ARGS + ["--devices", "2", "--model-axis", "2"])
        except RuntimeError as e:
            print(f"[tp] --devices 2 --model-axis 2 through the CLI on "
                  f"{torch.cuda.device_count()} card: {e}", flush=True)
        else:
            fail("--devices 2 --model-axis 2 on one card did not raise")
        try:
            serve_cli(SERVE_ARGS + TP_SERVE_CLI[2])
        except RuntimeError as e:
            print(f"[tp-serve] the serve CLI at {' '.join(TP_SERVE_CLI[2])} "
                  f"on {torch.cuda.device_count()} card: {e}", flush=True)
        else:
            fail("the serve CLI's --devices 2 on one card did not raise")
    print(f"[tp] phase 19 in {time.time() - t0:.1f}s on {card}", flush=True)
    return launches, errs, split_rows, mla_tp, serve_launches, serve_rows, \
        collectives, embed_launches


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
             seq=LM_SEQ, **cfg_kw):
    """A full-width ``arch`` trainer cut to ``layers`` layers (and any
    other config field in ``cfg_kw`` replaced) with the CLI's engine
    settings for 10 steps, and its feed: the token pipeline of ``seq``
    tokens a sequence or, for the audio encoder, a stand-in whose
    ``batch_at(_, i)`` is the CLI's audio batch of step i
    (``concrete_batch``, ``seq`` frames, drawn with numpy)."""
    import types
    from repro_torch.configs import EngineConfig, get_config
    from repro_torch.core.engine import Trainer
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.launch.specs import concrete_batch

    cfg = get_config(arch).replace(
        num_layers=layers, dtype=dtype, use_kernels=use_kernels, **cfg_kw)
    ecfg = EngineConfig(train_batch_size=batch,
                        gradient_accumulation_steps=accum, total_steps=10,
                        warmup_steps=1)
    if cfg.arch_type == "audio":
        return Trainer(cfg, ecfg), types.SimpleNamespace(
            global_batch=batch, batch_at=lambda _, i: concrete_batch(
                cfg, batch, seq, seed=i))
    return Trainer(cfg, ecfg), DataPipeline(
        kind="token", global_batch=batch, vocab=cfg.vocab_size,
        seq_len=seq, epoch_size=batch * 10)


def phase_lm_train(profile):
    """The decoder slice: ``--arch chatglm3-6b --layers 4 --seq 1024
    --batch 8 --accum 2 --steps 10`` (per step and microbatch: K1-K3 once a
    layer, K4/K5 twice a layer and once for the final norm). Returns the
    CLI run's launches."""
    attn, norms = 10 * 2 * LM_LAYERS, 10 * 2 * (2 * LM_LAYERS + 1)
    return decoder_train("chatglm3-6b", LM_LAYERS, LM_TRAIN_ARGS, {
        "flash_fwd": attn, "flash_bwd_dq": attn, "flash_bwd_dkv": attn,
        "rmsnorm_fwd": norms, "rmsnorm_bwd": norms}, "lm", profile)[0]


def phase_rwkv_train(profile):
    """The RWKV6 slice: ``--arch rwkv6-7b --layers 4 --seq 1024 --batch 8
    --accum 2 --steps 10`` (per step and microbatch: K6 and K7 once a
    layer, K4/K5 twice a layer and once for the final norm, no attention),
    with the fp32 gradient gate taken at the group norm's eps raised to
    RWKV_GATE_EPS; then ``rwkv_after_steps``. Returns (the CLI run's
    launches, the params of seed 0 as phase 15 decodes them)."""
    wkv, norms = 10 * 2 * RWKV_LAYERS, 10 * 2 * (2 * RWKV_LAYERS + 1)
    launches, hist, params = decoder_train(
        "rwkv6-7b", RWKV_LAYERS, RWKV_TRAIN_ARGS, {
            "wkv6_fwd": wkv, "wkv6_bwd": wkv, "rmsnorm_fwd": norms,
            "rmsnorm_bwd": norms}, "rwkv", profile, fp32_eps=RWKV_GATE_EPS,
        timed=RWKV_TIMED)
    rwkv_after_steps(hist)
    return launches, decode_params("rwkv6", params)


def phase_gemma_train(profile):
    """The dense-decoder family's slice: ``--arch gemma3-12b --layers 6
    --seq 4096 --batch 2 --accum 2 --steps 10`` (per step and microbatch:
    K1-K3 once a layer at head dim 256, five layers with the window of
    1024 and one without; K4/K5 twice a layer and once for the final norm),
    kernel against naive gradients on one microbatch of 1 x
    GEMMA_AGREE_SEQ (past the window), warm tokens/s of both paths in
    micro-batches of 1 x GEMMA_AGREE_SEQ in turns (at 4096 tokens the naive
    path's fp32 scores, ~1.7 GB a layer, do not fit beside the AdamW state
    on 80 GB) and of the kernel path at 4096; then ``phase_remat`` from the
    same params. Returns (the CLI run's launches, the params of seed 0 as
    phase 15 decodes them)."""
    from repro_torch.configs import get_config

    t0 = time.time()
    attn = 10 * 2 * GEMMA_LAYERS
    norms = 10 * 2 * (2 * GEMMA_LAYERS + 1)
    cfg = get_config("gemma3-12b").replace(num_layers=GEMMA_LAYERS)
    print(f"[gemma3] layer windows {cfg.layer_windows()}; head dim "
          f"{cfg.head_dim}; vocabulary {cfg.vocab_size} (tied, embedding "
          f"scale {cfg.embed_scale}); act {cfg.act}", flush=True)
    launches, _, params = decoder_train(
        "gemma3-12b", GEMMA_LAYERS, GEMMA_TRAIN_ARGS, {
            "flash_fwd": attn, "flash_bwd_dq": attn, "flash_bwd_dkv": attn,
            "rmsnorm_fwd": norms, "rmsnorm_bwd": norms}, "gemma3", profile,
        seq=GEMMA_SEQ, batch=2, accum=2, agree=(1, GEMMA_AGREE_SEQ),
        rate_seq=GEMMA_AGREE_SEQ)
    phase_remat(params)
    print(f"[gemma3] phase done in {time.time() - t0:.1f}s", flush=True)
    return launches, decode_params("gemma3", params)


def phase_remat(params):
    """Activation checkpointing at the gemma3 slice's shape, in process:
    three bf16 optimizer steps (batch 2 x GEMMA_SEQ, accum 2) with
    ``remat="block"`` and with ``"dots"`` against ``"none"``, from the same
    params and batches; losses within REMAT_TOL of the "none" run's (and
    whether bitwise equal), each run's peak of allocated device memory and
    ms per step of its last two steps (a reading), and exact launch
    counts: each layer's recompute runs K1 and both of its
    K4s once more, K2, K3 and K5 as often as without."""
    import gc
    import torch
    from repro_torch.core.engine import to_device

    steps, mb, L = 3, 2, GEMMA_LAYERS
    kw = {"arch": "gemma3-12b", "layers": L, "batch": 2, "accum": 2,
          "seq": GEMMA_SEQ}
    runs = {}
    for remat in ("none", "block", "dots"):
        again = remat != "none"
        expect = dict({name: 0 for name in counters()},
                      flash_fwd=steps * mb * L * (2 if again else 1),
                      flash_bwd_dq=steps * mb * L,
                      flash_bwd_dkv=steps * mb * L,
                      rmsnorm_fwd=steps * mb * ((4 if again else 2) * L + 1),
                      rmsnorm_bwd=steps * mb * (2 * L + 1))
        trainer, pipe = lm_setup("bfloat16", True, remat=remat, **kw)
        state = trainer.init_state({k: v.to("cuda", copy=True)
                                    for k, v in params.items()})
        batches = [to_device(pipe.batch_at(0, i), "cuda")
                   for i in range(steps)]
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counters()
        losses, t0 = [], 0.0
        for i, batch in enumerate(batches):
            if i == 1:          # the first step is a warm-up
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            state, m = trainer.train_step(state, batch)
            if not m["step_ok"]:
                fail(f"remat={remat}: a step was skipped by the guard")
            losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / (steps - 1) * 1e3
        peak = torch.cuda.max_memory_allocated()
        launches = read_counters()
        runs[remat] = losses
        d = max(abs(a - b) for a, b in zip(losses, runs["none"]))
        ok = launches == expect and d <= REMAT_TOL
        print(f"[remat] gemma3-12b ({L} layers, batch 2 x {GEMMA_SEQ}, accum "
              f"2, bf16) remat={remat}: losses {losses}; max |dloss| against "
              f"remat=none {d:.3e} (tol {REMAT_TOL}), bitwise equal "
              f"{losses == runs['none']}; torch.cuda.max_memory_allocated "
              f"{peak / 1e9:.2f} GB; {step_ms:.2f} ms per step (steps 2-3, "
              f"a reading); launches {launches} (expected {expect}) "
              f"{'ok' if ok else 'FAIL'}; {smi_line()}", flush=True)
        if not ok:
            fail(f"remat={remat}: losses or launches disagree")
        del state, trainer, batches
    gc.collect()
    torch.cuda.empty_cache()


def phase_dense():
    """Qwen2.5-14B and GLM-4-9B at full width, two layers each, through the
    CLI (``--layers 2 --seq 1024 --batch 8 --accum 2 --steps 3``, bf16):
    exact launch counts (K1-K3 once a layer and microbatch, K4/K5 twice a
    layer and once for the final norm), every loss and grad-norm finite,
    ``step_ok`` 1, the peak of allocated device memory; K1-K3 at
    Qwen2.5's attention shape (a GQA group of 5) against their plain
    versions (``check_attention``; GLM-4's shape is ``LM_ATTN_SHAPE``,
    checked in phase 6); each model's kernel against naive gradients on
    one microbatch of 4 x LM_SEQ (``kernel_naive_agreement``). Returns
    {arch: launches}."""
    import gc
    import math
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa

    t0 = time.time()
    steps = 3
    attn = steps * 2 * DENSE_LAYERS
    norms = steps * 2 * (2 * DENSE_LAYERS + 1)
    out = {}
    for arch in ("qwen2.5-14b", "glm4-9b"):
        cfg = get_config(arch)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        launches, hist = run_cli(["--arch", arch] + DENSE_ARGS, {
            "flash_fwd": attn, "flash_bwd_dq": attn, "flash_bwd_dkv": attn,
            "rmsnorm_fwd": norms, "rmsnorm_bwd": norms}, f"{arch} train")
        peak = torch.cuda.max_memory_allocated()
        if [r["step"] for r in hist] != list(range(steps)) or not all(
                math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
                and r["step_ok"] == 1 for r in hist):
            fail(f"{arch} train: bad rows {hist}")
        print(f"[dense] {arch} ({DENSE_LAYERS} layers, full width: d "
              f"{cfg.d_model}, {cfg.num_heads}:{cfg.num_kv_heads} heads of "
              f"{cfg.head_dim}, vocabulary {cfg.vocab_size}, norm eps "
              f"{cfg.norm_eps:g}) losses {[round(r['loss'], 4) for r in hist]}"
              f"; grad norms {[round(r['grad_norm'], 3) for r in hist]}; "
              f"step_ok all 1; wall {hist[-1]['wall_s']} s (cold); "
              f"torch.cuda.max_memory_allocated {peak / 1e9:.2f} GB; "
              f"{smi_line()}", flush=True)
        out[arch] = launches
        gc.collect()
        torch.cuda.empty_cache()
        if arch == "qwen2.5-14b":
            b, h, kh, _, t, d = QWEN_ATTN_SHAPE
            lib = fa._lib_bwd()
            split = fa.dkv_group_split(
                b, kh, t, d, h // kh, torch.cuda.get_device_properties(0)
                .multi_processor_count, lib.repro_flash_key_tile(),
                col_tiles=lib.repro_flash_dkv_col_tiles(d, d), dv=d)
            print(f"[qwen-attn] K3 bf16 grid: group {h // kh} split over "
                  f"{split.gs} CTA(s)", flush=True)
            inputs = model_layout_inputs(
                torch.Generator(device="cuda").manual_seed(6))
            check_attention("qwen-attn", "Qwen2.5's", QWEN_ATTN_SHAPE,
                            inputs)
        kernel_naive_agreement(arch, DENSE_LAYERS, (4, LM_SEQ))
    print(f"[dense] phase done in {time.time() - t0:.1f}s", flush=True)
    return out


def phase_granite_attention(card):
    """K1, K2 and K3 at Granite-MoE's attention shape (causal, GQA 24:8, a
    group of 3, head dim 64, S = T = 1024): against their plain versions
    in bf16 and fp32, K2 and K3 each run twice for bitwise equal results,
    K3's bf16 grid printed, then timed beside SDPA (``enable_gqa``) and the
    bounds."""
    import torch
    from repro_torch.kernels import flash_attention as fa

    b, h, kh, _, t, d = GRANITE_ATTN_SHAPE
    lib = fa._lib_bwd()
    split = fa.dkv_group_split(
        b, kh, t, d, h // kh, torch.cuda.get_device_properties(0)
        .multi_processor_count, lib.repro_flash_key_tile(),
        col_tiles=lib.repro_flash_dkv_col_tiles(d, d), dv=d)
    print(f"[granite-attn] K3 bf16 grid: group {h // kh} split over "
          f"{split.gs} CTA(s)", flush=True)
    inputs = model_layout_inputs(torch.Generator(device="cuda").manual_seed(7))
    errs = check_attention("granite-attn", "Granite-MoE's", GRANITE_ATTN_SHAPE,
                           inputs)
    t = attention_times(card, GRANITE_ATTN_SHAPE, True, inputs,
                        "granite-attn")
    return {key: dict(t[key], max_abs_err=errs[key]) for key in t}


@contextlib.contextmanager
def routing_spy(forced=None):
    """Records, for every GShard routing call (one a MoE layer), the
    expert indices (B,S,k) in choice order and the kept slots (the
    dispatch tensor's nonzeros, (B,S,E,C) bool). With ``forced`` (another
    run's records) the i-th call takes the i-th record's expert indices in
    place of its own top-k, and its gates are its own probabilities at
    those experts."""
    import torch
    from repro_torch.models import moe

    calls, real, real_top_k = [], moe.top_k_routing, moe.top_k

    def spy(logits, k, capacity, reduce=None):
        if forced is not None:
            idx = forced[len(calls)][0]
            moe.top_k = lambda probs, k: (probs.gather(-1, idx), idx)
        try:
            out = real(logits, k, capacity, reduce)
        finally:
            moe.top_k = real_top_k
        with torch.no_grad():
            idx = moe.top_k(torch.softmax(logits.detach(), dim=-1), k)[1] \
                if forced is None else forced[len(calls)][0]
            calls.append((idx, out[0].detach() > 0))
        return out
    moe.top_k_routing = spy
    try:
        yield calls
    finally:
        moe.top_k_routing, moe.top_k = real, real_top_k


def routing_diff(a, b):
    """Per layer, the (token, choice) routings and the kept slots that
    differ between two ``routing_spy`` records."""
    return ([int((x[0] != y[0]).sum()) for x, y in zip(a, b)],
            [int((x[1] != y[1]).sum()) for x, y in zip(a, b)])


def moe_agreement(arch, layers, agree, fp32_eps=None, *, params=None,
                      tag="granite", **cfg_kw):
    """Kernel against naive path (plain RMSNorm, naive attention) of the
    MoE decoder on one microbatch of ``agree`` (rows, tokens), from params
    of seed 0 (or ``params``, on the host; any other config field in
    ``cfg_kw``), GShard dispatch. Each path routes on its own first, and the
    (token, choice) routings and kept slots that differ are printed by
    layer: a routing flip (two router probabilities closer than the paths'
    rounding) is a discontinuity of the function, not an error of either
    path. fp32: the naive path is then run again with every layer's expert
    indices forced to the kernel path's (its gates its own probabilities
    at those experts); its kept slots must then equal the kernel path's in
    every layer, and max |dgrad| be within 2e-4 (where nothing flipped, the
    first naive run is that comparison). bf16: cosine >= 0.99 on the paths'
    own routings. Returns the params, on the host."""
    import gc
    import torch
    from repro_torch.core.engine import to_device
    from repro_torch.models.transformer import init_params

    kw = {"arch": arch, "layers": layers, **cfg_kw}
    host = params
    if host is None:
        trainer, _ = lm_setup("bfloat16", True, **kw)
        params = init_params(trainer.cfg, seed=0, device="cuda")
        del trainer
    else:
        params = {k: v.to("cuda") for k, v in host.items()}
    one = {"batch": agree[0], "accum": 1, "seq": agree[1]}
    label = f"{arch}, one microbatch of {agree[0]} x {agree[1]},"
    for dtype in ("float32", "bfloat16"):
        trainer_k, pipe = lm_setup(dtype, True, **one, **kw)
        trainer_n, _ = lm_setup(dtype, False, **one, **kw)
        micro = to_device(pipe.batch_at(0, 0), "cuda")
        with routing_spy() as rk:
            gk, mk = trainer_k.grads(params, micro)
        with routing_spy() as rn:
            gn, mn = trainer_n.grads(params, micro)
        if len(rk) != layers or len(rn) != layers:
            fail(f"{label} {dtype}: {len(rk)} and {len(rn)} routing calls "
                 f"for {layers} MoE layers")
        flips, slots = routing_diff(rk, rn)
        n = rk[0][0].numel()
        print(f"[{tag}] {label} {dtype} routing, kernel vs naive path, "
              f"each on its own: (token, choice) routings that differ by "
              f"layer {flips} of {n} each (share "
              f"{sum(flips) / (n * layers):.3e}); kept-slot differences by "
              f"layer {slots}", flush=True)
        how = "each on its own routing"
        if dtype == "float32" and (any(flips) or any(slots)):
            del gn, rn
            with routing_spy(forced=rk) as rn:
                gn, mn = trainer_n.grads(params, micro)
            flips, slots = routing_diff(rk, rn)
            print(f"[{tag}] {label} float32 naive path with the kernel "
                  f"path's expert indices forced: kept-slot differences by "
                  f"layer {slots} {'ok' if not any(slots) else 'FAIL'}",
                  flush=True)
            if any(slots) or len(rn) != layers:
                fail(f"{label} float32: forced routing left {sum(slots)} "
                     f"kept slots different")
            how = "both on the kernel path's routing"
        d_max, cos, _, _ = compare_grads(gk, gn, f"{dtype} kernel path")
        report_agreement(f"{label} {how},", dtype,
                         (abs(float(mk["loss"]) - float(mn["loss"])), d_max,
                          cos))
        print(f"[{tag}] {label} {dtype} moe_aux kernel path "
              f"{float(mk['moe_aux']):.6e}, naive path "
              f"{float(mn['moe_aux']):.6e}", flush=True)
        del trainer_k, trainer_n, micro, gk, gn, rk, rn
        gc.collect()
        torch.cuda.empty_cache()
    params = host if host is not None else \
        {k: v.cpu() for k, v in params.items()}
    gc.collect()
    torch.cuda.empty_cache()
    return params


def impl_agreement(params):
    """Gather against GShard dispatch on the card: one fp32 microbatch of 4
    x LM_SEQ through the kernel path at capacity factor IMPL_CF, on the
    first IMPL_LAYERS layers of ``params``: logits within 2e-5, grads
    within 5e-5, ``moe_aux`` rtol 1e-5."""
    import dataclasses
    import gc
    import torch
    from repro_torch.core.engine import to_device
    from repro_torch.models import transformer

    params = {k: (v[:IMPL_LAYERS] if k.startswith("moe_stack.") else v)
              .to("cuda") for k, v in params.items()}
    out = {}
    from repro_torch.configs import get_config

    ample = dataclasses.replace(get_config(GRANITE).moe,
                                capacity_factor=IMPL_CF)
    for impl in ("gshard", "gather"):
        trainer, pipe = lm_setup("float32", True, arch=GRANITE,
                                 layers=IMPL_LAYERS, batch=4, accum=1,
                                 moe_impl=impl, moe=ample)
        cfg = trainer.cfg
        micro = to_device(pipe.batch_at(0, 0), "cuda")
        with torch.no_grad():
            logits, aux = transformer.forward(cfg, params, micro)
        grads, _ = trainer.grads(params, micro)
        out[impl] = (logits, float(aux["moe_aux"]), grads)
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    (la, aa, ga), (lb, ab, gb) = out["gshard"], out["gather"]
    d_logits = (la - lb).abs().max().item()
    d_grad, cos, _, _ = compare_grads(gb, ga, "gather path")
    rel_aux = abs(ab - aa) / aa
    ok = d_logits <= IMPL_LOGITS_TOL and d_grad <= IMPL_GRAD_TOL and \
        rel_aux <= 1e-5 and bool(torch.isfinite(lb).all())
    print(f"[granite] gather vs GShard dispatch ({IMPL_LAYERS} layers, fp32, "
          f"one microbatch of 4 x {LM_SEQ}, capacity factor {IMPL_CF}): "
          f"max|dlogits|={d_logits:.3e} (tol {IMPL_LOGITS_TOL}), "
          f"max|dgrad|={d_grad:.3e} (tol {IMPL_GRAD_TOL}), gradient cosine "
          f"{cos:.6f}, moe_aux {aa:.6e} / {ab:.6e} (rel {rel_aux:.2e}, tol "
          f"1e-5) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("the gather and GShard dispatch disagree on the card")
    del out, params
    gc.collect()
    torch.cuda.empty_cache()


def moe_split(card):
    """One MoE layer at the slice's microbatch (4 x LM_SEQ, bf16, d 1536,
    40 experts of 512, top-8; GShard capacity 256 a row, the gather
    table's 1024 slots over 4096 tokens), each part's forward and backward
    timed alone with CUDA events: the routing (fp32 router product,
    softmax, top-k, positions, the dispatch and combine tensors, aux), the
    GShard dispatch einsum, the experts' batched products, the combine
    einsum, the gather path's slot table (forward only), dispatch and
    combine, and the whole layer through ``moe_ffn`` and through
    ``moe_ffn_gather``; the FLOPs of their products beside them. A reading
    of where an MoE layer's time goes."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = get_config(GRANITE)
    m, d = cfg.moe, cfg.d_model
    b, s, e, k, f = 4, LM_SEQ, m.num_experts, m.top_k, m.d_ff_expert
    c, cg = moe.capacity(s, cfg), moe.capacity(b * s, cfg)
    gen = torch.Generator(device="cuda").manual_seed(8)

    def rnd(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, device="cuda", generator=gen) * scale).to(
            dtype).requires_grad_()
    x = rnd(b, s, d)
    p = {"router": rnd(d, e, dtype=torch.float32, scale=0.02),
         "experts.w_gate": rnd(e, d, f, scale=d ** -0.5),
         "experts.w_up": rnd(e, d, f, scale=d ** -0.5),
         "experts.w_out": rnd(e, f, d, scale=f ** -0.5)}
    weights = tuple(p.values())
    with torch.no_grad():
        disp, comb, _ = moe.top_k_routing(x.float() @ p["router"], k, c)
    disp = disp.to(torch.bfloat16)
    comb = comb.to(torch.bfloat16).requires_grad_()
    ein, eout = rnd(e, b, c, d), rnd(e, b, c, d)
    flat = x.detach().reshape(b * s, d).requires_grad_()
    with torch.no_grad():
        gates, idx = moe.top_k(torch.softmax(flat.float() @ p["router"], -1),
                               k)
        slot, valid, pos, keep = moe.gather_slots(idx, e, cg)
    ek = idx.reshape(-1)
    gates = gates.reshape(-1).to(torch.bfloat16) * keep.to(torch.bfloat16)
    eout_g = rnd(e, cg, d)
    router_flops = 6 * b * s * d * e
    expert_flops = 18 * e * d * f
    parts = {
        "routing": (lambda: moe.top_k_routing(x.float() @ p["router"], k,
                                              c)[1], (x, p["router"]),
                    router_flops),
        "GShard dispatch einsum": (lambda: torch.einsum(
            "bsec,bsd->ebcd", disp, x), (x,), 4 * b * s * e * c * d),
        "expert products": (lambda: moe.expert_ffn(p, ein),
                            (ein,) + weights[1:], expert_flops * b * c),
        "GShard combine einsum": (lambda: torch.einsum(
            "bsec,ebcd->bsd", comb, eout), (comb, eout),
            6 * b * s * e * c * d),
        "gather slot table (gather_slots, forward only)": (
            lambda: moe.gather_slots(idx, e, cg), None, 0),
        "gather dispatch (x[slot] * valid)": (
            lambda: flat[slot] * valid[..., None].to(flat.dtype), (flat,), 0),
        "gather combine (gathered slots times gates, summed over k)": (
            lambda: (eout_g[ek, pos] * gates[:, None]).reshape(
                b * s, k, d).sum(1), (eout_g,), 0),
        "whole layer, GShard (moe_ffn)": (
            lambda: moe.moe_ffn(p, x, cfg)[0], (x,) + weights,
            router_flops + expert_flops * b * c + 10 * b * s * e * c * d),
        "whole layer, gather (moe_ffn_gather)": (
            lambda: moe.moe_ffn_gather(p, x, cfg.replace(
                moe_impl="gather"))[0], (x,) + weights,
            router_flops + expert_flops * cg),
    }
    rows = {}
    for name, (fn, leaves, flops) in parts.items():
        if leaves is None:
            run = fn
        else:
            grad_out = torch.ones_like(fn())

            def run():
                torch.autograd.grad(fn(), leaves, grad_outputs=grad_out)
        ms = time_ms(run, warmup=3, reps=10)
        rows[name] = ms
        print(f"[granite-split] one MoE layer, {name}"
              f"{'' if leaves is None else ', forward and backward'} "
              f"(4 x {LM_SEQ} tokens, bf16; GShard capacity {c} a row, "
              f"gather {cg}): {ms:.4f} ms, "
              + (f"{flops / 1e9:.1f} GFLOP of products "
                 f"({flops / ms / 1e9:.1f} TFLOP/s)" if flops
                 else "no products") + f"; {card}", flush=True)
    return rows


def phase_granite(profile, card):
    """The MoE decoder's slice: ``--arch granite-moe-3b-a800m --layers 8
    --seq 1024 --batch 8 --accum 2 --steps 10`` in bf16 with the default
    GShard dispatch (per step and microbatch: K1-K3 once a layer at D 64
    and a GQA group of 3, K4/K5 twice a layer and once for the final norm),
    every loss, grad norm and ``moe_aux`` finite, ``moe_aux`` > 0 and
    ``step_ok`` 1, the peak of allocated device memory; kernel against
    naive path on one microbatch of 4 x LM_SEQ (``moe_agreement``);
    warm tokens/s of both paths in turns, every kernel-path run faster;
    then gather against GShard (``impl_agreement``), warm tokens/s of the
    GShard and gather paths in turns (recorded, not gated) and one MoE
    layer's parts timed (``moe_split``). Returns (the CLI run's launches,
    the params of seed 0 as phase 15 decodes them)."""
    import gc
    import math
    import torch

    t0 = time.time()
    attn = 10 * 2 * GRANITE_LAYERS
    norms = 10 * 2 * (2 * GRANITE_LAYERS + 1)
    launches, hist, params = decoder_train(
        GRANITE, GRANITE_LAYERS, GRANITE_ARGS, {
            "flash_fwd": attn, "flash_bwd_dq": attn, "flash_bwd_dkv": attn,
            "rmsnorm_fwd": norms, "rmsnorm_bwd": norms}, "granite", profile,
        agreement=moe_agreement)
    aux = [r["moe_aux"] for r in hist]
    if not all(math.isfinite(a) and a > 0 for a in aux):
        fail(f"{GRANITE} train: moe_aux {aux}")
    print(f"[granite] the CLI run's moe_aux by step {aux} (finite, > 0)",
          flush=True)
    impl_agreement(params)
    rates = {}
    for impl in ("gshard", "gather", "gather", "gshard"):
        trainer, pipe = lm_setup("bfloat16", True, arch=GRANITE,
                                 layers=GRANITE_LAYERS, moe_impl=impl)
        rates.setdefault(impl, []).append(train_rate(trainer, pipe, params))
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    for impl, rs in rates.items():
        tps = sum(r[0] for r in rs) / len(rs) * LM_SEQ
        ms = sum(r[1] for r in rs) / len(rs)
        print(f"[granite] {GRANITE} bf16 warm training, kernel path, {impl} "
              f"dispatch (a reading, not gated): {tps:.1f} tokens/s, "
              f"{ms:.2f} ms per optimizer step (batch 8 x {LM_SEQ}, accum 2; "
              f"runs {[round(r[0] * LM_SEQ, 1) for r in rs]} tokens/s; "
              f"{smi_line()})", flush=True)
    moe_split(card)
    held = decode_params("granite", params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[granite] phase done in {time.time() - t0:.1f}s", flush=True)
    return launches, held


def phase_mla_attention(card):
    """K1, K2 and K3 at DeepSeek-V3's MLA shape (B 2, H = KH = 128, S = T =
    1024, D 192, Dv 128, causal) against their plain versions in bf16 and
    fp32 in the model's layout, K2 and K3 each run twice for bitwise equal
    results; then MLA_CASES (ragged, non-causal, windowed, GQA); then
    torch.autograd.grad through ``flash_mha`` at the MLA shape against the
    plain backward; then timed beside SDPA (its backends that take Dv != D
    named) and the bounds."""
    import torch

    inputs = model_layout_inputs(torch.Generator(device="cuda").manual_seed(9))
    errs = check_attention("mla-attn", "DeepSeek-V3's MLA", MLA_ATTN_SHAPE,
                           inputs)
    for label, shape, causal, window, layout in MLA_CASES:
        check_attention("mla-attn", f"the MLA {label}", shape, inputs,
                        windows=(window,), causal=causal, layout=layout)
    check_autograd("mla-attn", MLA_ATTN_SHAPE, inputs, causal=True)
    t = attention_times(card, MLA_ATTN_SHAPE, True, inputs, "mla-attn")
    return {key: dict(t[key], max_abs_err=errs[key]) for key in t}


def deepseek_kw():
    """lm_setup's arguments for the cut DeepSeek-V3: one layer, which is
    MoE (no leading dense layer), and DS_EXPERTS routed experts."""
    from repro_torch.configs import get_config
    moe = dataclasses.replace(get_config(DEEPSEEK).moe, first_dense_layers=0,
                              num_experts=DS_EXPERTS)
    return {"arch": DEEPSEEK, "layers": DS_LAYERS, "moe": moe}


def mtp_reading(trainer, params, batch):
    """The first batch's next-token and MTP cross-entropies at the initial
    params (no grad): the loss without and with the MTP logits, ``moe_aux``
    left out, the second less the first over 0.3."""
    import torch
    from repro_torch.models import transformer

    cfg = trainer.cfg
    with torch.no_grad():
        logits, aux = transformer.forward(cfg, params, batch)
        main = float(transformer.loss_from_logits(cfg, logits, batch)[0])
        both = float(transformer.loss_from_logits(
            cfg, logits, batch, {"moe_aux": torch.zeros_like(aux["moe_aux"]),
                                 "mtp_logits": aux["mtp_logits"]})[0])
    return main, (both - main) / 0.3


def phase_deepseek(profile, card):
    """DeepSeek-V3 at full width, cut to one MoE layer of DS_EXPERTS routed
    experts (``deepseek_kw``), through the port's ``Trainer`` in process (the
    CLI has no expert-count flag, as the reference has none): DS_STEPS steps
    in bf16 at batch DS_BATCH x LM_SEQ, accum 1, GShard dispatch, with the
    launch counters reset just before and read just after (per step: K1-K3
    twice, in the MoE layer and the MTP block; K4/K5 12 times: ln1,
    q_norm, kv_norm and ln2 of the layer, the final norm, and the MTP
    head's norm_h, norm_e, its block's four and its final norm), no layout
    copy, every loss, grad norm and ``moe_aux`` finite, ``moe_aux`` > 0,
    ``step_ok`` 1, the MTP term printed, the peak of allocated device
    memory beside the prediction; then kernel against naive path on one
    microbatch of 1 x LM_SEQ from the initial params (``moe_agreement``:
    fp32 within 2e-4 on the kernel path's routing, bf16 cosine >= 0.99);
    then warm tokens/s of both paths in turns (a reading, not gated: at
    this shape attention is a small part of the step). Returns (the run's
    launches, the initial params as phase 15 decodes them, the initial
    params on the host, which phase 19 trains on the model axis)."""
    import gc
    import math
    import torch
    from repro_torch.core.engine import to_device
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rms
    from repro_torch.models.transformer import init_params

    def free():
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.time()
    free()
    torch.cuda.reset_peak_memory_stats()
    kw = deepseek_kw()
    shape = {"batch": DS_BATCH, "accum": 1, "seq": LM_SEQ}
    trainer, pipe = lm_setup("bfloat16", True, **shape, **kw)
    t_init = time.time()
    params = init_params(trainer.cfg, seed=0, device="cuda", draw_on="cuda")
    n_params = sum(p.numel() for p in params.values())
    host = {k: v.cpu() for k, v in params.items()}
    print(f"[deepseek] {DEEPSEEK} cut to {DS_LAYERS} MoE layer of "
          f"{DS_EXPERTS} routed experts at full width: {n_params:,} params "
          f"({n_params / 1e9:.3f} B), drawn on the card and copied to the "
          f"host in {time.time() - t_init:.1f}s", flush=True)
    batches = [to_device(pipe.batch_at(0, i), "cuda")
               for i in range(DS_STEPS)]
    main, mtp = mtp_reading(trainer, params, batches[0])
    state = trainer.init_state(params)
    del params
    expect = dict({name: 0 for name in counters()}, flash_fwd=2 * DS_STEPS,
                  flash_bwd_dq=2 * DS_STEPS, flash_bwd_dkv=2 * DS_STEPS,
                  rmsnorm_fwd=12 * DS_STEPS, rmsnorm_bwd=12 * DS_STEPS)
    reset_counters()
    t_train = time.time()
    rows = []
    for batch in batches:
        state, m = trainer.train_step(state, batch)
        rows.append({"loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"]),
                     "moe_aux": float(m["moe_aux"]),
                     "step_ok": m["step_ok"]})
    torch.cuda.synchronize()
    t_train = time.time() - t_train
    launches = read_counters()
    copies = {"dO": fa.kernel_layout.copies, "rows": rms.row_layout.copies}
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"[deepseek] train: launches {launches} (expected {expect}); "
          f"layout copies {copies}", flush=True)
    if launches != expect or any(copies.values()):
        fail(f"{DEEPSEEK} train: launches {launches}, layout copies "
             f"{copies}; expected {expect} and no copy")
    for r in rows:
        if not (math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
                and math.isfinite(r["moe_aux"]) and r["moe_aux"] > 0
                and r["step_ok"] == 1):
            fail(f"{DEEPSEEK} train: bad step row {r}")
    print(f"[deepseek] {DEEPSEEK} ({DS_LAYERS} layer, {DS_EXPERTS} experts, "
          f"full width) bf16, batch {DS_BATCH} x {LM_SEQ}, accum 1, GShard: "
          f"losses {[round(r['loss'], 4) for r in rows]}; grad norms "
          f"{[round(r['grad_norm'], 3) for r in rows]}; moe_aux "
          f"{[round(r['moe_aux'], 6) for r in rows]}; step_ok all 1; "
          f"{DS_STEPS} steps in {t_train:.1f}s (cold: the first steps "
          f"included)", flush=True)
    print(f"[deepseek] the MTP term, first batch at the initial params: "
          f"next-token xent {main:.6f}, MTP xent {mtp:.6f}; main + 0.3 MTP "
          f"= {main + 0.3 * mtp:.6f} against step 0's loss - moe_aux "
          f"{rows[0]['loss'] - rows[0]['moe_aux']:.6f}", flush=True)
    print(f"[deepseek] torch.cuda.max_memory_allocated {peak:.2f} GB "
          f"(predicted {DS_PEAK_GB[0]:g}-{DS_PEAK_GB[1]:g} GB; {card})",
          flush=True)
    del state, batches
    free()

    moe_agreement(DEEPSEEK, DS_LAYERS, (1, LM_SEQ), params=host,
                      tag="deepseek", moe=kw["moe"])
    rates = {}
    for label in ("kernel", "naive", "naive", "kernel"):
        trainer, pipe = lm_setup("bfloat16", label == "kernel", **shape,
                                 **kw)
        rates.setdefault(label, []).append(train_rate(trainer, pipe, host))
        del trainer
        free()
    for label, rs in rates.items():
        tps = sum(r[0] for r in rs) / len(rs) * LM_SEQ
        ms = sum(r[1] for r in rs) / len(rs)
        print(f"[deepseek] {DEEPSEEK} bf16 warm training, {label} path (a "
              f"reading, not gated): {tps:.1f} tokens/s, {ms:.2f} ms per "
              f"optimizer step (batch {DS_BATCH} x {LM_SEQ}, accum 1; runs "
              f"{[round(r[0] * LM_SEQ, 1) for r in rs]} tokens/s; "
              f"{smi_line()})", flush=True)
    if profile:
        trainer, pipe = lm_setup("bfloat16", True, **shape, **kw)
        profile_step(f"{DEEPSEEK} ({DS_LAYERS} layer, {DS_EXPERTS} experts, "
                     f"bf16, batch {DS_BATCH} x {LM_SEQ})", trainer, pipe,
                     host)
        del trainer
    held = decode_params("deepseek", host)
    free()
    print(f"[deepseek] phase done in {time.time() - t0:.1f}s", flush=True)
    return launches, held, host


def require_kernel_wins(tag, rates):
    """Fail unless every timed kernel-path run of ``rates`` ({"kernel":
    [...], "naive": [...]}, each run (rate, ms)) was faster than every
    naive-path run."""
    if min(r[0] for r in rates["kernel"]) <= \
            max(r[0] for r in rates["naive"]):
        fail(f"{tag}: a timed kernel-path run was not faster than every "
             f"naive-path run")


def check_rows(tag, hist, steps):
    """Fail unless the CLI's rows are steps 0..steps-1, each with a finite
    loss and grad norm and ``step_ok`` 1."""
    import math
    if [r["step"] for r in hist] != list(range(steps)) or not all(
            math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
            and r["step_ok"] == 1 for r in hist):
        fail(f"{tag} train: bad rows {hist}")


def decoder_train(arch, layers, argv, expect, tag, profile, fp32_eps=None,
                  *, seq=LM_SEQ, batch=8, accum=2, agree=(4, LM_SEQ),
                  rate_seq=None, agreement=None, steps=10, timed=(4, 2),
                  paths=("kernel", "naive", "naive", "kernel"),
                  unit="tokens"):
    """A model's training slice at full width cut to ``layers`` layers:
    ``argv`` (bf16, ``batch`` x ``seq``, ``accum``, ``steps`` steps)
    through the CLI with the launch counters reset just before and read
    just after (``expect``), every loss and grad-norm finite and
    ``step_ok`` 1, the peak of allocated device memory; then
    ``kernel_naive_agreement`` on one microbatch of ``agree`` (rows,
    tokens) (or ``agreement``, a function with its signature and result),
    and warm training ``unit``/s (``timed``: timed and warm-up steps a
    run) of the ``paths`` in turns (every kernel-path run faster than
    every naive-path run, or the phase fails; at ``rate_seq`` tokens a
    sequence when given, and then the kernel path's at ``seq`` as well),
    all from params of seed 0. The previous phase's tensors are freed
    first, so two models never stand together. Returns (launches, the
    CLI's metrics rows, the params on the host)."""
    import gc
    import torch

    def free():
        gc.collect()
        torch.cuda.empty_cache()
    free()
    torch.cuda.reset_peak_memory_stats()
    launches, hist = run_cli(argv, expect, f"{arch} train")
    peak = torch.cuda.max_memory_allocated()
    check_rows(arch, hist, steps)
    print(f"[{tag}] {arch} ({layers} layers, full width) losses "
          f"{[round(r['loss'], 4) for r in hist]}; grad norms "
          f"{[round(r['grad_norm'], 3) for r in hist]}; step_ok all 1; "
          f"wall {hist[-1]['wall_s']} s (cold, init and first steps "
          f"included); torch.cuda.max_memory_allocated "
          f"{peak / 1e9:.2f} GB", flush=True)
    free()

    kw = {"arch": arch, "layers": layers}
    # the timed runs copy their params to the card from the host, so the
    # card holds one model's state at a time
    params = (agreement or kernel_naive_agreement)(arch, layers, agree,
                                                   fp32_eps)
    rates = {}
    rate_seq = rate_seq or seq
    shape = {"batch": batch, "accum": accum, "seq": rate_seq}
    for label in paths:
        trainer, pipe = lm_setup("bfloat16", label == "kernel", **shape,
                                 **kw)
        rates.setdefault(label, []).append(
            train_rate(trainer, pipe, params, *timed))
        free()
    if rate_seq != seq:
        trainer, pipe = lm_setup("bfloat16", True, batch=batch, accum=accum,
                                 seq=seq, **kw)
        rates[f"kernel path at {seq} {unit}"] = [
            train_rate(trainer, pipe, params, *timed)]
        free()
    for label, rs in rates.items():
        n = seq if label.startswith("kernel path") else rate_seq
        tps = sum(r[0] for r in rs) / len(rs) * n
        ms = sum(r[1] for r in rs) / len(rs)
        what = label if label.startswith("kernel path") else f"{label} path"
        print(f"[{tag}] {arch} bf16 warm training, {what}: "
              f"{tps:.1f} {unit}/s, {ms:.2f} ms per optimizer step (batch "
              f"{batch} x {n}, accum {accum}; runs "
              f"{[round(r[0] * n, 1) for r in rs]} {unit}/s; "
              f"{smi_line()})", flush=True)
    if "naive" in rates:
        require_kernel_wins(arch, rates)
    if profile:
        trainer, pipe = lm_setup("bfloat16", True, **shape, **kw)
        profile_step(f"{arch} ({layers} layers, bf16, batch {batch} x {seq}, "
                     f"accum {accum})", trainer, pipe, params)
    return launches, hist, params


def kernel_naive_agreement(arch, layers, agree, fp32_eps=None):
    """Kernel against naive path (plain RMSNorm and the naive attention
    or the chunked WKV6) of ``arch`` at full width cut to ``layers``
    layers, from params of seed 0, on one microbatch of ``agree`` (rows,
    tokens): fp32 max |dgrad| within 2e-4 (with ``fp32_eps`` the fp32
    agreement at the model's own norm eps is printed ungated and the gate
    holds a copy of the config with ``norm_eps=fp32_eps``), bf16 cosine >=
    0.99. Returns the params, on the host."""
    import gc
    import torch
    from repro_torch.core.engine import to_device
    from repro_torch.models.transformer import init_params

    kw = {"arch": arch, "layers": layers}
    trainer, pipe = lm_setup("bfloat16", True, **kw)
    params = init_params(trainer.cfg, seed=0, device="cuda")
    one = {"batch": agree[0], "accum": 1, "seq": agree[1]}
    for dtype in ("float32", "bfloat16"):
        trainer_k, pipe = lm_setup(dtype, True, **one, **kw)
        trainer_n, _ = lm_setup(dtype, False, **one, **kw)
        micro = to_device(pipe.batch_at(0, 0), "cuda")
        result = grad_agreement(trainer_k, trainer_n, params, micro, dtype)
        label = f"{arch}, one microbatch of {agree[0]} x {agree[1]},"
        if fp32_eps is not None and dtype == "float32":
            d_loss, d_grad, cos = result
            print(f"[train] {label} float32 kernel vs naive at the model's "
                  f"norm eps {trainer_k.cfg.norm_eps:g} (a reading, not "
                  f"gated: the group norm amplifies fp32 rounding on "
                  f"head-rows whose variance is near eps): |dloss|="
                  f"{d_loss:.3e}, max|dgrad|={d_grad:.3e}, gradient cosine "
                  f"{cos:.6f}", flush=True)
            trainer_k, _ = lm_setup(dtype, True, norm_eps=fp32_eps, **one,
                                    **kw)
            trainer_n, _ = lm_setup(dtype, False, norm_eps=fp32_eps, **one,
                                    **kw)
            result = grad_agreement(trainer_k, trainer_n, params, micro,
                                    dtype)
            label += f" norm eps {fp32_eps:g},"
        report_agreement(label, dtype, result)
        del trainer_k, trainer_n, micro
        gc.collect()
        torch.cuda.empty_cache()
    params = {k: v.cpu() for k, v in params.items()}
    gc.collect()
    torch.cuda.empty_cache()
    return params


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


def check_prefill_k1(tag, label, shape, window, inputs):
    """K1 at a prefill shape (causal, S < T, the keys past the prompt
    zeros as in a fresh cache) against ``ref_attention`` in bf16 and fp32
    (phase 3's gates); fails on a disagreement. Returns the bf16 max
    |error| of the output."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import ref_attention

    s, err = shape[3], None
    for dname in ("bfloat16", "float32"):
        dtype, tol = getattr(torch, dname), TOL_OUT[dname]
        q, k, v, _ = shape_inputs(inputs, shape, dtype, True)
        k[:, :, s:] = 0         # a cache's unwritten rows
        v[:, :, s:] = 0
        out, lse = fa.flash_attention_fwd(q, k, v, causal=True,
                                          window=window)
        torch.cuda.synchronize()
        want, want_lse = ref_attention(q, k, v, causal=True, window=window)
        res = {"out": close(out, want, tol),
               "lse": close(lse, want_lse, TOL_LSE)}
        ok = all(r[1] for r in res.values())
        print(f"[{tag}] K1 {label} {shape} {dname} causal window={window}: "
              + " ".join(f"max|d{key}|={r[0]:.3e}" for key, r in res.items())
              + f" (tol {tol}, rtol {tol}; lse {TOL_LSE}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"K1 disagrees with its plain version at the {label} "
                 f"prefill shape in {dname}")
        err = res["out"][0] if err is None else err
        del q, k, v, out, lse, want, want_lse
    return err


def time_prefill_k1(card, tag, label, shape, inputs):
    """K1 timed at a prefill shape in bf16 (causal, S < T) beside its
    plain version, SDPA (upper-left causal, as K1) and the bound over the
    live pairs. Returns the timing row."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import ref_attention

    q, k, v, _ = shape_inputs(inputs, shape, torch.bfloat16, True)
    k[:, :, shape[3]:] = 0
    v[:, :, shape[3]:] = 0
    ms = time_ms(lambda: fa.flash_attention_fwd(q, k, v, causal=True))
    plain = time_ms(lambda: ref_attention(q, k, v, causal=True), reps=10)
    qc, kc, vc = (x.contiguous() for x in (q, k, v))
    kw = {"is_causal": True, "enable_gqa": True}
    with torch.no_grad():
        library = time_ms(lambda: F.scaled_dot_product_attention(
            qc, kc, vc, **kw), calls=10)
        d_sdpa = (F.scaled_dot_product_attention(qc, kc, vc, **kw).float()
                  - fa.flash_attention_fwd(q, k, v)[0].float()).abs().max()
    bound_ms, bound_by, how = bound(card, *attn_work(shape, 2, True)["fwd"])
    print(f"[{tag}] K1 flash_fwd timing at {label}'s prefill {shape} bf16 "
          f"causal (S < T) on {card}: kernel {ms:.4f} ms, plain {plain:.4f} "
          f"ms, SDPA forward (yardstick; max |SDPA - K1| "
          f"{d_sdpa.item():.3e}) {library:.4f} ms; bound {bound_ms:.4f} ms "
          f"by {bound_by} over {live_pairs(shape[3], shape[4], True, 0):,} "
          f"live pairs and {live_keys(shape[3], shape[4], True, 0)} of "
          f"{shape[4]} keys a head ({how})", flush=True)
    return {"shape": list(shape), "ms": ms, "plain_ms": plain,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library}


def phase_prefill_kernels(card):
    """K1 at the prefill shapes (PREFILL_CASES) against ``ref_attention``
    (``check_prefill_k1``), K4 at a decode step's rows (DECODE_ROWS)
    against ``ref_rmsnorm_fwd``, then K1 timed at the first shape
    (``time_prefill_k1``). Returns the timing row."""
    import torch
    from repro_torch.kernels import rmsnorm as rms
    from repro_torch.kernels.ref import ref_rmsnorm_fwd

    inputs = model_layout_inputs(
        torch.Generator(device="cuda").manual_seed(11))
    errs = {label: check_prefill_k1("prefill", label, shape, window, inputs)
            for label, shape, window in PREFILL_CASES}
    gen = torch.Generator(device="cuda").manual_seed(12)
    for label, shape in DECODE_ROWS:
        for dname in ("bfloat16", "float32"):
            dtype, tol = getattr(torch, dname), RMS_TOL[dname]
            x = torch.randn(shape, device="cuda", generator=gen).to(dtype)
            scale = torch.randn(shape[-1], device="cuda", generator=gen)
            out, rinv = rms.fused_rmsnorm_fwd(x, scale, LM_EPS)
            torch.cuda.synchronize()
            want, want_rinv = ref_rmsnorm_fwd(x, scale, LM_EPS)
            err, ok = close(out, want, tol)
            d_rinv = ((rinv - want_rinv).abs() / want_rinv).max().item()
            ok = ok and d_rinv <= TOL_RINV and out.dtype == dtype
            print(f"[prefill] K4 at a decode step's rows, {label} {shape} "
                  f"{dname}: max|dout|={err:.3e} (tol {tol}, rtol {tol}) "
                  f"rel|drinv|={d_rinv:.3e} (tol {TOL_RINV}) "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                fail(f"K4 disagrees with its plain version at {label}'s "
                     f"decode rows in {dname}")
    label, shape, _ = PREFILL_CASES[0]
    return dict(time_prefill_k1(card, "prefill", label, shape, inputs),
                max_abs_err=errs[label])


def phase_serve_cli(argv=SERVE_ARGS, attn=SERVE_LAYERS,
                    norms=(2 * SERVE_LAYERS + 1) * SERVE_GEN):
    """``python -m repro_torch.launch.serve`` with ``argv`` (SERVE_ARGS:
    fp32, as the reference's serve) in this process, the counters reset
    just before and read just after: K1 ``attn`` times in the prefill
    (once an attention layer; the decode steps take the naive sdpa), K4
    ``norms`` times (SERVE_ARGS: twice a layer and once for the final norm
    in the prefill and in each of the 63 decode steps), no other kernel
    and no layout copy; its two ``[serve]`` lines. Returns (launches, its
    result)."""
    import gc
    import io
    import torch
    from repro_torch.kernels import rmsnorm as rms
    from repro_torch.launch import serve

    expect = dict({name: 0 for name in counters()}, flash_fwd=attn,
                  rmsnorm_fwd=norms)
    reset_counters()
    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        res = serve.main(argv)
    wall = time.time() - t0
    text = buf.getvalue()
    print(text, end="", flush=True)
    launches = read_counters()
    lines = [ln for ln in text.splitlines() if ln.startswith("[serve]")]
    print(f"[serve] the CLI ({' '.join(argv)}): launches {launches} "
          f"(expected {expect}); row layout copies {rms.row_layout.copies}; "
          f"{wall:.1f}s with the draw of the params", flush=True)
    if launches != expect or rms.row_layout.copies or len(lines) != 2 or \
            res["tokens"].shape != (SERVE_BATCH, SERVE_GEN):
        fail(f"the serve CLI: launches {launches} (expected {expect}), "
             f"{len(lines)} [serve] lines, tokens "
             f"{res['tokens'].shape}")
    gc.collect()
    torch.cuda.empty_cache()
    return launches, res


def decode_batch(cfg, tag, batch, n, seed):
    """Tokens (batch, n) and, for the vlm, VL_IMAGE image embeddings and a
    (t, h, w) grid: the image a 16 x 32 patch grid at t 0 (its sections
    differ), then text at its index in every section, as decode rotates."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, n),
                                  dtype=np.int32)}
    if tag == "qwen2-vl":
        i = np.arange(VL_IMAGE)
        pos = np.stack([np.zeros_like(i), i // 32, i % 32], -1)
        text = np.arange(VL_IMAGE, n)
        pos = np.concatenate([pos, np.repeat(text[:, None], 3, -1)], 0)
        out["positions"] = np.broadcast_to(pos[None], (batch, n, 3))
        out["image_embeds"] = rng.standard_normal(
            (batch, VL_IMAGE, cfg.d_model), dtype=np.float32)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to("cuda")
            for k, v in out.items()}


def nbytes(tree):
    """The bytes of the tensors of a cache tree ({group: {leaf: tensor}})
    or a flat dict of tensors."""
    return sum(nbytes(v) if isinstance(v, dict) else
               v.numel() * v.element_size() for v in tree.values())


def cosine(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float((a * b).sum() / (a.norm() * b.norm()))


def decode_cfg(arch, layers, kw):
    """The config a DECODE_MODELS entry decodes: ``arch`` at full width
    cut to ``layers`` layers, with ``kw``'s fields; an MoE at capacity
    factor 8 (DeepSeek-V3 with phase 14's experts)."""
    import dataclasses as dc
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if cfg.moe is not None:
        kw = dict(kw, moe=dc.replace(
            deepseek_kw()["moe"] if arch == DEEPSEEK else cfg.moe,
            capacity_factor=8.0))
    return cfg.replace(num_layers=layers, **kw)


def decode_params(tag, params):
    """``params`` (seed 0, on the host, from a training phase) as the
    DECODE_MODELS entry ``tag`` decodes them: only the keys its config has
    (no ``mtp.*`` for DeepSeek-V3), each stacked leaf cut to its first
    layers and copied, so the rest can be freed."""
    from repro_torch.core.sharding import is_stacked
    from repro_torch.models.transformer import init_params

    _, arch, layers, *_, kw, _ = next(m for m in DECODE_MODELS
                                      if m[0] == tag)
    keys = init_params(decode_cfg(arch, layers, kw), device="meta")
    return {k: v[:layers].clone() if is_stacked(k) and len(v) > layers
            else v for k, v in params.items() if k in keys}


def phase_decode_vs_train(held, models=DECODE_MODELS):
    """Each of ``models`` at full width, from its params in ``held``
    (seed 0, on the host; popped as used): train-mode logits of the whole sequence, then prefill of the prompt
    into a cache of the compute dtype and DECODE_STEPS decode steps; the
    prefill's and every step's logits against the train-mode ones: fp32
    max |d| within DECODE_TOL, bf16 cosine >= MIN_COSINE_BF16. The prefill
    launches K1 once an attention layer (a hybrid's: once a group; K6 for
    RWKV6, from the cache's state) and the decode steps no attention or
    WKV kernel. A model with a gate eps
    takes its fp32 gate at that norm eps, and its fp32 reading at its own
    eps is printed, its launches and finiteness checked but not its
    tolerance. The gated fp32 run's logits (the prefill's last position
    and each step's) and its cache's bytes go into SERVE_ONE_RANK."""
    import gc
    import torch
    from repro_torch.models import transformer as tr

    for tag, arch, layers, batch, s, max_len, kw, gate_eps in models:
        t0 = time.time()
        cfg = decode_cfg(arch, layers, kw)
        prefills = layers // cfg.hybrid_group if cfg.hybrid_group \
            else layers
        want = {k: tuple(v.shape) for k, v in
                tr.init_params(cfg, device="meta").items()}
        host = held.pop(tag)
        if {k: tuple(v.shape) for k, v in host.items()} != want:
            fail(f"{arch}: the held params do not fit the decode config")
        params = {k: v.to("cuda") for k, v in host.items()}
        del host
        n_params = sum(p.numel() for p in params.values())
        full = decode_batch(cfg, tag, batch, s + DECODE_STEPS, seed=1)
        prompt = {k: v[:, :s] if k != "image_embeds" else v
                  for k, v in full.items()}
        kernel = "wkv6_fwd" if arch == "rwkv6-7b" else "flash_fwd"
        readings = []
        # (dtype, norm eps (None: the model's), gated)
        runs = [("float32", None, gate_eps is None)] + \
            ([("float32", gate_eps, True)] if gate_eps else []) + \
            [("bfloat16", None, True)]
        for dname, eps, gated in runs:
            c = cfg.replace(dtype=dname, **({"norm_eps": eps} if eps else {}))
            with torch.inference_mode():
                want, _ = tr.forward(c, params, full, mode="eval")
                cache = tr.init_cache(c, batch, max_len,
                                      dtype=getattr(torch, dname),
                                      device="cuda")
                reset_counters()
                got, cache, _ = tr.forward(c, params, prompt, mode="prefill",
                                           cache=cache)
                prefill_launches = read_counters()[kernel]
                pairs = [(got, want[:, :s])]
                for i in range(DECODE_STEPS):
                    step, cache, _ = tr.forward(
                        c, params, {"token": full["tokens"][:, s + i:s + i
                                                            + 1],
                                    "index": s + i}, mode="decode",
                        cache=cache)
                    pairs.append((step[:, 0], want[:, s + i]))
                torch.cuda.synchronize()
                decode_launches = read_counters()[kernel] - prefill_launches
            if dname == "float32" and gated:
                # phase 19m holds each model rank's logits against these
                SERVE_ONE_RANK[tag] = (
                    torch.stack([pairs[0][0][:, -1]] + [a for a, _ in
                                                        pairs[1:]], 1)
                    .cpu().numpy(), nbytes(cache) / 1e9)
            diffs = [(a.float() - b.float()).abs().max().item()
                     for a, b in pairs]
            coss = [cosine(a, b) for a, b in pairs]
            finite = all(bool(torch.isfinite(a).all()) for a, _ in pairs)
            ok = finite and prefill_launches == prefills and \
                decode_launches == 0 and (
                    not gated or (max(diffs) <= DECODE_TOL
                                  if dname == "float32"
                                  else min(coss) >= MIN_COSINE_BF16))
            readings.append(
                f"{dname} at norm eps {c.norm_eps:g}"
                f"{'' if gated else ' (a reading, not gated)'}: "
                f"prefill max|d| {diffs[0]:.3e}, decode steps "
                f"max|d| {[float(f'{d:.3e}') for d in diffs[1:]]}, cosines "
                f"{[round(x, 6) for x in coss]} ({kernel} launches: prefill "
                f"{prefill_launches}, decode {decode_launches}) "
                f"{'ok' if ok else 'FAIL'}")
            del want, cache, got, pairs
            if not ok:
                print(f"[decode] {tag}: {readings[-1]}", flush=True)
                fail(f"{arch} decode disagrees with its train-mode logits "
                     f"in {dname} at norm eps {c.norm_eps:g}")
        print(f"[decode] {arch} at full width, {layers} layer(s), "
              f"{n_params / 1e9:.3f} B params, batch {batch}, prompt {s}, "
              f"cache {max_len} rows, {DECODE_STEPS} decode steps (fp32 "
              f"gate max|d| <= {DECODE_TOL:g}, bf16 cosine >= "
              f"{MIN_COSINE_BF16}): " + "; ".join(readings)
              + f" ({time.time() - t0:.1f}s)", flush=True)
        del params, full, prompt
        gc.collect()
        torch.cuda.empty_cache()


def phase_vl_train(card, host):
    """Qwen2-VL-72B at full width cut to VL_LAYERS layer from ``host``'s
    params (seed 0, on the host), through the port's ``Trainer`` in
    process: VL_STEPS bf16 steps at batch VL_BATCH x
    LM_SEQ with min(vision_tokens, LM_SEQ // 2) = 512 image embeddings
    (the CLI's vlm feed, ``launch/specs.py::concrete_batch``, seeded by the
    step), accum 1, the counters reset just before and read just after
    (K1-K3 once a step, K4/K5 three times: ln1, ln2, the final norm), every
    loss and grad norm finite, ``step_ok`` 1, the peak of allocated device
    memory beside the prediction, the warm steps' tokens/s; then kernel
    against naive path on the first batch from the same params (fp32 max
    |dgrad| within 2e-4, bf16 cosine >= 0.99). Returns the run's
    launches."""
    import gc
    import math
    import torch
    from repro_torch.core.engine import to_device
    from repro_torch.launch.specs import concrete_batch

    def free():
        gc.collect()
        torch.cuda.empty_cache()
    free()
    torch.cuda.reset_peak_memory_stats()
    kw = {"arch": VL, "layers": VL_LAYERS, "batch": VL_BATCH, "accum": 1,
          "seq": LM_SEQ}
    trainer, _ = lm_setup("bfloat16", True, **kw)
    cfg = trainer.cfg
    batches = [to_device(concrete_batch(cfg, VL_BATCH, LM_SEQ, seed=i),
                         "cuda") for i in range(VL_STEPS)]
    n_img = batches[0]["image_embeds"].shape[1]
    params = {k: v.to("cuda") for k, v in host.items()}
    n_params = sum(p.numel() for p in params.values())
    state = trainer.init_state(params)
    del params
    expect = dict({name: 0 for name in counters()},
                  flash_fwd=VL_STEPS * VL_LAYERS,
                  flash_bwd_dq=VL_STEPS * VL_LAYERS,
                  flash_bwd_dkv=VL_STEPS * VL_LAYERS,
                  rmsnorm_fwd=VL_STEPS * (2 * VL_LAYERS + 1),
                  rmsnorm_bwd=VL_STEPS * (2 * VL_LAYERS + 1))
    reset_counters()
    rows, times = [], []
    for batch in batches:
        t0 = time.perf_counter()
        state, m = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        rows.append({"loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"]),
                     "step_ok": m["step_ok"]})
    launches = read_counters()
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"[vl] train: launches {launches} (expected {expect})", flush=True)
    if launches != expect:
        fail(f"{VL} train: launches {launches}; expected {expect}")
    for r in rows:
        if not (math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
                and r["step_ok"] == 1):
            fail(f"{VL} train: bad step row {r}")
    warm = statistics.median(times[1:])
    print(f"[vl] {VL} ({VL_LAYERS} layer, full width: d {cfg.d_model}, "
          f"{cfg.num_heads}:{cfg.num_kv_heads} heads of {cfg.head_dim}, "
          f"M-RoPE {cfg.mrope_sections}; {n_params / 1e9:.3f} B params) bf16, "
          f"batch {VL_BATCH} x {LM_SEQ} with {n_img} image embeddings, "
          f"accum 1: losses {[round(r['loss'], 4) for r in rows]}; grad "
          f"norms {[round(r['grad_norm'], 3) for r in rows]}; step_ok all "
          f"1; step times {[round(t * 1e3, 1) for t in times]} ms (the "
          f"first cold), warm {VL_BATCH * LM_SEQ / warm:.1f} tokens/s; "
          f"torch.cuda.max_memory_allocated {peak:.2f} GB (predicted "
          f"{VL_PEAK_GB[0]:g}-{VL_PEAK_GB[1]:g} GB); {smi_line()}",
          flush=True)
    del state
    free()
    params = {k: v.to("cuda") for k, v in host.items()}
    for dtype in ("float32", "bfloat16"):
        trainer_k, _ = lm_setup(dtype, True, **kw)
        trainer_n, _ = lm_setup(dtype, False, **kw)
        report_agreement(f"{VL}, one microbatch of {VL_BATCH} x {LM_SEQ} "
                         f"with {n_img} image embeddings,", dtype,
                         grad_agreement(trainer_k, trainer_n, params,
                                        batches[0], dtype))
        del trainer_k, trainer_n
        free()
    del params, batches
    free()
    return launches


def serve_rates(card):
    """Readings, not gated, of Qwen2.5-14B at SERVE_LAYERS layers in
    process (prompt SERVE_PROMPT, SERVE_GEN generated, a cache of the
    compute dtype): warm prefill ms and decode tokens/s in bf16 at each
    batch of SERVE_RATE_BATCHES and in fp32 at SERVE_BATCH; then one
    decode step at SERVE_BATCH in each dtype split into its device time
    (CUDA events, the host ahead of the card), its host time (issuing the
    step while the card is busy) and the decode loop's time a step, the
    busy share being device over loop time; then one bf16 step under
    ``torch.profiler`` (after the rates: a profiler session slows the host
    work timed after it): the device spans' union against the step's wall
    time, and its table."""
    import gc
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.core.engine import Server, greedy
    from repro_torch.models.transformer import init_params

    cfg = get_config(QWEN).replace(num_layers=SERVE_LAYERS)
    params = init_params(cfg, seed=0, device="cuda")
    servers = {d: Server(cfg.replace(dtype=d), params)
               for d in ("bfloat16", "float32")}
    rows = [("bfloat16", b) for b in SERVE_RATE_BATCHES] + \
        [("float32", SERVE_BATCH)]
    loop_ms, caches = {}, {}
    for dname, batch in rows:
        server = servers[dname]
        prompt = np.random.default_rng(0).integers(
            0, cfg.vocab_size, (batch, SERVE_PROMPT), dtype=np.int32)
        for _ in range(2):          # the first run warms up
            cache = server.init_cache(batch, SERVE_PROMPT + SERVE_GEN)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            last, cache = server.prefill({"tokens": prompt}, cache)
            tok = greedy(last)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for i in range(SERVE_GEN - 1):
                tok, cache = server.decode_step(cache, tok, SERVE_PROMPT + i)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        loop_ms[dname, batch] = (t2 - t1) / (SERVE_GEN - 1) * 1e3
        if batch == SERVE_BATCH:
            caches[dname] = (cache, tok)
        print(f"[serve] {QWEN} ({SERVE_LAYERS} layers, full width) {dname} "
              f"in process, batch {batch}: prefill ({SERVE_PROMPT} tokens) "
              f"{(t1 - t0) * 1e3:.1f} ms, decode "
              f"{batch * (SERVE_GEN - 1) / (t2 - t1):.1f} tokens/s "
              f"({loop_ms[dname, batch]:.3f} ms a step over "
              f"{SERVE_GEN - 1} steps; warm; a reading, not gated; {card})",
              flush=True)
        del cache
    steps = {}
    for dname, (cache, tok) in caches.items():
        def step(server=servers[dname], cache=cache, tok=tok):
            return server.decode_step(cache, tok, SERVE_PROMPT)[0]
        device = time_ms(step, warmup=2, reps=10)
        hosts = []
        for _ in range(10):
            torch.cuda.synchronize()
            torch.cuda._sleep(SPIN_CYCLES)
            t0 = time.perf_counter()
            step()
            hosts.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
        host = statistics.median(hosts)
        loop = loop_ms[dname, SERVE_BATCH]
        steps[dname] = step
        print(f"[serve] one {dname} decode step of {QWEN} ({SERVE_LAYERS} "
              f"layers, batch {SERVE_BATCH}, {SERVE_PROMPT + SERVE_GEN}-row "
              f"cache; readings, not gated): device {device:.3f} ms (CUDA "
              f"events, host ahead), host {host:.3f} ms (issuing it, median "
              f"of 10), decode loop {loop:.3f} ms a step: busy "
              f"{device / loop:.1%}; {card}", flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps["bfloat16"]()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans, busy = device_spans(prof)
    print(f"[serve] one bf16 decode step under torch.profiler: "
          + (f"{len(spans)} device spans, device time {busy / 1e3:.3f} ms of "
             f"a {wall:.3f} ms step (busy {busy / 1e3 / wall:.1%} under the "
             f"profiler)" if spans else "device time not measured")
          + f"; {card}", flush=True)
    table = prof.key_averages().table(sort_by="self_device_time_total",
                                      row_limit=15)
    print(f"[profile] one bf16 decode step:\n{table}", flush=True)
    del servers, params, caches, steps
    gc.collect()
    torch.cuda.empty_cache()


def phase_serving(card, held):
    """Phase 15: serving and Qwen2-VL (15a-15e), from the params ``held``
    by the training phases ({DECODE_MODELS tag: params on the host}) and
    Qwen2-VL's, drawn here once. The serve CLI's, Qwen2-VL's and Gemma3's
    draws (all three made on the card) leave their fingerprints in
    SERVE_PRINTS: phase 19m's ranks draw them again (``serve_params``).
    Returns
    (K1's prefill timing row, the serve CLI's launches, Qwen2-VL
    training's launches, the serve CLI's tokens)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.transformer import init_params

    t0 = time.time()
    prefill = phase_prefill_kernels(card.split(",")[0])
    # the serve CLI's seed-0 draw's fingerprint, for phase 19m
    draw = serve.init_params

    def keep(cfg, **kw):
        params = draw(cfg, **kw)
        SERVE_PRINTS[cfg.name, cfg.num_layers] = fingerprint(params)
        return params
    serve.init_params = keep
    try:
        serve_launches, res = phase_serve_cli()
    finally:
        serve.init_params = draw
    print(f"[serve] {QWEN} ({SERVE_LAYERS} layers) fp32 through the CLI, "
          f"batch {SERVE_BATCH}: prefill ({SERVE_PROMPT} tokens) "
          f"{res['prefill_ms']:.1f} ms, decode {res['tok_s']:.1f} tokens/s "
          f"({SERVE_GEN - 1} steps in {res['decode_ms']:.1f} ms; cold: the "
          f"first calls included; a reading, not gated; {card})", flush=True)
    t_draw = time.time()
    vl_cfg = get_config(VL).replace(num_layers=VL_LAYERS)
    vl_host = init_params(vl_cfg, seed=0, device="cpu", draw_on="cuda")
    print(f"[serve] {VL} ({VL_LAYERS} layer) params drawn on the card and "
          f"copied to the host in {time.time() - t_draw:.1f}s", flush=True)
    phase_decode_vs_train(dict(held, **{"qwen2-vl": vl_host}))
    SERVE_PRINTS[get_config("gemma3-12b").name, GEMMA_LAYERS] = \
        fingerprint(held["gemma3"])
    SERVE_PRINTS[vl_cfg.name, VL_LAYERS] = fingerprint(vl_host)
    held.clear()
    vl_launches = phase_vl_train(card, vl_host)
    del vl_host
    serve_rates(card)
    print(f"[serve] phase 15 (serving and Qwen2-VL) in "
          f"{time.time() - t0:.1f}s", flush=True)
    return prefill, serve_launches, vl_launches, res["tokens"]


def phase_hubert(profile):
    """Phase 16: HuBERT-XLarge through the training CLI at full width cut
    to HUBERT_LAYERS layers (HUBERT_ARGS, bf16, the audio batches drawn
    each step) by
    ``decoder_train``: K1-K3 once a layer and microbatch, no K4/K5
    (LayerNorm); kernel against naive path on one microbatch (8 x 781) and
    warm frames/s of both paths in turns (1 warm-up and 3 timed steps a
    run). Returns the CLI run's launches."""
    t0 = time.time()
    attn = HUBERT_STEPS * HUBERT_ACCUM * HUBERT_LAYERS
    launches, _, _ = decoder_train(
        HUBERT, HUBERT_LAYERS, HUBERT_ARGS, {
            "flash_fwd": attn, "flash_bwd_dq": attn, "flash_bwd_dkv": attn},
        "hubert", profile, seq=HUBERT_SEQ, batch=HUBERT_BATCH,
        accum=HUBERT_ACCUM, agree=(HUBERT_BATCH // HUBERT_ACCUM, HUBERT_SEQ),
        steps=HUBERT_STEPS, timed=(3, 1), unit="frames")
    print(f"[hubert] phase 16 in {time.time() - t0:.1f}s", flush=True)
    return launches


def device_spans(prof):
    """(the device spans of a ``torch.profiler`` session, the time in us
    their union covers)."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, None
    for a, b in spans:              # the union of the device spans
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return spans, busy


def scan_split(card, trainer, pipe, params):
    """A reading of where a warm zamba2 training step's device time goes,
    under torch.profiler: the step's device time (the union of its device
    spans) and the top of its table, and the eager SSD scan's forward and
    backward alone at one layer's shape, times the layers and microbatches
    of a step."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.engine import to_device
    from repro_torch.models import mamba2

    def device_ms(fn):
        fn()                                    # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        spans, busy = device_spans(prof)
        if not spans:
            fail("zamba2: torch.profiler recorded no device time")
        return busy / 1e3, prof

    cfg = trainer.cfg
    state = trainer.init_state({k: v.to("cuda", copy=True)
                                for k, v in params.items()})
    batch = to_device(pipe.batch_at(0, 0), "cuda")

    def step():
        nonlocal state
        state, _ = trainer.train_step(state, batch)
    step_ms, prof = device_ms(step)
    table = prof.key_averages().table(sort_by="self_device_time_total",
                                      row_limit=15)
    del state, batch, prof
    d_in, h, _ = mamba2.dims(cfg)
    p, n = cfg.ssm.head_dim, cfg.ssm.state_dim
    b, s = ZAMBA_BATCH // ZAMBA_ACCUM, ZAMBA_SEQ
    gen = torch.Generator(device="cuda").manual_seed(21)
    xh = torch.randn((b, s, h, p), device="cuda", generator=gen).bfloat16()
    bm, cm = (torch.randn((b, s, n), device="cuda", generator=gen)
              .bfloat16() for _ in range(2))
    dt = torch.nn.functional.softplus(torch.randn(
        (b, s, h), device="cuda", generator=gen) + 0.5)
    leaves = [t.requires_grad_() for t in (xh, bm, cm, dt)]
    a_log, h0 = torch.zeros(h, device="cuda"), torch.zeros(
        (b, h, p, n), device="cuda")

    def scan():
        y, h_end = mamba2._ssd_chunk_scan(*leaves, a_log,
                                          cfg.ssm.chunk_size, h0)
        torch.autograd.grad((y.sum() + h_end.sum()), leaves)
    scan_ms, _ = device_ms(scan)
    uses = ZAMBA_LAYERS * ZAMBA_ACCUM
    print(f"[zamba2] one warm training step under torch.profiler: device "
          f"time {step_ms:.2f} ms; the SSD scan alone (forward and "
          f"backward, B {b}, S {s}, H {h}, P {p}, N {n}, chunk "
          f"{cfg.ssm.chunk_size}) {scan_ms:.3f} ms of device time a layer, "
          f"x {uses} = {scan_ms * uses:.1f} ms, "
          f"{scan_ms * uses / step_ms:.1%} of the step's (a reading; "
          f"{card})", flush=True)
    print(f"[profile] one warm {ZAMBA} ({ZAMBA_LAYERS} layers) training "
          f"step:\n{table}", flush=True)


def phase_zamba2(card):
    """Phase 17: Zamba2-2.7B through the training CLI at full width cut to
    ZAMBA_LAYERS layers (ZAMBA_ARGS, bf16) by ``decoder_train``: K1-K3
    once a group and microbatch; K4/K5 twice a Mamba2 layer (its norm and
    the inner RMSNorm at 5120), twice a use of the shared block, once for
    the final norm; kernel against naive path on one microbatch (2 x 4096,
    ``shared_attn.*`` among the gradients) and warm tokens/s of the kernel
    path. Then, from the same params of seed 0 on the host: the step's
    device time split (``scan_split``), prefill and decode against
    train-mode logits (``ZAMBA_DECODE``) and the serve CLI (fp32; K1 once
    a group in the prefill, K4 29 times a forward). Returns (the training
    run's launches, the serve CLI's, the seed-0 params on the host for
    phase 19: its training runs take their first TP_ZAMBA_LAYERS layers,
    its decode job all of them)."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.transformer import init_params

    def free():
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.time()
    groups = ZAMBA_LAYERS // get_config(ZAMBA).hybrid_group
    attn = ZAMBA_STEPS * ZAMBA_ACCUM * groups
    norms = ZAMBA_STEPS * ZAMBA_ACCUM * (2 * ZAMBA_LAYERS + 2 * groups + 1)
    shape = {"seq": ZAMBA_SEQ, "batch": ZAMBA_BATCH, "accum": ZAMBA_ACCUM}
    launches, _, host = decoder_train(
        ZAMBA, ZAMBA_LAYERS, ZAMBA_ARGS, {
            "flash_fwd": attn, "flash_bwd_dq": attn, "flash_bwd_dkv": attn,
            "rmsnorm_fwd": norms, "rmsnorm_bwd": norms}, "zamba2", False,
        agree=(ZAMBA_BATCH // ZAMBA_ACCUM, ZAMBA_SEQ), steps=ZAMBA_STEPS,
        timed=(3, 1), paths=("kernel",), **shape)
    trainer, pipe = lm_setup("bfloat16", True, arch=ZAMBA,
                             layers=ZAMBA_LAYERS, **shape)
    scan_split(card, trainer, pipe, host)
    del trainer
    free()
    phase_decode_vs_train({"zamba2": host}, ZAMBA_DECODE)
    draw = serve.init_params

    def held(cfg, seed=0, device="cuda"):
        # the serve CLI's seed-0 draw is this phase's, on the host
        want = {k: tuple(v.shape) for k, v in
                init_params(cfg, device="meta").items()}
        if seed != 0 or {k: tuple(v.shape) for k, v in host.items()} \
                != want:
            fail("the serve CLI's config does not fit the held params")
        return {k: v.to(device) for k, v in host.items()}
    serve.init_params = held
    try:
        serve_launches, res = phase_serve_cli(
            ZAMBA_SERVE_ARGS, attn=groups,
            norms=(2 * ZAMBA_LAYERS + 2 * groups + 1) * SERVE_GEN)
    finally:
        serve.init_params = draw
    print(f"[serve] {ZAMBA} ({ZAMBA_LAYERS} layers) fp32 through the CLI, "
          f"batch {SERVE_BATCH}: prefill ({SERVE_PROMPT} tokens) "
          f"{res['prefill_ms']:.1f} ms, decode {res['tok_s']:.1f} tokens/s "
          f"({SERVE_GEN - 1} steps in {res['decode_ms']:.1f} ms; cold; a "
          f"reading, not gated; {card})", flush=True)
    free()
    print(f"[zamba2] phase 17 in {time.time() - t0:.1f}s", flush=True)
    return launches, serve_launches, host


def main():
    t_script = time.time()
    secs = {}

    def timed(name, fn, *args):
        """``fn(*args)``, its seconds kept under ``name`` for the
        ``[chip_smoke] phases`` line."""
        t0 = time.time()
        out = fn(*args)
        secs[name] = round(time.time() - t0, 1)
        return out
    card = timed("1 card", phase_card)
    one = card.split(",")[0]
    sys.path.insert(0, str(ROOT / "src"))
    timed("2 build", phase_build)
    draws = share_draws()
    k1 = timed("3 K1", phase_k1, one)
    vit_rows = [k1] + timed("4 K2/K3", phase_k23, one)
    rms_rows = timed("5 K4/K5", phase_rms, one)
    lm_attn = timed("6 decoder attention", phase_lm_attention, one)
    gemma_attn = timed("6a Gemma3 attention", phase_gemma_attention, one)
    wkv_rows = timed("6b K6/K7", phase_wkv6, one)
    d80_attn = timed("6c D 80 attention", phase_d80_attention, one)
    print(f"[d80-attn] phase 6c in {secs['6c D 80 attention']:.1f}s",
          flush=True)
    profile = "--profile" in sys.argv[1:]
    timed("7 eval slice", phase_slice)
    vit_launches, vit_hist, counts = timed("8 ViT training", phase_train,
                                           profile, one)
    dp_launches, aug_launches, f32_ref = timed(
        "8b data parallel", phase_dp, vit_hist, profile)
    quickstart = start_quickstart()
    resume_launches = timed("8c checkpoints", phase_ckpt, vit_hist, f32_ref)
    timed("quickstart", phase_quickstart, quickstart)
    data_launches = timed("8d host data", phase_data, vit_hist)
    pp_launches, pp_lm_launches, pp_rates_ = timed(
        "18 pipeline", phase_pipeline, card)
    lm_launches = timed("9 ChatGLM3", phase_lm_train, profile)
    # each training phase hands phase 15 its params of seed 0, on the host
    held = {}
    rwkv_launches, held["rwkv6"] = timed("10 RWKV6", phase_rwkv_train,
                                         profile)
    gemma_launches, held["gemma3"] = timed("11 Gemma3", phase_gemma_train,
                                           profile)
    dense_launches = timed("12 Qwen2.5, GLM-4", phase_dense)
    granite_attn = timed("13 Granite attention", phase_granite_attention,
                         one)
    granite_launches, held["granite"] = timed("13 Granite-MoE",
                                              phase_granite, profile, card)
    # phase 19 takes RWKV6's, Granite's and DeepSeek-V3's draws too (phase
    # 15 pops the first two)
    tp_params = {"rwkv6": held["rwkv6"], "granite": held["granite"]}
    mla_attn = timed("14 MLA attention", phase_mla_attention, one)
    deepseek_launches, held["deepseek"], tp_params["deepseek"] = timed(
        "14 DeepSeek-V3", phase_deepseek, profile, card)
    print(f"[deepseek] phase 14 (MLA attention and DeepSeek-V3 training) "
          f"in {secs['14 MLA attention'] + secs['14 DeepSeek-V3']:.1f}s",
          flush=True)
    prefill, serve_launches, vl_launches, cli_tokens = timed(
        "15 serving, Qwen2-VL", phase_serving, card, held)
    hubert_launches = timed("16 HuBERT", phase_hubert, profile)
    zamba_launches, zamba_serve_launches, tp_params["zamba2"] = timed(
        "17 Zamba2", phase_zamba2, card)
    tp_launches, tp_errs, split_rows, tp_mla, tp_serve, tp_serve_k1, \
        tp_collectives, tp_embed = timed(
            "19 tensor parallel", phase_tp, card, f32_ref, tp_params,
            {"prefill": prefill, "tokens": cli_tokens})
    del tp_params
    print(f"[draws] params drawn on the host for the card: {draws['draws']} "
          f"draws made, {draws['shared']} repeats copied from the draw "
          f"before them", flush=True)
    if profile:
        profile_eval()
    def tp_family_launches(name):
        """Phase 19's runs' launches of kernel ``name`` by family, a
        rank's: ChatGLM3-6B (at model axis 2 and 4, and at pipe 2 x model
        2 flat and interleaved, by stage), Zamba2-2.7B, Granite-MoE
        (GShard and gather), RWKV6-7B and DeepSeek-V3 at model axis 2 and
        4."""
        return {f"tp_{fam}_launches": {
                    label: n[name] for label, n in tp_launches.items()
                    if label.startswith(fam)}
                for fam in ("chatglm3", "zamba2", "granite", "rwkv6",
                            "deepseek")}
    def tp_serve_launches(name):
        """Phase 19m's serving runs' launches of kernel ``name``, a
        rank's, by run (19o's decode under "dmodel" among them)."""
        return {label: n[name] for label, n in tp_serve.items()}

    def tp_embed_launches(name):
        """Phase 19o's "dmodel" training runs' launches of kernel
        ``name``, a rank's, by run."""
        return {label: n[name] for label, n in tp_embed.items()}
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
        # the training slice through the 1F1B pipeline at --pp 2 (phase 18,
        # batch 128 in 4 microbatches, 6 steps) and the warm rates there
        vit["pipeline_launches"] = pp_launches[row["name"]]
        vit["pipeline_images_per_s"] = pp_rates_
        # the training slice at model axis 2 (and data 2 x model 2, and
        # pipe 2 x model 2 by stage), each rank on the one card (phase
        # 19): a rank's launches
        vit["tp_launches"] = {label: n[row["name"]]
                              for label, n in tp_launches.items()
                              if label.startswith("vit")}
        if row["name"] in REDESIGNED:
            row = dict(row, redesigned=True, routes=ROUTES[row["name"]])
        # the dense-decoder family: Gemma3's attention (head dim 256) timed
        # at a local layer's window, its training run's launches, and the
        # Qwen2.5 and GLM-4 runs'
        gemma = dict(gemma_attn[key], launches=gemma_launches[row["name"]])
        # the MoE decoder: Granite-MoE's attention (D 64, a group of 3) and
        # its training run's launches
        granite = dict(granite_attn[key],
                       launches=granite_launches[row["name"]])
        # DeepSeek-V3's MLA: the attention at (D 192, Dv 128) and its
        # training run's launches
        deepseek = dict(mla_attn[key],
                        launches=deepseek_launches[row["name"]])
        # serving: K1 at the serve run's prefill shape and its launches;
        # Qwen2-VL training's launches
        serve = {"serve_launches": serve_launches[row["name"]],
                 "qwen2vl_launches": vl_launches[row["name"]]}
        if key == "fwd":
            serve["serve"] = dict(prefill,
                                  launches=serve_launches[row["name"]])
        # head dim 80: HuBERT's and Zamba2's attention timed in phase 6c,
        # their training runs' launches (phases 16, 17), Zamba2's serve CLI
        d80 = {"hubert": dict(d80_attn["hubert"][key],
                              launches=hubert_launches[row["name"]]),
               "zamba2": dict(d80_attn["zamba2"][key],
                              launches=zamba_launches[row["name"]]),
               "zamba2_serve_launches": zamba_serve_launches[row["name"]]}
        # ChatGLM3-6B at model axis 2 and 4 (phase 19): a rank's launches,
        # and K1-K3 at a model-axis-4 rank's shape (a KV head sliced from
        # the whole projection) against their plain versions
        tp = dict(tp_family_launches(row["name"]),
                  tp_rank_shape={"shape": list(TP_RANK_SHAPE),
                                 "max_abs_err": tp_errs[key]},
                  tp_mla={m: rows[key] for m, rows in tp_mla.items()},
                  tp_serve_launches=tp_serve_launches(row["name"]),
                  tp_embed_dmodel_launches=tp_embed_launches(row["name"]))
        if key == "fwd":
            # serving across ranks (19m): K1 at a model-axis-2 rank's
            # prefill shapes, beside the one-rank shape's
            tp["tp_serve"] = tp_serve_k1
        kernels.append(dict(row, **lm_attn[key], **serve, **tp,
                            launches=lm_launches[row["name"]], vit=vit,
                            gemma3_launches=gemma_launches[row["name"]],
                            gemma3=gemma, dense_launches={
                                arch: n[row["name"]]
                                for arch, n in dense_launches.items()},
                            granite_launches=granite_launches[row["name"]],
                            granite=granite,
                            deepseek_launches=deepseek_launches[row["name"]],
                            deepseek=deepseek,
                            pipeline_chatglm3_launches=pp_lm_launches[
                                row["name"]], **d80))
    # K4-K7's launches are the RWKV6 run's; K4/K5 run on both decoder
    # paths, so their rows carry the ChatGLM3 run's beside them
    for row in rms_rows + wkv_rows:
        extra = {"launches": rwkv_launches[row["name"]],
                 "serve_launches": serve_launches[row["name"]],
                 "qwen2vl_launches": vl_launches[row["name"]]}
        if row in rms_rows:
            extra["chatglm3_launches"] = lm_launches[row["name"]]
            extra["gemma3_launches"] = gemma_launches[row["name"]]
            extra["dense_launches"] = {arch: n[row["name"]] for arch, n
                                       in dense_launches.items()}
            extra["granite_launches"] = granite_launches[row["name"]]
            extra["deepseek_launches"] = deepseek_launches[row["name"]]
            extra["hubert_launches"] = hubert_launches[row["name"]]
            extra["zamba2_launches"] = zamba_launches[row["name"]]
            extra["zamba2_serve_launches"] = \
                zamba_serve_launches[row["name"]]
            extra["pipeline_chatglm3_launches"] = pp_lm_launches[row["name"]]
        extra.update(tp_family_launches(row["name"]))
        extra["tp_serve_launches"] = tp_serve_launches(row["name"])
        extra["tp_embed_dmodel_launches"] = tp_embed_launches(row["name"])
        if row["name"] in REDESIGNED:
            extra.update(redesigned=True, routes=ROUTES[row["name"]])
        kernels.append(dict(row, **extra))
    # the split-row K4/K5 (phase 19i's times): launches on the Zamba2 run
    # at model axis 2 (a rank's), with their partial passes'
    zamba_m2 = tp_launches["zamba2 fp32 --model-axis 2"]
    for row, partial in zip(split_rows, ("rmsnorm_sumsq", "rmsnorm_bwd_dot")):
        kernels.append(dict(
            row, launches=zamba_m2[row["name"]],
            partial_launches=zamba_m2[partial],
            tp_serve_launches=tp_serve_launches(row["name"]),
            **tp_family_launches(row["name"]),
            partial_tp_zamba2_launches={
                label: n[partial] for label, n in tp_launches.items()
                if label.startswith("zamba2")}))
    # phase 8 (a) and phase 19 (b): the dry run's counts against the card's
    print("[chip_smoke] counts " + json.dumps({
        "vit_train_step": counts,
        "tp_collectives": {f"{label} rank {rank}": c for (label, rank), c
                           in tp_collectives.items()}}), flush=True)
    print(json.dumps({"kernels": kernels}))
    print(f"[chip_smoke] phases {json.dumps(secs)}", flush=True)
    print(f"[chip_smoke] whole script {time.time() - t_script:.1f}s",
          flush=True)
    print(card)
    import torch
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
