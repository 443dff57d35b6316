"""Serving CLI of the port (``repro.launch.serve``): prefill a prompt
batch into the KV (or latent, or recurrent-state) cache, then greedy
decode one token a sequence per step:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \\
        --smoke --batch 4 --prompt-len 64 --gen 32 [--device cpu]

As the reference's serve it computes in float32 with params of seed 0,
makes the cache for ``--prompt-len + --gen`` tokens in float32, and prints
two ``[serve]`` lines: the prefill's and the decode loop's milliseconds
with the decode rate (``batch * (gen - 1)`` tokens over the decode time),
then the first two sequences' first 16 generated ids. The prompt is
drawn with numpy from seed 0 (ROADMAP deviation D5). ``--layers`` cuts the
depth, ``--no-kernels`` takes plain RMSNorm and the naive or chunked
paths. It runs on ``cuda`` unless ``--device cpu`` is given.

Across ranks (the reference's data x model mesh, ``launch/serve.py:30-63``):
``--devices N`` starts N ranks (one per card over NCCL; gloo processes with
``--device cpu``), or ``torchrun`` starts them, and ``--model-axis M``
splits each replica's layers over M of them, so ``--devices N`` is dp x M
(``--devices 4 --model-axis 2`` is data 2 x model 2):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-14b \\
        --smoke --device cpu --devices 4 --model-axis 2

Each data rank serves ``batch / dp`` of the rows, each model rank its heads
(``core/engine.py::Server``, ROADMAP D9); a batch the data ranks do not
divide is served whole by each of them; rank 0 prints the two lines over
every row, then a third: the bytes of its part of the cache (a rank's
share; MLA's latents split on the sequence where the model axis divides
the cache's rows, ``core/sharding.py::latents_split``). ``--model-axis``
without a world, a world that is not a multiple of it, a family without a
decode step and more ranks than cards are refused before any rank starts.
:func:`run` serves as one rank of a world its caller owns.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import distributed
from repro_torch.core.engine import Server, greedy, resolve_device
from repro_torch.core.sharding import check_serving
from repro_torch.models.transformer import init_params


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-14b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--devices", type=int, default=0,
                    help="ranks to start (one per card on cuda), dp x "
                         "model; 0 = one device, no process group")
    ap.add_argument("--model-axis", type=int, default=1,
                    help="model ranks per replica: each splits the layers "
                         "and caches its heads")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to N layers (0: the config's)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--no-kernels", action="store_true",
                    help="plain RMSNorm and the naive/chunked paths")
    args = ap.parse_args(argv)
    if args.prompt_len < 1 or args.gen < 1:
        raise SystemExit("[serve] --prompt-len and --gen must be >= 1")
    if args.devices < 0 or args.model_axis < 1:
        raise SystemExit(f"[serve] --devices must be >= 0 and --model-axis "
                         f">= 1: {args.devices}, {args.model_axis}")
    return args


def _torchrun() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def _config(args):
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    cfg = cfg.replace(dtype="float32", use_kernels=not args.no_kernels)
    if args.layers:
        cfg = cfg.replace(num_layers=args.layers)
    return cfg


def _check_layout(args, size) -> None:
    """Refuse, before any rank starts, a layout of ``size`` ranks (0: no
    world) the port cannot serve."""
    m = args.model_axis
    if m > 1 and not size:
        raise SystemExit(f"[serve] --model-axis {m} without a world: start "
                         f"dp x {m} ranks with --devices, or torchrun")
    if size and size % m:
        raise SystemExit(f"[serve] a world of {size} ranks is not a "
                         f"multiple of --model-axis {m}")
    try:
        check_serving(_config(args), args.batch, max(size // m, 1), m)
    except ValueError as e:
        raise SystemExit(f"[serve] {e}") from None


def main(argv=None) -> dict:
    """Serve once; returns rank 0's {"prefill_ms", "decode_ms", "tok_s",
    "tokens": the generated ids (batch, gen) int32 numpy}."""
    argv = sys.argv[1:] if argv is None else argv
    args = parse_args(argv)
    if _torchrun():
        size = int(os.environ["WORLD_SIZE"])
        if args.devices not in (0, size):
            raise SystemExit(f"[serve] --devices {args.devices} under a "
                             f"torchrun world of {size}")
        _check_layout(args, size)
        world = distributed.init_world(args.device)
        try:
            return run(args, world)
        finally:
            distributed.close_world()
    _check_layout(args, args.devices)
    if args.devices:
        return distributed.spawn(_rank_main, args.devices, argv,
                                 device=args.device)[0]
    return run(args, None)


def _rank_main(world, argv):
    """One spawned rank of ``--devices N``."""
    return run(parse_args(argv), world)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(args, world) -> dict:
    """Serve on one device, or as one rank of ``world`` (dp x
    ``--model-axis`` ranks; every rank calls it). Returns
    :func:`main`'s dict, the tokens of every row on every rank."""
    device = resolve_device(args.device) if world is None else world.device
    cfg = _config(args)
    if world is not None:
        _check_layout(args, world.size)
    # across ranks drawn on the host: a rank copies only its parts to its
    # device
    server = Server(cfg, init_params(cfg, seed=0, device=device
                                     if world is None else "cpu"),
                    device=device, world=world, model_axis=args.model_axis)
    max_len = args.prompt_len + args.gen
    cache = server.init_cache(args.batch, max_len, torch.float32)
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len), dtype=np.int32)

    _sync(device)
    t0 = time.perf_counter()
    last_logits, cache = server.prefill({"tokens": prompt}, cache)
    tok = greedy(last_logits)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    out = [tok]
    t0 = time.perf_counter()
    for i in range(args.gen - 1):
        tok, cache = server.decode_step(cache, tok, args.prompt_len + i)
        out.append(tok)
    _sync(device)
    t_decode = time.perf_counter() - t0

    gen = server.gather_rows(torch.cat(out, dim=1)).cpu().numpy()
    tps = args.batch * (args.gen - 1) / max(t_decode, 1e-9)
    if world is None or world.rank == 0:
        print(f"[serve] arch={cfg.name} batch={args.batch} "
              f"prefill({args.prompt_len} tok)={t_prefill * 1e3:.1f}ms "
              f"decode={t_decode * 1e3:.1f}ms ({tps:.1f} tok/s)")
        print(f"[serve] sample generations (token ids):\n{gen[:2, :16]}",
              flush=True)
    if world is not None and world.rank == 0:
        cache_bytes = sum(t.numel() * t.element_size()
                          for leaves in cache.values()
                          for t in leaves.values())
        print(f"[serve] cache {cache_bytes} bytes a rank (data "
              f"{server.row_split} x model {args.model_axis}; latents split "
              f"on the sequence: {server.latents})", flush=True)
    return {"prefill_ms": t_prefill * 1e3, "decode_ms": t_decode * 1e3,
            "tok_s": tps, "tokens": gen}


if __name__ == "__main__":
    main()
