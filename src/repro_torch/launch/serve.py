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
paths. It runs on ``cuda`` unless ``--device cpu`` is given, on one
device: the reference's sharded cache over a data and model mesh
(``--devices``, ``--model-axis``) is not ported.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.engine import Server, greedy, resolve_device
from repro_torch.models.transformer import init_params

# the flags of the reference's that wait for a later slice
NOT_PORTED = "serving across ranks and the model axis (ROADMAP item 16.3)"


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-14b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--devices", type=int, default=0,
                    help="not ported: " + NOT_PORTED)
    ap.add_argument("--model-axis", type=int, default=1,
                    help="not ported: " + NOT_PORTED)
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to N layers (0: the config's)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--no-kernels", action="store_true",
                    help="plain RMSNorm and the naive/chunked paths")
    args = ap.parse_args(argv)
    if args.devices > 1 or args.model_axis > 1:
        raise SystemExit(f"[serve] --devices {args.devices} --model-axis "
                         f"{args.model_axis}: {NOT_PORTED} is not yet "
                         f"ported to repro_torch; serve on one device")
    if args.prompt_len < 1 or args.gen < 1:
        raise SystemExit("[serve] --prompt-len and --gen must be >= 1")
    return args


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    """Serve once; returns {"prefill_ms", "decode_ms", "tok_s",
    "tokens": the generated ids (batch, gen) int32 numpy}."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    cfg = cfg.replace(dtype="float32", use_kernels=not args.no_kernels)
    if args.layers:
        cfg = cfg.replace(num_layers=args.layers)
    if not cfg.supports_decode():
        raise SystemExit(f"[serve] {cfg.name} has no decode step (an "
                         f"encoder or a classifier)")
    server = Server(cfg, init_params(cfg, seed=0, device=device),
                    device=device)
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

    gen = torch.cat(out, dim=1).cpu().numpy()
    tps = args.batch * (args.gen - 1) / max(t_decode, 1e-9)
    print(f"[serve] arch={cfg.name} batch={args.batch} "
          f"prefill({args.prompt_len} tok)={t_prefill * 1e3:.1f}ms "
          f"decode={t_decode * 1e3:.1f}ms ({tps:.1f} tok/s)")
    print(f"[serve] sample generations (token ids):\n{gen[:2, :16]}",
          flush=True)
    return {"prefill_ms": t_prefill * 1e3, "decode_ms": t_decode * 1e3,
            "tok_s": tps, "tokens": gen}


if __name__ == "__main__":
    main()
