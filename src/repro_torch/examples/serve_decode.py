"""Serving example (``examples/serve_decode.py`` of the JAX package):
batched prefill and greedy decode with a cache, at smoke size, through
``python -m repro_torch.launch.serve``, on the reference's list of
architecture families: attention (``qwen2.5-14b``), recurrent
(``rwkv6-7b``) and hybrid (``zamba2-2.7b``: Mamba2 layers and a shared
attention block, decoding from the SSM state and one KV cache a group).

    PYTHONPATH=src python -m repro_torch.examples.serve_decode [--device cpu]

It runs on ``cuda`` unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ARCHS = ("qwen2.5-14b", "rwkv6-7b", "zamba2-2.7b")


def main(argv=None) -> int:
    """Serve each arch in a child process; returns the first non-zero exit
    code, else 0."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=SRC + (os.pathsep + path if path
                                             else ""))
    for arch in ARCHS:
        print(f"\n=== {arch} ===", flush=True)
        r = subprocess.call(
            [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
             arch, "--smoke", "--batch", "2", "--prompt-len", "32", "--gen",
             "16", "--device", args.device], env=env)
        if r:
            return r
    return 0


if __name__ == "__main__":
    sys.exit(main())
