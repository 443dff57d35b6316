"""Build the hand-written CUDA kernels and load them through ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and no PyTorch headers, so
``nvcc`` compiles it in seconds into ``build/kernels/lib<name>-<hash>.so``
(the hash covers the source, the shared ``csrc/*.cuh`` headers and the
flags, so an edit to any of them rebuilds). The build happens at first
use, from the sources in the checkout only; a failed build raises with the
compiler's output. ``nvcc``'s ``-Xptxas -v`` report (registers, shared
memory, spills) is kept beside the library as ``.log``. Every function
takes its sources from ``CSRC`` unless given another directory, such as a
copy of ``csrc/`` with one part of a kernel taken out for a timing
ablation.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("flash_fwd", "flash_bwd", "rmsnorm", "wkv6")
# -split-compile=0: each nvcc optimises a source's kernels on every core
# (wkv6.cu's 64 instantiations took most of the build serially)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
              "-split-compile=0")

_loaded: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.isfile("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit on PATH or under /usr/local/cuda")
    return path


def lib_path(name: str, csrc: Path | None = None) -> Path:
    """The library for ``<csrc>/<name>.cu``, named by a digest of that
    source, every ``*.cuh`` header beside it (name and content) and the
    flags."""
    csrc = csrc or CSRC
    h = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES, csrc: Path | None = None) -> dict:
    """Compile each named source of ``csrc`` that has no library yet, one
    ``nvcc`` per source, all started together. Returns {name: compiler
    log}."""
    csrc = csrc or CSRC
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        so = lib_path(name, csrc)
        if so.exists():
            continue
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        log = so.with_suffix(".log")
        with open(log, "w") as f:
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                 str(csrc / f"{name}.cu")],
                stdout=f, stderr=subprocess.STDOUT)
        jobs[name] = (proc, tmp, so, log)
    logs, failed = {}, []
    for name, (proc, tmp, so, log) in jobs.items():
        proc.wait()
        logs[name] = log.read_text()
        if proc.returncode:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n"
                          f"{logs[name]}")
        else:
            os.replace(tmp, so)     # atomic: a concurrent build is harmless
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return logs


def load(name: str, csrc: Path | None = None) -> ctypes.CDLL:
    """The loaded library for ``<csrc>/<name>.cu``, building it first if
    needed; cached by directory and name for the life of the process."""
    key = (csrc or CSRC, name)
    if key not in _loaded:
        so = lib_path(name, key[0])
        if not so.exists():
            build([name], key[0])
        _loaded[key] = ctypes.CDLL(str(so))
    return _loaded[key]
