"""repro_torch — the PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

Module names follow the JAX package (``configs``, ``data``, ``models``,
``kernels``, ``core``, ``launch``) so each port module has an obvious
counterpart. This package imports ``torch`` and ``numpy`` only: never
``jax`` and never ``repro`` (whose ``__init__`` imports jax), so it runs on
a GPU machine that has no JAX installed.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``. On
a CUDA tensor a kernel wrapper launches its hand-written kernel or raises;
only a tensor that lies on the CPU takes the kernel's plain PyTorch version.
"""
