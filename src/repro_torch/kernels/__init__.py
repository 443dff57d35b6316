"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Nothing here compiles or loads a kernel at import: ``build.load`` runs
``nvcc`` at first use on the card.
"""
