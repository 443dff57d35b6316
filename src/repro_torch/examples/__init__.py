"""The paper's example scripts on the port (``examples/`` of the JAX package):
``quickstart``, ``train_vit_cifar`` and ``scaling_sweep``, each run as
``python -m repro_torch.examples.<name>``."""
