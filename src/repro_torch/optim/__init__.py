"""Optimizers and learning-rate schedules (``repro.optim``), by hand."""
from repro_torch.optim.optimizers import OptState, make_optimizer  # noqa: F401
from repro_torch.optim.schedule import make_schedule  # noqa: F401
