"""Optimizers and learning-rate schedules of the port."""
from repro_torch.optim.optimizers import Optimizer, make_optimizer  # noqa: F401
