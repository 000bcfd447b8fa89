"""Checkpoints of the port (``repro.checkpoint``), in the reference's
``.npz`` key layout: each package loads the other's."""
from repro_torch.checkpoint.npz import load_pytree, save_pytree  # noqa: F401
from repro_torch.checkpoint.fl_state import (  # noqa: F401
    load_fl_state, save_fl_state)
