"""Learning-rate strategies (paper Section 5.9; ``repro.optim.schedules``).

``cosine``  one cosine decay over the whole FL process (paper default).
``fixed``   constant base LR.
``cyclic``  cosine decay restarted within every layer-wise stage.

The paper scales linearly: lr = base_lr * batch_size / 256. The reference
computes the rate in float32; so does this module (numpy float32).
"""
from __future__ import annotations

import numpy as np


def scaled_base_lr(base_lr: float, batch_size: int) -> float:
    return base_lr * batch_size / 256.0


def learning_rate(step, total_steps: int, base_lr: float,
                  schedule: str = "cosine", *, stage_step=None,
                  stage_total: int = 0, warmup_steps: int = 0) -> float:
    f32 = np.float32
    step = f32(step)
    lr = f32(base_lr)
    if schedule == "fixed":
        out = lr
    elif schedule in ("cosine", "cyclic"):
        if schedule == "cosine":
            pos, span = step, total_steps
        else:
            pos = f32(step if stage_step is None else stage_step)
            span = stage_total or total_steps
        t = np.clip(pos / max(f32(1.0), f32(span)), f32(0.0), f32(1.0))
        out = lr * f32(0.5) * (f32(1.0) + np.cos(f32(np.pi) * t))
    else:
        raise ValueError(schedule)
    if warmup_steps:
        out = out * np.clip(step / f32(warmup_steps), f32(0.0), f32(1.0))
    return float(out)
