"""LR schedules, evaluated on the host in fp32 as the reference evaluates
them on device (``repro/optim/schedules.py``)."""
from __future__ import annotations

import numpy as np

f32 = np.float32


def cosine_warmup(step, base_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1) -> np.float32:
    """Linear warmup then cosine decay to final_frac*base_lr."""
    step = f32(step)
    if step < warmup_steps:
        return f32(base_lr) * step / f32(max(warmup_steps, 1))
    prog = np.clip((step - f32(warmup_steps))
                   / f32(max(total_steps - warmup_steps, 1)), f32(0), f32(1))
    return f32(final_frac * base_lr) + f32(
        (1 - final_frac) * base_lr * 0.5) * (f32(1) + np.cos(f32(np.pi) * prog))


def constant(step, base_lr: float, **_) -> np.float32:
    return f32(base_lr)
