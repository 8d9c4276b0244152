"""Learning-rate schedules (a port of the reference's
``repro/optim/schedule.py``): linear warmup then cosine decay, and a
constant. Pure functions of the step, in f32 as the reference computes
them (the Python constants fold first, as there)."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step: torch.Tensor, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, min_ratio: float = 0.1) -> torch.Tensor:
    """f32 learning rate at ``step`` (an int tensor): linear from 0 to
    ``peak_lr`` over ``warmup_steps``, then a cosine down to
    ``min_ratio * peak_lr`` at ``total_steps`` (held after)."""
    s = step.float()
    warm = s / max(warmup_steps, 1)
    prog = ((s - warmup_steps) / max(total_steps - warmup_steps, 1)
            ).clamp(0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return peak_lr * torch.where(s < warmup_steps, warm, cos)


def constant(step: torch.Tensor, *, peak_lr: float, **_) -> torch.Tensor:
    return torch.full_like(step, peak_lr, dtype=torch.float32)
