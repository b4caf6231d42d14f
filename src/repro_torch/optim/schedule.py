"""LR schedules, pure functions of the step (``repro/optim/schedule.py``).

Each returns an fp32 0-d tensor on the step's device, so a schedule read
inside the train step never waits for the card."""
from __future__ import annotations

import math
from typing import Callable, Union

import torch

__all__ = ["warmup_cosine", "constant"]

Step = Union[int, torch.Tensor]


def constant(lr: float) -> Callable[[Step], torch.Tensor]:
    def f(step: Step) -> torch.Tensor:
        return torch.full((), lr, dtype=torch.float32,
                          device=torch.as_tensor(step).device)
    return f


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1) -> Callable[[Step], torch.Tensor]:
    """Linear warm-up to ``peak_lr``, then a cosine decay to
    ``final_frac * peak_lr`` at ``total_steps``."""
    def f(step: Step) -> torch.Tensor:
        step = torch.as_tensor(step).float()
        warm = peak_lr * step / max(1, warmup_steps)
        prog = torch.clamp((step - warmup_steps) /
                           max(1, total_steps - warmup_steps), 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac) * 0.5 *
                         (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)
    return f
