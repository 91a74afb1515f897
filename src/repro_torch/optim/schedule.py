"""LR schedules. Port of ``repro/optim/schedule.py``."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.ref import recip_f32


def cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                    final_frac: float = 0.1):
    """Linear warm-up to ``peak_lr``, then a cosine to ``final_frac`` of it
    at ``total_steps``: ``lr(step)`` takes an int step tensor and returns
    an f32 tensor on its device. The divisions by the step counts are
    products with their f32 reciprocals, as XLA compiles the reference
    under ``jit`` (its training loop jits the step)."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = peak_lr * step * recip_f32(max(warmup_steps, 1))
        prog = torch.clamp((step - warmup_steps)
                           * recip_f32(max(total_steps - warmup_steps, 1)),
                           0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac)
                         * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)
    return lr
