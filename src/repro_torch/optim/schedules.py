"""LR schedules — the port of ``repro.optim.schedules``: scalar functions
of the step counter, computed in float32 as the reference computes them,
returned as 0-d float32 tensors on the CPU (a 0-d CPU tensor enters a
product on the card as a number, with no copy)."""
from __future__ import annotations

import math

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def linear_warmup(step, warmup_steps: int):
    return torch.minimum(_f32(1.0), (_f32(step) + 1) / max(1, warmup_steps))


def cosine_schedule(step, total_steps: int, warmup_steps: int = 0,
                    final_frac: float = 0.1):
    warm = linear_warmup(step, warmup_steps)
    prog = torch.clamp((_f32(step) - warmup_steps)
                       / max(1, total_steps - warmup_steps), 0.0, 1.0)
    cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * cos
