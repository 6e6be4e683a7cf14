"""Learning-rate / DDA step-size schedules, the port of `repro.optim.lr`.
All return f(step) -> lr with `step` a 0-d int32 tensor (1-indexed); the
lr is a float32 0-d tensor on the step's device, computed in float32 as
the reference computes it."""

from __future__ import annotations

import math

import torch


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def constant_lr(lr: float):
    return lambda t: torch.tensor(lr, dtype=torch.float32, device=t.device)


def rsqrt_lr(A: float, q: float = 0.5):
    """The paper's a(t) = A / t^q (q=1/2 default, eq. 7; general q for the
    increasingly-sparse regime, section IV.B)."""
    return lambda t: A / torch.clamp(_f32(t), min=1.0) ** q


def cosine_lr(peak: float, total_steps: int, floor: float = 0.0):
    def f(t):
        frac = torch.clamp(_f32(t) / total_steps, 0.0, 1.0)
        return floor + 0.5 * (peak - floor) * (1.0 + torch.cos(math.pi * frac))
    return f


def warmup_cosine(peak: float, warmup: int, total_steps: int,
                  floor: float = 0.0):
    def f(t):
        t = _f32(t)
        warm = peak * t / max(warmup, 1)
        frac = torch.clamp((t - warmup) / max(total_steps - warmup, 1),
                           0.0, 1.0)
        cos = floor + 0.5 * (peak - floor) * (1.0 + torch.cos(math.pi * frac))
        return torch.where(t < warmup, warm, cos)
    return f
