"""Learning-rate schedules, step -> lr.  The JAX package's formulas, in
float32 on 0-d CPU tensors, so every value (the transcendentals included)
is the one JAX computes.  WSD (warmup-stable-decay) is MiniCPM's schedule
[arXiv:2404.06395]."""

from __future__ import annotations

import math
from typing import Callable

import torch


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def constant_schedule(lr: float) -> Callable[[int], float]:
    return lambda step: float(_f32(lr))


def cosine_schedule(lr: float, warmup: int, total: int,
                    final_frac: float = 0.1) -> Callable[[int], float]:
    def fn(step: int) -> float:
        step = _f32(step)
        warm = lr * step / max(warmup, 1)
        prog = torch.clip((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = final_frac * lr + (1 - final_frac) * lr * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return float(torch.where(step < warmup, warm, cos))
    return fn


def wsd_schedule(lr: float, warmup: int, stable: int, decay: int,
                 final_frac: float = 0.01) -> Callable[[int], float]:
    """Warmup -> Stable (constant) -> Decay (exponential-ish linear-log).

    MiniCPM decays to ``final_frac``·lr over the last ``decay`` steps.
    """
    def fn(step: int) -> float:
        step = _f32(step)
        warm = lr * step / max(warmup, 1)
        in_decay = torch.clip((step - warmup - stable) / max(decay, 1),
                              0.0, 1.0)
        dec = lr * torch.exp(torch.log(_f32(final_frac)) * in_decay)
        out = torch.where(step < warmup, warm,
                          torch.where(step < warmup + stable, _f32(lr), dec))
        return float(out)
    return fn
