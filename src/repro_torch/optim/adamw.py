"""AdamW over the port's parameter trees, updated in place.

The arithmetic is the JAX package's ``adamw_update`` in its order of
operations (b1 0.9, b2 0.95, eps 1e-8, decay on every leaf, bias
corrections in float32 from the incremented step).  JAX returns new trees;
here parameters and moments are updated in place under
``torch.no_grad()``, which keeps one copy of each on the card instead of
two.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..tree import leaves, tree_map


@dataclass
class AdamWState:
    step: int     # updates taken so far
    mu: Any       # first moment, like params
    nu: Any       # second moment, like params


def adamw_init(params: Any) -> AdamWState:
    """Zero moments: float32 for float32 (or narrower) leaves, as in JAX,
    and float64 for float64 leaves."""
    def zeros(p: torch.Tensor) -> torch.Tensor:
        return torch.zeros(p.shape, device=p.device,
                           dtype=torch.promote_types(p.dtype, torch.float32))
    return AdamWState(step=0, mu=tree_map(zeros, params),
                      nu=tree_map(zeros, params))


def _bias_correction(b: float, t: int) -> float:
    """1 - b**t in float32, as JAX computes it from the float32 step."""
    return float(np.float32(1.0) - np.power(np.float32(b), np.float32(t)))


@torch.no_grad()
def adamw_update(params: Any, grads: Any, state: AdamWState, lr: float, *,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1) -> AdamWState:
    """One step: params, ``state.mu`` and ``state.nu`` change in place.
    Returns the state with the incremented step."""
    step = state.step + 1
    c1, c2 = _bias_correction(b1, step), _bias_correction(b2, step)
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state.mu),
                          leaves(state.nu)):
        g = g.to(m.dtype)
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_(torch.square(g) * (1 - b2))
        # delta = (m / c1) / (sqrt(v / c2) + eps) + wd * p
        delta = torch.div(m, c1)
        delta.div_(torch.div(v, c2).sqrt_().add_(eps))
        delta.add_(p.to(m.dtype) * weight_decay)
        p.sub_(delta.mul_(lr))
    return AdamWState(step=step, mu=state.mu, nu=state.nu)
