"""Gradient clipping by the global norm."""

from __future__ import annotations

from typing import Any, Tuple

import torch

from ..tree import leaves


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares (float32,
    float64 for float64 leaves), a 0-d tensor on the leaves' device."""
    total = 0
    for g in leaves(tree):
        g = g.to(torch.promote_types(g.dtype, torch.float32))
        total = total + torch.sum(torch.square(g))
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    """Scale every leaf in place by min(1, max_norm / max(norm, 1e-9)).
    Returns (grads, the norm before clipping).  No host sync."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)
    for g in leaves(grads):
        g.mul_(scale.to(g.dtype))
    return grads, norm
