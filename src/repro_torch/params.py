"""Weight bridge between the JAX package's parameter tree and the port's.

The JAX package's tree, flattened to numpy (nested dicts of arrays, with
non-ssm ``blocks`` stacked on a leading layer axis), has exactly the
port's keys, shapes and ``(in, out)`` layout, so crossing over is a copy.
Values are bit-exact both ways.  bfloat16 arrays (``ml_dtypes``) cross
as their raw 16-bit patterns.
"""

from __future__ import annotations

from typing import Any, Union

import numpy as np
import torch

from .core.device import resolve_device


def _to_tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.array(a, order="C")                  # a private, writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes            # numpy's bf16 type, as the JAX package uses
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16).copy()
    return t.numpy().copy()


def params_from_numpy(tree: Any, device: Union[str, torch.device] = "cuda") -> Any:
    """Nested dicts/lists of numpy arrays -> the same structure of tensors
    on ``device``."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, dev) for v in tree)
    return _to_tensor(np.asarray(tree), dev)


def params_to_numpy(tree: Any) -> Any:
    """The inverse of :func:`params_from_numpy` (host copies)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_to_numpy(v) for v in tree)
    return _to_numpy(tree)
