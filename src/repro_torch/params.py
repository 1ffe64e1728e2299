"""Weight bridge between the JAX package's parameter tree and the port's.

The JAX package's tree, flattened to numpy (nested dicts of arrays, with
non-ssm ``blocks`` stacked on a leading layer axis), has exactly the
port's keys, shapes and ``(in, out)`` layout, so crossing over is a copy.
Values are bit-exact both ways, and each leaf keeps its dtype (a bfloat16
hymba tree keeps its float32 Mamba ``A_log`` and ``D_skip``).  bfloat16
arrays (``ml_dtypes``) cross as their raw 16-bit patterns.  A train state (parameters, AdamW moments
and step) crosses the same way.
"""

from __future__ import annotations

from typing import Any, Union

import numpy as np
import torch

from .core.device import resolve_device
from .optim.adamw import AdamWState
from .tree import leaves, tree_map
from .train.step import TrainState


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
    return tree_map(lambda a: _to_tensor(np.asarray(a), dev), tree)


def params_to_numpy(tree: Any) -> Any:
    """The inverse of :func:`params_from_numpy` (host copies)."""
    return tree_map(_to_numpy, tree)


def train_state_from_numpy(state: Any,
                           device: Union[str, torch.device] = "cuda") -> Any:
    """A train state with numpy leaves (the JAX package's ``TrainState``
    mapped through ``np.asarray``: ``params`` and ``opt.step``, ``opt.mu``,
    ``opt.nu``) -> the port's ``TrainState`` on ``device``, bit-exact, its
    parameters marked as requiring grad."""
    params = params_from_numpy(state.params, device)
    for p in leaves(params):
        p.requires_grad_(True)
    opt = AdamWState(step=int(np.asarray(state.opt.step)),
                     mu=params_from_numpy(state.opt.mu, device),
                     nu=params_from_numpy(state.opt.nu, device))
    return TrainState(params=params, opt=opt)


def train_state_to_numpy(state: Any) -> Any:
    """The inverse of :func:`train_state_from_numpy`: a ``TrainState`` of
    host copies, its step an ``np.int32`` as JAX's."""
    opt = AdamWState(step=np.int32(state.opt.step),
                     mu=params_to_numpy(state.opt.mu),
                     nu=params_to_numpy(state.opt.nu))
    return TrainState(params=params_to_numpy(state.params), opt=opt)
