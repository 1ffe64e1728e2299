"""Train step: loss -> grads -> clip -> AdamW, the JAX package's
``train/step.py`` on PyTorch autograd.

The step takes numpy (or tensor) batches and moves them to the device of
the parameters.  Gradients come from ``torch.autograd.grad`` on the
layer-stacked leaves, so they come out stacked, as JAX's do; under
micro-batching each slice's gradient is divided by the slice count and
summed in float32, in slice order.  The lr is read from the schedule at
the step count before the update, as in JAX.  Parameters and moments are
updated in place (see :mod:`..optim.adamw`).

The port trains every arch the JAX package trains: the dense, MoE,
xLSTM (``ssm``), hybrid and vlm decoders and the encoder-decoder (audio).
A leaf the loss never reaches gets a zero gradient, as JAX's
``value_and_grad`` gives it (each xLSTM layer holds an ``mlstm`` and an
``slstm`` tree and runs one), so AdamW still decays it.  An
MoE config keeps the capacity-factor token drops, as the JAX package's
training does, and its gating differentiates through
``models.moe.RouterGating`` (the router kernel forward, the gating
backward kernel backward).  Attention of 2048 tokens or more, windowed
or not, differentiates through ``models.chunked.FlashAttention``; a
hybrid's Mamba recomputes each chunk in the backward; a vlm batch's
``vision_embeds`` (B, n_patches, D) and ``positions3`` (3, B, S) and an
audio batch's ``frames`` (B, enc_seq, d_source) are inputs, split on
their batch axis under micro-batching.  The chunkwise mLSTM
differentiates through ``models.ssm.MLSTMScan`` (the mLSTM kernel
forward, each chunk recomputed in the backward).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Tuple, Union

import numpy as np
import torch

from ..core.device import resolve_device
from ..models import ops_for
from ..models.config import ModelConfig
from ..optim import AdamWState, adamw_init, adamw_update, clip_by_global_norm
from ..tree import leaves, unflatten

Batch = Dict[str, Union[np.ndarray, torch.Tensor]]


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState


def train_state_init(cfg: ModelConfig, generator: torch.Generator,
                     device: Union[str, torch.device] = "cuda",
                     dtype: torch.dtype = torch.float32) -> TrainState:
    """Random parameters from ``generator`` (which lives on ``device``),
    marked as requiring grad, and zero AdamW moments."""
    params = ops_for(cfg).init(cfg, generator, resolve_device(device), dtype)
    for p in leaves(params):
        p.requires_grad_(True)
    return TrainState(params=params, opt=adamw_init(params))


def _micro_split(batch: Dict[str, torch.Tensor], k: int
                 ) -> Dict[str, torch.Tensor]:
    """Reshape each leaf's batch dim B -> (k, B/k) for micro-batching."""
    out = {}
    for name, v in batch.items():
        if name == "positions3":                    # (3, B, S)
            b = v.shape[1]
            out[name] = v.reshape(3, k, b // k, *v.shape[2:]).swapaxes(0, 1)
        else:
            b = v.shape[0]
            out[name] = v.reshape(k, b // k, *v.shape[1:])
    return out


def _grad(loss: torch.Tensor, flat: List[torch.Tensor]
          ) -> Tuple[torch.Tensor, ...]:
    """d loss / d each leaf, zeros for a leaf the loss does not reach."""
    return torch.autograd.grad(loss, flat, allow_unused=True,
                               materialize_grads=True)


def make_train_step(cfg: ModelConfig, schedule: Callable[[int], float],
                    max_grad_norm: float = 1.0, weight_decay: float = 0.1,
                    microbatches: int = 1) -> Callable:
    """Returns ``step(state, batch) -> (state, metrics)``; the state's
    tensors are updated in place.  ``step.grads_of(params, batch)`` is the
    step's first half: (loss, metrics, grads) with grads shaped like
    params, before clipping; ``step.update(state, loss, metrics, grads)``
    its second: clip, the lr, AdamW."""
    ops = ops_for(cfg)

    def grads_of(params: Any, batch: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Any]:
        flat = leaves(params)
        if microbatches == 1:
            loss, metrics = ops.loss_fn(params, cfg, batch)
            grads = list(_grad(loss, flat))
            return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                    unflatten(params, grads))
        micro = _micro_split(batch, microbatches)
        grads = [torch.zeros(p.shape, device=p.device,
                             dtype=torch.promote_types(p.dtype, torch.float32))
                 for p in flat]
        losses: List[torch.Tensor] = []
        ms: List[Dict[str, torch.Tensor]] = []
        for i in range(microbatches):
            loss, metrics = ops.loss_fn(params, cfg,
                                        {k: v[i] for k, v in micro.items()})
            for acc, g in zip(grads, _grad(loss, flat)):
                acc.add_(g.to(acc.dtype) / microbatches)
            losses.append(loss.detach())
            ms.append({k: v.detach() for k, v in metrics.items()})
        metrics = {k: torch.stack([m[k] for m in ms]).float().mean()
                   for k in ms[0]}
        return (torch.stack(losses).mean(), metrics,
                unflatten(params, grads))

    def update(state: TrainState, loss: torch.Tensor,
               metrics: Dict[str, torch.Tensor], grads: Any
               ) -> Tuple[TrainState, Dict[str, Any]]:
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        lr = schedule(state.opt.step)
        opt = adamw_update(state.params, grads, state.opt, lr,
                           weight_decay=weight_decay)
        out: Dict[str, Any] = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        out.update(metrics)
        return TrainState(state.params, opt), out

    def step(state: TrainState, batch: Batch
             ) -> Tuple[TrainState, Dict[str, Any]]:
        dev = leaves(state.params)[0].device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        return update(state, *grads_of(state.params, batch))

    step.grads_of = grads_of
    step.update = update
    return step
