"""Mixture-of-Experts layer: top-k token-choice routing with capacity.

The JAX package's dispatch/combine formulation (Shazeer et al.): tokens
pick their top-k experts, each expert takes at most C tokens per group,
overflow is dropped (the residual passes through), and the experts run as
one batched SwiGLU over ``(G, E, C, D)`` buffers.

Differences from the JAX package:

* The router product and the gating always go through
  :func:`repro_torch.kernels.ops.router_gating` (one CUDA kernel on the
  card, its plain version on the CPU), so there is no ``use_kernel``
  argument: it computes the JAX ``xt @ router`` then ``topk_gating``, ties
  to the lower expert index included.
* Under autograd the gating is :class:`RouterGating`, the twin of
  ``models/chunked.py``'s ``FlashAttention``: the router kernel forward and
  the gating backward kernel (``csrc/moe_gating_bwd.cu``) backward, where
  the JAX package differentiates ``topk_gating`` with XLA.
* The dispatch copies each token to its K rows by a broadcast, and the
  combine gathers each kept (token, k) slot and sums over k, instead of
  indexing and scatter-adding by token: a float ``index_add_`` on the card
  (and an indexed read's backward) uses atomics, whose rounding changes
  from run to run.  Both backward passes are then sums in a fixed order,
  and a kept slot's gather receives one gradient.
* The JAX package's sharding constraints on the dispatch buffers
  (``_constrain_groups``) have no counterpart on one device.
* :func:`run_moe` returns the gating, not the Switch aux loss; callers
  that want the loss take it from :func:`switch_aux`.  Eager PyTorch does
  not drop dead ops as ``jit`` does, so the serving path, which discards
  the loss, never computes it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import moe_gating as _gating
from ..kernels import ops
from ..kernels.ops import _route
from .common import Params, dense_init, init_mlp, run_mlp
from .config import ModelConfig


class RouterGating(torch.autograd.Function):
    """``RouterGating.apply(x, router, k)``: x (T, D), router (D, E) ->
    (weights (T,k), experts (T,k) int32, probs (T,E)), the values of
    ``ops.router_gating`` without grad, bit for bit.  The forward saves
    (x, router, weights, experts, probs); the backward is the gating's VJP
    (``router_gating_bwd_cuda`` on the card, ``router_gating_bwd_plain`` on
    the CPU).  ``experts`` is not differentiable."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, router: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        fwd = (_gating.router_gating_cuda if _route(x)
               else _gating.router_gating_plain)
        weights, experts, probs = fwd(x, router, k)
        ctx.save_for_backward(x, router, weights, experts, probs)
        ctx.mark_non_differentiable(experts)
        return weights, experts, probs

    @staticmethod
    def backward(ctx, dweights: torch.Tensor, _dexperts: Optional[torch.Tensor],
                 dprobs: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, None]:
        x, router, weights, experts, probs = ctx.saved_tensors
        bwd = (_gating.router_gating_bwd_cuda if _route(x)
               else _gating.router_gating_bwd_plain)
        dx, drouter = bwd(x, router, weights, experts, probs,
                          dweights.contiguous(), dprobs.contiguous())
        return dx, drouter, None


def init_moe(cfg: ModelConfig, generator: torch.Generator,
             device: torch.device, dtype: torch.dtype,
             n_layers: int) -> Params:
    """MoE weights stacked on a leading layer axis, with the JAX package's
    scales: the router (D, E) fp32 at 0.02, experts at ``1/sqrt(E)`` (its
    ``dense_init`` takes the fan-in from the first dim of (E, D, F))."""
    L, E, D, Fe = n_layers, cfg.n_experts, cfg.d_model, cfg.d_exp
    p: Params = {
        "router": dense_init(generator, (L, D, E), device, torch.float32,
                             scale=0.02),
        "w_gate": dense_init(generator, (L, E, D, Fe), device, dtype, fan_in=E),
        "w_up": dense_init(generator, (L, E, D, Fe), device, dtype, fan_in=E),
        "w_down": dense_init(generator, (L, E, Fe, D), device, dtype, fan_in=E),
    }
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(generator, D, cfg.n_shared_experts * Fe,
                               device, dtype, L)
    return p


def capacity(cfg: ModelConfig, Tg: int, no_drop: bool) -> int:
    """Tokens each expert takes per group of ``Tg`` tokens."""
    E, K = cfg.n_experts, cfg.moe_top_k
    if no_drop:
        # serving: the worst case exactly for small token counts (decode),
        # a 2x load-imbalance margin for large ones (prefill)
        if Tg <= 512:
            return Tg
        return min(int(2 * K * Tg / E) + 1, Tg)
    return min(int(max(K * Tg * cfg.capacity_factor / E, K)), Tg)


def run_moe(p: Params, cfg: ModelConfig, x: torch.Tensor,
            no_drop: bool = False,
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y, probs (T, E), experts (T, K)).

    ``no_drop=True`` (decode/serving): capacity covers the worst case, so
    no token is dropped mid-generation.  Training keeps the
    capacity-factor drop semantics.
    """
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.moe_top_k
    T = B * S
    xt = x.reshape(T, D)
    weights, experts, probs = ops.router_gating(
        xt.to(torch.promote_types(xt.dtype, torch.float32)).contiguous(),
        p["router"], K)

    G = cfg.moe_groups if cfg.moe_groups > 1 and T % cfg.moe_groups == 0 else 1
    Tg = T // G
    C = capacity(cfg, Tg, no_drop)
    dev = x.device

    # dispatch: each (token, k) takes the next free slot of its expert,
    # in token order; past the capacity it is dropped
    flat_exp = experts.reshape(G, Tg * K).long()
    onehot = F.one_hot(flat_exp, E)                          # (G, TgK, E)
    pos = torch.cumsum(onehot, dim=1) * onehot - 1
    pos_in_exp = pos.gather(2, flat_exp[..., None])[..., 0]  # (G, TgK)
    keep = pos_in_exp < C
    slot = flat_exp * C + torch.where(keep, pos_in_exp, 0)
    flat_w = weights.reshape(G, Tg * K) * keep
    # row t * K + k is token t: a broadcast, whose backward sums over k
    rows = x.reshape(G, Tg, 1, D).expand(G, Tg, K, D).reshape(G, Tg * K, D)
    contrib = torch.where(keep[..., None], rows, 0)
    # kept slots are distinct; dropped rows go to a spare last row, so the
    # writes need no accumulation
    dst = torch.where(keep, slot, E * C)
    buf = torch.zeros((G, E * C + 1, D), dtype=x.dtype, device=dev)
    buf.scatter_(1, dst[..., None].expand(-1, -1, D), contrib)
    eb = buf[:, :E * C].reshape(G, E, C, D)

    # expert SwiGLU, batched over experts (a plain product, as the JAX
    # package leaves it to XLA)
    h = F.silu(torch.einsum("gecd,edf->gecf", eb, p["w_gate"]))
    h = h * torch.einsum("gecd,edf->gecf", eb, p["w_up"])
    eo = torch.einsum("gecf,efd->gecd", h, p["w_down"]).reshape(G, E * C, D)

    # combine: gather each (token, k) slot, weight it, sum over k
    gathered = eo.gather(1, slot[..., None].expand(-1, -1, D))
    gathered = torch.where(keep[..., None],
                           gathered * flat_w[..., None].to(x.dtype), 0)
    y = gathered.reshape(G, Tg, K, D).sum(dim=2).reshape(T, D)

    if "shared" in p:
        y = y + run_mlp(p["shared"], xt)
    return y.reshape(B, S, D), probs, experts


def switch_aux(cfg: ModelConfig, probs: torch.Tensor,
               experts: torch.Tensor) -> torch.Tensor:
    """The Switch-style load-balance loss of one layer's gating, as the
    JAX ``run_moe`` returns it."""
    E = cfg.n_experts
    me = probs.mean(dim=0)
    ce = F.one_hot(experts[:, 0].long(), E).float().mean(dim=0)
    return torch.sum(me * ce) * E * cfg.router_aux_weight
