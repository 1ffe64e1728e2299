"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \\
        --steps 4 --batch 1 --seq 2048

Runs on the card (``--device cuda``, the default) with the full config;
``--reduced`` trains the smoke-test width (``--layers``, ``--d-model``,
``--vocab``) instead, and ``--device cpu`` runs the plain versions on the
CPU.  Without a card and without ``--device cpu`` it raises.  The port
trains dense configs (minicpm-2b, granite-8b, ...) and MoE configs
(qwen2-moe-a2.7b, dbrx-132b).  ``--save PATH``
writes the trained parameters as a checkpoint in the JAX package's format
(``repro_torch.checkpoint.save_local``), which either package can load.
"""

from __future__ import annotations

import argparse
import time
from typing import TYPE_CHECKING, Callable, Dict, List, Optional

import torch

if TYPE_CHECKING:
    from repro_torch.train import Trainer


def main(argv: Optional[List[str]] = None) -> List[Dict[str, float]]:
    """Train from the command line; returns the per-step history."""
    return run(argv).history


def make_schedule(name: str, lr: float, steps: int) -> Callable[[int], float]:
    """The launcher's lr schedule over ``steps``: ``cosine`` (a tenth
    warmup) or ``wsd`` (a tenth warmup, 70% stable, 20% decay)."""
    from repro_torch.optim import cosine_schedule, wsd_schedule

    if name == "wsd":
        return wsd_schedule(lr, steps // 10, 7 * steps // 10, 2 * steps // 10)
    return cosine_schedule(lr, steps // 10, steps)


def run(argv: Optional[List[str]] = None) -> "Trainer":
    """What :func:`main` runs; returns the trainer, its state trained."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced (smoke) variant")
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--vocab", type=int, default=2048)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--schedule", choices=["cosine", "wsd"], default="cosine")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--save", default=None, help="checkpoint path")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.core.device import resolve_device
    from repro_torch.data import make_batch_iterator
    from repro_torch.tree import leaves
    from repro_torch.train import Trainer, train_state_init

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(n_layers=args.layers, d_model=args.d_model,
                          vocab=args.vocab)
    sched = make_schedule(args.schedule, args.lr, args.steps)
    data = make_batch_iterator(cfg.vocab, args.seq, args.batch,
                               seed=args.seed)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = train_state_init(cfg, gen, device)
    n_params = sum(p.numel() for p in leaves(state.params))
    print(f"[train] arch={cfg.name} family={cfg.arch} "
          f"params={n_params / 1e6:.1f}M device={device}")
    trainer = Trainer(cfg, state, sched, data, microbatches=args.microbatches)
    t0 = time.perf_counter()
    hist = trainer.run(args.steps, log_every=max(args.steps // 20, 1))
    dt = time.perf_counter() - t0
    toks = args.steps * args.batch * args.seq
    print(f"[train] {args.steps} steps in {dt:.1f}s "
          f"({toks / dt:.0f} tok/s) loss {hist[0]['loss']:.3f} -> "
          f"{hist[-1]['loss']:.3f}")
    if args.save:
        from repro_torch.checkpoint import save_local
        n = save_local(args.save, trainer.state.params)
        print(f"[train] saved {n/1e6:.1f} MB checkpoint to {args.save}")
    return trainer


if __name__ == "__main__":
    main()
