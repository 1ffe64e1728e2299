"""Serving launcher: batched generation with the KV-cache decode path.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \\
        --batch 4 --prompt-len 64 --gen 32

``--arch`` takes any config: the dense ones (granite-8b, ...), the MoE
ones (qwen2-moe-a2.7b, dbrx-132b), xlstm-1.3b, hymba-1.5b (its k/v a
ring buffer of the 2048-token window once prompt and continuation reach
it), qwen2-vl-7b (``n_patches`` stubbed patch embeddings ~ N(0, 1) before
the prompt, positions on all three M-RoPE streams) and whisper-small
(stubbed frame embeddings ~ N(0, 1) of (batch, enc_seq, d_source)), the
stubs drawn from the ``--seed`` generator after the prompt, as the JAX
launcher adds them.

Runs on the card (``--device cuda``, the default) with the full config;
``--reduced`` serves the smoke-test width instead, and ``--device cpu``
runs the plain versions on the CPU.  Without a card and without
``--device cpu`` it raises.  ``--load PATH`` serves a checkpoint in the
JAX package's format (from either package's ``save_local``), loaded into
the tree of a fresh init on the chosen device.
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch


def main(argv: Optional[List[str]] = None) -> np.ndarray:
    """Serve from the command line; returns the generated tokens (B,
    gen)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--load", default=None, help="checkpoint to serve")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.core.device import resolve_device
    from repro_torch.models import ops_for
    from repro_torch.serving import GenerationEngine

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    ops = ops_for(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = ops.init(cfg, gen, device)
    if args.load:
        from repro_torch.checkpoint import load_local
        params = load_local(args.load, like=params)

    B, S = args.batch, args.prompt_len
    rng = np.random.default_rng(args.seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, size=(B, S), dtype=np.int32)}
    if cfg.arch == "vlm":
        batch["vision_embeds"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model), dtype=np.float32)
        batch["positions3"] = np.broadcast_to(
            np.arange(S + cfg.n_patches, dtype=np.int32),
            (3, B, S + cfg.n_patches)).copy()
    if cfg.arch == "audio":
        batch["frames"] = rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_source), dtype=np.float32)
    eng = GenerationEngine(cfg, params,
                           max_len=S + args.gen + cfg.n_patches + 1,
                           device=device)
    t0 = time.perf_counter()
    out, stats = eng.generate(batch, args.gen, temperature=args.temperature,
                              seed=args.seed)
    dt = time.perf_counter() - t0
    print(f"[serve] arch={cfg.name} device={device} batch={B} prompt={S} "
          f"generated={args.gen}")
    print(f"[serve] {stats['generated']} tokens in {dt:.2f}s "
          f"({stats['generated'] / dt:.1f} tok/s incl. prefill)")
    print(f"[serve] sample continuation: {out[0][:16].tolist()}")
    return out


if __name__ == "__main__":
    main()
