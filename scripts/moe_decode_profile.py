#!/usr/bin/env python3
"""Profile qwen2-moe-a2.7b's fused decode step at full width on one GPU.

    python3 scripts/moe_decode_profile.py [--src DIR] [--steps N]

Serves the model at full width and depth in fp32 with seeded random
weights, admits ``chip_smoke.SERVE_PROMPTS`` (8 sessions), and prints
``chip_smoke.profile_decode``'s ``decode_profile`` line: wall and device
busy ms per step, the idle share, the largest device items, and the router
product's and the gating's device ms per step.  Then the card's
``nvidia-smi`` name and power limit.

``--src`` is the ``src`` directory of the port to load (default: this
checkout's).  Pointing it at an unpacked older tree measures that tree
with the same profiling code, so two trees can be compared on one card in
one call.  Needs a card; without one it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the port's src directory to load")
    ap.add_argument("--steps", type=int, default=4,
                    help="decode steps in each profiled window")
    args = ap.parse_args(argv)
    src = Path(args.src).resolve()
    if not (src / "repro_torch" / "__init__.py").is_file():
        print(f"moe_decode_profile: no repro_torch under {src}",
              file=sys.stderr)
        return 2
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("moe_decode_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(src))
    import chip_smoke
    import repro_torch  # noqa: F401  (turns TF32 off)
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import decoder
    from repro_torch.serving import ShardModule

    if not Path(repro_torch.__file__).resolve().is_relative_to(src):
        print(f"moe_decode_profile: loaded {repro_torch.__file__}, not the "
              f"tree under {src}", file=sys.stderr)
        return 2
    print(json.dumps({"phase": "moe_decode_profile_source", "src": str(src)}),
          flush=True)
    build.build()
    cfg = get_config("qwen2-moe-a2.7b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = decoder.init_params(cfg, gen, "cuda")
    module = ShardModule(cfg, params, (0, cfg.n_layers), is_first=True,
                         is_last=True)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, (1, n), dtype=np.int32)
               for n in chip_smoke.SERVE_PROMPTS]
    feed = [rng.integers(0, cfg.vocab, (len(prompts),), dtype=np.int32)
            for _ in range(2 * args.steps + 1)]
    chip_smoke.profile_decode(torch, module, prompts, feed, args.steps)
    print(chip_smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
