"""Seconds a T2-form gate's CPU references take: one step of
``chip_smoke.t2_run`` for each of gates T2h, T2v and T2a (their reduced
configs, B=2, S=2048) in float32 and in float64 on this machine's CPU,
one micro-batch.

    python scripts/t2_cpu_cost.py [--arch hymba-1.5b ...] [--threads N]

Prints one JSON line per (arch, dtype).  The smoke runs three steps of
each at 1 and 2 micro-batches, so its CPU work for a gate is about six
times the sum of one arch's two lines.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main(argv=None):
    import chip_smoke

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+", default=list(chip_smoke.T2_ARCHS))
    ap.add_argument("--threads", type=int, default=None)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if args.threads:
        torch.set_num_threads(args.threads)
    for arch in args.arch:
        cfg, base, batches = chip_smoke.t2_inputs(torch, arch)
        for dtype in (np.float32, np.float64):
            t0 = time.perf_counter()
            chip_smoke.t2_run(torch, cfg, base, batches[:1], 1, dtype, "cpu")
            print(json.dumps({"arch": arch, "dtype": np.dtype(dtype).name,
                              "threads": torch.get_num_threads(),
                              "step_s": time.perf_counter() - t0}),
                  flush=True)


if __name__ == "__main__":
    main()
