"""Second witnesses for a T2-form gate: what its step-1 per-leaf reading
and its per-step readings give for runs that are correct in exact
arithmetic but round differently, and for a run that is not (TF32).

    python scripts/t2_witness.py [--arch xlstm-1.3b] [--seeds 7 8 9]
        [--device cuda|cpu] [--runs cpu64 cpu32 ...]
        [--out t2_witness.json]

For each seed the gate's inputs (``chip_smoke.t2_inputs`` with that
seed) go through ``chip_smoke.t2_run``'s three steps in these runs, each
at 1 and 2 micro-batches unless named otherwise:

- ``cpu64``: float64 on the CPU, the gate's reference;
- ``cpu32``: fp32 on the CPU, the gate's yardstick;
- ``cpu32_swapped``: ``cpu32`` with the batch's two rows swapped (the
  loss is a mean over tokens, so only the order of the sums changes);
- ``card32``: the port on the card, as the gate runs it;
- ``card32_plain``: ``card32`` with the mLSTM forward through the plain
  scan instead of the kernel (xLSTM only);
- ``card32_tf32`` (one micro-batch): ``card32`` with TF32 matmuls
  allowed, a run that loses mantissa bits, as a control.

Every run but the reference is held in T2's form (``chip_smoke.t2_ratios``
at T2's own multiple, 2) against ``cpu64`` with ``cpu32`` as the
yardstick, and ``cpu32`` is held with each sound run as the yardstick.  Prints one JSON line per
(seed, micro-batches, run) with the largest per-leaf ratio, the leaves
above 1 by name, and the step ratios; ``--out`` gets every run's
per-leaf relative error (max|run - cpu64| over the leaf's largest
|cpu64| entry) and loss and grad norm per step, for a form to be held
against them offline.  ``--device cpu`` makes the CPU runs only, and
``--runs`` names the runs to make (``cpu64`` and ``cpu32`` always).
"""

import argparse
import contextlib
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


@contextlib.contextmanager
def plain_mlstm_forward():
    """The mLSTM forward through the plain scan on the card."""
    from repro_torch.kernels import mlstm_scan

    kernel = mlstm_scan.mlstm_scan_cuda
    mlstm_scan.mlstm_scan_cuda = mlstm_scan.mlstm_scan_plain
    try:
        yield
    finally:
        mlstm_scan.mlstm_scan_cuda = kernel


@contextlib.contextmanager
def tf32_matmuls(torch):
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


def swapped(batches):
    return [{k: v[::-1].copy() for k, v in b.items()} for b in batches]


def main(argv=None):
    import chip_smoke as cs

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-1.3b")
    ap.add_argument("--seeds", type=int, nargs="+", default=[7, 8, 9])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--runs", nargs="+", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    import repro_torch  # noqa: F401  (turns TF32 off)
    from repro_torch.tree import leaves

    if args.device == "cuda":
        cs.require(torch.cuda.is_available(), "no CUDA device")
    names = None
    record = {"arch": args.arch, "seeds": {}}
    for seed in args.seeds:
        cfg, base, batches = cs.t2_inputs(torch, args.arch, seed=seed)
        if names is None:
            names = [n for n, _ in cs.named_leaves(base.params)]
            assert len(names) == len(leaves(base.params))
        runs = {}  # (name, mb) -> t2_run's result
        plan = [("cpu64", 1, np.float64, "cpu", batches, None),
                ("cpu64", 2, np.float64, "cpu", batches, None)]
        for mb in (1, 2):
            plan += [("cpu32", mb, np.float32, "cpu", batches, None),
                     ("cpu32_swapped", mb, np.float32, "cpu",
                      swapped(batches), None)]
        if args.device == "cuda":
            for mb in (1, 2):
                plan.append(("card32", mb, np.float32, "cuda", batches,
                             None))
                if cfg.arch == "ssm":
                    plan.append(("card32_plain", mb, np.float32, "cuda",
                                 batches, plain_mlstm_forward()))
            plan.append(("card32_tf32", 1, np.float32, "cuda", batches,
                         tf32_matmuls(torch)))
        if args.runs:
            plan = [p for p in plan
                    if p[0] in {*args.runs, "cpu64", "cpu32"}]
        seconds = {}
        for name, mb, dtype, dev, data, ctx in plan:
            t0 = time.perf_counter()
            with ctx or contextlib.nullcontext():
                grads, hist, counts = cs.t2_run(torch, cfg, base, data, mb,
                                                dtype, dev)
            seconds[f"{name}/mb{mb}"] = time.perf_counter() - t0
            runs[(name, mb)] = ([torch.from_numpy(g) for g in grads], hist,
                                counts)
        rec = record["seeds"][str(seed)] = {"seconds": seconds, "runs": {}}
        for (name, mb), run in runs.items():
            ref = runs[("cpu64", mb)]
            rel = []
            for a, c in zip(run[0], ref[0]):
                scale = c.abs().max().item()
                rel.append((a - c).abs().max().item() / scale if scale
                           else (math.inf if bool(a.ne(0).any()) else 0.0))
            rec["runs"][f"{name}/mb{mb}"] = {
                "leaf_rel_err": rel, "loss_grad_norm": run[1],
                "launches": {k: v for k, v in run[2].items() if v}}
            if name == "cpu64":
                continue
            pairs = [(name, "cpu32")]
            if name != "cpu32" and not name.endswith("tf32"):
                pairs.append(("cpu32", name))
            for subject, yard in pairs:
                if subject == yard:
                    continue
                grad_ratio, step_ratio = cs.t2_ratios(
                    runs[(subject, mb)], runs[(yard, mb)], ref)
                over = [(names[i], r) for i, r in enumerate(grad_ratio)
                        if r > 1]
                print(json.dumps({
                    "arch": args.arch, "seed": seed, "mb": mb,
                    "run": subject, "yardstick": yard,
                    "grad_leaf_ratio_max": max(grad_ratio),
                    "grad_leaves_over_1": len(over),
                    "over_1": sorted(over, key=lambda x: -x[1])[:8],
                    "step_ratio": step_ratio}), flush=True)
    record["leaf_names"] = names
    if torch.cuda.is_available():
        record["nvidia_smi"] = cs.nvidia_smi()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(record))


if __name__ == "__main__":
    main()
