"""The first steps of xlstm-1.3b at full width under the training
launcher's schedule, in fp32 and in float64, with the mLSTM forward
through the kernel or through the plain scan: whether a run whose loss
or grad norm leaves the finite numbers does so in float64 too (the
model's own arithmetic at that lr) or only in fp32.

    python scripts/xlstm_lr_probe.py [--device cuda] [--layers 8]
        [--vocab 0] [--seq 2048] [--steps 4] [--lr 3e-3 ...]
        [--dtype float32 float64] [--plain]

``--layers`` cuts the depth, ``--vocab`` the vocabulary (0 keeps the
config's); the width is always the config's.  Weights come from
``train_state_init`` with seed 0 and batches from ``make_batch_iterator``
with seed 0, as ``launch.train`` draws them, and each lr runs the
launcher's cosine schedule over ``--steps``.  Prints one JSON line per
(lr, dtype, route): each step's loss and grad norm, and at the first
step with a non-finite gradient the leaves that hold one.
"""

import argparse
import contextlib
import dataclasses
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "scripts"))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--vocab", type=int, default=0)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--lr", type=float, nargs="+", default=[3e-3])
    ap.add_argument("--dtype", nargs="+", default=["float32", "float64"])
    ap.add_argument("--plain", action="store_true",
                    help="also run the mLSTM forward through the plain scan")
    args = ap.parse_args(argv)

    import torch

    import repro_torch  # noqa: F401  (turns TF32 off)
    from repro_torch.configs import get_config
    from repro_torch.data import make_batch_iterator
    from repro_torch.kernels import ops
    from repro_torch.launch.train import make_schedule
    from repro_torch.train import make_train_step, train_state_init
    from t2_witness import plain_mlstm_forward

    import chip_smoke

    cfg = get_config("xlstm-1.3b")
    cfg = dataclasses.replace(cfg, n_layers=args.layers,
                              vocab=args.vocab or cfg.vocab)
    routes = ["kernel", "plain"] if args.plain else ["kernel"]
    if args.device == "cpu":
        routes = ["plain"]
    for lr in args.lr:
        for dt in args.dtype:
            for route in routes:
                if route == "kernel" and dt != "float32":
                    continue  # the kernel is fp32: float64 runs the plain scan
                ctx = (plain_mlstm_forward() if route == "plain"
                       and args.device != "cpu" else contextlib.nullcontext())
                t0 = time.perf_counter()
                with ctx:
                    line = run(torch, cfg, args, lr, getattr(torch, dt),
                               make_schedule, make_batch_iterator,
                               make_train_step, train_state_init, ops,
                               chip_smoke)
                line.update(lr=lr, dtype=dt, route=route,
                            seconds=time.perf_counter() - t0)
                print(json.dumps(line), flush=True)
    if args.device != "cpu":
        print(json.dumps({"nvidia_smi": chip_smoke.nvidia_smi()}))


def run(torch, cfg, args, lr, dtype, make_schedule, make_batch_iterator,
        make_train_step, train_state_init, ops, chip_smoke):
    from repro_torch.tree import tree_map

    # fp32 weights, as launch.train draws them, cast for a float64 run
    gen = torch.Generator(device=args.device).manual_seed(0)
    state = train_state_init(cfg, gen, args.device)
    if dtype != torch.float32:
        def cast(t):
            return t.detach().to(dtype)
        state = state._replace(
            params=tree_map(lambda p: cast(p).requires_grad_(),
                            state.params),
            opt=type(state.opt)(state.opt.step,
                                tree_map(cast, state.opt.mu),
                                tree_map(cast, state.opt.nu)))
    step = make_train_step(cfg, make_schedule("cosine", lr, args.steps))
    data = make_batch_iterator(cfg.vocab, args.seq, 1, seed=0)
    ops.reset_launch_counts()
    hist, bad = [], None
    for i in range(args.steps):
        batch = {k: torch.as_tensor(v, device=args.device)
                 for k, v in next(data).items()}
        loss, m, grads = step.grads_of(state.params, batch)
        if bad is None:
            names = [n for n, g in chip_smoke.named_leaves(grads)
                     if not bool(torch.isfinite(g).all())]
            if names:
                bad = {"step": i, "leaves": names}
        state, m = step.update(state, loss, m, grads)
        hist.append((float(m["loss"]), float(m["grad_norm"])))
        del grads
    return {"layers": cfg.n_layers, "vocab": cfg.vocab, "seq": args.seq,
            "loss_grad_norm": hist,
            "finite": all(math.isfinite(x) for h in hist for x in h),
            "first_non_finite_gradient": bad,
            "launches": {k: v for k, v in ops.launch_counts().items() if v}}


if __name__ == "__main__":
    main()
