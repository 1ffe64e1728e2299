"""Gate D3's round of ``chip_smoke.py``, its two inner steps per worker
replayed step by step on the card (fp32) and on the CPU (fp32, float64):
per leaf, the ratio of max|card32 - cpu64| to max(1e-4, 2 max|cpu32 -
cpu64|) (each over the leaf's largest |cpu64| entry) for the round's
pseudo-gradient and for each step's gradient, and at the
pseudo-gradient's worst element the three runs' gradients and
pseudo-gradients.  Prints each worker's four worst leaves and writes all
of it to ``chiprun_out/d3_diag.json``.  Needs a card; run from the
repository's root:

    python scripts/collab_d3_diagnosis.py
"""

import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def ratio(a, b, c):
    """D3's reading of one leaf: card ``a``, cpu32 ``b``, cpu64 ``c``."""
    scale = c.abs().max().item()
    return ((a - c).abs().max().item() / scale) / max(
        1e-4, 2 * (b - c).abs().max().item() / scale)


def replay(torch, cs, cfg, base, batches, dev, dt):
    """The worker's inner steps from ``base`` on ``dev`` in ``dt``: each
    step's gradient and the pseudo-gradient (float32 for a float32 run, as
    ``pseudo_gradient`` rounds it), all as float64 CPU tensors."""
    import numpy as np

    from repro_torch.optim import adamw_init, cosine_schedule
    from repro_torch.params import params_from_numpy
    from repro_torch.train import TrainState, make_train_step
    from repro_torch.tree import leaves

    params = params_from_numpy(cs._cast_tree(base, dt), dev)
    for p in leaves(params):
        p.requires_grad_(True)
    state = TrainState(params, adamw_init(params))
    step = make_train_step(cfg, cosine_schedule(cs.COLLAB_LR, 0, 100))
    grads = []
    for b in batches:
        _, _, g = step.grads_of(state.params, {
            k: torch.as_tensor(v, device=dev) for k, v in b.items()})
        grads.append({n: t.detach().double().cpu()
                      for n, t in cs.named_leaves(g, sep="/")})
        state, _ = step(state, b)
    start = {n: torch.from_numpy(np.asarray(a, np.float64))
             for n, a in cs.named_leaves(base, sep="/")}
    pg = {}
    for n, t in cs.named_leaves(state.params, sep="/"):
        d = start[n] - t.detach().double().cpu()
        pg[n] = d.float().double() if dt == np.float32 else d
    return pg, grads


def main():
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import numpy as np
    import torch

    import chip_smoke as cs
    import repro_torch  # noqa: F401  (turns TF32 off)
    from repro_torch.configs import get_config
    from repro_torch.data import make_batch_iterator
    from repro_torch.kernels import build
    from repro_torch.models import decoder
    from repro_torch.params import params_to_numpy

    build.build(["flash_attention", "flash_attention_bwd"])
    print(cs.nvidia_smi(), flush=True)
    cfg = get_config("minicpm-2b").reduced(**cs.T2_REDUCED)
    base = params_to_numpy(decoder.init_params(
        cfg, torch.Generator().manual_seed(cs.COLLAB_SEED), "cpu"))
    out = {}
    for w in range(cs.COLLAB_WORKERS):
        data = make_batch_iterator(cfg.vocab, cs.COLLAB_SEQ,
                                   cs.COLLAB_WORKERS,
                                   n_shards=cs.COLLAB_WORKERS, shard=w,
                                   seed=0)
        batches = [next(data) for _ in range(cs.COLLAB_INNER)]
        runs = {name: replay(torch, cs, cfg, base, batches, dev, dt)
                for name, dev, dt in (("card32", "cuda", np.float32),
                                      ("cpu32", "cpu", np.float32),
                                      ("cpu64", "cpu", np.float64))}
        order = ("card32", "cpu32", "cpu64")
        rows = {}
        for n in runs["cpu64"][0]:
            pg = [runs[r][0][n] for r in order]
            i = int((pg[0] - pg[2]).abs().argmax())
            rows[n] = {
                "pg_ratio": ratio(*pg),
                "grad_ratio": [ratio(*[runs[r][1][k][n] for r in order])
                               for k in range(cs.COLLAB_INNER)],
                "worst_index": i,
                "pg_at": {r: runs[r][0][n].flatten()[i].item()
                          for r in order},
                "pg_scale": pg[2].abs().max().item(),
                "grads_at": {r: [runs[r][1][k][n].flatten()[i].item()
                                 for k in range(cs.COLLAB_INNER)]
                             for r in order},
                "grad_scale_step0": runs["cpu64"][1][0][n].abs().max().item()}
        out[f"worker{w}"] = rows
        for n, r in sorted(rows.items(),
                           key=lambda kv: -kv[1]["pg_ratio"])[:4]:
            print(w, n, json.dumps(r), flush=True)
    os.makedirs(ROOT / "chiprun_out", exist_ok=True)
    with open(ROOT / "chiprun_out" / "d3_diag.json", "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main()
