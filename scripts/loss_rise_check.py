"""Four training steps of minicpm-2b at full width, cut to 2 layers, in the
JAX package or in the port, from one numpy-seeded tree and one batch
stream: the smoke's recipe (AdamW, cosine lr 3e-3 with no warmup, B=1,
S=2048), to tell a fault of the port from one of the recipe.

    JAX_PLATFORMS=cpu python scripts/loss_rise_check.py jax
    python scripts/loss_rise_check.py torch

Each run prints each step's loss, grad norm and lr, then one JSON line
with the history, the seconds and the peak RSS.  Run each package in its
own process, one after the other: one run holds 13-17 GB on the CPU.
"""

import argparse
import dataclasses
import json
import math
import resource
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

L, B, S, STEPS, LR, SEED = 2, 1, 2048, 4, 3e-3, 28


def numpy_tree(cfg):
    """The dense decoder's tree at the JAX ``dense_init`` scales (0.02 for
    the embedding, else 1/sqrt(fan_in)), drawn from one seeded generator."""
    rng = np.random.default_rng(SEED)
    D, F = cfg.d_model, cfg.d_ff

    def w(shape, fan_in, scale=None):
        s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(s)
    return {"embed": w((cfg.vocab, D), 0, 0.02),
            "final_norm": np.ones(D, np.float32),
            "blocks": {
                "ln1": np.ones((L, D), np.float32),
                "ln2": np.ones((L, D), np.float32),
                "attn": {"wq": w((L, D, cfg.q_dim), D),
                         "wk": w((L, D, cfg.kv_dim), D),
                         "wv": w((L, D, cfg.kv_dim), D),
                         "wo": w((L, cfg.q_dim, D), cfg.q_dim)},
                "mlp": {"w_gate": w((L, D, F), D), "w_up": w((L, D, F), D),
                        "w_down": w((L, F, D), F)}}}


def run_torch():
    from repro_torch.configs import get_config
    from repro_torch.data import make_batch_iterator
    from repro_torch.optim import adamw_init, cosine_schedule
    from repro_torch.params import params_from_numpy
    from repro_torch.train import TrainState, make_train_step
    from repro_torch.tree import leaves

    cfg = dataclasses.replace(get_config("minicpm-2b"), n_layers=L)
    params = params_from_numpy(numpy_tree(cfg), "cpu")
    for p in leaves(params):
        p.requires_grad_(True)
    state = TrainState(params, adamw_init(params))
    step = make_train_step(cfg, cosine_schedule(LR, 0, STEPS))
    data = make_batch_iterator(cfg.vocab, S, B, seed=0)
    for _ in range(STEPS):
        state, m = step(state, next(data))
        yield m


def run_jax():
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.data import make_batch_iterator
    from repro.optim import adamw_init, cosine_schedule
    from repro.train.step import TrainState, make_train_step

    cfg = dataclasses.replace(get_config("minicpm-2b"), n_layers=L)
    params = jax.tree.map(jnp.asarray, numpy_tree(cfg))
    state = TrainState(params, adamw_init(params))
    step = jax.jit(make_train_step(cfg, cosine_schedule(LR, 0, STEPS)))
    data = make_batch_iterator(cfg.vocab, S, B, seed=0)
    for _ in range(STEPS):
        state, m = step(state, {k: jnp.asarray(v)
                                for k, v in next(data).items()})
        yield m


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("package", choices=["jax", "torch"])
    args = ap.parse_args()
    t0 = time.time()
    hist = []
    for i, m in enumerate(run_jax() if args.package == "jax"
                          else run_torch()):
        hist.append({k: float(m[k]) for k in ("loss", "grad_norm", "lr")})
        print(i, hist[-1], flush=True)
    print(json.dumps({"package": args.package, "n_layers": L, "batch": B,
                      "seq": S, "hist": hist, "seconds": time.time() - t0,
                      "peak_rss_bytes": resource.getrusage(
                          resource.RUSAGE_SELF).ru_maxrss * 1024}))


if __name__ == "__main__":
    main()
