"""qwen2-moe-a2.7b's routing in the JAX package and in the port, on the
CPU, from one initial tree and one batch stream: full width cut to one
layer, B=1, S=2048, to tell whether the routing collapse that the smoke's
``moe_training`` phase reads on the card is the recipe's or a fault of the
port.

    JAX_PLATFORMS=cpu python scripts/moe_routing_check.py jax --dir DIR
    python scripts/moe_routing_check.py torch --dir DIR

Two parts, each printed as one JSON line:

* ``init``: the whole width, vocab 151,936.  One forward of the loss from
  the JAX package's init (``PRNGKey(30)``); layer 0's expert ids give the
  share of (token, k) slots past their expert's capacity.  The torch run
  reads the same tree and also runs a forward from the port's own init
  (``train_state_init`` with a CPU generator seeded 30; the smoke seeds a
  card generator, whose stream differs).
* ``train``: vocab cut to 8,192, so that a run with its AdamW state
  holds ~14 GB of host memory, not ~35 GB.  Four steps of the smoke's
  recipe (AdamW, cosine lr 3e-3 over 4 steps with no warmup, clip 1.0,
  decay 0.1) from the JAX package's init at that size: each step's loss,
  aux, grad norm and layer 0's dropped share.

The jax run writes both initial trees to DIR (7.2 GB); run it first, then
the torch run, one after the other.
"""

import argparse
import dataclasses
import hashlib
import json
import resource
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

ARCH, L, B, S, SEED = "qwen2-moe-a2.7b", 1, 1, 2048, 30
TRAIN_VOCAB, STEPS, LR = 8192, 4, 3e-3


def flat(tree, prefix=""):
    """{"a/b/c": leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def nest(flat_tree):
    out = {}
    for path, v in flat_tree.items():
        *head, last = path.split("/")
        node = out
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def dropped_share(ids, cfg):
    """Share of a gating call's (token, k) slots past their expert's
    capacity, by the capacity rule both packages state for training."""
    T, K = ids.shape
    E = cfg.n_experts
    G = cfg.moe_groups if cfg.moe_groups > 1 and T % cfg.moe_groups == 0 else 1
    Tg = T // G
    C = min(int(max(K * Tg * cfg.capacity_factor / E, K)), Tg)
    over = sum(np.maximum(np.bincount(g, minlength=E) - C, 0).sum()
               for g in ids.reshape(G, -1).astype(np.int64))
    return float(over) / ids.size


def routing_summary(ids, cfg):
    load = np.bincount(ids.reshape(-1).astype(np.int64),
                       minlength=cfg.n_experts)
    return {"dropped_share": dropped_share(ids, cfg),
            "experts_chosen": int((load > 0).sum()),
            "largest_load_share": float(load.max() / ids.size)}


def batches(make_batch_iterator, vocab):
    data = make_batch_iterator(vocab, S, B, seed=SEED)
    return [next(data) for _ in range(STEPS + 1)]


def tokens_sha(batch):
    return hashlib.sha256(np.ascontiguousarray(
        batch["tokens"]).tobytes()).hexdigest()[:16]


def run_jax(out_dir):
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.data import make_batch_iterator
    from repro.models import moe, ops_for
    from repro.optim import adamw_init, cosine_schedule
    from repro.train.step import TrainState, make_train_step

    rec = []
    real = moe.topk_gating

    def recording(logits, k):
        out = real(logits, k)
        jax.debug.callback(lambda ids: rec.append(np.asarray(ids)), out[1])
        return out
    moe.topk_gating = recording

    for part, vocab in (("init", None), ("train", TRAIN_VOCAB)):
        cfg = dataclasses.replace(get_config(ARCH), n_layers=L)
        if vocab:
            cfg = dataclasses.replace(cfg, vocab=vocab)
        params = ops_for(cfg).init(cfg, jax.random.PRNGKey(SEED))
        np.savez(out_dir / f"{part}.npz",
                 **{k: np.asarray(v) for k, v in flat(params).items()})
        data = batches(make_batch_iterator, cfg.vocab)
        rec.clear()
        t0 = time.time()
        line = {"package": "jax", "part": part, "vocab": cfg.vocab,
                "tokens_sha": tokens_sha(data[0])}
        if part == "init":
            loss, m = jax.jit(lambda p, b: ops_for(cfg).loss_fn(p, cfg, b))(
                params, {k: jnp.asarray(v) for k, v in data[0].items()})
            jax.effects_barrier()
            line.update(loss=float(loss), aux=float(m["aux"]),
                        routing=routing_summary(rec[0], cfg), calls=len(rec))
        else:
            state = TrainState(params, adamw_init(params))
            del params
            step = jax.jit(make_train_step(cfg, cosine_schedule(LR, 0, STEPS)),
                           donate_argnums=0)
            hist = []
            for b in data[:STEPS]:
                state, m = step(state, {k: jnp.asarray(v)
                                        for k, v in b.items()})
                jax.effects_barrier()
                hist.append({k: float(m[k]) for k in ("loss", "aux",
                                                      "grad_norm", "lr")})
                hist[-1]["routing"] = routing_summary(rec[-1], cfg)
            line.update(hist=hist, calls=len(rec))
            del state
        params = None
        line.update(seconds=time.time() - t0, peak_rss_bytes=peak_rss())
        print(json.dumps(line), flush=True)


def run_torch(out_dir):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import make_batch_iterator
    from repro_torch.kernels import moe_gating as mg
    from repro_torch.models import ops_for
    from repro_torch.optim import adamw_init, cosine_schedule
    from repro_torch.params import params_from_numpy
    from repro_torch.train import TrainState, make_train_step
    from repro_torch.tree import leaves

    rec = []
    real = mg.router_gating_plain

    def recording(x, router, k):
        out = real(x, router, k)
        rec.append(out[1].numpy().copy())
        return out
    mg.router_gating_plain = recording

    for part, vocab in (("init", None), ("train", TRAIN_VOCAB)):
        cfg = dataclasses.replace(get_config(ARCH), n_layers=L)
        if vocab:
            cfg = dataclasses.replace(cfg, vocab=vocab)
        with np.load(out_dir / f"{part}.npz") as z:
            params = params_from_numpy(nest({k: z[k] for k in z.files}),
                                       "cpu")
        data = batches(make_batch_iterator, cfg.vocab)
        rec.clear()
        t0 = time.time()
        line = {"package": "torch", "part": part, "vocab": cfg.vocab,
                "tokens_sha": tokens_sha(data[0])}
        if part == "init":
            batch = {k: torch.as_tensor(v) for k, v in data[0].items()}
            with torch.no_grad():
                loss, m = ops_for(cfg).loss_fn(params, cfg, batch)
                line.update(loss=float(loss), aux=float(m["aux"]),
                            routing=routing_summary(rec[0], cfg))
                del params
                own = ops_for(cfg).init(cfg, torch.Generator().manual_seed(
                    SEED), torch.device("cpu"), torch.float32)
                loss, m = ops_for(cfg).loss_fn(own, cfg, batch)
                line["own_init"] = {"loss": float(loss), "aux": float(m["aux"]),
                                    "routing": routing_summary(rec[1], cfg)}
                del own
        else:
            for p in leaves(params):
                p.requires_grad_(True)
            state = TrainState(params, adamw_init(params))
            del params
            step = make_train_step(cfg, cosine_schedule(LR, 0, STEPS))
            hist = []
            for b in data[:STEPS]:
                state, m = step(state, b)
                hist.append({k: float(m[k]) for k in ("loss", "aux",
                                                      "grad_norm", "lr")})
                hist[-1]["routing"] = routing_summary(rec[-1], cfg)
            del state
        if part == "train":
            line["hist"] = hist
        line.update(calls=len(rec), seconds=time.time() - t0,
                    peak_rss_bytes=peak_rss())
        print(json.dumps(line), flush=True)


def peak_rss():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("package", choices=["jax", "torch"])
    ap.add_argument("--dir", required=True, type=Path,
                    help="where the jax run writes the initial trees")
    args = ap.parse_args()
    args.dir.mkdir(parents=True, exist_ok=True)
    (run_jax if args.package == "jax" else run_torch)(args.dir)


if __name__ == "__main__":
    main()
