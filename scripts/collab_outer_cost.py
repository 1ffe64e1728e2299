"""Host seconds of the collab worker's float64 outer arithmetic, for the
tree of one source checkout: ``pseudo_gradient``, ``average_flat`` of two
contributions and one Nesterov ``CollabWorker._outer_step``, on seeded
float32 flats shaped like minicpm-2b's at full width cut to ``--layers``
layers (the smoke's collab phase: 4).  Prints one JSON line with each
call's seconds (best of ``--repeat``) and a sha256 of its outputs, so
that two checkouts can be compared for time and bits in one process
each.  Runs on the CPU; the flats take about 7 x 2.1 GB at 4 layers.

    python scripts/collab_outer_cost.py --src src
    python scripts/collab_outer_cost.py --src build/parent/src
"""

import argparse
import dataclasses
import hashlib
import json
import sys
import time


def shapes(src, layers, reduced):
    """(name, shape) of minicpm-2b's leaves cut to ``layers`` layers (and
    to a width of 64 and a vocab of 128 when ``reduced``, to try the
    script), from the port's init on the CPU."""
    import torch

    sys.path.insert(0, src)
    from repro_torch.configs import get_config
    from repro_torch.models import decoder

    cfg = dataclasses.replace(get_config("minicpm-2b"), n_layers=layers)
    if reduced:
        cfg = cfg.reduced(n_layers=layers, d_model=64, vocab=128)
    params = decoder.init_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu")

    def walk(tree, prefix):
        for k in sorted(tree):
            if isinstance(tree[k], dict):
                yield from walk(tree[k], f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", tuple(tree[k].shape)
    return list(walk(params, ""))


def digest(*flats):
    h = hashlib.sha256()
    for flat in flats:
        for k in sorted(flat):
            h.update(k.encode())
            h.update(flat[k].tobytes())
    return h.hexdigest()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default="src")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--repeat", type=int, default=2)
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args()
    import numpy as np

    leaves = shapes(args.src, args.layers, args.reduced)
    from types import SimpleNamespace

    from repro_torch.train import compress
    from repro_torch.train.collab import CollabWorker

    rng = np.random.default_rng(0)

    def flat(scale):
        return {k: (rng.standard_normal(s, dtype=np.float32)
                    * np.float32(scale)) for k, s in leaves}
    start = flat(0.02)
    end = {k: v + d for (k, v), d in zip(start.items(),
                                         flat(1e-3).values())}
    other = flat(1e-3)
    mom = flat(1e-3)
    out = {"src": args.src, "layers": args.layers,
           "entries": sum(v.size for v in start.values())}

    def timed(name, fn):
        best = None
        for _ in range(args.repeat):
            t0 = time.perf_counter()
            got = fn()
            s = time.perf_counter() - t0
            best = s if best is None else min(best, s)
        out[name] = {"s": best}
        return got
    grad = timed("pseudo_gradient",
                 lambda: compress.pseudo_gradient(start, end))
    out["pseudo_gradient"]["sha256"] = digest(grad)
    avg = timed("average_flat",
                lambda: compress.average_flat([grad, other]))
    out["average_flat"]["sha256"] = digest(avg)

    def outer():
        w = SimpleNamespace(
            ccfg=SimpleNamespace(outer_lr=0.7, outer_momentum=0.9,
                                 nesterov=True),
            outer_flat=dict(start), outer_mom=dict(mom))
        CollabWorker._outer_step(w, avg)
        return w
    w = timed("_outer_step", outer)
    out["_outer_step"]["sha256"] = digest(w.outer_flat, w.outer_mom)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
