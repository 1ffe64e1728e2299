"""Bytes that one hymba-1.5b block at full width keeps for its backward,
with the Mamba chunks recomputed (the port's ``run_mamba`` under grad)
and without (each chunk's checkpoint called through: the loop as it ran
before it had one).

    python scripts/hymba_block_saved_bytes.py --seq 2048 4096
    python scripts/hymba_block_saved_bytes.py --seq 2048 --control

For each sequence length (and with ``--control`` also without the
recompute), one block's forward runs under
``torch.autograd.graph.saved_tensors_hooks`` on the CPU in fp32 (B=1,
d=1600, d_in=3200, N=16, H=25, hd=64, window 2048) and counts the unique
storages of every saved tensor and of every input a chunk's checkpoint
holds, the block's own weights among them.  It prints one JSON line each:
the bytes, the block's weight bytes, and the activations over 32 layers.
The forward needs a few GB of host memory at S=4096 with the recompute
(the CPU flash plain version materializes the attention scores), and
the control some 7 GB at S=2048.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def block_saved_bytes(torch, cfg, S, recompute):
    from repro_torch.models import decoder, ssm

    gen = torch.Generator().manual_seed(0)
    params = decoder.init_params(cfg, gen, "cpu")
    bp = decoder.layer_params(params["blocks"], 0)
    bp = {k: ({kk: vv.clone().requires_grad_(True) for kk, vv in v.items()}
              if isinstance(v, dict) else v.clone().requires_grad_(True))
          for k, v in bp.items()}
    weights = sum(t.numel() * t.element_size() for v in bp.values()
                  for t in (v.values() if isinstance(v, dict) else [v]))
    x = torch.randn((1, S, cfg.d_model), generator=gen).requires_grad_(True)
    pos = torch.arange(S, dtype=torch.int32)[None]
    seen = {}

    def keep(t):
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()

    real = ssm.checkpoint

    def held(fn, *args, **kw):
        if not recompute:
            return fn(*args)
        for a in args:
            if isinstance(a, torch.Tensor):
                keep(a)
        return real(fn, *args, **kw)

    def pack(t):
        keep(t)
        return t

    ssm.checkpoint = held
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            y, _, _ = decoder.run_block(cfg, bp, x, pos)
    finally:
        ssm.checkpoint = real
    return sum(seen.values()), weights


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", type=int, nargs="+", default=[2048, 4096])
    ap.add_argument("--control", action="store_true",
                    help="also count the loop without the recompute")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import get_config

    cfg = get_config("hymba-1.5b")
    for S in args.seq:
        for recompute in (True, False) if args.control else (True,):
            saved, weights = block_saved_bytes(torch, cfg, S, recompute)
            print(json.dumps({
                "seq": S, "recompute": recompute, "saved_bytes": saved,
                "block_weight_bytes": weights,
                "activations_32_layers_bytes": cfg.n_layers
                * (saved - weights)}), flush=True)


if __name__ == "__main__":
    main()
