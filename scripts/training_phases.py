"""The smoke's training phases of the hybrid, vlm and audio archs alone
on the card, then its checkpoint, mesh and fleet phases at
``chip_smoke.CKPT_LAYERS`` layers, each phase's seconds printed as a JSON
line (``{"timing": name, "s": ...}``).

    python3 scripts/training_phases.py

From the root of a checkout, on a machine with the card: builds the
kernels, runs ``flash_backward_phase`` (gate T1), the three
``arch_train_parity_phase`` (T2h, T2v, T2a, their CPU runs in this
process), the three ``arch_training_phase`` (T3h, T3v, T3a), then the
chain, and prints ``{"done_s": ...}``.
"""
import json
import sys
import time

sys.path.insert(0, "src")
sys.path.insert(0, ".")
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import repro_torch  # noqa: E402,F401
from repro_torch.kernels import build  # noqa: E402


def timed(name, fn, *a, **kw):
    t = time.perf_counter()
    out = fn(*a, **kw)
    print(json.dumps({"timing": name, "s": time.perf_counter() - t}),
          flush=True)
    return out


t_main = time.perf_counter()
print(cs.nvidia_smi(), flush=True)
logs = timed("build", build.build, verbose=True)
flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
timed("flash_backward", cs.flash_backward_phase, torch, flush,
      logs.get("flash_attention_bwd", ""))
del flush
for arch in cs.T2_ARCHS:
    timed(f"train_parity {arch}", cs.arch_train_parity_phase, torch, arch)
for arch in cs.T3_ARCHS:
    cs.release(torch, arch)
    timed(f"training {arch}", cs.arch_training_phase, torch, arch)
cs.release(torch, "checkpoint")
with cs.cut_depth("minicpm-2b", cs.CKPT_LAYERS):
    trained, entries = timed("checkpoint", cs.checkpoint_phase, torch)
    fetched, ref = timed("mesh", cs.mesh_phase, torch, trained, entries,
                         t_main)
    del trained, entries
    cs.gc.collect()
    torch.cuda.empty_cache()
    timed("fleet", cs.fleet_phase, torch, fetched, ref, t_main)
print(json.dumps({"done_s": time.perf_counter() - t_main}), flush=True)
