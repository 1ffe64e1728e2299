#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and hold its kernels against
their plain versions.

    python3 chip_smoke.py

Phases, each printed as one JSON object per line:

1. device   — ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build    — the port's CUDA kernels compiled from ``src/repro_torch/
   kernels/csrc`` (one ``nvcc`` per source, all at once);
3. paged_decode_attention — the kernel at granite-8b widths (M=8, H=32,
   Hk=8, hd=128, page 32) over ragged lengths with poisoned stale pages,
   fp32 and int8, against ``paged_attention_plain`` on the card;
4. flash_attention — the kernel at B=1, H=32, hd=128, S=2048 and a ragged
   S=2050 (causal, window 128, non-causal), fp32 and bf16, against
   ``flash_attention_plain``; ``scaled_dot_product_attention`` is timed
   beside it as a yardstick only;
5. moe_gating — the router-gating kernel at T in {1, 8, 2048, 2050} and
   (E, K) in {(60, 4), (16, 4), (64, 8)}, plus duplicated logit columns
   (ties), against ``moe_gating_plain``: ids exactly, weights and
   probabilities within 1e-6; timed at T=8 (a decode step) and T=2048 (a
   prompt) for qwen2-moe-a2.7b's E=60, K=4;
6. small_parity — a reduced granite-8b (fp32 and int8 pools) and a
   reduced qwen2-moe-a2.7b with its 60 experts, top-4, served on the card
   and on the CPU (plain versions) with the same weights: logits must
   agree and only the card's run launches the kernels;
7. serving  — granite-8b at full width and full depth in fp32 with
   seeded random weights: a ``BatchEngine`` admits 8
   sessions (two 2048-token prompts through the flash kernel, six short
   ones), decodes 32 greedy steps through the paged kernel and closes
   them; launch counts, page accounting, timings; then the recorded token
   feed is replayed through the per-slot path (logits within 1e-3 of the
   fused path) and the int8 pool (deviation reported), and a few steps
   are profiled;
8. serving_moe — granite-8b released, then qwen2-moe-a2.7b at full width
   and depth in fp32 (14.3 B parameters) served the same way, every
   layer's router gating through the gating kernel: launch counts, page
   accounting, timings, peak memory, the per-slot replay within 1e-3,
   and a profile of a few steps.

Then a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before the
last line.  Without a card, or without ``src/repro_torch`` beside this
script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: H100 SXM published peaks (NVIDIA data sheet, dense): HBM bandwidth,
#: TF32 and bf16 tensor-core rates, and fp32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 495e12, "bfloat16": 989e12}
FP32_SIMT_FLOPS = 67e12

PAGED_LENGTHS = [0, 31, 32, 33, 100, 2047, 2048, 2069]
SERVE_PROMPTS = [2048, 2048, 12, 37, 64, 100, 200, 256]
SERVE_STEPS = 32
GATING_T = (1, 8, 2048, 2050)
GATING_EK = ((60, 4), (16, 4), (64, 8))
#: two runs of one feed may route a token differently only where its K-th
#: and (K+1)-th expert probabilities were this close in both (a rounding
#: tie; both runs' products differ in the last bits)
TIE_GAP = 1e-5


class SmokeFailure(Exception):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return res.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 20, warmup: int = 3, flush=None) -> float:
    """Median CUDA-event time of ``fn`` in ms; with ``flush``, a buffer
    larger than L2 is rewritten before each launch (cold caches)."""
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


# --------------------------------------------------------------- kernels

def paged_phase(torch, flush):
    import numpy as np

    from repro_torch.kernels import paged_attention as pa
    from repro_torch.serving.batch import _quant_page_int8

    dev = torch.device("cuda")
    M, H, Hk, hd, page = 8, 32, 8, 128, 32
    lengths = PAGED_LENGTHS
    # the engine allocates the current token's page before the step
    owned = [-(-(L + 1) // page) for L in lengths]
    NP = max(owned)
    P = sum(owned) + 16                           # 16 pages no slot owns
    rng = np.random.default_rng(0)
    perm = rng.permutation(P)
    bt = np.zeros((M, NP), np.int32)
    live = np.zeros((P, page), bool)
    at = 0
    for m, (L, n) in enumerate(zip(lengths, owned)):
        bt[m, :n] = perm[at:at + n]
        at += n
        for t in range(L):
            live[bt[m, t // page], t % page] = True
    g = torch.Generator(device=dev).manual_seed(0)
    kp = torch.randn((P, page, Hk, hd), generator=g, device=dev)
    vp = torch.randn((P, page, Hk, hd), generator=g, device=dev)
    stale = torch.from_numpy(~live).to(dev)
    kp[stale] = 1e4                               # poison: large and finite
    vp[stale] = -1e4
    q = torch.randn((M, H, hd), generator=g, device=dev)
    kn = torch.randn((M, Hk, hd), generator=g, device=dev)
    vn = torch.randn((M, Hk, hd), generator=g, device=dev)
    bt_t = torch.from_numpy(bt).to(dev)
    len_t = torch.tensor(lengths, dtype=torch.int32, device=dev)
    kq, ks = _quant_page_int8(kp)
    vq, vs = _quant_page_int8(vp)
    fp32 = (q, kp, vp, bt_t, len_t, kn, vn)
    int8 = (q, kq, vq, bt_t, len_t, kn, vn, ks, vs)

    err = {}
    for name, args in (("fp32", fp32), ("int8", int8)):
        got = pa.paged_attention_cuda(*args)
        want = pa.paged_attention_plain(*args)
        torch.cuda.synchronize()
        require(bool(torch.isfinite(got).all()), f"paged {name}: non-finite")
        err[name] = (got - want).abs().max().item()
    # tolerance: fp32 sums over up to ~2k keys in another order
    require(max(err.values()) <= 1e-4, f"paged kernel disagrees: {err}")

    pages_read = sum(-(-L // page) for L in lengths)
    fixed = (2 * M * H * hd + 2 * M * Hk * hd) * 4 + M * 4 + pages_read * 4

    def bound(itemsize: int, scales: bool) -> float:
        kv = sum(lengths) * Hk * hd * 2 * itemsize
        sc = pages_read * Hk * 4 * 2 if scales else 0
        return (kv + sc + fixed) / HBM_BYTES_PER_S * 1e3

    res = {
        "max_abs_err": err,
        "kernel_ms": time_ms(torch, lambda: pa.paged_attention_cuda(*fp32),
                             flush=flush),
        "kernel_int8_ms": time_ms(torch, lambda: pa.paged_attention_cuda(*int8),
                                  flush=flush),
        "plain_ms": time_ms(torch, lambda: pa.paged_attention_plain(*fp32),
                            iters=5, flush=flush),
        "bound_ms": bound(4, False),
        "bound_int8_ms": bound(1, True),
        # no single PyTorch call computes attention through a block table
        "library_ms": None,
    }
    emit({"phase": "paged_decode_attention", "M": M, "H": H, "Hk": Hk,
          "hd": hd, "page": page, "lengths": lengths, **res})
    return res


def flash_phase(torch, flush):
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    dev = torch.device("cuda")
    B, H, hd = 1, 32, 128
    g = torch.Generator(device=dev).manual_seed(1)
    cases = [("causal", 2048, 2048, True, 0), ("window128", 2048, 2048, True, 128),
             ("ragged", 2050, 2050, True, 0), ("noncausal", 128, 2048, False, 0)]
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, Sq, Sk, causal, window in cases:
            # the main path's layout: (B, S, H, hd) viewed as (B, H, S, hd)
            q, k, v = (torch.randn((B, S, H, hd), generator=g, device=dev)
                       .to(dtype).transpose(1, 2) for S in (Sq, Sk, Sk))
            got = fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
            want = fa.flash_attention_plain(q, k, v, causal=causal,
                                            window=window)
            torch.cuda.synchronize()
            key = f"{name}_{str(dtype).split('.')[1]}"
            require(bool(torch.isfinite(got.float()).all()), f"flash {key}")
            errs[key] = (got.float() - want.float()).abs().max().item()
            tol = 1e-4 if dtype == torch.float32 else 2e-2
            require(errs[key] <= tol, f"flash {key}: err {errs[key]} > {tol}")

    # times at the main path's case: causal fp32 prefill of 2048 tokens
    S = 2048
    q, k, v = (torch.randn((B, S, H, hd), generator=g, device=dev)
               .transpose(1, 2) for _ in range(3))
    flops = 4 * B * H * hd * (S * (S + 1) // 2)    # only unmasked pairs
    nbytes = 4 * B * H * S * hd * 4                # q, k, v read, out written
    res = {
        "max_abs_err": errs,
        "max_abs_err_fp32": max(v for k, v in errs.items()
                                if k.endswith("float32")),
        "kernel_ms": time_ms(torch, lambda: fa.flash_attention_cuda(q, k, v),
                             flush=flush),
        "plain_ms": time_ms(torch, lambda: fa.flash_attention_plain(q, k, v),
                            iters=5, flush=flush),
        "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), flush=flush),
        "bound_ms": max(flops / PEAK_FLOPS["float32"],
                        nbytes / HBM_BYTES_PER_S) * 1e3,
        "bound_by": ("operations" if flops / PEAK_FLOPS["float32"]
                     >= nbytes / HBM_BYTES_PER_S else "bytes"),
    }
    bq, kq_, vq_ = (t.to(torch.bfloat16) for t in (q, k, v))
    res["kernel_bf16_ms"] = time_ms(
        torch, lambda: fa.flash_attention_cuda(bq, kq_, vq_), flush=flush)
    res["bound_bf16_ms"] = max(flops / PEAK_FLOPS["bfloat16"],
                               nbytes / 2 / HBM_BYTES_PER_S) * 1e3
    emit({"phase": "flash_attention", "B": B, "H": H, "hd": hd, "S": S, **res})
    return res


def _gating_logits(torch, T, E, g, ties=False):
    """Router-like logits on the card; with ``ties`` every column appears
    twice and row 0 is uniform, so equal probabilities are common."""
    if ties:
        half = torch.randn((T, E // 2), generator=g, device="cuda") * 2
        x = torch.cat([half, half], dim=1)
        x[0] = 0.25
        return x.contiguous()
    return torch.randn((T, E), generator=g, device="cuda") * 2


def gating_phase(torch, flush):
    from repro_torch.kernels import moe_gating as mg

    g = torch.Generator(device="cuda").manual_seed(3)
    errs = {}
    cases = [(T, E, K, False) for T in GATING_T for E, K in GATING_EK]
    cases += [(T, 60, 4, True) for T in (8, 2050)]
    for T, E, K, ties in cases:
        x = _gating_logits(torch, T, E, g, ties)
        w, ids, probs = mg.moe_gating_cuda(x, K)
        wp, ip, pp = mg.moe_gating_plain(x, K)
        torch.cuda.synchronize()
        key = f"T{T}_E{E}_K{K}" + ("_ties" if ties else "")
        require(torch.equal(ids, ip), f"gating {key}: expert ids differ")
        errs[key] = max((w - wp).abs().max().item(),
                        (probs - pp).abs().max().item())
        require(errs[key] <= 1e-6, f"gating {key}: err {errs[key]} > 1e-6")

    # times at qwen2-moe-a2.7b's router: E=60, K=4; T=8 is one decode step
    # of 8 sessions, T=2048 one long prompt
    E, K = 60, 4

    def three_calls(x):
        # softmax, topk, divide: the same function but for the tie order
        # (torch.topk does not promise the lowest index first)
        p = torch.softmax(x, dim=-1)
        v, i = torch.topk(p, K, dim=-1)
        return v / torch.clamp_min(v.sum(-1, keepdim=True), 1e-9), i, p

    res = {"max_abs_err": errs, "max_abs_err_all": max(errs.values())}
    for T in (8, 2048):
        x = _gating_logits(torch, T, E, g)
        nbytes = 2 * T * E * 4 + T * K * 8     # logits in, probs + w + ids out
        ops = T * E * (5 + 2 * K)              # softmax, then K compare rounds
        res[f"T{T}"] = {
            "kernel_ms": time_ms(torch, lambda: mg.moe_gating_cuda(x, K),
                                 iters=50, flush=flush),
            "plain_ms": time_ms(torch, lambda: mg.moe_gating_plain(x, K),
                                iters=20, flush=flush),
            "softmax_topk_divide_ms": time_ms(torch, lambda: three_calls(x),
                                              iters=50, flush=flush),
            "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                            ops / FP32_SIMT_FLOPS) * 1e3,
            "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                         >= ops / FP32_SIMT_FLOPS else "operations"),
        }
    # no single PyTorch call computes softmax + ordered top-k + renormalise
    res["library_ms"] = None
    emit({"phase": "moe_gating", "E": E, "K": K, **res})
    return res


# --------------------------------------------------------------- serving

def _drive(eng, sim, prompts, steps, feed=None):
    """Open every session, decode ``steps`` greedy steps (or replay
    ``feed``), close.  Returns per-prompt prefill logits and seconds, the
    per-step logits and seconds, and the token feed."""
    import numpy as np

    sessions = [f"s{i}" for i in range(len(prompts))]
    first, prefill_s = [], []
    for sid, p in zip(sessions, prompts):
        t0 = time.perf_counter()
        out, _ = sim.run_process(eng.open(sid, p, p.shape[1] + steps + 1))
        prefill_s.append(time.perf_counter() - t0)   # out is on the host
        first.append(out[0])
    toks = np.asarray([int(np.argmax(r)) for r in first], np.int32)
    logits, step_s, fed = [], [], []
    for t in range(steps):
        x = feed[t] if feed is not None else toks
        fed.append(x)
        t0 = time.perf_counter()
        out, served, _ = eng.step(sessions, x)
        step_s.append(time.perf_counter() - t0)
        require(served == sessions, "a session was dropped")
        logits.append(out)
        toks = np.argmax(out, axis=-1).astype(np.int32)
    eng.close(sessions)
    return np.stack(first), prefill_s, logits, step_s, fed


@contextlib.contextmanager
def recording_gating():
    """Keep every router gating's (expert ids, probabilities) in call
    order, on their device (nothing is copied or synchronised while the
    run goes on).  The counted kernel wrapper still does the work."""
    from repro_torch.kernels import ops

    real, rec = ops.moe_gating, []

    def record(logits, k):
        out = real(logits, k)
        rec.append((out[1], out[2]))
        return out

    ops.moe_gating = record
    try:
        yield rec
    finally:
        ops.moe_gating = real


def _gating_by_call(rec, rows, L, steps, per_slot):
    """A run's gating records keyed by call: ("prefill", prompt, layer)
    with a row per token, ("step", t, layer) with a row per session.  The
    records come in the engine's order of work, which ``BatchEngine``'s
    docstring states: a prefill goes prompt by prompt, each through every
    layer; a fused step goes layer by layer over all sessions; a per-slot
    step goes session by session, each through every layer (its rows are
    stacked here).  Every record's row count is checked against that order,
    so a change of it fails here, or as a routing difference that is no
    tie."""
    import torch

    n = len(rows)
    calls = n * L + steps * L * (n if per_slot else 1)
    require(len(rec) in (0, calls), f"{len(rec)} gating calls, want {calls}")
    if not rec:
        return {}
    out = {("prefill", p, j): rec[p * L + j] for p in range(n) for j in range(L)}
    base = n * L
    for t in range(steps):
        for j in range(L):
            if per_slot:
                parts = [rec[base + (t * n + s) * L + j] for s in range(n)]
                out[("step", t, j)] = (torch.cat([r[0] for r in parts]),
                                       torch.cat([r[1] for r in parts]))
            else:
                out[("step", t, j)] = rec[base + t * L + j]
    for key, (ids, _) in out.items():
        want = rows[key[1]] if key[0] == "prefill" else n
        require(ids.shape[0] == want, f"gating call {key} has "
                f"{ids.shape[0]} rows, want {want}")
    return out


def routing_ties(rec_a, rec_b, rows, L, steps, k, b_per_slot=False):
    """Where two runs of one token feed first sent a token of a session to
    a different set of experts.  That decision must be a rounding tie in
    both runs (the k-th and (k+1)-th probabilities within ``TIE_GAP``);
    anything else fails.  From there on the session's states differ, so
    its later decisions are not compared.  ``rows`` are the prompt
    lengths.  Returns {session: {"step": the first step whose logits the
    tie reaches (-1: its prefill), "layer", "gaps"}}.

    At most half the sessions may reach a tie.  A real tie is rare (the
    full-width run met one in eight sessions, the reduced runs none),
    while a fault that flattens the probabilities (gating zeros, say)
    makes every decision a tie; the cap keeps such a run from passing by
    leaving its sessions out of the logit comparison."""
    n = len(rows)
    a = _gating_by_call(rec_a, rows, L, steps, False)
    b = _gating_by_call(rec_b, rows, L, steps, b_per_slot)
    reach = {}
    for key, (ids_a, probs_a) in a.items():         # in the order of the run
        ids_b, probs_b = b[key]
        differ = (ids_a.sort(dim=1).values.cpu()
                  != ids_b.sort(dim=1).values.cpu()).any(dim=1)
        for r in differ.nonzero()[:, 0].tolist():
            sess, step = (key[1], -1) if key[0] == "prefill" else (r, key[1])
            if sess in reach:
                continue
            gaps = []
            for probs in (probs_a[r], probs_b[r]):
                top = probs.float().cpu().topk(k + 1).values
                gaps.append(float(top[k - 1] - top[k]))
            require(max(gaps) <= TIE_GAP, f"routing differs at {key} row {r} "
                    f"with probability gaps {gaps}")
            reach[sess] = {"step": step, "layer": key[2], "gaps": gaps}
    require(len(reach) <= n // 2, f"routing ties reach {len(reach)} of {n} "
            "sessions")
    return reach


def logit_diff(run_a, run_b, reach):
    """Max |a - b| over two runs' prefill and step logits, leaving out each
    session from the step a routing tie first reached."""
    import numpy as np

    first_a, steps_a = run_a[0], run_a[2]
    first_b, steps_b = run_b[0], run_b[2]
    n = len(first_a)
    since = [reach[s]["step"] if s in reach else len(steps_a) for s in range(n)]
    keep = [s for s in range(n) if since[s] > -1]
    diffs = [float(np.abs(first_a[keep] - first_b[keep]).max())]
    for t, (a, b) in enumerate(zip(steps_a, steps_b)):
        keep = [s for s in range(n) if since[s] > t]
        diffs.append(float(np.abs(a[keep] - b[keep]).max()))
    return max(diffs)


def expected_launches(cfg, prompts, steps):
    """Every kernel launch of one served run: paged attention per layer per
    step, flash per layer per long prompt, gating per layer per pass."""
    L = cfg.n_layers
    n_long = sum(p.shape[1] >= 2048 for p in prompts)
    return {"paged_decode_attention": L * steps, "flash_attention": L * n_long,
            "moe_gating": L * (len(prompts) + steps) if cfg.arch == "moe" else 0}


def small_parity_phase(torch):
    """Reduced models served on the card (through the kernels) and on the
    CPU (plain versions) with the same weights and token feed: granite-8b
    with fp32 and int8 pools, and qwen2-moe-a2.7b with its 60 experts,
    top-4, and a narrow expert width.  fp32: 1e-4.  int8: k/v differ by
    fp32 rounding between the devices, so an element on a rounding edge can
    quantize one step apart: 1e-2, far below the int8-vs-fp32 deviation."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.simnet import Sim
    from repro_torch.kernels import ops
    from repro_torch.models import decoder
    from repro_torch.params import params_from_numpy, params_to_numpy
    from repro_torch.serving import BatchEngine, ShardModule

    cases = (("granite-8b", {}, (("fp32", 1e-4), ("int8", 1e-2))),
             ("qwen2-moe-a2.7b", dict(n_experts=60, moe_top_k=4, d_expert=32),
              (("fp32", 1e-4),)))
    steps = 6
    for seed, (name, kw, pools) in enumerate(cases, start=2):
        cfg = dataclasses.replace(get_config(name).reduced(), **kw)
        L = cfg.n_layers
        gen = torch.Generator(device="cuda").manual_seed(seed)
        params = decoder.init_params(cfg, gen, "cuda")
        cpu_params = params_from_numpy(params_to_numpy(params), "cpu")
        rng = np.random.default_rng(seed)
        prompts = [rng.integers(0, cfg.vocab, (1, n), dtype=np.int32)
                   for n in (2048, 5, 40)]
        want = expected_launches(cfg, prompts, steps)
        errs, ties = {}, {}
        for kv_dtype, tol in pools:
            runs, counts, recs = {}, {}, {}
            for device, p in (("cuda", params), ("cpu", cpu_params)):
                sim = Sim(seed=0)
                eng = BatchEngine(ShardModule(cfg, p, (0, L), True, True), sim,
                                  n_slots=4, page_size=32, kv_dtype=kv_dtype,
                                  device=device)
                ops.reset_launch_counts()
                with recording_gating() as recs[device]:
                    runs[device] = _drive(
                        eng, sim, prompts, steps,
                        None if device == "cuda" else runs["cuda"][4])
                counts[device] = ops.launch_counts()
            require(counts["cuda"] == want and not any(counts["cpu"].values()),
                    f"small_parity {name} {kv_dtype} launches: {counts}, "
                    f"want {want} on the card only")
            reach = routing_ties(recs["cuda"], recs["cpu"],
                                 [p.shape[1] for p in prompts], L, steps,
                                 cfg.moe_top_k)
            errs[kv_dtype] = logit_diff(runs["cuda"], runs["cpu"], reach)
            ties[kv_dtype] = reach
            require(errs[kv_dtype] <= tol, f"card vs CPU {name} {kv_dtype} "
                    f"logits differ by {errs[kv_dtype]}")
        emit({"phase": "small_parity", "config": f"{name} reduced(L={L}, "
              f"d={cfg.d_model}, vocab={cfg.vocab}"
              + (f", E={cfg.n_experts}, K={cfg.moe_top_k}, "
                 f"d_expert={cfg.d_expert})" if cfg.arch == "moe" else ")"),
              "launches_cuda": want, "max_abs_logit_err": errs,
              "tolerance": {k: t for k, t in pools},
              "routing_ties": {k: {str(s): t for s, t in r.items()}
                               for k, r in ties.items()}})


def serving_phase(torch, arch, phase):
    """Serve ``arch`` at full width and depth in fp32 through the fused
    engine, then replay its token feed through the per-slot path (the
    reference) and the int8 pool, and profile a few steps."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.simnet import Sim
    from repro_torch.kernels import ops
    from repro_torch.models import decoder
    from repro_torch.serving import BatchEngine, ShardModule
    from repro_torch.serving.sharded import _leaves

    cfg = get_config(arch)
    L = cfg.n_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = decoder.init_params(cfg, gen, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    module = ShardModule(cfg, params, (0, L), is_first=True, is_last=True)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, (1, n), dtype=np.int32)
               for n in SERVE_PROMPTS]
    want = expected_launches(cfg, prompts, SERVE_STEPS)

    sim = Sim(seed=0)
    eng = BatchEngine(module, sim, n_slots=8, page_size=32, device="cuda")
    ops.reset_launch_counts()
    with recording_gating() as rec:
        run = _drive(eng, sim, prompts, SERVE_STEPS)
    counts = ops.launch_counts()
    first, prefill_s, logits, step_s, feed = run
    pages_after = eng.stats["pages"]
    peak = torch.cuda.max_memory_allocated()
    require(pages_after == 0, f"pages after close: {pages_after}")
    require(counts == want, f"{arch} launches {counts} != {want}")
    for out in [first] + logits:
        require(out.shape == (len(prompts), cfg.vocab), f"shape {out.shape}")
        require(bool(np.isfinite(out).all()), "non-finite logits")
    emit({"phase": phase, "model": cfg.name, "n_layers": L,
          "d_model": cfg.d_model, "params": sum(
              t.numel() for t in _leaves(params)),
          "init_s": init_s, "prompts": SERVE_PROMPTS,
          "prefill_ms": [s * 1e3 for s in prefill_s],
          "decode_steps": SERVE_STEPS,
          "decode_ms_per_step_median": statistics.median(step_s) * 1e3,
          "tokens_per_s": len(prompts) * SERVE_STEPS / sum(step_s),
          "launches": counts, "pages_after_close": pages_after,
          "max_memory_allocated_bytes": peak})
    del eng
    torch.cuda.empty_cache()

    # replay the recorded feed: the per-slot path is the reference
    sim = Sim(seed=0)
    ref = BatchEngine(module, sim, n_slots=8, page_size=32, fused=False,
                      device="cuda")
    with recording_gating() as r_rec:
        r_run = _drive(ref, sim, prompts, SERVE_STEPS, feed)
    del ref
    torch.cuda.empty_cache()
    reach = routing_ties(rec, r_rec, SERVE_PROMPTS, L, SERVE_STEPS,
                         cfg.moe_top_k, b_per_slot=True)
    del rec, r_rec
    diff = logit_diff(run, r_run, reach)
    agree = float(np.mean([np.array_equal(np.argmax(a, -1), np.argmax(b, -1))
                           for a, b in zip(logits, r_run[2])]))
    require(diff <= 1e-3, f"fused vs per-slot logits differ by {diff}")

    sim = Sim(seed=0)
    q8 = BatchEngine(module, sim, n_slots=8, page_size=32, kv_dtype="int8",
                     device="cuda")
    _, _, q_logits, q_step_s, _ = _drive(q8, sim, prompts, SERVE_STEPS, feed)
    del q8
    torch.cuda.empty_cache()
    dev8 = max(float(np.abs(a - b).max()) for a, b in zip(q_logits, logits))
    emit({"phase": f"{phase}_replay",
          "per_slot_max_abs_logit_diff": diff, "tolerance": 1e-3,
          "per_slot_routing_ties": {str(s): t for s, t in reach.items()},
          "per_slot_greedy_agreement": agree,
          "per_slot_decode_ms_per_step_median":
              statistics.median(r_run[3]) * 1e3,
          "int8_max_abs_logit_dev": dev8,
          "int8_decode_ms_per_step_median": statistics.median(q_step_s) * 1e3})
    profile_decode(torch, module, prompts, feed)
    return counts


def profile_decode(torch, module, prompts, feed, steps: int = 4):
    """Where a fused decode step's time goes: ``torch.profiler`` over a
    few steps of the same feed; device busy share = summed kernel time
    over the window's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.simnet import Sim
    from repro_torch.serving import BatchEngine

    sim = Sim(seed=0)
    eng = BatchEngine(module, sim, n_slots=8, page_size=32, device="cuda")
    sessions = [f"s{i}" for i in range(len(prompts))]
    for sid, p in zip(sessions, prompts):
        sim.run_process(eng.open(sid, p, p.shape[1] + steps + 2))
    eng.step(sessions, feed[0])                 # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(steps):
            eng.step(sessions, feed[t + 1])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    eng.close(sessions)
    kernels = []          # device-side events only (ops would count twice)
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0:
            kernels.append((ev.self_device_time_total, ev.count, ev.key))
    kernels.sort(reverse=True)
    require(bool(kernels), "the profiler saw no device kernel")
    busy = sum(k[0] for k in kernels)
    emit({"phase": "decode_profile", "model": module.cfg.name, "steps": steps,
          "wall_ms_per_step": wall_us / steps / 1e3,
          "device_busy_ms_per_step": busy / steps / 1e3,
          "device_idle_share": 1.0 - busy / wall_us,
          "top_device_ops": [
              {"name": name[:80], "calls_per_step": n / steps,
               "ms_per_step": us / steps / 1e3}
              for us, n, name in kernels[:12]]})


def main() -> int:
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found beside this "
              "script", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    import repro_torch  # noqa: F401  (turns TF32 off)
    from repro_torch.kernels import build

    smi = nvidia_smi()
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    t0 = time.perf_counter()
    logs = build.build(verbose=True)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": {k: [ln for ln in v.splitlines() if "registers" in ln
                        or "spill" in ln] for k, v in logs.items()}})

    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")  # 256 MB
    paged = paged_phase(torch, flush)
    flash = flash_phase(torch, flush)
    gating = gating_phase(torch, flush)
    del flush
    small_parity_phase(torch)
    counts = serving_phase(torch, "granite-8b", "serving")
    # granite-8b's 33 GB and qwen2-moe-a2.7b's 57 GB do not fit one card
    # together: everything of the first model must be gone
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    require(held < 2 ** 30, f"{held} bytes still allocated before serving_moe")
    moe_counts = serving_phase(torch, "qwen2-moe-a2.7b", "serving_moe")

    emit({"kernels": [
        {"name": "paged_decode_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:116",
         "launches": counts["paged_decode_attention"],
         "max_abs_err": max(paged["max_abs_err"].values()),
         "ms": paged["kernel_ms"], "plain_ms": paged["plain_ms"],
         "bound_ms": paged["bound_ms"], "bound_by": "bytes",
         "library_ms": paged["library_ms"]},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:30",
         "launches": counts["flash_attention"],
         "max_abs_err": flash["max_abs_err_fp32"],
         "ms": flash["kernel_ms"], "plain_ms": flash["plain_ms"],
         "bound_ms": flash["bound_ms"], "bound_by": flash["bound_by"],
         "library_ms": flash["library_ms"]},
        {"name": "moe_gating", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/moe_gating.cu",
         "replaces": "src/repro/kernels/moe_gating.py:22",
         "launches": moe_counts["moe_gating"],
         "max_abs_err": gating["max_abs_err_all"],
         # times at T=8, the decode step that makes most of the launches
         "ms": gating["T8"]["kernel_ms"], "plain_ms": gating["T8"]["plain_ms"],
         "bound_ms": gating["T8"]["bound_ms"],
         "bound_by": gating["T8"]["bound_by"],
         "library_ms": gating["library_ms"]},
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
