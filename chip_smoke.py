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
   fp32 and int8, against ``paged_attention_plain`` on the card (1e-4),
   and over ``PAGED_CASES``: lengths either side of the split pass's
   4-page splits, one slot at 8191 beside empty ones, a block table far
   wider than any length with its padding on poisoned pages,
   qwen2-moe-a2.7b's H=16, Hk=16, and every slot at 8191; two launches
   must agree to the bit; timed with cold L2 at today's shape, qwen2-moe's
   and all-8191, each beside its bytes bound, today's shape also with a
   clean cold L2 and with every length 0 (the floor); the split pass's
   shared memory and resident blocks, and both passes' ptxas registers and
   spills;
4. flash_attention — the kernel at hd=128 over ``FLASH_CASES`` (B=1, H=32,
   S=2048 causal, window 128, 17, a ragged S=2050, non-causal; ragged 97
   with B=2; window 1; the serving layout's repeated k/v; q x 8), fp32
   and bf16, against ``flash_attention_plain``; timed at granite-8b's
   (H=32) and qwen2-moe-a2.7b's (H=16) causal prefill of 2048 tokens,
   with ``scaled_dot_product_attention`` beside it as a yardstick only,
   and the kernel's ptxas registers, spills and shared memory;
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
   and a profile of a few steps;
9. serving_xlstm — qwen2-moe-a2.7b released, then xlstm-1.3b at full width
   and depth in fp32 (5.64 B parameters) served per slot, every prefill's
   mLSTM layers through the mLSTM kernel, under gate G3; then the state
   handoff, layer by layer and end to end, with gate G1 on the kernel's
   real inputs in every mLSTM layer, and a profile of a few steps.

The mlstm phase (after moe_gating) holds the mLSTM kernel to gate G1 at
xlstm-1.3b's widths and reports its two kernels' ptxas registers, spills
and shared memory, and small_parity also serves a reduced xlstm-1.3b on
the card and on the CPU in float32 and float64 under gate G2.  The gates'
bounds are fixed in advance, each derived from a float64 reference:

* G1, kernel vs plain, on the card: with ``ref`` the plain version in
  float64 and ``p32`` the plain version in float32 on the same inputs,
  max|h - ref| <= 2 max|h_p32 - ref| + 1e-6 max|ref|; C and n within
  2e-5 of their largest reference entry; |m - m_ref| <= 2e-5 max(1,
  |m_ref|).
* G2, reduced xlstm-1.3b, card vs CPU, over every prefill's and step's
  logits: max|card32 - cpu64| <= max(1e-4, 2 max|cpu32 - cpu64|).
* G3, full width on the card: finite logits; mlstm_scan launched 42 times
  per prefill of the served run; pages 0 after close; 807,666,432 state
  bytes per session; fed each layer the same input, prefill(2047) + one
  decode step against prefill(2048) leaves the mLSTM C and n and the
  sLSTM c, n and h within 1e-4 of their largest entry and every m within
  1e-4; and the end-to-end logits of the two routes differ by no more
  than one ulp of the input embeddings moves prefill(2048)'s.

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
import re
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
#: xlstm-1.3b: one 2048-token prompt (8 chunks of 256 in the JAX model),
#: one ragged (one chunk of 300) and six short ones
XLSTM_PROMPTS = [2048, 300, 12, 37, 64, 100, 200, 256]
#: the reduced xlstm's prompts: the ragged W = S form and two full chunks
XLSTM_SMALL_PROMPTS = [12, 37, 64, 100, 200, 256, 300, 512]
XLSTM_SMALL_STEPS = 16
#: xlstm-1.3b's recurrent state of one session: per layer C (4, 1024,
#: 1024), n (4, 1024), m (4) and the sLSTM's four (4, 512), in fp32
XLSTM_STATE_BYTES = 807_666_432
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


def time_ms(torch, fn, iters: int = 20, warmup: int = 3, flush=None,
            flush_by_read: bool = False) -> float:
    """Median CUDA-event time of ``fn`` in ms; with ``flush``, a buffer
    larger than L2 is rewritten before each launch (cold caches, L2 full of
    dirty lines that ``fn``'s reads write back), or with ``flush_by_read``
    read instead (cold and clean)."""
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(iters):
        if flush is not None:
            flush.sum() if flush_by_read else flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


# --------------------------------------------------------------- kernels

def paged_inputs(torch, lengths, H, Hk, page=32, hd=128, width=None,
                 spare=16, seed=0):
    """A pool on the card with ragged lengths: every row a slot does not
    own below its length is poisoned (large and finite), and ``spare``
    pages no slot owns.  The block table is ``width`` pages wide (default:
    the widest slot's), and its padding is page 0, or with ``width`` the
    poisoned spare pages.  Returns the fp32 and int8 argument tuples."""
    import numpy as np

    from repro_torch.serving.batch import _quant_page_int8

    dev = torch.device("cuda")
    M = len(lengths)
    # the engine allocates the current token's page before the step
    owned = [-(-(L + 1) // page) for L in lengths]
    NP = width or max(owned)
    P = sum(owned) + spare
    rng = np.random.default_rng(seed)
    perm = rng.permutation(P)
    bt = np.zeros((M, NP), np.int32)
    live = np.zeros((P, page), bool)
    at = 0
    for m, (L, n) in enumerate(zip(lengths, owned)):
        bt[m, :n] = perm[at:at + n]
        if width:
            bt[m, n:] = perm[sum(owned):][np.arange(NP - n) % spare]
        at += n
        for t in range(L):
            live[bt[m, t // page], t % page] = True
    g = torch.Generator(device=dev).manual_seed(seed)
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
    return ((q, kp, vp, bt_t, len_t, kn, vn),
            (q, kq, vq, bt_t, len_t, kn, vn, ks, vs))


def paged_bound_ms(lengths, H, Hk, hd=128, page=32, itemsize=4,
                   scales=False) -> float:
    """Least time of one call: each live K/V row, each live page's scales
    and block-table entry, q, out, k/v_new and lengths moved once."""
    M = len(lengths)
    pages_read = sum(-(-L // page) for L in lengths)
    fixed = (2 * M * H * hd + 2 * M * Hk * hd) * 4 + M * 4 + pages_read * 4
    kv = sum(lengths) * Hk * hd * 2 * itemsize
    sc = pages_read * Hk * 4 * 2 if scales else 0
    return (kv + sc + fixed) / HBM_BYTES_PER_S * 1e3


#: the split pass's edges (name: H, Hk, lengths, table width), held against
#: the plain version like today's shape: lengths either side of the 4-page
#: (128-row) splits granite-8b's decode plans, one slot at 8191 beside
#: empty ones, a table far wider than any length whose padding points at
#: poisoned pages, qwen2-moe-a2.7b's heads, and every slot at 8191
PAGED_CASES = {
    "split_edges": (32, 8, [127, 128, 129, 255, 256, 257, 0, 1], None),
    "long_8191": (32, 8, [8191, 0, 0, 0, 0, 0, 0, 0], None),
    "wide_table": (32, 8, [0, 5, 40, 100, 31, 64, 1, 33], 256),
    "qwen_heads": (16, 16, PAGED_LENGTHS, None),
    "all_8191": (32, 8, [8191] * 8, None),
}
#: cases timed beside today's shape, each in fp32 and int8
PAGED_TIMED = ("qwen_heads", "all_8191")


def paged_check(torch, pa, name, fp32, int8) -> dict:
    """max |kernel - plain| in fp32 and int8; finite outputs."""
    err = {}
    for kind, args in (("fp32", fp32), ("int8", int8)):
        got = pa.paged_attention_cuda(*args)
        want = pa.paged_attention_plain(*args)
        torch.cuda.synchronize()
        require(bool(torch.isfinite(got).all()),
                f"paged {name} {kind}: non-finite")
        err[kind] = (got - want).abs().max().item()
    return err


def paged_ptxas(log: str) -> dict:
    """ptxas's report of each paged kernel instantiation."""
    def key_of(name):
        m = re.search(r"paged_(split|merge)_kernelI(?:([fa])Li(\d+)ELi(\d+)E"
                      r"|Li(\d+)ELi(\d+)E)", name)
        if m is None:
            return None
        if m.group(1) == "split":
            kind = "fp32" if m.group(2) == "f" else "int8"
            return f"split_{kind}_hd{m.group(3)}_rep{m.group(4)}"
        return f"merge_hd{m.group(5)}_rep{m.group(6)}"
    return ptxas_report(log, key_of)


def paged_phase(torch, flush, build_log: str = ""):
    from repro_torch.kernels import paged_attention as pa

    M, H, Hk, hd, page = 8, 32, 8, 128, 32
    lengths = PAGED_LENGTHS
    fp32, int8 = paged_inputs(torch, lengths, H, Hk)
    err = paged_check(torch, pa, "today", fp32, int8)
    # tolerance: fp32 sums over up to ~8k keys in another order
    require(max(err.values()) <= 1e-4, f"paged kernel disagrees: {err}")
    cases = {}
    for name, (h, hk, lens, width) in PAGED_CASES.items():
        c32, c8 = paged_inputs(torch, lens, h, hk, width=width)
        e = paged_check(torch, pa, name, c32, c8)
        require(max(e.values()) <= 1e-4, f"paged {name} disagrees: {e}")
        cases[name] = {"H": h, "Hk": hk, "lengths": lens, "table_width":
                       c32[3].shape[1], "pages_per_split": pa.split_pages(
                           c32[3].shape[1], page, len(lens), hk),
                       "max_abs_err": e}
        if name in PAGED_TIMED:
            cases[name].update(
                kernel_ms=time_ms(torch, lambda: pa.paged_attention_cuda(*c32),
                                  flush=flush),
                kernel_int8_ms=time_ms(
                    torch, lambda: pa.paged_attention_cuda(*c8), flush=flush),
                bound_ms=paged_bound_ms(lens, h, hk),
                bound_int8_ms=paged_bound_ms(lens, h, hk, itemsize=1,
                                             scales=True))
        del c32, c8
    # no atomics: a second launch on the same inputs is equal to the bit
    repeat = {}
    for kind, args in (("fp32", fp32), ("int8", int8)):
        a = pa.paged_attention_cuda(*args)
        b = pa.paged_attention_cuda(*args)
        torch.cuda.synchronize()
        repeat[kind] = bool(torch.equal(a, b))
    require(all(repeat.values()), f"paged kernel not bit-repeatable: {repeat}")

    empty = (*fp32[:4], torch.zeros_like(fp32[4]), *fp32[5:])
    res = {
        "max_abs_err": err,
        "kernel_ms": time_ms(torch, lambda: pa.paged_attention_cuda(*fp32),
                             flush=flush),
        "kernel_int8_ms": time_ms(torch, lambda: pa.paged_attention_cuda(*int8),
                                  flush=flush),
        "plain_ms": time_ms(torch, lambda: pa.paged_attention_plain(*fp32),
                            iters=5, flush=flush),
        # the same launch with L2 evicted by a read: no dirty lines to write
        # back, as in a decode step, where L2 holds mostly weights
        "kernel_clean_l2_ms": time_ms(
            torch, lambda: pa.paged_attention_cuda(*fp32), flush=flush,
            flush_by_read=True),
        # both passes over the same table with every length 0: launches,
        # empty splits and the merge, with no cached row
        "floor_ms": time_ms(torch, lambda: pa.paged_attention_cuda(*empty),
                            flush=flush),
        "bound_ms": paged_bound_ms(lengths, H, Hk),
        "bound_int8_ms": paged_bound_ms(lengths, H, Hk, itemsize=1,
                                        scales=True),
        # no single PyTorch call computes attention through a block table
        "library_ms": None,
    }
    emit({"phase": "paged_decode_attention", "M": M, "H": H, "Hk": Hk,
          "hd": hd, "page": page, "lengths": lengths,
          "pages_per_split": pa.split_pages(fp32[3].shape[1], page, M, Hk),
          **res, "bit_repeat": repeat, "cases": cases,
          "split_config": {f"{k}_rep{r}": pa.split_config(k == "int8", hd, r)
                           for k in ("fp32", "int8") for r in (4, 1)},
          "ptxas": paged_ptxas(build_log)})
    return res


def ptxas_report(log: str, key_of) -> dict:
    """Registers, static shared memory, spill bytes and stack of each entry
    function that ``key_of`` names (mangled name -> key, or None to skip),
    from an ``-Xptxas -v`` build log (empty when nothing was built)."""
    res, key = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            key = key_of(m.group(1))
            if key is not None:
                res[key] = {}
            continue
        if key is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            res[key].update(stack_bytes=int(m.group(1)),
                            spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            smem = re.search(r"(\d+) bytes smem", ln)
            res[key].update(registers=int(m.group(1)), static_smem_bytes=int(
                smem.group(1)) if smem else 0)
            key = None
    return res


def flash_ptxas(log: str) -> dict:
    """ptxas's report of each flash kernel instantiation."""
    def key_of(name):
        if "flash_fwd_kernel" not in name:
            return None
        hd = re.search(r"Li(\d+)EE", name).group(1)
        return ("bf16" if "bfloat16" in name else "fp32") + f"_hd{hd}"
    return ptxas_report(log, key_of)


def mlstm_ptxas(log: str) -> dict:
    """ptxas's report of the mLSTM scan's two kernels."""
    return ptxas_report(log, lambda name: "prep" if "mlstm_prep_kernel" in name
                        else "walk" if "mlstm_walk_kernel" in name else None)


#: (name, B, H, Sq, Sk, causal, window, form): the served prefill, ragged
#: tiles, narrow windows, a batch, the serving layout ("gqa": k/v of
#: (B, S, H/4, hd) repeat_interleaved, as models/common.py builds them)
#: and large scores ("large": q x 8, where the running-max rescale matters)
FLASH_CASES = [("causal", 1, 32, 2048, 2048, True, 0, "bshd"),
               ("window128", 1, 32, 2048, 2048, True, 128, "bshd"),
               ("ragged", 1, 32, 2050, 2050, True, 0, "bshd"),
               ("noncausal", 1, 32, 128, 2048, False, 0, "bshd"),
               ("ragged97_B2", 2, 8, 97, 97, True, 0, "bshd"),
               ("window17", 1, 32, 2048, 2048, True, 17, "bshd"),
               ("window1", 1, 8, 300, 300, True, 1, "bshd"),
               ("gqa", 1, 32, 2048, 2048, True, 0, "gqa"),
               ("large", 1, 32, 2048, 2048, True, 0, "large")]


def flash_inputs(torch, B, H, Sq, Sk, hd, dtype, form, g):
    """q, k, v on the card in the main path's layout: (B, S, H, hd) viewed
    as (B, H, S, hd)."""
    q, k, v = (torch.randn((B, S, H, hd), generator=g, device="cuda")
               .to(dtype).transpose(1, 2) for S in (Sq, Sk, Sk))
    if form == "gqa":
        k, v = (torch.repeat_interleave(t.transpose(1, 2)[:, :, ::4], 4, dim=2)
                .transpose(1, 2) for t in (k, v))
    elif form == "large":
        q = q * 8
    return q, k, v


def flash_phase(torch, flush, build_log: str):
    import ctypes

    import torch.nn.functional as F

    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    hd = 128
    g = torch.Generator(device="cuda").manual_seed(1)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, B, H, Sq, Sk, causal, window, form in FLASH_CASES:
            q, k, v = flash_inputs(torch, B, H, Sq, Sk, hd, dtype, form, g)
            got = fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
            want = fa.flash_attention_plain(q, k, v, causal=causal,
                                            window=window)
            torch.cuda.synchronize()
            key = f"{name}_{str(dtype).split('.')[1]}"
            require(bool(torch.isfinite(got.float()).all()), f"flash {key}")
            errs[key] = (got.float() - want.float()).abs().max().item()
            tol = 1e-4 if dtype == torch.float32 else 2e-2
            require(errs[key] <= tol, f"flash {key}: err {errs[key]} > {tol}")

    def timed(B, H, S, dtype=torch.float32):
        """Kernel, plain and SDPA times at a causal prefill of S tokens,
        and the bound: only the unmasked pairs' FLOP, each input read and
        the output written once."""
        q, k, v = flash_inputs(torch, B, H, S, S, hd, dtype, "bshd", g)
        flops = 4 * B * H * hd * (S * (S + 1) // 2)
        nbytes = 4 * B * H * S * hd * q.element_size()
        peak = PEAK_FLOPS[str(dtype).split(".")[1]]
        res = {"kernel_ms": time_ms(
            torch, lambda: fa.flash_attention_cuda(q, k, v), flush=flush)}
        if dtype == torch.float32:
            res["plain_ms"] = time_ms(
                torch, lambda: fa.flash_attention_plain(q, k, v), iters=5,
                flush=flush)
            res["library_ms"] = time_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True), flush=flush)
        res["bound_ms"] = max(flops / peak, nbytes / HBM_BYTES_PER_S) * 1e3
        res["bound_by"] = ("operations" if flops / peak
                           >= nbytes / HBM_BYTES_PER_S else "bytes")
        return res

    # the main path's case: granite-8b's causal fp32 prefill of 2048 tokens
    B, H, S = 1, 32, 2048
    res = {"max_abs_err": errs,
           "max_abs_err_fp32": max(v for k, v in errs.items()
                                   if k.endswith("float32")),
           **timed(B, H, S)}
    bf16 = timed(B, H, S, torch.bfloat16)
    res["kernel_bf16_ms"] = bf16["kernel_ms"]
    res["bound_bf16_ms"] = bf16["bound_ms"]
    # qwen2-moe-a2.7b's prefill: 16 heads
    res["H16"] = timed(B, 16, S)
    lib = build.load("flash_attention", fa._SIGNATURES)
    smem = lib.repro_flash_attention_smem_bytes
    smem.restype, smem.argtypes = ctypes.c_int, [ctypes.c_int]
    res["ptxas"] = flash_ptxas(build_log)
    res["dynamic_smem_bytes"] = {f"hd{d}": smem(d) for d in (64, 128)}
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


def mlstm_inputs(torch, B, H, S, hd, state, g):
    """The JAX kernel test's distributions, on the card: q, k (pre-scaled
    by 1/sqrt(hd)), v, log i ~ N(0,1), log f = log_sigmoid(N(0,1) + 2);
    the start state "empty" (m = -1e30), "cache" (a serving cache's zeros,
    m = 0) or "warm" (0.1·N(0,1) memory, m = 0.5)."""
    dev = "cuda"
    q, k, v = (torch.randn((B, H, S, hd), generator=g, device=dev)
               for _ in range(3))
    li = torch.randn((B, H, S), generator=g, device=dev)
    lf = torch.nn.functional.logsigmoid(
        torch.randn((B, H, S), generator=g, device=dev) + 2.0)
    C0 = torch.zeros((B, H, hd, hd), device=dev)
    n0 = torch.zeros((B, H, hd), device=dev)
    if state == "warm":
        C0 = 0.1 * torch.randn((B, H, hd, hd), generator=g, device=dev)
        n0 = 0.1 * torch.randn((B, H, hd), generator=g, device=dev)
    m0 = torch.full((B, H), {"empty": -1e30, "cache": 0.0, "warm": 0.5}[state],
                    device=dev)
    return [q, k / hd ** 0.5, v, li, lf, C0, n0, m0]


def mlstm_g1(torch, out, args):
    """Gate G1 on the kernel's outputs ``out`` for ``args``: the plain
    version in float64 on the card is ``ref``, in float32 ``p32``.  h:
    max|h - ref| <= 2 max|h_p32 - ref| + 1e-6 max|ref|; C and n within
    2e-5 of their largest reference entry; m within 2e-5 max(1, |m_ref|).
    Returns the readings, each ``*_over_limit`` <= 1 on a pass."""
    from repro_torch.kernels import mlstm_scan as ms

    p32 = ms.mlstm_scan_plain(*args)
    ref = ms.mlstm_scan_plain(*(a.double() for a in args))
    torch.cuda.synchronize()
    require(all(bool(torch.isfinite(t).all()) for t in out),
            "mlstm: non-finite kernel output")

    def err(a, b):
        return (a.double() - b).abs().max().item()

    h_abs, p32_abs = err(out[0], ref[0]), err(p32[0], ref[0])
    h_limit = 2 * p32_abs + 1e-6 * ref[0].abs().max().item()
    res = {"h_abs": h_abs, "h_plain_fp32_abs": p32_abs, "h_limit": h_limit,
           "h_over_limit": h_abs / h_limit}
    for name, a, b in zip("Cn", out[1:3], ref[1:3]):
        res[f"{name}_rel"] = err(a, b) / b.abs().max().item()
        res[f"{name}_over_limit"] = res[f"{name}_rel"] / 2e-5
    res["m_abs"] = err(out[3], ref[3])
    res["m_over_limit"] = ((out[3].double() - ref[3]).abs()
                           / (2e-5 * ref[3].abs().clamp_min(1.0))).max().item()
    return res


def g1_holds(res) -> bool:
    return all(v <= 1.0 for k, v in res.items() if k.endswith("_over_limit"))


def mlstm_work(B, H, S, hd, W):
    """The least work of the scan in chunks of W rows: per head and row
    q·C and the update's (k·wk)ᵀ·v (2 hd² FLOP each), and per chunk of Wc
    rows the causal half of q kᵀ and of P·v (hd Wc (Wc + 1) FLOP each);
    the bytes each input and output moves once; and, for comparison with
    earlier rows, the TPU kernel's four products at full W x W (no causal
    saving) with W by the model's chunk rule."""
    chunks = [min(W, S - t0) for t0 in range(0, S, W)]
    flops = B * H * (4 * S * hd * hd
                     + 2 * hd * sum(w * (w + 1) for w in chunks))
    nbytes = 4 * (4 * B * H * S * hd + 2 * B * H * S + 2 * B * H * hd * hd
                  + 2 * B * H * hd + 2 * B * H)
    Wt = 256 if S % 256 == 0 else S
    flops_w256 = B * H * (S // Wt) * (4 * Wt * Wt * hd + 4 * Wt * hd * hd)
    return flops, nbytes, flops_w256


#: (name, B, H, S, hd, start): xlstm-1.3b's widths (H = 4, hd = 1024) for
#: a 2048-token prompt from a serving cache, a ragged prompt, a batch from
#: a warm state and one decode row, then the JAX kernel test's fp32 shapes
MLSTM_CASES = [("S2048_cache", 1, 4, 2048, 1024, "cache"),
               ("S300_cache", 1, 4, 300, 1024, "cache"),
               ("B2_S512_warm", 2, 4, 512, 1024, "warm"),
               ("S1_warm", 1, 4, 1, 1024, "warm"),
               ("jax_1x1x128x64", 1, 1, 128, 64, "empty"),
               ("jax_2x2x256x64", 2, 2, 256, 64, "empty"),
               ("jax_1x2x256x128", 1, 2, 256, 128, "empty"),
               ("jax_2x1x512x256", 2, 1, 512, 256, "empty")]


def prep_ms(torch, lib, args, flush) -> float:
    """Time of the mLSTM kernel's first pass alone (a part of the scan's
    time), launched through its C entry with the scratch made beforehand,
    so that the wrapper's host work is not timed."""
    from repro_torch.kernels import mlstm_scan as ms

    q, k, _, li, lf, _, _, m0 = args
    B, H, S, hd = q.shape
    buf = torch.empty(ms.scratch_layout(lib, B * H, S, hd)[1][-1],
                      device="cuda")
    m_T = torch.empty_like(m0)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        require(lib.repro_mlstm_prep(
            q.data_ptr(), k.data_ptr(), li.data_ptr(), lf.data_ptr(),
            m0.data_ptr(), buf.data_ptr(), m_T.data_ptr(), B * H, S, hd,
            stream) == 0, "mlstm prep launch failed")
    return time_ms(torch, run, iters=10, flush=flush)


def mlstm_phase(torch, flush, build_log: str):
    """The mLSTM kernel under gate G1 at every case, with its time (cold
    L2) and its first pass's, the plain version's, the bound from the
    scan's least work at the kernel's chunk width (and, beside it, from
    the TPU kernel's work, as earlier rows were), and ptxas's report of
    its two kernels."""
    from repro_torch.kernels import build
    from repro_torch.kernels import mlstm_scan as ms

    lib = build.load("mlstm_scan", ms._SIGNATURES)
    g = torch.Generator(device="cuda").manual_seed(4)
    cases = {}
    for name, B, H, S, hd, start in MLSTM_CASES:
        args = mlstm_inputs(torch, B, H, S, hd, start, g)
        res = mlstm_g1(torch, ms.mlstm_scan_cuda(*args), args)
        require(g1_holds(res), f"mlstm {name}: gate G1 fails: {res}")
        W = ms.scratch_layout(lib, B * H, S, hd)[0]
        flops, nbytes, flops_w256 = mlstm_work(B, H, S, hd, W)
        t_ops = flops / PEAK_FLOPS["float32"]
        t_bytes = nbytes / HBM_BYTES_PER_S
        res.update({
            "kernel_ms": time_ms(torch, lambda: ms.mlstm_scan_cuda(*args),
                                 iters=10, flush=flush),
            "prep_ms": prep_ms(torch, lib, args, flush),
            "plain_ms": time_ms(torch, lambda: ms.mlstm_scan_plain(*args),
                                iters=5, flush=flush),
            "chunk": W, "flop": flops, "bytes": nbytes,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flop_w256": flops_w256,
            "bound_ms_w256": max(flops_w256 / PEAK_FLOPS["float32"],
                                 t_bytes) * 1e3})
        cases[name] = res
        del args
    # no single PyTorch call computes the chunkwise mLSTM recurrence
    emit({"phase": "mlstm", "cases": cases, "ptxas": mlstm_ptxas(build_log),
          "walk_dynamic_smem_bytes": lib.repro_mlstm_walk_smem_bytes(1024),
          "library_ms": None})
    return cases


# --------------------------------------------------------------- serving

def _drive(eng, sim, prompts, steps, feed=None):
    """Open every session, decode ``steps`` greedy steps (or replay
    ``feed``), close.  Returns per-prompt prefill logits and seconds, the
    per-step logits and seconds, the token feed, and each session's cache
    bytes before the close."""
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
    held = [eng._slot_kv_bytes(eng.by_session[sid]) for sid in sessions]
    eng.close(sessions)
    return np.stack(first), prefill_s, logits, step_s, fed, held


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
    step, flash per layer per long prompt, gating per layer per pass; for
    xLSTM (no attention, served per slot) the mLSTM scan per mLSTM layer
    per prefill, since a prefill against the cache takes the chunkwise
    form, and none in decode."""
    from repro_torch.models import decoder

    L = cfg.n_layers
    if cfg.arch == "ssm":
        n_mlstm = sum(not decoder._is_slstm(cfg, j) for j in range(L))
        return {"paged_decode_attention": 0, "flash_attention": 0,
                "moe_gating": 0, "mlstm_scan": n_mlstm * len(prompts)}
    n_long = sum(p.shape[1] >= 2048 for p in prompts)
    return {"paged_decode_attention": L * steps, "flash_attention": L * n_long,
            "moe_gating": L * (len(prompts) + steps) if cfg.arch == "moe" else 0,
            "mlstm_scan": 0}


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


def xlstm_parity_phase(torch):
    """Gate G2: a reduced xlstm-1.3b (L=8, so block 7 is the sLSTM;
    d=256, vocab 512, mLSTM head dim 128) served through ``BatchEngine``
    on the card in float32, then on the CPU in float32 and in float64 on
    the same weights and the card's greedy feed.  Over every prefill's
    and step's logits: max|card32 - cpu64| <= max(1e-4, 2 max|cpu32 -
    cpu64|).  The card launches the mLSTM kernel in the 7 mLSTM layers of
    every prefill, the CPU never."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.simnet import Sim
    from repro_torch.kernels import ops
    from repro_torch.models import decoder
    from repro_torch.params import params_from_numpy, params_to_numpy
    from repro_torch.serving import BatchEngine, ShardModule

    cfg = get_config("xlstm-1.3b").reduced(n_layers=8)
    L = cfg.n_layers
    gen = torch.Generator(device="cuda").manual_seed(5)
    params = decoder.init_params(cfg, gen, "cuda")
    tree = params_to_numpy(params)
    runs = {"card32": params,
            "cpu32": params_from_numpy(tree, "cpu"),
            "cpu64": params_from_numpy(_cast_tree(tree, np.float64), "cpu")}
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, (1, n), dtype=np.int32)
               for n in XLSTM_SMALL_PROMPTS]
    want = expected_launches(cfg, prompts, XLSTM_SMALL_STEPS)
    require(want["mlstm_scan"] == 7 * len(prompts), f"launches {want}")
    out, counts = {}, {}
    for name, p in runs.items():
        sim = Sim(seed=0)
        eng = BatchEngine(ShardModule(cfg, p, (0, L), True, True), sim,
                          n_slots=len(prompts), page_size=32,
                          device="cuda" if name == "card32" else "cpu")
        require(not eng.fused, "xlstm must serve per slot")
        ops.reset_launch_counts()
        out[name] = _drive(eng, sim, prompts, XLSTM_SMALL_STEPS,
                           None if name == "card32" else out["card32"][4])
        counts[name] = ops.launch_counts()
    require(counts["card32"] == want, f"card launches {counts['card32']}, "
            f"want {want}")
    require(not any(counts["cpu32"].values())
            and not any(counts["cpu64"].values()),
            f"the CPU runs launched kernels: {counts}")
    require(out["cpu64"][0].dtype == np.float64, "the fp64 run is not fp64")

    def diffs(a, b):          # max |a - b| per prefill row and per step
        return ([float(np.abs(a[0][i] - b[0][i]).max())
                 for i in range(len(prompts))]
                + [float(np.abs(x - y).max()) for x, y in zip(a[2], b[2])])

    card = diffs(out["card32"], out["cpu64"])
    cpu = diffs(out["cpu32"], out["cpu64"])
    limit = max(1e-4, 2 * max(cpu))
    emit({"phase": "small_parity", "config": f"xlstm-1.3b reduced(L={L}, "
          f"d={cfg.d_model}, vocab={cfg.vocab}, slstm_every="
          f"{cfg.slstm_every})", "prompts": XLSTM_SMALL_PROMPTS,
          "decode_steps": XLSTM_SMALL_STEPS, "launches_cuda": want,
          "max_abs_logit_err": {"card32_vs_cpu64": max(card),
                                "cpu32_vs_cpu64": max(cpu)},
          "g2_limit": limit, "card32_vs_cpu64_per_call": card,
          "cpu32_vs_cpu64_per_call": cpu})
    require(max(card) <= limit, f"gate G2 fails: card32 vs cpu64 {max(card)} "
            f"> {limit}")


def _cast_tree(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast_tree(v, dtype) for v in tree]
    return tree.astype(dtype)


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
    from repro_torch.serving.sharded import leaves

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
    first, prefill_s, logits, step_s, feed, _ = run
    pages_after = eng.stats["pages"]
    peak = torch.cuda.max_memory_allocated()
    require(pages_after == 0, f"pages after close: {pages_after}")
    require(counts == want, f"{arch} launches {counts} != {want}")
    for out in [first] + logits:
        require(out.shape == (len(prompts), cfg.vocab), f"shape {out.shape}")
        require(bool(np.isfinite(out).all()), "non-finite logits")
    emit({"phase": phase, "model": cfg.name, "n_layers": L,
          "d_model": cfg.d_model, "params": sum(
              t.numel() for t in leaves(params)),
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
    _, _, q_logits, q_step_s, _, _ = _drive(q8, sim, prompts, SERVE_STEPS,
                                            feed)
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


@contextlib.contextmanager
def recording_mlstm():
    """Keep every mLSTM scan's (inputs, outputs) in call order; the
    counted kernel wrapper still does the work."""
    from repro_torch.kernels import ops

    real, rec = ops.mlstm_scan, []

    def record(*args):
        out = real(*args)
        rec.append((args, out))
        return out

    ops.mlstm_scan = record
    try:
        yield rec
    finally:
        ops.mlstm_scan = real


def serving_xlstm_phase(torch):
    """Serve xlstm-1.3b at full width and depth in fp32 through the
    per-slot engine, every prefill's mLSTM layers through the kernel, under
    gate G3; then the state handoff checks (G3) with gate G1 on the
    kernel's real inputs, and a profile of a few decode steps."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.simnet import Sim
    from repro_torch.kernels import ops
    from repro_torch.models import decoder
    from repro_torch.serving.sharded import leaves
    from repro_torch.serving import BatchEngine, ShardModule

    cfg = get_config("xlstm-1.3b")
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
               for n in XLSTM_PROMPTS]
    want = expected_launches(cfg, prompts, SERVE_STEPS)
    require(want["mlstm_scan"] == 42 * len(prompts), f"launches {want}")

    sim = Sim(seed=0)
    eng = BatchEngine(module, sim, n_slots=8, page_size=32, device="cuda")
    require(not eng.fused, "xlstm must serve per slot")
    ops.reset_launch_counts()
    first, prefill_s, logits, step_s, feed, held = _drive(
        eng, sim, prompts, SERVE_STEPS)
    counts = ops.launch_counts()
    pages_after = eng.stats["pages"]
    peak = torch.cuda.max_memory_allocated()
    del eng
    emit({"phase": "serving_xlstm", "model": cfg.name, "n_layers": L,
          "d_model": cfg.d_model,
          "params": sum(t.numel() for t in leaves(params)),
          "init_s": init_s, "prompts": XLSTM_PROMPTS,
          "prefill_ms": [t * 1e3 for t in prefill_s],
          "decode_steps": SERVE_STEPS,
          "decode_ms_per_step_median": statistics.median(step_s) * 1e3,
          "tokens_per_s": len(prompts) * SERVE_STEPS / sum(step_s),
          "launches": counts, "pages_after_close": pages_after,
          "state_bytes_per_session": held,
          "max_memory_allocated_bytes": peak})
    for out in [first] + logits:
        require(out.shape == (len(prompts), cfg.vocab), f"shape {out.shape}")
        require(bool(np.isfinite(out).all()), "non-finite logits")
    require(counts == want, f"xlstm launches {counts} != {want}")
    require(pages_after == 0, f"pages after close: {pages_after}")
    require(held == [XLSTM_STATE_BYTES] * len(prompts),
            f"state bytes per session {held}")

    tokens = torch.from_numpy(prompts[0]).cuda()          # the 2048 prompt
    handoff_by_layer(torch, cfg, params, tokens)
    handoff_end_to_end(torch, cfg, params, tokens)
    profile_decode(torch, module, prompts, feed)
    return counts


def handoff_by_layer(torch, cfg, params, tokens):
    """Gate G3's handoff, layer by layer: each layer, fed the input that
    prefill(2048) gives it, runs prefill(2048) and prefill(2047) + one
    decode step from a fresh cache; the mLSTM C and n and the sLSTM c, n
    and h agree within 1e-4 of their largest entry, every m within 1e-4.
    The prefill(2048) pass is also where every mLSTM layer's real inputs
    hold the kernel to gate G1, and its layer times give the sLSTM's
    share."""
    import dataclasses

    from repro_torch.models import decoder

    one = dataclasses.replace(cfg, n_layers=1)
    S = tokens.shape[1]
    x = params["embed"][tokens.long()]
    pos = torch.arange(S, device="cuda")[None]
    worst = {"state_rel": 0.0, "m_abs": 0.0}
    g1_worst = {}
    ms_by_kind = {"mlstm": [], "slstm": []}

    def fresh():
        return decoder.init_cache(one, 1, S + 1, device="cuda")["layers"][0]

    for j, bp in enumerate(params["blocks"]):
        kind = "slstm" if decoder._is_slstm(cfg, j) else "mlstm"
        with recording_mlstm() as rec:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x_next, whole, _ = decoder.run_block(cfg, bp, x, pos, fresh(), 0,
                                                 layer_idx=j)
            torch.cuda.synchronize()
            ms_by_kind[kind].append((time.perf_counter() - t0) * 1e3)
        require(len(rec) == (kind == "mlstm"), f"layer {j}: {len(rec)} scans")
        for args, out in rec:
            res = mlstm_g1(torch, out, args)
            require(g1_holds(res), f"layer {j}: gate G1 fails on the real "
                    f"inputs: {res}")
            for k, v in res.items():
                g1_worst[k] = max(g1_worst.get(k, 0.0), v)
        del rec
        _, part, _ = decoder.run_block(cfg, bp, x[:, :S - 1], pos[:, :S - 1],
                                       fresh(), 0, layer_idx=j)
        _, part, _ = decoder.run_block(cfg, bp, x[:, S - 1:], pos[:, S - 1:],
                                       part, S - 1, layer_idx=j)
        keys = (("C", "n"), "m") if kind == "mlstm" else (("sc", "sn", "sh"),
                                                          "sm")
        for key in keys[0]:
            a, b = part[key], whole[key]
            rel = ((a - b).abs().max() / b.abs().max()).item()
            worst["state_rel"] = max(worst["state_rel"], rel)
            require(rel <= 1e-4, f"layer {j} {key}: handoff differs by {rel} "
                    "of its largest entry")
        m_abs = (part[keys[1]] - whole[keys[1]]).abs().max().item()
        worst["m_abs"] = max(worst["m_abs"], m_abs)
        require(m_abs <= 1e-4, f"layer {j} {keys[1]}: handoff differs by "
                f"{m_abs}")
        x = x_next
    total = sum(sum(v) for v in ms_by_kind.values())
    emit({"phase": "xlstm_handoff_by_layer", "S": S, **worst,
          "tolerance": {"state_rel": 1e-4, "m_abs": 1e-4},
          "mlstm_g1_real_inputs_worst": g1_worst,
          "mlstm_layers": len(ms_by_kind["mlstm"]),
          "mlstm_layer_ms_median": statistics.median(ms_by_kind["mlstm"]),
          "slstm_layer_ms_median": statistics.median(ms_by_kind["slstm"]),
          "slstm_share_of_layer_time": sum(ms_by_kind["slstm"]) / total})


def handoff_end_to_end(torch, cfg, params, tokens):
    """Gate G3's end-to-end handoff on the same model: |logits(2047 + 1) -
    logits(2048)| is no larger than what a one-ulp move of every input
    embedding entry does to prefill(2048)'s logits in the same run."""
    from repro_torch.models import decoder

    S = tokens.shape[1]

    def prefill(p, toks):
        cache = decoder.init_cache(cfg, 1, S + 1, device="cuda")
        return decoder.prefill(p, cfg, {"tokens": toks}, cache)

    whole, _ = prefill(params, tokens)
    part, cache = prefill(params, tokens[:, :S - 1])
    step, _ = decoder.decode_step(params, cfg, tokens[:, S - 1], cache)
    del cache
    moved = dict(params, embed=torch.nextafter(
        params["embed"], torch.tensor(float("inf"), device="cuda")))
    ulp, _ = prefill(moved, tokens)
    del moved
    handoff = (step - whole).abs().max().item()
    ulp_change = (ulp - whole).abs().max().item()
    emit({"phase": "xlstm_handoff", "S": S,
          "handoff_max_abs_logit_diff": handoff,
          "one_ulp_embedding_max_abs_logit_change": ulp_change,
          "logit_std": whole.std().item()})
    require(bool(torch.isfinite(step).all() and torch.isfinite(whole).all()),
            "non-finite handoff logits")
    require(handoff <= ulp_change, f"2047 + 1 vs 2048 logits differ by "
            f"{handoff}, more than one ulp of the embeddings moves them "
            f"({ulp_change})")


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


def release(torch, before: str) -> None:
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    require(held < 2 ** 30, f"{held} bytes still allocated before {before}")


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
    paged = paged_phase(torch, flush, logs.get("paged_attention", ""))
    flash = flash_phase(torch, flush, logs.get("flash_attention", ""))
    gating = gating_phase(torch, flush)
    mlstm = mlstm_phase(torch, flush, logs.get("mlstm_scan", ""))
    del flush
    small_parity_phase(torch)
    xlstm_parity_phase(torch)
    counts = serving_phase(torch, "granite-8b", "serving")
    # granite-8b's 33 GB, qwen2-moe-a2.7b's 57 GB and xlstm-1.3b's 23 GB do
    # not fit one card together: everything of one model must be gone
    # before the next
    release(torch, "serving_moe")
    moe_counts = serving_phase(torch, "qwen2-moe-a2.7b", "serving_moe")
    release(torch, "serving_xlstm")
    xlstm_counts = serving_xlstm_phase(torch)

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
        {"name": "mlstm_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/mlstm_scan.cu",
         "replaces": "src/repro/kernels/mlstm_scan.py:25",
         "launches": xlstm_counts["mlstm_scan"],
         # at the main path's long prompt: B=1, H=4, S=2048, hd=1024
         "max_abs_err": mlstm["S2048_cache"]["h_abs"],
         "ms": mlstm["S2048_cache"]["kernel_ms"],
         "plain_ms": mlstm["S2048_cache"]["plain_ms"],
         "bound_ms": mlstm["S2048_cache"]["bound_ms"],
         "bound_by": mlstm["S2048_cache"]["bound_by"],
         "library_ms": None},
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
