"""Continuous-batching engine for one pipeline shard (Orca-style).

A :class:`BatchEngine` owns a fixed table of decode *slots*.  Each slot
holds one session's KV cache, allocated in pages of ``page_size`` tokens
and grown on demand, so a shard admits new sequences and evicts finished
ones at every decode step.

Admission is FIFO: when the slot table is full, ``open`` parks the caller
on a queue event and a freed slot is handed directly to the oldest
waiter.  Compute methods return a simulated *cost in seconds* (the
``PEER_FLOPS``/``PEER_BW`` roofline model, kept from the JAX engine for
parity) alongside the result.

Two decode paths share the slot table:

* **Fused paged decode** (the dense and MoE archs; no mrope, no sliding
  window).  KV lives in an engine-owned page pool on the device — per layer
  ``(P, page, Hk, hd)`` tensors stacked as ``(L, P, page, Hk, hd)``, plus
  a free-page list — and each slot holds a block table of page ids.  One
  step advances every live slot: per layer, project q/k/v for the whole
  batch and run paged single-query attention
  (:func:`repro_torch.kernels.ops.paged_decode_attention`) over the block
  tables, then the MLP, or for MoE the routed experts without token
  drops; then the step's k/v are written into the pool in place.
  ``kv_dtype="int8"`` stores pages quantized (per-page per-kv-head
  scales, dequantized in the attention kernel); the partial page keeps an
  fp32 staging tail per slot, and appends requantize it on the device.

* **Per-slot path** (``fused=False``): one batch-1 ``module.apply`` per
  session per token over a dense cache grown by whole pages.

Order of work, which ``chip_smoke.py`` relies on to pair two runs' MoE
gating calls: ``open`` prefills its prompt through every layer in turn; a
fused step runs the layers in turn, each over all the step's sessions in
the order of ``sessions``; a per-slot step runs the sessions in that
order, each through every layer.

Unlike the JAX engine, the pool is never copied between host and device:
the JAX engine re-uploads the whole pool every step and appends on the
host, which at full width would move gigabytes per step.  Page ids and
page accounting follow the JAX engine's alloc/free order exactly, and
``stats["pages"]`` is 0 when every session is closed.
"""

from __future__ import annotations

import itertools
from collections import deque
from typing import Any, Deque, Dict, Generator, List, Optional, Tuple, Union

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.simnet import Sim
from ..kernels.ops import paged_decode_attention
from ..models.common import apply_rope, rms_norm, run_mlp
from ..models.moe import run_moe

__all__ = ["BatchEngine", "KVPool", "SlotState", "PEER_FLOPS", "PEER_BW"]

#: assumed accelerator throughput per serving peer, for simulated latency
PEER_FLOPS = 2.0e11
#: assumed accelerator memory bandwidth per serving peer (bytes/s); decode
#: is bandwidth-bound, so step cost is max(compute, weight+KV traffic)
PEER_BW = 8.0e10

#: archs the fused paged-decode path supports in this port
_FUSED_ARCHS = ("dense", "moe")

#: distinguishes each engine's leak gauge within one Sim
_ENGINE_SEQ = itertools.count()


def _quant_page_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization of pages ``(..., page, Hk, hd)`` with
    one scale per (leading index, kv-head): |x - x̂| <= absmax/254."""
    amax = x.abs().amax(dim=(-3, -1))
    scale = torch.where(amax > 0, amax / 127.0, 1.0).float()
    q = torch.round(x / scale[..., None, :, None]).to(torch.int8)
    return q, scale


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class KVPool:
    """Shared paged KV storage for one shard's fused decode path, on the
    device.

    ``k/v`` pools of shape ``(L, P, page, Hk, hd)`` grown geometrically,
    plus a free-page list — alloc and free are exact and symmetric.
    ``quant`` stores int8 pages with dequant scales ``(L, P, Hk)``.  The
    storage is replaced only when the pool grows.
    """

    def __init__(self, n_layers: int, n_kv_heads: int, head_dim: int,
                 page_size: int, quant: bool = False,
                 device: Union[str, torch.device] = "cuda"):
        self.L = n_layers
        self.Hk = n_kv_heads
        self.hd = head_dim
        self.page = page_size
        self.quant = quant
        self.device = resolve_device(device)
        self.n_pages = 0
        self._free: List[int] = []
        dt = torch.int8 if quant else torch.float32
        self.kp = torch.zeros((self.L, 0, page_size, self.Hk, self.hd),
                              dtype=dt, device=self.device)
        self.vp = torch.zeros_like(self.kp)
        self.ks = (torch.ones((self.L, 0, self.Hk), device=self.device)
                   if quant else None)
        self.vs = (torch.ones((self.L, 0, self.Hk), device=self.device)
                   if quant else None)

    @property
    def page_bytes(self) -> int:
        """Cache-resident bytes of one allocated page (k+v, + scales)."""
        per = self.L * self.page * self.Hk * self.hd * self.kp.element_size()
        scales = 2 * self.L * self.Hk * 4 if self.quant else 0
        return 2 * per + scales

    def pages_in_use(self) -> int:
        return self.n_pages - len(self._free)

    def bytes_in_use(self) -> int:
        return self.pages_in_use() * self.page_bytes

    def _grow(self, min_total: int) -> None:
        total = max(min_total, self.n_pages * 2, 8)
        add = total - self.n_pages

        def ext(a: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
            blk = torch.full((self.L, add) + tuple(a.shape[2:]), fill,
                             dtype=a.dtype, device=a.device)
            return torch.cat([a, blk], dim=1)

        self.kp = ext(self.kp)
        self.vp = ext(self.vp)
        if self.quant:
            self.ks = ext(self.ks, 1.0)
            self.vs = ext(self.vs, 1.0)
        self._free.extend(range(self.n_pages, total))
        self.n_pages = total

    def alloc(self, n: int) -> List[int]:
        if len(self._free) < n:
            self._grow(self.n_pages + n - len(self._free))
        return [self._free.pop() for _ in range(n)]

    def free(self, pages: List[int]) -> None:
        self._free.extend(pages)

    def write_pages(self, pids: List[int], k: torch.Tensor,
                    v: torch.Tensor) -> None:
        """Store whole pages ``(L, n, page, Hk, hd)`` fp32 (zero-padded
        past the valid tokens — zeros quantize to 0 under any scale)."""
        idx = torch.as_tensor(pids, dtype=torch.long, device=self.device)
        if self.quant:
            self.kp[:, idx], self.ks[:, idx] = _quant_page_int8(k)
            self.vp[:, idx], self.vs[:, idx] = _quant_page_int8(v)
        else:
            self.kp[:, idx] = k
            self.vp[:, idx] = v


class SlotState:
    """One occupied decode slot: a session pinned to a paged KV cache."""

    __slots__ = ("session", "slot", "cache", "capacity", "max_len",
                 "last_used", "length", "pages", "k_tail", "v_tail")

    def __init__(self, session: Any, slot: int, cache: Optional[Dict[str, Any]],
                 capacity: int, max_len: int, now: float):
        self.session = session
        self.slot = slot
        self.cache = cache            # dense per-slot cache (per-slot path)
        self.capacity = capacity
        self.max_len = max_len
        self.last_used = now
        self.length = 0               # cached tokens (fused path)
        self.pages: List[int] = []    # pool page ids (fused path)
        self.k_tail: Optional[torch.Tensor] = None   # fp32 staging master for
        self.v_tail: Optional[torch.Tensor] = None   # the partial page (int8)


def _fused_block(cfg: Any, p: Any, x: torch.Tensor, positions: torch.Tensor,
                 bt: torch.Tensor, lengths: torch.Tensor, kp: torch.Tensor,
                 vp: torch.Tensor, ks: Optional[torch.Tensor],
                 vs: Optional[torch.Tensor],
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One dense or MoE block for a batch of single-token rows, with KV
    read from the page pool.  Mirrors ``decoder.run_block``'s decode math
    (rms_norm -> q/k/v -> qk_norm -> rope -> masked softmax over the cache
    -> wo -> residual -> ln2 -> mlp/moe).  Returns (x, k_new, v_new)."""
    ap = p["attn"]
    B = x.shape[0]
    H, Hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q = (h @ ap["wq"]).reshape(B, 1, H, hd)
    k = (h @ ap["wk"]).reshape(B, 1, Hk, hd)
    v = (h @ ap["wv"]).reshape(B, 1, Hk, hd)
    if cfg.qk_norm:
        q = rms_norm(q, ap["q_norm"], cfg.norm_eps)
        k = rms_norm(k, ap["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    k0, v0 = k[:, 0].contiguous(), v[:, 0].contiguous()
    attn = paged_decode_attention(q[:, 0].contiguous(), kp, vp, bt, lengths,
                                  k0, v0, ks, vs)             # (B, H, hd)
    x = x + attn.reshape(B, 1, H * hd) @ ap["wo"]
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    if cfg.arch == "moe":
        ffn, _, _ = run_moe(p["moe"], cfg, h2, no_drop=True)
    else:
        ffn = run_mlp(p["mlp"], h2)
    return x + ffn, k0, v0


class BatchEngine:
    def __init__(self, module: Any, sim: Sim, n_slots: int = 8,
                 page_size: int = 32, kv_dtype: str = "fp32",
                 fused: Optional[bool] = None,
                 device: Union[str, torch.device] = "cuda"):
        if kv_dtype not in ("fp32", "int8"):
            raise ValueError(f"unknown kv_dtype {kv_dtype!r}")
        self.device = resolve_device(device)
        if module.device != self.device:
            raise ValueError(f"module lives on {module.device}, engine on "
                             f"{self.device}")
        self.module = module
        self.sim = sim
        self.n_slots = n_slots
        self.page_size = page_size
        self._free: List[int] = list(range(n_slots - 1, -1, -1))
        self._slot_last_session: List[Any] = [None] * n_slots
        self.by_session: Dict[Any, SlotState] = {}
        # FIFO of (session, event) waiting for a slot; a freed slot is
        # succeed()ed straight into the head waiter's event
        self._queue: Deque[Tuple[Any, Any]] = deque()
        supported = self._supports_fused(module)
        self.fused = supported if fused is None else (fused and supported)
        self.kv_dtype = kv_dtype if self.fused else "fp32"
        self._pool: Optional[KVPool] = None
        self._tails: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._fallback_pages = 0      # exact page counter for the dense path
        if self.fused:
            cfg = module.cfg
            quant = self.kv_dtype == "int8"
            self._pool = KVPool(module.n_layers, cfg.n_kv_heads, cfg.hd,
                                page_size, quant=quant, device=self.device)
            if quant:
                # per-slot fp32 staging tails of the partial page
                shape = (n_slots, module.n_layers, page_size, cfg.n_kv_heads,
                         cfg.hd)
                self._tails = (torch.zeros(shape, device=self.device),
                               torch.zeros(shape, device=self.device))
        self.stats = {
            "admitted": 0, "evicted": 0, "prefills": 0, "steps": 0,
            "step_sessions": 0, "queue_peak": 0, "slot_reuse": 0,
            "pages": 0, "pages_peak": 0, "idle_evicted": 0,
        }
        sim.register_leak_check(
            f"kv.pages:{next(_ENGINE_SEQ)}", self._pages_in_use)

    @staticmethod
    def _supports_fused(module: Any) -> bool:
        cfg = getattr(module, "cfg", None)
        return (cfg is not None
                and cfg.arch in _FUSED_ARCHS
                and not cfg.mrope
                and cfg.window == 0
                and hasattr(module, "_layer_params"))

    # -- occupancy ----------------------------------------------------------
    @property
    def slots_used(self) -> int:
        return self.n_slots - len(self._free)

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    # -- paged cache --------------------------------------------------------
    def _pages_for(self, n_tokens: int) -> int:
        return max(1, -(-n_tokens // self.page_size))

    def _alloc_cache(self, n_tokens: int) -> Tuple[Dict[str, Any], int]:
        cap = self._pages_for(n_tokens) * self.page_size
        return self.module.init_cache(1, cap), cap

    def _ensure_capacity(self, st: SlotState, need: int) -> None:
        """Grow the slot's dense cache by whole pages until it can hold
        ``need`` tokens."""
        if need <= st.capacity:
            return
        new_cap = self._pages_for(need) * self.page_size
        fresh = self.module.init_cache(1, new_cap)
        for name, old in st.cache["layers"].items():
            fresh["layers"][name][:, :, :old.shape[2]] = old
        st.cache = {"len": st.cache["len"], "layers": fresh["layers"]}
        self._fallback_pages += (new_cap - st.capacity) // self.page_size
        st.capacity = new_cap
        self._note_pages()

    def _pages_in_use(self) -> int:
        if self.fused:
            return self._pool.pages_in_use()
        return self._fallback_pages

    def _note_pages(self) -> None:
        used = self._pages_in_use()
        self.stats["pages"] = used
        if used > self.stats["pages_peak"]:
            self.stats["pages_peak"] = used

    # -- cost model ---------------------------------------------------------
    def _weight_bytes(self) -> float:
        return float(self.module.weight_bytes())

    def _slot_kv_bytes(self, st: SlotState) -> float:
        if self.fused:
            b = len(st.pages) * self._pool.page_bytes
            if st.k_tail is not None:
                b += _nbytes(st.k_tail) + _nbytes(st.v_tail)
            return float(b)
        if st.cache is None:
            return 0.0
        return float(sum(_nbytes(t) for t in st.cache["layers"].values()))

    def kv_bytes(self) -> float:
        """Current cache-resident bytes across all live slots (pool pages
        + fp32 staging tails, or dense per-slot caches)."""
        if self.fused:
            b = float(self._pool.bytes_in_use())
            for st in self.by_session.values():
                if st.k_tail is not None:
                    b += _nbytes(st.k_tail) + _nbytes(st.v_tail)
            return b
        return sum(self._slot_kv_bytes(st) for st in self.by_session.values())

    def _cost(self, flops: float, bytes_moved: float) -> float:
        """Roofline step time: compute-bound or bandwidth-bound."""
        return max(flops / PEER_FLOPS, bytes_moved / PEER_BW)

    # -- admission / eviction ------------------------------------------------
    def open(self, session: Any, x: np.ndarray, max_len: int) -> Generator:
        """Admit ``session`` (waiting FIFO for a slot if the table is full)
        and run its prefill.  Returns ``(out, cost_seconds)``; idempotent
        per session id — re-opening replaces the previous cache (and frees
        its pages)."""
        if session in self.by_session:
            old = self.by_session.pop(session)
            slot = old.slot
            self._free_slot_storage(old)
        elif self._free:
            slot = self._free.pop()
        else:
            ev = self.sim.event()
            self._queue.append((session, ev))
            self.stats["queue_peak"] = max(self.stats["queue_peak"],
                                           len(self._queue))
            slot = yield ev
        out, cost = self._prefill(session, slot, x, max_len)
        return out, cost

    def close(self, sessions: List[Any]) -> int:
        n = 0
        for sid in list(sessions):
            if sid in self.by_session:
                self._release(sid)
                n += 1
        return n

    def reap_idle(self, ttl: float) -> int:
        """Evict sessions untouched for ``ttl`` sim-seconds."""
        now = self.sim.now
        stale = [sid for sid, st in self.by_session.items()
                 if now - st.last_used > ttl]
        for sid in stale:
            self._release(sid)
            self.stats["idle_evicted"] += 1
        return len(stale)

    def fail_waiters(self, exc: BaseException) -> int:
        """Crash path: wake every queued admission with ``exc``."""
        n = 0
        while self._queue:
            _, ev = self._queue.popleft()
            ev.fail(exc)
            n += 1
        return n

    def _free_slot_storage(self, st: SlotState) -> None:
        """Return a slot's cache storage (not the slot itself)."""
        if self.fused:
            self._pool.free(st.pages)
            st.pages = []
        else:
            self._fallback_pages -= st.capacity // self.page_size
        self._note_pages()

    def _release(self, session: Any) -> None:
        st = self.by_session.pop(session)
        self.stats["evicted"] += 1
        self._free_slot_storage(st)
        if self._queue:
            _, ev = self._queue.popleft()
            ev.succeed(st.slot)       # direct handoff keeps admission FIFO
        else:
            self._free.append(st.slot)

    # -- compute ------------------------------------------------------------
    def _positions(self, base: int, B: int, S: int) -> torch.Tensor:
        if S == 1:
            return torch.full((B, 1), base, dtype=torch.int32,
                              device=self.device)
        return torch.arange(S, dtype=torch.int32,
                            device=self.device)[None].expand(B, S)

    def _input(self, x: Any) -> torch.Tensor:
        """Host rows -> device tensor; token ids are embedded on the first
        shard."""
        xt = torch.as_tensor(np.asarray(x), device=self.device)
        if self.module.is_first and not xt.is_floating_point():
            return self.module.embed(xt)
        return xt.float()

    def _pool_write_prefill(self, st: SlotState, k: torch.Tensor,
                            v: torch.Tensor) -> None:
        """Copy a prefilled slot's k/v ``(L, S, Hk, hd)`` into its pool
        pages; the partial last page keeps an fp32 staging master when
        the pool is quantized."""
        pool, page = self._pool, self.page_size
        L, S = k.shape[0], k.shape[1]
        n_full = S // page
        if n_full:
            tail_shape = (L, n_full, page) + tuple(k.shape[2:])
            pool.write_pages(st.pages[:n_full],
                             k[:, :n_full * page].reshape(tail_shape),
                             v[:, :n_full * page].reshape(tail_shape))
        rem = S - n_full * page
        if pool.quant:
            st.k_tail = self._tails[0][st.slot]
            st.v_tail = self._tails[1][st.slot]
            st.k_tail.zero_()
            st.v_tail.zero_()
            if rem:
                st.k_tail[:, :rem] = k[:, n_full * page:]
                st.v_tail[:, :rem] = v[:, n_full * page:]
                pool.write_pages([st.pages[n_full]], st.k_tail[:, None],
                                 st.v_tail[:, None])
        elif rem:
            pid = st.pages[n_full]
            pool.kp[:, pid, :rem] = k[:, n_full * page:]
            pool.vp[:, pid, :rem] = v[:, n_full * page:]

    def _pool_append(self, sts: List[SlotState], kn: torch.Tensor,
                     vn: torch.Tensor) -> None:
        """Write each live slot's new token ``kn[:, r]``, ``(L, Hk, hd)``,
        at position ``st.length``, in place on the device (the page was
        allocated before the step)."""
        pool, page = self._pool, self.page_size
        dev = self.device
        offs = [st.length % page for st in sts]
        pids = [st.pages[st.length // page] for st in sts]
        pid_t = torch.as_tensor(pids, dtype=torch.long, device=dev)
        off_t = torch.as_tensor(offs, dtype=torch.long, device=dev)
        if pool.quant:
            kt, vt = self._tails
            slots = torch.as_tensor([st.slot for st in sts], dtype=torch.long,
                                    device=dev)
            fresh = [st.slot for st, off in zip(sts, offs) if off == 0]
            if fresh:                          # a new page starts empty
                fresh_t = torch.as_tensor(fresh, dtype=torch.long, device=dev)
                kt[fresh_t] = 0.0
                vt[fresh_t] = 0.0
            kt[slots, :, off_t] = kn.transpose(0, 1)
            vt[slots, :, off_t] = vn.transpose(0, 1)
            kq, ksc = _quant_page_int8(kt[slots])   # (M, L, page, Hk, hd)
            vq, vsc = _quant_page_int8(vt[slots])
            pool.kp[:, pid_t] = kq.transpose(0, 1)
            pool.ks[:, pid_t] = ksc.transpose(0, 1)
            pool.vp[:, pid_t] = vq.transpose(0, 1)
            pool.vs[:, pid_t] = vsc.transpose(0, 1)
        else:
            pool.kp[:, pid_t, off_t] = kn
            pool.vp[:, pid_t, off_t] = vn
        for st in sts:
            st.length += 1

    def _prefill(self, session: Any, slot: int, x: np.ndarray,
                 max_len: int) -> Tuple[np.ndarray, float]:
        m = self.module
        self.stats["prefills"] += 1
        self.stats["admitted"] += 1
        if self._slot_last_session[slot] not in (None, session):
            self.stats["slot_reuse"] += 1
        self._slot_last_session[slot] = session
        xt = self._input(x)
        S = xt.shape[1]
        cache, cap = self._alloc_cache(S + 1)
        st = SlotState(session, slot, cache, cap, max_len, self.sim.now)
        self.by_session[session] = st
        if self.fused:
            # prefill runs through the dense path, then the resulting k/v
            # move into pool pages and the dense cache is dropped
            out, cache = m.apply(xt, self._positions(0, 1, S), cache)
            st.cache = None
            st.length = S
            st.pages = self._pool.alloc(cap // self.page_size)
            self._pool_write_prefill(st, cache["layers"]["k"][:, 0, :S],
                                     cache["layers"]["v"][:, 0, :S])
        else:
            self._fallback_pages += cap // self.page_size
            out, st.cache = m.apply(xt, self._positions(0, 1, S), st.cache)
        self._note_pages()
        if m.is_last:
            out = m.head(out[:, -1:])[:, 0]       # (1, vocab)
        cost = self._cost(m.flops(S),
                          self._weight_bytes() + self._slot_kv_bytes(st))
        return out.float().cpu().numpy(), cost

    def step(self, sessions: List[Any], x: np.ndarray,
             evict: Optional[List[Any]] = None,
             ) -> Tuple[np.ndarray, List[Any], float]:
        """One decode iteration over a batch of sessions.

        ``x`` is row-aligned with ``sessions``: int32 token ids ``(M,)``
        on the first shard, activations ``(M, d_model)`` downstream.
        Sessions the engine no longer holds are skipped; the returned
        ``served`` list tells the caller which rows came back.  ``evict``
        frees finished sessions *before* compute.  Returns
        ``(out, served, cost_seconds)`` with ``out`` a host array.
        """
        if evict:
            self.close(evict)
        self.stats["steps"] += 1
        if self.fused:
            return self._step_fused(sessions, x)
        return self._step_unfused(sessions, x)

    def _step_fused(self, sessions: List[Any], x: np.ndarray,
                    ) -> Tuple[np.ndarray, List[Any], float]:
        m = self.module
        xa = np.asarray(x)
        live: List[Tuple[int, Any, SlotState]] = []
        for i, sid in enumerate(sessions):
            st = self.by_session.get(sid)
            if st is None:
                continue
            st.last_used = self.sim.now
            need = self._pages_for(st.length + 1)
            if need > len(st.pages):           # next token starts a new page
                st.pages.extend(self._pool.alloc(need - len(st.pages)))
                st.capacity = len(st.pages) * self.page_size
                self._note_pages()
            live.append((i, sid, st))
        if not live:
            return np.zeros((0, 1), dtype=np.float32), [], 0.0
        M = len(live)
        NP = max(len(st.pages) for _, _, st in live)
        bt = np.zeros((M, NP), np.int32)      # padding entries are never read
        lengths = np.zeros((M,), np.int32)
        for r, (_, _, st) in enumerate(live):
            bt[r, :len(st.pages)] = st.pages
            lengths[r] = st.length
        h = self._input(xa[[i for i, _, _ in live]])[:, None]   # (M, 1, D)
        bt_t = torch.from_numpy(bt).to(self.device)
        len_t = torch.from_numpy(lengths).to(self.device)
        positions = len_t[:, None]
        pool = self._pool
        cfg = m.cfg
        nk = torch.empty((m.n_layers, M, cfg.n_kv_heads, cfg.hd),
                         device=self.device)
        nv = torch.empty_like(nk)
        for j in range(m.n_layers):
            h, nk[j], nv[j] = _fused_block(
                cfg, m._layer_params(j), h, positions, bt_t, len_t,
                pool.kp[j], pool.vp[j],
                None if pool.ks is None else pool.ks[j],
                None if pool.vs is None else pool.vs[j])
        out = m.head(h)[:, 0] if m.is_last else h[:, 0]
        sts = [st for _, _, st in live]
        self._pool_append(sts, nk, nv)
        served = [sid for _, sid, _ in live]
        kv_read = sum(self._slot_kv_bytes(st) for st in sts)
        self.stats["step_sessions"] += len(served)
        # one pass over the weights for the whole batch — the fused win
        cost = self._cost(m.flops(1) * len(served),
                          self._weight_bytes() + kv_read)
        return out.float().cpu().numpy(), served, cost

    def _step_unfused(self, sessions: List[Any], x: np.ndarray,
                      ) -> Tuple[np.ndarray, List[Any], float]:
        m = self.module
        served: List[Any] = []
        outs: List[np.ndarray] = []
        cost = 0.0
        for i, sid in enumerate(sessions):
            st = self.by_session.get(sid)
            if st is None:
                continue
            st.last_used = self.sim.now
            xi = self._input(np.asarray(x[i])[None])   # (1, D)
            xi = xi[:, None]                            # (1, 1, D)
            cur = st.cache["len"]
            self._ensure_capacity(st, cur + 1)
            out, st.cache = m.apply(xi, self._positions(cur, 1, 1), st.cache)
            out = m.head(out)[:, 0] if m.is_last else out[:, 0]
            outs.append(out[0].float().cpu().numpy())
            served.append(sid)
            # every session re-reads the shard weights: M passes per step
            cost += self._cost(m.flops(1),
                               self._weight_bytes() + self._slot_kv_bytes(st))
        self.stats["step_sessions"] += len(served)
        out_arr = (np.stack(outs) if outs
                   else np.zeros((0, 1), dtype=np.float32))
        return out_arr, served, cost

    def slot_of(self, session: Any) -> Optional[int]:
        st = self.by_session.get(session)
        return None if st is None else st.slot
