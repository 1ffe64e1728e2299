"""Sharded inference over the Lattica mesh (paper Fig. 1, Scenario 4), on
the port: pipeline shards of a model on peers behind NATs, each serving
the ``infer.<fleet>.<i>`` RPC surfaces, and the shard-aware client that
resolves providers on the DHT, routes by load, hedges idempotent calls
and migrates sessions off dead providers.

Most of this module is a checked copy of the JAX package's
``serving/sharded.py`` (``shard_key``, ``InferenceService``,
``InferenceV2Service``, ``ShardServer``, ``_Request``, ``ShardClient``,
``deploy_sharded``, ``serve_fleet``): the same code under the port's
import paths, so that a torch shard and a JAX shard speak the same wire
protocol, with the same payload sizes and simulated timings.  The parts
written for the port are the shard's local compute on tensors
(``plan_shards``, ``split_params``, ``ShardModule``) and
``ShardServer._handle``, the v1 plane's ops: each payload's ``"x"``
arrives as numpy (int32 token ids or float32 activations), moves onto the
device that holds the shard's parameters, and goes back as a float32
numpy array of the JAX server's shape.  A shard server and its
``BatchEngine`` run on that device; nothing moves to the CPU when no card
is found.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
from collections import deque
from typing import Any, Deque, Dict, Generator, List, Optional, Set, Tuple

import numpy as np
import torch

from ..core.dht import PeerInfo
from ..core.node import LatticaNode
from ..core.rpc import RpcContext, RpcError
from ..core.service import (Fixed, RpcStatus, Service, ServiceError,
                            TensorDictCodec, pickled, unary)
from ..core.simnet import DialError
from ..models import decoder
from ..models.common import rms_norm
from ..models.config import ModelConfig
from ..tree import leaves
from .batch import PEER_FLOPS, BatchEngine, _host
from .router import LoadAwareRouter, hedged_call

_session_seq = itertools.count(1)


def shard_key(fleet: str, idx: int) -> bytes:
    return hashlib.sha256(f"shard/{fleet}/{idx}".encode()).digest()


def plan_shards(cfg: ModelConfig, n_shards: int) -> List[Tuple[int, int]]:
    """Split layers into contiguous ranges, as even as possible."""
    L = cfg.n_layers
    base, rem = divmod(L, n_shards)
    plan = []
    lo = 0
    for i in range(n_shards):
        hi = lo + base + (1 if i < rem else 0)
        plan.append((lo, hi))
        lo = hi
    return plan


def _slice_layers(tree: Any, lo: int, hi: int) -> Any:
    """Layers ``lo:hi`` of a layer-stacked tree (views), or of a per-layer
    list (the xLSTM stack)."""
    if isinstance(tree, dict):
        return {k: _slice_layers(v, lo, hi) for k, v in tree.items()}
    return tree[lo:hi]


def _require_shardable(cfg: ModelConfig) -> None:
    """Shards hold a decoder's ``blocks``; an encoder-decoder tree has
    ``enc_blocks`` and ``dec_blocks``, on which the JAX package's
    ``split_params`` fails too (a ``KeyError``).  Whisper is served by
    ``GenerationEngine``."""
    if cfg.arch == "audio":
        raise ValueError(
            f"arch 'audio' ({cfg.name}) cannot be split into pipeline "
            "shards: its tree has enc_blocks and dec_blocks, no blocks; "
            "serve it with GenerationEngine")
    decoder.require_ported(cfg)


def split_params(cfg: ModelConfig, params: Any,
                 plan: List[Tuple[int, int]]) -> List[Dict[str, Any]]:
    """Per-shard param subsets (first gets embed, last gets norm+head).
    Layer slices are views of the stacked tensors, or sublists of the
    per-layer list."""
    _require_shardable(cfg)
    shards = []
    for i, (lo, hi) in enumerate(plan):
        sub: Dict[str, Any] = {"blocks": _slice_layers(params["blocks"], lo, hi)}
        if i == 0:
            sub["embed"] = params["embed"]
        if i == len(plan) - 1:
            sub["final_norm"] = params["final_norm"]
            if "lm_head" in params:
                sub["lm_head"] = params["lm_head"]
            elif cfg.tie_embeddings:
                sub["embed_out"] = params["embed"]
        shards.append(sub)
    return shards


class ShardModule:
    """Applies one shard's layer range, with per-session decode caches."""

    def __init__(self, cfg: ModelConfig, params: Dict[str, Any],
                 layer_range: Tuple[int, int], is_first: bool, is_last: bool):
        _require_shardable(cfg)
        self.cfg = cfg
        self.params = params
        self.lo, self.hi = layer_range
        self.is_first = is_first
        self.is_last = is_last

    @property
    def n_layers(self) -> int:
        return self.hi - self.lo

    @property
    def device(self) -> torch.device:
        return params_device(self.params)

    def _layer_params(self, j: int) -> Any:
        return decoder.layer_params(self.params["blocks"], j)

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.params["embed"][tokens.long()]

    def head(self, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, self.params["final_norm"], self.cfg.norm_eps)
        w = self.params.get("lm_head")
        if w is None:
            w = self.params["embed_out"].T
        return x @ w

    def init_cache(self, batch: int, max_len: int) -> Dict[str, Any]:
        """A decode cache for this shard's layers only: float32, or float64
        for float64 parameters (a CPU reference run)."""
        layer_cfg = dataclasses.replace(self.cfg, n_layers=self.n_layers)
        dtype = torch.promote_types(leaves(self.params)[0].dtype,
                                    torch.float32)
        return decoder.init_cache(layer_cfg, batch, max_len, dtype,
                                  device=self.device)

    def apply(self, x: torch.Tensor, positions: torch.Tensor,
              cache: Optional[Dict[str, Any]],
              ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
        if cache is not None:
            return decoder.apply_layers_cached(
                self.params["blocks"], self.cfg, x, positions, cache,
                layer_offset=self.lo)
        for j in range(self.n_layers):
            x, _, _ = decoder.run_block(self.cfg, self._layer_params(j), x,
                                        positions, layer_idx=self.lo + j)
        return x, None

    def flops(self, tokens: int) -> float:
        """The JAX package's cost model, kept as a parity target: 12 d^2
        per layer and token whatever the arch (an undercount for ssm)."""
        per_layer = 12 * self.cfg.d_model ** 2
        return 2.0 * tokens * per_layer * self.n_layers

    def weight_bytes(self) -> int:
        """Bytes the accelerator streams to apply this shard once — what
        the bandwidth term of the decode cost model charges per pass."""
        return sum(t.numel() * t.element_size() for t in leaves(self.params))


def params_device(params: Dict[str, Any]) -> torch.device:
    """The device every tensor of ``params`` lives on (raises if mixed)."""
    devices = {t.device for t in leaves(params)}
    if len(devices) != 1:
        raise ValueError(f"parameters span devices {sorted(map(str, devices))}")
    return devices.pop()


def _shard_input(m: ShardModule, x: Any, step: bool = False) -> torch.Tensor:
    """A v1 payload's ``"x"`` on the shard's device.  The first shard
    embeds integer token ids, (B, S) for a prompt or (B,) for a decode
    step (``step``); activations arrive as they were sent."""
    xt = torch.from_numpy(np.array(x)).to(m.device)
    if m.is_first and not xt.is_floating_point():
        return m.embed(xt[:, None] if step else xt)
    return xt


def _positions(m: ShardModule, B: int, S: int, device: torch.device,
               base: Optional[int] = None) -> torch.Tensor:
    """``arange(S)`` for a prompt or a score, ``base`` for a decode step;
    under M-RoPE the same positions on all three streams, as the JAX
    server's."""
    if base is None:
        pos = torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)
    else:
        pos = torch.full((B, S), base, dtype=torch.int32, device=device)
    if m.cfg.mrope:
        pos = pos[None].expand((3, B, S))
    return pos


class InferenceService(Service):
    """One pipeline shard's v1 RPC surface.  ``scope`` carries the fleet
    name and shard index, so each shard serves ``infer.<fleet>.<i>``.  The
    infer method is *not* idempotent (decode advances per-session KV
    caches); failover is handled explicitly by :class:`ShardClient`."""

    name = "infer"

    def __init__(self, server: "ShardServer"):
        self.server = server
        self.scope = f"{server.fleet}.{server.shard_idx}"

    @unary("infer", request=TensorDictCodec(), response=TensorDictCodec(),
           timeout=120.0)
    def infer(self, payload: Any, ctx: RpcContext) -> Generator:
        if not self.server.alive:
            raise ServiceError(RpcStatus.UNAVAILABLE,
                               f"shard {self.server.shard_idx} is down")
        resp = yield from self.server._handle(payload, ctx)
        return resp

    @unary("score", request=TensorDictCodec(), response=TensorDictCodec(),
           timeout=120.0, idempotent=True)
    def score(self, payload: Any, ctx: RpcContext) -> Generator:
        """Stateless forward pass: touches no session state, so it is the
        one v1 op that may be hedged/retried (latlint L004 requires the
        idempotency to be declared on the MethodSpec, not assumed)."""
        if payload.get("op") != "score":
            raise ServiceError(RpcStatus.NOT_FOUND,
                               "score method only serves op == 'score'")
        if not self.server.alive:
            raise ServiceError(RpcStatus.UNAVAILABLE,
                               f"shard {self.server.shard_idx} is down")
        resp = yield from self.server._handle(payload, ctx)
        return resp


class InferenceV2Service(Service):
    """The continuous-batching surface: per-step admission/eviction against
    the shard's slot table.  ``open``/``step`` are *not* idempotent (they
    advance KV caches); ``close``/``stats`` are."""

    name = "infer.v2"

    def __init__(self, server: "ShardServer"):
        self.server = server
        self.scope = f"{server.fleet}.{server.shard_idx}"

    def _check_alive(self) -> None:
        if not self.server.alive:
            raise ServiceError(RpcStatus.UNAVAILABLE,
                               f"shard {self.server.shard_idx} is down")

    @unary("infer.v2.open", request=TensorDictCodec(),
           response=TensorDictCodec(), timeout=120.0)
    def open(self, payload: Any, ctx: RpcContext) -> Generator:
        self._check_alive()
        eng = self.server.engine
        out, cost = yield from eng.open(
            tuple(payload["session"]), payload["x"], payload["max_len"])
        self._check_alive()     # died while we waited for a slot / computed
        yield ctx.cpu(cost)
        return {"x": out}

    @unary("infer.v2.step", request=TensorDictCodec(),
           response=TensorDictCodec(), timeout=60.0)
    def step(self, payload: Any, ctx: RpcContext) -> Generator:
        self._check_alive()
        eng = self.server.engine
        sessions = [tuple(s) for s in payload["sessions"]]
        evict = [tuple(s) for s in payload.get("evict", [])]
        out, served, cost = eng.step(sessions, payload["x"], evict=evict)
        yield ctx.cpu(cost)
        return {"x": out, "served": served}

    @unary("infer.v2.close", request=pickled(floor=96),
           response=pickled(floor=96), idempotent=True, timeout=15.0)
    def close(self, sessions: Any, ctx: RpcContext) -> Generator:
        yield ctx.cpu(2e-6)
        return self.server.engine.close([tuple(s) for s in sessions])

    @unary("infer.v2.stats", request=Fixed(64), response=pickled(floor=96),
           idempotent=True, timeout=10.0)
    def stats(self, payload: Any, ctx: RpcContext) -> Generator:
        self._check_alive()
        yield ctx.cpu(1e-6)
        eng = self.server.engine
        return {"slots_used": eng.slots_used, "n_slots": eng.n_slots,
                "queue_depth": eng.queue_depth}


class ShardServer:
    def __init__(self, node: LatticaNode, cfg: ModelConfig, fleet: str,
                 shard_idx: int, module: ShardModule, n_slots: int = 8,
                 page_size: int = 32, idle_ttl: float = 60.0,
                 kv_dtype: str = "fp32"):
        self.node = node
        self.cfg = cfg
        self.fleet = fleet
        self.shard_idx = shard_idx
        self.module = module
        self.sessions: Dict[Any, Dict[str, Any]] = {}    # v1 sessions
        self.alive = True
        self.idle_ttl = idle_ttl
        self.stats = {"prefill": 0, "decode": 0, "score": 0}
        self.engine = BatchEngine(module, node.sim, n_slots=n_slots,
                                  page_size=page_size, kv_dtype=kv_dtype,
                                  device=module.device)
        node.serve(InferenceService(self))
        node.serve(InferenceV2Service(self))
        if not hasattr(node, "shard_servers"):
            node.shard_servers = []                      # metrics registry
        node.shard_servers.append(self)
        node.sim.process(self._reaper(), daemon=True)

    def announce(self) -> Generator:
        yield from self.node.dht.provide(shard_key(self.fleet, self.shard_idx))
        return None

    def unannounce(self) -> Generator:
        """Withdraw this replica's DHT provider record (planned retirement
        — the inverse of :meth:`announce`; routers stop finding it)."""
        yield from self.node.dht.unprovide(
            shard_key(self.fleet, self.shard_idx))
        return None

    def stop(self) -> None:
        """Simulate a crash: all subsequent calls fail, and admissions
        parked on the slot queue fail *now* rather than at RPC deadline."""
        self.alive = False
        self.engine.fail_waiters(ServiceError(
            RpcStatus.UNAVAILABLE, f"shard {self.shard_idx} is down"))

    def _reaper(self) -> Generator:
        """Evict slots pinned by vanished clients (crash between steps,
        client-side deadline abandoning a queued admission)."""
        while self.alive:
            yield max(1.0, self.idle_ttl / 2)
            self.engine.reap_idle(self.idle_ttl)
        return None

    def _handle(self, payload: Any, ctx: RpcContext) -> Generator:
        """The v1 plane's ops on the shard's device.  The reply is a host
        float32 array of the JAX server's shape: last-position logits
        (B, vocab) or activations (B, S, d_model) for a prefill, (B, vocab)
        or (B, 1, d_model) for a decode step, all positions for a score."""
        op = payload["op"]
        m = self.module
        if op == "prefill":
            self.stats["prefill"] += 1
            with torch.no_grad():
                x = _shard_input(m, payload["x"])
                B, S = x.shape[0], x.shape[1]
                cache = m.init_cache(B, payload["max_len"])
                out, cache = m.apply(x, _positions(m, B, S, x.device), cache)
                self.sessions[payload["session"]] = cache
                if m.is_last:
                    out = m.head(out[:, -1:])[:, 0]
                out = _host(out)
            yield ctx.cpu(m.flops(B * S) / PEER_FLOPS)
            return {"x": out}
        if op == "decode":
            self.stats["decode"] += 1
            cache = self.sessions.get(payload["session"])
            if cache is None:
                # a replica that never saw this session's prefill: typed
                # NOT_FOUND so the client migrates instead of treating the
                # replica as dead
                raise ServiceError(
                    RpcStatus.NOT_FOUND,
                    f"unknown session {payload['session']!r}")
            with torch.no_grad():
                x = _shard_input(m, payload["x"], step=True)
                B = x.shape[0]
                pos = _positions(m, B, 1, x.device, base=cache["len"])
                out, cache = m.apply(x, pos, cache)
                self.sessions[payload["session"]] = cache
                if m.is_last:
                    out = m.head(out)[:, 0]
                out = _host(out)
            yield ctx.cpu(m.flops(B) / PEER_FLOPS)
            return {"x": out}
        if op == "score":
            self.stats["score"] += 1
            with torch.no_grad():
                x = _shard_input(m, payload["x"])
                B, S = x.shape[0], x.shape[1]
                out, _ = m.apply(x, _positions(m, B, S, x.device), None)
                if m.is_last:
                    out = m.head(out)
                out = _host(out)
            yield ctx.cpu(m.flops(B * S) / PEER_FLOPS)
            return {"x": out}
        raise ServiceError(RpcStatus.NOT_FOUND, f"unknown op {op}")


class _Request:
    """One in-flight generation request inside the v2 driver."""

    __slots__ = ("prompt", "n_tokens", "temperature", "rng", "generated",
                 "session", "chain", "done", "attempts", "migrations",
                 "submitted_at", "finished_at")

    def __init__(self, prompt: np.ndarray, n_tokens: int, temperature: float,
                 seed: int, done: Any, now: float):
        self.prompt = prompt                 # (1, S) int32
        self.n_tokens = n_tokens
        self.temperature = temperature
        self.rng = np.random.default_rng(seed)
        self.generated: List[int] = []
        self.session: Optional[Tuple[str, int]] = None
        self.chain: List[PeerInfo] = []
        self.done = done
        self.attempts = 0
        self.migrations = 0
        self.submitted_at = now
        self.finished_at: Optional[float] = None


class ShardClient:
    """Shard-aware stub: DHT provider resolution, load-aware routing,
    transparent failover, and a continuous-batching driver.

    The v1 methods (``prefill``/``decode_step``/``score``/``generate``)
    keep their one-session-at-a-time semantics.  The v2 driver
    (``submit``/``generate_concurrent``) multiplexes any number of
    concurrent sessions over one ``infer.v2.step`` RPC per shard hop per
    decode iteration, sampling client-side, and migrates sessions off dead
    providers by replaying prompt ⊕ generated-so-far on a fresh chain.
    """

    def __init__(self, node: LatticaNode, cfg: ModelConfig, fleet: str,
                 n_shards: int, resolve_ttl: float = 5.0,
                 hedge_after: float = 0.08, max_session_attempts: int = 8,
                 max_migrations: int = 10):
        self.node = node
        self.cfg = cfg
        self.fleet = fleet
        self.n_shards = n_shards
        self.resolve_ttl = resolve_ttl
        self.hedge_after = hedge_after
        self.max_session_attempts = max_session_attempts
        self.max_migrations = max_migrations
        self.router = LoadAwareRouter(node.sim)
        self._providers: Dict[int, List[PeerInfo]] = {}
        self._resolved_at: Dict[int, float] = {}
        self.stats = {"failovers": 0, "calls": 0, "sessions_migrated": 0,
                      "hedged": 0, "requests": 0, "completed": 0,
                      "failed_sessions": 0}
        self._pending: Deque[_Request] = deque()
        self._admitting: Set[_Request] = set()
        self._active: List[_Request] = []
        self._pump_alive = False
        self._wake: Optional[Any] = None
        if not hasattr(node, "shard_clients"):
            node.shard_clients = []                      # metrics registry
        node.shard_clients.append(self)

    # -- provider resolution -------------------------------------------------
    def _resolve(self, idx: int, refresh: bool = False) -> Generator:
        stale = (self.node.sim.now - self._resolved_at.get(idx, -1e9)
                 > self.resolve_ttl)
        if (refresh or stale or idx not in self._providers
                or not self._providers[idx]):
            provs = yield from self.node.dht.find_providers(
                shard_key(self.fleet, idx))
            fresh = [p for p in provs if p.peer_id != self.node.peer_id]
            if fresh or refresh:
                self._providers[idx] = fresh
            self._resolved_at[idx] = self.node.sim.now
        return self._providers.get(idx, [])

    def _drop_provider(self, idx: int, info: PeerInfo) -> None:
        provs = self._providers.get(idx, [])
        self._providers[idx] = [p for p in provs
                                if p.peer_id != info.peer_id]

    # -- v1 surface ----------------------------------------------------------
    def _call_shard(self, idx: int, payload: Dict[str, Any]) -> Generator:
        provs = yield from self._resolve(idx)
        if payload.get("op") == "score" and len(provs) > 1:
            # stateless + idempotent: hedge the tail on the next-best replica
            resp = yield from self._hedged_score(idx, provs, payload)
            if resp is not None:
                return resp
            provs = yield from self._resolve(idx, refresh=True)
        last: Optional[Exception] = None
        for round_ in range(2):
            ranked = self.router.rank(idx, list(provs),
                                      lambda p: p.peer_id)
            for info in ranked:
                self.stats["calls"] += 1
                t0 = self.node.sim.now
                self.router.begin(idx, info.peer_id)
                try:
                    stub = self.node.stub(InferenceService, info,
                                          scope=f"{self.fleet}.{idx}")
                    resp = yield from stub.infer(payload)
                    self.router.observe(idx, info.peer_id,
                                        self.node.sim.now - t0, True)
                    return resp
                except (RpcError, DialError) as e:
                    self.router.observe(idx, info.peer_id,
                                        self.node.sim.now - t0, False)
                    if (isinstance(e, ServiceError)
                            and not e.status.retryable):
                        raise     # NOT_FOUND etc: a healthy replica answered
                    last = e
                    self.stats["failovers"] += 1
                    self._drop_provider(idx, info)
                finally:
                    self.router.end(idx, info.peer_id)
            provs = yield from self._resolve(idx, refresh=True)
        raise RpcError(f"all providers for shard {idx} failed: {last}")

    def _hedged_score(self, idx: int, provs: List[PeerInfo],
                      payload: Dict[str, Any]) -> Generator:
        ranked = self.router.rank(idx, list(provs), lambda p: p.peer_id)

        def attempt(info: PeerInfo):
            def run() -> Generator:
                self.stats["calls"] += 1
                t0 = self.node.sim.now
                self.router.begin(idx, info.peer_id)
                try:
                    stub = self.node.stub(InferenceService, info,
                                          scope=f"{self.fleet}.{idx}")
                    # the dedicated score method declares idempotent=True;
                    # hedging the stateful `infer` would violate L004
                    resp = yield from stub.score(payload)
                    self.router.observe(idx, info.peer_id,
                                        self.node.sim.now - t0, True)
                    return resp
                except (RpcError, DialError):
                    self.router.observe(idx, info.peer_id,
                                        self.node.sim.now - t0, False)
                    self.stats["failovers"] += 1
                    self._drop_provider(idx, info)
                    raise
                finally:
                    self.router.end(idx, info.peer_id)
            return run

        try:
            resp = yield from hedged_call(
                self.node.sim, [attempt(p) for p in ranked[:3]],
                self.hedge_after, self.stats)
            return resp
        except (RpcError, DialError):
            return None           # caller falls back to sequential failover

    # -- v1 pipeline ops -----------------------------------------------------
    def prefill(self, tokens: np.ndarray, max_len: int) -> Generator:
        session = (self.node.host.name, next(_session_seq))
        x: Any = tokens
        for i in range(self.n_shards):
            payload = {"op": "prefill", "session": session, "x": x,
                       "max_len": max_len}
            resp = yield from self._call_shard(i, payload)
            x = resp["x"]
        return session, x                        # x = last-position logits

    def decode_step(self, session: Any, token: np.ndarray) -> Generator:
        x: Any = token
        for i in range(self.n_shards):
            payload = {"op": "decode", "session": session, "x": x}
            resp = yield from self._call_shard(i, payload)
            x = resp["x"]
        return x

    def score(self, tokens: np.ndarray) -> Generator:
        x: Any = tokens
        for i in range(self.n_shards):
            payload = {"op": "score", "x": x}
            resp = yield from self._call_shard(i, payload)
            x = resp["x"]
        return x

    def generate(self, tokens: np.ndarray, n_tokens: int) -> Generator:
        """Greedy v1 generation with mid-generation session migration: when
        a provider dies between decode steps, the session's KV state is gone
        with it — replay prompt ⊕ generated on a freshly resolved chain and
        keep going rather than losing the session."""
        max_len = tokens.shape[1] + n_tokens + 1
        session, logits = yield from self.prefill(tokens, max_len)
        out: List[np.ndarray] = []
        migrations = 0
        while len(out) < n_tokens:
            tok = np.argmax(logits, axis=-1).astype(np.int32)
            out.append(tok)
            if len(out) == n_tokens:
                break
            try:
                logits = yield from self.decode_step(session, tok)
            except (RpcError, DialError):
                migrations += 1
                if migrations > self.max_migrations:
                    raise
                self.stats["sessions_migrated"] += 1
                replay = np.concatenate(
                    [tokens] + [t[:, None] for t in out], axis=1)
                session, logits = yield from self.prefill(replay, max_len)
        return np.stack(out, axis=1)

    # -- v2 continuous-batching driver --------------------------------------
    def submit(self, tokens: np.ndarray, n_tokens: int,
               temperature: float = 0.0, seed: int = 0) -> Any:
        """Enqueue one generation request; returns an Event that succeeds
        with the generated token array (None if the session failed after
        exhausting retries)."""
        prompt = np.asarray(tokens, np.int32).reshape(1, -1)
        req = _Request(prompt, n_tokens, temperature, seed,
                       self.node.sim.event(), self.node.sim.now)
        self.stats["requests"] += 1
        self._pending.append(req)
        self._kick()
        return req.done

    def generate_concurrent(self, requests: List[Dict[str, Any]]) -> Generator:
        """Submit many requests and wait for all; each request is a dict of
        ``submit`` kwargs.  Returns the per-request token arrays."""
        events = [self.submit(**r) for r in requests]
        results = []
        for ev in events:
            res = yield ev
            results.append(res)
        return results

    def _kick(self) -> None:
        if not self._pump_alive:
            self._pump_alive = True
            self.node.sim.process(self._pump())
        elif self._wake is not None and not self._wake.triggered:
            self._wake.succeed()

    def _pump(self) -> Generator:
        """Iteration-level scheduler: start admissions as they arrive, run
        one decode round per iteration over every active session, grouped
        by provider chain (one ``step`` RPC per shard hop per group)."""
        sim = self.node.sim
        try:
            while self._pending or self._admitting or self._active:
                while self._pending:
                    req = self._pending.popleft()
                    self._admitting.add(req)
                    sim.process(self._admit(req))
                if self._active:
                    yield from self._decode_round()
                else:
                    self._wake = sim.event()
                    yield sim.any_of([self._wake, sim.timeout(0.02)])
                    self._wake = None
        finally:
            self._pump_alive = False
        return None

    def _admit(self, req: _Request) -> Generator:
        try:
            status = yield from self._try_admit(req)
        except (RpcError, DialError):
            status = "retry"
        finally:
            self._admitting.discard(req)
        if status == "active":
            self._active.append(req)
        elif status == "retry":
            req.attempts += 1
            if req.attempts >= self.max_session_attempts:
                self._fail(req)
            else:
                yield self.node.sim.timeout(0.1 * req.attempts)
                self._pending.append(req)
        self._kick()
        return None

    def _try_admit(self, req: _Request) -> Generator:
        """Route a chain through the shards and prefill (or replay) the
        request on it.  Returns "active", "done", or "retry"."""
        sid = (self.node.host.name, next(_session_seq))
        x: Any = np.concatenate(
            [req.prompt,
             np.asarray(req.generated, np.int32).reshape(1, -1)], axis=1)
        max_len = req.prompt.shape[1] + req.n_tokens + 1
        chain: List[PeerInfo] = []
        for i in range(self.n_shards):
            provs = yield from self._resolve(i)
            if not provs:
                provs = yield from self._resolve(i, refresh=True)
            resp = None
            for info in self.router.rank(i, list(provs),
                                         lambda p: p.peer_id):
                self.stats["calls"] += 1
                t0 = self.node.sim.now
                self.router.begin(i, info.peer_id)
                try:
                    stub = self.node.stub(InferenceV2Service, info,
                                          scope=f"{self.fleet}.{i}")
                    resp = yield from stub.open(
                        {"session": sid, "x": x, "max_len": max_len})
                    self.router.observe(i, info.peer_id,
                                        self.node.sim.now - t0, True)
                    chain.append(info)
                    break
                except (RpcError, DialError):
                    self.router.observe(i, info.peer_id,
                                        self.node.sim.now - t0, False)
                    self.stats["failovers"] += 1
                    self._drop_provider(i, info)
                finally:
                    self.router.end(i, info.peer_id)
            if resp is None:
                self._spawn_close(sid, chain)
                return "retry"
            x = resp["x"]
        req.session = sid
        req.chain = chain
        req.generated.append(self._sample(req, np.asarray(x)[0]))
        if len(req.generated) >= req.n_tokens:
            self._finish(req, in_active=False)
            return "done"
        return "active"

    def _decode_round(self) -> Generator:
        groups: Dict[Tuple, List[_Request]] = {}
        for req in list(self._active):
            key = tuple(p.peer_id for p in req.chain)
            groups.setdefault(key, []).append(req)
        procs = [self.node.sim.process(self._step_group(reqs))
                 for reqs in groups.values()]
        for p in procs:
            yield p
        return None

    def _step_group(self, reqs: List[_Request]) -> Generator:
        """One decode iteration for every session pinned to one chain: a
        single batched ``step`` RPC per shard hop.  Providers that died take
        the whole group to migration; sessions a provider no longer holds
        (post-restart) migrate individually via the ``served`` list."""
        chain = reqs[0].chain
        live = list(reqs)
        x: Any = np.asarray([r.generated[-1] for r in live], np.int32)
        for i, info in enumerate(chain):
            payload = {"sessions": [r.session for r in live], "x": x}
            self.stats["calls"] += 1
            t0 = self.node.sim.now
            self.router.begin(i, info.peer_id)
            try:
                stub = self.node.stub(InferenceV2Service, info,
                                      scope=f"{self.fleet}.{i}")
                resp = yield from stub.step(payload)
                self.router.observe(i, info.peer_id,
                                    self.node.sim.now - t0, True)
            except (RpcError, DialError):
                self.router.observe(i, info.peer_id,
                                    self.node.sim.now - t0, False)
                self.stats["failovers"] += 1
                self._drop_provider(i, info)
                for r in live:
                    self._migrate(r)
                return None
            finally:
                self.router.end(i, info.peer_id)
            served = {tuple(s) for s in resp["served"]}
            missing = [r for r in live if r.session not in served]
            for r in missing:
                self._migrate(r)
            # response rows align with the engine's served order, which is
            # the payload order filtered to sessions the shard still holds
            live = [r for r in live if r.session in served]
            if not live:
                return None
            x = resp["x"]
        for r, row in zip(live, x):
            r.generated.append(self._sample(r, row))
            if len(r.generated) >= r.n_tokens:
                self._finish(r)
        return None

    def _sample(self, req: _Request, logits: np.ndarray) -> int:
        if req.temperature <= 0.0:
            return int(np.argmax(logits))
        z = logits.astype(np.float64) / req.temperature
        z -= z.max()
        p = np.exp(z)
        p /= p.sum()
        return int(req.rng.choice(len(p), p=p))

    def _migrate(self, req: _Request) -> None:
        """Provider died (or lost the session) mid-generation: replay
        prompt ⊕ generated on a freshly routed chain.  Client-side sampling
        means no tokens are lost — only the dead shard's KV is recomputed."""
        if req in self._active:
            self._active.remove(req)
        self._spawn_close(req.session, req.chain)
        req.migrations += 1
        self.stats["sessions_migrated"] += 1
        req.session, req.chain = None, []
        if req.migrations > self.max_migrations:
            self._fail(req)
            return
        self._pending.append(req)
        self._kick()

    def _finish(self, req: _Request, in_active: bool = True) -> None:
        if in_active and req in self._active:
            self._active.remove(req)
        req.finished_at = self.node.sim.now
        self._spawn_close(req.session, req.chain)
        self.stats["completed"] += 1
        req.done.succeed(np.asarray(req.generated, np.int32))

    def _fail(self, req: _Request) -> None:
        self.stats["failed_sessions"] += 1
        req.done.succeed(None)

    def _spawn_close(self, sid: Any, chain: List[PeerInfo]) -> None:
        if sid is None or not chain:
            return
        self.node.sim.process(self._close_session(sid, list(chain)))

    def _close_session(self, sid: Any, chain: List[PeerInfo]) -> Generator:
        for i, info in enumerate(chain):
            try:
                stub = self.node.stub(InferenceV2Service, info,
                                      scope=f"{self.fleet}.{i}")
                yield from stub.close([sid])
            except (RpcError, DialError):
                pass              # dead provider needs no eviction
        return None


def deploy_sharded(nodes: List[LatticaNode], cfg: ModelConfig, params: Any,
                   fleet: str, replicas: int = 1, n_slots: int = 8,
                   page_size: int = 32,
                   kv_dtype: str = "fp32") -> List[ShardServer]:
    """Place ``n_shards = len(nodes) // replicas`` pipeline shards, each
    replicated ``replicas`` times across the given nodes."""
    n_shards = len(nodes) // replicas
    plan = plan_shards(cfg, n_shards)
    parts = split_params(cfg, params, plan)
    servers = []
    for r in range(replicas):
        for i, (lo, hi) in enumerate(plan):
            node = nodes[r * n_shards + i]
            module = ShardModule(cfg, parts[i], (lo, hi),
                                 is_first=(i == 0), is_last=(i == n_shards - 1))
            servers.append(ShardServer(node, cfg, fleet, i, module,
                                       n_slots=n_slots, page_size=page_size,
                                       kv_dtype=kv_dtype))
    return servers


def serve_fleet(nodes: List[LatticaNode], cfg: ModelConfig, params: Any,
                fleet: str, replicas: int = 1, n_slots: int = 8,
                page_size: int = 32, kv_dtype: str = "fp32",
                publisher: Optional[LatticaNode] = None) -> Generator:
    """Full serving bring-up: deploy shards, announce DHT providers,
    publish every shard's param sub-DAG + the serving plan into the CRDT
    plane (what :class:`~repro.serving.pressure.PressureMonitor` replicas
    fetch), and start per-server load publishing.  Returns the servers."""
    from .pressure import load_publisher, publish_serving_plan

    servers = deploy_sharded(nodes, cfg, params, fleet, replicas=replicas,
                             n_slots=n_slots, page_size=page_size,
                             kv_dtype=kv_dtype)
    for s in servers:
        yield from s.announce()
    n_shards = len(servers) // replicas
    plan = plan_shards(cfg, n_shards)
    parts = split_params(cfg, params, plan)
    pub = publisher or nodes[0]
    yield from publish_serving_plan(pub, fleet, plan, parts)
    for s in servers:
        s.node.sim.process(load_publisher(s), daemon=True)
    return servers
