"""Replica pressure: serving load feeding back into content replication.

The port's own copy of the JAX package's ``serving/pressure.py``: the
same code under the port's import paths, except that a spawned
replica's fetched parameters move onto the monitor's device (the card
unless the caller asks for the CPU) before its ``ShardServer`` serves
them.

Shard servers publish queue depth and slot occupancy as LWW registers in
the ``serving/<fleet>`` CRDT namespace (delta-pushed on the ``crdt/serving``
topic — PR 5's watch/push plane), alongside a *serving plan* register that
records the layer split and the root CID of each shard's param sub-DAG
(published per shard at deploy time via the delta-friendly checkpoint
path).

A :class:`PressureMonitor` runs on idle peers: it watches the fleet's
load registers, and when a shard stays hot for ``sustain`` consecutive
observations — aggregate (busy slots + queued admissions) / capacity at
or above ``hot_occupancy`` — and the shard has fewer than ``max_replicas``
live replicas, the monitor swarm-fetches that shard's param sub-DAG from
the content plane, constructs a local :class:`ShardServer`, and registers
itself as a new DHT provider of ``shard/<fleet>/<i>``.  Routing pressure
thereby *creates* replicas, the first path in the repo where the serving
plane drives content-plane replication instead of the other way round.

Crash semantics are passive: a dead server simply stops refreshing its
load register, so its samples go stale (``stale_after``) and drop out of
the pressure estimate — no failure detector needed.
"""

from __future__ import annotations

from typing import Any, Dict, Generator, List, Optional, Tuple, Union

import numpy as np
import torch

from ..checkpoint.lattica_ckpt import fetch_checkpoint, publish_checkpoint
from ..core.cid import CID
from ..core.device import resolve_device
from ..core.node import LatticaNode
from ..models.config import ModelConfig
from ..tree import tree_map

__all__ = ["load_key", "plan_key", "replicas_key", "tree_from_flat",
           "publish_serving_plan", "read_serving_plan", "load_publisher",
           "PressureMonitor"]


def load_key(fleet: str, shard_idx: int, host: str) -> str:
    return f"serving/{fleet}/load/{shard_idx}/{host}"


def plan_key(fleet: str) -> str:
    return f"serving/{fleet}/plan"


def replicas_key(fleet: str, shard_idx: int) -> str:
    return f"serving/{fleet}/replicas/{shard_idx}"


def _shard_ckpt_fleet(fleet: str, shard_idx: int) -> str:
    """Checkpoint-registry namespace for one shard's param sub-DAG."""
    return f"{fleet}-shard{shard_idx}"


def tree_from_flat(flat: Dict[str, np.ndarray]) -> Any:
    """Rebuild a nested params pytree from ``{path: leaf}`` with
    ``/``-joined paths (the ``params_to_parts`` naming).  Levels whose keys
    are all decimal integers become lists — which is how list-of-dicts
    block stacks (the ssm arch) flatten."""
    root: Dict[str, Any] = {}
    for path, leaf in flat.items():
        node = root
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf

    def collapse(d: Any) -> Any:
        if not isinstance(d, dict):
            return d
        out = {k: collapse(v) for k, v in d.items()}
        if out and all(k.isdigit() for k in out):
            return [out[k] for k in sorted(out, key=int)]
        return out

    return collapse(root)


# ---------------------------------------------------------------- plan plane
def publish_serving_plan(node: LatticaNode, fleet: str,
                         plan: List[Tuple[int, int]],
                         parts: List[Dict[str, Any]]) -> Generator:
    """Publish every shard's param subset as its own checkpoint DAG and
    record the serving plan (layer ranges + per-shard root CIDs) in the
    fleet's CRDT namespace.  Returns the per-shard root CIDs."""
    roots: List[CID] = []
    for i, sub in enumerate(parts):
        root = yield from publish_checkpoint(
            node, sub, step=0, fleet=_shard_ckpt_fleet(fleet, i))
        roots.append(root)
    value = (len(plan),
             tuple((lo, hi) for lo, hi in plan),
             tuple((r.codec, r.digest) for r in roots))
    node.store.register(plan_key(fleet)).set(
        value, node.sim.now, node.host.name)
    return roots


def read_serving_plan(node: LatticaNode, fleet: str,
                      ) -> Optional[Tuple[int, List[Tuple[int, int]],
                                          List[CID]]]:
    val = node.store.register(plan_key(fleet)).value()
    if val is None:
        return None
    n_shards, plan, roots = val
    return (int(n_shards),
            [(int(lo), int(hi)) for lo, hi in plan],
            [CID(int(c), bytes(d)) for c, d in roots])


# ---------------------------------------------------------------- load plane
def load_publisher(server: Any, interval: float = 0.25,
                   refresh: float = 2.0) -> Generator:
    """Server-side loop: keep ``serving/<fleet>/load/<shard>/<host>`` fresh.

    Writes on occupancy change and at least every ``refresh`` seconds
    (the heartbeat that distinguishes *idle* from *dead*); stops when the
    server stops, which is exactly what lets monitors age the sample out.
    """
    node = server.node
    key = load_key(server.fleet, server.shard_idx, node.host.name)
    last: Optional[Tuple[int, int]] = None
    last_pub = -1e9
    node.store.orset(replicas_key(server.fleet, server.shard_idx)).add(
        node.host.name, node.host.name)
    while server.alive:
        eng = server.engine
        cur = (eng.slots_used, eng.queue_depth)
        now = node.sim.now
        if cur != last or now - last_pub >= refresh:
            node.store.register(key).set(
                (cur[0], cur[1], eng.n_slots, round(now, 3)),
                now, node.host.name)
            last, last_pub = cur, now
        yield interval
    return None


# ------------------------------------------------------------------ monitor
class PressureMonitor:
    """Idle-peer loop that turns sustained shard pressure into a replica."""

    def __init__(self, node: LatticaNode, cfg: ModelConfig, fleet: str,
                 hot_occupancy: float = 0.75, sustain: int = 3,
                 interval: float = 0.5, stale_after: float = 3.0,
                 max_replicas: int = 3, n_slots: int = 8,
                 page_size: int = 32,
                 cold_occupancy: float = 0.15, cold_sustain: int = 6,
                 device: Union[str, torch.device] = "cuda"):
        self.node = node
        self.cfg = cfg
        self.fleet = fleet
        self.hot_occupancy = hot_occupancy
        self.sustain = sustain
        self.interval = interval
        self.stale_after = stale_after
        self.max_replicas = max_replicas
        self.n_slots = n_slots
        self.page_size = page_size
        #: retirement thresholds: a shard whose aggregate occupancy stays
        #: below ``cold_occupancy`` for ``cold_sustain`` consecutive
        #: observations gets its monitor-spawned replica retired (once
        #: drained) — pressure creates replicas AND takes them back
        self.cold_occupancy = cold_occupancy
        self.cold_sustain = cold_sustain
        self.running = True
        self.spawned: List[Any] = []
        self._spawned_shards: set = set()
        self._streak: Dict[int, int] = {}
        self._cold_streak: Dict[int, int] = {}
        self.stats = {"observations": 0, "hot_observations": 0, "spawned": 0,
                      "fetch_failures": 0, "retired": 0}
        #: where spawned replicas serve: the card unless asked for the CPU
        self.device = resolve_device(device)
        node.join_crdt_push("serving")

    def stop(self) -> None:
        self.running = False

    # -- pressure estimate ---------------------------------------------------
    def shard_pressure(self) -> Dict[int, float]:
        """Per-shard (busy slots + queued) / capacity over fresh samples."""
        prefix = f"serving/{self.fleet}/load/"
        now = self.node.sim.now
        agg: Dict[int, List[Tuple[int, int, int]]] = {}
        for key in list(self.node.store.entries):
            if not key.startswith(prefix):
                continue
            val = self.node.store.register(key).value()
            if val is None:
                continue
            used, queued, n_slots, ts = val
            if now - float(ts) > self.stale_after:
                continue        # dead or partitioned replica: age it out
            shard = int(key[len(prefix):].split("/", 1)[0])
            agg.setdefault(shard, []).append(
                (int(used), int(queued), int(n_slots)))
        out: Dict[int, float] = {}
        for shard, samples in agg.items():
            cap = sum(s[2] for s in samples)
            demand = sum(s[0] + s[1] for s in samples)
            out[shard] = demand / cap if cap else 0.0
        return out

    def replica_count(self, shard_idx: int) -> int:
        return len(self.node.store.orset(
            replicas_key(self.fleet, shard_idx)).value())

    # -- main loop -----------------------------------------------------------
    def run(self) -> Generator:
        while self.running:
            yield self.interval
            self.stats["observations"] += 1
            pressure = self.shard_pressure()
            for shard, p in pressure.items():
                if p >= self.hot_occupancy:
                    self.stats["hot_observations"] += 1
                    self._streak[shard] = self._streak.get(shard, 0) + 1
                else:
                    self._streak[shard] = 0
                if (self._streak.get(shard, 0) >= self.sustain
                        and shard not in self._spawned_shards
                        and self.replica_count(shard) < self.max_replicas):
                    yield from self.spawn_replica(shard)
            # -- retirement: sustained cold + drained → scale back down
            for server in list(self.spawned):
                shard = server.shard_idx
                if pressure.get(shard, 0.0) <= self.cold_occupancy:
                    self._cold_streak[shard] = \
                        self._cold_streak.get(shard, 0) + 1
                else:
                    self._cold_streak[shard] = 0
                eng = server.engine
                if (self._cold_streak.get(shard, 0) >= self.cold_sustain
                        and eng.slots_used == 0 and eng.queue_depth == 0):
                    yield from self.retire_replica(server)
        return None

    def retire_replica(self, server: Any) -> Generator:
        """Gracefully take a monitor-spawned replica back out of service:
        withdraw the DHT provider record, leave the replica ORSet, release
        the pinned shard params.  The load register is *not* touched — the
        stopped publisher loop lets it age out, the same passive path that
        covers crashes.  The shard stays eligible for a future respawn."""
        shard = server.shard_idx
        server.alive = False              # drained by precondition: no waiters
        yield from server.unannounce()
        self.node.store.orset(replicas_key(self.fleet, shard)).remove(
            self.node.host.name)
        self.node.unpin_latest(f"ckpt/{_shard_ckpt_fleet(self.fleet, shard)}")
        self.spawned.remove(server)
        self._spawned_shards.discard(shard)
        self._cold_streak[shard] = 0
        self.stats["retired"] += 1
        return None

    def _pull_plane(self) -> Generator:
        """One-shot anti-entropy with a few known peers: a monitor that
        joined after the plan was published (push only carries *new*
        mutations) reconciles the serving namespace off the mesh."""
        peers = sorted(self.node.peers, key=lambda p: p.digest)
        self.node.sim.rng.shuffle(peers)
        for pid in peers[:3]:
            try:
                yield from self.node.sync_crdt_with(self.node.peers[pid])
            except Exception:   # noqa: BLE001 — peer down; try the next
                continue
            if self.node.store.register(
                    plan_key(self.fleet)).value() is not None:
                return
        return None

    def spawn_replica(self, shard_idx: int) -> Optional[Any]:
        """Fetch the shard's param sub-DAG and start serving it."""
        from .sharded import ShardModule, ShardServer

        plan = read_serving_plan(self.node, self.fleet)
        if plan is None:
            yield from self._pull_plane()
            plan = read_serving_plan(self.node, self.fleet)
        if plan is None:
            return None
        n_shards, ranges, roots = plan
        self._spawned_shards.add(shard_idx)   # one attempt per shard
        try:
            flat = yield from fetch_checkpoint(
                self.node, roots[shard_idx],
                fleet=_shard_ckpt_fleet(self.fleet, shard_idx))
        except Exception:       # noqa: BLE001 — swarm fetch failed; back off
            self.stats["fetch_failures"] += 1
            self._spawned_shards.discard(shard_idx)
            return None
        params = tree_map(lambda t: t.to(self.device), tree_from_flat(flat))
        module = ShardModule(self.cfg, params, ranges[shard_idx],
                             is_first=(shard_idx == 0),
                             is_last=(shard_idx == n_shards - 1))
        server = ShardServer(self.node, self.cfg, self.fleet, shard_idx,
                             module, n_slots=self.n_slots,
                             page_size=self.page_size)
        yield from server.announce()
        self.node.sim.process(load_publisher(server), daemon=True)
        self.spawned.append(server)
        self.stats["spawned"] += 1
        return server
