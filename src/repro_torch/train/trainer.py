"""Training loops: the JAX package's plain local ``Trainer``, and the
mesh's ``LatticaSyncTrainer`` and ``ModelSubscriber``.

``Trainer`` is the port's own (it also takes ``microbatches``).
``LatticaSyncTrainer`` and ``ModelSubscriber`` are copies of the JAX
package's classes, held to them as syntax trees by
``tests/test_torch_collab.py``: a trainer that publishes model versions
into the Lattica mesh (``repro_torch.core``, ``checkpoint.lattica_ckpt``)
and an inference cluster that follows them.  The step is the port's
``make_train_step``, with no ``jax.jit``; a subscriber's ``like`` decides
where the fetched leaves go, each on the device of ``like``'s leaf.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Generator, Iterator, List, Optional

import numpy as np

from ..checkpoint.lattica_ckpt import (CheckpointRegistry,
                                       CheckpointService,
                                       fetch_checkpoint,
                                       publish_checkpoint,
                                       serve_checkpoints)
from ..core.dht import PeerInfo
from ..core.cid import CID, ChunkSpec
from ..core.node import LatticaNode
from ..models.config import ModelConfig
from .step import TrainState, make_train_step


class Trainer:
    def __init__(self, cfg: ModelConfig, state: TrainState,
                 schedule: Callable[[int], float],
                 data: Iterator[Dict[str, np.ndarray]], microbatches: int = 1):
        self.cfg = cfg
        self.state = state
        self.data = data
        self.step_fn = make_train_step(cfg, schedule, microbatches=microbatches)
        self.history: List[Dict[str, float]] = []

    def run(self, n_steps: int, log_every: int = 10,
            log: Optional[Callable[[str], None]] = print
            ) -> List[Dict[str, float]]:
        for i in range(n_steps):
            batch = next(self.data)
            self.state, metrics = self.step_fn(self.state, batch)
            rec = {k: float(v) for k, v in metrics.items()}
            rec["step"] = i
            self.history.append(rec)
            if log is not None and (i % log_every == 0 or i == n_steps - 1):
                log(f"step {i:5d}  loss={rec['loss']:.4f}  "
                    f"lr={rec['lr']:.2e}  gnorm={rec['grad_norm']:.2f}")
        return self.history


class LatticaSyncTrainer(Trainer):
    """Trainer that publishes model versions into a Lattica mesh.

    The simulation clock advances only inside mesh operations; jax compute
    is charged to the node's CPU via an estimated step time.
    """

    def __init__(self, cfg: ModelConfig, state: TrainState,
                 schedule: Callable, data: Iterator[Dict[str, np.ndarray]],
                 node: LatticaNode, fleet: str,
                 publish_every: int = 50, step_seconds: float = 0.5,
                 chunk_spec: Optional[ChunkSpec] = None):
        super().__init__(cfg, state, schedule, data)
        self.node = node
        self.fleet = fleet
        self.publish_every = publish_every
        self.step_seconds = step_seconds
        #: chunking strategy for published versions; every publish uses the
        #: same spec so leaf boundaries (and unchanged-content CIDs)
        #: reproduce across versions
        self.chunk_spec = chunk_spec
        self.published: List[CID] = []
        serve_checkpoints(node)   # subscribers may resolve 'latest' directly

    def run_mesh(self, n_steps: int,
                 log: Optional[Callable[[str], None]] = print) -> Generator:
        """A sim-process: train; every ``publish_every`` steps, publish.
        Each publish passes the previous version as ``base`` so the
        announcement carries delta stats (new vs reused blocks/bytes)."""
        for i in range(n_steps):
            batch = next(self.data)
            self.state, metrics = self.step_fn(self.state, batch)
            rec = {k: float(v) for k, v in metrics.items()}
            rec["step"] = i
            self.history.append(rec)
            yield self.step_seconds                    # wall-clock of the step
            if (i + 1) % self.publish_every == 0 or i == n_steps - 1:
                base = self.published[-1] if self.published else None
                root = yield from publish_checkpoint(
                    self.node, self.state.params, i + 1, self.fleet,
                    base=base, spec=self.chunk_spec)
                self.published.append(root)
                yield from self._gossip_registry()
                if log is not None:
                    log(f"[{self.node.host.name}] published step {i+1} "
                        f"loss={rec['loss']:.4f} root={root}")
        return self.published

    def _gossip_registry(self, fanout: int = 2) -> Generator:
        """Propagate the fresh registry entry right after a publish.

        Primary path: flush the delta push plane — the mutations from
        ``publish_checkpoint`` go out as per-key delta documents on the
        ``crdt/<ns>`` topics, so connected subscribers' ``watch`` callbacks
        fire within one gossip round.  Fallback: a couple of direct
        anti-entropy rounds with random peers for anyone the flood missed
        (NAT'd stragglers, empty meshes) — each of those now moves only
        per-key deltas, not the whole serialized store."""
        yield from self.node.crdt_push_flush()
        sim = self.node.sim
        peers = sorted(self.node.peers, key=lambda p: p.digest)
        if not peers:
            return None
        for pid in sim.rng.sample(peers, min(fanout, len(peers))):
            try:
                yield from self.node.sync_crdt_with(self.node.peers[pid])
            except Exception:        # noqa: BLE001 — unreachable peer
                continue
        return None


class ModelSubscriber:
    """Inference-cluster side: follow a fleet's model versions.

    Registry freshness is event-driven: the subscriber *watches*
    ``ckpt/<fleet>`` through the node's CRDT delta push plane, so a
    publisher's registry write lands here one gossip round after the
    publish and wakes the follow loop immediately — no anti-entropy
    lottery.  With ``resolve_from`` (the publisher's PeerInfo), each poll
    additionally asks that peer's ``CheckpointService`` for the fleet's
    latest version as a fallback — convergence survives missed floods and
    partitions (an unreachable peer just falls back to local knowledge).
    """

    def __init__(self, node: LatticaNode, cfg: ModelConfig, fleet: str,
                 like: Any = None, resolve_from: Optional[PeerInfo] = None):
        self.node = node
        self.cfg = cfg
        self.fleet = fleet
        self.like = like
        self.resolve_from = resolve_from
        self.registry = CheckpointRegistry(node, fleet)
        self.current_step = -1
        self.params: Any = None
        self.fetch_log: List[Dict[str, float]] = []
        self._announced: List[Any] = []
        self._wake = node.sim.event()
        node.pubsub.subscribe(self.registry.topic, self._on_announce)
        # pushed registry deltas (and merged-in anti-entropy state) wake
        # the follow loop the moment the local replica learns of a change
        node.watch_crdt(f"ckpt/{fleet}", self._on_registry_change)

    def _on_announce(self, topic: str, data: Any, frm: Any) -> None:
        self._announced.append(data)
        self._wakeup()

    def _on_registry_change(self, key: str, value: Any, origin: str) -> None:
        if origin == "remote":      # our own record_fetched must not self-wake
            self._wakeup()

    def _wakeup(self) -> None:
        if not self._wake.triggered:
            self._wake.succeed()

    def _best_known(self) -> Any:
        """Newest version from the CRDT register AND live announcements;
        returns ((step, root) or None, publisher PeerInfo or None)."""
        from ..checkpoint.lattica_ckpt import safe_meta_loads

        best = self.registry.latest()
        publisher: Optional[PeerInfo] = None
        for d in self._announced:
            if not (isinstance(d, tuple) and d and d[0] == "artifact"):
                continue
            try:
                # announcement meta is peer-supplied: restricted unpickle
                meta = safe_meta_loads(d[3])
                step = meta["step"]
            except Exception:        # noqa: BLE001 — malformed announcement
                continue
            if best is None or step > best[0]:
                best = (step, d[1])
                publisher = meta.get("publisher")
        self._announced.clear()
        return best, publisher

    def _resolve_remote(self) -> Generator:
        """Ask the publisher's CheckpointService for its latest (step, root);
        None when unset or unreachable."""
        if self.resolve_from is None:
            return None
        try:
            stub = self.node.stub(CheckpointService, self.resolve_from)
            return (yield from stub.latest(self.fleet))
        except Exception:            # noqa: BLE001 — partition/dead peer
            return None

    def poll_and_fetch(self) -> Generator:
        """Fetch the newest known version (CheckpointService resolution,
        CRDT register, or pubsub announcement) if newer than ours.  Returns
        the step, or None."""
        latest, publisher = self._best_known()
        remote = yield from self._resolve_remote()
        if remote is not None and (latest is None or remote[0] > latest[0]):
            latest = remote
            publisher = self.resolve_from
        if latest is None:
            return None
        step, root = latest
        if step <= self.current_step:
            return None
        t0 = self.node.sim.now
        hints = [publisher] if publisher is not None else None
        params = yield from fetch_checkpoint(self.node, root, self.like,
                                             hint_providers=hints,
                                             fleet=self.fleet)
        self.fetch_log.append({
            "step": step, "t_fetch": self.node.sim.now - t0,
            "bytes": self.node.bitswap.stats["bytes_fetched"]})
        self.current_step = step
        self.params = params
        # note the version in our ORSet replica (never the LWW pointer —
        # see CheckpointRegistry.record_fetched)
        self.registry.record_fetched(step, root)
        if publisher is not None:
            # one direct anti-entropy round with the publisher pins the LWW
            # register to what we just fetched — registry convergence no
            # longer waits on random gossip reaching this replica
            try:
                yield from self.node.sync_crdt_with(publisher)
            except Exception:        # noqa: BLE001 — partition/dead peer
                pass
        return step

    def follow(self, interval: float = 5.0, until_step: int = 10**9) -> Generator:
        """Background process: fetch new versions as they appear.

        Event-driven: a pushed registry delta (or a pubsub announcement)
        wakes the loop immediately; the ``interval`` poll is the fallback
        when no push arrives (partitions, missed floods), resolving through
        the publisher's ``CheckpointService`` when ``resolve_from`` is set.
        The old random-peer anti-entropy round per tick is gone — the push
        plane delivers registry changes in one gossip round instead."""
        sim = self.node.sim
        while self.current_step < until_step:
            yield sim.any_of([self._wake, sim.timeout(interval)])
            # always a fresh event: re-arming only on trigger would leave
            # the timeout path accumulating stale any_of waiters on the
            # same Event forever; re-arming *before* the poll means a push
            # arriving mid-fetch wakes the next iteration immediately
            self._wake = sim.event()
            try:
                yield from self.poll_and_fetch()
            except Exception:           # noqa: BLE001 — a partition or a
                continue                # dead provider must not kill the loop
        return self.current_step
