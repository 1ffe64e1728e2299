"""DiLoCo-style collaborative training over the Lattica mesh.

The port's own copy of the JAX package's ``train/collab.py``, held to
it as a syntax tree by ``tests/test_torch_collab.py``.  The inner steps
run the port's ``make_train_step`` on the device of the worker's
parameters, the eval loss runs under ``torch.no_grad()``, and the round
start rebuilds the parameters from the numpy outer state as fresh
tensors on the device and in the dtype of the worker's current tree
(``_params_like``): the port's AdamW updates parameters in place, so a
leaf that shared memory with ``start_flat`` would overwrite the round's
start and zero its pseudo-gradient.  The AdamW moments carry over from
round to round, as in the reference.  The outer math is the same numpy,
the outer step's evaluated over blocks of entries as the pseudo-gradient's
(``compress._blockwise``), to the same bits.

Each worker trains locally for ``inner_steps`` (H) AdamW steps, then
publishes its **pseudo-gradient** — the outer delta ``theta_round_start -
theta_after_H`` — as a content DAG over bitswap, compressed by top-k
sparsification + int8 block quantization with local error feedback
(:mod:`repro.train.compress`).  One communication round per H steps at a
few percent of the fp32 bytes is what makes geo-distributed training over
heterogeneous inter-region links viable at all (BlockTrain / ScaleAcross
setting; DiLoCo is the outer-optimizer recipe).

**No coordinator exists.**  Round state lives in the CRDT store under a
``train/<fleet>`` namespace and rides the delta push plane:

  * ``train/<fleet>/r<k>/members``     ORSet of worker names in round k
  * ``train/<fleet>/r<k>/c/<worker>``  LWW → (cid codec, digest, bytes…)
  * ``train/<fleet>/r<k>/closed``      LWW → sorted contributor tuple

A round *closes* when a quorum fraction of announced members have
contribution CIDs visible and a settle window has passed; any contributor
may then write the ``closed`` register.  Concurrent closers converge
deterministically: the register is written with a constant timestamp
(the round index), so the LWW tie-break on replica id picks the same
winner on every replica regardless of merge order.  A worker that applied
a losing closed-set detects the flip at the next round boundary and
**rebases**: it rewinds to its saved pre-round outer state and replays the
authoritative sets, so outer state never forks.  Stragglers that miss the
closed set fold their already-computed delta back into their error-feedback
residual — work is deferred, not lost.  Workers that drop mid-round simply
stop contributing; the quorum closes without them, and on rejoin they merge
the closed rounds from the CRDT store and replay the pinned contribution
DAGs to catch up (``catch_up``).

Every worker that saw the same contribution set applies the identical
Nesterov outer step (float64-accumulated average, float32 outer math), so
outer params are bit-identical across the fleet — verifiable remotely via
``CollabService.status`` digests without shipping any state.

Contribution DAGs are pinned for ``keep_rounds`` rounds (the rejoin replay
window) and unpinned after; a simsan leak gauge counts overdue pins so a
forgotten unpin fails the sanitizer, not production memory.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import (Any, Callable, Dict, Generator, Iterator, List, Optional,
                    Tuple)

import numpy as np
import torch

from ..checkpoint.serial import _map_with_path
from ..core.bitswap import FetchError
from ..core.cid import CID, decode_manifest_v2, manifest_version, read_dag
from ..core.node import LatticaNode
from ..core.rpc import RpcContext, RpcError
from ..core.service import (Fixed, RpcStatus, Service, ServiceError,
                            pickled, unary)
from ..core.simnet import DialError
from ..models import ops_for
from ..models.config import ModelConfig
from ..tree import leaves

from .compress import (_blockwise, average_flat, compress_pseudograd,
                       flat_digest, flat_from_entries, pseudo_gradient,
                       tree_to_flat)
from .step import TrainState, make_train_step

__all__ = ["CollabConfig", "CollabService", "CollabWorker", "serve_collab"]


def _params_like(flat: Dict[str, np.ndarray], like: Any,
                 trainable: bool = False) -> Any:
    """``flat``'s arrays in ``like``'s structure, each a fresh tensor on
    the device and in the dtype of ``like``'s leaf at its path, so that an
    in-place update never writes into ``flat``; with ``trainable``, marked
    as requiring grad, as ``train_state_init`` marks them.  A shape that
    differs from ``like``'s raises ``ValueError``."""
    def put(name: str, leaf: torch.Tensor) -> torch.Tensor:
        arr = flat[name]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"leaf {name}: outer shape {arr.shape} != "
                             f"{tuple(leaf.shape)}")
        out = torch.tensor(arr, dtype=leaf.dtype, device=leaf.device)
        return out.requires_grad_(trainable)
    return _map_with_path(put, like)


def _eval_loss(ops: Any, cfg: ModelConfig) -> Callable:
    """``ops.loss_fn``'s loss of a numpy batch, moved to the device of the
    parameters, under ``torch.no_grad()``."""
    @torch.no_grad()
    def loss(params: Any, batch: Dict[str, np.ndarray]) -> torch.Tensor:
        dev = leaves(params)[0].device
        return ops.loss_fn(params, cfg, {k: torch.as_tensor(v, device=dev)
                                         for k, v in batch.items()})[0]
    return loss


@dataclass
class CollabConfig:
    """Knobs of the collaborative round protocol."""

    inner_steps: int = 50        #: H — local AdamW steps per round
    quorum: float = 0.5          #: fraction of announced members that closes
    settle: float = 1.0          #: extra seconds after quorum for stragglers
    round_timeout: float = 120.0  #: close with whatever landed after this
    topk_frac: float = 0.05      #: kept fraction per leaf
    quant: Optional[str] = "int8_block"  #: kept-value codec (None = raw f32)
    outer_lr: float = 0.7        #: Nesterov outer-SGD learning rate
    outer_momentum: float = 0.9
    nesterov: bool = True
    keep_rounds: int = 2         #: pinned past rounds (rejoin replay window)


class CollabService(Service):
    """Remote view of a node's collaborative workers: current round,
    outer-state digest, round counters.  Lets peers (and tests) verify
    replicated outer state converged without shipping parameters, and
    lets a rejoiner learn how far behind it is.  Read-only → idempotent."""

    name = "collab"

    def __init__(self, node: LatticaNode):
        self.node = node
        self.workers: Dict[str, "CollabWorker"] = {}

    @unary("collab.status", request=Fixed(64), response=pickled(floor=96),
           idempotent=True, timeout=15.0)
    def status(self, fleet: Any, ctx: RpcContext) -> Generator:
        yield ctx.cpu(2e-6)
        w = self.workers.get(fleet)
        if w is None:
            raise ServiceError(RpcStatus.NOT_FOUND,
                               f"no collab worker for fleet {fleet!r}")
        return {"round": w.outer_round, "digest": w.outer_digest(),
                "closed": w.stats["rounds_closed"],
                "rebases": w.stats["rebases"]}


def serve_collab(node: LatticaNode) -> CollabService:
    """Expose (and share) the node's ``CollabService`` — one per node, so
    several fleets' workers on the same node register with one router
    entry."""
    svc = getattr(node, "_collab_service", None)
    if svc is None:
        svc = node.serve(CollabService(node))
        node._collab_service = svc
    return svc


class CollabWorker:
    """One fleet member of a DiLoCo-style collaborative run.

    Drive it with :meth:`run` as a sim process.  ``stop()`` models a crash
    (the worker bails at the next await point); a later :meth:`run` on the
    same object rejoins — ``catch_up`` replays the rounds that closed
    while it was gone from the CRDT record + pinned contribution DAGs,
    so the rejoiner lands on the fleet's bit-identical outer state
    instead of forking it.
    """

    def __init__(self, node: LatticaNode, cfg: ModelConfig,
                 state: TrainState, schedule: Callable,
                 data: Iterator[Dict[str, np.ndarray]], fleet: str,
                 collab: Optional[CollabConfig] = None,
                 step_seconds: float = 0.5,
                 eval_batch: Optional[Dict[str, np.ndarray]] = None):
        self.node = node
        self.sim = node.sim
        self.cfg = cfg
        self.fleet = fleet
        self.ccfg = collab or CollabConfig()
        self.name = node.host.name
        self.step_seconds = step_seconds
        self.data = data
        self._state = state
        self.step_fn = make_train_step(cfg, schedule)
        ops = ops_for(cfg)
        self._eval_fn = (_eval_loss(ops, cfg)
                         if eval_batch is not None else None)
        self.eval_batch = eval_batch

        #: replicated outer state (float32 numpy, path-keyed)
        self.outer_flat = tree_to_flat(state.params)
        self.outer_mom = {k: np.zeros_like(v) for k, v in self.outer_flat.items()}
        self.outer_round = 0
        #: error-feedback residual: pseudo-gradient mass not yet shipped
        self.residual = {k: np.zeros_like(v) for k, v in self.outer_flat.items()}

        self.history: List[Dict[str, float]] = []
        self.round_log: List[Dict[str, float]] = []
        self.stats: Dict[str, int] = {
            "rounds_closed": 0, "rounds_degraded": 0, "rounds_aborted": 0,
            "rebases": 0, "catchup_rounds": 0, "contribs_fetched": 0,
            "wire_bytes": 0, "dense_bytes": 0}
        self.alive = True

        #: round -> roots pinned for the rejoin replay window
        self._contrib_pins: Dict[int, List[CID]] = {}
        #: round -> closed set we applied (rebase detection window)
        self._applied: Dict[int, Tuple[str, ...]] = {}
        #: round -> (outer_flat, outer_mom) snapshot before the outer step
        self._pre_round: Dict[int, Tuple[Dict[str, np.ndarray],
                                         Dict[str, np.ndarray]]] = {}

        self._wake = self.sim.event()
        node.watch_crdt(f"train/{fleet}", self._on_change)
        serve_collab(node).workers[fleet] = self
        self.sim.register_leak_check(
            f"collab.overdue_pins:{self.name}", self.overdue_pins)

    # ------------------------------------------------------------- CRDT keys
    def _members_key(self, r: int) -> str:
        return f"train/{self.fleet}/r{r}/members"

    def _contrib_key(self, r: int, worker: str) -> str:
        return f"train/{self.fleet}/r{r}/c/{worker}"

    def _closed_key(self, r: int) -> str:
        return f"train/{self.fleet}/r{r}/closed"

    def _contrib(self, r: int, worker: str) -> Optional[Tuple]:
        val = self.node.store.register(self._contrib_key(r, worker)).value()
        return tuple(val) if val is not None else None

    def _closed(self, r: int) -> Optional[Tuple[str, ...]]:
        val = self.node.store.register(self._closed_key(r)).value()
        return tuple(val) if val is not None else None

    # ----------------------------------------------------------------- views
    def outer_digest(self) -> str:
        return flat_digest(self.outer_flat)

    def outer_params(self) -> Any:
        """Outer params in the model's pytree structure (for eval/ckpt)."""
        return _params_like(self.outer_flat, self._state.params)

    def overdue_pins(self) -> int:
        """Contribution roots still pinned past the replay window — the
        simsan leak gauge (anything here after quiesce is a leaked pin)."""
        horizon = self.outer_round - 1 - self.ccfg.keep_rounds
        return sum(len(v) for r, v in self._contrib_pins.items()
                   if r <= horizon)

    # ------------------------------------------------------------- lifecycle
    def stop(self) -> None:
        """Model a crash/departure: the worker bails at its next await
        point; CRDT state and pinned blocks survive on the node."""
        self.alive = False
        self._wakeup()

    def _on_change(self, key: str, value: Any, origin: str) -> None:
        self._wakeup()

    def _wakeup(self) -> None:
        if not self._wake.triggered:
            self._wake.succeed()

    def run(self, n_rounds: int,
            log: Optional[Callable[[str], None]] = None) -> Generator:
        """Sim process: catch up on rounds closed while away, then drive
        ``n_rounds`` collaborative rounds.  Returns rounds applied."""
        self.alive = True
        applied = yield from self.catch_up()
        for _ in range(n_rounds):
            if not self.alive:
                break
            done = yield from self.run_round(log)
            if done:
                applied += 1
        return applied

    # -------------------------------------------------------- one full round
    def run_round(self, log: Optional[Callable[[str], None]] = None,
                  ) -> Generator:
        r = self.outer_round
        store = self.node.store
        store.orset(self._members_key(r)).add(self.name, self.name)
        yield from self.node.crdt_push_flush()

        # -- inner phase: H local AdamW steps from the replicated outer state
        start_flat = {k: v.copy() for k, v in self.outer_flat.items()}
        self._state = TrainState(
            params=_params_like(start_flat, self._state.params,
                                trainable=True),
            opt=self._state.opt)
        for i in range(self.ccfg.inner_steps):
            if not self.alive:
                return False
            batch = next(self.data)
            self._state, metrics = self.step_fn(self._state, batch)
            rec = {k: float(v) for k, v in metrics.items()}
            rec["round"] = r
            self.history.append(rec)
            yield self.step_seconds
        if not self.alive:
            return False

        # -- compress + publish the pseudo-gradient as a content DAG
        end_flat = tree_to_flat(self._state.params)
        grad = pseudo_gradient(start_flat, end_flat)
        for k in grad:
            grad[k] = grad[k] + self.residual[k]
        parts, sent, cstats = compress_pseudograd(
            grad, frac=self.ccfg.topk_frac, quant=self.ccfg.quant)
        root = yield from self.node.publish_tree_artifact(parts, pin=True)
        self._contrib_pins.setdefault(r, []).append(root)
        self.stats["wire_bytes"] += cstats["wire_bytes"]
        self.stats["dense_bytes"] += cstats["dense_bytes"]
        store.register(self._contrib_key(r, self.name)).set(
            (root.codec, root.digest, cstats["wire_bytes"],
             cstats["dense_bytes"]),
            self.sim.now, self.name)
        yield from self.node.crdt_push_flush()

        # -- wait for the round to close, then apply the averaged outer step
        closed = yield from self._await_close(r)
        if closed is None:
            return False
        if self.name in closed:
            # shipped mass that the fleet applied: residual keeps the rest
            self.residual = {k: grad[k] - sent[k] for k in grad}
        else:
            # our contribution missed the close: defer the WHOLE delta
            self.residual = grad
        yield from self._apply_round(r, closed)
        if self.eval_batch is not None and self._eval_fn is not None:
            loss = float(self._eval_fn(self.outer_params(), self.eval_batch))
            self.round_log.append(
                {"round": r + 1, "eval_loss": loss,
                 "contributors": len(closed),
                 "wire_bytes": cstats["wire_bytes"]})
        if log is not None:
            log(f"[{self.name}] round {r} closed with {len(closed)} "
                f"contributors digest={self.outer_digest()[:12]}")
        return True

    def _await_close(self, r: int) -> Generator:
        """Block until round ``r`` has a converged closed set; write it
        ourselves once quorum + settle allow.  Event-driven via the CRDT
        watch plane, with the round timeout as the hard deadline."""
        sim = self.sim
        deadline = sim.now + self.ccfg.round_timeout
        quorum_at: Optional[float] = None
        while self.alive:
            self._wake = sim.event()    # re-arm BEFORE reading (no lost wake)
            closed = self._closed(r)
            if closed is not None:
                return closed
            members = sorted(self.node.store.orset(
                self._members_key(r)).value())
            contribs = [w for w in members
                        if self._contrib(r, w) is not None]
            need = max(1, math.ceil(self.ccfg.quorum * max(1, len(members))))
            now = sim.now
            if len(contribs) >= need and quorum_at is None:
                quorum_at = now
            settled = (quorum_at is not None
                       and now >= quorum_at + self.ccfg.settle)
            if (settled or now >= deadline) and contribs:
                if len(contribs) < need:
                    self.stats["rounds_degraded"] += 1
                # constant timestamp per round: every concurrent closer's
                # write carries ts=r, so the LWW replica-id tie-break picks
                # one deterministic winner no matter the merge order
                self.node.store.register(self._closed_key(r)).set(
                    tuple(sorted(contribs)), float(r), self.name)
                yield from self.node.crdt_push_flush()
                continue                # next loop iteration returns it
            if now >= deadline:
                self.stats["rounds_aborted"] += 1
                return None
            horizon = deadline
            if quorum_at is not None:
                horizon = min(horizon, quorum_at + self.ccfg.settle)
            yield sim.any_of([self._wake,
                              sim.timeout(max(horizon - now, 0.05))])
        return None

    # -------------------------------------------------------- applying rounds
    def _apply_round(self, r: int, closed: Tuple[str, ...]) -> Generator:
        """Fetch every contribution in ``closed``, average, Nesterov outer
        step.  Identical inputs → bit-identical outer state fleet-wide."""
        yield from self._maybe_rebase(r)
        grads = []
        for w in closed:                # sorted tuple: deterministic order
            flat = yield from self._fetch_contrib(r, w)
            grads.append(flat)
        self._pre_round[r] = (
            {k: v.copy() for k, v in self.outer_flat.items()},
            {k: v.copy() for k, v in self.outer_mom.items()})
        self._outer_step(average_flat(grads))
        self._applied[r] = closed
        self.outer_round = r + 1
        self.stats["rounds_closed"] += 1
        self._gc(r)
        return None

    def _outer_step(self, g: Dict[str, np.ndarray]) -> None:
        lr, mu = self.ccfg.outer_lr, self.ccfg.outer_momentum

        def step(p: np.ndarray, mom: np.ndarray, g: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
            m = mu * mom.astype(np.float64) + g.astype(np.float64)
            upd = g.astype(np.float64) + mu * m if self.ccfg.nesterov else m
            return ((p.astype(np.float64) - lr * upd).astype(np.float32),
                    m.astype(np.float32))
        for k in sorted(g):
            self.outer_flat[k], self.outer_mom[k] = _blockwise(
                step, self.outer_flat[k], self.outer_mom[k], g[k])

    def _fetch_contrib(self, r: int, worker: str) -> Generator:
        """Resolve + swarm-fetch one contribution DAG; decode to a flat
        gradient.  Pins the root for the rejoin replay window."""
        val = self._contrib(r, worker)
        deadline = self.sim.now + self.ccfg.round_timeout
        while val is None:
            # the closed set names a contribution our CRDT replica has not
            # merged yet — the push plane or anti-entropy must deliver it
            if self.sim.now >= deadline:
                raise FetchError(
                    f"round {r}: contribution record of {worker} never "
                    f"reached this replica")
            self._wake = self.sim.event()
            yield self.sim.any_of([self._wake, self.sim.timeout(1.0)])
            val = self._contrib(r, worker)
        root = CID(val[0], val[1])
        hint = self.node.infos_by_host.get(worker)
        if self.node.blockstore.peek(root) is None:
            yield from self.node.fetch_artifact(
                root, hint_providers=[hint] if hint is not None else None,
                assemble=False)
            self.stats["contribs_fetched"] += 1
        if root not in self._contrib_pins.get(r, []):
            self.node.blockstore.pin(root)
            self._contrib_pins.setdefault(r, []).append(root)
        manifest = self.node.blockstore.peek(root)
        if manifest is None or manifest_version(manifest) != 2:
            raise FetchError(f"round {r}: contribution of {worker} is not "
                             f"a v2 tree DAG")
        entries = decode_manifest_v2(manifest)[0]
        return flat_from_entries(
            [(e.name, read_dag(e.cid, self.node.blockstore.get,
                               verify=False), e.meta)
             for e in entries])

    def _maybe_rebase(self, upto: int) -> Generator:
        """Before applying round ``upto``: if any retained round's
        converged closed set differs from what we applied (we raced a
        concurrent closer and lost the LWW tie-break), rewind to the saved
        pre-round outer state and replay the authoritative sets.  This is
        what keeps optimistic application from ever forking outer state."""
        for p in sorted(self._applied):
            cur = self._closed(p)
            if cur is None or cur == self._applied[p]:
                continue
            self.stats["rebases"] += 1
            flat, mom = self._pre_round[p]
            self.outer_flat = {k: v.copy() for k, v in flat.items()}
            self.outer_mom = {k: v.copy() for k, v in mom.items()}
            for q in range(p, upto):
                authoritative = self._closed(q)
                if authoritative is None:
                    break
                grads = []
                for w in authoritative:
                    g = yield from self._fetch_contrib(q, w)
                    grads.append(g)
                self._pre_round[q] = (
                    {k: v.copy() for k, v in self.outer_flat.items()},
                    {k: v.copy() for k, v in self.outer_mom.items()})
                self._outer_step(average_flat(grads))
                self._applied[q] = authoritative
            break
        return None

    def _gc(self, r: int) -> None:
        """Drop rounds past the replay window: unpin their contribution
        DAGs, forget rebase snapshots."""
        horizon = r - self.ccfg.keep_rounds
        for old in [q for q in self._contrib_pins if q <= horizon]:
            for root in self._contrib_pins.pop(old):
                self.node.blockstore.unpin(root)
        for old in [q for q in self._applied if q <= horizon]:
            del self._applied[old]
            self._pre_round.pop(old, None)

    # --------------------------------------------------------------- rejoin
    def catch_up(self) -> Generator:
        """Replay rounds that closed while this worker was away.

        Syncs the CRDT replica with a few known peers first (a restarted
        node's push subscriptions start empty), then applies each closed
        round in sequence from the pinned/pinnable contribution DAGs —
        landing on the fleet's bit-identical outer state instead of
        forking from stale params.  Returns rounds replayed."""
        yield from self._sync_peers()
        replayed = 0
        while self.alive:
            closed = self._closed(self.outer_round)
            if closed is None:
                break
            yield from self._apply_round(self.outer_round, closed)
            self.stats["catchup_rounds"] += 1
            replayed += 1
        return replayed

    def _sync_peers(self, fanout: int = 3) -> Generator:
        peers = sorted(self.node.peers, key=lambda p: p.digest)
        for pid in peers[:fanout]:
            try:
                yield from self.node.sync_crdt_with(self.node.peers[pid])
            except (DialError, RpcError, ValueError):
                continue
        return None

    def peer_status(self, info: Any) -> Generator:
        """Ask a peer's ``CollabService`` where the fleet is (round,
        digest) — the rejoiner's view of how far behind it is."""
        stub = self.node.stub(CollabService, info)
        result = yield from stub.status(self.fleet)
        return result
