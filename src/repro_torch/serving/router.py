"""Load-aware replica routing for the serving plane.

The port's own copy of the JAX package's ``serving/router.py``: the same
code under the port's import paths.

Replaces first-successful-dial provider choice in :class:`ShardClient`:
every (shard, provider) pair keeps an EWMA of observed call latency, an
EWMA error rate, and a live in-flight depth, and the router orders
candidate replicas by a combined score (DIT's ``ExpertStats`` load-aware
router is the exemplar design).  A small epsilon-greedy exploration share
keeps stats fresh on replicas that would otherwise never be probed again
after one bad sample.

Also provides :func:`hedged_call` — a tail-latency hedge for *idempotent*
calls: the primary attempt races a hedge timer, and when the timer fires
first a backup attempt is launched on the next-best provider; the first
success wins.  Stateful decode steps must not be hedged (a duplicate
attempt would advance a second KV cache), so the serving driver only
hedges stateless ops and handles decode failures by session migration.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Generator, Hashable, List, Optional, Tuple

from ..core.simnet import Sim

__all__ = ["ProviderStats", "LoadAwareRouter", "hedged_call"]


class ProviderStats:
    """EWMA latency / error rate + in-flight depth for one provider."""

    __slots__ = ("latency", "error_rate", "inflight", "samples", "last_seen")

    def __init__(self) -> None:
        self.latency: Optional[float] = None   # EWMA seconds, None = no data
        self.error_rate = 0.0                  # EWMA of {0, 1} outcomes
        self.inflight = 0                      # calls currently outstanding
        self.samples = 0
        self.last_seen = 0.0

    def observe(self, latency: float, ok: bool, alpha: float, now: float) -> None:
        self.samples += 1
        self.last_seen = now
        if ok:
            self.latency = (latency if self.latency is None
                            else (1 - alpha) * self.latency + alpha * latency)
        # errors decay the same way successes do, so a recovered replica
        # earns its way back instead of being poisoned forever
        self.error_rate = (1 - alpha) * self.error_rate + alpha * (0.0 if ok else 1.0)


class LoadAwareRouter:
    """Scores (key, provider) pairs; lower score = better replica.

    ``score = ewma_latency * (1 + inflight) * (1 + error_weight * err)`` —
    queueing-theory shaped: expected completion grows with the work already
    queued on the replica, and recent failures multiply the penalty.
    Providers with no samples yet score as ``cold_latency`` so fresh
    replicas (e.g. pressure-spawned ones) are tried early but do not
    preempt a provider with a proven fast path.
    """

    def __init__(self, sim: Sim, alpha: float = 0.3, error_weight: float = 8.0,
                 explore: float = 0.05, cold_latency: float = 20e-3):
        self.sim = sim
        self.alpha = alpha
        self.error_weight = error_weight
        self.explore = explore
        self.cold_latency = cold_latency
        self._stats: Dict[Tuple[Hashable, Hashable], ProviderStats] = {}
        self.stats = {"picks": 0, "explored": 0, "observed": 0, "errors": 0}

    def _entry(self, key: Hashable, provider: Hashable) -> ProviderStats:
        entry = self._stats.get((key, provider))
        if entry is None:
            entry = self._stats[(key, provider)] = ProviderStats()
        return entry

    # -- accounting ---------------------------------------------------------
    def begin(self, key: Hashable, provider: Hashable) -> None:
        self._entry(key, provider).inflight += 1

    def end(self, key: Hashable, provider: Hashable) -> None:
        entry = self._entry(key, provider)
        entry.inflight = max(0, entry.inflight - 1)

    def observe(self, key: Hashable, provider: Hashable, latency: float,
                ok: bool) -> None:
        self.stats["observed"] += 1
        if not ok:
            self.stats["errors"] += 1
        self._entry(key, provider).observe(latency, ok, self.alpha,
                                           self.sim.now)

    def score(self, key: Hashable, provider: Hashable) -> float:
        entry = self._stats.get((key, provider))
        if entry is None or entry.latency is None:
            lat, err, infl = self.cold_latency, (entry.error_rate if entry
                                                 else 0.0), (entry.inflight
                                                             if entry else 0)
        else:
            lat, err, infl = entry.latency, entry.error_rate, entry.inflight
        return lat * (1.0 + infl) * (1.0 + self.error_weight * err)

    # -- choice -------------------------------------------------------------
    def rank(self, key: Hashable, providers: List[Any],
             provider_id: Callable[[Any], Hashable] = lambda p: p) -> List[Any]:
        """Candidates ordered best-first (the hedging/failover order).
        With probability ``explore`` the top two are swapped so second-best
        replicas keep producing fresh samples."""
        self.stats["picks"] += 1
        ordered = sorted(providers,
                         key=lambda p: self.score(key, provider_id(p)))
        if (len(ordered) > 1 and self.explore > 0
                and self.sim.rng.random() < self.explore):
            self.stats["explored"] += 1
            ordered[0], ordered[1] = ordered[1], ordered[0]
        return ordered

    def pick(self, key: Hashable, providers: List[Any],
             provider_id: Callable[[Any], Hashable] = lambda p: p) -> Any:
        return self.rank(key, providers, provider_id)[0]


def hedged_call(sim: Sim, attempts: List[Callable[[], Generator]],
                hedge_after: float, stats: Optional[Dict[str, int]] = None,
                ) -> Generator:
    """Run ``attempts[0]``; if it has not finished after ``hedge_after``
    seconds, launch the next attempt in parallel (and so on), returning the
    first success.  Raises the last failure only once every launched
    attempt has failed.  Only safe for idempotent work."""
    procs = []
    next_attempt = 0
    last_exc: Optional[BaseException] = None

    def launch() -> None:
        nonlocal next_attempt
        procs.append(sim.process(attempts[next_attempt]()))
        next_attempt += 1

    launch()
    while True:
        waits: List[Any] = list(procs)
        timer = None
        if next_attempt < len(attempts):
            timer = sim.timeout(hedge_after)
            waits.append(timer)
        try:
            idx, value = yield sim.any_of(waits)
        except BaseException as exc:  # noqa: BLE001 — one attempt failed
            last_exc = exc
            # drop finished-failed procs; keep the rest racing
            procs[:] = [p for p in procs if not p.triggered]
            if procs:
                continue
            if next_attempt < len(attempts):
                launch()
                continue
            raise
        if timer is not None and idx == len(waits) - 1:
            if stats is not None:
                stats["hedged"] = stats.get("hedged", 0) + 1
            launch()
            continue
        return value
