"""CID-indexed block storage: verification on put, pinning, LRU eviction.

The port's own copy of the JAX package's ``core/blockstore.py``: the same
code under the port's import paths.

The store is capacity-bounded (``capacity`` bytes, ``None`` = unbounded).
Blocks reachable from a *pinned* root — the walk follows both flat (v1) and
hierarchical (v2) manifests — are never evicted; everything else is fair
game for LRU eviction once ``bytes_stored`` exceeds the budget.  Pins are
reference-counted, so two checkpoint versions that share tensor sub-DAGs
can be pinned and unpinned independently without stranding shared blocks.

Policy hooks used by the layers above: publishers pin what they announce,
fetchers pin the latest version of each artifact lineage they follow
(``LatticaNode.pin_latest``) so older versions age out first.  Hit/miss/
eviction counters feed ``metrics.dashboard()``.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Set

from .cid import CID, dag_reachable


class BlockStore:
    def __init__(self, capacity: Optional[int] = None) -> None:
        #: insertion/touch order = LRU order (oldest first)
        self._blocks: "OrderedDict[CID, bytes]" = OrderedDict()
        self._pins: Dict[CID, int] = {}
        #: per-root record of exactly which CIDs that pin incremented —
        #: unpin releases this set, never a fresh reachability walk (blocks
        #: that arrived after the pin were never counted, so re-walking at
        #: unpin time would decrement refcounts other roots still rely on)
        self._pin_sets: Dict[CID, List[CID]] = {}
        self.capacity = capacity
        self.bytes_stored = 0
        self.stats = {"hits": 0, "misses": 0, "evictions": 0,
                      "bytes_evicted": 0}

    # ------------------------------------------------------------ block ops
    def put(self, cid: CID, data: bytes) -> None:
        if not cid.verify(data):
            raise ValueError(f"data does not match {cid}")
        if cid not in self._blocks:
            self.bytes_stored += len(data)
        self._blocks[cid] = data
        self._blocks.move_to_end(cid)
        # the incoming block is exempt from its own sweep: when everything
        # older is pinned/held, evicting the block we were just asked to
        # store would turn an over-budget put into silent data loss
        self._evict(exclude=cid)

    def put_many(self, blocks: Dict[CID, bytes]) -> None:
        for cid, data in blocks.items():
            self.put(cid, data)

    def get(self, cid: CID) -> Optional[bytes]:
        data = self._blocks.get(cid)
        if data is None:
            self.stats["misses"] += 1
            return None
        self.stats["hits"] += 1
        self._blocks.move_to_end(cid)
        return data

    def peek(self, cid: CID) -> Optional[bytes]:
        """Read without touching LRU order or hit/miss counters."""
        return self._blocks.get(cid)

    def has(self, cid: CID) -> bool:
        return cid in self._blocks

    def delete(self, cid: CID) -> None:
        if self._pins.get(cid):
            raise ValueError(f"cannot delete pinned block {cid}")
        data = self._blocks.pop(cid, None)
        if data is not None:
            self.bytes_stored -= len(data)

    def cids(self) -> List[CID]:
        return list(self._blocks.keys())

    def __len__(self) -> int:
        return len(self._blocks)

    # ------------------------------------------------------------- pinning
    def _reachable(self, root: CID) -> List[CID]:
        return dag_reachable(root, self.peek)

    @property
    def pinned_roots(self) -> Set[CID]:
        return set(self._pin_sets)

    def pin(self, root: CID) -> int:
        """Pin every block reachable from ``root`` (recursive over manifests
        present in the store).  Idempotent per root; returns the number of
        CIDs pinned.  The exact pinned set is recorded so :meth:`unpin`
        releases it symmetrically."""
        if root in self._pin_sets:
            return 0
        reach = self._reachable(root)
        for c in reach:
            self._pins[c] = self._pins.get(c, 0) + 1
        self._pin_sets[root] = reach
        return len(reach)

    def unpin(self, root: CID) -> int:
        """Release a ``pin``; blocks whose refcount drops to zero become
        evictable (lazily, at the next over-budget put).  Releases exactly
        the CID set recorded at pin time — blocks that became reachable from
        ``root`` only after the pin were never refcounted for it, and must
        not lose refcounts another root may hold."""
        reach = self._pin_sets.pop(root, None)
        if reach is None:
            return 0
        for c in reach:
            n = self._pins.get(c, 0) - 1
            if n <= 0:
                self._pins.pop(c, None)
            else:
                self._pins[c] = n
        self._evict()
        return len(reach)

    def pinned(self, cid: CID) -> bool:
        return self._pins.get(cid, 0) > 0

    def hold(self, cid: CID) -> None:
        """Transient single-block pin for in-flight transfers: a fetch
        session holds blocks as they arrive so LRU eviction can't cannibalize
        a version while it is still being assembled.  Pair with
        :meth:`release` (which deliberately does NOT trigger eviction, so a
        caller can promote the session's root to a real pin first)."""
        self._pins[cid] = self._pins.get(cid, 0) + 1

    def release(self, cid: CID) -> None:
        n = self._pins.get(cid, 0) - 1
        if n <= 0:
            self._pins.pop(cid, None)
        else:
            self._pins[cid] = n

    # ------------------------------------------------------- simsan gauges
    def outstanding_holds(self) -> int:
        """Transient transfer holds currently live: total pin refcounts not
        accounted for by a recorded root pin set.  Zero whenever every
        ``hold`` was paired with a ``release`` — the leak-audit invariant."""
        total = sum(self._pins.values())
        rooted = sum(len(s) for s in self._pin_sets.values())
        return total - rooted

    def pinned_root_count(self) -> int:
        return len(self._pin_sets)

    # ------------------------------------------------------------ eviction
    def set_capacity(self, capacity: Optional[int]) -> None:
        self.capacity = capacity
        self._evict()

    def _evict(self, exclude: Optional[CID] = None) -> None:
        if self.capacity is None or self.bytes_stored <= self.capacity:
            return
        # oldest-first sweep; pinned blocks are skipped, never reordered out
        for cid in list(self._blocks.keys()):
            if self.bytes_stored <= self.capacity:
                break
            if self._pins.get(cid, 0) > 0 or cid == exclude:
                continue
            data = self._blocks.pop(cid)
            self.bytes_stored -= len(data)
            self.stats["evictions"] += 1
            self.stats["bytes_evicted"] += len(data)
