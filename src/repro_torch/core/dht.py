"""Kademlia DHT (Maymounkov & Mazieres 2002) over Lattica RPC.

The port's own copy of the JAX package's ``core/dht.py``: the same code
under the port's import paths.

Provides the paper's content-discovery layer: 256-bit XOR key space shared
with CIDs and peer IDs, k-bucket routing tables, iterative (alpha-parallel)
lookups with O(log N) hop complexity, value records and provider records.
Every query is a real unary RPC over a (possibly relayed) connection, so DHT
performance inherits the traversal layer's behaviour.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Generator, List, Optional, Set, Tuple, TYPE_CHECKING

from .peer import Multiaddr, PeerId
from .rpc import RpcContext, RpcError
from .service import (CodecFn, Fixed, PEER_INFO_LIST, Service, pickled,
                      unary)
from .simnet import DialError

if TYPE_CHECKING:  # pragma: no cover
    from .node import LatticaNode

K = 20
ALPHA = 3
PEERINFO_WIRE_SIZE = 96
MAX_LOOKUP_ROUNDS = 24


@dataclass(frozen=True)
class PeerInfo:
    peer_id: PeerId
    host_name: str
    addrs: Tuple[Multiaddr, ...] = ()

    def wire_size(self) -> int:
        return PEERINFO_WIRE_SIZE


class RoutingTable:
    """256 k-buckets indexed by XOR-distance bit length."""

    def __init__(self, self_id: PeerId, k: int = K):
        self.self_id = self_id
        self.k = k
        self.buckets: List[List[PeerInfo]] = [[] for _ in range(256)]
        self._by_id: Dict[PeerId, PeerInfo] = {}

    def _bucket_index(self, peer_id: PeerId) -> int:
        d = self.self_id.xor_distance(peer_id)
        return max(d.bit_length() - 1, 0)

    def update(self, info: PeerInfo) -> None:
        if info.peer_id == self.self_id:
            return
        idx = self._bucket_index(info.peer_id)
        bucket = self.buckets[idx]
        existing = self._by_id.get(info.peer_id)
        if existing is not None:
            try:
                bucket.remove(existing)
            except ValueError:
                pass
            bucket.append(info)          # move to tail = most-recently-seen
            self._by_id[info.peer_id] = info
            return
        if len(bucket) < self.k:
            bucket.append(info)
            self._by_id[info.peer_id] = info
        # full bucket: Kademlia pings the LRU entry; we keep the old entry
        # (stable-peer preference), dropping the newcomer.

    def remove(self, peer_id: PeerId) -> None:
        info = self._by_id.pop(peer_id, None)
        if info is None:
            return
        bucket = self.buckets[self._bucket_index(peer_id)]
        try:
            bucket.remove(info)
        except ValueError:
            pass

    def closest(self, key: bytes, n: int = K) -> List[PeerInfo]:
        everyone = list(self._by_id.values())
        everyone.sort(key=lambda i: i.peer_id.distance_to_key(key))
        return everyone[:n]

    def __len__(self) -> int:
        return len(self._by_id)


#: tagged-union response sizes for the value/provider lookups
_FIND_VALUE_RESP = CodecFn(
    "find_value_resp",
    lambda p: 256 if p[0] == "value"
    else PEERINFO_WIRE_SIZE * max(len(p[1]), 1))
_GET_PROVIDERS_RESP = CodecFn(
    "get_providers_resp",
    lambda p: PEERINFO_WIRE_SIZE * max(len(p[0]) + len(p[1]), 1))


class KadService(Service):
    """The five Kademlia RPCs.  All are idempotent reads/upserts, so stubs
    may retry them freely; eviction-on-failure stays in ``KademliaDHT``."""

    name = "kad"

    def __init__(self, dht: "KademliaDHT"):
        self.dht = dht

    def _observe(self, ctx: RpcContext) -> None:
        info = self.dht.node.infos_by_host.get(ctx.remote_host.name)
        if info is not None:
            self.dht.table.update(info)

    @unary("kad.find_node", request=Fixed(96), response=PEER_INFO_LIST,
           idempotent=True, timeout=15.0)
    def find_node(self, payload: Any, ctx: RpcContext) -> Generator:
        self._observe(ctx)
        closest = self.dht.table.closest(payload, self.dht.k)
        yield ctx.cpu(5e-6)
        return closest

    @unary("kad.find_value", request=Fixed(96), response=_FIND_VALUE_RESP,
           idempotent=True, timeout=15.0)
    def find_value(self, payload: Any, ctx: RpcContext) -> Generator:
        self._observe(ctx)
        key = payload
        yield ctx.cpu(5e-6)
        if key in self.dht.records:
            val, _ = self.dht.records[key]
            return ("value", val)
        return ("peers", self.dht.table.closest(key, self.dht.k))

    @unary("kad.put", request=pickled(floor=96), response=Fixed(64),
           idempotent=True, timeout=15.0)
    def put(self, payload: Any, ctx: RpcContext) -> Generator:
        self._observe(ctx)
        key, value = payload
        self.dht.records[key] = (value, self.dht.node.sim.now)
        yield ctx.cpu(5e-6)
        return True

    @unary("kad.add_provider", request=Fixed(96 + PEERINFO_WIRE_SIZE),
           response=Fixed(64), idempotent=True, timeout=15.0)
    def add_provider(self, payload: Any, ctx: RpcContext) -> Generator:
        self._observe(ctx)
        key, info = payload
        self.dht.providers.setdefault(key, {})[info.peer_id] = (
            info, self.dht.node.sim.now)
        yield ctx.cpu(5e-6)
        return True

    @unary("kad.drop_provider", request=Fixed(96 + PEERINFO_WIRE_SIZE),
           response=Fixed(64), idempotent=True, timeout=15.0)
    def drop_provider(self, payload: Any, ctx: RpcContext) -> Generator:
        """Withdraw one provider record — the planned-retirement inverse of
        ``add_provider`` (same trust model: records are advisory hints the
        fetch path verifies by actually fetching, so a lying peer can only
        re-create the staleness TTLs already tolerate)."""
        self._observe(ctx)
        key, peer_id = payload
        entry = self.dht.providers.get(key)
        if entry is not None:
            entry.pop(peer_id, None)
            if not entry:
                del self.dht.providers[key]
        yield ctx.cpu(5e-6)
        return True

    @unary("kad.get_providers", request=Fixed(96),
           response=_GET_PROVIDERS_RESP, idempotent=True, timeout=15.0)
    def get_providers(self, payload: Any, ctx: RpcContext) -> Generator:
        self._observe(ctx)
        key = payload
        provs = [i for i, _ in self.dht.providers.get(key, {}).values()]
        closest = self.dht.table.closest(key, self.dht.k)
        yield ctx.cpu(5e-6)
        return provs, closest


class KademliaDHT:
    def __init__(self, node: "LatticaNode", k: int = K, alpha: int = ALPHA):
        self.node = node
        self.k = k
        self.alpha = alpha
        self.table = RoutingTable(node.peer_id, k)
        self.records: Dict[bytes, Tuple[Any, float]] = {}        # key -> (val, ts)
        self.providers: Dict[bytes, Dict[PeerId, Tuple[PeerInfo, float]]] = {}
        self.stats = {"lookups": 0, "rounds": 0, "queries": 0}
        node.serve(KadService(self))

    # ------------------------------------------------------------- queries
    def _query(self, info: PeerInfo, method: str, payload: Any) -> Generator:
        """Single RPC to one peer (``method`` is a KadService attr name);
        returns None on failure (peer evicted)."""
        self.stats["queries"] += 1
        try:
            stub = self.node.stub(KadService, info)
            resp = yield from getattr(stub, method)(payload)
            self.table.update(info)
            return resp
        except (DialError, RpcError):
            self.table.remove(info.peer_id)
            return None

    def _lookup(self, key: bytes, method: str, payload: Any,
                stop_on_value: bool = False) -> Generator:
        """Iterative alpha-parallel lookup.

        Returns (value_or_None, closest_infos, providers, rounds).
        """
        self.stats["lookups"] += 1
        sim = self.node.sim
        shortlist: Dict[PeerId, PeerInfo] = {
            i.peer_id: i for i in self.table.closest(key, self.k)}
        queried: Set[PeerId] = set()
        found_value: Optional[Any] = None
        found_providers: List[PeerInfo] = []
        rounds = 0

        def dist(pid: PeerId) -> int:
            return pid.distance_to_key(key)

        best_seen = min((dist(p) for p in shortlist), default=None)
        while rounds < MAX_LOOKUP_ROUNDS:
            candidates = sorted(
                (p for p in shortlist if p not in queried), key=dist)[: self.alpha]
            if not candidates:
                break
            rounds += 1
            self.stats["rounds"] += 1
            procs = [sim.process(self._query(shortlist[p], method, payload))
                     for p in candidates]
            queried.update(candidates)
            results = yield sim.all_of(procs)
            improved = False
            for resp in results:
                if resp is None:
                    continue
                if method == "find_value" and resp[0] == "value":
                    found_value = resp[1]
                    if stop_on_value:
                        return found_value, self._top(shortlist, key), found_providers, rounds
                    continue
                if method == "get_providers":
                    provs, closer = resp
                    for pi in provs:
                        if pi.peer_id not in {x.peer_id for x in found_providers}:
                            found_providers.append(pi)
                            self.node.remember(pi)
                else:
                    closer = resp if method == "find_node" else resp[1]
                for info in closer:
                    if info.peer_id == self.node.peer_id:
                        continue
                    self.node.remember(info)
                    if info.peer_id not in shortlist:
                        shortlist[info.peer_id] = info
                        d = dist(info.peer_id)
                        if best_seen is None or d < best_seen:
                            best_seen = d
                            improved = True
            if found_providers and method == "get_providers" and stop_on_value:
                break
            if not improved:
                # converged: stop once the k closest have all been queried
                top = sorted(shortlist, key=dist)[: self.k]
                if all(p in queried for p in top):
                    break
        return found_value, self._top(shortlist, key), found_providers, rounds

    def _top(self, shortlist: Dict[PeerId, PeerInfo], key: bytes) -> List[PeerInfo]:
        return [shortlist[p] for p in
                sorted(shortlist, key=lambda q: q.distance_to_key(key))[: self.k]]

    # ------------------------------------------------------------- public API
    def bootstrap_lookup(self) -> Generator:
        """Self-lookup to populate the routing table."""
        yield from self._lookup(self.node.peer_id.digest, "find_node",
                                self.node.peer_id.digest)

    def find_node(self, key: bytes) -> Generator:
        _, closest, _, _ = yield from self._lookup(key, "find_node", key)
        return closest

    def put(self, key: bytes, value: Any) -> Generator:
        """Store a record on the k closest peers."""
        _, closest, _, _ = yield from self._lookup(key, "find_node", key)
        sim = self.node.sim
        procs = [sim.process(self._query(i, "put", (key, value)))
                 for i in closest[: self.k]]
        self.records[key] = (value, sim.now)
        if procs:
            yield sim.all_of(procs)
        return len(procs)

    def get(self, key: bytes) -> Generator:
        if key in self.records:
            return self.records[key][0]
        value, _, _, _ = yield from self._lookup(
            key, "find_value", key, stop_on_value=True)
        return value

    def provide(self, key: bytes) -> Generator:
        """Announce this node as a provider for ``key`` (a CID digest)."""
        me = self.node.info()
        self.providers.setdefault(key, {})[me.peer_id] = (me, self.node.sim.now)
        _, closest, _, _ = yield from self._lookup(key, "find_node", key)
        sim = self.node.sim
        procs = [sim.process(self._query(i, "add_provider", (key, me)))
                 for i in closest[: self.k]]
        if procs:
            yield sim.all_of(procs)
        return len(procs)

    def unprovide(self, key: bytes) -> Generator:
        """Withdraw this node's provider record for ``key`` — locally and
        at the closest nodes :meth:`provide` targeted.  Used by planned
        retirement (a replica scaling back down); crashes still rely on
        record staleness, as ever."""
        me = self.node.info()
        entry = self.providers.get(key)
        if entry is not None:
            entry.pop(me.peer_id, None)
            if not entry:
                self.providers.pop(key, None)
        _, closest, _, _ = yield from self._lookup(key, "find_node", key)
        sim = self.node.sim
        procs = [sim.process(self._query(i, "drop_provider",
                                         (key, me.peer_id)))
                 for i in closest[: self.k]]
        if procs:
            yield sim.all_of(procs)
        return len(procs)

    def find_providers(self, key: bytes, first_only: bool = False) -> Generator:
        local = [i for i, _ in self.providers.get(key, {}).values()]
        if local and first_only:
            return local
        _, _, provs, _ = yield from self._lookup(
            key, "get_providers", key, stop_on_value=first_only)
        merged = {p.peer_id: p for p in local + provs}
        return list(merged.values())
