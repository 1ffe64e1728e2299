"""LatticaNode: the composed stack — what the paper's SDK exposes.

The port's own copy of the JAX package's ``core/node.py``: the same code
under the port's import paths.

identity + transport (dial/AutoNAT/relay/DCUtR) + RPC router + Kademlia DHT
+ pub/sub + CRDT replicated store + content-addressed blockstore + Bitswap.

``connect_info`` implements the paper's connection policy:
  1. reuse an existing connection;
  2. try direct dial on advertised direct addrs;
  3. fall back to a circuit relay;
  4. attempt a DCUtR hole-punch upgrade, keeping the circuit if it fails.
"""

from __future__ import annotations

from typing import Any, Dict, Generator, List, Optional, Tuple, TYPE_CHECKING

from .bitswap import Bitswap
from .blockstore import BlockStore
from .cid import CID, ChunkSpec, build_dag, build_tree_dag
from .crdt import (MST_LEAF_SIZE, ReplicatedStore, decode_delta2_request,
                   decode_delta2_response, decode_delta_request,
                   decode_mst_request, decode_mst_response, decode_summary,
                   decode_vv_map, encode_delta2_request,
                   encode_delta2_response, encode_delta_request,
                   encode_mst_request, encode_mst_response, encode_summary,
                   encode_vv_map, mst_wire_hash)
from .dht import KademliaDHT, PeerInfo
from .peer import Multiaddr, PeerId
from .pubsub import PubSub
from .rendezvous import RendezvousServer
from .rpc import RpcContext, RpcError, RpcRouter
from .service import (ByteLength, ClientInterceptor, Fixed, PEER_INFO,
                      RpcMetrics, RpcStatus, Service, ServerInterceptor,
                      ServiceError, Stub, serve_service, unary)
from .simnet import Connection, DialError, Host, Network, Sim
from .traversal import MAIN_PORT, Transport

#: How many relays a private node tries to hold reservations on (primary +
#: failover), ranked by measured RTT.
RELAY_TARGET = 2

#: A failed DCUtR upgrade is retried on the next connect after this long —
#: NAT state and address books evolve, so "relayed once" must not mean
#: "relayed forever" (libp2p retries hole punching the same way).
UPGRADE_RETRY_COOLDOWN = 30.0


class IdentityService(Service):
    """Push-pull identity exchange: each side learns the other's PeerInfo."""

    name = "id"

    def __init__(self, node: "LatticaNode"):
        self.node = node

    @unary("id.exchange", request=PEER_INFO, response=PEER_INFO,
           idempotent=True, timeout=10.0)
    def exchange(self, payload: Any, ctx: RpcContext) -> Generator:
        self.node.remember(payload)
        yield ctx.cpu(2e-6)
        return self.node.info()


class CrdtSyncService(Service):
    """v1 anti-entropy pair: digest probe, then full state exchange+merge.
    Both methods are idempotent — CRDT merge is, by definition.  Kept as
    the complete v1 surface so legacy peers are still served."""

    name = "crdt"

    def __init__(self, node: "LatticaNode"):
        self.node = node

    @unary("crdt.digest", request=Fixed(96), response=Fixed(96),
           idempotent=True, timeout=15.0)
    def digest(self, payload: Any, ctx: RpcContext) -> Generator:
        yield ctx.cpu(10e-6)
        return self.node.store.digest()

    @unary("crdt.exchange", request=ByteLength(), response=ByteLength(),
           idempotent=True, timeout=60.0)
    def exchange(self, payload: Any, ctx: RpcContext) -> Generator:
        incoming = ReplicatedStore.deserialize(payload)
        yield ctx.cpu(30e-6)
        self.node.store.merge(incoming)
        return self.node.store.serialize()


class CrdtSyncV2Service(CrdtSyncService):
    """v2 anti-entropy: summary exchange, then per-key delta transfer.

    ``summary`` takes the caller's per-key digest map and answers with our
    version vectors for exactly the keys that differ (or that one side is
    missing); ``delta`` then moves minimal per-key fragments both ways in a
    single RPC — the caller's fragments ride in the request, ours in the
    response.  Bytes moved are O(changed-state); the v1 methods remain
    served for peers that never learned the v2 surface."""

    @unary("crdt.summary", request=ByteLength(), response=ByteLength(),
           idempotent=True, timeout=30.0)
    def summary(self, payload: Any, ctx: RpcContext) -> Generator:
        theirs = decode_summary(payload)
        yield ctx.cpu(20e-6)
        store = self.node.store
        # latlint: disable=L007 serves the flat-v2 wire surface for old peers
        mine = store.key_digests()
        diff: Dict[str, Any] = {}
        for key, dg in theirs.items():
            if mine.get(key) != dg:
                diff[key] = store.entry_vv(key)
        for key in mine:
            if key not in theirs:
                diff[key] = store.entry_vv(key)
        return encode_vv_map(diff)

    @unary("crdt.delta", request=ByteLength(), response=ByteLength(),
           idempotent=True, timeout=60.0)
    def delta(self, payload: Any, ctx: RpcContext) -> Generator:
        vv_map, their_deltas = decode_delta_request(payload)
        yield ctx.cpu(30e-6)
        store = self.node.store
        if their_deltas and store.apply_delta(their_deltas):
            self.node._schedule_crdt_push()     # rumor-monger fresh state
        mine = store.delta_since(vv_map, keys=vv_map.keys())
        return ReplicatedStore.encode_delta(mine)


class CrdtSyncMstService(CrdtSyncV2Service):
    """Merkle-summarized anti-entropy: the caller walks our namespace-
    sharded summary forest (``crdt.mst``) to localize differing keys in
    O(log n) tree nodes, then runs the existing ``crdt.delta`` round on
    just those keys.  The flat v2 ``crdt.summary`` and the v1 full-state
    surface stay served, so mixed fleets negotiate downward per peer."""

    @unary("crdt.mst", request=ByteLength(), response=ByteLength(),
           idempotent=True, timeout=30.0)
    def mst(self, payload: Any, ctx: RpcContext) -> Generator:
        want_roots, queries = decode_mst_request(payload)
        yield ctx.cpu(15e-6)
        store = self.node.store
        forest = store.summary_forest()
        nodes: List[Dict[str, Any]] = []
        for ns, path in queries:
            tree = forest.get(ns)
            if tree is None or not tree.keys_under(path):
                nodes.append({"ns": ns, "p": path, "t": "x"})
            elif tree.is_leaf(path):
                kd = {k: [dg, store.entry_vv(k)]
                      for k, dg in tree.leaf_digests(path).items()}
                nodes.append({"ns": ns, "p": path, "t": "l", "kd": kd})
            else:
                nodes.append({"ns": ns, "p": path, "t": "i",
                              "c": tree.children(path)})
        roots = store.summary_roots() if want_roots else None
        return encode_mst_response(nodes, roots)

    @unary("crdt.delta2", request=ByteLength(), response=ByteLength(),
           idempotent=True, timeout=60.0)
    def delta2(self, payload: Any, ctx: RpcContext) -> Generator:
        """The MST walk's delta round.  Beyond ``crdt.delta`` it (a) ships
        full state for our keys under the caller's reconcile-bucket paths
        that its vv map does not name (the caller never fetched our per-key
        digests for those buckets), and (b) returns a ``want`` vv map for
        the keys where the caller's vv shows state we lack, so it can
        answer with one push-only ``crdt.delta``."""
        vv_map, their_deltas, buckets = decode_delta2_request(payload)
        yield ctx.cpu(30e-6)
        store = self.node.store
        if their_deltas and store.apply_delta(their_deltas):
            self.node._schedule_crdt_push()     # rumor-monger fresh state
        mine = store.delta_since(vv_map, keys=vv_map.keys())
        forest = store.summary_forest()
        for ns, path in buckets:
            tree = forest.get(ns)
            if tree is None:
                continue
            extra = [k for k in tree.keys_under(path) if k not in vv_map]
            if extra:
                mine.update(store.delta_since({}, keys=extra))
        want: Dict[str, Any] = {}
        for k, vv in vv_map.items():
            if vv and store.entry_vv(k) != vv:
                want[k] = store.entry_vv(k)
        return encode_delta2_response(mine, want)


def crdt_ns(key: str) -> str:
    """Namespace of a store key: its first path segment (``ckpt/f`` →
    ``ckpt``).  Delta pushes are published per-namespace on
    ``crdt/<ns>`` pubsub topics."""
    return key.split("/", 1)[0]


class LatticaNode:
    def __init__(self, net: Network, name: str, region: str = "us",
                 zone: str = "a", nat: Optional[Any] = None, cores: int = 4,
                 serve_rendezvous: bool = False,
                 machine: Optional[str] = None,
                 store_budget: Optional[int] = None,
                 crdt_proto: str = "mst",
                 crdt_push: bool = True,
                 crdt_push_window: float = 0.0):
        self.net = net
        self.sim: Sim = net.sim
        self.host: Host = net.host(name, region=region, zone=zone, nat=nat,
                                   cores=cores, machine=machine)
        self.peer_id = PeerId.from_name(name)
        self.transport = Transport(self.host, self.peer_id)
        self.router = RpcRouter(self.host)
        self.rpc_metrics = RpcMetrics()
        self._stub_cache: Dict[Any, Stub] = {}
        self.blockstore = BlockStore(capacity=store_budget)
        self.sim.register_leak_check(
            f"blockstore.holds:{name}", self.blockstore.outstanding_holds)
        self.sim.register_leak_check(
            f"blockstore.pins:{name}", self.blockstore.pinned_root_count)
        self._pinned_latest: Dict[str, CID] = {}
        self.store = ReplicatedStore(replica=name)
        self.peers: Dict[PeerId, PeerInfo] = {}
        self.infos_by_host: Dict[str, PeerInfo] = {}
        if crdt_proto not in ("v1", "v2", "mst"):
            raise ValueError(f"unknown crdt_proto {crdt_proto!r}")
        #: "mst" (default) localizes differing keys via the Merkle summary
        #: forest walk; "v2" uses the flat per-key digest summary; "v1"
        #: forces the legacy digest→full-swap protocol and serves only the
        #: v1 wire surface.  Each tier negotiates downward per peer
        #: (mst→v2→v1), so mixed-version fleets still converge.
        self.crdt_proto = crdt_proto
        #: eager convergence: local mutations publish deltas on crdt/<ns>
        #: pubsub topics so connected subscribers converge in one gossip
        #: round instead of waiting for an anti-entropy tick
        self.crdt_push = crdt_push and crdt_proto in ("v2", "mst")
        #: how long a scheduled push waits to coalesce further writes; 0.0
        #: batches only the same event instant (one-tick debounce), while a
        #: positive window lets high-churn namespaces ship one delta doc
        #: per window instead of per instant
        self.crdt_push_window = float(crdt_push_window)
        self.crdt_stats = {"rounds": 0, "delta_exchanges": 0,
                           "full_exchanges": 0, "tx_bytes": 0, "rx_bytes": 0,
                           "push_published": 0, "push_bytes": 0,
                           "push_applied": 0, "push_rejected": 0,
                           "summary_skipped": 0, "summary_bytes": 0,
                           "mst_exchanges": 0, "mst_probe_bytes": 0}
        self._crdt_peer_proto: Dict[PeerId, str] = {}
        #: per peer (our digest, our vv) snapshotted when both sides last
        #: held identical state — lets steady-state rounds skip the
        #: crdt.summary exchange entirely (see sync_crdt_with)
        self._crdt_sync_cache: Dict[PeerId, Tuple[bytes, Dict[str, Any]]] = {}
        self._push_vv: Dict[str, Any] = {}       # store.vv() at last push
        self._push_pending = False
        self._crdt_topics: set = set()
        self.identity = self.serve(IdentityService(self))
        self.crdt_sync = self.serve(
            CrdtSyncMstService(self) if crdt_proto == "mst"
            else CrdtSyncV2Service(self) if crdt_proto == "v2"
            else CrdtSyncService(self))
        if self.crdt_push:
            self.store.on_local_change(self._on_crdt_mutation)
        self.dht = KademliaDHT(self)
        self.pubsub = PubSub(self)
        self.bitswap = Bitswap(self)
        self.relay_infos: List[PeerInfo] = []          # primary first (by RTT)
        self._relay_meta: Dict[bytes, Dict[str, float]] = {}
        self._relay_candidates: List[PeerInfo] = []
        self.rendezvous: Optional[RendezvousServer] = (
            RendezvousServer(self) if serve_rendezvous else None)
        self._upgrade_attempted: Dict[PeerId, float] = {}  # peer -> last try

    # ----------------------------------------------------------- service API
    def serve(self, service: Service,
              interceptors: List[ServerInterceptor] = ()) -> Service:
        """Register every declared RPC method of ``service`` on this node."""
        return serve_service(self.router, service, interceptors=interceptors,
                             metrics=self.rpc_metrics)

    def stub(self, service_cls: type, target: Optional[PeerInfo] = None, *,
             conn: Optional[Connection] = None, scope: Optional[str] = None,
             interceptors: List[ClientInterceptor] = ()) -> Stub:
        """Typed client stub for ``service_cls`` at ``target`` (or over an
        explicit ``conn``).  Connections are acquired lazily per call via
        ``connect_info`` and reused.  Peer-targeted stubs without custom
        interceptors are cached — hot paths (DHT lookups, gossip fan-out)
        request one per RPC."""
        if conn is None and not interceptors and target is not None:
            key = (service_cls, target.peer_id, scope)
            cached = self._stub_cache.get(key)
            if cached is not None:
                cached._target = target      # refresh the PeerInfo snapshot
                return cached
            made = Stub(self, service_cls, target, scope=scope)
            self._stub_cache[key] = made
            return made
        return Stub(self, service_cls, target, conn=conn, scope=scope,
                    interceptors=interceptors)

    # ------------------------------------------------------------- identity
    @property
    def relay_info(self) -> Optional[PeerInfo]:
        """Primary (lowest-RTT) relay this node holds a reservation on."""
        return self.relay_infos[0] if self.relay_infos else None

    def info(self) -> PeerInfo:
        addrs: List[Multiaddr] = []
        if self.host.nat is None:
            addrs.append(Multiaddr(self.host.ip, MAIN_PORT))
        elif self.transport.reachability == "public":
            # e.g. full-cone NAT: our observed mapping is stranger-dialable
            for ip, port in sorted(self.transport.observed_addrs):
                addrs.append(Multiaddr(ip, port))
        for relay_info in self.relay_infos:     # primary first, then failover
            relay_ip = relay_info.addrs[0].ip
            addrs.append(Multiaddr(relay_ip, MAIN_PORT,
                                   relay_peer=relay_info.peer_id))
        return PeerInfo(self.peer_id, self.host.name, tuple(addrs))

    def remember(self, info: PeerInfo) -> None:
        if info.peer_id == self.peer_id:
            return
        old = self.peers.get(info.peer_id)
        if old is not None and not info.addrs:
            return  # don't clobber a dialable record with an empty one
        self.peers[info.peer_id] = info
        self.infos_by_host[info.host_name] = info
        self.dht.table.update(info)

    # ------------------------------------------------------------ connecting
    def connect_info(self, info: PeerInfo) -> Generator:
        """Connect to a peer, NAT-traversing as needed; returns Connection."""
        target_host = self.net.hosts.get(info.host_name)
        if target_host is not None:
            existing = self.host.connection_to(target_host)
            if existing is not None:
                if existing.relayed:
                    # a circuit is a fallback, not a fate: periodically
                    # retry the DCUtR upgrade (cooldown-limited)
                    upgraded = yield from self._maybe_upgrade(existing, info)
                    if upgraded is not None:
                        return upgraded
                return existing
        self.remember(info)
        direct = [a for a in info.addrs if not a.is_relay]
        relayed = [a for a in info.addrs if a.is_relay]
        last_err: Optional[Exception] = None
        for addr in direct:
            try:
                conn = yield from self.transport.dial_direct((addr.ip, addr.port))
                yield from self._identify(conn)
                return conn
            except DialError as e:
                last_err = e
        for addr in relayed:
            try:
                relay_host_conn = yield from self._conn_to_relay(addr)
                circuit = yield from self.transport.relay_connect(
                    relay_host_conn, info.peer_id)
                yield from self._identify(circuit)
                upgraded = yield from self._maybe_upgrade(circuit, info)
                return upgraded or circuit
            except DialError as e:
                last_err = e
        raise DialError(f"cannot connect to {info.peer_id}: {last_err}")

    def _conn_to_relay(self, addr: Multiaddr) -> Generator:
        relay_host = self.net._by_ip.get(addr.ip)
        if relay_host is not None:
            existing = self.host.connection_to(relay_host)
            if existing is not None and not existing.relayed:
                return existing
        conn = yield from self.transport.dial_direct((addr.ip, addr.port))
        return conn

    def _maybe_upgrade(self, circuit: Connection,
                       info: PeerInfo) -> Generator:
        """One DCUtR attempt per peer per cooldown window; returns a direct
        Connection or None (keep the circuit)."""
        last = self._upgrade_attempted.get(info.peer_id)
        if last is not None and self.sim.now - last < UPGRADE_RETRY_COOLDOWN:
            return None
        self._upgrade_attempted[info.peer_id] = self.sim.now
        direct = yield from self.transport.dcutr_upgrade(circuit)
        if direct is not None:
            circuit.close()
            return direct
        return None

    def _identify(self, conn: Connection) -> Generator:
        try:
            stub = self.stub(IdentityService, conn=conn)
            their = yield from stub.exchange(self.info())
            self.remember(their)
        except (RpcError, DialError):
            pass
        return None

    def connect_peer(self, peer_id: PeerId) -> Generator:
        info = self.peers.get(peer_id)
        if info is None:
            # resolve through the DHT
            closest = yield from self.dht.find_node(peer_id.digest)
            info = self.peers.get(peer_id)
            if info is None:
                for c in closest:
                    if c.peer_id == peer_id:
                        info = c
                        break
        if info is None:
            raise DialError(f"unknown peer {peer_id}")
        conn = yield from self.connect_info(info)
        return conn

    # ------------------------------------------------------------- bootstrap
    def bootstrap(self, bootstrap_infos: List[PeerInfo],
                  relay: Optional[PeerInfo] = None) -> Generator:
        """Join the mesh: dial bootstrappers, learn reachability, reserve a
        relay if private, then populate the DHT routing table."""
        conns = []
        probed = False
        for info in bootstrap_infos:
            try:
                conn = yield from self.connect_info(info)
                conns.append(conn)
            except DialError:
                continue
            if not probed:
                # AutoNAT immediately after the FIRST contact: the dial-back
                # is forwarded to a public peer we have never contacted, so
                # cone-NAT filters can't be satisfied by our own traffic.
                yield from self.transport.autonat_probe(conn)
                probed = True
        if not conns:
            raise DialError("all bootstrap nodes unreachable")
        self._relay_candidates = list(bootstrap_infos)
        if relay is not None and all(c.peer_id != relay.peer_id
                                     for c in self._relay_candidates):
            self._relay_candidates.append(relay)
        if self.transport.reachability != "public":
            candidates = [relay] if relay is not None else bootstrap_infos
            got = yield from self.acquire_relays(candidates)
            if not got and relay is not None:
                yield from self.acquire_relays(bootstrap_infos)
        yield from self.dht.bootstrap_lookup()
        for pid in list(self.peers):
            yield from self.pubsub.announce_subscriptions(pid)
        return self.transport.reachability

    # ---------------------------------------------------------------- relays
    def acquire_relays(self, candidates: List[PeerInfo],
                       want: int = RELAY_TARGET) -> Generator:
        """Score candidate relays by RTT and hold reservations on the best
        ``want`` of them (primary + failover).  Returns reservations held."""
        held = {i.peer_id for i in self.relay_infos}
        scored = []
        for info in candidates:
            if info.peer_id == self.peer_id or info.peer_id in held:
                continue
            try:
                conn = yield from self.connect_info(info)
                if conn.relayed:
                    continue        # a relay must be directly reachable
                rtt = yield from self.transport.ping(conn)
            except (DialError, RpcError):
                continue
            scored.append((rtt, info, conn))
        scored.sort(key=lambda s: s[0])
        for rtt, info, conn in scored:
            if len(self.relay_infos) >= want:
                break
            try:
                ok, ttl = yield from self.transport.relay_reserve(conn)
            except DialError:
                continue
            if ok:
                self._note_relay(info, ttl, rtt)
        return len(self.relay_infos)

    def reserve_relay(self, relay_info: PeerInfo) -> Generator:
        """Reserve (or refresh) a slot on one specific relay."""
        conn = yield from self.connect_info(relay_info)
        ok, ttl = yield from self.transport.relay_reserve(conn)
        if ok:
            self._note_relay(relay_info, ttl)
        return ok

    def _note_relay(self, info: PeerInfo, ttl: float,
                    rtt: Optional[float] = None) -> None:
        digest = info.peer_id.digest
        if all(i.peer_id != info.peer_id for i in self.relay_infos):
            self.relay_infos.append(info)
        meta = self._relay_meta.setdefault(digest, {})
        meta["expires_at"] = self.sim.now + ttl
        if rtt is not None:
            meta["rtt"] = rtt
        self.relay_infos.sort(
            key=lambda i: self._relay_meta.get(i.peer_id.digest, {})
                              .get("rtt", float("inf")))

    def _drop_relay(self, info: PeerInfo) -> None:
        self.relay_infos = [i for i in self.relay_infos
                            if i.peer_id != info.peer_id]
        self._relay_meta.pop(info.peer_id.digest, None)

    # ------------------------------------------------------------------ CRDT
    def sync_crdt_with(self, info: PeerInfo) -> Generator:
        """One anti-entropy round with one peer; returns True if state moved.

        mst (default): digest probe → Merkle summary-forest walk localizes
        differing keys in O(log n) tree nodes → per-key delta transfer.
        v2: digest probe → flat per-key digest summary → delta transfer.
        Peers that do not serve a tier's methods (``NOT_FOUND``) are
        remembered and get the next tier down (mst→v2→v1); a v1-configured
        node always speaks v1."""
        stats = self.crdt_stats
        stub = self.stub(CrdtSyncMstService, info)
        theirs = yield from stub.digest()
        stats["rounds"] += 1
        if theirs == self.store.digest():
            # identical state: snapshot (digest, vv) atomically so the next
            # divergent round can prove "peer == our old self" and skip the
            # summary exchange
            self._crdt_sync_cache[info.peer_id] = (theirs, self.store.vv())
            return False
        peer_proto = self._crdt_peer_proto.get(info.peer_id)
        if self.crdt_proto in ("v2", "mst") and peer_proto != "v1":
            cached = self._crdt_sync_cache.get(info.peer_id)
            if cached is not None and cached[0] == theirs:
                # the peer still holds exactly the state both sides shared
                # after the last round (content digests match), so what it
                # lacks is precisely delta_since(our vv back then): push it
                # without the crdt.summary round trip
                moved = yield from self._sync_crdt_skip(stub, info, cached[1])
                return moved
            if self.crdt_proto == "mst" and peer_proto != "v2":
                try:
                    moved = yield from self._sync_crdt_mst(stub)
                    stats["delta_exchanges"] += 1
                    stats["mst_exchanges"] += 1
                    self._crdt_sync_cache[info.peer_id] = (
                        self.store.digest(), self.store.vv())
                    return moved
                except ServiceError as e:
                    if e.status is not RpcStatus.NOT_FOUND:
                        raise
                    # peer predates the MST surface; remember and use flat v2
                    self._crdt_peer_proto[info.peer_id] = "v2"
            try:
                moved = yield from self._sync_crdt_v2(stub)
                stats["delta_exchanges"] += 1
                self._crdt_sync_cache[info.peer_id] = (
                    self.store.digest(), self.store.vv())
                return moved
            except ServiceError as e:
                if e.status is not RpcStatus.NOT_FOUND:
                    raise
                # peer only serves the v1 surface; remember and fall back
                self._crdt_peer_proto[info.peer_id] = "v1"
        stats["full_exchanges"] += 1
        mine = self.store.serialize()
        resp = yield from stub.exchange(mine)
        stats["tx_bytes"] += len(mine)
        stats["rx_bytes"] += len(resp)
        if self.store.merge(ReplicatedStore.deserialize(resp)):
            # rumor-monger state learned via anti-entropy: a peer the flood
            # could not reach re-publishes once it catches up, so the last
            # stragglers converge epidemically instead of pairwise-randomly
            self._schedule_crdt_push()
        return True

    def _sync_crdt_mst(self, stub: Stub) -> Generator:
        """Merkle walk + delta round of the mst protocol (digest already
        differed).  Round 0 fetches the peer's per-namespace roots; each
        following round batch-queries the differing subtrees one level
        deeper.  A differing subtree that is bucket-sized on *our* side
        stops descending there: its keys are reconciled through the
        ``crdt.delta2`` round's vv exchange (the responder ships its
        unnamed keys under the bucket path, and its ``want`` map pulls our
        surplus) — the probe never fetches per-key digest docs for buckets
        both sides hold.  Returns True if any state moved either way."""
        stats = self.crdt_stats
        store = self.store

        def track(req: bytes, resp: bytes) -> None:
            stats["tx_bytes"] += len(req)
            stats["rx_bytes"] += len(resp)
            stats["mst_probe_bytes"] += len(req) + len(resp)

        req = encode_mst_request([], want_roots=True)
        resp = yield from stub.mst(req)
        track(req, resp)
        their_roots, _ = decode_mst_response(resp)
        their_roots = their_roots or {}
        forest = store.summary_forest()
        my_roots = {ns: mst_wire_hash(t.root()) for ns, t in forest.items()}

        want_vv: Dict[str, Any] = {}    # remote-differing key -> their vv
        local_only: set = set()         # our keys the peer lacks entirely
        buckets: List[Tuple[str, str]] = []     # differing shared buckets
        frontier: List[Tuple[str, str]] = []
        for ns in sorted(set(my_roots) | set(their_roots)):
            if my_roots.get(ns) == their_roots.get(ns):
                continue
            if ns not in their_roots:
                local_only.update(forest[ns].keys_under(""))
            else:
                frontier.append((ns, ""))
        rounds = 0
        while frontier and rounds < 64:
            rounds += 1
            batch, frontier = frontier[:512], frontier[512:]
            req = encode_mst_request(batch)
            resp = yield from stub.mst(req)
            track(req, resp)
            _, docs = decode_mst_response(resp)
            for nd in docs:
                ns, path, t = nd["ns"], nd["p"], nd["t"]
                tree = forest.get(ns)
                local_keys = tree.keys_under(path) if tree is not None else []
                if t == "x":
                    # peer has nothing under this subtree
                    local_only.update(local_keys)
                elif t == "i":
                    their_children = nd["c"]        # wire-width hashes
                    mine_children = (
                        {nib: mst_wire_hash(h)
                         for nib, h in tree.children(path).items()}
                        if local_keys else {})
                    for nib in sorted(set(their_children) | set(mine_children)):
                        th = their_children.get(nib)
                        if th == mine_children.get(nib):
                            continue
                        if th is None:
                            local_only.update(tree.keys_under(path + nib))
                            continue
                        sub = path + nib
                        n_sub = (len(tree.keys_under(sub))
                                 if tree is not None else 0)
                        if 0 < n_sub <= MST_LEAF_SIZE:
                            buckets.append((ns, sub))
                        else:
                            frontier.append((ns, sub))
                else:   # leaf doc: our side was empty (or outsized) here
                    their_kd = nd["kd"]
                    mine_kd = (tree.leaf_digests(path)
                               if tree is not None else {})
                    for k, pair in their_kd.items():
                        if mine_kd.get(k) != pair[0]:
                            want_vv[k] = pair[1]
                    for k in local_keys:
                        if k not in their_kd:
                            local_only.add(k)
        diff: Dict[str, Any] = dict(want_vv)
        for k in local_only:
            diff.setdefault(k, None)    # peer knows nothing of these
        if not diff and not buckets:
            return False
        push = store.delta_since(diff, keys=diff.keys())
        my_vv = {k: store.entry_vv(k) for k in diff}
        for ns, path in buckets:
            for k in forest[ns].keys_under(path):
                my_vv[k] = store.entry_vv(k)
        req = encode_delta2_request(my_vv, push, buckets)
        dresp = yield from stub.delta2(req)
        stats["tx_bytes"] += len(req)
        stats["rx_bytes"] += len(dresp)
        their_deltas, want = decode_delta2_response(dresp)
        changed = store.apply_delta(their_deltas) if their_deltas else []
        push2 = store.delta_since(want, keys=want.keys()) if want else {}
        if push2:
            req2 = encode_delta_request({}, push2)
            dresp2 = yield from stub.delta(req2)
            stats["tx_bytes"] += len(req2)
            stats["rx_bytes"] += len(dresp2)
        if changed:
            self._schedule_crdt_push()      # rumor-monger what we learned
        return bool(changed) or bool(push) or bool(push2)

    def _sync_crdt_v2(self, stub: Stub) -> Generator:
        """Summary + delta rounds of the v2 protocol (digest already
        differed).  Returns True if any state moved in either direction."""
        stats = self.crdt_stats
        # latlint: disable=L007 negotiated flat-v2 fallback for pre-MST peers
        summary = encode_summary(self.store.key_digests())
        resp = yield from stub.summary(summary)
        stats["tx_bytes"] += len(summary)
        stats["rx_bytes"] += len(resp)
        stats["summary_bytes"] += len(summary) + len(resp)
        diff = decode_vv_map(resp)
        if not diff:
            return False
        # their vv per differing key -> what we have that they lack; our vv
        # rides along so the response carries what they have that we lack
        push = self.store.delta_since(diff, keys=diff.keys())
        my_vv = {k: self.store.entry_vv(k) for k in diff}
        req = encode_delta_request(my_vv, push)
        dresp = yield from stub.delta(req)
        stats["tx_bytes"] += len(req)
        stats["rx_bytes"] += len(dresp)
        their_deltas = ReplicatedStore.decode_delta(dresp)
        changed = self.store.apply_delta(their_deltas) if their_deltas else []
        if changed:
            self._schedule_crdt_push()      # rumor-monger what we learned
        return bool(changed) or bool(push)

    def _sync_crdt_skip(self, stub: Stub, info: PeerInfo,
                        since_vv: Dict[str, Any]) -> Generator:
        """Steady-state fast path: the peer's digest equals our snapshot
        from the last converged round, so it is missing exactly
        ``delta_since(since_vv)`` and has nothing we lack — one push-only
        ``crdt.delta``, no summary."""
        stats = self.crdt_stats
        push = self.store.delta_since(since_vv)
        # atomic (digest, vv) of the state the peer will hold post-merge;
        # verified by digest equality before the next skip, so a concurrent
        # local mutation mid-RPC only costs a fallback to the summary path
        snap = (self.store.digest(), self.store.vv())
        req = encode_delta_request({}, push)
        dresp = yield from stub.delta(req)
        stats["summary_skipped"] += 1
        stats["delta_exchanges"] += 1
        stats["tx_bytes"] += len(req)
        stats["rx_bytes"] += len(dresp)
        their_deltas = ReplicatedStore.decode_delta(dresp)
        changed = self.store.apply_delta(their_deltas) if their_deltas else []
        self._crdt_sync_cache[info.peer_id] = snap
        return bool(changed) or bool(push)

    # ------------------------------------------------------- CRDT delta push
    def watch_crdt(self, prefix: str, callback: Any) -> int:
        """Watch store keys under ``prefix`` *and* join the namespace's
        delta-push topic: ``callback(key, value, origin)`` fires on local
        mutations, merged-in anti-entropy state, and pushed deltas arriving
        via pubsub — i.e. one gossip round after a remote write, no
        anti-entropy tick required.  Returns the store watch handle.

        ``prefix`` must name a full namespace (its first path segment is
        the ``crdt/<ns>`` topic pushes are published on); an empty prefix
        would silently subscribe to a topic nothing publishes — watch
        everything with ``store.watch("")`` plus ``join_crdt_push`` per
        namespace instead."""
        if not prefix:
            raise ValueError(
                "watch_crdt needs a namespaced prefix; use store.watch('') "
                "+ join_crdt_push(ns) to watch everything")
        self.join_crdt_push(crdt_ns(prefix))
        return self.store.watch(prefix, callback)

    def join_crdt_push(self, ns: str) -> None:
        """Subscribe to ``crdt/<ns>`` delta pushes (idempotent)."""
        topic = f"crdt/{ns}"
        if topic in self._crdt_topics:
            return
        self._crdt_topics.add(topic)
        self.pubsub.subscribe(topic, self._on_crdt_push_msg)

    def _on_crdt_push_msg(self, topic: str, data: Any, frm: PeerId) -> None:
        try:
            deltas = ReplicatedStore.decode_delta(data)
            # local state on these keys not yet flushed, captured before
            # the merge — those keys must stay behind the push baseline
            pending = self.store.delta_since(self._push_vv,
                                             keys=deltas.keys())
            changed = self.store.apply_delta(deltas)
        except (ValueError, TypeError):
            self.crdt_stats["push_rejected"] += 1
            return
        if changed:
            self.crdt_stats["push_applied"] += 1
            # the push plane itself just carried this state to every mesh
            # subscriber; advancing the baseline keeps the next flush from
            # re-broadcasting the whole namespace (repair of missed pushes
            # is IHAVE/IWANT's and anti-entropy's job, not re-publish)
            for k in deltas:
                if k not in pending:
                    self._push_vv[k] = self.store.entry_vv(k)

    def _on_crdt_mutation(self, key: str) -> None:
        """Store local-mutation hook: debounce-schedule one push process so
        a burst of same-instant writes ships as a single delta batch."""
        self._schedule_crdt_push()

    def _schedule_crdt_push(self) -> None:
        if not self.crdt_push or self._push_pending:
            return
        self._push_pending = True
        self.sim.process(self._crdt_push_once())

    def _crdt_push_once(self) -> Generator:
        # window 0.0 batches just the current event instant (the mutating
        # call finishes its write batch); a positive window additionally
        # coalesces every write landing inside it into one delta doc per
        # namespace — high-churn fleets trade one window of push latency
        # for O(window) fewer published docs
        yield self.crdt_push_window
        self._push_pending = False
        yield from self.crdt_push_flush()
        return None

    def crdt_push_flush(self) -> Generator:
        """Publish per-namespace delta documents for everything mutated
        since the last push on the ``crdt/<ns>`` topics; connected
        subscribers converge in one gossip round.  Returns the number of
        topics published (0 when clean or push is disabled)."""
        if not self.crdt_push:
            return 0
        deltas = self.store.delta_since(self._push_vv)
        if not deltas:
            return 0
        self._push_vv = self.store.vv()
        by_ns: Dict[str, Dict[str, Any]] = {}
        for k, frag in deltas.items():
            by_ns.setdefault(crdt_ns(k), {})[k] = frag
        for ns in sorted(by_ns):
            blob = ReplicatedStore.encode_delta(by_ns[ns])
            self.crdt_stats["push_published"] += 1
            self.crdt_stats["push_bytes"] += len(blob)
            yield from self.pubsub.publish(f"crdt/{ns}", blob,
                                           size=max(len(blob), 64))
        return len(by_ns)

    def maintenance_loop(self, interval: float = 10.0) -> Generator:
        """Background upkeep of relay reservations.  Reservations are TTL'd
        on the relay side, so a private peer must (a) refresh each held slot
        before it expires, (b) re-establish reservations whose relay
        connection died (link flap, partition), and (c) replace relays that
        stop accepting it, topping back up to ``RELAY_TARGET`` from the
        candidate set — otherwise it silently loses inbound reachability.
        libp2p's reservation refresh works the same way."""
        while True:
            yield interval
            if self.host.nat is None:
                continue            # truly public hosts have static addrs
            # NAT keepalive: re-confirm our external mapping (STUN-style)
            # through the primary relay — or, for nodes that hold none
            # (e.g. dialable full-cone NATs, whose observed mapping IS
            # their advertised address), through a bootstrap server.
            anchors = self.relay_infos or self._relay_candidates
            if anchors:
                addr = anchors[0].addrs[0]
                try:
                    yield from self.transport.refresh_observed(
                        (addr.ip, MAIN_PORT))
                except DialError:
                    pass
            if self.transport.reachability == "public":
                continue
            for info in list(self.relay_infos):
                meta = self._relay_meta.get(info.peer_id.digest, {})
                relay_host = self.net.hosts.get(info.host_name)
                conn = (self.host.connection_to(relay_host)
                        if relay_host is not None else None)
                expiring = (self.sim.now + 2 * interval
                            >= meta.get("expires_at", 0.0))
                if conn is not None and not conn.closed and not expiring:
                    continue
                try:
                    ok = yield from self.reserve_relay(info)
                except (DialError, RpcError):
                    ok = False
                if not ok:
                    self._drop_relay(info)
            if len(self.relay_infos) < RELAY_TARGET and self._relay_candidates:
                try:
                    yield from self.acquire_relays(self._relay_candidates)
                except (DialError, RpcError):
                    pass

    def anti_entropy_loop(self, interval: float = 5.0) -> Generator:
        """Background gossip: periodically reconcile with a random peer."""
        while True:
            yield interval * (0.5 + self.sim.rng.random())
            if not self.peers:
                continue
            pid = self.sim.rng.choice(sorted(self.peers, key=lambda p: p.digest))
            info = self.peers[pid]
            try:
                yield from self.sync_crdt_with(info)
            except (DialError, RpcError, ValueError):
                # ValueError: peer sent undecodable/forbidden CRDT state —
                # skip the round, don't kill the background loop
                continue

    # ------------------------------------------------------------- artifacts
    def pin_latest(self, tag: str, root: CID) -> None:
        """Pin ``root`` as the latest version of lineage ``tag`` (a fleet,
        an artifact family) and unpin the previous holder — older versions
        become evictable under the blockstore budget while the newest one
        survives any churn."""
        prev = self._pinned_latest.get(tag)
        if prev == root:
            return
        self.blockstore.pin(root)
        if prev is not None:
            self.blockstore.unpin(prev)
        self._pinned_latest[tag] = root

    def unpin_latest(self, tag: str) -> None:
        """Release lineage ``tag`` entirely (a retired replica, a dropped
        artifact family): its current root becomes evictable.  No-op when
        the tag holds nothing."""
        root = self._pinned_latest.pop(tag, None)
        if root is not None:
            self.blockstore.unpin(root)

    def publish_artifact(self, data: bytes, meta: bytes = b"",
                         announce_topic: Optional[str] = None,
                         pin: bool = True,
                         spec: Optional[ChunkSpec] = None) -> Generator:
        """Chunk + store + provide a flat (v1) artifact; returns the root
        CID.  Raw byte blobs keep the flat manifest — the hierarchical path
        is :meth:`publish_tree_artifact`.  ``spec`` selects the chunking
        strategy (fixed-size by default; ``ChunkSpec.cdc`` keeps boundaries
        stable under byte-shifting edits)."""
        dag = build_dag(data, meta=meta, spec=spec)
        yield from self.bitswap.publish_dag(dag.blocks, dag.root)
        if pin:
            self.blockstore.pin(dag.root)
        if announce_topic is not None:
            yield from self.pubsub.publish(
                announce_topic, ("artifact", dag.root, len(data), meta), size=192)
        return dag.root

    def publish_tree_artifact(self, parts: List[Any], meta: bytes = b"",
                              announce_topic: Optional[str] = None,
                              pin: bool = True,
                              spec: Optional[ChunkSpec] = None) -> Generator:
        """Publish ``[(name, data, part_meta), ...]`` as a hierarchical (v2)
        DAG — one sub-DAG per part, so parts unchanged since an earlier
        version reuse their sub-root CIDs (and cost fetchers zero bytes).
        With a ``cdc`` ``spec``, *within-part* byte shifts also dedup: leaf
        boundaries re-synchronize after an edit instead of cascading.
        Returns the root CID."""
        dag = build_tree_dag(parts, meta=meta, spec=spec)
        yield from self.bitswap.publish_dag(dag.blocks, dag.root)
        if pin:
            self.blockstore.pin(dag.root)
        if announce_topic is not None:
            yield from self.pubsub.publish(
                announce_topic,
                ("artifact", dag.root, dag.total_size, meta), size=192)
        return dag.root

    def fetch_artifact(self, root: CID,
                       hint_providers: Optional[List[PeerInfo]] = None,
                       reprovide: bool = True,
                       assemble: bool = True) -> Generator:
        """Swarm-fetch a DAG of either manifest version.  With
        ``assemble=False`` the blocks land in the local store and ``None``
        is returned (structure-aware callers reassemble per entry)."""
        data = yield from self.bitswap.fetch_dag(root, hint_providers,
                                                 assemble=assemble)
        if reprovide:
            yield from self.dht.provide(root.key)
        return data
