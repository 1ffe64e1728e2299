"""Fleet builder: spin up a realistic Lattica mesh in one call.

The port's own copy of the JAX package's ``core/fleet.py``: the same code
under the port's import paths.

Used by tests, benchmarks and examples.  The default NAT-type mix follows
measured Internet distributions (Ford et al. 2005-era surveys: most NATs are
cone-like, a substantial minority symmetric), which is what produces the
paper's ~70 % direct hole-punch success among NAT'd pairs.  Symmetric boxes
additionally draw a port-allocation model (``sym_alloc_mix``): sequential
and fixed-delta allocators are predictable enough for DCUtR v2's
predicted-port spray, random ones force relay fallback — mirroring the NAT
measurement literature (Trautwein et al.).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Generator, List, Optional, Sequence, Tuple, Union

from .nat import NATBox, NATKind, PortAlloc, nat_label
from .node import LatticaNode
from .simnet import Network, Sim

#: NAT-type mix from the Trautwein et al. decentralized hole-punching
#: measurement campaign (PAPERS.md): live DHT crawls see fewer public
#: hosts than the Ford-era surveys and a heavier tail of address/port-
#: dependent (symmetric) boxes — the composition that makes 1k–10k-node
#: churn scenarios representative rather than optimistic.
TRAUTWEIN_NAT_MIX: List[Tuple[Optional[NATKind], float]] = [
    (None, 0.08),
    (NATKind.FULL_CONE, 0.10),
    (NATKind.RESTRICTED_CONE, 0.12),
    (NATKind.PORT_RESTRICTED, 0.38),
    (NATKind.SYMMETRIC, 0.32),
]

#: (kind, weight); ``None`` = publicly addressable host.  Weighted toward
#: hard NATs (port-restricted + symmetric ≈ 60%), which yields ≈70% direct
#: connectivity across random pairs — the paper's §4 figure.
DEFAULT_NAT_MIX: List[Tuple[Optional[NATKind], float]] = [
    (None, 0.10),
    (NATKind.FULL_CONE, 0.15),
    (NATKind.RESTRICTED_CONE, 0.15),
    (NATKind.PORT_RESTRICTED, 0.30),
    (NATKind.SYMMETRIC, 0.30),
]

#: Port-allocation model mix for SYMMETRIC boxes: (alloc, delta, weight).
#: Most CPE firmware allocates sequentially or with a small fixed stride
#: (predictable); a minority randomizes (punch-proof).
DEFAULT_SYM_ALLOC_MIX: List[Tuple[PortAlloc, int, float]] = [
    (PortAlloc.SEQUENTIAL, 1, 0.50),
    (PortAlloc.FIXED_DELTA, 2, 0.30),
    (PortAlloc.RANDOM, 1, 0.20),
]

REGIONS = ["us", "eu", "ap"]


@dataclass
class Fleet:
    sim: Sim
    net: Network
    bootstrap: List[LatticaNode]
    peers: List[LatticaNode]

    @property
    def all_nodes(self) -> List[LatticaNode]:
        return self.bootstrap + self.peers

    def node_by_name(self, name: str) -> LatticaNode:
        for n in self.all_nodes:
            if n.host.name == name:
                return n
        raise KeyError(name)

    def nat_kind_of(self, node: LatticaNode) -> str:
        """Human-readable NAT class of a node (for per-kind reporting)."""
        return nat_label(node.host.nat)


#: A per-peer NAT spec: ``None`` (public), a bare ``NATKind`` (default
#: allocator), or ``(NATKind, alloc, delta)`` for full control.
NatSpec = Union[None, NATKind, Tuple[NATKind, Union[PortAlloc, str], int]]


def wait_converged(sim: Sim, nodes_or_stores: Sequence[object],
                   timeout: float = 120.0) -> bool:
    """Run the sim until every replica's store digest agrees (or timeout).

    Built on the CRDT watch API: a change at *any* replica re-checks
    convergence immediately, so tests and examples no longer guess how many
    anti-entropy rounds to sleep through (the old registry-convergence
    flakiness).  Accepts ``LatticaNode``s or bare ``ReplicatedStore``s;
    background processes (gossip, fetch loops) keep running while this
    pumps the event loop.  Returns True once all digests are equal."""
    stores = [getattr(s, "store", s) for s in nodes_or_stores]

    def waiter() -> Generator:
        deadline = sim.now + timeout
        wake = [sim.event()]

        def ping(_key: object, _value: object, _origin: str) -> None:
            if not wake[0].triggered:
                wake[0].succeed()

        handles = [(s, s.watch("", ping)) for s in stores]
        try:
            while True:
                if len({s.digest() for s in stores}) == 1:
                    return True
                if sim.now >= deadline:
                    return False
                yield sim.any_of([wake[0], sim.timeout(deadline - sim.now)])
                wake[0] = sim.event()
        finally:
            for s, h in handles:
                s.unwatch(h)

    return sim.run_process(waiter(), until=sim.now + timeout + 1.0)


def make_nat(net: Network, spec: NatSpec) -> Optional[NATBox]:
    """Materialize a :data:`NatSpec` into a NAT box (or None for public)."""
    if spec is None:
        return None
    if isinstance(spec, NATKind):
        return NATBox(net, spec)
    kind, alloc, delta = spec
    return NATBox(net, kind, alloc=alloc, delta=delta)


def make_fleet(n_peers: int, seed: int = 0, n_bootstrap: int = 2,
               nat_mix: Optional[Sequence[Tuple[Optional[NATKind], float]]] = None,
               sym_alloc_mix: Optional[Sequence[Tuple[PortAlloc, int, float]]] = None,
               nat_kinds: Optional[Sequence[NatSpec]] = None,
               regions: Optional[List[str]] = None,
               same_region: Optional[str] = None,
               join: bool = True,
               maintenance: bool = True,
               cores: int = 4,
               sim: Optional[Sim] = None) -> Fleet:
    """Build bootstrap/relay servers + ``n_peers`` NAT-mixed peers.

    ``nat_kinds`` pins the exact per-peer NAT spec (overriding the random
    mix) — used by the punch-matrix benchmark and tests that need a
    controlled composition; it must have ``n_peers`` entries.

    With ``join=True`` every peer runs the full bootstrap (dial, AutoNAT,
    relay reservations if private, DHT self-lookup) before this returns.
    With ``maintenance=True`` (default) every peer also runs its background
    ``maintenance_loop`` — started right after that peer joins, so relay
    reservations (TTL'd on the relay side) are refreshed both while later
    peers are still joining and across long simulations.
    """
    if nat_kinds is not None and len(nat_kinds) != n_peers:
        raise ValueError("nat_kinds must have n_peers entries")
    # ``sim=`` lets callers supply a pre-configured simulator (e.g.
    # ``Sim(sanitize=True)`` for the simsan determinism/leak gates);
    # ``seed`` is ignored in that case.
    sim = Sim(seed=seed) if sim is None else sim
    net = Network(sim)
    nat_mix = list(nat_mix if nat_mix is not None else DEFAULT_NAT_MIX)
    alloc_mix = list(sym_alloc_mix if sym_alloc_mix is not None
                     else DEFAULT_SYM_ALLOC_MIX)
    regions = regions or REGIONS

    boots = []
    for b in range(n_bootstrap):
        node = LatticaNode(net, f"boot{b}", region=regions[b % len(regions)],
                           zone="core", serve_rendezvous=(b == 0), cores=cores)
        node.transport.enable_relay()
        boots.append(node)
    # interconnect bootstrap servers (sound AutoNAT forwarding needs a
    # public neighbor that joiners have not contacted yet)
    for b in boots[1:]:
        sim.run_process(b.connect_info(boots[0].info()))

    binfos = [b.info() for b in boots]
    kinds, weights = zip(*nat_mix)
    alloc_choices = [(a, d) for a, d, _w in alloc_mix]
    alloc_weights = [w for _a, _d, w in alloc_mix]
    peers: List[LatticaNode] = []
    for i in range(n_peers):
        if nat_kinds is not None:
            nat = make_nat(net, nat_kinds[i])
        else:
            kind = sim.rng.choices(kinds, weights=weights)[0]
            if kind is NATKind.SYMMETRIC:
                alloc, delta = sim.rng.choices(alloc_choices,
                                               weights=alloc_weights)[0]
                nat = NATBox(net, kind, alloc=alloc, delta=delta)
            elif kind is not None:
                nat = NATBox(net, kind)
            else:
                nat = None
        region = same_region or regions[i % len(regions)]
        zone = "a" if same_region else sim.rng.choice(["a", "b"])
        node = LatticaNode(net, f"peer{i}", region=region, zone=zone,
                           nat=nat, cores=cores)
        peers.append(node)

    for node in peers:
        if join:
            def _join(n: LatticaNode = node) -> Generator:
                yield from n.bootstrap(binfos)
                return None
            sim.run_process(_join())
        if maintenance:
            sim.process(node.maintenance_loop(), daemon=True)

    return Fleet(sim=sim, net=net, bootstrap=boots, peers=peers)


# ---------------------------------------------------------------------------
# Scale harness: 1k–10k virtual-clock nodes in seconds
# ---------------------------------------------------------------------------

#: approximate direct hole-punch success probabilities by NAT-kind pairing,
#: sampled instead of simulated at scale (the full DCUtR state machine is
#: exercised by ``make_fleet``/the traversal tests; re-running it for every
#: overlay edge of a 10k-node fleet would dominate build time without
#: changing the topology statistics).  Numbers bracket the ~70% aggregate
#: direct-connectivity figure the measurement campaign reports.
_PUNCH_P_CONE = 0.85          # neither side symmetric
_PUNCH_P_ONE_SYM = 0.65       # one symmetric (predictable allocator helps)
_PUNCH_P_BOTH_SYM = 0.15      # both symmetric: predicted-port spray rarely
_PUNCH_P_RANDOM_SYM = 0.02    # symmetric with randomized allocation


@dataclass
class ScaleFleet:
    """A pre-wired overlay of ``n`` nodes for fleet-scale benchmarks.

    Unlike :func:`make_fleet`, nodes do not run the full bootstrap
    (AutoNAT probes, relay reservations, DHT self-lookups): reachability
    is assigned from the NAT spec, address books and routing tables are
    seeded with sampled public contacts, and overlay connections are
    established directly — NAT'd nodes dial outbound, NAT'd↔NAT'd edges
    are kept with the measured punch-success probability.  That is what
    lets a 10k-node fleet stand up in seconds of wall time while keeping
    the topology statistics (public fraction, punchable-pair fraction,
    degree) faithful to the measurement campaign.
    """

    sim: Sim
    net: Network
    nodes: List[LatticaNode]
    publics: List[LatticaNode]
    natted: List[LatticaNode]
    degree: int
    public_contacts: int
    stats: Dict[str, int] = field(default_factory=lambda: {
        "edges": 0, "edges_public": 0, "edges_punched": 0,
        "edges_skipped": 0, "churn_events": 0})

    def node_by_name(self, name: str) -> LatticaNode:
        for n in self.nodes:
            if n.host.name == name:
                return n
        raise KeyError(name)

    # -- wiring -------------------------------------------------------------
    def _connectable(self, a: LatticaNode, b: LatticaNode) -> Optional[str]:
        """Edge classification: 'public' (at least one dialable side),
        'punched' (NAT'd pair that wins the punch-probability draw) or
        None (edge dropped)."""
        if a.host.nat is None or b.host.nat is None:
            return "public"
        kinds = (a.host.nat.kind, b.host.nat.kind)
        allocs = (a.host.nat.alloc, b.host.nat.alloc)
        if NATKind.SYMMETRIC in kinds:
            if PortAlloc.RANDOM in allocs:
                p = _PUNCH_P_RANDOM_SYM
            elif kinds == (NATKind.SYMMETRIC, NATKind.SYMMETRIC):
                p = _PUNCH_P_BOTH_SYM
            else:
                p = _PUNCH_P_ONE_SYM
        else:
            p = _PUNCH_P_CONE
        return "punched" if self.sim.rng.random() < p else None

    def _connect(self, a: LatticaNode, b: LatticaNode) -> bool:
        """Establish one overlay edge (both address books learn it)."""
        if a.host.connection_to(b.host) is not None:
            return True
        edge = self._connectable(a, b)
        if edge is None:
            self.stats["edges_skipped"] += 1
            return False
        self.net.establish(a.host, b.host)
        a.remember(b.info())
        b.remember(a.info())
        self.stats["edges"] += 1
        self.stats["edges_public" if edge == "public" else
                    "edges_punched"] += 1
        return True

    def wire_node(self, node: LatticaNode) -> None:
        """Seed one node's contacts and overlay edges (also the rejoin
        path after churn): remember a sample of public nodes (address
        book + routing table), then dial out until ``degree`` overlay
        edges exist."""
        rng = self.sim.rng
        publics = [p for p in self.publics if p is not node]
        if publics:
            k = min(self.public_contacts, len(publics))
            for pub in rng.sample(publics, k):
                node.remember(pub.info())
        # draw candidates lazily — O(degree) expected per node, where a
        # full shuffle would make standing up a 10k fleet O(n^2)
        n = len(self.nodes)
        wired = 0
        attempts = 0
        tried = {node.host.name}
        while (wired < self.degree and attempts < 20 * self.degree
               and len(tried) <= n):
            attempts += 1
            cand = self.nodes[rng.randrange(n)]
            if cand.host.name in tried:
                continue
            tried.add(cand.host.name)
            if self._connect(node, cand):
                wired += 1

    # -- churn --------------------------------------------------------------
    def churn_wave(self, frac: float) -> List[LatticaNode]:
        """Restart ``frac`` of the NAT'd population: connections drop,
        transient mesh/sync state is lost, and each victim rejoins
        through fresh contacts.  Peers notice only through failed
        deliveries (score collapse → prune → re-graft), exactly like a
        real churn event.  Returns the restarted nodes."""
        rng = self.sim.rng
        k = max(1, int(len(self.natted) * frac))
        victims = rng.sample(self.natted, min(k, len(self.natted)))
        for node in victims:
            self._restart(node)
        self.stats["churn_events"] += len(victims)
        return victims

    def churn_loop(self, frac: float, interval: float) -> Generator:
        """Continuous churn driver: one :meth:`churn_wave` per interval.
        Run it as a daemon process alongside the measured workload."""
        while True:
            yield interval
            self.churn_wave(frac)

    def _restart(self, node: LatticaNode) -> None:
        for conns in list(node.host._connections.values()):
            for c in list(conns):
                if not c.closed:
                    c.close()
        ps = node.pubsub
        for members in ps.mesh.values():
            members.clear()
        ps.peer_topics.clear()
        ps._pending_iwant.clear()
        ps._mcache.clear()
        ps._mcache_windows[:] = [[]]
        ps._seen.clear()
        node.peers.clear()
        node.infos_by_host.clear()
        node._stub_cache.clear()
        node._crdt_peer_proto.clear()
        node._crdt_sync_cache.clear()
        self.wire_node(node)
        # a restarted process re-announces its subscriptions on rejoin
        if ps.subscriptions:
            ps._push_subscription_update()

    # -- views --------------------------------------------------------------
    def relay_load(self) -> List[int]:
        """Per-node forwarded-message counts (mesh relay load)."""
        return [n.pubsub.stats["forwarded"] for n in self.nodes]

    def summary_bytes(self) -> Dict[str, int]:
        """Fleet-wide anti-entropy localization cost counters."""
        out = {"mst_probe_bytes": 0, "flat_summary_bytes": 0,
               "mst_exchanges": 0, "delta_exchanges": 0}
        for n in self.nodes:
            out["mst_probe_bytes"] += n.crdt_stats["mst_probe_bytes"]
            out["flat_summary_bytes"] += n.crdt_stats["summary_bytes"]
            out["mst_exchanges"] += n.crdt_stats["mst_exchanges"]
            out["delta_exchanges"] += n.crdt_stats["delta_exchanges"]
        return out


def make_scale_fleet(n_nodes: int, seed: int = 0,
                     nat_mix: Optional[Sequence[
                         Tuple[Optional[NATKind], float]]] = None,
                     sym_alloc_mix: Optional[Sequence[
                         Tuple[PortAlloc, int, float]]] = None,
                     degree: int = 8,
                     public_contacts: int = 16,
                     cores: int = 2,
                     crdt_push_window: float = 0.25,
                     nat_ttl: Optional[float] = 90.0,
                     regions: Optional[Sequence[str]] = None,
                     latency: Optional[Dict[str, float]] = None,
                     bandwidth: Optional[Dict[str, float]] = None,
                     sim: Optional[Sim] = None) -> ScaleFleet:
    """Stand up ``n_nodes`` virtual-clock nodes with the Trautwein NAT mix.

    Every node gets ``public_contacts`` sampled public peers in its
    address book / routing table and ``degree`` pre-established overlay
    edges (outbound from behind NAT; NAT'd↔NAT'd kept with the measured
    punch probability).  ``crdt_push_window`` defaults to a positive
    coalescing window — at fleet scale, per-instant delta docs are
    exactly the hot-namespace flood the batching window exists to stop.

    ``regions`` round-robins node placement over the given region labels
    (default: all of :data:`REGIONS`); ``latency``/``bandwidth`` override
    link-class parameters on the fabric — together they model
    heterogeneous-bandwidth multi-region fleets (e.g. two regions joined
    by a thin ``inter`` path for cross-region training rounds).
    """
    sim = Sim(seed=seed) if sim is None else sim
    net = Network(sim, latency=latency, bandwidth=bandwidth)
    region_cycle = list(regions) if regions else list(REGIONS)
    nat_mix = list(nat_mix if nat_mix is not None else TRAUTWEIN_NAT_MIX)
    alloc_mix = list(sym_alloc_mix if sym_alloc_mix is not None
                     else DEFAULT_SYM_ALLOC_MIX)
    kinds, weights = zip(*nat_mix)
    alloc_choices = [(a, d) for a, d, _w in alloc_mix]
    alloc_weights = [w for _a, _d, w in alloc_mix]

    nodes: List[LatticaNode] = []
    publics: List[LatticaNode] = []
    natted: List[LatticaNode] = []
    for i in range(n_nodes):
        kind = sim.rng.choices(kinds, weights=weights)[0]
        if kind is NATKind.SYMMETRIC:
            alloc, delta = sim.rng.choices(alloc_choices,
                                           weights=alloc_weights)[0]
            nat: Optional[NATBox] = NATBox(net, kind, alloc=alloc,
                                           delta=delta, ttl=nat_ttl)
        elif kind is not None:
            nat = NATBox(net, kind, ttl=nat_ttl)
        else:
            nat = None
        node = LatticaNode(net, f"n{i}",
                           region=region_cycle[i % len(region_cycle)],
                           zone=sim.rng.choice(["a", "b"]), nat=nat,
                           cores=cores, crdt_push_window=crdt_push_window)
        # reachability is assigned, not probed: the AutoNAT dance is a
        # per-node constant cost that adds nothing at this scale
        node.transport.reachability = "public" if nat is None else "private"
        # bound subscription-announce fan-out to roughly the overlay
        # degree (gossipsub announces over connected links only)
        node.pubsub.announce_cap = degree + 4
        nodes.append(node)
        (publics if nat is None else natted).append(node)

    fleet = ScaleFleet(sim=sim, net=net, nodes=nodes, publics=publics,
                       natted=natted, degree=degree,
                       public_contacts=public_contacts)
    for node in nodes:
        fleet.wire_node(node)
    return fleet
