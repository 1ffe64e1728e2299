"""NAT box models (RFC 3489 / Ford et al. 2005 taxonomy).

The port's own copy of the JAX package's ``core/nat.py``: the same code
under the port's import paths.

Four classical behaviours, driving the hole-punch success matrix that the
paper's ~70 % direct-connectivity figure comes from:

* FULL_CONE        endpoint-independent mapping, endpoint-independent filter
* RESTRICTED_CONE  endpoint-independent mapping, address-restricted filter
* PORT_RESTRICTED  endpoint-independent mapping, address+port-restricted filter
* SYMMETRIC        endpoint-DEPENDENT mapping (new external port per dst),
                   address+port-restricted filter

Hole punching (simultaneous open coordinated over a relay) succeeds iff each
side's punch packet passes the other side's filter given the externally
*observed* address each peer advertised.  Symmetric NATs advertise a port that
differs from the one they will actually use toward the peer, so punches into
port-restricted or symmetric counterparts fail *unless* the peer can predict
the next mapping — which is only possible when the NAT's port allocator is
regular.  Following the measurement literature (Trautwein et al.,
"Challenging Tribal Knowledge"), real symmetric NATs fall into a few
allocation families, modelled here by :class:`PortAlloc`:

* SEQUENTIAL   next external port = previous + 1 (very common CPE firmware)
* FIXED_DELTA  next = previous + delta for a device-constant delta
* RANDOM       uniformly random free port — unpredictable, punch-proof

Sequential and fixed-delta allocators make predicted-port hole punching
(DCUtR v2 in ``traversal.py``) viable; random allocators force relay
fallback.  Every box also keeps per-box counters so fleets can report
per-NAT-kind traversal behaviour (``Network.nat_stats`` aggregates them).
"""

from __future__ import annotations

import itertools
from enum import Enum
from typing import Dict, List, Optional, Set, Tuple, TYPE_CHECKING, Union

if TYPE_CHECKING:  # pragma: no cover
    from .simnet import Host, Network

Addr = Tuple[str, int]


class NATKind(Enum):
    FULL_CONE = "full_cone"
    RESTRICTED_CONE = "restricted_cone"
    PORT_RESTRICTED = "port_restricted"
    SYMMETRIC = "symmetric"


class PortAlloc(Enum):
    """External-port allocation policy of a NAT box."""

    SEQUENTIAL = "sequential"
    FIXED_DELTA = "fixed_delta"
    RANDOM = "random"


#: Random allocators draw from this external port range.
RANDOM_PORT_RANGE = (21000, 61000)


class NATBox:
    _ip_seq = itertools.count(1)

    def __init__(self, net: "Network", kind: NATKind,
                 alloc: Union[PortAlloc, str] = PortAlloc.SEQUENTIAL,
                 delta: int = 1, port_base: int = 20000,
                 ttl: Optional[float] = None):
        self.net = net
        self.kind = kind
        self.alloc = PortAlloc(alloc)
        self.delta = int(delta) if self.alloc is not PortAlloc.SEQUENTIAL else 1
        if self.alloc is PortAlloc.FIXED_DELTA and self.delta < 1:
            raise ValueError("fixed_delta allocator needs delta >= 1")
        if ttl is not None and ttl <= 0:
            raise ValueError("nat mapping ttl must be positive")
        #: Idle seconds after which a mapping expires (RFC 4787 REQ-5 UDP
        #: timer).  ``None`` keeps mappings forever — the pre-expiry model.
        self.ttl = ttl
        self.public_ip = f"198.51.{next(NATBox._ip_seq)}.1"
        self._next_port = port_base
        # cone NATs: (int_ip, int_port) -> ext_port
        self._cone_map: Dict[Tuple[str, int], int] = {}
        # symmetric NATs: (int_ip, int_port, dst) -> ext_port
        self._sym_map: Dict[Tuple[str, int, Addr], int] = {}
        # reverse: ext_port -> (host, int_port)
        self._rev: Dict[int, Tuple["Host", int]] = {}
        # filter state: ext_port -> set of remote addrs/ips sent to
        self._sent_to: Dict[int, Set[Addr]] = {}
        # expiry state: ext_port -> last traffic time / owning map key
        self._last_used: Dict[int, float] = {}
        self._key_of: Dict[int, Tuple] = {}
        self._hosts: Dict[str, "Host"] = {}
        #: Per-box traversal counters (aggregated per kind by
        #: ``Network.nat_stats``).
        self.stats = {
            "mappings": 0,            # external mappings minted
            "inbound_ok": 0,          # inbound datagrams routed through
            "inbound_filtered": 0,    # dropped by the filter state machine
            "inbound_unmapped": 0,    # dropped: no mapping at that ext port
            "expired": 0,             # mappings reclaimed by the idle timer
        }
        net.register_nat(self)

    def attach(self, host: "Host") -> None:
        self._hosts[host.ip] = host

    # -- allocation ----------------------------------------------------------
    def _alloc_port(self) -> int:
        if self.alloc is PortAlloc.RANDOM:
            lo, hi = RANDOM_PORT_RANGE
            while True:
                port = self.net.sim.rng.randrange(lo, hi)
                if port not in self._rev:
                    return port
        port = self._next_port
        self._next_port += self.delta
        while port in self._rev:  # skip ports still held by older mappings
            port += self.delta
            self._next_port = port + self.delta
        return port

    def _mint(self, host: "Host", int_port: int) -> int:
        ext = self._alloc_port()
        self._rev[ext] = (host, int_port)
        self._sent_to[ext] = set()
        self._last_used[ext] = self.net.sim.now
        self.stats["mappings"] += 1
        return ext

    # -- expiry --------------------------------------------------------------
    def _expired(self, ext: int) -> bool:
        if self.ttl is None:
            return False
        last = self._last_used.get(ext)
        return last is not None and self.net.sim.now - last > self.ttl

    def _purge(self, ext: int) -> None:
        """Reclaim one idle mapping: external port, filter state, and the
        owning cone/symmetric table entry all go together, so the next
        outbound flow mints a *fresh* external port (which is exactly what
        breaks stale advertised addresses on real NATs)."""
        self._rev.pop(ext, None)
        self._sent_to.pop(ext, None)
        self._last_used.pop(ext, None)
        key = self._key_of.pop(ext, None)
        if key is not None:
            if len(key) == 3:
                self._sym_map.pop(key, None)
            else:
                self._cone_map.pop(key, None)
        self.stats["expired"] += 1

    # -- outbound ------------------------------------------------------------
    def map_outbound(self, host: "Host", int_port: int, dst: Addr) -> Addr:
        if self.kind is NATKind.SYMMETRIC:
            key: Tuple = (host.ip, int_port, dst)
            table: Dict = self._sym_map
        else:
            key = (host.ip, int_port)
            table = self._cone_map
        ext = table.get(key)
        if ext is not None and self._expired(ext):
            self._purge(ext)
            ext = None
        if ext is None:
            ext = table[key] = self._mint(host, int_port)
            self._key_of[ext] = key
        self._sent_to[ext].add(dst)
        self._last_used[ext] = self.net.sim.now
        return (self.public_ip, ext)

    # -- inbound -------------------------------------------------------------
    def filter_inbound(self, ext_port: int, src: Addr) -> Optional[Tuple["Host", int]]:
        entry = self._rev.get(ext_port)
        if entry is not None and self._expired(ext_port):
            self._purge(ext_port)
            entry = None
        if entry is None:
            self.stats["inbound_unmapped"] += 1
            return None
        sent = self._sent_to.get(ext_port, set())
        if self.kind is NATKind.FULL_CONE:
            return self._pass(ext_port, entry)
        if self.kind is NATKind.RESTRICTED_CONE:
            if any(a[0] == src[0] for a in sent):
                return self._pass(ext_port, entry)
            self.stats["inbound_filtered"] += 1
            return None
        # PORT_RESTRICTED and SYMMETRIC both filter on (ip, port)
        if src in sent:
            return self._pass(ext_port, entry)
        self.stats["inbound_filtered"] += 1
        return None

    def _pass(self, ext_port: int,
              entry: Tuple["Host", int]) -> Tuple["Host", int]:
        """Route one inbound datagram through; established flows keep
        their mapping alive in both directions (RFC 4787 REQ-6)."""
        self.stats["inbound_ok"] += 1
        self._last_used[ext_port] = self.net.sim.now
        return entry


def nat_label(box: Optional[NATBox]) -> str:
    """Human-readable NAT class: ``"symmetric/<alloc>"`` for symmetric boxes
    (where the allocator determines punchability), the bare kind for cone
    boxes (their allocator is irrelevant to mapping behaviour), and
    ``"public"`` for no NAT.  Shared by stats aggregation and fleet
    reporting so per-kind rows always correlate."""
    if box is None:
        return "public"
    if box.kind is NATKind.SYMMETRIC:
        return f"{box.kind.value}/{box.alloc.value}"
    return box.kind.value


def aggregate_nat_stats(boxes: List[NATBox]) -> Dict[str, Dict[str, int]]:
    """Sum per-box counters into per-:func:`nat_label` rows."""
    out: Dict[str, Dict[str, int]] = {}
    for box in boxes:
        key = nat_label(box)
        row = out.setdefault(key, {"boxes": 0})
        row["boxes"] += 1
        for k, v in box.stats.items():
            row[k] = row.get(k, 0) + v
    return out
