"""Connectivity: direct dial, AutoNAT, circuit relay, DCUtR hole punching.

The port's own copy of the JAX package's ``core/traversal.py``: the same
code under the port's import paths.

This is the paper's Scenario 1.  All reachability decisions happen at the
*packet* level against the NAT models in ``nat.py`` — success/failure of a
hole punch is an emergent property of the NAT state machines, not a table
lookup, so the ~70 % direct-connectivity figure can be measured rather than
asserted.

Key modelling choice (mirrors QUIC/libp2p): every node sends all control
traffic from ONE main socket (port 4001).  Cone NATs therefore reuse the same
external mapping toward the relay and toward punch targets, which is exactly
what makes DCUtR work for them; symmetric NATs mint a fresh external port per
destination, which is exactly what breaks the naive punch.

DCUtR v2 (this module) recovers most symmetric pairs anyway:

* both sides exchange their *full* recent candidate address set (stale
  entries are pruned by age, and one bad candidate no longer sinks the
  upgrade — every candidate is punched in parallel);
* a peer behind an endpoint-dependent (symmetric) NAT learns its box's
  port-allocation fingerprint by probing the relay from fresh sockets: two
  consecutive allocation deltas agreeing ⇒ a predictable stride;
* the counterpart then *sprays* a predicted port window
  ``base + stride·k`` (birthday-paradox style) alongside the advertised
  candidates, catching the fresh mapping the symmetric NAT mints when its
  host punches outward.  Sequential / fixed-delta allocators thus upgrade
  to direct paths; random allocators stay on the relay.

Relay reservations are a managed resource: TTL'd, capacity-bounded,
refreshable only by the same host, and evicted as soon as the relay answers
"relay lost target" for them.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, Generator, List, Optional, Set, Tuple

from .peer import PeerId
from .service import stream_request
from .simnet import Connection, DialError, Host, Network, Sim, Stream

# NOTE: traversal control messages run *below* the typed service plane of
# ``service.py`` — they execute while the connection (or even reachability)
# is still being established, so no RPC router is addressable yet.  The
# request/response exchanges that do run over streams share the service
# layer's ``stream_request`` helper instead of hand-rolling send/recv/close.

Addr = Tuple[str, int]

MAIN_PORT = 4001
DIAL_TIMEOUT = 0.8
HANDSHAKE_CPU = 150e-6          # Noise/TLS1.3 asymmetric crypto per side
PUNCH_TRIES = 5
PUNCH_INTERVAL = 0.08
PUNCH_BACKOFF = 1.5             # retry interval growth factor

#: Predicted-port spray: how many ``base + stride·k`` slots to cover.  Must
#: exceed the number of mappings the symmetric side mints while punching the
#: counterpart's candidate list (≤ OBSERVED_ADDR_MAX + slack).
PREDICT_WINDOW = 12
#: Allocation deltas above this are treated as unpredictable.
MAX_PREDICTABLE_STRIDE = 64
#: Observed addresses confirmed within this window count as punch-fresh;
#: anything older triggers a re-learn through the relay before punching.
FRESH_ADDR_AGE = 30.0

#: Observed-address book: drop entries not re-confirmed within the TTL, and
#: keep at most this many (most recent first) as punch candidates.
OBSERVED_ADDR_TTL = 300.0
OBSERVED_ADDR_MAX = 8
#: AutoNAT: how many observed candidates to dial-back before concluding
#: "private" (one stale candidate must not misclassify a reachable host).
AUTONAT_MAX_PROBES = 4

RELAY_RESERVATION_TTL = 120.0
RELAY_MAX_RESERVATIONS = 64

PROTO_RELAY_RESERVE = "/lattica/relay/reserve/1.0"
PROTO_RELAY_CONNECT = "/lattica/relay/connect/1.0"
PROTO_RELAY_STOP = "/lattica/relay/stop/1.0"
PROTO_DCUTR = "/lattica/dcutr/2.0"
PROTO_AUTONAT = "/lattica/autonat/1.0"
PROTO_AUTONAT_FWD = "/lattica/autonat/fwd/1.0"
PROTO_PING = "/lattica/ping/1.0"

_req_seq = itertools.count(1)


@dataclass
class RelayReservation:
    """A relay-side slot: who may be circuit-dialed through this relay."""

    host: Host
    host_name: str
    created_at: float
    expires_at: float
    refreshes: int = 0


class Transport:
    """Per-host connectivity engine: packet listener + dial/punch/relay."""

    def __init__(self, host: Host, peer_id: PeerId):
        self.host = host
        self.peer_id = peer_id
        self.sim: Sim = host.net.sim
        self.net: Network = host.net
        self.sock = host.bind(MAIN_PORT)
        self._pending: Dict[Tuple[str, int], "object"] = {}
        # addr -> sim time last confirmed (insertion refreshed on re-observe)
        self._observed: Dict[Addr, float] = {}
        # sticky: once two ports were seen for one external IP, the NAT is
        # known endpoint-dependent for good (a property of the box, not of
        # whichever observations happen to still be fresh)
        self._seen_endpoint_dependent = False
        self.observed_of: Dict[str, Addr] = {}   # peer host name -> addr we saw
        self.reachability = "unknown"            # unknown | public | private
        self.relay_reservations: Dict[bytes, RelayReservation] = {}
        self.relay_ttl = RELAY_RESERVATION_TTL
        self.relay_capacity = RELAY_MAX_RESERVATIONS
        self.is_relay = False
        self.stats = {
            "dials_direct_ok": 0, "dials_direct_fail": 0,
            "punch_ok": 0, "punch_fail": 0, "relayed": 0,
            "predicted_punch_ok": 0, "fingerprint_probes": 0,
        }
        self.relay_stats = {
            "reserved": 0, "refreshed": 0, "expired": 0,
            "rejected_capacity": 0, "rejected_foreign": 0,
            "dropped_lost_target": 0,
        }
        self.sim.process(self._listen(), daemon=True)
        self.sim.register_leak_check(
            f"relay.reservations:{host.name}", self._live_reservation_count)
        host.handle(PROTO_PING, self._ping_handler)
        host.handle(PROTO_DCUTR, self._dcutr_handler)
        host.handle(PROTO_AUTONAT, self._autonat_handler)
        host.handle(PROTO_AUTONAT_FWD, self._autonat_fwd_handler)

    # --------------------------------------------------------- observed addrs
    @property
    def observed_addrs(self) -> Set[Addr]:
        """Live (non-expired) externally-observed addresses of this host."""
        self._prune_observed()
        return set(self._observed)

    def _observe(self, addr: Addr) -> None:
        addr = tuple(addr)
        if any(ip == addr[0] and port != addr[1]
               for ip, port in self._observed):
            self._seen_endpoint_dependent = True
        self._observed.pop(addr, None)           # refresh recency ordering
        self._observed[addr] = self.sim.now
        self._prune_observed()

    def _prune_observed(self) -> None:
        # Drop entries past the TTL — but always keep the freshest one: the
        # NAT mapping behind it does not expire in this model, and it is the
        # only dialable address a keepalive-less full-cone node has.
        now = self.sim.now
        if not self._observed:
            return
        newest = max(self._observed, key=self._observed.get)
        stale = [a for a, t in self._observed.items()
                 if now - t > OBSERVED_ADDR_TTL and a != newest]
        for a in stale:
            del self._observed[a]
        while len(self._observed) > OBSERVED_ADDR_MAX:
            oldest = min(self._observed, key=self._observed.get)
            del self._observed[oldest]

    def candidate_addrs(self) -> List[Addr]:
        """Punch/dial candidates, most recently confirmed first."""
        if self.host.nat is None:
            return [(self.host.ip, MAIN_PORT)]
        self._prune_observed()
        ranked = sorted(self._observed, key=self._observed.get, reverse=True)
        return ranked or [(self.host.ip, MAIN_PORT)]

    def refresh_observed(self, via: Addr, timeout: float = 0.5) -> Generator:
        """STUN-style keepalive: one syn/synack exchange from the MAIN
        socket toward ``via`` (our relay), re-confirming the external
        mapping punch candidates are built from.  Cone NATs re-confirm their
        single mapping; symmetric NATs re-confirm the relay-facing one."""
        req = next(_req_seq)
        ev = self.sim.event()
        self._pending[("synack", req)] = ev
        try:
            self.sock.sendto(via, ("syn", req, self.host.name), 80)
            idx, _ = yield self.sim.any_of([ev, self.sim.timeout(timeout)])
            return idx == 0          # the synack branch already observed it
        finally:
            self._pending.pop(("synack", req), None)

    def _freshen_for_punch(self, relay: Optional[Host]) -> Generator:
        """Before a punch, make sure we advertise at least one *live*
        candidate: if everything in the address book is stale (or gone),
        re-learn our mapping through the relay."""
        if self.host.nat is None or relay is None:
            return None
        now = self.sim.now
        fresh = [a for a, t in self._observed.items()
                 if now - t <= FRESH_ADDR_AGE]
        if not fresh:
            yield from self.refresh_observed((relay.ip, MAIN_PORT))
        return None

    def endpoint_dependent(self) -> bool:
        """Does our NAT mint a fresh mapping per destination (symmetric)?

        Inferred honestly from the address book: distinct external ports for
        the same external IP ⇒ endpoint-dependent mapping.  (A cone NAT shows
        every server the same mapping of our main socket.)  The verdict is
        sticky — mapping behaviour is a property of the box, so it survives
        the observations that established it aging out.
        """
        if self.host.nat is None:
            return False
        return self._seen_endpoint_dependent

    # ---------------------------------------------------------------- listen
    def _listen(self) -> Generator:
        while True:
            pkt = yield from self.sock.recv()
            kind = pkt.payload[0]
            if kind == "syn":
                _, req, name = pkt.payload
                self.observed_of[name] = pkt.src
                # synack echoes the dialer's externally observed address
                self.sock.sendto(pkt.src, ("synack", req, self.host.name, pkt.src), 96)
            elif kind == "synack":
                # every synack tells us our current external mapping — keep
                # the address book fresh (NAT keepalive / STUN-style)
                self._observe(tuple(pkt.payload[3]))
                ev = self._pending.pop(("synack", pkt.payload[1]), None)
                if ev is not None and not ev.triggered:
                    ev.succeed(pkt)
            elif kind == "punch":
                nonce = pkt.payload[1]
                self.sock.sendto(pkt.src, ("punch_ack", nonce), 64)
                ev = self._pending.get(("punch", nonce))
                if ev is not None and not ev.triggered:
                    ev.succeed(pkt)
            elif kind == "punch_ack":
                ev = self._pending.get(("punch", pkt.payload[1]))
                if ev is not None and not ev.triggered:
                    ev.succeed(pkt)
            elif kind == "probe":
                # AutoNAT dial-back probe: just prove reachability.
                self.sock.sendto(pkt.src, ("probe_ack", pkt.payload[1]), 64)

    # ------------------------------------------------------------- direct dial
    def dial_direct(self, addr: Addr, timeout: float = DIAL_TIMEOUT) -> Generator:
        """TCP/QUIC-style dial: SYN → SYNACK (proves reachability), then a
        Noise handshake round-trip.  Returns a secured Connection."""
        req = next(_req_seq)
        ev = self.sim.event()
        self._pending[("synack", req)] = ev
        try:
            got = None
            for _ in range(2):  # one retransmit for lossy paths
                self.sock.sendto(addr, ("syn", req, self.host.name), 80)
                idx, val = yield self.sim.any_of([ev, self.sim.timeout(timeout / 2)])
                if idx == 0:
                    got = val
                    break
            if got is None:
                self.stats["dials_direct_fail"] += 1
                raise DialError(f"dial to {addr} timed out")
        finally:
            self._pending.pop(("synack", req), None)
        _, _, peer_name, my_observed = got.payload
        self._observe(tuple(my_observed))
        peer_host = self.net.hosts[peer_name]
        # Noise XX: one extra round trip + CPU on both sides.
        lat, _, _ = self.net.path(self.host, peer_host)
        yield self.host.cpu.consume(HANDSHAKE_CPU)
        yield peer_host.cpu.consume(HANDSHAKE_CPU)
        yield self.sim.timeout(2 * lat)
        self.stats["dials_direct_ok"] += 1
        return self.net.establish(self.host, peer_host)

    # ------------------------------------------------------------------- ping
    def _ping_handler(self, stream: Stream) -> Generator:
        # single-shot: ping() opens a fresh stream per probe, so serve one
        # exchange and close (a parked while-True handler would hold the
        # server endpoint open long after the client closed its side)
        try:
            msg = yield from stream.recv(timeout=30.0)
            stream.send(("pong", msg[1]), 64)
        except DialError:
            pass
        finally:
            stream.close()

    def ping(self, conn: Connection) -> Generator:
        """Returns measured RTT over the connection."""
        t0 = self.sim.now
        stream = conn.open_stream(PROTO_PING, self.host)
        yield from stream_request(stream, ("ping", t0), 64, timeout=10.0)
        return self.sim.now - t0

    # --------------------------------------------------------- NAT fingerprint
    def nat_fingerprint(self, via: Addr) -> Generator:
        """Learn our NAT's port-allocation behaviour by opening three fresh
        sockets toward ``via`` (a public echo endpoint — in practice the
        relay we already hold a connection to).

        Each socket mints a new external mapping; the deltas between the
        consecutively observed ports reveal the allocator: two equal small
        deltas ⇒ predictable stride, anything else ⇒ random/unpredictable.
        Returns ``{"ip", "base", "stride", "dependent"}`` or ``None`` when
        the probe could not complete.  ``base`` is the *latest* allocated
        port, so the next mapping our NAT mints lands near
        ``base + stride`` — which is why this is never cached: punching a
        candidate list mints new mappings, and a stale base would put the
        peer's whole spray window below the allocator's next port.
        """
        ports: List[int] = []
        ip: Optional[str] = None
        for _ in range(3):
            sock = self.host.bind()
            req = next(_req_seq)
            try:
                observed = None
                for _retry in range(2):
                    sock.sendto(via, ("syn", req, self.host.name), 80)
                    try:
                        pkt = yield from sock.recv(timeout=0.4)
                    except DialError:
                        continue
                    if pkt.payload[0] == "synack" and pkt.payload[1] == req:
                        observed = tuple(pkt.payload[3])
                        break
                if observed is None:
                    return None
                ip, port = observed
                ports.append(port)
            finally:
                sock.close()
        self.stats["fingerprint_probes"] += 1
        d1, d2 = ports[1] - ports[0], ports[2] - ports[1]
        stride = d1 if (d1 == d2 and 0 < d1 <= MAX_PREDICTABLE_STRIDE) else None
        return {"ip": ip, "base": ports[-1], "stride": stride,
                "dependent": self.endpoint_dependent()}

    @staticmethod
    def predicted_ports(fp: Optional[Dict[str, object]]) -> List[Addr]:
        """Spray window for a peer whose NAT fingerprint is predictable."""
        if not fp or not fp.get("dependent") or not fp.get("stride"):
            return []
        base, stride, ip = int(fp["base"]), int(fp["stride"]), str(fp["ip"])
        return [(ip, base + stride * k) for k in range(1, PREDICT_WINDOW + 1)]

    # ------------------------------------------------------------ hole punch
    def _punch(self, targets: List[Addr], nonce: int,
               n_advertised: Optional[int] = None) -> Generator:
        """Spray punch datagrams at every target each round, with backoff
        between rounds; succeed when any punch/punch_ack arrives.

        ``n_advertised`` marks how many leading targets are advertised
        candidates (the rest are predicted ports) so success accounting can
        attribute predicted punches.
        """
        key = ("punch", nonce)
        ev = self._pending.get(key)
        if ev is None or ev.triggered:
            ev = self.sim.event()
            self._pending[key] = ev
        ok = False
        interval = PUNCH_INTERVAL
        for _ in range(PUNCH_TRIES):
            for t in targets:
                self.sock.sendto(t, ("punch", nonce), 64)
            idx, _ = yield self.sim.any_of([ev, self.sim.timeout(interval)])
            if idx == 0:
                ok = True
                break
            interval *= PUNCH_BACKOFF
        if not ok and ev.triggered:
            ok = True
        self._pending.pop(key, None)
        if ok and n_advertised is not None and len(targets) > n_advertised:
            # cannot tell *which* datagram landed; attribute to prediction
            # only when a spray window was in play at all
            self.stats["predicted_punch_ok"] += 1
        return ok

    def _punch_plan(self, remote_addrs: List[Addr],
                    remote_fp: Optional[Dict[str, object]]) -> Tuple[List[Addr], int]:
        cands = [tuple(a) for a in remote_addrs]
        predicted = [p for p in self.predicted_ports(remote_fp)
                     if p not in cands]
        return cands + predicted, len(cands)

    def _own_fingerprint_for_dcutr(self, relay: Optional[Host]) -> Generator:
        """Fingerprint to advertise in a DCUtR exchange: only meaningful when
        we are behind an endpoint-dependent NAT and a relay is reachable."""
        if relay is None or self.host.nat is None or not self.endpoint_dependent():
            return None
        fp = yield from self.nat_fingerprint((relay.ip, MAIN_PORT))
        return fp

    def _dcutr_handler(self, stream: Stream) -> Generator:
        """Responder side of Direct Connection Upgrade through Relay (v2)."""
        try:
            msg = yield from stream.recv(timeout=10.0)
            _, initiator_addrs, initiator_fp, nonce = msg
            yield from self._freshen_for_punch(stream.conn.relay)
            my_fp = yield from self._own_fingerprint_for_dcutr(stream.conn.relay)
            my_addrs = self.candidate_addrs()
            stream.send(("connect", my_addrs, my_fp, nonce), 160)
            yield from stream.recv(timeout=10.0)        # sync
            # pre-arm the punch waiter so an early-arriving punch isn't lost
            key = ("punch", nonce)
            if key not in self._pending or self._pending[key].triggered:
                self._pending[key] = self.sim.event()
            targets, n_adv = self._punch_plan(initiator_addrs, initiator_fp)
            yield from self._punch(targets, nonce, n_advertised=n_adv)
        except DialError:
            return
        finally:
            stream.close()

    def dcutr_upgrade(self, relayed_conn: Connection) -> Generator:
        """Initiator: attempt to upgrade a relayed connection to direct.

        Returns a direct Connection on success, None on failure (keep relay).
        """
        peer_host = relayed_conn.hosts[1] if relayed_conn.hosts[0] is self.host \
            else relayed_conn.hosts[0]
        nonce = next(_req_seq) * 7919
        try:
            yield from self._freshen_for_punch(relayed_conn.relay)
            my_fp = yield from self._own_fingerprint_for_dcutr(relayed_conn.relay)
            my_addrs = self.candidate_addrs()
            stream = relayed_conn.open_stream(PROTO_DCUTR, self.host)
            t0 = self.sim.now
            # pre-arm punch waiter before telling the peer the nonce
            self._pending[("punch", nonce)] = self.sim.event()
            stream.send(("connect", my_addrs, my_fp, nonce), 160)
            try:
                msg = yield from stream.recv(timeout=10.0)
                rtt = self.sim.now - t0
                _, remote_addrs, remote_fp, _ = msg
                stream.send(("sync",), 64)
            finally:
                stream.close()
            yield self.sim.timeout(rtt / 2)
            targets, n_adv = self._punch_plan(remote_addrs, remote_fp)
            ok = yield from self._punch(targets, nonce, n_advertised=n_adv)
        except DialError:
            self.stats["punch_fail"] += 1
            return None
        if not ok:
            self.stats["punch_fail"] += 1
            return None
        self.stats["punch_ok"] += 1
        # Reachability proven both ways; secure + establish the direct path.
        yield self.host.cpu.consume(HANDSHAKE_CPU)
        yield peer_host.cpu.consume(HANDSHAKE_CPU)
        lat, _, _ = self.net.path(self.host, peer_host)
        yield self.sim.timeout(2 * lat)
        return self.net.establish(self.host, peer_host)

    # ---------------------------------------------------------------- AutoNAT
    def probe_addr(self, addr: Addr, timeout: float = 0.3) -> Generator:
        """Dial-back probe from an *ephemeral* port (so cone-NAT filters
        aren't satisfied by the client's own earlier traffic to us)."""
        sock = self.host.bind()
        req = next(_req_seq)
        try:
            ok = False
            for _ in range(2):
                sock.sendto(addr, ("probe", req), 64)
                try:
                    pkt = yield from sock.recv(timeout=timeout)
                except DialError:
                    continue
                if pkt.payload[0] == "probe_ack" and pkt.payload[1] == req:
                    ok = True
                    break
            return ok
        finally:
            sock.close()

    def _autonat_fwd_handler(self, stream: Stream) -> Generator:
        """Second-hop prober: dial back an address on another server's behalf."""
        try:
            msg = yield from stream.recv(timeout=10.0)
            ok = yield from self.probe_addr(tuple(msg[1]))
            stream.send(("dialback", ok), 64)
        except DialError:
            return
        finally:
            stream.close()

    def _autonat_handler(self, stream: Stream) -> Generator:
        """Serve dial-back probes.  Prefer forwarding to a public neighbor the
        client has NOT contacted — a dial-back from a fresh (ip, port) is the
        only sound reachability witness against cone NATs."""
        try:
            msg = yield from stream.recv(timeout=10.0)
        except DialError:
            stream.close()
            return
        _, addr = msg
        client_host = stream.conn.hosts[0] if stream.conn.hosts[1] is self.host \
            else stream.conn.hosts[1]
        helper_conn = None
        for name, conns in self.host._connections.items():
            neighbor = self.net.hosts.get(name)
            if (neighbor is None or neighbor is client_host
                    or neighbor.nat is not None):
                continue
            live = [c for c in conns if not c.closed and not c.relayed]
            if live:
                helper_conn = live[0]
                break
        if helper_conn is not None:
            fwd = helper_conn.open_stream(PROTO_AUTONAT_FWD, self.host)
            try:
                resp = yield from stream_request(fwd, ("probe", addr), 96,
                                                 timeout=5.0)
                ok = bool(resp[1])
            except DialError:
                ok = False
        else:
            ok = yield from self.probe_addr(tuple(addr))
        stream.send(("dialback", ok), 64)
        stream.close()

    def autonat_probe(self, helper_conn: Connection) -> Generator:
        """Ask a connected public peer to dial back our observed addresses.

        Tries candidates in recency order until one succeeds — a single
        stale (e.g. lexically-smallest) observed address must not
        misclassify a reachable host as private."""
        if not self.observed_addrs:
            self.reachability = "private" if self.host.nat else "public"
            return self.reachability
        ok = False
        for addr in self.candidate_addrs()[:AUTONAT_MAX_PROBES]:
            stream = helper_conn.open_stream(PROTO_AUTONAT, self.host)
            try:
                msg = yield from stream_request(stream, ("probe", addr), 96,
                                                timeout=5.0)
                ok = bool(msg[1])
            except DialError:
                ok = False
            if ok:
                break
        self.reachability = "public" if ok else "private"
        return self.reachability

    # ------------------------------------------------------------------ relay
    def enable_relay(self, ttl: float = RELAY_RESERVATION_TTL,
                     capacity: int = RELAY_MAX_RESERVATIONS) -> None:
        """Make this (public) host a circuit relay."""
        self.is_relay = True
        self.relay_ttl = ttl
        self.relay_capacity = capacity
        self.host.handle(PROTO_RELAY_RESERVE, self._relay_reserve_handler)
        self.host.handle(PROTO_RELAY_CONNECT, self._relay_connect_handler)

    def _prune_reservations(self) -> None:
        now = self.sim.now
        expired = [d for d, r in self.relay_reservations.items()
                   if r.expires_at <= now]
        for d in expired:
            del self.relay_reservations[d]
            self.relay_stats["expired"] += 1

    def _live_reservation_count(self) -> int:
        """simsan gauge: unexpired relay reservations held on this host."""
        self._prune_reservations()
        return len(self.relay_reservations)

    def _peer_host_of(self, stream: Stream) -> Host:
        """The host on the far side of a stream's (authenticated) connection
        — never trust a host name claimed inside the message payload."""
        a, b = stream.conn.hosts
        return a if b is self.host else b

    def _relay_reserve_handler(self, stream: Stream) -> Generator:
        try:
            yield from self._relay_reserve_inner(stream)
        finally:
            stream.close()

    def _relay_reserve_inner(self, stream: Stream) -> Generator:
        try:
            msg = yield from stream.recv(timeout=10.0)
        except DialError:
            return
        _, peer_digest, _claimed_name = msg
        # Bind the reservation to the connection's actual peer: the secured
        # channel is what proves identity (stand-in for Noise binding the
        # PeerId's pubkey), so a claimed digest must match it — otherwise
        # any peer could squat another's slot and capture its circuits.
        client = self._peer_host_of(stream)
        if PeerId.from_name(client.name).digest != peer_digest:
            self.relay_stats["rejected_foreign"] += 1
            stream.send(("reserved", False, 0.0), 64)
            return
        now = self.sim.now
        self._prune_reservations()
        existing = self.relay_reservations.get(peer_digest)
        if existing is None:
            if len(self.relay_reservations) >= self.relay_capacity:
                self.relay_stats["rejected_capacity"] += 1
                stream.send(("reserved", False, 0.0), 64)
                return
            self.relay_reservations[peer_digest] = RelayReservation(
                host=client, host_name=client.name,
                created_at=now, expires_at=now + self.relay_ttl)
            self.relay_stats["reserved"] += 1
        else:
            existing.expires_at = now + self.relay_ttl
            existing.refreshes += 1
            self.relay_stats["refreshed"] += 1
        stream.send(("reserved", True, self.relay_ttl), 64)

    def _relay_connect_handler(self, stream: Stream) -> Generator:
        try:
            yield from self._relay_connect_inner(stream)
        finally:
            stream.close()

    def _relay_connect_inner(self, stream: Stream) -> Generator:
        try:
            msg = yield from stream.recv(timeout=10.0)
        except DialError:
            return
        _, target_digest, _claimed_src = msg
        self._prune_reservations()
        res = self.relay_reservations.get(target_digest)
        # the circuit's source is whoever actually opened this stream
        src_host = self._peer_host_of(stream)
        if res is None:
            stream.send(("error", "no reservation"), 64)
            return
        target = res.host
        conn_to_target = self.host.connection_to(target)
        if conn_to_target is None:
            # the reserved peer is gone — evict its slot immediately
            del self.relay_reservations[target_digest]
            self.relay_stats["dropped_lost_target"] += 1
            stream.send(("error", "relay lost target"), 64)
            return
        # Notify the target so it can account for the incoming circuit.
        stop = conn_to_target.open_stream(PROTO_RELAY_STOP, self.host)
        try:
            yield from stream_request(stop, ("incoming", src_host.name), 96,
                                      timeout=5.0)
        except DialError:
            stream.send(("error", "target rejected"), 64)
            return
        circuit = self.net.establish(src_host, target, relayed=True, relay=self.host)
        stream.send(("ok", circuit), 128)

    def relay_reserve(self, relay_conn: Connection) -> Generator:
        """Client: reserve (or refresh) a slot on a relay.

        Returns ``(ok, ttl)`` — the relay's TTL bounds when the client must
        refresh to keep inbound reachability."""
        self.host.handle(PROTO_RELAY_STOP, self._relay_stop_handler)
        stream = relay_conn.open_stream(PROTO_RELAY_RESERVE, self.host)
        msg = yield from stream_request(
            stream, ("reserve", self.peer_id.digest, self.host.name), 96,
            timeout=5.0)
        return bool(msg[1]), float(msg[2])

    def _relay_stop_handler(self, stream: Stream) -> Generator:
        try:
            yield from stream.recv(timeout=10.0)
            stream.send(("ok",), 64)
        except DialError:
            return
        finally:
            stream.close()

    def relay_connect(self, relay_conn: Connection, target: PeerId) -> Generator:
        """Client: open a circuit to ``target`` through a connected relay."""
        stream = relay_conn.open_stream(PROTO_RELAY_CONNECT, self.host)
        msg = yield from stream_request(
            stream, ("connect", target.digest, self.host.name), 96,
            timeout=10.0)
        if msg[0] != "ok":
            raise DialError(f"relay circuit failed: {msg[1]}")
        self.stats["relayed"] += 1
        return msg[1]
