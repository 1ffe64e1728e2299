"""Deterministic discrete-event network simulator.

The port's own copy of the JAX package's ``core/simnet.py``: the same code
under the port's import paths.

This is the substrate every Lattica protocol in this repo actually runs on:
packets traverse NAT boxes, streams are bandwidth/latency/CPU constrained, and
all protocol logic (Kademlia, Bitswap, DCUtR, RPC, gossip) executes as
generator-based processes against this event loop.  Determinism: a single
seeded ``random.Random`` drives jitter/loss/choices, and the heap breaks ties
with a monotone sequence number.

Process framework (SimPy-like, minimal):
    * ``yield <float>``          sleep for that many seconds
    * ``yield Event``            wait until the event succeeds (or re-raises)
    * ``yield Process``          wait for a child process to finish
    * ``return value``           completes the process; parents receive value
"""

from __future__ import annotations

import hashlib
import heapq
import itertools
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Generator, List, Optional, Tuple

# --------------------------------------------------------------------------
# Core event loop
# --------------------------------------------------------------------------


class SimError(Exception):
    pass


class DialError(SimError):
    """Raised when a dial / traversal attempt fails."""


def _values_differ(a: Any, b: Any) -> bool:
    """Conservative inequality: identity first, then ``==`` where it yields a
    plain bool (ndarrays and other broadcasting types count as different)."""
    if a is b:
        return False
    try:
        return not bool(a == b)
    except Exception:
        return True


class Sanitizer:
    """simsan evidence collector for one :class:`Sim` run.

    Activated via ``Sim(sanitize=True)``; records an event-trace digest
    (every dispatched callback, in order), double-settled events, processes
    that never ran to completion, and — together with the
    ``register_leak_check`` hooks subsystems install on the :class:`Sim` —
    an end-of-run resource leak audit.
    """

    def __init__(self, sim: "Sim"):
        self.sim = sim
        self._hash = hashlib.sha256()
        self.events_traced = 0
        self.double_settles: List[Dict[str, Any]] = []
        self._processes: List[Tuple["Process", str, bool]] = []

    # -- event trace ---------------------------------------------------------
    def trace(self, t: float, fn: Callable) -> None:
        name = getattr(fn, "__qualname__", None) or type(fn).__name__
        self._hash.update(f"{t!r}|{name}\n".encode())
        self.events_traced += 1

    def digest(self) -> str:
        return self._hash.hexdigest()

    # -- double-settle -------------------------------------------------------
    def note_settle(self, evt: "Event", kind: str, value: Any) -> None:
        """Called on succeed()/fail() of an already-triggered event; records a
        violation when the second settle disagrees with the first."""
        first = "fail" if evt.failed else "succeed"
        if kind == first and not _values_differ(value, evt.value):
            return  # benign idempotent re-settle with the same outcome
        self.double_settles.append({
            "t": self.sim.now,
            "event": type(evt).__name__,
            "first": first,
            "second": kind,
            "first_value": repr(evt.value)[:120],
            "second_value": repr(value)[:120],
        })

    # -- orphaned processes --------------------------------------------------
    def note_process(self, proc: "Process", daemon: bool) -> None:
        gen = proc._gen
        label = getattr(gen, "__qualname__", None) or repr(gen)
        self._processes.append((proc, label, daemon))

    def orphans(self) -> List[str]:
        """Non-daemon processes that never ran to completion.  Daemon
        processes (service loops marked ``sim.process(gen, daemon=True)``)
        are expected to outlive the run and are exempt."""
        return [label for proc, label, daemon in self._processes
                if not daemon and not proc.triggered]


class Event:
    """One-shot event; processes can wait on it."""

    __slots__ = ("sim", "triggered", "failed", "value", "_waiters")

    def __init__(self, sim: "Sim"):
        self.sim = sim
        self.triggered = False
        self.failed = False
        self.value: Any = None
        self._waiters: List[Callable[["Event"], None]] = []

    def succeed(self, value: Any = None) -> "Event":
        if self.triggered:
            if self.sim._san is not None:
                self.sim._san.note_settle(self, "succeed", value)
            return self
        self.triggered = True
        self.value = value
        for w in self._waiters:
            self.sim._schedule(0.0, w, self)
        self._waiters.clear()
        return self

    def fail(self, exc: BaseException) -> "Event":
        if self.triggered:
            if self.sim._san is not None:
                self.sim._san.note_settle(self, "fail", exc)
            return self
        self.triggered = True
        self.failed = True
        self.value = exc
        for w in self._waiters:
            self.sim._schedule(0.0, w, self)
        self._waiters.clear()
        return self

    def _add_waiter(self, cb: Callable[["Event"], None]) -> None:
        if self.triggered:
            self.sim._schedule(0.0, cb, self)
        else:
            self._waiters.append(cb)


class Process(Event):
    """Drives a generator; completion is an Event carrying the return value."""

    __slots__ = ("_gen",)

    def __init__(self, sim: "Sim", gen: Generator):
        super().__init__(sim)
        self._gen = gen
        sim._schedule(0.0, self._resume, None)

    # -- stepping ----------------------------------------------------------
    def _resume(self, evt: Optional[Event]) -> None:
        if self.triggered:
            return
        try:
            if isinstance(evt, Event) and evt.failed:
                item = self._gen.throw(evt.value)
            else:
                item = self._gen.send(evt.value if isinstance(evt, Event) else evt)
        except StopIteration as stop:
            self.succeed(stop.value)
            return
        except BaseException as exc:  # noqa: BLE001 - propagate to waiters
            if self._waiters:
                self.fail(exc)
            else:
                self.fail(exc)
                # Unobserved failure: keep silent (protocol best-effort paths).
            return
        self._dispatch(item)

    def _dispatch(self, item: Any) -> None:
        if isinstance(item, Event):
            item._add_waiter(self._resume)
        elif isinstance(item, (int, float)):
            self.sim._schedule(float(item), self._resume, None)
        else:  # pragma: no cover - programming error
            raise TypeError(f"process yielded unsupported item {item!r}")


class Sim:
    def __init__(self, seed: int = 0, sanitize: bool = False,
                 perturb: Optional[int] = None):
        import random

        self.now: float = 0.0
        self.rng = random.Random(seed)
        self._heap: List[Tuple[float, Any, Callable, Any]] = []
        self._seq = itertools.count()
        #: simsan: ``sanitize=True`` records an event-trace digest, flags
        #: conflicting double-settles, and tracks processes for the orphan
        #: report.  ``perturb=<seed>`` additionally randomizes same-time
        #: tie-breaks (from a *separate* seeded Random, so ``rng`` draws are
        #: unchanged) to surface latent event-order dependence.
        self._san: Optional[Sanitizer] = Sanitizer(self) if sanitize else None
        self._perturb = (random.Random(f"simsan-perturb:{perturb}")
                         if perturb is not None else None)
        self._leak_checks: Dict[str, Callable[[], float]] = {}
        self._leak_baseline: Dict[str, float] = {}

    # -- scheduling --------------------------------------------------------
    def _schedule(self, delay: float, fn: Callable, arg: Any) -> None:
        if self._perturb is None:
            key: Any = next(self._seq)
        else:
            # Random primary key shuffles equal-time events; the sequence
            # number stays as a deterministic final tie-break.
            key = (self._perturb.random(), next(self._seq))
        heapq.heappush(self._heap, (self.now + delay, key, fn, arg))

    def event(self) -> Event:
        return Event(self)

    def timeout(self, delay: float, value: Any = None) -> Event:
        ev = Event(self)
        self._schedule(delay, lambda _: ev.succeed(value), None)
        return ev

    def process(self, gen: Generator, daemon: bool = False) -> Process:
        """Spawn a process.  ``daemon=True`` marks service loops expected to
        outlive the run (listeners, pumps, maintenance) so the simsan orphan
        detector does not report them."""
        proc = Process(self, gen)
        if self._san is not None:
            self._san.note_process(proc, daemon)
        return proc

    def any_of(self, events: List[Event]) -> Event:
        """Succeeds with (index, value) of the first event that fires."""
        out = Event(self)

        def make_cb(i: int):
            def cb(evt: Event) -> None:
                if out.triggered:
                    return
                if evt.failed:
                    out.fail(evt.value)
                else:
                    out.succeed((i, evt.value))

            return cb

        for i, e in enumerate(events):
            e._add_waiter(make_cb(i))
        return out

    def all_of(self, events: List[Event]) -> Event:
        out = Event(self)
        remaining = [len(events)]
        results: List[Any] = [None] * len(events)
        if not events:
            out.succeed([])
            return out

        def make_cb(i: int):
            def cb(evt: Event) -> None:
                if out.triggered:
                    return
                if evt.failed:
                    out.fail(evt.value)
                    return
                results[i] = evt.value
                remaining[0] -= 1
                if remaining[0] == 0:
                    out.succeed(results)

            return cb

        for i, e in enumerate(events):
            e._add_waiter(make_cb(i))
        return out

    # -- running -----------------------------------------------------------
    def run(self, until: Optional[float] = None) -> None:
        san = self._san
        while self._heap:
            t, _, fn, arg = self._heap[0]
            if until is not None and t > until:
                self.now = until
                return
            heapq.heappop(self._heap)
            self.now = t
            if san is not None:
                san.trace(t, fn)
            fn(arg)
        if until is not None:
            self.now = max(self.now, until)

    def run_process(self, gen: Generator, until: float = 1e9) -> Any:
        """Run the loop until ``gen`` completes; returns its value or raises."""
        proc = self.process(gen)
        san = self._san
        while self._heap and not proc.triggered:
            t, _, fn, arg = heapq.heappop(self._heap)
            if t > until:
                raise SimError(f"process did not complete before t={until}")
            self.now = t
            if san is not None:
                san.trace(t, fn)
            fn(arg)
        if not proc.triggered:
            raise SimError("deadlock: process blocked with empty event queue")
        if proc.failed:
            raise proc.value
        return proc.value

    # -- simsan surface ------------------------------------------------------
    def trace_digest(self) -> str:
        """sha256 over every dispatched ``(time, callback)`` so far.  Two runs
        of the same scenario under the same seed must agree bit-for-bit."""
        if self._san is None:
            raise SimError("trace_digest requires Sim(sanitize=True)")
        return self._san.digest()

    def register_leak_check(self, name: str, fn: Callable[[], float]) -> None:
        """Install a named resource gauge (count of currently-held resources).
        Subsystems register these at construction; the audit compares gauges
        against the baseline snapshot.  Re-registering a name replaces it."""
        self._leak_checks[name] = fn

    def leak_report(self) -> Dict[str, float]:
        return {name: fn() for name, fn in sorted(self._leak_checks.items())}

    def leak_baseline(self) -> Dict[str, float]:
        """Snapshot current gauges as the audit baseline (call after setup so
        long-lived resources — listen sockets, live relay reservations —
        don't read as leaks)."""
        self._leak_baseline = self.leak_report()
        return dict(self._leak_baseline)

    def leak_audit(self) -> Dict[str, float]:
        """Gauges that moved above the baseline: ``{name: excess}``.  Empty
        means every audited resource returned to baseline."""
        base = self._leak_baseline
        return {name: v - base.get(name, 0)
                for name, v in self.leak_report().items()
                if v - base.get(name, 0) != 0}

    def san_report(self) -> Dict[str, Any]:
        """Full simsan report: trace digest, double-settles, orphans, leaks."""
        if self._san is None:
            raise SimError("san_report requires Sim(sanitize=True)")
        return {
            "trace_digest": self._san.digest(),
            "events": self._san.events_traced,
            "double_settles": list(self._san.double_settles),
            "orphans": self._san.orphans(),
            "leaks": self.leak_audit(),
        }


# --------------------------------------------------------------------------
# Network model: regions, links, CPU
# --------------------------------------------------------------------------

#: One-way latency in seconds between region classes.  ``local`` means the
#: same physical host (loopback); keys are frozensets of region labels.
DEFAULT_LATENCY = {
    "loopback": 20e-6,
    "lan": 0.25e-3,
    "wan": 10e-3,
    "inter": 75e-3,
}

#: Link bandwidth in bytes/second for each scenario class.
DEFAULT_BANDWIDTH = {
    "loopback": 4.0e9,   # memory-speed loopback
    "lan": 1.25e9,       # 10 Gbps
    "wan": 1.5e8,        # ~1.2 Gbps shared WAN path
    "inter": 3.0e7,      # ~240 Mbps transcontinental path
}

#: Packet loss probability (datagrams only; streams are reliable).
DEFAULT_LOSS = {"loopback": 0.0, "lan": 0.0, "wan": 0.005, "inter": 0.02}


def scenario_for(a: "Host", b: "Host") -> str:
    if a is b or (a.machine is not None and a.machine == b.machine):
        return "loopback"
    if a.region == b.region:
        return "lan" if a.zone == b.zone else "wan"
    return "inter"


class CPU:
    """A small multi-core CPU model: work items serialize across cores."""

    def __init__(self, sim: Sim, cores: int = 4):
        self.sim = sim
        self.cores = [0.0] * cores

    def consume(self, seconds: float) -> Event:
        """Occupy the earliest-free core for ``seconds``; event fires at end."""
        i = min(range(len(self.cores)), key=lambda k: self.cores[k])
        start = max(self.sim.now, self.cores[i])
        finish = start + seconds
        self.cores[i] = finish
        return self.sim.timeout(finish - self.sim.now)


@dataclass
class Packet:
    src: Tuple[str, int]       # observed (ip, port) of the sender
    dst: Tuple[str, int]
    payload: Any
    size: int = 128


class Socket:
    """Datagram socket (UDP-like) used by the traversal machinery."""

    def __init__(self, host: "Host", port: int):
        self.host = host
        self.port = port
        self._inbox: deque = deque()
        self._waiter: Optional[Event] = None
        self.closed = False

    def sendto(self, dst: Tuple[str, int], payload: Any, size: int = 128) -> None:
        self.host.net.send_packet(self.host, self.port, dst, payload, size)

    def _deliver(self, pkt: Packet) -> None:
        if self.closed:
            return
        self._inbox.append(pkt)
        if self._waiter is not None and not self._waiter.triggered:
            self._waiter.succeed()

    def recv(self, timeout: Optional[float] = None) -> Generator:
        """Process helper: yields until a packet arrives (or raises DialError)."""
        while not self._inbox:
            self._waiter = self.host.net.sim.event()
            if timeout is not None:
                race = self.host.net.sim.any_of(
                    [self._waiter, self.host.net.sim.timeout(timeout)]
                )
                idx, _ = yield race
                if idx == 1 and not self._inbox:
                    raise DialError(f"recv timeout on {self.host.name}:{self.port}")
            else:
                yield self._waiter
        return self._inbox.popleft()

    def close(self) -> None:
        self.closed = True
        self.host._sockets.pop(self.port, None)


# --------------------------------------------------------------------------
# Streams & connections
# --------------------------------------------------------------------------


class Stream:
    """One half of a bidirectional protocol stream over a Connection."""

    def __init__(self, conn: "Connection", stream_id: int, protocol: str, initiator: bool):
        self.conn = conn
        self.stream_id = stream_id
        self.protocol = protocol
        self.initiator = initiator
        self._inbox: deque = deque()
        self._waiter: Optional[Event] = None
        self.closed = False
        self.reset = False

    # local endpoint index within the connection (0 or 1)
    @property
    def _side(self) -> int:
        return 0 if self.initiator else 1

    def send(self, payload: Any, size: int = 128) -> None:
        if self.closed or self.conn.closed:
            raise DialError("stream closed")
        self.conn._transmit(self._side, self.stream_id, payload, size)

    def recv(self, timeout: Optional[float] = None) -> Generator:
        sim = self.conn.net.sim
        while not self._inbox:
            if self.reset or self.conn.closed:
                raise DialError("stream reset by peer / connection closed")
            self._waiter = sim.event()
            if timeout is not None:
                idx, _ = yield sim.any_of([self._waiter, sim.timeout(timeout)])
                if idx == 1 and not self._inbox:
                    raise DialError(f"stream recv timeout ({self.protocol})")
            else:
                yield self._waiter
        return self._inbox.popleft()

    def _deliver(self, payload: Any) -> None:
        self._inbox.append(payload)
        if self._waiter is not None and not self._waiter.triggered:
            self._waiter.succeed()

    def close(self) -> None:
        self.closed = True

    def _do_reset(self) -> None:
        self.reset = True
        if self._waiter is not None and not self._waiter.triggered:
            self._waiter.succeed()


class Connection:
    """An established, secured, multiplexed connection between two hosts.

    Latency / bandwidth are fixed at establishment (possibly via a relay
    path).  Each direction serializes bytes at ``bandwidth``; each message
    additionally costs CPU time on both endpoints (serialization + crypto).
    """

    #: Calibrated to the paper's Table-1 testbed (4-core hosts): ~200 µs of
    #: core time per message (stream bookkeeping, protobuf, syscalls) plus
    #: ~17 ns/byte (Noise AEAD + copies ≈ 60 MB/s/core).  These two constants
    #: reproduce the CPU-bound rows of Table 1 (10k QPS @128 B, ~850 QPS
    #: @256 KB on one host); the WAN rows are bandwidth/latency-bound.
    CPU_PER_MSG = 200e-6          # fixed per-message CPU cost (seconds)
    CPU_PER_BYTE = 17e-9          # per-byte serialization+MAC cost

    def __init__(self, net: "Network", a: "Host", b: "Host",
                 latency: float, bandwidth: float, relayed: bool = False,
                 relay: Optional["Host"] = None):
        self.net = net
        self.hosts = (a, b)
        self.latency = latency
        self.bandwidth = bandwidth
        self.relayed = relayed
        self.relay = relay
        self.closed = False
        self._next_free = [0.0, 0.0]          # per-direction tx serialization
        self._stream_seq = itertools.count(1)
        self._streams: Dict[int, List[Optional[Stream]]] = {}
        a._connections.setdefault(b.name, []).append(self)
        b._connections.setdefault(a.name, []).append(self)

    # -- streams -----------------------------------------------------------
    def open_stream(self, protocol: str, opener: "Host") -> Stream:
        if self.closed:
            raise DialError("connection closed")
        side = self.hosts.index(opener)
        sid = next(self._stream_seq)
        local = Stream(self, sid, protocol, initiator=(side == 0))
        remote = Stream(self, sid, protocol, initiator=(side != 0))
        # store endpoints indexed by connection side
        pair: List[Optional[Stream]] = [None, None]
        pair[side] = local
        pair[1 - side] = remote
        self._streams[sid] = pair
        # hand the remote endpoint to the responder's protocol handler
        responder = self.hosts[1 - side]
        responder._spawn_handler(protocol, remote)
        return local

    # -- data movement -----------------------------------------------------
    def transmit(self, sender: Stream, payload: Any, size: int) -> None:
        pair = self._streams.get(sender.stream_id)
        if pair is None or self.closed:
            return
        side = pair.index(sender)
        receiver = pair[1 - side]
        src_host, dst_host = self.hosts[side], self.hosts[1 - side]
        sim = self.net.sim
        # CPU at the sender
        tx_cpu = self.CPU_PER_MSG + self.CPU_PER_BYTE * size
        cpu_done = src_host.cpu.consume(tx_cpu)

        def after_cpu(_evt: Event) -> None:
            # serialize on the wire
            start = max(sim.now, self._next_free[side])
            wire = size / self.bandwidth
            self._next_free[side] = start + wire
            arrive = start + wire + self.latency
            sim._schedule(arrive - sim.now, lambda _: at_dst(), None)

        def at_dst() -> None:
            if self.closed or receiver is None or receiver.closed:
                return
            rx_cpu = self.CPU_PER_MSG + self.CPU_PER_BYTE * size
            done = dst_host.cpu.consume(rx_cpu)
            done._add_waiter(lambda _e: receiver._deliver(payload))

        cpu_done._add_waiter(after_cpu)

    def close(self) -> None:
        self.closed = True
        for pair in self._streams.values():
            for s in pair:
                if s is not None:
                    s._do_reset()
        a, b = self.hosts
        if self in a._connections.get(b.name, []):
            a._connections[b.name].remove(self)
        if self in b._connections.get(a.name, []):
            b._connections[a.name].remove(self)


# Patch Stream.send to route via Connection.transmit with correct identity.
def _stream_send(self: Stream, payload: Any, size: int = 128) -> None:
    if self.closed or self.conn.closed:
        raise DialError("stream closed")
    self.conn.transmit(self, payload, size)


Stream.send = _stream_send  # type: ignore[method-assign]


# --------------------------------------------------------------------------
# Hosts & the network fabric
# --------------------------------------------------------------------------


class Host:
    """A machine: sockets, CPU, protocol handlers, connections."""

    _ip_seq = itertools.count(1)

    def __init__(self, net: "Network", name: str, region: str = "us",
                 zone: str = "a", nat: Optional[Any] = None, cores: int = 4,
                 machine: Optional[str] = None):
        self.net = net
        self.name = name
        self.region = region
        self.zone = zone              # same region+zone => LAN, else WAN
        self.machine = machine        # same machine => loopback path
        self.ip = f"10.0.{next(Host._ip_seq)}.1" if nat else f"203.0.{next(Host._ip_seq)}.1"
        self.nat = nat
        self.cpu = CPU(net.sim, cores)
        self._sockets: Dict[int, Socket] = {}
        self._port_seq = itertools.count(40000)
        self._handlers: Dict[str, Callable[[Stream], Generator]] = {}
        self._connections: Dict[str, List[Connection]] = {}
        net._register_host(self)
        if nat is not None:
            nat.attach(self)

    # -- addressing --------------------------------------------------------
    @property
    def public_ip(self) -> Optional[str]:
        if self.nat is None:
            return self.ip
        return None  # only reachable through the NAT's mapped ports

    def bind(self, port: Optional[int] = None) -> Socket:
        if port is None:
            port = next(self._port_seq)
        sock = Socket(self, port)
        self._sockets[port] = sock
        return sock

    # -- protocols ---------------------------------------------------------
    def handle(self, protocol: str, fn: Callable[[Stream], Generator]) -> None:
        self._handlers[protocol] = fn

    def _spawn_handler(self, protocol: str, stream: Stream) -> None:
        fn = self._handlers.get(protocol)
        if fn is None:
            stream._do_reset()
            return
        # daemon: inbound handlers are driven by the remote peer and may park
        # on recv() past the end of a scenario — not orphans.
        self.net.sim.process(fn(stream), daemon=True)

    def connection_to(self, other: "Host") -> Optional[Connection]:
        for c in self._connections.get(other.name, []):
            if not c.closed:
                return c
        return None


class Network:
    def __init__(self, sim: Sim,
                 latency: Optional[Dict[str, float]] = None,
                 bandwidth: Optional[Dict[str, float]] = None,
                 loss: Optional[Dict[str, float]] = None):
        self.sim = sim
        self.latency = dict(DEFAULT_LATENCY, **(latency or {}))
        self.bandwidth = dict(DEFAULT_BANDWIDTH, **(bandwidth or {}))
        self.loss = dict(DEFAULT_LOSS, **(loss or {}))
        self.hosts: Dict[str, Host] = {}
        self._by_ip: Dict[str, Any] = {}   # ip -> Host | NATBox
        self.nats: List[Any] = []          # every NATBox on this fabric
        self._partitions: set = set()     # frozenset({region_a, region_b})
        sim.register_leak_check("net.sockets", self._open_socket_count)
        sim.register_leak_check("net.half_open_streams",
                                self._half_open_stream_count)

    # -- simsan gauges -------------------------------------------------------
    def _open_socket_count(self) -> int:
        return sum(len(h._sockets) for h in self.hosts.values())

    def _half_open_stream_count(self) -> int:
        """Streams on live connections where exactly one endpoint closed —
        the signature of a handler or caller that forgot to close its side.
        (Both-open pairs are in-flight exchanges; both-closed are done.)"""
        n = 0
        seen: set = set()
        for h in self.hosts.values():
            for conns in h._connections.values():
                for c in conns:
                    if id(c) in seen or c.closed:
                        continue
                    seen.add(id(c))
                    for pair in c._streams.values():
                        open_ends = sum(
                            1 for s in pair
                            if s is not None and not s.closed and not s.reset)
                        if open_ends == 1:
                            n += 1
        return n

    # -- registry ----------------------------------------------------------
    def _register_host(self, host: Host) -> None:
        self.hosts[host.name] = host
        if host.nat is None:
            self._by_ip[host.ip] = host

    def register_nat(self, nat: Any) -> None:
        self._by_ip[nat.public_ip] = nat
        self.nats.append(nat)

    def nat_stats(self) -> Dict[str, Dict[str, int]]:
        """Per-NAT-kind aggregate of every box's traversal counters."""
        from .nat import aggregate_nat_stats
        return aggregate_nat_stats(self.nats)

    def host(self, name: str, **kw: Any) -> Host:
        return Host(self, name, **kw)

    # -- partitions ----------------------------------------------------------
    def set_partition(self, region_a: str, region_b: str,
                      blocked: bool = True) -> None:
        """Cut (or heal) the path between two regions.  Cutting also tears
        down existing cross-partition connections (links die, sessions
        reset) — the failure mode CRDT anti-entropy must survive."""
        key = frozenset((region_a, region_b))
        if blocked:
            self._partitions.add(key)
            for host in list(self.hosts.values()):
                if host.region not in (region_a, region_b):
                    continue
                other_region = region_b if host.region == region_a else region_a
                for name, conns in list(host._connections.items()):
                    peer = self.hosts.get(name)
                    if peer is not None and peer.region == other_region:
                        for c in list(conns):
                            c.close()
        else:
            self._partitions.discard(key)

    def partitioned(self, a: Host, b: Host) -> bool:
        return frozenset((a.region, b.region)) in self._partitions

    # -- path properties ----------------------------------------------------
    def path(self, a: Host, b: Host) -> Tuple[float, float, float]:
        sc = scenario_for(a, b)
        return self.latency[sc], self.bandwidth[sc], self.loss[sc]

    # -- datagrams (NAT-aware) ----------------------------------------------
    def send_packet(self, src_host: Host, src_port: int,
                    dst: Tuple[str, int], payload: Any, size: int = 128) -> None:
        # outbound NAT translation
        if src_host.nat is not None:
            observed = src_host.nat.map_outbound(src_host, src_port, dst)
        else:
            observed = (src_host.ip, src_port)
        target = self._by_ip.get(dst[0])
        if target is None:
            return  # black hole
        # resolve the receiving host (possibly through its NAT filter)
        if isinstance(target, Host):
            dst_host, dst_port = target, dst[1]
        else:  # NAT box
            routed = target.filter_inbound(dst[1], observed)
            if routed is None:
                return  # dropped by NAT
            dst_host, dst_port = routed
        if self.partitioned(src_host, dst_host):
            return  # black-holed across the partition
        lat, _bw, loss = self.path(src_host, dst_host)
        if loss and self.sim.rng.random() < loss:
            return
        jitter = self.sim.rng.random() * lat * 0.05
        pkt = Packet(src=observed, dst=dst, payload=payload, size=size)

        def deliver(_: Any) -> None:
            sock = dst_host._sockets.get(dst_port)
            if sock is not None:
                sock._deliver(pkt)

        self.sim._schedule(lat + jitter + size / self.bandwidth[scenario_for(src_host, dst_host)],
                           deliver, None)

    # -- connections ---------------------------------------------------------
    def establish(self, a: Host, b: Host, relayed: bool = False,
                  relay: Optional[Host] = None) -> Connection:
        """Create a secured connection (path properties from the region model).

        Reachability must have been proven by the caller (direct dial packets
        or a completed hole punch) — this just instantiates the channel.
        """
        if relayed and relay is not None:
            lat = self.path(a, relay)[0] + self.path(relay, b)[0]
            bw = min(self.path(a, relay)[1], self.path(relay, b)[1],
                     RELAY_BANDWIDTH_CAP)
        else:
            lat, bw, _ = self.path(a, b)
        return Connection(self, a, b, lat, bw, relayed=relayed, relay=relay)


#: Circuit relays are a shared, rate-limited resource (libp2p caps relayed
#: connections hard; we model a generous but finite cap).
RELAY_BANDWIDTH_CAP = 2.0e6  # 16 Mbit/s per relayed connection
