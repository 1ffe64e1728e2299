"""Typed service layer over the dual-plane RPC router (the paper's §2 API).

The port's own copy of the JAX package's ``core/service.py``: the same code
under the port's import paths.

The raw plane (:mod:`repro.core.rpc`) moves framed messages; this module is
the declarative surface every in-tree protocol is defined against.  A
*service* is a class whose RPC methods are declared with :class:`MethodSpec`
metadata — wire name, plane (unary/streaming), request/response codecs,
idempotency, deadline and retry policy — so call sites stop hand-rolling
method-name strings, wire-size constants and ``repr(exc)`` error matching.

## Defining a service

Declare handler methods with the :func:`unary` / :func:`streaming`
decorators.  Handlers are simulation generators: ``yield ctx.cpu(...)`` to
model work, then ``return`` the response payload (the response codec computes
its wire size — no more ``return resp, 96``)::

    from repro.core.service import (Service, unary, streaming, pickled,
                                    Fixed, ServiceError, RpcStatus)

    class KvService(Service):
        name = "kv"

        def __init__(self):
            self.data = {}

        @unary("kv.get", request=Fixed(96), response=pickled(floor=64),
               idempotent=True, timeout=10.0)
        def get(self, key, ctx):
            yield ctx.cpu(2e-6)
            if key not in self.data:
                raise ServiceError(RpcStatus.NOT_FOUND, f"no key {key!r}")
            return self.data[key]

        @unary("kv.put", request=pickled(floor=96), response=Fixed(64),
               timeout=10.0)
        def put(self, payload, ctx):
            key, value = payload
            yield ctx.cpu(2e-6)
            self.data[key] = value
            return True

        @streaming("kv.scan")
        def scan(self, chan, ctx):
            for key, value in sorted(self.data.items()):
                yield from chan.send((key, value), 128)
            chan.end()

Serve it on a node, call it through a generated stub::

    server.serve(KvService())
    stub = client.stub(KvService, server.info())
    value = yield from stub.get("model/latest")     # typed unary call
    chan  = yield from stub.scan()                  # opens an RpcChannel

Stubs transparently reuse ``connect_info`` connections, enforce per-call
deadlines, retry *idempotent* unary calls with jittered backoff on
``UNAVAILABLE``/``DEADLINE_EXCEEDED``, and raise :class:`ServiceError`
carrying an :class:`RpcStatus` instead of stringly-typed failures.  Client
and server middleware is supported via interceptors; a built-in metrics
interceptor feeds per-method counters/latency into ``core/metrics.py``.

Multiple instances of one service (e.g. one pipeline shard per peer) are
disambiguated with ``scope``: wire names become ``"<name>.<scope>"`` on both
the serving and stub side.
"""

from __future__ import annotations

import enum
from collections import deque
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, Generator, Iterable, List, Optional,
                    Tuple)

from .rpc import (CONTROL_MSG_SIZE, RpcChannel, RpcContext, RpcError,
                  RpcRouter, call_unary, open_channel)
from .safepickle import wire_dumps
from .simnet import Connection, DialError, Host, Sim

__all__ = [
    "RpcStatus", "ServiceError", "Codec", "Fixed", "ByteLength", "pickled",
    "PeerInfoCodec", "PeerInfoListCodec", "DeclaredSizeCodec",
    "TensorDictCodec", "CodecFn", "CONTROL", "PEER_INFO", "PEER_INFO_LIST",
    "MethodSpec", "unary", "streaming", "Service", "serve_service", "Stub",
    "ClientCall", "MetricsClientInterceptor", "MetricsServerInterceptor",
    "RpcMetrics", "MethodStats", "stream_request",
]


# ---------------------------------------------------------------------------
# Status codes & typed errors
# ---------------------------------------------------------------------------


class RpcStatus(enum.Enum):
    """gRPC-style terminal status of an RPC."""

    OK = 0
    UNAVAILABLE = 1          # dial/transport failure, peer down — retryable
    NOT_FOUND = 2            # unknown method or missing resource
    DEADLINE_EXCEEDED = 3    # the per-call deadline elapsed
    INTERNAL = 4             # handler raised an unexpected exception

    @property
    def retryable(self) -> bool:
        return self in (RpcStatus.UNAVAILABLE, RpcStatus.DEADLINE_EXCEEDED)


class ServiceError(RpcError):
    """Typed RPC failure: carries an :class:`RpcStatus` plus detail text.

    Subclasses :class:`RpcError` so pre-existing ``except (DialError,
    RpcError)`` best-effort paths keep working unchanged.
    """

    def __init__(self, status: RpcStatus, detail: str = "", method: str = ""):
        super().__init__(f"{method or 'rpc'}: {status.name}: {detail}")
        self.status = status
        self.detail = detail
        self.method = method


# ---------------------------------------------------------------------------
# Codecs: simulated wire size from the payload
# ---------------------------------------------------------------------------


class Codec:
    """Computes the simulated wire size of a payload.

    The simulator charges bandwidth/CPU per byte, so the codec is what keeps
    call sites honest about payload size without hand-passed constants.
    """

    name = "codec"

    def size_of(self, payload: Any) -> int:  # pragma: no cover - interface
        raise NotImplementedError


class Fixed(Codec):
    """Constant wire size — control messages, digests, keys."""

    def __init__(self, size: int):
        self.name = f"fixed({size})"
        self.size = size

    def size_of(self, payload: Any) -> int:
        return self.size


class ByteLength(Codec):
    """``len(payload)`` for bytes-like payloads, with a framing floor."""

    def __init__(self, floor: int = CONTROL_MSG_SIZE):
        self.name = f"bytes(floor={floor})"
        self.floor = floor

    def size_of(self, payload: Any) -> int:
        return max(len(payload) if payload is not None else 0, self.floor)


class _Pickled(Codec):
    """Serialized-size codec for small structured payloads."""

    def __init__(self, floor: int = CONTROL_MSG_SIZE):
        self.name = f"pickled(floor={floor})"
        self.floor = floor

    def size_of(self, payload: Any) -> int:
        try:
            return max(len(wire_dumps(payload, protocol=4)), self.floor)
        except Exception:  # unpicklable sim object — fall back to the floor
            return self.floor


def pickled(floor: int = CONTROL_MSG_SIZE) -> Codec:
    return _Pickled(floor)


#: Wire size of one serialized PeerInfo record (kept equal to the historical
#: hand-tuned constant so calibrated benchmarks are unchanged).
PEER_INFO_WIRE = 96


class PeerInfoCodec(Codec):
    name = "peer_info"

    def size_of(self, payload: Any) -> int:
        return PEER_INFO_WIRE


class PeerInfoListCodec(Codec):
    name = "peer_info_list"

    def size_of(self, payload: Any) -> int:
        return PEER_INFO_WIRE * max(len(payload), 1)


class DeclaredSizeCodec(Codec):
    """Payload tuples whose last element declares the application size
    (pub/sub messages, where the simulated body is caller-declared)."""

    name = "declared"

    def size_of(self, payload: Any) -> int:
        return max(int(payload[-1]), CONTROL_MSG_SIZE)


class TensorDictCodec(Codec):
    """``{"x": ndarray}`` activation payloads: size = array nbytes."""

    name = "tensor_dict"

    def __init__(self, key: str = "x"):
        self.key = key

    def size_of(self, payload: Any) -> int:
        x = payload.get(self.key) if isinstance(payload, dict) else payload
        nbytes = getattr(x, "nbytes", None)
        return max(int(nbytes), CONTROL_MSG_SIZE) if nbytes else CONTROL_MSG_SIZE


class CodecFn(Codec):
    """Adapter for one-off size functions (tagged-union responses)."""

    def __init__(self, name: str, fn: Callable[[Any], int]):
        self.name = name
        self._fn = fn

    def size_of(self, payload: Any) -> int:
        return max(int(self._fn(payload)), CONTROL_MSG_SIZE)


CONTROL = Fixed(CONTROL_MSG_SIZE)
PEER_INFO = PeerInfoCodec()
PEER_INFO_LIST = PeerInfoListCodec()


# ---------------------------------------------------------------------------
# Method specs & service definition
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MethodSpec:
    """Declarative description of one RPC method."""

    name: str                          # wire name, e.g. "kad.find_node"
    kind: str = "unary"                # "unary" | "streaming"
    request: Codec = CONTROL
    response: Codec = CONTROL
    idempotent: bool = False
    timeout: float = 15.0              # per-attempt deadline (seconds)
    retries: int = 2                   # extra attempts (idempotent only)
    backoff: float = 0.05              # base for jittered exponential backoff


def unary(name: str, *, request: Codec = CONTROL, response: Codec = CONTROL,
          idempotent: bool = False, timeout: float = 15.0, retries: int = 2,
          backoff: float = 0.05) -> Callable:
    """Declare a unary handler ``def m(self, payload, ctx) -> resp``."""

    spec = MethodSpec(name=name, kind="unary", request=request,
                      response=response, idempotent=idempotent,
                      timeout=timeout, retries=retries, backoff=backoff)

    def deco(fn: Callable) -> Callable:
        fn.__rpc_spec__ = spec
        return fn

    return deco


def streaming(name: str, *, timeout: float = 30.0) -> Callable:
    """Declare a streaming handler ``def m(self, chan, ctx)``."""

    spec = MethodSpec(name=name, kind="streaming", timeout=timeout)

    def deco(fn: Callable) -> Callable:
        fn.__rpc_spec__ = spec
        return fn

    return deco


class Service:
    """Base class: collects decorated methods into a spec table."""

    #: short service name, used for diagnostics
    name = "svc"
    #: per-instance disambiguator; wire names become "<name>.<scope>"
    scope: Optional[str] = None

    @classmethod
    def rpc_specs(cls) -> Dict[str, MethodSpec]:
        """attr name -> MethodSpec, in definition order (MRO-resolved).
        Cached per class: hot paths build stubs per call."""
        cached = cls.__dict__.get("_rpc_specs_cache")
        if cached is not None:
            return cached
        specs: Dict[str, MethodSpec] = {}
        for klass in reversed(cls.__mro__):
            for attr, val in vars(klass).items():
                spec = getattr(val, "__rpc_spec__", None)
                if spec is not None:
                    specs[attr] = spec
        cls._rpc_specs_cache = specs
        return specs

    def wire_name(self, spec: MethodSpec) -> str:
        return spec.name if self.scope is None else f"{spec.name}.{self.scope}"


# ---------------------------------------------------------------------------
# Per-method metrics
# ---------------------------------------------------------------------------


class MethodStats:
    """Counters + bounded latency reservoir for one method."""

    __slots__ = ("calls", "errors", "latencies")

    def __init__(self, maxlen: Optional[int] = 512):
        self.calls = 0
        self.errors = 0
        self.latencies: deque = deque(maxlen=maxlen)

    def record(self, ok: bool, latency: float) -> None:
        self.calls += 1
        if not ok:
            self.errors += 1
        self.latencies.append(latency)

    def percentile(self, q: float) -> float:
        if not self.latencies:
            return 0.0
        ordered = sorted(self.latencies)
        idx = min(int(q * len(ordered)), len(ordered) - 1)
        return ordered[idx]


class RpcMetrics:
    """Per-node registry the metrics interceptors feed; read by
    ``core/metrics.py`` for the fleet dashboard."""

    def __init__(self):
        self.client: Dict[str, MethodStats] = {}
        self.server: Dict[str, MethodStats] = {}

    def _table(self, role: str) -> Dict[str, MethodStats]:
        return self.client if role == "client" else self.server

    def record(self, role: str, method: str, ok: bool, latency: float) -> None:
        table = self._table(role)
        stats = table.get(method)
        if stats is None:
            stats = table[method] = MethodStats()
        stats.record(ok, latency)


# ---------------------------------------------------------------------------
# Server side
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class HandlerInfo:
    service: Service
    attr: str
    wire: str
    spec: MethodSpec


class ServerInterceptor:
    """Server middleware; override :meth:`intercept`.

    ``proceed(payload, ctx)`` is a generator function running the rest of the
    chain (ultimately the handler).  Raise :class:`ServiceError` to fail the
    call with a typed status.
    """

    def intercept(self, info: HandlerInfo, payload: Any, ctx: RpcContext,
                  proceed: Callable) -> Generator:
        resp = yield from proceed(payload, ctx)
        return resp


class MetricsServerInterceptor(ServerInterceptor):
    def __init__(self, metrics: RpcMetrics, sim: Sim):
        self.metrics = metrics
        self.sim = sim

    def intercept(self, info: HandlerInfo, payload: Any, ctx: RpcContext,
                  proceed: Callable) -> Generator:
        t0 = self.sim.now
        try:
            resp = yield from proceed(payload, ctx)
        except BaseException:
            self.metrics.record("server", info.wire, False, self.sim.now - t0)
            raise
        self.metrics.record("server", info.wire, True, self.sim.now - t0)
        return resp


def _server_chain(info: HandlerInfo,
                  interceptors: Tuple[ServerInterceptor, ...]) -> Callable:
    handler = getattr(info.service, info.attr)

    def base(payload: Any, ctx: RpcContext) -> Generator:
        resp = yield from handler(payload, ctx)
        return resp

    chain = base
    for icpt in reversed(interceptors):
        def wrap(payload, ctx, _i=icpt, _next=chain):
            resp = yield from _i.intercept(info, payload, ctx, _next)
            return resp
        chain = wrap
    return chain


def _wrap_unary(info: HandlerInfo, chain: Callable,
                router: RpcRouter) -> Callable:
    """Adapt a service handler to the raw router plane: run the interceptor
    chain, map exceptions to in-band ``("e", status, detail)`` frames, and
    compute the response wire size from the codec."""

    def _count_error() -> None:
        # Failures travel in-band, so the router's success path runs next and
        # bumps unary_served; pre-compensate to keep the pre-refactor
        # semantics (errors = handler failures, unary_served = successes).
        router.stats["errors"] += 1
        router.stats["unary_served"] -= 1

    def router_handler(payload: Any, ctx: RpcContext) -> Generator:
        try:
            resp = yield from chain(payload, ctx)
        except ServiceError as exc:
            _count_error()
            return (("e", exc.status.value, exc.detail or str(exc)),
                    CONTROL_MSG_SIZE)
        except DialError:
            raise                      # transport died mid-call; nothing to send
        except Exception as exc:  # noqa: BLE001 — typed as INTERNAL for the caller
            _count_error()
            return ("e", RpcStatus.INTERNAL.value, repr(exc)), CONTROL_MSG_SIZE
        return ("r", resp), max(info.spec.response.size_of(resp),
                                CONTROL_MSG_SIZE)

    return router_handler


def _wrap_streaming(info: HandlerInfo, metrics: Optional[RpcMetrics]) -> Callable:
    handler = getattr(info.service, info.attr)

    def router_handler(chan: RpcChannel, ctx: RpcContext) -> Generator:
        if metrics is not None:
            metrics.record("server", info.wire, True, 0.0)
        yield from handler(chan, ctx)

    return router_handler


def serve_service(router: RpcRouter, service: Service,
                  interceptors: Iterable[ServerInterceptor] = (),
                  metrics: Optional[RpcMetrics] = None) -> Service:
    """Register every declared method of ``service`` with the router."""
    sim = router.sim
    chain_interceptors: Tuple[ServerInterceptor, ...] = tuple(interceptors)
    if metrics is not None:
        chain_interceptors = (MetricsServerInterceptor(metrics, sim),
                              ) + chain_interceptors
    for attr, spec in service.rpc_specs().items():
        info = HandlerInfo(service, attr, service.wire_name(spec), spec)
        if spec.kind == "unary":
            chain = _server_chain(info, chain_interceptors)
            router.register_unary(info.wire, _wrap_unary(info, chain, router))
        else:
            router.register_streaming(info.wire,
                                      _wrap_streaming(info, metrics))
    return service


# ---------------------------------------------------------------------------
# Client side: generated stubs
# ---------------------------------------------------------------------------


@dataclass
class ClientCall:
    """Mutable invocation record threaded through client interceptors."""

    wire: str
    spec: MethodSpec
    payload: Any
    timeout: float
    status: RpcStatus = RpcStatus.OK
    attempts: int = 0


class ClientInterceptor:
    """Client middleware; ``proceed(call)`` runs the rest of the chain."""

    def intercept(self, call: ClientCall, proceed: Callable) -> Generator:
        resp = yield from proceed(call)
        return resp


class MetricsClientInterceptor(ClientInterceptor):
    def __init__(self, metrics: RpcMetrics, sim: Sim):
        self.metrics = metrics
        self.sim = sim

    def intercept(self, call: ClientCall, proceed: Callable) -> Generator:
        t0 = self.sim.now
        try:
            resp = yield from proceed(call)
        except BaseException:
            self.metrics.record("client", call.wire, False, self.sim.now - t0)
            raise
        self.metrics.record("client", call.wire, True, self.sim.now - t0)
        return resp


class Stub:
    """Generated client for a service: one generator method per MethodSpec.

    Target is either a ``PeerInfo`` (connections acquired — and reused — via
    ``node.connect_info``) or an explicit ``Connection`` (``conn=...``), for
    callers sitting inside connection establishment itself.
    """

    def __init__(self, node: Any, service_cls: type, target: Any = None, *,
                 conn: Optional[Connection] = None,
                 scope: Optional[str] = None,
                 interceptors: Iterable[ClientInterceptor] = ()):
        if target is None and conn is None:
            raise ValueError("stub needs a PeerInfo target or conn=")
        self._node = node
        self._host: Host = node.host
        self._sim: Sim = node.sim
        self._target = target
        self._conn = conn
        self._scope = scope
        chain: Tuple[ClientInterceptor, ...] = tuple(interceptors)
        metrics = getattr(node, "rpc_metrics", None)
        if metrics is not None:
            chain = (MetricsClientInterceptor(metrics, self._sim),) + chain
        self._interceptors = chain
        # the interceptor chain only depends on the interceptor tuple
        # (per-call state travels in the ClientCall), so build it once
        self._chain = self._transport_call
        for icpt in reversed(chain):
            def wrap(c, _i=icpt, _next=self._chain):
                resp = yield from _i.intercept(c, _next)
                return resp
            self._chain = wrap
        effective_scope = scope if scope is not None else service_cls.scope
        for attr, spec in service_cls.rpc_specs().items():
            wire = (spec.name if effective_scope is None
                    else f"{spec.name}.{effective_scope}")
            setattr(self, attr, self._bind(wire, spec))

    # -- wiring --------------------------------------------------------------
    def _bind(self, wire: str, spec: MethodSpec) -> Callable:
        if spec.kind == "streaming":
            def open_method(timeout: Optional[float] = None) -> Generator:
                chan = yield from self._open(wire, spec,
                                             timeout or spec.timeout)
                return chan
            open_method.__name__ = wire
            return open_method

        def call_method(payload: Any = None, *,
                        timeout: Optional[float] = None) -> Generator:
            resp = yield from self._invoke(wire, spec, payload,
                                           timeout or spec.timeout)
            return resp
        call_method.__name__ = wire
        return call_method

    def _acquire(self) -> Generator:
        if self._conn is not None:
            if not self._conn.closed:
                return self._conn
            if self._target is None:
                # pinned-connection stub: nothing to re-dial against
                raise DialError("stub connection closed")
        conn = yield from self._node.connect_info(self._target)
        return conn

    # -- unary ---------------------------------------------------------------
    def _invoke(self, wire: str, spec: MethodSpec, payload: Any,
                timeout: float) -> Generator:
        call = ClientCall(wire=wire, spec=spec, payload=payload,
                          timeout=timeout)
        resp = yield from self._chain(call)
        return resp

    def _transport_call(self, call: ClientCall) -> Generator:
        spec = call.spec
        attempts = 1 + (spec.retries if spec.idempotent else 0)
        last: Optional[ServiceError] = None
        for attempt in range(attempts):
            call.attempts = attempt + 1
            if attempt:
                # jittered exponential backoff before each retry
                base = spec.backoff * (2 ** (attempt - 1))
                yield self._sim.timeout(base * (0.5 + self._sim.rng.random()))
            try:
                conn = yield from self._acquire()
            except DialError as exc:
                last = ServiceError(RpcStatus.UNAVAILABLE, str(exc),
                                    call.wire)
                continue
            try:
                resp = yield from self._attempt(conn, call)
                return resp
            except ServiceError as exc:
                last = exc
                if exc.status.retryable and attempt + 1 < attempts:
                    continue
                call.status = exc.status
                raise
        call.status = last.status if last else RpcStatus.UNAVAILABLE
        raise last or ServiceError(RpcStatus.UNAVAILABLE, "no attempt ran",
                                   call.wire)

    def _attempt(self, conn: Connection, call: ClientCall) -> Generator:
        spec = call.spec
        size = spec.request.size_of(call.payload)
        # Race the raw call against the deadline.  The inner rpc timeout is
        # kept far beyond ours so transport failures surface as DialError and
        # deadline expiry is decided here, in exactly one place.
        proc = self._sim.process(call_unary(
            self._host, conn, call.wire, call.payload, size=size,
            timeout=call.timeout * 2 + 60.0))
        try:
            idx, val = yield self._sim.any_of(
                [proc, self._sim.timeout(call.timeout)])
        except ServiceError:
            raise
        except RpcError as exc:
            # call_unary chains DialError causes; an uncaused RpcError is the
            # router's "no such method" err frame.
            if isinstance(exc.__cause__, DialError):
                raise ServiceError(RpcStatus.UNAVAILABLE, str(exc),
                                   call.wire) from exc
            raise ServiceError(RpcStatus.NOT_FOUND, str(exc),
                               call.wire) from exc
        except DialError as exc:
            raise ServiceError(RpcStatus.UNAVAILABLE, str(exc),
                               call.wire) from exc
        if idx == 1:
            raise ServiceError(RpcStatus.DEADLINE_EXCEEDED,
                               f"deadline {call.timeout}s elapsed", call.wire)
        return _unwrap(val, call.wire)

    # -- streaming -----------------------------------------------------------
    def _open(self, wire: str, spec: MethodSpec, timeout: float) -> Generator:
        try:
            conn = yield from self._acquire()
            chan = yield from open_channel(self._host, conn, wire,
                                           timeout=timeout)
        except ServiceError:
            raise
        except DialError as exc:
            raise ServiceError(RpcStatus.UNAVAILABLE, str(exc), wire) from exc
        except RpcError as exc:
            status = (RpcStatus.UNAVAILABLE
                      if isinstance(exc.__cause__, DialError)
                      else RpcStatus.NOT_FOUND)
            raise ServiceError(status, str(exc), wire) from exc
        metrics = getattr(self._node, "rpc_metrics", None)
        if metrics is not None:
            metrics.record("client", wire, True, 0.0)
        return chan


def _unwrap(envelope: Any, wire: str) -> Any:
    """Decode the service-plane response envelope into resp-or-raise."""
    if isinstance(envelope, tuple) and envelope and envelope[0] == "r":
        return envelope[1]
    if isinstance(envelope, tuple) and len(envelope) == 3 and envelope[0] == "e":
        try:
            status = RpcStatus(envelope[1])
        except ValueError:
            status = RpcStatus.INTERNAL
        raise ServiceError(status, str(envelope[2]), wire)
    raise ServiceError(RpcStatus.INTERNAL,
                       f"malformed response envelope: {envelope!r}", wire)


# ---------------------------------------------------------------------------
# Raw-stream control helper (pre-connection protocols)
# ---------------------------------------------------------------------------


def stream_request(stream: Any, payload: Any, size: int = CONTROL_MSG_SIZE,
                   timeout: float = 10.0, close: bool = True) -> Generator:
    """One request/response over a raw stream, for control exchanges that run
    *below* the typed RPC plane (relay signalling, AutoNAT dial-backs): the
    connection is still being established, so no router is reachable yet.
    Centralizes the send/recv/close boilerplate those paths hand-rolled."""
    stream.send(payload, size)
    try:
        msg = yield from stream.recv(timeout=timeout)
    finally:
        if close:
            stream.close()
    return msg
