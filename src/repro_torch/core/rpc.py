"""Dual-plane RPC over Lattica streams (the paper's §2 RPC subsystem).

The port's own copy of the JAX package's ``core/rpc.py``: the same code
under the port's import paths.

* **Unary plane** — request/response for control operations (health probes,
  shard placement, DHT queries, model-version lookups).  One stream per call,
  idempotent, cheap to retry.
* **Streaming plane** — long-lived, multiplexed, credit-based backpressured
  channels for tensor traffic.  Writers block when the receiver's byte-credit
  window is exhausted; receivers grant window updates as they drain, i.e.
  reactive-streams semantics over the simulated wire.

Handlers are generator functions so they can do real simulated work
(CPU, nested RPC, block fetches) while serving.
"""

from __future__ import annotations

import itertools
from collections import deque
from typing import Any, Callable, Dict, Generator, Optional, Tuple

from .simnet import Connection, DialError, Event, Host, Sim, Stream

PROTO_UNARY = "/lattica/rpc/1.0"
PROTO_STREAM = "/lattica/rpc-stream/1.0"

INIT_CREDIT = 1 << 20           # 1 MiB receive window per channel
CREDIT_GRANT_THRESHOLD = INIT_CREDIT // 2
CONTROL_MSG_SIZE = 64

UnaryHandler = Callable[[Any, "RpcContext"], Generator]       # -> (resp, size)
StreamHandler = Callable[["RpcChannel", "RpcContext"], Generator]


class RpcError(Exception):
    pass


class RpcContext:
    def __init__(self, host: Host, remote_host: Host):
        self.host = host
        self.remote_host = remote_host

    def cpu(self, seconds: float) -> Event:
        return self.host.cpu.consume(seconds)


class RpcRouter:
    """Per-node method registry; attach to a host to serve RPCs."""

    def __init__(self, host: Host):
        self.host = host
        self.sim: Sim = host.net.sim
        self.unary: Dict[str, UnaryHandler] = {}
        self.streaming: Dict[str, StreamHandler] = {}
        self.stats = {"unary_served": 0, "stream_served": 0, "errors": 0}
        host.handle(PROTO_UNARY, self._serve_unary)
        host.handle(PROTO_STREAM, self._serve_stream)

    def register_unary(self, method: str, handler: UnaryHandler) -> None:
        self.unary[method] = handler

    def register_streaming(self, method: str, handler: StreamHandler) -> None:
        self.streaming[method] = handler

    # -- server side ---------------------------------------------------------
    def _serve_unary(self, stream: Stream) -> Generator:
        # close our endpoint on every exit path: the client closes its side
        # after the response, and leaving ours open is a stream leak the
        # simsan audit flags (half-open pair on a live connection).
        try:
            try:
                method, payload, remote_name = yield from stream.recv(timeout=60.0)
            except DialError:
                return
            handler = self.unary.get(method)
            ctx = RpcContext(self.host, self.host.net.hosts[remote_name])
            if handler is None:
                self.stats["errors"] += 1
                stream.send(("err", f"no such method {method}"), CONTROL_MSG_SIZE)
                return
            try:
                resp, size = yield from handler(payload, ctx)
                self.stats["unary_served"] += 1
                stream.send(("ok", resp), max(size, CONTROL_MSG_SIZE))
            except Exception as exc:  # noqa: BLE001 — surfaced to the caller
                self.stats["errors"] += 1
                try:
                    stream.send(("err", repr(exc)), CONTROL_MSG_SIZE)
                except DialError:
                    pass
        finally:
            stream.close()

    def _serve_stream(self, stream: Stream) -> Generator:
        try:
            method, remote_name = yield from stream.recv(timeout=60.0)
        except DialError:
            stream.close()
            return
        handler = self.streaming.get(method)
        if handler is None:
            stream.send(("err", f"no such stream method {method}"), CONTROL_MSG_SIZE)
            stream.close()
            return
        stream.send(("hello",), CONTROL_MSG_SIZE)
        chan = RpcChannel(stream, self.sim)
        ctx = RpcContext(self.host, self.host.net.hosts[remote_name])
        self.stats["stream_served"] += 1
        try:
            yield from handler(chan, ctx)
        finally:
            # idempotent if the handler already ended the channel; otherwise
            # this is the server-side half-close that keeps streams balanced.
            chan.end()


# -- client side --------------------------------------------------------------


def call_unary(host: Host, conn: Connection, method: str, payload: Any,
               size: int = 128, timeout: float = 60.0) -> Generator:
    """Unary call over an existing connection.  Raises RpcError on failure."""
    stream = conn.open_stream(PROTO_UNARY, host)
    stream.send((method, payload, host.name), max(size, CONTROL_MSG_SIZE))
    try:
        msg = yield from stream.recv(timeout=timeout)
    except DialError as e:
        raise RpcError(f"{method}: {e}") from e
    finally:
        stream.close()
    if msg[0] != "ok":
        raise RpcError(f"{method}: remote error: {msg[1]}")
    return msg[1]


def open_channel(host: Host, conn: Connection, method: str,
                 timeout: float = 30.0) -> Generator:
    """Open a backpressured streaming channel; returns RpcChannel."""
    stream = conn.open_stream(PROTO_STREAM, host)
    stream.send((method, host.name), CONTROL_MSG_SIZE)
    msg = yield from stream.recv(timeout=timeout)
    if msg[0] != "hello":
        raise RpcError(f"{method}: channel rejected: {msg}")
    return RpcChannel(stream, host.net.sim)


class RpcChannel:
    """Bidirectional message channel with byte-credit flow control.

    Both endpoints hold an ``RpcChannel`` around their end of the stream.
    ``send`` blocks (yields) when the peer's window is exhausted; the peer
    grants credit back as its application code consumes messages.
    """

    def __init__(self, stream: Stream, sim: Sim):
        self.stream = stream
        self.sim = sim
        self.send_credit = INIT_CREDIT
        self._credit_waiters: deque = deque()
        self._pending_grant = 0
        self._inbox: deque = deque()
        self._inbox_waiter: Optional[Event] = None
        self._remote_ended = False
        self.bytes_sent = 0
        self.bytes_received = 0
        self._pump = sim.process(self._pump_loop(), daemon=True)

    # -- receive pump: demultiplexes data vs credit frames -------------------
    def _pump_loop(self) -> Generator:
        while True:
            try:
                msg = yield from self.stream.recv()
            except DialError:
                self._remote_ended = True
                self._wake_inbox()
                for w in self._credit_waiters:
                    if not w.triggered:
                        w.succeed()
                return
            kind = msg[0]
            if kind == "data":
                self._inbox.append((msg[1], msg[2]))
                self._wake_inbox()
            elif kind == "credit":
                self.send_credit += msg[1]
                while self._credit_waiters and self.send_credit > 0:
                    w = self._credit_waiters.popleft()
                    if not w.triggered:
                        w.succeed()
            elif kind == "end":
                self._remote_ended = True
                self._wake_inbox()
                # A graceful end must also wake senders blocked on credit,
                # exactly like the DialError path: they re-check
                # _remote_ended and raise instead of hanging forever.
                for w in self._credit_waiters:
                    if not w.triggered:
                        w.succeed()
                return  # "end" is the peer's final frame; park the pump

    def _wake_inbox(self) -> None:
        if self._inbox_waiter is not None and not self._inbox_waiter.triggered:
            self._inbox_waiter.succeed()

    # -- api ------------------------------------------------------------------
    def send(self, payload: Any, size: int) -> Generator:
        """Send one message, honoring the receive window (may yield)."""
        while self.send_credit < size:
            if self._remote_ended:
                raise RpcError("channel closed by peer")
            waiter = self.sim.event()
            self._credit_waiters.append(waiter)
            yield waiter
        self.send_credit -= size
        self.bytes_sent += size
        self.stream.send(("data", payload, size), size)
        return None

    def recv(self, timeout: Optional[float] = None) -> Generator:
        """Receive one message; returns payload or raises RpcError at end."""
        while not self._inbox:
            if self._remote_ended:
                raise RpcError("channel ended")
            self._inbox_waiter = self.sim.event()
            if timeout is not None:
                idx, _ = yield self.sim.any_of(
                    [self._inbox_waiter, self.sim.timeout(timeout)])
                if idx == 1 and not self._inbox:
                    raise RpcError("channel recv timeout")
            else:
                yield self._inbox_waiter
        payload, size = self._inbox.popleft()
        self.bytes_received += size
        self._pending_grant += size
        if self._pending_grant >= CREDIT_GRANT_THRESHOLD:
            self.stream.send(("credit", self._pending_grant), CONTROL_MSG_SIZE)
            self._pending_grant = 0
        return payload

    def end(self) -> None:
        try:
            self.stream.send(("end",), CONTROL_MSG_SIZE)
        except DialError:
            pass
        self.stream.close()
