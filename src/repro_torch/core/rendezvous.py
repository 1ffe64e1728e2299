"""Rendezvous service: namespace registration for expedited peer discovery.

The port's own copy of the JAX package's ``core/rendezvous.py``: the same
code under the port's import paths.

The paper uses a rendezvous point to orchestrate NAT traversal and to
shortcut provider discovery before DHT records propagate.  Any public node
can serve the rendezvous RPCs; clients register under a namespace (e.g. a
model-fleet name) and discover other registrants.
"""

from __future__ import annotations

from typing import Any, Dict, Generator, List, Tuple, TYPE_CHECKING

from .dht import PeerInfo
from .rpc import RpcContext
from .service import Fixed, PEER_INFO_LIST, Service, unary

if TYPE_CHECKING:  # pragma: no cover
    from .node import LatticaNode

DEFAULT_TTL = 7200.0


class RendezvousService(Service):
    """Namespace registry: register under a fleet name, discover registrants.
    Both methods are idempotent (re-register just refreshes the TTL)."""

    name = "rdv"

    def __init__(self, server: "RendezvousServer"):
        self.server = server

    @unary("rdv.register", request=Fixed(128), response=Fixed(64),
           idempotent=True, timeout=15.0)
    def register(self, payload: Any, ctx: RpcContext) -> Generator:
        ns, info, ttl = payload
        self.server.registrations.setdefault(ns, {})[info.peer_id.digest] = (
            info, self.server.node.sim.now + ttl)
        yield ctx.cpu(3e-6)
        return True

    @unary("rdv.discover", request=Fixed(96), response=PEER_INFO_LIST,
           idempotent=True, timeout=15.0)
    def discover(self, payload: Any, ctx: RpcContext) -> Generator:
        ns = payload
        now = self.server.node.sim.now
        entries = self.server.registrations.get(ns, {})
        live = [i for i, (info, exp) in entries.items() if exp > now]
        yield ctx.cpu(3e-6)
        return [entries[k][0] for k in live]


class RendezvousServer:
    def __init__(self, node: "LatticaNode"):
        self.node = node
        self.registrations: Dict[str, Dict[bytes, Tuple[PeerInfo, float]]] = {}
        node.serve(RendezvousService(self))


def register(node: "LatticaNode", rdv: PeerInfo, namespace: str,
             ttl: float = DEFAULT_TTL) -> Generator:
    stub = node.stub(RendezvousService, rdv)
    ok = yield from stub.register((namespace, node.info(), ttl))
    return ok


def discover(node: "LatticaNode", rdv: PeerInfo, namespace: str) -> Generator:
    stub = node.stub(RendezvousService, rdv)
    infos = yield from stub.discover(namespace)
    for i in infos:
        node.remember(i)
    return infos
