"""Lattica core: decentralized cross-NAT communication substrate.

The port's own copies of the JAX package's ``core`` modules (Python,
numpy and hashlib only), exporting what ``repro.core`` exports, plus the
device helper and the restricted unpickler with its wire-name rule:

* :mod:`repro_torch.core.simnet` — deterministic discrete-event network
* :mod:`repro_torch.core.nat` / :mod:`repro_torch.core.traversal` — NAT
  models, dialer, AutoNAT, circuit relay, DCUtR hole punching
* :mod:`repro_torch.core.cid` / :mod:`repro_torch.core.blockstore` /
  :mod:`repro_torch.core.bitswap` — content addressing + block exchange
* :mod:`repro_torch.core.dht` — Kademlia discovery/provider records
* :mod:`repro_torch.core.crdt` — the decentralized replicated store
* :mod:`repro_torch.core.rpc` — dual-plane RPC (unary + streaming)
* :mod:`repro_torch.core.service` — the typed service layer
* :mod:`repro_torch.core.pubsub` / :mod:`repro_torch.core.rendezvous` —
  announcement paths
* :mod:`repro_torch.core.node` — ``LatticaNode``, the composed SDK surface
* :mod:`repro_torch.core.safepickle` — restricted unpickling; the port's
  classes travel under the JAX package's module names
"""

from .cid import (CHUNK_SIZE, CID, CODEC_DAG, CODEC_RAW, DAG, ChunkSpec,
                  ManifestEntry, build_dag, build_tree_dag, chunk,
                  dag_reachable, decode_manifest, decode_manifest_v2,
                  encode_manifest, encode_manifest_v2, manifest_children,
                  manifest_version, read_dag, reassemble)
from .crdt import (GCounter, LWWRegister, MVRegister, ORSet, PNCounter,
                   ReplicatedStore, decode_entry, encode_entry)
from .device import resolve_device
from .dht import KademliaDHT, KadService, PeerInfo, RoutingTable
from .nat import NATBox, NATKind, PortAlloc, aggregate_nat_stats, nat_label
from .node import (CrdtSyncService, CrdtSyncV2Service, IdentityService,
                   LatticaNode, crdt_ns)
from .peer import Multiaddr, PeerId
from .rpc import RpcChannel, RpcError, RpcRouter, call_unary, open_channel
from .safepickle import restricted_loads, wire_dumps
from .service import (ClientInterceptor, Codec, Fixed, MethodSpec,
                      RpcMetrics, RpcStatus, ServerInterceptor, Service,
                      ServiceError, Stub, pickled, streaming, unary)
from .simnet import (Connection, DialError, Event, Host, Network, Process,
                     Sim, SimError, Stream)

__all__ = [
    "CID", "DAG", "ChunkSpec", "ManifestEntry", "build_dag",
    "build_tree_dag", "chunk",
    "dag_reachable", "decode_manifest", "decode_manifest_v2",
    "encode_manifest", "encode_manifest_v2", "manifest_children",
    "manifest_version", "read_dag",
    "GCounter", "LWWRegister", "MVRegister", "ORSet", "PNCounter",
    "ReplicatedStore", "decode_entry", "encode_entry",
    "KademliaDHT", "KadService", "PeerInfo",
    "RoutingTable", "NATBox", "NATKind", "PortAlloc",
    "aggregate_nat_stats", "nat_label", "CrdtSyncService",
    "CrdtSyncV2Service", "crdt_ns",
    "IdentityService", "LatticaNode", "Multiaddr", "PeerId",
    "RpcChannel", "RpcError", "RpcRouter", "call_unary", "open_channel",
    "ClientInterceptor", "Codec", "Fixed", "MethodSpec", "RpcMetrics",
    "RpcStatus", "ServerInterceptor", "Service", "ServiceError", "Stub",
    "pickled", "streaming", "unary",
    "Connection", "DialError", "Host", "Network", "Sim", "Stream",
    # the port's own, beyond ``repro.core``'s list
    "CHUNK_SIZE", "CODEC_DAG", "CODEC_RAW", "reassemble", "Event",
    "Process", "SimError", "resolve_device", "restricted_loads",
    "wire_dumps",
]
