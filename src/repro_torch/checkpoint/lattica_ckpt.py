"""Checkpoints over Lattica: publish/fetch model versions through the mesh.

The port's own copy of the JAX package's ``checkpoint/lattica_ckpt.py``: the
same code under the port's import paths.

The paper's RL-pipeline scenario (Fig. 1-3): a training cluster publishes a
new model version as CID-addressed chunks; inference clusters discover it
(pubsub announcement or CRDT register) and swarm-fetch it via Bitswap.  The
CRDT store is the *model version registry*:

  * ``ckpt/<fleet>``            ORSet of (step, root-CID) — every version
  * ``ckpt/<fleet>/latest``     LWW register → (step, root-CID)
  * ``steps/<fleet>``           GCounter of total optimizer steps

Versions are *delta-friendly*: each pytree leaf is serialized as its own
sub-DAG under a hierarchical (v2) root manifest, so consecutive versions
share the sub-root CIDs of unchanged tensors and fetchers only move the
changed ones.  ``publish_checkpoint(base=...)`` reports new-vs-reused
block/byte stats in the announcement meta; fetchers pin the latest fetched
version per fleet (older ones become evictable under a blockstore budget).
"""

from __future__ import annotations

from typing import Any, Dict, Generator, List, Optional, Tuple

from repro_torch.core.bitswap import FetchError
from repro_torch.core.cid import (CID, CODEC_DAG, ChunkSpec, build_tree_dag,
                                  dag_reachable, decode_manifest_v2,
                                  encode_manifest_v2, manifest_version,
                                  read_dag)
from repro_torch.core.dht import PeerInfo
from repro_torch.core.node import LatticaNode
from repro_torch.core.rpc import RpcContext
from repro_torch.core.safepickle import restricted_loads, wire_dumps
from repro_torch.core.service import Fixed, Service, pickled, unary

from .serial import (leaf_from_part, params_from_bytes, params_from_parts,
                     params_to_parts)


class CheckpointRegistry:
    """Typed view over a node's CRDT store for one model fleet."""

    def __init__(self, node: LatticaNode, fleet: str):
        self.node = node
        self.fleet = fleet

    @property
    def topic(self) -> str:
        return f"{self.fleet}/models"

    def record(self, step: int, root: CID) -> None:
        """Publisher-side: new version + move the LWW 'latest' pointer."""
        name = self.node.host.name
        self.node.store.orset(f"ckpt/{self.fleet}").add(
            (step, root.codec, root.digest), name)
        self.node.store.register(f"ckpt/{self.fleet}/latest").set(
            (step, root.codec, root.digest), self.node.sim.now, name)

    def record_fetched(self, step: int, root: CID) -> None:
        """Subscriber-side: note a version we hold WITHOUT touching the LWW
        pointer — re-setting 'latest' with a fresh local timestamp would
        let an old version win over a newer one after a merge."""
        self.node.store.orset(f"ckpt/{self.fleet}").add(
            (step, root.codec, root.digest), self.node.host.name)

    def versions(self) -> List[Tuple[int, CID]]:
        raw = self.node.store.orset(f"ckpt/{self.fleet}").value()
        return sorted((s, CID(c, d)) for s, c, d in raw)

    def latest(self) -> Optional[Tuple[int, CID]]:
        val = self.node.store.register(f"ckpt/{self.fleet}/latest").value()
        if val is None:
            return None
        s, c, d = val
        return s, CID(c, d)


class CheckpointService(Service):
    """Remote view of a node's checkpoint registry: resolve a fleet's
    latest/known versions directly from one peer, without waiting for CRDT
    anti-entropy to converge first.  Read-only, hence idempotent."""

    name = "ckpt"

    def __init__(self, node: LatticaNode):
        self.node = node

    @unary("ckpt.latest", request=Fixed(64), response=pickled(floor=96),
           idempotent=True, timeout=15.0)
    def latest(self, fleet: Any, ctx: RpcContext) -> Generator:
        yield ctx.cpu(2e-6)
        return CheckpointRegistry(self.node, fleet).latest()

    @unary("ckpt.versions", request=Fixed(64), response=pickled(floor=96),
           idempotent=True, timeout=15.0)
    def versions(self, fleet: Any, ctx: RpcContext) -> Generator:
        yield ctx.cpu(2e-6)
        return CheckpointRegistry(self.node, fleet).versions()


def serve_checkpoints(node: LatticaNode) -> CheckpointService:
    """Expose this node's checkpoint registry over the RPC plane."""
    return node.serve(CheckpointService(node))


def fetch_latest_from(node: LatticaNode, peer: PeerInfo, fleet: str,
                      like: Any = None) -> Generator:
    """Ask ``peer`` for the fleet's latest version and swarm-fetch it (the
    peer doubles as a provider hint).  Returns (step, params) or
    (None, None)."""
    stub = node.stub(CheckpointService, peer)
    latest = yield from stub.latest(fleet)
    if latest is None:
        return None, None
    step, root = latest
    params = yield from fetch_checkpoint(node, root, like,
                                         hint_providers=[peer], fleet=fleet)
    CheckpointRegistry(node, fleet).record_fetched(step, root)
    return step, params


def _classify_blocks(items, base_set) -> Dict[str, int]:
    """Split ``(cid, size)`` pairs into new vs reused against ``base_set``."""
    stats = {"new_blocks": 0, "new_bytes": 0,
             "reused_blocks": 0, "reused_bytes": 0}
    for c, size in items:
        kind = "reused" if c in base_set else "new"
        stats[f"{kind}_blocks"] += 1
        stats[f"{kind}_bytes"] += size
    return stats


def checkpoint_delta(node: LatticaNode, root: CID,
                     base: Optional[CID]) -> Dict[str, int]:
    """Block/byte sharing between two locally-held DAG roots: how much of
    ``root`` is new vs reused verbatim from ``base``.  Blocks missing from
    the local store count as new with size 0 (their bytes are unknown)."""
    store = node.blockstore
    base_set = set(dag_reachable(base, store.peek)) if base is not None else set()
    blk = store.peek
    return _classify_blocks(
        ((c, len(blk(c)) if blk(c) is not None else 0)
         for c in dag_reachable(root, store.peek)), base_set)


#: classes a checkpoint announcement's pickled meta may legitimately carry
#: (the publisher's PeerInfo); everything else is refused — announcement
#: meta arrives off pubsub / fetched manifests, i.e. from untrusted peers,
#: and an open ``pickle.loads`` there is an arbitrary-code-execution vector
_META_ALLOWED = frozenset({
    ("repro.core.dht", "PeerInfo"),
    ("repro.core.peer", "PeerId"),
    ("repro.core.peer", "Multiaddr"),
})


def safe_meta_loads(raw: bytes) -> Any:
    """Decode a checkpoint announcement/manifest meta blob without giving
    the sender code execution: only the allowlisted PeerInfo classes
    resolve.  Raises ``ValueError`` on anything malformed or forbidden."""
    return restricted_loads(raw, _META_ALLOWED)


def chunk_spec_of(node: LatticaNode, root: CID) -> Optional[ChunkSpec]:
    """The ``ChunkSpec`` recorded in a locally-held checkpoint root's meta,
    or None when absent/undecodable.  Publishing a delta against ``base``
    must chunk with the *same* spec the base used — identical boundaries are
    what make unchanged content keep its leaf CIDs."""
    manifest = node.blockstore.peek(root)
    if manifest is None:
        return None
    try:
        if manifest_version(manifest) != 2:
            return None
        meta = safe_meta_loads(decode_manifest_v2(manifest)[2])
        return ChunkSpec.decode(meta["chunking"].encode("ascii"))
    except Exception:        # noqa: BLE001 — older meta without a spec
        return None


def negotiate_chunk_spec(node: LatticaNode, root: CID,
                         prefer: Optional[ChunkSpec] = None,
                         ) -> Optional[ChunkSpec]:
    """Settle which ``ChunkSpec`` governs a fetched checkpoint.

    Content addressing means the publisher always wins — the DAG's
    boundaries are baked into its CIDs and a fetcher cannot re-cut them —
    so "negotiation" is the graceful-degradation half: a fetcher with a
    different preference accepts the recorded spec, the mismatch is
    counted on ``bitswap.stats`` so operators can see a fleet fragmenting
    into incompatible chunking, and the returned spec is what the fetcher
    must use for its own delta re-publishes to keep unchanged-content
    CIDs stable.  Falls back to the fetcher's preference when the
    manifest records nothing (v1 / spec-less meta)."""
    recorded = chunk_spec_of(node, root)
    stats = node.bitswap.stats
    stats["spec_negotiated"] += 1
    if recorded is None:
        return prefer
    if prefer is not None and prefer != recorded:
        stats["spec_mismatch"] += 1
    return recorded


def publish_checkpoint(node: LatticaNode, params: Any, step: int,
                       fleet: str, base: Optional[CID] = None,
                       spec: Optional[ChunkSpec] = None,
                       quant: Optional[str] = None) -> Generator:
    """Per-tensor chunk → provide on the DHT → announce → record in CRDT.

    Each pytree leaf becomes its own sub-DAG under a hierarchical (v2) root
    manifest, so a new version reuses the sub-root CIDs of unchanged tensors
    verbatim and fetchers only swarm what changed.  ``spec`` picks the
    chunking strategy (a ``cdc`` spec additionally dedups *within-tensor*
    byte-shifting edits); when omitted, the spec recorded in ``base``'s
    manifest meta is reused so boundaries — and therefore unchanged-content
    CIDs — reproduce exactly.  With ``base`` (the previous version's root),
    delta stats (new vs reused blocks/bytes) are embedded in the
    announcement meta.  ``quant="int8_block"`` publishes large float
    tensors block-quantized (~4x fewer bytes on top of delta reuse; the
    local fp32 master is untouched) — fetchers dequantize transparently
    from the part meta.  Returns the root CID.
    """
    reg = CheckpointRegistry(node, fleet)
    if spec is None and base is not None:
        spec = chunk_spec_of(node, base)
    if spec is None:
        spec = ChunkSpec()
    parts = params_to_parts(params, quant=quant)
    dag = build_tree_dag(parts, spec=spec)
    delta = None
    if base is not None:
        base_set = set(dag_reachable(base, node.blockstore.peek))
        delta = _classify_blocks(
            ((c, len(blk)) for c, blk in dag.blocks.items()), base_set)
    meta = wire_dumps({"step": step, "fleet": fleet,
                       "bytes": dag.total_size, "delta": delta,
                       "chunking": spec.encode().decode("ascii"),
                       "publisher": node.info()})
    # re-encode only the root manifest with the final meta (the sub-DAGs —
    # all the hashing work — are reused as built)
    manifest = encode_manifest_v2(dag.entries, dag.total_size, meta)
    blocks = dict(dag.blocks)
    del blocks[dag.root]
    root = CID.for_data(manifest, CODEC_DAG)
    blocks[root] = manifest
    yield from node.bitswap.publish_dag(blocks, root)
    node.pin_latest(f"ckpt/{fleet}", root)
    yield from node.pubsub.publish(
        reg.topic, ("artifact", root, dag.total_size, meta), size=192)
    reg.record(step, root)
    node.store.counter(f"steps/{fleet}").increment(node.host.name, 1)
    return root


def fetch_checkpoint(node: LatticaNode, root: CID, like: Any = None,
                     hint_providers: Optional[List[PeerInfo]] = None,
                     fleet: Optional[str] = None,
                     prefer_spec: Optional[ChunkSpec] = None) -> Generator:
    """Swarm-fetch a model version; returns the params pytree.

    Hierarchical (v2) roots reassemble per-tensor — sub-DAGs already in the
    local store (tensors unchanged since the last fetched version) are not
    re-fetched.  Flat (v1) roots take the legacy whole-blob path.  With
    ``fleet``, the fetched root is pinned as that fleet's latest (evicting
    older versions under a blockstore budget).  ``prefer_spec`` states the
    fetcher's chunking preference: when it differs from what the publisher
    recorded, the fetch still proceeds on the publisher's boundaries (see
    :func:`negotiate_chunk_spec`) and the mismatch is counted."""
    yield from node.fetch_artifact(root, hint_providers, assemble=False)
    negotiate_chunk_spec(node, root, prefer_spec)
    manifest = node.blockstore.peek(root)
    try:
        # store blocks were verified on put; skip re-hashing on reassembly
        if manifest is not None and manifest_version(manifest) == 2:
            entries = decode_manifest_v2(manifest)[0]
            flat = {e.name: leaf_from_part(
                        read_dag(e.cid, node.blockstore.get, verify=False),
                        e.meta)
                    for e in entries}
            params = params_from_parts(flat, like)
        else:
            params = params_from_bytes(
                read_dag(root, node.blockstore.get, verify=False), like)
    except (KeyError, ValueError) as e:
        raise FetchError(str(e)) from e
    if fleet is not None:
        node.pin_latest(f"ckpt/{fleet}", root)
    return params


def fetch_latest(node: LatticaNode, fleet: str, like: Any = None,
                 ) -> Generator:
    """Resolve the fleet's latest version from the CRDT registry and fetch.
    Returns (step, params) or (None, None) when no version is known."""
    reg = CheckpointRegistry(node, fleet)
    latest = reg.latest()
    if latest is None:
        return None, None
    step, root = latest
    params = yield from fetch_checkpoint(node, root, like, fleet=fleet)
    return step, params
