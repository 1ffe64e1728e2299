"""Node metrics & fleet dashboard.

The port's own copy of the JAX package's ``core/metrics.py``: the same code
under the port's import paths.

The paper's user study (§5) lists "improved monitoring dashboards" as the
top feedback item.  Every subsystem already keeps counters; this module
aggregates them into a per-node snapshot and renders a fleet-wide text
dashboard (the kind of operational view an SRE would curl off a node).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, TYPE_CHECKING

from .service import MethodStats

if TYPE_CHECKING:  # pragma: no cover
    from .node import LatticaNode


def node_snapshot(node: "LatticaNode") -> Dict[str, Any]:
    """Flat metrics snapshot of one node (all subsystem counters)."""
    t = node.transport
    snap: Dict[str, Any] = {
        "name": node.host.name,
        "region": node.host.region,
        "reachability": t.reachability,
        "is_relay": t.is_relay,
        "n_connections": sum(
            1 for conns in node.host._connections.values()
            for c in conns if not c.closed),
        "n_relayed": sum(
            1 for conns in node.host._connections.values()
            for c in conns if not c.closed and c.relayed),
        "peers_known": len(node.peers),
        "dht_table": len(node.dht.table),
        "dht_records": len(node.dht.records),
        "dht_provider_keys": len(node.dht.providers),
        "blocks": len(node.blockstore),
        "bytes_stored": node.blockstore.bytes_stored,
        "store_capacity": node.blockstore.capacity,
        "pinned_roots": len(node.blockstore.pinned_roots),
        "crdt_keys": len(node.store.entries),
    }
    snap["relay_reservations"] = len(t.relay_reservations)
    snap["relays_held"] = len(node.relay_infos)
    for prefix, stats in (("transport", t.stats),
                          ("relay", t.relay_stats),
                          ("rpc", node.router.stats),
                          ("dht", node.dht.stats),
                          ("pubsub", node.pubsub.stats),
                          ("crdt", node.crdt_stats),
                          ("store", node.blockstore.stats),
                          ("bitswap", node.bitswap.stats)):
        for k, v in stats.items():
            snap[f"{prefix}.{k}"] = v
    # serving plane: a node may host several ShardServers / ShardClients
    # (registered by serving/sharded.py); sum their counters
    servers = getattr(node, "shard_servers", [])
    if servers:
        snap["serving.shards"] = len(servers)
        snap["serving.slots_used"] = sum(s.engine.slots_used for s in servers)
        snap["serving.queue_depth"] = sum(s.engine.queue_depth for s in servers)
        for key in ("admitted", "evicted", "steps", "step_sessions",
                    "slot_reuse", "queue_peak", "pages_peak", "idle_evicted"):
            snap[f"serving.{key}"] = sum(s.engine.stats[key] for s in servers)
    clients = getattr(node, "shard_clients", [])
    if clients:
        for key in ("requests", "completed", "failed_sessions",
                    "sessions_migrated", "failovers", "hedged", "calls"):
            snap[f"serving.client.{key}"] = sum(c.stats[key] for c in clients)
    return snap


_DASH_COLS = [
    ("name", 8), ("region", 6), ("reachability", 9), ("n_connections", 5),
    ("dht_table", 6), ("blocks", 7), ("bytes_stored", 12),
    ("pinned_roots", 4), ("store.evictions", 6),
    ("bitswap.bytes_served", 12), ("bitswap.bytes_fetched", 12),
    ("rpc.unary_served", 8),
]


def rpc_method_stats(nodes: Iterable["LatticaNode"]) -> Dict[str, MethodStats]:
    """Aggregate the metrics interceptor's client-side per-method stats
    across a fleet: method -> merged calls/errors/latency reservoir."""
    merged: Dict[str, MethodStats] = {}
    for node in nodes:
        for method, stats in node.rpc_metrics.client.items():
            agg = merged.get(method)
            if agg is None:
                # unbounded: a bounded deque would silently keep only the
                # last nodes' samples and skew the fleet percentiles
                agg = merged[method] = MethodStats(maxlen=None)
            agg.calls += stats.calls
            agg.errors += stats.errors
            agg.latencies.extend(stats.latencies)
    return merged


def rpc_method_table(nodes: Iterable["LatticaNode"]) -> str:
    """Per-method RPC table (calls, errors, p50/p95 latency in ms)."""
    merged = rpc_method_stats(nodes)
    head = f"{'method':<22} {'calls':>7} {'errors':>6} {'p50_ms':>8} {'p95_ms':>8}"
    lines = [head, "-" * len(head)]
    for method in sorted(merged):
        s = merged[method]
        lines.append(f"{method:<22} {s.calls:>7} {s.errors:>6} "
                     f"{s.percentile(0.50) * 1e3:>8.2f} "
                     f"{s.percentile(0.95) * 1e3:>8.2f}")
    return "\n".join(lines)


def dashboard(nodes: Iterable["LatticaNode"]) -> str:
    """Fleet-wide text dashboard."""
    nodes = list(nodes)
    rows = [node_snapshot(n) for n in nodes]
    head = " ".join(f"{name.split('.')[-1][:w]:>{w}}" for name, w in _DASH_COLS)
    lines = [head, "-" * len(head)]
    for r in rows:
        lines.append(" ".join(
            f"{str(r.get(name, ''))[:w]:>{w}}" for name, w in _DASH_COLS))
    fwd = [r.get("pubsub.forwarded", 0) for r in rows] or [0]
    totals = {
        "direct_ok": sum(r.get("transport.punch_ok", 0) for r in rows),
        "punch_fail": sum(r.get("transport.punch_fail", 0) for r in rows),
        # mesh relay load: a healthy scored mesh keeps max near mean —
        # flood dissemination concentrates on well-known hubs instead
        "mesh_relay_max": max(fwd),
        "mesh_relay_mean": round(sum(fwd) / len(fwd), 1),
        # anti-entropy probe bytes (Merkle summary walks, O(log n)/probe)
        "summary_bytes": sum(r.get("crdt.mst_probe_bytes", 0) for r in rows),
        "bytes_moved": sum(r.get("bitswap.bytes_fetched", 0) for r in rows),
        "rpc_served": sum(r.get("rpc.unary_served", 0) for r in rows),
        "rpc_errors": sum(r.get("rpc.errors", 0) for r in rows),
        "sessions_migrated": sum(
            r.get("serving.client.sessions_migrated", 0) for r in rows),
    }
    lines.append("-" * len(head))
    lines.append("fleet: " + "  ".join(f"{k}={v}" for k, v in totals.items()))
    lines.append("")
    lines.append("per-method RPC (client side, fleet-wide):")
    lines.append(rpc_method_table(nodes))
    return "\n".join(lines)
