"""The port's Lattica mesh against the JAX package's.

``repro_torch.core`` and ``repro_torch.checkpoint.lattica_ckpt`` are
copies of the JAX package's modules, checked here by machine:

* **Copy fidelity.** Each copy's syntax tree equals its reference's once
  import paths are mapped (``repro_torch`` for ``repro``, relative or
  absolute alike), the module docstring's one added paragraph is taken
  out, and the wire-name lines of ``WIRE_LINES`` / ``WIRE_ADDED`` are
  applied to the reference.  The table is printed (``pytest -s``).
* **The two packages, scenario by scenario.** The same seeded scenario
  runs on both under ``Sim(sanitize=True)``: trace digests, event counts,
  sanitizer reports, dashboards, CIDs and fetched leaves are equal.
* **Wire bytes.** ``wire_dumps`` of the port's objects is ``pickle.dumps``
  of the reference's, each package's ``restricted_loads`` reads the
  other's bytes, and reading never imports ``repro``.
* **The port alone**, and gate M1's constants (``chip_smoke.MESH_GOLDEN``)
  re-derived through both packages.
"""

import ast
import hashlib
import importlib
import os
import pickle
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke
from repro_torch.params import params_from_numpy

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

#: the copies, by path under each package
MODULES = ["core/simnet.py", "core/peer.py", "core/nat.py", "core/rpc.py",
           "core/service.py", "core/metrics.py", "core/dht.py",
           "core/blockstore.py", "core/bitswap.py", "core/pubsub.py",
           "core/rendezvous.py", "core/crdt.py", "core/traversal.py",
           "core/node.py", "core/fleet.py", "checkpoint/lattica_ckpt.py",
           "core/cid.py", "core/safepickle.py"]

#: every line where a copy differs from its reference beyond the import
#: paths and the docstring: (file, reference text, port text, reason),
#: written in the reference's import form
WIRE_LINES = [
    ("core/service.py", "import pickle\n", "",
     "the one use of pickle below now goes through wire_dumps"),
    ("core/service.py", "from .simnet import Connection, DialError, Host, "
     "Sim\n", "from .safepickle import wire_dumps\nfrom .simnet import "
     "Connection, DialError, Host, Sim\n", "imports wire_dumps"),
    ("core/service.py", "len(pickle.dumps(payload, protocol=4))",
     "len(wire_dumps(payload, protocol=4))",
     "a pickled payload's simulated wire size counts the bytes a JAX peer "
     "writes, module names included, so the two packages' timings agree"),
    ("checkpoint/lattica_ckpt.py", "import pickle\n", "",
     "the one use of pickle below now goes through wire_dumps"),
    ("checkpoint/lattica_ckpt.py", "from repro.core.safepickle import "
     "restricted_loads\n", "from repro.core.safepickle import "
     "restricted_loads, wire_dumps\n", "imports wire_dumps"),
    ("checkpoint/lattica_ckpt.py", "meta = pickle.dumps(",
     "meta = wire_dumps(",
     "the root manifest's meta pickles the publisher's PeerInfo: under the "
     "wire names it is the JAX peer's bytes, and so is the root CID"),
    ("core/safepickle.py", "return super().find_class(module, name)",
     "return super().find_class(_renamed(module, _WIRE, _PORT), name)",
     "an allowlisted wire name resolves to the port's own class and never "
     "imports the JAX package"),
    ("core/safepickle.py", "from typing import Any, FrozenSet, Tuple\n",
     "import sys\nfrom typing import Any, FrozenSet, Optional, Tuple\n",
     "names the wire-name definitions use"),
]

#: top-level definitions a copy adds: (file, name, reason)
WIRE_ADDED = [
    ("core/safepickle.py", "_PORT", "the port's package name"),
    ("core/safepickle.py", "_WIRE", "the package name written to the wire"),
    ("core/safepickle.py", "_renamed", "maps a module's top package"),
    ("core/safepickle.py", "_WirePickler",
     "pickle's pure-Python pickler, the port's globals under wire names"),
    ("core/safepickle.py", "wire_dumps", "pickle.dumps under the wire names"),
]

#: the wire-name files: nothing else may appear in either table
WIRE_FILES = {"core/service.py", "checkpoint/lattica_ckpt.py",
              "core/safepickle.py"}

PARAGRAPH = "The port's own copy of the JAX package's ``{}``"


# ------------------------------------------------------------ copy fidelity

def _package_of(rel, top):
    return f"{top}.{rel.split('/')[0]}"


def _absolute(node, package):
    """``node``'s module as an absolute name (relative imports resolved
    against ``package``), its top package mapped to ``repro``."""
    if node.level:
        base = package.split(".")
        base = base[:len(base) - node.level + 1]
        name = ".".join(base + ([node.module] if node.module else []))
    else:
        name = node.module
    top, _, rest = name.partition(".")
    if top == "repro_torch":
        top = "repro"
    return f"{top}.{rest}" if rest else top


def _normalised(source, rel, top, added=()):
    """Module ``source`` as a dump of its syntax tree: docstring out,
    ``from`` imports absolute and under ``repro``, ``added`` top-level
    names out.  Returns (dump, docstring, names found of ``added``)."""
    tree = ast.parse(source)
    doc = ast.get_docstring(tree, clean=False)
    body = tree.body[1:] if doc is not None else tree.body
    found, kept = set(), []
    for stmt in body:
        names = _defined(stmt)
        if names and names <= set(added):
            found |= names
            continue
        kept.append(stmt)
    tree.body = kept
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            node.module = _absolute(node, _package_of(rel, top))
            node.level = 0
        elif isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.split(".")[0] == "repro_torch":
                    alias.name = "repro" + alias.name[len("repro_torch"):]
    return ast.dump(tree), doc, found


def _defined(stmt):
    """The top-level names ``stmt`` defines (empty for anything else)."""
    if isinstance(stmt, (ast.FunctionDef, ast.ClassDef)):
        return {stmt.name}
    if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
        targets = stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
        out = set()
        for t in targets:
            for n in ast.walk(t):
                if isinstance(n, ast.Name):
                    out.add(n.id)
        return out
    return set()


def _patched_reference(rel):
    """The reference's source with the table's wire-name lines applied;
    each reference text must occur exactly once."""
    src = (SRC / "repro" / rel).read_text()
    for f, old, new, _ in WIRE_LINES:
        if f == rel:
            assert src.count(old) == 1, (rel, old)
            src = src.replace(old, new)
    return src


@pytest.mark.parametrize("rel", MODULES)
def test_copy_is_the_reference(rel):
    """The copy's syntax tree is the reference's, apart from import paths,
    the docstring's one added paragraph and the listed wire-name lines."""
    port_src = (SRC / "repro_torch" / rel).read_text()
    added = [name for f, name, _ in WIRE_ADDED if f == rel]
    want, ref_doc, _ = _normalised(_patched_reference(rel), rel, "repro")
    got, port_doc, found = _normalised(port_src, rel, "repro_torch", added)
    assert found == set(added), (rel, set(added) - found)
    assert got == want, rel
    ref_paras = ref_doc.split("\n\n")
    port_paras = port_doc.split("\n\n")
    extra = [i for i, p in enumerate(port_paras)
             if p.startswith(PARAGRAPH.format(rel))]
    assert len(extra) == 1, rel
    del port_paras[extra[0]]
    assert port_paras == ref_paras, rel


def test_exceptions_table_holds_only_the_wire_name_lines():
    """The table of differences, printed: every entry is in a wire-name
    file and carries its reason, and every entry is needed (without it the
    copy no longer matches)."""
    print("\ncopy exceptions (file | reference | port | reason):")
    for f, old, new, why in WIRE_LINES:
        print(f"  {f} | {old.strip()!r} | {new.strip()!r} | {why}")
    for f, name, why in WIRE_ADDED:
        print(f"  {f} | - | def {name} | {why}")
    assert {f for f, *_ in WIRE_LINES} | {f for f, *_ in WIRE_ADDED} \
        == WIRE_FILES
    assert all(why for *_, why in WIRE_LINES + WIRE_ADDED)
    for i, (rel, old, new, _) in enumerate(WIRE_LINES):
        src = (SRC / "repro" / rel).read_text()
        for g, o, n, _ in WIRE_LINES[:i] + WIRE_LINES[i + 1:]:
            if g == rel:
                src = src.replace(o, n)
        added = [name for f, name, _ in WIRE_ADDED if f == rel]
        without, _, _ = _normalised(src, rel, "repro")
        port, _, _ = _normalised((SRC / "repro_torch" / rel).read_text(),
                                 rel, "repro_torch", added)
        assert without != port, (rel, old)


# ------------------------------------------------------- the two packages

def _pkg(top):
    """One package's mesh modules."""
    names = ("simnet", "fleet", "nat", "cid", "crdt", "metrics", "dht",
             "peer", "pubsub", "safepickle", "traversal")
    mods = {n: importlib.import_module(f"{top}.core.{n}") for n in names}
    mods["ckpt"] = importlib.import_module(f"{top}.checkpoint.lattica_ckpt")
    return SimpleNamespace(top=top, **mods)


JAX, PORT = _pkg("repro"), _pkg("repro_torch")


def _cid(c):
    return chip_smoke.cid_hex(c)


def _blob(n, seed):
    return np.random.default_rng(seed).integers(0, 256, n,
                                                dtype=np.uint8).tobytes()


def _san(sim, nodes, pkg, extra):
    """What every scenario reports: the sanitizer's report, the fleet's
    dashboard, and the scenario's own readings."""
    return {"san": sim.san_report(), "dashboard": pkg.metrics.dashboard(nodes),
            **extra}


def scenario_join(pkg):
    """(a) A 6-peer fleet joins under a pinned NAT mix (AutoNAT, relay
    reservations), then NAT'd pairs connect: DCUtR punches, a predicted
    symmetric punch, a relay fallback."""
    kind, alloc = pkg.nat.NATKind, pkg.nat.PortAlloc
    kinds = [None, kind.FULL_CONE, kind.PORT_RESTRICTED,
             (kind.SYMMETRIC, alloc.SEQUENTIAL, 1),
             (kind.SYMMETRIC, alloc.RANDOM, 1), kind.RESTRICTED_CONE]
    sim = pkg.simnet.Sim(seed=11, sanitize=True)
    fleet = pkg.fleet.make_fleet(6, nat_kinds=kinds, sim=sim)
    p = fleet.peers

    def dial():
        out = []
        for a, b in ((2, 5), (3, 2), (4, 5), (4, 2), (1, 3)):
            conn = yield from p[a].connect_info(p[b].info())
            out.append((a, b, conn.relayed))
        return out
    conns = sim.run_process(dial(), until=sim.now + 600)
    sim.run(until=sim.now + 20)
    return _san(sim, fleet.all_nodes, pkg, {
        "conns": conns,
        "reach": [n.transport.reachability for n in fleet.all_nodes],
        "relays": [[i.host_name for i in n.relay_infos] for n in p],
        "stats": [dict(n.transport.stats) for n in fleet.all_nodes],
        "relay_stats": [dict(n.transport.relay_stats)
                        for n in fleet.all_nodes]})


def scenario_dht(pkg):
    """(b) DHT: two peers provide one key, a third finds them; a value is
    put and read back."""
    sim = pkg.simnet.Sim(seed=12, sanitize=True)
    fleet = pkg.fleet.make_fleet(6, seed=12, sim=sim)
    p = fleet.peers
    key = hashlib.sha256(b"lattica").digest()

    def run():
        yield from p[0].dht.provide(key)
        yield from p[3].dht.provide(key)
        found = yield from p[5].dht.find_providers(key)
        yield from p[1].dht.put(key, b"value")
        got = yield from p[4].dht.get(key)
        return sorted(i.host_name for i in found), got
    found, got = sim.run_process(run(), until=sim.now + 600)
    assert found == ["peer0", "peer3"] and got == b"value"
    return _san(sim, fleet.all_nodes, pkg, {"found": found, "value": got})


def _tree_parts(seed, shift):
    """A tree of three parts; ``shift`` bytes inserted near the start of
    the big one (a byte-shifting edit) and one small part changed."""
    big = _blob(700_000, seed)
    big = big[:1000] + _blob(shift, seed + 1) + big[1000:]
    return [("a/big", big, b"m0"), ("b/small", _blob(3000 + shift, seed + 2),
                                    b"m1"), ("c/same", _blob(90_000, 7), b"m2")]


def scenario_bitswap(pkg):
    """(c) Bitswap fetch of a v2 tree DAG cut by ``cdc``, then of a second
    version over the first as its base: only the changed blocks move."""
    sim = pkg.simnet.Sim(seed=13, sanitize=True)
    fleet = pkg.fleet.make_fleet(6, seed=13, sim=sim)
    pub, leech = fleet.peers[0], fleet.peers[4]
    spec = pkg.cid.ChunkSpec.cdc(avg_size=16 * 1024)
    v1, v2 = _tree_parts(3, 0), _tree_parts(3, 17)

    def run():
        roots, moved, bodies = [], [], []
        for parts in (v1, v2):
            root = yield from pub.publish_tree_artifact(parts, spec=spec)
            before = leech.bitswap.stats["bytes_fetched"]
            yield from leech.fetch_artifact(root, assemble=False)
            moved.append(leech.bitswap.stats["bytes_fetched"] - before)
            entries = pkg.cid.decode_manifest_v2(
                leech.blockstore.peek(root))[0]
            bodies.append([(e.name, pkg.cid.read_dag(
                e.cid, leech.blockstore.get)) for e in entries])
            roots.append(_cid(root))
        return roots, moved, bodies
    roots, moved, bodies = sim.run_process(run(), until=sim.now + 900)
    assert bodies == [[(n, b) for n, b, _ in v] for v in (v1, v2)]
    assert moved[1] < moved[0]
    return _san(sim, fleet.all_nodes, pkg, {
        "roots": roots, "moved": moved, "stats": dict(leech.bitswap.stats)})


def scenario_crdt(pkg):
    """(d) Merkle-summary anti-entropy across three nodes with churn: each
    writes in several namespaces, one drops every connection mid-way and
    writes on, and pairwise rounds converge."""
    sim = pkg.simnet.Sim(seed=14, sanitize=True)
    fleet = pkg.fleet.make_fleet(3, seed=14, sim=sim, maintenance=False)
    nodes = fleet.peers
    for i, n in enumerate(nodes):
        for k in range(40):
            n.store.counter(f"ns{k % 4}/c{k}").increment(n.host.name, i + k)
        n.store.orset(f"reg/{i}").add(f"x{i}", n.host.name)
        n.store.register("reg/latest").set(f"v{i}", float(i), n.host.name)

    def rounds(k):
        for _ in range(k):
            for a, b in ((0, 1), (1, 2), (2, 0)):
                yield from nodes[a].sync_crdt_with(nodes[b].info())
        return None
    sim.run_process(rounds(1), until=sim.now + 600)
    for conns in list(nodes[1].host._connections.values()):    # churn
        for c in list(conns):
            c.close()
    for k in range(10):
        nodes[1].store.counter(f"ns{k % 4}/late{k}").increment("peer1", 1)
    sim.run_process(rounds(2), until=sim.now + 600)
    converged = pkg.fleet.wait_converged(sim, nodes, timeout=60.0)
    assert converged and all(n.crdt_stats["mst_exchanges"] for n in nodes)
    return _san(sim, fleet.all_nodes, pkg, {
        "converged": converged,
        "digests": [n.store.digest().hex() for n in nodes],
        "crdt_stats": [dict(n.crdt_stats) for n in nodes]})


def scenario_pubsub(pkg):
    """(e) Gossip: five peers subscribe, one publishes five messages."""
    sim = pkg.simnet.Sim(seed=15, sanitize=True)
    fleet = pkg.fleet.make_fleet(6, seed=15, sim=sim)
    got = {n.host.name: [] for n in fleet.peers}
    for n in fleet.peers[1:]:
        n.pubsub.subscribe("t", lambda _t, data, _src, name=n.host.name:
                           got[name].append(data))
    sim.run(until=sim.now + 5)

    def run():
        for i in range(5):
            yield from fleet.peers[0].pubsub.publish("t", ("msg", i), size=300)
            yield 0.5
        return None
    sim.run_process(run(), until=sim.now + 600)
    sim.run(until=sim.now + 20)
    assert all(len(v) == 5 for n, v in got.items() if n != "peer0")
    return _san(sim, fleet.all_nodes, pkg, {
        "got": got, "stats": [dict(n.pubsub.stats) for n in fleet.peers]})


def _small_trees():
    """Gate C1's reduced minicpm-2b (numpy, fp32) and a second version
    with two leaves changed."""
    v1 = chip_smoke.golden_numpy_tree(chip_smoke.golden_trees(torch, "cpu")[
        "fp32"])
    v2 = {k: v for k, v in v1.items()}
    v2["embed"] = v1["embed"] + np.float32(0.5)
    v2["final_norm"] = v1["final_norm"] * np.float32(2)
    return v1, v2


def scenario_checkpoint(pkg, quant):
    """(f) ``publish_checkpoint`` of a reduced minicpm-2b and then of a
    second version with the first as its base, ``fetch_latest`` of each at
    a peer behind another NAT; the port's trees are the numpy trees
    crossed with ``params_from_numpy``."""
    v1, v2 = _small_trees()
    if pkg is PORT:
        v1, v2 = (params_from_numpy(t, "cpu") for t in (v1, v2))
    sim = pkg.simnet.Sim(seed=16, sanitize=True)
    fleet = pkg.fleet.make_fleet(6, seed=16, sim=sim)
    pub, edge = fleet.peers[0], fleet.peers[-1]

    def run():
        out, base = [], None
        for step, tree in ((1, v1), (2, v2)):
            root = yield from pkg.ckpt.publish_checkpoint(
                pub, tree, step, "f", base=base, quant=quant)
            yield from edge.sync_crdt_with(pub.info())
            got_step, got = yield from pkg.ckpt.fetch_latest(edge, "f",
                                                             like=tree)
            out.append((_cid(root), got_step, got, pkg.ckpt.checkpoint_delta(
                pub, root, base)))
            base = root
        return out
    out = sim.run_process(run(), until=sim.now + 900)
    fetched = [{n: np.asarray(a) for n, a in
                chip_smoke.named_leaves(g, sep="/")} for _, _, g, _ in out]
    return _san(sim, fleet.all_nodes, pkg, {
        "roots": [r for r, *_ in out], "steps": [s for _, s, _, _ in out],
        "deltas": [d for *_, d in out], "fetched": fetched})


def scenario_killed_provider(pkg):
    """(g) Two providers seed one DAG; one is killed (every connection
    closed, its blocks gone) while the fetch runs; the fetch completes
    from the other."""
    sim = pkg.simnet.Sim(seed=17, sanitize=True)
    fleet = pkg.fleet.make_fleet(8, seed=17, same_region="us", sim=sim)
    good, doomed, leech = fleet.peers[0], fleet.peers[1], fleet.peers[-1]
    data = _blob(4 << 20, 17)
    dag = pkg.cid.build_dag(data)

    def seed():
        yield from good.bitswap.publish_dag(dict(dag.blocks), dag.root)
        yield from doomed.bitswap.publish_dag(dict(dag.blocks), dag.root)
        return None
    sim.run_process(seed(), until=sim.now + 600)
    killed_at = []

    def killer():
        while leech.bitswap.stats["blocks_fetched"] < 3:
            yield 0.01
        killed_at.append((sim.now, leech.bitswap.stats["blocks_fetched"]))
        for conns in list(doomed.host._connections.values()):
            for c in list(conns):
                c.close()
        for c in list(doomed.blockstore.cids()):
            doomed.blockstore.delete(c)

    def fetch():
        return (yield from leech.fetch_artifact(dag.root, reprovide=False))
    sim.process(killer())
    got = sim.run_process(fetch(), until=sim.now + 900)
    assert got == data and killed_at and leech.bitswap.stats["retries"] > 0
    return _san(sim, fleet.all_nodes, pkg, {
        "killed_at": killed_at, "stats": dict(leech.bitswap.stats)})


SCENARIOS = {
    "a_join": scenario_join, "b_dht": scenario_dht,
    "c_bitswap": scenario_bitswap, "d_crdt": scenario_crdt,
    "e_pubsub": scenario_pubsub,
    "f_checkpoint_fp32": lambda pkg: scenario_checkpoint(pkg, None),
    "f_checkpoint_int8": lambda pkg: scenario_checkpoint(pkg, "int8_block"),
    "g_killed_provider": scenario_killed_provider,
}


def _assert_same(a, b, where=""):
    """Equal readings; arrays (and tensors) exactly equal, dtype and
    shape included."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, (np.ndarray, torch.Tensor)) or isinstance(
            b, (np.ndarray, torch.Tensor)):
        x = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        y = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape, where
        np.testing.assert_array_equal(x, y, err_msg=where)
    else:
        assert a == b, (where, a, b)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_the_two_packages_run_the_same_scenario(name):
    """Trace digest, events, sanitizer report, dashboard, CIDs and fetched
    leaves are equal on ``repro.core`` and ``repro_torch.core``."""
    chip_smoke.fresh_counters(JAX)
    ref = SCENARIOS[name](JAX)
    chip_smoke.fresh_counters(PORT)
    port = SCENARIOS[name](PORT)
    assert ref["san"]["events"] > 100
    assert not ref["san"]["double_settles"]
    _assert_same(ref, port, name)


def test_a_join_covers_autonat_relays_and_dcutr():
    """Scenario (a) reaches what it is there for: AutoNAT's verdicts, relay
    reservations for the private peers, punched and relayed paths."""
    out = scenario_join(PORT)
    assert out["reach"][2] == "public" and "private" in out["reach"]
    assert all(out["relays"][i] for i in (2, 3, 4))
    assert sum(s["punch_ok"] for s in out["stats"]) > 0
    assert any(relayed for *_, relayed in out["conns"])
    assert not all(relayed for *_, relayed in out["conns"])


def test_f_fetched_leaves_equal_the_published_ones():
    """Scenario (f): fp32 leaves come back exactly; the second version
    reuses the first's unchanged leaves."""
    v1, v2 = _small_trees()
    out = scenario_checkpoint(PORT, None)
    for want, got in zip((v1, v2), out["fetched"]):
        _assert_same(dict(chip_smoke.named_leaves(want, sep="/")), got)
    assert out["steps"] == [1, 2]
    assert out["deltas"][1]["reused_blocks"] > 0


# --------------------------------------------------------------- wire bytes

def _objects(pkg):
    """The objects a peer puts on the wire: identity, addresses, a
    checkpoint meta and the CRDT kinds."""
    pid = pkg.peer.PeerId.from_name("peer0")
    relay = pkg.peer.PeerId.from_name("boot0")
    addrs = (pkg.peer.Multiaddr("10.0.0.1", 4001),
             pkg.peer.Multiaddr("1.2.3.4", 4001, relay_peer=relay))
    info = pkg.dht.PeerInfo(pid, "peer0", addrs)
    crdt = pkg.crdt
    g = crdt.GCounter()
    g.increment("a", 3)
    pn = crdt.PNCounter()
    pn.increment("a", 2)
    pn.decrement("b", 1)
    lww = crdt.LWWRegister()
    lww.set("v", 1.5, "a")
    mv = crdt.MVRegister()
    mv.set("x", "a")
    orset = crdt.ORSet()
    orset.add("e", "a")
    return {"PeerId": pid, "Multiaddr": addrs, "PeerInfo": info,
            "meta": {"step": 2, "fleet": "f", "bytes": 10, "delta": None,
                     "chunking": "fixed:262144", "publisher": info},
            "crdt": {"g": g, "pn": pn, "lww": lww, "mv": mv, "orset": orset}}


ALLOWED = (JAX.ckpt._META_ALLOWED | JAX.crdt.ReplicatedStore._WIRE_ALLOWED)


@pytest.mark.parametrize("what", ["PeerId", "Multiaddr", "PeerInfo", "meta",
                                  "crdt"])
@pytest.mark.parametrize("protocol", [None, 4, 5])
def test_wire_dumps_is_the_reference_pickle(what, protocol):
    """The port's objects pickle to the JAX package's bytes, and each
    package's ``restricted_loads`` reads the other's into its own
    classes."""
    ref, port = _objects(JAX)[what], _objects(PORT)[what]
    raw = pickle.dumps(ref, protocol=protocol)
    assert PORT.safepickle.wire_dumps(port, protocol=protocol) == raw
    in_port = PORT.safepickle.restricted_loads(raw, ALLOWED)
    in_ref = JAX.safepickle.restricted_loads(raw, ALLOWED)
    assert _classes(in_port) == {c.replace("repro.", "repro_torch.", 1)
                                 for c in _classes(in_ref)}
    assert {c.split(".")[0] for c in _classes(in_ref)} <= {"repro"}
    # decoded objects no longer share their strings, so their bytes are
    # those of the reference's decoded objects, not ``raw``
    assert PORT.safepickle.wire_dumps(in_port, protocol=protocol) == \
        pickle.dumps(in_ref, protocol=protocol)


def _classes(obj):
    """The modules and names of the classes inside ``obj``."""
    if isinstance(obj, dict):
        return set().union(*map(_classes, obj.values())) if obj else set()
    if isinstance(obj, (list, tuple)):
        return set().union(*map(_classes, obj)) if obj else set()
    if type(obj).__module__ == "builtins":
        return set()
    return {f"{type(obj).__module__}.{type(obj).__qualname__}"}


def test_wire_dumps_leaves_other_objects_as_pickle_writes_them():
    values = [0, -7, 2 ** 70, 1.5, "s", "é" * 300, b"\x00" * 70000, None,
              (1, (2, 3)), [1, [2]], {"a": {1: 2}}, {1, 2}, frozenset("ab"),
              list(range(3000)), np.arange(5, dtype=np.float32)]
    for v in values:
        for protocol in (None, 2, 4, 5):
            assert PORT.safepickle.wire_dumps(v, protocol) == pickle.dumps(
                v, protocol), (v, protocol)


def test_port_names_are_refused_on_the_wire():
    """The allow-lists name ``repro.*``: a payload written with the port's
    own module names (plain ``pickle.dumps``) is refused, and a global
    outside the list is refused whatever its package."""
    info = _objects(PORT)["PeerInfo"]
    with pytest.raises(ValueError):
        PORT.safepickle.restricted_loads(pickle.dumps(info), ALLOWED)
    with pytest.raises(ValueError):
        PORT.safepickle.restricted_loads(pickle.dumps(os.getcwd), ALLOWED)
    with pytest.raises(ValueError):
        PORT.safepickle.restricted_loads(pickle.dumps(_objects(JAX)["crdt"]))


def test_reading_a_reference_payload_imports_no_jax_package():
    """In a process with only the port: a payload of the JAX package's
    classes decodes into the port's, and ``repro`` is never imported."""
    raw = pickle.dumps([_objects(JAX)[k] for k in ("meta", "crdt")])
    code = (
        "import sys\n"
        "from repro_torch.checkpoint import lattica_ckpt\n"
        "from repro_torch.core import crdt, dht, safepickle\n"
        "allowed = lattica_ckpt._META_ALLOWED | "
        "crdt.ReplicatedStore._WIRE_ALLOWED\n"
        "meta, kinds = safepickle.restricted_loads("
        "sys.stdin.buffer.read(), allowed)\n"
        "assert type(meta['publisher']) is dht.PeerInfo\n"
        "assert type(kinds['orset']) is crdt.ORSet\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('repro', 'jax'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", code], input=raw, env=env,
                         capture_output=True, timeout=120)
    assert res.returncode == 0, res.stderr.decode()


# ---------------------------------------------------------- the port alone

def test_port_double_run_is_bit_identical_and_clean():
    """A sanitized scenario run twice on the port gives the same report,
    with no double-settle, no orphan and a clean leak audit."""
    trees = chip_smoke.golden_trees(torch, "cpu")
    runs = [chip_smoke.mesh_scenario(PORT, trees["fp32"], trees["fp32"],
                                     sanitize=True) for _ in range(2)]
    assert runs[0]["san"] == runs[1]["san"]
    san = runs[0]["san"]
    assert not san["double_settles"] and not san["orphans"]
    assert san["leaks"] == {} and runs[0]["leaks"] == {}
    for run in runs:
        got = dict(chip_smoke.named_leaves(run["fetched"]))
        for name, want in chip_smoke.named_leaves(trees["fp32"]):
            assert torch.equal(got[name], want), name


def test_mesh_golden_constants():
    """Gate M1's constants: re-derived through the JAX package (a numpy
    tree) and through the port (the same tree on the CPU)."""
    trees = chip_smoke.golden_trees(torch, "cpu")
    tree = chip_smoke.golden_numpy_tree(trees["fp32"])
    ref = chip_smoke.mesh_scenario(JAX, tree, tree, sanitize=True)
    port = chip_smoke.mesh_scenario(PORT, trees["fp32"], trees["fp32"],
                                    sanitize=True)
    assert chip_smoke.mesh_golden(ref) == chip_smoke.MESH_GOLDEN
    assert chip_smoke.mesh_golden(port) == chip_smoke.MESH_GOLDEN
    assert ref["path"] == port["path"] == "relayed"
    assert ref["nat"] == port["nat"]
    assert ref["nat"][:2] == ["port_restricted", "symmetric/random"]
    # the reference's streaming fetch leaves the fetcher's channel ends
    # open until the connection goes; the copy does the same
    assert ref["leaks_held"] == port["leaks_held"]
    assert ref["leaks_held"]["net.half_open_streams"] > 0
    assert ref["leaks"] == port["leaks"] == {}


# ------------------------------------------------------ the CRDT hazard

def test_crdt_create_only_entry_differs_between_merge_and_delta():
    """A store that only creates an empty CRDT (``counter(k)`` with no
    write) ships it in a full ``merge`` but not in ``delta_since``: the
    two receivers' digests differ, the same way in both packages.  The
    copy keeps this, so that JAX and torch replicas agree."""
    digests = {}
    for pkg in (JAX, PORT):
        Store = pkg.crdt.ReplicatedStore
        a = Store("a")
        a.counter("steps").increment("a", 2)
        a.counter("empty")                   # created, never written
        a.orset("set/empty")
        a.register("reg/empty")
        full, delta = Store("b"), Store("c")
        full.merge(a)
        delta.apply_delta(a.delta_since(delta.vv()))
        digests[pkg.top] = (full.digest(), delta.digest(),
                            sorted(full.entries), sorted(delta.entries))
    assert digests["repro"] == digests["repro_torch"]
    full_d, delta_d, full_keys, delta_keys = digests["repro"]
    assert full_d != delta_d
    assert set(full_keys) - set(delta_keys) == {"empty", "set/empty",
                                                "reg/empty"}


# ------------------------------------------------- the smoke's mesh phase

def test_mesh_phase_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.mesh_phase`` end to end at a reduced width on the CPU,
    gates M1-M3 as written, with the attention kernels' plain versions
    counted as their launches."""
    from repro_torch.checkpoint import params_to_parts
    from repro_torch.configs import get_config
    from repro_torch.core.cid import build_tree_dag
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import decoder

    for mod, name in ((fa, "flash_attention_plain"),
                      (pa, "paged_attention_plain")):
        def counted(*args, _fn=getattr(mod, name), _mod=mod, **kwargs):
            _mod.launches += 1
            return _fn(*args, **kwargs)
        monkeypatch.setattr(mod, name, counted)
    lines = []
    monkeypatch.setattr(chip_smoke, "nvidia_smi", lambda: "cpu")
    monkeypatch.setattr(chip_smoke, "emit", lines.append)
    cfg = get_config("minicpm-2b").reduced(**chip_smoke.T2_REDUCED)
    trained = decoder.init_params(cfg, torch.Generator().manual_seed(5),
                                  "cpu")
    entries = build_tree_dag(params_to_parts(trained)).entries
    chip_smoke.mesh_phase(torch, trained, entries, 0.0, device="cpu",
                          cfg=cfg)
    (line,) = lines
    assert line["phase"] == "mesh" and line["path"] == "relayed"
    assert [{k: r[k] for k in chip_smoke.MESH_GOLDEN} for r in line["m1"]] \
        == [chip_smoke.MESH_GOLDEN] * 2
    assert line["m3_launches"]["flash_attention"] > 0
    assert line["m3_launches"]["paged_decode_attention"] > 0
    assert set(line["stages"]) >= {"params_to_parts", "dag_build", "publish",
                                   "fetch", "reassembly", "copy_to_card",
                                   "publish_provide_s", "fetch_s"}
