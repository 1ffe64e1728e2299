"""The port's serving fleet against the JAX package's, and the two in one
mixed fleet.

``repro_torch.serving.router``, ``repro_torch.serving.pressure`` and most
of ``repro_torch.serving.sharded`` are copies of the JAX package's
modules, checked here by machine:

* **Copy fidelity.** Each copy's syntax tree equals its reference's once
  import paths are mapped (``repro_torch`` for ``repro``), the module
  docstring's one added paragraph is taken out, and the lines of
  ``COPY_LINES`` are applied to the reference; each listed line carries
  its reason and is needed.  In ``sharded.py`` the copied definitions
  (``SHARDED_COPIED``) are compared one by one, ``ShardServer`` without
  ``_handle``, which the port writes on tensors.
* **Port twins** of ``test_serving.py`` and of the router and end-to-end
  tests of ``test_serving_batch.py``, the port's tokens held against the
  JAX ``GenerationEngine`` on the same tree.
* **Scenario parity.** ``test_serving_batch.py``'s ``served_v2`` scenario
  on each package's own mesh under ``Sim(seed=21, sanitize=True)``: the
  same trace digest, events, simulated end time, client stats, tokens and
  dashboards.
* **The replies** of ``ShardServer._handle``: numpy arrays of the JAX
  server's dtype and shape, of equal ``TensorDictCodec`` sizes.
* **The mixed fleet**, in a subprocess (``mixed_main``): ``repro.core``
  and each ``repro.core.<m>`` aliased to the port's modules before any
  ``repro.serving`` or ``repro.checkpoint`` import, and
  ``repro.checkpoint.lattica_ckpt``'s ``pickle`` global pointed at the
  port's ``wire_dumps``; no file changes.  (a) the pin, (b) one CID served
  both ways, (c) a torch-shard kill, (d) pressure across packages.
* **The smoke's fleet phase**, rehearsed on the CPU at a reduced width.

Nothing of the JAX package is imported at the top of this file, so that
the subprocess can install the alias before it imports the JAX package.
"""

import ast
import importlib
import itertools
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
FLEET_KW = dict(n_layers=4, d_model=64, vocab=256)



@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The fleet's tensors are tiny: one intra-op thread runs them tens of
    times faster than a pool that waits on its workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ------------------------------------------------------------ copy fidelity

#: the copies, by path under each package
COPIES = ["serving/router.py", "serving/pressure.py", "serving/sharded.py"]

#: the top-level definitions of ``sharded.py`` that are copies
SHARDED_COPIED = ["_session_seq", "shard_key", "InferenceService",
                  "InferenceV2Service", "ShardServer", "_Request",
                  "ShardClient", "deploy_sharded", "serve_fleet"]

#: every line where a copy differs from its reference beyond the import
#: paths and the docstring: (file, reference text, port text, reason),
#: written in the reference's import form
COPY_LINES = [
    ("serving/sharded.py", "page_size=page_size, kv_dtype=kv_dtype)",
     "page_size=page_size, kv_dtype=kv_dtype, device=module.device)",
     "the shard's engine runs on the device that holds the shard's "
     "parameters; the port's BatchEngine takes its device and defaults to "
     "the card"),
    ("serving/pressure.py",
     "from typing import Any, Dict, Generator, List, Optional, Tuple\n",
     "from typing import Any, Dict, Generator, List, Optional, Tuple, "
     "Union\n", "names the device argument's type uses"),
    ("serving/pressure.py", "import numpy as np\n",
     "import numpy as np\nimport torch\n",
     "names the device argument's type uses"),
    ("serving/pressure.py", "from repro.core.cid import CID\n",
     "from repro.core.cid import CID\nfrom repro.core.device import "
     "resolve_device\n", "imports resolve_device"),
    ("serving/pressure.py", "from repro.models.config import ModelConfig\n",
     "from repro.models.config import ModelConfig\nfrom repro.tree import "
     "tree_map\n", "imports tree_map"),
    ("serving/pressure.py",
     "cold_occupancy: float = 0.15, cold_sustain: int = 6):",
     "cold_occupancy: float = 0.15, cold_sustain: int = 6, "
     "device: Union[str, torch.device] = 'cuda'):",
     "the monitor takes the device its spawned replicas serve on: the card "
     "unless the caller asks for the CPU"),
    ("serving/pressure.py", "        node.join_crdt_push(\"serving\")\n",
     "        self.device = resolve_device(device)\n"
     "        node.join_crdt_push(\"serving\")\n",
     "resolves it at construction: without a card, asking for it raises "
     "here, and nothing moves to the CPU"),
    ("serving/pressure.py", "params = tree_from_flat(flat)",
     "params = tree_map(lambda t: t.to(self.device), tree_from_flat(flat))",
     "the fetched parts come back as CPU tensors; the spawned replica's "
     "ShardServer serves them from the monitor's device"),
]

PARAGRAPH = "The port's own copy of the JAX package's ``{}``"


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


def _parsed(source, rel, top):
    """``source``'s syntax tree, its ``from`` imports absolute and under
    ``repro``, and its docstring."""
    tree = ast.parse(source)
    doc = ast.get_docstring(tree, clean=False)
    if doc is not None:
        tree.body = tree.body[1:]
    package = f"{top}.{rel.split('/')[0]}"
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            node.module = _absolute(node, package)
            node.level = 0
    return tree, doc


def _defined(stmt):
    if isinstance(stmt, (ast.FunctionDef, ast.ClassDef)):
        return stmt.name
    if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
            and isinstance(stmt.targets[0], ast.Name):
        return stmt.targets[0].id
    return None


def _copied(tree, rel):
    """What of module ``tree`` is a copy, as one dump: the whole module,
    or for ``sharded.py`` the definitions of ``SHARDED_COPIED`` with
    ``ShardServer._handle`` taken out."""
    if rel != "serving/sharded.py":
        return ast.dump(tree)
    defs = {_defined(s): s for s in tree.body if _defined(s)}
    out = []
    for name in SHARDED_COPIED:
        stmt = defs[name]
        if name == "ShardServer":
            stmt.body = [s for s in stmt.body if getattr(s, "name", None)
                         != "_handle"]
        out.append(ast.dump(stmt))
    return "\n".join(out)


def _reference(rel, skip=None):
    """The reference's source with ``COPY_LINES`` applied (all but entry
    ``skip``); each reference text must occur exactly once."""
    src = (SRC / "repro" / rel).read_text()
    for i, (f, old, new, _) in enumerate(COPY_LINES):
        if f == rel and i != skip:
            assert src.count(old) == 1, (rel, old)
            src = src.replace(old, new)
    return src


def _port_dump(rel):
    tree, doc = _parsed((SRC / "repro_torch" / rel).read_text(), rel,
                        "repro_torch")
    return _copied(tree, rel), doc


@pytest.mark.parametrize("rel", COPIES)
def test_copy_is_the_reference(rel):
    """The copy's syntax tree is the reference's, apart from import paths,
    the docstring's one added paragraph and the listed lines."""
    ref_tree, ref_doc = _parsed(_reference(rel), rel, "repro")
    got, port_doc = _port_dump(rel)
    assert got == _copied(ref_tree, rel), rel
    if rel == "serving/sharded.py":
        # the module is the port's own; its docstring names the copies
        assert all(f"``{n}``" in port_doc for n in SHARDED_COPIED[1:])
        return
    ref_paras = ref_doc.split("\n\n")
    port_paras = port_doc.split("\n\n")
    extra = [i for i, p in enumerate(port_paras)
             if p.startswith(PARAGRAPH.format(rel))]
    assert len(extra) == 1, rel
    del port_paras[extra[0]]
    assert port_paras == ref_paras, rel


def test_copy_lines_are_each_needed():
    """The table, printed: every entry carries its reason, and without any
    one of them the copy no longer matches."""
    print("\ncopy exceptions (file | reference | port | reason):")
    for f, old, new, why in COPY_LINES:
        print(f"  {f} | {old.strip()!r} | {new.strip()!r} | {why}")
    assert all(why for *_, why in COPY_LINES)
    for i, (rel, *_rest) in enumerate(COPY_LINES):
        tree, _ = _parsed(_reference(rel, skip=i), rel, "repro")
        assert _copied(tree, rel) != _port_dump(rel)[0], COPY_LINES[i]


# ------------------------------------------------------- the two packages

def _pkg(top):
    """One package's mesh and serving modules."""
    names = {"simnet": "core.simnet", "fleet": "core.fleet",
             "nat": "core.nat", "pubsub": "core.pubsub",
             "traversal": "core.traversal", "metrics": "core.metrics",
             "service": "core.service", "sharded": "serving.sharded",
             "router": "serving.router", "pressure": "serving.pressure",
             "ckpt": "checkpoint.lattica_ckpt"}
    return SimpleNamespace(top=top, **{
        k: importlib.import_module(f"{top}.{m}") for k, m in names.items()})


def fresh_serving_counters(pkg):
    """``chip_smoke.fresh_counters`` and the session counter of the
    package's ``sharded`` module, as a new process starts them."""
    chip_smoke.fresh_counters(pkg)
    pkg.sharded._session_seq = itertools.count(1)


def _prompts(seeds, n=8, vocab=FLEET_KW["vocab"]):
    """The JAX tests' prompts: ``jax.random.randint(PRNGKey(seed), (1, n),
    0, vocab)`` as int32 numpy."""
    import jax
    return [np.asarray(jax.random.randint(jax.random.PRNGKey(s), (1, n), 0,
                                          vocab), np.int32) for s in seeds]


def served_v2_scenario(pkg, cfg, params):
    """``test_serving_batch.py``'s ``served_v2`` fleet and its first test's
    traffic: ``make_fleet(10, same_region="us")`` under ``Sim(seed=21,
    sanitize=True)``, ``serve_fleet`` of 2 shards x 2 replicas with 4
    slots on the first four peers, and a ``ShardClient`` on the last
    generating 6 greedy tokens for each of 6 prompts at once."""
    fresh_serving_counters(pkg)
    sim = pkg.simnet.Sim(seed=21, sanitize=True)
    fleet = pkg.fleet.make_fleet(10, same_region="us", sim=sim)
    servers = sim.run_process(pkg.sharded.serve_fleet(
        fleet.peers[:4], cfg, params, "svc", replicas=2, n_slots=4),
        until=sim.now + 900)
    client = pkg.sharded.ShardClient(fleet.peers[-1], cfg, "svc", n_shards=2)

    def run():
        reqs = [dict(tokens=p, n_tokens=6) for p in _prompts(range(6))]
        return (yield from client.generate_concurrent(reqs))
    outs = sim.run_process(run(), until=sim.now + 900)
    san = sim.san_report()
    return {"end": sim.now, "trace_digest": san["trace_digest"],
            "events": san["events"], "stats": dict(client.stats),
            "tokens": [o.tolist() for o in outs],
            "dashboard": pkg.metrics.dashboard(fleet.all_nodes),
            "snapshots": [pkg.metrics.node_snapshot(n)
                          for n in fleet.all_nodes],
            "batched": any(s.engine.stats["step_sessions"]
                           > s.engine.stats["steps"] for s in servers)}


@pytest.fixture(scope="module")
def model():
    """The JAX package's reduced granite-8b and its seeded init, and the
    port's config with the same tree crossed to the CPU."""
    import jax

    from repro.configs import get_config as jax_get_config
    from repro.models import ops_for
    from repro_torch.configs import get_config

    jcfg = jax_get_config("granite-8b").reduced(**FLEET_KW)
    jops = ops_for(jcfg)
    jparams = jops.init(jcfg, jax.random.PRNGKey(0))
    cfg = get_config("granite-8b").reduced(**FLEET_KW)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return SimpleNamespace(jcfg=jcfg, jops=jops, jparams=jparams, cfg=cfg,
                           params=params)


_JAX_ENGINES = {}


def jax_tokens(model, prompt, n, max_len):
    """The JAX ``GenerationEngine``'s greedy tokens for ``prompt`` (one
    engine per tree and ``max_len``, so that each compiles once)."""
    import jax.numpy as jnp

    from repro.serving.engine import GenerationEngine as JaxEngine
    key = (id(model.jparams), max_len)
    if key not in _JAX_ENGINES:
        _JAX_ENGINES[key] = JaxEngine(model.jcfg, model.jparams,
                                      max_len=max_len)
    want, _ = _JAX_ENGINES[key].generate({"tokens": jnp.asarray(prompt)}, n)
    return np.asarray(want[0])


@pytest.fixture(scope="module")
def jax_served_v2(model):
    """The scenario on the JAX package, in this process, unaliased."""
    return served_v2_scenario(_pkg("repro"), model.jcfg, model.jparams)


def test_scenario_parity_with_the_jax_package(model, jax_served_v2):
    """The same seeded scenario on each package's own mesh: equal trace
    digest, events, simulated end time, client stats, tokens and
    dashboards."""
    ref = jax_served_v2
    port = served_v2_scenario(_pkg("repro_torch"), model.cfg, model.params)
    assert ref["events"] > 1000 and ref["batched"]
    assert ref["stats"]["completed"] == 6
    assert ref["stats"]["failed_sessions"] == 0
    for key in ref:
        assert port[key] == ref[key], key


# --------------------------------------------------------------- replies

class _Ctx:
    """The one thing ``_handle`` asks of its RPC context."""

    @staticmethod
    def cpu(seconds):
        return ("cpu", seconds)


def _call(server, payload):
    """``server._handle(payload)`` driven by hand: (reply, cost)."""
    gen = server._handle(payload, _Ctx())
    _, cost = next(gen)
    with pytest.raises(StopIteration) as stop:
        gen.send(None)
    return stop.value.value, cost


def _handle_servers(pkg, cfg, params):
    """Shard 0 and shard 1 of a 2-way split, each a ``ShardServer`` on a
    peer of a small fleet."""
    sim = pkg.simnet.Sim(seed=3)
    fleet = pkg.fleet.make_fleet(2, same_region="us", sim=sim, join=False,
                                 maintenance=False)
    plan = pkg.sharded.plan_shards(cfg, 2)
    parts = pkg.sharded.split_params(cfg, params, plan)
    return [pkg.sharded.ShardServer(
        fleet.peers[i], cfg, "h", i, pkg.sharded.ShardModule(
            cfg, parts[i], plan[i], is_first=i == 0, is_last=i == 1))
        for i in range(2)]


def test_handle_replies_are_the_jax_servers(model):
    """Prefill, decode and score through both shards: each reply is a
    numpy array of the JAX server's dtype and shape, with equal
    ``TensorDictCodec`` sizes and equal simulated cost, its values within
    1e-4 of the JAX server's."""
    jax_pkg, port_pkg = _pkg("repro"), _pkg("repro_torch")
    jsv = _handle_servers(jax_pkg, model.jcfg, model.jparams)
    psv = _handle_servers(port_pkg, model.cfg, model.params)
    jcodec = jax_pkg.service.TensorDictCodec()
    pcodec = port_pkg.service.TensorDictCodec()
    toks = _prompts([11], n=9)[0]
    batch = np.concatenate(_prompts([12, 13], n=7))
    flows = [("prefill", {"session": ("c", 1), "max_len": 16}, toks),
             ("decode", {"session": ("c", 1)}, np.asarray([5], np.int32)),
             ("decode", {"session": ("c", 1)}, np.asarray([7], np.int32)),
             ("score", {}, batch)]
    shapes = []
    for op, extra, x0 in flows:
        xj = xp = x0
        for i in range(2):
            rj, cj = _call(jsv[i], dict(extra, op=op, x=xj))
            rp, cp = _call(psv[i], dict(extra, op=op, x=xp))
            assert type(rp["x"]) is np.ndarray, (op, i)
            assert rp["x"].dtype == rj["x"].dtype == np.float32, (op, i)
            assert rp["x"].shape == rj["x"].shape, (op, i)
            assert pcodec.size_of(rp) == jcodec.size_of(rj), (op, i)
            assert cp == cj, (op, i)
            np.testing.assert_allclose(rp["x"], rj["x"], atol=1e-4, rtol=0)
            shapes.append(rp["x"].shape)
            xj, xp = rj["x"], rp["x"]
    D, V = model.cfg.d_model, model.cfg.vocab
    assert shapes == [(1, 9, D), (1, V), (1, 1, D), (1, V), (1, 1, D),
                      (1, V), (2, 7, D), (2, 7, V)]
    for s in psv:
        assert s.engine.device == s.module.device == torch.device("cpu")
    with pytest.raises(port_pkg.service.ServiceError):
        _call(psv[0], {"op": "decode", "session": ("c", 9),
                       "x": np.asarray([1], np.int32)})


# ------------------------------------------------- port twins: v1 plane

@pytest.fixture(scope="module")
def served(model):
    """``test_serving.py``'s fleet on the port: 2 shards x 2 replicas on
    the first four of nine peers."""
    from repro_torch.core.fleet import make_fleet
    from repro_torch.serving import deploy_sharded

    fleet = make_fleet(9, seed=21, same_region="us")
    sim = fleet.sim
    servers = deploy_sharded(fleet.peers[:4], model.cfg, model.params, "svc",
                             replicas=2)

    def announce():
        for s in servers:
            yield from s.announce()
    sim.run_process(announce(), until=sim.now + 600)
    return fleet, servers


def _jax_forward(model, toks):
    import jax.numpy as jnp
    local, _ = model.jops.forward(model.jparams, model.jcfg,
                                  {"tokens": jnp.asarray(toks)})
    return np.asarray(local)


def _random_tokens(seed, shape, vocab=FLEET_KW["vocab"]):
    import jax
    return np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape, 0,
                                         vocab), np.int32)


def test_pipeline_score_matches_local(model, served):
    from repro_torch.serving import ShardClient
    fleet, _ = served
    client = ShardClient(fleet.peers[-1], model.cfg, "svc", n_shards=2)
    toks = _random_tokens(1, (2, 16))

    def run():
        return (yield from client.score(toks))
    remote = fleet.sim.run_process(run(), until=fleet.sim.now + 600)
    np.testing.assert_allclose(remote, _jax_forward(model, toks), atol=1e-4,
                               rtol=1e-4)


def test_generation_matches_local_engine(model, served):
    from repro_torch.serving import ShardClient
    fleet, _ = served
    client = ShardClient(fleet.peers[-2], model.cfg, "svc", n_shards=2)
    toks = _random_tokens(2, (1, 8))

    def run():
        return (yield from client.generate(toks, 4))
    remote = fleet.sim.run_process(run(), until=fleet.sim.now + 600)
    np.testing.assert_array_equal(remote[0], jax_tokens(model, toks, 4, 32))


def test_failover_to_replica_shard(model, served):
    from repro_torch.serving import ShardClient
    fleet, servers = served
    [s for s in servers if s.shard_idx == 0][0].stop()
    client = ShardClient(fleet.peers[-1], model.cfg, "svc", n_shards=2)
    toks = _random_tokens(3, (1, 8))

    def run():
        return (yield from client.score(toks))
    remote = fleet.sim.run_process(run(), until=fleet.sim.now + 900)
    np.testing.assert_allclose(remote, _jax_forward(model, toks), atol=1e-4,
                               rtol=1e-4)
    assert client.stats["failovers"] >= 1


# ------------------------------------------------------- router twins

def test_router_prefers_fast_provider_and_ewma_recovers():
    from repro_torch.core.simnet import Sim
    from repro_torch.serving import LoadAwareRouter
    router = LoadAwareRouter(Sim(seed=4), alpha=0.3, explore=0.0)
    key = ("shard", 0)
    for _ in range(6):
        router.observe(key, "fast", 0.010, ok=True)
        router.observe(key, "slow", 0.200, ok=True)
    assert router.rank(key, ["slow", "fast"])[0] == "fast"
    assert router.score(key, "slow") > router.score(key, "fast")
    for _ in range(20):
        router.observe(key, "slow", 0.002, ok=True)
    assert router.rank(key, ["slow", "fast"])[0] == "slow"


def test_router_error_rate_and_inflight_penalize():
    from repro_torch.core.simnet import Sim
    from repro_torch.serving import LoadAwareRouter
    router = LoadAwareRouter(Sim(seed=5), alpha=0.3, explore=0.0)
    key = ("shard", 1)
    router.observe(key, "a", 0.010, ok=True)
    router.observe(key, "b", 0.010, ok=True)
    base = router.score(key, "a")
    router.observe(key, "a", 0.010, ok=False)
    assert router.score(key, "a") > base
    assert router.rank(key, ["a", "b"])[0] == "b"
    base_b = router.score(key, "b")
    router.begin(key, "b")
    assert router.score(key, "b") > base_b
    router.end(key, "b")
    assert router.score(key, "b") == base_b


# -------------------------------------------- port twins: batched plane

@pytest.fixture(scope="module")
def served_v2(model):
    from repro_torch.core.fleet import make_fleet
    from repro_torch.serving import serve_fleet

    fleet = make_fleet(10, seed=21, same_region="us")
    sim = fleet.sim
    servers = sim.run_process(
        serve_fleet(fleet.peers[:4], model.cfg, model.params, "svc",
                    replicas=2, n_slots=4), until=sim.now + 900)
    return fleet, servers


def test_batched_greedy_matches_engine_no_kv_bleed(model, served_v2):
    from repro_torch.serving import ShardClient
    fleet, servers = served_v2
    client = ShardClient(fleet.peers[-1], model.cfg, "svc", n_shards=2)
    prompts = _prompts(range(6))

    def run():
        return (yield from client.generate_concurrent(
            [dict(tokens=p, n_tokens=6) for p in prompts]))
    outs = fleet.sim.run_process(run(), until=fleet.sim.now + 900)
    for p, o in zip(prompts, outs):
        assert o is not None
        np.testing.assert_array_equal(o, jax_tokens(model, p, 6, 32))
    assert client.stats["failed_sessions"] == 0
    assert any(s.engine.stats["step_sessions"] > s.engine.stats["steps"]
               for s in servers)


def test_same_prompt_different_temperatures_diverge(model, served_v2):
    from repro_torch.serving import ShardClient
    fleet, _ = served_v2
    client = ShardClient(fleet.peers[-2], model.cfg, "svc", n_shards=2)
    (prompt,) = _prompts([9])

    def run():
        return (yield from client.generate_concurrent([
            dict(tokens=prompt, n_tokens=8, temperature=0.0),
            dict(tokens=prompt, n_tokens=8, temperature=1.5, seed=7)]))
    greedy, sampled = fleet.sim.run_process(run(), until=fleet.sim.now + 900)
    assert greedy is not None and sampled is not None
    np.testing.assert_array_equal(greedy, jax_tokens(model, prompt, 8, 32))
    assert not np.array_equal(greedy, sampled)


def test_mid_generation_kill_migrates_sessions(model, served_v2):
    from repro_torch.serving import ShardClient
    fleet, servers = served_v2
    sim = fleet.sim
    client = ShardClient(fleet.peers[-1], model.cfg, "svc", n_shards=2)
    prompts = _prompts(range(20, 26))

    def run():
        evs = [client.submit(p, 48) for p in prompts]
        busy = []
        for _ in range(200):
            yield sim.timeout(0.01)
            busy = [s for s in servers if s.alive and s.shard_idx == 0
                    and s.engine.slots_used > 0]
            if busy:
                break
        assert busy, "no busy shard-0 replica to kill"
        busy[0].stop()
        res = []
        for ev in evs:
            res.append((yield ev))
        return res
    outs = sim.run_process(run(), until=sim.now + 1800)
    for p, o in zip(prompts, outs):
        assert o is not None
        np.testing.assert_array_equal(o, jax_tokens(model, p, 48, 64))
    assert client.stats["failed_sessions"] == 0
    assert client.stats["sessions_migrated"] >= 1


def test_pressure_monitor_spawns_replica_on_hot_shard(model, served_v2):
    from repro_torch.serving import PressureMonitor, ShardClient
    fleet, _ = served_v2
    sim = fleet.sim
    client = ShardClient(fleet.peers[-1], model.cfg, "svc", n_shards=2)
    idle = fleet.peers[5]
    mon = PressureMonitor(idle, model.cfg, "svc", hot_occupancy=0.5,
                          sustain=2, interval=0.15, max_replicas=4,
                          n_slots=4, device="cpu")
    sim.process(mon.run())
    prompts = _prompts(range(40, 48))

    def run():
        return (yield from client.generate_concurrent(
            [dict(tokens=prompts[i % len(prompts)], n_tokens=48)
             for i in range(24)]))
    outs = sim.run_process(run(), until=sim.now + 3600)
    for _ in range(400):
        if mon.stats["spawned"] or mon.stats["fetch_failures"]:
            break
        sim.run(until=sim.now + 0.25)
    mon.stop()
    assert all(o is not None for o in outs)
    assert mon.stats["observations"] > 0
    assert mon.stats["spawned"] >= 1
    spawned = getattr(idle, "shard_servers", [])
    assert spawned and all(s.alive for s in spawned)
    for s in spawned:
        assert s.engine.device == torch.device("cpu")
        assert all(t.device.type == "cpu"
                   for _, t in chip_smoke.named_leaves(s.module.params))


# ------------------------------------------------------- the mixed fleet

#: reference ``repro.core`` modules, each aliased to the port's module of
#: the same name
CORE_MODULES = sorted(p.stem for p in (SRC / "repro" / "core").glob("*.py")
                      if p.stem != "__init__")


def install_alias():
    """Point ``repro.core`` and every ``repro.core.<m>`` at the port's
    modules.  Must run before anything imports ``repro.core``."""
    bad = sorted(m for m in sys.modules if m.split(".")[0] == "repro")
    assert not bad, f"the JAX package was imported first: {bad}"
    import repro_torch.core as pcore
    for m in CORE_MODULES:
        importlib.import_module(f"repro_torch.core.{m}")
    sys.modules["repro.core"] = pcore
    for m in CORE_MODULES:
        sys.modules[f"repro.core.{m}"] = sys.modules[f"repro_torch.core.{m}"]
    import repro
    repro.core = pcore


def install_shim(on=True):
    """Point ``repro.checkpoint.lattica_ckpt``'s ``pickle`` global at the
    port's ``wire_dumps`` (``on``), or back at ``pickle``."""
    from repro.checkpoint import lattica_ckpt
    from repro_torch.core.safepickle import wire_dumps
    lattica_ckpt.pickle = SimpleNamespace(dumps=wire_dumps) if on else pickle


def _mixed_fleet(seed):
    """``make_fleet(10, same_region="us")`` of the (aliased) mesh."""
    from repro.core.fleet import make_fleet
    from repro.core.simnet import Sim
    return make_fleet(10, same_region="us", sim=Sim(seed=seed))


def _fresh_all():
    import repro.serving.sharded as jsh
    import repro_torch.serving.sharded as psh
    from repro_torch import core
    chip_smoke.fresh_counters(SimpleNamespace(
        simnet=core.simnet, nat=core.nat, pubsub=core.pubsub,
        traversal=core.traversal))
    jsh._session_seq = itertools.count(1)
    psh._session_seq = itertools.count(1)


def _shard_server(pkg, node, cfg, params, fleet, idx, n_shards, n_slots=4):
    """Shard ``idx`` of ``params`` (the package's own split) served by
    ``pkg``'s ``ShardServer`` on ``node``."""
    plan = pkg.sharded.plan_shards(cfg, n_shards)
    part = pkg.sharded.split_params(cfg, params, plan)[idx]
    module = pkg.sharded.ShardModule(cfg, part, plan[idx], is_first=idx == 0,
                                     is_last=idx == n_shards - 1)
    return pkg.sharded.ShardServer(node, cfg, fleet, idx, module,
                                   n_slots=n_slots)


def _generate(sim, client, prompts, n):
    def run():
        return (yield from client.generate_concurrent(
            [dict(tokens=p, n_tokens=n) for p in prompts]))
    return sim.run_process(run(), until=sim.now + 1800)


def mixed_a(model, jax_pkg):
    """(a) The JAX package's scenario under the alias and the shim; then,
    without the shim, a JAX publisher's root meta names the port's class
    and ``safe_meta_loads`` refuses it."""
    _fresh_all()
    out = served_v2_scenario(jax_pkg, model.jcfg, model.jparams)
    install_shim(False)
    try:
        sim = jax_pkg.simnet.Sim(seed=5)
        fleet = jax_pkg.fleet.make_fleet(2, same_region="us", sim=sim)
        root = sim.run_process(jax_pkg.ckpt.publish_checkpoint(
            fleet.peers[0], {"w": np.ones(4, np.float32)}, 1, "m"))
        from repro.core.cid import decode_manifest_v2
        meta = decode_manifest_v2(fleet.peers[0].blockstore.peek(root))[2]
        try:
            jax_pkg.ckpt.safe_meta_loads(meta)
            out["unshimmed_meta"] = "read"
        except ValueError as e:
            out["unshimmed_meta"] = f"refused: {e}"
        out["unshimmed_names_port"] = b"repro_torch.core.dht" in meta
        out["unshimmed_chunk_spec"] = repr(
            jax_pkg.ckpt.chunk_spec_of(fleet.peers[0], root))
    finally:
        install_shim(True)
    return out


def _fetch_trees(sim, jax_pkg, nodes_pkgs, root, model):
    """Each node fetches ``root`` with its own package's
    ``fetch_checkpoint``; returns the trees in node order."""
    def run():
        trees = []
        for node, pkg in nodes_pkgs:
            like = model.jparams if pkg is jax_pkg else model.params
            tree = yield from pkg.ckpt.fetch_checkpoint(node, root, like)
            trees.append(tree)
        return trees
    return sim.run_process(run(), until=sim.now + 900)


def mixed_b(model, jax_pkg, port_pkg):
    """(b) One CID published by ``publish_checkpoint`` (the JAX package's,
    shimmed); every serving node fetches it with its own package's
    ``fetch_checkpoint`` and ``split_params``.  Fleet ``ab``: JAX shard 0,
    torch shard 1, the port's client.  Fleet ``ba``: torch shard 0, JAX
    shard 1, the JAX client.  Six sessions each."""
    _fresh_all()
    fleet = _mixed_fleet(31)
    sim, p = fleet.sim, fleet.peers
    root = sim.run_process(jax_pkg.ckpt.publish_checkpoint(
        p[0], _numpy_tree(model.jparams), 1, "mixed"), until=sim.now + 600)
    trees = _fetch_trees(sim, jax_pkg,
                         [(p[1], jax_pkg), (p[2], port_pkg),
                          (p[3], port_pkg), (p[4], jax_pkg)], root, model)
    servers = [
        _shard_server(jax_pkg, p[1], model.jcfg, trees[0], "ab", 0, 2),
        _shard_server(port_pkg, p[2], model.cfg, trees[1], "ab", 1, 2),
        _shard_server(port_pkg, p[3], model.cfg, trees[2], "ba", 0, 2),
        _shard_server(jax_pkg, p[4], model.jcfg, trees[3], "ba", 1, 2)]

    def announce():
        for s in servers:
            yield from s.announce()
    sim.run_process(announce(), until=sim.now + 600)
    prompts = _prompts(range(60, 66))
    out = {"root": chip_smoke.cid_hex(root),
           "kinds": [type(s).__module__ for s in servers],
           "leaf_types": [type(next(chip_smoke.named_leaves(t))[1]).__module__
                          for t in trees]}
    for name, pkg, cfg, peer in (("ab", port_pkg, model.cfg, p[9]),
                                 ("ba", jax_pkg, model.jcfg, p[8])):
        client = pkg.sharded.ShardClient(peer, cfg, name, n_shards=2)
        outs = _generate(sim, client, prompts, 6)
        out[name] = {"tokens": [None if o is None else o.tolist()
                                for o in outs], "stats": dict(client.stats)}
    out["want"] = [jax_tokens(model, q, 6, 32).tolist() for q in prompts]
    out["served"] = [s.engine.stats["admitted"] for s in servers]
    return out


def _numpy_tree(tree):
    """A JAX tree as nested dicts of numpy arrays."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def mixed_c(model, jax_pkg, port_pkg):
    """(c) Each shard has a JAX and a torch replica; a busy torch replica
    is stopped mid-decode; the port's client drives."""
    _fresh_all()
    fleet = _mixed_fleet(32)
    sim, p = fleet.sim, fleet.peers
    jtree, ptree = _numpy_tree(model.jparams), model.params
    servers = [
        _shard_server(jax_pkg, p[0], model.jcfg, jtree, "mix", 0, 2),
        _shard_server(port_pkg, p[1], model.cfg, ptree, "mix", 0, 2),
        _shard_server(port_pkg, p[2], model.cfg, ptree, "mix", 1, 2),
        _shard_server(jax_pkg, p[3], model.jcfg, jtree, "mix", 1, 2)]

    def announce():
        for s in servers:
            yield from s.announce()
    sim.run_process(announce(), until=sim.now + 600)
    client = port_pkg.sharded.ShardClient(p[9], model.cfg, "mix", n_shards=2)
    prompts = _prompts(range(70, 76))
    killed = []

    def run():
        evs = [client.submit(q, 48) for q in prompts]
        for _ in range(400):
            yield sim.timeout(0.01)
            busy = [s for s in servers if s.alive and s.engine.slots_used
                    and type(s).__module__.startswith("repro_torch")]
            if busy:
                killed.append((busy[0].shard_idx, sim.now,
                               busy[0].engine.slots_used))
                busy[0].stop()
                break
        res = []
        for ev in evs:
            res.append((yield ev))
        return res
    outs = sim.run_process(run(), until=sim.now + 1800)
    return {"killed": killed, "stats": dict(client.stats),
            "tokens": [None if o is None else o.tolist() for o in outs],
            "want": [jax_tokens(model, q, 48, 64).tolist() for q in prompts],
            "admitted": [(type(s).__module__, s.shard_idx,
                          s.engine.stats["admitted"]) for s in servers]}


def mixed_d(model, jax_pkg, port_pkg):
    """(d) The JAX ``serve_fleet`` publishes the serving plan; a port
    ``PressureMonitor`` (``device="cpu"``) spawns a torch replica from it
    under load; then the hot shard's JAX replicas are stopped and the
    torch replica alone serves that shard."""
    _fresh_all()
    # the JAX pressure test's fleet; under this load a draw such as seed 33
    # leaves abandoned admissions queued on a shard-0 replica, draining at
    # the reaper's pace, in the JAX package alone as here
    fleet = _mixed_fleet(21)
    sim, p = fleet.sim, fleet.peers
    servers = sim.run_process(jax_pkg.sharded.serve_fleet(
        p[:4], model.jcfg, model.jparams, "svc", replicas=2, n_slots=4),
        until=sim.now + 900)
    mon = port_pkg.pressure.PressureMonitor(
        p[5], model.cfg, "svc", hot_occupancy=0.5, sustain=2, interval=0.15,
        max_replicas=4, n_slots=4, device="cpu")
    sim.process(mon.run())
    client = jax_pkg.sharded.ShardClient(p[-1], model.jcfg, "svc",
                                         n_shards=2)
    prompts = _prompts(range(40, 48))
    outs = _generate(sim, client, [prompts[i % 8] for i in range(24)], 48)
    for _ in range(400):
        if mon.stats["spawned"] or mon.stats["fetch_failures"]:
            break
        sim.run(until=sim.now + 0.25)
    mon.stop()
    spawned = list(mon.spawned)
    out = {"stats": dict(mon.stats), "all_done": all(o is not None
                                                     for o in outs),
           "spawned": [(type(s).__module__, s.shard_idx,
                        str(s.engine.device),
                        sorted({str(t.device) for _, t in
                                chip_smoke.named_leaves(s.module.params)}))
                       for s in spawned]}
    if spawned:
        hot = spawned[0].shard_idx
        for s in servers:
            if s.shard_idx == hot:
                s.stop()
        solo = jax_pkg.sharded.ShardClient(p[-2], model.jcfg, "svc",
                                           n_shards=2)
        few = _prompts(range(80, 83))
        out["solo"] = [None if o is None else o.tolist()
                       for o in _generate(sim, solo, few, 6)]
        out["solo_want"] = [jax_tokens(model, q, 6, 32).tolist()
                            for q in few]
        out["solo_admitted"] = spawned[0].engine.stats["admitted"]
    return out


def mixed_main(out_path):
    """The subprocess: the alias, the shim, then cases (a)-(d), their
    readings pickled to ``out_path``."""
    install_alias()
    import repro.serving.sharded  # noqa: F401  (the JAX serving modules)
    torch.set_num_threads(1)
    install_shim(True)
    import jax

    from repro.configs import get_config as jax_get_config
    from repro.models import ops_for
    from repro_torch.configs import get_config

    jcfg = jax_get_config("granite-8b").reduced(**FLEET_KW)
    jops = ops_for(jcfg)
    jparams = jops.init(jcfg, jax.random.PRNGKey(0))
    model = SimpleNamespace(
        jcfg=jcfg, jops=jops, jparams=jparams,
        cfg=get_config("granite-8b").reduced(**FLEET_KW),
        params=params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu"))
    jax_pkg, port_pkg = _pkg("repro"), _pkg("repro_torch")
    assert jax_pkg.simnet is port_pkg.simnet
    assert jax_pkg.sharded is not port_pkg.sharded
    res = {"aliased": sorted(m for m in sys.modules
                             if m.startswith("repro.core")
                             and sys.modules[m].__name__.startswith(
                                 "repro_torch.core"))}
    for name, fn in (("a", lambda: mixed_a(model, jax_pkg)),
                     ("b", lambda: mixed_b(model, jax_pkg, port_pkg)),
                     ("c", lambda: mixed_c(model, jax_pkg, port_pkg)),
                     ("d", lambda: mixed_d(model, jax_pkg, port_pkg))):
        res[name] = fn()
    with open(out_path, "wb") as f:
        pickle.dump(res, f)


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    """Cases (a)-(d), run once in a subprocess of ``sys.executable``."""
    out = tmp_path_factory.mktemp("mixed") / "mixed.pkl"
    code = ("import sys\n"
            f"sys.path[:0] = [{str(SRC)!r}, {str(ROOT)!r}, "
            f"{str(ROOT / 'tests')!r}]\n"
            "import test_torch_fleet\n"
            f"test_torch_fleet.mixed_main({str(out)!r})\n")
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    with open(out, "rb") as f:
        return pickle.load(f)


def test_mixed_alias_covers_every_core_module(mixed):
    assert mixed["aliased"] == sorted(["repro.core"] + [
        f"repro.core.{m}" for m in CORE_MODULES])


def test_mixed_a_the_pin(mixed, jax_served_v2):
    """Under the alias and the shim, the JAX package's scenario is the
    unaliased run: client calls, simulated end time, tokens, trace digest,
    events and dashboard.  Without the shim, a JAX publisher's meta
    pickles the port's ``PeerInfo`` under its own module name, and
    ``safe_meta_loads`` refuses it (``chunk_spec_of`` then silently gives
    None): the shim is what lets nodes read a JAX node's meta."""
    a, ref = mixed["a"], jax_served_v2
    assert a["stats"]["calls"] == ref["stats"]["calls"] == 54
    assert a["end"] == ref["end"] == 29.183536000788852
    for key in ref:
        assert a[key] == ref[key], key
    assert a["unshimmed_meta"].startswith("refused")
    assert a["unshimmed_names_port"]
    assert a["unshimmed_chunk_spec"] == "None"


def test_mixed_b_one_cid_both_directions(mixed):
    """JAX shard 0 with torch shard 1 under the port's client, and torch
    shard 0 with JAX shard 1 under the JAX client, each node serving what
    its own package fetched from one root CID: the JAX
    ``GenerationEngine``'s greedy tokens, not all one token."""
    b = mixed["b"]
    assert b["kinds"] == ["repro.serving.sharded",
                          "repro_torch.serving.sharded",
                          "repro_torch.serving.sharded",
                          "repro.serving.sharded"]
    assert b["leaf_types"][1] == b["leaf_types"][2] == "torch"
    for fleet in ("ab", "ba"):
        assert b[fleet]["tokens"] == b["want"], fleet
        assert b[fleet]["stats"]["failed_sessions"] == 0
        assert b[fleet]["stats"]["completed"] == 6
    assert len({t for row in b["want"] for t in row}) > 1
    assert all(n >= 6 for n in b["served"])


def test_mixed_c_torch_shard_kill(mixed):
    c = mixed["c"]
    assert c["killed"], "no busy torch replica to kill"
    assert c["stats"]["failed_sessions"] == 0
    assert c["stats"]["sessions_migrated"] >= 1
    assert c["tokens"] == c["want"]
    # both packages' replicas served
    assert all(n > 0 for *_, n in c["admitted"])


def test_mixed_d_pressure_across_packages(mixed):
    d = mixed["d"]
    assert d["all_done"]
    assert d["stats"]["spawned"] >= 1
    assert all(kind == "repro_torch.serving.sharded" and dev == "cpu"
               and leaf_devs == ["cpu"]
               for kind, _, dev, leaf_devs in d["spawned"])
    assert d["solo"] == d["solo_want"]
    assert d["solo_admitted"] >= 3


# --------------------------------------------------- the smoke's fleet phase

def test_fleet_phase_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.fleet_phase`` end to end at a reduced width on the CPU,
    gates F1-F3 as written, with the attention kernels' plain versions
    counted as their launches."""
    from repro_torch.configs import get_config
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
    tree = decoder.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    *_, reference = chip_smoke.same_served_tokens(torch, cfg, tree, tree,
                                                  "M3", "cpu")
    chip_smoke.fleet_phase(torch, tree, reference, 0.0, device="cpu",
                           cfg=cfg)
    (line,) = lines
    assert line["phase"] == "fleet"
    assert line["f1"]["failed_sessions"] == 0
    assert line["f2"]["sessions_migrated"] >= 1
    assert line["f3"]["launches"]["flash_attention"] > 0
    assert line["f3"]["launches"]["paged_decode_attention"] > 0
    assert line["f3"]["launches"] == line["f3"]["predicted"]
    assert set(line["rpc_sim_s"]) == {"open", "step"}
