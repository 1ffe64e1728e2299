"""The port's mesh trainers and DiLoCo collaborative training against the
JAX package's, and the two packages in one collaborative fleet.

``repro_torch.train.compress``, ``repro_torch.train.collab`` and the
``LatticaSyncTrainer`` and ``ModelSubscriber`` classes of
``repro_torch.train.trainer`` are copies of the JAX package's, checked here
by machine:

* **Copy fidelity.** Each copy's syntax tree equals its reference's once
  import paths are mapped, the module docstring's one added paragraph is
  taken out, the definitions of ``COPY_ADDED`` are taken out of the port
  and the lines of ``COPY_LINES`` are applied to the reference; each
  listed line carries its reason and is needed.
* **Exact against JAX.** Compression, decoding, averaging, digests, the
  outer step and ``tree_to_flat`` of a crossed tree equal the JAX
  package's to the bit, and the smoke's ``COLLAB_GOLDEN`` is re-derived
  through it.
* **Port twins** of ``test_collab.py`` and of ``test_train.py``'s mesh
  test, with the reference's assertions; one round's pseudo-gradients
  against JAX workers'; a sanitized double run; the round-start seam.
* **The mixed fleet**, in a subprocess under ``test_torch_fleet``'s alias
  and shim: JAX and torch workers in one DiLoCo fleet, a torch worker
  rejoining onto the JAX workers' outer state, and checkpoints crossing
  between a ``LatticaSyncTrainer`` and a ``ModelSubscriber`` of the other
  package.
* **The smoke's collab phase**, rehearsed on the CPU at a reduced width.

Nothing of the JAX package is imported at the top of this file, so that
the subprocess can install the alias before it imports the JAX package.
"""

import ast
import dataclasses
import math
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
from repro_torch.params import params_from_numpy, train_state_from_numpy
from test_torch_fleet import _defined, _parsed

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
#: ``test_torch_train.py``'s tolerances: optimizer outputs (absolute),
#: a step's loss (relative)
OPT_TOL = 1e-6
STEP_RTOL = 1e-5
#: the reduced minicpm-2b of ``test_collab.py``
SMALL = dict(n_layers=2, d_model=64, vocab=128)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The workers' tensors are tiny: one intra-op thread runs them tens of
    times faster than a pool that waits on its workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ------------------------------------------------------------ copy fidelity

#: the copies, by path under each package
COPIES = ["train/compress.py", "train/collab.py", "train/trainer.py"]

#: the definitions of ``trainer.py`` that are copies (its ``Trainer`` is
#: the port's own)
TRAINER_COPIED = ["LatticaSyncTrainer", "ModelSubscriber"]

#: every line where a copy differs from its reference beyond the import
#: paths and the docstring: (file, reference text, port text, reason),
#: written in the reference's import form
COPY_LINES = [
    ("train/compress.py",
     "from repro.checkpoint.serial import (_sorted_leaves, encode_leaf_meta,",
     "from repro.checkpoint.serial import (_host, _sorted_leaves, "
     "encode_leaf_meta,", "imports _host"),
    ("train/compress.py", "np.asarray(arr, dtype=np.float32)",
     "np.asarray(_host(arr.float()), dtype=np.float32)",
     "a leaf is a tensor, maybe on the card and requiring grad: _host "
     "detaches it and copies it to the host once; .float() reads a bfloat16 "
     "leaf's values, not its raw 16-bit patterns"),
    ("train/compress.py", "sent[name] = leaf_from_part(raw, meta)\n",
     "sent[name] = leaf_from_part(raw, meta).numpy()\n",
     "the port's leaf_from_part returns a CPU tensor; sent is a float32 "
     "array, as the reference's"),
    ("train/compress.py",
     "return {name: leaf_from_part(raw, meta) for name, raw, meta in pairs}",
     "return {name: leaf_from_part(raw, meta).numpy() for name, raw, meta "
     "in pairs}", "a decoded flat is float32 arrays, as the reference's"),
    ("train/collab.py", "        self._like = state.params\n", "",
     "no tree is kept for its structure alone: _params_like reads the "
     "structure, device and dtype of the worker's current tree, so the "
     "first tree is freed after round 0 instead of staying on the card "
     "beside the live state"),
    ("train/compress.py",
     "    return {k: (start[k].astype(np.float64)\n"
     "                - end[k].astype(np.float64)).astype(np.float32)\n",
     "    return {k: _blockwise(lambda s, e: (s.astype(np.float64)\n"
     "                                       - e.astype(np.float64)).astype(\n"
     "                                           np.float32), start[k], end[k])\n",
     "the same float64 difference, in blocks: no whole-leaf float64 "
     "temporaries (two of 2.3 GB for minicpm-2b's embedding), same bits"),
    ("train/compress.py",
     "    for k in sorted(grads[0]):\n"
     "        acc = np.zeros(grads[0][k].shape, np.float64)\n"
     "        for g in grads:\n"
     "            acc += g[k].astype(np.float64)\n"
     "        out[k] = (acc / len(grads)).astype(np.float32)\n",
     "    def mean(*blocks: np.ndarray) -> np.ndarray:\n"
     "        acc = np.zeros(blocks[0].shape, np.float64)\n"
     "        for b in blocks:\n"
     "            acc += b.astype(np.float64)\n"
     "        return (acc / len(blocks)).astype(np.float32)\n"
     "    for k in sorted(grads[0]):\n"
     "        out[k] = _blockwise(mean, *(g[k] for g in grads))\n",
     "the same float64 sum in the same order, in blocks: same bits"),
    ("train/collab.py", "import jax\nimport numpy as np\n",
     "import numpy as np\nimport torch\n",
     "the inner steps run on torch; the outer math stays numpy"),
    ("train/collab.py", "from repro.core.bitswap import FetchError\n",
     "from repro.checkpoint.serial import _map_with_path\n"
     "from repro.core.bitswap import FetchError\n",
     "imports _map_with_path for _params_like"),
    ("train/collab.py",
     "from .compress import (average_flat, compress_pseudograd, flat_digest,\n"
     "                       flat_from_entries, pseudo_gradient, tree_to_flat)\n",
     "from .compress import (_blockwise, average_flat, compress_pseudograd,\n"
     "                       flat_digest, flat_from_entries, pseudo_gradient,\n"
     "                       tree_to_flat)\n", "imports _blockwise"),
    ("train/collab.py",
     "        for k in sorted(g):\n"
     "            m = mu * self.outer_mom[k].astype(np.float64) \\\n"
     "                + g[k].astype(np.float64)\n"
     "            upd = g[k].astype(np.float64) + mu * m if self.ccfg.nesterov "
     "else m\n"
     "            self.outer_flat[k] = (\n"
     "                self.outer_flat[k].astype(np.float64) - lr * upd\n"
     "            ).astype(np.float32)\n"
     "            self.outer_mom[k] = m.astype(np.float32)\n",
     "\n"
     "        def step(p: np.ndarray, mom: np.ndarray, g: np.ndarray\n"
     "                 ) -> Tuple[np.ndarray, np.ndarray]:\n"
     "            m = mu * mom.astype(np.float64) + g.astype(np.float64)\n"
     "            upd = g.astype(np.float64) + mu * m if self.ccfg.nesterov "
     "else m\n"
     "            return ((p.astype(np.float64) - lr * upd).astype("
     "np.float32),\n"
     "                    m.astype(np.float32))\n"
     "        for k in sorted(g):\n"
     "            self.outer_flat[k], self.outer_mom[k] = _blockwise(\n"
     "                step, self.outer_flat[k], self.outer_mom[k], g[k])\n",
     "the same Nesterov step in float64, in blocks: no whole-leaf float64 "
     "temporaries, same bits"),
    ("train/collab.py", "from repro.models.config import ModelConfig\n",
     "from repro.models.config import ModelConfig\n"
     "from repro.tree import leaves\n", "imports leaves for _eval_loss"),
    ("train/collab.py",
     "self.step_fn = jax.jit(make_train_step(cfg, schedule))",
     "self.step_fn = make_train_step(cfg, schedule)",
     "the port's make_train_step is the step itself, with no jax.jit"),
    ("train/collab.py",
     "self._eval_fn = (jax.jit(lambda p, b: ops.loss_fn(p, cfg, b)[0])",
     "self._eval_fn = (_eval_loss(ops, cfg)",
     "the eval loss moves the numpy batch to the parameters' device and "
     "runs under torch.no_grad()"),
    ("train/collab.py",
     "        from repro.checkpoint.serial import params_from_parts\n"
     "        return params_from_parts(dict(self.outer_flat), self._like)\n",
     "        return _params_like(self.outer_flat, self._state.params)\n",
     "the outer params as fresh tensors on the device of the worker's "
     "current tree; the port's params_from_parts takes tensors, not arrays"),
    ("train/collab.py",
     "        from repro.checkpoint.serial import params_from_parts\n"
     "        self._state = TrainState(\n"
     "            params=params_from_parts(dict(start_flat), self._like),\n",
     "        self._state = TrainState(\n"
     "            params=_params_like(start_flat, self._state.params,\n"
     "                                trainable=True),\n",
     "the round's start as fresh leaves that require grad: the port's AdamW "
     "updates them in place, so leaves sharing memory with start_flat "
     "would overwrite the round's start and zero its pseudo-gradient"),
]

#: top-level definitions a copy adds: (file, name, reason)
COPY_ADDED = [
    ("train/compress.py", "_BLOCK",
     "entries per block of the float64 outer arithmetic"),
    ("train/compress.py", "_blockwise",
     "elementwise numpy over blocks of entries, to the bits of one "
     "whole-array call"),
    ("train/collab.py", "_params_like",
     "numpy outer state -> fresh tensors in the structure, device and dtype "
     "of the worker's current tree"),
    ("train/collab.py", "_eval_loss",
     "the eval loss of a numpy batch under torch.no_grad()"),
]

PARAGRAPH = "The port's own copy of the JAX package's ``{}``"


def _reference(rel, skip=None):
    """The reference's source with ``COPY_LINES`` applied (all but entry
    ``skip``); each reference text must occur exactly once."""
    src = (SRC / "repro" / rel).read_text()
    for i, (f, old, new, _) in enumerate(COPY_LINES):
        if f == rel and i != skip:
            assert src.count(old) == 1, (rel, old)
            src = src.replace(old, new)
    return src


def _copied(tree, rel, added=()):
    """What of module ``tree`` is a copy, as one dump: for ``trainer.py``
    the classes of ``TRAINER_COPIED``, else the module without the
    top-level definitions named in ``added``."""
    if rel == "train/trainer.py":
        defs = {_defined(s): s for s in tree.body if _defined(s)}
        return "\n".join(ast.dump(defs[n]) for n in TRAINER_COPIED)
    tree.body = [s for s in tree.body if _defined(s) not in added]
    return ast.dump(tree)


def _added(rel):
    return {name for f, name, _ in COPY_ADDED if f == rel}


def _port_dump(rel):
    tree, doc = _parsed((SRC / "repro_torch" / rel).read_text(), rel,
                        "repro_torch")
    names = {_defined(s) for s in tree.body}
    assert _added(rel) <= names, rel
    return _copied(tree, rel, _added(rel)), doc


@pytest.mark.parametrize("rel", COPIES)
def test_copy_is_the_reference(rel):
    """The copy's syntax tree is the reference's, apart from import paths,
    the docstring's one added paragraph, the listed lines and the listed
    added definitions."""
    ref_tree, ref_doc = _parsed(_reference(rel), rel, "repro")
    assert not _added(rel) & {_defined(s) for s in ref_tree.body}
    got, port_doc = _port_dump(rel)
    assert got == _copied(ref_tree, rel), rel
    if rel == "train/trainer.py":
        # the module is the port's own; its docstring names the copies
        assert all(f"``{n}``" in port_doc for n in TRAINER_COPIED)
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
    for f, name, why in COPY_ADDED:
        print(f"  {f} | + {name} | {why}")
    assert all(why for *_, why in COPY_LINES + COPY_ADDED)
    for i, (rel, *_rest) in enumerate(COPY_LINES):
        tree, _ = _parsed(_reference(rel, skip=i), rel, "repro")
        assert _copied(tree, rel) != _port_dump(rel)[0], COPY_LINES[i]


def test_train_package_exports_the_references_names():
    import repro.train
    import repro_torch.train
    assert repro_torch.train.__all__ == repro.train.__all__
    for name in repro_torch.train.__all__:
        assert getattr(repro_torch.train, name).__module__.startswith(
            "repro_torch.train")


# ------------------------------------------------------ exact against JAX

def _grads(seed=3):
    """Seeded pseudo-gradients: a leaf under ``SPARSE_MIN_SIZE``, one at
    it, one of 4097 entries, a 2-D one, one of exact magnitude ties and
    one all zero."""
    rng = np.random.default_rng(seed)
    ties = rng.choice(np.float32([-1.0, -0.5, 0.5, 1.0]), size=(64, 32))
    return {"a/w": rng.normal(size=(200, 64)).astype(np.float32),
            "b/w": rng.normal(size=(4097,)).astype(np.float32),
            "edge": rng.normal(size=(256,)).astype(np.float32),
            "tiny": rng.normal(size=(8,)).astype(np.float32),
            "ties": ties.astype(np.float32),
            "zero": np.zeros((300,), np.float32)}


def _same_flat(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert type(a[k]) is np.ndarray and a[k].dtype == np.float32, k
        assert a[k].shape == b[k].shape, k
        assert np.array_equal(a[k].view(np.uint32), b[k].view(np.uint32)), k


COMPRESS_CASES = [(0.05, "int8_block"), (1 / 80, "int8_block"), (0.05, None),
                  (1.0, "int8_block")]


@pytest.mark.parametrize("frac,quant", COMPRESS_CASES)
def test_compress_matches_jax(frac, quant):
    """Byte-identical parts, bit-equal ``sent`` and equal stats, exact
    magnitude ties included."""
    from repro.train import compress as jc
    from repro_torch.train import compress as pc
    grads = _grads()
    jparts, jsent, jstats = jc.compress_pseudograd(grads, frac, quant)
    pparts, psent, pstats = pc.compress_pseudograd(grads, frac, quant)
    assert pparts == jparts
    _same_flat(psent, jsent)
    assert pstats == jstats


@pytest.mark.parametrize("nesterov", [True, False])
def test_decode_average_digest_and_outer_step_match_jax(nesterov):
    from repro.train import compress as jc
    from repro.train.collab import CollabWorker as JaxWorker
    from repro_torch.train import compress as pc
    from repro_torch.train.collab import CollabWorker
    parts = [jc.compress_pseudograd(_grads(s), 0.05, "int8_block")[0]
             for s in (3, 4, 5)]
    jflats = [jc.flat_from_entries(p) for p in parts]
    pflats = [pc.flat_from_entries(p) for p in parts]
    for a, b in zip(pflats, jflats):
        _same_flat(a, b)
    javg, pavg = jc.average_flat(jflats), pc.average_flat(pflats)
    _same_flat(pavg, javg)
    assert pc.flat_digest(pavg) == jc.flat_digest(javg)
    start = _grads(9)
    outs = []
    for cls in (JaxWorker, CollabWorker):
        w = SimpleNamespace(
            ccfg=SimpleNamespace(outer_lr=0.7, outer_momentum=0.9,
                                 nesterov=nesterov),
            outer_flat=dict(start),
            outer_mom={k: np.full_like(v, 0.25) for k, v in start.items()})
        for _ in range(2):
            cls._outer_step(w, javg)
        outs.append(w)
    _same_flat(outs[1].outer_flat, outs[0].outer_flat)
    _same_flat(outs[1].outer_mom, outs[0].outer_mom)


@pytest.mark.parametrize("block", [1000, 4096])
def test_blockwise_outer_math_matches_jax(monkeypatch, block):
    """With blocks smaller than the leaves (a partial last block
    included), the port's pseudo-gradient, average and outer step are the
    JAX package's whole-array ones, to the bit."""
    from repro.train import compress as jc
    from repro.train.collab import CollabWorker as JaxWorker
    from repro_torch.train import compress as pc
    from repro_torch.train.collab import CollabWorker
    monkeypatch.setattr(pc, "_BLOCK", block)
    start, end = _grads(9), _grads(10)
    grads = [pc.pseudo_gradient(start, end), _grads(11)]
    _same_flat(grads[0], jc.pseudo_gradient(start, end))
    avg = pc.average_flat(grads)
    _same_flat(avg, jc.average_flat(grads))
    outs = []
    for cls in (JaxWorker, CollabWorker):
        w = SimpleNamespace(
            ccfg=SimpleNamespace(outer_lr=0.7, outer_momentum=0.9,
                                 nesterov=True),
            outer_flat=dict(start),
            outer_mom={k: np.full_like(v, 0.25) for k, v in start.items()})
        for _ in range(2):
            cls._outer_step(w, avg)
        outs.append(w)
    _same_flat(outs[1].outer_flat, outs[0].outer_flat)
    _same_flat(outs[1].outer_mom, outs[0].outer_mom)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tree_to_flat_of_a_crossed_tree_matches_jax(dtype):
    """``tree_to_flat`` of a tree crossed from JAX, its leaves requiring
    grad: the JAX package's flat, to the bit."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget
    from repro.models import ops_for
    from repro.train import compress as jc
    from repro_torch.train import compress as pc
    jcfg = jget("minicpm-2b").reduced(**SMALL)
    jparams = jax.tree.map(lambda a: a.astype(jnp.dtype(dtype)),
                           ops_for(jcfg).init(jcfg, jax.random.PRNGKey(0)))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    for _, t in chip_smoke.named_leaves(params):
        t.requires_grad_(True)
    _same_flat(pc.tree_to_flat(params), jc.tree_to_flat(jparams))


def test_collab_golden_constants():
    """Gate D2's constants, re-derived through the JAX package's
    ``compress`` and ``CollabWorker._outer_step`` and through the port's,
    on gate C1's tree and the same tree from seed + 1."""
    import jax.numpy as jnp

    from repro.train import compress as jc
    from repro.train.collab import CollabWorker as JaxWorker
    from repro_torch.configs import get_config
    from repro_torch.models import decoder
    from repro_torch.train import compress as pc
    from repro_torch.train.collab import CollabWorker
    cfg = get_config("minicpm-2b").reduced(**chip_smoke.T2_REDUCED)
    like = decoder.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    a = chip_smoke.golden_numpy_tree(like)
    b = chip_smoke.golden_numpy_tree(like, chip_smoke.CKPT_GOLDEN_SEED + 1)

    def jnp_tree(t):
        return {k: jnp_tree(v) if isinstance(v, dict) else jnp.asarray(v)
                for k, v in t.items()}
    want = chip_smoke.collab_golden(jc, JaxWorker._outer_step, jnp_tree(a),
                                    jnp_tree(b))
    got = chip_smoke.collab_golden(pc, CollabWorker._outer_step,
                                   params_from_numpy(a, "cpu"),
                                   params_from_numpy(b, "cpu"))
    assert want == chip_smoke.COLLAB_GOLDEN
    assert got == want
    assert want["wire_bytes"] <= chip_smoke.COLLAB_WIRE_RATIO * \
        want["dense_bytes"]


# ------------------------------------------------------------- port twins

def _cfg():
    from repro_torch.configs import get_config
    return get_config("minicpm-2b").reduced(**SMALL)


def _make_workers(fleet, cfg, n, ccfg, fleet_name="fleetC"):
    """``test_collab.py``'s workers on the port: one seeded init each, on
    the CPU."""
    from repro_torch.data import make_batch_iterator
    from repro_torch.optim import cosine_schedule
    from repro_torch.train import train_state_init
    from repro_torch.train.collab import CollabWorker
    sched = cosine_schedule(1e-3, 5, 400)
    workers = []
    for i in range(n):
        data = make_batch_iterator(cfg.vocab, 32, global_batch=4,
                                   n_shards=n, shard=i, seed=1)
        workers.append(CollabWorker(
            fleet.peers[i], cfg, train_state_init(
                cfg, torch.Generator().manual_seed(0), "cpu"),
            sched, data, fleet_name, collab=ccfg, step_seconds=0.2))
    return workers


def test_port_compress_roundtrip_and_residual_identity():
    """sent == what receivers decode, so error feedback (grad - sent) is
    exactly the mass the fleet did NOT apply; wire bytes ≈ frac·(idx+val)."""
    from repro_torch.train.compress import (compress_pseudograd,
                                            flat_from_entries)
    rng = np.random.default_rng(3)
    grad = {"a/w": rng.normal(size=(200, 64)).astype(np.float32),
            "b/w": rng.normal(size=(4097,)).astype(np.float32),
            "tiny": rng.normal(size=(8,)).astype(np.float32)}
    parts, sent, stats = compress_pseudograd(grad, frac=0.05,
                                             quant="int8_block")
    decoded = flat_from_entries([(n, raw, meta) for n, raw, meta in parts])
    assert set(decoded) == set(grad)
    for k in grad:
        np.testing.assert_array_equal(decoded[k], sent[k])
    np.testing.assert_array_equal(sent["tiny"], grad["tiny"])
    assert stats["wire_bytes"] < 0.10 * stats["dense_bytes"]
    parts2, _, _ = compress_pseudograd(grad, frac=0.05, quant="int8_block")
    assert [(n, r, m) for n, r, m in parts] == [(n, r, m)
                                               for n, r, m in parts2]


def test_port_pseudo_gradient_and_average_are_deterministic():
    from repro_torch.train.compress import (average_flat, flat_digest,
                                            pseudo_gradient)
    rng = np.random.default_rng(4)
    a = {"w": rng.normal(size=(1000,)).astype(np.float32)}
    b = {"w": (a["w"] + rng.normal(size=(1000,)) * 1e-3).astype(np.float32)}
    g = pseudo_gradient(a, b)
    np.testing.assert_allclose(
        g["w"], (a["w"].astype(np.float64)
                 - b["w"].astype(np.float64)).astype(np.float32))
    avg = average_flat([g, g, g])
    np.testing.assert_array_equal(avg["w"], g["w"])
    assert flat_digest(avg) == flat_digest(g)


def test_port_collab_rounds_converge_bit_identical():
    """4 workers × 3 rounds, no coordinator: one outer digest, zero aborted
    rounds, wire ≤ 0.10× the fp32 bytes, no pin past its window."""
    from repro_torch.core.fleet import make_fleet
    from repro_torch.train.collab import CollabConfig
    cfg = _cfg()
    fleet = make_fleet(6, seed=3, same_region="us")
    sim = fleet.sim
    ccfg = CollabConfig(inner_steps=8, settle=0.5, topk_frac=0.05)
    workers = _make_workers(fleet, cfg, 4, ccfg)
    procs = [sim.process(w.run(3, log=None)) for w in workers]
    sim.run(until=sim.now + 600)
    for p in procs:
        assert p.triggered, "worker process never finished"
        assert not p.failed, p.value
    assert all(w.outer_round == 3 for w in workers)
    assert all(w.stats["rounds_aborted"] == 0 for w in workers)
    assert len({w.outer_digest() for w in workers}) == 1
    ratio = (workers[0].stats["wire_bytes"]
             / workers[0].stats["dense_bytes"])
    assert ratio <= 0.10, f"wire ratio {ratio:.3f} > 0.10"
    assert all(w.overdue_pins() == 0 for w in workers)


def test_port_collab_member_drop_quorum_close_and_rejoin():
    """Worker 3 dies mid-round 1; the quorum closes every round without it
    and the survivors agree.  On rejoin, ``catch_up`` replays the closed
    rounds instead of forking."""
    from repro_torch.core.fleet import make_fleet
    from repro_torch.train.collab import CollabConfig
    cfg = _cfg()
    fleet = make_fleet(6, seed=3, same_region="us")
    sim = fleet.sim
    ccfg = CollabConfig(inner_steps=8, settle=0.5, keep_rounds=4)
    workers = _make_workers(fleet, cfg, 4, ccfg)
    procs = [sim.process(w.run(3, log=None)) for w in workers]

    def killer():
        while not any(h["round"] == 1 for h in workers[3].history):
            yield 0.25
        yield 0.3
        workers[3].stop()

    sim.process(killer(), daemon=True)
    sim.run(until=sim.now + 600)
    for p in procs[:3]:
        assert p.triggered and not p.failed, getattr(p, "value", None)
    assert all(w.outer_round == 3 for w in workers[:3])
    assert all(w.stats["rounds_aborted"] == 0 for w in workers[:3])
    d_surv = {w.outer_digest() for w in workers[:3]}
    assert len(d_surv) == 1
    assert workers[3].outer_round == 1
    assert workers[3].outer_digest() not in d_surv

    rejoin = sim.process(workers[3].run(1, log=None))
    more = [sim.process(w.run(1, log=None)) for w in workers[:3]]
    sim.run(until=sim.now + 600)
    assert rejoin.triggered and not rejoin.failed, rejoin.value
    for p in more:
        assert p.triggered and not p.failed, getattr(p, "value", None)
    assert workers[3].stats["catchup_rounds"] >= 1
    assert len({w.outer_digest() for w in workers}) == 1
    assert all(w.overdue_pins() == 0 for w in workers)


def test_port_collab_status_rpc():
    from repro_torch.core.fleet import make_fleet
    from repro_torch.core.service import RpcStatus, ServiceError
    from repro_torch.train.collab import CollabConfig, CollabService
    cfg = _cfg()
    fleet = make_fleet(6, seed=9, same_region="us")
    sim = fleet.sim
    ccfg = CollabConfig(inner_steps=4, settle=0.5)
    workers = _make_workers(fleet, cfg, 2, ccfg, fleet_name="fleetS")
    procs = [sim.process(w.run(1, log=None)) for w in workers]
    sim.run(until=sim.now + 300)
    for p in procs:
        assert p.triggered and not p.failed, getattr(p, "value", None)

    def probe():
        return (yield from workers[0].peer_status(fleet.peers[1].info()))

    st = sim.run_process(probe(), until=sim.now + 60)
    assert st["round"] == 1
    assert st["digest"] == workers[0].outer_digest()
    assert st["closed"] == 1

    def probe_missing():
        stub = workers[0].node.stub(CollabService, fleet.peers[1].info())
        try:
            yield from stub.status("no-such-fleet")
        except ServiceError as e:
            return e.status
        return None

    assert sim.run_process(probe_missing(), until=sim.now + 60) \
        == RpcStatus.NOT_FOUND


def test_port_mesh_train_publish_subscribe():
    """``test_train.py``'s scenario 3 on the port: the trainer publishes
    versions into the mesh, a subscriber converges on the latest and
    fetches the params."""
    from repro_torch.checkpoint.lattica_ckpt import CheckpointRegistry
    from repro_torch.core.fleet import make_fleet
    from repro_torch.data import make_batch_iterator
    from repro_torch.optim import cosine_schedule
    from repro_torch.train import LatticaSyncTrainer, train_state_init
    from repro_torch.train.trainer import ModelSubscriber
    from repro_torch.tree import leaves
    cfg = _cfg()
    fleet = make_fleet(8, seed=17)
    sim = fleet.sim
    trainer_node, edge_node = fleet.peers[0], fleet.peers[-1]
    data = make_batch_iterator(cfg.vocab, 32, global_batch=4, seed=1)
    state = train_state_init(cfg, torch.Generator().manual_seed(0), "cpu")
    trainer = LatticaSyncTrainer(
        cfg, state, cosine_schedule(1e-3, 5, 100), data, node=trainer_node,
        fleet="fleetX", publish_every=10, step_seconds=0.2)
    sub = ModelSubscriber(edge_node, cfg, "fleetX", like=state.params)
    t_proc = sim.process(trainer.run_mesh(20, log=None))
    sim.process(sub.follow(interval=2.0, until_step=19))
    sim.run(until=sim.now + 600)
    assert t_proc.triggered and not t_proc.failed
    assert sub.current_step == 20
    assert sub.params is not None
    for a, b in zip(leaves(trainer.state.params), leaves(sub.params)):
        assert torch.equal(a.detach(), b)
    assert (CheckpointRegistry(edge_node, "fleetX").latest()
            == CheckpointRegistry(trainer_node, "fleetX").latest())


# --------------------------------------------------- one round against JAX

def _jax_model():
    import jax

    from repro.configs import get_config as jget
    from repro.train import train_state_init as jinit
    jcfg = jget("minicpm-2b").reduced(**SMALL)
    jstate = jinit(jcfg, jax.random.PRNGKey(0))
    return jcfg, jstate, jax.tree.map(np.asarray, jstate)


def _round_grads(pkg, cfg, states, batches, inner, eval_batch):
    """One round of two workers of package ``pkg`` (``"repro"`` or
    ``"repro_torch"``) on its own mesh, each from its state and batch
    iterator, the first with ``eval_batch``: each worker's pseudo-gradient
    of round 0, and the first worker's round log."""
    import importlib
    fleet_mod = importlib.import_module(f"{pkg}.core.fleet")
    collab = importlib.import_module(f"{pkg}.train.collab")
    compress = importlib.import_module(f"{pkg}.train.compress")
    sched = importlib.import_module(f"{pkg}.optim").cosine_schedule(
        1e-3, 5, 400)
    fleet = fleet_mod.make_fleet(4, seed=5, same_region="us")
    ccfg = collab.CollabConfig(inner_steps=inner, settle=0.5)
    workers = [collab.CollabWorker(fleet.peers[i], cfg, s, sched, b, "one",
                                   collab=ccfg, step_seconds=0.2,
                                   eval_batch=eval_batch if i == 0 else None)
               for i, (s, b) in enumerate(zip(states, batches))]
    start = {k: v.copy() for k, v in workers[0].outer_flat.items()}
    procs = [fleet.sim.process(w.run(1, log=None)) for w in workers]
    fleet.sim.run(until=fleet.sim.now + 300)
    assert all(p.triggered and not p.failed for p in procs)
    return [compress.pseudo_gradient(start,
                                     compress.tree_to_flat(w._state.params))
            for w in workers], workers[0].round_log


def test_one_round_pseudo_gradients_match_jax_workers():
    """Two JAX and two torch workers, each pair in its own package's fleet,
    from one crossed init on the same batches (L=2, d=64, vocab 128, S=32,
    H=4): each torch worker's round-0 pseudo-gradient within ``OPT_TOL``
    of its JAX twin's, and the first worker's eval loss of the outer
    params within ``test_torch_train.py``'s ``STEP_RTOL`` of the JAX
    worker's."""
    from repro.data import make_batch_iterator as jbatches
    from repro_torch.data import make_batch_iterator
    jcfg, jstate, np_state = _jax_model()
    cfg = _cfg()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)

    def data(fn, i):
        return fn(cfg.vocab, 32, global_batch=4, n_shards=2, shard=i, seed=1)
    eval_batch = next(data(make_batch_iterator, 1))
    want, want_log = _round_grads("repro", jcfg, [jstate, jstate],
                                  [data(jbatches, i) for i in range(2)], 4,
                                  eval_batch)
    got, got_log = _round_grads("repro_torch", cfg,
                                [train_state_from_numpy(np_state, "cpu")
                                 for _ in range(2)],
                                [data(make_batch_iterator, i)
                                 for i in range(2)], 4, eval_batch)
    ((jlog,), (plog,)) = want_log, got_log
    assert plog["round"] == jlog["round"] == 1
    np.testing.assert_allclose(plog["eval_loss"], jlog["eval_loss"],
                               rtol=STEP_RTOL)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert np.abs(w[k]).max() > 0, k
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=OPT_TOL,
                                       err_msg=k)


def _short_round_rejoin(pkg, cfg, state):
    """``test_collab.py``'s member drop in package ``pkg`` with rounds of 4
    inner steps of 0.2 s instead of 8: worker 3 stops mid-round 1 of
    three; after the others close all three, every worker runs one more
    round.  Returns the rejoiner's replayed rounds, each worker's outer
    round and the number of distinct outer digests."""
    import importlib
    fleet = importlib.import_module(f"{pkg}.core.fleet").make_fleet(
        6, seed=3, same_region="us")
    collab = importlib.import_module(f"{pkg}.train.collab")
    data = importlib.import_module(f"{pkg}.data")
    sched = importlib.import_module(f"{pkg}.optim").cosine_schedule(
        1e-3, 5, 400)
    sim = fleet.sim
    workers = [collab.CollabWorker(
        fleet.peers[i], cfg, state(), sched, data.make_batch_iterator(
            cfg.vocab, 32, global_batch=4, n_shards=4, shard=i, seed=1),
        "fleetC", collab=collab.CollabConfig(inner_steps=4, settle=0.5,
                                             keep_rounds=4),
        step_seconds=0.2) for i in range(4)]
    procs = [sim.process(w.run(3, log=None)) for w in workers]

    def killer():
        while not any(h["round"] == 1 for h in workers[3].history):
            yield 0.25
        yield 0.3
        workers[3].stop()
    sim.process(killer(), daemon=True)
    sim.run(until=sim.now + 600)
    procs += [sim.process(w.run(1, log=None)) for w in workers]
    sim.run(until=sim.now + 600)
    assert all(p.triggered and not p.failed for p in procs)
    return (workers[3].stats["catchup_rounds"],
            [w.outer_round for w in workers],
            len({w.outer_digest() for w in workers}))


def test_a_late_rejoiner_forks_in_both_packages():
    """A hazard of the reference, kept by the copy and fixed on neither
    side: with 0.8-s rounds the rejoiner's ``catch_up`` outlasts the
    survivors' extra round, it replays that round too, then runs its own
    next round alone, closes it with its own contribution, and its outer
    state parts from the fleet's.  (With ``test_collab.py``'s 1.6-s
    rounds it rejoins in time.)"""
    import jax

    from repro.configs import get_config as jget
    from repro.train import train_state_init as jinit
    from repro_torch.train import train_state_init
    jcfg = jget("minicpm-2b").reduced(**SMALL)
    want = _short_round_rejoin(
        "repro", jcfg, lambda: jinit(jcfg, jax.random.PRNGKey(0)))
    got = _short_round_rejoin(
        "repro_torch", _cfg(),
        lambda: train_state_init(_cfg(), torch.Generator().manual_seed(0),
                                 "cpu"))
    assert want == got == (3, [4, 4, 4, 5], 2)


# ------------------------------------------------- sanitized double run

def _sanitized_run():
    from repro_torch.core import simnet
    from repro_torch.core.fleet import make_fleet
    from repro_torch.train.collab import CollabConfig
    chip_smoke.fresh_counters(chip_smoke.port_mesh())
    sim = simnet.Sim(seed=3, sanitize=True)
    fleet = make_fleet(6, same_region="us", sim=sim)
    workers = _make_workers(fleet, _cfg(), 4, CollabConfig(
        inner_steps=4, settle=0.5, keep_rounds=1))
    procs = [sim.process(w.run(3, log=None)) for w in workers]
    sim.run(until=sim.now + 600)
    assert all(p.triggered and not p.failed for p in procs)
    report = sim.san_report()
    return {"trace_digest": report["trace_digest"],
            "events": report["events"],
            "double_settles": report["double_settles"],
            "digests": [w.outer_digest() for w in workers],
            "pins": {k: v for k, v in sim.leak_report().items()
                     if k.startswith("collab.overdue_pins")}}


def test_sanitized_double_run_is_bit_identical():
    """The port's collab scenario twice under ``Sim(sanitize=True)``: the
    same trace, one outer digest, and the overdue-pin gauges at 0."""
    first, second = _sanitized_run(), _sanitized_run()
    assert first == second
    assert first["events"] > 1000 and not first["double_settles"]
    assert len(set(first["digests"])) == 1
    assert len(first["pins"]) == 4 and not any(first["pins"].values())


# --------------------------------------------------- the round-start seam

def test_params_like_gives_fresh_trainable_leaves():
    """``_params_like`` copies: writing into a leaf leaves the numpy outer
    state as it was; the leaves take the like tree's dtype and device and
    require grad when asked."""
    from repro_torch.train.collab import _params_like
    from repro_torch.train.compress import tree_to_flat
    like = {"a": torch.randn(3, 4, dtype=torch.float64),
            "b": {"c": torch.randn(5)}}
    flat = tree_to_flat(like)
    keep = {k: v.copy() for k, v in flat.items()}
    out = _params_like(flat, like, trainable=True)
    assert out["a"].dtype == torch.float64 and out["b"]["c"].dtype == \
        torch.float32
    assert out["a"].requires_grad and out["b"]["c"].requires_grad
    with torch.no_grad():
        for t in (out["a"], out["b"]["c"]):
            t.add_(1.0)
    for k in flat:
        assert np.array_equal(flat[k], keep[k]), k
    plain = _params_like(flat, like)
    assert not plain["a"].requires_grad
    with pytest.raises(ValueError):
        _params_like({"a": flat["a"][:2], "b/c": flat["b/c"]}, like)


def test_round_start_is_left_as_it_was(monkeypatch):
    """After one inner phase on the CPU, the round's ``start_flat`` is
    still the outer state the round began from and the pseudo-gradient is
    nonzero in every leaf: the inner steps trained their own leaves, not
    ``start_flat``'s memory."""
    from repro_torch.core.fleet import make_fleet
    from repro_torch.train import collab
    seen = []

    def recording(start, end, _fn=collab.pseudo_gradient):
        seen.append(({k: v.copy() for k, v in start.items()}, end))
        return _fn(start, end)
    monkeypatch.setattr(collab, "pseudo_gradient", recording)
    fleet = make_fleet(3, seed=4, same_region="us")
    (worker,) = _make_workers(fleet, _cfg(), 1, collab.CollabConfig(
        inner_steps=3, settle=0.5))
    before = {k: v.copy() for k, v in worker.outer_flat.items()}
    proc = fleet.sim.process(worker.run(1, log=None))
    fleet.sim.run(until=fleet.sim.now + 300)
    assert proc.triggered and not proc.failed
    ((start, end),) = seen
    for k in before:
        assert np.array_equal(start[k], before[k]), k
        assert np.abs(start[k] - end[k]).max() > 0, k
    assert worker.outer_digest() != collab.flat_digest(before)


# ------------------------------------------------------ init scales

def test_init_scales_match_the_jax_dense_init():
    """Each leaf of the port's minicpm-2b init at full width (L=1) has the
    JAX package's ``dense_init`` scale: 0.02 for the embedding, else
    1/sqrt(fan_in) of its per-layer shape, within 1% of the draws' std;
    the norms are ones, as the JAX init's."""
    import jax

    from repro.configs import get_config as jget
    from repro.models import ops_for
    from repro_torch.configs import get_config
    from repro_torch.models import decoder
    cfg = dataclasses.replace(get_config("minicpm-2b"), n_layers=1)
    jcfg = dataclasses.replace(jget("minicpm-2b"), n_layers=1)
    shapes = jax.eval_shape(lambda k: ops_for(jcfg).init(jcfg, k),
                            jax.random.PRNGKey(0))
    jshape = {n: s.shape for n, s in chip_smoke.named_leaves(shapes)}
    params = decoder.init_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu")
    names = sorted(n for n, _ in chip_smoke.named_leaves(params))
    assert names == sorted(jshape)
    for name, t in chip_smoke.named_leaves(params):
        assert tuple(t.shape) == tuple(jshape[name]), name
        per_layer = jshape[name][1:] if name.startswith("blocks.") \
            else jshape[name]
        if len(per_layer) < 2:
            assert torch.equal(t, torch.ones_like(t)), name
            continue
        want = 0.02 if name == "embed" else 1 / math.sqrt(per_layer[0])
        std = t.double().std().item()
        assert abs(std / want - 1) < 1e-2, (name, std, want)
        assert abs(t.double().mean().item()) < 1e-2 * want, name
    del params


# ------------------------------------------------------- the mixed fleet

def _states(np_state, jstate, kinds):
    """Per worker, a train state of its package from one crossed init."""
    return [jstate if k == "jax" else train_state_from_numpy(np_state, "cpu")
            for k in kinds]


def _mixed_workers(fleet, kinds, ccfg_kw, name, jmodel, cfg):
    """One worker per entry of ``kinds`` (``"jax"`` or ``"torch"``), on
    peers 0, 1, ..., each with its package's ``CollabWorker``, schedule and
    batch iterator (shard i of ``len(kinds)``)."""
    import repro.train.collab as jcollab
    from repro.data import make_batch_iterator as jbatches
    from repro.optim import cosine_schedule as jsched
    from repro_torch.data import make_batch_iterator
    from repro_torch.optim import cosine_schedule
    from repro_torch.train import collab
    jcfg, jstate, np_state = jmodel
    out = []
    for i, (kind, state) in enumerate(zip(kinds, _states(
            np_state, jstate, kinds))):
        mod, c, batches, sched = (
            (jcollab, jcfg, jbatches, jsched) if kind == "jax"
            else (collab, cfg, make_batch_iterator, cosine_schedule))
        out.append(mod.CollabWorker(
            fleet.peers[i], c, state, sched(1e-3, 5, 400),
            batches(cfg.vocab, 32, global_batch=4, n_shards=len(kinds),
                    shard=i, seed=1), name,
            collab=mod.CollabConfig(**ccfg_kw), step_seconds=0.2))
    return out


def _mixed_fleet(seed, n=6):
    from repro.core.fleet import make_fleet
    from repro.core.simnet import Sim
    return make_fleet(n, same_region="us", sim=Sim(seed=seed))


def mixed_rounds(jmodel, cfg):
    """Two JAX and two torch workers close 2 rounds."""
    from test_torch_fleet import _fresh_all
    _fresh_all()
    fleet = _mixed_fleet(3)
    kinds = ["jax", "torch", "jax", "torch"]
    workers = _mixed_workers(fleet, kinds, dict(inner_steps=8, settle=0.5),
                             "mixedC", jmodel, cfg)
    procs = [fleet.sim.process(w.run(2, log=None)) for w in workers]
    fleet.sim.run(until=fleet.sim.now + 600)
    return {"done": [p.triggered and not p.failed for p in procs],
            "kinds": [type(w).__module__ for w in workers],
            "rounds": [w.outer_round for w in workers],
            "digests": [w.outer_digest() for w in workers],
            "aborted": [w.stats["rounds_aborted"] for w in workers],
            "ratio": [w.stats["wire_bytes"] / w.stats["dense_bytes"]
                      for w in workers],
            "overdue": [w.overdue_pins() for w in workers]}


def mixed_rejoin(jmodel, cfg):
    """``test_collab.py``'s member drop with workers of both packages: the
    torch worker 3 stops mid-round 1 of three; after the others close all
    three, it rejoins and everyone runs one more round."""
    from test_torch_fleet import _fresh_all
    _fresh_all()
    fleet = _mixed_fleet(3)
    sim = fleet.sim
    kinds = ["jax", "torch", "jax", "torch"]
    workers = _mixed_workers(fleet, kinds, dict(inner_steps=8, settle=0.5,
                                                keep_rounds=4),
                             "mixedR", jmodel, cfg)
    procs = [sim.process(w.run(3, log=None)) for w in workers]

    def killer():
        while not any(h["round"] == 1 for h in workers[3].history):
            yield 0.25
        yield 0.3
        workers[3].stop()
    sim.process(killer(), daemon=True)
    sim.run(until=sim.now + 600)
    out = {"survivors_done": [p.triggered and not p.failed
                              for p in procs[:3]],
           "stopped_round": workers[3].outer_round,
           "survivor_digests": [w.outer_digest() for w in workers[:3]],
           "stopped_digest": workers[3].outer_digest()}
    procs = [sim.process(w.run(1, log=None)) for w in workers]
    sim.run(until=sim.now + 600)
    out.update(after_done=[p.triggered and not p.failed for p in procs],
               catchup=workers[3].stats["catchup_rounds"],
               digests=[w.outer_digest() for w in workers],
               rounds=[w.outer_round for w in workers],
               aborted=[w.stats["rounds_aborted"] for w in workers[:3]])
    return out


def mixed_checkpoints(jmodel, cfg):
    """A JAX ``LatticaSyncTrainer`` followed by a torch ``ModelSubscriber``,
    and a torch trainer followed by a JAX subscriber, on one fleet; fp32
    trees, since the JAX reader refuses bfloat16."""
    import jax

    from repro.checkpoint.lattica_ckpt import CheckpointRegistry
    from repro.data import make_batch_iterator as jbatches
    from repro.optim import cosine_schedule as jsched
    from repro.train.trainer import LatticaSyncTrainer as JaxTrainer
    from repro.train.trainer import ModelSubscriber as JaxSubscriber
    from repro_torch.data import make_batch_iterator
    from repro_torch.optim import cosine_schedule
    from repro_torch.train import LatticaSyncTrainer
    from repro_torch.train.trainer import ModelSubscriber
    from test_torch_fleet import _fresh_all
    _fresh_all()
    jcfg, jstate, np_state = jmodel
    fleet = _mixed_fleet(17, n=8)
    sim, p = fleet.sim, fleet.peers
    jt = JaxTrainer(jcfg, jstate, jsched(1e-3, 5, 100),
                    jbatches(cfg.vocab, 32, global_batch=4, seed=1),
                    node=p[0], fleet="j2t", publish_every=3,
                    step_seconds=0.2)
    pt = LatticaSyncTrainer(cfg, train_state_from_numpy(np_state, "cpu"),
                            cosine_schedule(1e-3, 5, 100),
                            make_batch_iterator(cfg.vocab, 32,
                                                global_batch=4, seed=2),
                            node=p[1], fleet="t2j", publish_every=3,
                            step_seconds=0.2)
    psub = ModelSubscriber(p[-1], cfg, "j2t",
                           like=train_state_from_numpy(np_state,
                                                       "cpu").params)
    jsub = JaxSubscriber(p[-2], jcfg, "t2j", like=jstate.params)
    procs = [sim.process(jt.run_mesh(6, log=None)),
             sim.process(pt.run_mesh(6, log=None)),
             sim.process(psub.follow(interval=2.0, until_step=6)),
             sim.process(jsub.follow(interval=2.0, until_step=6))]
    sim.run(until=sim.now + 900)

    def same(a, b):
        la = [np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)
              for _, x in chip_smoke.named_leaves(a)]
        lb = [np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)
              for _, x in chip_smoke.named_leaves(b)]
        return len(la) == len(lb) > 0 and all(
            x.dtype == y.dtype and np.array_equal(x, y)
            for x, y in zip(la, lb))
    return {"done": [q.triggered and not q.failed for q in procs],
            "steps": [psub.current_step, jsub.current_step],
            "leaf_types": [type(next(chip_smoke.named_leaves(s.params))[1])
                           .__module__ for s in (psub, jsub)],
            "equal": [same(jax.tree.map(np.asarray, jt.state.params),
                           psub.params),
                      same(pt.state.params,
                           jax.tree.map(np.asarray, jsub.params))],
            "registries": [
                (CheckpointRegistry(p[-1], "j2t").latest()
                 == CheckpointRegistry(p[0], "j2t").latest()),
                (CheckpointRegistry(p[-2], "t2j").latest()
                 == CheckpointRegistry(p[1], "t2j").latest())]}


def mixed_collab_main(out_path):
    """The subprocess: ``test_torch_fleet``'s alias and shim, then the
    three cases, their readings pickled to ``out_path``."""
    from test_torch_fleet import install_alias, install_shim
    install_alias()
    import repro.train.collab  # noqa: F401  (the JAX training modules)
    torch.set_num_threads(1)
    install_shim(True)
    import repro_torch.core.simnet as psim
    import repro.core.simnet as jsim
    assert jsim is psim
    jmodel = _jax_model()
    cfg = _cfg()
    res = {name: fn(jmodel, cfg) for name, fn in (
        ("rounds", mixed_rounds), ("rejoin", mixed_rejoin),
        ("checkpoints", mixed_checkpoints))}
    with open(out_path, "wb") as f:
        pickle.dump(res, f)


@pytest.fixture(scope="module")
def mixed_collab(tmp_path_factory):
    """The three cases, run once in a subprocess of ``sys.executable``."""
    out = tmp_path_factory.mktemp("mixed_collab") / "mixed.pkl"
    code = ("import sys\n"
            f"sys.path[:0] = [{str(SRC)!r}, {str(ROOT)!r}, "
            f"{str(ROOT / 'tests')!r}]\n"
            "import test_torch_collab\n"
            f"test_torch_collab.mixed_collab_main({str(out)!r})\n")
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    with open(out, "rb") as f:
        return pickle.load(f)


def test_mixed_fleet_closes_rounds_with_one_outer_digest(mixed_collab):
    """Two JAX and two torch ``CollabWorker``s from one crossed init close
    2 rounds with one outer digest across the four and no aborted round."""
    r = mixed_collab["rounds"]
    assert r["kinds"] == ["repro.train.collab", "repro_torch.train.collab"] * 2
    assert all(r["done"])
    assert r["rounds"] == [2] * 4
    assert len(set(r["digests"])) == 1
    assert r["aborted"] == [0] * 4
    assert max(r["ratio"]) <= 0.10
    assert r["overdue"] == [0] * 4


def test_mixed_fleet_torch_worker_rejoins_onto_the_jax_digest(mixed_collab):
    r = mixed_collab["rejoin"]
    assert all(r["survivors_done"]) and all(r["after_done"])
    assert len(set(r["survivor_digests"])) == 1
    assert r["stopped_round"] == 1
    assert r["stopped_digest"] not in r["survivor_digests"]
    assert r["catchup"] >= 1
    assert len(set(r["digests"])) == 1 and r["rounds"] == [4] * 4
    assert r["aborted"] == [0] * 3


def test_mixed_checkpoints_cross_both_ways(mixed_collab):
    """A JAX trainer's versions fetched by a torch subscriber, and a torch
    trainer's by a JAX subscriber: the last version's leaves equal the
    trainer's, and the registries agree."""
    r = mixed_collab["checkpoints"]
    assert all(r["done"])
    assert r["steps"] == [6, 6]
    assert r["leaf_types"][0] == "torch"
    assert r["leaf_types"][1] != "torch"
    assert r["equal"] == [True, True]
    assert r["registries"] == [True, True]


# -------------------------------------------------- the smoke's collab phase

def test_collab_phase_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.collab_phase`` end to end at a reduced width on the CPU,
    gates D1-D6 as written (D3 holds the CPU to itself here), with the
    attention kernels' plain versions counted as their launches.  The
    rounds train at S=128, with the flash path taken from 128 tokens on
    instead of 2048."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import common

    monkeypatch.setattr(chip_smoke, "COLLAB_SEQ", 128)
    monkeypatch.setattr(common, "FLASH_MIN_SEQ", 128)

    for mod, name, count in ((fa, "flash_attention_plain", "launches"),
                             (fa, "flash_attention_bwd_plain",
                              "bwd_launches"),
                             (pa, "paged_attention_plain", "launches")):
        def counted(*args, _fn=getattr(mod, name), _mod=mod, _c=count,
                    **kwargs):
            setattr(_mod, _c, getattr(_mod, _c) + 1)
            return _fn(*args, **kwargs)
        monkeypatch.setattr(mod, name, counted)
    lines = []
    monkeypatch.setattr(chip_smoke, "nvidia_smi", lambda: "cpu")
    monkeypatch.setattr(chip_smoke, "emit", lines.append)
    cfg = get_config("minicpm-2b").reduced(**SMALL)
    chip_smoke.collab_phase(torch, 0.0, device="cpu", cfg=cfg,
                            parity_cfg=cfg)
    (line,) = lines
    assert line["phase"] == "collab"
    assert line["d2"] == chip_smoke.COLLAB_GOLDEN
    for part in ("grads", "update"):
        assert line["d3"][part]["ratio_to_bound_max"] <= 1.0, part
    assert line["d3"]["grads"]["readings"] == \
        chip_smoke.COLLAB_INNER * line["d3"]["update"]["readings"]
    assert "control_tf32" not in line["d3"]
    calls = line["d1"]["calls"]
    assert calls["step_fn"]["calls"] == chip_smoke.COLLAB_WORKERS * \
        chip_smoke.COLLAB_ROUNDS * chip_smoke.COLLAB_INNER
    assert calls["_outer_step"]["calls"] == chip_smoke.COLLAB_WORKERS * \
        chip_smoke.COLLAB_ROUNDS
    taken = chip_smoke.COLLAB_WORKERS * chip_smoke.COLLAB_ROUNDS * \
        chip_smoke.COLLAB_INNER
    assert line["launches"]["d1"]["flash_attention_bwd"] == 2 * taken
    assert line["launches"]["d4"]["paged_decode_attention"] == \
        2 * chip_smoke.COLLAB_STEPS
    assert line["launches"]["d5"]["flash_attention"] == \
        2 * chip_smoke.COLLAB_SYNC_STEPS
    assert max(line["d1"]["wire_ratio"]) <= chip_smoke.COLLAB_WIRE_RATIO
    assert [f["step"] for f in line["d5"]["fetch_log"]][-1] == \
        chip_smoke.COLLAB_SYNC_STEPS


def test_d3_update_check_sees_a_wrong_weight_decay(monkeypatch):
    """Gate D3b has teeth: when the workers' AdamW decays by 0.11 instead
    of the step's 0.1 (in every run, so that D3a's gradients still agree),
    the card run's pseudo-gradient against the update replayed with 0.1
    reads over its bound; with the right decay it reads within."""
    from repro_torch.configs import get_config
    from repro_torch.train import step as step_mod

    monkeypatch.setattr(chip_smoke, "COLLAB_SEQ", 64)
    cfg = get_config("minicpm-2b").reduced(**SMALL)
    right = chip_smoke.collab_parity(torch, cfg, device="cpu")
    assert right["update"]["ratio_to_bound_max"] <= 1.0
    assert right["grads"]["ratio_to_bound_max"] <= 1.0

    def decays_more(*args, _fn=step_mod.adamw_update, **kwargs):
        kwargs["weight_decay"] = 0.11
        return _fn(*args, **kwargs)
    monkeypatch.setattr(step_mod, "adamw_update", decays_more)
    wrong = chip_smoke.collab_parity(torch, cfg, device="cpu")
    assert wrong["grads"]["ratio_to_bound_max"] <= 1.0
    assert wrong["update"]["ratio_to_bound_max"] > 1.0
    assert len(wrong["update"]["over_bound"]) == wrong["update"]["readings"]


def test_d3_records_the_unclipped_gradients(monkeypatch):
    """Gate D3 holds the gradients each step clipped as they were before
    the clip: the float32 and float64 runs' first-step gradients, from one
    start, agree within 1e-5 of each leaf's largest (a record that shared
    memory with the gradient would hold the float64 run's clipped one),
    and replaying the update leaves the record as it was."""
    import numpy as np
    from repro_torch.configs import get_config

    monkeypatch.setattr(chip_smoke, "COLLAB_SEQ", 64)
    cfg = get_config("minicpm-2b").reduced(**SMALL)
    base, got = chip_smoke.collab_round_runs(
        torch, cfg, [("cpu32", "cpu", np.float32),
                     ("cpu64", "cpu", np.float64)])
    for i in range(chip_smoke.COLLAB_WORKERS):
        g32, g64 = got["cpu32"]["grads"][i][0], got["cpu64"]["grads"][i][0]
        for name, t in g64.items():
            assert t.dtype == torch.float64
            scale = t.abs().max().item()
            assert (g32[name] - t).abs().max().item() <= 1e-5 * scale, name
        for run in ("cpu32", "cpu64"):
            kept = got[run]["grads"][i]
            before = [{n: t.clone() for n, t in g.items()} for g in kept]
            for dtype in (np.float32, np.float64):
                chip_smoke.adamw_replay(torch, base, kept, dtype)
            for g, b in zip(kept, before):
                assert all(torch.equal(g[n], b[n]) for n in b)
