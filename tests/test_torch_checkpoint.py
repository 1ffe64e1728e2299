"""The port's checkpoint format against the JAX package's, byte for byte.

The same values go through ``repro.checkpoint`` (numpy / JAX trees) and
``repro_torch.checkpoint`` (torch trees on the CPU, crossed over with
``params_from_numpy``): parts, LCK2/LCK3 blobs, sparse parts, v1/v2 root
CIDs and the files ``save_local`` writes must be the same bytes; files
written by either package load in the other with bit-equal leaves and the
same greedy tokens; malformed input is refused with ``ValueError``; and
gate C1's constants (``chip_smoke.py``) are re-derived through the JAX
package on every run.
"""

import ast
import functools
import hashlib
import os
from pathlib import Path
from typing import NamedTuple

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import chip_smoke
from repro import checkpoint as jck
from repro.checkpoint import serial as jserial
from repro.configs import get_config as jax_get_config
from repro.core import cid as jcid
from repro.models import ops_for as jax_ops_for
from repro.serving.engine import GenerationEngine as JaxGenerationEngine
from repro_torch import checkpoint as tck
from repro_torch.checkpoint import serial as tserial
from repro_torch.configs import get_config
from repro_torch.core import cid as tcid
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.params import params_from_numpy
from repro_torch.serving import GenerationEngine
from repro_torch.tree import leaves

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("minicpm-2b", "qwen2-moe-a2.7b", "xlstm-1.3b")
QUANTS = (None, "int8_block")

#: gate C1 (``chip_smoke.CKPT_GOLDEN`` repeats these): a reduced
#: minicpm-2b (``chip_smoke.T2_REDUCED``) filled by
#: ``chip_smoke.golden_numpy_tree``, in fp32 and cast to bf16; the root CID
#: of ``build_tree_dag(params_to_parts(tree))`` and the sha256 of
#: ``params_to_bytes(tree)`` (and, fp32 only, with ``quant="int8_block"``)
GOLDEN = {
    "fp32": {"parts_root": "70db1520b27b65798924892f066c23ee9c4d9728804a1d4e"
                           "44fc154ad711491884",
             "blob_sha256": "4dd0ec5af6514685fb3fb9c5565999fe54acd8b20afb6139"
                            "060d4b2e9727c1ad",
             "int8_blob_sha256": "9136f2b3285f236bced0e48175e53177e10497d81495"
                                 "0cde9806d673cd42738e"},
    "bf16": {"parts_root": "7020d28a37aedb25764dc77dca6d4d1f66e1bdd8ddb46fc3"
                           "833c32e6fb53591470",
             "blob_sha256": "d35af68294655ba3e28fc5b65224fdb31360bc9098a097cc"
                            "a6b8e9e143ad2b76"},
}


# ------------------------------------------------------------------ helpers

@functools.lru_cache(maxsize=None)
def _model(arch):
    """(JAX config, JAX numpy tree, port config, port CPU tree) on the same
    values: a reduced ``arch`` from a seeded JAX init.  Callers do not
    modify what it returns."""
    jcfg = jax_get_config(arch).reduced()
    jparams = jax_ops_for(jcfg).init(jcfg, jax.random.PRNGKey(3))
    jtree = jax.tree.map(np.asarray, jparams)
    return jcfg, jtree, get_config(arch).reduced(), params_from_numpy(jtree,
                                                                      "cpu")


def _bits(x):
    """A leaf's raw bits as a numpy array (bf16 through a 16-bit view)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def _assert_same_leaves(got, want):
    """Two trees hold the same leaves: paths, dtypes, shapes and bits."""
    g = tserial._sorted_leaves(got)
    w = jserial._sorted_leaves(want)
    assert [n for n, _ in g] == [n for n, _ in w]
    for (name, a), (_, b) in zip(g, w):
        a, b = _bits(a), _bits(b)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def _bf16_numpy(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32).astype(
        ml_dtypes.bfloat16), tree)


def _mixed_numpy():
    """Leaves of every codec path: quantizable, odd-sized, below the
    quantization threshold, integer, 0-d, empty, float16."""
    rng = np.random.default_rng(5)
    return {
        "big": (rng.normal(size=(3, 4096 + 123)) * 4.0).astype(np.float32),
        "odd": rng.normal(size=(4097,)).astype(np.float32),
        "small": rng.normal(size=(10,)).astype(np.float32),
        "ints": np.arange(2048, dtype=np.int32),
        "scalar": np.array(2.5, dtype=np.float32),
        "empty": np.zeros((0, 4), np.float32),
        "half": rng.normal(size=(2, 1500)).astype(np.float16),
        "nest": [{"w": rng.normal(size=(5, 7)).astype(np.float64)},
                 np.array([True, False])],
    }


SPECS = {"default": None,
         "fixed16k": ("fixed", 16 * 1024),
         "cdc4k": ("cdc", 4096)}


def _spec(mod, name):
    s = SPECS[name]
    if s is None:
        return None
    if s[0] == "fixed":
        return mod.ChunkSpec("fixed", chunk_size=s[1])
    return mod.ChunkSpec.cdc(avg_size=s[1], norm=1)


def _tree_files(root):
    """Every file under ``root`` by relative path, with its bytes."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            out[os.path.relpath(p, root)] = Path(p).read_bytes()
    return out


# ------------------------------------------------------------ byte identity

@pytest.mark.parametrize("quant", QUANTS, ids=["raw", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_parts_and_blobs_are_byte_identical(arch, quant):
    _, jtree, _, tree = _model(arch)
    assert tck.params_to_parts(tree, quant) == jck.params_to_parts(jtree,
                                                                   quant)
    blob = tck.params_to_bytes(tree, quant)
    assert blob[:4] == (b"LCK2" if quant is None else b"LCK3")
    assert blob == jck.params_to_bytes(jtree, quant)


@pytest.mark.parametrize("quant", QUANTS, ids=["raw", "int8"])
def test_mixed_leaves_are_byte_identical(quant):
    """0-d, empty, integer, float16/64, bool and below-threshold leaves,
    a nested list, and a non-contiguous tensor view."""
    jtree = _mixed_numpy()
    tree = params_from_numpy(jtree, "cpu")
    tree["big"] = tree["big"].t().contiguous().t()        # column-major
    assert not tree["big"].is_contiguous()
    assert tck.params_to_parts(tree, quant) == jck.params_to_parts(jtree,
                                                                   quant)
    assert tck.params_to_bytes(tree, quant) == jck.params_to_bytes(jtree,
                                                                   quant)
    # a numpy tree crosses with params_from_numpy first: the encoder
    # takes tensors only
    with pytest.raises(ValueError, match="not a tensor"):
        tck.params_to_bytes(jtree, quant)


@pytest.mark.parametrize("spec", list(SPECS))
@pytest.mark.parametrize("arch", ARCHS)
def test_root_cids_are_identical(arch, spec):
    _, jtree, _, tree = _model(arch)
    tblob, jblob = tck.params_to_bytes(tree), jck.params_to_bytes(jtree)
    tdag = tcid.build_dag(tblob, spec=_spec(tcid, spec))
    jdag = jcid.build_dag(jblob, spec=_spec(jcid, spec))
    assert (tdag.root.codec, tdag.root.digest) == (jdag.root.codec,
                                                   jdag.root.digest)
    assert len(tdag.blocks) == len(jdag.blocks)
    ttree = tcid.build_tree_dag(tck.params_to_parts(tree, "int8_block"),
                                spec=_spec(tcid, spec))
    jt = jcid.build_tree_dag(jck.params_to_parts(jtree, "int8_block"),
                             spec=_spec(jcid, spec))
    assert ttree.root.digest == jt.root.digest
    assert [(e.name, e.cid.digest, e.size, e.meta) for e in ttree.entries] \
        == [(e.name, e.cid.digest, e.size, e.meta) for e in jt.entries]
    got = tcid.read_dag(ttree.root, ttree.blocks.get)
    assert got == jcid.read_dag(jt.root, jt.blocks.get)
    assert set(c.digest for c in tcid.dag_reachable(ttree.root,
                                                    ttree.blocks.get)) \
        == set(c.digest for c in jcid.dag_reachable(jt.root, jt.blocks.get))


@pytest.mark.parametrize("vals", [None, "int8_block"], ids=["f32", "int8"])
def test_sparse_parts_are_byte_identical(vals):
    rng = np.random.default_rng(11)
    arr = (rng.normal(size=(90, 100)) * 3.0).astype(np.float32)
    flat = arr.ravel()
    idx = np.sort(np.argpartition(-np.abs(flat), 4499)[:4500]).astype(
        np.uint32)
    want = jserial.encode_sparse_leaf(idx, flat[idx], arr.shape, vals=vals)
    assert tserial.encode_sparse_leaf(idx, flat[idx], arr.shape,
                                      vals=vals) == want
    got = tserial.encode_sparse_leaf(torch.from_numpy(idx.astype(np.int64)),
                                     torch.from_numpy(flat[idx]), arr.shape,
                                     vals=vals)
    assert got == want
    raw, enc = want
    meta = jserial.encode_leaf_meta("float32", arr.shape, enc)
    assert tserial.encode_leaf_meta("float32", arr.shape, enc) == meta
    np.testing.assert_array_equal(tck.leaf_from_part(raw, meta).numpy(),
                                  jck.leaf_from_part(raw, meta))


@pytest.mark.parametrize("spec", list(SPECS))
def test_save_local_files_are_byte_identical(tmp_path, spec):
    _, jtree, _, tree = _model("minicpm-2b")
    tdir, jdir = tmp_path / "torch", tmp_path / "jax"
    n_t = tck.save_local(str(tdir / "c.lck"), tree, spec=_spec(tcid, spec))
    n_j = jck.save_local(str(jdir / "c.lck"), jtree, spec=_spec(jcid, spec))
    assert n_t == n_j
    files = _tree_files(tdir)
    assert files == _tree_files(jdir)
    assert ("c.lck.blocks" in "".join(files)) == (spec != "default")
    # a re-save of the same tree writes only the root file
    if spec != "default":
        assert tck.save_local(str(tdir / "c.lck"), tree,
                              spec=_spec(tcid, spec)) == 37


@pytest.mark.parametrize("spec", list(SPECS))
def test_quantized_save_local_files_are_byte_identical(tmp_path, spec):
    """An ``int8_block`` save, whose flat layout quantizes each leaf as
    it is written, lays down the JAX package's files; both read back the
    same dequantized leaves."""
    jtree = _mixed_numpy()
    tree = params_from_numpy(jtree, "cpu")
    tdir, jdir = tmp_path / "torch", tmp_path / "jax"
    save_t = {}
    n_t = tck.save_local(str(tdir / "c.lck"), tree, quant="int8_block",
                         spec=_spec(tcid, spec), timings=save_t)
    n_j = jck.save_local(str(jdir / "c.lck"), jtree, quant="int8_block",
                         spec=_spec(jcid, spec))
    assert n_t == n_j
    assert _tree_files(tdir) == _tree_files(jdir)
    assert "encode" in save_t
    back = tck.load_local(str(tdir / "c.lck"), like=tree)
    _assert_same_leaves(back, jck.load_local(str(jdir / "c.lck"), like=jtree))


def test_bf16_and_0d_leaves_are_byte_identical(tmp_path):
    """A bf16 tree (``ml_dtypes`` on the JAX side, ``torch.bfloat16`` in the
    port) with a 0-d leaf: parts, blobs, CIDs and files match, bf16 leaves
    never take the int8 codec, and the port reads the JAX package's file
    bit for bit.  (The JAX package's own reader refuses the ``bfloat16``
    name, so this direction is the one that crosses.)"""
    _, jtree32, _, _ = _model("minicpm-2b")
    jtree = _bf16_numpy(dict(jtree32, step=np.array(7, np.int32)))
    tree = params_from_numpy(jtree, "cpu")
    assert tree["embed"].dtype == torch.bfloat16 and tree["step"].dim() == 0
    for quant in QUANTS:
        parts = tck.params_to_parts(tree, quant)
        assert parts == jck.params_to_parts(jtree, quant)
        assert all(b"int8_block" not in meta for _, _, meta in parts)
        assert tck.params_to_bytes(tree, quant) == jck.params_to_bytes(
            jtree, quant)
    assert tcid.build_tree_dag(tck.params_to_parts(tree)).root.digest == \
        jcid.build_tree_dag(jck.params_to_parts(jtree)).root.digest
    jck.save_local(str(tmp_path / "j.lck"), jtree)
    tck.save_local(str(tmp_path / "t.lck"), tree)
    assert (tmp_path / "j.lck").read_bytes() == (tmp_path / "t.lck").read_bytes()
    back = tck.load_local(str(tmp_path / "j.lck"), like=tree)
    _assert_same_leaves(back, jtree)
    assert tck.params_to_bytes(back) == jck.params_to_bytes(jtree)
    with pytest.raises(ValueError, match="unsafe dtype 'bfloat16'"):
        jck.load_local(str(tmp_path / "t.lck"))


def test_named_tuples_and_none_name_leaves_as_jax_does():
    class Pair(NamedTuple):
        a: object
        b: object

    jtree = {"s": Pair(np.ones(3, np.float32), [None, np.zeros(2, np.int64)]),
             "x": 1.5}
    tree = {"s": Pair(torch.ones(3), [None, torch.zeros(2, dtype=torch.int64)]),
            "x": torch.tensor(1.5, dtype=torch.float64)}
    assert [n for n, _, _ in tck.params_to_parts(tree)] == \
        [n for n, _, _ in jck.params_to_parts(jtree)] == \
        ["s/.a", "s/.b/1", "x"]
    assert tck.params_to_bytes(tree) == jck.params_to_bytes(jtree)
    back = tck.params_from_bytes(tck.params_to_bytes(tree), like=tree)
    assert isinstance(back["s"], Pair) and back["s"].b[0] is None
    assert torch.equal(back["s"].a, tree["s"].a)


def test_leaves_sort_by_path_string():
    """xlstm's 48 blocks sort as blocks/0, blocks/1, blocks/10, ... in the
    format, not in tree order."""
    tree = {"blocks": [{"w": torch.full((1,), float(i))} for i in range(12)]}
    names = [n for n, _, _ in tck.params_to_parts(tree)]
    assert names[:4] == ["blocks/0/w", "blocks/1/w", "blocks/10/w",
                         "blocks/11/w"]
    assert names == sorted(names)


# -------------------------------------------------------------- cross loads

@pytest.mark.parametrize("arch", ARCHS)
def test_cross_loads_and_greedy_tokens(tmp_path, arch):
    """A file ``repro`` saved loads in the port, and the reverse, with
    bit-equal leaves; the checkpoint and the weight bridge
    (``params_from_numpy``) give the same tree; both engines then greedy-
    decode the same tokens."""
    jcfg, jtree, cfg, tree = _model(arch)
    jck.save_local(str(tmp_path / "j.lck"), jtree)
    tck.save_local(str(tmp_path / "t.lck"), tree)
    fresh = jax.tree.map(np.zeros_like, jtree)
    got = tck.load_local(str(tmp_path / "j.lck"),
                         like=params_from_numpy(fresh, "cpu"))
    _assert_same_leaves(got, jtree)
    _assert_same_leaves(got, tree)
    assert all(t.device.type == "cpu" for t in leaves(got))
    jgot = jck.load_local(str(tmp_path / "t.lck"), like=fresh)
    _assert_same_leaves(tree, jgot)

    tokens = np.random.default_rng(4).integers(0, cfg.vocab, (2, 7),
                                               dtype=np.int32)
    want, _ = JaxGenerationEngine(jcfg, jax.tree.map(jnp.asarray, jgot),
                                  max_len=16).generate(
                                      {"tokens": jnp.asarray(tokens)}, 6)
    out, _ = GenerationEngine(cfg, got, max_len=16, device="cpu").generate(
        {"tokens": tokens}, 6)
    np.testing.assert_array_equal(out, np.asarray(want))


def test_reloaded_checkpoint_re_encodes_to_the_same_bytes(tmp_path):
    """Load, re-encode: the same bytes, also from ``like`` leaves that are
    non-contiguous views (``unbind`` slices of the stacked blocks)."""
    _, _, _, tree = _model("minicpm-2b")
    path = str(tmp_path / "c.lck")
    tck.save_local(path, tree)
    like = {k: v for k, v in tree.items()}
    like["blocks"] = {"attn": {k: v.transpose(-1, -2).contiguous().transpose(
        -1, -2) for k, v in tree["blocks"]["attn"].items()},
        **{k: v for k, v in tree["blocks"].items() if k != "attn"}}
    assert not like["blocks"]["attn"]["wq"].is_contiguous()
    back = tck.load_local(path, like=like)
    assert back["blocks"]["attn"]["wq"].is_contiguous()
    assert tck.params_to_bytes(back) == Path(path).read_bytes()
    assert tcid.build_tree_dag(tck.params_to_parts(back)).root == \
        tcid.build_tree_dag(tck.params_to_parts(tree)).root
    flat = tck.load_local(path)
    assert set(flat) == {n for n, _ in tserial._sorted_leaves(tree)}
    with pytest.raises(ValueError, match="stored shape"):
        tck.params_from_bytes(Path(path).read_bytes(),
                              like=dict(tree, embed=tree["embed"][:3]))


def test_timings_split_a_save_and_a_load(tmp_path):
    _, _, _, tree = _model("minicpm-2b")
    save_t, load_t = {}, {}
    tck.save_local(str(tmp_path / "c.lck"), tree, timings=save_t)
    tck.load_local(str(tmp_path / "c.lck"), like=tree, timings=load_t)
    assert set(save_t) == {"encode", "copy", "write"}
    assert set(load_t) == {"read", "decode", "copy"}
    assert all(v >= 0 for v in list(save_t.values()) + list(load_t.values()))


# ---------------------------------------------------------------- launchers

def test_launchers_save_and_load_on_the_cpu(tmp_path, capsys):
    """``launch.train --save`` writes a file the JAX package reads;
    ``launch.serve --load`` serves it, the tokens a ``GenerationEngine``
    gives on the trained tree."""
    path = str(tmp_path / "ck" / "step2.lck")
    trainer = launch_train.run([
        "--arch", "minicpm-2b", "--reduced", "--device", "cpu", "--steps",
        "2", "--seq", "32", "--batch", "2", "--vocab", "512", "--save", path])
    assert f"checkpoint to {path}" in capsys.readouterr().out
    trained = trainer.state.params
    jback = jck.load_local(path)
    assert set(jback) == {n for n, _ in tserial._sorted_leaves(trained)}
    for name, leaf in tserial._sorted_leaves(trained):
        np.testing.assert_array_equal(jback[name], leaf.detach().numpy())

    out = launch_serve.main(["--arch", "minicpm-2b", "--reduced", "--device",
                             "cpu", "--load", path, "--batch", "2",
                             "--prompt-len", "8", "--gen", "4"])
    cfg = get_config("minicpm-2b").reduced()
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, size=(2, 8),
                                               dtype=np.int32)
    with torch.no_grad():
        want, _ = GenerationEngine(cfg, trained, max_len=13,
                                   device="cpu").generate({"tokens": tokens}, 4)
    np.testing.assert_array_equal(out, want)


def test_serve_load_refuses_a_missing_card(tmp_path, monkeypatch):
    path = str(tmp_path / "c.lck")
    tck.save_local(path, _model("minicpm-2b")[3])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--arch", "minicpm-2b", "--reduced", "--load",
                           path])


# --------------------------------------------------------------- hypothesis

_leaf_shapes = st.lists(st.integers(0, 5), min_size=0, max_size=3)
_dtypes = st.sampled_from(["float32", "float16", "float64", "int32", "int8",
                           "bool", "bfloat16"])


@settings(max_examples=20, deadline=None)
@given(st.dictionaries(st.text(alphabet="abcdef/", min_size=1, max_size=6),
                       st.tuples(_leaf_shapes, _dtypes), min_size=1,
                       max_size=5),
       st.integers(0, 2 ** 31 - 1))
def test_roundtrip_arbitrary_trees(spec, seed):
    rng = np.random.default_rng(seed)
    jtree = {}
    for k, (shape, dt) in spec.items():
        vals = rng.normal(size=shape) * 100
        jtree[k] = (vals.astype(ml_dtypes.bfloat16) if dt == "bfloat16"
                    else vals.astype(dt))
    tree = params_from_numpy(jtree, "cpu")
    blob = tck.params_to_bytes(tree)
    assert blob == jck.params_to_bytes(jtree)
    back = tck.params_from_bytes(blob, like=tree)
    _assert_same_leaves(back, jtree)
    assert tck.params_to_parts(back) == jck.params_to_parts(jtree)


@settings(max_examples=20, deadline=None)
@given(st.dictionaries(st.text(alphabet="abcdef", min_size=1, max_size=6),
                       st.tuples(st.integers(1, 5), st.integers(1, 3000)),
                       min_size=1, max_size=4),
       st.integers(0, 2 ** 31 - 1))
def test_int8_roundtrip_arbitrary_trees(spec, seed):
    rng = np.random.default_rng(seed)
    jtree = {k: (rng.normal(size=(r, c)) * 4).astype(np.float32)
             for k, (r, c) in spec.items()}
    tree = params_from_numpy(jtree, "cpu")
    blob = tck.params_to_bytes(tree, quant="int8_block")
    assert blob == jck.params_to_bytes(jtree, quant="int8_block")
    back = tck.params_from_bytes(blob, like=tree)
    jback = jck.params_from_bytes(blob, like=jtree)
    for k in jtree:
        np.testing.assert_array_equal(back[k].numpy(), jback[k])


# --------------------------------------------------------- malformed input

def _hostile_pickle():
    import pickle

    class Exploit:
        def __reduce__(self):
            return (os.system, ("echo pwned",))
    return pickle.dumps(Exploit())


def _malformed_cases():
    """(label, call) pairs the JAX package refuses with ``ValueError``."""
    import pickle
    import struct

    tree = {"a": np.arange(4, dtype=np.float32),
            "b": np.arange(6, dtype=np.int32).reshape(2, 3)}
    blob = jck.params_to_bytes(tree)
    arr = np.arange(50, dtype=np.float32)
    idx = np.arange(40, 50, dtype=np.uint32)
    val = arr[idx]
    raw, enc = jserial.encode_sparse_leaf(idx, val, arr.shape)
    meta = jserial.encode_leaf_meta("float32", arr.shape, enc)
    evil = np.sort(np.r_[4_000_000_000, idx[1:]]).astype(
        np.uint32).tobytes() + val.tobytes()
    six = np.arange(6, dtype=np.float32).tobytes()
    hostile_index = _hostile_pickle()
    q = jck.params_to_bytes(_mixed_numpy(), quant="int8_block")
    return {
        "quant_bytes": lambda m: m.params_to_bytes(tree, quant="int4_magic"),
        "quant_parts": lambda m: m.params_to_parts(tree, quant="int4_magic"),
        "sparse_range": lambda m: m.serial.encode_sparse_leaf(
            np.array([50], np.uint32), np.array([1.0], np.float32),
            arr.shape),
        "sparse_len": lambda m: m.serial.encode_sparse_leaf(idx, val[:-1],
                                                            arr.shape),
        "sparse_codec": lambda m: m.serial.encode_sparse_leaf(
            idx, val, arr.shape, vals="fp4"),
        "sparse_k": lambda m: m.leaf_from_part(raw, jserial.encode_leaf_meta(
            "float32", arr.shape, {"codec": "topk", "k": 51})),
        "sparse_truncated": lambda m: m.leaf_from_part(raw[:-3], meta),
        "sparse_evil_index": lambda m: m.leaf_from_part(evil, meta),
        "meta_exploit": lambda m: m.leaf_from_part(six, _hostile_pickle()),
        "meta_object": lambda m: m.leaf_from_part(
            six, b'{"dtype":"object","shape":[6]}'),
        "meta_void": lambda m: m.leaf_from_part(
            six, b'{"dtype":"V4","shape":[6]}'),
        "meta_neg_shape": lambda m: m.leaf_from_part(
            six, b'{"dtype":"float32","shape":[-1]}'),
        "meta_garbage": lambda m: m.leaf_from_part(six, b"not json, not pickle"),
        "meta_codec": lambda m: m.leaf_from_part(
            six, b'{"dtype":"float32","enc":{"codec":"zip"},"shape":[6]}'),
        "int8_payload": lambda m: m.leaf_from_part(six, jserial.encode_leaf_meta(
            "float32", (6,), {"codec": "int8_block", "block": 4096})),
        "int8_block": lambda m: m.leaf_from_part(six, jserial.encode_leaf_meta(
            "float32", (6,), {"codec": "int8_block", "block": 0})),
        "legacy_exploit": lambda m: m.params_from_bytes(
            b"LCK1" + struct.pack(">I", len(hostile_index)) + hostile_index
            + six),
        "blob_empty": lambda m: m.params_from_bytes(b""),
        "blob_magic_only": lambda m: m.params_from_bytes(b"LCK2"),
        "blob_index_truncated": lambda m: m.params_from_bytes(
            b"LCK2" + struct.pack(">I", 99)),
        "blob_magic": lambda m: m.params_from_bytes(b"LCK9" + blob[4:]),
        "blob_truncated": lambda m: m.params_from_bytes(blob[:20]),
        "blob_payload_truncated": lambda m: m.params_from_bytes(blob[:-1]),
        "blob_quant_truncated": lambda m: m.params_from_bytes(q[:-5]),
        "blob_not_list": lambda m: m.params_from_bytes(
            b"LCK2" + struct.pack(">I", 2) + b"{}"),
        "blob_bad_entry": lambda m: m.params_from_bytes(
            b"LCK2" + struct.pack(">I", 7) + b"[[1,2]]"),
        "blob_pickled_tuple_meta": lambda m: m.leaf_from_part(
            six, pickle.dumps(("float32",))),
    }


@pytest.mark.parametrize("case", sorted(_malformed_cases()))
def test_malformed_input_is_refused_like_the_jax_package(case):
    call = _malformed_cases()[case]
    for mod in (jck, tck):
        with pytest.raises(ValueError):
            call(mod)


def test_port_refuses_what_a_tensor_cannot_hold():
    six = np.arange(6, dtype=np.float32).tobytes()
    for meta in (b'{"dtype":">f4","shape":[6]}', b'{"dtype":"U1","shape":[6]}',
                 b'{"dtype":"datetime64[s]","shape":[3]}'):
        with pytest.raises(ValueError):
            tck.leaf_from_part(six, meta)
    with pytest.raises(ValueError, match="no wire format"):
        tck.params_to_bytes({"x": torch.zeros(2, dtype=torch.float8_e4m3fn)})


def test_legacy_pickled_index_and_meta_still_decode():
    import pickle
    import struct

    tree = {"a": np.arange(4, dtype=np.float32),
            "b": np.arange(6, dtype=np.int32).reshape(2, 3)}
    payload = tree["a"].tobytes() + tree["b"].tobytes()
    head = pickle.dumps([("a", "float32", (4,), 0), ("b", "int32", (2, 3),
                                                     16)])
    legacy = b"LCK1" + struct.pack(">I", len(head)) + head + payload
    back = tck.params_from_bytes(legacy, like=params_from_numpy(tree, "cpu"))
    _assert_same_leaves(back, tree)
    raw = np.arange(6, dtype=np.float32).tobytes()
    got = tck.leaf_from_part(raw, pickle.dumps(("float32", (2, 3))))
    np.testing.assert_array_equal(got.numpy(), jck.leaf_from_part(
        raw, pickle.dumps(("float32", (2, 3)))))
    assert tserial.decode_leaf_meta(b'{"dtype":"bfloat16","shape":[2]}') == \
        (torch.bfloat16, (2,))


# ------------------------------------------------------------------- gate C1

def test_golden_constants():
    """Gate C1's constants: derived through the JAX package from the
    smoke's own tree builder, through the port on the CPU, and repeated
    unchanged in ``chip_smoke.py``."""
    assert chip_smoke.CKPT_GOLDEN == GOLDEN
    jcfg = jax_get_config("minicpm-2b").reduced(**chip_smoke.T2_REDUCED)
    jshape = jax.eval_shape(lambda: jax_ops_for(jcfg).init(
        jcfg, jax.random.PRNGKey(0)))
    trees = chip_smoke.golden_trees(torch, "cpu")
    assert [(n, tuple(t.shape)) for n, t in tserial._sorted_leaves(
        trees["fp32"])] == [(jserial._path_str(p), tuple(s.shape))
                            for p, s in sorted(
        jax.tree_util.tree_flatten_with_path(jshape)[0],
        key=lambda ps: jserial._path_str(ps[0]))]
    j32 = chip_smoke.golden_numpy_tree(trees["fp32"])
    jax_side = {"fp32": j32, "bf16": _bf16_numpy(j32)}
    for kind, tree in jax_side.items():
        want = {"parts_root": chip_smoke.cid_hex(jcid.build_tree_dag(
            jck.params_to_parts(tree)).root),
            "blob_sha256": hashlib.sha256(jck.params_to_bytes(tree)).hexdigest()}
        if kind == "fp32":
            want["int8_blob_sha256"] = hashlib.sha256(jck.params_to_bytes(
                tree, quant="int8_block")).hexdigest()
        assert want == GOLDEN[kind], kind
        assert chip_smoke.checkpoint_digests(
            trees[kind], int8=kind == "fp32") == GOLDEN[kind], kind


def test_checkpoint_code_imports_no_ml_dtypes():
    """The checkpoint format reads and writes bfloat16 without numpy's
    bf16 type: nothing in it, in ``core`` or in the smoke imports
    ``ml_dtypes``."""
    port = ROOT / "src" / "repro_torch"
    files = (sorted((port / "checkpoint").glob("*.py"))
             + sorted((port / "core").glob("*.py")) + [ROOT / "chip_smoke.py"])
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            assert not any(n.split(".")[0] == "ml_dtypes" for n in names), f
