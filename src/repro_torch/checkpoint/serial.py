"""Canonical parameter tree <-> bytes serialization for content addressing.

The port's copy of the JAX package's wire format, byte for byte: the same
tree gives the same parts, the same ``LCK2``/``LCK3`` blobs and therefore
the same CIDs on a torch peer as on a JAX one, so either can load what the
other saved or published.  Leaves are torch tensors on any device (a
numpy tree crosses with ``params_from_numpy`` first); the encoding and the
codecs run in numpy on the host, as the JAX package runs them.

Deterministic layout (sorted key-paths) so identical params always produce
identical CIDs.  A leaf's name is its path in the tree, dict keys and list
indices joined by ``/`` (``blocks/attn/wq``, ``blocks/0/mlstm/w_f``), and
leaves are sorted by that string, not in tree order.

Two granularities:

* ``params_to_bytes`` / ``params_from_bytes`` — the whole tree as one flat
  blob (local checkpoints, v1 flat-manifest artifacts).
* ``params_to_parts`` / ``params_from_parts`` — one ``(path, raw-bytes,
  dtype/shape-meta)`` part per leaf, feeding the hierarchical (v2) manifest
  path: each tensor becomes its own sub-DAG.

Both granularities accept ``quant="int8_block"``: large float leaves ship
as per-block scale+zero-point int8 (``_QUANT_BLOCK`` elements per block,
asymmetric: ``x̂ = q*scale + zp``, elementwise error ≤ block_range/508).
Quantized flat blobs carry the ``LCK3`` magic (5-field index entries).

bfloat16 leaves travel as their raw 16-bit patterns under the dtype name
``"bfloat16"``, which is what the JAX package writes for them; numpy has
no bfloat16 of its own, so they are read back through a 16-bit integer
view.  As in the JAX package, they never take the ``int8_block`` codec.
The JAX package's reader refuses the name; this one accepts it.

Decoding returns torch tensors: on the CPU without ``like``, on the device
of each of ``like``'s leaves with it, in the stored dtype.

Everything decoded here can arrive off the swarm, i.e. from untrusted
peers, so the wire formats are deliberately dumb: JSON for the index and
per-leaf dtype/shape meta, raw C-order bytes for tensor data.  Legacy
pickled indexes and metas decode only through a restricted unpickler
that refuses every class/global lookup.  Malformed input raises
``ValueError``.
"""

from __future__ import annotations

import json
import struct
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.safepickle import restricted_loads

_MAGIC = b"LCK1"    # legacy: pickled index (decoded via the safe shim only)
_MAGIC2 = b"LCK2"   # current: JSON index
_MAGIC3 = b"LCK3"   # JSON index with per-entry codec field (quantized blobs)

_QUANT_BLOCK = 4096       # elements per int8_block quantization group
_QUANT_MIN_SIZE = 1024    # leaves smaller than this ship unquantized

_QUANT_MODES = (None, "int8_block")

_BF16 = "bfloat16"

#: the wire dtype names a leaf may have, and the tensor dtype of each
_TORCH_DTYPES: Dict[str, torch.dtype] = {
    "bool": torch.bool, "uint8": torch.uint8, "int8": torch.int8,
    "uint16": torch.uint16, "int16": torch.int16, "uint32": torch.uint32,
    "int32": torch.int32, "uint64": torch.uint64, "int64": torch.int64,
    "float16": torch.float16, _BF16: torch.bfloat16,
    "float32": torch.float32, "float64": torch.float64,
    "complex64": torch.complex64, "complex128": torch.complex128,
}
_WIRE_NAMES = {t: name for name, t in _TORCH_DTYPES.items()}

def _safe_pickle_loads(raw: bytes) -> Any:
    """Decode a legacy pickled index/meta: primitives only — no allowlist,
    so any global resolution (the ACE hook) raises ``ValueError``."""
    return restricted_loads(raw)


def _checked_dtype(dtype: Any) -> str:
    """Validate an untrusted dtype string; returns its wire name.  Object/
    void dtypes would make ``np.frombuffer`` reinterpret attacker bytes as
    Python object pointers; dtypes a tensor cannot hold, or in a foreign
    byte order, are refused as well."""
    if not isinstance(dtype, str):
        raise ValueError(f"dtype must be a string, got {type(dtype).__name__}")
    if dtype == _BF16:
        return _BF16
    try:
        dt = np.dtype(dtype)
    except TypeError as e:
        raise ValueError(f"bad dtype {dtype!r}") from e
    if dt.hasobject or dt.kind in ("O", "V"):
        raise ValueError(f"refusing unsafe dtype {dtype!r}")
    if dt.name not in _TORCH_DTYPES or not dt.isnative:
        raise ValueError(f"unsupported dtype {dtype!r}")
    return dt.name


def _checked_shape(shape: Any) -> Tuple[int, ...]:
    if not isinstance(shape, (list, tuple)) or not all(
            isinstance(s, int) and s >= 0 for s in shape):
        raise ValueError(f"bad shape {shape!r}")
    return tuple(shape)


def _storage(name: str) -> np.dtype:
    """The numpy dtype that holds a wire dtype's raw bytes."""
    return np.dtype(np.int16) if name == _BF16 else np.dtype(name)


def _numel(shape: Tuple[int, ...]) -> int:
    return int(np.prod(shape, dtype=np.int64)) if shape else 1


# ---------------------------------------------------------------- tree walk

def _is_namedtuple(t: Any) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def _children(tree: Any) -> Optional[List[Tuple[str, Any]]]:
    """A node's ``(path component, child)`` pairs in the JAX package's
    flatten order, or None for a leaf.  The components are the ones its
    ``_path_str`` writes: dict keys, list/tuple indices, ``.field`` for a
    namedtuple's fields."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _flatten_with_path(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    if tree is None:                  # an empty node, as in a JAX pytree
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    return [x for k, v in kids
            for x in _flatten_with_path(v, f"{prefix}/{k}" if prefix else k)]


def _map_with_path(fn: Any, tree: Any, prefix: str = "") -> Any:
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn(prefix, tree)
    out = [_map_with_path(fn, v, f"{prefix}/{k}" if prefix else k)
           for k, v in kids]
    if isinstance(tree, dict):
        return dict(zip(sorted(tree), out))
    if _is_namedtuple(tree):
        return type(tree)(*out)
    return type(tree)(out)


def _sorted_leaves(params: Any) -> List[Tuple[str, torch.Tensor]]:
    named = _flatten_with_path(params)
    for name, leaf in named:
        if not isinstance(leaf, torch.Tensor):
            raise ValueError(f"leaf {name!r} is a {type(leaf).__name__}, "
                             "not a tensor")
    return sorted(named, key=lambda kv: kv[0])


# ---------------------------------------------------------------- host side

def _wire_dtype(leaf: torch.Tensor) -> str:
    if leaf.dtype not in _WIRE_NAMES:
        raise ValueError(f"no wire format for dtype {leaf.dtype}")
    return _WIRE_NAMES[leaf.dtype]


def _host(leaf: torch.Tensor) -> np.ndarray:
    """A leaf's values on the host in C order, in its storage dtype (a
    16-bit integer view for bfloat16).  The tensor is detached and copied
    from its device once; a CPU one may be returned as a view."""
    t = leaf.detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.contiguous().cpu().numpy()


def _tensor(arr: np.ndarray, name: str, shape: Tuple[int, ...]) -> torch.Tensor:
    """``arr`` (storage dtype) as a tensor of wire dtype ``name``.  Shares
    ``arr``'s memory, which may be a read-only view of a peer's bytes:
    callers copy it before it leaves this module."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "The given NumPy array is not "
                                "writable")
        t = torch.from_numpy(arr)
    return (t.view(torch.bfloat16) if name == _BF16 else t).reshape(shape)


def _from_float32(arr: np.ndarray, name: str) -> torch.Tensor:
    """A decoded float32 array as an owned tensor of wire dtype ``name``."""
    if name == _BF16:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr.astype(name)))


# ------------------------------------------------------------------- codecs

def _quant_blocks(n: int, block: int) -> int:
    return -(-n // block)


def _quantizable(name: str, size: int) -> bool:
    # bfloat16 stays raw: numpy's (ml_dtypes') bfloat16 is not of kind "f"
    return name != _BF16 and np.dtype(name).kind == "f" and \
        size >= _QUANT_MIN_SIZE


def _quant_int8_block(arr: np.ndarray, block: int = _QUANT_BLOCK) -> bytes:
    """Asymmetric per-block int8: payload = int8 values ‖ f32 scales ‖ f32
    zero-points.  ``x̂ = q*scale + zp`` with |x̂-x| ≤ scale/2 =
    block_range/508 elementwise."""
    flat = np.ascontiguousarray(arr, dtype=np.float32).reshape(-1)
    n = flat.size
    nb = _quant_blocks(n, block)
    padded = np.zeros(nb * block, np.float32)
    padded[:n] = flat
    blocks = padded.reshape(nb, block)
    mx = blocks.max(axis=1)
    mn = blocks.min(axis=1)
    zp = ((mx + mn) * 0.5).astype(np.float32)
    scale = np.where(mx > mn, (mx - mn) / 254.0, 1.0).astype(np.float32)
    q = np.clip(np.rint((blocks - zp[:, None]) / scale[:, None]),
                -127, 127).astype(np.int8)
    return q.reshape(-1)[:n].tobytes() + scale.tobytes() + zp.tobytes()


def _dequant_int8_block(raw: bytes, shape: Tuple[int, ...],
                        block: int) -> np.ndarray:
    """Inverse of :func:`_quant_int8_block` (raw is peer-supplied)."""
    n = _numel(shape)
    if not isinstance(block, int) or block <= 0:
        raise ValueError(f"bad quant block {block!r}")
    nb = _quant_blocks(n, block)
    if len(raw) != n + 8 * nb:
        raise ValueError(f"bad int8_block payload: {len(raw)} bytes for "
                         f"{n} values in {nb} blocks")
    q = np.frombuffer(raw, np.int8, count=n)
    scale = np.frombuffer(raw, np.float32, count=nb, offset=n)
    zp = np.frombuffer(raw, np.float32, count=nb, offset=n + 4 * nb)
    padded = np.zeros(nb * block, np.float32)
    padded[:n] = q
    out = padded.reshape(nb, block) * scale[:, None] + zp[:, None]
    return out.reshape(-1)[:n].reshape(shape)


def _as_numpy(x: Any) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def encode_sparse_leaf(indices: Any, values: Any, shape: Tuple[int, ...],
                       vals: Optional[str] = None,
                       ) -> Tuple[bytes, Dict[str, Any]]:
    """Encode a top-k sparse view of a leaf as an LCK3 part payload.

    Payload layout: ``uint32 flat-indices[k]`` ‖ value payload, where the
    value payload is raw float32 (``vals=None``) or an
    :func:`_quant_int8_block` blob over the k kept values
    (``vals="int8_block"``).  Absent positions decode to zero.
    ``indices`` and ``values`` are arrays or tensors.  Returns ``(raw,
    enc)``; pass ``enc`` to :func:`encode_leaf_meta`."""
    n = _numel(tuple(shape))
    idx = np.ascontiguousarray(_as_numpy(indices), dtype=np.uint32).reshape(-1)
    val = np.ascontiguousarray(_as_numpy(values), dtype=np.float32).reshape(-1)
    if idx.size != val.size:
        raise ValueError(f"sparse leaf: {idx.size} indices vs "
                         f"{val.size} values")
    if idx.size and int(idx.max()) >= n:
        raise ValueError(f"sparse index {int(idx.max())} out of range "
                         f"for {n} elements")
    if vals not in (None, "int8_block"):
        raise ValueError(f"unknown sparse value codec {vals!r}")
    enc: Dict[str, Any] = {"codec": "topk", "k": int(idx.size)}
    if vals == "int8_block":
        enc["vals"] = "int8_block"
        enc["block"] = _QUANT_BLOCK
        payload = _quant_int8_block(val) if idx.size else b""
    else:
        payload = val.tobytes()
    return idx.tobytes() + payload, enc


def _decode_sparse_leaf(raw: bytes, shape: Tuple[int, ...],
                        enc: Dict[str, Any]) -> np.ndarray:
    """Inverse of :func:`encode_sparse_leaf` (raw is peer-supplied)."""
    n = _numel(shape)
    k = enc.get("k")
    if not isinstance(k, int) or k < 0 or k > n:
        raise ValueError(f"bad sparse k {k!r} for {n} elements")
    if len(raw) < 4 * k:
        raise ValueError(f"truncated sparse payload: {len(raw)} bytes "
                         f"for k={k}")
    idx = np.frombuffer(raw, np.uint32, count=k)
    if k and int(idx.max()) >= n:
        raise ValueError(f"sparse index {int(idx.max())} out of range "
                         f"for {n} elements")
    vals_raw = raw[4 * k:]
    if enc.get("vals") == "int8_block":
        val = (_dequant_int8_block(vals_raw, (k,), enc.get("block"))
               if k else np.zeros(0, np.float32))
    else:
        if len(vals_raw) != 4 * k:
            raise ValueError(f"bad sparse value payload: {len(vals_raw)} "
                             f"bytes for k={k}")
        val = np.frombuffer(vals_raw, np.float32, count=k)
    out = np.zeros(n, np.float32)
    out[idx] = val
    return out.reshape(shape)


#: per-entry codecs the LCK3 layer understands
_LEAF_CODECS = ("int8_block", "topk")


def _leaf_codec(name: str, leaf: torch.Tensor,
                quant: Optional[str]) -> Optional[Dict[str, Any]]:
    """The codec descriptor a leaf of wire dtype ``name`` ships under,
    or None for a leaf that ships raw."""
    if quant == "int8_block" and _quantizable(name, leaf.numel()):
        return {"codec": "int8_block", "block": _QUANT_BLOCK}
    return None


def _payload_size(name: str, leaf: torch.Tensor,
                  enc: Optional[Dict[str, Any]]) -> int:
    """The bytes of :func:`_payload`'s result, from the shape alone."""
    n = leaf.numel()
    if enc is None:
        return n * _storage(name).itemsize
    return n + 8 * _quant_blocks(n, _QUANT_BLOCK)


def _payload(arr: np.ndarray, enc: Optional[Dict[str, Any]]) -> Any:
    """A leaf's wire payload from its host values (:func:`_host`): its
    raw bytes as a flat uint8 view, or the codec's bytes."""
    if enc is None:
        return arr.reshape(-1).view(np.uint8)
    return _quant_int8_block(arr)


def _decode_leaf(raw: bytes, name: str, shape: Tuple[int, ...],
                 enc: Optional[Dict[str, Any]]) -> torch.Tensor:
    """One entry's tensor.  A raw entry is a view of ``raw``."""
    if enc is None:
        return _tensor(np.frombuffer(raw, dtype=_storage(name),
                                     count=_numel(shape)), name, shape)
    if not isinstance(enc, dict) or enc.get("codec") not in _LEAF_CODECS:
        raise ValueError(f"unknown leaf codec {enc!r}")
    if enc["codec"] == "topk":
        return _from_float32(_decode_sparse_leaf(raw, shape, enc), name)
    return _from_float32(_dequant_int8_block(raw, shape, enc.get("block")),
                         name)


# ---------------------------------------------------------------- flat blob

def _encode_blob(params: Any, quant: Optional[str] = None,
                 ) -> Tuple[bytes, List[Tuple[torch.Tensor,
                                             Optional[Dict[str, Any]]]]]:
    """A blob's prefix (magic, index) and its body in order, each leaf
    with its codec descriptor: its payload, :func:`_payload` of its host
    values, follows the prefix in that order.  The index needs only the
    leaves' shapes, so no leaf is copied or encoded here."""
    if quant not in _QUANT_MODES:
        raise ValueError(f"unknown quant mode {quant!r}")
    index: List[Any] = []
    body: List[Tuple[torch.Tensor, Optional[Dict[str, Any]]]] = []
    off = 0
    for name, leaf in _sorted_leaves(params):
        dtype = _wire_dtype(leaf)
        shape = [int(s) for s in leaf.shape]
        enc = _leaf_codec(dtype, leaf, quant)
        if quant is None:
            index.append((name, dtype, shape, off))
        else:
            index.append((name, dtype, shape, off, enc))
        body.append((leaf, enc))
        off += _payload_size(dtype, leaf, enc)
    head = json.dumps(index, separators=(",", ":")).encode("utf-8")
    magic = _MAGIC2 if quant is None else _MAGIC3
    return magic + struct.pack(">I", len(head)) + head, body


def params_to_bytes(params: Any, quant: Optional[str] = None) -> bytes:
    prefix, body = _encode_blob(params, quant)
    return b"".join([prefix] + [_payload(_host(leaf), enc)
                                for leaf, enc in body])


def encode_leaf_meta(dtype: str, shape: Sequence[int],
                     enc: Optional[Dict[str, Any]] = None) -> bytes:
    """Safe fixed encoding of a tensor's ``(dtype, shape[, codec])`` for v2
    manifest entry meta: compact JSON, deterministic, decodable without
    pickle."""
    obj: Dict[str, Any] = {"dtype": dtype, "shape": list(shape)}
    if enc is not None:
        obj["enc"] = enc
    return json.dumps(obj, separators=(",", ":"),
                      sort_keys=True).encode("utf-8")


def _decode_leaf_meta_full(meta: bytes,
                           ) -> Tuple[str, Tuple[int, ...],
                                      Optional[Dict[str, Any]]]:
    if meta[:1] == b"{":
        try:
            obj = json.loads(meta.decode("utf-8"))
            dtype, shape = obj["dtype"], obj["shape"]
            enc = obj.get("enc")
        except (UnicodeDecodeError, ValueError, KeyError, TypeError) as e:
            raise ValueError(f"bad leaf meta {meta!r}") from e
    else:
        decoded = _safe_pickle_loads(meta)
        if not (isinstance(decoded, (tuple, list)) and len(decoded) == 2):
            raise ValueError(f"bad legacy leaf meta {meta!r}")
        dtype, shape, enc = decoded[0], list(decoded[1]), None
    if enc is not None and (not isinstance(enc, dict)
                            or enc.get("codec") not in _LEAF_CODECS):
        raise ValueError(f"unknown leaf codec in meta {meta!r}")
    return _checked_dtype(dtype), _checked_shape(shape), enc


def decode_leaf_meta(meta: bytes) -> Tuple[torch.dtype, Tuple[int, ...]]:
    """Decode entry meta from the JSON encoding (with or without a codec
    field) or (shim) a legacy primitive-only pickle into the tensor dtype
    and shape; raises ``ValueError`` on anything else."""
    name, shape, _ = _decode_leaf_meta_full(meta)
    return _TORCH_DTYPES[name], shape


def params_to_parts(params: Any,
                    quant: Optional[str] = None) -> List[Tuple[str, bytes, bytes]]:
    """Per-leaf parts ``(path, payload bytes, encoded meta)``, sorted by
    path — the unit of structural sharing for delta-friendly DAGs.

    ``quant="int8_block"`` ships large float leaves block-quantized (meta
    carries the codec); small/integer leaves and ``quant=None`` parts are
    raw bytes."""
    if quant not in _QUANT_MODES:
        raise ValueError(f"unknown quant mode {quant!r}")
    parts = []
    for name, leaf in _sorted_leaves(params):
        dtype = _wire_dtype(leaf)
        enc = _leaf_codec(dtype, leaf, quant)
        raw = _payload(_host(leaf), enc)
        parts.append((name, raw if isinstance(raw, bytes) else raw.tobytes(),
                      encode_leaf_meta(dtype, [int(s) for s in leaf.shape],
                                       enc)))
    return parts


def leaf_from_part(raw: bytes, meta: bytes) -> torch.Tensor:
    """Decode one part's bytes back into a CPU tensor using its
    dtype/shape (+ optional codec) meta.  ``meta`` and ``raw`` are both
    peer-supplied; malformed input raises ``ValueError``."""
    name, shape, enc = _decode_leaf_meta_full(meta)
    return _decode_leaf(raw, name, shape, enc).clone()


def _restore(flat: Dict[str, torch.Tensor], like: Any, copy: bool) -> Any:
    """``like``'s structure with ``flat``'s leaves, each on the device of
    ``like``'s leaf (a tensor) at its path, in its stored dtype.  ``copy``
    forces a copy where the leaf is already there."""
    def put(name: str, leaf: Any) -> torch.Tensor:
        if not isinstance(leaf, torch.Tensor):
            raise ValueError(f"like leaf {name!r} is a "
                             f"{type(leaf).__name__}, not a tensor")
        t = flat[name]
        if t.shape != leaf.shape:
            raise ValueError(f"leaf {name}: stored shape {tuple(t.shape)} "
                             f"!= {tuple(leaf.shape)}")
        return t.to(leaf.device, copy=copy)
    return _map_with_path(put, like)


def params_from_parts(flat: Dict[str, torch.Tensor], like: Any = None) -> Any:
    """Restore a ``{path: tensor}`` mapping into the structure of ``like``
    (or return the mapping itself when ``like`` is None).  Each leaf goes
    to the device of ``like``'s leaf; a stored shape that differs from
    ``like``'s raises ``ValueError``."""
    if like is None:
        return flat
    return _restore(flat, like, copy=False)


def _decode_index(data: bytes) -> Tuple[List, int]:
    """Index + payload offset from a checkpoint blob of either magic."""
    if len(data) < 8:
        raise ValueError("truncated checkpoint blob")
    magic = data[:4]
    (hlen,) = struct.unpack(">I", data[4:8])
    if 8 + hlen > len(data):
        raise ValueError("truncated checkpoint index")
    head = data[8:8 + hlen]
    if magic in (_MAGIC2, _MAGIC3):
        try:
            index = json.loads(bytes(head).decode("utf-8"))
        except (UnicodeDecodeError, ValueError) as e:
            raise ValueError(f"bad checkpoint index: {e}") from e
    elif magic == _MAGIC:
        index = _safe_pickle_loads(bytes(head))  # legacy shim, primitives only
    else:
        raise ValueError("not a checkpoint blob")
    if not isinstance(index, list):
        raise ValueError("checkpoint index is not a list")
    return index, 8 + hlen


def _decode_blob(data: bytes) -> Dict[str, torch.Tensor]:
    """Every entry of a blob as a CPU tensor; raw entries are views of
    ``data``."""
    index, base = _decode_index(data)
    flat: Dict[str, torch.Tensor] = {}
    for i, entry in enumerate(index):
        if not (isinstance(entry, (list, tuple)) and len(entry) in (4, 5)):
            raise ValueError(f"bad checkpoint index entry {entry!r}")
        name, dtype, shape, off = entry[:4]
        enc = entry[4] if len(entry) == 5 else None
        if not isinstance(name, str) or not isinstance(off, int) or off < 0:
            raise ValueError(f"bad checkpoint index entry {entry!r}")
        wire = _checked_dtype(dtype)
        shp = _checked_shape(shape)
        if enc is None:
            arr = np.frombuffer(data, dtype=_storage(wire), offset=base + off,
                                count=_numel(shp))
            flat[name] = _tensor(arr, wire, shp)
        else:
            # quantized entry: payload runs to the next entry's offset (the
            # index is offset-ordered) or the end of the blob
            end: Any = len(data) - base
            if i + 1 < len(index):
                nxt = index[i + 1]
                end = (nxt[3] if isinstance(nxt, (list, tuple))
                       and len(nxt) > 3 else None)
            if not isinstance(end, int) or end < off:
                raise ValueError(f"bad checkpoint index entry {entry!r}")
            flat[name] = _decode_leaf(data[base + off:base + end], wire, shp,
                                      enc)
    return flat


def _placed(flat: Dict[str, torch.Tensor], like: Any) -> Any:
    """:func:`_decode_blob`'s views as tensors of their own: on the CPU
    without ``like``, else in ``like``'s structure and devices."""
    if like is None:
        return {k: v.clone() for k, v in flat.items()}
    return _restore(flat, like, copy=True)


def params_from_bytes(data: bytes, like: Any = None) -> Any:
    """Decode a blob: ``{path: CPU tensor}`` without ``like``, else
    ``like``'s structure with each leaf on the device of ``like``'s."""
    return _placed(_decode_blob(data), like)
