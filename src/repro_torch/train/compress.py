"""Pseudo-gradient compression for collaborative training rounds.

The port's own copy of the JAX package's ``train/compress.py``, held
to it as a syntax tree by ``tests/test_torch_collab.py``.  Leaves may be
tensors on the card that require grad: they reach the host through
``checkpoint.serial._host``, as float32.  The port's ``leaf_from_part``
returns a CPU tensor; ``sent`` and ``flat_from_entries`` hand back its
float32 array, as the reference does.  The selection stays
``np.argpartition``: ``torch.topk`` orders ties otherwise.  The float64
arithmetic of ``pseudo_gradient`` and ``average_flat`` runs over blocks
of ``_BLOCK`` entries (``_blockwise``): the same operations on each
element, so the same bits, without whole-leaf float64 temporaries.

A DiLoCo-style round ships each worker's *outer delta* (``theta_round_start
- theta_after_H_inner_steps``) instead of per-step gradients.  Two lossy
stages make that delta cheap on the wire:

* **top-k sparsification** — only the ``topk_frac`` largest-magnitude
  entries of each leaf survive (per-leaf, so small layers are not starved
  by large ones); the dropped mass goes into a local *error-feedback
  residual* the caller folds into the next round's delta, so nothing is
  permanently lost, only deferred.
* **int8 block quantization of the kept values** — the PR 7 ``int8_block``
  codec applied to the dense vector of kept values (the sparse ``topk``
  entry codec in :mod:`repro.checkpoint.serial`).

Together a part costs ``k * (4 index + 1 value)`` bytes plus per-4096-block
scale/zero-point tails — ~1.6 % of the fp32 bytes at ``topk_frac=1/80``,
~6 % at the default 0.05 — against 4 bytes/element for a dense fp32
exchange.  Parts are ``(path, payload, meta)`` triples compatible with
``build_tree_dag``/``publish_tree_artifact``, so a contribution is an
ordinary content DAG: identical bytes hash to identical CIDs, fetchers
dequantize through :func:`repro.checkpoint.serial.leaf_from_part`, and the
delta plane (bitswap scheduling, pins, provider scoring) needs no new code.

Everything here is plain numpy on float32 (float64 accumulation for the
averages): every worker that decodes the same contribution set computes the
bit-identical average, which is what lets the outer step run replicated
with no coordinator.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..checkpoint.serial import (_host, _sorted_leaves, encode_leaf_meta,
                                 encode_sparse_leaf, leaf_from_part)

__all__ = ["DEFAULT_TOPK_FRAC", "SPARSE_MIN_SIZE", "tree_to_flat",
           "pseudo_gradient", "topk_select", "compress_pseudograd",
           "flat_from_entries", "average_flat", "flat_digest"]

#: default fraction of entries kept per leaf
DEFAULT_TOPK_FRAC = 0.05

#: leaves smaller than this ship dense fp32 — the 4-byte index per kept
#: entry would cost more than it saves
SPARSE_MIN_SIZE = 256


#: entries per block of the float64 outer arithmetic, whose temporaries
#: then stay in cache instead of faulting in whole-leaf float64 arrays
_BLOCK = 1 << 16


def _blockwise(fn: Any, *arrays: np.ndarray) -> Any:
    """``fn``, elementwise arithmetic on arrays of one shape, evaluated
    over blocks of ``_BLOCK`` flattened entries into fresh arrays of that
    shape: the bits of one call on the whole arrays.  Returns ``fn``'s
    array, or its tuple of arrays."""
    flat = [a.reshape(-1) for a in arrays]
    n = flat[0].size
    outs: List[np.ndarray] = []
    for lo in range(0, max(n, 1), _BLOCK):
        got = fn(*(f[lo:lo + _BLOCK] for f in flat))
        got = got if isinstance(got, tuple) else (got,)
        if not outs:
            outs = [np.empty(n, g.dtype) for g in got]
        for o, g in zip(outs, got):
            o[lo:lo + _BLOCK] = g
    shaped = tuple(o.reshape(arrays[0].shape) for o in outs)
    return shaped if len(shaped) > 1 else shaped[0]


def tree_to_flat(params: Any) -> Dict[str, np.ndarray]:
    """``{path: float32 ndarray}`` view of a pytree, sorted-path keyed
    (the :func:`params_to_parts` naming, so flats and parts interconvert)."""
    return {name: np.asarray(_host(arr.float()), dtype=np.float32)
            for name, arr in _sorted_leaves(params)}


def pseudo_gradient(start: Dict[str, np.ndarray],
                    end: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Outer delta ``start - end`` per leaf: the direction the inner
    optimizer moved, expressed as a gradient for the outer optimizer
    (which *subtracts* it)."""
    return {k: _blockwise(lambda s, e: (s.astype(np.float64)
                                       - e.astype(np.float64)).astype(
                                           np.float32), start[k], end[k])
            for k in start}


def topk_select(arr: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Indices (sorted ascending) and values of the ``k``
    largest-magnitude entries of ``arr`` flattened.  Deterministic for a
    given input, which is all replicated decoding needs — every peer sees
    the encoded bytes, not this selection."""
    flat = arr.reshape(-1)
    if k >= flat.size:
        idx = np.arange(flat.size, dtype=np.uint32)
        return idx, flat.astype(np.float32)
    mag = np.abs(flat)
    idx = np.argpartition(-mag, k - 1)[:k]
    idx = np.sort(idx).astype(np.uint32)
    return idx, flat[idx].astype(np.float32)


def compress_pseudograd(grad: Dict[str, np.ndarray],
                        frac: float = DEFAULT_TOPK_FRAC,
                        quant: Optional[str] = "int8_block",
                        ) -> Tuple[List[Tuple[str, bytes, bytes]],
                                   Dict[str, np.ndarray], Dict[str, int]]:
    """Compress a flat pseudo-gradient into content-DAG parts.

    Returns ``(parts, sent, stats)``: ``parts`` feed
    ``publish_tree_artifact``; ``sent`` is the *decoded* (post-sparsify,
    post-quantize) gradient actually on the wire — the caller keeps
    ``grad - sent`` as its error-feedback residual; ``stats`` counts
    ``dense_bytes`` (fp32 full-exchange cost) vs ``wire_bytes``."""
    if not 0.0 < frac <= 1.0:
        raise ValueError(f"topk_frac must be in (0, 1], got {frac}")
    parts: List[Tuple[str, bytes, bytes]] = []
    sent: Dict[str, np.ndarray] = {}
    dense_bytes = 0
    wire_bytes = 0
    for name in sorted(grad):
        arr = np.ascontiguousarray(grad[name], dtype=np.float32)
        dense_bytes += arr.nbytes
        if arr.size < SPARSE_MIN_SIZE:
            raw = arr.tobytes()
            meta = encode_leaf_meta("float32", arr.shape)
            parts.append((name, raw, meta))
            wire_bytes += len(raw)
            sent[name] = arr.copy()
            continue
        k = max(1, int(np.ceil(frac * arr.size)))
        idx, vals = topk_select(arr, k)
        raw, enc = encode_sparse_leaf(
            idx, vals, arr.shape,
            vals="int8_block" if quant == "int8_block" else None)
        meta = encode_leaf_meta("float32", arr.shape, enc)
        parts.append((name, raw, meta))
        wire_bytes += len(raw)
        # decode our own payload: `sent` must equal what receivers apply,
        # or the error-feedback residual silently drifts off the fleet
        sent[name] = leaf_from_part(raw, meta).numpy()
    return parts, sent, {"dense_bytes": dense_bytes, "wire_bytes": wire_bytes}


def flat_from_entries(pairs: List[Tuple[str, bytes, bytes]],
                      ) -> Dict[str, np.ndarray]:
    """Decode fetched ``(name, payload, meta)`` entries back into a flat
    gradient (peer-supplied bytes; malformed input raises ``ValueError``)."""
    return {name: leaf_from_part(raw, meta).numpy()
            for name, raw, meta in pairs}


def average_flat(grads: List[Dict[str, np.ndarray]],
                 ) -> Dict[str, np.ndarray]:
    """Elementwise mean over contributor gradients.  float64 accumulation
    in the caller-given (sorted-set) order, downcast once — replicas that
    average the same contribution set get bit-identical results."""
    if not grads:
        raise ValueError("cannot average zero contributions")
    out: Dict[str, np.ndarray] = {}
    def mean(*blocks: np.ndarray) -> np.ndarray:
        acc = np.zeros(blocks[0].shape, np.float64)
        for b in blocks:
            acc += b.astype(np.float64)
        return (acc / len(blocks)).astype(np.float32)
    for k in sorted(grads[0]):
        out[k] = _blockwise(mean, *(g[k] for g in grads))
    return out


def flat_digest(flat: Dict[str, np.ndarray]) -> str:
    """Order-insensitive content digest of a flat tree — replicas compare
    outer states without shipping them."""
    import hashlib

    h = hashlib.sha256()
    for k in sorted(flat):
        h.update(k.encode("utf-8"))
        h.update(np.ascontiguousarray(flat[k], dtype=np.float32).tobytes())
    return h.hexdigest()
