"""Plain local-disk checkpointing (same canonical blob as the mesh path).

Two on-disk layouts, byte-identical to the JAX package's for the same tree
and spec:

* flat (default): the canonical ``LCK*`` blob written verbatim.  The blob
  is written entry by entry as :func:`params_to_bytes` would lay it out
  (the index first, then each leaf in index order, copied from its device
  and, under ``quant``, quantized as it is written), so a save holds at
  most one leaf's values and its payload on the host and never the whole
  blob.
* chunked (``spec=``): the blob is cut by the given :class:`ChunkSpec`
  into content-addressed blocks stored under ``<path>.blocks/``; the
  checkpoint file itself is a tiny root manifest.  Blocks already present
  from an earlier save are *not rewritten*.  This layout builds the whole
  blob and its blocks on the host first.

``timings``, where given, collects the seconds spent in each stage of a
save (``encode``: the index and any codec; ``copy`` from the device;
``write``) or of a load (``read``, ``decode``, ``copy`` to the device).
A chunked save counts its whole blob and blocks under ``encode``.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional

import torch

from ..core.cid import CID, ChunkSpec, build_dag, read_dag
from .serial import (_decode_blob, _encode_blob, _host, _payload, _placed,
                     params_to_bytes)

#: magic of the chunked root-manifest file: points into ``<path>.blocks/``
_MAGIC_CHUNKED = b"LCKD"


def _block_path(blocks_dir: str, cid: CID) -> str:
    return os.path.join(blocks_dir, f"{cid.codec:02x}{cid.digest.hex()}")


def _lap(timings: Optional[Dict[str, float]], stage: str, t0: float) -> float:
    """Add the seconds since ``t0`` to ``timings[stage]``; returns now."""
    t = time.perf_counter()
    if timings is not None:
        timings[stage] = timings.get(stage, 0.0) + t - t0
    return t


def save_local(path: str, params: Any, quant: Optional[str] = None,
               spec: Optional[ChunkSpec] = None, *,
               timings: Optional[Dict[str, float]] = None) -> int:
    """Write a checkpoint; returns bytes written to disk *this save*.

    With ``spec`` the blob lands as content-addressed blocks (see module
    docstring) and the return value counts only the new blocks plus the
    manifest."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    t = time.perf_counter()
    if spec is None:
        prefix, body = _encode_blob(params, quant)
        t = _lap(timings, "encode", t)
        written = len(prefix)
        with open(tmp, "wb") as f:
            f.write(prefix)
            for leaf, enc in body:
                arr = _host(leaf)
                t = _lap(timings, "copy", t)
                piece = _payload(arr, enc)
                t = _lap(timings, "encode", t)
                f.write(piece)
                written += len(piece)
                del arr, piece        # before the next leaf's copy lands
                t = _lap(timings, "write", t)
        os.replace(tmp, path)
        return written
    data = params_to_bytes(params, quant=quant)
    dag = build_dag(data, spec=spec)
    t = _lap(timings, "encode", t)
    blocks_dir = path + ".blocks"
    os.makedirs(blocks_dir, exist_ok=True)
    written = 0
    for cid, blk in dag.blocks.items():
        dst = _block_path(blocks_dir, cid)
        if os.path.exists(dst):       # content-addressed: present == correct
            continue
        btmp = dst + ".tmp"
        with open(btmp, "wb") as f:
            f.write(blk)
        os.replace(btmp, dst)
        written += len(blk)
    root = _MAGIC_CHUNKED + bytes([dag.root.codec]) + dag.root.digest
    with open(tmp, "wb") as f:
        f.write(root)
    os.replace(tmp, path)
    _lap(timings, "write", t)
    return written + len(root)


def load_local(path: str, like: Any = None, *,
               timings: Optional[Dict[str, float]] = None) -> Any:
    """Read a checkpoint of either layout.  Without ``like``, a ``{path:
    CPU tensor}`` mapping; with it, ``like``'s structure, each leaf on the
    device of ``like``'s leaf (a leaf on a device that is not there
    raises)."""
    t = time.perf_counter()
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] == _MAGIC_CHUNKED:
        root = CID(data[4], data[5:])
        blocks_dir = path + ".blocks"

        def get(cid: CID) -> bytes:
            with open(_block_path(blocks_dir, cid), "rb") as bf:
                return bf.read()

        data = read_dag(root, get)
    t = _lap(timings, "read", t)
    flat = _decode_blob(data)
    t = _lap(timings, "decode", t)
    out = _placed(flat, like)
    if timings is not None and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    _lap(timings, "copy", t)
    return out
