"""Content identifiers, chunking, and Merkle DAGs.

The port's own copy of the JAX package's ``core/cid.py`` (numpy and
hashlib only): the same bytes cut the same way and hash to the same CIDs
on a torch peer as on a JAX one.

CIDs follow the multihash spirit: ``<version><codec><sha256 digest>``.  Large
artifacts (model checkpoints) are split into chunks, each chunk becoming a
leaf block; a manifest block (codec ``dag``) lists the child CIDs in order
so any peer can verify and reassemble the artifact.

Chunking is governed by a :class:`ChunkSpec` with two strategies:

* ``fixed`` — fixed-size slices (the historical default).  Cheap, but a
  single inserted/removed byte shifts every downstream boundary, so every
  later chunk gets a fresh CID even though its content barely moved.
* ``cdc`` — content-defined chunking via a Gear/FastCDC-style rolling hash
  with ``min``/``avg``/``max`` bounds.  Boundaries are a pure function of
  local content, so byte-shifting edits (grown vocabularies, appended
  optimizer state, partial in-place edits) re-synchronize after the edit
  point and the unchanged tail keeps its leaf CIDs — the property that makes
  re-publishing a slightly different artifact move bytes proportional to the
  edit, not the artifact.

Both strategies are fully deterministic (the gear table is derived from
fixed sha256 seeds), so a re-publish under the same ``ChunkSpec`` reproduces
identical boundaries and therefore identical CIDs.

Two manifest layouts coexist on the wire, distinguished by magic:

* **v1 flat** (``LDAG``): an ordered list of leaf-chunk CIDs + total size.
  Produced by :func:`build_dag`; the right shape for opaque byte blobs.
* **v2 hierarchical** (``LDG2``): an ordered list of *named entries*, each
  pointing at a sub-DAG root (or a raw leaf) with its size and a per-entry
  meta blob.  Produced by :func:`build_tree_dag`; the shape that makes
  *structural sharing* between artifact versions real: a checkpoint whose
  root lists one sub-DAG per tensor reuses the sub-root CIDs of unchanged
  tensors verbatim, so a fetcher only swarms the sub-DAGs it lacks.

Decoders dispatch on the magic (:func:`manifest_version`), so v2-aware
nodes still read every v1 manifest ever published.
"""

from __future__ import annotations

import hashlib
import struct
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

CHUNK_SIZE = 256 * 1024  # 256 KiB, matching Bitswap-typical block size

CODEC_RAW = 0x55
CODEC_DAG = 0x70


class CID:
    __slots__ = ("codec", "digest")

    def __init__(self, codec: int, digest: bytes):
        assert len(digest) == 32
        self.codec = codec
        self.digest = digest

    @classmethod
    def for_data(cls, data: bytes, codec: int = CODEC_RAW) -> "CID":
        return cls(codec, hashlib.sha256(data).digest())

    def verify(self, data: bytes) -> bool:
        return hashlib.sha256(data).digest() == self.digest

    @property
    def key(self) -> bytes:
        """DHT key for this CID (the raw digest)."""
        return self.digest

    def __eq__(self, other: object) -> bool:
        return (isinstance(other, CID) and other.codec == self.codec
                and other.digest == self.digest)

    def __hash__(self) -> int:
        return hash((self.codec, self.digest))

    def __repr__(self) -> str:
        return f"CID({'raw' if self.codec == CODEC_RAW else 'dag'}:{self.digest.hex()[:12]})"


def chunk(data: bytes, chunk_size: int = CHUNK_SIZE) -> List[bytes]:
    if not data:
        return [b""]
    return [data[i:i + chunk_size] for i in range(0, len(data), chunk_size)]


# -- content-defined chunking (Gear/FastCDC-style) ---------------------------

_GEAR_TABLE: Optional[np.ndarray] = None

#: cap on the rolling-hash mask width: candidates only test the low ``bits``
#: bits, so uint32 arithmetic suffices (identical low bits, half the memory)
_CDC_MAX_BITS = 30
#: scan slab: bounds peak temporaries to a constant regardless of part size
_CDC_SLAB = 8 * 2**20


def _gear_table() -> np.ndarray:
    """256 pseudo-random 32-bit gear values derived from fixed sha256 seeds:
    deterministic across platforms and interpreter versions, which is what
    makes CDC boundaries (and therefore CIDs) reproducible forever."""
    global _GEAR_TABLE
    if _GEAR_TABLE is None:
        raw = b"".join(hashlib.sha256(b"lattica-gear-%d" % i).digest()[:4]
                       for i in range(256))
        _GEAR_TABLE = np.frombuffer(raw, dtype=">u4").astype(np.uint32)
    return _GEAR_TABLE


def _windowed_hash(g: np.ndarray, width: int) -> np.ndarray:
    """``h[i] = Σ_{k < width} g[i-k] << k`` (mod 2**32, truncated at the
    array start) for every position at once.

    Built by window doubling instead of ``width`` shifted adds: a window
    sum of size ``w+v`` is ``W_w[i] + (W_v[i-w] << w)``, so power-of-two
    window sums compose along the binary decomposition of ``width`` —
    ~``2*log2(width)`` vectorized passes over the slab instead of
    ``width``.  Bitwise identical to the naive accumulation (uint32
    wraparound is associative/commutative), so boundaries never move.
    """
    n = len(g)
    h = np.zeros(n, dtype=np.uint32)
    if n == 0:
        return h
    width = min(width, n)       # terms past the array start don't exist
    p = g.astype(np.uint32)     # power-of-two window sums, starting at 1
    pw = 1
    done = 0                    # terms k < done are accumulated into h
    rem = width
    while rem:
        if rem & 1:
            h[done:] += p[:n - done] << np.uint32(done)
            done += pw
        rem >>= 1
        if rem:
            p2 = p.copy()
            if n > pw:
                p2[pw:] += p[:n - pw] << np.uint32(pw)
            p = p2
            pw *= 2
    return h


def _cdc_candidates(data: bytes, bits: int, norm: int = 0,
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Boundary-candidate positions as ``(strict, loose)`` arrays: the
    strict mask tests the low ``bits+norm`` bits (fires ~every
    ``2**(bits+norm)`` bytes), the loose mask ``bits-norm``.  ``norm=0``
    returns the same array twice — the legacy single-mask behavior.

    The gear recurrence ``h = (h << 1) + G[b]`` means bit ``k`` of ``h``
    only sees the last ``k+1`` bytes, so a mask of ``m`` low bits only
    needs the window sum of the last ``m`` bytes (carries flow strictly
    upward, mod-2**m truncation is exact).  The same property makes one
    scan serve both masks: the low ``bits-norm`` bits of the wide-window
    hash equal the narrow-window hash's, so the loose candidates fall out
    of the strict scan for free — and a ``norm>0`` scan stays
    gear-table-compatible with legacy ``norm=0`` boundaries.  The scan
    runs in overlapping slabs: a position only needs the window before
    it, so each slab recomputes that overlap and peak temporaries stay
    ~10x the slab size instead of scaling with the whole part.
    """
    bits_s = min(bits + norm, 31)
    bits_l = max(bits - norm, 1)
    buf = np.frombuffer(data, dtype=np.uint8)
    table = _gear_table()
    mask_s = np.uint32((1 << bits_s) - 1)
    mask_l = np.uint32((1 << bits_l) - 1)
    outs: List[np.ndarray] = []
    outl: List[np.ndarray] = []
    for start in range(0, len(data), _CDC_SLAB):
        lo = max(start - (bits_s - 1), 0)
        g = table[buf[lo:start + _CDC_SLAB]]
        h = _windowed_hash(g, bits_s)
        for mask, out in (((mask_s, outs),) if norm == 0 else
                          ((mask_s, outs), (mask_l, outl))):
            cand = np.nonzero((h & mask) == mask)[0] + lo
            out.append(cand[cand >= start])   # overlap → the prior slab
    strict = (np.concatenate(outs) if outs else np.zeros(0, dtype=np.int64))
    if norm == 0:
        return strict, strict
    loose = (np.concatenate(outl) if outl else np.zeros(0, dtype=np.int64))
    return strict, loose


def cdc_cut_points(data: bytes, min_size: int, avg_size: int,
                   max_size: int, norm: int = 0) -> List[int]:
    """Boundary offsets (exclusive chunk ends, last == ``len(data)``) for
    content-defined chunking.  Every chunk is in ``[min_size, max_size]``
    except possibly the final tail.  Boundaries depend only on nearby
    content, so an insertion re-synchronizes at the next surviving candidate
    instead of cascading through the rest of the buffer.

    ``norm`` enables FastCDC-style normalized chunking: below ``avg_size``
    only a *stricter* mask (``norm`` extra bits) may cut, past it a
    *looser* one — chunk sizes concentrate around the average instead of
    following the bare geometric distribution, which shrinks both the
    tiny-chunk overhead tail and the max-size forced cuts.  ``norm=0``
    reproduces the single-mask boundaries of earlier releases exactly.
    """
    n = len(data)
    if n <= min_size:
        return [n]
    bits = min(max(avg_size.bit_length() - 1, 6), _CDC_MAX_BITS)
    strict, loose = _cdc_candidates(data, bits, norm)
    # boundary *offsets*: a candidate at byte i ends a chunk after i
    strict = strict + 1
    loose = loose + 1 if norm else strict
    cuts: List[int] = []
    last = 0
    while last < n:
        if n - last <= min_size:
            cuts.append(n)
            break
        hi_limit = min(last + max_size, n)
        mid = min(last + avg_size, hi_limit)
        cut = hi_limit
        i0 = int(np.searchsorted(strict, last + min_size, side="left"))
        i1 = int(np.searchsorted(strict, mid, side="left"))
        if i0 < i1:                       # strict mask cut in [min, avg)
            cut = int(strict[i0])
        else:
            j0 = int(np.searchsorted(loose, mid, side="left"))
            j1 = int(np.searchsorted(loose, hi_limit, side="right"))
            if j0 < j1:                   # loose mask cut in [avg, max]
                cut = int(loose[j0])
        cuts.append(cut)
        last = cut
    return cuts


@dataclass(frozen=True)
class ChunkSpec:
    """How an artifact's bytes are split into leaf blocks.

    ``strategy="fixed"`` slices every ``chunk_size`` bytes; ``strategy="cdc"``
    places boundaries where a rolling gear hash fires, bounded by
    ``min_size``/``max_size`` around an expected ``avg_size``, with
    ``norm`` extra mask bits of FastCDC-style normalization (0 = the
    legacy single-mask behavior).  Specs encode to a compact ASCII form
    (``fixed:262144`` / ``cdc:65536:262144:1048576`` /
    ``cdc:65536:262144:1048576:2`` when normalized) so publishers can
    record them in manifest meta and a re-publish — or a delta re-publish
    against a ``base`` version — reproduces identical boundaries, which is
    the whole point: boundary determinism is what makes unchanged content
    keep its CIDs.
    """

    strategy: str = "fixed"
    chunk_size: int = CHUNK_SIZE
    min_size: int = CHUNK_SIZE // 4
    avg_size: int = CHUNK_SIZE
    max_size: int = CHUNK_SIZE * 4
    norm: int = 0

    def __post_init__(self) -> None:
        if self.strategy not in ("fixed", "cdc"):
            raise ValueError(f"unknown chunking strategy {self.strategy!r}")
        if not isinstance(self.norm, int) or self.norm < 0:
            raise ValueError(f"norm must be a non-negative int, got "
                             f"{self.norm!r}")
        if self.strategy == "fixed":
            if self.chunk_size <= 0:
                raise ValueError("chunk_size must be positive")
            if self.norm:
                raise ValueError("norm only applies to cdc chunking")
        else:
            if not 0 < self.min_size <= self.avg_size <= self.max_size:
                raise ValueError(
                    "cdc requires 0 < min_size <= avg_size <= max_size, got "
                    f"{self.min_size}/{self.avg_size}/{self.max_size}")
            # chunk_size is unused for cdc: normalize it to avg_size so
            # equality and encode()/decode() round-trips never diverge on
            # derivable state
            object.__setattr__(self, "chunk_size", self.avg_size)

    @classmethod
    def cdc(cls, avg_size: int = 64 * 1024, min_size: Optional[int] = None,
            max_size: Optional[int] = None, norm: int = 0) -> "ChunkSpec":
        return cls(strategy="cdc", chunk_size=avg_size,
                   min_size=min_size if min_size is not None else avg_size // 4,
                   avg_size=avg_size,
                   max_size=max_size if max_size is not None else avg_size * 4,
                   norm=norm)

    def split(self, data: bytes) -> List[bytes]:
        if not data:
            return [b""]
        if self.strategy == "fixed":
            return chunk(data, self.chunk_size)
        cuts = cdc_cut_points(data, self.min_size, self.avg_size,
                              self.max_size, norm=self.norm)
        out = []
        last = 0
        for cut in cuts:
            out.append(data[last:cut])
            last = cut
        return out

    def encode(self) -> bytes:
        if self.strategy == "fixed":
            return b"fixed:%d" % self.chunk_size
        if self.norm:
            return b"cdc:%d:%d:%d:%d" % (self.min_size, self.avg_size,
                                         self.max_size, self.norm)
        # norm=0 keeps the 4-field form older releases wrote and read
        return b"cdc:%d:%d:%d" % (self.min_size, self.avg_size, self.max_size)

    @classmethod
    def decode(cls, raw: bytes) -> "ChunkSpec":
        try:
            fields = raw.decode("ascii").split(":")
            if fields[0] == "fixed" and len(fields) == 2:
                return cls(strategy="fixed", chunk_size=int(fields[1]))
            if fields[0] == "cdc" and len(fields) in (4, 5):
                mn, avg, mx = (int(f) for f in fields[1:4])
                norm = int(fields[4]) if len(fields) == 5 else 0
                return cls(strategy="cdc", chunk_size=avg, min_size=mn,
                           avg_size=avg, max_size=mx, norm=norm)
        except (UnicodeDecodeError, ValueError) as e:
            raise ValueError(f"bad ChunkSpec encoding {raw!r}") from e
        raise ValueError(f"bad ChunkSpec encoding {raw!r}")


# -- Merkle DAG manifests ----------------------------------------------------

_MAGIC = b"LDAG"       # v1: flat chunk list
_MAGIC2 = b"LDG2"      # v2: named sub-DAG entries


def manifest_version(data: bytes) -> int:
    """1 for flat v1, 2 for hierarchical v2; raises on anything else."""
    if data[:4] == _MAGIC:
        return 1
    if data[:4] == _MAGIC2:
        return 2
    raise ValueError("not a manifest block")


def is_manifest(data: bytes) -> bool:
    return data[:4] in (_MAGIC, _MAGIC2)


def encode_manifest(children: Sequence[CID], total_size: int,
                    meta: bytes = b"") -> bytes:
    out = [_MAGIC, struct.pack(">QI", total_size, len(children))]
    for c in children:
        out.append(struct.pack(">B", c.codec))
        out.append(c.digest)
    out.append(struct.pack(">I", len(meta)))
    out.append(meta)
    return b"".join(out)


def _take(data: bytes, off: int, n: int, what: str) -> Tuple[bytes, int]:
    """Bounds-checked slice for manifest decoding.  Truncated or garbage
    blocks must surface as ``ValueError`` (which the fetch paths translate to
    ``FetchError``), never as ``struct.error``/``IndexError`` — a corrupt
    block from a misbehaving peer is a protocol error, not a node crash."""
    end = off + n
    if n < 0 or end > len(data):
        raise ValueError(
            f"truncated manifest: {what} at offset {off} needs {n} bytes, "
            f"{len(data) - off} remain")
    return data[off:end], end


def decode_manifest(data: bytes) -> Tuple[List[CID], int, bytes]:
    if data[:4] != _MAGIC:
        raise ValueError("not a v1 manifest block")
    head, off = _take(data, 4, 12, "header")
    total_size, n = struct.unpack(">QI", head)
    children = []
    for i in range(n):
        raw, off = _take(data, off, 33, f"child {i}")
        children.append(CID(raw[0], raw[1:]))
    raw, off = _take(data, off, 4, "meta length")
    (meta_len,) = struct.unpack(">I", raw)
    meta, off = _take(data, off, meta_len, "meta")
    return children, total_size, meta


# -- v2 hierarchical manifests -----------------------------------------------


@dataclass(frozen=True)
class ManifestEntry:
    """One named sub-DAG in a v2 root manifest.

    ``cid`` is either a sub-manifest root (``CODEC_DAG``) or a raw leaf
    (``CODEC_RAW``); ``size`` is the decoded byte length of the entry's
    content; ``meta`` is opaque per-entry metadata (e.g. a tensor's
    dtype/shape) that travels in the *root* manifest so entry content stays
    a pure function of its bytes — maximizing sub-DAG reuse across versions.
    """

    name: str
    cid: CID
    size: int
    meta: bytes = b""


def encode_manifest_v2(entries: Sequence[ManifestEntry], total_size: int,
                       meta: bytes = b"") -> bytes:
    out = [_MAGIC2, struct.pack(">QI", total_size, len(entries))]
    for e in entries:
        name = e.name.encode("utf-8")
        out.append(struct.pack(">H", len(name)))
        out.append(name)
        out.append(struct.pack(">B", e.cid.codec))
        out.append(e.cid.digest)
        out.append(struct.pack(">QI", e.size, len(e.meta)))
        out.append(e.meta)
    out.append(struct.pack(">I", len(meta)))
    out.append(meta)
    return b"".join(out)


def decode_manifest_v2(data: bytes) -> Tuple[List[ManifestEntry], int, bytes]:
    if data[:4] != _MAGIC2:
        raise ValueError("not a v2 manifest block")
    head, off = _take(data, 4, 12, "header")
    total_size, n = struct.unpack(">QI", head)
    entries: List[ManifestEntry] = []
    for i in range(n):
        raw, off = _take(data, off, 2, f"entry {i} name length")
        (name_len,) = struct.unpack(">H", raw)
        raw, off = _take(data, off, name_len, f"entry {i} name")
        try:
            name = raw.decode("utf-8")
        except UnicodeDecodeError as e:
            raise ValueError(f"entry {i} name is not utf-8") from e
        raw, off = _take(data, off, 33, f"entry {i} cid")
        child = CID(raw[0], raw[1:])
        raw, off = _take(data, off, 12, f"entry {i} size/meta length")
        size, meta_len = struct.unpack(">QI", raw)
        meta, off = _take(data, off, meta_len, f"entry {i} meta")
        entries.append(ManifestEntry(name, child, size, meta))
    raw, off = _take(data, off, 4, "meta length")
    (meta_len,) = struct.unpack(">I", raw)
    meta, off = _take(data, off, meta_len, "meta")
    return entries, total_size, meta


def manifest_children(data: bytes) -> List[CID]:
    """Direct children of a manifest block, either version."""
    if manifest_version(data) == 1:
        return decode_manifest(data)[0]
    return [e.cid for e in decode_manifest_v2(data)[0]]


@dataclass
class DAG:
    root: CID
    blocks: Dict[CID, bytes]
    total_size: int
    #: v2 only: the root manifest's entries, in order
    entries: List[ManifestEntry] = field(default_factory=list)


def build_dag(data: bytes, chunk_size: int = CHUNK_SIZE, meta: bytes = b"",
              spec: Optional[ChunkSpec] = None) -> DAG:
    """Chunk ``data`` into leaf blocks + one flat (v1) manifest root block.

    ``spec`` selects the chunking strategy; when omitted, the historical
    fixed-``chunk_size`` layout is used, so pre-existing artifacts keep their
    root CIDs."""
    if spec is None:
        spec = ChunkSpec(strategy="fixed", chunk_size=chunk_size)
    leaves = spec.split(data)
    blocks: Dict[CID, bytes] = {}
    children: List[CID] = []
    for piece in leaves:
        c = CID.for_data(piece, CODEC_RAW)
        blocks[c] = piece
        children.append(c)
    manifest = encode_manifest(children, len(data), meta)
    root = CID.for_data(manifest, CODEC_DAG)
    blocks[root] = manifest
    return DAG(root=root, blocks=blocks, total_size=len(data))


def build_tree_dag(parts: Sequence[Tuple[str, bytes, bytes]],
                   chunk_size: int = CHUNK_SIZE, meta: bytes = b"",
                   spec: Optional[ChunkSpec] = None) -> DAG:
    """Build a hierarchical (v2) DAG: one sub-DAG per ``(name, data, meta)``
    part, rooted in a named-entry manifest.

    Identical part bytes (across parts, or vs a previously built version)
    hash to the identical sub-root CID — that is the structural-sharing
    property the delta-sync path relies on.  With a ``cdc`` :class:`ChunkSpec`
    sharing also survives *within-part* byte shifts: leaf boundaries are
    content-defined, so only the chunks overlapping an edit change CIDs.
    """
    blocks: Dict[CID, bytes] = {}
    entries: List[ManifestEntry] = []
    total = 0
    for name, data, part_meta in parts:
        sub = build_dag(data, chunk_size=chunk_size, spec=spec)
        blocks.update(sub.blocks)
        entries.append(ManifestEntry(name, sub.root, len(data), part_meta))
        total += len(data)
    manifest = encode_manifest_v2(entries, total, meta)
    root = CID.for_data(manifest, CODEC_DAG)
    blocks[root] = manifest
    return DAG(root=root, blocks=blocks, total_size=total, entries=entries)


def reassemble(root_block: bytes, fetch: Dict[CID, bytes]) -> bytes:
    children, total_size, _meta = decode_manifest(root_block)
    parts = []
    for c in children:
        blk = fetch[c]
        if not c.verify(blk):
            raise ValueError(f"block {c} failed verification")
        parts.append(blk)
    data = b"".join(parts)
    assert len(data) == total_size
    return data


def read_dag(root: CID, get: Callable[[CID], Optional[bytes]],
             verify: bool = True) -> bytes:
    """Reassemble a DAG of either manifest version from a block getter.

    Raises ``KeyError`` on a missing block and ``ValueError`` on a
    hash-verification failure, so callers can distinguish "fetch more"
    from "corrupt data".  ``verify=False`` skips the per-block sha256 —
    correct when the getter is a store that already verified on put
    (``BlockStore``); keep the default for untrusted mappings.
    """
    block = get(root)
    if block is None:
        raise KeyError(f"missing block {root}")
    if verify and not root.verify(block):
        raise ValueError(f"block {root} failed verification")
    if root.codec == CODEC_RAW:
        return block
    if manifest_version(block) == 1:
        children, total_size, _ = decode_manifest(block)
        data = b"".join(read_dag(c, get, verify) for c in children)
    else:
        entries, total_size, _ = decode_manifest_v2(block)
        data = b"".join(read_dag(e.cid, get, verify) for e in entries)
    if len(data) != total_size:
        raise ValueError(f"reassembled size mismatch under {root}")
    return data


def dag_reachable(root: CID,
                  get: Callable[[CID], Optional[bytes]]) -> List[CID]:
    """All CIDs reachable from ``root`` through manifests resolvable via
    ``get`` (deduplicated, pre-order).  Children whose blocks are absent are
    still listed — their sub-trees just aren't expanded."""
    seen: Dict[CID, None] = {}
    stack = [root]
    while stack:
        c = stack.pop()
        if c in seen:
            continue
        seen[c] = None
        if c.codec != CODEC_DAG:
            continue
        block = get(c)
        if block is None or not is_manifest(block):
            continue
        stack.extend(reversed(manifest_children(block)))
    return list(seen)
