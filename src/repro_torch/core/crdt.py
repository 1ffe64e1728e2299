"""Conflict-free Replicated Data Types (Shapiro et al. 2011).

The port's own copy of the JAX package's ``core/crdt.py``: the same code
under the port's import paths.

State-based (CvRDT) implementations with join-semilattice ``merge``:
merge is commutative, associative and idempotent, so replicas converge
regardless of delivery order, duplication, or partitions — exactly the
property Lattica's decentralized store relies on, and exactly what the
hypothesis tests in ``tests/test_crdt.py`` verify.

Since the delta-state redesign every kind is additionally a *delta-state*
CRDT (Almeida et al. 2018 style): ``vv()`` reports a replica's causal state
as a compact version-vector summary, and ``delta_since(vv)`` returns a
minimal mergeable fragment — the same type, carrying only the state the
summarized replica has not seen.  Syncing two replicas therefore moves
O(changed-state), not O(total-state), and a fragment is safe to merge at
*any* replica (fragments never overstate causal coverage: counters are
cumulative, registers ship full state, and ORSet coverage is recomputed
from the tags actually held).

The wire format is a canonical, versioned JSON codec (one schema per kind,
``encode_entry``/``decode_entry``); digests are computed over the canonical
encoding so two honest replicas can never disagree on a digest for equal
state (pickle bytes vary across Python/protocol versions — the old codec).
``ReplicatedStore.deserialize`` still accepts legacy pickled v1 state
through the ``safepickle`` restricted unpickler.

The ``ReplicatedStore`` composes named CRDTs into a document, exposes
per-key digests and a store-level causal context for the v2 sync protocol,
and a ``watch(prefix, callback)`` subscription API that fires on local and
merged-in remote changes — the foundation of the mesh's event-driven delta
push plane (``LatticaNode.watch_crdt``).
"""

from __future__ import annotations

import base64
import hashlib
import json
from typing import (Any, Callable, Dict, FrozenSet, Iterable, List, Optional,
                    Set, Tuple)

#: magic prefix of the canonical JSON wire format (store snapshots and
#: delta documents); anything else falls back to the legacy pickle path
WIRE_MAGIC = b"CRD2"

#: current wire schema version
WIRE_VERSION = 2


# ---------------------------------------------------------------------------
# Canonical value codec
# ---------------------------------------------------------------------------
#
# CRDT user values (register contents, set elements) are restricted to JSON
# primitives plus bytes / tuple / set / frozenset / non-str-keyed dicts,
# encoded with reserved single-key tag objects.  The encoding is canonical:
# dict keys sort, set elements sort by their encoded JSON — so equal values
# always produce identical bytes, which is what makes digests comparable
# across replicas.


def canonical_dumps(doc: Any) -> bytes:
    """Deterministic JSON bytes: sorted keys, no whitespace, no NaN/Inf."""
    return json.dumps(doc, sort_keys=True, separators=(",", ":"),
                      allow_nan=False).encode("utf-8")


def _enc_val(v: Any) -> Any:
    """Python value -> JSON-able doc.  Raises ``ValueError`` on types the
    canonical codec does not cover (store values must stay primitive).

    Numerics are normalized by Python value-equality: ``3.0`` encodes as
    ``3`` (and ``-0.0`` as ``0``), because ``3 == 3.0`` means they are the
    *same* set element / dict key to every replica — encoding them
    differently would let two equal-state replicas disagree on a digest
    forever.  (Bools keep their own type; mixing ``True`` with ``1`` in
    one container is outside the canonical domain.)"""
    if v is None or type(v) in (bool, int, str):
        return v
    if type(v) is float:
        if v != v or v in (float("inf"), float("-inf")):
            raise ValueError("canonical codec: NaN/Inf not representable")
        if v == int(v) and abs(v) < 2.0 ** 53:
            return int(v)
        return v
    if isinstance(v, bytes):
        return {"__b": base64.b64encode(v).decode("ascii")}
    if type(v) is tuple:
        return {"__t": [_enc_val(x) for x in v]}
    if type(v) is list:
        return {"__l": [_enc_val(x) for x in v]}
    if type(v) in (set, frozenset):
        enc = [_enc_val(x) for x in v]
        enc.sort(key=lambda d: canonical_dumps(d))
        return {"__s": enc}
    if type(v) is dict:
        pairs = [[_enc_val(k), _enc_val(x)] for k, x in v.items()]
        pairs.sort(key=lambda p: canonical_dumps(p[0]))
        return {"__d": pairs}
    raise ValueError(f"canonical codec: unsupported value type {type(v)!r}")


def _dec_val(doc: Any) -> Any:
    """Inverse of :func:`_enc_val`; raises ``ValueError`` on malformed docs.
    Sets decode to ``frozenset`` (hashable, ``==``-equal to the original)."""
    if doc is None or type(doc) in (bool, int, str, float):
        return doc
    if type(doc) is dict:
        if len(doc) != 1:
            raise ValueError("canonical codec: malformed tag object")
        tag, body = next(iter(doc.items()))
        if tag == "__b":
            if not isinstance(body, str):
                raise ValueError("canonical codec: bad bytes payload")
            try:
                return base64.b64decode(body.encode("ascii"), validate=True)
            except Exception as e:  # noqa: BLE001
                raise ValueError(f"canonical codec: bad base64: {e}") from e
        if tag == "__t" and isinstance(body, list):
            return tuple(_dec_val(x) for x in body)
        if tag == "__l" and isinstance(body, list):
            return [_dec_val(x) for x in body]
        if tag == "__s" and isinstance(body, list):
            return frozenset(_dec_val(x) for x in body)
        if tag == "__d" and isinstance(body, list):
            out = {}
            for p in body:
                if not (isinstance(p, list) and len(p) == 2):
                    raise ValueError("canonical codec: bad dict pair")
                out[_dec_val(p[0])] = _dec_val(p[1])
            return out
    raise ValueError(f"canonical codec: undecodable doc {type(doc)!r}")


def _str_int_map(d: Any) -> bool:
    """``{str: int}`` with genuine ints (bools refused)."""
    return isinstance(d, dict) and all(
        isinstance(k, str) and type(v) is int for k, v in d.items())


def _is_count_map(d: Any) -> bool:
    """``{replica: count}``: a :func:`_str_int_map` of non-negatives."""
    return _str_int_map(d) and all(v >= 0 for v in d.values())


def _vv_counts(vv: Any, field: str) -> Dict[str, int]:
    """Extract a count map from a peer-supplied version-vector summary;
    malformed summaries degrade to {} (send full state) instead of raising —
    a hostile vv must never crash the responder mid-sync."""
    if isinstance(vv, dict):
        m = vv.get(field)
        if _is_count_map(m):
            return m
    return {}


def _dec_tags(doc: Any) -> Set[Tuple[str, int]]:
    """Decode ``[[replica, seq], ...]`` into a tag set, validating shape."""
    if not isinstance(doc, list):
        raise ValueError("crdt codec: tag list expected")
    tags = set()
    for t in doc:
        if not (isinstance(t, list) and len(t) == 2
                and isinstance(t[0], str) and type(t[1]) is int and t[1] > 0):
            raise ValueError("crdt codec: malformed replica tag")
        tags.add((t[0], t[1]))
    return tags


def _enc_tags(tags: Iterable[Tuple[str, int]]) -> List[List[Any]]:
    return [[r, n] for r, n in sorted(tags)]


# ---------------------------------------------------------------------------
# CRDT kinds
# ---------------------------------------------------------------------------


class CRDT:
    """Interface: value(), merge(other) -> changed, vv(), delta_since(vv),
    to_doc()/from_doc(), copy()."""

    #: optional mutation listener, set by :class:`ReplicatedStore` so local
    #: writes fire ``watch`` callbacks and the node's delta push plane;
    #: never serialized (see ``__getstate__``)
    _listener: Optional[Callable[[], None]] = None

    def value(self) -> Any:
        raise NotImplementedError

    def merge(self, other: "CRDT") -> bool:
        raise NotImplementedError

    def vv(self) -> Dict[str, Any]:
        """Compact causal summary of this replica's state (JSON-able)."""
        raise NotImplementedError

    def delta_since(self, vv: Any) -> Optional["CRDT"]:
        """Minimal fragment a replica summarized by ``vv`` is missing, or
        ``None`` when it has seen everything.  ``vv=None`` (or malformed)
        means "knows nothing" — the fragment is then the full state."""
        raise NotImplementedError

    def to_doc(self) -> Dict[str, Any]:
        """Canonical JSON document for this state (one schema per kind)."""
        raise NotImplementedError

    def copy(self) -> "CRDT":
        import copy as _copy

        return _copy.deepcopy(self)

    # -- plumbing -----------------------------------------------------------
    def _notify(self) -> None:
        if self._listener is not None:
            self._listener()

    def __getstate__(self) -> Dict[str, Any]:
        state = dict(self.__dict__)
        state.pop("_listener", None)
        return state


# ---------------------------------------------------------------- counters


class GCounter(CRDT):
    """Grow-only counter: per-replica max.  The counts map doubles as the
    version vector, and deltas are cumulative — safe to merge anywhere."""

    def __init__(self) -> None:
        self.counts: Dict[str, int] = {}

    def increment(self, replica: str, n: int = 1) -> None:
        if n < 0:
            raise ValueError("GCounter cannot decrease")
        if n > 0:
            # never materialize a zero entry: merge can't propagate it
            # (0 > 0 is false), so it would exist on this replica only and
            # desynchronize digests between replicas of equal value forever
            self.counts[replica] = self.counts.get(replica, 0) + n
        self._notify()

    def value(self) -> int:
        return sum(self.counts.values())

    def merge(self, other: "GCounter") -> bool:
        changed = False
        for r, c in other.counts.items():
            if c > self.counts.get(r, 0):
                self.counts[r] = c
                changed = True
        return changed

    def vv(self) -> Dict[str, Any]:
        return {"c": dict(self.counts)}

    def delta_since(self, vv: Any) -> Optional["GCounter"]:
        seen = _vv_counts(vv, "c")
        news = {r: c for r, c in self.counts.items() if c > seen.get(r, 0)}
        if not news:
            return None
        d = GCounter()
        d.counts = news
        return d

    def to_doc(self) -> Dict[str, Any]:
        # zero entries (legacy unpickled state) are stripped: they carry no
        # information and never propagate through merge
        return {"k": "g", "c": {r: c for r, c in self.counts.items() if c}}

    @classmethod
    def from_doc(cls, doc: Dict[str, Any]) -> "GCounter":
        if not _is_count_map(doc.get("c")):
            raise ValueError("gcounter doc: bad counts map")
        c = cls()
        c.counts = {r: n for r, n in doc["c"].items() if n}
        return c


class PNCounter(CRDT):
    """Increment/decrement counter as a pair of GCounters.

    The causal summary is the per-replica *sum* p+n: both halves grow
    monotonically at their owner, so observed (p, n) snapshots of one
    replica form a chain totally ordered by their sum."""

    def __init__(self) -> None:
        self.p = GCounter()
        self.n = GCounter()

    def increment(self, replica: str, n: int = 1) -> None:
        self.p.increment(replica, n)
        self._notify()

    def decrement(self, replica: str, n: int = 1) -> None:
        self.n.increment(replica, n)
        self._notify()

    def value(self) -> int:
        return self.p.value() - self.n.value()

    def merge(self, other: "PNCounter") -> bool:
        a = self.p.merge(other.p)
        b = self.n.merge(other.n)
        return a or b

    def vv(self) -> Dict[str, Any]:
        tot = {}
        for r in set(self.p.counts) | set(self.n.counts):
            tot[r] = self.p.counts.get(r, 0) + self.n.counts.get(r, 0)
        return {"c": tot}

    def delta_since(self, vv: Any) -> Optional["PNCounter"]:
        seen = _vv_counts(vv, "c")
        d = PNCounter()
        stale = True
        for r in set(self.p.counts) | set(self.n.counts):
            tot = self.p.counts.get(r, 0) + self.n.counts.get(r, 0)
            if tot > seen.get(r, 0):
                stale = False
                if r in self.p.counts:
                    d.p.counts[r] = self.p.counts[r]
                if r in self.n.counts:
                    d.n.counts[r] = self.n.counts[r]
        return None if stale else d

    def to_doc(self) -> Dict[str, Any]:
        return {"k": "pn",
                "p": {r: c for r, c in self.p.counts.items() if c},
                "n": {r: c for r, c in self.n.counts.items() if c}}

    @classmethod
    def from_doc(cls, doc: Dict[str, Any]) -> "PNCounter":
        if not (_is_count_map(doc.get("p")) and _is_count_map(doc.get("n"))):
            raise ValueError("pncounter doc: bad counts maps")
        c = cls()
        c.p.counts = {r: n for r, n in doc["p"].items() if n}
        c.n.counts = {r: n for r, n in doc["n"].items() if n}
        return c


# ---------------------------------------------------------------- registers


class LWWRegister(CRDT):
    """Last-writer-wins register; ties broken by replica id (total order).

    Carries a per-replica write counter so ``delta_since`` can tell whether
    a peer has seen our latest write.  Deltas ship the full (tiny) state —
    a register fragment always justifies the clock it carries, so it is
    safe to merge at any replica."""

    def __init__(self) -> None:
        self.ts: Tuple[float, str] = (-1.0, "")
        self._value: Any = None
        self.clock: Dict[str, int] = {}

    def set(self, value: Any, timestamp: float, replica: str) -> None:
        self.clock[replica] = self.clock.get(replica, 0) + 1
        # float() keeps the canonical encoding stable: an int timestamp
        # would re-encode differently after a wire roundtrip
        if (float(timestamp), replica) > self.ts:
            self.ts = (float(timestamp), replica)
            self._value = value
        self._notify()

    def value(self) -> Any:
        return self._value

    def merge(self, other: "LWWRegister") -> bool:
        changed = False
        if other.ts > self.ts:
            self.ts = other.ts
            self._value = other._value
            changed = True
        for r, c in getattr(other, "clock", {}).items():
            if c > self.clock.get(r, 0):
                self.clock[r] = c
        return changed

    def vv(self) -> Dict[str, Any]:
        return {"c": dict(self.clock)}

    def delta_since(self, vv: Any) -> Optional["LWWRegister"]:
        if self.ts == (-1.0, "") and not self.clock:
            return None                         # virgin register: no state
        seen = _vv_counts(vv, "c")
        if self.clock and all(c <= seen.get(r, 0)
                              for r, c in self.clock.items()):
            return None
        return self.copy()

    def to_doc(self) -> Dict[str, Any]:
        return {"k": "lww", "t": [self.ts[0], self.ts[1]],
                "v": _enc_val(self._value), "c": dict(self.clock)}

    @classmethod
    def from_doc(cls, doc: Dict[str, Any]) -> "LWWRegister":
        ts = doc.get("t")
        if not (isinstance(ts, list) and len(ts) == 2
                and type(ts[0]) in (int, float) and isinstance(ts[1], str)
                and _is_count_map(doc.get("c"))):
            raise ValueError("lww doc: bad timestamp/clock")
        r = cls()
        r.ts = (float(ts[0]), ts[1])
        r._value = _dec_val(doc.get("v"))
        r.clock = dict(doc["c"])
        return r

    def __setstate__(self, state: Dict[str, Any]) -> None:
        # legacy pickled registers predate the write clock and may carry
        # an int timestamp; normalize both
        self.__dict__.update(state)
        self.__dict__.setdefault("clock", {})
        ts = self.__dict__.get("ts")
        if (isinstance(ts, tuple) and len(ts) == 2
                and isinstance(ts[0], (int, float))
                and not isinstance(ts[0], bool)):
            self.ts = (float(ts[0]), ts[1])


class MVRegister(CRDT):
    """Multi-value register with vector-clock causality (keeps siblings).
    The vector clock is the causal summary; deltas ship full state (the
    sibling set is already minimal)."""

    def __init__(self) -> None:
        self.versions: Dict[FrozenSet[Tuple[str, int]], Any] = {}
        self.clock: Dict[str, int] = {}

    def set(self, value: Any, replica: str) -> None:
        self.clock[replica] = self.clock.get(replica, 0) + 1
        vc = frozenset(self.clock.items())
        self.versions = {vc: value}
        self._notify()

    @staticmethod
    def _dominates(a: FrozenSet[Tuple[str, int]], b: FrozenSet[Tuple[str, int]]) -> bool:
        da, db = dict(a), dict(b)
        keys = set(da) | set(db)
        ge = all(da.get(k, 0) >= db.get(k, 0) for k in keys)
        gt = any(da.get(k, 0) > db.get(k, 0) for k in keys)
        return ge and gt

    def value(self) -> Tuple[Any, ...]:
        return tuple(self.versions[k] for k in sorted(self.versions, key=sorted))

    def merge(self, other: "MVRegister") -> bool:
        combined = dict(self.versions)
        combined.update(other.versions)
        keep = {}
        for vc, val in combined.items():
            if not any(self._dominates(o, vc) for o in combined if o != vc):
                keep[vc] = val
        changed = keep.keys() != self.versions.keys()
        self.versions = keep
        for r, c in other.clock.items():
            self.clock[r] = max(self.clock.get(r, 0), c)
        return changed

    def vv(self) -> Dict[str, Any]:
        return {"c": dict(self.clock)}

    def delta_since(self, vv: Any) -> Optional["MVRegister"]:
        if not self.clock and not self.versions:
            return None
        seen = _vv_counts(vv, "c")
        if self.clock and all(c <= seen.get(r, 0)
                              for r, c in self.clock.items()):
            return None
        return self.copy()

    def to_doc(self) -> Dict[str, Any]:
        vs = [[_enc_tags(vc), _enc_val(val)]
              for vc, val in self.versions.items()]
        vs.sort(key=lambda p: canonical_dumps(p[0]))
        return {"k": "mv", "vs": vs, "c": dict(self.clock)}

    @classmethod
    def from_doc(cls, doc: Dict[str, Any]) -> "MVRegister":
        if not (_is_count_map(doc.get("c")) and isinstance(doc.get("vs"), list)):
            raise ValueError("mv doc: bad clock/versions")
        r = cls()
        for p in doc["vs"]:
            if not (isinstance(p, list) and len(p) == 2):
                raise ValueError("mv doc: bad version pair")
            r.versions[frozenset(_dec_tags(p[0]))] = _dec_val(p[1])
        r.clock = dict(doc["c"])
        return r


# -------------------------------------------------------------------- sets


class ORSet(CRDT):
    """Observed-remove set: add wins over concurrent remove.

    Delta interface: adds are summarized by a per-replica *contiguous*
    coverage vector recomputed from the tags actually held (``coverage``),
    so a fragment merged at a replica that missed earlier fragments can
    never overstate what it has seen — gaps keep the coverage low and a
    later sync refills them.  Tombstones are summarized by a digest: any
    difference ships the (typically tiny) tombstone set whole."""

    def __init__(self) -> None:
        self.adds: Dict[Any, Set[Tuple[str, int]]] = {}
        self.tombstones: Set[Tuple[str, int]] = set()
        self._tag_seq: Dict[str, int] = {}

    def add(self, element: Any, replica: str) -> None:
        self._tag_seq[replica] = self._tag_seq.get(replica, 0) + 1
        tag = (replica, self._tag_seq[replica])
        self.adds.setdefault(element, set()).add(tag)
        self._notify()

    def remove(self, element: Any) -> None:
        tags = self.adds.get(element, set())
        self.tombstones |= tags
        self._notify()

    def contains(self, element: Any) -> bool:
        live = self.adds.get(element, set()) - self.tombstones
        return bool(live)

    def value(self) -> Set[Any]:
        return {e for e, tags in self.adds.items() if tags - self.tombstones}

    def merge(self, other: "ORSet") -> bool:
        changed = False
        for e, tags in other.adds.items():
            mine = self.adds.setdefault(e, set())
            if not tags <= mine:
                mine |= tags
                changed = True
        if not other.tombstones <= self.tombstones:
            self.tombstones |= other.tombstones
            changed = True
        for r, s in other._tag_seq.items():
            self._tag_seq[r] = max(self._tag_seq.get(r, 0), s)
        return changed

    # -- causal summary -----------------------------------------------------
    def coverage(self) -> Dict[str, int]:
        """Per-replica contiguous add-tag prefix actually held.  At a
        replica that never merged a gapped fragment this equals the tag
        allocator; after a gap it is truthfully lower, so peers resend."""
        held: Dict[str, Set[int]] = {}
        for tags in self.adds.values():
            for r, n in tags:
                held.setdefault(r, set()).add(n)
        cov = {}
        for r, seqs in held.items():
            c = 0
            while c + 1 in seqs:
                c += 1
            if c:
                cov[r] = c
        return cov

    def _tomb_digest(self) -> str:
        raw = canonical_dumps(_enc_tags(self.tombstones))
        return base64.b64encode(
            hashlib.sha256(raw).digest()[:8]).decode("ascii")

    def vv(self) -> Dict[str, Any]:
        return {"s": self.coverage(), "t": self._tomb_digest()}

    def delta_since(self, vv: Any) -> Optional["ORSet"]:
        seen = _vv_counts(vv, "s")
        tomb_seen = vv.get("t") if isinstance(vv, dict) else None
        d = ORSet()
        fresh = False
        for e, tags in self.adds.items():
            new = {t for t in tags if t[1] > seen.get(t[0], 0)}
            if new:
                d.adds[e] = new
                fresh = True
        if self.tombstones and tomb_seen != self._tomb_digest():
            d.tombstones = set(self.tombstones)
            fresh = True
        if not fresh:
            return None
        d._tag_seq = dict(self._tag_seq)    # allocator state, not coverage
        return d

    def to_doc(self) -> Dict[str, Any]:
        adds = [[_enc_val(e), _enc_tags(tags)]
                for e, tags in self.adds.items()]
        adds.sort(key=lambda p: canonical_dumps(p[0]))
        return {"k": "orset", "a": adds,
                "t": _enc_tags(self.tombstones), "s": dict(self._tag_seq)}

    @classmethod
    def from_doc(cls, doc: Dict[str, Any]) -> "ORSet":
        if not (isinstance(doc.get("a"), list) and _is_count_map(doc.get("s"))):
            raise ValueError("orset doc: bad adds/seq")
        s = cls()
        for p in doc["a"]:
            if not (isinstance(p, list) and len(p) == 2):
                raise ValueError("orset doc: bad add pair")
            elem = _dec_val(p[0])
            try:
                hash(elem)
            except TypeError as e:
                raise ValueError("orset doc: unhashable element") from e
            s.adds[elem] = _dec_tags(p[1])
        s.tombstones = _dec_tags(doc.get("t", []))
        s._tag_seq = dict(doc["s"])
        return s


# ----------------------------------------------------------- codec dispatch


_KINDS = {"g": GCounter, "pn": PNCounter, "lww": LWWRegister,
          "mv": MVRegister, "orset": ORSet}
_KIND_TAGS = {cls: tag for tag, cls in _KINDS.items()}


def encode_entry(entry: CRDT) -> Dict[str, Any]:
    """CRDT -> canonical JSON document (tagged with its kind)."""
    if type(entry) not in _KIND_TAGS:
        raise ValueError(f"unknown CRDT kind {type(entry).__name__}")
    return entry.to_doc()


def decode_entry(doc: Any) -> CRDT:
    """Canonical JSON document -> CRDT; raises ``ValueError`` on anything
    malformed (documents arrive from arbitrary peers)."""
    if not isinstance(doc, dict):
        raise ValueError("crdt doc: object expected")
    cls = _KINDS.get(doc.get("k"))
    if cls is None:
        raise ValueError(f"crdt doc: unknown kind {doc.get('k')!r}")
    return cls.from_doc(doc)


def entry_digest(entry: CRDT) -> bytes:
    """Stable state fingerprint: sha256 over the canonical encoding."""
    return hashlib.sha256(canonical_dumps(encode_entry(entry))).digest()


def _tag_set(s: Any) -> bool:
    """Replica tags: a set/frozenset of ``(replica, seq)`` pairs."""
    return isinstance(s, (set, frozenset)) and all(
        isinstance(t, tuple) and len(t) == 2
        and isinstance(t[0], str) and isinstance(t[1], int) for t in s)


def _wire_valid(entry: Any) -> bool:
    """Deep shape check for a peer-supplied *legacy pickled* CRDT: the
    restricted unpickler guarantees the classes, but an attacker still
    controls the instance state, and type-confused internals (a str count,
    an unsortable clock) would blow up later inside merge()/digest() —
    after partial mutation.  Validate everything merge relies on before any
    of it is let near local state.  (The canonical JSON path validates in
    ``from_doc`` instead.)"""
    try:
        t = type(entry)
        if t is GCounter:
            return (_str_int_map(entry.counts)
                    and all(v >= 0 for v in entry.counts.values()))
        if t is PNCounter:
            return (type(entry.p) is GCounter and _wire_valid(entry.p)
                    and type(entry.n) is GCounter and _wire_valid(entry.n))
        if t is LWWRegister:
            ts = entry.ts
            return (isinstance(ts, tuple) and len(ts) == 2
                    and isinstance(ts[0], (int, float))
                    and not isinstance(ts[0], bool) and isinstance(ts[1], str)
                    and _str_int_map(getattr(entry, "clock", {})))
        if t is MVRegister:
            return (_str_int_map(entry.clock)
                    and isinstance(entry.versions, dict)
                    and all(isinstance(vc, frozenset) and _tag_set(vc)
                            for vc in entry.versions))
        if t is ORSet:
            return (isinstance(entry.adds, dict)
                    and all(_tag_set(tags) for tags in entry.adds.values())
                    and _tag_set(entry.tombstones)
                    and _str_int_map(entry._tag_seq))
        return False
    except AttributeError:      # attacker-controlled __dict__ may omit slots
        return False


# ----------------------------------------------------------- composed store


class ReplicatedStore(CRDT):
    """A named map of CRDTs — Lattica's decentralized data store.

    Used as the model-version registry: an ORSet of published checkpoint
    CIDs, an LWW pointer to the latest manifest, and G-Counters for global
    step / sample counts.

    Sync surface (the v2 anti-entropy protocol is built on these):

    * ``digest()``          — order-independent full-state fingerprint
    * ``key_digests()``     — per-key truncated fingerprints (summary round)
    * ``vv()``              — store-level causal context {key: kind vv}
    * ``delta_since(vv)``   — {key: fragment} of everything a peer misses
    * ``apply_delta(...)``  — merge fragments, firing ``watch`` callbacks

    ``watch(prefix, callback)`` subscribes to changes: the callback fires as
    ``callback(key, value, origin)`` on local mutations (origin="local") and
    on merged-in remote state (origin="remote").
    """

    def __init__(self, replica: str = "") -> None:
        self.replica = replica
        self.entries: Dict[str, CRDT] = {}
        self._watchers: Dict[int, Tuple[str, Callable[[str, Any, str], None]]] = {}
        self._watch_seq = 0
        self._local_hooks: List[Callable[[str], None]] = []
        # per-key digest cache: entry_digest() re-serializes the whole entry,
        # which turns every anti-entropy probe into O(keys x state) at fleet
        # scale; invalidated on any touch (merge may mutate bookkeeping such
        # as ORSet._tag_seq even when it reports no change)
        self._digest_cache: Dict[str, bytes] = {}
        self._summary_gen = 0
        self._forest_cache: Optional[
            Tuple[int, Dict[str, "MerkleSummaryTree"]]] = None

    # -- typed accessors ----------------------------------------------------
    def _get(self, key: str, kind: str) -> CRDT:
        if key not in self.entries:
            self._adopt(key, _KINDS[kind]())
        entry = self.entries[key]
        if not isinstance(entry, _KINDS[kind]):
            raise TypeError(f"{key} is {type(entry).__name__}, wanted {kind}")
        return entry

    def counter(self, key: str) -> GCounter:
        return self._get(key, "g")  # type: ignore[return-value]

    def pncounter(self, key: str) -> PNCounter:
        return self._get(key, "pn")  # type: ignore[return-value]

    def register(self, key: str) -> LWWRegister:
        return self._get(key, "lww")  # type: ignore[return-value]

    def orset(self, key: str) -> ORSet:
        return self._get(key, "orset")  # type: ignore[return-value]

    def mv(self, key: str) -> MVRegister:
        return self._get(key, "mv")  # type: ignore[return-value]

    def _adopt(self, key: str, entry: CRDT) -> CRDT:
        """Install ``entry`` under ``key`` wired to the watch plane."""
        self.entries[key] = entry
        entry._listener = lambda k=key: self._on_local_mutation(k)
        self._dirty(key)
        return entry

    def _dirty(self, key: str) -> None:
        """Drop cached summary state for a touched key."""
        self._digest_cache.pop(key, None)
        self._summary_gen += 1

    # -- watch plane ---------------------------------------------------------
    def watch(self, prefix: str,
              callback: Callable[[str, Any, str], None]) -> int:
        """Subscribe ``callback(key, value, origin)`` to every change of a
        key starting with ``prefix`` ("" watches everything).  Fires on
        local mutations and on merged-in remote state.  Returns a handle
        for :meth:`unwatch`."""
        self._watch_seq += 1
        self._watchers[self._watch_seq] = (prefix, callback)
        return self._watch_seq

    def unwatch(self, handle: int) -> None:
        self._watchers.pop(handle, None)

    def on_local_change(self, hook: Callable[[str], None]) -> None:
        """Register a store-wide local-mutation hook (the node's delta push
        plane); called with the mutated key before watch callbacks."""
        self._local_hooks.append(hook)

    def _on_local_mutation(self, key: str) -> None:
        self._dirty(key)
        for hook in list(self._local_hooks):
            hook(key)
        self._fire(key, "local")

    def _fire(self, key: str, origin: str) -> None:
        entry = self.entries.get(key)
        if entry is None:       # defensive: watcher raced an adoption
            return
        for prefix, cb in list(self._watchers.values()):
            if key.startswith(prefix):
                cb(key, entry.value(), origin)

    # -- CRDT interface ------------------------------------------------------
    def value(self) -> Dict[str, Any]:
        return {k: v.value() for k, v in self.entries.items()}

    def merge(self, other: "ReplicatedStore") -> bool:
        changed_keys = []
        for k, v in other.entries.items():
            if k in self.entries:
                self._dirty(k)
                if self.entries[k].merge(v):  # type: ignore[arg-type]
                    changed_keys.append(k)
            else:
                self._adopt(k, v.copy())
                changed_keys.append(k)
        for k in changed_keys:
            self._fire(k, "remote")
        return bool(changed_keys)

    # -- causal context / deltas ----------------------------------------------
    def vv(self) -> Dict[str, Any]:
        """Store-level causal context: {key: kind-specific version vector}."""
        return {k: e.vv() for k, e in self.entries.items()}

    def entry_vv(self, key: str) -> Optional[Dict[str, Any]]:
        entry = self.entries.get(key)
        return None if entry is None else entry.vv()

    def entry_digest_cached(self, key: str) -> bytes:
        """Full 32-byte state fingerprint of one entry, memoized until the
        entry is next touched (mutation, merge, or delta application)."""
        d = self._digest_cache.get(key)
        if d is None:
            d = self._digest_cache[key] = entry_digest(self.entries[key])
        return d

    def key_digests(self) -> Dict[str, str]:
        """Per-key truncated state fingerprints — the *flat* v2 summary
        round, O(keys) bytes per probe.  Superseded by the Merkle summary
        forest (:meth:`summary_forest`) for sim-executing sync paths; kept
        as the negotiated v2 wire fallback (latlint L007 flags new callers
        outside the fallback path)."""
        return {k: base64.b64encode(self.entry_digest_cached(k)[:8]).decode("ascii")
                for k in self.entries}

    def summary_forest(self) -> Dict[str, "MerkleSummaryTree"]:
        """Namespace-sharded Merkle summary trees (independent roots per
        namespace), rebuilt lazily when any entry has been touched.  The
        MST probe walks these to localize differing keys in O(log n) tree
        nodes instead of shipping every key's digest."""
        cached = self._forest_cache
        if cached is not None and cached[0] == self._summary_gen:
            return cached[1]
        by_ns: Dict[str, Dict[str, bytes]] = {}
        for k in self.entries:
            ns = k.split("/", 1)[0]
            by_ns.setdefault(ns, {})[k] = self.entry_digest_cached(k)[:8]
        forest = {ns: MerkleSummaryTree(kd) for ns, kd in by_ns.items()}
        self._forest_cache = (self._summary_gen, forest)
        return forest

    def summary_roots(self) -> Dict[str, str]:
        """{namespace: MST root hash (hex)} — the O(namespaces) probe."""
        return {ns: t.root() for ns, t in self.summary_forest().items()}

    def delta_since(self, vv_map: Any,
                    keys: Optional[Iterable[str]] = None) -> Dict[str, CRDT]:
        """Per-key fragments a replica summarized by ``vv_map`` is missing.
        ``vv_map`` maps key -> kind vv (or None = key unknown there); keys
        absent from the map count as unknown.  With ``keys``, only those
        are considered (the per-key protocol round)."""
        if not isinstance(vv_map, dict):
            vv_map = {}
        out: Dict[str, CRDT] = {}
        for k in (keys if keys is not None else self.entries):
            entry = self.entries.get(k)
            if entry is None:
                continue
            d = entry.delta_since(vv_map.get(k))
            if d is not None:
                out[k] = d
        return out

    def apply_delta(self, deltas: Dict[str, CRDT],
                    origin: str = "remote") -> List[str]:
        """Merge per-key fragments; returns the keys that changed (watch
        callbacks fire for each).  Raises ``ValueError`` on a kind conflict
        with local state — and validates the *whole* document before
        merging any of it, so a poisoned fragment can never land part of a
        delta without its watch callbacks firing."""
        for k, frag in deltas.items():
            if not isinstance(k, str) or not isinstance(frag, CRDT):
                raise ValueError("delta: malformed fragment map")
            cur = self.entries.get(k)
            if cur is not None and type(cur) is not type(frag):
                raise ValueError(
                    f"delta kind conflict for {k!r}: "
                    f"{type(cur).__name__} vs {type(frag).__name__}")
        changed = []
        for k, frag in deltas.items():
            cur = self.entries.get(k)
            if cur is None:
                self._adopt(k, frag.copy())
                changed.append(k)
            else:
                self._dirty(k)
                if cur.merge(frag):  # type: ignore[arg-type]
                    changed.append(k)
        for k in changed:
            self._fire(k, origin)
        return changed

    # -- sync helpers ----------------------------------------------------------
    def digest(self) -> bytes:
        """Order-independent fingerprint of the full state."""
        h = hashlib.sha256()
        for k in sorted(self.entries):
            h.update(k.encode())
            h.update(self.entry_digest_cached(k))
        return h.digest()

    @staticmethod
    def _canonical(entry: CRDT) -> bytes:
        """Canonical bytes of one entry's state (codec-based; stable across
        Python and pickle-protocol versions, unlike the old pickle.dumps)."""
        return canonical_dumps(encode_entry(entry))

    # -- wire format -----------------------------------------------------------
    #: globals legacy anti-entropy state may resolve: the CRDT classes
    #: themselves plus set/frozenset (which pickle routes through
    #: find_class).  The payload arrives from arbitrary peers, so everything
    #: else is refused — an open pickle.loads here would hand the sender
    #: code execution.
    _WIRE_ALLOWED = frozenset({
        ("repro.core.crdt", "GCounter"),
        ("repro.core.crdt", "PNCounter"),
        ("repro.core.crdt", "LWWRegister"),
        ("repro.core.crdt", "MVRegister"),
        ("repro.core.crdt", "ORSet"),
        ("builtins", "set"),
        ("builtins", "frozenset"),
    })

    def serialize(self) -> bytes:
        """Canonical versioned snapshot (v2 JSON wire format)."""
        doc = {"v": WIRE_VERSION,
               "entries": {k: encode_entry(e) for k, e in self.entries.items()}}
        return WIRE_MAGIC + canonical_dumps(doc)

    @staticmethod
    def encode_delta(deltas: Dict[str, CRDT]) -> bytes:
        """Per-key fragments -> canonical versioned delta document."""
        doc = {"v": WIRE_VERSION,
               "d": {k: encode_entry(e) for k, e in deltas.items()}}
        return WIRE_MAGIC + canonical_dumps(doc)

    @staticmethod
    def decode_delta(raw: bytes) -> Dict[str, CRDT]:
        """Decode + validate a peer-supplied delta document."""
        doc = _load_wire_doc(raw)
        d = doc.get("d")
        if not isinstance(d, dict):
            raise ValueError("delta doc: missing fragment map")
        return {_chk_key(k): decode_entry(v) for k, v in d.items()}

    @classmethod
    def deserialize(cls, data: bytes, replica: str = "") -> "ReplicatedStore":
        """Decode peer-supplied state; raises ``ValueError`` on payloads
        that are malformed or carry anything beyond CRDTs and primitives.
        Accepts both the canonical v2 JSON format and legacy pickled v1
        state (restricted unpickling, CRDT classes only)."""
        if data[:len(WIRE_MAGIC)] == WIRE_MAGIC:
            doc = _load_wire_doc(data)
            raw_entries = doc.get("entries")
            if not isinstance(raw_entries, dict):
                raise ValueError("CRDT state must be a {name: doc} map")
            store = cls(replica)
            for k, d in raw_entries.items():
                store._adopt(_chk_key(k), decode_entry(d))
            return store
        from .safepickle import restricted_loads

        entries = restricted_loads(data, cls._WIRE_ALLOWED)
        if not isinstance(entries, dict):
            raise ValueError("CRDT state must be a {name: CRDT} dict")
        for k, v in entries.items():
            if not isinstance(k, str) or not _wire_valid(v):
                raise ValueError(f"malformed CRDT state for entry {k!r}")
        store = cls(replica)
        for k, v in entries.items():
            store._adopt(k, v)
        return store


def _chk_key(k: Any) -> str:
    if not isinstance(k, str) or not k:
        raise ValueError("crdt doc: entry keys must be non-empty strings")
    return k


def _load_wire_doc(raw: bytes) -> Dict[str, Any]:
    """Parse + version-check a ``CRD2``-magic wire document."""
    if raw[:len(WIRE_MAGIC)] != WIRE_MAGIC:
        raise ValueError("crdt wire: bad magic")
    try:
        doc = json.loads(raw[len(WIRE_MAGIC):].decode("utf-8"))
    except Exception as e:  # noqa: BLE001 — undecodable peer payload
        raise ValueError(f"crdt wire: undecodable JSON: {e}") from e
    if not isinstance(doc, dict) or doc.get("v") != WIRE_VERSION:
        raise ValueError("crdt wire: unsupported document version")
    return doc


# ----------------------------------------------------------- summary wire


def encode_summary(digests: Dict[str, str]) -> bytes:
    """Per-key digest map -> summary request document."""
    return WIRE_MAGIC + canonical_dumps({"v": WIRE_VERSION, "kd": digests})


def decode_summary(raw: bytes) -> Dict[str, str]:
    doc = _load_wire_doc(raw)
    kd = doc.get("kd")
    if not (isinstance(kd, dict) and all(
            isinstance(k, str) and isinstance(v, str) for k, v in kd.items())):
        raise ValueError("summary doc: bad digest map")
    return kd


def encode_vv_map(vv_map: Dict[str, Optional[Dict[str, Any]]]) -> bytes:
    """{key: kind vv or None} -> summary response document."""
    return WIRE_MAGIC + canonical_dumps({"v": WIRE_VERSION, "vv": vv_map})


def decode_vv_map(raw: bytes) -> Dict[str, Optional[Dict[str, Any]]]:
    doc = _load_wire_doc(raw)
    vv = doc.get("vv")
    if not (isinstance(vv, dict) and all(
            isinstance(k, str) and (v is None or isinstance(v, dict))
            for k, v in vv.items())):
        raise ValueError("vv doc: bad version-vector map")
    return vv


def encode_delta_request(vv_map: Dict[str, Optional[Dict[str, Any]]],
                         deltas: Dict[str, CRDT]) -> bytes:
    """The delta round's request: the caller's per-key vv for the keys it
    wants updates on, plus its own fragments for the responder."""
    doc = {"v": WIRE_VERSION, "vv": vv_map,
           "d": {k: encode_entry(e) for k, e in deltas.items()}}
    return WIRE_MAGIC + canonical_dumps(doc)


def decode_delta_request(raw: bytes) -> Tuple[
        Dict[str, Optional[Dict[str, Any]]], Dict[str, CRDT]]:
    doc = _load_wire_doc(raw)
    vv = doc.get("vv")
    d = doc.get("d")
    if not (isinstance(vv, dict) and isinstance(d, dict)):
        raise ValueError("delta request: bad vv/fragment maps")
    vv_map = {}
    for k, v in vv.items():
        if not isinstance(k, str) or not (v is None or isinstance(v, dict)):
            raise ValueError("delta request: bad vv entry")
        vv_map[k] = v
    deltas = {_chk_key(k): decode_entry(v) for k, v in d.items()}
    return vv_map, deltas


def _chk_vv_map(vv: Any, what: str) -> Dict[str, Optional[Dict[str, Any]]]:
    if not isinstance(vv, dict):
        raise ValueError(f"{what}: bad vv map")
    out: Dict[str, Optional[Dict[str, Any]]] = {}
    for k, v in vv.items():
        if not isinstance(k, str) or not (v is None or isinstance(v, dict)):
            raise ValueError(f"{what}: bad vv entry")
        out[k] = v
    return out


def encode_delta2_request(vv_map: Dict[str, Optional[Dict[str, Any]]],
                          deltas: Dict[str, "CRDT"],
                          buckets: List[Tuple[str, str]]) -> bytes:
    """The MST delta round's request: the caller's per-key vv (including
    every key it holds under the listed reconcile buckets), its push
    fragments, and the differing leaf-bucket paths — the responder ships
    full state for its keys under those paths absent from the vv map."""
    doc = {"v": WIRE_VERSION, "vv": vv_map,
           "d": {k: encode_entry(e) for k, e in deltas.items()},
           "b": [[ns, p] for ns, p in buckets]}
    return WIRE_MAGIC + canonical_dumps(doc)


def decode_delta2_request(raw: bytes) -> Tuple[
        Dict[str, Optional[Dict[str, Any]]], Dict[str, "CRDT"],
        List[Tuple[str, str]]]:
    doc = _load_wire_doc(raw)
    vv_map = _chk_vv_map(doc.get("vv"), "delta2 request")
    d = doc.get("d")
    b = doc.get("b")
    if not isinstance(d, dict) or not isinstance(b, list) or len(b) > 4096:
        raise ValueError("delta2 request: bad fragment/bucket lists")
    deltas = {_chk_key(k): decode_entry(v) for k, v in d.items()}
    buckets = []
    for item in b:
        if not (isinstance(item, list) and len(item) == 2):
            raise ValueError("delta2 request: bad bucket")
        buckets.append((_chk_key(item[0]), _chk_path(item[1])))
    return vv_map, deltas, buckets


def encode_delta2_response(deltas: Dict[str, "CRDT"],
                           want: Dict[str, Optional[Dict[str, Any]]]
                           ) -> bytes:
    """The responder's fragments plus ``want`` — its vv for the keys where
    the caller's vv shows state the responder lacks, answered by one
    push-only ``crdt.delta`` follow-up."""
    doc = {"v": WIRE_VERSION,
           "d": {k: encode_entry(e) for k, e in deltas.items()},
           "w": want}
    return WIRE_MAGIC + canonical_dumps(doc)


def decode_delta2_response(raw: bytes) -> Tuple[
        Dict[str, "CRDT"], Dict[str, Optional[Dict[str, Any]]]]:
    doc = _load_wire_doc(raw)
    d = doc.get("d")
    if not isinstance(d, dict):
        raise ValueError("delta2 response: bad fragment map")
    deltas = {_chk_key(k): decode_entry(v) for k, v in d.items()}
    return deltas, _chk_vv_map(doc.get("w"), "delta2 response")


# ----------------------------------------------------------- Merkle summary


#: children per internal MST node (one hex nibble of the key-placement hash)
MST_FANOUT = 16

#: maximum keys a leaf bucket holds before it splits into an internal node
MST_LEAF_SIZE = 8

#: hex chars of a subtree hash shipped on the wire.  The walk only ever
#: compares hashes for equality, so 32 bits is collision headroom against
#: the ~1e3 comparisons a probe makes — and the astronomically-rare false
#: equality merely delays one subtree to the next anti-entropy round.
#: Full-width hashes stay internal to the tree.
MST_WIRE_HASH = 8


def mst_wire_hash(h: str) -> str:
    """Truncate an internal node hash to its wire width."""
    return h[:MST_WIRE_HASH]


def _mst_place(key: str) -> str:
    """Deterministic trie placement for a key: hex of sha256(key).  Equal
    key sets therefore always produce identical tree *shapes* regardless of
    insertion order or which replica built the tree."""
    return hashlib.sha256(key.encode("utf-8")).hexdigest()


class MerkleSummaryTree:
    """Deterministic Merkle prefix trie over ``{key: digest8}``.

    Keys are placed by the hex prefix of ``sha256(key)``; a subtree with at
    most :data:`MST_LEAF_SIZE` keys is a leaf bucket, anything larger splits
    on the next nibble.  Node hashes cover the sorted ``(key, digest)``
    content of the whole subtree, so two replicas with equal key state agree
    on every node hash — and a differing key is localized by walking the
    O(log n) differing path instead of exchanging every key's digest.

    The tree is immutable once built; ``ReplicatedStore.summary_forest``
    rebuilds (from cached per-key digests) only when an entry was touched.
    """

    def __init__(self, key_digests: Dict[str, bytes]) -> None:
        self._kd = dict(key_digests)
        self._paths = {k: _mst_place(k) for k in self._kd}
        # sorted once: children and leaf listings derive from slices
        self._order = sorted(self._kd)
        self._hash_cache: Dict[str, str] = {}

    def __len__(self) -> int:
        return len(self._kd)

    def keys_under(self, path: str) -> List[str]:
        """All keys whose placement hash starts with ``path`` (hex)."""
        return [k for k in self._order if self._paths[k].startswith(path)]

    def is_leaf(self, path: str) -> bool:
        return len(self.keys_under(path)) <= MST_LEAF_SIZE

    def node_hash(self, path: str) -> str:
        """Hex hash of the subtree at ``path`` ('' = root).  Empty subtrees
        hash to a distinguished constant so presence/absence is visible."""
        h = self._hash_cache.get(path)
        if h is None:
            keys = self.keys_under(path)
            acc = hashlib.sha256(b"MST1")
            for k in keys:
                acc.update(k.encode("utf-8"))
                acc.update(self._kd[k])
            h = self._hash_cache[path] = acc.hexdigest()
        return h

    def root(self) -> str:
        return self.node_hash("")

    def children(self, path: str) -> Dict[str, str]:
        """{nibble: child hash} for the non-empty children of an internal
        node (callers must not ask for children of a leaf)."""
        out: Dict[str, str] = {}
        for k in self.keys_under(path):
            nib = self._paths[k][len(path)]
            out.setdefault(nib, "")
        return {nib: self.node_hash(path + nib) for nib in out}

    def leaf_digests(self, path: str) -> Dict[str, str]:
        """{key: digest8 (b64)} for the keys in a leaf bucket."""
        return {k: base64.b64encode(self._kd[k]).decode("ascii")
                for k in self.keys_under(path)}


# MST probe wire documents.  One idempotent unary (``crdt.mst``) carries a
# batch of subtree queries; responses describe each queried node (internal
# children, or a leaf's keys with digest + per-key vv so the caller can run
# the existing delta round without another O(keys) exchange).

_HEX_NIBBLES = frozenset("0123456789abcdef")


def _chk_path(p: Any) -> str:
    if not isinstance(p, str) or len(p) > 64 or not set(p) <= _HEX_NIBBLES:
        raise ValueError("mst doc: bad subtree path")
    return p


def encode_mst_request(queries: List[Tuple[str, str]],
                       want_roots: bool = False) -> bytes:
    """Batch of ``(namespace, path)`` subtree queries, grouped by namespace
    so each ns string ships once; ``want_roots`` asks the responder to
    include its full {ns: root} map (first round)."""
    by_ns: Dict[str, List[str]] = {}
    for ns, p in queries:
        by_ns.setdefault(ns, []).append(p)
    doc: Dict[str, Any] = {"v": WIRE_VERSION, "q": by_ns}
    if want_roots:
        doc["r"] = True
    return WIRE_MAGIC + canonical_dumps(doc)


def decode_mst_request(raw: bytes) -> Tuple[bool, List[Tuple[str, str]]]:
    doc = _load_wire_doc(raw)
    q = doc.get("q")
    if not isinstance(q, dict):
        raise ValueError("mst request: bad query map")
    queries = []
    for ns, paths in q.items():
        if not isinstance(paths, list):
            raise ValueError("mst request: bad path list")
        for p in paths:
            queries.append((_chk_key(ns), _chk_path(p)))
    if len(queries) > 4096:
        raise ValueError("mst request: bad query list")
    return bool(doc.get("r")), queries


_CHILD_STRIDE = 1 + MST_WIRE_HASH


def _pack_children(children: Dict[str, str]) -> str:
    """{nibble: full hash} -> fixed-stride ``<nib><hash8>`` string (the
    probe's dominant wire term; a JSON map of full hashes costs ~8x)."""
    return "".join(nib + mst_wire_hash(h)
                   for nib, h in sorted(children.items()))


def _unpack_children(packed: str) -> Dict[str, str]:
    if len(packed) % _CHILD_STRIDE:
        raise ValueError("mst response: bad child packing")
    out: Dict[str, str] = {}
    for i in range(0, len(packed), _CHILD_STRIDE):
        nib = packed[i]
        if nib not in _HEX_NIBBLES:
            raise ValueError("mst response: bad child nibble")
        out[nib] = packed[i + 1:i + _CHILD_STRIDE]
    return out


def encode_mst_response(nodes: List[Dict[str, Any]],
                        roots: Optional[Dict[str, str]] = None) -> bytes:
    """``nodes``: one doc per query — {"ns", "p", "t": "i"|"l"|"x", and
    "c" (internal: {nibble: full hash}, packed + truncated on the wire) or
    "kd" (leaf: {key: [digest8, vv]})}.  Root hashes are truncated too."""
    wire_nodes = []
    for nd in nodes:
        if nd.get("t") == "i":
            nd = dict(nd)
            nd["c"] = _pack_children(nd["c"])
        wire_nodes.append(nd)
    doc: Dict[str, Any] = {"v": WIRE_VERSION, "n": wire_nodes}
    if roots is not None:
        doc["roots"] = {ns: mst_wire_hash(h) for ns, h in roots.items()}
    return WIRE_MAGIC + canonical_dumps(doc)


def decode_mst_response(raw: bytes) -> Tuple[
        Optional[Dict[str, str]], List[Dict[str, Any]]]:
    doc = _load_wire_doc(raw)
    roots = doc.get("roots")
    if roots is not None:
        if not (isinstance(roots, dict) and all(
                isinstance(k, str) and isinstance(v, str)
                for k, v in roots.items())):
            raise ValueError("mst response: bad roots map")
    nodes = doc.get("n")
    if not isinstance(nodes, list):
        raise ValueError("mst response: bad node list")
    for nd in nodes:
        if not (isinstance(nd, dict) and isinstance(nd.get("ns"), str)):
            raise ValueError("mst response: bad node doc")
        _chk_path(nd.get("p"))
        t = nd.get("t")
        if t == "i":
            c = nd.get("c")
            if not isinstance(c, str):
                raise ValueError("mst response: bad child packing")
            nd["c"] = _unpack_children(c)
        elif t == "l":
            kd = nd.get("kd")
            if not isinstance(kd, dict):
                raise ValueError("mst response: bad leaf map")
            for k, pair in kd.items():
                if not (isinstance(k, str) and isinstance(pair, list)
                        and len(pair) == 2 and isinstance(pair[0], str)
                        and (pair[1] is None or isinstance(pair[1], dict))):
                    raise ValueError("mst response: bad leaf entry")
        elif t != "x":
            raise ValueError("mst response: unknown node type")
    return roots, nodes
