"""Bitswap-style block exchange (the paper's decentralized-CDN layer).

The port's own copy of the JAX package's ``core/bitswap.py``: the same code
under the port's import paths.

Wantlist-driven parallel block fetch: a session resolves providers via the
DHT (or a rendezvous hint), pulls the root manifest, then swarms the missing
blocks across every live provider with a bounded in-flight window.  Each
block is hash-verified against its CID on arrival; fetched blocks are stored
and re-provided, so popular artifacts gain seeders as they spread — this is
what makes RL fleet-wide model dissemination scale in the paper's Scenario 3.

Hierarchical (v2) manifests are fetched recursively: the root manifest names
sub-DAG roots, any *missing* sub-manifests are pulled next, and then every
missing leaf across all sub-DAGs is striped over the providers in one
scheduling pass — sub-DAGs already in the local store (unchanged tensors
from a previous version) cost zero bytes.

Provider selection is *scored*, not round-robin: each peer carries an EWMA
of delivered throughput plus a failure penalty (``ProviderScore``), and
stripe assignment weights fast peers proportionally.  A cheap ``bs.have``
unary lets the retry path skip providers that lack a block instead of
burning the full 120 s ``bs.get`` deadline on them.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Dict, Generator, List, Optional, TYPE_CHECKING

from .cid import (CID, CODEC_DAG, decode_manifest, decode_manifest_v2,
                  manifest_children, manifest_version, read_dag)
from .dht import PeerInfo
from .rpc import RpcChannel, RpcContext, RpcError
from .service import CodecFn, Fixed, Service, streaming, unary
from .simnet import DialError

if TYPE_CHECKING:  # pragma: no cover
    from .node import LatticaNode

MAX_IN_FLIGHT = 32
BLOCK_REQ_SIZE = 96
#: above this many wanted blocks per provider, use the streaming plane
#: (one backpressured channel per provider) instead of per-block unary
STREAM_FETCH_MIN = 4


class FetchError(Exception):
    pass


class ProviderScore:
    """Per-provider quality estimate: EWMA of delivered bytes/second with a
    multiplicative failure penalty.  New providers start optimistic so they
    get sampled; the penalty halves the score per recent failure and decays
    on the next success."""

    __slots__ = ("ewma_bps", "failures")

    ALPHA = 0.3
    OPTIMISTIC_BPS = 16e6

    def __init__(self) -> None:
        self.ewma_bps: float = self.OPTIMISTIC_BPS
        self.failures: int = 0

    def record(self, nbytes: int, seconds: float) -> None:
        bps = nbytes / max(seconds, 1e-9)
        self.ewma_bps = (1 - self.ALPHA) * self.ewma_bps + self.ALPHA * bps
        if self.failures:
            self.failures -= 1

    def fail(self) -> None:
        self.failures += 1

    def value(self) -> float:
        return self.ewma_bps * (0.5 ** min(self.failures, 10))


_BLOCK_RESP = CodecFn(
    "block_resp",
    lambda p: max(len(p[1]), 64) if p[0] == "block" and p[1] else 64)


class BitswapService(Service):
    """Block exchange: per-block unary gets, presence probes, and bulk
    streaming fetch."""

    name = "bs"

    def __init__(self, bitswap: "Bitswap"):
        self.bitswap = bitswap

    @unary("bs.have", request=Fixed(64), response=Fixed(8),
           idempotent=True, timeout=10.0)
    def have(self, payload: Any, ctx: RpcContext) -> Generator:
        """Presence probe: do we hold this block?  Cheap enough that a
        fetcher can ask before committing to a 120 s ``bs.get``."""
        cid: CID = payload
        yield ctx.cpu(1e-6)
        return self.bitswap.node.blockstore.has(cid)

    @unary("bs.get", request=Fixed(BLOCK_REQ_SIZE), response=_BLOCK_RESP,
           idempotent=True, timeout=120.0)
    def get(self, payload: Any, ctx: RpcContext) -> Generator:
        cid: CID = payload
        bs = self.bitswap
        block = bs.node.blockstore.get(cid)
        yield ctx.cpu(8e-6)
        if block is None:
            return ("missing", None)
        bs.stats["blocks_served"] += 1
        bs.stats["bytes_served"] += len(block)
        return ("block", block)

    @streaming("bs.fetch")
    def fetch(self, chan: RpcChannel, ctx: RpcContext) -> Generator:
        """Streaming plane: receive a wantlist, stream the blocks back under
        the channel's byte-credit backpressure (paper §2, streaming mode)."""
        bs = self.bitswap
        try:
            wants = yield from chan.recv(timeout=60.0)
        except RpcError:
            return
        bs.stats["stream_sessions"] += 1
        for cid in wants:
            block = bs.node.blockstore.get(cid)
            yield ctx.cpu(8e-6)
            if block is not None:
                bs.stats["blocks_served"] += 1
                bs.stats["bytes_served"] += len(block)
            try:
                yield from chan.send((cid, block),
                                     len(block) if block else 64)
            except RpcError:
                return
        chan.end()


class Bitswap:
    def __init__(self, node: "LatticaNode"):
        self.node = node
        self.stats = {"blocks_served": 0, "blocks_fetched": 0,
                      "bytes_served": 0, "bytes_fetched": 0, "retries": 0,
                      "stream_sessions": 0, "have_probes": 0,
                      "have_skips": 0, "unsolicited_rejected": 0,
                      "spec_negotiated": 0, "spec_mismatch": 0}
        self.scores: Dict[bytes, ProviderScore] = {}
        node.serve(BitswapService(self))

    # ----------------------------------------------------------- scoring
    def score(self, info: PeerInfo) -> ProviderScore:
        s = self.scores.get(info.peer_id.digest)
        if s is None:
            s = self.scores[info.peer_id.digest] = ProviderScore()
        return s

    def _stripe(self, wanted: List[CID],
                live: List[PeerInfo]) -> List[List[CID]]:
        """Assign blocks to providers proportionally to their scores: each
        block goes to the provider with the best score-per-assigned-block
        ratio (greedy weighted fill — a fast peer gets a proportionally
        longer stripe than a slow or flaky one)."""
        weights = [max(self.score(p).value(), 1.0) for p in live]
        stripes: List[List[CID]] = [[] for _ in live]
        for c in wanted:
            idx = max(range(len(live)),
                      key=lambda i: weights[i] / (len(stripes[i]) + 1))
            stripes[idx].append(c)
        return stripes

    # ------------------------------------------------------------- client
    def _fetch_blocks_stream(self, info: PeerInfo,
                             cids: List[CID]) -> Generator:
        """Bulk fetch over one streaming channel; returns {cid: bytes} for
        whatever verified blocks arrived (partial on provider failure)."""
        got: Dict[CID, bytes] = {}
        wanted = set(cids)
        sim = self.node.sim
        t0 = sim.now
        try:
            stub = self.node.stub(BitswapService, info)
            chan = yield from stub.fetch()
            yield from chan.send(list(cids), 48 * len(cids))
            for _ in range(len(cids)):
                cid, block = yield from chan.recv(timeout=120.0)
                if cid not in wanted:
                    # a self-verifying block we never asked for: a misbehaving
                    # provider could otherwise stuff the store with junk and
                    # pad its own throughput score with bytes nobody wanted
                    self.stats["unsolicited_rejected"] += 1
                    continue
                if block is not None and cid.verify(block):
                    got[cid] = block
        except (DialError, RpcError):
            pass
        nbytes = sum(len(b) for b in got.values())
        if got:
            self.score(info).record(nbytes, sim.now - t0)
        if len(got) < len(cids):
            self.score(info).fail()
        return got

    def _probe_have(self, info: PeerInfo, cid: CID) -> Generator:
        """True/False/None(=unreachable) presence probe."""
        self.stats["have_probes"] += 1
        try:
            stub = self.node.stub(BitswapService, info)
            return (yield from stub.have(cid))
        except (DialError, RpcError):
            return None

    def _fetch_block(self, info: PeerInfo, cid: CID,
                     probe: bool = False) -> Generator:
        """Fetch one block from one provider; returns bytes or None.  With
        ``probe``, a cheap ``bs.have`` runs first so a provider that lacks
        the block costs a 10 s control round-trip, not a 120 s get."""
        if probe:
            has = yield from self._probe_have(info, cid)
            if not has:
                if has is False:
                    self.stats["have_skips"] += 1
                return None
        sim = self.node.sim
        t0 = sim.now
        try:
            stub = self.node.stub(BitswapService, info)
            resp = yield from stub.get(cid)
        except (DialError, RpcError):
            self.score(info).fail()
            return None
        kind, block = resp
        if kind != "block" or block is None or not cid.verify(block):
            self.score(info).fail()
            return None
        self.score(info).record(len(block), sim.now - t0)
        return block

    def _store_fetched(self, cid: CID, block: bytes,
                       held: Optional[List[CID]] = None) -> None:
        self.node.blockstore.put(cid, block)
        if held is not None:
            self.node.blockstore.hold(cid)
            held.append(cid)
        self.stats["blocks_fetched"] += 1
        self.stats["bytes_fetched"] += len(block)

    def _fetch_one_of(self, cid: CID, providers: List[PeerInfo],
                      probe: bool = False) -> Generator:
        """Try providers in score order until one delivers ``cid``."""
        ranked = sorted(providers, key=lambda p: -self.score(p).value())
        for info in ranked:
            block = yield from self._fetch_block(info, cid, probe=probe)
            if block is not None:
                return block
            self.stats["retries"] += 1
        return None

    def _swarm_missing(self, wanted: List[CID], providers: List[PeerInfo],
                       held: Optional[List[CID]] = None) -> Generator:
        """One scheduling pass: stripe ``wanted`` across providers by score
        (streaming plane when stripes are long enough), then a unary
        failover phase with have-probes for whatever is still missing."""
        node = self.node
        sim = node.sim
        missing = deque(
            dict.fromkeys(c for c in wanted if not node.blockstore.has(c)))
        if not missing:
            return None
        if not providers:
            raise FetchError(f"no providers for {len(missing)} blocks")
        live = list(providers)

        # ---- phase 1: bulk transfer over streaming channels --------------
        # any block a provider fails to deliver falls through to the unary
        # retry phase below
        if len(missing) >= STREAM_FETCH_MIN * max(len(live), 1):
            stripes = self._stripe(list(missing), live)

            def stream_worker(idx: int) -> Generator:
                if not stripes[idx]:
                    return 0
                got = yield from self._fetch_blocks_stream(
                    live[idx], stripes[idx])
                for cid, block in got.items():
                    self._store_fetched(cid, block, held)
                self.stats["retries"] += len(stripes[idx]) - len(got)
                return len(got)

            procs = [sim.process(stream_worker(i)) for i in range(len(live))]
            yield sim.all_of(procs)
            missing = deque(dict.fromkeys(
                c for c in wanted if not node.blockstore.has(c)))

        # ---- phase 2: per-block unary with provider failover --------------
        failures: Dict[bytes, int] = {}

        def worker(wid: int) -> Generator:
            while missing:
                cid = missing.popleft()
                if node.blockstore.has(cid):
                    continue
                got = None
                tries = 0
                while got is None and live and tries < 2 * len(live) + 2:
                    ranked = sorted(live,
                                    key=lambda p: -self.score(p).value())
                    info = ranked[(wid + tries) % len(ranked)]
                    # first attempt goes straight to get; retries probe
                    # bs.have first so block-less providers cost a control
                    # RTT instead of the 120 s get deadline
                    got = yield from self._fetch_block(info, cid,
                                                       probe=tries > 0)
                    tries += 1
                    if got is None:
                        self.stats["retries"] += 1
                        failures[info.peer_id.digest] = \
                            failures.get(info.peer_id.digest, 0) + 1
                        if failures[info.peer_id.digest] >= 3 and info in live:
                            live.remove(info)
                if got is None:
                    raise FetchError(f"block {cid} unavailable")
                self._store_fetched(cid, got, held)
            return None

        n_workers = min(MAX_IN_FLIGHT, max(len(live), 1),
                        max(len(missing), 1))
        procs = [sim.process(worker(i)) for i in range(n_workers)]
        if procs:
            yield sim.all_of(procs)
        return None

    def _resolve_providers(self, root: CID,
                           hint_providers: Optional[List[PeerInfo]],
                           ) -> Generator:
        providers: List[PeerInfo] = list(hint_providers or [])
        if not providers:
            providers = yield from self.node.dht.find_providers(root.key)
        return [p for p in providers if p.peer_id != self.node.peer_id]

    def fetch_dag(self, root: CID,
                  hint_providers: Optional[List[PeerInfo]] = None,
                  assemble: bool = True) -> Generator:
        """Fetch a manifest-rooted DAG (flat v1 or hierarchical v2).

        Providers come from hints (rendezvous / pubsub announcement) plus the
        DHT provider records.  For v2 roots, sub-manifests missing locally
        are pulled first, then all missing leaves across every sub-DAG are
        swarmed in one scored scheduling pass — sub-DAGs already present
        (unchanged entries vs an earlier version) are skipped entirely.

        Returns the reassembled bytes, or ``None`` with every block resident
        in the local store when ``assemble`` is False (structure-aware
        callers reassemble per entry themselves; they should pin the root
        before their next store write, since the session's transfer-holds
        are released on return).
        """
        node = self.node
        providers: List[PeerInfo] = []
        # transfer-holds: every block this session touches is exempt from
        # LRU eviction until the fetch (incl. assembly) completes, so a
        # tight blockstore budget can't cannibalize a version mid-transfer
        held: List[CID] = []

        def hold_local(cid: CID) -> None:
            if node.blockstore.has(cid):
                node.blockstore.hold(cid)
                held.append(cid)

        def need_providers() -> Generator:
            if not providers:
                got = yield from self._resolve_providers(root, hint_providers)
                providers.extend(got)
            return providers

        try:
            manifest = node.blockstore.get(root)
            if manifest is not None:
                hold_local(root)
            else:
                yield from need_providers()
                if not providers:
                    raise FetchError(f"no providers for {root}")
                manifest = yield from self._fetch_one_of(
                    root, providers, probe=len(providers) > 1)
                if manifest is None:
                    raise FetchError(
                        f"all providers failed serving manifest {root}")
                self._store_fetched(root, manifest, held)

            # collect the full leaf want-list, pulling missing sub-manifests;
            # a hash-valid but malformed manifest (truncated, garbage) raises
            # ValueError from the decoders and must surface as FetchError —
            # a misbehaving publisher is a failed fetch, not a node crash
            try:
                version = manifest_version(manifest)
                if version == 1:
                    leaves = decode_manifest(manifest)[0]
                else:
                    entries = decode_manifest_v2(manifest)[0]
            except ValueError as e:
                raise FetchError(f"corrupt manifest {root}: {e}") from e
            if version == 2:
                sub_missing = []
                for e in entries:
                    if e.cid.codec != CODEC_DAG:
                        continue
                    if node.blockstore.has(e.cid):
                        hold_local(e.cid)    # resident sub-manifests must
                        # survive evictions caused by the leaf swarm's puts
                    else:
                        sub_missing.append(e.cid)
                if sub_missing:
                    yield from need_providers()
                    yield from self._swarm_missing(sub_missing, providers,
                                                   held)
                leaves = []
                for e in entries:
                    if e.cid.codec != CODEC_DAG:
                        leaves.append(e.cid)
                        continue
                    sub = node.blockstore.peek(e.cid)
                    if sub is None:
                        raise FetchError(
                            f"sub-manifest {e.cid} missing after fetch")
                    try:
                        leaves.extend(manifest_children(sub))
                    except ValueError as exc:
                        raise FetchError(
                            f"corrupt sub-manifest {e.cid}: {exc}") from exc

            # dedup: repeated content (identical chunks) shares one CID and
            # is fetched once — content addressing's free deduplication
            wanted = list(dict.fromkeys(leaves))
            to_fetch = []
            for c in wanted:
                if node.blockstore.has(c):
                    hold_local(c)
                else:
                    to_fetch.append(c)
            if to_fetch:
                yield from need_providers()
                if not providers:
                    raise FetchError(f"no providers for leaves of {root}")
                yield from self._swarm_missing(to_fetch, providers, held)

            if not assemble:
                return None
            try:
                # blocks were hash-verified on arrival and again by the
                # store's put — skip a third sha256 pass per block
                return read_dag(root, node.blockstore.get, verify=False)
            except (KeyError, ValueError) as e:
                raise FetchError(str(e)) from e
        finally:
            for c in held:
                node.blockstore.release(c)

    def publish_dag(self, dag_blocks: Dict[CID, bytes], root: CID,
                    announce: bool = True) -> Generator:
        """Store all blocks locally and announce the root on the DHT."""
        self.node.blockstore.put_many(dag_blocks)
        if announce:
            yield from self.node.dht.provide(root.key)
        return root
