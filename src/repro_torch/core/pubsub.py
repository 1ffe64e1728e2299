"""Scored gossipsub-style pub/sub over the connected overlay.

The port's own copy of the JAX package's ``core/pubsub.py``: the same code
under the port's import paths.

Topics carry model-version announcements and CRDT delta pushes.  Each
subscriber maintains a bounded-degree *mesh* per topic (gossipsub v1.1
style): messages are eagerly pushed along mesh edges only, so per-peer
relay load is bounded by the mesh degree instead of concentrating on
well-known hubs the way the old flood did.  A heartbeat daemon grafts the
mesh back up to degree when peers churn out, prunes it down (worst score
first) when over-subscribed, and lazily advertises recent message IDs
(IHAVE) to a few off-mesh subscribers, who pull anything they missed
(IWANT) — the repair path that heals mesh partitions.

Peer scores feed graft/prune decisions: first-seen deliveries raise a
peer's score, duplicate deliveries and high delivery latency lower it, and
a peer's self-reported relay load discounts it as a graft target so load
spreads across the mesh.  Scores decay every heartbeat, so a formerly-good
peer that stops delivering drifts back toward prune candidacy.

Subscription state is exchanged through the same control surface
(``ps.ctl``): announces carry the full topic set, unsubscribes propagate
both eagerly (to currently-known peers) and lazily (any later announce
returns the current set), so late joiners never see a stale subscription.

Wire surface is a declared :class:`~repro.core.service.Service` — one
non-idempotent ``ps.msg`` push and one idempotent ``ps.ctl`` control
exchange.  Transient mesh state (pending IWANT pulls) registers a leak
gauge so ``Sim(sanitize=True)`` runs prove the repair plane drains.
"""

from __future__ import annotations

import hashlib
import itertools
from collections import OrderedDict
from typing import (Any, Callable, Dict, Generator, List, Optional, Set,
                    Tuple, TYPE_CHECKING)

from .peer import PeerId
from .rpc import RpcContext, RpcError
from .service import DeclaredSizeCodec, Fixed, Service, pickled, unary
from .simnet import DialError

if TYPE_CHECKING:  # pragma: no cover
    from .node import LatticaNode

#: target mesh degree per topic (D), with the low/high water marks the
#: heartbeat grafts up from / prunes down to (gossipsub v1.1 defaults)
MESH_DEGREE = 6
MESH_DEGREE_LO = 4
MESH_DEGREE_HI = 10

#: off-mesh subscribers that receive IHAVE gossip each heartbeat
GOSSIP_LAZY = 6

#: heartbeat cadence; each node's loop is phase-jittered from the sim rng
HEARTBEAT = 2.0

#: message-cache windows kept / advertised in IHAVE gossip (windows rotate
#: once per heartbeat, so repair reaches ~GOSSIP_WINDOWS heartbeats back)
MCACHE_WINDOWS = 5
GOSSIP_WINDOWS = 3

#: a requested-but-never-received message id expires after this long (the
#: pending-IWANT gauge must drain to baseline in sanitized runs)
IWANT_TIMEOUT = 2 * HEARTBEAT

#: most message ids pulled per control exchange — a rejoining node that
#: missed many messages spreads its repair pulls across advertisers and
#: heartbeats instead of turning one peer into the repair hotspot
IWANT_SERVE_CAP = 12

#: per-heartbeat multiplicative score decay
SCORE_DECAY = 0.8

#: mesh members scoring below this are dropped outright at the heartbeat —
#: the churn path: a departed peer fails its eager pushes, accumulates
#: failure penalties, and prunes itself out so a live subscriber is
#: grafted in its place
SCORE_PRUNE_THRESHOLD = -2.0

SEEN_CACHE = 4096

_seq = itertools.count(1)


class PubSubService(Service):
    """Gossip wire surface: eager message push + mesh control exchange.

    ``msg`` is deliberately *not* idempotent at the stub level — the mesh
    already dedups via the seen-cache, and stub retries would distort the
    gossip fan-out accounting.  The message payload carries its declared
    application size as the last tuple element (``DeclaredSizeCodec``).

    ``ctl`` is idempotent: every field is a state assertion (topic sets,
    mesh membership, have/want lists), so replaying one is harmless."""

    name = "ps"

    def __init__(self, pubsub: "PubSub"):
        self.pubsub = pubsub

    @unary("ps.msg", request=DeclaredSizeCodec(), response=Fixed(64),
           timeout=15.0)
    def msg(self, payload: Any, ctx: RpcContext) -> Generator:
        topic, data, mid, from_peer, sent_at, size = payload
        yield ctx.cpu(3e-6)
        self.pubsub._receive(topic, data, mid, from_peer, sent_at, size)
        return True

    @unary("ps.ctl", request=pickled(floor=96), response=pickled(floor=96),
           idempotent=True, timeout=15.0)
    def ctl(self, payload: Any, ctx: RpcContext) -> Generator:
        yield ctx.cpu(3e-6)
        return self.pubsub._handle_ctl(payload)


class PubSub:
    def __init__(self, node: "LatticaNode"):
        self.node = node
        self.subscriptions: Dict[str, List[Callable[[str, Any, PeerId], None]]] = {}
        self.peer_topics: Dict[PeerId, Set[str]] = {}
        #: per-topic mesh membership (peers we eagerly push to / expect
        #: eager pushes from); bounded by MESH_DEGREE_HI
        self.mesh: Dict[str, Set[PeerId]] = {}
        #: heartbeat-computed peer scores (graft preference / prune order)
        self.scores: Dict[PeerId, float] = {}
        #: raw score inputs since the last heartbeat
        self._perf: Dict[PeerId, Dict[str, float]] = {}
        #: message cache for IWANT serving: mid -> (topic, data, sent_at,
        #: size), plus rotation windows for IHAVE advertisement
        self._mcache: Dict[bytes, Tuple[str, Any, float, int]] = {}
        self._mcache_windows: List[List[bytes]] = [[]]
        #: mids we asked a peer to push (IWANT) but have not yet received;
        #: strictly transient — expired by the heartbeat, gauged for leaks
        self._pending_iwant: Dict[bytes, float] = {}
        self._seen: "OrderedDict[bytes, None]" = OrderedDict()
        #: when set, subscription-change announces go to at most this many
        #: peers (live connections first).  Small fleets leave it None —
        #: every known peer hears every change directly; at 1k+ nodes the
        #: scale harness bounds it, matching gossipsub's rule of announcing
        #: subscriptions only over connected links.
        self.announce_cap: Optional[int] = None
        self.stats = {"published": 0, "delivered": 0, "forwarded": 0,
                      "duplicates": 0, "grafts": 0, "prunes": 0,
                      "ihave_sent": 0, "iwant_sent": 0, "repaired": 0,
                      "iwant_expired": 0, "ctl_rounds": 0}
        node.serve(PubSubService(self))
        node.sim.register_leak_check(
            f"pubsub.pending_iwant:{node.host.name}",
            lambda: len(self._pending_iwant))
        node.sim.process(self._heartbeat_loop(), daemon=True)

    # -- subscription management ---------------------------------------------
    def subscribe(self, topic: str,
                  callback: Callable[[str, Any, PeerId], None]) -> None:
        is_new = topic not in self.subscriptions
        self.subscriptions.setdefault(topic, []).append(callback)
        if is_new:
            self.mesh.setdefault(topic, set())
            self._push_subscription_update()

    def unsubscribe(self, topic: str,
                    callback: Optional[Callable] = None) -> None:
        """Drop one callback (or all with ``callback=None``).  When the
        last callback goes, the topic leaves our subscription set, the
        mesh for it dissolves (PRUNE to every member), and the removal
        propagates: eagerly to currently-known peers, and to late joiners
        through the full-set announce they trigger on contact."""
        cbs = self.subscriptions.get(topic)
        if cbs is None:
            return
        if callback is None:
            cbs.clear()
        else:
            try:
                cbs.remove(callback)
            except ValueError:
                pass
        if cbs:
            return
        del self.subscriptions[topic]
        self.mesh.pop(topic, None)
        self._push_subscription_update()

    def _push_subscription_update(self) -> None:
        """Proactively push our full topic set to every peer we know.
        Subscription state is otherwise exchanged only at announce time
        (bootstrap / explicit ``announce_subscriptions``), so a topic
        change made *after* joining would stay invisible to the mesh —
        fresh subscribers would miss the next publish, and unsubscribed
        peers would keep receiving pushes.  One tiny idempotent unary per
        peer, over reused connections."""
        node = self.node
        targets = self._sorted_peers(node.peers)
        cap = self.announce_cap
        if cap is not None and len(targets) > cap:
            def connected(pid: PeerId) -> bool:
                host = node.net.hosts.get(node.peers[pid].host_name)
                return (host is not None
                        and node.host.connection_to(host) is not None)
            live = [p for p in targets if connected(p)]
            rest = [p for p in targets if p not in set(live)]
            targets = (live + rest)[:cap]
        for pid in targets:
            node.sim.process(self.announce_subscriptions(pid))

    def announce_subscriptions(self, peer: "PeerId") -> Generator:
        """Tell one peer our full topic set (piggybacks on connect); the
        response carries the peer's topics, so both sides learn."""
        yield from self._ctl_roundtrip(peer, {})
        return None

    # -- control exchange -----------------------------------------------------
    def _ctl_doc(self, extra: Dict[str, Any]) -> Dict[str, Any]:
        doc = {"from": self.node.peer_id,
               "topics": sorted(self.subscriptions),
               "load": self.stats["forwarded"]}
        doc.update(extra)
        return doc

    def _ctl_roundtrip(self, peer: PeerId, extra: Dict[str, Any]) -> Generator:
        """One ``ps.ctl`` exchange with ``peer``: our full topic set (plus
        any graft/prune/ihave fields) out, their topic set and reactions
        back.  Responder IWANTs are served by spawning eager pushes of the
        cached messages."""
        info = self.node.peers.get(peer)
        if info is None:
            return None
        try:
            stub = self.node.stub(PubSubService, info)
            resp = yield from stub.ctl(self._ctl_doc(extra))
        except (DialError, RpcError):
            self._perf_of(peer)["fail"] += 1.0
            return None
        self.stats["ctl_rounds"] += 1
        if not isinstance(resp, dict):
            return None
        theirs = resp.get("topics")
        if isinstance(theirs, list):
            self._set_peer_topics(peer, {t for t in theirs
                                         if isinstance(t, str)})
        for t in resp.get("pruned", ()):        # graft refused
            members = self.mesh.get(t)
            if members is not None:
                members.discard(peer)
        wants = [m for m in resp.get("iwant", ()) if isinstance(m, bytes)]
        if wants:
            self._serve_iwant(peer, wants)
        self._note_load(peer, resp.get("load"))
        return resp

    def _handle_ctl(self, doc: Any) -> Dict[str, Any]:
        """Server side of ``ps.ctl``; returns the response doc."""
        if not isinstance(doc, dict) or not isinstance(doc.get("from"), PeerId):
            return {"topics": sorted(self.subscriptions)}
        frm = doc["from"]
        topics = doc.get("topics")
        if isinstance(topics, list):
            self._set_peer_topics(frm, {t for t in topics
                                        if isinstance(t, str)})
        self._note_load(frm, doc.get("load"))
        pruned: List[str] = []
        for t in doc.get("graft", ()):
            members = self.mesh.get(t)
            if (t in self.subscriptions and members is not None
                    and len(members) < MESH_DEGREE_HI):
                if frm not in members:
                    members.add(frm)
                    self.stats["grafts"] += 1
            else:
                pruned.append(t)
        for t in doc.get("prune", ()):
            members = self.mesh.get(t)
            if members is not None:
                members.discard(frm)
        wants: List[bytes] = []
        ihave = doc.get("ihave")
        if isinstance(ihave, dict):
            now = self.node.sim.now
            for t, mids in sorted(ihave.items()):
                if t not in self.subscriptions:
                    continue
                for mid in mids:
                    if len(wants) >= IWANT_SERVE_CAP:
                        break       # un-pulled ids stay unseen; the next
                        # advertiser's IHAVE re-offers them
                    if (isinstance(mid, bytes) and mid not in self._seen
                            and mid not in self._pending_iwant):
                        self._pending_iwant[mid] = now
                        wants.append(mid)
        if wants:
            self.stats["iwant_sent"] += len(wants)
        resp: Dict[str, Any] = {"topics": sorted(self.subscriptions),
                                "load": self.stats["forwarded"]}
        if pruned:
            resp["pruned"] = pruned
        if wants:
            resp["iwant"] = wants
        return resp

    def _set_peer_topics(self, peer: PeerId, topics: Set[str]) -> None:
        """Record a peer's full topic set; mesh edges for topics the peer
        no longer subscribes to dissolve immediately (UNSUBSCRIBE
        propagation — a pushed update or any later announce both land
        here, so late joiners converge on the same view)."""
        self.peer_topics[peer] = topics
        for t, members in self.mesh.items():
            if peer in members and t not in topics:
                members.discard(peer)

    def _note_load(self, peer: PeerId, load: Any) -> None:
        if isinstance(load, int) and load >= 0:
            self._perf_of(peer)["load"] = float(load)

    def _serve_iwant(self, peer: PeerId, mids: List[bytes]) -> None:
        """Push cached messages a peer asked for (repair path)."""
        info = self.node.peers.get(peer)
        if info is None:
            return
        for mid in mids:
            cached = self._mcache.get(mid)
            if cached is None:
                continue
            topic, data, sent_at, size = cached
            self.node.sim.process(self._send_one(
                info, topic, data, mid, sent_at, size))

    # -- message flow -----------------------------------------------------------
    def _msg_id(self, topic: str, data: Any, origin: PeerId, seq: int) -> bytes:
        h = hashlib.sha256()
        h.update(topic.encode())
        h.update(repr(data).encode())
        h.update(origin.digest)
        h.update(seq.to_bytes(8, "big"))
        return h.digest()[:16]

    def _mark_seen(self, mid: bytes) -> bool:
        if mid in self._seen:
            return False
        self._seen[mid] = None
        if len(self._seen) > SEEN_CACHE:
            self._seen.popitem(last=False)
        return True

    def _cache_msg(self, mid: bytes, topic: str, data: Any, sent_at: float,
                   size: int) -> None:
        if mid in self._mcache:
            return
        self._mcache[mid] = (topic, data, sent_at, size)
        self._mcache_windows[0].append(mid)

    def _perf_of(self, peer: PeerId) -> Dict[str, float]:
        return self._perf.setdefault(
            peer, {"first": 0.0, "dup": 0.0, "lat": 0.0, "load": 0.0,
                   "fail": 0.0})

    def _receive(self, topic: str, data: Any, mid: bytes, from_peer: PeerId,
                 sent_at: float, size: int) -> None:
        """A pushed message arrived (eager mesh push or IWANT repair)."""
        now = self.node.sim.now
        if mid in self._pending_iwant:
            del self._pending_iwant[mid]
            self.stats["repaired"] += 1
        perf = self._perf_of(from_peer)
        if not self._mark_seen(mid):
            self.stats["duplicates"] += 1
            perf["dup"] += 1.0
            return
        perf["first"] += 1.0
        # EWMA of how stale this peer's deliveries are (publish->here)
        perf["lat"] = 0.8 * perf["lat"] + 0.2 * max(now - sent_at, 0.0)
        self._cache_msg(mid, topic, data, sent_at, size)
        for cb in self.subscriptions.get(topic, []):
            self.stats["delivered"] += 1
            cb(topic, data, from_peer)
        # eager re-push along our mesh edges (origin/sender excluded);
        # relay load stays bounded by the mesh degree.  A node that is
        # neither subscribed nor meshed may relay only toward peers it
        # knows are interested — blind relays re-pushing to the
        # uninterested turn one publish on a watcher-less topic into an
        # overlay-wide flood (every node forwarding to MESH_DEGREE more)
        self.node.sim.process(self._forward(
            topic, data, mid, sent_at, size,
            exclude={from_peer, self.node.peer_id},
            last_resort=(topic in self.subscriptions
                         or bool(self.mesh.get(topic)))))

    def _eager_targets(self, topic: str, exclude: Set[PeerId],
                       last_resort: bool = True) -> List[PeerId]:
        """Push targets for one hop: the topic mesh when it has formed;
        before the first heartbeat (or for topics we merely relay) fall
        back to known subscribers, then to peers whose topic set we have
        not learned yet — bounded by MESH_DEGREE either way."""
        members = [p for p in self._sorted_peers(self.mesh.get(topic, ()))
                   if p not in exclude]
        if members:
            return members[:MESH_DEGREE_HI]
        interested = [p for p in self._sorted_peers(self.peer_topics)
                      if topic in self.peer_topics[p] and p not in exclude]
        unknown = [p for p in self._sorted_peers(self.node.peers)
                   if p not in self.peer_topics and p not in exclude
                   and p != self.node.peer_id] if last_resort else []
        # last resort: peers whose recorded topic set lacks the topic —
        # that knowledge may be stale, and relays like the bootstrap
        # servers know the *actual* subscribers; dropping them entirely
        # would strand messages whose only eager targets are undialable
        others = [p for p in self._sorted_peers(self.node.peers)
                  if p not in exclude and p != self.node.peer_id
                  and p in self.peer_topics
                  and topic not in self.peer_topics[p]] if last_resort \
            else []
        chosen = interested[:MESH_DEGREE]
        for pool in (unknown, others):
            for p in pool:
                if len(chosen) >= MESH_DEGREE:
                    break
                chosen.append(p)
        return chosen

    @staticmethod
    def _sorted_peers(peers: Any) -> List[PeerId]:
        """Deterministic iteration order for peer sets/dicts."""
        return sorted(peers, key=lambda p: p.digest)

    def publish(self, topic: str, data: Any, size: int = 256) -> Generator:
        self.stats["published"] += 1
        mid = self._msg_id(topic, data, self.node.peer_id, next(_seq))
        self._mark_seen(mid)
        sent_at = self.node.sim.now
        self._cache_msg(mid, topic, data, sent_at, size)
        yield from self._forward(topic, data, mid, sent_at, size,
                                 exclude={self.node.peer_id})
        return mid

    def _forward(self, topic: str, data: Any, mid: bytes, sent_at: float,
                 size: int, exclude: Set[PeerId],
                 last_resort: bool = True) -> Generator:
        targets = self._eager_targets(topic, exclude, last_resort)
        sim = self.node.sim
        procs = []
        for pid in targets:
            info = self.node.peers.get(pid)
            if info is None:
                continue
            procs.append(sim.process(self._send_one(
                info, topic, data, mid, sent_at, size)))
        if procs:
            yield sim.all_of(procs)
        return None

    def _send_one(self, info: Any, topic: str, data: Any, mid: bytes,
                  sent_at: float, size: int) -> Generator:
        try:
            stub = self.node.stub(PubSubService, info)
            yield from stub.msg((topic, data, mid, self.node.peer_id,
                                 sent_at, size))
            self.stats["forwarded"] += 1
        except (DialError, RpcError):
            # a failed eager push marks the peer as likely departed; the
            # penalty drives its score under SCORE_PRUNE_THRESHOLD so the
            # heartbeat replaces it with a live subscriber
            self._perf_of(info.peer_id)["fail"] += 1.0
        return None

    # -- heartbeat: mesh maintenance + lazy gossip ------------------------------
    def _heartbeat_loop(self) -> Generator:
        # phase jitter so a fleet's heartbeats spread across the interval
        # instead of synchronizing into one thundering event instant
        yield self.node.sim.rng.random() * HEARTBEAT
        while True:
            yield HEARTBEAT
            if (not self.subscriptions and not self._pending_iwant
                    and not self._mcache):
                continue        # idle node: keep the tick O(1)
            self._heartbeat()

    def _heartbeat(self) -> None:
        now = self.node.sim.now
        # 1. expire IWANTs that were never answered (peer died / lied)
        for mid in [m for m, t in self._pending_iwant.items()
                    if now - t > IWANT_TIMEOUT]:
            del self._pending_iwant[mid]
            self.stats["iwant_expired"] += 1
        # 2. refresh scores from the window's delivery performance
        self._refresh_scores()
        # 3. per-topic mesh maintenance + IHAVE gossip, batched per peer
        ctl: Dict[PeerId, Dict[str, Any]] = {}
        for topic in sorted(self.subscriptions):
            self._maintain_topic(topic, ctl)
        self._gossip_ihave(ctl)
        for peer in self._sorted_peers(ctl):
            self.node.sim.process(self._ctl_roundtrip(peer, ctl[peer]))
        # 4. rotate the message-cache windows
        self._mcache_windows.insert(0, [])
        while len(self._mcache_windows) > MCACHE_WINDOWS:
            for mid in self._mcache_windows.pop():
                self._mcache.pop(mid, None)

    def _refresh_scores(self) -> None:
        for peer in self._sorted_peers(self._perf):
            perf = self._perf[peer]
            gain = perf["first"] - 0.5 * perf["dup"] - 2.0 * perf["lat"]
            # self-reported relay load discounts overloaded graft targets;
            # delivery failures (dial/rpc errors) weigh hardest — they mean
            # the peer is gone or unreachable, not merely slow
            gain -= 0.01 * perf["load"] + 1.5 * perf.get("fail", 0.0)
            prev = self.scores.get(peer, 0.0)
            self.scores[peer] = SCORE_DECAY * prev + gain
            perf["first"] = perf["dup"] = perf["fail"] = 0.0
        # scores of silent peers decay toward zero
        for peer in self.scores:
            if peer not in self._perf:
                self.scores[peer] *= SCORE_DECAY
        # snap near-zero scores to zero so a penalized peer that has been
        # quiet long enough becomes graft-eligible again (decay alone only
        # approaches zero asymptotically from below)
        for peer, s in self.scores.items():
            if s != 0.0 and abs(s) < 0.05:
                self.scores[peer] = 0.0

    def _score(self, peer: PeerId) -> float:
        return self.scores.get(peer, 0.0)

    def _maintain_topic(self, topic: str,
                        ctl: Dict[PeerId, Dict[str, Any]]) -> None:
        members = self.mesh.setdefault(topic, set())
        # drop mesh members that vanished, no longer subscribe, or whose
        # score collapsed (failed deliveries after churning out)
        for peer in list(members):
            if (peer not in self.node.peers
                    or topic not in self.peer_topics.get(peer, ())
                    or self._score(peer) < SCORE_PRUNE_THRESHOLD):
                members.discard(peer)
                self.stats["prunes"] += 1
        if len(members) < MESH_DEGREE_LO:
            candidates = [p for p in self._sorted_peers(self.peer_topics)
                          if topic in self.peer_topics[p]
                          and p not in members and p != self.node.peer_id
                          and p in self.node.peers
                          and self._score(p) >= 0.0]
            candidates.sort(key=lambda p: (-self._score(p), p.digest))
            for peer in candidates[:MESH_DEGREE - len(members)]:
                members.add(peer)
                self.stats["grafts"] += 1
                ctl.setdefault(peer, {}).setdefault("graft", []).append(topic)
        elif len(members) > MESH_DEGREE_HI:
            ranked = sorted(members, key=lambda p: (self._score(p), p.digest))
            for peer in ranked[:len(members) - MESH_DEGREE]:
                members.discard(peer)
                self.stats["prunes"] += 1
                ctl.setdefault(peer, {}).setdefault("prune", []).append(topic)

    def _gossip_ihave(self, ctl: Dict[PeerId, Dict[str, Any]]) -> None:
        """Advertise recent message ids to a few off-mesh subscribers per
        topic — the lazy pull path that repairs holes the eager mesh
        missed (partitions, churned-out members)."""
        recent: Dict[str, List[bytes]] = {}
        for window in self._mcache_windows[:GOSSIP_WINDOWS]:
            for mid in window:
                cached = self._mcache.get(mid)
                if cached is not None:
                    recent.setdefault(cached[0], []).append(mid)
        if not recent:
            return
        for topic in sorted(recent):
            members = self.mesh.get(topic, set())
            lazy = [p for p in self._sorted_peers(self.peer_topics)
                    if topic in self.peer_topics[p] and p not in members
                    and p != self.node.peer_id and p in self.node.peers]
            if not lazy:
                continue
            rng = self.node.sim.rng
            if len(lazy) > GOSSIP_LAZY:
                lazy = rng.sample(lazy, GOSSIP_LAZY)
            for peer in lazy:
                doc = ctl.setdefault(peer, {})
                doc.setdefault("ihave", {})[topic] = list(recent[topic])
                self.stats["ihave_sent"] += 1
