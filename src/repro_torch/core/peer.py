"""Peer identity & multiaddresses.

The port's own copy of the JAX package's ``core/peer.py``: the same code
under the port's import paths.

Peer IDs are the sha256 of an (abstract) public key, matching libp2p's
hash-of-pubkey scheme; the 256-bit digest doubles as the Kademlia key space.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Optional


class PeerId:
    __slots__ = ("digest",)

    def __init__(self, digest: bytes):
        assert len(digest) == 32
        self.digest = digest

    @classmethod
    def from_pubkey(cls, pubkey: bytes) -> "PeerId":
        return cls(hashlib.sha256(pubkey).digest())

    @classmethod
    def from_name(cls, name: str) -> "PeerId":
        return cls.from_pubkey(name.encode())

    def xor_distance(self, other: "PeerId") -> int:
        return int.from_bytes(self.digest, "big") ^ int.from_bytes(other.digest, "big")

    def distance_to_key(self, key: bytes) -> int:
        return int.from_bytes(self.digest, "big") ^ int.from_bytes(key, "big")

    def __eq__(self, other: object) -> bool:
        return isinstance(other, PeerId) and other.digest == self.digest

    def __hash__(self) -> int:
        return hash(self.digest)

    def __lt__(self, other: "PeerId") -> bool:
        return self.digest < other.digest

    def short(self) -> str:
        return self.digest.hex()[:12]

    def __repr__(self) -> str:
        return f"PeerId({self.short()})"


@dataclass(frozen=True)
class Multiaddr:
    """A dialable address: either a direct (ip, port) or a relay circuit."""

    ip: str
    port: int
    transport: str = "quic"           # "tcp" | "quic"
    relay_peer: Optional["PeerId"] = None   # set => /p2p-circuit via that relay

    @property
    def is_relay(self) -> bool:
        return self.relay_peer is not None

    def __repr__(self) -> str:
        base = f"/ip4/{self.ip}/{self.transport}/{self.port}"
        if self.relay_peer is not None:
            return f"/p2p/{self.relay_peer.short()}/p2p-circuit{base}"
        return base
