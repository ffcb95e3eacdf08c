"""Core crypto interfaces: tmhash, PubKey, PrivKey and BatchVerifier.

The port's own copy of `cometbft_tpu/crypto/keys.py`. Behavior parity: reference
crypto/crypto.go:22-54 (interfaces) and crypto/tmhash (SHA-256 with
20-byte truncated addresses).
"""

from __future__ import annotations

import hashlib
from abc import ABC, abstractmethod


def tmhash(data: bytes) -> bytes:
    """SHA-256 (reference crypto/tmhash/hash.go:9-11)."""
    return hashlib.sha256(data).digest()


def tmhash20(data: bytes) -> bytes:
    """First 20 bytes of SHA-256 (reference crypto/tmhash TruncatedSize)."""
    return tmhash(data)[:20]


class PubKey(ABC):
    @abstractmethod
    def address(self) -> bytes: ...

    @abstractmethod
    def bytes(self) -> bytes: ...

    @abstractmethod
    def verify_signature(self, msg: bytes, sig: bytes) -> bool: ...

    @abstractmethod
    def type_tag(self) -> str: ...

    def __eq__(self, other):
        return (
            isinstance(other, PubKey)
            and self.type_tag() == other.type_tag()
            and self.bytes() == other.bytes()
        )

    def __hash__(self):
        return hash((self.type_tag(), self.bytes()))


class PrivKey(ABC):
    @abstractmethod
    def sign(self, msg: bytes) -> bytes: ...

    @abstractmethod
    def pub_key(self) -> PubKey: ...

    @abstractmethod
    def bytes(self) -> bytes: ...

    @abstractmethod
    def type_tag(self) -> str: ...


class BatchVerifier(ABC):
    """Accumulate (pubkey, msg, sig) triples, then verify all at once.

    Matches the reference semantics (crypto/crypto.go:41-54): Add may fail
    fast on malformed input; Verify returns (all_valid, per_sig_validity).
    """

    @abstractmethod
    def add(self, pub_key: PubKey, msg: bytes, sig: bytes) -> bool: ...

    @abstractmethod
    def verify(self) -> tuple[bool, list[bool]]: ...
