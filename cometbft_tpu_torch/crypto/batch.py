"""Batch-verifier dispatch by public-key type: the entry point consumers call.

Behavior parity: reference crypto/batch/batch.go:11-35. Ed25519 is the
one key type this port batches, or verifies at all, so far: other types
return None, as the reference does for types without batch support, and
the port's consumers raise `types.validation.ErrUnsupportedKeyType` for
them where the reference verifies them singly
(types/validation.go:26-53).
"""

from __future__ import annotations

from . import ed25519
from .keys import BatchVerifier, PubKey


def create_batch_verifier(pub_key: PubKey, device="cuda") -> BatchVerifier | None:
    """A fresh batch verifier on `device` for this key's type, or None if
    the type has no batch support here. The consumers
    (`types/validation.py`, `light/verifier.py`) build theirs here."""
    if supports_batch_verifier(pub_key):
        return ed25519.Ed25519BatchVerifier(device=device)
    return None


def supports_batch_verifier(pub_key: PubKey | None) -> bool:
    """Whether this key can take the batch path (reference :31): Ed25519
    only, in the port."""
    return pub_key is not None and pub_key.type_tag() == ed25519.KEY_TYPE
