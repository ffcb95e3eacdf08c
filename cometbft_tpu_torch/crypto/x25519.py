"""X25519 Diffie-Hellman over Curve25519 (RFC 7748).

Twin of `cometbft_tpu/crypto/x25519.py`: pure-Python Montgomery-ladder
scalar multiplication, the key-agreement primitive of the port's p2p
secret connections (the reference prefers `cryptography` when it is
installed; the two compute the same bytes). Python's big-int pow is not
constant-time, so this is for the ephemeral handshake keys only —
a leaked ephemeral scalar compromises one session, never the node's
Ed25519 identity.
"""

from __future__ import annotations

import secrets

_P = 2**255 - 19
_A24 = 121665
BASE_POINT = (9).to_bytes(32, "little")


def _decode_scalar(k: bytes) -> int:
    if len(k) != 32:
        raise ValueError("x25519 scalar must be 32 bytes")
    b = bytearray(k)
    b[0] &= 248
    b[31] &= 127
    b[31] |= 64
    return int.from_bytes(bytes(b), "little")


def scalarmult(k: bytes, u: bytes) -> bytes:
    """RFC 7748 §5 X25519(k, u) -> 32-byte shared point."""
    if len(u) != 32:
        raise ValueError("x25519 point must be 32 bytes")
    k_int = _decode_scalar(k)
    x1 = int.from_bytes(u, "little") & ((1 << 255) - 1)
    x2, z2, x3, z3 = 1, 0, x1, 1
    swap = 0
    for t in reversed(range(255)):
        k_t = (k_int >> t) & 1
        if swap ^ k_t:
            x2, x3 = x3, x2
            z2, z3 = z3, z2
        swap = k_t
        a = (x2 + z2) % _P
        aa = a * a % _P
        b = (x2 - z2) % _P
        bb = b * b % _P
        e = (aa - bb) % _P
        c = (x3 + z3) % _P
        d = (x3 - z3) % _P
        da = d * a % _P
        cb = c * b % _P
        x3 = (da + cb) * (da + cb) % _P
        z3 = x1 * (da - cb) * (da - cb) % _P
        x2 = aa * bb % _P
        z2 = e * (aa + _A24 * e) % _P
    if swap:
        x2, z2 = x3, z3
    return (x2 * pow(z2, _P - 2, _P) % _P).to_bytes(32, "little")


def generate_private() -> bytes:
    return secrets.token_bytes(32)


def public_from_private(priv: bytes) -> bytes:
    return scalarmult(priv, BASE_POINT)


def shared_secret(priv: bytes, their_pub: bytes) -> bytes:
    """DH exchange; rejects the all-zero output produced by small-order
    peer points (same contributory-behavior check `cryptography` does)."""
    out = scalarmult(priv, their_pub)
    if out == b"\x00" * 32:
        raise ValueError("x25519 shared secret is zero (bad peer point)")
    return out
