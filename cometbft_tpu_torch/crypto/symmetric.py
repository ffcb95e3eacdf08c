"""Symmetric crypto: Salsa20/ChaCha20 family + Poly1305, pure host-side.

Twin of `cometbft_tpu/crypto/symmetric.py`, byte for byte: the same
functions compute the same bytes, all in pure Python (no `cryptography`):

- reference crypto/xsalsa20symmetric/symmetric.go: EncryptSymmetric =
  random 24-byte nonce ‖ NaCl secretbox (XSalsa20-Poly1305); the secret
  must be exactly 32 bytes;
- reference crypto/xchacha20poly1305: the XChaCha20-Poly1305 AEAD
  (HChaCha20 subkey + 8-byte-tail nonce ChaCha20-Poly1305);
- RFC 8439 ChaCha20-Poly1305, which seals every frame of the p2p secret
  connection (`p2p/secret_connection.py`).

ChaCha20 is the hot one (one 1,028-byte frame is 17 blocks), so its 20
rounds run as straight-line code over 16 local words, and the keystream is
XORed in as one big integer; everything else follows the specs as the
reference writes them.
"""

from __future__ import annotations

import secrets
import struct

MASK32 = 0xFFFFFFFF


def _rotl(x: int, n: int) -> int:
    return ((x << n) | (x >> (32 - n))) & MASK32


def _xor(data: bytes, stream: bytes) -> bytes:
    """data XOR the first len(data) bytes of stream."""
    n = len(data)
    if not n:
        return b""
    v = int.from_bytes(data, "little") ^ int.from_bytes(stream[:n], "little")
    return v.to_bytes(n, "little")


# ------------------------------------------------------------- salsa20 ----
def _salsa20_core(state16: list[int], rounds: int = 20) -> list[int]:
    x = list(state16)

    def qr(a, b, c, d):
        x[b] ^= _rotl((x[a] + x[d]) & MASK32, 7)
        x[c] ^= _rotl((x[b] + x[a]) & MASK32, 9)
        x[d] ^= _rotl((x[c] + x[b]) & MASK32, 13)
        x[a] ^= _rotl((x[d] + x[c]) & MASK32, 18)

    for _ in range(rounds // 2):
        qr(0, 4, 8, 12); qr(5, 9, 13, 1); qr(10, 14, 2, 6); qr(15, 3, 7, 11)
        qr(0, 1, 2, 3); qr(5, 6, 7, 4); qr(10, 11, 8, 9); qr(15, 12, 13, 14)
    return x


_SIGMA = struct.unpack("<4I", b"expand 32-byte k")


def _salsa20_block(key: bytes, nonce16: bytes) -> bytes:
    k = struct.unpack("<8I", key)
    n = struct.unpack("<4I", nonce16)
    s = [_SIGMA[0], *k[:4], _SIGMA[1], *n, _SIGMA[2], *k[4:], _SIGMA[3]]
    out = _salsa20_core(s)
    return struct.pack("<16I", *((a + b) & MASK32 for a, b in zip(out, s)))


def hsalsa20(key: bytes, nonce16: bytes) -> bytes:
    """32-byte subkey from the core WITHOUT the feedforward (key rows)."""
    k = struct.unpack("<8I", key)
    n = struct.unpack("<4I", nonce16)
    s = [_SIGMA[0], *k[:4], _SIGMA[1], *n, _SIGMA[2], *k[4:], _SIGMA[3]]
    z = _salsa20_core(s)
    picks = [z[0], z[5], z[10], z[15], z[6], z[7], z[8], z[9]]
    return struct.pack("<8I", *picks)


def xsalsa20_stream(key: bytes, nonce24: bytes, length: int,
                    counter: int = 0) -> bytes:
    subkey = hsalsa20(key, nonce24[:16])
    out = bytearray()
    block_nonce = nonce24[16:24]
    i = counter
    while len(out) < length:
        n16 = block_nonce + struct.pack("<Q", i)
        out += _salsa20_block(subkey, n16)
        i += 1
    return bytes(out[:length])


# ------------------------------------------------------------ poly1305 ----
def poly1305(key32: bytes, msg: bytes) -> bytes:
    r = int.from_bytes(key32[:16], "little")
    r &= 0x0FFFFFFC0FFFFFFC0FFFFFFC0FFFFFFF
    s = int.from_bytes(key32[16:], "little")
    p = (1 << 130) - 5
    acc = 0
    for i in range(0, len(msg), 16):
        blk = msg[i : i + 16]
        n = int.from_bytes(blk, "little") + (1 << (8 * len(blk)))
        acc = (acc + n) * r % p
    return ((acc + s) & ((1 << 128) - 1)).to_bytes(16, "little")


# ------------------------------------------------- NaCl secretbox --------
SECRETBOX_OVERHEAD = 16
NONCE_LEN = 24
SECRET_LEN = 32


def secretbox_seal(plaintext: bytes, nonce24: bytes, key: bytes) -> bytes:
    """XSalsa20-Poly1305: tag ‖ ciphertext (NaCl box layout)."""
    stream = xsalsa20_stream(key, nonce24, 32 + len(plaintext))
    poly_key, pad = stream[:32], stream[32:]
    ct = _xor(plaintext, pad)
    tag = poly1305(poly_key, ct)
    return tag + ct


def secretbox_open(boxed: bytes, nonce24: bytes, key: bytes) -> bytes | None:
    if len(boxed) < SECRETBOX_OVERHEAD:
        return None
    tag, ct = boxed[:16], boxed[16:]
    stream = xsalsa20_stream(key, nonce24, 32 + len(ct))
    poly_key, pad = stream[:32], stream[32:]
    if not secrets.compare_digest(tag, poly1305(poly_key, ct)):
        return None
    return _xor(ct, pad)


class ErrInvalidCiphertextLen(Exception):
    pass


class ErrCiphertextDecryption(Exception):
    pass


def encrypt_symmetric(plaintext: bytes, secret: bytes) -> bytes:
    """nonce(24) ‖ secretbox(plaintext) — reference EncryptSymmetric."""
    if len(secret) != SECRET_LEN:
        raise ValueError(f"secret must be {SECRET_LEN} bytes")
    nonce = secrets.token_bytes(NONCE_LEN)
    return nonce + secretbox_seal(plaintext, nonce, secret)


def decrypt_symmetric(ciphertext: bytes, secret: bytes) -> bytes:
    if len(secret) != SECRET_LEN:
        raise ValueError(f"secret must be {SECRET_LEN} bytes")
    if len(ciphertext) <= SECRETBOX_OVERHEAD + NONCE_LEN:
        raise ErrInvalidCiphertextLen
    out = secretbox_open(ciphertext[NONCE_LEN:], ciphertext[:NONCE_LEN], secret)
    if out is None:
        raise ErrCiphertextDecryption
    return out


# --------------------------------------------------------- chacha20 -------
def _chacha20_rounds(s: list[int], M: int = MASK32) -> tuple[int, ...]:
    """The 20 ChaCha rounds (10 column + diagonal double rounds) of the
    16-word state s, without the feed-forward. With M = MASK32 each word is
    one 32-bit value; with M = `_lane_mask(n)` each word packs n blocks'
    words, one a 64-bit lane (`chacha20_stream`): an add's carry lands in
    the lane's top half and the mask drops it, and a rotate's bits from
    the next lane land there too, so the same code runs n blocks at once."""
    x0, x1, x2, x3, x4, x5, x6, x7, x8, x9, x10, x11, x12, x13, x14, x15 = s
    for _ in range(10):
        x0 = (x0 + x4) & M; x12 ^= x0; x12 = ((x12 << 16) | (x12 >> 16)) & M
        x8 = (x8 + x12) & M; x4 ^= x8; x4 = ((x4 << 12) | (x4 >> 20)) & M
        x0 = (x0 + x4) & M; x12 ^= x0; x12 = ((x12 << 8) | (x12 >> 24)) & M
        x8 = (x8 + x12) & M; x4 ^= x8; x4 = ((x4 << 7) | (x4 >> 25)) & M
        x1 = (x1 + x5) & M; x13 ^= x1; x13 = ((x13 << 16) | (x13 >> 16)) & M
        x9 = (x9 + x13) & M; x5 ^= x9; x5 = ((x5 << 12) | (x5 >> 20)) & M
        x1 = (x1 + x5) & M; x13 ^= x1; x13 = ((x13 << 8) | (x13 >> 24)) & M
        x9 = (x9 + x13) & M; x5 ^= x9; x5 = ((x5 << 7) | (x5 >> 25)) & M
        x2 = (x2 + x6) & M; x14 ^= x2; x14 = ((x14 << 16) | (x14 >> 16)) & M
        x10 = (x10 + x14) & M; x6 ^= x10; x6 = ((x6 << 12) | (x6 >> 20)) & M
        x2 = (x2 + x6) & M; x14 ^= x2; x14 = ((x14 << 8) | (x14 >> 24)) & M
        x10 = (x10 + x14) & M; x6 ^= x10; x6 = ((x6 << 7) | (x6 >> 25)) & M
        x3 = (x3 + x7) & M; x15 ^= x3; x15 = ((x15 << 16) | (x15 >> 16)) & M
        x11 = (x11 + x15) & M; x7 ^= x11; x7 = ((x7 << 12) | (x7 >> 20)) & M
        x3 = (x3 + x7) & M; x15 ^= x3; x15 = ((x15 << 8) | (x15 >> 24)) & M
        x11 = (x11 + x15) & M; x7 ^= x11; x7 = ((x7 << 7) | (x7 >> 25)) & M
        # diagonal round
        x0 = (x0 + x5) & M; x15 ^= x0; x15 = ((x15 << 16) | (x15 >> 16)) & M
        x10 = (x10 + x15) & M; x5 ^= x10; x5 = ((x5 << 12) | (x5 >> 20)) & M
        x0 = (x0 + x5) & M; x15 ^= x0; x15 = ((x15 << 8) | (x15 >> 24)) & M
        x10 = (x10 + x15) & M; x5 ^= x10; x5 = ((x5 << 7) | (x5 >> 25)) & M
        x1 = (x1 + x6) & M; x12 ^= x1; x12 = ((x12 << 16) | (x12 >> 16)) & M
        x11 = (x11 + x12) & M; x6 ^= x11; x6 = ((x6 << 12) | (x6 >> 20)) & M
        x1 = (x1 + x6) & M; x12 ^= x1; x12 = ((x12 << 8) | (x12 >> 24)) & M
        x11 = (x11 + x12) & M; x6 ^= x11; x6 = ((x6 << 7) | (x6 >> 25)) & M
        x2 = (x2 + x7) & M; x13 ^= x2; x13 = ((x13 << 16) | (x13 >> 16)) & M
        x8 = (x8 + x13) & M; x7 ^= x8; x7 = ((x7 << 12) | (x7 >> 20)) & M
        x2 = (x2 + x7) & M; x13 ^= x2; x13 = ((x13 << 8) | (x13 >> 24)) & M
        x8 = (x8 + x13) & M; x7 ^= x8; x7 = ((x7 << 7) | (x7 >> 25)) & M
        x3 = (x3 + x4) & M; x14 ^= x3; x14 = ((x14 << 16) | (x14 >> 16)) & M
        x9 = (x9 + x14) & M; x4 ^= x9; x4 = ((x4 << 12) | (x4 >> 20)) & M
        x3 = (x3 + x4) & M; x14 ^= x3; x14 = ((x14 << 8) | (x14 >> 24)) & M
        x9 = (x9 + x14) & M; x4 ^= x9; x4 = ((x4 << 7) | (x4 >> 25)) & M
    return (x0, x1, x2, x3, x4, x5, x6, x7, x8, x9, x10, x11, x12, x13, x14, x15)


def _chacha20_block(key: bytes, counter: int, nonce12: bytes) -> bytes:
    s = [*_SIGMA, *struct.unpack("<8I", key), counter & MASK32,
         *struct.unpack("<3I", nonce12)]
    out = _chacha20_rounds(s)
    return struct.pack("<16I", *((a + b) & MASK32 for a, b in zip(out, s)))


def _lane_mask(n: int) -> int:
    """MASK32 in each of n 64-bit lanes."""
    return int.from_bytes(b"\xff\xff\xff\xff\x00\x00\x00\x00" * n, "little")


def chacha20_stream(key: bytes, nonce12: bytes, length: int,
                    counter: int = 1) -> bytes:
    """The keystream from block `counter` on, every block of it computed at
    once in 64-bit lanes of big integers (see `_chacha20_rounds`)."""
    n = -(-length // 64)
    if n == 0:
        return b""
    M = _lane_mask(n)
    rep = M // MASK32  # 1 in each lane
    ctr = sum(((counter + j) & MASK32) << (64 * j) for j in range(n))
    s = ([w * rep for w in _SIGMA] + [w * rep for w in struct.unpack("<8I", key)]
         + [ctr] + [w * rep for w in struct.unpack("<3I", nonce12)])
    x = _chacha20_rounds(s, M)
    out = bytearray(64 * n)
    for i in range(16):
        word = ((x[i] + s[i]) & M).to_bytes(8 * n, "little")  # block j's word i at 8j
        for k in range(4):
            out[4 * i + k::64] = word[k::8]
    return bytes(out[:length])


def hchacha20(key: bytes, nonce16: bytes) -> bytes:
    s = [*_SIGMA, *struct.unpack("<8I", key), *struct.unpack("<4I", nonce16)]
    z = _chacha20_rounds(s)
    return struct.pack("<8I", *(z[:4] + z[12:16]))


def _pad16(b: bytes) -> bytes:
    return b"\x00" * (-len(b) % 16)


def _aead_tag(key: bytes, nonce12: bytes, aad: bytes, ct: bytes) -> bytes:
    poly_key = _chacha20_block(key, 0, nonce12)[:32]
    mac_data = (aad + _pad16(aad) + ct + _pad16(ct)
                + struct.pack("<Q", len(aad)) + struct.pack("<Q", len(ct)))
    return poly1305(poly_key, mac_data)


def chacha20poly1305_seal(key: bytes, nonce12: bytes, plaintext: bytes,
                          aad: bytes = b"") -> bytes:
    ct = _xor(plaintext, chacha20_stream(key, nonce12, len(plaintext)))
    return ct + _aead_tag(key, nonce12, aad, ct)


def chacha20poly1305_open(key: bytes, nonce12: bytes, boxed: bytes,
                          aad: bytes = b"") -> bytes | None:
    if len(boxed) < 16:
        return None
    ct, tag = boxed[:-16], boxed[-16:]
    if not secrets.compare_digest(tag, _aead_tag(key, nonce12, aad, ct)):
        return None
    return _xor(ct, chacha20_stream(key, nonce12, len(ct)))


def xchacha20poly1305_seal(key: bytes, nonce24: bytes, plaintext: bytes,
                           aad: bytes = b"") -> bytes:
    """reference crypto/xchacha20poly1305 New().Seal."""
    subkey = hchacha20(key, nonce24[:16])
    nonce12 = b"\x00" * 4 + nonce24[16:]
    return chacha20poly1305_seal(subkey, nonce12, plaintext, aad)


def xchacha20poly1305_open(key: bytes, nonce24: bytes, boxed: bytes,
                           aad: bytes = b"") -> bytes | None:
    subkey = hchacha20(key, nonce24[:16])
    nonce12 = b"\x00" * 4 + nonce24[16:]
    return chacha20poly1305_open(subkey, nonce12, boxed, aad)
