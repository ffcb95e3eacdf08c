"""Authenticated encryption for peer connections.

Twin of `cometbft_tpu/p2p/secret_connection.py`. Behavior parity:
reference p2p/conn/secret_connection.go — the station-to-station pattern
(:32-40):
1. exchange ephemeral X25519 pubkeys;
2. derive two ChaCha20-Poly1305 keys + a challenge via HKDF-SHA256 over
   the DH secret; key roles assigned by sorted ephemeral keys so both
   sides agree (reference deriveSecretAndChallenge);
3. all further traffic is sealed in 1028-byte frames (4-byte little-endian
   length + 1024 data bytes, reference :34-38) with a little-endian
   96-bit counter nonce per direction (reference :44);
4. exchange Ed25519 identity pubkeys + signatures over the challenge
   INSIDE the encrypted channel and verify (shareAuthSignature).

Design note: CometBFT binds its transcript with Merlin; this
implementation binds the challenge with SHA-256 over both ephemeral keys
(lo || hi) — same STS shape, not byte-compatible with CometBFT's wire
format. It is byte-compatible with `cometbft_tpu`'s, whose nodes it
hand-shakes with.

The primitives are always the port's own: RFC 7748 X25519
(`crypto/x25519.py`), RFC 8439 ChaCha20-Poly1305 (`crypto/symmetric.py`,
pure Python) and an RFC 5869 HKDF-SHA256 on the standard library's hmac.
The reference prefers the `cryptography` package when it is installed;
the two compute the same bytes. Each connection counts the frames it
sealed and opened and the seconds that took (`sealed_frames`, `seal_s`,
`opened_frames`, `open_s`): on a host without a native cipher the
frames' cipher sets the wire's pace.
"""

from __future__ import annotations

import hashlib
import hmac
import struct
import threading
import time

from ..crypto import x25519 as _x25519
from ..crypto.ed25519 import Ed25519PrivKey, Ed25519PubKey
from ..crypto.symmetric import chacha20poly1305_open, chacha20poly1305_seal

DATA_LEN_SIZE = 4
DATA_MAX_SIZE = 1024
TAG_SIZE = 16
FRAME_SIZE = DATA_LEN_SIZE + DATA_MAX_SIZE  # plaintext frame
SEALED_FRAME_SIZE = FRAME_SIZE + TAG_SIZE


class AuthError(Exception):
    pass


def _x25519_keypair():
    """-> (32-byte private scalar, 32-byte public key)."""
    priv = _x25519.generate_private()
    return priv, _x25519.public_from_private(priv)


def _hkdf_sha256(ikm: bytes, length: int, info: bytes) -> bytes:
    """RFC 5869 with the null salt expanded to HashLen zero bytes."""
    prk = hmac.new(b"\x00" * 32, ikm, hashlib.sha256).digest()
    okm, block, ctr = b"", b"", 1
    while len(okm) < length:
        block = hmac.new(prk, block + info + bytes([ctr]),
                         hashlib.sha256).digest()
        okm += block
        ctr += 1
    return okm[:length]


class _Aead:
    """ChaCha20-Poly1305 under one key; decrypt raises AuthError on a tag
    mismatch."""

    def __init__(self, key: bytes):
        self._key = key

    def encrypt(self, nonce: bytes, data: bytes, aad: bytes | None) -> bytes:
        return chacha20poly1305_seal(self._key, nonce, data, aad or b"")

    def decrypt(self, nonce: bytes, data: bytes, aad: bytes | None) -> bytes:
        pt = chacha20poly1305_open(self._key, nonce, data, aad or b"")
        if pt is None:
            raise AuthError("frame authentication failed")
        return pt


def _read_exact(sock, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("socket closed")
        buf += chunk
    return buf


class _HalfNonce:
    """96-bit little-endian counter nonce (reference :44)."""

    def __init__(self):
        self._n = 0

    def next(self) -> bytes:
        v = self._n
        self._n += 1
        return struct.pack("<Q", v & ((1 << 64) - 1)) + struct.pack(
            "<I", v >> 64
        )


class SecretConnection:
    def __init__(self, sock, priv_key: Ed25519PrivKey):
        self._sock = sock
        self.sealed_frames = self.opened_frames = 0
        self.seal_s = self.open_s = 0.0
        self._send_lock = threading.Lock()
        self._recv_lock = threading.Lock()
        self._recv_buf = b""
        # reusable plaintext-frame scratch for the vectored send path:
        # one per connection, only ever touched under _send_lock
        self._frame_scratch = bytearray(FRAME_SIZE)
        self._zero_pad = bytes(DATA_MAX_SIZE)

        eph_priv, eph_pub = _x25519_keypair()
        sock.sendall(eph_pub)
        their_eph = _read_exact(sock, 32)

        shared = _x25519.shared_secret(eph_priv, their_eph)
        lo, hi = sorted([eph_pub, their_eph])
        we_are_lo = eph_pub == lo
        okm = _hkdf_sha256(
            shared + lo + hi,
            96,
            b"COMETBFT_TPU_SECRET_CONNECTION_KEY_AND_CHALLENGE_GEN",
        )
        key1, key2, challenge = okm[:32], okm[32:64], okm[64:]
        # lo's receive key is key1 (mirrors the reference's assignment)
        if we_are_lo:
            self._recv_aead = _Aead(key1)
            self._send_aead = _Aead(key2)
        else:
            self._recv_aead = _Aead(key2)
            self._send_aead = _Aead(key1)
        self._send_nonce = _HalfNonce()
        self._recv_nonce = _HalfNonce()

        # authenticate identities inside the encrypted channel
        sig = priv_key.sign(challenge)
        self.write_msg(priv_key.pub_key().bytes() + sig)
        auth = self.read_msg()
        if len(auth) != 32 + 64:
            raise AuthError("bad auth message size")
        their_pub = Ed25519PubKey(auth[:32])
        if not their_pub.verify_signature(challenge, auth[32:]):
            raise AuthError("peer identity signature invalid")
        self.remote_pub_key = their_pub

    # ------------------------------------------------------------------
    def write(self, data: bytes) -> None:
        """Send data as sealed frames (splitting like the reference Write)."""
        with self._send_lock:
            view = memoryview(data)
            # always send at least one frame (empty messages carry length 0)
            first = True
            while first or view:
                first = False
                chunk = bytes(view[:DATA_MAX_SIZE])
                view = view[len(chunk):]
                frame = struct.pack("<I", len(chunk)) + chunk
                frame += bytes(FRAME_SIZE - len(frame))
                self._sock.sendall(self._seal(frame))

    def _seal(self, frame: bytes) -> bytes:
        """One plaintext frame sealed under the next send nonce (counted)."""
        t0 = time.perf_counter()
        sealed = self._send_aead.encrypt(self._send_nonce.next(), frame, None)
        self.seal_s += time.perf_counter() - t0
        self.sealed_frames += 1
        return sealed

    def _read_frame(self) -> bytes:
        sealed = _read_exact(self._sock, SEALED_FRAME_SIZE)
        t0 = time.perf_counter()
        frame = self._recv_aead.decrypt(self._recv_nonce.next(), sealed, None)
        self.open_s += time.perf_counter() - t0
        self.opened_frames += 1
        (ln,) = struct.unpack_from("<I", frame)
        if ln > DATA_MAX_SIZE:
            raise AuthError("corrupt frame length")
        return frame[DATA_LEN_SIZE : DATA_LEN_SIZE + ln]

    def read(self, n: int) -> bytes:
        """Read up to n plaintext bytes (frame-buffered)."""
        with self._recv_lock:
            if not self._recv_buf:
                self._recv_buf = self._read_frame()
            out, self._recv_buf = self._recv_buf[:n], self._recv_buf[n:]
            return out

    def read_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.read(n - len(buf))
            buf += chunk
        return buf

    def write_views(self, *bufs) -> None:
        """Vectored write_msg: seal the logical concatenation of `bufs`
        as ONE length-prefixed message without materializing it.
        Wire-identical to ``write_msg(b"".join(bufs))`` — callers hand
        down memoryview slices (the MConnection zero-copy send path) and
        the only copy before encryption is the slice-assign into the
        per-connection frame scratch."""
        views = [memoryview(b) for b in bufs]
        total = sum(len(v) for v in views)
        views.insert(0, memoryview(struct.pack("<I", total)))
        with self._send_lock:
            scratch = self._frame_scratch
            vi, pos = 0, 0
            remaining = DATA_LEN_SIZE + total  # length prefix + payload
            while remaining > 0:
                take = min(DATA_MAX_SIZE, remaining)
                struct.pack_into("<I", scratch, 0, take)
                off = DATA_LEN_SIZE
                need = take
                while need:
                    v = views[vi]
                    k = min(len(v) - pos, need)
                    if k:
                        scratch[off:off + k] = v[pos:pos + k]
                        off += k
                        pos += k
                        need -= k
                    if pos == len(v):
                        vi += 1
                        pos = 0
                if take < DATA_MAX_SIZE:
                    scratch[off:FRAME_SIZE] = \
                        self._zero_pad[:FRAME_SIZE - off]
                self._sock.sendall(self._seal(bytes(scratch)))
                remaining -= take

    # message helpers for the handshake/MConnection layers: each message is
    # sent as its own frame sequence prefixed with a 4-byte length
    def write_msg(self, data) -> None:
        self.write_views(data)

    def read_msg(self) -> bytes:
        (ln,) = struct.unpack("<I", self.read_exact(4))
        if ln > 64 * 1024 * 1024:
            raise AuthError("message too large")
        return self.read_exact(ln)

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass
