"""Batched SHA-512 of pre-padded messages: the hash half of Ed25519
verification on the device.

Twin of `cometbft_tpu/ops/sha512.py`. Computes SHA-512(R || A || M) for
every lane of a signature batch, so the host never hashes on the
device-SHA and delta routes.

Input layout (the reference's): messages pre-padded to exactly two
128-byte SHA-512 blocks (R||A||M up to 239 bytes), delivered as (B, 64)
32-bit big-endian words. At this boundary the words are an int64 tensor
holding values < 2^32, or an int32 tensor holding the same bit patterns
(what the pinned host buffers carry); both give the same digests.

`sha512_digest` dispatches on the tensor's device: a CUDA tensor launches
the `sha512_blocks` kernel (`csrc/sha512_kernels.cu`), which returns the
64 digest bytes of each lane in hashlib's order; a CPU tensor runs the
plain version, `sha512_digest_plain`. The plain version keeps each
64-bit word as two 32-bit halves, each in an int64 tensor masked with
0xFFFFFFFF after every add (torch's uint32 has no add or shifts on the
CPU, and int32 `>>` is arithmetic), as the reference keeps (hi, lo)
uint32 pairs. The verify routes take the challenge through
`scalar.sha512_reduce`, which hashes and reduces mod L in one launch.

Constants are derived, not transcribed: K[t] = frac(cbrt(prime_t)) and
IV[i] = frac(sqrt(prime_i)) scaled to 64 bits, with exact integer roots,
spot-checked against FIPS 180-4 at import.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import field as F
from . import kernels as K

MAX_INPUT_BYTES = 239  # two 128-byte blocks minus 0x80 pad byte and 16-byte length
PADDED_BYTES = 256
PADDED_WORDS = 64  # 32-bit big-endian words

M32 = 0xFFFFFFFF


def _primes(n: int) -> list[int]:
    out, c = [], 2
    while len(out) < n:
        if all(c % p for p in out):
            out.append(c)
        c += 1
    return out


def _icbrt(n: int) -> int:
    x = int(round(n ** (1 / 3)))
    while x * x * x > n:
        x -= 1
    while (x + 1) ** 3 <= n:
        x += 1
    return x


_PRIMES = _primes(80)
K64 = [_icbrt(p << 192) & ((1 << 64) - 1) for p in _PRIMES]
IV64 = [math.isqrt(p << 128) & ((1 << 64) - 1) for p in _PRIMES[:8]]
assert K64[0] == 0x428A2F98D728AE22 and K64[79] == 0x6C44198C4A475817
assert IV64[0] == 0x6A09E667F3BCC908 and IV64[7] == 0x5BE0CD19137E2179


def _add2(a, b):
    lo = a[1] + b[1]
    return ((a[0] + b[0] + (lo >> 32)) & M32, lo & M32)


def _add(*xs):
    acc = xs[0]
    for x in xs[1:]:
        acc = _add2(acc, x)
    return acc


def _rotr(x, n: int):
    hi, lo = x
    if n == 32:
        return (lo, hi)
    if n > 32:
        hi, lo, n = lo, hi, n - 32
    return (((hi >> n) | (lo << (32 - n))) & M32, ((lo >> n) | (hi << (32 - n))) & M32)


def _shr(x, n: int):
    hi, lo = x
    return (hi >> n, ((lo >> n) | (hi << (32 - n))) & M32)


def _xor3(a, b, c):
    return (a[0] ^ b[0] ^ c[0], a[1] ^ b[1] ^ c[1])


def _bsig0(x):
    return _xor3(_rotr(x, 28), _rotr(x, 34), _rotr(x, 39))


def _bsig1(x):
    return _xor3(_rotr(x, 14), _rotr(x, 18), _rotr(x, 41))


def _ssig0(x):
    return _xor3(_rotr(x, 1), _rotr(x, 8), _shr(x, 7))


def _ssig1(x):
    return _xor3(_rotr(x, 19), _rotr(x, 61), _shr(x, 6))


def _ch(e, f, g):
    return tuple((e[i] & f[i]) ^ (~e[i] & M32 & g[i]) for i in range(2))


def _maj(a, b, c):
    return tuple((a[i] & b[i]) ^ (a[i] & c[i]) ^ (b[i] & c[i]) for i in range(2))


def _compress(state, w):
    """One SHA-512 block: state and w[0..15] are (hi, lo) pairs of (B,)
    int64 tensors; returns the new state."""
    w = list(w)
    a, b, c, d, e, f, g, h = state
    for t in range(80):
        if t >= 16:
            w.append(_add(_ssig1(w[t - 2]), w[t - 7], _ssig0(w[t - 15]), w[t - 16]))
        kt = (K64[t] >> 32, K64[t] & M32)
        t1 = _add(h, _bsig1(e), _ch(e, f, g), kt, w[t])
        t2 = _add2(_bsig0(a), _maj(a, b, c))
        a, b, c, d, e, f, g, h = _add2(t1, t2), a, b, c, _add2(d, t1), e, f, g
    return [_add2(s, v) for s, v in zip(state, (a, b, c, d, e, f, g, h))]


def two_blocks_mask(two_blocks, batch: int, device) -> torch.Tensor:
    if two_blocks is None:
        return torch.ones(batch, dtype=torch.bool, device=device)
    return two_blocks.to(device=device, dtype=torch.bool)


def sha512_two_blocks_plain(words, two_blocks=None):
    """Plain PyTorch SHA-512 on any device. words: (B, 64) int64 (< 2^32)
    or int32 (bit patterns); two_blocks: (B,) bool, lanes whose padded
    message spans both blocks (None = all). Short lanes take the state
    after block 1. Returns (hi, lo), each (8, B) int64 < 2^32: the digest
    as 8 big-endian 64-bit words split into halves."""
    w = words.to(torch.int64) & M32
    batch = w.shape[0]
    state = [(torch.full((batch,), iv >> 32, dtype=torch.int64, device=w.device),
              torch.full((batch,), iv & M32, dtype=torch.int64, device=w.device)) for iv in IV64]
    states = []
    for blk in range(2):
        block = [(w[:, blk * 32 + 2 * j], w[:, blk * 32 + 2 * j + 1]) for j in range(16)]
        state = _compress(state, block)
        states.append(state)
    tb = two_blocks_mask(two_blocks, batch, w.device)
    one, two = ([torch.stack([s[h] for s in st]) for h in range(2)] for st in states)
    return torch.where(tb, two[0], one[0]), torch.where(tb, two[1], one[1])


def digest_to_bytes(hi, lo):
    """(8, B) big-endian word halves -> (B, 64) uint8 digest bytes in
    hashlib order (byte i weighs 256^i in k)."""
    halves = torch.stack([hi, lo], dim=1).reshape(16, -1).to(torch.int64)  # (16, B)
    shifts = torch.tensor([24, 16, 8, 0], dtype=torch.int64, device=halves.device)
    b = (halves[:, None, :] >> shifts[None, :, None]) & 0xFF  # (16, 4, B)
    return b.reshape(64, -1).T.contiguous().to(torch.uint8)


def digest_to_words(digest):
    """(B, 64) uint8 digest bytes -> (hi, lo), each (8, B) int64: the
    inverse of `digest_to_bytes`."""
    b = digest.to(torch.int64).T.reshape(16, 4, -1)
    halves = (b[:, 0] << 24) | (b[:, 1] << 16) | (b[:, 2] << 8) | b[:, 3]
    return halves[0::2].contiguous(), halves[1::2].contiguous()


def sha512_digest_plain(words, two_blocks=None):
    """Plain PyTorch version of the `sha512_blocks` kernel: (B, 64) words
    -> (B, 64) uint8 digests in hashlib order."""
    return digest_to_bytes(*sha512_two_blocks_plain(words, two_blocks))


def sha512_digest(words, two_blocks=None):
    """(B, 64) padded words -> (B, 64) uint8 digests in hashlib order: one
    `sha512_blocks` launch on a CUDA tensor, the plain version on a CPU
    tensor."""
    if F.on_gpu(words):
        tb = two_blocks_mask(two_blocks, words.shape[0], words.device)
        return K.sha512_blocks(words.to(torch.int32).contiguous(), tb.contiguous())
    return sha512_digest_plain(words, two_blocks)


def sha512_two_blocks(words, two_blocks=None):
    """The reference's boundary: (hi, lo), each (8, B) int64 < 2^32, the
    digest's big-endian 64-bit words in halves. Through the kernel on a
    CUDA tensor, the plain version on a CPU tensor."""
    if F.on_gpu(words):
        return digest_to_words(sha512_digest(words, two_blocks))
    return sha512_two_blocks_plain(words, two_blocks)


def pad_rows(rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host helper: (n, ln) uint8 messages of one length -> what
    `pad_messages` gives for them, padded with whole-batch numpy ops."""
    n, ln = rows.shape
    if ln > MAX_INPUT_BYTES:
        raise ValueError("message exceeds two SHA-512 blocks")
    buf = np.zeros((n, PADDED_BYTES), np.uint8)
    buf[:, :ln] = rows
    buf[:, ln] = 0x80
    end = PADDED_BYTES if ln > 111 else PADDED_BYTES // 2
    buf[:, end - 8 : end] = np.frombuffer(np.array(ln * 8, ">u8").tobytes(), np.uint8)
    return buf.view(">u4").astype(np.uint32), np.full(n, ln > 111)


def pad_messages(msgs: list[bytes]) -> tuple[np.ndarray, np.ndarray]:
    """Host helper: messages -> ((B, 64) uint32 big-endian padded words,
    (B,) bool two-block flags).

    Standard SHA-512 padding per lane: messages <= 111 bytes fit one block
    (bit length at bytes 120..127), longer ones span two (length at bytes
    248..255). Vectorized for the common case of uniform-length messages
    (commit sign-bytes share a length, `pad_rows`); per-item loop
    otherwise.
    """
    n = len(msgs)
    buf = np.zeros((n, PADDED_BYTES), np.uint8)
    lens = np.fromiter((len(m) for m in msgs), np.int64, n) if n else np.zeros(0, np.int64)
    if n and lens.max(initial=0) > MAX_INPUT_BYTES:
        raise ValueError("message exceeds two SHA-512 blocks")
    if n and (lens == lens[0]).all():
        return pad_rows(np.frombuffer(b"".join(msgs), np.uint8).reshape(n, int(lens[0])))
    two = lens > 111
    for i, m in enumerate(msgs):
        ln = len(m)
        buf[i, :ln] = np.frombuffer(m, np.uint8)
        buf[i, ln] = 0x80
    bitlen = (lens * 8).astype(">u8").view(np.uint8).reshape(n, 8)
    buf[two, 248:256] = bitlen[two]
    buf[~two, 120:128] = bitlen[~two]
    words = buf.reshape(n, PADDED_WORDS, 4).astype(np.uint32) @ np.array(
        [1 << 24, 1 << 16, 1 << 8, 1], np.uint32
    )
    return words, two
