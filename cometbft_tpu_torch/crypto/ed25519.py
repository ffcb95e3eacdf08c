"""Ed25519 public keys and the GPU batch verifier.

Twin of the commit-verify subset of `cometbft_tpu/crypto/ed25519.py`.
`Ed25519BatchVerifier.submit()` has one route, the prehashed per-lane
ladder:

- the host packs (b, 96) R||S||k rows, with k = SHA-512(R||A||M) mod L
  hashed by hashlib, straight into a pinned buffer, and copies it to the
  device with `non_blocking=True`;
- the pubkey column is decompressed once per validator set and kept on
  the device, keyed by (sha256(pubkey blob), bucket, device);
- `ops.ed25519_verify.verify_batch_cached_a` runs the decompress and
  ladder kernels and leaves (bitmap, all-ok) on the device;
- `PendingBatch` / `collect_pending` fetch one all-ok scalar per batch,
  and the bitmap only when that scalar says some lane failed.

Behavior parity: reference crypto/ed25519/ed25519.go (verify :180-187
with ZIP-215 options :36-41, batch :207-240). A verifier made for
"cuda" on a host without a GPU raises; nothing falls back to the CPU.
"""

from __future__ import annotations

import hashlib
import threading

import numpy as np
import torch

from ..ops.ed25519_verify import decompress_pubkeys, verify_batch_cached_a
from . import ed25519_ref as ref
from .keys import BatchVerifier, PubKey, tmhash20

KEY_TYPE = "tendermint/PubKeyEd25519"
PUB_KEY_SIZE = 32
SIG_SIZE = 64

# Padded batch buckets (the reference's): 10240 exists for the
# 10k-validator commit, which 16384 would pad by 38%.
BUCKETS = (64, 256, 1024, 4096, 10240, 16384, 65536)

_L = ref.L
# big-endian bytes of the group order, for the vectorized S < L precheck
_L_BE = np.frombuffer(_L.to_bytes(32, "big"), np.uint8)

# (sha256(pubkey column), bucket, device) -> device-resident (ok_a, neg_a)
# from ops.ed25519_verify.decompress_pubkeys; shared by every verifier in
# the process, since consumers build a fresh verifier per commit.
_A_CACHE: dict = {}
_A_CACHE_SIZE = 4
_A_LOCK = threading.Lock()


def _bucket(n: int) -> int:
    for b in BUCKETS:
        if n <= b:
            return b
    return ((n + BUCKETS[-1] - 1) // BUCKETS[-1]) * BUCKETS[-1]


class Ed25519PubKey(PubKey):
    __slots__ = ("_b",)

    def __init__(self, b: bytes):
        if len(b) != PUB_KEY_SIZE:
            raise ValueError(f"ed25519 pubkey must be {PUB_KEY_SIZE} bytes")
        self._b = bytes(b)

    def address(self) -> bytes:
        return tmhash20(self._b)

    def bytes(self) -> bytes:
        return self._b

    def verify_signature(self, msg: bytes, sig: bytes) -> bool:
        return ref.verify(self._b, msg, sig)

    def type_tag(self) -> str:
        return KEY_TYPE

    def __repr__(self):
        return f"Ed25519PubKey({self._b.hex()[:16]}…)"


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is false"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


class Ed25519BatchVerifier(BatchVerifier):
    """Batch verifier on `device` ("cuda" by default; "cpu" runs the
    kernels' plain PyTorch versions)."""

    def __init__(self, device="cuda"):
        self.device = _resolve_device(device)
        self._precheck_fail: list[bool] = []
        # wire blobs accumulate at add() time (one memcpy per add instead
        # of a join sweep at submit)
        self._pub_buf = bytearray()
        self._sig_buf = bytearray()
        self._msg_buf = bytearray()
        self._msg_lens: list[int] = []

    def add_batch(self, pub_rows, sig_rows, msg_blob, msg_lens) -> None:
        """Vectorized add() for a whole commit's worth of ed25519 lanes.

        pub_rows (n,32) u8, sig_rows (n,64) u8, msg_blob bytes, msg_lens
        int array; every row is a structurally-complete 64-byte signature.
        The S < L precheck runs vectorized; failing lanes get a zeroed
        signature and precheck_fail=True, matching add() exactly."""
        n = len(msg_lens)
        if n == 0:
            return
        # S >= L precheck, lexicographic on the big-endian view
        s_be = sig_rows[:, 63:31:-1]  # (n, 32) most-significant first
        neq = s_be != _L_BE[None, :]
        first = neq.argmax(axis=1)
        rows = np.arange(n)
        bad = ~(neq.any(axis=1) & (s_be[rows, first] < _L_BE[first]))  # S >= L
        if bad.any():
            sig_rows = sig_rows.copy()
            sig_rows[bad] = 0
        self._precheck_fail.extend(bad.tolist())
        self._pub_buf += pub_rows.tobytes()
        self._sig_buf += sig_rows.tobytes()
        self._msg_buf += msg_blob
        self._msg_lens.extend(int(x) for x in msg_lens)

    def add(self, pub_key: PubKey, msg: bytes, sig: bytes) -> bool:
        if pub_key.type_tag() != KEY_TYPE:
            return False
        ok = len(sig) == SIG_SIZE
        if ok:
            ok = int.from_bytes(sig[32:], "little") < _L  # ZIP-215: reject S >= L
        pub = pub_key.bytes()
        sig_eff = sig if ok else b"\x00" * 64
        self._precheck_fail.append(not ok)
        self._pub_buf += pub
        self._sig_buf += sig_eff
        self._msg_buf += msg
        self._msg_lens.append(len(msg))
        return ok

    def count(self) -> int:
        return len(self._precheck_fail)

    def verify(self) -> tuple[bool, list[bool]]:
        if not self.count():
            return False, []
        return self.submit().result()

    def submit(self) -> "PendingBatch | DonePending":
        """Launch device verification without blocking on the result.

        A pipeline that submits several batches and collects them together
        (collect_pending) overlaps host packing with device work and pays
        one device->host round trip for all of them."""
        n = self.count()
        if n == 0:
            return DonePending(True, [])
        bits, all_ok = self._launch_device()
        # snapshot: the verifier may be reused after submit()
        return PendingBatch(bits, all_ok, n, list(self._precheck_fail))

    def _host_buffer(self, shape) -> tuple[torch.Tensor, np.ndarray]:
        """A zeroed uint8 host tensor (pinned when the target is a GPU) and
        its numpy view, for packing in place."""
        t = torch.zeros(shape, dtype=torch.uint8, pin_memory=self.device.type == "cuda")
        return t, t.numpy()

    def _pack_rsk(self, n: int, b: int) -> torch.Tensor:
        """(b, 96) R||S||k rows, k = SHA-512(R||A||M) mod L hashed here."""
        rsk, view = self._host_buffer((b, 96))
        sig = memoryview(self._sig_buf)
        pub = memoryview(self._pub_buf)
        msg = memoryview(self._msg_buf)
        view[:n, :64] = np.frombuffer(sig, np.uint8).reshape(n, 64)
        ks = bytearray(32 * n)
        sha = hashlib.sha512
        off = 0
        for i, ln in enumerate(self._msg_lens):
            h = sha(sig[64 * i : 64 * i + 32])
            h.update(pub[32 * i : 32 * i + 32])
            h.update(msg[off : off + ln])
            off += ln
            k = int.from_bytes(h.digest(), "little") % _L
            ks[32 * i : 32 * i + 32] = k.to_bytes(32, "little")
        view[:n, 64:] = np.frombuffer(ks, np.uint8).reshape(n, 32)
        return rsk

    def _pubkeys_on_device(self, n: int, b: int):
        """Cached (ok_a, neg_a) for this verifier's pubkey column."""
        fp = (hashlib.sha256(self._pub_buf).digest(), b, str(self.device))
        with _A_LOCK:
            cached = _A_CACHE.get(fp)
        if cached is None:
            a_host, view = self._host_buffer((b, 32))
            view[:n] = np.frombuffer(self._pub_buf, np.uint8).reshape(n, 32)
            cached = decompress_pubkeys(a_host.to(self.device, non_blocking=True))
            with _A_LOCK:
                _A_CACHE[fp] = cached
                while len(_A_CACHE) > _A_CACHE_SIZE:
                    _A_CACHE.pop(next(iter(_A_CACHE)))
        return cached

    def _launch_device(self):
        """Pack and hash on the host, copy R||S||k over, launch the kernels;
        returns the un-fetched (bits, all_ok) device tensors."""
        n = self.count()
        b = _bucket(n)
        rsk = self._pack_rsk(n, b).to(self.device, non_blocking=True)
        ok_a, neg_a = self._pubkeys_on_device(n, b)
        live = torch.arange(b, device=self.device) < n
        return verify_batch_cached_a(ok_a, neg_a, rsk, live)


class PendingBatch:
    """Handle to an in-flight device batch; result() fetches and finalizes.

    Holds a snapshot of the per-batch host state, so the originating
    verifier can be reused after submit(). The happy path fetches only the
    device-reduced all-ok scalar; the bitmap transfers only when some lane
    failed."""

    __slots__ = ("_dev", "_all_ok", "_n", "_precheck_fail")

    def __init__(self, dev, all_ok, n, precheck_fail):
        self._dev = dev
        self._all_ok = all_ok
        self._n = n
        self._precheck_fail = precheck_fail

    def _finalize_fast(self, dev_all_ok: bool) -> tuple[bool, list[bool]]:
        if dev_all_ok and not any(self._precheck_fail):
            return True, [True] * self._n
        bits = self._dev[: self._n].cpu().tolist()
        out = [bool(x) and not bad for x, bad in zip(bits, self._precheck_fail)]
        return all(out), out

    def result(self) -> tuple[bool, list[bool]]:
        return self._finalize_fast(bool(self._all_ok.item()))


class DonePending:
    """Already-resolved batch behind the pending API."""

    __slots__ = ("_ok", "_bits", "_all_ok")

    def __init__(self, ok, bits):
        self._ok = ok
        self._bits = bits
        self._all_ok = torch.tensor(ok)  # collect_pending stacks this

    def _finalize_fast(self, _dev_all_ok) -> tuple[bool, list[bool]]:
        return self._ok, self._bits

    def result(self) -> tuple[bool, list[bool]]:
        return self._ok, self._bits


def collect_pending(pendings) -> list[tuple[bool, list[bool]]]:
    """Resolve many in-flight batches with one device->host copy per device.

    Stacks the per-batch all-ok scalars on their device and fetches them
    together; only batches whose summary reports a failure pay the bitmap
    transfer."""
    if not pendings:
        return []
    groups: dict[torch.device, list[int]] = {}
    for i, p in enumerate(pendings):
        groups.setdefault(p._all_ok.device, []).append(i)
    summaries = [False] * len(pendings)
    for idx in groups.values():
        vals = torch.stack([pendings[i]._all_ok for i in idx]).cpu().tolist()
        for i, v in zip(idx, vals):
            summaries[i] = bool(v)
    return [p._finalize_fast(s) for p, s in zip(pendings, summaries)]


def batch_verifier(device="cuda") -> Ed25519BatchVerifier:
    return Ed25519BatchVerifier(device=device)
