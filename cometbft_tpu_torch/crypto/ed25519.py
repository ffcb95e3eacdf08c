"""Ed25519 public keys and the GPU batch verifier.

Twin of the commit-verify subset of `cometbft_tpu/crypto/ed25519.py`.
`Ed25519BatchVerifier.submit()` has two routes. The prehashed per-lane
ladder is the default:

- the host packs (b, 96) R||S||k rows, with k = SHA-512(R||A||M) mod L
  hashed by hashlib, straight into a pinned buffer, and copies it to the
  device with `non_blocking=True`;
- the pubkey column is decompressed once per validator set and kept on
  the device, keyed by (sha256(pubkey blob), bucket, device);
- `ops.ed25519_verify.verify_batch_cached_a` runs the decompress and
  ladder kernels and leaves (bitmap, all-ok) on the device;
- `PendingBatch` / `collect_pending` fetch one all-ok scalar per batch,
  and the bitmap only when that scalar says some lane failed.

The RLC/MSM route (`_launch_rlc`) verifies the whole batch as one
multi-scalar multiplication (`ops.msm`): the host lays out the digit
stream (`crypto.rlc.prepare`), one pinned buffer crosses to the device,
and one all-ok scalar comes back (`PendingRLC`); when it is false, the
batch reruns on the ladder route to find the failing lanes. `submit()`
takes it for n >= RLC_MIN when `_rlc_beats_ladder(n, bucket)` says so,
which it does not until the dispatch is calibrated on the GPU; tests and
`chip_smoke.py` pin that seam.

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
from ..ops.msm import rlc_verify_stream
from . import ed25519_ref as ref
from . import rlc as _rlc
from .keys import BatchVerifier, PubKey, tmhash20

KEY_TYPE = "tendermint/PubKeyEd25519"
PUB_KEY_SIZE = 32
SIG_SIZE = 64

# Padded batch buckets (the reference's): 10240 exists for the
# 10k-validator commit, which 16384 would pad by 38%.
BUCKETS = (64, 256, 1024, 4096, 10240, 16384, 65536)

# At and above this size the RLC/MSM route is considered instead of the
# per-lane ladder (the reference's threshold).
RLC_MIN = 4096

_L = ref.L
# big-endian bytes of the group order, for the vectorized S < L precheck
_L_BE = np.frombuffer(_L.to_bytes(32, "big"), np.uint8)

# (sha256(pubkey column), bucket, device) -> device-resident (ok_a, neg_a)
# from ops.ed25519_verify.decompress_pubkeys; shared by every verifier in
# the process, since consumers build a fresh verifier per commit.
_A_CACHE: dict = {}
_A_CACHE_SIZE = 4
_A_LOCK = threading.Lock()


def _rlc_beats_ladder(n: int, b: int) -> bool:
    """Whether the RLC/MSM route should take an n-lane batch in bucket b.
    False until the dispatch between the two routes is calibrated on the
    GPU: the reference's terms were measured on a TPU."""
    return False


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

    def __init__(self, device="cuda", force_perlane: bool = False):
        self.device = _resolve_device(device)
        # pins the per-lane ladder route (the RLC route's blame rerun)
        self._force_perlane = force_perlane
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

    def absorb(self, other: "Ed25519BatchVerifier") -> tuple[int, int]:
        """Append every queued lane of `other` onto this verifier, keeping
        order and precheck verdicts; returns the half-open lane range
        [start, end) the absorbed lanes occupy here. `other` is left as
        it was."""
        start = self.count()
        self._precheck_fail.extend(other._precheck_fail)
        self._pub_buf += other._pub_buf
        self._sig_buf += other._sig_buf
        self._msg_buf += other._msg_buf
        self._msg_lens.extend(other._msg_lens)
        return start, self.count()

    def _items(self) -> list[tuple[bytes, bytes, bytes]]:
        """The queued lanes as (pub, msg, sig) tuples (a precheck failure
        carries its zeroed signature)."""
        out = []
        off = 0
        for i, ln in enumerate(self._msg_lens):
            out.append((bytes(self._pub_buf[32 * i : 32 * i + 32]),
                        bytes(self._msg_buf[off : off + ln]),
                        bytes(self._sig_buf[64 * i : 64 * i + 64])))
            off += ln
        return out

    def verify(self) -> tuple[bool, list[bool]]:
        if not self.count():
            return False, []
        return self.submit().result()

    def submit(self) -> "PendingBatch | PendingRLC | DonePending":
        """Launch device verification without blocking on the result.

        A pipeline that submits several batches and collects them together
        (collect_pending) overlaps host packing with device work and pays
        one device->host round trip for all of them."""
        n = self.count()
        if n == 0:
            return DonePending(True, [])
        if not self._force_perlane and n >= RLC_MIN and _rlc_beats_ladder(n, _bucket(n)):
            pending = self._launch_rlc()
            if pending is not None:
                return pending
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

    def _pack_rlc(self, z16=None):
        """Host half of the RLC route: the digit layout (`rlc.prepare`) and
        every array the device needs, packed into one zeroed (pinned, for
        a GPU) uint8 buffer. Returns (buffer, fields, s_pad), or None when
        the layout declines the batch. z16 pins the coefficients (tests)."""
        n = self.count()
        b = _bucket(n)
        skip = np.asarray(self._precheck_fail, bool)
        prep = _rlc.prepare(self._items(), skip, b, z16)
        if prep is None:
            return None
        # pad the round count to a power of two (min 8), the reference's
        # tiering, so both packages run the same S
        s_pad = 8
        while s_pad < prep["s_rounds"]:
            s_pad *= 2
        a = np.zeros((b, 32), np.uint8)
        a[:n] = np.frombuffer(self._pub_buf, np.uint8).reshape(n, 32)
        r = np.zeros((b, 32), np.uint8)
        r[:n] = np.frombuffer(self._sig_buf, np.uint8).reshape(n, 64)[:, :32]
        live = np.zeros(b, np.uint8)
        live[:n] = ~skip
        arrays = {"a": a, "r": r, "live": live,
                  **{k: prep[k] for k in ("stream", "stream_neg", "counts", "weights",
                                          "c_digits")}}
        fields, off = {}, 0
        for k, arr in arrays.items():
            fields[k] = (off, arr.dtype, arr.shape)
            off += -(-arr.nbytes // 4) * 4  # 4-byte aligned, for the int32 views
        buf, view = self._host_buffer((off,))
        for k, arr in arrays.items():
            o = fields[k][0]
            view[o : o + arr.nbytes] = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
        return buf, fields, s_pad

    def _launch_rlc(self):
        """RLC/MSM route: one multi-scalar multiplication for the whole
        batch. Returns None when the host layout declines (bucket slot
        overflow, or no live lane) so the ladder route takes over."""
        packed = self._pack_rlc()
        if packed is None:
            return None
        buf, fields, s_pad = packed
        ok = verify_rlc_packed(buf.to(self.device, non_blocking=True), fields, s_pad)
        # snapshot for the blame rerun: the verifier may be reused after submit()
        snap = Ed25519BatchVerifier(self.device, force_perlane=True)
        snap.absorb(self)
        return PendingRLC(ok, list(self._precheck_fail), snap)


# numpy dtype of a packed field -> the torch dtype its bytes are viewed as.
# Stream indices are viewed signed (torch's unsigned 16- and 32-bit types
# have few operators); that is exact, since the layout keeps uint16
# indices <= 0x7FFF and uint32 indices far below 2^31.
_TORCH_DTYPES = {np.dtype(np.uint8): torch.uint8, np.dtype(np.uint16): torch.int16,
                 np.dtype(np.uint32): torch.int32, np.dtype(np.int32): torch.int32}


def unpack_rlc(buf: torch.Tensor, fields: dict) -> dict:
    """Views of the fields of a buffer packed by `_pack_rlc`, on its device."""
    out = {}
    for k, (off, dt, shape) in fields.items():
        nbytes = int(np.prod(shape)) * dt.itemsize
        out[k] = buf[off : off + nbytes].view(_TORCH_DTYPES[dt]).reshape(shape)
    return out


def verify_rlc_packed(buf: torch.Tensor, fields: dict, s_pad: int) -> torch.Tensor:
    """The device half of the RLC route on a buffer from `_pack_rlc`
    (already on the device). Returns the all-ok scalar, on the device."""
    t = unpack_rlc(buf, fields)
    return rlc_verify_stream(
        t["a"], t["r"], t["live"] != 0, t["stream"], t["stream_neg"], t["counts"],
        t["weights"], t["c_digits"], s_rounds=s_pad)


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


class PendingRLC:
    """In-flight RLC/MSM batch: a single device bool. When it is true,
    every live lane verified (random-linear-combination soundness); when
    false, the batch reruns on the per-lane ladder route to assign blame,
    as the reference falls back from batch to single verification
    (types/validation.go:304-311)."""

    __slots__ = ("_all_ok", "_precheck_fail", "_lanes")

    def __init__(self, all_ok, precheck_fail, lanes: Ed25519BatchVerifier):
        self._all_ok = all_ok
        self._precheck_fail = precheck_fail
        self._lanes = lanes  # force_perlane verifier holding the batch

    def _finalize_fast(self, dev_all_ok: bool) -> tuple[bool, list[bool]]:
        if dev_all_ok:
            bits = [not bad for bad in self._precheck_fail]
            return all(bits), bits
        return self._lanes.submit().result()

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
