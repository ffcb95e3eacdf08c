"""Ed25519 keys and the GPU batch verifier.

Twin of the commit-verify subset of `cometbft_tpu/crypto/ed25519.py`.
`Ed25519BatchVerifier.submit()` has three routes. A batch of fewer than
NATIVE_MAX lanes is verified at once on the host by the native C++
engine (`_native_batch`, `crypto/native.py`): one random-linear-
combination check, then one verify per lane when it fails. Larger
batches go to the device, where the prehashed per-lane ladder is the
default:

- the host packs (b, 96) R||S||k rows, with k = SHA-512(R||A||M) mod L
  hashed by the native packer (hashlib when the host library is absent),
  straight into a pinned buffer, and copies it to the device with
  `non_blocking=True`;
- the pubkey column is decompressed once per validator set and kept on
  the device, keyed by (sha256(pubkey blob), bucket, device);
- `ops.ed25519_verify.verify_batch_cached_a` runs the decompress and
  ladder kernels and leaves (bitmap, all-ok) on the device;
- `PendingBatch` / `collect_pending` fetch one all-ok scalar per batch,
  and the bitmap only when that scalar says some lane failed; a
  handle's `prefetch()` starts that scalar's copy into pinned host memory
  early, and its `result()` waits on the copy's event.

Two more device routes hash on the device, through the `sha512_reduce`
kernel, SHA-512 and the reduction mod L in one launch
(`ops.ed25519_verify.verify_batch` and `verify_batch_delta`):

- `device_sha=True` (`_launch_device_sha`): a, r, s, the SHA-512-padded
  R||A||M words, the two-block flags and the live mask cross in one
  pinned buffer (~362 B a lane). A lane whose R||A||M exceeds two blocks
  goes out with live=False and is verified on the host at result()
  (`PendingBatch`'s oversize lanes);
- the structured wire, `delta` (`_launch_device_delta`): when the
  batch's messages share a prefix and a suffix (commit sign bytes differ
  per lane only in the vote timestamp; `_detect_delta`), R||S plus the
  per-lane middle bytes cross (~75 B a lane) and the device rebuilds
  and hashes the messages; the pubkey encodings stay on the device with
  the decompressed points. The ladder route takes it for DELTA_MIN <= n
  and buckets up to DELTA_MAX_BUCKET when `_delta_beats_prehashed(n,
  bucket, device)` says so (the calibrated model on a GPU, never on the
  CPU).

The RLC/MSM route (`_launch_rlc`) verifies the whole batch as one
multi-scalar multiplication (`ops.msm`): the host lays out the digit
stream (`crypto.rlc.prepare`), one pinned buffer crosses to the device,
and one all-ok scalar comes back (`PendingRLC`); when it is false, the
batch reruns on the ladder route to find the failing lanes. `submit()`
takes it for n >= RLC_MIN when `_rlc_beats_ladder(n, bucket, device)`
says so: on a GPU it compares the two routes' modeled times
(`dispatch_model`), whose host terms are timed on this host and whose
device terms are timed on the card at the first decision for a bucket;
on the CPU (the kernels' plain versions) it keeps the ladder. Tests and
`chip_smoke.py` pin that seam, and `NATIVE_MAX = 0` sends every batch to
the device routes.

With a verify mesh up (`parallel/mesh.py`: more than one GPU, or an
engine installed through `parallel.mesh.set_engine`), two more things
happen. A batch of n >= MESH_MIN goes to `_launch_mesh` when
`_mesh_beats_single(n, bucket, device)` says so: the ladder route's rows,
padded to a multiple of the device count and sharded over it (path
"mesh"). And every batch the ladder route takes lands on the engine's
next device round robin (streamed placement, a `crypto.stream_place`
event). The model's mesh term is the ladder's host stage, its wire plus
the mesh's calibrated per-shard staging, and the bucket's calibrated
ladder device time over d plus the calibrated cross-device sum; on the
CPU the mesh is never picked.

Devices are keyed by index (`ops.field.device_key`): "cuda" and
"cuda:0" name one card in the pubkey cache and the calibration tables.

Each dispatch feeds `utils.metrics.crypto_metrics()` and, when tracing
is on, one `crypto.batch_verify` span with the route and the model's
terms (`_record_dispatch`).

Behavior parity: reference crypto/ed25519/ed25519.go (verify :180-187
with ZIP-215 options :36-41, batch :207-240). A verifier made for
"cuda" on a host without a GPU raises; nothing falls back to the CPU.
"""

from __future__ import annotations

import hashlib
import threading
import time

import numpy as np
import torch

from ..ops import sha512 as _sha
from ..ops.field import device_key
from ..ops.ed25519_verify import (
    DELTA_META_HEADER,
    DELTA_META_LEN,
    DELTA_PMAX,
    decompress_pubkeys,
    verify_batch,
    verify_batch_cached_a,
    verify_batch_delta,
    verify_batch_prehashed,
)
from ..ops.msm import rlc_verify_stream
from ..parallel import mesh as _mesh
from ..utils import trace as _trace
from ..utils.metrics import crypto_metrics
from . import ed25519_ref as ref
from . import native
from . import rlc as _rlc
from .keys import BatchVerifier, PrivKey, PubKey, tmhash20

KEY_TYPE = "tendermint/PubKeyEd25519"
PUB_KEY_SIZE = 32
PRIV_KEY_SIZE = 64
SIG_SIZE = 64

# Padded batch buckets (the reference's): 10240 exists for the
# 10k-validator commit, which 16384 would pad by 38%.
BUCKETS = (64, 256, 1024, 4096, 10240, 16384, 65536)

# At and above this size the RLC/MSM route is considered instead of the
# per-lane ladder (the reference's threshold).
RLC_MIN = 4096

# Below this size the native C++ engine verifies the batch on the host, as
# the reference does with an accelerator present: a commit-sized batch
# finishes there sooner than a device round trip. 0 disables the native
# route (the seam that forces the device routes).
NATIVE_MAX = 1024

# At and above this size the sharded mesh is considered (the reference's
# threshold): below it the d per-shard transfers eat the device-time split.
MESH_MIN = 4096

# The structured-wire (delta) route is considered for DELTA_MIN <= n and
# buckets up to DELTA_MAX_BUCKET (the reference's bounds, so that the same
# batches are eligible).
DELTA_MIN = 256
DELTA_MAX_BUCKET = 16384

_L = ref.L
# big-endian bytes of the group order, for the vectorized S < L precheck
_L_BE = np.frombuffer(_L.to_bytes(32, "big"), np.uint8)

# (sha256(pubkey column), bucket, device) -> device-resident (ok_a, neg_a)
# from ops.ed25519_verify.decompress_pubkeys; the delta route's entries,
# keyed (sha256, bucket, "delta", device), also hold the encodings. Shared
# by every verifier in the process, since consumers build a fresh verifier
# per commit.
_A_CACHE: dict = {}
_A_CACHE_SIZE = 4
_A_LOCK = threading.Lock()


# ---------------------------------------------------------------- dispatch

# Wire bytes a lane of the ladder route (R||S||k; the pubkeys cross once
# per validator set). The RLC and delta routes' bytes are those of their
# packed buffers at the bucket, read when the bucket's terms are timed.
_WIRE_LADDER_B = 96

_LINK_MBPS: dict[str, float] = {}  # str(device) -> MB/s
_TERMS: dict[tuple[int, str], dict] = {}  # (bucket, str(device)) -> calibrated terms


def _link_mbps(dev: torch.device) -> float:
    """Host-to-device rate, from one warm pinned 2 MiB copy timed with
    CUDA events; measured once per device."""
    key = str(dev)
    if key not in _LINK_MBPS:
        src = torch.zeros(2 << 20, dtype=torch.uint8, pin_memory=True)
        dst = torch.empty_like(src, device=dev)
        dst.copy_(src, non_blocking=True)  # warm the path
        torch.cuda.synchronize(dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        dst.copy_(src, non_blocking=True)
        end.record()
        end.synchronize()
        _LINK_MBPS[key] = src.numel() / 1e6 / max(start.elapsed_time(end) / 1e3, 1e-9)
    return _LINK_MBPS[key]


def _best_s(fn, reps: int = 2) -> tuple[float, object]:
    """(fastest wall seconds of `reps` calls of fn(), its last result)."""
    best, out = float("inf"), None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        best = min(best, time.perf_counter() - t0)
    return best, out


def _timed_launch(fn, dev: torch.device) -> tuple[float, float]:
    """(host seconds to issue fn's launches, device seconds from CUDA
    events around them) of one warm call of fn()."""
    fn()
    torch.cuda.synchronize(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    fn()
    issue = time.perf_counter() - t0
    end.record()
    end.synchronize()
    return issue, start.elapsed_time(end) / 1e3


def _calibrate(b: int, dev: torch.device) -> dict:
    """The device routes' stages, timed on a throwaway batch of b random
    lanes (vote-shaped 100-byte messages: a shared 76-byte prefix and
    16-byte suffix around 8 bytes a lane, as `crypto.testgen` makes them;
    S < 2^252 so that no lane fails the precheck; the halves take the same
    time whether or not a signature verifies):

    - host: the verifier's own pack of each route (`_pack_rsk`,
      `_pack_rlc`, and `_detect_delta` with `_pack_delta`), best of two,
      per lane. The reference times its packers at 1,024 lanes once per
      process; at 1,024 the native RLC packer's fixed costs overstated its
      cost a lane at 10,000 by 1.6-2.3x on the H100's host, so the port
      times them at the bucket;
    - issue and device: one warm call of each route's device half, the
      host time its launches take to issue and its CUDA-event time;
    - the RLC and delta routes' packed-buffer bytes.
    """
    rng = np.random.default_rng(b)
    sigs = rng.integers(0, 256, (b, 64), dtype=np.uint8)
    sigs[:, 63] &= 0x0F
    msgs = np.concatenate([np.broadcast_to(rng.integers(0, 256, 76, dtype=np.uint8), (b, 76)),
                           rng.integers(0, 256, (b, 8), dtype=np.uint8),
                           np.broadcast_to(rng.integers(0, 256, 16, dtype=np.uint8), (b, 16))],
                          axis=1)
    bv = Ed25519BatchVerifier(dev, force_perlane=True)
    bv.add_batch(rng.integers(0, 256, (b, 32), dtype=np.uint8), sigs, msgs.tobytes(),
                 np.full(b, 100))
    pack_s, rsk_host = _best_s(lambda: bv._pack_rsk(b, b))
    rsk = rsk_host.to(dev, non_blocking=True)
    ok_a, neg_a, a_enc = bv._decompress_pubkeys(b, b, with_encodings=True)
    live = torch.ones(b, dtype=torch.bool, device=dev)
    ladder_issue, ladder_s = _timed_launch(
        lambda: verify_batch_cached_a(ok_a, neg_a, rsk, live), dev)
    terms = {"ladder_us": pack_s / b * 1e6, "ladder_issue_s": ladder_issue, "ladder_s": ladder_s,
             "rlc_us": float("inf"), "rlc_issue_s": 0.0, "rlc_s": float("inf"), "rlc_wire_b": 0,
             "rlc_native": native.rlc_available(), "rlc_threads": native.rlc_packer_threads()}
    pack_s, (buf_host, fields) = _best_s(
        lambda: bv._pack_delta(_detect_delta(bv._msg_buf, bv._msg_lens)))
    t = unpack_fields(buf_host.to(dev, non_blocking=True), fields)
    terms["delta_issue_s"], terms["delta_s"] = _timed_launch(
        lambda: verify_batch_delta(ok_a, neg_a, a_enc, t["packed"], t["meta"]), dev)
    terms.update(delta_us=pack_s / b * 1e6, delta_wire_b=buf_host.numel())
    for _ in range(5):  # the layout draws z afresh and may decline
        pack_s, packed = _best_s(bv._pack_rlc)
        if packed is not None:
            buf_host, fields, s_pad = packed
            buf = buf_host.to(dev, non_blocking=True)
            terms["rlc_issue_s"], terms["rlc_s"] = _timed_launch(
                lambda: verify_rlc_packed(buf, fields, s_pad), dev)
            terms.update(rlc_us=pack_s / b * 1e6, rlc_wire_b=buf_host.numel())
            break
    return terms


def _terms(b: int, dev: torch.device) -> dict:
    """The calibrated terms of bucket b on `dev`, timed at the first
    decision for that bucket."""
    key = (b, str(dev))
    if key not in _TERMS:
        _TERMS[key] = _calibrate(b, dev)
        cm = crypto_metrics()
        for term in ("ladder_us", "rlc_us", "delta_us"):
            cm.calibration_us_per_sig.set(_TERMS[key][term], term)
    return _TERMS[key]


def _shard_terms(k: int, dev: torch.device) -> dict:
    """A mesh shard's stages at k lanes, timed at the first decision for k:
    one warm `verify_batch_prehashed` (what each shard runs, A and R
    decompressed in it) on throwaway lanes, its issue and device seconds."""
    key = (k, str(dev), "shard")
    if key not in _TERMS:
        x = np.random.default_rng(k).integers(0, 256, (k, 128), dtype=np.uint8)
        x[:, 95] &= 0x0F  # S and k under 2^252, as `_calibrate` draws S
        x[:, 127] &= 0x0F
        t = torch.from_numpy(x).to(dev)
        live = torch.ones(k, dtype=torch.bool, device=dev)
        issue, dev_s = _timed_launch(lambda: verify_batch_prehashed(
            t[:, :32], t[:, 32:64], t[:, 64:96], t[:, 96:], live), dev)
        _TERMS[key] = {"issue_s": issue, "device_s": dev_s}
    return _TERMS[key]


def dispatch_model(n: int, b: int, device="cuda") -> dict:
    """The modeled stage times (seconds) of an n-lane batch in bucket b on
    each device route of a CUDA `device`. A route's pipelined time is that
    of its slowest stage: host (its pack, per lane, then issuing its
    launches: the same thread does both), wire (bytes over the probed
    link) or device (the bucket's event-timed device half). The delta
    route's wire is its packed buffer at the calibration batch's middle
    width (8 bytes a lane, as vote sign bytes have it).

    With a calibrated mesh of more than one device (`_mesh_engine`), the
    sharded route's term is added, from a shard's own stages at b/d lanes
    (`_shard_terms`): host, the ladder's pack of n lanes and d issues of a
    shard's launches (one thread issues every shard); wire, the ladder's
    plus d per-shard stagings at the mesh's calibrated fixed cost; device,
    a shard's time plus the calibrated cross-device sum, d times a shard's
    time where the shards are logical shards of fewer cards (they run one
    after another)."""
    dev = device_key(device)
    bw = _link_mbps(dev) * 1e6
    t = _terms(b, dev)
    routes = {"ladder": {"wire": _WIRE_LADDER_B * b / bw, "device": t["ladder_s"],
                         "host": n * t["ladder_us"] * 1e-6 + t["ladder_issue_s"]}}
    for r in ("rlc", "delta"):
        routes[r] = {"wire": t[f"{r}_wire_b"] / bw, "device": t[f"{r}_s"],
                     "host": n * t[f"{r}_us"] * 1e-6 + t[f"{r}_issue_s"]}
    extra = {}
    eng = _mesh_engine()
    if eng is not None and eng.n_devices > 1 and eng.on_gpu:
        mt = eng.dispatch_terms()
        if mt["calibrated"]:
            d = eng.n_devices
            ts = _shard_terms(b // d, dev)
            serial = d // len(set(eng.devices))
            routes["mesh"] = {"wire": routes["ladder"]["wire"] + d * mt["put_fixed_s"],
                              "device": serial * ts["device_s"] + mt["collective_s"],
                              "host": n * t["ladder_us"] * 1e-6 + d * ts["issue_s"]}
            extra["n_devices"] = d
    return {"link_mbps": _LINK_MBPS[str(dev)], "terms": t, **routes, **extra,
            **{f"t_{r}": max(st.values()) for r, st in routes.items()}}


def _rlc_beats_ladder(n: int, b: int, device) -> bool:
    """Whether the RLC/MSM route should take an n-lane batch in bucket b:
    by the calibrated model on a GPU; never on the CPU, whose plain
    versions are no device to calibrate."""
    if torch.device(device).type != "cuda":
        return False
    m = dispatch_model(n, b, device)
    return m["t_rlc"] < m["t_ladder"]


def _mesh_beats_single(n: int, b: int, device) -> bool:
    """Whether the sharded mesh should take an n-lane batch in bucket b: its
    modeled time against the best single-device route (the ladder, or RLC
    from RLC_MIN) of the same calibrated model; never on the CPU."""
    if torch.device(device).type != "cuda":
        return False
    m = dispatch_model(n, b, device)
    if "t_mesh" not in m:
        return False
    best = m["t_ladder"] if n < RLC_MIN else min(m["t_ladder"], m["t_rlc"])
    return m["t_mesh"] < best


def _delta_beats_prehashed(n: int, b: int, device) -> bool:
    """Whether the structured-wire (delta) route should take an n-lane
    batch in bucket b instead of the prehashed ladder: by the calibrated
    model on a GPU; never on the CPU."""
    if torch.device(device).type != "cuda":
        return False
    m = dispatch_model(n, b, device)
    return m["t_delta"] < m["t_ladder"]


def _mesh_engine():
    """The process's verify mesh (`parallel.mesh.get_engine`, which owns the
    policy), or None when it is off."""
    return _mesh.get_engine()


def _pack_rsk_rows(n: int, sig_blob, pub_blob, msg_blob, msg_lens, out: np.ndarray) -> None:
    """R||S||k rows (k = SHA-512(R||A||M) mod L) into out[:n], a
    C-contiguous (>= n, 96) uint8 array; msg_lens a uint64 array. The
    native packer when the host library is built, hashlib otherwise."""
    if native.pack_rsk(n, sig_blob, pub_blob, msg_blob, msg_lens, out):
        return
    sig = memoryview(sig_blob)
    pub = memoryview(pub_blob)
    msg = memoryview(msg_blob)
    out[:n, :64] = np.frombuffer(sig, np.uint8, 64 * n).reshape(n, 64)
    ks = bytearray(32 * n)
    sha = hashlib.sha512
    off = 0
    for i, ln in enumerate(msg_lens.tolist()):
        h = sha(sig[64 * i : 64 * i + 32])
        h.update(pub[32 * i : 32 * i + 32])
        h.update(msg[off : off + ln])
        off += ln
        k = int.from_bytes(h.digest(), "little") % _L
        ks[32 * i : 32 * i + 32] = k.to_bytes(32, "little")
    out[:n, 64:] = np.frombuffer(ks, np.uint8).reshape(n, 32)


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
        """One gossiped vote's signature: the native engine, or the
        pure-Python `ed25519_ref` when the host library is absent."""
        crypto_metrics().path_selected_total.inc(1.0, "single", "ed25519")
        if native.available():
            return native.verify(self._b, msg, sig)
        return ref.verify(self._b, msg, sig)

    def type_tag(self) -> str:
        return KEY_TYPE

    def __repr__(self):
        return f"Ed25519PubKey({self._b.hex()[:16]}…)"


class Ed25519PrivKey(PrivKey):
    """A validator's signing key. Signing and the public key go through the
    native engine, which is required: there is no Python fallback."""

    __slots__ = ("_seed", "_pub")

    def __init__(self, key_bytes: bytes):
        if len(key_bytes) == 32:
            self._seed = bytes(key_bytes)
            self._pub = native.pubkey(self._seed)
        elif len(key_bytes) == PRIV_KEY_SIZE:
            self._seed = bytes(key_bytes[:32])
            self._pub = bytes(key_bytes[32:])
        else:
            raise ValueError("ed25519 privkey must be 32 (seed) or 64 bytes")

    @classmethod
    def generate(cls) -> "Ed25519PrivKey":
        return cls(ref.generate_seed())

    def sign(self, msg: bytes) -> bytes:
        return native.sign(self._seed, self._pub, msg)

    def pub_key(self) -> Ed25519PubKey:
        return Ed25519PubKey(self._pub)

    def bytes(self) -> bytes:
        return self._seed + self._pub

    def type_tag(self) -> str:
        return KEY_TYPE


def _resolve_device(device) -> torch.device:
    """`device` checked and keyed (`ops.field.device_key`: "cuda" becomes
    the current card's index, so caches see one card)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is false"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return device_key(dev)


class Ed25519BatchVerifier(BatchVerifier):
    """Batch verifier on `device` ("cuda" by default; "cpu" runs the
    kernels' plain PyTorch versions). `device_sha=True` sends every device
    batch to the device-SHA route."""

    def __init__(self, device="cuda", force_perlane: bool = False, device_sha: bool = False):
        self.device = _resolve_device(device)
        # pins the per-lane ladder route (the RLC route's blame rerun)
        self._force_perlane = force_perlane
        self._device_sha = device_sha
        self._delta = None  # memoized _detect_delta of the queued messages
        self._device_path = "ladder"  # the device route the last launch took
        self._oversize: list[int] = []  # lanes of the last launch verified on the host
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
        self._delta = None
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
        self._delta = None
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
        self._delta = None
        self._precheck_fail.extend(other._precheck_fail)
        self._pub_buf += other._pub_buf
        self._sig_buf += other._sig_buf
        self._msg_buf += other._msg_buf
        self._msg_lens.extend(other._msg_lens)
        return start, self.count()

    def _items(self) -> list[tuple[bytes, bytes, bytes]]:
        """The queued lanes as (pub, msg, sig) tuples (a precheck failure
        carries its zeroed signature)."""
        return _rlc.items_of(self._pub_buf, self._sig_buf, self._msg_buf, self._msg_lens)

    def verify(self) -> tuple[bool, list[bool]]:
        if not self.count():
            return False, []
        return self.submit().result()

    def submit(self) -> "PendingBatch | PendingRLC | DonePending":
        """Verify natively (n < NATIVE_MAX), or launch device verification
        without blocking on the result.

        A pipeline that submits several batches and collects them together
        (collect_pending) overlaps host packing with device work and pays
        one device->host round trip for all of them."""
        n = self.count()
        if n == 0:
            return DonePending(True, [])
        t0 = time.perf_counter()
        pending, path = None, "ladder"
        if not self._force_perlane:
            if 0 < NATIVE_MAX and n < NATIVE_MAX:
                pending = self._native_batch()
                if pending is not None:
                    path = "native"
            if pending is None and n >= MESH_MIN:
                eng = _mesh_engine()
                if eng is not None and _mesh_beats_single(n, _bucket(n), self.device):
                    pending, path = self._launch_mesh(eng), "mesh"
            if pending is None and n >= RLC_MIN and _rlc_beats_ladder(n, _bucket(n), self.device):
                pending = self._launch_rlc()
                if pending is not None:
                    path = "rlc"
        if pending is None:
            bits, all_ok = self._launch_device()
            path = self._device_path
            # snapshot: the verifier may be reused after submit()
            items = self._items() if self._oversize else []
            pending = PendingBatch(bits, all_ok, n, list(self._precheck_fail),
                                   [items[i] for i in self._oversize], list(self._oversize))
        self._record_dispatch(path, n, t0, pending)
        return pending

    def _record_dispatch(self, path: str, n: int, t0: float, pending) -> None:
        """The route's counter and the batch size; the pending handle's
        path and start time (its result() records the latency); and, when
        tracing is on, one `crypto.batch_verify` span with the model's
        stage terms of the route taken on a GPU."""
        host_s = time.perf_counter() - t0
        m = crypto_metrics()
        m.batch_size.observe(n)
        m.path_selected_total.inc(1.0, path, "ed25519")
        pending._path = path
        pending._t0 = t0
        if _trace.enabled:
            fields = {"path": path, "n": n}
            mdl = None
            if path in ("ladder", "rlc", "delta", "mesh") and self.device.type == "cuda":
                mdl = dispatch_model(n, _bucket(n), self.device)
            if mdl is not None and path in mdl:
                stages = mdl[path]
                if path == "mesh":
                    fields["n_devices"] = mdl["n_devices"]
                fields.update(model_host_ms=round(stages["host"] * 1e3, 3),
                              model_wire_ms=round(stages["wire"] * 1e3, 3),
                              model_device_ms=round(stages["device"] * 1e3, 3),
                              link_mbps=round(mdl["link_mbps"], 1))
            _trace.emit("crypto.batch_verify", "span", dur_ms=round(host_s * 1e3, 3), **fields)

    def _native_batch(self):
        """The batch on the native C++ engine, resolved now: one
        random-linear-combination check of the live lanes, then, if it
        fails, one verify per lane for the bitmap. None when the host
        library is absent (the device routes take the batch)."""
        if not native.available():
            return None
        items = self._items()
        live = [it for it, bad in zip(items, self._precheck_fail) if not bad]
        if live and native.batch_verify(live):
            bits = [not bad for bad in self._precheck_fail]
        else:
            bits = [not bad and native.verify(*it) for it, bad in zip(items, self._precheck_fail)]
        return DonePending(all(bits), bits)

    def _host_buffer(self, shape) -> tuple[torch.Tensor, np.ndarray]:
        """A zeroed uint8 host tensor (pinned when the target is a GPU) and
        its numpy view, for packing in place."""
        t = torch.zeros(shape, dtype=torch.uint8, pin_memory=self.device.type == "cuda")
        return t, t.numpy()

    def _field_buffer(self, specs: dict) -> tuple[torch.Tensor, dict, dict]:
        """One zeroed (pinned, for a GPU) uint8 buffer laid out for the
        fields {name: (numpy dtype, shape)}, each 16-byte aligned (the SHA
        kernels read rows as 16-byte loads). Returns (buffer, fields for
        `unpack_fields`, {name: numpy view to pack in place})."""
        fields, off = {}, 0
        for k, (dt, shape) in specs.items():
            dt = np.dtype(dt)
            fields[k] = (off, dt, tuple(shape))
            off += -(-int(np.prod(shape)) * dt.itemsize // 16) * 16
        buf, view = self._host_buffer((off,))
        views = {k: view[o : o + int(np.prod(shape)) * dt.itemsize].view(dt).reshape(shape)
                 for k, (o, dt, shape) in fields.items()}
        return buf, fields, views

    def _pack_rsk(self, n: int, b: int) -> torch.Tensor:
        """(b, 96) R||S||k rows, k = SHA-512(R||A||M) mod L hashed here."""
        rsk, view = self._host_buffer((b, 96))
        _pack_rsk_rows(n, self._sig_buf, self._pub_buf, self._msg_buf,
                       np.asarray(self._msg_lens, np.uint64), view)
        return rsk

    def _decompress_pubkeys(self, n: int, b: int, with_encodings: bool = False,
                            dev=None) -> tuple:
        """(ok_a, neg_a), and the (b, 32) encodings on the device when asked,
        of this verifier's pubkey column, padded to b lanes, on `dev` (the
        verifier's device by default)."""
        a_host, view = self._host_buffer((b, 32))
        view[:n] = np.frombuffer(self._pub_buf, np.uint8).reshape(n, 32)
        a_dev = a_host.to(dev or self.device, non_blocking=True)
        ok_a, neg_a = decompress_pubkeys(a_dev)
        return (ok_a, neg_a, a_dev) if with_encodings else (ok_a, neg_a)

    def _pubkeys_on_device(self, n: int, b: int, with_encodings: bool = False,
                           dev=None) -> tuple:
        """`_decompress_pubkeys`, cached per pubkey column, bucket and device
        (and apart for the delta route, whose entries hold the encodings)."""
        dev = dev or self.device
        fp = (hashlib.sha256(self._pub_buf).digest(), b, str(dev))
        if with_encodings:
            fp = fp[:2] + ("delta",) + fp[2:]
        with _A_LOCK:
            cached = _A_CACHE.get(fp)
        if cached is None:
            cached = self._decompress_pubkeys(n, b, with_encodings, dev)
            with _A_LOCK:
                _A_CACHE[fp] = cached
                while len(_A_CACHE) > _A_CACHE_SIZE:
                    _A_CACHE.pop(next(iter(_A_CACHE)))
        return cached

    def _launch_device(self):
        """The per-lane routes: the device-SHA route when the verifier asks
        for it; else the delta route when the model prefers it and the
        messages share a prefix and suffix; else the prehashed ladder (pack
        and hash on the host, copy R||S||k over). Returns the un-fetched
        (bits, all_ok) device tensors; `_device_path` names the route and
        `_oversize` the lanes left to the host."""
        self._device_path, self._oversize = "ladder", []
        n = self.count()
        b = _bucket(n)
        if self._device_sha:
            self._device_path = "device_sha"
            return self._launch_device_sha(n, b)
        if DELTA_MIN <= n and b <= DELTA_MAX_BUCKET and _delta_beats_prehashed(n, b, self.device):
            if self._delta is None:
                self._delta = _detect_delta(self._msg_buf, self._msg_lens) or False
            if self._delta:
                self._device_path = "delta"
                return self._launch_device_delta(self._delta)
        # streamed placement: with a mesh up, each whole batch lands on the
        # next mesh device round robin, so d independent commits verify at
        # once with no sum (the pubkey cache keeps a copy per device)
        dev = self.device
        eng = _mesh_engine()
        if eng is not None and eng.n_devices > 1 and eng.devices[0].type == dev.type:
            dev = eng.next_device()
            if _trace.enabled:
                _trace.emit("crypto.stream_place", "event", device=str(dev), n=n, b=b)
        rsk = self._pack_rsk(n, b).to(dev, non_blocking=True)
        ok_a, neg_a = self._pubkeys_on_device(n, b, dev=dev)
        live = torch.arange(b, device=dev) < n
        return verify_batch_cached_a(ok_a, neg_a, rsk, live)

    def _launch_mesh(self, eng):
        """Shard one mega-batch over every mesh device: the ladder route's
        96 B a lane R||S||k rows, padded so that B divides the mesh (dead
        lanes go out with live=False), the pubkey column staged once per
        set in the engine's cache. Returns a PendingBatch over the
        un-fetched all-ok scalar and the per-shard bitmaps."""
        n = self.count()
        b = _mesh.pad_to_shards(n, eng.n_devices, bucket=_bucket(n))
        rsk = self._pack_rsk(n, b)
        a_host, a_view = self._host_buffer((b, 32))
        a_view[:n] = np.frombuffer(self._pub_buf, np.uint8).reshape(n, 32)
        live = torch.arange(b) < n
        if self.device.type == "cuda":
            live = live.pin_memory()
        all_ok, bits = eng.submit(a_host, rsk, live, fp=hashlib.sha256(self._pub_buf).digest())
        self._device_path = "mesh"
        return PendingBatch(bits, all_ok, n, list(self._precheck_fail), [], [])

    def _pack_device_sha(self, n: int, b: int) -> tuple[torch.Tensor, dict, list[int]]:
        """Host half of the device-SHA route: A, R, S, the SHA-512-padded
        R||A||M words, the two-block flags and the live mask in one buffer,
        vectorized when every message has one length (commit sign bytes)
        and through `sha512.pad_messages` otherwise. A lane whose R||A||M
        exceeds MAX_INPUT_BYTES goes out dead. Returns (buffer, fields,
        the oversize lanes)."""
        buf, fields, v = self._field_buffer({
            "a": (np.uint8, (b, 32)), "r": (np.uint8, (b, 32)), "s": (np.uint8, (b, 32)),
            "words": (np.uint32, (b, _sha.PADDED_WORDS)), "two": (np.bool_, (b,)),
            "live": (np.bool_, (b,))})
        pub = np.frombuffer(self._pub_buf, np.uint8).reshape(n, 32)
        sig = np.frombuffer(self._sig_buf, np.uint8).reshape(n, 64)
        v["a"][:n] = pub
        v["r"][:n] = sig[:, :32]
        v["s"][:n] = sig[:, 32:]
        v["live"][:n] = True
        lens = np.asarray(self._msg_lens, np.int64)
        oversize = []
        if n and (lens == lens[0]).all() and 64 + lens[0] <= _sha.MAX_INPUT_BYTES:
            pre = np.concatenate([sig[:, :32], pub, np.frombuffer(self._msg_buf, np.uint8)
                                  .reshape(n, int(lens[0]))], axis=1)
            v["words"][:n], v["two"][:n] = _sha.pad_rows(pre)
        else:
            preimages = []
            for i, (p, m, sg) in enumerate(self._items()):
                pre = sg[:32] + p + m
                if len(pre) > _sha.MAX_INPUT_BYTES:
                    oversize.append(i)  # verified on the host at result()
                    pre = b""
                    v["live"][i] = False
                preimages.append(pre)
            v["words"][:n], v["two"][:n] = _sha.pad_messages(preimages)
        return buf, fields, oversize

    def _launch_device_sha(self, n: int, b: int):
        """Device-SHA route: one pinned buffer over, then SHA-512, the
        reduction mod L, `decompress` and the ladder on the device."""
        buf, fields, self._oversize = self._pack_device_sha(n, b)
        t = unpack_fields(buf.to(self.device, non_blocking=True), fields)
        return verify_batch(t["a"], t["r"], t["s"], t["words"], t["two"], t["live"])

    def _pack_delta(self, d: dict) -> tuple[torch.Tensor, dict]:
        """Host half of the delta route, from `_detect_delta`'s dict d: the
        (b, 64 + midmax + 1) rows R || S || middle bytes || middle length,
        and the meta row [plen, slen, n (3 bytes), pad, prefix, suffix], in
        one buffer."""
        n = self.count()
        b = _bucket(n)
        midmax, lcp, lcs = d["midmax"], d["lcp"], d["lcs"]
        buf, fields, v = self._field_buffer({"packed": (np.uint8, (b, 64 + midmax + 1)),
                                             "meta": (np.uint8, (DELTA_META_LEN,))})
        packed, meta = v["packed"], v["meta"]
        packed[:n, :64] = np.frombuffer(self._sig_buf, np.uint8).reshape(n, 64)
        take = min(midmax, d["arr"].shape[1] - lcp)
        if take > 0:
            packed[:n, 64 : 64 + take] = d["arr"][:, lcp : lcp + take]
        packed[:n, -1] = d["mid_lens"]
        meta[:5] = (lcp, lcs, n & 0xFF, (n >> 8) & 0xFF, (n >> 16) & 0xFF)
        h = DELTA_META_HEADER
        meta[h : h + lcp] = d["arr"][0, :lcp]
        l0 = int(d["lens"][0])
        meta[h + DELTA_PMAX : h + DELTA_PMAX + lcs] = d["arr"][0, l0 - lcs : l0]
        return buf, fields

    def _launch_device_delta(self, d: dict):
        """Delta route: R||S and the middle bytes over; the prefix, suffix and
        pubkey encodings rebuild the messages on the device."""
        n = self.count()
        buf, fields = self._pack_delta(d)
        t = unpack_fields(buf.to(self.device, non_blocking=True), fields)
        ok_a, neg_a, a_enc = self._pubkeys_on_device(n, _bucket(n), with_encodings=True)
        return verify_batch_delta(ok_a, neg_a, a_enc, t["packed"], t["meta"])

    def _pack_rlc(self, z16=None):
        """Host half of the RLC route: the digit layout (`rlc.prepare`) and
        every array the device needs, packed into one zeroed (pinned, for
        a GPU) uint8 buffer. Returns (buffer, fields, s_pad), or None when
        the layout declines the batch. z16 pins the coefficients (tests)."""
        n = self.count()
        b = _bucket(n)
        skip = np.asarray(self._precheck_fail, bool)
        # the columnar blobs: the native packer reads them without a join
        prep = _rlc.prepare(None, skip, b, z16, blobs=(
            self._pub_buf, self._sig_buf, self._msg_buf, np.asarray(self._msg_lens, np.uint64)))
        if prep is None:
            return None
        # pad the round count to a power of two (min 8), the reference's
        # tiering, so both packages run the same S
        s_pad = 8
        while s_pad < prep["s_rounds"]:
            s_pad *= 2
        arrays = {k: prep[k] for k in ("stream", "stream_neg", "counts", "weights", "c_digits")}
        buf, fields, v = self._field_buffer({
            "a": (np.uint8, (b, 32)), "r": (np.uint8, (b, 32)), "live": (np.uint8, (b,)),
            **{k: (arr.dtype, arr.shape) for k, arr in arrays.items()}})
        v["a"][:n] = np.frombuffer(self._pub_buf, np.uint8).reshape(n, 32)
        v["r"][:n] = np.frombuffer(self._sig_buf, np.uint8).reshape(n, 64)[:, :32]
        v["live"][:n] = ~skip
        for k, arr in arrays.items():
            v[k][...] = arr
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
# indices <= 0x7FFF and uint32 indices far below 2^31. The device-SHA
# route's uint32 message words are viewed as int32 bit patterns, which
# the SHA-512 kernel and its plain version take as they are.
_TORCH_DTYPES = {np.dtype(np.uint8): torch.uint8, np.dtype(np.uint16): torch.int16,
                 np.dtype(np.uint32): torch.int32, np.dtype(np.int32): torch.int32,
                 np.dtype(np.bool_): torch.bool}


def unpack_fields(buf: torch.Tensor, fields: dict) -> dict:
    """Views of the fields of a buffer packed by `_field_buffer`, on its
    device."""
    out = {}
    for k, (off, dt, shape) in fields.items():
        nbytes = int(np.prod(shape)) * dt.itemsize
        out[k] = buf[off : off + nbytes].view(_TORCH_DTYPES[dt]).reshape(shape)
    return out


def verify_rlc_packed(buf: torch.Tensor, fields: dict, s_pad: int) -> torch.Tensor:
    """The device half of the RLC route on a buffer from `_pack_rlc`
    (already on the device). Returns the all-ok scalar, on the device."""
    t = unpack_fields(buf, fields)
    return rlc_verify_stream(
        t["a"], t["r"], t["live"] != 0, t["stream"], t["stream_neg"], t["counts"],
        t["weights"], t["c_digits"], s_rounds=s_pad)


def _producer_stream(t: torch.Tensor):
    """The CUDA stream current when a summary scalar was produced (None on
    the CPU): its prefetch copy and event go on that stream, after the
    kernels that wrote it."""
    return torch.cuda.current_stream(t.device) if t.device.type == "cuda" else None


def _prefetch_summary(p) -> None:
    """Start the device->host copy of a handle's all-ok scalar into pinned
    memory (`non_blocking=True`) on the stream that produced it, and
    record an event after it there. Nothing on a CPU handle, or when
    already started."""
    if p._stream is None or p._ready is not None:
        return
    t = p._all_ok
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    with torch.cuda.stream(p._stream):
        host.copy_(t, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(p._stream)
    p._host_ok, p._ready = host, ready


def _fetch_summary(p) -> bool:
    """A handle's all-ok scalar on the host: after prefetch(), wait on its
    event and read the pinned copy (never before the event completes);
    else one blocking `.item()`."""
    if p._ready is not None:
        p._ready.synchronize()
        return bool(p._host_ok.item())
    return bool(p._all_ok.item())


def _observe_latency(p) -> None:
    """Record the submit->result wall time of a pending handle in the
    per-route latency histogram, once (the first resolution)."""
    if p._t0 is None:
        return
    crypto_metrics().verify_seconds.observe(time.perf_counter() - p._t0,
                                            p._path or "unknown", "ed25519")
    p._t0 = None


class PendingBatch:
    """Handle to an in-flight device batch; result() fetches and finalizes.

    Holds a snapshot of the per-batch host state, so the originating
    verifier can be reused after submit(). The happy path fetches only the
    device-reduced all-ok scalar; the bitmap transfers only when some lane
    failed. Lanes the device could not hash (the device-SHA route's
    messages over two blocks, which went out dead) are verified here on
    the host with `ed25519_ref.verify`, as the reference does."""

    __slots__ = ("_dev", "_all_ok", "_n", "_precheck_fail", "_oversize_items",
                 "_oversize_idx", "_path", "_t0", "_stream", "_host_ok", "_ready")

    def __init__(self, dev, all_ok, n, precheck_fail, oversize_items, oversize_idx):
        self._dev = dev
        self._all_ok = all_ok
        self._n = n
        self._precheck_fail = precheck_fail
        self._oversize_items = oversize_items
        self._oversize_idx = oversize_idx
        self._path = None
        self._t0 = None
        self._stream = _producer_stream(all_ok)
        self._host_ok = self._ready = None

    def _finalize_fast(self, dev_all_ok: bool) -> tuple[bool, list[bool]]:
        _observe_latency(self)
        if dev_all_ok and not any(self._precheck_fail):
            out = [True] * self._n
        else:
            dev = self._dev
            if isinstance(dev, list):  # the mesh's per-shard bitmaps
                dev = _mesh.gather_bits(dev)
            bits = dev[: self._n].cpu().tolist()
            out = [bool(x) and not bad for x, bad in zip(bits, self._precheck_fail)]
        for i, item in zip(self._oversize_idx, self._oversize_items):
            out[i] = not self._precheck_fail[i] and ref.verify(*item)
        return all(out), out

    def prefetch(self) -> None:
        """Start the device->host copy of the all-ok scalar without
        blocking, so a consumer overlaps it with other host work
        (reference :1119)."""
        _prefetch_summary(self)

    def result(self) -> tuple[bool, list[bool]]:
        return self._finalize_fast(_fetch_summary(self))


class PendingRLC:
    """In-flight RLC/MSM batch: a single device bool. When it is true,
    every live lane verified (random-linear-combination soundness); when
    false, the batch reruns on the per-lane ladder route to assign blame,
    as the reference falls back from batch to single verification
    (types/validation.go:304-311)."""

    __slots__ = ("_all_ok", "_precheck_fail", "_lanes", "_path", "_t0", "_stream",
                 "_host_ok", "_ready")

    def __init__(self, all_ok, precheck_fail, lanes: Ed25519BatchVerifier):
        self._all_ok = all_ok
        self._precheck_fail = precheck_fail
        self._lanes = lanes  # force_perlane verifier holding the batch
        self._path = None
        self._t0 = None
        self._stream = _producer_stream(all_ok)
        self._host_ok = self._ready = None

    def _finalize_fast(self, dev_all_ok: bool) -> tuple[bool, list[bool]]:
        _observe_latency(self)
        if dev_all_ok:
            bits = [not bad for bad in self._precheck_fail]
            return all(bits), bits
        return self._lanes.submit().result()

    def prefetch(self) -> None:
        """As PendingBatch.prefetch (reference :1183)."""
        _prefetch_summary(self)

    def result(self) -> tuple[bool, list[bool]]:
        return self._finalize_fast(_fetch_summary(self))


class DonePending:
    """Already-resolved batch (the native route, or no lane) behind the
    pending API."""

    __slots__ = ("_ok", "_bits", "_all_ok", "_path", "_t0")

    def __init__(self, ok, bits):
        self._ok = ok
        self._bits = bits
        self._all_ok = torch.tensor(ok)  # collect_pending stacks this
        self._path = None
        self._t0 = None

    def _finalize_fast(self, _dev_all_ok) -> tuple[bool, list[bool]]:
        _observe_latency(self)
        return self._ok, self._bits

    def prefetch(self) -> None:
        pass  # already on the host (reference :1147)

    def result(self) -> tuple[bool, list[bool]]:
        return self._finalize_fast(self._ok)


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


def _detect_delta(msg_blob, msg_lens):
    """Longest common prefix and suffix of a batch's messages (the
    columnar blob and lengths), vectorized. Commit sign bytes differ per
    lane only in the vote timestamp, so the device rebuilds each message
    (`ops.ed25519_verify.build_delta_msgs`) from ~8-16 bytes a lane.
    Returns the reference's packing dict (`arr`, `lens`, `lcp`, `lcs`,
    `midmax`, `mid_lens`), or None when the messages do not share enough
    structure to beat the 96 B/lane R||S||k rows."""
    n = len(msg_lens)
    if n == 0:
        return None
    lens = np.asarray(msg_lens, np.int64)
    maxlen = int(lens.max())
    minlen = int(lens.min())
    if minlen == 0 or maxlen > _sha.MAX_INPUT_BYTES - 64:
        return None
    flat = np.frombuffer(msg_blob, np.uint8)
    off = np.concatenate([[0], np.cumsum(lens)])
    idx = off[:-1, None] + np.arange(maxlen)[None, :]
    arr = flat[np.clip(idx, 0, len(flat) - 1)] * (
        np.arange(maxlen) < lens[:, None]).astype(np.uint8)
    inrange = np.arange(maxlen) < minlen
    common = (arr == arr[0:1]).all(axis=0) & inrange
    lcp = minlen if common.all() else int(np.argmin(common))
    ridx = off[1:, None] - 1 - np.arange(maxlen)[None, :]
    rev = flat[np.clip(ridx, 0, len(flat) - 1)]
    commons = (rev == rev[0:1]).all(axis=0) & inrange
    lcs = minlen if commons.all() else int(np.argmin(commons))
    lcs = min(lcs, minlen - lcp)
    mid_lens = lens - lcp - lcs
    midmax = max(8, -(-int(mid_lens.max()) // 8) * 8)
    if 64 + midmax + 1 >= _WIRE_LADDER_B:
        return None  # not enough shared structure to beat R||S||k
    return {"arr": arr, "lens": lens, "lcp": lcp, "lcs": lcs, "midmax": midmax,
            "mid_lens": mid_lens}


def batch_verifier(device="cuda") -> Ed25519BatchVerifier:
    return Ed25519BatchVerifier(device=device)
