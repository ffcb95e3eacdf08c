"""One signature batch over several devices.

Twin of `cometbft_tpu/parallel/mesh.py`. The data-parallel axis is the
signature batch: a 10,000-validator commit is padded to a multiple of the
device count (`pad_to_shards`) and cut into equal shards, one a device.
Where the reference lays the batch out on a JAX mesh and lets XLA insert
a psum, the port takes each step itself over an ordered list of
`torch.device`s:

- each shard is copied from a pinned host buffer to its device with
  `non_blocking=True`;
- each shard is verified on its device's current stream by the port's own
  ops (`ops.ed25519_verify.verify_batch_prehashed`, or `verify_batch` in
  the device-SHA form): decompression in the shard, then the ladder, so
  `decompress`, `ladder_sub_mul8` (and `sha512_reduce`) run on each
  shard's device;
- each shard's count of bad live lanes is summed onto the first device,
  innermost axis first (on a (host, sig) grid: within each host's row,
  then across the rows); before each add, the receiving device's stream
  waits on an event recorded on the sending shard's stream.

The result is an un-fetched all-ok scalar on the first device and the
per-shard bitmaps, which cross to the host only when that scalar says a
lane failed (`gather_bits`).

A list may name one device several times: logical shards of one card,
which run one after another on that card's stream (how the mesh is held
on a machine with one GPU), or of the CPU (the tests). Their times say
nothing about scaling across cards.

`MeshVerifyEngine` serves the dispatch of `crypto/ed25519.py` two ways:
`submit()` shards one mega-batch over every device, and `next_device()`
places whole independent batches round robin (streamed commits). Its
`dispatch_terms()` are timed on the GPU at first use (per-shard staging,
and the cross-device sum with the all-ok); on CPU devices nothing is
calibrated and the dispatch never picks the mesh.

`get_engine()` keeps the reference's policy under COMETBFT_TPU_TORCH_MESH;
`set_engine()` installs an engine directly (tests, `chip_smoke.py`). The
reference's multi-process layout, whose `hosts` is the JAX process count,
has no counterpart in one process: a (host, sig) grid is built only when
`hosts` is given.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import time

import numpy as np
import torch

from ..ops import ed25519_verify
from ..ops.field import device_key
from ..utils import trace as _trace
from ..utils.metrics import crypto_metrics

ENV = "COMETBFT_TPU_TORCH_MESH"
_A_CACHE_SIZE = 4


def default_devices() -> list[torch.device]:
    """Every visible GPU; the CPU on a host without one."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def make_mesh(devices=None) -> list[torch.device]:
    """The 1-D ("sig") mesh: the ordered devices a batch is sharded over
    (`default_devices()` when not given)."""
    devs = [device_key(d) for d in (default_devices() if devices is None else devices)]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    if len({d.type for d in devs}) > 1:
        raise ValueError("a mesh's devices must be all GPUs or all the CPU")
    return devs


def make_mesh_2d(devices=None, hosts: int = 2) -> list[list[torch.device]]:
    """The (host, sig) grid: `hosts` rows of consecutive devices. The sum
    of bad lanes runs within each row first, then across the rows, so one
    count a host crosses between hosts."""
    devs = make_mesh(devices)
    n = len(devs)
    if n % hosts:
        raise ValueError(f"{n} devices do not split over {hosts} hosts")
    k = n // hosts
    return [devs[i * k:(i + 1) * k] for i in range(hosts)]


def _rows(mesh) -> list[list[torch.device]]:
    """A 1-D mesh as one row; a grid as its rows."""
    if mesh and isinstance(mesh[0], (list, tuple)):
        return [list(r) for r in mesh]
    return [list(mesh)]


def pad_to_shards(n: int, parts: int, bucket: int | None = None) -> int:
    """Smallest padded batch size that holds n lanes, is at least the
    bucket, and divides evenly over `parts` shards. n < parts (every
    device still gets an equal, partly dead shard), a prime n and n == 0
    (one dead lane a device) are all covered. Dead lanes go out with
    live=False and are left out of the sum."""
    b = max(int(bucket or 0), int(n), 1)
    return -(-b // parts) * parts


def _on(dev: torch.device):
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def stage_shards(x, devices: list[torch.device]) -> list[torch.Tensor]:
    """Cut the host array x (B, ...) into len(devices) equal row blocks and
    copy each to its device, from pinned memory and with
    `non_blocking=True` when the devices are GPUs. A numpy array is
    wrapped without a copy (and pinned by one copy for a GPU)."""
    t = torch.as_tensor(x)
    if devices[0].type == "cuda" and not t.is_pinned():
        t = t.pin_memory()
    k = t.shape[0] // len(devices)
    return [t[i * k:(i + 1) * k].to(d, non_blocking=True) for i, d in enumerate(devices)]


def _sum_onto(counts: list[torch.Tensor], target: torch.device) -> torch.Tensor:
    """The sum of per-shard counts on `target`. Before each count crosses,
    the target's current stream waits on an event recorded on the stream
    of the count's device, where the shard's verify was queued."""
    total = None
    for c in counts:
        if c.device != target and c.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(c.device))
            torch.cuda.current_stream(target).wait_event(ev)
        c = c.to(target, non_blocking=True)
        total = c if total is None else total + c
    return total


def reduce_bad(counts: list[torch.Tensor], rows: list[list[torch.device]]) -> torch.Tensor:
    """Sum the per-shard counts (in the rows' flat order) onto the first
    device, innermost axis first: each row onto its first device, then
    the rows' totals onto the first row's."""
    k = len(rows[0])
    totals = [_sum_onto(counts[i * k:(i + 1) * k], row[0]) for i, row in enumerate(rows)]
    return _sum_onto(totals, rows[0][0])


def _run_shards(rows, verify, shard_args) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """verify(*args) on each shard's device (the last argument the live
    mask); returns (all-ok scalar on the first device, per-shard bits)."""
    bits, counts = [], []
    for args in shard_args:
        live = args[-1]
        with _on(live.device):
            b, _ = verify(*args)
            bits.append(b)
            counts.append((~b & live).sum())
    return reduce_bad(counts, rows) == 0, bits


def _check_divides(b: int, parts: int) -> None:
    if b % parts:
        raise ValueError(f"batch {b} does not shard over {parts} devices (pad with pad_to_shards)")


def sharded_verify_rsk_fn(mesh):
    """The production mesh verifier, prehashed lanes: fn(a_bytes, rsk, live)
    with a_bytes (B, 32) uint8 pubkey encodings (or their per-shard device
    tensors, as `MeshVerifyEngine.stage_pubkeys` keeps them), rsk (B, 96)
    uint8 R||S||k rows (k hashed on the host), live (B,) bool; B a multiple
    of the device count. Returns (all-ok scalar on the first device,
    per-shard bitmaps), both un-fetched."""
    rows = _rows(mesh)
    devs = [d for r in rows for d in r]

    def fn(a_bytes, rsk, live):
        _check_divides(rsk.shape[0], len(devs))
        a = a_bytes if isinstance(a_bytes, list) else stage_shards(a_bytes, devs)
        r = stage_shards(rsk, devs)
        lv = stage_shards(live, devs)
        return _run_shards(rows, ed25519_verify.verify_batch_prehashed,
                           [(ai, ri[:, :32], ri[:, 32:64], ri[:, 64:], li)
                            for ai, ri, li in zip(a, r, lv)])

    return fn


def sharded_verify_fn(mesh):
    """The device-SHA form: fn(a_bytes, r_bytes, s_bytes, msg_words,
    two_blocks, live) as `ops.ed25519_verify.verify_batch` takes them, B a
    multiple of the device count; the challenge is hashed in each shard.
    Returns (all-ok scalar on the first device, per-shard bitmaps)."""
    rows = _rows(mesh)
    devs = [d for r in rows for d in r]

    def fn(*arrays):
        _check_divides(arrays[0].shape[0], len(devs))
        shards = [stage_shards(x, devs) for x in arrays]
        return _run_shards(rows, ed25519_verify.verify_batch, list(zip(*shards)))

    return fn


def gather_bits(bits: list[torch.Tensor]) -> torch.Tensor:
    """The per-shard bitmaps as one (B,) bool tensor on the host."""
    return torch.cat([b.cpu() for b in bits])


def _as_numpy(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _wall_s(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


class MeshVerifyEngine:
    """A device mesh and its sharded verifier, serving two modes:

    - submit(): one mega-batch sharded over every device (used when one
      batch is big enough that splitting its device time d ways beats one
      device);
    - next_device(): round-robin placement of whole independent batches
      (streamed commits), d commits at once with no sum at all.

    `hosts` > 1 lays the devices out as a (host, sig) grid."""

    def __init__(self, devices=None, hosts: int = 1):
        self.devices = make_mesh(devices)
        self.n_devices = len(self.devices)
        if hosts > 1:
            self.axes = ("host", "sig")
            self.mesh = make_mesh_2d(self.devices, hosts)
        else:
            self.axes = ("sig",)
            self.mesh = self.devices
        self.on_gpu = self.devices[0].type == "cuda"
        self._verify = sharded_verify_rsk_fn(self.mesh)
        self._a_cache: dict = {}  # (sha256(pub column), B, devices) -> staged shards
        self._rr = 0
        self._terms: dict | None = None
        crypto_metrics().mesh_devices.set(float(self.n_devices))

    # -- dispatch terms ------------------------------------------------

    def _sync(self) -> None:
        for d in dict.fromkeys(self.devices):
            torch.cuda.synchronize(d)

    def dispatch_terms(self) -> dict:
        """{'put_fixed_s', 'collective_s', 'calibrated'} for the dispatch
        model's mesh term, timed on the GPUs at first use: put_fixed_s is
        each device's share of staging one small shard a device (64 rows of
        96 B, best of 3), collective_s the cross-device sum of one count a
        shard and its all-ok (best of 3). On CPU devices both are None and
        `calibrated` is False."""
        if self._terms is None:
            terms = {"put_fixed_s": None, "collective_s": None, "calibrated": False}
            if self.on_gpu:
                buf = torch.zeros((self.n_devices * 64, 96), dtype=torch.uint8).pin_memory()
                counts = [torch.zeros((), dtype=torch.int64, device=d) for d in self.devices]
                rows = _rows(self.mesh)

                def put():
                    stage_shards(buf, self.devices)
                    self._sync()

                def collective():
                    _ = reduce_bad(counts, rows) == 0
                    self._sync()

                put(), collective()  # warm
                terms["put_fixed_s"] = min(_wall_s(put) for _ in range(3)) / self.n_devices
                terms["collective_s"] = min(_wall_s(collective) for _ in range(3))
                terms["calibrated"] = True
            self._terms = terms
        return self._terms

    def set_collective_s(self, seconds: float) -> None:
        """Refine the collective term from a measured sharded run."""
        self.dispatch_terms()["collective_s"] = max(float(seconds), 0.0)

    # -- sharded mega-batch path ---------------------------------------

    def stage_pubkeys(self, a_bytes, fp=None) -> list[torch.Tensor]:
        """The (B, 32) pubkey column staged shard by shard, cached by
        (fingerprint, B, devices): replay verifies the same validator set
        every height, so its 32 B a lane cross the link once (the
        decompression itself runs in each shard at every submit)."""
        b = a_bytes.shape[0]
        if fp is None:
            fp = hashlib.sha256(_as_numpy(a_bytes).tobytes()).digest()
        key = (fp, b, tuple(map(str, self.devices)))
        staged = self._a_cache.get(key)
        if staged is None:
            staged = self._a_cache[key] = stage_shards(a_bytes, self.devices)
            while len(self._a_cache) > _A_CACHE_SIZE:
                self._a_cache.pop(next(iter(self._a_cache)))
        return staged

    def submit(self, a_bytes, rsk, live, fp=None):
        """Launch one sharded verify. B = a_bytes.shape[0] must be a
        multiple of the device count (`pad_to_shards`); dead lanes carry
        live=False. Returns (all-ok scalar on the first device, per-shard
        bitmaps), un-fetched."""
        _check_divides(a_bytes.shape[0], self.n_devices)
        t0 = time.perf_counter()
        all_ok, bits = self._verify(self.stage_pubkeys(a_bytes, fp), rsk, live)
        m = crypto_metrics()
        for i in range(self.n_devices):
            m.mesh_batches_total.inc(1.0, str(i), "shard")
        if _trace.enabled:
            b = a_bytes.shape[0]
            _trace.emit("crypto.mesh_submit", "span",
                        dur_ms=round((time.perf_counter() - t0) * 1e3, 3),
                        n=int(_as_numpy(live).sum()), b=b, n_devices=self.n_devices,
                        shard_lanes=b // self.n_devices)
        return all_ok, bits

    # -- streamed independent-batch path -------------------------------

    def next_device(self) -> torch.device:
        """Round-robin target for the next independent (streamed) batch;
        the per-device counter shows the skew."""
        i = self._rr % self.n_devices
        self._rr += 1
        crypto_metrics().mesh_batches_total.inc(1.0, str(i), "stream")
        return self.devices[i]


_ENGINE = None
_ENGINE_PROBED = False


def get_engine():
    """The process-wide engine, or None when the mesh is off.

    Policy (COMETBFT_TPU_TORCH_MESH, the reference's under the port's
    name):
      - "0"/"off": off;
      - unset, "1"/"on"/"auto": on over every GPU when more than one is
        visible (`default_devices` gives the CPU alone on a host without
        one, so the mesh is off there);
      - N >= 2: on over the first N of them.
    """
    global _ENGINE, _ENGINE_PROBED
    if _ENGINE_PROBED:
        return _ENGINE
    env = os.environ.get(ENV, "").strip().lower()
    devs = default_devices()
    engine = None
    if env in ("", "1", "on", "auto"):
        if len(devs) > 1:
            engine = MeshVerifyEngine(devs)
    elif env not in ("0", "off"):
        try:
            n = int(env)
        except ValueError:
            n = 0  # not a count: off, as the reference treats it
        if n >= 2 and len(devs) >= 2:
            engine = MeshVerifyEngine(devs[:min(n, len(devs))])
    _ENGINE, _ENGINE_PROBED = engine, True
    return _ENGINE


def set_engine(engine) -> None:
    """Install `engine` (or None) as the process's mesh, whatever the
    variable says: the seam through which tests and `chip_smoke.py` run
    the mesh over logical shards."""
    global _ENGINE, _ENGINE_PROBED
    _ENGINE, _ENGINE_PROBED = engine, True


def reset_engine() -> None:
    """Drop the cached engine so that the next get_engine() reads the
    variable again."""
    global _ENGINE, _ENGINE_PROBED
    _ENGINE, _ENGINE_PROBED = None, False
