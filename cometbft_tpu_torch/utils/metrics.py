"""Prometheus-style metrics: the port's minimal copy of the parts of
`cometbft_tpu/utils/metrics.py` that the ported modules record.

Counter, Gauge and Histogram (with per-bucket exemplars) with labels on
one `Registry`, and the bundles, under the reference's names so the two
backends' metrics line up:

- `CryptoMetrics`, fed by the verifier, the commit consumers and the
  shared scheduler (`batch_size`, `path_selected_total` and
  `verify_seconds` by path and curve, `calibration_us_per_sig`,
  `sched_queue_depth`, `sched_coalesced_total`, `sched_batch_sigs`);
- `StateMetrics` (`state/execution.py`) and `StoreMetrics`
  (`storage/blockstore.py`);
- `MempoolMetrics` (`mempool/mempool.py`, `mempool/admission.py` and the
  mempool-side stamps of `utils/txlife.py`);
- of `LightClientMetrics`, the two counters `light/client.py` feeds
  (`headers_verified_total`, `bisections_total`); the serving surface's
  metrics come with `light/serve.py`;
- `ConsensusMetrics`, fed by `consensus/state.py` and `utils/txlife.py`
  (all but the reference's `cert_gossip_total`, which only the
  certificate path feeds);
- `P2PMetrics` (`p2p/conn.py`, `p2p/switch.py`; `peer_height` and
  `peer_round` from `consensus/reactor.py`'s peer state) and
  `BlockSyncMetrics` (`blocksync/pool.py`, `blocksync/reactor.py`;
  `cert_verify_seconds` waits for replay's certificate branch);
- `StateSyncMetrics` (`statesync/syncer.py`);
- the mesh's `mesh_devices` and `mesh_batches_total` in `CryptoMetrics`
  (`parallel/mesh.py`).

`crypto_metrics()`, `state_metrics()`, ... hand out the process's bundle
against `DEFAULT_REGISTRY`; `reset_bundles()` clears them all (tests).
"""

from __future__ import annotations

import threading
import time

NAMESPACE = "cometbft"


def set_namespace(ns: str) -> None:
    """Set the metric-name prefix (config [instrumentation] namespace).

    Affects metrics registered after the call; node startup invokes it
    before any subsystem bundle is created.
    """
    global NAMESPACE
    if ns:
        NAMESPACE = ns


class _Metric:
    def __init__(self, name: str, help_: str, labels: tuple[str, ...]):
        self.name = name
        self.help = help_
        self.labels = labels
        self._lock = threading.Lock()
        self._values: dict[tuple, float] = {}

    def _key(self, label_values: tuple) -> tuple:
        if len(label_values) != len(self.labels):
            raise ValueError(f"{self.name}: expected labels {self.labels}, got {label_values}")
        return label_values

    def values(self) -> dict[tuple, float]:
        """Snapshot of the current samples, keyed by label-value tuple."""
        with self._lock:
            return dict(self._values)

    def remove(self, *labels) -> None:
        """Drop one labelled series (e.g. a disconnected peer's gauge)."""
        key = self._key(tuple(labels))
        with self._lock:
            self._values.pop(key, None)


class Counter(_Metric):
    def inc(self, amount: float = 1.0, *labels) -> None:
        key = self._key(tuple(labels))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount


class Gauge(_Metric):
    def set(self, value: float, *labels) -> None:
        with self._lock:
            self._values[self._key(tuple(labels))] = value


class Histogram(_Metric):
    DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

    def __init__(self, name, help_, labels, buckets=None):
        super().__init__(name, help_, labels)
        self.buckets = tuple(buckets or self.DEFAULT_BUCKETS)
        self._counts: dict[tuple, list[int]] = {}
        self._sums: dict[tuple, float] = {}
        # per-(labelset, bucket index) exemplar: (id, value, epoch ts) —
        # latest observation wins, like the prometheus client libraries
        self._exemplars: dict[tuple, dict[int, tuple]] = {}

    def observe(self, value: float, *labels, exemplar: str | None = None) -> None:
        key = self._key(tuple(labels))
        with self._lock:
            counts = self._counts.setdefault(key, [0] * (len(self.buckets) + 1))
            bucket_idx = len(self.buckets)  # +Inf
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
                    bucket_idx = min(bucket_idx, i)
            counts[-1] += 1  # +Inf
            self._sums[key] = self._sums.get(key, 0.0) + value
            if exemplar is not None:
                self._exemplars.setdefault(key, {})[bucket_idx] = (
                    str(exemplar), value, time.time())

    def exemplars(self) -> dict[tuple, dict[int, tuple]]:
        """{labels: {bucket index: (id, value, ts)}}; bucket index
        len(buckets) is +Inf."""
        with self._lock:
            return {k: dict(v) for k, v in self._exemplars.items()}

    def snapshot(self) -> dict[tuple, dict]:
        """{labels: {"count": n, "sum": s}}."""
        with self._lock:
            return {k: {"count": c[-1], "sum": self._sums.get(k, 0.0)}
                    for k, c in self._counts.items()}


class Registry:
    def __init__(self):
        self._metrics: list[_Metric] = []
        self._names: set[str] = set()
        self._lock = threading.Lock()

    def counter(self, subsystem: str, name: str, help_: str = "", labels: tuple = ()) -> Counter:
        return self._add(Counter(f"{NAMESPACE}_{subsystem}_{name}", help_, tuple(labels)))

    def gauge(self, subsystem: str, name: str, help_: str = "", labels: tuple = ()) -> Gauge:
        return self._add(Gauge(f"{NAMESPACE}_{subsystem}_{name}", help_, tuple(labels)))

    def histogram(self, subsystem: str, name: str, help_: str = "", labels: tuple = (),
                  buckets=None) -> Histogram:
        return self._add(Histogram(f"{NAMESPACE}_{subsystem}_{name}", help_, tuple(labels),
                                   buckets))

    def _add(self, m: _Metric):
        with self._lock:
            if m.name in self._names:
                raise ValueError(f"metric {m.name!r} already registered")
            self._names.add(m.name)
            self._metrics.append(m)
        return m

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()
            self._names.clear()


DEFAULT_REGISTRY = Registry()

# Sub-second buckets for the tx-lifecycle waterfall: single-node stage
# latencies live in the 0.5ms–2.5s band (admission windows are ~ms,
# consensus rounds ~100ms–1s); the default buckets start too coarse.
TX_STAGE_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                    0.1, 0.25, 0.5, 1.0, 2.5)


class ConsensusMetrics:
    """The reference's bundle as `consensus/state.py` and `utils/txlife.py`
    feed it, without `cert_gossip_total` (only the certificate path, which
    the port does not have, feeds it)."""

    def __init__(self, reg: Registry | None = None):
        reg = reg or DEFAULT_REGISTRY
        self.height = reg.gauge("consensus", "height", "Current height")
        self.rounds = reg.gauge("consensus", "rounds", "Round of the height")
        self.validators = reg.gauge("consensus", "validators",
                                    "Validator count")
        self.missing_validators = reg.gauge(
            "consensus", "missing_validators",
            "Validators absent from the last commit")
        self.block_interval_seconds = reg.histogram(
            "consensus", "block_interval_seconds",
            "Time between consecutive blocks")
        self.num_txs = reg.gauge("consensus", "num_txs", "Txs in last block")
        self.block_size_bytes = reg.gauge("consensus", "block_size_bytes",
                                          "Last block size")
        self.total_txs = reg.counter("consensus", "total_txs",
                                     "Total committed txs")
        self.step_duration_seconds = reg.histogram(
            "consensus", "step_duration_seconds",
            "Time spent in each consensus step", labels=("step",))
        # tx lifecycle observatory (utils/txlife.py): consensus-side
        # waterfall stages, bucket exemplars carrying sampled tx hashes
        self.tx_stage_seconds = reg.histogram(
            "consensus", "tx_stage_seconds",
            "Per-tx lifecycle stage latency, consensus-side stages "
            "(proposal_wait/consensus/apply/notify); sampled txs only",
            labels=("stage",), buckets=TX_STAGE_BUCKETS)
        self.tx_commit_seconds = reg.histogram(
            "consensus", "tx_commit_seconds",
            "Per-tx end-to-end arrival->commit latency; sampled txs only",
            buckets=TX_STAGE_BUCKETS)
        # speculative proposal assembly: hit = the block built during the
        # previous height's commit gap was consumed bit-exact by
        # enter_propose; discard = a round bump, valid_block lock, late
        # precommit, or mempool update invalidated it
        self.speculation_total = reg.counter(
            "consensus", "speculation_total",
            "Speculative proposal assemblies by outcome",
            labels=("outcome",))


class MempoolMetrics:
    def __init__(self, reg: Registry | None = None):
        reg = reg or DEFAULT_REGISTRY
        self.size = reg.gauge("mempool", "size", "Pending txs")
        self.failed_txs = reg.counter("mempool", "failed_txs",
                                      "CheckTx rejections")
        self.recheck_times = reg.counter("mempool", "recheck_times",
                                         "Post-block rechecks")
        self.tx_bytes = reg.gauge(
            "mempool", "tx_bytes",
            "Total bytes of pending txs (running counter, not a scan)")
        # micro-batched admission pipeline: windows amortize the app
        # round-trip + signature verify + lock acquisition
        self.admit_window_size = reg.histogram(
            "mempool", "admit_window_size",
            "Txs per admission window drained by the pipeline")
        self.admit_queue_depth = reg.gauge(
            "mempool", "admit_queue_depth",
            "Txs waiting in the admission queue")
        self.admit_latency = reg.histogram(
            "mempool", "admit_latency",
            "Seconds from enqueue to admission verdict")
        # tx lifecycle observatory (utils/txlife.py): mempool-side
        # waterfall stages, bucket exemplars carrying sampled tx hashes
        self.tx_stage_seconds = reg.histogram(
            "mempool", "tx_stage_seconds",
            "Per-tx lifecycle stage latency, mempool-side stages "
            "(admit_wait/verify/app_check); sampled txs only",
            labels=("stage",), buckets=TX_STAGE_BUCKETS)


class LightClientMetrics:
    """The light client's counters of the reference's bundle (the
    serving surface's metrics wait for `light/serve.py`)."""

    def __init__(self, reg: Registry | None = None):
        reg = reg or DEFAULT_REGISTRY
        self.headers_verified_total = reg.counter(
            "light", "headers_verified_total",
            "Light blocks verified (sequential + skipping)")
        self.bisections_total = reg.counter(
            "light", "bisections_total",
            "Bisection steps taken during skipping verification")


class StateMetrics:
    def __init__(self, reg: Registry | None = None):
        reg = reg or DEFAULT_REGISTRY
        self.block_processing_time = reg.histogram(
            "state", "block_processing_time",
            "ApplyBlock wall time (reference execution.go:230)")
        self.block_verify_time = reg.histogram(
            "state", "block_verify_time",
            "Commit signature verification wall time (TPU kernel path)")


class StoreMetrics:
    # commit bytes span ~100 B certificates to multi-MB signature
    # columns at 10k validators
    COMMIT_BUCKETS = (128, 512, 2048, 8192, 32768, 131072, 524288, 2097152)

    def __init__(self, reg: Registry | None = None):
        reg = reg or DEFAULT_REGISTRY
        self.commit_bytes = reg.histogram(
            "store", "commit_bytes",
            "Encoded canonical-commit bytes written per block "
            "(certificate-native BLS heights shrink this ~N/1)",
            buckets=StoreMetrics.COMMIT_BUCKETS)


class CryptoMetrics:
    BATCH_BUCKETS = (1, 64, 256, 1024, 4096, 10240, 16384, 65536)

    def __init__(self, reg: Registry | None = None):
        reg = reg or DEFAULT_REGISTRY
        self.batch_size = reg.histogram(
            "crypto", "batch_size", "Ed25519 batch-verify sizes", buckets=self.BATCH_BUCKETS)
        self.path_selected_total = reg.counter(
            "crypto", "path_selected_total",
            "Dispatch decisions per verify path (native/rlc/ladder/single) and curve",
            labels=("path", "curve"))
        self.verify_seconds = reg.histogram(
            "crypto", "verify_seconds", "Batch-verify wall time submit→result",
            labels=("path", "curve"))
        self.calibration_us_per_sig = reg.gauge(
            "crypto", "calibration_us_per_sig", "Calibrated host-stage dispatch terms",
            labels=("term",))
        self.mesh_devices = reg.gauge(
            "crypto", "mesh_devices",
            "Device count of the active verify mesh (0/absent = mesh off)")
        self.mesh_batches_total = reg.counter(
            "crypto", "mesh_batches_total",
            "Batches placed per mesh device: sharded mega-batch shards "
            "and streamed whole-commit placements (skew attribution)",
            labels=("device", "mode"))
        self.sched_queue_depth = reg.gauge(
            "crypto", "sched_queue_depth",
            "Verify requests queued in the shared scheduler, per tenant",
            labels=("tenant",))
        self.sched_coalesced_total = reg.counter(
            "crypto", "sched_coalesced_total",
            "Verify requests that shared a coalesced mega-batch dispatch, "
            "per request source (consensus/blocksync/light/admission)",
            labels=("source",))
        self.sched_batch_sigs = reg.histogram(
            "crypto", "sched_batch_sigs",
            "Signatures per coalesced scheduler dispatch",
            buckets=CryptoMetrics.BATCH_BUCKETS)


class P2PMetrics:
    def __init__(self, reg: Registry | None = None):
        reg = reg or DEFAULT_REGISTRY
        self.peers = reg.gauge("p2p", "peers", "Connected peers")
        self.message_receive_bytes_total = reg.counter(
            "p2p", "message_receive_bytes_total", "Bytes received",
            labels=("chan",))
        self.message_send_bytes_total = reg.counter(
            "p2p", "message_send_bytes_total", "Bytes sent",
            labels=("chan",))
        # fed by the consensus reactor's peer state
        self.peer_height = reg.gauge(
            "p2p", "peer_height", "Last known consensus height per peer",
            labels=("peer",))
        self.peer_round = reg.gauge(
            "p2p", "peer_round", "Last known consensus round per peer",
            labels=("peer",))
        self.broadcast_queue_depth = reg.gauge(
            "p2p", "broadcast_queue_depth",
            "Frames waiting in the async broadcast queue")
        self.broadcast_queue_dropped = reg.counter(
            "p2p", "broadcast_queue_dropped",
            "Frames dropped from a saturated broadcast queue")
        self.broadcast_queue_wait_seconds = reg.histogram(
            "p2p", "broadcast_queue_wait_seconds",
            "Enqueue->send wait of frames in the async broadcast queue",
            buckets=TX_STAGE_BUCKETS)
        self.send_queue_depth = reg.gauge(
            "p2p", "send_queue_depth",
            "Messages queued on an MConnection send channel",
            labels=("chan",))


class BlockSyncMetrics:
    def __init__(self, reg: Registry | None = None):
        reg = reg or DEFAULT_REGISTRY
        self.syncing = reg.gauge("blocksync", "syncing",
                                 "1 while block sync is running")
        self.latest_block_height = reg.gauge(
            "blocksync", "latest_block_height",
            "Highest height applied by block sync")
        self.num_peers = reg.gauge("blocksync", "num_peers",
                                   "Peers in the block pool")
        self.pending_requests = reg.gauge(
            "blocksync", "pending_requests",
            "In-flight block requests without a block yet")
        self.peer_height = reg.gauge(
            "blocksync", "peer_height",
            "Reported chain height per pool peer", labels=("peer",))
        self.blocks_applied_total = reg.counter(
            "blocksync", "blocks_applied_total",
            "Blocks verified and applied by block sync")
        self.bad_blocks_total = reg.counter(
            "blocksync", "bad_blocks_total",
            "Blocks that failed verification (request redone)")
        # fed by replay's certificate branch, which the port refuses (no BLS yet)
        self.cert_verify_seconds = reg.histogram(
            "blocksync", "cert_verify_seconds",
            "Certificate (one-pairing) commit verification wall time "
            "during replay, per commit", buckets=TX_STAGE_BUCKETS)


class StateSyncMetrics:
    def __init__(self, reg: Registry | None = None):
        reg = reg or DEFAULT_REGISTRY
        self.syncing = reg.gauge("statesync", "syncing",
                                 "1 while state sync is running")
        self.snapshots_discovered_total = reg.counter(
            "statesync", "snapshots_discovered_total",
            "Snapshots offered by peers")
        self.chunks_applied_total = reg.counter(
            "statesync", "chunks_applied_total",
            "Snapshot chunks accepted by the app")


_BUNDLES: dict[str, object] = {}
_BUNDLES_LOCK = threading.Lock()


def _bundle(name: str, cls):
    with _BUNDLES_LOCK:
        b = _BUNDLES.get(name)
        if b is None:
            b = _BUNDLES[name] = cls()
    return b


def consensus_metrics() -> ConsensusMetrics:
    return _bundle("consensus", ConsensusMetrics)


def mempool_metrics() -> MempoolMetrics:
    return _bundle("mempool", MempoolMetrics)


def light_metrics() -> LightClientMetrics:
    return _bundle("light", LightClientMetrics)


def state_metrics() -> StateMetrics:
    return _bundle("state", StateMetrics)


def store_metrics() -> StoreMetrics:
    return _bundle("store", StoreMetrics)


def crypto_metrics() -> CryptoMetrics:
    return _bundle("crypto", CryptoMetrics)


def p2p_metrics() -> P2PMetrics:
    return _bundle("p2p", P2PMetrics)


def blocksync_metrics() -> BlockSyncMetrics:
    return _bundle("blocksync", BlockSyncMetrics)


def statesync_metrics() -> StateSyncMetrics:
    return _bundle("statesync", StateSyncMetrics)


def reset_bundles() -> None:
    """Drop every bundle and empty DEFAULT_REGISTRY in place (tests)."""
    with _BUNDLES_LOCK:
        _BUNDLES.clear()
        DEFAULT_REGISTRY.clear()
