"""Prometheus-style metrics: the port's minimal copy of the parts of
`cometbft_tpu/utils/metrics.py` that the crypto dispatch records.

Counter, Gauge and Histogram with labels on one `Registry`, and the
`CryptoMetrics` bundle the verifier, the commit consumers and the shared
scheduler feed (`batch_size`, `path_selected_total` and `verify_seconds`
by path and curve, `calibration_us_per_sig`, `sched_queue_depth`,
`sched_coalesced_total`, `sched_batch_sigs`) under the reference's names,
so the two backends' metrics line up.
`crypto_metrics()` hands out the process's bundle against
`DEFAULT_REGISTRY`; `reset_bundles()` clears both (tests).
"""

from __future__ import annotations

import threading

NAMESPACE = "cometbft"


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

    def observe(self, value: float, *labels) -> None:
        key = self._key(tuple(labels))
        with self._lock:
            counts = self._counts.setdefault(key, [0] * (len(self.buckets) + 1))
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
            counts[-1] += 1  # +Inf
            self._sums[key] = self._sums.get(key, 0.0) + value

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


_bundle = None
_bundle_lock = threading.Lock()


def crypto_metrics() -> CryptoMetrics:
    global _bundle
    with _bundle_lock:
        if _bundle is None:
            _bundle = CryptoMetrics()
        return _bundle


def reset_bundles() -> None:
    """Drop the bundle and empty DEFAULT_REGISTRY in place (tests)."""
    global _bundle
    with _bundle_lock:
        _bundle = None
        DEFAULT_REGISTRY.clear()
