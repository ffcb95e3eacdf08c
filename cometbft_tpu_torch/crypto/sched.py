"""Shared verification scheduler: one dispatcher, N tenants.

Twin of `cometbft_tpu/crypto/sched.py` for the port's Ed25519 verifier.
Every verify consumer (consensus commit validation, blocksync replay
windows, light-serve cache misses, mempool admission windows) can hand
its filled verifier to ONE scheduler between it and the crypto dispatch:

  consumers --submit(filled verifier, tenant, source)--> per-tenant
  per-class queues --drainer--> coalesced mega-batch (absorb() merges
  the filled verifiers lane-exactly, recording each request's
  [start, end) range) --> ONE dispatch through the verifier's routes
  (native / ladder / RLC / delta) --> per-request verdict slices,
  bit-exact vs what each consumer's own dispatch would have returned.

Scheduling policy:

* Priority classes order service strictly: consensus > blocksync >
  light > background (admission rides in background).
* Within a class, tenants are served by deficit round-robin weighted
  by signature count: each round an active tenant's deficit grows by
  ``quantum_sigs * weight`` and it may dequeue requests while its head
  fits the deficit, so a hot tenant's share of any contended mega-batch
  is bounded by weight/(total weight) plus one request of slack.
* Coalescing window: the drainer collects until ``max_coalesce_sigs``
  or until the OLDEST queued request has waited ``max_coalesce_delay_ms``,
  whichever comes first. Single-waiter fast path: when exactly one
  request is queued when the drainer looks, it dispatches at once.

Lifecycle: lazy drainer start on first submit; ``stop()`` drains what it
can, then fails queued AND in-flight futures with tenant context after
``stop_timeout_s``; ``close()`` also refuses later submits.

The scheduler takes ``device=`` ("cuda" by default, "cpu" for the
kernels' plain versions) where the reference takes ``backend=``, and
``acquire_shared()/release_shared()`` refcount one process-wide
scheduler per device. ``verify_context()`` is the thread-local seam
`types/validation.py` consults, so verify_commit callers route their
Ed25519 batch through the scheduler without a new argument.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future

from ..utils import trace as _trace
from ..utils.metrics import crypto_metrics
from . import ed25519 as _ed

# strict service order; unknown sources verify at background priority
PRIORITY_CLASS = {
    "consensus": 0,
    "blocksync": 1,
    "light": 2,
    "admission": 3,
    "background": 3,
}
_N_CLASSES = 4


class _Request:
    __slots__ = ("bv", "tenant", "source", "prio", "n", "t_enqueue",
                 "future")

    def __init__(self, bv, tenant: str, source: str, prio: int):
        self.bv = bv
        self.tenant = tenant
        self.source = source
        self.prio = prio
        self.n = bv.count()
        self.t_enqueue = time.perf_counter()
        self.future: Future = Future()


class SchedPending:
    """Pending-compatible handle (.result()/.prefetch()) over a
    scheduler future, interchangeable with PendingBatch where consumers
    hold one — blocksync's window pipeline calls prefetch() on it."""

    __slots__ = ("_future",)

    def __init__(self, future: Future):
        self._future = future

    def prefetch(self) -> None:
        # dispatch and the device fetch happen on the drainer thread;
        # there is nothing for the consumer to start early
        return None

    def result(self, timeout: float | None = None) -> tuple[bool, list[bool]]:
        return self._future.result(timeout)


def _fail(fut: Future, exc: Exception) -> None:
    if not fut.done():
        try:
            fut.set_exception(exc)
        except Exception:  # noqa: BLE001 — lost the resolution race
            pass


def _resolve(fut: Future, value) -> None:
    if not fut.done():
        try:
            fut.set_result(value)
        except Exception:  # noqa: BLE001 — lost the resolution race
            pass


class VerifyScheduler:
    """Coalescing verify dispatcher with per-tenant weighted fairness.
    A scheduler made for "cuda" on a host without a GPU raises."""

    def __init__(
        self,
        device="cuda",
        max_coalesce_sigs: int = 16384,
        max_coalesce_delay_ms: float = 2.0,
        stop_timeout_s: float = 2.0,
        quantum_sigs: int = 512,
        manual: bool = False,
    ):
        self.device = _ed._resolve_device(device)
        self.max_coalesce_sigs = max(1, int(max_coalesce_sigs))
        self.max_coalesce_delay_s = max(0.0, float(max_coalesce_delay_ms)) / 1e3
        self.stop_timeout_s = float(stop_timeout_s)
        self.quantum_sigs = max(1, int(quantum_sigs))
        # manual mode (tests + deterministic measurement): no drainer
        # thread; callers pump batches with drain_once()
        self.manual = manual
        # queues[tenant][prio] -> deque[_Request]; _order preserves
        # first-seen tenant order for round-robin stability
        self._queues: dict[str, list[deque]] = {}
        self._order: list[str] = []
        self._weights: dict[str, float] = {}
        self._deficit: dict[str, float] = {}
        self._cv = threading.Condition()
        self._thread: threading.Thread | None = None
        self._stopped = False
        self._closed = False
        self._inflight: list[_Request] = []
        self._n_queued = 0
        # counters a workload can snapshot: dispatches is the number the
        # coalescing win is measured on (dispatch calls per 1k sigs)
        self.stats = {
            "requests": 0, "sigs": 0, "dispatches": 0,
            "coalesced_requests": 0, "passthrough": 0,
        }
        self._tenant_sigs: dict[str, int] = {}

    # -- producer side ---------------------------------------------------
    def submit(self, bv, tenant: str = "default",
               source: str = "background") -> SchedPending:
        """Enqueue a filled Ed25519BatchVerifier; the returned handle's
        result() is bit-exact with what ``bv.verify()`` would return."""
        prio = PRIORITY_CLASS.get(source, _N_CLASSES - 1)
        req = _Request(bv, tenant, source, prio)
        if req.n == 0:
            # match Ed25519BatchVerifier.verify() on an empty batch
            _resolve(req.future, (False, []))
            return SchedPending(req.future)
        with self._cv:
            if self._closed:
                _fail(req.future,
                      RuntimeError("verify scheduler closed"))
                return SchedPending(req.future)
            if not self.manual and (self._stopped or self._thread is None):
                # lazy start, admission-pipeline style: first submit
                # after construction (or stop()) spins the drainer up
                self._stopped = False
                if self._thread is None:
                    self._thread = threading.Thread(
                        target=self._drain_loop, daemon=True,
                        name="verify-sched",
                    )
                    self._thread.start()
            q = self._queues.get(tenant)
            if q is None:
                q = self._queues[tenant] = [deque() for _ in range(_N_CLASSES)]
                self._order.append(tenant)
            q[req.prio].append(req)
            self._n_queued += 1
            self.stats["requests"] += 1
            self.stats["sigs"] += req.n
            self._tenant_sigs[tenant] = \
                self._tenant_sigs.get(tenant, 0) + req.n
            crypto_metrics().sched_queue_depth.set(
                sum(len(d) for d in q), tenant)
            self._cv.notify()
        return SchedPending(req.future)

    def set_tenant_weight(self, tenant: str, weight: float) -> None:
        with self._cv:
            self._weights[tenant] = max(0.01, float(weight))

    def tenant_stats(self) -> dict[str, int]:
        """Per-tenant signatures accepted (fairness accounting)."""
        with self._cv:
            return dict(self._tenant_sigs)

    # -- lifecycle -------------------------------------------------------
    def stop(self) -> None:
        """Stop the drainer; queued and in-flight requests it could not
        finish within stop_timeout_s fail with tenant context."""
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
        t = self._thread
        if t is not None:
            t.join(timeout=self.stop_timeout_s)
        self._thread = None
        with self._cv:
            orphans: list[_Request] = []
            for q in self._queues.values():
                for d in q:
                    orphans.extend(d)
                    d.clear()
            self._n_queued = 0
            orphans.extend(self._inflight)
            for tenant in self._queues:
                crypto_metrics().sched_queue_depth.set(0.0, tenant)
        for req in orphans:
            _fail(req.future, RuntimeError(
                f"verify scheduler stopped: {req.n}-sig {req.source} "
                f"request from tenant {req.tenant!r} abandoned"))

    def close(self) -> None:
        """Terminal stop: later submits error immediately."""
        with self._cv:
            self._closed = True
        self.stop()

    # -- drainer ---------------------------------------------------------
    def _drain_loop(self) -> None:
        while True:
            batch = self._collect()
            if batch is None:
                return
            if batch:
                self._dispatch(batch)

    def _collect(self) -> list[_Request] | None:
        """Wait for work, linger for the coalescing window, pop one
        DRR-ordered batch. None = stopped with nothing queued."""
        with self._cv:
            while self._n_queued == 0 and not self._stopped:
                self._cv.wait()
            if self._n_queued == 0 and self._stopped:
                return None
            oldest = min(
                d[0].t_enqueue
                for q in self._queues.values() for d in q if d)
            deadline = oldest + self.max_coalesce_delay_s
            while (not self._stopped
                   and self._n_queued > 1
                   and self._queued_sigs() < self.max_coalesce_sigs):
                left = deadline - time.perf_counter()
                if left <= 0:
                    break
                self._cv.wait(timeout=left)
            # single-waiter fast path falls straight through: with one
            # request queued the while above never runs, so an idle
            # tenant's request dispatches with zero added latency
            batch = self._take_batch()
            self._inflight = batch
            return batch

    def _queued_sigs(self) -> int:
        return sum(r.n for q in self._queues.values() for d in q for r in d)

    def _take_batch(self) -> list[_Request]:
        """Pop up to max_coalesce_sigs of queued requests in (priority,
        weighted-DRR) order. Caller holds the lock."""
        batch: list[_Request] = []
        sigs = 0
        for prio in range(_N_CLASSES):
            while sigs < self.max_coalesce_sigs:
                active = [t for t in self._order
                          if self._queues[t][prio]]
                if not active:
                    break
                progressed = False
                for tenant in active:
                    d = self._queues[tenant][prio]
                    if not d:
                        continue
                    self._deficit[tenant] = (
                        self._deficit.get(tenant, 0.0)
                        + self.quantum_sigs * self._weights.get(tenant, 1.0))
                    while d and sigs < self.max_coalesce_sigs:
                        req = d[0]
                        if req.n > self._deficit[tenant]:
                            break
                        if batch and sigs + req.n > self.max_coalesce_sigs:
                            break  # request waits for the next batch
                        d.popleft()
                        self._n_queued -= 1
                        self._deficit[tenant] -= req.n
                        batch.append(req)
                        sigs += req.n
                        progressed = True
                    if not d:
                        # idle flows carry no credit into the next
                        # contention period (standard DRR reset)
                        self._deficit[tenant] = 0.0
                if not progressed and sigs > 0:
                    break
                if not progressed and sigs == 0:
                    # every head exceeds its deficit: keep accumulating
                    # rounds — bounded, since deficits grow by at least
                    # quantum_sigs * min_weight per round
                    continue
            if sigs >= self.max_coalesce_sigs:
                break
        for tenant in self._order:
            crypto_metrics().sched_queue_depth.set(
                sum(len(d) for d in self._queues[tenant]), tenant)
        return batch

    def _dispatch(self, batch: list[_Request]) -> None:
        """ONE crypto dispatch for the whole batch; per-request verdicts
        recovered from the mega-bitmap by recorded lane ranges."""
        m = crypto_metrics()
        n_req = len(batch)
        try:
            if n_req == 1:
                # pass-through: the lone request's verifier dispatches
                # as-is — no absorb copy, no coalescing tax
                req = batch[0]
                self.stats["dispatches"] += 1
                self.stats["passthrough"] += 1
                m.sched_batch_sigs.observe(req.n)
                t0 = time.perf_counter()
                ok, bits = req.bv.verify()
                if _trace.enabled:
                    _trace.emit(
                        "crypto.sched_coalesce", "span",
                        dur_ms=round((time.perf_counter() - t0) * 1e3, 3),
                        n_requests=1, sigs=req.n, tenants=req.tenant,
                        sources=req.source,
                        per_tenant_sigs={req.tenant: req.n})
                _resolve(req.future, (ok, bits))
                return
            mega = _ed.Ed25519BatchVerifier(device=self.device)
            ranges: list[tuple[int, int]] = []
            per_tenant: dict[str, int] = {}
            for req in batch:
                ranges.append(mega.absorb(req.bv))
                per_tenant[req.tenant] = \
                    per_tenant.get(req.tenant, 0) + req.n
                m.sched_coalesced_total.inc(1.0, req.source)
            self.stats["dispatches"] += 1
            self.stats["coalesced_requests"] += n_req
            m.sched_batch_sigs.observe(mega.count())
            tenants = ",".join(sorted(per_tenant))
            sources = ",".join(sorted({r.source for r in batch}))
            t0 = time.perf_counter()
            ok_all, bits_all = mega.verify()
            dur_ms = round((time.perf_counter() - t0) * 1e3, 3)
            if _trace.enabled:
                _trace.emit("crypto.sched_coalesce", "span",
                            dur_ms=dur_ms, n_requests=n_req,
                            sigs=mega.count(), tenants=tenants,
                            sources=sources, per_tenant_sigs=per_tenant)
            for req, (start, end) in zip(batch, ranges):
                bits = bits_all[start:end]
                _resolve(req.future, (all(bits), bits))
        except Exception as exc:  # noqa: BLE001 — deliver, don't die
            for req in batch:
                _fail(req.future, RuntimeError(
                    f"verify dispatch failed for tenant "
                    f"{req.tenant!r} ({req.source}): {exc}"))
        finally:
            with self._cv:
                self._inflight = []

    # -- manual pump (tests, deterministic measurement) ------------------
    def drain_once(self) -> int:
        """Form and dispatch one batch from whatever is queued right
        now; returns the number of requests dispatched. Only meaningful
        in manual mode (no drainer thread to race with)."""
        with self._cv:
            batch = self._take_batch()
            self._inflight = batch
        if batch:
            self._dispatch(batch)
        return len(batch)


# ----------------------------------------------------------------------
# thread-local routing context: verify_commit callers wrap their call in
# verify_context(...) and types/validation.py routes ed25519 batch
# groups through the scheduler without new plumbing in every signature.
# ----------------------------------------------------------------------
class _Ctx:
    __slots__ = ("sched", "tenant", "source")

    def __init__(self, sched: VerifyScheduler, tenant: str, source: str):
        self.sched = sched
        self.tenant = tenant
        self.source = source

    def submit(self, bv) -> SchedPending:
        return self.sched.submit(bv, tenant=self.tenant, source=self.source)


_tls = threading.local()


class verify_context:
    """``with verify_context(sched, tenant, source):`` — route ed25519
    batch verification inside the block to the shared scheduler. Nestable;
    a None scheduler makes the block a no-op (config-off wiring stays
    branch-free at call sites)."""

    def __init__(self, sched: VerifyScheduler | None, tenant: str,
                 source: str):
        self._ctx = _Ctx(sched, tenant, source) if sched is not None else None
        self._prev = None

    def __enter__(self):
        self._prev = getattr(_tls, "ctx", None)
        if self._ctx is not None:
            _tls.ctx = self._ctx
        return self

    def __exit__(self, *exc):
        if self._ctx is not None:
            _tls.ctx = self._prev
        return False


def current_context() -> _Ctx | None:
    return getattr(_tls, "ctx", None)


# ----------------------------------------------------------------------
# process-wide shared scheduler: N nodes (N chains) in one process share
# one scheduler per device.
# ----------------------------------------------------------------------
_shared: dict[str, tuple[VerifyScheduler, int]] = {}
_shared_lock = threading.Lock()


def acquire_shared(device="cuda", **cfg) -> VerifyScheduler:
    """Refcounted per-device singleton. The first acquirer's config
    wins (one scheduler can only have one coalescing policy); later
    acquirers share it as additional tenants."""
    key = str(_ed._resolve_device(device))
    with _shared_lock:
        ent = _shared.get(key)
        if ent is None or ent[0]._closed:
            s = VerifyScheduler(device=key, **cfg)
            _shared[key] = (s, 1)
            return s
        s, refs = ent
        _shared[key] = (s, refs + 1)
        return s


def release_shared(sched: VerifyScheduler) -> None:
    """Drop one reference; the last release closes the scheduler."""
    with _shared_lock:
        for key, (s, refs) in list(_shared.items()):
            if s is sched:
                if refs <= 1:
                    del _shared[key]
                    break
                _shared[key] = (s, refs - 1)
                return
    if sched is not None:
        sched.close()
