"""Micro-batched CheckTx admission pipeline (twin of
`cometbft_tpu/mempool/admission.py`; the pipeline takes `device=`,
"cuda" by default and "cpu" for the kernels' plain versions, where the
reference takes `backend=`, and a "cuda" pipeline on a host without a
GPU raises when it is made).

The per-tx admission path costs, for every tx: one app round-trip under
the mempool lock, one signature verify (when txs are signed), and one
lock acquisition — all serialized. Under sustained ingress from many
concurrent `broadcast_tx_*` callers and gossiping peers, those per-tx
costs dominate. This pipeline amortizes all three over a window:

  RPC handlers / peer receives --submit()--> admission queue
                                                  |
                             drainer collects a window
                             (<= `window` txs or `max_delay_s`)
                                                  |
            stage 0: per-tx prechecks, lock-free (size, LRU dedup)
            stage 1: ONE batch signature verify for the window
                     (crypto dispatch — the same engine that runs the
                     commit-verify mega-batches; through the shared
                     VerifyScheduler when one is given, so concurrent
                     tenants' windows coalesce)
            stage 2: ONE batched app CheckTx round (`check_txs`),
                     no mempool lock held
            stage 3: mempool lock taken ONCE, survivors inserted FIFO
                                                  |
                       per-tx futures resolve -> blocked callers

`check_tx()` blocks on the tx's future and re-raises the per-tx error,
so `broadcast_tx_sync` semantics are identical to the direct path; only
the cost model changes. Lock-order note: the drainer takes the app lock
(inside `check_txs`) and the mempool lock at *disjoint* times, never
nested, while the consensus executor takes mempool-then-app — since the
drainer never holds the app lock while waiting on the mempool lock,
there is no ABBA deadlock.

Signed-tx envelope: txs of the form

    b"STX\\x01" | pub(32) | sig(64) | payload

get their ed25519 signature checked in stage 1 (sig over
``SIGN_CONTEXT + payload``); bare txs skip stage 1. The KVStore app
parses the payload's ``key=value`` regardless, so signed load rides
through the whole stack unchanged.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future

from ..crypto.ed25519 import Ed25519BatchVerifier, Ed25519PubKey, _resolve_device
from ..utils.metrics import mempool_metrics
from ..utils import trace as _trace
from ..utils import txlife as _txlife

STX_MAGIC = b"STX\x01"
SIGN_CONTEXT = b"cometbft-tpu/tx/v1"
_STX_HEADER = len(STX_MAGIC) + 32 + 64


def wrap_signed_tx(priv, payload: bytes) -> bytes:
    """Envelope `payload` with the signer's pubkey and signature."""
    sig = priv.sign(SIGN_CONTEXT + payload)
    return STX_MAGIC + priv.pub_key().bytes() + sig + payload


def parse_signed_tx(tx: bytes):
    """(pub_bytes, sig, payload) for an STX envelope, else None."""
    if not tx.startswith(STX_MAGIC) or len(tx) < _STX_HEADER:
        return None
    off = len(STX_MAGIC)
    return tx[off:off + 32], tx[off + 32:off + 96], tx[_STX_HEADER:]


def _fail(fut: Future, exc: Exception) -> None:
    """Fail a per-tx future, tolerating resolution races: stop() may
    fail an in-flight window that a wedged drainer later resolves (or
    the reverse), and a future must only be resolved once."""
    if not fut.done():
        try:
            fut.set_exception(exc)
        except Exception:  # noqa: BLE001 — lost the race, already done
            pass


def _ok(fut: Future) -> None:
    if not fut.done():
        try:
            fut.set_result(None)
        except Exception:  # noqa: BLE001 — lost the race, already done
            pass


class _Entry:
    __slots__ = ("tx", "from_peer", "future", "t_enqueue", "key",
                 "gas_wanted")

    def __init__(self, tx: bytes, from_peer: str):
        self.tx = tx
        self.from_peer = from_peer
        self.future: Future = Future()
        self.t_enqueue = time.perf_counter()
        self.key = None
        self.gas_wanted = 0


class AdmissionPipeline:
    """Window drainer over an admission queue feeding a CListMempool."""

    def __init__(
        self,
        mempool,
        window: int = 256,
        max_delay_s: float = 0.002,
        verify_sigs: bool = True,
        device="cuda",
        queue_limit: int = 0,
        sched=None,
        tenant: str = "",
    ):
        self.mempool = mempool
        self.window = max(1, int(window))
        self.max_delay_s = max(0.0, float(max_delay_s))
        self.verify_sigs = verify_sigs
        self.device = _resolve_device(device)
        self.sched = sched  # shared VerifyScheduler (crypto/sched.py)
        self.tenant = tenant
        # 0 = derive from window: enough backlog to keep the drainer fed
        # without letting a stalled app grow the queue unboundedly
        self.queue_limit = queue_limit or self.window * 64
        self._q: deque[_Entry] = deque()
        self._cv = threading.Condition()
        self._thread: threading.Thread | None = None
        self._stopped = False
        self._closed = False
        # window the drainer popped but has not finished processing —
        # stop() fails these too when the drainer won't exit in time
        self._inflight: list[_Entry] = []
        self.stop_timeout_s = 2.0

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        with self._cv:
            if self._thread is not None:
                return
            self._stopped = False
            self._thread = threading.Thread(
                target=self._drain_loop, daemon=True, name="mempool-admit"
            )
            self._thread.start()

    def stop(self) -> None:
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
        t = self._thread
        if t is not None:
            t.join(timeout=self.stop_timeout_s)
        self._thread = None
        # Fail whatever is still queued so blocked callers unblock — and
        # when the drainer did not exit within the timeout (wedged in a
        # slow app CheckTx round, say), the in-flight window too:
        # nobody else will ever resolve those futures. _fail/_ok
        # tolerate the drainer limping in later.
        with self._cv:
            pending = list(self._q)
            self._q.clear()
            pending.extend(self._inflight)
        exc = RuntimeError("admission pipeline stopped")
        for e in pending:
            _fail(e.future, exc)

    def close(self) -> None:
        """Terminal stop for node shutdown: also refuses future submits
        (no lazy drainer restart — late callers get an immediate error
        instead of parking on a queue nobody drains)."""
        with self._cv:
            self._closed = True
        self.stop()

    # -- producer side -----------------------------------------------------
    def submit(self, tx: bytes, from_peer: str = "") -> Future:
        """Enqueue a tx; the returned future resolves to None on
        admission or raises the per-tx rejection."""
        e = _Entry(tx, from_peer)
        with self._cv:
            if self._closed:
                e.future.set_exception(
                    RuntimeError("admission pipeline closed"))
                return e.future
            if self._stopped or self._thread is None:
                # lazy start: the first submit after construction (or a
                # node that never called start()) spins the drainer up
                self._stopped = False
                if self._thread is None:
                    self._thread = threading.Thread(
                        target=self._drain_loop, daemon=True,
                        name="mempool-admit",
                    )
                    self._thread.start()
            if len(self._q) >= self.queue_limit:
                e.future.set_exception(
                    ErrAdmissionQueueFull(len(self._q), self.queue_limit))
                return e.future
            self._q.append(e)
            mempool_metrics().admit_queue_depth.set(len(self._q))
            self._cv.notify()
        if _txlife.enabled:
            _txlife.track(tx, "enqueue")
        return e.future

    def check_tx(self, tx: bytes, from_peer: str = "") -> None:
        """Blocking facade with direct-path semantics: raises the same
        ErrTxInCache/ErrMempoolFull/ErrTxTooLarge/ValueError the caller
        would get from CListMempool.check_tx."""
        self.submit(tx, from_peer).result()

    # -- drainer -----------------------------------------------------------
    def _drain_loop(self) -> None:
        while True:
            batch: list[_Entry] = []
            with self._cv:
                while not self._q and not self._stopped:
                    self._cv.wait()
                if self._stopped:
                    return
                # first tx opens the window; linger up to max_delay_s
                # for the window to fill (latency bound), then drain up
                # to `window` txs (size bound)
                deadline = self._q[0].t_enqueue + self.max_delay_s
                while (len(self._q) < self.window
                       and not self._stopped):
                    left = deadline - time.perf_counter()
                    if left <= 0:
                        break
                    self._cv.wait(timeout=left)
                while self._q and len(batch) < self.window:
                    batch.append(self._q.popleft())
                self._inflight = batch
                mempool_metrics().admit_queue_depth.set(len(self._q))
            if batch:
                try:
                    self._process_window(batch)
                except Exception as exc:  # noqa: BLE001 — deliver, don't die
                    for e in batch:
                        _fail(e.future, exc)
                finally:
                    with self._cv:
                        self._inflight = []

    def _process_window(self, batch: list[_Entry]) -> None:
        m = mempool_metrics()
        t0 = time.perf_counter()
        m.admit_window_size.observe(len(batch))

        # stage 0 — lock-free prechecks: oversize, LRU dedup (which also
        # collapses duplicates WITHIN the window: cache.push is
        # first-wins), fast-fail when the pool is already full
        live: list[_Entry] = []
        for e in batch:
            try:
                e.key = self.mempool.precheck(e.tx)
            except Exception as exc:  # noqa: BLE001 — per-tx verdict
                _fail(e.future, exc)
                continue
            live.append(e)
        n_dup = len(batch) - len(live)

        # stage 1 — one batch signature verify for the window's signed
        # envelopes, through the crypto dispatch (native/rlc/ladder)
        n_sig_fail = 0
        t1 = time.perf_counter()
        if _txlife.enabled:
            for e in live:
                _txlife.stage_key(e.key, "verify_start")
        if self.verify_sigs and live:
            live, n_sig_fail = self._verify_stage(live)
        t2 = time.perf_counter()
        if _txlife.enabled:
            for e in live:
                _txlife.stage_key(e.key, "verify_end")

        # stage 2 — one batched app CheckTx round; no mempool lock held
        n_app_fail = 0
        if live:
            results = self.mempool.app_check_batch([e.tx for e in live])
            kept: list[_Entry] = []
            for e, res in zip(live, results):
                if res.code != 0:
                    self.mempool.note_rejected(e.key)
                    _fail(e.future,
                          ValueError(f"tx rejected by app: code {res.code}"))
                    n_app_fail += 1
                    continue
                e.gas_wanted = res.gas_wanted
                kept.append(e)
            live = kept
        t3 = time.perf_counter()
        if _txlife.enabled:
            for e in live:
                _txlife.stage_key(e.key, "app_check")

        # stage 3 — single lock acquisition: insert survivors FIFO
        admitted: list[bytes] = []
        if live:
            errs = self.mempool.insert_batch(
                [(e.key, e.tx, e.gas_wanted) for e in live])
            for e, err in zip(live, errs):
                if err is not None:
                    _fail(e.future, err)
                else:
                    admitted.append(e.tx)
                    if _txlife.enabled:
                        _txlife.stage_key(e.key, "insert")
                    _ok(e.future)
        t4 = time.perf_counter()

        for e in batch:
            if e.future.done() and e.future.exception() is None:
                m.admit_latency.observe(t4 - e.t_enqueue)
        if admitted:
            self.mempool.notify_new_txs(admitted)
        if _trace.enabled:
            _trace.emit(
                "mempool.admit_window", "span",
                tenant=self.tenant,
                n=len(batch), dup=n_dup, sig_fail=n_sig_fail,
                app_fail=n_app_fail, admitted=len(admitted),
                sig_ms=round((t2 - t1) * 1e3, 3),
                app_ms=round((t3 - t2) * 1e3, 3),
                insert_ms=round((t4 - t3) * 1e3, 3),
                dur_ms=round((t4 - t0) * 1e3, 3),
            )

    def _verify_stage(self, live: list["_Entry"]):
        """One batch verify over the window's STX envelopes; rejects txs
        whose signature fails. Bare (non-envelope) txs pass through."""
        vf = None
        signed: list[tuple[int, bool]] = []  # (live index, precheck ok)
        for i, e in enumerate(live):
            parsed = parse_signed_tx(e.tx)
            if parsed is None:
                continue
            pub, sig, payload = parsed
            if vf is None:
                vf = Ed25519BatchVerifier(device=self.device)
            try:
                ok = vf.add(Ed25519PubKey(pub), SIGN_CONTEXT + payload, sig)
            except ValueError:
                ok = False
            signed.append((i, ok))
        if vf is None or not signed:
            return live, 0
        if self.sched is not None:
            _all_ok, bits = self.sched.submit(
                vf, tenant=self.tenant, source="admission").result()
        else:
            _all_ok, bits = vf.verify()
        bad: set[int] = set()
        for (i, pre_ok), bit in zip(signed, bits):
            if not (pre_ok and bit):
                bad.add(i)
        if not bad:
            return live, 0
        kept = []
        for i, e in enumerate(live):
            if i in bad:
                self.mempool.note_rejected(e.key)  # counts failed_txs
                _fail(e.future,
                      ValueError("tx rejected: invalid signature"))
            else:
                kept.append(e)
        return kept, len(bad)


class ErrAdmissionQueueFull(Exception):
    def __init__(self, depth, limit):
        super().__init__(f"admission queue full: {depth} >= {limit}")
