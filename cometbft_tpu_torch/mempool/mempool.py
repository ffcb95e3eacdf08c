"""Transaction mempool (twin of `cometbft_tpu/mempool/mempool.py`).

Behavior parity: reference mempool/clist_mempool.go —
- CheckTx admission through the app's mempool connection (:252 CheckTx,
  :389 resCbFirstTime): only code==OK txs enter the pool; everything seen
  recently sits in an LRU dedup cache (mempool/cache.go:35 LRUTxCache).
- Ordering: FIFO insertion order (the reference's concurrent linked list
  collapses to an ordered dict under Python's GIL; the wait/gossip seam
  is the on_new_tx/on_new_txs callbacks).
- Reap honors max_bytes/max_gas (:~500 ReapMaxBytesMaxGas).
- Update after a committed block (:~560): committed txs leave the pool
  (and stay in cache so peers can't replay them); survivors are
  re-CheckTx'd (recheck) because the app state changed.
- Lock/Unlock around proposal creation + update (reference Mempool
  interface, mempool/mempool.go:145).

Admission is split into lock-free prechecks, an UNLOCKED app CheckTx
round, and a locked insert — so the mempool lock is never held across
an app (or signature) call on the admission path. The micro-batched
pipeline (mempool/admission.py) drives the same three stages once per
window; the direct path here is the window-of-one degenerate case.
Gossip callbacks fire from a dedicated notifier thread, never from the
admitting (RPC/peer) thread, so a slow subscriber cannot stall
admission. The direct path's signature check (`verify_sigs`) is one
host verify a tx through the port's `Ed25519PubKey`.
"""

from __future__ import annotations

import hashlib
import threading

from ..utils.metrics import mempool_metrics
from ..utils import txlife as _txlife
from .txcolumns import TxColumns
from collections import OrderedDict, deque
from dataclasses import dataclass


def TxKey(tx: bytes) -> bytes:
    return hashlib.sha256(tx).digest()


class LRUTxCache:
    """Fixed-size LRU of tx keys (reference mempool/cache.go:35)."""

    def __init__(self, size: int = 10000):
        self._size = size
        self._map: OrderedDict[bytes, None] = OrderedDict()
        self._lock = threading.Lock()

    def push(self, key: bytes) -> bool:
        """False if already present (moves it to front like the reference)."""
        with self._lock:
            if key in self._map:
                self._map.move_to_end(key)
                return False
            self._map[key] = None
            if len(self._map) > self._size:
                self._map.popitem(last=False)
            return True

    def remove(self, key: bytes) -> None:
        with self._lock:
            self._map.pop(key, None)

    def has(self, key: bytes) -> bool:
        with self._lock:
            return key in self._map

    def reset(self) -> None:
        with self._lock:
            self._map.clear()


@dataclass
class _MempoolTx:
    tx: bytes
    height: int  # height when admitted
    gas_wanted: int


class ErrTxInCache(Exception):
    pass


class ErrMempoolFull(Exception):
    def __init__(self, size, max_size):
        super().__init__(f"mempool full: {size} >= {max_size}")


class ErrTxTooLarge(Exception):
    pass


class CListMempool:
    def __init__(
        self,
        app_conns,
        max_txs: int = 5000,
        max_tx_bytes: int = 1024 * 1024,
        cache_size: int = 10000,
        keep_invalid_txs_in_cache: bool = False,
        recheck_window: int = 256,
        verify_sigs: bool = False,
    ):
        self.app = app_conns
        self.max_txs = max_txs
        self.max_tx_bytes = max_tx_bytes
        self.keep_invalid = keep_invalid_txs_in_cache
        self.recheck_window = max(1, recheck_window)
        # verify STX-enveloped tx signatures at admission even on the
        # direct (pipeline-less) path — one native single-verify per tx,
        # the honest per-tx baseline the batched pipeline amortizes
        self.verify_sigs = verify_sigs
        self.cache = LRUTxCache(cache_size)
        self._txs: OrderedDict[bytes, _MempoolTx] = OrderedDict()
        self._lock = threading.RLock()  # the consensus Lock/Unlock seam
        self._bytes = 0  # running byte total (total_bytes was an O(N) scan)
        # monotonic pool-content version: bumped whenever the set of
        # reapable txs changes (insert/update/flush). The speculative
        # proposal seam compares versions across the speculation window
        # — a bump means the reap it ran is stale and the block must be
        # discarded.
        self.version = 0
        self.height = 0
        # gossip seams (p2p reactor subscribes): on_new_txs gets the
        # whole admitted window in one call; on_new_tx is the legacy
        # per-tx form. Both fire from the notifier thread.
        self.on_new_tx: list = []
        self.on_new_txs: list = []
        self._notify_q: deque[list[bytes]] = deque(maxlen=1024)
        self._notify_cv = threading.Condition()
        self._notify_thread: threading.Thread | None = None
        self._notify_stopped = False
        # optional micro-batched admission pipeline; when attached,
        # check_tx/submit_tx route through it
        self.pipeline = None

    # -- Mempool interface -------------------------------------------------
    def lock(self) -> None:
        self._lock.acquire()

    def unlock(self) -> None:
        self._lock.release()

    def size(self) -> int:
        return len(self._txs)

    def total_bytes(self) -> int:
        return self._bytes

    # -- admission stages (shared by the direct path and the pipeline) ----
    def precheck(self, tx: bytes) -> bytes:
        """Lock-free per-tx admission prechecks: oversize, LRU dedup,
        fast-fail on a full pool. Returns the tx key; raises the per-tx
        rejection. Claims the cache slot (first-wins), so the caller
        owns cleanup on later rejection (note_rejected)."""
        if len(tx) > self.max_tx_bytes:
            raise ErrTxTooLarge(f"tx {len(tx)}B > {self.max_tx_bytes}B")
        key = TxKey(tx)
        if not self.cache.push(key):
            raise ErrTxInCache(f"tx {key.hex()[:12]} already seen")
        if len(self._txs) >= self.max_txs:
            self.cache.remove(key)
            raise ErrMempoolFull(len(self._txs), self.max_txs)
        return key

    def app_check_batch(self, txs: list[bytes]) -> list:
        """One app CheckTx round for a window of txs. Uses the client's
        batched `check_txs` when it has one (LocalClient: one shared-
        mutex acquisition per window; SocketClient: pipelined requests),
        else falls back to per-tx calls. Never called with the mempool
        lock held on the admission path."""
        conn = self.app.mempool
        fn = getattr(conn, "check_txs", None)
        if fn is not None:
            res = fn(txs)
            if res is not None and len(res) == len(txs):
                return res
        return [conn.check_tx(tx) for tx in txs]

    def note_rejected(self, key: bytes) -> None:
        """Bookkeeping for a tx rejected after precheck claimed its
        cache slot (app code != 0 or bad signature)."""
        if not self.keep_invalid:
            self.cache.remove(key)
        mempool_metrics().failed_txs.inc()

    def insert_batch(self, items: list[tuple[bytes, bytes, int]]):
        """Insert app-approved txs FIFO under ONE lock acquisition.
        items = [(key, tx, gas_wanted)]; returns a per-item list of
        None (inserted) or the rejection to deliver to that caller."""
        errs: list = []
        m = mempool_metrics()
        with self._lock:
            for key, tx, gas_wanted in items:
                if len(self._txs) >= self.max_txs:
                    self.cache.remove(key)
                    errs.append(ErrMempoolFull(len(self._txs), self.max_txs))
                    continue
                if key in self._txs:  # lost a race to an identical tx
                    errs.append(ErrTxInCache(f"tx {key.hex()[:12]} already seen"))
                    continue
                self._txs[key] = _MempoolTx(tx, self.height, gas_wanted)
                self._bytes += len(tx)
                errs.append(None)
                self.version += 1
            m.size.set(len(self._txs))
            m.tx_bytes.set(self._bytes)
        return errs

    # -- gossip notifier ---------------------------------------------------
    def notify_new_txs(self, txs: list[bytes]) -> None:
        """Hand newly admitted txs to the gossip subscribers from a
        dedicated thread — the admitting (RPC/peer/drainer) thread never
        runs subscriber code, so a slow peer cannot stall admission."""
        if not txs or not (self.on_new_tx or self.on_new_txs):
            return
        with self._notify_cv:
            if self._notify_stopped:
                return
            if self._notify_thread is None:
                self._notify_thread = threading.Thread(
                    target=self._notify_loop, daemon=True,
                    name="mempool-notify",
                )
                self._notify_thread.start()
            self._notify_q.append(list(txs))
            self._notify_cv.notify()

    def _notify_loop(self) -> None:
        while True:
            with self._notify_cv:
                while not self._notify_q and not self._notify_stopped:
                    self._notify_cv.wait()
                if self._notify_stopped:
                    return
                txs = self._notify_q.popleft()
            for cb in self.on_new_txs:
                try:
                    cb(txs)
                except Exception:  # noqa: BLE001 — subscriber bug ≠ mempool bug
                    pass
            for cb in self.on_new_tx:
                for tx in txs:
                    try:
                        cb(tx)
                    except Exception:  # noqa: BLE001
                        pass

    def attach_pipeline(self, pipeline) -> None:
        self.pipeline = pipeline

    def close(self) -> None:
        """Stop the admission pipeline and the notifier thread."""
        if self.pipeline is not None:
            # terminal close (refuses late submits) where available;
            # plain stop() keeps duck-typed pipelines working
            closer = getattr(self.pipeline, "close", None)
            if closer is not None:
                closer()
            else:
                self.pipeline.stop()
        with self._notify_cv:
            self._notify_stopped = True
            self._notify_cv.notify_all()
        t = self._notify_thread
        if t is not None:
            t.join(timeout=2.0)

    # -- admission entry points --------------------------------------------
    def check_tx(self, tx: bytes, from_peer: str = "") -> None:
        """Admit a tx (raises on rejection; reference CheckTx :252).
        Routed through the micro-batched pipeline when one is attached;
        the result is delivered via the tx's future so semantics are
        unchanged."""
        if self.pipeline is not None:
            self.pipeline.check_tx(tx, from_peer)
            return
        key = self.precheck(tx)
        _txlife.stage_key(key, "verify_start")
        if self.verify_sigs:
            from .admission import SIGN_CONTEXT, parse_signed_tx

            parsed = parse_signed_tx(tx)
            if parsed is not None:
                pub, sig, payload = parsed
                from ..crypto.ed25519 import Ed25519PubKey

                try:
                    ok = Ed25519PubKey(pub).verify_signature(
                        SIGN_CONTEXT + payload, sig)
                except ValueError:
                    ok = False
                if not ok:
                    self.note_rejected(key)
                    raise ValueError("tx rejected: invalid signature")
        _txlife.stage_key(key, "verify_end")
        resp = self.app_check_batch([tx])[0]  # no mempool lock held
        if resp.code != 0:
            self.note_rejected(key)
            raise ValueError(f"tx rejected by app: code {resp.code}")
        _txlife.stage_key(key, "app_check")
        err = self.insert_batch([(key, tx, resp.gas_wanted)])[0]
        if err is not None:
            raise err
        _txlife.stage_key(key, "insert")
        self.notify_new_txs([tx])

    def submit_tx(self, tx: bytes, from_peer: str = ""):
        """Non-blocking admission: returns a Future that raises the
        per-tx rejection (or resolves to None). Without a pipeline the
        work happens inline and the future is already resolved."""
        if self.pipeline is not None:
            return self.pipeline.submit(tx, from_peer)
        from concurrent.futures import Future

        fut: Future = Future()
        try:
            self.check_tx(tx, from_peer)
            fut.set_result(None)
        except Exception as exc:  # noqa: BLE001 — delivered via future
            fut.set_exception(exc)
        return fut

    def reap_max_txs(self, n: int = -1) -> list[bytes]:
        """First n txs in FIFO order without budget accounting (reference
        ReapMaxTxs — serves the unconfirmed_txs RPC page cheaply)."""
        with self._lock:
            out = []
            for t in self._txs.values():
                if 0 <= n <= len(out):
                    break
                out.append(t.tx)
            return out

    def reap_max_bytes_max_gas(self, max_bytes: int = -1, max_gas: int = -1
                               ) -> list[bytes]:
        """FIFO reap under byte/gas budgets (reference ReapMaxBytesMaxGas)."""
        out, total_b, total_g = [], 0, 0
        with self._lock:
            for t in self._txs.values():
                if max_bytes >= 0 and total_b + len(t.tx) > max_bytes:
                    break
                if max_gas >= 0 and total_g + t.gas_wanted > max_gas:
                    break
                out.append(t.tx)
                total_b += len(t.tx)
                total_g += t.gas_wanted
        return out

    def reap_columns(self, max_bytes: int = -1, max_gas: int = -1
                     ) -> TxColumns:
        """Columnar reap: the same FIFO budget walk as
        reap_max_bytes_max_gas, but the result is ONE contiguous blob +
        offsets built under a single lock acquisition — the proposal
        path carries it through prepare_proposal, Data hash/encode, and
        block parts without re-materializing per-tx byte strings."""
        chunks: list[bytes] = []
        offsets = [0]
        total_b, total_g = 0, 0
        with self._lock:
            for t in self._txs.values():
                if max_bytes >= 0 and total_b + len(t.tx) > max_bytes:
                    break
                if max_gas >= 0 and total_g + t.gas_wanted > max_gas:
                    break
                chunks.append(t.tx)
                total_b += len(t.tx)
                total_g += t.gas_wanted
                offsets.append(total_b)
        return TxColumns(b"".join(chunks), offsets)

    def update(self, height: int, committed_txs: list[bytes],
               results=None) -> None:
        """Post-commit bookkeeping + recheck (reference Update :~560).

        Caller must hold the mempool lock (the executor's commit path).
        The recheck runs in `recheck_window`-sized batches, so the
        consensus-held lock window costs ceil(N/window) app calls
        instead of N."""
        self.height = height
        self.version += 1
        for i, tx in enumerate(committed_txs):
            key = TxKey(tx)
            code = results[i].code if results else 0
            if code == 0:
                self.cache.push(key)  # committed: never re-admit
            elif not self.keep_invalid:
                self.cache.remove(key)
            dropped = self._txs.pop(key, None)
            if dropped is not None:
                self._bytes -= len(dropped.tx)
        # recheck survivors against the new app state
        if self._txs:
            mempool_metrics().recheck_times.inc()
        keys = list(self._txs.keys())
        for i in range(0, len(keys), self.recheck_window):
            chunk = keys[i:i + self.recheck_window]
            responses = self.app_check_batch([self._txs[k].tx for k in chunk])
            for key, resp in zip(chunk, responses):
                if resp.code != 0:
                    dropped = self._txs.pop(key, None)
                    if dropped is not None:
                        self._bytes -= len(dropped.tx)
                    if not self.keep_invalid:
                        self.cache.remove(key)
        m = mempool_metrics()
        m.size.set(len(self._txs))
        m.tx_bytes.set(self._bytes)

    def flush(self) -> None:
        with self._lock:
            self._txs.clear()
            self.cache.reset()
            self._bytes = 0
            self.version += 1
            m = mempool_metrics()
            m.size.set(0)
            m.tx_bytes.set(0)

    def txs_available(self) -> bool:
        return bool(self._txs)


class NopMempool:
    """Disabled mempool (reference mempool/nop_mempool.go:111)."""

    version = 0

    def lock(self):
        pass

    def unlock(self):
        pass

    def size(self) -> int:
        return 0

    def check_tx(self, tx: bytes, from_peer: str = "") -> None:
        raise RuntimeError("mempool disabled")

    def reap_max_bytes_max_gas(self, max_bytes: int = -1, max_gas: int = -1):
        return []

    def reap_columns(self, max_bytes: int = -1, max_gas: int = -1):
        return TxColumns(b"", [0])

    def update(self, height, committed_txs, results=None) -> None:
        pass

    def flush(self) -> None:
        pass

    def txs_available(self) -> bool:
        return False
