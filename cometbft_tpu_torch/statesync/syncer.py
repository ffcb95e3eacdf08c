"""Twin of `cometbft_tpu/statesync/syncer.py`. State-sync syncer: restore the application from a peer snapshot,
anchored by light-client verification.

Behavior parity: reference internal/statesync/syncer.go —
sync_any (:144) retries over the snapshot pool; sync (:240) fetches the
light-client trust anchor, offers the snapshot to the app (:321),
fetches + applies chunks (:357) honoring the app's verdict enum
(accept / abort / retry / retry-snapshot / reject-snapshot), and
verifies the restored app via ABCI Info (:verifyApp). The returned
(state, commit) bootstraps the node, after which block sync takes over
(node/node.go:575-584).

Chunk fetching is injected as `fetch_chunk(snapshot, index) -> bytes or
None` — the p2p reactor provides the peer-backed implementation; tests
provide a local one.

`rejected` keeps each refused snapshot with the error that refused it,
in order (the reference only logs them), as block sync's `refused` does.
"""

from __future__ import annotations

import threading

from ..abci.types import ApplySnapshotChunkResult, OfferSnapshotResult
from ..abci.types import Snapshot as AbciSnapshot
from .chunks import ChunkQueue, ErrQueueClosed
from .snapshots import Snapshot, SnapshotPool


class StateSyncError(Exception):
    pass


class ErrNoSnapshots(StateSyncError):
    pass


class ErrAbort(StateSyncError):
    pass


class ErrRejectSnapshot(StateSyncError):
    pass


class ErrRejectFormat(StateSyncError):
    pass


class ErrRejectSender(StateSyncError):
    pass


class ErrChunkTimeout(StateSyncError):
    pass


class Syncer:
    def __init__(
        self,
        snapshot_conn,
        state_provider,
        fetch_chunk,
        pool: SnapshotPool | None = None,
        temp_dir: str | None = None,
        chunk_fetchers: int = 4,
        chunk_timeout: float = 10.0,
    ):
        self.conn = snapshot_conn
        self.provider = state_provider
        self.fetch_chunk = fetch_chunk
        self.pool = pool or SnapshotPool()
        self.temp_dir = temp_dir
        self.chunk_fetchers = chunk_fetchers
        self.chunk_timeout = chunk_timeout
        self.rejected: list[tuple[Snapshot, Exception]] = []

    # ------------------------------------------------------------------
    def add_snapshot(self, snapshot: Snapshot, peer: str = "") -> bool:
        added = self.pool.add(snapshot, peer)
        if added:
            from ..utils.metrics import statesync_metrics

            statesync_metrics().snapshots_discovered_total.inc()
        return added

    def sync_any(self, max_attempts: int = 10):
        """Try pool snapshots best-first until one restores; returns
        (state, commit) (reference SyncAny :144)."""
        from ..utils.metrics import statesync_metrics

        statesync_metrics().syncing.set(1)
        try:
            return self._sync_any(max_attempts)
        finally:
            statesync_metrics().syncing.set(0)

    def _sync_any(self, max_attempts: int):
        attempts = 0
        while attempts < max_attempts:
            snapshot = self.pool.best()
            if snapshot is None:
                raise ErrNoSnapshots("no viable snapshots in pool")
            attempts += 1
            chunks = ChunkQueue(snapshot, self.temp_dir)
            try:
                return self.sync(snapshot, chunks)
            except ErrAbort:
                raise
            except ErrRejectFormat as e:
                self._reject(snapshot, e, "format rejected")
                self.pool.reject_format(snapshot.format)
            except ErrRejectSender as e:
                self._reject(snapshot, e, "sender rejected")
                for peer in self.pool.peers(snapshot):
                    self.pool.reject_peer(peer)
                self.pool.reject(snapshot)
            except (ErrRejectSnapshot, ErrChunkTimeout, StateSyncError) as e:
                self._reject(snapshot, e, str(e))
                self.pool.reject(snapshot)
            finally:
                chunks.close()
        raise ErrNoSnapshots(f"no snapshot restored after {max_attempts} attempts")

    def _reject(self, snapshot: Snapshot, err: Exception, reason: str) -> None:
        from ..utils.log import logger

        self.rejected.append((snapshot, err))
        logger("statesync").warn(
            "snapshot rejected", height=snapshot.height,
            format=snapshot.format, reason=reason[:120],
        )

    # ------------------------------------------------------------------
    def sync(self, snapshot: Snapshot, chunks: ChunkQueue):
        """Restore one snapshot (reference Sync :240)."""
        # 1. light-client trust anchor BEFORE trusting any snapshot data
        try:
            snapshot.trusted_app_hash = self.provider.app_hash(snapshot.height)
        except Exception as e:  # noqa: BLE001 — any light failure rejects
            raise ErrRejectSnapshot(f"app hash verification failed: {e}") from e

        # 2. offer to the app
        self._offer(snapshot)

        # 3. optimistic state/commit so light failures surface pre-restore
        try:
            state = self.provider.state(snapshot.height)
            commit = self.provider.commit(snapshot.height)
        except Exception as e:  # noqa: BLE001
            raise ErrRejectSnapshot(f"state verification failed: {e}") from e

        # 4. fetch chunks concurrently while applying in order
        stop = threading.Event()
        fetchers = [
            threading.Thread(
                target=self._fetch_loop, args=(snapshot, chunks, stop),
                daemon=True,
            )
            for _ in range(min(self.chunk_fetchers, snapshot.chunks))
        ]
        for f in fetchers:
            f.start()
        try:
            self._apply_chunks(snapshot, chunks)
        finally:
            stop.set()

        # 5. verify the restored app reports the trusted height/hash
        self._verify_app(snapshot)
        return state, commit

    # ------------------------------------------------------------------
    def _offer(self, snapshot: Snapshot) -> None:
        result = self.conn.offer_snapshot(
            AbciSnapshot(
                height=snapshot.height,
                format=snapshot.format,
                chunks=snapshot.chunks,
                hash=snapshot.hash,
                metadata=snapshot.metadata,
            ),
            snapshot.trusted_app_hash,
        )
        if result == OfferSnapshotResult.ACCEPT:
            return
        if result == OfferSnapshotResult.ABORT:
            raise ErrAbort("app aborted state sync")
        if result == OfferSnapshotResult.REJECT_FORMAT:
            raise ErrRejectFormat(f"app rejected format {snapshot.format}")
        if result == OfferSnapshotResult.REJECT_SENDER:
            raise ErrRejectSender("app rejected snapshot senders")
        raise ErrRejectSnapshot(f"app rejected snapshot (result {result})")

    def _fetch_loop(self, snapshot: Snapshot, chunks: ChunkQueue, stop) -> None:
        while not stop.is_set():
            try:
                index = chunks.allocate()
            except ErrQueueClosed:
                return
            if index is None:
                # All chunks are currently allocated, but the app may still
                # requeue some via RETRY/RETRY_SNAPSHOT verdicts — keep
                # polling until the queue closes (reference fetchChunks
                # loops on errDone rather than exiting the goroutine).
                if stop.wait(0.05):
                    return
                continue
            data = None
            try:
                data = self.fetch_chunk(snapshot, index)
            except Exception:  # noqa: BLE001 — fetch failure: requeue
                data = None
            if data is None:
                chunks.retry(index)
                if stop.wait(0.05):
                    return
                continue
            chunks.add(index, data)

    def _apply_chunks(self, snapshot: Snapshot, chunks: ChunkQueue) -> None:
        applied = 0
        # Retry budget: now that fetchers keep polling for requeued
        # chunks, an app that answers RETRY/RETRY_SNAPSHOT forever (e.g.
        # a peer serving the same corrupted chunk on every fetch) would
        # otherwise loop the restore indefinitely. The reference bounds
        # this by the chunk request timeout; we bound it by total retry
        # verdicts — generous for transient faults, finite for poison.
        retries_left = 4 * snapshot.chunks + 16
        while applied < snapshot.chunks:
            got = chunks.next(timeout=self.chunk_timeout)
            if got is None:
                raise ErrChunkTimeout(
                    f"timed out waiting for chunk {applied}/{snapshot.chunks}"
                )
            index, data, sender = got
            result = self.conn.apply_snapshot_chunk(index, data, sender)
            if result == ApplySnapshotChunkResult.ACCEPT:
                applied += 1
                from ..utils.metrics import statesync_metrics

                statesync_metrics().chunks_applied_total.inc()
                continue
            if result == ApplySnapshotChunkResult.ABORT:
                raise ErrAbort("app aborted during chunk apply")
            if result in (
                ApplySnapshotChunkResult.RETRY,
                ApplySnapshotChunkResult.RETRY_SNAPSHOT,
            ):
                retries_left -= 1
                if retries_left < 0:
                    raise ErrRejectSnapshot(
                        "chunk retry budget exhausted during apply"
                    )
                if result == ApplySnapshotChunkResult.RETRY:
                    chunks.retry(index)
                else:
                    chunks.retry_all()
                    applied = 0
                continue
            if result == ApplySnapshotChunkResult.REJECT_SNAPSHOT:
                raise ErrRejectSnapshot("app rejected snapshot during apply")
            raise StateSyncError(f"unknown apply result {result}")

    def _verify_app(self, snapshot: Snapshot) -> None:
        info = self.conn.info()
        if info.last_block_height != snapshot.height:
            raise ErrRejectSnapshot(
                f"restored app height {info.last_block_height} != "
                f"snapshot height {snapshot.height}"
            )
        if info.last_block_app_hash != snapshot.trusted_app_hash:
            raise ErrRejectSnapshot(
                "restored app hash does not match light-client-verified hash"
            )
