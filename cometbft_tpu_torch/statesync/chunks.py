"""Twin of `cometbft_tpu/statesync/chunks.py`. Chunk queue: disk-backed staging for snapshot chunks being fetched.

Behavior parity: reference internal/statesync/chunks.go:320 — chunks are
spooled to a temp dir (snapshots can exceed memory), Allocate hands out
the next index to fetch, Add files a fetched chunk, Next blocks until
the next sequential chunk is available, Retry/RetryAll requeue after app
RETRY verdicts, Discard drops a bad chunk so a different peer can serve
it.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import threading


class ErrQueueClosed(Exception):
    pass


class ChunkQueue:
    def __init__(self, snapshot, temp_dir: str | None = None):
        self.snapshot = snapshot
        self._dir = tempfile.mkdtemp(prefix="statesync-", dir=temp_dir)
        self._lock = threading.Condition()
        self._status = ["pending"] * snapshot.chunks  # pending|allocated|done|returned
        self._senders: dict[int, str] = {}
        self._next = 0  # next index Next() will hand to the applier
        self._closed = False

    # -- fetch side --------------------------------------------------------
    def allocate(self) -> int | None:
        """The lowest pending index, marked allocated (None = none left)."""
        with self._lock:
            if self._closed:
                raise ErrQueueClosed
            for i, st in enumerate(self._status):
                if st == "pending":
                    self._status[i] = "allocated"
                    return i
            return None

    def add(self, index: int, chunk: bytes, sender: str = "") -> bool:
        """File a fetched chunk; False if out of range or already done."""
        with self._lock:
            if self._closed:
                return False
            if not (0 <= index < len(self._status)):
                return False
            if self._status[index] in ("done", "returned"):
                return False
            with open(self._path(index), "wb") as f:
                f.write(chunk)
            self._status[index] = "done"
            self._senders[index] = sender
            self._lock.notify_all()
            return True

    # -- apply side --------------------------------------------------------
    def next(self, timeout: float | None = None) -> tuple[int, bytes, str] | None:
        """Block for the next sequential chunk; None on timeout; raises
        ErrQueueClosed after close(). Returns (index, chunk, sender)."""
        with self._lock:
            while True:
                if self._closed:
                    raise ErrQueueClosed
                if self._next >= len(self._status):
                    return None  # all chunks already returned
                if self._status[self._next] == "done":
                    i = self._next
                    self._next += 1
                    self._status[i] = "returned"
                    with open(self._path(i), "rb") as f:
                        return i, f.read(), self._senders.get(i, "")
                if not self._lock.wait(timeout):
                    return None

    def retry(self, index: int) -> None:
        """Requeue one chunk (app said RETRY)."""
        with self._lock:
            if 0 <= index < len(self._status) and not self._closed:
                self._status[index] = "pending"
                self._senders.pop(index, None)
                self._next = min(self._next, index)
                self._lock.notify_all()

    def retry_all(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._status = ["pending"] * len(self._status)
            self._senders.clear()
            self._next = 0
            self._lock.notify_all()

    def discard(self, index: int) -> None:
        """Drop a chunk's data entirely (bad sender)."""
        self.retry(index)
        try:
            os.unlink(self._path(index))
        except OSError:
            pass

    def sender(self, index: int) -> str:
        with self._lock:
            return self._senders.get(index, "")

    def done(self) -> bool:
        with self._lock:
            return self._next >= len(self._status)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._lock.notify_all()
        shutil.rmtree(self._dir, ignore_errors=True)

    def _path(self, index: int) -> str:
        return os.path.join(self._dir, f"chunk-{index:06d}")
