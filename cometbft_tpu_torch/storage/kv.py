"""Key-value store abstraction (the cometbft-db seam, reference go.mod:47).

Backends: MemKV (dict, tests) and SqliteKV (single-file, batched writes).
Keys and values are bytes; iteration is byte-ordered over a prefix.

Twin of `cometbft_tpu/storage/kv.py` (`SqliteKV` on the standard
library's `sqlite3`).
"""

from __future__ import annotations

import sqlite3
import threading
from abc import ABC, abstractmethod
from typing import Iterator


class KVStore(ABC):
    @abstractmethod
    def get(self, key: bytes) -> bytes | None: ...

    @abstractmethod
    def set(self, key: bytes, value: bytes) -> None: ...

    @abstractmethod
    def delete(self, key: bytes) -> None: ...

    @abstractmethod
    def iterate_prefix(self, prefix: bytes) -> Iterator[tuple[bytes, bytes]]: ...

    @abstractmethod
    def write_batch(self, sets: list[tuple[bytes, bytes]], deletes: list[bytes] = ()) -> None: ...

    @abstractmethod
    def close(self) -> None: ...

    def has(self, key: bytes) -> bool:
        return self.get(key) is not None


class MemKV(KVStore):
    def __init__(self):
        self._d: dict[bytes, bytes] = {}
        self._lock = threading.Lock()

    def get(self, key):
        with self._lock:
            return self._d.get(key)

    def set(self, key, value):
        with self._lock:
            self._d[bytes(key)] = bytes(value)

    def delete(self, key):
        with self._lock:
            self._d.pop(key, None)

    def iterate_prefix(self, prefix):
        with self._lock:
            keys = sorted(k for k in self._d if k.startswith(prefix))
        for k in keys:
            v = self.get(k)
            if v is not None:
                yield k, v

    def write_batch(self, sets, deletes=()):
        with self._lock:
            for k, v in sets:
                self._d[bytes(k)] = bytes(v)
            for k in deletes:
                self._d.pop(k, None)

    def close(self):
        pass


class SqliteKV(KVStore):
    """Single-table SQLite KV; WAL mode for concurrent readers."""

    def __init__(self, path: str):
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        with self._lock:
            self._conn.execute("PRAGMA journal_mode=WAL")
            self._conn.execute("PRAGMA synchronous=NORMAL")
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS kv (k BLOB PRIMARY KEY, v BLOB NOT NULL)"
            )
            self._conn.commit()

    def get(self, key):
        with self._lock:
            row = self._conn.execute("SELECT v FROM kv WHERE k = ?", (key,)).fetchone()
        return row[0] if row else None

    def set(self, key, value):
        with self._lock:
            self._conn.execute(
                "INSERT INTO kv (k, v) VALUES (?, ?) ON CONFLICT(k) DO UPDATE SET v=excluded.v",
                (key, value),
            )
            self._conn.commit()

    def delete(self, key):
        with self._lock:
            self._conn.execute("DELETE FROM kv WHERE k = ?", (key,))
            self._conn.commit()

    def iterate_prefix(self, prefix):
        # upper bound = prefix with its last non-0xff byte incremented
        # (exclusive): a suffix-based bound like prefix+b"\xff"*N would
        # silently exclude keys extending further than N bytes
        hi = None
        p = bytearray(prefix)
        for i in range(len(p) - 1, -1, -1):
            if p[i] != 0xFF:
                p[i] += 1
                hi = bytes(p[: i + 1])
                break
        with self._lock:
            if hi is None:  # all-0xff (or empty) prefix: no upper bound
                rows = self._conn.execute(
                    "SELECT k, v FROM kv WHERE k >= ? ORDER BY k", (prefix,)
                ).fetchall()
            else:
                rows = self._conn.execute(
                    "SELECT k, v FROM kv WHERE k >= ? AND k < ? ORDER BY k",
                    (prefix, hi),
                ).fetchall()
        for k, v in rows:
            if bytes(k).startswith(prefix):
                yield bytes(k), bytes(v)

    def write_batch(self, sets, deletes=()):
        with self._lock:
            self._conn.executemany(
                "INSERT INTO kv (k, v) VALUES (?, ?) ON CONFLICT(k) DO UPDATE SET v=excluded.v",
                [(k, v) for k, v in sets],
            )
            if deletes:
                self._conn.executemany("DELETE FROM kv WHERE k = ?", [(k,) for k in deletes])
            self._conn.commit()

    def close(self):
        with self._lock:
            self._conn.close()


def open_kv(path: str | None) -> KVStore:
    """None/':memory:' -> MemKV; otherwise SQLite at path."""
    if path in (None, ":memory:"):
        return MemKV()
    return SqliteKV(path)
