"""Durable stores: KV abstraction, block store, state store.

Mirrors the reference's storage split (internal/store BlockStore over a
cometbft-db KV backend, internal/state state store) with Python-native
backends: in-memory dict and SQLite (single-file, transactional).

Twin of `cometbft_tpu/storage/` for the stores replay needs; the tx and
block indexers and the SQL sink are not here yet.
"""

from .kv import KVStore, MemKV, SqliteKV, open_kv  # noqa: F401
from .blockstore import BlockStore  # noqa: F401
from .statestore import StateStore  # noqa: F401
