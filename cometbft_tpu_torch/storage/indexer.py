"""Tx + block indexers over the KV store.

Behavior parity: reference internal/state/txindex/kv (tx results by hash,
composite-key search) + internal/state/indexer/block/kv (block events by
height), fed by an IndexerService subscribed to the event bus
(internal/state/txindex/indexer_service.go).

Twin of `cometbft_tpu/storage/indexer.py`: the same KV bytes.
"""

from __future__ import annotations

import threading

from ..crypto.keys import tmhash
from ..encoding import proto as pb
from ..utils.pubsub import Query
from .kv import KVStore, MemKV


def _key_tx(tx_hash: bytes) -> bytes:
    return b"TX:" + tx_hash


def _key_tx_height(height: int, index: int) -> bytes:
    return b"TH:" + height.to_bytes(8, "big") + index.to_bytes(4, "big")


def _key_block_events(height: int) -> bytes:
    return b"BE:" + height.to_bytes(8, "big")


class TxIndexer:
    """reference internal/state/txindex/kv/kv.go."""

    def __init__(self, db: KVStore | None = None):
        self._db = db or MemKV()
        self._lock = threading.Lock()

    def index(self, height: int, index: int, tx: bytes, result,
              events: dict[str, list[str]] | None = None) -> None:
        h = tmhash(tx)
        payload = (
            pb.f_varint(1, height)
            + pb.f_varint(2, index)
            + pb.f_bytes(3, tx)
            + pb.f_varint(4, getattr(result, "code", 0))
            + pb.f_bytes(5, getattr(result, "data", b""))
            + pb.f_bytes(6, _encode_events(events or {}))
        )
        with self._lock:
            self._db.write_batch(
                [(_key_tx(h), payload), (_key_tx_height(height, index), h)]
            )

    def get(self, tx_hash: bytes):
        raw = self._db.get(_key_tx(tx_hash))
        if raw is None:
            return None
        d = pb.fields_to_dict(raw)
        return {
            "height": pb.to_i64(d.get(1, 0)),
            "index": pb.to_i64(d.get(2, 0)),
            "tx": pb.as_bytes(d.get(3, b"")),
            "code": int(d.get(4, 0)),
            "data": pb.as_bytes(d.get(5, b"")),
            "events": _decode_events(pb.as_bytes(d.get(6, b""))),
        }

    def search(self, query_str: str, limit: int = 100) -> list[dict]:
        """Scan-match (reference kv search over composite keys)."""
        q = Query(query_str)
        out = []
        for _, tx_hash in self._db.iterate_prefix(b"TH:"):
            rec = self.get(tx_hash)
            if rec is None:
                continue
            events = dict(rec["events"])
            events.setdefault("tx.height", [str(rec["height"])])
            events.setdefault("tx.hash", [tmhash(rec["tx"]).hex().upper()])
            if q.matches(events):
                out.append(rec)
                if len(out) >= limit:
                    break
        return out


class BlockIndexer:
    """reference internal/state/indexer/block/kv."""

    def __init__(self, db: KVStore | None = None):
        self._db = db or MemKV()

    def index(self, height: int, events: dict[str, list[str]]) -> None:
        self._db.set(_key_block_events(height), _encode_events(events))

    def search(self, query_str: str, limit: int = 100) -> list[int]:
        q = Query(query_str)
        out = []
        for key, raw in self._db.iterate_prefix(b"BE:"):
            h = int.from_bytes(key[3:11], "big")
            events = _decode_events(raw)
            events.setdefault("block.height", [str(h)])
            if q.matches(events):
                out.append(h)
                if len(out) >= limit:
                    break
        return out


class IndexerService:
    """Subscribes to the event bus and feeds both indexers
    (reference internal/state/txindex/indexer_service.go)."""

    def __init__(self, event_bus, tx_indexer: TxIndexer,
                 block_indexer: BlockIndexer):
        self.tx_indexer = tx_indexer
        self.block_indexer = block_indexer
        self._bus = event_bus
        self._tx_sub = event_bus.subscribe("indexer", "tm.event = 'Tx'")
        self._block_sub = event_bus.subscribe("indexer", "tm.event = 'NewBlock'")
        self._stopped = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        from ..utils.pubsub import SubscriptionCancelled

        while not self._stopped.is_set():
            try:
                msg = self._tx_sub.next(timeout=0.1)
            except SubscriptionCancelled:
                # slow-consumer overflow: events in the gap are lost (the
                # reference drops slow subscribers too); resubscribe
                self._tx_sub = self._bus.subscribe("indexer", "tm.event = 'Tx'")
                msg = None
            if msg is not None:
                d = msg.data
                self.tx_indexer.index(
                    d["height"], d["index"], d["tx"], d["result"], msg.events
                )
            try:
                bmsg = self._block_sub.next(timeout=0.05)
            except SubscriptionCancelled:
                self._block_sub = self._bus.subscribe(
                    "indexer", "tm.event = 'NewBlock'"
                )
                bmsg = None
            if bmsg is not None:
                self.block_indexer.index(
                    bmsg.data["block"].header.height, bmsg.events
                )

    def stop(self) -> None:
        self._stopped.set()
        self._thread.join(timeout=2)


def _encode_events(events: dict[str, list[str]]) -> bytes:
    out = b""
    for k, vals in events.items():
        for v in vals:
            out += pb.f_embedded(1, pb.f_string(1, k) + pb.f_string(2, v))
    return out


def _decode_events(buf: bytes) -> dict[str, list[str]]:
    out: dict[str, list[str]] = {}
    for f, _, v in pb.parse_fields(buf):
        if f == 1:
            d = pb.fields_to_dict(pb.as_bytes(v))
            k = pb.as_bytes(d.get(1, b"")).decode("utf-8", "replace")
            val = pb.as_bytes(d.get(2, b"")).decode("utf-8", "replace")
            out.setdefault(k, []).append(val)
    return out
