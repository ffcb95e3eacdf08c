"""Block store: heights -> blocks, commits, seen-commits.

Behavior parity with reference internal/store/store.go:42 (BlockStore):
SaveBlock persists the block, its commit (the canonical +2/3 for
height-1... stored per height), and the "seen commit" used to propose the
next block; base/height track the retained range; Prune deletes below a
retain height (reference :309).

Twin of `cometbft_tpu/storage/blockstore.py`: the same keys and bytes, so
a store the reference wrote loads here (its KV items written through
`MemKV.write_batch`) and the same blocks saved here give the same items.
Commits decode through `types/block.py::decode_commit_any`, which refuses
a certificate-native commit by name. The port makes no CertCommit, so
`save_block` takes no full signature column beside one; a store carried
across keeps its columns (`load_seen_commit_full`), and `prune` and
`delete_latest_block` drop them as the reference's do.
"""

from __future__ import annotations

import threading

from ..encoding import proto as pb
from ..types import Block, Commit
from ..types.block import decode_commit_any
from ..utils.metrics import store_metrics
from .kv import KVStore


def _key_block(h: int) -> bytes:
    return b"B:" + h.to_bytes(8, "big")


def _key_commit(h: int) -> bytes:
    return b"C:" + h.to_bytes(8, "big")


def _key_seen_commit(h: int) -> bytes:
    return b"SC:" + h.to_bytes(8, "big")


def _key_block_hash(block_hash: bytes) -> bytes:
    return b"BH:" + block_hash


def _key_height_hash(h: int) -> bytes:
    return b"HH:" + h.to_bytes(8, "big")


def _key_ext_commit(h: int) -> bytes:
    return b"EC:" + h.to_bytes(8, "big")


def _key_full_seen_commit(h: int) -> bytes:
    # full signature column retained beside a certificate-native seen
    # commit in a store the reference wrote (its evidence window)
    return b"SCF:" + h.to_bytes(8, "big")


_KEY_STATE = b"BS:state"


class BlockStore:
    def __init__(self, db: KVStore):
        self._db = db
        self._lock = threading.RLock()
        self._base = 0
        self._height = 0
        raw = db.get(_KEY_STATE)
        if raw:
            d = pb.fields_to_dict(raw)
            self._base = pb.to_i64(d.get(1, 0))
            self._height = pb.to_i64(d.get(2, 0))

    def base(self) -> int:
        with self._lock:
            return self._base

    def height(self) -> int:
        with self._lock:
            return self._height

    def size(self) -> int:
        with self._lock:
            return 0 if self._height == 0 else self._height - self._base + 1

    def _save_meta(self, sets):
        payload = pb.f_varint(1, self._base) + pb.f_varint(2, self._height)
        sets.append((_KEY_STATE, payload))

    def save_block(self, block: Block, seen_commit: Commit) -> None:
        h = block.header.height
        with self._lock:
            if self._height and h != self._height + 1:
                raise ValueError(
                    f"non-contiguous save: have {self._height}, got {h}"
                )
            seen_enc = seen_commit.encode()
            sets = [
                (_key_block(h), block.encode()),
                (_key_seen_commit(h), seen_enc),
                (_key_block_hash(block.hash()), h.to_bytes(8, "big")),
                (_key_height_hash(h), block.hash()),
            ]
            if block.last_commit is not None and h > 1:
                canonical = block.last_commit.encode()
                sets.append((_key_commit(h - 1), canonical))
                store_metrics().commit_bytes.observe(len(canonical))
            else:
                store_metrics().commit_bytes.observe(len(seen_enc))
            self._height = h
            if self._base == 0:
                self._base = h
            self._save_meta(sets)
            self._db.write_batch(sets)

    def save_seen_commit(self, height: int, commit: Commit) -> None:
        """Store a commit without its block — the state-sync bootstrap
        (reference store.go SaveSeenCommit): after a snapshot restore the
        node holds the light-verified commit at the restore height but no
        block, and block sync verifies H+1 against it. Also anchors
        base/height so blocksync resumes from the restore point."""
        with self._lock:
            sets = [(_key_seen_commit(height), commit.encode())]
            if self._height == 0:
                self._base = height
                self._height = height
                self._save_meta(sets)
            self._db.write_batch(sets)

    def load_block(self, height: int) -> Block | None:
        raw = self._db.get(_key_block(height))
        # our own stored bytes are canonical by construction: stash them
        # so BlockID/part-set work skips the re-encode
        return Block.decode(raw, trusted_bytes=True) if raw else None

    def load_block_meta(self, height: int) -> tuple[Block, int] | None:
        """(block, wire size) without a re-encode — the stored bytes'
        length IS the canonical size (reference store.go LoadBlockMeta
        serves BlockMeta.BlockSize the same way)."""
        raw = self._db.get(_key_block(height))
        if not raw:
            return None
        return Block.decode(raw, trusted_bytes=True), len(raw)

    def load_block_by_hash(self, block_hash: bytes) -> Block | None:
        """O(1) via the hash→height index written at save time
        (reference internal/store/store.go LoadBlockByHash)."""
        raw = self._db.get(_key_block_hash(block_hash))
        if not raw:
            return None
        return self.load_block(int.from_bytes(raw, "big"))

    def load_block_commit(self, height: int) -> Commit | None:
        """The canonical commit FOR `height` (stored with block height+1),
        through decode_commit_any (a CertCommit raises by name)."""
        raw = self._db.get(_key_commit(height))
        return decode_commit_any(raw, trusted_bytes=True) if raw else None

    def load_seen_commit(self, height: int) -> Commit | None:
        raw = self._db.get(_key_seen_commit(height))
        return decode_commit_any(raw, trusted_bytes=True) if raw else None

    def load_seen_commit_full(self, height: int) -> Commit | None:
        """The full signature column for `height`: the column a carried
        store kept beside a certificate, else the seen commit itself (the
        port's seen commits are always full columns)."""
        raw = self._db.get(_key_full_seen_commit(height))
        if raw:
            return Commit.decode(raw, trusted_bytes=True)
        return self.load_seen_commit(height)

    def save_extended_commit(self, ext_commit) -> None:
        """Seen commit WITH vote extensions (reference SaveBlockWithExtendedCommit
        :262) — kept per height while extensions are enabled."""
        self._db.set(_key_ext_commit(ext_commit.height), ext_commit.encode())

    def load_extended_commit(self, height: int):
        from ..types.extended_commit import ExtendedCommit

        raw = self._db.get(_key_ext_commit(height))
        return ExtendedCommit.decode(raw) if raw else None

    def delete_latest_block(self) -> None:
        """Remove the top block (rollback support; reference
        internal/store/store.go DeleteLatestBlock)."""
        with self._lock:
            if self._height == 0:
                raise ValueError("block store is empty")
            h = self._height
            deletes = [_key_block(h), _key_seen_commit(h),
                       _key_full_seen_commit(h),
                       _key_commit(h - 1), _key_height_hash(h)]
            bh = self._db.get(_key_height_hash(h))
            if bh:
                deletes.append(_key_block_hash(bh))
            self._height = h - 1
            if self._height < self._base:
                self._base = self._height
            sets: list = []
            self._save_meta(sets)
            self._db.write_batch(sets, deletes)

    def prune(self, retain_height: int) -> int:
        """Delete blocks below retain_height; returns number pruned
        (reference internal/store/store.go:309)."""
        with self._lock:
            if retain_height <= self._base:
                return 0
            if retain_height > self._height + 1:
                raise ValueError("cannot prune beyond store height + 1")
            deletes = []
            pruned = 0
            for h in range(self._base, retain_height):
                # the HH entry gives the block hash without a decode
                bh = self._db.get(_key_height_hash(h))
                if bh:
                    deletes.append(_key_block_hash(bh))
                deletes += [_key_block(h), _key_commit(h),
                            _key_seen_commit(h), _key_full_seen_commit(h),
                            _key_height_hash(h), _key_ext_commit(h)]
                pruned += 1
            self._base = retain_height
            sets: list = []
            self._save_meta(sets)
            self._db.write_batch(sets, deletes)
            return pruned
