"""In-memory key=value example app (reference abci/example/kvstore).

Tx format: b"key=value". App hash commits to the store's contents +
height so every honest node agrees. Also the universal test app, like the
reference's kvstore doubles as the e2e app base.

The app hash is an incremental multiset digest (LtHash-style: sum of
2048-bit per-entry digests mod 2^2048, finalized with the height):
updating it costs O(txs in the block) instead of the O(whole store)
full re-hash that dominated the replay benchmark's per-block budget,
while staying content-binding — the reference kvstore's hash is just
varint(tx count) (reference abci/example/kvstore/kvstore.go:545-548),
which would let a lying state-sync snapshot smuggle arbitrary store
contents past the light-client-verified app hash, so we keep the
stronger commitment. The 2048-bit accumulator width (vs a single
SHA-256 sum) is what defeats Wagner's generalized-birthday k-sum
collision search on additive hashes, per the LtHash security analysis.

Twin of `cometbft_tpu/abci/kvstore.py`: the same app hash, results and
snapshots for the same txs.
"""

from __future__ import annotations

import hashlib

from .types import (
    Application,
    ApplySnapshotChunkResult,
    CheckTxResult,
    ExecTxResult,
    FinalizeBlockRequest,
    FinalizeBlockResponse,
    InfoResponse,
    InitChainRequest,
    InitChainResponse,
    OfferSnapshotResult,
    ProposalStatus,
    QueryResponse,
    Snapshot,
    ValidatorUpdate,
)

VALIDATOR_PREFIX = b"val:"


class KVStoreApp(Application):
    def __init__(self, snapshot_interval: int = 0, chunk_size: int = 4096):
        self.store: dict[bytes, bytes] = {}
        self.pending: dict[bytes, bytes] = {}
        self.height = 0
        self.app_hash = b"\x00" * 32
        self.val_updates: list[ValidatorUpdate] = []
        # -- snapshots (reference abci/example/kvstore + e2e app) --
        self.snapshot_interval = snapshot_interval
        self.chunk_size = chunk_size
        self._snapshots: dict[int, tuple[Snapshot, list[bytes]]] = {}
        self._restore: dict | None = None  # in-progress state-sync restore
        self._acc = 0  # multiset digest of `store` (excludes pending)
        self._staged_cache = None  # finalize-computed digest, consumed by commit

    # --- helpers ---
    @staticmethod
    def _parse(tx: bytes) -> tuple[bytes, bytes] | None:
        if b"=" not in tx:
            return None
        k, _, v = tx.partition(b"=")
        if not k:
            return None
        return k, v

    _ACC_MASK = (1 << 2048) - 1

    @staticmethod
    def _entry_digest(k: bytes, v: bytes) -> int:
        h = hashlib.sha256()
        h.update(len(k).to_bytes(4, "big") + k)
        h.update(len(v).to_bytes(4, "big") + v)
        base = h.digest()
        # expand to 2048 bits (8 counter-suffixed SHA-256 blocks): a
        # 256-bit additive accumulator falls to Wagner's k-sum attack in
        # ~2^40 work; at 2048 bits the attack is out of reach (LtHash)
        return int.from_bytes(
            b"".join(
                hashlib.sha256(bytes([i]) + base).digest() for i in range(8)
            ),
            "big",
        )

    @classmethod
    def _acc_for(cls, store: dict[bytes, bytes]) -> int:
        return sum(map(cls._entry_digest, store.keys(), store.values())) & cls._ACC_MASK

    def _staged_acc(self) -> int:
        """The multiset digest with `pending` applied over `store`."""
        acc = self._acc
        for k, v in self.pending.items():
            old = self.store.get(k)
            if old is not None:
                acc -= self._entry_digest(k, old)
            acc += self._entry_digest(k, v)
        return acc & self._ACC_MASK

    @staticmethod
    def _hash_of(height: int, acc: int) -> bytes:
        return hashlib.sha256(
            height.to_bytes(8, "big") + acc.to_bytes(256, "big")
        ).digest()

    def _compute_hash(self, height: int) -> bytes:
        return self._hash_of(height, self._staged_acc())

    # --- ABCI ---
    def info(self) -> InfoResponse:
        return InfoResponse(
            data="kvstore",
            version="0.1.0",
            last_block_height=self.height,
            last_block_app_hash=self.app_hash if self.height else b"",
        )

    def init_chain(self, req: InitChainRequest) -> InitChainResponse:
        return InitChainResponse(validators=[], app_hash=b"")

    def check_tx(self, tx: bytes) -> CheckTxResult:
        if self._parse(tx) is None:
            return CheckTxResult(code=1, log="tx must be key=value")
        return CheckTxResult()

    def process_proposal(self, txs) -> int:
        for tx in txs:
            if self._parse(tx) is None:
                return ProposalStatus.REJECT
        return ProposalStatus.ACCEPT

    def finalize_block(self, req: FinalizeBlockRequest) -> FinalizeBlockResponse:
        self.pending = {}
        self.val_updates = []
        results = []
        for tx in req.txs:
            kv = self._parse(tx)
            if kv is None:
                results.append(ExecTxResult(code=1, log="malformed tx"))
                continue
            k, v = kv
            if k.startswith(VALIDATOR_PREFIX):
                # "val:<hex pubkey>=<power>" mirrors the reference kvstore's
                # validator-update txs
                try:
                    pk = bytes.fromhex(k[len(VALIDATOR_PREFIX):].decode())
                    power = int(v)
                    self.val_updates.append(ValidatorUpdate(pk, "ed25519", power))
                except ValueError:
                    results.append(ExecTxResult(code=1, log="bad validator tx"))
                    continue
            self.pending[k] = v
            results.append(ExecTxResult(data=v))
        # computed once here; commit() reuses it (the per-entry digest
        # expansion is 9 SHA-256 calls per pending key)
        staged = self._staged_acc()
        self._staged_cache = staged
        app_hash = self._hash_of(req.height, staged)
        return FinalizeBlockResponse(
            tx_results=results,
            validator_updates=list(self.val_updates),
            app_hash=app_hash,
        )

    def commit(self) -> int:
        staged = getattr(self, "_staged_cache", None)
        self._acc = staged if staged is not None else self._staged_acc()
        self._staged_cache = None
        self.store.update(self.pending)
        self.pending = {}
        self.height += 1
        self.app_hash = self._hash_of(self.height, self._acc)
        if self.snapshot_interval and self.height % self.snapshot_interval == 0:
            self._take_snapshot()
        return 0

    # --- snapshot support (state sync source + target) ---
    def _serialize_state(self) -> bytes:
        out = [self.height.to_bytes(8, "big")]
        for k in sorted(self.store):
            v = self.store[k]
            out.append(len(k).to_bytes(4, "big") + k)
            out.append(len(v).to_bytes(4, "big") + v)
        return b"".join(out)

    def _take_snapshot(self) -> None:
        payload = self._serialize_state()
        chunks = [
            payload[i : i + self.chunk_size]
            for i in range(0, len(payload), self.chunk_size)
        ] or [b""]
        snap = Snapshot(
            height=self.height,
            format=1,
            chunks=len(chunks),
            hash=hashlib.sha256(payload).digest(),
        )
        self._snapshots[self.height] = (snap, chunks)
        # keep only the two most recent snapshots
        for h in sorted(self._snapshots)[:-2]:
            del self._snapshots[h]

    def list_snapshots(self) -> list[Snapshot]:
        return [snap for snap, _ in self._snapshots.values()]

    def load_snapshot_chunk(self, height: int, format_: int, chunk: int) -> bytes:
        entry = self._snapshots.get(height)
        if entry is None or format_ != 1 or not (0 <= chunk < len(entry[1])):
            return b""
        return entry[1][chunk]

    def offer_snapshot(self, snapshot: Snapshot, app_hash: bytes) -> int:
        if snapshot.format != 1:
            return OfferSnapshotResult.REJECT_FORMAT
        if snapshot.chunks <= 0 or not snapshot.hash:
            return OfferSnapshotResult.REJECT
        self._restore = {
            "snapshot": snapshot,
            "trusted_app_hash": app_hash,
            "chunks": {},
        }
        return OfferSnapshotResult.ACCEPT

    def apply_snapshot_chunk(self, index: int, chunk: bytes, sender: str) -> int:
        if self._restore is None:
            return ApplySnapshotChunkResult.ABORT
        snap: Snapshot = self._restore["snapshot"]
        self._restore["chunks"][index] = chunk
        if len(self._restore["chunks"]) < snap.chunks:
            return ApplySnapshotChunkResult.ACCEPT
        payload = b"".join(
            self._restore["chunks"][i] for i in range(snap.chunks)
        )
        if hashlib.sha256(payload).digest() != snap.hash:
            self._restore["chunks"].clear()
            return ApplySnapshotChunkResult.RETRY_SNAPSHOT
        height = int.from_bytes(payload[:8], "big")
        store: dict[bytes, bytes] = {}
        pos = 8
        while pos < len(payload):
            kl = int.from_bytes(payload[pos : pos + 4], "big")
            k = payload[pos + 4 : pos + 4 + kl]
            pos += 4 + kl
            vl = int.from_bytes(payload[pos : pos + 4], "big")
            v = payload[pos + 4 : pos + 4 + vl]
            pos += 4 + vl
            store[k] = v
        trusted = self._restore["trusted_app_hash"]
        self._restore = None
        # stage first: the restore only lands if it reproduces the
        # light-client-verified app hash (a lying snapshot must leave
        # the app untouched)
        staged_acc = self._acc_for(store)
        staged_hash = self._hash_of(height, staged_acc)
        if trusted and staged_hash != trusted:
            return ApplySnapshotChunkResult.REJECT_SNAPSHOT
        self.store = store
        self.pending = {}
        self._staged_cache = None
        self.height = height
        self._acc = staged_acc
        self.app_hash = staged_hash
        return ApplySnapshotChunkResult.ACCEPT

    def query(self, path: str, data: bytes, height: int = 0) -> QueryResponse:
        v = self.store.get(data)
        return QueryResponse(
            code=0 if v is not None else 1,
            key=data,
            value=v or b"",
            height=self.height,
        )
