"""State store: current state + per-height validator sets and ABCI results.

Behavior parity with reference internal/state/store.go:132: validators are
saved per height so light/evidence verification can look back; finalize
responses are saved for last_results_hash and reindexing; pruning removes
old heights (reference :297).

Twin of `cometbft_tpu/storage/statestore.py`: the same keys and bytes.
"""

from __future__ import annotations

from ..encoding import proto as pb
from .kv import KVStore

_KEY_STATE = b"S:cur"


def _key_vals(h: int) -> bytes:
    return b"SV:" + h.to_bytes(8, "big")


def _key_abci(h: int) -> bytes:
    return b"SA:" + h.to_bytes(8, "big")


def _key_params(h: int) -> bytes:
    return b"SP:" + h.to_bytes(8, "big")


class StateStore:
    def __init__(self, db: KVStore):
        self._db = db

    def save(self, state) -> None:
        from ..state.types import encode_validator_set

        # `validators` is the set for the NEXT height to commit; at genesis
        # (last_block_height == 0) that is initial_height, not 1 (reference
        # internal/state/store.go Bootstrap vs save split).
        next_height = max(state.last_block_height + 1, state.initial_height)
        sets = [(_KEY_STATE, state.encode())]
        # params used to validate block `next_height` (reference
        # internal/state/store.go saveConsensusParamsInfo)
        from ..state.types import encode_params

        sets.append((_key_params(next_height), encode_params(state.consensus_params)))
        if state.next_validators is not None:
            sets.append(
                (
                    _key_vals(next_height + 1),
                    encode_validator_set(state.next_validators),
                )
            )
        if state.validators is not None:
            sets.append(
                (_key_vals(next_height), encode_validator_set(state.validators))
            )
        self._db.write_batch(sets)

    def load(self):
        from ..state.types import State

        raw = self._db.get(_KEY_STATE)
        return State.decode(raw) if raw else None

    def load_consensus_params(self, height: int):
        """Params as of validating block `height`, or None if unsaved
        (reference internal/state/store.go LoadConsensusParams)."""
        from ..state.types import decode_params

        raw = self._db.get(_key_params(height))
        return decode_params(raw) if raw else None

    def load_validators(self, height: int):
        from ..state.types import decode_validator_set

        raw = self._db.get(_key_vals(height))
        return decode_validator_set(raw) if raw else None

    def save_finalize_response(self, height: int, payload: bytes) -> None:
        self._db.set(_key_abci(height), payload)

    def load_finalize_response(self, height: int) -> bytes | None:
        return self._db.get(_key_abci(height))

    def save_abci_responses(self, height: int, payload: bytes) -> None:
        """Full encoded FinalizeBlockResponse (reference
        state/store.go SaveFinalizeBlockResponse) — what reindexing and
        /block_results serve; save_finalize_response keeps only the
        results hash the header commits to."""
        self._db.set(b"AR:" + height.to_bytes(8, "big"), payload)

    def load_abci_responses(self, height: int) -> bytes | None:
        return self._db.get(b"AR:" + height.to_bytes(8, "big"))

    def prune(self, retain_height: int, current_height: int) -> int:
        deletes = []
        pruned = 0
        for h in range(1, retain_height):
            if self._db.has(_key_vals(h)) or self._db.has(_key_abci(h)):
                deletes += [_key_vals(h), _key_abci(h), _key_params(h),
                            b"AR:" + h.to_bytes(8, "big")]
                pruned += 1
        if deletes:
            self._db.write_batch([], deletes)
        return pruned
