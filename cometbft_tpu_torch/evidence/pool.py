"""Evidence pool: verify, persist, propose, prune (twin of
`cometbft_tpu/evidence/pool.py`; the gossip reactor comes with the p2p
slice).

Behavior parity: reference internal/evidence/pool.go —
- AddEvidence verifies against historical state (validator set at the
  evidence height) and persists it pending (:~130).
- PendingEvidence(maxBytes) returns proposable evidence (:~190).
- Update marks block-committed evidence, prunes expired (:~230) using the
  consensus params' evidence age (height AND time, both must expire).
- ReportConflictingVotes is the consensus-state hookup
  (reference internal/consensus/state.go:60-63); votes become
  DuplicateVoteEvidence on the next Update when the height's validator
  set is known.
"""

from __future__ import annotations

import threading

from ..storage.kv import KVStore, MemKV
from ..types import Timestamp
from ..types.evidence import (
    DuplicateVoteEvidence,
    EvidenceError,
    decode_evidence,
)


def _key_pending(h: int, ev_hash: bytes) -> bytes:
    return b"EP:" + h.to_bytes(8, "big") + ev_hash


def _key_committed(ev_hash: bytes) -> bytes:
    return b"EC:" + ev_hash


class EvidencePool:
    def __init__(self, db: KVStore | None = None, state_store=None,
                 block_store=None, chain_id: str = ""):
        self._db = db or MemKV()
        self.state_store = state_store
        self.block_store = block_store
        self.chain_id = chain_id
        self._lock = threading.Lock()
        self._conflicting_votes: list = []  # (vote_a, vote_b) pairs

    # ------------------------------------------------------------------
    def _validators_at(self, height: int):
        if self.state_store is None:
            return None
        return self.state_store.load_validators(height)

    def add_evidence(self, ev) -> None:
        """Verify + persist (reference AddEvidence)."""
        with self._lock:
            if self._db.has(_key_committed(ev.hash())):
                return  # already committed: no-op
            if isinstance(ev, DuplicateVoteEvidence):
                vals = self._validators_at(ev.height)
                if vals is not None:
                    ev.verify(self.chain_id, vals)
                elif self.state_store is not None:
                    raise EvidenceError(
                        f"no validator set stored for height {ev.height}"
                    )
            self._db.set(_key_pending(ev.height, ev.hash()), ev.wrapped())

    def check_evidence(self, evidence: list, max_bytes: int | None = None
                       ) -> None:
        """Verify a block's proposed evidence before accepting the block
        (reference internal/evidence/pool.go CheckEvidence + verify.go):
        every item must verify against the historical validator set, and
        the total encoded size must respect the params cap."""
        total = 0
        seen = set()
        for ev in evidence:
            h = ev.hash()
            if h in seen:
                raise EvidenceError("duplicate evidence in block")
            seen.add(h)
            total += len(ev.wrapped())
            if self._db.has(_key_committed(h)):
                raise EvidenceError("evidence already committed")
            if isinstance(ev, DuplicateVoteEvidence):
                vals = self._validators_at(ev.height)
                if vals is None:
                    raise EvidenceError(
                        f"no validator set stored for height {ev.height}"
                    )
                ev.verify(self.chain_id, vals)
            # LightClientAttackEvidence structural checks happen in the
            # light detector; here reject unknown shapes defensively
        if max_bytes is not None and total > max_bytes:
            raise EvidenceError(f"evidence bytes {total} > cap {max_bytes}")

    def report_conflicting_votes(self, vote_a, vote_b) -> None:
        """Consensus hands us raw equivocations
        (reference Pool.ReportConflictingVotes)."""
        with self._lock:
            self._conflicting_votes.append((vote_a, vote_b))

    def _materialize_conflicts(self, state) -> None:
        pending, self._conflicting_votes = self._conflicting_votes, []
        for a, b in pending:
            vals = self._validators_at(a.height)
            if vals is None:
                continue
            _, val = vals.get_by_address(a.validator_address)
            if val is None:
                continue
            ev = DuplicateVoteEvidence.from_votes(
                a, b, val.voting_power, vals.total_voting_power(),
                state.last_block_time,
            )
            try:
                ev.verify(self.chain_id, vals)
            except EvidenceError:
                continue
            self._db.set(_key_pending(ev.height, ev.hash()), ev.wrapped())

    # ------------------------------------------------------------------
    def pending_evidence(self, max_bytes: int = 1 << 20) -> list:
        out, total = [], 0
        for _, raw in self._db.iterate_prefix(b"EP:"):
            if total + len(raw) > max_bytes:
                break
            out.append(decode_evidence(raw))
            total += len(raw)
        return out

    def update(self, state, committed_evidence: list) -> None:
        """Post-commit: mark committed, materialize reports, prune expired
        (reference Pool.Update)."""
        with self._lock:
            for ev in committed_evidence:
                self._db.set(_key_committed(ev.hash()), b"\x01")
                self._db.delete(_key_pending(ev.height, ev.hash()))
        self._materialize_conflicts(state)
        self._prune(state)

    def _prune(self, state) -> None:
        params = state.consensus_params.evidence
        min_height = state.last_block_height - params.max_age_num_blocks
        min_time_ns = (
            state.last_block_time.unix_ns()
            - params.max_age_duration_ns
        )
        deletes = []
        for key, raw in self._db.iterate_prefix(b"EP:"):
            h = int.from_bytes(key[3:11], "big")
            if h >= min_height:
                break  # keys are height-ordered
            ev = decode_evidence(raw)
            ts = getattr(ev, "timestamp", Timestamp())
            if ts.unix_ns() < min_time_ns:
                deletes.append(key)
        if deletes:
            self._db.write_batch([], deletes)

    def size(self) -> int:
        return sum(1 for _ in self._db.iterate_prefix(b"EP:"))
