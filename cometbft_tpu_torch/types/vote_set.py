"""VoteSet: 2/3-majority vote tallying for one (height, round, type).

Behavior parity: reference types/vote_set.go (AddVote :~180-320, maj23
promotion, peer-claimed majorities for VoteSetBits gossip, MakeCommit).
Key invariants preserved:

- `votes[i]` holds ONE canonical vote per validator; a conflicting second
  vote is rejected with ErrVoteConflictingVotes (evidence material) unless
  a peer has claimed +2/3 for that block (SetPeerMaj23), in which case it
  is tracked in the per-block tally but not in votes[].
- When a block reaches +2/3, its votes become the canonical ones
  (reference vote_set.go addVerifiedVote's maj23 promotion).
- MakeCommit turns a +2/3 precommit set into a Commit, degrading votes for
  *other* blocks to ABSENT (reference MakeCommit/MakeExtendedCommit).

Twin of `cometbft_tpu/types/vote_set.py` without its certificate half:
`apply_certificate` raises UnsupportedCommitFormat (the port has no BLS),
so a set's majority always comes from its votes and `make_commit` always
yields a signature column.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..utils.bits import BitArray
from .basic import BlockID
from .block import BlockIDFlag, Commit, CommitSig, UnsupportedCommitFormat
from .validator_set import ValidatorSet
from .vote import SignedMsgType, Vote


class ErrVoteUnexpectedStep(Exception):
    pass


class ErrVoteInvalidValidatorIndex(Exception):
    pass


class ErrVoteInvalidValidatorAddress(Exception):
    pass


class ErrVoteInvalidSignature(Exception):
    pass


class ErrVoteNonDeterministicSignature(Exception):
    pass


class ErrVoteConflictingVotes(Exception):
    """Equivocation: two signed votes for different blocks at the same HRS.

    `added` mirrors the reference's (added, err) pair: a conflicting vote
    for a peer-claimed maj23 block IS tracked (added=True) while still
    surfacing the equivocation for the evidence pool."""

    def __init__(self, existing: Vote, new: Vote, added: bool = False):
        super().__init__(
            f"conflicting votes from validator {existing.validator_address.hex()}"
        )
        self.vote_a = existing
        self.vote_b = new
        self.added = added


def _block_key(block_id: BlockID) -> bytes:
    return block_id.key()


class _BlockVotes:
    """Tally for a single block ID (reference blockVotes)."""

    __slots__ = ("peer_maj23", "bit_array", "votes", "sum")

    def __init__(self, peer_maj23: bool, num_validators: int):
        self.peer_maj23 = peer_maj23
        self.bit_array = BitArray(num_validators)
        self.votes: list[Vote | None] = [None] * num_validators
        self.sum = 0

    def add_verified_vote(self, vote: Vote, power: int):
        idx = vote.validator_index
        if self.votes[idx] is None:
            self.bit_array.set(idx)
            self.votes[idx] = vote
            self.sum += power

    def get_by_index(self, idx: int) -> Vote | None:
        return self.votes[idx]


class VoteSet:
    def __init__(
        self,
        chain_id: str,
        height: int,
        round_: int,
        signed_msg_type: SignedMsgType,
        val_set: ValidatorSet,
    ):
        if height < 1:
            raise ValueError("VoteSet height must be >= 1")
        self.chain_id = chain_id
        self.height = height
        self.round = round_
        self.signed_msg_type = SignedMsgType(signed_msg_type)
        self.val_set = val_set
        n = len(val_set)
        self.votes_bit_array = BitArray(n)
        self.votes: list[Vote | None] = [None] * n
        self.sum = 0
        self.maj23: BlockID | None = None
        self.votes_by_block: dict[bytes, _BlockVotes] = {}
        self.peer_maj23s: dict[str, BlockID] = {}

    # ------------------------------------------------------------------
    def size(self) -> int:
        return len(self.val_set)

    def add_vote(self, vote: Vote, verify: bool = True) -> bool:
        """Add a vote; True if it changed the set. Raises on invalid votes.

        Mirrors reference AddVote: returns False (no error) for exact
        duplicates; raises ErrVoteConflictingVotes for equivocation (the
        caller turns it into evidence).
        """
        if vote is None:
            raise ValueError("nil vote")
        if (
            vote.height != self.height
            or vote.round != self.round
            or vote.type != self.signed_msg_type
        ):
            raise ErrVoteUnexpectedStep(
                f"expected {self.height}/{self.round}/{self.signed_msg_type}, got "
                f"{vote.height}/{vote.round}/{vote.type}"
            )
        idx = vote.validator_index
        if idx < 0:
            raise ErrVoteInvalidValidatorIndex("index < 0")
        val = self.val_set.get_by_index(idx)
        if val is None:
            raise ErrVoteInvalidValidatorIndex(f"no validator at index {idx}")
        if val.address != vote.validator_address:
            raise ErrVoteInvalidValidatorAddress(
                f"index {idx} is {val.address.hex()}, vote claims "
                f"{vote.validator_address.hex()}"
            )

        existing = self.votes[idx]
        if existing is not None and existing.block_id == vote.block_id:
            if existing.signature != vote.signature:
                raise ErrVoteNonDeterministicSignature(
                    "same vote, different signature"
                )
            return False  # exact duplicate

        if verify and not val.pub_key.verify_signature(
            vote.sign_bytes(self.chain_id), vote.signature
        ):
            raise ErrVoteInvalidSignature(
                f"invalid signature from {vote.validator_address.hex()}"
            )

        return self._add_verified(vote, val.voting_power)

    def _add_verified(self, vote: Vote, power: int) -> bool:
        idx = vote.validator_index
        key = _block_key(vote.block_id)
        existing = self.votes[idx]
        conflict = existing is not None and existing.block_id != vote.block_id

        bv = self.votes_by_block.get(key)
        if conflict and (bv is None or not bv.peer_maj23):
            raise ErrVoteConflictingVotes(existing, vote, added=False)
        if bv is None:
            bv = _BlockVotes(peer_maj23=False, num_validators=self.size())
            self.votes_by_block[key] = bv

        if existing is None:
            self.votes[idx] = vote
            self.votes_bit_array.set(idx)
            self.sum += power
        elif conflict and self.maj23 is not None and _block_key(self.maj23) == key:
            # conflicting vote FOR the established maj23 block becomes the
            # canonical one (reference vote_set.go addVerifiedVote)
            self.votes[idx] = vote

        old_sum = bv.sum
        quorum = self.val_set.total_voting_power() * 2 // 3 + 1
        bv.add_verified_vote(vote, power)

        if old_sum < quorum <= bv.sum and self.maj23 is None:
            self.maj23 = vote.block_id
            # promote this block's votes to canonical (reference :~300)
            for i, v in enumerate(bv.votes):
                if v is not None:
                    self.votes[i] = v
        if conflict:
            raise ErrVoteConflictingVotes(existing, vote, added=True)
        return True

    # ------------------------------------------------------------------
    def set_peer_maj23(self, peer_id: str, block_id: BlockID) -> None:
        """A peer claims +2/3 for block_id (reference SetPeerMaj23)."""
        key = _block_key(block_id)
        prev = self.peer_maj23s.get(peer_id)
        if prev is not None:
            if prev == block_id:
                return
            raise ValueError(f"conflicting maj23 claim from peer {peer_id}")
        self.peer_maj23s[peer_id] = block_id
        bv = self.votes_by_block.get(key)
        if bv is not None:
            bv.peer_maj23 = True
        else:
            self.votes_by_block[key] = _BlockVotes(True, self.size())

    def bit_array(self) -> BitArray:
        return self.votes_bit_array.copy()

    def bit_array_by_block_id(self, block_id: BlockID) -> BitArray | None:
        bv = self.votes_by_block.get(_block_key(block_id))
        return bv.bit_array.copy() if bv else None

    def get_by_index(self, idx: int) -> Vote | None:
        return self.votes[idx]

    def get_by_address(self, addr: bytes) -> Vote | None:
        i, _ = self.val_set.get_by_address(addr)
        return self.votes[i] if i >= 0 else None

    # ------------------------------------------------------------------
    def has_two_thirds_majority(self) -> bool:
        return self.maj23 is not None

    def two_thirds_majority(self) -> tuple[BlockID | None, bool]:
        return (self.maj23, self.maj23 is not None)

    def has_two_thirds_any(self) -> bool:
        return self.sum > self.val_set.total_voting_power() * 2 // 3

    def has_all(self) -> bool:
        return self.sum == self.val_set.total_voting_power()

    # ------------------------------------------------------------------
    def apply_certificate(self, cert) -> bool:
        """Refused: an aggregate-precommit certificate is BLS, which the
        port does not verify."""
        raise UnsupportedCommitFormat(
            "aggregate-precommit certificates (BLS) are not supported by the port")

    def make_commit(self) -> Commit:
        """+2/3 precommit set -> Commit (reference MakeCommit)."""
        if self.signed_msg_type != SignedMsgType.PRECOMMIT:
            raise ValueError("cannot MakeCommit() unless VoteSet.Type is PRECOMMIT")
        if self.maj23 is None or self.maj23.is_zero():
            raise ValueError("cannot MakeCommit() unless +2/3 for a block")
        sigs = []
        for i, v in enumerate(self.votes):
            if v is None:
                sigs.append(CommitSig.absent())
                continue
            if not v.is_nil() and v.block_id != self.maj23:
                sigs.append(CommitSig.absent())  # vote for another block
                continue
            flag = BlockIDFlag.NIL if v.is_nil() else BlockIDFlag.COMMIT
            sigs.append(
                CommitSig(
                    block_id_flag=flag,
                    validator_address=v.validator_address,
                    timestamp=v.timestamp,
                    signature=v.signature,
                )
            )
        return Commit(
            height=self.height,
            round=self.round,
            block_id=self.maj23,
            signatures=sigs,
        )

    def make_extended_commit(self):
        """+2/3 precommit set -> ExtendedCommit carrying vote extensions
        (reference MakeExtendedCommit)."""
        from .extended_commit import ExtendedCommit, ExtendedCommitSig

        base = self.make_commit()
        ext_sigs = []
        for cs, v in zip(base.signatures, self.votes):
            ext_sigs.append(
                ExtendedCommitSig(
                    block_id_flag=cs.block_id_flag,
                    validator_address=cs.validator_address,
                    timestamp=cs.timestamp,
                    signature=cs.signature,
                    extension=(v.extension if v is not None
                               and cs.block_id_flag == BlockIDFlag.COMMIT
                               else b""),
                    extension_signature=(
                        v.extension_signature if v is not None
                        and cs.block_id_flag == BlockIDFlag.COMMIT else b""
                    ),
                )
            )
        return ExtendedCommit(
            height=base.height,
            round=base.round,
            block_id=base.block_id,
            extended_signatures=ext_sigs,
        )
