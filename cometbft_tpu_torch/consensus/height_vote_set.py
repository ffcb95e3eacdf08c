"""Prevotes + precommits for every round of one height.

Behavior parity: reference internal/consensus/height_vote_set.go —
round-keyed VoteSets created on demand, a cap on peer-initiated "catchup"
rounds (one per peer), POL (proof-of-lock) lookup scanning rounds
descending.

The port's own copy of `cometbft_tpu/consensus/height_vote_set.py`,
unchanged.
"""

from __future__ import annotations

from ..types.basic import BlockID
from ..types.validator_set import ValidatorSet
from ..types.vote import SignedMsgType, Vote
from ..types.vote_set import VoteSet


class HeightVoteSet:
    def __init__(self, chain_id: str, height: int, val_set: ValidatorSet):
        self.chain_id = chain_id
        self.height = height
        self.val_set = val_set
        self.round = 0
        self._sets: dict[int, dict[SignedMsgType, VoteSet]] = {}
        self._peer_catchup_rounds: dict[str, list[int]] = {}
        self.set_round(0)

    def _ensure_round(self, r: int):
        if r not in self._sets:
            self._sets[r] = {
                SignedMsgType.PREVOTE: VoteSet(
                    self.chain_id, self.height, r, SignedMsgType.PREVOTE, self.val_set
                ),
                SignedMsgType.PRECOMMIT: VoteSet(
                    self.chain_id, self.height, r, SignedMsgType.PRECOMMIT, self.val_set
                ),
            }

    def set_round(self, r: int) -> None:
        """Track a new current round (creates r and r+1 like the reference)."""
        self._ensure_round(r)
        self._ensure_round(r + 1)
        self.round = max(self.round, r)

    def add_vote(self, vote: Vote, peer_id: str = "") -> bool:
        """Route a vote to its round's set. Peer votes for unknown future
        rounds are capped at one catchup round per peer (reference :~100)."""
        if vote.round not in self._sets:
            if peer_id:
                rounds = self._peer_catchup_rounds.setdefault(peer_id, [])
                if len(rounds) < 2:
                    self._ensure_round(vote.round)
                    rounds.append(vote.round)
                else:
                    return False  # GossipVotesAndPrecommitsError equivalent
            else:
                self._ensure_round(vote.round)
        return self._sets[vote.round][vote.type].add_vote(vote)

    def prevotes(self, r: int) -> VoteSet | None:
        return self._sets.get(r, {}).get(SignedMsgType.PREVOTE)

    def precommits(self, r: int) -> VoteSet | None:
        return self._sets.get(r, {}).get(SignedMsgType.PRECOMMIT)

    def pol_info(self) -> tuple[int, BlockID | None]:
        """Highest round with a prevote +2/3 majority (reference POLInfo)."""
        for r in sorted(self._sets, reverse=True):
            vs = self.prevotes(r)
            if vs is not None:
                maj, ok = vs.two_thirds_majority()
                if ok:
                    return r, maj
        return -1, None

    def set_peer_maj23(self, round_: int, vtype: SignedMsgType, peer_id: str,
                       block_id: BlockID) -> None:
        self._ensure_round(round_)
        self._sets[round_][vtype].set_peer_maj23(peer_id, block_id)
