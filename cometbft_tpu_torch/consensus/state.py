"""The Tendermint consensus state machine.

Behavior parity: reference internal/consensus/state.go —
- the single-threaded receive loop processing peer messages, own messages,
  and timeouts, WAL-logging each message BEFORE acting on it
  (receiveRoutine :775-863; own messages fsync via WriteSync :830);
- the step functions enterNewRound :1043, enterPropose :1130,
  enterPrevote :1312, enterPrevoteWait, enterPrecommit :1514,
  enterPrecommitWait, enterCommit :1649, tryFinalizeCommit :1712,
  finalizeCommit :1740 with the lock/unlock/valid-block (POL) rules;
- vote accounting addVote :2161 including last-commit precommits from the
  previous height;
- crash recovery: catchup_replay re-handles WAL records logged after the
  last #ENDHEIGHT (reference internal/consensus/replay.go:94), with
  signing idempotence delegated to the FilePV last-sign state.

Gossip transport: over real p2p the consensus reactor gossips proposals
as 64 KiB merkle-proved parts (consensus/reactor.py, reference
internal/consensus/reactor.go); the in-process loopback path used by
tests can also deliver whole blocks via BlockBytesMessage through
_handle_block_bytes. The part-set machinery defines BlockID either way
(types/part_set.py).

Twin of `cometbft_tpu/consensus/state.py`: `validate_block` runs on the
executor's `device` where the reference passes its `backend`. Two
departures, each a refusal or a halt and never another verdict:

- no certificate-native path: an AggregateCommitMessage is refused by
  name (UnsupportedCommitFormat) and never reaches the WAL, and the
  reference's `cert_native` option is absent (port validator sets are
  Ed25519 only, so the reference's fold never applies to them);
- a peer's message whose handling raises a device error
  (`ops.kernels.is_device_error`: a kernel that did not build or launch,
  a CUDA error) halts the node as an error on its own message does; the
  reference drops every exception a peer's message raises, which would
  hide a failed kernel behind a missing prevote. A malformed message is
  still dropped.
"""

from __future__ import annotations

import enum
import queue
import threading
import time
import time as _time
from dataclasses import dataclass, field as dc_field

from ..ops.kernels import is_device_error
from ..state.execution import BlockExecutor, BlockValidationError, validate_block
from ..utils import trace
from ..utils import txlife as _txlife
from ..utils.fail import fail_point
from ..utils.log import logger
from ..utils.metrics import consensus_metrics
from ..types import (
    Block,
    BlockID,
    Commit,
    Proposal,
    Timestamp,
    ValidatorSet,
    Vote,
)
from ..types.block import block_id_for
from ..types.evidence import evidence_list_hash
from ..types.vote import SignedMsgType
from ..types.vote_set import ErrVoteConflictingVotes, VoteSet
from .height_vote_set import HeightVoteSet
from .ticker import TimeoutInfo, TimeoutTicker
from .wal import (
    AggregateCommitMessage,
    BlockBytesMessage,
    MsgInfo,
    TimeoutMessage,
    WAL,
    refuse_certificate,
)


class RoundStep(enum.IntEnum):
    NEW_HEIGHT = 1
    NEW_ROUND = 2
    PROPOSE = 3
    PREVOTE = 4
    PREVOTE_WAIT = 5
    PRECOMMIT = 6
    PRECOMMIT_WAIT = 7
    COMMIT = 8


@dataclass
class TimeoutConfig:
    """Step timeouts (reference config/config.go ConsensusConfig defaults,
    scaled down for in-process nets by tests)."""

    propose: float = 3.0
    propose_delta: float = 0.5
    prevote: float = 1.0
    prevote_delta: float = 0.5
    precommit: float = 1.0
    precommit_delta: float = 0.5
    commit: float = 1.0

    def propose_timeout(self, round_: int) -> float:
        return self.propose + self.propose_delta * round_

    def prevote_timeout(self, round_: int) -> float:
        return self.prevote + self.prevote_delta * round_

    def precommit_timeout(self, round_: int) -> float:
        return self.precommit + self.precommit_delta * round_


@dataclass
class ProposalMessage:
    proposal: Proposal


@dataclass
class VoteMessage:
    vote: Vote
    # votes normally propagate by gossip pull from the vote sets; a
    # vote that is deliberately NOT in our own set (the byzantine
    # shadow from privval/byzantine.py) must be pushed on the wire
    # explicitly or it never leaves the process. Local-only flag —
    # the codec encodes just the vote.
    direct: bool = False


@dataclass
class _SpeculativeProposal:
    """A proposal block assembled ahead of enter_propose, with everything
    the assembly depended on so the consume seam can prove nothing moved.
    `state` is identity-compared: a different object means ApplyBlock ran
    again (app hash, valset, results all derive from it)."""

    height: int
    state: object
    last_commit_hash: bytes
    mempool_version: int
    block: Block
    block_id: BlockID


class ConsensusState:
    """One validator's consensus engine over an in-process transport."""

    def __init__(
        self,
        chain_id: str,
        sm_state,
        executor: BlockExecutor,
        block_store,
        privval,
        wal: WAL,
        broadcast=None,
        timeouts: TimeoutConfig | None = None,
        tx_source=None,
        name: str = "",
        now_ns=None,
        ticker_factory=None,
        speculative: bool = False,
        mempool_version=None,
    ):
        self.chain_id = chain_id
        self.sm_state = sm_state
        self.executor = executor
        self.block_store = block_store
        self.privval = privval
        self.wal = wal
        self.broadcast = broadcast or (lambda msg: None)
        self.timeouts = timeouts or TimeoutConfig()
        self.tx_source = tx_source or (lambda: [])
        self.name = name or (privval.address().hex()[:8] if privval else "observer")
        self.now_ns = now_ns or time.time_ns
        # speculative proposal assembly: when enabled and this
        # node proposes the next height, reap + block assembly run in a
        # background worker during the commit gap; mempool_version is the
        # staleness probe the consume seam checks (CListMempool.version)
        self.speculative = speculative
        self.mempool_version = mempool_version or (lambda: 0)
        self._spec_lock = threading.Lock()
        self._spec_thread: threading.Thread | None = None
        self._spec: _SpeculativeProposal | None = None

        self._log = logger("consensus").with_fields(node=self.name)
        self._last_commit_mono: float | None = None
        self.inbox: queue.Queue = queue.Queue()
        # reactor hooks: step-change broadcast + HasVote announcements
        # (reference broadcastNewRoundStepMessage / broadcastHasVoteMessage)
        self.on_new_step = None
        self.on_has_vote = None
        self.ticker = (ticker_factory or TimeoutTicker)(self._on_ticker_timeout)
        self.evidence: list[ErrVoteConflictingVotes] = []
        self.decided: dict[int, BlockID] = {}  # height -> committed block id
        self._replay_mode = False
        self._stopped = threading.Event()
        self.halt_error: BaseException | None = None  # what stopped the loop
        self._thread: threading.Thread | None = None
        self._step_cv = threading.Condition()
        # round-state snapshot lock: the consensus thread holds it across
        # each _process (one message/timeout = one atomic round-state
        # transition), so RPC dump routes can take a CONSISTENT snapshot
        # by acquiring it instead of retry-sampling racy fields. RLock:
        # handlers re-enter _process-held paths via the WAL replay seam.
        self.rs_mutex = threading.RLock()

        # --- RoundState ---
        self.height = sm_state.last_block_height + 1
        self.round = 0
        self.step = RoundStep.NEW_HEIGHT
        self._step_t0 = time.perf_counter()
        self.validators: ValidatorSet = sm_state.validators.copy()
        self.proposal: Proposal | None = None
        self.proposal_block: Block | None = None
        self.proposal_block_id: BlockID | None = None
        self.locked_round = -1
        self.locked_block: Block | None = None
        self.locked_block_id: BlockID | None = None
        self.valid_round = -1
        self.valid_block: Block | None = None
        self.valid_block_id: BlockID | None = None
        self.votes = HeightVoteSet(chain_id, self.height, self.validators)
        self.commit_round = -1
        self.last_commit: VoteSet | None = None
        self.triggered_timeout_precommit = False
        # tx lifecycle observatory: sampled (index, key) pairs of the
        # current proposal block, hashed once per (height, block id)
        self._txlife_cache: tuple | None = None

    # ==================================================================
    # lifecycle
    # ==================================================================
    def reconstruct_last_commit(self) -> None:
        """Rebuild the last-commit VoteSet from the stored seen commit
        (reference state.go reconstructLastCommit) — restart path."""
        h = self.sm_state.last_block_height
        if h == 0 or self.block_store is None:
            return
        seen = self.block_store.load_seen_commit(h)
        if seen is None:
            return
        vals = self.sm_state.last_validators
        vs = VoteSet(self.chain_id, h, seen.round, SignedMsgType.PRECOMMIT, vals)
        for idx, cs in enumerate(seen.signatures):
            if cs.is_absent():
                continue
            vs.add_vote(
                Vote(
                    type=SignedMsgType.PRECOMMIT,
                    height=h,
                    round=seen.round,
                    block_id=cs.effective_block_id(seen.block_id),
                    timestamp=cs.timestamp,
                    validator_address=cs.validator_address,
                    validator_index=idx,
                    signature=cs.signature,
                ),
                verify=False,  # stored commit was verified before saving
            )
        self.last_commit = vs

    def extensions_enabled(self, height: int) -> bool:
        """Vote extensions active at `height` (reference
        ConsensusParams.ABCI.VoteExtensionsEnabled)."""
        eh = self.sm_state.consensus_params.abci.vote_extensions_enable_height
        return eh > 0 and height >= eh

    def reset_to_state(self, sm_state) -> None:
        """Re-anchor a not-yet-started instance to a newer state (the
        block-sync / state-sync → consensus hand-off; reference
        SwitchToConsensus, consensus/reactor.go:113)."""
        if self._thread is not None:
            raise RuntimeError("cannot reset a running consensus instance")
        self.sm_state = sm_state
        self.height = sm_state.last_block_height + 1
        self.round = 0
        self.step = RoundStep.NEW_HEIGHT
        self.validators = sm_state.validators.copy()
        self.votes = HeightVoteSet(self.chain_id, self.height, self.validators)
        self.last_commit = None
        self.proposal = None
        self.proposal_block = None
        self.proposal_block_id = None

    def start(self, replay_wal: bool = True) -> None:
        if self.last_commit is None and self.height > self.sm_state.initial_height:
            self.reconstruct_last_commit()
        if replay_wal:
            self.catchup_replay()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"cs-{self.name}")
        self._thread.start()
        self._schedule_round0_start()

    def _schedule_round0_start(self):
        # NewHeight -> round 0 after timeout_commit (immediately at genesis).
        self.ticker.schedule(
            TimeoutInfo(0.0, self.height, 0, int(RoundStep.NEW_HEIGHT))
        )

    def stop(self) -> None:
        self._stopped.set()
        self.ticker.stop()
        self.inbox.put(None)
        if self._thread:
            self._thread.join(timeout=5)
        self.wal.flush()

    # ==================================================================
    # inbound
    # ==================================================================
    def send(self, msg, peer_id: str) -> None:
        """Deliver a message from a peer (thread-safe)."""
        self.inbox.put(MsgInfo(msg, peer_id))

    def _on_ticker_timeout(self, ti: TimeoutInfo) -> None:
        self.inbox.put(ti)

    def _run(self) -> None:
        while not self._stopped.is_set():
            item = self.inbox.get()
            if item is None:
                break
            try:
                self._process(item)
            except Exception as e:  # noqa: BLE001 — reference panics halt chain
                import traceback

                traceback.print_exc()
                self.halt_error = e
                self._stopped.set()
                with self._step_cv:
                    self._step_cv.notify_all()
                raise

    def _process(self, item) -> None:
        before = (self.height, self.round, int(self.step))
        try:
            with self.rs_mutex:
                self._process_inner(item)
        finally:
            if self.on_new_step is not None and (
                (self.height, self.round, int(self.step)) != before
            ):
                try:
                    self.on_new_step()  # reactor broadcasts NewRoundStep
                except Exception:  # noqa: BLE001
                    pass

    def _process_inner(self, item) -> None:
        if isinstance(item, TimeoutInfo):
            self.wal.write(
                TimeoutMessage(ti_height(item), item.round, item.step)
            )
            self._handle_timeout(item)
        elif isinstance(item, MsgInfo):
            inner = item.msg
            if isinstance(inner, AggregateCommitMessage):
                # refused by name before the WAL: a peer's is dropped as
                # malformed, our own halts
                if item.peer_id == "":
                    raise refuse_certificate()
            elif item.peer_id == "":
                # own msgs hit disk first
                self.wal.write_sync(MsgInfo(_wal_payload(inner), ""))
                fail_point()  # reference state.go:843 (own msg persisted)
                self._handle_msg(inner, item.peer_id)
            else:
                self.wal.write(MsgInfo(_wal_payload(inner), item.peer_id))
                try:
                    self._handle_msg(inner, item.peer_id)
                except Exception as e:
                    # A malformed peer message must never halt consensus
                    # (reference drops it and punishes the peer); only our
                    # own messages are trusted to be well-formed. A device
                    # error is no fault of the message: it halts.
                    if is_device_error(e):
                        raise
        with self._step_cv:
            self._step_cv.notify_all()

    def _handle_msg(self, msg, peer_id: str) -> None:
        if isinstance(msg, (VoteMessage, Vote)):
            self._handle_vote(msg.vote if isinstance(msg, VoteMessage) else msg,
                              peer_id)
        elif isinstance(msg, (ProposalMessage, Proposal)):
            self._handle_proposal(
                msg.proposal if isinstance(msg, ProposalMessage) else msg, peer_id
            )
        elif isinstance(msg, BlockBytesMessage):
            self._handle_block_bytes(msg, peer_id)
        elif isinstance(msg, AggregateCommitMessage):
            raise refuse_certificate()
        else:
            raise TypeError(f"unknown consensus message {type(msg)}")

    # ==================================================================
    # handlers
    # ==================================================================
    def _handle_proposal(self, p: Proposal, peer_id: str) -> None:
        # reference defaultSetProposal (state.go:1876)
        if self.proposal is not None:
            return
        if p.height != self.height or p.round != self.round:
            return
        p.basic_validate()
        proposer = self.validators.get_proposer()
        if not proposer.pub_key.verify_signature(
            p.sign_bytes(self.chain_id), p.signature
        ):
            raise BlockValidationError("invalid proposal signature")
        self.proposal = p
        if (
            self.proposal_block is not None
            and self.proposal_block_id is not None
            and self.proposal_block_id == p.block_id
        ):
            self._on_complete_proposal()

    def _handle_block_bytes(self, bb: BlockBytesMessage, peer_id: str) -> None:
        if bb.height != self.height:
            return
        if self.proposal_block is not None:
            return
        block = Block.decode(bb.block_bytes)
        bid = block_id_for(block)
        committed_id = None
        if self.commit_round >= 0:
            committed_id, _ = self.votes.precommits(self.commit_round).two_thirds_majority()
        wanted = (self.proposal is not None and bid == self.proposal.block_id) or (
            committed_id is not None and bid == committed_id
        )
        if not wanted and self.proposal is not None:
            return  # not the block we're looking for; drop
        self.proposal_block = block
        self.proposal_block_id = bid
        if self.proposal is not None and bid == self.proposal.block_id:
            self._on_complete_proposal()
        elif committed_id is not None and bid == committed_id:
            self._try_finalize_commit(self.height)

    def _on_complete_proposal(self) -> None:
        # reference handleCompleteProposal (state.go:2045)
        if self.step == RoundStep.PROPOSE:
            self.enter_prevote(self.height, self.round)
        elif self.step == RoundStep.COMMIT or self.commit_round >= 0:
            self._try_finalize_commit(self.height)

    def _handle_vote(self, v: Vote, peer_id: str) -> None:
        # reference tryAddVote/addVote (state.go:2095,2161)
        if v.height + 1 == self.height and v.type == SignedMsgType.PRECOMMIT:
            if self.step != RoundStep.NEW_HEIGHT or self.last_commit is None:
                return
            try:
                self.last_commit.add_vote(v)
            except ErrVoteConflictingVotes as e:
                self.evidence.append(e)
                self._trace_conflicting_votes(e)
            except Exception:
                pass
            return
        if v.height != self.height:
            return
        if (
            v.type == SignedMsgType.PRECOMMIT
            and not v.is_nil()
            and self.extensions_enabled(self.height)
            and peer_id != ""
        ):
            # reference addVote: peers' precommits must carry a valid
            # extension signature AND pass the app's VerifyVoteExtension
            if not self._verify_vote_extension(v):
                return
        try:
            added = self.votes.add_vote(v, peer_id)
        except ErrVoteConflictingVotes as e:
            self.evidence.append(e)
            self._trace_conflicting_votes(e)
            pool = getattr(self.executor, "evidence_pool", None)
            if pool is not None:  # reference evidencePool.ReportConflictingVotes
                pool.report_conflicting_votes(e.vote_a, e.vote_b)
            if not e.added:
                return
            added = True
        except Exception:
            if peer_id == "":
                raise  # own vote must never be invalid
            return  # bad peer vote: drop (peer punishment at p2p layer)
        if not added:
            return

        if self.on_has_vote is not None:
            try:
                self.on_has_vote(v)  # reactor broadcasts HasVote
            except Exception:  # noqa: BLE001 — gossip must not stall consensus
                pass

        if v.type == SignedMsgType.PREVOTE:
            self._after_prevote(v)
        else:
            self._after_precommit(v)

    def _verify_vote_extension(self, v: Vote) -> bool:
        _, val = self.validators.get_by_address(v.validator_address)
        if val is None:
            return False
        if not v.extension_signature:
            return False
        if not val.pub_key.verify_signature(
            v.extension_sign_bytes(self.chain_id), v.extension_signature
        ):
            return False
        return bool(
            self.executor.app.consensus.verify_vote_extension(
                v.height, v.validator_address, v.extension
            )
        )

    def _after_prevote(self, v: Vote) -> None:
        prevotes = self.votes.prevotes(v.round)
        maj, ok = prevotes.two_thirds_majority()
        if ok:
            # unlock on a later-round POL for a different block (state.go:2230)
            if (
                self.locked_block is not None
                and self.locked_round < v.round <= self.round
                and self.locked_block_id != maj
            ):
                self.locked_round = -1
                self.locked_block = None
                self.locked_block_id = None
            # track the most recent possible valid block (state.go:2246)
            if (
                not maj.is_zero()
                and (self.valid_round < v.round)
                and v.round == self.round
            ):
                if self.proposal_block_id == maj:
                    self.valid_round = v.round
                    self.valid_block = self.proposal_block
                    self.valid_block_id = maj
            if (_txlife.enabled and not maj.is_zero()
                    and self.proposal_block is not None
                    and self.proposal_block_id == maj):
                _txlife.stage_block(
                    self._lifecycle_pairs(self.proposal_block, maj),
                    "prevote_quorum", height=self.height, round=v.round)

        if self.round < v.round and prevotes.has_two_thirds_any():
            self.enter_new_round(self.height, v.round)
        elif self.round == v.round and self.step >= RoundStep.PREVOTE:
            if ok and (maj.is_zero() or maj == self.proposal_block_id
                       or maj == self.locked_block_id):
                self.enter_precommit(self.height, v.round)
            elif prevotes.has_two_thirds_any() and self.step == RoundStep.PREVOTE:
                self.enter_prevote_wait(self.height, v.round)
        elif (
            self.proposal is not None
            and 0 <= self.proposal.pol_round == v.round
            and self.step == RoundStep.PROPOSE
            and self._proposal_complete()
        ):
            self.enter_prevote(self.height, self.round)

    def _after_precommit(self, v: Vote) -> None:
        self._check_precommit_progress(v.round)

    def _check_precommit_progress(self, r: int) -> None:
        """Drive step transitions off round r's precommit set."""
        precommits = self.votes.precommits(r)
        maj, ok = precommits.two_thirds_majority()
        if ok:
            self.enter_new_round(self.height, r)
            self.enter_precommit(self.height, r)
            if not maj.is_zero():
                self.enter_commit(self.height, r)
            else:
                self.enter_precommit_wait(self.height, r)
        elif self.round <= r and precommits.has_two_thirds_any():
            self.enter_new_round(self.height, r)
            self.enter_precommit_wait(self.height, r)

    def _handle_timeout(self, ti: TimeoutInfo) -> None:
        # reference handleTimeout (state.go:982)
        if ti.height != self.height:
            return
        step = RoundStep(ti.step)
        if step == RoundStep.NEW_HEIGHT:
            self.enter_new_round(self.height, 0)
            return
        if ti.round < self.round or (
            ti.round == self.round and step < self.step
        ):
            return
        if step == RoundStep.PROPOSE:
            self.enter_prevote(self.height, ti.round)
        elif step == RoundStep.PREVOTE_WAIT:
            self.enter_precommit(self.height, ti.round)
        elif step == RoundStep.PRECOMMIT_WAIT:
            self.enter_precommit(self.height, ti.round)
            self.enter_new_round(self.height, ti.round + 1)

    # ==================================================================
    # step functions
    # ==================================================================
    def _update_step(self, round_: int, step: RoundStep) -> None:
        # Every step transition funnels through here: close the span for
        # the step being left (tracer + step-duration histogram), then
        # switch. One perf_counter read per transition when idle.
        prev = self.step
        if prev != step:
            now = time.perf_counter()
            dur = now - self._step_t0
            self._step_t0 = now
            consensus_metrics().step_duration_seconds.observe(dur, prev.name)
            if trace.enabled:
                trace.emit(
                    "consensus.step", "span", step=prev.name,
                    height=self.height, round=self.round,
                    dur_ms=round(dur * 1e3, 3), next=step.name,
                )
        self.round = round_
        self.step = step

    def enter_new_round(self, h: int, r: int) -> None:
        if h != self.height or r < self.round or (
            r == self.round and self.step != RoundStep.NEW_HEIGHT
        ):
            return
        if r > self.round:
            self.validators.increment_proposer_priority(r - self.round)
        self._log.debug("entering new round", height=h, round=r)
        consensus_metrics().rounds.set(r)
        self._update_step(r, RoundStep.NEW_ROUND)
        self.triggered_timeout_precommit = False
        if r != 0:
            self.proposal = None
            self.proposal_block = None
            self.proposal_block_id = None
        self.votes.set_round(r + 1)
        self.enter_propose(h, r)

    def enter_propose(self, h: int, r: int) -> None:
        if h != self.height or r < self.round or (
            r == self.round and self.step >= RoundStep.PROPOSE
        ):
            return
        self._update_step(r, RoundStep.PROPOSE)
        self.ticker.schedule(
            TimeoutInfo(self.timeouts.propose_timeout(r), h, r,
                        int(RoundStep.PROPOSE))
        )
        if self._proposal_complete():
            self.enter_prevote(h, r)
            return
        if self.privval is None:
            return
        proposer = self.validators.get_proposer()
        if proposer.address != self.privval.address():
            return
        # --- we are the proposer (defaultDecideProposal, state.go:1180) ---
        if self.valid_block is not None:
            block, bid = self.valid_block, self.valid_block_id
        else:
            last_commit = self._last_commit_for_proposal()
            spec = self._take_speculative(h, r, last_commit)
            if spec is not None:
                block, bid = spec.block, spec.block_id
            else:
                block = self.executor.create_proposal_block(
                    h, self.sm_state, last_commit, proposer.address,
                    self.tx_source(),
                    block_time=self._proposal_block_time(),
                )
                # encode exactly once: the memo feeds block_id_for's
                # part-set, the BlockBytesMessage broadcast below, and
                # _finalize_commit's size gauge
                block.__dict__["_enc_memo"] = block.encode()
                bid = block_id_for(block)
        if _txlife.enabled:
            _txlife.stage_block(self._lifecycle_pairs(block, bid), "reap",
                                height=h)
        proposal = Proposal(
            height=h, round=r, pol_round=self.valid_round, block_id=bid,
            timestamp=Timestamp.from_unix_ns(self.now_ns()),
        )
        self.privval.sign_proposal(self.chain_id, proposal)
        bb = BlockBytesMessage(
            h, r, block.__dict__.get("_enc_memo") or block.encode()
        )
        if not self._replay_mode:
            self.broadcast(ProposalMessage(proposal))
            self.broadcast(bb)
            if _txlife.enabled:
                _txlife.stage_block(self._lifecycle_pairs(block, bid),
                                    "gossip", height=h)
        self.send(ProposalMessage(proposal), "")
        self.send(bb, "")

    def _lifecycle_pairs(self, block, bid):
        """Sampled (index, key) pairs for a proposal block's txs —
        hashed ONCE per (height, block id) so the reap/gossip/quorum
        stamp sweeps don't re-hash the block per stage."""
        if block is None or bid is None:
            return ()
        tag = (self.height, bid.hash)
        cache = self._txlife_cache
        if cache is not None and cache[0] == tag:
            return cache[1]
        pairs = _txlife.sampled_keys(block.data.txs)
        self._txlife_cache = (tag, pairs)
        return pairs

    def _proposal_block_time(self) -> Timestamp:
        if self.height == self.sm_state.initial_height:
            return self.sm_state.last_block_time
        return Timestamp.from_unix_ns(self.now_ns())

    def _last_commit_for_proposal(self) -> Commit:
        if self.height == self.sm_state.initial_height:
            return Commit()
        assert self.last_commit is not None, "no last commit at height > initial"
        return self.last_commit.make_commit()

    # ------------------------------------------------------------------
    # speculative proposal assembly
    # ------------------------------------------------------------------
    def _maybe_speculate(self) -> None:
        """Kick off background proposal assembly for the height just
        entered, overlapping the reap + create_proposal_block + encode
        work with the NEW_HEIGHT commit gap (where the reference's
        tx-lifecycle observatory attributed 42.9% of e2e p50 as
        proposal_wait). Runs only when
        this node is the round-0 proposer; enter_propose consumes the
        result through _take_speculative, which re-checks everything the
        assembly depended on and discards on any mismatch — the cold
        path is always correct, speculation only ever saves time."""
        with self._spec_lock:
            if self._spec is not None:
                # previous height's block was never consumed (e.g. a
                # valid_block lock superseded it)
                self._spec = None
                consensus_metrics().speculation_total.inc(1.0, "discard")
        if (
            not self.speculative
            or self._replay_mode
            or self.privval is None
            or self.height == self.sm_state.initial_height
        ):
            return
        if self.validators.get_proposer().address != self.privval.address():
            return
        h = self.height
        state = self.sm_state
        last_commit = self._last_commit_for_proposal()
        mv = self.mempool_version()
        proposer_addr = self.privval.address()

        def work():
            t0 = time.perf_counter()
            try:
                # block_time is omitted on purpose: non-initial heights
                # derive the header time from median_time(last_commit),
                # which is frozen in the snapshot above — so the result
                # is bit-exact with the cold path
                block = self.executor.create_proposal_block(
                    h, state, last_commit, proposer_addr, self.tx_source()
                )
                enc = block.encode()
                block.__dict__["_enc_memo"] = enc
                bid = block_id_for(block)
            except Exception:  # noqa: BLE001 — speculation must never hurt
                return
            with self._spec_lock:
                if self._spec_thread is not t:
                    # superseded by a newer height's worker: drop
                    consensus_metrics().speculation_total.inc(
                        1.0, "discard")
                    return
                self._spec = _SpeculativeProposal(
                    height=h, state=state,
                    last_commit_hash=last_commit.hash(),
                    mempool_version=mv, block=block, block_id=bid,
                )
            if trace.enabled:
                trace.emit(
                    "consensus.propose_speculative", "span",
                    dur_ms=round((time.perf_counter() - t0) * 1e3, 3),
                    height=h, txs=len(block.data.txs), bytes=len(enc),
                )

        t = threading.Thread(target=work, daemon=True,
                             name=f"cs-spec-{self.name}")
        self._spec_thread = t
        t.start()

    def _take_speculative(self, h: int, r: int, last_commit: Commit):
        """The correctness seam: hand back the speculative block only if
        every input it was assembled from is still what enter_propose
        would use — otherwise discard. Joining an in-flight worker is
        never slower than redoing the same assembly on this thread."""
        t = self._spec_thread
        if t is None:
            return None
        t.join()
        self._spec_thread = None
        with self._spec_lock:
            spec, self._spec = self._spec, None
        if spec is None:
            consensus_metrics().speculation_total.inc(1.0, "discard")
            return None
        ok = (
            r == 0
            and spec.height == h
            and spec.state is self.sm_state
            and spec.mempool_version == self.mempool_version()
            and spec.last_commit_hash == last_commit.hash()
            and spec.block.header.evidence_hash == self._evidence_hash_now()
        )
        consensus_metrics().speculation_total.inc(
            1.0, "hit" if ok else "discard")
        return spec if ok else None

    def _evidence_hash_now(self) -> bytes:
        """Hash of the evidence create_proposal_block would include NOW
        (same pending_evidence budget it applies)."""
        pool = getattr(self.executor, "evidence_pool", None)
        if pool is None:
            return evidence_list_hash([])
        params = self.sm_state.consensus_params
        cap = min(params.evidence.max_bytes, params.block.max_bytes // 10)
        return evidence_list_hash(pool.pending_evidence(cap))

    def _proposal_complete(self) -> bool:
        return (
            self.proposal is not None
            and self.proposal_block is not None
            and self.proposal_block_id == self.proposal.block_id
        )

    def enter_prevote(self, h: int, r: int) -> None:
        if h != self.height or r < self.round or (
            r == self.round and self.step >= RoundStep.PREVOTE
        ):
            return
        self._update_step(r, RoundStep.PREVOTE)
        # defaultDoPrevote (state.go:1365)
        if self.locked_block is not None:
            self._sign_and_send_vote(SignedMsgType.PREVOTE, self.locked_block_id)
            return
        if self.proposal_block is None or not self._proposal_complete():
            self._sign_and_send_vote(SignedMsgType.PREVOTE, BlockID())
            return
        try:
            validate_block(
                self.sm_state, self.proposal_block,
                device=self.executor.device,
            )
            app_accepts = self.executor.process_proposal(self.proposal_block)
        except BlockValidationError:
            app_accepts = False
        self._sign_and_send_vote(
            SignedMsgType.PREVOTE,
            self.proposal_block_id if app_accepts else BlockID(),
        )

    def enter_prevote_wait(self, h: int, r: int) -> None:
        if h != self.height or r < self.round or (
            r == self.round and self.step >= RoundStep.PREVOTE_WAIT
        ):
            return
        self._update_step(r, RoundStep.PREVOTE_WAIT)
        self.ticker.schedule(
            TimeoutInfo(self.timeouts.prevote_timeout(r), h, r,
                        int(RoundStep.PREVOTE_WAIT))
        )

    def enter_precommit(self, h: int, r: int) -> None:
        if h != self.height or r < self.round or (
            r == self.round and self.step >= RoundStep.PRECOMMIT
        ):
            return
        self._update_step(r, RoundStep.PRECOMMIT)
        prevotes = self.votes.prevotes(r)
        maj, ok = prevotes.two_thirds_majority()
        if not ok:
            self._sign_and_send_vote(SignedMsgType.PRECOMMIT, BlockID())
            return
        if maj.is_zero():
            if self.locked_block is not None:
                self.locked_round = -1
                self.locked_block = None
                self.locked_block_id = None
            self._sign_and_send_vote(SignedMsgType.PRECOMMIT, BlockID())
            return
        if self.locked_block_id == maj:
            self.locked_round = r  # relock
            self._sign_and_send_vote(SignedMsgType.PRECOMMIT, maj)
            return
        if self.proposal_block_id == maj and self._proposal_complete():
            try:
                validate_block(
                    self.sm_state, self.proposal_block,
                    device=self.executor.device,
                )
            except BlockValidationError as e:
                raise RuntimeError(f"+2/3 prevoted an invalid block: {e}") from e
            self.locked_round = r
            self.locked_block = self.proposal_block
            self.locked_block_id = maj
            self._sign_and_send_vote(SignedMsgType.PRECOMMIT, maj)
            return
        # +2/3 for a block we don't have: precommit nil, mark valid
        self.valid_round = r
        self.valid_block = None
        self.valid_block_id = maj
        self._sign_and_send_vote(SignedMsgType.PRECOMMIT, BlockID())

    def enter_precommit_wait(self, h: int, r: int) -> None:
        # Reference enterPrecommitWait: does NOT change the step; a
        # triggered flag prevents each extra precommit from restarting the
        # timer (TriggeredTimeoutPrecommit, reference state.go:1614).
        if h != self.height or r != self.round or self.triggered_timeout_precommit:
            return
        self.triggered_timeout_precommit = True
        self.ticker.schedule(
            TimeoutInfo(self.timeouts.precommit_timeout(r), h, r,
                        int(RoundStep.PRECOMMIT_WAIT))
        )

    def enter_commit(self, h: int, r: int) -> None:
        if h != self.height or self.step == RoundStep.COMMIT:
            return
        self._update_step(self.round, RoundStep.COMMIT)
        self.commit_round = r
        maj, ok = self.votes.precommits(r).two_thirds_majority()
        assert ok and not maj.is_zero()
        if self.locked_block_id == maj:
            self.proposal_block = self.locked_block
            self.proposal_block_id = self.locked_block_id
        elif self.proposal_block_id != maj:
            # clear a mismatched proposal block so the committed one can
            # arrive via gossip (reference enterCommit sets ProposalBlock
            # to nil + fresh parts for the committed BlockID)
            self.proposal_block = None
            self.proposal_block_id = None
        if (_txlife.enabled and self.proposal_block is not None
                and self.proposal_block_id == maj):
            _txlife.stage_block(
                self._lifecycle_pairs(self.proposal_block, maj),
                "precommit_quorum", height=h, round=r)
        self._try_finalize_commit(h)

    def _try_finalize_commit(self, h: int) -> None:
        if self.commit_round < 0:
            return
        maj, ok = self.votes.precommits(self.commit_round).two_thirds_majority()
        if not ok or maj.is_zero():
            return
        if self.proposal_block_id != maj or self.proposal_block is None:
            return  # waiting for the block to arrive
        if _txlife.enabled:
            # block may have arrived after enter_commit (late gossip):
            # first-wins dedupes with the enter_commit stamp
            _txlife.stage_block(
                self._lifecycle_pairs(self.proposal_block, maj),
                "precommit_quorum", height=h, round=self.commit_round)
        self._finalize_commit(h, maj)

    def _finalize_commit(self, h: int, maj: BlockID) -> None:
        # reference finalizeCommit (state.go:1740)
        block = self.proposal_block
        precommits = self.votes.precommits(self.commit_round)
        seen_commit = precommits.make_commit()
        if self.block_store is not None:
            self.block_store.save_block(block, seen_commit)
            if self.extensions_enabled(h):
                self.block_store.save_extended_commit(
                    precommits.make_extended_commit()
                )
        self.wal.write_end_height(h)
        new_state = self.executor.apply_block(
            self.sm_state, maj, block,
        )
        self.decided[h] = maj
        self._log.info(
            "finalized block", height=h, round=self.commit_round,
            txs=len(block.data.txs), hash=block.hash().hex()[:16],
        )
        if trace.enabled:
            trace.emit(
                "consensus.finalize_commit", "event", height=h,
                round=self.commit_round, txs=len(block.data.txs),
            )
        m = consensus_metrics()
        m.height.set(h)
        m.validators.set(len(self.validators))
        m.num_txs.set(len(block.data.txs))
        m.total_txs.inc(len(block.data.txs))
        m.block_size_bytes.set(
            len(block.__dict__.get("_enc_memo") or block.encode())
        )
        m.missing_validators.set(
            sum(1 for cs in seen_commit.signatures if cs.is_absent())
        )
        now = _time.monotonic()
        if self._last_commit_mono is not None:
            m.block_interval_seconds.observe(now - self._last_commit_mono)
        self._last_commit_mono = now
        self._update_to_state(new_state, precommits)

    def _update_to_state(self, new_state, last_precommits: VoteSet) -> None:
        self.sm_state = new_state
        # close the COMMIT step BEFORE bumping the height: the span must
        # be stamped with the height that was committed, not the next
        # one (the flight recorder's per-height reconstruction keys
        # every step span on its height)
        self._update_step(0, RoundStep.NEW_HEIGHT)
        self.height = new_state.last_block_height + 1
        self.validators = new_state.validators.copy()
        self.round = 0
        self.proposal = None
        self.proposal_block = None
        self.proposal_block_id = None
        self.locked_round = -1
        self.locked_block = None
        self.locked_block_id = None
        self.valid_round = -1
        self.valid_block = None
        self.valid_block_id = None
        self.commit_round = -1
        self.last_commit = last_precommits
        self.triggered_timeout_precommit = False
        self.votes = HeightVoteSet(self.chain_id, self.height, self.validators)
        self.ticker.schedule(
            TimeoutInfo(self.timeouts.commit, self.height, 0,
                        int(RoundStep.NEW_HEIGHT))
        )
        self._maybe_speculate()

    # ==================================================================
    # voting
    # ==================================================================
    def _sign_and_send_vote(self, vtype: SignedMsgType, block_id: BlockID) -> None:
        if self.privval is None:
            return
        idx, val = self.validators.get_by_address(self.privval.address())
        if val is None:
            return
        bid = block_id or BlockID()
        ts = Timestamp.from_unix_ns(self.now_ns())
        vote = Vote(
            type=vtype,
            height=self.height,
            round=self.round,
            block_id=bid,
            timestamp=ts,
            validator_address=val.address,
            validator_index=idx,
        )
        extend = (
            vtype == SignedMsgType.PRECOMMIT
            and not vote.is_nil()
            and self.extensions_enabled(self.height)
        )
        if extend:
            # app-supplied extension rides the precommit
            # (reference state.go signVote -> ExtendVote)
            vote.extension = self.executor.app.consensus.extend_vote(
                self.height, self.round, vote.block_id.hash
            )
        self.privval.sign_vote(self.chain_id, vote, sign_extension=extend)
        if not self._replay_mode:
            self.broadcast(VoteMessage(vote))
            # byzantine injection seam (privval/byzantine.py): a
            # double-signing privval hands back a second, conflicting
            # signed vote for the same HRS. It goes to PEERS ONLY —
            # never into our own vote set — so the equivocation is
            # observable on the wire exactly like a remote adversary's.
            equivocate = getattr(self.privval, "equivocate", None)
            if equivocate is not None:
                shadow = equivocate(self.chain_id, vote)
                if shadow is not None:
                    self.broadcast(VoteMessage(shadow, direct=True))
        self.send(VoteMessage(vote), "")

    def _trace_conflicting_votes(self, e) -> None:
        """Surface an equivocation pair on the trace sink: p2p vote
        records carry no signatures, so this is the only place the
        watchtower can recover both SIGNED votes to build
        DuplicateVoteEvidence from."""
        if not trace.enabled:
            return
        try:
            a, b = e.vote_a, e.vote_b
            trace.emit(
                "consensus.conflicting_vote", "event",
                height=a.height, round=a.round, type=int(a.type),
                val=a.validator_address.hex(),
                vote_a=a.encode().hex(), vote_b=b.encode().hex(),
            )
        except Exception:  # noqa: BLE001 — tracing must not stall consensus
            pass

    # ==================================================================
    # WAL crash recovery
    # ==================================================================
    def catchup_replay(self) -> None:
        """Re-handle messages logged after the last #ENDHEIGHT
        (reference internal/consensus/replay.go:94)."""
        msgs = self.wal.search_for_end_height(self.height - 1)
        if msgs is None:
            if self.height - 1 > 0:
                return  # fresh WAL beyond genesis: nothing to replay
            msgs = []
        self._replay_mode = True
        try:
            for tm in msgs:
                m = tm.msg
                if isinstance(m, MsgInfo):
                    try:
                        self._handle_msg(m.msg, m.peer_id)
                    except Exception as e:
                        # tolerate stale/duplicate replay artifacts, not a
                        # device error
                        if is_device_error(e):
                            raise
                elif isinstance(m, TimeoutMessage):
                    try:
                        self._handle_timeout(
                            TimeoutInfo(0.0, m.height, m.round, m.step)
                        )
                    except Exception as e:
                        if is_device_error(e):
                            raise
        finally:
            self._replay_mode = False

    # ==================================================================
    # test helpers
    # ==================================================================
    def wait_for_height(self, h: int, timeout: float = 30.0) -> bool:
        deadline = time.monotonic() + timeout
        with self._step_cv:
            while self.height < h:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or self._stopped.is_set():
                    return self.height >= h
                self._step_cv.wait(remaining)
        return True


def ti_height(ti: TimeoutInfo) -> int:
    return ti.height


def _wal_payload(msg):
    if isinstance(msg, VoteMessage):
        return msg.vote
    if isinstance(msg, ProposalMessage):
        return msg.proposal
    return msg
