"""BlockExecutor: validate -> FinalizeBlock -> update state -> commit.

Behavior parity with reference internal/state/execution.go:
- ApplyBlock (:211): validateBlock, ABCI FinalizeBlock (:219), validator
  update validation (:261), updateState (:586) rotating the three
  validator sets, app Commit (:379), prune + events.
- validateBlock (internal/state/validation.go:92) runs
  state.last_validators.VerifyCommit on every block — the full-signature
  hot path that rides the batch verifier.
- CreateProposalBlock (:109) assembles a block through PrepareProposal.

Twin of `cometbft_tpu/state/execution.py`: the functions and the executor
take `device=` ("cuda" by default, "cpu" for the kernels' plain versions)
where the reference takes `backend=`; a "cuda" request on a host without
a GPU raises. Differences, each a refusal and never another verdict:
a validator update whose key is secp256k1 raises `UnsupportedKeyType`
naming the type (the port verifies Ed25519 only), and there is no
certificate-commit branch (the port's types decode no CertCommit). The
mempool, evidence pool, event bus, pruner and DA encoder are optional
objects of later slices, None here as on the reference's replay path.
"""

from __future__ import annotations

from dataclasses import replace

from ..crypto import merkle
from ..crypto.ed25519 import Ed25519PubKey, _resolve_device
from ..types import (
    Block,
    BlockID,
    Commit,
    Data,
    Header,
    PartSetHeader,
    Timestamp,
    Validator,
    ValidatorSet,
    verify_commit,
)
from ..types.block import Consensus
from ..types.evidence import evidence_list_hash
from ..types.validation import CommitError
from ..types.validator_set import UnsupportedKeyType
from .types import State


class BlockValidationError(Exception):
    pass


def _pub_key_from_update(vu) -> Ed25519PubKey:
    """ABCI ValidatorUpdate pub_key_type dispatch (reference
    abci/types PubKeyType strings via crypto/encoding codec). A secp256k1
    key, which the reference builds, raises UnsupportedKeyType naming it:
    the port has no verifier for it."""
    t = vu.pub_key_type
    if t in ("ed25519", "tendermint/PubKeyEd25519"):
        return Ed25519PubKey(vu.pub_key_bytes)
    if t in ("secp256k1", "tendermint/PubKeySecp256k1"):
        raise UnsupportedKeyType(f"unsupported key type {t}: the port verifies ed25519 only")
    raise BlockValidationError(f"unsupported validator key type {t!r}")


def median_time(commit: Commit, vals: ValidatorSet) -> Timestamp:
    """Voting-power-weighted median of commit timestamps (reference
    internal/state/state.go:266 MedianTime + types/time/time.go:35
    WeightedMedian): every non-ABSENT signature's timestamp counts
    (including NIL votes), validators are looked up by address, and the
    pick is the first sorted timestamp whose cumulative weight reaches
    total/2 (ties take the earlier timestamp)."""
    fast = _median_time_columnar(commit, vals)
    if fast is not None:
        return fast
    pairs = []
    total = 0
    for cs in commit.signatures:
        if cs.is_absent():
            continue
        _, val = vals.get_by_address(cs.validator_address)
        if val is None:
            continue
        pairs.append((cs.timestamp.unix_ns(), val.voting_power))
        total += val.voting_power
    if not pairs:
        return Timestamp()
    pairs.sort()
    median = total // 2
    for ts, p in pairs:
        if median <= p:
            return Timestamp.from_unix_ns(ts)
        median -= p
    return Timestamp.from_unix_ns(pairs[-1][0])


def _median_time_columnar(commit: Commit, vals: ValidatorSet):
    """Vectorized weighted median over the decode columns — replay runs
    this once per block over 1000-signature commits. None (fall back to
    the per-slot walk) unless every live address matches the set
    positionally, which the batched verify has already required."""
    cols = commit.verify_columns()
    if cols is None:
        return None
    vcols = vals.ed25519_columns()
    if vcols is None:
        return None
    import numpy as np

    flags, addrs, addr_lens, _, _, ts_s, ts_n = cols
    addr_rows, _, powers = vcols
    if len(flags) != len(addr_rows):
        return None
    live = flags != 1
    if not (addrs[live] == addr_rows[live]).all():
        return None  # out-of-order/unknown addresses: slow path
    # int64 ns math wraps beyond +-292 years from epoch (e.g. the Go
    # zero time, seconds = -62135596800); the scalar walk uses exact
    # Python ints, so out-of-range timestamps take the slow path rather
    # than risk a divergent median
    if len(ts_s) and (np.abs(ts_s[live]) > 9_000_000_000).any():
        return None
    ts = ts_s[live] * 1_000_000_000 + ts_n[live]
    pw = powers[live]
    if not len(ts):
        return Timestamp()
    order = np.argsort(ts, kind="stable")
    ts, pw = ts[order], pw[order]
    median = int(pw.sum()) // 2
    cum = np.cumsum(pw)
    # the scalar walk returns the first i with median - cum[i-1] <=
    # pw[i], i.e. the first i with cum[i] >= median
    i = int(np.searchsorted(cum, median, side="left"))
    if i >= len(ts):
        i = len(ts) - 1
    return Timestamp.from_unix_ns(int(ts[i]))


def results_hash(tx_results) -> bytes:
    """last_results_hash input (reference types/results.go Hash)."""
    return merkle.hash_from_byte_slices([r.encode() for r in tx_results])


def validate_block(
    state: State,
    block: Block,
    device="cuda",
    last_commit_preverified: bool = False,
) -> None:
    """Full block validation against current state
    (reference internal/state/validation.go).

    last_commit_preverified elides only the signature re-verification of
    the LastCommit (structure, size, hashes, and median-time checks still
    run) — used by the batched replay path, which has already verified
    those exact signatures in a window mega-batch.
    """
    device = _resolve_device(device)
    h = block.header
    if h.chain_id != state.chain_id:
        raise BlockValidationError(f"wrong chain id {h.chain_id}")
    expected_height = (
        state.initial_height
        if state.last_block_height == 0
        else state.last_block_height + 1
    )
    if h.height != expected_height:
        raise BlockValidationError(
            f"wrong height {h.height}, expected {expected_height}"
        )
    if h.last_block_id != state.last_block_id:
        raise BlockValidationError("wrong last_block_id")
    if h.validators_hash != state.validators.hash():
        raise BlockValidationError("wrong validators_hash")
    if h.next_validators_hash != state.next_validators.hash():
        raise BlockValidationError("wrong next_validators_hash")
    if h.consensus_hash != state.consensus_params.hash():
        raise BlockValidationError("wrong consensus_hash")
    if h.app_hash != state.app_hash:
        raise BlockValidationError("wrong app_hash")
    if h.last_results_hash != state.last_results_hash:
        raise BlockValidationError("wrong last_results_hash")
    if h.data_hash != block.data.hash():
        raise BlockValidationError("wrong data_hash")
    if h.last_commit_hash != block.last_commit.hash():
        raise BlockValidationError("wrong last_commit_hash")
    if h.evidence_hash != evidence_list_hash(block.evidence):
        raise BlockValidationError("wrong evidence_hash")

    if h.height == state.initial_height:
        if block.last_commit.signatures:
            raise BlockValidationError("initial block must have empty last commit")
    else:
        if len(block.last_commit.signatures) != len(state.last_validators):
            raise BlockValidationError("wrong last commit size")
        if not last_commit_preverified:
            try:
                verify_commit(
                    state.chain_id,
                    state.last_validators,
                    state.last_block_id,
                    h.height - 1,
                    block.last_commit,
                    device=device,
                )
            except CommitError as e:
                raise BlockValidationError(f"invalid last commit: {e}") from e
        # block time must be the weighted median of the last commit
        expected_time = median_time(block.last_commit, state.last_validators)
        if h.time != expected_time:
            raise BlockValidationError("block time != median commit time")
    if not h.proposer_address or len(h.proposer_address) != 20:
        raise BlockValidationError("invalid proposer address")
    if h.da_root and len(h.da_root) != 32:
        raise BlockValidationError("invalid da_root length")


def build_last_commit_info(block: Block, last_vals: ValidatorSet | None):
    """CommitInfo for FinalizeBlock (reference internal/state/execution.go
    buildLastCommitInfo): who signed the last commit, for incentives."""
    from ..abci.types import CommitInfo

    if block.header.height == 1 or last_vals is None:
        return CommitInfo()
    commit = block.last_commit
    cols = commit.verify_columns()
    if cols is not None and len(cols[0]) == len(last_vals.validators):
        present = (cols[0] != 1).tolist()  # flags != ABSENT
        votes = [
            (val.address, val.voting_power, p)
            for val, p in zip(last_vals.validators, present)
        ]
        return CommitInfo(round=commit.round, votes=votes)
    votes = []
    for idx, cs in enumerate(commit.signatures):
        val = last_vals.get_by_index(idx)
        if val is None:
            continue
        votes.append((val.address, val.voting_power, not cs.is_absent()))
    return CommitInfo(round=commit.round, votes=votes)


class BlockExecutor:
    def __init__(self, app_conns, state_store=None, block_store=None,
                 device="cuda", mempool=None, evidence_pool=None,
                 event_bus=None):
        self.app = app_conns
        self.state_store = state_store
        self.block_store = block_store
        self.device = _resolve_device(device)
        self.mempool = mempool
        self.evidence_pool = evidence_pool
        self.event_bus = event_bus
        self.event_handlers: list = []
        self.pruner = None  # optional state.pruner.Pruner (not ported yet)
        # optional da.DAServe (not ported yet): when set, proposals carry a DA commitment
        # in the header and apply_block re-derives and enforces it
        self.da_encoder = None
        # optional crypto.sched.VerifyScheduler: when set, LastCommit
        # verification inside validate_block routes through the shared
        # scheduler at consensus priority under this tenant (chain_id)
        self.verify_sched = None
        self.sched_tenant = ""

    # --- proposal side ---
    def create_proposal_block(
        self,
        height: int,
        state: State,
        last_commit: Commit,
        proposer_address: bytes,
        txs: list[bytes],
        block_time: Timestamp | None = None,
    ) -> Block:
        max_bytes = state.consensus_params.block.max_bytes
        ev_cap = min(state.consensus_params.evidence.max_bytes, max_bytes // 10)
        evidence = (
            self.evidence_pool.pending_evidence(ev_cap)
            if self.evidence_pool is not None
            else []
        )
        ev_size = sum(len(ev.wrapped()) for ev in evidence)
        local_last_commit = None
        eh = state.consensus_params.abci.vote_extensions_enable_height
        if eh > 0 and height > eh and self.block_store is not None:
            # deliver height-1's vote extensions to the app
            # (reference PrepareProposalRequest.LocalLastCommit)
            local_last_commit = self.block_store.load_extended_commit(
                height - 1
            )
        # evidence spends block budget before txs (reference MaxDataBytes)
        txs = self.app.consensus.prepare_proposal(
            txs, max_bytes - ev_size, local_last_commit
        )
        if height == state.initial_height:
            time = block_time or state.last_block_time
        else:
            time = median_time(last_commit, state.last_validators)
        data = Data(txs)
        da_root = (
            self.da_encoder.da_root_for(data)
            if self.da_encoder is not None
            else b""
        )
        header = Header(
            version=Consensus(),
            chain_id=state.chain_id,
            height=height,
            time=time,
            last_block_id=state.last_block_id,
            last_commit_hash=last_commit.hash(),
            data_hash=data.hash(),
            validators_hash=state.validators.hash(),
            next_validators_hash=state.next_validators.hash(),
            consensus_hash=state.consensus_params.hash(),
            app_hash=state.app_hash,
            last_results_hash=state.last_results_hash,
            evidence_hash=evidence_list_hash(evidence),
            proposer_address=proposer_address,
            da_root=da_root,
        )
        return Block(
            header=header, data=data, evidence=evidence,
            last_commit=last_commit,
        )

    def check_da_commitment(self, block: Block) -> None:
        """With DA enabled, the header's da_root must equal the root
        re-derived from the block's own payload — a proposer cannot
        commit to chunks that don't encode the data (apply-side gate;
        no-op when the node runs without a DA encoder)."""
        if self.da_encoder is None:
            return
        expected = self.da_encoder.da_root_for(block.data)
        if block.header.da_root != expected:
            raise BlockValidationError(
                "wrong da_root" if block.header.da_root else "missing da_root"
            )

    def process_proposal(self, block: Block) -> bool:
        from ..abci.types import ProposalStatus

        return (
            self.app.consensus.process_proposal(block.data.txs)
            == ProposalStatus.ACCEPT
        )

    # --- commit side ---
    def apply_block(
        self,
        state: State,
        block_id: BlockID,
        block: Block,
        last_commit_preverified: bool = False,
    ) -> State:
        import time as _time

        from ..abci.types import FinalizeBlockRequest
        from ..utils import trace
        from ..utils import txlife as _txlife
        from ..utils.fail import fail_point
        from ..utils.metrics import state_metrics

        # sampled txs of this block, hashed once: the apply/commit/notify
        # lifecycle stamps all sweep the same pairs
        life = _txlife.sampled_keys(block.data.txs) if _txlife.enabled else ()
        h_ = block.header.height
        t0 = _time.perf_counter()
        from ..crypto.sched import verify_context

        with verify_context(self.verify_sched, self.sched_tenant,
                            "consensus"):
            validate_block(
                state,
                block,
                device=self.device,
                last_commit_preverified=last_commit_preverified,
            )
        state_metrics().block_verify_time.observe(_time.perf_counter() - t0)
        self.check_da_commitment(block)
        if self.evidence_pool is not None and block.evidence:
            # reject fabricated misbehavior before it reaches the app
            # (reference internal/state/validation.go evpool.CheckEvidence)
            self.evidence_pool.check_evidence(
                block.evidence, state.consensus_params.evidence.max_bytes
            )

        t_validate = _time.perf_counter()
        fail_point()  # reference execution.go:251 (pre-FinalizeBlock)
        resp = self.app.consensus.finalize_block(
            FinalizeBlockRequest(
                txs=block.data.txs,
                decided_last_commit=build_last_commit_info(
                    block, state.last_validators
                ),
                misbehavior=[m for ev in block.evidence
                             for m in ev.to_abci_list()],
                hash=block.hash() or b"",
                height=block.header.height,
                time=block.header.time,
                next_validators_hash=block.header.next_validators_hash,
                proposer_address=block.header.proposer_address,
            )
        )
        if len(resp.tx_results) != len(block.data.txs):
            raise BlockValidationError("app returned wrong number of tx results")

        t_finalize = _time.perf_counter()
        if life:
            _txlife.stage_block(life, "apply", height=h_)
        fail_point()  # reference execution.go:258 (post-FinalizeBlock, pre-save)
        new_state = self._update_state(state, block_id, block, resp)

        # Commit with the mempool locked, then update it against the new
        # state (reference execution.go:379 Commit).
        fail_point()  # reference execution.go:293 (pre-Commit)
        if self.mempool is not None:
            self.mempool.lock()
            try:
                retain_height = self.app.consensus.commit()
                self.mempool.update(
                    block.header.height, block.data.txs, resp.tx_results
                )
            finally:
                self.mempool.unlock()
        else:
            retain_height = self.app.consensus.commit()
        if self.pruner is not None and retain_height:
            # the app's retain height feeds the background pruner
            # (reference execution.go Commit -> pruneBlocks)
            self.pruner.set_app_retain_height(retain_height)
        if self.evidence_pool is not None:
            self.evidence_pool.update(new_state, block.evidence)

        t_commit = _time.perf_counter()
        if life:
            _txlife.stage_block(life, "commit", height=h_)
        fail_point()  # reference execution.go:301 (post-Commit, pre-save)
        if self.state_store is not None:
            self.state_store.save(new_state)
            self.state_store.save_finalize_response(
                block.header.height, results_hash(resp.tx_results)
            )
            from ..abci import wire as _W

            self.state_store.save_abci_responses(
                block.header.height, _W.enc_finalize_resp(resp)
            )
        if self.event_bus is not None:
            # fire events (reference execution.go:313 fireEvents)
            self.event_bus.publish_new_block(block, resp)
            for i, tx in enumerate(block.data.txs):
                self.event_bus.publish_tx(
                    block.header.height, i, tx, resp.tx_results[i]
                )
            if resp.validator_updates:
                self.event_bus.publish_validator_set_updates(
                    resp.validator_updates
                )
        if life:
            # notify closes the lifecycle whether or not an event bus is
            # wired (without one there is simply nothing to wait on)
            _txlife.stage_block(life, "notify", height=h_)
        for handler in self.event_handlers:
            handler(block, resp)
        t_end = _time.perf_counter()
        state_metrics().block_processing_time.observe(t_end - t0)
        if trace.enabled:
            # One span per ApplyBlock carrying the per-stage breakdown
            # (validate = commit-sig verification, i.e. the crypto path).
            trace.emit(
                "state.apply_block", "span",
                height=block.header.height, txs=len(block.data.txs),
                dur_ms=round((t_end - t0) * 1e3, 3),
                validate_ms=round((t_validate - t0) * 1e3, 3),
                finalize_ms=round((t_finalize - t_validate) * 1e3, 3),
                commit_ms=round((t_commit - t_finalize) * 1e3, 3),
                save_events_ms=round((t_end - t_commit) * 1e3, 3),
            )
        return new_state

    def apply_block_preverified(self, state: State, block_id: BlockID, block: Block) -> State:
        """apply_block with LastCommit signatures already verified by the
        replay window mega-batch (all structural checks still run)."""
        return self.apply_block(state, block_id, block, last_commit_preverified=True)

    def _update_state(self, state: State, block_id: BlockID, block: Block, resp) -> State:
        n_vals = state.next_validators.copy()
        changed = state.last_height_validators_changed
        if resp.validator_updates:
            changes = []
            for vu in resp.validator_updates:
                changes.append(
                    Validator.from_pub_key(
                        _pub_key_from_update(vu), vu.power
                    )
                )
            n_vals.update_with_change_set(changes)
            changed = block.header.height + 2
        n_vals.increment_proposer_priority(1)
        # no defensive copies for the rotated sets: every mutator in the
        # codebase (here and consensus enter_new_round) operates on a
        # private .copy() first, so ValidatorSet objects reachable from
        # a State are never mutated in place — sharing them across the
        # rotation is safe and saves 2 full-set copies per block
        # (State.__post_init__ freezes the sets so a violation of that
        # convention raises instead of corrupting historical sets)
        return replace(
            state,
            last_block_height=block.header.height,
            last_block_id=block_id,
            last_block_time=block.header.time,
            last_validators=state.validators,
            validators=state.next_validators,
            next_validators=n_vals,
            last_height_validators_changed=changed,
            last_results_hash=results_hash(resp.tx_results),
            app_hash=resp.app_hash,
        )


def make_genesis_state(
    chain_id: str,
    validators: ValidatorSet,
    app_hash: bytes = b"",
    initial_height: int = 1,
    genesis_time: Timestamp | None = None,
    consensus_params=None,
) -> State:
    """Genesis -> State (reference internal/state/state.go MakeGenesisState)."""
    from .types import ConsensusParams

    return State(
        chain_id=chain_id,
        initial_height=initial_height,
        last_block_height=0,
        last_block_time=genesis_time or Timestamp.from_unix_ns(1_700_000_000_000_000_000),
        validators=validators.copy(),
        last_validators=None,  # empty at genesis (reference MakeGenesisState)
        next_validators=validators.copy_increment_proposer_priority(1),
        last_height_validators_changed=initial_height,
        consensus_params=consensus_params or ConsensusParams(),
    )
