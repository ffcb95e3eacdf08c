"""Light client: trusted store + primary/witness providers + bisection
(twin of `cometbft_tpu/light/client.py`; the client takes `device=`,
"cuda" by default and "cpu" for the kernels' plain versions, where the
reference takes `backend=`, and a "cuda" client on a host without a GPU
raises when it is made).

Behavior parity: reference light/client.go —
- TrustOptions anchor (:210 initialize from a trusted height+hash),
- sequential verification (:613 verifySequential),
- skipping/bisection verification (:706 verifySkipping: try non-adjacent
  from the latest trusted; on ErrNewValSetCantBeTrusted bisect midpoint),
- witness cross-checking (detector.go compareFirstHeaderWithWitnesses):
  after verification the new header is compared against every witness;
  a mismatch raises ErrConflictingHeaders (attack evidence handling is
  the evidence pool's job),
- pruning (:76 PruningSize).
"""

from __future__ import annotations

from abc import ABC, abstractmethod

from ..crypto.ed25519 import _resolve_device
from ..types import Timestamp
from .store import LightStore
from .types import LightBlock
from .verifier import (
    DEFAULT_TRUST_LEVEL,
    ErrInvalidHeader,
    ErrNewValSetCantBeTrusted,
    verify_adjacent,
    verify_non_adjacent,
)


def verify_ancestry(root: bytes, size: int, base_height: int, height: int,
                    header_hash: bytes, proof) -> bool:
    """Check a light-serve MMR ancestry proof: the header at `height`
    is leaf (height - base_height) of the accumulator snapshot with the
    given root and leaf count. `proof` may be an MMRProof or its
    encoded bytes (as served in /light_stream payloads)."""
    from .mmr import MMRProof

    if isinstance(proof, (bytes, bytearray)):
        try:
            proof = MMRProof.decode(bytes(proof))
        except Exception:  # noqa: BLE001 — malformed wire form
            return False
    if proof.size != size or proof.leaf_index != height - base_height:
        return False
    return proof.verify(root, header_hash)


class Provider(ABC):
    """Source of light blocks (reference light/provider/provider.go)."""

    @abstractmethod
    def light_block(self, height: int) -> LightBlock | None: ...

    @abstractmethod
    def chain_id(self) -> str: ...


class StoreProvider(Provider):
    """Provider over a local block/state store pair (tests, inspect mode)."""

    def __init__(self, chain_id: str, block_store, state_store):
        self._chain_id = chain_id
        self._blocks = block_store
        self._states = state_store

    def chain_id(self) -> str:
        return self._chain_id

    def light_block(self, height: int) -> LightBlock | None:
        from .types import SignedHeader

        block = self._blocks.load_block(height)
        commit = self._blocks.load_block_commit(height)
        if commit is None:
            commit = self._blocks.load_seen_commit(height)
        vals = self._states.load_validators(height)
        if block is None or commit is None or vals is None:
            return None
        return LightBlock(SignedHeader(block.header, commit), vals)


class ErrConflictingHeaders(Exception):
    """A witness backed a verifying alternative header: a real fork
    (reference light/errors.go ErrLightClientAttack). Carries the
    generated attack evidence."""

    def __init__(self, witness_idx: int, height: int, evidence=None):
        super().__init__(
            f"witness {witness_idx} disagrees at height {height} — "
            "light-client attack"
        )
        self.witness_idx = witness_idx
        self.height = height
        self.evidence = evidence


class ErrNoWitnesses(Exception):
    pass


class ProviderError(Exception):
    """Base for provider fetch failures; provider_http raises its own
    subclassable variant — anything non-verification is treated as a
    provider fault and demotes the provider."""


class LightClient:
    def __init__(
        self,
        chain_id: str,
        primary: Provider,
        witnesses: list[Provider] | None = None,
        store: LightStore | None = None,
        trusting_period_s: int = 14 * 24 * 3600,
        trust_level: tuple[int, int] = DEFAULT_TRUST_LEVEL,
        max_clock_drift_s: float = 10.0,
        pruning_size: int = 1000,
        device="cuda",
        skipping: bool = True,
    ):
        self.chain_id = chain_id
        self.primary = primary
        self.witnesses = witnesses or []
        self.store = store or LightStore()
        self.trusting_period_s = trusting_period_s
        self.trust_level = trust_level
        self.max_clock_drift_s = max_clock_drift_s
        self.pruning_size = pruning_size
        self.device = _resolve_device(device)
        self.skipping = skipping

    # ------------------------------------------------------------------
    def initialize(self, height: int, header_hash: bytes) -> LightBlock:
        """Trust anchor: fetch height from primary, check the hash matches
        (reference light/client.go initializeWithTrustOptions)."""
        lb = self.primary.light_block(height)
        if lb is None:
            raise ErrInvalidHeader(f"primary has no light block at {height}")
        lb.basic_validate(self.chain_id)
        if lb.signed_header.header.hash() != header_hash:
            raise ErrInvalidHeader("trusted hash mismatch at anchor height")
        self.store.save(lb)
        return lb

    # ------------------------------------------------------------------
    def verify_to_height(self, height: int, now: Timestamp) -> LightBlock:
        latest = self.store.latest()
        if latest is None:
            raise ErrInvalidHeader("client not initialized (no trusted block)")
        root = latest
        if height <= latest.height:
            got = self.store.load(height)
            if got is not None:
                return got
            below = [h for h in self.store.heights() if h < height]
            if not below:
                # target is below every trusted block: verify backwards
                # by hash links (reference light/client.go:933
                # backwards — signatures cannot be checked against a
                # future set, but each header pins its parent's hash)
                return self._verify_backwards(height, now)
            # target sits between stored trusted blocks: re-root forward
            # verification at the highest stored block below it (any
            # trusted block is a valid verification root; reference
            # light/client.go VerifyLightBlockAtHeight for h < latest
            # walks from a lower trusted header)
            root = self.store.load(max(below))
        target = self._fetch_primary(height)
        if self.skipping:
            out = self._verify_skipping(root, target, now)
        else:
            out = self._verify_sequential(root, target, now)
        self._cross_check(out, now)
        self.store.prune(self.pruning_size)
        return out

    # ------------------------------------------------------------------
    def _fetch_primary(self, height: int) -> LightBlock:
        """Fetch from the primary, replacing it with a responsive witness
        when it faults (reference light/client.go:1046 findNewPrimary)."""
        for _ in range(1 + len(self.witnesses)):
            try:
                lb = self.primary.light_block(height)
            except Exception as e:  # noqa: BLE001 — provider fault
                self._replace_primary(str(e))
                continue
            if lb is None:
                raise ErrInvalidHeader(
                    f"primary has no light block at {height}"
                )
            return lb
        raise ErrNoWitnesses("no responsive primary or witnesses left")

    def _replace_primary(self, reason: str) -> None:
        if not self.witnesses:
            raise ErrNoWitnesses(
                f"primary faulted ({reason}) and no witnesses remain"
            )
        old = self.primary
        self.primary = self.witnesses.pop(0)
        # the faulted primary is NOT enlisted as a witness: a provider
        # that lied or timed out must not keep a vote in cross-checks
        del old

    def _verify_backwards(self, height: int, now: Timestamp) -> LightBlock:
        earliest_h = min(self.store.heights())
        cur = self.store.load(earliest_h)
        for h in range(earliest_h - 1, height - 1, -1):
            nxt = self._fetch_primary(h)
            nxt.basic_validate(self.chain_id)
            if (
                nxt.signed_header.header.hash()
                != cur.signed_header.header.last_block_id.hash
            ):
                raise ErrInvalidHeader(
                    f"header {h} does not hash-link into trusted header "
                    f"{cur.height}"
                )
            self.store.save(nxt)
            cur = nxt
        return cur

    # ------------------------------------------------------------------
    def _verify_one(self, trusted: LightBlock, new: LightBlock, now: Timestamp
                    ) -> None:
        from ..utils.metrics import light_metrics

        light_metrics().headers_verified_total.inc()
        if new.height == trusted.height + 1:
            verify_adjacent(
                self.chain_id, trusted.signed_header, new.signed_header,
                new.validators, self.trusting_period_s, now,
                self.max_clock_drift_s, self.device,
            )
        else:
            # trusted NEXT validators: adjacent header's set is hashed in
            # the trusted header; for trusting verification the reference
            # uses the trusted block's NextValidators — our LightBlock
            # carries the current set, so fetch next via the primary's
            # height+1... the trusted header's next_validators_hash pins it.
            verify_non_adjacent(
                self.chain_id, trusted.signed_header,
                self._next_validators(trusted), new.signed_header,
                new.validators, self.trusting_period_s, now,
                self.trust_level, self.max_clock_drift_s, self.device,
            )

    def _next_validators(self, lb: LightBlock):
        nxt = self.primary.light_block(lb.height + 1)
        if nxt is not None and (
            nxt.validators.hash() == lb.signed_header.header.next_validators_hash
        ):
            return nxt.validators
        # fall back to the current set (valid when the set is unchanged)
        if lb.validators.hash() == lb.signed_header.header.next_validators_hash:
            return lb.validators
        raise ErrInvalidHeader(
            f"cannot obtain next validator set for height {lb.height}"
        )

    def _verify_sequential(self, trusted: LightBlock, target: LightBlock,
                           now: Timestamp) -> LightBlock:
        cur = trusted
        for h in range(trusted.height + 1, target.height):
            nxt = self.primary.light_block(h)
            if nxt is None:
                raise ErrInvalidHeader(f"primary missing height {h}")
            self._verify_one(cur, nxt, now)
            self.store.save(nxt)
            cur = nxt
        self._verify_one(cur, target, now)
        self.store.save(target)
        return target

    def _verify_skipping(self, trusted: LightBlock, target: LightBlock,
                         now: Timestamp) -> LightBlock:
        """Bisection (reference light/client.go:706 verifySkipping)."""
        cur = trusted
        pivots = [target]
        while pivots:
            pivot = pivots[-1]
            try:
                self._verify_one(cur, pivot, now)
            except ErrNewValSetCantBeTrusted:
                mid = (cur.height + pivot.height) // 2
                if mid in (cur.height, pivot.height):
                    raise
                mid_lb = self.primary.light_block(mid)
                if mid_lb is None:
                    raise ErrInvalidHeader(f"primary missing pivot height {mid}")
                from ..utils.metrics import light_metrics

                light_metrics().bisections_total.inc()
                pivots.append(mid_lb)
                continue
            self.store.save(pivot)
            cur = pivot
            pivots.pop()
        return cur

    # ------------------------------------------------------------------
    def _cross_check(self, lb: LightBlock, now: Timestamp) -> None:
        """Compare the fresh header against every witness (reference
        light/detector.go detectDivergence).

        - witness faults (network, lying validator-set hash) demote the
          witness on the spot;
        - a witness that merely disagrees but cannot back its header
          with a verifying chain from our trusted root is dropped;
        - a witness whose alternative chain VERIFIES is proof of a
          light-client attack: evidence is built and reported to the
          primary and all witnesses, and ErrConflictingHeaders raised."""
        want = lb.signed_header.header.hash()
        dead = []
        for i, w in enumerate(self.witnesses):
            try:
                other = w.light_block(lb.height)
            except Exception:  # noqa: BLE001 — provider fault
                dead.append(i)
                continue
            if other is None:
                continue  # witness lagging: harmless, retried next time
            if other.signed_header.header.hash() == want:
                continue
            ev = self._examine_conflict(w, other, now)
            if ev is None:
                dead.append(i)  # witness could not back its header
                continue
            self._report_evidence(ev)
            # Both directions matter (reference light/detector.go
            # examines the primary's trace against the witness too):
            # when the PRIMARY is the attacker, the witness's chain is
            # canonical and full nodes on it would reject `ev` as
            # non-conflicting — so also build evidence carrying the
            # primary's forged block and hand it to the witness, whose
            # chain can prosecute it.
            ev_primary = self._evidence_for_block(lb, ev.common_height)
            if ev_primary is not None:
                self._report_evidence_to(w, ev_primary)
            raise ErrConflictingHeaders(i, lb.height, ev)
        for i in reversed(dead):
            self.witnesses.pop(i)

    def _examine_conflict(self, witness, other: LightBlock, now: Timestamp):
        """Try to verify the witness's divergent header from our own
        trusted store THROUGH THE WITNESS (reference
        light/detector.go examineConflictingHeaderAgainstTrace). Success
        means over 1/3 of some trusted validator set signed two chains;
        returns LightClientAttackEvidence, or None when the witness
        cannot substantiate its header."""
        from ..types.evidence import LightClientAttackEvidence

        below = [h for h in self.store.heights() if h < other.height]
        if not below:
            return None
        common = self.store.load(max(below))
        shadow = LightClient(
            self.chain_id,
            primary=witness,
            witnesses=[],
            trusting_period_s=self.trusting_period_s,
            trust_level=self.trust_level,
            max_clock_drift_s=self.max_clock_drift_s,
            device=self.device,
            skipping=self.skipping,
        )
        shadow.store.save(common)
        try:
            verified = shadow.verify_to_height(other.height, now)
        except Exception:  # noqa: BLE001 — any failure: unsubstantiated
            return None
        if verified.signed_header.header.hash() != other.signed_header.header.hash():
            return None
        # byzantine overlap: signers of the conflicting commit that sit
        # in the trusted common validator set (reference
        # types/evidence.go GetByzantineValidators)
        byz = []
        commit = other.signed_header.commit
        for idx, cs in enumerate(commit.signatures):
            if cs.is_absent() or idx >= len(other.validators.validators):
                continue
            addr = cs.validator_address
            i2, v = common.validators.get_by_address(addr)
            if v is not None:
                byz.append(addr)
        return LightClientAttackEvidence(
            conflicting_block=other,
            common_height=common.height,
            byzantine_validators=byz,
            total_voting_power=common.validators.total_voting_power(),
            timestamp=common.signed_header.header.time,
        )

    def _evidence_for_block(self, blk: LightBlock, common_height: int):
        """LightClientAttackEvidence naming `blk` as the conflicting
        block, rooted at the given trusted common height."""
        from ..types.evidence import LightClientAttackEvidence

        common = self.store.load(common_height)
        if common is None:
            return None
        byz = []
        for cs in blk.signed_header.commit.signatures:
            if cs.is_absent():
                continue
            _, v = common.validators.get_by_address(cs.validator_address)
            if v is not None:
                byz.append(cs.validator_address)
        return LightClientAttackEvidence(
            conflicting_block=blk,
            common_height=common.height,
            byzantine_validators=byz,
            total_voting_power=common.validators.total_voting_power(),
            timestamp=common.signed_header.header.time,
        )

    def _report_evidence_to(self, provider, ev) -> None:
        report = getattr(provider, "report_evidence", None)
        if report is None:
            return
        try:
            report(ev)
        except Exception:  # noqa: BLE001 — best-effort
            pass

    def _report_evidence(self, ev) -> None:
        """Hand the attack evidence to every provider that can accept it
        (reference light/detector.go sendEvidence)."""
        for p in [self.primary, *self.witnesses]:
            self._report_evidence_to(p, ev)
