"""Pure light-client verification functions.

Behavior parity: reference light/verifier.go —
- VerifyAdjacent (:30): next-height header; untrusted validators must hash
  to the trusted header's next_validators_hash; +2/3 of them signed.
- VerifyNonAdjacent (:91): arbitrary forward height; the TRUSTED
  next-validator set must cover >= trust-level of the commit by address
  (VerifyCommitLightTrusting), and +2/3 of the untrusted set signed.
- Verify (:133): dispatch on height adjacency.
- Trusting-period / clock-drift checks (:169 checkTrustedHeaderAge,
  :186 validateHeader).

`verify_stream` packs EVERY commit signature of a header stream into one
device mega-batch instead of one batch call a header (the structural
per-header checks stay host-side).

Twin of `cometbft_tpu/light/verifier.py`: the functions take `device=`
("cuda" by default, "cpu" for the kernels' plain versions) where the
reference takes `backend=`. Certificate-native headers (CertCommit) are
not ported: the port's types decode no such commit.
"""

from __future__ import annotations

from ..crypto import ed25519
from ..types import Timestamp, ValidatorSet
from ..types.validation import (
    ErrInvalidSignature,
    ErrNotEnoughVotingPower,
    verify_commit_light,
    verify_commit_light_trusting,
)
from .types import LightBlock, SignedHeader

DEFAULT_TRUST_LEVEL = (1, 3)


class ErrHeaderExpired(Exception):
    pass


class ErrInvalidHeader(Exception):
    pass


class ErrNewValSetCantBeTrusted(Exception):
    """Trust-level check failed: bisection needed (reference
    ErrNewValSetCantBeTrusted)."""


def _check_trusted_age(trusted: SignedHeader, trusting_period_s: int,
                       now: Timestamp) -> None:
    expires = trusted.header.time.unix_ns() + trusting_period_s * 1_000_000_000
    if expires <= now.unix_ns():
        raise ErrHeaderExpired(
            f"trusted header from {trusted.header.time} expired at {expires}"
        )


def _validate_header(trusted: SignedHeader, untrusted: SignedHeader,
                     now: Timestamp, max_clock_drift_s: float) -> None:
    if untrusted.header.height <= trusted.header.height:
        raise ErrInvalidHeader(
            f"untrusted height {untrusted.header.height} <= trusted "
            f"{trusted.header.height}"
        )
    if not (trusted.header.time < untrusted.header.time):
        raise ErrInvalidHeader("untrusted header time not after trusted time")
    drift_ns = int(max_clock_drift_s * 1e9)
    if untrusted.header.time.unix_ns() >= now.unix_ns() + drift_ns:
        raise ErrInvalidHeader("untrusted header time too far in the future")


def verify_adjacent(
    chain_id: str,
    trusted: SignedHeader,
    untrusted: SignedHeader,
    untrusted_vals: ValidatorSet,
    trusting_period_s: int,
    now: Timestamp,
    max_clock_drift_s: float = 10.0,
    device="cuda",
) -> None:
    if untrusted.header.height != trusted.header.height + 1:
        raise ErrInvalidHeader("headers must be adjacent in height")
    _check_trusted_age(trusted, trusting_period_s, now)
    untrusted.basic_validate(chain_id)
    _validate_header(trusted, untrusted, now, max_clock_drift_s)
    if untrusted.header.validators_hash != trusted.header.next_validators_hash:
        raise ErrInvalidHeader(
            "untrusted validators_hash != trusted next_validators_hash"
        )
    verify_commit_light(
        chain_id, untrusted_vals, untrusted.commit.block_id,
        untrusted.header.height, untrusted.commit, device=device,
    )


def verify_non_adjacent(
    chain_id: str,
    trusted: SignedHeader,
    trusted_next_vals: ValidatorSet,
    untrusted: SignedHeader,
    untrusted_vals: ValidatorSet,
    trusting_period_s: int,
    now: Timestamp,
    trust_level: tuple[int, int] = DEFAULT_TRUST_LEVEL,
    max_clock_drift_s: float = 10.0,
    device="cuda",
) -> None:
    if untrusted.header.height == trusted.header.height + 1:
        raise ErrInvalidHeader("adjacent headers: use verify_adjacent")
    _check_trusted_age(trusted, trusting_period_s, now)
    untrusted.basic_validate(chain_id)
    _validate_header(trusted, untrusted, now, max_clock_drift_s)
    try:
        verify_commit_light_trusting(
            chain_id, trusted_next_vals, untrusted.commit,
            trust_level=trust_level, device=device,
        )
    except (ErrNotEnoughVotingPower,) as e:
        raise ErrNewValSetCantBeTrusted(str(e)) from e
    verify_commit_light(
        chain_id, untrusted_vals, untrusted.commit.block_id,
        untrusted.header.height, untrusted.commit, device=device,
    )


def verify(
    chain_id: str,
    trusted: SignedHeader,
    trusted_next_vals: ValidatorSet,
    untrusted: SignedHeader,
    untrusted_vals: ValidatorSet,
    trusting_period_s: int,
    now: Timestamp,
    trust_level: tuple[int, int] = DEFAULT_TRUST_LEVEL,
    max_clock_drift_s: float = 10.0,
    device="cuda",
) -> None:
    """Dispatch adjacent / non-adjacent (reference light/verifier.go:133)."""
    if untrusted.header.height == trusted.header.height + 1:
        verify_adjacent(
            chain_id, trusted, untrusted, untrusted_vals, trusting_period_s,
            now, max_clock_drift_s, device,
        )
    else:
        verify_non_adjacent(
            chain_id, trusted, trusted_next_vals, untrusted, untrusted_vals,
            trusting_period_s, now, trust_level, max_clock_drift_s, device,
        )


def verify_stream(
    chain_id: str,
    trusted: LightBlock,
    stream: list[LightBlock],
    trusting_period_s: int,
    now: Timestamp,
    max_clock_drift_s: float = 10.0,
    device="cuda",
) -> None:
    """Sequentially verify a contiguous header stream with ONE signature
    mega-batch across all headers.

    Equivalent checks to chaining verify_adjacent over the stream; raises
    on the first failure. Headers must be consecutive heights ascending
    from trusted.height+1.
    """
    _check_trusted_age(trusted.signed_header, trusting_period_s, now)
    bv = ed25519.Ed25519BatchVerifier(device=device)
    tallies: list[tuple[int, int, int]] = []  # (height, tally, threshold)
    prev = trusted
    for lb in stream:
        sh = lb.signed_header
        if sh.header.height != prev.height + 1:
            raise ErrInvalidHeader(
                f"stream not contiguous at height {sh.header.height}"
            )
        lb.basic_validate(chain_id)
        _validate_header(prev.signed_header, sh, now, max_clock_drift_s)
        if sh.header.validators_hash != prev.signed_header.header.next_validators_hash:
            raise ErrInvalidHeader(
                f"validators_hash mismatch at height {sh.header.height}"
            )
        vals = lb.validators
        if sh.commit.size() != len(vals):
            raise ErrInvalidHeader(f"commit size mismatch at {sh.header.height}")
        tally = 0
        for idx, cs in enumerate(sh.commit.signatures):
            if not cs.is_commit():
                continue
            val = vals.get_by_index(idx)
            if val is None or val.address != cs.validator_address:
                raise ErrInvalidSignature(
                    f"address mismatch at height {sh.header.height} idx {idx}"
                )
            if not bv.add(val.pub_key, sh.commit.vote_sign_bytes(chain_id, idx),
                          cs.signature):
                raise ErrInvalidSignature(
                    f"malformed signature at height {sh.header.height} idx {idx}"
                )
            tally += val.voting_power
        tallies.append(
            (sh.header.height, tally, vals.total_voting_power() * 2 // 3)
        )
        prev = lb
    ok, bits = bv.verify()
    if not ok:
        for i, good in enumerate(bits):
            if not good:
                raise ErrInvalidSignature(f"invalid signature in stream lane {i}")
    for height, tally, threshold in tallies:
        if tally <= threshold:
            raise ErrNotEnoughVotingPower(
                f"height {height}: tallied {tally} <= {threshold}"
            )
