"""Commit verification — the consensus consumers of the batch verifier.

Twin of `cometbft_tpu/types/validation.py` for Ed25519 commits. Behavior
parity with reference types/validation.go:
- VerifyCommit (:26): checks EVERY non-absent signature (LastCommit reward
  accuracy), tallying only BlockIDFlag.COMMIT votes toward the +2/3 check.
- VerifyCommitLight (:61): verifies only COMMIT votes, succeeds on +2/3.
- VerifyCommitLightTrusting (:125): validator lookup by address against a
  *different* (trusted) set, threshold = trust_level fraction of its power.
- Batch path (:214): any commit with >= 2 signatures goes through the
  BatchVerifier; on batch failure the per-signature validity bitmap
  pinpoints the first bad signature.

The consumers take `device=` where the reference takes `backend=`:
"cuda" (the default) runs the batch on the card, "cpu" the kernels' plain
PyTorch versions. A "cuda" request on a host without a GPU raises; nothing
falls back to the CPU. Inside `crypto.sched.verify_context` the batch goes
through the shared scheduler instead.

Not ported: certificate-native commits (`CertCommit`, one BLS pairing)
and the partitions of other key types (secp256k1, sr25519, BLS). A key
the port cannot verify raises ErrUnsupportedKeyType naming its type; it
is not verified some other way.
"""

from __future__ import annotations

import time as _time

from ..crypto import ed25519 as _ed
from ..utils import trace as _trace
from ..utils.metrics import crypto_metrics
from .basic import BlockID
from .block import Commit
from .validator_set import ValidatorSet

BATCH_VERIFY_THRESHOLD = 2

_ED_TAG = _ed.KEY_TYPE


def _curve_of(tag: str) -> str:
    """Metric/span curve label from a key type tag:
    "tendermint/PubKeyEd25519" -> "ed25519"."""
    return tag.rsplit("PubKey", 1)[-1].lower() or tag


def _observe_partition(tag: str, path: str, n: int, dt: float) -> None:
    """Per-curve observability for one commit partition
    (crypto_verify_seconds{path=...,curve=...} and, when tracing is on,
    one `crypto.commit_partition` span)."""
    curve = _curve_of(tag)
    m = crypto_metrics()
    m.path_selected_total.inc(1.0, path, curve)
    m.verify_seconds.observe(dt, path, curve)
    if _trace.enabled:
        _trace.emit("crypto.commit_partition", "span",
                    dur_ms=round(dt * 1e3, 3), curve=curve, path=path,
                    n=n)


class CommitError(Exception):
    pass


class ErrInvalidCommitHeight(CommitError):
    pass


class ErrInvalidCommitSize(CommitError):
    pass


class ErrInvalidBlockID(CommitError):
    pass


class ErrInvalidSignature(CommitError):
    pass


class ErrNotEnoughVotingPower(CommitError):
    pass


class ErrUnsupportedKeyType(CommitError):
    """A signature under a key type the port has no verifier for."""


def _verify_items(items, device):
    """items: list of (pubkey, msg, sig, power_if_counted). Returns tally.

    Two or more items go to one Ed25519 batch verifier: submitted first
    (through the shared scheduler when a verify_context is active), its
    pending handle's summary prefetched, then resolved; the bitmap names
    the first invalid index. Fewer verify singly. Raises
    ErrInvalidSignature naming the first invalid index, and
    ErrUnsupportedKeyType for a key that is not Ed25519.
    """
    for i, (pub, _, _, _) in enumerate(items):
        if pub.type_tag() != _ED_TAG:
            raise ErrUnsupportedKeyType(
                f"no verifier for key type {pub.type_tag()} at index {i}")
    if len(items) >= BATCH_VERIFY_THRESHOLD:
        from ..crypto.batch import create_batch_verifier
        from ..crypto.sched import current_context

        t0 = _time.perf_counter()
        bv = create_batch_verifier(items[0][0], device=device)
        for pub, msg, sig, _ in items:
            bv.add(pub, msg, sig)
        sched_ctx = current_context()
        if sched_ctx is not None:
            # shared-scheduler seam (crypto/sched.py): the filled verifier
            # coalesces with other tenants' work into one mega-dispatch;
            # the handle's bitmap slice is bit-exact
            pending = sched_ctx.submit(bv)
        else:
            pending = bv.submit()
            pending.prefetch()
        ok, bits = pending.result()
        _observe_partition(_ED_TAG, "batch", len(items), _time.perf_counter() - t0)
        if not ok:
            if bits:
                # the bitmap pinpoints failures directly — no rescan
                for j, b in enumerate(bits):
                    if not b:
                        raise ErrInvalidSignature(f"invalid signature at index {j}")
            # batch could not localize: fall back to single verification
            # like the reference (:327). If every signature passes singly,
            # the commit is valid — accept.
            for j, (pub, msg, sig, _) in enumerate(items):
                if not pub.verify_signature(msg, sig):
                    raise ErrInvalidSignature(f"invalid signature at index {j}")
    else:
        for i, (pub, msg, sig, _) in enumerate(items):
            if not pub.verify_signature(msg, sig):
                raise ErrInvalidSignature(f"invalid signature at index {i}")
    return sum(p for _, _, _, p in items)


def _check_commit_basics(vals: ValidatorSet, commit: Commit, height: int, block_id: BlockID):
    if commit.height != height:
        raise ErrInvalidCommitHeight(f"expected height {height}, got {commit.height}")
    if commit.block_id != block_id:
        raise ErrInvalidBlockID("commit is for a different block")


def verify_commit(
    chain_id: str,
    vals: ValidatorSet,
    block_id: BlockID,
    height: int,
    commit: Commit,
    device="cuda",
) -> None:
    """Full verification: every non-absent signature checked
    (reference types/validation.go:21-53)."""
    device = _ed._resolve_device(device)
    _check_commit_basics(vals, commit, height, block_id)
    if len(vals) != commit.size():
        raise ErrInvalidCommitSize(
            f"validator set size {len(vals)} != commit size {commit.size()}"
        )
    items = []
    for idx, cs in enumerate(commit.signatures):
        if cs.is_absent():
            continue
        val = vals.get_by_index(idx)
        if val.address != cs.validator_address:
            raise ErrInvalidSignature(
                f"address mismatch at index {idx}"
            )
        counted = val.voting_power if cs.is_commit() else 0
        items.append((val.pub_key, commit.vote_sign_bytes(chain_id, idx), cs.signature, counted))
    tally_power = _verify_items(items, device)
    threshold = vals.total_voting_power() * 2 // 3
    if tally_power <= threshold:
        raise ErrNotEnoughVotingPower(
            f"tallied {tally_power} <= threshold {threshold}"
        )


def verify_commit_light(
    chain_id: str,
    vals: ValidatorSet,
    block_id: BlockID,
    height: int,
    commit: Commit,
    device="cuda",
    verify_all_signatures: bool = False,
) -> None:
    """Verify only COMMIT votes; succeed on +2/3
    (reference types/validation.go:61; AllSignatures variant :136)."""
    device = _ed._resolve_device(device)
    _check_commit_basics(vals, commit, height, block_id)
    if len(vals) != commit.size():
        raise ErrInvalidCommitSize(
            f"validator set size {len(vals)} != commit size {commit.size()}"
        )
    items = []
    threshold = vals.total_voting_power() * 2 // 3
    running = 0
    for idx, cs in enumerate(commit.signatures):
        if not cs.is_commit():
            continue
        val = vals.get_by_index(idx)
        if val.address != cs.validator_address:
            raise ErrInvalidSignature(f"address mismatch at index {idx}")
        items.append((val.pub_key, commit.vote_sign_bytes(chain_id, idx), cs.signature, val.voting_power))
        running += val.voting_power
        if not verify_all_signatures and running > threshold:
            break
    tally = _verify_items(items, device)
    if tally <= threshold:
        raise ErrNotEnoughVotingPower(f"tallied {tally} <= threshold {threshold}")


def verify_commit_light_trusting(
    chain_id: str,
    vals: ValidatorSet,
    commit: Commit,
    trust_level: tuple[int, int] = (1, 3),
    device="cuda",
    verify_all_signatures: bool = False,
) -> None:
    """Trusted-set verification by address with fractional threshold
    (reference types/validation.go:125; AllSignatures variant :124 in
    evidence verify). Skips validators unknown to the trusted set; guards
    against double-counting a validator appearing at two indices."""
    device = _ed._resolve_device(device)
    num, den = trust_level
    if den <= 0 or num < 0 or num > den:
        raise ValueError("invalid trust level")
    threshold = vals.total_voting_power() * num // den
    seen: set[bytes] = set()
    items = []
    running = 0
    for idx, cs in enumerate(commit.signatures):
        if not cs.is_commit():
            continue
        _, val = vals.get_by_address(cs.validator_address)
        if val is None or val.address in seen:
            continue
        seen.add(val.address)
        items.append((val.pub_key, commit.vote_sign_bytes(chain_id, idx), cs.signature, val.voting_power))
        running += val.voting_power
        if not verify_all_signatures and running > threshold:
            break
    tally = _verify_items(items, device)
    if tally <= threshold:
        raise ErrNotEnoughVotingPower(f"tallied {tally} <= threshold {threshold}")
