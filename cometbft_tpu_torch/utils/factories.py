"""Deterministic fixtures: signers, validator sets, commits.

Twin of `cometbft_tpu/utils/factories.py` (without `make_chain`, which
needs ABCI and state execution, and `RPool`). For large validator sets
the Ed25519 keys are *scalar signers* — the secret is a raw scalar a with
pubkey [a]B computed by the device fixed-base ladder in one batch
(`_fixed_base_batch`: `ops/curve.py::fixed_base` at the verifier's
buckets, through the `fe_mul` / `fe_sq` kernels on a GPU), and signatures
finished host-side as S = r + k*a (mod L). These are standard verifiable
Ed25519 signatures; only derivation-from-seed is skipped, which verifiers
never see. For the same seed the signers, validator sets and commits are
byte-identical to the reference's: both draw the same numbers from
`numpy.random.default_rng(seed)` in the same order.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np
import torch

from ..crypto import ed25519_ref as ref
from ..crypto.ed25519 import Ed25519PubKey
from ..types import (
    BlockID,
    Commit,
    CommitSig,
    PartSetHeader,
    Timestamp,
    Validator,
    ValidatorSet,
)
from ..types.block import BlockIDFlag


@dataclass
class ScalarSigner:
    scalar: int
    pub_bytes: bytes

    def pub_key(self) -> Ed25519PubKey:
        return Ed25519PubKey(self.pub_bytes)

    def address(self) -> bytes:
        return self.pub_key().address()


def _fixed_base_batch(scalars: list[int], device="cuda") -> np.ndarray:
    """[s]B for a batch of scalars via the device ladder -> (N, 32) encodings
    (twin of the reference's `_fixed_base_fn` / `_fixed_base_batch`).

    Padded to the verifier's buckets, as the reference pads to its
    compiled shapes."""
    from ..crypto.ed25519 import _bucket
    from ..ops import curve as C

    n = len(scalars)
    b = _bucket(max(n, 1))
    padded = scalars + [1] * (b - n)
    digs = torch.from_numpy(C.scalar_digits(padded)).to(device)
    return C.compress(C.fixed_base(digs)).cpu().numpy()[:n]


def make_signers(n: int, seed: int = 0, device="cuda") -> list[ScalarSigner]:
    rng = np.random.default_rng(seed)
    scalars = [int.from_bytes(rng.bytes(32), "little") % ref.L or 1 for _ in range(n)]
    pubs = _fixed_base_batch(scalars, device)
    return [ScalarSigner(s, pubs[i].tobytes()) for i, s in enumerate(scalars)]


def batch_sign(signers: list[ScalarSigner], msgs: list[bytes], seed: int = 1,
               device="cuda") -> list[bytes]:
    """One signature per (signer, msg) pair, R points computed on `device`."""
    rng = np.random.default_rng(seed)
    rs = [int.from_bytes(rng.bytes(32), "little") % ref.L or 1 for _ in signers]
    r_encs = _fixed_base_batch(rs, device)
    sigs = []
    for signer, msg, r, r_enc in zip(signers, msgs, rs, r_encs):
        r_b = r_enc.tobytes()
        k = int.from_bytes(
            hashlib.sha512(r_b + signer.pub_bytes + msg).digest(), "little"
        ) % ref.L
        s = (r + k * signer.scalar) % ref.L
        sigs.append(r_b + s.to_bytes(32, "little"))
    return sigs


def sign_with_scalar(signer: ScalarSigner, msg: bytes) -> bytes:
    """One host-side signature (deterministic nonce); for single-vote paths
    (consensus state machine, privval) where device batching has nothing to
    amortize. Standard verifiable Ed25519 output."""
    r = (
        int.from_bytes(
            hashlib.sha512(b"nonce" + signer.pub_bytes + msg).digest(), "little"
        )
        % ref.L
        or 1
    )
    r_enc = ref._encode_point(*ref._ext_to_affine(ref._ext_scalar_mul(r, ref.B_POINT)))
    k = (
        int.from_bytes(
            hashlib.sha512(r_enc + signer.pub_bytes + msg).digest(), "little"
        )
        % ref.L
    )
    s = (r + k * signer.scalar) % ref.L
    return r_enc + s.to_bytes(32, "little")


def sign_vote(signer: ScalarSigner, vote, chain_id: str) -> None:
    vote.signature = sign_with_scalar(signer, vote.sign_bytes(chain_id))


def make_validator_set(
    signers: list[ScalarSigner], powers: list[int] | None = None
) -> ValidatorSet:
    powers = powers or [10] * len(signers)
    return ValidatorSet(
        [Validator.from_pub_key(s.pub_key(), p) for s, p in zip(signers, powers)]
    )


def make_block_id(tag: bytes = b"block") -> BlockID:
    h = hashlib.sha256(tag).digest()
    return BlockID(h, PartSetHeader(1, hashlib.sha256(tag + b"parts").digest()))


def make_commit(
    chain_id: str,
    height: int,
    round_: int,
    block_id: BlockID,
    vals: ValidatorSet,
    signers_by_addr: dict[bytes, ScalarSigner],
    time_ns: int = 1_700_000_000_000_000_000,
    absent: set[int] | None = None,
    nil: set[int] | None = None,
    sign_seed: int | None = None,
    device="cuda",
) -> Commit:
    """A commit signed by every validator (minus `absent` indices; `nil`
    indices sign a NIL precommit), ordered to match the validator set."""
    absent = absent or set()
    nil = nil or set()
    commit = Commit(height=height, round=round_, block_id=block_id, signatures=[])
    sig_slots = []
    signers, msgs = [], []
    for idx, val in enumerate(vals.validators):
        if idx in absent:
            commit.signatures.append(CommitSig.absent())
            sig_slots.append(None)
            continue
        ts = Timestamp.from_unix_ns(time_ns + idx)
        cs = CommitSig(
            block_id_flag=BlockIDFlag.NIL if idx in nil else BlockIDFlag.COMMIT,
            validator_address=val.address,
            timestamp=ts,
            signature=b"",
        )
        commit.signatures.append(cs)
        sig_slots.append(idx)
        signers.append(signers_by_addr[val.address])
        msgs.append(None)  # filled after sign bytes known
    # sign bytes depend on the commit structure built above
    j = 0
    for idx in range(len(vals.validators)):
        if sig_slots[idx] is None:
            continue
        msgs[j] = commit.vote_sign_bytes(chain_id, idx)
        j += 1
    sigs = batch_sign(
        signers, msgs, seed=(sign_seed if sign_seed is not None else height),
        device=device,
    )
    j = 0
    for idx in range(len(vals.validators)):
        if sig_slots[idx] is None:
            continue
        commit.signatures[idx].signature = sigs[j]
        j += 1
    return commit
