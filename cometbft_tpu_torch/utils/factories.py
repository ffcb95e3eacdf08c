"""Deterministic fixtures: signers, validator sets, commits, chains.

Twin of `cometbft_tpu/utils/factories.py`. For large validator sets
the Ed25519 keys are *scalar signers* — the secret is a raw scalar a with
pubkey [a]B computed by the device fixed-base ladder in one batch
(`_fixed_base_batch`: `ops/curve.py::fixed_base` at the verifier's
buckets, through the `fe_mul` / `fe_sq` kernels on a GPU), and signatures
finished host-side as S = r + k*a (mod L). These are standard verifiable
Ed25519 signatures; only derivation-from-seed is skipped, which verifiers
never see. For the same seed the signers, validator sets and commits are
byte-identical to the reference's: both draw the same numbers from
`numpy.random.default_rng(seed)` in the same order; `make_chain` runs
the port's executor and ABCI app, so its store's KV items and its final
state are the reference's bytes too.
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
from ..types.block import BlockIDFlag, block_id_for  # noqa: F401 (re-exported)


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


class RPool:
    """Pre-batched R nonce points for chunked chain generation.

    batch_sign's per-call _fixed_base_batch pays one device launch
    sequence and round trip; the pool computes R encodings for
    `blocks_per_fill` commits in ONE `_fixed_base_batch` on `device` and
    hands them out per block (the last block's first, as the
    reference's list pop does)."""

    def __init__(self, n_signers: int, blocks_per_fill: int = 32,
                 seed: int = 1, device="cuda"):
        self.n = n_signers
        self.per_fill = blocks_per_fill
        self.seed = seed
        self.device = device
        self._buf: list[tuple[list[int], np.ndarray]] = []

    def next(self) -> tuple[list[int], np.ndarray]:
        if not self._buf:
            rng = np.random.default_rng(self.seed)
            self.seed += 1
            total = self.n * self.per_fill
            rs = [
                int.from_bytes(rng.bytes(32), "little") % ref.L or 1
                for _ in range(total)
            ]
            encs = _fixed_base_batch(rs, self.device)
            for i in range(self.per_fill):
                lo = i * self.n
                self._buf.append((rs[lo:lo + self.n], encs[lo:lo + self.n]))
        return self._buf.pop()


def batch_sign(signers: list[ScalarSigner], msgs: list[bytes], seed: int = 1,
               device="cuda",
               nonces: tuple[list[int], np.ndarray] | None = None) -> list[bytes]:
    """One signature per (signer, msg) pair, R points computed on `device`
    (or taken from a pre-batched RPool draw via `nonces`)."""
    if nonces is not None:
        rs, r_encs = nonces
        rs, r_encs = rs[:len(signers)], r_encs[:len(signers)]
    else:
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


def signed_txs(signers: list[ScalarSigner], payloads: list[bytes], seed: int = 1,
               device="cuda") -> list[bytes]:
    """STX envelopes (`mempool.wrap_signed_tx`'s bytes) of payloads[i]
    signed by signers[i], the R points of all of them in one `batch_sign`
    on `device`: senders' signed load for the admission path."""
    from ..mempool.admission import SIGN_CONTEXT, STX_MAGIC

    sigs = batch_sign(signers, [SIGN_CONTEXT + p for p in payloads], seed=seed, device=device)
    return [STX_MAGIC + s.pub_bytes + sig + p for s, sig, p in zip(signers, sigs, payloads)]


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


def make_chain(
    n_blocks: int,
    n_validators: int = 4,
    chain_id: str = "replay-chain",
    txs_per_block: int = 2,
    app=None,
    seed: int = 0,
    device="cuda",
    nil_votes: dict[int, set[int]] | None = None,
    corrupt_sig: tuple[int, int] | None = None,
    r_pool: "RPool | None" = None,
):
    """Generate a fully-valid signed chain by actually running the executor.

    Returns (block_store, final_state, genesis_state, signers). Every block
    is built with create_proposal_block, committed by all validators
    (device-batched signing), and applied through ABCI — so replaying the
    store reproduces byte-identical state.

    nil_votes maps height -> validator indices casting NIL precommits in
    that height's commit. corrupt_sig=(height, idx) flips a byte of that
    commit signature after signing (the corrupted commit still propagates
    into the next block's embedded LastCommit, so verification during
    generation is elided for such chains — they exist to test that replay
    REJECTS them).

    r_pool amortizes the device nonce-point launches over many blocks.
    """
    from ..abci.client import AppConns
    from ..abci.kvstore import KVStoreApp
    from ..state.execution import BlockExecutor, make_genesis_state
    from ..crypto.ed25519 import _resolve_device
    from ..storage import BlockStore, MemKV

    device = _resolve_device(device)
    signers = make_signers(n_validators, seed=seed, device=device)
    vals = make_validator_set(signers)
    by_addr = {s.address(): s for s in signers}
    app = app or KVStoreApp()
    store = BlockStore(MemKV())
    executor = BlockExecutor(AppConns(app), device=device)
    genesis = make_genesis_state(chain_id, vals)
    state = genesis.copy()

    last_commit = Commit()
    for h in range(1, n_blocks + 1):
        txs = [b"k%d-%d=v%d" % (h, i, i) for i in range(txs_per_block)]
        proposer = state.validators.get_proposer()
        block = executor.create_proposal_block(
            h, state, last_commit, proposer.address, txs,
            block_time=state.last_block_time,
        )
        bid = block_id_for(block)
        vals_h = state.validators  # the set that signs height h's commit
        state = executor.apply_block(
            state, bid, block,
            last_commit_preverified=corrupt_sig is not None,
        )
        commit = make_commit(
            chain_id, h, 0, bid, vals_h, by_addr,
            time_ns=state.last_block_time.unix_ns() + 1_000_000_000,
            nil=(nil_votes or {}).get(h),
            device=device,
            r_pool=r_pool,
        )
        if corrupt_sig is not None and corrupt_sig[0] == h:
            cs = commit.signatures[corrupt_sig[1]]
            sig = bytearray(cs.signature)
            sig[0] ^= 0xFF
            cs.signature = bytes(sig)
            commit.invalidate_memos()
        store.save_block(block, commit)
        last_commit = commit
    return store, state, genesis, signers


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
    r_pool: "RPool | None" = None,
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
        nonces=r_pool.next() if r_pool is not None else None,
    )
    j = 0
    for idx in range(len(vals.validators)):
        if sig_slots[idx] is None:
            continue
        commit.signatures[idx].signature = sigs[j]
        j += 1
    return commit
