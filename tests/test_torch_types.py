"""The port's consensus types against the JAX package's, byte for byte.

Canonical sign bytes (the reference's golden vectors, and the commit's
cached splice), block, header, commit, data and validator-set hashes,
merkle roots (native and pure), and encode/decode round trips carried
across as bytes in both directions. The native `commit_parse` is held
against the Python walk, and against the reference's decode, on the
malformed-bytes cases of tests/test_commit_codec_diff.py.
"""

from __future__ import annotations

import random
from unittest import mock

import numpy as np
import pytest

pytest.importorskip("torch")

from cometbft_tpu.crypto import merkle as RM  # noqa: E402
from cometbft_tpu.encoding import proto as RPB  # noqa: E402
from cometbft_tpu.state import types as RST  # noqa: E402
from cometbft_tpu.types import basic as RB  # noqa: E402
from cometbft_tpu.types import block as RBL  # noqa: E402
from cometbft_tpu.types import vote as RV  # noqa: E402
from cometbft_tpu_torch.crypto import merkle as M  # noqa: E402
from cometbft_tpu_torch.crypto import native  # noqa: E402
from cometbft_tpu_torch.crypto.ed25519 import Ed25519PubKey  # noqa: E402
from cometbft_tpu_torch.encoding import proto as pb  # noqa: E402
from cometbft_tpu_torch.light import LightBlock, SignedHeader  # noqa: E402
from cometbft_tpu_torch.types import (  # noqa: E402
    Block,
    BlockID,
    BlockIDFlag,
    Commit,
    CommitSig,
    Data,
    Header,
    PartSetHeader,
    Timestamp,
    Validator,
    ValidatorSet,
    ZERO_TIME,
)
from cometbft_tpu_torch.types import block as BL  # noqa: E402
from cometbft_tpu_torch.types import validator_set as VS  # noqa: E402
from cometbft_tpu_torch.types.block import block_id_for  # noqa: E402
from cometbft_tpu_torch.types.vote import (  # noqa: E402
    SignedMsgType,
    Vote,
    canonical_proposal_bytes,
    canonical_vote_bytes,
    canonical_vote_extension_bytes,
)

ZERO_TS_FIELD = bytes([0x2A, 0xB, 0x8, 0x80, 0x92, 0xB8, 0xC3, 0x98, 0xFE, 0xFF, 0xFF, 0xFF, 0x1])
HEAD = [0x11, 1, 0, 0, 0, 0, 0, 0, 0, 0x19, 1, 0, 0, 0, 0, 0, 0, 0]


@pytest.mark.parametrize("msg_type, height, round_, chain_id, want", [
    # the reference's golden vectors (types/vote_test.go:63; tests/test_canonical.py:24-85)
    (SignedMsgType.UNKNOWN, 0, 0, "", bytes([0xD]) + ZERO_TS_FIELD),
    (SignedMsgType.PRECOMMIT, 1, 1, "", bytes([0x21, 0x8, 0x2] + HEAD) + ZERO_TS_FIELD),
    (SignedMsgType.PREVOTE, 1, 1, "", bytes([0x21, 0x8, 0x1] + HEAD) + ZERO_TS_FIELD),
    (SignedMsgType.UNKNOWN, 1, 1, "", bytes([0x1F] + HEAD) + ZERO_TS_FIELD),
    (SignedMsgType.UNKNOWN, 1, 1, "test_chain_id",
     bytes([0x2E] + HEAD) + ZERO_TS_FIELD + bytes([0x32, 0xD]) + b"test_chain_id"),
])
def test_canonical_vote_bytes_golden_vectors(msg_type, height, round_, chain_id, want):
    got = canonical_vote_bytes(msg_type, height, round_, BlockID(), ZERO_TIME, chain_id)
    assert got == want
    assert got == RV.canonical_vote_bytes(msg_type, height, round_, RB.BlockID(), RB.ZERO_TIME,
                                          chain_id)


def _ref_bid(bid: BlockID):
    return RB.BlockID.decode(bid.encode())


def test_canonical_bytes_match_reference_on_random_inputs():
    rng = random.Random(9)
    for _ in range(60):
        bid = rng.choice([BlockID(), BlockID(rng.randbytes(32), PartSetHeader(
            rng.randrange(5), rng.randbytes(32)))])
        ts = Timestamp(rng.choice([RB.GO_ZERO_SECONDS, 0, 1_700_000_000, -5]),
                       rng.choice([0, 1, 999_999_999]))
        h, r, cid = rng.randrange(-3, 2**40), rng.randrange(0, 2**20), rng.choice(["", "c", "x" * 200])
        args = (h, r, _ref_bid(bid), RB.Timestamp(ts.seconds, ts.nanos), cid)
        for t in SignedMsgType:
            assert canonical_vote_bytes(t, h, r, bid, ts, cid) == RV.canonical_vote_bytes(t, *args)
        pol = rng.randrange(-1, 5)
        assert canonical_proposal_bytes(h, r, pol, bid, ts, cid) == RV.canonical_proposal_bytes(
            h, r, pol, *args[2:])
        ext = rng.randbytes(rng.randrange(0, 40))
        assert canonical_vote_extension_bytes(ext, h, r, cid) == \
            RV.canonical_vote_extension_bytes(ext, h, r, cid)


def test_varints_and_vote_round_trip():
    assert pb.varint_i64(-1) == RPB.varint_i64(-1) == b"\xff" * 9 + b"\x01"
    v, _ = pb.read_uvarint(pb.varint_i64(-62135596800), 0)
    assert pb.to_i64(v) == -62135596800
    vote = Vote(type=SignedMsgType.PRECOMMIT, height=42, round=3,
                block_id=BlockID(b"\x01" * 32, PartSetHeader(2, b"\x02" * 32)),
                timestamp=Timestamp(1_700_000_000, 12345), validator_address=b"\x03" * 20,
                validator_index=7, signature=b"\x04" * 64)
    assert Vote.decode(vote.encode()) == vote
    assert RV.Vote.decode(vote.encode()).encode() == vote.encode()
    assert vote.sign_bytes("c") == RV.Vote.decode(vote.encode()).sign_bytes("c")


def _commit(rng: random.Random, n: int, flags=None) -> Commit:
    sigs = []
    for i in range(n):
        flag = flags[i] if flags else rng.choice([BlockIDFlag.COMMIT, BlockIDFlag.COMMIT,
                                                  BlockIDFlag.NIL, BlockIDFlag.ABSENT])
        if flag == BlockIDFlag.ABSENT:
            sigs.append(CommitSig.absent())
            continue
        sigs.append(CommitSig(flag, rng.randbytes(20),
                              Timestamp(1_700_000_000 + rng.randrange(10**6), rng.randrange(10**9)),
                              rng.randbytes(64)))
    bid = BlockID(rng.randbytes(32), PartSetHeader(rng.randrange(1, 4), rng.randbytes(32)))
    return Commit(height=rng.randrange(1, 2**40), round=rng.randrange(0, 9), block_id=bid,
                  signatures=sigs)


@pytest.mark.parametrize("chain_id", ["chain-a", "another-chain", ""])
def test_commit_sign_bytes_splice_blob_and_reference_agree(chain_id):
    """`vote_sign_bytes` (the cached splice) equals `canonical_vote_bytes`
    for COMMIT and NIL slots and the reference's bytes on every slot; the
    native blob of a decoded commit equals it on every index (absent
    slots have length 0), as does `vote_sign_bytes_all`."""
    c = _commit(random.Random(len(chain_id)), 40)
    ref = RBL.Commit.decode(c.encode())
    dec = Commit.decode(c.encode())
    blob, lens = dec.vote_sign_bytes_blob(chain_id)
    off = 0
    all_bytes = c.vote_sign_bytes_all(chain_id)
    for idx, cs in enumerate(c.signatures):
        ln = int(lens[idx])
        if cs.is_absent():
            assert ln == 0 and all_bytes[idx] is None
            continue
        want = canonical_vote_bytes(SignedMsgType.PRECOMMIT, c.height, c.round,
                                    cs.effective_block_id(c.block_id), cs.timestamp, chain_id)
        got = c.vote_sign_bytes(chain_id, idx)
        assert got == want == ref.vote_sign_bytes(chain_id, idx) == all_bytes[idx]
        assert blob[off:off + ln] == got
        assert dec.vote_sign_bytes(chain_id, idx) == got
        off += ln
    assert off == len(blob)


def _header(rng: random.Random, da: bool = False) -> Header:
    return Header(
        chain_id="chain-" + str(rng.randrange(100)), height=rng.randrange(1, 2**33),
        time=Timestamp(1_700_000_000 + rng.randrange(1000), rng.randrange(10**9)),
        last_block_id=BlockID(rng.randbytes(32), PartSetHeader(1, rng.randbytes(32))),
        last_commit_hash=rng.randbytes(32), data_hash=rng.randbytes(32),
        validators_hash=rng.randbytes(32), next_validators_hash=rng.randbytes(32),
        consensus_hash=rng.randbytes(32), app_hash=rng.randbytes(rng.choice([0, 8, 32])),
        last_results_hash=rng.randbytes(32), evidence_hash=b"",
        proposer_address=rng.randbytes(20), da_root=rng.randbytes(32) if da else b"")


def _valset(rng: random.Random, n: int) -> ValidatorSet:
    return ValidatorSet([Validator.from_pub_key(Ed25519PubKey(rng.randbytes(32)),
                                                rng.choice([1, 10, 10, 37]))
                         for _ in range(n)])


@pytest.mark.parametrize("seed", [0, 1])
def test_hashes_and_round_trips_match_reference(seed):
    """Header, commit, data, block and validator-set hashes equal the
    reference's on the same bytes; each type decodes the other package's
    encoding and encodes it back to the same bytes (Commit also through
    trusted bytes and the Python walk), and so do SignedHeader, LightBlock
    and BlockID."""
    rng = random.Random(seed)
    hdr, commit, vals = _header(rng, da=bool(seed)), _commit(rng, 13), _valset(rng, 9)
    ref_hdr = RBL.Header.decode(hdr.encode())
    assert ref_hdr.encode() == hdr.encode() and ref_hdr.hash() == hdr.hash()
    assert Header.decode(ref_hdr.encode()).encode() == hdr.encode()
    assert Header(chain_id="x").hash() is None and RBL.Header(chain_id="x").hash() is None

    ref_commit = RBL.Commit.decode(commit.encode())
    for dec in (Commit.decode(ref_commit.encode()),
                Commit.decode(ref_commit.encode(), trusted_bytes=True)):
        assert dec.encode() == commit.encode() and dec.hash() == ref_commit.hash() == commit.hash()
    with mock.patch.object(native, "available", return_value=False):
        walked = Commit.decode(ref_commit.encode())
    assert walked.encode() == commit.encode() and "_cols" not in walked.__dict__

    vbytes = VS.encode_validator_set(vals)
    ref_vals = RST.decode_validator_set(vbytes)
    assert ref_vals.hash() == vals.hash()
    assert RST.encode_validator_set(ref_vals) == vbytes
    back = VS.decode_validator_set(RST.encode_validator_set(ref_vals))
    assert VS.encode_validator_set(back) == vbytes and back.hash() == vals.hash()
    assert [v.proposer_priority for v in back.validators] == \
        [v.proposer_priority for v in ref_vals.validators]
    cols = back.ed25519_columns()
    assert cols[0].shape == (9, 20) and cols[1].tobytes() == b"".join(
        v.pub_key.bytes() for v in ref_vals.validators)

    data = Data([rng.randbytes(rng.randrange(0, 50)) for _ in range(11)])
    ref_data = RBL.Data.decode(data.encode())
    assert ref_data.hash() == data.hash() and Data.decode(ref_data.encode()) == data
    blk = Block(header=hdr, data=data, last_commit=commit)
    ref_blk = RBL.Block.decode(blk.encode())
    assert ref_blk.encode() == blk.encode() and ref_blk.hash() == blk.hash()
    assert Block.decode(ref_blk.encode()).encode() == blk.encode()
    assert block_id_for(Block.decode(blk.encode())).encode() == \
        RBL.block_id_for(RBL.Block.decode(blk.encode())).encode()

    sh = SignedHeader(hdr, commit)
    from cometbft_tpu.light import types as RLT

    ref_sh = RLT.SignedHeader.decode(sh.encode())
    assert SignedHeader.decode(ref_sh.encode()).encode() == sh.encode()
    lb = LightBlock(sh, vals)
    lb_bytes = RPB.f_embedded(1, ref_sh.encode()) + RPB.f_embedded(
        2, RST.encode_validator_set(ref_vals))
    assert lb.encode() == lb_bytes and LightBlock.decode(lb_bytes).encode() == lb_bytes
    bid = commit.block_id
    assert BlockID.decode(_ref_bid(bid).encode()) == bid and bid.key() == _ref_bid(bid).key()


@pytest.mark.parametrize("n", [0, 1, 2, 3, 7, 8, 9, 33, 100])
def test_merkle_root_native_pure_and_reference_agree(n):
    rng = random.Random(n)
    items = [rng.randbytes(rng.randrange(0, 70)) for _ in range(n)]
    want = RM._hash_pure(items)
    assert M._hash_pure(items) == want
    assert M.hash_from_byte_slices(items) == want
    if n:
        assert native.merkle_root(items) == want
    root, proofs = M.proofs_from_byte_slices(items)
    ref_root, ref_proofs = RM.proofs_from_byte_slices(items)
    assert root == ref_root == want
    assert [(p.total, p.index, p.leaf_hash, p.aunts) for p in proofs] == \
        [(p.total, p.index, p.leaf_hash, p.aunts) for p in ref_proofs]
    assert all(p.verify(root, it) for p, it in zip(proofs, items))


def test_native_sha256_matches_hashlib():
    import hashlib

    for ln in (0, 1, 55, 56, 64, 1000):
        data = bytes(range(256)) * 4
        assert native.sha256(data[:ln]) == hashlib.sha256(data[:ln]).digest()
    assert native.sha256_engine() in ("sha-ni", "portable")


# ---- Commit.decode on malformed bytes: native parse, Python walk and the reference


def _outcome(decode, buf):
    try:
        c = decode(buf)
    except Exception as e:  # noqa: BLE001 — any decode error counts
        return type(e).__name__
    return (c.height, c.round, c.block_id.encode(), [cs.encode() for cs in c.signatures],
            c.hash())


def _python_walk(buf):
    with mock.patch.object(native, "available", return_value=False):
        return Commit.decode(buf)


def _rand_codec_commit(rng: random.Random) -> bytes:
    """tests/test_commit_codec_diff.py::_rand_commit, encoded."""
    sigs = []
    for _ in range(rng.randrange(0, 8)):
        flag = rng.choice(list(BlockIDFlag))
        if flag == BlockIDFlag.ABSENT and rng.random() < 0.7:
            sigs.append(CommitSig.absent())
            continue
        sigs.append(CommitSig(flag, rng.randbytes(rng.choice([0, 20, 20, 20, 5])),
                              Timestamp(rng.choice([0, -1, 1_700_000_000, 2**40]),
                                        rng.choice([0, 1, 999_999_999])),
                              rng.randbytes(rng.choice([0, 64, 64, 64, 32]))))
    bid = rng.choice([BlockID(), BlockID(rng.randbytes(32), PartSetHeader(rng.randrange(4),
                                                                          rng.randbytes(32)))])
    return Commit(rng.choice([0, 1, rng.randrange(1, 2**62)]), rng.choice([0, rng.randrange(100)]),
                  bid, sigs).encode()


def _malformed(kind: str, rng: random.Random) -> list[bytes]:
    bufs = []
    if kind == "valid":
        bufs = [_rand_codec_commit(rng) for _ in range(60)]
    elif kind == "mutated":
        for _ in range(80):
            buf = bytearray(_rand_codec_commit(rng))
            for _ in range(rng.randrange(1, 4)):
                if buf:
                    buf[rng.randrange(len(buf))] = rng.randrange(256)
            bufs.append(bytes(buf))
    elif kind == "truncated":
        for _ in range(40):
            buf = _rand_codec_commit(rng)
            cut = rng.randrange(len(buf)) if buf else 0
            bufs += [buf[:cut], buf[cut:]]
    elif kind == "garbage":
        bufs = [rng.randbytes(rng.randrange(0, 96)) for _ in range(60)]
    elif kind == "spliced":
        base = [_rand_codec_commit(rng) for _ in range(20)]
        for _ in range(60):
            a, b = rng.choice(base), rng.choice(base)
            bufs.append(a[:rng.randrange(len(a) + 1)] + b[rng.randrange(len(b) + 1):])
    return bufs


@pytest.mark.parametrize("kind", ["valid", "mutated", "truncated", "garbage", "spliced"])
def test_commit_decode_native_walk_and_reference_agree(kind):
    """Both of the port's decoders and the reference's give the same
    commit, or all raise the same exception class."""
    assert native.available(), native.build_log
    for buf in _malformed(kind, random.Random(kind)):
        want = _outcome(RBL.Commit.decode, buf)
        assert _outcome(Commit.decode, buf) == want, buf.hex()
        assert _outcome(_python_walk, buf) == want, buf.hex()
        if kind == "valid":
            assert not isinstance(want, str)


def test_columns_of_a_native_decode():
    c = _commit(random.Random(5), 9, [BlockIDFlag.COMMIT] * 4 + [BlockIDFlag.ABSENT]
                + [BlockIDFlag.NIL] * 4)
    flags, addrs, addr_lens, sig_lens, sigs, ts_s, ts_n = Commit.decode(c.encode()).verify_columns()
    assert flags.tolist() == [int(cs.block_id_flag) for cs in c.signatures]
    assert sig_lens.tolist() == [len(cs.signature) for cs in c.signatures]
    assert ts_s.tolist() == [cs.timestamp.seconds for cs in c.signatures]
    assert ts_n.tolist() == [cs.timestamp.nanos for cs in c.signatures]
    assert bytes(sigs[0]) == c.signatures[0].signature and bytes(addrs[8]) == \
        c.signatures[8].validator_address
    assert c.verify_columns() is None and c.vote_sign_bytes_blob("x") is None


# ---- what the port does not decode


def test_other_key_types_are_refused_by_name():
    from cometbft_tpu.crypto.secp256k1 import Secp256k1PrivKey
    from cometbft_tpu.types import Validator as RVal
    from cometbft_tpu.types import ValidatorSet as RVS

    secp = Secp256k1PrivKey(b"\x07" * 32).pub_key()
    ref_vals = RVS([RVal.from_pub_key(secp, 10)])
    with pytest.raises(VS.UnsupportedKeyType, match="secp256k1"):
        VS.decode_validator_set(RST.encode_validator_set(ref_vals))
    with pytest.raises(VS.UnsupportedKeyType, match="bls12_381"):
        VS.decode_pub_key({3: b"\x01" * 48})
    with pytest.raises(ValueError, match="unknown public key oneof"):
        VS.decode_pub_key({})
    # a key sent as a varint: the reference reads bytes(32), the zero key
    from cometbft_tpu.types import validator_set as RVSM

    assert RVSM.decode_pub_key({1: 32}).bytes() == bytes(32)
    with pytest.raises(ValueError, match="expected length-delimited field"):
        VS.decode_pub_key({1: 32})


def test_certificate_commits_and_evidence_are_refused_by_name():
    plain = _commit(random.Random(2), 3).encode()
    assert BL.decode_commit_any(plain).encode() == plain
    assert BL.decode_commit_any(b"").encode() == Commit().encode()
    cert = pb.f_varint(1, 5) + pb.f_embedded(5, b"\x01")
    with pytest.raises(BL.UnsupportedCommitFormat, match="field 5"):
        BL.decode_commit_any(cert)
    blk = Block(header=Header(chain_id="c"))
    with_cert = blk.encode() + pb.f_embedded(4, cert)
    with pytest.raises(BL.UnsupportedCommitFormat):
        Block.decode(with_cert)
    # a block carrying evidence decodes since the evidence slice: the
    # reference's bytes and hashes, and it round-trips
    from cometbft_tpu_torch.types.evidence import DuplicateVoteEvidence, evidence_list_hash

    with_evidence = pb.f_embedded(1, blk.header.encode()) + pb.f_embedded(
        3, pb.f_embedded(1, b"\x0a\x00"))
    got, want = Block.decode(with_evidence), RBL.Block.decode(with_evidence)
    assert [e.hash() for e in got.evidence] == [e.hash() for e in want.evidence]
    assert got.encode() == want.encode()
    votes = [Vote(type=SignedMsgType.PRECOMMIT, height=4, round=0,
                  block_id=BlockID(bytes([i]) * 32, PartSetHeader(1, bytes([i + 1]) * 32)),
                  timestamp=Timestamp(9, 0), validator_address=b"\x05" * 20,
                  signature=bytes([i]) * 64) for i in (7, 3)]
    ev = DuplicateVoteEvidence.from_votes(*votes, 10, 40, Timestamp(10, 0))
    eblk = Block(header=Header(chain_id="c", height=5, evidence_hash=evidence_list_hash([ev])),
                 evidence=[ev])
    back = Block.decode(eblk.encode())
    assert back.encode() == eblk.encode() == RBL.Block.decode(eblk.encode()).encode()
    assert back.hash() == eblk.hash() and evidence_list_hash(back.evidence) == \
        back.header.evidence_hash
    assert np.array_equal(np.frombuffer(Block.decode(blk.encode()).encode(), np.uint8),
                          np.frombuffer(blk.encode(), np.uint8))


def test_host_codec_and_merkle_sources_are_the_references():
    """`merkle_native.inc` and `commit_codec.inc` are the reference's,
    unchanged, and the port's engine includes them after the reference's
    first 1,336 lines, as the reference does."""
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    ref_dir, port_dir = root / "cometbft_tpu" / "csrc", root / "cometbft_tpu_torch" / "csrc" / "host"
    for name in ("merkle_native.inc", "commit_codec.inc"):
        assert (port_dir / name).read_bytes() == (ref_dir / name).read_bytes()
    ref_lines = (ref_dir / "ed25519_native.cpp").read_text().splitlines()
    port = (port_dir / "ed25519_native.cpp").read_text()
    body = port[port.index("\n\n") + 2:].splitlines()
    assert body[:1336] == ref_lines[:1336]
    includes = [ln for ln in body[1336:] if ln.startswith("#include")]
    assert includes == ['#include "merkle_native.inc"', '#include "commit_codec.inc"']
