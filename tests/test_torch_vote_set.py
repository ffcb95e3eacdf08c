"""The port's VoteSet and BitArray against the reference's
(`tests/test_vote_set.py`, modeled on reference types/vote_set_test.go).

Each test runs through both packages on the same seed-made Ed25519 keys
(`Ed25519PrivKey` of numpy-drawn seeds); the commit a vote set makes is
byte-identical between them.
"""

import importlib
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch")

CHAIN = "test-chain"
N = 4
PACKAGES = {"port": "cometbft_tpu_torch", "reference": "cometbft_tpu"}
# the keyword that picks the verifier's device or backend in each package
VERIFY_KW = {"port": {"device": "cpu"}, "reference": {"backend": "cpu"}}


def modules(side: str):
    root = PACKAGES[side]
    names = {"ed": "crypto.ed25519", "keys": "crypto.keys", "basic": "types.basic",
             "block": "types.block", "valset": "types.validator_set", "vote": "types.vote",
             "vote_set": "types.vote_set", "bits": "utils.bits", "validation": "types.validation"}
    return SimpleNamespace(**{k: importlib.import_module(f"{root}.{v}") for k, v in names.items()})


def make_net(side: str):
    m = modules(side)
    seeds = np.random.default_rng(11).integers(0, 256, (N, 32), dtype=np.uint8)
    privs = [m.ed.Ed25519PrivKey(bytes(s)) for s in seeds]
    vals = m.valset.ValidatorSet(
        [m.valset.Validator.from_pub_key(p.pub_key(), 10) for p in privs], increment_first=False)
    by_addr = {p.pub_key().address(): p for p in privs}
    return SimpleNamespace(m=m, side=side, vals=vals,
                           privs=[by_addr[v.address] for v in vals.validators])


@pytest.fixture(scope="module", params=list(PACKAGES))
def net(request):
    return make_net(request.param)


def bid(net, tag: bytes):
    m = net.m
    return m.basic.BlockID(m.keys.tmhash(tag), m.basic.PartSetHeader(1, m.keys.tmhash(b"ps" + tag)))


def mkvote(net, idx, block_id, vtype=None, height=1, round_=0):
    m = net.m
    v = m.vote.Vote(
        type=m.vote.SignedMsgType.PRECOMMIT if vtype is None else vtype,
        height=height, round=round_, block_id=block_id,
        timestamp=m.basic.Timestamp(100 + idx, 0),
        validator_address=net.vals.validators[idx].address, validator_index=idx)
    v.signature = net.privs[idx].sign(v.sign_bytes(CHAIN))
    return v


def vote_set(net, height=1, round_=0):
    m = net.m
    return m.vote_set.VoteSet(CHAIN, height, round_, m.vote.SignedMsgType.PRECOMMIT, net.vals)


@pytest.mark.parametrize("side", list(PACKAGES))
def test_bit_array_basics(side):
    BitArray = modules(side).bits.BitArray
    ba = BitArray(10)
    assert ba.is_empty() and not ba.is_full()
    assert ba.set(3) and ba.set(9)
    assert not ba.set(10)
    assert ba.get(3) and not ba.get(4)
    assert ba.num_true() == 2 and ba.true_indices() == [3, 9]
    other = BitArray(12)
    other.set(3)
    other.set(11)
    assert ba.and_(other).true_indices() == [3]
    assert ba.or_(other).true_indices() == [3, 9, 11]
    assert ba.sub(other).true_indices() == [9]
    i, ok = ba.pick_random()
    assert ok and i in (3, 9)
    rt = BitArray.from_bytes(10, ba.to_bytes())
    assert rt == ba
    assert ba.to_bytes() == modules("reference").bits.BitArray(10, 1 << 3 | 1 << 9).to_bytes()
    assert repr(ba) == "BA{10:___x_____x}"


def test_add_vote_and_maj23(net):
    vs = vote_set(net)
    b = bid(net, b"blk")
    assert not vs.has_two_thirds_any()
    assert vs.add_vote(mkvote(net, 0, b))
    assert vs.add_vote(mkvote(net, 1, b))
    assert not vs.has_two_thirds_majority()
    # duplicate returns False without error
    assert not vs.add_vote(mkvote(net, 1, b))
    assert vs.add_vote(mkvote(net, 2, b))
    assert vs.has_two_thirds_majority()
    maj, ok = vs.two_thirds_majority()
    assert ok and maj == b
    assert vs.bit_array().true_indices() == [0, 1, 2]


def test_nil_votes_count_toward_any_not_block(net):
    vs = vote_set(net)
    nil = net.m.basic.BlockID()
    for i in range(3):
        assert vs.add_vote(mkvote(net, i, nil))
    assert vs.has_two_thirds_any()
    maj, ok = vs.two_thirds_majority()
    assert ok and maj is not None and maj.is_zero()  # 2/3 for nil IS a majority


def test_wrong_step_and_address(net):
    E = net.m.vote_set
    vs = vote_set(net)
    with pytest.raises(E.ErrVoteUnexpectedStep):
        vs.add_vote(mkvote(net, 0, bid(net, b"x"), vtype=net.m.vote.SignedMsgType.PREVOTE))
    v = mkvote(net, 0, bid(net, b"x"))
    v.validator_index = 1  # address of 0, slot of 1
    with pytest.raises(E.ErrVoteInvalidValidatorAddress):
        vs.add_vote(v)


def test_bad_signature(net):
    vs = vote_set(net)
    v = mkvote(net, 0, bid(net, b"x"))
    v.signature = bytes(64)
    with pytest.raises(net.m.vote_set.ErrVoteInvalidSignature):
        vs.add_vote(v)


def test_conflicting_votes_and_peer_maj23(net):
    E = net.m.vote_set
    vs = vote_set(net)
    a, b = bid(net, b"a"), bid(net, b"b")
    assert vs.add_vote(mkvote(net, 0, a))
    with pytest.raises(E.ErrVoteConflictingVotes) as ei:
        vs.add_vote(mkvote(net, 0, b))
    assert ei.value.vote_a.block_id == a and ei.value.vote_b.block_id == b
    # after a peer claims maj23 for b, the conflicting vote is tracked AND
    # the equivocation still surfaces (reference: added=true with error)
    vs.set_peer_maj23("peer1", b)
    with pytest.raises(E.ErrVoteConflictingVotes) as ei:
        vs.add_vote(mkvote(net, 0, b))
    assert ei.value.added
    # canonical vote for validator 0 is still for a
    assert vs.get_by_index(0).block_id == a
    assert vs.bit_array_by_block_id(b).true_indices() == [0]
    # b reaches 2/3 via validators 1,2 -> promoted to canonical
    vs.add_vote(mkvote(net, 1, b))
    vs.add_vote(mkvote(net, 2, b))
    maj, ok = vs.two_thirds_majority()
    assert ok and maj == b
    assert vs.get_by_index(0).block_id == b
    # a post-maj23 conflicting vote FOR the maj23 block replaces the slot
    vs2 = vote_set(net)
    vs2.set_peer_maj23("p", b)
    vs2.add_vote(mkvote(net, 3, a))
    for i in range(3):
        vs2.add_vote(mkvote(net, i, b))
    with pytest.raises(E.ErrVoteConflictingVotes) as ei:
        vs2.add_vote(mkvote(net, 3, b))
    assert ei.value.added
    assert vs2.get_by_index(3).block_id == b
    commit = vs2.make_commit()
    assert all(cs.is_commit() for cs in commit.signatures)


def make_commit(net):
    vs = vote_set(net, height=3, round_=1)
    b = bid(net, b"commit-me")
    for i in range(3):
        vs.add_vote(mkvote(net, i, b, height=3, round_=1))
    # validator 3 voted nil
    vs.add_vote(mkvote(net, 3, net.m.basic.BlockID(), height=3, round_=1))
    return vs, b, vs.make_commit()


def test_make_commit(net):
    vs, b, commit = make_commit(net)
    BlockIDFlag = net.m.block.BlockIDFlag
    assert commit.height == 3 and commit.round == 1 and commit.block_id == b
    flags = [cs.block_id_flag for cs in commit.signatures]
    assert flags == [BlockIDFlag.COMMIT] * 3 + [BlockIDFlag.NIL]
    # the commit verifies against the validator set
    net.m.validation.verify_commit(CHAIN, net.vals, b, 3, commit, **VERIFY_KW[net.side])
    ext = vs.make_extended_commit()
    assert ext.to_commit().encode() == commit.encode()


def test_make_commit_bytes_equal_the_reference():
    """The same votes give the same Commit and ExtendedCommit bytes in both
    packages, and the same bit arrays."""
    (vs_p, _, port), (vs_r, _, ref) = (make_commit(make_net(s)) for s in PACKAGES)
    assert port.encode() == ref.encode()
    assert vs_p.make_extended_commit().encode() == vs_r.make_extended_commit().encode()
    assert vs_p.bit_array().to_bytes() == vs_r.bit_array().to_bytes()


def test_certificates_are_refused_by_name():
    """The port's vote set has no certificate half: `apply_certificate`
    raises UnsupportedCommitFormat where the reference folds a BLS
    aggregate into the set."""
    from cometbft_tpu_torch.types.block import UnsupportedCommitFormat

    vs = vote_set(make_net("port"))
    with pytest.raises(UnsupportedCommitFormat, match="aggregate-precommit certificates"):
        vs.apply_certificate(object())
    assert not vs.has_two_thirds_majority()
