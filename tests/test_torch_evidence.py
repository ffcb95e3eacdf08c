"""The port's evidence types, evidence pool and the executor with a
mempool and an evidence pool attached, against the JAX package's.

Four validators made by the port's factories from a seed (their set
crosses to the reference as its proto bytes), precommits signed on the
host, evidence carried across as its proto encoding, commits as theirs.
Every comparison is exact: the same evidence bytes and hashes, the same
`verify` outcome (accept, or the same class and message) on each
tampered case, the same block bytes and hash with evidence, the pool's
sizes and pending lists at each step, and, over three blocks proposed
from each side's mempool and evidence pool and applied by each side's
executor, the same blocks, state bytes, mempool contents and app
misbehavior. The port runs on the CPU (the native route), the
reference with `backend="cpu"`.
"""

from __future__ import annotations

import types

import pytest

torch = pytest.importorskip("torch")

from cometbft_tpu.abci import kvstore as RK  # noqa: E402
from cometbft_tpu.abci.client import AppConns as RAppConns  # noqa: E402
from cometbft_tpu.evidence import EvidencePool as REvidencePool  # noqa: E402
from cometbft_tpu.light.types import LightBlock as RLightBlock  # noqa: E402
from cometbft_tpu.mempool import CListMempool as RCListMempool  # noqa: E402
from cometbft_tpu.state import execution as RX  # noqa: E402
from cometbft_tpu.state import types as RST  # noqa: E402
from cometbft_tpu.storage import MemKV as RMemKV  # noqa: E402
from cometbft_tpu.storage import StateStore as RStateStore  # noqa: E402
from cometbft_tpu.types import Commit as RCommit  # noqa: E402
from cometbft_tpu.types import Vote as RVote  # noqa: E402
from cometbft_tpu.types import block as RBL  # noqa: E402
from cometbft_tpu.types import evidence as REV  # noqa: E402
from cometbft_tpu_torch.abci import AppConns, KVStoreApp  # noqa: E402
from cometbft_tpu_torch.evidence import EvidencePool  # noqa: E402
from cometbft_tpu_torch.light import LightBlock, SignedHeader  # noqa: E402
from cometbft_tpu_torch.mempool import CListMempool  # noqa: E402
from cometbft_tpu_torch.state import execution as X  # noqa: E402
from cometbft_tpu_torch.state.types import State, encode_validator_set  # noqa: E402
from cometbft_tpu_torch.storage import MemKV, StateStore  # noqa: E402
from cometbft_tpu_torch.types import (  # noqa: E402
    Block,
    Commit,
    CommitSig,
    Data,
    Header,
    Timestamp,
    Vote,
)
from cometbft_tpu_torch.types import evidence as EV  # noqa: E402
from cometbft_tpu_torch.types.block import BlockIDFlag  # noqa: E402
from cometbft_tpu_torch.types.vote import SignedMsgType  # noqa: E402
from cometbft_tpu_torch.utils import factories as fx  # noqa: E402

CHAIN = "ev-chain"


@pytest.fixture(scope="module")
def world():
    signers = fx.make_signers(4, seed=3, device="cpu")
    vals = fx.make_validator_set(signers)
    by_addr = {s.address(): s for s in signers}
    s0 = by_addr[vals.validators[0].address]
    votes = []
    for tag in (b"one", b"two"):
        v = Vote(type=SignedMsgType.PRECOMMIT, height=5, round=0, block_id=fx.make_block_id(tag),
                 timestamp=Timestamp(9, 0), validator_address=vals.validators[0].address,
                 validator_index=0)
        fx.sign_vote(s0, v, CHAIN)
        votes.append(v)
    return types.SimpleNamespace(signers=signers, vals=vals, by_addr=by_addr, votes=votes,
                                 rvals=RST.decode_validator_set(encode_validator_set(vals)))


def _rvote(v):
    return RVote.decode(v.encode())


def _outcome(call):
    try:
        call()
    except Exception as e:  # noqa: BLE001 — compared by class and message
        return type(e).__name__, str(e)
    return None


def _dve(world, a, b, power=10, total=40, ts=Timestamp(10, 0), ordered=True):
    port = (EV.DuplicateVoteEvidence.from_votes(a, b, power, total, ts) if ordered
            else EV.DuplicateVoteEvidence(a, b, total, power, ts))
    ra, rb = _rvote(a), _rvote(b)
    ref = (REV.DuplicateVoteEvidence.from_votes(ra, rb, power, total, ts) if ordered
           else REV.DuplicateVoteEvidence(ra, rb, total, power, ts))
    return port, ref


def _tampered(world):
    """(name, port votes) of the reject cases the reference's verify names."""
    va, vb = world.votes

    def copy(v, **kw):
        out = Vote.decode(v.encode())
        for k, x in kw.items():
            setattr(out, k, x)
        return out

    other = world.vals.validators[1].address
    return [
        ("valid", (va, vb)),
        ("bad_signature", (copy(va, signature=bytes(64)), vb)),
        ("same_block", (va, copy(va))),
        ("other_height", (va, copy(vb, height=6))),
        ("prevote_vs_precommit", (va, copy(vb, type=SignedMsgType.PREVOTE))),
        ("proposal_type", (copy(va, type=SignedMsgType.PROPOSAL),
                           copy(vb, type=SignedMsgType.PROPOSAL))),
        ("other_validator", (va, copy(vb, validator_address=other))),
        ("stranger", (copy(va, validator_address=b"\x09" * 20),
                      copy(vb, validator_address=b"\x09" * 20))),
    ]


@pytest.mark.parametrize("case", range(8))
def test_duplicate_vote_evidence_matches_the_reference(world, case):
    name, (a, b) = _tampered(world)[case]
    port, ref = _dve(world, a, b, world.vals.validators[0].voting_power,
                     world.vals.total_voting_power())
    assert port.encode() == ref.encode() and port.wrapped() == ref.wrapped()
    assert port.hash() == ref.hash() and port.height == ref.height
    back = EV.decode_evidence(ref.wrapped())
    assert back.encode() == port.encode()
    got = _outcome(lambda: port.verify(CHAIN, world.vals))
    want = _outcome(lambda: ref.verify(CHAIN, world.rvals))
    assert got == want
    assert (got is None) == (name == "valid")
    (mb,), (rmb,) = port.to_abci_list(), ref.to_abci_list()
    assert vars(mb).keys() == vars(rmb).keys()
    assert [getattr(mb, k) == getattr(rmb, k) for k in vars(mb) if k != "time"] == \
        [True] * (len(vars(mb)) - 1)
    assert mb.time.unix_ns() == rmb.time.unix_ns()


@pytest.mark.parametrize("what", ["power", "total", "order"])
def test_evidence_field_mismatches_match_the_reference(world, what):
    va, vb = world.votes
    power, total = world.vals.validators[0].voting_power, world.vals.total_voting_power()
    if what == "power":
        port, ref = _dve(world, va, vb, power + 1, total)
    elif what == "total":
        port, ref = _dve(world, va, vb, power, total - 1)
    else:
        a, b = (va, vb) if vb.block_id.key() < va.block_id.key() else (vb, va)
        port, ref = _dve(world, a, b, power, total, ordered=False)
    assert port.wrapped() == ref.wrapped()
    got = _outcome(lambda: port.verify(CHAIN, world.vals))
    assert got is not None and got == _outcome(lambda: ref.verify(CHAIN, world.rvals))


def _light_block(world, height: int):
    sigs = [CommitSig(block_id_flag=BlockIDFlag.COMMIT, validator_address=v.address,
                      timestamp=Timestamp(20 + i, 0), signature=bytes([i + 1]) * 64)
            for i, v in enumerate(world.vals.validators)]
    sigs[2] = CommitSig.absent()
    bid = fx.make_block_id(b"conflicting")
    header = Header(chain_id=CHAIN, height=height, time=Timestamp(30, 0),
                    validators_hash=world.vals.hash(), last_block_id=fx.make_block_id(b"parent"))
    return LightBlock(SignedHeader(header, Commit(height, 0, bid, sigs)), world.vals)


def test_light_client_attack_evidence_matches_the_reference(world):
    lb = _light_block(world, 7)
    byz = [v.address for i, v in enumerate(world.vals.validators) if i != 2]
    port = EV.LightClientAttackEvidence(lb, 3, byz, world.vals.total_voting_power(),
                                        Timestamp(11, 0))
    ref = REV.decode_evidence(port.wrapped())
    assert isinstance(ref, REV.LightClientAttackEvidence)
    assert ref.wrapped() == port.wrapped() and ref.hash() == port.hash()
    assert isinstance(ref.conflicting_block, RLightBlock)
    back = EV.decode_evidence(ref.wrapped())
    assert back.encode() == port.encode() and back.height == 3
    assert [(m.type, m.validator_address, m.validator_power, m.height)
            for m in port.to_abci_list()] == \
        [(m.type, m.validator_address, m.validator_power, m.height) for m in ref.to_abci_list()]
    with pytest.raises(EV.EvidenceError, match="unknown evidence tag 3"):
        EV.decode_evidence(b"\x1a\x00")
    with pytest.raises(EV.EvidenceError, match="empty evidence"):
        EV.decode_evidence(b"")


def test_block_with_evidence_matches_the_reference(world):
    dve, _ = _dve(world, *world.votes)
    lcae = EV.LightClientAttackEvidence(_light_block(world, 7), 3, [b"\x01" * 20], 40,
                                        Timestamp(11, 0))
    h = Header(chain_id=CHAIN, height=6, validators_hash=b"\x01" * 32,
               evidence_hash=EV.evidence_list_hash([dve, lcae]))
    blk = Block(header=h, data=Data([b"tx=1"]), evidence=[dve, lcae])
    rblk = RBL.Block.decode(blk.encode())
    assert rblk.encode() == blk.encode() and rblk.hash() == blk.hash()
    assert REV.evidence_list_hash(rblk.evidence) == h.evidence_hash
    back = Block.decode(blk.encode())
    assert back.encode() == blk.encode() and [e.hash() for e in back.evidence] == \
        [e.hash() for e in rblk.evidence]


def _pools(world):
    """Each side's pool over a state store holding the set at height 5."""
    ss, rss = StateStore(MemKV()), RStateStore(RMemKV())
    enc = encode_validator_set(world.vals)
    ss._db.set(b"SV:" + (5).to_bytes(8, "big"), enc)
    rss._db.set(b"SV:" + (5).to_bytes(8, "big"), enc)
    return (EvidencePool(state_store=ss, chain_id=CHAIN),
            REvidencePool(state_store=rss, chain_id=CHAIN))


def _state(world, height: int, time_s: int, max_age=(100000, 48 * 3600 * 10**9)):
    from cometbft_tpu.state.types import ConsensusParams as RCP
    from cometbft_tpu.state.types import EvidenceParams as REP
    from cometbft_tpu.state.types import State as RState

    rs = RState(chain_id=CHAIN, initial_height=1, last_block_height=height,
                last_block_time=Timestamp(time_s, 0), validators=world.rvals,
                last_validators=world.rvals, next_validators=world.rvals,
                last_height_validators_changed=1,
                consensus_params=RCP(evidence=REP(max_age_num_blocks=max_age[0],
                                                  max_age_duration_ns=max_age[1])))
    return State.decode(rs.encode()), rs


def test_pool_flow_matches_the_reference(world):
    """add, pending, check (accept; duplicate; committed; over the cap; no
    set stored), update, re-add, report -> materialize, and pruning by age:
    the same sizes, pending bytes and outcomes on both sides."""
    pool, rpool = _pools(world)
    ev, rev = _dve(world, *world.votes, world.vals.validators[0].voting_power,
                   world.vals.total_voting_power())
    trace = []

    def both(fn, rfn):
        got, want = _outcome(fn), _outcome(rfn)
        assert got == want
        trace.append((got, pool.size(), rpool.size(),
                      [e.wrapped() for e in pool.pending_evidence()] ==
                      [e.wrapped() for e in rpool.pending_evidence()]))

    both(lambda: pool.add_evidence(ev), lambda: rpool.add_evidence(rev))
    both(lambda: pool.check_evidence([ev]), lambda: rpool.check_evidence([rev]))
    both(lambda: pool.check_evidence([ev, ev]), lambda: rpool.check_evidence([rev, rev]))
    both(lambda: pool.check_evidence([ev], 10), lambda: rpool.check_evidence([rev], 10))
    wrong_h, rwrong_h = _dve(world, *[Vote.decode(v.encode()) for v in world.votes])
    for v, rv in ((wrong_h.vote_a, rwrong_h.vote_a), (wrong_h.vote_b, rwrong_h.vote_b)):
        v.height = rv.height = 4
    both(lambda: pool.check_evidence([wrong_h]), lambda: rpool.check_evidence([rwrong_h]))
    st, rst = _state(world, 6, 11)
    both(lambda: pool.update(st, [ev]), lambda: rpool.update(rst, [rev]))
    both(lambda: pool.add_evidence(ev), lambda: rpool.add_evidence(rev))
    both(lambda: pool.check_evidence([ev]), lambda: rpool.check_evidence([rev]))
    # a report materializes at the next update; aged out once both limits pass
    pool2, rpool2 = _pools(world)
    pool, rpool = pool2, rpool2
    both(lambda: pool.report_conflicting_votes(*world.votes),
         lambda: rpool.report_conflicting_votes(*[_rvote(v) for v in world.votes]))
    both(lambda: pool.update(st, []), lambda: rpool.update(rst, []))
    st2, rst2 = _state(world, 9, 12, max_age=(3, 10**9))
    both(lambda: pool.update(st2, []), lambda: rpool.update(rst2, []))
    st3, rst3 = _state(world, 9, 13, max_age=(3, 10**9))
    both(lambda: pool.update(st3, []), lambda: rpool.update(rst3, []))
    sizes = [(t[0] is None, t[1], t[3]) for t in trace]
    assert sizes == [(True, 1, True), (True, 1, True), (False, 1, True), (False, 1, True),
                     (False, 1, True), (True, 0, True), (True, 0, True), (False, 0, True),
                     (True, 0, True), (True, 1, True), (True, 1, True), (True, 0, True)]


def _executors(world):
    """Each side's executor with a mempool, an evidence pool, a state
    store holding genesis, and a KVStore app that keeps the misbehavior
    FinalizeBlock hands it."""
    out = []
    for kv, appconns, mempool_cls, pool_cls, ss, bx, vals, dev in (
            (KVStoreApp, AppConns, CListMempool, EvidencePool, StateStore(MemKV()), X,
             world.vals, {"device": "cpu"}),
            (RK.KVStoreApp, RAppConns, RCListMempool, REvidencePool, RStateStore(RMemKV()), RX,
             world.rvals, {"backend": "cpu"})):
        class Seen(kv):
            def __init__(self):
                super().__init__()
                self.seen = []

            def finalize_block(self, req):
                self.seen.extend((m.type, m.validator_address, m.height)
                                 for m in req.misbehavior)
                return super().finalize_block(req)

        app = Seen()
        conns = appconns(app)
        mp = mempool_cls(conns)
        pool = pool_cls(state_store=ss, chain_id=CHAIN)
        genesis = bx.make_genesis_state(CHAIN, vals)
        ss.save(genesis)
        ex = bx.BlockExecutor(conns, state_store=ss, mempool=mp, evidence_pool=pool, **dev)
        out.append(types.SimpleNamespace(app=app, mp=mp, pool=pool, ex=ex, state=genesis))
    return out


def test_blocks_with_mempool_and_evidence_match_the_reference(world):
    """Three blocks, each proposed by `create_proposal_block` from the
    side's own mempool and evidence pool and applied by `apply_block`
    with both attached; votes at height 1 reported after block 1 are
    proposed in block 3. The port's commits cross to the reference as
    bytes."""
    port, ref = _executors(world)
    txs = [b"k%d=v%d" % (i, i) for i in range(9)] + [b"bad-tx"]
    for side in (port, ref):
        for tx in txs[:6]:
            side.mp.check_tx(tx)
    r_pool = fx.RPool(4, 3, device="cpu")
    last, rlast = Commit(), RCommit()
    for h in range(1, 4):
        blocks = []
        for side, lc in ((port, last), (ref, rlast)):
            reaped = side.mp.reap_max_bytes_max_gas(40)
            blocks.append(side.ex.create_proposal_block(
                h, side.state, lc, side.state.validators.get_proposer().address, reaped,
                block_time=side.state.last_block_time))
        blk, rblk = blocks
        assert blk.encode() == rblk.encode() and blk.hash() == rblk.hash()
        bid = fx.block_id_for(blk)
        commit = fx.make_commit(CHAIN, h, 0, bid, port.state.validators, world.by_addr,
                                time_ns=1_700_000_000_000_000_000 + h * 10**9, device="cpu",
                                r_pool=r_pool)
        port.state = port.ex.apply_block(port.state, bid, blk)
        ref.state = ref.ex.apply_block(ref.state, RBL.block_id_for(rblk), rblk)
        assert port.state.encode() == ref.state.encode()
        assert port.mp.reap_max_txs(-1) == ref.mp.reap_max_txs(-1)
        assert port.pool.size() == ref.pool.size()
        last, rlast = commit, RCommit.decode(commit.encode())
        if h == 1:
            for side in (port, ref):
                for tx in txs[6:]:
                    side.mp.check_tx(tx) if tx != b"bad-tx" else \
                        pytest.raises(ValueError, side.mp.check_tx, tx)
            votes = []
            for tag in (b"x", b"y"):
                v = Vote(type=SignedMsgType.PRECOMMIT, height=1, round=0,
                         block_id=fx.make_block_id(tag), timestamp=Timestamp(9, 0),
                         validator_address=world.vals.validators[2].address, validator_index=2)
                fx.sign_vote(world.by_addr[v.validator_address], v, CHAIN)
                votes.append(v)
            port.pool.report_conflicting_votes(*votes)
            ref.pool.report_conflicting_votes(*[_rvote(v) for v in votes])
        if h == 3:
            assert [len(e.wrapped()) for e in blk.evidence] == \
                [len(e.wrapped()) for e in rblk.evidence] and len(blk.evidence) == 1
    assert port.app.seen == ref.app.seen == [(1, world.vals.validators[2].address, 1)]
    assert port.pool.size() == 0 and not port.pool.pending_evidence()
    # committed txs stay in the cache: a second submit is refused on both sides
    assert _outcome(lambda: port.mp.check_tx(b"k0=v0")) == \
        _outcome(lambda: ref.mp.check_tx(b"k0=v0"))
