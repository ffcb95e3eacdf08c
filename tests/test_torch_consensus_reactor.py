"""The port's consensus reactor against the JAX package's
(`cometbft_tpu/consensus/reactor.py`): every message's wire bytes, the
decoder and the wire peek on a fuzz corpus (tests/test_fuzz_wire.py),
part assembly, the VoteSetMaj23 answer, catchup votes from a stored
commit, the peer state's bounds, the state machine's reactor hooks, and
validators over TCP: two port nodes (tests/test_node.py:71), and a port
validator beside a reference one. The certificate frame (field 10) is
the one divergence: the port drops it and keeps the peer."""

import random
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from cometbft_tpu.consensus import reactor as RR  # noqa: E402
from cometbft_tpu.consensus import state as RS  # noqa: E402
from cometbft_tpu.consensus import wal as RW  # noqa: E402
from cometbft_tpu.crypto import merkle as RM  # noqa: E402
from cometbft_tpu.encoding import proto as rpb  # noqa: E402
from cometbft_tpu import types as RT  # noqa: E402
from cometbft_tpu.types import agg_commit as RAC  # noqa: E402
from cometbft_tpu.types import block as RB  # noqa: E402
from cometbft_tpu.types import part_set as RPS  # noqa: E402
from cometbft_tpu.types import vote_set as RVS  # noqa: E402
from cometbft_tpu_torch.consensus import reactor as R  # noqa: E402
from cometbft_tpu_torch.consensus import state as S  # noqa: E402
from cometbft_tpu_torch.consensus import wal as W  # noqa: E402
from cometbft_tpu_torch.crypto import merkle as M  # noqa: E402
from cometbft_tpu_torch.crypto.ed25519 import Ed25519PrivKey  # noqa: E402
from cometbft_tpu_torch import types as T  # noqa: E402
from cometbft_tpu_torch.types import block as B  # noqa: E402
from cometbft_tpu_torch.types import part_set as PS  # noqa: E402
from cometbft_tpu_torch.types import vote_set as VS  # noqa: E402
from cometbft_tpu_torch.types.block import UnsupportedCommitFormat  # noqa: E402
from cometbft_tpu_torch.utils import log as L  # noqa: E402
from test_torch_pex import mutations, outcome  # noqa: E402

CHAIN = "reactor-chain"
PORT = "cometbft_tpu_torch"
REF = "cometbft_tpu"


@pytest.fixture(autouse=True)
def quiet_logs():
    sink = L._config.sink
    L.set_sink(lambda level, msg, fields: None)
    yield
    L.set_sink(sink)


def _messages(t, mk, st, wal, part_set):
    """One of each consensus message, built from one package's classes."""
    psh = t.PartSetHeader(3, b"\xbb" * 32)
    bid = t.BlockID(hash=b"\xaa" * 32, part_set_header=psh)
    vote = t.Vote(type=t.SignedMsgType.PRECOMMIT, height=7, round=1, block_id=bid,
                  timestamp=t.Timestamp(1, 2), validator_address=b"\x01" * 20,
                  validator_index=2, signature=b"\x02" * 64)
    prop = t.Proposal(height=7, round=1, pol_round=0, block_id=bid,
                      timestamp=t.Timestamp(3, 4), signature=b"\x03" * 64)
    part = part_set.Part(index=2, bytes_=b"block-part-payload", proof=mk.Proof(
        total=3, index=2, leaf_hash=b"\xcc" * 32, aunts=[b"\xdd" * 32, b""]))
    r = R if mk is M else RR
    return [
        st.VoteMessage(vote), st.ProposalMessage(prop), wal.BlockBytesMessage(7, 1, b"blk"),
        r.NewRoundStepMessage(7, 1, 3, 0), r.NewRoundStepMessage(1, 0, 1, -1),
        r.HasVoteMessage(7, 1, t.SignedMsgType.PREVOTE, 4),
        r.HasVoteMessage(7, 0, t.SignedMsgType.PRECOMMIT, 0),
        r.BlockPartMessage(7, 1, part),
        r.NewValidBlockMessage(7, 1, psh, True), r.NewValidBlockMessage(7, 1, psh, False),
        r.VoteSetMaj23Message(7, 1, t.SignedMsgType.PREVOTE, bid),
        r.VoteSetBitsMessage(7, 1, t.SignedMsgType.PRECOMMIT, bid, (1 << 100) | 5),
        r.VoteSetBitsMessage(7, 1, t.SignedMsgType.PREVOTE, bid, 0),
    ]


def _port_msgs():
    return _messages(T, M, S, W, PS)


def _ref_msgs():
    return _messages(RT, RM, RS, RW, RPS)


def test_every_consensus_message_encodes_to_the_reference_bytes():
    port = [R.encode_consensus_msg(m) for m in _port_msgs()]
    assert port == [RR.encode_consensus_msg(m) for m in _ref_msgs()]
    for raw in port:
        assert R.encode_consensus_msg(R.decode_consensus_msg(raw)) == raw
        assert R.peek_wire_msg(raw) == RR.peek_wire_msg(raw)


def _first_tag(raw: bytes):
    try:
        fields = rpb.parse_fields(raw)
    except Exception:  # noqa: BLE001
        return None
    return fields[0][0] if fields else None


def test_decoder_and_peek_match_the_reference_on_the_fuzz_corpus():
    """The same garbage gives the same value or the same exception class,
    but for a frame whose first field is 10 (a certificate), which the port
    refuses by name."""
    rng = random.Random(1234)
    seeds = [R.encode_consensus_msg(m) for m in _port_msgs()]
    runs = 0
    for valid in seeds:
        for mut in mutations(rng, valid, 120):
            got = outcome(R.decode_consensus_msg, mut)
            if _first_tag(mut) == 10:
                assert got == ("raise", "UnsupportedCommitFormat")
            else:
                assert got == outcome(RR.decode_consensus_msg, mut), mut
            assert outcome(R.peek_wire_msg, mut) == outcome(RR.peek_wire_msg, mut), mut
            runs += 1
    assert runs > 1_000


class FakePeer:
    def __init__(self, pid="peer0"):
        self.id, self.sent, self.node_info = pid, [], None

    def send(self, chan, raw):
        self.sent.append((chan, raw))
        return True


class FakeCS:
    """The parts of ConsensusState the reactor reads, and a log of what it
    was sent."""

    def __init__(self, height=7, round_=1, votes=None, block_store=None):
        self.height, self.round, self.step = height, round_, 1
        self.last_commit, self.proposal, self.votes = None, None, votes
        self.block_store, self.got = block_store, []

    def send(self, msg, peer_id=""):
        self.got.append(msg)


def _reactor(pkg_reactor, **kw):
    cs = FakeCS(**kw)
    r = pkg_reactor.ConsensusReactor(cs)
    peer = FakePeer()
    r.add_peer(peer)
    r.stop()  # the gossip routine exits; receive and the answers stay
    return r, cs, peer


def test_certificate_frame_is_dropped_and_the_peer_kept_unlike_the_reference():
    cert = RAC.AggregateCommit(height=3, round=0, block_id=RT.BlockID(hash=b"\x11" * 32),
                               timestamp=RT.Timestamp(5, 0), bitmap=b"\x07", agg_sig=b"\x09" * 96)
    raw = RR.encode_consensus_msg(RW.AggregateCommitMessage(cert))
    assert isinstance(RR.decode_consensus_msg(raw), RW.AggregateCommitMessage)
    with pytest.raises(UnsupportedCommitFormat, match="not supported by the port"):
        R.decode_consensus_msg(raw)
    r, cs, peer = _reactor(R)
    rr, rcs, _ = _reactor(RR)
    r.receive(R.VOTE_CHANNEL, peer, raw)
    rr.receive(RR.VOTE_CHANNEL, peer, raw)
    assert cs.got == [] and peer.id in r._peers
    assert [type(m).__name__ for m in rcs.got] == ["AggregateCommitMessage"]


def test_block_sync_wait_holds_gossip_until_the_switch_unlike_the_reference():
    """While its node block-syncs (`wait_sync`), the port's reactor
    announces no round step and drops proposals, parts and votes, as
    CometBFT's does; switch_to_consensus() announces the step to every
    peer and takes them again. The reference's reactor has no wait."""
    vote, prop, part = (_port_msgs()[i] for i in (0, 1, 7))
    frames = [(R.VOTE_CHANNEL, R.encode_consensus_msg(vote)),
              (R.DATA_CHANNEL, R.encode_consensus_msg(prop)),
              (R.DATA_CHANNEL, R.encode_consensus_msg(part))]
    cs = FakeCS()
    r = R.ConsensusReactor(cs, wait_sync=True)
    peer = FakePeer()
    r.add_peer(peer)
    r.stop()
    assert peer.sent == []
    for chan, raw in frames:
        r.receive(chan, peer, raw)
    assert cs.got == []
    r.switch_to_consensus()
    assert [chan for chan, _ in peer.sent] == [R.STATE_CHANNEL]
    assert type(R.decode_consensus_msg(peer.sent[0][1])).__name__ == "NewRoundStepMessage"
    for chan, raw in frames:
        r.receive(chan, peer, raw)
    # (one part of three: the reactor holds it until the block is whole)
    assert [type(m).__name__ for m in cs.got] == ["VoteMessage", "ProposalMessage"]
    rr, rcs, rpeer = _reactor(RR)
    assert rpeer.sent and {chan for chan, _ in rpeer.sent} == {RR.STATE_CHANNEL}


def _parts_and_proposal(t, part_set, st, data: bytes):
    ps = part_set.PartSet.from_data(data)
    prop = t.Proposal(height=7, round=1, pol_round=-1, block_id=t.BlockID(
        hash=b"\x42" * 32, part_set_header=ps.header), timestamp=t.Timestamp(9, 0))
    return ps, prop


@pytest.mark.parametrize("order", ["proposal_first", "parts_first"])
def test_part_assembly_matches_the_reference(order):
    """A proposal and its block's parts (one corrupted copy among them) in
    either order: both reactors hand the state machine the proposal and the
    assembled block bytes once, and drop the bad part."""
    data = np.random.default_rng(3).integers(0, 256, 150_000, dtype=np.uint8).tobytes()
    out = []
    for pkg, t, part_set, st in ((R, T, PS, S), (RR, RT, RPS, RS)):
        ps, prop = _parts_and_proposal(t, part_set, st, data)
        frames = [pkg.encode_consensus_msg(pkg.BlockPartMessage(7, 1, p)) for p in ps.parts]
        bad = ps.parts[1]
        bad = type(bad)(index=bad.index, bytes_=b"x" + bad.bytes_[1:], proof=bad.proof)
        frames.insert(1, pkg.encode_consensus_msg(pkg.BlockPartMessage(7, 1, bad)))
        pframe = pkg.encode_consensus_msg(st.ProposalMessage(prop))
        frames = [pframe] + frames if order == "proposal_first" else frames + [pframe]
        r, cs, peer = _reactor(pkg)
        for f in frames:
            r.receive(pkg.DATA_CHANNEL, peer, f)
        out.append([(type(m).__name__, getattr(m, "block_bytes", b"")) for m in cs.got])
    assert out[0] == out[1]
    assert sorted(name for name, _ in out[0]) == ["BlockBytesMessage", "ProposalMessage"]
    assert [b for name, b in out[0] if name == "BlockBytesMessage"] == [data]


def _votes(t, vs_mod, ed_priv, chain_id, n=4, signed=3):
    privs = [ed_priv(bytes([i + 1]) * 32) for i in range(n)]
    vals = t.ValidatorSet([t.Validator.from_pub_key(p.pub_key(), 10) for p in privs])
    by_addr = {p.pub_key().address(): p for p in privs}
    bid = t.BlockID(hash=b"\x55" * 32, part_set_header=t.PartSetHeader(1, b"\x66" * 32))
    vs = vs_mod.VoteSet(chain_id, 7, 1, t.SignedMsgType.PREVOTE, vals)
    for i, val in enumerate(vals.validators[:signed]):
        v = t.Vote(type=t.SignedMsgType.PREVOTE, height=7, round=1, block_id=bid,
                   timestamp=t.Timestamp(100 + i, 0), validator_address=val.address,
                   validator_index=i)
        v.signature = by_addr[val.address].sign(v.sign_bytes(chain_id))
        vs.add_vote(v)
    return vs, bid


class FakeVotes:
    def __init__(self, vs):
        self.vs = vs

    def prevotes(self, r):
        return self.vs if r == self.vs.round else None

    def precommits(self, r):
        return None


def test_maj23_answer_matches_the_reference():
    from cometbft_tpu.crypto.ed25519 import Ed25519PrivKey as RPriv

    sent = []
    for pkg, t, vs_mod, priv in ((R, T, VS, Ed25519PrivKey), (RR, RT, RVS, RPriv)):
        vs, bid = _votes(t, vs_mod, priv, CHAIN)
        r, _, peer = _reactor(pkg, votes=FakeVotes(vs))
        peer.sent.clear()
        r.receive(pkg.STATE_CHANNEL, peer, pkg.encode_consensus_msg(
            pkg.VoteSetMaj23Message(7, 1, t.SignedMsgType.PREVOTE, bid)))
        assert vs.peer_maj23s == {peer.id: bid}
        sent.append(peer.sent)
    assert sent[0] == sent[1] and len(sent[0]) == 1
    assert R.decode_consensus_msg(sent[0][0][1]).bits == 0b111


class FakeStore:
    def __init__(self, commit):
        self.commit = commit

    def load_block_commit(self, h):
        return self.commit if h == self.commit.height else None

    def load_seen_commit(self, h):
        return None


def test_catchup_votes_from_a_stored_commit_match_the_reference():
    """`_commit_as_voteset` turns a stored commit (one slot absent, one nil)
    into the same precommit frames, which a peer two heights behind gets
    one by one through the vote gossip."""
    bid = T.BlockID(hash=b"\x77" * 32, part_set_header=T.PartSetHeader(1, b"\x88" * 32))
    sigs = [B.CommitSig(B.BlockIDFlag.COMMIT, bytes([i]) * 20, T.Timestamp(10 + i, 0),
                        bytes([i]) * 64) for i in range(4)]
    sigs[1] = B.CommitSig.absent()
    sigs[2] = B.CommitSig(B.BlockIDFlag.NIL, b"\x02" * 20, T.Timestamp(12, 0), b"\x02" * 64)
    raw = B.Commit(height=5, round=2, block_id=bid, signatures=sigs).encode()
    frames = []
    for pkg, block_mod in ((R, B), (RR, RB)):
        commit = block_mod.Commit.decode(raw)
        r, cs, peer = _reactor(pkg, height=8, block_store=FakeStore(commit))
        cround, votes = r._commit_as_voteset(5)
        assert cround == 2 and [v.validator_index for v in votes] == [0, 2, 3]
        ps = r._peers[peer.id]
        ps.apply_new_round_step(pkg.NewRoundStepMessage(5, 0, 1, -1))
        peer.sent.clear()
        while r._gossip_votes(ps):
            pass
        frames.append(peer.sent)
    assert frames[0] == frames[1] and len(frames[0]) == 3


def test_peer_state_bounds_match_the_reference():
    out = []
    for pkg in (R, RR):
        ps = pkg.PeerState(FakePeer("p"))
        ps.apply_new_round_step(pkg.NewRoundStepMessage(9, 0, 1, -1))
        ps.mark_part(9, 0, 4)
        ps.mark_part(9, 1, 5)  # another round: not kept
        for h in range(100):
            ps.mark_vote(h, 0, 1, h % 7)
        ps.mark_vote(9, 0, 1, pkg.MAX_VALIDATORS + 1)
        ps.mark_vote(9, 0, 1, -1)
        r, _, peer = _reactor(pkg)
        rps = r._peers[peer.id]
        r.receive(pkg.VOTE_CHANNEL, peer, pkg.encode_consensus_msg(pkg.VoteSetBitsMessage(
            7, 1, 1, T.BlockID() if pkg is R else RT.BlockID(), 1 << (pkg.MAX_VALIDATORS + 1))))
        r.receive(pkg.VOTE_CHANNEL, peer, pkg.encode_consensus_msg(pkg.VoteSetBitsMessage(
            7, 1, 1, T.BlockID() if pkg is R else RT.BlockID(), 0b1011)))
        out.append((ps.snapshot(), sorted(ps.votes_seen.items()), sorted(rps.votes_seen.items())))
    assert out[0] == out[1]
    assert len(out[0][1]) == 64 and out[0][2] == [((7, 1, 1), {0, 1, 3})]


@pytest.mark.parametrize("package", [PORT, REF])
def test_state_hooks_fire_where_the_reference_fires_them(package, tmp_path, monkeypatch):
    """A lockstep network of 4 validators (chip_smoke.lockstep_consensus) to
    height 3 with the tampered proposal at (2, 0): every node's NewRoundStep
    and HasVote calls, in order, equal the reference's."""
    logs = {}
    for pkg in (PORT, REF):
        m = chip_smoke.consensus_modules(pkg)
        log = logs[pkg] = []
        orig = m.state.ConsensusState.__init__

        def init(self, *a, _orig=orig, _log=log, **k):
            _orig(self, *a, **k)
            self.on_new_step = lambda: _log.append(
                ("step", self.name, self.height, self.round, int(self.step)))
            self.on_has_vote = lambda v: _log.append(
                ("vote", self.name, v.height, v.round, int(v.type), v.validator_index))

        monkeypatch.setattr(m.state.ConsensusState, "__init__", init)
        kw = {"device": "cpu"} if pkg == PORT else {"backend": "cpu"}
        chip_smoke.lockstep_consensus(m, 4, 3, tmp_path / pkg, kw, bad=(2, 1), seed=5, n_txs=8)
    assert logs[PORT] == logs[REF]
    kinds = {e[0] for e in logs[package]}
    assert kinds == {"step", "vote"} and len(logs[package]) > 100


# ---- validators over TCP

def test_two_nodes_commit_over_tcp(tmp_path):
    """tests/test_node.py:71 with switches wired by hand: two port
    validators agree on heights 1-3 and a tx submitted at node 1 is
    gossiped and committed."""
    net = chip_smoke.TcpNet(2, tmp_path, exec_kws=[{"device": "cpu"}] * 2, seed=11)
    res = chip_smoke.run_tcp_net(net, [b"net=works"], 3, 60.0)
    assert res["height"] >= 3 and not res["stopped"] and not res["missing_txs"]
    assert len(res["block_hashes"]) == res["height"]
    assert net.nodes[0].book.has(net.nodes[1].id) and net.nodes[1].book.has(net.nodes[0].id)


def test_port_and_reference_validators_agree_over_tcp(tmp_path):
    """A port validator (device "cpu") and a reference validator (backend
    "cpu") on one TCP network commit heights 1-3 with the same block hashes
    (each node's store checked against the other's)."""
    net = chip_smoke.TcpNet(2, tmp_path, packages=[PORT, REF],
                            exec_kws=[{"device": "cpu"}, {"backend": "cpu"}], seed=12)
    res = chip_smoke.run_tcp_net(net, [b"mixed=net"], 3, 60.0)
    assert res["height"] >= 3 and not res["stopped"] and not res["missing_txs"]
    port, ref = net.nodes
    for h in range(1, 4):
        assert port.block_store.load_block(h).encode() == ref.block_store.load_block(h).encode()
        assert port.block_store.load_block(h).hash().hex() == res["block_hashes"][h - 1]


def test_reactor_pushes_a_direct_vote_to_every_peer():
    """A VoteMessage marked direct (a vote outside our own vote set) goes to
    every peer at once, as the reference pushes it."""
    frames = []
    for pkg, st, t in ((R, S, T), (RR, RS, RT)):
        r, _, peer = _reactor(pkg)
        peer.sent.clear()
        vote = _messages(t, M if pkg is R else RM, st, W if pkg is R else RW,
                         PS if pkg is R else RPS)[0].vote
        r.broadcast_msg(st.VoteMessage(vote, direct=True))
        frames.append(peer.sent)
    assert frames[0] == frames[1] and frames[0][0][0] == R.VOTE_CHANNEL


def test_wait_helpers_have_deadlines(tmp_path):
    """The TCP helpers never wait without a deadline."""
    net = chip_smoke.TcpNet(2, tmp_path, exec_kws=[{"device": "cpu"}] * 2)
    t0 = time.monotonic()
    with pytest.raises(AssertionError, match="no full mesh"):
        net.wait_mesh(0.2)  # never started: no peers
    assert time.monotonic() - t0 < 5


@pytest.mark.parametrize("late", [PORT, REF])
def test_late_validator_catches_up_through_consensus_gossip(tmp_path, late):
    """Three port validators commit alone (3 of 4 powers); a fourth joins at
    height 3 or later and catches up through the port's catchup gossip
    (NewValidBlock, the stored block's parts, the stored commit's
    precommits), to the same blocks. The late one is a port or a reference
    validator."""
    net = chip_smoke.TcpNet(4, tmp_path, packages=[PORT] * 3 + [late],
                            exec_kws=[{"device": "cpu"}] * 3 + [
                                {"device": "cpu"} if late == PORT else {"backend": "cpu"}],
                            seed=31)
    nodes = net.nodes
    for nd in nodes:
        nd.transport.listen()
        nd.switch.start()
    host, port = nodes[0].transport.node_info.listen_addr.split(":")
    try:
        for nd in nodes[1:3]:
            nd.switch.dial_peer(host, int(port))
        for nd in nodes[:3]:
            nd.cs.start(replay_wal=False)
        assert nodes[0].cs.wait_for_height(4, timeout=60.0)
        nodes[3].switch.dial_peer(host, int(port))
        nodes[3].cs.start(replay_wal=False)
        top = nodes[0].cs.sm_state.last_block_height
        assert nodes[3].cs.wait_for_height(top + 1, timeout=60.0)
        for h in range(1, top + 1):
            assert nodes[3].block_store.load_block(h).encode() == \
                nodes[0].block_store.load_block(h).encode()
        assert not any(nd.cs._stopped.is_set() for nd in nodes)
    finally:
        net.stop()
