"""The port's consensus (`cometbft_tpu_torch/consensus/`) against the
reference's: the WAL (framing, corruption, rotation, and records that
each package reads from the other), the threaded `InProcessNetwork` at device "cpu" in the scenarios of
`tests/test_consensus.py` and `tests/test_vote_extensions.py`, and the
port's two departures: a device error on a peer's message halts the node,
and an aggregate-precommit certificate is refused by name. The lockstep
network at 4 validators is held against the reference in
`tests/test_torch_chip_smoke.py`.
"""

import threading
import time
from dataclasses import replace

import pytest

pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from cometbft_tpu_torch.consensus import state as S  # noqa: E402
from cometbft_tpu_torch.consensus.net import (  # noqa: E402
    FAST_TIMEOUTS,
    InProcessNetwork,
    InProcessNode,
)
from cometbft_tpu_torch.consensus.state import RoundStep, TimeoutConfig  # noqa: E402
from cometbft_tpu_torch.consensus.wal import (  # noqa: E402
    WAL,
    AggregateCommitMessage,
    BlockBytesMessage,
    EndHeightMessage,
    MsgInfo,
    TimeoutMessage,
)
from cometbft_tpu_torch.ops.kernels import KernelError  # noqa: E402
from cometbft_tpu_torch.types import BlockID, PartSetHeader, Proposal, Timestamp, Vote  # noqa: E402
from cometbft_tpu_torch.types.block import UnsupportedCommitFormat  # noqa: E402
from cometbft_tpu_torch.types.vote import SignedMsgType  # noqa: E402


@pytest.fixture(autouse=True)
def quiet_consensus_log():
    """The nodes' "finalized block" records go nowhere instead of stderr."""
    from cometbft_tpu_torch.utils import log as L

    sink = L._config.sink
    L.set_sink(lambda level, msg, fields: None)
    yield
    L.set_sink(sink)


def wal_records(vote_cls, prop_cls, bid_cls, psh_cls, ts_cls, sign_type):
    bid = bid_cls(b"h" * 32, psh_cls(1, b"p" * 32))
    vote = vote_cls(type=sign_type.PREVOTE, height=3, round=1, block_id=bid,
                    timestamp=ts_cls(12, 34), validator_address=b"a" * 20, validator_index=2,
                    signature=b"s" * 64)
    prop = prop_cls(height=3, round=1, pol_round=-1, block_id=bid, timestamp=ts_cls(9, 9),
                    signature=b"q" * 64)
    return vote, prop


# ---------------------------------------------------------------- WAL ----
def test_wal_roundtrip(tmp_path):
    wal = WAL(str(tmp_path / "wal"))
    vote, prop = wal_records(Vote, Proposal, BlockID, PartSetHeader, Timestamp, SignedMsgType)
    wal.write(MsgInfo(vote, "peer-7"))
    wal.write_sync(MsgInfo(prop, ""))
    wal.write(MsgInfo(BlockBytesMessage(3, 1, b"blockbytes"), "p"))
    wal.write(TimeoutMessage(3, 1, 5, 100))
    wal.write_end_height(3)
    msgs = wal.read_all()
    assert len(msgs) == 5
    assert msgs[0].msg.peer_id == "peer-7" and msgs[0].msg.msg == vote
    assert msgs[1].msg.msg == prop
    assert msgs[2].msg.msg.block_bytes == b"blockbytes"
    assert msgs[3].msg == TimeoutMessage(3, 1, 5, 100)
    assert msgs[4].msg == EndHeightMessage(3)
    assert wal.search_for_end_height(3) == []
    assert wal.search_for_end_height(2) is None
    assert wal.search_for_end_height(0) is None  # not present either


def test_wal_detects_corruption(tmp_path):
    from cometbft_tpu_torch.consensus.wal import WALCorruptionError

    wal = WAL(str(tmp_path / "wal"))
    wal.write_end_height(1)
    wal.write_end_height(2)
    wal.flush()
    with open(str(tmp_path / "wal"), "r+b") as f:
        f.seek(10)
        b = f.read(1)
        f.seek(10)
        f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(WALCorruptionError, match="crc mismatch"):
        wal.read_all()


def test_wal_rotation(tmp_path):
    wal = WAL(str(tmp_path / "wal"), max_file_bytes=200)
    for h in range(1, 20):
        wal.write_end_height(h)
    msgs = wal.read_all()
    assert [m.msg.height for m in msgs] == list(range(1, 20))
    assert len(wal._rolled_paths()) > 0
    assert wal.search_for_end_height(19) == []
    tail = wal.search_for_end_height(18)
    assert len(tail) == 1 and tail[0].msg == EndHeightMessage(19)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_wal_reads_in_the_other_package(tmp_path, writer):
    """The same records written by either package give the same bytes,
    rotated the same way, and decode in the other to equal messages
    (compared by their encodings, with their times)."""
    from cometbft_tpu import types as RT
    from cometbft_tpu.consensus import wal as RW
    from cometbft_tpu.types import proposal as RP
    from cometbft_tpu.types import vote as RV
    from cometbft_tpu_torch.consensus import wal as PW

    sides = {"port": (PW, Vote, Proposal, BlockID, PartSetHeader, Timestamp, SignedMsgType),
             "reference": (RW, RT.Vote, RP.Proposal, RT.BlockID, RT.PartSetHeader,
                           RT.Timestamp, RV.SignedMsgType)}
    reader = "reference" if writer == "port" else "port"
    W = sides[writer][0]
    vote, prop = wal_records(*sides[writer][1:])
    wal = W.WAL(str(tmp_path / "wal"), max_file_bytes=300)
    for h in range(1, 4):
        wal.write(W.MsgInfo(vote, "peer-7"))
        wal.write_sync(W.MsgInfo(prop, ""))
        wal.write(W.MsgInfo(W.BlockBytesMessage(h, 0, b"block %d" % h), "p"))
        wal.write(W.TimeoutMessage(h, 1, 5, 100))
        wal.write_end_height(h)
    wal.close()
    R = sides[reader][0]
    got = R.WAL(str(tmp_path / "wal"), max_file_bytes=300)
    mine = W.WAL(str(tmp_path / "wal"), max_file_bytes=300)
    theirs, ours = got.read_all(), mine.read_all()
    assert len(got._rolled_paths()) > 1 and len(theirs) == len(ours) == 15
    assert [R._encode_timed(t) for t in theirs] == [W._encode_timed(t) for t in ours]
    assert [t.time_ns for t in theirs] == [t.time_ns for t in ours]
    assert got.search_for_end_height(2)[-1].msg.height == 3


def test_certificates_are_refused_by_name(tmp_path):
    """An AggregateCommitMessage (the reference's BLS catchup gossip) is
    refused by name: the WAL neither writes nor reads one, a peer's is
    dropped before the WAL, our own halts."""
    from cometbft_tpu.consensus import wal as RW

    wal = WAL(str(tmp_path / "wal"))
    with pytest.raises(UnsupportedCommitFormat, match="AggregateCommitMessage"):
        wal.write(MsgInfo(AggregateCommitMessage(cert=None), "peer"))
    # a record framed as the reference frames a certificate (MsgInfo field 4)
    import struct
    import zlib

    from cometbft_tpu.encoding import proto as pb

    body = pb.f_embedded(4, b"\x0a\x00") + pb.f_string(15, "peer")
    payload = pb.f_varint(1, 5) + pb.f_embedded(3, body)
    (tmp_path / "ref").write_bytes(
        RW._encode_timed(RW.TimedWALMessage(5, RW.EndHeightMessage(1)))
        + struct.pack(">II", zlib.crc32(payload), len(payload)) + payload)
    with pytest.raises(UnsupportedCommitFormat, match="AggregateCommitMessage"):
        WAL(str(tmp_path / "ref")).read_all()
    net = InProcessNetwork(1, str(tmp_path), device="cpu")
    cs = net.nodes[0].cs
    with pytest.raises(UnsupportedCommitFormat, match="AggregateCommitMessage"):
        cs._handle_msg(AggregateCommitMessage(cert=None), "peer")
    before = len(cs.wal.read_all())
    cs._process(MsgInfo(AggregateCommitMessage(cert=None), "peer"))  # dropped
    assert len(cs.wal.read_all()) == before
    with pytest.raises(UnsupportedCommitFormat, match="AggregateCommitMessage"):
        cs._process(MsgInfo(AggregateCommitMessage(cert=None), ""))


# ------------------------------------------------------- single node ----
def test_single_validator_commits(tmp_path):
    net = InProcessNetwork(1, str(tmp_path), device="cpu")
    net.start()
    try:
        assert net.wait_for_height(4, timeout=30), "1-val net stalled"
        node = net.nodes[0]
        assert node.block_store.height() >= 3
        blk, commit = node.block_store.load_block(2), node.block_store.load_seen_commit(2)
        assert blk is not None and commit is not None
        assert commit.block_id == net.nodes[0].cs.decided[2]
    finally:
        net.stop()


# ------------------------------------------------------------ 4 nodes ----
def test_four_validator_net_commits(tmp_path):
    net = InProcessNetwork(4, str(tmp_path), device="cpu")
    net.start()
    try:
        assert net.wait_for_height(4, timeout=60), "4-val net stalled"
    finally:
        net.stop()
    # all nodes agree on every committed block and on the app hash
    for h in range(1, 4):
        ids = {n.cs.decided[h].key() for n in net.nodes if h in n.cs.decided}
        assert len(ids) == 1, f"disagreement at height {h}"
    h = min(n.cs.sm_state.last_block_height for n in net.nodes)
    assert h >= 3
    assert len({n.block_store.load_block(h).header.app_hash for n in net.nodes}) == 1
    assert not any(n.cs.halt_error for n in net.nodes)


def test_net_survives_partition_of_one(tmp_path):
    """3/4 nodes keep committing; the partitioned node catching up is not
    required (no blocksync yet), liveness of the quorum is."""
    net = InProcessNetwork(4, str(tmp_path), device="cpu")
    net.start()
    try:
        assert net.wait_for_height(2, timeout=60)
        net.partition(3)
        target = max(n.cs.height for n in net.nodes[:3]) + 2
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if all(n.cs.height >= target for n in net.nodes[:3]):
                break
            time.sleep(0.05)
        assert all(n.cs.height >= target for n in net.nodes[:3]), (
            "quorum stalled after partition")
    finally:
        net.stop()


def test_tx_flows_from_mempool_to_block(tmp_path):
    """CheckTx -> gossip -> proposal -> committed block on all nodes."""
    net = InProcessNetwork(4, str(tmp_path), device="cpu")
    net.start()
    try:
        assert net.wait_for_height(2, timeout=60)
        net.nodes[1].mempool.check_tx(b"hello=world")
        target = max(n.cs.height for n in net.nodes) + 3
        assert net.wait_for_height(target, timeout=60)
        found = 0
        for n in net.nodes:
            for h in range(1, n.block_store.height() + 1):
                blk = n.block_store.load_block(h)
                if blk and b"hello=world" in blk.data.txs:
                    found += 1
                    break
        assert found == 4, f"tx committed on {found}/4 nodes"
        assert all(n.mempool.size() == 0 for n in net.nodes)
        assert all(n.app.query("", b"hello").value == b"world" for n in net.nodes)
    finally:
        net.stop()


# --------------------------------------------------------- crash/replay --
def test_crash_replay_recovers_mid_height(tmp_path):
    """Kill a 1-validator node after it commits, restart from WAL + stores:
    it resumes from the next height without double-sign errors."""
    from cometbft_tpu_torch.blocksync.replay import ReplayEngine
    from cometbft_tpu_torch.consensus.height_vote_set import HeightVoteSet
    from cometbft_tpu_torch.privval import FilePV

    net = InProcessNetwork(1, str(tmp_path), device="cpu")
    net.start()
    assert net.wait_for_height(3, timeout=30)
    node = net.nodes[0]
    net.stop()  # abrupt: whatever was in flight stays in the WAL
    committed = node.cs.sm_state.last_block_height
    assert committed >= 2

    # "restart": same WAL, same privval files, state recovered from stores
    pv2 = FilePV.load(str(tmp_path / "pv0.key.json"), str(tmp_path / "pv0.state.json"))
    node2 = InProcessNode(0, pv2, net.chain_id, net.genesis, str(tmp_path / "wal0"), net,
                          FAST_TIMEOUTS, device="cpu")
    engine = ReplayEngine(node.block_store, node2.executor, verify_mode="full", device="cpu")
    state2, _ = engine.run(net.genesis)
    assert state2.last_block_height == committed
    node2.block_store = node.block_store
    node2.cs.block_store = node.block_store
    node2.cs.sm_state = state2
    node2.cs.height = committed + 1
    node2.cs.validators = state2.validators.copy()
    node2.cs.votes = HeightVoteSet(net.chain_id, node2.cs.height, node2.cs.validators)
    node2.cs.start(replay_wal=True)
    try:
        assert node2.cs.wait_for_height(committed + 2, timeout=30), (
            "restarted node did not resume committing")
        assert node2.cs.halt_error is None
    finally:
        node2.cs.stop()
        node2.mempool.close()


# ------------------------------------------------------ vote extensions --
def ext_app_class():
    from cometbft_tpu_torch.abci import KVStoreApp

    class ExtApp(KVStoreApp):
        """kvstore + vote extensions: extends with a height-tagged blob and
        records what PrepareProposal/VerifyVoteExtension observed."""

        def __init__(self):
            super().__init__()
            self.seen_local_commits: list = []
            self.verified: list = []

        def extend_vote(self, height, round_, block_hash):
            return b"ext-%d" % height

        def verify_vote_extension(self, height, addr, ext):
            ok = ext == b"ext-%d" % height
            self.verified.append((height, ok))
            return ok

        def prepare_proposal(self, txs, max_tx_bytes, local_last_commit=None):
            self.seen_local_commits.append(local_last_commit)
            return super().prepare_proposal(txs, max_tx_bytes)

    return ExtApp


def ext_params():
    from cometbft_tpu_torch.state.types import ABCIParams, ConsensusParams

    return ConsensusParams(abci=ABCIParams(vote_extensions_enable_height=1))


def test_extensions_flow_through_consensus(tmp_path):
    from cometbft_tpu_torch.types.extended_commit import ExtendedCommit

    net = InProcessNetwork(4, str(tmp_path), timeouts=FAST_TIMEOUTS,
                           consensus_params=ext_params(), app_factory=ext_app_class(),
                           device="cpu")
    net.start()
    try:
        assert net.wait_for_height(4, timeout=60)
    finally:
        net.stop()
    node = net.nodes[0]
    # extended commits stored for every decided height
    for h in range(1, 4):
        ec = node.block_store.load_extended_commit(h)
        assert isinstance(ec, ExtendedCommit), h
        with_ext = [s for s in ec.extended_signatures
                    if s.extension == b"ext-%d" % h and s.extension_signature]
        assert len(with_ext) >= 3, (h, ec.extended_signatures)
        assert ExtendedCommit.decode(ec.encode()) == ec
        assert ec.to_commit().height == h
    # peers' extensions were app-verified
    assert any(ok for _, ok in node.app.verified)
    # some proposer at height >= 2 saw the previous extended commit
    seen = [c for n in net.nodes for c in n.app.seen_local_commits if c is not None]
    assert seen, "no proposer received a LocalLastCommit"
    assert all(isinstance(c, ExtendedCommit) for c in seen)


def test_bad_extension_rejected(tmp_path):
    """A precommit whose extension signature is forged, or missing, is not
    counted (`_verify_vote_extension`); the honest one is."""
    net = InProcessNetwork(2, str(tmp_path), timeouts=FAST_TIMEOUTS,
                           consensus_params=ext_params(), app_factory=ext_app_class(),
                           device="cpu")
    cs = net.nodes[0].cs
    pv = net.pvs[1]
    idx, val = cs.validators.get_by_address(pv.address())
    bid = BlockID(b"\xab" * 32, PartSetHeader(1, b"\xcd" * 32))
    vote = Vote(type=SignedMsgType.PRECOMMIT, height=cs.height, round=0, block_id=bid,
                timestamp=Timestamp(1_700_000_000, 0), validator_address=pv.address(),
                validator_index=idx, extension=b"ext-1")
    pv.sign_vote(net.chain_id, vote, sign_extension=True)
    good = replace(vote)
    cs._handle_vote(replace(vote, extension=b"evil"), peer_id="peer-x")  # forged
    assert cs.votes.precommits(0).sum == 0
    cs._handle_vote(replace(vote, extension_signature=b""), peer_id="peer-x")  # missing
    assert cs.votes.precommits(0).sum == 0
    cs._handle_vote(good, peer_id="peer-x")
    assert cs.votes.precommits(0).sum == val.voting_power


# ------------------------------------------------------------ devices ----
def test_cuda_without_a_gpu_raises(tmp_path):
    """The network, its nodes and their executors default to device
    "cuda", which raises on a host without a GPU."""
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        InProcessNetwork(1, str(tmp_path))
    net = InProcessNetwork(1, str(tmp_path), device="cpu")
    assert net.nodes[0].executor.device.type == "cpu"
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        InProcessNode(0, net.pvs[0], net.chain_id, net.genesis, str(tmp_path / "w"), net,
                      FAST_TIMEOUTS)


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
@pytest.mark.parametrize("error, halts", [
    (KernelError("ladder_sub_mul8 launch failed: cudaError 700"), True),
    (RuntimeError("CUDA error: an illegal memory access was encountered"), True),
    (ValueError("malformed block"), False),
])
def test_device_error_on_a_peer_proposal_halts_the_node(tmp_path, monkeypatch, error, halts):
    """A peer's complete proposal reaches `enter_prevote` -> `validate_block`
    inside the receive loop's per-message guard. A device error there (a
    kernel that failed to launch, a CUDA error) halts the node with that
    error, where the reference drops it; an error of the message itself is
    still dropped and the node keeps running, without a prevote."""
    net = InProcessNetwork(4, str(tmp_path), device="cpu",
                           timeouts=TimeoutConfig(propose=30.0, commit=0.0))
    proposer_addr = net.genesis.validators.get_proposer().address
    proposer = next(n for n in net.nodes if n.pv.address() == proposer_addr)
    node = next(n for n in net.nodes if n is not proposer)
    calls = []

    def failing(state, block, device="cuda", last_commit_preverified=False):
        calls.append(threading.current_thread().name)
        raise error

    monkeypatch.setattr(S, "validate_block", failing)
    node.cs.start(replay_wal=False)
    try:
        deadline = time.monotonic() + 10
        while node.cs.step != RoundStep.PROPOSE and time.monotonic() < deadline:
            time.sleep(0.01)
        assert node.cs.step == RoundStep.PROPOSE
        proposer.cs.enter_new_round(1, 0)  # broadcasts the proposal and its block
        deadline = time.monotonic() + 10
        while not (calls and node.cs.inbox.empty()) and time.monotonic() < deadline:
            time.sleep(0.01)
        if halts:
            node.cs._thread.join(timeout=10)
        assert calls == [f"cs-{node.cs.name}"]
        assert node.cs._stopped.is_set() is halts
        assert (node.cs.halt_error is error) is halts
        # the step moved to PREVOTE, but no prevote was signed either way
        assert node.cs.step == RoundStep.PREVOTE and node.pv._lss.height == 0
        peers = [m.msg.peer_id for m in node.wal.read_all() if isinstance(m.msg, MsgInfo)]
        assert peers == [f"node{proposer.idx}"] * 2  # the proposal and its block, logged
    finally:
        node.cs.stop()
        for n in net.nodes:
            n.mempool.close()
