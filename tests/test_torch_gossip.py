"""The port's mempool and evidence reactors against the JAX package's
(`cometbft_tpu/{mempool,evidence}/reactor.py`): the gossip cap
(tests/test_utils_internals.py:205), the multi-tx frame and a slow
subscriber (tests/test_mempool_admission.py:266, :124), evidence in and
out of the reactor, the evidence decoder on a fuzz corpus
(tests/test_fuzz_wire.py), tx gossip between a port node and a
reference node over TCP, and the equivocation flow of
tests/test_evidence_reactor.py:45 with switches wired by hand."""

import time

import pytest

pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from cometbft_tpu.abci.client import AppConns as RAppConns  # noqa: E402
from cometbft_tpu.abci.kvstore import KVStoreApp as RKVStoreApp  # noqa: E402
from cometbft_tpu.crypto.ed25519 import Ed25519PrivKey as RPriv  # noqa: E402
from cometbft_tpu.evidence import EvidencePool as REvidencePool  # noqa: E402
from cometbft_tpu.evidence import reactor as RER  # noqa: E402
from cometbft_tpu.mempool import CListMempool as RCListMempool  # noqa: E402
from cometbft_tpu.mempool import reactor as RMR  # noqa: E402
from cometbft_tpu import p2p as RP2P  # noqa: E402
from cometbft_tpu import storage as RST  # noqa: E402
from cometbft_tpu import types as RT  # noqa: E402
from cometbft_tpu.state import types as RSTT  # noqa: E402
from cometbft_tpu.types import evidence as REV  # noqa: E402
from cometbft_tpu_torch import p2p as P2P  # noqa: E402
from cometbft_tpu_torch import storage as ST  # noqa: E402
from cometbft_tpu_torch import types as T  # noqa: E402
from cometbft_tpu_torch.abci import AppConns, KVStoreApp  # noqa: E402
from cometbft_tpu_torch.crypto.ed25519 import Ed25519PrivKey  # noqa: E402
from cometbft_tpu_torch.evidence import EvidencePool  # noqa: E402
from cometbft_tpu_torch.evidence import reactor as ER  # noqa: E402
from cometbft_tpu_torch.mempool import AdmissionPipeline, CListMempool  # noqa: E402
from cometbft_tpu_torch.mempool import reactor as MR  # noqa: E402
from cometbft_tpu_torch.state import types as STT  # noqa: E402
from cometbft_tpu_torch.types import evidence as EV  # noqa: E402
from cometbft_tpu_torch.utils import log as L  # noqa: E402
from test_torch_pex import same_decoding  # noqa: E402

CHAIN = "gossip-chain"
DEADLINE_S = 30.0


@pytest.fixture(autouse=True)
def quiet_logs():
    sink = L._config.sink
    L.set_sink(lambda level, msg, fields: None)
    yield
    L.set_sink(sink)


def _wait(cond, timeout_s=DEADLINE_S):
    deadline = time.monotonic() + timeout_s
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.02)
    return cond()


def _mp(window=8):
    mp = CListMempool(AppConns(KVStoreApp()))
    mp.attach_pipeline(AdmissionPipeline(mp, window=window, max_delay_s=0.002, device="cpu"))
    return mp


class FakePeer:
    def __init__(self, i):
        self.id, self.got, self.frames = f"p{i}", 0, []

    def send(self, chan, payload):
        assert chan in (MR.MEMPOOL_CHANNEL, ER.EVIDENCE_CHANNEL)
        self.got += 1
        self.frames.append(payload)
        return True


class FakeSwitch:
    def __init__(self, peers):
        self._p = peers

    def peers(self):
        return list(self._p)

    def broadcast(self, chan, payload):
        for p in self._p:
            p.send(chan, payload)


class FakeMempool:
    def __init__(self):
        self.on_new_txs = []


# ---- the mempool reactor

def test_mempool_reactor_gossip_cap():
    """max_gossip_peers caps fan-out per broadcast with a random sample (not a
    fixed prefix, which would starve later peers)."""
    peers = [FakePeer(i) for i in range(6)]
    r = MR.MempoolReactor(FakeMempool(), max_gossip_peers=2)
    r.set_switch(FakeSwitch(peers))
    for _ in range(60):
        r._broadcast_txs([b"tx"])
    assert sum(p.got for p in peers) == 120
    assert all(p.got > 0 for p in peers), "sampling must rotate peers"


def test_multi_tx_gossip_frame_roundtrip_and_bytes():
    """An admitted window goes out as one frame, the reference's bytes; the
    receiving reactor admits every tx of it through submit_tx."""
    sent, rsent = [], []

    class Queue:
        def __init__(self, out):
            self.out = out

        def queue_broadcast(self, chan_id, payload):
            self.out.append((chan_id, payload))

        def peers(self):
            return []

    sender, receiver = _mp(), _mp()
    try:
        r_send = MR.MempoolReactor(sender)
        r_send.set_switch(Queue(sent))
        ref = RMR.MempoolReactor(FakeMempool())
        ref.set_switch(Queue(rsent))
        txs = [b"x=1", b"y=2", b"", b"z=3"]
        r_send._broadcast_txs(txs)
        ref._broadcast_txs(txs)
        assert sent == rsent and len(sent) == 1 and sent[0][0] == MR.MEMPOOL_CHANNEL
        MR.MempoolReactor(receiver).receive(MR.MEMPOOL_CHANNEL, FakePeer(0), sent[0][1])
        assert _wait(lambda: receiver.size() == 3, 5)
        assert sorted(receiver.reap_max_txs(-1)) == [b"x=1", b"y=2", b"z=3"]
    finally:
        sender.close()
        receiver.close()


def test_admitted_window_reaches_the_reactor_in_one_call():
    """The admission pipeline hands the reactor each admitted window through
    on_new_txs: one frame per window, in admission (reap) order."""
    mp = _mp(window=8)
    sent = []

    class Queue:
        def queue_broadcast(self, chan_id, payload):
            sent.append(payload)

    try:
        MR.MempoolReactor(mp).set_switch(Queue())
        futs = [mp.submit_tx(b"k%d=%d" % (i, i)) for i in range(8)]
        for f in futs:
            f.result(timeout=10)
        assert _wait(lambda: sum(len(MR.pb.parse_fields(f)) for f in sent) == 8, 5)
        got = [MR.pb.as_bytes(v) for f in sent for _, _, v in MR.pb.parse_fields(f)]
        assert got == mp.reap_max_txs(-1)
    finally:
        mp.close()


def test_slow_gossip_subscriber_does_not_stall_admission():
    """A slow subscriber (a reactor whose switch blocks) must not stall the
    admitting caller: the notifier runs off the admission path."""
    mp = CListMempool(AppConns(KVStoreApp()))

    class SlowSwitch:
        def queue_broadcast(self, chan_id, payload):
            time.sleep(0.25)

    try:
        MR.MempoolReactor(mp).set_switch(SlowSwitch())
        t0 = time.perf_counter()
        for i in range(5):
            mp.check_tx(b"k%d=%d" % (i, i))
        assert time.perf_counter() - t0 < 0.25
    finally:
        mp.close()


def test_port_and_reference_mempools_gossip_over_tcp():
    """A port node and a reference node, each a switch with a mempool
    reactor: a tx admitted on either side reaches the other's pool."""
    pmp = CListMempool(AppConns(KVStoreApp()))
    rmp = RCListMempool(RAppConns(RKVStoreApp()))
    nk, rnk = P2P.NodeKey.generate(), RP2P.NodeKey.generate()
    tr = P2P.Transport(nk, P2P.NodeInfo(node_id=nk.node_id(), network=CHAIN, moniker="port"))
    rtr = RP2P.Transport(rnk, RP2P.NodeInfo(node_id=rnk.node_id(), network=CHAIN, moniker="ref"))
    sw, rsw = P2P.Switch(tr), RP2P.Switch(rtr)
    for s, r in ((sw, MR.MempoolReactor(pmp)), (rsw, RMR.MempoolReactor(rmp))):
        r.set_switch(s)
        s.add_reactor(r)
    tr.listen()
    rtr.listen()
    sw.start()
    rsw.start()
    try:
        host, port = rtr.node_info.listen_addr.split(":")
        sw.dial_peer(host, int(port))
        assert _wait(lambda: rsw.peers() and sw.peers())
        pmp.check_tx(b"from=port")
        rmp.check_tx(b"from=ref")
        assert _wait(lambda: rmp.size() == 2 and pmp.size() == 2)
        assert sorted(pmp.reap_max_txs(-1)) == sorted(rmp.reap_max_txs(-1))
    finally:
        sw.stop()
        rsw.stop()
        pmp.close()
        rmp.close()


# ---- the evidence reactor

def _evidence(t, priv_cls, ev_mod, vs_codec, st_mod, pool_cls):
    """A pool whose state store holds a 4-validator set at height 2, and
    the DuplicateVoteEvidence of validator 0's two prevotes there."""
    privs = [priv_cls(bytes([i + 7]) * 32) for i in range(4)]
    vals = t.ValidatorSet([t.Validator.from_pub_key(p.pub_key(), 10) for p in privs])
    ss = st_mod.StateStore(st_mod.MemKV())
    ss._db.set(b"SV:" + (2).to_bytes(8, "big"), vs_codec.encode_validator_set(vals))
    val = vals.validators[0]
    priv = next(p for p in privs if p.pub_key().address() == val.address)
    votes = []
    for tag in (0xAA, 0xBB):
        v = t.Vote(type=t.SignedMsgType.PREVOTE, height=2, round=0, block_id=t.BlockID(
            hash=bytes([tag]) * 32, part_set_header=t.PartSetHeader(1, bytes([tag]) * 32)),
            timestamp=t.Timestamp(1_700_000_000, 0), validator_address=val.address,
            validator_index=0)
        v.signature = priv.sign(v.sign_bytes(CHAIN))
        votes.append(v)
    ev = ev_mod.DuplicateVoteEvidence.from_votes(votes[0], votes[1], 10, 40,
                                                 t.Timestamp(1_700_000_000, 0))
    return pool_cls(state_store=ss, chain_id=CHAIN), ev


def _pools():
    return (_evidence(T, Ed25519PrivKey, EV, STT, ST, EvidencePool),
            _evidence(RT, RPriv, REV, RSTT, RST, REvidencePool))


def test_evidence_reactor_admits_valid_evidence_and_drops_the_rest():
    """Inbound evidence goes through the pool's verification: a valid
    DuplicateVoteEvidence is pending in both packages (the same bytes), a
    forged or malformed one is dropped, and the sender is never sent back
    what it sent."""
    (pool, ev), (rpool, rev) = _pools()
    assert ev.wrapped() == rev.wrapped()
    forged = EV.decode_evidence(ev.wrapped())
    forged.vote_b.signature = bytes(64)
    pending = []
    for reactor_mod, p in ((ER, pool), (RER, rpool)):
        r = reactor_mod.EvidenceReactor(p)
        peer = FakePeer(0)
        r.add_peer(peer)
        for raw in (b"\x01\x02garbage", forged.wrapped(), ev.wrapped()):
            r.receive(ER.EVIDENCE_CHANNEL, peer, raw)
        pending.append([e.hash() for e in p.pending_evidence()])
        assert r._sent[peer.id] == {ev.hash()}
    assert pending[0] == pending[1] == [ev.hash()]


def test_evidence_broadcast_reaches_each_peer_once():
    (pool, ev), _ = _pools()
    pool.add_evidence(ev)
    r = ER.EvidenceReactor(pool)
    peers = [FakePeer(i) for i in range(3)]
    for p in peers:
        r.add_peer(p)
    r.set_switch(FakeSwitch(peers))
    try:
        assert _wait(lambda: all(p.got for p in peers), 5)
        time.sleep(3 * ER.BROADCAST_INTERVAL_S)
        assert [p.frames for p in peers] == [[ev.wrapped()]] * 3
    finally:
        r.stop()


def test_evidence_decoder_matches_the_reference_on_the_fuzz_corpus():
    (_, ev), _ = _pools()
    assert same_decoding(EV.decode_evidence, REV.decode_evidence, [ev.wrapped()]) > 300


# ---- over TCP

def test_equivocation_gossips_and_commits_over_tcp(tmp_path):
    """tests/test_evidence_reactor.py:45 with switches wired by hand: two
    conflicting prevotes of validator 1 sent to node 0's consensus become
    DuplicateVoteEvidence, which the evidence reactor gossips to node 1, and
    both nodes commit it, once."""
    net = chip_smoke.TcpNet(2, tmp_path, exec_kws=[{"device": "cpu"}] * 2, seed=21)
    res = chip_smoke.run_tcp_net(net, [], 2, 60.0, evidence_from=(0, 1))
    ev = res["duplicate_vote"]
    assert not res["stopped"]
    heights = [[h for h, _ in e] for e in res["evidence"]]
    assert len(heights[0]) == 1 and heights[0] == heights[1]
    assert {e[0][1] for e in res["evidence"]} == {ev.hash().hex()}
