"""Block sync over p2p (`cometbft_tpu_torch/blocksync/{pool,reactor}.py`)
against the reference's, on the CPU.

The chain is the reference fixture's (`make_chain(25, n_validators=4)`,
tests/test_blocksync_p2p.py), made once by the reference and crossed to
the port as KV items. The oracle is a reference node syncing from a
reference node: its store's KV items and its state's bytes. Every other
pairing of port and reference nodes, serving and syncing, must reach the
same bytes.
"""

import signal
import time

import pytest

pytest.importorskip("torch")

from cometbft_tpu.abci.client import AppConns as JAppConns  # noqa: E402
from cometbft_tpu.abci.kvstore import KVStoreApp as JKVStoreApp  # noqa: E402
from cometbft_tpu.blocksync.pool import BlockPool as JBlockPool  # noqa: E402
from cometbft_tpu.blocksync.reactor import BlockSyncReactor as JReactor  # noqa: E402
from cometbft_tpu import p2p as JP  # noqa: E402
from cometbft_tpu.state.execution import BlockExecutor as JBlockExecutor  # noqa: E402
from cometbft_tpu.storage import BlockStore as JBlockStore, MemKV as JMemKV  # noqa: E402
from cometbft_tpu.utils import metrics as JMetrics  # noqa: E402
from cometbft_tpu.utils.factories import make_chain as j_make_chain  # noqa: E402
from cometbft_tpu_torch import p2p as P  # noqa: E402
from cometbft_tpu_torch.abci import AppConns, KVStoreApp  # noqa: E402
from cometbft_tpu_torch.blocksync.pool import BlockPool  # noqa: E402
from cometbft_tpu_torch.blocksync.reactor import BlockSyncReactor  # noqa: E402
from cometbft_tpu_torch.state.execution import BlockExecutor  # noqa: E402
from cometbft_tpu_torch.state.types import State  # noqa: E402
from cometbft_tpu_torch.storage import BlockStore, MemKV  # noqa: E402
from cometbft_tpu_torch.types import Commit, CommitSig  # noqa: E402
from cometbft_tpu_torch.types.validation import CommitError  # noqa: E402
from cometbft_tpu_torch.utils import metrics  # noqa: E402

CHAIN = "bsync-chain"


@pytest.fixture(autouse=True)
def alarm():
    signal.signal(signal.SIGALRM, lambda *a: (_ for _ in ()).throw(TimeoutError("60 s")))
    signal.alarm(60)
    yield
    signal.alarm(0)


class _B:
    """A block stand-in: only its height."""

    def __init__(self, h):
        self.header = type("H", (), {"height": h})()


def test_pool_scheduling_and_redo_follow_the_reference():
    """The reference test's sequence, on both pools side by side."""
    sent, jsent = [], []
    pool = BlockPool(5, lambda p, h: sent.append((p, h)))
    jpool = JBlockPool(5, lambda p, h: jsent.append((p, h)))
    for pl in (pool, jpool):
        pl.set_peer_range("p1", 1, 30)
        pl.set_peer_range("p2", 1, 30)
        pl.make_requests()
    assert sent == jsent and sorted(h for _, h in sent)[0] == 5 and len(sent) == 26
    by_height = {h: p for p, h in sent}
    for pl in (pool, jpool):
        assert not pl.is_caught_up()
        assert pl.add_block(by_height[5], _B(5))
        assert not pl.add_block("intruder", _B(6))  # unsolicited
        assert pl.add_block(by_height[6], _B(6))
        first, second = pl.peek_two_blocks()
        assert (first.header.height, second.header.height) == (5, 6)
        pl.pop_request()
        assert pl.height == 6
        assert pl.redo_request(6) == by_height[6]
        assert pl.peek_two_blocks()[0] is None
        sent.clear()
        pl.make_requests()
    assert pool.max_peer_height() == jpool.max_peer_height() == 30


def test_redo_evicts_nobody_and_a_ban_is_for_the_proven_sender_unlike_the_reference():
    """Block H from an honest peer, H+1 (whose LastCommit failed the check)
    from a liar: the reference's redo evicts H's sender, the honest one,
    and keeps the liar; the port's redo evicts nobody, and the ban the
    reactor then puts on the liar drops its blocks and ignores its next
    status, while the honest peer stays."""
    for cls in (BlockPool, JBlockPool):
        sent = []
        pl = cls(5, lambda p, h: sent.append((p, h)))
        pl.set_peer_range("honest", 1, 10)
        pl.set_peer_range("liar", 1, 10)
        pl.make_requests()
        by_height = {h: p for p, h in sent}
        honest, liar = by_height[5], by_height[6]
        assert honest != liar
        assert pl.add_block(honest, _B(5)) and pl.add_block(liar, _B(6))
        if cls is BlockPool:
            assert pl.senders(5) == (honest, liar)
        assert pl.redo_request(5) == honest
        assert pl.peek_two_blocks() == (None, None)
        if cls is BlockPool:
            assert pl.add_block(liar, _B(8))
            pl.ban(liar)
            pl.set_peer_range(liar, 1, 10)  # its next status response
            assert pl.banned == {liar} and pl._peers.keys() == {honest}
            assert all(r.peer_id != liar and (r.block is None or r.height != 8)
                       for r in pl._requesters.values())
            sent.clear()
            pl.make_requests()
            assert {p for p, _ in sent} == {honest} and {5, 6, 8} <= {h for _, h in sent}
        else:
            pl.set_peer_range(liar, 1, 10)
            assert pl._peers.keys() == {liar}  # the honest sender evicted, the liar kept


@pytest.fixture(scope="module")
def chain():
    """The reference fixture's chain, and the oracle: a reference node synced
    from a reference node (its store's KV items and state bytes)."""
    store, _, genesis, _ = j_make_chain(25, n_validators=4, chain_id=CHAIN, backend="cpu",
                                        txs_per_block=1)
    fresh = JBlockStore(JMemKV())
    syncer = JReactor(fresh, executor=JBlockExecutor(JAppConns(JKVStoreApp()), backend="cpu"),
                      state=genesis.copy(), backend="cpu")
    state = sync_pair(JReactor(store), syncer, "reference", "reference")
    return store, genesis, (kv_items(fresh), state.encode())


def kv_items(store) -> list:
    return sorted(store._db.iterate_prefix(b""))


def port_store(ref_store) -> BlockStore:
    kv = MemKV()
    kv.write_batch(kv_items(ref_store))
    return BlockStore(kv)


PACKAGES = {"port": P, "reference": JP}


def switch(reactor, pkg, name):
    mod = PACKAGES[pkg]
    nk = mod.NodeKey.generate()
    tr = mod.Transport(nk, mod.NodeInfo(node_id=nk.node_id(), network=CHAIN, moniker=name))
    sw = mod.Switch(tr)
    sw.add_reactor(reactor)
    tr.listen()
    sw.start()
    return sw, tr


def sync_pair(serving, syncing, serve_pkg, sync_pkg, timeout_s=30, peers_after=None):
    """Connect a serving and a syncing node over TCP on 127.0.0.1 (the
    syncing one dials) and run one sync; returns its state (and puts the
    syncing switch's peer ids after it into `peers_after`)."""
    sw1, t1 = switch(serving, serve_pkg, "server")
    sw2, _ = switch(syncing, sync_pkg, "syncer")
    try:
        host, port = t1.node_info.listen_addr.split(":")
        sw2.dial_peer(host, int(port))
        deadline = time.monotonic() + 5
        while not syncing._peers and time.monotonic() < deadline:
            time.sleep(0.02)
        state = syncing.sync(timeout_s=timeout_s)
        if peers_after is not None:
            peers_after.extend(p.id for p in sw2.peers())
        return state
    finally:
        sw1.stop()
        sw2.stop()


@pytest.mark.parametrize("serve_pkg,sync_pkg", [("port", "port"), ("reference", "port"),
                                                ("port", "reference")])
def test_sync_reaches_the_reference_syncing_node_bytes(chain, serve_pkg, sync_pkg):
    ref_store, ref_genesis, (want_items, want_state) = chain
    if serve_pkg == "port":
        serving = BlockSyncReactor(port_store(ref_store))
    else:
        serving = JReactor(ref_store)
    if sync_pkg == "port":
        fresh = BlockStore(MemKV())
        syncing = BlockSyncReactor(fresh, executor=BlockExecutor(AppConns(KVStoreApp()), device="cpu"),
                                   state=State.decode(ref_genesis.encode()), device="cpu")
    else:
        fresh = JBlockStore(JMemKV())
        syncing = JReactor(fresh, executor=JBlockExecutor(JAppConns(JKVStoreApp()), backend="cpu"),
                           state=ref_genesis.copy(), backend="cpu")
    before = metrics.blocksync_metrics().blocks_applied_total.values().get((), 0.0)
    state = sync_pair(serving, syncing, serve_pkg, sync_pkg)
    assert state.last_block_height == 24 and fresh.height() == 24
    assert kv_items(fresh) == want_items
    assert state.encode() == want_state
    if sync_pkg == "port":
        m = metrics.blocksync_metrics()
        assert m.blocks_applied_total.values()[()] - before == 24
        assert m.latest_block_height.values()[()] == 24 and m.syncing.values()[()] == 0
        assert not syncing.refused and not syncing.banned


def test_forged_block_is_refused(chain):
    """The reference test's liar (block 3's txs changed): its sender is
    banned and disconnected, the forgery never applied nor stored, the
    refusal a CommitError."""
    ref_store, ref_genesis, _ = chain
    inner = port_store(ref_store)

    class LyingStore:
        def height(self):
            return inner.height()

        def base(self):
            return inner.base()

        def load_block(self, h):
            blk = inner.load_block(h)
            if blk is not None and h == 3:
                blk.data.txs = [b"forged=tx"]  # breaks data_hash / the block id
            return blk

    fresh = BlockStore(MemKV())
    syncing = BlockSyncReactor(fresh, executor=BlockExecutor(AppConns(KVStoreApp()), device="cpu"),
                               state=State.decode(ref_genesis.encode()), device="cpu")
    left = []
    state = sync_pair(BlockSyncReactor(LyingStore()), syncing, "port", "port", timeout_s=6,
                      peers_after=left)
    assert state.last_block_height < 3 and fresh.load_block(3) is None
    assert metrics.blocksync_metrics().bad_blocks_total.values()[()] >= 1
    (height, peer, err), = syncing.refused[:1]
    assert height == 3 and peer in syncing.banned and isinstance(err, CommitError)
    assert left == [] and not syncing._peers  # the liar was disconnected


def test_honest_and_lying_peers_connected_together_reach_the_tip(chain):
    """An honest peer and a liar connected at once, the liar's every block
    (it holds 2..24) carrying a flipped LastCommit signature: the first
    refusal has the honest peer's block H and the liar's forged H+1. Only
    the liar is banned and disconnected; the honest peer serves the refetch
    and the sync reaches the reference syncing node's bytes."""
    ref_store, ref_genesis, (want_items, want_state) = chain
    inner = port_store(ref_store)

    class LyingStore:
        def height(self):
            return inner.height()

        def base(self):
            return 2

        def load_block(self, h):
            blk = inner.load_block(h)
            if blk is not None and h >= 2:
                c = blk.last_commit
                sigs = list(c.signatures)
                s0 = sigs[0]
                sigs[0] = CommitSig(s0.block_id_flag, s0.validator_address, s0.timestamp,
                                    bytes([s0.signature[0] ^ 1]) + s0.signature[1:])
                blk.last_commit = Commit(c.height, c.round, c.block_id, sigs)
            return blk

    fresh = BlockStore(MemKV())
    syncing = BlockSyncReactor(fresh, executor=BlockExecutor(AppConns(KVStoreApp()), device="cpu"),
                               state=State.decode(ref_genesis.encode()), device="cpu")
    servers = [switch(BlockSyncReactor(port_store(ref_store)), "port", "honest"),
               switch(BlockSyncReactor(LyingStore()), "port", "liar")]
    sw, _ = switch(syncing, "port", "syncer")
    try:
        ids = []
        for _, tr in servers:
            host, port = tr.node_info.listen_addr.split(":")
            ids.append(sw.dial_peer(host, int(port)).id)
        deadline = time.monotonic() + 5
        while len(syncing._ranges) < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        honest, liar = ids
        state = syncing.sync(timeout_s=30)
        assert state.last_block_height == 24 and kv_items(fresh) == want_items
        assert state.encode() == want_state
        (height, peer, err), = syncing.refused
        assert peer == liar and height in (1, 2) and isinstance(err, CommitError)
        assert syncing.banned == {liar} and [p.id for p in sw.peers()] == [honest]
    finally:
        for s, _ in servers:
            s.stop()
        sw.stop()


def test_cuda_without_a_gpu_raises():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        BlockSyncReactor(BlockStore(MemKV()), executor=BlockExecutor(AppConns(KVStoreApp()),
                                                                     device="cpu"),
                         state=None)
    BlockSyncReactor(BlockStore(MemKV()))  # a serving node needs no device


def test_blocksync_and_p2p_metric_names_equal_the_reference():
    for name in ("BlockSyncMetrics", "P2PMetrics"):
        port = getattr(metrics, name)(metrics.Registry())
        ref = getattr(JMetrics, name)(JMetrics.Registry())
        assert vars(port).keys() == vars(ref).keys()
        for attr, m in vars(port).items():
            r = vars(ref)[attr]
            assert (type(m).__name__, m.name, m.help, m.labels) == (
                type(r).__name__, r.name, r.help, r.labels), attr
