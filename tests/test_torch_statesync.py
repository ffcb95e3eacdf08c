"""The port's state sync, pruner and rollback against the JAX package's
(`cometbft_tpu/statesync/`, `cometbft_tpu/state/{pruner,rollback}.py`):
all of tests/test_statesync.py on the port (the chunk queue, the pool's
ranking, the restore, corrupted and forged snapshots, the wire messages,
the flow over p2p, the pruner, rollback), each outcome held against the
reference's on the same chain, the wire decoder on a fuzz corpus
(tests/test_fuzz_wire.py), a liar's snapshot refused with the
reference's error, a port node restoring from a reference source over
TCP, and the one divergence: the port's restored state keeps every
validator set's proposer."""

import dataclasses
import hashlib
import inspect
import time

import pytest

pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from cometbft_tpu.abci.client import AppConns as RAppConns  # noqa: E402
from cometbft_tpu.abci.kvstore import KVStoreApp as RKVStoreApp  # noqa: E402
from cometbft_tpu import light as RL  # noqa: E402
from cometbft_tpu import p2p as RP2P  # noqa: E402
from cometbft_tpu import statesync as RSS  # noqa: E402
from cometbft_tpu.state import execution as RX  # noqa: E402
from cometbft_tpu.state import pruner as RPR  # noqa: E402
from cometbft_tpu.state import rollback as RRB  # noqa: E402
from cometbft_tpu.statesync import messages as RM  # noqa: E402
from cometbft_tpu.statesync import reactor as RSR  # noqa: E402
from cometbft_tpu.statesync.snapshots import Snapshot as RSnapshot  # noqa: E402
from cometbft_tpu import storage as RST  # noqa: E402
from cometbft_tpu.types import Timestamp as RTimestamp  # noqa: E402
from cometbft_tpu.types.block import block_id_for as r_block_id_for  # noqa: E402
from cometbft_tpu.utils.factories import make_chain  # noqa: E402
from cometbft_tpu_torch import light as L  # noqa: E402
from cometbft_tpu_torch import p2p as P2P  # noqa: E402
from cometbft_tpu_torch import statesync as SS  # noqa: E402
from cometbft_tpu_torch.abci import AppConns, KVStoreApp  # noqa: E402
from cometbft_tpu_torch.state import pruner as PR  # noqa: E402
from cometbft_tpu_torch.state import rollback as RB  # noqa: E402
from cometbft_tpu_torch.state.types import State  # noqa: E402
from cometbft_tpu_torch.statesync import messages as M  # noqa: E402
from cometbft_tpu_torch.statesync import reactor as SR  # noqa: E402
from cometbft_tpu_torch.statesync.snapshots import Snapshot  # noqa: E402
from cometbft_tpu_torch.storage import BlockStore, MemKV, StateStore  # noqa: E402
from cometbft_tpu_torch.types import Timestamp  # noqa: E402
from cometbft_tpu_torch.utils import log as LOG  # noqa: E402
from test_torch_pex import same_decoding  # noqa: E402

CHAIN = "ss-chain"
NOW_NS = 1_700_000_200_000_000_000
TOP = 10
DEADLINE_S = 30.0


@pytest.fixture(autouse=True)
def quiet_logs():
    sink = LOG._config.sink
    LOG.set_sink(lambda level, msg, fields: None)
    yield
    LOG.set_sink(sink)


def _ref_replay(store, genesis, top, app):
    """The reference's executor over blocks 1..top into `app`, every state
    saved in a reference StateStore from genesis on."""
    ss = RST.StateStore(RST.MemKV())
    ex = RX.BlockExecutor(RAppConns(app), state_store=ss, backend="cpu")
    state = genesis.copy()
    ss.save(state)
    for h in range(1, top + 1):
        blk = store.load_block(h)
        state = ex.apply_block(state, r_block_id_for(blk), blk)
    return ss, state


@pytest.fixture(scope="module")
def world():
    """The reference's 10-block, 4-validator chain; each package's source
    app (a snapshot every 4 heights, 64-byte chunks) and StateStore from a
    replay of it; the port's blocks crossed as KV items."""
    ref_store, _, ref_genesis, _ = make_chain(TOP, n_validators=4, chain_id=CHAIN,
                                               backend="cpu")
    items = sorted(ref_store._db.iterate_prefix(b""))
    genesis = State.decode(ref_genesis.encode())
    rapp = RKVStoreApp(snapshot_interval=4, chunk_size=64)
    rss, rstate = _ref_replay(ref_store, ref_genesis, TOP, rapp)
    app = KVStoreApp(snapshot_interval=4, chunk_size=64)
    store = _port_store(items)
    ss = StateStore(MemKV())
    state = chip_smoke.host_state(store, genesis, TOP, app=app, state_store=ss)
    assert state.encode() == rstate.encode()
    return {"items": items, "genesis": genesis, "app": app, "ss": ss, "state": state,
            "store": store, "ref_store": ref_store, "ref_genesis": ref_genesis, "rapp": rapp,
            "rss": rss, "rstate": rstate}


def _port_store(items):
    kv = MemKV()
    kv.write_batch(items)
    return BlockStore(kv)


def _light_client(world):
    provider = L.StoreProvider(CHAIN, world["store"], world["ss"])
    lc = L.LightClient(CHAIN, provider, device="cpu", trusting_period_s=10**9)
    lc.initialize(1, provider.light_block(1).signed_header.header.hash())
    return lc


def _ref_light_client(world):
    provider = RL.StoreProvider(CHAIN, world["ref_store"], world["rss"])
    lc = RL.LightClient(CHAIN, provider, backend="cpu", trusting_period_s=10**9)
    lc.initialize(1, provider.light_block(1).signed_header.header.hash())
    return lc


def _syncer(world, fetch=None, target=None):
    sp = SS.LightStateProvider(_light_client(world), CHAIN, now=Timestamp.from_unix_ns(NOW_NS))
    target = target or KVStoreApp()
    app = world["app"]

    def local_fetch(snapshot, index):
        return app.load_snapshot_chunk(snapshot.height, snapshot.format, index)

    return SS.Syncer(AppConns(target).snapshot, sp, fetch or local_fetch, chunk_timeout=2.0), target


def _ref_syncer(world, fetch=None):
    sp = RSS.LightStateProvider(_ref_light_client(world), CHAIN,
                                now=RTimestamp.from_unix_ns(NOW_NS))
    target = RKVStoreApp()
    app = world["rapp"]

    def local_fetch(snapshot, index):
        return app.load_snapshot_chunk(snapshot.height, snapshot.format, index)

    return RSS.Syncer(RAppConns(target).snapshot, sp, fetch or local_fetch,
                      chunk_timeout=2.0), target


def _offer_all(syncer, app, snap_cls, peer="peer1"):
    for s in app.list_snapshots():
        syncer.add_snapshot(snap_cls(s.height, s.format, s.chunks, s.hash, s.metadata), peer)


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — the class and message are the outcome
        return (type(e).__name__, str(e))


# ---- the chunk queue and the snapshot pool

@pytest.mark.parametrize("ss_mod", [SS, RSS], ids=["port", "reference"])
def test_chunk_queue_order_and_retry(tmp_path, ss_mod):
    snap = (Snapshot if ss_mod is SS else RSnapshot)(height=4, format=1, chunks=3,
                                                      hash=b"h" * 32)
    q = ss_mod.ChunkQueue(snap, str(tmp_path))
    assert q.allocate() == 0 and q.allocate() == 1 and q.allocate() == 2
    assert q.allocate() is None
    assert q.add(1, b"one", "p1")
    assert q.next(timeout=0.05) is None
    assert q.add(0, b"zero", "p0")
    assert q.next(timeout=1)[:2] == (0, b"zero")
    assert q.next(timeout=1)[:2] == (1, b"one")
    q.retry(1)
    assert q.allocate() == 1
    assert q.add(1, b"one!", "p2")
    assert q.next(timeout=1) == (1, b"one!", "p2")
    assert q.add(2, b"two", "p1") and q.next(timeout=1)[:2] == (2, b"two")
    assert q.done() and not q.add(2, b"again", "p3")
    q.discard(2)
    q.close()
    with pytest.raises(ss_mod.chunks.ErrQueueClosed):
        q.allocate()


@pytest.mark.parametrize("ss_mod, snap_cls", [(SS, Snapshot), (RSS, RSnapshot)],
                         ids=["port", "reference"])
def test_snapshot_pool_ranking_and_rejection(ss_mod, snap_cls):
    pool = ss_mod.SnapshotPool()
    s4 = snap_cls(height=4, format=1, chunks=1, hash=b"a" * 32)
    s8 = snap_cls(height=8, format=1, chunks=1, hash=b"b" * 32)
    s8f2 = snap_cls(height=8, format=2, chunks=1, hash=b"c" * 32)
    assert pool.add(s4, "p1") and pool.add(s8, "p1")
    assert not pool.add(s8, "p2")
    assert pool.peers(s8) == ["p1", "p2"]
    assert pool.add(s8f2, "p3") and pool.best().format == 2
    pool.reject_peer("p3")
    assert pool.best() == s8 and not pool.add(s8f2, "p3")
    pool.reject(s8)
    assert pool.best().height == 4 and not pool.add(s8, "p3")
    pool.reject_format(1)
    assert pool.best() is None


# ---- the restore

def test_statesync_restores_app_as_the_reference_does(world):
    syncer, target = _syncer(world)
    rsyncer, rtarget = _ref_syncer(world)
    assert [s.height for s in world["app"].list_snapshots()] == [4, 8]
    _offer_all(syncer, world["app"], Snapshot)
    _offer_all(rsyncer, world["rapp"], RSnapshot)
    state, commit = syncer.sync_any()
    rstate, rcommit = rsyncer.sync_any()
    assert state.last_block_height == commit.height == target.height == 8
    assert target.app_hash == state.app_hash == rtarget.app_hash == rstate.app_hash
    assert target._serialize_state() == rtarget._serialize_state()
    assert commit.encode() == rcommit.encode() and syncer.rejected == []
    for f in ("last_block_id", "last_results_hash", "last_height_validators_changed",
              "last_height_params_changed", "last_block_time"):
        assert repr(getattr(state, f)) == repr(getattr(rstate, f)), f
    for f in ("validators", "last_validators", "next_validators"):
        assert getattr(state, f).hash() == getattr(rstate, f).hash()


def test_restored_state_keeps_the_proposers_unlike_the_reference(world):
    """Equal powers tie the priorities at height 8, so the proposer a set
    carries is not the one its priorities name. The port's restored state
    at 8 equals the replay's (but for the heights of the last validator and
    params change a restore sets); the reference's loses last_validators'
    proposer in its light store."""
    syncer, _ = _syncer(world)
    rsyncer, _ = _ref_syncer(world)
    _offer_all(syncer, world["app"], Snapshot)
    _offer_all(rsyncer, world["rapp"], RSnapshot)
    state, _ = syncer.sync_any()
    rstate, _ = rsyncer.sync_any()
    want = chip_smoke.host_state(world["store"], world["genesis"], 8)
    rwant = _ref_replay(world["ref_store"], world["ref_genesis"], 8, RKVStoreApp())[1]
    assert want.encode() == rwant.encode()
    heights = {"last_height_validators_changed": want.last_height_validators_changed,
               "last_height_params_changed": want.last_height_params_changed}
    assert dataclasses.replace(state, **heights).encode() == want.encode()
    assert dataclasses.replace(rstate, **heights).encode() != rwant.encode()
    assert rstate.last_validators.get_proposer().address != \
        rwant.last_validators.get_proposer().address


def test_statesync_rejects_corrupted_snapshot_as_the_reference_does(world):
    def lying(app):
        def fetch(snapshot, index):
            good = app.load_snapshot_chunk(snapshot.height, snapshot.format, index)
            return b"\x00" * len(good) if index == 0 else good
        return fetch

    got = []
    for make, app, snap_cls in ((_syncer, world["app"], Snapshot),
                                (_ref_syncer, world["rapp"], RSnapshot)):
        syncer, _ = make(world, fetch=lying(app))
        s = app.list_snapshots()[-1]
        syncer.add_snapshot(snap_cls(s.height, s.format, s.chunks, s.hash, s.metadata), "liar")
        got.append(_outcome(lambda: syncer.sync_any(max_attempts=1)))
    assert got[0] == got[1] and got[0][0] in ("ErrNoSnapshots", "ErrRejectSnapshot")


def _forged_payload(app_cls, height):
    fake = app_cls()
    fake.store = {b"evil": b"data"}
    fake.height = height
    return fake._serialize_state()


def test_statesync_rejects_forged_snapshot_hash_as_the_reference_does(world):
    """A snapshot whose content hash checks out but whose state refutes the
    light client's app hash is refused, and the target keeps no part of it."""
    got = []
    for make, app_cls, snap_cls in ((_syncer, KVStoreApp, Snapshot),
                                    (_ref_syncer, RKVStoreApp, RSnapshot)):
        payload = _forged_payload(app_cls, 8)
        syncer, target = make(world, fetch=lambda snapshot, index, p=payload: p)
        syncer.add_snapshot(snap_cls(8, 1, 1, hashlib.sha256(payload).digest()), "forger")
        got.append(_outcome(lambda: syncer.sync_any(max_attempts=1)))
        assert target.store.get(b"evil") is None and target.height == 0
    assert got[0] == got[1] and got[0][0] in ("ErrNoSnapshots", "ErrRejectSnapshot")


def test_liar_snapshot_refused_with_the_references_error_then_honest_restored(world):
    """A liar's snapshot of another state, offered first at the honest
    best height (8), is tried first and refused with
    chip_smoke.SS_LIAR_ERROR, as the reference refuses it; the honest 8 is
    restored after it."""
    rejected = []
    for make, app_cls, app, snap_cls in ((_syncer, KVStoreApp, world["app"], Snapshot),
                                         (_ref_syncer, RKVStoreApp, world["rapp"], RSnapshot)):
        payload = _forged_payload(app_cls, 8)
        liar_hash = hashlib.sha256(payload).digest()

        def fetch(snapshot, index, app=app, payload=payload, liar_hash=liar_hash):
            if snapshot.hash == liar_hash:
                return payload
            return app.load_snapshot_chunk(snapshot.height, snapshot.format, index)

        syncer, target = make(world, fetch=fetch)
        rejected.append([])
        log_reject = getattr(syncer, "_log_reject", None)
        if log_reject is not None:  # the reference logs its rejections
            syncer._log_reject = lambda s, reason, out=rejected[-1]: out.append(
                (s.height, reason))
        syncer.add_snapshot(snap_cls(8, 1, 1, liar_hash), "liar")
        _offer_all(syncer, app, snap_cls)
        state, _ = syncer.sync_any()
        assert state.last_block_height == target.height == 8
        if log_reject is None:
            rejected[-1] = [(s.height, str(e)) for s, e in syncer.rejected]
            assert [(s.hash, type(e).__name__) for s, e in syncer.rejected] == [
                (liar_hash, chip_smoke.SS_LIAR_ERROR[0])]
    assert rejected[0] == rejected[1] == [(8, chip_smoke.SS_LIAR_ERROR[1])]


# ---- the wire

def _wire(m):
    return [m.SnapshotsRequest(),
            m.SnapshotsResponse(height=9, format=1, chunks=3, hash=b"h" * 32, metadata=b"m"),
            m.ChunkRequest(height=9, format=1, index=2),
            m.ChunkResponse(height=9, format=1, index=2, chunk=b"data"),
            m.ChunkResponse(height=9, format=1, index=7, missing=True),
            m.LightBlockRequest(height=5),
            m.LightBlockResponse(height=5, signed_header=b"sh", validator_set=b"vs"),
            m.LightBlockResponse(height=6)]


def test_statesync_wire_messages_roundtrip_with_the_reference_bytes():
    assert [x.encode() for x in _wire(M)] == [x.encode() for x in _wire(RM)]
    for msg in _wire(M):
        assert M.decode_message(msg.encode()) == msg
    assert (M.SNAPSHOT_CHANNEL, M.CHUNK_CHANNEL, M.LIGHT_BLOCK_CHANNEL) == (
        RM.SNAPSHOT_CHANNEL, RM.CHUNK_CHANNEL, RM.LIGHT_BLOCK_CHANNEL)


def test_statesync_decoder_matches_the_reference_on_the_fuzz_corpus():
    seeds = [x.encode() for x in _wire(M)]
    assert same_decoding(M.decode_message, RM.decode_message, seeds, n=120) > 900


# ---- over p2p

def _switch(reactors, p2p=P2P, moniker="t"):
    nk = p2p.NodeKey.generate()
    tr = p2p.Transport(nk, p2p.NodeInfo(node_id=nk.node_id(), network=CHAIN, moniker=moniker))
    sw = p2p.Switch(tr)
    for r in reactors:
        sw.add_reactor(r)
    tr.listen()
    sw.start()
    return sw, tr


def _wait(cond, timeout_s=DEADLINE_S):
    deadline = time.monotonic() + timeout_s
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.02)
    return cond()


@pytest.mark.parametrize("source", ["port", "reference"])
def test_statesync_over_p2p(world, source):
    """A serving node advertises snapshots, serves chunks and light blocks
    over TCP; a syncing port node discovers them, anchors a
    LightClient(device="cpu") through P2PLightProvider on block 1's hash
    and restores. The serving node is the port's or the reference's."""
    if source == "port":
        serving = SR.StateSyncReactor(AppConns(world["app"]).snapshot, None,
                                      block_store=world["store"], state_store=world["ss"])
        sw1, t1 = _switch([serving])
    else:
        serving = RSR.StateSyncReactor(RAppConns(world["rapp"]).snapshot, None,
                                       block_store=world["ref_store"], state_store=world["rss"])
        sw1, t1 = _switch([serving], RP2P)
    pool = SS.SnapshotPool()
    target = KVStoreApp()
    syncing = SR.StateSyncReactor(AppConns(target).snapshot, pool)
    sw2, _ = _switch([syncing])
    try:
        host, port = t1.node_info.listen_addr.split(":")
        sw2.dial_peer(host, int(port))
        assert _wait(lambda: pool.best() is not None and pool.best().height == 8)
        lc = L.LightClient(CHAIN, SR.P2PLightProvider(syncing, CHAIN), device="cpu",
                           trusting_period_s=10**9)
        lc.initialize(1, world["store"].load_block(1).header.hash())
        sp = SS.LightStateProvider(lc, CHAIN, now=Timestamp.from_unix_ns(NOW_NS))
        syncer = SS.Syncer(AppConns(target).snapshot, sp, syncing.fetch_chunk, pool=pool,
                           chunk_timeout=5.0)
        state, commit = syncer.sync_any()
        assert state.last_block_height == target.height == 8 and commit.height == 8
        assert target.app_hash == state.app_hash == world["store"].load_block(9).header.app_hash
        assert SR.P2PLightProvider(syncing, CHAIN).light_block(99) is None
    finally:
        sw1.stop()
        sw2.stop()


def test_light_block_served_is_the_stores(world):
    """The serving reactor's light block is the StoreProvider's, in the
    reference's bytes."""
    r = SR.StateSyncReactor(None, None, block_store=world["store"], state_store=world["ss"])
    rr = RSR.StateSyncReactor(None, None, block_store=world["ref_store"], state_store=world["rss"])
    for h in (1, 5, TOP, TOP + 1):
        assert r._serve_light_block(h) == rr._serve_light_block(h)
    lb = SR.StateSyncReactor._decode_light_block(M.decode_message(r._serve_light_block(5)))
    assert lb.signed_header.header.hash() == world["store"].load_block(5).header.hash()


# ---- the pruner and rollback

def test_pruner_effective_height_and_prune_as_the_reference_does(world):
    got = []
    for pr_mod, store, ss in ((PR, _port_store(world["items"]), StateStore(MemKV())),
                              (RPR, _ref_copy(world), RST.StateStore(RST.MemKV()))):
        pr = pr_mod.Pruner(store, ss, companion_enabled=True)
        pr.set_app_retain_height(6)
        assert pr.effective_retain_height() == 0
        pr.set_companion_block_retain_height(4)
        assert pr.effective_retain_height() == 4
        blocks, states = pr.prune_once()
        pr.set_app_retain_height(2)
        with pytest.raises(ValueError):
            pr.set_companion_block_results_retain_height(0)
        got.append((blocks, states, store.base(), store.load_block(3) is None,
                    store.load_block(4) is not None, pr.app_retain_height()))
    assert got[0] == got[1] == (3, 0, 4, True, True, 6)


def test_pruner_service_prunes_on_wake(world):
    store = _port_store(world["items"])
    pr = PR.Pruner(store, StateStore(MemKV()), interval_s=60.0)
    pr.start()
    try:
        pr.set_app_retain_height(5)
        assert _wait(lambda: store.base() == 5, 10)
    finally:
        pr.stop()


def _ref_copy(world):
    kv = RST.MemKV()
    kv.write_batch(world["items"])
    return RST.BlockStore(kv)


def test_rollback_one_height_as_the_reference_does(world):
    got = []
    for rb_mod, store, ss in (
            (RB, _port_store(world["items"]), None), (RRB, _ref_copy(world), None)):
        if rb_mod is RB:
            ss = StateStore(MemKV())
            chip_smoke.host_state(store, world["genesis"], TOP, state_store=ss)
        else:
            ss = _ref_replay(store, world["ref_genesis"], TOP, RKVStoreApp())[0]
        height, app_hash = rb_mod.rollback(store, ss, remove_block=True)
        got.append((height, app_hash, ss.load().encode(), store.height(),
                    store.load_block(TOP) is None))
    assert got[0] == got[1]
    assert got[0][0] == TOP - 1 and got[0][3] == TOP - 1 and got[0][4]
    assert got[0][1] == _port_store(world["items"]).load_block(TOP).header.app_hash


def test_rollback_refusals_match_the_reference(world):
    for rb_mod, store, ss_cls in ((RB, _port_store(world["items"]), StateStore),
                                  (RRB, _ref_copy(world), RST.StateStore)):
        empty = ss_cls(MemKV() if rb_mod is RB else RST.MemKV())
        with pytest.raises(rb_mod.RollbackError, match="no state found"):
            rb_mod.rollback(store, empty)


def test_p2p_light_provider_gets_none_from_a_silent_peer(monkeypatch):
    """A peer that never answers: the reactor's request returns None after
    its wait; the provider asks with the reactor's own wait, the
    reference's fixed 10 s, as the reference's provider does."""

    class Silent:
        id = "silent"

        def send(self, chan, raw):
            self.asked = (chan, raw)
            return True

    r = SR.StateSyncReactor(None, None)
    peer = Silent()
    r.add_peer(peer)
    t0 = time.monotonic()
    assert r.fetch_light_block(3, timeout=0.05) is None
    assert time.monotonic() - t0 < 2 and peer.asked == (
        M.LIGHT_BLOCK_CHANNEL, M.LightBlockRequest(height=3).encode())
    waits = [inspect.signature(m.StateSyncReactor.fetch_light_block).parameters["timeout"].default
             for m in (SR, RSR)]
    assert waits == [10.0, 10.0]
    asked = []
    monkeypatch.setattr(r, "fetch_light_block", lambda *a, **kw: asked.append((a, kw)))
    assert SR.P2PLightProvider(r, CHAIN).light_block(3) is None and asked == [((3,), {})]
    assert SR.P2PLightProvider(r, CHAIN).chain_id() == CHAIN
