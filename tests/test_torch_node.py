"""The port's node slice held against the JAX package on the CPU.

- `config.py`: the TOML bytes and round trip (but `crypto_backend`, which
  takes "cuda" or "cpu"); a reference config.toml that says "tpu" is
  refused naming the value.
- `types/genesis.py`: the JSON bytes both ways; other key types refused.
- `utils/pubsub.py`: `Query` over the reference's corpus (tests/test_rpc.py).
- `storage/indexer.py`: the KV bytes and searches.
- `state/handshake.py`: the states, replay counts and errors at the app
  heights of tests/test_abci_socket.py.
- `node/node.py`: two port nodes over TCP, then a port and a reference node
  in one network, agreeing on every block and app hash; a restart on
  sqlite; "cuda" without a GPU raising before any store opens; each option
  whose part the port lacks refused by name; `cert_native` not passed on.
"""

import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cometbft_tpu import config as RC  # noqa: E402
from cometbft_tpu.abci import client as RAC  # noqa: E402
from cometbft_tpu.abci import kvstore as RKV  # noqa: E402
from cometbft_tpu.state import handshake as RH  # noqa: E402
from cometbft_tpu.state import types as RST  # noqa: E402
from cometbft_tpu.storage import indexer as RI  # noqa: E402
from cometbft_tpu.storage import kv as RKVS  # noqa: E402
from cometbft_tpu.storage import statestore as RSS  # noqa: E402
from cometbft_tpu.types import genesis as RG  # noqa: E402
from cometbft_tpu.types.basic import Timestamp as RTimestamp  # noqa: E402
from cometbft_tpu.utils import pubsub as RPS  # noqa: E402
from cometbft_tpu.utils.factories import make_chain as r_make_chain  # noqa: E402
from cometbft_tpu_torch import config as PC  # noqa: E402
from cometbft_tpu_torch.abci import client as PAC  # noqa: E402
from cometbft_tpu_torch.abci import kvstore as PKV  # noqa: E402
from cometbft_tpu_torch.node import node as PN  # noqa: E402
from cometbft_tpu_torch.state import handshake as PH  # noqa: E402
from cometbft_tpu_torch.state import types as PST  # noqa: E402
from cometbft_tpu_torch.storage import indexer as PI  # noqa: E402
from cometbft_tpu_torch.storage import kv as PKVS  # noqa: E402
from cometbft_tpu_torch.storage import statestore as PSS  # noqa: E402
from cometbft_tpu_torch.storage.blockstore import BlockStore as PBlockStore  # noqa: E402
from cometbft_tpu_torch.types import genesis as PG  # noqa: E402
from cometbft_tpu_torch.types.basic import Timestamp as PTimestamp  # noqa: E402
from cometbft_tpu_torch.types.validator_set import UnsupportedKeyType  # noqa: E402
from cometbft_tpu_torch.utils import pubsub as PPS  # noqa: E402

FAST = {"timeout_propose": 0.6, "timeout_propose_delta": 0.2, "timeout_prevote": 0.3,
        "timeout_prevote_delta": 0.1, "timeout_precommit": 0.3,
        "timeout_precommit_delta": 0.1, "timeout_commit": 0.1}  # tests/test_node.py


# ---- config

def _varied(C):
    """A Config of package C with a value changed in every section."""
    cfg = C.Config()
    cfg.base.chain_id, cfg.base.moniker = "toml-chain", 'quo"te\\back\tslash'
    cfg.base.crypto_backend = "cpu"
    cfg.rpc.max_body_bytes, cfg.p2p.persistent_peers = 12345, "127.0.0.1:1,127.0.0.1:2"
    cfg.mempool.admission_max_delay_ms, cfg.consensus.timeout_propose = 0.5, 1.25
    cfg.consensus.cert_native, cfg.blocksync.verify_mode = False, "full"
    cfg.statesync.trust_period_s, cfg.storage.full_commit_window = 99, 7
    cfg.light.cache_size, cfg.da.pc_max_rows, cfg.replication.retain_frames = 8, 9, 10
    cfg.watchtower.da_samples, cfg.sched.tenant_weight = 3, 2.5
    cfg.instrumentation.namespace = "ns"
    return cfg


def test_config_toml_is_the_references_but_the_backend(tmp_path):
    """Defaults and a config varied in every section: the port writes the
    reference's TOML byte for byte but the backend line ("cuda" by default
    where the reference says "tpu"), and reads it back equal."""
    p, r = PC.Config().to_toml(), RC.Config().to_toml()
    assert 'crypto_backend = "cuda"' in p and 'crypto_backend = "tpu"' in r
    assert p.replace('"cuda"', '"tpu"') == r
    assert _varied(PC).to_toml() == _varied(RC).to_toml()
    path = str(tmp_path / "config.toml")
    _varied(PC).save(path)
    assert PC.Config.load(path) == _varied(PC)
    assert PC.Config.from_toml(_varied(RC).to_toml()) == _varied(PC)


def test_reference_tpu_backend_is_refused_naming_the_values():
    """A reference config.toml as `init` writes it says "tpu": the port
    refuses it, naming the value and the two it takes."""
    with pytest.raises(ValueError) as e:
        PC.Config.from_toml(RC.Config().to_toml())
    assert "'tpu'" in str(e.value) and "'cuda' or 'cpu'" in str(e.value)
    with pytest.raises(ValueError, match="'tpu'"):
        cfg = PC.Config()
        cfg.base.crypto_backend = "tpu"
        cfg.validate()
    assert PC.CRYPTO_BACKENDS == ("cuda", "cpu") and PC.Config().base.crypto_backend == "cuda"


@pytest.mark.parametrize("shards, ok", [((16, 16), True), ((4000, 96), True), ((4000, 97), False)])
def test_da_shard_bound_is_the_references(shards, ok):
    """`DAConfig.validate` keeps its own MAX_SHARDS, the reference's
    da/rs.py bound."""
    from cometbft_tpu.da.rs import MAX_SHARDS

    assert PC.MAX_SHARDS == MAX_SHARDS
    outcomes = []
    for C in (PC, RC):
        da = C.DAConfig(data_shards=shards[0], parity_shards=shards[1])
        try:
            da.validate()
            outcomes.append(None)
        except ValueError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1] and (outcomes[0] is None) == ok


def test_consensus_timeouts_build_the_ports_timeout_config():
    from cometbft_tpu_torch.consensus.state import TimeoutConfig

    t = _varied(PC).consensus.timeouts()
    assert isinstance(t, TimeoutConfig)
    assert vars(t) == vars(_varied(RC).consensus.timeouts())


# ---- genesis

def _genesis(G, T, S, rng, params=True):
    vals = [G.GenesisValidator(rng.bytes(32), int(rng.integers(1, 100)), f"v{i}")
            for i in range(5)]
    cp = None
    if params:
        cp = S.ConsensusParams(
            block=S.BlockParams(max_bytes=1234, max_gas=99),
            evidence=S.EvidenceParams(max_age_num_blocks=7, max_age_duration_ns=8, max_bytes=9),
            validator=S.ValidatorParams(pub_key_types=("ed25519",)),
            abci=S.ABCIParams(vote_extensions_enable_height=3))
    return G.GenesisDoc(chain_id="gen-chain", genesis_time=T(1_700_000_000, 123),
                        initial_height=4, validators=vals, app_hash=rng.bytes(32),
                        app_state=rng.bytes(17), consensus_params=cp)


@pytest.mark.parametrize("params", [True, False])
def test_genesis_json_is_the_references_both_ways(tmp_path, params):
    p = _genesis(PG, PTimestamp, PST, np.random.default_rng(3), params)
    r = _genesis(RG, RTimestamp, RST, np.random.default_rng(3), params)
    assert p.to_json() == r.to_json()
    assert PG.GenesisDoc.from_json(r.to_json()).to_json() == r.to_json()
    path = str(tmp_path / "genesis.json")
    p.save(path)
    back = PG.GenesisDoc.load(path)
    assert back.to_json() == p.to_json()
    assert back.validator_set().hash() == r.validator_set().hash()


@pytest.mark.parametrize("key_type, size", [("tendermint/PubKeySecp256k1", 33),
                                            ("tendermint/PubKeyBls12_381", 48)])
def test_genesis_other_key_types_are_refused_by_name(key_type, size):
    """A secp256k1 or BLS validator is read and written as the reference's
    JSON, but building the set raises UnsupportedKeyType naming the type,
    as `decode_pub_key` does."""
    rng = np.random.default_rng(5)
    docs = []
    for G, T in ((PG, PTimestamp), (RG, RTimestamp)):
        gv = G.GenesisValidator(rng.bytes(size), 10, "x", pub_key_type=key_type,
                                pop=b"\x01" * 96 if "Bls" in key_type else b"")
        docs.append(G.GenesisDoc(chain_id="c", genesis_time=T(1, 0), validators=[gv]))
        rng = np.random.default_rng(5)
    assert docs[0].to_json() == docs[1].to_json()
    back = PG.GenesisDoc.from_json(docs[1].to_json())
    with pytest.raises(UnsupportedKeyType, match=key_type):
        back.validator_set()


# ---- pubsub

QUERIES = ["tm.event = 'NewBlock' AND tx.height > 5", "tx.hash EXISTS", "app.key CONTAINS 'ell'",
           "x.y != 'a'", "tx.height >= 2", "tx.height <= 2.5", "tx.height < 10 AND tx.height != 3",
           "tm.event='Tx'", "a.b = 'x y'", "a.b = 7", "", "tm.event ~ 'x'", "k EXISTS 'v'",
           "k =", "AND", "tx.height > five"]
EVENTS = [{"tm.event": ["NewBlock"], "tx.height": ["6"]}, {"tm.event": ["NewBlock"],
          "tx.height": ["5"]}, {"tm.event": ["Tx"], "tx.height": ["9"]}, {"tx.hash": ["AB"]}, {},
          {"app.key": ["hello"]}, {"x.y": ["b"]}, {"x.y": ["a", "b"]}, {"tx.height": ["2"]},
          {"tx.height": ["3"]}, {"a.b": ["x y"]}, {"a.b": ["7.0"]}, {"tm.event": ["Tx"]},
          {"tx.height": ["five"]}]


def test_query_matches_the_reference_corpus():
    """tests/test_rpc.py:14's queries and events and more: the same parse
    errors and the same matches."""
    for q in QUERIES:
        out = []
        for PS in (PPS, RPS):
            try:
                query = PS.Query(q)
                out.append([query.matches(e) for e in EVENTS])
            except ValueError as e:
                out.append(str(e))
        assert out[0] == out[1], q


def test_pubsub_routing_matches_the_reference():
    """tests/test_rpc.py:64's routing, and a slow subscriber cancelled at
    capacity."""
    got = []
    for PS in (PPS, RPS):
        srv = PS.PubSubServer()
        blocks = srv.subscribe("c1", "tm.event = 'NewBlock'")
        txs = srv.subscribe("c1", "tm.event = 'Tx' AND tx.height >= 2")
        srv.publish("blk1", {"tm.event": ["NewBlock"]})
        srv.publish("tx1", {"tm.event": ["Tx"], "tx.height": ["1"]})
        srv.publish("tx2", {"tm.event": ["Tx"], "tx.height": ["2"]})
        out = [[m.data for m in blocks.drain()], [m.data for m in txs.drain()]]
        srv.unsubscribe_all("c1")
        srv.publish("blk2", {"tm.event": ["NewBlock"]})
        out.append(blocks.drain())
        slow = srv.subscribe("c2", "tm.event EXISTS")
        for i in range(slow.capacity + 1):
            srv.publish(i, {"tm.event": ["x"]})
        with pytest.raises(PS.SubscriptionCancelled):
            slow.next(timeout=0)
        out.append(slow.cancelled)
        got.append(out)
    assert got[0] == got[1] == [["blk1"], ["tx2"], [], True]


# ---- indexer

class _Result:
    def __init__(self, code, data):
        self.code, self.data = code, data


def _index_corpus(I, KV, rng):
    txi, bli = I.TxIndexer(KV.MemKV()), I.BlockIndexer(KV.MemKV())
    for h in range(1, 6):
        for i in range(int(rng.integers(0, 4))):
            tx = rng.bytes(int(rng.integers(1, 40)))
            events = {"tm.event": ["Tx"], "tx.height": [str(h)], "app.k": [f"v{i}", "w"]}
            txi.index(h, i, tx, _Result(int(rng.integers(0, 3)), rng.bytes(5)), events)
        bli.index(h, {"tm.event": ["NewBlock"], "block.height": [str(h)], "b.x": [str(h % 2)]})
    return txi, bli


def test_indexer_kv_bytes_and_searches_match_the_reference():
    p = _index_corpus(PI, PKVS, np.random.default_rng(7))
    r = _index_corpus(RI, RKVS, np.random.default_rng(7))
    for pi, ri in zip(p, r):
        assert sorted(pi._db.iterate_prefix(b"")) == sorted(ri._db.iterate_prefix(b""))
    for q in ("tx.height > 2", "app.k = 'w' AND tx.height <= 3", "tm.event = 'Tx'"):
        assert p[0].search(q) == r[0].search(q)
    for q in ("b.x = 1", "block.height >= 4", "tm.event = 'NewBlock'"):
        assert p[1].search(q) == r[1].search(q)
    rec = r[0].search("tm.event = 'Tx'")[0]
    from cometbft_tpu.crypto.keys import tmhash

    assert p[0].get(tmhash(rec["tx"])) == rec


def test_indexer_service_indexes_the_event_bus_as_the_reference():
    """The event bus's NewBlock and Tx events through IndexerService."""
    from cometbft_tpu.abci.types import ExecTxResult as RRes
    from cometbft_tpu.types import event_bus as REB
    from cometbft_tpu_torch.abci.types import ExecTxResult as PRes
    from cometbft_tpu_torch.types import event_bus as PEB

    class Blk:
        class header:
            height = 3

    dbs = []
    for EB, I, KV, Res in ((PEB, PI, PKVS, PRes), (REB, RI, RKVS, RRes)):
        bus = EB.EventBus()
        txi, bli = I.TxIndexer(KV.MemKV()), I.BlockIndexer(KV.MemKV())
        svc = I.IndexerService(bus, txi, bli)
        try:
            for i in range(3):
                bus.publish_tx(3, i, b"k%d=v" % i, Res(code=i, data=b"d"))
            bus.publish_new_block(Blk, None)
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline and (
                    len(list(txi._db.iterate_prefix(b"TH:"))) < 3
                    or not list(bli._db.iterate_prefix(b"BE:"))):
                time.sleep(0.02)
        finally:
            svc.stop()
        dbs.append((sorted(txi._db.iterate_prefix(b"")), sorted(bli._db.iterate_prefix(b""))))
    assert dbs[0] == dbs[1] and len(dbs[0][0]) == 6


# ---- handshake

@pytest.fixture(scope="module")
def hs_chain():
    """The reference's 6-block, 4-validator chain (tests/test_abci_socket.py
    :84), crossed to the port byte for byte."""
    store, state, genesis, _ = r_make_chain(6, n_validators=4, chain_id="hs-chain",
                                            backend="cpu")
    kv = PKVS.MemKV()
    kv.write_batch(sorted(store._db.iterate_prefix(b"")))
    return store, PBlockStore(kv), genesis, PST.State.decode(genesis.encode()), state


def _handshake(pkg, chain, app_height, state_height):
    """The Handshaker of `pkg` with an app already at `app_height` and a
    state store already at `state_height` (each by a first handshake over
    a store cut there); (state bytes, app hash, blocks replayed) or the
    error's class and message."""
    r_store, p_store, r_gen, p_gen, _ = chain
    H, AC, KVA, SS, KV = ((PH, PAC, PKV, PSS, PKVS) if pkg == "port"
                          else (RH, RAC, RKV, RSS, RKVS))
    store, gen = (p_store, p_gen) if pkg == "port" else (r_store, r_gen)
    kw = {"device": "cpu"} if pkg == "port" else {"backend": "cpu"}

    class Cut:
        def __init__(self, top):
            self.top = top

        def height(self):
            return self.top

        def load_block(self, h):
            return store.load_block(h) if h <= self.top else None

    conns = AC.AppConns(KVA.KVStoreApp())
    if app_height:
        H.Handshaker(SS.StateStore(KV.MemKV()), Cut(app_height), gen, **kw).handshake(conns)
    ss = SS.StateStore(KV.MemKV())
    if state_height:
        app2 = AC.AppConns(KVA.KVStoreApp())
        H.Handshaker(ss, Cut(state_height), gen, **kw).handshake(app2)
    hs = H.Handshaker(ss, store, gen, **kw)
    try:
        st = hs.handshake(conns)
    except Exception as e:  # noqa: BLE001 - compared with the reference's
        return type(e).__name__, str(e)
    return st.encode(), conns.query.info().last_block_app_hash, hs.blocks_replayed


@pytest.mark.parametrize("app_height, state_height", [
    (0, 0), (0, 6), (6, 6), (3, 6), (5, 0), (2, 4), (4, 2)])
def test_handshake_matches_the_reference(hs_chain, app_height, state_height):
    """tests/test_abci_socket.py:84 (a fresh app, state and store at 6) and
    :112 (the app at 5 with an empty state store: an error), and the app
    behind the state, at it, and ahead of it: the same state bytes, app
    hash and blocks replayed, or the same error."""
    port = _handshake("port", hs_chain, app_height, state_height)
    ref = _handshake("ref", hs_chain, app_height, state_height)
    assert port == ref
    if app_height <= state_height:
        assert port[0] == hs_chain[4].encode() and port[2] == 6 - app_height


# ---- nodes

def _key_json(pv) -> dict:
    return {"address": pv.pub_key().address().hex(), "pub_key": pv.pub_key().bytes().hex(),
            "priv_key": pv._priv.bytes().hex()}


def _mk_node(pkg, tmp_path, name, key, genesis_json, peers="", db="mem", app=None):
    """A node of `pkg` ("port" or "ref") as tests/test_node.py:_mk_node
    builds one (device or backend "cpu")."""
    if pkg == "port":
        from cometbft_tpu_torch.abci.kvstore import KVStoreApp
        from cometbft_tpu_torch.config import Config
        from cometbft_tpu_torch.node import Node
    else:
        from cometbft_tpu.abci.kvstore import KVStoreApp
        from cometbft_tpu.config import Config
        from cometbft_tpu.node import Node
    home = os.path.join(tmp_path, name)
    os.makedirs(os.path.join(home, "config"), exist_ok=True)
    os.makedirs(os.path.join(home, "data"), exist_ok=True)
    cfg = Config()
    cfg.base.home, cfg.base.moniker = home, name
    cfg.base.db_backend, cfg.base.crypto_backend = db, "cpu"
    cfg.p2p.laddr = cfg.rpc.laddr = "tcp://127.0.0.1:0"
    cfg.p2p.persistent_peers = peers
    for k, v in FAST.items():
        setattr(cfg.consensus, k, v)
    with open(os.path.join(home, "config/priv_validator_key.json"), "w") as f:
        json.dump(key, f)
    with open(os.path.join(home, "config/genesis.json"), "w") as f:
        f.write(genesis_json)
    return Node(cfg, app=app or KVStoreApp())


def _two_keys(seed):
    from cometbft_tpu_torch.crypto.ed25519 import Ed25519PrivKey
    from cometbft_tpu_torch.privval import FilePV

    rng = np.random.default_rng(seed)
    pvs = [FilePV(Ed25519PrivKey(rng.bytes(32)), None, None) for _ in range(2)]
    genesis = PG.GenesisDoc(
        chain_id="tcp-chain", genesis_time=PTimestamp(1_700_000_000, 0),
        validators=[PG.GenesisValidator(pv.pub_key().bytes(), 10, f"v{i}")
                    for i, pv in enumerate(pvs)])
    return [_key_json(pv) for pv in pvs], genesis.to_json()


def _run_pair(tmp_path, pkgs, seed, tx=b"net=works"):
    """Two validators of `pkgs` over TCP to height 3; a tx submitted at the
    second reaches a block. Returns the nodes' (block hash, app hash) at
    heights 1-3 and whether the tx was found on the first."""
    keys, gen = _two_keys(seed)
    n0 = _mk_node(pkgs[0], tmp_path, "n0", keys[0], gen)
    n0.start()
    n1 = None
    try:
        host, port = n0.listen_addr
        n1 = _mk_node(pkgs[1], tmp_path, "n1", keys[1], gen, peers=f"{host}:{port}")
        n1.start()
        deadline = time.monotonic() + 150
        while time.monotonic() < deadline and min(
                n.consensus.sm_state.last_block_height for n in (n0, n1)) < 3:
            time.sleep(0.1)
        n1.mempool.check_tx(tx)
        found = False
        while time.monotonic() < deadline and not found:
            found = any(tx in n0.block_store.load_block(h).data.txs
                        for h in range(1, n0.block_store.height() + 1))
            time.sleep(0.1)
        return [[(n.block_store.load_block(h).hash(),
                  n.block_store.load_block(h + 1).header.app_hash
                  if n.block_store.height() > h else None) for h in range(1, 4)]
                for n in (n0, n1)], found
    finally:
        if n1 is not None:
            n1.stop()
        n0.stop()


def test_two_port_nodes_commit_over_tcp(tmp_path):
    """tests/test_node.py:71 on the port: two `Node`s over TCP agree on
    heights 1-3, and a tx submitted at node 1 is gossiped and committed."""
    views, found = _run_pair(str(tmp_path), ("port", "port"), 1)
    assert views[0] == views[1] and found


def test_port_and_reference_nodes_agree_over_tcp(tmp_path):
    """A port `Node` (device "cpu") and a reference `Node` (backend "cpu")
    in one network: the same block hash and app hash at heights 1-3, and
    the reference's tx committed on the port's node."""
    views, found = _run_pair(str(tmp_path), ("port", "ref"), 2)
    assert views[0] == views[1] and all(a is not None for _, a in views[0][:2]) and found


def test_restart_on_sqlite(tmp_path):
    """A one-validator node on sqlite commits, stops and starts again on
    the same home: the handshake replays every stored block into a fresh
    app, the state is the stopped node's, and it commits further."""
    from cometbft_tpu_torch.crypto.ed25519 import Ed25519PrivKey
    from cometbft_tpu_torch.privval import FilePV

    pv = FilePV(Ed25519PrivKey(np.random.default_rng(4).bytes(32)), None, None)
    gen = PG.GenesisDoc(chain_id="sql-chain", genesis_time=PTimestamp(1_700_000_000, 0),
                        validators=[PG.GenesisValidator(pv.pub_key().bytes(), 10, "v0")])
    node = _mk_node("port", str(tmp_path), "n0", _key_json(pv), gen.to_json(), db="sqlite")
    node.start()
    try:
        node.mempool.check_tx(b"restart=yes")
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and node.consensus.sm_state.last_block_height < 3:
            time.sleep(0.05)
    finally:
        node.stop()
    state = node.state_store.load()
    assert state.last_block_height >= 3
    again = _mk_node("port", str(tmp_path), "n0", _key_json(pv), gen.to_json(), db="sqlite")
    try:
        assert again.handshaker.blocks_replayed == state.last_block_height
        assert again.consensus.sm_state.encode() == state.encode()
        assert again.app_conns.query.query("", b"restart", 0).value == b"yes"
        again.start()
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and \
                again.consensus.sm_state.last_block_height <= state.last_block_height:
            time.sleep(0.05)
        assert again.consensus.sm_state.last_block_height > state.last_block_height
    finally:
        again.stop()


def _home(tmp_path, **changes):
    """A port Config whose home holds a one-validator genesis; `changes`
    ("section.key" -> value) applied."""
    from cometbft_tpu_torch.crypto.ed25519 import Ed25519PrivKey

    home = str(tmp_path / "home")
    os.makedirs(os.path.join(home, "config"), exist_ok=True)
    pk = Ed25519PrivKey(b"\x07" * 32).pub_key()
    PG.GenesisDoc(chain_id="c", genesis_time=PTimestamp(1, 0),
                  validators=[PG.GenesisValidator(pk.bytes(), 10)]).save(
        os.path.join(home, "config/genesis.json"))
    cfg = PC.Config()
    cfg.base.home = home
    cfg.p2p.laddr = cfg.rpc.laddr = "tcp://127.0.0.1:0"
    for k, v in changes.items():
        section, key = k.split(".")
        setattr(getattr(cfg, section), key, v)
    return cfg


@pytest.fixture
def no_stores(monkeypatch):
    """Every store or socket the node would open, recorded."""
    opened = []
    monkeypatch.setattr(PN, "open_kv", lambda *a: opened.append(("kv", a)))
    monkeypatch.setattr(PN, "Transport", lambda *a, **k: opened.append(("transport", a)))
    monkeypatch.setattr(PN, "SocketAppConns", lambda *a: opened.append(("socket", a)))
    return opened


@pytest.mark.skipif(torch.cuda.is_available(), reason="a GPU is present")
def test_cuda_without_a_gpu_raises_before_any_store_opens(tmp_path, no_stores):
    """The node decides what a host without a GPU does: `Node` on "cuda"
    raises before it opens a store or a socket; there is no fallback to
    the native engine or to the CPU (ROADMAP.md queue C, "No-GPU hosts")."""
    cfg = _home(tmp_path)
    assert cfg.base.crypto_backend == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        PN.Node(cfg, app=PKV.KVStoreApp())
    assert no_stores == [] and not os.path.exists(os.path.join(cfg.base.home, "data"))


REFUSALS = [
    ({"base.abci": "grpc"}, 'abci = "grpc"'),
    ({"base.abci_call_log": True}, "abci_call_log"),
    ({"base.priv_validator_laddr": "tcp://127.0.0.1:1"}, "priv_validator_laddr"),
    ({"da.enabled": True}, "da.enabled"),
    ({"light.serve": True}, "light.serve"),
    ({"replication.serve": True}, "replication.serve"),
    ({"instrumentation.prometheus": True}, "instrumentation.prometheus"),
    ({"rpc.grpc_laddr": "127.0.0.1:1"}, "rpc.grpc_laddr"),
    ({"rpc.grpc_privileged_laddr": "127.0.0.1:2"}, "rpc.grpc_privileged_laddr"),
    ({}, "COMETBFT_TPU_BYZANTINE"),
]


@pytest.mark.parametrize("changes, name", REFUSALS, ids=[n for _, n in REFUSALS])
def test_each_unported_option_is_refused_by_name(tmp_path, monkeypatch, no_stores, changes,
                                                 name):
    """Each option whose part the port lacks raises NotPorted naming it,
    before the device check and before any store or socket; a default
    Config turns none of them on."""
    if name == "COMETBFT_TPU_BYZANTINE":
        monkeypatch.setenv(name, "1")
    cfg = _home(tmp_path, **{"base.crypto_backend": "cpu", **changes})
    with pytest.raises(PN.NotPorted, match=name.replace('"', '.')) as e:
        PN.Node(cfg, app=PKV.KVStoreApp())
    assert "not in the port yet" in str(e.value) and "step" in str(e.value)
    assert no_stores == []
    monkeypatch.delenv(name, raising=False)
    PN.refuse_unported(PC.Config())


@pytest.mark.parametrize("cert_native", [True, False])
def test_cert_native_is_kept_and_not_passed_on(tmp_path, cert_native):
    """`consensus.cert_native` stays in Config for the TOML round trip; the
    port's ConsensusState takes no such option (its validator sets are
    Ed25519 only, where the fold never applies), so the node built either
    way is the same."""
    import inspect

    from cometbft_tpu_torch.consensus.state import ConsensusState

    assert "cert_native" not in inspect.signature(ConsensusState.__init__).parameters
    cfg = _home(tmp_path, **{"base.crypto_backend": "cpu", "base.db_backend": "mem",
                             "consensus.cert_native": cert_native})
    node = PN.Node(cfg, app=PKV.KVStoreApp())
    try:
        assert node.consensus.sm_state.last_block_height == 0
        assert not hasattr(node.consensus, "cert_native")
    finally:
        node.stop()


def test_node_sets_the_metric_namespace_first(tmp_path):
    """The node applies `instrumentation.namespace` before any bundle is
    made (reference utils/metrics.py:23)."""
    from cometbft_tpu_torch.utils import metrics

    metrics.reset_bundles()
    cfg = _home(tmp_path, **{"base.crypto_backend": "cpu", "base.db_backend": "mem",
                             "instrumentation.namespace": "testns"})
    node = PN.Node(cfg, app=PKV.KVStoreApp())
    try:
        names = [m.name for m in metrics.DEFAULT_REGISTRY._metrics]
        assert names and all(n.startswith("testns_") for n in names)
    finally:
        node.stop()
        metrics.set_namespace("cometbft")
        metrics.reset_bundles()
