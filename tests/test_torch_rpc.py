"""The port's RPC held against the JAX package on the CPU.

Every route of `ROUTES` (and `UNSAFE_ROUTES`), on a port node and a
reference node built over the same `make_chain` stores with the same keys,
gives the same JSON or the same error. Then the HTTP round trip (JSON-RPC
POST, URI GET) and a websocket subscription on a running port node, and the
HTTP light-block provider over it.
"""

import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from cometbft_tpu.rpc import routes as RR  # noqa: E402
from cometbft_tpu.utils.factories import make_chain  # noqa: E402
from cometbft_tpu_torch.rpc import routes as PR  # noqa: E402

CHAIN = "rpc-chain"
N_BLOCKS = 6


def _packages(pkg):
    if pkg == "port":
        from cometbft_tpu_torch import cli
        from cometbft_tpu_torch.abci import wire as W
        from cometbft_tpu_torch.abci.kvstore import KVStoreApp
        from cometbft_tpu_torch.config import Config
        from cometbft_tpu_torch.node import Node
        from cometbft_tpu_torch.storage import BlockStore, SqliteKV
    else:
        from cometbft_tpu import cli
        from cometbft_tpu.abci import wire as W
        from cometbft_tpu.abci.kvstore import KVStoreApp
        from cometbft_tpu.config import Config
        from cometbft_tpu.node import Node
        from cometbft_tpu.storage import BlockStore, SqliteKV
    return cli, W, KVStoreApp, Config, Node, BlockStore, SqliteKV


def _node(pkg, home, store, genesis_json, keys):
    """A node of `pkg` (not started) on a home whose block store holds the
    chain and whose keys are `keys`: its handshake replays the chain into a
    fresh app and its state store; the txs and blocks are indexed as the
    event bus would index them."""
    cli, W, KVStoreApp, Config, Node, BlockStore, SqliteKV = _packages(pkg)
    assert cli.main(["--home", home, "init", "--chain-id", CHAIN]) == 0
    with open(os.path.join(home, "config/genesis.json"), "w") as f:
        f.write(genesis_json)
    for name, raw in keys.items():
        with open(os.path.join(home, "config", name), "w") as f:
            f.write(raw)
    kv = SqliteKV(os.path.join(home, "data/blockstore.db"))
    kv.write_batch(sorted(store._db.iterate_prefix(b"")))
    kv.close()
    cfg = Config.load(os.path.join(home, "config/config.toml"))
    cfg.base.home, cfg.base.crypto_backend = home, "cpu"
    node = Node(cfg, app=KVStoreApp())
    for h in range(1, node.block_store.height() + 1):
        blk = node.block_store.load_block(h)
        raw = node.state_store.load_abci_responses(h)
        resp = W.dec_finalize_resp(raw)
        node.block_indexer.index(h, {"tm.event": ["NewBlock"], "block.height": [str(h)]})
        for i, tx in enumerate(blk.data.txs):
            node.tx_indexer.index(h, i, tx, resp.tx_results[i],
                                  {"tm.event": ["Tx"], "tx.height": [str(h)]})
    return node


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    store, _, genesis, _ = make_chain(N_BLOCKS, n_validators=4, chain_id=CHAIN, backend="cpu")
    from cometbft_tpu.types.genesis import GenesisDoc, GenesisValidator

    gd = GenesisDoc(chain_id=CHAIN, genesis_time=genesis.last_block_time,
                    validators=[GenesisValidator(v.pub_key.bytes(), v.voting_power)
                                for v in genesis.validators.validators])
    tmp = tmp_path_factory.mktemp("rpc")
    port = _node("port", str(tmp / "port"), store, gd.to_json(), {})
    keys = {}
    for name in ("node_key.json", "priv_validator_key.json"):
        with open(tmp / "port" / "config" / name) as f:
            keys[name] = f.read()
    ref = _node("ref", str(tmp / "ref"), store, gd.to_json(), keys)
    yield port, ref, store
    for n in (port, ref):
        n.stop()


def _call(routes, env, name, params):
    try:
        return "ok", json.loads(json.dumps(routes[name](env, dict(params))))
    except Exception as e:  # noqa: BLE001 - compared with the reference's
        return type(e).__name__, getattr(e, "code", None), str(e)


def _params(store):
    """The params each route is called with: the defaults, each height of
    the chain, past the tip, and malformed values."""
    blk = store.load_block(3)
    tx = blk.data.txs[0]
    from cometbft_tpu.crypto.keys import tmhash

    heights = [{}] + [{"height": str(h)} for h in (1, 3, N_BLOCKS, N_BLOCKS + 1)]
    return {
        "block": heights, "header": heights, "commit": heights, "validators": heights,
        "block_results": heights,
        "block_by_hash": [{"hash": blk.hash().hex()}, {"hash": "00" * 32}],
        "header_by_hash": [{"hash": blk.hash().hex()}, {"hash": "00" * 32}],
        "blockchain": [{}, {"min_height": "2", "max_height": "4"}, {"min_height": "5",
                                                                   "max_height": "2"},
                       {"min_height": "x"}, {"min_height": "-1"}],
        "abci_query": [{"data": tx.split(b"=")[0].hex()}, {"data": "6e6f6e65"}],
        "tx": [{"hash": tmhash(tx).hex()}, {"hash": tmhash(tx).hex(), "prove": "true"},
               {"hash": "00" * 32}],
        "tx_search": [{"query": "tx.height >= 2"}, {"query": "tx.height >= 2", "prove": True,
                                                     "order_by": "desc", "per_page": "2",
                                                     "page": "2"},
                      {"query": "tx.height > 1", "page": "9"}, {"query": "bad ~"},
                      {"query": "tm.event = 'Tx'", "order_by": "sideways"}],
        "block_search": [{"query": "block.height > 4"}, {"query": "block.height > 0",
                                                          "order_by": "desc"}],
        "check_tx": [{"tx": b"k=v".hex()}, {"tx": b"bad".hex()}],
        "broadcast_tx_sync": [{"tx": b"rpc=sync".hex()}, {"tx": b"rpc=sync".hex()}],
        "broadcast_tx_async": [{"tx": b"rpc=async".hex()}],
        "broadcast_tx_commit": [{}],
        "unconfirmed_txs": [{}, {"limit": "1"}],
        "broadcast_evidence": [{"evidence": "zz"}, {"evidence": "0a00"}],
        "genesis_chunked": [{}, {"chunk": "1"}],
        "light_mmr_proof": [{"height": "2"}], "da_sample": [{"height": "2", "index": "1"}],
        "replication_snapshot_chunk": [{"chunk": "0"}],
        "dump_trace": [{}, {"n": "5", "name": "p2p."}],
    }


def test_route_tables_have_the_references_names():
    assert list(PR.ROUTES) == list(RR.ROUTES)
    assert list(PR.UNSAFE_ROUTES) == list(RR.UNSAFE_ROUTES)


def test_every_route_gives_the_references_json(nodes):
    """Every route, on both nodes over the same stores and keys, gives the
    same JSON or the same error (class, code, message); the light, DA and
    replication routes the reference's "disabled" error. The mempool routes
    run in order on both (broadcast, then the pool's contents, then the
    unsafe flush)."""
    port, ref, store = nodes
    params = _params(store)
    names = list(PR.ROUTES) + list(PR.UNSAFE_ROUTES)
    routes_p = {**PR.ROUTES, **PR.UNSAFE_ROUTES}
    routes_r = {**RR.ROUTES, **RR.UNSAFE_ROUTES}
    for name in names:
        for p in params.get(name, [{}]):
            got = _call(routes_p, port.rpc_env, name, p)
            want = _call(routes_r, ref.rpc_env, name, p)
            assert got == want, (name, p)
    for name in ("light_status", "da_status", "replication_status", "replication_snapshot"):
        assert _call(routes_p, port.rpc_env, name, {})[0] == "RPCError"
    assert _call(routes_p, port.rpc_env, "status", {})[1]["sync_info"]["latest_block_height"] \
        == str(N_BLOCKS)


# ---- a running port node

@pytest.fixture(scope="module")
def live(tmp_path_factory):
    from cometbft_tpu_torch.abci.kvstore import KVStoreApp
    from cometbft_tpu_torch.config import Config
    from cometbft_tpu_torch.crypto.ed25519 import Ed25519PrivKey
    from cometbft_tpu_torch.node import Node
    from cometbft_tpu_torch.privval import FilePV
    from cometbft_tpu_torch.types import Timestamp
    from cometbft_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
    from cometbft_tpu_torch.utils import log as L

    home = str(tmp_path_factory.mktemp("live"))
    os.makedirs(os.path.join(home, "config"), exist_ok=True)
    pv = FilePV(Ed25519PrivKey(np.random.default_rng(9).bytes(32)), None, None)
    GenesisDoc(chain_id="live-chain", genesis_time=Timestamp(1_700_000_000, 0),
               validators=[GenesisValidator(pv.pub_key().bytes(), 10, "v0")]).save(
        os.path.join(home, "config/genesis.json"))
    with open(os.path.join(home, "config/priv_validator_key.json"), "w") as f:
        json.dump({"address": pv.pub_key().address().hex(),
                   "pub_key": pv.pub_key().bytes().hex(), "priv_key": pv._priv.bytes().hex()}, f)
    cfg = Config()
    cfg.base.home, cfg.base.db_backend, cfg.base.crypto_backend = home, "mem", "cpu"
    cfg.p2p.laddr = cfg.rpc.laddr = "tcp://127.0.0.1:0"
    cfg.consensus.timeout_propose, cfg.consensus.timeout_commit = 0.5, 0.05
    sink = L._config.sink
    L.set_sink(lambda level, msg, fields: None)
    node = Node(cfg, app=KVStoreApp())
    node.start()
    yield node
    node.stop()
    L.set_sink(sink)


def test_http_post_and_uri_round_trip(live):
    """JSON-RPC over POST and the URI form over GET; a tx committed by
    broadcast_tx_commit is read back with its proof; unknown methods and
    bad bodies get the reference's codes; /light_stream answers 503."""
    import base64
    import urllib.error
    import urllib.request

    from cometbft_tpu_torch.crypto import merkle
    from cometbft_tpu_torch.crypto.keys import tmhash

    addr = live.rpc_addr
    r = chip_smoke.rpc(addr, "broadcast_tx_commit", tx=b"http=round".hex())
    assert r["check_tx"]["code"] == 0 and r["tx_result"]["code"] == 0
    got = chip_smoke.wait_for("the tx in the index", lambda: chip_smoke.rpc(
        addr, "tx", hash=r["hash"], prove=True), 30, poll_s=0.02)
    blk = live.block_store.load_block(int(got["height"]))
    pr = got["proof"]["proof"]
    proof = merkle.Proof(int(pr["total"]), int(pr["index"]), base64.b64decode(pr["leaf_hash"]),
                         [base64.b64decode(a) for a in pr["aunts"]])
    assert proof.verify(blk.header.data_hash, tmhash(b"http=round"))
    base = f"http://{addr[0]}:{addr[1]}"

    def get(path):
        with urllib.request.urlopen(base + path, timeout=10) as resp:
            return json.loads(resp.read())

    assert get(f"/abci_query?data=0x{b'http'.hex()}")["result"]["response"]["value"] == \
        b"round".hex().upper()
    assert get('/block?height="1"')["result"]["block"]["header"]["height"] == "1"
    assert get("/nope")["error"]["code"] == -32601
    req = urllib.request.Request(base, data=b"{not json", method="POST")
    with urllib.request.urlopen(req, timeout=10) as resp:
        assert json.loads(resp.read())["error"]["code"] == -32700
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(base + "/light_stream", timeout=10)
    assert e.value.code == 503


def test_websocket_subscription(live):
    """`subscribe` to NewBlock over the websocket: one event a height, in
    order; a bad query is answered with an error."""
    ws = chip_smoke.WsSubscriber(live.rpc_addr, "tm.event = 'NewBlock'")
    try:
        h0 = live.block_store.height()
        chip_smoke.wait_for("3 NewBlock events", lambda: len(ws.heights()) >= 3, 30)
        hs = ws.heights()
        assert hs == list(range(hs[0], hs[0] + len(hs))) and hs[0] >= h0
        ws._send({"jsonrpc": "2.0", "id": 7, "method": "subscribe", "params": {"query": "x ~"}})
        chip_smoke.wait_for("the error", lambda: any(m.get("id") == 7 for m in ws.msgs), 10)
        err = [m for m in ws.msgs if m.get("id") == 7][0]
        assert err["error"]["code"] == -32602
    finally:
        ws.close()


def test_http_provider_fetches_verified_light_blocks(live):
    """`HTTPProvider` rebuilds light blocks from /commit and /validators:
    the header hashes to the stored block's, the set to the header's
    validators_hash, and the commit verifies for the block."""
    from cometbft_tpu_torch.light.client import ProviderError
    from cometbft_tpu_torch.light.provider_http import HTTPProvider
    from cometbft_tpu_torch.types.block import block_id_for
    from cometbft_tpu_torch.types.validation import verify_commit

    chip_smoke.wait_for("height 3", lambda: live.block_store.height() >= 3, 30)
    p = HTTPProvider("live-chain", "http://%s:%d" % live.rpc_addr)
    lb = p.light_block(2)
    blk = live.block_store.load_block(2)
    assert lb.signed_header.header.hash() == blk.hash()
    verify_commit("live-chain", lb.validators, block_id_for(blk), 2, lb.signed_header.commit,
                  device="cpu")
    with pytest.raises(ProviderError, match="commit failed"):
        p.light_block(10_000)  # past the tip: the route's error, retried
