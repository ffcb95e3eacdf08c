"""Command-line interface (reference cmd/cometbft/commands/*).

Subcommands: init, start, testnet, show-node-id, show-validator,
gen-node-key, gen-validator, reset-all, version, inspect-lite.
Run via `python -m cometbft_tpu_torch.cli <cmd> [--home DIR]`.

Twin of `cometbft_tpu/cli.py`. Its homes hold the reference's files
byte for byte, but `config.toml` says `crypto_backend = "cuda"`: `start`
runs the node on the GPU and fails on a host without one. The `light`,
`replica` and `watchtower` commands and `testnet --key-type bls` are
refused by name: their parts are not in the port yet.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time


def _cfg_paths(home: str):
    return {
        "config": os.path.join(home, "config"),
        "data": os.path.join(home, "data"),
        "config_file": os.path.join(home, "config", "config.toml"),
        "genesis": os.path.join(home, "config", "genesis.json"),
        "pv_key": os.path.join(home, "config", "priv_validator_key.json"),
        "pv_state": os.path.join(home, "data", "priv_validator_state.json"),
        "node_key": os.path.join(home, "config", "node_key.json"),
    }


def cmd_init(args) -> int:
    """reference commands/init.go: config + genesis + keys."""
    from .config import Config
    from .privval import FilePV
    from .types import Timestamp
    from .types.genesis import GenesisDoc, GenesisValidator

    p = _cfg_paths(args.home)
    os.makedirs(p["config"], exist_ok=True)
    os.makedirs(p["data"], exist_ok=True)
    cfg = Config()
    cfg.base.home = args.home
    cfg.base.chain_id = args.chain_id
    cfg.save(p["config_file"])
    pv = FilePV.generate(p["pv_key"], p["pv_state"])
    if not os.path.exists(p["genesis"]):
        gd = GenesisDoc(
            chain_id=args.chain_id,
            genesis_time=Timestamp.from_unix_ns(time.time_ns()),
            validators=[GenesisValidator(pv.pub_key().bytes(), 10, "validator")],
        )
        gd.save(p["genesis"])
    from .p2p import NodeKey

    NodeKey.load_or_generate(p["node_key"])
    print(f"initialized node home at {args.home}")
    return 0


def cmd_start(args) -> int:
    """reference commands/run_node.go."""
    from .abci.kvstore import KVStoreApp
    from .config import Config
    from .node import Node

    p = _cfg_paths(args.home)
    spec = os.environ.get("COMETBFT_TPU_LOG")
    if spec:
        from .utils.log import _LEVELS, set_level

        # validate the WHOLE spec before applying any of it: set_level
        # mutates per-segment, and a partial apply with an "ignoring"
        # message would silently leave earlier segments active
        parts = [s.strip() for s in spec.split(",") if s.strip()]
        bad = [
            s for s in parts
            if (s.partition(":")[2] or s) not in _LEVELS
        ]
        if bad:
            # a diagnostic knob typo must not keep the node down
            print(f"ignoring COMETBFT_TPU_LOG (bad level in {bad})",
                  file=sys.stderr)
        else:
            set_level(spec)
    cfg = Config.load(p["config_file"])
    cfg.base.home = args.home
    if getattr(args, "seed_mode", False):
        # flag overrides config (reference --p2p.seed_mode)
        cfg.p2p.seed_mode = True
        cfg.validate()
    app = (
        KVStoreApp(snapshot_interval=cfg.base.snapshot_interval)
        if cfg.base.abci == "local" else None
    )
    node = Node(cfg, app=app)
    node.start()
    print(f"node started: p2p {node.listen_addr}, rpc {getattr(node, 'rpc_addr', None)}")
    # SIGTERM (the e2e runner's and any supervisor's stop signal) takes
    # the same graceful path as ^C: stores close and the buffered trace
    # sink flushes instead of dying mid-write
    import signal as _signal

    def _term(_sig, _frm):
        raise KeyboardInterrupt

    _signal.signal(_signal.SIGTERM, _term)
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        node.stop()
    return 0


def cmd_testnet(args) -> int:
    """reference commands/testnet.go: N validator homes + shared genesis.

    With --seed-nodes K, K extra seed-mode homes (node{v}..node{v+K-1},
    NOT in the genesis validator set) follow the validator homes, and
    the validators get `p2p.seeds` pointing at them with NO persistent
    peers — the seed-only bootstrap topology the e2e runner exercises."""
    from .config import Config
    from .privval import FilePV
    from .types import Timestamp
    from .types.genesis import GenesisDoc, GenesisValidator

    n_seeds = getattr(args, "seed_nodes", 0)
    total = args.v + n_seeds
    key_type = getattr(args, "key_type", "ed25519")
    if key_type != "ed25519":
        return _refuse(f"testnet --key-type {key_type}",
                       "BLS validator keys (step 5)")
    pv_key_type = "tendermint/PubKeyEd25519"
    pvs = []
    homes = []
    for i in range(total):
        home = os.path.join(args.output, f"node{i}")
        p = _cfg_paths(home)
        os.makedirs(p["config"], exist_ok=True)
        os.makedirs(p["data"], exist_ok=True)
        pvs.append(FilePV.generate(p["pv_key"], p["pv_state"],
                                   key_type=pv_key_type))
        homes.append(home)
    gd = GenesisDoc(
        chain_id=args.chain_id,
        genesis_time=Timestamp.from_unix_ns(time.time_ns()),
        validators=[
            GenesisValidator(
                pv.pub_key().bytes(), 10, f"node{i}",
                pub_key_type=pv_key_type,
            )
            for i, pv in enumerate(pvs[:args.v])
        ],
    )
    base_p2p = args.starting_port
    seed_addrs = [
        f"127.0.0.1:{base_p2p + 2 * (args.v + k)}" for k in range(n_seeds)
    ]
    for i, home in enumerate(homes):
        p = _cfg_paths(home)
        is_seed = i >= args.v
        cfg = Config()
        cfg.base.home = home
        cfg.base.chain_id = args.chain_id
        cfg.base.moniker = f"node{i}"
        cfg.p2p.laddr = f"tcp://127.0.0.1:{base_p2p + 2 * i}"
        cfg.rpc.laddr = f"tcp://127.0.0.1:{base_p2p + 2 * i + 1}"
        if is_seed:
            cfg.p2p.seed_mode = True
            # a seed may crawl its fellow seeds to widen its book
            cfg.p2p.seeds = ",".join(
                a for k, a in enumerate(seed_addrs) if k != i - args.v
            )
        elif n_seeds:
            # seed-only bootstrap: discovery must come through PEX
            cfg.p2p.seeds = ",".join(seed_addrs)
        else:
            cfg.p2p.persistent_peers = ",".join(
                f"127.0.0.1:{base_p2p + 2 * j}"
                for j in range(args.v) if j != i
            )
        cfg.save(p["config_file"])
        gd.save(p["genesis"])
    extra = f" + {n_seeds} seed homes" if n_seeds else ""
    print(f"generated {args.v} validator homes{extra} under {args.output}")
    return 0


def cmd_show_node_id(args) -> int:
    from .p2p import NodeKey

    p = _cfg_paths(args.home)
    print(NodeKey.load_or_generate(p["node_key"]).node_id())
    return 0


def cmd_show_validator(args) -> int:
    p = _cfg_paths(args.home)
    with open(p["pv_key"]) as f:
        d = json.load(f)
    print(json.dumps({"address": d["address"], "pub_key": d["pub_key"]}))
    return 0


def cmd_gen_node_key(args) -> int:
    from .p2p import NodeKey

    nk = NodeKey.generate()
    print(json.dumps({"id": nk.node_id()}))
    return 0


def cmd_gen_validator(args) -> int:
    from .privval import FilePV

    pv = FilePV.generate(None, None)
    print(json.dumps({
        "address": pv.pub_key().address().hex(),
        "pub_key": pv.pub_key().bytes().hex(),
    }))
    return 0


def cmd_reset_all(args) -> int:
    """reference commands/reset.go: wipe data, keep config + keys."""
    p = _cfg_paths(args.home)
    if os.path.isdir(p["data"]):
        for name in os.listdir(p["data"]):
            path = os.path.join(p["data"], name)
            if name == "priv_validator_state.json":
                continue
            if os.path.isdir(path):
                shutil.rmtree(path)
            else:
                os.unlink(path)
    os.makedirs(p["data"], exist_ok=True)
    with open(p["pv_state"], "w") as f:
        json.dump({"height": 0, "round": 0, "step": 0,
                   "signature": "", "sign_bytes": ""}, f)
    print("reset node data (privval last-sign state zeroed, keys kept)")
    return 0


def _refuse(what: str, part: str) -> int:
    print(f"{what}: not in the port yet ({part}, ROADMAP.md queue A)",
          file=sys.stderr)
    return 2


def cmd_light(args) -> int:
    """reference commands/light.go: the light proxy (light/proxy.py is
    not in the port yet)."""
    return _refuse("light", "the light proxy (step 6)")


def cmd_debug(args) -> int:
    """reference cmd/cometbft/commands/debug: capture a node's observable
    state over RPC into a tarball for post-mortem analysis."""
    import io
    import tarfile
    import urllib.request

    def rpc(method):
        body = json.dumps({"jsonrpc": "2.0", "id": 1, "method": method,
                           "params": {}}).encode()
        req = urllib.request.Request(
            args.rpc, data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.read()

    captured = {}
    for method in ("status", "net_info", "consensus_state",
                   "consensus_params", "num_unconfirmed_txs", "genesis"):
        try:
            captured[f"{method}.json"] = rpc(method)
        except Exception as e:  # noqa: BLE001 — capture what we can
            captured[f"{method}.error"] = str(e).encode()
    cfg_file = _cfg_paths(args.home)["config_file"]
    if os.path.exists(cfg_file):
        with open(cfg_file, "rb") as f:
            captured["config.toml"] = f.read()
    with tarfile.open(args.output, "w:gz") as tar:
        for name, data in captured.items():
            info = tarfile.TarInfo(name)
            info.size = len(data)
            info.mtime = int(time.time())
            tar.addfile(info, io.BytesIO(data))
    print(f"wrote {args.output} ({len(captured)} artifacts)")
    return 0


def cmd_compact_db(args) -> int:
    """reference commands/compact.go (experimental-compact-goleveldb):
    reclaim dead space in the node's sqlite stores."""
    import sqlite3

    p = _cfg_paths(args.home)
    n = 0
    for name in os.listdir(p["data"]):
        if not name.endswith(".db"):
            continue
        path = os.path.join(p["data"], name)
        before = os.path.getsize(path)
        con = sqlite3.connect(path)
        con.execute("VACUUM")
        con.close()
        after = os.path.getsize(path)
        print(f"{name}: {before} -> {after} bytes")
        n += 1
    if n == 0:
        print("no .db files under data/ (mem backend?)")
    return 0


def cmd_reindex_event(args) -> int:
    """reference commands/reindex_event.go: rebuild the tx and block
    indexes from the block store + stored ABCI responses."""
    from .abci import wire as W
    from .config import Config
    from .storage import BlockStore, StateStore, open_kv
    from .storage.indexer import BlockIndexer, TxIndexer
    from .crypto.keys import tmhash

    p = _cfg_paths(args.home)
    cfg = Config.load(p["config_file"])
    mem = cfg.base.db_backend == "mem"
    if mem:
        print("mem backend holds no persisted blocks to reindex")
        return 1
    bs = BlockStore(open_kv(os.path.join(args.home, "data/blockstore.db")))
    ss = StateStore(open_kv(os.path.join(args.home, "data/state.db")))
    txi = TxIndexer(open_kv(os.path.join(args.home, "data/tx_index.db")))
    bli = BlockIndexer(open_kv(os.path.join(args.home, "data/block_index.db")))
    start = args.start_height or bs.base() or 1
    end = args.end_height or bs.height()
    txs = blocks = 0
    for h in range(start, end + 1):
        blk = bs.load_block(h)
        raw = ss.load_abci_responses(h)
        if blk is None or raw is None:
            continue
        resp = W.dec_finalize_resp(raw)
        bli.index(h, {"tm.event": ["NewBlock"],
                      "block.height": [str(h)]})
        blocks += 1
        for i, tx in enumerate(blk.data.txs):
            result = (
                resp.tx_results[i] if i < len(resp.tx_results) else None
            )
            txi.index(h, i, tx, result, {
                "tm.event": ["Tx"],
                "tx.height": [str(h)],
                "tx.hash": [tmhash(tx).hex().upper()],
            })
            txs += 1
    print(f"reindexed heights [{start}, {end}]: "
          f"{blocks} blocks, {txs} txs")
    return 0


def cmd_inspect_lite(args) -> int:
    """reference `cometbft inspect`: serve RPC over the stores of a
    stopped node, without consensus."""
    from .config import Config
    from .rpc.routes import Env
    from .rpc.server import RPCServer
    from .storage import BlockStore, StateStore, open_kv
    from .types.genesis import GenesisDoc

    p = _cfg_paths(args.home)
    cfg = Config.load(p["config_file"])
    mem = cfg.base.db_backend == "mem"
    bs = BlockStore(open_kv(None if mem else os.path.join(args.home, "data/blockstore.db")))
    ss = StateStore(open_kv(None if mem else os.path.join(args.home, "data/state.db")))
    env = Env(block_store=bs, state_store=ss,
              genesis_doc=GenesisDoc.load(p["genesis"]))
    host, port = cfg.rpc.laddr[len("tcp://"):].rsplit(":", 1)
    srv = RPCServer(env, host, int(port))
    srv.start()
    print(f"inspect rpc on {srv.addr} (ctrl-c to stop)")
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        srv.stop()
    return 0


def cmd_rollback(args) -> int:
    """reference `cometbft rollback`: overwrite state height n with n-1
    so block n re-applies (app state untouched)."""
    from .config import Config
    from .state.rollback import RollbackError, rollback
    from .storage import BlockStore, StateStore, open_kv

    p = _cfg_paths(args.home)
    cfg = Config.load(p["config_file"])
    mem = cfg.base.db_backend == "mem"
    bs = BlockStore(open_kv(None if mem else os.path.join(args.home, "data/blockstore.db")))
    ss = StateStore(open_kv(None if mem else os.path.join(args.home, "data/state.db")))
    try:
        height, app_hash = rollback(bs, ss, remove_block=args.hard)
    except RollbackError as e:
        print(f"rollback failed: {e}")
        return 1
    print(f"rolled back state to height {height} (app hash {app_hash.hex()})")
    return 0


def cmd_bootstrap_state(args) -> int:
    """reference `cometbft bootstrap-state` (node/node.go:150-259): seed
    a fresh node's state store from light-client-verified state so it
    block-syncs from there instead of replaying from genesis."""
    from .config import Config
    from .node.node import bootstrap_state

    p = _cfg_paths(args.home)
    cfg = Config.load(p["config_file"])
    cfg.base.home = args.home
    try:
        h = bootstrap_state(
            cfg,
            height=args.height,
            rpc_servers=args.servers,
            trust_height=args.trust_height,
            trust_hash=args.trust_hash,
        )
    except Exception as e:  # noqa: BLE001 — operator tool
        print(f"bootstrap-state failed: {e}")
        return 1
    print(f"bootstrapped state at height {h}")
    return 0


def cmd_replica(args) -> int:
    """The serving replica (replication/ is not in the port yet)."""
    return _refuse("replica", "the replication plane (step 6)")


def cmd_watchtower(args) -> int:
    """The safety auditor (watchtower/ is not in the port yet)."""
    return _refuse("watchtower", "the watchtower (step 6)")


def cmd_version(args) -> int:
    from . import __version__

    print(__version__)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="cometbft_tpu_torch")
    ap.add_argument("--home", default=os.path.expanduser("~/.cometbft_tpu_torch"))
    sub = ap.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("init");  sp.add_argument("--chain-id", default="local-chain"); sp.set_defaults(fn=cmd_init)
    sp = sub.add_parser("start")
    sp.add_argument("--seed-mode", action="store_true",
                    help="run as a seed-crawler (overrides p2p.seed_mode)")
    sp.set_defaults(fn=cmd_start)
    sp = sub.add_parser("testnet")
    sp.add_argument("--v", type=int, default=4)
    sp.add_argument("--seed-nodes", type=int, default=0,
                    help="extra non-validator seed-mode homes; validators "
                         "then bootstrap via p2p.seeds instead of "
                         "persistent_peers")
    sp.add_argument("--output", default="./testnet")
    sp.add_argument("--chain-id", default="testnet-chain")
    sp.add_argument("--starting-port", type=int, default=26656)
    sp.add_argument("--key-type", default="ed25519",
                    choices=("ed25519", "bls"),
                    help="validator consensus key curve; the port "
                         "takes ed25519 only and refuses bls")
    sp.set_defaults(fn=cmd_testnet)
    sub.add_parser("show-node-id").set_defaults(fn=cmd_show_node_id)
    sub.add_parser("show-validator").set_defaults(fn=cmd_show_validator)
    sub.add_parser("gen-node-key").set_defaults(fn=cmd_gen_node_key)
    sub.add_parser("gen-validator").set_defaults(fn=cmd_gen_validator)
    sub.add_parser("reset-all").set_defaults(fn=cmd_reset_all)
    sub.add_parser("inspect-lite").set_defaults(fn=cmd_inspect_lite)
    sub.add_parser("inspect").set_defaults(fn=cmd_inspect_lite)
    refused = (cmd_light, cmd_replica, cmd_watchtower)
    for name, fn in zip(("light", "replica", "watchtower"), refused):
        sub.add_parser(name, help="not in the port yet").set_defaults(fn=fn)
    sp = sub.add_parser("debug")
    sp.add_argument("--rpc", default="http://127.0.0.1:26657")
    sp.add_argument("--output", default="cometbft-debug.tar.gz")
    sp.set_defaults(fn=cmd_debug)
    sub.add_parser("compact-db").set_defaults(fn=cmd_compact_db)
    sp = sub.add_parser("reindex-event")
    sp.add_argument("--start-height", type=int, default=0)
    sp.add_argument("--end-height", type=int, default=0)
    sp.set_defaults(fn=cmd_reindex_event)
    sp = sub.add_parser("rollback")
    sp.add_argument("--hard", action="store_true",
                    help="also remove the pending block from the block store")
    sp.set_defaults(fn=cmd_rollback)
    sp = sub.add_parser("bootstrap-state")
    sp.add_argument("--height", type=int, default=0,
                    help="state height to bootstrap (0 = latest - 2)")
    sp.add_argument("--servers", default="",
                    help="comma-separated RPC endpoints "
                         "(default: statesync.rpc_servers)")
    sp.add_argument("--trust-height", type=int, default=0)
    sp.add_argument("--trust-hash", default="")
    sp.set_defaults(fn=cmd_bootstrap_state)
    sub.add_parser("version").set_defaults(fn=cmd_version)

    args, extra = ap.parse_known_args(argv)
    if extra and args.fn not in refused:  # a refused command's arguments go unread
        ap.error(f"unrecognized arguments: {' '.join(extra)}")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
