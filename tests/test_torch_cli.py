"""The port's CLI: tests/test_cli.py on `cometbft_tpu_torch.cli`, and held
against the JAX package's CLI on the CPU.

With the same keys and clock, `init` and `testnet` write the reference's
genesis.json byte for byte, and its config.toml but for `crypto_backend`
("cuda" where the reference says "tpu"). The commands whose parts the port
lacks are refused by name; `python3 -m cometbft_tpu_torch.cli` runs, and
`start` on "cuda" without a GPU exits non-zero.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cometbft_tpu import cli as RCLI  # noqa: E402
from cometbft_tpu.crypto import ed25519 as RE  # noqa: E402
from cometbft_tpu_torch import cli as PCLI  # noqa: E402
from cometbft_tpu_torch.cli import main  # noqa: E402
from cometbft_tpu_torch.crypto import ed25519 as PE  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def test_init_show_reset(tmp_path, capsys):
    home = str(tmp_path / "home")
    assert main(["--home", home, "init", "--chain-id", "cli-chain"]) == 0
    assert os.path.exists(os.path.join(home, "config/config.toml"))
    assert os.path.exists(os.path.join(home, "config/genesis.json"))
    capsys.readouterr()
    assert main(["--home", home, "show-node-id"]) == 0
    assert len(capsys.readouterr().out.strip()) == 40
    assert main(["--home", home, "show-validator"]) == 0
    assert len(json.loads(capsys.readouterr().out)["pub_key"]) == 64
    assert main(["--home", home, "reset-all"]) == 0
    st = json.load(open(os.path.join(home, "data/priv_validator_state.json")))
    assert st["height"] == 0


def test_testnet_generation(tmp_path):
    out = str(tmp_path / "net")
    assert main(["testnet", "--v", "3", "--output", out, "--chain-id", "tn"]) == 0
    from cometbft_tpu_torch.config import Config
    from cometbft_tpu_torch.types.genesis import GenesisDoc

    gens = []
    for i in range(3):
        home = os.path.join(out, f"node{i}")
        cfg = Config.load(os.path.join(home, "config/config.toml"))
        assert cfg.base.moniker == f"node{i}" and cfg.base.crypto_backend == "cuda"
        assert len(cfg.p2p.persistent_peer_list()) == 2
        gens.append(GenesisDoc.load(os.path.join(home, "config/genesis.json")))
    assert len({g.validator_set().hash() for g in gens}) == 1


def test_gen_commands(capsys):
    assert main(["gen-node-key"]) == 0
    assert len(json.loads(capsys.readouterr().out)["id"]) == 40
    assert main(["gen-validator"]) == 0
    assert len(json.loads(capsys.readouterr().out)["pub_key"]) == 64
    assert main(["version"]) == 0
    assert capsys.readouterr().out.strip() == RCLI.VERSION


@pytest.fixture
def same_keys(monkeypatch):
    """Both packages' Ed25519 keys drawn from one seeded sequence each (so
    the n-th key of the port equals the reference's n-th), and one clock."""
    for E in (PE, RE):
        rng = np.random.default_rng(17)
        monkeypatch.setattr(E.Ed25519PrivKey, "generate",
                            classmethod(lambda cls, _r=rng: cls(_r.bytes(32))))
    monkeypatch.setattr(PCLI.time, "time_ns", lambda: 1_700_000_123_456_789_000)


@pytest.mark.parametrize("cmd", [["init", "--chain-id", "same-chain"],
                                 ["testnet", "--v", "3", "--chain-id", "same-net",
                                  "--starting-port", "30000"]])
def test_homes_are_the_references_files(tmp_path, same_keys, cmd):
    """With the same keys and clock, the port's homes hold the reference's
    genesis.json and key files byte for byte, and its config.toml but for
    the backend line (and the home's own path)."""
    homes = {}
    for pkg, m in (("port", PCLI.main), ("ref", RCLI.main)):
        root = tmp_path / pkg
        args = (["--home", str(root / "node0")] + cmd if cmd[0] == "init"
                else cmd + ["--output", str(root)])
        assert m(args) == 0
        homes[pkg] = root
    n = 1 if cmd[0] == "init" else 3
    for i in range(n):
        p, r = homes["port"] / f"node{i}", homes["ref"] / f"node{i}"
        for rel in ("config/genesis.json", "config/priv_validator_key.json",
                    "data/priv_validator_state.json"):
            assert (p / rel).read_bytes() == (r / rel).read_bytes(), rel
        pt = (p / "config/config.toml").read_text().replace(str(homes["port"]), "HOME")
        rt = (r / "config/config.toml").read_text().replace(str(homes["ref"]), "HOME")
        assert 'crypto_backend = "cuda"' in pt and pt.replace('"cuda"', '"tpu"') == rt


@pytest.mark.parametrize("argv, name", [
    (["light", "chain", "--primary", "http://127.0.0.1:1"], "light"),
    (["replica", "--core-url", "http://127.0.0.1:1"], "replica"),
    (["watchtower", "--nodes", "a=http://127.0.0.1:1"], "watchtower"),
    (["testnet", "--v", "2", "--key-type", "bls"], "testnet --key-type bls"),
])
def test_unported_commands_are_refused_by_name(tmp_path, capsys, argv, name):
    if argv[0] == "testnet":
        argv = argv + ["--output", str(tmp_path / "net")]
    assert main(argv) == 2
    assert f"{name}: not in the port yet" in capsys.readouterr().err
    assert not (tmp_path / "net").exists()


def test_compact_reindex_debug(tmp_path):
    """tests/test_cli.py's compact-db, reindex-event and debug against a
    real node home (the backend set to "cpu")."""
    import tarfile
    import time as _time

    from cometbft_tpu_torch.abci.kvstore import KVStoreApp
    from cometbft_tpu_torch.config import Config
    from cometbft_tpu_torch.crypto.keys import tmhash
    from cometbft_tpu_torch.node import Node
    from cometbft_tpu_torch.storage import open_kv
    from cometbft_tpu_torch.storage.indexer import TxIndexer

    home = str(tmp_path / "n0")
    assert main(["--home", home, "init", "--chain-id", "cli-chain"]) == 0
    cfg = Config.load(os.path.join(home, "config/config.toml"))
    cfg.base.home, cfg.base.crypto_backend = home, "cpu"
    cfg.p2p.laddr = cfg.rpc.laddr = "tcp://127.0.0.1:0"
    cfg.consensus.timeout_commit = 0.05
    node = Node(cfg, app=KVStoreApp())
    node.start()
    try:
        node.mempool.check_tx(b"cli=test")
        deadline = _time.monotonic() + 60
        while _time.monotonic() < deadline and node.consensus.sm_state.last_block_height < 3:
            _time.sleep(0.1)
        rhost, rport = node.rpc_addr
        out_tar = str(tmp_path / "debug.tar.gz")
        assert main(["debug", "--rpc", f"http://{rhost}:{rport}", "--output", out_tar]) == 0
        with tarfile.open(out_tar) as tar:
            names = tar.getnames()
        assert "status.json" in names and "consensus_state.json" in names
    finally:
        node.stop()
    assert main(["--home", home, "reindex-event"]) == 0
    txi = TxIndexer(open_kv(os.path.join(home, "data/tx_index.db")))
    assert txi.get(tmhash(b"cli=test")) is not None
    assert main(["--home", home, "compact-db"]) == 0
    assert main(["--home", home, "rollback"]) == 0


def test_cli_bootstrap_state_requires_anchor(tmp_path):
    home = str(tmp_path / "bs")
    assert main(["--home", home, "init", "--chain-id", "bs-chain"]) == 0
    assert main(["--home", home, "bootstrap-state"]) == 1
    assert main(["--home", home, "bootstrap-state", "--servers", "http://127.0.0.1:1"]) == 1


@pytest.mark.skipif(torch.cuda.is_available(), reason="a GPU is present")
def test_module_entry_point_and_start_without_a_gpu(tmp_path):
    """`python3 -m cometbft_tpu_torch.cli` runs; `start` on the default
    "cuda" backend exits non-zero on a host without a GPU, naming it, and
    leaves no store behind."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    run = [sys.executable, "-m", "cometbft_tpu_torch.cli"]
    res = subprocess.run(run + ["version"], capture_output=True, text=True, env=env, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == RCLI.VERSION
    home = str(tmp_path / "home")
    assert main(["--home", home, "init"]) == 0
    res = subprocess.run(run + ["--home", home, "start"], capture_output=True, text=True,
                         env=env, timeout=120)
    assert res.returncode != 0 and "cuda" in res.stderr
    assert not any(f.endswith(".db") for f in os.listdir(os.path.join(home, "data")))
