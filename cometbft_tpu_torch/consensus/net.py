"""In-process consensus networks over a loopback transport.

The reference tests whole consensus networks inside one process with
switches over in-memory connections (reference p2p/test_util.go:348
MakeConnectedSwitches, internal/consensus/common_test.go); this module is
that harness for our stack: N ConsensusStates wired broadcast-to-all, each
with its own KVStore app, stores, WAL, and FilePV.

Twin of `cometbft_tpu/consensus/net.py`. The nodes' executors verify on
`device` ("cuda" by default; "cpu" runs the kernels' plain versions, and
a "cuda" request without a GPU raises), where the reference's are pinned
to `backend="cpu"`. `stop()` also stops each mempool's notifier thread.
"""

from __future__ import annotations

import os

from ..abci.client import AppConns
from ..abci.kvstore import KVStoreApp
from ..evidence import EvidencePool
from ..mempool import CListMempool
from ..privval import FilePV
from ..state.execution import BlockExecutor, make_genesis_state
from ..storage import BlockStore, MemKV, StateStore
from ..crypto.ed25519 import _resolve_device
from ..types import Validator, ValidatorSet
from .state import ConsensusState, TimeoutConfig
from .wal import WAL


FAST_TIMEOUTS = TimeoutConfig(
    propose=0.6, propose_delta=0.2,
    prevote=0.3, prevote_delta=0.1,
    precommit=0.3, precommit_delta=0.1,
    commit=0.05,
)


class InProcessNode:
    def __init__(self, idx, pv, chain_id, genesis, wal_path, net, timeouts,
                 tx_source=None, app_factory=None, device="cuda"):
        self.idx = idx
        self.pv = pv
        self.net = net
        self.app = app_factory() if app_factory is not None else KVStoreApp()
        self.block_store = BlockStore(MemKV())
        self.state_store = StateStore(MemKV())
        conns = AppConns(self.app)
        self.mempool = CListMempool(conns)
        self.evidence_pool = EvidencePool(
            state_store=self.state_store, block_store=self.block_store,
            chain_id=chain_id,
        )
        self.executor = BlockExecutor(
            conns, state_store=self.state_store,
            block_store=self.block_store, device=device,
            mempool=self.mempool, evidence_pool=self.evidence_pool,
        )
        self.wal = WAL(wal_path)
        self.cs = ConsensusState(
            chain_id=chain_id,
            sm_state=genesis.copy(),
            executor=self.executor,
            block_store=self.block_store,
            privval=pv,
            wal=self.wal,
            broadcast=lambda msg, _i=idx: net.broadcast(_i, msg),
            timeouts=timeouts,
            tx_source=tx_source or self._reap_txs,
            name=f"node{idx}",
            # same wiring as the reference's node.py: speculative round-0
            # proposals with the mempool version as the staleness probe
            speculative=True,
            mempool_version=lambda: self.mempool.version,
        )

    def _reap_txs(self):
        # columnar reap, as in production (node/node.py tx_source)
        return self.mempool.reap_columns(max_bytes=1 << 20)


class InProcessNetwork:
    """N validators, full-mesh instant delivery (loopback)."""

    def __init__(self, n: int, tmpdir: str, chain_id: str = "loop-chain",
                 timeouts: TimeoutConfig = FAST_TIMEOUTS, power: int = 10,
                 consensus_params=None, app_factory=None, device="cuda"):
        self.device = _resolve_device(device)
        self.chain_id = chain_id
        self.app_factory = app_factory
        self.pvs = [
            FilePV.generate(
                os.path.join(tmpdir, f"pv{i}.key.json"),
                os.path.join(tmpdir, f"pv{i}.state.json"),
            )
            for i in range(n)
        ]
        vals = ValidatorSet(
            [Validator.from_pub_key(pv.pub_key(), power) for pv in self.pvs]
        )
        self.genesis = make_genesis_state(chain_id, vals)
        if consensus_params is not None:
            from dataclasses import replace as _replace

            self.genesis = _replace(
                self.genesis, consensus_params=consensus_params
            )
        self.nodes = [
            InProcessNode(
                i, self.pvs[i], chain_id, self.genesis,
                os.path.join(tmpdir, f"wal{i}"), self, timeouts,
                app_factory=app_factory, device=self.device,
            )
            for i in range(n)
        ]
        self._partitioned: set[int] = set()
        for node in self.nodes:
            node.mempool.on_new_tx.append(
                lambda tx, _i=node.idx: self.gossip_tx(_i, tx)
            )

    def gossip_tx(self, from_idx: int, tx: bytes) -> None:
        """Mempool gossip seam (reference mempool/reactor.go)."""
        if from_idx in self._partitioned:
            return
        for node in self.nodes:
            if node.idx == from_idx or node.idx in self._partitioned:
                continue
            try:
                node.mempool.check_tx(tx, from_peer=f"node{from_idx}")
            except Exception:
                pass  # dup / full / rejected: drop like the reference

    def broadcast(self, from_idx: int, msg) -> None:
        if from_idx in self._partitioned:
            return
        for node in self.nodes:
            if node.idx != from_idx and node.idx not in self._partitioned:
                node.cs.send(msg, peer_id=f"node{from_idx}")

    def partition(self, idx: int) -> None:
        """Cut a node off (both directions)."""
        self._partitioned.add(idx)

    def heal(self, idx: int) -> None:
        self._partitioned.discard(idx)

    def start(self) -> None:
        for node in self.nodes:
            node.cs.start(replay_wal=False)

    def stop(self) -> None:
        for node in self.nodes:
            node.cs.stop()
            node.mempool.close()

    def wait_for_height(self, h: int, timeout: float = 60.0) -> bool:
        return all(
            n.cs.wait_for_height(h, timeout) for n in self.nodes
            if n.idx not in self._partitioned
        )
