"""Node assembly: wire every subsystem into a runnable validator.

Behavior parity: reference node/node.go NewNode (:264-520) wiring order —
DBs -> state store -> genesis -> proxy app conns -> handshake/replay ->
mempool -> evidence -> block executor -> consensus (+WAL, privval) ->
transport -> switch (+reactors) -> dial persistent peers. OnStart (:523)
listens, starts reactors, dials.

The RPC server attaches via rpc.server.serve(node) (reference startRPC).

Twin of `cometbft_tpu/node/node.py`, in the reference's wiring order.
Every part that verifies signatures gets the config's device
(`crypto_backend`, "cuda" by default): the block executor, the admission
pipeline, the shared scheduler, the handshake, block sync and the state
sync light client. A node on "cuda" checks the card and builds and loads
the CUDA kernels before it opens a store or a socket, and raises if it
cannot; there is no fallback to the native engine or the CPU. The
options whose parts the port does not have yet are refused by name
(`refuse_unported`). The consensus reactor waits while the node
block-syncs, as CometBFT's does (the reference's does not): it announces
no round step and takes no proposal, part or vote until start() switches
it to consensus.
"""

from __future__ import annotations

import os

from ..abci.client import AppConns
from ..abci.socket import SocketAppConns
from ..config import Config
from ..consensus.reactor import ConsensusReactor
from ..consensus.state import ConsensusState
from ..consensus.wal import WAL
from ..evidence import EvidencePool
from ..mempool import CListMempool
from ..mempool.reactor import MempoolReactor
from ..p2p import NodeKey, Switch, Transport
from ..p2p.transport import NodeInfo
from ..privval import FilePV
from ..rpc.routes import Env
from ..rpc.server import RPCServer
from ..state.execution import BlockExecutor, make_genesis_state
from ..state.handshake import Handshaker
from ..storage import BlockStore, StateStore, open_kv
from ..storage.indexer import BlockIndexer, IndexerService, TxIndexer
from ..types.event_bus import EventBus
from ..types.genesis import GenesisDoc

class NotPorted(ValueError):
    """A configured option whose part the port does not have yet."""


def refuse_unported(config: Config) -> None:
    """Raise NotPorted naming the first option that turns on a part the
    port lacks, with the queue-A step of ROADMAP.md that brings it. None
    of them is on in a default Config."""
    refusals = (
        (config.base.abci == "grpc",
         'abci = "grpc": the gRPC ABCI transport (step 4, needs grpcio)'),
        (config.base.abci_call_log,
         "abci_call_log: the ABCI grammar recorder (step 6, with e2e/)"),
        (bool(config.base.priv_validator_laddr),
         "priv_validator_laddr: the remote signer (step 4, privval/signer.py)"),
        (bool(os.environ.get("COMETBFT_TPU_BYZANTINE")),
         "COMETBFT_TPU_BYZANTINE: the byzantine signer (step 6, "
         "privval/byzantine.py)"),
        (config.da.enabled, "da.enabled: data-availability sampling (step 6, da/)"),
        (config.light.serve, "light.serve: light-client serving (step 6, light/serve.py)"),
        (config.replication.serve,
         "replication.serve: the replication feed (step 6, replication/)"),
        (config.instrumentation.prometheus,
         "instrumentation.prometheus: the MetricsServer (step 4)"),
        (bool(config.rpc.grpc_laddr),
         "rpc.grpc_laddr: the gRPC services (step 4, needs grpcio)"),
        (bool(config.rpc.grpc_privileged_laddr),
         "rpc.grpc_privileged_laddr: the gRPC services (step 4, needs grpcio)"),
    )
    for on, what in refusals:
        if on:
            raise NotPorted(f"not in the port yet: {what}")


def check_device(device: str) -> None:
    """On "cuda": a GPU must be there and every kernel library must build
    and load, or this raises (RuntimeError, KernelError)."""
    from ..crypto.ed25519 import _resolve_device

    if _resolve_device(device).type == "cuda":
        from ..ops import kernels

        kernels.build()


class Node:
    def __init__(self, config: Config, app=None, genesis: GenesisDoc | None = None):
        """app: an in-process Application (abci=local); with abci=socket the
        node connects to config.base.proxy_app instead."""
        self.config = config
        refuse_unported(config)
        config.validate()
        device = config.base.crypto_backend
        check_device(device)
        home = config.base.home

        # --- observability ---------------------------------------------
        # Namespace must be applied before any subsystem constructs its
        # metrics bundle (bundle names are frozen at registration time).
        from ..utils import metrics as _metrics
        from ..utils import trace as _trace

        _metrics.set_namespace(config.instrumentation.namespace)
        # Register every bundle up front (reference node.go creates all
        # subsystem metrics at construction): /metrics then shows the
        # full inventory from the first scrape, zeros included, instead
        # of series popping into existence when a subsystem first runs.
        # (the port's bundles: no DA or replication bundle yet)
        for _mk in (
            _metrics.consensus_metrics, _metrics.mempool_metrics,
            _metrics.p2p_metrics, _metrics.state_metrics,
            _metrics.blocksync_metrics, _metrics.statesync_metrics,
            _metrics.light_metrics, _metrics.crypto_metrics,
        ):
            _mk()
        if config.instrumentation.trace_sink and not _trace.enabled:
            sink = config.instrumentation.trace_sink
            if not os.path.isabs(sink):
                sink = os.path.join(home, sink)
            _trace.configure(sink)
        # tx lifecycle sampling: env var (already applied at import)
        # wins over config, mirroring the trace-sink precedence
        if os.environ.get("COMETBFT_TPU_TXLIFE") is None:
            from ..utils import txlife as _txlife

            _txlife.configure(config.instrumentation.txlife_sample_rate)

        def _p(rel: str) -> str:
            path = os.path.join(home, rel)
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            return path

        # --- genesis ---------------------------------------------------
        self.genesis_doc = genesis or GenesisDoc.load(_p(config.base.genesis_file))
        self.genesis_doc.validate_basic()

        # --- stores ----------------------------------------------------
        mem = config.base.db_backend == "mem"
        self.block_store = BlockStore(
            open_kv(None if mem else _p("data/blockstore.db"))
        )
        self.state_store = StateStore(
            open_kv(None if mem else _p("data/state.db"))
        )

        # --- app conns -------------------------------------------------
        if config.base.abci == "local":
            if app is None:
                raise ValueError("abci=local requires an in-process app")
            self.app_conns = AppConns(app)
        else:
            self.app_conns = SocketAppConns(config.base.proxy_app)

        # --- identity --------------------------------------------------
        self.node_key = NodeKey.load_or_generate(_p(config.base.node_key_file))
        kf = _p(config.base.priv_validator_key_file)
        sf = _p(config.base.priv_validator_state_file)
        self.priv_validator = (
            FilePV.load(kf, sf) if os.path.exists(kf)
            else FilePV.generate(kf, sf)
        )

        # --- handshake / replay ---------------------------------------
        genesis_state = make_genesis_state(
            self.genesis_doc.chain_id,
            self.genesis_doc.validator_set(),
            app_hash=self.genesis_doc.app_hash,
            initial_height=self.genesis_doc.initial_height,
            genesis_time=self.genesis_doc.genesis_time,
            consensus_params=self.genesis_doc.consensus_params,
        )
        self.handshaker = Handshaker(
            self.state_store, self.block_store, genesis_state,
            device=device,
        )
        # A fresh node about to state-sync must NOT handshake first: the
        # reference skips doHandshake entirely when state sync will run
        # (node/node.go:575-584), so the app sees OfferSnapshot without a
        # prior InitChain — the CleanStart:StateSync production of the
        # ABCI grammar. If state sync later fails or finds no snapshots,
        # start() runs the deferred handshake before block sync.
        self._handshake_deferred = bool(
            getattr(config, "statesync", None)
            and config.statesync.enable
            and self.state_store.load() is None
        )
        if self._handshake_deferred:
            sm_state = genesis_state.copy()
        else:
            sm_state = self.handshaker.handshake(self.app_conns)

        # --- shared verification scheduler -----------------------------
        # One process-wide scheduler per crypto backend: every verify
        # consumer on this node (and any co-hosted chain) shares one
        # coalescing dispatch path with per-tenant DRR fairness. The
        # tenant key is the chain_id.
        self.verify_sched = None
        self.sched_tenant = self.genesis_doc.chain_id
        if config.sched.enabled:
            from ..crypto.sched import acquire_shared

            self.verify_sched = acquire_shared(
                device,
                max_coalesce_sigs=config.sched.max_coalesce_sigs,
                max_coalesce_delay_ms=config.sched.max_coalesce_delay_ms,
                stop_timeout_s=config.sched.stop_timeout_s,
            )
            self.verify_sched.set_tenant_weight(
                self.sched_tenant, config.sched.tenant_weight)

        # --- mempool / evidence / executor ----------------------------
        self.mempool = CListMempool(
            self.app_conns,
            max_txs=config.mempool.size,
            max_tx_bytes=config.mempool.max_tx_bytes,
            cache_size=config.mempool.cache_size,
            keep_invalid_txs_in_cache=config.mempool.keep_invalid_txs_in_cache,
            recheck_window=config.mempool.admission_window or 256,
            verify_sigs=config.mempool.admission_verify_sigs,
        )
        if config.mempool.admission_window > 0:
            # micro-batched admission: RPC handlers and peer receives
            # enqueue; one drainer runs batch sig verify + one app
            # CheckTx round + one locked insert per window
            from ..mempool import AdmissionPipeline

            self.mempool.attach_pipeline(AdmissionPipeline(
                self.mempool,
                window=config.mempool.admission_window,
                max_delay_s=config.mempool.admission_max_delay_ms / 1e3,
                verify_sigs=config.mempool.admission_verify_sigs,
                device=device,
                sched=self.verify_sched,
                tenant=self.sched_tenant,
            ))
        self.evidence_pool = EvidencePool(
            state_store=self.state_store, block_store=self.block_store,
            chain_id=self.genesis_doc.chain_id,
        )
        self.event_bus = EventBus()
        self.tx_indexer = TxIndexer()
        self.block_indexer = BlockIndexer()
        self.indexer_service = IndexerService(
            self.event_bus, self.tx_indexer, self.block_indexer
        )
        self.executor = BlockExecutor(
            self.app_conns,
            state_store=self.state_store,
            block_store=self.block_store,
            device=device,
            mempool=self.mempool,
            evidence_pool=self.evidence_pool,
            event_bus=self.event_bus,
        )
        self.executor.verify_sched = self.verify_sched
        self.executor.sched_tenant = self.sched_tenant
        from ..state.pruner import Pruner

        self.pruner = Pruner(self.block_store, self.state_store)
        self.executor.pruner = self.pruner

        # --- consensus -------------------------------------------------
        self.wal = WAL(_p(config.consensus.wal_file))
        self.consensus = ConsensusState(
            chain_id=self.genesis_doc.chain_id,
            sm_state=sm_state,
            executor=self.executor,
            block_store=self.block_store,
            privval=self.priv_validator,
            wal=self.wal,
            timeouts=config.consensus.timeouts(),
            # columnar carry-through: reap hands consensus a
            # TxColumns batch — one contiguous blob + offsets — that
            # rides unchanged into Data.hash/encode and prepare_proposal
            tx_source=lambda: self.mempool.reap_columns(max_bytes=1 << 20),
            name=config.base.moniker,
            speculative=config.consensus.speculative_propose,
            mempool_version=lambda: self.mempool.version,
        )

        # --- p2p -------------------------------------------------------
        from .. import __version__

        info = NodeInfo(
            node_id=self.node_key.node_id(),
            network=self.genesis_doc.chain_id,
            moniker=config.base.moniker,
            # software version is informational (compatible_with checks
            # network + channels only); the env override is the e2e
            # "upgrade" perturbation's hook for restarting a node as a
            # newer build (reference test/e2e/runner/perturb.go upgrade)
            version=os.environ.get("COMETBFT_TPU_VERSION", __version__),
        )
        self.transport = Transport(self.node_key, info)
        self.switch = Switch(
            self.transport,
            send_rate=config.p2p.send_rate,
            recv_rate=config.p2p.recv_rate,
            max_packet_payload_size=config.p2p.max_packet_payload_size,
        )
        # the block-sync wait of CometBFT's node (waitSync = block sync and
        # not the only validator); start() ends it before consensus starts
        vals = sm_state.validators.validators
        only_us = len(vals) == 1 and vals[0].address == self.priv_validator.address()
        self.consensus_reactor = ConsensusReactor(
            self.consensus, wait_sync=config.blocksync.enable and not only_us)
        self.consensus_reactor.set_switch(self.switch)
        self.mempool_reactor = MempoolReactor(
            self.mempool,
            max_gossip_peers=(
                config.mempool.experimental_max_gossip_connections
            ),
        )
        self.mempool_reactor.set_switch(self.switch)
        from ..evidence.reactor import EvidenceReactor

        self.evidence_reactor = EvidenceReactor(self.evidence_pool)
        self.evidence_reactor.set_switch(self.switch)
        self.switch.add_reactor(self.consensus_reactor)
        self.switch.add_reactor(self.mempool_reactor)
        self.switch.add_reactor(self.evidence_reactor)
        # state-sync reactor: always serve local snapshots; the syncing
        # side (pool + Syncer) activates only when config enables it
        # (reference node/node.go:427 createStatesyncReactor)
        from ..statesync import SnapshotPool, StateSyncReactor

        self.statesync_pool = (
            SnapshotPool() if getattr(config, "statesync", None)
            and config.statesync.enable else None
        )
        self.statesync_reactor = StateSyncReactor(
            self.app_conns.snapshot, self.statesync_pool,
            block_store=self.block_store, state_store=self.state_store,
        )
        from ..blocksync.reactor import BlockSyncReactor

        self.blocksync_reactor = BlockSyncReactor(
            self.block_store,
            executor=self.executor,
            state=sm_state,
            device=device,
        )
        self.switch.add_reactor(self.blocksync_reactor)
        self.switch.add_reactor(self.statesync_reactor)
        self.pex_reactor = None
        self.addr_book = None
        if config.p2p.pex:
            from ..p2p.pex import AddrBook, PexReactor

            self.addr_book = AddrBook(
                _p(config.p2p.addr_book_file),
                strict=config.p2p.addr_book_strict,
                self_id=self.node_key.node_id(),
            )
            self.pex_reactor = PexReactor(
                self.addr_book,
                target_outbound=config.p2p.max_outbound_peers,
                ensure_interval_s=config.p2p.pex_interval_s,
                seed_mode=config.p2p.seed_mode,
                seeds=config.p2p.seed_list(),
            )
            self.pex_reactor.set_switch(self.switch)
            self.switch.add_reactor(self.pex_reactor)
        self.rpc_env = Env(
            block_store=self.block_store,
            state_store=self.state_store,
            consensus=self.consensus,
            mempool=self.mempool,
            switch=self.switch,
            event_bus=self.event_bus,
            tx_indexer=self.tx_indexer,
            block_indexer=self.block_indexer,
            genesis_doc=self.genesis_doc,
            app_conns=self.app_conns,
            node_info=info,
            evidence_pool=self.evidence_pool,
            consensus_reactor=self.consensus_reactor,
        )
        self.rpc_server = None

    # ------------------------------------------------------------------
    def start(self) -> None:
        host, port = "127.0.0.1", 0
        laddr = self.config.p2p.laddr
        if laddr.startswith("tcp://"):
            host, p = laddr[len("tcp://"):].rsplit(":", 1)
            port = int(p)
        self.listen_addr = self.transport.listen(host, port)
        self.switch.start()
        rladdr = self.config.rpc.laddr
        if rladdr.startswith("tcp://"):
            rhost, rport = rladdr[len("tcp://"):].rsplit(":", 1)
            routes = None
            if self.config.rpc.unsafe:
                from ..rpc.routes import ROUTES, UNSAFE_ROUTES

                routes = {**ROUTES, **UNSAFE_ROUTES}
            self.rpc_server = RPCServer(
                self.rpc_env, rhost, int(rport), routes=routes
            )
            self.rpc_server.start()
            self.rpc_addr = self.rpc_server.addr
        if self.config.p2p.fault_injection:
            # fault-injection control channel for the e2e runner: a JSON
            # list of blocked peer ids in the node home partitions this
            # node at the transport level (no network namespaces needed)
            self.switch.watch_partition_file(
                self.config.path("data/partition.json")
            )
        for hostp, portp in self.config.p2p.persistent_peer_list():
            # the switch owns the retry loop: dialed immediately, then
            # redialed with backoff whenever disconnected
            self.switch.add_persistent_peer(hostp, portp)
        self.pruner.start()
        if self.pex_reactor is not None:
            self.pex_reactor.start()
        # startup hand-off chain (reference node/node.go:575-584):
        # state sync (if enabled and fresh) -> block sync -> consensus
        if self.statesync_pool is not None:
            self._run_state_sync()
        if self._handshake_deferred and self.state_store.load() is None:
            # state sync did not complete (no snapshots / failed): run
            # the handshake that was skipped in anticipation of it, so
            # the app still gets its InitChain before block sync
            sm_state = self.handshaker.handshake(self.app_conns)
            self.blocksync_reactor.state = sm_state
            self.consensus.reset_to_state(sm_state)
        # catch up over block sync before consensus when we have peers
        # that are ahead (reference SwitchToConsensus hand-off); sync()
        # itself drives the status exchange and gives up after 3 s when
        # no peer ever reports a range — but it never RUNS unless a
        # peer is connected when we look, hence the short wait below
        if (
            self.config.blocksync.enable
            and not self.switch.peers()
            and self.config.p2p.persistent_peer_list()
        ):
            # a restarting node checks for peers microseconds after the
            # switch starts dialing — losing that race silently skipped
            # block sync on EVERY restart and left catch-up to the
            # consensus reactor's per-peer gossip (observed: 100% of
            # restarts skipped; rarely the gossip path stalls). When
            # peers are configured, give the first dial a moment.
            import time as _time

            from ..utils.log import logger as _logger

            deadline = _time.monotonic() + 2.0
            while not self.switch.peers() and _time.monotonic() < deadline:
                _time.sleep(0.05)
            if not self.switch.peers():
                _logger("node").debug(
                    "block sync skipped: no peer connected within 2s"
                )
        if self.config.blocksync.enable and self.switch.peers():
            from ..utils.log import logger as _logger

            try:
                synced = self.blocksync_reactor.sync(timeout_s=30)
                if synced.last_block_height > self.consensus.sm_state.last_block_height:
                    self.consensus.reset_to_state(synced)
            except Exception as e:  # noqa: BLE001 — consensus can still
                # make progress via its own catchup; surface the cause
                _logger("node").warn(
                    "block sync failed; continuing to consensus",
                    err=str(e)[:120],
                )
        self.consensus_reactor.switch_to_consensus()
        self.consensus.start()

    def _run_state_sync(self) -> None:
        """Restore from a peer snapshot when enabled and the node is fresh
        (reference node/node.go:575-584 startStateSync)."""
        import time as _time

        from ..light.client import LightClient
        from ..statesync.reactor import P2PLightProvider
        from ..statesync.syncer import StateSyncError, Syncer
        from ..statesync.provider import LightStateProvider
        from ..utils.log import logger as _logger

        log = _logger("statesync")
        cfg = self.config.statesync
        if self.consensus.sm_state.last_block_height > 0:
            log.info("state already exists; skipping state sync")
            return
        # discovery: snapshot offers arrive from peers added at switch
        # start; wait (bounded) for the pool to fill rather than sleeping
        # a fixed interval
        deadline = _time.monotonic() + max(cfg.discovery_time_s, 0.1) * 5
        while self.statesync_pool.best() is None and _time.monotonic() < deadline:
            _time.sleep(0.05)
        if self.statesync_pool.best() is None:
            log.warn("no snapshots discovered; skipping state sync")
            return
        lc = LightClient(
            self.genesis_doc.chain_id,
            primary=P2PLightProvider(
                self.statesync_reactor, self.genesis_doc.chain_id
            ),
            trusting_period_s=cfg.trust_period_s,
            device=self.config.base.crypto_backend,
        )
        # Count chunk applications: a failure AFTER the app ingested any
        # chunk leaves the app in an undefined partial state, and the
        # deferred-handshake fallback (start()) would init_chain on top
        # of it. The reference treats a failed sync as fatal for exactly
        # this reason (node/node.go startStateSync error path); we only
        # permit the fallback when the app was never touched.
        class _CountingSnapshotConn:
            def __init__(self, conn):
                self._conn = conn
                self.chunks_applied = 0

            def apply_snapshot_chunk(self, *a, **kw):
                self.chunks_applied += 1
                return self._conn.apply_snapshot_chunk(*a, **kw)

            def __getattr__(self, name):
                return getattr(self._conn, name)

        snap_conn = _CountingSnapshotConn(self.app_conns.snapshot)
        try:
            lc.initialize(cfg.trust_height, bytes.fromhex(cfg.trust_hash))
            provider = LightStateProvider(
                lc,
                self.genesis_doc.chain_id,
                initial_height=self.genesis_doc.initial_height,
            )
            syncer = Syncer(
                snap_conn,
                provider,
                self.statesync_reactor.fetch_chunk,
                pool=self.statesync_pool,
                temp_dir=cfg.temp_dir or None,
                chunk_fetchers=cfg.chunk_fetchers,
            )
            state, commit = syncer.sync_any()
        except StateSyncError as e:
            if snap_conn.chunks_applied:
                raise RuntimeError(
                    "state sync failed after applying snapshot chunks; "
                    "app state is undefined — refusing to fall back "
                    f"(reference startStateSync is fatal here): {e}"
                ) from e
            log.warn("state sync failed; falling back to block sync",
                     err=str(e)[:120])
            return
        except Exception as e:  # noqa: BLE001 — e.g. bad trust anchor
            if snap_conn.chunks_applied:
                raise
            log.warn("state sync aborted", err=str(e)[:120])
            return
        self.state_store.save(state)
        self.block_store.save_seen_commit(state.last_block_height, commit)
        self.blocksync_reactor.state = state
        self.consensus.reset_to_state(state)
        log.info("state sync complete", height=state.last_block_height)

    def stop(self) -> None:
        self.consensus.stop()
        self.mempool.close()  # admission drainer + gossip notifier
        self.pruner.stop()
        if self.verify_sched is not None:
            # after every verify consumer above has stopped: last
            # co-hosted chain out closes the shared scheduler
            from ..crypto.sched import release_shared

            release_shared(self.verify_sched)
            self.verify_sched = None
        if self.pex_reactor is not None:
            self.pex_reactor.stop()  # also persists the address book
        self.consensus_reactor.stop()
        self.evidence_reactor.stop()
        self.switch.stop()
        self.indexer_service.stop()
        if self.rpc_server is not None:
            self.rpc_server.stop()


def bootstrap_state(config: Config, height: int = 0,
                    rpc_servers: str = "",
                    trust_height: int = 0, trust_hash: str = "") -> int:
    """Seed a FRESH node's stores from light-client-verified state at
    `height` without running a live node (reference node/node.go:150-259
    BootstrapState): after this, `start` block-syncs from height+1
    instead of replaying from genesis or needing live statesync.

    The node home must hold genesis; the state store must be empty.
    rpc_servers (comma-separated; falls back to config.statesync) supply
    the light blocks; the trust anchor comes from the arguments or the
    statesync config. height=0 bootstraps to the primary's latest - 2
    (State() needs H+2 verifiable). Returns the bootstrapped height.
    """
    from ..light.client import LightClient
    from ..light.provider_http import HTTPProvider
    from ..statesync.provider import LightStateProvider
    from ..storage import BlockStore, StateStore, open_kv
    from ..types.genesis import GenesisDoc

    genesis = GenesisDoc.load(config.path("config/genesis.json"))
    servers = [
        s.strip()
        for s in (rpc_servers or config.statesync.rpc_servers).split(",")
        if s.strip()
    ]
    if not servers:
        raise ValueError("bootstrap-state needs at least one RPC server")
    trust_height = trust_height or config.statesync.trust_height
    trust_hash = trust_hash or config.statesync.trust_hash
    if trust_height <= 0 or not trust_hash:
        raise ValueError("bootstrap-state needs a trust height + hash")
    mem = config.base.db_backend == "mem"
    ss = StateStore(open_kv(None if mem else config.path("data/state.db")))
    existing = ss.load()
    if existing is not None and existing.last_block_height > 0:
        raise ValueError(
            f"state store already at height {existing.last_block_height}; "
            "refusing to overwrite (reset first)"
        )
    primary, *witnesses = [
        HTTPProvider(genesis.chain_id, url) for url in servers
    ]
    lc = LightClient(
        genesis.chain_id,
        primary=primary,
        witnesses=witnesses,
        trusting_period_s=config.statesync.trust_period_s,
        device=config.base.crypto_backend,
    )
    lc.initialize(trust_height, bytes.fromhex(trust_hash))
    if height == 0:
        latest = primary.light_block(0)
        if latest is None:
            raise ValueError("primary has no latest block")
        height = max(latest.height - 2, trust_height)
    provider = LightStateProvider(
        lc, genesis.chain_id, initial_height=genesis.initial_height
    )
    state = provider.state(height)
    commit = provider.commit(height)
    ss.save(state)
    bs = BlockStore(
        open_kv(None if mem else config.path("data/blockstore.db"))
    )
    bs.save_seen_commit(height, commit)
    return height
