"""Node configuration (reference config/config.go + config/toml.go).

A typed Config with the reference's sections (Base, RPC, P2P, Mempool,
Consensus, BlockSync, Storage, Instrumentation), TOML persistence, and
per-section validation. The `crypto_backend` flag is the GPU seam: "cuda"
routes batch verification through the CUDA kernels, "cpu" through their
plain PyTorch versions.

Twin of `cometbft_tpu/config.py`: the same sections, keys and TOML, but
`crypto_backend` takes "cuda" or "cpu" (the reference's "tpu" / "cpu")
and defaults to "cuda". The options whose parts the port does not have
yet are read and written like the reference's; `node.Node` refuses them
by name (`node/node.py::refuse_unported`).
"""

from __future__ import annotations

import os

try:
    import tomllib
except ImportError:  # Python < 3.11: tomli is API-compatible
    import tomli as tomllib

from dataclasses import asdict, dataclass, field

CRYPTO_BACKENDS = ("cuda", "cpu")
# da/rs.py's bound on data + parity shards (GF(2^16) evaluation points);
# the port's own copy until da/ is ported
MAX_SHARDS = 4096


@dataclass
class BaseConfig:
    chain_id: str = ""
    moniker: str = "node"
    home: str = "."
    genesis_file: str = "config/genesis.json"
    priv_validator_key_file: str = "config/priv_validator_key.json"
    priv_validator_state_file: str = "data/priv_validator_state.json"
    # when set (tcp://host:port) the node LISTENS here and a remote
    # signer process dials in; FilePV is not used (reference
    # PrivValidatorListenAddr)
    priv_validator_laddr: str = ""
    node_key_file: str = "config/node_key.json"
    db_backend: str = "sqlite"  # sqlite | mem
    db_dir: str = "data"
    abci: str = "local"  # local | socket
    proxy_app: str = "unix:///tmp/app.sock"
    crypto_backend: str = "cuda"  # cuda | cpu
    # record grammar-relevant ABCI calls to data/abci_calls.log for the
    # e2e conformance checker (reference test/e2e/pkg/grammar)
    abci_call_log: bool = False
    # in-process kvstore app: take a snapshot every N heights so peers
    # can state-sync from this node (reference e2e app SnapshotInterval);
    # 0 disables
    snapshot_interval: int = 0

    def validate(self) -> None:
        if self.db_backend not in ("sqlite", "mem"):
            raise ValueError(f"unknown db_backend {self.db_backend}")
        if self.abci not in ("local", "socket"):
            raise ValueError(f"unknown abci mode {self.abci}")
        if self.crypto_backend not in CRYPTO_BACKENDS:
            raise ValueError(
                f"unknown crypto_backend {self.crypto_backend!r}: the port "
                f"takes {' or '.join(repr(b) for b in CRYPTO_BACKENDS)}")


@dataclass
class RPCConfig:
    laddr: str = "tcp://127.0.0.1:26657"
    max_body_bytes: int = 1_000_000
    # serve the unsafe_* operator routes (dial_seeds/dial_peers); off by
    # default like the reference's rpc.unsafe flag (config/config.go) —
    # anyone who can reach the listener could otherwise steer this
    # node's peer connections (eclipse-attack aid)
    unsafe: bool = False
    # gRPC services (reference [grpc] config): empty disables. The
    # privileged listener serves the pruning/data-companion API and
    # should stay on loopback.
    grpc_laddr: str = ""
    grpc_privileged_laddr: str = ""

    def validate(self) -> None:
        if self.max_body_bytes <= 0:
            raise ValueError("max_body_bytes must be positive")


@dataclass
class P2PConfig:
    laddr: str = "tcp://127.0.0.1:26656"
    persistent_peers: str = ""  # comma-separated host:port
    pex: bool = True
    addr_book_file: str = "config/addrbook.json"
    # refuse non-routable addresses in the book (reference
    # addr_book_strict). Off by default: this reproduction's nets run
    # on loopback, which strict mode would reject wholesale.
    addr_book_strict: bool = False
    # seed-crawler mode (reference p2p.seed_mode): crawl addresses,
    # serve addrs-on-request, never hold full peers
    seed_mode: bool = False
    # comma-separated host:port seed nodes dialed when the address book
    # cannot supply peers (reference p2p.seeds)
    seeds: str = ""
    # cadence of the PEX ensure-peers loop (or the crawl loop in seed
    # mode); e2e nets tighten this for fast seed-only bootstrap
    pex_interval_s: float = 30.0
    max_inbound_peers: int = 40
    max_outbound_peers: int = 10
    send_rate: int = 512_000  # bytes/s (reference 500 KB/s default)
    recv_rate: int = 512_000
    # data bytes per MConnection packet. 1024 keeps the reference's wire
    # shape; the receive path is frame-size-agnostic, so peers at
    # different sizes interoperate (e2e nets raise this — fewer
    # header/seal round-trips per block part)
    max_packet_payload_size: int = 1024
    # arm the fault-injection control channel (data/partition.json ->
    # transport-level peer blocking) — test harness only; a production
    # node must not expose a file that silently isolates it
    fault_injection: bool = False

    def validate(self) -> None:
        if self.max_inbound_peers < 0 or self.max_outbound_peers < 0:
            raise ValueError("peer limits must be >= 0")
        if self.pex_interval_s <= 0:
            raise ValueError("pex_interval_s must be positive")
        if self.seed_mode and not self.pex:
            raise ValueError("seed_mode requires pex")
        if self.max_packet_payload_size <= 0:
            raise ValueError("max_packet_payload_size must be positive")

    @staticmethod
    def _addr_list(raw: str) -> list[tuple[str, int]]:
        out = []
        for item in filter(None, raw.split(",")):
            host, port = item.strip().rsplit(":", 1)
            out.append((host, int(port)))
        return out

    def persistent_peer_list(self) -> list[tuple[str, int]]:
        return self._addr_list(self.persistent_peers)

    def seed_list(self) -> list[tuple[str, int]]:
        return self._addr_list(self.seeds)


@dataclass
class MempoolConfig:
    size: int = 5000
    cache_size: int = 10000
    max_tx_bytes: int = 1_048_576
    keep_invalid_txs_in_cache: bool = False
    # cap tx gossip fan-out per broadcast; 0 floods every peer
    # (reference's experimental max-gossip-connections bound)
    experimental_max_gossip_connections: int = 0
    # micro-batched admission pipeline: windows of up to
    # `admission_window` txs drained after at most
    # `admission_max_delay_ms` (latency bound), amortizing the app
    # round-trip, batch signature verify, and lock acquisition.
    # admission_window=0 disables the pipeline (per-tx admission).
    admission_window: int = 256
    admission_max_delay_ms: float = 2.0
    # batch-verify ed25519 signatures of STX-enveloped txs at admission
    admission_verify_sigs: bool = True

    def validate(self) -> None:
        if self.size <= 0 or self.cache_size <= 0:
            raise ValueError("mempool sizes must be positive")
        if self.admission_window < 0 or self.admission_max_delay_ms < 0:
            raise ValueError("admission window/delay must be >= 0")


@dataclass
class ConsensusConfig:
    wal_file: str = "data/cs.wal"
    timeout_propose: float = 3.0
    timeout_propose_delta: float = 0.5
    timeout_prevote: float = 1.0
    timeout_prevote_delta: float = 0.5
    timeout_precommit: float = 1.0
    timeout_precommit_delta: float = 0.5
    timeout_commit: float = 1.0
    # speculative proposal assembly: when this node is the
    # next height's proposer, reap + build the proposal block in the
    # background during the previous height's commit gap; enter_propose
    # consumes it only if (height, last-commit, state, mempool) still
    # match, else discards bit-safely and rebuilds cold
    speculative_propose: bool = True
    # certificate-native consensus: on all-BLS validator
    # sets, precommits adopt the proposal timestamp so +2/3 folds into
    # ONE aggregate certificate — gossiped to lagging peers as a single
    # frame, embedded as the block's LastCommit, and stored canonically.
    # Mixed/ed25519 sets never fold, so wire and store bytes stay
    # identical to the pre-certificate format regardless of this flag.
    # Kept for the TOML round trip; the port's Node does not pass it on
    # (its validator sets are Ed25519 only).
    cert_native: bool = True

    def validate(self) -> None:
        for name in ("timeout_propose", "timeout_prevote", "timeout_precommit",
                     "timeout_commit"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be >= 0")

    def timeouts(self):
        from .consensus.state import TimeoutConfig

        return TimeoutConfig(
            propose=self.timeout_propose,
            propose_delta=self.timeout_propose_delta,
            prevote=self.timeout_prevote,
            prevote_delta=self.timeout_prevote_delta,
            precommit=self.timeout_precommit,
            precommit_delta=self.timeout_precommit_delta,
            commit=self.timeout_commit,
        )


@dataclass
class BlockSyncConfig:
    enable: bool = True
    verify_mode: str = "batched"  # batched | full
    window: int = 32

    def validate(self) -> None:
        if self.verify_mode not in ("batched", "full"):
            raise ValueError(f"unknown verify_mode {self.verify_mode}")


@dataclass
class StateSyncConfig:
    """reference config.StateSyncConfig (config/config.go StateSync
    section): opt-in snapshot restore on boot, anchored at a trusted
    header (hash must come from an out-of-band source)."""

    enable: bool = False
    trust_height: int = 0
    trust_hash: str = ""
    trust_period_s: int = 7 * 24 * 3600
    discovery_time_s: float = 2.0
    chunk_fetchers: int = 4
    temp_dir: str = ""
    # comma-separated RPC endpoints for light-client verification
    # (reference statesync.rpc_servers); used by `bootstrap-state` and
    # available to operators running statesync against known nodes
    rpc_servers: str = ""

    def validate(self) -> None:
        if self.enable:
            if self.trust_height <= 0:
                raise ValueError("statesync.trust_height required when enabled")
            if not self.trust_hash:
                raise ValueError("statesync.trust_hash required when enabled")


@dataclass
class StorageConfig:
    discard_abci_responses: bool = False
    # heights of full signature columns kept beside a certificate-native
    # canonical seen commit (evidence window) — older columns
    # are dropped, the certificate remains verifiable forever
    full_commit_window: int = 64

    def validate(self) -> None:
        if self.full_commit_window < 0:
            raise ValueError("storage.full_commit_window must be >= 0")


@dataclass
class LightConfig:
    """Light-client streaming service (light/serve.py, ROADMAP #2).

    When `serve` is on, the node maintains an MMR accumulator over
    committed headers, exposes light_status/light_mmr_proof/light_bisect
    routes, and streams header+proof payloads at /light_stream. The
    verified-commit cache amortizes each height's batch verify across
    all subscribers."""

    serve: bool = False
    # verified-commit cache entries (heights) kept resident
    cache_size: int = 4096
    # per-subscriber payload queue bound; overflow drops oldest
    subscriber_queue: int = 4096
    # persist the MMR accumulator in the light column of the node DB
    # (mem-backed nodes rebuild from the block store on restart)
    persist_mmr: bool = True

    def validate(self) -> None:
        if self.cache_size <= 0:
            raise ValueError("light.cache_size must be positive")
        if self.subscriber_queue <= 0:
            raise ValueError("light.subscriber_queue must be positive")


@dataclass
class DAConfig:
    """Data-availability sampling (da/, ROADMAP #3).

    When `enabled`, every committed block's payload is split into
    `data_shards` chunks, extended with `parity_shards` Reed-Solomon
    parity chunks over GF(2^16), and committed to in the header's
    da_root. The node serves per-chunk opening proofs on da_sample and
    advertises the commitment on /light_stream; sampling clients
    (da/sampler.py) reach `confidence` that at least half the extended
    chunks — enough to reconstruct — are available."""

    enabled: bool = False
    data_shards: int = 16
    parity_shards: int = 16
    # samples each client draws per block; 0 derives the count from
    # `confidence` (da/sampler.py samples_for_confidence)
    samples_per_client: int = 0
    confidence: float = 0.99
    # extended-shard sets kept resident for serving samples
    retain_heights: int = 64
    # 2D polynomial-commitment track (da/pc.py, ROADMAP #1): per-column
    # KZG commitments + row/column erasure, bound into da_root via the
    # combined 0x04 root. Constant 48 B multiproof openings replace the
    # growing Merkle path; parity-linearity catches a lying encoder
    # with no fraud proofs.
    pc: bool = False
    pc_data_cols: int = 4
    pc_parity_cols: int = 4
    # payloads needing more data rows than this skip the PC track for
    # that height (opening cost scales with the column degree)
    pc_max_rows: int = 1024

    def validate(self) -> None:
        if self.data_shards < 1 or self.parity_shards < 1:
            raise ValueError("da shard counts must be >= 1")
        if self.pc_data_cols < 1 or self.pc_parity_cols < 1:
            raise ValueError("da pc column counts must be >= 1")
        if self.pc_max_rows < 1:
            raise ValueError("da.pc_max_rows must be >= 1")
        if self.data_shards + self.parity_shards > MAX_SHARDS:
            raise ValueError(
                f"da.data_shards + da.parity_shards must be <= {MAX_SHARDS}"
            )
        if self.samples_per_client < 0:
            raise ValueError("da.samples_per_client must be >= 0")
        if not (0.0 < self.confidence < 1.0):
            raise ValueError("da.confidence must be in (0, 1)")
        if self.retain_heights < 1:
            raise ValueError("da.retain_heights must be >= 1")


@dataclass
class ReplicationConfig:
    """Scale-out serving plane (replication/, ROADMAP #3).

    When `serve` is on (core role), the node publishes every committed
    height as one frame — header, validator set, canonical + seen
    commits, verified-commit certificate, 1x DA payload — on the
    resumable `/replication_feed` stream, retains the last
    `retain_frames` frames for cursor replay, and serves a bootstrap
    snapshot (MMR leaf sequence + retained frames) over
    replication_snapshot / replication_snapshot_chunk. Stateless
    replicas (`cli.py replica`, replication/replica.py) consume the
    feed and serve /light_stream, MMR proofs, bisection, DA samples and
    admission forwarding byte-identically with zero consensus state.
    The replica-role fields (core_url and below) are ignored by a core
    node; `cli.py replica` reads them."""

    serve: bool = False
    # frames kept resident for cursor replay; a replica whose cursor
    # falls behind this window re-bootstraps from the snapshot
    retain_frames: int = 1024
    # snapshot blob chunking for the statesync-shaped fetch protocol
    snapshot_chunk_bytes: int = 262144
    # ---- replica role (cli.py replica) ----
    core_url: str = ""  # http://host:port of the core feed
    # verify + forward broadcast_tx_* to the core through the replica's
    # own admission window (replica registers as its own DRR tenant)
    forward_admission: bool = True
    # healthz readiness: 503 while the feed-lag gauge exceeds this
    max_lag_heights: int = 16
    # replica tenant name on the shared VerifyScheduler ("" derives one)
    tenant: str = ""

    def validate(self) -> None:
        if self.retain_frames < 1:
            raise ValueError("replication.retain_frames must be >= 1")
        if self.snapshot_chunk_bytes < 1:
            raise ValueError(
                "replication.snapshot_chunk_bytes must be >= 1")
        if self.max_lag_heights < 0:
            raise ValueError("replication.max_lag_heights must be >= 0")


@dataclass
class WatchtowerConfig:
    """Streaming safety auditor (watchtower/, ROADMAP #5).

    Read by `cli.py watchtower`, never by a node: the auditor is a
    stateless external process that tails N core nodes' replication
    feeds (plus optional trace sinks) and runs the safety/liveness
    checks online. Core nodes only need `[replication] serve = true`.
    """

    # comma-separated core RPC base URLs (http://host:port) to audit
    node_urls: str = ""
    # comma-separated trace-sink paths for the online stall classifier
    # and the equivocation feed; empty disables trace-driven checks
    trace_sinks: str = ""
    # re-derive CertCommits against the retained column inside this
    # window of the tip (mirrors the store's full_commit_window)
    full_commit_window: int = 16
    # DA withholding watchdog cadence and per-sweep sample count
    da_interval_s: float = 2.0
    da_samples: int = 4
    # consecutive failed/stalled DA sweeps before the alarm raises
    da_alarm_after: int = 2
    # online stall classifier poll cadence
    stall_interval_s: float = 1.0
    # structured JSONL verdict log ("" = trace sink only)
    verdict_path: str = ""

    def validate(self) -> None:
        if self.full_commit_window < 0:
            raise ValueError(
                "watchtower.full_commit_window must be >= 0")
        if self.da_interval_s <= 0:
            raise ValueError("watchtower.da_interval_s must be positive")
        if self.da_samples < 1:
            raise ValueError("watchtower.da_samples must be >= 1")
        if self.da_alarm_after < 1:
            raise ValueError("watchtower.da_alarm_after must be >= 1")
        if self.stall_interval_s <= 0:
            raise ValueError(
                "watchtower.stall_interval_s must be positive")


@dataclass
class SchedConfig:
    """Shared verification scheduler (crypto/sched.py, ROADMAP #4).

    When `enabled`, every verify consumer on the node — consensus
    commit checks, blocksync replay windows, light-serve cache misses,
    mempool admission sig windows — submits its filled batch verifier
    to one process-wide scheduler (keyed by crypto backend) instead of
    dispatching directly. The scheduler coalesces concurrent requests
    into mega-batches bounded by `max_coalesce_sigs` /
    `max_coalesce_delay_ms` and services tenants (chain_ids) by
    deficit-round-robin weighted by `tenant_weight`. A lone request
    passes straight through with no added latency."""

    enabled: bool = True
    max_coalesce_sigs: int = 16384
    max_coalesce_delay_ms: float = 2.0
    stop_timeout_s: float = 2.0
    # this node's DRR weight when several chains share the scheduler
    tenant_weight: float = 1.0

    def validate(self) -> None:
        if self.max_coalesce_sigs < 1:
            raise ValueError("sched.max_coalesce_sigs must be >= 1")
        if self.max_coalesce_delay_ms < 0:
            raise ValueError("sched.max_coalesce_delay_ms must be >= 0")
        if self.stop_timeout_s <= 0:
            raise ValueError("sched.stop_timeout_s must be positive")
        if self.tenant_weight <= 0:
            raise ValueError("sched.tenant_weight must be positive")


@dataclass
class InstrumentationConfig:
    prometheus: bool = False
    prometheus_listen_addr: str = ":26660"
    # metric-name prefix (reference instrumentation.namespace)
    namespace: str = "cometbft"
    # JSONL span/event sink (utils/trace.py); empty disables tracing.
    # Relative paths resolve under the node home. The COMETBFT_TPU_TRACE
    # env var overrides at process level (subprocess nodes, bench.py).
    trace_sink: str = ""
    # tx lifecycle observatory (utils/txlife.py): sample 1 in N txs by
    # hash prefix; 0 disables. The COMETBFT_TPU_TXLIFE env var wins
    # over this (subprocess nodes, overhead harness).
    txlife_sample_rate: int = 64
    # /healthz on the metrics server: 200 while consensus height
    # advanced within this many seconds, 503 after
    healthz_window_s: float = 30.0

    def validate(self) -> None:
        if self.prometheus:
            addr = self.prometheus_listen_addr
            _, _, port = addr.rpartition(":")
            if not port.isdigit():
                raise ValueError(
                    "instrumentation.prometheus_listen_addr must end in"
                    f" :<port>, got {addr!r}"
                )
        if not self.namespace:
            raise ValueError("instrumentation.namespace must be non-empty")
        if self.txlife_sample_rate < 0:
            raise ValueError(
                "instrumentation.txlife_sample_rate must be >= 0")
        if self.healthz_window_s <= 0:
            raise ValueError(
                "instrumentation.healthz_window_s must be positive")


@dataclass
class Config:
    base: BaseConfig = field(default_factory=BaseConfig)
    rpc: RPCConfig = field(default_factory=RPCConfig)
    p2p: P2PConfig = field(default_factory=P2PConfig)
    mempool: MempoolConfig = field(default_factory=MempoolConfig)
    consensus: ConsensusConfig = field(default_factory=ConsensusConfig)
    blocksync: BlockSyncConfig = field(default_factory=BlockSyncConfig)
    statesync: StateSyncConfig = field(default_factory=StateSyncConfig)
    storage: StorageConfig = field(default_factory=StorageConfig)
    light: LightConfig = field(default_factory=LightConfig)
    da: DAConfig = field(default_factory=DAConfig)
    replication: ReplicationConfig = field(
        default_factory=ReplicationConfig)
    watchtower: WatchtowerConfig = field(
        default_factory=WatchtowerConfig)
    sched: SchedConfig = field(default_factory=SchedConfig)
    instrumentation: InstrumentationConfig = field(
        default_factory=InstrumentationConfig
    )

    def validate(self) -> None:
        for section in (self.base, self.rpc, self.p2p, self.mempool,
                        self.consensus, self.blocksync, self.statesync,
                        self.storage, self.light, self.da, self.replication,
                        self.watchtower, self.sched, self.instrumentation):
            section.validate()

    # -- paths ----------------------------------------------------------
    def path(self, rel: str) -> str:
        return os.path.join(self.base.home, rel)

    # -- TOML -----------------------------------------------------------
    def to_toml(self) -> str:
        def esc(s: str) -> str:
            # TOML basic-string escaping: a moniker or path containing a
            # quote/backslash must survive a save/load round trip.
            return (
                str(s)
                .replace("\\", "\\\\")
                .replace('"', '\\"')
                .replace("\n", "\\n")
                .replace("\t", "\\t")
            )

        def emit(name, obj):
            lines = [f"[{name}]"]
            for k, v in asdict(obj).items():
                if isinstance(v, bool):
                    lines.append(f"{k} = {'true' if v else 'false'}")
                elif isinstance(v, (int, float)):
                    lines.append(f"{k} = {v}")
                else:
                    lines.append(f'{k} = "{esc(v)}"')
            return "\n".join(lines)

        parts = [
            emit("base", self.base),
            emit("rpc", self.rpc),
            emit("p2p", self.p2p),
            emit("mempool", self.mempool),
            emit("consensus", self.consensus),
            emit("blocksync", self.blocksync),
            emit("statesync", self.statesync),
            emit("storage", self.storage),
            emit("light", self.light),
            emit("da", self.da),
            emit("replication", self.replication),
            emit("watchtower", self.watchtower),
            emit("sched", self.sched),
            emit("instrumentation", self.instrumentation),
        ]
        return "\n\n".join(parts) + "\n"

    @classmethod
    def from_toml(cls, raw: str) -> "Config":
        d = tomllib.loads(raw)

        def mk(section_cls, sd):
            # forward compatibility: a config written by a NEWER build
            # may carry keys this build does not know; dropping them
            # (with a warning) instead of crashing is what lets a node
            # downgrade/upgrade across builds with one config file
            # (reference viper-based loading is tolerant the same way)
            from dataclasses import fields as _fields

            known = {f.name for f in _fields(section_cls)}
            unknown = [k for k in sd if k not in known]
            if unknown:
                from .utils.log import logger

                logger("config").warn(
                    "ignoring unknown config keys",
                    section=section_cls.__name__,
                    keys=",".join(sorted(unknown)),
                )
            return section_cls(**{k: v for k, v in sd.items() if k in known})

        cfg = cls(
            base=mk(BaseConfig, d.get("base", {})),
            rpc=mk(RPCConfig, d.get("rpc", {})),
            p2p=mk(P2PConfig, d.get("p2p", {})),
            mempool=mk(MempoolConfig, d.get("mempool", {})),
            consensus=mk(ConsensusConfig, d.get("consensus", {})),
            blocksync=mk(BlockSyncConfig, d.get("blocksync", {})),
            statesync=mk(StateSyncConfig, d.get("statesync", {})),
            storage=mk(StorageConfig, d.get("storage", {})),
            light=mk(LightConfig, d.get("light", {})),
            da=mk(DAConfig, d.get("da", {})),
            replication=mk(ReplicationConfig, d.get("replication", {})),
            watchtower=mk(WatchtowerConfig, d.get("watchtower", {})),
            sched=mk(SchedConfig, d.get("sched", {})),
            instrumentation=mk(InstrumentationConfig,
                               d.get("instrumentation", {})),
        )
        cfg.validate()
        return cfg

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(self.to_toml())

    @classmethod
    def load(cls, path: str) -> "Config":
        with open(path) as f:
            return cls.from_toml(f.read())
