"""Per-transaction lifecycle observatory (twin of
`cometbft_tpu/utils/txlife.py`).

A sampled tx-hash tracker that stamps monotonic timestamps at every
stage a transaction crosses on its way to a block:

    arrival          RPC broadcast_tx_* or mempool gossip receive
    enqueue          admission-queue submit (pipeline path)
    verify_start     window signature-verify stage opens
    verify_end       window signature-verify stage closes
    app_check        app CheckTx accepted the tx
    insert           tx entered the mempool FIFO
    reap             proposer reaped it into a proposal block
    gossip           first block-bytes/part broadcast of that proposal
    prevote_quorum   +2/3 prevotes for the block containing it
    precommit_quorum +2/3 precommits (enter_commit)
    apply            FinalizeBlock returned for its block
    commit           app Commit finished for its block
    notify           event bus published its Tx event

Sampling is a deterministic hash prefix — ``sha256(tx)[:4]`` below a
threshold derived from ``rate`` (1 in N, default 64) — so every node
samples the SAME txs without coordination, and the traceview merger can
correlate a tx's ``tx.lifecycle`` records across per-node sinks through
the existing clock alignment. Each stamp is recorded at most once per
tx per stage (first wins: re-gossiped duplicates don't restamp), with a
``mono`` perf_counter value for exact within-process deltas; analyzers
fall back to the aligned wall clock across processes.

Two consumers ride on the stamps:

* trace records (``tx.lifecycle`` events in the JSONL sink) feeding
  utils/traceview.py + tools/latency_analyze.py — the stage waterfall
  that decomposes p50/p99 commit latency;
* the per-stage Prometheus histogram of the consensus bundle, observed
  on the fly, with the tx hash attached as an exemplar so a p99 bucket
  links back to a concrete trace.

Cost model: the hot-path guard is one module bool (``txlife.enabled``),
mirroring utils/trace.py. Per SAMPLED tx the work is a few dict ops
under a small lock; per unsampled tx it is one 4-byte int compare
(callers that already hold the tx key) or one sha256 (arrival sites).
Block-sweep stamp sites (reap/quorum/apply) hash each block's txs once
and cache the sampled subset. tools/trace_overhead.py --lifecycle
measures the end-to-end block-rate cost against the <=5% budget.

Configuration: ``[instrumentation] txlife_sample_rate`` (node config)
or the ``COMETBFT_TPU_TXLIFE`` env var (wins over config; picked up at
import by subprocess nodes). 0 disables the tracker entirely. As in the
reference, the tracker starts enabled at 1 in DEFAULT_RATE. The port's
stamp sites are the mempool's (`mempool/admission.py`: enqueue,
verify_start, verify_end, app_check, insert; `mempool/mempool.py`'s
direct path the same without enqueue) and `state/execution.py::
apply_block`'s apply, commit and notify. Arrival, reap, gossip and the
quorum stamps come with the RPC, consensus and p2p slices; until then a
caller that plays the RPC's part stamps arrival with `track`.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from collections import OrderedDict

from . import trace as _trace
from .metrics import consensus_metrics, mempool_metrics

DEFAULT_RATE = 64

# (waterfall label, start stages in preference order, end stage).
# app_check spans verify_end->insert (the app round plus the µs-scale
# locked insert); apply spans precommit_quorum->commit (validate +
# FinalizeBlock + Commit).
WATERFALL = (
    ("admit_wait",    ("arrival", "enqueue"), "verify_start"),
    ("verify",        ("verify_start",),      "verify_end"),
    ("app_check",     ("verify_end",),        "insert"),
    ("proposal_wait", ("insert",),            "reap"),
    ("consensus",     ("reap",),              "precommit_quorum"),
    ("apply",         ("precommit_quorum",),  "commit"),
    ("notify",        ("commit",),            "notify"),
)
_BY_END = {end: (label, starts) for label, starts, end in WATERFALL}
_MEMPOOL_LABELS = frozenset(("admit_wait", "verify", "app_check"))

# Live per-tx stage maps, LRU-capped: txs that never commit (rejected,
# evicted, node behind) must not grow memory without bound.
MAX_LIVE = 4096

rate: int = DEFAULT_RATE
enabled: bool = rate > 0
_threshold32: int = (1 << 32) // rate if rate else 0

_lock = threading.Lock()
_live: "OrderedDict[bytes, dict[str, float]]" = OrderedDict()


def configure(sample_rate: int) -> None:
    """Set the sampling rate (1 in N; 0 disables). Node startup calls
    this with ``instrumentation.txlife_sample_rate`` unless the
    COMETBFT_TPU_TXLIFE env var already chose at import time."""
    global rate, enabled, _threshold32
    r = max(0, int(sample_rate))
    rate = r
    enabled = r > 0
    _threshold32 = (1 << 32) // r if r else 0


def reset() -> None:
    """Test hook: drop live state and restore the import-time rate."""
    with _lock:
        _live.clear()
    env = os.environ.get("COMETBFT_TPU_TXLIFE")
    if env is not None:
        try:
            configure(int(env))
            return
        except ValueError:
            pass
    configure(DEFAULT_RATE)


def key_of(tx: bytes) -> bytes:
    return hashlib.sha256(bytes(tx)).digest()


def sampled_keys(txs) -> list[tuple[int, bytes]]:
    """[(index, key)] for the sampled txs of a block/window — hash each
    tx once; callers cache the result per block."""
    if not enabled:
        return []
    th = _threshold32
    out = []
    for i, tx in enumerate(txs):
        k = hashlib.sha256(bytes(tx)).digest()
        if int.from_bytes(k[:4], "big") < th:
            out.append((i, k))
    return out


def track(tx: bytes, stage: str, **fields) -> None:
    """Stamp `stage` for a raw tx (hashes it; arrival-site helper)."""
    if enabled:
        stage_key(key_of(tx), stage, **fields)


def stage_block(pairs, stage: str, **fields) -> None:
    """Stamp `stage` for every (index, key) pair of a sampled block."""
    for _i, k in pairs:
        stage_key(k, stage, **fields)


def stage_key(key: bytes, stage: str, **fields) -> None:
    """Stamp `stage` for a tx key (first stamp per stage wins). Feeds
    the per-stage histograms and emits one tx.lifecycle trace record."""
    if not enabled or key is None:
        return
    if int.from_bytes(key[:4], "big") >= _threshold32:
        return
    now = time.perf_counter()
    delta = label = None
    e2e = None
    with _lock:
        st = _live.get(key)
        if st is None:
            st = _live[key] = {}
            while len(_live) > MAX_LIVE:
                _live.popitem(last=False)
        elif stage in st:
            return
        else:
            _live.move_to_end(key)
        st[stage] = now
        wf = _BY_END.get(stage)
        if wf is not None:
            label, starts = wf
            for s in starts:
                t0 = st.get(s)
                if t0 is not None:
                    delta = now - t0
                    break
        if stage == "commit":
            t0 = st.get("arrival")
            if t0 is not None:
                e2e = now - t0
        if stage == "notify":
            _live.pop(key, None)
    txhex = key.hex()[:16]
    if delta is not None:
        if label in _MEMPOOL_LABELS:
            mempool_metrics().tx_stage_seconds.observe(delta, label, exemplar=txhex)
        else:
            consensus_metrics().tx_stage_seconds.observe(delta, label, exemplar=txhex)
    if e2e is not None:
        consensus_metrics().tx_commit_seconds.observe(e2e, exemplar=txhex)
    if _trace.enabled:
        _trace.emit("tx.lifecycle", "event", tx=txhex, stage=stage,
                    mono=round(now, 6), **fields)


_env = os.environ.get("COMETBFT_TPU_TXLIFE")
if _env is not None:
    try:
        configure(int(_env))
    except ValueError:
        pass
del _env
