"""JSONL span/event tracer: the port's minimal copy of
`cometbft_tpu/utils/trace.py`.

`enabled` is a plain module bool, so a hot path guards with
``if trace.enabled:`` and pays one global load when tracing is off.
`configure(path)` opens (appends to) a JSONL sink and turns tracing on;
`disable()` closes it. Each record is one JSON object per line with
``ts`` (epoch seconds), ``pid``, ``name`` and ``kind`` ("span" or
"event"), spans add ``dur_ms``, and the caller's fields follow.

The port emits only span names the reference registers (SPAN_REGISTRY
below, copied from `cometbft_tpu/utils/trace.py`), so the two backends'
traces line up.
"""

from __future__ import annotations

import json
import os
import threading
import time

enabled = False
_fh = None
_path = None
_lock = threading.Lock()

def configure(path: str) -> None:
    """Open (append) the JSONL sink at `path` and enable tracing."""
    global enabled, _fh, _path
    with _lock:
        if _fh is not None:
            _fh.close()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        _fh = open(path, "a", encoding="utf-8")
        _path = path
        enabled = True


def disable() -> None:
    global enabled, _fh, _path
    with _lock:
        enabled = False
        if _fh is not None:
            _fh.close()
        _fh = None
        _path = None


def path() -> str | None:
    return _path


def tail(n: int = 100) -> list[dict]:
    """Last `n` parsed records of the sink (the dump_trace RPC). Every
    record is flushed as it is written, so the file is whole; a line that
    does not parse is skipped."""
    p = _path
    if p is None or not os.path.exists(p):
        return []
    out = []
    with open(p, encoding="utf-8", errors="replace") as f:
        for line in f:
            try:
                out.append(json.loads(line))
            except ValueError:
                continue
    return out[-n:]


def emit(name: str, kind: str = "event", **fields) -> None:
    """Write one record and flush it. No-op (one bool check) when
    disabled."""
    if not enabled:
        return
    rec = {"ts": time.time(), "pid": os.getpid(), "name": name, "kind": kind, **fields}
    line = json.dumps(rec, separators=(",", ":"), default=str) + "\n"
    with _lock:
        if _fh is None:  # raced with disable()
            return
        _fh.write(line)
        _fh.flush()


# Every name passed to emit() in the port, with the reference's description
# (tests/test_torch_isolation.py checks both directions).
SPAN_REGISTRY = {
    "mempool.admit_window": "one micro-batched admission window: n/dup/sig_fail/app_fail/admitted + stage ms",
    "state.apply_block": "ApplyBlock with validate/finalize/commit/save stage breakdown",
    "crypto.batch_verify": "one batch-verify dispatch: path, n, modeled host/wire/device terms",
    "crypto.commit_partition": "per-curve share of one commit verification",
    "crypto.mesh_submit": "one sharded mega-batch across the verify mesh (n/b/n_devices/shard_lanes)",
    "crypto.stream_place": "one streamed commit placed on a mesh device (device/n/b)",
    "blocksync.block": "one fast-synced block: fetch→verify→apply breakdown",
    "p2p.zero_copy_send": "one multiplexed message fully packetized via memoryview slicing (chan/bytes/packets)",
    "crypto.sched_coalesce": "one shared-scheduler dispatch: n_requests/sigs/tenants/sources/per_tenant_sigs (crypto/sched.py)",
    "consensus.step": "span closing the consensus step being left (height/round/dur_ms/next)",
    "consensus.finalize_commit": "block decided at height/round, with tx count",
    "consensus.propose_speculative": "one speculative proposal assembly overlapping the previous height's commit gap (height/txs/bytes)",
    "consensus.conflicting_vote": "conflicting signed votes from one validator at one HRS (height/round/type/vote_a/vote_b hex) — the watchtower's equivocation feed",
    "tx.lifecycle": "one stage crossing of a sampled tx (tx/stage/mono; utils/txlife.py — hash-prefix sampled, correlated across nodes by tx)",
}
