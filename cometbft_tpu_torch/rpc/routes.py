"""RPC route handlers (reference rpc/core/routes.go + rpc/core/*.go).

Every handler takes the Env (handles to the node's stores and services,
reference rpc/core/env.go) and JSON params, returning JSON-able dicts.
Bytes are hex-encoded strings; blocks/commits are rendered structurally.

Twin of `cometbft_tpu/rpc/routes.py`: every route keeps its name and its
JSON. The light, DA and replication routes answer with the reference's
"disabled" error; those surfaces are not in the port yet.
"""

from __future__ import annotations

import base64

from ..crypto import merkle
from ..crypto.keys import tmhash
from ..mempool.mempool import ErrMempoolFull, ErrTxInCache, ErrTxTooLarge
from ..utils import txlife as _txlife


class RPCError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


class Env:
    """reference rpc/core/env.go Environment."""

    def __init__(self, *, block_store=None, state_store=None, consensus=None,
                 mempool=None, switch=None, event_bus=None, tx_indexer=None,
                 block_indexer=None, genesis_doc=None, app_conns=None,
                 node_info=None, evidence_pool=None, pex_reactor=None,
                 consensus_reactor=None):
        self.evidence_pool = evidence_pool
        self.pex_reactor = pex_reactor
        self.consensus_reactor = consensus_reactor
        self.block_store = block_store
        self.state_store = state_store
        self.consensus = consensus
        self.mempool = mempool
        self.switch = switch
        self.event_bus = event_bus
        self.tx_indexer = tx_indexer
        self.block_indexer = block_indexer
        self.genesis_doc = genesis_doc
        self.app_conns = app_conns
        self.node_info = node_info


def _b64(b: bytes) -> str:
    return base64.b64encode(b).decode()


def _hx(b: bytes | None) -> str:
    return (b or b"").hex().upper()


def _block_id_json(bid) -> dict:
    return {
        "hash": _hx(bid.hash),
        "parts": {
            "total": bid.part_set_header.total,
            "hash": _hx(bid.part_set_header.hash),
        },
    }


def _header_json(h) -> dict:
    # Full fidelity: every hashed field travels (version and the part-set
    # half of last_block_id are part of the header hash), so a client can
    # rebuild the Header and recompute its hash (rpc/codec.py is the
    # inverse; reference light/provider/http relies on the same property).
    return {
        "version": {"block": str(h.version.block), "app": str(h.version.app)},
        "chain_id": h.chain_id,
        "height": str(h.height),
        "time": {"seconds": h.time.seconds, "nanos": h.time.nanos},
        "last_block_id": _block_id_json(h.last_block_id),
        "last_commit_hash": _hx(h.last_commit_hash),
        "data_hash": _hx(h.data_hash),
        "validators_hash": _hx(h.validators_hash),
        "next_validators_hash": _hx(h.next_validators_hash),
        "consensus_hash": _hx(h.consensus_hash),
        "app_hash": _hx(h.app_hash),
        "last_results_hash": _hx(h.last_results_hash),
        "evidence_hash": _hx(h.evidence_hash),
        "proposer_address": _hx(h.proposer_address),
        "da_root": _hx(h.da_root),
    }


def _commit_json(c) -> dict:
    return {
        "height": str(c.height),
        "round": c.round,
        "block_id": _block_id_json(c.block_id),
        "signatures": [
            {
                "block_id_flag": int(cs.block_id_flag),
                "validator_address": _hx(cs.validator_address),
                "timestamp": {"seconds": cs.timestamp.seconds,
                              "nanos": cs.timestamp.nanos},
                "signature": _hx(cs.signature),
            }
            for cs in c.signatures
        ],
    }


def _block_json(b) -> dict:
    return {
        "header": _header_json(b.header),
        "data": {"txs": [_hx(tx) for tx in b.data.txs]},
        "last_commit": _commit_json(b.last_commit),
    }


# ------------------------------------------------------------------ routes
def health(env, params):
    return {}


def dump_trace(env, params):
    """Tail of the node's trace sink (observability debug aid).

    Returns the last `n` JSONL records (default 100, hard cap 1000 so a
    large sink can't balloon the RPC response) written by utils.trace;
    empty when tracing is disabled. `limit` is accepted as an alias for
    `n` (cosmos-style paging name). Optional filters: `name` keeps
    records whose span name contains the substring (e.g. ``name=p2p.``
    for the wire hooks), `kind` requires an exact kind ("span" or
    "event"), `tenant` keeps records touching that tenant (a record's
    ``tenant`` field, or membership in its comma-separated ``tenants``
    list — the shared-scheduler coalesce spans carry the latter). With
    filters, the last `n` MATCHING records out of the newest 1000 are
    returned.
    """
    from ..utils import trace

    n = int(params.get("limit", params.get("n", 100)) or 100)
    n = max(1, min(n, 1000))
    name = str(params.get("name", "") or "")
    kind = str(params.get("kind", "") or "")
    tenant = str(params.get("tenant", "") or "")

    def _tenant_match(r):
        if not tenant:
            return True
        if str(r.get("tenant", "")) == tenant:
            return True
        ts = r.get("tenants", "")
        if isinstance(ts, str):
            return tenant in ts.split(",")
        return isinstance(ts, (list, tuple)) and tenant in ts

    if not trace.enabled:
        records = []
    elif name or kind or tenant:
        records = [
            r for r in trace.tail(1000)
            if (not name or name in str(r.get("name", "")))
            and (not kind or r.get("kind") == kind)
            and _tenant_match(r)
        ][-n:]
    else:
        records = trace.tail(n)
    return {
        "enabled": trace.enabled,
        "path": trace.path() or "",
        "records": records,
    }


def status(env, params):
    bs = env.block_store
    latest = bs.height() if bs else 0
    header = None
    if bs and latest:
        blk = bs.load_block(latest)
        header = blk.header if blk else None
    return {
        "node_info": {
            "id": env.node_info.node_id if env.node_info else "",
            "network": env.genesis_doc.chain_id if env.genesis_doc else "",
            "moniker": env.node_info.moniker if env.node_info else "",
            "version": env.node_info.version if env.node_info else "",
        },
        "sync_info": {
            "latest_block_height": str(latest),
            "latest_block_hash": _hx(header.hash() if header else b""),
            "latest_app_hash": _hx(
                env.consensus.sm_state.app_hash if env.consensus else b""
            ),
            "catching_up": False,
        },
        "validator_info": {
            "address": _hx(
                env.consensus.privval.address()
                if env.consensus and env.consensus.privval else b""
            ),
        },
    }


def abci_info(env, params):
    info = env.app_conns.query.info()
    return {
        "response": {
            "data": info.data,
            "version": info.version,
            "last_block_height": str(info.last_block_height),
            "last_block_app_hash": _hx(info.last_block_app_hash),
        }
    }


def abci_query(env, params):
    path = params.get("path", "")
    data = bytes.fromhex(params.get("data", ""))
    height = int(params.get("height", 0))
    r = env.app_conns.query.query(path, data, height)
    return {
        "response": {
            "code": r.code,
            "key": _hx(r.key),
            "value": _hx(r.value),
            "height": str(r.height),
            "log": r.log,
        }
    }


def _get_height(env, params, default_latest=True):
    h = params.get("height")
    if h is None:
        if not default_latest:
            raise RPCError(-32602, "height required")
        return env.block_store.height()
    return int(h)


def block(env, params):
    h = _get_height(env, params)
    blk = env.block_store.load_block(h)
    if blk is None:
        raise RPCError(-32603, f"no block at height {h}")
    return {"block_id": {"hash": _hx(blk.hash())}, "block": _block_json(blk)}


def block_by_hash(env, params):
    want = bytes.fromhex(params.get("hash", ""))
    blk = env.block_store.load_block_by_hash(want)
    if blk is not None:
        return {"block_id": {"hash": _hx(want)}, "block": _block_json(blk)}
    raise RPCError(-32603, "block not found")


def header(env, params):
    h = _get_height(env, params)
    blk = env.block_store.load_block(h)
    if blk is None:
        raise RPCError(-32603, f"no block at height {h}")
    return {"header": _header_json(blk.header)}


def header_by_hash(env, params):
    """Header lookup by block hash (reference rpc/core/blocks.go:108
    HeaderByHash; an absent block returns an empty result, not an
    error, matching the reference)."""
    want = bytes.fromhex(params.get("hash", ""))
    blk = env.block_store.load_block_by_hash(want)
    if blk is None:
        return {"header": None}
    return {"header": _header_json(blk.header)}


def blockchain(env, params):
    """BlockchainInfo: block metas for [min_height, max_height], newest
    first, at most 20 (reference rpc/core/blocks.go:27 BlockchainInfo +
    filterMinMax :59 — zero means "default", min is clamped to the store
    base so pruned heights degrade gracefully)."""
    limit = 20
    bs = env.block_store
    base, height = bs.base(), bs.height()
    try:
        mn = int(params.get("min_height", 0) or 0)
        mx = int(params.get("max_height", 0) or 0)
    except (TypeError, ValueError):
        raise RPCError(-32602, "min_height/max_height must be integers")
    if mn < 0 or mx < 0:
        raise RPCError(-32602, "heights must be non-negative")
    mn = mn or 1
    mx = min(height, mx or height)
    mn = max(base, mn, mx - limit + 1)
    if mn > mx:
        raise RPCError(
            -32602, f"min height {mn} can't be greater than max height {mx}"
        )
    metas = []
    for h in range(mx, mn - 1, -1):
        meta = bs.load_block_meta(h)
        if meta is None:
            continue
        blk, size = meta
        metas.append({
            "block_id": {"hash": _hx(blk.hash())},
            "block_size": str(size),
            "header": _header_json(blk.header),
            "num_txs": str(len(blk.data.txs)),
        })
    return {"last_height": str(height), "block_metas": metas}


def commit(env, params):
    h = _get_height(env, params)
    blk = env.block_store.load_block(h)
    c = env.block_store.load_block_commit(h) or env.block_store.load_seen_commit(h)
    if blk is None or c is None:
        raise RPCError(-32603, f"no commit at height {h}")
    return {
        "signed_header": {
            "header": _header_json(blk.header),
            "commit": _commit_json(c),
        },
        "canonical": env.block_store.load_block_commit(h) is not None,
    }


def block_results(env, params):
    h = _get_height(env, params)
    if env.state_store is None:
        raise RPCError(-32603, "state store unavailable")
    rhash = env.state_store.load_finalize_response(h)
    out = {"height": str(h), "results_hash": _hx(rhash or b"")}
    raw = env.state_store.load_abci_responses(h)
    if raw:
        from ..abci import wire as W

        resp = W.dec_finalize_resp(raw)
        out["txs_results"] = [
            {
                "code": tr.code,
                "data": _hx(tr.data),
                "log": tr.log,
                "gas_wanted": str(tr.gas_wanted),
                "gas_used": str(tr.gas_used),
            }
            for tr in resp.tx_results
        ]
        out["validator_updates"] = [
            {
                "pub_key": _hx(vu.pub_key_bytes),
                "pub_key_type": vu.pub_key_type,
                "power": str(vu.power),
            }
            for vu in resp.validator_updates
        ]
        out["app_hash"] = _hx(resp.app_hash)
    return out


def validators(env, params):
    h = _get_height(env, params)
    vals = env.state_store.load_validators(h) if env.state_store else None
    if vals is None:
        raise RPCError(-32603, f"no validators at height {h}")
    return {
        "block_height": str(h),
        "validators": [
            {
                "address": _hx(v.address),
                "pub_key": _hx(v.pub_key.bytes()),
                "pub_key_type": v.pub_key.type_tag(),
                "voting_power": str(v.voting_power),
                "proposer_priority": str(v.proposer_priority),
            }
            for v in vals.validators
        ],
        "count": str(len(vals)),
        "total": str(len(vals)),
    }


def genesis(env, params):
    import json as _json

    return {"genesis": _json.loads(env.genesis_doc.to_json())}


def net_info(env, params):
    peers = env.switch.peers() if env.switch else []
    return {
        "listening": True,
        "n_peers": str(len(peers)),
        "peers": [
            {"node_info": {"id": p.id, "moniker": p.node_info.moniker}}
            for p in peers
        ],
    }


def _rs_lock(cs):
    """The consensus round-state mutex (consensus.state rs_mutex): the
    consensus thread holds it across every _process, so acquiring it
    here yields a snapshot that cannot mix two heights' fields. Stubbed
    consensus objects (tests) without the mutex degrade to lock-free."""
    lock = getattr(cs, "rs_mutex", None)
    if lock is None:
        import contextlib

        return contextlib.nullcontext()
    return lock


def consensus_state(env, params):
    cs = env.consensus
    with _rs_lock(cs):
        return {
            "round_state": {
                "height": str(cs.height),
                "round": cs.round,
                "step": int(cs.step),
                "locked_round": cs.locked_round,
                "valid_round": cs.valid_round,
            }
        }


def _vote_set_json(vs) -> dict | None:
    if vs is None:
        return None
    ba = vs.bit_array()
    maj, ok = vs.two_thirds_majority()
    return {
        "votes_bit_array": "".join(
            "x" if ba.get(i) else "_" for i in range(ba.size())
        ),
        "count": vs.size(),
        "two_thirds_majority": _block_id_json(maj) if ok and maj else None,
    }


def dump_consensus_state(env, params):
    """Full round-state dump plus per-peer consensus states (reference
    rpc/core/consensus.go:56 DumpConsensusState). The concise summary
    lives at consensus_state; this one carries the vote bitmaps and the
    reactor's per-peer (height, round, step) view for operators
    debugging a stall.

    Consistency: the consensus thread mutates the round state
    concurrently, and a naive field-by-field read could mix heights
    (e.g. height N's round with height N+1's locked block). The gather
    runs under cs.rs_mutex — held by the consensus thread across each
    _process transition — so the snapshot is a single consistent round
    state, replacing the old sample-and-retry heuristic (which could
    still return a torn snapshot after its retry budget)."""
    cs = env.consensus
    with _rs_lock(cs):
        votes = []
        hvs = cs.votes
        for r in sorted(hvs._sets):
            votes.append({
                "round": r,
                "prevotes": _vote_set_json(hvs.prevotes(r)),
                "precommits": _vote_set_json(hvs.precommits(r)),
            })
        rs = {
            "height": str(cs.height),
            "round": cs.round,
            "step": int(cs.step),
            "locked_round": cs.locked_round,
            "locked_block_hash": _hx(
                cs.locked_block.hash()
                if getattr(cs, "locked_block", None) else b""
            ),
            "valid_round": cs.valid_round,
            "valid_block_hash": _hx(
                cs.valid_block.hash()
                if getattr(cs, "valid_block", None) else b""
            ),
            "proposal": cs.proposal is not None,
            "height_vote_set": votes,
        }
    peers = []
    reactor = env.consensus_reactor
    if reactor is not None:
        for ps in list(reactor._peers.values()):
            peers.append({
                "node_address": ps.peer.id,
                "peer_state": {
                    "height": str(ps.height),
                    "round": ps.round,
                    "step": ps.step,
                    "last_commit_round": ps.last_commit_round,
                    "proposal_seen": ps.proposal_seen,
                },
            })
    return {"round_state": rs, "peers": peers}


def check_tx(env, params):
    """Run CheckTx against the app without touching the mempool
    (reference rpc/core/mempool.go:188 CheckTx)."""
    tx = bytes.fromhex(params["tx"])
    r = env.app_conns.mempool.check_tx(tx)
    return {
        "code": r.code,
        "data": _hx(r.data),
        "log": r.log,
        "gas_wanted": str(r.gas_wanted),
    }


def consensus_params(env, params):
    p = env.consensus.sm_state.consensus_params
    return {
        "consensus_params": {
            "block": {"max_bytes": str(p.block.max_bytes),
                      "max_gas": str(p.block.max_gas)},
            "evidence": {
                "max_age_num_blocks": str(p.evidence.max_age_num_blocks),
                "max_bytes": str(p.evidence.max_bytes),
            },
        }
    }


def broadcast_tx_sync(env, params):
    tx = bytes.fromhex(params["tx"])
    if _txlife.enabled:
        _txlife.track(tx, "arrival", src="rpc")
    try:
        env.mempool.check_tx(tx)
        code, log = 0, ""
    except (ErrTxInCache, ErrMempoolFull, ErrTxTooLarge, ValueError) as e:
        code, log = 1, str(e)
    return {"code": code, "log": log, "hash": _hx(tmhash(tx))}


def broadcast_tx_async(env, params):
    tx = bytes.fromhex(params["tx"])
    if _txlife.enabled:
        _txlife.track(tx, "arrival", src="rpc")
    submit = getattr(env.mempool, "submit_tx", None)
    if submit is not None:
        # truly async: enqueue into the admission pipeline and return
        # without waiting for the window to drain
        fut = submit(tx)
        fut.add_done_callback(lambda f: f.exception())  # fire and forget
    else:
        try:
            env.mempool.check_tx(tx)
        except Exception:  # noqa: BLE001 — async: fire and forget
            pass
    return {"code": 0, "hash": _hx(tmhash(tx))}


def broadcast_tx_commit(env, params, timeout_s: float = 30.0):
    """Submit and wait for the tx to land in a block (reference
    rpc/core/mempool.go BroadcastTxCommit via event subscription)."""
    tx = bytes.fromhex(params["tx"])
    if _txlife.enabled:
        _txlife.track(tx, "arrival", src="rpc")
    sub = env.event_bus.subscribe(
        f"btc-{tmhash(tx).hex()[:8]}", f"tm.event = 'Tx' AND tx.hash = '{_hx(tmhash(tx))}'"
    )
    try:
        from ..utils.pubsub import SubscriptionCancelled

        env.mempool.check_tx(tx)
        try:
            msg = sub.next(timeout=timeout_s)
        except SubscriptionCancelled:
            msg = None
        if msg is None:
            raise RPCError(-32603, "timed out waiting for tx commit")
        return {
            "check_tx": {"code": 0},
            "tx_result": {"code": getattr(msg.data["result"], "code", 0)},
            "hash": _hx(tmhash(tx)),
            "height": str(msg.data["height"]),
        }
    except (ErrTxInCache, ErrMempoolFull, ErrTxTooLarge, ValueError) as e:
        return {"check_tx": {"code": 1, "log": str(e)}, "hash": _hx(tmhash(tx))}
    finally:
        env.event_bus.unsubscribe_all(f"btc-{tmhash(tx).hex()[:8]}")


def unconfirmed_txs(env, params):
    limit = int(params.get("limit", 30))
    txs = env.mempool.reap_max_txs(limit) if env.mempool else []
    return {
        "n_txs": str(len(txs)),
        "total": str(env.mempool.size() if env.mempool else 0),
        "total_bytes": str(env.mempool.total_bytes() if env.mempool else 0),
        "txs": [_hx(t) for t in txs],
    }


def num_unconfirmed_txs(env, params):
    return {
        "n_txs": str(env.mempool.size() if env.mempool else 0),
        "total_bytes": str(env.mempool.total_bytes() if env.mempool else 0),
    }


def _as_bool(v) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).lower() in ("1", "true", "t", "yes")


def _paginate(items, params, order_key=None):
    """page/per_page/order_by handling shared by the search routes
    (reference rpc/core/tx.go TxSearch + rpc/core/env.go validatePage:
    per_page defaults to 30 capped at 100; page is 1-based; out-of-range
    pages are an error; order_by is "asc" (default) or "desc")."""
    order = str(params.get("order_by", "asc") or "asc").lower()
    if order not in ("asc", "desc"):
        raise RPCError(-32602, f"invalid order_by {order!r}")
    if order_key is not None:
        items = sorted(items, key=order_key, reverse=(order == "desc"))
    elif order == "desc":
        items = list(reversed(items))
    try:
        per_page = min(max(int(params.get("per_page", 30)), 1), 100)
        page = int(params.get("page", 1))
    except (TypeError, ValueError):
        raise RPCError(-32602, "page/per_page must be integers")
    total = len(items)
    pages = max((total + per_page - 1) // per_page, 1)
    if page < 1 or page > pages:
        raise RPCError(-32602, f"page {page} out of range [1, {pages}]")
    lo = (page - 1) * per_page
    return items[lo : lo + per_page], total


def _tx_proof(env, height: int, index: int, _cache=None):
    """Merkle inclusion proof of tx `index` in block `height`'s data
    hash (reference types/tx.go:79 Txs.Proof). `_cache` (dict keyed by
    height) lets tx_search build each block's tree once per page instead
    of once per result."""
    entry = _cache.get(height) if _cache is not None else None
    if entry is None:
        blk = env.block_store.load_block(height)
        if blk is None:
            return None
        root, proofs = merkle.proofs_from_byte_slices(
            [tmhash(t) for t in blk.data.txs]
        )
        entry = (blk.data.txs, root, proofs)
        if _cache is not None:
            _cache[height] = entry
    txs, root, proofs = entry
    if index >= len(proofs):
        return None
    p = proofs[index]
    return {
        "root_hash": _hx(root),
        "data": _hx(txs[index]),
        "proof": {
            "total": str(p.total),
            "index": str(p.index),
            "leaf_hash": _b64(p.leaf_hash),
            "aunts": [_b64(a) for a in p.aunts],
        },
    }


def tx(env, params):
    h = bytes.fromhex(params["hash"])
    rec = env.tx_indexer.get(h) if env.tx_indexer else None
    if rec is None:
        raise RPCError(-32603, "tx not found")
    out = {
        "hash": _hx(h),
        "height": str(rec["height"]),
        "index": rec["index"],
        "tx_result": {"code": rec["code"], "data": _hx(rec["data"])},
        "tx": _hx(rec["tx"]),
    }
    if _as_bool(params.get("prove", False)):
        proof = _tx_proof(env, rec["height"], rec["index"])
        if proof is not None:
            out["proof"] = proof
    return out


def tx_search(env, params):
    query = params.get("query", "")
    recs = env.tx_indexer.search(query) if env.tx_indexer else []
    page, total = _paginate(
        recs, params, order_key=lambda r: (r["height"], r["index"])
    )
    prove = _as_bool(params.get("prove", False))
    txs = []
    proof_cache: dict = {}
    for r in page:
        item = {
            "hash": _hx(tmhash(r["tx"])),
            "height": str(r["height"]),
            "index": r["index"],
            "tx_result": {"code": r["code"]},
        }
        if prove:
            proof = _tx_proof(env, r["height"], r["index"], proof_cache)
            if proof is not None:
                item["proof"] = proof
        txs.append(item)
    return {"txs": txs, "total_count": str(total)}


def block_search(env, params):
    query = params.get("query", "")
    heights = env.block_indexer.search(query) if env.block_indexer else []
    page, total = _paginate(heights, params, order_key=lambda h: h)
    out = []
    for h in page:
        blk = env.block_store.load_block(h)
        if blk is not None:
            out.append({"block_id": {"hash": _hx(blk.hash())},
                        "block": _block_json(blk)})
    return {"blocks": out, "total_count": str(total)}


def broadcast_evidence(env, params):
    """Submit proto-encoded (hex) evidence to the pool (reference
    rpc/core/evidence.go BroadcastEvidence); the evidence reactor then
    gossips it to peers."""
    from ..types.evidence import EvidenceError, decode_evidence

    raw = params.get("evidence", "")
    try:
        ev = decode_evidence(bytes.fromhex(raw))
    except Exception as e:  # noqa: BLE001 — caller sent garbage
        raise RPCError(-32602, f"invalid evidence: {e}") from e
    if env.evidence_pool is None:
        raise RPCError(-32603, "evidence pool unavailable")
    try:
        env.evidence_pool.add_evidence(ev)
    except EvidenceError as e:
        raise RPCError(-32603, f"evidence rejected: {e}") from e
    return {"hash": _hx(ev.hash())}


def genesis_chunked(env, params):
    """Genesis split into base64 chunks for large documents (reference
    rpc/core/net.go GenesisChunked)."""
    import base64

    chunk_size = 16 * 1024 * 1024
    doc = env.genesis_doc.to_json().encode()
    chunks = [
        doc[i : i + chunk_size] for i in range(0, len(doc), chunk_size)
    ] or [b""]
    idx = int(params.get("chunk", 0))
    if not 0 <= idx < len(chunks):
        raise RPCError(-32602, f"chunk {idx} out of range [0, {len(chunks)})")
    return {
        "chunk": str(idx),
        "total": str(len(chunks)),
        "data": base64.b64encode(chunks[idx]).decode(),
    }


def _dial(env, params):
    if env.switch is None:
        raise RPCError(-32603, "p2p switch unavailable")
    peers = params.get("peers") or params.get("seeds") or []
    dialed = []
    for addr in peers:
        try:
            host, _, port = addr.rpartition("@")[-1].rpartition(":")
            env.switch.dial_peer(host, int(port))
            dialed.append(addr)
        except Exception:  # noqa: BLE001 — unreachable peers are skipped
            continue
    return {"log": f"dialed {len(dialed)}/{len(peers)}"}


def unsafe_dial_seeds(env, params):
    return _dial(env, params)


def unsafe_dial_peers(env, params):
    # the reference's `persistent` flag is not supported: this switch
    # has no redial list, so accepting the flag would silently lie
    return _dial(env, params)


unsafe_dial_peers.__doc__ = unsafe_dial_seeds.__doc__ = (
    "Unsafe operator route: dial the given host:port peers now "
    "(reference rpc/core/net.go UnsafeDialSeeds/UnsafeDialPeers)."
)


def unsafe_flush_mempool(env, params):
    """Drop every transaction from the mempool (reference
    rpc/core/dev.go:9 UnsafeFlushMempool)."""
    if env.mempool is None:
        raise RPCError(-32603, "mempool unavailable")
    env.mempool.flush()
    return {}


# The light, DA and replication serving surfaces are not in the port yet
# (light/serve.py, da/ and replication/ come with a later slice). Their
# routes keep their names and answer with the reference's "disabled"
# error, which the reference gives a node whose config leaves them off
# (the port's Node refuses a config that turns them on).
_LIGHT_OFF = "light serving surface disabled (config [light] serve = false)"
_DA_OFF = "data-availability sampling disabled (config [da] enabled = false)"
_FEED_OFF = "replication feed disabled (config [replication] serve = false)"


def _disabled(name: str, message: str):
    def route(env, params):
        raise RPCError(-32603, message)

    route.__name__ = name
    route.__doc__ = f"Not served by the port: {message}."
    return route


light_status = _disabled("light_status", _LIGHT_OFF)
light_mmr_proof = _disabled("light_mmr_proof", _LIGHT_OFF)
light_bisect = _disabled("light_bisect", _LIGHT_OFF)
da_status = _disabled("da_status", _DA_OFF)
da_sample = _disabled("da_sample", _DA_OFF)
da_pc_commitments = _disabled("da_pc_commitments", _DA_OFF)
da_pc_sample = _disabled("da_pc_sample", _DA_OFF)
replication_status = _disabled("replication_status", "replication disabled")
replication_snapshot = _disabled("replication_snapshot", _FEED_OFF)
replication_snapshot_chunk = _disabled("replication_snapshot_chunk", _FEED_OFF)


# unsafe operator routes, served only when rpc.unsafe is enabled
# (reference rpc/core/routes.go AddUnsafeRoutes gated by config Unsafe)
UNSAFE_ROUTES = {
    "unsafe_dial_seeds": unsafe_dial_seeds,
    "unsafe_dial_peers": unsafe_dial_peers,
    "unsafe_flush_mempool": unsafe_flush_mempool,
}

ROUTES = {
    "health": health,
    "dump_trace": dump_trace,
    "status": status,
    "broadcast_evidence": broadcast_evidence,
    "genesis_chunked": genesis_chunked,
    "abci_info": abci_info,
    "abci_query": abci_query,
    "block": block,
    "block_by_hash": block_by_hash,
    "blockchain": blockchain,
    "header": header,
    "header_by_hash": header_by_hash,
    "commit": commit,
    "check_tx": check_tx,
    "dump_consensus_state": dump_consensus_state,
    "block_results": block_results,
    "validators": validators,
    "genesis": genesis,
    "net_info": net_info,
    "consensus_state": consensus_state,
    "consensus_params": consensus_params,
    "broadcast_tx_sync": broadcast_tx_sync,
    "broadcast_tx_async": broadcast_tx_async,
    "broadcast_tx_commit": broadcast_tx_commit,
    "unconfirmed_txs": unconfirmed_txs,
    "num_unconfirmed_txs": num_unconfirmed_txs,
    "tx": tx,
    "tx_search": tx_search,
    "block_search": block_search,
    "light_status": light_status,
    "light_mmr_proof": light_mmr_proof,
    "light_bisect": light_bisect,
    "da_status": da_status,
    "da_sample": da_sample,
    "da_pc_commitments": da_pc_commitments,
    "da_pc_sample": da_pc_sample,
    "replication_status": replication_status,
    "replication_snapshot": replication_snapshot,
    "replication_snapshot_chunk": replication_snapshot_chunk,
}
