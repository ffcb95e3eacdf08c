"""The port's light client, light store and MMR against the JAX package's.

Two 12-block, 4-validator chains made by the port's `make_chain` from one
seed (the same signers; the fork carries other txs), with validator 0's
power raised at height 7 (the set changes at height 9) and NIL votes at
heights 9 and 12; a replay through the port's executor fills a state
store with each height's set. Both stores cross to the reference as KV
items. The port's `LightClient` (device "cpu": the native route) and the
reference's (`backend="cpu"`) run the same cases: skipping (with the
pivots a 9/10 trust level forces), sequential, backwards by hash links,
re-rooted between trusted heights, a lying witness, a replaced primary,
and a forked witness. Every comparison is exact: the same heights
fetched and stored, verdicts, error classes and messages, and evidence
bytes. The MMR cases mirror `tests/test_mmr.py` without its synthetic
1M-leaf proofs: the same roots, node arrays, proof bytes and verdicts.
"""

from __future__ import annotations

import hashlib
import math
import types

import pytest

torch = pytest.importorskip("torch")

from cometbft_tpu.light import LightClient as RLightClient  # noqa: E402
from cometbft_tpu.light import LightStore as RLightStore  # noqa: E402
from cometbft_tpu.light import StoreProvider as RStoreProvider  # noqa: E402
from cometbft_tpu.light import mmr as RMMR  # noqa: E402
from cometbft_tpu.light import verify_ancestry as r_verify_ancestry  # noqa: E402
from cometbft_tpu.light.store import MMRStore as RMMRStore  # noqa: E402
from cometbft_tpu.storage import BlockStore as RBlockStore  # noqa: E402
from cometbft_tpu.storage import MemKV as RMemKV  # noqa: E402
from cometbft_tpu.storage import StateStore as RStateStore  # noqa: E402
from cometbft_tpu.types import Timestamp as RTimestamp  # noqa: E402
from cometbft_tpu_torch.abci import AppConns, KVStoreApp  # noqa: E402
from cometbft_tpu_torch.abci import types as AT  # noqa: E402
from cometbft_tpu_torch.light import (  # noqa: E402
    MMR,
    LightBlock,
    LightClient,
    LightStore,
    MMRProof,
    MMRStore,
    ProviderError,
    StoreProvider,
    verify_ancestry,
)
from cometbft_tpu_torch.light import mmr as M  # noqa: E402
from cometbft_tpu_torch.state.execution import BlockExecutor  # noqa: E402
from cometbft_tpu_torch.storage import MemKV, StateStore  # noqa: E402
from cometbft_tpu_torch.types import Timestamp  # noqa: E402
from cometbft_tpu_torch.types.block import block_id_for  # noqa: E402
from cometbft_tpu_torch.utils import factories as fx  # noqa: E402

CHAIN = "light-chain"
N = 12
NIL = {9: {1}, 12: {2}}
NOW_NS = 1_700_000_100_000_000_000
PERIOD = 10**9  # practically unexpiring


def bump_app(pub: bytes):
    class Bump(KVStoreApp):
        def finalize_block(self, req):
            resp = super().finalize_block(req)
            if req.height == 7:
                resp.validator_updates.append(AT.ValidatorUpdate(pub, "ed25519", 25))
            return resp

    return Bump()


def _items(kv) -> list:
    return sorted(kv.iterate_prefix(b""))


@pytest.fixture(scope="module")
def chains():
    """{"main", "fork"}: each (port block store, port state store, the
    reference's block store, the reference's state store)."""
    pub = fx.make_signers(1, seed=0, device="cpu")[0].pub_bytes
    out = {}
    for name, txs in (("main", 2), ("fork", 3)):
        store, _final, genesis, _ = fx.make_chain(
            N, n_validators=4, chain_id=CHAIN, txs_per_block=txs, device="cpu", nil_votes=NIL,
            app=bump_app(pub), r_pool=fx.RPool(4, 16, device="cpu"))
        ss = StateStore(MemKV())
        ss.save(genesis)
        ex = BlockExecutor(AppConns(bump_app(pub)), state_store=ss, device="cpu")
        state = genesis.copy()
        for h in range(1, N + 1):
            blk = store.load_block(h)
            state = ex.apply_block(state, block_id_for(blk), blk)
        rbs, rss = RMemKV(), RMemKV()
        rbs.write_batch(_items(store._db))
        rss.write_batch(_items(ss._db))
        out[name] = (store, ss, RBlockStore(rbs), RStateStore(rss))
    return out


class _Logged:
    """A provider that records the heights asked of it."""

    def __init__(self, inner, log: list, fail_at=None, lie_at=None):
        self.inner, self.log, self.fail_at, self.lie_at = inner, log, fail_at, lie_at

    def chain_id(self):
        return self.inner.chain_id()

    def light_block(self, height):
        self.log.append(height)
        if self.fail_at is not None and height >= self.fail_at:
            raise ProviderError(f"provider down at {height}")
        lb = self.inner.light_block(height)
        if lb is not None and height == self.lie_at:
            lb.signed_header.header.app_hash = b"\xde\xad" * 16
        return lb


def _side(chains, port: bool, primary="main", witnesses=(), **kw):
    """(client, the primary's height log, each witness's log, the evidence
    each witness received)."""
    def provider(name):
        st = chains[name]
        return StoreProvider(CHAIN, st[0], st[1]) if port else RStoreProvider(CHAIN, st[2], st[3])

    plog, wlogs, received = [], [], []
    wit = []
    for w in witnesses:
        name, opts = (w, {}) if isinstance(w, str) else w
        wlogs.append([])
        received.append([])
        p = _Logged(provider(name), wlogs[-1], **opts)
        p.report_evidence = received[-1].append
        wit.append(p)
    pfail = kw.pop("primary_fail_at", None)
    prim = _Logged(provider(primary), plog, fail_at=pfail)
    if port:
        c = LightClient(CHAIN, prim, witnesses=wit, store=LightStore(), trusting_period_s=PERIOD,
                        device="cpu", **kw)
    else:
        c = RLightClient(CHAIN, prim, witnesses=wit, store=RLightStore(), trusting_period_s=PERIOD,
                         backend="cpu", **kw)
    return types.SimpleNamespace(c=c, plog=plog, wlogs=wlogs, received=received, port=port)


def _now(port: bool):
    return (Timestamp if port else RTimestamp).from_unix_ns(NOW_NS)


def _run(side, steps) -> list:
    """Each step: ("init", h) or ("verify", h); the outcome of each: the
    verified block's height and header hash, or the error's class and
    message; then the stored heights and every provider's log."""
    out = []
    for op, h in steps:
        try:
            if op == "init":
                anchor = side.c.primary.light_block(h).signed_header.header.hash()
                side.plog.clear()
                lb = side.c.initialize(h, anchor)
            else:
                lb = side.c.verify_to_height(h, _now(side.port))
            out.append((lb.height, lb.signed_header.header.hash()))
        except Exception as e:  # noqa: BLE001 — compared by class and message
            out.append((type(e).__name__, str(e)))
    return [out, side.c.store.heights(), side.plog, side.wlogs, len(side.c.witnesses)]


CASES = {
    "skipping": dict(steps=[("init", 1), ("verify", N), ("verify", N)]),
    "pivots": dict(steps=[("init", 1), ("verify", N)], trust_level=(9, 10)),
    "sequential": dict(steps=[("init", 1), ("verify", 6)], skipping=False),
    "backwards": dict(steps=[("init", 8), ("verify", 3)]),
    "between": dict(steps=[("init", 1), ("verify", N), ("verify", 6), ("verify", 7)],
                    trust_level=(9, 10)),
    "agreeing_witness": dict(steps=[("init", 1), ("verify", N)], witnesses=["main"]),
    "lying_witness": dict(steps=[("init", 1), ("verify", 7)],
                          witnesses=[("main", {"lie_at": 7})]),
    "primary_replaced": dict(steps=[("init", 1), ("verify", 10)], primary_fail_at=2,
                             witnesses=["main"]),
    "no_witness_left": dict(steps=[("init", 1), ("verify", 10)], primary_fail_at=2),
    "fork": dict(steps=[("init", 1), ("verify", 5)], witnesses=["fork"]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_client_matches_the_reference(chains, case):
    spec = dict(CASES[case])
    steps = spec.pop("steps")
    got = _run(_side(chains, True, **spec), steps)
    want = _run(_side(chains, False, **spec), steps)
    assert got == want
    if case == "pivots":
        assert len(got[2]) > 4  # the 9/10 trust level forced bisection pivots


def test_fork_evidence_bytes_match_the_reference(chains):
    sides = [_side(chains, port, witnesses=["fork"]) for port in (True, False)]
    evs = []
    for s in sides:
        s.c.initialize(1, s.c.primary.light_block(1).signed_header.header.hash())
        with pytest.raises(Exception, match="light-client attack") as ei:
            s.c.verify_to_height(5, _now(s.port))
        evs.append((ei.value.evidence.wrapped(), [e.wrapped() for e in s.received[0]]))
    assert evs[0] == evs[1]
    assert len(evs[0][1]) == 2 and evs[0][1][0] == evs[0][0]


def test_phase_8_light_outcome_is_the_references(chains):
    """`chip_smoke.expected_light_outcome` at this size is what the
    reference's client does: skip to the tip with an agreeing witness,
    then the forked witness's conflict, evidence and both reports."""
    import chip_smoke

    st = chains["main"]
    addrs = [v.address for v in st[3].load_validators(1).validators]
    want = chip_smoke.expected_light_outcome(N, 5, addrs)
    s = _side(chains, False, witnesses=["main"])
    s.c.initialize(1, s.c.primary.light_block(1).signed_header.header.hash())
    s.c.verify_to_height(N, _now(False))
    f = _side(chains, False, witnesses=["fork"])
    f.c.initialize(1, f.c.primary.light_block(1).signed_header.header.hash())
    with pytest.raises(Exception) as ei:
        f.c.verify_to_height(5, _now(False))
    ev = ei.value.evidence
    got = {"heights": s.c.store.heights(), "error": (type(ei.value).__name__, str(ei.value)),
           "common_height": ev.common_height, "byzantine": sorted(ev.byzantine_validators),
           "reported_heights": [e.conflicting_block.height for e in f.received[0]]}
    assert got == want


def test_light_store_matches_the_reference(chains):
    st = chains["main"]
    p, r = StoreProvider(CHAIN, st[0], st[1]), RStoreProvider(CHAIN, st[2], st[3])
    db, rdb = MemKV(), RMemKV()
    ls, rls = LightStore(db), RLightStore(rdb)
    for h in (3, 1, 9, 5, 12):
        ls.save(p.light_block(h))
        rls.save(r.light_block(h))
    assert _items(db) == _items(rdb)
    assert ls.heights() == rls.heights() == [1, 3, 5, 9, 12]
    assert ls.latest().encode() == LightBlock.decode(ls.load(12).encode()).encode()
    assert ls.lowest().height == rls.lowest().height == 1
    assert ls.prune(2) == rls.prune(2) == 3
    assert _items(db) == _items(rdb) and ls.heights() == [9, 12]
    assert ls.load(3) is None


def test_cuda_client_without_a_gpu_raises(chains, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    st = chains["main"]
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        LightClient(CHAIN, StoreProvider(CHAIN, st[0], st[1]))


# ---- the MMR accumulator

def _leaves(n, tag=b"hdr"):
    return [hashlib.sha256(tag + i.to_bytes(8, "big")).digest() for i in range(n)]


EDGE_SIZES = sorted({1, 2, 3} | {1 << k for k in range(2, 9)} | {(1 << k) - 1 for k in range(2, 9)}
                    | {(1 << k) + 1 for k in range(2, 9)})


def test_mmr_nodes_and_roots_match_the_reference():
    leaves = _leaves(max(EDGE_SIZES))
    inc, rinc = MMR(), RMMR.MMR()
    for n in range(1, max(EDGE_SIZES) + 1):
        assert inc.append(leaves[n - 1]) == rinc.append(leaves[n - 1]) == n - 1
        if n in EDGE_SIZES:
            fresh = MMR.from_leaves(leaves[:n])
            nodes = [inc.node(p) for p in range(inc.node_count)]
            assert nodes == [fresh.node(p) for p in range(fresh.node_count)] == \
                [rinc.node(p) for p in range(rinc.node_count)]
            assert inc.root() == fresh.root() == rinc.root()
            assert M.peak_heights(n) == RMMR.peak_heights(n)
            assert M.peak_positions(n) == RMMR.peak_positions(n)
            assert inc.node_count == 2 * n - bin(n).count("1")


@pytest.mark.parametrize("n", [1, 2, 3, 4, 7, 8, 9, 16, 17, 33])
def test_mmr_proofs_match_the_reference(n):
    leaves = _leaves(n)
    acc, racc = MMR.from_leaves(leaves), RMMR.MMR.from_leaves(leaves)
    root = acc.root()
    for i in range(n):
        proof = acc.prove(i)
        assert proof.encode() == racc.prove(i).encode()
        assert proof.verify(root, leaves[i])
        assert MMRProof.decode(proof.encode()) == proof and proof.num_bytes() == len(proof.encode())


def _rejects(P, leaves, acc):
    root, proof = acc.root(), acc.prove(4)
    sib, is_left = proof.path[0]
    cases = [
        (proof, root, leaves[5]),
        (proof, hashlib.sha256(b"x").digest(), leaves[4]),
        (P(4, 9, proof.path[:-1], proof.left_peaks, proof.right_peaks), root, leaves[4]),
        (P(4, 9, proof.path + [(bytes(32), False)], proof.left_peaks, proof.right_peaks), root,
         leaves[4]),
        (P(4, 9, proof.path, [], []), root, leaves[4]),
        (P(4, 9, [(sib, not is_left)] + proof.path[1:], proof.left_peaks, proof.right_peaks),
         root, leaves[4]),
        (P(9, 9, [], [], []), root, leaves[0]),
        (proof, root, leaves[4]),
    ]
    return [p.verify(r, lh) for p, r, lh in cases]


def test_mmr_rejects_match_the_reference():
    leaves = _leaves(9)
    got = _rejects(MMRProof, leaves, MMR.from_leaves(leaves))
    assert got == _rejects(RMMR.MMRProof, leaves, RMMR.MMR.from_leaves(leaves))
    assert got == [False] * 7 + [True]


def test_mmr_snapshot_binding_wire_and_ancestry():
    leaves = _leaves(12)
    acc = MMR.from_leaves(leaves[:8])
    proof8, root8 = acc.prove(3), acc.root()
    for lh in leaves[8:]:
        acc.append(lh)
    assert (proof8.verify(root8, leaves[3]), proof8.verify(acc.root(), leaves[3]),
            acc.prove(3).verify(root8, leaves[3])) == (True, False, False)
    buf = proof8.encode()
    with pytest.raises(ValueError):
        MMRProof.decode(buf + b"\x00")
    with pytest.raises(Exception):
        MMRProof.decode(b"\x01\x02")
    acc = MMR.from_leaves(_leaves(10))
    racc = RMMR.MMR.from_leaves(_leaves(10))
    root, size = acc.root(), acc.leaf_count
    proof, rproof = acc.prove(3), racc.prove(3)
    args = [(8, proof), (8, proof.encode()), (9, proof), (8, b"junk")]
    got = [verify_ancestry(root, size, 5, h, _leaves(10)[3], p) for h, p in args]
    rargs = [(8, rproof), (8, rproof.encode()), (9, rproof), (8, b"junk")]
    assert got == [r_verify_ancestry(root, size, 5, h, _leaves(10)[3], p) for h, p in rargs]
    assert got == [True, True, False, False]
    assert not verify_ancestry(root, size + 1, 5, 8, _leaves(10)[3], proof)


@pytest.mark.parametrize("n", [1000, 50_000])
def test_mmr_proof_size_log_bound(n):
    acc = MMR.from_leaves(_leaves(n))
    step = max(1, n // 512)
    idxs = set(range(0, n, step)) | {0, 1, n - 1, n // 2}
    assert max(acc.prove(i).num_bytes() for i in idxs) <= 96 * math.log2(n)
    if n == 1000:
        assert acc.root() == RMMR.MMR.from_leaves(_leaves(n)).root()


def test_mmr_store_matches_the_reference():
    db, rdb = MemKV(), RMemKV()
    store, rstore = MMRStore(db), RMMRStore(rdb)
    assert store.node_count() == 0 and store.load_nodes() == (0, [])
    assert store.load_base_height() is None
    acc, racc = MMR(store=store), RMMR.MMR(store=rstore)
    for lh in _leaves(21):
        acc.append(lh)
        racc.append(lh)
    store.save_base_height(100)
    rstore.save_base_height(100)
    assert _items(db) == _items(rdb)
    back = MMR.load(MMRStore(db))
    assert (back.leaf_count, back.root()) == (21, acc.root())
    back.append(hashlib.sha256(b"more").digest())
    again = MMR.load(MMRStore(db))
    assert (again.leaf_count, again.root()) == (22, back.root())
    assert MMRStore(db).load_base_height() == 100
