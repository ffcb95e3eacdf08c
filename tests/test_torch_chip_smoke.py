"""The part of `chip_smoke.py`'s logic that runs without a card."""

import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from cometbft_tpu_torch.crypto import ed25519 as E  # noqa: E402


def test_rlc_submit_is_repeated_while_the_layout_declines(monkeypatch):
    """A declined layout sends the commit to the ladder: the smoke run
    hands that result to its check and submits again, so a decline (about
    one 10,000-signature commit in sixteen) does not fail the run; the
    submits are counted for the per-commit launch figures."""
    rlc = object.__new__(E.PendingRLC)
    ladder = [object(), object()]
    results = iter(ladder + [rlc])
    monkeypatch.setattr(chip_smoke, "submit_commit", lambda cols, dev: next(results))
    seen = []
    assert chip_smoke.submit_through_rlc(None, "cpu", seen.append) == (rlc, 3)
    assert seen == ladder


def test_rlc_submit_gives_up_after_repeated_declines(monkeypatch):
    monkeypatch.setattr(chip_smoke, "submit_commit", lambda cols, dev: object())
    seen = []
    with pytest.raises(AssertionError, match="declined the commit 5 times"):
        chip_smoke.submit_through_rlc(None, "cpu", seen.append)
    assert len(seen) == 5


def test_sources_name_every_kernel_and_the_function_it_replaces():
    """`SOURCES` lists the ten kernels, the same names as the launch
    counts; each source exists; each kernel's first `file:line` of the JAX
    package is the `def` of the function it computes (a Pallas kernel, or
    a plain-XLA function for `region_sum`, `window_combine`,
    `sha512_blocks`, `reduce512` and the fused `sha512_reduce`); the
    device-SHA routes' kernels are in it."""
    from cometbft_tpu_torch.ops import kernels as K

    assert list(chip_smoke.SOURCES) == list(K.launches) and len(K.launches) == 10
    for name, (source, replaces) in chip_smoke.SOURCES.items():
        assert (chip_smoke.ROOT / source).is_file(), source
        path, line = replaces.split(",")[0].split()[0].split(":")
        text = (chip_smoke.ROOT / path).read_text().splitlines()[int(line) - 1]
        assert text.startswith("def "), (name, text)
    assert set(chip_smoke.SHA_KERNELS) | set(chip_smoke.SHA_STANDALONE) <= set(chip_smoke.SOURCES)


def test_bound_counts():
    """The operation counts behind the two new kernels' bounds: a SHA-512
    block's 32-bit instructions and `reduce512`'s wide multiplies."""
    assert chip_smoke.SHA_INT_OPS_PER_BLOCK == 3696
    assert chip_smoke.REDUCE_WIDE_MULS == 81 + 44


@pytest.mark.parametrize("counts, ok", [
    ({"sha512_reduce": 34, "sha512_blocks": 0, "reduce512": 0}, True),
    ({"sha512_reduce": 33, "sha512_blocks": 0, "reduce512": 0}, False),
    ({"sha512_reduce": 34, "sha512_blocks": 34, "reduce512": 0}, False),
    ({"sha512_reduce": 34, "sha512_blocks": 0, "reduce512": 1}, False),
    ({"sha512_reduce": 0, "sha512_blocks": 34, "reduce512": 34}, False),
])
def test_challenge_launch_check(counts, ok):
    """The device-SHA and delta routes' launch check: `sha512_reduce`
    once a commit (34 commits here), `sha512_blocks` and `reduce512`
    never; the routes check `decompress` and the ladder besides."""
    assert chip_smoke.SHA_KERNELS == ("sha512_reduce", "decompress", "ladder_sub_mul8")
    if ok:
        chip_smoke.check_challenge_launches("device_sha", counts, 34)
    else:
        with pytest.raises(AssertionError, match="34 sha512_reduce launches"):
            chip_smoke.check_challenge_launches("device_sha", counts, 34)


def test_ops_challenge_leg_launches_each_standalone_kernel_once(monkeypatch):
    """Phase 4 (e) on the CPU, the launchers replaced by counted plain
    versions and the device test forced true: one commit's packed words
    through `sha512_digest` then `reduce512` give `sha512_reduce`'s k from
    one launch of each standalone kernel and none of the fused one."""
    import numpy as np

    from cometbft_tpu_torch.ops import field as F
    from cometbft_tpu_torch.ops import kernels as K
    from cometbft_tpu_torch.ops import scalar as SC
    from cometbft_tpu_torch.ops import sha512 as H

    def counted(name, fn):
        def launch(*args):
            K.launches[name] += 1
            return fn(*args)
        return launch

    monkeypatch.setattr(K, "sha512_blocks", counted("sha512_blocks", H.sha512_digest_plain))
    monkeypatch.setattr(K, "reduce512", counted("reduce512", SC.reduce512_plain))
    monkeypatch.setattr(K, "sha512_reduce", counted("sha512_reduce", SC.sha512_reduce_plain))
    rng = np.random.default_rng(4)
    cols = chip_smoke.to_columns([(rng.bytes(32), rng.bytes(100), rng.bytes(64))
                                  for _ in range(20)])
    monkeypatch.setattr(F, "on_gpu", lambda t: True)
    counts = chip_smoke.ops_challenge_leg(torch.device("cpu"), cols)
    assert (counts["sha512_blocks"], counts["reduce512"], counts["sha512_reduce"]) == (1, 1, 0)


# ---- phase 6's helpers (the consumers)


@pytest.fixture(scope="module")
def small_commit():
    """An 8-validator commit of power 10, made by the port's factories on
    the CPU."""
    from cometbft_tpu_torch.utils import factories as fx

    signers = fx.make_signers(8, seed=21, device="cpu")
    vals = fx.make_validator_set(signers, [10] * 8)
    bid = fx.make_block_id(b"smoke")
    commit = fx.make_commit("c", 3, 0, bid, vals, {s.address(): s for s in signers},
                            device="cpu")
    return vals, bid, commit, signers


@pytest.mark.parametrize("fn", chip_smoke.CONSUMER_FUNCS)
@pytest.mark.parametrize("bad, absent, all_sigs", [
    (None, 0, False), (1, 0, False), (6, 0, False), (6, 0, True), (None, 3, False),
    (4, 3, False), (4, 3, True), (2, 2, False), (None, 6, True),
])
def test_expected_outcome_matches_the_consumers(small_commit, fn, bad, absent, all_sigs):
    """`expected_outcome`, the phase's index and tally checks, against what
    the port's consumers give on the CPU (held against the reference's in
    tests/test_torch_validation.py), with the same helpers the phase uses
    to break a commit."""
    from cometbft_tpu_torch.types import validation as V

    vals, bid, commit, _ = small_commit
    c = chip_smoke.with_absent_prefix(commit, absent)
    if bad is not None:
        c = chip_smoke.with_flipped_signature(c, bad)
    kw = {"verify_all_signatures": True} if all_sigs and fn != "verify_commit" else {}
    if fn == "verify_commit_light_trusting":
        call = lambda: V.verify_commit_light_trusting("c", vals, c, device="cpu", **kw)  # noqa: E731
    else:
        call = lambda: getattr(V, fn)("c", vals, bid, 3, c, device="cpu", **kw)  # noqa: E731
    want = chip_smoke.expected_outcome(fn, 8, 10, bad=bad, absent=absent,
                                       all_sigs=all_sigs and fn != "verify_commit")
    assert chip_smoke.check_outcome(fn, call, want) == want
    assert [cs.signature for cs in commit.signatures[absent:]] != \
        [cs.signature for cs in c.signatures[absent:]] or bad is None


def test_check_outcome_fails_on_another_outcome():
    def boom():
        raise ValueError("invalid signature at index 3")

    with pytest.raises(AssertionError, match="got .*ValueError"):
        chip_smoke.check_outcome("x", boom, ("ErrInvalidSignature", "invalid signature at index 3"))
    with pytest.raises(AssertionError, match="got None"):
        chip_smoke.check_outcome("x", lambda: None, ("ValueError", "m"))


def test_header_stream_builder(small_commit):
    """Consecutive heights one second apart, chained block ids, one set
    signing every header: verify_stream passes; a flipped signature is
    named by its stream lane."""
    from cometbft_tpu_torch.light import verifier as LV
    from cometbft_tpu_torch.types import Timestamp

    signers = small_commit[3][:4]
    trusted, stream = chip_smoke.build_header_stream("c", signers, 3, 1_000, "cpu")
    assert [lb.height for lb in stream] == [2, 3, 4] and trusted.height == 1
    assert [lb.time.seconds for lb in (trusted, *stream)] == [1_000, 1_001, 1_002, 1_003]
    for prev, lb in zip((trusted, *stream), stream):
        assert lb.signed_header.header.last_block_id == prev.signed_header.commit.block_id
        lb.basic_validate("c")
    now = Timestamp(1_010, 0)
    LV.verify_stream("c", trusted, stream, chip_smoke.TRUST_PERIOD_S, now, device="cpu")
    lb = stream[1]
    broken = list(stream)
    broken[1] = type(lb)(type(lb.signed_header)(
        lb.signed_header.header, chip_smoke.with_flipped_signature(lb.signed_header.commit, 2)),
        lb.validators)
    with pytest.raises(Exception, match="invalid signature in stream lane 6"):
        LV.verify_stream("c", trusted, broken, chip_smoke.TRUST_PERIOD_S, now, device="cpu")


def test_stage_split_chains_the_stages_and_takes_medians():
    calls = []
    stages = [("a", lambda x: calls.append(("a", x)) or 1),
              ("b", lambda x: calls.append(("b", x)) or x + 1)]
    out = chip_smoke.stage_split_ms(stages, 3, prepare=lambda: calls.append("prep"))
    assert calls == ["prep", ("a", None), ("b", 1)] * 4  # one warm-up, three timed
    assert set(out) == {"a", "b", "sum"} and out["sum"] >= max(out["a"], out["b"]) >= 0


def test_verify_stages_run_verify_commit_by_hand(small_commit):
    vals, _, commit, _ = small_commit
    stages = chip_smoke.verify_stages("c", vals, commit, "cpu")
    assert [name for name, _ in stages] == ["sign_bytes", "adds", "submit", "result"]
    x = None
    for _, fn in stages:
        x = fn(x)
    assert x.result() == (True, [True] * 8)
    out = chip_smoke.stage_split_ms(stages, 2, prepare=commit.invalidate_memos)
    assert out["sum"] > 0


# ---- phase 7's helpers (block-sync replay)


def test_replay_window_arithmetic():
    """The phase's counts at 1,000 validators, window 64: 63 last commits
    and the tip in the first window, 64 and the tip in each later one, all
    in bucket 65,536; height 2's commit index 777 is lane 1,777 of the bad
    chain's one window."""
    lanes = chip_smoke.replay_window_lanes(256, 1_000, 64)
    assert lanes == [64_000, 65_000, 65_000, 65_000] and sum(lanes) == 259_000
    assert {E._bucket(n) for n in lanes} == {65_536}
    assert chip_smoke.replay_window_lanes(6, 1_000, 64) == [6_000]
    assert E._bucket(6_000) == 10_240 and 6_000 >= E.RLC_MIN
    assert chip_smoke.replay_bad_lane(2, 777, 1_000, 64) == 1_777
    assert chip_smoke.replay_window_lanes(8, 4, 3) == [12, 16, 12]
    assert chip_smoke.expected_replay_outcome("batched", 6, 1_000, 10, 2, 777, 64) == (
        "ErrInvalidSignature", "invalid signature in window lane 1777", 0)
    # full mode: the light check of height 2 stops at 667 signatures, before
    # index 777, and accepts; block 3's validation names it
    assert chip_smoke.expected_replay_outcome("full", 6, 1_000, 10, 2, 777, 64) == (
        "BlockValidationError", "invalid last commit: invalid signature at index 777", 2)
    assert chip_smoke.expected_replay_outcome("full", 6, 1_000, 10, 2, 300, 64) == (
        "ErrInvalidSignature", "invalid signature at index 300", 1)


_BAD_CHAINS = {}


def _bad_chain(idx):
    """A reference chain of 5 blocks x 4 validators whose height-2 commit
    has the signature at `idx` broken (one per index, made once)."""
    from cometbft_tpu.utils import factories as RF

    if idx not in _BAD_CHAINS:
        _BAD_CHAINS[idx] = RF.make_chain(5, n_validators=4, chain_id="bad", backend="cpu",
                                         corrupt_sig=(2, idx))
    return _BAD_CHAINS[idx]


@pytest.mark.parametrize("mode, window, idx", [
    ("batched", 64, 3), ("batched", 2, 3), ("batched", 3, 1), ("full", 64, 3), ("full", 64, 1)])
def test_expected_replay_outcome_matches_the_reference(mode, window, idx):
    """`expected_replay_outcome` against the reference's replay of a
    make_chain chain with one broken signature, and the port's replay of
    the same store (carried as KV items): the same class, message and
    blocks applied first."""
    from cometbft_tpu.abci import kvstore as RK
    from cometbft_tpu.abci.client import AppConns as RAppConns
    from cometbft_tpu.blocksync import ReplayEngine as RReplayEngine
    from cometbft_tpu.state.execution import BlockExecutor as RBlockExecutor
    from cometbft_tpu_torch.abci import AppConns, KVStoreApp
    from cometbft_tpu_torch.blocksync import ReplayEngine
    from cometbft_tpu_torch.state.execution import BlockExecutor
    from cometbft_tpu_torch.state.types import State
    from cometbft_tpu_torch.storage import BlockStore, MemKV

    r_store, _, r_genesis, _ = _bad_chain(idx)
    want = chip_smoke.expected_replay_outcome(mode, 5, 4, 10, 2, idx, window)
    r_app = RK.KVStoreApp()
    r_eng = RReplayEngine(r_store, RBlockExecutor(RAppConns(r_app), backend="cpu"),
                          verify_mode=mode, window=window, backend="cpu")
    assert (*chip_smoke.outcome_of(lambda: r_eng.run(r_genesis.copy())), r_app.height) == want
    kv = MemKV()
    kv.write_batch(sorted(r_store._db.iterate_prefix(b"")))
    app = KVStoreApp()
    eng = ReplayEngine(BlockStore(kv), BlockExecutor(AppConns(app), device="cpu"),
                       verify_mode=mode, window=window, device="cpu")
    got = chip_smoke.outcome_of(lambda: eng.run(State.decode(r_genesis.encode())))
    assert (*got, app.height) == want


def test_submit_timer_keeps_the_window_or_submits_it():
    """The smoke run's stand-in for the engine's verify scheduler: with
    `keep` it holds the window's verifier (every lane of the window's
    commits) and verifies nothing; without, it submits the verifier as the
    engine does with no scheduler, so the replay's outcome is the same,
    and it adds up the seconds."""
    from cometbft_tpu_torch.abci import AppConns, KVStoreApp
    from cometbft_tpu_torch.blocksync import ReplayEngine
    from cometbft_tpu_torch.state.execution import BlockExecutor
    from cometbft_tpu_torch.state.types import State
    from cometbft_tpu_torch.storage import BlockStore, MemKV

    r_store, _, r_genesis, _ = _bad_chain(3)
    kv = MemKV()
    kv.write_batch(sorted(r_store._db.iterate_prefix(b"")))
    store, state = BlockStore(kv), State.decode(r_genesis.encode())
    keep = chip_smoke.SubmitTimer(keep=True)
    eng = ReplayEngine(store, BlockExecutor(AppConns(KVStoreApp()), device="cpu"), window=64,
                       device="cpu", sched=keep)
    pending, _, lanes = eng._queue_window(
        state.chain_id, state.validators, state.last_validators, state.last_block_id,
        state.initial_height, [store.load_block(h) for h in range(1, 6)])
    assert lanes == keep.kept.count() == chip_smoke.replay_window_lanes(5, 4, 64)[0] == 20
    assert pending.result() == (True, []) and keep.seconds == 0
    timer = chip_smoke.SubmitTimer()
    app = KVStoreApp()
    eng = ReplayEngine(store, BlockExecutor(AppConns(app), device="cpu"), window=64,
                       device="cpu", sched=timer)
    got = chip_smoke.outcome_of(lambda: eng.run(state.copy()))
    assert (*got, app.height) == chip_smoke.expected_replay_outcome("batched", 5, 4, 10, 2, 3, 64)
    assert timer.seconds > 0


# ---- phase 8's helpers (ingest, blocks with evidence; the light leg's
# expected outcome is held in tests/test_torch_light_client.py)

INGEST_PLANTS_SMALL = {"bad_sig": 7, "app_reject": 15, "malformed": 20, "duplicate": (30, 5),
                       "oversize": 35, "conflict": (2, 40)}


@pytest.fixture(scope="module")
def ingest_world():
    """Eight senders and an 80-tx stream of every planted class, signed by
    the port's factories on the CPU (`ingest_stream`)."""
    from cometbft_tpu_torch.utils import factories as fx

    senders = fx.make_signers(8, seed=29, device="cpu")
    txs, bad = chip_smoke.ingest_stream(senders, 0, 80, INGEST_PLANTS_SMALL, 1, "cpu")
    return senders, txs, bad


def test_expected_ingest_outcome_matches_the_reference(ingest_world):
    """`expected_ingest_outcome` against the reference's mempool on the
    same stream (per-tx path, signatures verified), with a pool of 60: the
    same class and message for every tx; and the port's pipeline at
    window 16 on the CPU gives the same."""
    from cometbft_tpu.abci.client import AppConns as RAppConns
    from cometbft_tpu.abci.kvstore import KVStoreApp as RKVStoreApp
    from cometbft_tpu.mempool import CListMempool as RCListMempool
    from cometbft_tpu_torch.abci import KVStoreApp
    from cometbft_tpu_torch.abci.types import CheckTxResult

    _, txs, bad = ingest_world
    want = chip_smoke.expected_ingest_outcome(txs, bad, 60, chip_smoke.MAX_TX_BYTES)
    rmp = RCListMempool(RAppConns(RKVStoreApp()), max_txs=60,
                        max_tx_bytes=chip_smoke.MAX_TX_BYTES, verify_sigs=True)
    assert [chip_smoke.outcome_of(lambda tx=tx: rmp.check_tx(tx)) for tx in txs] == want
    assert {o[0] if o else "ok" for o in want} == {
        "ok", "ValueError", "ErrTxInCache", "ErrTxTooLarge", "ErrMempoolFull"}
    assert sorted(set(o[1] for o in want if o and o[0] == "ValueError")) == [
        "tx rejected by app: code 1", "tx rejected: invalid signature"]
    mp = chip_smoke.ingest_node(chip_smoke.once_app(KVStoreApp, CheckTxResult), "cpu",
                                window=16)
    mp.max_txs = 60
    try:
        assert chip_smoke.future_outcomes([mp.submit_tx(tx) for tx in txs], 30) == want
    finally:
        mp.close()
    assert mp.reap_max_txs(-1) == rmp.reap_max_txs(-1)


def test_blocks_leg_final_state_matches_the_reference(ingest_world):
    """Phase 8's blocks leg at 4 validators and 6 blocks on the CPU: the
    final state equals `expected_blocks_state`, and the reference's
    executor applying the same block bytes (its KVStore app, an evidence
    pool on its state store) reaches the same state bytes; the evidence
    rides in block 5, the recheck drops the second write of a key."""
    from cometbft_tpu.abci import kvstore as RK
    from cometbft_tpu.abci import types as RAT
    from cometbft_tpu.abci.client import AppConns as RAppConns
    from cometbft_tpu.evidence import EvidencePool as REvidencePool
    from cometbft_tpu.mempool import parse_signed_tx as r_parse_signed_tx
    from cometbft_tpu.state import execution as RX
    from cometbft_tpu.state.types import State as RState
    from cometbft_tpu.storage import MemKV as RMemKV
    from cometbft_tpu.storage import StateStore as RStateStore
    from cometbft_tpu.types import block as RBL
    from cometbft_tpu_torch.abci import AppConns, KVStoreApp
    from cometbft_tpu_torch.abci.types import CheckTxResult
    from cometbft_tpu_torch.mempool import CListMempool
    from cometbft_tpu_torch.utils import factories as fx

    senders, txs, bad = ingest_world
    mp = CListMempool(AppConns(chip_smoke.once_app(KVStoreApp, CheckTxResult)), max_txs=60,
                      max_tx_bytes=chip_smoke.MAX_TX_BYTES)
    for tx in txs:
        chip_smoke.outcome_of(lambda tx=tx: mp.check_tx(tx))
    before = mp.reap_max_txs(-1)
    d = chip_smoke.blocks_leg(mp, senders[:4], "cpu", KVStoreApp, CheckTxResult, 6, "blocks",
                              137 * 30, (2, 1, 3), r_pool=fx.RPool(4, 6, device="cpu"))
    assert [e for _, e in d["carried"]] == [0, 0, 0, 0, 1, 0]
    assert d["app"].misbehavior and d["pool"].size() == 0
    committed = [tx for blk, _ in d["blocks"] for tx in RBL.Block.decode(blk).data.txs]
    assert [tx for tx in before if tx not in committed and tx not in mp.reap_max_txs(-1)] == \
        [txs[INGEST_PLANTS_SMALL["conflict"][1]]]
    final = d["final"].encode()
    assert chip_smoke.expected_blocks_state(d["genesis"].encode(), d["blocks"],
                                            chip_smoke.once_app(KVStoreApp, CheckTxResult),
                                            "blocks") == final
    rstate = RState.decode(d["genesis"].encode())
    rss = RStateStore(RMemKV())
    rss.save(rstate)
    rex = RX.BlockExecutor(RAppConns(chip_smoke.once_app(RK.KVStoreApp, RAT.CheckTxResult,
                                                         parse=r_parse_signed_tx)),
                           state_store=rss, backend="cpu",
                           evidence_pool=REvidencePool(state_store=rss, chain_id="blocks"))
    for blk_bytes, commit_bytes in d["blocks"]:
        blk = RBL.Block.decode(blk_bytes)
        assert blk.encode() == blk_bytes
        assert RBL.Commit.decode(commit_bytes).encode() == commit_bytes
        rstate = rex.apply_block(rstate, RBL.block_id_for(blk), blk)
    assert rstate.encode() == final


def test_dispatch_log_reads_each_scheduler_dispatch_from_the_trace(ingest_world, tmp_path):
    """`dispatch_log` on a manual scheduler with tracing on: two admission
    windows' verifiers coalesce into one dispatch, a third passes through
    alone; each is (requests, signatures, route, ms) in dispatch order."""
    from cometbft_tpu_torch.crypto.ed25519 import Ed25519BatchVerifier, Ed25519PubKey
    from cometbft_tpu_torch.crypto.sched import VerifyScheduler
    from cometbft_tpu_torch.mempool import parse_signed_tx
    from cometbft_tpu_torch.mempool.admission import SIGN_CONTEXT
    from cometbft_tpu_torch.utils import trace

    _, txs, bad = ingest_world
    signed = [parse_signed_tx(tx) for i, tx in enumerate(txs) if i not in bad]
    signed = [p for p in signed if p is not None]

    def window(parsed):
        bv = Ed25519BatchVerifier(device="cpu")
        for pub, sig, payload in parsed:
            bv.add(Ed25519PubKey(pub), SIGN_CONTEXT + payload, sig)
        return bv

    tap = chip_smoke.TraceTap(tmp_path / "trace.jsonl")
    trace.configure(str(tap.path))
    try:
        sched = VerifyScheduler(device="cpu", manual=True)
        tap.mark()
        pending = [sched.submit(window(signed[:5]), tenant="a", source="admission"),
                   sched.submit(window(signed[5:12]), tenant="b", source="admission")]
        sched.drain_once()
        pending.append(sched.submit(window(signed[12:15]), tenant="a", source="admission"))
        sched.drain_once()
        assert all(p.result()[0] for p in pending)
        log = chip_smoke.dispatch_log(tap)
    finally:
        trace.disable()
    assert [d[:3] for d in log] == [(2, 12, "native"), (1, 3, "native")]
    assert all(isinstance(d[3], float) and d[3] >= 0 for d in log)


# ---- phase 9's helpers (in-process consensus)

@pytest.mark.parametrize("seed,bad,n_txs", [(5, (3, 2), 24), (3, (3, 1), 32)])
def test_expected_consensus_outcome_matches_the_reference(tmp_path, seed, bad, n_txs):
    """Phase 9 (b)'s lockstep function at 4 validators and 4 heights, the
    round-0 proposal of height 3 carrying a last commit with one signature
    flipped: the port at device "cpu" (`expected_consensus_outcome`) and
    the reference's modules (backend "cpu") give the same outcome: block
    hashes, seen commits of every node, app hashes, state bytes, WAL
    records without their times, decided rounds (height 3 at round 1), the
    nil prevotes at (3, 0) and the direct check of the tampered block."""
    want = chip_smoke.expected_consensus_outcome(4, 4, tmp_path / "port", bad=bad, seed=seed,
                                                 n_txs=n_txs)
    ref = chip_smoke.lockstep_consensus(chip_smoke.consensus_modules("cometbft_tpu"), 4, 4,
                                        tmp_path / "ref", {"backend": "cpu"}, bad=bad,
                                        seed=seed, n_txs=n_txs)
    assert {k: ref[k] for k in chip_smoke.LOCKSTEP_OUTCOME_KEYS} == want
    assert want["rounds"] == [0, 0, 1, 0]
    proposer = want["proposers"]["3/0"]
    assert want["nil_prevotes"] == [i for i in range(4) if i != proposer]
    assert ref["proposers"]["3/1"] != proposer
    assert want["tamper_check"] == ("BlockValidationError",
                                    f"invalid last commit: invalid signature at index {bad[1]}")
    assert len(chip_smoke.lockstep_txs(2)) == chip_smoke.LOCKSTEP_TXS
    assert {len(tx) for tx in chip_smoke.lockstep_txs(2)} == {chip_smoke.LOCKSTEP_TX_BYTES}


def test_split_timer_takes_nested_calls_out_of_their_callers():
    """`SplitTimer` books a wrapped call's wall time to its name less the
    time of wrapped calls inside it, counts the calls, and restores the
    originals."""
    import time
    import types

    ns = types.SimpleNamespace()
    ns.inner = lambda: time.sleep(0.05)
    ns.outer = lambda: (time.sleep(0.005), ns.inner())
    timer = chip_smoke.SplitTimer()
    orig = ns.inner
    timer.wrap(ns, "inner", "inner")
    timer.wrap(ns, "outer", "outer")
    ns.outer()
    ns.inner()
    timer.restore()
    assert ns.inner is orig
    assert timer.calls == {"inner": 2, "outer": 1}
    # booked whole, outer would hold at least 55 ms
    assert timer.ms["inner"] >= 100 and 5 <= timer.ms["outer"] < 50
    assert chip_smoke.histogram_delta({(): {"count": 1, "sum": 2.0}},
                                      {(): {"count": 3, "sum": 5.0},
                                       ("x",): {"count": 1, "sum": 1.0}}) == {
        (): (2, 3.0), ("x",): (1, 1.0)}


# ---- phase 10's helpers (the verify mesh, block sync over p2p)

@pytest.fixture(scope="module")
def sync_world():
    """The reference's 5-block, 4-validator chain, crossed to the port as KV
    items: (reference store, its genesis, the port's store, its genesis)."""
    from cometbft_tpu.utils.factories import make_chain
    from cometbft_tpu_torch.state.types import State
    from cometbft_tpu_torch.storage import BlockStore, MemKV

    store, _, genesis, _ = make_chain(5, n_validators=4, chain_id="p10-chain", backend="cpu",
                                      txs_per_block=1)
    kv = MemKV()
    kv.write_batch(sorted(store._db.iterate_prefix(b"")))
    return store, genesis, BlockStore(kv), State.decode(genesis.encode())


def test_store_view_serves_to_its_top_and_forges_one_signature(sync_world):
    _, _, store, _ = sync_world
    view = chip_smoke.StoreView(store, 4, forge=(3, 1))
    assert (view.height(), view.base()) == (4, store.base()) and view.load_block(5) is None
    honest, forged = store.load_block(3), view.load_block(3)
    sigs = [cs.signature for cs in honest.last_commit.signatures]
    fsigs = [cs.signature for cs in forged.last_commit.signatures]
    assert [i for i in range(4) if sigs[i] != fsigs[i]] == [1]
    assert fsigs[1][0] == sigs[1][0] ^ 1 and forged.header.hash() == honest.header.hash()
    assert view.load_block(2).encode() == store.load_block(2).encode()


def test_host_state_and_refusal_match_the_reference(sync_world):
    """`host_state` against the reference's executor over the same blocks,
    and `host_refusal` of a forged last commit against the reference's
    `verify_commit_light` on the same commit."""
    from cometbft_tpu.abci.client import AppConns
    from cometbft_tpu.abci.kvstore import KVStoreApp
    from cometbft_tpu.state.execution import BlockExecutor
    from cometbft_tpu.types.block import block_id_for
    from cometbft_tpu.types.validation import verify_commit_light

    ref_store, ref_genesis, store, genesis = sync_world
    ex, state = BlockExecutor(AppConns(KVStoreApp()), backend="cpu"), ref_genesis.copy()
    for h in range(1, 5):
        blk = ref_store.load_block(h)
        state = ex.apply_block(state, block_id_for(blk), blk)
        if h == 2:
            at_2 = state
    assert chip_smoke.host_state(store, genesis, 4).encode() == state.encode()
    got = chip_smoke.host_refusal(chip_smoke.StoreView(store, 5, forge=(4, 2)),
                                  chip_smoke.host_state(store, genesis, 2), 3)
    ref4 = ref_store.load_block(4)
    ref4.last_commit.signatures[2].signature = bytes(
        [ref4.last_commit.signatures[2].signature[0] ^ 1]) + ref4.last_commit.signatures[2].signature[1:]
    ref4.last_commit.invalidate_memos()
    want = chip_smoke.outcome_of(lambda: verify_commit_light(
        at_2.chain_id, at_2.validators, block_id_for(ref_store.load_block(3)), 3,
        ref4.last_commit, backend="cpu"))
    assert got == want == ("ErrInvalidSignature", "invalid signature at index 2")
    assert chip_smoke.host_refusal(chip_smoke.StoreView(store, 5), chip_smoke.host_state(
        store, genesis, 2), 3) is None


def test_blocksync_phase_rehearsal(sync_world, monkeypatch, tmp_path):
    """Phase 10 (b) on the CPU at a small size (device "cpu", the plain
    ladder for every check): (b1) on the crossed chain at the reference's
    rates, (b2) and (b3) on a port chain; every check of the phase holds."""
    from cometbft_tpu_torch.ops import curve as C
    from cometbft_tpu_torch.ops import kernels as K
    from cometbft_tpu_torch.utils import trace

    for fn, name in (("decompress_plain", "decompress"),
                     ("ladder_sub_mul8_plain", "ladder_sub_mul8")):
        orig = getattr(C, fn)
        monkeypatch.setattr(C, fn, lambda *a, _o=orig, _n=name: (
            K.launches.__setitem__(_n, K.launches[_n] + 1), _o(*a))[1])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(E, "NATIVE_MAX", 0)
    monkeypatch.setattr(chip_smoke, "OUT_DIR", tmp_path)
    monkeypatch.setattr(chip_smoke, "REPLAY_CHAIN", "p10-chain")
    for name, value in (("SYNC_TOP", 2), ("SYNC_VALIDATORS", 4), ("SYNC_BLOCKS", 3),
                        ("SYNC_FORGED", (2, 1)), ("SYNC_TIMEOUT_S", 60.0)):
        monkeypatch.setattr(chip_smoke, name, value)
    _, _, store, genesis = sync_world
    kern = {n: {"launches_by_route": {}, "launches": 0} for n in chip_smoke.SOURCES}
    try:
        out = chip_smoke.blocksync_phase(torch.device("cpu"), "cpu", 3, kern,
                                         (store, None, genesis))
    finally:
        trace.disable()
    assert out["b1"]["blocks"] == 1 and out["b2"]["blocks"] == 2
    assert out["b2"]["routes"]["ladder"] >= 2 and out["b1"]["verify_ms"] > 0
    assert out["b2"]["quiet"]["verify_ms"] > 0 and out["b2"]["quiet"]["apply_ms"] > 0
    assert out["b3"]["liar"]["height"] == 0 and out["b3"]["bad_blocks"] >= 1
    assert out["b3"]["refusal"][0][2] == ("ErrInvalidSignature", "invalid signature at index 1")
    assert out["b3"]["honest"]["blocks"] == 2 and out["b3"]["sealed_frames"] > 0
    assert kern["ladder_sub_mul8"]["launches_by_route"]["blocksync"] > 0


def test_mesh_check_holds_shards_against_one_device():
    """`check_sharded` over 2 CPU shards: a batch with its last lane broken
    and an empty one agree with the single device; a sharded verifier that
    drops a shard's verdict is caught."""
    from cometbft_tpu_torch.crypto import ed25519_ref as ref
    from cometbft_tpu_torch.parallel import mesh as M

    cpu = torch.device("cpu")
    items = []
    for i in range(5):
        seed = bytes([i + 1]) * 32
        items.append((ref.pubkey_from_seed(seed), b"m%d" % i, ref.sign(seed, b"m%d" % i)))
    bad = chip_smoke.broken_lanes(items, [4])
    assert bad[:4] == items[:4] and bad[4][2][0] == items[4][2][0] ^ 1
    eng = M.MeshVerifyEngine([cpu, cpu])
    assert chip_smoke.check_sharded("t", eng, cpu, *chip_smoke.mesh_arrays(bad, 6)) is False
    assert chip_smoke.check_sharded("t", eng, cpu, *chip_smoke.mesh_arrays([], 2)) is True

    def lying(a, rsk, live):
        ok, bits = eng.submit(a, rsk, live)
        return ok, [bits[0], torch.ones_like(bits[1])]

    with pytest.raises(AssertionError, match="sharded all-ok"):
        chip_smoke.check_sharded("t", lying, cpu, *chip_smoke.mesh_arrays(bad, 6))
    assert [len(d) for d in chip_smoke.mesh_layouts(cpu)] == list(chip_smoke.MESH_SHARDS)


def test_mesh_shard_check_takes_the_last_shard_and_catches_a_wrong_ladder(monkeypatch):
    """`mesh_shard_check` over 2 CPU shards of a 6-lane batch (lane 4
    broken, lane 5 padding): it keeps the last shard's 3 lanes, checks
    `decompress` over 6 and the ladder over 3, and a ladder that differs
    from its plain version on one lane is caught."""
    from cometbft_tpu_torch.crypto import ed25519_ref as ref
    from cometbft_tpu_torch.ops import curve as C
    from cometbft_tpu_torch.parallel import mesh as M

    cpu = torch.device("cpu")
    items = []
    for i in range(5):
        seed = bytes([i + 1]) * 32
        items.append((ref.pubkey_from_seed(seed), b"m%d" % i, ref.sign(seed, b"m%d" % i)))
    arrays = chip_smoke.mesh_arrays(chip_smoke.broken_lanes(items, [4]), 6)
    eng = M.MeshVerifyEngine([cpu, cpu])
    got = chip_smoke.mesh_shard_check(eng, *arrays)
    assert got["shard_lanes"] == 3 and got["decompress_lanes"] == 6
    assert got["decompress_mismatches"] == got["ladder_mismatches"] == 0
    real = C.ladder_sub_mul8

    def off_by_one(*args):
        X, Y, Z = real(*args)
        X = X.clone()
        X[0, 1] += 1
        return X, Y, Z

    monkeypatch.setattr(C, "ladder_sub_mul8", off_by_one)
    with pytest.raises(AssertionError, match="ladder_sub_mul8 at B=3 1 lanes"):
        chip_smoke.mesh_shard_check(eng, *arrays)


# ---- phase 11's helpers (the network reactors and state sync)

def _count_plain_kernels(monkeypatch):
    """The plain decompress and ladder count as launches; the card's sync is
    a no-op."""
    from cometbft_tpu_torch.ops import curve as C
    from cometbft_tpu_torch.ops import kernels as K

    for fn, name in (("decompress_plain", "decompress"),
                     ("ladder_sub_mul8_plain", "ladder_sub_mul8")):
        orig = getattr(C, fn)
        monkeypatch.setattr(C, fn, lambda *a, _o=orig, _n=name: (
            K.launches.__setitem__(_n, K.launches[_n] + 1), _o(*a))[1])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)


@pytest.fixture
def quiet_nodes():
    from cometbft_tpu_torch.utils import log as L

    sink = L._config.sink
    L.set_sink(lambda level, msg, fields: None)
    yield
    L.set_sink(sink)


def test_tcp_leg_rehearsal(monkeypatch, tmp_path, quiet_nodes):
    """Phase 11 (a) on the CPU at a small size, the timeouts ten times
    tests/test_node.py's: 2 validators over TCP with PEX, txs at the last
    node and the equivocation committed once on every node; the pinned run
    keeps a full last commit for the window check (stubbed here: phase 9's
    rehearsal holds it)."""
    _count_plain_kernels(monkeypatch)
    for name, value in (("TCP_NODES", 2), ("TCP_HEIGHT", 3), ("TCP_TXS", 8),
                        ("TCP_PINNED_HEIGHT", 2),
                        ("TCP_TIMEOUT_S", 90.0)):
        monkeypatch.setattr(chip_smoke, name, value)
    # the plain ladder checks a last commit in ~1 s on a CPU: rounds long enough for it
    monkeypatch.setattr(chip_smoke, "TCP_TIMEOUTS",
                        {k: 10 * v for k, v in chip_smoke.TCP_TIMEOUTS.items()})
    checked = []
    monkeypatch.setattr(chip_smoke, "batch_window_check", lambda dev, card, bv, what, lane, rate: (
        checked.append((bv.count(), lane)), {"lanes": bv.count(), "bucket": E._bucket(bv.count())})[1])
    counts = {}
    out = chip_smoke.tcp_leg(torch.device("cpu"), "cpu", counts, tmp_path, 0, 1.0)
    assert out["height"] >= 3 and out["mesh_s"] > 0 and out["evidence_block"] >= 2
    assert len(set(map(tuple, out["evidence"]))) == 1 and not out["stopped"]
    assert checked and checked[0][0] >= 1 and checked[0][1] == chip_smoke.TCP_CHECK_BAD_LANE
    assert counts["tcp_pinned"]["ladder_sub_mul8"] > 0 and out["pinned"]["routes"]["ladder"] > 0


def test_gossip_leg_rehearsal(monkeypatch, tmp_path, quiet_nodes):
    """Phase 11 (b) on the CPU at 24-lane windows: a raw peer's frames to B
    over TCP, every outcome expected_ingest_outcome's, C's pool B's, no
    refused tx at C."""
    from cometbft_tpu_torch.utils import factories as fx
    from cometbft_tpu_torch.utils import trace

    _count_plain_kernels(monkeypatch)
    monkeypatch.setattr(E, "NATIVE_MAX", 0)
    for name, value in (("MAX_TX_BYTES", 1_000), ("MEMPOOL_SIZE", 60), ("BIG_WINDOW", 24),
                        ("BIG_DELAY_S", 0.5), ("GOSSIP_FRAME_TXS", 8)):
        monkeypatch.setattr(chip_smoke, name, value)
    plants = {"bad_sig": 7, "app_reject": 15, "malformed": 20, "duplicate": (30, 10),
              "oversize": 35, "conflict": (1, 40)}
    cpu = torch.device("cpu")
    txs, bad = chip_smoke.ingest_stream(fx.make_signers(8, seed=1, device=cpu), 0, 48, plants,
                                        3, cpu)
    tap = chip_smoke.TraceTap(tmp_path / "trace.jsonl")
    trace.configure(str(tap.path))
    try:
        out = chip_smoke.gossip_leg(cpu, "cpu", {}, (txs, bad), tap)
    finally:
        trace.disable()
    want = chip_smoke.expected_ingest_outcome(txs, bad, 60, 1_000)
    assert out["admitted"] == out["pool"] == sum(w is None for w in want) == out["c_received"]
    # B's windows also hold what C gossips back (refused: already seen)
    assert sum(out["windows"]["b"]) >= len(txs) and sum(out["windows"]["c"]) >= out["pool"]
    assert out["gossip_frames"] >= 1 and out["routes"]["ladder"] > 0


@pytest.fixture(scope="module")
def ss_chains():
    """Two reference chains crossed to the port: 10 blocks (for (c1), (c3))
    and 6 blocks (for (c2)), 4 validators each."""
    from cometbft_tpu.utils.factories import make_chain
    from cometbft_tpu_torch.state.types import State
    from cometbft_tpu_torch.storage import BlockStore, MemKV

    out = []
    for n, chain_id in ((10, chip_smoke.REPLAY_CHAIN), (6, chip_smoke.SYNC_CHAIN)):
        store, _, genesis, _ = make_chain(n, n_validators=4, chain_id=chain_id, backend="cpu")
        kv = MemKV()
        kv.write_batch(sorted(store._db.iterate_prefix(b"")))
        out.append((BlockStore(kv), State.decode(genesis.encode())))
    return out


def test_statesync_phase_rehearsal(ss_chains, monkeypatch, quiet_nodes):
    """Phase 11 (c) on the CPU (the plain ladder for every check): (c1) and
    (c2) restore and block-sync to the source's state, (c3) refuses the
    liar (at the honest height here, its offer first) with the reference's
    error first; (c1) takes the ladder alone and keeps its first light check
    for the window check (stubbed here: phase 9's rehearsal holds it), and
    the light time splits into fetch and verification."""
    _count_plain_kernels(monkeypatch)
    monkeypatch.setattr(E, "NATIVE_MAX", 0)
    for name, value in (("SS_C1_TOP", 10), ("SS_C1_INTERVAL", 4), ("SS_C2_INTERVAL", 2),
                        ("SS_LIAR_HEIGHT", 8), ("SS_TIMEOUT_S", 60.0),
                        ("SS_C1_CHECK_BUCKET", 64), ("SS_C1_CHECK_BAD_LANE", 1)):
        monkeypatch.setattr(chip_smoke, name, value)
    checked = []
    monkeypatch.setattr(chip_smoke, "batch_window_check", lambda dev, card, bv, what, lane, rate: (
        checked.append((bv.count(), lane)), {"lanes": bv.count(), "bucket": E._bucket(bv.count())})[1])
    counts = {}
    out = chip_smoke.statesync_phase(torch.device("cpu"), "cpu", counts, ss_chains, 1.0)
    assert checked == [(out["c1"]["window_check"]["lanes"], 1)] and checked[0][0] >= 2
    assert set(out["c1"]["restore_routes"]) == {"ladder", "batch"}
    for k in ("c1", "c2", "c3"):
        assert out[k]["fetches"] >= out[k]["light_blocks"] and 0 < out[k]["fetch_s"]
        assert out[k]["fetch_worst_s"] <= out[k]["fetch_s"] < out[k]["light_s"]
        assert out[k]["verify_s"] == pytest.approx(out[k]["light_s"] - out[k]["fetch_s"])
    assert [out[k]["snapshot_height"] for k in ("c1", "c2", "c3")] == [8, 4, 8]
    assert [out[k]["blocks"] for k in ("c1", "c2", "c3")] == [1, 1, 1]
    assert out["c3"]["rejected"] == [(8, chip_smoke.SS_LIAR_ERROR)]
    assert out["c1"]["rejected"] == out["c2"]["rejected"] == []
    assert out["c2"]["light_heights"] == [1, 4, 5, 6] and out["c1"]["light_ms_a_block"] > 0
    assert all(out[k]["launches"]["ladder_sub_mul8"] for k in ("c1", "c2", "c3"))


# ---- phase 12's legs (the node)

@pytest.fixture
def node_out(monkeypatch, tmp_path):
    """The node processes' logs under tmp_path; the kernels' card sync a
    no-op."""
    monkeypatch.setattr(chip_smoke, "OUT_DIR", tmp_path / "out")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    (tmp_path / "out" / "node").mkdir(parents=True)
    return tmp_path


def test_node_single_leg_rehearsal(monkeypatch, node_out, quiet_nodes):
    """Phase 12 (a) on the CPU with 16 txs: `cli init`'s defaults, every tx
    committed over HTTP and read back with its proof, one NewBlock event a
    height, and the restart replaying every stored block into a fresh app
    before committing more."""
    monkeypatch.setattr(chip_smoke, "NODE_TXS", 16)
    out = chip_smoke.node_single_leg(torch.device("cpu"), "cpu", node_out / "single")
    assert out["replayed"] == out["heights"] >= 2 and out["ws_events"] >= 1
    assert out["height_after"] >= out["heights"] + chip_smoke.NODE_RESTART_HEIGHTS
    assert 0 < out["commit_ms_p50"] <= out["commit_ms_p99"]


def test_node_procs_leg_rehearsal(monkeypatch, node_out):
    """Phase 12 (b) on the CPU: 4 processes from `cli testnet` (the backend
    set to "cpu") to height 3 with 16 txs sent at node 3, equal at every
    height, each exiting 0 on SIGTERM."""
    monkeypatch.setattr(chip_smoke, "NODE_PROC_HEIGHT", 3)
    monkeypatch.setattr(chip_smoke, "NODE_PROC_TXS", 16)
    out = chip_smoke.node_procs_leg(torch.device("cpu"), "cpu", node_out,
                                    node_out / "out" / "node")
    assert out["height"] >= 3 and out["exit_codes"] == [0] * chip_smoke.NODE_PROCS
    assert out["block_interval_s"] > 0


def test_node_catchup_leg_rehearsal(monkeypatch, node_out, quiet_nodes):
    """Phase 12 (c) on the CPU at 24 validators: every check on the plain
    ladder (NATIVE_MAX at 0, counted as launches); a source process on the
    first 3 heights of a 4-block chain, a fresh Node catching up 2 blocks
    through Node.start() to the host's state. The plain ladder takes
    seconds a check on a loaded CPU, so block sync gets 300 s here where
    the node gives it 30."""
    from cometbft_tpu_torch.blocksync.reactor import BlockSyncReactor
    from cometbft_tpu_torch.utils import factories as fx

    store, _, genesis, _ = fx.make_chain(4, n_validators=24, chain_id=chip_smoke.SYNC_CHAIN,
                                         txs_per_block=1, device="cpu")
    _count_plain_kernels(monkeypatch)
    monkeypatch.setattr(E, "NATIVE_MAX", 0)
    monkeypatch.setattr(chip_smoke, "NODE_SOURCE_TOP", 3)
    sync = BlockSyncReactor.sync
    monkeypatch.setattr(BlockSyncReactor, "sync",
                        lambda self, timeout_s=60.0, **k: sync(self, timeout_s=300.0, **k))
    counts = {}
    out = chip_smoke.node_catchup_leg(torch.device("cpu"), "cpu", counts, node_out,
                                      node_out / "out" / "node", (store, genesis))
    assert out["blocks"] == 2 and out["exit_codes"] == [0] and out["validators"] == 24
    assert counts["catchup"]["decompress"] and counts["catchup"]["ladder_sub_mul8"]
    assert out["routes"]["ladder"] >= 2
