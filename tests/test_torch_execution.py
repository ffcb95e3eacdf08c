"""The port's block execution (`state/execution.py`) against the JAX
package's.

One chain is made by the reference (`make_chain`, 6 blocks x 4
validators) with an app that raises validator 0's power at height 2, so
the blocks from height 4 on are signed by a set of unequal powers. Its
blocks and states cross to the port as bytes. Every comparison is exact:
the same bytes, or the same exception class and message.
"""

from __future__ import annotations

import json
import types

import pytest

torch = pytest.importorskip("torch")

from cometbft_tpu import types as RTY  # noqa: E402
from cometbft_tpu.abci import kvstore as RK  # noqa: E402
from cometbft_tpu.abci import types as RAT  # noqa: E402
from cometbft_tpu.abci.client import AppConns as RAppConns  # noqa: E402
from cometbft_tpu.state import execution as RX  # noqa: E402
from cometbft_tpu.storage import MemKV as RMemKV  # noqa: E402
from cometbft_tpu.storage import StateStore as RStateStore  # noqa: E402
from cometbft_tpu.utils import factories as RF  # noqa: E402
from cometbft_tpu_torch import types as TY  # noqa: E402
from cometbft_tpu_torch.abci import AppConns, KVStoreApp  # noqa: E402
from cometbft_tpu_torch.abci import types as AT  # noqa: E402
from cometbft_tpu_torch.state import execution as X  # noqa: E402
from cometbft_tpu_torch.state.types import State  # noqa: E402
from cometbft_tpu_torch.storage import MemKV, StateStore  # noqa: E402
from cometbft_tpu_torch.types.validator_set import UnsupportedKeyType  # noqa: E402
from cometbft_tpu_torch.utils import fail, trace, txlife  # noqa: E402

CHAIN = "exec-chain"
N_BLOCKS = 6
BUMP = (2, 25)  # (height, new power of validator 0)


def bump_app(kvstore_cls, update_cls, pub: bytes):
    class Bump(kvstore_cls):
        def finalize_block(self, req):
            resp = super().finalize_block(req)
            if req.height == BUMP[0]:
                resp.validator_updates.append(update_cls(pub, "ed25519", BUMP[1]))
            return resp

    return Bump()


@pytest.fixture(scope="module")
def world():
    """The reference's chain and, per height h, its state after h blocks
    (0: genesis) and the port's decoded blocks."""
    pub = RF.make_signers(1, seed=0)[0].pub_bytes
    store, final, genesis, _ = RF.make_chain(
        N_BLOCKS, n_validators=4, chain_id=CHAIN, backend="cpu",
        app=bump_app(RK.KVStoreApp, RAT.ValidatorUpdate, pub))
    ex = RX.BlockExecutor(RAppConns(bump_app(RK.KVStoreApp, RAT.ValidatorUpdate, pub)),
                          backend="cpu")
    states = [genesis]
    for h in range(1, N_BLOCKS + 1):
        blk = store.load_block(h)
        states.append(ex.apply_block(states[-1], RTY.block.block_id_for(blk), blk))
    assert states[-1].encode() == final.encode()
    raw = {h: store._db.get(b"B:" + h.to_bytes(8, "big")) for h in range(1, N_BLOCKS + 1)}
    return types.SimpleNamespace(store=store, states=states, raw=raw, pub=pub)


def port_state(r_state) -> State:
    return State.decode(r_state.encode())


def outcome(call):
    try:
        call()
    except Exception as e:  # noqa: BLE001 — compared by class and message
        return type(e).__name__, str(e)
    return None


def test_powers_are_unequal_from_height_4(world):
    powers = sorted(v.voting_power for v in world.states[3].validators.validators)
    assert powers == [10, 10, 10, 25]
    assert world.states[2].validators.hash() != world.states[3].validators.hash()


def _set_commit(blk, commit):
    blk.last_commit = commit
    blk.header.last_commit_hash = commit.hash()


# one mutation per check of validate_block (reference state/execution.py:140-211),
# each (height of the block, edit(block, types module)); height 1 checks the
# initial block
MUTATIONS = {
    "valid": (5, lambda b, t: None),
    "valid_initial": (1, lambda b, t: None),
    "chain_id": (5, lambda b, t: setattr(b.header, "chain_id", "other-chain")),
    "height": (5, lambda b, t: setattr(b.header, "height", 6)),
    "last_block_id": (5, lambda b, t: setattr(b.header, "last_block_id", t.BlockID(
        b"\x01" * 32, t.PartSetHeader(1, b"\x02" * 32)))),
    "validators_hash": (5, lambda b, t: setattr(b.header, "validators_hash", b"\x03" * 32)),
    "next_validators_hash": (5, lambda b, t: setattr(b.header, "next_validators_hash",
                                                     b"\x04" * 32)),
    "consensus_hash": (5, lambda b, t: setattr(b.header, "consensus_hash", b"\x05" * 32)),
    "app_hash": (5, lambda b, t: setattr(b.header, "app_hash", b"\x06" * 32)),
    "last_results_hash": (5, lambda b, t: setattr(b.header, "last_results_hash", b"\x07" * 32)),
    "data_hash": (5, lambda b, t: b.data.txs.__setitem__(0, b"evil=1")),
    "last_commit_hash": (5, lambda b, t: setattr(b.header, "last_commit_hash", b"\x08" * 32)),
    "evidence_hash": (5, lambda b, t: setattr(b.header, "evidence_hash", b"\x09" * 32)),
    "initial_last_commit": (1, lambda b, t: _set_commit(b, t.Commit(
        0, 0, t.BlockID(), [t.CommitSig.absent()]))),
    "last_commit_size": (5, lambda b, t: _set_commit(b, t.Commit(
        b.last_commit.height, b.last_commit.round, b.last_commit.block_id,
        list(b.last_commit.signatures)[:3]))),
    "last_commit_signature": (5, lambda b, t: _set_commit(b, t.Commit(
        b.last_commit.height, b.last_commit.round, b.last_commit.block_id,
        [s if i != 2 else t.CommitSig(s.block_id_flag, s.validator_address, s.timestamp,
                                      bytes([s.signature[0] ^ 1]) + s.signature[1:])
         for i, s in enumerate(b.last_commit.signatures)]))),
    "last_commit_block_id": (5, lambda b, t: _set_commit(b, t.Commit(
        b.last_commit.height, b.last_commit.round, t.BlockID(b"\x0a" * 32),
        list(b.last_commit.signatures)))),
    "block_time": (5, lambda b, t: setattr(b.header, "time", t.Timestamp(
        b.header.time.seconds, b.header.time.nanos + 1))),
    "proposer_address": (5, lambda b, t: setattr(b.header, "proposer_address", b"\x0b" * 19)),
    "proposer_address_empty": (3, lambda b, t: setattr(b.header, "proposer_address", b"")),
    "da_root": (5, lambda b, t: setattr(b.header, "da_root", b"\x0c" * 31)),
}


@pytest.mark.parametrize("case", list(MUTATIONS))
def test_validate_block_matches_reference(world, case):
    h, edit = MUTATIONS[case]
    blk = TY.Block.decode(world.raw[h])
    r_blk = RTY.Block.decode(world.raw[h])
    edit(blk, TY)
    edit(r_blk, RTY)
    want = outcome(lambda: RX.validate_block(world.states[h - 1], r_blk, backend="cpu"))
    got = outcome(lambda: X.validate_block(port_state(world.states[h - 1]), blk, device="cpu"))
    assert got == want
    assert (want is None) == (case in ("valid", "valid_initial"))


def test_apply_block_with_state_store_gives_the_same_bytes(world):
    """Blocks 1..6 through both executors with a state store: the same
    state after every block and the same state-store items (states,
    validator sets by height, params, results hashes and the encoded
    FinalizeBlock responses), across the power change."""
    r_ss, ss = RStateStore(RMemKV()), StateStore(MemKV())
    r_ex = RX.BlockExecutor(RAppConns(bump_app(RK.KVStoreApp, RAT.ValidatorUpdate, world.pub)),
                            state_store=r_ss, backend="cpu")
    ex = X.BlockExecutor(AppConns(bump_app(KVStoreApp, AT.ValidatorUpdate, world.pub)),
                         state_store=ss, device="cpu")
    r_state, state = world.states[0], port_state(world.states[0])
    for h in range(1, N_BLOCKS + 1):
        r_blk, blk = RTY.Block.decode(world.raw[h]), TY.Block.decode(world.raw[h])
        r_state = r_ex.apply_block(r_state, RTY.block.block_id_for(r_blk), r_blk)
        state = ex.apply_block(state, TY.block.block_id_for(blk), blk)
        assert state.encode() == r_state.encode() == world.states[h].encode()
    assert dict(ss._db.iterate_prefix(b"")) == dict(r_ss._db.iterate_prefix(b""))
    assert ss.load_abci_responses(BUMP[0]) == r_ss.load_abci_responses(BUMP[0])


@pytest.mark.parametrize("updates", [[("v0", 25)], [("v0", 0)], [("new", 7), ("v1", 3)], []])
def test_update_state_matches_reference(world, updates):
    """`_update_state` rotates the three sets and applies the app's
    validator updates (a power change, a removal, an addition) as the
    reference does."""
    r_state = world.states[4]
    vals = r_state.next_validators.validators
    keys = {"v0": vals[0].pub_key.bytes(), "v1": vals[1].pub_key.bytes(),
            "new": RF.make_signers(6, seed=9)[5].pub_bytes}
    r_blk, blk = RTY.Block.decode(world.raw[5]), TY.Block.decode(world.raw[5])
    r_resp = RAT.FinalizeBlockResponse(
        tx_results=[RAT.ExecTxResult(data=b"v0")],
        validator_updates=[RAT.ValidatorUpdate(keys[k], "ed25519", p) for k, p in updates],
        app_hash=b"\x01" * 32)
    resp = AT.FinalizeBlockResponse(
        tx_results=[AT.ExecTxResult(data=b"v0")],
        validator_updates=[AT.ValidatorUpdate(keys[k], "ed25519", p) for k, p in updates],
        app_hash=b"\x01" * 32)
    r_ex = RX.BlockExecutor(RAppConns(RK.KVStoreApp()), backend="cpu")
    ex = X.BlockExecutor(AppConns(KVStoreApp()), device="cpu")
    want = r_ex._update_state(r_state, RTY.block.block_id_for(r_blk), r_blk, r_resp)
    got = ex._update_state(port_state(r_state), TY.block.block_id_for(blk), blk, resp)
    assert got.encode() == want.encode()
    assert got.last_height_validators_changed == want.last_height_validators_changed


def _with_slots(commit_cls, sig_cls, commit, absent=(), nil=()):
    """A copy of `commit` with slots made absent or NIL (signatures kept:
    median time never verifies them)."""
    sigs = []
    for i, s in enumerate(commit.signatures):
        if i in absent:
            sigs.append(sig_cls.absent())
        elif i in nil:
            sigs.append(sig_cls(3, s.validator_address, s.timestamp, s.signature))
        else:
            sigs.append(s)
    return commit_cls(commit.height, commit.round, commit.block_id, sigs)


@pytest.mark.parametrize("h, absent, nil", [(5, (), ()), (6, (0,), ()), (6, (), (0, 2)),
                                            (4, (1, 3), ()), (5, (0, 1, 2, 3), ())])
def test_median_time_with_unequal_powers(world, h, absent, nil):
    """The weighted median of the last commit's timestamps under the
    unequal set (validator 0 at 25 of 55): the port's columnar form and
    its slot walk both give the reference's timestamp."""
    r_vals = world.states[h - 1].last_validators
    vals = port_state(world.states[h - 1]).last_validators
    r_commit = _with_slots(RTY.Commit, RTY.CommitSig, RTY.Block.decode(world.raw[h]).last_commit,
                           absent, nil)
    commit = _with_slots(TY.Commit, TY.CommitSig, TY.Block.decode(world.raw[h]).last_commit,
                         absent, nil)
    want = RX.median_time(r_commit, r_vals)
    want = (want.seconds, want.nanos)
    got = X.median_time(commit, vals)  # a hand-built commit: the slot walk
    assert X._median_time_columnar(commit, vals) is None
    assert (got.seconds, got.nanos) == want
    decoded = TY.Commit.decode(commit.encode())  # native decode columns: the columnar form
    fast = X._median_time_columnar(decoded, vals)
    assert (fast.seconds, fast.nanos) == want


def test_build_last_commit_info_matches_reference(world):
    for h in (1, 2, 5):
        r_blk, blk = RTY.Block.decode(world.raw[h]), TY.Block.decode(world.raw[h])
        want = RX.build_last_commit_info(r_blk, world.states[h - 1].last_validators)
        got = X.build_last_commit_info(blk, port_state(world.states[h - 1]).last_validators)
        assert (got.round, got.votes) == (want.round, want.votes)


def test_create_proposal_block_matches_the_stored_blocks(world):
    """The proposer side: the block the port's executor builds from the
    reference's state and last commit is the stored block, byte for byte."""
    ex = X.BlockExecutor(AppConns(KVStoreApp()), device="cpu")
    for h in (1, 4):
        stored = TY.Block.decode(world.raw[h])
        state = port_state(world.states[h - 1])
        blk = ex.create_proposal_block(h, state, stored.last_commit,
                                       stored.header.proposer_address, list(stored.data.txs),
                                       block_time=state.last_block_time)
        assert blk.encode() == world.raw[h]
    assert ex.process_proposal(stored) is True


def test_genesis_state_matches_reference(world):
    vals = port_state(world.states[0]).validators
    genesis = X.make_genesis_state(CHAIN, vals)
    assert genesis.encode() == world.states[0].encode()


@pytest.mark.parametrize("key_type", ["secp256k1", "tendermint/PubKeySecp256k1", "sr25519"])
def test_non_ed25519_validator_update(world, key_type):
    """A secp256k1 update, which the reference applies, is refused by name;
    an unknown type raises the reference's BlockValidationError."""
    vu = AT.ValidatorUpdate(b"\x02" + b"\x11" * 32, key_type, 5)
    r_vu = RAT.ValidatorUpdate(b"\x02" + b"\x11" * 32, key_type, 5)
    got = outcome(lambda: X._pub_key_from_update(vu))
    if key_type == "sr25519":
        assert got == outcome(lambda: RX._pub_key_from_update(r_vu))
        return
    assert got == ("UnsupportedKeyType",
                   f"unsupported key type {key_type}: the port verifies ed25519 only")
    assert RX._pub_key_from_update(r_vu).type_tag() == "tendermint/PubKeySecp256k1"
    ex = X.BlockExecutor(AppConns(bump_app(KVStoreApp, lambda *a: vu, world.pub)), device="cpu")
    state = port_state(world.states[1])
    blk = TY.Block.decode(world.raw[2])
    with pytest.raises(UnsupportedKeyType, match=f"unsupported key type {key_type}"):
        ex.apply_block(state, TY.block.block_id_for(blk), blk)


def test_cuda_without_a_gpu_raises(world, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        X.BlockExecutor(AppConns(KVStoreApp()))
    blk = TY.Block.decode(world.raw[2])
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        X.validate_block(port_state(world.states[1]), blk, last_commit_preverified=True)


def test_apply_block_span_and_lifecycle_stamps(world, tmp_path):
    """With tracing on and every tx sampled, apply_block writes one
    `state.apply_block` span and the apply, commit and notify stamps of
    its tx; the state metrics observe the block."""
    from cometbft_tpu_torch.utils.metrics import consensus_metrics, state_metrics

    sink = tmp_path / "trace.jsonl"
    trace.configure(str(sink))
    txlife.configure(1)
    try:
        ex = X.BlockExecutor(AppConns(KVStoreApp()), device="cpu")
        blk = TY.Block.decode(world.raw[1])
        ex.apply_block(port_state(world.states[0]), TY.block.block_id_for(blk), blk)
    finally:
        trace.disable()
        txlife.reset()
    recs = [json.loads(line) for line in sink.read_text().splitlines()]
    spans = [r for r in recs if r["name"] == "state.apply_block"]
    assert len(spans) == 1 and spans[0]["height"] == 1 and spans[0]["txs"] == 2
    assert {"validate_ms", "finalize_ms", "commit_ms", "save_events_ms"} <= set(spans[0])
    stages = [r["stage"] for r in recs if r["name"] == "tx.lifecycle"]
    assert stages == ["apply", "apply", "commit", "commit", "notify", "notify"]
    assert state_metrics().block_processing_time.snapshot()[()]["count"] >= 1
    assert consensus_metrics().tx_stage_seconds.snapshot()  # apply -> commit -> notify spans
    assert txlife.rate == txlife.DEFAULT_RATE and txlife.enabled


def test_fail_point_dies_at_the_configured_call(monkeypatch):
    """FAIL_TEST_INDEX=N: the N-th fail_point() call (0-based) ends the
    process; unset, none does."""
    calls = []
    monkeypatch.setattr(fail.os, "_exit", lambda code: calls.append(code))
    monkeypatch.delenv("FAIL_TEST_INDEX", raising=False)
    fail.reset()
    for _ in range(3):
        fail.fail_point()
    assert calls == []
    monkeypatch.setenv("FAIL_TEST_INDEX", "2")
    fail.reset()
    for i in range(4):
        fail.fail_point()
        assert calls == ([1] if i >= 2 else [])
    fail.reset()


@pytest.mark.parametrize("bundle", ["StateMetrics", "StoreMetrics", "ConsensusMetrics",
                                    "CryptoMetrics"])
def test_metric_bundles_line_up_with_the_reference(bundle):
    """Each metric of the port's bundles is the reference's same-named
    metric: its full name, kind, labels and buckets."""
    from cometbft_tpu.utils import metrics as RM
    from cometbft_tpu_torch.utils import metrics as M

    port = vars(getattr(M, bundle)(M.Registry()))
    ref = vars(getattr(RM, bundle)(RM.Registry()))
    assert port and set(port) <= set(ref)

    def shape(m):
        return (type(m).__name__, m.name, tuple(m.labels), getattr(m, "buckets", None))

    assert {k: shape(m) for k, m in port.items()} == {k: shape(ref[k]) for k in port}


def test_histogram_exemplars_as_the_reference():
    from cometbft_tpu.utils import metrics as RM
    from cometbft_tpu_torch.utils import metrics as M

    h = M.Registry().histogram("x", "y", buckets=(1, 2))
    r = RM.Registry().histogram("x", "y", buckets=(1, 2))
    for m in (h, r):
        m.observe(0.5, exemplar="aa")
        m.observe(1.5)
        m.observe(9, exemplar="bb")
    assert {k: {i: v[:2] for i, v in e.items()} for k, e in h.exemplars().items()} == \
        {k: {i: v[:2] for i, v in e.items()} for k, e in r.exemplars().items()} == \
        {(): {0: ("aa", 0.5), 2: ("bb", 9)}}


@pytest.mark.parametrize("rate", [0, 1, 2, 7, 64])
def test_txlife_samples_the_reference_txs(rate):
    """At each sampling rate (0 off, 1 in N otherwise) the port samples the
    same txs of a block as the reference, so both backends' lifecycle
    records follow the same transactions."""
    from cometbft_tpu.utils import txlife as RL

    txs = [b"k%d=v%d" % (i, i * 7) for i in range(512)]
    try:
        txlife.configure(rate)
        RL.configure(rate)
        got = txlife.sampled_keys(txs)
        assert got == RL.sampled_keys(txs)
        assert txlife.enabled == bool(rate) and len(got) <= len(txs)
        if rate == 1:
            assert len(got) == len(txs)
    finally:
        txlife.reset()
        RL.reset()
