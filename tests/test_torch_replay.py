"""The port's chain generation and block-sync replay against the JAX
package's.

One chain per package (`make_chain`, 10 blocks x 4 validators, NIL votes
at heights 2 and 10, nonces from an `RPool`), each made with a small
`KVStoreApp` subclass that raises validator 0's power at height 7, so
the set changes at height 9: the two stores hold the same KV items and
the same final state. The port's `ReplayEngine` replays the reference's
store (carried across as KV items) in full and batched modes, across the
set change, to the reference's final state with the reference's
`sigs_verified`; a tampered block fails with the reference's class and
message. The port runs on the CPU (the kernels' plain versions, or the
native route under NATIVE_MAX), the reference with `backend="cpu"`.
"""

from __future__ import annotations

import types

import pytest

torch = pytest.importorskip("torch")

from cometbft_tpu.abci import kvstore as RK  # noqa: E402
from cometbft_tpu.abci import types as RAT  # noqa: E402
from cometbft_tpu.abci.client import AppConns as RAppConns  # noqa: E402
from cometbft_tpu.blocksync import ReplayEngine as RReplayEngine  # noqa: E402
from cometbft_tpu.state import execution as RX  # noqa: E402
from cometbft_tpu.storage import BlockStore as RBlockStore  # noqa: E402
from cometbft_tpu.storage import MemKV as RMemKV  # noqa: E402
from cometbft_tpu.utils import factories as RF  # noqa: E402
from cometbft_tpu_torch.abci import AppConns, KVStoreApp  # noqa: E402
from cometbft_tpu_torch.abci import types as AT  # noqa: E402
from cometbft_tpu_torch.blocksync import ReplayEngine  # noqa: E402
from cometbft_tpu_torch.crypto import ed25519 as E  # noqa: E402
from cometbft_tpu_torch.state import execution as X  # noqa: E402
from cometbft_tpu_torch.state.types import State  # noqa: E402
from cometbft_tpu_torch.storage import BlockStore, MemKV  # noqa: E402
from cometbft_tpu_torch.utils import factories as fx  # noqa: E402
from cometbft_tpu_torch.utils.metrics import crypto_metrics  # noqa: E402

CHAIN = "replay-chain"
N_BLOCKS = 10
BUMP = (7, 25)  # (height, new power of validator 0): the set changes at height 9
NIL = {2: {1}, 10: {2}}


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
    pub = fx.make_signers(1, seed=0, device="cpu")[0].pub_bytes
    port = fx.make_chain(N_BLOCKS, n_validators=4, chain_id=CHAIN, device="cpu", nil_votes=NIL,
                         app=bump_app(KVStoreApp, AT.ValidatorUpdate, pub),
                         r_pool=fx.RPool(4, 16, device="cpu"))
    ref = RF.make_chain(N_BLOCKS, n_validators=4, chain_id=CHAIN, backend="cpu", nil_votes=NIL,
                        app=bump_app(RK.KVStoreApp, RAT.ValidatorUpdate, pub),
                        r_pool=RF.RPool(4, 16))
    return types.SimpleNamespace(port=port, ref=ref, pub=pub)


def items(kv) -> dict:
    return dict(kv.iterate_prefix(b""))


def carried(ref_store) -> BlockStore:
    kv = MemKV()
    kv.write_batch(sorted(items(ref_store._db).items()))
    return BlockStore(kv)


def port_replay(world, store, mode="batched", window=64, depth=None, to_height=None, **kw):
    ex = X.BlockExecutor(AppConns(bump_app(KVStoreApp, AT.ValidatorUpdate, world.pub)),
                         device="cpu")
    eng = ReplayEngine(store, ex, verify_mode=mode, window=window, device="cpu", depth=depth,
                       **kw)
    return eng.run(State.decode(world.ref[2].encode()), to_height)


def ref_replay(world, store, mode="batched", window=64, depth=None, to_height=None):
    ex = RX.BlockExecutor(RAppConns(bump_app(RK.KVStoreApp, RAT.ValidatorUpdate, world.pub)),
                          backend="cpu")
    eng = RReplayEngine(store, ex, verify_mode=mode, window=window, backend="cpu", depth=depth)
    return eng.run(world.ref[2].copy(), to_height)


def outcome(call):
    try:
        call()
    except Exception as e:  # noqa: BLE001 — compared by class and message
        return type(e).__name__, str(e)
    return None


def test_make_chain_byte_identical(world):
    (store, final, genesis, signers), (r_store, r_final, r_genesis, r_signers) = world.port, world.ref
    assert items(store._db) == items(r_store._db)
    assert final.encode() == r_final.encode() and genesis.encode() == r_genesis.encode()
    assert [(s.scalar, s.pub_bytes) for s in signers] == \
        [(s.scalar, s.pub_bytes) for s in r_signers]
    assert final.validators.hash() != genesis.validators.hash()  # the set changed
    assert store.load_block(9).header.validators_hash != store.load_block(8).header.validators_hash


@pytest.mark.parametrize("mode, window, depth", [
    ("full", 64, None), ("batched", 64, None), ("batched", 2, 1), ("batched", 2, 4),
    ("batched", 3, 1), ("batched", 3, 4)])
def test_replay_matches_reference(world, mode, window, depth):
    state, stats = port_replay(world, carried(world.ref[0]), mode, window, depth)
    r_state, r_stats = ref_replay(world, world.ref[0], mode, window, depth)
    assert state.encode() == r_state.encode() == world.ref[1].encode()
    assert (stats.blocks, stats.sigs_verified) == (r_stats.blocks, r_stats.sigs_verified)
    assert stats.blocks == N_BLOCKS
    # the port's own store replays to the same state
    again, _ = port_replay(world, world.port[0], mode, window, depth)
    assert again.encode() == state.encode()


def test_window_3_over_8_blocks_verifies_40_signatures(world):
    """Windows of 3 over the 8 blocks of the first set: [1-3] last commits
    2, 3 + tip 3 = 12 lanes; [4-6] 16; [7-8] 12 -> 40 with 4 validators."""
    state, stats = port_replay(world, carried(world.ref[0]), window=3, to_height=8)
    r_state, r_stats = ref_replay(world, world.ref[0], window=3, to_height=8)
    assert stats.sigs_verified == r_stats.sigs_verified == 40
    assert state.encode() == r_state.encode()


def test_set_change_drains_and_requeues(world):
    """A window never spans the set change: the windows are [1-8] and
    [9-10]; the second is queued after block 8 applies, against the state
    the change produced."""
    seen = []

    class Recording(ReplayEngine):
        def _queue_window(self, chain_id, validators, lc_vals, prev_bid, initial_height, blocks):
            seen.append(([b.header.height for b in blocks], validators.hash()))
            return super()._queue_window(chain_id, validators, lc_vals, prev_bid,
                                         initial_height, blocks)

    ex = X.BlockExecutor(AppConns(bump_app(KVStoreApp, AT.ValidatorUpdate, world.pub)),
                         device="cpu")
    state, stats = Recording(carried(world.ref[0]), ex, device="cpu").run(
        State.decode(world.ref[2].encode()))
    assert [h for h, _ in seen] == [list(range(1, 9)), [9, 10]]
    assert seen[0][1] != seen[1][1] == state.validators.hash()
    assert stats.sigs_verified == (7 + 1) * 4 + (2 + 1) * 4 - 1  # the tip's NIL vote


@pytest.mark.parametrize("mode", ["batched", "full"])
def test_tampered_block_fails_as_the_reference(world, mode):
    r_tampered, tampered = RBlockStore(RMemKV()), BlockStore(MemKV())
    for h in range(1, N_BLOCKS + 1):
        blk = world.ref[0].load_block(h)
        if h == 4:
            blk.data.txs[0] = b"evil=1"
        r_tampered.save_block(blk, world.ref[0].load_seen_commit(h))
    tampered._db.write_batch(sorted(items(r_tampered._db).items()))
    tampered = BlockStore(tampered._db)
    want = outcome(lambda: ref_replay(world, r_tampered, mode))
    assert want is not None
    assert outcome(lambda: port_replay(world, tampered, mode)) == want


@pytest.mark.parametrize("mode, window", [("batched", 64), ("batched", 3), ("full", 64)])
def test_absent_slot_in_the_tip_commit(world, mode, window):
    """The tip's seen commit with an absent slot (and so a lane dropped
    from the window's mega-batch): the reference's state and count."""
    r_signers = world.ref[3]
    signers = [fx.ScalarSigner(s.scalar, s.pub_bytes) for s in r_signers]
    r_vals = world.ref[1].last_validators  # the set that signed height 10
    vals = State.decode(world.ref[1].encode()).last_validators
    bid = world.ref[1].last_block_id
    r_commit = RF.make_commit(CHAIN, N_BLOCKS, 0, bid, r_vals,
                              {s.address(): s for s in r_signers}, absent={3},
                              r_pool=RF.RPool(4, 1, seed=77))
    from cometbft_tpu_torch.types import BlockID, PartSetHeader

    p_bid = BlockID(bid.hash, PartSetHeader(bid.part_set_header.total,
                                            bid.part_set_header.hash))
    commit = fx.make_commit(CHAIN, N_BLOCKS, 0, p_bid, vals, {s.address(): s for s in signers},
                            absent={3}, device="cpu", r_pool=fx.RPool(4, 1, seed=77, device="cpu"))
    assert commit.encode() == r_commit.encode()
    r_store = RBlockStore(RMemKV())
    for h in range(1, N_BLOCKS + 1):
        r_store.save_block(world.ref[0].load_block(h),
                           r_commit if h == N_BLOCKS else world.ref[0].load_seen_commit(h))
    state, stats = port_replay(world, carried(r_store), mode, window)
    r_state, r_stats = ref_replay(world, r_store, mode, window)
    assert state.encode() == r_state.encode()
    assert stats.sigs_verified == r_stats.sigs_verified


def test_pipeline_depth_without_a_mesh(world):
    store = BlockStore(MemKV())
    ex = X.BlockExecutor(AppConns(KVStoreApp()), device="cpu")
    assert ReplayEngine(store, ex, device="cpu")._pipeline_depth() == 2
    assert ReplayEngine(store, ex, device="cpu", depth=4)._pipeline_depth() == 4
    assert ReplayEngine(store, ex, device="cpu", depth=0)._pipeline_depth() == 2
    with pytest.raises(ValueError, match="unknown verify_mode"):
        ReplayEngine(store, ex, verify_mode="fast", device="cpu")


def test_plain_ladder_route_under_replay(world, monkeypatch):
    """NATIVE_MAX = 0: the first window (blocks 1-3, 11 lanes: height 2's
    NIL vote is verified too) takes the device route on the CPU, the plain
    `decompress` and ladder, and the state is the reference's."""
    from cometbft_tpu_torch.ops import curve

    monkeypatch.setattr(E, "NATIVE_MAX", 0)
    calls = {"decompress": 0, "ladder": 0}
    for name, key in (("decompress_plain", "decompress"), ("ladder_sub_mul8_plain", "ladder")):
        real = getattr(curve, name)

        def wrapped(*a, _real=real, _key=key, **kw):
            calls[_key] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(curve, name, wrapped)
    before = crypto_metrics().path_selected_total.values()
    state, stats = port_replay(world, carried(world.ref[0]), window=3, to_height=3)
    r_state, r_stats = ref_replay(world, world.ref[0], window=3, to_height=3)
    assert state.encode() == r_state.encode()
    assert stats.sigs_verified == r_stats.sigs_verified == 12
    after = crypto_metrics().path_selected_total.values()
    key = ("ladder", "ed25519")
    assert after.get(key, 0) - before.get(key, 0) == 1
    assert calls["ladder"] == 1 and calls["decompress"] >= 1


def test_windows_through_the_shared_scheduler(world):
    from cometbft_tpu_torch.crypto import sched as S

    sched = S.VerifyScheduler(device="cpu")
    try:
        state, stats = port_replay(world, carried(world.ref[0]), window=3, sched=sched,
                                   tenant="replay")
    finally:
        sched.close()
    r_state, r_stats = ref_replay(world, world.ref[0], window=3)
    assert state.encode() == r_state.encode()
    assert stats.sigs_verified == r_stats.sigs_verified
    assert sched.tenant_stats()["replay"] == stats.sigs_verified


def test_cuda_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ex = X.BlockExecutor(AppConns(KVStoreApp()), device="cpu")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        ReplayEngine(BlockStore(MemKV()), ex)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        fx.make_chain(1)


def test_certificate_commit_in_store_is_refused_by_name(world):
    """A store whose tip commit is certificate-native (fields 5-8, no
    signature column): the port has no certificate branch, so replay
    stops at that commit's decode, naming the format, after applying the
    blocks before the window that needs it."""
    from cometbft_tpu_torch.encoding import proto as pb
    from cometbft_tpu_torch.types.block import UnsupportedCommitFormat

    seen = world.ref[0].load_seen_commit(N_BLOCKS)
    cert = (pb.f_varint(1, seen.height) + pb.f_embedded(3, seen.block_id.encode())
            + pb.f_embedded(5, seen.signatures[0].timestamp.encode())
            + pb.f_bytes(7, b"\x01" * 96) + pb.f_varint(8, 4))
    store = carried(world.ref[0])
    store._db.set(b"SC:" + N_BLOCKS.to_bytes(8, "big"), cert)
    ex = X.BlockExecutor(AppConns(bump_app(KVStoreApp, AT.ValidatorUpdate, world.pub)),
                         device="cpu")
    eng = ReplayEngine(store, ex, device="cpu")
    with pytest.raises(UnsupportedCommitFormat, match="certificate-native commit"):
        eng.run(State.decode(world.ref[2].encode()))
    assert ex.app.consensus._app.height == 8  # the window [1-8] applied


def _other_key_set(vals, idx: int, pubkey_base, tag: str = "tendermint/PubKeySecp256k1"):
    """`vals` with validator `idx`'s key behind a key object of another
    type (same address, bytes and signature check): a set that only
    exists in memory, since the port's `decode_pub_key` refuses such keys
    on the wire."""
    class OtherKey(pubkey_base):
        def __init__(self, inner):
            self.inner = inner

        def address(self):
            return self.inner.address()

        def bytes(self):
            return self.inner.bytes()

        def verify_signature(self, msg, sig):
            return self.inner.verify_signature(msg, sig)

        def type_tag(self):
            return tag

    out = vals.copy()
    v = out.validators[idx]
    v.pub_key = OtherKey(v.pub_key)
    out.__dict__.pop("_ed_cols", None)
    return out


def test_non_ed25519_key_in_a_window_is_refused_by_name(world):
    """The kept divergence of `_window_batch`: a set holding a key that is
    not Ed25519 makes the columnar path decline (`ed25519_columns` is
    None), and the per-slot path raises ErrUnsupportedKeyType naming the
    type, height and index, where the reference verifies that signature
    singly and counts it beside its lanes (the same total as the port's
    window over the all-Ed25519 set)."""
    from cometbft_tpu.crypto.keys import PubKey as RPubKey
    from cometbft_tpu.state.types import State as RState
    from cometbft_tpu_torch.crypto.keys import PubKey

    store = carried(world.ref[0])
    blocks = [store.load_block(h) for h in (1, 2, 3)]
    genesis = State.decode(world.ref[2].encode())
    vals = _other_key_set(genesis.validators, 2, PubKey)
    assert vals.ed25519_columns() is None
    eng = ReplayEngine(store, X.BlockExecutor(AppConns(KVStoreApp()), device="cpu"),
                       device="cpu")
    from cometbft_tpu_torch.types.validation import ErrUnsupportedKeyType

    with pytest.raises(ErrUnsupportedKeyType) as ei:
        eng._queue_window(CHAIN, vals, vals, genesis.last_block_id, genesis.initial_height,
                          blocks)
    addr = vals.validators[2].address
    idx = [cs.validator_address for cs in blocks[1].last_commit.signatures].index(addr)
    assert str(ei.value) == ("no verifier for key type tendermint/PubKeySecp256k1 at height 1 "
                             f"index {idx}")
    # the reference verifies that lane singly and goes on
    rgen = RState.decode(world.ref[2].encode())
    rvals = _other_key_set(rgen.validators, 2, RPubKey)
    rstore = world.ref[0]
    reng = RReplayEngine(rstore, RX.BlockExecutor(RAppConns(RK.KVStoreApp()), backend="cpu"),
                         backend="cpu")
    rblocks = [rstore.load_block(h) for h in (1, 2, 3)]
    pending, _, n = reng._queue_window(CHAIN, rvals, rvals, rgen.last_block_id,
                                       rgen.initial_height, rblocks)
    assert pending.result()[0] and n == reng._resolve_window((pending, [], n))
    port_vals = genesis.validators
    _, _, lanes = eng._queue_window(CHAIN, port_vals, port_vals, genesis.last_block_id,
                                    genesis.initial_height, blocks)
    assert n == lanes
