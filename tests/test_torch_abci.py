"""The port's ABCI layer against the JAX package's, byte for byte.

`KVStoreApp` of both packages runs the same blocks of txs (valid,
malformed, `val:` validator updates, a snapshot interval): the same
`enc_finalize_resp` bytes, app hashes, query answers and snapshots. The
FinalizeBlock response's wire encoding gives the reference's bytes for
the same response, and decodes its own bytes back to the response.
"""

from __future__ import annotations

import threading

import pytest

torch = pytest.importorskip("torch")

from cometbft_tpu.abci import kvstore as RK  # noqa: E402
from cometbft_tpu.abci import types as RT  # noqa: E402
from cometbft_tpu.abci import wire as RW  # noqa: E402
from cometbft_tpu.types import Timestamp as RTimestamp  # noqa: E402
from cometbft_tpu_torch.abci import AppConns, KVStoreApp, LocalClient  # noqa: E402
from cometbft_tpu_torch.abci import types as T  # noqa: E402
from cometbft_tpu_torch.abci import wire as W  # noqa: E402
from cometbft_tpu_torch.types import Timestamp  # noqa: E402

PUB = "ab" * 32
BLOCKS = [
    [b"a=1", b"b=2", b"bad", b"=nokey"],
    [b"a=3", b"val:" + PUB.encode() + b"=7", b"val:zz=1", b"val:" + PUB.encode() + b"=x"],
    [],
    [b"c=" + bytes(range(256)), b"a=", b"k=v=w"],
    [b"val:" + PUB.encode() + b"=0", b"d=4"],
]


def run_blocks(app_cls, types_mod, wire_mod, ts_cls, snapshot_interval):
    """Finalize and commit BLOCKS; per height the encoded response, the
    app hash after commit and the query answers."""
    app = app_cls(snapshot_interval=snapshot_interval, chunk_size=64)
    out = []
    for h, txs in enumerate(BLOCKS, start=1):
        resp = app.finalize_block(types_mod.FinalizeBlockRequest(
            txs=list(txs), height=h, time=ts_cls(1_700_000_000 + h, 5)))
        app.commit()
        q = [app.query("/key", k) for k in (b"a", b"c", b"missing", b"val:" + PUB.encode())]
        out.append((wire_mod.enc_finalize_resp(resp), app.app_hash, app.height,
                    [(r.code, r.key, r.value, r.height) for r in q],
                    [tx for tx in txs if app.check_tx(tx).is_ok()]))
    return app, out


@pytest.mark.parametrize("snapshot_interval", [0, 2])
def test_kvstore_matches_reference(snapshot_interval):
    app, port = run_blocks(KVStoreApp, T, W, Timestamp, snapshot_interval)
    r_app, ref = run_blocks(RK.KVStoreApp, RT, RW, RTimestamp, snapshot_interval)
    assert port == ref
    assert app.info() == T.InfoResponse(**vars(r_app.info()))
    snaps = [(s.height, s.format, s.chunks, s.hash) for s in app.list_snapshots()]
    assert snaps == [(s.height, s.format, s.chunks, s.hash) for s in r_app.list_snapshots()]
    assert bool(snaps) == bool(snapshot_interval)
    for height, _, chunks, _ in snaps:
        for i in range(chunks + 1):
            assert app.load_snapshot_chunk(height, 1, i) == r_app.load_snapshot_chunk(height, 1, i)


def test_validator_updates_and_results():
    app = KVStoreApp()
    resp = app.finalize_block(T.FinalizeBlockRequest(txs=BLOCKS[1], height=1))
    assert [r.code for r in resp.tx_results] == [0, 0, 1, 1]
    assert resp.validator_updates == [T.ValidatorUpdate(bytes.fromhex(PUB), "ed25519", 7)]
    assert app.process_proposal([b"x=1"]) == T.ProposalStatus.ACCEPT
    assert app.process_proposal([b"x=1", b"nokv"]) == T.ProposalStatus.REJECT


def test_snapshot_restores_into_the_port_from_reference_chunks():
    """A state-sync restore in the port from the reference app's snapshot
    chunks lands on the reference's app hash; a lying app hash is refused
    and leaves the app untouched."""
    r_app, _ = run_blocks(RK.KVStoreApp, RT, RW, RTimestamp, 2)
    snap = r_app.list_snapshots()[-1]
    chunks = [r_app.load_snapshot_chunk(snap.height, 1, i) for i in range(snap.chunks)]
    port_snap = T.Snapshot(snap.height, snap.format, snap.chunks, snap.hash)
    liar = KVStoreApp()
    assert liar.offer_snapshot(port_snap, b"\x01" * 32) == T.OfferSnapshotResult.ACCEPT
    results = [liar.apply_snapshot_chunk(i, c, "peer") for i, c in enumerate(chunks)]
    assert results[-1] == T.ApplySnapshotChunkResult.REJECT_SNAPSHOT and liar.height == 0
    app = KVStoreApp()
    rk_app = RK.KVStoreApp()
    for a, s in ((app, port_snap), (rk_app, snap)):
        assert a.offer_snapshot(s, b"") == 1
        for i, c in enumerate(chunks):
            a.apply_snapshot_chunk(i, c, "peer")
    assert (app.height, app.app_hash, app.store) == (rk_app.height, rk_app.app_hash, rk_app.store)


def _finalize_resps(t):
    """The same FinalizeBlock responses, one of each shape, built from the
    module `t`."""
    vu = [t.ValidatorUpdate(b"\x01" * 32, "ed25519", 5),
          t.ValidatorUpdate(b"\x02" * 33, "secp256k1", 0)]
    return {
        "empty": t.FinalizeBlockResponse(),
        "results": t.FinalizeBlockResponse(
            tx_results=[t.ExecTxResult(data=b"v"), t.ExecTxResult(code=1, log="malformed tx"),
                        t.ExecTxResult(gas_wanted=5, gas_used=3)],
            validator_updates=vu, app_hash=b"\x09" * 32),
        "updates_only": t.FinalizeBlockResponse(validator_updates=vu[:1], app_hash=b"\x0a" * 32),
        "removal": t.FinalizeBlockResponse(
            validator_updates=[t.ValidatorUpdate(b"\x03" * 32, "ed25519", 0)]),
        "unicode_log": t.FinalizeBlockResponse(
            tx_results=[t.ExecTxResult(code=2, log="clé ✓ 鍵", data=b"\x00\xff")]),
        "wide_values": t.FinalizeBlockResponse(
            tx_results=[t.ExecTxResult(code=2**32 - 1, data=b"\x00" * 1000,
                                       gas_wanted=2**62, gas_used=2**63 - 1)],
            validator_updates=[t.ValidatorUpdate(b"\x04" * 32, "ed25519", 2**60)]),
        "many": t.FinalizeBlockResponse(
            tx_results=[t.ExecTxResult(code=i % 3, data=bytes([i % 256]) * (i % 7))
                        for i in range(300)], app_hash=b"\x0b" * 32),
    }


@pytest.mark.parametrize("kind", ["empty", "results", "updates_only", "removal", "unicode_log",
                                  "wide_values", "many"])
def test_finalize_resp_wire_matches_reference_and_round_trips(kind):
    """The bytes `apply_block` stores for a block's ABCI responses are the
    reference's, and decode back to the response."""
    msg = _finalize_resps(T)[kind]
    enc = W.enc_finalize_resp(msg)
    assert enc == RW.enc_finalize_resp(_finalize_resps(RT)[kind])
    assert W.dec_finalize_resp(enc) == msg


def test_app_conns_share_one_lock():
    """The four logical connections serialize on one lock, as the
    reference's multi-app conn does."""
    app = KVStoreApp()
    conns = AppConns(app)
    clients = (conns.consensus, conns.mempool, conns.query, conns.snapshot)
    assert len({id(c._lock) for c in clients}) == 1
    assert isinstance(conns.consensus, LocalClient)
    assert conns.query.height == 0  # attributes pass through unwrapped
    held = threading.Event()
    release = threading.Event()

    class Slow(KVStoreApp):
        def info(self):
            held.set()
            release.wait(5)
            return super().info()

    slow = AppConns(Slow())
    th = threading.Thread(target=slow.query.info)
    th.start()
    held.wait(5)
    got = []
    th2 = threading.Thread(target=lambda: got.append(slow.mempool.check_tx(b"a=1")))
    th2.start()
    th2.join(0.2)
    assert not got  # the mempool connection waits for the query connection's call
    release.set()
    th.join(5)
    th2.join(5)
    assert got and got[0].is_ok()
