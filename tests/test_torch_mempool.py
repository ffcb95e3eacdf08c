"""The port's mempool and admission pipeline against the JAX package's.

The same transaction stream, made from a numpy seed (signed STX envelopes
of seeded keys, bare `key=value` txs, and the classes the reference's
tests plant: a broken signature, a payload the app rejects, an envelope
cut short, a duplicate, an oversize tx, a full pool), goes through the
port's `CListMempool` and the reference's. Every comparison is exact:
the same error class and message for every tx, the same reap order, the
same `TxColumns` blob and offsets, the same survivors, cache and byte
count after `update`. The port's `AdmissionPipeline` (device "cpu"),
alone, with two tenants on one scheduler, and on the kernels' plain
ladder, gives the reference's per-tx path's outcomes. Every threaded
test has its own time limit (SIGALRM).
"""

from __future__ import annotations

import signal
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cometbft_tpu.abci import kvstore as RK  # noqa: E402
from cometbft_tpu.abci import types as RAT  # noqa: E402
from cometbft_tpu.abci.client import AppConns as RAppConns  # noqa: E402
from cometbft_tpu.mempool import CListMempool as RCListMempool  # noqa: E402
from cometbft_tpu.mempool import TxKey as RTxKey  # noqa: E402
from cometbft_tpu.mempool.txcolumns import TxColumns as RTxColumns  # noqa: E402
from cometbft_tpu.types.block import Data as RData  # noqa: E402
from cometbft_tpu_torch.abci import AppConns, KVStoreApp  # noqa: E402
from cometbft_tpu_torch.abci import types as AT  # noqa: E402
from cometbft_tpu_torch.crypto import ed25519 as E  # noqa: E402
from cometbft_tpu_torch.crypto import ed25519_ref as ref  # noqa: E402
from cometbft_tpu_torch.crypto import sched as S  # noqa: E402
from cometbft_tpu_torch.mempool import (  # noqa: E402
    AdmissionPipeline,
    CListMempool,
    NopMempool,
    TxKey,
    parse_signed_tx,
    wrap_signed_tx,
)
from cometbft_tpu_torch.mempool.admission import SIGN_CONTEXT, STX_MAGIC  # noqa: E402
from cometbft_tpu_torch.mempool.txcolumns import TxColumns  # noqa: E402
from cometbft_tpu_torch.types.block import Data  # noqa: E402

TEST_LIMIT_S = 60
MAX_TX_BYTES = 200


@pytest.fixture(autouse=True)
def time_limit():
    """Fail a test that runs past TEST_LIMIT_S (a hung drainer) instead of
    letting it hold the whole run."""
    def on_alarm(signum, frame):
        raise TimeoutError(f"test ran past its {TEST_LIMIT_S} s limit")

    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(TEST_LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


class _Signer:
    """A seeded Ed25519 key for `wrap_signed_tx` (pure-Python signing)."""

    def __init__(self, seed: bytes):
        self.seed = seed
        self._pub = ref.pubkey_from_seed(seed)

    def sign(self, msg: bytes) -> bytes:
        return ref.sign(self.seed, msg)

    def pub_key(self):
        return E.Ed25519PubKey(self._pub)


def _signers(n: int, seed: int):
    rng = np.random.default_rng(seed)
    return [_Signer(rng.bytes(32)) for _ in range(n)]


def _broken(tx: bytes) -> bytes:
    i = len(STX_MAGIC) + 32 + 3
    return tx[:i] + bytes([tx[i] ^ 0x04]) + tx[i + 1:]


def _app_rejected_stx(signer, tag: bytes) -> bytes:
    """A signed payload without '=' whose whole envelope has none either,
    so the KVStore app rejects it."""
    for j in range(64):
        tx = wrap_signed_tx(signer, tag + b"-%d" % j)
        if b"=" not in tx:
            return tx
    raise AssertionError("no '='-free envelope in 64 tries")


@pytest.fixture(scope="module")
def stream():
    """(txs, max_txs): 48 txs with every class, 'full' past max_txs."""
    signers = _signers(6, seed=11)
    rng = np.random.default_rng(5)
    txs = []
    for i in range(48):
        if i % 3 == 0:
            txs.append(b"bare%d=%d" % (i, rng.integers(1 << 30)))
        else:
            txs.append(wrap_signed_tx(signers[i % 6], b"k%d=%d" % (i, rng.integers(1 << 30))))
    txs[4] = _broken(txs[4])                         # invalid signature
    txs[7] = _app_rejected_stx(signers[1], b"noeq")  # signed, app rejects
    txs[9] = b"no-equals-sign"                       # bare, app rejects
    txs[11] = STX_MAGIC + b"cut-short"               # malformed envelope: a bare tx
    txs[13] = txs[2]                                 # duplicate of an admitted tx
    txs[16] = txs[4]                                 # the broken tx again (left the cache)
    txs[19] = b"x" * (MAX_TX_BYTES + 1)              # oversize
    txs[21] = txs[9]                                 # the app-rejected tx again
    return txs, 30


def _outcomes(mp, txs) -> list:
    out = []
    for tx in txs:
        try:
            mp.check_tx(tx)
            out.append(None)
        except Exception as e:  # noqa: BLE001 — compared by class and message
            out.append((type(e).__name__, str(e)))
    return out


def _ref_pool(txs, max_txs, app=None, **kw):
    mp = RCListMempool(RAppConns(app or RK.KVStoreApp()), max_txs=max_txs,
                       max_tx_bytes=MAX_TX_BYTES, verify_sigs=True, **kw)
    return mp, _outcomes(mp, txs)


def _port_pool(txs, max_txs, app=None, **kw):
    mp = CListMempool(AppConns(app or KVStoreApp()), max_txs=max_txs,
                      max_tx_bytes=MAX_TX_BYTES, verify_sigs=True, **kw)
    return mp, _outcomes(mp, txs)


def test_per_tx_outcomes_reap_and_columns_match_the_reference(stream):
    txs, max_txs = stream
    rmp, want = _ref_pool(txs, max_txs)
    mp, got = _port_pool(txs, max_txs)
    assert got == want
    classes = {o[0] if o else "ok" for o in got}
    assert classes == {"ok", "ValueError", "ErrTxInCache", "ErrTxTooLarge", "ErrMempoolFull"}
    assert ("ValueError", "tx rejected: invalid signature") in got
    assert got[16] == got[4] and got[21] == got[9]
    assert mp.size() == rmp.size() == max_txs
    assert mp.total_bytes() == rmp.total_bytes()
    assert mp.reap_max_txs(-1) == rmp.reap_max_txs(-1)
    assert mp.reap_max_txs(7) == rmp.reap_max_txs(7)
    for budget in (0, 40, 333, 1_000, -1):
        assert mp.reap_max_bytes_max_gas(budget) == rmp.reap_max_bytes_max_gas(budget)
        cols, rcols = mp.reap_columns(budget), rmp.reap_columns(budget)
        assert (bytes(cols.blob), cols.offsets) == (bytes(rcols.blob), rcols.offsets)
    assert mp.version == rmp.version
    assert all(mp.cache.has(TxKey(t)) == rmp.cache.has(RTxKey(t)) for t in txs)


def _flip_app(kvstore_cls, check_result_cls):
    class Flip(kvstore_cls):
        """Rejects txs whose key ends in an odd digit once `strict`."""

        strict = False

        def check_tx(self, tx):
            if self.strict and int(tx.split(b"=")[0][-1:] or b"0") % 2:
                return check_result_cls(code=7)
            return super().check_tx(tx)

    return Flip()


@pytest.mark.parametrize("recheck_window", [1, 8])
@pytest.mark.parametrize("keep_invalid", [False, True])
def test_update_and_recheck_match_the_reference(recheck_window, keep_invalid):
    """A committed block with one failed tx, then the recheck against the
    app's new rules: the same survivors, cache, bytes and version."""
    txs = [b"k%d=%d" % (i, i) for i in range(37)]
    committed = [b"k0=0", b"k1=1", b"k4=4", b"absent=1"]

    def run(mp, app, result_cls):
        for tx in txs:
            mp.check_tx(tx)
        app.strict = True
        mp.lock()
        mp.update(5, committed, [result_cls(), result_cls(code=3), result_cls(), result_cls()])
        mp.unlock()
        return (mp.reap_max_txs(-1), mp.total_bytes(), mp.version, mp.height,
                [mp.cache.has(TxKey(t)) for t in txs + committed])

    rapp, app = _flip_app(RK.KVStoreApp, RAT.CheckTxResult), _flip_app(KVStoreApp, AT.CheckTxResult)
    kw = dict(recheck_window=recheck_window, keep_invalid_txs_in_cache=keep_invalid)
    want = run(RCListMempool(RAppConns(rapp), **kw), rapp, RAT.ExecTxResult)
    got = run(CListMempool(AppConns(app), **kw), app, AT.ExecTxResult)
    assert got == want
    assert b"k2=2" in got[0] and b"k3=3" not in got[0]


def test_flush_and_nop_mempool():
    mp = CListMempool(AppConns(KVStoreApp()))
    mp.check_tx(b"a=1")
    mp.flush()
    assert (mp.size(), mp.total_bytes(), mp.cache.has(TxKey(b"a=1"))) == (0, 0, False)
    mp.check_tx(b"a=1")
    nop = NopMempool()
    with pytest.raises(RuntimeError, match="mempool disabled"):
        nop.check_tx(b"a=1")
    assert nop.reap_max_bytes_max_gas() == [] and list(nop.reap_columns()) == []


def _pipeline_stream():
    """48 txs whose outcomes do not depend on how windows split them: the
    planted classes sit before the pool fills (at 40), a duplicate copies
    an admitted tx, and after index 40 every tx is new and valid."""
    signers = _signers(4, seed=23)
    txs = [wrap_signed_tx(signers[i % 4], b"p%d=%d" % (i, i * 7)) for i in range(48)]
    txs[3] = _broken(txs[3])
    txs[6] = b"no-equals-sign"
    txs[8] = txs[1]
    txs[10] = b"y" * (MAX_TX_BYTES + 1)
    txs[12] = STX_MAGIC + b"short"
    return txs, 40


@pytest.fixture(scope="module")
def pstream():
    txs, max_txs = _pipeline_stream()
    rmp, want = _ref_pool(txs, max_txs)
    return txs, max_txs, want, rmp.reap_max_txs(-1)


def _pipelined(app, max_txs, **kw):
    mp = CListMempool(AppConns(app), max_txs=max_txs, max_tx_bytes=MAX_TX_BYTES)
    mp.attach_pipeline(AdmissionPipeline(mp, device="cpu", **kw))
    return mp


def _futures(mp, txs) -> list:
    out = []
    for f in [mp.submit_tx(tx) for tx in txs]:
        exc = f.exception(timeout=30)
        out.append(None if exc is None else (type(exc).__name__, str(exc)))
    return out


@pytest.mark.parametrize("window", [1, 5, 16])
def test_pipeline_gives_the_per_tx_outcomes(pstream, window):
    txs, max_txs, want, want_reap = pstream
    mp = _pipelined(KVStoreApp(), max_txs, window=window, max_delay_s=0.002)
    try:
        assert _futures(mp, txs) == want
        assert mp.reap_max_txs(-1) == want_reap
        with pytest.raises(Exception, match="already seen"):
            mp.check_tx(txs[1])  # the blocking facade re-raises the per-tx error
    finally:
        mp.close()


def test_two_tenants_coalesce_on_one_scheduler(pstream):
    """Two tenants' windows queue on one manual scheduler and go out in
    ONE dispatch; each tenant gets the per-tx outcomes of its own stream,
    its broken signature included, and no other."""
    txs, max_txs, want, _ = pstream
    other = [t for t in _pipeline_stream()[0]]
    other[3], other[20] = other[20], _broken(other[20])  # a different broken lane
    rmp, want_other = _ref_pool(other, max_txs)
    sched = S.VerifyScheduler(device="cpu", manual=True)
    pools = [_pipelined(KVStoreApp(), max_txs, window=len(txs), max_delay_s=5.0, sched=sched,
                        tenant=f"chain-{i}") for i in range(2)]
    futs = [[m.submit_tx(tx) for tx in s] for m, s in zip(pools, (txs, other))]
    try:
        deadline = time.monotonic() + 20
        while sched._n_queued < 2 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert sched._n_queued == 2
        assert sched.drain_once() == 2
        got = [[None if f.exception(timeout=20) is None else
                (type(f.exception()).__name__, str(f.exception())) for f in fs] for fs in futs]
    finally:
        for m in pools:
            m.close()
        sched.close()
    assert got == [want, want_other]
    assert sched.stats["dispatches"] == 1 and sched.stats["coalesced_requests"] == 2
    assert sched.tenant_stats() == {"chain-0": 44, "chain-1": 44}


def test_window_on_the_plain_ladder(monkeypatch):
    """NATIVE_MAX = 0: an admission window takes the device route on the
    CPU (the kernels' plain versions); the broken lane is named exactly."""
    from cometbft_tpu_torch.ops import curve

    monkeypatch.setattr(E, "NATIVE_MAX", 0)
    calls = []
    real = curve.ladder_sub_mul8_plain
    monkeypatch.setattr(curve, "ladder_sub_mul8_plain",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    signers = _signers(3, seed=31)
    txs = [wrap_signed_tx(signers[i % 3], b"d%d=%d" % (i, i)) for i in range(8)]
    txs[5] = _broken(txs[5])
    _, want = _ref_pool(txs, 100)
    mp = _pipelined(KVStoreApp(), 100, window=8, max_delay_s=5.0)
    try:
        assert _futures(mp, txs) == want
    finally:
        mp.close()
    assert want[5] == ("ValueError", "tx rejected: invalid signature") and calls == [1]


def test_signed_envelope_parse_and_per_tx_verify():
    signer = _signers(1, seed=41)[0]
    tx = wrap_signed_tx(signer, b"sig=ok")
    pub, sig, payload = parse_signed_tx(tx)
    assert (pub, payload) == (signer.pub_key().bytes(), b"sig=ok")
    assert ref.verify(pub, SIGN_CONTEXT + payload, sig)
    assert parse_signed_tx(STX_MAGIC + b"short") is None and parse_signed_tx(b"a=1") is None


def test_stop_fails_pending_futures_promptly():
    """A drainer wedged in the app: close() returns within the stop
    timeout, every pending future fails, and late submits are refused."""
    release = threading.Event()

    class BlockingApp(KVStoreApp):
        def check_txs(self, txs):
            release.wait(10)
            return [KVStoreApp.check_tx(self, tx) for tx in txs]

    mp = _pipelined(BlockingApp(), 100, window=4, max_delay_s=0.001)
    mp.pipeline.stop_timeout_s = 0.2
    futures = [mp.pipeline.submit(b"k%d=%d" % (i, i)) for i in range(12)]
    time.sleep(0.1)
    t0 = time.monotonic()
    mp.close()
    assert time.monotonic() - t0 < 2.0
    for fut in futures:
        with pytest.raises(RuntimeError, match="admission pipeline"):
            fut.result(timeout=1)
    with pytest.raises(RuntimeError, match="closed"):
        mp.pipeline.submit(b"late=1").result(timeout=1)
    release.set()


def test_mempool_lock_not_held_across_app_call():
    free = []

    class ProbeApp(KVStoreApp):
        def check_txs(self, txs):
            holder = {}

            def probe():
                holder["got"] = mp._lock.acquire(timeout=1.0)
                if holder["got"]:
                    mp._lock.release()

            t = threading.Thread(target=probe)
            t.start()
            t.join()
            free.append(holder.get("got", False))
            return [self.check_tx(tx) for tx in txs]

    mp = _pipelined(ProbeApp(), 100, window=16)
    try:
        mp.check_tx(b"a=1")
    finally:
        mp.close()
    assert free and all(free)


def test_notifier_order_and_slow_subscriber():
    """Admitted txs reach on_new_txs in reap order, and a slow per-tx
    subscriber runs on the notifier thread, not the admitting one."""
    order = []
    mp = _pipelined(KVStoreApp(), 100, window=8)
    mp.on_new_txs.append(order.extend)
    mp.on_new_tx.append(lambda tx: time.sleep(0.01))
    try:
        t0 = time.perf_counter()
        for i in range(20):
            mp.check_tx(b"k%d=%d" % (i, i))
        assert time.perf_counter() - t0 < 0.5
        deadline = time.monotonic() + 5
        while len(order) < 20 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert order == mp.reap_max_txs(-1)
    finally:
        mp.close()


def test_cuda_pipeline_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mp = CListMempool(AppConns(KVStoreApp()))
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        AdmissionPipeline(mp)


TXS = [b"alpha", b"", b"x" * 300, b"\x00\x01\x02", b"last-tx"]


def test_txcolumns_match_the_reference():
    cols, rcols = TxColumns.from_txs(TXS), RTxColumns.from_txs(TXS)
    assert (bytes(cols.blob), cols.offsets) == (bytes(rcols.blob), rcols.offsets)
    assert list(cols) == TXS and cols[-1] == TXS[-1] and cols[1:3] == TXS[1:3]
    assert cols == TXS and cols != TXS[:-1] and len(cols) == 5
    assert cols.tx_hashes() == rcols.tx_hashes()
    assert cols.encode_data() == rcols.encode_data()
    assert Data(cols).hash() == Data(list(TXS)).hash() == RData(list(TXS)).hash()
    assert Data(cols).encode() == Data(list(TXS)).encode() == RData(rcols).encode()
    assert Data.decode(Data(cols).encode()).txs == TXS
    for budget in range(0, cols.total_bytes() + 3):
        a, b = cols.prefix_max_bytes(budget), rcols.prefix_max_bytes(budget)
        assert (a.offsets, list(a)) == (b.offsets, list(b))
    app = AT.Application()
    for budget in (0, 4, 305, 10_000):
        assert list(app.prepare_proposal(cols, budget)) == app.prepare_proposal(list(TXS), budget)
    empty = TxColumns.from_txs([])
    assert (len(empty), Data(empty).hash()) == (0, Data([]).hash())


@pytest.mark.parametrize("bundle", ["MempoolMetrics", "LightClientMetrics", "ConsensusMetrics"])
def test_metric_bundles_line_up_with_the_reference(bundle):
    from cometbft_tpu.utils import metrics as RM
    from cometbft_tpu_torch.utils import metrics as M

    port = vars(getattr(M, bundle)(M.Registry()))
    ref_ = vars(getattr(RM, bundle)(RM.Registry()))
    assert port and set(port) <= set(ref_)

    def shape(m):
        return (type(m).__name__, m.name, tuple(m.labels), getattr(m, "buckets", None))

    assert {k: shape(m) for k, m in port.items()} == {k: shape(ref_[k]) for k in port}


def test_lifecycle_stamps_feed_the_mempool_and_commit_histograms():
    """With every tx sampled, a tx stamped at arrival and admitted through
    the pipeline lands in the mempool bundle's admit_wait, verify and
    app_check rows, and its commit stamp in tx_commit_seconds, as the
    reference's tracker records the same stamps."""
    from cometbft_tpu.utils import metrics as RM
    from cometbft_tpu.utils import txlife as RL
    from cometbft_tpu_torch.utils import metrics as M
    from cometbft_tpu_torch.utils import txlife

    tx = wrap_signed_tx(_signers(1, seed=3)[0], b"life=1")
    try:
        txlife.configure(1)
        RL.configure(1)
        M.reset_bundles()
        RM.reset_bundles()
        mp = _pipelined(KVStoreApp(), 10, window=1)
        try:
            txlife.track(tx, "arrival")
            mp.check_tx(tx)
        finally:
            mp.close()
        txlife.stage_key(TxKey(tx), "commit")
        key = RTxKey(tx)
        for st in ("arrival", "verify_start", "verify_end", "insert", "commit"):
            RL.stage_key(key, st)
        got = (set(M.mempool_metrics().tx_stage_seconds.snapshot()),
               M.consensus_metrics().tx_commit_seconds.snapshot()[()]["count"])
        want = (set(RM.mempool_metrics().tx_stage_seconds.snapshot()),
                RM.consensus_metrics().tx_commit_seconds.snapshot()[()]["count"])
        assert got == want == ({("admit_wait",), ("verify",), ("app_check",)}, 1)
    finally:
        txlife.reset()
        RL.reset()
        M.reset_bundles()
        RM.reset_bundles()
