"""The port's shared verify scheduler against the JAX package's.

Coalescing is bit-exact: each request's verdict sliced from one mega-batch
equals its own verifier's and the reference scheduler's on the same bytes.
The service order (priority classes, weighted deficit round-robin) and
the lifecycle (stop fails queued work with tenant context, close refuses
later submits, a submit after stop restarts the drainer) are the
reference's. Every test has its own time limit (SIGALRM), and every
scheduler that starts a drainer is closed in a `finally`.
"""

from __future__ import annotations

import signal
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from cometbft_tpu.crypto import ed25519 as RE  # noqa: E402
from cometbft_tpu.crypto import sched as RS  # noqa: E402
from cometbft_tpu_torch.crypto import ed25519 as E  # noqa: E402
from cometbft_tpu_torch.crypto import ed25519_ref as ref  # noqa: E402
from cometbft_tpu_torch.crypto import sched as S  # noqa: E402
from cometbft_tpu_torch.types import validation  # noqa: E402
from cometbft_tpu_torch.utils import factories as fx  # noqa: E402
from cometbft_tpu_torch.utils import metrics, trace  # noqa: E402

TEST_LIMIT_S = 60


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


_SEEDS = [bytes([i + 1]) * 32 for i in range(8)]
_PUBS = [ref.pubkey_from_seed(s) for s in _SEEDS]


def _lanes(n, bad=(), tag=b""):
    out = []
    for i in range(n):
        msg = b"sched-msg-%d-" % i + tag
        sig = ref.sign(_SEEDS[i % 8], msg)
        if i in bad:
            sig = sig[:-1] + bytes([sig[-1] ^ 0xFF])
        out.append((_PUBS[i % 8], msg, sig))
    return out


def _bv(lanes, device="cpu"):
    bv = E.Ed25519BatchVerifier(device=device)
    for pub, msg, sig in lanes:
        bv.add(E.Ed25519PubKey(pub), msg, sig)
    return bv


def _ref_bv(lanes):
    bv = RE.Ed25519BatchVerifier(backend="tpu")
    for pub, msg, sig in lanes:
        bv.add(RE.Ed25519PubKey(pub), msg, sig)
    return bv


SHAPES = [(3, ()), (5, (0,)), (1, ()), (4, (3,)), (2, (0, 1)), (7, ())]


@pytest.mark.parametrize("route", ["native", "device"])
def test_coalesced_slices_match_own_verify_and_reference(route, monkeypatch):
    """Six requests, rejects at and across request boundaries, in one
    dispatch: each slice equals the request's own verify() and the
    reference scheduler's slice. `device` pins NATIVE_MAX = 0, so the
    mega-batch runs the plain versions of the ladder route."""
    lanes = [_lanes(n, bad, b"seq%d" % i) for i, (n, bad) in enumerate(SHAPES)]
    own = [_bv(x).verify() for x in lanes]
    if route == "device":
        monkeypatch.setattr(E, "NATIVE_MAX", 0)
    s = S.VerifyScheduler(device="cpu", manual=True)
    rs = RS.VerifyScheduler(backend="tpu", manual=True)
    handles = [s.submit(_bv(x), tenant=f"t{i % 2}", source="consensus")
               for i, x in enumerate(lanes)]
    r_handles = [rs.submit(_ref_bv(x), tenant=f"t{i % 2}", source="consensus")
                 for i, x in enumerate(lanes)]
    assert s.drain_once() == rs.drain_once() == len(SHAPES)
    assert s.stats == rs.stats and s.stats["dispatches"] == 1
    got = [h.result(timeout=5) for h in handles]
    assert got == own == [h.result(timeout=5) for h in r_handles]
    assert [ok for ok, _ in got] == [True, False, True, False, False, True]


def test_empty_submit_matches_empty_verify():
    s = S.VerifyScheduler(device="cpu", manual=True)
    assert s.submit(E.Ed25519BatchVerifier(device="cpu")).result(1) == \
        E.Ed25519BatchVerifier(device="cpu").verify() == (False, [])


def _service_order(sched, make_bv, scenario):
    """Submit the scenario's requests, pump drain_once until empty, and
    return, per dispatch, the sorted names of the requests it resolved."""
    weights, reqs = scenario
    for tenant, w in weights.items():
        sched.set_tenant_weight(tenant, w)
    lanes = _lanes(4)
    handles = {name: sched.submit(make_bv(lanes[:n]), tenant=tenant, source=source)
               for name, tenant, source, n in reqs}
    order, seen = [], set()
    while sched.drain_once():
        done = sorted(k for k, h in handles.items() if h._future.done() and k not in seen)
        seen.update(done)
        order.append(done)
        assert len(order) < 100
    assert all(h.result(5)[0] for h in handles.values())
    return order


SCENARIOS = {
    # max_coalesce_sigs, quantum_sigs, (weights, [(name, tenant, source, lanes)])
    "priority": (4, 512, ({}, [("adm", "a", "admission", 3), ("bg", "b", "background", 2),
                               ("light", "a", "light", 3), ("sync", "b", "blocksync", 3),
                               ("cons", "a", "consensus", 3), ("other", "c", "gossip", 1)])),
    "hot_tenant": (64, 8, ({"hot": 1.0, "victim": 1.0},
                           [(f"h{i}", "hot", "light", 4) for i in range(60)]
                           + [(f"v{i}", "victim", "light", 4) for i in range(6)])),
    "weights": (32, 8, ({"big": 3.0, "small": 1.0},
                        [(f"B{i}", "big", "light", 4) for i in range(20)]
                        + [(f"s{i}", "small", "light", 4) for i in range(20)])),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_service_order_matches_reference(name):
    max_sigs, quantum, scenario = SCENARIOS[name]
    s = S.VerifyScheduler(device="cpu", manual=True, max_coalesce_sigs=max_sigs,
                          quantum_sigs=quantum)
    rs = RS.VerifyScheduler(backend="tpu", manual=True, max_coalesce_sigs=max_sigs,
                            quantum_sigs=quantum)
    order = _service_order(s, _bv, scenario)
    assert order == _service_order(rs, _ref_bv, scenario)
    assert s.tenant_stats() == rs.tenant_stats()
    if name == "priority":
        # consensus first; the one-lane background request fills its batch
        assert order[:3] == [["cons", "other"], ["sync"], ["light"]]
    if name == "hot_tenant":  # the victim is served whole in the first batch
        assert {f"v{i}" for i in range(6)} <= set(order[0]) and len(order[0]) <= 16


def _message(h):
    with pytest.raises(RuntimeError) as ei:
        h.result(timeout=1)
    return str(ei.value)


def test_stop_and_close_fail_like_the_reference():
    """stop() fails what is still queued with the tenant, source and size;
    a submit after close() fails at once. The messages are the
    reference's."""
    msgs = []
    for sched, bv in ((S.VerifyScheduler(device="cpu", manual=True, stop_timeout_s=0.1),
                       _bv(_lanes(3))),
                      (RS.VerifyScheduler(backend="tpu", manual=True, stop_timeout_s=0.1),
                       _ref_bv(_lanes(3)))):
        h = sched.submit(bv, tenant="chain-z", source="blocksync")
        sched.stop()
        sched.close()
        late = sched.submit(bv, tenant="late", source="light")
        msgs.append((_message(h), _message(late)))
    assert msgs[0] == msgs[1] == (
        "verify scheduler stopped: 3-sig blocksync request from tenant 'chain-z' abandoned",
        "verify scheduler closed")


def test_drainer_starts_lazily_stops_and_restarts():
    s = S.VerifyScheduler(device="cpu", max_coalesce_delay_ms=1.0)
    try:
        assert s._thread is None
        assert s.submit(_bv(_lanes(2, tag=b"r1")), tenant="a").result(10) == (True, [True] * 2)
        t1 = s._thread
        assert t1 is not None and t1.is_alive()
        s.stop()
        assert s._thread is None and not t1.is_alive()
        assert s.submit(_bv(_lanes(2, bad=(1,), tag=b"r2")), tenant="a").result(10) == \
            (False, [True, False])
        assert s.stats["passthrough"] == 2
    finally:
        s.close()
    assert s._thread is None and not any(t.name == "verify-sched" and t.is_alive()
                                         for t in threading.enumerate())


def test_concurrent_submits_lose_and_duplicate_nothing():
    """16 threads (more than the cores) race the threaded drainer with a
    short switch interval: every request resolves once, with its own
    lanes' bitmap, and the scheduler's counts add up."""
    import sys

    reqs = {(t, i): _lanes(2, bad=(0,) if (t + i) % 3 == 0 else (), tag=b"c%d-%d" % (t, i))
            for t in range(16) for i in range(4)}
    results, errors, lock = {}, [], threading.Lock()
    s = S.VerifyScheduler(device="cpu", max_coalesce_delay_ms=1.0, max_coalesce_sigs=256)

    def producer(t):
        try:
            for i in range(4):
                got = s.submit(_bv(reqs[(t, i)]), tenant=f"t{t % 4}",
                               source="light").result(timeout=30)
                with lock:
                    assert (t, i) not in results
                    results[(t, i)] = got
        except Exception as e:  # noqa: BLE001 — collected, asserted below
            with lock:
                errors.append((t, repr(e)))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=producer, args=(t,)) for t in range(16)]
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=40)
    finally:
        sys.setswitchinterval(old)
        s.close()
    assert not any(th.is_alive() for th in threads) and not errors, errors
    assert results == {k: (not (k[0] + k[1]) % 3 == 0, [(k[0] + k[1]) % 3 != 0, True])
                       for k in reqs}
    st = s.stats
    assert st["requests"] == 64 and st["sigs"] == 128
    assert st["passthrough"] + st["coalesced_requests"] == 64 >= st["dispatches"]


def test_acquire_shared_refcounts_per_device():
    a = S.acquire_shared("cpu", max_coalesce_delay_ms=1.0)
    try:
        b = S.acquire_shared(torch.device("cpu"))
        assert a is b and a.device == torch.device("cpu")
        S.release_shared(b)
        assert not a._closed
    finally:
        S.release_shared(a)
    assert a._closed and not S._shared
    c = S.acquire_shared("cpu")
    assert c is not a
    S.release_shared(c)


def test_cuda_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        S.VerifyScheduler()
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        S.acquire_shared("cuda")
    assert not S._shared


def test_two_tenants_coalesce_through_verify_context(tmp_path):
    """Two tenants' verify_commit calls, each from its own thread under
    verify_context, coalesce into one dispatch (the scheduler pumped by
    hand once both are queued). A bad signature in one tenant's commit
    fails that tenant only, naming the exact index; the other verifies.
    The dispatch leaves the sched metrics and one `crypto.sched_coalesce`
    span naming both tenants."""
    import json

    signers = fx.make_signers(6, seed=7, device="cpu")
    vals = fx.make_validator_set(signers)
    by_addr = {x.address(): x for x in signers}
    commits = {}
    for chain in ("chain-a", "chain-b"):
        bid = fx.make_block_id(chain.encode())
        commits[chain] = (bid, fx.make_commit(chain, 3, 0, bid, vals, by_addr, device="cpu"))
    cs = commits["chain-b"][1].signatures[3]
    cs.signature = bytes([cs.signature[0] ^ 0xFF]) + cs.signature[1:]
    commits["chain-b"][1].invalidate_memos()

    metrics.reset_bundles()
    trace.configure(str(tmp_path / "t.jsonl"))
    sched = S.VerifyScheduler(device="cpu", manual=True)
    outcomes = {}

    def run(chain):
        bid, commit = commits[chain]
        try:
            with S.verify_context(sched, chain, "consensus"):
                validation.verify_commit(chain, vals, bid, 3, commit, device="cpu")
            outcomes[chain] = None
        except Exception as e:  # noqa: BLE001 — compared below
            outcomes[chain] = (type(e).__name__, str(e))

    threads = [threading.Thread(target=run, args=(c,)) for c in commits]
    try:
        for t in threads:
            t.start()
        deadline = time.monotonic() + 20
        while sched._n_queued < 2:
            assert time.monotonic() < deadline, "the tenants never queued"
            time.sleep(0.01)
        assert sched.drain_once() == 2
        for t in threads:
            t.join(20)
    finally:
        sched.close()
        trace.disable()
    assert not any(t.is_alive() for t in threads)
    assert outcomes == {"chain-a": None,
                        "chain-b": ("ErrInvalidSignature", "invalid signature at index 3")}
    assert sched.stats["dispatches"] == 1 and sched.stats["coalesced_requests"] == 2
    assert sched.tenant_stats() == {"chain-a": 6, "chain-b": 6}
    m = metrics.crypto_metrics()
    assert m.sched_coalesced_total.values() == {("consensus",): 2.0}
    assert m.sched_batch_sigs.snapshot()[()]["count"] == 1
    assert m.sched_queue_depth.values() == {("chain-a",): 0.0, ("chain-b",): 0.0}
    recs = [json.loads(x) for x in (tmp_path / "t.jsonl").read_text().splitlines()]
    spans = [r for r in recs if r["name"] == "crypto.sched_coalesce"]
    assert len(spans) == 1 and spans[0]["per_tenant_sigs"] == {"chain-a": 6, "chain-b": 6}


def test_verify_context_none_sched_is_noop():
    with S.verify_context(None, "t", "light"):
        assert S.current_context() is None
