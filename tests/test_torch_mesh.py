"""The port's verify mesh (`cometbft_tpu_torch/parallel/mesh.py`) against
the reference's, on the CPU.

The port's mesh runs on logical "cpu" shards (the plain versions of the
kernels, one after another); the reference's `MeshVerifyEngine` runs on
its 8-device virtual CPU mesh (tests/conftest.py). Each lanes-a-shard
count costs the reference one XLA compile of its sharded verifier (about
a minute here), so every layout below is laid out at one shape, 104
lanes over 8 shards, and the reference compiles it once.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from cometbft_tpu.crypto import ed25519 as JE  # noqa: E402
from cometbft_tpu.crypto import ed25519_ref as jref  # noqa: E402
from cometbft_tpu.parallel import mesh as JM  # noqa: E402
from cometbft_tpu_torch.blocksync.replay import ReplayEngine  # noqa: E402
from cometbft_tpu_torch.crypto import ed25519 as E  # noqa: E402
from cometbft_tpu_torch.ops import ed25519_verify as V  # noqa: E402
from cometbft_tpu_torch.ops.field import device_key  # noqa: E402
from cometbft_tpu_torch.parallel import mesh as M  # noqa: E402
from cometbft_tpu_torch.utils.metrics import crypto_metrics  # noqa: E402

CPU = torch.device("cpu")
B = 104  # 13 lanes a shard over 8 shards
# XLA:CPU settings that shorten the compile of the reference's verify graph;
# the graph is integer code, so every result is the same
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(autouse=True)
def no_engine():
    """No test leaves a mesh installed for the next one."""
    M.reset_engine()
    yield
    M.reset_engine()


def placed(before: dict) -> dict:
    """The mesh placements counted since `before` (a snapshot of
    `mesh_batches_total`)."""
    after = crypto_metrics().mesh_batches_total.values()
    return {k: v - before.get(k, 0.0) for k, v in after.items() if v != before.get(k, 0.0)}


def signed_items(n, corrupt=()):
    """The reference test's lanes: four keys, distinct messages, a bad
    lane's R broken (S stays canonical)."""
    seeds = [bytes([i % 5 + 1]) * 32 for i in range(4)]
    out = []
    for i in range(n):
        seed = seeds[i % 4]
        msg = b"mesh-lane-%04d" % i
        sig = jref.sign(seed, msg)
        if i in corrupt:
            sig = bytes([sig[0] ^ 1]) + sig[1:]
        out.append((jref.pubkey_from_seed(seed), msg, sig))
    return out


def port_packed(items, parts, bucket=None):
    """The port's production packing: the verifier's R||S||k rows and its
    pubkey column, padded over `parts` shards."""
    bv = E.Ed25519BatchVerifier(CPU)
    for pub, msg, sig in items:
        bv.add(E.Ed25519PubKey(pub), msg, sig)
    n = bv.count()
    b = M.pad_to_shards(n, parts, bucket=bucket)
    a = np.zeros((b, 32), np.uint8)
    a[:n] = np.frombuffer(bytes(bv._pub_buf), np.uint8).reshape(n, 32)
    return a, bv._pack_rsk(n, b).numpy(), np.arange(b) < n


@pytest.fixture(scope="module")
def ref_mesh():
    cpus = jax.devices("cpu")
    if len(cpus) < 8:
        pytest.skip("needs the 8 virtual CPU devices of tests/conftest.py")
    eng = JM.MeshVerifyEngine(cpus[:8], calibrate=False)
    shapes = (((B, 32), np.uint8), ((B, 96), np.uint8), ((B,), bool))
    args = [jax.device_put(np.zeros(s, d), eng._sharding) for s, d in shapes]
    cache = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    try:
        eng._fns[B] = eng._fn(B).lower(*args).compile(FAST_COMPILE)
    finally:
        jax.config.update("jax_enable_compilation_cache", cache)
    return eng


# (lanes, bad lanes): a valid prime batch; the same with bad lanes on three
# shards, the last lane among them; 13 lanes over 8 shards; 5 lanes, so
# that seven shards are all dead
LAYOUTS = {
    "accept_prime_97": (97, ()),
    "reject_prime_97_last_lane": (97, (5, 50, 96)),
    "13_over_8": (13, (5, 12)),
    "all_dead_shards": (5, ()),
}


@pytest.mark.parametrize("layout", LAYOUTS)
def test_sharded_verdicts_equal_the_reference_mesh(layout, ref_mesh):
    n, bad = LAYOUTS[layout]
    a, rsk, live = port_packed(signed_items(n, set(bad)), 8, bucket=B)
    assert a.shape == (B, 32)
    jok, jbits = ref_mesh.submit(a, rsk, live)
    ok, bits = M.MeshVerifyEngine([CPU] * 8).submit(a, rsk, live)
    assert len(bits) == 8 and all(b.shape == (13,) for b in bits)
    got = M.gather_bits(bits).numpy()
    np.testing.assert_array_equal(got, np.asarray(jbits))
    assert bool(ok) == bool(jok) == (not bad)
    assert [i for i in range(n) if not got[i]] == list(bad) and not got[n:].any()


def test_packed_rows_equal_the_reference_packer():
    items = signed_items(13, {5})
    a, rsk, live = port_packed(items, 8, bucket=16)
    jbv = JE.Ed25519BatchVerifier(backend="cpu")
    for pub, msg, sig in items:
        jbv.add(JE.Ed25519PubKey(pub), msg, sig)
    jrsk, jlive, jpub = jbv._pack_rsk_live(13, 16)
    np.testing.assert_array_equal(rsk, jrsk)
    np.testing.assert_array_equal(live, jlive)
    np.testing.assert_array_equal(a[:13].tobytes(), bytes(jpub))


def test_pad_to_shards_equals_the_reference():
    for n in (0, 1, 5, 7, 8, 13, 97, 100, 4096, 10_000):
        for parts in (1, 2, 3, 4, 8):
            for bucket in (None, 0, 16, 256, 10_240):
                assert M.pad_to_shards(n, parts, bucket) == JM.pad_to_shards(n, parts, bucket)


def test_a_batch_that_does_not_divide_is_refused_as_the_reference_refuses_it():
    ref_eng = JM.MeshVerifyEngine(jax.devices("cpu")[:8], calibrate=False)
    args = (np.zeros((10, 32), np.uint8), np.zeros((10, 96), np.uint8), np.zeros(10, bool))
    with pytest.raises(ValueError) as want:
        ref_eng.submit(*args)
    with pytest.raises(ValueError) as got:
        M.MeshVerifyEngine([CPU] * 8).submit(*args)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="do not split over 2 hosts"):
        M.make_mesh_2d([CPU] * 7, hosts=2)
    with pytest.raises(ValueError, match="do not split over 2 hosts"):
        JM.make_mesh_2d(jax.devices("cpu")[:7], hosts=2)


def test_round_robin_equals_the_reference():
    ref_eng = JM.MeshVerifyEngine(jax.devices("cpu")[:8], calibrate=False)
    want = [ref_eng.devices.index(ref_eng.next_device()) for _ in range(16)]
    eng = M.MeshVerifyEngine([CPU] * 8)
    before = crypto_metrics().mesh_batches_total.values()
    got = []
    for _ in range(16):
        got.append(eng._rr % 8)
        assert eng.next_device() == CPU
    assert got == want == [i % 8 for i in range(16)]
    assert placed(before) == {(str(i), "stream"): 2.0 for i in range(8)}
    assert crypto_metrics().mesh_devices.values()[()] == 8.0


def test_get_engine_policy(monkeypatch):
    monkeypatch.setattr(M, "default_devices", lambda: [CPU] * 8)
    cases = [("0", None), ("off", None), ("", 8), ("on", 8), ("auto", 8), ("1", 8), ("2", 2),
             ("20", 8), ("x", None)]
    for env, want in cases:
        monkeypatch.setenv(M.ENV, env)
        M.reset_engine()
        eng = M.get_engine()
        assert (eng and eng.n_devices) == want, env
        monkeypatch.setenv(M.ENV, "0" if want else "on")
        assert M.get_engine() is eng  # probed once
    monkeypatch.delenv(M.ENV)
    monkeypatch.setattr(M, "default_devices", lambda: [CPU])
    M.reset_engine()
    assert M.get_engine() is None  # one device: no mesh
    monkeypatch.setenv("COMETBFT_TPU_MESH", "on")  # the reference's variable is not the port's
    M.reset_engine()
    assert M.get_engine() is None
    eng = M.MeshVerifyEngine([CPU] * 3)
    M.set_engine(eng)
    assert E._mesh_engine() is eng


def test_pipeline_depth_is_one_plus_the_mesh():
    eng = ReplayEngine(None, None, device="cpu")
    assert eng._pipeline_depth() == 2
    M.set_engine(M.MeshVerifyEngine([CPU] * 4))
    assert eng._pipeline_depth() == 5
    assert ReplayEngine(None, None, device="cpu", depth=3)._pipeline_depth() == 3


def test_the_mesh_is_never_picked_on_the_cpu(monkeypatch):
    eng = M.MeshVerifyEngine([CPU] * 4)
    M.set_engine(eng)
    assert eng.dispatch_terms() == {"put_fixed_s": None, "collective_s": None, "calibrated": False}
    assert not E._mesh_beats_single(10_000, 10_240, "cpu")
    assert not E._mesh_beats_single(E.MESH_MIN, E.MESH_MIN, CPU)
    eng.set_collective_s(2e-5)
    assert eng.dispatch_terms()["collective_s"] == 2e-5


def _model_terms(ladder_ms, issue_ms):
    return {"ladder_us": 1.0, "ladder_s": ladder_ms * 1e-3, "ladder_issue_s": issue_ms * 1e-3,
            "rlc_us": float("inf"), "rlc_s": float("inf"), "rlc_issue_s": 0.0, "rlc_wire_b": 0,
            "rlc_threads": 1, "rlc_native": True, "delta_us": float("inf"),
            "delta_s": float("inf"), "delta_issue_s": 0.0, "delta_wire_b": 0}


@pytest.mark.parametrize("devices, serial, picked", [
    (["cuda:0", "cuda:1", "cuda:2", "cuda:3"], 1, True),  # four cards: the shards overlap
    (["cuda:0"] * 4, 4, False),  # four logical shards of one card run one after another
])
def test_mesh_term_takes_the_shards_bucket(monkeypatch, devices, serial, picked):
    """The mesh term reads a shard's own stages at b/d lanes: its device
    stage is a shard's time (d times it on logical shards of one card)
    plus the sum, its host stage the pack plus d issues of a shard's
    launches. A shard of 2,560 lanes costing 6 ms against 10,240 lanes'
    20 ms: four cards win, four logical shards do not."""
    monkeypatch.setattr(E, "_LINK_MBPS", {"cuda": 1000.0})
    monkeypatch.setattr(E, "_TERMS", {(10_240, "cuda"): _model_terms(20.0, 3.0),
                                      (2_560, "cuda", "shard"): {"issue_s": 2e-3,
                                                                 "device_s": 6e-3}})
    eng = type("Eng", (), {"n_devices": 4, "on_gpu": True,
                           "devices": [torch.device(d) for d in devices],
                           "dispatch_terms": lambda self: {"put_fixed_s": 1e-5,
                                                           "collective_s": 5e-5,
                                                           "calibrated": True}})()
    monkeypatch.setattr(E, "_mesh_engine", lambda: eng)
    m = E.dispatch_model(10_000, 10_240, "cuda")
    assert m["mesh"]["device"] == pytest.approx(serial * 6e-3 + 5e-5)
    assert m["mesh"]["host"] == pytest.approx(10_000 * 1e-6 + 4 * 2e-3)
    assert m["mesh"]["wire"] == pytest.approx(m["ladder"]["wire"] + 4 * 1e-5)
    assert m["ladder"]["device"] == pytest.approx(20e-3) and m["n_devices"] == 4
    assert E._mesh_beats_single(10_000, 10_240, "cuda") is picked


def test_shard_terms_time_one_shards_verify(monkeypatch):
    """`_shard_terms(k)` times what a shard runs, `verify_batch_prehashed`
    on k lanes (here on the CPU, the timer stubbed), once per k."""
    calls = []

    def timed(fn, dev):
        bits, ok = fn()
        calls.append((bits.shape, ok.shape, dev))
        return 0.001, 0.002

    monkeypatch.setattr(E, "_TERMS", {})
    monkeypatch.setattr(E, "_timed_launch", timed)
    assert E._shard_terms(8, CPU) == {"issue_s": 0.001, "device_s": 0.002}
    assert E._shard_terms(8, CPU) is E._TERMS[(8, "cpu", "shard")]
    assert calls == [((8,), (), CPU)]


def test_device_keys_name_the_card(monkeypatch):
    assert device_key("cpu") == CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert device_key("cuda") == device_key("cuda:0") == torch.device("cuda", 0)
    assert str(device_key(torch.device("cuda"))) == "cuda:0"
    assert device_key("cuda:1") == torch.device("cuda", 1)


def test_submit_takes_the_mesh_through_the_seam_and_the_grid_agrees(monkeypatch):
    """With an engine installed and the pick forced, submit() shards the
    batch (path "mesh"; a precheck failure and two bad lanes, one the
    last, come back exact); the 2 x 2 (host, sig) grid gives the 1-D
    mesh's bits on the same arrays."""
    monkeypatch.setattr(E, "NATIVE_MAX", 0)
    monkeypatch.setattr(E, "MESH_MIN", 1)
    monkeypatch.setattr(E, "_mesh_beats_single", lambda n, b, device: True)
    M.set_engine(M.MeshVerifyEngine([CPU] * 4))
    items = signed_items(13, {5, 12})
    bv = E.Ed25519BatchVerifier(CPU)
    for pub, msg, sig in items:
        bv.add(E.Ed25519PubKey(pub), msg, sig)
    pub, msg, sig = items[0]
    bv.add(E.Ed25519PubKey(pub), msg, sig[:32] + E._L.to_bytes(32, "little"))  # S = L
    before = crypto_metrics().mesh_batches_total.values()
    pending = bv.submit()
    assert pending._path == "mesh"
    ok, bits = pending.result()
    assert not ok and [i for i, b in enumerate(bits) if not b] == [5, 12, 13]
    assert placed(before) == {(str(i), "shard"): 1.0 for i in range(4)}
    a, rsk, live = port_packed(items, 4)
    one_ok, one_bits = M.MeshVerifyEngine([CPU] * 4).submit(a, rsk, live)
    grid = M.MeshVerifyEngine([CPU] * 4, hosts=2)
    assert grid.mesh == [[CPU, CPU], [CPU, CPU]] and grid.axes == ("host", "sig")
    two_ok, two_bits = grid.submit(a, rsk, live)
    assert torch.equal(M.gather_bits(one_bits), M.gather_bits(two_bits))
    assert bool(one_ok) == bool(two_ok) is False


def test_streamed_batches_go_round_robin(monkeypatch):
    monkeypatch.setattr(E, "NATIVE_MAX", 0)
    M.set_engine(M.MeshVerifyEngine([CPU] * 2))
    before = crypto_metrics().mesh_batches_total.values()
    items = signed_items(3, {1})
    for _ in range(3):
        bv = E.Ed25519BatchVerifier(CPU)
        for pub, msg, sig in items:
            bv.add(E.Ed25519PubKey(pub), msg, sig)
        pending = bv.submit()
        assert pending._path == "ladder" and pending.result() == (False, [True, False, True])
    assert placed(before) == {("0", "stream"): 2.0, ("1", "stream"): 1.0}


def test_device_sha_sharded_verifier_equals_verify_batch():
    """The device-SHA form over 2 shards against `verify_batch` on the same
    arrays, a lane of the second shard broken."""
    from cometbft_tpu_torch.graft_entry import _example_batch

    a, r, s, words, two, live = _example_batch(16, "cpu")
    s = s.clone()
    s[11, 0] ^= 1
    want_bits, want_ok = V.verify_batch(a, r, s, words, two, live)
    ok, bits = M.sharded_verify_fn([CPU, CPU])(a, r, s, words, two, live)
    assert torch.equal(M.gather_bits(bits), want_bits)
    assert bool(ok) == bool(want_ok) is False and not want_bits[11] and want_bits.sum() == 15
