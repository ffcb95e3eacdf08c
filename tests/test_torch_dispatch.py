"""The port's verifier dispatch, on the CPU: the native route under
NATIVE_MAX, the calibrated model between the two device routes, and the
dispatch telemetry.

- A batch of fewer than NATIVE_MAX lanes resolves on the native C++
  engine; on a mixed ZIP-215 batch (torsion A and R, S >= L, flipped bits,
  sign-flipped and identity keys) its bitmap equals the JAX package's
  verifier's, the oracle's and the port's own plain ladder's
  (NATIVE_MAX = 0).
- `dispatch_model`, with pinned link, host and device terms, picks as the
  reference's crossover tests do (`tests/test_dispatch.py:360-391`);
  `_rlc_beats_ladder` is False on the CPU without asking the model.
- `Ed25519PubKey.verify_signature` goes native.
- `submit()` feeds the crypto metrics and the `crypto.batch_verify` span,
  which carries the route taken.
"""

import hashlib
import json
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cometbft_tpu.crypto import ed25519 as JE  # noqa: E402
from cometbft_tpu_torch.crypto import ed25519 as E  # noqa: E402
from cometbft_tpu_torch.crypto import ed25519_ref as ref  # noqa: E402
from cometbft_tpu_torch.crypto import native  # noqa: E402
from cometbft_tpu_torch.utils import metrics, trace  # noqa: E402


@pytest.fixture
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the native host library")


rng = np.random.default_rng(17)


def signed(n, msg_len=80):
    out = []
    for _ in range(n):
        seed = bytes(rng.bytes(32))
        msg = bytes(rng.bytes(msg_len))
        out.append((ref.pubkey_from_seed(seed), msg, ref.sign(seed, msg)))
    return out


def torsion_point():
    for y in range(2, 50):
        aff = ref._decode_point(y.to_bytes(32, "little"), zip215=True)
        if aff is None:
            continue
        t = ref._ext_scalar_mul(ref.L, ref._to_ext(aff))
        if not ref._ext_is_identity(t):
            return t
    raise AssertionError("no torsion point found")


def torsion_signed(seed: bytes, msg: bytes, shift_a: bool, t8):
    """Valid only under the cofactored equation: A or R has an 8-torsion part."""
    a = int.from_bytes(seed, "little") % ref.L
    r = int.from_bytes(hashlib.sha512(seed).digest(), "little") % ref.L
    A = ref._ext_scalar_mul(a, ref.B_POINT)
    R = ref._ext_scalar_mul(r, ref.B_POINT)
    if shift_a:
        A = ref._ext_add(A, t8)
    else:
        R = ref._ext_add(R, t8)
    a_enc = ref._encode_point(*ref._ext_to_affine(A))
    r_enc = ref._encode_point(*ref._ext_to_affine(R))
    k = int.from_bytes(hashlib.sha512(r_enc + a_enc + msg).digest(), "little") % ref.L
    return a_enc, msg, r_enc + ((r + k * a) % ref.L).to_bytes(32, "little")


def mixed_batch():
    """Valid lanes, flipped signature bits, S >= L, sign-flipped A, torsion
    on A and on R, and the identity key canonical and non-canonical."""
    t8 = torsion_point()
    cases = []
    for i, (pub, msg, sig) in enumerate(signed(3)):
        cases.append((pub, msg, sig))
        cases.append((pub, msg, bytes([sig[0] ^ 1]) + sig[1:]))
        cases.append((pub, msg, sig[:40] + bytes([sig[40] ^ 0x10]) + sig[41:]))
        cases.append(torsion_signed(bytes([i]) + msg[:31], b"torsion-A", True, t8))
        cases.append(torsion_signed(bytes([i + 64]) + msg[:31], b"torsion-R", False, t8))
        cases.append((bytes([*pub[:31], pub[31] ^ 0x80]), msg, sig))
        s = int.from_bytes(sig[32:], "little")
        cases.append((pub, msg, sig[:32] + (s + ref.L).to_bytes(32, "little")))
    r_scalar = int.from_bytes(rng.bytes(32), "little") % ref.L
    r_enc = ref._encode_point(*ref._ext_to_affine(ref._ext_scalar_mul(r_scalar, ref.B_POINT)))
    sig_id = r_enc + r_scalar.to_bytes(32, "little")
    cases.append((ref._encode_point(0, 1), b"identity-key", sig_id))
    cases.append(((1 + ref.P).to_bytes(32, "little"), b"identity-key", sig_id))
    return cases


def port_verifier(cases):
    bv = E.Ed25519BatchVerifier(device="cpu")
    for p, m, s in cases:
        bv.add(E.Ed25519PubKey(p), m, s)
    return bv


@pytest.fixture
def telemetry(tmp_path):
    """Fresh crypto metrics and a trace sink; yields the sink's records."""
    metrics.reset_bundles()
    sink = tmp_path / "trace.jsonl"
    trace.configure(str(sink))

    def records():
        return [json.loads(ln) for ln in sink.read_text().splitlines()]

    yield records
    trace.disable()
    metrics.reset_bundles()


# ---------------------------------------------------------------- the native route


@pytest.mark.usefixtures("gxx")
def test_native_route_bitmap_matches_reference_and_plain_ladder(monkeypatch):
    cases = mixed_batch()
    want = [ref.verify(*c) for c in cases]
    assert want.count(True) == 3 * 3 + 2 and not all(want)
    pending = port_verifier(cases).submit()
    assert isinstance(pending, E.DonePending) and pending._path == "native"
    ok, bits = pending.result()
    jbv = JE.Ed25519BatchVerifier(backend="tpu")
    for p, m, s in cases:
        jbv.add(JE.Ed25519PubKey(p), m, s)
    jpending = jbv.submit()
    assert jpending._path == "native"
    assert (ok, bits) == jpending.result() == (False, want)
    # NATIVE_MAX = 0: the device route's plain versions give the same bitmap
    monkeypatch.setattr(E, "NATIVE_MAX", 0)
    plain = port_verifier(cases).submit()
    assert isinstance(plain, E.PendingBatch) and plain._path == "ladder"
    assert plain.result() == (False, want)


@pytest.mark.usefixtures("gxx")
@pytest.mark.parametrize("n", [1, 13, E.NATIVE_MAX - 1])
def test_native_route_below_native_max(n, monkeypatch):
    items = [signed(1)[0]] * n  # one signature, n times: cheap to make
    bv = port_verifier(items)
    called = []
    monkeypatch.setattr(E.Ed25519BatchVerifier, "_launch_device",
                        lambda self: called.append(self) or pytest.fail("device route taken"))
    pending = bv.submit()
    assert isinstance(pending, E.DonePending) and pending.result() == (True, [True] * n)
    assert not called


def test_native_max_is_the_reference_threshold_and_its_edge_goes_to_the_device(monkeypatch):
    assert E.NATIVE_MAX == JE.NATIVE_MAX == 1024
    items = [signed(1)[0]] * E.NATIVE_MAX
    bv = port_verifier(items)
    monkeypatch.setattr(E.Ed25519BatchVerifier, "_launch_device",
                        lambda self: (torch.ones(1, dtype=torch.bool), torch.tensor(True)))
    pending = bv.submit()
    assert isinstance(pending, E.PendingBatch) and pending._path == "ladder"


@pytest.mark.usefixtures("gxx")
def test_native_route_blames_precheck_and_bad_lanes():
    items = signed(12)
    p, m, s = items[2]
    items[2] = (p, m, bytes([s[0] ^ 1]) + s[1:])
    p, m, s = items[9]
    items[9] = (p, m, s[:32] + (ref.L + 5).to_bytes(32, "little"))  # S >= L: precheck
    ok, bits = port_verifier(items).submit().result()
    assert not ok and [i for i, b in enumerate(bits) if not b] == [2, 9]
    # every lane failed the precheck: no batch check, all False
    bad = [(p, m, s[:32] + (ref.L + i).to_bytes(32, "little")) for i, (p, m, s) in
           enumerate(signed(3))]
    assert port_verifier(bad).submit().result() == (False, [False] * 3)


def test_without_the_library_small_batches_take_the_device_route(monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)
    items = signed(3)
    pending = port_verifier(items).submit()
    assert isinstance(pending, E.PendingBatch) and pending._path == "ladder"
    assert pending.result() == (True, [True] * 3)


# ---------------------------------------------------------------- the model


def pin_model(monkeypatch, link_mbps, rlc_us, ladder_us=1.6, n=10_000, b=10_240,
              ladder_dev_us=2.39, rlc_dev_us=2.11, rlc_wire_b=116, issue_s=0.0):
    """The reference's crossover terms (`tests/test_dispatch.py:_pin_model`:
    per-signature host and device times and 116 wire bytes a lane) as the
    port's per-bucket terms."""
    monkeypatch.setattr(E, "_LINK_MBPS", {"cuda": float(link_mbps)})
    monkeypatch.setattr(E, "_TERMS", {(b, "cuda"): {
        "ladder_us": float(ladder_us), "ladder_s": n * ladder_dev_us * 1e-6,
        "ladder_issue_s": issue_s, "rlc_us": float(rlc_us), "rlc_s": n * rlc_dev_us * 1e-6,
        "rlc_issue_s": issue_s, "rlc_wire_b": rlc_wire_b * b, "rlc_threads": 1,
        "rlc_native": True, "delta_us": float("inf"), "delta_s": float("inf"),
        "delta_issue_s": issue_s, "delta_wire_b": 0}})


@pytest.mark.parametrize("link_mbps, rlc_us, rlc_wins, binding", [
    (1000.0, 1.1, True, "device"),  # fast link, native packer
    (1000.0, 20.0, False, "host"),  # numpy packer
    (30.0, 1.1, False, "wire"),  # slow link: RLC's 116 B a lane against 96
])
def test_dispatch_model_crossovers(monkeypatch, link_mbps, rlc_us, rlc_wins, binding):
    pin_model(monkeypatch, link_mbps, rlc_us)
    m = E.dispatch_model(10_000, 10_240, "cuda")
    assert m["t_rlc"] == pytest.approx(m["rlc"][binding])
    assert m["t_rlc"] == max(m["rlc"].values()) and m["t_ladder"] == max(m["ladder"].values())
    assert m["ladder"]["wire"] == pytest.approx(96 * 10_240 / (link_mbps * 1e6))
    assert E._rlc_beats_ladder(10_000, 10_240, "cuda") is rlc_wins


def test_dispatch_model_host_term_carries_launch_issue(monkeypatch):
    """The host issues a route's launches after packing: an issue time that
    makes RLC's host stage the slowest sends the batch back to the ladder."""
    pin_model(monkeypatch, 1000.0, 1.1, issue_s=0.0)
    assert E._rlc_beats_ladder(10_000, 10_240, "cuda")
    pin_model(monkeypatch, 1000.0, 1.1, issue_s=0.030)
    m = E.dispatch_model(10_000, 10_240, "cuda")
    assert m["rlc"]["host"] == pytest.approx(10_000 * 1.1e-6 + 0.030)
    assert m["ladder"]["host"] == pytest.approx(10_000 * 1.6e-6 + 0.030)
    pin_model(monkeypatch, 1000.0, 1.1)
    E._TERMS[(10_240, "cuda")]["rlc_issue_s"] = 0.030
    assert not E._rlc_beats_ladder(10_000, 10_240, "cuda")


def test_rlc_never_beats_the_ladder_on_the_cpu(monkeypatch):
    monkeypatch.setattr(E, "dispatch_model", lambda *a: pytest.fail("the model was asked"))
    for n in (E.RLC_MIN, 10_000, 65_536):
        assert E._rlc_beats_ladder(n, E._bucket(n), torch.device("cpu")) is False
        assert E._rlc_beats_ladder(n, E._bucket(n), "cpu") is False


def test_terms_are_calibrated_at_the_bucket(monkeypatch):
    """The host terms are the verifier's own packs of a bucket-wide
    throwaway batch, timed here; the device halves (a card's CUDA events)
    are stubbed: the ladder's, the delta route's and the RLC route's. Once
    per bucket and device."""
    monkeypatch.setattr(E, "_TERMS", {})
    timed = []
    monkeypatch.setattr(E, "_timed_launch", lambda fn, dev: timed.append(dev) or (0.001, 0.002))
    metrics.reset_bundles()
    cpu = torch.device("cpu")
    terms = E._terms(64, cpu)
    assert timed == [cpu, cpu, cpu]
    assert 0 < terms["ladder_us"] < 1e4 and 0 < terms["rlc_us"] < 1e5
    assert 0 < terms["delta_us"] < 1e4
    assert terms["ladder_issue_s"] == terms["rlc_issue_s"] == terms["delta_issue_s"] == 0.001
    assert terms["ladder_s"] == terms["rlc_s"] == terms["delta_s"] == 0.002
    # the delta buffer: (64, 64 + 8 + 1) rows and the 360-byte meta, 16-byte aligned
    assert terms["delta_wire_b"] == 64 * 73 + 368
    bv = port_verifier(signed(64))
    assert terms["rlc_wire_b"] == bv._pack_rlc()[0].numel()  # the packed buffer's bytes
    assert terms["rlc_native"] == native.rlc_available()
    assert terms["rlc_threads"] == native.rlc_packer_threads()
    assert E._terms(64, cpu) is terms and len(timed) == 3
    gauge = metrics.crypto_metrics().calibration_us_per_sig.values()
    assert gauge == {("ladder_us",): terms["ladder_us"], ("rlc_us",): terms["rlc_us"],
                     ("delta_us",): terms["delta_us"]}
    metrics.reset_bundles()


@pytest.mark.cuda
def test_terms_are_timed_on_the_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the device terms are timed on the card")
    monkeypatch.setattr(E, "_TERMS", {})
    m = E.dispatch_model(5000, 10_240, "cuda")
    t = m["terms"]
    assert 0 < t["ladder_s"] < 1 and 0 < t["rlc_s"] < 1 and t["rlc_wire_b"] > 96 * 10_240
    assert 0 < t["ladder_issue_s"] <= 1 and 0 < t["rlc_us"] < 1e3
    assert m["link_mbps"] > 100
    assert E._rlc_beats_ladder(5000, 10_240, "cuda") == (m["t_rlc"] < m["t_ladder"])


# ---------------------------------------------------------------- single votes


@pytest.mark.usefixtures("gxx")
def test_verify_signature_goes_native(monkeypatch, telemetry):
    (pub, msg, sig), = signed(1)
    seen = []
    real = native.verify
    monkeypatch.setattr(native, "verify", lambda *a: seen.append(a) or real(*a))
    monkeypatch.setattr(ref, "verify", lambda *a: pytest.fail("the oracle was asked"))
    key = E.Ed25519PubKey(pub)
    assert key.verify_signature(msg, sig)
    assert not key.verify_signature(msg + b"!", sig)
    assert seen == [(pub, msg, sig), (pub, msg + b"!", sig)]
    counts = metrics.crypto_metrics().path_selected_total.values()
    assert counts == {("single", "ed25519"): 2.0}


# ---------------------------------------------------------------- telemetry


@pytest.mark.usefixtures("gxx")
def test_submit_records_path_in_span_and_metrics(monkeypatch, telemetry):
    items = signed(5)
    ok, _ = port_verifier(items).submit().result()
    monkeypatch.setattr(E, "NATIVE_MAX", 0)
    pending = port_verifier(items[:3]).submit()
    assert E.collect_pending([pending]) == [(True, [True] * 3)]
    spans = [r for r in telemetry() if r["name"] == "crypto.batch_verify"]
    assert [(r["kind"], r["path"], r["n"]) for r in spans] == [("span", "native", 5),
                                                               ("span", "ladder", 3)]
    assert all(r["dur_ms"] >= 0 for r in spans)
    assert "model_host_ms" not in spans[1]  # the CPU's plain versions are not modeled
    m = metrics.crypto_metrics()
    assert m.path_selected_total.values() == {("native", "ed25519"): 1.0,
                                              ("ladder", "ed25519"): 1.0}
    assert m.batch_size.snapshot()[()] == {"count": 2, "sum": 8.0}
    latency = m.verify_seconds.snapshot()
    assert set(latency) == {("native", "ed25519"), ("ladder", "ed25519")}
    assert all(v["count"] == 1 for v in latency.values())
    assert pending._t0 is None  # observed once
    pending.result()
    assert m.verify_seconds.snapshot()[("ladder", "ed25519")]["count"] == 1


def test_span_carries_the_model_terms_on_a_gpu(monkeypatch, telemetry):
    """A device-route span on a GPU verifier carries the model's stage
    terms of the route taken (the device half stubbed: no card here)."""
    pin_model(monkeypatch, 1000.0, 1.1, n=3, b=64)
    bv = port_verifier(signed(3))
    monkeypatch.setattr(bv, "device", torch.device("cuda"))
    bv._record_dispatch("ladder", 3, 0.0, E.DonePending(True, [True] * 3))
    span, = telemetry()
    mdl = E.dispatch_model(3, 64, "cuda")
    assert span["path"] == "ladder" and span["n"] == 3 and span["link_mbps"] == 1000.0
    assert span["model_device_ms"] == round(mdl["ladder"]["device"] * 1e3, 3)
    assert span["model_wire_ms"] == round(mdl["ladder"]["wire"] * 1e3, 3)
    assert span["model_host_ms"] == round(mdl["ladder"]["host"] * 1e3, 3)


def test_tracing_off_writes_nothing(tmp_path):
    sink = tmp_path / "trace.jsonl"
    trace.configure(str(sink))
    trace.disable()
    assert not trace.enabled
    trace.emit("crypto.batch_verify", "span", path="native")
    port_verifier(signed(2)).submit().result()
    assert sink.read_text() == ""
