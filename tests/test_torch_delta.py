"""The port's structured-wire (delta) route against the JAX package's, on
the CPU.

`cometbft_tpu_torch.crypto.ed25519._detect_delta`, `_pack_delta` and
`ops.ed25519_verify.build_delta_msgs` / `verify_batch_delta` (through the
plain versions of the `sha512_blocks`, `reduce512`, `decompress` and
ladder kernels) against `cometbft_tpu`'s `_detect_delta`,
`build_delta_msgs` and `verify_batch_delta` under `jax.jit` on the CPU,
on ragged middle lengths; the port's verifier with the delta route pinned
(as `tests/test_dispatch.py:279-333` pins the reference's) against the
reference verifier's and the oracle's bitmaps; and the route's dispatch
term. Inputs come from numpy with fixed seeds. The tolerance is exact
everywhere: dicts, words, bitmaps and all-ok must be equal bit for bit.
Every verify batch has one shape (B = 64, 73-byte packed rows), so the
reference compiles its verify graph once (`fast_jit`). Its pubkey stage
is fed the port's `decompress_pubkeys` output instead of compiling its
own: `tests/test_torch_verify.py::test_prehashed_and_cached_a_bitwise`
holds the two bitwise equal, and the oracle checks every bitmap here.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from cometbft_tpu.crypto import ed25519 as JE  # noqa: E402
from cometbft_tpu.ops import ed25519_verify as JV  # noqa: E402
from cometbft_tpu_torch.crypto import ed25519 as E  # noqa: E402
from cometbft_tpu_torch.crypto import ed25519_ref as ref  # noqa: E402
from cometbft_tpu_torch.ops import ed25519_verify as V  # noqa: E402
from cometbft_tpu_torch.ops import sha512 as H  # noqa: E402
from test_torch_sha512 import fast_jit  # noqa: E402

B = 64


def structured(n, seed, mids=(5, 6, 7, 8), pfx_len=70, sfx_len=14):
    """n signed lanes whose messages share a prefix and a suffix around a
    middle of ragged length (vote timestamps as varints)."""
    rng = np.random.default_rng(seed)
    pfx, sfx = rng.bytes(pfx_len), rng.bytes(sfx_len)
    out = []
    for i in range(n):
        key = rng.bytes(32)
        msg = pfx + rng.bytes(mids[i % len(mids)]) + sfx
        out.append((ref.pubkey_from_seed(key), msg, ref.sign(key, msg)))
    return out


def columns(items):
    return b"".join(m for _, m, _ in items), [len(m) for _, m, _ in items]


def verifier(items, **kw):
    bv = E.Ed25519BatchVerifier(device="cpu", **kw)
    for p, m, s in items:
        bv.add(E.Ed25519PubKey(p), m, s)
    return bv


@pytest.fixture(scope="module")
def batch():
    """A structured batch of 20 lanes: a flipped signature bit in lane 3,
    S >= L in lane 7 (a precheck failure, signature zeroed), a torsion-free
    valid rest."""
    items = structured(20, 7)
    p, m, s = items[3]
    items[3] = (p, m, bytes([s[0] ^ 1]) + s[1:])
    p, m, s = items[7]
    items[7] = (p, m, s[:32] + (int.from_bytes(s[32:], "little") + ref.L).to_bytes(32, "little"))
    return items


@pytest.fixture(scope="module")
def jax_verify_batch_delta():
    return fast_jit(JV.verify_batch_delta)


def port_decompress_pubkeys(a_bytes):
    """The port's pubkey stage on the reference's (B, 32) array, as numpy."""
    ok_a, neg_a = V.decompress_pubkeys(torch.from_numpy(np.array(a_bytes)))
    return ok_a.numpy(), tuple(c.numpy() for c in neg_a)


def test_detect_delta_matches_reference(batch):
    d = E._detect_delta(*columns(batch))
    jd = JE._detect_delta(batch)
    assert {k: d[k] for k in ("lcp", "lcs", "midmax")} == {k: jd[k] for k in
                                                             ("lcp", "lcs", "midmax")}
    assert (d["lcp"], d["lcs"], d["midmax"]) == (70, 14, 8)
    for k in ("arr", "lens", "mid_lens"):
        assert d[k].dtype == jd[k].dtype and np.array_equal(d[k], jd[k]), k
    # one length for all, and a suffix that runs into the middle
    for items in (structured(6, 8, mids=(8,)), structured(6, 9, mids=(3, 9), sfx_len=0)):
        d, jd = E._detect_delta(*columns(items)), JE._detect_delta(items)
        assert all(np.array_equal(d[k], jd[k]) for k in jd), items


def test_detect_delta_declines_like_the_reference():
    rng = np.random.default_rng(5)
    random = [(b"", rng.bytes(100), b"") for _ in range(8)]
    wide = [(b"", b"p" * 40 + rng.bytes(40) + b"s" * 10, b"") for _ in range(8)]
    empty = [(b"", b"", b"")] * 3
    long = [(b"", b"x" * 176, b"")] * 3
    for items in (random, wide, empty, long, []):
        assert E._detect_delta(*columns(items)) is None
        assert JE._detect_delta(items) is None


def test_build_delta_msgs_matches_reference_and_padding(batch):
    """The rebuilt words of each live lane equal the reference's and
    `pad_messages` of the lane's true R||A||M; the flags too."""
    bv = verifier(batch)
    d = E._detect_delta(bv._msg_buf, bv._msg_lens)
    buf, fields = bv._pack_delta(d)
    t = E.unpack_fields(buf, fields)
    a_enc = torch.zeros((B, 32), dtype=torch.uint8)
    a_enc[:20] = torch.from_numpy(np.frombuffer(bv._pub_buf, np.uint8).reshape(20, 32))
    meta, packed = t["meta"], t["packed"]
    h = V.DELTA_META_HEADER
    args = (a_enc, packed[:, :-1], packed[:, -1], meta[0].long(), meta[1].long(),
            meta[h : h + V.DELTA_PMAX], meta[h + V.DELTA_PMAX :])
    words, two = V.build_delta_msgs(*args)
    jwords, jtwo = jax.jit(JV.build_delta_msgs)(*(np.asarray(x) for x in args))
    np.testing.assert_array_equal(words.numpy().view(np.uint32), np.asarray(jwords))
    np.testing.assert_array_equal(two.numpy(), np.asarray(jtwo))
    pw, ptwo = H.pad_messages([sg[:32] + p + m for p, m, sg in bv._items()])
    np.testing.assert_array_equal(words[:20].numpy().view(np.uint32), pw)
    assert two[:20].tolist() == ptwo.tolist() == [True] * 20
    # the meta header: prefix and suffix lengths and n = 20
    assert meta[:5].tolist() == [70, 14, 20, 0, 0] and packed.shape == (B, 64 + 8 + 1)
    assert packed[:20, -1].tolist() == [5, 6, 7, 8] * 5


def test_verify_batch_delta_bitwise(batch, jax_verify_batch_delta):
    """The device half on the port's packed rows and meta: the same
    bitmap and all-ok as the reference's `verify_batch_delta`; dead lanes
    past n report False."""
    bv = verifier(batch)
    buf, fields = bv._pack_delta(E._detect_delta(bv._msg_buf, bv._msg_lens))
    t = E.unpack_fields(buf, fields)
    ok_a, neg_a, a_enc = bv._decompress_pubkeys(20, B, with_encodings=True)
    bits, all_ok = V.verify_batch_delta(ok_a, neg_a, a_enc, t["packed"], t["meta"])
    jbits, jall = jax_verify_batch_delta(ok_a.numpy(), tuple(c.numpy() for c in neg_a),
                                         a_enc.numpy(), t["packed"].numpy(), t["meta"].numpy())
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))
    assert bool(all_ok) == bool(jall) is False
    assert [i for i in range(B) if not bits[i]] == [3, 7] + list(range(20, B))


def test_delta_route_matches_reference_verifier(monkeypatch, batch, jax_verify_batch_delta):
    """Both verifiers with NATIVE_MAX = 0, DELTA_MIN = 1 and the route
    pinned: the path is `delta`, the bitmaps equal the reference
    verifier's and the oracle's, and a valid batch's all-ok is True; the
    wire is under 80 bytes a lane."""
    for mod in (E, JE):
        monkeypatch.setattr(mod, "NATIVE_MAX", 0)
        monkeypatch.setattr(mod, "DELTA_MIN", 1)
    monkeypatch.setattr(E, "_delta_beats_prehashed", lambda n, b, device: True)
    monkeypatch.setattr(JE, "_delta_beats_prehashed", lambda n, b: True)
    monkeypatch.setattr(JV, "verify_batch_delta_jit", jax_verify_batch_delta)
    monkeypatch.setattr(JV, "decompress_pubkeys_jit", port_decompress_pubkeys)
    monkeypatch.setattr(E, "_A_CACHE", {})
    want = [ref.verify(*it) for it in batch]
    assert want.count(False) == 2
    for items, expect in ((batch, (False, want)), (batch[8:], (True, [True] * 12))):
        bv = verifier(items)
        jbv = JE.Ed25519BatchVerifier(backend="tpu")
        for p, m, s in items:
            jbv.add(JE.Ed25519PubKey(p), m, s)
        pending, jpending = bv.submit(), jbv.submit()
        assert pending._path == jpending._path == "delta"
        assert pending.result() == jpending.result() == expect
        assert JE._LAST_WIRE_B_PER_LANE == 73
    # one entry a pubkey column, apart from the ladder's: it holds the encodings
    assert [k[1:] for k in E._A_CACHE] == [(B, "delta", "cpu")] * 2
    assert all(v[2].shape == (B, 32) for v in E._A_CACHE.values())


def test_delta_memo_is_cleared_where_the_lanes_change(monkeypatch, batch):
    """The detection is memoized per verifier; add, add_batch and absorb
    each clear it."""
    monkeypatch.setattr(E, "NATIVE_MAX", 0)
    monkeypatch.setattr(E, "DELTA_MIN", 1)
    monkeypatch.setattr(E, "_delta_beats_prehashed", lambda n, b, device: True)
    monkeypatch.setattr(E, "verify_batch_delta", lambda *args: (None, None))
    monkeypatch.setattr(E, "_A_CACHE", {})
    bv = verifier(batch[:4])
    bv._launch_device()
    assert bv._device_path == "delta" and bv._delta["mid_lens"].tolist() == [5, 6, 7, 8]
    p, m, s = batch[4]
    bv.add(E.Ed25519PubKey(p), m, s)
    assert bv._delta is None
    bv._launch_device()
    assert bv._delta["mid_lens"].tolist() == [5, 6, 7, 8, 5]
    bv.add_batch(np.frombuffer(p, np.uint8)[None], np.frombuffer(s, np.uint8)[None], m,
                 np.array([len(m)]))
    assert bv._delta is None
    bv._launch_device()
    bv.absorb(verifier(batch[5:6]))
    assert bv._delta is None
    bv._launch_device()
    assert len(bv._delta["mid_lens"]) == 7
    # random messages: detection declines, memoized as False, the ladder runs
    monkeypatch.setattr(E, "verify_batch_cached_a", lambda *args: (None, None))
    rng = np.random.default_rng(1)
    rand = verifier([(p, rng.bytes(100), s) for p, _, s in batch[:4]])
    rand._launch_device()
    assert rand._delta is False and rand._device_path == "ladder"


def test_delta_never_beats_the_ladder_on_the_cpu(monkeypatch):
    monkeypatch.setattr(E, "dispatch_model", lambda *a: pytest.fail("the model was asked"))
    for n in (E.DELTA_MIN, 10_000):
        assert E._delta_beats_prehashed(n, E._bucket(n), "cpu") is False
    assert (E.DELTA_MIN, E.DELTA_MAX_BUCKET) == (JE.DELTA_MIN, JE.DELTA_MAX_BUCKET)


@pytest.mark.parametrize("link_mbps, delta_s, delta_wins", [
    (1000.0, 0.020, False),  # a fast link: the extra device hashing costs more than the wire
    (1000.0, 0.010, True),  # a device half faster than the ladder's
    (5.0, 0.030, True),  # a slow link: 73 B a lane against 96 decides
])
def test_dispatch_model_delta_term(monkeypatch, link_mbps, delta_s, delta_wins):
    """The delta route's wire is its packed buffer's bytes over the link,
    its device and host terms the calibrated ones; it is picked when its
    slowest stage beats the ladder's."""
    b, n = 10_240, 10_000
    monkeypatch.setattr(E, "_LINK_MBPS", {"cuda": link_mbps})
    monkeypatch.setattr(E, "_TERMS", {(b, "cuda"): {
        "ladder_us": 0.4, "ladder_s": 0.012, "ladder_issue_s": 0.002,
        "rlc_us": 1.0, "rlc_s": 0.01, "rlc_issue_s": 0.0, "rlc_wire_b": 160 * b,
        "delta_us": 0.5, "delta_s": delta_s, "delta_issue_s": 0.002,
        "delta_wire_b": 73 * b + V.DELTA_META_LEN}})
    m = E.dispatch_model(n, b, "cuda")
    assert m["delta"]["wire"] == pytest.approx((73 * b + 360) / (link_mbps * 1e6))
    assert m["delta"]["host"] == pytest.approx(n * 0.5e-6 + 0.002)
    assert m["t_delta"] == max(m["delta"].values())
    assert E._delta_beats_prehashed(n, b, "cuda") is delta_wins
