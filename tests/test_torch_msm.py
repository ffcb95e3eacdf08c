"""The port's RLC/MSM route against the JAX package's and an exact-integer
oracle, on the CPU.

One signed batch (made with `ed25519_ref`, not the JAX `testgen`) and one
pinned set of z coefficients give both packages the same layout at
bucket 64. The host layout and `expand_stream` must be byte-identical to
the reference's; `_accumulate` bitwise equal to the reference's jitted
one, on the same niels arrays (numpy, converted once, so JAX never
compiles its decompression); the weighted lanes, region sums and window
combine equal to an exact-integer emulation of the MSM as projective
points; the verdicts of `rlc_verify_stream` and of the verifier's RLC
route equal `ed25519_ref.verify`'s, and the blame rerun equal to the
ladder route's bitmap. Exact throughout: integer arithmetic.
"""

import hashlib

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from cometbft_tpu.crypto import rlc as JR  # noqa: E402
from cometbft_tpu.ops import msm as JM  # noqa: E402
from cometbft_tpu_torch.crypto import ed25519 as E  # noqa: E402
from cometbft_tpu_torch.crypto import ed25519_ref as ref  # noqa: E402
from cometbft_tpu_torch.crypto import rlc  # noqa: E402
from cometbft_tpu_torch.ops import curve as C  # noqa: E402
from cometbft_tpu_torch.ops import field as F  # noqa: E402
from cometbft_tpu_torch.ops import msm as M  # noqa: E402

BUCKET = 64
N_SIGS = 9
P = F.P_INT


def signed(rng, n, msg_len=64):
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


def torsion_signed(rng, msg: bytes, shift_a: bool, t8):
    """Valid only under the cofactored equation: A or R has an 8-torsion part."""
    a = int.from_bytes(rng.bytes(32), "little") % ref.L
    r = int.from_bytes(rng.bytes(32), "little") % ref.L
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


def no_root_encoding() -> bytes:
    """A y encoding with no square root for x: not a curve point."""
    for y in range(2, 50):
        enc = y.to_bytes(32, "little")
        if ref._decode_point(enc, zip215=True) is None:
            return enc
    raise AssertionError("every small y decodes")


def s_pad_of(prep) -> int:
    s_pad = 8
    while s_pad < prep["s_rounds"]:
        s_pad *= 2
    return s_pad


def device_inputs(items, skip, prep):
    """The route's device arrays for one batch, as CPU tensors."""
    a = np.zeros((BUCKET, 32), np.uint8)
    r = np.zeros((BUCKET, 32), np.uint8)
    live = np.zeros(BUCKET, bool)
    for i, (pub, _, sig) in enumerate(items):
        a[i] = np.frombuffer(pub, np.uint8)
        r[i] = np.frombuffer(sig[:32], np.uint8)
    live[: len(items)] = ~skip
    return (torch.from_numpy(a), torch.from_numpy(r), torch.from_numpy(live),
            torch.from_numpy(prep["stream"].astype(np.int32)), torch.from_numpy(prep["stream_neg"]),
            torch.from_numpy(prep["counts"]), torch.from_numpy(prep["weights"]),
            torch.from_numpy(prep["c_digits"]))


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(215)
    items = signed(rng, N_SIGS)
    z16 = rng.integers(0, 256, (N_SIGS, 16), dtype=np.uint8)
    skip = np.zeros(N_SIGS, bool)
    prep = rlc.prepare(items, skip, BUCKET, z16)
    s_pad = s_pad_of(prep)
    idx, neg = M.expand_stream(torch.from_numpy(prep["stream"]),
                               torch.from_numpy(prep["stream_neg"]),
                               torch.from_numpy(prep["counts"]), s_pad)
    # affine niels of R_i (at i), A_i (at BUCKET + i) and the sentinel (at
    # 2 BUCKET), from the port's decompress and to_niels on the CPU
    a_bytes, r_bytes = device_inputs(items, skip, prep)[:2]
    _, a_pt = C.decompress(a_bytes)
    _, r_pt = C.decompress(r_bytes)
    niels = tuple(torch.cat([r_c, a_c, i_c], dim=1) for r_c, a_c, i_c in zip(
        C.to_niels(r_pt)[:3], C.to_niels(a_pt)[:3], M._identity_niels(1, "cpu")))
    return {"items": items, "z16": z16, "prep": prep, "s_pad": s_pad, "idx": idx, "neg": neg,
            "niels": niels}


def emulate(items, idx, neg, weights):
    """Exact-integer emulation of the device MSM over the host layout
    (tests/test_dispatch.py::test_rlc_layout_msm_semantics): per-lane
    weighted points, region sums, and the Horner total."""
    table = {}
    for i, (pub, _, sig) in enumerate(items):
        table[i] = ref._to_ext(ref._decode_point(sig[:32], zip215=True))
        table[BUCKET + i] = ref._to_ext(ref._decode_point(pub, zip215=True))
    ident = ref._IDENT
    acc = [ident] * rlc.WK
    for s in range(idx.shape[0]):
        for lane in np.nonzero(idx[s] != 2 * BUCKET)[0]:
            pt = table[int(idx[s, lane])]
            acc[lane] = ref._ext_add(acc[lane], ref._ext_neg(pt) if neg[s, lane] else pt)
    wts = weights.reshape(-1)
    weighted = [ref._ext_scalar_mul(int(w), a) if w and a is not ident else ident
                for w, a in zip(wts, acc)]
    window_of = {rlc.region_of_m(w): w for w in range(rlc.N_WINDOWS)}
    window_of.update({rlc.region_of_z(w): w for w in range(rlc.Z_WINDOWS)})
    regions, total = [], ident
    for r in range(rlc.N_REGIONS):
        win = ident
        for lane in range(r * rlc.K_BUCKETS, (r + 1) * rlc.K_BUCKETS):
            if weighted[lane] is not ident:
                win = ref._ext_add(win, weighted[lane])
        regions.append(win)
        total = ref._ext_add(total, ref._ext_scalar_mul(1 << (10 * window_of[r]), win))
    return weighted, regions, total


def limbs_of(points):
    """Python extended points -> four (22, n) CPU tensors (affine, Z = 1)."""
    out = np.zeros((4, F.NLIMBS, len(points)), np.int32)
    out[1:3, 0] = 1  # identity: (0, 1, 1, 0)
    for i, pt in enumerate(points):
        if ref._ext_is_identity(pt):
            continue
        x, y = ref._ext_to_affine(pt)
        for c, v in enumerate((x, y, 1, x * y % P)):
            out[c, :, i] = F.from_int(v)
    return tuple(torch.from_numpy(o) for o in out)


def same_points(got, want_py):
    return bool(C._PLAIN.eq_points(got, limbs_of(want_py)).all())


# ---------------------------------------------------------------- host layout


def test_layout_constants_match_reference():
    for name in ("C_BITS", "K_BUCKETS", "N_WINDOWS", "Z_WINDOWS", "N_REGIONS", "WK"):
        assert getattr(rlc, name) == getattr(JR, name) == getattr(M, name)
    assert M.REGION_DBL == JM.REGION_DBL
    assert [rlc.region_of_m(w) for w in range(26)] == [JR.region_of_m(w) for w in range(26)]
    assert [rlc.region_of_z(w) for w in range(13)] == [JR.region_of_z(w) for w in range(13)]
    assert [rlc.slot_depth(b) for b in E.BUCKETS] == [JR.slot_depth(b) for b in E.BUCKETS]
    scal = np.random.default_rng(3).integers(0, 256, (50, 33), dtype=np.uint8)
    scal[:, 32] = 0
    scal[:, 31] &= 0x1F  # < 2^253
    np.testing.assert_array_equal(rlc._signed_digits(scal, 26), JR._signed_digits(scal, 26))


@pytest.mark.parametrize("case", ["all_live", "skipped_lanes", "all_skipped"])
def test_prepare_is_byte_identical_to_reference(batch, case):
    skip = np.zeros(N_SIGS, bool)
    if case == "skipped_lanes":
        skip[[1, 4]] = True
    elif case == "all_skipped":
        skip[:] = True
    got = rlc.prepare(batch["items"], skip, BUCKET, batch["z16"])
    want = JR.prepare_numpy(batch["items"], skip, BUCKET, batch["z16"])
    if case == "all_skipped":
        assert got is None and want is None
        return
    assert set(got) == set(want)
    assert got["s_rounds"] == want["s_rounds"]
    for k in ("stream", "stream_neg", "counts", "weights", "c_digits"):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_expand_stream_matches_reference(batch):
    prep, s_pad = batch["prep"], batch["s_pad"]
    want_idx, want_neg = jax.jit(JM.expand_stream, static_argnames="s_rounds")(
        prep["stream"], prep["stream_neg"], prep["counts"], s_rounds=s_pad)
    host_idx, host_neg = rlc.expand_stream_host(prep, s_pad)
    ref_host_idx, ref_host_neg = JR.expand_stream_host(prep, s_pad)
    assert batch["idx"].dtype == torch.int32 and batch["neg"].dtype == torch.bool
    np.testing.assert_array_equal(batch["idx"].numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(batch["neg"].numpy(), np.asarray(want_neg))
    np.testing.assert_array_equal(host_idx, ref_host_idx)
    np.testing.assert_array_equal(host_neg, ref_host_neg)
    np.testing.assert_array_equal(batch["idx"].numpy(), host_idx)
    np.testing.assert_array_equal(batch["neg"].numpy(), host_neg)


# ---------------------------------------------------------------- device math


def test_accumulate_is_bitwise_equal_to_reference(batch):
    niels_np = tuple(c.numpy() for c in batch["niels"])
    want = jax.jit(JM._accumulate)(niels_np, batch["idx"].numpy(), batch["neg"].numpy())
    got = M._accumulate(batch["niels"], batch["idx"], batch["neg"])
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_weighted_lanes_and_window_sums_match_exact_emulation(batch):
    prep = batch["prep"]
    weights = torch.from_numpy(prep["weights"])
    # a CPU tensor takes the plain version, accumulate_weighted_plain
    weighted = M.accumulate_weighted(batch["niels"], batch["idx"], batch["neg"], weights)
    want_w, want_regions, want_total = emulate(
        batch["items"], batch["idx"].numpy(), batch["neg"].numpy(), prep["weights"])
    assert same_points(weighted, want_w)
    win_sums = M.region_tree_sum(weighted)
    assert win_sums[0].shape == (F.NLIMBS, rlc.N_REGIONS)
    assert same_points(win_sums, want_regions)
    msm = M.window_combine(win_sums)
    assert same_points(msm, [want_total])
    # and the layout satisfies the RLC equation
    total = C.add(msm, C.fixed_base(torch.from_numpy(prep["c_digits"])))
    assert bool(C.is_identity(C.mul8(total))[0])


# ---------------------------------------------------------------- verdicts


def verdict_case(case):
    """(items, skip) for one verdict case, and the verdict ref.verify gives."""
    rng = np.random.default_rng(list(case.encode()))
    items = signed(rng, 6)
    skip = np.zeros(len(items), bool)
    if case == "torsion_and_skipped":
        t8 = torsion_point()
        items[1] = torsion_signed(rng, items[1][1], True, t8)
        items[4] = torsion_signed(rng, items[4][1], False, t8)
        # S >= L: the precheck skips the lane (z = 0, not live), and its R,
        # which is no curve point, must not fail the batch
        pub, msg, _ = items[5]
        items[5] = (pub, msg, no_root_encoding() + (ref.L + 1).to_bytes(32, "little"))
        skip[5] = True
    elif case == "r_no_root":
        pub, msg, sig = items[3]
        items[3] = (pub, msg, no_root_encoding() + sig[32:])
    want = all(ref.verify(*it) for it, bad in zip(items, skip) if not bad)
    return items, skip, want


@pytest.mark.parametrize("case, expect", [
    ("all_valid", True), ("torsion_and_skipped", True), ("r_no_root", False),
])
def test_rlc_verify_stream_verdicts(case, expect):
    items, skip, want = verdict_case(case)
    assert want == expect
    z16 = np.random.default_rng(7).integers(0, 256, (len(items), 16), dtype=np.uint8)
    prep = rlc.prepare(items, skip, BUCKET, z16)
    ok = M.rlc_verify_stream(*device_inputs(items, skip, prep), s_rounds=s_pad_of(prep))
    assert ok.dtype == torch.bool and ok.shape == ()
    assert bool(ok) == want


# ---------------------------------------------------------------- the route


@pytest.fixture(autouse=True)
def device_routes(monkeypatch):
    """NATIVE_MAX = 0: every batch here is smaller than NATIVE_MAX and
    would go to the native C++ engine; these tests hold the device
    routes."""
    monkeypatch.setattr(E, "NATIVE_MAX", 0)


@pytest.fixture
def rlc_seam(monkeypatch):
    """Pin the verifier's dispatch on the RLC route for any batch size."""
    monkeypatch.setattr(E, "RLC_MIN", 1)
    monkeypatch.setattr(E, "_rlc_beats_ladder", lambda n, b, device: True)


def verifier(items, **kw):
    bv = E.Ed25519BatchVerifier(device="cpu", **kw)
    for pub, msg, sig in items:
        bv.add(E.Ed25519PubKey(pub), msg, sig)
    return bv


def test_dispatch_keeps_the_ladder_by_default():
    assert E.RLC_MIN == 4096
    assert E._rlc_beats_ladder(10_000, 10_240, torch.device("cpu")) is False


def test_packed_buffer_carries_the_layout(batch):
    bv = verifier(batch["items"])
    buf, fields, s_pad = bv._pack_rlc(batch["z16"])
    assert buf.dtype == torch.uint8 and buf.dim() == 1 and s_pad == batch["s_pad"]
    t = E.unpack_fields(buf, fields)
    prep = batch["prep"]
    for k in ("stream", "stream_neg", "counts", "weights", "c_digits"):
        np.testing.assert_array_equal(t[k].numpy().astype(prep[k].dtype), prep[k], err_msg=k)
    assert t["a"][N_SIGS:].eq(0).all() and t["live"].tolist() == [1] * N_SIGS + [0] * (
        BUCKET - N_SIGS)
    assert bytes(t["r"][0].numpy()) == batch["items"][0][2][:32]


def test_rlc_route_blames_like_the_ladder(rlc_seam):
    """A flipped signature bit makes the RLC verdict false; the blame rerun
    on the ladder then gives the same bitmap as the ladder route."""
    rng = np.random.default_rng(99)
    items = signed(rng, 7)
    pub, msg, sig = items[3]
    items[3] = (pub, msg, bytes([sig[0] ^ 1]) + sig[1:])
    pub, msg, sig = items[5]
    items[5] = (pub, msg, sig[:32] + (ref.L + 2).to_bytes(32, "little"))  # S >= L
    bv = verifier(items)
    pending = bv.submit()
    assert isinstance(pending, E.PendingRLC)
    assert not bool(pending._all_ok)
    ladder = verifier(items, force_perlane=True).submit()
    assert isinstance(ladder, E.PendingBatch)
    (ok, bits), (ok_l, bits_l) = E.collect_pending([pending, ladder])
    want = [ref.verify(*it) for it in items]
    assert not ok and not ok_l
    assert bits == bits_l == want == [i not in (3, 5) for i in range(7)]


def test_rlc_route_declines_to_the_ladder(rlc_seam):
    """No live lane (every S >= L): the layout declines and the ladder
    route takes the batch."""
    rng = np.random.default_rng(5)
    items = [(p, m, s[:32] + (ref.L + i).to_bytes(32, "little"))
             for i, (p, m, s) in enumerate(signed(rng, 3))]
    pending = verifier(items).submit()
    assert isinstance(pending, E.PendingBatch)
    assert pending.result() == (False, [False] * 3)
