"""The CUDA kernels of `cometbft_tpu_torch` against their plain PyTorch
versions, on the card. Every test here needs a CUDA GPU and nvcc, and skips
without them. Run them on a machine with the card by

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

(`--noconftest`: the suite's conftest configures JAX, which that machine
need not have). Exact agreement after `freeze`: integer arithmetic.
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from cometbft_tpu_torch.crypto import ed25519_ref as ref  # noqa: E402
from cometbft_tpu_torch.ops import curve as C  # noqa: E402
from cometbft_tpu_torch.ops import field as F  # noqa: E402
from cometbft_tpu_torch.ops import kernels as K  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def device_routes(monkeypatch):
    """NATIVE_MAX = 0: the verifier tests' batches are smaller than
    NATIVE_MAX and would go to the native C++ engine; these tests hold the
    device routes."""
    from cometbft_tpu_torch.crypto import ed25519 as E

    monkeypatch.setattr(E, "NATIVE_MAX", 0)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels are built with nvcc and run only on the card")
    return torch.device("cuda")


def loose(rng, n):
    a = np.empty((F.NLIMBS, n), np.int32)
    a[0] = rng.integers(0, 13824, n)
    a[1:] = rng.integers(0, 4300, (F.NLIMBS - 1, n))
    a[:, : min(n, 1)] = 0
    if n > 1:
        a[0, 1], a[1:, 1] = 13823, 4299
    if n > 2:
        a[:, 2] = F.P_LIMBS
    return a


def frozen_equal(got, want):
    return torch.equal(F.freeze(got), F.freeze(want))


@pytest.mark.parametrize("n", [1, 33, 257, 4096])
def test_fe_mul_sq_match_plain(dev, n):
    rng = np.random.default_rng(n)
    a = torch.from_numpy(loose(rng, n)).to(dev)
    b = torch.from_numpy(loose(rng, n)).to(dev)
    before = dict(K.launches)
    got_mul, got_sq = F.mul(a, b), F.sq(a)
    assert K.launches["fe_mul"] == before["fe_mul"] + 1
    assert K.launches["fe_sq"] == before["fe_sq"] + 1
    assert frozen_equal(got_mul, F.mul_plain(a, b))
    assert frozen_equal(got_sq, F.sq_plain(a))
    assert torch.equal(got_mul, F.freeze(got_mul))  # canonical output


def test_decompress_matches_plain(dev):
    rng = np.random.default_rng(1)
    P = F.P_INT
    encs = rng.integers(0, 256, (300, 32), dtype=np.uint8)
    for i, y in enumerate([1, 1 + P, 0, P, P + 18, 2, 3]):
        encs[i] = np.frombuffer(y.to_bytes(32, "little"), np.uint8)
    encs[7] = encs[0]
    encs[7, 31] |= 0x80
    for i in range(8, 40):
        k = int.from_bytes(rng.bytes(32), "little") % ref.L
        encs[i] = np.frombuffer(
            ref._encode_point(*ref._ext_to_affine(ref._ext_scalar_mul(k, ref.B_POINT))), np.uint8)
    t = torch.from_numpy(encs).to(dev)
    valid, pt = C.decompress(t)
    sign, y = C._split_encoding(t)
    pv, px, ptt = C.decompress_plain(y, sign)
    assert torch.equal(valid, pv)
    assert frozen_equal(pt[0], px) and frozen_equal(pt[3], ptt)
    assert valid.cpu().tolist() == [
        ref._decode_point(e.tobytes(), zip215=True) is not None for e in encs]


def test_ladder_sub_mul8_matches_plain(dev):
    rng = np.random.default_rng(2)
    n = 70
    encs = np.stack([np.frombuffer(ref._encode_point(*ref._ext_to_affine(
        ref._ext_scalar_mul(int.from_bytes(rng.bytes(32), "little") % ref.L, ref.B_POINT))),
        np.uint8) for _ in range(2 * n)])
    ok, pts = C.decompress(torch.from_numpy(encs).to(dev))
    assert ok.all()
    a = C.neg(tuple(c[:, :n].contiguous() for c in pts))
    r = tuple(c[:, n:].contiguous() for c in pts)
    sd = torch.from_numpy(rng.integers(-8, 8, (64, n), dtype=np.int32)).to(dev)
    kd = torch.from_numpy(rng.integers(-8, 8, (64, n), dtype=np.int32)).to(dev)
    got = C.ladder_sub_mul8(sd, kd, a, r)
    want = C.ladder_sub_mul8_plain(sd, kd, a, r)
    assert all(frozen_equal(g, w) for g, w in zip(got, want))


def torsion_limbs(dev):
    """A nontrivial 8-torsion point as (X, Y, Z, T) limb columns."""
    for y in range(2, 50):
        aff = ref._decode_point(y.to_bytes(32, "little"), zip215=True)
        if aff is None:
            continue
        t = ref._ext_scalar_mul(ref.L, ref._to_ext(aff))
        if not ref._ext_is_identity(t):
            return tuple(torch.from_numpy(F.from_int(v % F.P_INT)).to(dev) for v in t)
    raise AssertionError("no torsion point found")


def ladder_inputs(rng, n, dev):
    """A, R, s and k digits for n lanes: random points and digits, with
    the edges in the first lanes: digits all -8, all 7 and all 0, then
    identity and 8-torsion A and R."""
    digits = lambda: torch.from_numpy(rng.integers(-8, 8, (64, 2 * n), dtype=np.int32)).to(dev)
    pts = C.fixed_base(digits())
    a = [c[:, :n].clone() for c in pts]
    r = [c[:, n:].clone() for c in pts]
    sd, kd = digits()[:, :n].contiguous(), digits()[:, :n].contiguous()
    for lane, v in enumerate((-8, 7, 0)[:n]):
        sd[:, lane] = v
        kd[:, lane] = v
    edges = [(C.identity(1, dev), a), (torsion_limbs(dev), a), (C.identity(1, dev), r),
             (torsion_limbs(dev), r)]
    for lane, (pt, dst) in enumerate(edges, start=3):
        if lane < n:
            for c in range(4):
                dst[c][:, lane] = pt[c].reshape(-1)
    return tuple(a), tuple(r), sd, kd


@pytest.mark.parametrize("n", [1, 3, 70, 1027])
def test_ladder_sub_mul8_ragged_batches(dev, n):
    """Partial thread groups and partial blocks: every lane matches the
    plain version, and the same lanes of a larger launch."""
    rng = np.random.default_rng(n)
    a, r, sd, kd = ladder_inputs(rng, 2048, dev)
    head = lambda t: t[..., :n].contiguous()
    before = K.launches["ladder_sub_mul8"]
    got = C.ladder_sub_mul8(head(sd), head(kd), tuple(map(head, a)), tuple(map(head, r)))
    assert K.launches["ladder_sub_mul8"] == before + 1
    want = C.ladder_sub_mul8_plain(head(sd), head(kd), tuple(map(head, a)), tuple(map(head, r)))
    assert all(frozen_equal(g, w) for g, w in zip(got, want))
    full = C.ladder_sub_mul8(sd, kd, a, r)
    assert all(torch.equal(g, f[:, :n]) for g, f in zip(got, full))


@pytest.mark.parametrize("n", [1, 3, 70, 1027])
def test_decompress_ragged_batches(dev, n):
    rng = np.random.default_rng(10 + n)
    encs = rng.integers(0, 256, (2048, 32), dtype=np.uint8)
    for i, y in enumerate([1, 1 + F.P_INT, 0, F.P_INT, 2]):
        encs[i] = np.frombuffer(y.to_bytes(32, "little"), np.uint8)
    sign, y = C._split_encoding(torch.from_numpy(encs).to(dev))
    sign_row = sign[None, :].contiguous()
    valid, x, t = K.decompress(y[:, :n].contiguous(), sign_row[:, :n].contiguous())
    pv, px, pt = C.decompress_plain(y[:, :n], sign[:n])
    assert torch.equal(valid[0] != 0, pv)
    assert frozen_equal(x, px) and frozen_equal(t, pt)
    fv, fx, ft = K.decompress(y, sign_row)
    assert torch.equal(valid, fv[:, :n]) and torch.equal(x, fx[:, :n]) and torch.equal(t, ft[:, :n])


def test_accum_weight_matches_plain(dev):
    """On a real gather table: a 24-signature batch at bucket 64, its
    layout from `crypto.rlc.prepare` with pinned z, at S = 8."""
    from cometbft_tpu_torch.crypto import rlc
    from cometbft_tpu_torch.ops import msm as M

    rng = np.random.default_rng(4)
    items = []
    for _ in range(24):
        seed = bytes(rng.bytes(32))
        msg = bytes(rng.bytes(50))
        items.append((ref.pubkey_from_seed(seed), msg, ref.sign(seed, msg)))
    prep = rlc.prepare(items, np.zeros(24, bool), 64,
                       rng.integers(0, 256, (24, 16), dtype=np.uint8))
    assert prep["s_rounds"] <= 8
    idx, neg = M.expand_stream(*(torch.from_numpy(prep[k]).to(dev)
                                 for k in ("stream", "stream_neg", "counts")), 8)
    encs = np.zeros((128, 32), np.uint8)
    for i, (pub, _, sig) in enumerate(items):
        encs[i] = np.frombuffer(sig[:32], np.uint8)
        encs[64 + i] = np.frombuffer(pub, np.uint8)
    _, pts = C.decompress(torch.from_numpy(encs).to(dev))
    niels = tuple(torch.cat([c, i], dim=1) for c, i in zip(C.to_niels(pts)[:3],
                                                         M._identity_niels(1, dev)))
    weights = torch.from_numpy(prep["weights"]).to(dev)
    before = K.launches["accum_weight"]
    got = M.accumulate_weighted(niels, idx, neg, weights)
    assert K.launches["accum_weight"] == before + 1
    want = M.accumulate_weighted_plain(niels, idx, neg, weights)
    assert all(frozen_equal(g, w) for g, w in zip(got, want))
    assert all(torch.equal(g, F.freeze(g)) for g in got)  # canonical output


@pytest.mark.parametrize("n", [1, 3, 70, 1027])
def test_accum_weight_ragged_lanes(dev, n):
    """Partial thread groups and partial blocks: every lane matches the
    plain version, and the same lanes of a 2,048-lane launch, at an odd S."""
    from cometbft_tpu_torch.ops import msm as M

    rng = np.random.default_rng(20 + n)
    lanes, rounds, points = 2048, 9, 500
    pts = C.fixed_base(torch.from_numpy(
        rng.integers(-8, 8, (64, points), dtype=np.int32)).to(dev))
    niels = tuple(c.contiguous() for c in C.to_niels(pts)[:3])
    idx = torch.from_numpy(rng.integers(0, points, (rounds, lanes), dtype=np.int32)).to(dev)
    neg = torch.from_numpy(rng.integers(0, 2, (rounds, lanes), dtype=np.int32)).to(dev)
    weights = torch.from_numpy(rng.integers(0, 1 << M.C_BITS, lanes, dtype=np.int32)).to(dev)
    head = lambda t: t[..., :n].contiguous()
    before = K.launches["accum_weight"]
    got = K.accum_weight(niels, head(idx), head(neg), head(weights))
    assert K.launches["accum_weight"] == before + 1
    want = M.accumulate_weighted_plain(niels, head(idx), head(neg) != 0, head(weights))
    assert all(frozen_equal(g, w) for g, w in zip(got, want))
    assert torch.equal(got, K.accum_weight(niels, idx, neg, weights)[..., :n])


def group_points(regions, dev):
    """(4, 22, regions * 512) points [s]B on the card (random digits), every
    37th lane the identity, as a weight-0 bucket lane holds it."""
    from cometbft_tpu_torch.ops import msm as M

    rng = np.random.default_rng(regions)
    lanes = regions * M.K_BUCKETS
    pts = torch.stack(C.fixed_base(torch.from_numpy(
        rng.integers(-8, 8, (64, lanes), dtype=np.int32)).to(dev)))
    pts[..., 5::37] = torch.stack(C.identity(1, dev))
    return pts.contiguous()


@pytest.mark.parametrize("regions", [1, 39])
def test_region_sum_matches_plain(dev, regions):
    from cometbft_tpu_torch.ops import msm as M

    pts = group_points(regions, dev)
    before = K.launches["region_sum"]
    got = M.region_tree_sum(pts)
    assert K.launches["region_sum"] == before + 1
    want = M.region_tree_sum_plain(pts)
    assert got.shape == (4, F.NLIMBS, regions)
    assert all(frozen_equal(g, w) for g, w in zip(got, want))
    assert all(torch.equal(g, F.freeze(g)) for g in got)  # canonical output


def test_window_combine_matches_plain(dev):
    from cometbft_tpu_torch.ops import msm as M

    sums = M.region_tree_sum_plain(group_points(M.N_REGIONS, dev))
    before = K.launches["window_combine"]
    got = M.window_combine(sums)
    assert K.launches["window_combine"] == before + 1
    want = M.window_combine_plain(sums)
    assert got.shape == (4, F.NLIMBS, 1)
    assert all(frozen_equal(g, w) for g, w in zip(got, want))
    assert all(torch.equal(g, F.freeze(g)) for g in got)


def test_rlc_route_on_the_card(dev, monkeypatch):
    """The RLC submit launches each kernel of its tail once and at most two
    standalone field products (the niels forms of A and R); the blame
    rerun finds the bad lane."""
    from cometbft_tpu_torch.crypto import ed25519 as E
    from cometbft_tpu_torch.crypto.testgen import generate_signed_batch

    monkeypatch.setattr(E, "RLC_MIN", 1)
    monkeypatch.setattr(E, "_rlc_beats_ladder", lambda n, b, device: True)
    items = generate_signed_batch(40, seed=5, device=dev)
    bv = E.Ed25519BatchVerifier(device=dev)
    for i, (pub, msg, sig) in enumerate(items):
        bv.add(E.Ed25519PubKey(pub), msg + (b"!" if i == 11 else b""), sig)
    before = dict(K.launches)
    pending = bv.submit()
    assert isinstance(pending, E.PendingRLC)
    torch.cuda.synchronize()
    ran = {k: K.launches[k] - before[k] for k in K.launches}
    assert ran["fe_mul"] + ran["fe_sq"] <= 2, ran
    assert ran["accum_weight"] == ran["region_sum"] == ran["window_combine"] == 1, ran
    assert ran["decompress"] == 2 and ran["ladder_sub_mul8"] == 1, ran
    ok, bits = pending.result()
    assert not ok and [i for i, b in enumerate(bits) if not b] == [11]


def test_verifier_on_the_card(dev):
    from cometbft_tpu_torch.crypto.ed25519 import Ed25519BatchVerifier, Ed25519PubKey
    from cometbft_tpu_torch.crypto.testgen import generate_signed_batch

    items = generate_signed_batch(50, seed=3, device=dev)
    bv = Ed25519BatchVerifier(device=dev)
    for i, (pub, msg, sig) in enumerate(items):
        bv.add(Ed25519PubKey(pub), msg + (b"!" if i == 7 else b""), sig)
    ok, bits = bv.verify()
    assert not ok and [i for i, b in enumerate(bits) if not b] == [7]
    assert generate_signed_batch(8, seed=3, device="cpu") == generate_signed_batch(
        8, seed=3, device=dev)


@pytest.mark.parametrize("route", ["ladder", "rlc"])
def test_prefetch_copies_the_summary_into_pinned_memory(dev, monkeypatch, route):
    """prefetch() on a CUDA handle copies its all-ok scalar into pinned host
    memory behind an event on the producing stream; result() reads it
    there and gives the same verdicts as an un-prefetched handle."""
    from cometbft_tpu_torch.crypto import ed25519 as E
    from cometbft_tpu_torch.crypto.testgen import generate_signed_batch

    monkeypatch.setattr(E, "RLC_MIN", 1)
    monkeypatch.setattr(E, "_rlc_beats_ladder", lambda n, b, device: route == "rlc")
    items = generate_signed_batch(40, seed=9, device=dev)
    for bad in (None, 13):
        handles = []
        for prefetch in (True, False):
            bv = E.Ed25519BatchVerifier(device=dev)
            for i, (pub, msg, sig) in enumerate(items):
                bv.add(E.Ed25519PubKey(pub), msg + (b"!" if i == bad else b""), sig)
            pending = bv.submit()
            assert type(pending).__name__ == ("PendingRLC" if route == "rlc" else "PendingBatch")
            assert pending._stream == torch.cuda.current_stream(dev)
            if prefetch:
                pending.prefetch()
                pending.prefetch()  # a second call starts nothing more
                assert pending._host_ok.is_pinned() and pending._ready is not None
            handles.append(pending)
        ok, bits = handles[0].result()
        assert (ok, bits) == handles[1].result()
        assert [i for i, b in enumerate(bits) if not b] == ([] if bad is None else [bad])


def sha_inputs(rng, n):
    """n padded R||A||M rows of 64 to 239 bytes (the block edges first) and
    their flags, as the device-SHA route packs them (int32 bit patterns)."""
    from cometbft_tpu_torch.ops import sha512 as H

    lens = ([0, 47, 48, 175] + rng.integers(0, 176, n).tolist())[:n]
    msgs = [rng.bytes(64 + ln) for ln in lens]
    words, two = H.pad_messages(msgs)
    return msgs, torch.from_numpy(words.view(np.int32)), torch.from_numpy(two)


def test_sha512_blocks_matches_plain_and_hashlib(dev):
    from cometbft_tpu_torch.ops import sha512 as H

    msgs, words, two = sha_inputs(np.random.default_rng(12), 4096)
    before = K.launches["sha512_blocks"]
    got = H.sha512_digest(words.to(dev), two.to(dev))
    assert K.launches["sha512_blocks"] == before + 1
    assert torch.equal(got.cpu(), H.sha512_digest_plain(words, two))
    assert [bytes(r) for r in got[:64].cpu().numpy()] == [
        __import__("hashlib").sha512(m).digest() for m in msgs[:64]]


def reduce_inputs(rng, n):
    from cometbft_tpu_torch.ops import scalar as SC

    L, top = SC.L_INT, (1 << 512) - 1
    vals = [0, L - 1, L, 2 * L, top, 3 * L - 1, top // L * L - 1]
    vals = (vals + [int.from_bytes(rng.bytes(64), "little") for _ in range(n)])[:n]
    return vals, torch.from_numpy(np.stack(
        [np.frombuffer(v.to_bytes(64, "little"), np.uint8) for v in vals]))


def test_reduce512_matches_plain_and_ints(dev):
    from cometbft_tpu_torch.ops import scalar as SC

    vals, digest = reduce_inputs(np.random.default_rng(13), 4096)
    before = K.launches["reduce512"]
    got = SC.reduce512(digest.to(dev)).cpu()
    assert K.launches["reduce512"] == before + 1
    assert torch.equal(got, SC.reduce512_plain(digest))
    assert [sum(int(x) << (12 * i) for i, x in enumerate(got[:, j])) for j in range(64)] == [
        v % SC.L_INT for v in vals[:64]]


@pytest.mark.parametrize("n", [1, 3, 70, 1027])
def test_sha512_blocks_ragged_batches(dev, n):
    _, words, two = sha_inputs(np.random.default_rng(14), 1027)
    full = K.sha512_blocks(words.to(dev), two.to(dev))
    part = K.sha512_blocks(words[:n].to(dev), two[:n].to(dev))
    assert torch.equal(part, full[:n])


@pytest.mark.parametrize("n", [1, 3, 70, 1027])
def test_reduce512_ragged_batches(dev, n):
    _, digest = reduce_inputs(np.random.default_rng(15), 1027)
    full = K.reduce512(digest.to(dev))
    assert torch.equal(K.reduce512(digest[:n].to(dev)), full[:, :n])


def test_sha512_reduce_matches_plain_and_hashlib(dev):
    """The fused hash and reduction, one launch: equal to the plain
    composition, and to Python's `% L` of hashlib's digest."""
    import hashlib

    from cometbft_tpu_torch.ops import scalar as SC

    msgs, words, two = sha_inputs(np.random.default_rng(16), 4096)
    before = K.launches["sha512_reduce"]
    got = SC.sha512_reduce(words.to(dev), two.to(dev)).cpu()
    assert K.launches["sha512_reduce"] == before + 1
    assert torch.equal(got, SC.sha512_reduce_plain(words, two))
    assert [sum(int(x) << (12 * i) for i, x in enumerate(got[:, j])) for j in range(64)] == [
        int.from_bytes(hashlib.sha512(m).digest(), "little") % SC.L_INT for m in msgs[:64]]


@pytest.mark.parametrize("n", [1, 3, 70, 1027])
def test_sha512_reduce_ragged_batches(dev, n):
    _, words, two = sha_inputs(np.random.default_rng(17), 1027)
    full = K.sha512_reduce(words.to(dev), two.to(dev))
    assert torch.equal(K.sha512_reduce(words[:n].to(dev), two[:n].to(dev)), full[:, :n])


def test_device_sha_and_delta_routes_on_the_card(dev, monkeypatch):
    """300 vote-shaped signatures with a bad lane through each route: the
    exact bitmap, and each route's kernels launched once a submit: the
    challenge through `sha512_reduce`, neither standalone kernel."""
    from cometbft_tpu_torch.crypto import ed25519 as E
    from cometbft_tpu_torch.crypto.testgen import generate_signed_batch

    monkeypatch.setattr(E, "_rlc_beats_ladder", lambda n, b, device: False)
    monkeypatch.setattr(E, "_delta_beats_prehashed", lambda n, b, device: True)
    items = generate_signed_batch(300, seed=6, msg_len=100, vote_shaped=True, device=dev)
    for path, kw in (("device_sha", {"device_sha": True}), ("delta", {})):
        bv = E.Ed25519BatchVerifier(device=dev, **kw)
        for i, (pub, msg, sig) in enumerate(items):
            bv.add(E.Ed25519PubKey(pub), msg, bytes([sig[0] ^ (i == 17)]) + sig[1:])
        before = dict(K.launches)
        pending = bv.submit()
        torch.cuda.synchronize()
        ran = {k: K.launches[k] - before[k] for k in K.launches}
        assert pending._path == path
        assert ran["sha512_reduce"] == ran["ladder_sub_mul8"] == 1, ran
        assert ran["sha512_blocks"] == ran["reduce512"] == 0, ran
        ok, bits = pending.result()
        assert not ok and [i for i, b in enumerate(bits) if not b] == [17]
