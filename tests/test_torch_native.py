"""The port's native host engine (`cometbft_tpu_torch/crypto/native.py`,
`csrc/host/`) against the pure-Python oracle, the port's Python packers
and the JAX package's native engine, on the CPU.

- `verify` and `batch_verify` agree with the port's `ed25519_ref.verify`
  on random signatures and on the ZIP-215 edge encodings of
  `tests/test_curve.py:112` as A and as R.
- `pack_rsk` rows are byte-identical to the reference's `native.pack_rsk`
  and to the port's hashlib loop, with message lengths that run both the
  8-wide and the one-at-a-time hashing.
- `rlc.prepare` (the native packer) is byte-identical to the port's
  `prepare_numpy` and to the reference's `prepare` and `prepare_numpy` for
  the same z coefficients: every bucket, skip masks, edge scalars, and
  both declines (-1 a window's lanes overflow, -2 no live lane).

Skips with a stated reason where the host has no g++.
"""

import hashlib
import shutil

import numpy as np
import pytest

pytest.importorskip("torch")

from cometbft_tpu.crypto import native as JN  # noqa: E402
from cometbft_tpu.crypto import rlc as JR  # noqa: E402
from cometbft_tpu_torch.crypto import ed25519 as E  # noqa: E402
from cometbft_tpu_torch.crypto import ed25519_ref as ref  # noqa: E402
from cometbft_tpu_torch.crypto import native, rlc  # noqa: E402


@pytest.fixture(autouse=True)
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the native host library")


rng = np.random.default_rng(6)
L = ref.L
P = ref.P
PREP_KEYS = ("stream", "stream_neg", "counts", "weights", "c_digits")


def signed(n, msg_len=None):
    out = []
    for _ in range(n):
        seed = bytes(rng.bytes(32))
        msg = bytes(rng.bytes(int(rng.integers(0, 300)) if msg_len is None else msg_len))
        out.append((ref.pubkey_from_seed(seed), msg, ref.sign(seed, msg)))
    return out


def random_items(n, msg_len=None):
    return [(rng.bytes(32), rng.bytes(int(rng.integers(0, 180)) if msg_len is None else msg_len),
             rng.bytes(64)) for _ in range(n)]


def z16_of(n):
    return rng.integers(0, 256, (n, 16), dtype=np.uint8)


def blobs_of(items):
    return (b"".join(it[0] for it in items), b"".join(it[2] for it in items),
            b"".join(it[1] for it in items), np.array([len(it[1]) for it in items], np.uint64))


def assert_same_prep(got, want, ctx):
    assert (got is None) == (want is None), ctx
    if got is None:
        return
    assert got["s_rounds"] == want["s_rounds"], ctx
    for k in PREP_KEYS:
        assert got[k].dtype == want[k].dtype, (ctx, k)
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{ctx} {k}")


def all_packers(items, skip, bucket, z16):
    """The port's native and numpy packers and the reference's two, for the
    same inputs; all four must agree."""
    got = rlc.prepare(items, skip, bucket, z16)
    for name, want in (("port numpy", rlc.prepare_numpy(items, skip, bucket, z16)),
                       ("reference", JR.prepare(items, skip, bucket, z16)),
                       ("reference numpy", JR.prepare_numpy(items, skip, bucket, z16))):
        assert_same_prep(got, want, (name, len(items), bucket))
    return got


def with_sign(y: int) -> bytes:
    b = bytearray(y.to_bytes(32, "little"))
    b[31] |= 0x80
    return bytes(b)


# the encodings of tests/test_curve.py:112 (canonical and non-canonical
# identity, negative zero, the order-4 point y = 0 and its non-canonical
# forms, y without a square root, small valid y)
ZIP215_ENCODINGS = [ref._encode_point(0, 1), (1 + P).to_bytes(32, "little"), with_sign(1),
                    (0).to_bytes(32, "little"), P.to_bytes(32, "little"), with_sign(P)]
ZIP215_ENCODINGS += [y.to_bytes(32, "little") for y in range(2, 6)]


# ---------------------------------------------------------------- the library


def test_library_builds_and_names_its_engine():
    assert native.available(), native.build_log
    assert native.engine() in ("avx512-ifma", "portable")
    assert native.rlc_available()
    assert 1 <= native.rlc_packer_threads() <= 8
    d = native.build_dir()
    assert d.parent == native.BUILD_ROOT and d.name.startswith("host-")
    assert (d / native.LIB_NAME).is_file()
    assert {p.name for p in native._sources()} == {
        "ed25519_native.cpp", "ed25519_ifma.inc", "sha512_mb.inc", "rlc_packer.inc",
        "merkle_native.inc", "commit_codec.inc"}


def test_without_gxx_the_library_is_absent(monkeypatch, tmp_path):
    """No g++: nothing is built, the entry points say so, and the callers'
    Python paths take over."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path / "bin"))
    assert not native.available()
    assert native.build_log == "g++ not found on PATH"
    assert native.engine() == "unavailable" and native.rlc_packer_threads() == 1
    assert not native.pack_rsk(0, b"", b"", b"", np.zeros(0, np.uint64),
                               np.zeros((0, 96), np.uint8))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.verify(b"\0" * 32, b"", b"\0" * 64)
    (pub, msg, sig), = signed(1)
    assert E.Ed25519PubKey(pub).verify_signature(msg, sig)  # ed25519_ref
    assert not list((tmp_path / "build").rglob("*.so"))


# ---------------------------------------------------------------- verify


def test_verify_matches_oracle_on_random_signatures():
    for pub, msg, sig in signed(12):
        assert native.verify(pub, msg, sig)
        assert not native.verify(pub, msg + b"x", sig)
        bad = bytearray(sig)
        bad[int(rng.integers(0, 64))] ^= 1 + int(rng.integers(0, 255))
        assert native.verify(pub, msg, bytes(bad)) == ref.verify(pub, msg, bytes(bad))


@pytest.mark.parametrize("enc", ZIP215_ENCODINGS, ids=range(len(ZIP215_ENCODINGS)))
def test_verify_and_batch_verify_zip215_edges(enc):
    """Each edge encoding as A (with a zero and a random signature) and as
    R (beside a valid key): single and one-item batch verdicts equal the
    oracle's."""
    (pub, msg, sig), = signed(1, msg_len=40)
    s = rng.integers(0, 256, 32, dtype=np.uint8)
    s[31] &= 0x0F
    cases = [(enc, msg, bytes(64)), (enc, msg, enc + bytes(s)), (pub, msg, enc + sig[32:]),
             (enc, msg, enc + bytes(32))]
    for case in cases:
        want = ref.verify(*case)
        assert native.verify(*case) == want, case
        assert native.batch_verify([case]) == want, case


def test_verify_rejects_s_at_or_above_l():
    (pub, msg, sig), = signed(1)
    for s in (L, L + 1, 2**256 - 1):
        assert not native.verify(pub, msg, sig[:32] + s.to_bytes(32, "little"))


def test_batch_verify_accepts_valid_and_rejects_one_bad_lane():
    items = signed(40, msg_len=100)
    assert native.batch_verify(items)
    p, m, s = items[7]
    items[7] = (p, m, bytes([s[0] ^ 1]) + s[1:])
    assert not native.batch_verify(items)
    assert not native.batch_verify([])


# ---------------------------------------------------------------- pack_rsk


def hashlib_rows(items):
    rows = np.zeros((len(items), 96), np.uint8)
    for i, (pub, msg, sig) in enumerate(items):
        k = int.from_bytes(hashlib.sha512(sig[:32] + pub + msg).digest(), "little") % L
        rows[i] = np.frombuffer(sig + k.to_bytes(32, "little"), np.uint8)
    return rows


@pytest.mark.parametrize("lengths", ["uniform", "mixed"])
def test_pack_rsk_matches_reference_and_hashlib(lengths, monkeypatch):
    """Uniform lengths fill groups of eight (the multi-buffer hash on an
    AVX-512 host); mixed lengths break them, so runs of eight and single
    lanes alternate. 0- and 300-byte messages take 1 and 3 SHA-512 blocks."""
    if lengths == "uniform":
        items = random_items(37, msg_len=100)
    else:
        lens = [100] * 8 + [0, 300, 7] + [111] * 9 + [128 - 64 - 17, 128 - 64 - 16] + [
            int(x) for x in rng.integers(0, 300, 21)]
        items = [(rng.bytes(32), rng.bytes(ln), rng.bytes(64)) for ln in lens]
    n = len(items)
    pub, sig, msg, lens = blobs_of(items)
    got = np.full((n + 3, 96), 0xAB, np.uint8)  # rows past n stay as they were
    assert native.pack_rsk(n, sig, pub, msg, lens, got)
    want_ref = np.zeros((n, 96), np.uint8)
    assert JN.pack_rsk(n, sig, pub, msg, lens, want_ref)
    np.testing.assert_array_equal(got[:n], want_ref)
    np.testing.assert_array_equal(got[:n], hashlib_rows(items))
    assert (got[n:] == 0xAB).all()
    # the verifier's Python path (library absent) gives the same rows
    monkeypatch.setattr(native, "pack_rsk", lambda *args: False)
    py = np.zeros((n, 96), np.uint8)
    E._pack_rsk_rows(n, bytearray(sig), bytearray(pub), bytearray(msg), lens, py)
    np.testing.assert_array_equal(py, got[:n])


def test_pack_rsk_refuses_wrong_buffers():
    items = random_items(4, msg_len=10)
    pub, sig, msg, lens = blobs_of(items)
    with pytest.raises(ValueError, match="uint64"):
        native.pack_rsk(4, sig, pub, msg, lens.astype(np.int64), np.zeros((4, 96), np.uint8))
    with pytest.raises(ValueError, match="out_rsk"):
        native.pack_rsk(4, sig, pub, msg, lens, np.zeros((3, 96), np.uint8))
    with pytest.raises(ValueError, match="out_rsk"):
        native.pack_rsk(4, sig, pub, msg, lens, np.zeros((4, 96), np.uint8)[:, ::-1])
    with pytest.raises(ValueError, match="sig_blob"):
        native.pack_rsk(4, sig[:-1], pub, msg, lens, np.zeros((4, 96), np.uint8))


def test_verifier_packs_rows_natively():
    items = signed(9, msg_len=100)
    bv = E.Ed25519BatchVerifier(device="cpu")
    for pub, msg, sig in items:
        bv.add(E.Ed25519PubKey(pub), msg, sig)
    rsk = bv._pack_rsk(9, 64)
    assert rsk.shape == (64, 96)
    np.testing.assert_array_equal(rsk.numpy()[:9], hashlib_rows(items))
    assert not rsk.numpy()[9:].any()


# ---------------------------------------------------------------- rlc_pack


@pytest.mark.parametrize("bucket", E.BUCKETS)
def test_prepare_every_bucket(bucket):
    """uint16 stream entries up to bucket 16,383, uint32 above."""
    n = min(bucket, 96)
    prep = all_packers(random_items(n), np.zeros(n, bool), bucket, z16_of(n))
    assert prep["stream"].dtype == (np.uint32 if 2 * bucket > 0x7FFF else np.uint16)


@pytest.mark.parametrize("mask", ["none", "random", "alternating", "all"])
def test_prepare_skip_masks(mask):
    n = 64
    skip = {"none": np.zeros(n, bool), "random": rng.integers(0, 2, n).astype(bool),
            "alternating": np.arange(n) % 2 == 0, "all": np.ones(n, bool)}[mask]
    prep = all_packers(random_items(n), skip, 256, z16_of(n))
    assert (prep is None) == (mask == "all")


def test_prepare_edge_scalars():
    """s = 0, L - 1, L, 2^256 - 1 and L + 12345; z all zero (forced to 1)
    and all ones."""
    edge_s = [0, L - 1, L, 2**256 - 1, L + 12345]
    items = [(rng.bytes(32), rng.bytes(50), rng.bytes(32) + s.to_bytes(32, "little"))
             for s in edge_s] + random_items(11)
    z16 = z16_of(len(items))
    z16[0] = 0
    z16[1] = 0xFF
    all_packers(items, np.zeros(len(items), bool), 64, z16)


def test_prepare_commit_sized_batch():
    """A 10,000-signature-shaped batch at bucket 10,240 (500 lanes, uniform
    vote-sized messages) and a random batch at 4,096."""
    all_packers(random_items(500, msg_len=100), np.zeros(500, bool), 10_240, z16_of(500))
    n = 300
    all_packers(random_items(n), rng.integers(0, 4, n) == 0, 4096, z16_of(n))


def overflowing_batch():
    """524 lanes at bucket 1,024 (slot depth 12) whose z puts window 1's
    digits on 511 magnitudes once and one magnitude 13 times: 513 lanes of
    one region, over its 512."""
    depth = rlc.slot_depth(1024)
    assert depth == 12
    digits = list(range(1, 512)) + [512] * (depth + 1)
    n = len(digits)
    z16 = np.zeros((n, 16), np.uint8)
    for i, d in enumerate(digits):
        z16[i] = np.frombuffer((1 | d << 10).to_bytes(16, "little"), np.uint8)
    return random_items(n, msg_len=20), z16


def rlc_pack_code(items, skip, bucket, z16):
    n = len(items)
    pub, sig, msg, lens = blobs_of(items)
    stream = np.zeros(rlc.N_REGIONS * n + 8, np.uint16)
    neg = np.zeros(rlc.N_REGIONS * n + 8, np.uint8)
    return native.rlc_pack(
        n, bucket, rlc.slot_depth(bucket), pub, sig, msg, lens, skip.astype(np.uint8),
        z16, 2, stream, neg, np.zeros(rlc.WK, np.uint8),
        np.zeros((rlc.N_REGIONS, rlc.K_BUCKETS), np.int32), np.zeros(32, np.uint8))


def test_prepare_declines_on_lane_overflow():
    items, z16 = overflowing_batch()
    skip = np.zeros(len(items), bool)
    assert rlc_pack_code(items, skip, 1024, z16)[0] == -1
    assert all_packers(items, skip, 1024, z16) is None
    # one fewer of the repeated magnitude fits
    assert all_packers(items[:-1], skip[:-1], 1024, z16[:-1]) is not None


def test_prepare_declines_without_a_live_lane():
    items = random_items(5)
    skip = np.ones(5, bool)
    assert rlc_pack_code(items, skip, 64, z16_of(5))[0] == -2
    assert all_packers(items, skip, 64, z16_of(5)) is None
    assert rlc.prepare([], np.zeros(0, bool), 64) is None


def test_prepare_blobs_match_items_and_numpy_without_the_library(monkeypatch):
    n = 80
    items, z16, skip = random_items(n), z16_of(n), np.zeros(n, bool)
    skip[3] = True
    want = rlc.prepare(items, skip, 256, z16)
    assert_same_prep(rlc.prepare(None, skip, 256, z16, blobs=blobs_of(items)), want, "blobs")
    monkeypatch.setattr(native, "rlc_available", lambda: False)
    assert_same_prep(rlc.prepare(None, skip, 256, z16, blobs=blobs_of(items)), want,
                     "numpy from blobs")


def test_rlc_pack_is_chunk_count_invariant():
    n, bucket = 200, 1024
    items, z16 = random_items(n), z16_of(n)
    skip = (np.arange(n) % 9 == 0).astype(np.uint8)
    pub, sig, msg, lens = blobs_of(items)
    outs = []
    for nchunks in (1, 2, 3, 7):
        bufs = (np.zeros(rlc.N_REGIONS * n, np.uint16), np.zeros(rlc.N_REGIONS * n, np.uint8),
                np.zeros(rlc.WK, np.uint8), np.zeros((rlc.N_REGIONS, rlc.K_BUCKETS), np.int32),
                np.zeros(32, np.uint8))
        res = native.rlc_pack(n, bucket, rlc.slot_depth(bucket), pub, sig, msg, lens, skip,
                              z16, 2, *bufs, nchunks=nchunks)
        assert res[0] > 0
        outs.append((res, *(b.tobytes() for b in bufs)))
    assert all(o == outs[0] for o in outs[1:])


def test_rlc_pack_refuses_wrong_buffers():
    items = random_items(4)
    pub, sig, msg, lens = blobs_of(items)
    args = (4, 64, rlc.slot_depth(64), pub, sig, msg, lens, np.zeros(4, np.uint8), z16_of(4))
    outs = [np.zeros(rlc.N_REGIONS * 4, np.uint16), np.zeros(rlc.N_REGIONS * 4, np.uint8),
            np.zeros(rlc.WK, np.uint8), np.zeros((rlc.N_REGIONS, rlc.K_BUCKETS), np.int32),
            np.zeros(32, np.uint8)]
    with pytest.raises(ValueError, match="2-byte entries, not 4"):
        native.rlc_pack(*args, 4, *outs)
    with pytest.raises(ValueError, match="out_weights"):
        native.rlc_pack(*args, 2, *outs[:3], outs[3].astype(np.int64), outs[4])
    with pytest.raises(ValueError, match="z16"):
        native.rlc_pack(*args[:8], z16_of(3), 2, *outs)
