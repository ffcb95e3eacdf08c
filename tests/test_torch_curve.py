"""The port's edwards25519 point code against the JAX package's.

Same points and digits (numpy, from a seed) through `cometbft_tpu.ops.curve`
on the CPU/XLA path and through `cometbft_tpu_torch.ops.curve` on CPU
tensors, where `decompress` and `ladder_sub_mul8` run the plain PyTorch
versions of their kernels. Exact: loose limbs bitwise equal, decoded
points equal to the pure-Python oracle.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from cometbft_tpu.crypto import ed25519_ref as jref  # noqa: E402
from cometbft_tpu.ops import curve as JC  # noqa: E402
from cometbft_tpu_torch.crypto import ed25519_ref as ref  # noqa: E402
from cometbft_tpu_torch.ops import curve as C  # noqa: E402
from cometbft_tpu_torch.ops import field as F  # noqa: E402

P = F.P_INT
rng = np.random.default_rng(77)


def torsion_point():
    for y in range(2, 50):
        aff = ref._decode_point(y.to_bytes(32, "little"), zip215=True)
        if aff is None:
            continue
        t = ref._ext_scalar_mul(ref.L, ref._to_ext(aff))
        if not ref._ext_is_identity(t):
            return t
    raise AssertionError("no torsion point found")


T8 = torsion_point()


def rand_points(n):
    """Random curve points, every third with an 8-torsion component."""
    pts = []
    for i in range(n):
        k = int.from_bytes(rng.bytes(32), "little") % ref.L
        p = ref._ext_scalar_mul(k or 1, ref.B_POINT)
        if i % 3 == 2:
            p = ref._ext_add(p, T8)
        pts.append(p)
    return pts


def pack(pts):
    """Python extended points -> tuple of four (22, n) numpy limb arrays,
    affine-normalized."""
    coords = []
    for pt in pts:
        x, y = ref._ext_to_affine(pt)
        coords.append((x, y, 1, (x * y) % P))
    return tuple(np.stack([F.from_int(c[i]) for c in coords], axis=1) for i in range(4))


def port(arrs):
    return C.from_reference_arrays(arrs, device="cpu")


def same(jax_out, torch_out):
    """Bitwise equality of a limb array (or a point: a tuple of them)."""
    if isinstance(torch_out, tuple):
        assert len(jax_out) == len(torch_out)
        for j, t in zip(jax_out, torch_out):
            if j is None:
                assert t is None
            else:
                same(j, t)
        return
    want = np.asarray(jax_out)
    got = torch_out.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def affine(pt):
    X, Y, Z = (F.freeze(c).numpy() for c in pt[:3])
    out = []
    for i in range(X.shape[1]):
        zi = pow(F.to_int(Z[:, i]), P - 2, P)
        out.append((F.to_int(X[:, i]) * zi % P, F.to_int(Y[:, i]) * zi % P))
    return out


def test_oracle_copy_matches_reference():
    assert (ref.P, ref.L, ref.D, ref.SQRT_M1) == (jref.P, jref.L, jref.D, jref.SQRT_M1)
    assert ref.B_POINT == jref.B_POINT
    seed = bytes(range(32))
    assert ref.pubkey_from_seed(seed) == jref.pubkey_from_seed(seed)
    assert ref.sign(seed, b"m") == jref.sign(seed, b"m")


def test_base_niels_equals_reference():
    np.testing.assert_array_equal(C.BASE_NIELS.numpy(), np.asarray(JC.BASE_NIELS))
    assert C.BASE_NIELS.dtype == torch.int32
    np.testing.assert_array_equal(C.base_niels(torch.device("cpu")).numpy(),
                                  np.asarray(JC.BASE_NIELS))


def test_from_reference_arrays():
    limbs = F.from_int(12345, 3)
    mask = np.array([True, False, True])
    t = C.from_reference_arrays(limbs, device="cpu")
    assert t.dtype == torch.int32 and t.device.type == "cpu"
    np.testing.assert_array_equal(t.numpy(), limbs)
    pt = C.from_reference_arrays((limbs, limbs.astype(np.int64)), device="cpu")
    assert isinstance(pt, tuple) and all(c.dtype == torch.int32 for c in pt)
    m = C.from_reference_arrays(mask, device="cpu")
    assert m.dtype == torch.bool and m.tolist() == mask.tolist()
    d = C.from_reference_arrays(JC.scalar_digits([5, 7]), device="cpu")
    assert d.shape == (64, 2) and d.dtype == torch.int32


def test_scalar_digits_equal_reference():
    ss = [0, 1, 7, ref.L - 1, 2**253 - 1] + [
        int.from_bytes(rng.bytes(32), "little") % ref.L for _ in range(4)
    ]
    np.testing.assert_array_equal(C.scalar_digits(ss), JC.scalar_digits(ss))


@pytest.mark.parametrize("op", ["add", "dbl", "dbl_no_t", "to_niels", "neg", "mul8"])
def test_point_ops_bitwise(op):
    p, q = pack(rand_points(8)), pack(rand_points(8))
    jfn = {"add": JC.add, "dbl": JC.dbl, "dbl_no_t": JC.dbl_no_t, "to_niels": JC.to_niels,
           "neg": JC.neg, "mul8": JC.mul8}[op]
    tfn = {"add": C.add, "dbl": C.dbl, "dbl_no_t": C.dbl_no_t, "to_niels": C.to_niels,
           "neg": C.neg, "mul8": C.mul8}[op]
    if op == "add":
        same(jax.jit(jfn)(p, q), tfn(port(p), port(q)))
    else:
        same(jax.jit(jfn)(p), tfn(port(p)))


def test_niels_additions_bitwise():
    p, q = pack(rand_points(8)), pack(rand_points(8))
    nq = JC.to_niels(q)
    same(jax.jit(JC.add_niels)(p, nq), C.add_niels(port(p), port(tuple(np.asarray(c) for c in nq))))
    base = tuple(np.broadcast_to(np.asarray(JC.BASE_NIELS)[5, c][:, None], (F.NLIMBS, 8))
                 for c in range(3))
    same(jax.jit(JC.madd)(p, base), C.madd(port(p), port(base)))


def test_identity_eq_and_completeness():
    pts = rand_points(6)
    p = port(pack(pts))
    s = C.add(p, C.neg(p))
    assert C.is_identity(s).all()
    ident = C.identity(6, "cpu")
    assert affine(C.add(p, ident)) == [ref._ext_to_affine(x) for x in pts]
    assert affine(C.dbl(p)) == [ref._ext_to_affine(ref._ext_add(x, x)) for x in pts]
    same(JC.eq_points(pack(pts), pack(pts[::-1])), C.eq_points(p, port(pack(pts[::-1]))))
    same(JC.is_identity(JC.identity(6)), C.is_identity(ident))


def test_lane_table_bitwise():
    p = pack(rand_points(4))
    same(jax.jit(JC.lane_table)(p), C.lane_table(port(p)))


def zip215_cases():
    def with_sign(y: int) -> bytes:
        b = bytearray(y.to_bytes(32, "little"))
        b[31] |= 0x80
        return bytes(b)

    cases = [
        ref._encode_point(0, 1),  # canonical identity
        (1 + P).to_bytes(32, "little"),  # non-canonical y = 1 + p
        with_sign(1),  # x = 0 with the sign bit set
        (0).to_bytes(32, "little"),  # y = 0: order-4 point
        P.to_bytes(32, "little"),  # non-canonical y = p
        with_sign(P),  # non-canonical y = p with the sign bit
        (P + 18).to_bytes(32, "little"),  # largest non-canonical y = p + 18
    ]
    cases += [y.to_bytes(32, "little") for y in range(2, 6)]  # some have no root
    cases += [ref._encode_point(*ref._ext_to_affine(ref._ext_scalar_mul(k, T8)))
              for k in range(1, 4)]  # torsion points
    return np.stack([np.frombuffer(e, np.uint8) for e in cases])


def test_decompress_zip215_bitwise_and_oracle():
    encs = zip215_cases()
    jvalid, jpt = jax.jit(JC.decompress)(jnp.asarray(encs))
    valid, pt = C.decompress(torch.from_numpy(encs))
    same(jvalid, valid)
    same(jpt, pt)
    want = [ref._decode_point(e.tobytes(), zip215=True) for e in encs]
    assert valid.tolist() == [w is not None for w in want]
    got = affine(pt)
    for i, w in enumerate(want):
        if w is not None:
            assert got[i] == w, i


def test_decompress_plain_is_the_dispatch_on_cpu():
    encs = zip215_cases()
    sign, y = C._split_encoding(torch.from_numpy(encs))
    v, x, t = C.decompress_plain(y, sign)
    valid, pt = C.decompress(torch.from_numpy(encs))
    assert torch.equal(v, valid) and torch.equal(x, pt[0]) and torch.equal(t, pt[3])


def test_compress_roundtrip_bitwise():
    pts = rand_points(8)
    p = pack(pts)
    enc = C.compress(port(p))
    same(jax.jit(JC.compress)(p), enc)
    assert [bytes(e) for e in enc.numpy()] == [
        ref._encode_point(*ref._ext_to_affine(x)) for x in pts]


def test_ladder_sub_mul8_bitwise():
    n = 4
    a, r = pack(rand_points(n)), pack(rand_points(n))
    ss = [int.from_bytes(rng.bytes(32), "little") % ref.L for _ in range(n)]
    ks = [0, 1] + [int.from_bytes(rng.bytes(32), "little") % ref.L for _ in range(n - 2)]
    sd, kd = C.scalar_digits(ss), C.scalar_digits(ks)
    # off the TPU the reference's ladder_sub_mul8 is exactly this chain;
    # jit(JC.ladder) at 4 lanes is the graph tests/test_curve.py compiles
    lad = jax.jit(JC.ladder)(jnp.asarray(sd), jnp.asarray(kd), a)
    want = jax.jit(lambda p, q: JC.mul8(JC.add(p, JC.neg(q)))[:3])(lad, r)
    got = C.ladder_sub_mul8(port(sd), port(kd), port(a), port(r))
    same(tuple(want), got)
    plain = C.ladder_sub_mul8_plain(port(sd), port(kd), port(a), port(r))
    assert all(torch.equal(g, h) for g, h in zip(got, plain))


def test_ladder_matches_oracle():
    n = 4
    pts = rand_points(n)
    ss = [int.from_bytes(rng.bytes(32), "little") % ref.L for _ in range(n)]
    ks = [int.from_bytes(rng.bytes(32), "little") % ref.L for _ in range(n)]
    r = C.ladder(port(C.scalar_digits(ss)), port(C.scalar_digits(ks)), port(pack(pts)))
    assert affine(r) == [
        ref._ext_to_affine(ref._ext_add(ref._ext_scalar_mul(s, ref.B_POINT),
                                        ref._ext_scalar_mul(k, p)))
        for s, k, p in zip(ss, ks, pts)]


def test_fixed_base_compress_bitwise():
    ss = [1, 7, ref.L - 1, int.from_bytes(rng.bytes(32), "little") % ref.L, 2]
    sd = C.scalar_digits(ss)
    jr = jax.jit(JC.fixed_base)(jnp.asarray(sd))
    r = C.fixed_base(port(sd))
    same(jr, r)
    assert [bytes(e) for e in C.compress(r).numpy()] == [
        ref._encode_point(*ref._ext_to_affine(ref._ext_scalar_mul(s, ref.B_POINT)))
        for s in ss]
