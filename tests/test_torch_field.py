"""The port's GF(2^255 - 19) limb arithmetic against the JAX package's.

Same inputs (numpy, from a seed) through `cometbft_tpu.ops.field` on the
CPU/XLA path and through `cometbft_tpu_torch.ops.field` on CPU tensors,
which run the plain PyTorch versions of the field kernels. Integer
arithmetic, so the tolerance is exact: loose limbs are bitwise equal, and
canonical values equal Python ints.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from cometbft_tpu.ops import field as JF  # noqa: E402
from cometbft_tpu_torch.ops import field as F  # noqa: E402

P = F.P_INT
rng = np.random.default_rng(1234)
N = 48

j_add = jax.jit(JF.add)
j_sub = jax.jit(JF.sub)
j_neg = jax.jit(JF.neg)
j_carry = jax.jit(JF.carry)
j_mul = jax.jit(JF.mul)
j_sq = jax.jit(JF.sq)
j_freeze = jax.jit(JF.freeze)
j_pow2523 = jax.jit(JF.pow2523)
j_invert = jax.jit(JF.invert)


def loose(n=N):
    """(22, n) int32 limbs over the loose invariant, the first lanes at its
    edges: zero, every limb at its maximum, p, limb 0 at its maximum over
    canonical limbs, and all-ones canonical limbs."""
    a = np.empty((F.NLIMBS, n), np.int32)
    a[0] = rng.integers(0, 13824, n)
    a[1:] = rng.integers(0, 4300, (F.NLIMBS - 1, n))
    a[:, 0] = 0
    a[0, 1], a[1:, 1] = 13823, 4299
    a[:, 2] = F.P_LIMBS
    a[0, 3], a[1:, 3] = 13823, 4095
    a[:, 4] = 4095
    a[:, 5] = F.from_int(1)
    return a


def ints(arr):
    return [F.to_int(arr[:, i]) for i in range(arr.shape[1])]


def same(jax_out, torch_out):
    """Bitwise equality (loose limbs, masks, bytes): same dtype, shape and
    values."""
    want = np.asarray(jax_out)
    got = torch_out.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_constants_match_reference():
    np.testing.assert_array_equal(F.P_LIMBS, JF.P_LIMBS)
    assert (F.NLIMBS, F.BITS, F.FOLD, F.P_INT) == (JF.NLIMBS, JF.BITS, JF.FOLD, JF.P_INT)
    for v in (0, 1, 19, P - 1, P + 5, 2**255 - 1):
        np.testing.assert_array_equal(F.from_int(v), JF.from_int(v))
        np.testing.assert_array_equal(F.from_int(v, 3), JF.from_int(v, 3))


@pytest.mark.parametrize("op", ["add", "sub", "neg"])
def test_linear_ops_bitwise(op):
    a, b = loose(), loose()
    if op == "add":
        same(j_add(a, b), F.add(T(a), T(b)))
    elif op == "sub":
        same(j_sub(a, b), F.sub(T(a), T(b)))
        same(j_sub(b, a), F.sub(T(b), T(a)))
    else:
        same(j_neg(a), F.neg(T(a)))


@pytest.mark.parametrize("hi", [1 << 23, 1 << 28])
def test_carry_bitwise(hi):
    x = rng.integers(-hi, hi, (F.NLIMBS, N)).astype(np.int32)
    x[:, 0] = hi - 1
    x[:, 1] = -hi
    same(j_carry(x), F.carry(T(x)))


def test_mul_sq_bitwise_and_exact():
    a, b = loose(), loose()
    got = F.mul(T(a), T(b))
    same(j_mul(a, b), got)
    same(j_mul(a, b), F.mul_plain(T(a), T(b)))
    same(j_sq(a), F.sq(T(a)))
    same(j_sq(a), F.sq_plain(T(a)))
    prods = ints(F.freeze(got).numpy())
    assert prods == [(x * y) % P for x, y in zip(ints(a), ints(b))]


def test_mul_broadcasts_a_constant():
    a = loose()
    c = JF.from_int(121665)[:, None]
    same(j_mul(a, c), F.mul(T(a), T(c)))


@pytest.mark.parametrize("c", [0, 1, 2, 19, 8191])
def test_mul_small_bitwise(c):
    a = loose()
    same(jax.jit(lambda x: JF.mul_small(x, c))(a), F.mul_small(T(a), c))


def test_mul_small_rejects_large_constant():
    with pytest.raises(ValueError):
        F.mul_small(T(loose()), 1 << 13)


def test_freeze_eq_iszero_parity_select():
    a, b = loose(), loose()
    b[:, :6] = a[:, :6]
    fz = F.freeze(T(a))
    same(j_freeze(a), fz)
    assert ints(fz.numpy()) == [v % P for v in ints(a)]
    same(JF.eq(a, b), F.eq(T(a), T(b)))
    same(JF.is_zero(a), F.is_zero(T(a)))
    same(JF.parity(a), F.parity(T(a)))
    cond = rng.integers(0, 2, N).astype(bool)
    same(JF.select(cond, a, b), F.select(T(cond), T(a), T(b)))


def test_pow2523_invert_bitwise_and_exact():
    a = loose(16)
    pw = F.pow2523(T(a))
    same(j_pow2523(a), pw)
    inv = F.invert(T(a))
    same(j_invert(a), inv)
    assert ints(F.freeze(pw).numpy()) == [pow(v % P, (P - 5) // 8, P) for v in ints(a)]
    assert ints(F.freeze(inv).numpy()) == [pow(v % P, P - 2, P) for v in ints(a)]


def test_sqn_matches_repeated_squaring():
    a = loose(8)
    same(jax.jit(lambda x: JF.sqn(x, 5))(a), F.sqn(T(a), 5))


def test_byte_codecs_bitwise():
    raw = rng.integers(0, 256, (N, 32), dtype=np.uint8)
    raw[0] = 0xFF
    raw[1] = 0
    raw[2] = np.frombuffer(P.to_bytes(32, "little"), np.uint8)
    limbs = F.from_bytes_le(T(raw))
    same(JF.from_bytes_le(jnp.asarray(raw)), limbs)
    assert ints(limbs.numpy()) == [int.from_bytes(r.tobytes(), "little") for r in raw]
    a = loose()
    enc = F.to_bytes_le(T(a))
    same(jax.jit(JF.to_bytes_le)(a), enc)
    assert enc.dtype == torch.uint8
    assert [int.from_bytes(r.tobytes(), "little") for r in enc.numpy()] == [
        v % P for v in ints(a)
    ]


def test_cpu_tensors_take_the_plain_version_without_building():
    from cometbft_tpu_torch.ops import kernels as K

    before = dict(K.launches)
    a = T(loose(8))
    F.mul(a, a)
    F.sq(a)
    assert K.launches == before


def test_other_devices_raise():
    a = torch.zeros((F.NLIMBS, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        F.mul(a, a)
    with pytest.raises(ValueError, match="unsupported device"):
        F.sq(a)
