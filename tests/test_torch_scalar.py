"""The port's scalar handling mod L against the JAX package's: the byte
unpacking, the S < L check and the signed radix-16 recoding the verify
path uses. Exact: limbs and digits bitwise equal, values equal Python ints."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from cometbft_tpu.ops import scalar as JS  # noqa: E402
from cometbft_tpu_torch.ops import scalar as S  # noqa: E402

L = S.L_INT
rng = np.random.default_rng(99)


def scalars_bytes(vals):
    return np.stack([np.frombuffer(v.to_bytes(32, "little"), np.uint8) for v in vals])


EDGES = [0, 1, L - 1, L, L + 1, 2 * L, 2**252, 2**253 - 1, 2**255 - 1, 2**256 - 1]


def same(jax_out, torch_out):
    want = np.asarray(jax_out)
    got = torch_out.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_constants_match_reference():
    assert (S.L_INT, S.HALF_INT, S._K) == (JS.L_INT, JS.HALF_INT, JS._K)


@pytest.mark.parametrize("nbytes,nlimbs", [(32, 22), (64, 43), (8, 6)])
def test_bytes_to_limbs_bitwise(nbytes, nlimbs):
    raw = rng.integers(0, 256, (12, nbytes), dtype=np.uint8)
    raw[0] = 0xFF
    same(JS.bytes_to_limbs(jnp.asarray(raw), nlimbs), S.bytes_to_limbs(torch.from_numpy(raw), nlimbs))


def test_lt_l_bitwise_and_exact():
    vals = EDGES + [int.from_bytes(rng.bytes(32), "little") for _ in range(10)]
    raw = scalars_bytes(vals)
    got = S.lt_l(torch.from_numpy(raw))
    same(JS.lt_l(jnp.asarray(raw)), got)
    assert got.tolist() == [v < L for v in vals]


def test_recode_signed_and_digits_bitwise():
    vals = [v for v in EDGES if v < 2**255] + [
        int.from_bytes(rng.bytes(32), "little") % L for _ in range(10)]
    raw = scalars_bytes(vals)
    got = S.digits_from_bytes(torch.from_numpy(raw))
    same(JS.digits_from_bytes(jnp.asarray(raw)), got)
    d = got.numpy().astype(object)
    # the digits carry the value itself below 2^256 - HALF (higher values
    # wrap, and the verify path rejects them by lt_l)
    for j, v in enumerate(vals):
        if v < 2**256 - S.HALF_INT:
            assert sum(int(d[i, j]) * 16**i for i in range(64)) == v
    assert got.min() >= -8 and got.max() <= 7


def test_canon_and_sub_borrow_bitwise():
    x = rng.integers(0, 1 << 20, (22, 8)).astype(np.int32)
    for rounds in (0, 2):
        want, wc = JS._canon(jnp.asarray(x), rounds)
        got, gc = S._canon(torch.from_numpy(x), rounds)
        same(want, got)
        same(wc, gc)
    a = rng.integers(0, 4096, (22, 8)).astype(np.int32)
    b = rng.integers(0, 4096, (22, 8)).astype(np.int32)
    want, wb = JS._sub_borrow(jnp.asarray(a), jnp.asarray(b))
    got, gb = S._sub_borrow(torch.from_numpy(a), torch.from_numpy(b))
    same(want, got)
    same(wb, gb)
