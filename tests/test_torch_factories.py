"""The port's fixture factories against the JAX package's, byte for byte.

For the same seed the signers (scalars and public keys from the
fixed-base ladder), validator sets, block ids, signatures and commits are
identical to the reference's. The port runs on the CPU here (the plain
versions of the field kernels); the reference compiles its fixed-base
graph once, at the 64-lane bucket.
"""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from cometbft_tpu.state import types as RST  # noqa: E402
from cometbft_tpu.utils import factories as RF  # noqa: E402
from cometbft_tpu_torch.crypto import ed25519_ref as ref  # noqa: E402
from cometbft_tpu_torch.crypto import native  # noqa: E402
from cometbft_tpu_torch.types import validator_set as VS  # noqa: E402
from cometbft_tpu_torch.utils import factories as fx  # noqa: E402

CHAIN = "factory-chain"


@pytest.fixture(scope="module")
def both():
    return fx.make_signers(7, seed=3, device="cpu"), RF.make_signers(7, seed=3)


def test_signers_byte_identical(both):
    port, refs = both
    assert [(s.scalar, s.pub_bytes) for s in port] == [(s.scalar, s.pub_bytes) for s in refs]
    for s in port[:2]:  # [a]B from the device ladder equals the pure-Python oracle's
        assert s.pub_bytes == ref._encode_point(*ref._ext_to_affine(
            ref._ext_scalar_mul(s.scalar, ref.B_POINT)))
    assert port[0].address() == refs[0].address()


def test_validator_set_and_block_id_byte_identical(both):
    port, refs = both
    powers = [10, 3, 10, 7, 1, 10, 2]
    vals, r_vals = fx.make_validator_set(port, powers), RF.make_validator_set(refs, powers)
    assert VS.encode_validator_set(vals) == RST.encode_validator_set(r_vals)
    assert vals.hash() == r_vals.hash()
    assert fx.make_validator_set(port).hash() == RF.make_validator_set(refs).hash()
    assert fx.make_block_id(b"x").encode() == RF.make_block_id(b"x").encode()


def test_signatures_byte_identical(both):
    port, refs = both
    msgs = [b"m%d" % i * (i + 1) for i in range(len(port))]
    sigs = fx.batch_sign(port, msgs, seed=5, device="cpu")
    assert sigs == RF.batch_sign(refs, msgs, seed=5)
    assert all(native.verify(s.pub_bytes, m, g) for s, m, g in zip(port, msgs, sigs))
    assert fx.sign_with_scalar(port[1], b"vote") == RF.sign_with_scalar(refs[1], b"vote")


@pytest.mark.parametrize("absent, nil", [((), ()), ((1,), (2, 4))])
def test_commit_byte_identical(both, absent, nil):
    port, refs = both
    vals, r_vals = fx.make_validator_set(port), RF.make_validator_set(refs)
    bid = fx.make_block_id(b"blk")
    commit = fx.make_commit(CHAIN, 9, 1, bid, vals, {s.address(): s for s in port},
                            absent=set(absent), nil=set(nil), device="cpu")
    r_commit = RF.make_commit(CHAIN, 9, 1, RF.make_block_id(b"blk"), r_vals,
                              {s.address(): s for s in refs}, absent=set(absent), nil=set(nil))
    assert commit.encode() == r_commit.encode()
    assert commit.hash() == r_commit.hash()
    assert [commit.vote_sign_bytes(CHAIN, i) for i in range(7) if i not in absent] == \
        [r_commit.vote_sign_bytes(CHAIN, i) for i in range(7) if i not in absent]


def test_fixed_base_pads_to_the_verifier_bucket(monkeypatch):
    """The twin of `_fixed_base_fn` runs `ops/curve.py::fixed_base` once at
    the bucket (64 lanes for 3 scalars) and returns the n encodings."""
    from cometbft_tpu_torch.ops import curve as C

    seen = []
    real = C.fixed_base
    monkeypatch.setattr(C, "fixed_base", lambda digs: seen.append(digs.shape) or real(digs))
    out = fx._fixed_base_batch([1, 2, 3], device="cpu")
    assert seen == [(64, 64)] and out.shape == (3, 32)
    assert out[0].tobytes() == ref._encode_point(*ref._ext_to_affine(ref.B_POINT))
