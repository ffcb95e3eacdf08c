"""The port's device-SHA verify path against the JAX package's, on the CPU.

`cometbft_tpu_torch.ops.ed25519_verify.verify_batch` (SHA-512, the
reduction mod L, `decompress` and the ladder through their plain
versions), `graft_entry.entry` and the verifier's device-SHA route
(`device_sha=True`) against `cometbft_tpu`'s `verify_batch_jit`,
`__graft_entry__._example_batch` and its verifier with `device_sha=True`,
and against the oracle; a lane over two SHA-512 blocks is verified on the
host. Inputs come from numpy with fixed seeds. The tolerance is exact:
bitmaps and all-ok must be equal bit for bit. Every batch has one shape
(B = 64), so the reference compiles its verify graph once, with XLA's
cheaper codegen settings (`fast_jit`; integer code, so the results are
the same).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import __graft_entry__ as JG  # noqa: E402
from cometbft_tpu.crypto import ed25519 as JE  # noqa: E402
from cometbft_tpu.ops import ed25519_verify as JV  # noqa: E402
from cometbft_tpu_torch import graft_entry  # noqa: E402
from cometbft_tpu_torch.crypto import ed25519 as E  # noqa: E402
from cometbft_tpu_torch.crypto import ed25519_ref as ref  # noqa: E402
from cometbft_tpu_torch.ops import ed25519_verify as V  # noqa: E402
from cometbft_tpu_torch.ops import sha512 as H  # noqa: E402
from test_torch_sha512 import fast_jit  # noqa: E402
from test_torch_verify import mixed_batch  # noqa: E402

B = 64


@pytest.fixture(scope="module")
def jax_verify_batch():
    return fast_jit(JV.verify_batch)


def pack_for_verify_batch(cases):
    """The device-SHA route's inputs at B lanes: encodings, the padded
    R||A||M words and flags, and the live mask."""
    n = len(cases)
    a = np.zeros((B, 32), np.uint8)
    r = np.zeros((B, 32), np.uint8)
    s = np.zeros((B, 32), np.uint8)
    for i, (pub, _, sig) in enumerate(cases):
        a[i] = np.frombuffer(pub, np.uint8)
        r[i] = np.frombuffer(sig[:32], np.uint8)
        s[i] = np.frombuffer(sig[32:], np.uint8)
    words = np.zeros((B, 64), np.uint32)
    two = np.zeros(B, bool)
    words[:n], two[:n] = H.pad_messages([sig[:32] + pub + msg for pub, msg, sig in cases])
    return a, r, s, words, two, np.arange(B) < n


def test_verify_batch_mixed_zip215_bitwise(jax_verify_batch):
    """Valid lanes, flipped bits, S >= L, sign-flipped A, torsion on A and
    on R, the identity key canonical and not: the same bitmap and all-ok
    as the reference's `verify_batch_jit`, and the oracle's verdicts."""
    cases = mixed_batch()
    a, r, s, words, two, live = pack_for_verify_batch(cases)
    jbits, jall = jax_verify_batch(a, r, s, words, two, live)
    bits, all_ok = V.verify_batch(*(torch.from_numpy(x) for x in (a, r, s)),
                                  torch.from_numpy(words.view(np.int32)), torch.from_numpy(two),
                                  torch.from_numpy(live))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))
    assert bool(all_ok) == bool(jall) is False
    assert bits[: len(cases)].tolist() == [ref.verify(*c) for c in cases]
    assert not bits[len(cases):].any()


def test_graft_entry_matches_reference(jax_verify_batch):
    """The port's entry at n = 8 against the reference's `_example_batch(8)`
    and its `verify_batch`, which runs the same lanes padded with dead
    ones to the file's one shape."""
    fn, args = graft_entry.entry(n=8, device="cpu")
    jargs = JG._example_batch(8)
    assert all(np.array_equal(t.numpy().view(j.dtype), j) for t, j in zip(args, jargs))
    bits = fn(*args)
    assert bits.shape == (8,) and bool(bits.all())
    padded = [np.concatenate([j, np.zeros((B - 8, *j.shape[1:]), j.dtype)]) for j in jargs]
    jbits, _ = jax_verify_batch(*padded)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits)[:8])


def test_device_sha_route_matches_reference_verifier(monkeypatch, jax_verify_batch):
    """`device_sha=True` on both verifiers (NATIVE_MAX = 0): the mixed
    batch plus a valid and a broken lane whose R||A||M exceeds two blocks
    (ragged lengths, so `pad_messages` packs the lanes; the oversize lanes
    go out dead and are verified on the host). Same bitmaps as the
    reference verifier and the oracle, path `device_sha`."""
    monkeypatch.setattr(E, "NATIVE_MAX", 0)
    monkeypatch.setattr(JE, "NATIVE_MAX", 0)
    monkeypatch.setattr(JV, "verify_batch_jit", jax_verify_batch)
    seed = bytes(range(32))
    big = bytes(np.random.default_rng(9).integers(0, 256, 200, dtype=np.uint8))
    good = (ref.pubkey_from_seed(seed), big, ref.sign(seed, big))
    cases = mixed_batch() + [good, (good[0], big[:-1] + b"!", good[2])]
    bv = E.Ed25519BatchVerifier(device="cpu", device_sha=True)
    jbv = JE.Ed25519BatchVerifier(backend="tpu", device_sha=True)
    for p, m, sg in cases:
        assert bv.add(E.Ed25519PubKey(p), m, sg) == jbv.add(JE.Ed25519PubKey(p), m, sg)
    pending, jpending = bv.submit(), jbv.submit()
    assert pending._path == jpending._path == "device_sha"
    assert pending._oversize_idx == jpending._oversize_idx == [26, 27]
    want = [ref.verify(*c) for c in cases]
    assert want[26] and not want[27]
    assert pending.result() == jpending.result() == (False, want)


def test_oversize_lane_with_s_at_least_l_rejected_unlike_the_reference(monkeypatch):
    """A lane over two SHA-512 blocks whose S >= L, under a small-order A
    (the identity key 01 00..00, a 200-byte message, S = L + 1): the port
    rejects it. `add()` zeroes such a signature; the reference's
    `PendingBatch._finalize_fast` then verifies the oversize lane as
    `ref.verify(pub, msg, zeros)`, which accepts: R = 0 has order 4 and
    S = 0, so [8](-R - [k]A) is the identity for a small-order A. That is a
    fault of the reference (ZIP-215 and its own `add()` reject S >= L),
    recorded here so this test says so if the reference changes."""
    monkeypatch.setattr(E, "NATIVE_MAX", 0)
    ident = bytes([1]) + bytes(31)
    msg = bytes(np.random.default_rng(10).integers(0, 256, 200, dtype=np.uint8))
    seed = bytes(range(32, 64))
    sig = ref.sign(seed, msg)[:32] + (ref.L + 1).to_bytes(32, "little")
    zeros = bytes(64)
    assert not ref.verify(ident, msg, sig)
    assert ref.verify(ident, msg, zeros)  # what the reference's host check runs

    pending = E.PendingBatch(torch.ones(1, dtype=torch.bool), torch.tensor(True), 1, [True],
                             [(ident, msg, zeros)], [0])
    assert pending.result() == (False, [False])
    jpending = JE.PendingBatch(np.array([True]), np.array(True), 1, [True],
                               [(ident, msg, zeros)], [0])
    assert jpending._finalize_fast(True) == (True, [True])  # the reference's fault

    short = b"a vote"
    bv = E.Ed25519BatchVerifier(device="cpu", device_sha=True)
    assert not bv.add(E.Ed25519PubKey(ident), msg, sig)
    assert bv.add(E.Ed25519PubKey(ref.pubkey_from_seed(seed)), short, ref.sign(seed, short))
    pending = bv.submit()
    assert pending._path == "device_sha" and pending._oversize_idx == [0]
    assert pending.result() == (False, [False, True])
