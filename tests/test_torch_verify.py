"""The port's commit-verify path against the JAX package's, on the CPU.

`cometbft_tpu_torch`'s `ops.ed25519_verify` and `Ed25519BatchVerifier
(device="cpu")` (the plain PyTorch versions of the kernels) against
`cometbft_tpu`'s device functions and its `Ed25519BatchVerifier(backend=
"tpu", force_perlane=True)` on the CPU/XLA path: identical verdict bitmaps
on mixed-validity, ZIP-215 torsion and non-canonical, S >= L and commit
batches. Every batch stays inside the 64-lane bucket.
"""

import hashlib

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from cometbft_tpu.crypto import ed25519 as JE  # noqa: E402
from cometbft_tpu.crypto import testgen as JT  # noqa: E402
from cometbft_tpu.ops import ed25519_verify as JV  # noqa: E402
from cometbft_tpu_torch.crypto import ed25519 as E  # noqa: E402
from cometbft_tpu_torch.crypto import ed25519_ref as ref  # noqa: E402
from cometbft_tpu_torch.crypto.batch import create_batch_verifier  # noqa: E402
from cometbft_tpu_torch.crypto.testgen import generate_signed_batch  # noqa: E402
from cometbft_tpu_torch.ops import ed25519_verify as V  # noqa: E402

rng = np.random.default_rng(2024)


@pytest.fixture(autouse=True)
def device_routes(monkeypatch):
    """NATIVE_MAX = 0: every batch here is smaller than NATIVE_MAX and
    would go to the native C++ engine; these tests hold the device
    routes."""
    monkeypatch.setattr(E, "NATIVE_MAX", 0)


def signed(n, msg_len=100):
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
    for i, (pub, msg, sig) in enumerate(signed(4)):
        cases.append((pub, msg, sig))
        cases.append((pub, msg, bytes([sig[0] ^ 1]) + sig[1:]))
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


def verdicts_both(cases):
    jbv = JE.Ed25519BatchVerifier(backend="tpu", force_perlane=True)
    bv = E.Ed25519BatchVerifier(device="cpu")
    jadded = [jbv.add(JE.Ed25519PubKey(p), m, s) for p, m, s in cases]
    added = [bv.add(E.Ed25519PubKey(p), m, s) for p, m, s in cases]
    assert added == jadded
    return jbv.verify(), bv.verify()


def test_mixed_zip215_batch_matches_reference_and_oracle():
    cases = mixed_batch()
    (jok, jbits), (ok, bits) = verdicts_both(cases)
    want = [ref.verify(p, m, s) for p, m, s in cases]
    assert bits == jbits == want
    assert ok == jok is False
    # the torsion and identity-key lanes are the interesting, valid ones
    assert want[2] and want[3] and want[-1] and want[-2]


def test_all_valid_batch():
    (jok, jbits), (ok, bits) = verdicts_both(signed(20))
    assert ok and jok and bits == jbits == [True] * 20


def test_prehashed_and_cached_a_bitwise():
    cases = mixed_batch()
    n, b = len(cases), 64
    a = np.zeros((b, 32), np.uint8)
    rsk = np.zeros((b, 96), np.uint8)
    for i, (pub, msg, sig) in enumerate(cases):
        a[i] = np.frombuffer(pub, np.uint8)
        rsk[i, :64] = np.frombuffer(sig, np.uint8)
        k = int.from_bytes(hashlib.sha512(sig[:32] + pub + msg).digest(), "little") % ref.L
        rsk[i, 64:] = np.frombuffer(k.to_bytes(32, "little"), np.uint8)
    live = np.arange(b) < n
    jok_a, jneg_a = JV.decompress_pubkeys_jit(jnp.asarray(a))
    ok_a, neg_a = V.decompress_pubkeys(torch.from_numpy(a))
    np.testing.assert_array_equal(ok_a.numpy(), np.asarray(jok_a))
    for j, t in zip(jneg_a, neg_a):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    jbits, jall = JV.verify_batch_cached_a_jit(jok_a, jneg_a, jnp.asarray(rsk), jnp.asarray(live))
    bits, all_ok = V.verify_batch_cached_a(ok_a, neg_a, torch.from_numpy(rsk), torch.from_numpy(live))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))
    assert bool(all_ok) == bool(jall) is False
    pbits, pall = V.verify_batch_prehashed(
        torch.from_numpy(a), torch.from_numpy(rsk[:, :32].copy()),
        torch.from_numpy(rsk[:, 32:64].copy()), torch.from_numpy(rsk[:, 64:].copy()),
        torch.from_numpy(live))
    assert torch.equal(pbits, bits) and bool(pall) == bool(all_ok)
    # padding lanes never verify and never spoil the summary
    assert not bits[n:].any()


def test_factories_commit_same_bitmap_with_one_corrupted_index():
    from cometbft_tpu.utils import factories as fx

    chain = "torch-port-chain"
    signers = fx.make_signers(12, seed=5)
    vals = fx.make_validator_set(signers)
    by_addr = {s.address(): s for s in signers}
    commit = fx.make_commit(chain, 7, 0, fx.make_block_id(b"torch"), vals, by_addr)
    triples = []
    for idx, (val, cs) in enumerate(zip(vals.validators, commit.signatures)):
        sig = cs.signature
        if idx == 4:
            sig = sig[:10] + bytes([sig[10] ^ 0x40]) + sig[11:]
        triples.append((val.pub_key.bytes(), commit.vote_sign_bytes(chain, idx), sig))
    (jok, jbits), (ok, bits) = verdicts_both(triples)
    assert bits == jbits
    assert not ok and not jok
    assert [i for i, bit in enumerate(bits) if not bit] == [4]


def test_add_batch_matches_add():
    cases = mixed_batch()
    bv = E.Ed25519BatchVerifier(device="cpu")
    pubs = np.stack([np.frombuffer(p, np.uint8) for p, _, _ in cases])
    sigs = np.stack([np.frombuffer(s, np.uint8) for _, _, s in cases])
    blob = b"".join(m for _, m, _ in cases)
    bv.add_batch(pubs, sigs, blob, np.array([len(m) for _, m, _ in cases]))
    _, want = verdicts_both(cases)
    assert bv.count() == len(cases)
    assert bv.verify() == want


def test_pipelined_submit_and_collect():
    items = signed(5)
    bv = E.Ed25519BatchVerifier(device="cpu")
    for pub, msg, sig in items[:3]:
        bv.add(E.Ed25519PubKey(pub), msg, sig)
    p1 = bv.submit()
    pub, msg, sig = items[3]
    bv.add(E.Ed25519PubKey(pub), msg + b"!", sig)
    p2 = bv.submit()
    empty = E.Ed25519BatchVerifier(device="cpu").submit()
    (ok1, b1), (ok2, b2), (ok3, b3) = E.collect_pending([p1, p2, empty])
    assert ok1 and b1 == [True] * 3
    assert not ok2 and b2 == [True, True, True, False]
    assert ok3 and b3 == []
    assert p1.result() == (ok1, b1)
    assert E.collect_pending([]) == []


def test_create_batch_verifier_by_key_type():
    from cometbft_tpu_torch.crypto.keys import PubKey

    class OtherKey(PubKey):
        def address(self):
            return b"\0" * 20

        def bytes(self):
            return b"\1" * 33

        def verify_signature(self, msg, sig):
            return False

        def type_tag(self):
            return "tendermint/PubKeySecp256k1"

    pub = E.Ed25519PubKey(signed(1)[0][0])
    bv = create_batch_verifier(pub, device="cpu")
    assert isinstance(bv, E.Ed25519BatchVerifier) and bv.device.type == "cpu"
    assert create_batch_verifier(OtherKey(), device="cpu") is None
    assert not bv.add(OtherKey(), b"m", b"\0" * 64)


def test_default_device_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        E.Ed25519BatchVerifier()
    with pytest.raises(RuntimeError, match="cuda"):
        E.batch_verifier()
    with pytest.raises(RuntimeError, match="cuda"):
        create_batch_verifier(E.Ed25519PubKey(b"\0" * 32))


def test_generate_signed_batch_byte_identical_to_reference():
    got = generate_signed_batch(8, seed=11, msg_len=100, vote_shaped=True, device="cpu")
    assert got == JT.generate_signed_batch(8, seed=11, msg_len=100, vote_shaped=True)
    plain = generate_signed_batch(8, seed=11, msg_len=40, device="cpu")
    # the same seed draws the same keys and nonces whatever the messages
    assert [p for p, _, _ in plain] == [p for p, _, _ in got]
    assert [len(m) for _, m, _ in plain] == [40] * 8
    assert all(ref.verify(p, m, s) for p, m, s in got + plain)
