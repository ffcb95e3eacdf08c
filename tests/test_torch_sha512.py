"""The port's SHA-512 and reduction mod L against the JAX package's, on
the CPU.

`cometbft_tpu_torch.ops.sha512` (the plain version of the `sha512_blocks`
kernel, `pad_messages`) and `ops.scalar.reduce512` (the plain version of
the `reduce512` kernel) against `cometbft_tpu`'s `sha512_two_blocks`,
`pad_messages` and `reduce512` under `jax.jit` on the CPU, and against
`hashlib` and Python integers; the device-SHA route's host pack of
uniform-length messages against `pad_messages`. Inputs come from numpy
with fixed seeds. The tolerance is exact everywhere: digests, words and
limbs must be equal bit for bit. `fast_jit` here compiles the JAX
package's verify graphs for `test_torch_device_sha.py` and
`test_torch_delta.py`.
"""

import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from cometbft_tpu.ops import scalar as JSC  # noqa: E402
from cometbft_tpu.ops import sha512 as JH  # noqa: E402
from cometbft_tpu_torch.crypto import ed25519 as E  # noqa: E402
from cometbft_tpu_torch.crypto import ed25519_ref as ref  # noqa: E402
from cometbft_tpu_torch.ops import ed25519_verify as V  # noqa: E402
from cometbft_tpu_torch.ops import scalar as SC  # noqa: E402
from cometbft_tpu_torch.ops import sha512 as H  # noqa: E402
from test_torch_verify import signed  # noqa: E402

B = 64
LENGTHS = [0, 1, 55, 111, 112, 127, 128, 175, 200, 239]
# XLA:CPU settings that shorten the compile of the reference's verify graph;
# the graphs are integer code, so every result is the same
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def fast_jit(fn):
    """jax.jit(fn) compiled with FAST_COMPILE, once per argument shape, and
    kept out of the persistent compilation cache (writing the executable
    there lengthens each compile)."""
    compiled = {}

    def call(*args):
        key = tuple((np.shape(x), str(x.dtype)) for x in jax.tree_util.tree_leaves(args))
        if key not in compiled:
            cache = jax.config.jax_enable_compilation_cache
            jax.config.update("jax_enable_compilation_cache", False)
            try:
                compiled[key] = jax.jit(fn).lower(*args).compile(FAST_COMPILE)
            finally:
                jax.config.update("jax_enable_compilation_cache", cache)
        return compiled[key](*args)

    return call



@pytest.fixture(scope="module")
def messages():
    rng = np.random.default_rng(512)
    return [rng.bytes(n) for n in LENGTHS]


def test_constants_match_the_reference():
    assert H.K64 == JH._K64 and H.IV64 == JH._IV64
    assert (H.MAX_INPUT_BYTES, H.PADDED_BYTES, H.PADDED_WORDS) == (
        JH.MAX_INPUT_BYTES, JH.PADDED_BYTES, JH.PADDED_WORDS)


def test_pad_messages_matches_the_reference(messages):
    words, two = H.pad_messages(messages)
    jwords, jtwo = JH.pad_messages(messages)
    assert words.dtype == jwords.dtype and np.array_equal(words, jwords)
    assert np.array_equal(two, jtwo)
    assert two.tolist() == [n > 111 for n in LENGTHS]
    uniform = [m[:100] for m in messages[-3:]]  # the vectorized branch
    assert all(np.array_equal(x, y) for x, y in zip(H.pad_messages(uniform),
                                                    JH.pad_messages(uniform)))


def test_pad_messages_rejects_oversize():
    with pytest.raises(ValueError):
        H.pad_messages([b"x" * 240])
    with pytest.raises(ValueError):
        H.pad_messages([b"", b"x" * (H.MAX_INPUT_BYTES + 1)])


@pytest.mark.parametrize("dtype", ["int64", "int32"])
def test_sha512_matches_reference_and_hashlib(messages, dtype):
    """One- and two-block lanes, the lengths at the block edges; words as
    int64 values or as int32 bit patterns."""
    words, two = H.pad_messages(messages)
    w = torch.from_numpy(words.astype(np.int64) if dtype == "int64" else words.view(np.int32))
    hi, lo = H.sha512_two_blocks(w, torch.from_numpy(two))
    jhi, jlo = jax.jit(JH.sha512_two_blocks)(words, two)
    assert hi.dtype == lo.dtype == torch.int64
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    digest = H.sha512_digest(w, torch.from_numpy(two))
    assert digest.shape == (len(messages), 64) and digest.dtype == torch.uint8
    assert [bytes(row) for row in digest.numpy()] == [hashlib.sha512(m).digest()
                                                      for m in messages]
    assert all(torch.equal(x, y) for x, y in zip(H.digest_to_words(digest), (hi, lo)))
    assert torch.equal(V._digest_to_bytes(hi, lo), digest)


def test_sha512_short_lanes_take_the_first_block(messages):
    """A lane flagged one-block ignores whatever its second block holds;
    two_blocks=None hashes both blocks of every lane."""
    words, two = H.pad_messages(messages)
    junk = words.copy()
    junk[~two, 32:] = np.random.default_rng(3).integers(0, 2**32, (int((~two).sum()), 32),
                                                         dtype=np.uint32)
    got = H.sha512_digest(torch.from_numpy(junk.view(np.int32)), torch.from_numpy(two))
    assert torch.equal(got, H.sha512_digest(torch.from_numpy(words.view(np.int32)),
                                            torch.from_numpy(two)))
    hi, lo = H.sha512_two_blocks(torch.from_numpy(junk.view(np.int32)))
    jhi, jlo = jax.jit(JH.sha512_two_blocks)(junk)
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))


def edge_digests(rng) -> list[int]:
    """0, L - 1, L, 2L, 2^512 - 1, values just under and at multiples of
    L, values that make the Barrett quotient's estimate short, and random
    512-bit values."""
    L = SC.L_INT
    top = (1 << 512) - 1
    vals = [0, 1, L - 1, L, L + 1, 2 * L, 2 * L - 1, 3 * L - 1, top, top - 1,
            top // L * L, top // L * L - 1, (1 << 252) - 1, 1 << 252, (1 << 256) - 1]
    vals += [q * L - d for q in (2**200, 2**259 + 3, top // L) for d in (1, 2, L // 2)]
    vals += [int.from_bytes(rng.bytes(64), "little") for _ in range(B - len(vals))]
    return vals


def test_reduce512_matches_reference_and_ints():
    vals = edge_digests(np.random.default_rng(44))
    digests = np.stack([np.frombuffer(v.to_bytes(64, "little"), np.uint8) for v in vals])
    k = SC.reduce512(torch.from_numpy(digests))
    assert k.shape == (22, B) and k.dtype == torch.int32
    np.testing.assert_array_equal(k.numpy(), np.asarray(jax.jit(JSC.reduce512)(digests)))
    got = [sum(int(x) << (12 * i) for i, x in enumerate(k[:, j])) for j in range(B)]
    assert got == [v % SC.L_INT for v in vals]
    assert int(k.max()) < 4096 and int(k.min()) >= 0
    np.testing.assert_array_equal(SC.L_LIMBS, np.asarray(JSC.L_LIMBS))
    np.testing.assert_array_equal(SC._MU_LIMBS, np.asarray(JSC._MU_LIMBS))


def test_device_sha_pack_of_uniform_lengths():
    """Messages of one length take the vectorized branch of the pack:
    its words and flags equal `pad_messages` of the R||A||M preimages, a
    precheck failure's zeroed signature included, and the live mask
    covers the n lanes."""
    cases = signed(5, msg_len=60)
    p, m, sg = cases[1]
    cases[1] = (p, m, sg[:32] + (int.from_bytes(sg[32:], "little") + ref.L).to_bytes(32, "little"))
    for msg_len, two in ((47, False), (48, True)):  # R||A||M of 111 and 112 bytes
        cases = [(p, bytes(msg_len), sg) for p, _, sg in cases]
        bv = E.Ed25519BatchVerifier(device="cpu", device_sha=True)
        for c in cases:
            bv.add(E.Ed25519PubKey(c[0]), c[1], c[2])
        buf, fields, oversize = bv._pack_device_sha(5, B)
        t = E.unpack_fields(buf, fields)
        words, flags = H.pad_messages([sg[:32] + p + m for p, m, sg in bv._items()])
        assert oversize == [] and bv._items()[1][2] == bytes(64)
        np.testing.assert_array_equal(t["words"][:5].numpy().view(np.uint32), words)
        assert t["two"][:5].tolist() == flags.tolist() == [two] * 5
        assert t["live"].tolist() == [True] * 5 + [False] * (B - 5)
        assert not t["words"][5:].any() and not t["two"][5:].any()
        np.testing.assert_array_equal(t["s"][:5].numpy(), np.stack(
            [np.frombuffer(sg[32:], np.uint8) for _, _, sg in bv._items()]))
