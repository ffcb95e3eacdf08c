"""The RLC route's tail after the weighted lanes, on the CPU: the port's
plain region sums and window combine against the JAX package's, and the
one-ladder form of its last step against the old chain of point ops.

- `region_tree_sum_plain` and `window_combine_plain` equal the reference's
  `_region_tree_sum` and `_window_combine` limb for limb after `freeze`,
  on random points of the group (multiples of the base point through
  `ed25519_ref`, some identity and 8-torsion lanes, Z not 1). The
  reference runs under `jax.jit` on the CPU, where it takes its XLA route;
  it is compiled at XLA's lowest backend optimization level, which changes
  no integer result and halves the compile.
- `ladder_sub_mul8_plain(c, 0, identity, -msm)`, the form the route now
  launches as one ladder kernel, gives the verdict and the point of
  `mul8(add(msm, fixed_base(c)))` on a valid batch and on a batch with
  one signature's S changed (the same msm, another c).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from cometbft_tpu.ops import msm as JM  # noqa: E402
from cometbft_tpu_torch.crypto import ed25519_ref as ref  # noqa: E402
from cometbft_tpu_torch.crypto import rlc  # noqa: E402
from cometbft_tpu_torch.ops import curve as C  # noqa: E402
from cometbft_tpu_torch.ops import field as F  # noqa: E402
from cometbft_tpu_torch.ops import msm as M  # noqa: E402

BUCKET = 64
N_SIGS = 9
LOW_OPT = {"xla_backend_optimization_level": 0}


def torsion_point():
    for y in range(2, 50):
        aff = ref._decode_point(y.to_bytes(32, "little"), zip215=True)
        if aff is None:
            continue
        t = ref._ext_scalar_mul(ref.L, ref._to_ext(aff))
        if not ref._ext_is_identity(t):
            return t
    raise AssertionError("no torsion point found")


def group_points(rng, n_distinct, n):
    """(4, 22, n) int32 extended points: n lanes drawn from n_distinct
    points P_i = P_0 + i Q (random P_0 and Q, multiples of the base point),
    every 37th lane the identity (a weight-0 bucket lane), every 101st an
    8-torsion point added."""
    pt = ref._ext_scalar_mul(int(rng.integers(1, 2**62)), ref.B_POINT)
    step = ref._ext_scalar_mul(int(rng.integers(1, 2**62)), ref.B_POINT)
    t8 = torsion_point()
    distinct = np.zeros((4, F.NLIMBS, n_distinct), np.int32)
    for i in range(n_distinct):
        pt = ref._ext_add(pt, step)
        q = ref._ext_add(pt, t8) if i % 101 == 9 else pt
        for c in range(4):
            distinct[c, :, i] = F.from_int(q[c] % F.P_INT)
    out = distinct[:, :, rng.integers(0, n_distinct, n)]
    out[:, :, 5::37] = np.array([0, 1, 1, 0], np.int32)[:, None, None] * (
        np.arange(F.NLIMBS) == 0)[None, :, None]
    return out


def frozen_equal(got, want):
    return all(torch.equal(F.freeze(g), F.freeze(torch.from_numpy(np.array(w))))
               for g, w in zip(got, want))


def test_region_tree_sum_plain_matches_reference():
    pts = group_points(np.random.default_rng(41), 2048, M.WK)
    want = jax.jit(JM._region_tree_sum).lower(tuple(pts)).compile(LOW_OPT)(tuple(pts))
    got = M.region_tree_sum_plain(torch.from_numpy(pts))
    assert got.shape == (4, F.NLIMBS, M.N_REGIONS)
    assert frozen_equal(got, want)
    assert torch.equal(M.region_tree_sum(torch.from_numpy(pts)), got)  # CPU: the plain version


def test_window_combine_plain_matches_reference():
    sums = group_points(np.random.default_rng(42), M.N_REGIONS, M.N_REGIONS)
    want = jax.jit(JM._window_combine).lower(tuple(sums)).compile(LOW_OPT)(tuple(sums))
    got = M.window_combine_plain(torch.from_numpy(sums))
    assert got.shape == (4, F.NLIMBS, 1)
    assert frozen_equal(got, want)
    assert torch.equal(M.window_combine(torch.from_numpy(sums)), got)


def signed(rng, n, msg_len=64):
    out = []
    for _ in range(n):
        seed = bytes(rng.bytes(32))
        msg = bytes(rng.bytes(msg_len))
        out.append((ref.pubkey_from_seed(seed), msg, ref.sign(seed, msg)))
    return out


@pytest.fixture(scope="module")
def tail_inputs():
    """msm of a valid 9-signature batch at bucket 64 (the plain route up
    to window_combine), and c of that batch and of a broken copy whose
    signature 4 has its S changed: the layout, and so msm, is the same."""
    rng = np.random.default_rng(43)
    items = signed(rng, N_SIGS)
    broken = list(items)
    pub, msg, sig = broken[4]
    s = (int.from_bytes(sig[32:], "little") + 1) % ref.L
    broken[4] = (pub, msg, sig[:32] + s.to_bytes(32, "little"))
    z16 = rng.integers(0, 256, (N_SIGS, 16), dtype=np.uint8)
    skip = np.zeros(N_SIGS, bool)
    prep = rlc.prepare(items, skip, BUCKET, z16)
    prep_broken = rlc.prepare(broken, skip, BUCKET, z16)
    for k in ("stream", "stream_neg", "counts", "weights"):
        np.testing.assert_array_equal(prep[k], prep_broken[k])
    assert not np.array_equal(prep["c_digits"], prep_broken["c_digits"])
    s_pad = 8
    while s_pad < prep["s_rounds"]:
        s_pad *= 2
    idx, neg = M.expand_stream(*(torch.from_numpy(prep[k]) for k in
                                 ("stream", "stream_neg", "counts")), s_pad)
    a = np.zeros((BUCKET, 32), np.uint8)
    r = np.zeros((BUCKET, 32), np.uint8)
    for i, (pub, _, sig) in enumerate(items):
        a[i] = np.frombuffer(pub, np.uint8)
        r[i] = np.frombuffer(sig[:32], np.uint8)
    _, a_pt = C.decompress(torch.from_numpy(a))
    _, r_pt = C.decompress(torch.from_numpy(r))
    niels = tuple(torch.cat([r_c, a_c, i_c], dim=1) for r_c, a_c, i_c in zip(
        C.to_niels(r_pt)[:3], C.to_niels(a_pt)[:3], M._identity_niels(1, "cpu")))
    weighted = M.accumulate_weighted_plain(niels, idx, neg, torch.from_numpy(prep["weights"]))
    msm = M.window_combine_plain(M.region_tree_sum_plain(weighted))
    return {"msm": msm, "valid": (prep["c_digits"], all(ref.verify(*it) for it in items)),
            "broken": (prep_broken["c_digits"], all(ref.verify(*it) for it in broken))}


@pytest.mark.parametrize("case, expect", [("valid", True), ("broken", False)])
def test_one_ladder_tail_matches_the_point_op_chain(tail_inputs, case, expect):
    msm = tail_inputs["msm"]
    c_np, want = tail_inputs[case]
    assert want == expect
    c = torch.from_numpy(c_np)
    old = C._PLAIN.mul8(C._PLAIN.add(msm, C._PLAIN.fixed_base(c)))
    X, Y, Z = C.ladder_sub_mul8_plain(c, torch.zeros_like(c), C.identity(1, "cpu"), C.neg(msm))
    assert bool(C.is_identity(old)[0]) == expect
    assert bool(C.is_identity((X, Y, Z, None))[0]) == expect
    assert bool(C._PLAIN.eq_points((X, Y, Z, None), old)[0])
    # and the same through the dispatching entry point, on CPU tensors
    got = C.ladder_sub_mul8(c, torch.zeros_like(c), C.identity(1, "cpu"), C.neg(msm))
    assert all(torch.equal(g, w) for g, w in zip(got, (X, Y, Z)))
