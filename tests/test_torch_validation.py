"""The port's verify_commit, verify_commit_light and
verify_commit_light_trusting against the JAX package's.

The fixtures are made by the port (`utils/factories.py`, on the CPU) and
carried to the reference as bytes: the validator set through its proto
encoding, the commit and the block id through theirs. Each case runs all
three functions in both packages; the outcome must be the same: no error,
or the same exception class with the same message. The reference runs
with backend="tpu", which on CPU JAX sends every batch to its native
engine; the port runs device="cpu" (its native route under NATIVE_MAX,
and in two cases the plain versions of the device route).
"""

from __future__ import annotations

import copy

import pytest

torch = pytest.importorskip("torch")

from cometbft_tpu.state import types as RST  # noqa: E402
from cometbft_tpu.types import basic as RB  # noqa: E402
from cometbft_tpu.types import block as RBL  # noqa: E402
from cometbft_tpu.types import validation as RVAL  # noqa: E402
from cometbft_tpu_torch.crypto import ed25519 as E  # noqa: E402
from cometbft_tpu_torch.crypto.keys import PubKey  # noqa: E402
from cometbft_tpu_torch.types import BlockIDFlag, CommitSig, Validator, ValidatorSet  # noqa: E402
from cometbft_tpu_torch.types import validation as VAL  # noqa: E402
from cometbft_tpu_torch.types import validator_set as VS  # noqa: E402
from cometbft_tpu_torch.utils import factories as fx  # noqa: E402
from cometbft_tpu_torch.utils import metrics, trace  # noqa: E402

CHAIN = "chain-v"
HEIGHT = 7
FUNCS = ("verify_commit", "verify_commit_light", "verify_commit_light_trusting")


@pytest.fixture(scope="module")
def world():
    """8 signers of power 10 (threshold 53 for +2/3, 26 for 1/3), two
    spare signers, and a valid commit by all 8."""
    signers = fx.make_signers(10, seed=11, device="cpu")
    vals = fx.make_validator_set(signers[:8])
    by_addr = {s.address(): s for s in signers}
    bid = fx.make_block_id(b"validation")
    commit = fx.make_commit(CHAIN, HEIGHT, 0, bid, vals, by_addr, device="cpu")
    strangers = fx.make_signers(6, seed=12, device="cpu")
    return {"signers": signers, "vals": vals, "by_addr": by_addr, "bid": bid, "commit": commit,
            "strangers": strangers}


def _flip(cs: CommitSig) -> None:
    cs.signature = bytes([cs.signature[0] ^ 1]) + cs.signature[1:]


def _resign(w, commit, idx: int) -> None:
    """Sign slot idx again over its current sign bytes (a NIL vote)."""
    signer = w["by_addr"][commit.signatures[idx].validator_address]
    commit.invalidate_memos()
    commit.signatures[idx].signature = fx.sign_with_scalar(
        signer, commit.vote_sign_bytes(CHAIN, idx))


def _case(name: str, w):
    """(vals, trusted vals, block id, height, commit) of one case."""
    vals, bid, commit = w["vals"], w["bid"], copy.deepcopy(w["commit"])
    trusted, height = vals, HEIGHT
    sigs = commit.signatures
    if name == "bad_signature":
        _flip(sigs[2])
    elif name == "bad_signature_after_two_thirds":
        _flip(sigs[7])  # the light functions stop before it
    elif name == "absent_and_nil":
        sigs[1] = CommitSig.absent()
        sigs[3].block_id_flag = BlockIDFlag.NIL
        _resign(w, commit, 3)
    elif name == "nil_with_bad_signature":
        sigs[3].block_id_flag = BlockIDFlag.NIL
        _resign(w, commit, 3)
        _flip(sigs[3])
    elif name == "under_threshold":
        for i in (0, 1, 2):
            sigs[i] = CommitSig.absent()
    elif name == "address_mismatch":
        sigs[4].validator_address = b"\x42" * 20
    elif name == "wrong_height":
        height = HEIGHT + 1
    elif name == "wrong_block_id":
        bid = fx.make_block_id(b"another block")
    elif name == "trusting_unknown_and_duplicate":
        # the trusted set knows two of the signers (20 of its 80); slot 6
        # repeats slot 0's validator and vote, which must count once
        sigs[6] = copy.deepcopy(sigs[0])
        trusted = fx.make_validator_set(w["signers"][:2] + w["strangers"])
    elif name != "valid":
        raise ValueError(name)
    commit.invalidate_memos()
    return vals, trusted, bid, height, commit


CASES = ("valid", "bad_signature", "bad_signature_after_two_thirds", "absent_and_nil",
         "nil_with_bad_signature", "under_threshold", "address_mismatch", "wrong_height",
         "wrong_block_id", "trusting_unknown_and_duplicate")


def _outcome(fn, *args, **kw):
    try:
        fn(*args, **kw)
    except Exception as e:  # noqa: BLE001 — the class and message are compared
        return type(e).__name__, str(e)
    return None


def _run_both(fn: str, vals, trusted, bid, height, commit):
    """(port outcome, reference outcome), the reference given bytes only."""
    r_vals = RST.decode_validator_set(VS.encode_validator_set(vals))
    r_trusted = RST.decode_validator_set(VS.encode_validator_set(trusted))
    r_bid = RB.BlockID.decode(bid.encode())
    r_commit = RBL.Commit.decode(commit.encode())
    if fn == "verify_commit_light_trusting":
        port = _outcome(VAL.verify_commit_light_trusting, CHAIN, trusted, commit, device="cpu")
        ref = _outcome(RVAL.verify_commit_light_trusting, CHAIN, r_trusted, r_commit,
                       backend="tpu")
    else:
        port = _outcome(getattr(VAL, fn), CHAIN, vals, bid, height, commit, device="cpu")
        ref = _outcome(getattr(RVAL, fn), CHAIN, r_vals, r_bid, height, r_commit, backend="tpu")
    return port, ref


EXPECTED = {  # what the reference gives; pinned so that a case cannot go vacuous
    ("valid", "verify_commit"): None,
    ("bad_signature", "verify_commit"): ("ErrInvalidSignature", "invalid signature at index 2"),
    ("bad_signature_after_two_thirds", "verify_commit_light"): None,
    ("under_threshold", "verify_commit"): ("ErrNotEnoughVotingPower",
                                           "tallied 50 <= threshold 53"),
    ("nil_with_bad_signature", "verify_commit"): ("ErrInvalidSignature",
                                                  "invalid signature at index 3"),
    ("address_mismatch", "verify_commit"): ("ErrInvalidSignature", "address mismatch at index 4"),
    ("wrong_height", "verify_commit"): ("ErrInvalidCommitHeight", "expected height 8, got 7"),
    ("wrong_block_id", "verify_commit_light"): ("ErrInvalidBlockID",
                                                "commit is for a different block"),
    ("trusting_unknown_and_duplicate", "verify_commit_light_trusting"): (
        "ErrNotEnoughVotingPower", "tallied 20 <= threshold 26"),
}


@pytest.mark.parametrize("fn", FUNCS)
@pytest.mark.parametrize("case", CASES)
def test_outcome_matches_reference(world, case, fn):
    port, ref = _run_both(fn, *_case(case, world))
    assert port == ref
    if (case, fn) in EXPECTED:
        assert ref == EXPECTED[(case, fn)]


@pytest.fixture
def device_route(monkeypatch):
    """NATIVE_MAX = 0: the commit goes through the device route's plain
    versions (ladder, 64-lane bucket) instead of the native engine."""
    monkeypatch.setattr(E, "NATIVE_MAX", 0)
    monkeypatch.setattr(E, "_rlc_beats_ladder", lambda n, b, device: False)


@pytest.mark.parametrize("case", ["valid", "bad_signature"])
def test_device_route_outcome_matches_reference(world, device_route, case):
    metrics.reset_bundles()
    port, ref = _run_both("verify_commit", *_case(case, world))
    assert port == ref == EXPECTED[(case, "verify_commit")]
    assert metrics.crypto_metrics().path_selected_total.values() == {
        ("ladder", "ed25519"): 1.0, ("batch", "ed25519"): 1.0}


def test_one_signature_verifies_singly(world):
    """Below BATCH_VERIFY_THRESHOLD the signature verifies alone, in both
    packages, with the same messages."""
    signer = world["signers"][0]
    vals = fx.make_validator_set([signer])
    commit = fx.make_commit(CHAIN, HEIGHT, 0, world["bid"], vals, world["by_addr"],
                            device="cpu")
    assert _run_both("verify_commit", vals, vals, world["bid"], HEIGHT, commit) == (None, None)
    _flip(commit.signatures[0])
    commit.invalidate_memos()
    port, ref = _run_both("verify_commit", vals, vals, world["bid"], HEIGHT, commit)
    assert port == ref == ("ErrInvalidSignature", "invalid signature at index 0")


class _OtherKey(PubKey):
    def __init__(self, b):
        self._b = b

    def address(self):
        return self._b[:20]

    def bytes(self):
        return self._b

    def verify_signature(self, msg, sig):
        raise AssertionError("a key of another type must not be verified")

    def type_tag(self):
        return "tendermint/PubKeySecp256k1"


def test_non_ed25519_key_is_refused_by_name(world):
    """The reference verifies a secp256k1 validator's vote; the port has no
    verifier for it: its validator-set decode refuses the key, naming its
    type, and a key of another type handed to the verifiers raises
    ErrUnsupportedKeyType, also naming it. Nothing verifies it some other
    way (a recorded divergence, ROADMAP.md queue C)."""
    from cometbft_tpu.crypto.secp256k1 import Secp256k1PrivKey

    priv = Secp256k1PrivKey(b"\x05" * 32)
    r_vals = RST.decode_validator_set(VS.encode_validator_set(world["vals"]))
    r_vals = type(r_vals)([*r_vals.validators,
                           type(r_vals.validators[0]).from_pub_key(priv.pub_key(), 10)])
    with pytest.raises(VS.UnsupportedKeyType, match="secp256k1"):
        VS.decode_validator_set(RST.encode_validator_set(r_vals))

    other = _OtherKey(b"\x09" * 33)
    vals = ValidatorSet([*world["vals"].validators, Validator(other.address(), other, 10)])
    commit = copy.deepcopy(world["commit"])
    idx = [v.address for v in vals.validators].index(other.address())
    commit.signatures.insert(idx, CommitSig(BlockIDFlag.COMMIT, other.address(),
                                            commit.signatures[0].timestamp, b"\x01" * 64))
    commit.invalidate_memos()
    for fn in FUNCS:
        args = ((CHAIN, vals, commit) if fn == "verify_commit_light_trusting"
                else (CHAIN, vals, world["bid"], HEIGHT, commit))
        kw = {"verify_all_signatures": True} if fn != "verify_commit" else {}
        with pytest.raises(VAL.ErrUnsupportedKeyType, match="PubKeySecp256k1"):
            getattr(VAL, fn)(*args, device="cpu", **kw)


def test_cuda_without_a_gpu_raises(world, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    vals, _, bid, height, commit = _case("valid", world)
    for call in (lambda: VAL.verify_commit(CHAIN, vals, bid, height, commit),
                 lambda: VAL.verify_commit_light(CHAIN, vals, bid, height, commit, device="cuda"),
                 lambda: VAL.verify_commit_light_trusting(CHAIN, vals, commit)):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            call()


def test_partition_metrics_and_span(world, tmp_path):
    """One verify_commit records the batch partition under the curve label
    and, with tracing on, one `crypto.commit_partition` span."""
    import json

    metrics.reset_bundles()
    trace.configure(str(tmp_path / "t.jsonl"))
    try:
        VAL.verify_commit(CHAIN, world["vals"], world["bid"], HEIGHT, world["commit"],
                          device="cpu")
    finally:
        trace.disable()
    m = metrics.crypto_metrics()
    assert m.path_selected_total.values()[("batch", "ed25519")] == 1.0
    assert m.path_selected_total.values()[("native", "ed25519")] == 1.0
    assert m.verify_seconds.snapshot()[("batch", "ed25519")]["count"] == 1
    recs = [json.loads(x) for x in (tmp_path / "t.jsonl").read_text().splitlines()]
    part = [r for r in recs if r["name"] == "crypto.commit_partition"]
    assert len(part) == 1 and part[0]["curve"] == "ed25519" and part[0]["n"] == 8


def test_prefetch_on_cpu_handles_does_nothing(world, monkeypatch):
    """The consumers call prefetch() after submit(); on a CPU handle
    (native or plain device route) it starts no copy and result() is
    unchanged."""
    vals, commit = world["vals"], world["commit"]
    for native_max in (E.NATIVE_MAX, 0):
        monkeypatch.setattr(E, "NATIVE_MAX", native_max)
        bv = E.Ed25519BatchVerifier(device="cpu")
        for i, cs in enumerate(commit.signatures):
            bv.add(vals.get_by_index(i).pub_key, commit.vote_sign_bytes(CHAIN, i), cs.signature)
        pending = bv.submit()
        assert pending.prefetch() is None
        assert getattr(pending, "_ready", None) is None
        assert pending.result() == (True, [True] * 8)
