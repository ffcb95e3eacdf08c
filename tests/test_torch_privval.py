"""The port's FilePV against the reference's (`tests/test_privval.py`,
reference privval/file_test.go): double-sign protection, the timestamp-only
re-sign, restarts; key and state files each package loads from the other;
signatures byte-equal to the reference's; other key types refused by name.
"""

import importlib
import json

import numpy as np
import pytest

pytest.importorskip("torch")

CHAIN = "pv-chain"
PACKAGES = {"port": "cometbft_tpu_torch", "reference": "cometbft_tpu"}


class Pkg:
    def __init__(self, side: str):
        root = PACKAGES[side]
        self.pv = importlib.import_module(f"{root}.privval.file_pv")
        self.ed = importlib.import_module(f"{root}.crypto.ed25519")
        self.keys = importlib.import_module(f"{root}.crypto.keys")
        self.types = importlib.import_module(f"{root}.types")
        self.vote = importlib.import_module(f"{root}.types.vote")
        self.FilePV = self.pv.FilePV
        self.DoubleSignError = self.pv.DoubleSignError

    def bid(self, tag: bytes):
        t = self.types
        return t.BlockID(self.keys.tmhash(tag), t.PartSetHeader(1, self.keys.tmhash(b"p" + tag)))

    def vote_(self, h, r, block_id, t=None, ts=None):
        T = self.types
        return T.Vote(type=self.vote.SignedMsgType.PRECOMMIT if t is None else t, height=h,
                      round=r, block_id=block_id, timestamp=ts or T.Timestamp(50, 0))


@pytest.fixture(params=list(PACKAGES))
def P(request):
    return Pkg(request.param)


def seed_key(P, n: int = 0):
    return P.ed.Ed25519PrivKey(bytes(np.random.default_rng(n).integers(0, 256, 32,
                                                                       dtype=np.uint8)))


def test_sign_and_verify(P, tmp_path):
    pv = P.FilePV.generate(str(tmp_path / "key.json"), str(tmp_path / "state.json"))
    v = P.vote_(1, 0, P.bid(b"a"))
    pv.sign_vote(CHAIN, v)
    assert pv.pub_key().verify_signature(v.sign_bytes(CHAIN), v.signature)


def test_exact_resign_returns_same_signature(P, tmp_path):
    pv = P.FilePV.generate(None, str(tmp_path / "state.json"))
    v1 = P.vote_(1, 0, P.bid(b"a"))
    pv.sign_vote(CHAIN, v1)
    v2 = P.vote_(1, 0, P.bid(b"a"))
    pv.sign_vote(CHAIN, v2)
    assert v1.signature == v2.signature


def test_timestamp_only_difference_reuses_signature(P, tmp_path):
    T = P.types.Timestamp
    pv = P.FilePV.generate(None, str(tmp_path / "state.json"))
    v1 = P.vote_(1, 0, P.bid(b"a"), ts=T(50, 0))
    pv.sign_vote(CHAIN, v1)
    v2 = P.vote_(1, 0, P.bid(b"a"), ts=T(99, 5))
    pv.sign_vote(CHAIN, v2)
    assert v2.signature == v1.signature
    assert v2.timestamp == T(50, 0)  # previous timestamp served


def test_conflicting_block_refused(P, tmp_path):
    pv = P.FilePV.generate(None, str(tmp_path / "state.json"))
    pv.sign_vote(CHAIN, P.vote_(1, 0, P.bid(b"a")))
    with pytest.raises(P.DoubleSignError):
        pv.sign_vote(CHAIN, P.vote_(1, 0, P.bid(b"b")))


def test_hrs_regression_refused(P, tmp_path):
    pv = P.FilePV.generate(None, str(tmp_path / "state.json"))
    pv.sign_vote(CHAIN, P.vote_(5, 3, P.bid(b"a")))
    with pytest.raises(P.DoubleSignError):
        pv.sign_vote(CHAIN, P.vote_(4, 0, P.bid(b"a")))
    with pytest.raises(P.DoubleSignError):
        pv.sign_vote(CHAIN, P.vote_(5, 2, P.bid(b"a")))
    # step regression: precommit signed, now a prevote at same h/r
    with pytest.raises(P.DoubleSignError):
        pv.sign_vote(CHAIN, P.vote_(5, 3, P.bid(b"a"), t=P.vote.SignedMsgType.PREVOTE))


def test_protection_survives_restart(P, tmp_path):
    key, st = str(tmp_path / "key.json"), str(tmp_path / "state.json")
    pv = P.FilePV.generate(key, st)
    pv.sign_vote(CHAIN, P.vote_(7, 1, P.bid(b"a")))
    pv2 = P.FilePV.load(key, st)
    assert pv2.address() == pv.address()
    with pytest.raises(P.DoubleSignError):
        pv2.sign_vote(CHAIN, P.vote_(7, 1, P.bid(b"b")))
    # exact re-sign still served after restart
    v = P.vote_(7, 1, P.bid(b"a"))
    pv2.sign_vote(CHAIN, v)
    assert pv.pub_key().verify_signature(v.sign_bytes(CHAIN), v.signature)


def test_proposal_sign_and_conflict(P, tmp_path):
    T = P.types
    pv = P.FilePV.generate(None, str(tmp_path / "state.json"))
    p1 = T.Proposal(height=2, round=0, block_id=P.bid(b"p"), timestamp=T.Timestamp(10, 0))
    pv.sign_proposal(CHAIN, p1)
    assert pv.pub_key().verify_signature(p1.sign_bytes(CHAIN), p1.signature)
    # proposal then prevote at same h/r is the normal step order
    v = P.vote_(2, 0, P.bid(b"p"), t=P.vote.SignedMsgType.PREVOTE)
    pv.sign_vote(CHAIN, v)
    # conflicting proposal at same h/r refused
    p2 = T.Proposal(height=2, round=0, block_id=P.bid(b"q"), timestamp=T.Timestamp(10, 0))
    with pytest.raises(P.DoubleSignError):
        pv.sign_proposal(CHAIN, p2)


@pytest.mark.parametrize("writer, reader", [("port", "reference"), ("reference", "port")])
def test_key_and_state_files_load_in_the_other_package(tmp_path, writer, reader):
    """A FilePV's key and state files, written by one package from the same
    seed-made key, are byte-identical to the other's and load there; the
    double-sign guard and the served signature carry across."""
    W, R = Pkg(writer), Pkg(reader)
    files = {}
    for side, P in (("w", W), ("r", R)):
        key, st = tmp_path / f"{side}.key.json", tmp_path / f"{side}.state.json"
        pv = P.FilePV(seed_key(P, 3), str(key), str(st))
        pv._save_key()
        v = P.vote_(4, 0, P.bid(b"a"))
        pv.sign_vote(CHAIN, v)
        files[side] = (key.read_bytes(), st.read_bytes(), v.signature)
    assert files["w"] == files["r"]
    assert json.loads(files["w"][0])["key_type"] == "tendermint/PubKeyEd25519"
    pv = R.FilePV.load(str(tmp_path / "w.key.json"), str(tmp_path / "w.state.json"))
    assert pv.pub_key().bytes() == seed_key(W, 3).pub_key().bytes()
    v = R.vote_(4, 0, R.bid(b"a"), ts=R.types.Timestamp(77, 0))
    pv.sign_vote(CHAIN, v)  # the timestamp-only re-sign serves the stored signature
    assert v.signature == files["w"][2] and v.timestamp == R.types.Timestamp(50, 0)
    with pytest.raises(R.DoubleSignError):
        pv.sign_vote(CHAIN, R.vote_(4, 0, R.bid(b"b")))


def test_signatures_equal_the_reference():
    """The same key signs the same bytes alike in both packages: the
    port's native signer against the reference's, and the public key
    the port's engine derives against the reference's."""
    port, ref = Pkg("port"), Pkg("reference")
    rng = np.random.default_rng(5)
    for n in range(8):
        kp, kr = seed_key(port, n), seed_key(ref, n)
        assert kp.pub_key().bytes() == kr.pub_key().bytes()
        assert kp.bytes() == kr.bytes()
        msg = rng.integers(0, 256, int(rng.integers(0, 300)), dtype=np.uint8).tobytes()
        assert kp.sign(msg) == kr.sign(msg)
        assert port.ed.Ed25519PrivKey(kr.bytes()).sign(msg) == kr.sign(msg)
    vp, vr = port.vote_(9, 2, port.bid(b"z")), ref.vote_(9, 2, ref.bid(b"z"))
    pvp = port.FilePV(seed_key(port, 1), None, None)
    pvr = ref.FilePV(seed_key(ref, 1), None, None)
    pvp.sign_vote(CHAIN, vp)
    pvr.sign_vote(CHAIN, vr)
    assert vp.signature == vr.signature
    pp = port.types.Proposal(height=9, round=2, block_id=port.bid(b"z"),
                             timestamp=port.types.Timestamp(3, 4))
    pr = ref.types.Proposal(height=9, round=2, block_id=ref.bid(b"z"),
                            timestamp=ref.types.Timestamp(3, 4))
    port.FilePV(seed_key(port, 1), None, None).sign_proposal(CHAIN, pp)
    ref.FilePV(seed_key(ref, 1), None, None).sign_proposal(CHAIN, pr)
    assert pp.signature == pr.signature and pp.encode() == pr.encode()


@pytest.mark.parametrize("key_type", ["tendermint/PubKeySecp256k1",
                                      "tendermint/PubKeyBls12_381"])
def test_other_key_types_are_refused_by_name(tmp_path, key_type):
    """The port's FilePV signs with Ed25519 alone: generating, or loading a
    key file of, a secp256k1 or BLS key raises UnsupportedKeyType naming
    the type, where the reference builds the key."""
    from cometbft_tpu_torch.privval import FilePV
    from cometbft_tpu_torch.types.validator_set import UnsupportedKeyType

    with pytest.raises(UnsupportedKeyType, match=key_type):
        FilePV.generate(str(tmp_path / "k.json"), str(tmp_path / "s.json"), key_type=key_type)
    ref = Pkg("reference").FilePV.generate(str(tmp_path / "k.json"), str(tmp_path / "s.json"),
                                           key_type=key_type)
    assert json.loads((tmp_path / "k.json").read_text())["key_type"] == key_type
    with pytest.raises(UnsupportedKeyType, match=key_type):
        FilePV.load(str(tmp_path / "k.json"), str(tmp_path / "s.json"))
    assert ref.pub_key().type_tag() == key_type


def test_the_port_signs_only_through_the_native_engine(monkeypatch):
    """No Python fallback for signing: without the host library, signing
    raises."""
    from cometbft_tpu_torch.crypto import native

    key = seed_key(Pkg("port"), 2)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    with pytest.raises(RuntimeError, match="native ed25519 unavailable"):
        key.sign(b"msg")
