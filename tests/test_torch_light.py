"""The port's light-client verifier against the JAX package's.

Light blocks come from the reference's `make_chain` (4 validators, 6
heights) and are carried to the port as bytes (SignedHeader and the proto
ValidatorSet). `verify_adjacent`, `verify_non_adjacent`, `verify` and
`verify_stream` must give the reference's outcome on each case: no error,
or the same exception class with the same message.
"""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from cometbft_tpu.encoding import proto as RPB  # noqa: E402
from cometbft_tpu.light import types as RLT  # noqa: E402
from cometbft_tpu.light import verifier as RLV  # noqa: E402
from cometbft_tpu.state import types as RST  # noqa: E402
from cometbft_tpu.types import basic as RB  # noqa: E402
from cometbft_tpu.utils import factories as RF  # noqa: E402
from cometbft_tpu_torch.crypto import ed25519 as E  # noqa: E402
from cometbft_tpu_torch.light import LightBlock  # noqa: E402
from cometbft_tpu_torch.light import verifier as LV  # noqa: E402
from cometbft_tpu_torch.types import Timestamp  # noqa: E402

CHAIN = "light-chain"
PERIOD_S = 14 * 24 * 3600


@pytest.fixture(scope="module")
def chain():
    """{height: LightBlock bytes} of a 6-block chain, and the bytes of a
    validator set that shares no validator with it."""
    store, _state, genesis, _signers = RF.make_chain(6, n_validators=4, chain_id=CHAIN, seed=0)
    vals = RST.encode_validator_set(genesis.validators)
    out = {}
    for h in range(1, 7):
        sh = RLT.SignedHeader(store.load_block(h).header, store.load_seen_commit(h))
        out[h] = RPB.f_embedded(1, sh.encode()) + RPB.f_embedded(2, vals)
    strangers = RF.make_validator_set(RF.make_signers(4, seed=99))
    return out, RST.encode_validator_set(strangers)


def _ref_lb(buf: bytes):
    d = RPB.fields_to_dict(buf)
    return RLT.LightBlock(RLT.SignedHeader.decode(d[1]), RST.decode_validator_set(d[2]))


def _mutate(buf: bytes, *, flip_sig=None, chain_id=None, vals=None) -> bytes:
    """The light block with one signature bit flipped, another chain id,
    or another validator set; re-encoded by the port."""
    lb = LightBlock.decode(buf)
    if flip_sig is not None:
        cs = lb.signed_header.commit.signatures[flip_sig]
        cs.signature = bytes([cs.signature[0] ^ 1]) + cs.signature[1:]
        lb.signed_header.commit.invalidate_memos()
    if chain_id is not None:
        lb.signed_header.header.chain_id = chain_id
    out = lb.encode()
    if vals is not None:
        out = RPB.f_embedded(1, lb.signed_header.encode()) + RPB.f_embedded(2, vals)
    return out


def _outcome(fn, *args, **kw):
    try:
        fn(*args, **kw)
    except Exception as e:  # noqa: BLE001 — class and message are compared
        return type(e).__name__, str(e)
    return None


def _now(lbs, h, later_s=10):
    t = LightBlock.decode(lbs[h]).time
    return t.seconds + later_s, t.nanos


def _both(kind, blocks, now, **kw):
    """Run one verifier function in both packages on the same light-block
    bytes: blocks = (trusted, untrusted...) or (trusted, stream)."""
    ts = (Timestamp(*now), RB.Timestamp(*now))
    outs = []
    for lb_of, mod, t, dev in ((LightBlock.decode, LV, ts[0], {"device": "cpu"}),
                               (_ref_lb, RLV, ts[1], {"backend": "tpu"})):
        trusted, *rest = (lb_of(b) for b in blocks)
        if kind == "stream":
            outs.append(_outcome(mod.verify_stream, CHAIN, trusted, rest, PERIOD_S, t, **dev, **kw))
        elif kind == "adjacent":
            outs.append(_outcome(mod.verify_adjacent, CHAIN, trusted.signed_header,
                                 rest[0].signed_header, rest[0].validators, PERIOD_S, t, **dev,
                                 **kw))
        else:
            fn = mod.verify_non_adjacent if kind == "non_adjacent" else mod.verify
            outs.append(_outcome(fn, CHAIN, trusted.signed_header, trusted.validators,
                                 rest[0].signed_header, rest[0].validators, PERIOD_S, t, **dev,
                                 **kw))
    return outs


def _cases(lbs, strangers):
    now = _now(lbs, 6)
    bad4 = _mutate(lbs[4], flip_sig=2)
    return {
        "adjacent": ("adjacent", (lbs[1], lbs[2]), now, None),
        "adjacent_bad_signature": ("adjacent", (lbs[1], _mutate(lbs[2], flip_sig=0)), now,
                                   ("ErrInvalidSignature", "invalid signature at index 0")),
        "adjacent_not_adjacent": ("adjacent", (lbs[1], lbs[3]), now,
                                  ("ErrInvalidHeader", "headers must be adjacent in height")),
        "adjacent_wrong_chain": ("adjacent", (lbs[1], _mutate(lbs[2], chain_id="other")), now,
                                 None),
        "adjacent_expired": ("adjacent", (lbs[1], lbs[2]), _now(lbs, 1, PERIOD_S + 1), None),
        "adjacent_from_the_future": ("adjacent", (lbs[1], lbs[2]), _now(lbs, 1, -20), None),
        "non_adjacent": ("non_adjacent", (lbs[1], lbs[4]), now, None),
        "non_adjacent_untrusted_set": ("non_adjacent", (_mutate(lbs[1], vals=strangers), lbs[4]),
                                       now, None),
        "non_adjacent_bad_signature": ("non_adjacent", (lbs[1], bad4), now, None),
        "verify_adjacent": ("verify", (lbs[2], lbs[3]), now, None),
        "verify_skipping": ("verify", (lbs[1], lbs[5]), now, None),
        "stream": ("stream", (lbs[1], *(lbs[h] for h in range(2, 7))), now, None),
        "stream_bad_signature": ("stream", (lbs[1], lbs[2], lbs[3], bad4, lbs[5]), now,
                                 ("ErrInvalidSignature", "invalid signature in stream lane 10")),
        "stream_gap": ("stream", (lbs[1], lbs[2], lbs[4]), now, None),
        "stream_wrong_chain": ("stream", (lbs[1], lbs[2], _mutate(lbs[3], chain_id="x")), now,
                               None),
        "stream_expired": ("stream", (lbs[1], lbs[2]), _now(lbs, 1, PERIOD_S), None),
    }


CASE_NAMES = ("adjacent", "adjacent_bad_signature", "adjacent_not_adjacent",
              "adjacent_wrong_chain", "adjacent_expired", "adjacent_from_the_future",
              "non_adjacent", "non_adjacent_untrusted_set", "non_adjacent_bad_signature",
              "verify_adjacent", "verify_skipping", "stream", "stream_bad_signature",
              "stream_gap", "stream_wrong_chain", "stream_expired")
FAILS = {"adjacent_wrong_chain": "ValueError", "adjacent_expired": "ErrHeaderExpired",
         "adjacent_from_the_future": "ErrInvalidHeader",
         "non_adjacent_untrusted_set": "ErrNewValSetCantBeTrusted",
         "non_adjacent_bad_signature": "ErrInvalidSignature", "stream_gap": "ErrInvalidHeader",
         "stream_wrong_chain": "ValueError", "stream_expired": "ErrHeaderExpired"}


@pytest.mark.parametrize("name", CASE_NAMES)
def test_outcome_matches_reference(chain, name):
    lbs, strangers = chain
    kind, blocks, now, want = _cases(lbs, strangers)[name]
    port, ref = _both(kind, blocks, now)
    assert port == ref
    if name in FAILS:
        assert ref is not None and ref[0] == FAILS[name], ref
    else:
        assert ref == want


def test_stream_on_the_device_route(chain, monkeypatch):
    """Each stream's lanes (20, then 16) in one batch through the plain
    versions of the ladder route (NATIVE_MAX = 0); a bad lane is named by
    its stream lane."""
    monkeypatch.setattr(E, "NATIVE_MAX", 0)
    monkeypatch.setattr(E, "_rlc_beats_ladder", lambda n, b, device: False)
    lbs, strangers = chain
    for name in ("stream", "stream_bad_signature"):
        kind, blocks, now, want = _cases(lbs, strangers)[name]
        assert _both(kind, blocks, now) == [want, want]


def test_cuda_without_a_gpu_raises(chain, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lbs, _ = chain
    trusted, nxt = LightBlock.decode(lbs[1]), LightBlock.decode(lbs[2])
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        LV.verify_stream(CHAIN, trusted, [nxt], PERIOD_S, Timestamp(*_now(lbs, 6)))
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        LV.verify_adjacent(CHAIN, trusted.signed_header, nxt.signed_header, nxt.validators,
                           PERIOD_S, Timestamp(*_now(lbs, 6)))
