"""File-backed private validator with double-sign protection.

Behavior parity: reference privval/file.go —
- FilePVKey / FilePVLastSignState split across two files (:38,74): the key
  file is written once; the state file is rewritten (atomically) before
  every signature leaves the signer.
- CheckHRS (:99): refuse any (height, round, step) regression; for the same
  HRS, only re-serve the exact previous signature.
- signVote/signProposal (:306,341): if the new sign-bytes differ from the
  last signed bytes ONLY in the timestamp, re-serve the previous signature
  with the previous timestamp (:428 checkVotesOnlyDifferByTimestamp);
  anything else at the same HRS is a double-sign attempt and is refused.

The "sign bytes without timestamp" comparison re-encodes the canonical
message with the previous timestamp rather than regex-stripping fields —
same outcome as the reference's proto-unmarshal/zero/remarshal dance.

Twin of `cometbft_tpu/privval/file_pv.py`, Ed25519 only: the key and
state files are the reference's, byte for byte, and load in either
package; a key file of type secp256k1 or BLS raises UnsupportedKeyType
(the port signs and verifies Ed25519 alone).
"""

from __future__ import annotations

import enum
import json
import os
import tempfile
from dataclasses import dataclass

from ..crypto.ed25519 import Ed25519PrivKey, Ed25519PubKey
from ..crypto.keys import PrivKey, PubKey
from ..types.basic import Timestamp
from ..types.validator_set import UnsupportedKeyType
from ..types.vote import (
    SignedMsgType,
    canonical_proposal_bytes,
    canonical_vote_bytes,
)


class DoubleSignError(Exception):
    pass


class SignStep(enum.IntEnum):
    NONE = 0
    PROPOSE = 1
    PREVOTE = 2
    PRECOMMIT = 3


_PRECOMMIT_TYPE = SignedMsgType.PRECOMMIT


def _priv_key_class(key_type: str):
    """Key-file "key_type" tag -> PrivKey class. Ed25519 is the default
    (and the tag older key files lack); the reference's secp256k1 and BLS
    tags are refused by name."""
    if key_type in ("tendermint/PubKeyBls12_381", "tendermint/PubKeySecp256k1"):
        raise UnsupportedKeyType(f"no signer for key type {key_type} in the port")
    return Ed25519PrivKey


_VOTE_TO_STEP = {
    SignedMsgType.PREVOTE: SignStep.PREVOTE,
    SignedMsgType.PRECOMMIT: SignStep.PRECOMMIT,
}


@dataclass
class _LastSignState:
    height: int = 0
    round: int = 0
    step: int = 0
    signature: bytes = b""
    sign_bytes: bytes = b""

    def check_hrs(self, height: int, round_: int, step: int) -> bool:
        """True when (h, r, s) equals the last-signed HRS and a signature
        exists; raises on regression (reference CheckHRS :99)."""
        if self.height > height:
            raise DoubleSignError(f"height regression: {self.height} > {height}")
        if self.height == height:
            if self.round > round_:
                raise DoubleSignError(
                    f"round regression at height {height}: {self.round} > {round_}"
                )
            if self.round == round_:
                if self.step > step:
                    raise DoubleSignError(
                        f"step regression at {height}/{round_}: "
                        f"{self.step} > {step}"
                    )
                if self.step == step:
                    if not self.signature:
                        raise DoubleSignError("no signature saved for repeated HRS")
                    return True
        return False


class FilePV:
    """types.PrivValidator backed by key + state files."""

    def __init__(self, priv_key: PrivKey, key_path: str | None,
                 state_path: str | None):
        self._priv = priv_key
        self._key_path = key_path
        self._state_path = state_path
        self._lss = _LastSignState()
        if state_path and os.path.exists(state_path):
            self._lss = self._load_state(state_path)

    # ------------------------------------------------------------------
    @classmethod
    def generate(cls, key_path: str | None = None, state_path: str | None = None,
                 key_type: str = "tendermint/PubKeyEd25519") -> "FilePV":
        pv = cls(_priv_key_class(key_type).generate(), key_path, state_path)
        if key_path:
            pv._save_key()
        if state_path:
            pv._save_state()  # reference writes both files at gen time
        return pv

    @classmethod
    def load(cls, key_path: str, state_path: str) -> "FilePV":
        with open(key_path) as f:
            d = json.load(f)
        klass = _priv_key_class(d.get("key_type", "tendermint/PubKeyEd25519"))
        return cls(klass(bytes.fromhex(d["priv_key"])), key_path, state_path)

    def _save_key(self):
        pub = self._priv.pub_key()
        _atomic_write_json(self._key_path, {
            "address": pub.address().hex(),
            "pub_key": pub.bytes().hex(),
            "priv_key": self._priv.bytes().hex(),
            "key_type": self._priv.type_tag(),
        })

    @staticmethod
    def _load_state(path: str) -> _LastSignState:
        with open(path) as f:
            d = json.load(f)
        return _LastSignState(
            height=d["height"], round=d["round"], step=d["step"],
            signature=bytes.fromhex(d["signature"]),
            sign_bytes=bytes.fromhex(d["sign_bytes"]),
        )

    def _save_state(self):
        if self._state_path:
            _atomic_write_json(self._state_path, {
                "height": self._lss.height, "round": self._lss.round,
                "step": self._lss.step,
                "signature": self._lss.signature.hex(),
                "sign_bytes": self._lss.sign_bytes.hex(),
            })

    # ------------------------------------------------------------------
    def pub_key(self) -> PubKey:
        return self._priv.pub_key()

    def address(self) -> bytes:
        return self.pub_key().address()

    def sign_vote(self, chain_id: str, vote, sign_extension: bool = False) -> None:
        """Sign a Vote in place (reference signVote :306). With
        sign_extension (precommits while vote extensions are enabled) the
        extension gets its own signature over the canonical extension
        sign-bytes — double-sign protection covers only the vote itself,
        matching the reference (extensions are deterministic app data)."""
        self._sign_vote_inner(chain_id, vote)
        if (
            sign_extension
            and not vote.is_nil()
            and vote.type == _PRECOMMIT_TYPE
        ):
            vote.extension_signature = self._priv.sign(
                vote.extension_sign_bytes(chain_id)
            )

    def _sign_vote_inner(self, chain_id: str, vote) -> None:
        step = _VOTE_TO_STEP.get(vote.type)
        if step is None:
            raise ValueError(f"unknown vote type {vote.type}")
        sign_bytes = vote.sign_bytes(chain_id)
        same_hrs = self._lss.check_hrs(vote.height, vote.round, int(step))
        if same_hrs:
            if sign_bytes == self._lss.sign_bytes:
                vote.signature = self._lss.signature
                return
            prev_ts = _vote_timestamp_if_only_ts_differs(
                self._lss.sign_bytes, sign_bytes, chain_id, vote
            )
            if prev_ts is not None:
                vote.timestamp = prev_ts
                vote.signature = self._lss.signature
                return
            raise DoubleSignError(
                f"conflicting vote data at {vote.height}/{vote.round}/{step.name}"
            )
        sig = self._priv.sign(sign_bytes)
        self._lss = _LastSignState(
            vote.height, vote.round, int(step), sig, sign_bytes
        )
        self._save_state()
        vote.signature = sig

    def sign_proposal(self, chain_id: str, proposal) -> None:
        """Sign a Proposal in place (reference signProposal :341)."""
        sign_bytes = canonical_proposal_bytes(
            proposal.height, proposal.round, proposal.pol_round,
            proposal.block_id, proposal.timestamp, chain_id,
        )
        same_hrs = self._lss.check_hrs(
            proposal.height, proposal.round, int(SignStep.PROPOSE)
        )
        if same_hrs:
            if sign_bytes == self._lss.sign_bytes:
                proposal.signature = self._lss.signature
                return
            prev_ts = _proposal_timestamp_if_only_ts_differs(
                self._lss.sign_bytes, sign_bytes, chain_id, proposal
            )
            if prev_ts is not None:
                proposal.timestamp = prev_ts
                proposal.signature = self._lss.signature
                return
            raise DoubleSignError(
                f"conflicting proposal data at {proposal.height}/{proposal.round}"
            )
        sig = self._priv.sign(sign_bytes)
        self._lss = _LastSignState(
            proposal.height, proposal.round, int(SignStep.PROPOSE), sig, sign_bytes
        )
        self._save_state()
        proposal.signature = sig


def _atomic_write_json(path: str, obj) -> None:
    d = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".pv-")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(obj, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _parse_ts(sign_bytes: bytes, fnum: int) -> Timestamp | None:
    """Extract the Timestamp field from canonical sign-bytes
    (field 5 in CanonicalVote, field 6 in CanonicalProposal)."""
    from ..encoding import proto as pb

    _, n = pb.read_uvarint(sign_bytes, 0)
    d = pb.fields_to_dict(sign_bytes[n:])
    if fnum not in d:
        return None
    try:
        return Timestamp.decode(pb.as_bytes(d[fnum]))
    except Exception:
        return None


def _vote_timestamp_if_only_ts_differs(last_sb, new_sb, chain_id, vote):
    prev_ts = _parse_ts(last_sb, 5)
    if prev_ts is None:
        return None
    rebuilt = canonical_vote_bytes(
        vote.type, vote.height, vote.round, vote.block_id, prev_ts, chain_id
    )
    return prev_ts if rebuilt == last_sb else None


def _proposal_timestamp_if_only_ts_differs(last_sb, new_sb, chain_id, proposal):
    prev_ts = _parse_ts(last_sb, 6)
    if prev_ts is None:
        return None
    rebuilt = canonical_proposal_bytes(
        proposal.height, proposal.round, proposal.pol_round,
        proposal.block_id, prev_ts, chain_id,
    )
    return prev_ts if rebuilt == last_sb else None
