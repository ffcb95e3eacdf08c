"""JSON -> core types: the inverse of the route encoders in routes.py.

The light client's HTTP provider rebuilds Header/Commit/ValidatorSet
from RPC JSON and re-derives every hash itself — nothing from the wire
is trusted until the recomputed hashes and signatures check out
(reference light/provider/http parses rpc types the same way).

Twin of `cometbft_tpu/rpc/codec.py`, Ed25519 keys only.
"""

from __future__ import annotations

from ..types import Timestamp
from ..types.basic import BlockID, PartSetHeader
from ..types.block import BlockIDFlag, Commit, CommitSig, Consensus, Header
from ..types.validator_set import UnsupportedKeyType, Validator, ValidatorSet


def _hb(s: str | None) -> bytes:
    return bytes.fromhex(s) if s else b""


def _time_from_json(d: dict) -> Timestamp:
    return Timestamp(int(d.get("seconds", 0)), int(d.get("nanos", 0)))


def block_id_from_json(d: dict) -> BlockID:
    parts = d.get("parts") or {}
    return BlockID(
        hash=_hb(d.get("hash")),
        part_set_header=PartSetHeader(
            int(parts.get("total", 0)), _hb(parts.get("hash"))
        ),
    )


def header_from_json(d: dict) -> Header:
    ver = d.get("version") or {}
    return Header(
        version=Consensus(int(ver.get("block", 0)), int(ver.get("app", 0))),
        chain_id=d.get("chain_id", ""),
        height=int(d.get("height", 0)),
        time=_time_from_json(d.get("time") or {}),
        last_block_id=block_id_from_json(d.get("last_block_id") or {}),
        last_commit_hash=_hb(d.get("last_commit_hash")),
        data_hash=_hb(d.get("data_hash")),
        validators_hash=_hb(d.get("validators_hash")),
        next_validators_hash=_hb(d.get("next_validators_hash")),
        consensus_hash=_hb(d.get("consensus_hash")),
        app_hash=_hb(d.get("app_hash")),
        last_results_hash=_hb(d.get("last_results_hash")),
        evidence_hash=_hb(d.get("evidence_hash")),
        proposer_address=_hb(d.get("proposer_address")),
        da_root=_hb(d.get("da_root")),
    )


def commit_from_json(d: dict) -> Commit:
    return Commit(
        height=int(d.get("height", 0)),
        round=int(d.get("round", 0)),
        block_id=block_id_from_json(d.get("block_id") or {}),
        signatures=[
            CommitSig(
                block_id_flag=BlockIDFlag(int(s.get("block_id_flag", 0))),
                validator_address=_hb(s.get("validator_address")),
                timestamp=_time_from_json(s.get("timestamp") or {}),
                signature=_hb(s.get("signature")),
            )
            for s in d.get("signatures", [])
        ],
    )


def pub_key_from_json(type_tag: str, raw: bytes):
    """An Ed25519 key; a secp256k1 or sr25519 key raises
    UnsupportedKeyType naming its type, as `decode_pub_key` does (the
    reference builds those keys)."""
    if "Secp256k1" in type_tag or "Sr25519" in type_tag:
        raise UnsupportedKeyType(
            f"unsupported key type {type_tag}: the port verifies ed25519 only")
    from ..crypto.ed25519 import Ed25519PubKey

    return Ed25519PubKey(raw)


def validator_set_from_json(d: dict) -> ValidatorSet:
    vals = []
    for v in d.get("validators", []):
        pk = pub_key_from_json(
            v.get("pub_key_type", "tendermint/PubKeyEd25519"),
            _hb(v.get("pub_key")),
        )
        vals.append(
            Validator(
                address=_hb(v.get("address")),
                pub_key=pk,
                voting_power=int(v.get("voting_power", 0)),
                proposer_priority=int(v.get("proposer_priority", 0)),
            )
        )
    return ValidatorSet(vals)
