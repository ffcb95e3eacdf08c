"""Genesis document (reference types/genesis.go).

The chain's immutable boot config: chain id, genesis time, initial
validator set, consensus params, app state. JSON on disk like the
reference (genesis.json).

Twin of `cometbft_tpu/types/genesis.py`: the same JSON byte for byte.
A secp256k1 or BLS12-381 validator is read and written, but building a
validator set from it raises UnsupportedKeyType, as `decode_pub_key`
does: the port verifies Ed25519 only.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

from ..crypto.ed25519 import Ed25519PubKey

# Exact key-type -> pubkey size. The old check was a substring test
# ("Secp256k1 in type ? 33 : 32") that silently measured any future key
# type against ed25519's 32 bytes; BLS12-381's 48-byte G1 keys made it
# load-bearing to dispatch on the full tag.
PUB_KEY_SIZES = {
    "tendermint/PubKeyEd25519": 32,
    "tendermint/PubKeySecp256k1": 33,
    "tendermint/PubKeyBls12_381": 48,
}

BLS_KEY_TYPE = "tendermint/PubKeyBls12_381"


def _genesis_pub_key(gv):
    if gv.pub_key_type != "tendermint/PubKeyEd25519":
        raise UnsupportedKeyType(
            f"unsupported key type {gv.pub_key_type}: the port verifies "
            "ed25519 only")
    return Ed25519PubKey(gv.pub_key_bytes)


from .basic import Timestamp  # noqa: E402
from .validator_set import UnsupportedKeyType, Validator, ValidatorSet  # noqa: E402

MAX_CHAIN_ID_LEN = 50


@dataclass
class GenesisValidator:
    pub_key_bytes: bytes
    power: int
    name: str = ""
    pub_key_type: str = "tendermint/PubKeyEd25519"
    # BLS12-381 only: proof-of-possession over the pubkey bytes (rogue-key
    # defense for the aggregate path); checked at validator-set construction
    pop: bytes = b""


@dataclass
class GenesisDoc:
    chain_id: str
    genesis_time: Timestamp = field(default_factory=Timestamp)
    initial_height: int = 1
    validators: list[GenesisValidator] = field(default_factory=list)
    app_hash: bytes = b""
    app_state: bytes = b""
    # ConsensusParams (state.types) or None for the defaults — carried
    # in genesis.json like the reference (types/genesis.go
    # GenesisDoc.ConsensusParams), so e.g. vote-extension enablement
    # reaches process nodes through the boot document
    consensus_params: object | None = None

    def validate_basic(self) -> None:
        """reference types/genesis.go ValidateAndComplete."""
        if not self.chain_id:
            raise ValueError("genesis: empty chain id")
        if len(self.chain_id) > MAX_CHAIN_ID_LEN:
            raise ValueError(f"genesis: chain id longer than {MAX_CHAIN_ID_LEN}")
        if self.initial_height < 1:
            raise ValueError("genesis: initial_height must be >= 1")
        for gv in self.validators:
            if gv.power < 0:
                raise ValueError("genesis: negative validator power")
            want = PUB_KEY_SIZES.get(gv.pub_key_type)
            if want is None:
                # sr25519 keys sign votes but have no proto PublicKey
                # representation, so they cannot appear in validator
                # sets (matches reference crypto/encoding/codec.go)
                raise ValueError(
                    f"genesis: validator key type {gv.pub_key_type!r} "
                    "not supported in validator sets"
                )
            if len(gv.pub_key_bytes) != want:
                raise ValueError(
                    f"genesis: bad {gv.pub_key_type} pubkey size "
                    f"(want {want}, got {len(gv.pub_key_bytes)})"
                )
            if gv.pub_key_type == BLS_KEY_TYPE and not gv.pop:
                raise ValueError(
                    "genesis: BLS12-381 validator missing proof-of-"
                    "possession"
                )

    def validator_set(self) -> ValidatorSet:
        # the reference's BLS proof-of-possession gate is not needed:
        # _genesis_pub_key refuses every key but Ed25519
        return ValidatorSet(
            [
                Validator.from_pub_key(_genesis_pub_key(gv), gv.power)
                for gv in self.validators
            ]
        )

    # ------------------------------------------------------------------
    def to_json(self) -> str:
        d = {
            "chain_id": self.chain_id,
            "genesis_time": {
                "seconds": self.genesis_time.seconds,
                "nanos": self.genesis_time.nanos,
            },
            "initial_height": self.initial_height,
            "validators": [
                {
                    "pub_key": gv.pub_key_bytes.hex(),
                    "pub_key_type": gv.pub_key_type,
                    "power": gv.power,
                    "name": gv.name,
                    **({"pop": gv.pop.hex()} if gv.pop else {}),
                }
                for gv in self.validators
            ],
            "app_hash": self.app_hash.hex(),
            "app_state": self.app_state.hex(),
        }
        cp = self.consensus_params
        if cp is not None:
            d["consensus_params"] = {
                "block": {"max_bytes": cp.block.max_bytes,
                          "max_gas": cp.block.max_gas},
                "evidence": {
                    "max_age_num_blocks": cp.evidence.max_age_num_blocks,
                    "max_age_duration_ns": cp.evidence.max_age_duration_ns,
                    "max_bytes": cp.evidence.max_bytes,
                },
                "validator": {
                    "pub_key_types": list(cp.validator.pub_key_types),
                },
                "abci": {
                    "vote_extensions_enable_height":
                        cp.abci.vote_extensions_enable_height,
                },
            }
        return json.dumps(d, indent=2)

    @classmethod
    def from_json(cls, raw: str) -> "GenesisDoc":
        d = json.loads(raw)
        gd = cls(
            chain_id=d["chain_id"],
            genesis_time=Timestamp(
                d.get("genesis_time", {}).get("seconds", 0),
                d.get("genesis_time", {}).get("nanos", 0),
            ),
            initial_height=d.get("initial_height", 1),
            validators=[
                GenesisValidator(
                    bytes.fromhex(v["pub_key"]),
                    v["power"],
                    v.get("name", ""),
                    v.get("pub_key_type", "tendermint/PubKeyEd25519"),
                    bytes.fromhex(v.get("pop", "")),
                )
                for v in d.get("validators", [])
            ],
            app_hash=bytes.fromhex(d.get("app_hash", "")),
            app_state=bytes.fromhex(d.get("app_state", "")),
        )
        if "consensus_params" in d:
            # lazy import: state.types depends on this package
            from ..state.types import (
                ABCIParams, BlockParams, ConsensusParams, EvidenceParams,
                ValidatorParams,
            )

            def mk(param_cls, sd):
                # forward compatibility (same shape as Config.from_toml's
                # tolerant loader): a genesis written by a NEWER build may
                # carry param keys this build does not know — drop them
                # with a warning instead of raising TypeError at boot
                from dataclasses import fields as _fields

                known = {f.name for f in _fields(param_cls)}
                unknown = [k for k in sd if k not in known]
                if unknown:
                    from ..utils.log import logger

                    logger("genesis").warn(
                        "ignoring unknown consensus-param keys",
                        section=param_cls.__name__,
                        keys=",".join(sorted(unknown)),
                    )
                return param_cls(**{k: v for k, v in sd.items() if k in known})

            p = d["consensus_params"]
            bp, ep = p.get("block", {}), p.get("evidence", {})
            vp, ap = p.get("validator", {}), p.get("abci", {})
            gd.consensus_params = ConsensusParams(
                block=mk(BlockParams, bp),
                evidence=mk(EvidenceParams, ep),
                validator=ValidatorParams(
                    pub_key_types=tuple(vp["pub_key_types"])
                ) if vp.get("pub_key_types") else ValidatorParams(),
                abci=mk(ABCIParams, ap),
            )
        gd.validate_basic()
        return gd

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "GenesisDoc":
        with open(path) as f:
            return cls.from_json(f.read())
