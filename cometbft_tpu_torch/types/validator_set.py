"""Validators and the proposer-priority validator set.

Behavior parity with reference types/validator_set.go: ordering by
(voting power desc, address asc), proposer rotation via priority queue
(IncrementProposerPriority :116, rescale window :143, avg-centering :227),
merkle hash over SimpleValidator encodings (:348), and ABCI update
application with the -(P + P/8) new-validator priority penalty (:659).
Arithmetic is int64-clipped exactly like the reference (safeAddClip /
truncated division), since priorities are consensus-visible state.

The port's own copy of `cometbft_tpu/types/validator_set.py`, with the
proto ValidatorSet encoding of `cometbft_tpu/state/types.py`
(`encode_validator_set` / `decode_validator_set`). The port verifies
Ed25519 keys only: a secp256k1, sr25519 or BLS12-381 key is neither
encoded nor decoded (UnsupportedKeyType names its type).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..crypto import merkle
from ..crypto.keys import PubKey
from ..encoding import proto as pb

I64_MAX = (1 << 63) - 1
I64_MIN = -(1 << 63)
MAX_TOTAL_VOTING_POWER = I64_MAX // 8
PRIORITY_WINDOW_SIZE_FACTOR = 2


def _clip(v: int) -> int:
    return max(I64_MIN, min(I64_MAX, v))


def _trunc_div(a: int, b: int) -> int:
    """Go-style int64 division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


class UnsupportedKeyType(ValueError):
    """A public key of a type the port has no verifier for."""


# crypto.v1.PublicKey oneof fields the port does not decode
_OTHER_KEY_FIELDS = ((2, "secp256k1"), (3, "bls12_381"))


def encode_pub_key(pk: PubKey) -> bytes:
    """crypto.v1.PublicKey oneof, ed25519=1 (reference
    types/validator_set.py encode_pub_key; its secp256k1=2 and
    bls12_381=3 arms raise UnsupportedKeyType here)."""
    tag = pk.type_tag()
    if "Ed25519" in tag:
        return pb.f_bytes(1, pk.bytes(), emit_empty=True)
    raise UnsupportedKeyType(f"unsupported key type {tag}: the port verifies ed25519 only")


def decode_pub_key(fields: dict) -> PubKey:
    """Inverse of encode_pub_key from parsed proto fields {tag: bytes}.
    A secp256k1 or BLS12-381 key raises UnsupportedKeyType naming the
    type; the port must not decode a key it cannot verify."""
    from ..crypto.ed25519 import Ed25519PubKey

    if 1 in fields:
        return Ed25519PubKey(pb.as_bytes(fields[1]))
    for f, name in _OTHER_KEY_FIELDS:
        if f in fields:
            raise UnsupportedKeyType(
                f"unsupported key type {name}: the port verifies ed25519 only")
    raise ValueError("unknown public key oneof")


@dataclass
class Validator:
    address: bytes
    pub_key: PubKey
    voting_power: int
    proposer_priority: int = 0

    @classmethod
    def from_pub_key(cls, pk: PubKey, power: int) -> "Validator":
        return cls(pk.address(), pk, power)

    def simple_encode(self) -> bytes:
        """SimpleValidator proto (pubkey + power), the hashing encoding."""
        return pb.f_embedded(1, encode_pub_key(self.pub_key)) + pb.f_varint(
            2, self.voting_power
        )

    def compare_proposer_priority(self, other: "Validator") -> "Validator":
        if self.proposer_priority > other.proposer_priority:
            return self
        if self.proposer_priority < other.proposer_priority:
            return other
        if self.address < other.address:
            return self
        if self.address > other.address:
            return other
        raise ValueError("validators with equal addresses")

    def copy(self) -> "Validator":
        return Validator(
            self.address, self.pub_key, self.voting_power, self.proposer_priority
        )


def _sort_key(v: Validator):
    # voting power desc, then address asc
    return (-v.voting_power, v.address)


class ValidatorSet:
    """Ordered validator set with proposer rotation."""

    def __init__(self, validators: list[Validator], increment_first: bool = True):
        if not validators:
            raise ValueError("validator set must not be empty")
        vals = sorted((v.copy() for v in validators), key=_sort_key)
        addrs = [v.address for v in vals]
        if len(set(addrs)) != len(addrs):
            raise ValueError("duplicate validator address")
        self.validators: list[Validator] = vals
        self.proposer: Validator | None = None
        self._total_power: int | None = None
        self._addr_index: dict[bytes, int] | None = None
        self._frozen = False
        self.total_voting_power()  # validates the cap
        if increment_first:
            self.increment_proposer_priority(1)

    # --- queries ---

    def __len__(self) -> int:
        return len(self.validators)

    def total_voting_power(self) -> int:
        if self._total_power is None:
            total = 0
            for v in self.validators:
                total += v.voting_power
                if total > MAX_TOTAL_VOTING_POWER:
                    raise ValueError("total voting power exceeds cap")
            self._total_power = total
        return self._total_power

    def get_by_address(self, addr: bytes) -> tuple[int, Validator | None]:
        # O(1) address index (10k-validator light-trusting verification
        # does one lookup per signature; a linear scan would be O(N^2)).
        if self._addr_index is None:
            self._addr_index = {
                v.address: i for i, v in enumerate(self.validators)
            }
        i = self._addr_index.get(addr, -1)
        return (i, self.validators[i]) if i >= 0 else (-1, None)

    def get_by_index(self, idx: int) -> Validator | None:
        if 0 <= idx < len(self.validators):
            return self.validators[idx]
        return None

    def has_address(self, addr: bytes) -> bool:
        return self.get_by_address(addr)[0] >= 0

    def hash(self) -> bytes:
        # memoized: the hash covers only (pubkey, power) — membership
        # changes go through update_with_changeset (which invalidates);
        # proposer-priority churn doesn't affect it. Replay hashes the
        # same set once per block otherwise (~ms each at 100 vals).
        h = self.__dict__.get("_hash_memo")
        if h is None:
            h = merkle.hash_from_byte_slices(
                [v.simple_encode() for v in self.validators]
            )
            self.__dict__["_hash_memo"] = h
        return h

    def ed25519_columns(self):
        """(addr_rows (n,20) u8, pub_rows (n,32) u8, powers i64) numpy
        columns for the batch-verify fast path, or None when any key is
        not ed25519. Memoized — replay verifies the same frozen set for
        thousands of consecutive commits."""
        cols = self.__dict__.get("_ed_cols", False)
        if cols is not False:
            return cols
        import numpy as np

        cols = None
        try:
            pubs = []
            for v in self.validators:
                pk = v.pub_key
                if pk.type_tag() != "tendermint/PubKeyEd25519":
                    raise ValueError
                pubs.append(pk.bytes())
            n = len(self.validators)
            cols = (
                np.frombuffer(
                    b"".join(v.address for v in self.validators), np.uint8
                ).reshape(n, 20),
                np.frombuffer(b"".join(pubs), np.uint8).reshape(n, 32),
                np.asarray([v.voting_power for v in self.validators],
                           np.int64),
            )
        except ValueError:
            cols = None
        self.__dict__["_ed_cols"] = cols
        return cols

    def freeze(self) -> "ValidatorSet":
        """Seal the set against mutation. State snapshots share (alias)
        ValidatorSet objects instead of defensively copying; the safety
        convention is that every mutator operates on a private .copy()
        first. freeze() makes a convention violation fail loudly instead
        of silently corrupting historical sets."""
        self._frozen = True
        return self

    def _assert_mutable(self):
        if getattr(self, "_frozen", False):
            raise RuntimeError(
                "mutating a frozen ValidatorSet (aliased by a State "
                "snapshot) — call .copy() first"
            )

    def copy(self) -> "ValidatorSet":
        vs = ValidatorSet.__new__(ValidatorSet)
        vs.validators = [v.copy() for v in self.validators]
        vs.proposer = self.proposer.copy() if self.proposer else None
        vs._total_power = self._total_power
        vs._addr_index = None
        vs._frozen = False
        memo = self.__dict__.get("_hash_memo")
        if memo is not None:  # same membership -> same hash
            vs.__dict__["_hash_memo"] = memo
        return vs

    # --- proposer priority machinery ---

    def _compute_avg_priority(self) -> int:
        n = len(self.validators)
        s = sum(v.proposer_priority for v in self.validators)
        # Go big.Int Euclidean Div (floor for positive divisor)
        return s // n

    def _shift_by_avg(self):
        avg = self._compute_avg_priority()
        for v in self.validators:
            v.proposer_priority = _clip(v.proposer_priority - avg)

    def rescale_priorities(self, diff_max: int):
        self._assert_mutable()
        if diff_max <= 0:
            return
        prios = [v.proposer_priority for v in self.validators]
        diff = max(prios) - min(prios)
        if diff < 0:
            diff = -diff
        ratio = (diff + diff_max - 1) // diff_max
        if diff > diff_max:
            for v in self.validators:
                v.proposer_priority = _trunc_div(v.proposer_priority, ratio)

    def _increment_once(self) -> Validator:
        for v in self.validators:
            v.proposer_priority = _clip(v.proposer_priority + v.voting_power)
        mostest = self.validators[0]
        for v in self.validators[1:]:
            mostest = mostest.compare_proposer_priority(v)
        mostest.proposer_priority = _clip(
            mostest.proposer_priority - self.total_voting_power()
        )
        return mostest

    def increment_proposer_priority(self, times: int):
        self._assert_mutable()
        if times <= 0:
            raise ValueError("times must be positive")
        diff_max = PRIORITY_WINDOW_SIZE_FACTOR * self.total_voting_power()
        self.rescale_priorities(diff_max)
        self._shift_by_avg()
        proposer = None
        for _ in range(times):
            proposer = self._increment_once()
        self.proposer = proposer

    def get_proposer(self) -> Validator:
        if self.proposer is None:
            self.proposer = self._find_proposer()
        return self.proposer

    def _find_proposer(self) -> Validator:
        mostest = self.validators[0]
        for v in self.validators[1:]:
            mostest = mostest.compare_proposer_priority(v)
        return mostest

    def copy_increment_proposer_priority(self, times: int) -> "ValidatorSet":
        vs = self.copy()
        vs.increment_proposer_priority(times)
        return vs

    # --- updates (ABCI validator changes) ---

    def update_with_change_set(self, changes: list[Validator]):
        """Apply power updates / removals (power 0), reference :594-643.

        New validators enter with priority -(P' + P'>>3) where P' is
        tvpAfterUpdatesBeforeRemovals — the total power with all updates
        applied but removals NOT yet applied (reference verifyUpdates
        :423-455, computeNewPriorities :479); priorities are then rescaled
        into the window and recentered, in that order (:638-639).
        """
        self._assert_mutable()
        if not changes:
            return
        by_addr = {}
        for c in changes:
            if c.address in by_addr:
                raise ValueError("duplicate address in change set")
            if c.voting_power < 0:
                raise ValueError("negative voting power")
            by_addr[c.address] = c

        removals = {a for a, c in by_addr.items() if c.voting_power == 0}
        for a in removals:
            if not self.has_address(a):
                raise ValueError("removing non-existent validator")

        # tvp after updates, before removals (reference verifyUpdates):
        # old total plus the delta of every non-removal change.
        tvp_updates = self.total_voting_power()
        for a, c in by_addr.items():
            if c.voting_power == 0:
                continue
            _, old = self.get_by_address(a)
            tvp_updates += c.voting_power - (old.voting_power if old else 0)
        removed_power = sum(
            self.get_by_address(a)[1].voting_power for a in removals
        )
        if tvp_updates - removed_power > MAX_TOTAL_VOTING_POWER:
            raise ValueError("total voting power exceeds cap after update")

        kept = [v for v in self.validators if v.address not in removals]
        updated = []
        new_addrs = []
        for v in kept:
            c = by_addr.get(v.address)
            if c is not None and c.voting_power != 0:
                nv = v.copy()
                nv.voting_power = c.voting_power
                nv.pub_key = c.pub_key
                updated.append(nv)
            else:
                updated.append(v.copy())
        existing = {v.address for v in updated}
        for a, c in by_addr.items():
            if c.voting_power > 0 and a not in existing:
                nv = c.copy()
                updated.append(nv)
                new_addrs.append(a)

        if not updated:
            raise ValueError("applying changes would empty the validator set")

        penalty = -(tvp_updates + (tvp_updates >> 3))
        new_set = set(new_addrs)
        for v in updated:
            if v.address in new_set:
                v.proposer_priority = penalty

        self.validators = sorted(updated, key=_sort_key)
        self._total_power = None
        self._addr_index = None
        self.__dict__.pop("_hash_memo", None)
        self.__dict__.pop("_ed_cols", None)
        self.total_voting_power()
        # scale into the priority window, then center (reference order)
        self.rescale_priorities(
            PRIORITY_WINDOW_SIZE_FACTOR * self.total_voting_power()
        )
        self._shift_by_avg()


# ----- proto ValidatorSet (reference cometbft_tpu/state/types.py) -----


def _encode_validator(v: Validator) -> bytes:
    return (
        pb.f_bytes(1, v.address)
        + pb.f_embedded(2, encode_pub_key(v.pub_key))
        + pb.f_varint(3, v.voting_power)
        + pb.f_varint(4, v.proposer_priority)
    )


def _decode_validator(buf: bytes) -> Validator:
    d = pb.fields_to_dict(buf)
    key_fields = pb.fields_to_dict(pb.as_bytes(d.get(2, b"")))
    pk = decode_pub_key(key_fields)
    return Validator(
        address=pb.as_bytes(d.get(1, b"")),
        pub_key=pk,
        voting_power=pb.to_i64(d.get(3, 0)),
        proposer_priority=pb.to_i64(d.get(4, 0)),
    )


def encode_validator_set(vs: ValidatorSet) -> bytes:
    """cometbft.types.v1.ValidatorSet: validators (1), proposer address (2)."""
    out = b""
    for v in vs.validators:
        out += pb.f_embedded(1, _encode_validator(v))
    prop = vs.get_proposer()
    out += pb.f_bytes(2, prop.address)
    return out


def decode_validator_set(buf: bytes) -> ValidatorSet:
    vals = []
    prop_addr = b""
    for f, _, v in pb.parse_fields(buf):
        if f == 1:
            vals.append(_decode_validator(pb.as_bytes(v)))
        elif f == 2:
            prop_addr = pb.as_bytes(v)
    vs = ValidatorSet(vals, increment_first=False)
    # restore exact priorities (ValidatorSet() copies, order by power)
    if prop_addr:
        _, p = vs.get_by_address(prop_addr)
        vs.proposer = p
    return vs
