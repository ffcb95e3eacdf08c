"""Blocks: Header, Commit, CommitSig, Data.

Hash rules (behavior parity with reference types/block.go):
- Header.Hash = merkle over the 14 proto-encoded header fields, primitives
  wrapped in gogo wrapper messages (reference types/block.go:438-473 +
  types/encoding_helper.go cdcEncode); empty primitives hash as nil leaves.
- Commit.Hash = merkle over proto-encoded CommitSigs (types/block.go:835).
- Data.Hash = merkle over SHA-256 tx hashes (types/tx.go Txs.Hash).
- Commit.VoteSignBytes rebuilds the canonical precommit each signer signed
  (types/block.go:879): per-validator timestamp and flag-dependent BlockID.

The port's own copy of `cometbft_tpu/types/block.py`. `Commit.decode`
parses through the port's native `commit_parse` and `vote_sign_bytes_blob`
builds through its `commit_sign_bytes` (`crypto/native.py`). Not ported:
certificate-native commits (`types/agg_commit.py::CertCommit`);
`decode_commit_any` raises UnsupportedCommitFormat for them. A block's
evidence decodes through `types/evidence.py::decode_evidence`.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

from ..crypto import merkle
from ..crypto.keys import tmhash
from ..encoding import proto as pb
from .basic import BlockID, Timestamp, ZERO_BLOCK_ID, ZERO_TIME
from .vote import SignedMsgType

MAX_HEADER_BYTES = 660  # 626 reference fields + the 34-byte da_root leaf
BLOCK_PART_SIZE_BYTES = 65536  # reference types/part_set.go BlockPartSizeBytes


class BlockIDFlag(enum.IntEnum):
    UNKNOWN = 0
    ABSENT = 1
    COMMIT = 2
    NIL = 3


# IntEnum.__call__ is slow; the columnar decode loop looks flags up here
# (misses fall through to the constructor, which raises for bad values)
_FLAG_CACHE = {f.value: f for f in BlockIDFlag}


def _wrap_string(s: str) -> bytes:
    return pb.f_string(1, s) if s else b""


def _wrap_int64(v: int) -> bytes:
    return pb.f_varint(1, v) if v else b""


def _wrap_bytes(b: bytes) -> bytes:
    return pb.f_bytes(1, b) if b else b""


@dataclass(frozen=True)
class Consensus:
    """Version info (reference proto cometbft/version/v1 Consensus)."""

    block: int = 11  # reference version/version.go BlockProtocol
    app: int = 0

    def encode(self) -> bytes:
        return pb.f_varint(1, self.block) + pb.f_varint(2, self.app)

    @classmethod
    def decode(cls, buf: bytes) -> "Consensus":
        d = pb.fields_to_dict(buf)
        return cls(int(d.get(1, 0)), int(d.get(2, 0)))


@dataclass
class Header:
    version: Consensus = field(default_factory=Consensus)
    chain_id: str = ""
    height: int = 0
    time: Timestamp = ZERO_TIME
    last_block_id: BlockID = ZERO_BLOCK_ID
    last_commit_hash: bytes = b""
    data_hash: bytes = b""
    validators_hash: bytes = b""
    next_validators_hash: bytes = b""
    consensus_hash: bytes = b""
    app_hash: bytes = b""
    last_results_hash: bytes = b""
    evidence_hash: bytes = b""
    proposer_address: bytes = b""
    # DA extension (da/commit.py): root of the erasure-coded chunk
    # commitment; empty when DA is disabled — and then it contributes
    # neither a hash leaf nor wire bytes, so legacy headers stay
    # bit-identical
    da_root: bytes = b""

    def hash(self) -> bytes | None:
        if not self.validators_hash:
            return None
        leaves = [
            self.version.encode(),
            _wrap_string(self.chain_id),
            _wrap_int64(self.height),
            self.time.encode(),
            self.last_block_id.encode(),
            _wrap_bytes(self.last_commit_hash),
            _wrap_bytes(self.data_hash),
            _wrap_bytes(self.validators_hash),
            _wrap_bytes(self.next_validators_hash),
            _wrap_bytes(self.consensus_hash),
            _wrap_bytes(self.app_hash),
            _wrap_bytes(self.last_results_hash),
            _wrap_bytes(self.evidence_hash),
            _wrap_bytes(self.proposer_address),
        ]
        if self.da_root:
            leaves.append(_wrap_bytes(self.da_root))
        return merkle.hash_from_byte_slices(leaves)

    def encode(self) -> bytes:
        return (
            pb.f_embedded(1, self.version.encode())
            + pb.f_string(2, self.chain_id)
            + pb.f_varint(3, self.height)
            + pb.f_embedded(4, self.time.encode())
            + pb.f_embedded(5, self.last_block_id.encode())
            + pb.f_bytes(6, self.last_commit_hash)
            + pb.f_bytes(7, self.data_hash)
            + pb.f_bytes(8, self.validators_hash)
            + pb.f_bytes(9, self.next_validators_hash)
            + pb.f_bytes(10, self.consensus_hash)
            + pb.f_bytes(11, self.app_hash)
            + pb.f_bytes(12, self.last_results_hash)
            + pb.f_bytes(13, self.evidence_hash)
            + pb.f_bytes(14, self.proposer_address)
            + pb.f_bytes(15, self.da_root)
        )

    @classmethod
    def decode(cls, buf: bytes) -> "Header":
        d = pb.fields_to_dict(buf)
        return cls(
            version=Consensus.decode(pb.as_bytes(d.get(1, b""))),
            chain_id=pb.as_bytes(d.get(2, b"")).decode("utf-8"),
            height=pb.to_i64(d.get(3, 0)),
            time=Timestamp.decode(pb.as_bytes(d.get(4, b""))),
            last_block_id=BlockID.decode(pb.as_bytes(d.get(5, b""))),
            last_commit_hash=pb.as_bytes(d.get(6, b"")),
            data_hash=pb.as_bytes(d.get(7, b"")),
            validators_hash=pb.as_bytes(d.get(8, b"")),
            next_validators_hash=pb.as_bytes(d.get(9, b"")),
            consensus_hash=pb.as_bytes(d.get(10, b"")),
            app_hash=pb.as_bytes(d.get(11, b"")),
            last_results_hash=pb.as_bytes(d.get(12, b"")),
            evidence_hash=pb.as_bytes(d.get(13, b"")),
            proposer_address=pb.as_bytes(d.get(14, b"")),
            da_root=pb.as_bytes(d.get(15, b"")),
        )


@dataclass
class CommitSig:
    """One validator's slot in a commit (reference types/block.go:594)."""

    block_id_flag: BlockIDFlag = BlockIDFlag.ABSENT
    validator_address: bytes = b""
    timestamp: Timestamp = ZERO_TIME
    signature: bytes = b""

    @classmethod
    def absent(cls) -> "CommitSig":
        return cls()

    def is_absent(self) -> bool:
        return self.block_id_flag == BlockIDFlag.ABSENT

    def is_commit(self) -> bool:
        return self.block_id_flag == BlockIDFlag.COMMIT

    def for_block(self) -> bool:
        return self.block_id_flag == BlockIDFlag.COMMIT

    def effective_block_id(self, commit_block_id: BlockID) -> BlockID:
        """The BlockID this slot's vote was cast for
        (reference types/block.go CommitSig.BlockID)."""
        if self.block_id_flag == BlockIDFlag.COMMIT:
            return commit_block_id
        return ZERO_BLOCK_ID

    def encode(self) -> bytes:
        return (
            pb.f_varint(1, int(self.block_id_flag))
            + pb.f_bytes(2, self.validator_address)
            + pb.f_embedded(3, self.timestamp.encode())
            + pb.f_bytes(4, self.signature)
        )

    @classmethod
    def decode(cls, buf: bytes) -> "CommitSig":
        d = pb.fields_to_dict(buf)
        return cls(
            block_id_flag=BlockIDFlag(int(d.get(1, 0))),
            validator_address=pb.as_bytes(d.get(2, b"")),
            timestamp=Timestamp.decode(pb.as_bytes(d.get(3, b""))),
            signature=pb.as_bytes(d.get(4, b"")),
        )

    @classmethod
    def _decode_span(cls, buf: bytes, i: int, end: int) -> "CommitSig":
        """Decode from buf[i:end] without slicing out sub-buffers: a
        commit carries one of these per validator and the generic
        dict-of-fields walk was replay's single largest host cost."""
        rv = pb.read_uvarint
        flag = 0
        addr = b""
        ts_s = 0  # bug-compatible with the generic decoder's absent-field default
        ts_n = 0
        sig = b""
        while i < end:
            tag, i = rv(buf, i)
            f, wt = tag >> 3, tag & 7
            if wt == 0:
                v, i = rv(buf, i)
                # a varint must not run past the span into the next
                # field (the generic decoder's sub-buffer slice raised
                # here; match it)
                if i > end:
                    raise ValueError("truncated varint in CommitSig")
                if f == 1:
                    flag = v
            elif wt == 2:
                ln, i = rv(buf, i)
                j = i + ln
                if j > end or i > end:
                    raise ValueError("truncated commit sig field")
                if f == 2:
                    addr = buf[i:j]
                elif f == 4:
                    sig = buf[i:j]
                elif f == 3:
                    while i < j:
                        t2, i = rv(buf, i)
                        if t2 & 7 != 0:
                            raise ValueError("bad timestamp wire type")
                        v2, i = rv(buf, i)
                        if i > j:
                            raise ValueError("truncated timestamp varint")
                        if t2 >> 3 == 1:
                            ts_s = pb.to_i64(v2)
                        elif t2 >> 3 == 2:
                            ts_n = pb.to_i64(v2)
                i = j
            else:
                raise ValueError(f"unsupported wire type {wt} in CommitSig")
        if i > end:
            raise ValueError("truncated varint in CommitSig")
        return cls(
            block_id_flag=BlockIDFlag(flag),
            validator_address=addr,
            timestamp=Timestamp(ts_s, ts_n),
            signature=sig,
        )


class _LazySigList:
    """CommitSig list materialized on first ELEMENT access.

    Natively-decoded commits carry columnar views (Commit.verify_columns)
    that the batched replay path consumes directly; building 1000
    CommitSig objects per block cost more than the wire parse itself.
    Length/truthiness never materialize (validate_block's size checks
    stay free); iteration, indexing, and equality build the real list
    once and delegate."""

    __slots__ = ("_n", "_mk", "_real")

    def __init__(self, n: int, mk):
        self._n = n
        self._mk = mk
        self._real = None

    def _mat(self) -> list:
        if self._real is None:
            self._real = self._mk()
            self._mk = None
        return self._real

    def __len__(self):
        return self._n

    def __bool__(self):
        return self._n > 0

    def __iter__(self):
        return iter(self._mat())

    def __getitem__(self, i):
        return self._mat()[i]

    def __eq__(self, other):
        if isinstance(other, _LazySigList):
            other = other._mat()
        if isinstance(other, list):
            return self._mat() == other
        return NotImplemented

    def __repr__(self):
        return repr(self._mat())


@dataclass
class Commit:
    """+2/3 precommit evidence for a block (reference types/block.go:835)."""

    height: int = 0
    round: int = 0
    block_id: BlockID = ZERO_BLOCK_ID
    signatures: list[CommitSig] = field(default_factory=list)

    def hash(self) -> bytes:
        # memoized: commits are immutable once decoded/sealed, and block
        # validation re-merkles the predecessor's 100+ signatures per
        # height otherwise
        h = self.__dict__.get("_hash_memo")
        if h is None:
            # leaves are each slot's canonical encoding; a commit decoded
            # from bytes THIS node wrote (trusted_bytes) reuses the decode
            # spans — byte-identical to cs.encode() since our own encoder
            # produced them (wire-received commits never take this path:
            # a non-canonical adversarial encoding must not define the
            # hash)
            leaves = self.__dict__.get("_sig_spans")
            if leaves is None:
                leaves = [cs.encode() for cs in self.signatures]
            h = merkle.hash_from_byte_slices(leaves)
            self.__dict__["_hash_memo"] = h
        return h

    def size(self) -> int:
        return len(self.signatures)

    def _sb_parts(self, chain_id: str):
        """Commit-invariant sign-bytes parts (prefix variants + chain-id
        tail), cached per (Commit, chain_id)."""
        cache = self.__dict__.get("_sb_cache")
        if cache is None or cache[0] != chain_id:
            head = (
                pb.f_varint(1, int(SignedMsgType.PRECOMMIT))
                + pb.f_sfixed64(2, self.height)
                + pb.f_sfixed64(3, self.round)
            )
            cache = (
                chain_id,
                head + pb.f_embedded_opt(4, self.block_id.encode_canonical()),
                head + pb.f_embedded_opt(4, ZERO_BLOCK_ID.encode_canonical()),
                pb.f_string(6, chain_id),
            )
            self.__dict__["_sb_cache"] = cache
        return cache

    def vote_sign_bytes(self, chain_id: str, idx: int) -> bytes:
        """Rebuild the canonical precommit bytes validator idx signed
        (reference types/block.go:879).

        Byte-identical to canonical_vote_bytes; the commit-invariant
        prefix (type, height, round, block id) and suffix (chain id) are
        built once per Commit — verify_commit calls this for every
        validator and the per-call proto assembly was half its cost."""
        cs = self.signatures[idx]
        cache = self._sb_parts(chain_id)
        _, with_bid, nil_bid, tail = cache
        is_commit = cs.block_id_flag == BlockIDFlag.COMMIT
        key = (cache, is_commit, cs.timestamp)
        sb = cs.__dict__.get("_sb")
        if sb is not None and sb[0] == key and sb[0][0] is cache:
            return sb[1]
        prefix = with_bid if is_commit else nil_bid
        out = pb.length_prefixed(
            prefix + pb.f_embedded(5, cs.timestamp.encode()) + tail
        )
        # memo per CommitSig, keyed on the prefix-cache identity (which
        # changes whenever chain_id/height/round/block_id change) plus
        # the slot fields the bytes depend on: vote gossip and repeated
        # commit verification rebuild these bytes many times
        cs.__dict__["_sb"] = (key, out)
        return out

    def vote_sign_bytes_all(self, chain_id: str) -> list:
        """Sign bytes for every slot in one pass (None for absent).

        Byte-identical to vote_sign_bytes per index, minus the per-call
        memo machinery: window replay builds a hundred of these per
        block, where the per-slot work is just prefix + timestamp
        varints + tail."""
        if not self.signatures:
            return []
        _, with_bid, nil_bid, tail = self._sb_parts(chain_id)
        lp = pb.length_prefixed
        fv = pb.f_varint
        fe = pb.f_embedded
        commit_flag = BlockIDFlag.COMMIT
        absent_flag = BlockIDFlag.ABSENT
        out = []
        for cs in self.signatures:
            if cs.block_id_flag == absent_flag:
                out.append(None)
                continue
            ts = cs.timestamp
            prefix = with_bid if cs.block_id_flag == commit_flag else nil_bid
            out.append(
                lp(prefix + fe(5, fv(1, ts.seconds) + fv(2, ts.nanos)) + tail)
            )
        return out

    def verify_columns(self):
        """Columnar views for batch verification: (flags u8, addrs
        (n,20) u8, addr_lens u8, sig_lens u8, sigs (n,64) u8, ts_s i64,
        ts_n i64) numpy arrays, or None when this commit was not decoded through
        the native columnar parser (wire/store decode is the replay
        path; hand-built commits take the per-slot path)."""
        cols = self.__dict__.get("_cols")
        if cols is None:
            return None
        import numpy as np

        n, flags, addr_lens, addrs, ts_s, ts_n, sig_lens, sigs = cols
        return (
            np.frombuffer(flags, np.uint8, n),
            np.frombuffer(addrs, np.uint8, n * 20).reshape(n, 20),
            np.frombuffer(addr_lens, np.uint8, n),
            np.frombuffer(sig_lens, np.uint8, n),
            np.frombuffer(sigs, np.uint8, n * 64).reshape(n, 64),
            np.frombuffer(ts_s, np.int64, n),
            np.frombuffer(ts_n, np.int64, n),
        )

    def vote_sign_bytes_blob(self, chain_id: str):
        """(msgs blob, lens uint32 array) covering every slot (absent
        slots have length 0), built in one native call from the decode
        columns — byte-identical to vote_sign_bytes per index. None
        when columns or the native lib are unavailable."""
        cols = self.__dict__.get("_cols")
        if cols is None:
            return None
        from ..crypto import native as _native

        import numpy as np

        n, flags, addr_lens, addrs, ts_s, ts_n, sig_lens, sigs = cols
        _, with_bid, nil_bid, tail = self._sb_parts(chain_id)
        return _native.commit_sign_bytes(
            n, np.frombuffer(flags, np.uint8, n),
            np.frombuffer(ts_s, np.int64, n),
            np.frombuffer(ts_n, np.int64, n),
            with_bid, nil_bid, tail,
        )

    def invalidate_memos(self) -> None:
        """Drop every derived-bytes memo (encode, hash, sign-bytes
        parts, decode columns, spans). Commits are immutable on every
        production path — decode, make_commit, and VoteSet.make_commit
        all seal before exposing — so only code that mutates a
        CommitSig in place afterwards (test factories, corruption
        harnesses) must call this, or stale memoized bytes will be
        served."""
        d = self.__dict__
        for k in ("_enc_memo", "_hash_memo", "_cols", "_sig_spans",
                  "_sb_cache"):
            d.pop(k, None)

    def encode(self) -> bytes:
        # memoized: commits are immutable once constructed (decode /
        # make_commit / VoteSet.make_commit all seal before exposing),
        # and the hot paths re-encode them constantly — every
        # save_block, gossip frame, and embedded LastCommit encodes the
        # same 1000-signature list again. In-place mutators must call
        # invalidate_memos().
        memo = self.__dict__.get("_enc_memo")
        if memo is not None:
            return memo
        out = (
            pb.f_varint(1, self.height)
            + pb.f_varint(2, self.round)
            + pb.f_embedded(3, self.block_id.encode())
        )
        for cs in self.signatures:
            out += pb.f_embedded(4, cs.encode())
        self.__dict__["_enc_memo"] = out
        return out

    @classmethod
    def decode(cls, buf: bytes, trusted_bytes: bool = False) -> "Commit":
        # columnar fast path: one C call parses the whole signature list
        # (csrc/commit_codec.inc); Python only materializes the objects.
        # Falls through to the pure-Python walk when the native lib is
        # absent or the wire shape needs its exact error behavior.
        from ..crypto import native as _native

        parsed = _native.commit_parse(buf) if _native.available() else None
        if parsed is not None:
            h_u64, r_u64, bid_span, cols = parsed
            n, flags, addr_lens, addrs, ts_s, ts_n, sig_lens, sigs, spans = cols
            # flag validation must stay DECODE-time even though the
            # CommitSig objects are lazy: the pure-Python walk raises
            # ValueError on an out-of-range flag while parsing, and
            # native/non-native builds must reject identical bytes
            # identically (test_commit_codec_diff pins this)
            if n and max(flags[:n]) > 3:
                raise ValueError(
                    f"{max(flags[:n])} is not a valid BlockIDFlag"
                )

            def _mk_sigs():
                sig_list = []
                flag_cache = _FLAG_CACHE
                flag_of = BlockIDFlag
                ts_of = Timestamp
                cs_of = CommitSig
                for i in range(n):
                    a0 = i * 20
                    s0 = i * 64
                    fv = flags[i]
                    fl = flag_cache.get(fv)
                    if fl is None:  # UNKNOWN(0) is falsy; don't use `or`
                        fl = flag_of(fv)
                    sig_list.append(
                        cs_of(
                            fl,
                            addrs[a0 : a0 + addr_lens[i]],
                            ts_of(ts_s[i], ts_n[i]),
                            sigs[s0 : s0 + sig_lens[i]],
                        )
                    )
                return sig_list

            spans_out = None
            if trusted_bytes:
                spans_out = [
                    buf[spans[2 * i] : spans[2 * i] + spans[2 * i + 1]]
                    for i in range(n)
                ]
            bid_off, bid_len = bid_span
            commit = cls(
                pb.to_i64(h_u64),
                pb.to_i64(r_u64),
                BlockID.decode(buf[bid_off : bid_off + bid_len])
                if bid_len or bid_off
                else ZERO_BLOCK_ID,
                _LazySigList(n, _mk_sigs),
            )
            if spans_out is not None:
                commit.__dict__["_sig_spans"] = spans_out
            # stash the columnar views for the batch-verify fast path
            # (replay verifies 1000-signature commits; re-extracting
            # per-CommitSig fields there costs more than the decode)
            commit.__dict__["_cols"] = (
                n, flags, addr_lens, addrs, ts_s, ts_n, sig_lens, sigs
            )
            return commit
        # specialized walk (one pass, no per-sig sub-buffer dicts): the
        # signature list dominates and replay decodes one commit per
        # block. trusted_bytes (store-loaded only) additionally stashes
        # each slot's wire span as its canonical encoding for hash()
        height = round_ = 0
        block_id = ZERO_BLOCK_ID
        sigs = []
        spans = [] if trusted_bytes else None
        rv = pb.read_uvarint
        i, n = 0, len(buf)
        while i < n:
            tag, i = rv(buf, i)
            f, wt = tag >> 3, tag & 7
            if wt == 0:
                v, i = rv(buf, i)
                if f == 1:
                    height = pb.to_i64(v)
                elif f == 2:
                    round_ = pb.to_i64(v)
            elif wt == 2:
                ln, i = rv(buf, i)
                j = i + ln
                if j > n:
                    raise ValueError("truncated commit field")
                if f == 4:
                    sigs.append(CommitSig._decode_span(buf, i, j))
                    if spans is not None:
                        spans.append(buf[i:j])
                elif f == 3:
                    block_id = BlockID.decode(buf[i:j])
                i = j
            else:
                raise ValueError(f"unsupported wire type {wt} in Commit")
        commit = cls(height, round_, block_id, sigs)
        if spans is not None:
            commit.__dict__["_sig_spans"] = spans
        return commit


class UnsupportedCommitFormat(ValueError):
    """A certificate-native commit (BLS aggregate, `CertCommit`): the port
    has no verifier for it, so it decodes none."""


def decode_commit_any(buf: bytes, trusted_bytes: bool = False) -> Commit:
    """One decode path for both commit formats (reference
    types/agg_commit.py decode_commit_any): plain Commits and CertCommits
    share field slots 1-3, so a top-level tag scan picks the decoder —
    field 4 (per-slot column) => Commit, fields 5-8 => CertCommit, which
    raises UnsupportedCommitFormat here, neither => Commit."""
    rv = pb.read_uvarint
    i, n = 0, len(buf)
    while i < n:
        tag, i = rv(buf, i)
        f, wt = tag >> 3, tag & 7
        if f >= 4:
            if f == 4:
                return Commit.decode(buf, trusted_bytes=trusted_bytes)
            raise UnsupportedCommitFormat(
                f"certificate-native commit (field {f}): CertCommit is not ported")
        if wt == 0:
            _, i = rv(buf, i)
        elif wt == 2:
            ln, i = rv(buf, i)
            i += ln
        elif wt == 1:
            i += 8
        elif wt == 5:
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wt} in commit")
    return Commit.decode(buf, trusted_bytes=trusted_bytes)

def tx_hash(tx: bytes) -> bytes:
    return tmhash(tx)


def block_id_for(block: "Block") -> BlockID:
    """Canonical BlockID: header hash + part-set header over the block bytes
    (reference types/block.go MakePartSet + BlockID).

    Memoized per Block instance: callers compute the id of a COMPLETE
    block (decoded from the store/wire or finalized by consensus), and
    replay/validation would otherwise re-encode + re-merkle the same
    ~10 KB block three times per height."""
    memo = block.__dict__.get("_bid_memo")
    if memo is not None:
        return memo
    from .part_set import PartSet

    # blocks decoded with trusted_bytes=True carry their own canonical
    # store bytes; encode() itself stays memo-free so post-decode
    # mutations (e.g. re-saving an edited block) always re-encode
    enc = block.__dict__.get("_enc_memo")
    if enc is None:
        enc = block.encode()
    ps = PartSet.from_data(enc)
    bid = BlockID(block.hash(), ps.header)
    block.__dict__["_bid_memo"] = bid
    return bid


@dataclass
class Data:
    txs: list[bytes] = field(default_factory=list)

    def hash(self) -> bytes:
        # columnar fast path (mempool/txcolumns.py): the batch memoizes
        # its per-tx hash column — bit-identical leaves, merkle unchanged
        hashes = getattr(self.txs, "tx_hashes", None)
        if hashes is not None:
            return merkle.hash_from_byte_slices(hashes())
        return merkle.hash_from_byte_slices([tx_hash(t) for t in self.txs])

    def encode(self) -> bytes:
        # columnar fast path: the batch memoizes the exact repeated
        # f_bytes(1, tx, emit_empty=True) payload this loop produces
        enc = getattr(self.txs, "encode_data", None)
        if enc is not None:
            return enc()
        out = b""
        for t in self.txs:
            out += pb.f_bytes(1, t, emit_empty=True)
        return out

    @classmethod
    def decode(cls, buf: bytes) -> "Data":
        return cls([pb.as_bytes(v) for f, _, v in pb.parse_fields(buf) if f == 1])


@dataclass
class Block:
    header: Header
    data: Data = field(default_factory=Data)
    evidence: list = field(default_factory=list)
    last_commit: Commit = field(default_factory=Commit)

    def hash(self) -> bytes | None:
        return self.header.hash()

    def encode(self) -> bytes:
        # EvidenceList: repeated oneof-wrapped Evidence (field 1)
        ev_payload = b"".join(pb.f_embedded(1, ev.wrapped()) for ev in self.evidence)
        return (
            pb.f_embedded(1, self.header.encode())
            + pb.f_embedded(2, self.data.encode())
            + pb.f_embedded(3, ev_payload)
            + pb.f_embedded_opt(4, self.last_commit.encode() if self.last_commit else None)
        )

    @classmethod
    def decode(cls, buf: bytes, trusted_bytes: bool = False) -> "Block":
        """trusted_bytes=True stashes `buf` as the encode memo — ONLY
        for bytes this node wrote itself (the block store): re-encoding
        for BlockID/part-set work then reuses them. Wire-received bytes
        must never be trusted here (a non-canonical adversarial encoding
        would define this node's BlockID).

        Raises UnsupportedCommitFormat when its last commit is a
        CertCommit."""
        from .evidence import decode_evidence

        d = pb.fields_to_dict(buf)
        evidence = []
        for f, _, v in pb.parse_fields(pb.as_bytes(d.get(3, b""))):
            if f == 1:
                evidence.append(decode_evidence(pb.as_bytes(v)))
        blk = cls(
            header=Header.decode(pb.as_bytes(d.get(1, b""))),
            data=Data.decode(pb.as_bytes(d.get(2, b""))),
            evidence=evidence,
            last_commit=(
                decode_commit_any(
                    pb.as_bytes(d.get(4, b"")), trusted_bytes=trusted_bytes
                )
                if 4 in d
                else Commit()
            ),
        )
        if trusted_bytes:
            blk.__dict__["_enc_memo"] = bytes(buf)
        return blk
