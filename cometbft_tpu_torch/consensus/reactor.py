"""Consensus reactor: per-peer state-aware gossip over p2p channels.

Twin of `cometbft_tpu/consensus/reactor.py`, without the certificate
half: the port has no `types/agg_commit.py` and no certificate-native
consensus, so there is no AggregateCommitMessage on field 10 to send.
`decode_consensus_msg` raises UnsupportedCommitFormat on field 10, and
`receive` drops such a frame and keeps the peer, as the state machine
drops a peer's certificate (the reference decodes it and hands it to
the state machine). Every other message is the reference's, byte for
byte.

Behavior parity: reference internal/consensus/reactor.go — the reactor
owns the State/Data/Vote channels (:152) and runs per-peer gossip
driven by each peer's advertised round state:

- NewRoundStep broadcasts on every step change (:455) update
  PeerState; HasVote (:525) marks individual votes seen.
- gossipDataRoutine (:567): the proposal and its block PARTS flow to
  peers at our height by bitmap difference; peers on earlier heights
  get parts of the committed block from the store (:683
  gossipDataForCatchup).
- gossipVotesRoutine (:735): votes flow by VoteSet-bitmap difference —
  current-round prevotes/precommits, POL prevotes, last-commit
  precommits for peers one height back, and stored commit signatures
  for peers further back (rs.Height >= prs.Height+2 -> LoadCommit).
- queryMaj23Routine (:893): same-height peers are periodically told
  which blocks we see +2/3 votes for; they answer with VoteSetBits
  bitmaps that prune the vote gossip difference.

Blocks never travel whole: the proposer splits them into 64 KiB merkle-
proved parts (types/part_set.py, reference types/part_set.go) and every
receiver reassembles + verifies against the proposal's PartSetHeader
before the state machine sees BlockBytes.
"""

from __future__ import annotations

import threading
import time

from ..encoding import proto as pb
from ..crypto import merkle
from ..p2p.conn import ChannelDescriptor
from ..p2p.switch import Reactor
from ..types import Proposal, Vote
from ..types.basic import BlockID, PartSetHeader
from ..types.part_set import PART_SIZE, Part, PartSet
from ..types.vote import SignedMsgType
from ..utils import trace
from ..utils.log import logger
from ..utils.metrics import p2p_metrics
from .state import ConsensusState, ProposalMessage, RoundStep, VoteMessage
from ..types.block import UnsupportedCommitFormat
from .wal import BlockBytesMessage, refuse_certificate

STATE_CHANNEL = 0x20
DATA_CHANNEL = 0x21
VOTE_CHANNEL = 0x22

# Largest validator set any peer-supplied vote index or bitmap may claim
# (reference MaxVotesCount = 10000); bounds HasVote indexes and the
# VoteSetBits bit_length so one message cannot force millions of marks.
MAX_VALIDATORS = 10_000

_log = logger("cons-reactor")


# ----------------------------------------------------------------------
# wire messages
# ----------------------------------------------------------------------
class NewRoundStepMessage:
    __slots__ = ("height", "round", "step", "last_commit_round")

    def __init__(self, height, round_, step, last_commit_round=-1):
        self.height = height
        self.round = round_
        self.step = step
        self.last_commit_round = last_commit_round


class HasVoteMessage:
    __slots__ = ("height", "round", "type", "index")

    def __init__(self, height, round_, type_, index):
        self.height = height
        self.round = round_
        self.type = type_
        self.index = index


class BlockPartMessage:
    __slots__ = ("height", "round", "part")

    def __init__(self, height, round_, part: Part):
        self.height = height
        self.round = round_
        self.part = part


class NewValidBlockMessage:
    """Advertises a known-valid block's part-set header (reference
    NewValidBlockMessage): lets peers verify parts for a block they have
    no proposal for (catchup / late joiners). Safety: the commit votes
    sign the BlockID, which includes this header — a forged header can
    never assemble into a committable block."""

    __slots__ = ("height", "round", "psh", "is_commit")

    def __init__(self, height, round_, psh: PartSetHeader, is_commit=False):
        self.height = height
        self.round = round_
        self.psh = psh
        self.is_commit = is_commit


class VoteSetMaj23Message:
    __slots__ = ("height", "round", "type", "block_id")

    def __init__(self, height, round_, type_, block_id):
        self.height = height
        self.round = round_
        self.type = type_
        self.block_id = block_id


class VoteSetBitsMessage:
    __slots__ = ("height", "round", "type", "block_id", "bits")

    def __init__(self, height, round_, type_, block_id, bits: int):
        self.height = height
        self.round = round_
        self.type = type_
        self.block_id = block_id
        self.bits = bits


def _encode_proof(p: merkle.Proof) -> bytes:
    out = (
        pb.f_varint(1, p.total)
        + pb.f_varint(2, p.index)
        + pb.f_bytes(3, p.leaf_hash)
    )
    for a in p.aunts:
        out += pb.f_bytes(4, a, emit_empty=True)
    return out


def _decode_proof(buf: bytes) -> merkle.Proof:
    aunts = []
    total = index = 0
    leaf = b""
    for f, _, v in pb.parse_fields(buf):
        if f == 1:
            total = pb.to_i64(v)
        elif f == 2:
            index = pb.to_i64(v)
        elif f == 3:
            leaf = pb.as_bytes(v)
        elif f == 4:
            aunts.append(pb.as_bytes(v))
    return merkle.Proof(total=total, index=index, leaf_hash=leaf, aunts=aunts)


def encode_consensus_msg(msg) -> bytes:
    if isinstance(msg, VoteMessage):
        return pb.f_embedded(1, msg.vote.encode())
    if isinstance(msg, ProposalMessage):
        return pb.f_embedded(2, msg.proposal.encode())
    if isinstance(msg, BlockBytesMessage):
        return pb.f_embedded(
            3,
            pb.f_varint(1, msg.height)
            + pb.f_varint(2, msg.round)
            + pb.f_bytes(3, msg.block_bytes),
        )
    if isinstance(msg, NewRoundStepMessage):
        return pb.f_embedded(
            4,
            pb.f_varint(1, msg.height)
            + pb.f_varint(2, msg.round)
            + pb.f_varint(3, int(msg.step))
            + pb.f_varint(4, msg.last_commit_round + 1),
        )
    if isinstance(msg, HasVoteMessage):
        return pb.f_embedded(
            5,
            pb.f_varint(1, msg.height)
            + pb.f_varint(2, msg.round)
            + pb.f_varint(3, int(msg.type))
            + pb.f_varint(4, msg.index + 1),
        )
    if isinstance(msg, BlockPartMessage):
        part = (
            pb.f_varint(1, msg.part.index + 1)
            + pb.f_bytes(2, msg.part.bytes_)
            + pb.f_embedded(3, _encode_proof(msg.part.proof))
        )
        return pb.f_embedded(
            6,
            pb.f_varint(1, msg.height)
            + pb.f_varint(2, msg.round)
            + pb.f_embedded(3, part),
        )
    if isinstance(msg, VoteSetMaj23Message):
        return pb.f_embedded(
            7,
            pb.f_varint(1, msg.height)
            + pb.f_varint(2, msg.round)
            + pb.f_varint(3, int(msg.type))
            + pb.f_embedded(4, msg.block_id.encode()),
        )
    if isinstance(msg, NewValidBlockMessage):
        return pb.f_embedded(
            9,
            pb.f_varint(1, msg.height)
            + pb.f_varint(2, msg.round)
            + pb.f_embedded(3, msg.psh.encode())
            + (pb.f_varint(4, 1) if msg.is_commit else b""),
        )
    if isinstance(msg, VoteSetBitsMessage):
        # bitmap travels as little-endian bytes: a varint caps out at 63
        # validators, real sets are larger (reference BitArray proto)
        nbytes = (msg.bits.bit_length() + 7) // 8 or 1
        return pb.f_embedded(
            8,
            pb.f_varint(1, msg.height)
            + pb.f_varint(2, msg.round)
            + pb.f_varint(3, int(msg.type))
            + pb.f_embedded(4, msg.block_id.encode())
            + pb.f_bytes(5, msg.bits.to_bytes(nbytes, "little")),
        )
    raise TypeError(f"unsupported consensus message {type(msg)}")


def decode_consensus_msg(buf: bytes):
    fields = pb.parse_fields(buf)
    if not fields:
        raise ValueError("empty consensus message")
    fnum, _, v = fields[0]
    v = pb.as_bytes(v)
    d = pb.fields_to_dict(v) if fnum != 1 and fnum != 2 else None
    if fnum == 1:
        return VoteMessage(Vote.decode(v))
    if fnum == 2:
        return ProposalMessage(Proposal.decode(v))
    if fnum == 3:
        return BlockBytesMessage(
            pb.to_i64(d.get(1, 0)), pb.to_i64(d.get(2, 0)), pb.as_bytes(d.get(3, b""))
        )
    if fnum == 4:
        return NewRoundStepMessage(
            pb.to_i64(d.get(1, 0)),
            pb.to_i64(d.get(2, 0)),
            pb.to_i64(d.get(3, 0)),
            pb.to_i64(d.get(4, 0)) - 1,
        )
    if fnum == 5:
        return HasVoteMessage(
            pb.to_i64(d.get(1, 0)),
            pb.to_i64(d.get(2, 0)),
            SignedMsgType(pb.to_i64(d.get(3, 0))),
            pb.to_i64(d.get(4, 0)) - 1,
        )
    if fnum == 6:
        pd = pb.fields_to_dict(pb.as_bytes(d.get(3, b"")))
        part = Part(
            index=pb.to_i64(pd.get(1, 0)) - 1,
            bytes_=pb.as_bytes(pd.get(2, b"")),
            proof=_decode_proof(pb.as_bytes(pd.get(3, b""))),
        )
        return BlockPartMessage(
            pb.to_i64(d.get(1, 0)), pb.to_i64(d.get(2, 0)), part
        )
    if fnum == 7:
        return VoteSetMaj23Message(
            pb.to_i64(d.get(1, 0)),
            pb.to_i64(d.get(2, 0)),
            SignedMsgType(pb.to_i64(d.get(3, 0))),
            BlockID.decode(pb.as_bytes(d.get(4, b""))),
        )
    if fnum == 8:
        return VoteSetBitsMessage(
            pb.to_i64(d.get(1, 0)),
            pb.to_i64(d.get(2, 0)),
            SignedMsgType(pb.to_i64(d.get(3, 0))),
            BlockID.decode(pb.as_bytes(d.get(4, b""))),
            int.from_bytes(pb.as_bytes(d.get(5, b"")), "little"),
        )
    if fnum == 9:
        return NewValidBlockMessage(
            pb.to_i64(d.get(1, 0)),
            pb.to_i64(d.get(2, 0)),
            PartSetHeader.decode(pb.as_bytes(d.get(3, b""))),
            bool(pb.to_i64(d.get(4, 0))),
        )
    if fnum == 10:
        # an aggregate-precommit certificate (BLS): refused by name
        raise refuse_certificate()
    raise ValueError(f"unknown consensus message tag {fnum}")


# ----------------------------------------------------------------------
# flight-recorder wire hook: classify consensus wire messages
# into p2p.send / p2p.recv trace records WITHOUT constructing
# Vote/Proposal objects — only the outer tag and the height/round (and
# vote-type / index) varints are peeked. Installed on the switch via
# set_msg_tracer so the p2p layer stays ignorant of the wire format;
# the traceview merger pairs these records across per-node sinks to
# align clocks and build message edges.
# ----------------------------------------------------------------------
# HasVote (tag 5) is deliberately absent: it is the chattiest frame on
# the state channel (every vote received is re-announced to every
# peer), carries no payload the analyzers use, and tracing it measurably
# inflates sink volume on dense vote gossip.
_WIRE_MSG_KINDS = {
    1: "vote", 2: "proposal", 3: "block_bytes", 4: "new_round_step",
    6: "block_part", 7: "vote_set_maj23",
    8: "vote_set_bits", 9: "new_valid_block", 10: "agg_commit",
}
_VOTE_TYPE_NAMES = {1: "prevote", 2: "precommit", 32: "proposal"}
# Mempool channel id duplicated here (mempool/reactor.py) to keep the
# wire hook import-free of the mempool package: its tx frames become
# msg="txs" records, adding tx-gossip edges to the clock alignment.
_MEMPOOL_CHANNEL = 0x30
_TRACE_CHANNELS = frozenset(
    (STATE_CHANNEL, DATA_CHANNEL, VOTE_CHANNEL, _MEMPOOL_CHANNEL))


def peek_wire_msg(raw: bytes) -> dict | None:
    """Cheap metadata peek of an encoded consensus wire message:
    {"msg": kind, "height": h, "round": r, [+ "type"/"idx"/"step"]}.
    Returns None for unknown tags."""
    fields = pb.parse_fields(raw)
    if not fields:
        return None
    tag, _, v = fields[0]
    kind = _WIRE_MSG_KINDS.get(tag)
    if kind is None:
        return None
    emb = pb.fields_to_dict(pb.as_bytes(v))
    out: dict = {"msg": kind}
    if tag in (1, 2):  # Vote / Proposal protos: 2=height, 3=round
        out["height"] = pb.to_i64(emb.get(2, 0))
        out["round"] = pb.to_i64(emb.get(3, 0))
        if tag == 1:
            t = pb.to_i64(emb.get(1, 0))
            out["type"] = _VOTE_TYPE_NAMES.get(t, t)
            out["idx"] = pb.to_i64(emb.get(7, 0))
    else:  # wrapper messages: 1=height, 2=round
        out["height"] = pb.to_i64(emb.get(1, 0))
        out["round"] = pb.to_i64(emb.get(2, 0))
        if tag == 4:
            out["step"] = pb.to_i64(emb.get(3, 0))
        elif tag == 6:
            pd = pb.fields_to_dict(pb.as_bytes(emb.get(3, b"")))
            out["idx"] = pb.to_i64(pd.get(1, 0)) - 1
        elif tag in (7, 8):
            t = pb.to_i64(emb.get(3, 0))
            out["type"] = _VOTE_TYPE_NAMES.get(t, t)
    return out


def trace_wire_msg(direction: str, peer_id: str, chan_id: int,
                   raw: bytes) -> None:
    """Switch msg_tracer hook: one p2p.send/p2p.recv event per consensus
    wire message. Must never raise — a malformed frame is the receive
    path's problem; an exception here would tear down the peer."""
    if chan_id not in _TRACE_CHANNELS:
        return
    try:
        if chan_id == _MEMPOOL_CHANNEL:
            # tx gossip frame: repeated field 1, one element per tx
            meta = {"msg": "txs",
                    "n": sum(1 for f, _w, _v in pb.parse_fields(raw)
                             if f == 1)}
        else:
            meta = peek_wire_msg(raw)
        if meta is None:
            return
        if direction == "send":
            trace.event("p2p.send", peer=peer_id, chan=chan_id,
                        bytes=len(raw), **meta)
        else:
            trace.event("p2p.recv", peer=peer_id, chan=chan_id,
                        bytes=len(raw), **meta)
    except Exception:  # noqa: BLE001 — tracing must not disturb p2p
        pass


# ----------------------------------------------------------------------
# per-peer round state (reference internal/consensus/peer_state.go)
# ----------------------------------------------------------------------
class PeerState:
    def __init__(self, peer):
        self.peer = peer
        self.lock = threading.Lock()
        self.height = 0
        self.round = -1
        self.step = 0
        self.last_commit_round = -1
        self.proposal_seen = False
        self.parts: set[int] = set()  # part indexes at (height, round)
        self.catchup_parts: set[int] = set()  # parts sent for peer's height
        self.catchup_height = 0
        self.catchup_time = 0.0  # last catchup (re)start, for retry
        self.last_maj23_query = 0.0
        self.last_step_send = 0.0  # periodic NewRoundStep re-send
        # (height, round, type) -> set of validator indexes known to peer
        self.votes_seen: dict[tuple[int, int, int], set[int]] = {}

    def apply_new_round_step(self, m: NewRoundStepMessage) -> None:
        with self.lock:
            if (m.height, m.round) != (self.height, self.round):
                self.proposal_seen = False
                self.parts = set()
            if m.height != self.height:
                # keep only vote knowledge still useful (same height or
                # the commit for the previous height)
                self.votes_seen = {
                    k: v for k, v in self.votes_seen.items()
                    if k[0] >= m.height - 1
                }
            self.height = m.height
            self.round = m.round
            self.step = m.step
            self.last_commit_round = m.last_commit_round
        # per-peer reactor state gauges (rejoin-stall debugging needs
        # every peer's view of height/round exported)
        pid = getattr(self.peer, "id", "") or ""
        if pid:
            pm = p2p_metrics()
            pm.peer_height.set(m.height, pid[:16])
            pm.peer_round.set(m.round, pid[:16])

    def mark_vote(self, height: int, round_: int, type_: int, index: int):
        if index < 0 or index > MAX_VALIDATORS:
            return
        with self.lock:
            self.votes_seen.setdefault((height, round_, int(type_)), set()).add(
                index
            )
            # votes_seen keys are peer-influenced (HasVote/VoteSetBits at
            # arbitrary heights): bound the dict so junk heights cannot
            # accumulate — oldest keys go first
            while len(self.votes_seen) > 64:
                self.votes_seen.pop(next(iter(self.votes_seen)))

    def has_vote(self, height: int, round_: int, type_: int, index: int) -> bool:
        with self.lock:
            return index in self.votes_seen.get(
                (height, round_, int(type_)), ()
            )

    def mark_part(self, height: int, round_: int, index: int) -> None:
        with self.lock:
            if (height, round_) == (self.height, self.round):
                self.parts.add(index)

    def snapshot(self):
        with self.lock:
            return (self.height, self.round, self.step, self.proposal_seen,
                    set(self.parts))


class ConsensusReactor(Reactor):
    """State-aware gossip: one routine per peer pushes exactly what that
    peer is missing (proposal, block parts, votes), with catchup service
    for peers on earlier heights."""

    GOSSIP_SLEEP_S = 0.01
    PEER_QUERY_MAJ23_INTERVAL_S = 2.0
    # bounds on attacker-controlled buffers
    MAX_PART_INDEX = 2047  # parts per block (128 MiB at 64 KiB parts)
    MAX_HEADERLESS_PARTS = 256  # buffered before the proposal arrives
    MAX_VB_CANDIDATES = 4  # distinct NewValidBlock headers per height
    CATCHUP_CACHE_SIZE = 8  # committed-block PartSets kept for laggards
    MAX_VALIDATORS = MAX_VALIDATORS  # per-message vote-index/bitmap cap

    def __init__(self, cs: ConsensusState, block_store=None, wait_sync: bool = False):
        self.cs = cs
        self.block_store = block_store if block_store is not None else cs.block_store
        self.switch = None
        # CometBFT's waitSync (consensus/reactor.go AddPeer, Receive): while
        # the node block-syncs it announces no round step, so peers gossip
        # it no catch-up, and it drops proposals, parts and votes;
        # switch_to_consensus() ends it. The reference has no such wait
        # (ROADMAP.md queue C).
        self.wait_sync = wait_sync
        self._peers: dict[str, PeerState] = {}
        self._threads: dict[str, threading.Thread] = {}
        self._lock = threading.Lock()
        self._stopped = threading.Event()
        # our round's outbound data (proposer side + relayed)
        self._round_parts: PartSet | None = None
        self._round_parts_hr: tuple[int, int] = (0, -1)
        # reassembly of the incoming proposal block
        self._assembling: dict[int, Part] = {}
        self._assembling_hdr: PartSetHeader | None = None
        self._assembling_hr: tuple[int, int] = (0, -1)
        # committed-block PartSets / commit-vote lists served to lagging
        # peers, keyed by height (bounded LRU: peers lagging at different
        # heights must not thrash a single-entry cache with full
        # re-merkleizations, and one vote send must not rebuild the list)
        self._catchup_cache: dict[int, PartSet] = {}
        self._catchup_votes: dict[int, tuple] = {}
        # height-keyed assembly of a known-valid block (catchup path):
        # headers arrive via NewValidBlock, parts verified against them.
        # Multiple candidates per height, bounded: a forged header from
        # one peer must never pin the slot and starve honest headers
        # (safety holds regardless — commits sign the part-set header —
        # this bound is about liveness and memory).
        self._vb_height = 0
        self._vb_candidates: dict[bytes, tuple[PartSetHeader, dict[int, Part]]] = {}
        # encoded BlockPartMessage frames keyed (height, round, index):
        # gossiping P parts to N peers otherwise re-encodes the same
        # merkle-proved part N times (catchup frames carry the PEER's
        # round, hence round in the key); bounded FIFO
        self._part_frame_cache: dict[tuple[int, int, int], bytes] = {}
        cs.broadcast = self.broadcast_msg
        cs.on_new_step = self._on_new_step
        cs.on_has_vote = self._on_has_vote

    # -- Reactor interface ---------------------------------------------
    def channels(self) -> list[ChannelDescriptor]:
        return [
            ChannelDescriptor(STATE_CHANNEL, priority=6),
            ChannelDescriptor(DATA_CHANNEL, priority=10),
            ChannelDescriptor(VOTE_CHANNEL, priority=7),
        ]

    def set_switch(self, switch) -> None:
        self.switch = switch
        # arm the flight recorder's wire hook (no-op until tracing is
        # enabled; the switch fans it to every peer's send/recv path)
        if hasattr(switch, "set_msg_tracer"):
            switch.set_msg_tracer(trace_wire_msg)

    def stop(self) -> None:
        self._stopped.set()

    def add_peer(self, peer) -> None:
        ps = PeerState(peer)
        with self._lock:
            self._peers[peer.id] = ps
            t = threading.Thread(
                target=self._gossip_routine, args=(ps,), daemon=True,
                name=f"gossip-{peer.id[:8]}",
            )
            self._threads[peer.id] = t
        if not self.wait_sync:
            peer.send(STATE_CHANNEL, encode_consensus_msg(self._our_step_msg()))
        t.start()

    def remove_peer(self, peer, reason) -> None:
        with self._lock:
            self._peers.pop(peer.id, None)
            self._threads.pop(peer.id, None)
        pm = p2p_metrics()
        pm.peer_height.remove(peer.id[:16])
        pm.peer_round.remove(peer.id[:16])

    # -- outbound hooks from the state machine -------------------------
    def _our_step_msg(self) -> NewRoundStepMessage:
        cs = self.cs
        lcr = -1
        if cs.last_commit is not None:
            lcr = cs.last_commit.round
        return NewRoundStepMessage(cs.height, cs.round, int(cs.step), lcr)

    def _on_new_step(self) -> None:
        if self.switch is not None:
            self.switch.broadcast(
                STATE_CHANNEL, encode_consensus_msg(self._our_step_msg())
            )

    def _on_has_vote(self, vote: Vote) -> None:
        if self.switch is not None:
            self.switch.broadcast(
                STATE_CHANNEL,
                encode_consensus_msg(
                    HasVoteMessage(
                        vote.height, vote.round, vote.type, vote.validator_index
                    )
                ),
            )

    def broadcast_msg(self, msg) -> None:
        """Outbound seam for the state machine: proposals and our block
        bytes become round data served by the gossip routines; votes are
        pulled from the vote sets by difference, so no direct send."""
        if isinstance(msg, BlockBytesMessage):
            ps = PartSet.from_data(msg.block_bytes)
            with self._lock:
                self._round_parts = ps
                self._round_parts_hr = (msg.height, msg.round)
                # frames cached for an earlier (h, r) generation must
                # not alias the new round's parts
                self._part_frame_cache.clear()
        elif isinstance(msg, ProposalMessage):
            # proposal itself is picked up from cs.proposal by gossip;
            # nothing to store (cs sets cs.proposal before broadcasting)
            pass
        elif isinstance(msg, VoteMessage) and msg.direct:
            # a vote deliberately absent from our own vote set (the
            # byzantine equivocation shadow) — gossip pull would never
            # pick it up, so push it to every peer once
            raw = encode_consensus_msg(msg)
            with self._lock:
                peers = [ps.peer for ps in self._peers.values()]
            for peer in peers:
                try:
                    peer.send(VOTE_CHANNEL, raw)
                except Exception:  # noqa: BLE001 — peer mid-disconnect
                    pass
        # other VoteMessage: served from cs.votes by the vote gossip

    # -- inbound --------------------------------------------------------
    def switch_to_consensus(self) -> None:
        """End the block-sync wait: announce our round step to every peer
        (CometBFT Reactor.SwitchToConsensus)."""
        self.wait_sync = False
        frame = encode_consensus_msg(self._our_step_msg())
        with self._lock:
            peers = [ps.peer for ps in self._peers.values()]
        for peer in peers:
            peer.send(STATE_CHANNEL, frame)

    def receive(self, chan_id: int, peer, raw: bytes) -> None:
        if self.wait_sync and chan_id in (DATA_CHANNEL, VOTE_CHANNEL):
            return
        try:
            msg = decode_consensus_msg(raw)
        except UnsupportedCommitFormat:
            return  # a certificate frame: dropped, the peer kept
        with self._lock:
            ps = self._peers.get(peer.id)
        if ps is None:
            return
        if isinstance(msg, NewRoundStepMessage):
            ps.apply_new_round_step(msg)
        elif isinstance(msg, HasVoteMessage):
            ps.mark_vote(msg.height, msg.round, msg.type, msg.index)
        elif isinstance(msg, VoteMessage):
            v = msg.vote
            ps.mark_vote(v.height, v.round, v.type, v.validator_index)
            self.cs.send(msg, peer_id=peer.id)
        elif isinstance(msg, ProposalMessage):
            p = msg.proposal
            if (p.height, p.round) == (self.cs.height, self.cs.round):
                with ps.lock:
                    ps.proposal_seen = True
                self._begin_assembly(p, peer.id)
            self.cs.send(msg, peer_id=peer.id)
        elif isinstance(msg, BlockPartMessage):
            if (
                not 0 <= msg.part.index <= self.MAX_PART_INDEX
                or len(msg.part.bytes_) > PART_SIZE
            ):
                return
            ps.mark_part(msg.height, msg.round, msg.part.index)
            self._add_part(msg, peer.id)
        elif isinstance(msg, NewValidBlockMessage):
            with self._lock:
                if msg.height != self.cs.height:
                    return
                if self._vb_height != msg.height:
                    self._vb_height = msg.height
                    self._vb_candidates = {}
                key = msg.psh.hash
                if (
                    key not in self._vb_candidates
                    and len(self._vb_candidates) < self.MAX_VB_CANDIDATES
                    and 0 < msg.psh.total <= self.MAX_PART_INDEX + 1
                ):
                    self._vb_candidates[key] = (msg.psh, {})
        elif isinstance(msg, BlockBytesMessage):
            # legacy whole-block message: still accepted (tests, tools)
            self.cs.send(msg, peer_id=peer.id)
        elif isinstance(msg, VoteSetMaj23Message):
            self._answer_maj23(peer, msg)
        elif isinstance(msg, VoteSetBitsMessage):
            # the peer's bitmap for (height, round, type): every set bit
            # is a vote we need not gossip to it (reference peer_state
            # ApplyVoteSetBitsMessage). Bounded: one crafted message must
            # not force millions of marks.
            bits = msg.bits
            if bits.bit_length() > MAX_VALIDATORS:
                return
            i = 0
            while bits:
                if bits & 1:
                    ps.mark_vote(msg.height, msg.round, msg.type, i)
                bits >>= 1
                i += 1

    def _try_complete_locked(self, height: int, round_: int):
        """Caller holds self._lock. Returns assembled bytes when the
        round assembly is complete, else None."""
        hdr = self._assembling_hdr
        if hdr is None or len(self._assembling) != hdr.total:
            return None
        if not all(i in self._assembling for i in range(hdr.total)):
            return None
        parts = [self._assembling[i] for i in range(hdr.total)]
        data = PartSet(parts, hdr).assemble()
        self._assembling = {}
        self._assembling_hr = (0, -1)
        self._assembling_hdr = None
        # serve the parts onward to peers that still miss them
        self._round_parts = PartSet(parts, hdr)
        self._round_parts_hr = (height, round_)
        self._part_frame_cache.clear()
        return data

    def _begin_assembly(self, proposal: Proposal, peer_id: str) -> None:
        with self._lock:
            hr = (proposal.height, proposal.round)
            if self._assembling_hr != hr:
                self._assembling = {}
                self._assembling_hr = hr
            # adopt (or re-assert) the proposal's header; drop any
            # headerless-buffered parts that fail its proofs
            self._assembling_hdr = proposal.block_id.part_set_header
            bad = [
                i for i, part in self._assembling.items()
                if not PartSet.verify_part(self._assembling_hdr, part)
            ]
            for i in bad:
                self._assembling.pop(i)
            data = self._try_complete_locked(hr[0], hr[1])
        if data is not None:
            self.cs.send(
                BlockBytesMessage(hr[0], hr[1], data), peer_id=peer_id
            )

    def _add_part(self, msg: BlockPartMessage, peer_id: str) -> None:
        data = None
        hr = (msg.height, msg.round)
        with self._lock:
            if hr == self._assembling_hr or hr == (
                self.cs.height, self.cs.round
            ):
                if hr != self._assembling_hr:
                    # parts may arrive before the proposal: buffer them
                    # under the current round with an unknown header
                    self._assembling = {}
                    self._assembling_hr = hr
                    self._assembling_hdr = None
                hdr = self._assembling_hdr
                if hdr is None:
                    # headerless buffering is bounded: these parts are
                    # unverifiable until the proposal arrives, so a peer
                    # must not be able to grow the dict without limit
                    # (overflow parts are re-gossiped by bitmap diff)
                    if len(self._assembling) < self.MAX_HEADERLESS_PARTS:
                        self._assembling[msg.part.index] = msg.part
                elif PartSet.verify_part(hdr, msg.part):
                    self._assembling[msg.part.index] = msg.part
                    data = self._try_complete_locked(hr[0], hr[1])
                else:
                    _log.debug("invalid block part", height=msg.height,
                               index=msg.part.index, peer=peer_id[:8])
            if data is None and msg.height == self.cs.height:
                # known-valid block path (catchup): verify against any
                # announced NewValidBlock header, round-agnostic
                if self._vb_height != self.cs.height:
                    self._vb_candidates = {}
                    self._vb_height = self.cs.height
                for vhdr, vparts in self._vb_candidates.values():
                    if not PartSet.verify_part(vhdr, msg.part):
                        continue
                    vparts[msg.part.index] = msg.part
                    if len(vparts) == vhdr.total and all(
                        i in vparts for i in range(vhdr.total)
                    ):
                        parts = [vparts[i] for i in range(vhdr.total)]
                        data = PartSet(parts, vhdr).assemble()
                        vparts.clear()
                    break
        if data is not None:
            self.cs.send(
                BlockBytesMessage(msg.height, msg.round, data),
                peer_id=peer_id,
            )

    def _answer_maj23(self, peer, m: VoteSetMaj23Message) -> None:
        if m.height != self.cs.height:
            return
        vs = (
            self.cs.votes.prevotes(m.round)
            if m.type == SignedMsgType.PREVOTE
            else self.cs.votes.precommits(m.round)
        )
        if vs is None:
            return
        vs.set_peer_maj23(peer.id, m.block_id)
        ba = vs.bit_array_by_block_id(m.block_id)
        bits = 0
        if ba is not None:
            for i in range(ba.size()):
                if ba.get(i):
                    bits |= 1 << i
        peer.send(
            VOTE_CHANNEL,
            encode_consensus_msg(
                VoteSetBitsMessage(m.height, m.round, m.type, m.block_id, bits)
            ),
        )

    # -- per-peer gossip routine ---------------------------------------
    def _gossip_routine(self, ps: PeerState) -> None:
        while not self._stopped.is_set():
            with self._lock:
                alive = self._peers.get(ps.peer.id) is ps
            if not alive:
                return
            try:
                sent = self._gossip_data(ps)
                sent = self._gossip_votes(ps) or sent
                self._maybe_query_maj23(ps)
                self._maybe_resend_step(ps)
            except Exception as e:  # noqa: BLE001 — peer loops must survive
                _log.warn("gossip error", peer=ps.peer.id[:8],
                          err=f"{type(e).__name__}: {e}"[:120])
                sent = False
            if not sent:
                time.sleep(self.GOSSIP_SLEEP_S)

    STEP_RESEND_S = 2.0

    def _maybe_resend_step(self, ps: PeerState) -> None:
        """Re-broadcast our NewRoundStep to this peer periodically.

        State sync otherwise rests on the single add_peer-time send plus
        step-change broadcasts; if a peer misses those while both nodes
        are idle-waiting (no +2/3 -> no timeouts armed -> no new steps),
        its stale view of us (height 0) keeps its gossip routine from
        sending the very votes that would unstick the round — a mutual
        stall observed live on two-validator nets. A 2 s heartbeat of
        ~30 bytes makes peer state self-healing."""
        now = time.monotonic()
        if self.wait_sync or now - ps.last_step_send < self.STEP_RESEND_S:
            return
        ps.last_step_send = now
        ps.peer.send(
            STATE_CHANNEL, encode_consensus_msg(self._our_step_msg())
        )

    def _maybe_query_maj23(self, ps: PeerState) -> None:
        """Periodically tell a same-height peer which blocks we see +2/3
        votes for; it answers with VoteSetBits so vote gossip skips what
        it already has (reference queryMaj23Routine :893)."""
        now = time.monotonic()
        with ps.lock:
            if now - ps.last_maj23_query < self.PEER_QUERY_MAJ23_INTERVAL_S:
                return
            ps.last_maj23_query = now
            h = ps.height
        cs = self.cs
        if h != cs.height:
            return
        for vtype, vs in (
            (SignedMsgType.PREVOTE, cs.votes.prevotes(cs.round)),
            (SignedMsgType.PRECOMMIT, cs.votes.precommits(cs.round)),
        ):
            maj23 = getattr(vs, "maj23", None) if vs is not None else None
            if maj23 is None:
                continue
            ps.peer.send(
                STATE_CHANNEL,
                encode_consensus_msg(
                    VoteSetMaj23Message(cs.height, cs.round, vtype, maj23)
                ),
            )

    PART_FRAME_CACHE_SIZE = 256

    def _part_frame(self, h: int, r: int, part) -> bytes:
        """Encoded BlockPartMessage frame, cached per (height, round,
        index) so N peer gossip routines share one encode per part."""
        key = (h, r, part.index)
        with self._lock:
            frame = self._part_frame_cache.get(key)
        if frame is None:
            frame = encode_consensus_msg(BlockPartMessage(h, r, part))
            with self._lock:
                frame = self._part_frame_cache.setdefault(key, frame)
                while len(self._part_frame_cache) > self.PART_FRAME_CACHE_SIZE:
                    self._part_frame_cache.pop(
                        next(iter(self._part_frame_cache))
                    )
        return frame

    def _gossip_data(self, ps: PeerState) -> bool:
        cs = self.cs
        h, r, step, prop_seen, peer_parts = ps.snapshot()
        if h == 0:
            return False
        # catchup: peer is on an earlier height — serve the committed
        # block's parts from the store (reference gossipDataForCatchup)
        if h < cs.height:
            if self.block_store is None:
                return False
            with self._lock:
                cps = self._catchup_cache.get(h)
            if cps is None:
                # one store load + encode + merkleization per height, NOT
                # per part: the cache is consulted before touching the
                # store (a 32-part block would otherwise decode 32 times
                # per lagging peer)
                blk = self.block_store.load_block(h)
                if blk is None:
                    return False
                cps = PartSet.from_data(blk.encode())
                with self._lock:
                    cps = self._catchup_cache.setdefault(h, cps)
                    while len(self._catchup_cache) > self.CATCHUP_CACHE_SIZE:
                        self._catchup_cache.pop(
                            next(iter(self._catchup_cache))
                        )
            announce = False
            now = time.monotonic()
            with ps.lock:
                if ps.catchup_height != h:
                    ps.catchup_height = h
                    ps.catchup_parts = set()
                    ps.catchup_time = now
                    announce = True
                missing = [
                    p for p in cps.parts if p.index not in ps.catchup_parts
                ]
                if not missing and not announce:
                    # everything sent but the peer is still stuck at h:
                    # assume loss and retransmit after a grace period
                    if now - ps.catchup_time < 2.0:
                        return False
                    ps.catchup_parts = set()
                    ps.catchup_time = now
                    missing = list(cps.parts)
                    announce = True
                part = missing[0] if missing else None
                if part is not None:
                    ps.catchup_parts.add(part.index)
            if announce:
                # header first, so the peer can verify the parts
                # (reference NewValidBlockMessage semantics)
                ps.peer.send(
                    DATA_CHANNEL,
                    encode_consensus_msg(
                        NewValidBlockMessage(h, r, cps.header, is_commit=True)
                    ),
                )
            if part is not None:
                ps.peer.send(DATA_CHANNEL, self._part_frame(h, r, part))
            return True
        if h != cs.height:
            return False
        # proposal
        if cs.proposal is not None and not prop_seen and r == cs.round:
            ps.peer.send(
                DATA_CHANNEL,
                encode_consensus_msg(ProposalMessage(cs.proposal)),
            )
            with ps.lock:
                ps.proposal_seen = True
            return True
        # block parts by bitmap difference
        with self._lock:
            parts = self._round_parts
            hr = self._round_parts_hr
        if parts is not None and hr == (cs.height, cs.round) and r == cs.round:
            for part in parts.parts:
                if part.index not in peer_parts:
                    ps.peer.send(
                        DATA_CHANNEL, self._part_frame(hr[0], hr[1], part)
                    )
                    ps.mark_part(hr[0], hr[1], part.index)
                    return True
        return False

    def _pick_send_vote(self, ps: PeerState, vs) -> bool:
        """Send one vote from `vs` the peer hasn't seen (reference
        PickSendVote)."""
        if vs is None:
            return False
        ba = vs.bit_array()
        vtype = vs.signed_msg_type
        for i in range(ba.size()):
            if ba.get(i) and not ps.has_vote(vs.height, vs.round, vtype, i):
                v = vs.get_by_index(i)
                if v is None:
                    continue
                ps.peer.send(VOTE_CHANNEL, encode_consensus_msg(VoteMessage(v)))
                ps.mark_vote(vs.height, vs.round, vtype, i)
                return True
        return False

    def _commit_as_voteset(self, height: int):
        """Stored commit -> precommit votes for catchup gossip (reference
        gossipVotesRoutine LoadCommit path). Cached per height beside the
        catchup PartSets: one vote is sent per gossip iteration and the
        reconstruction must not repeat per vote."""
        with self._lock:
            cached = self._catchup_votes.get(height)
        if cached is not None:
            return cached
        store = self.block_store
        if store is None:
            return None
        commit = store.load_block_commit(height) or store.load_seen_commit(
            height
        )
        if commit is None:
            return None
        votes = []
        for idx, csig in enumerate(commit.signatures):
            if csig.is_absent():
                continue
            votes.append(
                Vote(
                    type=SignedMsgType.PRECOMMIT,
                    height=height,
                    round=commit.round,
                    block_id=csig.effective_block_id(commit.block_id),
                    timestamp=csig.timestamp,
                    validator_address=csig.validator_address,
                    validator_index=idx,
                    signature=csig.signature,
                )
            )
        out = (commit.round, votes)
        with self._lock:
            self._catchup_votes[height] = out
            while len(self._catchup_votes) > self.CATCHUP_CACHE_SIZE:
                self._catchup_votes.pop(next(iter(self._catchup_votes)))
        return out

    def _gossip_votes(self, ps: PeerState) -> bool:
        cs = self.cs
        h, r, step, _, _ = ps.snapshot()
        if h == 0:
            return False
        if h == cs.height:
            # current-height votes by difference: peer round prevotes /
            # precommits, our round, POL
            for vs in (
                cs.votes.prevotes(r),
                cs.votes.precommits(r),
                cs.votes.prevotes(cs.round),
                cs.votes.precommits(cs.round),
            ):
                if self._pick_send_vote(ps, vs):
                    return True
            # a peer still on NEW_HEIGHT may be waiting for the previous
            # height's precommits to finalize its own commit (reference
            # gossipVotesForHeight's RoundStepNewHeight -> LastCommit)
            if (
                cs.last_commit is not None
                and step == int(RoundStep.NEW_HEIGHT)
                and self._pick_send_vote(ps, cs.last_commit)
            ):
                return True
            return False
        if h == cs.height - 1 and cs.last_commit is not None:
            return self._pick_send_vote(ps, cs.last_commit)
        if h < cs.height - 1:
            got = self._commit_as_voteset(h)
            if got is None:
                return False
            cround, votes = got
            for v in votes:
                if not ps.has_vote(h, cround, SignedMsgType.PRECOMMIT,
                                   v.validator_index):
                    ps.peer.send(
                        VOTE_CHANNEL, encode_consensus_msg(VoteMessage(v))
                    )
                    ps.mark_vote(h, cround, SignedMsgType.PRECOMMIT,
                                 v.validator_index)
                    return True
        return False
