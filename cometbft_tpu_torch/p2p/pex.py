"""Twin of `cometbft_tpu/p2p/pex.py`. Peer exchange: bucketed address book + PEX reactor + seed crawler.

Behavior parity: reference p2p/pex/ — the AddrBook (addrbook.py) keeps
heard-about addresses in 256 hashed "new" buckets and proven-good ones
in 64 "old" buckets, keyed by a persisted random key over the
(source-group, addr-group) pair, with promotion/demotion, biased random
selection (~70% old when healthy), and atomic JSON persistence
(addrbook.go). The reactor (pex_reactor.go) speaks channel 0x00: on
AddPeer it asks for addresses, answers requests with a random
selection, and an ensure-peers loop dials from the book — with
exponential backoff per failed address — falling back to the configured
seed nodes when starved.

Seed-crawler mode (reference pex_reactor.go seedMode/crawlPeers): a
node with `p2p.seed_mode` on does not keep full peers. It crawls — dial
an address from the book, handshake, request the peer's addresses, file
them, disconnect — and serves addrs-on-request to inbound dialers,
hanging up shortly after replying. This is what lets a network
bootstrap from a single well-known address.

Wire format matches the reference pex proto (Message oneof:
pex_request=1, pex_addrs=2; NetAddress {id=1, ip=2, port=3}).
"""

from __future__ import annotations

import random
import threading
import time

from ..encoding import proto as pb
from ..utils.log import logger
from .addrbook import AddrBook, KnownAddress, NetAddress  # noqa: F401 — re-export
from .conn import ChannelDescriptor
from .switch import Reactor

PEX_CHANNEL = 0x00
MAX_ADDRS_PER_MSG = 100
_log = logger("pex")


def encode_pex_request() -> bytes:
    return pb.f_embedded(1, b"")


def encode_pex_addrs(addrs: list[NetAddress]) -> bytes:
    body = b"".join(pb.f_embedded(1, a.encode()) for a in addrs)
    return pb.f_embedded(2, body)


def decode_pex_message(buf: bytes):
    d = pb.fields_to_dict(buf)
    if 1 in d:
        return "request", None
    if 2 in d:
        addrs = []
        for f, _, v in pb.parse_fields(pb.as_bytes(d[2])):
            if f == 1:
                addrs.append(NetAddress.from_fields(pb.fields_to_dict(pb.as_bytes(v))))
        return "addrs", addrs
    return None, None


class PexReactor(Reactor):
    """Channel 0x00 address gossip + ensure-peers / seed-crawl loop."""

    def __init__(self, book: AddrBook, target_outbound: int = 10,
                 ensure_interval_s: float = 30.0,
                 seed_mode: bool = False,
                 seeds: list[tuple[str, int]] | None = None,
                 seed_disconnect_s: float = 1.5,
                 crawl_batch: int = 8):
        self.book = book
        self.target_outbound = target_outbound
        self.ensure_interval_s = ensure_interval_s
        self.seed_mode = seed_mode
        self.seeds = list(seeds or [])
        # seed mode: how long a connection may live after admission —
        # long enough for a request/addrs exchange both ways, short
        # enough that the seed never accumulates full peers
        self.seed_disconnect_s = seed_disconnect_s
        self.crawl_batch = crawl_batch
        self._switch = None
        self._stopped = threading.Event()
        self._thread: threading.Thread | None = None
        self._requested: set[str] = set()  # peers we asked (rate limit)
        self._hangup: dict[str, float] = {}  # seed mode: peer -> deadline

    def set_switch(self, switch) -> None:
        self._switch = switch

    def channels(self) -> list[ChannelDescriptor]:
        return [ChannelDescriptor(id=PEX_CHANNEL, priority=1)]

    def add_peer(self, peer) -> None:
        # learn the peer's self-reported listen address
        la = getattr(peer.node_info, "listen_addr", "")
        if la and ":" in la:
            host, _, port = la.rpartition(":")
            try:
                self.book.add_address(
                    NetAddress(peer.id, host, int(port)), source=peer.id
                )
            except ValueError:
                pass
        if peer.outbound:
            self.book.mark_good(peer.id)
        peer.send(PEX_CHANNEL, encode_pex_request())
        self._requested.add(peer.id)
        if self.seed_mode:
            self._hangup[peer.id] = (
                time.monotonic() + self.seed_disconnect_s
            )

    def remove_peer(self, peer, reason) -> None:
        self._requested.discard(peer.id)
        self._hangup.pop(peer.id, None)

    def receive(self, chan_id: int, peer, raw: bytes) -> None:
        kind, addrs = decode_pex_message(raw)
        if kind == "request":
            peer.send(
                PEX_CHANNEL,
                encode_pex_addrs(self.book.random_selection(MAX_ADDRS_PER_MSG)),
            )
        elif kind == "addrs":
            if peer.id not in self._requested:
                # unsolicited addrs: the reference disconnects such peers
                if self._switch is not None:
                    self._switch.stop_peer_for_error(peer, "unsolicited pex")
                return
            self._requested.discard(peer.id)
            for a in addrs[:MAX_ADDRS_PER_MSG]:
                self.book.add_address(a, source=peer.id)

    # -- ensure-peers (full-peer mode) -------------------------------------
    def ensure_peers(self) -> None:
        """Dial book addresses until the outbound target is met,
        honoring per-address exponential backoff; when nothing is
        dialable and the node is peerless, fall back to a configured
        seed (reference pex_reactor.go ensurePeers/dialSeeds)."""
        if self._switch is None:
            return
        peers = self._switch.peers()
        out = sum(1 for p in peers if p.outbound)
        need = self.target_outbound - out
        if need <= 0:
            return
        skip = {p.id for p in peers}
        dialed = 0
        for _ in range(3 * need + 10):
            if dialed >= need:
                break
            addr = self.book.pick_address()
            if addr is None:
                break
            if addr.node_id in skip:
                continue
            skip.add(addr.node_id)  # one try per address per round
            if self.book.backoff_remaining(addr.node_id) > 0:
                continue
            if self._dial_book_addr(addr):
                dialed += 1
        if dialed == 0 and not self._switch.peers():
            # starved: no peers and nothing dialable in the book
            self._dial_seed(skip)
        if out + dialed < self.target_outbound and peers:
            # re-solicit addresses from a connected peer: the book may
            # be too thin to meet the target (reference ensurePeers
            # asks a random peer for more addrs while below target)
            p = random.choice(peers)
            self._requested.add(p.id)
            p.send(PEX_CHANNEL, encode_pex_request())

    def _dial_book_addr(self, addr: NetAddress) -> bool:
        self.book.mark_attempt(addr.node_id)
        try:
            peer = self._switch.dial_peer(addr.host, addr.port)
        except Exception as e:  # noqa: BLE001 — dial failures expected
            _log.debug("pex dial failed", peer=addr.node_id[:12],
                       err=str(e)[:60])
            return False
        # only trust the book entry once the AUTHENTICATED peer id
        # from the handshake matches what the book claimed — otherwise
        # any host could pollute the book under a victim's node id
        # (reference switch.go dial id check)
        if peer.id != addr.node_id:
            self.book.mark_bad(addr.node_id)
            self._switch.stop_peer_for_error(
                peer, ValueError("dialed node id mismatch")
            )
            return False
        self.book.mark_good(addr.node_id)
        return True

    def _dial_seed(self, skip: set[str]) -> None:
        """Dial one random configured seed; its pex response re-seeds
        the book (reference dialSeeds)."""
        for host, port in random.sample(self.seeds, len(self.seeds)):
            try:
                peer = self._switch.dial_peer(host, port)
            except Exception as e:  # noqa: BLE001 — seed may be down
                _log.debug("seed dial failed", seed=f"{host}:{port}",
                           err=str(e)[:60])
                continue
            if peer.id in skip:
                return  # raced an inbound connection from the seed
            _log.info("bootstrapping from seed", seed=f"{host}:{port}")
            return

    # -- seed crawler (seed mode) ------------------------------------------
    def crawl(self) -> None:
        """One crawl round: dial up to crawl_batch book addresses to
        harvest their addrs (add_peer sends the request; the hangup
        sweep disconnects them), falling back to other seeds when the
        book is empty (reference crawlPeers)."""
        if self._switch is None:
            return
        skip = {p.id for p in self._switch.peers()}
        dialed = 0
        for _ in range(3 * self.crawl_batch):
            if dialed >= self.crawl_batch:
                break
            addr = self.book.pick_address(bias_old_pct=30)
            if addr is None:
                break
            if addr.node_id in skip:
                continue
            skip.add(addr.node_id)
            if self.book.backoff_remaining(addr.node_id) > 0:
                continue
            if self._dial_book_addr(addr):
                dialed += 1
        if dialed == 0 and not self._switch.peers():
            self._dial_seed(skip)

    def sweep_hangups(self) -> None:
        """Disconnect seed-mode connections past their deadline: a seed
        serves addrs and hangs up, never holding full peers."""
        if self._switch is None or not self._hangup:
            return
        now = time.monotonic()
        due = [pid for pid, dl in self._hangup.items() if now >= dl]
        if not due:
            return
        for peer in self._switch.peers():
            if peer.id in due:
                self._hangup.pop(peer.id, None)
                self._switch.stop_peer_for_error(peer, "seed: addrs served")
        for pid in due:  # peer already gone: drop the stale deadline
            self._hangup.pop(pid, None)

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stopped.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
        self.book.save()

    def _loop(self) -> None:
        # seed mode wakes fast (hangup sweeps are latency-sensitive)
        # while crawling/saving only every ensure_interval_s; full-peer
        # mode runs ensure_peers straight away so a freshly started node
        # does not idle one full interval before its first dial
        last_work = 0.0
        tick = min(0.25, self.ensure_interval_s) if self.seed_mode \
            else self.ensure_interval_s
        while not self._stopped.is_set():
            try:
                now = time.monotonic()
                if self.seed_mode:
                    self.sweep_hangups()
                    if now - last_work >= self.ensure_interval_s:
                        last_work = now
                        self.crawl()
                        self.book.save()
                else:
                    self.ensure_peers()
                    self.book.save()
            except Exception:  # noqa: BLE001 — keep the loop alive
                pass
            self._stopped.wait(tick)
