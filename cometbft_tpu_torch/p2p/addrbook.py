"""Twin of `cometbft_tpu/p2p/addrbook.py`. Bucketed peer address book (reference p2p/pex/addrbook.go).

The reference defends its address space with a hashed-bucket layout:
256 "new" buckets hold heard-about addresses, 64 "old" buckets hold
proven-good ones, and an address's bucket index is a keyed hash of its
address group and its source's group. The key (random, persisted with
the book) makes bucket placement unpredictable to an attacker, and the
group terms cap how many buckets any one /16 (or any one gossiping
source) can reach — a poisoning peer can land addresses in at most
NEW_BUCKETS_PER_GROUP of the 256 new buckets, so it cannot crowd honest
entries out of the rest (addrbook.go calcNewBucket/calcOldBucket).

Lifecycle parity with the reference:
  add_address   files an address into a new bucket (evicting a stale or
                oldest entry when the bucket is full — expireNew)
  mark_good     promotes new -> old after a successful outbound
                handshake (moveToOld; a full old bucket demotes its
                stalest entry back to new)
  mark_attempt  counts a dial attempt; drives per-address exponential
                backoff in the PEX dial loop
  mark_bad      bans the address for `ban_s` and removes it (MarkBad)
  pick_address  random selection biased ~70% toward old entries when
                both groups are populated (PickAddress)

Persistence is atomic JSON (tmp + os.replace) carrying the hash key and
every entry's bucket assignment, so the new/old split and bucket layout
round-trip across restart (addrbook.go saveToFile/loadFromFile).
"""

from __future__ import annotations

import hashlib
import ipaddress
import json
import os
import random
import threading
import time
from dataclasses import dataclass

from ..encoding import proto as pb

NEW_BUCKET_COUNT = 256
OLD_BUCKET_COUNT = 64
BUCKET_SIZE = 64
# spread caps: one source group reaches at most this many new buckets;
# one address group at most this many old buckets (reference
# newBucketsPerGroup / oldBucketsPerGroup)
NEW_BUCKETS_PER_GROUP = 32
OLD_BUCKETS_PER_GROUP = 4
# an entry with this many failed attempts and no success ever is stale
# and is the first evicted from a full bucket (reference isBad)
STALE_ATTEMPTS = 3
DEFAULT_BAN_S = 24 * 3600.0


@dataclass(frozen=True)
class NetAddress:
    node_id: str
    host: str
    port: int

    def encode(self) -> bytes:
        return (
            pb.f_string(1, self.node_id)
            + pb.f_string(2, self.host)
            + pb.f_varint(3, self.port)
        )

    @classmethod
    def from_fields(cls, d: dict) -> "NetAddress":
        return cls(
            node_id=pb.as_bytes(d.get(1, b"")).decode(),
            host=pb.as_bytes(d.get(2, b"")).decode(),
            port=pb.to_i64(d.get(3, 0)),
        )

    def routable(self) -> bool:
        """Globally reachable (reference netaddress.go Routable)."""
        try:
            ip = ipaddress.ip_address(self.host)
        except ValueError:
            return bool(self.host)  # DNS name: assume routable
        return ip.is_global

    def group_key(self) -> str:
        """Address group for bucket hashing: the /16 for routable IPv4,
        the /32 prefix for IPv6, "local"/"private" buckets for
        non-routable space (reference addrbook.go groupKey)."""
        try:
            ip = ipaddress.ip_address(self.host)
        except ValueError:
            return self.host or "unroutable"
        if ip.is_loopback:
            return "local"
        if not ip.is_global:
            return "private"
        if ip.version == 4:
            a, b, *_ = self.host.split(".")
            return f"{a}.{b}"
        return str(ipaddress.ip_network(f"{self.host}/32", strict=False))


@dataclass
class KnownAddress:
    """Book entry (reference pex/known_address.go)."""

    addr: NetAddress
    src: str  # node id (or label) that told us about this address
    bucket: int
    is_old: bool = False
    attempts: int = 0
    last_attempt: float = 0.0
    last_success: float = 0.0

    def is_stale(self) -> bool:
        return self.attempts >= STALE_ATTEMPTS and self.last_success == 0.0

    def to_json(self) -> dict:
        return {
            "node_id": self.addr.node_id,
            "host": self.addr.host,
            "port": self.addr.port,
            "src": self.src,
            "bucket": self.bucket,
            "is_old": self.is_old,
            "attempts": self.attempts,
            "last_attempt": self.last_attempt,
            "last_success": self.last_success,
        }


class AddrBook:
    """256-new / 64-old bucketed address book with keyed-hash placement.

    `strict` refuses non-routable addresses like the reference's
    addr_book_strict (off by default here: this reproduction's nets run
    on loopback). `self_id` keeps the node's own id out of the book.
    """

    def __init__(self, path: str | None = None, strict: bool = False,
                 self_id: str = "", key: bytes | None = None):
        self._path = path
        self._strict = strict
        self._self_id = self_id
        self._key = key or os.urandom(24)
        self._lock = threading.Lock()
        self._addrs: dict[str, KnownAddress] = {}
        # dicts (not sets) so eviction can fall back to insertion order
        self._new: list[dict[str, None]] = [
            {} for _ in range(NEW_BUCKET_COUNT)
        ]
        self._old: list[dict[str, None]] = [
            {} for _ in range(OLD_BUCKET_COUNT)
        ]
        self._banned: dict[str, float] = {}  # node id -> ban expiry
        if path and os.path.exists(path):
            self._load()

    # -- bucket hashing ----------------------------------------------------
    def _hash64(self, data: str) -> int:
        h = hashlib.sha256(self._key + data.encode()).digest()
        return int.from_bytes(h[:8], "big")

    def _calc_new_bucket(self, addr: NetAddress, src_group: str) -> int:
        # double hash (reference calcNewBucket): the outer hash is keyed
        # by the SOURCE group only, so one source spans at most
        # NEW_BUCKETS_PER_GROUP distinct new buckets
        h1 = self._hash64(addr.group_key() + "|" + src_group)
        h1 %= NEW_BUCKETS_PER_GROUP
        return self._hash64(src_group + "|" + str(h1)) % NEW_BUCKET_COUNT

    def _calc_old_bucket(self, addr: NetAddress) -> int:
        # keyed by the ADDRESS group: one /16 spans at most
        # OLD_BUCKETS_PER_GROUP old buckets (reference calcOldBucket)
        h1 = self._hash64(f"{addr.node_id}@{addr.host}:{addr.port}")
        h1 %= OLD_BUCKETS_PER_GROUP
        return self._hash64(addr.group_key() + "|" + str(h1)) % OLD_BUCKET_COUNT

    # -- mutation ----------------------------------------------------------
    def add_address(self, addr: NetAddress, source: str = "") -> bool:
        """File a heard-about address into its new bucket. Returns False
        for invalid/self/banned/duplicate addresses and (in strict mode)
        non-routable ones."""
        if not addr.node_id or not addr.host or not (0 < addr.port < 65536):
            return False
        if addr.node_id == self._self_id:
            return False
        if self._strict and not addr.routable():
            return False
        with self._lock:
            now = time.time()
            expiry = self._banned.get(addr.node_id)
            if expiry is not None:
                if expiry > now:
                    return False
                del self._banned[addr.node_id]  # ban expired
            if addr.node_id in self._addrs:
                return False
            src_addr = self._addrs.get(source)
            src_group = (
                src_addr.addr.group_key() if src_addr is not None
                else (source or "unknown")
            )
            bucket = self._calc_new_bucket(addr, src_group)
            self._evict_if_full(self._new[bucket])
            self._new[bucket][addr.node_id] = None
            self._addrs[addr.node_id] = KnownAddress(
                addr=addr, src=source, bucket=bucket
            )
            return True

    def _evict_if_full(self, bucket: dict[str, None]) -> None:
        """Make room in a full new bucket: drop a stale entry (many
        failed attempts, never succeeded) or, failing that, the entry
        with the oldest activity (reference expireNew/pickOldest)."""
        if len(bucket) < BUCKET_SIZE:
            return
        victim = next(
            (nid for nid in bucket if self._addrs[nid].is_stale()),
            None,
        )
        if victim is None:
            victim = min(
                bucket, key=lambda nid: self._addrs[nid].last_attempt
            )
        del bucket[victim]
        del self._addrs[victim]

    def mark_good(self, node_id: str) -> None:
        """Promote to an old bucket after a successful outbound
        connection (reference MarkGood -> moveToOld)."""
        with self._lock:
            ka = self._addrs.get(node_id)
            if ka is None:
                return
            ka.attempts = 0
            ka.last_success = time.time()
            if ka.is_old:
                return
            del self._new[ka.bucket][node_id]
            ob = self._calc_old_bucket(ka.addr)
            if len(self._old[ob]) >= BUCKET_SIZE:
                # demote the old entry with the stalest activity back to
                # a new bucket (reference moveToOld's displacement)
                demote_id = min(
                    self._old[ob],
                    key=lambda nid: max(self._addrs[nid].last_success,
                                        self._addrs[nid].last_attempt),
                )
                del self._old[ob][demote_id]
                dka = self._addrs[demote_id]
                dka.is_old = False
                dka.bucket = self._calc_new_bucket(
                    dka.addr, dka.src or "unknown"
                )
                self._evict_if_full(self._new[dka.bucket])
                self._new[dka.bucket][demote_id] = None
            ka.is_old = True
            ka.bucket = ob
            self._old[ob][node_id] = None

    def mark_attempt(self, node_id: str) -> None:
        with self._lock:
            ka = self._addrs.get(node_id)
            if ka is not None:
                ka.attempts += 1
                ka.last_attempt = time.time()

    def mark_bad(self, node_id: str, ban_s: float = DEFAULT_BAN_S) -> None:
        """Remove and ban (evidence of misbehavior; reference MarkBad)."""
        with self._lock:
            ka = self._addrs.pop(node_id, None)
            if ka is not None:
                group = self._old if ka.is_old else self._new
                group[ka.bucket].pop(node_id, None)
            self._banned[node_id] = time.time() + ban_s

    def backoff_remaining(self, node_id: str, base_s: float = 0.5,
                          cap_s: float = 30.0) -> float:
        """Seconds until `node_id` may be redialed: exponential in the
        consecutive failed attempts since the last success (the PEX
        ensure-peers loop consults this before every dial)."""
        with self._lock:
            ka = self._addrs.get(node_id)
            if ka is None or ka.attempts == 0:
                return 0.0
            wait = min(cap_s, base_s * (2 ** (ka.attempts - 1)))
            return max(0.0, ka.last_attempt + wait - time.time())

    # -- selection ---------------------------------------------------------
    def pick_address(self, bias_old_pct: int = 70) -> NetAddress | None:
        """Random address: a random entry of a random non-empty bucket,
        drawn from the old group ~bias_old_pct% of the time when both
        groups are populated (reference PickAddress)."""
        with self._lock:
            has_old = any(self._old)
            has_new = any(self._new)
            if not has_old and not has_new:
                return None
            use_old = has_old and (
                not has_new or random.randrange(100) < bias_old_pct
            )
            buckets = [b for b in (self._old if use_old else self._new) if b]
            bucket = random.choice(buckets)
            return self._addrs[random.choice(list(bucket))].addr

    def random_selection(self, n: int = 100) -> list[NetAddress]:
        with self._lock:
            pool = [ka.addr for ka in self._addrs.values()]
        random.shuffle(pool)
        return pool[:n]

    # -- introspection -----------------------------------------------------
    def has(self, node_id: str) -> bool:
        with self._lock:
            return node_id in self._addrs

    def known(self, node_id: str) -> KnownAddress | None:
        with self._lock:
            return self._addrs.get(node_id)

    def size(self) -> int:
        with self._lock:
            return len(self._addrs)

    def counts(self) -> tuple[int, int]:
        """(new entries, old entries)."""
        with self._lock:
            old = sum(1 for ka in self._addrs.values() if ka.is_old)
            return len(self._addrs) - old, old

    # -- persistence -------------------------------------------------------
    def save(self) -> None:
        if not self._path:
            return
        with self._lock:
            doc = {
                "key": self._key.hex(),
                "addrs": [ka.to_json() for ka in self._addrs.values()],
                "banned": dict(self._banned),
            }
        tmp = self._path + ".tmp"
        os.makedirs(os.path.dirname(self._path) or ".", exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, self._path)

    def _load(self) -> None:
        try:
            with open(self._path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return
        if "key" in doc:
            try:
                self._key = bytes.fromhex(doc["key"])
            except ValueError:
                pass
        banned = doc.get("banned", {})
        if isinstance(banned, list):  # legacy flat-book format
            expiry = time.time() + DEFAULT_BAN_S
            banned = {nid: expiry for nid in banned}
        self._banned = {str(k): float(v) for k, v in banned.items()}
        entries = doc.get("addrs")
        if entries is None:
            # legacy flat-book file ({"new": [...], "old": [...]}):
            # migrate into buckets so an upgrade keeps its peers
            entries = [
                {**a, "is_old": False} for a in doc.get("new", [])
            ] + [{**a, "is_old": True} for a in doc.get("old", [])]
        for e in entries:
            try:
                addr = NetAddress(e["node_id"], e["host"], int(e["port"]))
            except (KeyError, TypeError, ValueError):
                continue
            if not addr.node_id or addr.node_id in self._addrs:
                continue
            is_old = bool(e.get("is_old", False))
            buckets = self._old if is_old else self._new
            bucket = e.get("bucket", -1)
            if not (isinstance(bucket, int) and 0 <= bucket < len(buckets)
                    and len(buckets[bucket]) < BUCKET_SIZE):
                # missing/invalid/full slot (e.g. a legacy file or a key
                # change): recompute placement under the current key
                bucket = (
                    self._calc_old_bucket(addr) if is_old
                    else self._calc_new_bucket(addr, e.get("src") or "unknown")
                )
                if len(buckets[bucket]) >= BUCKET_SIZE:
                    continue
            buckets[bucket][addr.node_id] = None
            self._addrs[addr.node_id] = KnownAddress(
                addr=addr,
                src=e.get("src", ""),
                bucket=bucket,
                is_old=is_old,
                attempts=int(e.get("attempts", 0)),
                last_attempt=float(e.get("last_attempt", 0.0)),
                last_success=float(e.get("last_success", 0.0)),
            )
