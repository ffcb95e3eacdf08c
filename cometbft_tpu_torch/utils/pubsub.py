"""Event pub/sub with the reference's query language.

Behavior parity: reference internal/pubsub (Server, :~600) +
internal/pubsub/query (the `tm.event='NewBlock' AND tx.height > 5`
language). Supported operators: =, !=, <, <=, >, >=, CONTAINS, EXISTS,
combined with AND (the reference's language has no OR). Values compare
numerically when both sides parse as numbers, else as strings.

Twin of `cometbft_tpu/utils/pubsub.py`.
"""

from __future__ import annotations

import re
import threading
from dataclasses import dataclass, field


# ---------------------------------------------------------------- query ---
_TOKEN = re.compile(
    r"\s*(?:(?P<key>[\w.]+)\s*(?P<op><=|>=|!=|=|<|>|\bCONTAINS\b|\bEXISTS\b)"
    r"\s*(?P<val>'[^']*'|[\w.\-]+)?)\s*"
)


@dataclass
class _Condition:
    key: str
    op: str
    value: str | None

    def matches(self, events: dict[str, list[str]]) -> bool:
        vals = events.get(self.key)
        if self.op == "EXISTS":
            return vals is not None
        if vals is None:
            return False
        for v in vals:
            if self._match_one(v):
                return True
        return False

    def _match_one(self, v: str) -> bool:
        want = self.value
        if self.op == "CONTAINS":
            return want in v
        try:
            a, b = float(v), float(want)
            if self.op == "=":
                return a == b
            if self.op == "!=":
                return a != b
            if self.op == "<":
                return a < b
            if self.op == "<=":
                return a <= b
            if self.op == ">":
                return a > b
            if self.op == ">=":
                return a >= b
        except (TypeError, ValueError):
            pass
        if self.op == "=":
            return v == want
        if self.op == "!=":
            return v != want
        return False


class Query:
    """Parsed AND-combination of conditions (reference pubsub/query)."""

    def __init__(self, s: str):
        self.source = s
        self.conditions: list[_Condition] = []
        for clause in re.split(r"\bAND\b", s):
            clause = clause.strip()
            if not clause:
                continue
            m = _TOKEN.fullmatch(clause)
            if not m:
                raise ValueError(f"bad query clause: {clause!r}")
            val = m.group("val")
            if val is not None and val.startswith("'"):
                val = val[1:-1]
            op = m.group("op")
            if op == "EXISTS" and val is not None:
                raise ValueError("EXISTS takes no value")
            if op != "EXISTS" and val is None:
                raise ValueError(f"operator {op} needs a value")
            self.conditions.append(_Condition(m.group("key"), op, val))
        if not self.conditions:
            raise ValueError("empty query")

    def matches(self, events: dict[str, list[str]]) -> bool:
        return all(c.matches(events) for c in self.conditions)


# ---------------------------------------------------------------- server --
@dataclass
class Message:
    data: object
    events: dict[str, list[str]] = field(default_factory=dict)


class SubscriptionCancelled(Exception):
    """The subscription was dropped (slow-consumer overflow or explicit
    unsubscribe); the consumer should resubscribe if it still cares."""


class Subscription:
    def __init__(self, query: Query, capacity: int = 256):
        self.query = query
        self.capacity = capacity
        self._buf: list[Message] = []
        self._cv = threading.Condition()
        self.cancelled = False

    def publish(self, msg: Message) -> None:
        """Buffer a matching message; a subscriber that stops draining is
        cancelled at capacity (reference pubsub drops slow subscribers
        rather than buffering unboundedly — internal/pubsub/pubsub.go)."""
        with self._cv:
            if self.cancelled:
                return
            if len(self._buf) >= self.capacity:
                self.cancelled = True
                self._buf.clear()
                self._cv.notify_all()
                return
            self._buf.append(msg)
            self._cv.notify_all()

    def next(self, timeout: float | None = None) -> Message | None:
        """Pop the next message, or None on timeout. Raises
        SubscriptionCancelled once the subscription was dropped (capacity
        overflow or unsubscribe) so consumers can resubscribe instead of
        polling a dead buffer forever."""
        with self._cv:
            if self.cancelled:
                raise SubscriptionCancelled(self.query.source)
            if not self._buf:
                self._cv.wait(timeout)
            if self.cancelled:
                raise SubscriptionCancelled(self.query.source)
            if self._buf:
                return self._buf.pop(0)
            return None

    def cancel(self) -> None:
        with self._cv:
            self.cancelled = True
            self._buf.clear()
            self._cv.notify_all()

    def drain(self) -> list[Message]:
        with self._cv:
            out, self._buf = self._buf, []
            return out


class PubSubServer:
    def __init__(self):
        self._subs: dict[tuple[str, str], Subscription] = {}
        self._lock = threading.Lock()

    def subscribe(self, client_id: str, query_str: str) -> Subscription:
        q = Query(query_str)
        sub = Subscription(q)
        with self._lock:
            self._subs[(client_id, query_str)] = sub
        return sub

    def unsubscribe(self, client_id: str, query_str: str) -> None:
        with self._lock:
            sub = self._subs.pop((client_id, query_str), None)
        if sub:
            sub.cancel()

    def unsubscribe_all(self, client_id: str) -> None:
        with self._lock:
            gone = [k for k in self._subs if k[0] == client_id]
            for k in gone:
                self._subs.pop(k).cancel()

    def publish(self, data, events: dict[str, list[str]] | None = None) -> None:
        msg = Message(data, events or {})
        with self._lock:
            subs = list(self._subs.items())
        dead = []
        for key, sub in subs:
            if sub.cancelled:
                dead.append(key)
                continue
            if sub.query.matches(msg.events):
                sub.publish(msg)
        if dead:
            with self._lock:
                for key in dead:
                    if self._subs.get(key) is not None and self._subs[key].cancelled:
                        self._subs.pop(key, None)
