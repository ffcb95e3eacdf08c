"""EventBus: typed pub/sub facade over the pubsub server.

Behavior parity: reference types/event_bus.go (:34) + types/events.go —
publishes EventNewBlock, EventTx and EventValidatorSetUpdates with the
standard composite keys (`tm.event='NewBlock'`, `tx.height`, `tx.hash`)
that subscribers and indexers filter on.

Twin of `cometbft_tpu/types/event_bus.py`, without its `publish_vote`
and its NewBlockHeader name, which nothing uses.
"""

from __future__ import annotations

from ..utils.pubsub import PubSubServer, Subscription

EVENT_NEW_BLOCK = "NewBlock"
EVENT_TX = "Tx"
EVENT_VALIDATOR_SET_UPDATES = "ValidatorSetUpdates"

TYPE_KEY = "tm.event"


class EventBus:
    def __init__(self):
        self._server = PubSubServer()

    def subscribe(self, client_id: str, query: str) -> Subscription:
        return self._server.subscribe(client_id, query)

    def unsubscribe(self, client_id: str, query: str) -> None:
        self._server.unsubscribe(client_id, query)

    def unsubscribe_all(self, client_id: str) -> None:
        self._server.unsubscribe_all(client_id)

    # ------------------------------------------------------------------
    def publish_new_block(self, block, finalize_resp) -> None:
        h = str(block.header.height)
        events = {TYPE_KEY: [EVENT_NEW_BLOCK], "block.height": [h]}
        _merge_abci_events(events, getattr(finalize_resp, "events", []))
        self._server.publish(
            {"type": EVENT_NEW_BLOCK, "block": block, "result": finalize_resp},
            events,
        )

    def publish_tx(self, height: int, index: int, tx: bytes, result) -> None:
        from ..crypto.keys import tmhash

        events = {
            TYPE_KEY: [EVENT_TX],
            "tx.height": [str(height)],
            "tx.hash": [tmhash(tx).hex().upper()],
        }
        _merge_abci_events(events, getattr(result, "events", []))
        self._server.publish(
            {"type": EVENT_TX, "height": height, "index": index, "tx": tx,
             "result": result},
            events,
        )

    def publish_validator_set_updates(self, updates) -> None:
        self._server.publish(
            {"type": EVENT_VALIDATOR_SET_UPDATES, "updates": updates},
            {TYPE_KEY: [EVENT_VALIDATOR_SET_UPDATES]},
        )


def _merge_abci_events(events: dict, abci_events) -> None:
    """ABCI events are (type, [(key, value)]) pairs; composite key is
    type.key (reference types/events.go)."""
    for ev in abci_events or []:
        etype = getattr(ev, "type", None) or (ev[0] if isinstance(ev, tuple) else None)
        attrs = getattr(ev, "attributes", None) or (
            ev[1] if isinstance(ev, tuple) else []
        )
        for item in attrs:
            k = item[0] if isinstance(item, tuple) else getattr(item, "key", "")
            v = item[1] if isinstance(item, tuple) else getattr(item, "value", "")
            if isinstance(k, bytes):
                k = k.decode("utf-8", "replace")
            if isinstance(v, bytes):
                v = v.decode("utf-8", "replace")
            events.setdefault(f"{etype}.{k}", []).append(str(v))
