"""Twin of `cometbft_tpu/state/pruner.py`. Background pruner service.

Behavior parity: reference internal/state/pruner.go (509 LoC) — a
service that periodically prunes block and state stores up to an
"effective retain height": the minimum of the application's retain
height (returned by ABCI Commit) and, when a data companion is enabled,
the companion's block/block-results retain heights (settable via the
privileged pruning RPC service). Heights are persisted so pruning
resumes across restarts.
"""

from __future__ import annotations

import threading

_KEY_APP_RETAIN = b"PR:app"
_KEY_COMPANION_BLOCK = b"PR:dcb"
_KEY_COMPANION_RESULTS = b"PR:dcr"


class Pruner:
    def __init__(
        self,
        block_store,
        state_store,
        interval_s: float = 10.0,
        companion_enabled: bool = False,
    ):
        self.block_store = block_store
        self.state_store = state_store
        self.interval_s = interval_s
        self.companion_enabled = companion_enabled
        self._db = state_store._db
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stopped = threading.Event()
        self._thread: threading.Thread | None = None

    # -- retain-height setters (persisted) ---------------------------------
    def _get(self, key: bytes) -> int:
        raw = self._db.get(key)
        return int.from_bytes(raw, "big") if raw else 0

    def _set(self, key: bytes, h: int) -> None:
        self._db.set(key, h.to_bytes(8, "big"))

    def set_app_retain_height(self, h: int) -> None:
        """From ABCI Commit's retain_height (reference SetApplicationBlockRetainHeight)."""
        if h <= 0:
            return
        with self._lock:
            if h > self._get(_KEY_APP_RETAIN):
                self._set(_KEY_APP_RETAIN, h)
        self._wake.set()

    def set_companion_block_retain_height(self, h: int) -> None:
        if h <= 0:
            raise ValueError("retain height must be positive")
        with self._lock:
            self._set(_KEY_COMPANION_BLOCK, h)
        self._wake.set()

    def set_companion_block_results_retain_height(self, h: int) -> None:
        if h <= 0:
            raise ValueError("retain height must be positive")
        with self._lock:
            self._set(_KEY_COMPANION_RESULTS, h)
        self._wake.set()

    def app_retain_height(self) -> int:
        return self._get(_KEY_APP_RETAIN)

    def companion_block_retain_height(self) -> int:
        return self._get(_KEY_COMPANION_BLOCK)

    def companion_block_results_retain_height(self) -> int:
        return self._get(_KEY_COMPANION_RESULTS)

    def effective_retain_height(self) -> int:
        """min(app, companion) when the companion is enabled, else app
        (reference pruner.go findMinRetainHeight)."""
        app = self._get(_KEY_APP_RETAIN)
        if not self.companion_enabled:
            return app
        # companion enabled but silent (height 0) blocks pruning — its
        # data needs are unknown, so nothing may be deleted yet
        return min(app, self._get(_KEY_COMPANION_BLOCK))

    # -- service ------------------------------------------------------------
    def prune_once(self) -> tuple[int, int]:
        """One pruning pass; returns (blocks_pruned, states_pruned)."""
        retain = self.effective_retain_height()
        if retain <= 1:
            return 0, 0
        blocks = self.block_store.prune(retain)
        states = self.state_store.prune(retain, self.block_store.height())
        return blocks, states

    def _run(self) -> None:
        while not self._stopped.is_set():
            try:
                self.prune_once()
            except Exception:  # noqa: BLE001 — pruning must never kill the node
                pass
            self._wake.wait(self.interval_s)
            self._wake.clear()

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stopped.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
