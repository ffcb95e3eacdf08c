"""ABCI clients (twin of `cometbft_tpu/abci/client.py`).

LocalClient: in-process, mutex-serialized (reference abci/client/
local_client.go) — one lock shared by the four logical connections
(reference proxy/multi_app_conn.go keeps consensus/mempool/query/snapshot
conns over one creator).
"""

from __future__ import annotations

import threading

from .types import Application


class LocalClient:
    """Serialized in-process ABCI client; method set mirrors Application."""

    def __init__(self, app: Application, lock: threading.Lock | None = None):
        self._app = app
        self._lock = lock or threading.Lock()

    def __getattr__(self, name):
        fn = getattr(self._app, name)
        if not callable(fn):
            return fn

        def wrapper(*a, **kw):
            with self._lock:
                return fn(*a, **kw)

        return wrapper


class AppConns:
    """The four logical ABCI connections over one application
    (reference proxy/multi_app_conn.go)."""

    def __init__(self, app: Application):
        lock = threading.Lock()
        self.consensus = LocalClient(app, lock)
        self.mempool = LocalClient(app, lock)
        self.query = LocalClient(app, lock)
        self.snapshot = LocalClient(app, lock)
