"""RPC clients (reference rpc/client/http + rpc/client/local); twin of
`cometbft_tpu/rpc/client.py`."""

from __future__ import annotations

import json
import urllib.request


class HTTPClient:
    def __init__(self, base_url: str, timeout: float = 30.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self._id = 0

    def call(self, method: str, params: dict | None = None,
             timeout: float | None = None):
        self._id += 1
        body = json.dumps({
            "jsonrpc": "2.0", "id": self._id, "method": method,
            "params": params or {},
        }).encode()
        req = urllib.request.Request(
            self.base_url, data=body,
            headers={"Content-Type": "application/json"},
        )
        t = self.timeout if timeout is None else timeout
        with urllib.request.urlopen(req, timeout=t) as resp:
            out = json.loads(resp.read())
        if "error" in out:
            raise RuntimeError(f"rpc error: {out['error']}")
        return out["result"]

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)

        def method(**params):
            return self.call(name, params)

        return method


class LocalClient:
    """In-process client over the same route table
    (reference rpc/client/local)."""

    def __init__(self, env):
        from .routes import ROUTES

        self._env = env
        self._routes = ROUTES

    def call(self, method: str, params: dict | None = None):
        fn = self._routes[method]
        return fn(self._env, params or {})

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)

        def method(**params):
            return self.call(name, params)

        return method
