"""TCP transport with the secret-connection + node-info upgrade.

Twin of `cometbft_tpu/p2p/transport.py`. Behavior parity: reference p2p/transport.go — MultiplexTransport accept/
dial (:137), `upgrade` (:410): wrap the raw conn in SecretConnection,
exchange NodeInfo, verify the authenticated key matches the claimed node
id and the chains/channels are compatible.
"""

from __future__ import annotations

import socket
import threading
import time
from dataclasses import dataclass

from ..encoding import proto as pb
from ..utils.log import logger
from .key import NodeKey
from .secret_connection import SecretConnection

_log = logger("p2p")


@dataclass
class NodeInfo:
    """reference p2p/node_info.go DefaultNodeInfo."""

    node_id: str = ""
    listen_addr: str = ""
    network: str = ""  # chain id
    version: str = "0.1.0"
    channels: bytes = b""
    moniker: str = ""

    def encode(self) -> bytes:
        return (
            pb.f_string(1, self.node_id)
            + pb.f_string(2, self.listen_addr)
            + pb.f_string(3, self.network)
            + pb.f_string(4, self.version)
            + pb.f_bytes(5, self.channels)
            + pb.f_string(6, self.moniker)
        )

    @classmethod
    def decode(cls, buf: bytes) -> "NodeInfo":
        d = pb.fields_to_dict(buf)
        return cls(
            node_id=pb.as_bytes(d.get(1, b"")).decode(),
            listen_addr=pb.as_bytes(d.get(2, b"")).decode(),
            network=pb.as_bytes(d.get(3, b"")).decode(),
            version=pb.as_bytes(d.get(4, b"")).decode(),
            channels=pb.as_bytes(d.get(5, b"")),
            moniker=pb.as_bytes(d.get(6, b"")).decode(),
        )

    def compatible_with(self, other: "NodeInfo") -> bool:
        if self.network != other.network:
            return False
        return any(c in self.channels for c in other.channels)


class UpgradeError(Exception):
    pass


class Transport:
    def __init__(self, node_key: NodeKey, node_info: NodeInfo):
        self.node_key = node_key
        self.node_info = node_info
        self._listener: socket.socket | None = None
        self._stopped = threading.Event()
        self._last_accept_warn = 0.0

    # ------------------------------------------------------------------
    def listen(self, host: str = "127.0.0.1", port: int = 0) -> tuple[str, int]:
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((host, port))
        s.listen(16)
        s.settimeout(0.2)
        self._listener = s
        addr = s.getsockname()
        self.node_info.listen_addr = f"{addr[0]}:{addr[1]}"
        return addr[0], addr[1]

    def accept_raw(self):
        """Blocking accept of a raw TCP connection (no handshake), or
        None on stop. Callers upgrade on their own thread so one slow or
        silent dialer cannot stall peer admission (the reference upgrades
        concurrently — p2p/transport.go:410)."""
        while not self._stopped.is_set():
            try:
                raw, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError as e:
                if self._stopped.is_set():
                    return None  # listener closed by close()
                # transient accept failure (EMFILE while a neighboring
                # process churns descriptors, interrupted syscall, ...):
                # a permanent return here would silently kill inbound
                # peer admission for the node's remaining lifetime.
                # Pause briefly so a hot error can't spin on the GIL,
                # and log (rate-limited) so a PERMANENTLY broken
                # listener is visible to operators.
                now = time.monotonic()
                if now - self._last_accept_warn > 5.0:
                    self._last_accept_warn = now
                    _log.warn("accept failed; retrying",
                              err=f"{type(e).__name__}: {e}"[:80])
                time.sleep(0.05)
                continue
            return raw
        return None

    def accept(self):
        """Blocking accept -> (SecretConnection, NodeInfo) or None on stop.

        Serial convenience path (tests, simple tools); the Switch uses
        accept_raw + upgrade on a per-connection thread."""
        raw = self.accept_raw()
        if raw is None:
            return None
        return self._upgrade(raw)

    def upgrade(self, raw: socket.socket):
        return self._upgrade(raw)

    def dial(self, host: str, port: int):
        raw = socket.create_connection((host, port), timeout=10)
        return self._upgrade(raw)

    def _upgrade(self, raw: socket.socket):
        """SecretConnection handshake + NodeInfo exchange (reference :410)."""
        raw.settimeout(10)
        sc = SecretConnection(raw, self.node_key.priv_key)
        sc.write_msg(self.node_info.encode())
        their = NodeInfo.decode(sc.read_msg())
        authed_id = sc.remote_pub_key.address().hex()
        if their.node_id != authed_id:
            sc.close()
            raise UpgradeError(
                f"node id {their.node_id} != authenticated key {authed_id}"
            )
        if not self.node_info.compatible_with(their):
            sc.close()
            raise UpgradeError("incompatible peer (network/channels)")
        raw.settimeout(None)
        return sc, their

    def close(self) -> None:
        self._stopped.set()
        if self._listener is not None:
            self._listener.close()
