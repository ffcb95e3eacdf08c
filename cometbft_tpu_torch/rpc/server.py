"""JSON-RPC 2.0 server: HTTP POST + GET-URI + WebSocket subscriptions.

Behavior parity: reference rpc/jsonrpc/server — http_json_handler.go
(POST body {jsonrpc, id, method, params}), uri handler (GET
/method?param=value), and ws_handler.go (subscribe/unsubscribe streaming
events). The WebSocket implementation is a minimal RFC 6455 server
(text frames, no extensions) on top of the same threading HTTP server.

Twin of `cometbft_tpu/rpc/server.py`. /light_stream and /replication_feed
answer 503 "disabled", as the reference's node does with those surfaces
off.
"""

from __future__ import annotations

import base64
import hashlib
import json
import struct
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qsl, urlparse

from .routes import ROUTES, RPCError

_WS_MAGIC = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"


def _ws_accept(key: str) -> str:
    return base64.b64encode(
        hashlib.sha1((key + _WS_MAGIC).encode()).digest()
    ).decode()


def _ws_send_text(wfile, data: str) -> None:
    payload = data.encode()
    header = b"\x81"  # FIN + text
    n = len(payload)
    if n < 126:
        header += bytes([n])
    elif n < 65536:
        header += bytes([126]) + struct.pack(">H", n)
    else:
        header += bytes([127]) + struct.pack(">Q", n)
    wfile.write(header + payload)
    wfile.flush()


def _ws_read_frame(rfile) -> tuple[int, bytes] | None:
    head = rfile.read(2)
    if len(head) < 2:
        return None
    opcode = head[0] & 0x0F
    masked = head[1] & 0x80
    n = head[1] & 0x7F
    if n == 126:
        n = struct.unpack(">H", rfile.read(2))[0]
    elif n == 127:
        n = struct.unpack(">Q", rfile.read(8))[0]
    mask = rfile.read(4) if masked else b"\x00" * 4
    data = bytearray(rfile.read(n))
    for i in range(len(data)):
        data[i] ^= mask[i % 4]
    return opcode, bytes(data)


class RPCServer:
    def __init__(self, env, host: str = "127.0.0.1", port: int = 0,
                 routes=None):
        self.env = env
        self.routes = ROUTES if routes is None else routes
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet
                pass

            # ---- JSON-RPC over POST --------------------------------
            def do_POST(self):
                try:
                    ln = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(ln) or b"{}")
                except Exception:
                    return self._respond_err(None, -32700, "parse error")
                self._dispatch(req)

            # ---- URI routes + websocket over GET -------------------
            def do_GET(self):
                if self.headers.get("Upgrade", "").lower() == "websocket":
                    return self._websocket()
                u = urlparse(self.path)
                method = u.path.strip("/")
                params = dict(parse_qsl(u.query))
                if method == "light_stream":
                    return self._light_stream(params)
                if method == "replication_feed":
                    return self._replication_feed(params)
                # URI params arrive as "5" (quoted) or 0xABC (hex) per the
                # reference's URI style; normalize both so handlers that
                # do bytes.fromhex / int() see plain values. The 0x strip
                # only applies to byte-valued params — a quoted string
                # legitimately starting with 0x must survive.
                for k, v in params.items():
                    quoted = len(v) >= 2 and v[0] == v[-1] == '"'
                    v = v.strip('"')
                    if not quoted and k in ("tx", "hash", "data", "evidence") \
                            and (v.startswith("0x") or v.startswith("0X")):
                        v = v[2:]
                    params[k] = v
                self._dispatch({"jsonrpc": "2.0", "id": -1, "method": method,
                                "params": params})

            def _dispatch(self, req):
                method = req.get("method", "")
                rid = req.get("id", -1)
                fn = outer.routes.get(method)
                if fn is None:
                    return self._respond_err(rid, -32601,
                                             f"method {method} not found")
                try:
                    result = fn(outer.env, req.get("params") or {})
                except RPCError as e:
                    return self._respond_err(rid, e.code, str(e))
                except Exception as e:  # noqa: BLE001
                    return self._respond_err(rid, -32603, str(e))
                body = json.dumps(
                    {"jsonrpc": "2.0", "id": rid, "result": result}
                ).encode()
                self._write(200, body)

            def _respond_err(self, rid, code, msg):
                body = json.dumps(
                    {"jsonrpc": "2.0", "id": rid,
                     "error": {"code": code, "message": msg}}
                ).encode()
                self._write(200, body)

            def _write(self, status, body):
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            # ---- streams of the surfaces the port does not serve ----
            def _light_stream(self, params):
                """GET /light_stream: the reference's answer of a node
                whose light serving is off (light/serve.py is not in the
                port yet)."""
                body = json.dumps({"error": "light serving disabled"}).encode()
                return self._write(503, body)

            def _replication_feed(self, params):
                """GET /replication_feed: the reference's answer of a node
                whose replication feed is off (replication/ is not in the
                port yet)."""
                body = json.dumps({"error": "replication feed disabled"}
                                  ).encode()
                return self._write(503, body)

            # ---- websocket subscriptions ---------------------------
            def _websocket(self):
                key = self.headers.get("Sec-WebSocket-Key", "")
                self.send_response(101, "Switching Protocols")
                self.send_header("Upgrade", "websocket")
                self.send_header("Connection", "Upgrade")
                self.send_header("Sec-WebSocket-Accept", _ws_accept(key))
                self.end_headers()
                client_id = f"ws-{id(self)}"
                subs: dict[str, object] = {}
                lock = threading.Lock()
                stop = threading.Event()

                def pump():
                    from ..utils.pubsub import SubscriptionCancelled

                    while not stop.is_set():
                        with lock:
                            items = list(subs.items())
                        for q, sub in items:
                            try:
                                msg = sub.next(timeout=0.05)
                            except SubscriptionCancelled:
                                with lock:
                                    subs.pop(q, None)
                                try:
                                    with lock:
                                        _ws_send_text(self.wfile, json.dumps({
                                            "jsonrpc": "2.0",
                                            "id": -1,
                                            "error": {
                                                "code": -32000,
                                                "message": "subscription cancelled"
                                                           " (client too slow)",
                                                "data": q,
                                            },
                                        }))
                                except OSError:
                                    stop.set()
                                continue
                            if msg is None:
                                continue
                            try:
                                with lock:
                                    _ws_send_text(self.wfile, json.dumps({
                                        "jsonrpc": "2.0",
                                        "id": -1,
                                        "result": {
                                            "query": q,
                                            "data": _render_event(msg),
                                            "events": msg.events,
                                        },
                                    }))
                            except OSError:
                                stop.set()
                                return
                        if not items:
                            stop.wait(0.05)

                t = threading.Thread(target=pump, daemon=True)
                t.start()
                try:
                    while not stop.is_set():
                        frame = _ws_read_frame(self.rfile)
                        if frame is None:
                            break
                        opcode, data = frame
                        if opcode == 0x8:  # close
                            break
                        if opcode == 0x9:  # ping -> pong
                            with lock:
                                self.wfile.write(b"\x8a\x00")
                            continue
                        if opcode != 0x1:
                            continue
                        try:
                            req = json.loads(data)
                        except Exception:
                            continue
                        method = req.get("method")
                        params = req.get("params") or {}
                        rid = req.get("id", -1)
                        if method == "subscribe":
                            q = params.get("query", "")
                            try:
                                sub = outer.env.event_bus.subscribe(client_id, q)
                                with lock:
                                    subs[q] = sub
                                    _ws_send_text(self.wfile, json.dumps(
                                        {"jsonrpc": "2.0", "id": rid,
                                         "result": {}}))
                            except ValueError as e:
                                with lock:
                                    _ws_send_text(self.wfile, json.dumps(
                                        {"jsonrpc": "2.0", "id": rid,
                                         "error": {"code": -32602,
                                                   "message": str(e)}}))
                        elif method == "unsubscribe":
                            q = params.get("query", "")
                            outer.env.event_bus.unsubscribe(client_id, q)
                            with lock:
                                subs.pop(q, None)
                                _ws_send_text(self.wfile, json.dumps(
                                    {"jsonrpc": "2.0", "id": rid, "result": {}}))
                finally:
                    stop.set()
                    outer.env.event_bus.unsubscribe_all(client_id)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.addr = self._httpd.server_address
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()


def _render_event(msg) -> dict:
    d = msg.data
    if isinstance(d, dict):
        out = {"type": d.get("type", "")}
        if "height" in d:
            out["height"] = str(d["height"])
        if "tx" in d:
            out["tx"] = d["tx"].hex().upper()
        if "block" in d:
            out["block_height"] = str(d["block"].header.height)
        return out
    return {"type": str(type(d))}
