"""ABCI socket server and client.

Behavior parity: reference abci/server/socket_server.go +
abci/client/socket_client.go —
- varint-length-delimited frames over a unix or tcp socket;
- the client PIPELINES: a writer thread drains a request queue while a
  reader thread matches responses in order (reference sendRequestsRoutine
  :129 / recvResponseRoutine :165); sync callers enqueue and wait;
- the server handles one connection's requests strictly in order
  (reference handleRequests).

The kvstore app runs out-of-process over this (tests/test_abci_socket.py
kills and restarts it mid-chain; the Handshaker replays the app to tip —
reference internal/consensus/replay.go:241,283).

Twin of `cometbft_tpu/abci/socket.py`: a port client talks to a
reference server and a reference client to a port server.
"""

from __future__ import annotations

import os
import queue
import socket
import threading

from . import wire as W
from . import types as T


def _read_exact(sock: socket.socket):
    def reader(n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("socket closed")
            buf += chunk
        return buf

    return reader


def dispatch_abci(app: T.Application, method: int, payload: bytes) -> bytes:
    """Decode request payload, call the app, encode the response — the
    transport-independent ABCI server core shared by the socket and gRPC
    servers (caller holds any app serialization lock)."""
    from ..encoding import proto as pb

    if method == W.ECHO:
        return payload
    if method == W.FLUSH:
        return b""
    if method == W.INFO:
        return W.enc_info_resp(app.info())
    if method == W.INIT_CHAIN:
        return W.enc_init_chain_resp(
            app.init_chain(W.dec_init_chain_req(payload))
        )
    if method == W.QUERY:
        path, data, height = W.dec_query_req(payload)
        return W.enc_query_resp(app.query(path, data, height))
    if method == W.CHECK_TX:
        return W.enc_check_tx_resp(app.check_tx(payload))
    if method == W.PREPARE_PROPOSAL:
        d = pb.fields_to_dict(payload)
        txs = W.dec_tx_list(pb.as_bytes(d.get(1, b"")))
        max_bytes = pb.to_i64(d.get(2, 0))
        return W.enc_tx_list(app.prepare_proposal(txs, max_bytes))
    if method == W.PROCESS_PROPOSAL:
        txs = W.dec_tx_list(payload)
        return pb.f_varint(1, app.process_proposal(txs), emit_zero=True)
    if method == W.FINALIZE_BLOCK:
        return W.enc_finalize_resp(
            app.finalize_block(W.dec_finalize_req(payload))
        )
    if method == W.COMMIT:
        return pb.f_varint(1, app.commit(), emit_zero=True)
    raise ValueError(f"unknown ABCI method {method}")


class SocketServer:
    """Serves one Application over unix/tcp."""

    def __init__(self, app: T.Application, addr: str):
        """addr: 'unix:///path' or 'tcp://host:port'."""
        self.app = app
        self.addr = addr
        self._listener: socket.socket | None = None
        self._threads: list[threading.Thread] = []
        self._stopped = threading.Event()
        self._app_lock = threading.Lock()

    def start(self) -> None:
        if self.addr.startswith("unix://"):
            path = self.addr[len("unix://"):]
            if os.path.exists(path):
                os.unlink(path)
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            s.bind(path)
        elif self.addr.startswith("tcp://"):
            host, port = self.addr[len("tcp://"):].rsplit(":", 1)
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind((host, int(port)))
        else:
            raise ValueError(f"bad addr {self.addr}")
        s.listen(8)
        s.settimeout(0.2)
        self._listener = s
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        self._threads.append(t)

    def _accept_loop(self) -> None:
        while not self._stopped.is_set():
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            t = threading.Thread(target=self._serve_conn, args=(conn,), daemon=True)
            t.start()
            self._threads.append(t)

    def _serve_conn(self, conn: socket.socket) -> None:
        reader = _read_exact(conn)
        try:
            while not self._stopped.is_set():
                method, payload = W.read_frame(reader)
                resp = self._dispatch(method, payload)
                conn.sendall(W.frame(method, resp))
        except (ConnectionError, OSError):
            pass
        finally:
            conn.close()

    def _dispatch(self, method: int, payload: bytes) -> bytes:
        with self._app_lock:
            return dispatch_abci(self.app, method, payload)

    def stop(self) -> None:
        self._stopped.set()
        if self._listener is not None:
            self._listener.close()


class SocketClient:
    """Pipelined ABCI socket client with the LocalClient's method surface."""

    def __init__(self, addr: str, timeout: float = 30.0):
        self.addr = addr
        self.timeout = timeout
        if addr.startswith("unix://"):
            self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self._sock.connect(addr[len("unix://"):])
        elif addr.startswith("tcp://"):
            host, port = addr[len("tcp://"):].rsplit(":", 1)
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._sock.connect((host, int(port)))
        else:
            raise ValueError(f"bad addr {addr}")
        self._send_q: queue.Queue = queue.Queue()
        self._pending: queue.Queue = queue.Queue()  # response futures, in order
        self._closed = threading.Event()
        self._writer = threading.Thread(target=self._send_loop, daemon=True)
        self._reader = threading.Thread(target=self._recv_loop, daemon=True)
        self._writer.start()
        self._reader.start()

    # -- pipelined transport (reference socket_client.go:129,165) ----------
    def _send_loop(self) -> None:
        while not self._closed.is_set():
            try:
                item = self._send_q.get(timeout=0.2)
            except queue.Empty:
                continue
            method, payload, fut = item
            self._pending.put(fut)
            try:
                self._sock.sendall(W.frame(method, payload))
            except OSError as e:
                fut["error"] = e
                fut["event"].set()
                return

    def _recv_loop(self) -> None:
        reader = _read_exact(self._sock)
        while not self._closed.is_set():
            try:
                method, payload = W.read_frame(reader)
            except (ConnectionError, OSError) as e:
                # fail all pending futures
                while True:
                    try:
                        fut = self._pending.get_nowait()
                    except queue.Empty:
                        break
                    fut["error"] = e
                    fut["event"].set()
                return
            fut = self._pending.get()
            fut["method"] = method
            fut["payload"] = payload
            fut["event"].set()

    def _call(self, method: int, payload: bytes = b"") -> bytes:
        fut = {"event": threading.Event()}
        self._send_q.put((method, payload, fut))
        if not fut["event"].wait(self.timeout):
            raise TimeoutError(f"ABCI call {method} timed out")
        if "error" in fut:
            raise ConnectionError(f"ABCI connection failed: {fut['error']}")
        return fut["payload"]

    def close(self) -> None:
        self._closed.set()
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()

    # -- Application-shaped surface ---------------------------------------
    def echo(self, msg: bytes) -> bytes:
        return self._call(W.ECHO, msg)

    def flush(self) -> None:
        self._call(W.FLUSH)

    def info(self) -> T.InfoResponse:
        return W.dec_info_resp(self._call(W.INFO))

    def init_chain(self, req: T.InitChainRequest) -> T.InitChainResponse:
        return W.dec_init_chain_resp(
            self._call(W.INIT_CHAIN, W.enc_init_chain_req(req))
        )

    def query(self, path: str, data: bytes, height: int = 0) -> T.QueryResponse:
        return W.dec_query_resp(
            self._call(W.QUERY, W.enc_query_req(path, data, height))
        )

    def check_tx(self, tx: bytes) -> T.CheckTxResult:
        return W.dec_check_tx_resp(self._call(W.CHECK_TX, tx))

    def check_txs(self, txs: list[bytes]) -> list[T.CheckTxResult]:
        """Pipelined batch CheckTx: enqueue every request before waiting
        on any response, so one admission window costs one round-trip of
        latency instead of len(txs) (the transport already preserves
        order via the pending queue)."""
        futs = []
        for tx in txs:
            fut = {"event": threading.Event()}
            self._send_q.put((W.CHECK_TX, tx, fut))
            futs.append(fut)
        out = []
        for fut in futs:
            if not fut["event"].wait(self.timeout):
                raise TimeoutError("ABCI batch check_tx timed out")
            if "error" in fut:
                raise ConnectionError(
                    f"ABCI connection failed: {fut['error']}")
            out.append(W.dec_check_tx_resp(fut["payload"]))
        return out

    def prepare_proposal(self, txs: list[bytes], max_tx_bytes: int,
                         local_last_commit=None) -> list[bytes]:
        from ..encoding import proto as pb

        payload = pb.f_embedded(1, W.enc_tx_list(txs)) + pb.f_varint(2, max_tx_bytes)
        return W.dec_tx_list(self._call(W.PREPARE_PROPOSAL, payload))

    def process_proposal(self, txs: list[bytes]) -> int:
        from ..encoding import proto as pb

        out = self._call(W.PROCESS_PROPOSAL, W.enc_tx_list(txs))
        return int(pb.fields_to_dict(out).get(1, 0))

    def finalize_block(self, req: T.FinalizeBlockRequest) -> T.FinalizeBlockResponse:
        return W.dec_finalize_resp(
            self._call(W.FINALIZE_BLOCK, W.enc_finalize_req(req))
        )

    def commit(self) -> int:
        from ..encoding import proto as pb

        return int(pb.fields_to_dict(self._call(W.COMMIT)).get(1, 0))


class SocketAppConns:
    """proxy.AppConns over one socket address: four pipelined clients
    (reference proxy/multi_app_conn.go keeps 4 logical connections)."""

    def __init__(self, addr: str):
        self.consensus = SocketClient(addr)
        self.mempool = SocketClient(addr)
        self.query = SocketClient(addr)
        self.snapshot = SocketClient(addr)

    def close(self) -> None:
        for c in (self.consensus, self.mempool, self.query, self.snapshot):
            c.close()
