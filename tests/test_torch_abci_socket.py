"""The port's ABCI socket and wire codecs held against the JAX package on
the CPU.

- Every codec of `abci/wire.py` writes the reference's bytes on a
  numpy-seeded corpus, and reads them back to the same values.
- A port client drives a reference server and a reference client a port
  server, each over a unix socket, with the same answers as the app
  called in process; the handshake replays a chain into an app behind a
  socket (tests/test_abci_socket.py:84).
"""

import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cometbft_tpu.abci import socket as RS  # noqa: E402
from cometbft_tpu.abci import types as RT  # noqa: E402
from cometbft_tpu.abci import wire as RW  # noqa: E402
from cometbft_tpu.abci.kvstore import KVStoreApp as RKVStoreApp  # noqa: E402
from cometbft_tpu.types.basic import Timestamp as RTimestamp  # noqa: E402
from cometbft_tpu_torch.abci import socket as PS  # noqa: E402
from cometbft_tpu_torch.abci import types as PT  # noqa: E402
from cometbft_tpu_torch.abci import wire as PW  # noqa: E402
from cometbft_tpu_torch.abci.kvstore import KVStoreApp as PKVStoreApp  # noqa: E402
from cometbft_tpu_torch.types.basic import Timestamp as PTimestamp  # noqa: E402


def _corpus(T, Ts, seed):
    """One of each request and response type, from `seed`, built from
    package T's dataclasses (Ts its Timestamp)."""
    rng = np.random.default_rng(seed)

    def b(n=None):
        return rng.bytes(int(rng.integers(0, 40)) if n is None else n)

    def i(hi=1 << 40):
        return int(rng.integers(0, hi))

    def vu():
        return T.ValidatorUpdate(b(32), ["ed25519", "secp256k1"][i(2)], i())

    def ts():
        return Ts(i(1 << 33), i(10**9))

    return {
        "tx_list": [b() for _ in range(i(5))] + [b""],
        "finalize_req": T.FinalizeBlockRequest(
            txs=[b() for _ in range(i(4))],
            decided_last_commit=T.CommitInfo(i(5), [(b(20), i(), bool(i(2))) for _ in range(3)]),
            misbehavior=[T.Misbehavior(1 + i(2), b(20), i(), i(), ts(), i()) for _ in range(i(3))],
            hash=b(32), height=i(), time=ts(), next_validators_hash=b(32),
            proposer_address=b(20)),
        "finalize_resp": T.FinalizeBlockResponse(
            tx_results=[T.ExecTxResult(i(3), b(), "log%d" % i(), i(), i()) for _ in range(3)],
            validator_updates=[vu() for _ in range(i(3))], app_hash=b(32)),
        "info_resp": T.InfoResponse("data", "v1", i(), i(), b(32)),
        "check_tx_resp": T.CheckTxResult(i(3), b(), "check", i()),
        "query_req": ("/store", b(), i()),
        "query_resp": T.QueryResponse(i(3), b(), b(), i(), "q"),
        "init_chain_req": T.InitChainRequest(ts(), "chain-%d" % i(), [vu() for _ in range(3)],
                                             b(), 1 + i()),
        "init_chain_resp": T.InitChainResponse([vu() for _ in range(2)], b(32)),
    }


def _plain(x):
    """A dataclass tree as plain values (the packages' classes differ)."""
    if dataclasses.is_dataclass(x):
        return {f.name: _plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if hasattr(x, "seconds") and hasattr(x, "nanos"):
        return (x.seconds, x.nanos)
    return x


@pytest.mark.parametrize("seed", range(6))
def test_every_codec_writes_the_references_bytes(seed):
    p, r = _corpus(PT, PTimestamp, seed), _corpus(RT, RTimestamp, seed)
    for name in p:
        enc_p, enc_r = getattr(PW, "enc_" + name), getattr(RW, "enc_" + name)
        args_p = p[name] if name == "query_req" else (p[name],)
        args_r = r[name] if name == "query_req" else (r[name],)
        raw = enc_r(*args_r)
        assert enc_p(*args_p) == raw, name
        dec_p, dec_r = getattr(PW, "dec_" + name), getattr(RW, "dec_" + name)
        assert _plain(dec_p(raw)) == _plain(dec_r(raw)), name
    for method in range(1, 17):
        payload = np.random.default_rng(seed + method).bytes(seed * 50)
        framed = PW.frame(method, payload)
        assert framed == RW.frame(method, payload)
        pos = [0]

        def read(n, buf=framed):
            out = buf[pos[0]:pos[0] + n]
            pos[0] += n
            return out

        assert PW.read_frame(read) == (method, payload)
    ids = [k for k in dir(RW) if k.isupper() and isinstance(getattr(RW, k), int)]
    assert len(ids) == 16 and [getattr(PW, k) for k in ids] == [getattr(RW, k) for k in ids]


def _drive(client_cls, T, Ts):
    """The client's answers to one of each call, as plain values."""
    def run(addr):
        c = client_cls(addr)
        try:
            out = [c.echo(b"hi"), c.info(), c.init_chain(T.InitChainRequest(
                Ts(5, 6), "sock-chain", [T.ValidatorUpdate(b"\x01" * 32, "ed25519", 10)]))]
            out.append(c.check_tx(b"k=v"))
            out.append(c.check_txs([b"a=1", b"bad", b"b=2"]))
            out.append(c.prepare_proposal([b"a=1", b"b=2"], 1 << 20))
            out.append(c.process_proposal([b"a=1", b"bad"]))
            out.append(c.finalize_block(T.FinalizeBlockRequest(
                txs=[b"a=1", b"b=2", b"bad"], height=1, time=Ts(7, 8), hash=b"\x02" * 32)))
            out.append(c.commit())
            out.append(c.query("", b"a", 0))
            c.flush()
            return _plain(out)
        finally:
            c.close()
    return run


@pytest.mark.parametrize("server, client", [("ref", "port"), ("port", "ref")])
def test_client_and_server_across_the_packages(tmp_path, server, client):
    """A port client with a reference server, and the reverse: every call's
    answer equals the in-process app's, and 8 threads pipelining echoes over
    one client all get their own answers."""
    addr = f"unix://{tmp_path}/app.sock"
    srv_mod, app = (RS, RKVStoreApp()) if server == "ref" else (PS, PKVStoreApp())
    srv = srv_mod.SocketServer(app, addr)
    srv.start()
    try:
        if client == "port":
            got = _drive(PS.SocketClient, PT, PTimestamp)(addr)
        else:
            got = _drive(RS.SocketClient, RT, RTimestamp)(addr)
        c = (PS if client == "port" else RS).SocketClient(addr)
        errs = []

        def worker(k):
            try:
                for j in range(20):
                    assert c.echo(b"m%d-%d" % (k, j)) == b"m%d-%d" % (k, j)
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        threads = [threading.Thread(target=worker, args=(k,)) for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        c.close()
        assert not errs
    finally:
        srv.stop()

    class Local:
        """The same calls on an in-process app of the client's package."""

        def __init__(self, addr):
            self.app = PKVStoreApp() if client == "port" else RKVStoreApp()

        def echo(self, m):
            return m

        def check_txs(self, txs):
            return [self.app.check_tx(t) for t in txs]

        def flush(self):
            pass

        def close(self):
            pass

        def __getattr__(self, name):
            return getattr(self.app, name)

    T, Ts = (PT, PTimestamp) if client == "port" else (RT, RTimestamp)
    want = _drive(Local, T, Ts)(None)
    assert got == want
    assert got[0] == b"hi" and got[7]["app_hash"] and got[9]["value"] == b"1"


def test_socket_app_conns_handshake_replays_the_chain(tmp_path):
    """tests/test_abci_socket.py:84 on the port: a fresh app behind a
    socket (a reference server), replayed to the tip by the port's
    Handshaker through SocketAppConns, to the chain's app hash."""
    from cometbft_tpu.utils.factories import make_chain
    from cometbft_tpu_torch.state.handshake import Handshaker
    from cometbft_tpu_torch.state.types import State
    from cometbft_tpu_torch.storage import BlockStore, MemKV, StateStore

    store, state, genesis, _ = make_chain(6, n_validators=4, chain_id="hs-chain", backend="cpu")
    kv = MemKV()
    kv.write_batch(sorted(store._db.iterate_prefix(b"")))
    addr = f"unix://{tmp_path}/app.sock"
    srv = RS.SocketServer(RKVStoreApp(), addr)
    srv.start()
    conns = PS.SocketAppConns(addr)
    try:
        hs = Handshaker(StateStore(MemKV()), BlockStore(kv), State.decode(genesis.encode()),
                        device="cpu")
        out = hs.handshake(conns)
        assert hs.blocks_replayed == 6 and out.encode() == state.encode()
        assert conns.query.query("/store", b"k1-0").value != b""
    finally:
        conns.close()
        srv.stop()
