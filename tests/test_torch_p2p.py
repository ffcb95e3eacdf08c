"""The port's p2p layer (`cometbft_tpu_torch/p2p/`) and its ciphers
(`crypto/x25519.py`, `crypto/symmetric.py`) against the reference's, on
the CPU: the RFC vectors, the same bytes as the reference's functions on
random inputs, and a port node talking to a reference node over real
sockets in both directions (the reference's connection seals with the
`cryptography` package where it is installed, the port's in pure Python).
"""

import os
import signal
import socket
import threading
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from cometbft_tpu.crypto import symmetric as JS  # noqa: E402
from cometbft_tpu.crypto import x25519 as JX  # noqa: E402
from cometbft_tpu import p2p as JP  # noqa: E402
from cometbft_tpu_torch import p2p as P  # noqa: E402
from cometbft_tpu_torch.crypto import symmetric as S  # noqa: E402
from cometbft_tpu_torch.crypto import x25519 as X  # noqa: E402
from cometbft_tpu_torch.p2p.secret_connection import AuthError  # noqa: E402

rng = np.random.default_rng(7748)
PACKAGES = {"port": P, "reference": JP}
PAIRS = [("port", "reference"), ("reference", "port")]


@pytest.fixture(autouse=True)
def alarm():
    """Every socket test fails instead of hanging."""
    signal.signal(signal.SIGALRM, lambda *a: (_ for _ in ()).throw(TimeoutError("60 s")))
    signal.alarm(60)
    yield
    signal.alarm(0)


def test_x25519_rfc7748_vectors_and_the_reference():
    vectors = [
        ("a546e36bf0527c9d3b16154b82465edd62144c0ac1fc5a18506a2244ba449ac4",
         "e6db6867583030db3594c1a424b15f7c726624ec26b3353b10a903a6d0ab1c4c",
         "c3da55379de9c6908e94ea4df28d084f32eccf03491c71f754b4075577a28552"),
        ("4b66e9d4d1b4673c5ad22691957d6af5c11b6421e0ea01d42ca4169e7918ba0d",
         "e5210f12786811d3f4b7959d0538ae2c31dbe7106fc03c3efc4cd549c715a493",
         "95cbde9476e8907d7aade45cb4b873f88b595a68799fa152e6f8f7647aac7957"),
    ]
    for k, u, out in vectors:
        assert X.scalarmult(bytes.fromhex(k), bytes.fromhex(u)).hex() == out
    a = bytes.fromhex("77076d0a7318a57d3c16c17251b26645df4c2f87ebc0992ab177fba51db92c2a")
    b = bytes.fromhex("5dab087e624a8a4b79e17f8b83800ee66f3bb1292618b6fd1c2f8b27ff88e0eb")
    assert X.public_from_private(a).hex() == (
        "8520f0098930a754748b7ddcb43ef75a0dbf3a0d26381af4eba4a98eaa9b4e6a")
    shared = "4a5d9d5ba4ce2de1728e3bf480350f25e07e21c947d19e3376f09b3c1e161742"
    assert X.shared_secret(a, X.public_from_private(b)).hex() == shared
    assert X.shared_secret(b, X.public_from_private(a)).hex() == shared
    for _ in range(8):
        k, u = rng.bytes(32), rng.bytes(32)
        assert X.scalarmult(k, u) == JX.scalarmult(k, u)
    with pytest.raises(ValueError, match="zero"):
        X.shared_secret(a, bytes(32))  # a small-order peer point


def test_chacha20poly1305_rfc8439_vector_and_poly1305():
    key = bytes(range(0x80, 0xA0))
    nonce = bytes.fromhex("070000004041424344454647")
    aad = bytes.fromhex("50515253c0c1c2c3c4c5c6c7")
    pt = (b"Ladies and Gentlemen of the class of '99: If I could offer you only one tip "
          b"for the future, sunscreen would be it.")
    boxed = S.chacha20poly1305_seal(key, nonce, pt, aad)
    assert boxed[:16].hex() == "d31a8d34648e60db7b86afbc53ef7ec2"
    assert boxed[-16:].hex() == "1ae10b594f09e26a7e902ecbd0600691"
    assert S.chacha20poly1305_open(key, nonce, boxed, aad) == pt
    assert S.chacha20poly1305_open(key, nonce, boxed[:-1] + bytes([boxed[-1] ^ 1]), aad) is None
    poly_key = bytes.fromhex("85d6be7857556d337f4452fe42d506a80103808afb0db2fd4abff6af4149f51b")
    assert S.poly1305(poly_key, b"Cryptographic Forum Research Group").hex() == (
        "a8061dc1305136c6c22b8baf0c0127a9")
    assert S.hchacha20(bytes(range(32)), bytes.fromhex("000000090000004a0000000031415927")).hex() \
        == "82413b4227b27bfed30e42508a877d73a0f9e4d58a74a853c12ec41326d3ecdc"


@pytest.mark.parametrize("n", [0, 1, 63, 64, 65, 1028, 5000])
def test_ciphers_equal_the_reference(n):
    key, n12, n24, msg, aad = (rng.bytes(32), rng.bytes(12), rng.bytes(24), rng.bytes(n),
                               rng.bytes(n % 19))
    assert S.chacha20poly1305_seal(key, n12, msg, aad) == JS.chacha20poly1305_seal(key, n12, msg, aad)
    assert S.xchacha20poly1305_seal(key, n24, msg, aad) == JS.xchacha20poly1305_seal(key, n24, msg, aad)
    assert S.xchacha20poly1305_open(key, n24, JS.xchacha20poly1305_seal(key, n24, msg), b"") == msg
    assert S.secretbox_seal(msg, n24, key) == JS.secretbox_seal(msg, n24, key)
    assert S.secretbox_open(JS.secretbox_seal(msg, n24, key), n24, key) == msg
    for ctr in (0, 1, 2**32 - 1):
        assert S.chacha20_stream(key, n12, n, ctr) == JS.chacha20_stream(key, n12, n, ctr)
    assert S.xsalsa20_stream(key, n24, n) == JS.xsalsa20_stream(key, n24, n)
    secret = S.encrypt_symmetric(msg, key)
    if n:
        assert JS.decrypt_symmetric(secret, key) == msg and S.decrypt_symmetric(secret, key) == msg
    else:  # an empty plaintext is refused by both, as too short a ciphertext
        with pytest.raises(JS.ErrInvalidCiphertextLen):
            JS.decrypt_symmetric(secret, key)
        with pytest.raises(S.ErrInvalidCiphertextLen):
            S.decrypt_symmetric(secret, key)


def sc_pair(a_pkg, b_pkg):
    """A SecretConnection of package a_pkg and one of b_pkg over a socket
    pair, hand-shaken on two threads."""
    sa, sb = socket.socketpair()
    ka, kb = PACKAGES[a_pkg].NodeKey.generate(), PACKAGES[b_pkg].NodeKey.generate()
    out = {}
    t = threading.Thread(target=lambda: out.setdefault(
        "b", PACKAGES[b_pkg].SecretConnection(sb, kb.priv_key)))
    t.start()
    sca = PACKAGES[a_pkg].SecretConnection(sa, ka.priv_key)
    t.join(10)
    return sca, out["b"], ka, kb


class _FakeSock:
    def __init__(self, data):
        self._data = data

    def recv(self, n):
        out, self._data = self._data[:n], self._data[n:]
        return out

    def close(self):
        pass


@pytest.mark.parametrize("a_pkg,b_pkg", PAIRS)
def test_secret_connection_with_the_reference(a_pkg, b_pkg):
    sca, scb, ka, kb = sc_pair(a_pkg, b_pkg)
    try:
        assert sca.remote_pub_key.bytes() == kb.priv_key.pub_key().bytes()
        assert scb.remote_pub_key.bytes() == ka.priv_key.pub_key().bytes()
        for n in (0, 1, 1019, 1020, 1024, 3000, 5000):
            msg = rng.bytes(n)
            sca.write_msg(msg)
            assert scb.read_msg() == msg
            scb.write_msg(msg[::-1])
            assert sca.read_msg() == msg[::-1]
        port, other = (sca, scb) if a_pkg == "port" else (scb, sca)
        assert port.sealed_frames >= 10 and port.opened_frames >= 10 and port.seal_s > 0
        # a flipped byte in transit: the port's side refuses the frame
        raw_a, raw_b = socket.socketpair()
        other._sock = raw_a
        other.write_msg(b"payload")
        data = raw_b.recv(65536)
        port._sock = _FakeSock(bytes([data[0] ^ 0xFF]) + data[1:])
        with pytest.raises(AuthError, match="authentication failed"):
            port.read_msg()
        raw_a.close()
        raw_b.close()
    finally:
        sca.close()
        scb.close()


@pytest.mark.parametrize("a_pkg,b_pkg", PAIRS)
def test_mconnection_with_the_reference(a_pkg, b_pkg):
    """Channel priorities, multi-packet messages and peers at different
    packet sizes, a port MConnection against a reference one."""
    sca, scb, _, _ = sc_pair(a_pkg, b_pkg)
    got_a, got_b = [], []
    done_a, done_b = threading.Event(), threading.Event()
    descs_a = [PACKAGES[a_pkg].ChannelDescriptor(0x20, priority=5),
               PACKAGES[a_pkg].ChannelDescriptor(0x21, priority=1)]
    descs_b = [PACKAGES[b_pkg].ChannelDescriptor(0x20, priority=5),
               PACKAGES[b_pkg].ChannelDescriptor(0x21, priority=1)]
    big = bytes(range(256)) * 120

    def on_b(chan, msg):
        got_b.append((chan, msg))
        if len(got_b) == 4:
            done_b.set()

    ma = PACKAGES[a_pkg].MConnection(sca, descs_a, lambda c, m: (got_a.append((c, m)),
                                                                  done_a.set()),
                                     max_packet_payload_size=8192)
    mb = PACKAGES[b_pkg].MConnection(scb, descs_b, on_b, max_packet_payload_size=1024)
    ma.start()
    mb.start()
    try:
        assert ma.send(0x20, b"votes")
        assert ma.send(0x21, b"x" * 5000)
        assert ma.send(0x20, b"more-votes")
        assert ma.send(0x21, big)
        assert not ma.send(0x99, b"no such channel")
        assert done_b.wait(10), got_b
        by_chan = {}
        for c, m in got_b:
            by_chan.setdefault(c, []).append(m)
        assert by_chan == {0x20: [b"votes", b"more-votes"], 0x21: [b"x" * 5000, big]}
        assert mb.send(0x21, big[::-1])  # 1 KiB packets to an 8 KiB peer
        assert done_a.wait(10)
        assert got_a == [(0x21, big[::-1])]
    finally:
        ma.stop()
        mb.stop()


class EchoReactor:
    def __init__(self, pkg, chan=0x30):
        self.chan, self.pkg = chan, pkg
        self.received, self.event = [], threading.Event()

    def channels(self):
        return [PACKAGES[self.pkg].ChannelDescriptor(self.chan, priority=3)]

    def receive(self, chan_id, peer, msg):
        self.received.append((peer.id, msg))
        self.event.set()

    def add_peer(self, peer):
        pass

    def remove_peer(self, peer, reason):
        pass


def make_switch(pkg, chain="p2p-chain"):
    mod = PACKAGES[pkg]
    nk = mod.NodeKey.generate()
    tr = mod.Transport(nk, mod.NodeInfo(node_id=nk.node_id(), network=chain, moniker=pkg))
    sw = mod.Switch(tr)
    r = EchoReactor(pkg)
    sw.add_reactor(r)
    tr.listen()
    sw.start()
    return sw, r, tr


@pytest.mark.parametrize("dialer,listener", PAIRS)
def test_switch_with_the_reference(dialer, listener):
    sw1, r1, t1 = make_switch(listener)
    sw2, r2, t2 = make_switch(dialer)
    sw3, _, _ = make_switch(dialer, chain="another-chain")
    try:
        host, port = t1.node_info.listen_addr.split(":")
        peer = sw2.dial_peer(host, int(port))
        assert peer.id == t1.node_info.node_id
        deadline = time.monotonic() + 20
        while not sw1.peers() and time.monotonic() < deadline:
            time.sleep(0.02)
        assert [p.id for p in sw1.peers()] == [t2.node_info.node_id]
        sw2.broadcast(0x30, b"gossip")
        assert r1.event.wait(5) and r1.received == [(t2.node_info.node_id, b"gossip")]
        sw1.broadcast(0x30, b"reply")
        assert r2.event.wait(5) and r2.received == [(t1.node_info.node_id, b"reply")]
        with pytest.raises(Exception, match="incompatible|closed|reset|Broken"):
            sw3.dial_peer(host, int(port))  # a wrong network is refused
        assert len(sw1.peers()) == 1
    finally:
        for sw in (sw1, sw2, sw3):
            sw.stop()


def test_node_info_encoding_equals_the_reference():
    kw = dict(node_id="ab" * 20, listen_addr="127.0.0.1:26656", network="chain",
              channels=bytes([0x20, 0x40]), moniker="m")
    enc = P.NodeInfo(**kw).encode()
    assert enc == JP.NodeInfo(**kw).encode()
    assert P.NodeInfo.decode(enc) == P.NodeInfo(**kw)
    nk = P.NodeKey.generate()
    assert nk.node_id() == nk.priv_key.pub_key().address().hex() and len(nk.node_id()) == 40


def test_node_key_file_round_trips_with_the_reference(tmp_path):
    path = str(tmp_path / "node_key.json")
    nk = P.NodeKey.load_or_generate(path)
    assert JP.NodeKey.load_or_generate(path).node_id() == nk.node_id()
    assert P.NodeKey.load_or_generate(path).node_id() == nk.node_id()
    assert os.path.getsize(path) > 0


def test_payload_size_validation():
    from cometbft_tpu_torch.p2p import conn

    assert (conn.MAX_PACKET_PAYLOAD, conn.DEFAULT_SEND_RATE, conn.DEFAULT_RECV_RATE) == (
        1024, 512_000, 512_000)
    assert P.ChannelDescriptor(1).recv_message_capacity == 8 * 1024 * 1024
    with pytest.raises(ValueError, match="positive"):
        P.MConnection(None, [], lambda c, m: None, max_packet_payload_size=0)
    sca, scb, _, _ = sc_pair("port", "port")
    errs, done = [], threading.Event()
    ma = P.MConnection(sca, [P.ChannelDescriptor(0x43)], lambda c, m: None,
                       max_packet_payload_size=512)
    mb = P.MConnection(scb, [P.ChannelDescriptor(0x43, recv_message_capacity=64)],
                       lambda c, m: None, on_error=lambda e: (errs.append(e), done.set()))
    ma.start()
    mb.start()
    try:
        assert ma.send(0x43, b"o" * 400)  # one 400 B packet over a 64 B capacity
        assert done.wait(5) and any("capacity" in str(e) for e in errs)
    finally:
        ma.stop()
        mb.stop()
