"""The port's address book and PEX reactor against the JAX package's
(`cometbft_tpu/p2p/{addrbook,pex}.py`): the reference's flows of
tests/test_p2p.py on the port, the same bucket placement and book file
under one key, the same PEX wire bytes, and the same decoder outcome on
a fuzz corpus (tests/test_fuzz_wire.py)."""

import json
import random
import time

import pytest

pytest.importorskip("torch")

from cometbft_tpu.p2p import addrbook as RA  # noqa: E402
from cometbft_tpu.p2p import pex as RP  # noqa: E402
from cometbft_tpu_torch.encoding import proto as pb  # noqa: E402
from cometbft_tpu_torch.p2p import NodeInfo, NodeKey, Switch, Transport  # noqa: E402
from cometbft_tpu_torch.p2p import pex as P  # noqa: E402
from cometbft_tpu_torch.p2p.addrbook import BUCKET_SIZE, AddrBook, NetAddress  # noqa: E402

KEY = bytes(range(24))
DEADLINE_S = 30.0


@pytest.fixture(autouse=True)
def quiet_logs():
    from cometbft_tpu_torch.utils import log as L

    sink = L._config.sink
    L.set_sink(lambda level, msg, fields: None)
    yield
    L.set_sink(sink)


def norm(x):
    """A package-free form of a decoded value: class name and fields."""
    if isinstance(x, (list, tuple)):
        return [norm(v) for v in x]
    if isinstance(x, (bytes, str, int, float, bool)) or x is None:
        return x
    fields = getattr(x, "__dataclass_fields__", None) or getattr(x, "__slots__", None) \
        or sorted(vars(x))
    return (type(x).__name__, [(f, norm(getattr(x, f))) for f in fields])


def outcome(decode, raw):
    try:
        return ("ok", norm(decode(raw)))
    except Exception as e:  # noqa: BLE001 — the class is the outcome
        return ("raise", type(e).__name__)


def mutations(rng, data: bytes, n: int):
    """tests/test_fuzz_wire.py's corpus: the seed, empty, truncations, bit
    flips, garbage and splices."""
    yield b""
    yield data
    for _ in range(n):
        kind = rng.randrange(4)
        if kind == 0 and data:
            yield data[: rng.randrange(len(data))]
        elif kind == 1 and data:
            i = rng.randrange(len(data))
            yield data[:i] + bytes([data[i] ^ (1 << rng.randrange(8))]) + data[i + 1:]
        elif kind == 2:
            yield rng.randbytes(rng.randrange(1, 64))
        else:
            i = rng.randrange(len(data) + 1)
            yield data[i:] + data[:i]


def same_decoding(port_decode, ref_decode, seeds, n: int = 300, seed: int = 1234):
    rng = random.Random(seed)
    runs = 0
    for valid in seeds:
        for mut in mutations(rng, valid, n):
            assert outcome(port_decode, mut) == outcome(ref_decode, mut), mut
            runs += 1
    return runs


def _make(tmp_path, name, **kw):
    nk = NodeKey.generate()
    tr = Transport(nk, NodeInfo(node_id=nk.node_id(), network="pex-chain", moniker=name))
    sw = Switch(tr)
    book = AddrBook(str(tmp_path / f"{name}.json"))
    pex = P.PexReactor(book, target_outbound=4, **kw)
    pex.set_switch(sw)
    sw.add_reactor(pex)
    tr.listen()
    sw.start()
    return sw, tr, book, pex


def _wait(cond, timeout_s=DEADLINE_S):
    deadline = time.monotonic() + timeout_s
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.02)
    return cond()


# ---- the address book

def test_addrbook_groups_and_persistence(tmp_path):
    path = str(tmp_path / "addrbook.json")
    book = AddrBook(path)
    a1 = NetAddress("id1", "10.0.0.1", 26656)
    a2 = NetAddress("id2", "10.0.0.2", 26656)
    assert book.add_address(a1, "src") and book.add_address(a2, "src")
    assert not book.add_address(a1, "src")
    assert not book.add_address(NetAddress("", "x", 1))
    book.mark_good("id1")
    assert book.size() == 2
    book.mark_bad("id2")
    assert book.size() == 1
    assert not book.add_address(a2, "src")
    book.save()
    book2 = AddrBook(path)
    assert book2.has("id1") and not book2.has("id2")
    assert book2.pick_address().node_id == "id1"


@pytest.mark.parametrize("host, group", [
    ("10.1.2.3", "private"), ("127.0.0.1", "local"), ("8.8.4.4", "8.8"),
    ("2001:4860::8888", "2001:4860::/32"), ("seed.example.com", "seed.example.com"),
    ("", "unroutable"),
])
def test_group_key_and_routable_match_the_reference(host, group):
    a, r = NetAddress("n", host, 1), RA.NetAddress("n", host, 1)
    assert a.group_key() == r.group_key() == group
    assert a.routable() == r.routable()
    assert a.encode() == r.encode()


def _same_ops(book, na):
    """One script of adds, promotions, attempts and bans (no randomness)."""
    for i in range(150):
        book.add_address(na(f"n{i}", f"{20 + i % 7}.{i % 5}.0.{i}", 1000 + i), source=f"s{i % 4}")
    for i in range(0, 150, 3):
        book.mark_good(f"n{i}")
    for i in range(1, 60, 7):
        book.mark_attempt(f"n{i}")
    for i in (5, 50, 95):
        book.mark_bad(f"n{i}")
    return book


def test_bucket_placement_and_book_file_match_the_reference(tmp_path):
    """One key, the same script: every entry in the same bucket of the same
    group, and each package's file loads in the other with the same
    placement."""
    port = _same_ops(AddrBook(str(tmp_path / "port.json"), key=KEY), NetAddress)
    ref = _same_ops(RA.AddrBook(str(tmp_path / "ref.json"), key=KEY), RA.NetAddress)
    assert port.counts() == ref.counts()
    placed = {nid: (ka.is_old, ka.bucket, ka.attempts) for nid, ka in port._addrs.items()}
    assert placed == {nid: (ka.is_old, ka.bucket, ka.attempts) for nid, ka in ref._addrs.items()}
    port.save()
    ref.save()

    def doc(path):
        d = json.load(open(path))
        for e in d["addrs"]:
            e.pop("last_attempt"), e.pop("last_success")
        return d["key"], d["addrs"], sorted(d["banned"])

    assert doc(tmp_path / "port.json") == doc(tmp_path / "ref.json")
    cross = RA.AddrBook(str(tmp_path / "port.json"))
    back = AddrBook(str(tmp_path / "ref.json"))
    assert {n: (k.is_old, k.bucket) for n, k in cross._addrs.items()} == \
        {n: (k.is_old, k.bucket) for n, k in back._addrs.items()}


def test_addrbook_restart_roundtrip(tmp_path):
    path = str(tmp_path / "book.json")
    book = AddrBook(path)
    for i in range(12):
        assert book.add_address(NetAddress(f"id{i}", f"10.{i}.0.1", 26656), source=f"src{i % 3}")
    for i in range(4):
        book.mark_good(f"id{i}")
    for i in range(4, 9):
        book.mark_attempt(f"id{i}")
    book.mark_bad("id11")
    book.save()
    for _restart in range(2):
        book = AddrBook(path)
        book.save()
    assert book.counts() == (7, 4)
    for i in range(12):
        ka, orig_old = book.known(f"id{i}"), i < 4
        if i == 11:
            assert ka is None
            assert not book.add_address(NetAddress("id11", "10.11.0.1", 26656))
            continue
        assert ka is not None and ka.is_old == orig_old
        assert ka.attempts == (1 if 4 <= i < 9 else 0)
    fresh = AddrBook(path)
    for nid, ka in fresh._addrs.items():
        assert book.known(nid).bucket == ka.bucket


def test_addrbook_promotion_eviction_and_demotion():
    book = AddrBook()
    for i in range(BUCKET_SIZE):
        assert book.add_address(NetAddress(f"n{i}", f"10.1.{i // 256}.{i % 256}", 1000 + i),
                                source="gossiper")
    for i in range(3):
        for _ in range(3):
            book.mark_attempt(f"n{i}")
    assert book.add_address(NetAddress("overflow0", "10.1.200.200", 2000), source="gossiper")
    assert book.size() == BUCKET_SIZE and not book.has("n0")
    book.mark_good("n10")
    assert book.counts() == (BUCKET_SIZE - 1, 1) and book.known("n10").is_old
    book2 = AddrBook()
    total = 280
    for i in range(total):
        assert book2.add_address(NetAddress(f"v{i}", f"44.44.{i // 256}.{i % 256}", 3000 + i),
                                 source=f"s{i % 7}")
        book2.mark_good(f"v{i}")
    new_n, old_n = book2.counts()
    assert old_n <= 4 * BUCKET_SIZE and new_n + old_n == total
    assert new_n >= total - 4 * BUCKET_SIZE


def test_addrbook_biased_selection_distribution():
    book = AddrBook()
    old_ids = set()
    for i in range(10):
        book.add_address(NetAddress(f"old{i}", f"20.{i}.0.1", 26656), source="a")
        book.mark_good(f"old{i}")
        old_ids.add(f"old{i}")
    for i in range(30):
        book.add_address(NetAddress(f"new{i}", f"30.{i}.0.1", 26656), source="b")
    random.seed(7)
    hits_old = sum(1 for _ in range(600) if book.pick_address().node_id in old_ids)
    assert 0.55 < hits_old / 600 < 0.85
    assert all(book.pick_address(bias_old_pct=100).node_id in old_ids for _ in range(50))
    assert all(book.pick_address(bias_old_pct=0).node_id not in old_ids for _ in range(50))


def test_backoff_grows_with_failed_attempts():
    book = AddrBook()
    book.add_address(NetAddress("n", "10.0.0.1", 1))
    assert book.backoff_remaining("n") == 0.0
    book.mark_attempt("n")
    first = book.backoff_remaining("n")
    book.mark_attempt("n")
    book.mark_attempt("n")
    assert 0 < first <= 0.5 < book.backoff_remaining("n") <= 2.0
    book.mark_good("n")
    assert book.backoff_remaining("n") == 0.0


# ---- the PEX wire

def test_pex_wire_roundtrip_and_bytes():
    assert P.encode_pex_request() == RP.encode_pex_request()
    assert P.decode_pex_message(P.encode_pex_request()) == ("request", None)
    addrs = [NetAddress("n1", "1.2.3.4", 1000), NetAddress("n2", "::1", 2)]
    raw = P.encode_pex_addrs(addrs)
    assert raw == RP.encode_pex_addrs([RA.NetAddress(a.node_id, a.host, a.port) for a in addrs])
    assert P.decode_pex_message(raw) == ("addrs", addrs)


def test_pex_decoder_matches_the_reference_on_the_fuzz_corpus():
    seeds = [
        P.encode_pex_request(),
        P.encode_pex_addrs([NetAddress("aa" * 20, "127.0.0.1", 26656)]),
        P.encode_pex_addrs([]),
        P.encode_pex_addrs([NetAddress("", "", 0)]),
        P.encode_pex_addrs([NetAddress("bb" * 20, "::1", 1),
                            NetAddress("cc" * 20, "2001:db8::42", 65535),
                            NetAddress("dd" * 20, "seed.example.com", 26656)]),
        P.encode_pex_addrs([NetAddress(f"{i:040x}", f"10.0.{i // 256}.{i % 256}", 26656)
                            for i in range(100)]),
    ]
    assert same_decoding(P.decode_pex_message, RP.decode_pex_message, seeds) > 300


def test_pex_decoder_nested_garbage_matches_the_reference():
    cases = [
        pb.f_embedded(2, pb.f_embedded(1, b"\xff" * 40)),
        pb.f_embedded(2, pb.f_embedded(1, pb.f_embedded(1, pb.f_embedded(1, b"\x08\x01")))),
        pb.f_embedded(2, pb.f_varint(1, 7)),
        pb.f_varint(1, 1 << 62),
        pb.f_embedded(2, pb.f_embedded(1, pb.f_string(1, "id") + pb.f_varint(3, 1 << 63))),
        pb.f_embedded(1, b"") + pb.f_embedded(2, b""),
        b"\xff" * 10,
    ]
    for raw in cases:
        got = outcome(P.decode_pex_message, raw)
        assert got == outcome(RP.decode_pex_message, raw)
        if got[0] == "ok":
            kind, addrs = got[1]
            assert kind in (None, "request", "addrs")


# ---- PEX over TCP

def test_pex_gossip_and_dial(tmp_path):
    """C knows only B, B knows A: after PEX gossip and ensure_peers, C
    dials A (tests/test_p2p.py's flow on the port)."""
    sw_a, t_a, _, _ = _make(tmp_path, "a")
    sw_b, t_b, book_b, _ = _make(tmp_path, "b")
    sw_c, t_c, book_c, pex_c = _make(tmp_path, "c")
    try:
        host_a, port_a = t_a.node_info.listen_addr.split(":")
        host_b, port_b = t_b.node_info.listen_addr.split(":")
        sw_b.dial_peer(host_a, int(port_a))
        book_b.add_address(NetAddress(t_a.node_info.node_id, host_a, int(port_a)), "manual")
        peer_b = sw_c.dial_peer(host_b, int(port_b))
        last_ask = time.monotonic()
        deadline = time.monotonic() + DEADLINE_S
        while not book_c.has(t_a.node_info.node_id) and time.monotonic() < deadline:
            if time.monotonic() - last_ask > 2.0:
                peer_b.send(P.PEX_CHANNEL, P.encode_pex_request())
                last_ask = time.monotonic()
            time.sleep(0.05)
        assert book_c.has(t_a.node_info.node_id)
        deadline = time.monotonic() + DEADLINE_S
        while len(sw_c.peers()) < 2 and time.monotonic() < deadline:
            pex_c.ensure_peers()
            time.sleep(0.25)
        assert any(p.id == t_a.node_info.node_id for p in sw_c.peers())
        assert book_c.known(t_a.node_info.node_id).is_old  # dialed out: promoted
    finally:
        sw_a.stop(); sw_b.stop(); sw_c.stop()


def test_unsolicited_addrs_disconnect_the_peer(tmp_path):
    """An addrs message nobody asked for stops the peer (reference)."""
    sw_a, t_a, _, pex_a = _make(tmp_path, "a")
    sw_b, t_b, _, _ = _make(tmp_path, "b")
    try:
        host, port = t_a.node_info.listen_addr.split(":")
        peer = sw_b.dial_peer(host, int(port))
        assert _wait(lambda: t_b.node_info.node_id in {p.id for p in sw_a.peers()})
        # A asked B on add_peer; B's answer clears it, a second one is unsolicited
        assert _wait(lambda: t_b.node_info.node_id not in pex_a._requested)
        peer.send(P.PEX_CHANNEL, P.encode_pex_addrs([NetAddress("x" * 40, "10.0.0.9", 5)]))
        assert _wait(lambda: not sw_a.peers())
    finally:
        sw_a.stop(); sw_b.stop()


def test_pex_seed_crawler_serves_and_hangs_up(tmp_path):
    sw_s, t_s, book_s, pex_s = _make(tmp_path, "seed", seed_mode=True, seed_disconnect_s=0.3)
    sw_a, t_a, _, _ = _make(tmp_path, "a")
    sw_b, t_b, book_b, _ = _make(tmp_path, "b")
    try:
        host_s, port_s = t_s.node_info.listen_addr.split(":")
        sw_a.dial_peer(host_s, int(port_s))
        assert _wait(lambda: book_s.has(t_a.node_info.node_id), 10)
        time.sleep(0.4)
        pex_s.sweep_hangups()
        assert _wait(lambda: not sw_s.peers(), 5), "seed kept a full peer"
        sw_b.dial_peer(host_s, int(port_s))
        assert _wait(lambda: book_b.has(t_a.node_info.node_id), 10), "B never learned A"
        pex_s.crawl()
        time.sleep(0.4)
        pex_s.sweep_hangups()
        assert _wait(lambda: not sw_s.peers(), 5), "crawl connections were not hung up"
    finally:
        sw_s.stop(); sw_a.stop(); sw_b.stop()


def test_port_and_reference_pex_exchange_addresses(tmp_path):
    """A reference node and a port node over TCP: each learns the other's
    listen address and the addresses the other's book holds."""
    from cometbft_tpu.p2p import NodeInfo as RNodeInfo, NodeKey as RNodeKey
    from cometbft_tpu.p2p import Switch as RSwitch, Transport as RTransport

    nk = RNodeKey.generate()
    rt = RTransport(nk, RNodeInfo(node_id=nk.node_id(), network="pex-chain", moniker="ref"))
    rsw = RSwitch(rt)
    rbook = RA.AddrBook(None, self_id=nk.node_id())
    rbook.add_address(RA.NetAddress("r" * 40, "10.9.9.9", 26656), "manual")
    rpex = RP.PexReactor(rbook)
    rpex.set_switch(rsw)
    rsw.add_reactor(rpex)
    rt.listen()
    rsw.start()
    sw, t, book, _ = _make(tmp_path, "port")
    try:
        host, port = rt.node_info.listen_addr.split(":")
        sw.dial_peer(host, int(port))
        assert _wait(lambda: book.has("r" * 40) and book.has(nk.node_id()))
        assert _wait(lambda: rbook.has(t.node_info.node_id))
        assert book.known(nk.node_id()).is_old
    finally:
        sw.stop(); rsw.stop()
