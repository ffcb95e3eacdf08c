"""The port's stores against the JAX package's, byte for byte.

One chain is made by the reference (`make_chain`, 5 blocks x 4
validators, a NIL vote at height 3). Its block store crosses to the port
as KV items written with the port's `MemKV.write_batch` and loads there;
the same blocks and commits saved by the port's `BlockStore` give the
same KV items; `prune` and `delete_latest_block` leave both packages'
stores with the same items. `StateStore` writes the same bytes in both
packages. `MemKV` and `SqliteKV` behave as the reference's.
"""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from cometbft_tpu.state import types as RST  # noqa: E402
from cometbft_tpu.storage import BlockStore as RBlockStore  # noqa: E402
from cometbft_tpu.storage import MemKV as RMemKV  # noqa: E402
from cometbft_tpu.storage import StateStore as RStateStore  # noqa: E402
from cometbft_tpu.storage import open_kv as r_open_kv  # noqa: E402
from cometbft_tpu.utils import factories as RF  # noqa: E402
from cometbft_tpu_torch.state.types import State  # noqa: E402
from cometbft_tpu_torch.storage import BlockStore, MemKV, SqliteKV, StateStore, open_kv  # noqa: E402
from cometbft_tpu_torch.types import Block, Commit  # noqa: E402

CHAIN = "storage-chain"
N_BLOCKS = 5


@pytest.fixture(scope="module")
def chain():
    return RF.make_chain(N_BLOCKS, n_validators=4, chain_id=CHAIN, backend="cpu",
                         nil_votes={3: {1}})


def items(kv) -> dict:
    return dict(kv.iterate_prefix(b""))


def carried(ref_store) -> BlockStore:
    """The reference's store as KV items in the port's MemKV."""
    kv = MemKV()
    kv.write_batch(sorted(items(ref_store._db).items()))
    return BlockStore(kv)


def resaved(ref_store):
    """Both packages' stores, each with the reference's blocks and seen
    commits saved through its own BlockStore (the port's decoded in the
    port)."""
    r, p = RBlockStore(RMemKV()), BlockStore(MemKV())
    for h in range(1, N_BLOCKS + 1):
        r.save_block(ref_store.load_block(h), ref_store.load_seen_commit(h))
        raw_b = ref_store._db.get(b"B:" + h.to_bytes(8, "big"))
        raw_c = ref_store._db.get(b"SC:" + h.to_bytes(8, "big"))
        p.save_block(Block.decode(raw_b), Commit.decode(raw_c))
    return r, p


def test_reference_store_loads_in_the_port(chain):
    ref_store = chain[0]
    store = carried(ref_store)
    assert (store.base(), store.height(), store.size()) == (1, N_BLOCKS, N_BLOCKS)
    for h in range(1, N_BLOCKS + 1):
        blk, r_blk = store.load_block(h), ref_store.load_block(h)
        assert blk.encode() == r_blk.encode() and blk.hash() == r_blk.hash()
        assert store.load_seen_commit(h).encode() == ref_store.load_seen_commit(h).encode()
        assert store.load_seen_commit_full(h).encode() == ref_store.load_seen_commit(h).encode()
        commit = store.load_block_commit(h)
        if h < N_BLOCKS:
            assert commit.encode() == ref_store.load_block_commit(h).encode()
            assert commit.hash() == ref_store.load_block(h + 1).header.last_commit_hash
        else:
            assert commit is None and ref_store.load_block_commit(h) is None
        assert store.load_block_by_hash(r_blk.hash()).encode() == r_blk.encode()
        meta, size = store.load_block_meta(h)
        assert (meta.hash(), size) == (r_blk.hash(), ref_store.load_block_meta(h)[1])
    assert store.load_block(N_BLOCKS + 1) is None and store.load_block_by_hash(b"\0" * 32) is None
    assert store.load_extended_commit(1) is None


def test_saving_the_same_blocks_gives_the_same_items(chain):
    r, p = resaved(chain[0])
    assert items(p._db) == items(r._db) == items(chain[0]._db)


def test_non_contiguous_save_raises(chain):
    r, p = resaved(chain[0])
    blk = Block.decode(chain[0]._db.get(b"B:" + (2).to_bytes(8, "big")))
    with pytest.raises(ValueError, match="non-contiguous save: have 5, got 2"):
        p.save_block(blk, Commit())
    with pytest.raises(ValueError, match="non-contiguous save: have 5, got 2"):
        r.save_block(chain[0].load_block(2), chain[0].load_seen_commit(2))


@pytest.mark.parametrize("op", ["prune_3", "prune_6", "prune_1", "delete_latest_2"])
def test_prune_and_delete_latest_block_match_reference(chain, op):
    r, p = resaved(chain[0])
    if op.startswith("prune"):
        h = int(op.split("_")[1])
        assert p.prune(h) == r.prune(h)
    else:
        for _ in range(int(op.split("_")[2])):
            p.delete_latest_block()
            r.delete_latest_block()
    assert items(p._db) == items(r._db)
    assert (p.base(), p.height()) == (r.base(), r.height())
    reopened = BlockStore(p._db)  # base and height persist with the items
    assert (reopened.base(), reopened.height()) == (r.base(), r.height())


def test_empty_store_refuses_delete_and_prune():
    p, r = BlockStore(MemKV()), RBlockStore(RMemKV())
    for s in (p, r):
        with pytest.raises(ValueError, match="block store is empty"):
            s.delete_latest_block()
        with pytest.raises(ValueError, match="cannot prune beyond store height"):
            s.prune(5)
    assert p.prune(0) == r.prune(0) == 0


def test_prune_beyond_height_raises(chain):
    _, p = resaved(chain[0])
    with pytest.raises(ValueError, match="cannot prune beyond store height"):
        p.prune(N_BLOCKS + 2)


def test_seen_commit_bootstrap_matches_reference(chain):
    commit = chain[0].load_seen_commit(4)
    p, r = BlockStore(MemKV()), RBlockStore(RMemKV())
    p.save_seen_commit(4, Commit.decode(commit.encode()))
    r.save_seen_commit(4, commit)
    assert items(p._db) == items(r._db)
    assert (p.base(), p.height()) == (4, 4)


def test_state_store_same_bytes_both_ways(chain):
    _, final, genesis, _ = chain
    for r_state in (genesis, final):
        r_ss, ss = RStateStore(RMemKV()), StateStore(MemKV())
        r_ss.save(r_state)
        state = State.decode(r_state.encode())
        assert state.encode() == r_state.encode()
        ss.save(state)
        assert items(ss._db) == items(r_ss._db)
        loaded = ss.load()
        assert loaded.encode() == r_state.encode()
        assert loaded.validators.get_proposer().address == \
            r_state.validators.get_proposer().address
        nxt = max(r_state.last_block_height + 1, r_state.initial_height)
        assert ss.load_validators(nxt).hash() == r_state.validators.hash()
        assert ss.load_validators(nxt + 1).hash() == r_state.next_validators.hash()
        assert ss.load_validators(nxt + 2) is None
        assert ss.load_consensus_params(nxt) == state.consensus_params
        assert RST.encode_params(r_ss.load_consensus_params(nxt)) == \
            RST.encode_params(r_state.consensus_params)
    for s in (ss, r_ss):
        s.save_finalize_response(3, b"results")
        s.save_abci_responses(3, b"responses")
    assert ss.load_finalize_response(3) == b"results" and ss.load_abci_responses(3) == b"responses"
    assert ss.prune(nxt, nxt) == r_ss.prune(nxt, nxt)
    assert items(ss._db) == items(r_ss._db)


def kv_ops(kv):
    """A fixed sequence of KV operations; returns what each read saw."""
    seen = []
    kv.set(b"a", b"1")
    kv.set(b"a", b"2")
    kv.write_batch([(b"b", b"x"), (b"b\xff", b"y"), (b"b\xff\xff\x00", b"z"), (b"\xff\xff", b"f"),
                    (b"c", b"")], deletes=[b"nope"])
    seen.append([kv.get(k) for k in (b"a", b"b", b"c", b"d")])
    seen.append([kv.has(k) for k in (b"a", b"c", b"d")])
    for prefix in (b"", b"b", b"b\xff", b"\xff", b"\xff\xff", b"z"):
        seen.append(list(kv.iterate_prefix(prefix)))
    kv.delete(b"a")
    kv.write_batch([(b"d", b"4")], deletes=[b"b", b"c"])
    seen.append(list(kv.iterate_prefix(b"")))
    return seen


@pytest.mark.parametrize("backend", ["mem", "sqlite"])
def test_kv_semantics_match_reference(backend, tmp_path):
    path = None if backend == "mem" else str(tmp_path / "port.db")
    r_path = None if backend == "mem" else str(tmp_path / "ref.db")
    kv, r_kv = open_kv(path), r_open_kv(r_path)
    assert isinstance(kv, MemKV if backend == "mem" else SqliteKV)
    assert kv_ops(kv) == kv_ops(r_kv)
    kv.close()
    r_kv.close()
    if backend == "sqlite":  # the items persist in the file
        again = SqliteKV(path)
        assert list(again.iterate_prefix(b"")) == [(b"b\xff", b"y"), (b"b\xff\xff\x00", b"z"),
                                                   (b"d", b"4"), (b"\xff\xff", b"f")]
        again.close()
    assert isinstance(open_kv(":memory:"), MemKV)
