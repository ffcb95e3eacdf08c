"""The port stands alone and never falls back.

- Importing every module of `cometbft_tpu_torch`, and `chip_smoke`, loads
  neither JAX nor `cometbft_tpu`, nor the `cryptography` package (the p2p
  layer's ciphers are the port's own).
- A kernel wrapper handed a CUDA request with no kernel library raises; it
  does not run the plain version instead. A CPU tensor never reaches a
  kernel launcher.
"""

import subprocess
import sys
import textwrap
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from cometbft_tpu_torch.ops import field as F  # noqa: E402
from cometbft_tpu_torch.ops import kernels as K  # noqa: E402
from cometbft_tpu_torch.ops import msm as M  # noqa: E402
from cometbft_tpu_torch.ops import scalar as SC  # noqa: E402
from cometbft_tpu_torch.ops import sha512 as H  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def test_port_and_chip_smoke_import_no_jax_and_no_reference():
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        sys.path.insert(0, {str(ROOT)!r})
        import cometbft_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(cometbft_tpu_torch.__path__,
                                                        "cometbft_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        bad = sorted(n for n in sys.modules
                     if n.split(".")[0] in ("jax", "jaxlib", "cometbft_tpu", "cryptography"))
        missing = set(["cometbft_tpu_torch.crypto.native", "cometbft_tpu_torch.utils.trace",
                       "cometbft_tpu_torch.utils.metrics", "cometbft_tpu_torch.ops.sha512",
                       "cometbft_tpu_torch.graft_entry", "cometbft_tpu_torch.encoding.proto",
                       "cometbft_tpu_torch.types.basic", "cometbft_tpu_torch.types.vote",
                       "cometbft_tpu_torch.types.block", "cometbft_tpu_torch.types.validator_set",
                       "cometbft_tpu_torch.types.validation", "cometbft_tpu_torch.light.types",
                       "cometbft_tpu_torch.light.verifier", "cometbft_tpu_torch.utils.factories",
                       "cometbft_tpu_torch.crypto.sched", "cometbft_tpu_torch.crypto.merkle",
                       "cometbft_tpu_torch.crypto.batch", "cometbft_tpu_torch.utils.fail",
                       "cometbft_tpu_torch.utils.txlife", "cometbft_tpu_torch.types.evidence",
                       "cometbft_tpu_torch.types.extended_commit", "cometbft_tpu_torch.abci.types",
                       "cometbft_tpu_torch.abci.wire", "cometbft_tpu_torch.abci.client",
                       "cometbft_tpu_torch.abci.kvstore", "cometbft_tpu_torch.state.types",
                       "cometbft_tpu_torch.state.execution", "cometbft_tpu_torch.storage.kv",
                       "cometbft_tpu_torch.storage.blockstore",
                       "cometbft_tpu_torch.storage.statestore",
                       "cometbft_tpu_torch.blocksync.replay",
                       "cometbft_tpu_torch.mempool.txcolumns",
                       "cometbft_tpu_torch.mempool.mempool",
                       "cometbft_tpu_torch.mempool.admission",
                       "cometbft_tpu_torch.evidence.pool", "cometbft_tpu_torch.light.mmr",
                       "cometbft_tpu_torch.light.store",
                       "cometbft_tpu_torch.light.client", "cometbft_tpu_torch.utils.bits",
                       "cometbft_tpu_torch.utils.log", "cometbft_tpu_torch.types.proposal",
                       "cometbft_tpu_torch.types.vote_set", "cometbft_tpu_torch.privval",
                       "cometbft_tpu_torch.privval.file_pv", "cometbft_tpu_torch.consensus",
                       "cometbft_tpu_torch.consensus.ticker", "cometbft_tpu_torch.consensus.wal",
                       "cometbft_tpu_torch.consensus.height_vote_set",
                       "cometbft_tpu_torch.consensus.state",
                       "cometbft_tpu_torch.consensus.net", "cometbft_tpu_torch.parallel",
                       "cometbft_tpu_torch.parallel.mesh", "cometbft_tpu_torch.crypto.x25519",
                       "cometbft_tpu_torch.crypto.symmetric", "cometbft_tpu_torch.p2p",
                       "cometbft_tpu_torch.p2p.key", "cometbft_tpu_torch.p2p.secret_connection",
                       "cometbft_tpu_torch.p2p.conn", "cometbft_tpu_torch.p2p.transport",
                       "cometbft_tpu_torch.p2p.switch", "cometbft_tpu_torch.blocksync.pool",
                       "cometbft_tpu_torch.blocksync.reactor",
                       "cometbft_tpu_torch.p2p.addrbook", "cometbft_tpu_torch.p2p.pex",
                       "cometbft_tpu_torch.mempool.reactor",
                       "cometbft_tpu_torch.evidence.reactor",
                       "cometbft_tpu_torch.consensus.reactor", "cometbft_tpu_torch.statesync",
                       "cometbft_tpu_torch.statesync.messages",
                       "cometbft_tpu_torch.statesync.snapshots",
                       "cometbft_tpu_torch.statesync.chunks",
                       "cometbft_tpu_torch.statesync.provider",
                       "cometbft_tpu_torch.statesync.syncer",
                       "cometbft_tpu_torch.statesync.reactor",
                       "cometbft_tpu_torch.state.pruner",
                       "cometbft_tpu_torch.state.rollback", "cometbft_tpu_torch.utils.pubsub",
                       "cometbft_tpu_torch.types.event_bus", "cometbft_tpu_torch.types.genesis",
                       "cometbft_tpu_torch.storage.indexer",
                       "cometbft_tpu_torch.state.handshake", "cometbft_tpu_torch.abci.socket",
                       "cometbft_tpu_torch.config", "cometbft_tpu_torch.rpc",
                       "cometbft_tpu_torch.rpc.routes", "cometbft_tpu_torch.rpc.server",
                       "cometbft_tpu_torch.rpc.client", "cometbft_tpu_torch.rpc.codec",
                       "cometbft_tpu_torch.light.provider_http", "cometbft_tpu_torch.node",
                       "cometbft_tpu_torch.node.node", "cometbft_tpu_torch.cli"]) - set(names)
        bad += sorted(n for n in sys.modules if n.split(".")[0] in ("grpc",))
        print(len(names), bad, missing)
        sys.exit(1 if bad or missing or len(names) < 50 else 0)
    """)
    # -I: no PYTHON* variables and no user site, so nothing preloads JAX
    res = subprocess.run([sys.executable, "-I", "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def fake_cuda_tensor(shape, dtype=torch.int32):
    """Stands in for a CUDA tensor (int32 unless told) on a host whose
    torch has no CUDA: it passes the wrappers' device, dtype, shape and
    layout checks."""
    t = types.SimpleNamespace(
        device=torch.device("cuda"), dtype=dtype, shape=torch.Size(shape),
        is_contiguous=lambda: True, data_ptr=lambda: 0,
    )
    t.contiguous = lambda: t
    t.to = lambda *args, **kwargs: (
        fake_cuda_tensor(shape, kwargs["dtype"]) if "dtype" in kwargs else t)
    t.reshape = lambda *new_shape: fake_cuda_tensor((t.shape.numel(),))  # reshape(-1) only
    return t


@pytest.fixture
def no_nvcc(monkeypatch, tmp_path):
    """No kernel library loaded, no nvcc on PATH or under CUDA_HOME, and an
    empty build directory."""
    monkeypatch.setattr(K, "_libs", {})
    monkeypatch.setattr(K, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path / "bin"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    return tmp_path


def test_build_without_nvcc_raises(no_nvcc):
    with pytest.raises(RuntimeError, match="nvcc not found"):
        K.build()


def test_failed_build_raises(no_nvcc):
    nvcc = no_nvcc / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text("#!/bin/sh\necho 'error: no compiler here' >&2\nexit 2\n")
    nvcc.chmod(0o755)
    with pytest.raises(RuntimeError, match="CUDA kernel build failed"):
        K.build()
    assert not list((no_nvcc / "build").rglob("*.so"))


def test_cuda_requests_without_a_library_raise(no_nvcc):
    a = fake_cuda_tensor((F.NLIMBS, 8))
    before = dict(K.launches)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        K.fe_mul(a, a)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        F.mul(a, a)  # the dispatching wrapper: no plain fallback either
    with pytest.raises(RuntimeError, match="nvcc not found"):
        F.sq(a)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        K.decompress(a, fake_cuda_tensor((1, 8)))
    digits = fake_cuda_tensor((64, 8))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        K.ladder_sub_mul8(fake_cuda_tensor((4, F.NLIMBS, 8)), fake_cuda_tensor((4, F.NLIMBS, 8)),
                          digits, digits, fake_cuda_tensor((9, 3, F.NLIMBS)))
    niels = tuple(fake_cuda_tensor((F.NLIMBS, 129)) for _ in range(3))
    table = fake_cuda_tensor((8, M.WK))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        K.accum_weight(niels, table, table, fake_cuda_tensor((M.WK,)))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        # the dispatching wrapper: no plain fallback either
        M.accumulate_weighted(niels, table, table, fake_cuda_tensor((M.N_REGIONS, M.K_BUCKETS)))
    weighted = fake_cuda_tensor((4, F.NLIMBS, M.WK))
    sums = fake_cuda_tensor((4, F.NLIMBS, M.N_REGIONS))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        K.region_sum(weighted)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        M.region_tree_sum(weighted)  # the dispatching wrapper: no plain fallback either
    with pytest.raises(RuntimeError, match="nvcc not found"):
        K.window_combine(sums)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        M.window_combine(sums)
    words = fake_cuda_tensor((8, 64))
    two = fake_cuda_tensor((8,), torch.bool)
    digest = fake_cuda_tensor((8, 64), torch.uint8)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        K.sha512_blocks(words, two)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        H.sha512_digest(words, two)  # the dispatching wrapper: no plain fallback either
    with pytest.raises(RuntimeError, match="nvcc not found"):
        K.reduce512(digest)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        SC.reduce512(digest)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        K.sha512_reduce(words, two)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        SC.sha512_reduce(words, two)  # the dispatching wrapper: no plain fallback either
    assert K.launches == before


def test_launchers_refuse_cpu_tensors():
    a = torch.zeros((F.NLIMBS, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.fe_mul(a, a)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.fe_sq(a)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.decompress(a, torch.zeros((1, 4), dtype=torch.int32))
    idx = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.accum_weight((a, a, a), idx, idx, torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.region_sum(torch.zeros((4, F.NLIMBS, 2 * M.K_BUCKETS), dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.window_combine(torch.zeros((4, F.NLIMBS, M.N_REGIONS), dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.sha512_blocks(torch.zeros((4, 64), dtype=torch.int32), torch.zeros(4, dtype=torch.bool))
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.reduce512(torch.zeros((4, 64), dtype=torch.uint8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.sha512_reduce(torch.zeros((4, 64), dtype=torch.int32), torch.zeros(4, dtype=torch.bool))


def test_launchers_check_dtype_and_shape():
    a = fake_cuda_tensor((F.NLIMBS, 8))
    wrong = types.SimpleNamespace(**{**vars(a), "dtype": torch.int64})
    with pytest.raises(ValueError, match="int32"):
        K.fe_mul(a, wrong)
    with pytest.raises(ValueError, match="shape"):
        K.fe_mul(a, fake_cuda_tensor((F.NLIMBS, 9)))
    with pytest.raises(ValueError, match="shape"):
        K.decompress(a, fake_cuda_tensor((8,)))
    niels = (a, a, fake_cuda_tensor((F.NLIMBS, 9)))
    idx = fake_cuda_tensor((3, 16))
    with pytest.raises(ValueError, match="shape"):
        K.accum_weight(niels, idx, idx, fake_cuda_tensor((16,)))
    with pytest.raises(ValueError, match="shape"):
        K.accum_weight((a, a, a), idx, fake_cuda_tensor((3, 15)), fake_cuda_tensor((16,)))
    with pytest.raises(ValueError, match="int32"):
        K.accum_weight((a, a, a), idx, idx, types.SimpleNamespace(
            **{**vars(fake_cuda_tensor((16,))), "dtype": torch.int64}))
    with pytest.raises(ValueError, match="whole number of regions"):
        K.region_sum(fake_cuda_tensor((4, F.NLIMBS, M.K_BUCKETS + 1)))
    with pytest.raises(ValueError, match="shape"):
        K.region_sum(fake_cuda_tensor((3, F.NLIMBS, M.K_BUCKETS)))
    with pytest.raises(ValueError, match="shape"):
        K.window_combine(fake_cuda_tensor((4, F.NLIMBS, M.N_REGIONS - 1)))
    words, two = fake_cuda_tensor((8, 64)), fake_cuda_tensor((8,), torch.bool)
    with pytest.raises(ValueError, match="expected bool"):
        K.sha512_blocks(words, fake_cuda_tensor((8,)))
    with pytest.raises(ValueError, match="shape"):
        K.sha512_blocks(fake_cuda_tensor((8, 63)), two)
    with pytest.raises(ValueError, match="shape"):
        K.sha512_blocks(words, fake_cuda_tensor((7,), torch.bool))
    with pytest.raises(ValueError, match="16-byte aligned"):
        K.sha512_blocks(types.SimpleNamespace(**{**vars(words), "data_ptr": lambda: 4}), two)
    with pytest.raises(ValueError, match="expected bool"):
        K.sha512_reduce(words, fake_cuda_tensor((8,)))
    with pytest.raises(ValueError, match="16-byte aligned"):
        K.sha512_reduce(types.SimpleNamespace(**{**vars(words), "data_ptr": lambda: 4}), two)
    with pytest.raises(ValueError, match="expected uint8"):
        K.reduce512(fake_cuda_tensor((8, 64)))
    with pytest.raises(ValueError, match="16-byte aligned"):
        K.reduce512(types.SimpleNamespace(**{**vars(fake_cuda_tensor((8, 64), torch.uint8)),
                                             "data_ptr": lambda: 8}))


def test_build_dir_is_keyed_by_the_sources():
    d = K.build_dir()
    assert d.parent == K.BUILD_ROOT and len(d.name) == 16
    assert K.build_dir() == d
    assert {p.name for p in K._sources()} >= {
        "field25519.cuh", "edwards25519.cuh", "field_kernels.cu", "curve_kernels.cu",
        "msm_kernels.cu", "sha512_kernels.cu"}



def test_span_names_are_registered_both_ways():
    """Every span name the port emits is in its SPAN_REGISTRY, every
    registered name is emitted somewhere, and each is a name the reference
    registers, with the same description."""
    import re

    from cometbft_tpu.utils import trace as ref_trace
    from cometbft_tpu_torch.utils import trace

    src = "".join(p.read_text() for p in (ROOT / "cometbft_tpu_torch").rglob("*.py"))
    emitted = set(re.findall(r"trace\.emit\(\s*\"([a-z0-9_.]+)\"", src))
    assert emitted == set(trace.SPAN_REGISTRY)
    assert {k: ref_trace.SPAN_REGISTRY[k] for k in trace.SPAN_REGISTRY} == trace.SPAN_REGISTRY
