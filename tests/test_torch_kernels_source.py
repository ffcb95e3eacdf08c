"""What the CUDA sources of `cometbft_tpu_torch` promise that the CPU can
check without a compiler: the curve constants written out in the kernels'
radix 2^25.5, the SHA-512 and Barrett constants of `sha512_kernels.cu`,
and the C launch signatures that `ops/kernels.py` binds with ctypes.
"""

import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from cometbft_tpu_torch.crypto import ed25519_ref as ref  # noqa: E402
from cometbft_tpu_torch.ops import kernels as K  # noqa: E402

CSRC = Path(K.CSRC)
ROOT = CSRC.parent.parent


def radix_offset(i: int) -> int:
    """Bit offset of limb i in field25519.cuh (`off`): widths 26, 25, 26, ..."""
    return 25 * i + (i + 1) // 2


@pytest.mark.parametrize("name, value", [
    ("D_C", ref.D),
    ("D2_C", 2 * ref.D % ref.P),
    ("SQRTM1_C", ref.SQRT_M1),
])
def test_radix_constants_match_the_oracle(name, value):
    src = (CSRC / "field25519.cuh").read_text()
    body = re.search(rf"__constant__ uint32_t {name}\[NL\] = \{{([^}}]*)\}}", src).group(1)
    limbs = [int(x, 16) for x in body.split(",")]
    assert len(limbs) == 10
    assert all(0 <= v < (1 << (25 if i & 1 else 26)) for i, v in enumerate(limbs))
    assert sum(v << radix_offset(i) for i, v in enumerate(limbs)) == value


def test_launch_signatures_match_the_bindings():
    for lib, fns in K._SIGNATURES.items():
        src = (CSRC / f"{lib}.cu").read_text()
        for fn, argtypes in fns.items():
            m = re.search(rf'extern "C" int {fn}\(([^)]*)\)', src)
            assert m, f"{fn} not exported by {lib}.cu"
            params = [p.strip() for p in m.group(1).split(",")]
            assert len(params) == len(argtypes), fn
            for p, t in zip(params, argtypes):
                assert ("*" in p) == (t is K._P), (fn, p)
                if t is K._I64:
                    assert p.startswith("int64_t"), (fn, p)


def test_every_exported_launcher_is_bound():
    """Each `.cu` file is a library with bindings, and each `extern "C"`
    function it exports has one (and the other way round)."""
    assert set(K.LIBRARIES) == {p.stem for p in CSRC.glob("*.cu")} == set(K._SIGNATURES)
    for lib in K.LIBRARIES:
        exported = set(re.findall(r'extern "C" int (\w+)\(', (CSRC / f"{lib}.cu").read_text()))
        assert exported == set(K._SIGNATURES[lib]), lib


def test_msm_kernel_constants_match_the_layout():
    """C_BITS, the region layout and the Horner chain's REGION_DBL in
    msm_kernels.cu are those of ops/msm.py, and the launchers' region
    constants too."""
    from cometbft_tpu_torch.ops import msm as M

    src = (CSRC / "msm_kernels.cu").read_text()
    assert int(re.search(r"constexpr int C_BITS = (\d+);", src).group(1)) == M.C_BITS
    assert "NIELS_WORDS = 3 * NLIMBS12" in src
    assert "constexpr int K_BUCKETS = 1 << (C_BITS - 1);" in src
    assert constant(src, "N_REGIONS") == M.N_REGIONS == K.N_REGIONS
    assert M.K_BUCKETS == K.REGION_LANES
    body = re.search(r"__constant__ int REGION_DBL\[N_REGIONS\] = \{([^}]*)\}", src).group(1)
    assert tuple(int(x) for x in body.split(",")) == M.REGION_DBL
    assert set(K.launches) == {"fe_mul", "fe_sq", "decompress", "ladder_sub_mul8",
                               "accum_weight", "region_sum", "window_combine",
                               "sha512_blocks", "reduce512", "sha512_reduce"}


def constant(src: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_launch_shapes_match_the_sources():
    """The launchers in csrc/ use the threads-per-lane and block constants
    their kernels are bounded by; a ladder or `accum_weight` block is whole
    warps of whole four-thread groups, so a group never straddles two warps
    and every shuffle has all 32 threads; and the ragged batches of
    chip_smoke.py and the card tests end in a partial block of each
    kernel."""
    curve = (CSRC / "curve_kernels.cu").read_text()
    lane_threads = constant((CSRC / "edwards25519.cuh").read_text(), "LANE_THREADS")
    ladder = constant(curve, "LADDER_THREADS")
    decompress = constant(curve, "DECOMPRESS_THREADS")
    assert (lane_threads, ladder, decompress) == (4, 64, 32)
    assert ladder % 32 == 0 and 32 % lane_threads == 0
    assert "__launch_bounds__(LADDER_THREADS)" in curve
    assert "blocks_for(batch * LANE_THREADS, LADDER_THREADS), LADDER_THREADS, smem" in curve
    assert "__launch_bounds__(DECOMPRESS_THREADS)" in curve
    assert "blocks_for(batch, DECOMPRESS_THREADS), DECOMPRESS_THREADS, 0" in curve
    field = (CSRC / "field_kernels.cu").read_text()
    assert constant(field, "THREADS") == 64
    assert field.count("<<<blocks_for(batch), THREADS, 0,") == 2
    msm = (CSRC / "msm_kernels.cu").read_text()
    # accum_weight: four threads a lane, whole warps a block
    accum = constant(msm, "ACCUM_THREADS")
    assert accum % 32 == 0
    assert "__launch_bounds__(ACCUM_THREADS, 1)" in msm
    assert ("(lanes * LANE_THREADS + ACCUM_THREADS - 1) / ACCUM_THREADS" in msm
            and "<<<blocks, ACCUM_THREADS, 0," in msm)
    # region_sum: one block per region, one first-level addition per
    # thread; window_combine: one warp, so every shuffle has 32 threads
    assert "constexpr int SUM_THREADS = K_BUCKETS / 2;" in msm
    assert "__launch_bounds__(SUM_THREADS)" in msm
    assert "<<<(unsigned)regions, SUM_THREADS, sizeof(uint32_t) * SUM_SMEM_WORDS," in msm
    assert constant(msm, "COMBINE_THREADS") == 32
    assert "__launch_bounds__(COMBINE_THREADS)" in msm
    assert "<<<1, COMBINE_THREADS, 0," in msm
    smoke = (ROOT / "chip_smoke.py").read_text()
    check = int(re.search(r"^LADDER_CHECK_LANES = ([\d_]+)", smoke, re.M).group(1))
    assert re.search(r"^RAGGED_LANES = \(1, 3, 70, LADDER_CHECK_LANES\)", smoke, re.M)
    # sha512_blocks, sha512_reduce and reduce512: one lane a thread, one
    # warp a block
    sha = (CSRC / "sha512_kernels.cu").read_text()
    sha_threads, reduce_threads = constant(sha, "SHA_THREADS"), constant(sha, "REDUCE_THREADS")
    assert (sha_threads, reduce_threads) == (32, 32)
    assert sha.count("__launch_bounds__(SHA_THREADS)") == 2
    assert "__launch_bounds__(REDUCE_THREADS)" in sha
    assert sha.count("<<<blocks_for(batch, SHA_THREADS), SHA_THREADS, 0,") == 2
    assert "<<<blocks_for(batch, REDUCE_THREADS), REDUCE_THREADS, 0," in sha
    card = (ROOT / "tests" / "test_torch_kernels.py").read_text()
    assert card.count('@pytest.mark.parametrize("n", [1, 3, 70, 1027])') == 6
    for n in (3, 70, check):
        assert n % (ladder // lane_threads) and n % decompress, n
        assert n % (accum // lane_threads), n
        assert n % sha_threads and n % reduce_threads, n


def test_ladder_shared_memory_needs_no_opt_in():
    """The ladder's dynamic shared memory (the converted base table and one
    table column per thread) stays under the 48 KB a launch may take
    without cudaFuncSetAttribute, which the launcher does not call."""
    curve = (CSRC / "curve_kernels.cu").read_text()
    nl = 10
    base_words = 9 * 4 * nl
    tbl_words = 9 * nl
    assert "constexpr int BASE_WORDS = 9 * 4 * NL;" in curve
    assert "constexpr int TBL_WORDS = 9 * NL;" in curve
    assert "sizeof(uint32_t) * (BASE_WORDS + (size_t)TBL_WORDS * LADDER_THREADS)" in curve
    assert 4 * (base_words + tbl_words * constant(curve, "LADDER_THREADS")) <= 48 * 1024
    assert "cudaFuncSetAttribute" not in curve


def test_region_sum_shared_memory_needs_no_opt_in():
    """region_sum keeps one point (4 coordinates of 10 words) per thread in
    dynamic shared memory: 256 threads, 40 KB, under the 48 KB a launch may
    take without cudaFuncSetAttribute."""
    msm = (CSRC / "msm_kernels.cu").read_text()
    assert "constexpr int SUM_SMEM_WORDS = 4 * NL * SUM_THREADS;" in msm
    sum_threads = (1 << (constant(msm, "C_BITS") - 1)) // 2
    assert sum_threads == 256
    assert 4 * (4 * 10 * sum_threads) <= 48 * 1024
    assert "cudaFuncSetAttribute(" not in msm  # the source names it only in a comment


def test_ptxas_usage_reads_registers_and_spills():
    """`kernels.ptxas_usage` (read by chip_smoke.py and the kernel sweep)
    takes each kernel's own lines of an `nvcc -Xptxas -v` log."""
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN2_19accum_weight_kernelEPKi' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN2_19accum_weight_kernelEPKi",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 92 registers, used 0 barriers",
        "ptxas info    : Compiling entry function '_ZN2_17region_sum_kernelEPKi' for 'sm_90a'",
        "    8 bytes stack frame, 12 bytes spill stores, 12 bytes spill loads",
        "ptxas info    : Used 255 registers, used 1 barriers",
    ])
    assert K.ptxas_usage(log, "accum_weight_kernel") == {"spill_bytes": 0, "registers": 92}
    assert K.ptxas_usage(log, "region_sum_kernel") == {"spill_bytes": 12, "registers": 255}
    assert K.ptxas_usage(log, "window_combine_kernel") == {}


def constant_array(src: str, name: str) -> list[int]:
    body = re.search(rf"(?:__constant__|constexpr) uint(?:32|64)_t {name}\[\d+\] = \{{([^}}]*)\}}",
                     src).group(1)
    return [int(x.strip().rstrip("ul"), 16) for x in body.split(",") if x.strip()]


def test_sha512_kernel_constants_match_the_derived_ones():
    """K512 and IV512 of sha512_kernels.cu are the constants the plain
    version derives from exact integer roots; L_W and MU_W (immediates of
    the Barrett step) are L and floor(2^512 / L) in 32-bit words."""
    from cometbft_tpu_torch.ops import scalar as SC
    from cometbft_tpu_torch.ops import sha512 as H

    src = (CSRC / "sha512_kernels.cu").read_text()
    assert constant_array(src, "K512") == H.K64
    assert constant_array(src, "IV512") == H.IV64
    words = lambda x, n: [(x >> (32 * i)) & 0xFFFFFFFF for i in range(n)]  # noqa: E731
    assert constant_array(src, "L_W") == words(SC.L_INT, 8)
    mu = (1 << 512) // SC.L_INT
    assert mu < 1 << 288 and constant_array(src, "MU_W") == words(mu, 9)
    assert constant(src, "NLIMBS12") == 22


def test_fused_challenge_launcher_is_bound():
    """`sha512_reduce_launch` (words, flags, out, batch, stream) is bound,
    and the wrapper that launches it has a launch count."""
    assert K._SIGNATURES["sha512_kernels"]["sha512_reduce_launch"] == [
        K._P, K._P, K._P, K._I64, K._P]
    assert "sha512_reduce" in K.launches
