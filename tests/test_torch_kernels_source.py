"""What the CUDA sources of `cometbft_tpu_torch` promise that the CPU can
check without a compiler: the curve constants written out in the kernels'
radix 2^25.5, and the C launch signatures that `ops/kernels.py` binds with
ctypes.
"""

import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from cometbft_tpu_torch.crypto import ed25519_ref as ref  # noqa: E402
from cometbft_tpu_torch.ops import kernels as K  # noqa: E402

CSRC = Path(K.CSRC)


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
    from cometbft_tpu_torch.ops import msm as M

    src = (CSRC / "msm_kernels.cu").read_text()
    assert int(re.search(r"constexpr int C_BITS = (\d+);", src).group(1)) == M.C_BITS
    assert "NIELS_WORDS = 3 * NLIMBS12" in src
    assert set(K.launches) == {"fe_mul", "fe_sq", "decompress", "ladder_sub_mul8",
                               "accum_weight"}
