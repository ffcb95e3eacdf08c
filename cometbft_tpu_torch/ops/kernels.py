"""Build, load and launch the hand-written CUDA kernels.

Each `csrc/*.cu` file is compiled on first use by its own `nvcc` process
(all started together) into a shared library with a plain C interface,
then loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o <name>.so csrc/<name>.cu

The libraries go to `build/cometbft_tpu_torch/<hash>/` beside the
package, where <hash> covers every source and the flags, so an edited
source rebuilds and an unchanged one loads at once. `ptxas -v` output
(registers, spills, shared memory per kernel) is kept beside each library
as `<name>.ptxas.txt` (`ptxas_report()`).

Each launcher checks device, dtype, shape and contiguity, allocates its
outputs with `torch.empty`, launches on `torch.cuda.current_stream()`,
raises if the C function returns a non-zero `cudaGetLastError()`, and
adds one to its entry in `launches`. A missing `nvcc` or a failed build
raises; nothing falls back to the plain versions. Those errors are
`KernelError`s; `is_device_error` tells them, and torch's CUDA errors,
from an error of the data (the consensus state machine drops a peer's
bad message but halts on a device error).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

NLIMBS = 22

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent.parent / "build" / "cometbft_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
LIBRARIES = ("field_kernels", "curve_kernels", "msm_kernels", "sha512_kernels")

# The RLC layout's regions (ops/msm.py K_BUCKETS, N_REGIONS), which
# csrc/msm_kernels.cu has as constants.
REGION_LANES = 512
N_REGIONS = 39

# One plain integer per kernel, incremented where the kernel is launched.
launches = {"fe_mul": 0, "fe_sq": 0, "decompress": 0, "ladder_sub_mul8": 0,
            "accum_weight": 0, "region_sum": 0, "window_combine": 0, "sha512_blocks": 0,
            "reduce512": 0, "sha512_reduce": 0}

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_SIGNATURES = {
    "field_kernels": {
        "fe_mul_launch": [_P, _P, _P, _I64, _P],
        "fe_sq_launch": [_P, _P, _I64, _P],
    },
    "curve_kernels": {
        "decompress_launch": [_P, _P, _P, _P, _P, _I64, _P],
        "ladder_sub_mul8_launch": [_P, _P, _P, _P, _P, _P, _I64, _P],
    },
    "msm_kernels": {
        "accum_weight_launch": [_P, _P, _P, _P, _P, _I64, _I64, _I64, _P],
        "region_sum_launch": [_P, _P, _I64, _P],
        "window_combine_launch": [_P, _P, _I64, _P],
    },
    "sha512_kernels": {
        "sha512_blocks_launch": [_P, _P, _P, _I64, _P],
        "reduce512_launch": [_P, _P, _I64, _P],
        "sha512_reduce_launch": [_P, _P, _P, _I64, _P],
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


class KernelError(RuntimeError):
    """A kernel library that could not be built or loaded, or a launch that
    failed."""


def is_device_error(e: BaseException) -> bool:
    """Whether `e`, or an error it was raised from, is a fault of the device
    layer: a KernelError, torch's CUDA errors (out of memory, an
    accelerator error, a RuntimeError naming CUDA), or a "cuda" device
    requested on a host without one."""
    accel = getattr(torch, "AcceleratorError", None)
    while e is not None:
        if isinstance(e, (KernelError, torch.cuda.OutOfMemoryError)):
            return True
        if accel is not None and isinstance(e, accel):
            return True
        if isinstance(e, RuntimeError) and "cuda" in str(e).lower():
            return True
        e = e.__cause__
    return False


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or str(Path(cuda_home) / "bin" / "nvcc")
    if not Path(found).is_file():
        raise KernelError(
            "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels cannot be built"
        )
    return found


def compile_sources(sources: dict[str, Path], out_dir: Path) -> None:
    """One nvcc per source {name: path}, built against CSRC's headers,
    all running at once, into `out_dir/<name>.so`, each `ptxas -v` log
    beside it as `<name>.ptxas.txt`; raises if any build fails."""
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        tmp = out_dir / f"{name}.so.tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    errors = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        (out_dir / f"{name}.ptxas.txt").write_text(log)
        if proc.returncode != 0:
            errors.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out_dir / f"{name}.so")
    if errors:
        raise KernelError("CUDA kernel build failed:\n" + "\n".join(errors))


def _compile_all(out_dir: Path) -> None:
    """Each missing library of LIBRARIES, from CSRC."""
    todo = [n for n in LIBRARIES if not (out_dir / f"{n}.so").is_file()]
    if todo:
        compile_sources({n: CSRC / f"{n}.cu" for n in todo}, out_dir)


def build() -> dict[str, ctypes.CDLL]:
    """Build (if needed) and load every kernel library; idempotent."""
    with _lock:
        if len(_libs) == len(LIBRARIES):
            return _libs
        out_dir = build_dir()
        _compile_all(out_dir)
        for name in LIBRARIES:
            try:
                lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
            except OSError as e:
                raise KernelError(f"cannot load {name}.so: {e}") from e
            for fn, argtypes in _SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _libs[name] = lib
        return _libs


def ptxas_report() -> dict[str, str]:
    """The `nvcc -Xptxas -v` output of each library's last build."""
    out_dir = build_dir()
    return {
        n: (out_dir / f"{n}.ptxas.txt").read_text()
        for n in LIBRARIES
        if (out_dir / f"{n}.ptxas.txt").is_file()
    }


def ptxas_usage(log: str, kernel: str) -> dict:
    """Registers and spill-store bytes of the kernel whose mangled name
    holds `kernel`, from an `nvcc -Xptxas -v` log; {} when it is absent."""
    out, inside = {}, False
    for ln in log.splitlines():
        if "Compiling entry" in ln:
            inside = kernel in ln
        elif inside and "spill stores" in ln:
            out["spill_bytes"] = int(ln.split("bytes spill stores")[0].split(",")[-1])
        elif inside and "Used" in ln and "registers" in ln:
            out["registers"] = int(ln.split("Used")[1].split()[0])
    return out


def _fn(lib: str, name: str):
    return getattr(build()[lib], name)


def _check(t: torch.Tensor, shape: tuple, what: str, dtype=torch.int32) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: expected {str(dtype).removeprefix('torch.')}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{what}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")


def _check_rows16(t: torch.Tensor, what: str) -> None:
    """Rows read as 16-byte loads need a 16-byte aligned start."""
    if t.data_ptr() % 16:
        raise ValueError(f"{what}: expected a 16-byte aligned tensor")


def _launch(f, kernel: str, device, batch: int, *ptrs) -> None:
    if batch == 0:
        return  # nothing to launch; outputs are empty
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = f(*ptrs, batch, stream)
    if rc != 0:
        raise KernelError(f"{kernel} launch failed: cudaError {rc}")
    launches[kernel] += 1


def fe_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(22, B) x (22, B) loose -> (22, B) canonical product mod p."""
    batch = a.shape[-1]
    _check(a, (NLIMBS, batch), "fe_mul a")
    _check(b, (NLIMBS, batch), "fe_mul b")
    if b.device != a.device:
        raise ValueError("fe_mul: operands on different devices")
    f = _fn("field_kernels", "fe_mul_launch")
    out = torch.empty_like(a)
    _launch(f, "fe_mul", a.device, batch, a.data_ptr(), b.data_ptr(), out.data_ptr())
    return out


def fe_sq(a: torch.Tensor) -> torch.Tensor:
    """(22, B) loose -> (22, B) canonical square mod p."""
    batch = a.shape[-1]
    _check(a, (NLIMBS, batch), "fe_sq a")
    f = _fn("field_kernels", "fe_sq_launch")
    out = torch.empty_like(a)
    _launch(f, "fe_sq", a.device, batch, a.data_ptr(), out.data_ptr())
    return out


def decompress(y: torch.Tensor, sign: torch.Tensor):
    """ZIP-215 decoding core. y: (22, B) loose limbs of the sign-masked
    encoding (may be >= p); sign: (1, B) int32 in {0, 1}.
    Returns valid (1, B) int32, x and t = x*y as (22, B) canonical limbs."""
    batch = y.shape[-1]
    _check(y, (NLIMBS, batch), "decompress y")
    _check(sign, (1, batch), "decompress sign")
    f = _fn("curve_kernels", "decompress_launch")
    valid = torch.empty((1, batch), dtype=torch.int32, device=y.device)
    x = torch.empty_like(y)
    t = torch.empty_like(y)
    _launch(f, "decompress", y.device, batch,
            y.data_ptr(), sign.data_ptr(), valid.data_ptr(), x.data_ptr(), t.data_ptr())
    return valid, x, t


def ladder_sub_mul8(a4: torch.Tensor, r4: torch.Tensor, s_digits: torch.Tensor,
                    k_digits: torch.Tensor, base_niels: torch.Tensor) -> torch.Tensor:
    """(X, Y, Z) of [8]([s]B + [k]A - R) per lane, stacked (3, 22, B),
    canonical. a4, r4: (4, 22, B) extended points (loose limbs); digits
    (64, B) int32 in [-8, 7]; base_niels (9, 3, 22) int32."""
    batch = s_digits.shape[-1]
    _check(a4, (4, NLIMBS, batch), "ladder_sub_mul8 a")
    _check(r4, (4, NLIMBS, batch), "ladder_sub_mul8 r")
    _check(s_digits, (64, batch), "ladder_sub_mul8 s_digits")
    _check(k_digits, (64, batch), "ladder_sub_mul8 k_digits")
    _check(base_niels, (9, 3, NLIMBS), "ladder_sub_mul8 base_niels")
    for t in (r4, s_digits, k_digits, base_niels):
        if t.device != a4.device:
            raise ValueError("ladder_sub_mul8: operands on different devices")
    f = _fn("curve_kernels", "ladder_sub_mul8_launch")
    out = torch.empty((3, NLIMBS, batch), dtype=torch.int32, device=a4.device)
    _launch(f, "ladder_sub_mul8", a4.device, batch,
            a4.data_ptr(), r4.data_ptr(), s_digits.data_ptr(), k_digits.data_ptr(),
            base_niels.data_ptr(), out.data_ptr())
    return out


def accum_weight(niels, gather_idx: torch.Tensor, gather_neg: torch.Tensor,
                 weights: torch.Tensor) -> torch.Tensor:
    """Weighted bucket points of the RLC/MSM route, stacked (4, 22, WK),
    canonical. niels: (Y+X, Y-X, 2dT), three (22, M) affine niels columns
    (loose limbs); gather_idx, gather_neg: (S, WK) int32 (index into M,
    sign flag 0/1); weights: (WK,) int32 in [0, 2^10).

    The table is re-laid out point-major, (M, 3, 22), before the launch,
    so that each lane's gather reads 264 contiguous bytes."""
    rounds, lanes = gather_idx.shape
    points = niels[0].shape[-1]
    for name, c in zip(("ypx", "ymx", "t2d"), niels):
        _check(c, (NLIMBS, points), f"accum_weight niels {name}")
    _check(gather_idx, (rounds, lanes), "accum_weight gather_idx")
    _check(gather_neg, (rounds, lanes), "accum_weight gather_neg")
    _check(weights, (lanes,), "accum_weight weights")
    dev = gather_idx.device
    for t in (*niels, gather_neg, weights):
        if t.device != dev:
            raise ValueError("accum_weight: operands on different devices")
    f = _fn("msm_kernels", "accum_weight_launch")
    table = torch.stack(niels).permute(2, 0, 1).contiguous()
    out = torch.empty((4, NLIMBS, lanes), dtype=torch.int32, device=dev)
    _launch(f, "accum_weight", dev, lanes,
            table.data_ptr(), gather_idx.data_ptr(), gather_neg.data_ptr(), weights.data_ptr(),
            out.data_ptr(), points, rounds)
    return out


def region_sum(weighted: torch.Tensor) -> torch.Tensor:
    """Sum of each region's REGION_LANES lanes by the pairwise tree of the
    RLC route: (4, 22, R * REGION_LANES) extended points (loose limbs),
    stacked, -> (4, 22, R), canonical. One block per region."""
    lanes = weighted.shape[-1]
    if lanes % REGION_LANES:
        raise ValueError(f"region_sum: {lanes} lanes is not a whole number of regions")
    regions = lanes // REGION_LANES
    _check(weighted, (4, NLIMBS, lanes), "region_sum weighted")
    f = _fn("msm_kernels", "region_sum_launch")
    out = torch.empty((4, NLIMBS, regions), dtype=torch.int32, device=weighted.device)
    _launch(f, "region_sum", weighted.device, regions, weighted.data_ptr(), out.data_ptr())
    return out


def window_combine(sums: torch.Tensor) -> torch.Tensor:
    """The MSM's total from its N_REGIONS region sums, Horner over the
    regions in descending weight: (4, 22, N_REGIONS) extended points (loose
    limbs), stacked, -> (4, 22, 1), canonical. One warp."""
    _check(sums, (4, NLIMBS, N_REGIONS), "window_combine sums")
    f = _fn("msm_kernels", "window_combine_launch")
    out = torch.empty((4, NLIMBS, 1), dtype=torch.int32, device=sums.device)
    _launch(f, "window_combine", sums.device, N_REGIONS, sums.data_ptr(), out.data_ptr())
    return out


def _check_sha_inputs(words: torch.Tensor, two_blocks: torch.Tensor, kernel: str) -> int:
    batch = words.shape[0]
    _check(words, (batch, 64), f"{kernel} words")
    _check(two_blocks, (batch,), f"{kernel} two_blocks", torch.bool)
    _check_rows16(words, f"{kernel} words")
    if two_blocks.device != words.device:
        raise ValueError(f"{kernel}: operands on different devices")
    return batch


def sha512_blocks(words: torch.Tensor, two_blocks: torch.Tensor) -> torch.Tensor:
    """SHA-512 of each lane's pre-padded blocks: words (B, 64) int32, the
    big-endian 32-bit words' bit patterns, 16-byte aligned; two_blocks (B,)
    bool. Returns (B, 64) uint8, each lane's digest in hashlib's byte
    order (byte i weighs 256^i in k); a lane whose flag is false takes the
    state after block 1."""
    batch = _check_sha_inputs(words, two_blocks, "sha512_blocks")
    f = _fn("sha512_kernels", "sha512_blocks_launch")
    out = torch.empty((batch, 64), dtype=torch.uint8, device=words.device)
    _launch(f, "sha512_blocks", words.device, batch,
            words.data_ptr(), two_blocks.data_ptr(), out.data_ptr())
    return out


def reduce512(digest: torch.Tensor) -> torch.Tensor:
    """(B, 64) uint8 little-endian 512-bit values, 16-byte aligned ->
    (22, B) int32 canonical 12-bit limbs of the value mod L."""
    batch = digest.shape[0]
    _check(digest, (batch, 64), "reduce512 digest", torch.uint8)
    _check_rows16(digest, "reduce512 digest")
    f = _fn("sha512_kernels", "reduce512_launch")
    out = torch.empty((NLIMBS, batch), dtype=torch.int32, device=digest.device)
    _launch(f, "reduce512", digest.device, batch, digest.data_ptr(), out.data_ptr())
    return out


def sha512_reduce(words: torch.Tensor, two_blocks: torch.Tensor) -> torch.Tensor:
    """`reduce512(sha512_blocks(words, two_blocks))` in one launch, the
    digest kept in registers: words (B, 64) int32, 16-byte aligned;
    two_blocks (B,) bool -> (22, B) int32 canonical 12-bit limbs of each
    lane's SHA-512 mod L."""
    batch = _check_sha_inputs(words, two_blocks, "sha512_reduce")
    f = _fn("sha512_kernels", "sha512_reduce_launch")
    out = torch.empty((NLIMBS, batch), dtype=torch.int32, device=words.device)
    _launch(f, "sha512_reduce", words.device, batch,
            words.data_ptr(), two_blocks.data_ptr(), out.data_ptr())
    return out
