"""ctypes binding for the C++ Ed25519 host engine (`csrc/host/`).

Twin of the Ed25519 half of `cometbft_tpu/crypto/native.py`: signing,
single and batch verification on the host's cores, the R||S||k row
packer of the ladder route (8-wide multi-buffer SHA-512 where the host has AVX-512)
and the RLC route's layout packer (`rlc_packer.inc`, a worker pool); and
the host control plane's SHA-256 and merkle root (`merkle_native.inc`)
and columnar commit codec (`commit_codec.inc`: `commit_parse`,
`commit_sign_bytes`), which the consensus types use.

The library is built on first use with the reference's command line

    g++ -std=c++17 -O3 -march=native -pthread -fPIC -shared \
        -o libed25519_host.so csrc/host/ed25519_native.cpp

into `build/cometbft_tpu_torch/host-<hash>/` beside the package, where
<hash> covers the sources, the flags and what `-march=native` means on
this host (the compiler's predefined macros for it: code built for one
CPU's instruction set does not run on every x86 CPU), so an unchanged
tree on the same host loads it at once. Without `g++`, or when the build fails, the
library is absent: `available()` is False, `build_log` says why, and the
callers take their Python paths (hashlib, `ed25519_ref`, numpy); signing
has none and raises.

The packer's worker threads start with the library's first RLC call and
live as long as the process: do not fork after that.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

HOST_SRC = Path(__file__).resolve().parent.parent / "csrc" / "host"
BUILD_ROOT = Path(__file__).resolve().parent.parent.parent / "build" / "cometbft_tpu_torch"
GXX_FLAGS = ["-std=c++17", "-O3", "-march=native", "-pthread", "-fPIC", "-shared"]
LIB_NAME = "libed25519_host.so"

_lock = threading.Lock()
_lib = None
_tried = False
build_log = ""  # why the library is absent, when it is

_P = ctypes.c_void_p
_U64 = ctypes.c_uint64
_SIGNATURES = {
    "ed25519_engine": (ctypes.c_int, []),
    "ed25519_verify": (ctypes.c_int, [ctypes.c_char_p, ctypes.c_char_p, _U64, ctypes.c_char_p]),
    "ed25519_sign": (None, [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, _U64,
                            ctypes.c_char_p]),
    "ed25519_pubkey": (None, [ctypes.c_char_p, ctypes.c_char_p]),
    "ed25519_batch_verify": (ctypes.c_int, [_U64, ctypes.c_char_p, ctypes.c_char_p,
                                            ctypes.POINTER(_U64), ctypes.c_char_p]),
    "ed25519_pack_rsk": (None, [_U64, _P, _P, _P, ctypes.POINTER(_U64), _P]),
    "rlc_packer_threads": (ctypes.c_int, []),
    "rlc_pack": (ctypes.c_long, [
        _U64, _U64, _U64,  # n, bucket, depth
        _P, _P, _P, ctypes.POINTER(_U64),  # pubs, sigs, msgs, msg_lens
        _P, _P,  # skip, z16
        ctypes.c_int, ctypes.c_int,  # elem_size, nchunks
        _P, _P, _P, _P, _P,  # stream, neg, counts, weights, c
        ctypes.POINTER(_U64),  # s_rounds
    ]),
    "merkle_root_native": (None, [_U64, ctypes.c_char_p, ctypes.POINTER(_U64), ctypes.c_char_p]),
    "sha256_oneshot": (None, [ctypes.c_char_p, _U64, ctypes.c_char_p]),
    "sha256_engine": (ctypes.c_int, []),
    "commit_parse": (ctypes.c_long, [
        ctypes.c_char_p, _U64, _U64,  # buf, len, cap
        ctypes.POINTER(_U64),  # head
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,  # flags, addr_lens, addrs
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),  # ts_s, ts_n
        ctypes.c_char_p, ctypes.c_char_p,  # sig_lens, sigs
        ctypes.POINTER(_U64),  # spans
    ]),
    "commit_sign_bytes": (ctypes.c_long, [
        _U64, _P, ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_char_p, _U64, ctypes.c_char_p, _U64,  # prefix_commit, prefix_nil
        ctypes.c_char_p, _U64, _P, _U64,  # tail, out, cap
        ctypes.POINTER(ctypes.c_uint32),  # lens_out
    ]),
}


def _sources() -> list[Path]:
    return sorted(HOST_SRC.glob("*.cpp")) + sorted(HOST_SRC.glob("*.inc"))


def _native_target() -> str:
    """The compiler's predefined macros under -march=native (the
    instruction-set extensions it will use on this host); empty without
    g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        return ""
    proc = subprocess.run([gxx, "-march=native", "-dM", "-E", "-x", "c++", os.devnull],
                          capture_output=True, text=True, timeout=60)
    return proc.stdout


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(_native_target().encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / f"host-{h.hexdigest()[:16]}"


def _build(out: Path) -> bool:
    global build_log
    gxx = shutil.which("g++")
    if gxx is None:
        build_log = "g++ not found on PATH"
        return False
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    cmd = [gxx, *GXX_FLAGS, "-o", str(tmp), str(HOST_SRC / "ed25519_native.cpp")]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        build_log = f"g++ failed to run: {e}"
        tmp.unlink(missing_ok=True)
        return False
    if proc.returncode != 0:
        build_log = f"g++ exited {proc.returncode}\n{proc.stderr}"
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, out)  # atomic: concurrent builds each land a whole file
    return True


def get_lib():
    """The loaded library, building it if needed; None if it is absent."""
    global _lib, _tried, build_log
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = build_dir() / LIB_NAME
        if not so.is_file() and not _build(so):
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as e:
            build_log = f"cannot load {so}: {e}"
            return None
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _lib = lib
        return _lib


def _required():
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"native ed25519 unavailable: {build_log}")
    return lib


def engine() -> str:
    """Which code serves verification: "avx512-ifma" (the 8-lane vpmadd52
    engine), "portable" (the scalar 5x51 engine) or "unavailable"."""
    lib = get_lib()
    if lib is None:
        return "unavailable"
    return "avx512-ifma" if lib.ed25519_engine() else "portable"


def available() -> bool:
    return get_lib() is not None


def verify(pub: bytes, msg: bytes, sig: bytes) -> bool:
    """ZIP-215 verify of one signature; raises RuntimeError if the library
    is absent."""
    return bool(_required().ed25519_verify(pub, msg, len(msg), sig))


def sign(seed: bytes, pub: bytes, msg: bytes) -> bytes:
    """RFC 8032 signature R||S of `msg` under the 32-byte seed whose public
    key is `pub`; raises RuntimeError if the library is absent."""
    out = ctypes.create_string_buffer(64)
    _required().ed25519_sign(seed, pub, msg, len(msg), out)
    return out.raw


def pubkey(seed: bytes) -> bytes:
    """The 32-byte public key of a 32-byte seed; raises RuntimeError if
    the library is absent."""
    out = ctypes.create_string_buffer(32)
    _required().ed25519_pubkey(seed, out)
    return out.raw


def batch_verify(items) -> bool:
    """One random-linear-combination check of [(pub32, msg, sig64), ...]
    (a Pippenger multi-scalar multiplication in C++). False means some
    signature failed (or there is none); the caller verifies singly for
    the bitmap."""
    lib = _required()
    n = len(items)
    if n == 0:
        return False
    pubs = b"".join(it[0] for it in items)
    sigs = b"".join(it[2] for it in items)
    msgs = b"".join(it[1] for it in items)
    lens = (_U64 * n)(*(len(it[1]) for it in items))
    return bool(lib.ed25519_batch_verify(n, pubs, msgs, lens, sigs))


def _addr(buf, nbytes: int, what: str):
    """Zero-copy pointer to a bytes-like or uint8 array holding at least
    `nbytes` bytes."""
    arr = np.frombuffer(buf, np.uint8)
    if arr.size < nbytes:
        raise ValueError(f"{what}: {arr.size} bytes, need {nbytes}")
    return arr.ctypes.data_as(_P)


def _lens_ptr(msg_lens, n: int):
    if not (isinstance(msg_lens, np.ndarray) and msg_lens.dtype == np.uint64
            and msg_lens.flags.c_contiguous and msg_lens.size == n):
        raise ValueError("msg_lens must be a C-contiguous uint64 array of n lengths")
    return msg_lens.ctypes.data_as(ctypes.POINTER(_U64))


def _out_ptr(arr: np.ndarray, dtype, nbytes: int, what: str):
    if not (isinstance(arr, np.ndarray) and arr.dtype == dtype and arr.flags.c_contiguous
            and arr.nbytes >= nbytes):
        raise ValueError(f"{what} must be a C-contiguous {np.dtype(dtype)} array of at least "
                         f"{nbytes} bytes")
    return arr.ctypes.data_as(_P)


def pack_rsk(n: int, sig_blob, pub_blob, msg_blob, msg_lens, out_rsk) -> bool:
    """R||S||k wire rows (stride 96) for n lanes, k = SHA-512(R||A||M) mod
    L, written into `out_rsk` (a C-contiguous uint8 array, at least n rows
    of 96 bytes). The blobs may be bytes, bytearray or uint8 arrays (no
    copy); `msg_lens` is a uint64 array. False when the library is absent
    (the caller packs in Python)."""
    lib = get_lib()
    if lib is None:
        return False
    lens = _lens_ptr(msg_lens, n)
    if out_rsk.ndim != 2 or out_rsk.shape[1] != 96:
        raise ValueError(f"out_rsk must have rows of 96 bytes, got shape {out_rsk.shape}")
    lib.ed25519_pack_rsk(
        n, _addr(sig_blob, 64 * n, "sig_blob"), _addr(pub_blob, 32 * n, "pub_blob"),
        _addr(msg_blob, int(msg_lens.sum()), "msg_blob"), lens,
        _out_ptr(out_rsk, np.uint8, 96 * n, "out_rsk"))
    return True


def rlc_available() -> bool:
    """True when the library, and with it the native RLC packer, loaded."""
    return available()


def rlc_packer_threads() -> int:
    """Workers the native packer spreads a batch across (1 when the
    library is absent: the numpy packer runs on one core)."""
    lib = get_lib()
    return 1 if lib is None else max(1, int(lib.rlc_packer_threads()))


def rlc_pack(n, bucket, depth, pub_blob, sig_blob, msg_blob, msg_lens, skip_u8, z16,
             elem_size, out_stream, out_neg, out_counts, out_weights, out_c, nchunks=0):
    """`crypto/rlc.py::prepare` in one C call: hashes, z*h and sum z*s mod
    L, signed-digit recode, bucket layout and the dense stream, on the
    packer's workers (byte-identical for any `nchunks`; 0 = the pool's
    width). Outputs are preallocated C-contiguous arrays: stream >= 39n
    entries of `elem_size` bytes, neg >= 39n bytes, counts WK bytes,
    weights (39, 512) int32, c 32 bytes. Returns (c_len, s_rounds); c_len
    < 0 is a decline (-1 a window's lanes overflow, -2 no live lane).
    Raises RuntimeError if the library is absent."""
    lib = _required()
    if out_stream.itemsize != elem_size:
        raise ValueError(f"out_stream has {out_stream.itemsize}-byte entries, not {elem_size}")
    s_rounds = _U64(0)
    c_len = lib.rlc_pack(
        n, bucket, depth, _addr(pub_blob, 32 * n, "pub_blob"),
        _addr(sig_blob, 64 * n, "sig_blob"), _addr(msg_blob, int(msg_lens.sum()), "msg_blob"),
        _lens_ptr(msg_lens, n), _addr(skip_u8, n, "skip"), _addr(z16, 16 * n, "z16"),
        elem_size, nchunks,
        _out_ptr(out_stream, out_stream.dtype, 39 * n * elem_size, "out_stream"),
        _out_ptr(out_neg, np.uint8, 39 * n, "out_neg"),
        _out_ptr(out_counts, np.uint8, 39 * 512, "out_counts"),
        _out_ptr(out_weights, np.int32, 39 * 512 * 4, "out_weights"),
        _out_ptr(out_c, np.uint8, 32, "out_c"),
        ctypes.byref(s_rounds),
    )
    return int(c_len), int(s_rounds.value)


def commit_parse(buf: bytes):
    """Columnar parse of a Commit wire buffer's signature list in one C
    call. Returns (height_u64, round_u64, bid_span, cols) where cols =
    (count, flags, addr_lens, addrs, ts_s, ts_n, sig_lens, sigs, spans),
    or None when the library is absent or the buffer needs the
    (stricter-error) Python walk of `types/block.py::Commit.decode`."""
    lib = get_lib()
    if lib is None:
        return None
    cap = len(buf) // 6 + 4
    while True:
        head = (_U64 * 4)()
        flags = ctypes.create_string_buffer(cap)
        addr_lens = ctypes.create_string_buffer(cap)
        addrs = ctypes.create_string_buffer(cap * 20)
        ts_s = (ctypes.c_int64 * cap)()
        ts_n = (ctypes.c_int64 * cap)()
        sig_lens = ctypes.create_string_buffer(cap)
        sigs = ctypes.create_string_buffer(cap * 64)
        spans = (_U64 * (cap * 2))()
        rc = lib.commit_parse(buf, len(buf), cap, head, flags, addr_lens, addrs,
                              ts_s, ts_n, sig_lens, sigs, spans)
        if rc == -2:  # more signatures than slots: retry with room
            cap *= 2
            continue
        if rc < 0:
            return None
        return (int(head[0]), int(head[1]), (int(head[2]), int(head[3])),
                (int(rc), flags.raw, addr_lens.raw, addrs.raw, ts_s, ts_n,
                 sig_lens.raw, sigs.raw, spans))


def commit_sign_bytes(n, flags, ts_s, ts_n, prefix_commit: bytes, prefix_nil: bytes,
                      tail: bytes):
    """Canonical sign bytes of every commit slot in one C call.

    flags: uint8 array; ts_s / ts_n: int64 arrays (no copy). Returns (blob
    bytes, uint32 lengths array; 0 for an absent slot), or None when the
    library is absent or a flag is not ABSENT, COMMIT or NIL."""
    lib = get_lib()
    if lib is None:
        return None
    # worst case a slot: 3-byte length prefix + prefix + 24-byte timestamp + tail
    cap = int(n) * (max(len(prefix_commit), len(prefix_nil)) + len(tail) + 32)
    out = np.empty(cap, np.uint8)
    lens = np.empty(n, np.uint32)
    total = lib.commit_sign_bytes(
        n, flags.ctypes.data_as(_P),
        ts_s.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ts_n.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        prefix_commit, len(prefix_commit), prefix_nil, len(prefix_nil),
        tail, len(tail), out.ctypes.data_as(_P), cap,
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    if total < 0:
        return None
    return out[:total].tobytes(), lens


def merkle_root(items) -> bytes:
    """RFC-6962 merkle root of a list of byte leaves in one C call (leaf
    prefix 0x00, inner 0x01, reference crypto/merkle/hash.go); raises
    RuntimeError if the library is absent."""
    lib = _required()
    n = len(items)
    offs = (_U64 * (n + 1))()
    pos = 0
    for i, it in enumerate(items):
        offs[i] = pos
        pos += len(it)
    offs[n] = pos
    out = ctypes.create_string_buffer(32)
    lib.merkle_root_native(n, b"".join(items), offs, out)
    return out.raw


def sha256(data: bytes) -> bytes:
    """SHA-256 of `data` in C (SHA-NI where the host has it); raises
    RuntimeError if the library is absent."""
    out = ctypes.create_string_buffer(32)
    _required().sha256_oneshot(data, len(data), out)
    return out.raw


def sha256_engine() -> str:
    """"sha-ni", "portable" or "unavailable"."""
    lib = get_lib()
    if lib is None:
        return "unavailable"
    return "sha-ni" if lib.sha256_engine() else "portable"
