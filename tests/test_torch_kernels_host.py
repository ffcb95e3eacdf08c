"""The CUDA kernels' code, compiled for the host and run on the CPU.

This machine has no nvcc and no card, so `csrc/curve_kernels.cu`,
`csrc/field_kernels.cu`, `csrc/msm_kernels.cu` and `csrc/sha512_kernels.cu`
are compiled here with
g++ against a small header that stands in for the CUDA features they use:
each CUDA thread of a block is a user-space context (`ucontext`),
`__syncthreads` a hand-over to the next one round-robin, `__shfl_sync` an
exchange through an array between two such barriers, shared memory one
array per block. That runs the four-threads-per-lane ladder (its
shuffles, layouts, table columns and signed-digit handling), `decompress`,
the field products, the RLC route's `accum_weight` (four threads a lane),
the RLC tail's `region_sum` (one block per region, partial sums in shared
memory) and `window_combine` (one lane on four threads), and the
device-SHA routes' `sha512_blocks`, `reduce512` and the fused
`sha512_reduce` (one lane a thread) on small inputs, which must agree with the plain PyTorch versions (after
`freeze` for field elements; digests and scalars bit for bit). Partial
thread groups and partial blocks are in every ladder and `accum_weight`
case. Skips without g++.
"""

import hashlib
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cometbft_tpu_torch.crypto import ed25519_ref as ref  # noqa: E402
from cometbft_tpu_torch.ops import curve as C  # noqa: E402
from cometbft_tpu_torch.ops import field as F  # noqa: E402
from cometbft_tpu_torch.ops import kernels as K  # noqa: E402
from cometbft_tpu_torch.ops import msm as M  # noqa: E402

SHIM = r"""
#pragma once
#include <ucontext.h>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <functional>
#include <string>
#include <vector>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __noinline__
#define __constant__
#define __restrict__
#define __launch_bounds__(...)
struct int2 { int x, y; };
struct uint4 { unsigned x, y, z, w; };
template <typename T> inline T __ldg(const T* p) { return *p; }
// The threads of a block are user-space contexts run round-robin: each
// runs until it reaches a barrier, then hands over to the next live one,
// so a barrier holds once the turn comes back.
struct Dim3 { unsigned x = 0, y = 0, z = 0; };
inline Dim3 threadIdx, blockIdx, blockDim;
inline std::vector<ucontext_t> g_ctx;
inline std::vector<std::vector<char>> g_stack;
inline std::vector<char> g_done;
inline ucontext_t g_sched;
inline int g_cur = 0;
inline const std::function<void()>* g_body = nullptr;
inline std::vector<uint32_t> g_slots, g_smem;
inline int next_live(int from) {
  const int n = (int)g_ctx.size();
  for (int i = 1; i <= n; ++i) {
    const int t = (from + i) % n;
    if (!g_done[t]) return t;
  }
  return -1;
}
inline void __syncthreads() {
  const int me = g_cur, nxt = next_live(me);
  if (nxt == me) return;
  g_cur = nxt;
  threadIdx.x = nxt;
  swapcontext(&g_ctx[me], &g_ctx[nxt]);
  threadIdx.x = g_cur;
}
inline uint32_t __shfl_sync(unsigned, uint32_t v, int src, int width) {
  g_slots[threadIdx.x] = v;
  __syncthreads();
  const uint32_t r = g_slots[(threadIdx.x & ~(unsigned)(width - 1)) + (src & (width - 1))];
  __syncthreads();
  return r;
}
inline void emu_entry() {
  (*g_body)();
  g_done[g_cur] = 1;
  const int nxt = next_live(g_cur);
  if (nxt < 0) setcontext(&g_sched);
  g_cur = nxt;
  threadIdx.x = nxt;
  setcontext(&g_ctx[nxt]);
}
inline void emu_launch(unsigned blocks, unsigned threads, size_t smem_bytes,
                       const std::function<void()>& body) {
  blockDim.x = threads;
  g_body = &body;
  g_slots.assign(threads, 0);
  g_ctx.assign(threads, ucontext_t{});
  g_stack.assign(threads, std::vector<char>(1 << 18));
  for (unsigned b = 0; b < blocks; ++b) {
    g_smem.assign(smem_bytes / 4 + 1, 0xdeadbeefu);
    g_done.assign(threads, 0);
    blockIdx.x = b;
    for (unsigned t = 0; t < threads; ++t) {
      getcontext(&g_ctx[t]);
      g_ctx[t].uc_stack.ss_sp = g_stack[t].data();
      g_ctx[t].uc_stack.ss_size = g_stack[t].size();
      g_ctx[t].uc_link = nullptr;
      makecontext(&g_ctx[t], emu_entry, 0);
    }
    g_cur = 0;
    threadIdx.x = 0;
    swapcontext(&g_sched, &g_ctx[0]);
  }
}
static std::vector<int32_t> rd(const std::string& p, size_t n) {
  std::vector<int32_t> v(n);
  FILE* f = fopen(p.c_str(), "rb");
  if (!f || fread(v.data(), 4, n, f) != n) abort();
  fclose(f);
  return v;
}
static void wr(const std::string& p, const std::vector<int32_t>& v) {
  FILE* f = fopen(p.c_str(), "wb");
  fwrite(v.data(), 4, v.size(), f);
  fclose(f);
}
"""

MAINS = {
    "curve_kernels": r"""
int main(int argc, char** argv) {
  const std::string kind = argv[1], d = argv[3];
  const long B = atol(argv[2]);
  if (kind == "ladder") {
    auto a4 = rd(d + "/a4", 4 * 22 * B), r4 = rd(d + "/r4", 4 * 22 * B);
    auto s = rd(d + "/s", 64 * B), k = rd(d + "/k", 64 * B), base = rd(d + "/base", 9 * 3 * 22);
    std::vector<int32_t> out(3 * 22 * B, -1);
    const size_t smem = sizeof(uint32_t) * (BASE_WORDS + (size_t)TBL_WORDS * LADDER_THREADS);
    emu_launch(blocks_for(B * LANE_THREADS, LADDER_THREADS), LADDER_THREADS, smem, [&] {
      ladder_sub_mul8_kernel(a4.data(), r4.data(), s.data(), k.data(), base.data(), out.data(), B);
    });
    wr(d + "/out", out);
  } else {
    auto y = rd(d + "/y", 22 * B), sign = rd(d + "/sign", B);
    std::vector<int32_t> valid(B, -1), x(22 * B, -1), t(22 * B, -1);
    emu_launch(blocks_for(B, DECOMPRESS_THREADS), DECOMPRESS_THREADS, 0, [&] {
      decompress_kernel(y.data(), sign.data(), valid.data(), x.data(), t.data(), B);
    });
    wr(d + "/valid", valid);
    wr(d + "/x", x);
    wr(d + "/t", t);
  }
  return 0;
}
""",
    "field_kernels": r"""
int main(int argc, char** argv) {
  const long B = atol(argv[2]);
  const std::string d = argv[3];
  auto a = rd(d + "/a", 22 * B), b = rd(d + "/b", 22 * B);
  std::vector<int32_t> mul(22 * B), sq(22 * B);
  emu_launch(blocks_for(B), THREADS, 0, [&] { fe_mul_kernel(a.data(), b.data(), mul.data(), B); });
  emu_launch(blocks_for(B), THREADS, 0, [&] { fe_sq_kernel(a.data(), sq.data(), B); });
  wr(d + "/mul", mul);
  wr(d + "/sq", sq);
  return 0;
}
""",
    "msm_kernels": r"""
int main(int argc, char** argv) {
  const std::string kind = argv[1], d = argv[3];
  const long regions = atol(argv[2]);
  if (kind == "accum_weight") {  // argv[2]: lanes; dims: points, rounds
    const long lanes = regions;
    auto dims = rd(d + "/dims", 2);
    const long points = dims[0], rounds = dims[1];
    auto niels = rd(d + "/niels", points * NIELS_WORDS);
    auto idx = rd(d + "/idx", rounds * lanes), neg = rd(d + "/neg", rounds * lanes);
    auto weights = rd(d + "/weights", lanes);
    std::vector<int32_t> out(4 * 22 * lanes, -1);
    emu_launch((lanes * LANE_THREADS + ACCUM_THREADS - 1) / ACCUM_THREADS, ACCUM_THREADS, 0, [&] {
      accum_weight_kernel(niels.data(), idx.data(), neg.data(), weights.data(), out.data(), points,
                          rounds, lanes);
    });
    wr(d + "/out", out);
    return 0;
  }
  std::vector<int32_t> out(4 * 22 * (kind == "region_sum" ? regions : 1), -1);
  if (kind == "region_sum") {
    auto pts = rd(d + "/pts", 4 * 22 * regions * K_BUCKETS);
    emu_launch(regions, SUM_THREADS, sizeof(uint32_t) * SUM_SMEM_WORDS,
               [&] { region_sum_kernel(pts.data(), out.data(), regions); });
  } else {
    auto sums = rd(d + "/sums", 4 * 22 * regions);
    emu_launch(1, COMBINE_THREADS, 0,
               [&] { window_combine_kernel(sums.data(), out.data(), regions); });
  }
  wr(d + "/out", out);
  return 0;
}
""",
    "sha512_kernels": r"""
int main(int argc, char** argv) {
  const std::string kind = argv[1], d = argv[3];
  const long B = atol(argv[2]);
  if (kind == "reduce512") {  // digest (B, 64) bytes -> (22, B) limbs
    auto digest = rd(d + "/digest", 16 * B);
    std::vector<int32_t> out(22 * B, -1);
    emu_launch((B + REDUCE_THREADS - 1) / REDUCE_THREADS, REDUCE_THREADS, 0, [&] {
      reduce512_kernel((const uint8_t*)digest.data(), out.data(), B);
    });
    wr(d + "/out", out);
    return 0;
  }
  // words (B, 64), two (B,) as int32 0/1 -> digest (B, 64) bytes or (22, B) limbs
  auto words = rd(d + "/words", 64 * B), two32 = rd(d + "/two", B);
  std::vector<uint8_t> two(two32.begin(), two32.end());
  const bool fused = kind == "sha512_reduce";
  std::vector<int32_t> out((fused ? 22 : 16) * B, -1);
  emu_launch((B + SHA_THREADS - 1) / SHA_THREADS, SHA_THREADS, 0, [&] {
    if (fused)
      sha512_reduce_kernel((const uint32_t*)words.data(), two.data(), out.data(), B);
    else
      sha512_blocks_kernel((const uint32_t*)words.data(), two.data(), (uint32_t*)out.data(), B);
  });
  wr(d + "/out", out);
  return 0;
}
""",
}


@pytest.fixture(scope="module")
def host_build(tmp_path_factory):
    """Compile each kernel source for the host; {library: executable}."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel sources for the host")
    out = tmp_path_factory.mktemp("kernels_host")
    (out / "cuda_runtime.h").write_text(SHIM)
    exes = {}
    for lib, main in MAINS.items():
        src = (K.CSRC / f"{lib}.cu").read_text()
        src = src[: src.index('extern "C"')]  # the launchers use <<<>>>
        src = src.replace("extern __shared__ uint32_t smem[];", "uint32_t* smem = g_smem.data();")
        cpp = out / f"{lib}.cpp"
        cpp.write_text(src + main)
        exe = out / lib
        subprocess.run([gxx, "-std=c++20", "-O1", "-w", "-I", str(out),
                        "-I", str(K.CSRC), "-o", str(exe), str(cpp)], check=True,
                       capture_output=True, timeout=600)
        exes[lib] = exe
    return exes


def run(exe, kind, batch, arrays, outputs, tmp_path):
    for name, arr in arrays.items():
        np.ascontiguousarray(arr, dtype=np.int32).tofile(tmp_path / name)
    subprocess.run([str(exe), kind, str(batch), str(tmp_path)], check=True, timeout=600)
    return [torch.from_numpy(np.fromfile(tmp_path / name, np.int32).reshape(shape))
            for name, shape in outputs]


def frozen_equal(got, want):
    return torch.equal(F.freeze(got), F.freeze(want))


def torsion_point():
    for y in range(2, 50):
        aff = ref._decode_point(y.to_bytes(32, "little"), zip215=True)
        if aff is None:
            continue
        t = ref._ext_scalar_mul(ref.L, ref._to_ext(aff))
        if not ref._ext_is_identity(t):
            return t
    raise AssertionError("no torsion point found")


def test_field_products_match_plain(host_build, tmp_path):
    rng = np.random.default_rng(0)
    n = 40
    a = np.empty((2, F.NLIMBS, n), np.int32)
    a[:, 0] = rng.integers(0, 13824, (2, n))
    a[:, 1:] = rng.integers(0, 4300, (2, F.NLIMBS - 1, n))
    a[:, :, 0] = 0
    a[:, 0, 1], a[:, 1:, 1] = 13823, 4299  # the loose invariant's top
    a[:, :, 2] = F.P_LIMBS[None]
    mul, sq = run(host_build["field_kernels"], "field", n, {"a": a[0], "b": a[1]},
                  [("mul", (F.NLIMBS, n)), ("sq", (F.NLIMBS, n))], tmp_path)
    ta, tb = torch.from_numpy(a[0]), torch.from_numpy(a[1])
    assert frozen_equal(mul, F.mul_plain(ta, tb)) and torch.equal(mul, F.freeze(mul))
    assert frozen_equal(sq, F.sq_plain(ta)) and torch.equal(sq, F.freeze(sq))


def test_decompress_matches_plain(host_build, tmp_path):
    rng = np.random.default_rng(1)
    n = 45  # one full warp-block and a partial one
    encs = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    for i, y in enumerate([1, 1 + F.P_INT, 0, F.P_INT, F.P_INT + 18, 2, 3]):
        encs[i] = np.frombuffer(y.to_bytes(32, "little"), np.uint8)
    encs[7] = encs[0]
    encs[7, 31] |= 0x80
    t8 = torsion_point()
    for i in range(8):
        encs[8 + i] = np.frombuffer(
            ref._encode_point(*ref._ext_to_affine(ref._ext_scalar_mul(i, t8))), np.uint8)
    sign, y = C._split_encoding(torch.from_numpy(encs))
    valid, x, t = run(host_build["curve_kernels"], "decompress", n,
                      {"y": y.numpy(), "sign": sign.numpy()},
                      [("valid", (n,)), ("x", (F.NLIMBS, n)), ("t", (F.NLIMBS, n))], tmp_path)
    pv, px, pt = C.decompress_plain(y, sign)
    assert torch.equal(valid != 0, pv)
    assert frozen_equal(x, px) and frozen_equal(t, pt)
    assert torch.equal(x, F.freeze(x)) and torch.equal(t, F.freeze(t))


@pytest.mark.parametrize("n", [1, 3, 21])
def test_ladder_matches_plain(host_build, tmp_path, n):
    """Random points and digits, and in the first lanes the digit extremes
    (all -8, all 7, all 0) and identity and 8-torsion A and R."""
    rng = np.random.default_rng(2 + n)
    digits = lambda: torch.from_numpy(rng.integers(-8, 8, (64, n), dtype=np.int32))
    a = [c.clone() for c in C.fixed_base(digits())]
    r = [c.clone() for c in C.fixed_base(digits())]
    sd, kd = digits(), digits()
    for lane, v in enumerate((-8, 7, 0)[:n]):
        sd[:, lane] = v
        kd[:, lane] = v
    t8 = [torch.from_numpy(F.from_int(c % F.P_INT)) for c in torsion_point()]
    ident = [torch.from_numpy(F.from_int(c)) for c in (0, 1, 1, 0)]
    for lane, pt, dst in ((3, ident, a), (4, t8, a), (5, ident, r), (6, t8, r)):
        if lane < n:
            for c in range(4):
                dst[c][:, lane] = pt[c]
    out = run(host_build["curve_kernels"], "ladder", n,
              {"a4": torch.stack(a).numpy(), "r4": torch.stack(r).numpy(), "s": sd.numpy(),
               "k": kd.numpy(), "base": C.BASE_NIELS.numpy()},
              [("out", (3, F.NLIMBS, n))], tmp_path)[0]
    want = C.ladder_sub_mul8_plain(sd, kd, tuple(a), tuple(r))
    assert all(frozen_equal(g, w) for g, w in zip(out, want))
    assert torch.equal(out, torch.stack([F.freeze(g) for g in out]))


def random_points(rng, n):
    """n extended points of the prime-order group, (4, 22, n) int32 limbs,
    as the weighted lanes hold them: Z not 1, and some lanes the identity
    (a lane of weight 0) or an 8-torsion point. P_{i+1} = P_i + Q from a
    random start and step."""
    start = ref._ext_scalar_mul(int(rng.integers(1, 2**62)), ref.B_POINT)
    step = ref._ext_scalar_mul(int(rng.integers(1, 2**62)), ref.B_POINT)
    t8 = torsion_point()
    out = np.zeros((4, F.NLIMBS, n), np.int32)
    pt = start
    for i in range(n):
        pt = ref._ext_add(pt, step)
        if i % 37 == 5:
            lane = ref._IDENT
        elif i % 101 == 9:
            lane = ref._ext_add(pt, t8)
        else:
            lane = pt
        for c in range(4):
            out[c, :, i] = F.from_int(lane[c] % F.P_INT)
    return out


@pytest.mark.parametrize("regions", [1, 3])
def test_region_sum_matches_plain(host_build, tmp_path, regions):
    rng = np.random.default_rng(20 + regions)
    pts = random_points(rng, regions * M.K_BUCKETS)
    out = run(host_build["msm_kernels"], "region_sum", regions, {"pts": pts},
              [("out", (4, F.NLIMBS, regions))], tmp_path)[0]
    want = M.region_tree_sum_plain(torch.from_numpy(pts))
    assert all(frozen_equal(g, w) for g, w in zip(out, want))
    assert torch.equal(out, torch.stack([F.freeze(g) for g in out]))


def test_window_combine_matches_plain(host_build, tmp_path):
    sums = random_points(np.random.default_rng(30), M.N_REGIONS)
    out = run(host_build["msm_kernels"], "window_combine", M.N_REGIONS, {"sums": sums},
              [("out", (4, F.NLIMBS, 1))], tmp_path)[0]
    want = M.window_combine_plain(torch.from_numpy(sums))
    assert all(frozen_equal(g, w) for g, w in zip(out, want))
    assert torch.equal(out, torch.stack([F.freeze(g) for g in out]))


def affine_niels(pt):
    """(Y+X, Y-X, 2dT) of an extended point, as three lists of 22 limbs of
    its affine form (Z = 1), as decompression leaves the points of the
    RLC table."""
    x, y = ref._ext_to_affine(pt)
    return [F.from_int((y + x) % F.P_INT), F.from_int((y - x) % F.P_INT),
            F.from_int(2 * ref.D * x * y % F.P_INT)]


@pytest.mark.parametrize("lanes, rounds", [(21, 8), (13, 5)])
def test_accum_weight_matches_plain(host_build, tmp_path, lanes, rounds):
    """A table of random points with the identity and an 8-torsion point
    among them and the identity sentinel last; gather rows with negated
    rounds and padding (the sentinel) at the end of each lane, one lane all
    padding; weights 0, 1, 511, 512 and 1,023 in the first lanes. 21 lanes
    end in a partial block and a partial warp, 13 in a partial warp, at
    S = 8 and an odd S."""
    rng = np.random.default_rng(40 + rounds)
    pts = [ref._ext_scalar_mul(int(rng.integers(1, 2**62)), ref.B_POINT) for _ in range(9)]
    pts += [ref._IDENT, torsion_point(), ref._IDENT]  # the last one is the sentinel
    cols = [torch.from_numpy(np.stack(c, axis=1)) for c in zip(*map(affine_niels, pts))]
    points, sentinel = len(pts), len(pts) - 1
    idx = rng.integers(0, points, (rounds, lanes), dtype=np.int32)
    neg = rng.integers(0, 2, (rounds, lanes), dtype=np.int32)
    counts = rng.integers(0, rounds + 1, lanes)
    counts[:3] = (rounds, 0, rounds - 1)
    pad = np.arange(rounds)[:, None] >= counts[None, :]
    idx[pad], neg[pad] = sentinel, 0
    weights = rng.integers(0, 1 << M.C_BITS, lanes, dtype=np.int32)
    weights[:5] = (0, 1, 511, 512, 1023)
    table = torch.stack(cols).permute(2, 0, 1).contiguous()  # the wrapper's layout
    out = run(host_build["msm_kernels"], "accum_weight", lanes,
              {"dims": np.array([points, rounds]), "niels": table.numpy(), "idx": idx,
               "neg": neg, "weights": weights},
              [("out", (4, F.NLIMBS, lanes))], tmp_path)[0]
    want = M.accumulate_weighted_plain(tuple(cols), torch.from_numpy(idx),
                                       torch.from_numpy(neg != 0), torch.from_numpy(weights))
    assert all(frozen_equal(g, w) for g, w in zip(out, want))
    assert torch.equal(out, torch.stack([F.freeze(g) for g in out]))


@pytest.mark.parametrize("n", [1, 37])
def test_sha512_blocks_matches_plain(host_build, tmp_path, n):
    """Messages of 0 to 175 bytes (the lengths at the block edge among
    them) behind 64-byte R||A heads, one- and two-block lanes, and in the
    last lanes a one-block flag over a second block of junk; 37 lanes end
    in a partial block."""
    from cometbft_tpu_torch.ops import sha512 as H

    rng = np.random.default_rng(60 + n)
    lens = [0, 111 - 64, 112 - 64, 175] + rng.integers(0, 176, n).tolist()
    msgs = [rng.bytes(64 + ln) for ln in lens[:n]]
    words, two = H.pad_messages(msgs)
    if n > 4:
        words[-1, 32:] = rng.integers(0, 2**32, 32, dtype=np.uint32)
        two[-1] = False
    out = run(host_build["sha512_kernels"], "sha512", n,
              {"words": words.view(np.int32), "two": two.astype(np.int32)},
              [("out", (n, 16))], tmp_path)[0]
    digest = torch.from_numpy(out.numpy().view(np.uint8).reshape(n, 64))
    want = H.sha512_digest_plain(torch.from_numpy(words.view(np.int32)), torch.from_numpy(two))
    assert torch.equal(digest, want)
    assert bytes(digest[0].numpy()) == hashlib.sha512(msgs[0]).digest()


@pytest.mark.parametrize("n", [1, 70])
def test_reduce512_matches_plain(host_build, tmp_path, n):
    """0, L - 1, L, 2L, 2^512 - 1, values just under multiples of L, and
    random 512-bit values; 70 lanes end in a partial block."""
    from cometbft_tpu_torch.ops import scalar as SC

    rng = np.random.default_rng(80 + n)
    L, top = SC.L_INT, (1 << 512) - 1
    vals = [top, 0, L - 1, L, 2 * L, 3 * L - 1, top // L * L - 1, (2**259 + 3) * L - 1]
    vals = (vals + [int.from_bytes(rng.bytes(64), "little") for _ in range(n)])[:n]
    digest = np.stack([np.frombuffer(v.to_bytes(64, "little"), np.uint8) for v in vals])
    out = run(host_build["sha512_kernels"], "reduce512", n, {"digest": digest.view(np.int32)},
              [("out", (22, n))], tmp_path)[0]
    assert torch.equal(out, SC.reduce512_plain(torch.from_numpy(digest)))
    assert [sum(int(x) << (12 * i) for i, x in enumerate(out[:, j])) for j in range(n)] == [
        v % L for v in vals]


@pytest.mark.parametrize("n", [1, 3, 33, 70])
def test_sha512_reduce_matches_plain(host_build, tmp_path, n):
    """The fused hash and reduction: one- and two-block lanes (the block
    edge lengths first), the last lanes of 70 a warp whose lanes are all
    one-block, 33 and 70 ending in a partial block; k equal to the plain composition and to Python's `% L` of
    hashlib's digest. The Barrett step the kernel ends with is
    `reduce512`'s: on the reduction's edge digests (0, L - 1, L, 2L,
    2^512 - 1, just under multiples of L) in the first lanes of a
    launch of the same width, it gives Python's `% L`."""
    from cometbft_tpu_torch.ops import scalar as SC
    from cometbft_tpu_torch.ops import sha512 as H

    rng = np.random.default_rng(90 + n)
    lens = ([0, 111 - 64, 112 - 64, 175] + rng.integers(0, 176, n).tolist())[:n]
    if n > 64:
        lens[64:] = rng.integers(0, 48, n - 64).tolist()  # a block of one-block lanes
    msgs = [rng.bytes(64 + ln) for ln in lens]
    words, two = H.pad_messages(msgs)
    assert n < 3 or (two.any() and not two.all())
    out = run(host_build["sha512_kernels"], "sha512_reduce", n,
              {"words": words.view(np.int32), "two": two.astype(np.int32)},
              [("out", (22, n))], tmp_path)[0]
    assert torch.equal(out, SC.sha512_reduce_plain(torch.from_numpy(words.view(np.int32)),
                                                   torch.from_numpy(two)))
    L = SC.L_INT
    assert [sum(int(x) << (12 * i) for i, x in enumerate(out[:, j])) for j in range(n)] == [
        int.from_bytes(hashlib.sha512(m).digest(), "little") % L for m in msgs]
    top = (1 << 512) - 1
    vals = [0, L - 1, L, 2 * L, top, top // L * L - 1, (2**200) * L - 1][:n]
    vals += [int.from_bytes(hashlib.sha512(m).digest(), "little") for m in msgs[len(vals):]]
    digest = np.stack([np.frombuffer(v.to_bytes(64, "little"), np.uint8) for v in vals])
    red = run(host_build["sha512_kernels"], "reduce512", n, {"digest": digest.view(np.int32)},
              [("out", (22, n))], tmp_path)[0]
    assert [sum(int(x) << (12 * i) for i, x in enumerate(red[:, j])) for j in range(n)] == [
        v % L for v in vals]
    assert torch.equal(red[:, 7:], out[:, 7:])  # the same digests past the edges
