// SHA-512 of pre-padded lanes and the reduction of 512-bit values mod L:
// the challenge k = SHA-512(R || A || M) mod L of the device-SHA and delta
// verify routes, as three kernels built from the same device functions.
//
// sha512_blocks_kernel computes cometbft_tpu/ops/sha512.py:131
// sha512_two_blocks (plain XLA, no Pallas): (B, 64) 32-bit big-endian words
// of up to two padded 128-byte blocks (int32 bit patterns, rows 16-byte
// aligned) and a (B,) two-block flag (bool bytes) -> (B, 64) uint8, each
// lane's digest in hashlib's byte order. A lane whose flag is false takes
// the state after block 1.
//
// reduce512_kernel computes cometbft_tpu/ops/scalar.py:131 reduce512 (plain
// XLA): (B, 64) uint8 little-endian 512-bit values -> (22, B) int32
// canonical 12-bit limbs < L, limb-major (limb j of lane l at j * B + l).
// The reference runs Barrett (HAC 14.42) in base 2^12; this kernel runs the
// same algorithm in base 2^32 (k = 8 words, mu = floor(2^512 / L) in 9
// words, HAC's two conditional subtractions at the end). The result is
// canonical, so it equals the reference's bit for bit.
//
// sha512_reduce_kernel computes reduce512(sha512_blocks(words, two)) in one
// launch, the digest kept in registers: (B, 64) words and (B,) flags ->
// (22, B) limbs. It is the one launch of the routes' challenge.
//
// Bound on the H100: operations for the hash (about 46 32-bit integer
// instructions a round, 80 rounds a block, against 64 a clock an SM: 4.5 us
// for 10,240 lanes of two blocks, above the 1 us their 3.3 MB take); bytes
// for reduce512 (152 B a lane, 0.5 us at B = 10,240, against 125 wide
// multiplies a lane); the fused kernel's 345 B a lane take 1.05 us, under
// the hash's operations.
//
// Design. A lane's 160 rounds are one dependent chain, so at most one warp
// a 32 lanes can compress: 320 warps for a 10,240-lane commit, fewer than
// the card's 528 warp schedulers, each warp alone on its scheduler, with no
// other warp to hide its stalls. What sets the time is how many integer
// instructions that one warp issues a round and how densely. One thread a
// lane, one warp a block. The rounds run as a 16-round unrolled body in a
// loop (the rotating names line up every 8 rounds; the message schedule is
// computed in place over a 16-word ring, W[t + 16] right after round t
// reads W[t]): about 1,500 instructions, where a fully unrolled lane is
// about 3,700 (59 KB of code) and ran 1.3x slower. Both blocks' 16-byte
// loads issue at the start, block 2's words kept in registers, so its
// loads are not waited for between the blocks. K[t] is in __constant__
// memory, a broadcast. A schedule warp beside each compressing warp
// (W[t] + K[t] through shared memory, with or without placing the
// compressing warps on distinct schedulers), 64-bit additions as
// multiply-adds on the FMA pipe, a shorter e chain, 8-round bodies and two
// bodies an iteration all ran slower on the H100 (PERF.md, section 6).
// reduce512 runs one lane a thread, 32-thread blocks; the words of L and mu
// are immediates (the Barrett loops are unrolled), so the three zero words of
// L drop out of q3 * L. sha512_reduce runs the same Barrett step on the
// lane's thread after the last round.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int SHA_THREADS = 32;  // one lane a thread, one warp a block
constexpr int CHUNK = 16;        // rounds of the unrolled body
constexpr int REDUCE_THREADS = 32;
constexpr int NLIMBS12 = 22;

__constant__ uint64_t K512[80] = {
    0x428A2F98D728AE22ull, 0x7137449123EF65CDull, 0xB5C0FBCFEC4D3B2Full, 0xE9B5DBA58189DBBCull,
    0x3956C25BF348B538ull, 0x59F111F1B605D019ull, 0x923F82A4AF194F9Bull, 0xAB1C5ED5DA6D8118ull,
    0xD807AA98A3030242ull, 0x12835B0145706FBEull, 0x243185BE4EE4B28Cull, 0x550C7DC3D5FFB4E2ull,
    0x72BE5D74F27B896Full, 0x80DEB1FE3B1696B1ull, 0x9BDC06A725C71235ull, 0xC19BF174CF692694ull,
    0xE49B69C19EF14AD2ull, 0xEFBE4786384F25E3ull, 0x0FC19DC68B8CD5B5ull, 0x240CA1CC77AC9C65ull,
    0x2DE92C6F592B0275ull, 0x4A7484AA6EA6E483ull, 0x5CB0A9DCBD41FBD4ull, 0x76F988DA831153B5ull,
    0x983E5152EE66DFABull, 0xA831C66D2DB43210ull, 0xB00327C898FB213Full, 0xBF597FC7BEEF0EE4ull,
    0xC6E00BF33DA88FC2ull, 0xD5A79147930AA725ull, 0x06CA6351E003826Full, 0x142929670A0E6E70ull,
    0x27B70A8546D22FFCull, 0x2E1B21385C26C926ull, 0x4D2C6DFC5AC42AEDull, 0x53380D139D95B3DFull,
    0x650A73548BAF63DEull, 0x766A0ABB3C77B2A8ull, 0x81C2C92E47EDAEE6ull, 0x92722C851482353Bull,
    0xA2BFE8A14CF10364ull, 0xA81A664BBC423001ull, 0xC24B8B70D0F89791ull, 0xC76C51A30654BE30ull,
    0xD192E819D6EF5218ull, 0xD69906245565A910ull, 0xF40E35855771202Aull, 0x106AA07032BBD1B8ull,
    0x19A4C116B8D2D0C8ull, 0x1E376C085141AB53ull, 0x2748774CDF8EEB99ull, 0x34B0BCB5E19B48A8ull,
    0x391C0CB3C5C95A63ull, 0x4ED8AA4AE3418ACBull, 0x5B9CCA4F7763E373ull, 0x682E6FF3D6B2B8A3ull,
    0x748F82EE5DEFB2FCull, 0x78A5636F43172F60ull, 0x84C87814A1F0AB72ull, 0x8CC702081A6439ECull,
    0x90BEFFFA23631E28ull, 0xA4506CEBDE82BDE9ull, 0xBEF9A3F7B2C67915ull, 0xC67178F2E372532Bull,
    0xCA273ECEEA26619Cull, 0xD186B8C721C0C207ull, 0xEADA7DD6CDE0EB1Eull, 0xF57D4F7FEE6ED178ull,
    0x06F067AA72176FBAull, 0x0A637DC5A2C898A6ull, 0x113F9804BEF90DAEull, 0x1B710B35131C471Bull,
    0x28DB77F523047D84ull, 0x32CAAB7B40C72493ull, 0x3C9EBE0A15C9BEBCull, 0x431D67C49C100D4Cull,
    0x4CC5D4BECB3E42B6ull, 0x597F299CFC657E2Aull, 0x5FCB6FAB3AD6FAECull, 0x6C44198C4A475817ull,
};

__constant__ uint64_t IV512[8] = {
    0x6A09E667F3BCC908ull, 0xBB67AE8584CAA73Bull, 0x3C6EF372FE94F82Bull, 0xA54FF53A5F1D36F1ull,
    0x510E527FADE682D1ull, 0x9B05688C2B3E6C1Full, 0x1F83D9ABFB41BD6Bull, 0x5BE0CD19137E2179ull,
};

// The little-endian 32-bit words of L = 2^252 + 27742317777372353535851937790883648493
// and of mu = floor(2^512 / L). Read only at unrolled (constant) indices, so
// each word is an immediate operand.
__device__ __forceinline__ uint32_t l_word(int i) {
  constexpr uint32_t L_W[8] = {
      0x5CF5D3EDu, 0x5812631Au, 0xA2F79CD6u, 0x14DEF9DEu,
      0x00000000u, 0x00000000u, 0x00000000u, 0x10000000u,
  };
  return L_W[i];
}
__device__ __forceinline__ uint32_t mu_word(int i) {
  constexpr uint32_t MU_W[9] = {
      0x0A2C131Bu, 0xED9CE5A3u, 0x086329A7u, 0x2106215Du, 0xFFFFFFEBu,
      0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0x0000000Fu,
  };
  return MU_W[i];
}

__device__ __forceinline__ uint64_t rotr(uint64_t x, int n) { return (x >> n) | (x << (64 - n)); }
__device__ __forceinline__ uint64_t bsig0(uint64_t a) { return rotr(a, 28) ^ rotr(a, 34) ^ rotr(a, 39); }
__device__ __forceinline__ uint64_t bsig1(uint64_t e) { return rotr(e, 14) ^ rotr(e, 18) ^ rotr(e, 41); }
__device__ __forceinline__ uint64_t ssig0(uint64_t w) { return rotr(w, 1) ^ rotr(w, 8) ^ (w >> 7); }
__device__ __forceinline__ uint64_t ssig1(uint64_t w) { return rotr(w, 19) ^ rotr(w, 61) ^ (w >> 6); }
__device__ __forceinline__ uint64_t ch(uint64_t e, uint64_t f, uint64_t g) { return (e & f) ^ (~e & g); }
__device__ __forceinline__ uint64_t maj(uint64_t a, uint64_t b, uint64_t c) {
  return (a & b) ^ (a & c) ^ (b & c);
}

__device__ __forceinline__ uint32_t bswap32(uint32_t v) {
  return (v >> 24) | ((v >> 8) & 0xFF00u) | ((v << 8) & 0xFF0000u) | (v << 24);
}

// One round (FIPS 180-4, section 6.4.2) with wk = W[t] + K[t]; d and h take
// the new e and a.
__device__ __forceinline__ void sha_round(uint64_t a, uint64_t b, uint64_t c, uint64_t& d,
                                          uint64_t e, uint64_t f, uint64_t g, uint64_t& h,
                                          uint64_t wk) {
  const uint64_t t1 = h + wk + bsig1(e) + ch(e, f, g);
  d += t1;
  h = t1 + bsig0(a) + maj(a, b, c);
}

// CHUNK rounds on the working variables s (a at s[0] on entry and on exit),
// round i taking wk(i). At round i, a is s[(8 - i) & 7]: the names rotate
// instead of the values.
template <typename WK>
__device__ __forceinline__ void rounds(uint64_t s[8], WK wk) {
#pragma unroll
  for (int i = 0; i < CHUNK; ++i) {
    const int o = 16 - i;
    sha_round(s[o & 7], s[(o + 1) & 7], s[(o + 2) & 7], s[(o + 3) & 7], s[(o + 4) & 7],
              s[(o + 5) & 7], s[(o + 6) & 7], s[(o + 7) & 7], wk(i));
  }
}

// The 16 words of one block (8 16-byte loads of a lane's row) as big-endian
// 64-bit values.
__device__ __forceinline__ void block_words(const uint4 v8[8], uint64_t w[16]) {
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    w[2 * q] = ((uint64_t)v8[q].x << 32) | v8[q].y;
    w[2 * q + 1] = ((uint64_t)v8[q].z << 32) | v8[q].w;
  }
}

// The schedule in place over a 16-word ring: w[i] holds W[t] and takes W[t + 16].
__device__ __forceinline__ void schedule_step(uint64_t w[16], int i) {
  w[i] = (w[i] + ssig0(w[(i + 1) & 15])) + (w[(i + 9) & 15] + ssig1(w[(i + 14) & 15]));
}

// CHUNK rounds from round t0 on s with the message words in the ring w
// (w[i] holds W[t0 + i]); with kSchedule, w[i] then takes W[t0 + i + 16].
template <bool kSchedule>
__device__ __forceinline__ void chunk(uint64_t s[8], uint64_t w[16], int t0) {
  rounds(s, [&](int i) {
    const uint64_t wk = w[i] + K512[t0 + i];
    if (kSchedule) schedule_step(w, i);
    return wk;
  });
}

// The hash of this thread's lane, schedule and rounds on the one thread.
__device__ __forceinline__ void sha512_lane(const uint32_t* __restrict__ words,
                                            const uint8_t* __restrict__ two_flags,
                                            int64_t lane, uint64_t st[8]) {
  const uint4* row = reinterpret_cast<const uint4*>(words + lane * 64);
  uint4 cur[8], nxt[8];  // both blocks' loads issued at once, block 2's kept in registers
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    cur[q] = row[q];
    nxt[q] = row[8 + q];
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) st[i] = IV512[i];
  const int nblocks = two_flags[lane] ? 2 : 1;
#pragma unroll 1
  for (int blk = 0; blk < nblocks; ++blk) {
    uint64_t w[16], s[8];
    block_words(cur, w);
#pragma unroll
    for (int q = 0; q < 8; ++q) cur[q] = nxt[q];
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i] = st[i];
#pragma unroll 1
    for (int t = 0; t < 64; t += CHUNK) chunk<true>(s, w, t);
    chunk<false>(s, w, 64);
#pragma unroll
    for (int i = 0; i < 8; ++i) st[i] += s[i];
  }
}

// x (16 little-endian 32-bit words of a 512-bit value) mod L -> (22, batch)
// 12-bit limbs of lane `lane`, by Barrett in base b = 2^32.
__device__ __forceinline__ void reduce_store(const uint32_t x[16], int32_t* __restrict__ out,
                                             int64_t lane, int64_t batch) {
  // q2 = floor(x / b^7) * mu (9 x 9 words -> 18)
  uint32_t q2[18];
#pragma unroll
  for (int i = 0; i < 18; ++i) q2[i] = 0;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    uint64_t carry = 0;
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      const uint64_t t = (uint64_t)x[7 + i] * mu_word(j) + q2[i + j] + carry;
      q2[i + j] = (uint32_t)t;
      carry = t >> 32;
    }
    q2[i + 9] = (uint32_t)carry;
  }
  // q3 = floor(q2 / b^9) (words 9..17); r2 = q3 * L mod b^9 (L's zero words drop out)
  uint32_t r2[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) r2[i] = 0;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    uint64_t carry = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (i + j < 9) {
        const uint64_t t = (uint64_t)q2[9 + i] * l_word(j) + r2[i + j] + carry;
        r2[i + j] = (uint32_t)t;
        carry = t >> 32;
      }
    }
    if (i + 8 < 9) r2[i + 8] = (uint32_t)carry;
  }
  // r = (x mod b^9) - r2 mod b^9, which is < 3L (HAC 14.42); then subtract L
  // while r >= L. In base 2^32 the estimate q3 is short by at most one
  // (x mod b^7 contributes under 2^224 / L < 2^-27, frac(2^512 / L) = 0.225),
  // so r < 2L and the second subtraction never fires; HAC's two are kept.
  uint32_t r[10];
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const uint64_t t = (uint64_t)x[i] - r2[i] - borrow;
    r[i] = (uint32_t)t;
    borrow = (t >> 32) & 1;
  }
  r[9] = 0;
#pragma unroll
  for (int round = 0; round < 2; ++round) {
    uint32_t d[9];
    borrow = 0;
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      const uint64_t t = (uint64_t)r[i] - (i < 8 ? l_word(i) : 0u) - borrow;
      d[i] = (uint32_t)t;
      borrow = (t >> 32) & 1;
    }
#pragma unroll
    for (int i = 0; i < 9; ++i) r[i] = borrow ? r[i] : d[i];
  }
  // r < L < 2^253: 22 limbs of 12 bits
#pragma unroll
  for (int j = 0; j < NLIMBS12; ++j) {
    const int bit = 12 * j, w = bit >> 5, sh = bit & 31;
    const uint64_t v = (((uint64_t)r[w + 1] << 32) | r[w]) >> sh;
    out[(int64_t)j * batch + lane] = (int32_t)(v & 0xFFFu);
  }
}

// The digest's words as the little-endian 32-bit words of k's 512 bits
// (hashlib's byte order read little-endian).
__device__ __forceinline__ void digest_words(const uint64_t st[8], uint32_t x[16]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    x[2 * i] = bswap32((uint32_t)(st[i] >> 32));
    x[2 * i + 1] = bswap32((uint32_t)st[i]);
  }
}

__global__ void __launch_bounds__(SHA_THREADS)
    sha512_blocks_kernel(const uint32_t* __restrict__ words, const uint8_t* __restrict__ two,
                         uint32_t* __restrict__ out, int64_t batch) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= batch) return;
  uint64_t st[8];
  sha512_lane(words, two, lane, st);
  uint32_t x[16];
  digest_words(st, x);
  uint4* o = reinterpret_cast<uint4*>(out + lane * 16);
#pragma unroll
  for (int q = 0; q < 4; ++q) o[q] = uint4{x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]};
}

__global__ void __launch_bounds__(SHA_THREADS)
    sha512_reduce_kernel(const uint32_t* __restrict__ words, const uint8_t* __restrict__ two,
                         int32_t* __restrict__ out, int64_t batch) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= batch) return;
  uint64_t st[8];
  sha512_lane(words, two, lane, st);
  uint32_t x[16];
  digest_words(st, x);
  reduce_store(x, out, lane, batch);
}

__global__ void __launch_bounds__(REDUCE_THREADS)
    reduce512_kernel(const uint8_t* __restrict__ digest, int32_t* __restrict__ out,
                     int64_t batch) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= batch) return;
  uint32_t x[16];
  const uint4* row = reinterpret_cast<const uint4*>(digest + lane * 64);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint4 v = row[q];
    x[4 * q] = v.x;
    x[4 * q + 1] = v.y;
    x[4 * q + 2] = v.z;
    x[4 * q + 3] = v.w;
  }
  reduce_store(x, out, lane, batch);
}

unsigned blocks_for(int64_t batch, int threads) {
  return (unsigned)((batch + threads - 1) / threads);
}

}  // namespace

extern "C" int sha512_blocks_launch(const void* words, const void* two, void* out, int64_t batch,
                                    void* stream) {
  sha512_blocks_kernel<<<blocks_for(batch, SHA_THREADS), SHA_THREADS, 0,
                         (cudaStream_t)stream>>>((const uint32_t*)words, (const uint8_t*)two,
                                                 (uint32_t*)out, batch);
  return (int)cudaGetLastError();
}

extern "C" int sha512_reduce_launch(const void* words, const void* two, void* out, int64_t batch,
                                    void* stream) {
  sha512_reduce_kernel<<<blocks_for(batch, SHA_THREADS), SHA_THREADS, 0,
                         (cudaStream_t)stream>>>((const uint32_t*)words, (const uint8_t*)two,
                                                 (int32_t*)out, batch);
  return (int)cudaGetLastError();
}

extern "C" int reduce512_launch(const void* digest, void* out, int64_t batch, void* stream) {
  reduce512_kernel<<<blocks_for(batch, REDUCE_THREADS), REDUCE_THREADS, 0,
                     (cudaStream_t)stream>>>((const uint8_t*)digest, (int32_t*)out, batch);
  return (int)cudaGetLastError();
}
