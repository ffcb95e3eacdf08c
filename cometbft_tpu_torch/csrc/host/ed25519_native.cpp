// Copied unchanged from cometbft_tpu/csrc/ed25519_native.cpp, lines
// 1-1336: its Ed25519 half (SHA-512, field, scalars, points, the IFMA and
// multi-buffer SHA-512 includes, the extern "C" entry points through
// ed25519_pack_rsk) and the include of the RLC packer; then the includes
// of the merkle engine and the commit codec (reference lines 1338-1342).
// The secp256k1, sr25519, BLS12-381, Reed-Solomon and G1-MSM engines that
// the reference includes after them are not copied.
// Built with g++ on first use by cometbft_tpu_torch/crypto/native.py.

// Native Ed25519 sign/verify for the host-side control plane.
//
// The data plane (batch verification) runs on TPU (cometbft_tpu/ops);
// this covers the per-signature host path — individual gossiped votes,
// privval signing, p2p handshake identity — where the reference leans
// on curve25519-voi's assembly (reference crypto/ed25519/ed25519.go:13).
//
// Original implementation derived from RFC 8032 + the curve equations:
// - field GF(2^255-19): 5 x 51-bit limbs, products via unsigned __int128
// - points: extended homogeneous (X, Y, Z, T), complete a=-1 addition
// - scalars mod L: 4 x 64-bit words, Barrett-free binary reduction
// - verification uses ZIP-215 semantics: liberal decoding, cofactored
//   equation [8]([S]B - [k]A - R) == identity, S < L required
//
// Exposed as a tiny C ABI consumed via ctypes (no pybind11 in image).

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <thread>
#include <atomic>
#include <vector>
#include <array>
#include <string>
#include <unordered_map>
#include <mutex>
#include <shared_mutex>

typedef unsigned __int128 u128;
typedef uint64_t u64;
typedef uint8_t u8;

// ----------------------------------------------------------- SHA-512 ----
namespace sha512 {

static const u64 K[80] = {
    0x428a2f98d728ae22ULL, 0x7137449123ef65cdULL, 0xb5c0fbcfec4d3b2fULL,
    0xe9b5dba58189dbbcULL, 0x3956c25bf348b538ULL, 0x59f111f1b605d019ULL,
    0x923f82a4af194f9bULL, 0xab1c5ed5da6d8118ULL, 0xd807aa98a3030242ULL,
    0x12835b0145706fbeULL, 0x243185be4ee4b28cULL, 0x550c7dc3d5ffb4e2ULL,
    0x72be5d74f27b896fULL, 0x80deb1fe3b1696b1ULL, 0x9bdc06a725c71235ULL,
    0xc19bf174cf692694ULL, 0xe49b69c19ef14ad2ULL, 0xefbe4786384f25e3ULL,
    0x0fc19dc68b8cd5b5ULL, 0x240ca1cc77ac9c65ULL, 0x2de92c6f592b0275ULL,
    0x4a7484aa6ea6e483ULL, 0x5cb0a9dcbd41fbd4ULL, 0x76f988da831153b5ULL,
    0x983e5152ee66dfabULL, 0xa831c66d2db43210ULL, 0xb00327c898fb213fULL,
    0xbf597fc7beef0ee4ULL, 0xc6e00bf33da88fc2ULL, 0xd5a79147930aa725ULL,
    0x06ca6351e003826fULL, 0x142929670a0e6e70ULL, 0x27b70a8546d22ffcULL,
    0x2e1b21385c26c926ULL, 0x4d2c6dfc5ac42aedULL, 0x53380d139d95b3dfULL,
    0x650a73548baf63deULL, 0x766a0abb3c77b2a8ULL, 0x81c2c92e47edaee6ULL,
    0x92722c851482353bULL, 0xa2bfe8a14cf10364ULL, 0xa81a664bbc423001ULL,
    0xc24b8b70d0f89791ULL, 0xc76c51a30654be30ULL, 0xd192e819d6ef5218ULL,
    0xd69906245565a910ULL, 0xf40e35855771202aULL, 0x106aa07032bbd1b8ULL,
    0x19a4c116b8d2d0c8ULL, 0x1e376c085141ab53ULL, 0x2748774cdf8eeb99ULL,
    0x34b0bcb5e19b48a8ULL, 0x391c0cb3c5c95a63ULL, 0x4ed8aa4ae3418acbULL,
    0x5b9cca4f7763e373ULL, 0x682e6ff3d6b2b8a3ULL, 0x748f82ee5defb2fcULL,
    0x78a5636f43172f60ULL, 0x84c87814a1f0ab72ULL, 0x8cc702081a6439ecULL,
    0x90befffa23631e28ULL, 0xa4506cebde82bde9ULL, 0xbef9a3f7b2c67915ULL,
    0xc67178f2e372532bULL, 0xca273eceea26619cULL, 0xd186b8c721c0c207ULL,
    0xeada7dd6cde0eb1eULL, 0xf57d4f7fee6ed178ULL, 0x06f067aa72176fbaULL,
    0x0a637dc5a2c898a6ULL, 0x113f9804bef90daeULL, 0x1b710b35131c471bULL,
    0x28db77f523047d84ULL, 0x32caab7b40c72493ULL, 0x3c9ebe0a15c9bebcULL,
    0x431d67c49c100d4cULL, 0x4cc5d4becb3e42b6ULL, 0x597f299cfc657e2aULL,
    0x5fcb6fab3ad6faecULL, 0x6c44198c4a475817ULL};

static inline u64 rotr(u64 x, int n) { return (x >> n) | (x << (64 - n)); }

struct Ctx {
    u64 h[8];
    u8 buf[128];
    u64 total;
    size_t fill;
};

static void init(Ctx *c) {
    static const u64 iv[8] = {
        0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL, 0x3c6ef372fe94f82bULL,
        0xa54ff53a5f1d36f1ULL, 0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
        0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL};
    memcpy(c->h, iv, sizeof iv);
    c->total = 0;
    c->fill = 0;
}

static void block(Ctx *c, const u8 *p) {
    u64 w[80];
    for (int i = 0; i < 16; i++) {
        w[i] = ((u64)p[8 * i] << 56) | ((u64)p[8 * i + 1] << 48) |
               ((u64)p[8 * i + 2] << 40) | ((u64)p[8 * i + 3] << 32) |
               ((u64)p[8 * i + 4] << 24) | ((u64)p[8 * i + 5] << 16) |
               ((u64)p[8 * i + 6] << 8) | (u64)p[8 * i + 7];
    }
    for (int i = 16; i < 80; i++) {
        u64 s0 = rotr(w[i - 15], 1) ^ rotr(w[i - 15], 8) ^ (w[i - 15] >> 7);
        u64 s1 = rotr(w[i - 2], 19) ^ rotr(w[i - 2], 61) ^ (w[i - 2] >> 6);
        w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    u64 a = c->h[0], b = c->h[1], d = c->h[3], e = c->h[4];
    u64 cc = c->h[2], f = c->h[5], g = c->h[6], h = c->h[7];
    for (int i = 0; i < 80; i++) {
        u64 S1 = rotr(e, 14) ^ rotr(e, 18) ^ rotr(e, 41);
        u64 ch = (e & f) ^ (~e & g);
        u64 t1 = h + S1 + ch + K[i] + w[i];
        u64 S0 = rotr(a, 28) ^ rotr(a, 34) ^ rotr(a, 39);
        u64 maj = (a & b) ^ (a & cc) ^ (b & cc);
        u64 t2 = S0 + maj;
        h = g; g = f; f = e; e = d + t1;
        d = cc; cc = b; b = a; a = t1 + t2;
    }
    c->h[0] += a; c->h[1] += b; c->h[2] += cc; c->h[3] += d;
    c->h[4] += e; c->h[5] += f; c->h[6] += g; c->h[7] += h;
}

static void update(Ctx *c, const u8 *data, size_t len) {
    c->total += len;
    while (len) {
        size_t take = 128 - c->fill;
        if (take > len) take = len;
        memcpy(c->buf + c->fill, data, take);
        c->fill += take;
        data += take;
        len -= take;
        if (c->fill == 128) {
            block(c, c->buf);
            c->fill = 0;
        }
    }
}

static void final(Ctx *c, u8 out[64]) {
    u64 bits = c->total * 8;
    u8 pad = 0x80;
    update(c, &pad, 1);
    u8 z = 0;
    while (c->fill != 112) update(c, &z, 1);
    u8 lenb[16] = {0};
    for (int i = 0; i < 8; i++) lenb[15 - i] = (u8)(bits >> (8 * i));
    c->total -= 0;  // length bytes excluded from message length already counted
    // careful: update() counts these 16 bytes into total, harmless (total unused after)
    update(c, lenb, 16);
    for (int i = 0; i < 8; i++)
        for (int j = 0; j < 8; j++) out[8 * i + j] = (u8)(c->h[i] >> (56 - 8 * j));
}

static void hash(const u8 *a, size_t an, const u8 *b, size_t bn,
                 const u8 *d, size_t dn, u8 out[64]) {
    Ctx c;
    init(&c);
    if (an) update(&c, a, an);
    if (bn) update(&c, b, bn);
    if (dn) update(&c, d, dn);
    final(&c, out);
}

}  // namespace sha512

// ----------------------------------------------- field GF(2^255-19) ----
namespace fe {

typedef struct { u64 v[5]; } F;  // 51-bit limbs

static const u64 MASK = (1ULL << 51) - 1;

static void set0(F *o) { memset(o->v, 0, sizeof o->v); }
static void set1(F *o) { set0(o); o->v[0] = 1; }

static void add(F *o, const F *a, const F *b) {
    for (int i = 0; i < 5; i++) o->v[i] = a->v[i] + b->v[i];
}

// o = a - b, with a 4p limbwise bias: b's limbs may be uncarried mul
// outputs (< 2^52), and 4 * (2^51 - 19) > 2^52 keeps every limb
// nonnegative while the value shift (4p) vanishes mod p
static void sub(F *o, const F *a, const F *b) {
    o->v[0] = a->v[0] + 0x7ffffffffffedULL * 4 - b->v[0];
    o->v[1] = a->v[1] + 0x7ffffffffffffULL * 4 - b->v[1];
    o->v[2] = a->v[2] + 0x7ffffffffffffULL * 4 - b->v[2];
    o->v[3] = a->v[3] + 0x7ffffffffffffULL * 4 - b->v[3];
    o->v[4] = a->v[4] + 0x7ffffffffffffULL * 4 - b->v[4];
}

static void carry(F *o) {
    for (int r = 0; r < 3; r++) {
        u64 c = 0;
        for (int i = 0; i < 5; i++) {
            u64 t = o->v[i] + c;
            o->v[i] = t & MASK;
            c = t >> 51;
        }
        o->v[0] += 19 * c;
    }
}

static void mul(F *o, const F *a, const F *b) {
    // fully unrolled 5x51 schoolbook with pre-scaled 19*b wraparounds
    // (donna-style layout; ~3x the looped version under -O2)
    const u64 a0 = a->v[0], a1 = a->v[1], a2 = a->v[2], a3 = a->v[3],
              a4 = a->v[4];
    const u64 b0 = b->v[0], b1 = b->v[1], b2 = b->v[2], b3 = b->v[3],
              b4 = b->v[4];
    const u64 b1_19 = b1 * 19, b2_19 = b2 * 19, b3_19 = b3 * 19,
              b4_19 = b4 * 19;
    u128 t0 = (u128)a0 * b0 + (u128)a1 * b4_19 + (u128)a2 * b3_19 +
              (u128)a3 * b2_19 + (u128)a4 * b1_19;
    u128 t1 = (u128)a0 * b1 + (u128)a1 * b0 + (u128)a2 * b4_19 +
              (u128)a3 * b3_19 + (u128)a4 * b2_19;
    u128 t2 = (u128)a0 * b2 + (u128)a1 * b1 + (u128)a2 * b0 +
              (u128)a3 * b4_19 + (u128)a4 * b3_19;
    u128 t3 = (u128)a0 * b3 + (u128)a1 * b2 + (u128)a2 * b1 +
              (u128)a3 * b0 + (u128)a4 * b4_19;
    u128 t4 = (u128)a0 * b4 + (u128)a1 * b3 + (u128)a2 * b2 +
              (u128)a3 * b1 + (u128)a4 * b0;
    u64 r0, r1, r2, r3, r4;
    u128 c;
    r0 = (u64)t0 & MASK; c = t0 >> 51;
    t1 += c; r1 = (u64)t1 & MASK; c = t1 >> 51;
    t2 += c; r2 = (u64)t2 & MASK; c = t2 >> 51;
    t3 += c; r3 = (u64)t3 & MASK; c = t3 >> 51;
    t4 += c; r4 = (u64)t4 & MASK; c = t4 >> 51;
    // top carry can reach ~2^63 with loose (sub-biased) inputs, so the
    // 19-fold must run in 128-bit and ripple once into limb 1; limbs end
    // < 2^51 + 2^17 — safely inside the next mul's accumulation bound
    u128 fold = c * 19 + r0;
    o->v[0] = (u64)fold & MASK;
    o->v[1] = r1 + (u64)(fold >> 51);
    o->v[2] = r2;
    o->v[3] = r3;
    o->v[4] = r4;
}

static void sq(F *o, const F *a) { mul(o, a, a); }

static void mul_small(F *o, const F *a, u64 s) {
    u128 c = 0;
    for (int i = 0; i < 5; i++) {
        u128 v = (u128)a->v[i] * s + c;
        o->v[i] = (u64)v & MASK;
        c = v >> 51;
    }
    o->v[0] += 19 * (u64)c;
    carry(o);
}

static void freeze(F *o) {
    carry(o);
    // conditional subtract p (possibly twice)
    for (int r = 0; r < 2; r++) {
        u64 t[5];
        t[0] = o->v[0] - 0x7ffffffffffedULL;
        u64 borrow = t[0] >> 63;
        t[0] &= ~(1ULL << 63);
        // do proper borrow chain
        __int128 acc = (__int128)o->v[0] - 0x7ffffffffffedULL;
        u64 res[5];
        res[0] = (u64)acc & MASK;
        acc >>= 51;
        for (int i = 1; i < 5; i++) {
            acc += (__int128)o->v[i] - 0x7ffffffffffffULL;
            res[i] = (u64)acc & MASK;
            acc >>= 51;
        }
        (void)borrow; (void)t;
        if (acc == 0) memcpy(o->v, res, sizeof res);  // o >= p: keep result
    }
}

static void to_bytes(u8 out[32], const F *a) {
    F t = *a;
    freeze(&t);
    u64 limbs[5];
    memcpy(limbs, t.v, sizeof limbs);
    for (int i = 0; i < 32; i++) out[i] = 0;
    int bit = 0;
    for (int l = 0; l < 5; l++) {
        for (int b = 0; b < 51; b++) {
            if (limbs[l] >> b & 1) out[(bit + b) / 8] |= (u8)(1 << ((bit + b) % 8));
        }
        bit += 51;
    }
}

static void from_bytes(F *o, const u8 in[32]) {
    // little-endian, top bit masked by caller if needed
    u64 limbs[5] = {0, 0, 0, 0, 0};
    for (int i = 0; i < 255; i++) {
        if (in[i / 8] >> (i % 8) & 1) limbs[i / 51] |= 1ULL << (i % 51);
    }
    memcpy(o->v, limbs, sizeof limbs);
}

static int is_zero(const F *a) {
    F t = *a;
    freeze(&t);
    u64 acc = 0;
    for (int i = 0; i < 5; i++) acc |= t.v[i];
    return acc == 0;
}

static int eq(const F *a, const F *b) {
    F d;
    sub(&d, a, b);
    carry(&d);
    return is_zero(&d);
}

static int parity(const F *a) {
    F t = *a;
    freeze(&t);
    return (int)(t.v[0] & 1);
}

// a^(2^252 - 3): shared exponent for invert + sqrt
static void pow2523(F *o, const F *a) {
    F x2, x9, x11, x31, t;
    sq(&x2, a);                       // 2
    sq(&t, &x2); sq(&t, &t);          // 8
    mul(&x9, &t, a);                  // 9
    mul(&x11, &x9, &x2);              // 11
    sq(&t, &x11); mul(&x31, &t, &x9); // 2^5-1
    F r = x31;
    for (int i = 0; i < 5; i++) sq(&r, &r);
    mul(&r, &r, &x31);                // 2^10-1
    F r10 = r;
    for (int i = 0; i < 10; i++) sq(&r, &r);
    mul(&r, &r, &r10);                // 2^20-1
    F r20 = r;
    for (int i = 0; i < 20; i++) sq(&r, &r);
    mul(&r, &r, &r20);                // 2^40-1
    for (int i = 0; i < 10; i++) sq(&r, &r);
    mul(&r, &r, &r10);                // 2^50-1
    F r50 = r;
    for (int i = 0; i < 50; i++) sq(&r, &r);
    mul(&r, &r, &r50);                // 2^100-1
    F r100 = r;
    for (int i = 0; i < 100; i++) sq(&r, &r);
    mul(&r, &r, &r100);               // 2^200-1
    for (int i = 0; i < 50; i++) sq(&r, &r);
    mul(&r, &r, &r50);                // 2^250-1
    sq(&r, &r); sq(&r, &r);
    mul(o, &r, a);                    // 2^252-3
}

static void invert(F *o, const F *a) {
    F t;
    pow2523(&t, a);  // a^(2^252-3)
    sq(&t, &t); sq(&t, &t); sq(&t, &t);  // a^(2^255-24)
    F a2, a3;
    sq(&a2, a);
    mul(&a3, &a2, a);
    mul(o, &t, &a3);  // exponent 2^255-24+3 = p-2... (8*(2^252-3)+3)
}

}  // namespace fe

// ------------------------------------------------- scalars mod L ---------
namespace sc {

// L = 2^252 + 27742317777372353535851937790883648493
static const u64 L[4] = {0x5812631a5cf5d3edULL, 0x14def9dea2f79cd6ULL,
                         0, 0x1000000000000000ULL};

// 256-bit big-endian-agnostic helpers over 4x64 LE words
static int cmp(const u64 a[4], const u64 b[4]) {
    for (int i = 3; i >= 0; i--) {
        if (a[i] < b[i]) return -1;
        if (a[i] > b[i]) return 1;
    }
    return 0;
}

static void sub(u64 o[4], const u64 a[4], const u64 b[4]) {
    unsigned char borrow = 0;
    for (int i = 0; i < 4; i++) {
        u128 t = (u128)a[i] - b[i] - borrow;
        o[i] = (u64)t;
        borrow = (t >> 64) ? 1 : 0;
    }
}

// l0 = L - 2^252 (125 bits): 2^252 === -l0 (mod L), the fold constant
static const u64 L0[2] = {0x5812631a5cf5d3edULL, 0x14def9dea2f79cd6ULL};

// r (n+2 words, zeroed by caller) = a (na words) * l0
static void mul_l0(u64 *r, const u64 *a, int na) {
    for (int i = 0; i < na; i++) {
        u128 carry = 0;
        for (int j = 0; j < 2; j++) {
            u128 t = (u128)a[i] * L0[j] + r[i + j] + carry;
            r[i + j] = (u64)t;
            carry = t >> 64;
        }
        for (int k = i + 2; carry; k++) {
            u128 t = (u128)r[k] + carry;
            r[k] = (u64)t;
            carry = t >> 64;
        }
    }
}

// lo = v mod 2^252 (4 words), hi = v >> 252 (nh words, trimmed)
static void split252(const u64 *v, int nv, u64 lo[4], u64 *hi, int *nh) {
    for (int i = 0; i < 4; i++) lo[i] = i < nv ? v[i] : 0;
    lo[3] &= 0x0fffffffffffffffULL;  // 252 = 3*64 + 60
    int n = nv - 3;
    if (n < 0) n = 0;
    for (int i = 0; i < n; i++) {
        u64 low = v[3 + i] >> 60;
        u64 high = (4 + i < nv) ? (v[4 + i] << 4) : 0;
        hi[i] = low | high;
    }
    while (n > 0 && hi[n - 1] == 0) n--;
    *nh = n;
}

// reduce a 512-bit LE value mod L via three signed folds at the 2^252
// boundary: x = hi*2^252 + lo === lo - hi*l0; the negative part rides in
// a second accumulator (A - B), folded symmetrically. ~25 word-muls vs
// the 512-iteration shift-subtract this replaces.
static void reduce512(u64 o[4], const u8 in[64]) {
    u64 A[10] = {0}, B[10] = {0};
    int na = 8, nb = 0;
    for (int i = 0; i < 8; i++)
        for (int j = 0; j < 8; j++) A[i] |= (u64)in[8 * i + j] << (8 * j);
    for (int round = 0; round < 3; round++) {
        u64 loA[4], hiA[7], loB[4], hiB[7];
        int nhA, nhB;
        split252(A, na, loA, hiA, &nhA);
        split252(B, nb, loB, hiB, &nhB);
        // A' = loA + hiB*l0 ; B' = loB + hiA*l0  (A - B preserved mod L)
        u64 pa[10] = {0}, pb[10] = {0};
        mul_l0(pa, hiB, nhB);
        mul_l0(pb, hiA, nhA);
        unsigned char cy = 0;
        for (int i = 0; i < 4; i++) {
            u128 t = (u128)pa[i] + loA[i] + cy;
            pa[i] = (u64)t;
            cy = (unsigned char)(t >> 64);
        }
        for (int i = 4; cy; i++) {
            u128 t = (u128)pa[i] + cy;
            pa[i] = (u64)t;
            cy = (unsigned char)(t >> 64);
        }
        cy = 0;
        for (int i = 0; i < 4; i++) {
            u128 t = (u128)pb[i] + loB[i] + cy;
            pb[i] = (u64)t;
            cy = (unsigned char)(t >> 64);
        }
        for (int i = 4; cy; i++) {
            u128 t = (u128)pb[i] + cy;
            pb[i] = (u64)t;
            cy = (unsigned char)(t >> 64);
        }
        memcpy(A, pa, sizeof A);
        memcpy(B, pb, sizeof B);
        na = nb = 10;
        while (na > 0 && A[na - 1] == 0) na--;
        while (nb > 0 && B[nb - 1] == 0) nb--;
    }
    // both < 2^253 < 2L now: bring under L, then r = (A - B) mod L
    u64 a4[4], b4[4];
    memcpy(a4, A, 32);
    memcpy(b4, B, 32);
    if (cmp(a4, L) >= 0) sub(a4, a4, L);
    if (cmp(b4, L) >= 0) sub(b4, b4, L);
    if (cmp(a4, b4) >= 0) {
        sub(o, a4, b4);
    } else {
        u64 t[4];
        sub(t, b4, a4);   // t = B - A
        sub(o, L, t);     // o = L - t
    }
}

static void from_bytes(u64 o[4], const u8 in[32]) {
    for (int i = 0; i < 4; i++) {
        o[i] = 0;
        for (int j = 0; j < 8; j++) o[i] |= (u64)in[8 * i + j] << (8 * j);
    }
}

static void to_bytes(u8 out[32], const u64 a[4]) {
    for (int i = 0; i < 4; i++)
        for (int j = 0; j < 8; j++) out[8 * i + j] = (u8)(a[i] >> (8 * j));
}

// o = (a*b + c) mod L — schoolbook into 512 bits then reduce
static void muladd(u64 o[4], const u64 a[4], const u64 b[4], const u64 c[4]) {
    u64 wide[8] = {0};
    for (int i = 0; i < 4; i++) {
        u128 carry = 0;
        for (int j = 0; j < 4; j++) {
            u128 t = (u128)a[i] * b[j] + wide[i + j] + carry;
            wide[i + j] = (u64)t;
            carry = t >> 64;
        }
        wide[i + 4] += (u64)carry;
    }
    u128 carry = 0;
    for (int i = 0; i < 4; i++) {
        u128 t = (u128)wide[i] + c[i] + carry;
        wide[i] = (u64)t;
        carry = t >> 64;
    }
    for (int i = 4; i < 8 && carry; i++) {
        u128 t = (u128)wide[i] + carry;
        wide[i] = (u64)t;
        carry = t >> 64;
    }
    u8 bytes[64];
    for (int i = 0; i < 8; i++)
        for (int j = 0; j < 8; j++) bytes[8 * i + j] = (u8)(wide[i] >> (8 * j));
    reduce512(o, bytes);
}

}  // namespace sc

// --------------------------------------------------- curve points --------
namespace ge {

using fe::F;

struct P {
    F x, y, z, t;
};

// d = -121665/121666
static F D, D2, SQRTM1;
static P BASE;
static bool inited = false;

static void identity(P *o) {
    fe::set0(&o->x);
    fe::set1(&o->y);
    fe::set1(&o->z);
    fe::set0(&o->t);
}

static void add(P *o, const P *p, const P *q) {
    F a, b, c, d_, e, f, g, h, t0, t1;
    fe::sub(&t0, &p->y, &p->x); fe::carry(&t0);
    fe::sub(&t1, &q->y, &q->x); fe::carry(&t1);
    fe::mul(&a, &t0, &t1);
    fe::add(&t0, &p->y, &p->x);
    fe::add(&t1, &q->y, &q->x);
    fe::mul(&b, &t0, &t1);
    fe::mul(&c, &p->t, &D2);
    fe::mul(&c, &c, &q->t);
    fe::mul(&d_, &p->z, &q->z);
    fe::add(&d_, &d_, &d_);
    fe::sub(&e, &b, &a); fe::carry(&e);
    fe::sub(&f, &d_, &c); fe::carry(&f);
    fe::add(&g, &d_, &c);
    fe::add(&h, &b, &a);
    fe::mul(&o->x, &e, &f);
    fe::mul(&o->y, &g, &h);
    fe::mul(&o->z, &f, &g);
    fe::mul(&o->t, &e, &h);
}

static void dbl(P *o, const P *p) { add(o, p, p); }

static void neg(P *o, const P *p) {
    F zero;
    fe::set0(&zero);
    fe::sub(&o->x, &zero, &p->x); fe::carry(&o->x);
    o->y = p->y;
    o->z = p->z;
    fe::sub(&o->t, &zero, &p->t); fe::carry(&o->t);
}

// affine niels form (Z = 1): the 7-mul mixed-addition operand
struct Niels {
    F ypx, ymx, t2d;
};

static void madd(P *o, const P *p, const Niels *n) {
    F a, b, c, d_, e, f, g, h, t0;
    fe::sub(&t0, &p->y, &p->x); fe::carry(&t0);
    fe::mul(&a, &t0, &n->ymx);
    fe::add(&t0, &p->y, &p->x);
    fe::mul(&b, &t0, &n->ypx);
    fe::mul(&c, &p->t, &n->t2d);
    fe::add(&d_, &p->z, &p->z);
    fe::sub(&e, &b, &a); fe::carry(&e);
    fe::sub(&f, &d_, &c); fe::carry(&f);
    fe::add(&g, &d_, &c);
    fe::add(&h, &b, &a);
    fe::mul(&o->x, &e, &f);
    fe::mul(&o->y, &g, &h);
    fe::mul(&o->z, &f, &g);
    fe::mul(&o->t, &e, &h);
}

static void msub(P *o, const P *p, const Niels *n) {
    // add of -N: swap (Y+X, Y-X), negate 2dT
    Niels m;
    m.ypx = n->ymx;
    m.ymx = n->ypx;
    F zero;
    fe::set0(&zero);
    fe::sub(&m.t2d, &zero, &n->t2d); fe::carry(&m.t2d);
    madd(o, p, &m);
}

static void to_niels_affine(Niels *o, const P *p) {
    // normalize (one inversion) then cache (Y+X, Y-X, 2dT)
    F zi, x, y, t;
    fe::invert(&zi, &p->z);
    fe::mul(&x, &p->x, &zi);
    fe::mul(&y, &p->y, &zi);
    fe::mul(&t, &x, &y);
    fe::add(&o->ypx, &y, &x);
    fe::sub(&o->ymx, &y, &x); fe::carry(&o->ymx);
    fe::mul(&o->t2d, &t, &D2);
}

// multiples 1..128 of B in affine niels — radix-256 fixed-base madds
// (one-time init; the reference gets this from curve25519-voi's
// precomputed basepoint tables)
static Niels BASE_N[128];

// signed radix-16 digits: value = sum d_i 16^i, d_i in [-8, 8); 64 digits
static void recode16(const u8 s[32], signed char out[64]) {
    int carry = 0;
    for (int i = 0; i < 32; i++) {
        int lo = (s[i] & 15) + carry;
        carry = lo >= 8;
        out[2 * i] = (signed char)(lo - (carry << 4));
        int hi = (s[i] >> 4) + carry;
        carry = hi >= 8;
        out[2 * i + 1] = (signed char)(hi - (carry << 4));
    }
    // inputs < 2^253 (S and k are both < L): nibble 63 <= 1, so the
    // final carry is always 0 — no overflow digit exists
    (void)carry;
}

// signed radix-256 digits: value = sum d_i 256^i, d_i in [-128, 128);
// nw digits (callers size for the scalar range + final carry)
static void recode256(const u8 *s, int nbytes, signed char *out, int nw) {
    int carry = 0;
    for (int i = 0; i < nw; i++) {
        int d = (i < nbytes ? s[i] : 0) + carry;
        carry = d >= 128;
        out[i] = (signed char)(d - (carry << 8));
    }
}

// o = [s]p, 4-bit windows msb-first
static void scalar_mul(P *o, const u8 s[32], const P *p) {
    P table[16];
    identity(&table[0]);
    table[1] = *p;
    for (int i = 2; i < 16; i++) add(&table[i], &table[i - 1], p);
    P r;
    identity(&r);
    for (int i = 31; i >= 0; i--) {
        for (int half = 1; half >= 0; half--) {
            int nib = (s[i] >> (4 * half)) & 15;
            if (!(i == 31 && half == 1)) {
                dbl(&r, &r); dbl(&r, &r); dbl(&r, &r); dbl(&r, &r);
            }
            if (nib) add(&r, &r, &table[nib]);
        }
    }
    *o = r;
}

// ZIP-215 liberal decompression; returns 0 on failure
static int decompress(P *o, const u8 in[32]) {
    u8 yb[32];
    memcpy(yb, in, 32);
    int sign = yb[31] >> 7;
    yb[31] &= 0x7f;
    fe::from_bytes(&o->y, yb);  // NOT checked canonical: ZIP-215 liberal
    F yy, u, v, v3, v7, t0, x, vxx;
    fe::sq(&yy, &o->y);
    F one;
    fe::set1(&one);
    fe::sub(&u, &yy, &one); fe::carry(&u);
    fe::mul(&v, &yy, &D);
    fe::add(&v, &v, &one); fe::carry(&v);
    fe::sq(&v3, &v);
    fe::mul(&v3, &v3, &v);
    fe::sq(&v7, &v3);
    fe::mul(&v7, &v7, &v);
    fe::mul(&t0, &u, &v7);
    fe::pow2523(&t0, &t0);
    fe::mul(&x, &u, &v3);
    fe::mul(&x, &x, &t0);
    fe::sq(&vxx, &x);
    fe::mul(&vxx, &vxx, &v);
    F negu;
    fe::set0(&negu);
    fe::sub(&negu, &negu, &u); fe::carry(&negu);
    if (!fe::eq(&vxx, &u)) {
        if (!fe::eq(&vxx, &negu)) return 0;
        fe::mul(&x, &x, &SQRTM1);
    }
    if (fe::parity(&x) != sign) {
        F zero;
        fe::set0(&zero);
        fe::sub(&x, &zero, &x); fe::carry(&x);
    }
    o->x = x;
    fe::set1(&o->z);
    fe::mul(&o->t, &o->x, &o->y);
    return 1;
}

static void compress(u8 out[32], const P *p) {
    F zi, x, y;
    fe::invert(&zi, &p->z);
    fe::mul(&x, &p->x, &zi);
    fe::mul(&y, &p->y, &zi);
    fe::to_bytes(out, &y);
    out[31] |= (u8)(fe::parity(&x) << 7);
}

static int is_identity(const P *p) {
    return fe::is_zero(&p->x) && fe::eq(&p->y, &p->z);
}

static void init_constants() {
    if (inited) return;
    // d = -121665 * inv(121666)
    F n121665, n121666, inv121666, zero;
    fe::set0(&zero);
    fe::set0(&n121665); n121665.v[0] = 121665;
    fe::set0(&n121666); n121666.v[0] = 121666;
    fe::invert(&inv121666, &n121666);
    F d_;
    fe::mul(&d_, &n121665, &inv121666);
    fe::sub(&D, &zero, &d_); fe::carry(&D);
    fe::add(&D2, &D, &D); fe::carry(&D2);
    // sqrt(-1) = 2^((p-1)/4): compute via pow2523(-1)... use known bytes
    static const u8 sqrtm1_bytes[32] = {
        0xb0, 0xa0, 0x0e, 0x4a, 0x27, 0x1b, 0xee, 0xc4, 0x78, 0xe4, 0x2f,
        0xad, 0x06, 0x18, 0x43, 0x2f, 0xa7, 0xd7, 0xfb, 0x3d, 0x99, 0x00,
        0x4d, 0x2b, 0x0b, 0xdf, 0xc1, 0x4f, 0x80, 0x24, 0x83, 0x2b};
    fe::from_bytes(&SQRTM1, sqrtm1_bytes);
    // base point: y = 4/5
    F four, five, inv5, by;
    fe::set0(&four); four.v[0] = 4;
    fe::set0(&five); five.v[0] = 5;
    fe::invert(&inv5, &five);
    fe::mul(&by, &four, &inv5);
    u8 bb[32];
    fe::to_bytes(bb, &by);  // sign bit 0 => even x
    decompress(&BASE, bb);
    // 1..128 multiples of B as affine niels (one inversion each; ~0.5 ms
    // one-time — per-process, amortized across every verify)
    P cur = BASE;
    to_niels_affine(&BASE_N[0], &cur);
    for (int i = 1; i < 128; i++) {
        add(&cur, &cur, &BASE);
        to_niels_affine(&BASE_N[i], &cur);
    }
    inited = true;
}

// r += [k](-A) + [s]B via a shared Straus double-and-add chain:
// radix-16 for the variable base (8-entry per-call table), radix-256
// for B against the static 128-entry niels table. ~252 dbl + 64 add +
// 32 madd vs ~1100 ops for two independent ladders.
static void straus_sb_ka(P *o, const u8 s[32], const u8 k[32], const P *negA) {
    signed char dk[64], ds[32];
    recode16(k, dk);
    recode256(s, 32, ds, 32);
    P atab[8];  // 1..8 multiples of negA
    atab[0] = *negA;
    for (int i = 1; i < 8; i++) add(&atab[i], &atab[i - 1], negA);
    P r, t;
    identity(&r);
    for (int i = 63; i >= 0; i--) {
        if (i != 63) {
            dbl(&r, &r); dbl(&r, &r); dbl(&r, &r); dbl(&r, &r);
        }
        int d = dk[i];
        if (d > 0) add(&r, &r, &atab[d - 1]);
        else if (d < 0) {
            neg(&t, &atab[-d - 1]);
            add(&r, &r, &t);
        }
        if ((i & 1) == 0) {
            int db = ds[i >> 1];
            if (db > 0) madd(&r, &r, &BASE_N[db - 1]);
            else if (db < 0) msub(&r, &r, &BASE_N[-db - 1]);
        }
    }
    *o = r;
}

}  // namespace ge

// ------------------------------------------- AVX-512 IFMA engine --------
// 4-lane vectorized engine using vpmadd52{l,h}uq — the 52-bit
// multiply-accumulate the instruction set grew for exactly this field.
// Two lane disciplines share one type:
//  - point ops: lanes = the 4 independent field muls inside the unified
//    a=-1 Edwards addition (add-2008-hwcd-3): an add or double is TWO
//    vector muls instead of eight serial ones;
//  - decompression: lanes = 4 independent signatures through the
//    identical sqrt-chain control flow.
// Radix 2^52 (5 limbs, 260 bits): limb positions line up with the
// 52-bit instruction split, and 2^260 === 608 (mod p) folds overflow.
// Compiled only when -march=native enables IFMA (build-on-demand per
// machine, cometbft_tpu/crypto/native.py), with a runtime cpuid check.
#if defined(__AVX512IFMA__) && defined(__AVX512VL__) && defined(__AVX512DQ__)
#define ED25519_HAVE_IFMA 1
#include <immintrin.h>

#include "ed25519_ifma.inc"
#endif  // ED25519_HAVE_IFMA

// Decoded-pubkey cache shared by single and batch verification: commit
// verification re-checks the SAME validator set every height, so the
// sqrt exponentiation per A — roughly a third of the single-verify cost
// — runs once per validator. Decompression is deterministic, so caching
// the negated point by its 32-byte encoding is sound.
static std::unordered_map<std::string, ge::P> g_negA_cache;
static std::shared_mutex g_negA_mtx;

static bool cached_neg_decompress(ge::P *negA, const u8 pub[32]) {
    std::string key((const char *)pub, 32);
    {
        std::shared_lock<std::shared_mutex> rl(g_negA_mtx);
        auto it = g_negA_cache.find(key);
        if (it != g_negA_cache.end()) {
            *negA = it->second;
            return true;
        }
    }
    ge::P A;
    if (!ge::decompress(&A, pub)) return false;
    ge::neg(negA, &A);
    std::unique_lock<std::shared_mutex> wl(g_negA_mtx);
    if (g_negA_cache.size() > 65536) g_negA_cache.clear();
    g_negA_cache.emplace(std::move(key), *negA);
    return true;
}

// 8-way multi-buffer SHA-512 (AVX-512) for batch challenge hashing
#include "sha512_mb.inc"

// ------------------------------------------------------- public ABI ------
extern "C" {

// which engine serves verification: 1 = AVX-512 IFMA vector engine,
// 0 = portable scalar (tests/bench report this)
int ed25519_engine(void) {
#ifdef ED25519_HAVE_IFMA
    if (v4::usable()) return 1;
#endif
    return 0;
}

// Keccak-f[1600] permutation, in place on a 200-byte little-endian
// state — the inner loop of merlin/STROBE transcripts
// (crypto/merlin.py): sr25519 batches pay ~6 permutations per
// signature, and the Python permutation was ~60% of their remaining
// cost after the native MSM. Standard theta/rho+pi/chi/iota rounds;
// lane layout matches the Python reference (lane i = x + 5y).
static inline u64 k_rotl(u64 v, int n) {
    return n ? (v << n) | (v >> (64 - n)) : v;
}

void keccak_f1600(u8 *state) {
    static const u64 RC[24] = {
        0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
        0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
        0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
        0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
        0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
        0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
        0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
        0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL,
    };
    static const int ROT[5][5] = {
        {0, 36, 3, 41, 18}, {1, 44, 10, 45, 2}, {62, 6, 43, 15, 61},
        {28, 55, 25, 21, 56}, {27, 20, 39, 8, 14},
    };
    u64 a[25];
    memcpy(a, state, 200);
    for (int rnd = 0; rnd < 24; rnd++) {
        u64 c[5], d[5], b[25];
        for (int x = 0; x < 5; x++)
            c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
        for (int x = 0; x < 5; x++)
            d[x] = c[(x + 4) % 5] ^ k_rotl(c[(x + 1) % 5], 1);
        for (int i = 0; i < 25; i++) a[i] ^= d[i % 5];
        for (int x = 0; x < 5; x++)
            for (int y = 0; y < 5; y++)
                b[y + 5 * ((2 * x + 3 * y) % 5)] =
                    k_rotl(a[x + 5 * y], ROT[x][y]);
        for (int x = 0; x < 5; x++)
            for (int y = 0; y < 5; y++)
                a[x + 5 * y] = b[x + 5 * y] ^
                    ((~b[(x + 1) % 5 + 5 * y]) & b[(x + 2) % 5 + 5 * y]);
        a[0] ^= RC[rnd];
    }
    memcpy(state, a, 200);
}

// Generic Edwards multi-scalar multiplication RISTRETTO-identity check:
//   sum [k_i] P_i in the identity coset of ristretto255.
// P_i arrive as affine (x, y) 32-byte LE field elements (the caller —
// e.g. the sr25519 ristretto batch, crypto/sr25519.py — has already
// decoded and validated them; negation is the caller's x -> -x).
// Plain Pippenger, window c=8. The identity coset is the 4-torsion
// {(0,1), (0,-1), (+-i, 0)}, i.e. affine x*y == 0 — in extended
// coordinates exactly T == 0 (X*Y = Z*T, Z != 0). An exact-identity
// check would reject ~half of all VALID sr25519 batches: each
// signature equation holds only up to torsion on coset
// representatives (see crypto/sr25519.py _verify_rlc).
// Precondition: xs/ys/scalars each hold n 32-byte elements. n == 0 is
// legal and returns 1: the empty sum IS the identity (a zero-signature
// batch verifies vacuously, matching the Python oracle's behavior).
int edwards_msm_is_identity(u64 n, const u8 *xs, const u8 *ys,
                            const u8 *scalars) {
    ge::init_constants();
    if (n == 0) return 1;  // empty sum is the identity element
    const int C = 8, NBK = (1 << C) - 1, NW = 32;
    std::vector<ge::P> pts(n);
    for (u64 i = 0; i < n; i++) {
        fe::from_bytes(&pts[i].x, xs + i * 32);
        fe::from_bytes(&pts[i].y, ys + i * 32);
        fe::set1(&pts[i].z);
        fe::mul(&pts[i].t, &pts[i].x, &pts[i].y);
    }
    ge::P acc;
    ge::identity(&acc);
    std::vector<ge::P> buckets(NBK);
    for (int w = NW - 1; w >= 0; w--) {
        for (int b = 0; b < NBK; b++) ge::identity(&buckets[b]);
        bool any = false;
        for (u64 i = 0; i < n; i++) {
            int d = scalars[i * 32 + w];
            if (d) {
                ge::add(&buckets[d - 1], &buckets[d - 1], &pts[i]);
                any = true;
            }
        }
        if (w != NW - 1)
            for (int k = 0; k < C; k++) ge::dbl(&acc, &acc);
        if (!any) continue;
        // sum_d d * bucket[d-1] via suffix running sums
        ge::P running, total;
        ge::identity(&running);
        ge::identity(&total);
        for (int b = NBK - 1; b >= 0; b--) {
            ge::add(&running, &running, &buckets[b]);
            ge::add(&total, &total, &running);
        }
        ge::add(&acc, &acc, &total);
    }
    return fe::is_zero(&acc.t);
}

// verify: ZIP-215. Returns 1 valid, 0 invalid.
int ed25519_verify(const u8 *pub, const u8 *msg, u64 msg_len, const u8 *sig) {
#ifdef ED25519_HAVE_IFMA
    if (v4::usable()) return v4::verify_v4(pub, msg, msg_len, sig);
#endif
    ge::init_constants();
    // S < L
    u64 s_words[4];
    sc::from_bytes(s_words, sig + 32);
    if (sc::cmp(s_words, sc::L) >= 0) return 0;
    ge::P negA_c, R;
    if (!cached_neg_decompress(&negA_c, pub)) return 0;
    if (!ge::decompress(&R, sig)) return 0;
    // k = SHA512(R || A || M) mod L
    u8 digest[64];
    sha512::hash(sig, 32, pub, 32, msg, msg_len, digest);
    u64 k[4];
    sc::reduce512(k, digest);
    u8 kb[32];
    sc::to_bytes(kb, k);
    // check [8]([S]B + [k](-A) - R) == identity, one Straus chain
    ge::P negR, acc;
    ge::neg(&negR, &R);
    ge::straus_sb_ka(&acc, sig + 32, kb, &negA_c);
    ge::add(&acc, &acc, &negR);
    ge::dbl(&acc, &acc);
    ge::dbl(&acc, &acc);
    ge::dbl(&acc, &acc);
    return ge::is_identity(&acc);
}

// RLC batch verify (reference crypto/ed25519/ed25519.go:207-240 /
// curve25519-voi BatchVerifier): one Pippenger MSM checks
//   [8]([c]B + sum [z_i](-R_i) + sum [z_i h_i](-A_i)) == identity.
// Returns 1 when the whole batch verifies; 0 on any failure (caller
// falls back to per-signature verification for blame, mirroring
// types/validation.go:304-311). msgs are concatenated; msg_lens[i]
// gives each length.
int ed25519_batch_verify(u64 n, const u8 *pubs, const u8 *msgs,
                         const u64 *msg_lens, const u8 *sigs) {
#ifdef ED25519_HAVE_IFMA
    if (v4::usable()) return v4::batch_verify_v4(n, pubs, msgs, msg_lens, sigs);
#endif
    ge::init_constants();
    if (n == 0) return 0;
    // z seed: OS entropy once per batch, expanded by counter hashing.
    // Fail CLOSED without it: batch soundness rests on the z_i being
    // unpredictable to the signer, and any input-derived fallback is
    // attacker-influenced (fd exhaustion is attacker-reachable). A 0
    // return sends the caller to per-signature verification, which
    // needs no randomness. Read BEFORE the allocations so the failure
    // path leaks nothing.
    u8 seed[32];
    {
        FILE *f = fopen("/dev/urandom", "rb");
        size_t got = f ? fread(seed, 1, 32, f) : 0;
        if (f) fclose(f);
        if (got != 32) return 0;
    }
    const int ZW = 17, MW = 32, NW = 32;  // windows: z, z*h, Horner span
    ge::P *negR = new ge::P[n], *negA = new ge::P[n];
    signed char *zd = new signed char[n * ZW];
    signed char *md = new signed char[n * MW];
    u64 *offsets = new u64[n];
    {
        u64 off = 0;
        for (u64 i = 0; i < n; i++) { offsets[i] = off; off += msg_lens[i]; }
    }
    unsigned nthreads = std::thread::hardware_concurrency();
    if (nthreads == 0) nthreads = 1;
    if (nthreads > 8) nthreads = 8;
    if (n < 64) nthreads = 1;

    // ---- phase 1 (parallel over signatures): decompress, hash, digits;
    // per-thread partial c accumulators merged after join
    std::atomic<int> ok{1};
    std::vector<std::array<u64, 4>> partial_c(nthreads);
    auto sig_worker = [&](unsigned t) {
        u64 lo = n * t / nthreads, hi = n * (t + 1) / nthreads;
        u64 c[4] = {0, 0, 0, 0};
        for (u64 i = lo; i < hi && ok.load(std::memory_order_relaxed); i++) {
            const u8 *pub = pubs + 32 * i, *sig = sigs + 64 * i;
            u64 s_words[4];
            sc::from_bytes(s_words, sig + 32);
            if (sc::cmp(s_words, sc::L) >= 0) { ok.store(0); break; }
            ge::P R;
            if (!cached_neg_decompress(&negA[i], pub)) {
                ok.store(0);
                break;
            }
            if (!ge::decompress(&R, sig)) {
                ok.store(0);
                break;
            }
            ge::neg(&negR[i], &R);
            u8 digest[64];
            sha512::hash(sig, 32, pub, 32, msgs + offsets[i], msg_lens[i],
                         digest);
            u64 h[4], z[4] = {0, 0, 0, 0}, m[4], zero[4] = {0, 0, 0, 0};
            sc::reduce512(h, digest);
            u8 zbuf[64], ctr[8];
            for (int b = 0; b < 8; b++) ctr[b] = (u8)(i >> (8 * b));
            sha512::hash(seed, 32, ctr, 8, nullptr, 0, zbuf);
            zbuf[0] |= 1;  // nonzero
            for (int b = 0; b < 8; b++) z[0] |= (u64)zbuf[b] << (8 * b);
            for (int b = 0; b < 8; b++) z[1] |= (u64)zbuf[8 + b] << (8 * b);
            sc::muladd(m, z, h, zero);     // m = z*h mod L
            sc::muladd(c, z, s_words, c);  // c += z*s mod L
            u8 zb[32] = {0}, mb[32];
            memcpy(zb, zbuf, 16);
            sc::to_bytes(mb, m);
            ge::recode256(zb, 16, &zd[i * ZW], ZW);
            ge::recode256(mb, 32, &md[i * MW], MW);
        }
        memcpy(partial_c[t].data(), c, 32);
    };
    if (nthreads == 1) {
        sig_worker(0);
    } else {
        std::vector<std::thread> ths;
        for (unsigned t = 0; t < nthreads; t++)
            ths.emplace_back(sig_worker, t);
        for (auto &th : ths) th.join();
    }

    int result = 0;
    if (ok.load()) {
        u64 c[4] = {0, 0, 0, 0};
        for (unsigned t = 0; t < nthreads; t++) {
            // c = (c + partial) mod L: both < L, one conditional subtract
            unsigned char cy = 0;
            for (int i = 0; i < 4; i++) {
                u128 s = (u128)c[i] + partial_c[t][i] + cy;
                c[i] = (u64)s;
                cy = (unsigned char)(s >> 64);
            }
            if (cy || sc::cmp(c, sc::L) >= 0) sc::sub(c, c, sc::L);
        }
        // ---- phase 2 (parallel over windows): Pippenger c=8 — scatter
        // into 128 signed buckets, suffix running-sum reduce
        ge::P win_sums[NW];
        bool win_live[NW];
        auto win_worker = [&](unsigned t) {
            ge::P buckets[128];
            bool used[128];
            ge::P tmp;
            for (int w = t; w < NW; w += (int)nthreads) {
                memset(used, 0, sizeof used);
                for (u64 i = 0; i < n; i++) {
                    if (w < ZW && zd[i * ZW + w]) {
                        int d = zd[i * ZW + w];
                        int b = (d > 0 ? d : -d) - 1;
                        ge::P *src = &negR[i];
                        if (!used[b]) {
                            if (d > 0) buckets[b] = *src;
                            else ge::neg(&buckets[b], src);
                            used[b] = true;
                        } else if (d > 0) {
                            ge::add(&buckets[b], &buckets[b], src);
                        } else {
                            ge::neg(&tmp, src);
                            ge::add(&buckets[b], &buckets[b], &tmp);
                        }
                    }
                    if (md[i * MW + w]) {
                        int d = md[i * MW + w];
                        int b = (d > 0 ? d : -d) - 1;
                        ge::P *src = &negA[i];
                        if (!used[b]) {
                            if (d > 0) buckets[b] = *src;
                            else ge::neg(&buckets[b], src);
                            used[b] = true;
                        } else if (d > 0) {
                            ge::add(&buckets[b], &buckets[b], src);
                        } else {
                            ge::neg(&tmp, src);
                            ge::add(&buckets[b], &buckets[b], &tmp);
                        }
                    }
                }
                // sum_b (b+1) * bucket[b] via suffix running sums
                ge::P acc, sum;
                bool acc_live = false, sum_live = false;
                ge::identity(&acc);
                ge::identity(&sum);
                for (int b = 127; b >= 0; b--) {
                    if (used[b]) {
                        if (acc_live) ge::add(&acc, &acc, &buckets[b]);
                        else { acc = buckets[b]; acc_live = true; }
                    }
                    if (acc_live) {
                        if (sum_live) ge::add(&sum, &sum, &acc);
                        else { sum = acc; sum_live = true; }
                    }
                }
                win_sums[w] = sum;
                win_live[w] = sum_live;
            }
        };
        if (nthreads == 1) {
            win_worker(0);
        } else {
            std::vector<std::thread> ths;
            for (unsigned t = 0; t < nthreads; t++)
                ths.emplace_back(win_worker, t);
            for (auto &th : ths) th.join();
        }
        // ---- Horner over windows with the [c]B digits folded in
        signed char cd[NW];
        u8 cb[32];
        sc::to_bytes(cb, c);
        ge::recode256(cb, 32, cd, NW);
        ge::P S;
        ge::identity(&S);
        for (int w = NW - 1; w >= 0; w--) {
            if (w != NW - 1)
                for (int d8 = 0; d8 < 8; d8++) ge::dbl(&S, &S);
            if (win_live[w]) ge::add(&S, &S, &win_sums[w]);
            int db = cd[w];
            if (db > 0) ge::madd(&S, &S, &ge::BASE_N[db - 1]);
            else if (db < 0) ge::msub(&S, &S, &ge::BASE_N[-db - 1]);
        }
        ge::dbl(&S, &S);
        ge::dbl(&S, &S);
        ge::dbl(&S, &S);
        result = ge::is_identity(&S);
    }
    delete[] negR;
    delete[] negA;
    delete[] zd;
    delete[] md;
    delete[] offsets;
    return result;
}

// sign: RFC 8032. seed is 32 bytes; out sig is 64 bytes.
void ed25519_sign(const u8 *seed, const u8 *pub, const u8 *msg, u64 msg_len,
                  u8 *sig_out) {
    ge::init_constants();
    u8 h[64];
    sha512::hash(seed, 32, nullptr, 0, nullptr, 0, h);
    u8 a_clamped[32];
    memcpy(a_clamped, h, 32);
    a_clamped[0] &= 248;
    a_clamped[31] &= 63;
    a_clamped[31] |= 64;
    // r = SHA512(prefix || msg) mod L
    u8 rdig[64];
    sha512::hash(h + 32, 32, msg, msg_len, nullptr, 0, rdig);
    u64 r[4];
    sc::reduce512(r, rdig);
    u8 rb[32];
    sc::to_bytes(rb, r);
    ge::P Rp;
    ge::scalar_mul(&Rp, rb, &ge::BASE);
    u8 Renc[32];
    ge::compress(Renc, &Rp);
    // k = SHA512(R || A || M) mod L
    u8 kdig[64];
    sha512::hash(Renc, 32, pub, 32, msg, msg_len, kdig);
    u64 k[4], a_words[4], s[4];
    sc::reduce512(k, kdig);
    // a mod L (clamped a < 2^255, reduce via 512-bit path)
    u8 a64[64] = {0};
    memcpy(a64, a_clamped, 32);
    sc::reduce512(a_words, a64);
    sc::muladd(s, k, a_words, r);  // s = k*a + r mod L
    memcpy(sig_out, Renc, 32);
    sc::to_bytes(sig_out + 32, s);
}

// pubkey from seed
void ed25519_pubkey(const u8 *seed, u8 *pub_out) {
    ge::init_constants();
    u8 h[64];
    sha512::hash(seed, 32, nullptr, 0, nullptr, 0, h);
    u8 a[32];
    memcpy(a, h, 32);
    a[0] &= 248;
    a[31] &= 63;
    a[31] |= 64;
    ge::P A;
    ge::scalar_mul(&A, a, &ge::BASE);
    ge::compress(pub_out, &A);
}

// sha512 for completeness (host tooling)
void sha512_digest(const u8 *msg, u64 len, u8 *out) {
    sha512::hash(msg, len, nullptr, 0, nullptr, 0, out);
}


// Batch challenge scalars: k_i = SHA-512(R_i || A_i || M_i) mod L,
// written at out + i*out_stride. Eight equal-length preimages at a time
// ride the AVX-512 multi-buffer SHA-512 (csrc/sha512_mb.inc) — the
// scalar hash loop was ~12 ms of every 10k-lane submit on the
// single-core host; commit sign bytes within a batch are uniformly
// sized, so grouping by length almost always fills full groups. The
// strided output serves both the k-blob export (stride 32) and the
// in-place R||S||k wire assembly (stride 96).
static void batch_k_strided(u64 n, const u8 *sigs, const u8 *pubs,
                            const u8 *msgs, const u64 *msg_lens, u8 *out,
                            u64 out_stride) {
    u64 off = 0;
    u64 i = 0;
    bool mb = sha512mb::usable();
    while (i < n) {
        u64 ml = msg_lens[i];
        u64 total = 64 + ml;
        u64 nblocks = (total + 17 + 127) / 128;
        bool group = mb && i + 8 <= n && nblocks <= 8;
        if (group) {
            for (int k = 1; k < 8; k++)
                if (msg_lens[i + k] != ml) { group = false; break; }
        }
        if (group) {
            alignas(64) u8 scratch[8][8 * 128];
            const u8 *ptrs[8];
            u8 digests[8][64];
            u64 o = off;
            for (int k = 0; k < 8; k++) {
                u8 *buf = scratch[k];
                // zero only the padding tail: bytes [0, total) are
                // overwritten by the copies below
                memset(buf + total, 0, nblocks * 128 - total);
                memcpy(buf, sigs + (i + k) * 64, 32);
                memcpy(buf + 32, pubs + (i + k) * 32, 32);
                memcpy(buf + 64, msgs + o, ml);
                buf[total] = 0x80;
                u64 bits = total * 8;
                u8 *lp = buf + nblocks * 128 - 8;
                for (int j = 0; j < 8; j++) lp[j] = (u8)(bits >> (56 - 8 * j));
                ptrs[k] = buf;
                o += ml;
            }
            sha512mb::hash8_padded(ptrs, nblocks, digests);
            for (int k = 0; k < 8; k++) {
                u64 kk[4];
                sc::reduce512(kk, digests[k]);
                sc::to_bytes(out + (i + k) * out_stride, kk);
            }
            i += 8;
            off = o;
        } else {
            u8 digest[64];
            sha512::hash(sigs + i * 64, 32, pubs + i * 32, 32, msgs + off,
                         ml, digest);
            u64 kk[4];
            sc::reduce512(kk, digest);
            sc::to_bytes(out + i * out_stride, kk);
            off += ml;
            i += 1;
        }
    }
}

void ed25519_batch_k(u64 n, const u8 *sigs, const u8 *pubs, const u8 *msgs,
                     const u64 *msg_lens, u8 *out) {
    batch_k_strided(n, sigs, pubs, msgs, msg_lens, out, 32);
}

// Assemble the device wire buffer R||S||k for n lanes directly into the
// caller's (stride 96) numpy array: one call replaces the Python-side
// k-blob round trip plus two numpy copies on the hot submit path
// (crypto/ed25519.py _launch_device).
void ed25519_pack_rsk(u64 n, const u8 *sigs, const u8 *pubs, const u8 *msgs,
                      const u64 *msg_lens, u8 *out_rsk) {
    for (u64 i = 0; i < n; i++) memcpy(out_rsk + i * 96, sigs + i * 64, 64);
    batch_k_strided(n, sigs, pubs, msgs, msg_lens, out_rsk + 64, 96);
}

}  // extern "C"

// RLC/MSM host packer — native port of crypto/rlc.py prepare
// (own extern "C" exports: rlc_pack, rlc_packer_threads)
#include "rlc_packer.inc"

// SHA-256 + RFC-6962 merkle root engine (own extern "C" exports)
#include "merkle_native.inc"

// Columnar Commit wire parser (own extern "C" exports)
#include "commit_codec.inc"
