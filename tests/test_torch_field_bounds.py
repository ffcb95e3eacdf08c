"""The limb bounds of the CUDA field layer (`csrc/field25519.cuh`), walked
with Python ints: no compiler and no card needed.

The kernels compute in ten unsigned limbs of radix 2^25.5 with 32-bit
limbs and 64-bit product columns, and nothing checks for overflow at run
time. These tests read the carry order from the header, derive the
"reduced" bound as the fixed point of every operation that returns a
reduced element, and then run Python models of `fe_mul`, `fe_sq`,
`fe_add`, `fe_sub`, `fe_neg`, `fe_lin` and the carries at the bounds'
extremes: no 32-bit operand or limb and no 64-bit column may overflow,
every result must land inside the reduced bound, and every value must be
right mod p. The last test compiles the header's own functions for the
host (g++) and holds them limb for limb against the models at the same
extremes, so the models' overflow checks hold for the code itself: an
operand or column that wrapped would change the limbs.
"""

import itertools
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

SRC = Path(__file__).resolve().parent.parent / "cometbft_tpu_torch" / "csrc" / "field25519.cuh"
NL = 10
P = 2**255 - 19
W = [26 if i % 2 == 0 else 25 for i in range(NL)]
OFF = [25 * i + (i + 1) // 2 for i in range(NL)]
MASK = [(1 << w) - 1 for w in W]
TWO_P = [2 * ((1 << 26) - 19)] + [2 * MASK[i] for i in range(1, NL)]
U32, U64 = 1 << 32, 1 << 64


def carry_order() -> list[int]:
    src = SRC.read_text()
    stated = re.search(r"// CARRY_ORDER = \{([^}]*)\}", src).group(1)
    order = [int(x) for x in stated.split(",")]
    body = re.search(r"void carry_ref10\(T h\[NL\]\) \{(.*?)\n\}", src, re.S).group(1)
    assert [int(x) for x in re.findall(r"carry_step<(\d+)>\(h\)", body)] == order
    return order


ORDER = carry_order()


def value(limbs) -> int:
    return sum(int(v) << OFF[i] for i, v in enumerate(limbs)) % P


def carry(h, bits):
    """The header's carry_ref10 on `bits`-bit limbs, checking each sum."""
    h = list(h)
    for i in ORDER:
        c = h[i] >> W[i]
        h[i] &= MASK[i]
        if i == NL - 1:
            h[0] += 19 * c
        else:
            h[i + 1] += c
        assert max(h) < 1 << bits, f"carry overflows {bits} bits"
    return h


def carry_bound(hmax, bits):
    """An upper bound of each limb after carry() of limbs <= hmax."""
    h = list(hmax)
    for i in ORDER:
        c = h[i] >> W[i]
        h[i] = min(h[i], MASK[i])
        if i == NL - 1:
            h[0] += 19 * c
        else:
            h[i + 1] += c
        assert max(h) < 1 << bits
    return h


def mul_columns(f, g):
    """fe_mul's operands and 64-bit columns, before the carry."""
    g19 = [19 * x for x in g]
    f2 = [2 * x if i & 1 else x for i, x in enumerate(f)]
    assert max(g19) < U32 and max(f2) < U32
    h = [0] * NL
    for i in range(NL):
        for j in range(NL):
            fi = f2[i] if i & j & 1 else f[i]
            gj = g19[j] if i + j >= NL else g[j]
            h[(i + j) % NL] += fi * gj
            assert h[(i + j) % NL] < U64
    return h


def sq_columns(f):
    """fe_sq's operands and columns: 55 products."""
    f2 = [2 * x for x in f]
    f19 = [19 * x for x in f]
    h = [0] * NL
    n = 0
    for i in range(NL):
        for j in range(i, NL):
            both_odd = i & j & 1
            if i < j:
                fi = 2 * f2[i] if both_odd else f2[i]
            else:
                fi = f2[i] if both_odd else f[i]
            fj = f19[j] if i + j >= NL else f[j]
            assert fi < U32 and fj < U32
            h[(i + j) % NL] += fi * fj
            assert h[(i + j) % NL] < U64
            n += 1
    assert n == 55
    return h


def lin(f, a, g, b, k):
    """fe_lin with signed coefficients: the true limbs must lie in
    [0, 2^32), where the kernel's mod-2^32 arithmetic is exact."""
    h = [a * x + b * y + k * t for x, y, t in zip(f, g, TWO_P)]
    assert min(h) >= 0 and max(h) < U32
    return h


def fe_mul(f, g):
    return carry(mul_columns(f, g), 64)


def fe_sq(f):
    return carry(sq_columns(f), 64)


def fe_add(f, g):
    return carry(lin(f, 1, g, 1, 0), 32)


def fe_sub(f, g):
    return carry(lin(f, 1, g, -1, 1), 32)


def fe_neg(f):
    return carry(lin(f, -1, f, 0, 1), 32)


def reduced_bound():
    """Fixed point: the largest limbs any operation that promises a
    reduced result can return, given reduced inputs (and lazy ones, limb
    <= reduced + 2p, into the products)."""
    r = list(MASK)
    for _ in range(10):
        lazy = [x + t for x, t in zip(r, TWO_P)]
        outs = [
            carry_bound(mul_columns(lazy, lazy), 64),
            carry_bound(sq_columns(lazy), 64),
            carry_bound([2 * x for x in r], 32),  # add
            carry_bound(lazy, 32),  # sub, neg
        ]
        new = [max(col) for col in zip(r, *outs)]
        if new == r:
            return r
        r = new
    raise AssertionError("no fixed point")


R = reduced_bound()
LAZY = [x + t for x, t in zip(R, TWO_P)]


def test_carry_order_is_two_interleaved_chains():
    assert ORDER == [0, 4, 1, 5, 2, 6, 3, 7, 4, 8, 9, 0]


def test_reduced_bound_is_the_documented_one():
    """The header's comment: even limbs < 2^26, odd limbs < 2^25 except
    limbs 1 and 5, which keep under 2^11 of slack; 2p exceeds every limb
    (sub and neg stay non-negative); lazy limbs keep 19x and 4x in 32
    bits and the product columns under 2^62.2."""
    for i in range(NL):
        slack = 1 << 11 if i in (1, 5) else 0
        assert R[i] < (1 << W[i]) + slack, i
        assert TWO_P[i] > R[i]
    assert R[1] >= 1 << 25 and R[5] >= 1 << 25  # the slack is real
    assert 19 * max(LAZY) < U32
    assert 4 * max(LAZY[1::2]) < U32
    assert max(mul_columns(LAZY, LAZY)) < 2**62.2
    assert max(sq_columns(LAZY)) < 2**62.2


def extremes():
    """Reduced elements at the bound's corners: all limbs at the bound,
    all zero, alternating, the bound's limbs with one at zero, p and 2p
    in limbs, and a few random ones."""
    out = [list(R), [0] * NL, [R[i] if i % 2 else 0 for i in range(NL)],
           [0 if i % 2 else R[i] for i in range(NL)]]
    out += [[0 if j == i else R[j] for j in range(NL)] for i in range(NL)]
    p_limbs = [(1 << 26) - 19] + MASK[1:]
    out.append(p_limbs)
    rng = np.random.default_rng(0)
    out += [[int(rng.integers(0, R[i] + 1)) for i in range(NL)] for _ in range(8)]
    return out


def assert_reduced(h):
    assert all(0 <= x <= b for x, b in zip(h, R)), h


@pytest.mark.parametrize("op", ["mul", "sq", "add", "sub", "neg"])
def test_operations_at_the_extremes(op):
    xs = extremes()
    for f, g in itertools.product(xs, xs[:6]):
        if op == "mul":
            h, want = fe_mul(f, g), value(f) * value(g)
        elif op == "sq":
            h, want = fe_sq(f), value(f) ** 2
        elif op == "add":
            h, want = fe_add(f, g), value(f) + value(g)
        elif op == "sub":
            h, want = fe_sub(f, g), value(f) - value(g)
        else:
            h, want = fe_neg(f), -value(f)
        assert_reduced(h)
        assert value(h) == want % P


# fe_lin's coefficients (a, b, k) where the kernels make lazy operands:
# Y - X + 2p and Y + X (grp_add, niels_part), 2Z (niels_part), 2p - X.
LIN_COEFFS = [(1, -1, 1), (1, 1, 0), (2, 0, 0), (-1, 0, 1)]


def lazy_elements():
    """Lazy operands: the sum or difference plus 2p of two reduced
    elements at the extremes, and the lazy bound itself."""
    xs = extremes()
    lazies = [lin(f, 1, g, -1, 1) for f, g in itertools.product(xs[:6], xs[:6])]
    lazies += [lin(f, 1, g, 1, 0) for f, g in itertools.product(xs[:4], xs[:4])]
    lazies.append(list(LAZY))
    return lazies


def test_lazy_products_at_the_extremes():
    """Products of lazy inputs (the sum or difference plus 2p of two
    reduced elements, as grp_add and niels_part feed them) stay exact."""
    lazies = lazy_elements()
    for f in lazies:
        assert all(x <= b for x, b in zip(f, LAZY))
        for g in lazies[:8] + [list(LAZY)]:
            h = fe_mul(f, g)
            assert_reduced(h)
            assert value(h) == value(f) * value(g) % P
        h = fe_sq(f)
        assert_reduced(h)
        assert value(h) == value(f) ** 2 % P


def carry_once(h):
    """The header's carry_once: every limb carries at once."""
    out = [x & m for x, m in zip(h, MASK)]
    for i in range(NL):
        out[(i + 1) % NL] += (19 if i == NL - 1 else 1) * (h[i] >> W[i])
    assert max(out) < U32
    return out


def doubling_lines():
    """grp_dbl's stage-2 lines before their carry_once round,
    c_own * s + c_yy * Y^2 - X^2 + 4p for each thread's coefficients
    (threads 0..3: e, g, f, h) at the extremes, each with its value."""
    xs = extremes()
    coeffs = [(1, -1), (0, 1), (-2, 1), (0, -1)]
    out = []
    for (c_own, c_yy), s, yy, xx in itertools.product(coeffs, xs[:5], xs[:5], xs[:5]):
        m = [c_own * a + c_yy * b - c + 2 * t for a, b, c, t in zip(s, yy, xx, TWO_P)]
        out.append((m, (c_own * value(s) + c_yy * value(yy) - value(xx)) % P))
    return out


def test_doubling_combination_at_the_extremes():
    """grp_dbl's stage-2 line, c_own * s + c_yy * Y^2 - X^2 + 4p, for each
    thread's coefficients, then one carry_once round: non-negative, below
    2^29, and lazy after the round (an operand fe_mul accepts); the
    product of two such lines is reduced and right."""
    worst = [0] * NL
    lines = []
    for m, want in doubling_lines():
        assert min(m) >= 0 and max(m) < 1 << 29
        h = carry_once(m)
        assert all(x <= b for x, b in zip(h, LAZY)), h
        assert value(h) == want
        worst = [max(a, b) for a, b in zip(worst, h)]
        lines.append(h)
    for f, g in [(worst, worst)] + list(zip(lines[::7], lines[3::7])):
        h = fe_mul(f, g)
        assert_reduced(h)
        assert value(h) == value(f) * value(g) % P
    # the interval bound: the largest line, limb by limb, after the round
    top = [R[i] + R[i] + 2 * TWO_P[i] for i in range(NL)]
    once = [m for m in MASK]
    for i in range(NL):
        once[(i + 1) % NL] += (19 if i == NL - 1 else 1) * (top[i] >> W[i])
    assert all(x <= b for x, b in zip(once, LAZY))


SHIM = """
#pragma once
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__
#define __constant__
"""

HOST_MAIN = r"""
#include <cstdio>
#include <cstdlib>
#include <string>
#include <vector>

#include "field25519.cuh"

using namespace f25519;

static std::vector<uint32_t> rd(const std::string& p, size_t n) {
  std::vector<uint32_t> v(n);
  FILE* f = fopen(p.c_str(), "rb");
  if (!f || fread(v.data(), 4, n, f) != n) abort();
  fclose(f);
  return v;
}

// argv: operation, count, and a directory holding f and g (count x 10
// limbs) and c (count x 3 fe_lin coefficients); writes out (count x 10).
int main(int argc, char** argv) {
  const std::string op = argv[1], d = argv[3];
  const size_t n = (size_t)atol(argv[2]);
  const auto f = rd(d + "/f", NL * n), g = rd(d + "/g", NL * n), c = rd(d + "/c", 3 * n);
  std::vector<uint32_t> out(NL * n);
  for (size_t e = 0; e < n; ++e) {
    fe x, y, h;
    for (int i = 0; i < NL; ++i) {
      x.v[i] = f[e * NL + i];
      y.v[i] = g[e * NL + i];
    }
    if (op == "mul") h = fe_mul(x, y);
    else if (op == "sq") h = fe_sq(x);
    else if (op == "add") h = fe_add(x, y);
    else if (op == "sub") h = fe_sub(x, y);
    else if (op == "neg") h = fe_neg(x);
    else if (op == "lin") h = fe_lin(x, c[3 * e], y, c[3 * e + 1], c[3 * e + 2]);
    else if (op == "once") h = carry_once(x);
    else abort();
    for (int i = 0; i < NL; ++i) out[e * NL + i] = h.v[i];
  }
  FILE* o = fopen((d + "/out").c_str(), "wb");
  fwrite(out.data(), 4, out.size(), o);
  fclose(o);
  return 0;
}
"""


@pytest.fixture(scope="module")
def header_exe(tmp_path_factory):
    """field25519.cuh compiled for the host behind a small driver."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the field header for the host")
    out = tmp_path_factory.mktemp("field_host")
    (out / "cuda_runtime.h").write_text(SHIM)
    (out / "main.cpp").write_text(HOST_MAIN)
    exe = out / "field_host"
    subprocess.run([gxx, "-std=c++17", "-O1", "-I", str(out), "-I", str(SRC.parent),
                    "-o", str(exe), str(out / "main.cpp")], check=True, capture_output=True,
                   timeout=300)
    return exe


def run_header(exe, tmp, op, f, g=None, coeffs=None):
    n = len(f)
    np.array(f, np.uint32).tofile(tmp / "f")
    np.array(g if g is not None else f, np.uint32).tofile(tmp / "g")
    np.array(coeffs if coeffs is not None else [(0, 0, 0)] * n, np.int64).astype(
        np.uint32).tofile(tmp / "c")
    subprocess.run([str(exe), op, str(n), str(tmp)], check=True, timeout=60)
    return np.fromfile(tmp / "out", np.uint32).reshape(n, NL).tolist()


def test_header_code_matches_the_models_at_the_extremes(header_exe, tmp_path):
    """fe_mul, fe_sq, fe_add, fe_sub, fe_neg, fe_lin and carry_once of the
    header, on reduced elements at the extremes, lazy operands and the
    doubling's lines, return the models' limbs exactly."""
    xs = extremes()
    f, g = map(list, zip(*itertools.product(xs, xs[:6])))
    lazies = lazy_elements()
    lf, lg = map(list, zip(*itertools.product(lazies, lazies[:8] + [list(LAZY)])))
    lin_cases = [(a, b, c) for a, b in itertools.product(xs[:6], xs[:6]) for c in LIN_COEFFS]
    lines = [m for m, _ in doubling_lines()]
    cases = [
        ("mul", f, g, None, [fe_mul(a, b) for a, b in zip(f, g)]),
        ("mul", lf, lg, None, [fe_mul(a, b) for a, b in zip(lf, lg)]),
        ("sq", xs + lazies, None, None, [fe_sq(a) for a in xs + lazies]),
        ("add", f, g, None, [fe_add(a, b) for a, b in zip(f, g)]),
        ("sub", f, g, None, [fe_sub(a, b) for a, b in zip(f, g)]),
        ("neg", xs, None, None, [fe_neg(a) for a in xs]),
        ("lin", [a for a, _, _ in lin_cases], [b for _, b, _ in lin_cases],
         [c for _, _, c in lin_cases], [lin(a, c[0], b, c[1], c[2]) for a, b, c in lin_cases]),
        ("once", lines, None, None, [carry_once(m) for m in lines]),
    ]
    for op, a, b, c, want in cases:
        assert run_header(header_exe, tmp_path, op, a, b, c) == want, op
