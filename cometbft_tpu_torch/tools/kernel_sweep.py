#!/usr/bin/env python3
"""Time the ladder and decompress kernels over batch sizes, time
`accum_weight` over launch shapes, and count the instructions of their
loops.

    python3 -m cometbft_tpu_torch.tools.kernel_sweep [--sizes 2560,5120,10240,20480,40960]
        [--accum-shapes 32x1,64x1,128x1,64x0,64x6] [--sass]

For each batch size B: `ladder_sub_mul8` and `decompress` on random
points and digits (seeded), mean milliseconds per launch by CUDA events
over back-to-back launches. Time against B says where a kernel stands:
proportional once the card is full (throughput), flat while it is not
(latency). To time a parent commit, run this script in a `git archive`
of it.

`accum_weight` at the RLC route's shape (WK = 19,968 bucket lanes, S =
64 rounds, M = 20,481 table points; random table limbs, gather rows and
weights, seeded): `csrc/msm_kernels.cu` is built once per launch shape
TxB of `--accum-shapes`: T threads a block and a `__launch_bounds__`
minimum of B blocks an SM, 0 for none (the one-argument form); the
source's ACCUM_THREADS and bounds rewritten. Each build's registers and
spill come from `ptxas -v`;
its resident threads an SM and waves follow from them; its output must
equal the package build's. The builds are timed in turns, 3 rounds of
20 launches, and the table prints each round's mean milliseconds.

`--sass` disassembles the package's ladder, `accum_weight`,
`sha512_blocks` and `sha512_reduce` (`cuobjdump -sass`) and prints the
opcode counts of each loop body (a backward branch and its target) and
of the whole kernel. (To time another version of
`csrc/sha512_kernels.cu` beside the package's, use `chip_smoke.py
--parent-sha`.) The last line is one JSON object with every number, the
card's name and power limit. Needs one CUDA GPU and nvcc.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import subprocess
import sys
from pathlib import Path


def smi(query: str) -> str:
    res = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0].strip()


def loop_histograms(sass: str, kernel: str) -> dict:
    """Opcode counts of `kernel`'s loop bodies and of the whole function."""
    funcs = re.split(r"\n\s*Function : ", sass)
    body = next(f for f in funcs if f.split("\n", 1)[0].find(kernel) >= 0)
    ins = []
    for ln in body.splitlines():
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", ln)
        if m:
            text = re.sub(r"^@!?U?P\w+\s+", "", m.group(2).strip())
            ins.append((int(m.group(1), 16), text))
    out = {"whole": collections.Counter(t.split()[0] for _, t in ins)}
    for addr, text in ins:
        m = re.match(r"BRA (0x[0-9a-f]+)", text)
        if m and int(m.group(1), 16) < addr:
            lo = int(m.group(1), 16)
            out[f"loop {lo:#x}-{addr:#x}"] = collections.Counter(
                t.split()[0] for a, t in ins if lo <= a <= addr)
    return {k: {"instructions": sum(c.values()), "top": dict(c.most_common(12))}
            for k, c in out.items()}


# Hopper's per-SM limits: 65,536 registers given out to a warp in units
# of 256, 64 warps, 32 blocks
SM_REGISTERS, REG_UNIT, SM_WARPS, SM_BLOCKS = 65536, 256, 64, 32


def resident_threads(threads: int, regs: int) -> int:
    """Threads an SM holds at once of a kernel with `regs` registers a
    thread in blocks of `threads` (no shared memory)."""
    warps = threads // 32
    per_warp = -(-regs * 32 // REG_UNIT) * REG_UNIT
    blocks = min(SM_BLOCKS, SM_WARPS // warps, SM_REGISTERS // (per_warp * warps))
    return blocks * threads


def build_accum_variants(K, shapes, out_dir: Path) -> dict:
    """{shape: (launcher, ptxas usage)}: msm_kernels.cu per launch shape
    "TxB", one nvcc each, all at once."""
    import ctypes

    src = (K.CSRC / "msm_kernels.cu").read_text()
    jobs = {}
    for shape in shapes:
        threads, min_blocks = (int(x) for x in shape.split("x"))
        text, n = re.subn(r"constexpr int ACCUM_THREADS = \d+;",
                          f"constexpr int ACCUM_THREADS = {threads};", src)
        bounds = f"ACCUM_THREADS, {min_blocks}" if min_blocks else "ACCUM_THREADS"
        text, m = re.subn(r"__launch_bounds__\(ACCUM_THREADS, \d+\)",
                          f"__launch_bounds__({bounds})", text)
        if (n, m) != (1, 1):
            raise RuntimeError("msm_kernels.cu has no ACCUM_THREADS / __launch_bounds__ to set")
        variant = out_dir / f"msm_kernels_{shape}.cu"
        out_dir.mkdir(parents=True, exist_ok=True)
        variant.write_text(text)
        jobs[shape] = variant
    K.compile_sources(jobs, out_dir)
    out = {}
    for label in jobs:
        f = ctypes.CDLL(str(out_dir / f"{label}.so")).accum_weight_launch
        f.argtypes = K._SIGNATURES["msm_kernels"]["accum_weight_launch"]
        f.restype = ctypes.c_int
        log = (out_dir / f"{label}.ptxas.txt").read_text()
        out[label] = (f, K.ptxas_usage(log, "accum_weight_kernel"))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default="2560,5120,10240,20480,40960")
    ap.add_argument("--accum-shapes", default="32x1,64x1,128x1,64x0,64x6,64x8,128x3,128x4")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from cometbft_tpu_torch.ops import curve as C
    from cometbft_tpu_torch.ops import kernels as K

    if not torch.cuda.is_available():
        print("kernel_sweep: needs a CUDA GPU", file=sys.stderr)
        return 1
    K.build()
    result = {"card": smi("name,power.limit"), "ptxas": [
        ln.strip() for ln in K.ptxas_report()["curve_kernels"].splitlines()
        if "registers" in ln or "spill" in ln]}
    sizes = [int(x) for x in args.sizes.split(",")]
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    top = max(sizes)

    def digits():
        return torch.from_numpy(rng.integers(-8, 8, (64, top), dtype=np.int32)).to(dev)

    a4 = torch.stack(C.neg(C.fixed_base(digits()))).contiguous()
    r4 = torch.stack(C.fixed_base(digits())).contiguous()
    sd, kd, base = digits(), digits(), C.base_niels(dev)
    encs = torch.from_numpy(rng.integers(0, 256, (top, 32), dtype=np.uint8)).to(dev)
    sign, y = C._split_encoding(encs)

    def ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    for b in sizes:
        lad = [t[..., :b].contiguous() for t in (a4, r4, sd, kd)]
        yb, sb = y[:, :b].contiguous(), sign[None, :b].contiguous()
        result[f"ladder_sub_mul8_ms_B{b}"] = ms(lambda: K.ladder_sub_mul8(*lad, base), 20)
        result[f"decompress_ms_B{b}"] = ms(lambda: K.decompress(yb, sb), 50)
        print(f"B={b}: ladder_sub_mul8 {result[f'ladder_sub_mul8_ms_B{b}']:.4f} ms, "
              f"decompress {result[f'decompress_ms_B{b}']:.4f} ms", flush=True)
    del a4, r4, sd, kd, encs, sign, y
    result["accum_weight"] = sweep_accum(K, args, rng, dev, ms)
    if args.sass:
        cuobjdump = Path(K._nvcc()).parent / "cuobjdump"
        for lib, kernel, key in (("curve_kernels", "ladder_sub_mul8_kernel", "sass_ladder"),
                                 ("msm_kernels", "accum_weight_kernel", "sass_accum_weight"),
                                 ("sha512_kernels", "sha512_blocks_kernel", "sass_sha512_blocks"),
                                 ("sha512_kernels", "sha512_reduce_kernel", "sass_sha512_reduce")):
            sass = subprocess.run([str(cuobjdump), "-sass", str(K.build_dir() / f"{lib}.so")],
                                  capture_output=True, text=True, check=True).stdout
            result[key] = loop_histograms(sass, kernel)
            for name, h in result[key].items():
                print(f"{key} {name}: {h['instructions']} instructions, {h['top']}", flush=True)
    print(result["card"])
    print(json.dumps(result))
    return 0


def sweep_accum(K, args, rng, dev, ms) -> dict:
    """accum_weight at WK = 19,968, S = 64 over the launch shapes of the
    arguments, in turns; prints the table."""
    import numpy as np
    import torch

    lanes, rounds, points = 19_968, 64, 2 * 10_240 + 1
    niels = tuple(torch.from_numpy(rng.integers(0, 4096, (22, points), dtype=np.int32)).to(dev)
                  for _ in range(3))
    idx = torch.from_numpy(rng.integers(0, points, (rounds, lanes), dtype=np.int32)).to(dev)
    neg = torch.from_numpy(rng.integers(0, 2, (rounds, lanes), dtype=np.int32)).to(dev)
    weights = torch.from_numpy(rng.integers(0, 1024, lanes, dtype=np.int32)).to(dev)
    want = K.accum_weight(niels, idx, neg, weights)
    table = torch.stack(niels).permute(2, 0, 1).contiguous()  # as the wrapper lays it out
    shapes = [x for x in args.accum_shapes.split(",") if x]
    variants = build_accum_variants(K, shapes, K.BUILD_ROOT / "sweep" / K.build_dir().name)
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty_like(want)

    def launcher(f):
        def go():
            rc = f(table.data_ptr(), idx.data_ptr(), neg.data_ptr(), weights.data_ptr(),
                   out.data_ptr(), points, rounds, lanes, stream)
            if rc != 0:
                raise RuntimeError(f"accum_weight launch failed: cudaError {rc}")
        return go

    rows = {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, (f, ptx) in variants.items():
        out.fill_(-1)
        launcher(f)()
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise AssertionError(f"accum_weight variant {label} disagrees with the package build")
        row = {"label": label, **ptx, "ms": []}
        row["resident_threads_per_sm"] = resident_threads(int(label.split("x")[0]),
                                                          ptx["registers"])
        row["waves"] = lanes * 4 / (sms * row["resident_threads_per_sm"])  # 4 threads a lane
        rows[label] = row
    for _ in range(3):
        for label, (f, _) in variants.items():
            rows[label]["ms"].append(ms(launcher(f), 20))
    print(f"accum_weight, WK = {lanes}, S = {rounds}, M = {points}: "
          "shape | registers | spill B | threads/SM | waves | ms (3 rounds)")
    for row in rows.values():
        print(f"  {row['label']} | {row.get('registers')} | {row.get('spill_bytes')} | "
              f"{row['resident_threads_per_sm']} | {row['waves']:.3f} | "
              + ", ".join(f"{t:.4f}" for t in row["ms"]), flush=True)
    return rows


if __name__ == "__main__":
    sys.exit(main())
