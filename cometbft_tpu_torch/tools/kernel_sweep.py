#!/usr/bin/env python3
"""Time the ladder and decompress kernels over batch sizes, and count the
instructions of the ladder's loops.

    python3 -m cometbft_tpu_torch.tools.kernel_sweep [--sizes 2560,5120,10240,20480,40960] [--sass]

For each batch size B: `ladder_sub_mul8` and `decompress` on random
points and digits (seeded), mean milliseconds per launch by CUDA events
over back-to-back launches. Time against B says where a kernel stands:
proportional once the card is full (throughput), flat while it is not
(latency). To time a parent commit, run this script in a `git archive`
of it. `--sass` disassembles the built ladder (`cuobjdump -sass`) and prints the
opcode counts of each loop body (a backward branch and its target) and
of the whole kernel. The last line is one JSON object with every number,
the card's name and power limit. Needs one CUDA GPU and nvcc.
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default="2560,5120,10240,20480,40960")
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
    if args.sass:
        cuobjdump = Path(K._nvcc()).parent / "cuobjdump"
        sass = subprocess.run([str(cuobjdump), "-sass", str(K.build_dir() / "curve_kernels.so")],
                              capture_output=True, text=True, check=True).stdout
        result["sass_ladder"] = loop_histograms(sass, "ladder_sub_mul8_kernel")
        for name, h in result["sass_ladder"].items():
            print(f"sass {name}: {h['instructions']} instructions, {h['top']}", flush=True)
    print(result["card"])
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
