#!/usr/bin/env python3
"""Measure the card's rate of 32-bit integer multiplies, plain and wide,
and of the kernels' own field products.

    python3 -m cometbft_tpu_torch.tools.int_mul_rate

The kernels' bounds count field products in 32x32->64-bit multiply-adds
(`mad.wide.u32`, SASS `IMAD.WIDE.U32`), priced at the CUDA C++
Programming Guide's rate for 32-bit integer multiply-add on compute
capability 9.0 (64 per clock per SM). The guide does not say whether the
wide form issues at that rate. This script times long unrolled runs of
independent `mad.lo.u32` and `mad.wide.u32` on every SM (enough warps to
hide latency) and prints each rate per clock per SM at the SM clock that
`nvidia-smi` reads during the run, beside the card's name and power
limit. It then times `fe_mul` and `fe_sq` of `csrc/field25519.cuh`
the same way (each thread four chains of dependent products, the card
full), which gives the rate a kernel made of nothing but field products
could reach. The CUDA source is built with nvcc into `build/` at first use.
Needs one CUDA GPU.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

#include "field25519.cuh"

// 8 independent accumulators, UNROLL x 8 multiply-adds per loop trip.
#define UNROLL 16

__global__ void mad_lo(const uint32_t* in, uint32_t* out, int iters) {
  uint32_t a[8], h[8];
  for (int k = 0; k < 8; ++k) { a[k] = in[(threadIdx.x + k) & 255] | 1u; h[k] = a[k] ^ 0x9e37u; }
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int k = 0; k < 8; ++k)
        asm volatile("mad.lo.u32 %0, %1, %2, %0;" : "+r"(h[k]) : "r"(a[k]), "r"(a[(k + u) & 7]));
    }
  }
  uint32_t s = 0;
  for (int k = 0; k < 8; ++k) s ^= h[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__global__ void mad_wide(const uint32_t* in, uint32_t* out, int iters) {
  uint32_t a[8];
  uint64_t h[8];
  for (int k = 0; k < 8; ++k) { a[k] = in[(threadIdx.x + k) & 255] | 1u; h[k] = a[k] ^ 0x9e37u; }
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int k = 0; k < 8; ++k)
        asm volatile("mad.wide.u32 %0, %1, %2, %0;" : "+l"(h[k]) : "r"(a[k]), "r"(a[(k + u) & 7]));
    }
  }
  uint64_t s = 0;
  for (int k = 0; k < 8; ++k) s ^= h[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = (uint32_t)(s ^ (s >> 32));
}

using namespace f25519;

// Four independent chains of field products per thread, FIELD_UNROLL
// products each per loop trip. OP: 0 fe_mul, 1 fe_sq.
#define FIELD_UNROLL 4

template <int OP>
__global__ void field_chain(const uint32_t* in, uint32_t* out, int iters) {
  fe x[4], y;
  for (int c = 0; c < 4; ++c)
    for (int i = 0; i < NL; ++i) x[c].v[i] = (in[(threadIdx.x + i + c) & 255] * 2654435761u) & lmask(i);
  for (int i = 0; i < NL; ++i) y.v[i] = (in[(threadIdx.x + 7 * i) & 255] * 40503u) & lmask(i);
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < FIELD_UNROLL; ++u) {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        x[c] = OP == 1 ? fe_sq(x[c]) : fe_mul(x[c], y);
    }
  }
  uint32_t s = 0;
  for (int c = 0; c < 4; ++c)
    for (int i = 0; i < NL; ++i) s ^= x[c].v[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int launch(int which, const void* in, void* out, int blocks, int threads, int iters,
                      void* stream) {
  const uint32_t* i = (const uint32_t*)in;
  uint32_t* o = (uint32_t*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (which == 0)
    mad_lo<<<blocks, threads, 0, st>>>(i, o, iters);
  else if (which == 1)
    mad_wide<<<blocks, threads, 0, st>>>(i, o, iters);
  else if (which == 2)
    field_chain<0><<<blocks, threads, 0, st>>>(i, o, iters);
  else
    field_chain<1><<<blocks, threads, 0, st>>>(i, o, iters);
  return (int)cudaGetLastError();
}
"""

PER_TRIP = 16 * 8
FIELD_PER_TRIP = 4 * 4
# wide multiplies a product (csrc/field25519.cuh), for the multiply rate
WIDE_PER = {"fe_mul": 100, "fe_sq": 55}


def smi(query: str) -> str:
    res = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0].strip()


def main() -> int:
    import torch

    from cometbft_tpu_torch.ops import kernels as K

    if not torch.cuda.is_available():
        print("int_mul_rate: needs a CUDA GPU", file=sys.stderr)
        return 1
    out_dir = K.BUILD_ROOT / "int_mul_rate"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "int_mul_rate.cu"
    src.write_text(SOURCE)
    lib_path = out_dir / "int_mul_rate.so"
    subprocess.run([K._nvcc(), *K.NVCC_FLAGS, "-I", str(K.CSRC), "-o", str(lib_path), str(src)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.launch.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.launch.restype = ctypes.c_int

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, threads, iters = sms * 8, 256, 4096
    inp = torch.arange(256, dtype=torch.int32, device="cuda")
    out = torch.empty(blocks * threads, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    result = {"card": smi("name,power.limit"), "sms": sms}
    kinds = (("mad.lo.u32", 0, iters, PER_TRIP), ("mad.wide.u32", 1, iters, PER_TRIP),
             ("fe_mul", 2, iters // 64, FIELD_PER_TRIP), ("fe_sq", 3, iters // 64, FIELD_PER_TRIP))
    for name, which, n_iter, per_trip in kinds:
        def run():
            rc = lib.launch(which, inp.data_ptr(), out.data_ptr(), blocks, threads, n_iter, stream)
            if rc:
                raise RuntimeError(f"launch failed: cudaError {rc}")
        run()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        reps = 5
        start.record()
        for _ in range(reps):
            run()
        end.record()
        clock_mhz = float(smi("clocks.sm").split()[0])  # read while the launches run
        end.synchronize()
        ms = start.elapsed_time(end) / reps
        ops = blocks * threads * n_iter * per_trip
        per_s = ops / (ms * 1e-3)
        result[name] = {"ms": ms, "ops_per_s": per_s, "sm_clock_mhz": clock_mhz,
                        "per_sm_per_clock": per_s / (sms * clock_mhz * 1e6)}
        if name in WIDE_PER:
            result[name]["wide_multiplies_per_sm_per_clock"] = (
                result[name]["per_sm_per_clock"] * WIDE_PER[name])
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
