"""The rate of TF32 ``mma.sync.m16n8k8`` on the card: the ceiling of the
float32 kernels that run their products as 3xTF32 ``mma.sync`` (B6's and
B7's backward, B7's ``chunk``), beside the data sheet's TF32 peak (495
TFLOP/s dense), which counts ``wgmma``.

Usage, on a machine with an NVIDIA GPU and the CUDA toolkit::

    python3 scripts/mma_tf32_rate.py

Builds one kernel (``nvcc``, into ``build/mma_tf32_rate/``): each warp
issues ``iters`` rounds of ``acc`` independent m16n8k8 products on register
operands (no memory traffic), 4 blocks an SM; timed by CUDA events over
one launch after one.  Prints one JSON line: TFLOP/s (2,048 FLOP a
product) for 4, 8 and 16 accumulators and 4, 8 and 16 warps a block.
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
template <int NACC>
__global__ void rate(float* out, int iters) {
  float acc[NACC][4] = {};
  const uint32_t a0 = threadIdx.x, a1 = 3u * threadIdx.x, b1 = 11u;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int n = 0; n < NACC; ++n)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, "
          "%3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(acc[n][0]), "+f"(acc[n][1]), "+f"(acc[n][2]), "+f"(acc[n][3])
          : "r"(a0), "r"(a1), "r"(7u), "r"(9u), "r"(threadIdx.x ^ n), "r"(b1));
  }
  float s = 0.0f;
  for (int n = 0; n < NACC; ++n) s += acc[n][0] + acc[n][1] + acc[n][2] + acc[n][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
template <int NACC>
float timed(int blocks, int threads, int iters) {
  float* out;
  cudaMalloc(&out, sizeof(float) * blocks * threads);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  rate<NACC><<<blocks, threads>>>(out, iters);
  cudaEventRecord(e0);
  rate<NACC><<<blocks, threads>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.0f;
  cudaEventElapsedTime(&ms, e0, e1);
  cudaFree(out);
  return ms;
}
extern "C" float run(int nacc, int blocks, int threads, int iters) {
  return nacc == 4 ? timed<4>(blocks, threads, iters)
       : nacc == 8 ? timed<8>(blocks, threads, iters)
                   : timed<16>(blocks, threads, iters);
}
"""


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("mma_tf32_rate: needs an NVIDIA GPU")
    out_dir = Path(__file__).resolve().parents[1] / "build" / "mma_tf32_rate"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib = out_dir / "rate.cu", out_dir / "rate.so"
    src.write_text(SOURCE)
    subprocess.run(["/usr/local/cuda/bin/nvcc", "-O3", "-gencode",
                    "arch=compute_90a,code=sm_90a", "-shared", "-Xcompiler",
                    "-fPIC", "-o", str(lib), str(src)], check=True)
    fn = ctypes.CDLL(str(lib)).run
    fn.restype = ctypes.c_float
    fn.argtypes = [ctypes.c_int] * 4
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    res = {"device": torch.cuda.get_device_name(0), "sms": sms, "cases": []}
    iters = 4096
    for nacc in (4, 8, 16):
        for warps in (4, 8, 16):
            blocks = 4 * sms
            ms = fn(nacc, blocks, 32 * warps, iters)
            n = blocks * warps * iters * nacc
            res["cases"].append(dict(
                acc=nacc, warps=warps, ms=ms,
                tflops=n * 2048 / ms / 1e9))
    print(json.dumps(res))


if __name__ == "__main__":
    main()
