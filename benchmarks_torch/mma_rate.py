#!/usr/bin/env python3
"""What ``mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32`` sustains on one
CUDA card: the ceiling of the dropout-attention kernels' products
(``beyond_deep_ensembles_tpu_torch/csrc/dropout_attention.cu``), which the data
sheet's 495 TFLOP/s (the rate of ``wgmma``) does not give.

    python3 benchmarks_torch/mma_rate.py      # from the repository root

Compiles a kernel with nvcc into ``build/``: every warp runs ``mma.sync`` in a
loop over ``chains`` independent accumulators (1 = each product waits for the
one before it), with 1, 2 or 4 warps per SM sub-core on every SM. Prints the
card's name and power limit, then TFLOP/s and the time per product and warp.
"""
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = os.path.join(ROOT, "build", "mma_rate")
SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
template <int kChains>
__global__ void rate(float* out, int iters) {
  float c[kChains][4];
  for (int j = 0; j < kChains; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
  const uint32_t a0 = threadIdx.x << 13, a1 = a0 + 8192, a2 = a0 + 16384, a3 = a0 + 24576;
  const uint32_t b0 = blockIdx.x << 13, b1 = b0 + 8192;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < kChains; ++j)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
                   "{%8, %9}, {%0, %1, %2, %3};\n"
                   : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
                   : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
  float sum = 0.f;
  for (int j = 0; j < kChains; ++j) sum += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}
extern "C" float run(int chains, int blocks, int threads, int iters, float* out) {
  cudaEvent_t start, stop;
  cudaEventCreate(&start);
  cudaEventCreate(&stop);
  for (int turn = 0; turn < 2; ++turn) {  // the first turn warms up
    cudaEventRecord(start);
    if (chains == 1) rate<1><<<blocks, threads>>>(out, iters);
    else if (chains == 4) rate<4><<<blocks, threads>>>(out, iters);
    else rate<8><<<blocks, threads>>>(out, iters);
    cudaEventRecord(stop);
    cudaEventSynchronize(stop);
  }
  float ms = 0.f;
  cudaEventElapsedTime(&ms, start, stop);
  return cudaGetLastError() == cudaSuccess ? ms : -1.f;
}
"""


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("mma_rate: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    os.makedirs(BUILD, exist_ok=True)
    src, lib_path = os.path.join(BUILD, "mma_rate.cu"), os.path.join(BUILD, "mma_rate.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    nvcc = "nvcc" if subprocess.run(["which", "nvcc"], capture_output=True).returncode == 0 else "/usr/local/cuda/bin/nvcc"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-o", lib_path, src], check=True)
    lib = ctypes.CDLL(lib_path)
    lib.run.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.run.restype = ctypes.c_float
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 1024, device="cuda")
    iters = 20000
    for chains in (1, 4, 8):
        for warps_per_subcore in (1, 2, 4):
            threads = 128 * warps_per_subcore  # one block per SM, its warps dealt over the four sub-cores
            ms = lib.run(chains, sms, threads, iters, out.data_ptr())
            if ms < 0:
                raise RuntimeError("launch failed")
            products = sms * (threads // 32) * iters * chains
            tflops = products * 2 * 16 * 8 * 8 / ms / 1e9
            ns = ms * 1e6 / (iters * chains)
            print(f"{chains} chain(s), {warps_per_subcore} warp(s) per sub-core: {tflops:.1f} TFLOP/s; one warp's "
                  f"product every {ns:.2f} ns")
    return 0


if __name__ == "__main__":
    sys.exit(main())
