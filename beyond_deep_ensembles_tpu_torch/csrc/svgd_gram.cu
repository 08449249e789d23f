// K2: the SVGD Gram matrix G = X X^T of n particles, X [n, P] fp32 row-major,
// G [n, n] fp32, for n <= 32, as a CUDA kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel beyond_deep_ensembles_tpu/ops/svgd_kernel.py:37
// `_gram_kernel` (launched by `_gram_pallas`), which carries one n x n sum in
// VMEM scratch across a sequential grid over P tiles. Here blocks run in
// parallel and in no order, so the sum is taken in two passes:
//
//   pass 1 (`gram_partial`): the rows are cut into tiles of kTile = 8; block
//     (pair, chunk) takes one pair of row tiles (ta <= tb) and one chunk of
//     columns. Each thread walks its columns of the chunk, loads the pair's
//     8 + 8 values of a column (8 for a diagonal pair) and accumulates the
//     8 x 8 products in fp32 registers. A warp-shuffle tree and a fixed-order
//     sum over the block's 8 warps leave one 8 x 8 partial per block in
//     scratch (`partial`, allocated by the caller);
//   pass 2 (`gram_finish`): one block per element of the lower triangle sums
//     that element's partials over the chunks in a fixed order and writes it
//     to both halves of G.
//
// No atomics: every sum runs in an order fixed by (n, P, chunks), so two runs
// give the same bits. Rows >= n read as 0; columns >= P are never read.
//
// Bound: device memory. The work is 2 n^2 P operations on 4 n P bytes, about
// n / 2 operations per byte (2.5 at n = 5, 10 at n = 20), below the card's
// fp32 rate over its memory rate (about 20), so tensor cores would not help.
// Each element of X is read from device memory once: neighbouring threads
// read neighbouring columns (coalesced), and the blocks of all tile pairs of
// one chunk are adjacent in launch order, so for n > 8, where a row tile is
// read by several pairs, the repeat reads of a chunk come from L2.
//
// C interface for ctypes: `svgd_gram` returns cudaGetLastError() after both
// launches (0 on success); it launches on the given stream and does not
// synchronise.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 8;                 // rows per tile; a thread holds kTile x kTile sums
constexpr int kSlots = kTile * kTile;    // floats per partial
constexpr int kThreads = 256;            // pass 1 block
constexpr int kWarps = kThreads / 32;
constexpr int kFinishThreads = 128;      // pass 2 block
constexpr int kMaxN = 32;
constexpr int kMaxChunks = 65535;        // gridDim.y

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
}

__device__ __forceinline__ int pair_index(int ta, int tb, int tiles) {
  // pairs (ta, tb), ta <= tb, in the order (0,0), (0,1), ..., (0,t-1), (1,1), ...
  return ta * tiles - ta * (ta - 1) / 2 + (tb - ta);
}

__global__ void __launch_bounds__(kThreads)
gram_partial(const float* __restrict__ x, float* __restrict__ partial, int n, long long p,
             long long chunk, int tiles, int pairs) {
  const int pair = blockIdx.x;
  int ta = 0, rest = pair;
  while (rest >= tiles - ta) {
    rest -= tiles - ta;
    ++ta;
  }
  const int tb = ta + rest;
  const bool diagonal = ta == tb;
  const long long begin = static_cast<long long>(blockIdx.y) * chunk;
  const long long end = begin + chunk < p ? begin + chunk : p;

  float acc[kTile][kTile];
#pragma unroll
  for (int u = 0; u < kTile; ++u)
#pragma unroll
    for (int v = 0; v < kTile; ++v) acc[u][v] = 0.f;

  for (long long col = begin + threadIdx.x; col < end; col += kThreads) {
    float a[kTile], b[kTile];
#pragma unroll
    for (int u = 0; u < kTile; ++u) {
      const int row = ta * kTile + u;
      a[u] = row < n ? __ldg(x + static_cast<long long>(row) * p + col) : 0.f;
    }
    if (diagonal) {
#pragma unroll
      for (int v = 0; v < kTile; ++v) b[v] = a[v];
    } else {
#pragma unroll
      for (int v = 0; v < kTile; ++v) {
        const int row = tb * kTile + v;
        b[v] = row < n ? __ldg(x + static_cast<long long>(row) * p + col) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kTile; ++u)
#pragma unroll
      for (int v = 0; v < kTile; ++v) acc[u][v] = fmaf(a[u], b[v], acc[u][v]);
  }

  __shared__ float warp_sums[kWarps][kSlots];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int u = 0; u < kTile; ++u)
#pragma unroll
    for (int v = 0; v < kTile; ++v) {
      const float s = warp_sum(acc[u][v]);
      if (lane == 0) warp_sums[warp][u * kTile + v] = s;
    }
  __syncthreads();
  if (threadIdx.x < kSlots) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += warp_sums[w][threadIdx.x];
    partial[(static_cast<long long>(blockIdx.y) * pairs + pair) * kSlots + threadIdx.x] = s;
  }
}

__global__ void __launch_bounds__(kFinishThreads)
gram_finish(const float* __restrict__ partial, float* __restrict__ out, int n, int chunks, int tiles,
            int pairs) {
  // block -> (i, j) of the lower triangle, j <= i
  int i = 0;
  while ((i + 1) * (i + 2) / 2 <= static_cast<int>(blockIdx.x)) ++i;
  const int j = blockIdx.x - i * (i + 1) / 2;
  // G[j][i] sits in pair (j / kTile, i / kTile) at slot (j % kTile, i % kTile)
  const int slot = pair_index(j / kTile, i / kTile, tiles) * kSlots + (j % kTile) * kTile + i % kTile;
  float s = 0.f;
  for (int c = threadIdx.x; c < chunks; c += kFinishThreads)
    s += partial[static_cast<long long>(c) * pairs * kSlots + slot];
  s = warp_sum(s);
  __shared__ float warp_sums[kFinishThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int w = 0; w < kFinishThreads / 32; ++w) t += warp_sums[w];
    out[j * n + i] = t;
    out[i * n + j] = t;
  }
}

}  // namespace

extern "C" {

// Floats of scratch `svgd_gram` needs for n rows cut into `chunks` chunks.
long long svgd_gram_scratch_floats(int n, int chunks) {
  const long long tiles = (n + kTile - 1) / kTile;
  return static_cast<long long>(chunks) * (tiles * (tiles + 1) / 2) * kSlots;
}

// G = X X^T. x: [n, p] fp32 contiguous on `device`; out: [n, n] fp32;
// partial: scratch of `scratch_floats` floats (at least
// svgd_gram_scratch_floats(n, chunks)); chunks: column chunks of pass 1.
int svgd_gram(const void* x, int n, long long p, int chunks, void* partial, long long scratch_floats,
              void* out, int device, void* stream) {
  if (n < 1 || n > kMaxN || p < 1 || chunks < 1 || chunks > kMaxChunks ||
      scratch_floats < svgd_gram_scratch_floats(n, chunks))
    return static_cast<int>(cudaErrorInvalidValue);
  int previous = 0;
  cudaError_t err = cudaGetDevice(&previous);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (previous != device && (err = cudaSetDevice(device)) != cudaSuccess) return static_cast<int>(err);
  const int tiles = (n + kTile - 1) / kTile;
  const int pairs = tiles * (tiles + 1) / 2;
  const long long chunk = (p + chunks - 1) / chunks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  gram_partial<<<dim3(pairs, chunks), kThreads, 0, s>>>(static_cast<const float*>(x),
                                                        static_cast<float*>(partial), n, p, chunk,
                                                        tiles, pairs);
  err = cudaGetLastError();
  if (err == cudaSuccess) {
    gram_finish<<<n * (n + 1) / 2, kFinishThreads, 0, s>>>(static_cast<const float*>(partial),
                                                           static_cast<float*>(out), n, chunks,
                                                           tiles, pairs);
    err = cudaGetLastError();
  }
  if (previous != device) cudaSetDevice(previous);
  return static_cast<int>(err);
}

const char* svgd_gram_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
