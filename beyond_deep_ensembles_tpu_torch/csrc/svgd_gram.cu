// K2: the SVGD Gram matrix G = X X^T of n particles, X [n, P] fp32 row-major,
// G [n, n] fp32, for n <= 32, as one CUDA kernel launch for Hopper (sm_90a).
//
// Replaces the TPU kernel beyond_deep_ensembles_tpu/ops/svgd_kernel.py:37
// `_gram_kernel` (launched by `_gram_pallas`), which carries one n x n sum in
// VMEM scratch across a sequential grid over P tiles. Here the blocks run in
// parallel, so the sum is taken in one launch in three steps:
//
//   1. The grid is sized to the card (one block per SM). The columns are
//      cut into tiles of `cols` columns; block b takes the contiguous tiles
//      [tiles * b / blocks, tiles * (b + 1) / blocks). Its threads stage
//      each tile, every row of it, into shared memory with 16-byte cp.async
//      copies in a ring of kSmallStages (n <= 8) or kPairStages tiles, so
//      each element of X leaves device memory once and the copies of the
//      next tiles run under the products of this one.
//   2. The block's warps split the lower triangle of G over the same staged
//      columns, as the caller's plan (pairs, slices) says. For n <= 8 every
//      thread holds all n (n + 1) / 2 sums of the triangle, and the 8 warps
//      take every 8th run of 32 columns. For n > 8
//      the rows are cut into tiles of kTile = 8; warp w takes the tile pair
//      w % pairs (pairs (ta, tb), ta >= tb, in the order (0,0), (1,0),
//      (1,1), (2,0), ...) over every slices-th run of 32 columns, slice
//      w / pairs, and holds 64 sums (36 on a diagonal pair). Rows >= n read a
//      zero row of shared memory.
//   3. Each warp sums its lanes by a shuffle tree; the block adds its warps
//      in slice order and writes its n (n + 1) / 2 partials to scratch,
//      element-major (partial[e * blocks + b]). The last block to finish,
//      found by an atomic ticket after __threadfence(), sums every block's
//      partials in block order (lane l takes blocks l, l + 32, ..., then a
//      shuffle tree) and writes both halves of G. It resets the ticket
//      counter to 0, so the next launch, and the next replay of a CUDA graph
//      that holds this one, finds it at 0.
//
// The ticket only picks which block sums: the order of every sum is fixed by
// (n, P, cols, blocks), so two runs with one launch plan give the same bits.
// The counter is one 32-bit word per device, kept zeroed by the caller
// (ops/svgd_kernel.py). Two launches in flight at once would take each
// other's tickets, so K2 is for one stream at a time: launches on one stream
// run one after the other. Launches on two streams that may overlap, and
// concurrent replays of CUDA graphs that hold a K2 launch, are unsupported.
//
// Bound: device memory. The work is n (n + 1) P fused multiply-adds on 4 n P
// bytes, about n / 2 operations per byte (2.5 at n = 5, 10 at n = 20), below
// the card's fp32 rate over its memory rate (about 20), so tensor cores would
// not help. Rows start at 4 r P bytes, 16-byte aligned only where r P % 4 ==
// 0, so a row's copies start at the 16-byte boundary at or before its first
// column and the row sits in shared memory at that offset (0-3 floats). That
// boundary lies inside X's allocation (allocations are 16-byte aligned); the
// copy that would pass the end of X is cut short (cp.async's source size) and
// zero-filled.
//
// C interface for ctypes: `svgd_gram` returns cudaGetLastError() after the
// launch (0 on success); it launches on the given stream and does not
// synchronise.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxN = 32;
constexpr int kTile = 8;             // rows of a row tile (n > 8)
constexpr int kSmallWarps = 8;       // n <= 8: 8 warps, one pair, 8 slices
constexpr int kMaxWarps = 12;        // n > 8: pairs * ceil(8 / pairs) <= 12
constexpr int kColumnQuantum = 128;  // cols is a multiple of it
constexpr int kSmallStages = 3;      // tiles of the cp.async ring, n <= 8
constexpr int kPairStages = 2;       // n > 8: two wide tiles
constexpr int kMaxDevices = 64;
constexpr int kMaxSmem = 200 * 1024;  // dynamic shared memory a block may ask for (sm_90: 227 KB
                                      // less the static 3 KB)

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
}

__device__ __forceinline__ void cp_async_16(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// wait until at most Pending groups of this thread are in flight
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// row i >= j of the lower triangle at e = i (i + 1) / 2 + j
__device__ __forceinline__ void triangle_entry(int e, int& i, int& j) {
  i = static_cast<int>((sqrtf(8.f * e + 1.f) - 1.f) * 0.5f);
  while (i * (i + 1) / 2 > e) --i;
  while ((i + 1) * (i + 2) / 2 <= e) ++i;
  j = e - i * (i + 1) / 2;
}

struct Plan {
  const float* xa;  // X's address rounded down to 16 bytes
  long long total;  // floats from xa to the end of X
  long long p;
  long long tiles;  // column tiles
  int base;         // X's first float, from xa (0-3)
  int n;
  int cols;         // columns of a tile
  int stride;       // floats of a staged row: cols + 4
};

// Stage tile t of X (all n rows) into `buf`: row r's column c (c0 <= c <
// c0 + cols_here) lands at buf[r * stride + (base + r p) % 4 + c - c0]. The
// thread's first chunk (r0, k0) and its step (dr, dk) over the n x per_row
// chunks are fixed for the launch.
__device__ __forceinline__ void stage_tile(const Plan& s, float* buf, long long t, int r0, int k0, int dr,
                                           int dk, int per_row) {
  const long long c0 = t * s.cols;
  const long long cols_here = s.p - c0 < s.cols ? s.p - c0 : s.cols;
  for (int r = r0, k = k0; r < s.n;) {
    const long long lo = s.base + r * s.p + c0;
    const long long g = (lo & ~3LL) + 4LL * k;
    if (g < lo + cols_here) {
      const long long left = s.total - g;
      cp_async_16(buf + r * s.stride + 4 * k, s.xa + g, left >= 4 ? 16 : static_cast<int>(4 * left));
    }
    r += dr;
    k += dk;
    if (k >= per_row) {
      k -= per_row;
      ++r;
    }
  }
}

// n <= 8: thread q of the block takes columns q, q + 256, ... of the tile and
// holds the N (N + 1) / 2 sums of the triangle.
template <int N>
__device__ __forceinline__ void accumulate_triangle(const float* smem, int stage_off, const int (&row_off)[N],
                                                    int cols_here, float (&acc)[N * (N + 1) / 2]) {
  for (int j = threadIdx.x; j < cols_here; j += blockDim.x) {
    float v[N];
#pragma unroll
    for (int r = 0; r < N; ++r) v[r] = smem[stage_off + row_off[r] + j];
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int k = 0; k <= i; ++k) acc[i * (i + 1) / 2 + k] = fmaf(v[i], v[k], acc[i * (i + 1) / 2 + k]);
  }
}

// n > 8: the warp's lane takes columns q, q + step, ... of the tile for the
// tile pair whose rows sit at offsets oa (tile ta) and ob (tile tb).
__device__ __forceinline__ void accumulate_pair(const float* smem, const int (&oa)[kTile], const int (&ob)[kTile],
                                                bool diagonal, int q, int step, int cols_here,
                                                float (&acc)[kTile * kTile]) {
  if (diagonal) {
    for (int j = q; j < cols_here; j += step) {
      float a[kTile];
#pragma unroll
      for (int u = 0; u < kTile; ++u) a[u] = smem[oa[u] + j];
#pragma unroll
      for (int u = 0; u < kTile; ++u)
#pragma unroll
        for (int v = 0; v <= u; ++v) acc[u * kTile + v] = fmaf(a[u], a[v], acc[u * kTile + v]);
    }
  } else {
    for (int j = q; j < cols_here; j += step) {
      float a[kTile], b[kTile];
#pragma unroll
      for (int u = 0; u < kTile; ++u) a[u] = smem[oa[u] + j];
#pragma unroll
      for (int v = 0; v < kTile; ++v) b[v] = smem[ob[v] + j];
#pragma unroll
      for (int u = 0; u < kTile; ++u)
#pragma unroll
        for (int v = 0; v < kTile; ++v) acc[u * kTile + v] = fmaf(a[u], b[v], acc[u * kTile + v]);
    }
  }
}

// N in 1..8: the triangle in every thread (8 warps); N = 0: tile pairs (n in
// 9..32, pairs * slices warps). A ring of Stages tiles.
template <int N, int Stages>
__global__ void __launch_bounds__(N > 0 ? kSmallWarps * 32 : kMaxWarps * 32, N > 0 ? 2 : 1)
gram_kernel(Plan s, int pairs, int slices, float* __restrict__ partial, unsigned* __restrict__ counter,
            float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float warp_sums[kMaxWarps][kTile * kTile];
  __shared__ bool last;
  const int n = s.n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int stage_floats = n * s.stride;
  const int zero_row = Stages * stage_floats;
  for (int j = threadIdx.x; j < s.stride; j += blockDim.x) smem[zero_row + j] = 0.f;

  const long long first = s.tiles * blockIdx.x / gridDim.x;
  const int count = static_cast<int>(s.tiles * (blockIdx.x + 1) / gridDim.x - first);
  const int per_row = s.cols / 4 + 1;
  const int r0 = threadIdx.x / per_row, k0 = threadIdx.x % per_row;
  const int dr = blockDim.x / per_row, dk = blockDim.x % per_row;
  for (int t = 0; t < Stages - 1; ++t) {
    if (t < count) stage_tile(s, smem + t * stage_floats, first + t, r0, k0, dr, dk, per_row);
    cp_async_commit();
  }

  constexpr int kSums = N > 0 ? N * (N + 1) / 2 : kTile * kTile;
  float acc[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) acc[k] = 0.f;
  // rows of the warp's tile pair (n > 8): ta >= tb
  const int pair = warp % pairs, slice = warp / pairs;
  int ta = 0;
  while ((ta + 1) * (ta + 2) / 2 <= pair) ++ta;
  const int tb = pair - ta * (ta + 1) / 2;
  int row_off[N > 0 ? N : kTile];
#pragma unroll
  for (int r = 0; r < (N > 0 ? N : kTile); ++r) {
    const int row = N > 0 ? r : ta * kTile + r;
    row_off[r] = row < n ? row * s.stride + static_cast<int>((s.base + row * s.p) & 3) : -1;
  }
  int col_off[kTile];
#pragma unroll
  for (int r = 0; r < kTile; ++r) {
    const int row = tb * kTile + r;
    col_off[r] = row < n ? row * s.stride + static_cast<int>((s.base + row * s.p) & 3) : -1;
  }

  for (int i = 0; i < count; ++i) {
    cp_async_wait<Stages - 2>();
    __syncthreads();
    const int next = i + Stages - 1;
    if (next < count) stage_tile(s, smem + (next % Stages) * stage_floats, first + next, r0, k0, dr, dk, per_row);
    cp_async_commit();
    const long long c0 = (first + i) * s.cols;
    const int cols_here = static_cast<int>(s.p - c0 < s.cols ? s.p - c0 : s.cols);
    const int stage_off = (i % Stages) * stage_floats;
    if constexpr (N > 0) {
      accumulate_triangle<N>(smem, stage_off, row_off, cols_here, acc);
    } else {
      int oa[kTile], ob[kTile];
#pragma unroll
      for (int r = 0; r < kTile; ++r) {
        oa[r] = row_off[r] >= 0 ? stage_off + row_off[r] : zero_row;
        ob[r] = col_off[r] >= 0 ? stage_off + col_off[r] : zero_row;
      }
      accumulate_pair(smem, oa, ob, ta == tb, slice * 32 + lane, slices * 32, cols_here, acc);
    }
  }
  cp_async_wait<0>();

  // warp sums, then the block's partials: element e = (i, j), i >= j, is
  // slot (i % 8, j % 8) of pair (i / 8, j / 8), summed over its slices
#pragma unroll
  for (int u = 0; u < (N > 0 ? N : kTile); ++u)
#pragma unroll
    for (int v = 0; v < (N > 0 ? N : kTile); ++v) {
      if (N > 0 ? v > u : (ta == tb && v > u)) continue;
      const float t = warp_sum(acc[N > 0 ? u * (u + 1) / 2 + v : u * kTile + v]);
      if (lane == 0) warp_sums[warp][u * kTile + v] = t;
    }
  __syncthreads();
  const int elements = n * (n + 1) / 2;
  for (int e = threadIdx.x; e < elements; e += blockDim.x) {
    int i, j;
    triangle_entry(e, i, j);
    const int pi = (i / kTile) * (i / kTile + 1) / 2 + j / kTile, slot = (i % kTile) * kTile + j % kTile;
    float t = warp_sums[pi][slot];
    for (int sl = 1; sl < slices; ++sl) t += warp_sums[sl * pairs + pi][slot];
    partial[static_cast<long long>(e) * gridDim.x + blockIdx.x] = t;
  }

  // the last block to finish sums the partials in block order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counter, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int warps = blockDim.x >> 5;
  constexpr int kGroup = 4;  // elements a warp sums at once, for loads in flight
  for (int e0 = warp * kGroup; e0 < elements; e0 += warps * kGroup) {
    float t[kGroup];
#pragma unroll
    for (int q = 0; q < kGroup; ++q) t[q] = 0.f;
#pragma unroll 4
    for (int b = lane; b < static_cast<int>(gridDim.x); b += 32)
#pragma unroll
      for (int q = 0; q < kGroup; ++q)
        if (e0 + q < elements) t[q] += __ldcg(partial + static_cast<long long>(e0 + q) * gridDim.x + b);
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
      const float g = warp_sum(t[q]);
      if (lane == 0 && e0 + q < elements) {
        int i, j;
        triangle_entry(e0 + q, i, j);
        out[i * n + j] = g;
        out[j * n + i] = g;
      }
    }
  }
  if (threadIdx.x == 0) *counter = 0u;
}

using Kernel = void (*)(Plan, int, int, float*, unsigned*, float*);
const Kernel kKernels[9] = {
    gram_kernel<0, kPairStages>,  gram_kernel<1, kSmallStages>, gram_kernel<2, kSmallStages>,
    gram_kernel<3, kSmallStages>, gram_kernel<4, kSmallStages>, gram_kernel<5, kSmallStages>,
    gram_kernel<6, kSmallStages>, gram_kernel<7, kSmallStages>, gram_kernel<8, kSmallStages>};
bool smem_raised[kMaxDevices][9];

}  // namespace

extern "C" {

// G = X X^T in one launch. x: [n, p] fp32 contiguous on `device`, 4-byte
// aligned; out: [n, n] fp32; the launch plan (pairs, slices, cols, tiles,
// blocks) as ops/svgd_kernel.py::launch_plan makes it, checked here only so
// far as it keeps the launch inside its memory; partial: scratch of
// `partial_floats` >= blocks * n (n + 1) / 2 floats; counter: one 32-bit
// word, 0 on entry and left at 0, used by no other launch in flight.
int svgd_gram(const void* x, int n, long long p, int pairs, int slices, int cols, long long tiles, int blocks,
              void* partial, long long partial_floats, void* counter, void* out, int device, void* stream) {
  const int row_tiles = (n + kTile - 1) / kTile;
  const bool warps_ok = n <= kTile ? pairs == 1 && slices == kSmallWarps
                                   : pairs == row_tiles * (row_tiles + 1) / 2 && slices >= 1 &&
                                         pairs * slices <= kMaxWarps;
  if (n < 1 || n > kMaxN || p < 1 || !warps_ok || cols < kColumnQuantum || cols % kColumnQuantum != 0 ||
      tiles != (p + cols - 1) / cols || blocks < 1 || blocks > tiles || device < 0 || device >= kMaxDevices ||
      partial_floats < static_cast<long long>(blocks) * n * (n + 1) / 2 ||
      reinterpret_cast<std::uintptr_t>(x) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int stride = cols + 4;
  const int stages = n > kTile ? kPairStages : kSmallStages;
  const long long smem_bytes = (static_cast<long long>(stages) * n + 1) * stride * sizeof(float);
  if (smem_bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);

  int previous = 0;
  cudaError_t err = cudaGetDevice(&previous);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (previous != device && (err = cudaSetDevice(device)) != cudaSuccess) return static_cast<int>(err);
  const int which = n > kTile ? 0 : n;
  if (!smem_raised[device][which]) {
    err = cudaFuncSetAttribute(kKernels[which], cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    smem_raised[device][which] = err == cudaSuccess;
  }
  if (err == cudaSuccess) {
    const auto addr = reinterpret_cast<std::uintptr_t>(x);
    Plan s;
    s.base = static_cast<int>((addr / 4) % 4);
    s.xa = reinterpret_cast<const float*>(addr - 4 * s.base);
    s.total = s.base + static_cast<long long>(n) * p;
    s.p = p;
    s.tiles = tiles;
    s.n = n;
    s.cols = cols;
    s.stride = stride;
    kKernels[which]<<<blocks, 32 * pairs * slices, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
        s, pairs, slices, static_cast<float*>(partial), static_cast<unsigned*>(counter), static_cast<float*>(out));
    err = cudaGetLastError();
  }
  if (previous != device) cudaSetDevice(previous);
  return static_cast<int>(err);
}

const char* svgd_gram_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
