// K3a and K3b: self-attention with dropout on the probabilities, forward and
// backward, as CUDA kernels for Hopper (sm_90a). Every product runs on the
// tensor cores by warpgroup instructions (wgmma) as split TF32 ("3xTF32") with
// fp32 accumulation, so the results keep fp32 accuracy.
//
// Replaces the TPU kernels beyond_deep_ensembles_tpu/ops/attention.py:84
// `_fwd_kernel` (K3a, launched by `_fwd_call`) and :101 `_bwd_kernel` (K3b,
// launched by `_bwd_call`). Each of those holds one whole (batch, head) panel,
// [L, L] scores included, in VMEM. A Hopper block has at most 227 KB of shared
// memory, so here the panel is cut into tiles of 64 key columns (query rows in
// the dK/dV launch) that a block of 128 rows walks over, and nothing [L,
// L]-shaped is ever stored in device memory (but for the debug output of K3a).
//
// Layout: q, k, v, o, dO, dq, dk, dv are [B, L, H, 64] fp32, contiguous (the
// port's public layout, so no transposes are needed around the kernels); bias
// is [B, L] fp32, 0 for a key that is attended and -1e30 for a padded one;
// lse and delta are [B, H, L] fp32; a given keep mask is uint8 [B, H, L, L].
// Any L >= 1, head dimension 64: in the last tile of a panel, rows beyond L
// are loaded as zeros, key columns beyond L score -inf (probability exactly 0)
// and stores beyond L are left out.
//
// Semantics (those of the JAX kernels): S = Q K^T * scale + bias, P =
// softmax(S) over all keys (the row sum runs over the undropped values),
// dropout on P: an element is kept with its uniform u >= p and then scaled by
// 1 / (1 - p), O = P_drop V. The backward gives dV = P_drop^T dO, dP =
// drop(dO V^T), dS = P * (dP - rowsum(dP * P)), dQ = dS K scale, dK = dS^T Q
// scale. rowsum(dP * P) = rowsum(dO * O) per query row (O = P_drop V), so the
// backward takes it from dO and O (`delta`), as flash attention does.
// Scores are kept in base 2: Q (K in the dK/dV launch) is multiplied by
// scale * log2(e) when it is loaded, the exponentials are ex2.approx, and
// `lse` is the base-2 log-sum-exp of those scores, m + log2(l).
//
// Dropout mask, three modes, each its own instance of the kernels: none (p =
// 0); Philox-4x32-10 keyed by the panel seed `seed + b H + h` (the JAX
// kernel's per-(b, h) seeding) with the counter (col / 8, row), whose four
// words give eight 16-bit uniforms for eight neighbouring columns, so that
// K3b regenerates the mask of K3a bit for bit from (seed, b, h, row, col)
// alone; or a given uint8 keep mask. The seed is a host value, or a key in
// device memory plus a host index (`seed_ptr`, as K1's device seed): each
// block reads the key when it starts and adds it, so a CUDA graph that
// captured the launch draws afresh at every replay once the key has moved,
// as the JAX kernel reads its seed from SMEM.
//
// Split TF32. An fp32 operand x becomes hi = x rounded to TF32 and lo = x -
// hi as the tensor core reads it (`split` has the arithmetic); a product a b
// is three tensor-core products summed in fp32, a_lo b_hi + a_hi b_lo + a_hi
// b_hi; the dropped a_lo b_lo is about 2^-22 of a b. The operand a lane keeps
// for all its tiles (its rows of Q; of dO; of K and V in the dK/dV launch) is
// split once per block and held in registers as wgmma's A fragments; the tile
// that streams past is split once per block and tile, by all threads
// together, into hi and lo operand tiles in shared memory, which wgmma reads
// as B through a descriptor.
//
// Kernels. A block is two warpgroups of 128 threads; warpgroup w owns the
// block's rows 64 w .. 64 w + 63 (16 per warp: lane 4 g + t has rows g and
// g + 8 of its warp's), and both read the same operand tiles, so a tile is
// loaded and split once per 128 rows. wgmma.mma_async.m64nNk8 with A from
// registers (a0 = A[g][t], a1 = A[g + 8][t], a2 = A[g][t + 4], a3 = A[g +
// 8][t + 4] of each k-step of 8), B a K-major tile in the 128-byte swizzle,
// and the accumulator in registers (columns 8 j + 2 t + {0, 1} of every
// n-tile j, rows g and g + 8). A sum over k may run in any order and the
// columns of a product may be dealt to the accumulator in any order; the
// split pass writes the operand tiles in orders chosen such that no
// probability ever leaves the registers (`score_column`, `depth_position`
// and the comments beside them): a lane's accumulator columns of two
// neighbouring n-tiles are four neighbouring keys (one half of a Philox
// call, one uchar4 of a given mask), the accumulator of a score product is the A fragment of the
// product that follows as it stands (a0..a3 = c0, c2, c1, c3), and a lane ends
// with 16 neighbouring floats of each of its output rows. The dK/dV launch
// computes S^T and (dO V^T)^T the same way (A = K or V rows, B = Q or dO
// tiles), so its lanes hold one key and four neighbouring query rows: the
// eight lanes that share t each draw Philox for one (query row, group of
// eight keys) and exchange their 8-bit results by shuffles.
//
// Shared memory and loads: the next raw tiles (K and V; Q and dO in the dK/dV
// launch) arrive by the copy engine (TMA through a tensor map, an mbarrier
// counting the bytes) while the block computes on the operand tiles split
// from the last ones; each tile is read from device memory once per block.
// Bank arithmetic: the engine writes the raw tiles in the 128-byte swizzle,
// so the split pass's float4 reads (8 lanes = 8 neighbouring rows, one chunk)
// fall on 8 different groups of 4 banks (chunk ^ row % 8); its scalar stores
// along a depth row (32 lanes = 32 depth positions of one 128-byte row) hit
// 32 banks; its float4 stores of a score tile (8 lanes = 8 rows of which
// pairs share row % 8 after `score_column`) conflict two ways. No
// probability is stored to shared memory at all.
//   K3a `attn_forward`: a block per (128 query rows, h, b) walks the key tiles
//     with an online softmax (running max m and row sum l, the sum over the
//     undropped exponentials, the kept ones accumulated into O), then writes
//     O / (l (1 - p)) and lse. With `probs` it walks the key tiles a second
//     time and writes the realized P_drop (debug only).
//   K3b, two launches, no atomics, so every sum runs in a fixed order and
//     repeat runs agree bit for bit:
//     `attn_backward_dq`: a block per 128 query rows computes delta for its
//       rows (written out for the next launch), walks the key tiles
//       recomputing S, P and dP, 32 keys at a time, and accumulates dQ;
//     `attn_backward_dkdv`: a block per 128 keys walks the query tiles
//       recomputing S^T, P, dP, 16 query rows at a time, and accumulates dK
//       and dV.
//   The split recomputes S and dO V^T once more than a single pass with an
//   atomic dQ would (14 L^2 D operations per panel instead of 10).
//
// Bound: operations. K3a does 4 B H L^2 D fp32-accurate operations and moves
// 16 B L H D bytes (q, k, v in, o out) plus the bias and lse: at (8, 12, 512,
// 64) 6.44 GFLOP against 50 MB (15 us at 3.35 TB/s); K3b's 10 B H L^2 D is
// 16.1 GFLOP against about 100 MB. On the CUDA cores (67 TFLOP/s) that is 96
// and 240 us; on the unit these kernels use, three TF32 products per
// operation at 495 TFLOP/s, 39 and 98 us.
//
// C interface for ctypes: each function makes the tensor maps of the tensors
// its kernels stream (host work, a few microseconds), launches on the given
// stream, returns the first error (0 on success) and does not synchronise.
#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;                 // head dimension
constexpr int kTile = 64;              // query rows and key columns of a tile
constexpr int kThreads = 256;          // two warpgroups of four warps; a warp owns 16 rows
constexpr int kBlockRows = 128;        // rows of a block: 64 per warpgroup
constexpr int kTileFloats = kTile * kD;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kModeNone = 0, kModePhilox = 1, kModeGiven = 2;

// The mask's parameters; the mode itself is the kernels' template argument.
struct Dropout {
  unsigned long long seed;    // Philox: the step's seed (the panel adds b H + h), or the index added to *seed_ptr
  const long long* seed_ptr;  // Philox: the key in device memory, or null for a host seed
  const uint8_t* keep;        // given: [B, H, L, L]
  float p;                    // drop probability
  float inv_keep;             // 1 / (1 - p)
  uint32_t threshold;         // Philox: a 16-bit value u is kept if u << 16 >= threshold
};

// The Philox seed of this launch: the host value, plus the device key where
// there is one (read once per block, before any mask is drawn).
template <int kMode>
__device__ __forceinline__ void resolve_seed(Dropout& drop) {
  if constexpr (kMode == kModePhilox) {
    if (drop.seed_ptr != nullptr) drop.seed += static_cast<unsigned long long>(__ldg(drop.seed_ptr));
  }
}

__device__ __forceinline__ long long row_offset(int b, int row, int h, int L, int H) {
  return ((static_cast<long long>(b) * L + row) * H + h) * kD;
}

// Philox-4x32-10 (Salmon et al., SC 2011), the generator of curand and Triton.
__device__ __forceinline__ uint4 philox(uint4 ctr, uint2 key) {
  constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u, kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t hi0 = __umulhi(kM0, ctr.x), lo0 = kM0 * ctr.x;
    const uint32_t hi1 = __umulhi(kM1, ctr.z), lo1 = kM1 * ctr.z;
    ctr = make_uint4(hi1 ^ ctr.y ^ key.x, lo1, hi0 ^ ctr.w ^ key.y, lo0);
    key.x += kW0;
    key.y += kW1;
  }
  return ctr;
}

// The mask of panel (b, h): the eight columns 8 c .. 8 c + 7 of row `row` take
// the eight 16-bit halves (low half first) of the four words of Philox at
// counter (c, row) under the panel's key; an element is kept if its uniform
// u = half 2^-16 is at least p, i.e. half >= ceil(p 2^16).
__device__ __forceinline__ uint4 philox_row(const Dropout& drop, int b, int h, int H, int row, int col8) {
  const unsigned long long panel = drop.seed + static_cast<unsigned long long>(b) * H + h;
  return philox(make_uint4(static_cast<uint32_t>(col8), static_cast<uint32_t>(row), 0u, 0u),
                make_uint2(static_cast<uint32_t>(panel), static_cast<uint32_t>(panel >> 32)));
}

// Keep flags of the four halves of the words (w0, w1), in column order.
__device__ __forceinline__ void keep_halves(const Dropout& drop, uint32_t w0, uint32_t w1, bool out[4]) {
  out[0] = (w0 << 16) >= drop.threshold;
  out[1] = w0 >= drop.threshold;
  out[2] = (w1 << 16) >= drop.threshold;
  out[3] = w1 >= drop.threshold;
}

__device__ __forceinline__ const uint8_t* keep_row(const Dropout& drop, int b, int h, int H, int L, int row) {
  return drop.keep + ((static_cast<long long>(b) * H + h) * L + row) * L;
}

// Keep flags of rows `row` (out[0]) and `row + 8` (out[1]), columns col ..
// col + 3, col = 4 t + a multiple of 16, of panel (b, h): a lane's elements of
// a pair of n-tiles. With Philox the lanes t and t ^ 1 hold the two halves
// of one group of eight columns on both rows: the even one draws for `row`,
// the odd one for `row + 8`, and they swap the words the other needs.
// Elements beyond L are never stored and read nothing.
template <int kMode>
__device__ __forceinline__ void keep_pair(const Dropout& drop, int b, int h, int H, int L, int row, int col, int t,
                                          bool out[2][4]) {
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) out[r][c] = true;
  if constexpr (kMode == kModePhilox) {
    const bool odd = (t & 1) != 0;
    const uint4 w = philox_row(drop, b, h, H, odd ? row + 8 : row, col >> 3);
    // the even lane keeps its row's words 0, 1 and sends 2, 3; the odd one the reverse
    const uint32_t theirs0 = __shfl_xor_sync(0xffffffffu, odd ? w.x : w.z, 1);
    const uint32_t theirs1 = __shfl_xor_sync(0xffffffffu, odd ? w.y : w.w, 1);
    keep_halves(drop, odd ? theirs0 : w.x, odd ? theirs1 : w.y, out[0]);
    keep_halves(drop, odd ? w.z : theirs0, odd ? w.w : theirs1, out[1]);
  } else if constexpr (kMode == kModeGiven) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row + 8 * r >= L) continue;
      const uint8_t* m = keep_row(drop, b, h, H, L, row + 8 * r) + col;
      if ((L & 3) == 0) {  // rows of the mask are 4-byte aligned
        if (col < L) {
          const uchar4 m4 = *reinterpret_cast<const uchar4*>(m);
          out[r][0] = m4.x != 0;
          out[r][1] = m4.y != 0;
          out[r][2] = m4.z != 0;
          out[r][3] = m4.w != 0;
        }
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (col + c < L) out[r][c] = m[c] != 0;
      }
    }
  }
}

// Keep flags for a lane of the dK/dV launch: keys key0 (out[0]) and key0 + 8
// (out[1]), key0 = g + a multiple of 16, query rows row .. row + 3: out[.][i]
// for query row + i. With Philox the eight lanes that share t hold the same
// four queries and the two groups of eight keys: lane g draws for query row
// + g % 4 and the group g / 4 % 2, packs the eight flags, and each lane picks
// its key's bit from the eight lanes' bytes.
template <int kMode>
__device__ __forceinline__ void keep_pair_transposed(const Dropout& drop, int b, int h, int H, int L, int row,
                                                     int key0, int lane, bool out[2][4]) {
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i) out[r][i] = true;
  if constexpr (kMode == kModePhilox) {
    const int g = lane >> 2;
    const uint4 w = philox_row(drop, b, h, H, row + (g & 3), (key0 >> 3) + ((g >> 2) & 1));
    bool low[4], high[4];
    keep_halves(drop, w.x, w.y, low);
    keep_halves(drop, w.z, w.w, high);
    uint32_t packed = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c) packed |= (low[c] ? 1u << c : 0u) | (high[c] ? 16u << c : 0u);
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        out[r][i] = ((__shfl_sync(0xffffffffu, packed, (lane & 3) | ((4 * r + i) << 2)) >> g) & 1u) != 0;
  } else if constexpr (kMode == kModeGiven) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (row + i < L) {
        const uint8_t* m = keep_row(drop, b, h, H, L, row + i);
        if (key0 < L) out[0][i] = m[key0] != 0;
        if (key0 + 8 < L) out[1][i] = m[key0 + 8] != 0;
      }
    }
  }
}

__device__ __forceinline__ uint32_t shared_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes from device to shared memory without passing registers; `valid`
// false writes zeros and reads nothing.
__device__ __forceinline__ void copy_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(shared_address(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void commit_copies() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Waits for all of this thread's copies.
__device__ __forceinline__ void wait_copies() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// ---- tile loads ---------------------------------------------------------------
//
// A 64 x 64 tile of a [B, L, H, 64] tensor comes by the copy engine (TMA): one
// thread asks for two boxes of 64 rows x 32 floats through the tensor's map
// (made on the host, `make_map`), and the engine writes each as [64][32]
// floats in the 128-byte swizzle (the 16-byte chunk c of row r at chunk c ^
// (r % 8)), zeros for the rows beyond L, and reports the bytes to a barrier
// in shared memory. No warp waits for room in its load queue, as every warp
// did for about a thousand cycles a tile when the lanes copied 16 bytes each
// (cp.async). Turn n of the barrier completes when the thread that announced
// the bytes has arrived and all of them are there; waiters pass its parity.
__device__ __forceinline__ void barrier_init(uint64_t* barrier) {
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(shared_address(barrier)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

__device__ __forceinline__ void barrier_wait(uint64_t* barrier, int turn) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(shared_address(barrier)), "r"(turn & 1)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void load_tile(float* raw, const CUtensorMap* map, int b, int h, int r0,
                                          uint64_t* barrier) {
#pragma unroll
  for (int half = 0; half < 2; ++half)
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], "
        "[%6];\n" ::"r"(shared_address(raw + half * (kTileFloats / 2))),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(32 * half), "r"(h), "r"(r0), "r"(b), "r"(shared_address(barrier))
        : "memory");
}

// Thread 0 starts the loads of rows r0 .. r0 + 63 of panel (b, h) of one tile
// (map1 null) or two into raw0 (and raw1) for the barrier's next turn.
__device__ __forceinline__ void load_tiles(float* raw0, const CUtensorMap* map0, float* raw1, const CUtensorMap* map1,
                                           int b, int h, int r0, uint64_t* barrier) {
  if (threadIdx.x != 0) return;
  const int bytes = (map1 != nullptr ? 2 : 1) * kTileFloats * static_cast<int>(sizeof(float));
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(shared_address(barrier)), "r"(bytes)
               : "memory");
  load_tile(raw0, map0, b, h, r0, barrier);
  if (map1 != nullptr) load_tile(raw1, map1, b, h, r0, barrier);
}

// x[r0 .. r0 + 63] of a row of L floats into dst[0 .. 63]; zeros beyond L.
__device__ __forceinline__ void load_row_async(float* dst, const float* __restrict__ x, int r0, int L) {
  if (threadIdx.x < kTile) {
    const bool valid = r0 + static_cast<int>(threadIdx.x) < L;
    copy_async4(dst + threadIdx.x, x + (valid ? r0 + threadIdx.x : 0), valid);
  }
}

// Measurement switch (ops/attention.py and the tests build without it):
// K3_PRODUCTS 1 takes a single TF32 product (the high parts alone), which
// misses the fp32 tolerances and shows what the two small products cost.
#ifndef K3_PRODUCTS
#define K3_PRODUCTS 3
#endif

// x = hi + lo + O(2^-21 x): hi is x rounded to 11 significant bits (a TF32
// value) by Veltkamp's splitting with 2^13 + 1, three fp32 operations that
// must not be contracted into an fma (two cvt.rna.tf32.f32 per element
// measured slower); lo = x - hi is exact and goes to the tensor core as
// it is, which reads its upper 19 bits (a truncation of lo by at most 2^-10 of
// it, 2^-21 of x).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  const float c = __fmul_rn(x, 8193.f);
  const float high = __fsub_rn(c, __fsub_rn(c, x));
  hi = __float_as_uint(high);
  lo = __float_as_uint(__fsub_rn(x, high));
}

// 2^x by the special-function unit alone (2 ulp; a result below 2^-126 is 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A row whose every key is padded (its batch row's key mask all zero) scores
// the bias, -1e30, at every key: its maximum m is -1e30, l is L, and its lse,
// m + log2(L), rounds back to -1e30 (log2(L) is far below half an ulp of
// 1e30). P = exp2(s - lse) would then be 1 at every key, where the softmax of
// L equal scores is 1 / L, as the JAX kernel and the plain version give. So P
// is taken as exp2((s - lse) - shift): shift is log2(L) on such a row, whose
// s - lse is 0 at every key of the panel, and 0 on every other row, where the
// arithmetic is that of exp2(s - lse) bit for bit. An attended key scores far
// above kPaddedRow, so any row with one has its lse above it.
constexpr float kPaddedRow = -5e29f;

__device__ __forceinline__ float padded_row_shift(float row_lse, float log2_len) {
  return row_lse <= kPaddedRow ? log2_len : 0.f;
}

// ---- operand tiles in shared memory -----------------------------------------
//
// A wgmma B operand is a tile [64 rows n][64 depth k] of TF32 values, depth
// contiguous ("K-major"), in the 128-byte swizzle: two halves of 32 depth
// positions, each [64][32] floats with rows of 128 bytes, the 16-byte chunk c
// of row n stored at chunk c ^ (n % 8); a tile starts on a 1024-byte boundary.
// Element (n, k) is the float
//   (k / 32) (kTileFloats / 2) + 32 n + 4 ((k % 32 / 4) ^ (n % 8)) + k % 4.

// Where a tile row (a key; a query row in the dK/dV launch) sits as a column
// of a score product and as a depth position of the product that follows.
// wgmma's accumulator gives a lane the columns 8 j + 2 t + {0, 1} of every
// n-tile j, and its A fragment of k-step j wants the depth positions 8 j + t
// and 8 j + t + 4. Tile row 16 m + 4 a + 2 e + b (a < 4; e, b < 2) goes to
// column 8 (2 m + e) + 2 a + b, so that a lane's columns of the n-tiles 2 m
// and 2 m + 1 are the four neighbouring rows 16 m + 4 t + {0, 1, 2, 3} (one
// Philox call, one uchar4 of a given mask), and to depth position 8 (2 m + e)
// + a + 4 b, so that the accumulator's registers are the next product's A
// fragment as they stand (a0..a3 = c0, c2, c1, c3).
__device__ __forceinline__ int score_column(int row) {
  return (row & 48) | ((row & 2) << 2) | ((row >> 1) & 6) | (row & 1);
}

__device__ __forceinline__ int depth_position(int row) {
  return (row & 48) | ((row & 2) << 2) | ((row & 1) << 2) | ((row >> 2) & 3);
}

// Column d = 16 t + 2 j + b of an output product (P V, dS K, ...) is dealt to
// accumulator column 8 j + 2 t + b, so a lane ends with 16 neighbouring
// floats of its two rows: that column is row 8 j + 2 t + b of a depth tile.

// Splits the tile `raw` (as the copy engine left it) into TF32 operand
// tiles, hi at `tile` and lo at `tile + kTileFloats`: with kScores the tile
// whose rows are score columns (contracted over d), with kDepth the
// transposed tile whose rows are output columns d and whose depth is the
// tile's rows. A lane takes one row: the float4 reads of the swizzled raw
// tile and the scalar stores along a depth row hit 32 banks; the float4
// stores of the score tile conflict two ways.
template <bool kScores, bool kDepth>
__device__ __forceinline__ void convert_tile(const float* raw, float* scores_tile, float* depth_tile) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = 32 * (warp & 1) + lane, side = warp >> 1;  // the warp takes d = 16 side .. 16 side + 15
  const int n = score_column(row), k = depth_position(row);
  // the element formula taken apart into what the thread fixes and what the
  // unrolled loops fix, so that no address is computed per element. Score
  // tile: d = 16 side + 4 i is chunk 4 (side % 2) + i of half side / 2.
  // Depth tile: the output column of d = 16 side + 4 i + e is 8 (2 i + e / 2)
  // + 2 side + e % 2, so its chunk is one of two values of the thread.
  const float* src = raw + (side >> 1) * (kTileFloats / 2) + row * 32;
  const int src_chunk = (row & 7) ^ (4 * (side & 1));
  float* scores_at = scores_tile + (side >> 1) * (kTileFloats / 2) + n * 32;
  const int scores_chunk = (n & 7) ^ (4 * (side & 1));
  float* depth_at = depth_tile + (k >> 5) * (kTileFloats / 2) + 64 * side + (k & 3);
  const int depth_chunk[2] = {(((k & 31) >> 2) ^ (2 * side)) << 2, (((k & 31) >> 2) ^ (2 * side) ^ 1) << 2};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 x = *reinterpret_cast<const float4*>(src + ((i ^ src_chunk) << 2));
    const float xs[4] = {x.x, x.y, x.z, x.w};
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split(xs[e], hi[e], lo[e]);
    if constexpr (kScores) {
      float* at = scores_at + ((i ^ scores_chunk) << 2);
      *reinterpret_cast<uint4*>(at) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(at + kTileFloats) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    if constexpr (kDepth) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float* at = depth_at + 256 * (2 * i + (e >> 1)) + 32 * (e & 1) + depth_chunk[e & 1];
        at[0] = __uint_as_float(hi[e]);
        at[kTileFloats] = __uint_as_float(lo[e]);
      }
    }
  }
}

// Makes the tiles just written visible to the tensor cores' reads, block-wide.
__device__ __forceinline__ void publish_tiles() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

// ---- warpgroup products -------------------------------------------------------

// The shared-memory descriptor of an operand tile (or of rows of it): start
// address / 16, stride between groups of 8 rows 1024 bytes, 128-byte swizzle.
__device__ __forceinline__ uint64_t descriptor(const float* tile) {
  return static_cast<uint64_t>((shared_address(tile) & 0x3FFFF) >> 4) | (uint64_t(1) << 16) | (uint64_t(64) << 32) |
         (uint64_t(1) << 62);
}

// The descriptor moved to k-step `step` of the tile: 32 bytes a step, the
// second half of the depth 8192 bytes on.
__device__ __forceinline__ uint64_t at_step(uint64_t desc, int step) {
  return desc + (step >> 2) * (kTileFloats / 2 * 4 / 16) + 2 * (step & 3);
}

__device__ __forceinline__ void products_begin() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }

__device__ __forceinline__ void products_end() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d = (scale_d ? d : 0) + a b over one k-step of 8: the warpgroup's 64 rows
// (a: this lane's A fragment) by kN columns (the rows of the tile at `desc`).
template <int kN>
__device__ __forceinline__ void wgmma(float (*d)[4], const uint32_t a[4], uint64_t desc, int scale_d) {
  if constexpr (kN == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]),
          "+f"(d[1][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  } else if constexpr (kN == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]),
          "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]),
          "+f"(d[3][2]), "+f"(d[3][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  } else {
    static_assert(kN == 64, "a product is 16, 32 or 64 columns wide");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]),
          "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]),
          "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]),
          "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
}

// d (+)= a b as split TF32, b's high part at `desc` and its low part a tile on:
// the small terms first. `fresh` starts d from zero.
template <int kN>
__device__ __forceinline__ void wgmma_split(float (*d)[4], const uint32_t a_hi[4], const uint32_t a_lo[4],
                                            uint64_t desc, bool fresh) {
  constexpr int kLow = kTileFloats * 4 / 16;  // the low tile follows the high one
#if K3_PRODUCTS == 3
  wgmma<kN>(d, a_lo, desc, fresh ? 0 : 1);
  wgmma<kN>(d, a_hi, desc + kLow, 1);
  wgmma<kN>(d, a_hi, desc, 1);
#else
  wgmma<kN>(d, a_hi, desc, fresh ? 0 : 1);
#endif
}

// The A operand of a lane for all eight k-steps over d: its two rows x 64, split.
struct Fragments {
  uint32_t hi[8][4];
  uint32_t lo[8][4];
};

// Rows `row` and `row + 8` of panel (b, h) of x, times `mult`, as A
// fragments (rows beyond L as zeros). With kDot also dots[r] += the lane's
// part of sum_d x[row + 8 r][d] * y[row + 8 r][d] (of the unscaled x).
template <bool kDot>
__device__ __forceinline__ void load_fragments(Fragments& f, const float* __restrict__ x, const float* __restrict__ y,
                                               int b, int h, int row, int L, int H, int t, float mult,
                                               float dots[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = row + 8 * r < L;
    const long long off = row_offset(b, ok ? row + 8 * r : 0, h, L, H);
#pragma unroll
    for (int step = 0; step < 8; ++step)
#pragma unroll
      for (int half = 0; half < 2; ++half) {  // depth positions 8 step + t and 8 step + t + 4
        const float value = ok ? __ldg(x + off + 8 * step + 4 * half + t) : 0.f;
        if constexpr (kDot) dots[r] = fmaf(value, ok ? __ldg(y + off + 8 * step + 4 * half + t) : 0.f, dots[r]);
        split(value * mult, f.hi[step][2 * half + r], f.lo[step][2 * half + r]);
      }
  }
}

// d = A X^T for the kN score columns from `column0` on, X a score tile
// (convert_tile). Afterwards d[2 m' + e][2 r + c] is row g + 8 r, tile row
// 16 m + 4 t + 2 e + c, for the pair m = column0 / 16 + m'.
template <int kN>
__device__ __forceinline__ void scores(float (*d)[4], const Fragments& a, const float* tile, int column0) {
  const uint64_t desc = descriptor(tile + column0 * 32);
#pragma unroll
  for (int step = 0; step < 8; ++step) wgmma_split<kN>(d, a.hi[step], a.lo[step], at_step(desc, step), step == 0);
}

// The A fragments of the k-steps j < kSteps from a lane's values p[j][2 r + c]
// as `scores` leaves them: a0..a3 = c0, c2, c1, c3.
template <int kSteps>
__device__ __forceinline__ void make_fragments(const float (*p)[4], uint32_t (*hi)[4], uint32_t (*lo)[4]) {
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    split(p[j][0], hi[j][0], lo[j][0]);
    split(p[j][2], hi[j][1], lo[j][1]);
    split(p[j][1], hi[j][2], lo[j][2]);
    split(p[j][3], hi[j][3], lo[j][3]);
  }
}

// acc += P X over the depth positions 8 step0 .. 8 (step0 + kSteps) - 1 of
// the depth tile X, P as make_fragments made it.
template <int kSteps>
__device__ __forceinline__ void accumulate(float (*acc)[4], const uint32_t (*hi)[4], const uint32_t (*lo)[4],
                                           const float* tile, int step0) {
  const uint64_t desc = descriptor(tile);
#pragma unroll
  for (int j = 0; j < kSteps; ++j) wgmma_split<64>(acc, hi[j], lo[j], at_step(desc, step0 + j), false);
}

// After products_end(): ties the accumulators' later reads, and the last
// use of the fragments a product read, to this point, so that the compiler
// moves neither across the wait (the products run asynchronously and own
// their registers until it).
template <int kRows>
__device__ __forceinline__ void products_done(float (*d)[4]) {
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+f"(d[i][j])::"memory");
}

template <int kRows>
__device__ __forceinline__ void fragments_done(const uint32_t (*a)[4]) {
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" ::"r"(a[i][j]) : "memory");
}

// Rows `row` and `row + 8` of panel (b, h) of `out` from accumulators as
// `accumulate` leaves them (acc[j][2 r + c] is column 16 t + 2 j + c), times
// mult[r].
__device__ __forceinline__ void store_rows(float* __restrict__ out, const float acc[8][4], const float mult[2],
                                           int b, int h, int row, int L, int H, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row + 8 * r >= L) continue;
    float4* dst = reinterpret_cast<float4*>(out + row_offset(b, row + 8 * r, h, L, H)) + 4 * t;
    const float s = mult[r];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      dst[i] = make_float4(acc[2 * i][2 * r] * s, acc[2 * i][2 * r + 1] * s, acc[2 * i + 1][2 * r] * s,
                           acc[2 * i + 1][2 * r + 1] * s);
  }
}

template <int kRows>
__device__ __forceinline__ void zero(float a[kRows][4]) {
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[i][j] = 0.f;
}

// Adds the key bias to a pair's scores; with kRagged (the panel's last tile
// where L is no multiple of 64) keys beyond L score -inf.
template <bool kRagged>
__device__ __forceinline__ void add_bias(float s[2][4], const float* bias_s, int col, int L) {
  const float4 bias4 = *reinterpret_cast<const float4*>(bias_s);
  const float bias[4] = {bias4.x, bias4.y, bias4.z, bias4.w};
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const bool inside = !kRagged || col + 2 * e + c < L;
      s[e][c] = inside ? s[e][c] + bias[2 * e + c] : -INFINITY;
      s[e][c + 2] = inside ? s[e][c + 2] + bias[2 * e + c] : -INFINITY;
    }
}

// The same for all the pairs of kPairs consecutive pairs from tile column col0 on.
template <int kPairs>
__device__ __forceinline__ void add_bias_pairs(float (*s)[4], const float* tile_bias, int tile0, int col0, int t, int L) {
  if (tile0 + kTile <= L) {
#pragma unroll
    for (int m = 0; m < kPairs; ++m) add_bias<false>(&s[2 * m], tile_bias + col0 + 16 * m + 4 * t, 0, L);
  } else {
#pragma unroll
    for (int m = 0; m < kPairs; ++m)
      add_bias<true>(&s[2 * m], tile_bias + col0 + 16 * m + 4 * t, tile0 + col0 + 16 * m + 4 * t, L);
  }
}

// Shared memory, in floats. Operand tiles (hi and lo) first, each on a
// 1024-byte boundary, then the raw tiles (the same), then two turns of row
// vectors and the loads' barrier.
constexpr int kOperand = 2 * kTileFloats;  // a tile's hi and lo
constexpr int kForwardFloats = 2 * kOperand + 2 * kTileFloats + 2 * kTile + 2;  // K, V^T; raw K, V; bias
constexpr int kDqFloats = 3 * kOperand + 2 * kTileFloats + 2 * kTile + 2;       // K, V, K^T; raw K, V; bias
constexpr int kDkdvFloats = 4 * kOperand + 2 * kTileFloats + 4 * kTile + 2;     // Q, dO, Q^T, dO^T; raw; lse, delta
constexpr int kForwardBytes = kForwardFloats * static_cast<int>(sizeof(float));
constexpr int kDqBytes = kDqFloats * static_cast<int>(sizeof(float));
constexpr int kDkdvBytes = kDkdvFloats * static_cast<int>(sizeof(float));

// Measurement switch K3_CLOCKS: every kernel adds up, over all blocks, the
// cycles its thread 0 spends in each phase of a tile (k3_clocks() reads and
// clears the sums); the profilers that would show this do not run everywhere.
// Kernel 0 is attn_forward, 1 attn_backward_dq, 2 attn_backward_dkdv.
#ifdef K3_CLOCKS
__device__ unsigned long long phase_clocks[3][16];
#define K3_PHASES_BEGIN long long phase_start = clock64()
#define K3_PHASE(kernel, i)                                                                 \
  do {                                                                                      \
    const long long now = clock64();                                                        \
    if (threadIdx.x == 0)                                                                   \
      atomicAdd(&phase_clocks[kernel][i], static_cast<unsigned long long>(now - phase_start)); \
    phase_start = clock64();                                                                \
  } while (0)
#else
#define K3_PHASES_BEGIN
#define K3_PHASE(kernel, i)
#endif

// The descriptors assume tiles on 1024-byte boundaries.
__device__ __forceinline__ void check_alignment(const float* smem) {
  if ((shared_address(smem) & 1023u) != 0) asm volatile("trap;\n");
}

template <int kMode>
__global__ void __launch_bounds__(kThreads, 1)
attn_forward(const float* __restrict__ q, const __grid_constant__ CUtensorMap k_map,
             const __grid_constant__ CUtensorMap v_map, const float* __restrict__ bias, Dropout drop, float scale,
             float* __restrict__ o, float* __restrict__ lse, float* __restrict__ probs, int L, int H) {
  extern __shared__ __align__(1024) float smem[];
  resolve_seed<kMode>(drop);
  float* k_tile = smem;                 // K as score columns
  float* vt_tile = smem + kOperand;     // V^T as depth
  float* k_raw = smem + 2 * kOperand;
  float* v_raw = k_raw + kTileFloats;
  float* bias_s = v_raw + kTileFloats;   // [2][64]
  uint64_t* arrived = reinterpret_cast<uint64_t*>(bias_s + 2 * kTile);
  check_alignment(smem);
  barrier_init(arrived);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int i0 = blockIdx.x * kBlockRows, h = blockIdx.y, b = blockIdx.z;
  const int row = i0 + 16 * (threadIdx.x >> 5) + g;  // the lane's rows: row and row + 8
  const int tiles = (L + kTile - 1) / kTile;
  const float* bias_row = bias + static_cast<long long>(b) * L;

  load_tiles(k_raw, &k_map, v_raw, &v_map, b, h, 0, arrived);
  load_row_async(bias_s, bias_row, 0, L);
  commit_copies();
  Fragments qf;
  load_fragments<false>(qf, q, nullptr, b, h, row, L, H, t, scale * kLog2e, nullptr);
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f}, acc[8][4];
  zero<8>(acc);

  K3_PHASES_BEGIN;
  for (int jt = 0; jt < tiles; ++jt) {
    wait_copies();
    barrier_wait(arrived, jt);
    __syncthreads();  // the raw tiles have landed; the operand tiles of the last turn are read
    K3_PHASE(0, 0);
    convert_tile<true, false>(k_raw, k_tile, nullptr);
    convert_tile<false, true>(v_raw, nullptr, vt_tile);
    K3_PHASE(0, 1);
    publish_tiles();
    K3_PHASE(0, 2);
    const float* tile_bias = bias_s + (jt & 1) * kTile;
    if (jt + 1 < tiles) {  // the next tile loads while this one computes
      load_tiles(k_raw, &k_map, v_raw, &v_map, b, h, (jt + 1) * kTile, arrived);
      load_row_async(bias_s + ((jt + 1) & 1) * kTile, bias_row, (jt + 1) * kTile, L);
      commit_copies();
    }
    K3_PHASE(0, 3);
    float s[8][4];
    products_begin();
    scores<64>(s, qf, k_tile, 0);
    K3_PHASE(0, 4);
    products_end();
    products_done<8>(s);
    K3_PHASE(0, 5);
    add_bias_pairs<4>(s, tile_bias, jt * kTile, 0, t, L);
    float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) tile_max[r] = fmaxf(tile_max[r], fmaxf(s[j][2 * r], s[j][2 * r + 1]));
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 1));
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 2));
      const float m_new = fmaxf(m_run[r], tile_max[r]);     // finite: every tile has a key inside L
      const float correction = fast_exp2(m_run[r] - m_new);  // 0 on the first tile
      m_run[r] = m_new;
      l_run[r] *= correction;  // the lane's part of the row sum; the lanes' parts are added at the end
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[j][2 * r] *= correction;
        acc[j][2 * r + 1] *= correction;
      }
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      bool kept[2][4];
      keep_pair<kMode>(drop, b, h, H, L, row, jt * kTile + 16 * m + 4 * t, t, kept);
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float ex = fast_exp2(s[2 * m + e][2 * r + c] - m_run[r]);
            l_run[r] += ex;
            s[2 * m + e][2 * r + c] = kept[r][2 * e + c] ? ex : 0.f;
          }
    }
    K3_PHASE(0, 6);
    uint32_t p_hi[8][4], p_lo[8][4];
    make_fragments<8>(s, p_hi, p_lo);
    K3_PHASE(0, 7);
    products_begin();
    accumulate<8>(acc, p_hi, p_lo, vt_tile, 0);
    K3_PHASE(0, 8);
    products_end();
    products_done<8>(acc);
    fragments_done<8>(p_hi);
    fragments_done<8>(p_lo);
    K3_PHASE(0, 9);
  }

  float inv[2], row_lse[2], row_shift[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    inv[r] = 1.f / (l_run[r] * (1.f - drop.p));
    row_lse[r] = m_run[r] + log2f(l_run[r]);
    row_shift[r] = padded_row_shift(row_lse[r], log2f(static_cast<float>(L)));
    if (t == 0 && row + 8 * r < L) lse[(static_cast<long long>(b) * H + h) * L + row + 8 * r] = row_lse[r];
  }
  store_rows(o, acc, inv, b, h, row, L, H, t);
  if (probs == nullptr) return;

  // debug: the realized probabilities, exp2(s - lse) kept and scaled, [B, H, L, L]
  for (int jt = 0; jt < tiles; ++jt) {
    __syncthreads();  // the last turn's tiles are read
    load_tiles(k_raw, &k_map, nullptr, nullptr, b, h, jt * kTile, arrived);
    load_row_async(bias_s, bias_row, jt * kTile, L);
    commit_copies();
    wait_copies();
    barrier_wait(arrived, tiles + jt);
    __syncthreads();
    convert_tile<true, false>(k_raw, k_tile, nullptr);
    publish_tiles();
    float s[8][4];
    products_begin();
    scores<64>(s, qf, k_tile, 0);
    products_end();
    products_done<8>(s);
    add_bias_pairs<4>(s, bias_s, jt * kTile, 0, t, L);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int col = jt * kTile + 16 * m + 4 * t;
      bool kept[2][4];
      keep_pair<kMode>(drop, b, h, H, L, row, col, t, kept);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (row + 8 * r >= L) continue;
        float out[4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          out[c] = kept[r][c] ? fast_exp2((s[2 * m + (c >> 1)][2 * r + (c & 1)] - row_lse[r]) - row_shift[r]) * drop.inv_keep : 0.f;
        float* dst = probs + ((static_cast<long long>(b) * H + h) * L + row + 8 * r) * L + col;
        if ((L & 3) == 0) {
          if (col < L) *reinterpret_cast<float4*>(dst) = make_float4(out[0], out[1], out[2], out[3]);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (col + c < L) dst[c] = out[c];
        }
      }
    }
  }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads, 1)
attn_backward_dq(const float* __restrict__ q, const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map, const float* __restrict__ bias, Dropout drop,
                 float scale, const float* __restrict__ o,
                 const float* __restrict__ dout, const float* __restrict__ lse, float* __restrict__ delta,
                 float* __restrict__ dq, int L, int H) {
  extern __shared__ __align__(1024) float smem[];
  resolve_seed<kMode>(drop);
  float* k_tile = smem;                  // K as score columns
  float* v_tile = smem + kOperand;       // V as score columns (of dO V^T)
  float* kt_tile = smem + 2 * kOperand;  // K^T as depth
  float* k_raw = smem + 3 * kOperand;
  float* v_raw = k_raw + kTileFloats;
  float* bias_s = v_raw + kTileFloats;    // [2][64]
  uint64_t* arrived = reinterpret_cast<uint64_t*>(bias_s + 2 * kTile);
  check_alignment(smem);
  barrier_init(arrived);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int i0 = blockIdx.x * kBlockRows, h = blockIdx.y, b = blockIdx.z;
  const int row = i0 + 16 * (threadIdx.x >> 5) + g;
  const int tiles = (L + kTile - 1) / kTile;
  const long long stat = (static_cast<long long>(b) * H + h) * L;
  const float* bias_row = bias + static_cast<long long>(b) * L;

  load_tiles(k_raw, &k_map, v_raw, &v_map, b, h, 0, arrived);
  load_row_async(bias_s, bias_row, 0, L);
  commit_copies();
  Fragments qf, dof;
  load_fragments<false>(qf, q, nullptr, b, h, row, L, H, t, scale * kLog2e, nullptr);
  float row_delta[2] = {0.f, 0.f}, row_lse[2], row_shift[2];
  load_fragments<true>(dof, dout, o, b, h, row, L, H, t, 1.f, row_delta);  // delta = rowsum(dO * O)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row_delta[r] += __shfl_xor_sync(0xffffffffu, row_delta[r], 1);
    row_delta[r] += __shfl_xor_sync(0xffffffffu, row_delta[r], 2);
    const bool inside = row + 8 * r < L;
    row_lse[r] = inside ? lse[stat + row + 8 * r] : 0.f;
    row_shift[r] = padded_row_shift(row_lse[r], log2f(static_cast<float>(L)));
    if (inside && t == 0) delta[stat + row + 8 * r] = row_delta[r];
  }
  float acc[8][4];
  zero<8>(acc);

  K3_PHASES_BEGIN;
  for (int jt = 0; jt < tiles; ++jt) {
    wait_copies();
    barrier_wait(arrived, jt);
    __syncthreads();
    K3_PHASE(1, 0);
    convert_tile<true, true>(k_raw, k_tile, kt_tile);
    convert_tile<true, false>(v_raw, v_tile, nullptr);
    K3_PHASE(1, 1);
    publish_tiles();
    K3_PHASE(1, 2);
    const float* tile_bias = bias_s + (jt & 1) * kTile;
    if (jt + 1 < tiles) {
      load_tiles(k_raw, &k_map, v_raw, &v_map, b, h, (jt + 1) * kTile, arrived);
      load_row_async(bias_s + ((jt + 1) & 1) * kTile, bias_row, (jt + 1) * kTile, L);
      commit_copies();
    }
    K3_PHASE(1, 3);
#pragma unroll
    for (int half = 0; half < 2; ++half) {  // 32 keys at a time: two pairs
      float s[4][4], dp[4][4];
      products_begin();
      scores<32>(s, qf, k_tile, 32 * half);
      scores<32>(dp, dof, v_tile, 32 * half);  // dO V^T
      products_end();
      products_done<4>(s);
      products_done<4>(dp);
      K3_PHASE(1, 4);
      add_bias_pairs<2>(s, tile_bias, jt * kTile, 32 * half, t, L);
#pragma unroll
      for (int mm = 0; mm < 2; ++mm) {
        bool kept[2][4];
        keep_pair<kMode>(drop, b, h, H, L, row, jt * kTile + 32 * half + 16 * mm + 4 * t, t, kept);
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const float p = fast_exp2((s[2 * mm + e][2 * r + c] - row_lse[r]) - row_shift[r]);
              const float dpk = kept[r][2 * e + c] ? dp[2 * mm + e][2 * r + c] * drop.inv_keep : 0.f;
              s[2 * mm + e][2 * r + c] = p * (dpk - row_delta[r]);  // dS
            }
      }
      K3_PHASE(1, 5);
      uint32_t ds_hi[4][4], ds_lo[4][4];
      make_fragments<4>(s, ds_hi, ds_lo);
      K3_PHASE(1, 6);
      products_begin();
      accumulate<4>(acc, ds_hi, ds_lo, kt_tile, 4 * half);  // dS K
      products_end();
      products_done<8>(acc);
      fragments_done<4>(ds_hi);
      fragments_done<4>(ds_lo);
      K3_PHASE(1, 7);
    }
  }
  const float mult[2] = {scale, scale};
  store_rows(dq, acc, mult, b, h, row, L, H, t);
}

template <int kMode>
__global__ void __launch_bounds__(kThreads, 1)
attn_backward_dkdv(const __grid_constant__ CUtensorMap q_map, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ bias, Dropout drop, float scale,
                   const __grid_constant__ CUtensorMap do_map, const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dk,
                   float* __restrict__ dv, int L, int H) {
  extern __shared__ __align__(1024) float smem[];
  resolve_seed<kMode>(drop);
  float* q_tile = smem;                    // Q as score columns (of K Q^T)
  float* do_tile = smem + kOperand;        // dO as score columns (of V dO^T)
  float* qt_tile = smem + 2 * kOperand;    // Q^T as depth
  float* dot_tile = smem + 3 * kOperand;   // dO^T as depth
  float* q_raw = smem + 4 * kOperand;
  float* do_raw = q_raw + kTileFloats;
  float* stats_s = do_raw + kTileFloats;    // [2][lse 64, delta 64]
  uint64_t* arrived = reinterpret_cast<uint64_t*>(stats_s + 4 * kTile);
  check_alignment(smem);
  barrier_init(arrived);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int j0 = blockIdx.x * kBlockRows, h = blockIdx.y, b = blockIdx.z;
  const int key = j0 + 16 * (threadIdx.x >> 5) + g;  // the lane's keys: key and key + 8
  const int tiles = (L + kTile - 1) / kTile;
  const long long stat = (static_cast<long long>(b) * H + h) * L;
  const float log2_len = log2f(static_cast<float>(L));

  // query tile `it` of Q and dO into the raw tiles, lse and delta into turn it % 2
  auto load_queries_async = [&](int it) {
    load_tiles(q_raw, &q_map, do_raw, &do_map, b, h, it * kTile, arrived);
    load_row_async(stats_s + (it & 1) * 2 * kTile, lse + stat, it * kTile, L);
    load_row_async(stats_s + (it & 1) * 2 * kTile + kTile, delta + stat, it * kTile, L);
    commit_copies();
  };

  load_queries_async(0);
  Fragments kf, vf;
  load_fragments<false>(kf, k, nullptr, b, h, key, L, H, t, scale * kLog2e, nullptr);
  load_fragments<false>(vf, v, nullptr, b, h, key, L, H, t, 1.f, nullptr);
  float key_bias[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) key_bias[r] = key + 8 * r < L ? bias[static_cast<long long>(b) * L + key + 8 * r] : 0.f;
  float acc_dk[8][4], acc_dv[8][4];
  zero<8>(acc_dk);
  zero<8>(acc_dv);

  K3_PHASES_BEGIN;
  for (int it = 0; it < tiles; ++it) {
    wait_copies();
    barrier_wait(arrived, it);
    __syncthreads();
    K3_PHASE(2, 0);
    convert_tile<true, true>(q_raw, q_tile, qt_tile);
    convert_tile<true, true>(do_raw, do_tile, dot_tile);
    K3_PHASE(2, 1);
    publish_tiles();
    K3_PHASE(2, 2);
    const float* tile_stats = stats_s + (it & 1) * 2 * kTile;
    if (it + 1 < tiles) load_queries_async(it + 1);
    K3_PHASE(2, 3);
#pragma unroll
    for (int m = 0; m < 4; ++m) {  // 16 query rows at a time: one pair
      // S^T and (dO V^T)^T: rows are the lane's keys, columns the query rows
      // query .. query + 3 (zero rows of Q and dO, lse and delta 0, beyond L:
      // they add nothing to dK and dV)
      const int query = it * kTile + 16 * m + 4 * t;
      float st[2][4], dpt[2][4];
      products_begin();
      scores<16>(st, kf, q_tile, 16 * m);
      scores<16>(dpt, vf, do_tile, 16 * m);
      products_end();
      products_done<2>(st);
      products_done<2>(dpt);
      K3_PHASE(2, 4);
      const float4 lse4 = *reinterpret_cast<const float4*>(tile_stats + 16 * m + 4 * t);
      const float4 delta4 = *reinterpret_cast<const float4*>(tile_stats + kTile + 16 * m + 4 * t);
      const float query_lse[4] = {lse4.x, lse4.y, lse4.z, lse4.w};
      const float query_shift[4] = {padded_row_shift(lse4.x, log2_len), padded_row_shift(lse4.y, log2_len),
                                    padded_row_shift(lse4.z, log2_len), padded_row_shift(lse4.w, log2_len)};
      const float query_delta[4] = {delta4.x, delta4.y, delta4.z, delta4.w};
      bool kept[2][4];
      keep_pair_transposed<kMode>(drop, b, h, H, L, query, key, lane, kept);
      float pd[2][4];
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int i = 2 * e + c;  // query + i
            const float p = fast_exp2((st[e][2 * r + c] + key_bias[r] - query_lse[i]) - query_shift[i]);
            const float dpk = kept[r][i] ? dpt[e][2 * r + c] * drop.inv_keep : 0.f;
            pd[e][2 * r + c] = kept[r][i] ? p * drop.inv_keep : 0.f;  // P_drop^T
            st[e][2 * r + c] = p * (dpk - query_delta[i]);          // dS^T
          }
      K3_PHASE(2, 5);
      uint32_t pd_hi[2][4], pd_lo[2][4], ds_hi[2][4], ds_lo[2][4];
      make_fragments<2>(pd, pd_hi, pd_lo);
      make_fragments<2>(st, ds_hi, ds_lo);
      K3_PHASE(2, 6);
      products_begin();
      accumulate<2>(acc_dv, pd_hi, pd_lo, dot_tile, 2 * m);  // P_drop^T dO
      accumulate<2>(acc_dk, ds_hi, ds_lo, qt_tile, 2 * m);   // dS^T Q
      products_end();
      products_done<8>(acc_dv);
      products_done<8>(acc_dk);
      fragments_done<2>(pd_hi);
      fragments_done<2>(pd_lo);
      fragments_done<2>(ds_hi);
      fragments_done<2>(ds_lo);
      K3_PHASE(2, 7);
    }
  }
  const float mult_dk[2] = {scale, scale}, mult_dv[2] = {1.f, 1.f};
  store_rows(dk, acc_dk, mult_dk, b, h, key, L, H, t);
  store_rows(dv, acc_dv, mult_dv, b, h, key, L, H, t);
}

constexpr int kMaxDevices = 64;
bool configured[kMaxDevices];

// Lets a kernel take its shared memory above the 48 KB default.
template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int kMode>
cudaError_t configure_mode() {
  cudaError_t err = allow_shared(attn_forward<kMode>, kForwardBytes);
  if (err == cudaSuccess) err = allow_shared(attn_backward_dq<kMode>, kDqBytes);
  if (err == cudaSuccess) err = allow_shared(attn_backward_dkdv<kMode>, kDkdvBytes);
  return err;
}

// Once per device, for every kernel.
cudaError_t configure(int device) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (configured[device]) return cudaSuccess;
  cudaError_t err = configure_mode<kModeNone>();
  if (err == cudaSuccess) err = configure_mode<kModePhilox>();
  if (err == cudaSuccess) err = configure_mode<kModeGiven>();
  configured[device] = err == cudaSuccess;
  return err;
}

cudaError_t check_and_enter(int B, int L, int H, int mode, float p, const void* keep, int device, int* previous) {
  if (B < 1 || H < 1 || L < 1 || (L + kTile - 1) / kTile > 65535 || H > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  if (mode < kModeNone || mode > kModeGiven || (mode == kModeGiven && keep == nullptr) ||
      (mode == kModeNone) != (p == 0.f) || !(p >= 0.f && p < 1.f))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaGetDevice(previous);
  if (err != cudaSuccess) return err;
  // also where the device is this thread's already: setting it binds the
  // device's context to a thread that has made no runtime call yet
  // (autograd's), and the tensor-map encoder needs one
  if ((err = cudaSetDevice(device)) != cudaSuccess) return err;
  return configure(device);
}

// cuTensorMapEncodeTiled, from libcuda, which the runtime has loaded already.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* libcuda = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    return libcuda == nullptr ? nullptr : reinterpret_cast<EncodeTiled>(dlsym(libcuda, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// The copy engine's map of x, [B, L, H, 64] fp32: boxes of 64 rows (L) x 32
// floats of one (b, h), written in the 128-byte swizzle, zeros beyond L.
cudaError_t make_map(CUtensorMap* map, const void* x, int B, int L, int H) {
  const cuuint64_t row_bytes = kD * sizeof(float);
  const cuuint64_t dims[4] = {kD, static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(L), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {row_bytes, H * row_bytes, static_cast<cuuint64_t>(L) * H * row_bytes};
  const cuuint32_t box[4] = {kD / 2, 1, kTile, 1}, steps[4] = {1, 1, 1, 1};
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const CUresult result =
      encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(x), dims, strides, box, steps,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return result == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

Dropout make_dropout(unsigned long long seed, const void* seed_ptr, const void* keep, float p) {
  // ceil(p 2^16) <= 2^16 - 1 for p <= 0.99998; above, every element is dropped
  const uint32_t halves = static_cast<uint32_t>(ceilf(p * 65536.f));
  const uint32_t threshold = halves > 65535u ? 0xffffffffu : halves << 16;
  return Dropout{seed, static_cast<const long long*>(seed_ptr), static_cast<const uint8_t*>(keep), p,
                 1.f / (1.f - p), threshold};
}

}  // namespace

extern "C" {

// K3a. o: [B, L, H, 64]; lse: [B, H, L], base 2; probs: [B, H, L, L] or null.
// mode 0: no dropout (p must be 0); 1: Philox from `seed`, plus the int64 at
// `seed_ptr` (device memory) unless it is null; 2: `keep` given.
int k3_forward(const void* q, const void* k, const void* v, const void* bias, int mode, unsigned long long seed,
               const void* seed_ptr, const void* keep, float p, float scale, void* o, void* lse, void* probs, int B, int L, int H,
               int device, void* stream) {
  int previous = 0;
  cudaError_t err = check_and_enter(B, L, H, mode, p, keep, device, &previous);
  CUtensorMap k_map, v_map;
  if (err == cudaSuccess) err = make_map(&k_map, k, B, L, H);
  if (err == cudaSuccess) err = make_map(&v_map, v, B, L, H);
  if (err == cudaSuccess) {
    const auto kernel = mode == kModeNone     ? attn_forward<kModeNone>
                        : mode == kModePhilox ? attn_forward<kModePhilox>
                                              : attn_forward<kModeGiven>;
    kernel<<<dim3((L + kBlockRows - 1) / kBlockRows, H, B), kThreads, kForwardBytes, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), k_map, v_map, static_cast<const float*>(bias), make_dropout(seed, seed_ptr, keep, p),
        scale, static_cast<float*>(o), static_cast<float*>(lse), static_cast<float*>(probs), L, H);
    err = cudaGetLastError();
  }
  if (previous != device) cudaSetDevice(previous);
  return static_cast<int>(err);
}

// K3b. lse: K3a's; delta: [B, H, L] scratch; dq, dk, dv: [B, L, H, 64].
int k3_backward(const void* q, const void* k, const void* v, const void* bias, int mode, unsigned long long seed,
                const void* seed_ptr, const void* keep, float p, float scale, const void* o, const void* dout, const void* lse,
                void* delta, void* dq, void* dk, void* dv, int B, int L, int H, int device, void* stream) {
  int previous = 0;
  cudaError_t err = check_and_enter(B, L, H, mode, p, keep, device, &previous);
  const Dropout drop = make_dropout(seed, seed_ptr, keep, p);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((L + kBlockRows - 1) / kBlockRows, H, B);
  CUtensorMap q_map, k_map, v_map, do_map;
  if (err == cudaSuccess) err = make_map(&q_map, q, B, L, H);
  if (err == cudaSuccess) err = make_map(&k_map, k, B, L, H);
  if (err == cudaSuccess) err = make_map(&v_map, v, B, L, H);
  if (err == cudaSuccess) err = make_map(&do_map, dout, B, L, H);
  if (err == cudaSuccess) {
    const auto kernel = mode == kModeNone     ? attn_backward_dq<kModeNone>
                        : mode == kModePhilox ? attn_backward_dq<kModePhilox>
                                              : attn_backward_dq<kModeGiven>;
    kernel<<<grid, kThreads, kDqBytes, s>>>(
        static_cast<const float*>(q), k_map, v_map, static_cast<const float*>(bias), drop, scale,
        static_cast<const float*>(o),
        static_cast<const float*>(dout), static_cast<const float*>(lse), static_cast<float*>(delta),
        static_cast<float*>(dq), L, H);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess) {
    const auto kernel = mode == kModeNone     ? attn_backward_dkdv<kModeNone>
                        : mode == kModePhilox ? attn_backward_dkdv<kModePhilox>
                                              : attn_backward_dkdv<kModeGiven>;
    kernel<<<grid, kThreads, kDkdvBytes, s>>>(
        q_map, static_cast<const float*>(k), static_cast<const float*>(v), static_cast<const float*>(bias), drop,
        scale, do_map, static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<float*>(dk),
        static_cast<float*>(dv), L, H);
    err = cudaGetLastError();
  }
  if (previous != device) cudaSetDevice(previous);
  return static_cast<int>(err);
}

#ifdef K3_CLOCKS
// out[kernel][phase], 3 x 16. attn_forward: wait for the tile, split it into
// operand tiles, publish them, start the next loads, start Q K^T, wait for it,
// softmax and dropout, split P, start P V, wait for it. The backward kernels:
// the same first four, then the score products, the elementwise part, the
// split of dS (and P_drop), the accumulating products.
int k3_clocks(unsigned long long* out) {
  const unsigned long long zeros[3][16] = {};
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(out, phase_clocks, sizeof(phase_clocks));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(phase_clocks, zeros, sizeof(zeros));
  return static_cast<int>(err);
}
#endif

const char* k3_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
