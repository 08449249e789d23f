// K3a and K3b on bf16 operands: self-attention with dropout on the
// probabilities, forward and backward, as CUDA kernels for Hopper (sm_90a),
// for the DistilBERT encoder under `compute_dtype: bf16`. Every product is a
// tensor-core `mma.sync.m16n8k16` of bf16 operands with fp32 accumulation.
//
// Replaces the TPU kernels beyond_deep_ensembles_tpu/ops/attention.py:84
// `_fwd_kernel` (K3a) and :101 `_bwd_kernel` (K3b) where those run on bf16
// q, k, v. Their rule, kept here: S = Q K^T accumulated in fp32, times the
// scale, plus the key bias (-1e30 on a padded key), an fp32 softmax, dropout
// on the probabilities (kept with u >= p, then scaled by 1 / (1 - p)), P_drop
// rounded to bf16 before P_drop V, O written in bf16 (JAX :66-69, :88-93);
// the backward takes dV = P_drop^T dO from bf16 P_drop, dP = drop(dO V^T),
// dS = P * (dP - rowsum(dP * P)) rounded to bf16 before dQ = dS K scale and
// dK = dS^T Q scale, fp32 accumulation, dQ, dK and dV written in bf16 (JAX
// :111-128). The fp32 kernels (`dropout_attention.cu`, split TF32) stay for
// fp32 operands.
//
// Layout: q, k, v, o, dO, dq, dk, dv are [B, L, H, 64] bf16, contiguous; bias
// is [B, L] fp32; lse and delta are [B, H, L] fp32; a given keep mask is uint8
// [B, H, L, L]. Any L >= 1: rows beyond L load as zeros, keys beyond L score
// -inf, stores beyond L are left out.
//
// The dropout mask is the fp32 kernels' bit for bit (`philox_row` and the
// threshold are theirs): Philox-4x32-10 keyed by the panel seed seed + b H +
// h, counter (col / 8, row), the 16-bit half col % 8 of the four words (low
// half first) as the uniform; or a given mask; or none at p = 0. The seed is
// a host value, or a key in device memory plus the host value, read once per
// block (a captured launch draws afresh at each replay).
//
// Kernels. A block is four warps; a warp owns 16 rows (query rows in K3a and
// the dQ launch, keys in the dK/dV launch), and holds its own operands (Q; Q
// and dO; K and V) as mma A fragments in registers for the whole walk. The
// tiles that stream past are loaded into shared memory, rows padded to 72
// bf16 so that neither the fragment loads nor `ldmatrix` conflict on banks.
// The C fragment of a score product is the A fragment of the product that
// follows as it stands (two n-tiles of 8 are one k-step of 16), so no
// probability leaves the registers; the B operand of that product (V, K, dO
// or Q, row-major) is read by `ldmatrix.trans`. Scores are kept in base 2.
//   K3a `fwd`: a block per (64 query rows, h, b) walks tiles of 64 keys with
//     an online softmax (running max m, row sum l of the undropped values,
//     the kept values rounded to bf16 and accumulated into O), then writes
//     O / (l (1 - p)) in bf16 and lse = m + log2(l). The kept values are
//     rounded before the division by l (1 - p): the same relative rounding
//     as P_drop's, at another scale.
//   K3b, two launches without atomics (repeat runs agree bit for bit):
//     `dq`: a block per 64 query rows takes delta = rowsum(dO * O) for its
//       rows (written out for the next launch), walks tiles of 32 keys
//       recomputing S, P and dO V^T, and accumulates dQ;
//     `dkdv`: a block per 64 keys walks tiles of 32 query rows recomputing
//       S^T, P^T and V dO^T, and accumulates dK and dV.
//   The mask's Philox calls are shared: in K3a and dQ the four lanes of a
//   row pair draw the four (row, group of 8 keys) pairs of two n-tiles and
//   exchange the words by shuffles; in dK/dV the eight lanes that share a
//   query pair draw eight (query, key group) pairs and exchange packed bits.
//
// Bound: at DistilBERT's (8, 12, 512, 64), K3a does 4 B H L^2 D = 6.44 GFLOP
// (6.5 us at 989 TFLOP/s bf16) and moves 8 B L H D = 25 MB (q, k, v in, o
// out: 7.5 us at 3.35 TB/s), so bytes bound it; K3b does 10 B H L^2 D = 16.1
// GFLOP (16.3 us) against 50 MB (15 us), so operations bound it (the dQ /
// dK-dV split recomputes S and dO V^T once more: 14 B H L^2 D done). This
// first version
// loads its tiles synchronously (no copy engine, no double buffering) and
// runs `mma.sync`, not `wgmma`: it is right first, and its times stand in
// PERF.md beside the bounds.
//
// C interface for ctypes: each function launches on the given stream,
// returns the first error (0 on success) and does not synchronise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kD = 64;            // head dimension
constexpr int kThreads = 128;     // four warps of 16 rows
constexpr int kRows = 64;         // rows of a block
constexpr int kFwdKeys = 64;      // keys of a K3a tile
constexpr int kBwdCols = 32;      // keys of a dQ tile, query rows of a dK/dV tile
constexpr int kLd = kD + 8;       // a tile row in shared memory, bf16 (144 bytes)
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kModeNone = 0, kModePhilox = 1, kModeGiven = 2;

struct Dropout {
  unsigned long long seed;    // Philox: the step's seed (the panel adds b H + h), or the index added to *seed_ptr
  const long long* seed_ptr;  // Philox: the key in device memory, or null for a host seed
  const uint8_t* keep;        // given: [B, H, L, L]
  float p;                    // drop probability
  float inv_keep;             // 1 / (1 - p)
  uint32_t threshold;         // Philox: a 16-bit value u is kept if u << 16 >= threshold
};

template <int kMode>
__device__ __forceinline__ void resolve_seed(Dropout& drop) {
  if constexpr (kMode == kModePhilox) {
    if (drop.seed_ptr != nullptr) drop.seed += static_cast<unsigned long long>(__ldg(drop.seed_ptr));
  }
}

__device__ __forceinline__ long long row_offset(int b, int row, int h, int L, int H) {
  return ((static_cast<long long>(b) * L + row) * H + h) * kD;
}

// Philox-4x32-10, as in dropout_attention.cu.
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

// The words of row `row`, key group `col8` (keys 8 col8 .. 8 col8 + 7) of panel (b, h).
__device__ __forceinline__ uint4 philox_row(const Dropout& drop, int b, int h, int H, int row, int col8) {
  const unsigned long long panel = drop.seed + static_cast<unsigned long long>(b) * H + h;
  return philox(make_uint4(static_cast<uint32_t>(col8), static_cast<uint32_t>(row), 0u, 0u),
                make_uint2(static_cast<uint32_t>(panel), static_cast<uint32_t>(panel >> 32)));
}

__device__ __forceinline__ uint32_t word_of(const uint4& w, int i) {
  return i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w;
}

__device__ __forceinline__ bool given_keep(const Dropout& drop, int b, int h, int H, int L, int row, int col) {
  if (row >= L || col >= L) return true;
  return drop.keep[((static_cast<long long>(b) * H + h) * L + row) * L + col] != 0;
}

// Keep bits of a lane's elements of the n-tiles j0 = col0 / 8 and j0 + 1 in
// the C layout (rows row0 + g, row0 + g + 8; columns 8 j + 2 t, + 1): bit
// 4 i + e for n-tile j0 + i and fragment element e (e / 2: the row, e % 2: the
// column). With Philox lane t draws the pair (row0 + g + 8 (t % 2), group
// col0 / 8 + t / 2), and in round r reads word t of lane (t - r) % 4's pair.
template <int kMode>
__device__ __forceinline__ uint32_t keep_bits(const Dropout& drop, int b, int h, int H, int L, int row0, int col0,
                                              int lane) {
  const int g = lane >> 2, t = lane & 3;
  uint32_t bits = 0;
  if constexpr (kMode == kModePhilox) {
    const uint4 w = philox_row(drop, b, h, H, row0 + g + 8 * (t & 1), (col0 >> 3) + (t >> 1));
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const uint32_t got = __shfl_sync(0xffffffffu, word_of(w, (r + t) & 3), (lane & ~3) | ((t - r) & 3));
      const int c = (t - r) & 3;
      const int shift = 4 * (c >> 1) + 2 * (c & 1);
      bits |= (((got << 16) >= drop.threshold ? 1u : 0u) | (got >= drop.threshold ? 2u : 0u)) << shift;
    }
  } else if constexpr (kMode == kModeGiven) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (given_keep(drop, b, h, H, L, row0 + g + 8 * (e >> 1), col0 + 8 * i + 2 * t + (e & 1)))
          bits |= 1u << (4 * i + e);
  } else {
    bits = 0xffu;
  }
  return bits;
}

// The same for the dK/dV launch, whose rows are keys (key0 + g, key0 + g + 8)
// and whose columns are query rows (query0 + 8 j + 2 t, + 1). With Philox the
// eight lanes that share t draw the pairs (query0 + 2 t + g % 2 + 8 (g / 2 % 2),
// key group key0 / 8 + g / 4), pack the eight keys' bits, and each lane takes
// its key's bit of the lane holding its (query, group).
template <int kMode>
__device__ __forceinline__ uint32_t keep_bits_transposed(const Dropout& drop, int b, int h, int H, int L, int key0,
                                                         int query0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  uint32_t bits = 0;
  if constexpr (kMode == kModePhilox) {
    const uint4 w = philox_row(drop, b, h, H, query0 + 2 * t + (g & 1) + 8 * ((g >> 1) & 1), (key0 >> 3) + (g >> 2));
    uint32_t packed = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t x = word_of(w, i);
      packed |= ((x << 16) >= drop.threshold ? 1u : 0u) << (2 * i);
      packed |= (x >= drop.threshold ? 1u : 0u) << (2 * i + 1);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int grp = 0; grp < 2; ++grp) {
        const uint32_t got = __shfl_sync(0xffffffffu, packed, 4 * (q + 4 * grp) + t);
        bits |= ((got >> g) & 1u) << (4 * (q >> 1) + 2 * grp + (q & 1));
      }
  } else if constexpr (kMode == kModeGiven) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (given_keep(drop, b, h, H, L, query0 + 8 * i + 2 * t + (e & 1), key0 + g + 8 * (e >> 1)))
          bits |= 1u << (4 * i + e);
  } else {
    bits = 0xffu;
  }
  return bits;
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

__device__ __forceinline__ void mma(float d[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// A fragments of a warp's 16 rows row0 .. row0 + 15 of x, the four k-steps of
// the head dimension: a[kk] = {A[g][16 kk + 2t..], A[g + 8][..], A[g][16 kk +
// 8 + 2t..], A[g + 8][..]}; rows beyond L are zeros.
__device__ __forceinline__ void load_a(uint32_t a[4][4], const bf16* __restrict__ x, int b, int h, int row0, int L,
                                       int H, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    const uint32_t* p = reinterpret_cast<const uint32_t*>(x + row_offset(b, row < L ? row : 0, h, L, H));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      a[kk][r] = row < L ? __ldg(p + 8 * kk + t) : 0u;
      a[kk][2 + r] = row < L ? __ldg(p + 8 * kk + 4 + t) : 0u;
    }
  }
}

// Rows row0 .. row0 + kTileRows - 1 of x into a shared tile, zeros beyond L.
template <int kTileRows>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* __restrict__ x, int b, int h, int row0, int L,
                                          int H) {
  for (int i = threadIdx.x; i < kTileRows * 8; i += kThreads) {
    const int row = i >> 3, chunk = i & 7;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + row < L) v = __ldg(reinterpret_cast<const uint4*>(x + row_offset(b, row0 + row, h, L, H)) + chunk);
    *reinterpret_cast<uint4*>(tile + row * kLd + 8 * chunk) = v;
  }
}

// s[j] = A B^T over the head dimension for the tile's rows 8 j + g (B = the
// tile, row-major: the warp's rows times the tile's rows).
template <int kN>
__device__ __forceinline__ void products(float (*s)[4], const uint32_t a[4][4], const bf16* tile, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    const uint32_t* p = reinterpret_cast<const uint32_t*>(tile + (8 * j + g) * kLd) + t;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma(s[j], a[kk], p[8 * kk], p[8 * kk + 4]);
  }
}

// acc += P T with P the C fragments p (kN columns, rounded to bf16 here: the
// A operand) and T the tile, row-major [kN rows][64], read by ldmatrix.trans.
template <int kN>
__device__ __forceinline__ void accumulate(float acc[8][4], const float (*p)[4], const bf16* tile, int lane) {
#pragma unroll
  for (int kk = 0; kk < kN / 16; ++kk) {
    const uint32_t a[4] = {pack(p[2 * kk][0], p[2 * kk][1]), pack(p[2 * kk][2], p[2 * kk][3]),
                           pack(p[2 * kk + 1][0], p[2 * kk + 1][1]), pack(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, tile + (16 * kk + (lane & 15)) * kLd + 16 * jj + 8 * (lane >> 4));
      mma(acc[2 * jj], a, r[0], r[1]);
      mma(acc[2 * jj + 1], a, r[2], r[3]);
    }
  }
}

// A row of 64 outputs from the fragments (rows g, g + 8; columns 8 j + 2t, + 1),
// times mult[r], in bf16; rows beyond L are left out.
__device__ __forceinline__ void store_rows(bf16* __restrict__ out, const float acc[8][4], const float mult[2], int b,
                                           int h, int row0, int L, int H, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= L) continue;
    uint32_t* p = reinterpret_cast<uint32_t*>(out + row_offset(b, row, h, L, H)) + t;
#pragma unroll
    for (int j = 0; j < 8; ++j) p[4 * j] = pack(acc[j][2 * r] * mult[r], acc[j][2 * r + 1] * mult[r]);
  }
}

__device__ __forceinline__ float row_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// A row whose every key is padded scores the bias at every key: m = -1e30
// log2(e), and lse = m + log2(L) rounds to m, so exp2(s - lse) would be 1, not
// 1 / L. The backward takes exp2((s - lse) - shift), shift = log2(L) on such a
// row and 0 elsewhere (dropout_attention.cu's rule).
constexpr float kPaddedRow = -1e29f;

__device__ __forceinline__ float padded_row_shift(float lse, int L) {
  return lse <= kPaddedRow ? log2f(static_cast<float>(L)) : 0.f;
}

template <int kMode>
__global__ void __launch_bounds__(kThreads) fwd(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                                const bf16* __restrict__ v, const float* __restrict__ bias,
                                                Dropout drop, float scale, bf16* __restrict__ o,
                                                float* __restrict__ lse, int L, int H) {
  __shared__ alignas(16) bf16 k_tile[kFwdKeys * kLd];
  __shared__ alignas(16) bf16 v_tile[kFwdKeys * kLd];
  __shared__ float tile_bias[kFwdKeys];
  resolve_seed<kMode>(drop);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * kRows + (threadIdx.x >> 5) * 16;
  uint32_t qa[4][4];
  load_a(qa, q, b, h, row0, L, H, lane);
  const float c = scale * kLog2e;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  for (int key0 = 0; key0 < L; key0 += kFwdKeys) {
    __syncthreads();
    load_tile<kFwdKeys>(k_tile, k, b, h, key0, L, H);
    load_tile<kFwdKeys>(v_tile, v, b, h, key0, L, H);
    if (threadIdx.x < kFwdKeys)
      tile_bias[threadIdx.x] = key0 + threadIdx.x < L ? bias[static_cast<long long>(b) * L + key0 + threadIdx.x] * kLog2e
                                                      : -INFINITY;
    __syncthreads();
    float s[8][4];
    products<kFwdKeys>(s, qa, k_tile, lane);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = s[j][e] * c + tile_bias[8 * j + 2 * t + (e & 1)];
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = row_max(mx[r]);
      alpha[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      const uint32_t bits = keep_bits<kMode>(drop, b, h, H, L, row0, key0 + 16 * jp, lane);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[2 * jp + i][e] - m[e >> 1]);
          l[e >> 1] += p;
          s[2 * jp + i][e] = (bits >> (4 * i + e)) & 1u ? p : 0.f;
        }
    }
    accumulate<kFwdKeys>(acc, s, v_tile, lane);
  }
  float mult[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = row_sum(l[r]);
    mult[r] = drop.inv_keep / l[r];
    const int row = row0 + g + 8 * r;
    if (t == 0 && row < L) lse[(static_cast<long long>(b) * H + h) * L + row] = m[r] + log2f(l[r]);
  }
  store_rows(o, acc, mult, b, h, row0, L, H, lane);
}

template <int kMode>
__global__ void __launch_bounds__(kThreads) dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                                      const bf16* __restrict__ v, const float* __restrict__ bias,
                                                      Dropout drop, float scale, const bf16* __restrict__ o,
                                                      const bf16* __restrict__ dout, const float* __restrict__ lse,
                                                      float* __restrict__ delta, bf16* __restrict__ dq, int L,
                                                      int H) {
  __shared__ alignas(16) bf16 k_tile[kBwdCols * kLd];
  __shared__ alignas(16) bf16 v_tile[kBwdCols * kLd];
  __shared__ float tile_bias[kBwdCols];
  resolve_seed<kMode>(drop);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * kRows + (threadIdx.x >> 5) * 16;
  const long long stats = (static_cast<long long>(b) * H + h) * L;
  // delta = rowsum(dO * O): the four lanes of a row take 16 columns each
  float row_delta[2], row_lse[2], row_shift[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    float sum = 0.f;
    if (row < L) {
      const uint4* po = reinterpret_cast<const uint4*>(o + row_offset(b, row, h, L, H) + 16 * t);
      const uint4* pd = reinterpret_cast<const uint4*>(dout + row_offset(b, row, h, L, H) + 16 * t);
#pragma unroll
      for (int chunk = 0; chunk < 2; ++chunk) {
        const uint4 x = __ldg(po + chunk), y = __ldg(pd + chunk);
        const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 a = unpack(xs[i]), d = unpack(ys[i]);
          sum += a.x * d.x + a.y * d.y;
        }
      }
    }
    row_delta[r] = row_sum(sum);
    if (t == 0 && row < L) delta[stats + row] = row_delta[r];
    row_lse[r] = row < L ? lse[stats + row] : 0.f;
    row_shift[r] = padded_row_shift(row_lse[r], L);
  }
  uint32_t qa[4][4], da[4][4];
  load_a(qa, q, b, h, row0, L, H, lane);
  load_a(da, dout, b, h, row0, L, H, lane);
  const float c = scale * kLog2e;
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  for (int key0 = 0; key0 < L; key0 += kBwdCols) {
    __syncthreads();
    load_tile<kBwdCols>(k_tile, k, b, h, key0, L, H);
    load_tile<kBwdCols>(v_tile, v, b, h, key0, L, H);
    if (threadIdx.x < kBwdCols)
      tile_bias[threadIdx.x] = key0 + threadIdx.x < L ? bias[static_cast<long long>(b) * L + key0 + threadIdx.x] * kLog2e
                                                      : -INFINITY;
    __syncthreads();
    float s[4][4], dp[4][4];
    products<kBwdCols>(s, qa, k_tile, lane);
    products<kBwdCols>(dp, da, v_tile, lane);
#pragma unroll
    for (int jp = 0; jp < 2; ++jp) {
      const uint32_t bits = keep_bits<kMode>(drop, b, h, H, L, row0, key0 + 16 * jp, lane);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 2 * jp + i, r = e >> 1;
          const float p = exp2f((s[j][e] * c + tile_bias[8 * j + 2 * t + (e & 1)] - row_lse[r]) - row_shift[r]);
          const float dpv = (bits >> (4 * i + e)) & 1u ? dp[j][e] * drop.inv_keep : 0.f;
          s[j][e] = p * (dpv - row_delta[r]);
        }
    }
    accumulate<kBwdCols>(acc, s, k_tile, lane);
  }
  const float mult[2] = {scale, scale};
  store_rows(dq, acc, mult, b, h, row0, L, H, lane);
}

template <int kMode>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                                        const bf16* __restrict__ v, const float* __restrict__ bias,
                                                        Dropout drop, float scale, const bf16* __restrict__ dout,
                                                        const float* __restrict__ lse,
                                                        const float* __restrict__ delta, bf16* __restrict__ dk,
                                                        bf16* __restrict__ dv, int L, int H) {
  __shared__ alignas(16) bf16 q_tile[kBwdCols * kLd];
  __shared__ alignas(16) bf16 do_tile[kBwdCols * kLd];
  __shared__ float tile_lse[kBwdCols], tile_delta[kBwdCols], tile_shift[kBwdCols];
  resolve_seed<kMode>(drop);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, key0 = blockIdx.x * kRows + (threadIdx.x >> 5) * 16;
  const long long stats = (static_cast<long long>(b) * H + h) * L;
  uint32_t ka[4][4], va[4][4];
  load_a(ka, k, b, h, key0, L, H, lane);
  load_a(va, v, b, h, key0, L, H, lane);
  float key_bias[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + g + 8 * r;
    key_bias[r] = key < L ? bias[static_cast<long long>(b) * L + key] * kLog2e : -INFINITY;
  }
  const float c = scale * kLog2e;
  float dk_acc[8][4], dv_acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;
  for (int query0 = 0; query0 < L; query0 += kBwdCols) {
    __syncthreads();
    load_tile<kBwdCols>(q_tile, q, b, h, query0, L, H);
    load_tile<kBwdCols>(do_tile, dout, b, h, query0, L, H);
    if (threadIdx.x < kBwdCols) {
      const int row = query0 + threadIdx.x;
      const float row_lse = row < L ? lse[stats + row] : 0.f;
      tile_lse[threadIdx.x] = row_lse;
      tile_shift[threadIdx.x] = padded_row_shift(row_lse, L);
      tile_delta[threadIdx.x] = row < L ? delta[stats + row] : 0.f;
    }
    __syncthreads();
    float s[4][4], dp[4][4], pd[4][4];
    products<kBwdCols>(s, ka, q_tile, lane);
    products<kBwdCols>(dp, va, do_tile, lane);
#pragma unroll
    for (int jp = 0; jp < 2; ++jp) {
      const uint32_t bits = keep_bits_transposed<kMode>(drop, b, h, H, L, key0, query0 + 16 * jp, lane);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 2 * jp + i, col = 8 * j + 2 * t + (e & 1);
          const bool kept = (bits >> (4 * i + e)) & 1u;
          const float p = query0 + col < L
                              ? exp2f((s[j][e] * c + key_bias[e >> 1] - tile_lse[col]) - tile_shift[col])
                              : 0.f;
          pd[j][e] = kept ? p * drop.inv_keep : 0.f;
          const float dpv = kept ? dp[j][e] * drop.inv_keep : 0.f;
          s[j][e] = p * (dpv - tile_delta[col]);
        }
    }
    accumulate<kBwdCols>(dv_acc, pd, do_tile, lane);
    accumulate<kBwdCols>(dk_acc, s, q_tile, lane);
  }
  const float dk_mult[2] = {scale, scale}, dv_mult[2] = {1.f, 1.f};
  store_rows(dk, dk_acc, dk_mult, b, h, key0, L, H, lane);
  store_rows(dv, dv_acc, dv_mult, b, h, key0, L, H, lane);
}

cudaError_t check_and_enter(int B, int L, int H, int mode, float p, const void* keep, int device, int* previous) {
  if (B < 1 || H < 1 || L < 1 || (L + kRows - 1) / kRows > 65535 || H > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  if (mode < kModeNone || mode > kModeGiven || (mode == kModeGiven && keep == nullptr) ||
      (mode == kModeNone) != (p == 0.f) || !(p >= 0.f && p < 1.f))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaGetDevice(previous);
  if (err != cudaSuccess) return err;
  return cudaSetDevice(device);
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

// K3a on bf16. o: [B, L, H, 64] bf16; lse: [B, H, L] fp32, base 2. mode 0: no
// dropout (p must be 0); 1: Philox from `seed`, plus the int64 at `seed_ptr`
// (device memory) unless it is null; 2: `keep` given.
int k3_bf16_forward(const void* q, const void* k, const void* v, const void* bias, int mode, unsigned long long seed,
                    const void* seed_ptr, const void* keep, float p, float scale, void* o, void* lse, int B, int L,
                    int H, int device, void* stream) {
  int previous = 0;
  cudaError_t err = check_and_enter(B, L, H, mode, p, keep, device, &previous);
  if (err == cudaSuccess) {
    const auto kernel = mode == kModeNone ? fwd<kModeNone> : mode == kModePhilox ? fwd<kModePhilox> : fwd<kModeGiven>;
    kernel<<<dim3((L + kRows - 1) / kRows, H, B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const float*>(bias), make_dropout(seed, seed_ptr, keep, p), scale, static_cast<bf16*>(o),
        static_cast<float*>(lse), L, H);
    err = cudaGetLastError();
  }
  if (previous != device) cudaSetDevice(previous);
  return static_cast<int>(err);
}

// K3b on bf16. lse: K3a's; delta: [B, H, L] fp32 scratch; dq, dk, dv: [B, L, H, 64] bf16.
int k3_bf16_backward(const void* q, const void* k, const void* v, const void* bias, int mode, unsigned long long seed,
                     const void* seed_ptr, const void* keep, float p, float scale, const void* o, const void* dout,
                     const void* lse, void* delta, void* dq, void* dk, void* dv, int B, int L, int H, int device,
                     void* stream) {
  int previous = 0;
  cudaError_t err = check_and_enter(B, L, H, mode, p, keep, device, &previous);
  const Dropout drop = make_dropout(seed, seed_ptr, keep, p);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((L + kRows - 1) / kRows, H, B);
  if (err == cudaSuccess) {
    const auto kernel = mode == kModeNone     ? dq_kernel<kModeNone>
                        : mode == kModePhilox ? dq_kernel<kModePhilox>
                                              : dq_kernel<kModeGiven>;
    kernel<<<grid, kThreads, 0, s>>>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                     static_cast<const bf16*>(v), static_cast<const float*>(bias), drop, scale,
                                     static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
                                     static_cast<const float*>(lse), static_cast<float*>(delta),
                                     static_cast<bf16*>(dq), L, H);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess) {
    const auto kernel = mode == kModeNone     ? dkdv_kernel<kModeNone>
                        : mode == kModePhilox ? dkdv_kernel<kModePhilox>
                                              : dkdv_kernel<kModeGiven>;
    kernel<<<grid, kThreads, 0, s>>>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                     static_cast<const bf16*>(v), static_cast<const float*>(bias), drop, scale,
                                     static_cast<const bf16*>(dout), static_cast<const float*>(lse),
                                     static_cast<const float*>(delta), static_cast<bf16*>(dk),
                                     static_cast<bf16*>(dv), L, H);
    err = cudaGetLastError();
  }
  if (previous != device) cudaSetDevice(previous);
  return static_cast<int>(err);
}

}  // extern "C"
