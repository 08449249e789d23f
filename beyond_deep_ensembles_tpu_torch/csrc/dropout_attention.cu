// K3a and K3b: self-attention with dropout on the probabilities, forward and
// backward, as CUDA kernels for Hopper (sm_90a), in fp32 throughout.
//
// Replaces the TPU kernels beyond_deep_ensembles_tpu/ops/attention.py:84
// `_fwd_kernel` (K3a, launched by `_fwd_call`) and :101 `_bwd_kernel` (K3b,
// launched by `_bwd_call`). Each of those holds one whole (batch, head) panel,
// [L, L] scores included, in VMEM. A Hopper block has at most 227 KB of shared
// memory and has to share the SM with others, so here the panel is cut into
// tiles of 64 query rows by 64 key columns and nothing [L, L]-shaped is ever
// stored in device memory (but for the debug output of K3a).
//
// Layout: q, k, v, o, dO, dq, dk, dv are [B, L, H, 64] fp32, contiguous (the
// port's public layout, so no transposes are needed around the kernels); bias
// is [B, L] fp32, 0 for a key that is attended and -1e30 for a padded one;
// lse and delta are [B, H, L] fp32; a given keep mask is uint8 [B, H, L, L].
// L must be a multiple of 64 and the head dimension 64.
//
// Semantics (those of the JAX kernels): S = Q K^T * scale + bias, P =
// softmax(S) over all keys (the row sum runs over the undropped values),
// dropout on P: an element is kept with its uniform u >= p and then scaled by
// 1 / (1 - p), O = P_drop V. The backward gives dV = P_drop^T dO, dP =
// drop(dO V^T), dS = P * (dP - rowsum(dP * P)), dQ = dS K scale, dK = dS^T Q
// scale. rowsum(dP * P) = rowsum(dO * O) per query row (O = P_drop V), so the
// backward takes it from dO and O (`delta`), as flash attention does.
//
// Dropout mask, three modes: none (p = 0); Philox-4x32-10 keyed by the panel
// seed `seed + b H + h` (the JAX kernel's per-(b, h) seeding) with the
// counter (col / 4, row), whose four 32-bit words give the uniforms of four
// neighbouring columns, so that K3b regenerates the mask of K3a bit for bit
// from (seed, b, h, row, col) alone; or a given uint8 keep mask.
//
// Kernels. Blocks of 256 threads as 16 x 16; each thread owns a 4 x 4
// micro-tile of every 64 x 64 product; operands come from shared memory,
// stored so that a thread reads four neighbouring values as one float4.
//   K3a `attn_forward`: a block per (64 query rows, h, b) walks the key tiles
//     with an online softmax (running max m and row sum l, the sum over the
//     undropped exponentials, the kept ones accumulated into O), then writes
//     O / (l (1 - p)) and lse = m + log l. With `probs` it walks the key tiles
//     a second time and writes the realized P_drop (debug only).
//   K3b, two launches, no atomics, so every sum runs in a fixed order and
//     repeat runs agree bit for bit:
//     `attn_backward_dq`: a block per query tile computes delta for its rows
//       (written out for the next launch), walks the key tiles recomputing S,
//       P and dP, and accumulates dQ;
//     `attn_backward_dkdv`: a block per key tile walks the query tiles
//       recomputing S^T, P, dP and accumulates dK and dV.
//   The split recomputes S and dO V^T once more than a single pass with an
//   atomic dQ would (14 L^2 D operations per panel instead of 10).
//
// Bound: operations. K3a does 4 B H L^2 D fp32 operations and moves 16 B L H D
// bytes (q, k, v in, o out) plus the bias and lse: at (8, 12, 512, 64) 6.44
// GFLOP (96 us at 67 TFLOP/s) against 50 MB (15 us at 3.35 TB/s); K3b's
// 10 B H L^2 D is 16.1 GFLOP (240 us) against about 100 MB (q, k, v, o, dO
// in, dq, dk, dv out). The products run as fp32 FMAs, not TF32 tensor-core products,
// so that the card's results hold to the CPU path; the tiles keep the
// operations per shared-memory load at 16 per 8 floats read.
//
// C interface for ctypes: each function returns cudaGetLastError() after its
// launches (0 on success), launches on the given stream and does not
// synchronise.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;                 // head dimension
constexpr int kTile = 64;              // query rows and key columns of a tile
constexpr int kThreads = 256;          // 16 x 16, a 4 x 4 micro-tile each
constexpr int kPitch = kTile + 4;      // row pitch (floats) of tiles read along their rows
constexpr int kTileT = kD * kPitch;    // floats of a transposed [64][kPitch] tile
constexpr int kTileR = kTile * kD;     // floats of a row-major [64][64] tile
constexpr int kModeNone = 0, kModePhilox = 1, kModeGiven = 2;

struct Dropout {
  int mode;
  unsigned long long seed;    // Philox: the step's seed (the panel adds b H + h)
  const uint8_t* keep;        // given: [B, H, L, L]
  float p;                    // drop probability
  float inv_keep;             // 1 / (1 - p)
};

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

__device__ __forceinline__ bool keep_bit(uint32_t bits, float p) {
  return static_cast<float>(bits >> 8) * 5.9604644775390625e-8f >= p;  // u in [0, 1), 24 bits
}

// Keep flags of row `row`, columns 4 col4 .. 4 col4 + 3, of panel (b, h).
__device__ __forceinline__ void keep4(const Dropout& drop, int b, int h, int H, int L, int row, int col4,
                                      bool out[4]) {
  if (drop.mode == kModePhilox) {
    const unsigned long long panel = drop.seed + static_cast<unsigned long long>(b) * H + h;
    const uint4 r = philox(make_uint4(static_cast<uint32_t>(col4), static_cast<uint32_t>(row), 0u, 0u),
                           make_uint2(static_cast<uint32_t>(panel), static_cast<uint32_t>(panel >> 32)));
    out[0] = keep_bit(r.x, drop.p);
    out[1] = keep_bit(r.y, drop.p);
    out[2] = keep_bit(r.z, drop.p);
    out[3] = keep_bit(r.w, drop.p);
  } else if (drop.mode == kModeGiven) {
    const uchar4 m = *reinterpret_cast<const uchar4*>(
        drop.keep + ((static_cast<long long>(b) * H + h) * L + row) * L + 4 * col4);
    out[0] = m.x != 0;
    out[1] = m.y != 0;
    out[2] = m.z != 0;
    out[3] = m.w != 0;
  } else {
    out[0] = out[1] = out[2] = out[3] = true;
  }
}

// Rows r0 .. r0 + 63 of panel (b, h) of x into t[d][row] (pitch kPitch). A
// warp takes 32 rows of one float4 column, so the transposing stores hit 32
// different banks.
__device__ __forceinline__ void load_transposed(float* t, const float* __restrict__ x, int b, int h, int r0,
                                                int L, int H) {
#pragma unroll
  for (int i = 0; i < kTileR / 4 / kThreads; ++i) {
    const int f = threadIdx.x + kThreads * i;
    const int row = f & (kTile - 1), c4 = f / kTile;
    const float4 v = __ldg(reinterpret_cast<const float4*>(x + row_offset(b, r0 + row, h, L, H)) + c4);
    t[(4 * c4 + 0) * kPitch + row] = v.x;
    t[(4 * c4 + 1) * kPitch + row] = v.y;
    t[(4 * c4 + 2) * kPitch + row] = v.z;
    t[(4 * c4 + 3) * kPitch + row] = v.w;
  }
}

// Rows r0 .. r0 + 63 of panel (b, h) of x into r[row][d] (pitch kD), coalesced.
__device__ __forceinline__ void load_rows(float* r, const float* __restrict__ x, int b, int h, int r0, int L,
                                          int H) {
#pragma unroll
  for (int i = 0; i < kTileR / 4 / kThreads; ++i) {
    const int f = threadIdx.x + kThreads * i;
    const int row = f / (kD / 4), c4 = f % (kD / 4);
    reinterpret_cast<float4*>(r + row * kD)[c4] =
        __ldg(reinterpret_cast<const float4*>(x + row_offset(b, r0 + row, h, L, H)) + c4);
  }
}

// acc[i][j] += sum_k a[k][4 ty + i] * b[k][4 tx + j], k < 64.
__device__ __forceinline__ void product(float acc[4][4], const float* a, int a_pitch, const float* b, int b_pitch,
                                        int ty, int tx) {
#pragma unroll 8
  for (int k = 0; k < 64; ++k) {
    const float4 av = *reinterpret_cast<const float4*>(a + k * a_pitch + 4 * ty);
    const float4 bv = *reinterpret_cast<const float4*>(b + k * b_pitch + 4 * tx);
    const float ar[4] = {av.x, av.y, av.z, av.w}, br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
  }
}

// Max and sum over the 16 threads that share ty (lanes 0-15 or 16-31 of a warp).
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int offset = 8; offset > 0; offset >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, offset));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int offset = 8; offset > 0; offset >>= 1) v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
}

__device__ __forceinline__ void zero(float a[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[i][j] = 0.f;
}

// Shared memory of each kernel, in floats.
constexpr int kForwardFloats = 3 * kTileT + kTileR + kTile;   // qt, kt, pt; vr; bias
constexpr int kDqFloats = 3 * kTileT + kTileR + 3 * kTile;    // qt, dot, kt/dst; kr; bias, lse, delta
constexpr int kDkdvFloats = 4 * kTileT + 2 * kTileR + 3 * kTile;  // kt, vt, qt/ps, dot/dss; qr, dor; bias, lse, delta

__global__ void __launch_bounds__(kThreads, 2)
attn_forward(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
             const float* __restrict__ bias, Dropout drop, float scale, float* __restrict__ o,
             float* __restrict__ lse, float* __restrict__ probs, int L, int H) {
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // Q^T  [d][i]
  float* kt = qt + kTileT;                      // K^T  [d][j]
  float* pt = kt + kTileT;                      // P^T  [j][i], the kept exponentials
  float* vr = pt + kTileT;                      // V    [j][d]
  float* bias_s = vr + kTileR;                  // bias [j]
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int i0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;

  load_transposed(qt, q, b, h, i0, L, H);
  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }
  zero(acc);

  for (int j0 = 0; j0 < L; j0 += kTile) {
    __syncthreads();  // the previous tile's kt, pt and vr are read
    load_transposed(kt, k, b, h, j0, L, H);
    load_rows(vr, v, b, h, j0, L, H);
    if (tid < kTile) bias_s[tid] = bias[static_cast<long long>(b) * L + j0 + tid];
    __syncthreads();
    float s[4][4];
    zero(s);
    product(s, qt, kPitch, kt, kPitch, ty, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float tile_max = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = fmaf(s[r][c], scale, bias_s[4 * tx + c]);
        tile_max = fmaxf(tile_max, s[r][c]);
      }
      const float m_new = fmaxf(m[r], row_max(tile_max));
      const float correction = expf(m[r] - m_new);  // 0 on the first tile
      m[r] = m_new;
      bool kept[4];
      keep4(drop, b, h, H, L, i0 + 4 * ty + r, (j0 >> 2) + tx, kept);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float e = expf(s[r][c] - m_new);
        sum += e;
        pt[(4 * tx + c) * kPitch + 4 * ty + r] = kept[c] ? e : 0.f;
      }
      l[r] = l[r] * correction + row_sum(sum);
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] *= correction;
    }
    __syncthreads();
    product(acc, pt, kPitch, vr, kD, ty, tx);
  }

  float row_lse[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = i0 + 4 * ty + r;
    const float denom = l[r] * (1.f - drop.p);
    reinterpret_cast<float4*>(o + row_offset(b, row, h, L, H))[tx] =
        make_float4(acc[r][0] / denom, acc[r][1] / denom, acc[r][2] / denom, acc[r][3] / denom);
    row_lse[r] = m[r] + logf(l[r]);
    if (tx == 0) lse[(static_cast<long long>(b) * H + h) * L + row] = row_lse[r];
  }
  if (probs == nullptr) return;

  // debug: the realized probabilities, exp(s - lse) kept and scaled, [B, H, L, L]
  for (int j0 = 0; j0 < L; j0 += kTile) {
    __syncthreads();
    load_transposed(kt, k, b, h, j0, L, H);
    if (tid < kTile) bias_s[tid] = bias[static_cast<long long>(b) * L + j0 + tid];
    __syncthreads();
    float s[4][4];
    zero(s);
    product(s, qt, kPitch, kt, kPitch, ty, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = i0 + 4 * ty + r;
      bool kept[4];
      keep4(drop, b, h, H, L, row, (j0 >> 2) + tx, kept);
      float out[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        out[c] = kept[c] ? expf(fmaf(s[r][c], scale, bias_s[4 * tx + c]) - row_lse[r]) * drop.inv_keep : 0.f;
      reinterpret_cast<float4*>(probs + ((static_cast<long long>(b) * H + h) * L + row) * L + j0)[tx] =
          make_float4(out[0], out[1], out[2], out[3]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
attn_backward_dq(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                 const float* __restrict__ bias, Dropout drop, float scale, const float* __restrict__ o,
                 const float* __restrict__ dout, const float* __restrict__ lse, float* __restrict__ delta,
                 float* __restrict__ dq, int L, int H) {
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // Q^T  [d][i]
  float* dot = qt + kTileT;                     // dO^T [d][i]
  float* kt = dot + kTileT;                     // K^T  [d][j], then dS^T [j][i]
  float* kr = kt + kTileT;                      // K    [j][d]
  float* bias_s = kr + kTileR;                  // bias [j]
  float* lse_s = bias_s + kTile;                // lse  [i]
  float* delta_s = lse_s + kTile;               // delta [i]
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int i0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const long long stat0 = (static_cast<long long>(b) * H + h) * L + i0;

  load_transposed(qt, q, b, h, i0, L, H);
  load_transposed(dot, dout, b, h, i0, L, H);
  {
    // delta = rowsum(dO * O): four threads a row, 16 columns each
    const int row = tid >> 2, part = tid & 3;
    const float4* orow = reinterpret_cast<const float4*>(o + row_offset(b, i0 + row, h, L, H)) + 4 * part;
    const float4* drow = reinterpret_cast<const float4*>(dout + row_offset(b, i0 + row, h, L, H)) + 4 * part;
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float4 a = __ldg(orow + c), g = __ldg(drow + c);
      sum = fmaf(a.x, g.x, fmaf(a.y, g.y, fmaf(a.z, g.z, fmaf(a.w, g.w, sum))));
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (part == 0) {
      delta_s[row] = sum;
      delta[stat0 + row] = sum;
      lse_s[row] = lse[stat0 + row];
    }
  }
  float acc[4][4];
  zero(acc);

  for (int j0 = 0; j0 < L; j0 += kTile) {
    __syncthreads();  // the previous tile's dS^T and kr are read
    load_transposed(kt, k, b, h, j0, L, H);
    load_rows(kr, k, b, h, j0, L, H);
    if (tid < kTile) bias_s[tid] = bias[static_cast<long long>(b) * L + j0 + tid];
    __syncthreads();
    float s[4][4], dp[4][4];
    zero(s);
    zero(dp);
    product(s, qt, kPitch, kt, kPitch, ty, tx);
    // dO V^T: V^T is read straight from the transposed tile loaded into kt's
    // place after S is done with it
    __syncthreads();
    load_transposed(kt, v, b, h, j0, L, H);
    __syncthreads();
    product(dp, dot, kPitch, kt, kPitch, ty, tx);
    __syncthreads();  // kt is overwritten with dS^T below
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = 4 * ty + r;
      bool kept[4];
      keep4(drop, b, h, H, L, i0 + row, (j0 >> 2) + tx, kept);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(fmaf(s[r][c], scale, bias_s[4 * tx + c]) - lse_s[row]);
        const float dpk = kept[c] ? dp[r][c] * drop.inv_keep : 0.f;
        kt[(4 * tx + c) * kPitch + row] = p * (dpk - delta_s[row]);
      }
    }
    __syncthreads();
    product(acc, kt, kPitch, kr, kD, ty, tx);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
    reinterpret_cast<float4*>(dq + row_offset(b, i0 + 4 * ty + r, h, L, H))[tx] =
        make_float4(acc[r][0] * scale, acc[r][1] * scale, acc[r][2] * scale, acc[r][3] * scale);
}

__global__ void __launch_bounds__(kThreads, 2)
attn_backward_dkdv(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                   const float* __restrict__ bias, Dropout drop, float scale, const float* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dk,
                   float* __restrict__ dv, int L, int H) {
  extern __shared__ float4 smem4[];
  float* kt = reinterpret_cast<float*>(smem4);  // K^T  [d][j]
  float* vt = kt + kTileT;                      // V^T  [d][j]
  float* qt = vt + kTileT;                      // Q^T  [d][i], then P_drop [i][j]
  float* dot = qt + kTileT;                     // dO^T [d][i], then dS [i][j]
  float* qr = dot + kTileT;                     // Q    [i][d]
  float* dor = qr + kTileR;                     // dO   [i][d]
  float* bias_s = dor + kTileR;                 // bias [j]
  float* lse_s = bias_s + kTile;                // lse  [i]
  float* delta_s = lse_s + kTile;               // delta [i]
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int j0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const long long stat = (static_cast<long long>(b) * H + h) * L;

  load_transposed(kt, k, b, h, j0, L, H);
  load_transposed(vt, v, b, h, j0, L, H);
  if (tid < kTile) bias_s[tid] = bias[static_cast<long long>(b) * L + j0 + tid];
  float acc_dk[4][4], acc_dv[4][4];
  zero(acc_dk);
  zero(acc_dv);

  for (int i0 = 0; i0 < L; i0 += kTile) {
    __syncthreads();  // the previous tile's P_drop, dS, qr and dor are read
    load_transposed(qt, q, b, h, i0, L, H);
    load_transposed(dot, dout, b, h, i0, L, H);
    load_rows(qr, q, b, h, i0, L, H);
    load_rows(dor, dout, b, h, i0, L, H);
    if (tid < kTile) {
      lse_s[tid] = lse[stat + i0 + tid];
      delta_s[tid] = delta[stat + i0 + tid];
    }
    __syncthreads();
    // S^T and (dO V^T)^T, rows j = 4 ty + r, columns i = 4 tx + c
    float st[4][4], dpt[4][4];
    zero(st);
    zero(dpt);
    product(st, kt, kPitch, qt, kPitch, ty, tx);
    product(dpt, vt, kPitch, dot, kPitch, ty, tx);
    __syncthreads();  // qt and dot are overwritten with P_drop and dS below
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = 4 * tx + c;  // query row i within the tile
      bool kept[4];                // for keys j = 4 ty .. 4 ty + 3
      keep4(drop, b, h, H, L, i0 + col, (j0 >> 2) + ty, kept);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float p = expf(fmaf(st[r][c], scale, bias_s[4 * ty + r]) - lse_s[col]);
        const float dpk = kept[r] ? dpt[r][c] * drop.inv_keep : 0.f;
        qt[col * kPitch + 4 * ty + r] = kept[r] ? p * drop.inv_keep : 0.f;
        dot[col * kPitch + 4 * ty + r] = p * (dpk - delta_s[col]);
      }
    }
    __syncthreads();
    product(acc_dv, qt, kPitch, dor, kD, ty, tx);
    product(acc_dk, dot, kPitch, qr, kD, ty, tx);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const long long off = row_offset(b, j0 + 4 * ty + r, h, L, H);
    reinterpret_cast<float4*>(dk + off)[tx] =
        make_float4(acc_dk[r][0] * scale, acc_dk[r][1] * scale, acc_dk[r][2] * scale, acc_dk[r][3] * scale);
    reinterpret_cast<float4*>(dv + off)[tx] = make_float4(acc_dv[r][0], acc_dv[r][1], acc_dv[r][2], acc_dv[r][3]);
  }
}

constexpr int kMaxDevices = 64;
bool configured[kMaxDevices];

// Lets each kernel take its shared memory above the 48 KB default, once per device.
cudaError_t configure(int device) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (configured[device]) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(attn_forward, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kForwardFloats * static_cast<int>(sizeof(float)));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attn_backward_dq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kDqFloats * static_cast<int>(sizeof(float)));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attn_backward_dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kDkdvFloats * static_cast<int>(sizeof(float)));
  configured[device] = err == cudaSuccess;
  return err;
}

cudaError_t check_and_enter(int B, int L, int H, int mode, float p, const void* keep, int device, int* previous) {
  if (B < 1 || H < 1 || L < kTile || L % kTile != 0 || L / kTile > 65535 || H > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  if (mode < kModeNone || mode > kModeGiven || (mode == kModeGiven && keep == nullptr) ||
      (mode == kModeNone) != (p == 0.f) || !(p >= 0.f && p < 1.f))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaGetDevice(previous);
  if (err != cudaSuccess) return err;
  if (*previous != device && (err = cudaSetDevice(device)) != cudaSuccess) return err;
  return configure(device);
}

Dropout make_dropout(int mode, unsigned long long seed, const void* keep, float p) {
  return Dropout{mode, seed, static_cast<const uint8_t*>(keep), p, 1.f / (1.f - p)};
}

}  // namespace

extern "C" {

// K3a. o: [B, L, H, 64]; lse: [B, H, L]; probs: [B, H, L, L] or null.
// mode 0: no dropout (p must be 0); 1: Philox from `seed`; 2: `keep` given.
int k3_forward(const void* q, const void* k, const void* v, const void* bias, int mode, unsigned long long seed,
               const void* keep, float p, float scale, void* o, void* lse, void* probs, int B, int L, int H,
               int device, void* stream) {
  int previous = 0;
  cudaError_t err = check_and_enter(B, L, H, mode, p, keep, device, &previous);
  if (err == cudaSuccess) {
    attn_forward<<<dim3(L / kTile, H, B), kThreads, kForwardFloats * sizeof(float),
                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(bias), make_dropout(mode, seed, keep, p), scale, static_cast<float*>(o),
        static_cast<float*>(lse), static_cast<float*>(probs), L, H);
    err = cudaGetLastError();
  }
  if (previous != device) cudaSetDevice(previous);
  return static_cast<int>(err);
}

// K3b. delta: [B, H, L] scratch; dq, dk, dv: [B, L, H, 64].
int k3_backward(const void* q, const void* k, const void* v, const void* bias, int mode, unsigned long long seed,
                const void* keep, float p, float scale, const void* o, const void* dout, const void* lse,
                void* delta, void* dq, void* dk, void* dv, int B, int L, int H, int device, void* stream) {
  int previous = 0;
  cudaError_t err = check_and_enter(B, L, H, mode, p, keep, device, &previous);
  const Dropout drop = make_dropout(mode, seed, keep, p);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(L / kTile, H, B);
  if (err == cudaSuccess) {
    attn_backward_dq<<<grid, kThreads, kDqFloats * sizeof(float), s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(bias), drop, scale, static_cast<const float*>(o),
        static_cast<const float*>(dout), static_cast<const float*>(lse), static_cast<float*>(delta),
        static_cast<float*>(dq), L, H);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess) {
    attn_backward_dkdv<<<grid, kThreads, kDkdvFloats * sizeof(float), s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(bias), drop, scale, static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<float*>(dk),
        static_cast<float*>(dv), L, H);
    err = cudaGetLastError();
  }
  if (previous != device) cudaSetDevice(previous);
  return static_cast<int>(err);
}

const char* k3_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
