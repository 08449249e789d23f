// K1 on bf16 planes: the local-reparameterization epilogue of a BBB layer
// that computes in bf16, forward and backward, as CUDA kernels for Hopper
// (sm_90a). The fp32 planes stay on the Triton kernels of
// ops/sampling.py, with their random stream.
//
// Replaces the TPU kernel beyond_deep_ensembles_tpu/ops/sampling.py:46
// `_sample_kernel` (launched by `_sample_2d`) where it runs on bf16 planes.
// Its rule, kept here: out = (act_mean + b_mean[c]) + sqrt(act_var +
// b_var[c]) z in fp32, rounded once to bf16 (JAX :58-59); the backward is
// d act_var = g z 0.5 / sqrt(act_var + b_var[c]), rounded once (JAX
// :121-123), with z drawn again from (seed, i), never stored. c is the index
// along dim 1: (i / hw) % C for a plane of C channels of hw positions.
//
// The draw. One Philox-4x32-10 call, keyed by the seed's two 32-bit halves
// at counter (i / 8, 0, 0, 0), gives the eight normals of elements 8 (i / 8)
// ... 8 (i / 8) + 7: word w = i % 8 / 2 is one Box-Muller pair, its top 20
// bits the radial uniform u = (k + 1/2) 2^-20 and its low 12 bits the angle
// theta = 2 pi (j + 1/2) 2^-12 - pi; z = r cos(theta) at an even i, r
// sin(theta) at an odd one, r = sqrt(-2 ln u). The smallest u, 2^-21, caps
// |z| at 5.396; the 4096 angles are symmetric about 0 and pi. z is a
// function of (seed, i) alone (ops/sampling.py::philox_slot_bf16), so the
// forward, the backward, a frozen row and a shard at an offset draw the same
// z whatever their grids. ln, the radius's square root, sin and cos are the
// special-function unit's approximations (lg2, sqrt, sin, cos .approx): about
// 2^-20 of z, far below a bf16 spacing (2^-8); ops/sampling.py's
// `normals_bf16_plain` is the same map in plain PyTorch.
//
// Bound: device memory. A thread takes the 8 contiguous elements of one
// Philox call: two 16-byte loads (the mean or g, and the variance), issued
// before the draw, and one 16-byte store, 6 bytes an element. On the hot
// path that is about 30 instructions an element (33.75 forward, 29.75
// backward without a bias, by benchmarks_torch/k1_sass.py): an eighth of
// ten Philox rounds (two wide integer multiplies, two three-way xors),
// half a Box-Muller pair (four special-function instructions and a few
// integer and float ones), the bf16 unpacking, sqrt (correctly rounded, as
// the plain version's) and the fused multiply-add; the card's issue rate
// allows about 60 at its byte rate (at 1980 MHz). The Triton kernel on
// bf16 planes (four normals a call, libdevice's precise log, sin and cos,
// an integer division for the channel) issued 90, 129 with a bias, and its
// issue set its time.
// The channel index takes no division: a host-made magic multiplier
// (ops/sampling.py::_divider), once for the thread's 8 elements (one
// channel where hw % 8 == 0, two where hw >= 8, split where the first
// ends).
//
// Modes (one kernel per mode, bias run and noise source):
//   flat: train (z drawn at the global index start + l) and given (z =
//     eps[l % eps_n], eps fp32 of the full shape or one row), forward or
//     backward; `noise` writes the drawn z itself in fp32 and `words` the
//     Philox words of each group (the checks' way to read the kernel's
//     draw back; no sample is taken).
//   frozen: one row of z for the whole batch, the train draw of example 0:
//     a 2-D grid, x over 2048-position chunks of the row, y over chunks of
//     `per_program` examples; a thread draws its 8 positions once and
//     applies them to each of its examples.
// A group of 8 that lies whole inside the plane, with the planes 16-byte
// aligned and the global index's groups on the local ones (start % 8 == 0;
// for frozen, row % 8 == 0), takes the vector path; any other group (a
// shard's ragged ends, a ragged last group, a row not a multiple of 8) goes
// element by element through `scalar_group`, kept out of line so the vector
// path stays straight.
//
// C interface for ctypes: `k1_bf16` launches on the given stream, returns
// cudaGetLastError() after the launch (0 on success) and does not
// synchronise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kPer = 8;  // elements a thread: one Philox call
constexpr int kForward = 0, kBackward = 1, kNoise = 2, kWords = 3;
// the bias: none, or the channels a vector group (8 elements from a multiple
// of 8) spans: one where hw % 8 == 0, at most two where hw >= 8, else up to 8
constexpr int kNoBias = 0, kAnyChannels = 1, kTwoChannels = 2, kOneChannel = 3;
constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;  // Philox-4x32 multipliers
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;  // its key increments
constexpr float kTwoLn2 = 1.3862943611198906f;
constexpr float kTwoPi = 6.283185307179586f;
constexpr float kThreePi = 9.42477796076938f;

// floor(n / d) = (n magic) >> shift for 0 <= n < 2^31 (ops/sampling.py::_divider)
struct Divider {
  uint32_t magic;
  int shift;
};

struct Args {
  const bf16* a;      // act_mean (forward) or g (backward)
  const bf16* var;    // act_var
  const bf16* bmean;  // bias mean, [C] (forward with bias)
  const bf16* bvar;   // bias variance, [C]
  const float* eps;   // given z
  void* out;          // bf16 plane, or fp32 z in noise mode
  const long long* key;  // device seed: the key in device memory, or null
  long long seed;     // the host seed, or the draw index added to *key
  int n;              // elements of the plane (frozen: of one row)
  int shift;          // flat: start % 8, the first group's elements before the plane
  int group0;         // flat: start / 8, the first group's Philox counter
  int eps_n;          // given: eps's elements (n, or one row)
  int hw, channels;   // positions a channel, channels
  int batch, per_program;  // frozen
  int vec;            // the planes 16-byte aligned, shift 0 (frozen: row % 8 == 0)
  Divider by_hw, by_channels, by_eps;
};

__device__ __forceinline__ uint32_t quotient(uint32_t n, Divider d) {
  return static_cast<uint32_t>((static_cast<uint64_t>(n) * d.magic) >> d.shift);
}

__device__ __forceinline__ int channel_of(const Args& p, int l) {
  const uint32_t q = quotient(static_cast<uint32_t>(l), p.by_hw);
  return static_cast<int>(q - quotient(q, p.by_channels) * static_cast<uint32_t>(p.channels));
}

__device__ __forceinline__ unsigned long long seed_of(const Args& p) {
  return static_cast<unsigned long long>(p.seed + (p.key != nullptr ? *p.key : 0LL));
}

// The special-function unit's approximations (one MUFU instruction each,
// sin and cos after a multiply by 1 / 2 pi).
__device__ __forceinline__ float lg2_approx(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float sqrt_approx(float x) {
  float y;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float sin_approx(float x) {
  float y;
  asm("sin.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float cos_approx(float x) {
  float y;
  asm("cos.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One Box-Muller pair from 32 bits: the top 20 the radius, the low 12 the angle.
__device__ __forceinline__ void box_muller(uint32_t w, float& z0, float& z1) {
  const float u = __uint_as_float(((w >> 9) & 0x7FFFF8u) | 0x3F800004u) - 1.0f;  // (k + 1/2) 2^-20
  const float x = __uint_as_float(((w << 11) & 0x7FF800u) | 0x3F800400u);        // 1 + (j + 1/2) 2^-12
  const float r = sqrt_approx(-kTwoLn2 * lg2_approx(u));
  const float theta = fmaf(kTwoPi, x, -kThreePi);  // 2 pi (x - 1) - pi, in (-pi, pi)
  z0 = r * cos_approx(theta);
  z1 = r * sin_approx(theta);
}

// Philox-4x32-10 at counter (counter, 0, 0, 0) under the seed's two halves.
__device__ __forceinline__ uint4 philox(unsigned long long seed, uint32_t counter) {
  uint32_t k0 = static_cast<uint32_t>(seed), k1 = static_cast<uint32_t>(seed >> 32);
  uint32_t c0 = counter, c1 = 0, c2 = 0, c3 = 0;
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    if (round > 0) {
      k0 += kW0;
      k1 += kW1;
    }
    const uint32_t hi0 = __umulhi(kM0, c0), lo0 = kM0 * c0;
    const uint32_t hi1 = __umulhi(kM1, c2), lo1 = kM1 * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

// The eight normals of Philox counter `counter` under `seed`.
__device__ __forceinline__ void draw8(unsigned long long seed, uint32_t counter, float (&z)[kPer]) {
  const uint4 w = philox(seed, counter);
  box_muller(w.x, z[0], z[1]);
  box_muller(w.y, z[2], z[3]);
  box_muller(w.z, z[4], z[5]);
  box_muller(w.w, z[6], z[7]);
}

// The sample (forward) or the variance gradient (backward) of one element,
// in fp32: a is act_mean + b_mean (forward) or g (backward), v is act_var +
// b_var. Given and drawn z take the same expression.
template <int kMode>
__device__ __forceinline__ float element(float a, float v, float z) {
  if constexpr (kMode == kForward) {
    return __fmaf_rn(__fsqrt_rn(v), z, a);
  } else {
    return __fmul_rn(__fmul_rn(__fmul_rn(a, z), 0.5f), rsqrtf(v));
  }
}

__device__ __forceinline__ float lo_half(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_half(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

// Elements l0 .. l0 + 7 of the plane at `base`, one at a time, those in
// [0, n) only (frozen: l0 is a row position and n the row). Out of line:
// the group's z is drawn again here (counter), so the vector path keeps its
// draw in registers.
template <int kMode, int kRun, bool kGiven>
__device__ __noinline__ void scalar_group(const Args p, int base, int l0, uint32_t counter) {
  float z[kPer];
  if constexpr (!kGiven) draw8(seed_of(p), counter, z);
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int l = l0 + k;
    if (l < 0 || l >= p.n) continue;
    const int at = base + l;
    float zk;
    if constexpr (kGiven) {
      zk = p.eps[p.eps_n == p.n ? l : l - static_cast<int>(quotient(l, p.by_eps)) * p.eps_n];
    } else {
      zk = z[k];
    }
    if constexpr (kMode == kNoise) {
      static_cast<float*>(p.out)[at] = zk;
    } else {
      float a = to_float(p.a[at]), v = to_float(p.var[at]);
      if constexpr (kRun != kNoBias) {
        const int c = channel_of(p, l);
        v = v + to_float(p.bvar[c]);
        if constexpr (kMode == kForward) a = a + to_float(p.bmean[c]);
      }
      static_cast<bf16*>(p.out)[at] = __float2bfloat16_rn(element<kMode>(a, v, zk));
    }
  }
}

// The bias of a whole group at local l0 (a multiple of 8): of one channel,
// of two (split where the first ends), or of each element's.
template <int kMode, int kRun>
__device__ __forceinline__ void group_bias(const Args& p, int l0, float (&bm)[kPer], float (&bv)[kPer]) {
  if constexpr (kRun == kOneChannel) {
    const int c = channel_of(p, l0);
    const float m = kMode == kForward ? to_float(p.bmean[c]) : 0.0f, s = to_float(p.bvar[c]);
#pragma unroll
    for (int k = 0; k < kPer; ++k) bm[k] = m, bv[k] = s;
  } else if constexpr (kRun == kTwoChannels) {
    // elements k < split lie in channel c0, the rest in the next
    const uint32_t q = quotient(static_cast<uint32_t>(l0), p.by_hw);
    const int split = p.hw - (l0 - static_cast<int>(q) * p.hw);
    const int c0 = static_cast<int>(q - quotient(q, p.by_channels) * static_cast<uint32_t>(p.channels));
    const int c1 = c0 + 1 == p.channels ? 0 : c0 + 1;
    const float m0 = kMode == kForward ? to_float(p.bmean[c0]) : 0.0f, s0 = to_float(p.bvar[c0]);
    const float m1 = kMode == kForward ? to_float(p.bmean[c1]) : 0.0f, s1 = to_float(p.bvar[c1]);
#pragma unroll
    for (int k = 0; k < kPer; ++k) bm[k] = k < split ? m0 : m1, bv[k] = k < split ? s0 : s1;
  } else {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int c = channel_of(p, l0 + k);
      bm[k] = kMode == kForward ? to_float(p.bmean[c]) : 0.0f;
      bv[k] = to_float(p.bvar[c]);
    }
  }
}

// A whole group's sample or gradient from its loaded planes (av: act_mean
// or g, vv: act_var, 8 bf16 each), stored with one 16-byte store at `at`.
template <int kMode, int kRun>
__device__ __forceinline__ void vector_apply(const Args& p, int at, int l0, uint4 av, uint4 vv,
                                             const float (&z)[kPer]) {
  const uint32_t aw[4] = {av.x, av.y, av.z, av.w}, vw[4] = {vv.x, vv.y, vv.z, vv.w};
  float bm[kPer], bv[kPer];
  if constexpr (kRun != kNoBias) group_bias<kMode, kRun>(p, l0, bm, bv);
  uint32_t ow[4];
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    float a0 = lo_half(aw[w]), a1 = hi_half(aw[w]), v0 = lo_half(vw[w]), v1 = hi_half(vw[w]);
    if constexpr (kRun != kNoBias) {
      v0 = v0 + bv[2 * w], v1 = v1 + bv[2 * w + 1];
      if constexpr (kMode == kForward) a0 = a0 + bm[2 * w], a1 = a1 + bm[2 * w + 1];
    }
    ow[w] = pack(element<kMode>(a0, v0, z[2 * w]), element<kMode>(a1, v1, z[2 * w + 1]));
  }
  *reinterpret_cast<uint4*>(static_cast<bf16*>(p.out) + at) = make_uint4(ow[0], ow[1], ow[2], ow[3]);
}

__device__ __forceinline__ uint4 load16(const bf16* at) { return __ldg(reinterpret_cast<const uint4*>(at)); }

// A whole group of the flat modes at local l0 (a multiple of 8): the planes'
// loads issued first, then the draw (or eps), then the sample, or z stored.
template <int kMode, int kRun, bool kGiven>
__device__ __forceinline__ void vector_group(const Args& p, int l0, uint32_t counter) {
  uint4 av, vv;
  if constexpr (kMode != kNoise) av = load16(p.a + l0), vv = load16(p.var + l0);
  float z[kPer];
  if constexpr (kGiven) {
    if (p.eps_n == p.n) {
      const float4 e0 = __ldg(reinterpret_cast<const float4*>(p.eps + l0));
      const float4 e1 = __ldg(reinterpret_cast<const float4*>(p.eps + l0) + 1);
      z[0] = e0.x, z[1] = e0.y, z[2] = e0.z, z[3] = e0.w;
      z[4] = e1.x, z[5] = e1.y, z[6] = e1.z, z[7] = e1.w;
    } else {
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int l = l0 + k;
        z[k] = p.eps[l - static_cast<int>(quotient(l, p.by_eps)) * p.eps_n];
      }
    }
  } else {
    draw8(seed_of(p), counter, z);
  }
  if constexpr (kMode == kNoise) {
    float4* out = reinterpret_cast<float4*>(static_cast<float*>(p.out) + l0);
    out[0] = make_float4(z[0], z[1], z[2], z[3]);
    out[1] = make_float4(z[4], z[5], z[6], z[7]);
  } else {
    vector_apply<kMode, kRun>(p, l0, l0, av, vv, z);
  }
}

// Train, given, noise and words modes: thread t takes the global elements
// 8 (group0 + t) .. + 7, local l0 = 8 t - shift.
template <int kMode, int kRun, bool kGiven>
__global__ void __launch_bounds__(kThreads) k1_flat(const Args p) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int l0 = t * kPer - p.shift;
  if (l0 >= p.n) return;
  const uint32_t counter = static_cast<uint32_t>(p.group0 + t);
  if constexpr (kMode == kWords) {  // the group's Philox words, 4 a thread
    static_cast<uint4*>(p.out)[t] = philox(seed_of(p), counter);
  } else if (__builtin_expect(p.vec && l0 + kPer <= p.n, 1)) {
    vector_group<kMode, kRun, kGiven>(p, l0, counter);
  } else {
    scalar_group<kMode, kRun, kGiven>(p, 0, l0, counter);
  }
}

// Frozen eval: the row positions r0 .. r0 + 7 (the train draw of example 0)
// for examples [y per_program, min((y + 1) per_program, batch)).
template <int kMode, int kRun>
__global__ void __launch_bounds__(kThreads) k1_frozen(const Args p) {
  const int r0 = (blockIdx.x * kThreads + threadIdx.x) * kPer;
  if (r0 >= p.n) return;
  const int first = blockIdx.y * p.per_program;
  const int last = min(first + p.per_program, p.batch);
  const uint32_t counter = static_cast<uint32_t>(r0 / kPer);
  if (__builtin_expect(p.vec && r0 + kPer <= p.n, 1)) {
    float z[kPer];
    draw8(seed_of(p), counter, z);
    for (int b = first; b < last; ++b) {
      const int at = b * p.n + r0;
      vector_apply<kMode, kRun>(p, at, r0, load16(p.a + at), load16(p.var + at), z);
    }
  } else {
    for (int b = first; b < last; ++b) scalar_group<kMode, kRun, false>(p, b * p.n, r0, counter);
  }
}

template <int kMode, int kRun, bool kGiven>
void* flat_kernel() {
  return reinterpret_cast<void*>(&k1_flat<kMode, kRun, kGiven>);
}

template <int kMode, int kRun>
void* frozen_kernel() {
  return reinterpret_cast<void*>(&k1_frozen<kMode, kRun>);
}

// A mode's kernels by bias run, kNoBias .. kOneChannel.
struct ByRun {
  void* kernel[4];
};

template <int kMode, bool kGiven>
ByRun flat_kernels() {
  return {{flat_kernel<kMode, kNoBias, kGiven>(), flat_kernel<kMode, kAnyChannels, kGiven>(),
           flat_kernel<kMode, kTwoChannels, kGiven>(), flat_kernel<kMode, kOneChannel, kGiven>()}};
}

template <int kMode>
ByRun frozen_kernels() {
  return {{frozen_kernel<kMode, kNoBias>(), frozen_kernel<kMode, kAnyChannels>(),
           frozen_kernel<kMode, kTwoChannels>(), frozen_kernel<kMode, kOneChannel>()}};
}

void* by_run(int run, const ByRun& kernels) { return kernels.kernel[run]; }

}  // namespace

extern "C" {

// One launch of K1 on bf16 planes. mode: 0 forward, 1 backward, 2 noise (z
// in fp32 into `out`, no planes read), 3 words (the 4 Philox words of each
// group of 8 into `out`); frozen: the 2-D frozen grid
// (grid_x row chunks x grid_y example chunks), else a flat grid of grid_x
// blocks; run: 0 without a bias, else the channels a group of 8 spans (1
// any, 2 at most two, 3 one: ops/sampling.py::_channel_run). The pointers are the planes' (bias, eps and key may be null);
// the divider pairs (magic, shift) are ops/sampling.py::_divider's.
int k1_bf16(int mode, int frozen, int has_bias, int given, const void* a, const void* var, const void* bmean,
            const void* bvar, const void* eps, void* out, const void* key, long long seed, int n, int shift,
            int group0, int eps_n, int hw, int channels, int batch, int per_program, int vec, int run,
            unsigned hw_magic, int hw_shift, unsigned c_magic, int c_shift, unsigned eps_magic, int eps_shift,
            int grid_x, int grid_y, void* stream) {
  Args p;
  p.a = static_cast<const bf16*>(a);
  p.var = static_cast<const bf16*>(var);
  p.bmean = static_cast<const bf16*>(bmean);
  p.bvar = static_cast<const bf16*>(bvar);
  p.eps = static_cast<const float*>(eps);
  p.out = out;
  p.key = static_cast<const long long*>(key);
  p.seed = seed;
  p.n = n;
  p.shift = shift;
  p.group0 = group0;
  p.eps_n = eps_n;
  p.hw = hw;
  p.channels = channels;
  p.batch = batch;
  p.per_program = per_program;
  p.vec = vec;
  p.by_hw = {hw_magic, hw_shift};
  p.by_channels = {c_magic, c_shift};
  p.by_eps = {eps_magic, eps_shift};

  if (run < kNoBias || run > kOneChannel || (run != kNoBias) != (has_bias != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  void* kernel = nullptr;
  if (frozen) {
    if (given || mode >= kNoise) return static_cast<int>(cudaErrorInvalidValue);
    kernel = mode == kForward ? by_run(run, frozen_kernels<kForward>())
                              : by_run(run, frozen_kernels<kBackward>());
  } else if (mode == kNoise || mode == kWords) {
    if (given || has_bias) return static_cast<int>(cudaErrorInvalidValue);
    kernel = mode == kNoise ? flat_kernel<kNoise, kNoBias, false>() : flat_kernel<kWords, kNoBias, false>();
  } else if (mode == kForward) {
    kernel = given ? by_run(run, flat_kernels<kForward, true>())
                   : by_run(run, flat_kernels<kForward, false>());
  } else if (mode == kBackward) {
    kernel = given ? by_run(run, flat_kernels<kBackward, true>())
                   : by_run(run, flat_kernels<kBackward, false>());
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  void* params[] = {&p};
  const cudaError_t err = cudaLaunchKernel(kernel, dim3(grid_x, grid_y), dim3(kThreads), params, 0,
                                           static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

const char* k1_bf16_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
