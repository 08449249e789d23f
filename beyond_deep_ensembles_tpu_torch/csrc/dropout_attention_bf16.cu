// K3a and K3b on bf16 operands: self-attention with dropout on the
// probabilities, forward and backward, as CUDA kernels for Hopper (sm_90a),
// for the DistilBERT encoder under `compute_dtype: bf16`. Every product is a
// warpgroup tensor-core product (`wgmma.mma_async`, m64n64k16) of bf16
// operands with fp32 accumulation, and every streamed tile arrives by the
// copy engine (TMA, `cp.async.bulk.tensor`) into a ring of stages guarded by
// mbarriers.
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
// :111-128). rowsum(dP * P) = rowsum(dO * O) (`delta`). The kept
// probabilities are rounded before the 1 / (1 - p) (and in K3a the 1 / l) is
// applied to the sum they make: the same relative rounding as P_drop's. The
// fp32 kernels (`dropout_attention.cu`, split TF32) stay for fp32 operands.
//
// Layout: q, k, v, o, dO, dq, dk, dv are [B, L, H, 64] bf16, contiguous; bias
// is [B, L] fp32; lse and delta are [B, H, L] fp32; a given keep mask is uint8
// [B, H, L, L]. Any L >= 1: rows beyond L load as zeros (the copy engine's
// out-of-bounds fill), keys beyond L score -inf, query rows beyond L have lse
// +inf in the backward (P = 0), stores beyond L are left out.
//
// The dropout mask is the fp32 kernels' bit for bit (`philox` and the
// threshold are theirs): Philox-4x32-10 keyed by the panel seed seed + b H +
// h, counter (col / 8, row), the 16-bit half col % 8 of the four words (low
// half first) as the uniform; or a given mask; or none at p = 0. The seed is
// a host value, or a key in device memory plus the host value, read when the
// kernel runs (a captured launch draws afresh at each replay).
//
// Bound: at DistilBERT's (8, 12, 512, 64), K3a does 4 B H L^2 D = 6.44 GFLOP
// (6.5 us at 989 TFLOP/s bf16) and moves 8 B L H D = 25 MB (q, k, v in, o
// out: 7.5 us at 3.35 TB/s), so bytes bound it; K3b does 10 B H L^2 D = 16.1
// GFLOP (16.3 us) against 50 MB (15 us), so operations bound it. Beside that
// bound, work it leaves out sets a floor: each of the 25.2 M scores takes an
// exp2 on the special-function unit (16 a clock per SM: about 7 us a pass)
// and a share of a Philox call (an eighth of ten rounds of two wide integer
// multiplies and two three-way xors, about 10 us a pass over the scores at
// the full issue rate of the card). The kernels are bound by this
// elementwise work and its latency, not by the tensor cores.
//
// Design (the usual shape of a fast Hopper kernel). A block is three
// warpgroups: a producer and two consumers of 64 rows each (128 rows a
// block: query rows in K3a and the dQ launch, keys in the dK/dV launch). The
// producer gives up registers (`setmaxnreg.dec` to 40) and the consumers
// take them (`setmaxnreg.inc` to 232), so a consumer holds its score,
// probability and output accumulators without spills. One producer thread loads the block's
// own operands once (Q; Q and dO; K and V: [128][64] each) and streams the
// other two tensors' tiles of 64 rows through a ring of kStages stages (full
// and empty mbarriers per stage); a second producer warp writes each tile's
// row vectors into the same stage (the key bias times log2(e), -inf beyond
// L; or lse, its padded-row shift and delta). A consumer runs its score
// products with both operands read from shared memory through descriptors
// (K-major, the 128-byte swizzle the copy engine writes), does the softmax,
// the mask and the elementwise gradient in registers, packs the
// probabilities (or dS) to bf16 as the A operand of the next product
// straight from the accumulator registers (the accumulator of a score
// product is the A fragment of the product that follows as it stands: a0..a3
// = c[2k][0..1], c[2k][2..3], c[2k + 1][0..1], c[2k + 1][2..3]), and takes
// the B operand of that product (V, K, dO or Q) from the same landed tile
// read MN-major through the descriptor's transpose bit: no transposing pass.
// The two consumers share each tile and interleave on the SM. Scores are
// kept in base 2.
//   K3a `fwd`: an online softmax over the key tiles (running max m, row sum l
//     of the undropped values, the kept values rounded to bf16 and
//     accumulated into O), then O / (l (1 - p)) in bf16 and lse = m + log2(l).
//     With Philox each quad's four lanes draw the four (row, group of 8 keys)
//     pairs of two n-tiles, pack their flags and gather them by two shuffles;
//     in training it also leaves the bits in `drawn` (one bit a score).
//   K3b, three launches at most, no atomics, every sum in one order, so
//     repeat runs agree bit for bit:
//     `draw` (with Philox, where K3a left no bits: K3b called alone): the
//       keep bits, one word of `drawn` a thread;
//     `dq_kernel`: a block per 128 query rows takes delta = rowsum(dO * O) for
//       its rows (written out for the next launch) and walks the key tiles
//       recomputing S, P and dO V^T with the bits read back, accumulating
//       dQ = dS K;
//     `dkdv_kernel`: a block per 128 keys walks the query tiles recomputing
//       S^T, P^T and V dO^T with the same bits, accumulating dV = P_drop^T dO
//       and dK = dS^T Q.
//   dQ route (a), a launch of its own, was taken over route (b), one launch
//   adding each key block's dQ share into fp32 scratch in block order: built
//   and measured, (b) took 0.1723 ms at (8, 12, 512, 64), Philox, against
//   (a)'s 0.1145 (then), its per-tile barrier between the two consumers (the
//   dQ share's A operand spans both) and the ordered read-add-write on each
//   consumer's critical path outweighing the pass it saves (PERF.md).
// Each consumer walks its tiles with one wait a tile and no product in
// flight across an iteration: a product in flight across the loop's back
// edge made ptxas serialize every wgmma (its advisory C7515: the copies of
// the loop-carried accumulators fall between issue and wait).
//
// Measurement switch (ops/attention.py and the tests build without it):
// K3_CLOCKS, cycles by phase (k3_bf16_clocks).
//
// C interface for ctypes: each function makes the tensor maps of the tensors
// its kernels load (host work, a few microseconds), launches on the given
// stream, returns the first error (0 on success) and does not synchronise.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kD = 64;                         // head dimension
constexpr int kTile = 64;                      // rows of a streamed tile, and of a consumer warpgroup
constexpr int kConsumers = 2;                  // consumer warpgroups
constexpr int kBlockRows = kConsumers * kTile;  // rows of a block
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kStages = 3;                    // the ring's depth (2 measured the same)
constexpr int kTileBytes = kTile * kD * 2;     // 8 KB: [64 rows][64] bf16
constexpr int kVectors = 3;                    // row vectors a stage carries
#define K3_PRODUCER_REGS "40"                  // setmaxnreg: (168 - 40) x 128 = (232 - 168) x 256
#define K3_CONSUMER_REGS "232"
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

// What a consumer needs to realize its panel's mask.
struct Mask {
  uint32_t kx[10], ky[10];  // Philox: the panel's round keys (round r: key + r (W0, W1))
  const uint8_t* panel;     // given: the panel's [L, L] mask
  uint32_t threshold;
  int L;
};

constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u, kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;

template <int kMode>
__device__ __forceinline__ Mask make_mask(Dropout drop, int b, int h, int H, int L) {
  Mask m;
  m.panel = nullptr;
  m.threshold = drop.threshold;
  m.L = L;
  if constexpr (kMode == kModePhilox) {
    if (drop.seed_ptr != nullptr) drop.seed += static_cast<unsigned long long>(__ldg(drop.seed_ptr));
    const unsigned long long panel = drop.seed + static_cast<unsigned long long>(b) * H + h;
    m.kx[0] = static_cast<uint32_t>(panel);
    m.ky[0] = static_cast<uint32_t>(panel >> 32);
#pragma unroll
    for (int r = 1; r < 10; ++r) {
      m.kx[r] = m.kx[r - 1] + kW0;
      m.ky[r] = m.ky[r - 1] + kW1;
    }
  } else if constexpr (kMode == kModeGiven) {
    m.panel = drop.keep + (static_cast<long long>(b) * H + h) * L * L;
  }
  return m;
}

__device__ __forceinline__ long long row_offset(int b, int row, int h, int L, int H) {
  return ((static_cast<long long>(b) * L + row) * H + h) * kD;
}

// Philox-4x32-10, as in dropout_attention.cu: the words of row `row`, key group
// `col8` (keys 8 col8 .. 8 col8 + 7) of the panel.
__device__ __forceinline__ uint4 philox(const Mask& m, int row, int col8) {
  uint4 ctr = make_uint4(static_cast<uint32_t>(col8), static_cast<uint32_t>(row), 0u, 0u);
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    // each product one wide multiply (its high and low words together)
    const unsigned long long p0 = static_cast<unsigned long long>(kM0) * ctr.x;
    const unsigned long long p1 = static_cast<unsigned long long>(kM1) * ctr.z;
    const uint32_t hi0 = static_cast<uint32_t>(p0 >> 32), lo0 = static_cast<uint32_t>(p0);
    const uint32_t hi1 = static_cast<uint32_t>(p1 >> 32), lo1 = static_cast<uint32_t>(p1);
    ctr = make_uint4(hi1 ^ ctr.y ^ m.kx[round], lo1, hi0 ^ ctr.w ^ m.ky[round], lo0);
  }
  return ctr;
}

__device__ __forceinline__ uint32_t word_of(const uint4& w, int i) {
  return i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w;
}

__device__ __forceinline__ bool given_keep(const Mask& m, int row, int col) {
  if (row >= m.L || col >= m.L) return true;
  return m.panel[static_cast<long long>(row) * m.L + col] != 0;
}

// Keep bits of a lane's elements of the n-tiles j0 = col0 / 8 and j0 + 1 in
// the accumulator layout (rows row0 + g, row0 + g + 8; columns 8 j + 2 t, +
// 1): the element of n-tile j0 + i, row g + 8 r and column 8 j + 2 t + c is
// bit keep_position(i, 2 r + c). With Philox lane t draws the pair (row0 + g
// + 8 (t % 2), group col0 / 8 + t / 2) and packs its eight flags (bit 2 w +
// h for word w's half h: keys 2 w + h of the group) into byte t of a word;
// two shuffles give every lane of the quad all four bytes, and a lane's two
// keys 2 t, 2 t + 1 of each byte are its elements.
__device__ __forceinline__ int keep_position(int i, int e) { return 16 * i + 8 * (e >> 1) + (e & 1); }

template <int kMode>
__device__ __forceinline__ uint32_t keep_bits(const Mask& m, int row0, int col0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  uint32_t bits = 0;
  if constexpr (kMode == kModePhilox) {
    const uint4 w = philox(m, row0 + g + 8 * (t & 1), (col0 >> 3) + (t >> 1));
    uint32_t packed = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t x = word_of(w, i);
      packed |= ((x << 16) >= m.threshold ? 1u : 0u) << (2 * i);
      packed |= (x >= m.threshold ? 1u : 0u) << (2 * i + 1);
    }
    uint32_t all = packed << (8 * t);
    all |= __shfl_xor_sync(0xffffffffu, all, 1);
    all |= __shfl_xor_sync(0xffffffffu, all, 2);
    bits = all >> (2 * t);
  } else if constexpr (kMode == kModeGiven) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (given_keep(m, row0 + g + 8 * (e >> 1), col0 + 8 * i + 2 * t + (e & 1))) bits |= 1u << keep_position(i, e);
  } else {
    bits = 0xffffffffu;
  }
  return bits;
}

// With Philox the backward reads its mask back, drawn once: by K3a in
// training, else by K3b's first launch (`draw`): the words of keep_bits (lane
// t = 0's,
// unshifted: byte 2 kh + r for the rows g + 8 r and keys 8 kh .. 8 kh + 7 of
// a pair of n-tiles, bit key % 8) at index [b H + h][row pair][key group of
// 16] of `drawn`, a row pair being the rows 16 a + g and 16 a + g + 8 (index
// 8 a + g), tiles x 32 row pairs by tiles x 4 groups a panel. One bit a
// score, 1 / 8 of K3b's bytes of q, k, v, dO at L = 512.
__device__ __forceinline__ long long drawn_panel(int b, int h, int H, int tiles) {
  return (static_cast<long long>(b) * H + h) * 128 * tiles * tiles;
}

// The dQ launch's keep bits of a lane's pair of n-tiles from col0 (rows row0
// + g, row0 + g + 8), as keep_bits gives them: with Philox read back from
// `drawn` (row0 a multiple of 16: its row pairs are row0 / 2 + g).
template <int kMode>
__device__ __forceinline__ uint32_t keep_bits_read(const Mask& m, const uint32_t* __restrict__ drawn, int tiles,
                                                   int row0, int col0, int lane) {
  if constexpr (kMode == kModePhilox)
    return __ldg(drawn + static_cast<long long>(row0 / 2 + (lane >> 2)) * (4 * tiles) + col0 / 16) >> (2 * (lane & 3));
  else
    return keep_bits<kMode>(m, row0, col0, lane);
}

// The dK/dV launch's keep bits of a lane's elements of the pair of n-tiles
// from query0 (rows: keys key0 + g, key0 + g + 8; columns: query rows query0
// + 8 i + 2 t + c): word[c], bit 16 kh + 8 i for key key0 + g + 8 kh. With
// Philox they are read back from `drawn`.
template <int kMode>
__device__ __forceinline__ void keep_words_transposed(const Mask& m, const uint32_t* __restrict__ drawn, int tiles,
                                                      int key0, int query0, int lane, uint32_t word[2]) {
  const int g = lane >> 2, t = lane & 3;
  if constexpr (kMode == kModePhilox) {
#pragma unroll
    for (int c = 0; c < 2; ++c)
      word[c] = __ldg(drawn + static_cast<long long>(query0 / 2 + 2 * t + c) * (4 * tiles) + key0 / 16) >> g;
  } else if constexpr (kMode == kModeGiven) {
    word[0] = word[1] = 0;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (given_keep(m, query0 + 8 * i + 2 * t + (e & 1), key0 + g + 8 * (e >> 1)))
          word[e & 1] |= 1u << (16 * (e >> 1) + 8 * i);
  } else {
    word[0] = word[1] = 0xffffffffu;
  }
}

// The keep bits of a lane's four n-tile pairs of a 64-column tile (bits[jp]
// for the pair from col0 + 16 jp). K3a draws tile j + 1's bits in the same
// straight-line block as tile j's elementwise work, so that the Philox
// chains' integer work interleaves with it; the backward reads them back a
// tile ahead.
template <int kMode>
__device__ __forceinline__ void keep_tile(const Mask& m, int row0, int col0, int lane, uint32_t bits[4]) {
#pragma unroll
  for (int jp = 0; jp < 4; ++jp) bits[jp] = keep_bits<kMode>(m, row0, col0 + 16 * jp, lane);
}

template <int kMode>
__device__ __forceinline__ void keep_tile_read(const Mask& m, const uint32_t* __restrict__ drawn, int tiles, int row0,
                                               int col0, int lane, uint32_t bits[4]) {
#pragma unroll
  for (int jp = 0; jp < 4; ++jp) bits[jp] = keep_bits_read<kMode>(m, drawn, tiles, row0, col0 + 16 * jp, lane);
}

template <int kMode>
__device__ __forceinline__ void keep_tile_transposed(const Mask& m, const uint32_t* __restrict__ drawn, int tiles,
                                                     int key0, int query0, int lane, uint32_t words[4][2]) {
#pragma unroll
  for (int jp = 0; jp < 4; ++jp) keep_words_transposed<kMode>(m, drawn, tiles, key0, query0 + 16 * jp, lane, words[jp]);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

// 2^x by the special-function unit alone (2 ulp; a result below 2^-126 is 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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

// ---- shared memory, barriers and the copy engine ------------------------------
//
// Layout (bytes from a 1024-byte boundary): the block's own operands, two
// [128][64] bf16 tiles (each two boxes of 64 rows); the ring, kStages stages
// of two [64][64] tiles; the ring's row vectors, kStages x [kVectors][64]
// floats; the barriers: own, full[kStages], empty[kStages]. The copy engine
// writes a box as rows of 128 bytes in the 128-byte swizzle (the 16-byte
// chunk c of row r at chunk c ^ r % 8), which is the canonical K-major
// layout of a wgmma operand whose rows are the tile's rows, and the
// canonical MN-major layout of one whose depth runs along them.
struct Smem {
  uint8_t* base;
  __device__ explicit Smem(uint8_t* p) : base(p) {}
  __device__ bf16* own(int i) const { return reinterpret_cast<bf16*>(base + i * 2 * kTileBytes); }
  __device__ bf16* ring(int stage, int i) const {
    return reinterpret_cast<bf16*>(base + (4 + 2 * stage + i) * kTileBytes);
  }
  __device__ float* vec(int stage) const {
    return reinterpret_cast<float*>(base + (4 + 2 * kStages) * kTileBytes) + stage * kVectors * kTile;
  }
  __device__ uint64_t* own_full() const { return reinterpret_cast<uint64_t*>(vec(kStages)); }
  __device__ uint64_t* full(int stage) const { return own_full() + 1 + stage; }
  __device__ uint64_t* empty(int stage) const { return own_full() + 1 + kStages + stage; }
};

constexpr int kSmemBytes = (4 + 2 * kStages) * kTileBytes + kStages * kVectors * kTile * 4 + (1 + 2 * kStages) * 8;

__device__ __forceinline__ uint32_t shared_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void barrier_init(uint64_t* barrier, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(shared_address(barrier)), "r"(count) : "memory");
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

__device__ __forceinline__ void barrier_arrive(uint64_t* barrier) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(shared_address(barrier)) : "memory");
}

__device__ __forceinline__ void barrier_expect(uint64_t* barrier, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(shared_address(barrier)), "r"(bytes)
               : "memory");
}

// Rows row0 .. row0 + 63 of panel (b, h) of the map's tensor into `tile`;
// zeros beyond L; the bytes are reported to `barrier`.
__device__ __forceinline__ void load_box(bf16* tile, const CUtensorMap* map, int b, int h, int row0,
                                         uint64_t* barrier) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], "
      "[%6];\n" ::"r"(shared_address(tile)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(h), "r"(row0), "r"(b), "r"(shared_address(barrier))
      : "memory");
}

// The descriptors assume tiles on 1024-byte boundaries.
__device__ __forceinline__ void check_alignment(const void* smem) {
  if ((shared_address(smem) & 1023u) != 0) asm volatile("trap;\n");
}

// Thread 0 makes the barriers: own (one arrival and the bytes), full (the
// loading thread's and the vector warp's 32 arrivals and the bytes), empty
// (one arrival per consumer warp that runs).
__device__ __forceinline__ void make_barriers(const Smem& sm, int consumer_warps) {
  if (threadIdx.x == 0) {
    barrier_init(sm.own_full(), 1);
    for (int s = 0; s < kStages; ++s) {
      barrier_init(sm.full(s), 1 + 32);
      barrier_init(sm.empty(s), consumer_warps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The producer warpgroup. Thread 0 loads the block's own operands (own1 may
// be null) and then streams the tiles of ring0 and ring1, stage by stage,
// each stage once its consumers have released it; warp 1 writes each tile's
// row vectors, vectors(vec, row, i) for the tile's row i, into the stage and
// arrives. The other two warps have nothing to do.
template <typename Vectors>
__device__ __forceinline__ void produce(const Smem& sm, const CUtensorMap* own0, const CUtensorMap* own1,
                                        const CUtensorMap* ring0, const CUtensorMap* ring1, Vectors vectors, int b,
                                        int h, int row_base, int L) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles = (L + kTile - 1) / kTile;
  if (warp == 0 && lane == 0) {
    const int boxes = row_base + kTile < L ? 2 : 1;  // a box wholly beyond L has no consumer
    barrier_expect(sm.own_full(), (own1 != nullptr ? 2 : 1) * boxes * kTileBytes);
    for (int i = 0; i < boxes; ++i) {
      load_box(sm.own(0) + i * kTile * kD, own0, b, h, row_base + i * kTile, sm.own_full());
      if (own1 != nullptr) load_box(sm.own(1) + i * kTile * kD, own1, b, h, row_base + i * kTile, sm.own_full());
    }
    for (int j = 0; j < tiles; ++j) {
      const int stage = j % kStages;
      if (j >= kStages) barrier_wait(sm.empty(stage), j / kStages - 1);
      barrier_expect(sm.full(stage), 2 * kTileBytes);
      load_box(sm.ring(stage, 0), ring0, b, h, j * kTile, sm.full(stage));
      load_box(sm.ring(stage, 1), ring1, b, h, j * kTile, sm.full(stage));
    }
  } else if (warp == 1) {
    for (int j = 0; j < tiles; ++j) {
      const int stage = j % kStages;
      if (j >= kStages) barrier_wait(sm.empty(stage), j / kStages - 1);
      for (int i = lane; i < kTile; i += 32) vectors(sm.vec(stage), j * kTile + i, i);
      barrier_arrive(sm.full(stage));
    }
  }
}

__device__ __forceinline__ void producer_registers() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 " K3_PRODUCER_REGS ";\n" ::: "memory");
}

__device__ __forceinline__ void consumer_registers() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 " K3_CONSUMER_REGS ";\n" ::: "memory");
}

// ---- warpgroup products -------------------------------------------------------

// The descriptor of a [rows][64] bf16 tile as the copy engine wrote it: start
// address / 16, 1024 bytes between groups of 8 rows, the 128-byte swizzle.
// K-major (the depth along a row): a k-step of 16 moves it 32 bytes (+2).
__device__ __forceinline__ uint64_t kmajor(const bf16* tile) {
  return static_cast<uint64_t>((shared_address(tile) & 0x3FFFF) >> 4) | (uint64_t(1) << 16) | (uint64_t(64) << 32) |
         (uint64_t(1) << 62);
}

// MN-major (the depth down the rows, the 64 output columns along a row, one
// swizzle atom wide): a k-step of 16 rows moves it 2048 bytes (+128). Both
// offsets are 1024 bytes: the stride between groups of 8 depth rows, and the
// stride between atoms along the columns, which a 64-wide product never takes.
__device__ __forceinline__ uint64_t mnmajor(const bf16* tile) {
  return static_cast<uint64_t>((shared_address(tile) & 0x3FFFF) >> 4) | (uint64_t(64) << 16) | (uint64_t(64) << 32) |
         (uint64_t(1) << 62);
}

__device__ __forceinline__ void products_begin() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }

__device__ __forceinline__ void products_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }

// Waits for every product this warpgroup has committed.
__device__ __forceinline__ void products_wait() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

#define K3_ACC32(d)                                                                                                  \
  "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]),            \
      "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]),        \
      "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]),        \
      "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),        \
      "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])

#define K3_OUT32(d)                                                                                                  \
  "=f"(d[0][0]), "=f"(d[0][1]), "=f"(d[0][2]), "=f"(d[0][3]), "=f"(d[1][0]), "=f"(d[1][1]), "=f"(d[1][2]),            \
      "=f"(d[1][3]), "=f"(d[2][0]), "=f"(d[2][1]), "=f"(d[2][2]), "=f"(d[2][3]), "=f"(d[3][0]), "=f"(d[3][1]),        \
      "=f"(d[3][2]), "=f"(d[3][3]), "=f"(d[4][0]), "=f"(d[4][1]), "=f"(d[4][2]), "=f"(d[4][3]), "=f"(d[5][0]),        \
      "=f"(d[5][1]), "=f"(d[5][2]), "=f"(d[5][3]), "=f"(d[6][0]), "=f"(d[6][1]), "=f"(d[6][2]), "=f"(d[6][3]),        \
      "=f"(d[7][0]), "=f"(d[7][1]), "=f"(d[7][2]), "=f"(d[7][3])

#define K3_REGS32                                                                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "  \
  "%24, %25, %26, %27, %28, %29, %30, %31}"

// d += A B over one k-step of 16: A the warpgroup's 64 rows at `a`
// (K-major), B the 64 rows at `b` (K-major), both in shared memory.
__device__ __forceinline__ void wgmma_ss(float (*d)[4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " K3_REGS32 ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : K3_ACC32(d)
      : "l"(a), "l"(b), "r"(1));
}

// d = A B over the first k-step, d's old values not read: written as outputs
// only, so that the compiler defines none of d's registers between the
// batch's products to hand stale values in.
__device__ __forceinline__ void wgmma_ss_first(float (*d)[4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " K3_REGS32 ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : K3_OUT32(d)
      : "l"(a), "l"(b), "r"(0));
}

// d += A B over one k-step of 16: A a lane's fragment in registers, B the
// MN-major tile at `b` (its 16 depth rows by 64 columns).
__device__ __forceinline__ void wgmma_rs(float (*d)[4], const uint32_t a[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " K3_REGS32 ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : K3_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// After products_wait(): ties the accumulators' later reads and writes, and
// the last use of the fragments a product read, to this point, so that the
// compiler moves none of them into the time the products run (they own their
// registers until the wait). Never between a product's issue and the wait:
// an instruction that defines an accumulator register there makes ptxas
// serialize every wgmma (its advisory C7515).
__device__ __forceinline__ void products_done(float (*d)[4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+f"(d[i][j])::"memory");
}

__device__ __forceinline__ void fragments_done(const uint32_t (*a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" ::"r"(a[i][j]) : "memory");
}

// d = A B^T over the head dimension, A the warpgroup's 64 rows at `a`
// (K-major) and B the 64 rows of `tile`: issued, not waited for.
__device__ __forceinline__ void issue_scores(float (*d)[4], uint64_t a, const bf16* tile) {
  const uint64_t b = kmajor(tile);
  wgmma_ss_first(d, a, b);
#pragma unroll
  for (int kk = 1; kk < 4; ++kk) wgmma_ss(d, a + 2 * kk, b + 2 * kk);
}

// d += A B, A a lane's fragments of 64 depth positions and B the MN-major
// tile (its 64 rows the depth): issued, not waited for.
__device__ __forceinline__ void issue_accumulate(float (*d)[4], const uint32_t (*a)[4], const bf16* tile) {
  const uint64_t b = mnmajor(tile);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs(d, a[kk], b + 128 * kk);
}

// The A fragment of k-step kk from a 64-column accumulator (columns 16 kk ..
// 16 kk + 15), rounded to bf16.
__device__ __forceinline__ void to_fragment(uint32_t a[4], const float (*c)[4], int kk) {
  a[0] = pack(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

__device__ __forceinline__ void zero(float (*a)[4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[i][j] = 0.f;
}

// A row of 64 outputs from the accumulator (rows g, g + 8; columns 8 j + 2t,
// + 1), times mult[r], in bf16; rows beyond L are left out.
__device__ __forceinline__ void store_rows(bf16* __restrict__ out, const float (*acc)[4], const float mult[2], int b,
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

// Measurement switch K3_CLOCKS: each kernel adds up, over all blocks, the
// cycles the first consumer thread spends in each phase of a tile (and, in
// slot 7, from its first wait to its last store); k3_bf16_clocks() reads and
// clears the sums. Kernel 0 is fwd, 1 dq_kernel, 2 dkdv_kernel; phases: the
// stage's release, the elementwise part (with the next tile's mask), the
// wait for the next tile, the products' issue, the wait for them.
#ifdef K3_CLOCKS
__device__ unsigned long long phase_clocks[3][8];
#define K3_PHASES_BEGIN long long phase_start = clock64(), kernel_start = phase_start
#define K3_PHASE(kernel, i)                                                                     \
  do {                                                                                          \
    const long long now = clock64();                                                            \
    if (threadIdx.x == 128) atomicAdd(&phase_clocks[kernel][i], static_cast<unsigned long long>(now - phase_start)); \
    phase_start = now;                                                                          \
  } while (0)
#define K3_PHASES_END(kernel)                                                                   \
  if (threadIdx.x == 128) atomicAdd(&phase_clocks[kernel][7], static_cast<unsigned long long>(clock64() - kernel_start))
#else
#define K3_PHASES_BEGIN
#define K3_PHASE(kernel, i)
#define K3_PHASES_END(kernel)
#endif

// ---- the consumers --------------------------------------------------------------

// Each consumer walks its tiles with one wait a tile, and no product in
// flight across an iteration: tile j's elementwise part (K3a draws tile j +
// 1's mask in the same straight-line block; K3b reads tile j + 1's keep bits
// back at its start); then, once tile j + 1 has landed, tile j's
// accumulating product and tile j + 1's score products issued together; the
// wait; tile j's stage released.

// K3a for the 64 query rows wg_row0 .. of consumer c: the warp's rows row0 +
// g and row0 + g + 8.
template <int kMode>
__device__ __forceinline__ void forward_rows(const Smem& sm, const Dropout& drop, float scale, bf16* __restrict__ o,
                                             float* __restrict__ lse, uint32_t* __restrict__ drawn, int b, int h,
                                             int H, int L, int wg_row0, int c) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = wg_row0 + 16 * ((threadIdx.x >> 5) & 3);
  const int tiles = (L + kTile - 1) / kTile;
  const Mask mask = make_mask<kMode>(drop, b, h, H, L);
  const uint64_t q_desc = kmajor(sm.own(0) + c * kTile * kD);
  const float cs = scale * kLog2e;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, acc[8][4], s[8][4];
  uint32_t pa[4][4] = {};
  zero(acc);
  K3_PHASES_BEGIN;
  uint32_t bits[4];
  barrier_wait(sm.own_full(), 0);
  barrier_wait(sm.full(0), 0);
  products_begin();
  issue_scores(s, q_desc, sm.ring(0, 0));  // S = Q K^T
  products_commit();
  keep_tile<kMode>(mask, row0, 0, lane, bits);
  products_wait();
  products_done(s);
  for (int jt = 0; jt < tiles; ++jt) {
    const int stage = jt % kStages;
    K3_PHASE(0, 0);
    if (kMode == kModePhilox && drawn != nullptr && t == 0)  // the quad's draws of this tile, for K3b
#pragma unroll
      for (int jp = 0; jp < 4; ++jp)
        drawn[drawn_panel(b, h, H, tiles) + static_cast<long long>(row0 / 2 + g) * (4 * tiles) + 4 * jt + jp] =
            bits[jp];
    uint32_t next_bits[4];  // the next tile's, drawn among this tile's elementwise work (past the last: unused)
    keep_tile<kMode>(mask, row0, (jt + 1) * kTile, lane, next_bits);
    const float* tile_bias = sm.vec(stage);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 bias2 = *reinterpret_cast<const float2*>(tile_bias + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = fmaf(s[j][e], cs, (e & 1) ? bias2.y : bias2.x);
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = row_max(mx[r]);               // finite: every tile has a key inside L
      alpha[r] = fast_exp2(m[r] - mx[r]);  // 0 on the first tile
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];
#pragma unroll
    for (int jp = 0; jp < 4; ++jp)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = fast_exp2(s[2 * jp + i][e] - m[e >> 1]);
          l[e >> 1] += p;
          s[2 * jp + i][e] = (bits[jp] >> keep_position(i, e)) & 1u ? p : 0.f;
        }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) to_fragment(pa[kk], s, kk);
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) bits[jp] = next_bits[jp];
    K3_PHASE(0, 1);
    if (jt + 1 < tiles) barrier_wait(sm.full((jt + 1) % kStages), (jt + 1) / kStages);
    K3_PHASE(0, 2);
    products_begin();
    issue_accumulate(acc, pa, sm.ring(stage, 1));  // O += P_drop V
    if (jt + 1 < tiles) issue_scores(s, q_desc, sm.ring((jt + 1) % kStages, 0));
    products_commit();
    K3_PHASE(0, 3);
    products_wait();
    K3_PHASE(0, 4);
    products_done(s);
    products_done(acc);
    fragments_done(pa);
    if (lane == 0) barrier_arrive(sm.empty(stage));
  }
  float mult[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = row_sum(l[r]);
    mult[r] = drop.inv_keep / l[r];
    const int row = row0 + g + 8 * r;
    if (t == 0 && row < L) lse[(static_cast<long long>(b) * H + h) * L + row] = m[r] + log2f(l[r]);
  }
  K3_PHASES_END(0);
  store_rows(o, acc, mult, b, h, row0, L, H, lane);
}

// The dQ launch for the 64 query rows of consumer c.
template <int kMode>
__device__ __forceinline__ void dq_rows(const Smem& sm, const Dropout& drop, float scale, const bf16* __restrict__ o,
                                        const bf16* __restrict__ dout, const float* __restrict__ lse,
                                        float* __restrict__ delta, const uint32_t* __restrict__ drawn,
                                        bf16* __restrict__ dq, int b, int h, int H, int L, int wg_row0, int c) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = wg_row0 + 16 * ((threadIdx.x >> 5) & 3);
  const int tiles = (L + kTile - 1) / kTile;
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
  // with Philox the first launch's draws are read back: no round keys here
  const Mask mask = make_mask<kMode == kModePhilox ? kModeNone : kMode>(drop, b, h, H, L);
  const uint32_t* panel_drawn = kMode == kModePhilox ? drawn + drawn_panel(b, h, H, tiles) : nullptr;
  const uint64_t q_desc = kmajor(sm.own(0) + c * kTile * kD), do_desc = kmajor(sm.own(1) + c * kTile * kD);
  const float cs = scale * kLog2e;
  float acc[8][4], s[8][4], dp[8][4];
  uint32_t da[4][4] = {};
  zero(acc);
  K3_PHASES_BEGIN;
  uint32_t bits[4];
  barrier_wait(sm.own_full(), 0);
  barrier_wait(sm.full(0), 0);
  products_begin();
  issue_scores(s, q_desc, sm.ring(0, 0));    // S = Q K^T
  issue_scores(dp, do_desc, sm.ring(0, 1));  // dP = dO V^T
  products_commit();
  keep_tile_read<kMode>(mask, panel_drawn, tiles, row0, 0, lane, bits);
  products_wait();
  products_done(s);
  products_done(dp);
  for (int jt = 0; jt < tiles; ++jt) {
    const int stage = jt % kStages;
    K3_PHASE(1, 0);
    uint32_t next_bits[4];  // the next tile's, a whole tile ahead (past the last tile: tile 0's, unused)
    keep_tile_read<kMode>(mask, panel_drawn, tiles, row0, ((jt + 1) % tiles) * kTile, lane, next_bits);
    const float* tile_bias = sm.vec(stage);
#pragma unroll
    for (int jp = 0; jp < 4; ++jp)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int j = 2 * jp + i;
        const float2 bias2 = *reinterpret_cast<const float2*>(tile_bias + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const float p =
              fast_exp2((fmaf(s[j][e], cs, (e & 1) ? bias2.y : bias2.x) - row_lse[r]) - row_shift[r]);
          const float kept_diff = fmaf(dp[j][e], drop.inv_keep, -row_delta[r]);  // dP - delta where kept
          s[j][e] = p * ((bits[jp] >> keep_position(i, e)) & 1u ? kept_diff : -row_delta[r]);  // dS
        }
      }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) to_fragment(da[kk], s, kk);
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) bits[jp] = next_bits[jp];
    K3_PHASE(1, 1);
    const int next = (jt + 1) % kStages;
    if (jt + 1 < tiles) barrier_wait(sm.full(next), (jt + 1) / kStages);
    K3_PHASE(1, 2);
    products_begin();
    issue_accumulate(acc, da, sm.ring(stage, 0));  // dQ += dS K
    if (jt + 1 < tiles) {
      issue_scores(s, q_desc, sm.ring(next, 0));
      issue_scores(dp, do_desc, sm.ring(next, 1));
    }
    products_commit();
    K3_PHASE(1, 3);
    products_wait();
    K3_PHASE(1, 4);
    products_done(s);
    products_done(dp);
    products_done(acc);
    fragments_done(da);
    if (lane == 0) barrier_arrive(sm.empty(stage));
  }
  const float mult[2] = {scale, scale};
  K3_PHASES_END(1);
  store_rows(dq, acc, mult, b, h, row0, L, H, lane);
}

// The dK/dV launch for the 64 keys of consumer c: the warp's keys key0 + g
// and key0 + g + 8 are its rows, the streamed query rows its columns.
template <int kMode>
__device__ __forceinline__ void dkdv_rows(const Smem& sm, const Dropout& drop, float scale,
                                          const float* __restrict__ bias, const uint32_t* __restrict__ drawn,
                                          bf16* __restrict__ dk, bf16* __restrict__ dv, int b, int h, int H, int L,
                                          int wg_key0, int c) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int key0 = wg_key0 + 16 * ((threadIdx.x >> 5) & 3);
  const int tiles = (L + kTile - 1) / kTile;
  float key_bias[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + g + 8 * r;
    key_bias[r] = key < L ? bias[static_cast<long long>(b) * L + key] * kLog2e : -INFINITY;
  }
  // with Philox the dQ launch's draws are read back: no round keys here
  const Mask mask = make_mask<kMode == kModePhilox ? kModeNone : kMode>(drop, b, h, H, L);
  const uint32_t* panel_drawn = kMode == kModePhilox ? drawn + drawn_panel(b, h, H, tiles) : nullptr;
  const uint64_t k_desc = kmajor(sm.own(0) + c * kTile * kD), v_desc = kmajor(sm.own(1) + c * kTile * kD);
  const float cs = scale * kLog2e;
  float dk_acc[8][4], dv_acc[8][4], st[8][4], dpt[8][4];
  uint32_t pa[4][4] = {}, da[4][4] = {};
  zero(dk_acc);
  zero(dv_acc);
  K3_PHASES_BEGIN;
  uint32_t words[4][2];
  barrier_wait(sm.own_full(), 0);
  barrier_wait(sm.full(0), 0);
  products_begin();
  issue_scores(st, k_desc, sm.ring(0, 0));   // S^T = K Q^T
  issue_scores(dpt, v_desc, sm.ring(0, 1));  // (dO V^T)^T = V dO^T
  products_commit();
  keep_tile_transposed<kMode>(mask, panel_drawn, tiles, key0, 0, lane, words);
  products_wait();
  products_done(st);
  products_done(dpt);
  for (int it = 0; it < tiles; ++it) {
    const int stage = it % kStages;
    K3_PHASE(2, 0);
    uint32_t next_words[4][2];  // the next tile's bits, a whole tile ahead (past the last tile: tile 0's, unused)
    keep_tile_transposed<kMode>(mask, panel_drawn, tiles, key0, ((it + 1) % tiles) * kTile, lane, next_words);
    const float* tile_lse = sm.vec(stage);
    const float* tile_shift = tile_lse + kTile;
    const float* tile_delta = tile_lse + 2 * kTile;
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int j = 2 * jp + i, col = 8 * j + 2 * t;
        const float2 lse2 = *reinterpret_cast<const float2*>(tile_lse + col);
        const float2 shift2 = *reinterpret_cast<const float2*>(tile_shift + col);
        const float2 delta2 = *reinterpret_cast<const float2*>(tile_delta + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool kept = (words[jp][e & 1] >> (16 * (e >> 1) + 8 * i)) & 1u;
          const float p = fast_exp2((fmaf(st[j][e], cs, key_bias[e >> 1]) - ((e & 1) ? lse2.y : lse2.x)) -
                                    ((e & 1) ? shift2.y : shift2.x));
          const float row_delta = (e & 1) ? delta2.y : delta2.x;
          const float kept_diff = fmaf(dpt[j][e], drop.inv_keep, -row_delta);  // dP - delta where kept
          dpt[j][e] = kept ? p : 0.f;                       // P_drop^T (1 - p); dV takes 1 / (1 - p) at the end
          st[j][e] = p * (kept ? kept_diff : -row_delta);  // dS^T
        }
      }
      to_fragment(pa[jp], dpt, jp);
      to_fragment(da[jp], st, jp);
    }
    K3_PHASE(2, 1);
    const int next = (it + 1) % kStages;
    if (it + 1 < tiles) barrier_wait(sm.full(next), (it + 1) / kStages);
    K3_PHASE(2, 2);
    products_begin();
    issue_accumulate(dv_acc, pa, sm.ring(stage, 1));  // dV += P_drop^T dO
    issue_accumulate(dk_acc, da, sm.ring(stage, 0));  // dK += dS^T Q
    if (it + 1 < tiles) {
      issue_scores(st, k_desc, sm.ring(next, 0));
      issue_scores(dpt, v_desc, sm.ring(next, 1));
    }
    products_commit();
    K3_PHASE(2, 3);
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) words[jp][0] = next_words[jp][0], words[jp][1] = next_words[jp][1];
    products_wait();
    K3_PHASE(2, 4);
    products_done(st);
    products_done(dpt);
    products_done(dk_acc);
    products_done(dv_acc);
    fragments_done(pa);
    fragments_done(da);
    if (lane == 0) barrier_arrive(sm.empty(stage));
  }
  const float dk_mult[2] = {scale, scale}, dv_mult[2] = {drop.inv_keep, drop.inv_keep};
  K3_PHASES_END(2);
  store_rows(dk, dk_acc, dk_mult, b, h, key0, L, H, lane);
  store_rows(dv, dv_acc, dv_mult, b, h, key0, L, H, lane);
}

// ---- the kernels ----------------------------------------------------------------

template <int kMode>
__global__ void __launch_bounds__(kThreads, 1)
fwd(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, const float* __restrict__ bias, Dropout drop, float scale,
    bf16* __restrict__ o, float* __restrict__ lse, uint32_t* __restrict__ drawn, int L, int H) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const Smem sm(smem);
  check_alignment(smem);
  const int b = blockIdx.z, h = blockIdx.y, row_base = blockIdx.x * kBlockRows;
  const int active = row_base + kTile < L ? 2 : 1;  // consumers with a row inside L
  make_barriers(sm, 4 * active);
  const int wg = threadIdx.x >> 7;
  if (wg == 0) {
    producer_registers();
    const float* bias_row = bias + static_cast<long long>(b) * L;
    produce(
        sm, &q_map, nullptr, &k_map, &v_map,
        [&](float* vec, int key, int i) { vec[i] = key < L ? bias_row[key] * kLog2e : -INFINITY; }, b, h, row_base,
        L);
  } else {
    consumer_registers();
    if (wg - 1 < active)
      forward_rows<kMode>(sm, drop, scale, o, lse, drawn, b, h, H, L, row_base + kTile * (wg - 1), wg - 1);
  }
}

// K3b's first launch with Philox: the panel's keep bits, one word of
// `drawn` a thread (four Philox calls: its row pair's two rows by its key
// group's two groups of eight), every thread of the card busy, so that the
// calls' latency hides behind each other's.
__global__ void __launch_bounds__(256) draw(Dropout drop, uint32_t* __restrict__ drawn, int L, int H) {
  const int tiles = (L + kTile - 1) / kTile, panel = blockIdx.y;  // one row of blocks a panel
  const int rem = blockIdx.x * 256 + threadIdx.x;
  if (rem >= 128 * tiles * tiles) return;
  const int pair = rem / (4 * tiles), group = rem - pair * (4 * tiles);
  const int row = 16 * (pair >> 3) + (pair & 7);
  const Mask m = make_mask<kModePhilox>(drop, panel / H, panel % H, H, L);
  uint32_t word = 0;
#pragma unroll
  for (int kh = 0; kh < 2; ++kh)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const uint4 w = philox(m, row + 8 * r, 2 * group + kh);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t x = word_of(w, k);
        word |= (((x << 16) >= m.threshold ? 1u : 0u) | (x >= m.threshold ? 2u : 0u)) << (8 * (2 * kh + r) + 2 * k);
      }
    }
  drawn[static_cast<long long>(panel) * 128 * tiles * tiles + rem] = word;
}

template <int kMode>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
          const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
          const float* __restrict__ bias, Dropout drop, float scale, const bf16* __restrict__ o,
          const bf16* __restrict__ dout, const float* __restrict__ lse, float* __restrict__ delta,
          const uint32_t* __restrict__ drawn, bf16* __restrict__ dq, int L, int H) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const Smem sm(smem);
  check_alignment(smem);
  const int b = blockIdx.z, h = blockIdx.y, row_base = blockIdx.x * kBlockRows;
  const int active = row_base + kTile < L ? 2 : 1;
  make_barriers(sm, 4 * active);
  const int wg = threadIdx.x >> 7;
  if (wg == 0) {
    producer_registers();
    const float* bias_row = bias + static_cast<long long>(b) * L;
    produce(
        sm, &q_map, &do_map, &k_map, &v_map,
        [&](float* vec, int key, int i) { vec[i] = key < L ? bias_row[key] * kLog2e : -INFINITY; }, b, h, row_base,
        L);
  } else {
    consumer_registers();
    if (wg - 1 < active)
      dq_rows<kMode>(sm, drop, scale, o, dout, lse, delta, drawn, dq, b, h, H, L, row_base + kTile * (wg - 1),
                     wg - 1);
  }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
            const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
            const float* __restrict__ bias, Dropout drop, float scale, const float* __restrict__ lse,
            const float* __restrict__ delta, const uint32_t* __restrict__ drawn, bf16* __restrict__ dk,
            bf16* __restrict__ dv, int L, int H) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const Smem sm(smem);
  check_alignment(smem);
  const int b = blockIdx.z, h = blockIdx.y, key_base = blockIdx.x * kBlockRows;
  const int active = key_base + kTile < L ? 2 : 1;
  make_barriers(sm, 4 * active);
  const int wg = threadIdx.x >> 7;
  if (wg == 0) {
    producer_registers();
    const long long stats = (static_cast<long long>(b) * H + h) * L;
    // query rows beyond L: lse +inf, so P = 0 there and they add nothing
    produce(
        sm, &k_map, &v_map, &q_map, &do_map,
        [&](float* vec, int row, int i) {
          const float row_lse = row < L ? lse[stats + row] : INFINITY;
          vec[i] = row_lse;
          vec[kTile + i] = row < L ? padded_row_shift(row_lse, L) : 0.f;
          vec[2 * kTile + i] = row < L ? delta[stats + row] : 0.f;
        },
        b, h, key_base, L);
  } else {
    consumer_registers();
    if (wg - 1 < active)
      dkdv_rows<kMode>(sm, drop, scale, bias, drawn, dk, dv, b, h, H, L, key_base + kTile * (wg - 1), wg - 1);
  }
}

// ---- host side ------------------------------------------------------------------

constexpr int kMaxDevices = 64;
bool configured[kMaxDevices];

template <typename Kernel>
cudaError_t allow_shared(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
}

template <int kMode>
cudaError_t configure_mode() {
  cudaError_t err = allow_shared(fwd<kMode>);
  if (err == cudaSuccess) err = allow_shared(dq_kernel<kMode>);
  if (err == cudaSuccess) err = allow_shared(dkdv_kernel<kMode>);
  return err;
}

// Once per device, for every kernel: their shared memory above the 48 KB default.
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
  // the grids: (row blocks, H, B) and the draw's (words, B H)
  if (B < 1 || H < 1 || L < 1 || L > 65535 * kBlockRows || H > 65535 || B > 65535 ||
      static_cast<long long>(B) * H > 65535)
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

// The copy engine's map of x, [B, L, H, 64] bf16: boxes of 64 rows (L) x 64
// values of one (b, h), written in the 128-byte swizzle, zeros beyond L.
cudaError_t make_map(CUtensorMap* map, const void* x, int B, int L, int H) {
  const cuuint64_t row_bytes = kD * sizeof(bf16);
  const cuuint64_t dims[4] = {kD, static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(L), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {row_bytes, H * row_bytes, static_cast<cuuint64_t>(L) * H * row_bytes};
  const cuuint32_t box[4] = {kD, 1, kTile, 1}, steps[4] = {1, 1, 1, 1};
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const CUresult result =
      encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides, box, steps,
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

// K3a on bf16. o: [B, L, H, 64] bf16; lse: [B, H, L] fp32, base 2. mode 0: no
// dropout (p must be 0); 1: Philox from `seed`, plus the int64 at `seed_ptr`
// (device memory) unless it is null; 2: `keep` given. drawn: with Philox, null
// or int32 space of B H 128 tiles^2 words, tiles = ceil(L / 64), where the
// kernel leaves its keep bits for K3b (`drawn_panel`).
int k3_bf16_forward(const void* q, const void* k, const void* v, const void* bias, int mode, unsigned long long seed,
                    const void* seed_ptr, const void* keep, float p, float scale, void* o, void* lse, void* drawn,
                    int B, int L, int H, int device, void* stream) {
  int previous = 0;
  cudaError_t err = check_and_enter(B, L, H, mode, p, keep, device, &previous);
  CUtensorMap q_map, k_map, v_map;
  if (err == cudaSuccess) err = make_map(&q_map, q, B, L, H);
  if (err == cudaSuccess) err = make_map(&k_map, k, B, L, H);
  if (err == cudaSuccess) err = make_map(&v_map, v, B, L, H);
  if (err == cudaSuccess) {
    const auto kernel = mode == kModeNone ? fwd<kModeNone> : mode == kModePhilox ? fwd<kModePhilox> : fwd<kModeGiven>;
    kernel<<<dim3((L + kBlockRows - 1) / kBlockRows, H, B), kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
        q_map, k_map, v_map, static_cast<const float*>(bias), make_dropout(seed, seed_ptr, keep, p), scale,
        static_cast<bf16*>(o), static_cast<float*>(lse), static_cast<uint32_t*>(drawn), L, H);
    err = cudaGetLastError();
  }
  if (previous != device) cudaSetDevice(previous);
  return static_cast<int>(err);
}

// K3b on bf16. lse: K3a's; delta: [B, H, L] fp32 scratch; drawn: with Philox
// (mode 1) int32 space of B H 128 tiles^2 words, tiles = ceil(L / 64), the
// keep bits: K3a's (drawn_by_forward 1), or scratch that a first launch
// (`draw`) fills; else null; dq, dk, dv: [B, L, H, 64] bf16.
int k3_bf16_backward(const void* q, const void* k, const void* v, const void* bias, int mode, unsigned long long seed,
                     const void* seed_ptr, const void* keep, float p, float scale, const void* o, const void* dout,
                     const void* lse, void* delta, void* drawn, int drawn_by_forward, void* dq, void* dk, void* dv,
                     int B, int L, int H, int device, void* stream) {
  int previous = 0;
  cudaError_t err = check_and_enter(B, L, H, mode, p, keep, device, &previous);
  if (err == cudaSuccess && mode == kModePhilox && drawn == nullptr) err = cudaErrorInvalidValue;
  const Dropout drop = make_dropout(seed, seed_ptr, keep, p);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((L + kBlockRows - 1) / kBlockRows, H, B);
  CUtensorMap q_map, k_map, v_map, do_map;
  if (err == cudaSuccess) err = make_map(&q_map, q, B, L, H);
  if (err == cudaSuccess) err = make_map(&k_map, k, B, L, H);
  if (err == cudaSuccess) err = make_map(&v_map, v, B, L, H);
  if (err == cudaSuccess) err = make_map(&do_map, dout, B, L, H);
  if (err == cudaSuccess && mode == kModePhilox && !drawn_by_forward) {
    const int tiles = (L + kTile - 1) / kTile;
    draw<<<dim3((128 * tiles * tiles + 255) / 256, B * H), 256, 0, s>>>(drop, static_cast<uint32_t*>(drawn), L, H);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess) {
    const auto kernel = mode == kModeNone     ? dq_kernel<kModeNone>
                        : mode == kModePhilox ? dq_kernel<kModePhilox>
                                              : dq_kernel<kModeGiven>;
    kernel<<<grid, kThreads, kSmemBytes, s>>>(q_map, k_map, v_map, do_map, static_cast<const float*>(bias), drop,
                                              scale, static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
                                              static_cast<const float*>(lse), static_cast<float*>(delta),
                                              static_cast<const uint32_t*>(drawn), static_cast<bf16*>(dq), L, H);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess) {
    const auto kernel = mode == kModeNone     ? dkdv_kernel<kModeNone>
                        : mode == kModePhilox ? dkdv_kernel<kModePhilox>
                                              : dkdv_kernel<kModeGiven>;
    kernel<<<grid, kThreads, kSmemBytes, s>>>(q_map, k_map, v_map, do_map, static_cast<const float*>(bias), drop,
                                              scale, static_cast<const float*>(lse),
                                              static_cast<const float*>(delta),
                                              static_cast<const uint32_t*>(drawn), static_cast<bf16*>(dk),
                                              static_cast<bf16*>(dv), L, H);
    err = cudaGetLastError();
  }
  if (previous != device) cudaSetDevice(previous);
  return static_cast<int>(err);
}

#ifdef K3_CLOCKS
// out[kernel][phase], 3 x 8 (see K3_CLOCKS).
int k3_bf16_clocks(unsigned long long* out) {
  const unsigned long long zeros[3][8] = {};
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(out, phase_clocks, sizeof(phase_clocks));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(phase_clocks, zeros, sizeof(zeros));
  return static_cast<int>(err);
}
#endif

}  // extern "C"
