// Brute-force descriptor matching: per-query (best index, best distance,
// second-best distance) over a masked database, Hamming on packed binary
// descriptors and squared L2 on float descriptors.
//
// Replaces the TPU kernels of parakeet_slam_tpu/kernels/match.py:
//   hamming_top2 (:269, body _hamming_packed_kernel :201) and
//   l2_top2      (:342, via _dist_top2 :150, body _dist_top2_kernel :107).
// The TPU runs Hamming through its matrix unit with the bit-dot identity
// (bf16 bit-planes). Here too: with bits as +-1 int8, Hamming = (256 - dot)
// / 2, exact in int32, on the int8 tensor cores; the [N, M] distance matrix
// is never written.
//
// Contract (the reference's, reproduced exactly):
//   - invalid database rows count as 2^30 (Hamming) or 1e30 (L2);
//   - the best index is the smallest among equal distances; on a tie the
//     second-best equals the best; with one valid row the second is the
//     sentinel; with no valid row the result is (0, sentinel, sentinel);
//   - L2 is ||a||^2 + ||b||^2 - 2 a.b with float32 accumulation, best and
//     second clamped at >= 0 after the top-2. The cross product runs on the
//     tensor cores as 3xTF32 (below); one TF32 product alone would move
//     the distances by up to 4e-2 at D=128, and with them the argmins.
//
// Design.
//   Hamming: a block takes 128 queries and walks its chunk of the database
//   in tiles of 128 rows. Its queries are expanded once to +-1 int8 (bit 1
//   -> -1, bit 0 -> +1; word j, byte i of a packed word's 8 output words is
//   bit 8 i + j: queries and rows alike, so positions pair up) in the
//   K-major, 128-byte swizzled layout the wgmma descriptor names, 256 bytes
//   a row in two 128-byte halves. The block is three warpgroups. One is the
//   producer: thread t loads row t of the next tile and its flag a tile
//   ahead, the warpgroup skips a tile whose rows are all invalid, and a kept
//   tile is expanded into the next stage of a ring of three with each row's
//   fold bias, then signalled with the stage's `full` mbarrier. Two are
//   consumers, 64 queries each: wgmma.mma_async m64n128k32.s32.s8.s8, 8
//   k-steps for 256 bits, then the fold in the accumulator fragment. A
//   thread holds two query rows and 32 interleaved columns; each distance
//   becomes a key (distance << 22) + (row - chunk start), plus 2^31 for an
//   invalid row, in one multiply-add from the accumulator (2^29 + bias -
//   dot * 2^21), and a running (smallest, second smallest) key per row
//   takes min and max alone: the smaller key is the smaller distance, then
//   the smaller index, which is the reference's first-index rule, and the
//   four lanes that share a row merge by shuffles with the index compared
//   as part of the key. Skipping an all-invalid tile is exact: the fold
//   starts from the no-valid-row state, and an invalid row's key is above
//   every valid one. The rows of a chunk are split over gridDim.y (a chunk
//   holds at most 2^22 rows: the key's index field); each chunk writes a
//   partial top-2 (one chunk alone writes the result) and a second kernel
//   merges the partials in ascending chunk order with the reference's
//   cross-tile rule
//     b1' = min(b1, t1), idx' = t1 < b1 ? t_idx : idx,
//     b2' = min(max(b1, t1), min(b2, t2)).
//   A batch axis on gridDim.z takes the place of the reference's vmap over
//   the keyframe store; a batch stride of 0 shares an operand.
//   L2: what bounds it is the cross product, 2 N M D operations: outside the
//   tensor cores 0.41 ms at N=1024, M=131072, D=128, and a register-tiled
//   loop is held by shared-memory reads far above that. So the product runs
//   on the tensor cores, and since TF32 keeps 10 mantissa bits, as 3xTF32:
//   every float is split into big = tf32(x) and small = tf32(x - big), and
//   big.big + (big.small + small.big) is accumulated in float32 by
//   wgmma.mma_async m64n128k8; the two sums are kept in separate
//   accumulators and added in the fold. A block takes 128 queries and walks
//   its chunk of the database in tiles of 128 rows, the feature axis in
//   slices of 32 floats: one 128-byte row of the 128-byte swizzled K-major
//   layout both operands use, so [rows, D] row-major needs no transposed
//   copy. The queries' planes (times -2: exact) are split once and stay in
//   shared memory (D <= 128; above that they are staged slice by slice like
//   the database). The block is three warpgroups. One is the producer: it
//   loads the next database slice to registers while it waits for a free
//   stage of a ring of three, splits it, stores the planes and signals the
//   stage's `full` mbarrier. Two are consumers, 64 queries each: they wait
//   for `full`, start the step's 12 products, leave them in flight into the
//   next step, and hand a stage back (`empty`) when its products are done.
//   They never wait for each other, so one folds a tile while the other's
//   products keep the tensor cores busy. Features past D and rows past the
//   chunk are zeros in shared memory, never in device memory. The fold
//   happens in the accumulator fragment: a thread owns two query rows and
//   32 interleaved columns of the tile, forms (qn + dn) + (-2 a.b), puts
//   invalid rows at 1e30, and folds its columns in ascending order into a
//   running (best, idx, second) per row. The four lanes that share a row
//   hold interleaved column sets, so they merge by shuffles with the index
//   compared explicitly: the other's best wins if smaller, or equal with a
//   smaller index. Chunks over gridDim.y and the merge kernel are as for
//   Hamming. A pre-pass kernel writes the squared norms (one warp a row).
//
// Bound. Hamming at N=1024, M=131072: 134 M pairs x 256 int8 products =
// 68.7 G operations at 1,979 TOP/s, 0.035 ms, against 0.002 ms for the 4 MB
// of operands. XOR + __popc on the SM cannot come near it (1.07 G popcounts
// at 16 a clock per SM need ~0.29 ms). Each consumer warpgroup waits for its
// products before it folds them, and the fold (four integer operations a
// distance) and the producer's expansion share the issue slots, so the
// tensor cores idle while a tile is folded; a block's queries are expanded
// anew for every chunk. L2 at
// N=1024, M=131072, D=128 with 1 row in 5 invalid: 3 x 27.5 G TF32
// operations at 495 TFLOP/s, 0.167 ms, against 0.02 ms for the 67.6 MB of
// operands. Both operands of a wgmma come from shared memory here (96 bytes
// a clock of its 128), and the producer's stores of the planes (21 more)
// compete with them: that, not the tensor cores, holds the kernel at about
// two and a half times that bound.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kBigI = 1 << 30;
constexpr float kBigF = 1e30f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- L2

constexpr int kL2Consumers = 256;  // two warpgroups, 64 query rows each, multiply and fold
constexpr int kL2Producers = 128;  // one warpgroup stages the database
constexpr int kL2Threads = kL2Consumers + kL2Producers;
constexpr int kL2Q = 128;          // queries per block
constexpr int kL2M = 128;          // database rows per tile: the wgmma's n
constexpr int kL2K = 32;           // floats per slice of the feature axis: one 128-byte swizzle row
constexpr int kL2QSlots = 4;       // query slices held in shared memory (D <= 128 stays resident)
constexpr int kL2Stages = 3;       // database slices in the ring
constexpr int kL2NormSlots = 4;    // tiles whose norms and validity are held
constexpr int kPlane = kL2M * kL2K * 4;  // bytes of one plane (big or small) of one slice
constexpr int kL2Smem = (kL2QSlots + kL2Stages) * 2 * kPlane + kL2NormSlots * kL2M * 5 +
                        2 * kL2Stages * 8;

// x rounded to TF32 (10 mantissa bits, ties away from zero): the result of
// cvt.rna.tf32.f32 for every finite x, in two integer operations.
__device__ __forceinline__ float tf32_round(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

// Four floats of row `row` from feature d on, zero past D.
__device__ __forceinline__ float4 load4(const float* __restrict__ row, int d, int D, bool vec) {
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (vec) {
    if (d < D) v = __ldg(reinterpret_cast<const float4*>(row + d));
  } else {
    if (d < D) v.x = row[d];
    if (d + 1 < D) v.y = row[d + 1];
    if (d + 2 < D) v.z = row[d + 2];
    if (d + 3 < D) v.w = row[d + 3];
  }
  return v;
}

// Split four floats into big = tf32(x) and small = tf32(x - big) (the
// difference is exact) and store them as 16-byte chunk `chunk` of row `row`
// in the big plane at `plane` and the small plane behind it, in the 128-byte
// swizzle the wgmma descriptor names: chunk c of row r lies at c ^ (r % 8).
__device__ __forceinline__ void store_split(uint8_t* plane, int row, int chunk, float4 v) {
  const float4 big = make_float4(tf32_round(v.x), tf32_round(v.y), tf32_round(v.z),
                                 tf32_round(v.w));
  const float4 small = make_float4(tf32_round(v.x - big.x), tf32_round(v.y - big.y),
                                   tf32_round(v.z - big.z), tf32_round(v.w - big.w));
  const int off = row * 128 + ((chunk ^ (row & 7)) << 4);
  *reinterpret_cast<float4*>(plane + off) = big;
  *reinterpret_cast<float4*>(plane + kPlane + off) = small;
}

// Shared-memory matrix descriptor of a K-major operand whose rows are 128
// bytes, swizzled by 128 bytes: start address, leading offset (unused for
// this layout), 1024 bytes from one group of 8 rows to the next.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3ffff) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d (64 x 128, float32, 64 registers a thread) = a (64 x 8) . b (128 x 8)^T,
// plus d unless scale_d is 0; both operands TF32 in shared memory.
__device__ __forceinline__ void wgmma_m64n128k8(float (&d)[64], uint64_t a, uint64_t b,
                                                int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// Keeps the compiler from reading the accumulators before the wait for the
// asynchronous products that write them.
__device__ __forceinline__ void pin(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Squared norm of each row, one warp a row. The sums run in another order
// than a library reduction's: a few units in the last place of the norm.
__global__ void __launch_bounds__(256) row_norms_kernel(const float* __restrict__ x,
                                                        float* __restrict__ out, int rows, int D,
                                                        int vec) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const float* r = x + (long long)row * D;
  float acc = 0.0f;
  for (int d = 4 * lane; d < D; d += 128) {
    const float4 v = load4(r, d, D, vec);
    acc += v.x * v.x;
    acc += v.y * v.y;
    acc += v.z * v.z;
    acc += v.w * v.w;
  }
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (lane == 0) out[row] = acc;
}

struct Top2 {
  float b1, b2;
  int bi;
};

// One more distance, from a row index above all the earlier ones.
__device__ __forceinline__ void fold(Top2& t, float d, int m) {
  t.b2 = fminf(t.b2, fmaxf(t.b1, d));
  t.bi = d < t.b1 ? m : t.bi;
  t.b1 = fminf(t.b1, d);
}

// Two partial top-2 over disjoint row sets in any order: the smaller best
// wins, the smaller index among equal bests.
__device__ __forceinline__ void merge_by_index(Top2& t, float o1, float o2, int oi) {
  const float nb2 = fminf(fmaxf(t.b1, o1), fminf(t.b2, o2));
  t.bi = (o1 < t.b1 || (o1 == t.b1 && oi < t.bi)) ? oi : t.bi;
  t.b1 = fminf(t.b1, o1);
  t.b2 = nb2;
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__global__ void __launch_bounds__(kL2Threads, 1) l2_partial_kernel(
    const float* __restrict__ qd, const float* __restrict__ db,
    const float* __restrict__ qn, const float* __restrict__ dn,
    const uint8_t* __restrict__ valid, int32_t* __restrict__ p_idx,
    float* __restrict__ p_b1, float* __restrict__ p_b2, int N, int M, int D,
    int S, int chunk, int vec) {
  // the swizzle is a function of the address: planes start at multiples of 1024
  extern __shared__ __align__(1024) uint8_t l2_smem[];
  uint8_t* s_q = l2_smem;                              // [slot][big, small]
  uint8_t* s_db = s_q + kL2QSlots * 2 * kPlane;        // [stage][big, small]
  float* s_dn = reinterpret_cast<float*>(s_db + kL2Stages * 2 * kPlane);   // [tile % 4][row]
  uint8_t* s_valid = reinterpret_cast<uint8_t*>(s_dn + kL2NormSlots * kL2M);  // [tile % 4][row]
  uint64_t* s_bar = reinterpret_cast<uint64_t*>(s_valid + kL2NormSlots * kL2M);
  const uint32_t full = smem_u32(s_bar);               // [stage]: the stage's planes are stored
  const uint32_t empty = full + 8 * kL2Stages;         // [stage]: its products are done
  if (smem_u32(l2_smem) & 1023) __trap();

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kL2Q;
  const int m0 = blockIdx.y * chunk;
  const int m1 = min(m0 + chunk, M);
  const int n_slices = (D + kL2K - 1) / kL2K;
  const int n_steps = ((m1 - m0 + kL2M - 1) / kL2M) * n_slices;
  const bool resident = n_slices <= kL2QSlots;

  // Slice `slice` of the block's queries, split, into slot `slot`, by the
  // n_threads threads that call it. The products are taken with -2 q:
  // scaling by a power of two is exact in the split, the products and the
  // sums, and saves the fold a multiply.
  auto stage_q = [&](int slice, int slot, int t, int n_threads) {
    for (int e = t; e < kL2Q * 8; e += n_threads) {
      const int r = e >> 3, c = e & 7;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (q0 + r < N) v = load4(qd + (long long)(q0 + r) * D, slice * kL2K + 4 * c, D, vec);
      v = make_float4(-2.0f * v.x, -2.0f * v.y, -2.0f * v.z, -2.0f * v.w);
      store_split(s_q + slot * 2 * kPlane, r, c, v);
    }
  };
  if (tid == 0) {
    for (int s = 0; s < kL2Stages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(full + 8 * s),
                   "r"(kL2Producers) : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(empty + 8 * s),
                   "r"(kL2Consumers) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (resident) {
    for (int sl = 0; sl < n_slices; ++sl) stage_q(sl, sl, tid, kL2Threads);
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  if (tid >= kL2Consumers) {
    // ------------------------------------------------------------ producer
    // Step p's slice of the database goes to ring stage p % 3 once the
    // products of step p - 3 are done with it: loaded to registers a step
    // ahead, split, stored. Rows past the chunk's end are staged as zeros
    // and invalid: they fold as the sentinel, which changes no top-2.
    // the block's registers go where they are needed: 88 a thread here, 208
    // for the consumers' two accumulator sets
    asm volatile("setmaxnreg.dec.sync.aligned.u32 88;");
    const int t = tid - kL2Consumers;
    const int s_chunk = t & 7;   // a thread moves 16-byte chunk s_chunk of rows s_row + 16 i
    const int s_row = t >> 3;
    float4 pre[8];
    float pre_dn = 0.0f;
    uint8_t pre_valid = 0;
    auto load_db = [&](int t0, int slice) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = t0 + s_row + 16 * i;
        pre[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (m < m1) pre[i] = load4(db + (long long)m * D, slice * kL2K + 4 * s_chunk, D, vec);
      }
      if (slice == 0) {
        const int m = t0 + t;
        pre_dn = m < m1 ? dn[m] : 0.0f;
        pre_valid = m < m1 ? valid[m] : 0;
      }
    };
    load_db(m0, 0);
    int tile = 0, slice = 0, stage = 0;
    uint32_t parity = 1;  // the ring starts empty: the first waits pass
    for (int step = 0; step < n_steps; ++step) {
      mbar_wait(empty + 8 * stage, parity);
      if (!resident) stage_q(slice, stage, t, kL2Producers);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        store_split(s_db + stage * 2 * kPlane, s_row + 16 * i, s_chunk, pre[i]);
      }
      if (slice == 0) {
        s_dn[(tile % kL2NormSlots) * kL2M + t] = pre_dn;
        s_valid[(tile % kL2NormSlots) * kL2M + t] = pre_valid;
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_arrive(full + 8 * stage);
      if (++slice == n_slices) {
        slice = 0;
        ++tile;
      }
      if (++stage == kL2Stages) {
        stage = 0;
        parity ^= 1;
      }
      if (step + 1 < n_steps) load_db(m0 + tile * kL2M, slice);  // in flight under the wait
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 208;");
    // the accumulator fragment: this thread holds rows r_lo and r_lo + 8 of
    // its warpgroup's 64, columns 8 j + c_lo + {0, 1} for j = 0..15
    const int lane = tid & 31;
    const int wg = tid >> 7;
    const int r_lo = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
    const int c_lo = (lane & 3) * 2;
    const float qn_lo = q0 + r_lo < N ? qn[q0 + r_lo] : 0.0f;
    const float qn_hi = q0 + r_lo + 8 < N ? qn[q0 + r_lo + 8] : 0.0f;
    Top2 lo = {kBigF, kBigF, m0}, hi = lo;
    // the big x big products and the two cross terms are summed apart: the
    // cross terms are 2^-11 of the sum, and added to it one by one each would
    // cost a rounding at the sum's magnitude
    float acc_big[64], acc_small[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc_big[i] = acc_small[i] = 0.0f;

    // A step's products stay in flight into the next step; its stage goes
    // back to the producer when they are done. The two warpgroups wait for
    // the producer alone, never for each other, so one folds a tile while
    // the other multiplies.
    int tile = 0, slice = 0, stage = 0, unreleased = -1;
    uint32_t parity = 0;
    for (int step = 0; step < n_steps; ++step) {
      mbar_wait(full + 8 * stage, parity);
      const uint32_t a_big = smem_u32(s_q + (resident ? slice : stage) * 2 * kPlane) + wg * 64 * 128;
      const uint32_t b_big = smem_u32(s_db + stage * 2 * kPlane);
      const int n_k8 = min(kL2K, D - slice * kL2K + 7) / 8;  // 8-wide steps that hold data
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
      for (int kk = 0; kk < n_k8; ++kk) {
        const int first = slice == 0 && kk == 0 ? 0 : 1;
        // 32 bytes further along every (swizzled) row
        const uint64_t ab = smem_desc(a_big + 32 * kk), as = smem_desc(a_big + kPlane + 32 * kk);
        const uint64_t bb = smem_desc(b_big + 32 * kk), bs = smem_desc(b_big + kPlane + 32 * kk);
        wgmma_m64n128k8(acc_small, as, bb, first);
        wgmma_m64n128k8(acc_small, ab, bs, 1);
        wgmma_m64n128k8(acc_big, ab, bb, first);
      }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      if (unreleased >= 0) {
        asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
        mbar_arrive(empty + 8 * unreleased);
      }
      unreleased = stage;

      if (slice + 1 == n_slices) {
        // the tile's cross products are whole: fold its distances
        asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
        mbar_arrive(empty + 8 * stage);
        unreleased = -1;
        pin(acc_big);
        pin(acc_small);
        const float* t_dn = s_dn + (tile % kL2NormSlots) * kL2M;
        const uint8_t* t_valid = s_valid + (tile % kL2NormSlots) * kL2M;
        const int t0 = m0 + tile * kL2M;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int c = 8 * j + c_lo;
          const float2 dn2 = *reinterpret_cast<const float2*>(t_dn + c);
          const uchar2 v2 = *reinterpret_cast<const uchar2*>(t_valid + c);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float dnv = e ? dn2.y : dn2.x;
            const bool ok = e ? v2.y : v2.x;
            const float x_lo = acc_big[4 * j + e] + acc_small[4 * j + e];
            const float x_hi = acc_big[4 * j + 2 + e] + acc_small[4 * j + 2 + e];
            fold(lo, ok ? (qn_lo + dnv) + x_lo : kBigF, t0 + c + e);
            fold(hi, ok ? (qn_hi + dnv) + x_hi : kBigF, t0 + c + e);
          }
        }
        slice = 0;
        ++tile;
      } else {
        ++slice;
      }
      if (++stage == kL2Stages) {
        stage = 0;
        parity ^= 1;
      }
    }

    // the four lanes that share a row hold interleaved columns
#pragma unroll
    for (int w = 1; w <= 2; w <<= 1) {
      const float l1 = __shfl_xor_sync(0xffffffffu, lo.b1, w), l2 = __shfl_xor_sync(0xffffffffu, lo.b2, w);
      const int li = __shfl_xor_sync(0xffffffffu, lo.bi, w);
      const float h1 = __shfl_xor_sync(0xffffffffu, hi.b1, w), h2 = __shfl_xor_sync(0xffffffffu, hi.b2, w);
      const int hidx = __shfl_xor_sync(0xffffffffu, hi.bi, w);
      merge_by_index(lo, l1, l2, li);
      merge_by_index(hi, h1, h2, hidx);
    }
    if ((lane & 3) == 0) {
      const long long o = (long long)blockIdx.y * N + q0 + r_lo;
      if (q0 + r_lo < N) {
        p_idx[o] = lo.bi;
        p_b1[o] = lo.b1;
        p_b2[o] = lo.b2;
      }
      if (q0 + r_lo + 8 < N) {
        p_idx[o + 8] = hi.bi;
        p_b1[o + 8] = hi.b1;
        p_b2[o + 8] = hi.b2;
      }
    }
  }
}

// ---------------------------------------------------------------- Hamming

constexpr int kWords = 8;                 // 256-bit descriptors
constexpr int kHamConsumers = 256;        // two warpgroups, 64 queries each
constexpr int kHamProducers = 128;        // one warpgroup expands the database
constexpr int kHamThreads = kHamConsumers + kHamProducers;
constexpr int kHamQ = 128;                // queries per block
constexpr int kHamM = 128;                // database rows per tile: the wgmma's n
constexpr int kHamStages = 3;             // tiles in the ring
constexpr int kHamPlane = kHamM * 128;    // bytes of one 128-bit half of a tile, +-1 int8
constexpr int kHamTileBytes = 2 * kHamPlane;
constexpr int kHamSmem = (1 + kHamStages) * kHamTileBytes + kHamStages * kHamM * 4 +
                         kHamStages * 4 + 2 * 4 * 4 + 2 * kHamStages * 8;
// A fold key: (distance << 22) | (row - chunk start), unsigned, with 2^31
// added for an invalid row; the smallest key is the best row, ties to the
// smallest index. Rows of a chunk must fit in 22 bits.
constexpr uint32_t kKeyInvalid = 0x80000000u;
constexpr int kKeyShift = 22;
constexpr int kMaxChunk = 1 << kKeyShift;

// Packed bits x -> 8 words of +-1 int8 (bit 1 -> -1, bit 0 -> +1): word j,
// byte i holds bit 8 i + j. Queries and database rows are expanded alike,
// so the order of the 256 positions is the same in both, and the dot
// product of two rows is 256 - 2 Hamming.
__device__ __forceinline__ void expand8(uint32_t x, uint4& lo, uint4& hi) {
  uint32_t o[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j] = ((x >> j) & 0x01010101u) * 0xfeu + 0x01010101u;
  lo = make_uint4(o[0], o[1], o[2], o[3]);
  hi = make_uint4(o[4], o[5], o[6], o[7]);
}

// Row `row` of a tile of +-1 int8 rows, K-major in the 128-byte swizzle the
// wgmma descriptor names (16-byte chunk c of a row at c ^ (row % 8)): word
// w of the packed row fills chunks 2 (w % 4) and 2 (w % 4) + 1 of half w / 4.
__device__ __forceinline__ void store_expanded(uint8_t* tile, int row, int w, uint32_t x) {
  uint4 lo, hi;
  expand8(x, lo, hi);
  uint8_t* half = tile + (w >> 2) * kHamPlane + row * 128;
  const int c = 2 * (w & 3);
  *reinterpret_cast<uint4*>(half + ((c ^ (row & 7)) << 4)) = lo;
  *reinterpret_cast<uint4*>(half + (((c + 1) ^ (row & 7)) << 4)) = hi;
}

// d (64 x 128, int32, 64 registers a thread) = a (64 x 32) . b (128 x 32)^T,
// plus d unless scale_d is 0; both operands int8 in shared memory.
__device__ __forceinline__ void wgmma_m64n128k32_s8(int32_t (&d)[64], uint64_t a, uint64_t b,
                                                    int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void pin(int32_t (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// (best, second) of the keys seen, the smaller first.
__device__ __forceinline__ void fold_key(uint32_t& k1, uint32_t& k2, uint32_t key) {
  k2 = min(k2, max(k1, key));
  k1 = min(k1, key);
}

__device__ __forceinline__ int32_t key_distance(uint32_t key) {
  return key >= kKeyInvalid ? kBigI : (int32_t)(key >> kKeyShift);
}

__global__ void __launch_bounds__(kHamThreads, 1) hamming_partial_kernel(
    const int32_t* __restrict__ qd, const int32_t* __restrict__ db,
    const uint8_t* __restrict__ valid, int32_t* __restrict__ p_idx,
    int32_t* __restrict__ p_b1, int32_t* __restrict__ p_b2, int N, int M,
    long long q_bs, long long db_bs, long long v_bs, int S, int chunk) {
  // the swizzle is a function of the address: tiles start at multiples of 1024
  extern __shared__ __align__(1024) uint8_t ham_smem[];
  uint8_t* s_q = ham_smem;                                     // the block's queries
  uint8_t* s_db = s_q + kHamTileBytes;                         // [stage]
  uint64_t* s_bar = reinterpret_cast<uint64_t*>(s_db + kHamStages * kHamTileBytes);
  uint32_t* s_bias = reinterpret_cast<uint32_t*>(s_bar + 2 * kHamStages);  // [stage][row]
  int* s_tile = reinterpret_cast<int*>(s_bias + kHamStages * kHamM);  // [stage]: tile, -1 = done
  int* s_any = s_tile + kHamStages;                            // [parity][producer warp]
  const uint32_t full = smem_u32(s_bar);                       // [stage]: the tile is stored
  const uint32_t empty = full + 8 * kHamStages;                // [stage]: its products are folded
  if (smem_u32(ham_smem) & 1023) __trap();

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * kHamQ;
  const int m0 = blockIdx.y * chunk;
  const int m1 = min(m0 + chunk, M);
  const int32_t* qb = qd + (long long)b * q_bs;
  const int32_t* dbb = db + (long long)b * db_bs;
  const uint8_t* vb = valid + (long long)b * v_bs;

  if (tid == 0) {
    for (int s = 0; s < kHamStages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(full + 8 * s),
                   "r"(kHamProducers) : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(empty + 8 * s),
                   "r"(kHamConsumers) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // The producer's thread t owns row t of every tile: it loads the row's 8
  // words and its flag a tile ahead, the first before the queries' expansion
  const int t = tid - kHamConsumers;
  uint4 w0, w1;
  uint8_t ok;
  auto load_row = [&](int t0) {
    const int m = t0 + t;
    w0 = w1 = make_uint4(0u, 0u, 0u, 0u);
    ok = 0;
    if (m < m1) {
      const uint4* row = reinterpret_cast<const uint4*>(dbb + (long long)m * kWords);
      w0 = __ldg(row);
      w1 = __ldg(row + 1);
      ok = vb[m];
    }
  };
  if (t >= 0) load_row(m0);
  // the queries, expanded once; rows past N are zeros
  for (int e = tid; e < kHamQ * kWords; e += kHamThreads) {
    const int r = e >> 3, w = e & 7;
    store_expanded(s_q, r, w, q0 + r < N ? (uint32_t)qb[(long long)(q0 + r) * kWords + w] : 0u);
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  if (tid >= kHamConsumers) {
    // ------------------------------------------------------------ producer
    // The warpgroup skips a tile whose rows are all invalid (exact: such a
    // tile cannot change a top-2 that starts from the no-valid-row state).
    // A kept tile goes to the next stage of the ring once the consumers have
    // folded what it held, expanded, with each row's fold bias: (row - m0)
    // plus 2^31 if the row is invalid or past the chunk. After the last
    // tile a stage with tile -1 ends the walk.
    const int warp = t >> 5;
    int stage = 0, k = 0;
    uint32_t parity = 1;  // the ring starts empty: the first waits pass
    for (int t0 = m0; t0 < m1; t0 += kHamM, ++k) {
      const uint4 c0 = w0, c1 = w1;
      const uint8_t c_ok = ok;
      if (t0 + kHamM < m1) load_row(t0 + kHamM);  // in flight under the rest
      const unsigned any = __ballot_sync(0xffffffffu, c_ok != 0);
      if ((t & 31) == 0) s_any[(k & 1) * 4 + warp] = any != 0;
      asm volatile("bar.sync 1, %0;" ::"n"(kHamProducers) : "memory");
      const int* a = s_any + (k & 1) * 4;
      if (!(a[0] | a[1] | a[2] | a[3])) continue;
      mbar_wait(empty + 8 * stage, parity);
      uint8_t* tile = s_db + stage * kHamTileBytes;
      store_expanded(tile, t, 0, c0.x);
      store_expanded(tile, t, 1, c0.y);
      store_expanded(tile, t, 2, c0.z);
      store_expanded(tile, t, 3, c0.w);
      store_expanded(tile, t, 4, c1.x);
      store_expanded(tile, t, 5, c1.y);
      store_expanded(tile, t, 6, c1.z);
      store_expanded(tile, t, 7, c1.w);
      s_bias[stage * kHamM + t] = (uint32_t)(t0 - m0 + t) + (c_ok ? 0u : kKeyInvalid);
      if (t == 0) s_tile[stage] = t0;
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_arrive(full + 8 * stage);
      if (++stage == kHamStages) {
        stage = 0;
        parity ^= 1;
      }
    }
    mbar_wait(empty + 8 * stage, parity);
    if (t == 0) s_tile[stage] = -1;
    mbar_arrive(full + 8 * stage);
  } else {
    // ----------------------------------------------------------- consumers
    // the accumulator fragment: this thread holds rows r_lo and r_lo + 8 of
    // its warpgroup's 64 queries, columns 8 j + c_lo + {0, 1} for j = 0..15
    const int lane = tid & 31;
    const int wg = tid >> 7;
    const int r_lo = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
    const int c_lo = (lane & 3) * 2;
    uint32_t lo1 = 0xffffffffu, lo2 = 0xffffffffu, hi1 = 0xffffffffu, hi2 = 0xffffffffu;
    int32_t acc[64];
    const uint32_t a_base = smem_u32(s_q) + wg * 64 * 128;
    int stage = 0;
    uint32_t parity = 0;
    while (true) {
      mbar_wait(full + 8 * stage, parity);
      if (s_tile[stage] < 0) break;
      const uint32_t b_base = smem_u32(s_db + stage * kHamTileBytes);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        // 32 bytes further along every (swizzled) row, then the second half
        const uint32_t off = (kk >> 2) * kHamPlane + 32 * (kk & 3);
        wgmma_m64n128k32_s8(acc, smem_desc(a_base + off), smem_desc(b_base + off), kk > 0);
      }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      pin(acc);
      // key = (distance << 22) + bias, distance = (256 - dot) / 2: dot is
      // even, so (256 - dot) << 21 = 2^29 - dot * 2^21
      const uint32_t* bias = s_bias + stage * kHamM;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const uint2 bj = *reinterpret_cast<const uint2*>(bias + 8 * j + c_lo);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const uint32_t c = (e ? bj.y : bj.x) + (1u << 29);
          fold_key(lo1, lo2, c - ((uint32_t)acc[4 * j + e] << 21));
          fold_key(hi1, hi2, c - ((uint32_t)acc[4 * j + 2 + e] << 21));
        }
      }
      mbar_arrive(empty + 8 * stage);
      if (++stage == kHamStages) {
        stage = 0;
        parity ^= 1;
      }
    }
    // the four lanes that share a row hold interleaved columns; the key
    // holds the index, so the smaller key is the smaller index on a tie
#pragma unroll
    for (int w = 1; w <= 2; w <<= 1) {
      const uint32_t l1 = __shfl_xor_sync(0xffffffffu, lo1, w), l2 = __shfl_xor_sync(0xffffffffu, lo2, w);
      const uint32_t h1 = __shfl_xor_sync(0xffffffffu, hi1, w), h2 = __shfl_xor_sync(0xffffffffu, hi2, w);
      lo2 = min(max(lo1, l1), min(lo2, l2));
      lo1 = min(lo1, l1);
      hi2 = min(max(hi1, h1), min(hi2, h2));
      hi1 = min(hi1, h1);
    }
    if ((lane & 3) == 0) {
      const long long o = ((long long)b * S + blockIdx.y) * N + q0 + r_lo;
      if (q0 + r_lo < N) {
        p_idx[o] = lo1 >= kKeyInvalid ? m0 : m0 + (int32_t)(lo1 & (kMaxChunk - 1));
        p_b1[o] = key_distance(lo1);
        p_b2[o] = key_distance(lo2);
      }
      if (q0 + r_lo + 8 < N) {
        p_idx[o + 8] = hi1 >= kKeyInvalid ? m0 : m0 + (int32_t)(hi1 & (kMaxChunk - 1));
        p_b1[o + 8] = key_distance(hi1);
        p_b2[o + 8] = key_distance(hi2);
      }
    }
  }
}

// ---------------------------------------------------------------- merge

template <typename T>
__device__ __forceinline__ T tmin(T a, T b) { return b < a ? b : a; }
template <typename T>
__device__ __forceinline__ T tmax(T a, T b) { return a < b ? b : a; }

__device__ __forceinline__ int32_t finish(int32_t v) { return v; }
// L2: the reference clamps best and second at >= 0 after the top-2 and
// maps anything at or above half the sentinel to the sentinel.
__device__ __forceinline__ float finish(float v) {
  return v >= 0.5f * kBigF ? kBigF : tmax(v, 0.0f);
}

template <typename T>
__global__ void merge_kernel(const int32_t* __restrict__ p_idx, const T* __restrict__ p_b1,
                             const T* __restrict__ p_b2, int32_t* __restrict__ idx,
                             T* __restrict__ out_b1, T* __restrict__ out_b2, int B, int N,
                             int S) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= (long long)B * N) return;
  const long long b = g / N, n = g % N;
  const long long base = b * S * N + n;
  int32_t bi = p_idx[base];
  T b1 = p_b1[base], b2 = p_b2[base];
  for (int s = 1; s < S; ++s) {
    const long long o = base + (long long)s * N;
    const T t1 = p_b1[o], t2 = p_b2[o];
    const int32_t ti = p_idx[o];
    const T nb2 = tmin(tmax(b1, t1), tmin(b2, t2));
    if (t1 < b1) bi = ti;
    b1 = tmin(b1, t1);
    b2 = nb2;
  }
  idx[g] = bi;
  out_b1[g] = finish(b1);
  out_b2[g] = finish(b2);
}

int blocks_for(long long n, int threads) { return (int)((n + threads - 1) / threads); }

// Raises `kernel`'s dynamic shared-memory limit to `bytes` once per device
// (the attribute holds for the process; the launches run every frame).
template <typename Kernel>
cudaError_t allow_dynamic_smem(Kernel kernel, int bytes, std::atomic<unsigned>& raised) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (raised.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) raised.fetch_or(bit);
  return err;
}

}  // namespace

// p_idx, p_b1, p_b2 [B, S, N] are scratch for the chunks' partial results,
// unused when S is 1.
extern "C" int hamming_top2_launch(const int32_t* qd, const int32_t* db, const uint8_t* valid,
                                   int32_t* idx, int32_t* b1, int32_t* b2, int32_t* p_idx,
                                   int32_t* p_b1, int32_t* p_b2, int B, int N, int M,
                                   long long q_bs, long long db_bs, long long v_bs, int S,
                                   int chunk, void* stream) {
  if (B < 1 || N < 1 || M < 1 || S < 1 || chunk < 1 || chunk % kHamM != 0 ||
      chunk > kMaxChunk || (long long)S * chunk < M || (long long)(S - 1) * chunk >= M ||
      S > 65535 || B > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  static std::atomic<unsigned> raised{0};
  cudaError_t err = allow_dynamic_smem(hamming_partial_kernel, kHamSmem, raised);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(blocks_for(N, kHamQ), S, B);
  // one chunk: its partial result is the result ([B, N] either way)
  hamming_partial_kernel<<<grid, kHamThreads, kHamSmem, st>>>(
      qd, db, valid, S == 1 ? idx : p_idx, S == 1 ? b1 : p_b1, S == 1 ? b2 : p_b2, N, M, q_bs,
      db_bs, v_bs, S, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return (int)err;
  merge_kernel<int32_t><<<blocks_for((long long)B * N, 256), 256, 0, st>>>(
      p_idx, p_b1, p_b2, idx, b1, b2, B, N, S);
  return (int)cudaGetLastError();
}

// qn [N] and dn [M] are scratch for the squared norms.
extern "C" int l2_top2_launch(const float* qd, const float* db, float* qn, float* dn,
                              const uint8_t* valid, int32_t* idx, float* b1, float* b2,
                              int32_t* p_idx, float* p_b1, float* p_b2, int N, int M, int D,
                              int S, int chunk, void* stream) {
  if (N < 1 || M < 1 || D < 1 || S < 1 || chunk < 1 || chunk % kL2M != 0 ||
      (long long)S * chunk < M || (long long)(S - 1) * chunk >= M || S > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  static std::atomic<unsigned> raised{0};
  cudaError_t err = allow_dynamic_smem(l2_partial_kernel, kL2Smem, raised);
  if (err != cudaSuccess) return (int)err;
  // 16-byte loads where every row starts at a multiple of 16 bytes
  const int vec = D % 4 == 0 && (((uintptr_t)qd | (uintptr_t)db) & 15) == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  row_norms_kernel<<<blocks_for(N, 8), 256, 0, st>>>(qd, qn, N, D, vec);
  row_norms_kernel<<<blocks_for(M, 8), 256, 0, st>>>(db, dn, M, D, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid(blocks_for(N, kL2Q), S, 1);
  l2_partial_kernel<<<grid, kL2Threads, kL2Smem, st>>>(qd, db, qn, dn, valid, p_idx, p_b1, p_b2,
                                                       N, M, D, S, chunk, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  merge_kernel<float><<<blocks_for(N, 256), 256, 0, st>>>(p_idx, p_b1, p_b2, idx, b1, b2, 1,
                                                         N, S);
  return (int)cudaGetLastError();
}
