// Brute-force descriptor matching: per-query (best index, best distance,
// second-best distance) over a masked database, Hamming on packed binary
// descriptors and squared L2 on float descriptors.
//
// Replaces the TPU kernels of parakeet_slam_tpu/kernels/match.py:
//   hamming_top2 (:269, body _hamming_packed_kernel :201) and
//   l2_top2      (:342, via _dist_top2 :150, body _dist_top2_kernel :107).
// The TPU runs Hamming through its matrix unit with the bit-dot identity
// (bf16 bit-planes), because it has no popcount. Hopper has one: here a
// distance is XOR + __popc over the 8 packed words, read as two 16-byte
// loads, and the [N, M] distance matrix is never written.
//
// Contract (the reference's, reproduced exactly):
//   - invalid database rows count as 2^30 (Hamming) or 1e30 (L2);
//   - the best index is the smallest among equal distances; on a tie the
//     second-best equals the best; with one valid row the second is the
//     sentinel; with no valid row the result is (0, sentinel, sentinel);
//   - L2 is ||a||^2 + ||b||^2 - 2 a.b in fp32 (norms precomputed by the
//     wrapper, as the reference does), best and second clamped at >= 0
//     after the top-2. No tensor cores, no TF32.
//
// Design.
//   Hamming: one thread per query keeps its query's 8 words in registers;
//   database tiles of 256 rows (8 KB) are staged in shared memory and read
//   as broadcasts. Each thread folds a running (best, idx, second) in
//   ascending row order with a strict '<', which is the reference's
//   first-index rule. N=1024 queries fill only 8 blocks of 128 threads, so
//   the rows are split into S contiguous chunks over gridDim.y; each chunk
//   writes a partial top-2 and a second kernel merges the partials in
//   ascending chunk order with the reference's cross-tile rule
//     b1' = min(b1, t1), idx' = t1 < b1 ? t_idx : idx,
//     b2' = min(max(b1, t1), min(b2, t2)).
//   A batch axis on gridDim.z takes the place of the reference's vmap over
//   the keyframe store; a batch stride of 0 shares an operand.
//   L2: a block takes 32 queries and walks its chunk in tiles of 64 rows;
//   the 32x64 cross products are accumulated from 32-wide slices of the
//   feature axis staged in shared memory (sequential in d, one rounding per
//   multiply and per add under -fmad=false), written to a shared distance
//   tile, and folded into the running top-2 by one thread per query in
//   ascending row order.
//
// Bound. Hamming at N=1024, M=131072: 134 M pairs x 8 popcounts = 1.07 G
// popcounts (quarter-rate on the SM) plus ~3 G integer ops: instruction-bound,
// ~0.3-0.6 ms at full occupancy; the database (4 MB) sits in L2. L2 at
// N=1024, M=131072, D=128: 17 G fp32 multiply-adds without tensor cores
// (67 TFLOP/s peak) bounds it at ~0.5 ms, far from reached by this simple
// tiling (a wgmma/3xTF32 form is later work).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBigI = 1 << 30;
constexpr float kBigF = 1e30f;

// ---------------------------------------------------------------- Hamming

constexpr int kHamThreads = 128;  // queries per block
constexpr int kHamTile = 256;     // database rows per shared tile
constexpr int kWords = 8;         // 256-bit descriptors

__global__ void __launch_bounds__(kHamThreads) hamming_partial_kernel(
    const int32_t* __restrict__ qd, const int32_t* __restrict__ db,
    const uint8_t* __restrict__ valid, int32_t* __restrict__ p_idx,
    int32_t* __restrict__ p_b1, int32_t* __restrict__ p_b2, int N, int M,
    long long q_bs, long long db_bs, long long v_bs, int S, int chunk) {
  __shared__ uint4 tile[kHamTile][2];
  __shared__ uint8_t tvalid[kHamTile];
  const int b = blockIdx.z;
  const int s = blockIdx.y;
  const int n = blockIdx.x * kHamThreads + threadIdx.x;
  const int m0 = s * chunk;
  const int m1 = min(m0 + chunk, M);
  const int32_t* dbb = db + (long long)b * db_bs;
  const uint8_t* vb = valid + (long long)b * v_bs;

  uint4 q0 = make_uint4(0, 0, 0, 0), q1 = q0;
  if (n < N) {
    const uint4* qrow = reinterpret_cast<const uint4*>(qd + (long long)b * q_bs +
                                                       (long long)n * kWords);
    q0 = qrow[0];
    q1 = qrow[1];
  }
  int b1 = kBigI, b2 = kBigI, bi = m0;
  for (int t0 = m0; t0 < m1; t0 += kHamTile) {
    const int cnt = min(kHamTile, m1 - t0);
    __syncthreads();
    for (int k = threadIdx.x; k < 2 * cnt; k += kHamThreads) {
      const uint4* src = reinterpret_cast<const uint4*>(dbb + (long long)t0 * kWords);
      tile[k >> 1][k & 1] = src[k];
    }
    for (int k = threadIdx.x; k < cnt; k += kHamThreads) tvalid[k] = vb[t0 + k];
    __syncthreads();
    if (n < N) {
      for (int r = 0; r < cnt; ++r) {
        const uint4 a = tile[r][0];
        const uint4 c = tile[r][1];
        int d = __popc(q0.x ^ a.x) + __popc(q0.y ^ a.y) + __popc(q0.z ^ a.z) +
                __popc(q0.w ^ a.w) + __popc(q1.x ^ c.x) + __popc(q1.y ^ c.y) +
                __popc(q1.z ^ c.z) + __popc(q1.w ^ c.w);
        d = tvalid[r] ? d : kBigI;
        if (d < b1) {
          b2 = b1;
          b1 = d;
          bi = t0 + r;
        } else if (d < b2) {
          b2 = d;
        }
      }
    }
  }
  if (n < N) {
    const long long o = ((long long)b * S + s) * N + n;
    p_idx[o] = bi;
    p_b1[o] = b1;
    p_b2[o] = b2;
  }
}

// ---------------------------------------------------------------- L2

constexpr int kL2Threads = 256;
constexpr int kL2Q = 32;   // queries per block
constexpr int kL2M = 64;   // database rows per tile
constexpr int kL2D = 32;   // feature slice staged per step

__global__ void __launch_bounds__(kL2Threads) l2_partial_kernel(
    const float* __restrict__ qd, const float* __restrict__ db,
    const float* __restrict__ qn, const float* __restrict__ dn,
    const uint8_t* __restrict__ valid, int32_t* __restrict__ p_idx,
    float* __restrict__ p_b1, float* __restrict__ p_b2, int N, int M, int D,
    int S, int chunk) {
  __shared__ float sq[kL2Q][kL2D + 1];
  __shared__ float sdb[kL2M][kL2D + 1];
  __shared__ float dist[kL2Q][kL2M + 1];
  const int s = blockIdx.y;
  const int q0 = blockIdx.x * kL2Q;
  const int m0 = s * chunk;
  const int m1 = min(m0 + chunk, M);
  const int tid = threadIdx.x;
  const int qi = tid >> 3;  // this thread's query row in the tile, 0..31
  const int cj = tid & 7;   // its columns cj, cj+8, ..., cj+56

  float b1 = kBigF, b2 = kBigF;
  int bi = m0;
  for (int t0 = m0; t0 < m1; t0 += kL2M) {
    const int cnt = min(kL2M, m1 - t0);
    float acc[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] = 0.0f;
    for (int d0 = 0; d0 < D; d0 += kL2D) {
      const int dw = min(kL2D, D - d0);
      __syncthreads();
      for (int e = tid; e < kL2Q * kL2D; e += kL2Threads) {
        const int r = e / kL2D, c = e % kL2D;
        const int qr = q0 + r;
        sq[r][c] = (qr < N && c < dw) ? qd[(long long)qr * D + d0 + c] : 0.0f;
      }
      for (int e = tid; e < kL2M * kL2D; e += kL2Threads) {
        const int r = e / kL2D, c = e % kL2D;
        sdb[r][c] = (r < cnt && c < dw) ? db[(long long)(t0 + r) * D + d0 + c] : 0.0f;
      }
      __syncthreads();
      for (int c = 0; c < dw; ++c) {
        const float a = sq[qi][c];
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[k] = acc[k] + a * sdb[cj + 8 * k][c];
      }
    }
    const int qr = q0 + qi;
    const float qnv = qr < N ? qn[qr] : 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int c = cj + 8 * k;
      if (c < cnt) {
        const int m = t0 + c;
        const float v = (qnv + dn[m]) - 2.0f * acc[k];
        dist[qi][c] = valid[m] ? v : kBigF;
      }
    }
    __syncthreads();
    if (tid < kL2Q) {
      for (int c = 0; c < cnt; ++c) {
        const float d = dist[tid][c];
        if (d < b1) {
          b2 = b1;
          b1 = d;
          bi = t0 + c;
        } else if (d < b2) {
          b2 = d;
        }
      }
    }
  }
  if (tid < kL2Q && q0 + tid < N) {
    const long long o = (long long)s * N + q0 + tid;
    p_idx[o] = bi;
    p_b1[o] = b1;
    p_b2[o] = b2;
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

}  // namespace

extern "C" int hamming_top2_launch(const int32_t* qd, const int32_t* db, const uint8_t* valid,
                                   int32_t* idx, int32_t* b1, int32_t* b2, int32_t* p_idx,
                                   int32_t* p_b1, int32_t* p_b2, int B, int N, int M,
                                   long long q_bs, long long db_bs, long long v_bs, int S,
                                   int chunk, void* stream) {
  if (B < 1 || N < 1 || M < 1 || S < 1 || chunk < 1 || (long long)S * chunk < M ||
      (long long)(S - 1) * chunk >= M || S > 65535 || B > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(blocks_for(N, kHamThreads), S, B);
  hamming_partial_kernel<<<grid, kHamThreads, 0, st>>>(qd, db, valid, p_idx, p_b1, p_b2, N, M,
                                                      q_bs, db_bs, v_bs, S, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  merge_kernel<int32_t><<<blocks_for((long long)B * N, 256), 256, 0, st>>>(
      p_idx, p_b1, p_b2, idx, b1, b2, B, N, S);
  return (int)cudaGetLastError();
}

extern "C" int l2_top2_launch(const float* qd, const float* db, const float* qn,
                              const float* dn, const uint8_t* valid, int32_t* idx, float* b1,
                              float* b2, int32_t* p_idx, float* p_b1, float* p_b2, int N,
                              int M, int D, int S, int chunk, void* stream) {
  if (N < 1 || M < 1 || D < 1 || S < 1 || chunk < 1 || (long long)S * chunk < M ||
      (long long)(S - 1) * chunk >= M || S > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(blocks_for(N, kL2Q), S, 1);
  l2_partial_kernel<<<grid, kL2Threads, 0, st>>>(qd, db, qn, dn, valid, p_idx, p_b1, p_b2, N,
                                                 M, D, S, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  merge_kernel<float><<<blocks_for(N, 256), 256, 0, st>>>(p_idx, p_b1, p_b2, idx, b1, b2, 1,
                                                         N, S);
  return (int)cudaGetLastError();
}
