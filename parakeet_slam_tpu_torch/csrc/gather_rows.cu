// Resampling payload gather: out_leaf[i, :] = in_leaf[idx[i], :] for every
// leaf of the particle state, in ONE launch.
//
// Replaces the TPU kernel parakeet_slam_tpu/kernels/resample_pallas.py
// (gather_rows, called once per leaf by gather_state). Each leaf is viewed
// as [P, row_bytes] raw bytes (bool travels as its one-byte storage), so
// the copy is exact. The destination buffers are separate allocations: an
// in-place gather would read a row after another block overwrote it.
//
// Grid (P, n_leaves): block (i, k) copies row idx[i] of leaf k, with 16-byte
// vector loads when source row, destination row and row length are all
// 16-byte aligned, and byte copies otherwise (e.g. the 12-byte pose rows).
//
// Bound: pure bandwidth. At P=2048, L=10240, S=3 the maps are 0.86 GB, read
// once and written once: about 0.5 ms at the H100's 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLeaves = 8;
constexpr int kThreads = 256;

struct LeafTable {
  const uint8_t* src[kMaxLeaves];
  uint8_t* dst[kMaxLeaves];
  long long row_bytes[kMaxLeaves];
};

__global__ void __launch_bounds__(kThreads) gather_rows_kernel(
    LeafTable t, const int32_t* __restrict__ idx, int P) {
  const int i = blockIdx.x;
  const int k = blockIdx.y;
  const int j = idx[i];
  if (j < 0 || j >= P) __trap();  // indices come from searchsorted, clamped
  const long long nb = t.row_bytes[k];
  const uint8_t* s = t.src[k] + (long long)j * nb;
  uint8_t* d = t.dst[k] + (long long)i * nb;
  if ((((uintptr_t)s | (uintptr_t)d | (uintptr_t)nb) & 15) == 0) {
    const int4* s4 = reinterpret_cast<const int4*>(s);
    int4* d4 = reinterpret_cast<int4*>(d);
    for (long long v = threadIdx.x; v < nb / 16; v += kThreads) d4[v] = s4[v];
  } else {
    for (long long b = threadIdx.x; b < nb; b += kThreads) d[b] = s[b];
  }
}

}  // namespace

extern "C" int gather_rows_launch(const void* const* srcs, void* const* dsts,
                                  const long long* row_bytes, int n_leaves,
                                  const int32_t* idx, int P, void* stream) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves || P < 1) {
    return (int)cudaErrorInvalidValue;
  }
  LeafTable t;
  for (int k = 0; k < n_leaves; ++k) {
    t.src[k] = static_cast<const uint8_t*>(srcs[k]);
    t.dst[k] = static_cast<uint8_t*>(dsts[k]);
    t.row_bytes[k] = row_bytes[k];
  }
  gather_rows_kernel<<<dim3(P, n_leaves), kThreads, 0, (cudaStream_t)stream>>>(t, idx, P);
  return (int)cudaGetLastError();
}
