// Resampling payload gather: out_leaf[i, :] = in_leaf[idx[i], :] for every
// leaf of the particle state, in ONE launch. The P output rows may be fewer
// than the P_src source rows.
//
// Source window (the ring gather of the sharded filter): with lo >= 0 the
// sources are the block of global rows [lo, lo + P_src) that is resident at
// this ring step. An output row whose index falls inside the window takes
// source row idx[i] - lo; every other output row is left as it was, so the
// S launches of a ring write each output row exactly once, and a launch
// moves the bytes of its window's rows and no more.
//
// Replaces the TPU kernel parakeet_slam_tpu/kernels/resample_pallas.py
// (gather_rows, called once per leaf by gather_state). Each leaf is viewed
// as [P, row_bytes] raw bytes (bool travels as its one-byte storage), so
// the copy is exact. The destination buffers are separate allocations: an
// in-place gather would read a row after another block overwrote it.
//
// Bound: pure bandwidth. At P=2048, L=10240, S=3 the maps are 0.86 GB, read
// once and written once: about 0.5 ms at the H100's 3.35 TB/s. Rows run
// from 12 bytes (pose) to 160 KB (lm_cov), so a block per row leaves the
// card with blocks four orders of magnitude apart in work, and a thread
// that carries the payload through its registers has 16 bytes in flight.
//
// Design: a persistent grid over equal pieces, and no payload in registers.
// The wrapper cuts every row whose address and length are multiples of 16
// bytes into chunks of one size (the last of a row is shorter) and numbers
// them across all such leaves. A block is one to an SM and holds kRings
// rings of kStages chunk buffers in shared memory; ring w of block b takes
// chunks b * kRings + w, + gridDim.x * kRings, ... One thread drives a
// ring with bulk asynchronous copies: global to shared, completing on the
// stage's mbarrier, then shared to global as a bulk group; a stage is loaded
// again once the store that read it has left shared memory, so a ring has a
// load and a store in flight. Four rings of two 16 KB stages were the best
// of the ring counts, depths and chunk sizes timed on the H100: more rings
// matter when the source rows repeat (resampling indices) and come from
// L2, where one ring's chain of waits is what limits it. The block's last
// warp copies the leaves that are not 16-byte shaped (the 12-byte pose, the
// 4-byte lm_count) with plain loads, several rows to an item, from a second
// list.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLeaves = 8;
constexpr int kRings = 4;   // warps that each drive a ring of bulk copies
constexpr int kStages = 2;  // chunk buffers of one ring
constexpr int kThreads = 32 * (kRings + 1);  // and one warp that copies the small leaves

// Leaves [0, n_bulk) are copied in chunks by bulk copies: `per` is the
// chunks of one row. Leaves [n_bulk, n_bulk + n_small) are copied by
// threads: `per` is the rows of one item. `first` is the leaf's first item
// in its list.
struct LeafTable {
  const uint8_t* src[kMaxLeaves];
  uint8_t* dst[kMaxLeaves];
  long long row_bytes[kMaxLeaves];
  int per[kMaxLeaves];
  int first[kMaxLeaves];
  int n_bulk, n_small;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Entry i of the index vector, int64 (`wide`) or int32 as the caller holds
// it. Without a window (lo < 0) every entry is a row of the source leaves,
// which have n_src rows; with one, entries inside [lo, lo + n_src) are
// rebased by lo and the others mark their output row as skipped.
struct Index {
  const void* data;
  int wide;
  int n_src;
  long long lo;
};

// The source row of output row i, or -1 when it lies outside the window.
__device__ __forceinline__ int checked(Index idx, int i) {
  long long j = idx.wide ? static_cast<const long long*>(idx.data)[i]
                         : static_cast<const int32_t*>(idx.data)[i];
  if (idx.lo >= 0) {
    j -= idx.lo;
    return (j < 0 || j >= idx.n_src) ? -1 : (int)j;
  }
  if (j < 0 || j >= idx.n_src) __trap();  // indices come from searchsorted, clamped
  return (int)j;
}

// Leaf of item `item` among leaves [k0, k1), whose `first` ascend.
__device__ __forceinline__ int leaf_of(const LeafTable& t, int k0, int k1, int item) {
  int k = k0;
  while (k + 1 < k1 && item >= t.first[k + 1]) ++k;
  return k;
}

__device__ __forceinline__ void wait_parity(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar), "r"(parity)
      : "memory");
}

template <typename T>
__device__ __forceinline__ void copy_rows(const LeafTable& t, int k, Index idx, int P,
                                          int r0, int r1, int lane) {
  const long long w = t.row_bytes[k] / sizeof(T);  // elements of a row
  const T* s = reinterpret_cast<const T*>(t.src[k]);
  T* d = reinterpret_cast<T*>(t.dst[k]);
  for (long long e = lane; e < (r1 - r0) * w; e += 32) {
    const int r = r0 + (int)(e / w);
    const long long c = e % w;
    const int src = checked(idx, r);
    if (src >= 0) d[r * w + c] = s[src * w + c];
  }
}

// Item `item` of the small list, `per` whole rows of its leaf, by one warp.
__device__ __forceinline__ void copy_small_item(const LeafTable& t, Index idx, int P,
                                                int item, int lane) {
  const int k = leaf_of(t, t.n_bulk, t.n_bulk + t.n_small, item);
  const int r0 = (item - t.first[k]) * t.per[k];
  const int r1 = min(P, r0 + t.per[k]);
  if ((((uintptr_t)t.src[k] | (uintptr_t)t.dst[k] | (uintptr_t)t.row_bytes[k]) & 3) == 0) {
    copy_rows<uint32_t>(t, k, idx, P, r0, r1, lane);
  } else {
    copy_rows<uint8_t>(t, k, idx, P, r0, r1, lane);
  }
}

// Chunk `item` of the bulk list: its leaf, row, offset in the row and bytes.
struct Piece {
  int k, r;
  long long off;
  uint32_t bytes;
};

__device__ __forceinline__ Piece piece_of(const LeafTable& t, int item, int chunk) {
  Piece p;
  p.k = leaf_of(t, 0, t.n_bulk, item);
  const int local = item - t.first[p.k];
  p.r = local / t.per[p.k];
  p.off = (long long)(local % t.per[p.k]) * chunk;
  p.bytes = (uint32_t)min((long long)chunk, t.row_bytes[p.k] - p.off);
  return p;
}

__global__ void __launch_bounds__(kThreads) gather_rows_kernel(
    const __grid_constant__ LeafTable t, Index idx, int P, int chunk,
    int n_bulk_items, int n_small_items) {
  extern __shared__ __align__(128) uint8_t rings[];  // [kRings][kStages][chunk]
  __shared__ __align__(8) uint64_t fulls[kRings][kStages];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp == kRings) {
    for (int item = blockIdx.x; item < n_small_items; item += gridDim.x) {
      copy_small_item(t, idx, P, item, lane);
    }
    return;
  }
  if (lane != 0) return;

  // the chunked leaves: this thread alone starts and awaits the copies of
  // its ring, chunks me, me + stride, ...
  const int me = blockIdx.x * kRings + warp;
  const int stride = gridDim.x * kRings;
  uint8_t* ring = rings + (size_t)warp * kStages * chunk;
  uint64_t* full = fulls[warp];
  const int n_mine = me < n_bulk_items ? (n_bulk_items - me + stride - 1) / stride : 0;
  if (n_mine == 0) return;
  for (int s = 0; s < kStages; ++s) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(&full[s]))
                 : "memory");
  }
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");

  // the source row of the chunk in each stage (-1: outside the window)
  int stage_row[kStages];
  auto load = [&](int j, const Piece& p, int row) {
    const uint32_t bar = smem_u32(&full[j % kStages]);
    stage_row[j % kStages] = row;
    if (row < 0) {
      // nothing to copy: a plain arrival completes the stage's phase at once
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
      return;
    }
    const uint8_t* src = t.src[p.k] + row * t.row_bytes[p.k] + p.off;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
                 "r"(p.bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        ::"r"(smem_u32(ring + (size_t)(j % kStages) * chunk)), "l"(src), "r"(p.bytes), "r"(bar)
        : "memory");
  };

  for (int j = 0; j < kStages - 1 && j < n_mine; ++j) {
    const Piece p = piece_of(t, me + j * stride, chunk);
    load(j, p, checked(idx, p.r));
  }
  for (int j = 0; j < n_mine; ++j) {
    // the source row of the chunk to load next is read while this one lands
    const int jn = j + kStages - 1;
    Piece pn = {};
    int row_n = 0;
    if (jn < n_mine) {
      pn = piece_of(t, me + jn * stride, chunk);
      row_n = checked(idx, pn.r);
    }
    const Piece p = piece_of(t, me + j * stride, chunk);
    const bool stored = stage_row[j % kStages] >= 0;
    wait_parity(smem_u32(&full[j % kStages]), (j / kStages) & 1);
    if (stored) {
      uint8_t* dst = t.dst[p.k] + p.r * t.row_bytes[p.k] + p.off;
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
                   "r"(smem_u32(ring + (size_t)(j % kStages) * chunk)), "r"(p.bytes)
                   : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
    if (jn < n_mine) {
      // chunk jn goes where chunk j - 1 was: wait until that store has read
      // its stage (all groups but the newest, or all of them when chunk j
      // lay outside the window and committed none)
      if (stored) {
        asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      } else {
        asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      }
      load(jn, pn, row_n);
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

}  // namespace

// Leaves [0, n_bulk) and then [n_bulk, n_bulk + n_small) in the arrays, as
// LeafTable lays them out. `chunk` is the size of a ring stage in bytes. P
// rows are written; without a window (lo < 0) every index is a row in
// [0, P_src) of the sources, with one the sources are global rows
// [lo, lo + P_src) and only the output rows whose index lies there are
// written.
extern "C" int gather_rows_launch(const void* const* srcs, void* const* dsts,
                                  const long long* row_bytes, const int* per, const int* first,
                                  int n_bulk, int n_small, int n_bulk_items, int n_small_items,
                                  int chunk, const void* idx, int idx_is_int64, int P,
                                  int P_src, long long lo, void* stream) {
  const int n = n_bulk + n_small;
  if (n_bulk < 0 || n_small < 0 || n < 1 || n > kMaxLeaves || P < 1 || P_src < 1 || chunk < 16 ||
      chunk % 16 != 0 || n_bulk_items < 0 || n_small_items < 0) {
    return (int)cudaErrorInvalidValue;
  }
  LeafTable t = {};
  t.n_bulk = n_bulk;
  t.n_small = n_small;
  for (int k = 0; k < n; ++k) {
    t.src[k] = static_cast<const uint8_t*>(srcs[k]);
    t.dst[k] = static_cast<uint8_t*>(dsts[k]);
    t.row_bytes[k] = row_bytes[k];
    t.per[k] = per[k];
    t.first[k] = first[k];
    const bool shaped = (((uintptr_t)srcs[k] | (uintptr_t)dsts[k] | (uintptr_t)row_bytes[k]) & 15) == 0;
    if (per[k] < 1 || row_bytes[k] < 1 || (k < n_bulk && !shaped)) return (int)cudaErrorInvalidValue;
  }
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const int items = max((n_bulk_items + kRings - 1) / kRings, n_small_items);
  const int smem = kRings * kStages * chunk;
  cudaError_t err = cudaFuncSetAttribute(gather_rows_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  // as many blocks as fit on the card at once, and no more than there are items
  const int per_sm = max(1, min(8, (227 * 1024) / (smem + 1024)));
  gather_rows_kernel<<<max(1, min(items, per_sm * n_sm)), kThreads, smem, (cudaStream_t)stream>>>(
      t, Index{idx, idx_is_int64, P_src, lo}, P, chunk, n_bulk_items, n_small_items);
  return (int)cudaGetLastError();
}
