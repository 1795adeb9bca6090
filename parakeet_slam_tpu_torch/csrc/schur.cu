// Batched symmetric 3x3 inverse-apply: y[n] = C[n]^-1 u[n] for N landmark
// blocks, the cofactor inverse applied in one pass (C^-1 is never written).
//
// Replaces the TPU kernel parakeet_slam_tpu/kernels/schur.py (apply_cinv,
// body _kernel, math _cofactor_apply). The bundle-adjustment solver calls it
// once per bucket in every PCG matvec, once for the right-hand side and once
// for the back-substitution.
//
// The TPU version repacks C and u into nine [R, 128] planes padded to 1024
// rows, two extra passes over device memory that its lane layout wants. Here
// one thread per block reads its row of C [N, 3, 3] as it lies (the upper
// triangle: six of the nine floats) and of u [N, 3] through element strides,
// and writes y [N, 3]; the ragged end is a guard, not padding.
//
// The arithmetic is the plain twin's (kernels/schur.py::apply_cinv_reference)
// operation for operation: six cofactors, det = xx*A + xy*B + xz*Cc, |det| <
// eps replaced by eps (the sign is dropped, as in the reference), three IEEE
// divisions by det. Built with -fmad=false, so kernel and twin round alike.
//
// Bound: bytes. A block needs 24 of its 36 bytes of C and 12 of u in, 12 of
// y out, against 46 float operations (24 multiplies, 14 adds and subtracts,
// 2 negations, 3 divisions, the |det| test): N = 262144 needs 12.6 MB, about
// 3.8 us at the H100's 3.35 TB/s (15.7 MB and 4.7 us with all of C, whose
// unused lower triangle shares 32-byte sectors with the rest). A bucket of
// the solver has at most a few tens of thousands of blocks, so on the
// solver's path a launch costs its launch overhead.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) apply_cinv_kernel(
    const float* __restrict__ C, const float* __restrict__ u, float* __restrict__ y, int N,
    long long c_sn, long long c_sr, long long c_sc, long long u_sn, long long u_sc, float eps) {
  const long long n = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  const float* c = C + n * c_sn;
  const float xx = c[0];
  const float xy = c[c_sc];
  const float xz = c[2 * c_sc];
  const float yy = c[c_sr + c_sc];
  const float yz = c[c_sr + 2 * c_sc];
  const float zz = c[2 * c_sr + 2 * c_sc];
  const float* v = u + n * u_sn;
  const float u0 = v[0];
  const float u1 = v[u_sc];
  const float u2 = v[2 * u_sc];

  const float A = yy * zz - yz * yz;
  const float B = -(xy * zz - yz * xz);
  const float Cc = xy * yz - yy * xz;
  const float E = xx * zz - xz * xz;
  const float F = -(xx * yz - xy * xz);
  const float I = xx * yy - xy * xy;
  float det = xx * A + xy * B + xz * Cc;
  det = fabsf(det) < eps ? eps : det;

  float* out = y + n * 3;
  out[0] = (A * u0 + B * u1 + Cc * u2) / det;
  out[1] = (B * u0 + E * u1 + F * u2) / det;
  out[2] = (Cc * u0 + F * u1 + I * u2) / det;
}

}  // namespace

// Strides are in elements. y is contiguous [N, 3].
extern "C" int apply_cinv_launch(const float* C, const float* u, float* y, int N,
                                 long long c_sn, long long c_sr, long long c_sc,
                                 long long u_sn, long long u_sc, float eps, void* stream) {
  if (N < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (N + kThreads - 1) / kThreads;
  apply_cinv_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      C, u, y, N, c_sn, c_sr, c_sc, u_sn, u_sc, eps);
  return (int)cudaGetLastError();
}
