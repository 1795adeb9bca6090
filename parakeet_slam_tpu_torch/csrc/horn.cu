// Batched rotation fit of closed-form 3-D/3-D registration: for each
// cross-covariance M [3, 3] the proper rotation R that maximizes tr(R^T M),
// i.e. the Kabsch/Umeyama R = U diag(1, 1, sign(det U det V^T)) V^T of
// M = U S V^T, without the SVD.
//
// Replaces no Pallas kernel. It replaces the reference's jnp.linalg.svd and
// jnp.linalg.det inside its jitted closure verification
// (parakeet_slam_tpu/backend/graph.py:461, estimate_relative_pose_3d3d,
// vmapped by system.py's _verify_candidates). torch.linalg.svd and
// torch.linalg.det on CUDA check convergence and pivots on the host, so
// they cannot run inside a CUDA graph; this kernel reads nothing back and
// lets the whole verification (Horn's three rounds and the refine) be one
// graph. The plain twin is kernels/horn.py::rotation_fit_reference (the
// SVD/det code), run on CPU tensors.
//
// Method: Horn's quaternion form. tr(R(q)^T M) = q^T N q for a unit
// quaternion q = (w, x, y, z), with N the symmetric 4x4 matrix built from M
// below; q is the eigenvector of N's largest eigenvalue. One thread per
// matrix, in float64: cyclic Jacobi sweeps on N (each sweep zeroes the six
// off-diagonal pairs in turn) until the off-diagonal mass is below 1e-30 of
// the whole, at most kMaxSweeps; quadratic convergence ends a well-posed
// fit in 3-6 sweeps. The eigenvectors stay orthonormal whatever the input,
// so R is a rotation with det +1 even where M has rank 1 or 0 (then one of
// the optimal rotations; the identity for M = 0). Where the optimum is
// unique (sigma_2 > 0, and sigma_2 > sigma_3 when det M < 0) the gap of N's
// top eigenvalue is 2 (sigma_2 + sign(det M) sigma_3) and float64 leaves an
// error of about 1e-16 sigma_1 / gap before the float32 store.
//
// Bound: the launch. A matrix is 36 bytes in and 36 out; its work, in
// float64, is 14 operations to build N, 23 a convergence test (one more
// than the sweeps), 57 a Jacobi rotation (six a sweep) and 55 to normalize
// q and write R: ~1,500 for a fit of four sweeps. Closure verification fits
// Nc <= 16 matrices a round (three rounds a verify), far below one wave of
// the card, so any launch is at the launch floor.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxSweeps = 32;

__device__ __forceinline__ void rotate(double a[4][4], double v[4][4], int p, int q) {
  const double apq = a[p][q];
  if (apq == 0.0) return;
  const double theta = (a[q][q] - a[p][p]) / (2.0 * apq);
  // tan of the angle that zeroes a[p][q], the root of smaller magnitude;
  // 1 / (2 theta) where theta * theta would overflow
  const double at = fabs(theta);
  double t = at > 1e150 ? 0.5 / at : 1.0 / (at + sqrt(theta * theta + 1.0));
  if (theta < 0.0) t = -t;
  const double c = 1.0 / sqrt(t * t + 1.0);
  const double s = t * c;
  a[p][p] -= t * apq;
  a[q][q] += t * apq;
  a[p][q] = a[q][p] = 0.0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (r != p && r != q) {
      const double arp = a[r][p], arq = a[r][q];
      a[r][p] = a[p][r] = c * arp - s * arq;
      a[r][q] = a[q][r] = s * arp + c * arq;
    }
    const double vrp = v[r][p], vrq = v[r][q];
    v[r][p] = c * vrp - s * vrq;
    v[r][q] = s * vrp + c * vrq;
  }
}

__global__ void __launch_bounds__(kThreads) rotation_fit_kernel(
    const float* __restrict__ cov, float* __restrict__ R, int* __restrict__ sweeps, int B,
    long long s_b, long long s_r, long long s_c) {
  const long long b = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  const float* m = cov + b * s_b;
  double M[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) M[i][j] = (double)m[i * s_r + j * s_c];

  // q^T N q = sum_ij R(q)_ij M_ij, q = (w, x, y, z)
  double a[4][4];
  a[0][0] = M[0][0] + M[1][1] + M[2][2];
  a[1][1] = M[0][0] - M[1][1] - M[2][2];
  a[2][2] = -M[0][0] + M[1][1] - M[2][2];
  a[3][3] = -M[0][0] - M[1][1] + M[2][2];
  a[0][1] = a[1][0] = M[2][1] - M[1][2];
  a[0][2] = a[2][0] = M[0][2] - M[2][0];
  a[0][3] = a[3][0] = M[1][0] - M[0][1];
  a[1][2] = a[2][1] = M[0][1] + M[1][0];
  a[1][3] = a[3][1] = M[0][2] + M[2][0];
  a[2][3] = a[3][2] = M[1][2] + M[2][1];
  double v[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) v[i][j] = i == j ? 1.0 : 0.0;

  int sweep = 0;
  for (; sweep < kMaxSweeps; ++sweep) {
    double off = 0.0, diag = 0.0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      diag += a[i][i] * a[i][i];
#pragma unroll
      for (int j = i + 1; j < 4; ++j) off += a[i][j] * a[i][j];
    }
    // also false for a NaN input, which then runs every sweep
    if (off <= 1e-30 * (diag + off)) break;
    rotate(a, v, 0, 1);
    rotate(a, v, 0, 2);
    rotate(a, v, 0, 3);
    rotate(a, v, 1, 2);
    rotate(a, v, 1, 3);
    rotate(a, v, 2, 3);
  }

  // the largest eigenvalue's column (the first of equal ones), picked with
  // constant indices so that a and v stay in registers
  double top = a[0][0], w = v[0][0], x = v[1][0], y = v[2][0], z = v[3][0];
#pragma unroll
  for (int i = 1; i < 4; ++i) {
    if (a[i][i] > top) {
      top = a[i][i];
      w = v[0][i];
      x = v[1][i];
      y = v[2][i];
      z = v[3][i];
    }
  }
  const double inv = 1.0 / sqrt(w * w + x * x + y * y + z * z);
  w *= inv;
  x *= inv;
  y *= inv;
  z *= inv;

  float* out = R + b * 9;
  out[0] = (float)(1.0 - 2.0 * (y * y + z * z));
  out[1] = (float)(2.0 * (x * y - w * z));
  out[2] = (float)(2.0 * (x * z + w * y));
  out[3] = (float)(2.0 * (x * y + w * z));
  out[4] = (float)(1.0 - 2.0 * (x * x + z * z));
  out[5] = (float)(2.0 * (y * z - w * x));
  out[6] = (float)(2.0 * (x * z - w * y));
  out[7] = (float)(2.0 * (y * z + w * x));
  out[8] = (float)(1.0 - 2.0 * (x * x + y * y));
  if (sweeps != nullptr) sweeps[b] = sweep;
}

}  // namespace

// cov's strides are in elements; R is contiguous [B, 3, 3]; sweeps, where
// not null, receives each matrix's number of Jacobi sweeps [B].
extern "C" int rotation_fit_launch(const float* cov, float* R, int* sweeps, int B,
                                   long long s_b, long long s_r, long long s_c, void* stream) {
  if (B < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (B + kThreads - 1) / kThreads;
  rotation_fit_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(cov, R, sweeps, B, s_b,
                                                                     s_r, s_c);
  return (int)cudaGetLastError();
}
