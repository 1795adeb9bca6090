// The FastSLAM 2.0 proposal's refinement for the SE(3) vision models
// (stereo_3d, pinhole_3d): for every particle, the pose Gaussian of the
// motion model (mean pose [7], tangent covariance [6, 6]) is EKF-updated by
// each of the frame's Z observations in order that matches a known
// landmark, and the log-weight takes that observation's likelihood.
//
// Replaces no Pallas kernel. It replaces the Python loop over the
// observations of filter/fastslam2.py (now kernels/propose_3d.py::refine),
// which runs ~370 small torch kernels an observation: at kitti00's shape
// (P = 2048, Z = 128) ~47,000 graph nodes a frame. The plain twin is
// kernels/propose_3d.py::propose_3d_reference, that loop with the hoisted
// association, run on CPU tensors.
//
// Design: the particles are independent and an observation's step depends
// on the previous one's pose and covariance, so one thread walks one
// particle's chain of Z steps with the pose, the 6x6 covariance and the
// step's temporaries in registers; the association (best lane, its
// log-likelihood) is known before the chain, so the landmark gathers do not
// wait on the pose. An unmatched observation only adds its weight. Blocks of
// 32 threads spread P = 2048 particles over 64 SMs.
//
// Bound: the serial chain. A matched step gathers a lane's mean and
// covariance and its count (52 B) and does ~2,700 float operations (1,152
// fma at Dz = 3, counted as two each, the two 6x6x6 Joseph products 432 of
// them, and ~400 more); an unmatched step reads 8 B. kitti00's steady
// frames have ~150,000 matched steps of P x Z = 262,144: ~10 MB (3 us at
// 3.35 TB/s) and ~0.41 GFLOP (6 us at 67 TFLOP/s). The floor is the latency
// of each particle's chain of dependent steps, one warp an SM: the kernel
// takes ~0.44 ms a frame there, against ~47,000 graph nodes and ~70 ms for
// the loop.
//
// Bits: the loop on the card rounds as torch's CUDA kernels round, and the
// kernel repeats each of its operations in the same order (built with
// -fmad=false, so nothing is contracted that the loop does not contract):
//   - every `@` between matrices is a cuBLAS batched sgemm (FFMA kernels):
//     each output element is an fma chain over k in ascending order from 0;
//     chained products go left to right as Python evaluates them;
//   - a product with a vector side (K nu, V v in the retraction, the
//     einsum's two) goes to other cuBLAS kernels, which add its products
//     in one of three orders by the shape and the batch count (at kitti00's
//     P = 2048 the einsum's x^T S^-1 is interleaved and the rest chunked; at
//     P = 64 x^T S^-1 is sequential). orders_kernel reads which from torch's
//     own products at the batch count in use, once, on the device (dot_in
//     below);
//   - each elementwise torch op rounds once: a Python constant enters as
//     its float32 cast, `c / x` of a Python constant is torch's
//     reciprocal(x) * c, `x / c` is x * float32(1 / c), `c - x` is one
//     subtraction;
//   - torch.linalg.cross's kernel computes a1 b2 - a2 b1 as
//     fma(a1, b2, -(a2 b1));
//   - the einsum of gaussian_loglik is two batched products, (nu^T S^-1) nu;
//   - torch's reductions over a last dim of 3 to 6 take two threads
//     (element k to thread k mod 2), each adding its elements in two slots
//     (its first, third, ... in one, the others in the other): |delta| =
//     sqrt(((d0^2 + d4^2) + d2^2) + ((d1^2 + d5^2) + d3^2)), the
//     quaternion's norm sqrt((q0^2 + q2^2) + (q1^2 + q3^2)), and the sum of
//     the three squares of _safe_norm (s0 + s2) + s1; each square rounded;
//   - sinf, cosf, logf, sqrtf and the divisions are the CUDA maths
//     library's, as in torch's kernels.
// The rules were found on the card with torch 2.11 (CUDA 12.8) at P = 64,
// 512 and 2048; eval/propose_check.py finds them again with another torch
// or cuBLAS.
// eval/propose_check.py holds each rule against the loop's intermediates,
// and the kernel against the loop, with torch.equal on the card.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 32;
constexpr float kMinDepth = 0.1f;  // filter/models.py MIN_DEPTH

struct Consts {
  float fx, fy, cx, cy, fxb;  // fxb = float32(fx * baseline)
  float r[3];                 // diagonal of R
  float log_p0, unmatched_w, log2pi_d;
};

__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

// C = A B and C = A B^T as cuBLAS's FFMA gemm computes each element.
template <int M, int K, int N>
__device__ __forceinline__ void mm(const float (&A)[M][K], const float (&B)[K][N],
                                   float (&C)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < K; ++k) acc = __fmaf_rn(A[i][k], B[k][j], acc);
      C[i][j] = acc;
    }
}

template <int M, int K, int N>
__device__ __forceinline__ void mm_bt(const float (&A)[M][K], const float (&B)[N][K],
                                      float (&C)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < K; ++k) acc = __fmaf_rn(A[i][k], B[j][k], acc);
      C[i][j] = acc;
    }
}

// A product with a vector side goes to other cuBLAS kernels, and which one
// depends on the shape and the batch count. Each adds the rounded products
// p_k = a_k b_k in one of three orders: chunked (k split over two threads
// in chunks, fma chains, then added), interleaved (k mod 2), or sequential
// (one fma chain, as the sgemm). Over 3 entries: fma(a1, b1, p0) + p2,
// fma(a2, b2, p0) + p1, fma(a2, b2, fma(a1, b1, p0)); over 2 entries:
// fma(a1, b1, p0), p0 + p1, fma(a1, b1, p0). The orders word (see
// orders_kernel) holds a site's order in two bits at its kOrder* shift.
constexpr int kChunked = 0, kInterleaved = 1, kSequential = 2;
constexpr int kOrderKnu = 0, kOrderVv = 2, kOrderVm = 4, kOrderDot = 6;
constexpr int kOrderUnknown = 1 << 16;

__device__ __forceinline__ int order_of(int word, int site) { return (word >> site) & 3; }

template <int K>
__device__ __forceinline__ float dot_in(float a0, float b0, float a1, float b1, float a2,
                                        float b2, int order) {
  static_assert(K == 2 || K == 3, "dot_in: K is 2 or 3");
  if constexpr (K == 3) {
    if (order == kInterleaved) return __fmaf_rn(a2, b2, a0 * b0) + a1 * b1;
    if (order == kSequential) return __fmaf_rn(a2, b2, __fmaf_rn(a1, b1, a0 * b0));
    return __fmaf_rn(a1, b1, a0 * b0) + a2 * b2;
  } else {
    return order == kInterleaved ? a0 * b0 + a1 * b1 : __fmaf_rn(a1, b1, a0 * b0);
  }
}

// y = A x
template <int M, int K>
__device__ __forceinline__ void mv(const float (&A)[M][K], const float (&x)[K], float (&y)[M],
                                   int order) {
#pragma unroll
  for (int i = 0; i < M; ++i)
    y[i] = dot_in<K>(A[i][0], x[0], A[i][1], x[1], A[i][K - 1], x[K - 1], order);
}

// y = x^T A
template <int K>
__device__ __forceinline__ void vm(const float (&x)[K], const float (&A)[K][K], float (&y)[K],
                                   int order) {
#pragma unroll
  for (int j = 0; j < K; ++j)
    y[j] = dot_in<K>(x[0], A[0][j], x[1], A[1][j], x[K - 1], A[K - 1][j], order);
}

template <int K>
__device__ __forceinline__ float dot(const float (&a)[K], const float (&b)[K], int order) {
  return dot_in<K>(a[0], b[0], a[1], b[1], a[K - 1], b[K - 1], order);
}

__device__ __forceinline__ void cross(const float a[3], const float b[3], float c[3]) {
  c[0] = __fmaf_rn(a[1], b[2], -(a[2] * b[1]));
  c[1] = __fmaf_rn(a[2], b[0], -(a[0] * b[2]));
  c[2] = __fmaf_rn(a[0], b[1], -(a[1] * b[0]));
}

// geometry.quat_rotate: v + w t + u x t, t = 2 u x v
__device__ __forceinline__ void quat_rotate(const float u[3], float w, const float v[3],
                                            float out[3]) {
  float t[3], c[3];
  cross(u, v, t);
#pragma unroll
  for (int k = 0; k < 3; ++k) t[k] = 2.0f * t[k];
  cross(u, t, c);
#pragma unroll
  for (int k = 0; k < 3; ++k) out[k] = (v[k] + w * t[k]) + c[k];
}

// geometry.quat_to_matrix
__device__ __forceinline__ void quat_to_matrix(const float q[4], float (&R)[3][3]) {
  const float x = q[0], y = q[1], z = q[2], w = q[3];
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, xz = x * z, yz = y * z;
  const float wx = w * x, wy = w * y, wz = w * z;
  R[0][0] = 1.0f - 2.0f * (yy + zz);
  R[0][1] = 2.0f * (xy - wz);
  R[0][2] = 2.0f * (xz + wy);
  R[1][0] = 2.0f * (xy + wz);
  R[1][1] = 1.0f - 2.0f * (xx + zz);
  R[1][2] = 2.0f * (yz - wx);
  R[2][0] = 2.0f * (xz - wy);
  R[2][1] = 2.0f * (yz + wx);
  R[2][2] = 1.0f - 2.0f * (xx + yy);
}

// The model's h, jac and pose_jac at one landmark (filter/models.py).
template <int DZ>
__device__ __forceinline__ void observe(const Consts& c, const float pose[7], const float mu[3],
                                        float (&zhat)[DZ], float (&Hm)[DZ][3],
                                        float (&Hx)[DZ][6]) {
  // p = se3_apply_inverse(pose, mu)
  const float u[3] = {-pose[3], -pose[4], -pose[5]};
  const float d[3] = {mu[0] - pose[0], mu[1] - pose[1], mu[2] - pose[2]};
  float p[3];
  quat_rotate(u, pose[6], d, p);
  const float z = clamp_min(p[2], kMinDepth);
  const float rz = 1.0f / z;
  const float zz = z * z;
  const float rzz = 1.0f / zz;
  zhat[0] = (c.fx * p[0]) / z + c.cx;
  zhat[1] = (c.fy * p[1]) / z + c.cy;
  // the rows of dh/dp_cam; pose_jac's carry the clamp's derivative
  const float e02 = (-c.fx * p[0]) / zz, e12 = (-c.fy * p[1]) / zz;
  const float e22 = rzz * -c.fxb;
  const float live = p[2] > kMinDepth ? 1.0f : 0.0f;
  float dz[DZ][3], hp[DZ][3];
  dz[0][0] = rz * c.fx; dz[0][1] = 0.0f; dz[0][2] = e02;
  dz[1][0] = 0.0f; dz[1][1] = rz * c.fy; dz[1][2] = e12;
  hp[0][0] = dz[0][0]; hp[0][1] = 0.0f; hp[0][2] = e02 * live;
  hp[1][0] = 0.0f; hp[1][1] = dz[1][1]; hp[1][2] = e12 * live;
  if constexpr (DZ == 3) {
    zhat[2] = rz * c.fxb;
    dz[2][0] = 0.0f; dz[2][1] = 0.0f; dz[2][2] = e22;
    hp[2][0] = 0.0f; hp[2][1] = 0.0f; hp[2][2] = e22 * live;
  }
  const float q[4] = {pose[3], pose[4], pose[5], pose[6]};
  float R[3][3];
  quat_to_matrix(q, R);
  mm_bt(dz, R, Hm);  // dz_dp @ R_wc^T
  const float hat[3][3] = {{0.0f, -p[2], p[1]}, {p[2], 0.0f, -p[0]}, {-p[1], p[0], 0.0f}};
  float hh[DZ][3];
  mm(hp, hat, hh);
#pragma unroll
  for (int r = 0; r < DZ; ++r)
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      Hx[r][k] = -hp[r][k];
      Hx[r][3 + k] = hh[r][k];
    }
}

// linalg.inv_psd: (inverse, det) by cofactors
__device__ __forceinline__ float inv_psd(const float (&m)[3][3], float (&inv)[3][3]) {
  const float a = m[0][0], b = m[0][1], c = m[0][2];
  const float d = m[1][0], e = m[1][1], f = m[1][2];
  const float g = m[2][0], h = m[2][1], i = m[2][2];
  const float A = e * i - f * h;
  const float B = -(d * i - f * g);
  const float C = d * h - e * g;
  const float D = -(b * i - c * h);
  const float E = a * i - c * g;
  const float F = -(a * h - b * g);
  const float G = b * f - c * e;
  const float H = -(a * f - c * d);
  const float I = a * e - b * d;
  const float det = (a * A + b * B) + c * C;
  const float ds = fabsf(det) < 1e-12f ? 1e-12f : det;
  inv[0][0] = A / ds; inv[0][1] = D / ds; inv[0][2] = G / ds;
  inv[1][0] = B / ds; inv[1][1] = E / ds; inv[1][2] = H / ds;
  inv[2][0] = C / ds; inv[2][1] = F / ds; inv[2][2] = I / ds;
  return det;
}

__device__ __forceinline__ float inv_psd(const float (&m)[2][2], float (&inv)[2][2]) {
  const float det = m[0][0] * m[1][1] - m[0][1] * m[1][0];
  const float ds = fabsf(det) < 1e-12f ? 1e-12f : det;
  inv[0][0] = m[1][1] / ds; inv[0][1] = -m[0][1] / ds;
  inv[1][0] = -m[1][0] / ds; inv[1][1] = m[0][0] / ds;
  return det;
}

// models.se3_retract: pose o exp(delta), in place
__device__ __forceinline__ void retract(float pose[7], const float delta[6], int order) {
  const float v[3] = {delta[0], delta[1], delta[2]};
  const float w[3] = {delta[3], delta[4], delta[5]};
  // so3_exp_quat(w)
  const float s0 = w[0] * w[0], s1 = w[1] * w[1], s2 = w[2] * w[2];
  const float theta = sqrtf((s0 + s2) + s1 + 1e-24f);
  const bool tiny = theta < 1e-8f;
  const float half = theta * 0.5f;
  const float k = tiny ? 0.5f - (theta * theta) * (1.0f / 48.0f)
                       : sinf(half) / (tiny ? 1.0f : theta);
  const float q[4] = {k * w[0], k * w[1], k * w[2], cosf(half)};
  // _se3_V(w) @ v
  const bool small = theta < 1e-6f;
  const float th = small ? 1.0f : theta;
  const float t2 = theta * theta, th2 = th * th;
  const float A = small ? 1.0f - t2 * (1.0f / 6.0f) : sinf(th) / th;
  const float B = small ? 0.5f - t2 * (1.0f / 24.0f) : (1.0f - cosf(th)) / th2;
  const float C = small ? 1.0f / 6.0f - t2 * (1.0f / 120.0f) : (1.0f - A) / th2;
  const float W[3][3] = {{0.0f, -w[2], w[1]}, {w[2], 0.0f, -w[0]}, {-w[1], w[0], 0.0f}};
  float WW[3][3], V[3][3];
  mm(W, W, WW);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) V[i][j] = ((i == j ? 1.0f : 0.0f) + B * W[i][j]) + C * WW[i][j];
  float t[3];
  mv(V, v, t, order);
  // se3_compose(pose, (t, q))
  const float qa[3] = {pose[3], pose[4], pose[5]};
  float rt[3];
  quat_rotate(qa, pose[6], t, rt);
  const float x1 = pose[3], y1 = pose[4], z1 = pose[5], w1 = pose[6];
  const float x2 = q[0], y2 = q[1], z2 = q[2], w2 = q[3];
  const float m[4] = {
      ((w1 * x2 + x1 * w2) + y1 * z2) - z1 * y2,
      ((w1 * y2 - x1 * z2) + y1 * w2) + z1 * x2,
      ((w1 * z2 + x1 * y2) - y1 * x2) + z1 * w2,
      ((w1 * w2 - x1 * x2) - y1 * y2) - z1 * z2,
  };
  const float n = clamp_min(
      sqrtf((m[0] * m[0] + m[2] * m[2]) + (m[1] * m[1] + m[3] * m[3])), 1e-12f);
#pragma unroll
  for (int k = 0; k < 3; ++k) pose[k] = pose[k] + rt[k];
#pragma unroll
  for (int k = 0; k < 4; ++k) pose[3 + k] = m[k] / n;
}

template <int DZ>
__global__ void __launch_bounds__(kThreads) propose_3d_kernel(
    const float* __restrict__ pose_in, const float* __restrict__ pcov_in,
    const float* __restrict__ logw_in, const int* __restrict__ best,
    const float* __restrict__ best_ll, const float* __restrict__ lm_mean,
    const float* __restrict__ lm_cov, const int* __restrict__ lm_count,
    const bool* __restrict__ any_valid, const float* __restrict__ zobs,
    const bool* __restrict__ valid, float* __restrict__ pose_out, float* __restrict__ pcov_out,
    float* __restrict__ logw_out, const int* __restrict__ orders, int P, int L, int Z,
    int weight_min_count, Consts c) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;
  float pose[7], Pc[6][6];
#pragma unroll
  for (int k = 0; k < 7; ++k) pose[k] = pose_in[(long long)p * 7 + k];
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) Pc[i][j] = pcov_in[(long long)p * 36 + i * 6 + j];
  float lw = logw_in[p];
  const bool anyv = any_valid[p];
  const int* brow = best + (long long)p * Z;
  const float* lrow = best_ll + (long long)p * Z;
  const long long lane0 = (long long)p * L;
  const int order = *orders;

  for (int i = 0; i < Z; ++i) {
    const bool v = valid[i];
    const int b = brow[i];
    bool matched = v && anyv && lrow[i] >= c.log_p0;
    if (matched && weight_min_count > 0) matched = lm_count[lane0 + b] >= weight_min_count;
    if (!matched) {
      lw = lw + (v ? c.unmatched_w : 0.0f);
      continue;
    }
    float mu[3], cv[3][3];
#pragma unroll
    for (int k = 0; k < 3; ++k) mu[k] = lm_mean[(lane0 + b) * 3 + k];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int k = 0; k < 3; ++k) cv[r][k] = lm_cov[(lane0 + b) * 9 + r * 3 + k];

    float zhat[DZ], Hm[DZ][3], Hx[DZ][6];
    observe<DZ>(c, pose, mu, zhat, Hm, Hx);
    float nu[DZ];
#pragma unroll
    for (int r = 0; r < DZ; ++r) nu[r] = zobs[i * DZ + r] - zhat[r];
    // Q = Hm cv Hm^T + R, S = Hx P Hx^T + Q
    float t1[DZ][3], Q[DZ][DZ], t3[DZ][6], S[DZ][DZ];
    mm(Hm, cv, t1);
    mm_bt(t1, Hm, Q);
    mm(Hx, Pc, t3);
    mm_bt(t3, Hx, S);
#pragma unroll
    for (int r = 0; r < DZ; ++r)
#pragma unroll
      for (int k = 0; k < DZ; ++k) {
        Q[r][k] = Q[r][k] + (r == k ? c.r[r] : 0.0f);
        S[r][k] = S[r][k] + Q[r][k];
      }
    float Sinv[DZ][DZ];
    const float det = inv_psd(S, Sinv);
    // K = P Hx^T S^-1, delta = K nu
    float t5[6][DZ], K[6][DZ], delta[6];
    mm_bt(Pc, Hx, t5);
    mm(t5, Sinv, K);
    mv(K, nu, delta, order_of(order, kOrderKnu));
    // Joseph form: (I - K Hx) P (I - K Hx)^T + K Q K^T, symmetrised
    float IKH[6][6], t6[6][6], Pn[6][6], t8[6][DZ], t9[6][6];
    mm(K, Hx, IKH);
#pragma unroll
    for (int r = 0; r < 6; ++r)
#pragma unroll
      for (int k = 0; k < 6; ++k) IKH[r][k] = (r == k ? 1.0f : 0.0f) - IKH[r][k];
    mm(IKH, Pc, t6);
    mm_bt(t6, IKH, Pn);
    mm(K, Q, t8);
    mm_bt(t8, K, t9);
#pragma unroll
    for (int r = 0; r < 6; ++r)
#pragma unroll
      for (int k = 0; k < 6; ++k) Pn[r][k] = Pn[r][k] + t9[r][k];
    bool finite = true;
#pragma unroll
    for (int r = 0; r < 6; ++r)
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        t6[r][k] = 0.5f * (Pn[r][k] + Pn[k][r]);
        finite = finite && isfinite(t6[r][k]);
      }
    // gaussian_loglik(S, nu): (nu^T S^-1) nu
    float tn[DZ];
    vm(nu, Sinv, tn, order_of(order, kOrderVm));
    const float maha = clamp_min(dot(tn, nu, order_of(order, kOrderDot)), 0.0f);
    const float ll = -0.5f * ((maha + logf(clamp_min(det, 1e-12f))) + c.log2pi_d);
    float sq[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      finite = finite && isfinite(delta[k]);
      sq[k] = delta[k] * delta[k];
    }
    const float norm = sqrtf(((sq[0] + sq[4]) + sq[2]) + ((sq[1] + sq[5]) + sq[3]));
    if (finite && isfinite(ll) && norm < 1.0f) {
      retract(pose, delta, order_of(order, kOrderVv));
#pragma unroll
      for (int r = 0; r < 6; ++r)
#pragma unroll
        for (int k = 0; k < 6; ++k) Pc[r][k] = t6[r][k];
      lw = lw + ll;
    } else {
      lw = lw + c.unmatched_w;
    }
  }

#pragma unroll
  for (int k = 0; k < 7; ++k) pose_out[(long long)p * 7 + k] = pose[k];
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) pcov_out[(long long)p * 36 + i * 6 + j] = Pc[i][j];
  logw_out[p] = lw;
}

// The orders word from torch's own products on random operands of the
// loop's shapes and strides at this batch count (kernels/propose_3d.py::
// orders): K nu (K [P, 6, DZ], nu [P, DZ]), V v (V [P, 3, 3], v the first
// three of a [P, 6] row) and the einsum (nu^T S) nu (S [P, DZ, DZ]). `miss`
// collects, per candidate, whether any particle's result differs.
template <int DZ>
__global__ void orders_kernel(const float* __restrict__ K, const float* __restrict__ nu,
                              const float* __restrict__ V, const float* __restrict__ d6,
                              const float* __restrict__ S, const float* __restrict__ knu,
                              const float* __restrict__ vv, const float* __restrict__ e, int P,
                              unsigned* __restrict__ miss) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  float x[DZ], A[DZ][DZ];
#pragma unroll
  for (int k = 0; k < DZ; ++k) {
    x[k] = nu[p * DZ + k];
#pragma unroll
    for (int j = 0; j < DZ; ++j) A[k][j] = S[(p * DZ + k) * DZ + j];
  }
  const float* d = d6 + p * 6;
  unsigned m = 0;
#pragma unroll
  for (int f = 0; f < 3; ++f) {
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const float* k = K + (p * 6 + i) * DZ;
      const float y = dot_in<DZ>(k[0], x[0], k[1], x[1], k[DZ - 1], x[DZ - 1], f);
      if (__float_as_uint(y) != __float_as_uint(knu[p * 6 + i])) m |= 1u << f;
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float* a = V + (p * 3 + i) * 3;
      const float y = dot_in<3>(a[0], d[0], a[1], d[1], a[2], d[2], f);
      if (__float_as_uint(y) != __float_as_uint(vv[p * 3 + i])) m |= 8u << f;
    }
  }
#pragma unroll
  for (int c = 0; c < 9; ++c) {
    float t[DZ];
    vm(x, A, t, c / 3);
    if (__float_as_uint(dot(t, x, c % 3)) != __float_as_uint(e[p])) m |= 64u << c;
  }
  if (m) atomicOr(miss, m);
}

// Each site's first order whose results all matched (the einsum's first
// pair of orders); kOrderUnknown where none did.
__global__ void orders_pick(const unsigned* __restrict__ miss, int* __restrict__ orders) {
  const unsigned m = *miss;
  int o = kOrderUnknown;
  for (int f = 2; f >= 0; --f) {
    if (!(m & (1u << f))) o = (o & ~(3 << kOrderKnu)) | (f << kOrderKnu);
    if (!(m & (8u << f))) o = (o & ~(3 << kOrderVv)) | (f << kOrderVv);
  }
  for (int c = 8; c >= 0; --c)
    if (!(m & (64u << c)))
      o = (o & ~((3 << kOrderVm) | (3 << kOrderDot))) | ((c / 3) << kOrderVm) |
          ((c % 3) << kOrderDot);
  const bool knu = (m & 7u) != 7u, vv = (m & 56u) != 56u, e = (m >> 6) != 511u;
  *orders = (knu && vv && e) ? (o & ~kOrderUnknown) : o;
}

}  // namespace

extern "C" int propose_3d_orders_launch(const float* K, const float* nu, const float* V,
                                        const float* d6, const float* S, const float* knu,
                                        const float* vv, const float* e, unsigned* miss,
                                        int* orders, int P, int dz, void* stream) {
  if (P < 1 || (dz != 2 && dz != 3)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(miss, 0, sizeof(unsigned), s);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (P + 127) / 128;
  if (dz == 3)
    orders_kernel<3><<<blocks, 128, 0, s>>>(K, nu, V, d6, S, knu, vv, e, P, miss);
  else
    orders_kernel<2><<<blocks, 128, 0, s>>>(K, nu, V, d6, S, knu, vv, e, P, miss);
  orders_pick<<<1, 1, 0, s>>>(miss, orders);
  return (int)cudaGetLastError();
}

// consts: fx, fy, cx, cy, fx * b, R's diagonal (3, zero-padded), log_p0,
// the unmatched weight, D log(2 pi) (kernels/propose_3d.py::constants).
extern "C" int propose_3d_launch(const float* pose, const float* pcov, const float* log_w,
                                 const int* best, const float* best_ll, const float* lm_mean,
                                 const float* lm_cov, const int* lm_count, const bool* any_valid,
                                 const float* z, const bool* valid, float* pose_out,
                                 float* pcov_out, float* logw_out, const int* orders, int P,
                                 int L, int Z, int model, int weight_min_count,
                                 const float* consts, void* stream) {
  if (P < 1 || L < 1 || Z < 0 || (model != 0 && model != 1)) return (int)cudaErrorInvalidValue;
  Consts c;
  c.fx = consts[0]; c.fy = consts[1]; c.cx = consts[2]; c.cy = consts[3]; c.fxb = consts[4];
  c.r[0] = consts[5]; c.r[1] = consts[6]; c.r[2] = consts[7];
  c.log_p0 = consts[8]; c.unmatched_w = consts[9]; c.log2pi_d = consts[10];
  const int blocks = (P + kThreads - 1) / kThreads;
  cudaStream_t s = (cudaStream_t)stream;
  if (model == 1)
    propose_3d_kernel<3><<<blocks, kThreads, 0, s>>>(
        pose, pcov, log_w, best, best_ll, lm_mean, lm_cov, lm_count, any_valid, z, valid,
        pose_out, pcov_out, logw_out, orders, P, L, Z, weight_min_count, c);
  else
    propose_3d_kernel<2><<<blocks, kThreads, 0, s>>>(
        pose, pcov, log_w, best, best_ll, lm_mean, lm_cov, lm_count, any_valid, z, valid,
        pose_out, pcov_out, logw_out, orders, P, L, Z, weight_min_count, c);
  return (int)cudaGetLastError();
}
