// Fused FastSLAM measurement update and association scores for the 3-D
// vision models (pinhole_3d, stereo_3d, equirect_3d).
//
// Replaces the TPU kernels of parakeet_slam_tpu/kernels/ekf_update_3d.py:
//   score_3d_kernel       <- score_3d (_score_entry, _score_pass);
//   ekf_update_3d_kernel  <- measurement_update_3d (_kernel, with
//                            ekf_common.fill_free_slots and ekf_common.associate).
// Both compute what the reference's XLA path computes
// (FastSLAM.measurement_core with use_pallas=False, filter/fastslam.py):
//   1. score every observation against every valid lane of the PRE-FRAME map:
//      ll = log N(z; h(m), H S H^T + R) - desc_weight * popcount(desc ^ lm_desc);
//      invalid lanes and non-finite scores count -1e30; best lane = largest
//      ll, smallest lane among equal maxima (or external scores, ext_ll/ext_ix);
//   2. new landmark iff best < log_p0 or the particle has no valid lane; new
//      observations take the first min(Z, 64) free lanes in ascending order,
//      by their exclusive rank in observation order;
//   3. log_w += sum over valid obs of (new ? log_p0 : best ll), when asked;
//   4. EKF updates (mean and covariance kept when the lane's count reached
//      `freeze`), landmark inits (ray prior or stereo triangulation), counts
//      and the latest descriptor, applied in observation order per lane;
//   5. cull: valid, unmatched (and in view unless cull_unseen) lanes lose one
//      count; a lane stays valid while its count is >= 0.
// Arithmetic follows the plain PyTorch twins (kernels/ekf_update_3d.py)
// operation for operation, and the library is built with -fmad=false, so
// that masks, lanes and counts agree exactly with the twins on the card.
// score_3d_kernel and the update's own score pass are one device function,
// score_sweep, so their scores and lanes are equal bit for bit.
//
// Design: one block per particle, working straight from device memory in
// the JAX layout ([P, L, 3] means, [P, L, 3, 3] covariances, [P, L, W]
// descriptor words); the update writes the state IN PLACE (the Pallas call
// aliases it the same way). Only lanes below the particle's live
// high-watermark are swept.
//   - score_sweep lists each window of 256 lanes' valid lanes in ascending
//     order and stages their geometry (zhat, Q^-1, log det Q) and
//     descriptors once per frame as shared-memory records; observations lie
//     across threads, each sweeping every G-th record with its z and
//     descriptor in registers (no divergence on invalid lanes, no geometry
//     redone per observation). The same window ballot lists the free lanes,
//     so the update needs no second scan over L for its free slots.
//   - The update keeps the per-observation best (ll, lane), the free-slot
//     list, the targets and a bitmap of the lanes matched this frame in
//     shared memory. Fed scores (ext), it skips the sweep and lists the free
//     lanes by the same ballot, stopping at the first min(Z, 64). The apply
//     pass runs one thread per distinct target lane, which walks that
//     lane's observations in order; the cull one thread per lane below the
//     high-watermark.
//
// Bound: a pair costs about 60 instructions (the Mahalanobis form, W
// popcounts at an eighth of the FP32 rate, the argmax); at P=2048,
// L=10240, Z=128 with half the lanes valid that is 1.34 G pairs, so both
// kernels scoring a frame are bound by instruction issue, not by the 1.78 GB
// state. Fed scores, the update reads only the flags below the
// high-watermark, the valid lanes' means and counts for the cull and the
// targeted lanes: ~0.3 GB at that shape, and its per-lane loops wait on
// memory (the cull's chain of flag, mean and count loads a lane).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>
#include <string.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxZ = 256;
constexpr int kMaxW = 8;
constexpr int kMaxFree = 64;
constexpr int kMaxL = 1 << 18;
constexpr int kMaxBitmapBytes = kMaxL / 8;
static_assert(kMaxZ <= kThreads, "the association gives each observation a thread");
constexpr float kNegInf = -1e30f;
constexpr float kMinDepth = 0.1f;
constexpr int kPinhole = 0, kStereo = 1, kEquirect = 2;
// Three blocks of 256 threads per SM: caps the kernels at 80 registers, at
// the cost of up to 24 bytes of spills; both kernels were faster so than at
// two blocks per SM in the same call on an H100.
constexpr int kMinBlocksPerSM = 3;

// Float constants of one call, in the order of ekf_update_3d.Consts.NAMES.
struct Consts {
  float fx, fy, cx, cy, inv_fx, inv_fy, fxb, img_w, img_h, inv_img_w, inv_img_h, ku, kv;
  float r0, r1, r2, desc_weight, log_p0, log2pi_d, init_infl, range_prior, sr2, st2;
  float max_range, pi, half_pi, two_pi, inv_pi, inv_2pi;
};
constexpr int kNumConsts = 29;
static_assert(sizeof(Consts) == kNumConsts * sizeof(float), "Consts layout");

struct Flags {
  int P, L, Z, W, freeze, update_weights, cull, cull_unseen, ext;
};

struct Cam {
  float R[3][3];  // R_cw
  float t[3];
};

template <int MODEL>
struct Dims {
  static constexpr int Dz = MODEL == kStereo ? 3 : 2;
};

// max(x, m) / clamp that keep a NaN x, as torch.clamp does.
__device__ __forceinline__ float clamp_min(float x, float m) { return x < m ? m : x; }
__device__ __forceinline__ float clamp_pm1(float x) {
  return x < -1.f ? -1.f : (x > 1.f ? 1.f : x);
}

__device__ __forceinline__ float dot3(float a0, float b0, float a1, float b1, float a2,
                                      float b2) {
  return (a0 * b0 + a1 * b1) + a2 * b2;
}

// (a, ia) <- the better of (a, ia) and (b, ib): larger ll, then smaller lane.
__device__ __forceinline__ void take_better(float& a, int& ia, float b, int ib) {
  if (b > a || (b == a && ib < ia)) {
    a = b;
    ia = ib;
  }
}

__device__ __forceinline__ Cam load_cam(const float* cam, int p) {
  Cam c;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) c.R[i][j] = cam[12 * p + 3 * i + j];
  for (int k = 0; k < 3; ++k) c.t[k] = cam[12 * p + 9 + k];
  return c;
}

// p = R_cw (m - t)
__device__ __forceinline__ void cam_point(const Cam& cam, const float m[3], float p[3]) {
  const float d0 = m[0] - cam.t[0], d1 = m[1] - cam.t[1], d2 = m[2] - cam.t[2];
  for (int i = 0; i < 3; ++i) p[i] = dot3(cam.R[i][0], d0, cam.R[i][1], d1, cam.R[i][2], d2);
}

// R_cw^T a
__device__ __forceinline__ void rotate_to_world(const Cam& cam, const float a[3], float r[3]) {
  for (int k = 0; k < 3; ++k)
    r[k] = dot3(cam.R[0][k], a[0], cam.R[1][k], a[1], cam.R[2][k], a[2]);
}

// zhat [Dz] and H = d zhat / d m [Dz][3] at camera point p.
template <int MODEL>
__device__ __forceinline__ void zhat_jac(const Consts& c, const Cam& cam, const float p[3],
                                         float zh[3], float H[3][3]) {
  const float(&R)[3][3] = cam.R;
  if constexpr (MODEL != kEquirect) {
    const float z = clamp_min(p[2], kMinDepth);
    const float zz = z * z;
    zh[0] = (c.fx * p[0]) / z + c.cx;
    zh[1] = (c.fy * p[1]) / z + c.cy;
    float a = c.fx / z, b = (-c.fx * p[0]) / zz;
    for (int j = 0; j < 3; ++j) H[0][j] = a * R[0][j] + b * R[2][j];
    a = c.fy / z;
    b = (-c.fy * p[1]) / zz;
    for (int j = 0; j < 3; ++j) H[1][j] = a * R[1][j] + b * R[2][j];
    if constexpr (MODEL == kStereo) {
      zh[2] = c.fxb / z;
      b = (-c.fxb) / zz;
      for (int j = 0; j < 3; ++j) H[2][j] = b * R[2][j];
    }
  } else {
    const float x = p[0], y = p[1], z = p[2];
    const float xx_yy = x * x + y * y;
    const float r = sqrtf(xx_yy + z * z) + 1e-9f;
    const float az = atan2f(y, x);
    const float el = asinf(clamp_pm1(z / r));
    zh[0] = ((az + c.pi) * c.inv_2pi) * c.img_w;
    zh[1] = ((c.half_pi - el) * c.inv_pi) * c.img_h;
    const float rho2 = xx_yy + 1e-9f;
    const float rho = sqrtf(rho2);
    const float den = (rho2 + z * z) * rho;
    const float du0 = c.ku * (-y / rho2), du1 = c.ku * (x / rho2);
    const float dv0 = (-c.kv * (-x * z)) / den, dv1 = (-c.kv * (-y * z)) / den;
    const float dv2 = (-c.kv * rho2) / den;
    for (int j = 0; j < 3; ++j) {
      H[0][j] = du0 * R[0][j] + du1 * R[1][j];
      H[1][j] = dot3(dv0, R[0][j], dv1, R[1][j], dv2, R[2][j]);
    }
  }
}

// Inverse of a Dz x Dz matrix with the reference's |det| < 1e-12 clamp.
template <int D>
__device__ __forceinline__ float inverse(const float Q[3][3], float inv[3][3]) {
  if constexpr (D == 2) {
    const float det = Q[0][0] * Q[1][1] - Q[0][1] * Q[1][0];
    const float ds = fabsf(det) < 1e-12f ? 1e-12f : det;
    inv[0][0] = Q[1][1] / ds;
    inv[0][1] = -Q[0][1] / ds;
    inv[1][0] = -Q[1][0] / ds;
    inv[1][1] = Q[0][0] / ds;
    return det;
  } else {
    const float a = Q[0][0], b = Q[0][1], cc = Q[0][2];
    const float d = Q[1][0], e = Q[1][1], f = Q[1][2];
    const float g = Q[2][0], h = Q[2][1], i = Q[2][2];
    const float A = e * i - f * h;
    const float B = -(d * i - f * g);
    const float C = d * h - e * g;
    const float Dc = -(b * i - cc * h);
    const float E = a * i - cc * g;
    const float F = -(a * h - b * g);
    const float G = b * f - cc * e;
    const float Hc = -(a * f - cc * d);
    const float II = a * e - b * d;
    const float det = (a * A + b * B) + cc * C;
    const float ds = fabsf(det) < 1e-12f ? 1e-12f : det;
    inv[0][0] = A / ds;
    inv[0][1] = Dc / ds;
    inv[0][2] = G / ds;
    inv[1][0] = B / ds;
    inv[1][1] = E / ds;
    inv[1][2] = Hc / ds;
    inv[2][0] = C / ds;
    inv[2][1] = F / ds;
    inv[2][2] = II / ds;
    return det;
  }
}

// Q = (H S) H^T + diag(r)
template <int D>
__device__ __forceinline__ void innovation_cov(const Consts& c, const float H[3][3],
                                               const float S[3][3], float Q[3][3]) {
  float A[3][3];
  for (int i = 0; i < D; ++i)
    for (int j = 0; j < 3; ++j)
      A[i][j] = dot3(H[i][0], S[0][j], H[i][1], S[1][j], H[i][2], S[2][j]);
  for (int i = 0; i < D; ++i)
    for (int j = 0; j < D; ++j)
      Q[i][j] = dot3(A[i][0], H[j][0], A[i][1], H[j][1], A[i][2], H[j][2]);
  const float r[3] = {c.r0, c.r1, c.r2};
  for (int k = 0; k < D; ++k) Q[k][k] = Q[k][k] + r[k];
}

template <int MODEL>
__device__ __forceinline__ void residual(const Consts& c, const float* z, const float zh[3],
                                         float nu[3]) {
  for (int k = 0; k < Dims<MODEL>::Dz; ++k) nu[k] = z[k] - zh[k];
  if constexpr (MODEL == kEquirect) nu[0] = nu[0] - c.img_w * rintf(nu[0] * c.inv_img_w);
}

template <int D>
__device__ __forceinline__ float maha(const float nu[3], const float inv[3][3]) {
  float t[3];
  for (int j = 0; j < D; ++j) {
    float acc = nu[0] * inv[0][j];
    for (int i = 1; i < D; ++i) acc = acc + nu[i] * inv[i][j];
    t[j] = acc;
  }
  float acc = t[0] * nu[0];
  for (int j = 1; j < D; ++j) acc = acc + t[j] * nu[j];
  return clamp_min(acc, 0.f);
}

// One lane's scoring geometry: zhat, Q^-1 and log det Q.
struct LaneGeom {
  float zh[3];
  float inv[3][3];
  float logdet;
};

template <int MODEL>
__device__ __forceinline__ void lane_geometry(const Consts& c, const Cam& cam, const float* mean,
                                              const float* cov, LaneGeom& g) {
  constexpr int D = Dims<MODEL>::Dz;
  float m[3] = {mean[0], mean[1], mean[2]};
  float S[3][3];
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b) S[a][b] = cov[3 * a + b];
  float p[3], H[3][3], Q[3][3];
  cam_point(cam, m, p);
  zhat_jac<MODEL>(c, cam, p, g.zh, H);
  innovation_cov<D>(c, H, S, Q);
  const float det = inverse<D>(Q, g.inv);
  g.logdet = logf(clamp_min(det, 1e-12f));
}

// One past the last valid lane of this block's particle.
__device__ int high_watermark(const uint8_t* __restrict__ valid, int L, int* s_red) {
  const int tid = threadIdx.x;
  int hi = -1;
  for (int l = tid; l < L; l += kThreads)
    if (valid[l]) hi = l;
  for (int off = 16; off > 0; off >>= 1) hi = max(hi, __shfl_down_sync(0xffffffffu, hi, off));
  if ((tid & 31) == 0) s_red[tid >> 5] = hi;
  __syncthreads();
  int out = -1;
  for (int w = 0; w < kWarps; ++w) out = max(out, s_red[w]);
  __syncthreads();
  return out + 1;
}

__device__ void load_obs(const Flags& f, int Dz, const float* z, const int32_t* desc,
                         float (*s_z)[3], uint32_t (*s_desc)[kMaxW]) {
  for (int i = threadIdx.x; i < f.Z; i += kThreads) {
    for (int k = 0; k < Dz; ++k) s_z[i][k] = z[i * Dz + k];
    for (int w = 0; w < f.W; ++w) s_desc[i][w] = (uint32_t)desc[i * f.W + w];
  }
}

// score_3d's lane record: one valid lane's scoring geometry and descriptor,
// staged once per frame in shared memory (64 bytes for Dz = 2, 96 for 3).
template <int D>
struct alignas(16) ScoreRec {
  float zh[D];
  float logdet;
  float inv[D][D];
  int lane;
  alignas(16) uint32_t desc[kMaxW];
};
static_assert(sizeof(ScoreRec<2>) == 64 && sizeof(ScoreRec<3>) == 96, "ScoreRec layout");

template <int D>
__device__ __forceinline__ ScoreRec<D> load_score_rec(const ScoreRec<D>* rec, bool with_desc) {
  constexpr int kGeom = (sizeof(ScoreRec<D>) - kMaxW * sizeof(uint32_t)) / 16;
  const float4* src = reinterpret_cast<const float4*>(rec);
  ScoreRec<D> R;
  float4* dst = reinterpret_cast<float4*>(&R);
#pragma unroll
  for (int k = 0; k < kGeom; ++k) dst[k] = src[k];
  if (with_desc) {
    dst[kGeom] = src[kGeom];
    dst[kGeom + 1] = src[kGeom + 1];
  }
  return R;
}

// The pair's score, in the twin's arithmetic (`_pair_scores`).
template <int MODEL>
__device__ __forceinline__ float score_pair(const Consts& c, int W, const ScoreRec<Dims<MODEL>::Dz>& R,
                                            const float* zt, const uint32_t* zd) {
  constexpr int D = Dims<MODEL>::Dz;
  float inv[3][3];
#pragma unroll
  for (int a = 0; a < D; ++a)
#pragma unroll
    for (int b = 0; b < D; ++b) inv[a][b] = R.inv[a][b];
  float zh[3] = {R.zh[0], R.zh[1], D == 3 ? R.zh[D - 1] : 0.f};
  float nu[3];
  residual<MODEL>(c, zt, zh, nu);
  float ll = -0.5f * ((maha<D>(nu, inv) + R.logdet) + c.log2pi_d);
  if (W > 0) {
    int ham = 0;
#pragma unroll
    for (int w = 0; w < kMaxW; ++w)
      if (w < W) ham += __popc(R.desc[w] ^ zd[w]);
    ll = ll - c.desc_weight * (float)ham;
  }
  return isfinite(ll) ? ll : kNegInf;
}

// Appends this window's free lanes below hwm to s_free in ascending order
// while fewer than n_fs are listed; `holes` is the warp's ballot of them and
// s_hcount [kWarps] the per-warp counts, written and synced by the caller.
// Returns the new count of free lanes seen (uniform across the block).
__device__ __forceinline__ int list_holes(int l, unsigned holes, const int* s_hcount, int nfree,
                                          int n_fs, int* s_free) {
  const int lane_id = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int rank = nfree + __popc(holes & ((1u << lane_id) - 1u)), total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    rank += w < warp ? s_hcount[w] : 0;
    total += s_hcount[w];
  }
  if (((holes >> lane_id) & 1u) && rank < n_fs) s_free[rank] = l;
  return nfree + total;
}

// The score sweep of both kernels: per observation i < Z of this block's
// particle, the best lane below hwm and its score into best_ll[i] /
// best_ix[i] (global or shared), every lane at or above hwm being invalid.
// Lanes below the high-watermark are walked in windows of 256: each
// window's valid lanes are listed in ascending order (ballot and prefix) and
// their geometry and descriptors staged as records; then thread t, owning
// observation t % Z in group t / Z of G = 256 / Z groups, sweeps every G-th
// record with its z and descriptor in registers and one running (best,
// lane). The groups merge by the first-lane rule, and the smallest invalid
// lane enters the merge at -1e30, as the invalid lanes score in the twin.
// The same ballot lists the first n_fs free lanes below hwm in s_free, in
// ascending order; returns how many free lanes lie below hwm. Expects s_z
// and s_desc loaded and synced; ends without a barrier after its writes.
template <int MODEL>
__device__ int score_sweep(const Consts& c, const Flags& f, const Cam& cm, int hwm,
                           const float* __restrict__ mean, const float* __restrict__ cov,
                           const int32_t* __restrict__ ldesc, const uint8_t* __restrict__ valid,
                           const float (*s_z)[3], const uint32_t (*s_desc)[kMaxW],
                           ScoreRec<Dims<MODEL>::Dz>* s_rec, float* s_part_ll, int* s_part_ix,
                           int* s_wcount, int* s_hcount, int* s_free, int n_fs,
                           float* best_ll, int* best_ix) {
  constexpr int D = Dims<MODEL>::Dz;
  const int tid = threadIdx.x, lane_id = tid & 31, warp = tid >> 5;
  const int L = f.L, Z = f.Z, W = f.W;
  const int G = kThreads / Z;
  const int my_i = tid % Z, my_g = tid / Z;
  const bool sweeps = my_g < G;
  float zt[3];
  uint32_t zd[kMaxW];
#pragma unroll
  for (int k = 0; k < 3; ++k) zt[k] = k < D ? s_z[my_i][k] : 0.f;
#pragma unroll
  for (int w = 0; w < kMaxW; ++w) zd[w] = w < W ? s_desc[my_i][w] : 0u;
  float best = -CUDART_INF_F;
  int bix = 0x7fffffff, nfree = 0;

  for (int l0 = 0; l0 < hwm; l0 += kThreads) {
    const int l = l0 + tid;
    const bool ok = l < hwm && valid[l] != 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, ok);
    const unsigned holes = __ballot_sync(0xffffffffu, l < hwm && !ok);
    if (lane_id == 0) {
      s_wcount[warp] = __popc(ballot);
      s_hcount[warp] = __popc(holes);
    }
    __syncthreads();
    nfree = list_holes(l, holes, s_hcount, nfree, n_fs, s_free);
    int rank = __popc(ballot & ((1u << lane_id) - 1u)), listed = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      rank += w < warp ? s_wcount[w] : 0;
      listed += s_wcount[w];
    }
    if (ok) {
      LaneGeom g;
      lane_geometry<MODEL>(c, cm, mean + 3 * (size_t)l, cov + 9 * (size_t)l, g);
      ScoreRec<D>& R = s_rec[rank];
#pragma unroll
      for (int k = 0; k < D; ++k) R.zh[k] = g.zh[k];
      R.logdet = g.logdet;
#pragma unroll
      for (int a = 0; a < D; ++a)
#pragma unroll
        for (int b = 0; b < D; ++b) R.inv[a][b] = g.inv[a][b];
      R.lane = l;
#pragma unroll
      for (int w = 0; w < kMaxW; ++w) R.desc[w] = w < W ? (uint32_t)ldesc[(size_t)l * W + w] : 0u;
    }
    __syncthreads();
    if (sweeps) {
      int j = my_g;
      for (; j + G < listed; j += 2 * G) {
        const ScoreRec<D> A = load_score_rec<D>(&s_rec[j], W > 0);
        const ScoreRec<D> B = load_score_rec<D>(&s_rec[j + G], W > 0);
        const float a = score_pair<MODEL>(c, W, A, zt, zd);
        const float b = score_pair<MODEL>(c, W, B, zt, zd);
        if (a > best) { best = a; bix = A.lane; }  // lanes rise: keeps the first maximum
        if (b > best) { best = b; bix = B.lane; }
      }
      if (j < listed) {
        const ScoreRec<D> A = load_score_rec<D>(&s_rec[j], W > 0);
        const float a = score_pair<MODEL>(c, W, A, zt, zd);
        if (a > best) { best = a; bix = A.lane; }
      }
    }
    __syncthreads();
  }

  s_part_ll[tid] = best;
  s_part_ix[tid] = bix;
  __syncthreads();
  // every lane at or above hwm is invalid: the first of them, if none below
  const int first_free = nfree > 0 ? s_free[0] : hwm;
  for (int i = tid; i < Z; i += kThreads) {
    float a = s_part_ll[i];
    int ia = s_part_ix[i];
    for (int g = 1; g < G; ++g) take_better(a, ia, s_part_ll[g * Z + i], s_part_ix[g * Z + i]);
    if (first_free < L) take_better(a, ia, kNegInf, first_free);
    best_ll[i] = a;
    best_ix[i] = ia;
  }
  return nfree;
}

// score_3d: the best lane and its score per (particle, observation), one
// block per particle, by score_sweep.
template <int MODEL>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSM) score_3d_kernel(
    const float* __restrict__ cam, const float* __restrict__ lm_mean,
    const float* __restrict__ lm_cov, const int32_t* __restrict__ lm_desc,
    const uint8_t* __restrict__ lm_valid, const float* __restrict__ z,
    const int32_t* __restrict__ desc, float* __restrict__ out_ll, int32_t* __restrict__ out_ix,
    Consts c, Flags f) {
  constexpr int D = Dims<MODEL>::Dz;
  __shared__ ScoreRec<D> s_rec[kThreads];
  __shared__ float s_z[kMaxZ][3];
  __shared__ uint32_t s_desc[kMaxZ][kMaxW];
  __shared__ float s_part_ll[kThreads];
  __shared__ int s_part_ix[kThreads];
  __shared__ int s_wcount[kWarps];
  __shared__ int s_hcount[kWarps];
  __shared__ int s_red[kWarps];
  __shared__ int s_free[1];
  const int p = blockIdx.x;
  const size_t base = (size_t)p * f.L;
  load_obs(f, D, z, desc, s_z, s_desc);
  const Cam cm = load_cam(cam, p);
  const uint8_t* valid = lm_valid + base;
  const int hwm = high_watermark(valid, f.L, s_red);  // syncs the stores above
  score_sweep<MODEL>(c, f, cm, hwm, lm_mean + 3 * base, lm_cov + 9 * base, lm_desc + base * f.W,
                     valid, s_z, s_desc, s_rec, s_part_ll, s_part_ix, s_wcount, s_hcount, s_free,
                     1, out_ll + (size_t)p * f.Z, out_ix + (size_t)p * f.Z);
}

// A new landmark at observation z: (mean [3], cov [3][3]).
template <int MODEL>
__device__ void init_landmark(const Consts& c, const Cam& cam, const float* z, float mean[3],
                              float cov[3][3]) {
  if constexpr (MODEL == kStereo) {
    const float depth = c.fxb / clamp_min(z[2], 1e-3f);
    const float pc[3] = {((z[0] - c.cx) * c.inv_fx) * depth, ((z[1] - c.cy) * c.inv_fy) * depth,
                         depth};
    float r[3], p[3], zh[3], H[3][3], Hi[3][3];
    rotate_to_world(cam, pc, r);
    for (int k = 0; k < 3; ++k) mean[k] = cam.t[k] + r[k];
    cam_point(cam, mean, p);
    zhat_jac<MODEL>(c, cam, p, zh, H);
    for (int k = 0; k < 3; ++k) H[k][k] = H[k][k] + 1e-9f;
    inverse<3>(H, Hi);
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        cov[i][j] = c.init_infl * dot3(Hi[i][0] * c.r0, Hi[j][0], Hi[i][1] * c.r1, Hi[j][1],
                                       Hi[i][2] * c.r2, Hi[j][2]);
    return;
  }
  float ray[3];
  if constexpr (MODEL == kPinhole) {
    const float rx = (z[0] - c.cx) * c.inv_fx;
    const float ry = (z[1] - c.cy) * c.inv_fy;
    const float n = sqrtf((rx * rx + ry * ry) + 1.0f);
    ray[0] = rx / n;
    ray[1] = ry / n;
    ray[2] = 1.0f / n;
  } else {
    const float az = ((z[0] * c.inv_img_w) * c.two_pi) - c.pi;
    const float el = c.half_pi - (z[1] * c.inv_img_h) * c.pi;
    const float ce = cosf(el);
    ray[0] = ce * cosf(az);
    ray[1] = ce * sinf(az);
    ray[2] = sinf(el);
  }
  const float a[3] = {c.range_prior * ray[0], c.range_prior * ray[1], c.range_prior * ray[2]};
  float r[3], ray_w[3];
  rotate_to_world(cam, a, r);
  for (int k = 0; k < 3; ++k) mean[k] = cam.t[k] + r[k];
  rotate_to_world(cam, ray, ray_w);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      const float along = ray_w[i] * ray_w[j];
      const float rest = (i == j ? 1.0f : 0.0f) - along;
      cov[i][j] = c.init_infl * (c.sr2 * along + c.st2 * rest);
    }
}

// EKF update of one lane's (m, S) by one observation, in place.
template <int MODEL>
__device__ void ekf_lane_update(const Consts& c, const Cam& cam, const float* z, float m[3],
                                float S[3][3]) {
  constexpr int D = Dims<MODEL>::Dz;
  float p[3], zh[3], H[3][3], Q[3][3], Qi[3][3], nu[3];
  cam_point(cam, m, p);
  zhat_jac<MODEL>(c, cam, p, zh, H);
  residual<MODEL>(c, z, zh, nu);
  innovation_cov<D>(c, H, S, Q);
  inverse<D>(Q, Qi);
  float SHt[3][3], K[3][3];
  for (int k = 0; k < 3; ++k)
    for (int a = 0; a < D; ++a) SHt[k][a] = dot3(S[k][0], H[a][0], S[k][1], H[a][1], S[k][2], H[a][2]);
  for (int k = 0; k < 3; ++k)
    for (int a = 0; a < D; ++a) {
      float acc = SHt[k][0] * Qi[0][a];
      for (int b = 1; b < D; ++b) acc = acc + SHt[k][b] * Qi[b][a];
      K[k][a] = acc;
    }
  float mu[3], IKH[3][3], Sn[3][3];
  for (int k = 0; k < 3; ++k) {
    float acc = K[k][0] * nu[0];
    for (int a = 1; a < D; ++a) acc = acc + K[k][a] * nu[a];
    mu[k] = m[k] + acc;
  }
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b) {
      float acc = K[a][0] * H[0][b];
      for (int e = 1; e < D; ++e) acc = acc + K[a][e] * H[e][b];
      IKH[a][b] = (a == b ? 1.0f : 0.0f) - acc;
    }
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b)
      Sn[a][b] = dot3(IKH[a][0], S[0][b], IKH[a][1], S[1][b], IKH[a][2], S[2][b]);
  for (int k = 0; k < 3; ++k) m[k] = mu[k];
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b) S[a][b] = 0.5f * (Sn[a][b] + Sn[b][a]);
}

template <int MODEL>
__device__ __forceinline__ bool in_fov(const Consts& c, const Cam& cam, const float m[3]) {
  float p[3];
  cam_point(cam, m, p);
  if constexpr (MODEL == kEquirect) return sqrtf((p[0] * p[0] + p[1] * p[1]) + p[2] * p[2]) < c.max_range;
  float zh[3], H[3][3];
  zhat_jac<MODEL>(c, cam, p, zh, H);
  return (p[2] > 0.05f) && (p[2] < c.max_range) && (zh[0] >= 0.f) && (zh[0] < c.img_w) &&
         (zh[1] >= 0.f) && (zh[1] < c.img_h);
}

template <int MODEL>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSM) ekf_update_3d_kernel(
    const float* __restrict__ cam, float* __restrict__ log_w, float* __restrict__ lm_mean,
    float* __restrict__ lm_cov, int32_t* __restrict__ lm_desc, uint8_t* __restrict__ lm_valid,
    int32_t* __restrict__ lm_count, const float* __restrict__ z,
    const int32_t* __restrict__ desc, const uint8_t* __restrict__ zvalid,
    const float* __restrict__ ext_ll, const int32_t* __restrict__ ext_ix,
    float* __restrict__ n_match, int32_t* __restrict__ target, Consts c, Flags f) {
  constexpr int D = Dims<MODEL>::Dz;
  __shared__ ScoreRec<D> s_rec[kThreads];
  __shared__ float s_z[kMaxZ][3];
  __shared__ uint32_t s_desc[kMaxZ][kMaxW];
  __shared__ uint8_t s_zv[kMaxZ];
  __shared__ float s_best_ll[kMaxZ];
  __shared__ int s_best_ix[kMaxZ];
  __shared__ int s_tgt[kMaxZ];
  __shared__ uint8_t s_new[kMaxZ];
  __shared__ int s_free[kMaxFree];
  __shared__ float s_part_ll[kThreads];
  __shared__ int s_part_ix[kThreads];
  __shared__ int s_wcount[kWarps];
  __shared__ int s_hcount[kWarps];
  __shared__ int s_red[kWarps];
  extern __shared__ uint32_t s_matched[];  // one bit per lane

  const int p = blockIdx.x;
  const int tid = threadIdx.x, lane_id = tid & 31, warp = tid >> 5;
  const int L = f.L, Z = f.Z, W = f.W;
  const size_t base = (size_t)p * L;
  float* mean = lm_mean + 3 * base;
  float* cov = lm_cov + 9 * base;
  int32_t* ldesc = lm_desc + base * W;
  uint8_t* valid = lm_valid + base;
  int32_t* count = lm_count + base;

  load_obs(f, D, z, desc, s_z, s_desc);
  for (int i = tid; i < Z; i += kThreads) {
    s_zv[i] = zvalid[i];
    if (f.ext) {
      s_best_ll[i] = ext_ll[(size_t)p * Z + i];
      s_best_ix[i] = ext_ix[(size_t)p * Z + i];
    }
  }
  for (int w = tid; w < (L + 31) / 32; w += kThreads) s_matched[w] = 0u;
  const Cam cm = load_cam(cam, p);
  const int hwm = high_watermark(valid, L, s_red);  // syncs the loads above

  // ---- pass 1: score the pre-frame map (unless scores came in), listing
  // the first n_fs free lanes (ascending) below hwm on the way -----------
  const int n_fs = Z < kMaxFree ? Z : kMaxFree;
  int nfree = 0;
  if (!f.ext) {
    nfree = score_sweep<MODEL>(c, f, cm, hwm, mean, cov, ldesc, valid, s_z, s_desc, s_rec,
                               s_part_ll, s_part_ix, s_wcount, s_hcount, s_free, n_fs,
                               s_best_ll, s_best_ix);
  } else {
    // scores came in: the same ballot lists the free lanes, and stops early
    for (int l0 = 0; l0 < hwm && nfree < n_fs; l0 += kThreads) {
      const int l = l0 + tid;
      const unsigned holes = __ballot_sync(0xffffffffu, l < hwm && valid[l] == 0);
      if (lane_id == 0) s_hcount[warp] = __popc(holes);
      __syncthreads();
      nfree = list_holes(l, holes, s_hcount, nfree, n_fs, s_free);
      __syncthreads();
    }
  }
  // every lane at or above hwm is free: they follow in order
  const int n_below = nfree < n_fs ? nfree : n_fs;
  for (int k = tid; n_below + k < n_fs && hwm + k < L; k += kThreads) s_free[n_below + k] = hwm + k;
  __syncthreads();

  // ---- association decisions and the weight increment: observation i on
  // thread i; the new ones take the free slots by their exclusive rank in
  // observation order (ballot and prefix) -------------------------------
  {
    const int above = L - hwm < n_fs ? L - hwm : n_fs;
    const int nfound = n_below + above < n_fs ? n_below + above : n_fs;
    const bool any_valid = hwm > 0;
    const int i = tid;
    const bool v = i < Z && s_zv[i] != 0;
    const float best_ll = i < Z ? s_best_ll[i] : 0.f;
    const bool is_new = (best_ll < c.log_p0) || !any_valid;
    const bool do_new = is_new && v;
    const unsigned news = __ballot_sync(0xffffffffu, do_new);
    if (lane_id == 0) s_wcount[warp] = __popc(news);
    __syncthreads();
    int arank = __popc(news & ((1u << lane_id) - 1u));
#pragma unroll
    for (int w = 0; w < kWarps; ++w) arank += w < warp ? s_wcount[w] : 0;
    const bool do_alloc = do_new && arank < nfound;
    const bool do_upd = !is_new && v;
    if (i < Z) {
      const int t = do_upd ? s_best_ix[i] : (do_alloc ? s_free[arank] : -1);
      s_tgt[i] = t;
      s_new[i] = is_new;
      target[(size_t)p * Z + i] = t;
    }
    // n_match and the weight increment: a warp tree, then the warps in order
    float dw = v ? (is_new ? c.log_p0 : best_ll) : 0.f;
    float nm = (do_upd || do_alloc) ? 1.f : 0.f;
    for (int off = 16; off > 0; off >>= 1) {
      dw = dw + __shfl_down_sync(0xffffffffu, dw, off);
      nm = nm + __shfl_down_sync(0xffffffffu, nm, off);
    }
    if (lane_id == 0) {
      s_part_ll[warp] = dw;
      s_part_ll[kWarps + warp] = nm;
    }
    __syncthreads();
    if (tid == 0) {
      float sdw = 0.f, snm = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        sdw = sdw + s_part_ll[w];
        snm = snm + s_part_ll[kWarps + w];
      }
      n_match[p] = snm;
      if (f.update_weights) log_w[p] = log_w[p] + sdw;
    }
  }

  // ---- pass 3: apply; one thread per distinct lane, in obs order ------
  for (int i = tid; i < Z; i += kThreads) {
    const int t = s_tgt[i];
    if (t < 0) continue;
    // the lane's first observation owns it and meets its own at k = i, so
    // a warp's owners run their first update together (an owner that
    // started from k = 0 would meet it at k = i: one warp lane at a time)
    bool head = true;
    for (int j = 0; j < i && head; ++j) head = s_tgt[j] != t;
    if (!head) continue;
    atomicOr(&s_matched[t >> 5], 1u << (t & 31));
    const size_t l = (size_t)t;
    for (int k = i; k < Z; ++k) {
      if (s_tgt[k] != t) continue;
      float m[3], S[3][3];
      if (s_new[k]) {
        init_landmark<MODEL>(c, cm, s_z[k], m, S);
        valid[l] = 1;
        count[l] = 1;
      } else {
        const int cnt = count[l];
        for (int a = 0; a < 3; ++a) m[a] = mean[3 * l + a];
        for (int a = 0; a < 3; ++a)
          for (int b = 0; b < 3; ++b) S[a][b] = cov[9 * l + 3 * a + b];
        ekf_lane_update<MODEL>(c, cm, s_z[k], m, S);
        count[l] = cnt + 2;
        if (f.freeze > 0 && cnt >= f.freeze) {  // anchor freeze: keep mean and cov
          for (int w = 0; w < W; ++w) ldesc[l * W + w] = (int32_t)s_desc[k][w];
          continue;
        }
      }
      for (int a = 0; a < 3; ++a) mean[3 * l + a] = m[a];
      for (int a = 0; a < 3; ++a)
        for (int b = 0; b < 3; ++b) cov[9 * l + 3 * a + b] = S[a][b];
      for (int w = 0; w < W; ++w) ldesc[l * W + w] = (int32_t)s_desc[k][w];
    }
  }
  __syncthreads();

  // ---- pass 4: cull (every lane at or above hwm was free this frame) ----
  if (!f.cull) return;
  for (int l = tid; l < hwm; l += kThreads) {
    if (!valid[l]) continue;
    const bool matched = (s_matched[l >> 5] >> (l & 31)) & 1u;
    bool dec = !matched;
    if (dec && !f.cull_unseen) {
      const float m[3] = {mean[3 * (size_t)l], mean[3 * (size_t)l + 1], mean[3 * (size_t)l + 2]};
      dec = in_fov<MODEL>(c, cm, m);
    }
    const int cnt = count[l] - (dec ? 1 : 0);
    if (dec) count[l] = cnt;
    if (cnt < 0) valid[l] = 0;
  }
}

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

template <int MODEL>
int launch_update(const float* cam, float* log_w, float* lm_mean, float* lm_cov,
                  int32_t* lm_desc, uint8_t* lm_valid, int32_t* lm_count, const float* z,
                  const int32_t* desc, const uint8_t* zvalid, const float* ext_ll,
                  const int32_t* ext_ix, float* n_match, int32_t* target, const Consts& c,
                  const Flags& f, cudaStream_t stream) {
  // the matched-lane bitmap: 32 KB at the largest L, past the 48 KB a block
  // gets without asking beside the 41 KB of static shared memory. The limit
  // is raised to the largest bitmap once per device.
  static std::atomic<unsigned> raised{0};
  const cudaError_t err =
      allow_dynamic_smem(ekf_update_3d_kernel<MODEL>, kMaxBitmapBytes, raised);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)((f.L + 31) / 32) * sizeof(uint32_t);
  ekf_update_3d_kernel<MODEL><<<f.P, kThreads, smem, stream>>>(
      cam, log_w, lm_mean, lm_cov, lm_desc, lm_valid, lm_count, z, desc, zvalid, ext_ll,
      ext_ix, n_match, target, c, f);
  return (int)cudaGetLastError();
}

template <int MODEL>
int launch_score(const float* cam, const float* lm_mean, const float* lm_cov,
                 const int32_t* lm_desc, const uint8_t* lm_valid, const float* z,
                 const int32_t* desc, float* out_ll, int32_t* out_ix, const Consts& c,
                 const Flags& f, cudaStream_t stream) {
  score_3d_kernel<MODEL><<<f.P, kThreads, 0, stream>>>(cam, lm_mean, lm_cov, lm_desc, lm_valid, z, desc, out_ll, out_ix, c, f);
  return (int)cudaGetLastError();
}

bool bad_shape(int P, int L, int Z, int W, int model) {
  return P < 1 || L < 1 || L > kMaxL || Z < 1 || Z > kMaxZ || W < 0 || W > kMaxW ||
         model < kPinhole || model > kEquirect;
}

Consts read_consts(const float* host) {
  Consts c;
  memcpy(&c, host, sizeof(Consts));
  return c;
}

}  // namespace

extern "C" int score_3d_launch(const float* cam, const float* lm_mean, const float* lm_cov,
                               const int32_t* lm_desc, const uint8_t* lm_valid, const float* z,
                               const int32_t* desc, float* out_ll, int32_t* out_ix, int P,
                               int L, int Z, int W, int model, const float* consts,
                               void* stream) {
  if (bad_shape(P, L, Z, W, model)) return (int)cudaErrorInvalidValue;
  const Consts c = read_consts(consts);
  const Flags f{P, L, Z, W, 0, 0, 0, 0, 0};
  cudaStream_t s = (cudaStream_t)stream;
  switch (model) {
    case kPinhole:
      return launch_score<kPinhole>(cam, lm_mean, lm_cov, lm_desc, lm_valid, z, desc, out_ll,
                                    out_ix, c, f, s);
    case kStereo:
      return launch_score<kStereo>(cam, lm_mean, lm_cov, lm_desc, lm_valid, z, desc, out_ll,
                                   out_ix, c, f, s);
    default:
      return launch_score<kEquirect>(cam, lm_mean, lm_cov, lm_desc, lm_valid, z, desc, out_ll,
                                     out_ix, c, f, s);
  }
}

extern "C" int ekf_update_3d_launch(const float* cam, float* log_w, float* lm_mean,
                                    float* lm_cov, int32_t* lm_desc, uint8_t* lm_valid,
                                    int32_t* lm_count, const float* z, const int32_t* desc,
                                    const uint8_t* zvalid, const float* ext_ll,
                                    const int32_t* ext_ix, float* n_match, int32_t* target,
                                    int P, int L, int Z, int W, int model, int freeze,
                                    int update_weights, int cull, int cull_unseen,
                                    const float* consts, void* stream) {
  if (bad_shape(P, L, Z, W, model) || ((ext_ll == nullptr) != (ext_ix == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Consts c = read_consts(consts);
  const Flags f{P, L, Z, W, freeze, update_weights, cull, cull_unseen, ext_ll != nullptr};
  cudaStream_t s = (cudaStream_t)stream;
  switch (model) {
    case kPinhole:
      return launch_update<kPinhole>(cam, log_w, lm_mean, lm_cov, lm_desc, lm_valid, lm_count,
                                     z, desc, zvalid, ext_ll, ext_ix, n_match, target, c, f, s);
    case kStereo:
      return launch_update<kStereo>(cam, log_w, lm_mean, lm_cov, lm_desc, lm_valid, lm_count,
                                    z, desc, zvalid, ext_ll, ext_ix, n_match, target, c, f, s);
    default:
      return launch_update<kEquirect>(cam, log_w, lm_mean, lm_cov, lm_desc, lm_valid, lm_count,
                                      z, desc, zvalid, ext_ll, ext_ix, n_match, target, c, f, s);
  }
}
