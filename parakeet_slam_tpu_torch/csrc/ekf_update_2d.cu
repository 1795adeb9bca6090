// Fused FastSLAM 1.0 range-bearing measurement update for one frame.
//
// Replaces the TPU kernel parakeet_slam_tpu/kernels/ekf_update.py
// (measurement_update_2d, body _kernel, with ekf_common.fill_free_slots and
// ekf_common.associate). It computes what the reference's XLA path computes
// (FastSLAM.measurement_core with use_pallas=False, filter/fastslam.py):
//   1. score every observation against every valid lane of the PRE-FRAME
//      map; best lane = largest log-likelihood, smallest lane among equal
//      maxima; invalid lanes and non-finite scores score -1e30;
//   2. new landmark iff best < log_p0 or the particle has no valid lane;
//      new observations take the first min(Z, 64) free lanes in ascending
//      order, by their exclusive rank in observation order;
//   3. log_w += sum over valid obs of (new ? log_p0 : best ll);
//   4. EKF updates / allocations applied strictly in observation order;
//   5. cull: valid, unmatched (and in the field of view unless cull_unseen)
//      lanes lose one count; a lane stays valid while count >= 0.
// Arithmetic follows the plain PyTorch twin (kernels/ekf_update.py,
// measurement_update_2d_reference) operation for operation; built with
// -fmad=false so that no multiply-add is contracted, masks and lanes agree
// exactly with the twin on the card.
//
// Design: one block per particle, working straight from device memory in
// the JAX layout; the state tensors are updated IN PLACE (the Pallas call
// aliases them the same way). Shared memory holds only the observations,
// the per-observation best (ll, lane), the free-slot list and the targets.
//
// Bound: each frame reads the whole map once (41 B per lane at S=3) and
// spends about 25 fp32 operations plus one bearing wrap, atan2f(sinf, cosf),
// per (lane, observation). At P=2048, L=10240, Z=32 that is 671 M pairs,
// and the full-precision libm wrap makes the kernel bound by instruction
// issue (7.4 ms on an H100), not by the 0.86 GB it reads (0.26 ms). Lanes
// are re-read from global memory for every chunk of 16 observations. At
// the corridor shape P=64 blocks fill only 64 of the 132 SMs; spreading a
// particle over several blocks is left to a later change.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxZ = 64;
constexpr int kMaxS = 4;
constexpr int kZChunk = 16;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float wrap_angle(float a) {
  return atan2f(sinf(a), cosf(a));
}

// max(x, m) that keeps a NaN x, as torch.clamp does (fmaxf would drop it).
__device__ __forceinline__ float clamp_min(float x, float m) { return x < m ? m : x; }

// (a, ia) <- the better of (a, ia) and (b, ib): larger ll, then smaller lane.
__device__ __forceinline__ void take_better(float& a, int& ia, float b, int ib) {
  if (b > a || (b == a && ib < ia)) {
    a = b;
    ia = ib;
  }
}

struct Params {
  int P, L, Z, S;
  float r11, r22, sig_var, log_p0, log2pi2, init_infl, max_range, fov_half;
  int update_weights, cull, cull_unseen;
};

__global__ void __launch_bounds__(kThreads) ekf_update_2d_kernel(
    const float* __restrict__ pose, float* __restrict__ log_w,
    float* __restrict__ lm_mean, float* __restrict__ lm_cov,
    float* __restrict__ lm_sig, uint8_t* __restrict__ lm_valid,
    int32_t* __restrict__ lm_count, const float* __restrict__ z,
    const float* __restrict__ sig, const uint8_t* __restrict__ zvalid,
    float* __restrict__ n_match, int32_t* __restrict__ target, Params c) {
  __shared__ float s_z[kMaxZ][2];
  __shared__ float s_sig[kMaxZ][kMaxS];
  __shared__ uint8_t s_zv[kMaxZ];
  __shared__ float s_best_ll[kMaxZ];
  __shared__ int s_best_ix[kMaxZ];
  __shared__ int s_free[kMaxZ];
  __shared__ int s_tgt[kMaxZ];
  __shared__ uint8_t s_new[kMaxZ];
  __shared__ float s_wll[kThreads / 32][kZChunk];
  __shared__ int s_wix[kThreads / 32][kZChunk];
  __shared__ int s_wcount[kThreads / 32];
  __shared__ int s_nfree;

  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane_id = tid & 31;
  const int warp = tid >> 5;
  const int L = c.L, Z = c.Z, S = c.S;
  const size_t base = (size_t)p * L;

  for (int i = tid; i < Z; i += kThreads) {
    s_z[i][0] = z[2 * i];
    s_z[i][1] = z[2 * i + 1];
    for (int s = 0; s < S; ++s) s_sig[i][s] = sig[i * S + s];
    s_zv[i] = zvalid[i];
  }
  __syncthreads();

  const float px = pose[3 * p], py = pose[3 * p + 1], pth = pose[3 * p + 2];

  // ---- pass 1: score the pre-frame map --------------------------------
  int saw_valid = 0;
  for (int z0 = 0; z0 < Z; z0 += kZChunk) {
    float bl[kZChunk];
    int bi[kZChunk];
#pragma unroll
    for (int k = 0; k < kZChunk; ++k) {
      bl[k] = -CUDART_INF_F;
      bi[k] = 0x7fffffff;
    }
    for (int l = tid; l < L; l += kThreads) {
      const size_t pl = base + l;
      const bool ok = lm_valid[pl] != 0;
      saw_valid |= ok;
      float r = 0.f, phi = 0.f, i11 = 0.f, i12 = 0.f, i21 = 0.f, i22 = 0.f,
            logdet = 0.f;
      float lsig[kMaxS];
      if (ok) {
        const float dx = lm_mean[2 * pl] - px;
        const float dy = lm_mean[2 * pl + 1] - py;
        const float q = dx * dx + dy * dy + 1e-12f;
        r = sqrtf(q);
        phi = wrap_angle(atan2f(dy, dx) - pth);
        const float h11 = dx / r, h12 = dy / r, h21 = -dy / q, h22 = dx / q;
        const float s11 = lm_cov[4 * pl], s12 = lm_cov[4 * pl + 1];
        const float s21 = lm_cov[4 * pl + 2], s22 = lm_cov[4 * pl + 3];
        const float a11 = h11 * s11 + h12 * s21, a12 = h11 * s12 + h12 * s22;
        const float a21 = h21 * s11 + h22 * s21, a22 = h21 * s12 + h22 * s22;
        const float q11 = a11 * h11 + a12 * h12 + c.r11;
        const float q12 = a11 * h21 + a12 * h22;
        const float q21 = a21 * h11 + a22 * h12;
        const float q22 = a21 * h21 + a22 * h22 + c.r22;
        const float det = q11 * q22 - q12 * q21;
        const float ds = fabsf(det) < 1e-12f ? 1e-12f : det;
        i11 = q22 / ds;
        i12 = -q12 / ds;
        i21 = -q21 / ds;
        i22 = q11 / ds;
        logdet = logf(clamp_min(det, 1e-12f));
        for (int s = 0; s < S; ++s) lsig[s] = lm_sig[pl * S + s];
      }
#pragma unroll
      for (int k = 0; k < kZChunk; ++k) {
        const int i = z0 + k;
        if (i < Z) {
          float ll = kNegInf;
          if (ok) {
            const float nu1 = s_z[i][0] - r;
            const float nu2 = wrap_angle(s_z[i][1] - phi);
            const float t1 = nu1 * i11 + nu2 * i21;
            const float t2 = nu1 * i12 + nu2 * i22;
            const float maha = clamp_min(t1 * nu1 + t2 * nu2, 0.f);
            ll = -0.5f * ((maha + logdet) + c.log2pi2);
            if (S > 0) {
              float d2 = 0.f;
              for (int s = 0; s < S; ++s) {
                const float d = lsig[s] - s_sig[i][s];
                d2 = d2 + d * d;
              }
              ll = ll - (0.5f * d2) / c.sig_var;
            }
            if (!isfinite(ll)) ll = kNegInf;
          }
          if (ll > bl[k]) {
            bl[k] = ll;
            bi[k] = l;
          }
        }
      }
    }
    // block argmax per observation of this chunk
#pragma unroll
    for (int k = 0; k < kZChunk; ++k) {
      float a = bl[k];
      int ia = bi[k];
      for (int off = 16; off > 0; off >>= 1) {
        const float b = __shfl_down_sync(0xffffffffu, a, off);
        const int ib = __shfl_down_sync(0xffffffffu, ia, off);
        take_better(a, ia, b, ib);
      }
      if (lane_id == 0) {
        s_wll[warp][k] = a;
        s_wix[warp][k] = ia;
      }
    }
    __syncthreads();
    if (tid < kZChunk && z0 + tid < Z) {
      float a = s_wll[0][tid];
      int ia = s_wix[0][tid];
      for (int w = 1; w < kThreads / 32; ++w) take_better(a, ia, s_wll[w][tid], s_wix[w][tid]);
      s_best_ll[z0 + tid] = a;
      s_best_ix[z0 + tid] = ia;
    }
    __syncthreads();
  }
  const int any_valid = __syncthreads_or(saw_valid);

  // ---- pass 2: free slots (first n_fs invalid lanes, ascending) -------
  const int n_fs = Z < kMaxZ ? Z : kMaxZ;
  if (tid == 0) s_nfree = 0;
  __syncthreads();
  for (int l0 = 0; l0 < L; l0 += kThreads) {
    const int nfree = s_nfree;  // uniform: read after the barrier
    if (nfree >= n_fs) break;
    const int l = l0 + tid;
    const bool is_free = l < L && lm_valid[base + l] == 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, is_free);
    if (lane_id == 0) s_wcount[warp] = __popc(ballot);
    __syncthreads();
    int rank = nfree + __popc(ballot & ((1u << lane_id) - 1u));
    int total = 0;
    for (int w = 0; w < kThreads / 32; ++w) {
      if (w < warp) rank += s_wcount[w];
      total += s_wcount[w];
    }
    if (is_free && rank < n_fs) s_free[rank] = l;
    __syncthreads();
    if (tid == 0) s_nfree = nfree + total;
    __syncthreads();
  }

  // ---- association decisions and the weight increment ---------------
  if (tid == 0) {
    const int nfound = s_nfree < n_fs ? s_nfree : n_fs;
    int arank = 0;
    float dw = 0.f, nm = 0.f;
    for (int i = 0; i < Z; ++i) {
      const bool v = s_zv[i] != 0;
      const float best_ll = s_best_ll[i];
      const bool is_new = (best_ll < c.log_p0) || !any_valid;
      const bool do_new = is_new && v;
      const bool has_free = arank < nfound;
      const bool do_alloc = do_new && has_free;
      const bool do_upd = !is_new && v;
      const int t = do_upd ? s_best_ix[i] : (do_alloc ? s_free[arank] : -1);
      arank += do_new;
      s_tgt[i] = t;
      s_new[i] = is_new;
      target[(size_t)p * Z + i] = t;
      nm += (do_upd || do_alloc) ? 1.f : 0.f;
      if (v) dw = dw + (is_new ? c.log_p0 : best_ll);
    }
    n_match[p] = nm;
    if (c.update_weights) log_w[p] = log_w[p] + dw;

    // ---- pass 3: apply in observation order -------------------------
    for (int i = 0; i < Z; ++i) {
      const int t = s_tgt[i];
      if (t < 0) continue;
      const size_t pl = base + t;
      const float zr = s_z[i][0], zphi = s_z[i][1];
      if (!s_new[i]) {
        const float mx = lm_mean[2 * pl], my = lm_mean[2 * pl + 1];
        const float s11 = lm_cov[4 * pl], s12 = lm_cov[4 * pl + 1];
        const float s21 = lm_cov[4 * pl + 2], s22 = lm_cov[4 * pl + 3];
        const float dx = mx - px, dy = my - py;
        const float q = dx * dx + dy * dy + 1e-12f;
        const float r = sqrtf(q);
        const float phi = wrap_angle(atan2f(dy, dx) - pth);
        const float h11 = dx / r, h12 = dy / r, h21 = -dy / q, h22 = dx / q;
        const float a11 = h11 * s11 + h12 * s21, a12 = h11 * s12 + h12 * s22;
        const float a21 = h21 * s11 + h22 * s21, a22 = h21 * s12 + h22 * s22;
        const float q11 = a11 * h11 + a12 * h12 + c.r11;
        const float q12 = a11 * h21 + a12 * h22;
        const float q21 = a21 * h11 + a22 * h12;
        const float q22 = a21 * h21 + a22 * h22 + c.r22;
        const float det = q11 * q22 - q12 * q21;
        const float ds = fabsf(det) < 1e-12f ? 1e-12f : det;
        const float i11 = q22 / ds, i12 = -q12 / ds, i21 = -q21 / ds, i22 = q11 / ds;
        const float nu1 = zr - r;
        const float nu2 = wrap_angle(zphi - phi);
        // K = (Sigma H^T) Q^-1
        const float b11 = s11 * h11 + s12 * h12, b12 = s11 * h21 + s12 * h22;
        const float b21 = s21 * h11 + s22 * h12, b22 = s21 * h21 + s22 * h22;
        const float k11 = b11 * i11 + b12 * i21, k12 = b11 * i12 + b12 * i22;
        const float k21 = b21 * i11 + b22 * i21, k22 = b21 * i12 + b22 * i22;
        lm_mean[2 * pl] = mx + (k11 * nu1 + k12 * nu2);
        lm_mean[2 * pl + 1] = my + (k21 * nu1 + k22 * nu2);
        // (I - K H) Sigma, then symmetrised
        const float e11 = 1.f - (k11 * h11 + k12 * h21), e12 = -(k11 * h12 + k12 * h22);
        const float e21 = -(k21 * h11 + k22 * h21), e22 = 1.f - (k21 * h12 + k22 * h22);
        const float c11 = e11 * s11 + e12 * s21, c12 = e11 * s12 + e12 * s22;
        const float c21 = e21 * s11 + e22 * s21, c22 = e21 * s12 + e22 * s22;
        lm_cov[4 * pl] = 0.5f * (c11 + c11);
        lm_cov[4 * pl + 1] = 0.5f * (c12 + c21);
        lm_cov[4 * pl + 2] = 0.5f * (c21 + c12);
        lm_cov[4 * pl + 3] = 0.5f * (c22 + c22);
        const int cnt = lm_count[pl] + 2;
        lm_count[pl] = cnt;
        const float cf = fmaxf((float)cnt, 1.f);
        for (int s = 0; s < S; ++s) {
          const float so = lm_sig[pl * S + s];
          lm_sig[pl * S + s] = so + (s_sig[i][s] - so) / cf;
        }
      } else {
        const float ang = pth + zphi;
        const float ca = cosf(ang), sa = sinf(ang);
        const float mx = px + zr * ca, my = py + zr * sa;
        const float dx = mx - px, dy = my - py;
        const float q = dx * dx + dy * dy + 1e-12f;
        const float r = sqrtf(q);
        const float h11 = dx / r, h12 = dy / r, h21 = -dy / q, h22 = dx / q;
        const float det = h11 * h22 - h12 * h21;
        const float ds = fabsf(det) < 1e-12f ? 1e-12f : det;
        const float g11 = h22 / ds, g12 = -h12 / ds, g21 = -h21 / ds, g22 = h11 / ds;
        lm_mean[2 * pl] = mx;
        lm_mean[2 * pl + 1] = my;
        lm_cov[4 * pl] = c.init_infl * ((g11 * c.r11) * g11 + (g12 * c.r22) * g12);
        lm_cov[4 * pl + 1] = c.init_infl * ((g11 * c.r11) * g21 + (g12 * c.r22) * g22);
        lm_cov[4 * pl + 2] = c.init_infl * ((g21 * c.r11) * g11 + (g22 * c.r22) * g12);
        lm_cov[4 * pl + 3] = c.init_infl * ((g21 * c.r11) * g21 + (g22 * c.r22) * g22);
        lm_valid[pl] = 1;
        lm_count[pl] = 1;
        for (int s = 0; s < S; ++s) lm_sig[pl * S + s] = s_sig[i][s];
      }
    }
  }
  __syncthreads();

  // ---- pass 4: cull ----------------------------------------------------
  if (!c.cull) return;
  for (int l = tid; l < L; l += kThreads) {
    const size_t pl = base + l;
    if (!lm_valid[pl]) continue;
    bool matched = false;
    for (int i = 0; i < Z; ++i) matched |= (s_tgt[i] == l);
    if (matched) continue;
    bool dec = true;
    if (!c.cull_unseen) {
      const float dx = lm_mean[2 * pl] - px;
      const float dy = lm_mean[2 * pl + 1] - py;
      const float r = sqrtf(dx * dx + dy * dy + 1e-12f);
      const float phi = wrap_angle(atan2f(dy, dx) - pth);
      dec = (r < c.max_range) && (fabsf(phi) < c.fov_half);
    }
    if (dec) {
      const int cnt = lm_count[pl] - 1;
      lm_count[pl] = cnt;
      lm_valid[pl] = cnt >= 0;
    }
  }
}

}  // namespace

extern "C" int ekf_update_2d_launch(
    const float* pose, float* log_w, float* lm_mean, float* lm_cov, float* lm_sig,
    uint8_t* lm_valid, int32_t* lm_count, const float* z, const float* sig,
    const uint8_t* zvalid, float* n_match, int32_t* target, int P, int L, int Z,
    int S, float r11, float r22, float sig_var, float log_p0, float log2pi2,
    float init_infl, float max_range, float fov_half, int update_weights, int cull,
    int cull_unseen, void* stream) {
  if (P < 1 || L < 1 || Z < 1 || Z > kMaxZ || S < 0 || S > kMaxS) {
    return (int)cudaErrorInvalidValue;
  }
  Params c{P, L, Z, S, r11, r22, sig_var, log_p0, log2pi2, init_infl,
           max_range, fov_half, update_weights, cull, cull_unseen};
  ekf_update_2d_kernel<<<P, kThreads, 0, (cudaStream_t)stream>>>(
      pose, log_w, lm_mean, lm_cov, lm_sig, lm_valid, lm_count, z, sig, zvalid,
      n_match, target, c);
  return (int)cudaGetLastError();
}
