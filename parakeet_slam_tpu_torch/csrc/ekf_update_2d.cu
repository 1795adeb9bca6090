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
// Design: one block per particle, the state tensors in the JAX layout,
// updated IN PLACE (the Pallas call aliases them the same way).
//   - The lanes are walked in windows of 512. A block-wide scan of the
//     window's valid bytes lists its valid lanes in ascending order in shared
//     memory (and the free lanes, of which the first min(Z, 64) are the
//     allocation slots), so no thread sweeps an invalid lane.
//   - Each listed lane's geometry (range, bearing, inverse innovation
//     covariance, log-determinant, signature) is computed once per frame
//     into a shared-memory record, with its cull decision as a bit.
//   - Observations lie across threads: thread t owns observation t % Z, in
//     group t / Z of G = 256 / Z groups, keeps its z and signature in
//     registers, and sweeps every G-th listed lane, keeping one running
//     (best, lane). A warp reads one record at a time (a broadcast).
//   - The groups' bests merge with the explicit first-lane rule; the
//     smallest free lane enters the merge at -1e30, as the invalid lanes
//     score in the twin.
//   - Association is one warp (ballot ranks for the allocation slots); the
//     apply is one thread per distinct target lane, walking that lane's
//     observations in order; the cull reads the bitmap of lanes that are
//     valid, in view and unmatched, beside the apply.
// Bound: the frame reads the map once (41 B per lane at S=3). Each pair of a
// valid lane and an observation costs ~25 operations plus the bearing wrap
// atan2(sin a, cos a), ~50 instructions of full-precision libm that the
// twin's bits require, so the kernel is bound by instruction issue.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxZ = 64;
constexpr int kMaxS = 4;
constexpr int kPerThread = 2;
constexpr int kWindow = kThreads * kPerThread;
constexpr int kMaxL = 1 << 18;  // the cull bitmap lives in shared memory
constexpr float kNegInf = -1e30f;

// The twin's wrap, atan2(sin a, cos a). For |a| <= 8 (every bearing
// difference the filter forms) sin and cos come from one sincosf, which
// shares the argument reduction; chip_smoke.py holds this function against
// torch's atan2(sin, cos) bit for bit over all 2^32 floats.
__device__ __forceinline__ float wrap_angle(float a) {
  float s, c;
  if (fabsf(a) <= 8.f) {
    sincosf(a, &s, &c);
  } else {
    s = sinf(a);
    c = cosf(a);
  }
  return atan2f(s, c);
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
  int P, L, Z;
  float r11, r22, sig_var, log_p0, log2pi2, init_infl, max_range, fov_half;
  int update_weights, cull, cull_unseen;
};

// One listed lane's scoring geometry: 48 bytes, three 16-byte loads.
struct alignas(16) LaneRec {
  float r, phi, i11, i12;
  float i21, i22, logdet;
  int lane;
  float sig[kMaxS];
};

// Predicted range/bearing, H and the inverse innovation covariance of a
// landmark at (mx, my) with covariance s: the twin's _pair_geometry.
struct Geom {
  float r, phi, q, h11, h12, h21, h22, i11, i12, i21, i22, det;
};

__device__ __forceinline__ Geom pair_geometry(const Params& c, float px, float py, float pth,
                                              float mx, float my, float s11, float s12,
                                              float s21, float s22) {
  Geom g;
  const float dx = mx - px, dy = my - py;
  g.q = dx * dx + dy * dy + 1e-12f;
  g.r = sqrtf(g.q);
  g.phi = wrap_angle(atan2f(dy, dx) - pth);
  g.h11 = dx / g.r;
  g.h12 = dy / g.r;
  g.h21 = -dy / g.q;
  g.h22 = dx / g.q;
  const float a11 = g.h11 * s11 + g.h12 * s21, a12 = g.h11 * s12 + g.h12 * s22;
  const float a21 = g.h21 * s11 + g.h22 * s21, a22 = g.h21 * s12 + g.h22 * s22;
  const float q11 = a11 * g.h11 + a12 * g.h12 + c.r11;
  const float q12 = a11 * g.h21 + a12 * g.h22;
  const float q21 = a21 * g.h11 + a22 * g.h12;
  const float q22 = a21 * g.h21 + a22 * g.h22 + c.r22;
  g.det = q11 * q22 - q12 * q21;
  const float ds = fabsf(g.det) < 1e-12f ? 1e-12f : g.det;
  g.i11 = q22 / ds;
  g.i12 = -q12 / ds;
  g.i21 = -q21 / ds;
  g.i22 = q11 / ds;
  return g;
}

// Log-likelihood of observation (zr, zphi, zs) against a listed lane.
template <int S>
__device__ __forceinline__ float pair_ll(const Params& c, const LaneRec& R, float zr, float zphi,
                                         const float* zs) {
  const float nu1 = zr - R.r;
  const float nu2 = wrap_angle(zphi - R.phi);
  const float t1 = nu1 * R.i11 + nu2 * R.i21;
  const float t2 = nu1 * R.i12 + nu2 * R.i22;
  const float maha = clamp_min(t1 * nu1 + t2 * nu2, 0.f);
  float ll = -0.5f * ((maha + R.logdet) + c.log2pi2);
  if constexpr (S > 0) {
    float d2 = 0.f;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float d = R.sig[s] - zs[s];
      d2 = d2 + d * d;
    }
    ll = ll - (0.5f * d2) / c.sig_var;
  }
  return isfinite(ll) ? ll : kNegInf;
}

template <int S>
__device__ __forceinline__ LaneRec load_rec(const LaneRec* rec) {
  const float4* src = reinterpret_cast<const float4*>(rec);
  LaneRec R;
  float4* dst = reinterpret_cast<float4*>(&R);
  dst[0] = src[0];
  dst[1] = src[1];
  if constexpr (S > 0) dst[2] = src[2];
  return R;
}

template <int S>
__global__ void __launch_bounds__(kThreads) ekf_update_2d_kernel(
    const float* __restrict__ pose, float* __restrict__ log_w,
    float* __restrict__ lm_mean, float* __restrict__ lm_cov,
    float* __restrict__ lm_sig, uint8_t* __restrict__ lm_valid,
    int32_t* __restrict__ lm_count, const float* __restrict__ z,
    const float* __restrict__ sig, const uint8_t* __restrict__ zvalid,
    float* __restrict__ n_match, int32_t* __restrict__ target, Params c) {
  __shared__ LaneRec s_rec[kWindow];
  __shared__ int s_list[kWindow];
  __shared__ float s_z[kMaxZ][2];
  __shared__ float s_sig[kMaxZ][kMaxS];
  __shared__ uint8_t s_zv[kMaxZ];
  __shared__ float s_best_ll[kMaxZ];
  __shared__ int s_best_ix[kMaxZ];
  __shared__ float s_part_ll[kThreads];
  __shared__ int s_part_ix[kThreads];
  __shared__ int s_free[kMaxZ];
  __shared__ int s_tgt[kMaxZ];
  __shared__ uint8_t s_new[kMaxZ];
  __shared__ int s_wscan[kWarps];
  extern __shared__ uint32_t s_dec[];  // one bit per lane: cull candidates

  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane_id = tid & 31;
  const int warp = tid >> 5;
  const int L = c.L, Z = c.Z;
  const size_t base = (size_t)p * L;
  const int n_fs = Z < kMaxZ ? Z : kMaxZ;

  for (int i = tid; i < Z; i += kThreads) {
    s_z[i][0] = z[2 * i];
    s_z[i][1] = z[2 * i + 1];
    for (int s = 0; s < S; ++s) s_sig[i][s] = sig[i * S + s];
    s_zv[i] = zvalid[i];
  }
  for (int w = tid; w < (L + 31) / 32; w += kThreads) s_dec[w] = 0u;

  const float px = pose[3 * p], py = pose[3 * p + 1], pth = pose[3 * p + 2];
  // this thread's observation and group in the sweep
  const int G = kThreads / Z;
  const int my_i = tid % Z, my_g = tid / Z;
  float best = -CUDART_INF_F;
  int bix = 0x7fffffff;
  __syncthreads();
  const bool sweeps = my_g < G && s_zv[my_i] != 0;
  const float zr = s_z[my_i][0], zphi = s_z[my_i][1];
  float zs[kMaxS > 0 ? kMaxS : 1];
#pragma unroll
  for (int s = 0; s < S; ++s) zs[s] = s_sig[my_i][s];

  // ---- pass 1: list, measure and score the valid lanes, window by window --
  int n_valid = 0, n_free = 0;  // uniform: running totals before the window
  for (int l0 = 0; l0 < L; l0 += kWindow) {
    // the window's valid and free lanes, ranked in ascending lane order
    const int la = l0 + kPerThread * tid;
    int cv = 0, cf = 0;
    bool v[kPerThread];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const bool in = la + k < L;
      v[k] = in && lm_valid[base + la + k] != 0;
      cv += v[k];
      cf += in && !v[k];
    }
    int incl = cv | (cf << 16);  // both counts in one scan (each < 2^16)
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int n = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane_id >= off) incl += n;
    }
    if (lane_id == 31) s_wscan[warp] = incl;
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int t = s_wscan[w];
      before += w < warp ? t : 0;
      total += t;
    }
    int rv = (before & 0xffff) + (incl & 0xffff) - cv;
    int rf = n_free + (before >> 16) + (incl >> 16) - cf;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      if (v[k]) {
        s_list[rv++] = la + k;
      } else if (la + k < L) {
        if (rf < n_fs) s_free[rf] = la + k;
        ++rf;
      }
    }
    const int listed = total & 0xffff;
    n_free += total >> 16;
    __syncthreads();

    // each listed lane's geometry, once per frame
    for (int j = tid; j < listed; j += kThreads) {
      const int l = s_list[j];
      const size_t pl = base + l;
      const Geom g = pair_geometry(c, px, py, pth, lm_mean[2 * pl], lm_mean[2 * pl + 1],
                                   lm_cov[4 * pl], lm_cov[4 * pl + 1], lm_cov[4 * pl + 2],
                                   lm_cov[4 * pl + 3]);
      LaneRec R;
      R.r = g.r;
      R.phi = g.phi;
      R.i11 = g.i11;
      R.i12 = g.i12;
      R.i21 = g.i21;
      R.i22 = g.i22;
      R.logdet = logf(clamp_min(g.det, 1e-12f));
      R.lane = l;
#pragma unroll
      for (int s = 0; s < kMaxS; ++s) R.sig[s] = s < S ? lm_sig[pl * S + s] : 0.f;
      s_rec[j] = R;
      // the cull of an unmatched lane sees this pre-frame mean: its decision
      // is known now; matched lanes are cleared after the association
      if (c.cull && (c.cull_unseen || ((g.r < c.max_range) && (fabsf(g.phi) < c.fov_half))))
        atomicOr(&s_dec[l >> 5], 1u << (l & 31));
    }
    __syncthreads();

    // the sweep: every G-th listed lane, ascending, for this observation
    if (sweeps) {
      int j = my_g;
      for (; j + G < listed; j += 2 * G) {
        const LaneRec A = load_rec<S>(&s_rec[j]);
        const LaneRec B = load_rec<S>(&s_rec[j + G]);
        const float la_ = pair_ll<S>(c, A, zr, zphi, zs);
        const float lb_ = pair_ll<S>(c, B, zr, zphi, zs);
        if (la_ > best) { best = la_; bix = A.lane; }
        if (lb_ > best) { best = lb_; bix = B.lane; }
      }
      if (j < listed) {
        const LaneRec A = load_rec<S>(&s_rec[j]);
        const float la_ = pair_ll<S>(c, A, zr, zphi, zs);
        if (la_ > best) { best = la_; bix = A.lane; }
      }
    }
    n_valid += listed;
    __syncthreads();
  }

  // ---- merge the groups; the smallest free lane scores -1e30 --------------
  s_part_ll[tid] = best;
  s_part_ix[tid] = bix;
  __syncthreads();
  if (tid < Z) {
    float a = s_part_ll[tid];
    int ia = s_part_ix[tid];
    for (int g = 1; g < G; ++g) take_better(a, ia, s_part_ll[g * Z + tid], s_part_ix[g * Z + tid]);
    if (n_free > 0) take_better(a, ia, kNegInf, s_free[0]);
    s_best_ll[tid] = a;
    s_best_ix[tid] = ia;
  }
  __syncthreads();

  // ---- association: one warp, allocation ranks by ballot -----------------
  const bool any_valid = n_valid > 0;
  const int nfound = n_free < n_fs ? n_free : n_fs;
  if (warp == 0) {
    int arank0 = 0;
    float nm = 0.f;
    for (int i0 = 0; i0 < Z; i0 += 32) {
      const int i = i0 + lane_id;
      const bool in = i < Z;
      const bool vz = in && s_zv[i] != 0;
      const float best_ll = in ? s_best_ll[i] : 0.f;
      const bool is_new = (best_ll < c.log_p0) || !any_valid;
      const bool do_new = is_new && vz;
      const unsigned ballot = __ballot_sync(0xffffffffu, do_new);
      const int arank = arank0 + __popc(ballot & ((1u << lane_id) - 1u));
      const bool do_alloc = do_new && arank < nfound;
      const bool do_upd = !is_new && vz;
      const int t = do_upd ? s_best_ix[i] : (do_alloc ? s_free[arank] : -1);
      if (in) {
        s_tgt[i] = t;
        s_new[i] = is_new;
        target[(size_t)p * Z + i] = t;
      }
      nm += (float)__popc(__ballot_sync(0xffffffffu, do_upd || do_alloc));
      arank0 += __popc(ballot);
    }
    __syncwarp();  // the warp's s_new / s_tgt writes, before lane 0 reads them
    if (lane_id == 0) {
      float dw = 0.f;
      for (int i = 0; i < Z; ++i)
        if (s_zv[i]) dw = dw + (s_new[i] ? c.log_p0 : s_best_ll[i]);
      n_match[p] = nm;
      if (c.update_weights) log_w[p] = log_w[p] + dw;
    }
  }
  __syncthreads();
  // matched lanes are not culled
  if (tid < Z && s_tgt[tid] >= 0) {
    const int t = s_tgt[tid];
    atomicAnd(&s_dec[t >> 5], ~(1u << (t & 31)));
  }
  __syncthreads();

  // ---- apply: one thread per distinct target lane, in observation order --
  // (beside it, the cull of the unmatched lanes: disjoint lanes)
  if (tid < Z) {
    const int t0 = s_tgt[tid];
    bool head = t0 >= 0;
    for (int j = 0; j < tid && head; ++j) head = s_tgt[j] != t0;
    if (head) {
      const size_t pl = base + t0;
      for (int i = tid; i < Z; ++i) {
        if (s_tgt[i] != t0) continue;
        const float zr_ = s_z[i][0], zphi_ = s_z[i][1];
        if (!s_new[i]) {
          const float mx = lm_mean[2 * pl], my = lm_mean[2 * pl + 1];
          const float s11 = lm_cov[4 * pl], s12 = lm_cov[4 * pl + 1];
          const float s21 = lm_cov[4 * pl + 2], s22 = lm_cov[4 * pl + 3];
          const Geom g = pair_geometry(c, px, py, pth, mx, my, s11, s12, s21, s22);
          const float nu1 = zr_ - g.r;
          const float nu2 = wrap_angle(zphi_ - g.phi);
          // K = (Sigma H^T) Q^-1
          const float b11 = s11 * g.h11 + s12 * g.h12, b12 = s11 * g.h21 + s12 * g.h22;
          const float b21 = s21 * g.h11 + s22 * g.h12, b22 = s21 * g.h21 + s22 * g.h22;
          const float k11 = b11 * g.i11 + b12 * g.i21, k12 = b11 * g.i12 + b12 * g.i22;
          const float k21 = b21 * g.i11 + b22 * g.i21, k22 = b21 * g.i12 + b22 * g.i22;
          lm_mean[2 * pl] = mx + (k11 * nu1 + k12 * nu2);
          lm_mean[2 * pl + 1] = my + (k21 * nu1 + k22 * nu2);
          // (I - K H) Sigma, then symmetrised
          const float e11 = 1.f - (k11 * g.h11 + k12 * g.h21), e12 = -(k11 * g.h12 + k12 * g.h22);
          const float e21 = -(k21 * g.h11 + k22 * g.h21), e22 = 1.f - (k21 * g.h12 + k22 * g.h22);
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
          const float ang = pth + zphi_;
          const float ca = cosf(ang), sa = sinf(ang);
          const float mx = px + zr_ * ca, my = py + zr_ * sa;
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
  }

  // ---- cull: valid, in view (unless cull_unseen) and unmatched ------------
  if (!c.cull) return;
  for (int l = tid; l < L; l += kThreads) {
    if (!((s_dec[l >> 5] >> (l & 31)) & 1u)) continue;
    const int cnt = lm_count[base + l] - 1;
    lm_count[base + l] = cnt;
    lm_valid[base + l] = cnt >= 0;
  }
}

template <int S>
int launch(const float* pose, float* log_w, float* lm_mean, float* lm_cov, float* lm_sig,
           uint8_t* lm_valid, int32_t* lm_count, const float* z, const float* sig,
           const uint8_t* zvalid, float* n_match, int32_t* target, const Params& c,
           cudaStream_t stream) {
  const size_t smem = (size_t)((c.L + 31) / 32) * sizeof(uint32_t);
  static bool opted_in = false;  // the bitmap may pass the 48 KB default
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        ekf_update_2d_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (kMaxL / 32) * (int)sizeof(uint32_t));
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  ekf_update_2d_kernel<S><<<c.P, kThreads, smem, stream>>>(
      pose, log_w, lm_mean, lm_cov, lm_sig, lm_valid, lm_count, z, sig, zvalid, n_match,
      target, c);
  return (int)cudaGetLastError();
}

__global__ void wrap_angle_kernel(const float* __restrict__ in, float* __restrict__ out,
                                  long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    out[i] = wrap_angle(in[i]);
}

}  // namespace

// The kernels' bearing wrap over an array (for its bit-for-bit check).
extern "C" int wrap_angle_launch(const float* in, float* out, long long n, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const long long need = (n + kThreads - 1) / kThreads;
  const int blocks = (int)(need < 132 * 16 ? need : 132 * 16);
  wrap_angle_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(in, out, n);
  return (int)cudaGetLastError();
}

extern "C" int ekf_update_2d_launch(
    const float* pose, float* log_w, float* lm_mean, float* lm_cov, float* lm_sig,
    uint8_t* lm_valid, int32_t* lm_count, const float* z, const float* sig,
    const uint8_t* zvalid, float* n_match, int32_t* target, int P, int L, int Z,
    int S, float r11, float r22, float sig_var, float log_p0, float log2pi2,
    float init_infl, float max_range, float fov_half, int update_weights, int cull,
    int cull_unseen, void* stream) {
  if (P < 1 || L < 1 || L > kMaxL || Z < 1 || Z > kMaxZ || S < 0 || S > kMaxS) {
    return (int)cudaErrorInvalidValue;
  }
  const Params c{P, L, Z, r11, r22, sig_var, log_p0, log2pi2, init_infl,
                 max_range, fov_half, update_weights, cull, cull_unseen};
  cudaStream_t s = (cudaStream_t)stream;
#define EKF2D_ARGS pose, log_w, lm_mean, lm_cov, lm_sig, lm_valid, lm_count, z, sig, zvalid, \
                   n_match, target, c, s
  switch (S) {
    case 0: return launch<0>(EKF2D_ARGS);
    case 1: return launch<1>(EKF2D_ARGS);
    case 2: return launch<2>(EKF2D_ARGS);
    case 3: return launch<3>(EKF2D_ARGS);
    default: return launch<4>(EKF2D_ARGS);
  }
#undef EKF2D_ARGS
}
