// Flow-BA Levenberg-Marquardt solve, one thread block per instance (sm_90a).
//
// Replaces the TPU kernel multimot_track_tpu/solvers/flow_ba_pallas.py ::
// solve_flow_ba_pallas (kernel body _make_kernel; helpers _chol_solve6,
// _exp_se3_scalar, _compose).  It computes what that kernel computes, the
// whole LM solve of the flow-aware pose BA:
//
//   cost = sum_valid Huber(w_pt * w_p * ||obs + f - pi(T X)||^2) + w_f ||f - f_meas||^2
//
// Each iteration Schur-eliminates the per-point 2-D flow (its Hessian block
// is a scalar times I2), reduces the 21 upper-triangle Hessian and 6
// gradient sums over the points, solves the damped 6x6 system by Cholesky,
// back-substitutes the flow, evaluates the trial objective and applies
// Nielsen's lambda schedule; it stops at rel_tol or at the iteration cap.
//
// What bounds it on an H100.  The work is tiny (~150 flops per point per
// pass, 2 passes per iteration; N = 2048..4096 points) and strictly
// sequential across iterations: every iteration ends in two block-wide
// reductions and a serial 6x6 Cholesky + se(3) exp on one thread.  So the
// solve is latency bound (barriers, the serial scalar tail, L2 reads of the
// 9 per-point planes, 36 B per point per pass), not bandwidth or FLOP
// bound, and a stage of few instances (the camera stages: one instance per
// pair) fills only a few of the 132 SMs.
//
// What the design does about it.  The LM loop, its done flag and the
// lambda bookkeeping all run inside the kernel: one launch per solve stage
// for every instance of the stage, no host round trip per iteration.  The
// current and trial flow live in dynamic shared memory (4 x N floats,
// 64 KB at N = 4096; global scratch beyond ~12.8k points), so accepting a
// step is a buffer swap.  The read-only per-point inputs are SoA planes in
// global memory, coalesced and L2 resident across iterations.  Reductions
// are fixed order (per-thread strided partials, xor-butterfly warp
// shuffles, then warps summed in order by one thread each): no atomics, so
// results repeat run to run.  Wider instances per block, tensor-core
// reductions, TMA and CUDA graphs are left for later work.
//
// Numerics follow the plain torch solver (solvers/flow_ba.py) and the
// Pallas kernel: 1/(z + 1e-9) in the residual, 1/max(z, 1e-6) in the
// Jacobian and the lambda seed, point weights on the reprojection edge only,
// and an unweighted final chi2.  Plain C ABI, bound with ctypes.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 27;         // 21 upper-triangle H entries + 6 gradient
constexpr int kPlanes = 9;        // X0 X1 X2 obs0 obs1 fm0 fm1 valid wpt

struct Params {
  float wp0, wf0, d2, tau, rel_tol, fx, fy, cx, cy;
  int iters;
};

// Sum NV per-thread values over the block; every thread returns with the
// totals in out[0..NV).  Fixed order: butterfly within each warp, then one
// thread per value adds the warp partials in warp order.
template <int NV>
__device__ __forceinline__ void block_sum(float (&v)[NV], float* scratch, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    float x = v[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
    if (lane == 0) scratch[k * kWarps + warp] = x;
  }
  __syncthreads();
  if (threadIdx.x < NV) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += scratch[threadIdx.x * kWarps + w];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

__device__ __forceinline__ float block_max(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float m = scratch[0];
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, scratch[w]);
  __syncthreads();
  return m;
}

struct Point {
  float X0, X1, X2, ob0, ob1, fm0, fm1, wpt;
  bool valid;
};

__device__ __forceinline__ Point load_point(const float* __restrict__ pl, int n, int i) {
  Point q;
  q.X0 = pl[i];
  q.X1 = pl[n + i];
  q.X2 = pl[2 * n + i];
  q.ob0 = pl[3 * n + i];
  q.ob1 = pl[4 * n + i];
  q.fm0 = pl[5 * n + i];
  q.fm1 = pl[6 * n + i];
  q.valid = pl[7 * n + i] > 0.f;
  q.wpt = pl[8 * n + i];
  return q;
}

// Robust objective contribution of one point (zero when invalid).
__device__ __forceinline__ float point_objective(const Point& q, const float* R, const float* t,
                                                 float f0, float f1, const Params& p) {
  const float y0 = R[0] * q.X0 + R[1] * q.X1 + R[2] * q.X2 + t[0];
  const float y1 = R[3] * q.X0 + R[4] * q.X1 + R[5] * q.X2 + t[1];
  const float y2 = R[6] * q.X0 + R[7] * q.X1 + R[8] * q.X2 + t[2];
  const float iz = 1.f / (y2 + 1e-9f);
  const float r0 = (q.ob0 + f0) - (p.fx * y0 * iz + p.cx);
  const float r1 = (q.ob1 + f1) - (p.fy * y1 * iz + p.cy);
  const float chi2w = q.wpt * p.wp0 * (r0 * r0 + r1 * r1);
  const float rho = chi2w <= p.d2 ? chi2w : 2.f * sqrtf(p.d2 * fmaxf(chi2w, 1e-20f)) - p.d2;
  const float rf0 = f0 - q.fm0, rf1 = f1 - q.fm1;
  const float chi2f = p.wf0 * (rf0 * rf0 + rf1 * rf1);
  return q.valid ? rho + chi2f : 0.f;
}

// Per-point linearisation shared by the two passes of an iteration.
struct Lin {
  float A0[6], A1[6];
  float r0, r1, rf0, rf1, wp, wf;
};

__device__ __forceinline__ Lin linearise(const Point& q, const float* R, const float* t,
                                         float f0, float f1, const Params& p) {
  Lin L;
  const float y0 = R[0] * q.X0 + R[1] * q.X1 + R[2] * q.X2 + t[0];
  const float y1 = R[3] * q.X0 + R[4] * q.X1 + R[5] * q.X2 + t[1];
  const float y2 = R[6] * q.X0 + R[7] * q.X1 + R[8] * q.X2 + t[2];
  const float izr = 1.f / (y2 + 1e-9f);                 // residual projection
  L.r0 = (q.ob0 + f0) - (p.fx * y0 * izr + p.cx);
  L.r1 = (q.ob1 + f1) - (p.fy * y1 * izr + p.cy);
  const float chi2w = q.wpt * p.wp0 * (L.r0 * L.r0 + L.r1 * L.r1);
  const float w_rob = chi2w <= p.d2 ? 1.f : sqrtf(p.d2 / fmaxf(chi2w, 1e-20f));
  L.wp = q.valid ? q.wpt * p.wp0 * w_rob : 0.f;
  L.wf = q.valid ? p.wf0 : 0.f;
  L.rf0 = f0 - q.fm0;
  L.rf1 = f1 - q.fm1;
  const float iz = 1.f / fmaxf(y2, 1e-6f);              // Jacobian projection
  const float a = p.fx * iz, b = -p.fx * y0 * iz * iz;
  const float c = p.fy * iz, d = -p.fy * y1 * iz * iz;
  // A = d r_p / d xi with xi = (omega, upsilon), left update T <- exp(xi) T
  L.A0[0] = -b * y1;  L.A0[1] = -a * y2 + b * y0;  L.A0[2] = a * y1;
  L.A0[3] = -a;       L.A0[4] = 0.f;               L.A0[5] = -b;
  L.A1[0] = c * y2 - d * y1;  L.A1[1] = d * y0;  L.A1[2] = -c * y0;
  L.A1[3] = 0.f;              L.A1[4] = -c;      L.A1[5] = -d;
  return L;
}

// x = H^{-1} g for SPD H (6x6 row-major), unrolled Cholesky, diagonal
// clamped at 1e-30 like geometry/smallsolve.py.
__device__ void chol_solve6(const float* H, const float* g, float* x) {
  float L[6][6];
  for (int i = 0; i < 6; ++i) {
    for (int j = 0; j <= i; ++j) {
      float s = H[i * 6 + j];
      for (int k = 0; k < j; ++k) s -= L[i][k] * L[j][k];
      L[i][j] = (i == j) ? sqrtf(fmaxf(s, 1e-30f)) : s / L[j][j];
    }
  }
  float y[6];
  for (int i = 0; i < 6; ++i) {
    float s = g[i];
    for (int k = 0; k < i; ++k) s -= L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
    for (int k = i + 1; k < 6; ++k) s -= L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
}

// se(3) exp of (omega, upsilon) with geometry/se3.exp_se3's eps terms.
__device__ void exp_se3(const float* xi, float* R, float* t) {
  const float EPS = 1e-8f;
  const float w0 = xi[0], w1 = xi[1], w2 = xi[2];
  const float th2 = w0 * w0 + w1 * w1 + w2 * w2;
  const float th = sqrtf(th2 + EPS * EPS);
  const bool small = th2 < 1e-10f;
  const float a = small ? 1.f - th2 / 6.f : sinf(th) / th;
  const float b = small ? 0.5f - th2 / 24.f : (1.f - cosf(th)) / (th2 + EPS * EPS);
  const float c = small ? 1.f / 6.f - th2 / 120.f : (th - sinf(th)) / (th2 * th + EPS);
  const float K[9] = {0.f, -w2, w1, w2, 0.f, -w0, -w1, w0, 0.f};
  float K2[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      K2[i * 3 + j] = K[i * 3] * K[j] + K[i * 3 + 1] * K[3 + j] + K[i * 3 + 2] * K[6 + j];
  float V[9];
  for (int k = 0; k < 9; ++k) {
    const float e = (k % 4 == 0) ? 1.f : 0.f;
    R[k] = e + a * K[k] + b * K2[k];
    V[k] = e + b * K[k] + c * K2[k];
  }
  for (int i = 0; i < 3; ++i)
    t[i] = V[i * 3] * xi[3] + V[i * 3 + 1] * xi[4] + V[i * 3 + 2] * xi[5];
}

__global__ void __launch_bounds__(kThreads)
flow_ba_lm_kernel(const float* __restrict__ tin, const float* __restrict__ planes,
                  float* __restrict__ tout, float* __restrict__ fout,
                  float* __restrict__ chi2_out, float* __restrict__ stats,
                  float* __restrict__ gscratch, int n, Params p) {
  extern __shared__ float dyn[];
  __shared__ float s_red[kSums * kWarps];
  __shared__ float s_sum[kSums];
  __shared__ float s_R[9], s_t[3], s_Rn[9], s_tn[3], s_dxi[6];
  __shared__ float s_F, s_lam, s_nu, s_pred_pose;
  __shared__ int s_cur, s_done, s_it;

  const int m = blockIdx.x, tid = threadIdx.x;
  const float* pl = planes + (size_t)m * kPlanes * n;
  // two flow buffers of 2 planes each: buffer b is fb[2*b*n .. 2*b*n + 2n)
  float* fb = gscratch ? gscratch + (size_t)m * 4 * n : dyn;

  if (tid == 0) {
    const float* T = tin + (size_t)m * 16;
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) s_R[i * 3 + j] = T[i * 4 + j];
      s_t[i] = T[i * 4 + 3];
    }
    s_cur = 0;
    s_done = 0;
    s_it = 0;
    s_nu = 2.f;
  }
  for (int i = tid; i < n; i += kThreads) {
    fb[i] = pl[5 * n + i];
    fb[n + i] = pl[6 * n + i];
  }
  __syncthreads();

  // ---- lambda seed (tau * max diag scale) and the initial objective ----
  {
    float R[9], t[3];
    for (int k = 0; k < 9; ++k) R[k] = s_R[k];
    for (int k = 0; k < 3; ++k) t[k] = s_t[k];
    float mx = 0.f;
    float acc[1] = {0.f};
    for (int i = tid; i < n; i += kThreads) {
      const Point q = load_point(pl, n, i);
      const float y2 = R[6] * q.X0 + R[7] * q.X1 + R[8] * q.X2 + t[2];
      const float z = fmaxf(y2, 1e-6f);
      const float scale = (p.fx / z) * (p.fx / z) + (p.fy / z) * (p.fy / z);
      if (q.valid) mx = fmaxf(mx, q.wpt * p.wp0 * scale);
      acc[0] += point_objective(q, R, t, q.fm0, q.fm1, p);
    }
    mx = block_max(mx, s_red);
    block_sum<1>(acc, s_red, s_sum);
    if (tid == 0) {
      s_lam = p.tau * fmaxf(mx, 1.f);
      s_F = s_sum[0];
    }
    __syncthreads();
  }

  for (int it = 0; it < p.iters; ++it) {
    if (s_done) break;                      // block-uniform: read after a barrier
    const int cur = s_cur;
    const float* f0 = fb + 2 * cur * n;
    const float* f1 = f0 + n;
    float* g0 = fb + 2 * (1 - cur) * n;     // trial buffer
    float* g1 = g0 + n;
    const float lam = s_lam;
    float R[9], t[3];
    for (int k = 0; k < 9; ++k) R[k] = s_R[k];
    for (int k = 0; k < 3; ++k) t[k] = s_t[k];

    // ---- pass 1: reduced Hessian and gradient ----
    float acc[kSums];
#pragma unroll
    for (int k = 0; k < kSums; ++k) acc[k] = 0.f;
    for (int i = tid; i < n; i += kThreads) {
      const Point q = load_point(pl, n, i);
      const Lin L = linearise(q, R, t, f0[i], f1[i], p);
      const float h = L.wp + L.wf + lam;
      const float inv_h = 1.f / h;
      const float wH = L.wp * (L.wf + lam) * inv_h;
      const float k1 = 1.f - L.wp * inv_h, k2 = L.wf * inv_h;
      const float e0 = L.wp * (k1 * L.r0 - k2 * L.rf0);
      const float e1 = L.wp * (k1 * L.r1 - k2 * L.rf1);
      int k = 0;
#pragma unroll
      for (int a = 0; a < 6; ++a)
#pragma unroll
        for (int b = a; b < 6; ++b) acc[k++] += wH * (L.A0[a] * L.A0[b] + L.A1[a] * L.A1[b]);
#pragma unroll
      for (int a = 0; a < 6; ++a) acc[21 + a] += L.A0[a] * e0 + L.A1[a] * e1;
    }
    block_sum<kSums>(acc, s_red, s_sum);

    // ---- serial tail: damped 6x6 solve, exp, compose ----
    if (tid == 0) {
      float H[36], mg[6], dxi[6];
      int k = 0;
      for (int a = 0; a < 6; ++a)
        for (int b = a; b < 6; ++b) {
          H[a * 6 + b] = s_sum[k];
          H[b * 6 + a] = s_sum[k];
          ++k;
        }
      for (int a = 0; a < 6; ++a) {
        H[a * 6 + a] += lam;
        mg[a] = -s_sum[21 + a];
      }
      chol_solve6(H, mg, dxi);
      float pred_pose = 0.f;
      for (int a = 0; a < 6; ++a) pred_pose += dxi[a] * (lam * dxi[a] - s_sum[21 + a]);
      float dR[9], dt[3];
      exp_se3(dxi, dR, dt);
      for (int i = 0; i < 3; ++i) {
        for (int j = 0; j < 3; ++j)
          s_Rn[i * 3 + j] = dR[i * 3] * R[j] + dR[i * 3 + 1] * R[3 + j] + dR[i * 3 + 2] * R[6 + j];
        s_tn[i] = dR[i * 3] * t[0] + dR[i * 3 + 1] * t[1] + dR[i * 3 + 2] * t[2] + dt[i];
      }
      for (int a = 0; a < 6; ++a) s_dxi[a] = dxi[a];
      s_pred_pose = pred_pose;
    }
    __syncthreads();

    // ---- pass 2: flow back-substitution, trial objective ----
    float Rn[9], tn[3], dxi[6];
    for (int k = 0; k < 9; ++k) Rn[k] = s_Rn[k];
    for (int k = 0; k < 3; ++k) tn[k] = s_tn[k];
    for (int k = 0; k < 6; ++k) dxi[k] = s_dxi[k];
    float acc2[2] = {0.f, 0.f};             // pred_flow, F_new
    for (int i = tid; i < n; i += kThreads) {
      const Point q = load_point(pl, n, i);
      const float fi0 = f0[i], fi1 = f1[i];
      const Lin L = linearise(q, R, t, fi0, fi1, p);
      const float inv_h = 1.f / (L.wp + L.wf + lam);
      const float gf0 = L.wp * L.r0 + L.wf * L.rf0;
      const float gf1 = L.wp * L.r1 + L.wf * L.rf1;
      float Ad0 = 0.f, Ad1 = 0.f;
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        Ad0 += L.A0[a] * dxi[a];
        Ad1 += L.A1[a] * dxi[a];
      }
      const float df0 = -(gf0 + L.wp * Ad0) * inv_h;
      const float df1 = -(gf1 + L.wp * Ad1) * inv_h;
      if (q.valid) acc2[0] += df0 * (lam * df0 - gf0) + df1 * (lam * df1 - gf1);
      const float fn0 = fi0 + df0, fn1 = fi1 + df1;
      g0[i] = fn0;
      g1[i] = fn1;
      acc2[1] += point_objective(q, Rn, tn, fn0, fn1, p);
    }
    block_sum<2>(acc2, s_red, s_sum);

    // ---- accept / reject, Nielsen's lambda update ----
    if (tid == 0) {
      const float F = s_F, F_new = s_sum[1];
      const float pred = 0.5f * (s_pred_pose + s_sum[0]);
      const float gain = (F - F_new) / fmaxf(pred, 1e-20f);
      const bool accept = (F_new < F) && isfinite(F_new);
      const float q = 2.f * gain - 1.f;
      const float lam_acc = lam * fmaxf(1.f / 3.f, 1.f - q * q * q);
      const bool done = (accept && (F - F_new < p.rel_tol * F + 1e-10f)) || (lam > 1e8f);
      if (accept) {
        for (int k = 0; k < 9; ++k) s_R[k] = s_Rn[k];
        for (int k = 0; k < 3; ++k) s_t[k] = s_tn[k];
        s_F = F_new;
        s_cur = 1 - cur;
        s_lam = lam_acc;
        s_nu = 2.f;
      } else {
        s_lam = lam * s_nu;
        s_nu = s_nu * 2.f;
      }
      s_done = done ? 1 : 0;
      s_it = it + 1;
    }
    __syncthreads();
  }

  // ---- final unweighted chi2, inliers, mean reprojection ----
  {
    float R[9], t[3];
    for (int k = 0; k < 9; ++k) R[k] = s_R[k];
    for (int k = 0; k < 3; ++k) t[k] = s_t[k];
    const float* f0 = fb + 2 * s_cur * n;
    const float* f1 = f0 + n;
    float acc[2] = {0.f, 0.f};
    for (int i = tid; i < n; i += kThreads) {
      const Point q = load_point(pl, n, i);
      const float y0 = R[0] * q.X0 + R[1] * q.X1 + R[2] * q.X2 + t[0];
      const float y1 = R[3] * q.X0 + R[4] * q.X1 + R[5] * q.X2 + t[1];
      const float y2 = R[6] * q.X0 + R[7] * q.X1 + R[8] * q.X2 + t[2];
      const float iz = 1.f / (y2 + 1e-9f);
      const float r0 = (q.ob0 + f0[i]) - (p.fx * y0 * iz + p.cx);
      const float r1 = (q.ob1 + f1[i]) - (p.fy * y1 * iz + p.cy);
      const float chi2 = p.wp0 * (r0 * r0 + r1 * r1);
      chi2_out[(size_t)m * n + i] = chi2;
      fout[(size_t)m * 2 * n + i] = f0[i];
      fout[(size_t)m * 2 * n + n + i] = f1[i];
      if (q.valid && chi2 <= p.d2) {
        acc[0] += 1.f;
        acc[1] += sqrtf(chi2);
      }
    }
    block_sum<2>(acc, s_red, s_sum);
    if (tid == 0) {
      float* T = tout + (size_t)m * 16;
      for (int i = 0; i < 3; ++i) {
        for (int j = 0; j < 3; ++j) T[i * 4 + j] = s_R[i * 3 + j];
        T[i * 4 + 3] = s_t[i];
      }
      T[12] = 0.f;
      T[13] = 0.f;
      T[14] = 0.f;
      T[15] = 1.f;
      float* st = stats + (size_t)m * 4;
      st[0] = s_sum[0];
      st[1] = s_sum[1] / fmaxf(s_sum[0], 1.f);
      st[2] = s_F;
      st[3] = (float)s_it;
    }
  }
}

}  // namespace

extern "C" {

// Shared-memory bytes the kernel needs for n points when the flow buffers
// live in shared memory.
size_t flow_ba_lm_smem_bytes(int n) { return (size_t)4 * n * sizeof(float); }

// Launch one block per instance on `stream`.  scratch: null to keep the
// flow buffers in shared memory, else (m, 4, n) floats of global scratch.
// Returns cudaGetLastError() after the launch (0 = launched).
int flow_ba_lm_launch(const float* tin, const float* planes, float* tout, float* fout,
                      float* chi2, float* stats, float* scratch, int m, int n, int iters,
                      float reproj_info, float prior_info, float rp_thres, float tau,
                      float rel_tol, float fx, float fy, float cx, float cy, void* stream) {
  if (m <= 0) return 0;
  const size_t smem = scratch ? 0 : flow_ba_lm_smem_bytes(n);
  cudaError_t err = cudaFuncSetAttribute(flow_ba_lm_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  Params p{reproj_info, prior_info, rp_thres, tau, rel_tol, fx, fy, cx, cy, iters};
  flow_ba_lm_kernel<<<m, kThreads, smem, (cudaStream_t)stream>>>(
      tin, planes, tout, fout, chi2, stats, scratch, n, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
