// Flow-BA Levenberg-Marquardt solve, one thread-block cluster per instance (sm_90a).
//
// Replaces the TPU kernel multimot_track_tpu/solvers/flow_ba_pallas.py ::
// solve_flow_ba_pallas (kernel body _make_kernel; helpers _chol_solve6,
// _exp_se3_scalar, _compose).  It computes what that kernel computes, the
// whole LM solve of the flow-aware pose BA:
//
//   cost = sum_valid Huber(w_pt * w_p * ||obs + f - pi(T X)||^2) + w_f ||f - f_meas||^2
//
// with X = Twl pi^-1(obs, depth).  Each iteration Schur-eliminates the
// per-point 2-D flow (its Hessian block is a scalar times I2), reduces the
// 21 upper-triangle Hessian and 6 gradient sums over the points, solves the
// damped 6x6 system by Cholesky, back-substitutes the flow, evaluates the
// trial objective and applies Nielsen's lambda schedule; it stops at
// rel_tol or at the iteration cap.
//
// What bounds it on an H100.  Per valid point and LM iteration the
// algorithm needs ~295 fp32 operations: pass 1 ~208 (transform 18,
// residual and robust weight ~24, Jacobian ~18, Schur terms ~17, the 21
// Hessian products 105 and 6 gradient products 24), pass 2 ~87
// (back-substitution ~38, trial objective ~47); ~120 more once per point
// (back-projection, lambda seed, initial objective, final chi2).  The
// bytes are ~21 in and ~13 out per point.  At the path's shapes (1-198
// instances of 2048-4096 points, 4-14 iterations) that is 0.04-27 us of
// the card's fp32 peak.  But each iteration is a strict chain: a pass over
// the points, a reduction of 27 sums over all of them, a 6x6 Cholesky, an
// se(3) exp and a compose, a second pass, a second reduction and the
// accept test, none of which can start before the one before it ends.
// That chain costs ~3.4-3.8 us per iteration on this card even at one
// point per thread (tools/k1_plan_sweep.py, chain_cost), so the small
// shapes are bound by its latency, not by bytes or flops, and the large
// ones by how many points each SM walks per iteration.
//
// What the design does about it.
//  - One cluster of C CTAs works on one instance (C in {1, 2, 4, 8},
//    chosen by the wrapper from (M, N): spread a few instances over many
//    SMs, keep a stage of many instances in few waves).  CTA r owns points
//    [r S, r S + S), S = ceil(N / C), and thread j of a CTA owns its
//    points j, j + 256, ...  Only the owner ever touches a point, so no
//    barrier guards point data.
//  - Every point is read from device memory once: the CTA back-projects
//    it itself (X = Twl pi^-1(obs, depth), valid && depth > 0, the point
//    weight) into shared memory, 13 float planes of P * 256 points (P the
//    held points per thread, 1..16: up to 4096 points, 208 KB), with the
//    current and trial flow.  Accepting a step swaps the flow buffers.
//    Points beyond 4096 per CTA are streamed from device memory inside
//    the kernel every pass, their flows in a global scratch buffer.
//  - Up to P = 2, pass 1 keeps each point's y = T X, 1 / z, flow gradient,
//    weight and 1 / h in registers, and pass 2 rebuilds the Jacobian from
//    them instead of re-linearising.  Invalid points are skipped: their
//    terms are exact zeros in the plain version, and their flow never
//    moves.  P = 2..8 run two CTAs per SM (<= 128 registers a thread), so
//    a stage of many instances runs in fewer waves.
//  - Reductions are fixed order and cluster wide, with no atomics: a warp
//    reduce-scatters its 27 sums in 31 shuffles, warp 0 adds the 8 warp
//    partials in warp order, and after a cluster barrier warp 0 of every
//    CTA adds the C CTA partials in rank order through distributed shared
//    memory.  Every CTA thus holds the same totals, bit for bit; warp 0 of
//    every CTA runs the same 6x6 solve, exp and compose on them and hands
//    the step to its CTA through shared memory, and every thread runs the
//    same accept test on the second reduction's totals, so the cluster
//    takes the same steps and leaves the loop together with no broadcast
//    between CTAs.  Two partial slots alternate, so one cluster barrier
//    per reduction suffices.  Two launches on the same inputs give the
//    same bits.  The Cholesky's diagonal takes one rsqrt each, the
//    chain's longest link.
//  - The kernel reads the caller's tensors with per-instance strides (a
//    broadcast Twl or point weight has stride 0) and writes T, flow,
//    chi2, inliers, n_inliers (int64), mean reprojection and iterations:
//    the wrapper allocates the outputs and launches, nothing else.
//
// Numerics follow the plain torch solver (solvers/flow_ba.py) and the
// Pallas kernel: 1/(z + 1e-9) in the residual, 1/max(z, 1e-6) in the
// Jacobian and the lambda seed, point weights on the reprojection edge only,
// and an unweighted final chi2.  Plain C ABI, bound with ctypes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "se3.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 27;         // 21 upper-triangle H entries + 6 gradient
constexpr int kPlanes = 13;       // X0 X1 X2 ob0 ob1 fm0 fm1 wpt valid, 2 flow buffers x 2
constexpr int kFlowPlane = 9;     // flow buffer b, component c: plane 9 + 2 b + c
constexpr int kMaxP = 16;         // held points per thread at most
constexpr int kCacheP = 2;        // pass 1 keeps its linearisation in registers up to this P

struct Args {
  const float* T_init; long long sT;   // (M, 4, 4); s*: instance strides in elements
  const float* Twl; long long sW;      // (M, 4, 4), stride 0 when broadcast
  const float* obs; long long sO;      // (M, N, 2)
  const float* fm; long long sF;       // (M, N, 2)
  const float* depth; long long sD;    // (M, N)
  const uint8_t* valid; long long sV;  // (M, N) bool
  const float* wpt; long long sP;      // (M, N) / (N,) point weights, or null (all 1)
  float* T_out;                        // (M, 4, 4)
  float* flow_out;                     // (M, N, 2)
  float* chi2_out;                     // (M, N)
  uint8_t* inl_out;                    // (M, N) bool
  long long* n_inl_out;                // (M,)
  float* mean_out;                     // (M,)
  int* iters_out;                      // (M,)
  float* scratch;                      // (M, 4, N) flows of streamed points, or null
  int n, iters;
  float wp0, wf0, d2, tau, rel_tol, fx, fy, cx, cy;
};

struct Point {
  float X0, X1, X2, ob0, ob1, fm0, fm1, wpt;
  bool valid;
};

// Back-project point i of instance m from the caller's tensors; W is Twl's
// top three rows (row-major 3 x 4).
__device__ __forceinline__ Point fetch_point(const Args& a, int m, int i, const float* W) {
  Point q;
  const float u = a.obs[m * a.sO + 2 * i], v = a.obs[m * a.sO + 2 * i + 1];
  const float d = a.depth[m * a.sD + i];
  const float x = (u - a.cx) * d / a.fx, y = (v - a.cy) * d / a.fy;
  q.X0 = W[0] * x + W[1] * y + W[2] * d + W[3];
  q.X1 = W[4] * x + W[5] * y + W[6] * d + W[7];
  q.X2 = W[8] * x + W[9] * y + W[10] * d + W[11];
  q.ob0 = u;
  q.ob1 = v;
  q.fm0 = a.fm[m * a.sF + 2 * i];
  q.fm1 = a.fm[m * a.sF + 2 * i + 1];
  q.wpt = a.wpt ? a.wpt[m * a.sP + i] : 1.f;
  q.valid = a.valid[m * a.sV + i] != 0 && d > 0.f;
  return q;
}

// Robust objective contribution of one valid point.
__device__ __forceinline__ float point_objective(const Point& q, const float* R, const float* t,
                                                 float f0, float f1, const Args& p) {
  const float y0 = R[0] * q.X0 + R[1] * q.X1 + R[2] * q.X2 + t[0];
  const float y1 = R[3] * q.X0 + R[4] * q.X1 + R[5] * q.X2 + t[1];
  const float y2 = R[6] * q.X0 + R[7] * q.X1 + R[8] * q.X2 + t[2];
  const float iz = 1.f / (y2 + 1e-9f);
  const float r0 = (q.ob0 + f0) - (p.fx * y0 * iz + p.cx);
  const float r1 = (q.ob1 + f1) - (p.fy * y1 * iz + p.cy);
  const float chi2w = q.wpt * p.wp0 * (r0 * r0 + r1 * r1);
  const float rho = chi2w <= p.d2 ? chi2w : 2.f * sqrtf(p.d2 * fmaxf(chi2w, 1e-20f)) - p.d2;
  const float rf0 = f0 - q.fm0, rf1 = f1 - q.fm1;
  return rho + p.wf0 * (rf0 * rf0 + rf1 * rf1);
}

// A = d r_p / d xi at y = T X, xi = (omega, upsilon), left update T <- exp(xi) T;
// iz = 1 / max(y2, 1e-6), the Jacobian's projection.
__device__ __forceinline__ void jacobian(float y0, float y1, float y2, float iz, const Args& p,
                                         float* A0, float* A1) {
  const float a = p.fx * iz, b = -p.fx * y0 * iz * iz;
  const float c = p.fy * iz, d = -p.fy * y1 * iz * iz;
  A0[0] = -b * y1;  A0[1] = -a * y2 + b * y0;  A0[2] = a * y1;
  A0[3] = -a;       A0[4] = 0.f;               A0[5] = -b;
  A1[0] = c * y2 - d * y1;  A1[1] = d * y0;  A1[2] = -c * y0;
  A1[3] = 0.f;              A1[4] = -c;      A1[5] = -d;
}

// What pass 2 needs of pass 1's linearisation of one valid point.
struct Lin {
  float y0, y1, y2, iz;  // T X and the Jacobian's 1 / max(y2, 1e-6)
  float gf0, gf1;        // flow gradient w_p r_p + w_f r_f
  float wp, inv_h;       // robust reprojection weight, 1 / (w_p + w_f + lambda)
};

__device__ __forceinline__ Lin linearise(const Point& q, const float* R, const float* t,
                                         float f0, float f1, float lam, const Args& p,
                                         float* r, float* rf) {
  Lin L;
  L.y0 = R[0] * q.X0 + R[1] * q.X1 + R[2] * q.X2 + t[0];
  L.y1 = R[3] * q.X0 + R[4] * q.X1 + R[5] * q.X2 + t[1];
  L.y2 = R[6] * q.X0 + R[7] * q.X1 + R[8] * q.X2 + t[2];
  const float izr = 1.f / (L.y2 + 1e-9f);               // residual projection
  r[0] = (q.ob0 + f0) - (p.fx * L.y0 * izr + p.cx);
  r[1] = (q.ob1 + f1) - (p.fy * L.y1 * izr + p.cy);
  const float chi2w = q.wpt * p.wp0 * (r[0] * r[0] + r[1] * r[1]);
  const float w_rob = chi2w <= p.d2 ? 1.f : sqrtf(p.d2 / fmaxf(chi2w, 1e-20f));
  L.wp = q.wpt * p.wp0 * w_rob;
  rf[0] = f0 - q.fm0;
  rf[1] = f1 - q.fm1;
  L.gf0 = L.wp * r[0] + p.wf0 * rf[0];
  L.gf1 = L.wp * r[1] + p.wf0 * rf[1];
  L.iz = 1.f / fmaxf(L.y2, 1e-6f);
  L.inv_h = 1.f / (L.wp + p.wf0 + lam);
  return L;
}

// One step of a warp's reduce-scatter of 2W values: a lane keeps the upper
// half when (lane & W) is set and adds its partner's copy of that half.
template <int W>
__device__ __forceinline__ void scatter_step(float (&x)[32], int lane) {
  const bool up = lane & W;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const float send = up ? x[k] : x[k + W];
    const float keep = up ? x[k + W] : x[k];
    x[k] = keep + __shfl_xor_sync(0xffffffffu, send, W);
  }
}

// Shared-memory buffers of one CTA for cluster_reduce.
struct ReduceBufs {
  float warp[kWarps][32];   // each warp's partial sums
  float cta[2][32];         // the CTA's partial, read by the whole cluster; two slots
  float tot[32];            // the cluster's totals
  float step[19];           // warp 0's LM step: dxi, R_new, t_new, predicted pose decrease
};

// Sum (or, for value 0 when kMax0, take the max of) NV per-thread values
// over the whole cluster.  Fixed order: within a warp a butterfly (NV <= 2)
// or a reduce-scatter (lane k ends with sum k, 31 shuffles), then warp 0
// adds the kWarps warp partials in warp order, and after a cluster barrier
// warp 0 of every CTA adds the C CTA partials in rank order, read through
// distributed shared memory.  Every thread of every CTA returns with the
// same totals in v (with kWarp0Only, only warp 0 does).  Consecutive calls
// alternate `slot`, so one cluster barrier per call keeps a CTA partial
// from being rewritten while another CTA still reads it.
template <int NV, bool kMax0, bool kWarp0Only = false>
__device__ __forceinline__ void cluster_reduce(float (&v)[NV], ReduceBufs& rb, int slot,
                                               cg::cluster_group& cl) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  auto op = [](bool is_max, float x, float y) { return is_max ? fmaxf(x, y) : x + y; };
  if constexpr (NV <= 2) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      float x = v[k];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        x = op(kMax0 && k == 0, x, __shfl_xor_sync(0xffffffffu, x, off));
      if (lane == 0) rb.warp[warp][k] = x;
    }
  } else {
    float x[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) x[k] = k < NV ? v[k] : 0.f;
    scatter_step<16>(x, lane);
    scatter_step<8>(x, lane);
    scatter_step<4>(x, lane);
    scatter_step<2>(x, lane);
    scatter_step<1>(x, lane);
    if (lane < NV) rb.warp[warp][lane] = x[0];
  }
  __syncthreads();
  const bool is_max = kMax0 && lane == 0;
  if (warp == 0 && lane < NV) {
    float s = rb.warp[0][lane];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s = op(is_max, s, rb.warp[w][lane]);
    rb.cta[slot][lane] = s;
  }
  cl.sync();
  if (warp == 0 && lane < NV) {
    const int C = (int)cl.num_blocks();
    float part[8];                        // all C remote loads in flight at once
#pragma unroll
    for (int r = 0; r < 8; ++r)
      if (r < C) part[r] = cl.map_shared_rank(&rb.cta[slot][lane], r)[0];
    float s = part[0];
#pragma unroll
    for (int r = 1; r < 8; ++r)
      if (r < C) s = op(is_max, s, part[r]);
    rb.tot[lane] = s;
  }
  if constexpr (kWarp0Only) {               // only warp 0 needs the totals
    if (warp != 0) return;
    __syncwarp();
  } else {
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < NV; ++k) v[k] = rb.tot[k];
}

// x = H^{-1} g for SPD H (6x6 row-major), unrolled Cholesky, diagonal
// clamped at 1e-30 like geometry/smallsolve.py.
__device__ __forceinline__ void chol_solve6(const float* H, const float* g, float* x) {
  float L[6][6], inv[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = H[i * 6 + j];
#pragma unroll
      for (int k = 0; k < j; ++k) s -= L[i][k] * L[j][k];
      if (i == j) {                 // one MUFU.RSQ: the column's critical path
        const float d = fmaxf(s, 1e-30f);
        inv[i] = rsqrtf(d);
        L[i][i] = d * inv[i];
      } else {
        L[i][j] = s * inv[j];
      }
    }
  }
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = g[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= L[i][k] * y[k];
    y[i] = s * inv[i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s -= L[k][i] * x[k];
    x[i] = s * inv[i];
  }
}

// Points per CTA held in shared memory for a P-point-per-thread instantiation.
template <int P>
__host__ __device__ constexpr int held_points() { return P * kThreads; }

// CTAs an SM holds: two for P = 2..8 (<= 128 registers a thread, <= 104 KB
// of shared memory), so that a stage of many instances runs in fewer
// waves; one at P = 16 (208 KB), and at P = 1, whose one point per thread
// leaves the iteration's serial chain to set the pace: it keeps up to 255
// registers rather than spill in that chain.
template <int P>
__host__ __device__ constexpr int ctas_per_sm() { return P == 1 || P == 16 ? 1 : 2; }

template <int P>
__global__ void __launch_bounds__(kThreads, ctas_per_sm<P>()) flow_ba_lm_kernel(const Args a) {
  constexpr int HP = held_points<P>();
  constexpr bool kCache = P <= kCacheP;
  extern __shared__ float sm[];                   // kPlanes planes of HP floats
  __shared__ ReduceBufs rb;
  cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const int m = blockIdx.x / C, tid = threadIdx.x;
  const int n = a.n, S = (n + C - 1) / C;
  const int begin = min(rank * S, n);
  const int cnt = min(n - begin, S);               // points of this CTA
  const int held = min(cnt, HP);                  // of those, held in shared memory
  auto PL = [&](int plane, int k) -> float& { return sm[plane * HP + k]; };
  float* gflow = a.scratch ? a.scratch + (size_t)m * 4 * n + begin : nullptr;
  auto GF = [&](int plane, int k) -> float& { return gflow[(size_t)plane * n + k]; };
  auto held_point = [&](int k) {
    Point q;
    q.X0 = PL(0, k); q.X1 = PL(1, k); q.X2 = PL(2, k);
    q.ob0 = PL(3, k); q.ob1 = PL(4, k); q.fm0 = PL(5, k); q.fm1 = PL(6, k);
    q.wpt = PL(7, k);
    q.valid = PL(8, k) != 0.f;
    return q;
  };

  __shared__ float s_W[12];                       // Twl's top rows, for fetch_point
  if (tid < 12) s_W[tid] = a.Twl[m * a.sW + tid];
  float R[9], t[3];
  {
    const float* T = a.T_init + m * a.sT;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) R[i * 3 + j] = T[i * 4 + j];
      t[i] = T[i * 4 + 3];
    }
  }
  __syncthreads();

  // ---- the one read of the points; lambda seed and initial objective ----
  float lam, F;
  {
    float acc[2] = {0.f, 0.f};                    // max seed, objective
    auto seed = [&](const Point& q) {
      if (!q.valid) return;
      const float y2 = R[6] * q.X0 + R[7] * q.X1 + R[8] * q.X2 + t[2];
      const float z = fmaxf(y2, 1e-6f);
      const float scale = (a.fx / z) * (a.fx / z) + (a.fy / z) * (a.fy / z);
      acc[0] = fmaxf(acc[0], q.wpt * a.wp0 * scale);
      acc[1] += point_objective(q, R, t, q.fm0, q.fm1, a);
    };
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int k = tid + j * kThreads;
      if (k < held) {
        const Point q = fetch_point(a, m, begin + k, s_W);
        PL(0, k) = q.X0; PL(1, k) = q.X1; PL(2, k) = q.X2;
        PL(3, k) = q.ob0; PL(4, k) = q.ob1; PL(5, k) = q.fm0; PL(6, k) = q.fm1;
        PL(7, k) = q.wpt;
        PL(8, k) = q.valid ? 1.f : 0.f;
#pragma unroll
        for (int b = 0; b < 4; b += 2) {
          PL(kFlowPlane + b, k) = q.fm0;
          PL(kFlowPlane + b + 1, k) = q.fm1;
        }
        seed(q);
      }
    }
    for (int k = held + tid; k < cnt; k += kThreads) {
      const Point q = fetch_point(a, m, begin + k, s_W);
#pragma unroll
      for (int b = 0; b < 4; b += 2) {
        GF(b, k) = q.fm0;
        GF(b + 1, k) = q.fm1;
      }
      seed(q);
    }
    cluster_reduce<2, true>(acc, rb, 0, cl);
    lam = a.tau * fmaxf(acc[0], 1.f);
    F = acc[1];
  }

  float nu = 2.f;
  int cur = 0, it_done = 0, slot = 1;
  Lin cache[kCache ? P : 1];
  for (int it = 0; it < a.iters; ++it) {
    const int trial = 1 - cur;

    // ---- pass 1: reduced Hessian and gradient ----
    float acc[kSums];
#pragma unroll
    for (int k = 0; k < kSums; ++k) acc[k] = 0.f;
    auto pass1 = [&](const Point& q, float f0, float f1, Lin& L) {
      float r[2], rf[2], A0[6], A1[6];
      L = linearise(q, R, t, f0, f1, lam, a, r, rf);
      jacobian(L.y0, L.y1, L.y2, L.iz, a, A0, A1);
      const float inv_h = L.inv_h;
      const float wH = L.wp * (a.wf0 + lam) * inv_h;
      const float k1 = 1.f - L.wp * inv_h, k2 = a.wf0 * inv_h;
      const float e0 = L.wp * (k1 * r[0] - k2 * rf[0]);
      const float e1 = L.wp * (k1 * r[1] - k2 * rf[1]);
      int k = 0;
#pragma unroll
      for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int j = i; j < 6; ++j) acc[k++] += wH * (A0[i] * A0[j] + A1[i] * A1[j]);
#pragma unroll
      for (int i = 0; i < 6; ++i) acc[21 + i] += A0[i] * e0 + A1[i] * e1;
    };
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int k = tid + j * kThreads;
      if (k < held) {
        const Point q = held_point(k);
        if (q.valid) {
          Lin L;
          pass1(q, PL(kFlowPlane + 2 * cur, k), PL(kFlowPlane + 2 * cur + 1, k), L);
          if constexpr (kCache) cache[j] = L;
        }
      }
    }
    for (int k = held + tid; k < cnt; k += kThreads) {
      const Point q = fetch_point(a, m, begin + k, s_W);
      if (q.valid) {
        Lin L;
        pass1(q, GF(2 * cur, k), GF(2 * cur + 1, k), L);
      }
    }
    cluster_reduce<kSums, false, true>(acc, rb, slot, cl);
    slot ^= 1;

    // ---- the damped 6x6 solve, exp and compose: warp 0 of every CTA on the
    // same totals, so every CTA takes the same step ----
    if (threadIdx.x < 32) {
      float dxi[6], Rn[9], tn[3], pred_pose = 0.f;
      float H[36], mg[6];
      int k = 0;
#pragma unroll
      for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int j = i; j < 6; ++j) {
          H[i * 6 + j] = acc[k];
          H[j * 6 + i] = acc[k];
          ++k;
        }
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        H[i * 6 + i] += lam;
        mg[i] = -acc[21 + i];
      }
      chol_solve6(H, mg, dxi);
#pragma unroll
      for (int i = 0; i < 6; ++i) pred_pose += dxi[i] * (lam * dxi[i] - acc[21 + i]);
      float dR[9], dt[3];
      exp_se3(dxi, dR, dt);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j)
          Rn[i * 3 + j] = dR[i * 3] * R[j] + dR[i * 3 + 1] * R[3 + j] + dR[i * 3 + 2] * R[6 + j];
        tn[i] = dR[i * 3] * t[0] + dR[i * 3 + 1] * t[1] + dR[i * 3 + 2] * t[2] + dt[i];
      }
      if (threadIdx.x == 0) {
#pragma unroll
        for (int i = 0; i < 6; ++i) rb.step[i] = dxi[i];
#pragma unroll
        for (int i = 0; i < 9; ++i) rb.step[6 + i] = Rn[i];
#pragma unroll
        for (int i = 0; i < 3; ++i) rb.step[15 + i] = tn[i];
        rb.step[18] = pred_pose;
      }
    }
    __syncthreads();
    float dxi[6], Rn[9], tn[3];
#pragma unroll
    for (int i = 0; i < 6; ++i) dxi[i] = rb.step[i];
#pragma unroll
    for (int i = 0; i < 9; ++i) Rn[i] = rb.step[6 + i];
#pragma unroll
    for (int i = 0; i < 3; ++i) tn[i] = rb.step[15 + i];
    const float pred_pose = rb.step[18];

    // ---- pass 2: flow back-substitution, trial objective ----
    float acc2[2] = {0.f, 0.f};                   // pred_flow, F_new
    auto pass2 = [&](const Point& q, float f0, float f1, const Lin& L, float& g0, float& g1) {
      float A0[6], A1[6];
      jacobian(L.y0, L.y1, L.y2, L.iz, a, A0, A1);
      const float inv_h = L.inv_h;
      float Ad0 = 0.f, Ad1 = 0.f;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        Ad0 += A0[i] * dxi[i];
        Ad1 += A1[i] * dxi[i];
      }
      const float df0 = -(L.gf0 + L.wp * Ad0) * inv_h;
      const float df1 = -(L.gf1 + L.wp * Ad1) * inv_h;
      acc2[0] += df0 * (lam * df0 - L.gf0) + df1 * (lam * df1 - L.gf1);
      g0 = f0 + df0;
      g1 = f1 + df1;
      acc2[1] += point_objective(q, Rn, tn, g0, g1, a);
    };
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int k = tid + j * kThreads;
      if (k < held) {
        const Point q = held_point(k);
        if (q.valid) {
          const float f0 = PL(kFlowPlane + 2 * cur, k), f1 = PL(kFlowPlane + 2 * cur + 1, k);
          Lin L;
          if constexpr (kCache) {
            L = cache[j];
          } else {
            float r[2], rf[2];
            L = linearise(q, R, t, f0, f1, lam, a, r, rf);
          }
          pass2(q, f0, f1, L, PL(kFlowPlane + 2 * trial, k), PL(kFlowPlane + 2 * trial + 1, k));
        }
      }
    }
    for (int k = held + tid; k < cnt; k += kThreads) {
      const Point q = fetch_point(a, m, begin + k, s_W);
      if (q.valid) {
        const float f0 = GF(2 * cur, k), f1 = GF(2 * cur + 1, k);
        float r[2], rf[2];
        const Lin L = linearise(q, R, t, f0, f1, lam, a, r, rf);
        pass2(q, f0, f1, L, GF(2 * trial, k), GF(2 * trial + 1, k));
      }
    }
    cluster_reduce<2, false>(acc2, rb, slot, cl);
    slot ^= 1;

    // ---- accept / reject, Nielsen's lambda update (every thread alike) ----
    const float F_new = acc2[1];
    const float pred = 0.5f * (pred_pose + acc2[0]);
    const float gain = (F - F_new) / fmaxf(pred, 1e-20f);
    const bool accept = (F_new < F) && isfinite(F_new);
    const float qg = 2.f * gain - 1.f;
    const float lam_acc = lam * fmaxf(1.f / 3.f, 1.f - qg * qg * qg);
    const bool done = (accept && (F - F_new < a.rel_tol * F + 1e-10f)) || (lam > 1e8f);
    if (accept) {
#pragma unroll
      for (int k = 0; k < 9; ++k) R[k] = Rn[k];
#pragma unroll
      for (int k = 0; k < 3; ++k) t[k] = tn[k];
      F = F_new;
      cur = trial;
      lam = lam_acc;
      nu = 2.f;
    } else {
      lam = lam * nu;
      nu = nu * 2.f;
    }
    it_done = it + 1;
    if (done) break;
  }

  // ---- final unweighted chi2, flows, inliers, mean reprojection ----
  float acc[2] = {0.f, 0.f};                      // inliers, sum sqrt(chi2)
  auto final_point = [&](const Point& q, int i, float f0, float f1) {
    const float y0 = R[0] * q.X0 + R[1] * q.X1 + R[2] * q.X2 + t[0];
    const float y1 = R[3] * q.X0 + R[4] * q.X1 + R[5] * q.X2 + t[1];
    const float y2 = R[6] * q.X0 + R[7] * q.X1 + R[8] * q.X2 + t[2];
    const float iz = 1.f / (y2 + 1e-9f);
    const float r0 = (q.ob0 + f0) - (a.fx * y0 * iz + a.cx);
    const float r1 = (q.ob1 + f1) - (a.fy * y1 * iz + a.cy);
    const float chi2 = a.wp0 * (r0 * r0 + r1 * r1);
    const bool inl = q.valid && chi2 <= a.d2;
    const size_t o = (size_t)m * n + i;
    a.chi2_out[o] = chi2;
    a.flow_out[2 * o] = f0;
    a.flow_out[2 * o + 1] = f1;
    a.inl_out[o] = inl ? 1 : 0;
    if (inl) {
      acc[0] += 1.f;
      acc[1] += sqrtf(chi2);
    }
  };
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int k = tid + j * kThreads;
    if (k < held)
      final_point(held_point(k), begin + k, PL(kFlowPlane + 2 * cur, k),
                  PL(kFlowPlane + 2 * cur + 1, k));
  }
  for (int k = held + tid; k < cnt; k += kThreads)
    final_point(fetch_point(a, m, begin + k, s_W), begin + k, GF(2 * cur, k),
                GF(2 * cur + 1, k));
  cluster_reduce<2, false>(acc, rb, slot, cl);
  if (rank == 0 && tid == 0) {
    float* T = a.T_out + (size_t)m * 16;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) T[i * 4 + j] = R[i * 3 + j];
      T[i * 4 + 3] = t[i];
    }
    T[12] = 0.f;
    T[13] = 0.f;
    T[14] = 0.f;
    T[15] = 1.f;
    a.n_inl_out[m] = (long long)acc[0];
    a.mean_out[m] = acc[1] / fmaxf(acc[0], 1.f);
    a.iters_out[m] = it_done;
  }
  cl.sync();               // no CTA leaves while another may read its partials
}

template <int P>
size_t smem_bytes() { return (size_t)kPlanes * held_points<P>() * sizeof(float); }

template <int P>
int launch(const Args& a, int m, int cluster, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(m * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes<P>();
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // a cluster shape the card cannot co-schedule fails here: that error is
  // the refusal
  cudaError_t err = cudaLaunchKernelEx(&cfg, flow_ba_lm_kernel<P>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int P>
int set_smem() {
  return (int)cudaFuncSetAttribute(flow_ba_lm_kernel<P>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem_bytes<P>());
}

}  // namespace

extern "C" {

// Once per library load: let every instantiation use its shared memory.
int flow_ba_lm_init() {
  int err = set_smem<1>();
  if (!err) err = set_smem<2>();
  if (!err) err = set_smem<4>();
  if (!err) err = set_smem<8>();
  if (!err) err = set_smem<16>();
  return err;
}

// Points a CTA holds in shared memory at the most (beyond that it streams).
int flow_ba_lm_max_held() { return held_points<kMaxP>(); }

// CTAs of the p-point instantiation that one SM holds, as the card reports
// it (the wrapper's plan assumes ctas_per_sm<p>()), or -1 on an error.
int flow_ba_lm_ctas_per_sm(int p) {
  int n = -1;
  cudaError_t err = cudaErrorInvalidValue;
  switch (p) {
    case 1: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, flow_ba_lm_kernel<1>, kThreads, smem_bytes<1>()); break;
    case 2: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, flow_ba_lm_kernel<2>, kThreads, smem_bytes<2>()); break;
    case 4: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, flow_ba_lm_kernel<4>, kThreads, smem_bytes<4>()); break;
    case 8: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, flow_ba_lm_kernel<8>, kThreads, smem_bytes<8>()); break;
    case 16: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, flow_ba_lm_kernel<16>, kThreads, smem_bytes<16>()); break;
  }
  return err == cudaSuccess ? n : -1;
}

// Launch m clusters of `cluster` CTAs (1, 2, 4 or 8), `p` held points per
// thread (1, 2, 4, 8 or 16), on `stream`.  Returns a CUDA error code
// (0 = launched); a cluster the card cannot schedule is the launch's own
// error.
int flow_ba_lm_launch(const float* T_init, long long sT, const float* Twl, long long sW,
                      const float* obs, long long sO, const float* fm, long long sF,
                      const float* depth, long long sD, const uint8_t* valid, long long sV,
                      const float* wpt, long long sP, float* T_out, float* flow_out,
                      float* chi2_out, uint8_t* inl_out, long long* n_inl_out, float* mean_out,
                      int* iters_out, float* scratch, int m, int n, int cluster, int p,
                      int iters, float reproj_info, float prior_info, float rp_thres, float tau,
                      float rel_tol, float fx, float fy, float cx, float cy, void* stream) {
  if (m <= 0) return 0;
  if (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) return (int)cudaErrorInvalidValue;
  // a CTA streams the points beyond p * kThreads; their flows need scratch
  if ((n + cluster - 1) / cluster > p * kThreads && !scratch) return (int)cudaErrorInvalidValue;
  const Args a{T_init, sT, Twl, sW, obs, sO, fm, sF, depth, sD, valid, sV, wpt, sP,
               T_out, flow_out, chi2_out, inl_out, n_inl_out, mean_out, iters_out, scratch,
               n, iters, reproj_info, prior_info, rp_thres, tau, rel_tol, fx, fy, cx, cy};
  cudaStream_t s = (cudaStream_t)stream;
  switch (p) {
    case 1: return launch<1>(a, m, cluster, s);
    case 2: return launch<2>(a, m, cluster, s);
    case 4: return launch<4>(a, m, cluster, s);
    case 8: return launch<8>(a, m, cluster, s);
    case 16: return launch<16>(a, m, cluster, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
