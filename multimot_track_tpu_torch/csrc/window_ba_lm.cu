// Trailing-window bundle adjustment LM, one thread-block cluster per window (sm_90a).
//
// Replaces no TPU kernel: the JAX package's solvers/window_ba.solve_window_ba
// is an XLA while_loop.  The port's plain version (solvers/window_ba.py) runs
// it as a Python loop of eager ops, ~13,000 launches a window, and the host's
// time per launch, not the card, set its pace.  This kernel runs the whole
// solve in one launch:
//
//   cost = sum_{f >= 1, i vis} Huber(||obs_{f,i} - pi(T_f pi^-1(obs_{0,i}, 1 / rho_i))||^2)
//        + w_prior sum_{i valid} (rho_i - rho0_i)^2
//        + w_odo sum_e ||log(T_e T_{e-1}^-1 Z_e^-1)||^2
//
// over the F - 1 free poses (frame 0 is the gauge) and one inverse depth a
// track.  Each of exactly `iters` steps linearises every observation (Huber
// IRLS weights), eliminates each track's inverse depth (a scalar), adds the
// odometry-prior blocks, solves the damped D x D reduced system (D = 6 (F -
// 1)) by Cholesky, back-substitutes the inverse depths, evaluates the
// candidate and applies Nielsen's lambda schedule.  A failed pivot gives a
// non-finite step, which the acceptance test rejects.
//
// What bounds it on an H100.  At the live shape (F = 5, N = 2048, 30 steps,
// ~7,400 visible observations) the algorithm needs ~3.3 MFLOP a step (per
// observation ~264: the linearisation and its 27 + 8 products, the
// candidate's objective; per valid track ~720: its rank-one Schur term
// b b^T / h over the 25 x 25 augmented system and the back-substitution;
// ~6k for the 24 x 24 Cholesky and solves), ~100 MFLOP a solve: ~1.5 us of
// the fp32 peak, and ~110 KB of inputs and outputs (chip_smoke.py's
// k3_bound_us counts it).  But each step is a strict chain: a pass over the
// tracks, a cluster-wide reduction of the reduced system, a Cholesky of D
// sequential columns on one warp, an exp and compose per pose, a second
// pass and a second reduction, ~40 us in all.  Latency, not operations or
// bytes, sets the pace.
//
// What the design does about it.
//  - One cluster of C CTAs (C in {1, 2, 4, 8}, planned from N by the
//    wrapper) holds the window; CTA r owns tracks [r S, r S + S), S =
//    ceil(N / C), and its thread j owns tracks j, j + 256, ...  Only the
//    owner touches a track's inverse depth and its Schur row, so no barrier
//    guards them: they live in a global scratch buffer (L2-resident), which
//    also streams any number of tracks.
//  - Per track tile (one track a thread), pass 1 walks the track's F - 1
//    observations: each observation's 21 + 6 pose-block sums go through a
//    warp reduce-scatter (31 shuffles) into the warp's own per-frame
//    accumulators in shared memory, and its 6 Schur columns B_f into a
//    shared tile of rows [B, g_rho] / sqrt(h_rho).  The tile's (D + 1)(D +
//    2) / 2 upper-triangle products sum_i u_a u_b are split over the
//    threads, each summing its entries over the tile in track order from
//    16-byte loads (rows 4 banks apart, so a quarter warp's rows never
//    share a bank).
//  - Reductions are fixed order with no atomics: warps in warp order,
//    tiles in tile order, then after a cluster barrier each CTA adds the C
//    CTA partials in rank order through distributed shared memory.  Every
//    CTA thus holds the same totals bit for bit, builds the same reduced
//    system, and warp 0 of each runs the same Cholesky, solve, exp and
//    compose: the cluster takes the same steps with no broadcast.  Big and
//    small reductions alternate, so one cluster barrier each keeps a
//    partial from being rewritten while another CTA still reads it.  Two
//    launches on the same inputs give the same bits.
//  - The kernel reads the caller's tensors as they are (frame-0
//    back-projection, rho0, the visibility mask and the odometry targets
//    happen on the card) and writes poses, inverse depths and chi2: the
//    wrapper allocates and launches, nothing else.
//
// Numerics follow the plain solver: 1/(z + 1e-9) in the residual, 1/max(z,
// 1e-6) in the Jacobian, clamps that pass NaN on as torch.clamp does, the
// same seed of lambda.  Plain C ABI, bound with ctypes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "se3.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = kThreads;        // tracks per Schur tile: one a thread
constexpr int kUS = kTile + 4;         // tile row stride: 16-byte rows, 4 banks apart
constexpr int kMaxF = 16;
constexpr int kMaxD = 6 * (kMaxF - 1);
constexpr int kPair = 27;              // 21 upper-triangle H_ff entries + 6 of g_f
constexpr int kMaxE = (kMaxD + 1) * (kMaxD + 2) / 2;
constexpr int kMaxSlots = (kMaxE + kThreads - 1) / kThreads;

struct Args {
  const float* poses;      // (F, 4, 4) initial Tcw, frame 0 the gauge
  const float* uv;         // (F, N, 2)
  const uint8_t* alive;    // (F, N) bool
  const float* depth0;     // (N,)
  float* poses_out;        // (F, 4, 4)
  float* rho_out;          // (N,)
  float* chi2_out;         // ()
  float* scratch;          // (D + 4, N): B planes, h, g_rho, two inverse-depth buffers
  int F, n, iters;
  float fx, fy, cx, cy, huber, d2, w_prior, tau, w_odo;
};

// torch.clamp(x, min=m): NaN stays NaN (fmaxf would drop it).
__device__ __forceinline__ float clampmin(float x, float m) { return x < m ? m : x; }

// Offsets (in floats) of the dynamic shared memory for F frames.
struct Layout {
  int U, accw, part, tot, A, g, y, z, dxi, invd, pose, Z, Ad, AtA, ro, ron, misc, total;
};

__host__ __device__ inline Layout layout(int F) {
  const int Fm = F - 1, D = 6 * Fm, E = (D + 1) * (D + 2) / 2, L = Fm * kPair + E;
  Layout o;
  int p = 0;
  o.U = p;    p += (D + 1) * kUS;           // first: 16-byte aligned rows
  o.accw = p; p += kWarps * Fm * kPair;
  o.part = p; p += L;
  o.tot = p;  p += L;
  o.A = p;    p += D * (D + 1);
  o.g = p;    p += D;
  o.y = p;    p += D;
  o.z = p;    p += D;
  o.dxi = p;  p += D;
  o.invd = p; p += D;
  o.pose = p; p += 2 * Fm * 12;            // current and candidate poses
  o.Z = p;    p += Fm * 12;
  o.Ad = p;   p += Fm * 36;
  o.AtA = p;  p += Fm * 36;
  o.ro = p;   p += Fm * 6;
  o.ron = p;  p += Fm * 6;
  o.misc = p; p += 4;
  o.total = p;
  return o;
}

// Index of (r, c), r <= c, in the row-major upper triangle of an n x n matrix.
__host__ __device__ __forceinline__ int tri(int r, int c, int n) {
  return r * n - r * (r - 1) / 2 + (c - r);
}

// One track's frame-0 data.
struct Track {
  float d0, d1;    // the frame-0 ray (x / z, y / z), z = 1
  float rho0;      // depth prior
  bool valid;      // alive in frame 0 with positive depth
};

__device__ __forceinline__ Track fetch_track(const Args& a, int i) {
  Track k;
  const float d = a.depth0[i];
  k.valid = a.alive[i] != 0 && d > 0.f;
  k.rho0 = k.valid ? 1.f / clampmin(d, 1e-3f) : 1.f;
  k.d0 = (a.uv[2 * i] - a.cx) / a.fx;
  k.d1 = (a.uv[2 * i + 1] - a.cy) / a.fy;
  return k;
}

// Robust reprojection cost of a valid track over its visible frames plus
// its depth prior, at poses P (Fm x 12) and inverse depth rho.
__device__ float track_objective(const Args& a, const Track& k, int i, float rho,
                                 const float* P, int Fm) {
  if (!k.valid) return 0.f;
  const float X0 = k.d0 / rho, X1 = k.d1 / rho, X2 = 1.f / rho;
  float s = 0.f;
  for (int f = 0; f < Fm; ++f) {
    const size_t o = (size_t)(f + 1) * a.n + i;
    if (!a.alive[o]) continue;
    const float* T = P + 12 * f;
    const float y0 = T[0] * X0 + T[1] * X1 + T[2] * X2 + T[3];
    const float y1 = T[4] * X0 + T[5] * X1 + T[6] * X2 + T[7];
    const float y2 = T[8] * X0 + T[9] * X1 + T[10] * X2 + T[11];
    const float izr = 1.f / (y2 + 1e-9f);
    const float r0 = a.uv[2 * o] - (a.fx * y0 * izr + a.cx);
    const float r1 = a.uv[2 * o + 1] - (a.fy * y1 * izr + a.cy);
    const float rn2 = r0 * r0 + r1 * r1;
    s += rn2 <= a.d2 ? rn2 : 2.f * a.huber * sqrtf(clampmin(rn2, 1e-20f)) - a.d2;
  }
  const float dr = rho - k.rho0;
  return s + a.w_prior * (dr * dr);
}

// Odometry residuals r_e = log(T_e T_{e-1}^-1 Z_e^-1) (T_{-1} = I) of poses
// P into ro (Fm x 6), by warp 0; returns w_odo sum ||r||^2 on lane 0.
__device__ float odo_residuals(const float* P, const float* Z, float* ro, int Fm, float w_odo,
                               int lane) {
  if (lane < Fm) {
    float M[12], Zi[12], C[12];
    if (lane == 0) {
#pragma unroll
      for (int q = 0; q < 12; ++q) M[q] = P[q];
    } else {
      float Pi[12];
      inverse34(P + 12 * (lane - 1), Pi);
      compose34(P + 12 * lane, Pi, M);
    }
    inverse34(Z + 12 * lane, Zi);
    compose34(M, Zi, C);
    log_se3(C, ro + 6 * lane);
  }
  __syncwarp();
  float s = 0.f;
  if (lane == 0)
    for (int q = 0; q < 6 * Fm; ++q) s += ro[q] * ro[q];
  return w_odo * s;
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

struct SmallBufs {
  float warp[kWarps][2];
  float cta[2];      // read by the whole cluster
  float tot[2];
};

// Sum (value 0: the min when kMin0) two per-thread values over the
// cluster in a fixed order; every thread returns the totals.
template <bool kMin0>
__device__ __forceinline__ void reduce2(float (&v)[2], SmallBufs& sb, cg::cluster_group& cl) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  auto op = [](bool is_min, float x, float y) { return is_min ? fminf(x, y) : x + y; };
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    float x = v[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x = op(kMin0 && k == 0, x, __shfl_xor_sync(0xffffffffu, x, off));
    if (lane == 0) sb.warp[warp][k] = x;
  }
  __syncthreads();
  const int k = threadIdx.x;
  if (k < 2) {
    float s = sb.warp[0][k];
    for (int w = 1; w < kWarps; ++w) s = op(kMin0 && k == 0, s, sb.warp[w][k]);
    sb.cta[k] = s;
  }
  cl.sync();
  if (k < 2) {
    const int C = (int)cl.num_blocks();
    float part[8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
      if (r < C) part[r] = cl.map_shared_rank(&sb.cta[k], r)[0];
    float s = part[0];
#pragma unroll
    for (int r = 1; r < 8; ++r)
      if (r < C) s = op(kMin0 && k == 0, s, part[r]);
    sb.tot[k] = s;
  }
  __syncthreads();
  v[0] = sb.tot[0];
  v[1] = sb.tot[1];
}

__global__ void __launch_bounds__(kThreads, 1) window_ba_lm_kernel(const Args a) {
  extern __shared__ __align__(16) float sm[];
  __shared__ SmallBufs sb;
  cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int F = a.F, Fm = F - 1, D = 6 * Fm, n = a.n;
  const int E = (D + 1) * (D + 2) / 2, L = Fm * kPair + E, lda = D + 1;
  const int S = (n + C - 1) / C, begin = min(rank * S, n), cnt = min(n - begin, S);
  const int tiles = (cnt + kTile - 1) / kTile;
  const Layout lo = layout(F);
  float* U = sm + lo.U;
  float* accw = sm + lo.accw;
  float* part = sm + lo.part;
  float* tot = sm + lo.tot;
  float* A = sm + lo.A;
  float* g = sm + lo.g;
  float* dxi = sm + lo.dxi;
  float* Z = sm + lo.Z;
  float* Ad = sm + lo.Ad;
  float* AtA = sm + lo.AtA;
  float* ro = sm + lo.ro;
  float* ron = sm + lo.ron;
  float* misc = sm + lo.misc;        // odo cost of the candidate, pose part of pred, step ok
  float* Bs = a.scratch;             // plane j < D: B_j; D: h; D + 1: g_rho
  float* rho_buf[2] = {a.scratch + (size_t)(D + 2) * n, a.scratch + (size_t)(D + 3) * n};

  // this thread's Schur entries tid + 256 s of the (D + 1)^2 upper triangle,
  // as row * 128 + column (-1: none)
  int ent[kMaxSlots];
#pragma unroll
  for (int s = 0; s < kMaxSlots; ++s) {
    int e = tid + s * kThreads, r = 0;
    if (e < E) {
      while (e >= D + 1 - r) {
        e -= D + 1 - r;
        ++r;
      }
      ent[s] = r * 128 + r + e;
    } else {
      ent[s] = -1;
    }
  }

  // ---- poses, odometry targets, their adjoints ----
  if (tid < Fm) {
    float Pi[12];
    inverse34(a.poses + 16 * tid, Pi);
    compose34(a.poses + 16 * (tid + 1), Pi, Z + 12 * tid);
    adjoint34(Z + 12 * tid, Ad + 36 * tid);
#pragma unroll
    for (int q = 0; q < 12; ++q) sm[lo.pose + 12 * tid + q] = a.poses[16 * (tid + 1) + q];
  }
  __syncthreads();
  for (int p = tid; p < (Fm - 1) * 36; p += kThreads) {   // A2_e^T A2_e, A2_e = Ad(Z_{e+1})
    const int e = p / 36, r = (p % 36) / 6, c = p % 6;
    const float* M = Ad + 36 * (e + 1);
    float s = 0.f;
    for (int k = 0; k < 6; ++k) s += M[6 * k + r] * M[6 * k + c];
    AtA[p] = s;
  }
  float odo = 0.f;
  if (warp == 0) odo = odo_residuals(sm + lo.pose, Z, ro, Fm, a.w_odo, lane);
  if (tid == 0) misc[0] = a.w_odo > 0.f ? odo : 0.f;
  __syncthreads();

  // ---- initial objective and the seed of lambda ----
  float lam, Fv;
  {
    float v[2] = {1e9f, 0.f};            // nearest valid depth, objective
    for (int k = tid; k < cnt; k += kThreads) {
      const int i = begin + k;
      const Track tr = fetch_track(a, i);
      rho_buf[0][i] = tr.rho0;
      if (tr.valid) v[0] = fminf(v[0], a.depth0[i]);
      v[1] += track_objective(a, tr, i, tr.rho0, sm + lo.pose, Fm);
    }
    reduce2<true>(v, sb, cl);
    Fv = v[1] + misc[0];
    const float q = a.fx / clampmin(v[0], 1.f);
    lam = a.tau * clampmin(q * q, 1.f);
  }

  float nu = 2.f;
  int pc = 0, cur = 0;                   // current pose buffer, inverse-depth buffer
  for (int it = 0; it < a.iters; ++it) {
    const float* P = sm + lo.pose + 12 * Fm * pc;
    float* Pn = sm + lo.pose + 12 * Fm * (1 - pc);

    // ---- pass 1: pose blocks, Schur terms ----
    for (int p = tid; p < kWarps * Fm * kPair; p += kThreads) accw[p] = 0.f;
    float sacc[kMaxSlots];
#pragma unroll
    for (int s = 0; s < kMaxSlots; ++s) sacc[s] = 0.f;
    __syncthreads();
    for (int tile = 0; tile < tiles; ++tile) {
      const int k = tile * kTile + tid;
      const bool have = k < cnt;
      const int i = begin + k;
      Track tr{0.f, 0.f, 1.f, false};
      float rho = 1.f;
      if (have) {
        tr = fetch_track(a, i);
        rho = rho_buf[cur][i];
      }
      const float X0 = tr.d0 / rho, X1 = tr.d1 / rho, X2 = 1.f / rho;
      float h_acc = 0.f, gr_acc = 0.f;
      for (int f = 0; f < Fm; ++f) {
        float x[32];
#pragma unroll
        for (int q = 0; q < 32; ++q) x[q] = 0.f;
        float B[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        const size_t o = (size_t)(f + 1) * n + i;
        if (tr.valid && a.alive[o]) {
          const float* T = P + 12 * f;
          const float q0 = T[0] * X0 + T[1] * X1 + T[2] * X2;     // R X
          const float q1 = T[4] * X0 + T[5] * X1 + T[6] * X2;
          const float q2 = T[8] * X0 + T[9] * X1 + T[10] * X2;
          const float y0 = q0 + T[3], y1 = q1 + T[7], y2 = q2 + T[11];
          const float izr = 1.f / (y2 + 1e-9f);
          const float r0 = a.uv[2 * o] - (a.fx * y0 * izr + a.cx);
          const float r1 = a.uv[2 * o + 1] - (a.fy * y1 * izr + a.cy);
          const float rn2 = r0 * r0 + r1 * r1;
          const float w = rn2 <= a.d2 ? 1.f : a.huber / sqrtf(clampmin(rn2, 1e-20f));
          const float iz = 1.f / clampmin(y2, 1e-6f);
          const float pa = a.fx * iz, pb = -a.fx * y0 * iz * iz;
          const float pc_ = a.fy * iz, pd = -a.fy * y1 * iz * iz;
          // Jp = -(dpi [-hat(y) | I]), the left-update pose Jacobian
          const float A0[6] = {-pb * y1, -pa * y2 + pb * y0, pa * y1, -pa, 0.f, -pb};
          const float A1[6] = {pc_ * y2 - pd * y1, pd * y0, -pc_ * y0, 0.f, -pc_, -pd};
          // Jr = -(dpi dy/drho), dy/drho = -R X / rho
          const float e0 = -q0 / rho, e1 = -q1 / rho, e2 = -q2 / rho;
          const float J0 = -(pa * e0 + pb * e2), J1 = -(pc_ * e1 + pd * e2);
          int q = 0;
#pragma unroll
          for (int r = 0; r < 6; ++r)
#pragma unroll
            for (int c = r; c < 6; ++c) x[q++] = w * (A0[r] * A0[c] + A1[r] * A1[c]);
#pragma unroll
          for (int r = 0; r < 6; ++r) {
            x[21 + r] = w * (A0[r] * r0 + A1[r] * r1);
            B[r] = w * (A0[r] * J0 + A1[r] * J1);
          }
          h_acc += w * (J0 * J0 + J1 * J1);
          gr_acc += w * (J0 * r0 + J1 * r1);
        }
#pragma unroll
        for (int r = 0; r < 6; ++r) {
          U[(6 * f + r) * kUS + tid] = B[r];
          if (have) Bs[(size_t)(6 * f + r) * n + i] = B[r];
        }
        scatter_step<16>(x, lane);
        scatter_step<8>(x, lane);
        scatter_step<4>(x, lane);
        scatter_step<2>(x, lane);
        scatter_step<1>(x, lane);
        if (lane < kPair) accw[(warp * Fm + f) * kPair + lane] += x[0];
      }
      const float h = h_acc + a.w_prior + lam;
      const float gr = gr_acc + a.w_prior * (rho - tr.rho0);
      const float sc = tr.valid ? 1.f / sqrtf(h) : 0.f;
      for (int r = 0; r < D; ++r) U[r * kUS + tid] *= sc;
      U[D * kUS + tid] = gr * sc;
      if (have) {
        Bs[(size_t)D * n + i] = h;
        Bs[(size_t)(D + 1) * n + i] = gr;
      }
      __syncthreads();
      const int cols4 = (min(cnt - tile * kTile, kTile) + 3) / 4;
#pragma unroll
      for (int s = 0; s < kMaxSlots; ++s) {
        if (ent[s] >= 0) {
          const float4* ua = reinterpret_cast<const float4*>(U + (ent[s] >> 7) * kUS);
          const float4* ub = reinterpret_cast<const float4*>(U + (ent[s] & 127) * kUS);
          float acc = sacc[s];
          for (int c = 0; c < cols4; ++c) {
            const float4 p = ua[c], q = ub[c];
            acc = fmaf(p.x, q.x, acc);
            acc = fmaf(p.y, q.y, acc);
            acc = fmaf(p.z, q.z, acc);
            acc = fmaf(p.w, q.w, acc);
          }
          sacc[s] = acc;
        }
      }
      __syncthreads();
    }

    // ---- the cluster's totals: CTA partials, then every CTA adds them in rank order ----
    for (int p = tid; p < Fm * kPair; p += kThreads) {
      float s = accw[p];
      for (int w = 1; w < kWarps; ++w) s += accw[w * Fm * kPair + p];
      part[p] = s;
    }
#pragma unroll
    for (int s = 0; s < kMaxSlots; ++s)
      if (ent[s] >= 0) part[Fm * kPair + tid + s * kThreads] = sacc[s];
    cl.sync();
    for (int p = tid; p < L; p += kThreads) {
      float q[8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
        if (r < C) q[r] = cl.map_shared_rank(part + p, r)[0];
      float s = q[0];
#pragma unroll
      for (int r = 1; r < 8; ++r)
        if (r < C) s += q[r];
      tot[p] = s;
    }
    __syncthreads();

    // ---- the damped reduced system H dxi = -g ----
    const float* Sch = tot + Fm * kPair;
    for (int p = tid; p < D * D; p += kThreads) {
      const int r = p / D, c = p % D, fr = r / 6, ar = r % 6, fc = c / 6, ac = c % 6;
      float v = 0.f;
      if (fr == fc) v = tot[fr * kPair + tri(min(ar, ac), max(ar, ac), 6)] + (ar == ac ? lam : 0.f);
      v -= Sch[tri(min(r, c), max(r, c), D + 1)];
      if (a.w_odo > 0.f) {          // edge e couples poses (e - 1, e): I and -Ad(Z_e)
        if (fr == fc) {
          if (ar == ac) v += a.w_odo;
          if (fr < Fm - 1) v += a.w_odo * AtA[36 * fr + 6 * ar + ac];
        } else if (fr == fc + 1) {
          v += -a.w_odo * Ad[36 * (fc + 1) + 6 * ar + ac];
        } else if (fc == fr + 1) {
          v += -a.w_odo * Ad[36 * (fr + 1) + 6 * ac + ar];
        }
      }
      A[r * lda + c] = v;
    }
    for (int r = tid; r < D; r += kThreads) {
      const int fr = r / 6, ar = r % 6;
      float v = tot[fr * kPair + 21 + ar] - Sch[tri(r, D, D + 1)];
      if (a.w_odo > 0.f) {
        v += a.w_odo * ro[r];
        if (fr < Fm - 1) {
          float s = 0.f;
          for (int k = 0; k < 6; ++k) s += Ad[36 * (fr + 1) + 6 * k + ar] * ro[6 * (fr + 1) + k];
          v -= a.w_odo * s;
        }
      }
      g[r] = v;
    }
    __syncthreads();

    // ---- warp 0 of every CTA: Cholesky, solve, exp and compose, candidate odometry ----
    if (warp == 0) {
      float* invd = sm + lo.invd;
      float* y = sm + lo.y;
      float* z = sm + lo.z;
      for (int k = 0; k < D; ++k) {
        const float d = A[k * lda + k];
        const float inv = d > 0.f ? 1.f / sqrtf(d) : __int_as_float(0x7fc00000);   // NaN step
        for (int r = k + 1 + lane; r < D; r += 32) A[r * lda + k] *= inv;
        if (lane == 0) invd[k] = inv;
        __syncwarp();
        for (int r = k + 1 + lane; r < D; r += 32) {
          const float l = A[r * lda + k];
          for (int c = k + 1; c <= r; ++c) A[r * lda + c] -= l * A[c * lda + k];
        }
        __syncwarp();
      }
      for (int r = lane; r < D; r += 32) y[r] = -g[r];
      __syncwarp();
      for (int k = 0; k < D; ++k) {              // L z = -g
        const float zk = y[k] * invd[k];
        if (lane == 0) z[k] = zk;
        for (int r = k + 1 + lane; r < D; r += 32) y[r] -= A[r * lda + k] * zk;
        __syncwarp();
      }
      for (int k = D - 1; k >= 0; --k) {         // L^T dxi = z
        const float xk = z[k] * invd[k];
        if (lane == 0) dxi[k] = xk;
        for (int r = lane; r < k; r += 32) z[r] -= A[k * lda + r] * xk;
        __syncwarp();
      }
      if (lane < Fm) {                           // candidate T_f = exp(dxi_f) T_f
        float dR[9], dt[3];
        exp_se3(dxi + 6 * lane, dR, dt);
        const float* T = P + 12 * lane;
        float* Tn = Pn + 12 * lane;
#pragma unroll
        for (int r = 0; r < 3; ++r) {
#pragma unroll
          for (int c = 0; c < 3; ++c)
            Tn[4 * r + c] = dR[3 * r] * T[c] + dR[3 * r + 1] * T[4 + c] + dR[3 * r + 2] * T[8 + c];
          Tn[4 * r + 3] = dR[3 * r] * T[3] + dR[3 * r + 1] * T[7] + dR[3 * r + 2] * T[11] + dt[r];
        }
      }
      __syncwarp();
      const float odo_new = odo_residuals(Pn, Z, ron, Fm, a.w_odo, lane);
      if (lane == 0) {
        float pred = 0.f;
        bool ok = true;
        for (int r = 0; r < D; ++r) {
          pred += dxi[r] * (lam * dxi[r] - g[r]);
          ok = ok && isfinite(dxi[r]);
        }
        misc[0] = a.w_odo > 0.f ? odo_new : 0.f;
        misc[1] = pred;
        misc[2] = ok ? 1.f : 0.f;
      }
    }
    __syncthreads();

    // ---- pass 2: inverse-depth back-substitution, the candidate's objective ----
    float v[2] = {0.f, 0.f};                       // objective, inverse-depth part of pred
    for (int k = tid; k < cnt; k += kThreads) {
      const int i = begin + k;
      const Track tr = fetch_track(a, i);
      const float rho = rho_buf[cur][i];
      float bd = 0.f;
      for (int r = 0; r < D; ++r) bd += Bs[(size_t)r * n + i] * dxi[r];
      const float h = Bs[(size_t)D * n + i], gr = Bs[(size_t)(D + 1) * n + i];
      const float drho = -(gr + bd) / h;
      const float rn = tr.valid ? clampmin(rho + drho, 1e-4f) : rho;
      rho_buf[1 - cur][i] = rn;
      v[0] += track_objective(a, tr, i, rn, Pn, Fm);
      if (tr.valid) v[1] += drho * (lam * drho - gr);
    }
    reduce2<false>(v, sb, cl);

    // ---- accept / reject, Nielsen's lambda update (every thread alike) ----
    const float F_new = misc[2] != 0.f ? v[0] + misc[0] : __int_as_float(0x7fc00000);
    const float pred = 0.5f * (misc[1] + v[1]);
    const bool accept = (F_new < Fv) && isfinite(F_new);
    const float gain = (Fv - F_new) / clampmin(pred, 1e-20f);
    const float qg = 2.f * gain - 1.f;
    const float lam_acc = lam * clampmin(1.f - qg * qg * qg, 1.f / 3.f);
    if (accept) {
      pc = 1 - pc;
      cur = 1 - cur;
      Fv = F_new;
      lam = lam_acc;
      nu = 2.f;
      for (int p = tid; p < 6 * Fm; p += kThreads) ro[p] = ron[p];
    } else {
      lam = lam * nu;
      nu = nu * 2.f;
    }
  }

  // ---- outputs ----
  for (int k = tid; k < cnt; k += kThreads) a.rho_out[begin + k] = rho_buf[cur][begin + k];
  if (rank == 0) {
    const float* P = sm + lo.pose + 12 * Fm * pc;
    if (tid < 16) a.poses_out[tid] = a.poses[tid];
    for (int p = tid; p < 16 * Fm; p += kThreads) {
      const int f = p / 16, q = p % 16;
      a.poses_out[16 * (f + 1) + q] = q < 12 ? P[12 * f + q] : (q == 15 ? 1.f : 0.f);
    }
    if (tid == 0) a.chi2_out[0] = Fv;
  }
  cl.sync();               // no CTA leaves while another may read its partials
}

size_t smem_bytes(int F) { return (size_t)layout(F).total * sizeof(float); }

}  // namespace

extern "C" {

// Once per library load: let the kernel use the shared memory of the
// largest window.
int window_ba_lm_init() {
  return (int)cudaFuncSetAttribute(window_ba_lm_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem_bytes(kMaxF));
}

int window_ba_lm_max_frames() { return kMaxF; }

// Launch one cluster of `cluster` CTAs (1, 2, 4 or 8) on `stream`.  Returns
// a CUDA error code (0 = launched); a cluster the card cannot schedule is
// the launch's own error.
int window_ba_lm_launch(const float* poses, const float* uv, const uint8_t* alive,
                        const float* depth0, float* poses_out, float* rho_out, float* chi2_out,
                        float* scratch, int F, int n, int cluster, int iters, float fx, float fy,
                        float cx, float cy, float huber, float d2, float w_prior, float tau,
                        float w_odo, void* stream) {
  if (F < 2 || F > kMaxF || n < 1) return (int)cudaErrorInvalidValue;
  if (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) return (int)cudaErrorInvalidValue;
  const Args a{poses, uv, alive, depth0, poses_out, rho_out, chi2_out, scratch, F, n, iters,
               fx, fy, cx, cy, huber, d2, w_prior, tau, w_odo};
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes(F);
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, window_ba_lm_kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
