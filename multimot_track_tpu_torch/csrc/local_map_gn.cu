// TrackLocalMap's stereo Gauss-Newton, one CTA per local-map call (sm_90a).
//
// Replaces no TPU kernel: the JAX package runs the local map's
// _gn_refine_stereo rounds as an XLA fori_loop.  The port's plain version
// (pipeline/keyframes.local_map_gn) runs them as a Python loop of eager ops,
// ~10,500 small launches and 32 host syncs a call, and the host's time per
// launch, not the card, set its pace.  This kernel runs the whole schedule
// in one launch, in float32:
//
//   rounds x { Huber weights at the round's start pose, iters GN steps }
//   rounds x { inlier weights at the round's start pose, iters GN steps }
//   the inlier count at the final pose
//
// on the stereo residual r = (u, v, bf / max(z, 1e-6) - disp) of every map
// point, rows weighted (w, w, w w_disp).  A step sums H = sum Jw^T J + 1e-6 I
// and g = sum Jw^T r, solves H delta = -g by geometry/smallsolve's unrolled
// Cholesky (diagonal clamped at 1e-30) and composes T <- exp(delta) T.  The
// Huber weight is mf min(thresh / max(|d|, 1e-6), 1) (z > 0) with d the
// pixel residual; the inlier weight is (matched & |d| < thresh & z > 0).
//
// What bounds it on an H100.  At the live shape (M = 3072 map points, 2 + 2
// rounds of 8 steps) the algorithm needs ~250 flops a point a step (the
// transform, the residual, the 3 x 6 Jacobian, the 21 + 6 products of each
// of its 3 rows, the round's weight), ~25 MFLOP a call: ~0.4 us of the fp32
// peak, and ~90 KB of inputs.  But the 32 steps are a strict chain: a pass
// over the points, a block-wide reduction of 27 sums, a 6 x 6 Cholesky and
// an exp on one thread, the pose broadcast to every thread.  Latency, not
// operations or bytes, sets the pace.
//
// What the design does about it.
//  - One CTA of 1024 threads, so the chain never leaves the SM and a
//    barrier is the only wait between its links.  Thread j owns points j,
//    j + 1024, ...: any M, M = 0 too.
//  - The points are read from device memory once, into shared memory (up
//    to kCap of them, field by field so that a warp's reads are
//    conflict-free); the few beyond the cap are read from device memory,
//    L2-resident, on each pass.
//  - A round's weights are recomputed on each pass from the round's start
//    pose (a transform and a projection a point) rather than stored, so
//    nothing a point needs outlives its pass but the inputs.
//  - Fixed-order reductions, no atomics: each thread sums its points in
//    order, a warp reduce-scatter (31 shuffles) leaves lane k with the
//    warp's sum k, and warp 0 adds the 32 warp partials in warp order.  Two
//    launches on the same inputs give the same bits.
//  - Thread 0 factors, solves, takes the exp and composes; the pose reaches
//    every thread through shared memory at the step's closing barrier.
//
// Numerics follow the plain version: 1/(z + 1e-9) in the projection,
// 1/max(z, 1e-6) in the Jacobian and the disparity, clamps that pass NaN on
// as torch.clamp does, the lower triangle of H as the plain Cholesky reads
// it.  The bottom row of the written pose is (0, 0, 0, 1).  Plain C ABI,
// bound with ctypes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "se3.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 27;          // 21 lower-triangle entries of H, then 6 of g
constexpr int kFields = 8;         // X (3), u, v, disparity, disparity weight, matched
constexpr int kCap = 4096;         // points held in shared memory (128 KB)

struct Args {
  const float* T_init;      // (4, 4) Tcw
  const float* Xw;          // (M, 3) local map points, world frame
  const float* uv;          // (M, 2) matched keypoints
  const float* disp;        // (M,) measured disparity
  const float* w_disp;      // (M,) disparity row weight
  const uint8_t* matched;   // (M,) bool
  float* T_out;             // (4, 4)
  long long* n_out;         // () inliers at T_out
  int M, iters, rounds;
  float fx, fy, cx, cy, bf, thresh;
};

struct Point {
  float X[3], u, v, disp, wd, mf;
};

// torch.clamp's min and max: NaN passes (fmaxf and fminf would drop it)
__device__ __forceinline__ float clampmin(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float clampmax(float x, float hi) { return x > hi ? hi : x; }

// Point i: from shared memory below the cap, else from device memory.
__device__ __forceinline__ Point fetch(const Args& a, const float* sp, int cap, int i) {
  Point p;
  if (i < cap) {
    p.X[0] = sp[i];
    p.X[1] = sp[cap + i];
    p.X[2] = sp[2 * cap + i];
    p.u = sp[3 * cap + i];
    p.v = sp[4 * cap + i];
    p.disp = sp[5 * cap + i];
    p.wd = sp[6 * cap + i];
    p.mf = sp[7 * cap + i];
  } else {
    p.X[0] = a.Xw[3 * i];
    p.X[1] = a.Xw[3 * i + 1];
    p.X[2] = a.Xw[3 * i + 2];
    p.u = a.uv[2 * i];
    p.v = a.uv[2 * i + 1];
    p.disp = a.disp[i];
    p.wd = a.w_disp[i];
    p.mf = a.matched[i] ? 1.f : 0.f;
  }
  return p;
}

// y = T X (geometry/se3.transform)
__device__ __forceinline__ void transform(const float* T, const float* X, float* y) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    y[i] = T[4 * i] * X[0] + T[4 * i + 1] * X[1] + T[4 * i + 2] * X[2] + T[4 * i + 3];
}

// The pixel residual project(y) - (u, v) (geometry/camera.project).
__device__ __forceinline__ void pixel_residual(const Args& a, const float* y, const Point& p,
                                               float& du, float& dv) {
  const float inv_z = 1.f / (y[2] + 1e-9f);
  du = a.fx * y[0] * inv_z + a.cx - p.u;
  dv = a.fy * y[1] * inv_z + a.cy - p.v;
}

// Point p's weight at the round's start pose Tw: Huber's, or the inlier
// indicator (which is also what the final count counts).
__device__ __forceinline__ float weight(const Args& a, const float* Tw, bool huber,
                                        const Point& p) {
  float y[3];
  transform(Tw, p.X, y);
  float du, dv;
  pixel_residual(a, y, p, du, dv);
  const float r = sqrtf(du * du + dv * dv);
  if (huber)
    return p.mf * clampmax(a.thresh / clampmin(r, 1e-6f), 1.f) * (y[2] > 0.f ? 1.f : 0.f);
  return (p.mf != 0.f && r < a.thresh && y[2] > 0.f) ? 1.f : 0.f;
}

// Add point p's weighted rows at pose T to the 21 + 6 sums: the Jacobian is
// camera.project_jacobian(y, fx, fy, bf) @ se3.point_jacobian(y), written
// out entry by entry.
__device__ __forceinline__ void accumulate(const Args& a, const float* T, const Point& p,
                                           float w, float (&acc)[32]) {
  float y[3];
  transform(T, p.X, y);
  float du, dv;
  pixel_residual(a, y, p, du, dv);
  const float zc = clampmin(y[2], 1e-6f);
  const float iz = 1.f / zc;
  const float r[3] = {du, dv, a.bf / zc - p.disp};
  const float A = a.fx * iz, B = a.fy * iz;
  const float C = -a.fx * y[0] * iz * iz, D = -a.fy * y[1] * iz * iz, E = -a.bf * iz * iz;
  const float J[3][6] = {{C * y[1], A * y[2] - C * y[0], -A * y[1], A, 0.f, C},
                         {D * y[1] - B * y[2], -D * y[0], B * y[0], 0.f, B, D},
                         {E * y[1], -E * y[0], 0.f, 0.f, 0.f, E}};
  const float wr[3] = {w, w, w * p.wd};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float Jw[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) Jw[i] = J[k][i] * wr[k];
    int q = 0;
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int j = 0; j <= i; ++j) acc[q++] += Jw[i] * J[k][j];
#pragma unroll
    for (int i = 0; i < 6; ++i) acc[21 + i] += Jw[i] * r[k];
  }
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

// H delta = -g by smallsolve.solve_spd's unrolled Cholesky (the diagonal
// clamped at 1e-30), then T <- exp(delta) T.  tot: H's lower triangle row
// by row, then g.
__device__ void solve_and_update(const float* tot, float* T) {
  float L[6][6];
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = tot[i * (i + 1) / 2 + j] + (i == j ? 1e-6f : 0.f);
#pragma unroll
      for (int k = 0; k < j; ++k) s = s - L[i][k] * L[j][k];
      L[i][j] = i == j ? sqrtf(clampmin(s, 1e-30f)) : s / L[j][j];
    }
  float y[6], x[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = -tot[21 + i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s = s - L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
  float R[9], t[3];
  exp_se3(x, R, t);
  const float Ex[12] = {R[0], R[1], R[2], t[0], R[3], R[4], R[5], t[1], R[6], R[7], R[8], t[2]};
  float Tn[12];
  compose34(Ex, T, Tn);
#pragma unroll
  for (int q = 0; q < 12; ++q) T[q] = Tn[q];
}

__global__ void __launch_bounds__(kThreads, 1) local_map_gn_kernel(const Args a) {
  extern __shared__ float sp[];             // kFields planes of cap points
  __shared__ float T[12], Tw[12];           // the pose, the round's start pose (3 x 4)
  __shared__ float part[kWarps][kSums];
  __shared__ float tot[kSums];
  __shared__ int cnt[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int M = a.M, cap = min(M, kCap);

  for (int i = tid; i < cap; i += kThreads) {
    sp[i] = a.Xw[3 * i];
    sp[cap + i] = a.Xw[3 * i + 1];
    sp[2 * cap + i] = a.Xw[3 * i + 2];
    sp[3 * cap + i] = a.uv[2 * i];
    sp[4 * cap + i] = a.uv[2 * i + 1];
    sp[5 * cap + i] = a.disp[i];
    sp[6 * cap + i] = a.w_disp[i];
    sp[7 * cap + i] = a.matched[i] ? 1.f : 0.f;
  }
  if (tid < 12) T[tid] = a.T_init[tid];
  __syncthreads();

  for (int phase = 0; phase < 2; ++phase) {          // Huber rounds, then inlier rounds
    for (int round = 0; round < a.rounds; ++round) {
      if (tid < 12) Tw[tid] = T[tid];
      __syncthreads();
      for (int it = 0; it < a.iters; ++it) {
        float acc[32];
#pragma unroll
        for (int q = 0; q < 32; ++q) acc[q] = 0.f;
        for (int i = tid; i < M; i += kThreads) {
          const Point p = fetch(a, sp, cap, i);
          accumulate(a, T, p, weight(a, Tw, phase == 0, p), acc);
        }
        scatter_step<16>(acc, lane);
        scatter_step<8>(acc, lane);
        scatter_step<4>(acc, lane);
        scatter_step<2>(acc, lane);
        scatter_step<1>(acc, lane);
        if (lane < kSums) part[warp][lane] = acc[0];   // lane k holds the warp's sum k
        __syncthreads();
        if (warp == 0) {
          if (lane < kSums) {
            float s = part[0][lane];
            for (int w = 1; w < kWarps; ++w) s += part[w][lane];
            tot[lane] = s;
          }
          __syncwarp();
          if (lane == 0) solve_and_update(tot, T);
        }
        __syncthreads();
      }
    }
  }

  // the inlier count at the final pose
  int c = 0;
  for (int i = tid; i < M; i += kThreads) c += weight(a, T, false, fetch(a, sp, cap, i)) != 0.f;
  c = __reduce_add_sync(0xffffffffu, c);
  if (lane == 0) cnt[warp] = c;
  __syncthreads();
  if (tid == 0) {
    long long n = 0;
    for (int w = 0; w < kWarps; ++w) n += cnt[w];
    *a.n_out = n;
  }
  if (tid < 16) a.T_out[tid] = tid < 12 ? T[tid] : (tid == 15 ? 1.f : 0.f);
}

}  // namespace

extern "C" {

// Once per library load: let the kernel use the shared memory of kCap points.
int local_map_gn_init() {
  return (int)cudaFuncSetAttribute(local_map_gn_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)(kFields * kCap * sizeof(float)));
}

// Launch one CTA on `stream`.  Returns a CUDA error code (0 = launched).
int local_map_gn_launch(const float* T_init, const float* Xw, const float* uv, const float* disp,
                        const float* w_disp, const uint8_t* matched, float* T_out,
                        long long* n_out, int M, int iters, int rounds, float fx, float fy,
                        float cx, float cy, float bf, float thresh, void* stream) {
  if (M < 0 || iters < 0 || rounds < 0) return (int)cudaErrorInvalidValue;
  const Args a{T_init, Xw, uv, disp, w_disp, matched, T_out, n_out, M, iters, rounds,
               fx, fy, cx, cy, bf, thresh};
  const size_t smem = (size_t)kFields * (M < kCap ? M : kCap) * sizeof(float);
  local_map_gn_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
