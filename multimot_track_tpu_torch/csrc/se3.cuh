// SE(3) helpers for the LM kernels, on one thread: the float32 arithmetic of
// geometry/se3.py (its eps terms and small-angle branches), so that a
// kernel's LM trajectory follows the plain solver's step for step.
//
// Rigid transforms are the top three rows of a row-major 4 x 4 matrix,
// 12 floats: R[i][j] at 4 i + j, t[i] at 4 i + 3.  Tangents are
// (omega, upsilon), rotation first.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

// se(3) exp of (omega, upsilon) with geometry/se3.exp_se3's eps terms;
// R row-major 3 x 3, t 3.
__device__ __forceinline__ void exp_se3(const float* xi, float* R, float* t) {
  const float EPS = 1e-8f;
  const float w0 = xi[0], w1 = xi[1], w2 = xi[2];
  const float th2 = w0 * w0 + w1 * w1 + w2 * w2;
  const float th = sqrtf(th2 + EPS * EPS);
  const bool small = th2 < 1e-10f;
  float sn, cs;
  sincosf(th, &sn, &cs);
  const float a = small ? 1.f - th2 / 6.f : sn / th;
  const float b = small ? 0.5f - th2 / 24.f : (1.f - cs) / (th2 + EPS * EPS);
  const float c = small ? 1.f / 6.f - th2 / 120.f : (th - sn) / (th2 * th + EPS);
  const float K[9] = {0.f, -w2, w1, w2, 0.f, -w0, -w1, w0, 0.f};
  float K2[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      K2[i * 3 + j] = K[i * 3] * K[j] + K[i * 3 + 1] * K[3 + j] + K[i * 3 + 2] * K[6 + j];
  float V[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const float e = (k % 4 == 0) ? 1.f : 0.f;
    R[k] = e + a * K[k] + b * K2[k];
    V[k] = e + b * K[k] + c * K2[k];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
    t[i] = V[i * 3] * xi[3] + V[i * 3 + 1] * xi[4] + V[i * 3 + 2] * xi[5];
}

// C = A B for rigid 3 x 4 transforms (C may not alias A or B).
__device__ __forceinline__ void compose34(const float* A, const float* B, float* C) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[4 * i + j] = A[4 * i] * B[j] + A[4 * i + 1] * B[4 + j] + A[4 * i + 2] * B[8 + j];
    C[4 * i + 3] = A[4 * i] * B[3] + A[4 * i + 1] * B[7] + A[4 * i + 2] * B[11] + A[4 * i + 3];
  }
}

// B = A^-1 for a rigid 3 x 4 transform: (R^T, -R^T t).
__device__ __forceinline__ void inverse34(const float* A, float* B) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) B[4 * i + j] = A[4 * j + i];
    B[4 * i + 3] = -(A[i] * A[3] + A[4 + i] * A[7] + A[8 + i] * A[11]);
  }
}

// Ad(T) = [[R, 0], [hat(t) R, R]], row-major 6 x 6.
__device__ __forceinline__ void adjoint34(const float* T, float* Ad) {
  const float t0 = T[3], t1 = T[7], t2 = T[11];
  const float H[9] = {0.f, -t2, t1, t2, 0.f, -t0, -t1, t0, 0.f};
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float r = T[4 * i + j];
      Ad[6 * i + j] = r;
      Ad[6 * i + 3 + j] = 0.f;
      Ad[6 * (3 + i) + 3 + j] = r;
      Ad[6 * (3 + i) + j] =
          H[3 * i] * T[j] + H[3 * i + 1] * T[4 + j] + H[3 * i + 2] * T[8 + j];
    }
}

// se(3) log of a rigid 3 x 4 transform: geometry/se3.log_se3 (inverse
// Rodrigues, then the closed-form inverse left Jacobian on t).
__device__ __forceinline__ void log_se3(const float* T, float* xi) {
  const float EPS2 = 1e-16f;
  const float tr = T[0] + T[5] + T[10];
  const float cos_t = fminf(fmaxf((tr - 1.f) * 0.5f, -1.f), 1.f);
  const bool small = cos_t > 0.999999f;
  const float theta = acosf(small ? 0.f : cos_t);
  const float sin_safe = small ? 1.f : sinf(theta);
  const float scale = small ? 0.5f : theta / (2.f * sin_safe);
  const float w0 = scale * (T[9] - T[6]);
  const float w1 = scale * (T[2] - T[8]);
  const float w2 = scale * (T[4] - T[1]);
  const float th2 = w0 * w0 + w1 * w1 + w2 * w2;
  const float th = sqrtf(th2 + EPS2);
  const bool small2 = th2 < 1e-10f;
  const float denom = small2 ? 1.f : 2.f * th * sinf(th);
  const float c = small2 ? 1.f / 12.f + th2 / 720.f
                         : 1.f / fmaxf(th2, EPS2) - (1.f + cosf(th)) / denom;
  const float K[9] = {0.f, -w2, w1, w2, 0.f, -w0, -w1, w0, 0.f};
  float Vi[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float k2 = K[i * 3] * K[j] + K[i * 3 + 1] * K[3 + j] + K[i * 3 + 2] * K[6 + j];
      Vi[i * 3 + j] = (i == j ? 1.f : 0.f) - 0.5f * K[i * 3 + j] + c * k2;
    }
  xi[0] = w0;
  xi[1] = w1;
  xi[2] = w2;
#pragma unroll
  for (int i = 0; i < 3; ++i)
    xi[3 + i] = Vi[i * 3] * T[3] + Vi[i * 3 + 1] * T[7] + Vi[i * 3 + 2] * T[11];
}

}  // namespace
