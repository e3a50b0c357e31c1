// Projection-gated descriptor matching, best / second / index per query (sm_90a).
//
// Replaces the TPU kernel multimot_track_tpu/ops/pallas_match.py ::
// fused_match_projected (kernel body _kernel).  For every query descriptor
// it computes what that kernel computes, without forming the N x M matrix:
//
//   D[j] = hamming(a, b_j)  if valid_a && valid_b[j] && |uv_pred - uv_b[j]|^2 <= r^2
//          1e9              otherwise
//   best = min_j D[j], idx = first argmin, second = min over j != idx
//
// Descriptors arrive in the JAX package's {-1, +1} int8 sign form.  A small
// pre-pass packs them to 8 x uint32 bits (bit = value > 0), so a distance is
// popc of the XOR of 8 words: exact, and no tensor cores needed.
//
// What bounds it on an H100.  At the main path's shapes (3 x 1024 queries
// against 1024 references for TrackLocalMap; 4 x 1024 against 1024 for the
// fuse scan) the work is ~3-4 M candidate pairs of ~20 integer and float
// instructions each, a few microseconds of the card's issue rate, and the
// inputs are ~0.5 MB.  So it is bound by launch latency and by how few
// blocks the grid has (48-64), not by bandwidth or arithmetic.  The TPU
// kernel's 128-query MXU matmul against a resident (256, M) f32 transpose
// has no counterpart here: it moved 32x more bytes per descriptor.
//
// What the design does about it.  One thread per query keeps its 8 words,
// its predicted position and its best / second / index in registers; the
// block stages 64 references at a time (bits, position, flag) in shared
// memory and every thread walks them in ascending index with strict `<`
// updates, which gives lax.top_k's tie order: ties go to the lowest index
// and a tied second equals the best.  The grid is (query tiles, batch L),
// the references are shared by the whole batch, and the ragged last tile is
// masked.  The spatial gate is rounded as du*du + dv*dv with explicit
// __fmul_rn / __fadd_rn so that FMA contraction cannot move a point across
// the radius relative to the plain version.  Plain C ABI, bound with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;      // queries per block; also references per tile
constexpr int kWords = 8;         // 256 bits
constexpr int kBits = 256;
constexpr float kBig = 1e9f;

// bits[r][w] bit i = (desc[r][32 w + i] > 0); one thread per (row, word).
__global__ void pack_signs_kernel(const int8_t* __restrict__ desc, uint32_t* __restrict__ bits,
                                  int rows) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= rows * kWords) return;
  const int8_t* src = desc + (size_t)(t / kWords) * kBits + (t % kWords) * 32;
  uint32_t w = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) w |= (uint32_t)(src[i] > 0) << i;
  bits[t] = w;
}

__global__ void __launch_bounds__(kThreads)
match_projected_kernel(const uint32_t* __restrict__ bits_a, const float2* __restrict__ uv_a,
                       const uint8_t* __restrict__ valid_a, const uint32_t* __restrict__ bits_b,
                       const float2* __restrict__ uv_b, const uint8_t* __restrict__ valid_b,
                       int n, int m, float r2, float* __restrict__ best_out,
                       float* __restrict__ second_out, int* __restrict__ idx_out) {
  __shared__ uint32_t s_bits[kThreads][kWords + 1];   // +1 word: no bank conflicts
  __shared__ float2 s_uv[kThreads];
  __shared__ uint8_t s_valid[kThreads];

  const int q = blockIdx.x * kThreads + threadIdx.x;
  const bool in_range = q < n;
  const size_t row = (size_t)blockIdx.y * n + q;
  uint32_t a[kWords];
  float2 p = make_float2(0.f, 0.f);
  bool ok_a = false;
  if (in_range) {
#pragma unroll
    for (int w = 0; w < kWords; ++w) a[w] = bits_a[row * kWords + w];
    p = uv_a[row];
    ok_a = valid_a[row] != 0;
  } else {
#pragma unroll
    for (int w = 0; w < kWords; ++w) a[w] = 0u;
  }

  float best = kBig, second = kBig;
  int idx = 0;
  for (int t0 = 0; t0 < m; t0 += kThreads) {
    __syncthreads();                   // the previous tile is consumed
    const int j = t0 + threadIdx.x;
    if (j < m) {
#pragma unroll
      for (int w = 0; w < kWords; ++w) s_bits[threadIdx.x][w] = bits_b[(size_t)j * kWords + w];
      s_uv[threadIdx.x] = uv_b[j];
      s_valid[threadIdx.x] = valid_b[j];
    }
    __syncthreads();
    const int cnt = min(kThreads, m - t0);
    for (int k = 0; k < cnt; ++k) {
      const float du = __fsub_rn(p.x, s_uv[k].x);
      const float dv = __fsub_rn(p.y, s_uv[k].y);
      const float d2 = __fadd_rn(__fmul_rn(du, du), __fmul_rn(dv, dv));
      float d = kBig;
      if (ok_a && s_valid[k] && d2 <= r2) {
        int h = 0;
#pragma unroll
        for (int w = 0; w < kWords; ++w) h += __popc(a[w] ^ s_bits[k][w]);
        d = (float)h;
      }
      if (d < best) {
        second = best;
        best = d;
        idx = t0 + k;
      } else if (d < second) {
        second = d;
      }
    }
  }
  if (in_range) {
    best_out[row] = best;
    second_out[row] = second;
    idx_out[row] = idx;
  }
}

int pack(const int8_t* desc, uint32_t* bits, int rows, cudaStream_t stream) {
  if (rows <= 0) return 0;
  const int threads = 256;
  const int blocks = (rows * kWords + threads - 1) / threads;
  pack_signs_kernel<<<blocks, threads, 0, stream>>>(desc, bits, rows);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// l batches of n queries each (desc_a (l*n, 256) int8, uv_a (l*n, 2) f32,
// valid_a (l*n) u8) against one set of m references shared by the batch.
// bits_a (l*n, 8) and bits_b (m, 8) are uint32 scratch.  Outputs (l*n,).
// Launches the two pack passes and the match kernel on `stream`; returns the
// first nonzero cudaGetLastError() (0 = all launched).
int match_projected_launch(const int8_t* desc_a, const float* uv_a, const uint8_t* valid_a,
                           const int8_t* desc_b, const float* uv_b, const uint8_t* valid_b,
                           uint32_t* bits_a, uint32_t* bits_b, int l, int n, int m, float r2,
                           float* best, float* second, int* idx, void* stream) {
  if (l <= 0 || n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  int err = pack(desc_a, bits_a, l * n, s);
  if (err) return err;
  err = pack(desc_b, bits_b, m, s);
  if (err) return err;
  dim3 grid((n + kThreads - 1) / kThreads, l);
  match_projected_kernel<<<grid, kThreads, 0, s>>>(
      bits_a, reinterpret_cast<const float2*>(uv_a), valid_a, bits_b,
      reinterpret_cast<const float2*>(uv_b), valid_b, n, m, r2, best, second, idx);
  return (int)cudaGetLastError();
}

}  // extern "C"
