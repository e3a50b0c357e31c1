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
// Descriptors arrive in the JAX package's {-1, +1} int8 sign form and are
// packed to 8 x uint32 bits (bit = value > 0) on chip, so a distance is popc
// of the XOR of 8 words: exact, and no tensor cores needed.
//
// What bounds it on an H100.  At the main path's shapes (3072 queries
// against 1024 references for TrackLocalMap, 4 x 1024 against 1024 for the
// fuse scan, 3072 against 3072 for the window tracks) the inputs and
// outputs are ~1-1.6 MB (0.3-0.5 us at the memory rate); the 3-9 M gate
// tests take ~10 instructions each, 1-3 us of the card's issue rate; only
// ~0.15 % of the pairs pass the gate and need a distance.  So it is bound
// by the gate scan's issue rate and by the latency of one launch and of
// its few dependent steps, not by bytes or arithmetic; int8 tensor-core
// products would compute every distance to keep 0.15 % of them.
//
// What the design does about it.
//  - One launch per call and nothing else on the stream: the signs are
//    packed inside the kernel, which writes idx as int64; the wrapper only
//    checks, allocates the outputs and launches.
//  - The L x N queries are one run of rows (the references are shared).  A
//    tile of kQ = 128 queries goes to one thread-block cluster of C CTAs
//    (C from the wrapper's plan, ops/match_cuda.match_plan): CTA rank r
//    owns the contiguous share [r S, r S + S) of the references,
//    S = ceil(M / C), and packs it into shared memory with the positions.
//    kT = 4 consecutive threads work on one query, each scanning a
//    contiguous sub-slice of the CTA's references in ascending order with
//    strict `<` updates.  At the path shapes that is 64-192 CTAs of 16
//    warps on 132 SMs.  More threads per query (8-32, more CTAs) ran
//    slower at every live shape (tools/k2_plan_sweep.py, PERF.md).
//  - Bytes from L2 bound the packing: every cluster reads all M reference
//    descriptors.  So each query is read once per cluster, not once per
//    CTA: rank r packs 1/C of the tile's queries, and after one cluster
//    barrier every thread reads its query's 32 bytes from the rank that
//    packed them (distributed shared memory).  At 3072 x 1024 that is
//    ~7 MB per call instead of ~13.
//  - Packing without ballots: a lane loads 16 bytes of a descriptor, tests
//    4 bytes at a time for > 0 with three integer operations and folds the
//    16 results into 16 bits; two lanes make one 32-bit word.  The bits are
//    permuted the same way for queries and references, so popc(a ^ b) is
//    the Hamming distance.
//  - The gate is tested kChunk references at a time, independent of each
//    other, into a bit mask; only the ~0.15 % of pairs that pass take their
//    distance, in ascending order.
//  - Validity is folded into the positions: an invalid query or reference
//    gets NaN coordinates, whose gate test is false, as the plain version's
//    flag test is.  A gated-out pair would enter the scan as 1e9, which
//    never passes a strict `<` against a best and second that start at 1e9,
//    so it is skipped.  The gate is rounded as du*du + dv*dv with explicit
//    __fsub_rn / __fmul_rn / __fadd_rn, so that FMA contraction cannot move
//    a point across the radius relative to the plain version.
//  - A share larger than kSlots references is walked in tiles of kSlots;
//    each tile is cut into kT contiguous sub-slices of at most 128.
//  - Exact merge in fixed order, lower slice P1 with higher slice P2: if
//    P2.best < P1.best the result is (P2.best, P2.idx, min(P2.second,
//    P1.best)), else (P1.best, P1.idx, min(P1.second, P2.best)).  A slice
//    with no references reports (+inf, 0, +inf) and never wins; a slice
//    whose candidates are all gated out reports (1e9, its first index, 1e9),
//    so a row with nothing gated ends at (1e9, 1e9, 0) as the plain version
//    gives.  Order: the kT sub-slices of a tile by a shuffle butterfly, the
//    tiles in order, then the C CTAs' partials in rank order: the rank that
//    packed a query merges and writes it, and the other CTAs store their
//    partials into its shared memory (one 16-byte store each) before the
//    second cluster barrier.  No atomics: two launches give the same bits.
// Plain C ABI, bound with ctypes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;     // threads per CTA (ops/match_cuda.py THREADS)
constexpr int kSlots = 512;       // references a CTA stages per tile (SLOTS)
constexpr int kT = 4;             // threads per query (THREADS_PER_QUERY)
constexpr int kQ = kThreads / kT;  // queries per cluster
constexpr int kMaxCluster = 8;
constexpr int kBits = 256;       // descriptor bytes
constexpr int kBatch = 8;         // 16-byte loads a lane has in flight while packing
constexpr int kChunk = 8;         // gate tests issued together
constexpr float kBig = 1e9f;

struct Args {
  const int8_t* desc_a;    // (rows, 256), all inputs contiguous
  const float2* uv_a;      // (rows,)
  const uint8_t* valid_a;  // (rows,) bool
  const int8_t* desc_b;    // (m, 256)
  const float2* uv_b;      // (m,)
  const uint8_t* valid_b;  // (m,) bool
  float* best;             // (rows,)
  float* second;           // (rows,)
  long long* idx;          // (rows,) int64
  int rows, m;
  float r2;
};

struct Best {
  float best, second;
  int idx;
};

// The union of a lower slice `lo` and the next higher slice `hi`.
__device__ __forceinline__ Best merge(const Best& lo, const Best& hi) {
  if (hi.best < lo.best) return {hi.best, fminf(hi.second, lo.best), hi.idx};
  return {lo.best, fminf(lo.second, hi.best), lo.idx};
}

// Bit 8 e + 7 is set iff byte e of x, a signed value, is > 0 (1..127):
// its low 7 bits are not all 0 and its sign bit is clear.
__device__ __forceinline__ uint32_t positive_bytes(uint32_t x) {
  return ((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) & ~x & 0x80808080u;
}

// Pack n0 descriptors, rows first0.. of src0, into dst0[i], and then n1
// more from src1 into dst1 (8 words as two uint4; rows 16-byte aligned),
// all loads of a warp's batch in flight together.  A warp takes
// two rows per 16-byte load: lane l reads bytes [16 (l % 16), +16) of row
// 2 j + l / 16, folds their 16 sign tests into bits {0..3} + 8 e, and each
// even lane ORs in its odd neighbour's bits at {4..7} + 8 e: word w covers
// bytes [32 w, 32 w + 32).  Every descriptor's bits are permuted the same
// way, so popc(a ^ b) is the Hamming distance.
__device__ __forceinline__ void pack(const int8_t* __restrict__ src0, int first0, int n0,
                                     uint4 (*dst0)[2], const int8_t* __restrict__ src1,
                                     int first1, int n1, uint4 (*dst1)[2]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, half = lane >> 4, i = lane & 15;
  constexpr int kWarps = kThreads / 32, kRows = 2 * kBatch;
  const int n = n0 + n1;
  for (int r0 = warp * kRows; r0 < n; r0 += kWarps * kRows) {     // warp-uniform
    uint4 v[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int r = r0 + 2 * b + half;
      const int8_t* row = r < n0 ? src0 + (long long)(first0 + r) * kBits
                                 : src1 + (long long)(first1 + r - n0) * kBits;
      v[b] = r < n ? *reinterpret_cast<const uint4*>(row + 16 * i) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const uint32_t bits = positive_bytes(v[b].x) >> 7 | positive_bytes(v[b].y) >> 6 |
                            positive_bytes(v[b].z) >> 5 | positive_bytes(v[b].w) >> 4;
      const uint32_t word = bits | __shfl_down_sync(0xffffffffu, bits, 1) << 4;
      const int r = r0 + 2 * b + half;
      if (!(i & 1) && r < n)
        reinterpret_cast<uint32_t*>(r < n0 ? dst0[r] : dst1[r - n0])[i >> 1] = word;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2) match_projected_kernel(const Args a) {
  __shared__ uint4 s_bits[kSlots][2];         // a tile's references, packed
  __shared__ float2 s_uv[kSlots + kT + kChunk];  // their positions (NaN: invalid); sub-slice t at offset t
  __shared__ uint4 s_q[kQ][2];                // this rank's share of the tile's queries, packed
  __shared__ float4 s_part[kQ + kMaxCluster];  // [rank][query] partials of the queries this CTA writes

  cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const int q0 = (int)(blockIdx.x / C) * kQ;  // clusters are consecutive blocks
  const int nq = min(kQ, a.rows - q0);
  const int qi = threadIdx.x / kT, t = threadIdx.x % kT, lane = threadIdx.x & 31;
  const int per = (kQ + C - 1) / C;           // queries each rank packs, merges and writes
  const float nan = __int_as_float(0x7fc00000);

  float2 p = make_float2(nan, nan);
  if (qi < nq) {
    const long long row = q0 + qi;
    const bool ok_a = a.valid_a[row] != 0;
    const float2 uv = a.uv_a[row];
    if (ok_a) p = uv;
  }
  const int S = (a.m + C - 1) / C;
  const int b0 = min(rank * S, a.m), b1 = min(b0 + S, a.m);
  const int q_first = min(rank * per, nq), q_n = min(per, nq - q_first);
  uint32_t qa[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
  Best acc = {INFINITY, INFINITY, 0};
  // the first tile, even of an empty share, packs this rank's queries
  for (int j0 = b0; j0 < b1 || j0 == b0; j0 += kSlots) {
    const int n = min(kSlots, b1 - j0);
    const int len = max((n + kT - 1) / kT, 1);  // sub-slice t: [t len, t len + len) of the tile
    if (j0 > b0) __syncthreads();             // the previous tile is consumed
    const bool mine = (int)threadIdx.x < n;   // kSlots == kThreads: one reference a thread
    float2 u = make_float2(nan, nan);
    bool ok_b = false;
    if (mine) {
      const long long j = j0 + threadIdx.x;
      ok_b = a.valid_b[j] != 0;
      u = a.uv_b[j];
    }
    pack(a.desc_a, q0 + q_first, j0 == b0 ? q_n : 0, s_q, a.desc_b, j0, n, s_bits);
    if (mine) s_uv[threadIdx.x + threadIdx.x / len] = ok_b ? u : make_float2(nan, nan);
    if (j0 == b0) {
      // every rank's queries packed, and every CTA of the cluster started
      cl.sync();
      const int owner = qi / per;
      const uint4* w = *cl.map_shared_rank(&s_q[qi - owner * per], owner);
      const uint4 w0 = w[0], w1 = w[1];
      qa[0] = w0.x; qa[1] = w0.y; qa[2] = w0.z; qa[3] = w0.w;
      qa[4] = w1.x; qa[5] = w1.y; qa[6] = w1.z; qa[7] = w1.w;
    } else {
      __syncthreads();
    }
    const int k0 = min(t * len, n), k1 = min(k0 + len, n);
    Best v = {INFINITY, INFINITY, 0};
    if (k0 < k1) v = {kBig, kBig, j0 + k0};
    // kChunk independent gate tests, then the few hits in ascending order
    for (int k = k0; k < k1; k += kChunk) {
      uint32_t hits = 0u;
#pragma unroll
      for (int e = 0; e < kChunk; ++e) {
        const float2 ub = s_uv[k + e + t];
        const float du = __fsub_rn(p.x, ub.x);
        const float dv = __fsub_rn(p.y, ub.y);
        const float d2 = __fadd_rn(__fmul_rn(du, du), __fmul_rn(dv, dv));
        hits |= (uint32_t)(k + e < k1 && d2 <= a.r2) << e;
      }
      while (hits) {
        const int kk = k + __ffs(hits) - 1;
        hits &= hits - 1u;
        const uint4 w0 = s_bits[kk][0], w1 = s_bits[kk][1];
        const int h = __popc(qa[0] ^ w0.x) + __popc(qa[1] ^ w0.y) + __popc(qa[2] ^ w0.z) +
                      __popc(qa[3] ^ w0.w) + __popc(qa[4] ^ w1.x) + __popc(qa[5] ^ w1.y) +
                      __popc(qa[6] ^ w1.z) + __popc(qa[7] ^ w1.w);
        const float d = (float)h;
        if (d < v.best) {
          v.second = v.best;
          v.best = d;
          v.idx = j0 + kk;
        } else if (d < v.second) {
          v.second = d;
        }
      }
    }
    // the kT sub-slices of the tile, lower lanes holding lower slices; every
    // lane of the group ends with the same result
#pragma unroll
    for (int off = 1; off < kT; off <<= 1) {
      const Best o = {__shfl_xor_sync(0xffffffffu, v.best, off),
                      __shfl_xor_sync(0xffffffffu, v.second, off),
                      __shfl_xor_sync(0xffffffffu, v.idx, off)};
      v = (lane & off) ? merge(o, v) : merge(v, o);
    }
    acc = merge(acc, v);
  }
  // rank r merges and writes its queries: every CTA stores its partial of
  // such a query into rank r's shared memory, then one cluster barrier, and
  // no CTA touches another's memory after it
  if (t == 0) {
    const int owner = qi / per;
    *cl.map_shared_rank(&s_part[rank * per + qi - owner * per], owner) =
        make_float4(acc.best, acc.second, __int_as_float(acc.idx), 0.f);
  }
  cl.sync();
  if ((int)threadIdx.x < q_n) {
    float4 f = s_part[threadIdx.x];
    Best v = {f.x, f.y, __float_as_int(f.z)};
    for (int r = 1; r < C; ++r) {
      f = s_part[r * per + threadIdx.x];
      v = merge(v, {f.x, f.y, __float_as_int(f.z)});
    }
    const int q = q0 + q_first + (int)threadIdx.x;
    a.best[q] = v.best;
    a.second[q] = v.second;
    a.idx[q] = (long long)v.idx;
  }
}

// The same grid and clusters doing nothing: the floor one launch costs.
__global__ void __launch_bounds__(kThreads) empty_kernel() {}

cudaLaunchConfig_t config(cudaLaunchAttribute* attr, int rows, int cluster, cudaStream_t stream) {
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((rows + kQ - 1) / kQ) * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

bool valid_cluster(int cluster) { return cluster >= 1 && cluster <= kMaxCluster; }

}  // namespace

extern "C" {

// The kernel's fixed shape, for the wrapper to check its plan against.
void match_projected_shape(int* threads, int* slots, int* per_query) {
  *threads = kThreads;
  *slots = kSlots;
  *per_query = kT;
}

// Clusters of `cluster` CTAs the card can hold at once (0: it cannot
// schedule one), or -1 on an error.
int match_projected_max_clusters(int cluster) {
  if (!valid_cluster(cluster)) return -1;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config(attr, kQ, cluster, 0);
  int n = 0;
  return cudaOccupancyMaxActiveClusters(&n, match_projected_kernel, &cfg) == cudaSuccess ? n : -1;
}

// `rows` queries (desc_a (rows, 256) int8, uv_a (rows, 2) f32, valid_a
// (rows,) u8) against `m` >= 1 references (desc_b, uv_b, valid_b
// likewise); outputs (rows,) best, second (f32) and idx (int64).  All
// contiguous; descriptors 16-byte aligned, positions 8-byte.  One launch of
// ceil(rows / 128) clusters of `cluster` CTAs (1..8) on `stream`.  Returns
// a CUDA error code (0 = launched, or nothing to do); a cluster the card
// cannot schedule is the launch's own error.
int match_projected_launch(const int8_t* desc_a, const float* uv_a, const uint8_t* valid_a,
                           const int8_t* desc_b, const float* uv_b, const uint8_t* valid_b,
                           float* best, float* second, long long* idx, int rows, int m,
                           int cluster, float r2, void* stream) {
  if (rows <= 0) return 0;
  if (m < 1 || !valid_cluster(cluster)) return (int)cudaErrorInvalidValue;
  const Args a{desc_a, reinterpret_cast<const float2*>(uv_a), valid_a, desc_b,
               reinterpret_cast<const float2*>(uv_b), valid_b, best, second, idx, rows, m, r2};
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config(attr, rows, cluster, (cudaStream_t)stream);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, match_projected_kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The empty kernel on the grid match_projected_launch would use.
int match_projected_empty_launch(int rows, int cluster, void* stream) {
  if (rows <= 0 || !valid_cluster(cluster)) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config(attr, rows, cluster, (cudaStream_t)stream);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, empty_kernel);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
