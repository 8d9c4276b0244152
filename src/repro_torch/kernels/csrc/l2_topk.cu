// Fused squared-L2 distance tiles + running per-row top-k against ONE shared
// database, for Hopper (sm_90a). Computes, per query row, the k smallest of
// x_sqnorm - 2 q.x (the wrapper adds ||q||^2 or the SQ8 bias afterwards).
// The B x N distance matrix never reaches device memory.
//
// Replaces: src/repro/kernels/l2_topk.py::_l2_topk_kernel
//           (launched by l2_topk_padded; ops.l2_topk).
//
// What bounds it on the H100: operations. At the fit's ground truth
// (B = 10k queries, N = 1M rows, D = 128) it does 2*B*N*D = 2.6e15 f32
// flops against 0.5 GB of database: ~5000 flops per byte, far above the
// ridge. Products stay f32 x f32 on the CUDA cores (67 TFLOP/s peak), as
// the reference multiplies f32 by f32 with f32 accumulation; TF32 tensor
// cores would be a later, separately-toleranced choice.
//
// What the design does about it:
//  * Register-blocked SIMT GEMM: a block owns BQ = 64 queries x BN = 128
//    database rows; each of 256 threads accumulates a 4 x 8 tile, fed by
//    float4 reads from shared memory. The database tile is read once per
//    64 queries instead of once per query.
//  * The TPU walks the database axis in sequence and carries the top-k in
//    its output block. Here a loop inside the block walks a contiguous
//    range of database tiles, keeping each query's running top-k in shared
//    memory. To fill 132 SMs when B is small, the database is split into
//    `nsplit` ranges over grid.y and a second kernel merges the per-range
//    lists in range order.
//  * The merge after each tile: a lane-parallel filter against the current
//    k-th distance, then ordered insertion of the survivors at position
//    #(entries <= d). Candidates arrive in ascending row order, so a tie
//    keeps the lower row first, as lax.top_k does.
//  * Rows past N count as +inf and never enter; list slots never filled
//    stay (+inf, -1), the reference kernel's initial running top-k.
//  * Database codes may be f32, bf16 or int8 (widened to f32 when staged).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64, BN = 128, BD = 16, kThreads = 256, kMaxK = 64;
constexpr int SQ = BQ + 4, SX = BN + 4;  // padded staging rows
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// See bucket_probe.cu: insert at #(entries <= d) into a list of K <= 64.
__device__ __forceinline__ void warp_insert(float* ld, int* li, int K,
                                            float d, int id, int lane) {
  const bool ha = lane < K, hb = lane + 32 < K;
  const float a = ha ? ld[lane] : 0.f;
  const float b = hb ? ld[lane + 32] : 0.f;
  const int ia = ha ? li[lane] : 0;
  const int ib = hb ? li[lane + 32] : 0;
  const int pos = __popc(__ballot_sync(kFull, ha && a <= d)) +
                  __popc(__ballot_sync(kFull, hb && b <= d));
  if (pos >= K) return;
  __syncwarp();
  if (lane >= pos && lane + 1 < K) { ld[lane + 1] = a; li[lane + 1] = ia; }
  if (lane + 32 >= pos && lane + 33 < K) { ld[lane + 33] = b; li[lane + 33] = ib; }
  __syncwarp();
  if (lane == 0) { ld[pos] = d; li[pos] = id; }
  __syncwarp();
}

size_t tile_smem_floats() {
  const size_t staging = BD * SQ + BD * SX;
  const size_t dist = BQ * BN;
  return staging > dist ? staging : dist;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
l2_topk_kernel(const float* __restrict__ q, const T* __restrict__ x,
               const float* __restrict__ xsq, float* __restrict__ out_d,
               int* __restrict__ out_i, int B, int N, int D, int K,
               int rows_per_split, int tile_floats) {
  extern __shared__ float smem[];
  float* sq = smem;                 // [BD][SQ] staging (GEMM phase)
  float* sx = smem + BD * SQ;       // [BD][SX]
  float* dist = smem;               // [BQ][BN] (merge phase; aliases staging)
  float* ld = smem + tile_floats;   // [BQ][K] running top-k
  int* li = reinterpret_cast<int*>(ld + BQ * K);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = tid / 16, tx = tid % 16;
  const int qb = blockIdx.x * BQ;
  const int split = blockIdx.y;
  const int n_lo = split * rows_per_split;
  const int n_hi = min(N, n_lo + rows_per_split);

  for (int e = tid; e < BQ * K; e += kThreads) { ld[e] = inf_f(); li[e] = -1; }

  for (int n0 = n_lo; n0 < n_hi; n0 += BN) {
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int d0 = 0; d0 < D; d0 += BD) {
      __syncthreads();  // the previous readers of the staging / dist tile are done
      for (int e = tid; e < BQ * BD; e += kThreads) {
        const int r = e / BD, c = e % BD, gq = qb + r, gd = d0 + c;
        sq[c * SQ + r] = (gq < B && gd < D) ? q[(long long)gq * D + gd] : 0.f;
      }
      for (int e = tid; e < BN * BD; e += kThreads) {
        const int r = e / BD, c = e % BD, gn = n0 + r, gd = d0 + c;
        sx[c * SX + r] = (gn < n_hi && gd < D) ? to_f(x[(long long)gn * D + gd]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BD; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(sq + kk * SQ + ty * 4);
        const float4 b0 = *reinterpret_cast<const float4*>(sx + kk * SX + tx * 4);
        const float4 b1 = *reinterpret_cast<const float4*>(sx + kk * SX + 64 + tx * 4);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();  // staging reads done before dist overwrites it
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int gn = n0 + h * 64 + tx * 4 + j;
          v[j] = gn < n_hi ? xsq[gn] - 2.f * acc[i][h * 4 + j] : inf_f();
        }
        *reinterpret_cast<float4*>(dist + (ty * 4 + i) * BN + h * 64 + tx * 4) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    }
    __syncthreads();
    // Warp w merges queries 8w .. 8w+7; candidates in ascending row order.
    for (int qq = 0; qq < BQ / 8; ++qq) {
      const int ql = warp * (BQ / 8) + qq;
      if (qb + ql >= B) break;  // uniform across the warp
      float* L = ld + ql * K;
      int* I = li + ql * K;
      for (int c = 0; c < BN; c += 32) {
        const float d = dist[ql * BN + c + lane];
        unsigned m = __ballot_sync(kFull, d < L[K - 1]);
        while (m) {
          const int src = __ffs(m) - 1;
          m &= m - 1;
          warp_insert(L, I, K, __shfl_sync(kFull, d, src), n0 + c + src, lane);
        }
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < BQ * K; e += kThreads) {
    const int ql = e / K, j = e % K, gq = qb + ql;
    if (gq < B) {
      const long long at = ((long long)split * B + gq) * K + j;
      out_d[at] = ld[e];
      out_i[at] = li[e];
    }
  }
}

// One warp per query: merge the nsplit ascending lists [nsplit, B, K] in
// range order (range s holds only rows below range s+1's).
__global__ void __launch_bounds__(kThreads)
l2_merge_kernel(const float* __restrict__ part_d, const int* __restrict__ part_i,
                float* __restrict__ out_d, int* __restrict__ out_i, int B, int K,
                int nsplit) {
  __shared__ float lds[kThreads / 32][kMaxK];
  __shared__ int lis[kThreads / 32][kMaxK];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (kThreads / 32) + warp;
  if (b >= B) return;  // whole warp
  float* L = lds[warp];
  int* I = lis[warp];
  for (int j = lane; j < K; j += 32) { L[j] = inf_f(); I[j] = -1; }
  __syncwarp();
  for (int s = 0; s < nsplit; ++s) {
    for (int c = 0; c < K; c += 32) {
      const long long at = ((long long)s * B + b) * K + c + lane;
      const bool ok = c + lane < K;
      const float d = ok ? part_d[at] : inf_f();
      const int id = ok ? part_i[at] : -1;
      unsigned m = __ballot_sync(kFull, d < L[K - 1]);
      while (m) {
        const int src = __ffs(m) - 1;
        m &= m - 1;
        warp_insert(L, I, K, __shfl_sync(kFull, d, src), __shfl_sync(kFull, id, src),
                    lane);
      }
    }
  }
  for (int j = lane; j < K; j += 32) {
    out_d[(long long)b * K + j] = L[j];
    out_i[(long long)b * K + j] = I[j];
  }
}

template <typename T>
cudaError_t launch(const float* q, const void* x, const float* xsq, float* out_d,
                   int* out_i, float* part_d, int* part_i, int B, int N, int D, int K,
                   int nsplit, cudaStream_t stream) {
  const int tile_floats = static_cast<int>(tile_smem_floats());
  const size_t smem = sizeof(float) * tile_floats + (sizeof(float) + sizeof(int)) * BQ * K;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(l2_topk_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int tiles = (N + BN - 1) / BN;
  const int rows_per_split = (tiles + nsplit - 1) / nsplit * BN;
  const dim3 grid((B + BQ - 1) / BQ, nsplit);
  float* td = nsplit > 1 ? part_d : out_d;
  int* ti = nsplit > 1 ? part_i : out_i;
  l2_topk_kernel<T><<<grid, kThreads, smem, stream>>>(
      q, static_cast<const T*>(x), xsq, td, ti, B, N, D, K, rows_per_split, tile_floats);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || nsplit == 1) return e;
  const int per_block = kThreads / 32;
  l2_merge_kernel<<<(B + per_block - 1) / per_block, kThreads, 0, stream>>>(
      part_d, part_i, out_d, out_i, B, K, nsplit);
  return cudaGetLastError();
}

}  // namespace

// x_dtype: 0 float32, 1 bfloat16, 2 int8. nsplit: database ranges over
// grid.y (an empty range yields an all-(+inf, -1) list, which the merge
// ignores). part_d/part_i: [nsplit, B, K] scratch, unused when nsplit == 1.
// Returns cudaGetLastError() after the launches.
extern "C" int l2_topk_launch(const float* q, const void* x, int x_dtype,
                              const float* xsq, float* out_d, int* out_i,
                              float* part_d, int* part_i, int B, int N, int D,
                              int K, int nsplit, cudaStream_t stream) {
  if (B <= 0) return 0;
  if (K < 1 || K > kMaxK || N < 1 || nsplit < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (x_dtype) {
    case 0: return launch<float>(q, x, xsq, out_d, out_i, part_d, part_i, B, N, D, K,
                                 nsplit, stream);
    case 1: return launch<__nv_bfloat16>(q, x, xsq, out_d, out_i, part_d, part_i, B, N, D,
                                         K, nsplit, stream);
    case 2: return launch<int8_t>(q, x, xsq, out_d, out_i, part_d, part_i, B, N, D, K,
                                  nsplit, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
