// Fused IVF probe step for Hopper (sm_90a): per-query bucket distances
// merged into the running top-k, with the insert count DARTH's features need.
//
// Replaces: src/repro/kernels/bucket_topk.py::_bucket_topk_kernel
//           (launched by bucket_topk_padded; ops.bucket_probe).
//
// What bounds it on the H100: device-memory bytes. Every query reads its
// OWN bucket (cap ids, and the codes and sqnorm of its live rows), so there
// is no reuse across queries: a batched matrix-vector product at 2 flops per
// byte of f32 codes (8 per byte of int8), far below the card's ~20 flop/byte
// f32 ridge. The least time is B * (cap * 4 + live * (D * bytes + 4)) bytes
// at 3.35 TB/s, live being the rows whose id is not -1.
//
// What the design does about it:
//  * One block per query; the gather happens here. The kernel takes the
//    whole bucket store plus a per-query slot index, so the [B, cap, D]
//    gather the reference materialises in memory never exists.
//  * An `active` mask: an inactive query (DARTH terminated it) reads no
//    bucket bytes, copies its running top-k through and counts 0. This is
//    what turns early termination into saved bandwidth on this card.
//  * Rows are read with 16-byte loads by a group of G lanes (G = D*bytes/16
//    rounded up to a power of two, at most 32), so a warp reads 32 * 16 B
//    per instruction whether the codes are f32, bf16 or int8. int8 codes
//    are read as int8 and widened in registers. Rows whose width is not a
//    multiple of 16 bytes take a scalar path (one row per warp).
//  * The whole cap is scanned, not just bucket_sizes[b] rows: deletes leave
//    tombstoned rows (id -1, sqnorm +inf) in place, so live rows can sit
//    past the size. A row whose id is -1 (a pad or a tombstone) has
//    distance +inf whatever its codes, so only its id is read.
//  * Each lane group works on kUnroll rows at a time, so a warp keeps
//    twice the bytes in flight that one row would.
//  * The bucket streams through shared memory in chunks of kChunk rows:
//    all warps compute a chunk's distances, then warp 0 merges them into
//    the running top-k in column order. A lane-parallel filter against the
//    current k-th distance drops most candidates; survivors are inserted
//    one at a time at position #(entries <= d), which is lax.top_k's
//    order: the lowest column wins a tie (running entries before bucket
//    rows, lower rows before higher).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 1024;
constexpr int kMaxK = 64;
constexpr int kUnroll = 2;
constexpr unsigned kFull = 0xffffffffu;

template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int n = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int n = 8; };
template <> struct Vec<int8_t> { static constexpr int n = 16; };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return static_cast<float>(v); }

// q . row[c*n : (c+1)*n] for one 16-byte chunk c of the row.
template <typename T>
__device__ __forceinline__ float dot16(const T* row, const float* qs, int c) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(row) + c);
  const T* v = reinterpret_cast<const T*>(&raw);
  const float* qc = qs + c * Vec<T>::n;
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < Vec<T>::n; ++j) s = fmaf(qc[j], to_f(v[j]), s);
  return s;
}

// Insert (d, id) into the ascending list ld/li of length K <= 64 held in
// shared memory, at position #(entries <= d); dropped if that is K.
// Called by all 32 lanes of one warp with the same (d, id).
__device__ __forceinline__ void warp_insert(float* ld, int* li, int K,
                                            float d, int id, int lane) {
  const bool ha = lane < K, hb = lane + 32 < K;
  const float a = ha ? ld[lane] : 0.f;
  const float b = hb ? ld[lane + 32] : 0.f;
  const int ia = ha ? li[lane] : 0;
  const int ib = hb ? li[lane + 32] : 0;
  const int pos = __popc(__ballot_sync(kFull, ha && a <= d)) +
                  __popc(__ballot_sync(kFull, hb && b <= d));
  if (pos >= K) return;  // uniform across the warp
  __syncwarp();
  if (lane >= pos && lane + 1 < K) { ld[lane + 1] = a; li[lane + 1] = ia; }
  if (lane + 32 >= pos && lane + 33 < K) { ld[lane + 33] = b; li[lane + 33] = ib; }
  __syncwarp();
  if (lane == 0) { ld[pos] = d; li[pos] = id; }
  __syncwarp();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bucket_probe_kernel(const float* __restrict__ q, const T* __restrict__ vecs,
                    const float* __restrict__ sqn, const int* __restrict__ ids,
                    const int* __restrict__ slot,
                    const unsigned char* __restrict__ active,
                    const float* __restrict__ bias, const float* __restrict__ kth,
                    const float* __restrict__ run_d, const int* __restrict__ run_i,
                    float* __restrict__ out_d, int* __restrict__ out_i,
                    int* __restrict__ out_c, int C, int D, int K, int vec_path) {
  extern __shared__ float smem[];
  float* qs = smem;                                     // [D]
  float* cd = qs + ((D + 3) & ~3);                      // [kChunk]
  int* ci = reinterpret_cast<int*>(cd + kChunk);        // [kChunk]
  float* ld = reinterpret_cast<float*>(ci + kChunk);    // [kMaxK]
  int* li = reinterpret_cast<int*>(ld + kMaxK);         // [kMaxK]
  __shared__ int count;

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (active != nullptr && !active[b]) {
    if (tid < K) {
      out_d[b * K + tid] = run_d[b * K + tid];
      out_i[b * K + tid] = run_i[b * K + tid];
    }
    if (tid == 0) out_c[b] = 0;
    return;
  }
  if (tid < K) { ld[tid] = run_d[b * K + tid]; li[tid] = run_i[b * K + tid]; }
  for (int d = tid; d < D; d += kThreads) qs[d] = q[(long long)b * D + d];
  if (tid == 0) count = 0;
  __syncthreads();

  const long long row0 = (long long)(slot != nullptr ? slot[b] : b) * C;
  const T* base = vecs + row0 * D;
  const float bias_b = bias[b], kth_b = kth[b];
  int G = 32;
  if (vec_path) {
    const int nv = D / Vec<T>::n;
    G = 1;
    while (G < nv && G < 32) G <<= 1;
  }
  const int rows_per_warp = 32 / G, g = lane / G, gl = lane % G;
  int my_count = 0;

  for (int c0 = 0; c0 < C; c0 += kChunk) {
    const int n = min(kChunk, C - c0);
    const int span = rows_per_warp * kUnroll;
    // The loop bound is uniform per warp, so every lane reaches the shuffles.
    for (int rb = warp * span; rb < n; rb += kWarps * span) {
      int id[kUnroll];
      float s[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = rb + u * rows_per_warp + g;
        id[u] = r < n ? __ldg(ids + row0 + c0 + r) : -1;
        s[u] = 0.f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (id[u] < 0) continue;
        const T* row = base + (long long)(c0 + rb + u * rows_per_warp + g) * D;
        if (vec_path) {
          const int nv = D / Vec<T>::n;
          for (int c = gl; c < nv; c += G) s[u] += dot16(row, qs, c);
        } else {
          for (int d = gl; d < D; d += G) s[u] = fmaf(qs[d], to_f(row[d]), s[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        for (int off = G / 2; off > 0; off >>= 1)
          s[u] += __shfl_xor_sync(kFull, s[u], off);
      if (gl == 0) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int r = rb + u * rows_per_warp + g;
          if (r >= n) continue;
          float dist = __int_as_float(0x7f800000);
          if (id[u] >= 0)
            dist = fmaxf(__ldg(sqn + row0 + c0 + r) - 2.f * s[u] + bias_b, 0.f);
          cd[r] = dist;
          ci[r] = id[u];
          my_count += dist < kth_b;
        }
      }
    }
    __syncthreads();
    if (warp == 0) {
      for (int c = 0; c < n; c += 32) {
        const float d = c + lane < n ? cd[c + lane] : __int_as_float(0x7f800000);
        const int id = c + lane < n ? ci[c + lane] : -1;
        unsigned m = __ballot_sync(kFull, d < ld[K - 1]);
        while (m) {
          const int src = __ffs(m) - 1;
          m &= m - 1;
          warp_insert(ld, li, K, __shfl_sync(kFull, d, src),
                      __shfl_sync(kFull, id, src), lane);
        }
      }
    }
    __syncthreads();
  }
  for (int off = 16; off > 0; off >>= 1) my_count += __shfl_xor_sync(kFull, my_count, off);
  if (lane == 0) atomicAdd(&count, my_count);
  __syncthreads();
  if (tid < K) { out_d[b * K + tid] = ld[tid]; out_i[b * K + tid] = li[tid]; }
  if (tid == 0) out_c[b] = count;
}

template <typename T>
cudaError_t launch(const float* q, const void* vecs, const float* sqn,
                   const int* ids, const int* slot, const unsigned char* active,
                   const float* bias, const float* kth, const float* run_d,
                   const int* run_i, float* out_d, int* out_i, int* out_c,
                   int B, int C, int D, int K, int vec_path, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (((D + 3) & ~3) + 2 * kChunk + 2 * kMaxK);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(bucket_probe_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  bucket_probe_kernel<T><<<B, kThreads, smem, stream>>>(
      q, static_cast<const T*>(vecs), sqn, ids, slot, active, bias, kth,
      run_d, run_i, out_d, out_i, out_c, C, D, K, vec_path);
  return cudaGetLastError();
}

}  // namespace

// vec_dtype: 0 float32, 1 bfloat16, 2 int8. slot == nullptr: buckets are
// pre-gathered ([B, C, D], query b reads bucket b). active == nullptr: all
// queries active. vec_path: D * sizeof(code) is a multiple of 16 and the
// store is 16-byte aligned. Returns cudaGetLastError() after the launch.
extern "C" int bucket_probe_launch(
    const float* q, const void* vecs, int vec_dtype, const float* sqn,
    const int* ids, const int* slot, const unsigned char* active,
    const float* bias, const float* kth, const float* run_d, const int* run_i,
    float* out_d, int* out_i, int* out_c, int B, int C, int D, int K,
    int vec_path, cudaStream_t stream) {
  if (B <= 0) return 0;
  if (K < 1 || K > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  switch (vec_dtype) {
    case 0: return launch<float>(q, vecs, sqn, ids, slot, active, bias, kth, run_d, run_i,
                                 out_d, out_i, out_c, B, C, D, K, vec_path, stream);
    case 1: return launch<__nv_bfloat16>(q, vecs, sqn, ids, slot, active, bias, kth, run_d,
                                         run_i, out_d, out_i, out_c, B, C, D, K, vec_path,
                                         stream);
    case 2: return launch<int8_t>(q, vecs, sqn, ids, slot, active, bias, kth, run_d, run_i,
                                  out_d, out_i, out_c, B, C, D, K, vec_path, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
