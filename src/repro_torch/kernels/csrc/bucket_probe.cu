// Fused IVF probe step for Hopper (sm_90a): per-query bucket distances
// merged into the running top-k, with the insert count DARTH's features need.
//
// Replaces: src/repro/kernels/bucket_topk.py::_bucket_topk_kernel
//           (launched by bucket_topk_padded; ops.bucket_probe).
//
// What bounds it on the H100: device-memory bytes. A query reads one bucket
// (cap ids, and the codes and sqnorm of its live rows) and does 0.5 flops
// per byte of f32 codes (2 per byte of int8), far below the card's ~20
// flop/byte f32 ridge, so tensor cores cannot help. Queries of one call may
// share a bucket (a fit batch of clustered learn queries often does); the
// first read of it brings it into L2 and later readers in the same wave
// find it there. So the least time is that of reading each DISTINCT bucket
// of the call once, cap * 4 + live * (D * bytes + 4) bytes, live being the
// rows whose id is not -1, plus each query's own inputs and outputs, at
// 3.35 TB/s. This design keeps device memory busy; it still reads a shared
// bucket once per query (from L2 after the first), which is where it is
// furthest from that bound: a fit batch's 256 learn queries can share a
// few dozen buckets.
//
// What the design does about it:
//  * Buckets are very uneven (on a 1M-row, 1024-list index the cap is 5832
//    rows against a mean of 977), and the bucket a query probes first is
//    size-biased. So a query's bucket is split into tiles of kTile = 256
//    rows, each its own block: grid (B, ceil(C / kTile)), sized from C
//    alone, so the host never reads bucket sizes. A 5832-row bucket is
//    spread over 23 SMs instead of streaming through one. 256 rows is
//    128 KB of f32 codes at D = 128: enough work to amortise a block's
//    fixed cost (its ids, its list merge, its share of the scratch), small
//    enough that the last large bucket no longer sets the kernel's time.
//    kTile is the library's alone: the wrapper asks bucket_probe_tile()
//    for it to size the scratch. Queries run along grid.x (no 65535 limit
//    on B); the block scheduler walks x first, so tile t of every query is
//    issued together: the first tiles, which hold the live rows, before the
//    tails, which are mostly pad, and queries sharing a bucket read the
//    same tile close in time, from L2.
//  * The gather happens here: the kernel takes the whole bucket store plus
//    a per-query slot, so the [B, cap, D] gather never exists in memory.
//  * A block first reads its tile's ids (one per thread) and the sqnorm of
//    live rows. The whole cap is scanned, not just bucket_sizes[b] rows:
//    deletes leave tombstones (id -1) in place, so live rows can sit past
//    the size. Codes are streamed only up to the tile's last live row; a
//    tile holding only pads or tombstones reads nothing else, writes an
//    all-(+inf, -1) list and a count of 0. An inactive query (DARTH
//    terminated it) has its blocks return at once: only the merge touches
//    it, copying its running top-k through with a count of 0.
//  * The codes stream through shared memory in a ring of kStages stages of
//    ~kStageBytes each, filled by one producer thread with 1-D bulk copies
//    (cp.async.bulk, the TMA engine without a tensor map), whose completion
//    lands on a per-stage mbarrier. Eight consumer warps compute distances
//    on stage s while stages s+1.. are in flight, and release a stage
//    through a second mbarrier. No thread spends registers on the loads,
//    and up to kStages * kStageBytes per block are in flight.
//  * Each consumer warp keeps its own top-K of the tile, so no warp waits
//    while another merges: a lane-parallel filter (d < the running k-th,
//    which wins every tie, and d < the warp's own k-th), then the
//    survivors are inserted one at a time. A group of G lanes reads one
//    row of a stage with 16-byte vectors (G = row bytes / 16 rounded up to a power of
//    two, at most 32), whatever the code width; int8 codes are widened in
//    registers.
//  * Lists are ordered by (distance, column), the order of lax.top_k's
//    ties: lowest column first, running entries before bucket rows. An
//    entry goes to position #(entries before it in that order). At the end
//    of a tile warp 0 merges the other warps' lists into its own, and the
//    tile's K best go to scratch with its count of d < kth.
//  * A second kernel, one warp per query, merges the running top-k and
//    the tile lists in column order (running entries, then tile 0, 1, ..),
//    which reproduces the single-pass result exactly: each of the K
//    smallest under (distance, column) is among its own tile's K smallest.
//    It also sums the tile counts, so the count is exact.
//  * A row whose width is not a multiple of 16 bytes, a store that is not
//    16-byte aligned (bulk copies need both), or a row too wide for the
//    ring takes a plain-load path in the same kernel: one row per warp,
//    scalar loads straight from device memory.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kTile = 256;               // rows per block
constexpr int kWarps = 8;                // consumer warps
constexpr int kThreads = (kWarps + 1) * 32;  // + one producer warp
constexpr int kStages = 4;
constexpr int kStageBytes = 8192;
constexpr int kMaxRingBytes = 160 * 1024;
constexpr int kMaxK = 64;
constexpr unsigned kFull = 0xffffffffu;

template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int n = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int n = 8; };
template <> struct Vec<int8_t> { static constexpr int n = 16; };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// q . row[c*n : (c+1)*n] for one 16-byte chunk `raw` (chunk c) of a row;
// qs is 16-byte aligned.
template <typename T>
__device__ __forceinline__ float dot16(uint4 raw, const float* qs, int c) {
  const T* v = reinterpret_cast<const T*>(&raw);
  const float4* qc = reinterpret_cast<const float4*>(qs + c * Vec<T>::n);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < Vec<T>::n / 4; ++j) {
    const float4 qv = qc[j];
    s = fmaf(qv.x, to_f(v[4 * j]), s);
    s = fmaf(qv.y, to_f(v[4 * j + 1]), s);
    s = fmaf(qv.z, to_f(v[4 * j + 2]), s);
    s = fmaf(qv.w, to_f(v[4 * j + 3]), s);
  }
  return s;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Wait for the completion of the barrier's phase with parity `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// One bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from device memory into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes),
      "r"(smem_addr(bar)) : "memory");
}

// (d, c) comes before (d2, c2): lower distance, then lower column.
__device__ __forceinline__ bool before(float d, int c, float d2, int c2) {
  return d < d2 || (d == d2 && c < c2);
}

// Insert (d, c, id) into the list ld/lc/li of length K <= 64, ordered by
// (distance, column), at position #(entries before it); dropped if that
// is K. Called by all 32 lanes of one warp with the same (d, c, id).
__device__ __forceinline__ void warp_insert(float* ld, int* lc, int* li, int K,
                                            float d, int c, int id, int lane) {
  const bool ha = lane < K, hb = lane + 32 < K;
  const float a = ha ? ld[lane] : 0.f;
  const float b = hb ? ld[lane + 32] : 0.f;
  const int ca = ha ? lc[lane] : 0, cb = hb ? lc[lane + 32] : 0;
  const int ia = ha ? li[lane] : 0, ib = hb ? li[lane + 32] : 0;
  const int pos = __popc(__ballot_sync(kFull, ha && before(a, ca, d, c))) +
                  __popc(__ballot_sync(kFull, hb && before(b, cb, d, c)));
  if (pos >= K) return;  // uniform across the warp
  __syncwarp();
  if (lane >= pos && lane + 1 < K) {
    ld[lane + 1] = a; lc[lane + 1] = ca; li[lane + 1] = ia;
  }
  if (lane + 32 >= pos && lane + 33 < K) {
    ld[lane + 33] = b; lc[lane + 33] = cb; li[lane + 33] = ib;
  }
  __syncwarp();
  if (lane == 0) { ld[pos] = d; lc[pos] = c; li[pos] = id; }
  __syncwarp();
}

// Per-warp state of the tile scan.
struct Scan {
  float* ld; int* lc; int* li;     // this warp's top-K of the tile
  const int* tids; const float* tsq;
  float bias, kth, run_kth;
  int K, G, gl, lane, count;

  // Row r of the tile (valid if ok), whose partial dot products are spread
  // over the G lanes of this lane's group: reduce, then count and filter.
  // Called by all lanes of the warp, rows ascending per group.
  __device__ __forceinline__ void take(int r, bool ok, float s) {
    for (int off = G / 2; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
    float dist = inf_f();
    int id = -1;
    if (ok && gl == 0) {
      id = tids[r];
      if (id >= 0) dist = fmaxf(tsq[r] - 2.f * s + bias, 0.f);
      count += dist < kth;
    }
    unsigned m = __ballot_sync(kFull, gl == 0 && dist < run_kth && dist < ld[K - 1]);
    while (m) {
      const int src = __ffs(m) - 1;
      m &= m - 1;
      warp_insert(ld, lc, li, K, __shfl_sync(kFull, dist, src),
                  __shfl_sync(kFull, r, src), __shfl_sync(kFull, id, src), lane);
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
probe_tile_kernel(const float* __restrict__ q, const T* __restrict__ vecs,
                  const float* __restrict__ sqn, const int* __restrict__ ids,
                  const int* __restrict__ slot,
                  const unsigned char* __restrict__ active,
                  const float* __restrict__ bias, const float* __restrict__ kth,
                  const float* __restrict__ run_d, float* __restrict__ part_d,
                  int* __restrict__ part_i, int* __restrict__ part_c, int C,
                  int D, int K, int rows_per_stage, int ring) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  __shared__ int wlast[kWarps + 1];
  __shared__ int tile_count;

  const int b = blockIdx.x, t = blockIdx.y;
  if (active != nullptr && !active[b]) return;  // the merge copies it through
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row_bytes = D * static_cast<int>(sizeof(T));
  const int R = rows_per_stage;
  T* ringbuf = reinterpret_cast<T*>(smem);
  float* qs = reinterpret_cast<float*>(
      smem + (ring ? static_cast<size_t>(kStages) * R * row_bytes : 0));
  int* tids = reinterpret_cast<int*>(qs + ((D + 3) & ~3));       // [kTile]
  float* tsq = reinterpret_cast<float*>(tids + kTile);           // [kTile]
  float* wd = tsq + kTile;                                       // [kWarps][kMaxK]
  int* wc = reinterpret_cast<int*>(wd + kWarps * kMaxK);
  int* wi = wc + kWarps * kMaxK;

  const int c0 = t * kTile;
  const int rows = min(kTile, C - c0);
  const long long row0 = static_cast<long long>(slot != nullptr ? slot[b] : b) * C + c0;
  const long long part = (static_cast<long long>(b) * gridDim.y + t) * K;

  // Ids and live sqnorms of the tile; the last live row bounds the stream.
  int id = -1;
  float sq = inf_f();
  if (tid < rows) {
    id = __ldg(ids + row0 + tid);
    if (id >= 0) sq = __ldg(sqn + row0 + tid);
  }
  if (tid < kTile) { tids[tid] = id; tsq[tid] = sq; }
  const int last = __reduce_max_sync(kFull, id >= 0 ? tid + 1 : 0);
  if (lane == 0) wlast[warp] = last;
  __syncthreads();
  int n = 0;
#pragma unroll
  for (int w = 0; w <= kWarps; ++w) n = max(n, wlast[w]);
  if (n == 0) {  // pads and tombstones only: most blocks of a large cap
    if (tid < K) { part_d[part + tid] = inf_f(); part_i[part + tid] = -1; }
    if (tid == 0) part_c[static_cast<long long>(b) * gridDim.y + t] = 0;
    return;
  }
  for (int d = tid; d < D; d += kThreads) qs[d] = q[static_cast<long long>(b) * D + d];
  for (int e = tid; e < kWarps * kMaxK; e += kThreads) {
    wd[e] = inf_f(); wc[e] = 0x7fffffff; wi[e] = -1;
  }
  if (tid == 0) {
    tile_count = 0;
    if (ring) {
      for (int s = 0; s < kStages; ++s) { mbar_init(&full[s], 1); mbar_init(&empty[s], kWarps); }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
  }
  __syncthreads();
  const int nst = (n + R - 1) / R;

  if (warp == kWarps) {
    // Producer: one thread keeps the ring full.
    if (ring && lane == 0) {
      const char* src = reinterpret_cast<const char*>(vecs + row0 * D);
      for (int s = 0; s < nst; ++s) {
        const int st = s % kStages;
        if (s >= kStages) mbar_wait(&empty[st], ((s / kStages) - 1) & 1);
        const unsigned bytes = static_cast<unsigned>(min(R, n - s * R) * row_bytes);
        mbar_expect_tx(&full[st], bytes);
        bulk_load(ringbuf + static_cast<size_t>(st) * R * D,
                  src + static_cast<size_t>(s) * R * row_bytes, bytes, &full[st]);
      }
    }
  } else {
    Scan sc;
    sc.ld = wd + warp * kMaxK; sc.lc = wc + warp * kMaxK; sc.li = wi + warp * kMaxK;
    sc.tids = tids; sc.tsq = tsq;
    sc.bias = bias[b]; sc.kth = kth[b];
    sc.run_kth = run_d[static_cast<long long>(b) * K + K - 1];
    sc.K = K; sc.lane = lane; sc.count = 0;
    int G = 32;
    const int nv = row_bytes / 16;
    if (ring) { G = 1; while (G < nv && G < 32) G <<= 1; }
    sc.G = G;
    const int rpw = 32 / G, g = lane / G;
    sc.gl = lane % G;
    const int step = kWarps * rpw;
    if (ring) {
      for (int s = 0; s < nst; ++s) {
        const int st = s % kStages;
        mbar_wait(&full[st], (s / kStages) & 1);
        const T* buf = ringbuf + static_cast<size_t>(st) * R * D;
        const int rs = s * R, nr = min(R, n - rs);
        // The loop bound is uniform per warp, so every lane reaches the shuffles.
        for (int rb = warp * rpw; rb < nr; rb += step) {
          const int r = rb + g;
          const bool ok = r < nr;
          float acc = 0.f;
          if (ok && tids[rs + r] >= 0) {
            const uint4* row = reinterpret_cast<const uint4*>(buf + static_cast<size_t>(r) * D);
            for (int c = sc.gl; c < nv; c += G) acc += dot16<T>(row[c], qs, c);
          }
          sc.take(rs + r, ok, acc);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[st]);
      }
    } else {
      for (int rb = warp * rpw; rb < n; rb += step) {
        const int r = rb + g;
        const bool ok = r < n;
        float acc = 0.f;
        if (ok && tids[r] >= 0) {
          const T* row = vecs + (row0 + r) * D;
          for (int d = sc.gl; d < D; d += G) acc = fmaf(qs[d], to_f(row[d]), acc);
        }
        sc.take(r, ok, acc);
      }
    }
    int cnt = sc.count;
    for (int off = 16; off > 0; off >>= 1) cnt += __shfl_xor_sync(kFull, cnt, off);
    if (lane == 0) atomicAdd(&tile_count, cnt);
  }
  __syncthreads();
  if (warp == 0) {
    float* ld = wd; int* lc = wc; int* li = wi;
    for (int w = 1; w < kWarps; ++w) {
      for (int j0 = 0; j0 < K; j0 += 32) {
        const int j = j0 + lane;
        const float d = j < K ? wd[w * kMaxK + j] : inf_f();
        const int c = j < K ? wc[w * kMaxK + j] : 0x7fffffff;
        const int i = j < K ? wi[w * kMaxK + j] : -1;
        unsigned m = __ballot_sync(kFull, before(d, c, ld[K - 1], lc[K - 1]));
        while (m) {
          const int src = __ffs(m) - 1;
          m &= m - 1;
          warp_insert(ld, lc, li, K, __shfl_sync(kFull, d, src),
                      __shfl_sync(kFull, c, src), __shfl_sync(kFull, i, src), lane);
        }
      }
    }
    for (int j = lane; j < K; j += 32) { part_d[part + j] = ld[j]; part_i[part + j] = li[j]; }
    if (lane == 0) part_c[static_cast<long long>(b) * gridDim.y + t] = tile_count;
  }
}

// One warp per query: the running top-k, then the tile lists in column
// order (tile 0, 1, ..; each ascending), inserted by (distance, position),
// and the sum of the tile counts. Inactive queries copy through.
__global__ void __launch_bounds__(256)
probe_merge_kernel(const unsigned char* __restrict__ active,
                   const float* __restrict__ run_d, const int* __restrict__ run_i,
                   const float* __restrict__ part_d, const int* __restrict__ part_i,
                   const int* __restrict__ part_c, float* __restrict__ out_d,
                   int* __restrict__ out_i, int* __restrict__ out_c, int B, int K,
                   int ntiles) {
  __shared__ float lds[8][kMaxK];
  __shared__ int lcs[8][kMaxK];
  __shared__ int lis[8][kMaxK];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * 8 + warp;
  if (b >= B) return;  // whole warp
  const long long rk = static_cast<long long>(b) * K;
  if (active != nullptr && !active[b]) {
    for (int j = lane; j < K; j += 32) { out_d[rk + j] = run_d[rk + j]; out_i[rk + j] = run_i[rk + j]; }
    if (lane == 0) out_c[b] = 0;
    return;
  }
  float* L = lds[warp]; int* LC = lcs[warp]; int* LI = lis[warp];
  for (int j = lane; j < K; j += 32) { L[j] = run_d[rk + j]; LC[j] = j - K; LI[j] = run_i[rk + j]; }
  __syncwarp();
  const int total = ntiles * K;
  const long long base = static_cast<long long>(b) * total;
  float dn = lane < total ? part_d[base + lane] : inf_f();
  int in = lane < total ? part_i[base + lane] : -1;
  for (int e = 0; e < total; e += 32) {
    const float d = dn;
    const int id = in;
    if (e + 32 < total) {  // fetch the next chunk while this one merges
      dn = e + 32 + lane < total ? part_d[base + e + 32 + lane] : inf_f();
      in = e + 32 + lane < total ? part_i[base + e + 32 + lane] : -1;
    }
    unsigned m = __ballot_sync(kFull, d < L[K - 1]);
    while (m) {
      const int src = __ffs(m) - 1;
      m &= m - 1;
      warp_insert(L, LC, LI, K, __shfl_sync(kFull, d, src), e + src,
                  __shfl_sync(kFull, id, src), lane);
    }
  }
  int cnt = 0;
  for (int t = lane; t < ntiles; t += 32) cnt += part_c[static_cast<long long>(b) * ntiles + t];
  for (int off = 16; off > 0; off >>= 1) cnt += __shfl_xor_sync(kFull, cnt, off);
  for (int j = lane; j < K; j += 32) { out_d[rk + j] = L[j]; out_i[rk + j] = LI[j]; }
  if (lane == 0) out_c[b] = cnt;
}

template <typename T>
cudaError_t launch(const float* q, const void* vecs, const float* sqn,
                   const int* ids, const int* slot, const unsigned char* active,
                   const float* bias, const float* kth, const float* run_d,
                   const int* run_i, float* out_d, int* out_i, int* out_c,
                   float* part_d, int* part_i, int* part_c, int B, int C, int D,
                   int K, int ntiles, int vec, cudaStream_t stream) {
  const int row_bytes = D * static_cast<int>(sizeof(T));
  const int R = max(1, min(kTile, kStageBytes / row_bytes));
  const int ring = vec && static_cast<long long>(kStages) * R * row_bytes <= kMaxRingBytes;
  const size_t smem = (ring ? static_cast<size_t>(kStages) * R * row_bytes : 0) +
                      sizeof(float) * (((D + 3) & ~3) + 2 * kTile) +
                      (sizeof(float) + 2 * sizeof(int)) * kWarps * kMaxK;
  if (ntiles > 0) {
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(probe_tile_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
      if (e != cudaSuccess) return e;
    }
    probe_tile_kernel<T><<<dim3(B, ntiles), kThreads, smem, stream>>>(
        q, static_cast<const T*>(vecs), sqn, ids, slot, active, bias, kth, run_d,
        part_d, part_i, part_c, C, D, K, R, ring);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  probe_merge_kernel<<<(B + 7) / 8, 256, 0, stream>>>(
      active, run_d, run_i, part_d, part_i, part_c, out_d, out_i, out_c, B, K, ntiles);
  return cudaGetLastError();
}

}  // namespace

// vec_dtype: 0 float32, 1 bfloat16, 2 int8. slot == nullptr: buckets are
// pre-gathered ([B, C, D], query b reads bucket b). active == nullptr: all
// queries active. vec: D * sizeof(code) is a multiple of 16 and the store
// is 16-byte aligned (the ring's bulk copies need both). scratch holds
// B * ntiles * (2K + 1) 4-byte words, ntiles = ceil(C / bucket_probe_tile()):
// the tile lists' distances [B, ntiles, K], their ids [B, ntiles, K] and
// the tile counts [B, ntiles]. Returns cudaGetLastError() after the launches.
extern "C" int bucket_probe_tile() { return kTile; }

extern "C" int bucket_probe_launch(
    const float* q, const void* vecs, int vec_dtype, const float* sqn,
    const int* ids, const int* slot, const unsigned char* active,
    const float* bias, const float* kth, const float* run_d, const int* run_i,
    float* out_d, int* out_i, int* out_c, void* scratch, int B, int C, int D,
    int K, int vec, cudaStream_t stream) {
  if (B <= 0) return 0;
  const int ntiles = (C + kTile - 1) / kTile;
  if (K < 1 || K > kMaxK || C < 0 || D < 1 || ntiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t parts = static_cast<size_t>(B) * ntiles * K;
  float* part_d = static_cast<float*>(scratch);
  int* part_i = reinterpret_cast<int*>(part_d + parts);
  int* part_c = part_i + parts;
  switch (vec_dtype) {
    case 0: return launch<float>(q, vecs, sqn, ids, slot, active, bias, kth, run_d, run_i,
                                 out_d, out_i, out_c, part_d, part_i, part_c, B, C, D,
                                 K, ntiles, vec, stream);
    case 1: return launch<__nv_bfloat16>(q, vecs, sqn, ids, slot, active, bias, kth,
                                         run_d, run_i, out_d, out_i, out_c, part_d,
                                         part_i, part_c, B, C, D, K, ntiles, vec,
                                         stream);
    case 2: return launch<int8_t>(q, vecs, sqn, ids, slot, active, bias, kth, run_d,
                                  run_i, out_d, out_i, out_c, part_d, part_i, part_c,
                                  B, C, D, K, ntiles, vec, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
