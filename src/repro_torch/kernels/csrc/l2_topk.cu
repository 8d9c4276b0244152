// Fused squared-L2 distance tiles + running per-row top-k against ONE shared
// database, for Hopper (sm_90a). Computes, per query row, the k smallest of
// x_sqnorm - 2 q.x (the wrapper adds ||q||^2 or the SQ8 bias afterwards),
// ascending, the lower row first on a tie (as lax.top_k); slots never filled
// hold (+inf, -1) and rows with x_sqnorm = +inf never enter. The B x N
// distance matrix never reaches device memory.
//
// Replaces: src/repro/kernels/l2_topk.py::_l2_topk_kernel
//           (launched by l2_topk_padded; ops.l2_topk).
//
// What bounds it on the H100: operations. The main path runs it at two
// shapes: the fit's exact ground truth (q [1024, 128] x the 1M-row database,
// k = 10) and k-means assignment in ivf.build (q [<= 65536, 128] x 1024
// centroids, k = 1). Both do 2*B*N*D flops on a few hundred MB at most, far
// above the ridge. The function is owed f32 accuracy, so two figures bound
// it: the least time to do the flops to f32 accuracy on the tensor cores
// (three TF32 passes at 495 TFLOP/s for f32 codes; three bf16 passes at
// 989 TFLOP/s for bf16/int8 codes, whose values are exact in bf16) -- 1.59
// ms at the ground-truth shape, 0.104 ms at k-means -- and the old figure,
// f32 FMAs on the CUDA cores at 67 TFLOP/s (3.91 ms and 0.256 ms).
//
// Products on the tensor cores in split TF32 ("3xTF32"). Each f32 operand is
// split as a = a_hi + a_lo, a_hi = cvt.rna.tf32(a), a_lo = cvt.rna.tf32(a -
// a_hi), and a.b is accumulated in f32 as a_lo.b_hi + a_hi.b_lo + a_hi.b_hi
// with mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32. bf16 and int8 codes have
// at most 8 significant bits, exact in TF32's 11, so their lo part is zero
// and the a_hi.b_lo pass is skipped. The dropped a_lo.b_lo term and the
// rounding of a_lo leave a relative error near 2^-22 per product, inside the
// tolerance the kernel is held to on float data.
//
// Exactness on integer data. An integer v with |v| <= 2048 has at most 11
// significant bits, so it is exact in TF32: v_hi = v, v_lo = 0, and every
// product the tensor cores form is an exact integer. Where every partial sum
// of q.x is an integer below 2^24 in magnitude (values -8..8 at D = 40, or
// SIFT's 0..255 at D = 128: 255^2 * 128 < 2^24), f32 holds each of them
// exactly, so the sum is exact in any order and any accumulation width of
// at least 24 bits. x_sqnorm - 2 q.x is then the same f32 operation as the
// plain version's, and the kernel's distances and ids are bit-equal to it.
//
// What the design does:
//  * A block owns BQ = 128 queries x BN = 128 database rows; 8 warps in a
//    2 x 4 grid each own a 64 x 32 accumulator tile (4 x 4 mma tiles, 64 f32
//    registers a thread). The larger query tile halves, against a 64-query
//    tile, how often the k-means shape re-reads its 512 KB of centroids.
//  * The depth is walked in chunks of BK = 64. q's and x's chunks stream
//    into a ring of two shared-memory stages with cp.async (16-byte copies,
//    zero-filled past B, past the block's rows and past D): chunk s+1 --
//    across tile boundaries too -- is in flight while chunk s is multiplied,
//    and one barrier a chunk hands a stage back. Rows whose width is not a
//    multiple of 16 bytes, or tensors not 16-byte aligned, fill the same
//    ring with plain loads.
//  * The 8 k-slots of an mma take values (0, 2, 4, 6, 1, 3, 5, 7) of an
//    8-deep step, in A and B alike, so a lane reads its two values of a row
//    in one load. Rows are padded (288 bytes for f32, 144 for bf16, 80 for
//    int8) so that no two lanes of a fragment load meet on a bank. Each
//    element is split into hi / lo once, as it leaves shared memory into a
//    fragment register, not once per product.
//  * The top-k merge works as before, and off the products' path as far as
//    it can: after a tile's last chunk, the warps that own the accumulators
//    compute distances in registers and filter them against each query's
//    running k-th (d < kth). Survivors are written to the stage the chunk
//    just consumed, now a [BN][BQ] distance tile, with a per-query bit mask;
//    a block-wide OR barrier skips the merge when no query has one. For
//    k = 1 (k-means) a warp passes on only its best column of a row. Then
//    thread r merges query r: survivors in ascending row order, each put
//    after the entries <= it, so a tie keeps the lower row first. The lanes
//    of a warp make their insertion passes together and without branching.
//  * The TPU walks the database axis in sequence and carries the top-k in
//    its output block. Here a block walks a contiguous range of database
//    tiles; the database is split into `nsplit` ranges over grid.y so that
//    one wave of blocks fills the 132 SMs, and l2_merge_kernel merges the
//    per-range lists in range order (range s holds only rows below s+1's).
//  * Tile sizes are the library's alone: l2_topk_tiles() reports them to
//    the wrapper, which sizes nsplit from them.
//  * k is bucketed at compile time: lists of up to 64 and of up to 128
//    (the evaluation's wide ground truth takes k = 100). A block keeps its
//    queries' running lists in shared memory beside the ring, 8 k BQ bytes:
//    at k <= 64 a 128-query block takes 215 KB with f32 codes; at k <= 128
//    it would take 280 KB, over the 227 KB a block may have. So the 128
//    bucket runs blocks of BQ = 64 queries, one warp row of 4 warps (177 KB),
//    each warp keeping the same 64 x 32 accumulator tile; the 64 bucket is
//    the 128-query block above, unchanged.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BN = 128, BK = 64;            // block tile: rows, depth
constexpr int kWarpsN = 4;                  // warps along BN
constexpr int WM = 64, WN = BN / kWarpsN;   // 64 x 32 per warp
constexpr int MT = WM / 16, NT = WN / 8;    // mma tiles per warp
constexpr int kStages = 2;
constexpr int kMaskWords = BN / 32;
constexpr unsigned kFull = 0xffffffffu;
static_assert(WN == 32, "a warp's columns are one mask word");

// The block for lists of up to KMAX entries (64 or 128): BQ queries, a
// kWarpsM x kWarpsN warp grid, kThreads threads.
template <int KMAX>
struct Tile {
  static_assert(KMAX == 64 || KMAX == 128, "k buckets are 64 and 128");
  static constexpr int BQ = KMAX <= 64 ? 128 : 64;
  static constexpr int kWarpsM = BQ / WM;
  static constexpr int kThreads = kWarpsM * kWarpsN * 32;
  static_assert(BQ % 32 == 0, "whole warps merge, one query per thread");
};

// Words to add to a row of `words` so that rows start `step` words apart
// modulo `mod`.
__host__ __device__ constexpr int pad_words(int words, int step, int mod) {
  return ((step - words % mod) % mod + mod) % mod;
}
// Bytes of a staged row holding BK values of `bytes` each. A lane reads
// values 2t, 2t+1 of row g in one load (8 bytes of f32, 4 of bf16, 2 of
// int8). f32 rows start 8 words apart mod 32 (a half-warp reads 4 rows of
// 8 words), bf16 and int8 rows 4 words apart: lanes share words, not banks.
__host__ __device__ constexpr int staged_row(int bytes) {
  return bytes == 4 ? 4 * (BK + pad_words(BK, 8, 32))
                    : 4 * (BK * bytes / 4 + pad_words(BK * bytes / 4, 4, 8));
}
constexpr int kQRow = staged_row(4);

// Raw staging type of a database code, and its bytes per staged row.
template <typename T> struct Code;
template <> struct Code<float> { using raw = float; static constexpr int row = staged_row(4); };
template <> struct Code<__nv_bfloat16> { using raw = uint16_t; static constexpr int row = staged_row(2); };
template <> struct Code<int8_t> { using raw = int8_t; static constexpr int row = staged_row(1); };

template <typename T, int BQ>
__host__ __device__ constexpr int stage_bytes() { return BQ * kQRow + BN * Code<T>::row; }
// A ring slot: one stage, or a tile's distances once its stage is consumed.
template <typename T, int BQ>
__host__ __device__ constexpr int slot_bytes() {
  return stage_bytes<T, BQ>() > BQ * BN * 4 ? stage_bytes<T, BQ>() : BQ * BN * 4;
}

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// Values 2t and 2t+1 of a staged row, as f32 (exact for bf16 and int8).
__device__ __forceinline__ void pair_f(const float* p, float& a, float& b) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  a = v.x;
  b = v.y;
}
__device__ __forceinline__ void pair_f(const uint16_t* p, float& a, float& b) {
  const uint32_t v = *reinterpret_cast<const uint32_t*>(p);
  a = __uint_as_float(v << 16);
  b = __uint_as_float(v & 0xffff0000u);
}
__device__ __forceinline__ void pair_f(const int8_t* p, float& a, float& b) {
  const char2 v = *reinterpret_cast<const char2*>(p);
  a = static_cast<float>(v.x);
  b = static_cast<float>(v.y);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; bytes past src_bytes (0 or 16) are zero.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// v = hi + lo, both TF32.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32(v);
  lo = tf32(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// See bucket_probe.cu: insert at #(entries <= d) into a list of K <= 32 W;
// lane l holds entries l, l + 32, ... (W of them).
template <int W>
__device__ __forceinline__ void warp_insert(float* ld, int* li, int K,
                                            float d, int id, int lane) {
  bool h[W];
  float a[W];
  int ia[W];
#pragma unroll
  for (int u = 0; u < W; ++u) h[u] = lane + 32 * u < K;
#pragma unroll
  for (int u = 0; u < W; ++u) a[u] = h[u] ? ld[lane + 32 * u] : 0.f;
#pragma unroll
  for (int u = 0; u < W; ++u) ia[u] = h[u] ? li[lane + 32 * u] : 0;
  int pos = 0;
#pragma unroll
  for (int u = 0; u < W; ++u) pos += __popc(__ballot_sync(kFull, h[u] && a[u] <= d));
  if (pos >= K) return;
  __syncwarp();
#pragma unroll
  for (int u = 0; u < W; ++u) {
    const int j = lane + 32 * u;
    if (j >= pos && j + 1 < K) { ld[j + 1] = a[u]; li[j + 1] = ia[u]; }
  }
  __syncwarp();
  if (lane == 0) { ld[pos] = d; li[pos] = id; }
  __syncwarp();
}

// Stage chunk `d0` of query block `qb` and of database tile `n0` (rows below
// n_hi) into `stage`: q as [BQ][kQRow bytes] f32, x as [BN][Code<T>::row
// bytes] raw codes, zero past B, n_hi and D.
template <typename T, int BQ, int kThreads>
__device__ __forceinline__ void load_stage(char* stage, const float* q,
                                           const T* x, int qb, int n0, int n_hi,
                                           int d0, int B, int D, bool vec,
                                           int tid) {
  using R = typename Code<T>::raw;
  char* sq = stage;
  char* sx = stage + BQ * kQRow;
  if (vec) {
    constexpr int QSEG = BK * 4 / 16;            // 16-byte pieces of a q row
    for (int e = tid; e < BQ * QSEG; e += kThreads) {
      const int r = e / QSEG, s = e % QSEG, gq = qb + r, gd = d0 + s * 4;
      const bool ok = gq < B && gd < D;
      cp_async16(sq + r * kQRow + s * 16, ok ? q + (long long)gq * D + gd : q,
                 ok ? 16 : 0);
    }
    constexpr int EPS = 16 / sizeof(R);          // codes per piece
    constexpr int XSEG = BK / EPS;
    for (int e = tid; e < BN * XSEG; e += kThreads) {
      const int r = e / XSEG, s = e % XSEG, gn = n0 + r, gd = d0 + s * EPS;
      const bool ok = gn < n_hi && gd < D;
      const R* src = reinterpret_cast<const R*>(x);
      cp_async16(sx + r * Code<T>::row + s * 16,
                 ok ? src + (long long)gn * D + gd : src, ok ? 16 : 0);
    }
  } else {
    for (int e = tid; e < BQ * BK; e += kThreads) {
      const int r = e / BK, c = e % BK, gq = qb + r, gd = d0 + c;
      reinterpret_cast<float*>(sq + r * kQRow)[c] =
          (gq < B && gd < D) ? q[(long long)gq * D + gd] : 0.f;
    }
    const R* src = reinterpret_cast<const R*>(x);
    for (int e = tid; e < BN * BK; e += kThreads) {
      const int r = e / BK, c = e % BK, gn = n0 + r, gd = d0 + c;
      reinterpret_cast<R*>(sx + r * Code<T>::row)[c] =
          (gn < n_hi && gd < D) ? src[(long long)gn * D + gd] : R(0);
    }
  }
}

template <typename T, int KMAX>
__global__ void __launch_bounds__(Tile<KMAX>::kThreads, 1)
l2_topk_kernel(const float* __restrict__ q, const T* __restrict__ x,
               const float* __restrict__ xsq, float* __restrict__ out_d,
               int* __restrict__ out_i, int B, int N, int D, int K,
               int rows_per_split, bool vec) {
  using R = typename Code<T>::raw;
  constexpr int BQ = Tile<KMAX>::BQ, kThreads = Tile<KMAX>::kThreads;
  constexpr bool kSplitX = sizeof(R) == 4;  // only f32 codes have a lo part
  extern __shared__ __align__(16) char smem[];
  // What a query owns lies along its own column (index + j * BQ), so the
  // thread that merges query r reads and writes bank r % 32 only.
  char* ring = smem;                                             // kStages slots
  unsigned* mask = reinterpret_cast<unsigned*>(smem + kStages * slot_bytes<T, BQ>());  // [kMaskWords][BQ]
  float* ld = reinterpret_cast<float*>(mask + kMaskWords * BQ);  // [K][BQ]
  int* li = reinterpret_cast<int*>(ld + K * BQ);                 // [K][BQ]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;         // mma fragment coordinates
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int qb = blockIdx.x * BQ;
  const int n_lo = blockIdx.y * rows_per_split;
  const int n_hi = min(N, n_lo + rows_per_split);
  const int nk = (D + BK - 1) / BK;
  const int ntile = n_hi > n_lo ? (n_hi - n_lo + BN - 1) / BN : 0;
  const int steps = ntile * nk;

  for (int e = tid; e < BQ * K; e += kThreads) { ld[e] = inf_f(); li[e] = -1; }

  auto prefetch = [&](int s) {
    if (s < steps)
      load_stage<T, BQ, kThreads>(ring + (s % kStages) * slot_bytes<T, BQ>(), q, x, qb,
                    n_lo + (s / nk) * BN, n_hi, (s % nk) * BK, B, D, vec, tid);
    cp_async_commit();
  };
  for (int s = 0; s < kStages - 1; ++s) prefetch(s);

  float acc[MT][NT][4];
  float xs[NT][2];  // x_sqnorm of this thread's 8 columns of the tile

  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kStages - 2>();   // step s has landed (this thread's part)
    __syncthreads();                // everyone's part; slot s-1 is free
    prefetch(s + kStages - 1);
    const int kc = s % nk, n0 = n_lo + (s / nk) * BN;
    if (kc == 0) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int gn = n0 + wn * WN + j * 8 + 2 * t + e;
          xs[j][e] = gn < n_hi ? __ldg(xsq + gn) : inf_f();
        }
    }

    char* stage = ring + (s % kStages) * slot_bytes<T, BQ>();
    const float* sq = reinterpret_cast<const float*>(stage) + (wm * WM + g) * (kQRow / 4);
    const R* sx = reinterpret_cast<const R*>(stage + BQ * kQRow +
                                             (wn * WN + g) * Code<T>::row);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t ahi[MT][4], alo[MT][4], bhi[NT][2], blo[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        // The 8 k-slots of an mma hold values kk + (0, 2, 4, 6, 1, 3, 5, 7)
        // in A and in B alike: slot t takes value 2t and slot t+4 value
        // 2t+1, so a lane loads both with one access. The products summed
        // are the same.
        const float* p = sq + i * 16 * (kQRow / 4) + kk + 2 * t;
        float r0, r1, r8, r9;  // rows g and g+8
        pair_f(p, r0, r1);
        pair_f(p + 8 * (kQRow / 4), r8, r9);
        // a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
        split(r0, ahi[i][0], alo[i][0]);
        split(r8, ahi[i][1], alo[i][1]);
        split(r1, ahi[i][2], alo[i][2]);
        split(r9, ahi[i][3], alo[i][3]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        // b0 (k = t, n = g), b1 (k = t+4, n = g); row n of the x chunk
        const R* p = sx + j * 8 * (Code<T>::row / (int)sizeof(R)) + kk + 2 * t;
        float v0, v1;
        pair_f(p, v0, v1);
        if constexpr (kSplitX) {
          split(v0, bhi[j][0], blo[j][0]);
          split(v1, bhi[j][1], blo[j][1]);
        } else {  // exact in TF32
          bhi[j][0] = __float_as_uint(v0);
          bhi[j][1] = __float_as_uint(v1);
        }
      }
      // Pass-major, so that 16 independent products separate two that
      // accumulate into the same registers; the small terms go first.
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], alo[i], bhi[j]);
      if constexpr (kSplitX) {
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], ahi[i], blo[j]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], ahi[i], bhi[j]);
    }
    if (kc != nk - 1) continue;

    // Tile done: distances in registers, filtered against each query's
    // running k-th; survivors go to dist, the slot this step consumed
    // ([BN][BQ] f32), with a bit in their query's mask. The slot is refilled
    // only after the next step's barrier, which the merge comes before.
    __syncthreads();
    float* dist = reinterpret_cast<float*>(stage);
    unsigned any = 0;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wm * WM + i * 16 + h * 8 + g;
        const float kth = qb + row < B ? ld[(K - 1) * BQ + row] : -inf_f();
        unsigned bits = 0;
        if (K == 1) {
          // A list of one can take only the best of the warp's 32 columns
          // (the lowest on a tie), as k-means assignment asks: keep that.
          float bd = inf_f();
          int bc = 0;
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float d = xs[j][e] - 2.f * acc[i][j][h * 2 + e];
              if (d < bd) { bd = d; bc = j * 8 + 2 * t + e; }
            }
#pragma unroll
          for (int off = 1; off < 4; off <<= 1) {
            const float od = __shfl_xor_sync(kFull, bd, off);
            const int oc = __shfl_xor_sync(kFull, bc, off);
            if (od < bd || (od == bd && oc < bc)) { bd = od; bc = oc; }
          }
          if (bd < kth) {
            bits = 1u << bc;
            if (t == 0) dist[(wn * WN + bc) * BQ + row] = bd;
          }
        } else {
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float d = xs[j][e] - 2.f * acc[i][j][h * 2 + e];
              if (d < kth) {
                const int col = j * 8 + 2 * t + e;
                dist[(wn * WN + col) * BQ + row] = d;
                bits |= 1u << col;
              }
            }
          bits |= __shfl_xor_sync(kFull, bits, 1);
          bits |= __shfl_xor_sync(kFull, bits, 2);
        }
        if (t == 0) mask[wn * BQ + row] = bits;
        any |= bits;
      }
    if (!__syncthreads_or(any != 0)) continue;
    // Thread r merges query r: its survivors in ascending row order, each
    // inserted after the entries <= it by one pass down the list, so a tie
    // keeps the lower row first. A pass loads 8 entries ahead of the
    // stores that shift them. The lanes of a warp take their next survivors
    // together and make the same K-step pass without branching (a lane with
    // nothing to insert rewrites its list as it is), so they never make it
    // one after another.
    if (tid < BQ) {
      const bool mine = qb + tid < B;
      float* L = ld + tid;
      int* I = li + tid;
      float kth = mine ? L[(K - 1) * BQ] : -inf_f();
      int w = 0;
      unsigned bits = mine ? mask[tid] : 0u;
      for (;;) {
        while (!bits && w + 1 < kMaskWords) {
          ++w;
          if (mine) bits = mask[w * BQ + tid];
        }
        if (!__any_sync(kFull, bits != 0)) break;
        float d = inf_f();
        int col = 0;
        if (bits) {
          col = w * 32 + __ffs(bits) - 1;
          bits &= bits - 1;
          d = dist[col * BQ + tid];
        }
        const bool ins = d < kth;
        if (!__any_sync(kFull, ins)) continue;
        const int id = n0 + col;
        float cur = L[(K - 1) * BQ];  // L[j] and I[j] before the pass reaches j
        int cur_i = I[(K - 1) * BQ];
        for (int j0 = K - 1; j0 > 0; j0 -= 8) {
          float p[8];
          int pi[8];
#pragma unroll
          for (int u = 0; u < 8; ++u)
            if (j0 - u > 0) { p[u] = L[(j0 - u - 1) * BQ]; pi[u] = I[(j0 - u - 1) * BQ]; }
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int j = j0 - u;
            if (j <= 0) break;
            // Shift the entry above down, put d here, or keep: stored
            // either way, so the lanes do not branch apart.
            const bool shift = ins && p[u] > d, put = ins && !shift && cur > d;
            L[j * BQ] = shift ? p[u] : put ? d : cur;
            I[j * BQ] = shift ? pi[u] : put ? id : cur_i;
            cur = p[u];
            cur_i = pi[u];
          }
        }
        const bool put = ins && cur > d;
        L[0] = put ? d : cur;
        I[0] = put ? id : cur_i;
        if (ins) kth = L[(K - 1) * BQ];
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int e = tid; e < BQ * K; e += kThreads) {
    const int ql = e % BQ, j = e / BQ, gq = qb + ql;
    if (gq < B) {
      const long long at = ((long long)blockIdx.y * B + gq) * K + j;
      out_d[at] = ld[e];
      out_i[at] = li[e];
    }
  }
}

// One warp per query: merge the nsplit ascending lists [nsplit, B, K] in
// range order (range s holds only rows below range s+1's). K <= KMAX.
template <int KMAX>
__global__ void __launch_bounds__(256)
l2_merge_kernel(const float* __restrict__ part_d, const int* __restrict__ part_i,
                float* __restrict__ out_d, int* __restrict__ out_i, int B, int K,
                int nsplit) {
  __shared__ float lds[8][KMAX];
  __shared__ int lis[8][KMAX];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * 8 + warp;
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
        warp_insert<KMAX / 32>(L, I, K, __shfl_sync(kFull, d, src),
                             __shfl_sync(kFull, id, src), lane);
      }
    }
  }
  for (int j = lane; j < K; j += 32) {
    out_d[(long long)b * K + j] = L[j];
    out_i[(long long)b * K + j] = I[j];
  }
}

template <typename T, int KMAX>
cudaError_t launch(const float* q, const void* x, const float* xsq, float* out_d,
                   int* out_i, float* part_d, int* part_i, int B, int N, int D, int K,
                   int nsplit, cudaStream_t stream) {
  constexpr int BQ = Tile<KMAX>::BQ;
  const size_t smem = static_cast<size_t>(kStages) * slot_bytes<T, BQ>() +
                      sizeof(unsigned) * kMaskWords * BQ +
                      (sizeof(float) + sizeof(int)) * K * BQ;
  cudaError_t e = cudaFuncSetAttribute(l2_topk_kernel<T, KMAX>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  // 16-byte copies need 16-byte rows (of q and of x) at 16-byte addresses.
  const bool vec = D % 4 == 0 && (D * sizeof(typename Code<T>::raw)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int tiles = (N + BN - 1) / BN;
  const int rows_per_split = (tiles + nsplit - 1) / nsplit * BN;
  const dim3 grid((B + BQ - 1) / BQ, nsplit);
  float* td = nsplit > 1 ? part_d : out_d;
  int* ti = nsplit > 1 ? part_i : out_i;
  l2_topk_kernel<T, KMAX><<<grid, Tile<KMAX>::kThreads, smem, stream>>>(
      q, static_cast<const T*>(x), xsq, td, ti, B, N, D, K, rows_per_split, vec);
  e = cudaGetLastError();
  if (e != cudaSuccess || nsplit == 1) return e;
  l2_merge_kernel<KMAX><<<(B + 7) / 8, 256, 0, stream>>>(part_d, part_i, out_d, out_i,
                                                         B, K, nsplit);
  return cudaGetLastError();
}

// The smallest k bucket that holds K.
template <typename T>
cudaError_t launch_k(const float* q, const void* x, const float* xsq, float* out_d,
                     int* out_i, float* part_d, int* part_i, int B, int N, int D, int K,
                     int nsplit, cudaStream_t stream) {
  if (K <= 64)
    return launch<T, 64>(q, x, xsq, out_d, out_i, part_d, part_i, B, N, D, K, nsplit,
                         stream);
  return launch<T, 128>(q, x, xsq, out_d, out_i, part_d, part_i, B, N, D, K, nsplit,
                        stream);
}

constexpr int kMaxK = 128;  // the largest k bucket

}  // namespace

// The block tile for lists of k entries (1 <= k <= kMaxK): queries and
// database rows per block of l2_topk_kernel.
extern "C" void l2_topk_tiles(int k, int* queries, int* rows) {
  *queries = k <= 64 ? Tile<64>::BQ : Tile<128>::BQ;
  *rows = BN;
}

// x_dtype: 0 float32, 1 bfloat16, 2 int8. nsplit: database ranges over
// grid.y (an empty range yields an all-(+inf, -1) list, which the merge
// ignores). part_d/part_i: [nsplit, B, K] scratch, unused when nsplit == 1.
// Returns cudaGetLastError() after the launches.
extern "C" int l2_topk_launch(const float* q, const void* x, int x_dtype,
                              const float* xsq, float* out_d, int* out_i,
                              float* part_d, int* part_i, int B, int N, int D,
                              int K, int nsplit, cudaStream_t stream) {
  if (B <= 0) return 0;
  if (K < 1 || K > kMaxK || N < 1 || D < 1 || nsplit < 1 || nsplit > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (x_dtype) {
    case 0: return launch_k<float>(q, x, xsq, out_d, out_i, part_d, part_i, B, N, D, K,
                                   nsplit, stream);
    case 1: return launch_k<__nv_bfloat16>(q, x, xsq, out_d, out_i, part_d, part_i, B, N,
                                           D, K, nsplit, stream);
    case 2: return launch_k<int8_t>(q, x, xsq, out_d, out_i, part_d, part_i, B, N, D, K,
                                    nsplit, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
