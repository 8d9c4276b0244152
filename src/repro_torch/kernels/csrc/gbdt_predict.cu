// Batched inference over a complete-binary-tree GBDT ensemble (DARTH's
// recall predictor) for Hopper (sm_90a). out[b] = sum over trees of the
// leaf reached by x[b]; the wrapper adds the ensemble's base. A row goes
// right iff feat >= 0 and x[max(feat, 0)] > thr: thr = +inf and feat = -1
// both send it left.
//
// Replaces: src/repro/kernels/gbdt_predict.py::_gbdt_kernel
//           (launched by gbdt_predict_padded; ops.gbdt_predict).
//
// What bounds it on the H100. The work is B * T * (2 depth + 1) table
// lookups (per tree and level a node record and the feature it names, then
// one leaf) over an ensemble of ~76 KB (100 trees of depth 6), on B rows of
// 11 features. Two figures bound it:
//  * small B (DARTH's search: 1000 rows; a fit batch: 256): the launch, the
//    round trip that stages the tables from L2, and the lookups of the few
//    SMs that hold rows (one block per 32 rows);
//  * large B (the fit's hold-out, ~200,000 rows): the rate at which the
//    SMs serve lookups from shared memory, 32 per clock per SM; at 132 SMs
//    and 1,980 MHz that is B * T * 13 / 8.4e12 s, ~0.03 ms at 200,000.
// Bytes (76 KB + 48 B a row over 3.35 TB/s) bound neither.
//
// What the design does about them:
//  * The tables live in dynamic shared memory. A block stages a chunk of
//    trees once, packing each node's (feature, threshold) into one 8-byte
//    record (feature -1 becomes feature 0 with threshold +inf, and the
//    feature index is premultiplied by the x tile's stride), so a level
//    costs one record load and one feature load. Leaves sit after the
//    records. Leaves and the x tile are copied with cp.async while the
//    records pass through registers, so staging is one round trip to L2.
//    Up to 227 KB a block, after cudaFuncSetAttribute.
//  * Thread = row, and all lanes of a warp walk the same tree at the same
//    time: at level l they read among the 2^l records of one tree, a
//    broadcast at the top and at most 256 contiguous bytes at depth 5,
//    instead of 32 trees' records at once. Each thread walks up to four
//    trees together so that their dependent loads overlap.
//  * The x tile is staged transposed, xs[f * R + row], R a multiple of 32:
//    whatever feature each lane asks for, the 32 lanes hit 32 banks.
//  * The grid fills the card as far as the rows allow. With few rows a
//    block takes 32 of them and splits the trees over its 32 warps (tree
//    slices), which add their partial sums in slice order through shared
//    memory; with many rows a block takes 1024 rows a tile, one tree slice,
//    and loops over tiles, the tables staged once. (Splitting a row block's
//    trees further, over a cluster of blocks that add through distributed
//    shared memory, spreads the lookups over more SMs but was slower on the
//    H100: its cluster barriers cost more than the lookups they spread.)
//  * Ensembles too large for one block's shared memory are staged chunk by
//    chunk; a tree too large by itself (depth >= 14 or so) is read from
//    device memory by the same kernel, and so is x when its tile would not
//    fit (hundreds of features). No floating-point atomics: the sum over
//    trees has a fixed order, so two calls give bit-equal outputs.
#include <cuda_runtime.h>
#include <math_constants.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxDevices = 64;
// Node records a thread loads before its first store when staging, so that
// one round trip to L2 stages kBatch * kThreads of them.
constexpr int kBatch = 8;

struct Args {
  const float* x;
  const int* feat;
  const float* thresh;
  const float* leaf;
  float* out;
  int B, F, T, depth;
  int rows_tile;       // R: rows of one tile, a power of two in [32, kThreads]
  int chunk;           // trees staged at once (0: read from device memory)
  int rows_per_block;  // rows of one block, a multiple of 32
};

// Sum of the leaves reached by this thread's row in trees t .. t + U - 1.
// A record holds the feature's offset in the x tile (or row) and the
// threshold; the descent goes right iff x > threshold.
template <bool kTreeSmem, bool kXSmem, int U>
__device__ __forceinline__ float descend(const Args& a, const int2* rec,
                                         const float* lv, const float* xs,
                                         const float* xrow, int r, int t,
                                         int c0) {
  const int n_int = (1 << a.depth) - 1;
  const int n_leaf = 1 << a.depth;
  int node[U];
#pragma unroll
  for (int u = 0; u < U; ++u) node[u] = 0;
  for (int l = 0; l < a.depth; ++l) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      int off;
      float thr;
      if constexpr (kTreeSmem) {
        const int2 e = rec[(t + u - c0) * n_int + node[u]];
        off = e.x;
        thr = __int_as_float(e.y);
      } else {
        const size_t i = static_cast<size_t>(t + u) * n_int + node[u];
        const int f = __ldg(a.feat + i);
        off = max(f, 0) * (kXSmem ? a.rows_tile : 1);
        thr = f < 0 ? CUDART_INF_F : __ldg(a.thresh + i);
      }
      const float xv = kXSmem ? xs[off + r] : __ldg(xrow + off);
      node[u] = 2 * node[u] + 1 + (xv > thr ? 1 : 0);
    }
  }
  float s = 0.f;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int j = node[u] - n_int;
    s += kTreeSmem
             ? lv[(t + u - c0) * n_leaf + j]
             : __ldg(a.leaf + static_cast<size_t>(t + u) * n_leaf + j);
  }
  return s;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes from global to shared without a register; zero where !valid
// (src must still be a valid address).
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

template <bool kTreeSmem, bool kXSmem>
__global__ void __launch_bounds__(kThreads, 1) gbdt_predict_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int R = a.rows_tile;
  const int S = kThreads / R;  // tree slices
  const int lg_r = __ffs(R) - 1;
  const int r = threadIdx.x & (R - 1);
  const int s = threadIdx.x >> lg_r;
  const int n_int = (1 << a.depth) - 1;
  const int n_leaf = 1 << a.depth;
  const int chunk = kTreeSmem ? a.chunk : a.T;
  const int nchunks = (a.T + chunk - 1) / chunk;
  int2* rec = reinterpret_cast<int2*>(smem);
  float* lv = reinterpret_cast<float*>(rec + (kTreeSmem ? chunk * n_int : 0));
  float* xs = lv + (kTreeSmem ? chunk * n_leaf : 0);
  float* red = xs + (kXSmem ? a.F * R : 0);  // kThreads floats if S > 1
  const int row_begin = blockIdx.x * a.rows_per_block;
  const int row_end = min(a.B, row_begin + a.rows_per_block);

  for (int t0 = row_begin; t0 < row_end; t0 += R) {
    const int row = t0 + r;
    // Warps whose 32 rows all lie past the block's range skip the descent.
    const bool warp_live = t0 + (r & ~31) < row_end;
    if constexpr (kXSmem) {  // in flight while the trees are staged
      for (int i = threadIdx.x; i < a.F * R; i += kThreads) {
        const int rr = i & (R - 1);
        const bool in = t0 + rr < row_end;
        cp_async4(xs + i,
                  a.x + (in ? static_cast<size_t>(t0 + rr) * a.F + (i >> lg_r) : 0),
                  in);
      }
    }
    const float* xrow = a.x + static_cast<size_t>(min(row, a.B - 1)) * a.F;
    float acc = 0.f;
    for (int c = 0; c < nchunks; ++c) {
      const int c0 = c * chunk;
      const int cn = min(chunk, a.T - c0);
      if (kTreeSmem && (nchunks > 1 || t0 == row_begin)) {
        const int* fg = a.feat + static_cast<size_t>(c0) * n_int;
        const float* tg = a.thresh + static_cast<size_t>(c0) * n_int;
        const float* lg = a.leaf + static_cast<size_t>(c0) * n_leaf;
        for (int i = threadIdx.x; i < cn * n_leaf; i += kThreads)
          cp_async4(lv + i, lg + i, true);
        const int mul = kXSmem ? R : 1;
        const int n_rec = cn * n_int;
        for (int i0 = threadIdx.x; i0 < n_rec; i0 += kThreads * kBatch) {
          int f[kBatch];
          float th[kBatch];
#pragma unroll
          for (int k = 0; k < kBatch; ++k) {
            const int i = i0 + k * kThreads;
            f[k] = i < n_rec ? __ldg(fg + i) : 0;
            th[k] = i < n_rec ? __ldg(tg + i) : 0.f;
          }
#pragma unroll
          for (int k = 0; k < kBatch; ++k) {
            const int i = i0 + k * kThreads;
            if (i < n_rec)
              rec[i] = make_int2(f[k] < 0 ? 0 : f[k] * mul,
                                 __float_as_int(f[k] < 0 ? CUDART_INF_F : th[k]));
          }
        }
      }
      cp_async_wait_all();
      __syncthreads();
      if (warp_live) {
        // Slice s walks trees [lo, hi) of this chunk.
        const int lo = c0 + s * cn / S;
        const int hi = c0 + (s + 1) * cn / S;
        int t = lo;
        for (; t + 4 <= hi; t += 4)
          acc += descend<kTreeSmem, kXSmem, 4>(a, rec, lv, xs, xrow, r, t, c0);
        switch (hi - t) {  // the last 1-3 trees, also walked together
          case 3:
            acc += descend<kTreeSmem, kXSmem, 3>(a, rec, lv, xs, xrow, r, t, c0);
            break;
          case 2:
            acc += descend<kTreeSmem, kXSmem, 2>(a, rec, lv, xs, xrow, r, t, c0);
            break;
          case 1:
            acc += descend<kTreeSmem, kXSmem, 1>(a, rec, lv, xs, xrow, r, t, c0);
            break;
        }
      }
      if (kTreeSmem && nchunks > 1) __syncthreads();  // before restaging
    }
    // Sum the slices in slice order.
    float v = acc;
    if (S > 1) {
      red[threadIdx.x] = acc;  // = red[s * R + r]
      __syncthreads();
      if (s == 0) {
#pragma unroll 8
        for (int k = 1; k < S; ++k) v += red[k * R + r];
      }
    }
    if (s == 0 && row < row_end) a.out[row] = v;
    __syncthreads();  // xs and red are reused by the next tile
  }
}

struct Plan {
  int rows_tile, slices, chunk, nchunks, tree_smem, x_smem, grid,
      rows_per_block;
  size_t smem;
};

// The current card's SM count and per-block shared-memory limit (opt-in).
int device_limits(int* sms, int* smem_max) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  return static_cast<int>(e);
}

int make_plan(int B, int F, int T, int depth, Plan* p) {
  if (B < 1 || depth < 1 || depth > 24 || T < 1 || F < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0, smem_max = 0;
  const int rc = device_limits(&sms, &smem_max);
  if (rc != 0) return rc;
  // Rows per tile: the fewest (from 32) that need at most one block per SM;
  // the other warps of the block split the trees.
  const long long b = B;
  int R = 32;
  while (R < kThreads && (b + R - 1) / R > sms) R *= 2;
  p->rows_tile = R;
  p->slices = kThreads / R;
  // Rows spread evenly over at most one block per SM.
  const long long grid = std::min<long long>((b + R - 1) / R, sms);
  p->rows_per_block = static_cast<int>(((b + grid - 1) / grid + 31) / 32 * 32);
  p->grid = static_cast<int>((b + p->rows_per_block - 1) / p->rows_per_block);
  const size_t xbytes = 4 * static_cast<size_t>(F) * R;
  p->x_smem = xbytes <= static_cast<size_t>(smem_max) / 2;
  const size_t fixed = (p->x_smem ? xbytes : 0) + (p->slices > 1 ? 4 * kThreads : 0);
  const size_t per_tree = 8 * ((size_t{1} << depth) - 1) + 4 * (size_t{1} << depth);
  const size_t fit = (static_cast<size_t>(smem_max) - fixed) / per_tree;
  p->tree_smem = fit >= 1;
  p->nchunks = p->tree_smem ? static_cast<int>((T + fit - 1) / fit) : 1;
  p->chunk = p->tree_smem ? (T + p->nchunks - 1) / p->nchunks : 0;
  p->smem = fixed + (p->tree_smem ? p->chunk * per_tree : 0);
  return 0;
}

template <bool kTreeSmem, bool kXSmem>
int launch(const Args& a, const Plan& p, cudaStream_t stream) {
  auto kernel = gbdt_predict_kernel<kTreeSmem, kXSmem>;
  // The opt-in above 48 KB, once per device and variant.
  static int raised[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices || !raised[dev]) {
    int smem_max = 0, sms = 0;
    const int rc = device_limits(&sms, &smem_max);
    if (rc != 0) return rc;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_max);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < kMaxDevices) raised[dev] = 1;
  }
  kernel<<<p.grid, kThreads, p.smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The launch's choices for B rows of F features and T trees of this depth,
// written to out[9]: rows per tile, tree slices per block, trees per staged
// chunk (0 when trees are read from device memory), chunks, trees staged
// (0/1), x staged (0/1), blocks, rows per block, dynamic shared memory in
// bytes.
extern "C" int gbdt_predict_plan(int B, int F, int T, int depth, int* out) {
  Plan p;
  const int rc = make_plan(B, F, T, depth, &p);
  if (rc != 0) return rc;
  const int v[9] = {p.rows_tile, p.slices, p.chunk, p.nchunks, p.tree_smem,
                    p.x_smem, p.grid, p.rows_per_block, static_cast<int>(p.smem)};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return 0;
}

// x f32[B, F]; feat i32[T, 2^depth - 1] with every entry < F; thresh
// f32[T, 2^depth - 1]; leaf f32[T, 2^depth]; out f32[B]. Returns
// cudaGetLastError() after the launch.
extern "C" int gbdt_predict_launch(const float* x, const int* feat,
                                   const float* thresh, const float* leaf,
                                   float* out, int B, int F, int T, int depth,
                                   cudaStream_t stream) {
  if (B <= 0) return 0;
  Plan p;
  const int rc = make_plan(B, F, T, depth, &p);
  if (rc != 0) return rc;
  const Args a{x, feat, thresh, leaf, out, B, F, T, depth,
               p.rows_tile, p.chunk, p.rows_per_block};
  if (p.tree_smem)
    return p.x_smem ? launch<true, true>(a, p, stream) : launch<true, false>(a, p, stream);
  return p.x_smem ? launch<false, true>(a, p, stream) : launch<false, false>(a, p, stream);
}
