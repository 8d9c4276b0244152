// Batched inference over a complete-binary-tree GBDT ensemble (DARTH's
// recall predictor) for Hopper (sm_90a). out[b] = sum over trees of the
// leaf reached by x[b]; the wrapper adds the ensemble's base.
//
// Replaces: src/repro/kernels/gbdt_predict.py::_gbdt_kernel
//           (launched by gbdt_predict_padded; ops.gbdt_predict).
//
// What bounds it on the H100: launch latency. DARTH calls it once per due
// prediction with at most a few hundred rows of 11 features; the work is
// B * T * depth dependent loads (100 trees x 6 levels) and the data is the
// ~76 KB ensemble plus 44 B per row, a few microseconds at 3.35 TB/s.
//
// What the design does about it:
//  * One warp per row; lanes walk trees t = lane, lane + 32, ... and descend
//    with indexed loads (node = 2 node + 1 + go_right), then a shuffle
//    reduction sums the leaves. The TPU kernel's level-wise one-hot
//    contractions were a workaround for the TPU's lack of gathers; indexed
//    loads replace them here.
//  * The ensemble is read from global memory and left to the L1/L2 caches
//    (76 KB is above the 48 KB static shared-memory limit and every block
//    would have to stage all of it for a handful of rows).
//  * Go right iff f >= 0 and x[max(f, 0)] > thr: thresh = +inf and f = -1
//    both send a row left, as in the reference.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
gbdt_predict_kernel(const float* __restrict__ x, const int* __restrict__ feat,
                    const float* __restrict__ thresh, const float* __restrict__ leaf,
                    float* __restrict__ out, int B, int F, int T, int depth) {
  const int lane = threadIdx.x & 31;
  const int b = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  if (b >= B) return;  // whole warp
  const float* xr = x + (long long)b * F;
  const int n_int = (1 << depth) - 1;
  const int n_leaf = 1 << depth;
  float s = 0.f;
  for (int t = lane; t < T; t += 32) {
    const int* ft = feat + (long long)t * n_int;
    const float* tt = thresh + (long long)t * n_int;
    int node = 0;
    for (int l = 0; l < depth; ++l) {
      const int f = __ldg(ft + node);
      const float xv = __ldg(xr + max(f, 0));
      node = 2 * node + 1 + ((f >= 0 && xv > __ldg(tt + node)) ? 1 : 0);
    }
    s += __ldg(leaf + (long long)t * n_leaf + node - n_int);
  }
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  if (lane == 0) out[b] = s;
}

}  // namespace

// x f32[B, F]; feat i32[T, 2^depth - 1] with every entry < F; thresh
// f32[T, 2^depth - 1]; leaf f32[T, 2^depth]; out f32[B]. Returns
// cudaGetLastError() after the launch.
extern "C" int gbdt_predict_launch(const float* x, const int* feat,
                                   const float* thresh, const float* leaf,
                                   float* out, int B, int F, int T, int depth,
                                   cudaStream_t stream) {
  if (B <= 0) return 0;
  if (depth < 1 || depth > 24 || T < 1 || F < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows_per_block = kThreads / 32;
  gbdt_predict_kernel<<<(B + rows_per_block - 1) / rows_per_block, kThreads, 0, stream>>>(
      x, feat, thresh, leaf, out, B, F, T, depth);
  return static_cast<int>(cudaGetLastError());
}
