// Sparse neighbour mixing over padded neighbour tiles, for Hopper (sm_90a).
//
//   Y[r, :] = sum_k w[r, k] * Theta[idx[r, k], :]        (float32 accumulate)
//
// Replaces the Pallas TPU kernel src/repro/kernels/sparse_mix.py::sparse_mix
// (body _sparse_mix_kernel). With R = B rows it is the woken rows'
// neighbour sums of one engine super-tick (MixOp.gather_rows, the unfused
// slot); with R = n it is the full sparse neighbour sum (MixOp.all).
// Pad entries of a row point at any valid row with weight 0.
//
// What bounds it on the H100: bytes. Each output element costs one
// multiply-add per neighbour against four bytes of a gathered neighbour
// row, about 0.5 flop per byte, far below the ~20 float32 flop per byte
// where the card's compute would become the limit. The time is the
// gathered Theta rows (at most R * K * p * 4 bytes, fewer distinct ones
// when neighbourhoods overlap) plus the (R, K) tables and the (R, p)
// output, over HBM bandwidth.
//
// What the design does about it: the Pallas kernel keeps the whole
// (n, bp) Theta slab in VMEM; here Theta stays in HBM (0.2 GB at the main
// path's n = 500k, p = 100) and each warp gathers the neighbour rows of
// one output row, its 32 lanes running along p, so every neighbour row is
// read as whole 128-byte lines and neighbour rows shared between output
// rows come from L2. A row's (idx, w) pairs are read once per 32
// neighbours, one per lane, and broadcast with shuffles; the sums stay in
// registers (8 columns a lane, p in passes of 256). Warps of rows past R
// in the last block leave at once: grid padding is masked, not clamped.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kColsPerLane = 8;
constexpr int kPassP = 32 * kColsPerLane;  // columns per pass over a row's neighbours
constexpr unsigned kFullMask = 0xffffffffu;

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
sparse_mix_kernel(const int* __restrict__ idx, const float* __restrict__ w,
                  const float* __restrict__ theta, float* __restrict__ out,
                  int R, int K, int p) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r >= R) return;  // the whole warp leaves together, so shuffles stay full
  const int* idx_r = idx + (size_t)r * K;
  const float* w_r = w + (size_t)r * K;
  float* out_r = out + (size_t)r * p;
  for (int c0 = 0; c0 < p; c0 += kPassP) {
    float acc[kColsPerLane];
#pragma unroll
    for (int u = 0; u < kColsPerLane; ++u) acc[u] = 0.f;
    for (int k0 = 0; k0 < K; k0 += 32) {
      const int kl = k0 + lane;
      const int j_lane = kl < K ? idx_r[kl] : 0;
      const float w_lane = kl < K ? w_r[kl] : 0.f;
      const int kn = min(32, K - k0);
      for (int t = 0; t < kn; ++t) {
        const int j = __shfl_sync(kFullMask, j_lane, t);
        const float wk = __shfl_sync(kFullMask, w_lane, t);
        const float* src = theta + (size_t)j * p + c0;
#pragma unroll
        for (int u = 0; u < kColsPerLane; ++u) {
          const int c = u * 32 + lane;
          if (c0 + c < p) acc[u] = fmaf(wk, __ldg(src + c), acc[u]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kColsPerLane; ++u) {
      const int c = c0 + u * 32 + lane;
      if (c < p) out_r[c] = acc[u];
    }
  }
}

}  // namespace

extern "C" int sparse_mix_launch(const int* idx, const float* w, const float* theta,
                                 float* out, int R, int K, int p, void* stream) {
  if (R <= 0 || p <= 0) return 0;
  const dim3 grid((R + kWarpsPerBlock - 1) / kWarpsPerBlock);
  sparse_mix_kernel<<<grid, 32 * kWarpsPerBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      idx, w, theta, out, R, K, p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
