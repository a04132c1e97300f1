// Sparse neighbour mixing over padded neighbour tiles, for Hopper (sm_90a).
//
//   Y[r, :] = sum_k w[r, k] * Theta[idx[r, k], :]        (float32 accumulate)
//
// Replaces the Pallas TPU kernel src/repro/kernels/sparse_mix.py::sparse_mix
// (body _sparse_mix_kernel). With R = B rows it is the woken rows'
// neighbour sums of one engine super-tick (MixOp.gather_rows, the unfused
// slot); with R = n it is the full sparse neighbour sum (MixOp.all,
// synchronous_round). Pad entries of a row point at any valid row with
// weight 0.
//
// What bounds it on the H100: bytes. Each output element costs one
// multiply-add per neighbour against four bytes of a gathered neighbour
// row, about 0.5 flop per byte, far below the ~20 float32 flop per byte
// where the card's compute would become the limit. The least time counts
// each distinct Theta row read once, plus the (R, K) tables and the
// (R, p) output. What the access pattern allows is further out: at
// R = n = 500k the neighbour rows of a random geometric graph, numbered in
// random order, are scattered over a 200 MB slab that the 50 MB L2 cannot
// hold, so each real entry's row (400 bytes at p = 100) comes from HBM
// about once per use.
//
// What the design does about it: one warp per output row, lanes along p.
// - Only the real entries are walked. A row's (idx, w) pairs are read 32
//   at a time, one per lane (the next 32 are loaded before the current
//   ones are walked), and __ballot_sync(w != 0) gives the warp one mask;
//   the warp walks its set bits in ascending k with __ffs. The padding
//   (58% of the entries at average degree 16 and K = 38) costs no load.
//   Skipping a weight-0 term leaves every sum over finite Theta as it was:
//   fmaf(0, x, acc) == acc.
// - Up to kUnroll = 8 real neighbours' rows are loaded before any is
//   multiplied, so a warp keeps 8 rows in flight; the FMAs then run in the
//   same ascending k order, so each output is one fixed chain: a second
//   launch gives the same bits. No atomics.
// - When p % 4 == 0 and Theta starts on a 16-byte boundary each lane loads
//   a float4 (a p = 100 row is one instruction over 25 lanes); otherwise a
//   scalar instance of the same kernel loads 4 floats a lane 32 apart. The
//   wrapper picks the instance. Columns go in passes of 128.
// Warps of rows past R in the last block leave at once: grid padding is
// masked, not clamped.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kUnroll = 8;       // neighbour rows in flight per warp
constexpr int kPassCols = 128;   // columns per pass: 4 a lane
constexpr unsigned kFullMask = 0xffffffffu;

template <bool VEC>
__device__ __forceinline__ float4 load_cols(const float* __restrict__ row, int c0, int lane,
                                            int p) {
  if (VEC) {
    const int c = c0 + lane * 4;
    return c < p ? __ldg(reinterpret_cast<const float4*>(row + c))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int c = c0 + q * 32 + lane;
    v[q] = c < p ? __ldg(row + c) : 0.f;
  }
  return make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void fma4(float4& acc, float w, const float4& x) {
  acc.x = fmaf(w, x.x, acc.x);
  acc.y = fmaf(w, x.y, acc.y);
  acc.z = fmaf(w, x.z, acc.z);
  acc.w = fmaf(w, x.w, acc.w);
}

template <bool VEC>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
sparse_mix_kernel(const int* __restrict__ idx, const float* __restrict__ w,
                  const float* __restrict__ theta, float* __restrict__ out, int R, int K, int p) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r >= R) return;  // the whole warp leaves together, so shuffles stay full
  const int* idx_r = idx + (size_t)r * K;
  const float* w_r = w + (size_t)r * K;
  float* out_r = out + (size_t)r * p;
  for (int c0 = 0; c0 < p; c0 += kPassCols) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    int j_cur = lane < K ? __ldg(idx_r + lane) : 0;
    float w_cur = lane < K ? __ldg(w_r + lane) : 0.f;
    for (int k0 = 0; k0 < K; k0 += 32) {
      const int kn = k0 + 32 + lane;  // the next 32 pairs, in flight during this walk
      const int j_next = kn < K ? __ldg(idx_r + kn) : 0;
      const float w_next = kn < K ? __ldg(w_r + kn) : 0.f;
      unsigned live = __ballot_sync(kFullMask, w_cur != 0.f);  // warp-uniform
      while (live) {
        float wk[kUnroll];
        float4 x[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          wk[u] = 0.f;
          x[u] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (live) {
            const int b = __ffs(live) - 1;  // lowest remaining k
            live &= live - 1;
            const int j = __shfl_sync(kFullMask, j_cur, b);
            wk[u] = __shfl_sync(kFullMask, w_cur, b);
            x[u] = load_cols<VEC>(theta + (size_t)j * p, c0, lane, p);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (wk[u] != 0.f) fma4(acc, wk[u], x[u]);
      }
      j_cur = j_next;
      w_cur = w_next;
    }
    if (VEC) {
      const int c = c0 + lane * 4;
      if (c < p) *reinterpret_cast<float4*>(out_r + c) = acc;
    } else {
      const float v[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = c0 + q * 32 + lane;
        if (c < p) out_r[c] = v[q];
      }
    }
  }
}

}  // namespace

// vec: 1 for the float4 instance (p % 4 == 0, theta and out 16-byte
// aligned), 0 for the scalar one.
extern "C" int sparse_mix_launch(const int* idx, const float* w, const float* theta, float* out,
                                 int R, int K, int p, int vec, void* stream) {
  if (R <= 0 || p <= 0) return 0;
  if (vec && (p % 4 != 0 || reinterpret_cast<uintptr_t>(theta) % 16 != 0 ||
              reinterpret_cast<uintptr_t>(out) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((R + kWarpsPerBlock - 1) / kWarpsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    sparse_mix_kernel<true><<<grid, 32 * kWarpsPerBlock, 0, s>>>(idx, w, theta, out, R, K, p);
  else
    sparse_mix_kernel<false><<<grid, 32 * kWarpsPerBlock, 0, s>>>(idx, w, theta, out, R, K, p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
