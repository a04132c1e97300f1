// The fused woken-row super-tick update, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/fused_row_update.py::fused_row_update (body
// _fused_row_update_kernel). For each woken row b of one engine super-tick
// (rows[b] indexes the (nt, p) Theta slab; rows[b] >= limit is a sentinel):
//
//   th     = Theta[rows[b]]
//   neigh  = sum_k w[b, k] * Theta[idx[b, k]]
//   r_i    = 2 (x_i . th - y_i)                     for the m points of row b
//            (optionally scaled by min(1, clip / (|r_i| * |x_i|_1)))
//   grad   = sum_i mask_i r_i x_i / max(sum_i mask_i, 1) + 2 lam th + noise[b]
//   new    = (1 - alpha) th + alpha (neigh / deg - mu c grad)       (Eq. 4)
//
// with coef[b] = [alpha, deg, mu c, 2 lam], the quadratic loss only, and
// new written to Theta[rows[b]] unless rows[b] >= limit.
//
// Snapshot rule, and the choice made here: every read must see the
// start-of-slot Theta, even where one woken row is another woken row's
// neighbour. The Pallas kernel gets that by writing a separate output slab
// initialised as a copy of the input. This port updates Theta IN PLACE,
// which saves copying the whole (nt, p) slab every slot, and keeps the
// rule with two launches on one stream: fused_rows_kernel computes all B
// new rows into a (B, p) scratch while Theta is only read, then
// scatter_rows_kernel writes the rows with 0 <= rows[b] < limit. The
// valid rows of one call must be distinct (the engine's woken batch is),
// or two blocks would race for the same row.
//
// Shapes: B, m and p are taken ragged as they come (no padding to TPU
// tiles). A row's p values and its m residuals sit in shared memory, so
// p <= 1024 and m <= 2048 (kMaxP, kMaxM); the wrapper raises above them.
//
// What bounds it on the H100: bytes. Per woken row it reads its K
// neighbour rows, the row itself and its (m, p) data, and writes one row:
// about (K + m + 2) p floats against about (2 K + 4 m + 6) p flops, near
// 0.5 flop per byte. The time is those bytes over HBM bandwidth, tens of
// MB per super-tick at the main path's B = 4.5k, K = 38, m = 8, p = 100.
//
// What the design does about it: one block of 128 threads per woken row,
// threads along p, so the neighbour rows and the data rows are read as
// coalesced lines. The residual dots reduce with warp shuffles, one warp
// per data point; the gradient sum, the neighbour sum and the Eq. 4 step
// then run per column in registers. Sentinel rows leave at once and cost
// nothing. Per-row coefficients are read from coef, not baked in.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxP = 1024;
constexpr int kMaxM = 2048;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
fused_rows_kernel(const int* __restrict__ rows, const int* __restrict__ idx,
                  const float* __restrict__ w, const float* __restrict__ coef,
                  int coef_stride, const float* __restrict__ X,
                  const float* __restrict__ y, const float* __restrict__ mask,
                  const float* __restrict__ noise, const float* __restrict__ theta,
                  float* __restrict__ new_rows, int K, int m, int p, int limit,
                  float clip, int use_clip) {
  extern __shared__ float smem[];
  float* th = smem;         // (p,) the woken row at the start of the slot
  float* resid = smem + p;  // (m,) masked, clipped residuals
  __shared__ float s_mhat;

  const int b = blockIdx.x;
  const int row = rows[b];
  if (row < 0 || row >= limit) return;  // sentinel: never scattered, skip the work
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const float* th_g = theta + (size_t)row * p;
  for (int c = threadIdx.x; c < p; c += kThreads) th[c] = th_g[c];
  __syncthreads();

  const float* Xb = X + (size_t)b * m * p;
  const float* yb = y + (size_t)b * m;
  const float* mb = mask + (size_t)b * m;
  for (int i = warp; i < m; i += kWarps) {
    const float* xi = Xb + (size_t)i * p;
    float dot = 0.f, l1 = 0.f;
    for (int c = lane; c < p; c += 32) {
      const float xv = xi[c];
      dot = fmaf(xv, th[c], dot);
      l1 += fabsf(xv);
    }
    dot = warp_sum(dot);
    float r = 2.f * (dot - yb[i]);
    if (use_clip) {
      // L1 clip of the point gradient r x: |r x|_1 = |r| |x|_1.
      l1 = warp_sum(l1);
      r *= fminf(1.f, clip / fmaxf(fabsf(r) * l1, 1e-12f));
    }
    if (lane == 0) resid[i] = r * mb[i];
  }
  if (warp == 0) {
    float s = 0.f;
    for (int i = lane; i < m; i += 32) s += mb[i];
    s = warp_sum(s);
    if (lane == 0) s_mhat = fmaxf(s, 1.f);
  }
  __syncthreads();

  const float* cb = coef + (size_t)b * coef_stride;
  const float alpha = cb[0], deg = cb[1], cmu = cb[2], lam2 = cb[3];
  const float m_hat = s_mhat;
  const int* idx_b = idx + (size_t)b * K;
  const float* w_b = w + (size_t)b * K;
  for (int c = threadIdx.x; c < p; c += kThreads) {
    float neigh = 0.f;
    for (int k = 0; k < K; ++k) neigh = fmaf(w_b[k], theta[(size_t)idx_b[k] * p + c], neigh);
    float g = 0.f;
    for (int i = 0; i < m; ++i) g = fmaf(resid[i], Xb[(size_t)i * p + c], g);
    const float t = th[c];
    float grad = g / m_hat + lam2 * t;
    if (noise != nullptr) grad += noise[(size_t)b * p + c];
    new_rows[(size_t)b * p + c] = (1.f - alpha) * t + alpha * (neigh / deg - cmu * grad);
  }
}

__global__ void __launch_bounds__(kThreads)
scatter_rows_kernel(const int* __restrict__ rows, const float* __restrict__ new_rows,
                    float* __restrict__ theta, int p, int limit) {
  const int b = blockIdx.x;
  const int row = rows[b];
  if (row < 0 || row >= limit) return;
  float* dst = theta + (size_t)row * p;
  const float* src = new_rows + (size_t)b * p;
  for (int c = threadIdx.x; c < p; c += kThreads) dst[c] = src[c];
}

}  // namespace

// scratch: (B, p) float32, the new rows between the two launches.
extern "C" int fused_row_update_launch(const int* rows, const int* idx, const float* w,
                                       const float* coef, int coef_stride, const float* X,
                                       const float* y, const float* mask, const float* noise,
                                       float* theta, float* scratch, int B, int K, int m,
                                       int p, int limit, float clip, int use_clip,
                                       void* stream) {
  if (B <= 0 || p <= 0) return 0;
  if (p > kMaxP || m > kMaxM) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)(p + m) * sizeof(float);
  fused_rows_kernel<<<B, kThreads, smem, s>>>(rows, idx, w, coef, coef_stride, X, y, mask,
                                               noise, theta, scratch, K, m, p, limit, clip,
                                               use_clip);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scatter_rows_kernel<<<B, kThreads, 0, s>>>(rows, scratch, theta, p, limit);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
