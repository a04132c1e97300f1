// Fused per-example clip -> mean -> noise, for Hopper (sm_90a).
//
//   s_i    = min(1, C / max(sqrt(max(|g_i|^2, 1e-24)), 1e-12))   for each row i < N
//   out[d] = sum_i s_i g[i, d] / n_total + noise_scale * noise[d]
//
// Replaces the Pallas TPU kernel src/repro/kernels/dp_clip_noise.py::dp_clip_noise
// (bodies _norms_kernel and _clip_mean_kernel): the DP aggregation of Eq. 6
// with the per-example L2 clip of Supp. D.2. grads is (N, D) float32 or
// bfloat16, read in its own type and summed in float32; noise is (D,)
// float32 standard draws; out is (D,) float32.
//
// What bounds it on the H100: bytes. Each element of grads is read for a
// square-and-add and a multiply-add, about 4 flops against 4 bytes (2 in
// bf16), far below the card's ~20 float32 flops per byte. The least time
// is one read of grads plus the noise and the output over HBM bandwidth:
// 4.23 MB, about 1.26 us, at the (256, 4096) float32 shape of
// benchmarks/bench_kernels.py.
//
// What the design does about it. The Pallas kernel walks a sequential
// (N-block, D-block) grid twice and carries its sums in VMEM from step to
// step; here blocks run in parallel and carry nothing, so the two passes
// are two launches on one stream, with an (N,) float32 scratch between:
//
// * norms_kernel: one warp per example row. Lanes run along D, 16 bytes a
//   lane (four floats or eight bf16) where the row is 16-byte aligned, one
//   element a lane otherwise, so a warp reads whole 128-byte lines. The
//   squared norm is reduced by warp shuffles and the warp writes the row's
//   clip factor s_i.
// * clip_mean_kernel: one block per tile of kTileD columns, one column a
//   thread. The block stages the factors s_i in shared memory, kChunkN
//   rows at a time, and walks the N rows in order, each row's tile read as
//   one coalesced segment; the sum stays in a register. The last step
//   divides by n_total and adds noise_scale * noise.
//
// No atomics: every output is summed in one fixed order, so results repeat
// from run to run. Ragged N and D are masked in the kernels; nothing is
// padded. Known limit, left for later work: at (256, 4096) the second pass
// has 16 blocks for 132 SMs, so most of the card idles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNormWarps = 8;    // rows per block in the first pass
constexpr int kTileD = 256;      // columns per block (and threads) in the second pass
constexpr int kChunkN = 1024;    // clip factors staged in shared memory at a time
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Sum of squares of a 16-byte word holding 4 floats or 8 bf16.
__device__ __forceinline__ float sumsq16(const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  return v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
}
__device__ __forceinline__ float sumsq16(const __nv_bfloat16* p) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
  float s = 0.f;
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const float x = __bfloat162float(h[u]);
    s = fmaf(x, x, s);
  }
  return s;
}

template <typename T>
__global__ void __launch_bounds__(32 * kNormWarps)
norms_kernel(const T* __restrict__ g, float* __restrict__ scales, int N, int D, float clip,
             int vec) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kNormWarps + (threadIdx.x >> 5);
  if (r >= N) return;  // whole warps leave together, so the shuffles stay full
  const T* row = g + (size_t)r * D;
  float ss = 0.f;
  if (vec) {
    constexpr int kPer = 16 / sizeof(T);  // elements in one 16-byte word
    for (int c = lane * kPer; c < D; c += 32 * kPer) ss += sumsq16(row + c);
  } else {
    for (int c = lane; c < D; c += 32) {
      const float x = to_f32(row[c]);
      ss = fmaf(x, x, ss);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(kFullMask, ss, off);
  if (lane == 0) {
    const float nrm = sqrtf(fmaxf(ss, 1e-24f));
    scales[r] = fminf(1.f, clip / fmaxf(nrm, 1e-12f));
  }
}

template <typename T>
__global__ void __launch_bounds__(kTileD)
clip_mean_kernel(const T* __restrict__ g, const float* __restrict__ scales,
                 const float* __restrict__ noise, float* __restrict__ out, int N, int D,
                 float noise_scale, float n_total) {
  __shared__ float s_scale[kChunkN];
  const int c = blockIdx.x * kTileD + threadIdx.x;
  const bool live = c < D;  // masked, but every thread helps stage the factors
  float acc = 0.f;
  for (int r0 = 0; r0 < N; r0 += kChunkN) {
    const int rn = min(kChunkN, N - r0);
    __syncthreads();
    for (int i = threadIdx.x; i < rn; i += kTileD) s_scale[i] = scales[r0 + i];
    __syncthreads();
    if (live) {
      const T* col = g + (size_t)r0 * D + c;
#pragma unroll 8
      for (int i = 0; i < rn; ++i) acc = fmaf(s_scale[i], to_f32(col[(size_t)i * D]), acc);
    }
  }
  if (live) out[c] = acc / n_total + noise_scale * noise[c];
}

template <typename T>
int launch(const T* g, const float* noise, float* out, float* scales, int N, int D,
           float clip, float noise_scale, float n_total, cudaStream_t s) {
  const int vec = ((reinterpret_cast<uintptr_t>(g) & 15) == 0) &&
                  (((size_t)D * sizeof(T)) % 16 == 0);
  norms_kernel<T><<<(N + kNormWarps - 1) / kNormWarps, 32 * kNormWarps, 0, s>>>(
      g, scales, N, D, clip, vec);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  clip_mean_kernel<T><<<(D + kTileD - 1) / kTileD, kTileD, 0, s>>>(
      g, scales, noise, out, N, D, noise_scale, n_total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// grads: (N, D), float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1); scratch:
// (N,) float32, the clip factors between the two launches.
extern "C" int dp_clip_noise_launch(const void* grads, int is_bf16, const float* noise,
                                    float* out, float* scratch, int N, int D, float clip,
                                    float noise_scale, float n_total, void* stream) {
  if (N <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch(static_cast<const __nv_bfloat16*>(grads), noise, out, scratch, N, D, clip,
                  noise_scale, n_total, s);
  return launch(static_cast<const float*>(grads), noise, out, scratch, N, D, clip,
                noise_scale, n_total, s);
}

extern "C" const char* kernel_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
