// Dense neighbour mixing Y = A @ Theta, for Hopper (sm_90a).
//
//   A (n, n) float32, Theta (n, p) float32  ->  Y (n, p) float32
//
// Replaces the Pallas TPU kernel src/repro/kernels/graph_mix.py::graph_mix
// (body _mix_kernel), which multiplies at Precision.HIGHEST: full float32.
// So this kernel runs IEEE float32 fused multiply-adds on the CUDA cores.
// It uses no TF32 and no tensor-core mma, which would keep about three
// decimal digits. Caller: MixOp.all on a dense graph (below the sparse
// crossover of 2048 agents), behind Objective.block_grad and
// synchronous_round.
//
// What bounds it on the H100: at the dense sizes it serves (n just under
// 2048, p = 100) it reads A once (16.8 MB) and does 2 n^2 p = 0.84 GFLOP,
// about 50 flop per byte. That is above the ~20 flop per byte ridge of
// float32 without tensor cores (67 TFLOP/s over 3.35 TB/s), so at full
// float32 it is bound by operations, not bytes. A TF32 tensor-core
// product would be bandwidth-bound, but it is not the reference's
// arithmetic.
//
// What the design does about it: a classic shared-memory tiled SGEMM.
// Each block owns a 32 x 32 tile of Y and walks the contraction in steps
// of 16: it stages a 32 x 16 slab of A (transposed) and a 16 x 32 slab of
// Theta in shared memory, and each of its 256 threads keeps a 2 x 2
// block of sums in registers, so every staged value feeds several FMAs.
// The small tile gives 256 blocks at n = 2047, p = 100, enough to occupy
// all 132 SMs. Ragged edges (n, p not multiples of the tile) are masked
// on load (zeros) and on store.

#include <cuda_runtime.h>

namespace {

constexpr int kBM = 32;  // rows of Y per block
constexpr int kBN = 32;  // columns of Y per block
constexpr int kBK = 16;  // contraction step
constexpr int kTM = 2;   // rows per thread
constexpr int kTN = 2;   // columns per thread
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);  // 256

__global__ void __launch_bounds__(kThreads)
graph_mix_kernel(const float* __restrict__ A, const float* __restrict__ T,
                 float* __restrict__ Y, int n, int p) {
  __shared__ float As[kBK][kBM + 1];  // A tile, transposed: As[k][row]
  __shared__ float Bs[kBK][kBN + 1];
  const int tx = threadIdx.x % (kBN / kTN);
  const int ty = threadIdx.x / (kBN / kTN);
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < n; k0 += kBK) {
    for (int e = threadIdx.x; e < kBM * kBK; e += kThreads) {
      const int r = e / kBK, k = e % kBK;
      const int gr = row0 + r, gk = k0 + k;
      As[k][r] = (gr < n && gk < n) ? A[(size_t)gr * n + gk] : 0.f;
    }
    for (int e = threadIdx.x; e < kBK * kBN; e += kThreads) {
      const int k = e / kBN, c = e % kBN;
      const int gk = k0 + k, gc = col0 + c;
      Bs[k][c] = (gk < n && gc < p) ? T[(size_t)gk * p + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float a[kTM], b[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = As[k][ty * kTM + i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) b[j] = Bs[k][tx * kTN + j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = row0 + ty * kTM + i;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int c = col0 + tx * kTN + j;
      if (r < n && c < p) Y[(size_t)r * p + c] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" int graph_mix_launch(const float* A, const float* T, float* Y, int n, int p,
                                void* stream) {
  if (n <= 0 || p <= 0) return 0;
  const dim3 grid((p + kBN - 1) / kBN, (n + kBM - 1) / kBM);
  graph_mix_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(A, T, Y, n, p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
