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
// float32 it is bound by operations: 12.5 us at n = 2047, p = 100.
//
// What the design does about it: a register-tiled SGEMM with split-K.
// - Each 256-thread block owns a 128 x 128 tile of Y; each thread keeps
//   an 8 x 8 block of sums (rows ty*4 + {0..3} and 64 + ty*4 + {0..3},
//   columns likewise). Per contraction step a thread reads its 8 A values
//   and 8 Theta values as four 16-byte shared loads, which feed 64 FMAs;
//   the next step's fragments are loaded while the current step's FMAs
//   run. A quarter-warp's loads broadcast or fall on distinct banks.
// - Tiles of 16 contraction steps go through a 2-stage ring in shared
//   memory with cp.async, so the next tile loads while the current one
//   computes; one __syncthreads per 16 steps. A is staged transposed
//   (As[k][row], rows padded to 132 floats so the transposing 4-byte
//   copies of a warp hit 32 distinct banks): 4-byte copies take any n, so
//   A's 8188-byte rows at n = 2047 need no padded copy, and they are 8 of
//   about 1,100 instructions a thread issues per stage. Theta is copied
//   16 bytes at a time when p % 4 == 0 and it is 16-byte aligned (p =
//   100), else 4 bytes at a time (a second template instance, picked by
//   the wrapper).
// - At n = 2047, p = 100 there are only 16 output tiles for 132 SMs, so
//   the contraction is split into S parts (blockIdx.z), each a multiple
//   of 16 steps, S chosen by the wrapper (repro_torch.kernels.graph_mix
//   .split_plan) so that one wave of one block an SM fills the card: S =
//   8, 128 blocks. Each part writes its partial tile to an (S, n, p)
//   scratch; a second launch sums the S partials of every output in rank
//   order, with S loads in flight before the adds. It is launched as a
//   programmatic dependent of the product, so it is scheduled while the
//   product's last blocks run and waits on the device (griddepcontrol)
//   for the whole product to finish. Within a part every output is an FMA
//   chain in ascending k. No atomics: a second launch gives the same bits.
//   (A thread-block cluster summing through distributed shared memory
//   would save the second launch, but at one block an SM the card holds
//   only 15 clusters of 8 at once, not the 16 that n = 2047 needs.)
// - Ragged n and p are masked on load (zero fill) and on store.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

// A block owns kBM x kBN outputs of Y, with kThreads threads in a 16 x 16
// grid, each keeping 8 x 8 sums.
constexpr int kBM = 128;         // rows of Y per block
constexpr int kBN = 128;         // columns of Y per block
constexpr int kThreads = 256;
constexpr int kBK = 16;          // contraction steps per stage
constexpr int kStages = 2;       // depth of the cp.async ring
constexpr int kPadM = kBM + 4;   // As row length: 4-byte transposing copies on 32 banks

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy src_bytes (0 or 16) from global to shared and zero-fill the rest of 16.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// Copy src_bytes (0 or 4) from global to shared and zero-fill the rest of 4.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct __align__(16) Ring {
  float a[kStages][kBK][kPadM];   // A tile, transposed: a[s][k][row]
  float b[kStages][kBK][kBN];     // Theta tile: b[s][k][col]
};

// Stage the tiles of contraction steps [kb, kb + kBK), masked to kend and n.
template <bool T_VEC>
__device__ __forceinline__ void load_stage(Ring& sm, int s, const float* __restrict__ A,
                                           const float* __restrict__ T, int n, int p, int row0,
                                           int col0, int kb, int kend) {
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < kBM * kBK / kThreads; ++i) {  // 8 a thread; a warp: 4 rows x 32 B
    const int e = t + i * kThreads;
    const int r = (e / 8) % kBM, k = (e / (8 * kBM)) * 8 + e % 8;  // 8 steps of 128 rows at a time
    const int gr = row0 + r, gk = kb + k;
    const bool live = gr < n && gk < kend;
    cp_async4(&sm.a[s][k][r], live ? A + (size_t)gr * n + gk : A, live ? 4 : 0);
  }
  if (T_VEC) {  // kBK rows x 32 float4: kBK / 8 a thread
#pragma unroll
    for (int i = 0; i < kBK / 8; ++i) {
      const int e = t + i * kThreads;
      const int k = e / (kBN / 4), cq = (e % (kBN / 4)) * 4;
      const int gk = kb + k, gc = col0 + cq;
      const bool live = gk < kend && gc < p;  // p % 4 == 0: all four or none
      cp_async16(&sm.b[s][k][cq], live ? T + (size_t)gk * p + gc : T, live ? 16 : 0);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kBK * kBN / kThreads; ++i) {  // 8 a thread
      const int e = t + i * kThreads;
      const int k = e / kBN, c = e % kBN;
      const int gk = kb + k, gc = col0 + c;
      const bool live = gk < kend && gc < p;
      cp_async4(&sm.b[s][k][c], live ? T + (size_t)gk * p + gc : T, live ? 4 : 0);
    }
  }
}

// The 8 + 8 operands of one contraction step for thread (ty, tx): rows
// ty*4 + {0..3} and 64 + ty*4 + {0..3}, columns tx*4 + {0..3} and
// 64 + tx*4 + {0..3}.
struct Frag {
  float4 a0, a1, b0, b1;
};

__device__ __forceinline__ Frag load_frag(const Ring& sm, int s, int k, int ty, int tx) {
  Frag f;
  f.a0 = *reinterpret_cast<const float4*>(&sm.a[s][k][ty * 4]);
  f.a1 = *reinterpret_cast<const float4*>(&sm.a[s][k][64 + ty * 4]);
  f.b0 = *reinterpret_cast<const float4*>(&sm.b[s][k][tx * 4]);
  f.b1 = *reinterpret_cast<const float4*>(&sm.b[s][k][64 + tx * 4]);
  return f;
}

__device__ __forceinline__ void fma_frag(float (&acc)[8][8], const Frag& f) {
  const float a[8] = {f.a0.x, f.a0.y, f.a0.z, f.a0.w, f.a1.x, f.a1.y, f.a1.z, f.a1.w};
  const float b[8] = {f.b0.x, f.b0.y, f.b0.z, f.b0.w, f.b1.x, f.b1.y, f.b1.z, f.b1.w};
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
}

__device__ __forceinline__ void add_to(float& s, float v) { s += v; }

__device__ __forceinline__ void add_to(float4& s, const float4& v) {
  s.x += v.x;
  s.y += v.y;
  s.z += v.z;
  s.w += v.w;
}

// One block: the partial product of a 128 x 128 tile of Y over the
// contraction part blockIdx.z, [z * chunk, min((z + 1) * chunk, n)),
// written to out + z * n * p.
template <bool T_VEC>
__global__ void __launch_bounds__(kThreads, 1)
graph_mix_kernel(const float* __restrict__ A, const float* __restrict__ T,
                 float* __restrict__ out, int n, int p, int chunk) {
  __shared__ Ring sm;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  const int kbeg = blockIdx.z * chunk;
  const int kend = min(kbeg + chunk, n);
  const int tiles = (kend - kbeg + kBK - 1) / kBK;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < tiles) load_stage<T_VEC>(sm, s, A, T, n, p, row0, col0, kbeg + s * kBK, kend);
    cp_async_commit();
  }

  for (int tile = 0; tile < tiles; ++tile) {
    cp_async_wait<kStages - 2>();  // this tile's group has landed
    __syncthreads();               // ... for every thread; the slot refilled below is free
    const int next = tile + kStages - 1;
    if (next < tiles)
      load_stage<T_VEC>(sm, next % kStages, A, T, n, p, row0, col0, kbeg + next * kBK, kend);
    cp_async_commit();

    const int s = tile % kStages;
    Frag f[2];
    f[0] = load_frag(sm, s, 0, ty, tx);
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      if (k + 1 < kBK) f[(k + 1) & 1] = load_frag(sm, s, k + 1, ty, tx);  // next step in flight
      fma_frag(acc, f[k & 1]);
    }
  }
  cp_async_wait<0>();
  // Let the rank-order sum launch now: it waits (griddepcontrol.wait) for
  // this whole grid to finish and its stores to be visible before it reads.
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  float* dst = out + (size_t)blockIdx.z * n * p;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (r >= n) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = col0 + h * 64 + tx * 4;
      if (T_VEC) {  // p % 4 == 0: the four columns are in or out together
        if (c < p)
          *reinterpret_cast<float4*>(dst + (size_t)r * p + c) =
              make_float4(acc[i][h * 4], acc[i][h * 4 + 1], acc[i][h * 4 + 2], acc[i][h * 4 + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < p) dst[(size_t)r * p + c + j] = acc[i][h * 4 + j];
      }
    }
  }
}

// Y[e] = part[0][e] + part[1][e] + ... + part[S-1][e], summed in rank order.
// Each thread loads kSumBatch partials before it adds them, so that many
// trips to L2 are in flight at once; the adds keep the rank order.
constexpr int kSumBatch = 8;

template <bool VEC>
__global__ void split_sum_kernel(const float* __restrict__ part, float* __restrict__ Y,
                                 long long count, int S) {
  using V = typename std::conditional<VEC, float4, float>::type;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the partials are complete
  const long long m = VEC ? count / 4 : count;
  const V* pv = reinterpret_cast<const V*>(part);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < m; e += stride) {
    V s = pv[e];
    for (int z0 = 1; z0 < S; z0 += kSumBatch) {
      V v[kSumBatch];
#pragma unroll
      for (int u = 0; u < kSumBatch; ++u)
        if (z0 + u < S) v[u] = pv[(z0 + u) * m + e];
#pragma unroll
      for (int u = 0; u < kSumBatch; ++u)
        if (z0 + u < S) add_to(s, v[u]);
    }
    reinterpret_cast<V*>(Y)[e] = s;
  }
}

template <bool T_VEC>
void launch_gemm(const float* A, const float* T, float* out, int n, int p, int splits, int chunk,
                 cudaStream_t stream) {
  const dim3 grid((p + kBN - 1) / kBN, (n + kBM - 1) / kBM, splits);
  graph_mix_kernel<T_VEC><<<grid, kThreads, 0, stream>>>(A, T, out, n, p, chunk);
}

}  // namespace

// Y = A @ T. The wrapper plans the launch: `splits` contraction parts of
// `chunk` steps each (a multiple of kBK = 16; splits * chunk >= n and
// (splits - 1) * chunk < n) and `t_vec` for 16-byte copies of T. With
// splits > 1, `scratch` holds splits * n * p floats.
extern "C" int graph_mix_launch(const float* A, const float* T, float* Y, float* scratch, int n,
                                int p, int splits, int chunk, int t_vec, void* stream_ptr) {
  if (n <= 0 || p <= 0) return 0;
  const bool plan_ok = splits >= 1 && chunk > 0 && chunk % kBK == 0 &&
                       (long long)splits * chunk >= n && (long long)(splits - 1) * chunk < n &&
                       (splits == 1 || scratch != nullptr);
  const bool t_ok = !t_vec || (p % 4 == 0 && reinterpret_cast<uintptr_t>(T) % 16 == 0 &&
                               reinterpret_cast<uintptr_t>(Y) % 16 == 0 &&
                               reinterpret_cast<uintptr_t>(scratch) % 16 == 0);
  if (!plan_ok || !t_ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  float* out = splits == 1 ? Y : scratch;
  if (t_vec)
    launch_gemm<true>(A, T, out, n, p, splits, chunk, stream);
  else
    launch_gemm<false>(A, T, out, n, p, splits, chunk, stream);
  cudaError_t status = cudaGetLastError();
  if (status != cudaSuccess || splits == 1) return static_cast<int>(status);
  const long long count = (long long)n * p;
  const bool vec = count % 4 == 0;
  const int threads = 256;
  long long blocks = ((vec ? count / 4 : count) + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;  // grid-stride beyond
  // Programmatic dependent launch: the sum is scheduled while the product's
  // last blocks run, instead of after the whole grid has drained.
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(threads);
  cfg.stream = stream;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  const float* part = scratch;
  status = vec ? cudaLaunchKernelEx(&cfg, split_sum_kernel<true>, part, Y, count, splits)
               : cudaLaunchKernelEx(&cfg, split_sum_kernel<false>, part, Y, count, splits);
  if (status != cudaSuccess) return static_cast<int>(status);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
