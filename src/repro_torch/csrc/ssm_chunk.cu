// Mamba2 intra-chunk SSD (the quadratic half of the state-space dual), for
// Hopper (sm_90a).
//
// For each group g (one batch row, one chunk and one SSM head), over the
// Q positions of the chunk, with state width N and head width P:
//
//   y[g,q,p]     = sum_{t<=q} (C[q].B[t]) * exp(clip(cum[q]-cum[t], -60, 0)) * dt[t] * x[t,p]
//   s_loc[g,p,n] = sum_t exp(clip(cum[Q-1]-cum[t], -60, 0)) * dt[t] * x[t,p] * B[t,n]
//
// C, B (G / heads, Q, N): group g reads block g / heads, so the heads of one
// (batch, chunk) share one copy of C and B (the model's single B/C group);
// heads = 1 is the reference's (G, Q, N) layout. cum, dt (G, Q) float32;
// x (G, Q, P); C, B and x all float32 or all bfloat16, widened to float32
// on load. Out: y (G, Q, P) and s_loc (G, P, N), float32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssm_scan.py::ssm_chunk
// (body _ssm_chunk_kernel), whose dots run at Precision.HIGHEST: so this
// kernel does IEEE float32 fused multiply-adds on the CUDA cores, no TF32,
// and expf (not the fast __expf). Caller: repro_torch.models.ssm
// .mamba2_forward, once per Mamba2 layer of every prefill on the card.
//
// What bounds it on the H100: at the zamba2-1.2b prefill shape (G = 4096,
// Q = 128, N = P = 64) it needs 12.95 GFLOP of causal float32 work against
// 0.34 GB of traffic, about 38 flop per byte: above the ~20 flop per byte
// ridge of float32 without tensor cores, so bound by operations (0.19 ms
// at 67 TFLOP/s). Reaching that needs the products in registers; this
// first version feeds every FMA from shared memory and is bound by
// shared-memory loads instead (about 0.6 loads per FMA).
//
// What the design does about it: one block of 256 threads per group. B, x
// and the decay terms of the group are staged in shared memory as float32
// (B padded to N + 1 columns, so lanes reading one column of 32 rows hit 32
// banks). s_loc: warp w owns rows p = w + 8a, lane l columns n = l + 32b,
// summed over t in order. y: the queries go in tiles of 32 rows; the tile
// stages its rows of C, then each warp computes a 4 x (up to 4 x 32)
// register tile of C.B^T for its 4 rows, scales it by the clipped decay and
// dt (zero above the diagonal) into a shared (32, Q) score tile, and sums
// scores times x over t in order. Column blocks of 32 keys that lie wholly
// above the tile's diagonal are never computed: the causal half is skipped
// at 32-key granularity. No atomics, so a second launch gives the same bits.
// Shared memory: 90 KB at the prefill shape (two blocks per SM), up to
// 162 KB at Q = N = P = 128, above the 48 KB default, so the launch raises
// the kernel's dynamic shared-memory limit first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 4;
constexpr int kTileQ = kWarps * kRowsPerWarp;  // 32 query rows per tile
constexpr int kMaxQ = 128;
constexpr int kMaxN = 128;
constexpr int kMaxP = 128;
constexpr int kKeySlots = kMaxQ / 32;  // key columns a lane holds in a score tile

__device__ __forceinline__ float load_f32(const void* p, size_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// exp(clip(d, -60, 0)), as the reference clips both exponentials.
__device__ __forceinline__ float clipped_decay(float d) {
  return expf(fminf(fmaxf(d, -60.f), 0.f));
}

// Shared-memory floats for one group: B (Q x (N+1)), x (Q x P), one tile of
// C (32 x N), one score tile (32 x Qp), cum, dt and the end weights (Q each).
__host__ __device__ inline size_t smem_floats(int Q, int N, int P) {
  const int Qp = (Q + 31) / 32 * 32;
  return (size_t)Q * (N + 1) + (size_t)Q * P + (size_t)kTileQ * N + (size_t)kTileQ * Qp +
         3 * (size_t)Q;
}

// NB = column slots of 32 along N, PB = along P (each 1, 2 or 4).
template <int NB, int PB>
__global__ void __launch_bounds__(kThreads, 2)
ssm_chunk_kernel(const void* __restrict__ Cg, const void* __restrict__ Bg,
                 const float* __restrict__ cum, const float* __restrict__ dt,
                 const void* __restrict__ xg, float* __restrict__ y, float* __restrict__ s_loc,
                 int Q, int N, int P, int heads, int bf16) {
  extern __shared__ float smem[];
  const int ldb = N + 1;
  const int Qp = (Q + 31) / 32 * 32;
  float* Bs = smem;                   // Q x (N + 1)
  float* Xs = Bs + (size_t)Q * ldb;   // Q x P
  float* Cs = Xs + (size_t)Q * P;     // kTileQ x N
  float* Ss = Cs + kTileQ * N;        // kTileQ x Qp
  float* cum_s = Ss + kTileQ * Qp;    // Q
  float* dt_s = cum_s + Q;            // Q
  float* wend_s = dt_s + Q;           // Q

  const int g = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t cb_off = (size_t)(g / heads) * Q * N;
  const size_t x_off = (size_t)g * Q * P;

  for (int e = threadIdx.x; e < Q * N; e += kThreads)
    Bs[(e / N) * ldb + e % N] = load_f32(Bg, cb_off + e, bf16);
  for (int e = threadIdx.x; e < Q * P; e += kThreads) Xs[e] = load_f32(xg, x_off + e, bf16);
  for (int e = threadIdx.x; e < Q; e += kThreads) {
    cum_s[e] = cum[(size_t)g * Q + e];
    dt_s[e] = dt[(size_t)g * Q + e];
  }
  __syncthreads();
  const float cum_end = cum_s[Q - 1];
  for (int e = threadIdx.x; e < Q; e += kThreads)
    wend_s[e] = clipped_decay(cum_end - cum_s[e]) * dt_s[e];
  __syncthreads();

  // s_loc[p, n] = sum_t (w_end[t] x[t, p]) B[t, n]: rows p = warp + 8a,
  // columns n = lane + 32b.
  {
    constexpr int kA = PB * 4;  // ceil(P / 8) <= 4 PB
    float acc[kA][NB];
#pragma unroll
    for (int a = 0; a < kA; ++a)
#pragma unroll
      for (int b = 0; b < NB; ++b) acc[a][b] = 0.f;
    for (int t = 0; t < Q; ++t) {
      const float wt = wend_s[t];
      float bv[NB];
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const int n = lane + 32 * b;
        bv[b] = n < N ? Bs[t * ldb + n] : 0.f;
      }
#pragma unroll
      for (int a = 0; a < kA; ++a) {
        const int p = warp + kWarps * a;
        if (p < P) {
          const float xw = wt * Xs[t * P + p];
#pragma unroll
          for (int b = 0; b < NB; ++b) acc[a][b] = fmaf(xw, bv[b], acc[a][b]);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < kA; ++a) {
      const int p = warp + kWarps * a;
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const int n = lane + 32 * b;
        if (p < P && n < N) s_loc[((size_t)g * P + p) * N + n] = acc[a][b];
      }
    }
  }

  // y, one tile of kTileQ query rows at a time; this warp owns tile rows
  // row0 .. row0 + 3.
  const int row0 = warp * kRowsPerWarp;
  for (int q0 = 0; q0 < Q; q0 += kTileQ) {
    const int rows = min(kTileQ, Q - q0);
    for (int e = threadIdx.x; e < rows * N; e += kThreads)
      Cs[e] = load_f32(Cg, cb_off + (size_t)q0 * N + e, bf16);
    __syncthreads();
    const int tend = min(q0 + kTileQ, Q);  // no row of the tile sees a key at or past tend
    const int slots = (tend + 31) / 32;    // key column blocks of 32 that are computed

    // Scores: acc[i][j] = C[q0 + row0 + i] . B[lane + 32 j].
    float acc[kRowsPerWarp][kKeySlots];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
      for (int j = 0; j < kKeySlots; ++j) acc[i][j] = 0.f;
    for (int n = 0; n < N; ++n) {
      float c[kRowsPerWarp], b[kKeySlots];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
        c[i] = row0 + i < rows ? Cs[(row0 + i) * N + n] : 0.f;
#pragma unroll
      for (int j = 0; j < kKeySlots; ++j) {
        const int t = lane + 32 * j;
        b[j] = (j < slots && t < tend) ? Bs[t * ldb + n] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
        for (int j = 0; j < kKeySlots; ++j)
          if (j < slots) acc[i][j] = fmaf(c[i], b[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int q = q0 + row0 + i;
#pragma unroll
      for (int j = 0; j < kKeySlots; ++j) {
        const int t = lane + 32 * j;
        if (j < slots)
          Ss[(row0 + i) * Qp + t] =
              (q < Q && t <= q) ? acc[i][j] * clipped_decay(cum_s[q] - cum_s[t]) * dt_s[t] : 0.f;
      }
    }
    __syncthreads();

    // y[q, p] = sum_t S[q, t] x[t, p]; past the warp's last row every score
    // is zero, so its sum stops there.
    float ya[kRowsPerWarp][PB];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
      for (int k = 0; k < PB; ++k) ya[i][k] = 0.f;
    const int tlim = min(q0 + row0 + kRowsPerWarp, Q);
    for (int t = 0; t < tlim; ++t) {
      float s[kRowsPerWarp], xv[PB];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) s[i] = Ss[(row0 + i) * Qp + t];
#pragma unroll
      for (int k = 0; k < PB; ++k) {
        const int p = lane + 32 * k;
        xv[k] = p < P ? Xs[t * P + p] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
        for (int k = 0; k < PB; ++k) ya[i][k] = fmaf(s[i], xv[k], ya[i][k]);
    }
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int q = q0 + row0 + i;
#pragma unroll
      for (int k = 0; k < PB; ++k) {
        const int p = lane + 32 * k;
        if (q < Q && p < P) y[((size_t)g * Q + q) * P + p] = ya[i][k];
      }
    }
    __syncthreads();  // the next tile overwrites Cs and Ss
  }
}

template <int NB, int PB>
cudaError_t launch(const void* C, const void* B, const float* cum, const float* dt,
                   const void* x, float* y, float* s_loc, int G, int Q, int N, int P,
                   int heads, int bf16, cudaStream_t stream) {
  const size_t bytes = smem_floats(Q, N, P) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ssm_chunk_kernel<NB, PB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  ssm_chunk_kernel<NB, PB><<<G, kThreads, bytes, stream>>>(C, B, cum, dt, x, y, s_loc, Q, N,
                                                            P, heads, bf16);
  return cudaGetLastError();
}

template <int NB>
cudaError_t launch_p(int pb, const void* C, const void* B, const float* cum, const float* dt,
                     const void* x, float* y, float* s_loc, int G, int Q, int N, int P,
                     int heads, int bf16, cudaStream_t stream) {
  switch (pb) {
    case 1: return launch<NB, 1>(C, B, cum, dt, x, y, s_loc, G, Q, N, P, heads, bf16, stream);
    case 2: return launch<NB, 2>(C, B, cum, dt, x, y, s_loc, G, Q, N, P, heads, bf16, stream);
    default: return launch<NB, 4>(C, B, cum, dt, x, y, s_loc, G, Q, N, P, heads, bf16, stream);
  }
}

int slots_of(int width) { return width <= 32 ? 1 : width <= 64 ? 2 : 4; }

}  // namespace

extern "C" int ssm_chunk_launch(const void* C, const void* B, const float* cum, const float* dt,
                                const void* x, float* y, float* s_loc, int G, int Q, int N,
                                int P, int heads, int bf16, void* stream) {
  if (G < 1 || Q < 1 || Q > kMaxQ || N < 1 || N > kMaxN || P < 1 || P > kMaxP || heads < 1 ||
      G % heads != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const int pb = slots_of(P);
  cudaError_t err;
  switch (slots_of(N)) {
    case 1: err = launch_p<1>(pb, C, B, cum, dt, x, y, s_loc, G, Q, N, P, heads, bf16, s); break;
    case 2: err = launch_p<2>(pb, C, B, cum, dt, x, y, s_loc, G, Q, N, P, heads, bf16, s); break;
    default: err = launch_p<4>(pb, C, B, cum, dt, x, y, s_loc, G, Q, N, P, heads, bf16, s);
  }
  return static_cast<int>(err);
}

extern "C" const char* kernel_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
