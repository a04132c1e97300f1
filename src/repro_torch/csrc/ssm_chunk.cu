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
// Q = 128, N = P = 64, 64 heads sharing each C/B block) the function needs
// 2 [(G/heads) Q(Q+1)/2 N + G Q(Q+1)/2 P + G Q P N] = 8.69 GFLOP of causal
// float32 work (C.B^T once per C/B block) against 0.34 GB of traffic:
// bound by operations, 0.13 ms at 67 TFLOP/s.
//
// What the design does about it:
// - One block of 256 threads per (batch, chunk, group of hg heads); the
//   wrapper's head_plan (kernels/ssm_chunk.py) picks hg, a divisor of
//   heads that leaves enough blocks to fill the card. The block stages C
//   and B once, computes the causal C.B^T once and reuses it for each of
//   its hg heads.
// - C.B^T stays in registers: thread (tq, tt) keeps CB[16i + tq][16j + tt]
//   for the 36 pairs j <= i of 16-row blocks (the blocks above the
//   diagonal are never computed), summed from 8 float4 of C and 8 of B per
//   4 steps of n. B and C rows are padded to a stride of 4 mod 8 floats,
//   so the float4 reads of 8 consecutive rows hit distinct banks.
// - Per head: x (cp.async), cum and dt arrive in shared memory; every
//   thread turns its C.B^T registers into S = CB * exp(clip(cum_q -
//   cum_t)) * dt_t on the causal half, stored in a triangular layout of
//   16-row blocks (row block i keeps keys t < 16 (i + 1), 16 queries
//   wide, [t][q]). Then warps 0-3 compute s_loc = (w_end x)^T B with 4 x 8
//   register tiles (a float4 of x and two of B per t) while warps 4-7
//   compute y = S @ x, each over row blocks i and 7 - i (equal work), with
//   4 x 8 (P <= 64) or 4 x 16 register tiles: one float4 of S and two or
//   four of x per t, over keys t < 16 (i + 1) only.
// - Shared memory is B, S, one head's x and its cum, dt and end weights:
//   106 KB at the prefill shape, so two blocks share an SM (and at most
//   128 registers a thread): while one waits for its next head's x, the
//   other computes. C is staged over S and x before the first head. At
//   Q = N = P = 128 a block takes 171 KB, one an SM.
// - Every output is one FMA chain in ascending n or t, the same whatever
//   hg is and whether C and B are shared: no atomics, a second launch
//   gives the same bits, and heads = 64 gives the bits of the expanded
//   heads = 1 layout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxQ = 128;
constexpr int kMaxN = 128;
constexpr int kMaxP = 128;

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

__device__ __forceinline__ float load_f32(const void* p, size_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// exp(clip(d, -60, 0)), as the reference clips both exponentials.
__device__ __forceinline__ float clipped_decay(float d) {
  return expf(fminf(fmaxf(d, -60.f), 0.f));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Offsets (in floats) of the shared-memory regions of one block.
struct Layout {
  int Qp;   // Q rounded up to 16: rows of every staged matrix
  int nb;   // 16-row blocks
  int ldb;  // row stride of B and C: N rounded up to 32, plus 4
  int Px;   // row stride of x: 32, 64 or 128
  int off_s, off_x, off_cum, off_dt, off_wend, floats;
};

__host__ __device__ inline int width_of(int P) { return P <= 32 ? 32 : P <= 64 ? 64 : 128; }

__host__ __device__ inline Layout layout_of(int Q, int N, int P) {
  Layout L;
  L.Qp = (Q + 15) / 16 * 16;
  L.nb = L.Qp / 16;
  L.ldb = (N + 31) / 32 * 32 + 4;
  L.Px = width_of(P);
  L.off_s = L.Qp * L.ldb;
  L.off_x = L.off_s + 128 * L.nb * (L.nb + 1);  // S: 16 x 16 floats per (t-block, row block)
  L.off_cum = L.off_x + L.Qp * L.Px;
  L.off_dt = L.off_cum + L.Qp;
  L.off_wend = L.off_dt + L.Qp;
  const int end = L.off_wend + L.Qp;
  const int c_end = L.off_s + L.Qp * L.ldb;  // C is staged over S and x
  L.floats = end > c_end ? end : c_end;
  return L;
}

// PB = Px / 32: column groups of 32 a lane's y tile spans (1, 2 or 4). At
// PB <= 2 two blocks fit an SM (<= 128 registers, <= 113 KB each).
template <int PB>
__global__ void __launch_bounds__(kThreads, PB == 4 ? 1 : 2)
ssm_chunk_kernel(const void* __restrict__ Cg, const void* __restrict__ Bg,
                 const float* __restrict__ cum, const float* __restrict__ dt,
                 const void* __restrict__ xg, float* __restrict__ y, float* __restrict__ s_loc,
                 int Q, int N, int P, int heads, int hg, int bf16, int xvec) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Layout L = layout_of(Q, N, P);
  const int Qp = L.Qp, nb = L.nb, ldb = L.ldb, Px = L.Px;
  float* Bs = smem;
  float* St = smem + L.off_s;
  float* Cs = St;  // before the first head only
  float* Xs = smem + L.off_x;
  float* cs = smem + L.off_cum;
  float* ds = smem + L.off_dt;
  float* wend = smem + L.off_wend;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int splits = heads / hg;
  const int gc = blockIdx.x / splits;                      // the (batch, chunk) block of C and B
  const int g0 = gc * heads + (blockIdx.x % splits) * hg;  // this block's first group
  const size_t cb_off = (size_t)gc * Q * N;

  for (int e = tid; e < Qp * ldb; e += kThreads) {
    const int r = e / ldb, c = e - r * ldb;
    const bool in = r < Q && c < N;
    Bs[e] = in ? load_f32(Bg, cb_off + (size_t)r * N + c, bf16) : 0.f;
    Cs[e] = in ? load_f32(Cg, cb_off + (size_t)r * N + c, bf16) : 0.f;
  }
  __syncthreads();

  // C.B^T, kept in registers for all the block's heads: thread (tq, tt)
  // holds cb[i(i+1)/2 + j] = CB[16i + tq][16j + tt] for j <= i, each summed
  // over n in order.
  const int tq = tid & 15, tt = tid >> 4;
  float cb[36];
#pragma unroll
  for (int a = 0; a < 36; ++a) cb[a] = 0.f;
  {
    const int n4 = (N + 3) & ~3;
    for (int n = 0; n < n4; n += 4) {
      float4 c[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (i < nb) {
          c[i] = ld4(Cs + (16 * i + tq) * ldb + n);
          b[i] = ld4(Bs + (16 * i + tt) * ldb + n);
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j <= i; ++j) {
          if (i < nb) {
            float& acc = cb[i * (i + 1) / 2 + j];
            acc = fmaf(c[i].x, b[j].x, acc);
            acc = fmaf(c[i].y, b[j].y, acc);
            acc = fmaf(c[i].z, b[j].z, acc);
            acc = fmaf(c[i].w, b[j].w, acc);
          }
        }
      }
    }
  }
  __syncthreads();  // C is dead: S and x may be written

  // Bring head h's x, cum and dt in: cp.async when x is float32 with
  // 16-byte rows (xvec), plain (widening) loads otherwise.
  auto load_head = [&](int h) {
    const int g = g0 + h;
    const float* cum_g = cum + (size_t)g * Q;
    const float* dt_g = dt + (size_t)g * Q;
    if (xvec) {
      const float* xs = static_cast<const float*>(xg) + (size_t)g * Q * P;
      const int chunks = Px / 4;
      for (int e = tid; e < Qp * chunks; e += kThreads) {
        const int r = e / chunks, c = (e - r * chunks) * 4;
        const bool in = r < Q && c < P;  // P % 4 == 0: a chunk is in or out whole
        cp_async16(Xs + r * Px + c, in ? xs + (size_t)r * P + c : xs, in ? 16 : 0);
      }
      for (int e = tid; e < Qp; e += kThreads) {
        cp_async4(cs + e, e < Q ? cum_g + e : cum_g, e < Q ? 4 : 0);
        cp_async4(ds + e, e < Q ? dt_g + e : dt_g, e < Q ? 4 : 0);
      }
      cp_async_commit();
    } else {
      const size_t x_off = (size_t)g * Q * P;
      for (int e = tid; e < Qp * Px; e += kThreads) {
        const int r = e / Px, c = e - r * Px;
        Xs[e] = (r < Q && c < P) ? load_f32(xg, x_off + (size_t)r * P + c, bf16) : 0.f;
      }
      for (int e = tid; e < Qp; e += kThreads) {
        cs[e] = e < Q ? cum_g[e] : 0.f;
        ds[e] = e < Q ? dt_g[e] : 0.f;
      }
    }
  };

  load_head(0);
  for (int h = 0; h < hg; ++h) {
    if (xvec) cp_async_wait<0>();
    __syncthreads();
    const int g = g0 + h;

    // S = CB * exp(clip(cum_q - cum_t)) * dt_t for t <= q < Q, else 0, from
    // the registers into the triangular layout (a warp writes 2 x 16
    // consecutive floats: no bank conflicts); w_end beside it.
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i < nb) {
        const int q = 16 * i + tq;
        const float cq = cs[q];
#pragma unroll
        for (int j = 0; j <= i; ++j) {
          const int t = 16 * j + tt;
          const float v = cb[i * (i + 1) / 2 + j] * clipped_decay(cq - cs[t]) * ds[t];
          St[128 * i * (i + 1) + t * 16 + tq] = (t <= q && q < Q) ? v : 0.f;
        }
      }
    }
    if (tid < Qp) wend[tid] = tid < Q ? clipped_decay(cs[Q - 1] - cs[tid]) * ds[tid] : 0.f;
    __syncthreads();

    if (warp < 4) {
      // s_loc[p, n] = sum_t (w_end[t] x[t, p]) B[t, n]: thread (r, c) keeps
      // rows p = pp + 4r + {0..3}, columns n = nn + 4c + {0..3} and + 32.
      const int r = tid >> 3, c = tid & 7;
      const int Nw = ldb - 4;
      for (int pp = 0; pp < Px; pp += 64) {
        const int p0 = pp + 4 * r;
        if (p0 >= Px) continue;  // uniform in a warp: Px is a multiple of 32
        for (int nn = 0; nn < Nw; nn += 64) {
          const bool hi = nn + 32 < Nw;
          float acc[4][8];
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int v = 0; v < 8; ++v) acc[u][v] = 0.f;
#pragma unroll 4
          for (int t = 0; t < Q; ++t) {
            const float wt = wend[t];
            const float4 xv = ld4(Xs + t * Px + p0);
            const float4 b0 = ld4(Bs + t * ldb + nn + 4 * c);
            const float4 b1 =
                hi ? ld4(Bs + t * ldb + nn + 32 + 4 * c) : make_float4(0.f, 0.f, 0.f, 0.f);
            const float xw[4] = {wt * xv.x, wt * xv.y, wt * xv.z, wt * xv.w};
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              acc[u][0] = fmaf(xw[u], b0.x, acc[u][0]);
              acc[u][1] = fmaf(xw[u], b0.y, acc[u][1]);
              acc[u][2] = fmaf(xw[u], b0.z, acc[u][2]);
              acc[u][3] = fmaf(xw[u], b0.w, acc[u][3]);
              acc[u][4] = fmaf(xw[u], b1.x, acc[u][4]);
              acc[u][5] = fmaf(xw[u], b1.y, acc[u][5]);
              acc[u][6] = fmaf(xw[u], b1.z, acc[u][6]);
              acc[u][7] = fmaf(xw[u], b1.w, acc[u][7]);
            }
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int p = p0 + u;
            if (p >= P) continue;
            float* out = s_loc + ((size_t)g * P + p) * N;
#pragma unroll
            for (int v = 0; v < 8; ++v) {
              const int n = nn + 4 * c + (v < 4 ? v : 28 + v);
              if (n < N) out[n] = acc[u][v];
            }
          }
        }
      }
    } else {
      // y[q, p] = sum_{t < 16 (i + 1)} S[q, t] x[t, p]: warp 4 + k takes row
      // blocks k and 7 - k (equal work); lane (ly, lx) keeps rows 16i + 4ly
      // + {0..3}, columns 4lx + 32c + {0..3}.
      const int ly = lane >> 3, lx = lane & 7;
#pragma unroll 1
      for (int half = 0; half < 2; ++half) {
        const int i = half == 0 ? warp - 4 : 11 - warp;
        if (i >= nb) continue;
        const float* Sb = St + 128 * i * (i + 1) + 4 * ly;
        float acc[4][4 * PB];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4 * PB; ++v) acc[u][v] = 0.f;
        const int tend = 16 * i + 16;
#pragma unroll 4
        for (int t = 0; t < tend; ++t) {
          const float4 sv4 = ld4(Sb + t * 16);
          float4 xv[PB];
#pragma unroll
          for (int cc = 0; cc < PB; ++cc) xv[cc] = ld4(Xs + t * Px + 4 * lx + 32 * cc);
          const float sv[4] = {sv4.x, sv4.y, sv4.z, sv4.w};
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int cc = 0; cc < PB; ++cc) {
              acc[u][4 * cc + 0] = fmaf(sv[u], xv[cc].x, acc[u][4 * cc + 0]);
              acc[u][4 * cc + 1] = fmaf(sv[u], xv[cc].y, acc[u][4 * cc + 1]);
              acc[u][4 * cc + 2] = fmaf(sv[u], xv[cc].z, acc[u][4 * cc + 2]);
              acc[u][4 * cc + 3] = fmaf(sv[u], xv[cc].w, acc[u][4 * cc + 3]);
            }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int q = 16 * i + 4 * ly + u;
          if (q >= Q) continue;
          float* out = y + ((size_t)g * Q + q) * P;
#pragma unroll
          for (int cc = 0; cc < PB; ++cc) {
            const int p = 4 * lx + 32 * cc;
            if (P % 4 == 0) {
              if (p < P)
                *reinterpret_cast<float4*>(out + p) =
                    make_float4(acc[u][4 * cc], acc[u][4 * cc + 1], acc[u][4 * cc + 2],
                                acc[u][4 * cc + 3]);
            } else {
#pragma unroll
              for (int v = 0; v < 4; ++v)
                if (p + v < P) out[p + v] = acc[u][4 * cc + v];
            }
          }
        }
      }
    }
    __syncthreads();  // x, cum, dt, S and w_end are rewritten next
    if (h + 1 < hg) load_head(h + 1);
  }
}

template <int PB>
cudaError_t launch(const void* C, const void* B, const float* cum, const float* dt, const void* x,
                   float* y, float* s_loc, int G, int Q, int N, int P, int heads, int hg,
                   int bf16, int xvec, cudaStream_t stream) {
  const size_t bytes = (size_t)layout_of(Q, N, P).floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ssm_chunk_kernel<PB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  ssm_chunk_kernel<PB><<<G / hg, kThreads, bytes, stream>>>(C, B, cum, dt, x, y, s_loc, Q, N, P,
                                                            heads, hg, bf16, xvec);
  return cudaGetLastError();
}

}  // namespace

// Shared-memory bytes of one block at (Q, N, P).
extern "C" int ssm_chunk_smem_bytes(int Q, int N, int P) {
  return layout_of(Q, N, P).floats * static_cast<int>(sizeof(float));
}

// hg: heads per block (a divisor of heads; the wrapper's head_plan). xvec:
// 1 when x is float32 with P % 4 == 0 and 16-byte aligned (cp.async copies).
extern "C" int ssm_chunk_launch(const void* C, const void* B, const float* cum, const float* dt,
                                const void* x, float* y, float* s_loc, int G, int Q, int N,
                                int P, int heads, int hg, int bf16, int xvec, void* stream) {
  if (G < 1 || Q < 1 || Q > kMaxQ || N < 1 || N > kMaxN || P < 1 || P > kMaxP || heads < 1 ||
      G % heads != 0 || hg < 1 || heads % hg != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (xvec && (bf16 || P % 4 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  const int w = width_of(P);
  if (w == 32)
    err = launch<1>(C, B, cum, dt, x, y, s_loc, G, Q, N, P, heads, hg, bf16, xvec, s);
  else if (w == 64)
    err = launch<2>(C, B, cum, dt, x, y, s_loc, G, Q, N, P, heads, hg, bf16, xvec, s);
  else
    err = launch<4>(C, B, cum, dt, x, y, s_loc, G, Q, N, P, heads, hg, bf16, xvec, s);
  return static_cast<int>(err);
}

extern "C" const char* kernel_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
