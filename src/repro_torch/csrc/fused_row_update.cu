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
// rule in two launches on one stream: fused_rows_kernel computes all B
// new rows into a (B, p) scratch while Theta is only read, then
// scatter_rows_kernel writes the rows with 0 <= rows[b] < limit. The
// scatter is a programmatic dependent launch (griddepcontrol): scheduled
// while the compute's last blocks run, it waits on the device for the
// whole compute grid. (One cooperative launch with a grid barrier between
// the two steps measured slower on an H100: 29.7 against 25.7 us at the
// main path's shape; PERF.md.) The valid rows of one call must be
// distinct (the engine's woken batch is), or two warps would race for the
// same row.
//
// What bounds it on the H100: bytes. Per woken row it reads its real
// neighbour rows, the row itself and its (m, p) data, and writes one row:
// about (K_real + m + 2) p floats against about (2 K_real + 4 m + 8) p
// flops, near 0.5 flop per byte.
//
// What the design does about it (the access pattern of sparse_mix.cu):
// - One warp per woken row, 4 rows a block, lanes along p in passes of
//   128 columns: a float4 a lane where p % 4 == 0 and Theta, X and noise
//   start on 16-byte boundaries (a p = 100 row is one load over 25 lanes),
//   4 floats a lane 32 apart in a scalar instance elsewhere. The wrapper
//   picks the instance and the number of passes (1, 2, 4 or 8: p <= 1024).
// - X is read once: the row's points go in chunks of 8 / passes, held in
//   registers (m = 8, p = 100: the whole (8, 100) block, one float4 a lane
//   a point); the residual dots reduce by warp shuffle, and the gradient
//   sum sum_i mask_i r_i x_i is taken from the same registers, in
//   ascending i.
// - The neighbour walk takes only the entries with w != 0: the lanes hold
//   32 (idx, w) pairs at a time (the next 32 load meanwhile), and
//   __ballot_sync(w != 0) gives the warp the entries to walk in ascending
//   k, with 8 / passes neighbour rows in flight. Skipping a weight-0 term
//   leaves every sum over finite Theta as it was (fmaf(0, x, acc) == acc).
// - The row's first 32 (idx, w) pairs, its coefficients, targets and mask
//   are loaded first, a lane each, and passed around by shuffles. Sentinel
//   rows leave at once.
// Every output is a fixed chain of FMAs: no atomics, a second launch gives
// the same bits.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 4;        // woken rows per block
constexpr int kThreads = 32 * kWarps;
constexpr int kPassCols = 128;   // columns a pass: 4 a lane
constexpr int kMaxP = 1024;      // 8 passes
constexpr int kMaxM = 2048;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

// A lane's 4 columns of a pass: through the read-only cache (NC), or
// coherent.
template <bool VEC, bool NC = true>
__device__ __forceinline__ float4 load_cols(const float* __restrict__ row, int c0, int lane,
                                            int p) {
  if (VEC) {
    const int c = c0 + lane * 4;
    if (c >= p) return make_float4(0.f, 0.f, 0.f, 0.f);
    const float4* q = reinterpret_cast<const float4*>(row + c);
    return NC ? __ldg(q) : *q;
  }
  float v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int c = c0 + q * 32 + lane;
    v[q] = c < p ? (NC ? __ldg(row + c) : row[c]) : 0.f;
  }
  return make_float4(v[0], v[1], v[2], v[3]);
}

template <bool VEC>
__device__ __forceinline__ void store_cols(float* __restrict__ row, int c0, int lane, int p,
                                           const float4& v) {
  if (VEC) {
    const int c = c0 + lane * 4;
    if (c < p) *reinterpret_cast<float4*>(row + c) = v;
  } else {
    const float a[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = c0 + q * 32 + lane;
      if (c < p) row[c] = a[q];
    }
  }
}

__device__ __forceinline__ void fma4(float4& acc, float w, const float4& x) {
  acc.x = fmaf(w, x.x, acc.x);
  acc.y = fmaf(w, x.y, acc.y);
  acc.z = fmaf(w, x.z, acc.z);
  acc.w = fmaf(w, x.w, acc.w);
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float abs_sum4(const float4& a, float acc) {
  return acc + fabsf(a.x) + fabsf(a.y) + fabsf(a.z) + fabsf(a.w);
}

struct Args {
  const int* rows;
  const int* idx;
  const float* w;
  const float* coef;
  int coef_stride;
  const float* X;
  const float* y;
  const float* mask;
  const float* noise;
  float* theta;
  float* scratch;
  int B, K, m, p, limit;
  float clip;
  int use_clip;
};

// The new row b into scratch[b]; the warp leaves at once for a sentinel.
// PASSES: 128-column passes held in registers (p <= 128 PASSES).
template <bool VEC, int PASSES>
__device__ __forceinline__ void row_update(const Args& a, int b, int lane) {
  constexpr int kPoints = 8 / PASSES;  // data points in registers at once
  constexpr int kUnroll = 8 / PASSES;  // neighbour rows in flight
  const int* __restrict__ idx = a.idx;
  const float* __restrict__ w = a.w;
  const float* __restrict__ X = a.X;
  const float* __restrict__ y = a.y;
  const float* __restrict__ mask = a.mask;
  const float* __restrict__ noise = a.noise;
  const float* __restrict__ theta = a.theta;
  const int K = a.K, m = a.m, p = a.p, limit = a.limit;
  const float clip = a.clip;
  const int row = a.rows[b];
  if (row < 0 || row >= limit) return;  // sentinel: never scattered, skip the work
  // Loads that depend on nothing else go first: the first 32 (idx, w)
  // pairs and the row's coefficients, a lane each.
  const int* idx_b = idx + (size_t)b * K;
  const float* w_b = w + (size_t)b * K;
  int j_cur = lane < K ? __ldg(idx_b + lane) : 0;
  float w_cur = lane < K ? __ldg(w_b + lane) : 0.f;
  const float coef_l = lane < 4 ? __ldg(a.coef + (size_t)b * a.coef_stride + lane) : 0.f;

  float4 th[PASSES];
#pragma unroll
  for (int ps = 0; ps < PASSES; ++ps)
    th[ps] = load_cols<VEC>(theta + (size_t)row * p, ps * kPassCols, lane, p);

  // Residuals and the gradient sum, kPoints data points at a time.
  float4 g[PASSES];
#pragma unroll
  for (int ps = 0; ps < PASSES; ++ps) g[ps] = make_float4(0.f, 0.f, 0.f, 0.f);
  float mass = 0.f;
  const float* Xb = X + (size_t)b * m * p;
  for (int i0 = 0; i0 < m; i0 += kPoints) {
    float4 xr[kPoints][PASSES];
    float dot[kPoints], l1[kPoints];
    // The chunk's targets and mask, lane u holding point i0 + u.
    const bool mine = lane < kPoints && i0 + lane < m;
    const float y_l = mine ? __ldg(y + (size_t)b * m + i0 + lane) : 0.f;
    const float mask_l = mine ? __ldg(mask + (size_t)b * m + i0 + lane) : 0.f;
#pragma unroll
    for (int u = 0; u < kPoints; ++u) {
      dot[u] = 0.f;
      l1[u] = 0.f;
#pragma unroll
      for (int ps = 0; ps < PASSES; ++ps) {
        xr[u][ps] = i0 + u < m ? load_cols<VEC>(Xb + (size_t)(i0 + u) * p, ps * kPassCols, lane, p)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
        dot[u] = dot4(xr[u][ps], th[ps], dot[u]);
        l1[u] = abs_sum4(xr[u][ps], l1[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kPoints; ++u) {
      if (i0 + u >= m) break;
      const float d = warp_sum(dot[u]);
      float r = 2.f * (d - __shfl_sync(kFullMask, y_l, u));
      if (a.use_clip) {
        // L1 clip of the point gradient r x: |r x|_1 = |r| |x|_1.
        const float n1 = warp_sum(l1[u]);
        r *= fminf(1.f, clip / fmaxf(fabsf(r) * n1, 1e-12f));
      }
      const float mk = __shfl_sync(kFullMask, mask_l, u);
      mass += mk;
      const float rm = r * mk;
#pragma unroll
      for (int ps = 0; ps < PASSES; ++ps) fma4(g[ps], rm, xr[u][ps]);
    }
  }

  // The neighbour sum over the real entries, in ascending k.
  float4 nb[PASSES];
#pragma unroll
  for (int ps = 0; ps < PASSES; ++ps) nb[ps] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k0 = 0; k0 < K; k0 += 32) {
    const int kn = k0 + 32 + lane;  // the next 32 pairs, in flight during this walk
    const int j_next = kn < K ? __ldg(idx_b + kn) : 0;
    const float w_next = kn < K ? __ldg(w_b + kn) : 0.f;
    unsigned live = __ballot_sync(kFullMask, w_cur != 0.f);  // warp-uniform
    while (live) {
      float wk[kUnroll];
      float4 xn[kUnroll][PASSES];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        wk[u] = 0.f;
#pragma unroll
        for (int ps = 0; ps < PASSES; ++ps) xn[u][ps] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (live) {
          const int bit = __ffs(live) - 1;  // lowest remaining k
          live &= live - 1;
          const int j = __shfl_sync(kFullMask, j_cur, bit);
          wk[u] = __shfl_sync(kFullMask, w_cur, bit);
#pragma unroll
          for (int ps = 0; ps < PASSES; ++ps)
            xn[u][ps] = load_cols<VEC>(theta + (size_t)j * p, ps * kPassCols, lane, p);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (wk[u] != 0.f)
#pragma unroll
          for (int ps = 0; ps < PASSES; ++ps) fma4(nb[ps], wk[u], xn[u][ps]);
    }
    j_cur = j_next;
    w_cur = w_next;
  }

  const float alpha = __shfl_sync(kFullMask, coef_l, 0), deg = __shfl_sync(kFullMask, coef_l, 1);
  const float cmu = __shfl_sync(kFullMask, coef_l, 2), lam2 = __shfl_sync(kFullMask, coef_l, 3);
  const float m_hat = fmaxf(mass, 1.f);
#pragma unroll
  for (int ps = 0; ps < PASSES; ++ps) {
    const float4 nz = noise != nullptr
                          ? load_cols<VEC>(noise + (size_t)b * p, ps * kPassCols, lane, p)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    const float t[4] = {th[ps].x, th[ps].y, th[ps].z, th[ps].w};
    const float gs[4] = {g[ps].x, g[ps].y, g[ps].z, g[ps].w};
    const float ns[4] = {nb[ps].x, nb[ps].y, nb[ps].z, nb[ps].w};
    const float zs[4] = {nz.x, nz.y, nz.z, nz.w};
    float o[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float grad = gs[q] / m_hat + lam2 * t[q];
      if (noise != nullptr) grad += zs[q];
      o[q] = (1.f - alpha) * t[q] + alpha * (ns[q] / deg - cmu * grad);
    }
    store_cols<VEC>(a.scratch + (size_t)b * p, ps * kPassCols, lane, p,
                    make_float4(o[0], o[1], o[2], o[3]));
  }
}

// Theta[rows[b]] = scratch[b] for a valid row.
template <bool VEC, int PASSES>
__device__ __forceinline__ void scatter_row(const Args& a, int b, int lane) {
  const int row = a.rows[b];
  if (row < 0 || row >= a.limit) return;
#pragma unroll
  for (int ps = 0; ps < PASSES; ++ps) {
    const float4 v = load_cols<VEC, false>(a.scratch + (size_t)b * a.p, ps * kPassCols, lane, a.p);
    store_cols<VEC>(a.theta + (size_t)row * a.p, ps * kPassCols, lane, a.p, v);
  }
}

// Two launches: the compute, a warp a woken row, then the scatter as its
// programmatic dependent.
template <bool VEC, int PASSES>
__global__ void __launch_bounds__(kThreads) fused_rows_kernel(const Args a) {
  // Let the scatter be scheduled now; it waits for this whole grid.
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b < a.B) row_update<VEC, PASSES>(a, b, threadIdx.x & 31);
}

template <bool VEC, int PASSES>
__global__ void __launch_bounds__(kThreads) scatter_rows_kernel(const Args a) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // every new row is written
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b < a.B) scatter_row<VEC, PASSES>(a, b, threadIdx.x & 31);
}

template <bool VEC, int PASSES>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int blocks = (a.B + kWarps - 1) / kWarps;
  fused_rows_kernel<VEC, PASSES><<<blocks, kThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, scatter_rows_kernel<VEC, PASSES>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t launch_passes(int passes, const Args& a, cudaStream_t s) {
  switch (passes) {
    case 1: return launch<VEC, 1>(a, s);
    case 2: return launch<VEC, 2>(a, s);
    case 4: return launch<VEC, 4>(a, s);
    default: return launch<VEC, 8>(a, s);
  }
}

}  // namespace

// scratch: (B, p) float32, the new rows between the compute and the
// scatter. passes: 1, 2, 4 or 8 with 128 passes >= p (the wrapper's plan);
// vec: 1 for the float4 instance (p % 4 == 0; theta, X, noise and scratch
// 16-byte aligned), 0 for the scalar one.
extern "C" int fused_row_update_launch(const int* rows, const int* idx, const float* w,
                                       const float* coef, int coef_stride, const float* X,
                                       const float* y, const float* mask, const float* noise,
                                       float* theta, float* scratch, int B, int K, int m,
                                       int p, int limit, float clip, int use_clip, int passes,
                                       int vec, void* stream) {
  if (B <= 0 || p <= 0) return 0;
  if (p > kMaxP || m > kMaxM || m < 0 || K < 0) return static_cast<int>(cudaErrorInvalidValue);
  if ((passes != 1 && passes != 2 && passes != 4 && passes != 8) || passes * kPassCols < p)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto aligned = [](const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; };
  if (vec && (p % 4 != 0 || !aligned(theta) || !aligned(X) || !aligned(scratch) ||
              (noise != nullptr && !aligned(noise))))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{rows, idx, w, coef, coef_stride, X, y, mask, noise, theta, scratch,
               B, K, m, p, limit, clip, use_clip};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(vec ? launch_passes<true>(passes, a, s)
                              : launch_passes<false>(passes, a, s));
}

extern "C" const char* kernel_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
