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
// benchmarks/bench_kernels.py. A row's clip factor needs the whole row, and
// a column's sum needs every row, so the work cannot split into
// independent tiles in both directions at once.
//
// The design (the launch is planned in kernels/dp_clip_noise.py::clip_plan):
//
// * clip_partial_kernel: the grid is (row blocks, column blocks). A block
//   of 256 threads takes `rows` rows and `passes` passes of 256 loads
//   across its columns; each thread loads 16 bytes a row and pass (4
//   float32 or 8 bf16; one element in the scalar instance, used where
//   grads or its rows are not 16-byte aligned), all of them issued before
//   any is used, and keeps them in registers: rows x passes <= 8 words, so
//   grads is read once. Where one block covers a whole row (D <= 8 passes:
//   8192 float32 columns), the block alone has its rows' squared norms
//   (warp shuffles, then the warps in order). Where it does not, a
//   thread-block cluster of `cluster` (<= 8) blocks spans the row, and
//   each block sums the cluster's partial norms, exchanged through
//   distributed shared memory, in rank order: every block of the cluster
//   gets the same clip factors. The block then scales the tile it holds
//   and sums its rows in ascending order into a partial row of column
//   sums; with one row block (N <= rows) that is the result, written out
//   directly.
// * combine_kernel, a programmatic dependent launch (griddepcontrol), only
//   when there are several row blocks: a block of 8 warps takes 32 columns;
//   warp w sums its contiguous share of the partial rows in ascending
//   order, then the 8 warp sums are added in warp order, divided by
//   n_total, and the noise is added.
//
// At (256, 4096) float32 a block holds 2 whole rows (4 passes of 1024
// columns, 8 loads of 16 bytes in flight a thread): 128 blocks, one wave
// of the 132 SMs, no cluster; the combine is 128 blocks summing 128
// partial rows (2 MB, in L2) per column. A cluster would let a block hold
// 8 rows of a quarter of the width and leave 32 partial rows, but a
// cluster launch costs the card about a microsecond more for each doubling
// of its size, more than the smaller combine saves (chip_smoke.py phase 3
// times the alternatives), so the plan takes the smallest cluster that
// keeps the tile in registers.
//
// A row wider than 8 passes of a cluster of 8 blocks (65,536 float32
// columns with 16-byte loads, 16,384 in the scalar instance) does not fit
// the registers: the block streams its columns twice, once for the norms
// and once for the sums; the second read mostly hits L2.
//
// No atomics: every sum has one fixed order (given the plan, which depends
// only on N, D, the dtype and the alignment), so results repeat bit for
// bit from launch to launch. Ragged N and D are masked in the kernels;
// nothing is padded.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;        // most rows a block takes
constexpr int kSlots = 8;       // 16-byte words of grads a thread holds in registers
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kCombineCols = 32;  // columns a combine block sums, one a lane
constexpr unsigned kFullMask = 0xffffffffu;

struct Args {
  const void* g;
  const float* noise;
  float* out;
  float* partial;  // (row_blocks, D) when row_blocks > 1
  int N, D, rows, passes;
  float clip, noise_scale, n_total;
};

// The elements one thread loads at a time: 16 bytes, or one element.
template <typename T, bool VEC>
struct Load {
  static constexpr int kN = VEC ? 16 / static_cast<int>(sizeof(T)) : 1;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, bool VEC>
__device__ __forceinline__ void load(const T* p, float (&v)[Load<T, VEC>::kN]) {
  if constexpr (!VEC) {
    v[0] = to_f32(*p);
  } else if constexpr (sizeof(T) == 4) {
    const float4 w = *reinterpret_cast<const float4*>(p);
    v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
  } else {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&w);
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = __bfloat162float(h[u]);
  }
}

template <int N>
__device__ __forceinline__ float sumsq(const float (&v)[N]) {
  float s = 0.f;
#pragma unroll
  for (int u = 0; u < N; ++u) s = fmaf(v[u], v[u], s);
  return s;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Column sums of the block's scaled rows, written as a partial row or, with
// one row block, as the result.
template <int N>
__device__ __forceinline__ void emit(const Args& a, size_t c, const float (&acc)[N]) {
  if (a.partial != nullptr) {
    float* dst = a.partial + (size_t)blockIdx.x * a.D + c;
    if constexpr (N % 4 == 0) {
#pragma unroll
      for (int u = 0; u < N; u += 4)
        *reinterpret_cast<float4*>(dst + u) = make_float4(acc[u], acc[u + 1], acc[u + 2], acc[u + 3]);
    } else {
#pragma unroll
      for (int u = 0; u < N; ++u) dst[u] = acc[u];
    }
  } else {
#pragma unroll
    for (int u = 0; u < N; ++u) a.out[c + u] = acc[u] / a.n_total + a.noise_scale * a.noise[c + u];
  }
}

// PASSES > 0: the block holds its tile in registers, rows x PASSES words of
// 16 bytes a thread (at most kSlots), and reads grads once. PASSES == 0:
// `a.passes` passes, streamed twice (norms, then sums).
template <typename T, bool VEC, int PASSES>
__global__ void __launch_bounds__(kThreads) clip_partial_kernel(const Args a) {
  constexpr int kN = Load<T, VEC>::kN;
  constexpr int kPassCols = kThreads * kN;
  constexpr int kR = PASSES > 0 ? kSlots / PASSES : kRows;  // most rows a block
  __shared__ float s_warp[kWarps][kR];
  __shared__ float s_ssq[kR];
  __shared__ float s_scale[kR];
  // Let the combine be scheduled now; it waits for this whole grid.
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  cg::cluster_group cluster = cg::this_cluster();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * a.rows;
  const int nr = min(a.rows, a.N - r0);
  const size_t D = a.D;
  const size_t c0 = (size_t)blockIdx.y * a.passes * kPassCols + (size_t)threadIdx.x * kN;
  const T* g = static_cast<const T*>(a.g) + (size_t)r0 * D;

  float x[PASSES > 0 ? kSlots : 1][kN];  // the tile: row r, pass q in word r * PASSES + q
  float ss[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) ss[r] = 0.f;
  if constexpr (PASSES > 0) {
#pragma unroll
    for (int r = 0; r < kR; ++r) {
#pragma unroll
      for (int q = 0; q < PASSES; ++q) {
        const size_t c = c0 + (size_t)q * kPassCols;
        if (r < nr && c < D) {
          load<T, VEC>(g + r * D + c, x[r * PASSES + q]);
        } else {
#pragma unroll
          for (int u = 0; u < kN; ++u) x[r * PASSES + q][u] = 0.f;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) {
#pragma unroll
      for (int q = 0; q < PASSES; ++q) ss[r] += sumsq(x[r * PASSES + q]);
    }
  } else {
    for (int q = 0; q < a.passes; ++q) {
      const size_t c = c0 + (size_t)q * kPassCols;
      if (c >= D) break;
      float v[kR][kN];
#pragma unroll
      for (int r = 0; r < kR; ++r)
        if (r < nr) load<T, VEC>(g + r * D + c, v[r]);
#pragma unroll
      for (int r = 0; r < kR; ++r)
        if (r < nr) ss[r] += sumsq(v[r]);
    }
  }

  // The block's partial squared norms, then the cluster's, in rank order.
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    float v = ss[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
    if (lane == 0) s_warp[warp][r] = v;
  }
  __syncthreads();
  if (threadIdx.x < kR) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += s_warp[w][threadIdx.x];
    s_ssq[threadIdx.x] = t;
  }
  cluster.sync();
  if (threadIdx.x < nr) {
    float t = 0.f;
    for (unsigned k = 0; k < cluster.num_blocks(); ++k)
      t += *cluster.map_shared_rank(&s_ssq[threadIdx.x], k);
    const float nrm = sqrtf(fmaxf(t, 1e-24f));
    s_scale[threadIdx.x] = fminf(1.f, a.clip / fmaxf(nrm, 1e-12f));
  }
  // This block's reads of its peers' shared memory are done. Arrive now and
  // wait before leaving, so no block's shared memory goes while a peer reads.
  cluster_arrive();
  __syncthreads();

  const int passes = PASSES > 0 ? PASSES : a.passes;
  for (int q = 0; q < passes; ++q) {
    const size_t c = c0 + (size_t)q * kPassCols;
    if (c >= D) break;
    float acc[kN];
#pragma unroll
    for (int u = 0; u < kN; ++u) acc[u] = 0.f;
    if constexpr (PASSES > 0) {
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        if (r < nr) {
          const float s = s_scale[r];
#pragma unroll
          for (int u = 0; u < kN; ++u) acc[u] = fmaf(s, x[r * PASSES + q][u], acc[u]);
        }
      }
    } else {
      float v[kR][kN];
#pragma unroll
      for (int r = 0; r < kR; ++r)
        if (r < nr) load<T, VEC>(g + r * D + c, v[r]);
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        if (r < nr) {
          const float s = s_scale[r];
#pragma unroll
          for (int u = 0; u < kN; ++u) acc[u] = fmaf(s, v[r][u], acc[u]);
        }
      }
    }
    emit(a, c, acc);
  }
  cluster_wait();
}

__global__ void __launch_bounds__(kThreads)
combine_kernel(const float* __restrict__ partial, const float* __restrict__ noise,
               float* __restrict__ out, int D, int row_blocks, float noise_scale,
               float n_total) {
  __shared__ float s_part[kWarps][kCombineCols];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * kCombineCols + lane;
  const int per = (row_blocks + kWarps - 1) / kWarps;
  const int y0 = min(row_blocks, warp * per), y1 = min(row_blocks, y0 + per);
  const float nz = c < D ? noise[c] : 0.f;  // noise is ready before the partials
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // every partial row is written
  float acc = 0.f;
  if (c < D) {
#pragma unroll 8
    for (int y = y0; y < y1; ++y) acc += partial[(size_t)y * D + c];
  }
  s_part[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && c < D) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += s_part[w][lane];
    out[c] = t / n_total + noise_scale * nz;
  }
}

template <typename T, bool VEC, int PASSES>
cudaError_t launch(const Args& a, int cluster, int row_blocks, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(row_blocks, cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cluster;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;  // a cluster launch costs more to schedule
  cudaError_t err = cudaLaunchKernelEx(&cfg, clip_partial_kernel<T, VEC, PASSES>, a);
  if (err != cudaSuccess || a.partial == nullptr) return err != cudaSuccess ? err : cudaGetLastError();
  cudaLaunchConfig_t dep = {};
  dep.gridDim = dim3((a.D + kCombineCols - 1) / kCombineCols);
  dep.blockDim = dim3(kThreads);
  dep.stream = s;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  dep.attrs = pdl;
  dep.numAttrs = 1;
  err = cudaLaunchKernelEx(&dep, combine_kernel, static_cast<const float*>(a.partial), a.noise,
                           a.out, a.D, row_blocks, a.noise_scale, a.n_total);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The resident instance for 1, 2, 4 or 8 passes where rows x passes words
// fit the tile, the streamed one otherwise.
template <typename T, bool VEC>
cudaError_t by_passes(const Args& a, int cluster, int row_blocks, cudaStream_t s) {
  if (a.rows * a.passes <= kSlots) {
    switch (a.passes) {
      case 1: return launch<T, VEC, 1>(a, cluster, row_blocks, s);
      case 2: return launch<T, VEC, 2>(a, cluster, row_blocks, s);
      case 4: return launch<T, VEC, 4>(a, cluster, row_blocks, s);
      case 8: return launch<T, VEC, 8>(a, cluster, row_blocks, s);
      default: break;
    }
  }
  return launch<T, VEC, 0>(a, cluster, row_blocks, s);
}

}  // namespace

// grads: (N, D), float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1); partial:
// (row_blocks, D) float32 when row_blocks > 1, else unused. The plan
// (kernels/dp_clip_noise.py::clip_plan): `vec` 16-byte loads (grads and
// partial 16-byte aligned, D * itemsize a multiple of 16), `passes` column
// passes of 256 loads a block, `cluster` blocks across D, `rows` rows a
// block, row_blocks = ceil(N / rows).
extern "C" int dp_clip_noise_launch(const void* grads, int is_bf16, const float* noise,
                                    float* out, float* partial, int N, int D, float clip,
                                    float noise_scale, float n_total, int vec, int passes,
                                    int cluster, int rows, int row_blocks, void* stream) {
  if (N <= 0 || D <= 0 || rows < 1 || rows > kRows || passes < 1 || cluster < 1 ||
      cluster > kMaxCluster || row_blocks != (N + rows - 1) / rows)
    return static_cast<int>(cudaErrorInvalidValue);
  const int item = is_bf16 ? 2 : 4;
  const long long pass_cols = (long long)kThreads * (vec ? 16 / item : 1);
  if ((long long)cluster * passes * pass_cols < D || (long long)(cluster - 1) * passes * pass_cols >= D)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto aligned = [](const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; };
  if (row_blocks > 1 && partial == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (vec && (((long long)D * item) % 16 != 0 || !aligned(grads) ||
              (row_blocks > 1 && !aligned(partial))))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{grads, noise, out, row_blocks > 1 ? partial : nullptr, N, D, rows, passes,
               clip, noise_scale, n_total};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16)
    err = vec ? by_passes<__nv_bfloat16, true>(a, cluster, row_blocks, s)
              : by_passes<__nv_bfloat16, false>(a, cluster, row_blocks, s);
  else
    err = vec ? by_passes<float, true>(a, cluster, row_blocks, s)
              : by_passes<float, false>(a, cluster, row_blocks, s);
  return static_cast<int>(err);
}

extern "C" const char* kernel_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
