// GroupNorm over an NHWC (channels_last) tensor, f32 statistics, for sm_90a.
//
// Replaces: loco_edit_tpu/ops/pallas/groupnorm_stats.py::_groupnorm_stats_impl
// (kernel body _stats_kernel), the one-pass per-(batch, channel) sum and
// sum-of-squares that feed ops/norms.py::group_norm_f32. This file computes
// the whole group_norm_f32: statistics, group reduction and the normalize +
// affine pass, with the same formula (var = max(E[x^2] - mean^2, 0) in f32,
// rstd = 1 / sqrt(var + eps)).
//
// What bounds it on the H100: bytes. At the P2 shapes (C = 128..1024 at
// 256^2..8^2 pixels) it does ~5 flops per element and must read x twice
// (once for the statistics, once to normalize) and write y once: three
// streams where the bound counts two, so it can reach at most 2/3 of it.
//
// What the design does about it, in two launches:
//   - Every thread moves 16 bytes per load and store (8 bf16 or 4 f32
//     channels); a block is (C / vec / NV) x rows threads, so a warp reads
//     whole contiguous runs of pixels, and each thread starts kUnroll loads
//     of each of its NV vectors before it uses any of them. NV = 1 up to
//     512 vectors a pixel; wider rows (f32 at C = 2560, the SD U-Net's skip
//     concatenation: 640 vectors) give each thread NV = 2 vectors, the
//     second blockDim.x vectors after the first, so a block row stays
//     within 512 threads and each channel keeps one thread and one
//     summation order.
//   - Launch 1 (statistics): grid (chunks, B). Each block sums its chunk of
//     pixels per channel in registers, reduces rows and then the channels of
//     each group in shared memory in a fixed order, and writes per-chunk
//     group partials. The TPU kernel carried its accumulators across a
//     sequential grid; here the last block to finish for a batch element
//     (a __threadfence + integer atomicAdd ticket) reduces that element's
//     partials in a fixed order and writes mean and rstd, then resets the
//     ticket to 0 for the next call. No float atomics: the same bits every
//     run, whichever block comes last.
//   - Launch 2 (normalize): grid (chunks, B). Each thread is fixed on its
//     channels and keeps their mean, rstd, scale and bias in registers
//     outside the pixel loop: no division or modulo per element.
//   - The chunk (pixels per block) is chosen by the wrapper
//     (ops/groupnorm.py::launch_geometry) so that batch 1 still fills the
//     card.
//   Later work: fusing SiLU and the ResBlock scale-shift into launch 2, and
//   one read for tensors that fit a thread-block cluster's shared memory.
//
// Two more entries expose the launches on their own, for spatial
// parallelism (parallel/sp.py), where each rank holds a band of rows and
// the statistics must be those of the whole image:
//   - loco_group_norm_sums: launch 1 with the same fixed-order reduction,
//     ending in the per-(element, group) f32 sum and sum of squares instead
//     of mean and rstd;
//   - loco_group_norm_apply: launch 2 from such sums (all-reduced across
//     the ranks in between) and the element count n they cover; each thread
//     forms its groups' mean and rstd with finalize(), the formula the
//     fused entry's last block uses, so that sums -> apply gives the fused
//     entry's bits on one rank.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kUnroll = 4;  // 16-byte loads in flight per thread
constexpr int kSubsets = 8; // chunk subsets per group in the final reduce

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static void unpack(const uint4& u, float (&f)[4]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float (&f)[4]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void unpack(const uint4& u, float (&f)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 p = __bfloat1622float2(h[j]);
      f[2 * j] = p.x;
      f[2 * j + 1] = p.y;
    }
  }
  __device__ static uint4 pack(const float (&f)[8]) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
    return u;
  }
};

// mean and rstd of a group from its sum a, sum of squares a2 and count n:
// var = max(E[x^2] - mean^2, 0), the product rounded on its own (no FMA).
__device__ __forceinline__ void finalize(float a, float a2, float n, float eps,
                                         float& mean, float& rstd) {
  mean = a / n;
  const float var = fmaxf(a2 / n - __fmul_rn(mean, mean), 0.f);
  rstd = 1.f / sqrtf(var + eps);
}

// Launch 1. grid (chunks, B), block (C / vec / NV, rows). part: per-chunk group
// sums then sums of squares, each (B, chunks, G); stats: mean (B, G) then
// rstd (B, G), or with kSums the group sums (B, G) then sums of squares
// (B, G); tickets: (B,) ints, 0 on entry and on exit.
template <typename T, int NV, bool kSums>
__global__ void gn_stats_kernel(const T* __restrict__ x, float* __restrict__ part,
                                float* __restrict__ stats, int* __restrict__ tickets,
                                int hw, int c, int groups, int chunk, float eps) {
  constexpr int kVec = Vec<T>::kN;
  extern __shared__ float sh[];
  __shared__ bool is_last;
  const int rows = blockDim.y;
  const int nthreads = blockDim.x * rows;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  const int nb = gridDim.y;
  const int nchunks = gridDim.x;
  const int ch0 = threadIdx.x * kVec;
  const int vstride = blockDim.x * kVec;  // channels between a thread's vectors
  const int p1 = min((blockIdx.x + 1) * chunk, hw);
  const T* xb = x + (size_t)b * hw * c + ch0;

  float s[NV][kVec], ss[NV][kVec];
#pragma unroll
  for (int v = 0; v < NV; ++v)
#pragma unroll
    for (int j = 0; j < kVec; ++j) s[v][j] = ss[v][j] = 0.f;
  for (int p = blockIdx.x * chunk + threadIdx.y; p < p1; p += rows * kUnroll) {
    uint4 u[kUnroll][NV];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int pk = p + k * rows;
#pragma unroll
      for (int v = 0; v < NV; ++v)
        u[k][v] = pk < p1 ? __ldg(reinterpret_cast<const uint4*>(
                                xb + (size_t)pk * c + v * vstride))
                          : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        float f[kVec];
        Vec<T>::unpack(u[k][v], f);
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          s[v][j] += f[j];
          ss[v][j] += f[j] * f[j];
        }
      }
  }

  // Rows, then the channels of each group, in a fixed order.
  float* sh_s = sh;                 // [rows][C]
  float* sh_ss = sh + rows * c;
#pragma unroll
  for (int v = 0; v < NV; ++v)
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      sh_s[threadIdx.y * c + ch0 + v * vstride + j] = s[v][j];
      sh_ss[threadIdx.y * c + ch0 + v * vstride + j] = ss[v][j];
    }
  __syncthreads();
  for (int ch = tid; ch < c; ch += nthreads) {
    float a = sh_s[ch], a2 = sh_ss[ch];
    for (int r = 1; r < rows; ++r) {
      a += sh_s[r * c + ch];
      a2 += sh_ss[r * c + ch];
    }
    sh_s[ch] = a;                   // row 0 of column ch: only this thread
    sh_ss[ch] = a2;
  }
  __syncthreads();
  const int cg = c / groups;
  float* part_s = part;
  float* part_ss = part + (size_t)nb * nchunks * groups;
  for (int g = tid; g < groups; g += nthreads) {
    float a = 0.f, a2 = 0.f;
    for (int j = 0; j < cg; ++j) {
      a += sh_s[g * cg + j];
      a2 += sh_ss[g * cg + j];
    }
    const size_t o = ((size_t)b * nchunks + blockIdx.x) * groups + g;
    part_s[o] = a;
    part_ss[o] = a2;
    __threadfence();                // partials visible before the ticket
  }
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(&tickets[b], 1) == nchunks - 1;
  __syncthreads();
  if (!is_last) return;

  // The last block of element b: reduce its chunks' partials in a fixed
  // order (subset k sums chunks k, k + 8, ...; then the 8 subsets in order).
  __threadfence();
  float* fs = sh;                   // [G][kSubsets], shared memory is free now
  float* fss = sh + groups * kSubsets;
  for (int i = tid; i < groups * kSubsets; i += nthreads) {
    const int g = i / kSubsets;
    float a = 0.f, a2 = 0.f;
    for (int k = i % kSubsets; k < nchunks; k += kSubsets) {
      const size_t o = ((size_t)b * nchunks + k) * groups + g;
      a += __ldcg(part_s + o);
      a2 += __ldcg(part_ss + o);
    }
    fs[i] = a;
    fss[i] = a2;
  }
  __syncthreads();
  const float n = (float)hw * (float)cg;
  for (int g = tid; g < groups; g += nthreads) {
    float a = 0.f, a2 = 0.f;
    for (int k = 0; k < kSubsets; ++k) {
      a += fs[g * kSubsets + k];
      a2 += fss[g * kSubsets + k];
    }
    if (kSums) {
      stats[b * groups + g] = a;
      stats[(nb + b) * groups + g] = a2;
    } else {
      float mean, rstd;
      finalize(a, a2, n, eps, mean, rstd);
      stats[b * groups + g] = mean;
      stats[(nb + b) * groups + g] = rstd;
    }
  }
  if (tid == 0) tickets[b] = 0;
}

// Launch 2. grid (chunks, B), block (C / vec / NV, rows):
// y = (x - mean) * rstd * scale + bias, in x's dtype. stats holds mean and
// rstd, or with kFromSums the sums of n elements a group, as launch 1 with
// kSums writes them.
template <typename T, int NV, bool kFromSums>
__global__ void gn_apply_kernel(const T* __restrict__ x, T* __restrict__ y,
                                const float* __restrict__ stats,
                                const float* __restrict__ scale,
                                const float* __restrict__ bias, int hw, int c,
                                int groups, int chunk, float n, float eps) {
  constexpr int kVec = Vec<T>::kN;
  const int rows = blockDim.y;
  const int b = blockIdx.y;
  const int ch0 = threadIdx.x * kVec;
  const int vstride = blockDim.x * kVec;
  const int cg = c / groups;
  float mu[NV][kVec], rs[NV][kVec], sc[NV][kVec], bi[NV][kVec];
#pragma unroll
  for (int v = 0; v < NV; ++v)
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int ch = ch0 + v * vstride + j;
      const int g = ch / cg;
      if (kFromSums) {
        finalize(stats[b * groups + g], stats[(gridDim.y + b) * groups + g], n,
                 eps, mu[v][j], rs[v][j]);
      } else {
        mu[v][j] = stats[b * groups + g];
        rs[v][j] = stats[(gridDim.y + b) * groups + g];
      }
      sc[v][j] = scale[ch];
      bi[v][j] = bias[ch];
    }
  const int p1 = min((blockIdx.x + 1) * chunk, hw);
  const size_t base = (size_t)b * hw * c + ch0;
  for (int p = blockIdx.x * chunk + threadIdx.y; p < p1; p += rows * kUnroll) {
    uint4 u[kUnroll][NV];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int pk = p + k * rows;
      if (pk < p1) {
#pragma unroll
        for (int v = 0; v < NV; ++v)
          u[k][v] = __ldcs(reinterpret_cast<const uint4*>(
              x + base + (size_t)pk * c + v * vstride));
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int pk = p + k * rows;
      if (pk >= p1) break;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        float f[kVec];
        Vec<T>::unpack(u[k][v], f);
#pragma unroll
        for (int j = 0; j < kVec; ++j)
          f[j] = (f[j] - mu[v][j]) * rs[v][j] * sc[v][j] + bi[v][j];
        *reinterpret_cast<uint4*>(y + base + (size_t)pk * c + v * vstride) =
            Vec<T>::pack(f);
      }
    }
  }
}

// mode: 0 = fused (stats then normalize), 1 = sums only into `out`
// ((2, B, G) f32), 2 = normalize from the sums in `out` covering n elements.
template <typename T, int NV>
int launch(int mode, const void* x, void* y, float* out, const float* scale,
           const float* bias, float* work, int* tickets, int b, int hw, int c,
           int groups, float n, float eps, int rows, int chunk,
           cudaStream_t stream) {
  const int nchunks = (hw + chunk - 1) / chunk;
  const dim3 grid(nchunks, b), block(c / Vec<T>::kN / NV, rows);
  if (mode == 2) {
    gn_apply_kernel<T, NV, true><<<grid, block, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), out, scale, bias, hw, c,
        groups, chunk, n, eps);
    return (int)cudaGetLastError();
  }
  float* part = work;
  const int fin = 2 * groups * kSubsets, red = 2 * rows * c;
  const size_t smem = (fin > red ? fin : red) * sizeof(float);
  if (mode == 1) {
    gn_stats_kernel<T, NV, true><<<grid, block, smem, stream>>>(
        static_cast<const T*>(x), part, out, tickets, hw, c, groups, chunk, eps);
    return (int)cudaGetLastError();
  }
  float* stats = work + 2 * (size_t)b * nchunks * groups;
  gn_stats_kernel<T, NV, false><<<grid, block, smem, stream>>>(
      static_cast<const T*>(x), part, stats, tickets, hw, c, groups, chunk, eps);
  gn_apply_kernel<T, NV, false><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), stats, scale, bias, hw, c,
      groups, chunk, 0.f, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_nv(int nvec, int mode, const void* x, void* y, float* out,
              const float* scale, const float* bias, float* work, int* tickets,
              int b, int hw, int c, int groups, float n, float eps, int rows,
              int chunk, cudaStream_t stream) {
  if (nvec == 1)
    return launch<T, 1>(mode, x, y, out, scale, bias, work, tickets, b, hw, c,
                        groups, n, eps, rows, chunk, stream);
  if (nvec == 2)
    return launch<T, 2>(mode, x, y, out, scale, bias, work, tickets, b, hw, c,
                        groups, n, eps, rows, chunk, stream);
  return (int)cudaErrorInvalidValue;
}

int dispatch(int is_bf16, int nvec, int mode, const void* x, void* y,
             float* out, const float* scale, const float* bias, float* work,
             int* tickets, int b, int hw, int c, int groups, float n, float eps,
             int rows, int chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_nv<__nv_bfloat16>(nvec, mode, x, y, out, scale, bias, work,
                                    tickets, b, hw, c, groups, n, eps, rows,
                                    chunk, s);
  return launch_nv<float>(nvec, mode, x, y, out, scale, bias, work, tickets, b,
                          hw, c, groups, n, eps, rows, chunk, s);
}

}  // namespace

// x, y: (B, H*W, C) contiguous and 16-byte aligned, f32 (is_bf16 = 0) or
// bf16 (is_bf16 = 1). scale, bias: (C,) f32. work: f32 scratch of
// 2 * B * ceil(HW / chunk) * groups + 2 * B * groups floats. tickets: B ints,
// all 0 (left 0). nvec (1 or 2), rows and chunk from
// ops/groupnorm.py::launch_geometry. Requires C % 32 == 0, C % groups == 0
// and C / vec % nvec == 0. Returns cudaGetLastError().
extern "C" int loco_group_norm(const void* x, void* y, const float* scale,
                               const float* bias, float* work, int* tickets,
                               int b, int hw, int c, int groups, float eps,
                               int nvec, int rows, int chunk, int is_bf16,
                               void* stream) {
  return dispatch(is_bf16, nvec, 0, x, y, nullptr, scale, bias, work, tickets,
                  b, hw, c, groups, 0.f, eps, rows, chunk, stream);
}

// Launch 1 alone. sums: (2, B, G) f32 out, the group sums then the sums of
// squares of x over its hw pixels, reduced in the fused entry's order. x,
// work, tickets and the geometry as for loco_group_norm.
extern "C" int loco_group_norm_sums(const void* x, float* sums, float* work,
                                    int* tickets, int b, int hw, int c,
                                    int groups, int nvec, int rows, int chunk,
                                    int is_bf16, void* stream) {
  return dispatch(is_bf16, nvec, 1, x, nullptr, sums, nullptr, nullptr, work,
                  tickets, b, hw, c, groups, 0.f, 0.f, rows, chunk, stream);
}

// Launch 2 alone. sums: (2, B, G) f32 in, as loco_group_norm_sums writes
// them, covering n elements a group (after an all-reduce across ranks, n
// counts every rank's pixels). x, y, scale, bias and the geometry as for
// loco_group_norm.
extern "C" int loco_group_norm_apply(const void* x, void* y, const float* sums,
                                     const float* scale, const float* bias,
                                     int b, int hw, int c, int groups, float n,
                                     float eps, int nvec, int rows, int chunk,
                                     int is_bf16, void* stream) {
  return dispatch(is_bf16, nvec, 2, x, y, const_cast<float*>(sums), scale,
                  bias, nullptr, nullptr, b, hw, c, groups, n, eps, rows, chunk,
                  stream);
}
