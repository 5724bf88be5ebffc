// The operands of the 3xTF32 convolution route (ops/conv.py), for sm_90a.
//
// Replaces no TPU kernel: the JAX package leaves f32 convolutions to XLA.
// It was added so that an exact-f32 convolution can run as two cuDNN TF32
// convolutions. Each value v is split into hi = v rounded to TF32
// (cvt.rna: 10 mantissa bits, to nearest) and lo = v - hi (exact in f32).
// One pass over an activation writes hi, cut into chunks of its channels
// (one convolution each: the route keeps each tensor-core accumulator
// short), and the pair [hi, lo] with the depth doubled, so that the route
// sums hi*hi chunk by chunk and, in one more convolution, hi*lo + lo*hi
// against the weight's [lo, hi] (made once per weight, in PyTorch).
//
// What bounds it on the H100: bytes. It reads each value once (4 bytes) and
// writes it three times (12), and does two operations a value. Each thread
// moves 16-byte vectors where a row's length allows, and a grid-stride loop
// over 16 blocks an SM keeps the loads in flight.
//
// Layout: `in` is n values in rows of `row` (a channels_last activation:
// rows of C channels, one a pixel). hi holds the rows' chunks of `width`
// channels one chunk after another, each chunk a channels_last tensor of
// its own: hi[g * (n / row) * width + r * width + j] = hi of
// in[r * row + g * width + j]. pair holds each row doubled,
// pair[r * 2 * row + c] = hi and pair[(r * 2 + 1) * row + c] = lo of
// in[r * row + c].

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

__device__ __forceinline__ float tf32_rna(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

template <int V>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  __device__ static float get(const T& v, int) { return v; }
  __device__ static void set(T& v, int, float x) { v = x; }
};
template <>
struct Vec<4> {
  using T = float4;
  __device__ static float get(const T& v, int i) {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
  }
  __device__ static void set(T& v, int i, float x) {
    if (i == 0) v.x = x; else if (i == 1) v.y = x; else if (i == 2) v.z = x; else v.w = x;
  }
};

// V values a step; width % V == 0, so a vector never crosses a chunk
template <int V>
__global__ void __launch_bounds__(kThreads)
split_kernel(const float* __restrict__ in, float* __restrict__ hi_out,
             float* __restrict__ pair, long long n, long long row, long long width) {
  using W = Vec<V>;
  using T = typename W::T;
  const long long step = (long long)gridDim.x * blockDim.x * V;
  const long long chunk = n / row * width;
  for (long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * V; i < n;
       i += step) {
    const T v = *reinterpret_cast<const T*>(in + i);
    T hi, lo;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float x = W::get(v, j);
      const float h = tf32_rna(x);
      W::set(hi, j, h);
      W::set(lo, j, x - h);
    }
    const long long r = i / row, c = i - r * row, g = c / width;
    *reinterpret_cast<T*>(hi_out + g * chunk + r * width + (c - g * width)) = hi;
    float* o = pair + i + r * row;   // (r * 2) * row + c
    *reinterpret_cast<T*>(o) = hi;
    *reinterpret_cast<T*>(o + row) = lo;
  }
}

}  // namespace

// in: n f32 values in rows of `row`; hi_out: n values in chunks of `width`
// (a divisor of row) channels; pair: 2 n values, each row doubled into
// [hi, lo]. All device pointers; returns the launch's cudaError_t.
extern "C" int loco_conv_split(const float* in, float* hi_out, float* pair, long long n,
                               long long row, long long width, void* stream) {
  if (n <= 0) return 0;
  if (width <= 0 || row % width) return (int)cudaErrorInvalidValue;
  const auto aligned = [](const float* p) {
    return reinterpret_cast<unsigned long long>(p) % 16 == 0;
  };
  const bool vec4 = width % 4 == 0 && aligned(in) && aligned(hi_out) && aligned(pair);
  const int v = vec4 ? 4 : 1;
  const long long want = (n / v + kThreads - 1) / kThreads;
  const int blocks = (int)(want < kMaxBlocks ? want : kMaxBlocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4)
    split_kernel<4><<<blocks, kThreads, 0, s>>>(in, hi_out, pair, n, row, width);
  else
    split_kernel<1><<<blocks, kThreads, 0, s>>>(in, hi_out, pair, n, row, width);
  return (int)cudaGetLastError();
}
