// Flash attention forward (online softmax) for sm_90a, two routes chosen by
// dtype: bf16 on the tensor cores, f32 on the FMA units.
//
// Replaces: loco_edit_tpu/ops/pallas/flash_attention.py::flash_attention
// (kernel body _flash_kernel): softmax((q * d^-1/4)(k * d^-1/4)^T) v with the
// softmax and the accumulation in f32 and the output in the input dtype.
//
// What bounds it on the H100: bytes. At the P2 shapes, (B, 8, 256, 64) and
// (B, 8, 64, 64), one (batch, head) reads 3 * N * D and writes N * D values
// for 4 * N^2 * D flops: ~128 flops per byte at N = 256, below the ~295
// flop/byte ridge of the bf16 tensor cores, and far below it at N = 64.
// The DDPM U-Net's single-head attention, (B, 1, 256, 512) and
// (B, 1, 64, 512), has the same flops per byte. mma.sync (not wgmma) is
// enough to stay under the byte bound.
//
// bf16 route (the model's dtype), FlashAttention-2 style:
//   - One block of 4 warps per (batch * head, 64-row query tile, slice of
//     output columns); each warp owns 16 query rows. S = Q K^T and O += P V
//     run as mma.sync.m16n8k16 bf16 products with f32 accumulators; Q, K and
//     V fragments come from shared memory by ldmatrix (ldmatrix.trans for V).
//   - Q and K/V tiles are staged in bf16 by 16-byte cp.async, K/V
//     double-buffered, rows padded by 16 bytes so ldmatrix has no bank
//     conflicts. Each thread rounds q * d^-1/4 and k * d^-1/4 to bf16 in
//     place on the chunks it copied, as the plain version rounds qs and ks.
//   - The online softmax (row max, row sum, rescale) stays in f32 registers
//     with quad shuffles; P is rounded to bf16 in registers and fed as the A
//     operand of P V; the final division by the row sum is in f32. The
//     output goes through shared memory for 16-byte stores.
//   - Any N_q and N_kv (the SD U-Net's cross-attention has N_q = 4096..64
//     queries against N_kv = 77 text keys): the key loop runs to N_kv, the
//     ragged last key tile (77 = 64 + 13) is zero-filled by cp.async (a
//     source size of 0) and its logits past N_kv are set to -inf before the
//     running max; query rows >= N_q are not stored. Strided (head-split)
//     views are taken as they are; the wrapper checks 16-byte alignment.
//   - Wide heads (D = 256, 512; the DDPM U-Net's D = C = 512): a third grid
//     axis cuts the output columns into D / 128 slices. Each block still
//     forms the full logits S over all D (Q stays whole in shared memory,
//     K tiles are D wide) and runs the same online softmax, but accumulates
//     only O[:, slice] += P V[:, slice], so its accumulators and its P V code
//     are those of the D = 128 route. At D <= 128 there is one slice and Q
//     fragments stay in registers; at D > 128 they are read from shared
//     memory per k-step (32 k-steps would hold 128 registers). D = 512 takes
//     32-key tiles so that Q (64 KB), double-buffered K (2 x 32 KB) and V
//     slices (2 x 8 KB) fit the opt-in shared memory. The cost: S is formed
//     D / 128 times and K read that many times (from L2 after the first).
//   - The SD 1.5 / LCM head dims (8 heads of 320, 640, 1280): D = 40 and 80
//     are not multiples of 16 or of 16-wide n-tile pairs. Q K^T runs over D
//     rounded up to 16 (40 -> 48: a third k-step over Q and K columns held
//     at zero in shared memory), and P V ends on a lone 8-wide n-tile
//     (ldmatrix .x2.trans) where D / 8 is odd. D = 160 is cut into two
//     equal 80-column slices (kSlices = ceil(D / 128), kDV = D / kSlices),
//     on 32-key tiles like the other D > 128. static_asserts refuse a D the
//     tiling cannot cover.
//
// f32 route (explicitly for float32 inputs; the f32 checks take it, the bf16
// model never does): scalar FMA loops from f32 shared memory. TF32 tensor
// cores would not hold the 1e-3 agreement of the f32 network with the CPU.
// One block per (batch * head, 32-row query tile, output slice), each warp
// keeps a running (max, sum, acc) for 8 query rows; wide heads take the same
// output slices (at most 128 columns) and 32-key tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

struct Strides {
  long long b, h, n;  // element strides; the head dim has stride 1
};

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// bf16 route: tensor cores.

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 128;    // 4 warps x 16 query rows
constexpr int kBlockQ = 64;
constexpr int kMaxSlice = 128;   // output columns per block
constexpr float kLog2e = 1.4426950408889634f;

constexpr int round16(int x) { return (x + 15) / 16 * 16; }

// Tiles of head dim D. The output columns are cut into kSlices equal slices
// of kDV <= 128 columns (D = 160: two of 80; D = 256, 512: 128 each). Q K^T
// runs kKD / 16 k-steps over D rounded up to 16 (D = 40: 48), the columns
// D..kKD-1 of the Q and K tiles held at zero, so they add nothing to S. Q
// (64 x D) and K (kBlockK x D) rows have a stride of kKD + 8 elements, V
// slices (kBlockK x kDV) of round16(kDV) + 8: 16 B of padding past a
// multiple of 32 B, so the 8 rows one ldmatrix reads fall in distinct banks.
template <int D>
struct Geo {
  static constexpr int kSlices = (D + kMaxSlice - 1) / kMaxSlice;
  static constexpr int kDV = D / kSlices;
  static constexpr int kKD = round16(D);
  static constexpr int kBlockK = D > kMaxSlice ? 32 : 64;
  static constexpr bool kQInRegs = D <= kMaxSlice;
  static constexpr int kQStride = kKD + 8;
  static constexpr int kVStride = round16(kDV) + 8;
  static constexpr int kQElems = kBlockQ * kQStride;
  static constexpr int kKElems = kBlockK * kQStride;
  static constexpr int kVElems = kBlockK * kVStride;
  static constexpr int kSmemBytes = (kQElems + 2 * kKElems + 2 * kVElems) * 2;
  static_assert(kSlices * kDV == D, "output slices must cover D exactly");
  static_assert(kDV % 8 == 0 && kDV <= kMaxSlice, "slice not whole n-tiles");
  static_assert(kKD >= D && kKD - D < 16 && (kKD - D) % 8 == 0,
                "k-steps must cover D, the padding one 16-byte chunk at most");
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes = 0 zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// Two transposed 8x8 matrices (lanes 0-15 give the row addresses).
__device__ __forceinline__ void ldsm_x2_trans(unsigned (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&h);
}

// Start the copies of up to ROWS rows of COLS values into a tile of row
// stride STRIDE; rows at or past `rows` are zero-filled. A tile of 16-byte
// chunks that is not a multiple of the block (D = 40, 80: 5 or 10 chunks a
// row) leaves the last pass partly idle.
template <int ROWS, int COLS, int STRIDE>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long row_stride, int rows,
                                          int tid) {
  constexpr int kChunks = COLS / 8;
  constexpr int kTotal = ROWS * kChunks;
  static_assert(COLS % 8 == 0, "rows must be whole 16-byte chunks");
#pragma unroll
  for (int it = 0; it < (kTotal + kThreads - 1) / kThreads; ++it) {
    const int i = tid + it * kThreads;
    if (kTotal % kThreads != 0 && i >= kTotal) break;
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = r < rows;
    cp_async16(dst + r * STRIDE + c * 8, ok ? src + r * row_stride + c * 8 : src,
               ok ? 16 : 0);
  }
}

// Round x * scale to bf16 in place, on the chunks this thread copied with
// load_tile<ROWS, COLS, STRIDE> (its own cp.async results are visible to it
// after the wait).
template <int ROWS, int COLS, int STRIDE>
__device__ __forceinline__ void scale_tile(bf16* t, float scale, int tid) {
  constexpr int kChunks = COLS / 8;
  constexpr int kTotal = ROWS * kChunks;
#pragma unroll
  for (int it = 0; it < (kTotal + kThreads - 1) / kThreads; ++it) {
    const int i = tid + it * kThreads;
    if (kTotal % kThreads != 0 && i >= kTotal) break;
    uint4* p = reinterpret_cast<uint4*>(t + (i / kChunks) * STRIDE +
                                        (i % kChunks) * 8);
    uint4 u = *p;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      h[j] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
    }
    *p = u;
  }
}

// grid (ceil(N / 64), B * H, kSlices), block 128.
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o,
                          int heads, int nq, int nkv, Strides sq, Strides sk,
                          Strides sv, Strides so, float scale) {
  using G = Geo<D>;
  constexpr int DV = G::kDV;
  constexpr int kBlockK = G::kBlockK;
  constexpr int QS = G::kQStride;
  constexpr int VS = G::kVStride;
  constexpr int kDTiles = DV / 8;    // 8-wide n-tiles of this block's O slice
  constexpr int kKSteps = G::kKD / 16;  // 16-deep k-steps of Q K^T
  constexpr int kKeyTiles = kBlockK / 8;
  static_assert(kKSteps * 16 >= D, "k-steps must cover D");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [64][QS]
  bf16* ks = qs + G::kQElems;                    // [2][kBlockK][QS]
  bf16* vs = ks + 2 * G::kKElems;                // [2][kBlockK][VS]

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int q0 = blockIdx.x * kBlockQ;
  const int c0 = blockIdx.z * DV;    // first output column of this block
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;            // fragment row within 8
  const int t4 = lane % 4;           // fragment column pair
  const int mat = lane / 8, r8 = lane % 8;  // ldmatrix: matrix, row address

  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h + c0;
  bf16* ob = o + b * so.b + h * so.h + c0;
  const int num_tiles = (nkv + kBlockK - 1) / kBlockK;

  if constexpr (G::kKD != D) {
    // columns D..kKD-1 of Q and of both K buffers (one 16-byte chunk a
    // row): zero, never written by a copy; the first __syncthreads in the
    // key loop orders these stores before any ldmatrix
    for (int r = tid; r < kBlockQ + 2 * kBlockK; r += kThreads)
      *reinterpret_cast<uint4*>(qs + r * QS + D) = make_uint4(0u, 0u, 0u, 0u);
  }
  load_tile<kBlockQ, D, QS>(qs, qb + q0 * sq.n, sq.n, nq - q0, tid);
  load_tile<kBlockK, D, QS>(ks, kb, sk.n, nkv, tid);
  load_tile<kBlockK, DV, VS>(vs, vb, sv.n, nkv, tid);
  cp_async_commit();

  unsigned qf[G::kQInRegs ? kKSteps : 1][4];
  float acc[kDTiles][4];
  float m[2] = {-INFINITY, -INFINITY};   // rows g and g + 8
  float l[2] = {0.f, 0.f};               // this thread's share of the row sums
#pragma unroll
  for (int i = 0; i < kDTiles; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  const bf16* qrow = qs + (warp * 16 + lane % 16) * QS + (lane / 16) * 8;

  for (int t = 0; t < num_tiles; ++t) {
    const int cur = t & 1;
    const int j0 = t * kBlockK;
    if (t + 1 < num_tiles) {
      const int j1 = j0 + kBlockK;
      load_tile<kBlockK, D, QS>(ks + (cur ^ 1) * G::kKElems, kb + j1 * sk.n,
                                sk.n, nkv - j1, tid);
      load_tile<kBlockK, DV, VS>(vs + (cur ^ 1) * G::kVElems, vb + j1 * sv.n,
                                 sv.n, nkv - j1, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if (t == 0) scale_tile<kBlockQ, D, QS>(qs, scale, tid);
    scale_tile<kBlockK, D, QS>(ks + cur * G::kKElems, scale, tid);
    __syncthreads();

    if constexpr (G::kQInRegs) {
      if (t == 0) {
#pragma unroll
        for (int kk = 0; kk < kKSteps; ++kk) ldsm_x4(qf[kk], qrow + kk * 16);
      }
    }
    const bf16* kt = ks + cur * G::kKElems;
    const bf16* vt = vs + cur * G::kVElems;

    // S = Q K^T for this warp's 16 rows and the tile's keys, over all of D.
    float s[kKeyTiles][4];
#pragma unroll
    for (int i = 0; i < kKeyTiles; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      unsigned a[4];
      if constexpr (G::kQInRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
      } else {
        ldsm_x4(a, qrow + kk * 16);
      }
#pragma unroll
      for (int jj = 0; jj < kKeyTiles / 2; ++jj) {
        unsigned bfr[4];
        ldsm_x4(bfr, kt + (jj * 16 + (mat / 2) * 8 + r8) * QS + kk * 16 +
                         (mat % 2) * 8);
        mma_bf16(s[2 * jj], a, bfr[0], bfr[1]);
        mma_bf16(s[2 * jj + 1], a, bfr[2], bfr[3]);
      }
    }

    if (j0 + kBlockK > nkv) {        // ragged last key tile
#pragma unroll
      for (int i = 0; i < kKeyTiles; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j0 + i * 8 + 2 * t4 + (e & 1) >= nkv) s[i][e] = -INFINITY;
    }

    // Online softmax in f32 for rows g (e = 0, 1) and g + 8 (e = 2, 3).
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < kKeyTiles; ++i) {
      mx[0] = fmaxf(mx[0], fmaxf(s[i][0], s[i][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[i][2], s[i][3]));
    }
    float alpha[2], mscaled[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f((m[r] - mx[r]) * kLog2e);
      mscaled[r] = mx[r] * kLog2e;
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < kKeyTiles; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[i][e] = exp2f(fmaf(s[i][e], kLog2e, -mscaled[e / 2]));
        l[e / 2] += s[i][e];
      }
#pragma unroll
    for (int i = 0; i < kDTiles; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] *= alpha[e / 2];

    // O[:, slice] += P V[:, slice], P rounded to bf16 as the A operand.
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      const unsigned pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int d0 = 0; d0 + 16 <= DV; d0 += 16) {
        unsigned bfr[4];
        ldsm_x4_trans(bfr, vt + (kk * 16 + (mat % 2) * 8 + r8) * VS + d0 +
                               (mat / 2) * 8);
        mma_bf16(acc[d0 / 8], pa, bfr[0], bfr[1]);
        mma_bf16(acc[d0 / 8 + 1], pa, bfr[2], bfr[3]);
      }
      if constexpr (kDTiles % 2) {   // an odd last n-tile (D = 40: 5 tiles)
        unsigned bfr[2];
        ldsm_x2_trans(bfr, vt + (kk * 16 + (mat % 2) * 8 + r8) * VS + DV - 8);
        mma_bf16(acc[kDTiles - 1], pa, bfr[0], bfr[1]);
      }
    }
    __syncthreads();  // this tile's buffers are free for the next prefetch
  }

  // Row sums across the quad, divide in f32, stage the warp's 16 rows in its
  // own rows of the Q tile (no other warp reads them) and store them with
  // 16-byte writes.
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / l[r];
  }
  bf16* stage = qs + warp * 16 * QS;
#pragma unroll
  for (int i = 0; i < kDTiles; ++i) {
    *reinterpret_cast<__nv_bfloat162*>(stage + g * QS + i * 8 + 2 * t4) =
        __floats2bfloat162_rn(acc[i][0] * inv[0], acc[i][1] * inv[0]);
    *reinterpret_cast<__nv_bfloat162*>(stage + (g + 8) * QS + i * 8 + 2 * t4) =
        __floats2bfloat162_rn(acc[i][2] * inv[1], acc[i][3] * inv[1]);
  }
  __syncwarp();
  constexpr int kChunks = DV / 8;
#pragma unroll
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = i / kChunks, c = i % kChunks;
    const int row = q0 + warp * 16 + r;
    if (row < nq)
      *reinterpret_cast<uint4*>(ob + row * so.n + c * 8) =
          *reinterpret_cast<const uint4*>(stage + r * QS + c * 8);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int heads, int nq, int nkv, Strides sq, Strides sk, Strides sv,
           Strides so, float scale, cudaStream_t stream) {
  constexpr int smem = Geo<D>::kSmemBytes;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((nq + kBlockQ - 1) / kBlockQ, b * heads, Geo<D>::kSlices);
  flash_fwd_bf16_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), heads, nq, nkv, sq,
      sk, sv, so, scale);
  return (int)cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// f32 route: FMA loops on the SIMT cores.

namespace simt {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockQ = 32;                 // query rows per block
constexpr int kRowsPerWarp = kBlockQ / kWarps;
constexpr int kMaxSlice = 128;              // output columns per block

// Head dim D: kSlices equal output slices of kDV <= 128 columns (D = 160:
// two of 80), keys per shared-memory tile.
template <int D>
struct Geo {
  static constexpr int kSlices = (D + kMaxSlice - 1) / kMaxSlice;
  static constexpr int kDV = D / kSlices;
  static constexpr int kBlockK = D > kMaxSlice ? 32 : 64;
  static constexpr int kSmemFloats = kBlockQ * D + kBlockK * (D + 1) + kBlockK * kDV;
  static_assert(kSlices * kDV == D, "output slices must cover D exactly");
};

// grid (ceil(N / 32), B * H, kSlices), block 128.
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         int heads, int nq, int nkv, Strides sq, Strides sk,
                         Strides sv, Strides so, float scale) {
  using G = Geo<D>;
  constexpr int DV = G::kDV;
  constexpr int kBlockK = G::kBlockK;
  constexpr int kKeysPerLane = kBlockK / 32;
  constexpr int kDimsPerLane = (DV + 31) / 32;  // lanes past DV guarded below
  extern __shared__ float smem[];
  float* qs = smem;                        // [kBlockQ][D]
  float* ks = qs + kBlockQ * D;            // [kBlockK][D + 1]
  float* vs = ks + kBlockK * (D + 1);      // [kBlockK][DV]

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int q0 = blockIdx.x * kBlockQ;
  const int c0 = blockIdx.z * DV;          // first output column of this block
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h + c0;
  float* ob = o + b * so.b + h * so.h + c0;

  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    qs[i] = (q0 + r < nq) ? qb[(q0 + r) * sq.n + d] * scale : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDimsPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < kDimsPerLane; ++e) acc[r][e] = 0.f;
  }

  for (int j0 = 0; j0 < nkv; j0 += kBlockK) {
    __syncthreads();  // previous tile fully consumed (and q tile written)
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int j = i / D, d = i % D;
      ks[j * (D + 1) + d] = (j0 + j < nkv) ? kb[(j0 + j) * sk.n + d] * scale : 0.f;
    }
    for (int i = tid; i < kBlockK * DV; i += kThreads) {
      const int j = i / DV, d = i % DV;
      vs[i] = (j0 + j < nkv) ? vb[(j0 + j) * sv.n + d] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = warp * kRowsPerWarp + r;
      if (q0 + row >= nq) continue;  // warp-uniform
      const float* qrow = qs + row * D;
      float s[kKeysPerLane];
      float tile_max = -INFINITY;
#pragma unroll
      for (int i = 0; i < kKeysPerLane; ++i) {
        const int j = lane + 32 * i;
        const float* krow = ks + j * (D + 1);
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) dot += qrow[d] * krow[d];
        s[i] = (j0 + j < nkv) ? dot : -INFINITY;
        tile_max = fmaxf(tile_max, s[i]);
      }
      tile_max = warp_max(tile_max);
      const float m_new = fmaxf(m[r], tile_max);
      const float alpha = expf(m[r] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int i = 0; i < kKeysPerLane; ++i) {
        s[i] = expf(s[i] - m_new);
        psum += s[i];
      }
      l[r] = l[r] * alpha + warp_sum(psum);
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < kDimsPerLane; ++e) acc[r][e] *= alpha;
#pragma unroll
      for (int i = 0; i < kKeysPerLane; ++i) {
#pragma unroll 8
        for (int jj = 0; jj < 32; ++jj) {
          const float p = __shfl_sync(0xffffffffu, s[i], jj);
          const float* vrow = vs + (32 * i + jj) * DV;
#pragma unroll
          for (int e = 0; e < kDimsPerLane; ++e) {
            const int d = lane + 32 * e;
            if (d < DV) acc[r][e] += p * vrow[d];
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = warp * kRowsPerWarp + r;
    if (q0 + row >= nq) continue;
    const float inv_l = 1.f / l[r];
#pragma unroll
    for (int e = 0; e < kDimsPerLane; ++e) {
      const int d = lane + 32 * e;
      if (d < DV) ob[(q0 + row) * so.n + d] = acc[r][e] * inv_l;
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int heads, int nq, int nkv, Strides sq, Strides sk, Strides sv,
           Strides so, float scale, cudaStream_t stream) {
  const size_t smem = Geo<D>::kSmemFloats * sizeof(float);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((nq + kBlockQ - 1) / kBlockQ, b * heads, Geo<D>::kSlices);
  flash_fwd_f32_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), heads, nq, nkv, sq,
      sk, sv, so, scale);
  return (int)cudaGetLastError();
}

}  // namespace simt

template <bool kBf16>
int dispatch(int d, const void* q, const void* k, const void* v, void* o,
             int b, int heads, int nq, int nkv, Strides sq, Strides sk,
             Strides sv, Strides so, float scale, cudaStream_t stream) {
#define LOCO_ATTN_CASE(D)                                                     \
  case D:                                                                     \
    return kBf16 ? tc::launch<D>(q, k, v, o, b, heads, nq, nkv, sq, sk, sv,   \
                                 so, scale, stream)                           \
                 : simt::launch<D>(q, k, v, o, b, heads, nq, nkv, sq, sk, sv,  \
                                   so, scale, stream);
  switch (d) {
    LOCO_ATTN_CASE(16)
    LOCO_ATTN_CASE(32)
    LOCO_ATTN_CASE(40)
    LOCO_ATTN_CASE(64)
    LOCO_ATTN_CASE(80)
    LOCO_ATTN_CASE(128)
    LOCO_ATTN_CASE(160)
    LOCO_ATTN_CASE(256)
    LOCO_ATTN_CASE(512)
    default: return (int)cudaErrorInvalidValue;
  }
#undef LOCO_ATTN_CASE
}

}  // namespace

// q, o: (B, H, N_q, D); k, v: (B, H, N_kv, D); element strides (b, h, n)
// each and a head dim of stride 1; f32 (is_bf16 = 0, FMA route) or bf16
// (is_bf16 = 1, tensor-core route: pointers 16-byte aligned, strides
// multiples of 8). D in {16, 32, 40, 64, 80, 128, 160, 256, 512};
// N_q, N_kv >= 1.
// Returns cudaGetLastError().
extern "C" int loco_flash_attention(
    const void* q, const void* k, const void* v, void* o, int b, int heads,
    int n, int n_kv, int d, long long sqb, long long sqh, long long sqn, long long skb,
    long long skh, long long skn, long long svb, long long svh, long long svn,
    long long sob, long long soh, long long son, float scale, int is_bf16,
    void* stream) {
  const Strides sq{sqb, sqh, sqn}, sk{skb, skh, skn}, sv{svb, svh, svn},
      so{sob, soh, son};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<true>(d, q, k, v, o, b, heads, n, n_kv, sq, sk, sv, so,
                          scale, s);
  return dispatch<false>(d, q, k, v, o, b, heads, n, n_kv, sq, sk, sv, so,
                         scale, s);
}
