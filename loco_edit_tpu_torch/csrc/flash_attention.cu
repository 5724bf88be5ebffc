// Flash attention forward (online softmax) for sm_90a, two routes chosen by
// dtype, both on the tensor cores: bf16 products, and f32 products made
// exact to f32 accuracy by splitting each operand into two TF32 parts.
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
// f32 route (float32 inputs: the f32 networks and checks), 3xTF32: every
// product a * b runs as a_hi b_hi + a_hi b_lo + a_lo b_hi on TF32
// mma.sync.m16n8k8 with f32 accumulators, where a_hi = cvt.rna.tf32(a) and
// a_lo = cvt.rna.tf32(a - a_hi). One TF32 operand keeps 11 significant bits
// (a relative error of 2^-11 per product: the f32 checks see 4e-4 of the
// largest output); hi + lo keep 22 and the dropped lo * lo term is below
// 2^-22, so the logits and P V stay within a few f32 ulps of an f32 FMA sum
// while running at a third of the TF32 rate (495 / 3 = 165 TFLOP/s on the
// H100 against 67 for FMA). The hi parts are rounded with cvt.rna: leaving
// them to the MMA's truncation of the low 13 bits, with lo taken from the
// unrounded register, is 1xTF32 by truncation. Numerics otherwise as the
// Pallas kernel: q and k scaled by d^-1/4 in f32, f32 online softmax (max,
// rescale, exp2), one f32 division by the row sum, f32 output.
// What bounds it: operations from N = 256 up. 4 N^2 D flops over 16 N D
// bytes is N / 4 flops per byte, above the 165e12 / 3.35e12 = 49 of the
// split product's ridge (the bf16 route's arithmetic is 3x cheaper and its
// bytes 2x fewer: bytes bound at the P2 shapes).
//   - The tensor cores truncate their f32 sums (toward zero, each addend
//     aligned to the largest), so an O accumulator chained through every
//     key tile drifts (~1e-4 of the output at 4096 keys, 128 tiles x 12
//     MMAs): each tile's P V goes into fresh accumulators and is added to
//     O with fmaf (O = alpha O + P V), rounded to nearest. What remains is
//     within a few times an f32 FMA loop's rounding against float64
//     (chip_smoke.py prints both per call), far inside the 5e-5 checks.
//   - k = 8 divides every D, so no columns are padded. The k index of each
//     8-deep step is permuted (t <-> 2t, t + 4 <-> 2t + 1, on both operands):
//     fragments load as 16-byte {hi, hi, lo, lo} groups, and the C
//     fragment of S is the A fragment of P V without a shuffle.
//   - Copies are cp.async, 16 bytes where the view allows (else 4 bytes:
//     any view with a head dim of stride 1 is taken without a copy), the
//     ragged last key tile zero-filled (source size 0) and its logits past
//     N_kv set to -inf; query rows >= N_q are not stored.
//   - "rows" (D <= 80): a block of 4 warps per (batch * head, 64-row query
//     tile), each warp 16 rows and all D output columns; Q is split once
//     into registers; 32-key K and V tiles land f32 in raw tiles and
//     are split once per tile into hi/lo tiles (K scaled; V transposed,
//     its columns XOR-swizzled, K's rows padded, so fragment loads have no
//     bank conflicts). Both are double-buffered: tile t + 1 is split while
//     tile t is computed and tile t + 2 copied, one barrier a tile. 102 KB
//     of shared memory at D = 64; at D = 80 16-key tiles, and Q's split
//     fragments in shared memory (107 KB), leaving the registers to the
//     accumulators.
//   - "cols" (D >= 128; the DDPM U-Net and the VAE at D = 512): S is formed
//     once per (32-row query tile, 16-key tile) for all output columns.
//     Warp w (of 8; D / 32 below 256) forms the partial logits over its
//     D / warps dims and owns the same output columns of O; two softmax
//     warps sum the partials, run the online softmax and stage split P and
//     the rescale factors in shared memory. A split 32-row Q tile at D = 512
//     would be 132 KB, so Q stays f32 in shared memory (scaled once) and is
//     split per k-step; K and V tiles are double-buffered f32 (215 KB in
//     all at D = 512) and each value is split once, by the one warp that
//     reads it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

struct Strides {
  long long b, h, n;  // element strides; the head dim has stride 1
};

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
// f32 route: 3xTF32 on the tensor cores.

namespace tf32x3 {

constexpr float kLog2e = 1.4426950408889634f;

// float4 units per row of a split K tile: at least `pairs`, = 4 mod 8, so
// the two rows a quarter-warp reads with one 16-byte load fall in distinct
// banks
constexpr int pad_pairs(int pairs) { return pairs + (12 - pairs % 8) % 8; }

__device__ __forceinline__ unsigned tf32_rna(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo + r, |r| <= 2^-22 |x|: hi is x rounded to TF32 (10 mantissa
// bits, to nearest), lo the remainder x - hi (exact in f32) rounded too
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// {hi(x0), hi(x1), lo(x0), lo(x1)}: the B fragment of one 8-deep k-step
__device__ __forceinline__ float4 split2(float x0, float x1) {
  unsigned h0, l0, h1, l1;
  split(x0, h0, l0);
  split(x1, h1, l1);
  return make_float4(__uint_as_float(h0), __uint_as_float(h1), __uint_as_float(l0),
                     __uint_as_float(l1));
}

// c (16x8 f32) += a (16x8 tf32, row) * b (8x8 tf32, col)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b (one 8-deep k-step) to f32 accuracy: the two small cross terms
// first, then hi * hi. The dropped lo * lo term and the rounding of lo stay
// below 2^-22 of |a||b|. b = split2(...) of the two B values.
__device__ __forceinline__ void mma3(float (&c)[4], const unsigned (&ah)[4],
                                     const unsigned (&al)[4], const float4& b) {
  mma_tf32(c, al, __float_as_uint(b.x), __float_as_uint(b.y));
  mma_tf32(c, ah, __float_as_uint(b.z), __float_as_uint(b.w));
  mma_tf32(c, ah, __float_as_uint(b.x), __float_as_uint(b.y));
}

// Split the four C values of one 16x8 P tile into the A fragments of one
// 8-key k-step. The k index is permuted, t <-> key 2t and t + 4 <-> key
// 2t + 1 (the same permutation on V's rows), so a thread's own C values are
// its A values and no shuffle is needed.
__device__ __forceinline__ void split_p(const float (&s)[4], unsigned (&ph)[4],
                                        unsigned (&pl)[4]) {
  split(s[0], ph[0], pl[0]);
  split(s[2], ph[1], pl[1]);
  split(s[1], ph[2], pl[2]);
  split(s[3], ph[3], pl[3]);
}

// 4-byte async copy (for views that are not 16-byte aligned); src_bytes = 0
// zero-fills the destination.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   tc::smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

// Start the copies of ROWS rows of D values into a tile of row stride
// STRIDE, rows at or past `rows` zero-filled: 16-byte copies where every
// pointer and stride is 16-byte aligned (vec16), else 4-byte ones.
template <int ROWS, int D, int STRIDE, int THREADS>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long row_stride, int rows, int tid,
                                          bool vec16) {
  if (vec16) {
    constexpr int kChunks = D / 4;
#pragma unroll 4
    for (int i = tid; i < ROWS * kChunks; i += THREADS) {
      const int r = i / kChunks, c = i % kChunks;
      const bool ok = r < rows;
      tc::cp_async16(dst + r * STRIDE + c * 4, ok ? src + r * row_stride + c * 4 : src,
                     ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < ROWS * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const bool ok = r < rows;
      cp_async4(dst + r * STRIDE + c, ok ? src + r * row_stride + c : src, ok ? 4 : 0);
    }
  }
}

// Online softmax over one key tile for a warp's 16 rows: s holds the C
// fragments of N 8-key n-tiles (rows g: e = 0, 1; g + 8: e = 2, 3), keys
// past N_kv already -inf. Updates the running max m and this thread's
// share of the row sums l, returns the rescale factor of the old rows in
// alpha and leaves the unnormalized exponentials in s.
template <int N>
__device__ __forceinline__ void online_softmax(float (&s)[N][4], float (&m)[2],
                                               float (&l)[2], float (&alpha)[2]) {
  float mx[2] = {m[0], m[1]}, ms[2];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    mx[0] = fmaxf(mx[0], fmaxf(s[i][0], s[i][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[i][2], s[i][3]));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = exp2f((m[r] - mx[r]) * kLog2e);
    ms[r] = mx[r] * kLog2e;
    m[r] = mx[r];
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[i][e] = exp2f(fmaf(s[i][e], kLog2e, -ms[e / 2]));
      l[e / 2] += s[i][e];
    }
}

template <int N>
__device__ __forceinline__ void mask_keys(float (&s)[N][4], int j0, int nkv, int t4) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (j0 + i * 8 + 2 * t4 + (e & 1) >= nkv) s[i][e] = -INFINITY;
}

// The row sums across the quad, for the final division.
__device__ __forceinline__ void quad_sum(float (&l)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
}

// -- "rows": D <= 80. Each warp owns 16 query rows and all D output columns.
//
// Q is split once, when its tile lands: into registers (D / 8 k-steps of 8
// registers) up to D = 64, into shared memory at D = 80, where registers go
// to the accumulators. K and V tiles land f32 by cp.async in double-buffered
// raw tiles and are split once per tile into double-buffered hi/lo tiles (K
// scaled, V transposed). Tile t + 1 is split while tile t is computed, in
// the same instruction stream, so the split's ALU work fills the MMAs'
// latency (it cost a third of the time as a phase of its own at D = 64),
// and tile t + 2's copies are in flight: one barrier a tile.
template <int D>
struct Rows {
  static constexpr int kThreads = 128;
  static constexpr int kBlockQ = 64;
  static constexpr int kBlockK = D <= 64 ? 32 : 16;  // D = 80: two blocks an SM
  static constexpr int kNT = kBlockK / 8;      // n-tiles of S, k-steps of P V
  static constexpr int kSteps = D / 8;         // k-steps of Q K^T, n-tiles of O
  static constexpr int kRaw = D + 4;           // raw f32 row stride (16-byte rows)
  static constexpr int kKS = pad_pairs(D / 2); // K tile: [key][dim pair] float4
  static constexpr int kVS = kBlockK / 2;      // V^T tile: [dim][key pair] float4, swizzled
  static constexpr int kRawFloats = kBlockK * kRaw;         // one raw K or V tile
  static constexpr int kSplit = kBlockK * kKS + D * kVS;    // float4: one split K + V^T
  static constexpr int kSplitSteps = kBlockK * D / 2 / kThreads;  // float4 a thread
  // Q's A fragments: in registers up to D = 64 (D registers), split in
  // shared memory as [row][dim pair] float4 at D = 80
  static constexpr bool kQInRegs = D <= 64;
  static constexpr int kQSplitBytes = kQInRegs ? 0 : kBlockQ * kKS * 16;
  static constexpr int kSmemBytes = 4 * kRawFloats * 4 + 2 * kSplit * 16 + kQSplitBytes;
  static_assert(D % 8 == 0 && D <= 80, "rows split: D a multiple of 8, at most 80");
  static_assert(kBlockK * D / 2 % kThreads == 0, "the split covers a tile in whole steps");
  static_assert(kBlockQ * kRaw * 4 <= 2 * kSplit * 16, "the Q tile is staged in the split tiles");
};

// Column swizzle of the V^T tile, by dim: the 8 dims one quarter-warp
// writes (one key pair each) and the 2 x 4 float4 one quarter-warp reads
// (dims g, g + 1 of a k-step) each land in 8 distinct 16-byte bank groups.
__device__ __forceinline__ int v_swizzle(int d) { return ((d & 1) << 2) | ((d >> 1) & 3); }

// grid (ceil(N_q / 64), B * H), block 128.
template <int D>
__global__ void __launch_bounds__(128)
    flash_fwd_f32_rows(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o, int heads,
                       int nq, int nkv, Strides sq, Strides sk, Strides sv, Strides so,
                       float scale, int vec16) {
  using G = Rows<D>;
  constexpr int kSteps = G::kSteps, kRaw = G::kRaw, kKS = G::kKS, kVS = G::kVS;
  constexpr int kBlockK = G::kBlockK, kNT = G::kNT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* raw = reinterpret_cast<float*>(smem_raw);     // [2][K, V][kBlockK][kRaw]
  float4* halves = reinterpret_cast<float4*>(raw + 4 * G::kRawFloats);
  // halves[buf]: split K [kBlockK][kKS], then split V^T [D][kVS]
  float4* qs = halves + 2 * G::kSplit;                 // [64][kKS] (D = 80 only)
  float* qraw = reinterpret_cast<float*>(halves);      // [64][kRaw] until split

  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int q0 = blockIdx.x * G::kBlockQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  float* ob = o + b * so.b + h * so.h;
  const int num_tiles = (nkv + kBlockK - 1) / kBlockK;

  // start the copies of key tile `tile` into raw buffer `buf`
  auto load_tile = [&](int tile, int buf) {
    const int j = tile * kBlockK;
    float* kr = raw + buf * 2 * G::kRawFloats;
    load_rows<kBlockK, D, kRaw, 128>(kr, kb + j * sk.n, sk.n, nkv - j, tid, vec16);
    load_rows<kBlockK, D, kRaw, 128>(kr + G::kRawFloats, vb + j * sv.n, sv.n, nkv - j,
                                     tid, vec16);
    tc::cp_async_commit();
  };
  // raw buffer `buf` -> split buffer `buf`: K scaled and split, V transposed
  // and split
  auto split_tile = [&](int buf) {
    const float* kr = raw + buf * 2 * G::kRawFloats;
    const float* vr = kr + G::kRawFloats;
    float4* kt = halves + buf * G::kSplit;
    float4* vt = kt + kBlockK * kKS;
#pragma unroll
    for (int it = 0; it < G::kSplitSteps; ++it) {
      const int i = tid + it * 128, r = i / (D / 2), p = i % (D / 2);
      const float2 x = *reinterpret_cast<const float2*>(kr + r * kRaw + 2 * p);
      kt[r * kKS + p] = split2(x.x * scale, x.y * scale);
    }
#pragma unroll
    for (int it = 0; it < G::kSplitSteps; ++it) {
      const int i = tid + it * 128, d = i % D, p = i / D;
      vt[d * kVS + (p ^ v_swizzle(d))] = split2(vr[2 * p * kRaw + d], vr[(2 * p + 1) * kRaw + d]);
    }
  };

  load_rows<G::kBlockQ, D, kRaw, 128>(qraw, q + b * sq.b + h * sq.h + q0 * sq.n, sq.n,
                                      nq - q0, tid, vec16);
  load_tile(0, 0);   // one group with Q
  if (num_tiles > 1) {
    load_tile(1, 1);
    tc::cp_async_wait<1>();
  } else {
    tc::cp_async_wait<0>();
  }
  __syncthreads();

  unsigned qh[G::kQInRegs ? kSteps : 1][4], ql[G::kQInRegs ? kSteps : 1][4];
  if constexpr (G::kQInRegs) {
    // q * d^-1/4 split into A fragments: rows g, g + 8 of the warp; dims
    // 2 t4, 2 t4 + 1 of each k-step (the permuted k index)
    const float* r0 = qraw + (warp * 16 + g) * kRaw + 2 * t4;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      const float2 x0 = *reinterpret_cast<const float2*>(r0 + kk * 8);
      const float2 x1 = *reinterpret_cast<const float2*>(r0 + 8 * kRaw + kk * 8);
      split(x0.x * scale, qh[kk][0], ql[kk][0]);
      split(x1.x * scale, qh[kk][1], ql[kk][1]);
      split(x0.y * scale, qh[kk][2], ql[kk][2]);
      split(x1.y * scale, qh[kk][3], ql[kk][3]);
    }
  } else {
    for (int i = tid; i < G::kBlockQ * D / 2; i += 128) {
      const int r = i / (D / 2), p = i % (D / 2);
      const float2 x = *reinterpret_cast<const float2*>(qraw + r * kRaw + 2 * p);
      qs[r * kKS + p] = split2(x.x * scale, x.y * scale);
    }
  }
  __syncthreads();   // Q is read before the split tiles overwrite it
  split_tile(0);

  float acc[kSteps][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < kSteps; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  const int vsw = v_swizzle(g);   // = v_swizzle(n * 8 + g) for every n-tile
  const float4* qrow = qs + (warp * 16 + g) * kKS + t4;

  for (int t = 0; t < num_tiles; ++t) {
    tc::cp_async_wait<0>();
    // split tile t visible and tile t + 1's copies in; every warp is done
    // with tile t - 1, so its split buffer and tile t's raw buffer are free
    __syncthreads();
    if (t + 2 < num_tiles) load_tile(t + 2, t & 1);
    const float4* kt = halves + (t & 1) * G::kSplit;
    const float4* vt = kt + kBlockK * kKS;

    // S = Q K^T for the warp's 16 rows and the tile's keys
    float s[kNT][4];
#pragma unroll
    for (int i = 0; i < kNT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      if constexpr (G::kQInRegs) {
#pragma unroll
        for (int n = 0; n < kNT; ++n)
          mma3(s[n], qh[kk], ql[kk], kt[(n * 8 + g) * kKS + kk * 4 + t4]);
      } else {
        const float4 x0 = qrow[kk * 4], x1 = qrow[8 * kKS + kk * 4];
        const unsigned ah[4] = {__float_as_uint(x0.x), __float_as_uint(x1.x),
                                __float_as_uint(x0.y), __float_as_uint(x1.y)};
        const unsigned al[4] = {__float_as_uint(x0.z), __float_as_uint(x1.z),
                                __float_as_uint(x0.w), __float_as_uint(x1.w)};
#pragma unroll
        for (int n = 0; n < kNT; ++n) mma3(s[n], ah, al, kt[(n * 8 + g) * kKS + kk * 4 + t4]);
      }
    }
    // tile t + 1 (past the last tile: stale data that no one reads)
    split_tile((t + 1) & 1);

    mask_keys(s, t * kBlockK, nkv, t4);
    float alpha[2];
    online_softmax(s, m, l, alpha);

    // P V of this tile: k-step kk is the tile's keys 8 kk .. 8 kk + 7 (S
    // n-tile kk), into fresh accumulators
    float pv[kSteps][4];
#pragma unroll
    for (int n = 0; n < kSteps; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kNT; ++kk) {
      unsigned ph[4], pl[4];
      split_p(s[kk], ph, pl);
#pragma unroll
      for (int n = 0; n < kSteps; ++n)
        mma3(pv[n], ph, pl, vt[(n * 8 + g) * kVS + ((kk * 4 + t4) ^ vsw)]);
    }
    // O = alpha O + P V on the FMA units (round to nearest)
#pragma unroll
    for (int n = 0; n < kSteps; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = fmaf(acc[n][e], alpha[e / 2], pv[n][e]);
  }

  quad_sum(l);
  const float inv[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= nq) continue;
#pragma unroll
    for (int n = 0; n < kSteps; ++n)
      *reinterpret_cast<float2*>(ob + row * so.n + n * 8 + 2 * t4) =
          make_float2(acc[n][2 * r] * inv[r], acc[n][2 * r + 1] * inv[r]);
  }
}

// -- "cols": D >= 128. S is formed once per (query tile, key tile) for all
// output columns: warp w forms the partial logits over dims
// [w kCols, (w + 1) kCols) and owns the same output columns. The partials
// are summed (in warp order) by the softmax warps, one per 16-row m-tile,
// which stage P (split) and the row rescale factors in shared memory.
//
// Shared memory at D = 512: a 32-row f32 Q tile is 66 KB and a split one
// would be 132 KB, so Q stays f32 in shared memory (scaled once when it
// lands) and is split per k-step into registers; K and V tiles of 16 keys
// are double-buffered f32 (2 x 2 x 33 KB) and each value is split once, by
// the one warp whose dims or columns hold it, as it is loaded.
template <int D>
struct Cols {
  static constexpr int kWarps = D >= 256 ? 8 : D / 32;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kCols = D / kWarps;     // Q K^T depth and O columns of a warp
  static constexpr int kSteps = kCols / 8;
  static constexpr int kBlockQ = 32, kBlockK = 16;
  static constexpr int kMT = kBlockQ / 16;     // m-tiles (softmax warps)
  static constexpr int kNT = kBlockK / 8;      // 8-key n-tiles of S
  static constexpr int kQS = D + 8;            // = 8 mod 32: conflict-free 8-byte A loads
  static constexpr int kKS = D + 8;            // same for the B loads of K
  static constexpr int kVS = D + 4;            // = 4 mod 16: conflict-free B loads of V
  static constexpr int kQFloats = kBlockQ * kQS;
  static constexpr int kKFloats = kBlockK * kKS;
  static constexpr int kVFloats = kBlockK * kVS;
  static constexpr int kSp = kWarps * kMT * kNT * 32;  // float4: S partials
  static constexpr int kPf = kMT * kNT * 2 * 32;       // uint4: P A fragments
  static constexpr int kSmemBytes =
      (kQFloats + 2 * kKFloats + 2 * kVFloats) * 4 + (kSp + kPf) * 16 + 2 * kBlockQ * 4;
  static_assert(kWarps * kCols == D && kCols % 8 == 0, "warps must cover D in k-steps");
  static_assert(kWarps >= kMT, "one softmax warp per m-tile");
  static_assert(kSmemBytes <= 232448, "over the opt-in shared memory");
};

// grid (ceil(N_q / 32), B * H), block 32 * kWarps.
template <int D>
__global__ void __launch_bounds__(Cols<D>::kThreads)
    flash_fwd_f32_cols(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o, int heads,
                       int nq, int nkv, Strides sq, Strides sk, Strides sv, Strides so,
                       float scale, int vec16) {
  using G = Cols<D>;
  constexpr int kSteps = G::kSteps, kMT = G::kMT, kNT = G::kNT, kT = G::kThreads;
  constexpr int kQS = G::kQS, kKS = G::kKS, kVS = G::kVS, kBlockK = G::kBlockK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qraw = reinterpret_cast<float*>(smem_raw);     // [32][kQS]
  float* kraw = qraw + G::kQFloats;                     // [2][kBlockK][kKS]
  float* vraw = kraw + 2 * G::kKFloats;                 // [2][kBlockK][kVS]
  float4* sp = reinterpret_cast<float4*>(vraw + 2 * G::kVFloats);  // [w][mt][n][lane]
  uint4* pf = reinterpret_cast<uint4*>(sp + G::kSp);    // [mt][kk][hi, lo][lane]
  float* alpha_s = reinterpret_cast<float*>(pf + G::kPf);  // [32]
  float* inv_s = alpha_s + G::kBlockQ;                  // [32]

  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int q0 = blockIdx.x * G::kBlockQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int c0 = warp * G::kCols;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  float* ob = o + b * so.b + h * so.h;
  const int num_tiles = (nkv + kBlockK - 1) / kBlockK;

  load_rows<G::kBlockQ, D, kQS, kT>(qraw, q + b * sq.b + h * sq.h + q0 * sq.n, sq.n,
                                    nq - q0, tid, vec16);
  load_rows<kBlockK, D, kKS, kT>(kraw, kb, sk.n, nkv, tid, vec16);
  load_rows<kBlockK, D, kVS, kT>(vraw, vb, sv.n, nkv, tid, vec16);
  tc::cp_async_commit();

  float acc[kMT][kSteps][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int i = 0; i < kSteps; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][i][e] = 0.f;
  // the running max and row-sum share of m-tile `warp` (softmax warps only)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int t = 0; t < num_tiles; ++t) {
    const int j0 = t * kBlockK;
    tc::cp_async_wait<0>();
    __syncthreads();   // tile t is in; every warp is done with tile t - 1
    if (t == 0) {
      for (int i = tid; i < G::kBlockQ * D; i += kT) qraw[(i / D) * kQS + i % D] *= scale;
      __syncthreads();
    }
    if (t + 1 < num_tiles) {
      const int j1 = j0 + kBlockK, nb = (t + 1) & 1;
      load_rows<kBlockK, D, kKS, kT>(kraw + nb * G::kKFloats, kb + j1 * sk.n, sk.n,
                                     nkv - j1, tid, vec16);
      load_rows<kBlockK, D, kVS, kT>(vraw + nb * G::kVFloats, vb + j1 * sv.n, sv.n,
                                     nkv - j1, tid, vec16);
      tc::cp_async_commit();
    }
    const float* kt = kraw + (t & 1) * G::kKFloats;
    const float* vt = vraw + (t & 1) * G::kVFloats;

    // this warp's partial S over its kCols dims, both m-tiles
    float s[kMT][kNT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      const int d = c0 + kk * 8 + 2 * t4;
      unsigned ah[kMT][4], al[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const float2 x0 = *reinterpret_cast<const float2*>(qraw + (mt * 16 + g) * kQS + d);
        const float2 x1 =
            *reinterpret_cast<const float2*>(qraw + (mt * 16 + g + 8) * kQS + d);
        split(x0.x, ah[mt][0], al[mt][0]);
        split(x1.x, ah[mt][1], al[mt][1]);
        split(x0.y, ah[mt][2], al[mt][2]);
        split(x1.y, ah[mt][3], al[mt][3]);
      }
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        const float2 y = *reinterpret_cast<const float2*>(kt + (n * 8 + g) * kKS + d);
        const float4 bk = split2(y.x * scale, y.y * scale);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) mma3(s[mt][n], ah[mt], al[mt], bk);
      }
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int n = 0; n < kNT; ++n)
        sp[((warp * kMT + mt) * kNT + n) * 32 + lane] =
            make_float4(s[mt][n][0], s[mt][n][1], s[mt][n][2], s[mt][n][3]);
    __syncthreads();   // partials visible

    if (warp < kMT) {  // the softmax of m-tile `warp`
      const int mt = warp;
      float st[kNT][4];
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        float4 a = sp[(mt * kNT + n) * 32 + lane];
#pragma unroll
        for (int w = 1; w < G::kWarps; ++w) {
          const float4 x = sp[((w * kMT + mt) * kNT + n) * 32 + lane];
          a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
        }
        st[n][0] = a.x; st[n][1] = a.y; st[n][2] = a.z; st[n][3] = a.w;
      }
      if (j0 + kBlockK > nkv) mask_keys(st, j0, nkv, t4);
      float alpha[2];
      online_softmax(st, m, l, alpha);
      if (t4 == 0) {
        alpha_s[mt * 16 + g] = alpha[0];
        alpha_s[mt * 16 + g + 8] = alpha[1];
      }
#pragma unroll
      for (int kk = 0; kk < kNT; ++kk) {
        unsigned ph[4], pl[4];
        split_p(st[kk], ph, pl);
        pf[((mt * kNT + kk) * 2) * 32 + lane] = make_uint4(ph[0], ph[1], ph[2], ph[3]);
        pf[((mt * kNT + kk) * 2 + 1) * 32 + lane] = make_uint4(pl[0], pl[1], pl[2], pl[3]);
      }
    }
    __syncthreads();   // P and the rescale factors visible

    // P V[:, c0 .. c0 + kCols) of this tile, into fresh accumulators
    float pv[kMT][kSteps][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int n = 0; n < kSteps; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) pv[mt][n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kNT; ++kk) {
      unsigned ph[kMT][4], pl[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const uint4 x = pf[((mt * kNT + kk) * 2) * 32 + lane];
        const uint4 y = pf[((mt * kNT + kk) * 2 + 1) * 32 + lane];
        ph[mt][0] = x.x; ph[mt][1] = x.y; ph[mt][2] = x.z; ph[mt][3] = x.w;
        pl[mt][0] = y.x; pl[mt][1] = y.y; pl[mt][2] = y.z; pl[mt][3] = y.w;
      }
      const float* v0 = vt + (kk * 8 + 2 * t4) * kVS + c0 + g;
#pragma unroll
      for (int n = 0; n < kSteps; ++n) {
        const float4 bv = split2(v0[n * 8], v0[kVS + n * 8]);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) mma3(pv[mt][n], ph[mt], pl[mt], bv);
      }
    }
    // O = alpha O + P V on the FMA units (round to nearest)
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const float a0 = alpha_s[mt * 16 + g], a1 = alpha_s[mt * 16 + g + 8];
#pragma unroll
      for (int n = 0; n < kSteps; ++n) {
        acc[mt][n][0] = fmaf(acc[mt][n][0], a0, pv[mt][n][0]);
        acc[mt][n][1] = fmaf(acc[mt][n][1], a0, pv[mt][n][1]);
        acc[mt][n][2] = fmaf(acc[mt][n][2], a1, pv[mt][n][2]);
        acc[mt][n][3] = fmaf(acc[mt][n][3], a1, pv[mt][n][3]);
      }
    }
  }

  if (warp < kMT) {
    quad_sum(l);
    if (t4 == 0) {
      inv_s[warp * 16 + g] = 1.f / l[0];
      inv_s[warp * 16 + g + 8] = 1.f / l[1];
    }
  }
  __syncthreads();
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + mt * 16 + g + 8 * r;
      if (row >= nq) continue;
      const float inv = inv_s[mt * 16 + g + 8 * r];
#pragma unroll
      for (int n = 0; n < kSteps; ++n)
        *reinterpret_cast<float2*>(ob + row * so.n + c0 + n * 8 + 2 * t4) =
            make_float2(acc[mt][n][2 * r] * inv, acc[mt][n][2 * r + 1] * inv);
    }
}

template <typename Kernel>
int configure(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int b, int heads,
           int nq, int nkv, Strides sq, Strides sk, Strides sv, Strides so, float scale,
           bool vec16, cudaStream_t stream) {
  static bool configured = false;
  if constexpr (D <= 80) {
    using G = Rows<D>;
    if (!configured) {
      const int err = configure(flash_fwd_f32_rows<D>, G::kSmemBytes);
      if (err) return err;
      configured = true;
    }
    const dim3 grid((nq + G::kBlockQ - 1) / G::kBlockQ, b * heads);
    flash_fwd_f32_rows<D><<<grid, G::kThreads, G::kSmemBytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), heads, nq, nkv, sq, sk, sv,
        so, scale, vec16);
  } else {
    using G = Cols<D>;
    if (!configured) {
      const int err = configure(flash_fwd_f32_cols<D>, G::kSmemBytes);
      if (err) return err;
      configured = true;
    }
    const dim3 grid((nq + G::kBlockQ - 1) / G::kBlockQ, b * heads);
    flash_fwd_f32_cols<D><<<grid, G::kThreads, G::kSmemBytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), heads, nq, nkv, sq, sk, sv,
        so, scale, vec16);
  }
  return (int)cudaGetLastError();
}

}  // namespace tf32x3

template <bool kBf16>
int dispatch(int d, const void* q, const void* k, const void* v, void* o,
             int b, int heads, int nq, int nkv, Strides sq, Strides sk,
             Strides sv, Strides so, float scale, bool vec16, cudaStream_t stream) {
#define LOCO_ATTN_CASE(D)                                                     \
  case D:                                                                     \
    return kBf16 ? tc::launch<D>(q, k, v, o, b, heads, nq, nkv, sq, sk, sv,   \
                                 so, scale, stream)                           \
                 : tf32x3::launch<D>(q, k, v, o, b, heads, nq, nkv, sq, sk,    \
                                     sv, so, scale, vec16, stream);
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

bool aligned16(const void* p, const Strides& s) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0 && s.b % 4 == 0 &&
         s.h % 4 == 0 && s.n % 4 == 0;
}

}  // namespace

// q, o: (B, H, N_q, D); k, v: (B, H, N_kv, D); element strides (b, h, n)
// each and a head dim of stride 1; f32 (is_bf16 = 0, 3xTF32 route: 16-byte
// copies where q, k, v and their strides are 16-byte aligned, 4-byte ones
// otherwise) or bf16 (is_bf16 = 1, pointers 16-byte aligned, strides
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
                          scale, true, s);
  const bool vec16 = aligned16(q, sq) && aligned16(k, sk) && aligned16(v, sv);
  return dispatch<false>(d, q, k, v, o, b, heads, n, n_kv, sq, sk, sv, so,
                         scale, vec16, s);
}
