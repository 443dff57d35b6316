// Helpers shared by the flash-attention kernels: K1 (flash_fwd.cu) and
// K2/K3 (flash_bwd.cu).
//
// Two routes share them. fp32 inputs take the CUDA-core kernels, which
// stage tiles as fp32 in shared memory (load8, load_tile) and run scalar
// FMAs. bf16 inputs take the tensor-core kernels, which copy bf16 tiles to
// shared memory with cp.async (cp_async16, load_tile_async), read MMA
// fragments with ldmatrix and multiply with mma.sync m16n8k16 (bf16 in,
// fp32 accumulators).
//
// Fragment layout of mma.sync.m16n8k16 for a lane l of the warp, with
// g = l / 4 and c = l % 4 (PTX ISA, "Matrix fragments for mma.m16n8k16"):
//   A (16x16, row-major): a0 = (g, 2c..2c+1), a1 = (g+8, 2c..),
//                         a2 = (g, 2c+8..),   a3 = (g+8, 2c+8..);
//   B (16x8, k x n):      b0 = (k 2c..2c+1, n g), b1 = (k 2c+8.., n g);
//   C (16x8, fp32):       c0, c1 = (g, 2c), (g, 2c+1);
//                         c2, c3 = (g+8, 2c), (g+8, 2c+1).
// Two 16-bit values share a register, the lower column in the low half.
// So the C fragments of two neighbouring 8-column blocks are, packed to
// bf16, the A fragment of one 16-deep block: the probabilities of a
// product feed the next product from registers.
//
// Tiles of bf16 rows live in shared memory with a row stride of D + 8
// elements (V and dO tiles: Dv + 8): each row starts 16 bytes later in the
// bank pattern than the one before, so the eight 16-byte rows that one
// ldmatrix phase reads hit eight different bank groups (no conflicts), for
// every width here (32, 48, 64, 80, 128, 192 and 256: (w + 8) / 8 is
// odd).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// The (D, Dv) pairs the kernels are built for: q and k rows of D, v rows
// (and O, dO, dv) of Dv. D = Dv for the MHA/GQA models (80: HuBERT's and
// Zamba2's heads); (192, 128) is DeepSeek-V3's MLA (nope 128 + rope 64 for
// q and k, 128 for v), whose V is not padded to D, and (48, 32) its smoke
// config's. Every dispatch keys on this table, and
// kernels/flash_attention.py's HEAD_DIM_PAIRS lists the same pairs.
#define FLASH_HEAD_DIM_PAIRS(X) \
  X(32, 32) X(64, 64) X(80, 80) X(128, 128) X(256, 256) X(192, 128) \
  X(48, 32)

namespace {

constexpr int BM = 64;    // query rows per tile
constexpr int BN = 64;    // keys per tile
constexpr float NEG_INF = -1073741824.0f;   // -2**30, the reference's mask
constexpr float LSE_BIG = 1073741824.0f;    // lse of a fully-masked row
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

typedef __nv_bfloat16 bf16;

// Rows of the streamed tile of the fp32 CUDA-core kernels (K1's and K2's
// key tiles, K3's query tiles): 64, and 32 at D 256, where 64-row fp32
// tiles of every operand would not fit the 227 KB a CTA may hold.
template <int D>
__host__ __device__ constexpr int f32_tile() { return D == 256 ? 32 : 64; }

// The fp32 routes spread a W-wide row's W / 4 float4 column groups over
// the 8 threads that share its rows: thread cg owns groups cg + 8 jj for
// jj < f4_groups<W>() where f4_owns<W>(cg, jj). Where 32 divides W every
// thread owns W / 32 and the test folds away; at W 80 (20 groups) threads
// 0-3 own three and threads 4-7 two, at W 48 (12) 0-3 two and 4-7 one.
template <int W>
__host__ __device__ constexpr int f4_groups() { return (W / 4 + 7) / 8; }

template <int W>
__device__ __forceinline__ bool f4_owns(int cg, int jj) {
  static_assert(W % 8 == 0, "rows move in 8-element chunks");
  return cg + 8 * jj < W / 4;
}

// ---- masks -------------------------------------------------------------

// Whether query qpos may attend to key kpos: inside S and T, causal
// (k <= q) and within the static window (q - k < window).
template <typename P>
__device__ __forceinline__ bool live(const P& p, int qpos, int kpos) {
  return qpos < p.s && kpos < p.t && (!p.causal || kpos <= qpos) &&
         (p.window <= 0 || qpos - kpos < p.window);
}

// Whether a (queries [q0, q0 + nq), keys [k0, k0 + nk)) tile holds a
// masked pair; a tile that holds none skips the mask, as the reference's
// _block_needs_mask lets its interior blocks do.
template <typename P>
__device__ __forceinline__ bool tile_needs_mask(const P& p, int q0, int nq,
                                                int k0, int nk) {
  return q0 + nq > p.s || k0 + nk > p.t ||
         (p.causal && k0 + nk - 1 > q0) ||
         (p.window > 0 && q0 + nq - 1 - k0 >= p.window);
}

// ---- the fp32 CUDA-core route ------------------------------------------

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 c = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = c.x; x[5] = c.y; x[6] = c.z; x[7] = c.w;
}

__device__ __forceinline__ void load8(const bf16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(bf16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float lane_of(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

__device__ __forceinline__ float row_max8(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}

__device__ __forceinline__ float row_sum8(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

// Stage a ROWS-row tile of width D as fp32 in shared memory (row stride
// ld_s), from global rows ld_g elements apart, with NT threads. Rows at
// `rows` and beyond are zero: a masked probability is exactly 0, and
// 0 * NaN from stale memory would poison the sums (the guard at
// flash_attention.py:262-263).
template <typename T, int D, int NT, int ROWS = BM>
__device__ __forceinline__ void load_tile(float* dst, int ld_s, const T* src,
                                          long long ld_g, int rows) {
  constexpr int CPR = D / 8;   // 8-element chunks per row
#pragma unroll 4
  for (int c = threadIdx.x; c < ROWS * CPR; c += NT) {
    const int r = c / CPR;
    const int col = (c % CPR) * 8;
    float x[8];
    if (r < rows) {
      load8(src + r * ld_g + col, x);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = 0.f;
    }
    float4* d4 = reinterpret_cast<float4*>(dst + r * ld_s + col);
    d4[0] = make_float4(x[0], x[1], x[2], x[3]);
    d4[1] = make_float4(x[4], x[5], x[6], x[7]);
  }
}

// ---- the bf16 tensor-core route ----------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; with `pred`
// false the 16 bytes are zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

// One fp32 (4 bytes) likewise.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 bf16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, and register i of lane l receives matrix i's (l/4, 2(l%4)..+1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// The same, each matrix transposed: lane l receives (2(l%4)..+1, l/4).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d += A B for one 16x8x16 block: bf16 A and B, fp32 d.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values as a bf16 pair, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A operand of a 16-row block from shared memory: rows r0.., columns
// k0..k0+15 of a tile with row stride ld (elements).
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int ld, int r0, int k0, int lane) {
  ldmatrix_x4(a, tile + (r0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
}

// B operands of two 8-column blocks n0.. and n0+8.. at depth k0..k0+15,
// from a tile stored n-major (row n holds B's column n, as K rows do for
// Q K^T): b[0], b[1] for block n0 and b[2], b[3] for block n0 + 8.
__device__ __forceinline__ void load_b_nmajor(uint32_t (&b)[4],
                                              const bf16* tile, int ld,
                                              int n0, int k0, int lane) {
  ldmatrix_x4(b, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 +
                     ((lane >> 3) & 1) * 8);
}

// The same from a tile stored k-major (row k holds B's row k, as V rows
// do for P V): ldmatrix's transpose gives each lane its (k pair, n).
__device__ __forceinline__ void load_b_kmajor(uint32_t (&b)[4],
                                              const bf16* tile, int ld,
                                              int n0, int k0, int lane) {
  ldmatrix_x4_trans(b, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                           n0 + (lane >> 4) * 8);
}

// Copy a ROWS x D bf16 tile to shared memory (row stride D + 8) with
// cp.async, NT threads, 16 bytes each; rows at `rows` and beyond are
// zero-filled, so stale memory never meets a product.
template <int D, int ROWS, int NT>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src,
                                                long long ld_g, int rows) {
  constexpr int CPR = D / 8;   // 16-byte chunks per row
#pragma unroll
  for (int c = threadIdx.x; c < ROWS * CPR; c += NT) {
    const int r = c / CPR;
    const int col = (c % CPR) * 8;
    const bool in = r < rows;
    cp_async16(dst + r * (D + 8) + col, src + (in ? r * ld_g + col : 0), in);
  }
}

}  // namespace
