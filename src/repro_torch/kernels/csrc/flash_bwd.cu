// K2 and K3: the flash-attention backward for Hopper (sm_90a), plain C
// interface.
//
// Replaces src/repro/kernels/flash_attention.py:_dq_kernel (K2, launched by
// _backward_dq) and :_dkv_kernel (K3, launched by _backward_dkv). For q
// (B,H,S,D), k/v (B,KH,T,D), the forward's output O and fp32 lse (B,H,S),
// and the output gradient dO, with GQA (kv_head = h / (H/KH)):
//   K2: Delta = rowsum(dO * O) (fp32, (B,H,S)), and per live key
//       P = exp(S*scale - lse), dS = P * (dO V^T - Delta) * scale,
//       dq = dS K in q's dtype;
//   K3: dv = P^T dO and dk = dS^T Q, summed over the GQA group's query
//       heads, in k's and v's dtypes.
// The causal mask, the static sliding window and the ragged edges of S and
// T follow K1 (flash_fwd.cu): masked P and dS are exactly 0, so a row with
// no live key (lse = 2**30) contributes nothing, as in the pruned Pallas
// grid.
//
// What bounds them on an H100 SXM: at the ViT-B/16 training micro-shape
// (B=64, H=12, S=T=197, D=64, bf16) K2 must read q, k, v, dO and O and
// write dq (6 x 19.4 MB) plus lse and Delta (2 x 0.6 MB): 117.4 MB, 35 us
// at 3.35 TB/s; its three products are 6*B*H*S*T*D = 11.4 GFLOP, 12 us at
// the 989 TFLOP/s bf16 tensor-core peak. K3 reads q, k, v and dO, writes dk
// and dv, and reads lse and Delta: the same 117.4 MB; its four products are
// 15.3 GFLOP, 15 us. Both are bound by bytes.
//
// What this design does about it: each CTA reads its resident tiles once
// (K2: q, dO, O; K3: k, v) and streams the other side's tiles from L2, keeps
// S, P, dP and dS in registers and shared memory only, and writes each
// gradient once, with no atomics: K2 owns a 64-row q tile, K3 a 64-key tile
// and loops over the whole GQA group inside the CTA (the loop replaces the
// TPU kernel's sequential `arbitrary` grid axis and its VMEM accumulators),
// so the result is the same from run to run. Like K1, this first version
// runs its products on the fp32 CUDA cores, not the tensor cores, so it is
// bound by fp32 FMA issue well above the memory bound; wgmma and TMA are
// later work.
//
// Layout, as in K1: 128 threads; thread t owns rows 4*(t/8) .. +3 of the
// CTA's resident tile; for a 64x64 score tile it owns columns (t%8) + 8j,
// and for a 64xD accumulator the float4 column groups (t%8) + 8jj. The 8
// threads that share rows are neighbouring lanes, so row sums reduce with
// three xor shuffles. Tiles are staged in shared memory as fp32, rows padded
// by 4 floats so that eight column groups read eight rows without bank
// conflicts. Element strides are passed in, so dO, dq, dk and dv may be
// (B,S,H,D) buffers seen as (B,H,S,D) views.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;    // query rows per tile
constexpr int BN = 64;    // keys per tile (the loader assumes BN == BM)
constexpr int NT = 128;   // threads per CTA: 16 row groups x 8 column groups
constexpr int LDP = BN + 4;   // padded row stride of a 64x64 P/dS tile

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;     // K2 only
  const void* d_o;
  const float* lse;
  float* delta;      // written by K2, read by K3
  void* dq;          // K2
  void* dk;          // K3
  void* dv;          // K3
  int b, h, kh, s, t;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  long long do_sb, do_sh, do_ss;
  long long dq_sb, dq_sh, dq_ss;
  long long dk_sb, dk_sh, dk_ss;
  long long dv_sb, dv_sh, dv_ss;
  int causal, window;
  float scale;
};

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 c = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = c.x; x[5] = c.y; x[6] = c.z; x[7] = c.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
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

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
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

__device__ __forceinline__ float row_sum8(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

__device__ __forceinline__ bool live(const Params& p, int qpos, int kpos) {
  return qpos < p.s && kpos < p.t && (!p.causal || kpos <= qpos) &&
         (p.window <= 0 || qpos - kpos < p.window);
}

// Stage a 64-row tile of width D as fp32 in shared memory (row stride
// D + 4), from global rows ld_g elements apart. Rows at `rows` and beyond
// are zero, so stale memory never meets a product (0 * NaN).
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long ld_g, int rows) {
  constexpr int CPR = D / 8;   // 8-element chunks per row
  constexpr int LD = D + 4;
#pragma unroll 4
  for (int c = threadIdx.x; c < BM * CPR; c += NT) {
    const int r = c / CPR;
    const int col = (c % CPR) * 8;
    float x[8];
    if (r < rows) {
      load8(src + r * ld_g + col, x);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = 0.f;
    }
    float4* d4 = reinterpret_cast<float4*>(dst + r * LD + col);
    d4[0] = make_float4(x[0], x[1], x[2], x[3]);
    d4[1] = make_float4(x[4], x[5], x[6], x[7]);
  }
}

// acc[i][j] = sum_d A[r0+i][d] * B[cg+8j][d]: rows of the resident tile A
// against rows of the streamed tile B, both staged with stride D + 4.
template <int D>
__device__ __forceinline__ void tile_dot(const float* A, const float* B,
                                         int r0, int cg, float (&acc)[4][8]) {
  constexpr int LD = D + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int kk = 0; kk < D; kk += 4) {
    float4 a[4], bb[8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (r0 + i) * LD + kk);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      bb[j] = *reinterpret_cast<const float4*>(B + (cg + 8 * j) * LD + kk);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[i][j] = fmaf(a[i].x, bb[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, bb[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, bb[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, bb[j].w, acc[i][j]);
      }
  }
}

// acc[i][c] += sum_n W[r0+i][n] * X[n][col c]: a 64x64 weight tile W
// (stride LDP) times a 64xD tile X (stride D + 4), for the thread's rows
// r0+i and float4 column groups cg + 8jj.
template <int D>
__device__ __forceinline__ void tile_matmul(const float* W, const float* X,
                                            int r0, int cg,
                                            float (&acc)[4][D / 8]) {
  constexpr int LD = D + 4;
  constexpr int DV = D / 32;
#pragma unroll 2
  for (int n = 0; n < BN; n += 4) {
    float4 w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = *reinterpret_cast<const float4*>(W + (r0 + i) * LDP + n);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float* xrow = X + (n + u) * LD;
#pragma unroll
      for (int jj = 0; jj < DV; ++jj) {
        const float4 xb =
            *reinterpret_cast<const float4*>(xrow + 4 * (cg + 8 * jj));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float wv = lane_of(w[i], u);
          acc[i][4 * jj + 0] = fmaf(wv, xb.x, acc[i][4 * jj + 0]);
          acc[i][4 * jj + 1] = fmaf(wv, xb.y, acc[i][4 * jj + 1]);
          acc[i][4 * jj + 2] = fmaf(wv, xb.z, acc[i][4 * jj + 2]);
          acc[i][4 * jj + 3] = fmaf(wv, xb.w, acc[i][4 * jj + 3]);
        }
      }
    }
  }
}

// Write the thread's rows r0+i < rows of a 64xD accumulator, in T.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* base, long long ld, int rows,
                                           int r0, int cg,
                                           const float (&acc)[4][D / 8]) {
  constexpr int DV = D / 32;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (r0 + i < rows) {
      T* row = base + (r0 + i) * ld;
#pragma unroll
      for (int jj = 0; jj < DV; ++jj)
        store4(row + 4 * (cg + 8 * jj),
               make_float4(acc[i][4 * jj + 0], acc[i][4 * jj + 1],
                           acc[i][4 * jj + 2], acc[i][4 * jj + 3]));
    }
  }
}

template <int D>
constexpr int dq_smem_bytes() {   // Q, dO, K (O before the loop), V; dS
  return (4 * BM * (D + 4) + BM * LDP) * static_cast<int>(sizeof(float));
}

template <int D>
constexpr int dkv_smem_bytes() {  // K, V, Q, dO; P, dS; lse, Delta
  return (4 * BM * (D + 4) + 2 * BN * LDP + 2 * BM) *
         static_cast<int>(sizeof(float));
}

// K2: one CTA per (64-row q tile, head, batch).
template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(const Params p) {
  constexpr int LD = D + 4;
  constexpr int DV = D / 32;
  extern __shared__ float4 smem_f4[];
  float* Qs = reinterpret_cast<float*>(smem_f4);
  float* dOs = Qs + BM * LD;
  float* Ks = dOs + BM * LD;
  float* Vs = Ks + BN * LD;
  float* dSs = Vs + BN * LD;

  const int q0 = blockIdx.x * BM;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int kvh = hh / (p.h / p.kh);
  const int rows = min(BM, p.s - q0);
  const T* kg = static_cast<const T*>(p.k) + bb * p.k_sb + kvh * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + bb * p.v_sb + kvh * p.v_sh;

  load_tile<T, D>(Qs, static_cast<const T*>(p.q) + bb * p.q_sb +
                          hh * p.q_sh + q0 * p.q_ss, p.q_ss, rows);
  load_tile<T, D>(dOs, static_cast<const T*>(p.d_o) + bb * p.do_sb +
                           hh * p.do_sh + q0 * p.do_ss, p.do_ss, rows);
  // O only feeds Delta, so it borrows K's buffer before the loop
  load_tile<T, D>(Ks, static_cast<const T*>(p.o) + bb * p.o_sb +
                          hh * p.o_sh + q0 * p.o_ss, p.o_ss, rows);
  __syncthreads();

  const int tid = threadIdx.x;
  const int r0 = (tid >> 3) * 4;
  const int cg = tid & 7;
  const long long row_base = (static_cast<long long>(bb) * p.h + hh) * p.s;

  // Delta = rowsum(dO * O) for the thread's rows, first (the Pallas
  // kernel's fused _init, flash_attention.py:409-418); zero-filled rows
  // past S give 0
  float lse[4], delta[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float part = 0.f;
#pragma unroll
    for (int jj = 0; jj < DV; ++jj) {
      const int col = 4 * (cg + 8 * jj);
      const float4 a =
          *reinterpret_cast<const float4*>(dOs + (r0 + i) * LD + col);
      const float4 c =
          *reinterpret_cast<const float4*>(Ks + (r0 + i) * LD + col);
      part += a.x * c.x + a.y * c.y + a.z * c.z + a.w * c.w;
    }
    delta[i] = row_sum8(part);
    const bool in = r0 + i < rows;
    lse[i] = in ? p.lse[row_base + q0 + r0 + i] : 0.f;
    if (in && cg == 0) p.delta[row_base + q0 + r0 + i] = delta[i];
  }

  float acc[4][D / 8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 8; ++c) acc[i][c] = 0.f;

  // the key tiles this q tile can see (K1's loop bounds)
  int k_lo = 0, k_hi = p.t;
  if (p.causal) k_hi = min(k_hi, q0 + BM);
  if (p.window > 0) k_lo = max(0, q0 - p.window + 1);
  k_lo -= k_lo % BN;

  for (int kt = k_lo; kt < k_hi; kt += BN) {
    __syncthreads();   // every thread is done with the previous K, V, dS
    const int kv_rows = min(BN, p.t - kt);
    load_tile<T, D>(Ks, kg + kt * p.k_ss, p.k_ss, kv_rows);
    load_tile<T, D>(Vs, vg + kt * p.v_ss, p.v_ss, kv_rows);
    __syncthreads();

    float pr[4][8], dp[4][8];
    tile_dot<D>(Qs, Ks, r0, cg, pr);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        pr[i][j] = live(p, q0 + r0 + i, kt + cg + 8 * j)
                       ? expf(pr[i][j] * p.scale - lse[i]) : 0.f;
    tile_dot<D>(dOs, Vs, r0, cg, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        dSs[(r0 + i) * LDP + cg + 8 * j] =
            live(p, q0 + r0 + i, kt + cg + 8 * j)
                ? pr[i][j] * (dp[i][j] - delta[i]) * p.scale : 0.f;
    __syncthreads();

    tile_matmul<D>(dSs, Ks, r0, cg, acc);   // dq += dS K
  }

  store_rows<T, D>(static_cast<T*>(p.dq) + bb * p.dq_sb + hh * p.dq_sh +
                       q0 * p.dq_ss, p.dq_ss, rows, r0, cg, acc);
}

// K3: one CTA per (64-key tile, kv head, batch); loops over the group's
// query heads and the live q tiles, and flushes dk and dv once.
template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(const Params p) {
  constexpr int LD = D + 4;
  extern __shared__ float4 smem_f4[];
  float* Ks = reinterpret_cast<float*>(smem_f4);
  float* Vs = Ks + BN * LD;
  float* Qs = Vs + BN * LD;
  float* dOs = Qs + BM * LD;
  float* Ps = dOs + BM * LD;
  float* dSs = Ps + BN * LDP;
  float* lse_s = dSs + BN * LDP;
  float* delta_s = lse_s + BM;

  const int k0 = blockIdx.x * BN;
  const int kvh = blockIdx.y;
  const int bb = blockIdx.z;
  const int g = p.h / p.kh;
  const int kv_rows = min(BN, p.t - k0);

  load_tile<T, D>(Ks, static_cast<const T*>(p.k) + bb * p.k_sb +
                          kvh * p.k_sh + k0 * p.k_ss, p.k_ss, kv_rows);
  load_tile<T, D>(Vs, static_cast<const T*>(p.v) + bb * p.v_sb +
                          kvh * p.v_sh + k0 * p.v_ss, p.v_ss, kv_rows);

  const int tid = threadIdx.x;
  const int r0 = (tid >> 3) * 4;
  const int cg = tid & 7;

  float dk[4][D / 8], dv[4][D / 8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 8; ++c) dk[i][c] = dv[i][c] = 0.f;

  // the q tiles that can see this key tile: q >= k for causal, and
  // q - k < window, with k in [k0, k0 + BN)
  int q_lo = p.causal ? k0 : 0, q_hi = p.s;
  if (p.window > 0) q_hi = min(q_hi, k0 + BN - 1 + p.window);
  q_lo -= q_lo % BM;

  for (int gi = 0; gi < g; ++gi) {
    const int hh = kvh * g + gi;
    const long long row_base = (static_cast<long long>(bb) * p.h + hh) * p.s;
    const T* qg = static_cast<const T*>(p.q) + bb * p.q_sb + hh * p.q_sh;
    const T* dog = static_cast<const T*>(p.d_o) + bb * p.do_sb + hh * p.do_sh;
    for (int qt = q_lo; qt < q_hi; qt += BM) {
      __syncthreads();   // every thread is done with the previous tiles
      const int q_rows = min(BM, p.s - qt);
      load_tile<T, D>(Qs, qg + qt * p.q_ss, p.q_ss, q_rows);
      load_tile<T, D>(dOs, dog + qt * p.do_ss, p.do_ss, q_rows);
      for (int r = tid; r < BM; r += NT) {
        lse_s[r] = r < q_rows ? p.lse[row_base + qt + r] : 0.f;
        delta_s[r] = r < q_rows ? p.delta[row_base + qt + r] : 0.f;
      }
      __syncthreads();

      // transposed tiles: rows are the CTA's keys r0+i, columns the
      // queries cg+8j
      float pr[4][8], dp[4][8];
      tile_dot<D>(Ks, Qs, r0, cg, pr);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int qj = cg + 8 * j;
          pr[i][j] = live(p, qt + qj, k0 + r0 + i)
                         ? expf(pr[i][j] * p.scale - lse_s[qj]) : 0.f;
          Ps[(r0 + i) * LDP + qj] = pr[i][j];
        }
      tile_dot<D>(Vs, dOs, r0, cg, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int qj = cg + 8 * j;
          dSs[(r0 + i) * LDP + qj] =
              live(p, qt + qj, k0 + r0 + i)
                  ? pr[i][j] * (dp[i][j] - delta_s[qj]) * p.scale : 0.f;
        }
      __syncthreads();

      tile_matmul<D>(Ps, dOs, r0, cg, dv);    // dv += P^T dO
      tile_matmul<D>(dSs, Qs, r0, cg, dk);    // dk += dS^T Q
    }
  }

  store_rows<T, D>(static_cast<T*>(p.dk) + bb * p.dk_sb + kvh * p.dk_sh +
                       k0 * p.dk_ss, p.dk_ss, kv_rows, r0, cg, dk);
  store_rows<T, D>(static_cast<T*>(p.dv) + bb * p.dv_sb + kvh * p.dv_sh +
                       k0 * p.dv_ss, p.dv_ss, kv_rows, r0, cg, dv);
}

template <typename T, int D>
cudaError_t launch_dq(const Params& p, cudaStream_t stream) {
  constexpr int smem = dq_smem_bytes<D>();   // above 48 KB for D >= 64
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.s + BM - 1) / BM, p.h, p.b);
  flash_bwd_dq_kernel<T, D><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Params& p, cudaStream_t stream) {
  constexpr int smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.t + BN - 1) / BN, p.kh, p.b);
  flash_bwd_dkv_kernel<T, D><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int which, int d, const Params& p, cudaStream_t st) {
  if (which == 0) {
    switch (d) {
      case 32: return launch_dq<T, 32>(p, st);
      case 64: return launch_dq<T, 64>(p, st);
      case 128: return launch_dq<T, 128>(p, st);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (d) {
    case 32: return launch_dkv<T, 32>(p, st);
    case 64: return launch_dkv<T, 64>(p, st);
    case 128: return launch_dkv<T, 128>(p, st);
    default: return cudaErrorInvalidValue;
  }
}

int run(int which, int dtype, int d, const Params& p, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(dispatch<float>(which, d, p, st));
  if (dtype == 1)
    return static_cast<int>(dispatch<__nv_bfloat16>(which, d, p, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

void set_common(Params& p, const void* q, const void* k, const void* v,
                const void* d_o, const void* lse, int b, int h, int kh,
                int s, int t, const long long* st, int causal, int window,
                float scale) {
  p.q = q; p.k = k; p.v = v; p.d_o = d_o;
  p.lse = static_cast<const float*>(lse);
  p.b = b; p.h = h; p.kh = kh; p.s = s; p.t = t;
  p.q_sb = st[0]; p.q_sh = st[1]; p.q_ss = st[2];
  p.k_sb = st[3]; p.k_sh = st[4]; p.k_ss = st[5];
  p.v_sb = st[6]; p.v_sh = st[7]; p.v_ss = st[8];
  p.do_sb = st[9]; p.do_sh = st[10]; p.do_ss = st[11];
  p.causal = causal; p.window = window; p.scale = scale;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. `strides` holds the (batch, head, row)
// element strides of q, k, v, dO and then the outputs (K2: o, dq; K3: dk,
// dv), 18 values; the last dimension of every tensor is contiguous. lse and
// delta are contiguous fp32 (B,H,S). Each returns a cudaError_t (0 = ok).
int repro_flash_bwd_dq(int dtype, int d, const void* q, const void* k,
                       const void* v, const void* o, const void* d_o,
                       const void* lse, void* dq, void* delta, int b, int h,
                       int kh, int s, int t, const long long* strides,
                       int causal, int window, float scale, void* stream) {
  Params p = {};
  set_common(p, q, k, v, d_o, lse, b, h, kh, s, t, strides, causal, window,
             scale);
  p.o = o; p.dq = dq; p.delta = static_cast<float*>(delta);
  p.o_sb = strides[12]; p.o_sh = strides[13]; p.o_ss = strides[14];
  p.dq_sb = strides[15]; p.dq_sh = strides[16]; p.dq_ss = strides[17];
  return run(0, dtype, d, p, stream);
}

int repro_flash_bwd_dkv(int dtype, int d, const void* q, const void* k,
                        const void* v, const void* d_o, const void* lse,
                        const void* delta, void* dk, void* dv, int b, int h,
                        int kh, int s, int t, const long long* strides,
                        int causal, int window, float scale, void* stream) {
  Params p = {};
  set_common(p, q, k, v, d_o, lse, b, h, kh, s, t, strides, causal, window,
             scale);
  p.delta = const_cast<float*>(static_cast<const float*>(delta));
  p.dk = dk; p.dv = dv;
  p.dk_sb = strides[12]; p.dk_sh = strides[13]; p.dk_ss = strides[14];
  p.dv_sb = strides[15]; p.dv_sh = strides[16]; p.dv_ss = strides[17];
  return run(1, dtype, d, p, stream);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
