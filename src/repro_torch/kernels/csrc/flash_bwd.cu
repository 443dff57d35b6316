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
// At the ChatGLM3 shape (B=4, H=32, KH=2, S=T=1024, D=128, causal) K3's
// four causal products are 68.8 GFLOP, 69.5 us, against 76.5 MB (22.8 us):
// operations bound it there.
//
// What the designs do about it, common to both: each CTA reads its
// resident tiles once (K2: q, dO, O; K3: k, v) and streams the other
// side's tiles from L2, keeps S, P, dP and dS on chip, and writes each
// gradient once, with no atomics, so the result is the same from run to
// run. K2 owns a 64-row q tile; K3 a 64-key tile and loops over its query
// heads and q tiles inside the CTA (the loop replaces the TPU kernel's
// sequential `arbitrary` grid axis and its VMEM accumulators).
//
// K3 takes two routes, by dtype:
//
// bf16, flash_bwd_dkv_tc_kernel (the main path): the FlashAttention-2
// dk/dv loop on the tensor cores. 4 warps of 16 keys each keep K and V in
// shared memory and dK, dV as fp32 accumulators in registers; Q and dO
// tiles (64 queries, 32 at D 128 for registers) stream through two
// buffers with cp.async, with their lse and Delta rows. S^T = K Q^T,
// dP^T = V dO^T, dV += P^T dO and dK += dS^T Q run on mma.sync m16n8k16
// (bf16 in, fp32 accumulators), fed by ldmatrix; P^T and dS^T are rounded
// to bf16 in registers to become A operands. Only tiles that hold a masked
// pair pay for the mask. Under GQA one CTA per key tile would starve the
// card (the decoder: 16 key tiles x 2 kv heads x 4 = 128 CTAs on 132 SMs,
// each walking 16 heads), so the wrapper splits each group's heads over
// `gs` CTAs (flash_attention.py:dkv_group_split; 4 there, 512 CTAs), each
// writing fp32 partials that dkv_reduce_kernel then sums in a fixed order.
// The low causal key tiles, which see the most q tiles, start first.
//
// fp32, and K2 in both dtypes: scalar FMAs on the fp32 CUDA cores (TF32
// would miss the fp32 gate of 1e-4). 128 threads; thread t owns rows
// 4*(t/8) .. +3 of the CTA's resident tile; for a 64x64 score tile it owns
// columns (t%8) + 8j, and for a 64xD accumulator the float4 column groups
// (t%8) + 8jj; row sums reduce with three xor shuffles. Tiles are staged in
// shared memory as fp32, rows padded by 4 floats against bank conflicts.
// K2 on the tensor cores is later work.
//
// Element strides are passed in, so dO, dq, dk and dv may be (B,S,H,D)
// buffers seen as (B,H,S,D) views.

#include "flash_common.cuh"

namespace {

constexpr int NT = 128;   // threads per CTA
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

  load_tile<T, D, NT>(Qs, D + 4, static_cast<const T*>(p.q) + bb * p.q_sb +
                          hh * p.q_sh + q0 * p.q_ss, p.q_ss, rows);
  load_tile<T, D, NT>(dOs, D + 4, static_cast<const T*>(p.d_o) + bb * p.do_sb +
                           hh * p.do_sh + q0 * p.do_ss, p.do_ss, rows);
  // O only feeds Delta, so it borrows K's buffer before the loop
  load_tile<T, D, NT>(Ks, D + 4, static_cast<const T*>(p.o) + bb * p.o_sb +
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
    load_tile<T, D, NT>(Ks, D + 4, kg + kt * p.k_ss, p.k_ss, kv_rows);
    load_tile<T, D, NT>(Vs, D + 4, vg + kt * p.v_ss, p.v_ss, kv_rows);
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

  load_tile<T, D, NT>(Ks, D + 4, static_cast<const T*>(p.k) + bb * p.k_sb +
                          kvh * p.k_sh + k0 * p.k_ss, p.k_ss, kv_rows);
  load_tile<T, D, NT>(Vs, D + 4, static_cast<const T*>(p.v) + bb * p.v_sb +
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
      load_tile<T, D, NT>(Qs, D + 4, qg + qt * p.q_ss, p.q_ss, q_rows);
      load_tile<T, D, NT>(dOs, D + 4, dog + qt * p.do_ss, p.do_ss, q_rows);
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

// The bf16 K3 route: query rows per streamed tile. At D 128 the dK and dV
// accumulators take 128 registers a lane, so the S^T and dP^T tiles are
// kept to 32 queries there.
template <int D>
__host__ __device__ constexpr int dkv_bq() { return D == 128 ? 32 : 64; }

template <int D>
constexpr int dkv_tc_smem_bytes() {  // K, V; two Q, two dO; two lse, Delta
  return (2 * BN + 4 * dkv_bq<D>()) * (D + 8) *
             static_cast<int>(sizeof(bf16)) +
         4 * dkv_bq<D>() * static_cast<int>(sizeof(float));
}

// One warp's step over one streamed q tile of the bf16 K3 (at qt, rows of
// Q, dO and their lse and Delta in Qb, dOb, lb, db): S^T, P^T, dP^T, dS^T
// for its 16 keys, then dV += P^T dO and dK += dS^T Q. With RAGGED (the
// tile runs past S) query blocks past S skip their products; their
// probabilities are masked to 0, so the result is the same.
template <int D, bool RAGGED>
__device__ __forceinline__ void dkv_tile(const Params& p, const bf16* Ks,
                                         const bf16* Vs, const bf16* Qb,
                                         const bf16* dOb, const float* lb,
                                         const float* db, int k0, int qt,
                                         float sl2, float (&dk)[D / 8][4],
                                         float (&dv)[D / 8][4]) {
  constexpr int LD = D + 8;
  constexpr int BQ = dkv_bq<D>();
  constexpr int NQ = BQ / 8;
  constexpr int ND = D / 8;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = lane & 3;
  const int key0 = k0 + warp * 16 + (lane >> 2);   // keys key0, key0 + 8
  const int q_live = p.s - qt;

  // S^T = K Q^T and dP^T = V dO^T: the warp's 16 keys against BQ
  // queries
  float st[NQ][4], dp[NQ][4];
#pragma unroll
  for (int nq = 0; nq < NQ; ++nq)
#pragma unroll
    for (int e = 0; e < 4; ++e) st[nq][e] = dp[nq][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    uint32_t ak[4], av[4];
    load_a(ak, Ks, LD, warp * 16, kk, lane);
    load_a(av, Vs, LD, warp * 16, kk, lane);
#pragma unroll
    for (int nq = 0; nq < NQ; nq += 2) {
      if (RAGGED && nq * 8 >= q_live) break;
      uint32_t b[4];
      load_b_nmajor(b, Qb, LD, nq * 8, kk, lane);
      mma_bf16(st[nq], ak, b[0], b[1]);
      mma_bf16(st[nq + 1], ak, b[2], b[3]);
      load_b_nmajor(b, dOb, LD, nq * 8, kk, lane);
      mma_bf16(dp[nq], av, b[0], b[1]);
      mma_bf16(dp[nq + 1], av, b[2], b[3]);
    }
  }

  // P^T (masked pairs exactly 0, only where the tile holds one) and
  // dS^T = P^T (dP^T - Delta)
  const bool masked = tile_needs_mask(p, qt, BQ, k0, BN);
#pragma unroll
  for (int nq = 0; nq < NQ; ++nq)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qi = nq * 8 + 2 * c + (e & 1);
      float pv = exp2f(fmaf(st[nq][e], sl2, -lb[qi] * LOG2E));
      if (masked && !live(p, qt + qi, key0 + (e >> 1) * 8)) pv = 0.f;
      st[nq][e] = pv;
      dp[nq][e] = pv * (dp[nq][e] - db[qi]);
    }

  // dV += P^T dO and dK += dS^T Q, the queries as the depth
#pragma unroll
  for (int kb = 0; kb < BQ / 16; ++kb) {
    if (RAGGED && kb * 16 >= q_live) break;
    uint32_t ap[4], as[4];
    ap[0] = pack_bf16(st[2 * kb][0], st[2 * kb][1]);
    ap[1] = pack_bf16(st[2 * kb][2], st[2 * kb][3]);
    ap[2] = pack_bf16(st[2 * kb + 1][0], st[2 * kb + 1][1]);
    ap[3] = pack_bf16(st[2 * kb + 1][2], st[2 * kb + 1][3]);
    as[0] = pack_bf16(dp[2 * kb][0], dp[2 * kb][1]);
    as[1] = pack_bf16(dp[2 * kb][2], dp[2 * kb][3]);
    as[2] = pack_bf16(dp[2 * kb + 1][0], dp[2 * kb + 1][1]);
    as[3] = pack_bf16(dp[2 * kb + 1][2], dp[2 * kb + 1][3]);
#pragma unroll
    for (int nd = 0; nd < ND; nd += 2) {
      uint32_t b[4];
      load_b_kmajor(b, dOb, LD, nd * 8, kb * 16, lane);
      mma_bf16(dv[nd], ap, b[0], b[1]);
      mma_bf16(dv[nd + 1], ap, b[2], b[3]);
      load_b_kmajor(b, Qb, LD, nd * 8, kb * 16, lane);
      mma_bf16(dk[nd], as, b[0], b[1]);
      mma_bf16(dk[nd + 1], as, b[2], b[3]);
    }
  }
}

// K3 on the tensor cores (bf16): one CTA per (64-key tile, kv head and
// group slice, batch); slice `slice` of `gs` takes query heads
// kvh*g + slice*g/gs .. + g/gs - 1 of the group. Each warp owns 16 keys.
// K and V stay in shared memory; (q tile, head) steps stream Q, dO, lse
// and Delta through two buffers with cp.async. Per step, on mma.sync:
//   S^T = K Q^T, P^T = exp(S^T scale - lse), dP^T = V dO^T,
//   dV += P^T dO, dS^T = P^T (dP^T - Delta), dK += dS^T Q,
// with P^T and dS^T rounded to bf16 in registers as A operands (the
// FlashAttention-2 backward), the accumulators in fp32 registers. With
// gs == 1 (part == nullptr) dK (times scale) and dV are written in k's
// and v's dtype; otherwise as fp32 partials to part (gs, 2, B, KH, T, D),
// which dkv_reduce_kernel sums. At D 64 the registers are capped at 168 a
// lane, so that three CTAs share an SM (D 32 fits three uncapped).
template <int D>
__global__ void __launch_bounds__(NT, D == 64 ? 3 : 1)
    flash_bwd_dkv_tc_kernel(const Params p, int gs, float* part) {
  constexpr int LD = D + 8;
  constexpr int BQ = dkv_bq<D>();
  constexpr int ND = D / 8;     // 8-column blocks of dK, dV
  extern __shared__ uint4 smem_u4[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_u4);
  bf16* Vs = Ks + BN * LD;
  bf16* Qs = Vs + BN * LD;           // two buffers
  bf16* dOs = Qs + 2 * BQ * LD;      // two buffers
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * BQ * LD);   // two
  float* dl_s = lse_s + 2 * BQ;                                 // two

  // CTAs start in linear order: key tiles in order of k0 across every
  // (slice, kv head, batch), so the low causal key tiles, which see the
  // most q tiles, go first
  const int per = gridDim.y * gridDim.z;
  const int lin = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y *
                                                             blockIdx.z);
  const int k0 = (lin / per) * BN;
  const int kvh = (lin % per) % gridDim.y / gs;
  const int slice = (lin % per) % gridDim.y % gs;
  const int bb = (lin % per) / gridDim.y;
  const int gper = p.h / p.kh / gs;
  const int h0 = kvh * (p.h / p.kh) + slice * gper;
  const int kv_rows = min(BN, p.t - k0);

  // the q tiles that can see this key tile: q >= k for causal, and
  // q - k < window, with k in [k0, k0 + BN)
  int q_lo = p.causal ? k0 : 0, q_hi = p.s;
  if (p.window > 0) q_hi = min(q_hi, k0 + BN - 1 + p.window);
  q_lo -= q_lo % BQ;
  const int n_q = q_hi > q_lo ? (q_hi - q_lo + BQ - 1) / BQ : 0;
  const int n_it = gper * n_q;

  const bf16* qb = static_cast<const bf16*>(p.q) + bb * p.q_sb;
  const bf16* dob = static_cast<const bf16*>(p.d_o) + bb * p.do_sb;
  // step `it` (head h0 + it / n_q, q tile it % n_q) into buffer `buf`
  auto load_step = [&](int it, int buf) {
    const int hh = h0 + it / n_q;
    const int qt = q_lo + (it % n_q) * BQ;
    const int rows = min(BQ, p.s - qt);
    load_tile_async<D, BQ, NT>(Qs + buf * BQ * LD,
                               qb + hh * p.q_sh + qt * p.q_ss, p.q_ss, rows);
    load_tile_async<D, BQ, NT>(dOs + buf * BQ * LD,
                               dob + hh * p.do_sh + qt * p.do_ss, p.do_ss,
                               rows);
    const long long row = (static_cast<long long>(bb) * p.h + hh) * p.s + qt;
    for (int r = threadIdx.x; r < BQ; r += NT) {
      const bool in = r < rows;
      cp_async4(lse_s + buf * BQ + r, p.lse + (in ? row + r : 0), in);
      cp_async4(dl_s + buf * BQ + r, p.delta + (in ? row + r : 0), in);
    }
  };

  load_tile_async<D, BN, NT>(Ks, static_cast<const bf16*>(p.k) +
                                     bb * p.k_sb + kvh * p.k_sh +
                                     k0 * p.k_ss, p.k_ss, kv_rows);
  load_tile_async<D, BN, NT>(Vs, static_cast<const bf16*>(p.v) +
                                     bb * p.v_sb + kvh * p.v_sh +
                                     k0 * p.v_ss, p.v_ss, kv_rows);
  if (n_it > 0) load_step(0, 0);
  cp_async_commit();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int key0 = k0 + warp * 16 + g;   // keys key0 and key0 + 8
  const bool keys_live = k0 + warp * 16 < p.t;
  const float sl2 = p.scale * LOG2E;

  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nd][e] = dv[nd][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_it) load_step(it + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();   // this step's tiles (and K, V) have landed
    __syncthreads();
    // a warp whose 16 keys all lie past T skips the step; a q tile past S
    // takes the ragged step
    if (keys_live) {
      const int qt = q_lo + (it % n_q) * BQ;
      const bf16* Qb = Qs + buf * BQ * LD;
      const bf16* dOb = dOs + buf * BQ * LD;
      const float* lb = lse_s + buf * BQ;
      const float* db = dl_s + buf * BQ;
      if (qt + BQ <= p.s)
        dkv_tile<D, false>(p, Ks, Vs, Qb, dOb, lb, db, k0, qt, sl2, dk, dv);
      else
        dkv_tile<D, true>(p, Ks, Vs, Qb, dOb, lb, db, k0, qt, sl2, dk, dv);
    }
    __syncthreads();   // every warp is done with this buffer
  }
  cp_async_wait<0>();
  __syncthreads();     // K and V have landed, also where no step ran

  if (part == nullptr) {
    // dK, dV in bf16, staged in the warp's own K and V rows (no other
    // warp reads them) and written 16 bytes at a time
    bf16* Kw = Ks + warp * 16 * LD;
    bf16* Vw = Vs + warp * 16 * LD;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int off = (g + 8 * r) * LD + nd * 8 + 2 * c;
        *reinterpret_cast<uint32_t*>(Kw + off) =
            pack_bf16(dk[nd][2 * r] * p.scale, dk[nd][2 * r + 1] * p.scale);
        *reinterpret_cast<uint32_t*>(Vw + off) =
            pack_bf16(dv[nd][2 * r], dv[nd][2 * r + 1]);
      }
    __syncwarp();
    bf16* dkg = static_cast<bf16*>(p.dk) + bb * p.dk_sb + kvh * p.dk_sh;
    bf16* dvg = static_cast<bf16*>(p.dv) + bb * p.dv_sb + kvh * p.dv_sh;
#pragma unroll
    for (int i = lane; i < 16 * ND; i += 32) {
      const int r = i / ND;
      const int col = (i % ND) * 8;
      const int key = k0 + warp * 16 + r;
      if (key < p.t) {
        *reinterpret_cast<uint4*>(dkg + key * p.dk_ss + col) =
            *reinterpret_cast<const uint4*>(Kw + r * LD + col);
        *reinterpret_cast<uint4*>(dvg + key * p.dv_ss + col) =
            *reinterpret_cast<const uint4*>(Vw + r * LD + col);
      }
    }
  } else {
    // fp32 partials of this slice: part[slice][0 = dK, 1 = dV][b][kvh]
    const long long n = static_cast<long long>(p.b) * p.kh * p.t * D;
    const long long base =
        2 * slice * n + ((static_cast<long long>(bb) * p.kh + kvh) * p.t) * D;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = key0 + 8 * r;
        if (key < p.t) {
          const long long at = base + static_cast<long long>(key) * D +
                               nd * 8 + 2 * c;
          *reinterpret_cast<float2*>(part + at) = make_float2(
              dk[nd][2 * r] * p.scale, dk[nd][2 * r + 1] * p.scale);
          *reinterpret_cast<float2*>(part + n + at) =
              make_float2(dv[nd][2 * r], dv[nd][2 * r + 1]);
        }
      }
  }
}

// The second launch of K3 where gs > 1: dK and dV as the sums of the gs
// slices' fp32 partials, slice 0 first (a fixed order, so the result is
// the same from run to run), cast to k's and v's dtype and layout. One
// thread per 4 elements of the (2, B, KH, T, D) pair.
__global__ void __launch_bounds__(256)
    dkv_reduce_kernel(const Params p, int gs, int d, const float* part) {
  const long long n = static_cast<long long>(p.b) * p.kh * p.t * d;
  const long long e =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  if (e >= 2 * n) return;
  const int which = e >= n;          // 0 = dK, 1 = dV
  const long long i = e - which * n;
  float4 acc = *reinterpret_cast<const float4*>(part + e);
  for (int sl = 1; sl < gs; ++sl) {
    const float4 x =
        *reinterpret_cast<const float4*>(part + 2 * sl * n + e);
    acc.x += x.x; acc.y += x.y; acc.z += x.z; acc.w += x.w;
  }
  const int col = static_cast<int>(i % d);
  const long long row = i / d;
  const int key = static_cast<int>(row % p.t);
  const int kvh = static_cast<int>(row / p.t % p.kh);
  const int bb = static_cast<int>(row / p.t / p.kh);
  bf16* out = which
      ? static_cast<bf16*>(p.dv) + bb * p.dv_sb + kvh * p.dv_sh +
            key * p.dv_ss
      : static_cast<bf16*>(p.dk) + bb * p.dk_sb + kvh * p.dk_sh +
            key * p.dk_ss;
  store4(out + col, acc);
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

template <int D>
cudaError_t launch_dkv_tc(const Params& p, int gs, float* part,
                          cudaStream_t stream) {
  if (gs < 1 || (p.h / p.kh) % gs || (gs > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  constexpr int smem = dkv_tc_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_tc_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.t + BN - 1) / BN, p.kh * gs, p.b);
  float* partials = gs > 1 ? part : nullptr;
  flash_bwd_dkv_tc_kernel<D><<<grid, NT, smem, stream>>>(p, gs, partials);
  err = cudaGetLastError();
  if (err != cudaSuccess || gs == 1) return err;
  const long long quads = static_cast<long long>(p.b) * p.kh * p.t * D / 2;
  const unsigned blocks = static_cast<unsigned>((quads + 255) / 256);
  dkv_reduce_kernel<<<blocks, 256, 0, stream>>>(p, gs, D, part);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dq(int d, const Params& p, cudaStream_t st) {
  switch (d) {
    case 32: return launch_dq<T, 32>(p, st);
    case 64: return launch_dq<T, 64>(p, st);
    case 128: return launch_dq<T, 128>(p, st);
    default: return cudaErrorInvalidValue;
  }
}

// K3 by dtype: fp32 on the CUDA cores (no group split), bf16 on the
// tensor cores
cudaError_t dispatch_dkv(int dtype, int d, const Params& p, int gs,
                         float* part, cudaStream_t st) {
  if (dtype == 0 && gs == 1) {
    switch (d) {
      case 32: return launch_dkv<float, 32>(p, st);
      case 64: return launch_dkv<float, 64>(p, st);
      case 128: return launch_dkv<float, 128>(p, st);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype == 1) {
    switch (d) {
      case 32: return launch_dkv_tc<32>(p, gs, part, st);
      case 64: return launch_dkv_tc<64>(p, gs, part, st);
      case 128: return launch_dkv_tc<128>(p, gs, part, st);
      default: return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
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
// delta are contiguous fp32 (B,H,S). K3 splits each GQA group over `gs`
// CTAs (a divisor of H/KH; 1 for float32); with gs > 1, `scratch` holds
// 2 * gs * B * KH * T * D fp32 partials. Each returns a cudaError_t
// (0 = ok).
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(dispatch_dq<float>(d, p, st));
  if (dtype == 1) return static_cast<int>(dispatch_dq<bf16>(d, p, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

int repro_flash_bwd_dkv(int dtype, int d, const void* q, const void* k,
                        const void* v, const void* d_o, const void* lse,
                        const void* delta, void* dk, void* dv, int b, int h,
                        int kh, int s, int t, const long long* strides,
                        int causal, int window, float scale, int gs,
                        void* scratch, void* stream) {
  Params p = {};
  set_common(p, q, k, v, d_o, lse, b, h, kh, s, t, strides, causal, window,
             scale);
  p.delta = const_cast<float*>(static_cast<const float*>(delta));
  p.dk = dk; p.dv = dv;
  p.dk_sb = strides[12]; p.dk_sh = strides[13]; p.dk_ss = strides[14];
  p.dv_sb = strides[15]; p.dv_sh = strides[16]; p.dv_ss = strides[17];
  return static_cast<int>(dispatch_dkv(dtype, d, p, gs,
                                       static_cast<float*>(scratch),
                                       static_cast<cudaStream_t>(stream)));
}

// Keys per K3 CTA (BN): the host sizes K3's group split from it.
int repro_flash_key_tile() { return BN; }

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
