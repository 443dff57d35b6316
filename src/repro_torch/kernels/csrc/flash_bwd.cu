// K2 and K3: the flash-attention backward for Hopper (sm_90a), plain C
// interface.
//
// Replaces src/repro/kernels/flash_attention.py:_dq_kernel (K2, launched by
// _backward_dq) and :_dkv_kernel (K3, launched by _backward_dkv). For q
// (B,H,S,D), k (B,KH,T,D), v (B,KH,T,Dv), the forward's output O
// (B,H,S,Dv) and fp32 lse (B,H,S), and the output gradient dO (B,H,S,Dv),
// with GQA (kv_head = h / (H/KH)):
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
// At the ChatGLM3 shape (B=4, H=32, KH=2, S=T=1024, D=128, causal) K2's
// three causal products are 51.6 GFLOP (52 us) against 139.5 MB (42 us),
// and K3's four 68.8 GFLOP (70 us) against 76.5 MB (23 us): operations
// bound both there.
//
// What the designs do about it, common to both: each CTA reads its
// resident tiles once (K2: q, dO, O; K3: k, v) and streams the other
// side's tiles from L2, keeps S, P, dP and dS on chip, and writes each
// gradient once, with no atomics, so the result is the same from run to
// run. K2 owns a 64-row q tile; K3 a 64-key tile and loops over its query
// heads and q tiles inside the CTA (the loop replaces the TPU kernel's
// sequential `arbitrary` grid axis and its VMEM accumulators).
//
// Each takes two routes, by dtype:
//
// bf16, the main path: the FlashAttention-2 backward loops on the tensor
// cores, mma.sync m16n8k16 (bf16 in, fp32 accumulators) fed by ldmatrix
// from rows padded to D + 8 elements, tiles copied with cp.async (rows past
// S or T zero-filled) through two buffers, the next in flight while the
// current one is used. P and dS are rounded to bf16 in registers to become
// A operands. Only tiles that hold a masked pair pay for the mask, and a
// tile past T or S takes a separate templated step that skips the blocks
// past the edge (a per-element skip in every tile cost K1 17%).
//
//   flash_bwd_dq_tc_kernel (K2): one CTA of 4 warps per (64-row q tile,
//   head, batch); each warp owns 16 query rows. Q and dO stay in shared
//   memory (their A fragments are re-read with ldmatrix per key tile, which
//   keeps the registers to S, dP and the dq accumulators); O borrows a key
//   buffer before the loop, for Delta. 64-key K and V tiles stream; per
//   tile S = Q K^T, dP = dO V^T and dq += dS K (K as the B operand through
//   ldmatrix.trans) run on mma.sync, with each element's (row, key) for the
//   mask taken from the C-fragment layout. Causal q tiles launch in
//   reverse, so the tiles that see the most keys start first. dq (times
//   scale) is staged through the warp's own Q rows and written once with
//   16-byte stores; Delta once per row. The grid needs no split: 16 q tiles
//   x 32 heads x 4 = 2,048 CTAs at the decoder's shape, 4 x 12 x 64 =
//   3,072 at the ViT's.
//
//   flash_bwd_dkv_tc_kernel (K3): 4 warps of 16 keys each keep K and V in
//   shared memory and dK, dV as fp32 accumulators in registers; Q and dO
//   tiles (64 queries, 32 at D 128 for registers) stream with their lse and
//   Delta rows. S^T = K Q^T, dP^T = V dO^T, dV += P^T dO and dK += dS^T Q
//   run on mma.sync. Under GQA one CTA per key tile would starve the card
//   (the decoder: 16 key tiles x 2 kv heads x 4 = 128 CTAs on 132 SMs, each
//   walking 16 heads), so the wrapper splits each group's heads over `gs`
//   CTAs (flash_attention.py:dkv_group_split; 4 there, 512 CTAs), each
//   writing fp32 partials that dkv_reduce_kernel then sums in a fixed
//   order. The low causal key tiles, which see the most q tiles, start
//   first.
//
// fp32: scalar FMAs on the fp32 CUDA cores (TF32 would miss the fp32 gate
// of 1e-4). 128 threads; thread t owns rows 4*(t/8) .. +3 of the CTA's
// resident tile; for a 64x64 score tile it owns columns (t%8) + 8j, and for
// a 64xD accumulator the float4 column groups (t%8) + 8jj (f4_owns: at
// D 80 threads t%8 < 4 own three, the others two); row sums reduce
// with three xor shuffles. Tiles are staged in shared memory as fp32, rows
// padded by 4 floats against bank conflicts.
//
// Head dim 256 (Gemma3's) takes the same loops with three changes. bf16
// K2 runs each 64-key tile in two passes of 32 keys (dq_keys), so S and dP
// (32 registers a lane) sit beside dq's 128; its Q, dO and two K and V
// buffers take 198 KB, one CTA an SM. K3, in both routes, splits dK and dV
// over two CTAs of 128 columns each (dkv_cols): both recompute S^T and
// dP^T over the whole D, for 1.5 times the products, so that each keeps
// 128 accumulator registers a lane instead of 256. The fp32 routes stream
// tiles of 32 rows (f32_tile; K2's keys, K3's queries) to fit shared
// memory. At Gemma3-12B's attention (B=1, H=16, KH=8, S=T=4096, D=256,
// causal) a local layer's window of 1024 leaves 58.7 M live pairs: K2's
// products are 90.2 GFLOP (91 us) against 168 MB (50 us), K3's 120.3
// GFLOP (122 us) against 135 MB (40 us); operations bound both.
//
// The value head dim is a second template parameter, DV: the (D, Dv) pairs
// of FLASH_HEAD_DIM_PAIRS (flash_common.cuh), D = Dv or DeepSeek-V3's MLA
// (192, 128). S and dq = dS K run over D, dP = dO V^T and Delta over Dv;
// V and dO tiles are Dv wide (nothing padded). K3 keeps dK (D columns) and
// dV (Dv) of a key tile in one CTA at (192, 128): 96 + 64 fp32 accumulator
// registers a lane on the tensor cores; ptxas gives that kernel 255
// registers and spills 44 bytes (136 bytes of reloads; the fp32 route 288
// and 192). A split over two CTAs (48 + 32 accumulators, as D 256 does)
// would not spill, but both CTAs recompute S^T and dP^T, 1.5 times the
// products, so one CTA a key tile stays. At the MLA shape (B=2,
// H=KH=128, S=T=1024, causal) K2's products are 2 x 134.3 M
// live pairs x (2 x 192 + 128) = 137.6 GFLOP (139 us) against 505.4 MB
// (151 us): bytes bound it; K3's 2 x 134.3 M x (2 x 192 + 2 x 128) =
// 172.0 GFLOP (174 us) against the same 505.4 MB: operations bound it.
//
// Element strides are passed in, so dO, dq, dk and dv may be (B,S,H,D)
// buffers seen as (B,H,S,D) views.

#include "flash_common.cuh"

namespace {

constexpr int NT = 128;   // threads per CTA

// Columns of dK one K3 CTA owns: all D, or half of D at 256, where both
// fp32 accumulators of a whole row would take 256 registers a lane; the
// grid then holds D / dkv_cols<D>() CTAs per key tile (dkv_col_tiles),
// each recomputing S^T and dP^T over the whole D and owning the same
// share of dV's Dv columns.
template <int D>
__host__ __device__ constexpr int dkv_cols() { return D == 256 ? 128 : D; }

template <int D>
__host__ __device__ constexpr int dkv_col_tiles() { return D / dkv_cols<D>(); }

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
// against NJ x 8 rows of the streamed tile B, both staged with stride
// D + 4.
template <int D, int NJ>
__device__ __forceinline__ void tile_dot(const float* A, const float* B,
                                         int r0, int cg,
                                         float (&acc)[4][NJ]) {
  constexpr int LD = D + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int kk = 0; kk < D; kk += 4) {
    float4 a[4], bb[NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (r0 + i) * LD + kk);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      bb[j] = *reinterpret_cast<const float4*>(B + (cg + 8 * j) * LD + kk);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        acc[i][j] = fmaf(a[i].x, bb[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, bb[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, bb[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, bb[j].w, acc[i][j]);
      }
  }
}

// acc[i][c] += sum_n W[r0+i][n] * X[n][col c]: a 64 x NK weight tile W
// (stride NK + 4) times NK rows of a tile X (stride D + 4) from its column
// X on, for the thread's rows r0+i and the float4 column groups cg + 8jj
// of the first DC columns it owns (f4_owns).
template <int D, int NK, int DC>
__device__ __forceinline__ void tile_matmul(
    const float* W, const float* X, int r0, int cg,
    float (&acc)[4][4 * f4_groups<DC>()]) {
  constexpr int LD = D + 4;
  constexpr int LDW = NK + 4;
  constexpr int DV = f4_groups<DC>();
#pragma unroll 2
  for (int n = 0; n < NK; n += 4) {
    float4 w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = *reinterpret_cast<const float4*>(W + (r0 + i) * LDW + n);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float* xrow = X + (n + u) * LD;
#pragma unroll
      for (int jj = 0; jj < DV; ++jj) {
        if (!f4_owns<DC>(cg, jj)) continue;
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

// Write the thread's rows r0+i < rows of a 64 x DC accumulator, in T.
template <typename T, int DC>
__device__ __forceinline__ void store_rows(
    T* base, long long ld, int rows, int r0, int cg,
    const float (&acc)[4][4 * f4_groups<DC>()]) {
  constexpr int DV = f4_groups<DC>();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (r0 + i < rows) {
      T* row = base + (r0 + i) * ld;
#pragma unroll
      for (int jj = 0; jj < DV; ++jj)
        if (f4_owns<DC>(cg, jj))
          store4(row + 4 * (cg + 8 * jj),
                 make_float4(acc[i][4 * jj + 0], acc[i][4 * jj + 1],
                             acc[i][4 * jj + 2], acc[i][4 * jj + 3]));
    }
  }
}

template <int D, int DV>
constexpr int dq_smem_bytes() {   // Q, dO; K, V (O before the loop); dS
  constexpr int KB = f32_tile<D>();
  return ((BM + KB) * (D + 4) + (BM + KB) * (DV + 4) + BM * (KB + 4)) *
         static_cast<int>(sizeof(float));
}

template <int D, int DV>
constexpr int dkv_smem_bytes() {  // K, V; Q, dO; P, dS; lse, Delta
  constexpr int QB = f32_tile<D>();
  return ((BN + QB) * (D + 4) + (BN + QB) * (DV + 4) + 2 * BN * (QB + 4) +
          2 * QB) *
         static_cast<int>(sizeof(float));
}

// K2 on the CUDA cores (fp32): one CTA per (64-row q tile, head, batch);
// key tiles of KB = f32_tile<D>() rows (32 at D 256).
template <typename T, int D, int DV>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(const Params p) {
  constexpr int KB = f32_tile<D>();
  constexpr int NJ = KB / 8;      // keys per thread in a score tile
  constexpr int LD = D + 4;
  constexpr int LDV = DV + 4;     // dO, V and O rows
  constexpr int LDS = KB + 4;     // padded dS row stride
  constexpr int NG = f4_groups<DV>();   // float4 groups of a Dv row
  static_assert(BM * LDV <= KB * (LD + LDV),
                "K2 stages O's rows in the K and V buffers");
  extern __shared__ float4 smem_f4[];
  float* Qs = reinterpret_cast<float*>(smem_f4);
  float* dOs = Qs + BM * LD;
  float* Ks = dOs + BM * LDV;
  float* Vs = Ks + KB * LD;
  float* dSs = Vs + KB * LDV;

  const int q0 = blockIdx.x * BM;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int kvh = hh / (p.h / p.kh);
  const int rows = min(BM, p.s - q0);
  const T* kg = static_cast<const T*>(p.k) + bb * p.k_sb + kvh * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + bb * p.v_sb + kvh * p.v_sh;

  load_tile<T, D, NT>(Qs, D + 4, static_cast<const T*>(p.q) + bb * p.q_sb +
                          hh * p.q_sh + q0 * p.q_ss, p.q_ss, rows);
  load_tile<T, DV, NT>(dOs, LDV, static_cast<const T*>(p.d_o) +
                                    bb * p.do_sb + hh * p.do_sh +
                                    q0 * p.do_ss, p.do_ss, rows);
  // O only feeds Delta, so it borrows the K and V buffers before the loop
  load_tile<T, DV, NT>(Ks, LDV, static_cast<const T*>(p.o) + bb * p.o_sb +
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
    for (int jj = 0; jj < NG; ++jj) {
      if (!f4_owns<DV>(cg, jj)) continue;
      const int col = 4 * (cg + 8 * jj);
      const float4 a =
          *reinterpret_cast<const float4*>(dOs + (r0 + i) * LDV + col);
      const float4 c =
          *reinterpret_cast<const float4*>(Ks + (r0 + i) * LDV + col);
      part += a.x * c.x + a.y * c.y + a.z * c.z + a.w * c.w;
    }
    delta[i] = row_sum8(part);
    const bool in = r0 + i < rows;
    lse[i] = in ? p.lse[row_base + q0 + r0 + i] : 0.f;
    if (in && cg == 0) p.delta[row_base + q0 + r0 + i] = delta[i];
  }

  float acc[4][4 * f4_groups<D>()];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * f4_groups<D>(); ++c) acc[i][c] = 0.f;

  // the key tiles this q tile can see (K1's loop bounds)
  int k_lo = 0, k_hi = p.t;
  if (p.causal) k_hi = min(k_hi, q0 + BM);
  if (p.window > 0) k_lo = max(0, q0 - p.window + 1);
  k_lo -= k_lo % KB;

  for (int kt = k_lo; kt < k_hi; kt += KB) {
    __syncthreads();   // every thread is done with the previous K, V, dS
    const int kv_rows = min(KB, p.t - kt);
    load_tile<T, D, NT, KB>(Ks, LD, kg + kt * p.k_ss, p.k_ss, kv_rows);
    load_tile<T, DV, NT, KB>(Vs, LDV, vg + kt * p.v_ss, p.v_ss, kv_rows);
    __syncthreads();

    float pr[4][NJ], dp[4][NJ];
    tile_dot<D, NJ>(Qs, Ks, r0, cg, pr);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        pr[i][j] = live(p, q0 + r0 + i, kt + cg + 8 * j)
                       ? expf(pr[i][j] * p.scale - lse[i]) : 0.f;
    tile_dot<DV, NJ>(dOs, Vs, r0, cg, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        dSs[(r0 + i) * LDS + cg + 8 * j] =
            live(p, q0 + r0 + i, kt + cg + 8 * j)
                ? pr[i][j] * (dp[i][j] - delta[i]) * p.scale : 0.f;
    __syncthreads();

    tile_matmul<D, KB, D>(dSs, Ks, r0, cg, acc);   // dq += dS K
  }

  store_rows<T, D>(static_cast<T*>(p.dq) + bb * p.dq_sb + hh * p.dq_sh +
                       q0 * p.dq_ss, p.dq_ss, rows, r0, cg, acc);
}

// K3: one CTA per (64-key tile, kv head and column block, batch); loops
// over the group's query heads and the live q tiles (QB = f32_tile<D>()
// rows each, 32 at D 256), and flushes its DC = dkv_cols<D>() columns of
// dk and its DCV = Dv / dkv_col_tiles<D>() columns of dv once.
template <typename T, int D, int DV>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(const Params p) {
  constexpr int QB = f32_tile<D>();
  constexpr int NJ = QB / 8;      // queries per thread in a score tile
  constexpr int CT = dkv_col_tiles<D>();
  constexpr int DC = dkv_cols<D>();
  constexpr int DCV = DV / CT;
  constexpr int LD = D + 4;
  constexpr int LDV = DV + 4;     // V and dO rows
  constexpr int LDS = QB + 4;     // padded P/dS row stride
  extern __shared__ float4 smem_f4[];
  float* Ks = reinterpret_cast<float*>(smem_f4);
  float* Vs = Ks + BN * LD;
  float* Qs = Vs + BN * LDV;
  float* dOs = Qs + QB * LD;
  float* Ps = dOs + QB * LDV;
  float* dSs = Ps + BN * LDS;
  float* lse_s = dSs + BN * LDS;
  float* delta_s = lse_s + QB;

  const int k0 = blockIdx.x * BN;
  const int kvh = blockIdx.y / CT;
  const int col0 = blockIdx.y % CT * DC;
  const int colv0 = blockIdx.y % CT * DCV;
  const int bb = blockIdx.z;
  const int g = p.h / p.kh;
  const int kv_rows = min(BN, p.t - k0);

  load_tile<T, D, NT>(Ks, D + 4, static_cast<const T*>(p.k) + bb * p.k_sb +
                          kvh * p.k_sh + k0 * p.k_ss, p.k_ss, kv_rows);
  load_tile<T, DV, NT>(Vs, LDV, static_cast<const T*>(p.v) + bb * p.v_sb +
                                   kvh * p.v_sh + k0 * p.v_ss, p.v_ss,
                       kv_rows);

  const int tid = threadIdx.x;
  const int r0 = (tid >> 3) * 4;
  const int cg = tid & 7;

  float dk[4][4 * f4_groups<DC>()], dv[4][4 * f4_groups<DCV>()];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < 4 * f4_groups<DC>(); ++c) dk[i][c] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * f4_groups<DCV>(); ++c) dv[i][c] = 0.f;
  }

  // the q tiles that can see this key tile: q >= k for causal, and
  // q - k < window, with k in [k0, k0 + BN)
  int q_lo = p.causal ? k0 : 0, q_hi = p.s;
  if (p.window > 0) q_hi = min(q_hi, k0 + BN - 1 + p.window);
  q_lo -= q_lo % QB;

  for (int gi = 0; gi < g; ++gi) {
    const int hh = kvh * g + gi;
    const long long row_base = (static_cast<long long>(bb) * p.h + hh) * p.s;
    const T* qg = static_cast<const T*>(p.q) + bb * p.q_sb + hh * p.q_sh;
    const T* dog = static_cast<const T*>(p.d_o) + bb * p.do_sb + hh * p.do_sh;
    for (int qt = q_lo; qt < q_hi; qt += QB) {
      __syncthreads();   // every thread is done with the previous tiles
      const int q_rows = min(QB, p.s - qt);
      load_tile<T, D, NT, QB>(Qs, D + 4, qg + qt * p.q_ss, p.q_ss, q_rows);
      load_tile<T, DV, NT, QB>(dOs, LDV, dog + qt * p.do_ss, p.do_ss,
                               q_rows);
      for (int r = tid; r < QB; r += NT) {
        lse_s[r] = r < q_rows ? p.lse[row_base + qt + r] : 0.f;
        delta_s[r] = r < q_rows ? p.delta[row_base + qt + r] : 0.f;
      }
      __syncthreads();

      // transposed tiles: rows are the CTA's keys r0+i, columns the
      // queries cg+8j
      float pr[4][NJ], dp[4][NJ];
      tile_dot<D, NJ>(Ks, Qs, r0, cg, pr);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int qj = cg + 8 * j;
          pr[i][j] = live(p, qt + qj, k0 + r0 + i)
                         ? expf(pr[i][j] * p.scale - lse_s[qj]) : 0.f;
          Ps[(r0 + i) * LDS + qj] = pr[i][j];
        }
      tile_dot<DV, NJ>(Vs, dOs, r0, cg, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int qj = cg + 8 * j;
          dSs[(r0 + i) * LDS + qj] =
              live(p, qt + qj, k0 + r0 + i)
                  ? pr[i][j] * (dp[i][j] - delta_s[qj]) * p.scale : 0.f;
        }
      __syncthreads();

      // dv += P^T dO and dk += dS^T Q over this CTA's columns
      tile_matmul<DV, QB, DCV>(Ps, dOs + colv0, r0, cg, dv);
      tile_matmul<D, QB, DC>(dSs, Qs + col0, r0, cg, dk);
    }
  }

  store_rows<T, DC>(static_cast<T*>(p.dk) + bb * p.dk_sb + kvh * p.dk_sh +
                        k0 * p.dk_ss + col0, p.dk_ss, kv_rows, r0, cg, dk);
  store_rows<T, DCV>(static_cast<T*>(p.dv) + bb * p.dv_sb + kvh * p.dv_sh +
                         k0 * p.dv_ss + colv0, p.dv_ss, kv_rows, r0, cg, dv);
}

// Keys of a bf16 K2 tile that one pass of dq_tile takes: the whole tile,
// or half of it at D 256, where the S and dP fragments of 64 keys beside
// the 128 registers of dq's accumulator would crowd the 255 a lane has.
template <int D>
__host__ __device__ constexpr int dq_keys() { return D == 256 ? 32 : BN; }

// One warp's step over one key tile of the bf16 K2 (at kt, K and V rows in
// Kb, Vb), in passes of KS = dq_keys<D>() keys: S = Q K^T (over D) and
// dP = dO V^T (over Dv; dO and V rows of DV + 8) for its 16 rows against
// the pass's keys, P = exp(S scale - lse), dS = P (dP - Delta), then
// dq += dS K. lse2 and dl hold lse * log2(e) and Delta of the lane's rows
// g and g + 8. With RAGGED (the tile runs past T) key blocks past T skip
// their products; their dS are masked to 0, so the result is the same.
template <int D, int DV, bool RAGGED>
__device__ __forceinline__ void dq_tile(const Params& p, const bf16* Qs,
                                        const bf16* dOs, const bf16* Kb,
                                        const bf16* Vb, int q0, int kt,
                                        float sl2, const float (&lse2)[2],
                                        const float (&dl)[2],
                                        float (&dq)[D / 8][4]) {
  constexpr int LD = D + 8;
  constexpr int LDV = DV + 8;
  constexpr int KS = dq_keys<D>();
  constexpr int NB = KS / 8;
  constexpr int ND = D / 8;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = lane & 3;
  const int row0 = warp * 16 + (lane >> 2);   // rows row0 and row0 + 8

#pragma unroll 1
  for (int j0 = 0; j0 < BN; j0 += KS) {
    const int keys_live = p.t - kt - j0;
    if (RAGGED && keys_live <= 0) break;
    float s[NB][4], dp[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      // the depth runs over D for S and over the first Dv for dP
      uint32_t aq[4], ad[4];
      load_a(aq, Qs, LD, warp * 16, kk, lane);
      if (kk < DV) load_a(ad, dOs, LDV, warp * 16, kk, lane);
#pragma unroll
      for (int nb = 0; nb < NB; nb += 2) {
        if (RAGGED && nb * 8 >= keys_live) break;
        uint32_t b[4];
        load_b_nmajor(b, Kb, LD, j0 + nb * 8, kk, lane);
        mma_bf16(s[nb], aq, b[0], b[1]);
        mma_bf16(s[nb + 1], aq, b[2], b[3]);
        if (kk < DV) {
          load_b_nmajor(b, Vb, LDV, j0 + nb * 8, kk, lane);
          mma_bf16(dp[nb], ad, b[0], b[1]);
          mma_bf16(dp[nb + 1], ad, b[2], b[3]);
        }
      }
    }

    // P (masked pairs exactly 0, only where the warp's rows and the keys
    // hold one) and dS = P (dP - Delta), over dP's registers
    const bool masked = tile_needs_mask(p, q0 + warp * 16, 16, kt + j0, KS);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pv = exp2f(fmaf(s[nb][e], sl2, -lse2[e >> 1]));
        if (masked && !live(p, q0 + row0 + (e >> 1) * 8,
                            kt + j0 + nb * 8 + 2 * c + (e & 1)))
          pv = 0.f;
        dp[nb][e] = pv * (dp[nb][e] - dl[e >> 1]);
      }

    // dq += dS K, the keys as the depth: dS rounded to bf16 in registers
    // as the A operand, K (stored key-major) as B through ldmatrix.trans
#pragma unroll
    for (int kb = 0; kb < KS / 16; ++kb) {
      if (RAGGED && kb * 16 >= keys_live) break;
      uint32_t a[4];
      a[0] = pack_bf16(dp[2 * kb][0], dp[2 * kb][1]);
      a[1] = pack_bf16(dp[2 * kb][2], dp[2 * kb][3]);
      a[2] = pack_bf16(dp[2 * kb + 1][0], dp[2 * kb + 1][1]);
      a[3] = pack_bf16(dp[2 * kb + 1][2], dp[2 * kb + 1][3]);
#pragma unroll
      for (int nd = 0; nd < ND; nd += 2) {
        uint32_t b[4];
        load_b_kmajor(b, Kb, LD, nd * 8, j0 + kb * 16, lane);
        mma_bf16(dq[nd], a, b[0], b[1]);
        mma_bf16(dq[nd + 1], a, b[2], b[3]);
      }
    }
  }
}

// K2 on the tensor cores (bf16): see the note at the top. Where D <= 80 the
// registers are capped at 168 a lane, so that three CTAs share an SM (at
// D 128 shared memory allows two, at D 192 and 256 one, whose lanes may
// take 255).
static_assert(BM <= BN, "K2 stages BM rows of O in a key buffer of BN rows");
template <int D, int DV>
__global__ void __launch_bounds__(NT, D >= 192 ? 1 : D == 128 ? 2 : 3)
    flash_bwd_dq_tc_kernel(const Params p) {
  constexpr int LD = D + 8;
  constexpr int LDV = DV + 8;   // dO, V and O rows
  constexpr int ND = D / 8;     // 8-column blocks of dq
  static_assert(DV <= D, "K2 stages O's Dv-wide rows in a key buffer");
  extern __shared__ uint4 smem_u4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_u4);
  bf16* dOs = Qs + BM * LD;
  bf16* Ks = dOs + BM * LDV;         // two buffers; O borrows the second
  bf16* Vs = Ks + 2 * BN * LD;       // two buffers of BN x LDV

  // CTAs start in linear order; causal q tiles go last-first
  const int per = gridDim.y * gridDim.z;
  const int lin = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y *
                                                             blockIdx.z);
  int qt = lin / per;
  if (p.causal) qt = gridDim.x - 1 - qt;
  const int hh = (lin % per) % gridDim.y;
  const int bb = (lin % per) / gridDim.y;
  const int q0 = qt * BM;
  const int kvh = hh / (p.h / p.kh);
  const int rows = min(BM, p.s - q0);
  const bf16* kg = static_cast<const bf16*>(p.k) + bb * p.k_sb +
                   kvh * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + bb * p.v_sb +
                   kvh * p.v_sh;

  // the key tiles this q tile can see (K1's loop bounds)
  int k_lo = 0, k_hi = p.t;
  if (p.causal) k_hi = min(k_hi, q0 + BM);
  if (p.window > 0) k_lo = max(0, q0 - p.window + 1);
  k_lo -= k_lo % BN;

  // Q, dO and O first (O into the second K buffer), then the first K, V
  // tile, each its own group
  load_tile_async<D, BM, NT>(Qs, static_cast<const bf16*>(p.q) +
                                     bb * p.q_sb + hh * p.q_sh +
                                     q0 * p.q_ss, p.q_ss, rows);
  load_tile_async<DV, BM, NT>(dOs, static_cast<const bf16*>(p.d_o) +
                                       bb * p.do_sb + hh * p.do_sh +
                                       q0 * p.do_ss, p.do_ss, rows);
  load_tile_async<DV, BM, NT>(Ks + BN * LD, static_cast<const bf16*>(p.o) +
                                                bb * p.o_sb + hh * p.o_sh +
                                                q0 * p.o_ss, p.o_ss, rows);
  cp_async_commit();
  if (k_lo < k_hi) {
    const int kv_rows = min(BN, p.t - k_lo);
    load_tile_async<D, BN, NT>(Ks, kg + k_lo * p.k_ss, p.k_ss, kv_rows);
    load_tile_async<DV, BN, NT>(Vs, vg + k_lo * p.v_ss, p.v_ss, kv_rows);
  }
  cp_async_commit();
  cp_async_wait<1>();   // Q, dO and O have landed
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int c = lane & 3;
  const long long row_base = (static_cast<long long>(bb) * p.h + hh) * p.s;

  // Delta = rowsum(dO * O) in fp32 for the warp's 16 rows (the Pallas
  // kernel's fused _init, flash_attention.py:409-418): lanes 2r and 2r + 1
  // take the two halves of row r's 16-byte chunks; zero-filled rows past S
  // give 0. Each lane then takes its rows g and g + 8 from lanes 2g, 2g + 16.
  float part = 0.f;
  {
    const int r = warp * 16 + (lane >> 1);
    const bf16* dor = dOs + r * LDV;
    const bf16* orow = Ks + BN * LD + r * LDV;
#pragma unroll
    for (int col = (lane & 1) * 8; col < DV; col += 16) {
      float a[8], b[8];
      load8(dor + col, a);
      load8(orow + col, b);
#pragma unroll
      for (int i = 0; i < 8; ++i) part = fmaf(a[i], b[i], part);
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if (!(lane & 1) && q0 + r < p.s) p.delta[row_base + q0 + r] = part;
  }
  const float dl[2] = {__shfl_sync(0xffffffffu, part, 2 * g),
                       __shfl_sync(0xffffffffu, part, 2 * g + 16)};
  float lse2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = q0 + warp * 16 + g + 8 * r;
    lse2[r] = qpos < p.s ? p.lse[row_base + qpos] * LOG2E : 0.f;
  }
  __syncthreads();      // every warp is done with O before K takes its buffer

  const float sl2 = p.scale * LOG2E;
  const bool rows_live = q0 + warp * 16 < p.s;
  float dq[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[nd][e] = 0.f;

  int buf = 0;
  for (int kt = k_lo; kt < k_hi; kt += BN, buf ^= 1) {
    if (kt + BN < k_hi) {   // the next tile into the other buffer
      const int kv_rows = min(BN, p.t - kt - BN);
      load_tile_async<D, BN, NT>(Ks + (buf ^ 1) * BN * LD,
                                 kg + (kt + BN) * p.k_ss, p.k_ss, kv_rows);
      load_tile_async<DV, BN, NT>(Vs + (buf ^ 1) * BN * LDV,
                                  vg + (kt + BN) * p.v_ss, p.v_ss, kv_rows);
    }
    cp_async_commit();
    cp_async_wait<1>();   // this tile has landed
    __syncthreads();
    // a warp whose 16 rows all lie past S skips the tile; a tile past T
    // takes the ragged step
    if (rows_live) {
      const bf16* Kb = Ks + buf * BN * LD;
      const bf16* Vb = Vs + buf * BN * LDV;
      if (kt + BN <= p.t)
        dq_tile<D, DV, false>(p, Qs, dOs, Kb, Vb, q0, kt, sl2, lse2, dl,
                              dq);
      else
        dq_tile<D, DV, true>(p, Qs, dOs, Kb, Vb, q0, kt, sl2, lse2, dl, dq);
    }
    __syncthreads();   // every warp is done with this buffer
  }
  cp_async_wait<0>();

  // dq * scale in bf16, staged in the warp's own Q rows (no other warp
  // reads them, and this warp's last reads of them are done) and written
  // 16 bytes at a time
  bf16* Qw = Qs + warp * 16 * LD;
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    *reinterpret_cast<uint32_t*>(Qw + g * LD + nd * 8 + 2 * c) =
        pack_bf16(dq[nd][0] * p.scale, dq[nd][1] * p.scale);
    *reinterpret_cast<uint32_t*>(Qw + (g + 8) * LD + nd * 8 + 2 * c) =
        pack_bf16(dq[nd][2] * p.scale, dq[nd][3] * p.scale);
  }
  __syncwarp();
  bf16* dqg = static_cast<bf16*>(p.dq) + bb * p.dq_sb + hh * p.dq_sh;
#pragma unroll
  for (int i = lane; i < 16 * ND; i += 32) {
    const int r = i / ND;
    const int col = (i % ND) * 8;
    const int qpos = q0 + warp * 16 + r;
    if (qpos < p.s)
      *reinterpret_cast<uint4*>(dqg + qpos * p.dq_ss + col) =
          *reinterpret_cast<const uint4*>(Qw + r * LD + col);
  }
}

// The bf16 K3 route: query rows per streamed tile. At D 128 the dK and dV
// accumulators take 128 registers a lane, so the S^T and dP^T tiles are
// kept to 32 queries there; at D 256 too, where a CTA owns 128 columns of
// each (dkv_cols).
template <int D>
__host__ __device__ constexpr int dkv_bq() { return D >= 128 ? 32 : 64; }

template <int D, int DV>
constexpr int dkv_tc_smem_bytes() {  // K, V; two Q, two dO; two lse, Delta
  return (BN + 2 * dkv_bq<D>()) * (D + DV + 16) *
             static_cast<int>(sizeof(bf16)) +
         4 * dkv_bq<D>() * static_cast<int>(sizeof(float));
}

// One warp's step over one streamed q tile of the bf16 K3 (at qt, rows of
// Q, dO and their lse and Delta in Qb, dOb, lb, db): S^T over the whole D
// and dP^T over the whole Dv (V and dO rows of DV + 8), P^T, dS^T for its
// 16 keys, then dV += P^T dO for the CTA's dV columns colv0 .. +
// Dv / dkv_col_tiles<D>() and dK += dS^T Q for its dK columns col0 .. +
// dkv_cols<D>(). With RAGGED (the tile runs past S) query blocks past S
// skip their products; their probabilities are masked to 0, so the result
// is the same.
template <int D, int DV, bool RAGGED>
__device__ __forceinline__ void dkv_tile(
    const Params& p, const bf16* Ks, const bf16* Vs, const bf16* Qb,
    const bf16* dOb, const float* lb, const float* db, int k0, int qt,
    int col0, int colv0, float sl2, float (&dk)[dkv_cols<D>() / 8][4],
    float (&dv)[DV / dkv_col_tiles<D>() / 8][4]) {
  constexpr int LD = D + 8;
  constexpr int LDV = DV + 8;
  constexpr int BQ = dkv_bq<D>();
  constexpr int NQ = BQ / 8;
  constexpr int NDK = dkv_cols<D>() / 8;
  constexpr int NDV = DV / dkv_col_tiles<D>() / 8;
  constexpr int NDM = NDK > NDV ? NDK : NDV;
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
    // the depth runs over D for S^T and over the first Dv for dP^T
    uint32_t ak[4], av[4];
    load_a(ak, Ks, LD, warp * 16, kk, lane);
    if (kk < DV) load_a(av, Vs, LDV, warp * 16, kk, lane);
#pragma unroll
    for (int nq = 0; nq < NQ; nq += 2) {
      if (RAGGED && nq * 8 >= q_live) break;
      uint32_t b[4];
      load_b_nmajor(b, Qb, LD, nq * 8, kk, lane);
      mma_bf16(st[nq], ak, b[0], b[1]);
      mma_bf16(st[nq + 1], ak, b[2], b[3]);
      if (kk < DV) {
        load_b_nmajor(b, dOb, LDV, nq * 8, kk, lane);
        mma_bf16(dp[nq], av, b[0], b[1]);
        mma_bf16(dp[nq + 1], av, b[2], b[3]);
      }
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
    for (int nd = 0; nd < NDM; nd += 2) {
      uint32_t b[4];
      if (nd < NDV) {
        load_b_kmajor(b, dOb, LDV, colv0 + nd * 8, kb * 16, lane);
        mma_bf16(dv[nd], ap, b[0], b[1]);
        mma_bf16(dv[nd + 1], ap, b[2], b[3]);
      }
      if (nd < NDK) {
        load_b_kmajor(b, Qb, LD, col0 + nd * 8, kb * 16, lane);
        mma_bf16(dk[nd], as, b[0], b[1]);
        mma_bf16(dk[nd + 1], as, b[2], b[3]);
      }
    }
  }
}

// K3 on the tensor cores (bf16): one CTA per (64-key tile, kv head, group
// slice and column block, batch); slice `slice` of `gs` takes query heads
// kvh*g + slice*g/gs .. + g/gs - 1 of the group, and column block `cb` the
// columns cb*DC .. + DC - 1 of dK (DC = dkv_cols<D>(): all of D, or half at
// D 256) and the same share of dV's (DCV = Dv / dkv_col_tiles<D>()). Each
// warp owns 16 keys.
// K and V stay in shared memory; (q tile, head) steps stream Q, dO, lse
// and Delta through two buffers with cp.async. Per step, on mma.sync:
//   S^T = K Q^T, P^T = exp(S^T scale - lse), dP^T = V dO^T,
//   dV += P^T dO, dS^T = P^T (dP^T - Delta), dK += dS^T Q,
// with P^T and dS^T rounded to bf16 in registers as A operands (the
// FlashAttention-2 backward), the accumulators in fp32 registers. With
// gs == 1 (part == nullptr) dK (times scale) and dV are written in k's
// and v's dtype; otherwise as fp32 partials to part (gs, 2, B, KH, T, D),
// dV's in the first Dv columns of its rows, which dkv_reduce_kernel sums.
// At D 64 the registers are capped at 168 a lane, so that three CTAs share
// an SM (D 32 and 48 fit three uncapped; at D 80, 2 x 80 accumulator
// registers a lane, a lane may take 255).
template <int D, int DV>
__global__ void __launch_bounds__(NT, D == 64 ? 3 : 1)
    flash_bwd_dkv_tc_kernel(const Params p, int gs, float* part) {
  constexpr int LD = D + 8;
  constexpr int LDV = DV + 8;   // V and dO rows
  constexpr int BQ = dkv_bq<D>();
  constexpr int CT = dkv_col_tiles<D>();
  constexpr int DC = dkv_cols<D>();
  constexpr int DCV = DV / CT;
  constexpr int NDK = DC / 8;   // 8-column blocks of dK in the CTA
  constexpr int NDV = DCV / 8;  // and of dV
  constexpr int NDM = NDK > NDV ? NDK : NDV;
  static_assert(DV <= D, "K3's partials hold dV in rows of D");
  extern __shared__ uint4 smem_u4[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_u4);
  bf16* Vs = Ks + BN * LD;
  bf16* Qs = Vs + BN * LDV;          // two buffers
  bf16* dOs = Qs + 2 * BQ * LD;      // two buffers of BQ x LDV
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * BQ * LDV);  // two
  float* dl_s = lse_s + 2 * BQ;                                 // two

  // CTAs start in linear order: key tiles in order of k0 across every
  // (slice, kv head, batch), so the low causal key tiles, which see the
  // most q tiles, go first
  const int per = gridDim.y * gridDim.z;
  const int lin = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y *
                                                             blockIdx.z);
  const int k0 = (lin / per) * BN;
  const int yy = (lin % per) % gridDim.y / CT;
  const int col0 = (lin % per) % gridDim.y % CT * DC;
  const int colv0 = (lin % per) % gridDim.y % CT * DCV;
  const int kvh = yy / gs;
  const int slice = yy % gs;
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
    load_tile_async<DV, BQ, NT>(dOs + buf * BQ * LDV,
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
  load_tile_async<DV, BN, NT>(Vs, static_cast<const bf16*>(p.v) +
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

  float dk[NDK][4], dv[NDV][4];
#pragma unroll
  for (int nd = 0; nd < NDM; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (nd < NDK) dk[nd][e] = 0.f;
      if (nd < NDV) dv[nd][e] = 0.f;
    }

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
      const bf16* dOb = dOs + buf * BQ * LDV;
      const float* lb = lse_s + buf * BQ;
      const float* db = dl_s + buf * BQ;
      if (qt + BQ <= p.s)
        dkv_tile<D, DV, false>(p, Ks, Vs, Qb, dOb, lb, db, k0, qt, col0,
                               colv0, sl2, dk, dv);
      else
        dkv_tile<D, DV, true>(p, Ks, Vs, Qb, dOb, lb, db, k0, qt, col0,
                              colv0, sl2, dk, dv);
    }
    __syncthreads();   // every warp is done with this buffer
  }
  cp_async_wait<0>();
  __syncthreads();     // K and V have landed, also where no step ran

  if (part == nullptr) {
    // dK, dV in bf16, staged in the first DC (DCV) columns of the warp's
    // own K (V) rows (no other warp reads them) and written 16 bytes at a
    // time to columns col0.. (colv0..)
    bf16* Kw = Ks + warp * 16 * LD;
    bf16* Vw = Vs + warp * 16 * LDV;
#pragma unroll
    for (int nd = 0; nd < NDM; ++nd)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (nd < NDK)
          *reinterpret_cast<uint32_t*>(Kw + (g + 8 * r) * LD + nd * 8 +
                                       2 * c) =
              pack_bf16(dk[nd][2 * r] * p.scale,
                        dk[nd][2 * r + 1] * p.scale);
        if (nd < NDV)
          *reinterpret_cast<uint32_t*>(Vw + (g + 8 * r) * LDV + nd * 8 +
                                       2 * c) =
              pack_bf16(dv[nd][2 * r], dv[nd][2 * r + 1]);
      }
    __syncwarp();
    bf16* dkg = static_cast<bf16*>(p.dk) + bb * p.dk_sb + kvh * p.dk_sh;
    bf16* dvg = static_cast<bf16*>(p.dv) + bb * p.dv_sb + kvh * p.dv_sh;
#pragma unroll
    for (int i = lane; i < 16 * NDM; i += 32) {
      const int r = i / NDM;
      const int col = (i % NDM) * 8;
      const int key = k0 + warp * 16 + r;
      if (key < p.t) {
        if (col < DC)
          *reinterpret_cast<uint4*>(dkg + key * p.dk_ss + col0 + col) =
              *reinterpret_cast<const uint4*>(Kw + r * LD + col);
        if (col < DCV)
          *reinterpret_cast<uint4*>(dvg + key * p.dv_ss + colv0 + col) =
              *reinterpret_cast<const uint4*>(Vw + r * LDV + col);
      }
    }
  } else {
    // fp32 partials of this slice: part[slice][0 = dK, 1 = dV][b][kvh],
    // rows of D (dV's in their first Dv columns)
    const long long n = static_cast<long long>(p.b) * p.kh * p.t * D;
    const long long base =
        2 * slice * n + ((static_cast<long long>(bb) * p.kh + kvh) * p.t) * D;
#pragma unroll
    for (int nd = 0; nd < NDM; ++nd)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = key0 + 8 * r;
        if (key < p.t) {
          const long long at = base + static_cast<long long>(key) * D +
                               nd * 8 + 2 * c;
          if (nd < NDK)
            *reinterpret_cast<float2*>(part + at + col0) = make_float2(
                dk[nd][2 * r] * p.scale, dk[nd][2 * r + 1] * p.scale);
          if (nd < NDV)
            *reinterpret_cast<float2*>(part + n + at + colv0) =
                make_float2(dv[nd][2 * r], dv[nd][2 * r + 1]);
        }
      }
  }
}

// The second launch of K3 where gs > 1: dK and dV as the sums of the gs
// slices' fp32 partials, slice 0 first (a fixed order, so the result is
// the same from run to run), cast to k's and v's dtype and layout. One
// thread per 4 elements of the (2, B, KH, T, D) pair; dV's rows hold Dv
// columns (dv, a multiple of 4), and the rest of each is skipped.
__global__ void __launch_bounds__(256)
    dkv_reduce_kernel(const Params p, int gs, int d, int dv,
                      const float* part) {
  const long long n = static_cast<long long>(p.b) * p.kh * p.t * d;
  const long long e =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  if (e >= 2 * n) return;
  const int which = e >= n;          // 0 = dK, 1 = dV
  const long long i = e - which * n;
  if (which && i % d >= dv) return;
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

template <int D, int DV>
cudaError_t launch_dq(const Params& p, cudaStream_t stream) {
  constexpr int smem = dq_smem_bytes<D, DV>();   // above 48 KB for D >= 64
  static_assert(smem <= 232448, "K2 fp32: tiles over a CTA's 227 KB");
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<float, D, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.s + BM - 1) / BM, p.h, p.b);
  flash_bwd_dq_kernel<float, D, DV><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D, int DV>
cudaError_t launch_dq_tc(const Params& p, cudaStream_t stream) {
  // Q, dO, two K and two V buffers, bf16
  constexpr int smem = ((BM + 2 * BN) * (D + 8) + (BM + 2 * BN) * (DV + 8)) *
                       static_cast<int>(sizeof(bf16));
  static_assert(smem <= 232448, "K2 bf16: tiles over a CTA's 227 KB");
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_tc_kernel<D, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.s + BM - 1) / BM, p.h, p.b);
  flash_bwd_dq_tc_kernel<D, DV><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D, int DV>
cudaError_t launch_dkv(const Params& p, cudaStream_t stream) {
  constexpr int smem = dkv_smem_bytes<D, DV>();
  static_assert(smem <= 232448, "K3 fp32: tiles over a CTA's 227 KB");
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<float, D, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.t + BN - 1) / BN, p.kh * dkv_col_tiles<D>(), p.b);
  flash_bwd_dkv_kernel<float, D, DV><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D, int DV>
cudaError_t launch_dkv_tc(const Params& p, int gs, float* part,
                          cudaStream_t stream) {
  if (gs < 1 || (p.h / p.kh) % gs || (gs > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  constexpr int smem = dkv_tc_smem_bytes<D, DV>();
  static_assert(smem <= 232448, "K3 bf16: tiles over a CTA's 227 KB");
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_tc_kernel<D, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.t + BN - 1) / BN, p.kh * gs * dkv_col_tiles<D>(), p.b);
  float* partials = gs > 1 ? part : nullptr;
  flash_bwd_dkv_tc_kernel<D, DV><<<grid, NT, smem, stream>>>(p, gs,
                                                             partials);
  err = cudaGetLastError();
  if (err != cudaSuccess || gs == 1) return err;
  const long long quads = static_cast<long long>(p.b) * p.kh * p.t * D / 2;
  const unsigned blocks = static_cast<unsigned>((quads + 255) / 256);
  dkv_reduce_kernel<<<blocks, 256, 0, stream>>>(p, gs, D, DV, part);
  return cudaGetLastError();
}

// K2 by dtype (0: fp32 on the CUDA cores, 1: bf16 on the tensor cores)
// and (d, dv) pair; any other is refused
cudaError_t dispatch_dq(int dtype, int d, int dv, const Params& p,
                        cudaStream_t st) {
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
#define K2_CASE(D_, DV_)                                             \
  if (d == D_ && dv == DV_)                                          \
    return dtype == 0 ? launch_dq<D_, DV_>(p, st)                    \
                      : launch_dq_tc<D_, DV_>(p, st);
  FLASH_HEAD_DIM_PAIRS(K2_CASE)
#undef K2_CASE
  return cudaErrorInvalidValue;
}

// K3 likewise: fp32 on the CUDA cores (no group split), bf16 on the
// tensor cores
cudaError_t dispatch_dkv(int dtype, int d, int dv, const Params& p, int gs,
                         float* part, cudaStream_t st) {
  if (!(dtype == 0 && gs == 1) && dtype != 1) return cudaErrorInvalidValue;
#define K3_CASE(D_, DV_)                                             \
  if (d == D_ && dv == DV_)                                          \
    return dtype == 0 ? launch_dkv<D_, DV_>(p, st)                   \
                      : launch_dkv_tc<D_, DV_>(p, gs, part, st);
  FLASH_HEAD_DIM_PAIRS(K3_CASE)
#undef K3_CASE
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

// dtype: 0 = float32, 1 = bfloat16; d and dv the head dims of q/k and of
// v (a pair of FLASH_HEAD_DIM_PAIRS). `strides` holds the (batch, head,
// row) element strides of q, k, v, dO and then the outputs (K2: o, dq;
// K3: dk, dv), 18 values; the last dimension of every tensor is
// contiguous. lse and delta are contiguous fp32 (B,H,S). K3 splits each
// GQA group over `gs` CTAs (a divisor of H/KH; 1 for float32); with
// gs > 1, `scratch` holds 2 * gs * B * KH * T * d fp32 partials. Each
// returns a cudaError_t (0 = ok).
int repro_flash_bwd_dq(int dtype, int d, int dv, const void* q,
                       const void* k, const void* v, const void* o,
                       const void* d_o, const void* lse, void* dq,
                       void* delta, int b, int h, int kh, int s, int t,
                       const long long* strides, int causal, int window,
                       float scale, void* stream) {
  Params p = {};
  set_common(p, q, k, v, d_o, lse, b, h, kh, s, t, strides, causal, window,
             scale);
  p.o = o; p.dq = dq; p.delta = static_cast<float*>(delta);
  p.o_sb = strides[12]; p.o_sh = strides[13]; p.o_ss = strides[14];
  p.dq_sb = strides[15]; p.dq_sh = strides[16]; p.dq_ss = strides[17];
  return static_cast<int>(
      dispatch_dq(dtype, d, dv, p, static_cast<cudaStream_t>(stream)));
}

int repro_flash_bwd_dkv(int dtype, int d, int dv, const void* q,
                        const void* k, const void* v, const void* d_o,
                        const void* lse, const void* delta, void* grad_k,
                        void* grad_v, int b, int h, int kh, int s, int t,
                        const long long* strides, int causal, int window,
                        float scale, int gs, void* scratch, void* stream) {
  Params p = {};
  set_common(p, q, k, v, d_o, lse, b, h, kh, s, t, strides, causal, window,
             scale);
  p.delta = const_cast<float*>(static_cast<const float*>(delta));
  p.dk = grad_k; p.dv = grad_v;
  p.dk_sb = strides[12]; p.dk_sh = strides[13]; p.dk_ss = strides[14];
  p.dv_sb = strides[15]; p.dv_sh = strides[16]; p.dv_ss = strides[17];
  return static_cast<int>(dispatch_dkv(dtype, d, dv, p, gs,
                                       static_cast<float*>(scratch),
                                       static_cast<cudaStream_t>(stream)));
}

// Keys per K3 CTA (BN): the host sizes K3's group split from it.
int repro_flash_key_tile() { return BN; }

// K3's CTAs per (key tile, kv head, group slice) at head dims (d, dv):
// each owns d / this many columns of dK and dv / this many of dV (0 for a
// pair no kernel takes).
int repro_flash_dkv_col_tiles(int d, int dv) {
#define COL_TILES_CASE(D_, DV_) \
  if (d == D_ && dv == DV_) return dkv_col_tiles<D_>();
  FLASH_HEAD_DIM_PAIRS(COL_TILES_CASE)
#undef COL_TILES_CASE
  return 0;
}

// Query rows per K2 CTA (BM): K2's grid is ceil(S / BM) x H x B.
int repro_flash_query_tile() { return BM; }

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
