// K1: flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces src/repro/kernels/flash_attention.py:_fwd_kernel, the Pallas TPU
// kernel that _forward launches. For q (B,H,S,D), k (B,KH,T,D) and v
// (B,KH,T,Dv), with GQA (kv_head = h / (H/KH)), it computes
// O = softmax(mask(Q K^T D^-0.5)) V (B,H,S,Dv) in q's dtype and the fp32
// row logsumexp lse (B,H,S), under the causal
// mask, a static sliding window and the ragged edges of S and T. A row with
// no live key gets O = 0 and lse = 2**30, so a backward's exp(s - lse) is 0.
//
// What bounds it on an H100 SXM: at the ViT-B/16 eval shape (B=128, H=12,
// S=T=197, D=64, bf16) the function must move q, k, v and o once (4 x 38.7
// MB) and the fp32 lse (1.2 MB), 156.1 MB or 46.6 us at 3.35 TB/s; its two
// products are 4*B*H*S*T*D = 15.3 GFLOP, 15.4 us at the 989 TFLOP/s bf16
// tensor-core peak: bytes bound it, by a factor of three. At the ChatGLM3
// shape (B=4, H=32, KH=2, S=T=1024, D=128, causal) the causal products are
// 34.4 GFLOP, 34.8 us, against 71.8 MB (21.4 us): operations bound it. At
// Gemma3-12B's (B=1, H=16, KH=8, S=T=4096, D=256, causal) a local layer's
// window of 1024 leaves 58.7 M live pairs, 60.1 GFLOP (60.8 us) against
// 100.9 MB (30.1 us); the global layer's triangle is 137.5 GFLOP (139 us):
// operations bound both. At DeepSeek-V3's MLA (B=2, H=KH=128, S=T=1024,
// D=192, Dv=128, causal) the products are 2 x 134.3 M live pairs x
// (192 + 128) = 86.0 GFLOP (86.9 us) against 336.6 MB (100.5 us): bytes
// bound it, narrowly.
//
// The value head dim is a second template parameter, DV: the (D, Dv) pairs
// of FLASH_HEAD_DIM_PAIRS (flash_common.cuh), D = Dv or (192, 128). S = Q
// K^T runs over D, O += P V over Dv; V's tiles are Dv wide, so nothing is
// padded.
//
// Two routes, by dtype (the `dtype` code of repro_flash_fwd):
//
// bf16, flash_fwd_tc_kernel (the main path): the FlashAttention-2 loop on
// the tensor cores. One CTA of 4 warps per (64-row q tile, head, batch);
// each warp owns 16 query rows. The Q tile stays in shared memory; 64-key
// K and V tiles stream through two shared-memory buffers with cp.async
// (16-byte copies, rows past T zero-filled), the next tile in flight while
// the current one is used. S = Q K^T and O += P V run on mma.sync m16n8k16
// (bf16 in, fp32 accumulators) fed by ldmatrix from rows padded to D + 8
// elements; S, the online-softmax max and sum, and O stay in registers,
// reduced across the 4 lanes of a quad. P is rounded to bf16 in registers
// to become the A operand of P V, as ref_attention and the model's naive
// sdpa round it. Only tiles that hold a masked pair pay for the mask
// (flash_attention.py:117 _block_needs_mask), and the ragged tails skip
// what they can: a warp whose rows lie past S, and key blocks past T.
// CTAs launch q tile by q tile across every head; causal q tiles in
// reverse, so the tiles that see the most keys start first. O is staged
// through the warp's own Q rows and written with 16-byte stores. Where
// D <= 64 the registers are capped so that four CTAs share an SM, at the
// cost of a few spilled bytes (three at D 80: HuBERT's and Zamba2's heads
// take the same loops with ten 8-column blocks of O, five 16-deep steps
// of S). D 256 runs the same loop: its Q tile and
// two K and V buffers take 169 KB, one CTA an SM, and its O accumulator
// 128 fp32 registers a lane of the 255 it may use. With 64 x 64 tiles and
// one 16-row block per warp, the ldmatrix traffic and the latency of short
// loops (4 key tiles at S = 197) hold it well above its bound; wgmma, TMA,
// larger tiles and warp specialisation are later work.
//
// fp32, flash_fwd_kernel: scalar fp32 FMAs on the CUDA cores, as the TPU
// kernel's fp32 upcast does; the tensor cores' TF32 would round the inputs
// to 10 mantissa bits and miss the 1e-4 gate. Thread t owns query rows
// 4*(t/8) .. +3 of the tile; for the scores it owns keys (t%8) + 8j of
// each key tile (64 keys; 32 at D 256, where the fp32 tiles would not fit
// otherwise: 139 KB then), and for O the float4 column groups
// (t%8) + 8jj (f4_owns: at Dv 80 threads t%8 < 4 own three groups, the
// others two); row max and sum reduce with three xor shuffles. Tiles are
// staged as fp32, Q and K rows padded by 4 floats against bank conflicts.
//
// Element strides are passed in, so the caller can hand in the model's
// (B,S,H,D) layout as a (B,H,S,D) view without a transposing copy.

#include "flash_common.cuh"

namespace {

constexpr int NT = 128;   // threads per CTA

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int b, h, kh, s, t;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int causal, window;
  float scale;
};

template <int D, int DV>
constexpr int smem_bytes() {   // Q, K, V, P; K and V f32_tile<D>() rows
  constexpr int KB = f32_tile<D>();
  return (BM * (D + 4) + KB * (D + 4) + KB * DV + BM * (KB + 4)) *
         static_cast<int>(sizeof(float));
}


// The fp32 route: scalar FMAs on the CUDA cores, tiles staged as fp32;
// key tiles of KB = f32_tile<D>() rows (32 at D 256).
template <typename T, int D, int DV>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(const Params p) {
  constexpr int KB = f32_tile<D>();
  constexpr int NJ = KB / 8;   // keys per thread in a score tile
  constexpr int LDQ = D + 4;   // padded Q/K row stride (floats)
  constexpr int LDP = KB + 4;  // padded P row stride
  constexpr int NG = f4_groups<DV>();  // float4 column groups of O a thread
  extern __shared__ float4 smem_f4[];
  float* Qs = reinterpret_cast<float*>(smem_f4);
  float* Ks = Qs + BM * LDQ;
  float* Vs = Ks + KB * LDQ;
  float* Ps = Vs + KB * DV;

  const int q0 = blockIdx.x * BM;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int kvh = hh / (p.h / p.kh);
  const T* qg = static_cast<const T*>(p.q) + bb * p.q_sb + hh * p.q_sh +
                q0 * p.q_ss;
  const T* kg = static_cast<const T*>(p.k) + bb * p.k_sb + kvh * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + bb * p.v_sb + kvh * p.v_sh;

  load_tile<T, D, NT>(Qs, LDQ, qg, p.q_ss, min(BM, p.s - q0));

  const int tid = threadIdx.x;
  const int r0 = (tid >> 3) * 4;
  const int cg = tid & 7;

  float m[4], l[4], acc[4][4 * NG];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NG; ++c) acc[i][c] = 0.f;
  }

  // the key tiles this q tile can see: keys k <= q for causal, and
  // q - k < window, with q in [q0, q0 + BM)
  int k_lo = 0, k_hi = p.t;
  if (p.causal) k_hi = min(k_hi, q0 + BM);
  if (p.window > 0) k_lo = max(0, q0 - p.window + 1);
  k_lo -= k_lo % KB;

  for (int kt = k_lo; kt < k_hi; kt += KB) {
    __syncthreads();   // every thread is done with the previous tile
    const int kv_rows = min(KB, p.t - kt);
    load_tile<T, D, NT, KB>(Ks, LDQ, kg + kt * p.k_ss, p.k_ss, kv_rows);
    load_tile<T, DV, NT, KB>(Vs, DV, vg + kt * p.v_ss, p.v_ss, kv_rows);
    __syncthreads();

    // scores of rows r0+i against keys kt + cg + 8j
    float sc[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D; kk += 4) {
      float4 qa[4], kb[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(Qs + (r0 + i) * LDQ + kk);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        kb[j] = *reinterpret_cast<const float4*>(Ks + (cg + 8 * j) * LDQ + kk);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          sc[i][j] = fmaf(qa[i].x, kb[j].x, sc[i][j]);
          sc[i][j] = fmaf(qa[i].y, kb[j].y, sc[i][j]);
          sc[i][j] = fmaf(qa[i].z, kb[j].z, sc[i][j]);
          sc[i][j] = fmaf(qa[i].w, kb[j].w, sc[i][j]);
        }
    }

    // mask, online softmax, and P to shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + r0 + i;
      unsigned live = 0u;
      float mt = NEG_INF;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int kpos = kt + cg + 8 * j;
        const bool ok = qpos < p.s && kpos < p.t &&
                        (!p.causal || kpos <= qpos) &&
                        (p.window <= 0 || qpos - kpos < p.window);
        live |= static_cast<unsigned>(ok) << j;
        sc[i][j] = ok ? sc[i][j] * p.scale : NEG_INF;
        mt = fmaxf(mt, sc[i][j]);
      }
      mt = row_max8(mt);
      const float m_new = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float pij = ((live >> j) & 1u) ? expf(sc[i][j] - m_new) : 0.f;
        Ps[(r0 + i) * LDP + cg + 8 * j] = pij;
        rs += pij;
      }
      rs = row_sum8(rs);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * NG; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // O += P V: rows r0+i, the float4 column groups cg + 8jj it owns
#pragma unroll 2
    for (int n = 0; n < KB; n += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(Ps + (r0 + i) * LDP + n);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vrow = Vs + (n + u) * DV;
#pragma unroll
        for (int jj = 0; jj < NG; ++jj) {
          if (!f4_owns<DV>(cg, jj)) continue;
          const float4 vb =
              *reinterpret_cast<const float4*>(vrow + 4 * (cg + 8 * jj));
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pv = lane_of(pa[i], u);
            acc[i][4 * jj + 0] = fmaf(pv, vb.x, acc[i][4 * jj + 0]);
            acc[i][4 * jj + 1] = fmaf(pv, vb.y, acc[i][4 * jj + 1]);
            acc[i][4 * jj + 2] = fmaf(pv, vb.z, acc[i][4 * jj + 2]);
            acc[i][4 * jj + 3] = fmaf(pv, vb.w, acc[i][4 * jj + 3]);
          }
        }
      }
    }
  }

  // O = acc / max(l, 1e-30) in the output dtype; lse = m + log l, or
  // LSE_BIG for a row whose max never left NEG_INF (flash_attention.py:290)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + r0 + i;
    if (qpos < p.s) {
      const float lsafe = fmaxf(l[i], 1e-30f);
      T* orow = static_cast<T*>(p.o) + bb * p.o_sb + hh * p.o_sh +
                qpos * p.o_ss;
#pragma unroll
      for (int jj = 0; jj < NG; ++jj)
        if (f4_owns<DV>(cg, jj))
          store4(orow + 4 * (cg + 8 * jj),
                 make_float4(acc[i][4 * jj + 0] / lsafe,
                             acc[i][4 * jj + 1] / lsafe,
                             acc[i][4 * jj + 2] / lsafe,
                             acc[i][4 * jj + 3] / lsafe));
      if (cg == 0)
        p.lse[(static_cast<long long>(bb) * p.h + hh) * p.s + qpos] =
            m[i] > 0.5f * NEG_INF ? m[i] + logf(lsafe) : LSE_BIG;
    }
  }
}

// One warp's step over one key tile of the bf16 forward: S = Q K^T for
// its 16 rows (over D), the online softmax, O += P V (over Dv; V rows of
// DV + 8 elements in Vb). With RAGGED (the tile runs past T) key blocks
// past T skip their products; their probabilities are masked to 0, so the
// result is the same.
template <int D, int DV, bool RAGGED>
__device__ __forceinline__ void fwd_tile(const Params& p, const bf16* Qs,
                                         const bf16* Kb, const bf16* Vb,
                                         int q0, int kt, float sl2,
                                         float (&o)[DV / 8][4], float (&m)[2],
                                         float (&l)[2]) {
  constexpr int LD = D + 8;
  constexpr int LDV = DV + 8;
  constexpr int NB = BN / 8;
  constexpr int ND = DV / 8;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = lane & 3;
  const int row0 = warp * 16 + (lane >> 2);
  const int keys_live = p.t - kt;

  // S = Q K^T: the warp's 16 rows against the tile's 64 keys
  float s[NB][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    uint32_t a[4];
    load_a(a, Qs, LD, warp * 16, kk, lane);
#pragma unroll
    for (int nb = 0; nb < NB; nb += 2) {
      if (RAGGED && nb * 8 >= keys_live) break;
      uint32_t b[4];
      load_b_nmajor(b, Kb, LD, nb * 8, kk, lane);
      mma_bf16(s[nb], a, b[0], b[1]);
      mma_bf16(s[nb + 1], a, b[2], b[3]);
    }
  }

  // mask (only where the tile holds a masked pair), online softmax
  // on the unscaled scores: p = 2^(s sl2 - m sl2), one FMA each
  const bool masked = tile_needs_mask(p, q0, BM, kt, BN);
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (masked && !live(p, q0 + row0 + (e >> 1) * 8,
                          kt + nb * 8 + 2 * c + (e & 1)))
        s[nb][e] = NEG_INF;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[nb][e]);
    }
  float msl[2];   // the new max times sl2
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float alpha = exp2f((m[r] - mx[r]) * sl2);
    m[r] = mx[r];
    msl[r] = mx[r] * sl2;
    l[r] *= alpha;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      o[nd][2 * r] *= alpha;
      o[nd][2 * r + 1] *= alpha;
    }
  }
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // a masked pair is exactly 0, also in a row with no live key yet
      const float pv = s[nb][e] == NEG_INF
                           ? 0.f
                           : exp2f(fmaf(s[nb][e], sl2, -msl[e >> 1]));
      s[nb][e] = pv;
      l[e >> 1] += pv;
    }

  // O += P V, P rounded to bf16 in registers as the A operand
#pragma unroll
  for (int kb = 0; kb < BN / 16; ++kb) {
    if (RAGGED && kb * 16 >= keys_live) break;
    uint32_t a[4];
    a[0] = pack_bf16(s[2 * kb][0], s[2 * kb][1]);
    a[1] = pack_bf16(s[2 * kb][2], s[2 * kb][3]);
    a[2] = pack_bf16(s[2 * kb + 1][0], s[2 * kb + 1][1]);
    a[3] = pack_bf16(s[2 * kb + 1][2], s[2 * kb + 1][3]);
#pragma unroll
    for (int nd = 0; nd < ND; nd += 2) {
      uint32_t b[4];
      load_b_kmajor(b, Vb, LDV, nd * 8, kb * 16, lane);
      mma_bf16(o[nd], a, b[0], b[1]);
      mma_bf16(o[nd + 1], a, b[2], b[3]);
    }
  }
}

// The bf16 route: see the note at the top. Where D <= 64 the registers
// are capped at 128 a lane, so that four CTAs share an SM; at D 80 at 168,
// three CTAs (its 40 O registers a lane would spill under 128); at D 128,
// 192 and 256 a lane may take 255 (the O accumulator alone is 128 fp32
// registers a lane at D 256, where shared memory holds one CTA an SM
// anyway; 64 at (192, 128)).
template <int D, int DV>
__global__ void __launch_bounds__(NT, D >= 128 ? 1 : D > 64 ? 3 : 4)
    flash_fwd_tc_kernel(const Params p) {
  constexpr int LD = D + 8;     // padded Q and K row stride (elements)
  constexpr int LDV = DV + 8;   // padded V row stride
  constexpr int ND = DV / 8;    // 8-column blocks of O
  static_assert(DV <= D, "K1 bf16 stages O in the warp's Q rows");
  extern __shared__ uint4 smem_u4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_u4);
  bf16* Ks = Qs + BM * LD;          // two buffers
  bf16* Vs = Ks + 2 * BN * LD;      // two buffers of BN x LDV

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
  const bf16* qg = static_cast<const bf16*>(p.q) + bb * p.q_sb +
                   hh * p.q_sh + q0 * p.q_ss;
  const bf16* kg = static_cast<const bf16*>(p.k) + bb * p.k_sb +
                   kvh * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + bb * p.v_sb +
                   kvh * p.v_sh;

  // the key tiles this q tile can see: keys k <= q for causal, and
  // q - k < window, with q in [q0, q0 + BM)
  int k_lo = 0, k_hi = p.t;
  if (p.causal) k_hi = min(k_hi, q0 + BM);
  if (p.window > 0) k_lo = max(0, q0 - p.window + 1);
  k_lo -= k_lo % BN;

  load_tile_async<D, BM, NT>(Qs, qg, p.q_ss, min(BM, p.s - q0));
  if (k_lo < k_hi) {
    const int rows = min(BN, p.t - k_lo);
    load_tile_async<D, BN, NT>(Ks, kg + k_lo * p.k_ss, p.k_ss, rows);
    load_tile_async<DV, BN, NT>(Vs, vg + k_lo * p.v_ss, p.v_ss, rows);
  }
  cp_async_commit();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = lane & 3;
  const int row0 = warp * 16 + (lane >> 2);   // rows row0 and row0 + 8
  const float sl2 = p.scale * LOG2E;          // scores to log2 units
  const bool rows_live = q0 + warp * 16 < p.s;

  float o[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};   // running max of the raw scores
  float l[2] = {0.f, 0.f};           // this lane's part of the row sum

  int buf = 0;
  for (int kt = k_lo; kt < k_hi; kt += BN, buf ^= 1) {
    if (kt + BN < k_hi) {   // the next tile into the other buffer
      const int rows = min(BN, p.t - kt - BN);
      load_tile_async<D, BN, NT>(Ks + (buf ^ 1) * BN * LD,
                                 kg + (kt + BN) * p.k_ss, p.k_ss, rows);
      load_tile_async<DV, BN, NT>(Vs + (buf ^ 1) * BN * LDV,
                                  vg + (kt + BN) * p.v_ss, p.v_ss, rows);
    }
    cp_async_commit();
    cp_async_wait<1>();   // this tile (and Q) has landed
    __syncthreads();
    // a warp whose 16 rows all lie past S skips the tile (the ragged tail
    // of S = 197); a tile past T takes the ragged step
    if (rows_live) {
      const bf16* Kb = Ks + buf * BN * LD;
      const bf16* Vb = Vs + buf * BN * LDV;
      if (kt + BN <= p.t)
        fwd_tile<D, DV, false>(p, Qs, Kb, Vb, q0, kt, sl2, o, m, l);
      else
        fwd_tile<D, DV, true>(p, Qs, Kb, Vb, q0, kt, sl2, o, m, l);
    }
    __syncthreads();   // every warp is done with this buffer
  }
  cp_async_wait<0>();
  __syncthreads();     // Q has landed, also where no key tile ran

  // O = acc / max(l, 1e-30) in bf16, staged in the warp's own Q rows (no
  // other warp reads them) and written 16 bytes at a time; lse = m + log l
  // in natural units, or LSE_BIG for a row that saw no live key
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
  bf16* Ow = Qs + warp * 16 * LD;
  const int g = lane >> 2;
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    *reinterpret_cast<uint32_t*>(Ow + g * LD + nd * 8 + 2 * c) =
        pack_bf16(o[nd][0] * inv[0], o[nd][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(Ow + (g + 8) * LD + nd * 8 + 2 * c) =
        pack_bf16(o[nd][2] * inv[1], o[nd][3] * inv[1]);
  }
  __syncwarp();
  bf16* og = static_cast<bf16*>(p.o) + bb * p.o_sb + hh * p.o_sh;
#pragma unroll
  for (int i = lane; i < 16 * ND; i += 32) {
    const int r = i / ND;
    const int col = (i % ND) * 8;
    const int qpos = q0 + warp * 16 + r;
    if (qpos < p.s)
      *reinterpret_cast<uint4*>(og + qpos * p.o_ss + col) =
          *reinterpret_cast<const uint4*>(Ow + r * LD + col);
  }
  if (c == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = q0 + row0 + 8 * r;
      if (qpos < p.s)
        p.lse[(static_cast<long long>(bb) * p.h + hh) * p.s + qpos] =
            m[r] > 0.5f * NEG_INF ? (m[r] * sl2 + log2f(l[r])) * LN2
                                  : LSE_BIG;
    }
  }
}

template <int D, int DV>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D, DV>();   // above 48 KB for D >= 64
  static_assert(smem <= 232448, "K1 fp32: tiles over a CTA's 227 KB");
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<float, D, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.s + BM - 1) / BM, p.h, p.b);
  flash_fwd_kernel<float, D, DV><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D, int DV>
cudaError_t launch_tc(const Params& p, cudaStream_t stream) {
  // Q, two K and two V buffers, bf16
  constexpr int smem = ((BM + 2 * BN) * (D + 8) + 2 * BN * (DV + 8)) *
                       static_cast<int>(sizeof(bf16));
  static_assert(smem <= 232448, "K1 bf16: tiles over a CTA's 227 KB");
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<D, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.s + BM - 1) / BM, p.h, p.b);
  flash_fwd_tc_kernel<D, DV><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

// By dtype (0: fp32 on the CUDA cores, 1: bf16 on the tensor cores) and
// (d, dv) pair; any other is refused
cudaError_t dispatch(int dtype, int d, int dv, const Params& p,
                     cudaStream_t st) {
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
#define K1_CASE(D_, DV_)                                          \
  if (d == D_ && dv == DV_)                                       \
    return dtype == 0 ? launch_f32<D_, DV_>(p, st) : launch_tc<D_, DV_>(p, st);
  FLASH_HEAD_DIM_PAIRS(K1_CASE)
#undef K1_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; d and dv the head dims of q/k and of
// v (a pair of FLASH_HEAD_DIM_PAIRS). Strides are in elements; the last
// dimension of every tensor is contiguous. Returns a cudaError_t (0 = ok).
int repro_flash_fwd(int dtype, int d, int dv, const void* q, const void* k,
                    const void* v, void* o, void* lse, int b, int h, int kh,
                    int s, int t, long long q_sb, long long q_sh,
                    long long q_ss, long long k_sb, long long k_sh,
                    long long k_ss, long long v_sb, long long v_sh,
                    long long v_ss, long long o_sb, long long o_sh,
                    long long o_ss, int causal, int window, float scale,
                    void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.lse = static_cast<float*>(lse);
  p.b = b; p.h = h; p.kh = kh; p.s = s; p.t = t;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.causal = causal; p.window = window; p.scale = scale;
  return static_cast<int>(
      dispatch(dtype, d, dv, p, static_cast<cudaStream_t>(stream)));
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
