// K6 and K7: the chunked WKV6 recurrence (RWKV6 "Finch"), forward and
// backward, for Hopper (sm_90a), plain C interface.
//
// K6 replaces src/repro/kernels/wkv6.py:_fwd_kernel (launched by _forward,
// with and without the states residual). For r/k/v (B,S,H,P) in bf16 or
// fp32, log-decays wlog (B,S,H,P) in bf16 or fp32, the bonus u (H,P) and the
// initial state s0 (B,H,P,P) in fp32, it carries the fp32 (P,P) state S
// over the chunks of each (b, h). Per chunk, with L = cumsum(w) and
// lprev = L - w down the chunk's rows:
//   o = (r e^lprev) S + sum_{j<t} [sum_p r_tp e^(lprev_tp - L_jp) k_jp] v_j
//       + (r.u.k) v,
//   S <- e^L_end S + (k e^(L_end - L))^T v,
// and writes o (B,S,H,P) fp32, s_end (B,H,P,P) fp32 and, when asked, the
// state entering every chunk (B,H,NC,P,P) fp32, the backward's residual.
// K7 replaces _bwd_kernel (launched by _backward): from those states and
// the cotangents dO and dS_end it writes dr, dk, dv, dwlog in their
// primals' dtypes, dS0 (B,H,P,P) fp32 and du as fp32 (B,H,NC,P) partials
// that the wrapper sums over chunks, then B (no atomics, so du and dS0
// repeat bit for bit).
//
// What bounds them on an H100 SXM: at the RWKV6-7B training shape (micro-
// batch 4, S 1024, H 64, P 64, chunk 32; r/k/v bf16, wlog fp32) K6 with
// states must move r/k/v (3 x 33.6 MB), wlog and o (67.1 MB each), the
// states (134.2 MB) and s0/s_end (4.2 MB each): about 378 MB, 0.113 ms at
// 3.35 TB/s. Its products (4 cs P^2 per chunk for the state, about as much
// again for the pairwise decays) are about 6 GFLOP of fp32, 0.09 ms at
// 67 TFLOP/s: the bytes bound it, narrowly. K7 as a function moves about
// 545 MB (the states and fp32 dO on top), 0.16 ms, and does 12.7 GFLOP,
// 0.19 ms: operations bound it. Its two launches below move about 984 MB
// (the G_c scratch written and read, dO read twice), 0.29 ms.
//
// K6's design: only the state carry is serial across chunks, and row p of
// S evolves alone, S[p,:] <- e^L_end,p S[p,:] + sum_j k_jp e^(L_end,p -
// L_jp) v_j, so K6 is two launches behind one call:
//   (a) wkv6_fwd_scan_kernel: the state scan, split over (32-row slice of
//       S, b, h), 512 CTAs at the shape above, four to an SM, so its 32
//       dependent steps run in one wave (16-row slices, as K7's scan, made
//       1,024 CTAs in two waves, and the scan took 0.21 ms on an H100
//       against 0.15: scripts/wkv6_bwd_phases.py times it); it writes
//       every S_c, the state entering chunk c, and s_end;
//   (b) wkv6_fwd_chunk_kernel: one CTA of 128 threads per (b, h, chunk),
//       8,192 CTAs, for the chunk's o from its own rows and S_c alone.
// The serial loop of the TPU kernel's grid thus runs in 512 short scans
// instead of 256 CTAs that did all the work of every chunk in turn, and
// both launches keep their loads in flight: the scan prefetches the next
// chunk while it updates S, and a chunk CTA issues every load before the
// first is used (16-byte runs where the strides allow). The (cs, cs, P)
// pairwise-decay tensor of the TPU kernel (256 KB at cs 32, P 64) is never
// built: exp(lprev_t - L_j) is recomputed where it is used, over the live
// triangle j < t only, a lane a pair, where the exponent is <= 0 and
// nothing can overflow under any decay (the min(., 0) guards the last
// rounding); that pass issues one expf per pair and column and bounds the
// chunk launch's arithmetic. The two launches move more than the function:
// the scan reads k, v, wlog and s0 and writes the states and s_end (about
// 277 MB at the shape above), the chunk launch reads r, k, v, wlog and the
// states and writes o (about 369 MB): about 646 MB, 0.19 ms at 3.35 TB/s.
// The primal-only call runs the same two launches with a scratch in place
// of `states`, so it moves the same 646 MB where its function needs 243
// MB: the scratch's round trip (268 MB) and the second reads of k, v and
// wlog are the price of the split.
//
// K7's design: only the state gradient G = dLoss/dS_out is serial across
// chunks; every other term of a chunk depends only on that chunk's inputs,
// its entering state S_c and its G_c. So K7 is two launches behind one call:
//   (a) wkv6_bwd_scan_kernel: the reverse scan G_{c-1} = (r e^lprev)_c^T
//       dO_c + e^L_end,c G_c from dS_end, split over (16-row slice of G,
//       b, h), 1,024 CTAs at the shape above; it writes every G_c to an
//       fp32 scratch the size of the states, and dS0;
//   (b) wkv6_bwd_chunk_kernel: one CTA of 128 threads per (b, h, chunk),
//       8,192 CTAs, for the chunk's dr, dk, dv, dwlog and du partial. Its
//       loads (the chunk's rows, S_c and G_c) are all issued before the
//       first is used: with short CTAs, few to an SM, latency rules. Each
//       thread owns a 4 x 4 block of every (cs, P) output and register-
//       tiles the three (cs x P)(P x P) products (dO S^T, v G^T, kadv G)
//       with float4 shared-memory reads; the pairwise adjoints recompute
//       exp(lprev_t - L_j) over the live triangle as K6 does, and the
//       reference's E tensor folds away (dlprev_pair = r dr_att, dL_pair =
//       -k dk_att). 74 KB of tiles, so three CTAs share an SM.
// Both stay in fp32 FMAs on the CUDA cores (the fp32 bound; TF32 would miss
// the 1e-3 gate). lprev is taken as L_{t-1}, the same sum as L - w without
// its last rounding. Element strides of the model's (B,S,H,P) tensors are
// passed in; the last dimension is contiguous. expf, not __expf or exp2f
// of prescaled logs: the build passes no fast-math flag, and log2 units
// doubled dwlog's fp32 error in a trial.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Element strides (batch, sequence, head) of one (B,S,H,P) tensor.
struct Strides {
  long long b, s, h;
};

struct FwdArgs {
  const void* r;
  const void* k;
  const void* v;
  const void* w;
  const float* u;       // (H,P)
  const float* s0;      // (B,H,P,P)
  float* o;             // (B,S,H,P) contiguous
  float* s_end;         // (B,H,P,P)
  float* states;        // (B,H,NC,P,P): the states, or a scratch
  int h, s, cs;
  Strides sr, sk, sv, sw;
  int vec;              // r/k/v/wlog load as 16-byte runs (see vec_ok)
};

struct BwdArgs {
  const void* r;
  const void* k;
  const void* v;
  const void* w;
  const float* u;       // (H,P)
  const float* states;  // (B,H,NC,P,P)
  const float* dout;    // (B,S,H,P) fp32
  const float* ds_end;  // (B,H,P,P)
  void* dr;             // (B,S,H,P) contiguous, r's dtype
  void* dk;
  void* dv;
  void* dw;             // wlog's dtype
  float* ds0;           // (B,H,P,P)
  float* du;            // (B,H,NC,P) partials, one per chunk
  float* gsc;           // (B,H,NC,P,P) scratch: G_c = dLoss/dS_out of chunk c
  int h, s, cs;
  Strides sr, sk, sv, sw, sdo;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// exp(lprev_t - L_j) for j < t: the exponent is <= 0 up to rounding.
__device__ __forceinline__ float pair_decay(float lprev_t, float l_j) {
  return expf(fminf(lprev_t - l_j, 0.f));
}

// The N = rows * P / NT values of rows [row0, ..) of head hh of batch bb
// that thread t stages (t, t + NT, ...), as fp32 in registers, every load
// issued before any is used; put_rows stores them with row stride ld.
template <typename T, int P, int NT, int N>
__device__ __forceinline__ void fetch_rows(float (&x)[N], const void* base,
                                           const Strides& st, int bb, int hh,
                                           long long row0) {
  const T* src = static_cast<const T*>(base) + bb * st.b + row0 * st.s +
                 hh * st.h;
#pragma unroll
  for (int m = 0; m < N; ++m) {
    const int i = threadIdx.x + NT * m;
    x[m] = to_f32(src[(i / P) * st.s + i % P]);
  }
}
template <int P, int NT, int N>
__device__ __forceinline__ void put_rows(float* dst, int ld,
                                         const float (&x)[N]) {
#pragma unroll
  for (int m = 0; m < N; ++m) {
    const int i = threadIdx.x + NT * m;
    dst[(i / P) * ld + i % P] = x[m];
  }
}

// K6's staging: the N = rows * P / NT values of rows [row0, ..) of head hh
// of batch bb that thread t stages, kept in T until put_tile stores them as
// fp32 (row stride ld). They come in runs of V adjacent columns, run m of
// the thread being run t + NT m of the tile in row order, each run one load
// of V * sizeof(T) <= 16 bytes when vec, else V scalar loads.
template <int Bytes> struct RawOf;
template <> struct RawOf<16> { using type = uint4; };
template <> struct RawOf<8> { using type = uint2; };
template <typename T, int N>
__host__ __device__ constexpr int run_len() {
  return 16 / static_cast<int>(sizeof(T)) < N
             ? 16 / static_cast<int>(sizeof(T)) : N;
}
template <typename T, int P, int NT, int N>
__device__ __forceinline__ void fetch_tile(T (&x)[N], const void* base,
                                           const Strides& st, int bb, int hh,
                                           long long row0, int vec) {
  constexpr int V = run_len<T, N>();
  using Raw = typename RawOf<V * sizeof(T)>::type;
  const T* src = static_cast<const T*>(base) + bb * st.b + row0 * st.s +
                 hh * st.h;
#pragma unroll
  for (int m = 0; m < N / V; ++m) {
    const int i = (threadIdx.x + NT * m) * V;
    const T* p = src + (i / P) * st.s + i % P;
    if (vec) {
      const Raw raw = *reinterpret_cast<const Raw*>(p);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < V; ++j) x[m * V + j] = e[j];
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) x[m * V + j] = p[j];
    }
  }
}
template <typename T, int P, int NT, int N>
__device__ __forceinline__ void put_tile(float* dst, int ld,
                                         const T (&x)[N]) {
  constexpr int V = run_len<T, N>();
#pragma unroll
  for (int m = 0; m < N / V; ++m) {
    const int i = (threadIdx.x + NT * m) * V;
#pragma unroll
    for (int j = 0; j < V; ++j)
      dst[(i / P) * ld + i % P + j] = to_f32(x[m * V + j]);
  }
}

// A line "// phase: NAME" marks the next code line, a loop header or a
// launch, as a part of K6 or K7 that scripts/wkv6_bwd_phases.py takes out
// (the loop runs no times, the launch is dropped) to time the kernel
// without it.

constexpr int SCAN_NT = 128;    // threads per scan CTA (K6, K7): 4 warps
constexpr int SLICE = 16;       // rows of G per K7 scan CTA
constexpr int FWD_SLICE = 32;   // rows of S per K6 scan CTA

// Threads of a chunk CTA (K6, K7): each owns 4 rows (rg + RG i, RG = CS / 4
// row groups) and 4 columns of every (CS, P) output, so that a warp's lanes
// read consecutive columns and at most a few rows.
template <int P, int CS>
__host__ __device__ constexpr int chunk_threads() { return CS * P / 16; }

// ---- K6, launch (a): the state scan ------------------------------------

// S_c, the state entering chunk c, for every chunk, by the only serial part
// of the forward: S_0 = s0, S_{c+1} = e^L_end,c S_c + kadv_c^T v_c with
// kadv = k e^(L_end - L). Row p of S needs only column p of k and w, so
// there is one CTA per (slice of SL = FWD_SLICE rows of S, b, h), the
// slices of one (b, h) side by side (blockIdx.x = bh * P / SL + slice), so
// they share the chunk's v in L2: 512 CTAs at the rwkv6-7b
// shape, which fit the card at once (four to an SM), so the 32 dependent
// steps run in one wave. The slice stays in registers: warp w owns rows p0
// + RW w + i (i < RW = SL / 4), lane l the columns l + 32j. The loop is
// bound by latency, so each step loads the next chunk's v, k and w into
// registers while it works on its own, and its cumsum of w runs on every
// thread: NSEG segments of CS / NSEG rows per column, their totals added
// through shared memory. S_c goes to a.states before the chunk's update,
// s_end after the last.
template <typename TI, typename TW, int P, int CS>
__global__ void __launch_bounds__(SCAN_NT) wkv6_fwd_scan_kernel(FwdArgs a) {
  constexpr int SL = FWD_SLICE;
  static_assert(P % SL == 0, "P must be a multiple of the scan's slice");
  constexpr int RW = SL / 4;                 // rows of the slice a warp
  constexpr int NQ = P / 32;
  constexpr int NV = CS * P / SCAN_NT;       // v values a thread stages
  constexpr int NKW = CS * SL / SCAN_NT;     // k (and w) values a thread
  constexpr int NSEG = SCAN_NT / SL;         // cumsum segments a column
  __shared__ __align__(16) float sv[CS * P];
  __shared__ __align__(16) float ska[CS * SL];   // k e^(L_end - L)
  __shared__ float stot[SCAN_NT];                // segment sums of w
  const int nsl = P / SL;
  const int slice = blockIdx.x % nsl, bh = blockIdx.x / nsl;
  const int bb = bh / a.h, hh = bh % a.h;
  const int p0 = slice * SL;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nc = a.s / CS;
  const long long pp = static_cast<long long>(P) * P;
  // the cumsum's share of this thread: column col of the slice, rows
  // seg * NKW .. + NKW - 1
  const int col = tid % SL, seg = tid / SL;

  float s[RW][NQ];
  const float* s0 = a.s0 + bh * pp;
#pragma unroll
  for (int i = 0; i < RW; ++i)
#pragma unroll
    for (int j = 0; j < NQ; ++j)
      s[i][j] = s0[(p0 + RW * warp + i) * P + lane + 32 * j];

  // the chunk's v (16-byte runs where the strides allow) and the thread's
  // cumsum rows of k and w
  TI nv[NV];
  float nk[NKW], nw[NKW];
  auto fetch = [&](int c) {
    const long long row0 = static_cast<long long>(c) * CS;
    fetch_tile<TI, P, SCAN_NT>(nv, a.v, a.sv, bb, hh, row0, a.vec);
    const TI* kg = static_cast<const TI*>(a.k) + bb * a.sk.b +
                   (row0 + seg * NKW) * a.sk.s + hh * a.sk.h + p0 + col;
    const TW* wg = static_cast<const TW*>(a.w) + bb * a.sw.b +
                   (row0 + seg * NKW) * a.sw.s + hh * a.sw.h + p0 + col;
#pragma unroll
    for (int m = 0; m < NKW; ++m) {
      nk[m] = to_f32(kg[m * a.sk.s]);
      nw[m] = to_f32(wg[m * a.sw.s]);
    }
  };
  fetch(0);

  for (int c = 0; c < nc; ++c) {
    float* sc = a.states + (bh * nc + c) * pp;
#pragma unroll
    for (int i = 0; i < RW; ++i)
#pragma unroll
      for (int j = 0; j < NQ; ++j)
        sc[(p0 + RW * warp + i) * P + lane + 32 * j] = s[i][j];
    // this chunk's registers: the w segment's inclusive sums kept, its
    // total shared
    float ck[NKW], cw[NKW];
    float tot = 0.f;
#pragma unroll
    for (int m = 0; m < NKW; ++m) {
      ck[m] = nk[m];
      tot += nw[m];
      cw[m] = tot;
    }
    __syncthreads();       // the previous chunk's reads are done
    put_tile<TI, P, SCAN_NT>(sv, P, nv);
    stot[tid] = tot;
    if (c + 1 < nc) fetch(c + 1);   // in flight while this chunk is worked on
    __syncthreads();
    // L of the segment's rows (the earlier segments' sums + the sum to the
    // row) and L_end of the column (every segment's sum, in the same order)
    float off = 0.f, lend = 0.f;
#pragma unroll
    for (int m = 0; m < NSEG; ++m) {
      if (m == seg) off = lend;
      lend += stot[m * SL + col];
    }
#pragma unroll
    for (int m = 0; m < NKW; ++m)
      ska[(seg * NKW + m) * SL + col] = ck[m] * expf(lend - (off + cw[m]));
    __syncthreads();
    float acc[RW][NQ];
#pragma unroll
    for (int i = 0; i < RW; ++i)
#pragma unroll
      for (int j = 0; j < NQ; ++j) acc[i][j] = 0.f;
#pragma unroll 4
    for (int t = 0; t < CS; ++t) {
      float d[NQ];
#pragma unroll
      for (int j = 0; j < NQ; ++j) d[j] = sv[t * P + lane + 32 * j];
#pragma unroll
      for (int i0 = 0; i0 < RW; i0 += 4) {
        const float4 ka = *reinterpret_cast<const float4*>(
            ska + t * SL + RW * warp + i0);
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          acc[i0][j] = fmaf(ka.x, d[j], acc[i0][j]);
          acc[i0 + 1][j] = fmaf(ka.y, d[j], acc[i0 + 1][j]);
          acc[i0 + 2][j] = fmaf(ka.z, d[j], acc[i0 + 2][j]);
          acc[i0 + 3][j] = fmaf(ka.w, d[j], acc[i0 + 3][j]);
        }
      }
    }
    // e^L_end of the warp's rows: every segment's sum of that column
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      float l = 0.f;
#pragma unroll
      for (int m = 0; m < NSEG; ++m) l += stot[m * SL + RW * warp + i];
      const float decay = expf(l);
#pragma unroll
      for (int j = 0; j < NQ; ++j) s[i][j] = fmaf(decay, s[i][j], acc[i][j]);
    }
  }
  float* se = a.s_end + bh * pp;
#pragma unroll
  for (int i = 0; i < RW; ++i)
#pragma unroll
    for (int j = 0; j < NQ; ++j)
      se[(p0 + RW * warp + i) * P + lane + 32 * j] = s[i][j];
}

// ---- K6, launch (b): the chunks' outputs, in parallel --------------------

// Shared memory of a K6 chunk CTA, in floats: r (then r e^lprev), v and S_c
// with row stride P; w (then L) and k with stride P + 4, whose rows the att
// pass reads across lanes as float4 (8 lanes of a quarter-warp on rows j ..
// j + 7 hit 32 distinct banks); att (CS, CS + 4), read as float4 along j;
// the cumsum's segment sums, diag and u.
template <int P, int CS>
__host__ __device__ constexpr int fwd_chunk_smem_floats() {
  return 2 * CS * P + P * P + 2 * CS * (P + 4) + CS * (CS + 4) +
         chunk_threads<P, CS>() + CS + P;
}

// One CTA per (b, h, chunk), blockIdx.x = bh * NC + c: o for the chunk's
// rows from its r, k, v, w and its entering state S_c (launch (a)). Thread
// (rg, cg) owns the rows rg + RG i and the 4 adjacent columns 4 cg .. 4 cg
// + 3, so that its row of o is one float4 and a row of S_c or v one float4
// read.
template <typename TI, typename TW, int P, int CS>
__global__ void __launch_bounds__(CS * P / 16, 4)
    wkv6_fwd_chunk_kernel(FwdArgs a) {
  constexpr int NT = chunk_threads<P, CS>();
  constexpr int LJ = P + 4, LA = CS + 4;
  constexpr int RG = CS / 4, CG = P / 4;
  constexpr int NSEG = NT / P;             // cumsum segments a column
  constexpr int SEG = CS / NSEG;           // rows a segment
  extern __shared__ float4 smem_f4[];
  float* sr = reinterpret_cast<float*>(smem_f4);   // r, then r e^lprev
  float* sv = sr + CS * P;
  float* sS = sv + CS * P;           // S_c (P, P)
  float* sL = sS + P * P;            // w, then L (stride LJ)
  float* sk = sL + CS * LJ;          // (stride LJ)
  float* satt = sk + CS * LJ;        // (CS, LA): att[t][j] on j < t, else 0
  float* stot = satt + CS * LA;      // (NT): segment sums of w
  float* sdiag = stot + NT;          // (CS): sum_p r u k
  float* su = sdiag + CS;            // (P)

  const int nc = a.s / CS;
  const int bh = blockIdx.x / nc, c = blockIdx.x % nc;
  const int bb = bh / a.h, hh = bh % a.h;
  const long long row0 = static_cast<long long>(c) * CS;
  const int tid = threadIdx.x;
  const int rg = tid / CG, cg = tid % CG;

  // 1. stage the chunk's rows as fp32, S_c and u. The CTA is short-lived
  // and few share an SM, so latency rules: every load is issued before the
  // first store
  constexpr int NR = CS * P / NT;          // 16 values a thread per tile
  constexpr int NPP = P * P / 4 / NT;      // float4s a thread of S_c
  TI xr[NR], xk[NR], xv[NR];
  TW xw[NR];
  fetch_tile<TI, P, NT>(xr, a.r, a.sr, bb, hh, row0, a.vec);
  fetch_tile<TI, P, NT>(xk, a.k, a.sk, bb, hh, row0, a.vec);
  fetch_tile<TI, P, NT>(xv, a.v, a.sv, bb, hh, row0, a.vec);
  fetch_tile<TW, P, NT>(xw, a.w, a.sw, bb, hh, row0, a.vec);
  const float4* sc = reinterpret_cast<const float4*>(
      a.states + (static_cast<long long>(bh) * nc + c) * P * P);
  float4 xs[NPP];
#pragma unroll
  for (int m = 0; m < NPP; ++m) xs[m] = sc[tid + NT * m];
  put_tile<TI, P, NT>(sr, P, xr);
  put_tile<TI, P, NT>(sk, LJ, xk);
  put_tile<TI, P, NT>(sv, P, xv);
  put_tile<TW, P, NT>(sL, LJ, xw);
#pragma unroll
  for (int m = 0; m < NPP; ++m)
    reinterpret_cast<float4*>(sS)[tid + NT * m] = xs[m];
  for (int p = tid; p < P; p += NT) su[p] = a.u[hh * P + p];
  for (int i = tid; i < CS * LA; i += NT) satt[i] = 0.f;
  __syncthreads();

  // 2. diag[t] = sum_p r u k, NT / CS = P / 16 adjacent threads a row, 16
  // columns each (from a column that differs between rows, so that the
  // lanes spread over the banks), their sums combined by shuffles; then L =
  // cumsum(w) down each column: thread (seg, col) sums its SEG rows in
  // place, then adds the earlier segments' totals
  {
    constexpr int PARTS = NT / CS;
    const int t = tid / PARTS, part = tid % PARTS;
    float dg = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int p = part * 16 + (i + t) % 16;
      dg += sr[t * P + p] * su[p] * sk[t * LJ + p];
    }
#pragma unroll
    for (int o = 1; o < PARTS; o <<= 1)
      dg += __shfl_xor_sync(0xffffffffu, dg, o);
    if (part == 0) sdiag[t] = dg;
  }
  {
    const int col = tid % P, seg = tid / P;
    float* lc = sL + seg * SEG * LJ + col;
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < SEG; ++t) {
      acc += lc[t * LJ];
      lc[t * LJ] = acc;
    }
    stot[tid] = acc;
    __syncthreads();
    float off = 0.f;
    for (int m = 0; m < seg; ++m) off += stot[m * P + col];
    if (seg)
#pragma unroll
      for (int t = 0; t < SEG; ++t) lc[t * LJ] += off;
  }
  __syncthreads();

  // 3. att[t][j] on the live triangle j < t: a warp takes the rows ta =
  // CS/2 + f and tb = CS/2 - 1 - f together (ta + tb = CS - 1 pairs), a
  // lane a pair, the sum over p in the lane
  {
    const int lane = tid & 31, warp = tid >> 5;
    // phase: fwd-att-pass
    for (int f = warp; f < CS / 2; f += NT / 32) {
      const int ta = CS / 2 + f, tb = CS / 2 - 1 - f;
      const int t = lane < ta ? ta : tb;
      const int j = lane < ta ? lane : lane - ta;
      if (lane < ta + tb) {
        // lprev_t = L_{t-1}
        const float4* lt = reinterpret_cast<const float4*>(sL + (t - 1) * LJ);
        const float4* lj = reinterpret_cast<const float4*>(sL + j * LJ);
        const float4* rt = reinterpret_cast<const float4*>(sr + t * P);
        const float4* kj = reinterpret_cast<const float4*>(sk + j * LJ);
        float att = 0.f;
#pragma unroll 4
        for (int q = 0; q < P / 4; ++q) {
          const float4 a = lt[q], b = lj[q], x = rt[q], y = kj[q];
          att += x.x * pair_decay(a.x, b.x) * y.x;
          att += x.y * pair_decay(a.y, b.y) * y.y;
          att += x.z * pair_decay(a.z, b.z) * y.z;
          att += x.w * pair_decay(a.w, b.w) * y.w;
        }
        satt[t * LA + j] = att;
      }
    }
  }
  __syncthreads();

  // 4. r e^lprev in place
  for (int i = tid; i < CS * P; i += NT)
    if (i >= P) sr[i] *= expf(sL[(i / P - 1) * LJ + i % P]);
  __syncthreads();

  // 5. o = (r e^lprev) S_c + att v + diag v at the thread's rows and columns
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  // phase: fwd-products
#pragma unroll 2
  for (int k = 0; k < P; k += 4) {
    float4 x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = *reinterpret_cast<const float4*>(sr + (rg + RG * i) * P + k);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 y =
          *reinterpret_cast<const float4*>(sS + (k + u) * P + 4 * cg);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float xv = u == 0 ? x[i].x : u == 1 ? x[i].y
                       : u == 2 ? x[i].z : x[i].w;
        acc[i][0] = fmaf(xv, y.x, acc[i][0]);
        acc[i][1] = fmaf(xv, y.y, acc[i][1]);
        acc[i][2] = fmaf(xv, y.z, acc[i][2]);
        acc[i][3] = fmaf(xv, y.w, acc[i][3]);
      }
    }
  }
  // att v over j below the thread's last row, rounded up to a multiple of
  // 4 (att is 0 past each row's own), 4 j at a time
  const int jend = (rg + RG * 3 + 3) & ~3;
  // phase: fwd-products
  for (int j = 0; j < jend; j += 4) {
    float4 at[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      at[i] = *reinterpret_cast<const float4*>(satt + (rg + RG * i) * LA + j);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 y =
          *reinterpret_cast<const float4*>(sv + (j + u) * P + 4 * cg);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float w = u == 0 ? at[i].x : u == 1 ? at[i].y
                      : u == 2 ? at[i].z : at[i].w;
        acc[i][0] = fmaf(w, y.x, acc[i][0]);
        acc[i][1] = fmaf(w, y.y, acc[i][1]);
        acc[i][2] = fmaf(w, y.z, acc[i][2]);
        acc[i][3] = fmaf(w, y.w, acc[i][3]);
      }
    }
  }
  const long long orow = static_cast<long long>(a.h) * P;
  float* ob = a.o + ((static_cast<long long>(bb) * a.s + row0) * a.h + hh) *
                        P + 4 * cg;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = rg + RG * i;
    const float4 y = *reinterpret_cast<const float4*>(sv + t * P + 4 * cg);
    const float dg = sdiag[t];
    *reinterpret_cast<float4*>(ob + t * orow) = make_float4(
        fmaf(dg, y.x, acc[i][0]), fmaf(dg, y.y, acc[i][1]),
        fmaf(dg, y.z, acc[i][2]), fmaf(dg, y.w, acc[i][3]));
  }
}

// ---- K7, launch (a): the state-gradient scan -------------------------

// G_c = dLoss/dS_out of chunk c for every chunk, by the only serial part
// of the backward: G_{NC-1} = dS_end, G_{c-1} = (r_c e^lprev_c)^T dO_c +
// e^L_end,c G_c. One CTA per (slice of SLICE rows of G, b, h), the slices
// of one (b, h) side by side (blockIdx.x = bh * P / SLICE + slice), so
// they share the chunk's dO in L2. The slice of G stays in registers:
// warp w owns rows p0 + 4w + i (i < 4), lane l the columns l + 32j. The
// loop is bound by latency, so each step loads the next chunk's dO, r and
// w into registers while it works on its own, and its cumsum of w runs on
// every thread: 8 segments of CS / 8 rows per column, their totals added
// through shared memory. G_c goes to the scratch before the chunk's
// update; dS0 = G entering chunk 0.
template <typename TI, typename TW, int P, int CS>
__global__ void __launch_bounds__(SCAN_NT) wkv6_bwd_scan_kernel(BwdArgs a) {
  constexpr int NQ = P / 32;
  constexpr int ND = CS * P / SCAN_NT;       // dO values a thread stages
  constexpr int NRW = CS * SLICE / SCAN_NT;  // r (and w) values, = CS / 8
  __shared__ float sdo[CS * P];
  __shared__ __align__(16) float sr[CS * SLICE];   // r, then r e^lprev
  __shared__ float stot[SCAN_NT];                  // segment sums of w
  const int nsl = P / SLICE;
  const int slice = blockIdx.x % nsl, bh = blockIdx.x / nsl;
  const int bb = bh / a.h, hh = bh % a.h;
  const int p0 = slice * SLICE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nc = a.s / CS;
  const long long pp = static_cast<long long>(P) * P;
  // the cumsum's share of this thread: column col of the slice, rows
  // seg * NRW .. + NRW - 1
  const int col = tid % SLICE, seg = tid / SLICE;

  float g[4][NQ];
  const float* dse = a.ds_end + bh * pp;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NQ; ++j)
      g[i][j] = dse[(p0 + 4 * warp + i) * P + lane + 32 * j];

  // the chunk's dO (thread-strided) and the thread's cumsum rows of r, w
  float ndo[ND], nr[NRW], nw[NRW];
  auto fetch = [&](int c) {
    const long long row0 = static_cast<long long>(c) * CS;
    const float* dog = a.dout + bb * a.sdo.b + row0 * a.sdo.s +
                       hh * a.sdo.h;
#pragma unroll
    for (int m = 0; m < ND; ++m) {
      const int i = tid + SCAN_NT * m;
      ndo[m] = dog[(i / P) * a.sdo.s + i % P];
    }
    const TI* rg = static_cast<const TI*>(a.r) + bb * a.sr.b +
                   (row0 + seg * NRW) * a.sr.s + hh * a.sr.h + p0 + col;
    const TW* wg = static_cast<const TW*>(a.w) + bb * a.sw.b +
                   (row0 + seg * NRW) * a.sw.s + hh * a.sw.h + p0 + col;
#pragma unroll
    for (int m = 0; m < NRW; ++m) {
      nr[m] = to_f32(rg[m * a.sr.s]);
      nw[m] = to_f32(wg[m * a.sw.s]);
    }
  };
  fetch(nc - 1);

  for (int c = nc - 1; c >= 0; --c) {
    float* gc = a.gsc + (bh * nc + c) * pp;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NQ; ++j)
        gc[(p0 + 4 * warp + i) * P + lane + 32 * j] = g[i][j];
    // this chunk's registers: dO to shared memory, the w segment's
    // inclusive sums kept, its total shared
    float cr[NRW], cw[NRW];
    float tot = 0.f;
#pragma unroll
    for (int m = 0; m < NRW; ++m) {
      cr[m] = nr[m];
      tot += nw[m];
      cw[m] = tot;
    }
    __syncthreads();       // the previous chunk's reads are done
#pragma unroll
    for (int m = 0; m < ND; ++m) sdo[tid + SCAN_NT * m] = ndo[m];
    stot[tid] = tot;
    if (c > 0) fetch(c - 1);   // in flight while this chunk is worked on
    __syncthreads();
    // lprev of the segment's rows = the earlier segments' sums + the sum
    // before the row; r e^lprev to shared memory
    float off = 0.f;
    for (int m = 0; m < seg; ++m) off += stot[m * SLICE + col];
#pragma unroll
    for (int m = 0; m < NRW; ++m) {
      const float lprev = off + (m ? cw[m - 1] : 0.f);
      sr[(seg * NRW + m) * SLICE + col] = cr[m] * expf(lprev);
    }
    __syncthreads();
    float gn[4][NQ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NQ; ++j) gn[i][j] = 0.f;
#pragma unroll 8
    for (int t = 0; t < CS; ++t) {
      const float4 rd =
          *reinterpret_cast<const float4*>(sr + t * SLICE + 4 * warp);
      float d[NQ];
#pragma unroll
      for (int j = 0; j < NQ; ++j) d[j] = sdo[t * P + lane + 32 * j];
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        gn[0][j] = fmaf(rd.x, d[j], gn[0][j]);
        gn[1][j] = fmaf(rd.y, d[j], gn[1][j]);
        gn[2][j] = fmaf(rd.z, d[j], gn[2][j]);
        gn[3][j] = fmaf(rd.w, d[j], gn[3][j]);
      }
    }
    // e^L_end of the warp's rows: every segment's sum of that column
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float lend = 0.f;
      for (int m = 0; m < SCAN_NT / SLICE; ++m)
        lend += stot[m * SLICE + 4 * warp + i];
      const float decay = expf(lend);
#pragma unroll
      for (int j = 0; j < NQ; ++j) g[i][j] = gn[i][j] + decay * g[i][j];
    }
  }
  float* ds0 = a.ds0 + bh * pp;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NQ; ++j)
      ds0[(p0 + 4 * warp + i) * P + lane + 32 * j] = g[i][j];
}

// ---- K7, launch (b): the chunks' adjoints, in parallel -------------------

// Shared memory of a K7 chunk CTA, in floats. Row strides: P + 1 for L, k and
// v, whose rows the pair pass reads across lanes (scalar loads on distinct
// banks); P for r, dO and kadv, read a row at a time as float4; P + 4 for
// the (P, P) state and G, read as float4 down rows across lanes.
template <int P, int CS>
__host__ __device__ constexpr int chunk_smem_floats() {
  return 3 * CS * (P + 1) + 3 * CS * P + P * (P + 4) + 2 * CS * CS +
         2 * P + 2 * CS;
}

// acc[i][j] = sum_k A[(rg + RG i) * P + k] * B[(cg + CG j) * ldb + k]: the
// thread's block of A B^T, both operands read as float4 along k.
template <int P, int CS>
__device__ __forceinline__ void mm_abt(float (&acc)[4][4], const float* A,
                                       const float* B, int ldb, int rg,
                                       int cg) {
  constexpr int RG = CS / 4, CG = P / 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  // phase: products
#pragma unroll 4
  for (int k = 0; k < P; k += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = *reinterpret_cast<const float4*>(A + (rg + RG * i) * P + k);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      y[j] = *reinterpret_cast<const float4*>(B + (cg + CG * j) * ldb + k);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(x[i].x, y[j].x, acc[i][j]);
        acc[i][j] = fmaf(x[i].y, y[j].y, acc[i][j]);
        acc[i][j] = fmaf(x[i].z, y[j].z, acc[i][j]);
        acc[i][j] = fmaf(x[i].w, y[j].w, acc[i][j]);
      }
  }
}

// One CTA per (b, h, chunk), blockIdx.x = bh * NC + c: from the chunk's r,
// k, v, w and dO, its entering state S_c (K6's states) and G_c (launch
// (a)), dr, dk, dv and dwlog for the chunk's rows and the chunk's du
// partial. With L = cumsum(w), lprev_t = L_{t-1} (0 at t = 0), rdec =
// r e^lprev, kadv = k e^(L_end - L) and dA[t][j] = dO_t . v_j on j < t:
//   dr = dr_att + (dO S^T) e^lprev + u k dov,
//   dk = dk_att + (v G^T) e^(L_end - L) + u r dov,
//   dv = att^T dO + kadv G + diag dO,
// with dr_att[t] = sum_{j<t} dA[t][j] e^(lprev_t - L_j) k_j and dk_att[j] =
// sum_{t>j} dA[t][j] e^(lprev_t - L_j) r_t (kernels/ref.py:
// wkv6_pair_adjoints with the E tensor folded away), and dwlog by the
// reverse cumsum of the decay adjoints.
template <typename TI, typename TW, int P, int CS>
__global__ void __launch_bounds__(CS * P / 16, 3)
    wkv6_bwd_chunk_kernel(BwdArgs a) {
  constexpr int NT = chunk_threads<P, CS>();
  constexpr int LJ = P + 1, LPP = P + 4;
  constexpr int RG = CS / 4, CG = P / 4;
  extern __shared__ float4 smem_f4[];
  float* sL = reinterpret_cast<float*>(smem_f4);   // w, then L (stride LJ)
  float* sk = sL + CS * LJ;
  float* sv = sk + CS * LJ;          // v, then dkadv kadv
  float* sr = sv + CS * LJ;          // (stride P from here)
  float* sdo = sr + CS * P;
  float* ska = sdo + CS * P;         // kadv, then the decay adjoints' sum
  float* sPP = ska + CS * P;         // S_c, then G_c, then dlprev (LPP)
  float* satt = sPP + P * LPP;       // (CS, CS): att[t][j] on j < t
  float* sdA = satt + CS * CS;       // (CS, CS): dA[t][j] on j < t
  float* slend = sdA + CS * CS;      // (P)
  float* su = slend + P;             // (P)
  float* sdiag = su + P;             // (CS): sum_p r u k
  float* sdov = sdiag + CS;          // (CS): dO . v

  const int nc = a.s / CS;
  const int bh = blockIdx.x / nc, c = blockIdx.x % nc;
  const int bb = bh / a.h, hh = bh % a.h;
  const long long row0 = static_cast<long long>(c) * CS;
  const long long pp = static_cast<long long>(P) * P;
  const int tid = threadIdx.x;
  const int rg = tid / CG, cg = tid % CG;

  // 1. stage the chunk's rows as fp32, S_c and u. The CTA is short-lived
  // and few share an SM, so latency rules: every load of the chunk, G_c's
  // too (kept in registers until step 4), is issued before the first store
  constexpr int NR = CS * P / NT;          // 16 values a thread per tile
  constexpr int NPP = P * P / 4 / NT;      // float4s a thread of S or G
  float xr[NR], xk[NR], xv[NR], xw[NR], xd[NR];
  fetch_rows<TI, P, NT>(xr, a.r, a.sr, bb, hh, row0);
  fetch_rows<TI, P, NT>(xk, a.k, a.sk, bb, hh, row0);
  fetch_rows<TI, P, NT>(xv, a.v, a.sv, bb, hh, row0);
  fetch_rows<TW, P, NT>(xw, a.w, a.sw, bb, hh, row0);
  fetch_rows<float, P, NT>(xd, a.dout, a.sdo, bb, hh, row0);
  const float4* sc = reinterpret_cast<const float4*>(
      a.states + (bh * nc + c) * pp);
  const float* gc = a.gsc + (bh * nc + c) * pp;
  float4 xs[NPP], xg[NPP];
#pragma unroll
  for (int m = 0; m < NPP; ++m) {
    xs[m] = sc[tid + NT * m];
    xg[m] = reinterpret_cast<const float4*>(gc)[tid + NT * m];
  }
  put_rows<P, NT>(sr, P, xr);
  put_rows<P, NT>(sk, LJ, xk);
  put_rows<P, NT>(sv, LJ, xv);
  put_rows<P, NT>(sL, LJ, xw);
  put_rows<P, NT>(sdo, P, xd);
#pragma unroll
  for (int m = 0; m < NPP; ++m) {
    const int i = tid + NT * m;
    *reinterpret_cast<float4*>(sPP + (i / (P / 4)) * LPP + 4 * (i % (P / 4))) =
        xs[m];
  }
  for (int p = tid; p < P; p += NT) su[p] = a.u[hh * P + p];
  __syncthreads();

  // 2. L = cumsum(w) down each column, L_end, kadv (one thread a column)
  if (tid < P) {
    const int p = tid;
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < CS; ++t) {
      acc += sL[t * LJ + p];
      sL[t * LJ + p] = acc;
    }
    slend[p] = acc;
#pragma unroll
    for (int t = 0; t < CS; ++t)
      ska[t * P + p] = sk[t * LJ + p] * expf(acc - sL[t * LJ + p]);
  }
  __syncthreads();

  // 3. att[t][j] and dA[t][j] on the live triangle j < t: a warp takes the
  // rows ta = CS/2 + f and tb = CS/2 - 1 - f together (ta + tb = CS - 1
  // pairs), a lane a pair, the sum over p in the lane; the row dots diag
  // and dov with one thread a row, each starting at its own column so
  // that the lanes hit distinct banks; dO S^T into registers; and, with
  // one thread a row p, sum_q S[p][q] G_c[p][q] for dL_end, G_c read from
  // global memory before it replaces S_c.
  {
    const int lane = tid & 31, warp = tid >> 5;
    // phase: att-pass
    for (int f = warp; f < CS / 2; f += NT / 32) {
      const int ta = CS / 2 + f, tb = CS / 2 - 1 - f;
      const int t = lane < ta ? ta : tb;
      const int j = lane < ta ? lane : lane - ta;
      if (lane < ta + tb) {
        const float* Lt = sL + (t - 1) * LJ;    // lprev_t = L_{t-1}
        const float* Lj = sL + j * LJ;
        const float* rt = sr + t * P;
        const float* kj = sk + j * LJ;
        const float* dt = sdo + t * P;
        const float* vj = sv + j * LJ;
        float att = 0.f, da = 0.f;
#pragma unroll 8
        for (int p = 0; p < P; ++p) {
          att += rt[p] * pair_decay(Lt[p], Lj[p]) * kj[p];
          da = fmaf(dt[p], vj[p], da);
        }
        satt[t * CS + j] = att;
        sdA[t * CS + j] = da;
      }
    }
  }
  for (int t = tid; t < CS; t += NT) {
    float dg = 0.f, dv = 0.f;
#pragma unroll 8
    for (int i = 0; i < P; ++i) {
      const int p = (i + t) % P;
      dg += sr[t * P + p] * su[p] * sk[t * LJ + p];
      dv = fmaf(sdo[t * P + p], sv[t * LJ + p], dv);
    }
    sdiag[t] = dg;
    sdov[t] = dv;
  }
  float drdec[4][4];
  mm_abt<P, CS>(drdec, sdo, sPP, LPP, rg, cg);
  float sg = 0.f;                    // thread p < P: sum_q S[p][q] G[p][q]
  if (tid < P) {
#pragma unroll
    for (int q = 0; q < P; q += 4) {
      const float4 x = *reinterpret_cast<const float4*>(sPP + tid * LPP + q);
      const float4 y = *reinterpret_cast<const float4*>(gc + tid * P + q);
      sg += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
    }
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < NPP; ++m) {
    const int i = tid + NT * m;
    *reinterpret_cast<float4*>(sPP + (i / (P / 4)) * LPP + 4 * (i % (P / 4))) =
        xg[m];
  }
  __syncthreads();

  // 4. dv = att^T dO + kadv G + diag dO, and v G^T for dk; the thread's
  // rows are j (dv) or t (dkadv), its columns q or p
  const long long orow = static_cast<long long>(a.h) * P;
  const long long obase = (static_cast<long long>(bb) * a.s + row0) * orow +
                          static_cast<long long>(hh) * P;
  float dkadv[4][4];
  {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = dkadv[i][j] = 0.f;
    // v G^T, v read a scalar at a time (stride LJ)
    // phase: products
#pragma unroll 4
    for (int k = 0; k < P; k += 4) {
      float4 y[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        y[j] = *reinterpret_cast<const float4*>(sPP + (cg + CG * j) * LPP + k);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* vr = sv + (rg + RG * i) * LJ + k;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          dkadv[i][j] = fmaf(vr[0], y[j].x, dkadv[i][j]);
          dkadv[i][j] = fmaf(vr[1], y[j].y, dkadv[i][j]);
          dkadv[i][j] = fmaf(vr[2], y[j].z, dkadv[i][j]);
          dkadv[i][j] = fmaf(vr[3], y[j].w, dkadv[i][j]);
        }
      }
    }
    // kadv G, kadv read as float4 along p
    // phase: products
#pragma unroll 2
    for (int k = 0; k < P; k += 4) {
      float4 x[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        x[i] = *reinterpret_cast<const float4*>(ska + (rg + RG * i) * P + k);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float y[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) y[j] = sPP[(k + u) * LPP + cg + CG * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float xv = u == 0 ? x[i].x : u == 1 ? x[i].y
                         : u == 2 ? x[i].z : x[i].w;
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv, y[j], acc[i][j]);
        }
      }
    }
    // att^T dO over the live t > j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = rg + RG * i;
      float at[4] = {0.f, 0.f, 0.f, 0.f};
      for (int t = j + 1; t < CS; ++t) {
        const float w = satt[t * CS + j];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          at[jj] = fmaf(w, sdo[t * P + cg + CG * jj], at[jj]);
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int q = cg + CG * jj;
        put(static_cast<TI*>(a.dv) + obase + j * orow + q,
            at[jj] + acc[i][jj] + sdiag[j] * sdo[j * P + q]);
      }
    }
  }
  __syncthreads();     // v, kadv, att and G are no longer read

  // 5. dr, dk and the decay adjoints at the thread's (t, p): dr_att over
  // j < t, dk_att over t' > t, each pair decay recomputed where used
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = rg + RG * i;
    float dra[4] = {0.f, 0.f, 0.f, 0.f}, dka[4] = {0.f, 0.f, 0.f, 0.f};
    float lp[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      lp[jj] = t > 0 ? sL[(t - 1) * LJ + cg + CG * jj] : 0.f;
    // phase: pair-loops
    for (int j = 0; j < t; ++j) {
      const float d = sdA[t * CS + j];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int p = cg + CG * jj;
        dra[jj] += d * pair_decay(lp[jj], sL[j * LJ + p]) * sk[j * LJ + p];
      }
    }
    // phase: pair-loops
    for (int t2 = t + 1; t2 < CS; ++t2) {
      const float d = sdA[t2 * CS + t];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int p = cg + CG * jj;
        dka[jj] += d * pair_decay(sL[(t2 - 1) * LJ + p], sL[t * LJ + p]) *
                   sr[t2 * P + p];
      }
    }
    const float dov = sdov[t];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int p = cg + CG * jj;
      const float rv = sr[t * P + p], kv = sk[t * LJ + p];
      const float elp = expf(lp[jj]);
      const float eadv = expf(slend[p] - sL[t * LJ + p]);
      const float dr = dra[jj] + drdec[i][jj] * elp + su[p] * kv * dov;
      const float dk = dka[jj] + dkadv[i][jj] * eadv + su[p] * rv * dov;
      put(static_cast<TI*>(a.dr) + obase + t * orow + p, dr);
      put(static_cast<TI*>(a.dk) + obase + t * orow + p, dk);
      const float kk = dkadv[i][jj] * kv * eadv;
      const float dlp = drdec[i][jj] * rv * elp + rv * dra[jj];
      sv[t * LJ + p] = kk;                       // dkadv kadv
      sPP[t * LPP + p] = dlp;                    // dLoss/dlprev
      ska[t * P + p] = dlp - kv * dka[jj] - kk;  // dlprev + dL_pair - kk
    }
  }
  __syncthreads();

  // 6. dwlog by the cumsum adjoint, a reverse scan down each column (one
  // thread a column): dL_end = sum_j kk + e^L_end sum_q S G enters at the
  // last row; dwlog = suffix - dlprev; and the chunk's du partial
  if (tid < P) {
    const int p = tid;
    float dl_end = 0.f;
    for (int j = 0; j < CS; ++j) dl_end += sv[j * LJ + p];
    dl_end += expf(slend[p]) * sg;
    float suffix = dl_end, du = 0.f;
    for (int t = CS - 1; t >= 0; --t) {
      suffix += ska[t * P + p];
      put(static_cast<TW*>(a.dw) + obase + t * orow + p,
          suffix - sPP[t * LPP + p]);
      du += sr[t * P + p] * sk[t * LJ + p] * sdov[t];
    }
    a.du[(bh * nc + c) * P + p] = du;
  }
}

// K6's two launches for one shape: the scan (bh * P / FWD_SLICE CTAs), then
// one CTA per (b, h, chunk).
template <typename TI, typename TW, int P, int CS>
cudaError_t launch_fwd(const FwdArgs& a, int bh, cudaStream_t stream) {
  const int scan_ctas = bh * (P / FWD_SLICE);
  // phase: fwd-scan-launch
  wkv6_fwd_scan_kernel<TI, TW, P, CS><<<scan_ctas, SCAN_NT, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int smem =
      fwd_chunk_smem_floats<P, CS>() * static_cast<int>(sizeof(float));
  err = cudaFuncSetAttribute(wkv6_fwd_chunk_kernel<TI, TW, P, CS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  constexpr int nt = chunk_threads<P, CS>();
  const int chunk_ctas = bh * (a.s / CS);
  // phase: fwd-chunk-launch
  wkv6_fwd_chunk_kernel<TI, TW, P, CS><<<chunk_ctas, nt, smem, stream>>>(a);
  return cudaGetLastError();
}

// K7's two launches for one shape: the scan (bh * P / SLICE CTAs), then
// one CTA per (b, h, chunk).
template <typename TI, typename TW, int P, int CS>
cudaError_t launch_bwd(const BwdArgs& a, int bh, cudaStream_t stream) {
  const int scan_ctas = bh * (P / SLICE);
  // phase: scan-launch
  wkv6_bwd_scan_kernel<TI, TW, P, CS><<<scan_ctas, SCAN_NT, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int smem =
      chunk_smem_floats<P, CS>() * static_cast<int>(sizeof(float));
  err = cudaFuncSetAttribute(wkv6_bwd_chunk_kernel<TI, TW, P, CS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  constexpr int nt = chunk_threads<P, CS>();
  const int chunk_ctas = bh * (a.s / CS);
  // phase: chunk-launch
  wkv6_bwd_chunk_kernel<TI, TW, P, CS><<<chunk_ctas, nt, smem, stream>>>(a);
  return cudaGetLastError();
}

struct Fwd {
  template <typename TI, typename TW, int P, int CS>
  static cudaError_t run(const FwdArgs& a, int bh, cudaStream_t st) {
    return launch_fwd<TI, TW, P, CS>(a, bh, st);
  }
};
struct Bwd {
  template <typename TI, typename TW, int P, int CS>
  static cudaError_t run(const BwdArgs& a, int bh, cudaStream_t st) {
    return launch_bwd<TI, TW, P, CS>(a, bh, st);
  }
};

// The launches of L (Fwd or Bwd) for the call's dtypes, P and chunk.
template <typename L, typename TI, typename TW, typename Args>
cudaError_t dispatch_shape(int p, const Args& a, int bh, cudaStream_t st) {
  if (p == 32)
    return a.cs == 16 ? L::template run<TI, TW, 32, 16>(a, bh, st)
                      : L::template run<TI, TW, 32, 32>(a, bh, st);
  return a.cs == 16 ? L::template run<TI, TW, 64, 16>(a, bh, st)
                    : L::template run<TI, TW, 64, 32>(a, bh, st);
}

template <typename L, typename Args>
cudaError_t dispatch(int in_dtype, int w_dtype, int p, const Args& a, int bh,
                     cudaStream_t st) {
  using bf = __nv_bfloat16;
  if (in_dtype == 1 && w_dtype == 1)
    return dispatch_shape<L, bf, bf>(p, a, bh, st);
  if (in_dtype == 1) return dispatch_shape<L, bf, float>(p, a, bh, st);
  if (w_dtype == 1) return dispatch_shape<L, float, bf>(p, a, bh, st);
  return dispatch_shape<L, float, float>(p, a, bh, st);
}

Strides strides_at(const long long* s, int i) {
  return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

// 1 when each of r, k, v and wlog starts on 16 bytes and its (batch, seq,
// head) strides are multiples of 16 bytes, so that K6's staging loads
// 16-byte runs; else 0 (scalar loads).
int vec_ok(int in_dtype, int w_dtype, const void* const* ptrs,
           const long long* strides) {
  for (int i = 0; i < 4; ++i) {
    const long long el = (i < 3 ? in_dtype : w_dtype) == 1 ? 2 : 4;
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16) return 0;
    for (int j = 0; j < 3; ++j)
      if (strides[3 * i + j] * el % 16) return 0;
  }
  return 1;
}

}  // namespace

extern "C" {

// in_dtype (r, k, v and dr, dk, dv) and w_dtype (wlog and dwlog): 0 =
// float32, 1 = bfloat16; everything else is float32. p is 32 or 64, cs 16 or
// 32, s a multiple of cs (the wrapper checks). strides: (batch, seq, head)
// element strides of r, k, v, wlog and (K7) dO; their last dimension is
// contiguous, and every other tensor is dense. Each returns a cudaError_t.
// states is float32 (B,H,NC,P,P), written with the state entering every
// chunk: the backward's residual, or a scratch for a primal-only call.
int repro_wkv6_fwd(int in_dtype, int w_dtype, int p, const void* r,
                   const void* k, const void* v, const void* w,
                   const void* u, const void* s0, void* o, void* s_end,
                   void* states, int b, int s, int h, int cs,
                   const long long* strides, void* stream) {
  const void* const ptrs[4] = {r, k, v, w};
  FwdArgs a{r, k, v, w, static_cast<const float*>(u),
            static_cast<const float*>(s0), static_cast<float*>(o),
            static_cast<float*>(s_end), static_cast<float*>(states), h, s, cs,
            strides_at(strides, 0), strides_at(strides, 1),
            strides_at(strides, 2), strides_at(strides, 3),
            vec_ok(in_dtype, w_dtype, ptrs, strides)};
  return static_cast<int>(dispatch<Fwd>(in_dtype, w_dtype, p, a, b * h,
                                        static_cast<cudaStream_t>(stream)));
}

// du is float32 (B,H,NC,P): one partial per (b, h, chunk), which the
// wrapper sums; scratch is float32 (B,H,NC,P,P) for the G_c of every chunk.
int repro_wkv6_bwd(int in_dtype, int w_dtype, int p, const void* r,
                   const void* k, const void* v, const void* w,
                   const void* u, const void* states, const void* dout,
                   const void* ds_end, void* dr, void* dk, void* dv, void* dw,
                   void* ds0, void* du, void* scratch, int b, int s, int h,
                   int cs, const long long* strides, void* stream) {
  BwdArgs a{r, k, v, w, static_cast<const float*>(u),
            static_cast<const float*>(states),
            static_cast<const float*>(dout),
            static_cast<const float*>(ds_end), dr, dk, dv, dw,
            static_cast<float*>(ds0), static_cast<float*>(du),
            static_cast<float*>(scratch), h, s, cs,
            strides_at(strides, 0), strides_at(strides, 1),
            strides_at(strides, 2), strides_at(strides, 3),
            strides_at(strides, 4)};
  return static_cast<int>(dispatch<Bwd>(in_dtype, w_dtype, p, a, b * h,
                                        static_cast<cudaStream_t>(stream)));
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
