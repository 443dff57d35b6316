// K6 and K7: the chunked WKV6 recurrence (RWKV6 "Finch"), forward and
// backward, for Hopper (sm_90a), plain C interface.
//
// K6 replaces src/repro/kernels/wkv6.py:_fwd_kernel (launched by _forward,
// with and without the states residual). For r/k/v (B,S,H,P) in bf16 or
// fp32, log-decays wlog (B,S,H,P) in bf16 or fp32, the bonus u (H,P) and the
// initial state s0 (B,H,P,P) in fp32, it walks the chunks of each (b, h) in
// order and carries the fp32 (P,P) state S. Per chunk, with
// L = cumsum(w) and lprev = L - w down the chunk's rows:
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
// K6's design: one CTA of 256 threads per (b, h), which walks the chunks
// in a loop (the TPU kernel's sequential grid axis) with the state in
// shared memory; every input is read once and every output written once.
// Per chunk the r/k/v/w tiles are staged as fp32 in shared memory. The
// (cs, cs, P) pairwise-decay tensor of the TPU kernel (256 KB at cs 32,
// P 64, more than a CTA's shared memory) is never built: exp(lprev_t -
// L_j) is recomputed where it is used, over the live triangle j < t only,
// where the exponent is <= 0 and nothing can overflow under any decay (the
// min(., 0) guards the last rounding). The arithmetic is scalar fp32 on the
// CUDA cores; the grid is only B * H CTAs (256, about two waves on 132 SMs)
// and the chunk loop is serial, so it runs far above its bound: the chunk-
// parallel design of K7 is its next step.
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

constexpr int NT = 256;              // threads per CTA
constexpr int NWARP = NT / 32;

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
  float* states;        // (B,H,NC,P,P) or null
  int h, s, cs;
  Strides sr, sk, sv, sw;
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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// exp(lprev_t - L_j) for j < t: the exponent is <= 0 up to rounding.
__device__ __forceinline__ float pair_decay(float lprev_t, float l_j) {
  return expf(fminf(lprev_t - l_j, 0.f));
}

// Stage rows [row0, row0 + cs) of head hh of batch bb as fp32 (cs, P).
template <typename T, int P>
__device__ __forceinline__ void load_tile(float* dst, const void* base,
                                          const Strides& st, int bb, int hh,
                                          long long row0, int cs) {
  const T* src = static_cast<const T*>(base) + bb * st.b + row0 * st.s +
                 hh * st.h;
  for (int i = threadIdx.x; i < cs * P; i += NT) {
    const int t = i / P, p = i % P;
    dst[i] = to_f32(src[t * st.s + p]);
  }
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

// A (P, P) fp32 matrix between global (dense rows) and shared memory (rows
// padded to P + 1, so that threads indexed by the row hit distinct banks).
template <int P>
__device__ __forceinline__ void load_pp(float* dst, const float* src) {
  for (int i = threadIdx.x; i < P * P; i += NT)
    dst[(i / P) * (P + 1) + i % P] = src[i];
}
template <int P>
__device__ __forceinline__ void store_pp(float* dst, const float* src) {
  for (int i = threadIdx.x; i < P * P; i += NT)
    dst[i] = src[(i / P) * (P + 1) + i % P];
}

// L = cumsum(w) down each column (one thread per column), lprev = L - w
// written over w, and l_end = L of the last row.
template <int P>
__device__ __forceinline__ void decays(float* lp, float* L, float* lend,
                                       int cs) {
  if (threadIdx.x < P) {
    const int p = threadIdx.x;
    float acc = 0.f;
    for (int t = 0; t < cs; ++t) {
      const float w = lp[t * P + p];
      acc += w;
      L[t * P + p] = acc;
      lp[t * P + p] = acc - w;
    }
    lend[p] = acc;
  }
}

// rdec = r e^lprev and kadv = k e^(L_end - L).
template <int P>
__device__ __forceinline__ void decayed(float* rd, float* ka, const float* r,
                                        const float* k, const float* lp,
                                        const float* L, const float* lend,
                                        int cs) {
  for (int i = threadIdx.x; i < cs * P; i += NT) {
    rd[i] = r[i] * expf(lp[i]);
    ka[i] = k[i] * expf(lend[i % P] - L[i]);
  }
}

// att[t, j] = sum_p r_tp e^(lprev_tp - L_jp) k_jp on j < t, else 0; one
// warp per (t, j), lanes over p.
template <int P>
__device__ __forceinline__ void pair_att(float* att, const float* r,
                                         const float* k, const float* lp,
                                         const float* L, int cs) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int pr = warp; pr < cs * cs; pr += NWARP) {
    const int t = pr / cs, j = pr % cs;
    float acc = 0.f;
    if (j < t) {
#pragma unroll
      for (int p = lane; p < P; p += 32)
        acc += r[t * P + p] * pair_decay(lp[t * P + p], L[j * P + p]) *
               k[j * P + p];
      acc = warp_sum(acc);
    }
    if (lane == 0) att[pr] = acc;
  }
}

// out[t] = sum_p a_tp b_tp c_p (c null: 1); one warp per row.
template <int P>
__device__ __forceinline__ void row_dots(float* out, const float* a,
                                         const float* b, const float* c,
                                         int cs) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int t = warp; t < cs; t += NWARP) {
    float acc = 0.f;
#pragma unroll
    for (int p = lane; p < P; p += 32)
      acc += c ? a[t * P + p] * c[p] * b[t * P + p] : a[t * P + p] * b[t * P + p];
    acc = warp_sum(acc);
    if (lane == 0) out[t] = acc;
  }
}

// K6: one CTA per (b, h), blockIdx.x = b * H + h.
template <typename TI, typename TW, int P>
__global__ void __launch_bounds__(NT) wkv6_fwd_kernel(FwdArgs a) {
  extern __shared__ float smem[];
  constexpr int LD = P + 1;
  constexpr int G = NT / P;          // row groups: thread = (group, column)
  const int cs = a.cs, tile = cs * P;
  const int bh = blockIdx.x, bb = bh / a.h, hh = bh % a.h;
  const int col = threadIdx.x % P, grp = threadIdx.x / P;
  const int nc = a.s / cs;
  float* sr = smem;
  float* sk = sr + tile;
  float* sv = sk + tile;
  float* slp = sv + tile;            // w, then lprev
  float* sL = slp + tile;
  float* srd = sL + tile;            // r e^lprev
  float* ska = srd + tile;           // k e^(L_end - L)
  float* sS = ska + tile;            // (P, P + 1)
  float* satt = sS + P * LD;         // (cs, cs)
  float* sdiag = satt + cs * cs;     // (cs)
  float* slend = sdiag + cs;         // (P)
  float* su = slend + P;             // (P)

  for (int p = threadIdx.x; p < P; p += NT) su[p] = a.u[hh * P + p];
  load_pp<P>(sS, a.s0 + static_cast<long long>(bh) * P * P);
  __syncthreads();

  for (int c = 0; c < nc; ++c) {
    const long long row0 = static_cast<long long>(c) * cs;
    if (a.states)
      store_pp<P>(a.states + (static_cast<long long>(bh) * nc + c) * P * P,
                  sS);
    load_tile<TI, P>(sr, a.r, a.sr, bb, hh, row0, cs);
    load_tile<TI, P>(sk, a.k, a.sk, bb, hh, row0, cs);
    load_tile<TI, P>(sv, a.v, a.sv, bb, hh, row0, cs);
    load_tile<TW, P>(slp, a.w, a.sw, bb, hh, row0, cs);
    __syncthreads();
    decays<P>(slp, sL, slend, cs);
    __syncthreads();
    decayed<P>(srd, ska, sr, sk, slp, sL, slend, cs);
    pair_att<P>(satt, sr, sk, slp, sL, cs);
    row_dots<P>(sdiag, sr, sk, su, cs);
    __syncthreads();

    // o[t, col]: the carried state, the strictly causal pairs, the bonus
    float* orow = a.o + ((static_cast<long long>(bb) * a.s + row0) * a.h +
                         hh) * P + col;
    for (int t = grp; t < cs; t += G) {
      float acc = 0.f;
#pragma unroll 16
      for (int p = 0; p < P; ++p) acc += srd[t * P + p] * sS[p * LD + col];
      float pairs = 0.f;
      for (int j = 0; j < t; ++j) pairs += satt[t * cs + j] * sv[j * P + col];
      orow[static_cast<long long>(t) * a.h * P] =
          acc + pairs + sdiag[t] * sv[t * P + col];
    }
    __syncthreads();                 // every read of the old S is done

    for (int p = grp; p < P; p += G) {
      float acc = 0.f;
      for (int j = 0; j < cs; ++j) acc += ska[j * P + p] * sv[j * P + col];
      sS[p * LD + col] = expf(slend[p]) * sS[p * LD + col] + acc;
    }
    __syncthreads();
  }
  store_pp<P>(a.s_end + static_cast<long long>(bh) * P * P, sS);
}

// ---- K7, launch (a): the state-gradient scan -------------------------
//
// A line "// phase: NAME" marks the next code line, a loop header or a
// launch, as a part of K7 that scripts/wkv6_bwd_phases.py takes out (the
// loop runs no times, the launch is dropped) to time K7 without it.

constexpr int SCAN_NT = 128;    // threads per scan CTA: 4 warps
constexpr int SLICE = 16;       // rows of G per scan CTA

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

// Threads of a chunk CTA: each owns a 4 x 4 block of every (CS, P) output,
// rows rg + RG i and columns cg + CG j (CG = P / 4 column threads, RG =
// CS / 4 row groups), so a warp's lanes read consecutive columns and at
// most a few rows.
template <int P, int CS>
__host__ __device__ constexpr int chunk_threads() { return CS * P / 16; }

// Shared memory of a chunk CTA, in floats. Row strides: P + 1 for L, k and
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

size_t fwd_smem(int p, int cs) {
  return sizeof(float) *
         (7 * cs * p + p * (p + 1) + cs * cs + cs + 2 * p);
}

template <typename Kernel, typename Args>
cudaError_t launch(Kernel kernel, const Args& args, int blocks, size_t smem,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<blocks, NT, smem, stream>>>(args);
  return cudaGetLastError();
}

template <int P, typename Args>
cudaError_t dispatch_fwd(int in_dtype, int w_dtype, const Args& a,
                         int blocks, cudaStream_t st) {
  const size_t smem = fwd_smem(P, a.cs);
  using bf = __nv_bfloat16;
  if (in_dtype == 1 && w_dtype == 1)
    return launch(wkv6_fwd_kernel<bf, bf, P>, a, blocks, smem, st);
  if (in_dtype == 1)
    return launch(wkv6_fwd_kernel<bf, float, P>, a, blocks, smem, st);
  if (w_dtype == 1)
    return launch(wkv6_fwd_kernel<float, bf, P>, a, blocks, smem, st);
  return launch(wkv6_fwd_kernel<float, float, P>, a, blocks, smem, st);
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

template <typename TI, typename TW>
cudaError_t dispatch_bwd_shape(int p, const BwdArgs& a, int bh,
                               cudaStream_t st) {
  if (p == 32)
    return a.cs == 16 ? launch_bwd<TI, TW, 32, 16>(a, bh, st)
                      : launch_bwd<TI, TW, 32, 32>(a, bh, st);
  return a.cs == 16 ? launch_bwd<TI, TW, 64, 16>(a, bh, st)
                    : launch_bwd<TI, TW, 64, 32>(a, bh, st);
}

cudaError_t dispatch_bwd(int in_dtype, int w_dtype, int p, const BwdArgs& a,
                         int bh, cudaStream_t st) {
  using bf = __nv_bfloat16;
  if (in_dtype == 1 && w_dtype == 1)
    return dispatch_bwd_shape<bf, bf>(p, a, bh, st);
  if (in_dtype == 1) return dispatch_bwd_shape<bf, float>(p, a, bh, st);
  if (w_dtype == 1) return dispatch_bwd_shape<float, bf>(p, a, bh, st);
  return dispatch_bwd_shape<float, float>(p, a, bh, st);
}

Strides strides_at(const long long* s, int i) {
  return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

}  // namespace

extern "C" {

// in_dtype (r, k, v and dr, dk, dv) and w_dtype (wlog and dwlog): 0 =
// float32, 1 = bfloat16; everything else is float32. p is 32 or 64, cs 16 or
// 32, s a multiple of cs (the wrapper checks). strides: (batch, seq, head)
// element strides of r, k, v, wlog and (K7) dO; their last dimension is
// contiguous, and every other tensor is dense. Each returns a cudaError_t.
int repro_wkv6_fwd(int in_dtype, int w_dtype, int p, const void* r,
                   const void* k, const void* v, const void* w,
                   const void* u, const void* s0, void* o, void* s_end,
                   void* states, int b, int s, int h, int cs,
                   const long long* strides, void* stream) {
  FwdArgs a{r, k, v, w, static_cast<const float*>(u),
            static_cast<const float*>(s0), static_cast<float*>(o),
            static_cast<float*>(s_end), static_cast<float*>(states), h, s, cs,
            strides_at(strides, 0), strides_at(strides, 1),
            strides_at(strides, 2), strides_at(strides, 3)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p == 32) return dispatch_fwd<32>(in_dtype, w_dtype, a, b * h, st);
  return dispatch_fwd<64>(in_dtype, w_dtype, a, b * h, st);
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
  return static_cast<int>(dispatch_bwd(in_dtype, w_dtype, p, a, b * h,
                                       static_cast<cudaStream_t>(stream)));
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
