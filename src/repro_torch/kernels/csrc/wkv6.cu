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
// K7 replaces _bwd_kernel (launched by _backward): it walks the chunks in
// reverse and carries G = dLoss/dS_out in fp32 from dS_end,
//   G_in = (r e^lprev)^T dO + e^L_end G,
// and writes dr, dk, dv, dwlog in their primals' dtypes, dS0 (B,H,P,P) fp32
// and du as fp32 (B,H,P) partials that the wrapper sums over B (no atomics,
// so du and dS0 repeat bit for bit).
//
// What bounds them on an H100 SXM: at the RWKV6-7B training shape (micro-
// batch 4, S 1024, H 64, P 64, chunk 32; r/k/v bf16, wlog fp32) K6 with
// states must move r/k/v (3 x 33.6 MB), wlog and o (67.1 MB each), the
// states (134.2 MB) and s0/s_end (4.2 MB each): about 378 MB, 0.113 ms at
// 3.35 TB/s. Its products (4 cs P^2 per chunk for the state, about as much
// again for the pairwise decays) are about 6 GFLOP of fp32, 0.09 ms at
// 67 TFLOP/s: the bytes bound it, narrowly. K7 moves about 545 MB (the
// states and fp32 dO on top), 0.16 ms, and does about twice K6's work.
//
// What this design does about it: one CTA of 256 threads per (b, h), which
// walks the chunks in a loop (the TPU kernel's sequential grid axis) with
// the state in shared memory; every input is read once and every output
// written once. Per chunk the r/k/v/w (and dO) tiles are staged as fp32 in
// shared memory. The (cs, cs, P) pairwise-decay tensor of the TPU kernel
// (256 KB at cs 32, P 64, more than a CTA's shared memory) is never built:
// exp(lprev_t - L_j) is recomputed where it is used, over the live triangle
// j < t only, where the exponent is <= 0 and nothing can overflow under any
// decay (the min(., 0) guards the last rounding). In K7 the reference's E
// tensor folds away, dlprev_pair = r dr_att and dL_pair = -k dk_att, so two
// passes (one over j for each (t, p), one over t for each (j, p)) give every
// pairwise adjoint. K7 writes the new G to a second buffer, so the reads of
// the old G (dv, dkadv, dl_end) need no ordering against it. The arithmetic
// is scalar fp32 on the CUDA cores: the chunk loop is serial per (b, h) and
// the grid is only 256 CTAs (about two waves on 132 SMs), so this first
// version is far above its bound; tensor cores and splitting a (b, h) over
// more CTAs are later work. Element strides of the model's (B,S,H,P)
// tensors are passed in; the last dimension is contiguous. expf, not
// __expf: the build passes no fast-math flag.

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
  float* du;            // (B,H,P) partials
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

// K7: one CTA per (b, h), the chunks in reverse.
template <typename TI, typename TW, int P>
__global__ void __launch_bounds__(NT) wkv6_bwd_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  constexpr int LD = P + 1;
  constexpr int G = NT / P;
  const int cs = a.cs, tile = cs * P;
  const int bh = blockIdx.x, bb = bh / a.h, hh = bh % a.h;
  const int col = threadIdx.x % P, grp = threadIdx.x / P;
  const int nc = a.s / cs;
  float* sr = smem;
  float* sk = sr + tile;
  float* sv = sk + tile;
  float* slp = sv + tile;            // w, then lprev
  float* sL = slp + tile;
  float* sdo = sL + tile;
  float* srd = sdo + tile;           // r e^lprev
  float* ska = srd + tile;           // k e^(L_end - L)
  float* sdlp = ska + tile;          // dLoss/dlprev
  float* sdLt = sdlp + tile;         // dL_pair - dkadv kadv
  float* sdkk = sdLt + tile;         // dkadv kadv
  float* sS = sdkk + tile;           // entering state (P, P + 1)
  float* sG = sS + P * LD;           // dLoss/dS_out (P, P + 1)
  float* sGn = sG + P * LD;          // dLoss/dS_in (P, P + 1)
  float* sdA = sGn + P * LD;         // (cs, cs)
  float* satt = sdA + cs * cs;       // (cs, cs)
  float* sdiag = satt + cs * cs;     // (cs)
  float* sdov = sdiag + cs;          // (cs)
  float* slend = sdov + cs;          // (P)
  float* su = slend + P;             // (P)

  for (int p = threadIdx.x; p < P; p += NT) su[p] = a.u[hh * P + p];
  load_pp<P>(sG, a.ds_end + static_cast<long long>(bh) * P * P);
  float du = 0.f;                    // column threadIdx.x < P
  const long long out_row = static_cast<long long>(a.h) * P;

  for (int c = nc - 1; c >= 0; --c) {
    const long long row0 = static_cast<long long>(c) * cs;
    load_tile<TI, P>(sr, a.r, a.sr, bb, hh, row0, cs);
    load_tile<TI, P>(sk, a.k, a.sk, bb, hh, row0, cs);
    load_tile<TI, P>(sv, a.v, a.sv, bb, hh, row0, cs);
    load_tile<TW, P>(slp, a.w, a.sw, bb, hh, row0, cs);
    load_tile<float, P>(sdo, a.dout, a.sdo, bb, hh, row0, cs);
    load_pp<P>(sS, a.states + (static_cast<long long>(bh) * nc + c) * P * P);
    __syncthreads();
    decays<P>(slp, sL, slend, cs);
    __syncthreads();
    decayed<P>(srd, ska, sr, sk, slp, sL, slend, cs);
    pair_att<P>(satt, sr, sk, slp, sL, cs);
    {  // dA[t, j] = dO_t . v_j on j < t, one warp per pair
      const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
      for (int pr = warp; pr < cs * cs; pr += NWARP) {
        const int t = pr / cs, j = pr % cs;
        float acc = 0.f;
        if (j < t) {
#pragma unroll
          for (int q = lane; q < P; q += 32) acc += sdo[t * P + q] * sv[j * P + q];
          acc = warp_sum(acc);
        }
        if (lane == 0) sdA[pr] = acc;
      }
    }
    row_dots<P>(sdiag, sr, sk, su, cs);
    row_dots<P>(sdov, sdo, sv, nullptr, cs);
    __syncthreads();

    // dr and dk at (t, p = col); dlprev, dL_pair - dkadv kadv and
    // dkadv kadv for the decay gradients
    const long long base = (static_cast<long long>(bb) * a.s + row0) * out_row +
                           static_cast<long long>(hh) * P + col;
    for (int t = grp; t < cs; t += G) {
      const int p = col, i = t * P + p;
      const float lp = slp[i], Lt = sL[i];
      float dr_att = 0.f;
      for (int j = 0; j < t; ++j)
        dr_att += sdA[t * cs + j] * pair_decay(lp, sL[j * P + p]) *
                  sk[j * P + p];
      float dk_att = 0.f;
      for (int t2 = t + 1; t2 < cs; ++t2)
        dk_att += sdA[t2 * cs + t] * pair_decay(slp[t2 * P + p], Lt) *
                  sr[t2 * P + p];
      float drdec = 0.f, dkadv = 0.f;
#pragma unroll 16
      for (int q = 0; q < P; ++q) {
        drdec += sdo[t * P + q] * sS[p * LD + q];
        dkadv += sv[t * P + q] * sG[p * LD + q];
      }
      const float dov = sdov[t], up = su[p], rv = sr[i], kv = sk[i];
      const float dr = dr_att + drdec * expf(lp) + up * kv * dov;
      const float dk = dk_att + dkadv * expf(slend[p] - Lt) + up * rv * dov;
      put(static_cast<TI*>(a.dr) + base + t * out_row, dr);
      put(static_cast<TI*>(a.dk) + base + t * out_row, dk);
      const float kk = dkadv * ska[i];
      sdlp[i] = drdec * srd[i] + rv * dr_att;
      sdLt[i] = -kv * dk_att - kk;
      sdkk[i] = kk;
    }
    // dv at (j, q = col), and G_in into the second buffer
    for (int j = grp; j < cs; j += G) {
      float acc = 0.f;
      for (int t = j + 1; t < cs; ++t) acc += satt[t * cs + j] * sdo[t * P + col];
      float st = 0.f;
#pragma unroll 16
      for (int p = 0; p < P; ++p) st += ska[j * P + p] * sG[p * LD + col];
      put(static_cast<TI*>(a.dv) + base + j * out_row,
          acc + st + sdiag[j] * sdo[j * P + col]);
    }
    for (int p = grp; p < P; p += G) {
      float acc = 0.f;
      for (int t = 0; t < cs; ++t) acc += srd[t * P + p] * sdo[t * P + col];
      sGn[p * LD + col] = acc + expf(slend[p]) * sG[p * LD + col];
    }
    __syncthreads();

    // dwlog by the cumsum adjoint: a reverse scan down each column (the
    // threads < P, whose col is their p, so base addresses their column)
    if (threadIdx.x < P) {
      const int p = threadIdx.x;
      float sg = 0.f;
      for (int q = 0; q < P; ++q) sg += sS[p * LD + q] * sG[p * LD + q];
      float dl_end = 0.f;
      for (int j = 0; j < cs; ++j) dl_end += sdkk[j * P + p];
      dl_end += expf(slend[p]) * sg;
      float suffix = 0.f;
      for (int t = cs - 1; t >= 0; --t) {
        const int i = t * P + p;
        const float dlp = sdlp[i];
        float tot = sdLt[i] + dlp;
        if (t == cs - 1) tot += dl_end;
        suffix += tot;
        put(static_cast<TW*>(a.dw) + base + t * out_row, suffix - dlp);
        du += sr[i] * sk[i] * sdov[t];
      }
    }
    __syncthreads();
    float* tmp = sG;
    sG = sGn;
    sGn = tmp;
  }
  store_pp<P>(a.ds0 + static_cast<long long>(bh) * P * P, sG);
  if (threadIdx.x < P) a.du[static_cast<long long>(bh) * P + threadIdx.x] = du;
}

size_t fwd_smem(int p, int cs) {
  return sizeof(float) *
         (7 * cs * p + p * (p + 1) + cs * cs + cs + 2 * p);
}

size_t bwd_smem(int p, int cs) {
  return sizeof(float) *
         (11 * cs * p + 3 * p * (p + 1) + 2 * cs * cs + 2 * cs + 2 * p);
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

template <int P, typename Args>
cudaError_t dispatch_bwd(int in_dtype, int w_dtype, const Args& a,
                         int blocks, cudaStream_t st) {
  const size_t smem = bwd_smem(P, a.cs);
  using bf = __nv_bfloat16;
  if (in_dtype == 1 && w_dtype == 1)
    return launch(wkv6_bwd_kernel<bf, bf, P>, a, blocks, smem, st);
  if (in_dtype == 1)
    return launch(wkv6_bwd_kernel<bf, float, P>, a, blocks, smem, st);
  if (w_dtype == 1)
    return launch(wkv6_bwd_kernel<float, bf, P>, a, blocks, smem, st);
  return launch(wkv6_bwd_kernel<float, float, P>, a, blocks, smem, st);
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

// du is float32 (B,H,P) scratch: one partial per (b, h).
int repro_wkv6_bwd(int in_dtype, int w_dtype, int p, const void* r,
                   const void* k, const void* v, const void* w,
                   const void* u, const void* states, const void* dout,
                   const void* ds_end, void* dr, void* dk, void* dv, void* dw,
                   void* ds0, void* du, int b, int s, int h, int cs,
                   const long long* strides, void* stream) {
  BwdArgs a{r, k, v, w, static_cast<const float*>(u),
            static_cast<const float*>(states),
            static_cast<const float*>(dout),
            static_cast<const float*>(ds_end), dr, dk, dv, dw,
            static_cast<float*>(ds0), static_cast<float*>(du), h, s, cs,
            strides_at(strides, 0), strides_at(strides, 1),
            strides_at(strides, 2), strides_at(strides, 3),
            strides_at(strides, 4)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p == 32) return dispatch_bwd<32>(in_dtype, w_dtype, a, b * h, st);
  return dispatch_bwd<64>(in_dtype, w_dtype, a, b * h, st);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
