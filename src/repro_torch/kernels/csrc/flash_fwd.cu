// K1: flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces src/repro/kernels/flash_attention.py:_fwd_kernel, the Pallas TPU
// kernel that _forward launches. For q (B,H,S,D) and k/v (B,KH,T,D), with
// GQA (kv_head = h / (H/KH)), it computes O = softmax(mask(Q K^T D^-0.5)) V
// in q's dtype and the fp32 row logsumexp lse (B,H,S), under the causal
// mask, a static sliding window and the ragged edges of S and T. A row with
// no live key gets O = 0 and lse = 2**30, so a backward's exp(s - lse) is 0.
//
// What bounds it on an H100 SXM: at the ViT-B/16 eval shape (B=128, H=12,
// S=T=197, D=64, bf16) the function must move q, k, v and o once (4 x 38.7
// MB) and the fp32 lse (1.2 MB), 156.1 MB or 46.6 us at 3.35 TB/s; its two
// products are 4*B*H*S*T*D = 15.3 GFLOP, 15.4 us at the 989 TFLOP/s bf16
// tensor-core peak. The bytes bound it, by a factor of three.
//
// What this design does about it: each CTA reads its q tile once and each
// K/V tile once (the 4 q tiles of one head re-read K/V from L2, not HBM),
// writes O and lse once, and keeps the S x T scores and probabilities in
// registers and shared memory only. The arithmetic runs on the fp32 CUDA
// cores with fp32 probabilities, as the TPU kernel's fp32 upcast does, not
// on the tensor cores: this first version is bound by fp32 FMA issue, well
// above the memory bound. wgmma, TMA and warp specialisation are later work.
//
// Layout: one CTA of 128 threads per (64-row q tile, head, batch). Thread t
// owns query rows 4*(t/8) .. +3 of the tile; for the scores it owns keys
// (t%8) + 8j of each 64-key tile, and for O the float4 column groups
// (t%8) + 8jj. The 8 threads that share rows are neighbouring lanes, so row
// max and row sum reduce with three xor shuffles. Tiles are staged in
// shared memory as fp32; Q and K rows are padded by 4 floats so that the
// eight column groups read eight rows at once without bank conflicts.
// Element strides are passed in, so the caller can hand in the model's
// (B,S,H,D) layout as a (B,H,S,D) view without a transposing copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;    // query rows per CTA
constexpr int BN = 64;    // keys per K/V tile (the loader assumes BN == BM)
constexpr int NT = 128;   // threads per CTA: 16 row groups x 8 column groups
constexpr float NEG_INF = -1073741824.0f;   // -2**30, the reference's mask
constexpr float LSE_BIG = 1073741824.0f;    // lse of a fully-masked row

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

// Stage a 64-row tile of width D as fp32 in shared memory (row stride ld_s),
// from global rows ld_g elements apart. Rows at `rows` and beyond are zero:
// a masked probability is exactly 0, and 0 * NaN from stale memory would
// poison the sums (the guard at flash_attention.py:262-263).
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int ld_s, const T* src,
                                          long long ld_g, int rows) {
  constexpr int CPR = D / 8;   // 8-element chunks per row
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
    float4* d4 = reinterpret_cast<float4*>(dst + r * ld_s + col);
    d4[0] = make_float4(x[0], x[1], x[2], x[3]);
    d4[1] = make_float4(x[4], x[5], x[6], x[7]);
  }
}

template <int D>
constexpr int smem_bytes() {
  return (BM * (D + 4) + BN * (D + 4) + BN * D + BM * (BN + 4)) *
         static_cast<int>(sizeof(float));
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(const Params p) {
  constexpr int LDQ = D + 4;   // padded Q/K row stride (floats)
  constexpr int LDP = BN + 4;  // padded P row stride
  constexpr int DV = D / 32;   // float4 column groups of O per thread
  extern __shared__ float4 smem_f4[];
  float* Qs = reinterpret_cast<float*>(smem_f4);
  float* Ks = Qs + BM * LDQ;
  float* Vs = Ks + BN * LDQ;
  float* Ps = Vs + BN * D;

  const int q0 = blockIdx.x * BM;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int kvh = hh / (p.h / p.kh);
  const T* qg = static_cast<const T*>(p.q) + bb * p.q_sb + hh * p.q_sh +
                q0 * p.q_ss;
  const T* kg = static_cast<const T*>(p.k) + bb * p.k_sb + kvh * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + bb * p.v_sb + kvh * p.v_sh;

  load_tile<T, D>(Qs, LDQ, qg, p.q_ss, min(BM, p.s - q0));

  const int tid = threadIdx.x;
  const int r0 = (tid >> 3) * 4;
  const int cg = tid & 7;

  float m[4], l[4], acc[4][4 * DV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * DV; ++c) acc[i][c] = 0.f;
  }

  // the key tiles this q tile can see: keys k <= q for causal, and
  // q - k < window, with q in [q0, q0 + BM)
  int k_lo = 0, k_hi = p.t;
  if (p.causal) k_hi = min(k_hi, q0 + BM);
  if (p.window > 0) k_lo = max(0, q0 - p.window + 1);
  k_lo -= k_lo % BN;

  for (int kt = k_lo; kt < k_hi; kt += BN) {
    __syncthreads();   // every thread is done with the previous tile
    const int kv_rows = min(BN, p.t - kt);
    load_tile<T, D>(Ks, LDQ, kg + kt * p.k_ss, p.k_ss, kv_rows);
    load_tile<T, D>(Vs, D, vg + kt * p.v_ss, p.v_ss, kv_rows);
    __syncthreads();

    // scores of rows r0+i against keys kt + cg + 8j
    float sc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D; kk += 4) {
      float4 qa[4], kb[8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(Qs + (r0 + i) * LDQ + kk);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        kb[j] = *reinterpret_cast<const float4*>(Ks + (cg + 8 * j) * LDQ + kk);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
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
      for (int j = 0; j < 8; ++j) {
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
      for (int j = 0; j < 8; ++j) {
        const float pij = ((live >> j) & 1u) ? expf(sc[i][j] - m_new) : 0.f;
        Ps[(r0 + i) * LDP + cg + 8 * j] = pij;
        rs += pij;
      }
      rs = row_sum8(rs);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * DV; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // O += P V: rows r0+i, float4 column groups cg + 8jj
#pragma unroll 2
    for (int n = 0; n < BN; n += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(Ps + (r0 + i) * LDP + n);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vrow = Vs + (n + u) * D;
#pragma unroll
        for (int jj = 0; jj < DV; ++jj) {
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
      for (int jj = 0; jj < DV; ++jj)
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

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();   // above 48 KB for D >= 64
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.s + BM - 1) / BM, p.h, p.b);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const Params& p, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the last
// dimension of every tensor is contiguous. Returns a cudaError_t (0 = ok).
int repro_flash_fwd(int dtype, int d, const void* q, const void* k,
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(dispatch_d<float>(d, p, st));
  if (dtype == 1) return static_cast<int>(dispatch_d<__nv_bfloat16>(d, p, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
