// K4 and K5: the fused RMSNorm forward and backward for Hopper (sm_90a),
// plain C interface.
//
// K4 replaces src/repro/kernels/rmsnorm.py:_fwd_kernel (launched by
// _forward): for x (rows, D) in bf16 or fp32 and an fp32 scale (D,), it
// writes rinv = 1 / sqrt(mean(x^2) + eps) per row in fp32 and
// out = x * rinv * scale in x's dtype. K5 replaces _bwd_kernel (launched by
// _backward): from x, scale, the saved fp32 rinv and dy it writes
//   dx = rinv * (dy*s) - rinv^3 / D * x * rowsum(dy*s*x)   in x's dtype,
//   dscale = sum over rows of dy * x * rinv                 in fp32.
//
// What bounds them on an H100 SXM: at the dense-decoder shape (rows 4096 =
// micro-batch 4 x seq 1024, D 4096, bf16) K4 must read x and write out once
// (2 x 33.6 MB, plus 16 KB each of scale and rinv), 67.1 MB or 20.0 us at
// 3.35 TB/s; K5 must read x and dy and write dx (100.7 MB), 30.0 us. Their
// few operations per element (about 4 and 10) take under 2 us on the fp32
// CUDA cores: both are bound by the bytes.
//
// What this design does about it. K4: one CTA per row; each thread loads
// 16-byte vectors of its row (8 bf16 or 4 fp32 elements, with a scalar tail
// when D is not a multiple or a row is not 16-byte aligned), sums squares in
// fp32 with warp shuffles and then across warps in shared memory, and
// re-reads its vectors for the output (the row's 8 KB is still in L1).
// K5: the TPU kernel sums dscale across a sequential grid in a VMEM scratch
// accumulator; CTAs on a GPU run in no order, so each CTA takes a fixed
// block of rows, writes its fp32 column partials of dy*x*rinv to an fp32
// (n_blocks, D) workspace, and a second small launch sums the workspace
// over the blocks in a fixed order. There are no atomics: the sums are
// taken in the same order on every run, so dscale repeats bit for bit. The
// number of blocks depends only on the shape (the wrapper's choice), not on
// the card. Rows past the end are never visited, as vjp.row_valid masks
// them. Row strides are passed in; the last dimension is contiguous.
// The row pass keeps the memory pipe busy: each thread owns fixed columns
// of every row (16-byte units of 8 bf16 or 4 fp32), whose scale and dscale
// partials stay in its registers for the whole CTA; it reads each row's x
// and dy once, into registers, from which it computes both the row's dot
// and dx; the next row's loads are issued before the current row is
// reduced and written; and the row's reduction takes one barrier (the warp
// sums alternate between two buffers). A CTA holds 512 threads at D 4096
// in bf16 (63 registers), two to an SM, so 32 warps per SM keep loads in
// flight; at the decoder's shape it takes 16 rows, and its 256 CTAs run in
// one wave on 132 SMs (512 CTAs of 8 rows run in two waves with twice the
// workspace, and are slower: scripts/rmsnorm_timing.py times both).
//
// The split row (tensor parallelism's Mamba2 inner norm, whose row of
// width W is spread over the ranks of a model group, each holding D = W/M
// columns): the row's statistic needs every rank's columns, so each pass
// that K4 and K5 take over a whole row is cut in two around an all-reduce
// that the caller makes between the launches.
//   forward:  rmsnorm_rowdot_kernel<T, false> writes each row's fp32 sum of
//             squares over its D columns; [all-reduce]; K4 in its SPLIT
//             mode reads the whole row's sum instead of taking it, with
//             rinv = 1 / sqrt(sum / W + eps), and writes out and rinv.
//   backward: rmsnorm_rowdot_kernel<T, true> writes each row's fp32
//             rowsum(dy*s*x) over its D columns; [all-reduce]; K5's row
//             pass in its SPLIT mode reads that whole-row sum instead of
//             taking it (no per-row block reduction, no barrier) with
//             1 / W for 1 / D; dscale over the D columns is K5's, its
//             fixed-order reduction unchanged.
// Each pass is bound by its bytes, as K4 and K5 are; the partial passes
// read x (and dy) once more, and the partials add 8 bytes a row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 256;
constexpr int RED_COLS = 32;     // dscale reduce: columns per CTA
constexpr int RED_GROUPS = 8;    // dscale reduce: block groups per column

template <typename T> struct VecOf;
template <> struct VecOf<float> { static constexpr int N = 4; };
template <> struct VecOf<__nv_bfloat16> { static constexpr int N = 8; };

__device__ __forceinline__ void load_vec(const float* p, float (&x)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// K5's 16-byte units, held in registers, as fp32: 4 fp32 or 8 bf16 values.
__device__ __forceinline__ void unpack(const uint4& u, float (&x)[4]) {
  x[0] = __uint_as_float(u.x); x[1] = __uint_as_float(u.y);
  x[2] = __uint_as_float(u.z); x[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void unpack(const uint4& u, float (&x)[8]) {
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store_vec(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&x)[8]) {
  uint4 u;
  __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h2[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

template <int N>
__device__ __forceinline__ void load_scale(const float* p, float (&s)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 a = *reinterpret_cast<const float4*>(p + i);
    s[i] = a.x; s[i + 1] = a.y; s[i + 2] = a.z; s[i + 3] = a.w;
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The sum of v over the CTA, the same value in every thread: each thread
// adds the warp partials in warp order, so the result does not depend on
// timing.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  __syncthreads();                    // red may still be read from last call
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
  for (int i = 0; i < nw; ++i) t += red[i];
  return t;
}

// block_sum with one barrier, for a loop of sums: successive calls
// alternate between two buffers red (a float per warp each), so that one
// call's writes cannot race with the reads of the call before.
__device__ __forceinline__ float block_sum_alternating(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
  for (int i = 0; i < static_cast<int>(blockDim.x >> 5); ++i) t += red[i];
  return t;
}

// K4: one CTA per row. vec: every row start and the scale are 16-byte
// aligned, so the first (D / N) * N elements move as 16-byte vectors.
// SPLIT: the row's sum of squares is the whole row's, read from sumsq, and
// the mean is over its width W, not D.
template <typename T, bool SPLIT>
__global__ void __launch_bounds__(MAX_THREADS) rmsnorm_fwd_kernel(
    const T* __restrict__ x, const float* __restrict__ scale,
    T* __restrict__ out, float* __restrict__ rinv, int d, long long x_rs,
    long long o_rs, float eps, int vec, const float* __restrict__ sumsq,
    float width) {
  constexpr int N = VecOf<T>::N;
  __shared__ float red[MAX_THREADS / 32];
  const long long row = blockIdx.x;
  const T* xr = x + row * x_rs;
  T* orow = out + row * o_rs;
  const int nvec = vec ? d / N : 0;

  float r;
  if constexpr (SPLIT) {
    r = 1.f / sqrtf(sumsq[row] / width + eps);
  } else {
    float ss = 0.f;
    for (int j = threadIdx.x; j < nvec; j += blockDim.x) {
      float v[N];
      load_vec(xr + j * N, v);
#pragma unroll
      for (int i = 0; i < N; ++i) ss += v[i] * v[i];
    }
    for (int c = nvec * N + threadIdx.x; c < d; c += blockDim.x) {
      const float v = to_f32(xr[c]);
      ss += v * v;
    }
    ss = block_sum(ss, red);
    // 1 / sqrt, not rsqrtf: the reference divides by sqrt
    r = 1.f / sqrtf(ss / static_cast<float>(d) + eps);
  }
  if (threadIdx.x == 0) rinv[row] = r;

  for (int j = threadIdx.x; j < nvec; j += blockDim.x) {
    float v[N], s[N];
    load_vec(xr + j * N, v);
    load_scale<N>(scale + j * N, s);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = (v[i] * r) * s[i];
    store_vec(orow + j * N, v);
  }
  for (int c = nvec * N + threadIdx.x; c < d; c += blockDim.x)
    put(orow + c, (to_f32(xr[c]) * r) * scale[c]);
}

// The split row's partial pass: one CTA per row, out[row] = the fp32 sum
// over the row's D columns of x * x (forward, BWD false) or (dy * s) * x
// (backward), each thread's share then the CTA's in a fixed order.
template <typename T, bool BWD>
__global__ void __launch_bounds__(MAX_THREADS) rmsnorm_rowdot_kernel(
    const T* __restrict__ x, const float* __restrict__ scale,
    const T* __restrict__ dy, float* __restrict__ out, int d, long long x_rs,
    long long dy_rs, int vec) {
  constexpr int N = VecOf<T>::N;
  __shared__ float red[MAX_THREADS / 32];
  const long long row = blockIdx.x;
  const T* xr = x + row * x_rs;
  const int nvec = vec ? d / N : 0;

  float acc = 0.f;
  for (int j = threadIdx.x; j < nvec; j += blockDim.x) {
    float v[N];
    load_vec(xr + j * N, v);
    if constexpr (BWD) {
      float g[N], s[N];
      load_vec(dy + row * dy_rs + j * N, g);
      load_scale<N>(scale + j * N, s);
#pragma unroll
      for (int i = 0; i < N; ++i) acc += (g[i] * s[i]) * v[i];
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) acc += v[i] * v[i];
    }
  }
  for (int c = nvec * N + threadIdx.x; c < d; c += blockDim.x) {
    const float v = to_f32(xr[c]);
    if constexpr (BWD)
      acc += (to_f32(dy[row * dy_rs + c]) * scale[c]) * v;
    else
      acc += v * v;
  }
  acc = block_sum(acc, red);
  if (threadIdx.x == 0) out[row] = acc;
}

// K5's staging: unit j of a row is its columns [j N, j N + N), kept raw (16
// bytes: 8 bf16 or 4 fp32) until used. It loads as one 16-byte vector when
// vec and it lies inside the row, else by scalars, the columns past D as 0.
template <typename T>
__device__ __forceinline__ uint4 load_unit(const T* row, int j, int d,
                                           int vec) {
  constexpr int N = VecOf<T>::N;
  const int c0 = j * N;
  if (vec && c0 + N <= d) return *reinterpret_cast<const uint4*>(row + c0);
  uint4 u = make_uint4(0u, 0u, 0u, 0u);
  T* e = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (c0 + i < d) e[i] = row[c0 + i];
  return u;
}

template <typename T, int N>
__device__ __forceinline__ void store_unit(T* row, int j, int d, int vec,
                                           const float (&x)[N]) {
  const int c0 = j * N;
  if (vec && c0 + N <= d) {
    store_vec(row + c0, x);
    return;
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (c0 + i < d) put(row + c0 + i, x[i]);
}

// K5, first launch: CTA b takes rows [b * rows_per_block, +rows_per_block)
// and writes its dscale partial to ws[b, :]. Thread t owns the units t +
// blockDim.x m (m < M) of every row: their scale and dscale partials stay
// in its registers, each row's x and dy are read once into registers, and
// the next row's loads are issued before the current row is reduced.
// SPLIT: each row's rowsum(dy*s*x) is the whole row's, read from dots, and
// the row's width is W, not D.
template <typename T, int M, bool SPLIT>
__global__ void __launch_bounds__(M == 8 ? 1024 : 512, M == 1 ? 2 : 1)
    rmsnorm_bwd_kernel(const T* __restrict__ x,
                       const float* __restrict__ scale,
                       const float* __restrict__ rinv,
                       const T* __restrict__ dy, T* __restrict__ dx,
                       float* __restrict__ ws, long long rows, int d,
                       long long x_rs, long long dy_rs, long long dx_rs,
                       int rows_per_block, int vec,
                       const float* __restrict__ dots, float width) {
  constexpr int N = VecOf<T>::N;
  __shared__ float red[2][32];
  const float dinv = SPLIT ? 1.f / width : 1.f / static_cast<float>(d);
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long r1 = min(rows, r0 + rows_per_block);

  float s[M][N], acc[M][N];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int c0 = (threadIdx.x + blockDim.x * m) * N;
    if (vec && c0 + N <= d) {
      load_scale<N>(scale + c0, s[m]);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) s[m][i] = c0 + i < d ? scale[c0 + i] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) acc[m][i] = 0.f;
  }

  // this row's x and dy (cx, cg) and the next row's, in flight (nx, ng)
  uint4 cx[M], cg[M], nx[M], ng[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int j = threadIdx.x + blockDim.x * m;
    cx[m] = load_unit(x + r0 * x_rs, j, d, vec);
    cg[m] = load_unit(dy + r0 * dy_rs, j, d, vec);
  }
  float rv = rinv[r0], nrv = 0.f;
  float dv = 0.f, ndv = 0.f;
  if constexpr (SPLIT) dv = dots[r0];
  for (long long row = r0; row < r1; ++row) {
    if (row + 1 < r1) {
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int j = threadIdx.x + blockDim.x * m;
        nx[m] = load_unit(x + (row + 1) * x_rs, j, d, vec);
        ng[m] = load_unit(dy + (row + 1) * dy_rs, j, d, vec);
      }
      nrv = rinv[row + 1];
      if constexpr (SPLIT) ndv = dots[row + 1];
    }
    float xv[M][N], g[M][N];
    float dot = 0.f;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      unpack(cx[m], xv[m]);
      unpack(cg[m], g[m]);
      if constexpr (!SPLIT) {
#pragma unroll
        for (int i = 0; i < N; ++i) dot += (g[m][i] * s[m][i]) * xv[m][i];
      }
    }
    if constexpr (SPLIT)
      dot = dv;
    else
      dot = block_sum_alternating(dot, red[(row - r0) & 1]);

    const float a = rv * rv * rv * dinv;
    T* dr = dx + row * dx_rs;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      float o[N];
#pragma unroll
      for (int i = 0; i < N; ++i) {
        o[i] = rv * (g[m][i] * s[m][i]) - (a * xv[m][i]) * dot;
        acc[m][i] += (g[m][i] * xv[m][i]) * rv;
      }
      store_unit(dr, threadIdx.x + blockDim.x * m, d, vec, o);
      cx[m] = nx[m];
      cg[m] = ng[m];
    }
    rv = nrv;
    dv = ndv;
  }

  float* wr = ws + static_cast<long long>(blockIdx.x) * d;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int c0 = (threadIdx.x + blockDim.x * m) * N;
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (c0 + i < d) wr[c0 + i] = acc[m][i];
  }
}

// K5, second launch: dscale[c] = sum over b of ws[b, c], in a fixed order.
// Thread (g, col) sums blocks g, g + RED_GROUPS, ... in turn; then group 0
// adds the RED_GROUPS partial sums in group order.
__global__ void __launch_bounds__(RED_COLS * RED_GROUPS) dscale_reduce_kernel(
    const float* __restrict__ ws, float* __restrict__ dscale, int n_blocks,
    int d) {
  __shared__ float part[RED_GROUPS][RED_COLS + 1];
  const int col = threadIdx.x % RED_COLS, g = threadIdx.x / RED_COLS;
  const int c = blockIdx.x * RED_COLS + col;
  float t = 0.f;
  if (c < d)
    for (int b = g; b < n_blocks; b += RED_GROUPS)
      t += ws[static_cast<long long>(b) * d + c];
  part[g][col] = t;
  __syncthreads();
  if (g == 0 && c < d) {
    float s = 0.f;
    for (int k = 0; k < RED_GROUPS; ++k) s += part[k][col];
    dscale[c] = s;
  }
}

// Threads per CTA: the smallest power of two from 32 to MAX_THREADS that
// gives every thread at most one vector of a row, if there is one.
int threads_for(int d, int n) {
  const int units = (d + n - 1) / n;
  int nt = 32;
  while (nt < MAX_THREADS && nt < units) nt *= 2;
  return nt;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// sumsq, width: the split row's whole-row sums of squares and width (K4's
// SPLIT mode) when sumsq is given, else the whole-row K4
template <typename T>
cudaError_t launch_fwd(const void* x, const float* scale, void* out,
                       float* rinv, long long rows, int d, long long x_rs,
                       long long o_rs, float eps, const float* sumsq,
                       float width, cudaStream_t stream) {
  constexpr int N = VecOf<T>::N;
  const int vec = aligned16(x) && aligned16(out) && aligned16(scale) &&
                  x_rs % N == 0 && o_rs % N == 0;
  auto kernel = sumsq ? rmsnorm_fwd_kernel<T, true>
                      : rmsnorm_fwd_kernel<T, false>;
  kernel<<<static_cast<unsigned>(rows), threads_for(d, N), 0, stream>>>(static_cast<const T*>(x), scale, static_cast<T*>(out), rinv, d, x_rs, o_rs, eps, vec, sumsq, width);
  return cudaGetLastError();
}

// the split row's partial pass: Σ x*x per row, or Σ (dy*s)*x with dy
template <typename T>
cudaError_t launch_rowdot(const void* x, const float* scale, const void* dy,
                          float* out, long long rows, int d, long long x_rs,
                          long long dy_rs, cudaStream_t stream) {
  constexpr int N = VecOf<T>::N;
  const int vec = aligned16(x) && x_rs % N == 0 &&
                  (!dy || (aligned16(dy) && aligned16(scale) &&
                           dy_rs % N == 0));
  auto kernel = dy ? rmsnorm_rowdot_kernel<T, true>
                   : rmsnorm_rowdot_kernel<T, false>;
  kernel<<<static_cast<unsigned>(rows), threads_for(d, N), 0, stream>>>(static_cast<const T*>(x), scale, static_cast<const T*>(dy), out, d, x_rs, dy_rs, vec);
  return cudaGetLastError();
}

template <typename T, int M, bool SPLIT>
cudaError_t launch_bwd_rows(const void* x, const float* scale,
                            const float* rinv, const void* dy, void* dx,
                            float* ws, long long rows, int d, long long x_rs,
                            long long dy_rs, long long dx_rs,
                            int rows_per_block, int n_blocks, int nt, int vec,
                            const float* dots, float width,
                            cudaStream_t stream) {
  rmsnorm_bwd_kernel<T, M, SPLIT><<<n_blocks, nt, 0, stream>>>(static_cast<const T*>(x), scale, rinv, static_cast<const T*>(dy), static_cast<T*>(dx), ws, rows, d, x_rs, dy_rs, dx_rs, rows_per_block, vec, dots, width);
  return cudaGetLastError();
}

template <typename T, bool SPLIT>
auto bwd_rows_launcher(int m) {
  return m == 1 ? launch_bwd_rows<T, 1, SPLIT>
       : m == 2 ? launch_bwd_rows<T, 2, SPLIT>
       : m == 4 ? launch_bwd_rows<T, 4, SPLIT>
                : launch_bwd_rows<T, 8, SPLIT>;
}

// dots, width: the split row's whole-row sums rowsum(dy*s*x) and width
// (K5's SPLIT mode) when dots is given, else the whole-row K5
template <typename T>
cudaError_t launch_bwd(const void* x, const float* scale, const float* rinv,
                       const void* dy, void* dx, float* ws, float* dscale,
                       long long rows, int d, long long x_rs, long long dy_rs,
                       long long dx_rs, int rows_per_block, int n_blocks,
                       const float* dots, float width, cudaStream_t stream) {
  constexpr int N = VecOf<T>::N;
  const int vec = aligned16(x) && aligned16(dy) && aligned16(dx) &&
                  aligned16(scale) && x_rs % N == 0 && dy_rs % N == 0 &&
                  dx_rs % N == 0;
  // units a thread: the fewest of 1, 2, 4, 8 that keep a CTA within 512
  // threads (1024 at 8, which D <= 32768 always allows)
  const int units = (d + N - 1) / N;
  int m = 1;
  while (m < 8 && (units + m - 1) / m > 512) m *= 2;
  const int nt = ((units + m - 1) / m + 31) / 32 * 32;
  auto rows_launch = dots ? bwd_rows_launcher<T, true>(m)
                          : bwd_rows_launcher<T, false>(m);
  cudaError_t err = rows_launch(x, scale, rinv, dy, dx, ws, rows, d, x_rs,
                                dy_rs, dx_rs, rows_per_block, n_blocks, nt,
                                vec, dots, width, stream);
  if (err != cudaSuccess) return err;
  dscale_reduce_kernel<<<(d + RED_COLS - 1) / RED_COLS,
                         RED_COLS * RED_GROUPS, 0, stream>>>(ws, dscale,
                                                             n_blocks, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, out, dy, dx); scale, rinv, ws and
// dscale are float32. Row strides are in elements; the last dimension of
// every tensor is contiguous. Each returns a cudaError_t (0 = ok).
int repro_rmsnorm_fwd(int dtype, const void* x, const void* scale, void* out,
                      void* rinv, long long rows, int d, long long x_rs,
                      long long o_rs, float eps, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(scale);
  float* r = static_cast<float*>(rinv);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16>(x, s, out, r, rows, d, x_rs, o_rs, eps,
                                     nullptr, 0.f, st);
  return launch_fwd<float>(x, s, out, r, rows, d, x_rs, o_rs, eps, nullptr,
                           0.f, st);
}

// ws is float32 (n_blocks, D) scratch; CTA b covers rows
// [b * rows_per_block, min(rows, (b + 1) * rows_per_block)).
int repro_rmsnorm_bwd(int dtype, const void* x, const void* scale,
                      const void* rinv, const void* dy, void* dx, void* ws,
                      void* dscale, long long rows, int d, long long x_rs,
                      long long dy_rs, long long dx_rs, int rows_per_block,
                      int n_blocks, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(scale);
  const float* r = static_cast<const float*>(rinv);
  float* w = static_cast<float*>(ws);
  float* ds = static_cast<float*>(dscale);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(x, s, r, dy, dx, w, ds, rows, d, x_rs,
                                     dy_rs, dx_rs, rows_per_block, n_blocks,
                                     nullptr, 0.f, st);
  return launch_bwd<float>(x, s, r, dy, dx, w, ds, rows, d, x_rs, dy_rs,
                           dx_rs, rows_per_block, n_blocks, nullptr, 0.f,
                           st);
}

// The split row's partial pass: out (rows,) fp32 gets each row's Σ x*x over
// its d columns when dy is null (the forward's), else Σ (dy*scale)*x (the
// backward's).
int repro_rmsnorm_rowdot(int dtype, const void* x, const void* scale,
                         const void* dy, void* out, long long rows, int d,
                         long long x_rs, long long dy_rs, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(scale);
  float* o = static_cast<float*>(out);
  if (dtype == 1)
    return launch_rowdot<__nv_bfloat16>(x, s, dy, o, rows, d, x_rs, dy_rs,
                                        st);
  return launch_rowdot<float>(x, s, dy, o, rows, d, x_rs, dy_rs, st);
}

// K4's split-row mode: sumsq (rows,) fp32 is the whole row's sum of
// squares, width the whole row's width.
int repro_rmsnorm_fwd_split(int dtype, const void* x, const void* scale,
                            const void* sumsq, void* out, void* rinv,
                            long long rows, int d, long long x_rs,
                            long long o_rs, float width, float eps,
                            void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(scale);
  const float* ss = static_cast<const float*>(sumsq);
  float* r = static_cast<float*>(rinv);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16>(x, s, out, r, rows, d, x_rs, o_rs, eps,
                                     ss, width, st);
  return launch_fwd<float>(x, s, out, r, rows, d, x_rs, o_rs, eps, ss, width,
                           st);
}

// K5's split-row mode: dots (rows,) fp32 is the whole row's
// rowsum(dy*scale*x), width the whole row's width.
int repro_rmsnorm_bwd_split(int dtype, const void* x, const void* scale,
                            const void* rinv, const void* dy,
                            const void* dots, void* dx, void* ws,
                            void* dscale, long long rows, int d,
                            long long x_rs, long long dy_rs, long long dx_rs,
                            float width, int rows_per_block, int n_blocks,
                            void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(scale);
  const float* r = static_cast<const float*>(rinv);
  const float* dt = static_cast<const float*>(dots);
  float* w = static_cast<float*>(ws);
  float* ds = static_cast<float*>(dscale);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(x, s, r, dy, dx, w, ds, rows, d, x_rs,
                                     dy_rs, dx_rs, rows_per_block, n_blocks,
                                     dt, width, st);
  return launch_bwd<float>(x, s, r, dy, dx, w, ds, rows, d, x_rs, dy_rs,
                           dx_rs, rows_per_block, n_blocks, dt, width, st);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
