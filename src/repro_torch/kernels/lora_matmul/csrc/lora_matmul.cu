// Fused LoRA matmul for Hopper: y = x @ W + delta, one kernel template in two
// forms.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/lora_matmul/kernel.py:
//   * `_lora_kernel_grouped` / `lora_matmul_grouped`: a batch mixing adapters,
//     y[m] = x[m] @ W + scales[idx[m]] * (x[m] @ A[idx[m]]) @ B[idx[m]], which
//     the TPU kernel computes as x @ W + ((x @ A_cat) * mask) @ B_cat over the
//     adapters' factors concatenated on the rank axis (A_cat [K, G*r],
//     B_cat [G*r, N]); rows with idx[m] < 0 are the plain x @ W;
//   * `_lora_kernel` / `lora_matmul`: one adapter, y = x @ W + s * (x @ A) @ B,
//     the same template with G = 1, one scale and no index.
// x is [M, K], W [K, N], both row-major.  Accumulation is f32; the output is
// written in x's dtype.  Type combinations (x, W, factors): (f32, f32, f32)
// for the toy path and the text encoder, (f32, bf16, bf16) for the full-width
// MMDiT path, (bf16, bf16, bf16) for the bf16 kernel grid.
//
// Bound at the path's shape.  Every image-stream q/k/v/o projection of a
// mixed-tenant batch at full SD3 width (3 requests x CFG 2 x 4096 tokens:
// M = 24576, K = N = 1536, G = 2 adapters of rank 8) does
// 2*M*K*(N + 2*G*r) = 1.18e11 operations counting the masked product over all
// G*r columns as the TPU kernel computes it: 1.77 ms at the card's f32 rate
// outside the tensor cores (67 TFLOP/s on an H100 SXM).  It moves 0.31 GB
// (0.09 ms at 3.35 TB/s), so it is bound by operations.  This kernel computes
// each row only against its own adapter's rank block, which is what the run's
// data needs: 2*M*K*N + 2*(rows with an adapter)*r*(K + N) operations, 1.74 ms
// when two of the three requests carry an adapter.  The inputs are f32 and the
// path holds its results to f32, so the products run in f32 FMA on the CUDA
// cores with TF32 off; tensor-core tiles (wgmma, TMA) wait for a tolerance
// decision on TF32 or bf16.
//
// Design.  Each block owns one 128x128 output tile and loops over K itself in
// steps of 16 (the TPU kernel's sequential k grid axis becomes this loop); 256
// threads each hold an 8x8 register tile of x @ W, fed by float4 reads of a
// k-major x tile and a W tile in shared memory (4 shared loads per 64 FMAs).
// The tiles are double-buffered: each thread issues the next K step's global
// loads (16-byte loads where the rows are aligned) into registers before it
// computes the current step, and stores them into the other buffer after, so
// one barrier a step separates the two.  In the same loop the block
// accumulates x @ A for its rows: two threads a row, each reads the row's 16
// x values of the step once and sums them against every other rank column of
// the row's own adapter (a transposed A_cat tile, float4 reads over k), adding
// into an f32 [128, r] buffer in shared memory.  On the TPU the k axis runs in
// order, so `xa` is computed once per m tile on the first n sweep and reused;
// here blocks are independent, so every n tile recomputes it: 2*r/N, about 1 %
// more operations at the MMDiT shape (2 % if all G*r columns were computed).
// The epilogue reads each row's idx, scales its adapter's xa by scales[idx]
// and multiplies by B_cat's rank block for the tile's columns (read through
// the L1 cache: B_cat is 49 KB at the MMDiT shape); a row with idx < 0 adds
// nothing, so its result does not depend on the other rows' adapters.  A row
// whose idx is past the last adapter is written as NaN rather than read
// outside A_cat.  Ragged edges in M, K, N are masked (zero-filled tiles,
// guarded stores); G*r may be up to 256 (two stages and the [128, r] buffer
// then take 221 KB of shared memory).  The block allocates nothing and
// launches on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 16, NT = 256;
constexpr int LDX = BM + 4;   // k-major x tile row stride (float4-aligned)
constexpr int LDR = BK + 4;   // row-major x tile and transposed A tile stride
constexpr int kMaxRankCols = 256;
constexpr int kAStaged = 2;   // A_cat elements a thread stages per K step
static_assert(NT == 2 * BM && BM * BK == 8 * NT && BK * BN == 8 * NT,
              "each thread moves 8 x and 8 W elements, two threads a row");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// 8 consecutive elements at p as f32, `valid` of them in bounds (zeros
// past them); one or two 16-byte loads when `vec` says p is aligned
__device__ __forceinline__ void load8(const float* p, int valid, bool vec,
                                      float (&v)[8]) {
  if (vec && valid >= 8) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = i < valid ? p[i] : 0.f;
  }
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, int valid,
                                      bool vec, float (&v)[8]) {
  if (vec && valid >= 8) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = i < valid ? to_f32(p[i]) : 0.f;
  }
}

template <typename T>
__device__ __forceinline__ bool vec_ok(const T* p, int row_len) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         row_len % (16 / (int)sizeof(T)) == 0;
}

// this thread's i-th tile row (or column) of its 8: two runs of four
__device__ __forceinline__ int tile_pos(int t, int i) {
  return (i < 4 ? 0 : 64) + t * 4 + (i & 3);
}

// one stage of tiles: x^T [BK][LDX], W [BK][BN], x [BM][LDR], A_cat^T [GR][LDR]
__host__ __device__ inline int stage_floats(int gr) {
  return BK * LDX + BK * BN + BM * LDR + gr * LDR;
}

size_t smem_bytes(int gr, int r) {
  return sizeof(float) * (2 * (size_t)stage_floats(gr) + (size_t)BM * r) +
         sizeof(int) * BM;
}

template <typename TX, typename TW, typename TF, bool kGrouped>
__global__ void __launch_bounds__(NT, 2)
lora_matmul_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                   const TF* __restrict__ a, const TF* __restrict__ b,
                   const int* __restrict__ idx,
                   const float* __restrict__ scales, float scale,
                   TX* __restrict__ out, int M, int K, int N, int G, int R) {
  extern __shared__ float4 smem4[];
  const int GR = G * R;
  float* smem = reinterpret_cast<float*>(smem4);
  const int SF = stage_floats(GR);
  float* sXA = smem + 2 * SF;                      // [BM][R] x @ A, own block
  int* sIdx = reinterpret_cast<int*>(sXA + BM * R);

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  // what this thread moves each K step: 8 k of x row xr_row, 8 n of W row wk
  const int xr_row = tid >> 1, xr_k = (tid & 1) * 8;
  const int wk = tid >> 4, wn = (tid & 15) * 8;
  const bool x_vec = vec_ok(x, K), w_vec = vec_ok(w, N);
  const int xm = m0 + xr_row;

  for (int i = tid; i < BM; i += NT) {
    const int m = m0 + i;
    sIdx[i] = m < M ? (kGrouped ? idx[m] : 0) : -1;
  }
  for (int e = tid; e < BM * R; e += NT) sXA[e] = 0.f;

  // the K step at k0 into registers: global loads in flight while the
  // block computes the step before
  float xs[8], ws[8], as[kAStaged];
  auto fetch = [&](int k0) {
    load8(x + (size_t)xm * K + k0 + xr_k, xm < M ? K - k0 - xr_k : 0, x_vec,
          xs);
    const int kw = k0 + wk;
    load8(w + (size_t)kw * N + n0 + wn, kw < K ? N - n0 - wn : 0, w_vec, ws);
#pragma unroll
    for (int i = 0; i < kAStaged; ++i) {
      const int e = tid + i * NT, k = k0 + e / GR;
      as[i] = (e < BK * GR && k < K) ? to_f32(a[(size_t)k * GR + e % GR]) : 0.f;
    }
  };
  auto store = [&](int stage, int k0) {
    float* sXt = smem + stage * SF;
    float* sW = sXt + BK * LDX;
    float* sXr = sW + BK * BN;
    float* sAt = sXr + BM * LDR;
#pragma unroll
    for (int i = 0; i < 8; ++i) sXt[(xr_k + i) * LDX + xr_row] = xs[i];
    float4* xr = reinterpret_cast<float4*>(sXr + xr_row * LDR + xr_k);
    xr[0] = make_float4(xs[0], xs[1], xs[2], xs[3]);
    xr[1] = make_float4(xs[4], xs[5], xs[6], xs[7]);
    float4* wr = reinterpret_cast<float4*>(sW + wk * BN + wn);
    wr[0] = make_float4(ws[0], ws[1], ws[2], ws[3]);
    wr[1] = make_float4(ws[4], ws[5], ws[6], ws[7]);
#pragma unroll
    for (int i = 0; i < kAStaged; ++i) {
      const int e = tid + i * NT;
      if (e < BK * GR) sAt[(e % GR) * LDR + e / GR] = as[i];
    }
    for (int e = tid + kAStaged * NT; e < BK * GR; e += NT) {   // G*r > 32
      const int k = k0 + e / GR;
      sAt[(e % GR) * LDR + e / GR] =
          k < K ? to_f32(a[(size_t)k * GR + e % GR]) : 0.f;
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  fetch(0);
  store(0, 0);
  __syncthreads();

  const int nk = (K + BK - 1) / BK;
  for (int s = 0; s < nk; ++s) {
    const bool more = s + 1 < nk;
    if (more) fetch((s + 1) * BK);
    const float* sXt = smem + (s & 1) * SF;
    const float* sW = sXt + BK * LDX;
    const float* sXr = sW + BK * BN;
    const float* sAt = sXr + BM * LDR;

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float xv[8], wv[8];
      const float* xk = sXt + kk * LDX;
      const float* wkk = sW + kk * BN;
      *reinterpret_cast<float4*>(xv) =
          *reinterpret_cast<const float4*>(xk + ty * 4);
      *reinterpret_cast<float4*>(xv + 4) =
          *reinterpret_cast<const float4*>(xk + 64 + ty * 4);
      *reinterpret_cast<float4*>(wv) =
          *reinterpret_cast<const float4*>(wkk + tx * 4);
      *reinterpret_cast<float4*>(wv + 4) =
          *reinterpret_cast<const float4*>(wkk + 64 + tx * 4);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
    }

    // x @ A over this K step: two threads a row, each row against its own
    // adapter's rank block (the row's 16 x values read once)
    {
      const int row = tid >> 1, g = sIdx[row];
      if (g >= 0 && g < G) {
        const float4* xr = reinterpret_cast<const float4*>(sXr + row * LDR);
        const float4 x0 = xr[0], x1 = xr[1], x2 = xr[2], x3 = xr[3];
        for (int j = tid & 1; j < R; j += 2) {
          const float4* ar =
              reinterpret_cast<const float4*>(sAt + (g * R + j) * LDR);
          const float4 a0 = ar[0], a1 = ar[1], a2 = ar[2], a3 = ar[3];
          float d = 0.f;
          d = fmaf(x0.x, a0.x, d); d = fmaf(x0.y, a0.y, d);
          d = fmaf(x0.z, a0.z, d); d = fmaf(x0.w, a0.w, d);
          d = fmaf(x1.x, a1.x, d); d = fmaf(x1.y, a1.y, d);
          d = fmaf(x1.z, a1.z, d); d = fmaf(x1.w, a1.w, d);
          d = fmaf(x2.x, a2.x, d); d = fmaf(x2.y, a2.y, d);
          d = fmaf(x2.z, a2.z, d); d = fmaf(x2.w, a2.w, d);
          d = fmaf(x3.x, a3.x, d); d = fmaf(x3.y, a3.y, d);
          d = fmaf(x3.z, a3.z, d); d = fmaf(x3.w, a3.w, d);
          sXA[row * R + j] += d;
        }
      }
    }

    if (more) store((s + 1) & 1, (s + 1) * BK);
    __syncthreads();   // the next stage is written, this one is read
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = tile_pos(ty, i);
    const int m = m0 + row;
    if (m >= M) continue;
    const int g = sIdx[row];
    float d[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) d[c] = 0.f;
    if (g >= 0 && g < G) {
      const float s = kGrouped ? scales[g] : scale;
      for (int j = 0; j < R; ++j) {
        const float xs_ = sXA[row * R + j] * s;
        const TF* br = b + (size_t)(g * R + j) * N;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int n = n0 + tile_pos(tx, c);
          if (n < N) d[c] = fmaf(xs_, to_f32(br[n]), d[c]);
        }
      }
    }
    TX* orow = out + (size_t)m * N;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int n = n0 + tile_pos(tx, c);
      if (n >= N) continue;
      float v = acc[i][c];
      if (g >= G)
        v = __int_as_float(0x7fc00000);   // no such adapter: poison the row
      else if (g >= 0)
        v += d[c];
      store_f32(orow + n, v);
    }
  }
}

template <typename TX, typename TW, typename TF, bool kGrouped>
int launch(const void* x, const void* w, const void* a, const void* b,
           const int* idx, const float* scales, float scale, void* out, int m,
           int k, int n, int g, int r, cudaStream_t stream) {
  const size_t smem = smem_bytes(g * r, r);
  auto kernel = lora_matmul_kernel<TX, TW, TF, kGrouped>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w),
      static_cast<const TF*>(a), static_cast<const TF*>(b), idx, scales, scale,
      static_cast<TX*>(out), m, k, n, g, r);
  return (int)cudaGetLastError();
}

template <bool kGrouped>
int dispatch(const void* x, const void* w, const void* a, const void* b,
             const int* idx, const float* scales, float scale, void* out, int m,
             int k, int n, int g, int r, int xt, int wt, int ft,
             cudaStream_t st) {
  using bf16 = __nv_bfloat16;
  if (xt == 0 && wt == 0 && ft == 0)
    return launch<float, float, float, kGrouped>(x, w, a, b, idx, scales, scale,
                                                 out, m, k, n, g, r, st);
  if (xt == 0 && wt == 1 && ft == 1)
    return launch<float, bf16, bf16, kGrouped>(x, w, a, b, idx, scales, scale,
                                               out, m, k, n, g, r, st);
  if (xt == 1 && wt == 1 && ft == 1)
    return launch<bf16, bf16, bf16, kGrouped>(x, w, a, b, idx, scales, scale,
                                              out, m, k, n, g, r, st);
  return -1;
}

}  // namespace

// x [m, k], w [k, n], a [k, g*r], b [g*r, n], out [m, n]: contiguous device
// arrays; dtype codes 0 = float32, 1 = bfloat16 for x (and out), w and the
// factors a, b.  `idx` ([m] int32) and `scales` ([g] float32) select the
// grouped form; with `idx` null the single-adapter form runs with g = 1 and
// `scale`.  Launches on `stream` and returns the CUDA error of the launch (0
// on success), or -1 for a type combination or size the kernel does not take.
extern "C" int lora_matmul_fwd(const void* x, const void* w, const void* a,
                               const void* b, const void* idx,
                               const void* scales, float scale, void* out,
                               int m, int k, int n, int g, int r, int x_dtype,
                               int w_dtype, int f_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= 0 || n <= 0 || k < 0 || g <= 0 || r <= 0 ||
      g * r > kMaxRankCols || (idx == nullptr && g != 1))
    return -1;
  const int* ip = static_cast<const int*>(idx);
  const float* sp = static_cast<const float*>(scales);
  if (idx != nullptr)
    return dispatch<true>(x, w, a, b, ip, sp, scale, out, m, k, n, g, r,
                          x_dtype, w_dtype, f_dtype, st);
  return dispatch<false>(x, w, a, b, ip, sp, scale, out, m, k, n, g, r,
                         x_dtype, w_dtype, f_dtype, st);
}
