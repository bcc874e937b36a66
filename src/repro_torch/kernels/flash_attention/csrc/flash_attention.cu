// Blockwise online-softmax attention (FlashAttention forward) for Hopper.
//
// Replaces the Pallas TPU kernel `_attn_kernel` / `flash_attention` in
// src/repro/kernels/flash_attention/kernel.py.  Same function: for q, k, v of
// shape [BH, S, D] (f32 or bf16), out = softmax(q k^T / sqrt(D)) v per head,
// with a padding guard, optional causal and sliding-window masks, masked
// probabilities zeroed explicitly, a row whose softmax sum is 0 giving 0, and
// rectangular Sq != Sk.  All arithmetic is f32 (the running max, sum and
// accumulator included); the output is written in the input's dtype.
//
// Bound at the path's shape.  The MMDiT joint attention at full SD3 width
// (BH = 48 for one CFG-doubled request, S = 4429, D = 64, f32) does
// 4*BH*S^2*D = 2.4e11 operations on 218 MB of q/k/v/o: 1.1e3 operations a
// byte, so it is bound by operations, not memory.  Its inputs are f32 and the
// path needs f32 results, so the rate that bounds it is the card's f32 rate
// outside the tensor cores (67 TFLOP/s on an H100 SXM): about 3.6 ms a call,
// and 7.2 ms at BH = 96, when two requests share a backbone batch.
//
// Design.  One thread block per (bh, q-tile) sweeps all K/V tiles itself (the
// TPU kernel's sequential k grid axis becomes this loop), so the running max,
// sum and accumulator stay in registers for the whole sweep and q, k, v are
// each read from device memory once per q-tile.  The Q tile (pre-scaled), the
// K and V tiles and the probability tile live in shared memory as f32 with an
// odd row stride (D + 1), so the column reads of the two products hit 32
// distinct banks.  Thread (tr, tc) owns rows tr + i*TR and columns tc + j*TC of
// both the score tile and the output accumulator: each row's TC owners sit in
// one warp, so the row max and row sum are warp shuffles and the rescale by
// alpha touches only the thread's own registers.  Tiles wholly outside the
// causal or window band are skipped (exact: they would contribute 0).
// Tile shapes are chosen from D: 64x64 tiles for D = 8..64 (the kernel grid and
// the MMDiT path); 16x16 tiles for D = 1024, so that the text encoder's head
// still fits (Q, K, V tiles of 16 x 1025 floats: 197 KB of the 227 KB a block
// may use).  Other head dims are instantiated when a path needs them.  Products run on
// the CUDA cores in f32 FMA; tensor-core (mma/wgmma) tiles are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;   // the TPU kernel's NEG_INF

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int D, int BQ, int BK>
constexpr int smem_floats() {
  return BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1);
}

template <typename T, int D, int BQ, int BK, int NT, int TC>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int sq, int sk,
                 float scale, int causal, int has_window, int window) {
  constexpr int TR = NT / TC;   // thread rows
  constexpr int RT = BQ / TR;   // tile rows a thread owns
  constexpr int SC = BK / TC;   // score columns a thread owns
  constexpr int OC = D / TC;    // output columns a thread owns
  constexpr int LD = D + 1;     // odd shared-memory row strides:
  constexpr int LP = BK + 1;    // column reads stay bank-conflict free
  static_assert(NT % TC == 0 && BQ % TR == 0 && BK % TC == 0 && D % TC == 0,
                "tile shape");
  static_assert(TC <= 32 && (32 % TC) == 0, "a row's owners share a warp");

  extern __shared__ float smem[];
  float* sQ = smem;              // [BQ][LD], pre-scaled
  float* sK = sQ + BQ * LD;      // [BK][LD]
  float* sV = sK + BK * LD;      // [BK][LD]
  float* sP = sV + BK * LD;      // [BQ][LP]

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int tr = tid / TC;
  const int tc = tid % TC;
  const T* qb = q + (size_t)bh * sq * D;
  const T* kb = k + (size_t)bh * sk * D;
  const T* vb = v + (size_t)bh * sk * D;
  T* ob = o + (size_t)bh * sq * D;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D, qr = q0 + r;
    sQ[r * LD + c] = qr < sq ? load_f32(qb + (size_t)qr * D + c) * scale : 0.f;
  }

  float acc[RT][OC];
  float m[RT], l[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.f;
  }

  // the K range this q-tile can see: the causal band ends at its last row,
  // the window band starts window-1 keys before its first row
  int k_begin = 0, k_end = sk;
  if (causal) k_end = min(sk, q0 + BQ);
  if (has_window) k_begin = max(0, q0 - window + 1) / BK * BK;

  for (int kt = k_begin; kt < k_end; kt += BK) {
    __syncthreads();   // the previous tile's reads of sK, sV, sP are done
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i % D, kr = kt + r;
      const bool ok = kr < sk;   // padding guard: rows past Sk read as 0
      sK[r * LD + c] = ok ? load_f32(kb + (size_t)kr * D + c) : 0.f;
      sV[r * LD + c] = ok ? load_f32(vb + (size_t)kr * D + c) : 0.f;
    }
    __syncthreads();

    float s[RT][SC];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < SC; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RT], kv[SC];
#pragma unroll
      for (int i = 0; i < RT; ++i) qv[i] = sQ[(tr + i * TR) * LD + d];
#pragma unroll
      for (int j = 0; j < SC; ++j) kv[j] = sK[(tc + j * TC) * LD + d];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < SC; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int r = tr + i * TR;
      const int qpos = q0 + r;
      bool ok[SC];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        const int kpos = kt + tc + j * TC;
        ok[j] = kpos < sk && (!causal || kpos <= qpos) &&
                (!has_window || kpos > qpos - window);
        s[i][j] = ok[j] ? s[i][j] : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = TC / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        // zero masked probabilities explicitly: a fully masked tile must
        // add 0, not exp(NEG_INF - NEG_INF) = 1
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sP[r * LP + tc + j * TC] = p;
        rs += p;
      }
#pragma unroll
      for (int off = TC / 2; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < OC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[RT], vv[OC];
#pragma unroll
      for (int i = 0; i < RT; ++i) pv[i] = sP[(tr + i * TR) * LP + kk];
#pragma unroll
      for (int c = 0; c < OC; ++c) vv[c] = sV[kk * LD + tc + c * TC];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int c = 0; c < OC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int qr = q0 + tr + i * TR;
    if (qr >= sq) continue;
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);   // fully masked rows
#pragma unroll
    for (int c = 0; c < OC; ++c)
      store_from_f32(ob + (size_t)qr * D + tc + c * TC, acc[i][c] * inv);
  }
}

template <typename T, int D, int BQ, int BK, int NT, int TC>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int sq, int sk, float scale, int causal, int has_window, int window,
           cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * smem_floats<D, BQ, BK>();
  auto kernel = flash_fwd_kernel<T, D, BQ, BK, NT, TC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + BQ - 1) / BQ, bh);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, scale, causal,
      has_window, window);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int bh,
             int sq, int sk, int d, float scale, int causal, int has_window,
             int window, cudaStream_t st) {
  switch (d) {
    case 8:    return launch<T, 8, 64, 64, 128, 8>(q, k, v, o, bh, sq, sk, scale, causal, has_window, window, st);
    case 16:   return launch<T, 16, 64, 64, 128, 16>(q, k, v, o, bh, sq, sk, scale, causal, has_window, window, st);
    case 32:   return launch<T, 32, 64, 64, 128, 16>(q, k, v, o, bh, sq, sk, scale, causal, has_window, window, st);
    case 64:   return launch<T, 64, 64, 64, 128, 16>(q, k, v, o, bh, sq, sk, scale, causal, has_window, window, st);
    case 1024: return launch<T, 1024, 16, 16, 256, 16>(q, k, v, o, bh, sq, sk, scale, causal, has_window, window, st);
    default:   return -1;
  }
}

}  // namespace

// q, k, v, o: contiguous [bh, sq|sk, d] device arrays of one dtype
// (0 = float32, 1 = bfloat16).  Launches on `stream` and returns the CUDA
// error of the launch (0 on success), or -1 for a head dim or dtype the
// kernel does not take.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int bh, int sq, int sk, int d,
                                   int dtype, float scale, int causal,
                                   int has_window, int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, bh, sq, sk, d, scale, causal,
                           has_window, window, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, bh, sq, sk, d, scale, causal,
                                   has_window, window, st);
  return -1;
}
