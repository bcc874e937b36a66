// Dynamic per-row int8 activation quantization for Hopper.
//
// Replaces the plain `jnp` quantization that the JAX package's `_quant_apply`
// runs before its Pallas kernel (`_quantize_rows`, src/repro/kernels/
// quant_matmul/ops.py:112).  Same function, the same bits: for x [M, K]
// float32 (row-major),
//   amax[m]  = max_k |x[m, k]|                       (exact in any order)
//   xs[m]    = amax[m] > 0 ? amax[m] * f32(1/127) : 1  (a product, as XLA
//              computes amax / 127 inside jit and the plain version does)
//   xq[m, k] = clamp(round_half_even(x[m, k] / xs[m]), -127, 127)
// with IEEE division (`__fdiv_rn`; the build passes no fast-math flag) and
// `__float2int_rn` (round half to even) before the clamp.  Non-finite input
// follows torch: the row maximum propagates NaN, so a row holding a NaN gets
// xs = 1 (NaN > 0 is false); an element whose quotient is NaN becomes 0, as
// torch's cast of NaN to int8 gives on the card; +-inf quotients clamp to
// +-127.
//
// Bound.  Bytes: each element is read once (4 bytes) and written once (1
// byte), 5 bytes an element: 0.038 ms at (16384, 1536) and 0.150 ms at
// (16384, 6144) at the H100 SXM's 3.35 TB/s.  The plain version makes about
// six passes over the float32 tensor.
//
// Design.  One pass over x from device memory: a row lives in registers
// between its maximum and its quantization.  TPR threads share a row, the
// fewest (a power of two from 32 to 1024) that hold it at 32 floats (eight
// 16-byte chunks) a thread: 64 at K 1536, 128 at K 4096, 256 at K 6144, 512
// at K 16384.  A block holds 256 threads (TPR of them when TPR > 256), so
// several rows share a block at short K.  The maximum is reduced by warp
// shuffles, then across the row's warps through shared memory.  Few
// registers a thread let several blocks share an SM, so one block's loads
// overlap another's arithmetic.  Rows longer than 32768 take 1024 threads
// and read x twice (the second read mostly from L2).  16-byte loads and
// 4-byte stores where K % 4 == 0 and the pointers are aligned; element loads
// and byte stores otherwise, in the same coalesced order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;                 // threads a block, at least
constexpr int CH = 8;                   // 16-byte chunks a thread holds
constexpr int MAX_TPR = 1024;           // threads a row, at most
constexpr float INV_INT8_MAX = 0.007874015718698502f;   // f32(1/127)

// max that propagates NaN, as torch's amax does
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ int quantize(float v, float s) {
  const int q = __float2int_rn(__fdiv_rn(v, s));    // NaN -> 0, saturating
  return max(-127, min(127, q));
}

__device__ __forceinline__ uint32_t pack4(float4 v, float s) {
  return (uint32_t)(quantize(v.x, s) & 0xff)
       | (uint32_t)(quantize(v.y, s) & 0xff) << 8
       | (uint32_t)(quantize(v.z, s) & 0xff) << 16
       | (uint32_t)(quantize(v.w, s) & 0xff) << 24;
}

__device__ __forceinline__ float abs_max4(float m, float4 v) {
  m = nan_max(m, fabsf(v.x));
  m = nan_max(m, fabsf(v.y));
  m = nan_max(m, fabsf(v.z));
  return nan_max(m, fabsf(v.w));
}

// The row maximum across the TPR threads that share a row, in a block of BT
// threads.  Every thread of the block must call it (one barrier).
template <int TPR, int BT>
__device__ __forceinline__ float row_max(float m) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, o));
  if constexpr (TPR > 32) {
    __shared__ float warp_max[BT / 32];
    if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
    __syncthreads();
    const int first = threadIdx.x / TPR * (TPR / 32);
    m = warp_max[first];
#pragma unroll
    for (int w = 1; w < TPR / 32; ++w) m = nan_max(m, warp_max[first + w]);
  }
  return m;
}

// TPR threads per row, blocks of max(TPR, 256).  RESIDENT: the row fits in
// the threads' registers (K <= TPR * CH * 4).  VEC: 16-byte loads.
template <int TPR, bool RESIDENT, bool VEC>
__global__ void __launch_bounds__(TPR > NT ? TPR : NT)
quantize_rows_kernel(const float* __restrict__ x, int8_t* __restrict__ xq,
                     float* __restrict__ xs, int m, int k) {
  constexpr int BT = TPR > NT ? TPR : NT;
  const int row = blockIdx.x * (BT / TPR) + threadIdx.x / TPR;
  const int lane = threadIdx.x % TPR;
  // a row past M reads and writes nothing, but its threads still reach the
  // barrier in row_max
  const int nc = row < m ? (VEC ? k / 4 : k) : 0;   // chunks or elements
  const float* xr = x + (size_t)row * k;
  int8_t* qr = xq + (size_t)row * k;

  float amax = 0.f;
  float s;
  if constexpr (RESIDENT && VEC) {
    float4 v[CH];
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int c = lane + i * TPR;
      v[i] = c < nc ? __ldg(reinterpret_cast<const float4*>(xr) + c)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      amax = abs_max4(amax, v[i]);
    }
    amax = row_max<TPR, BT>(amax);
    s = amax > 0.f ? __fmul_rn(amax, INV_INT8_MAX) : 1.f;
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int c = lane + i * TPR;
      if (c < nc) reinterpret_cast<uint32_t*>(qr)[c] = pack4(v[i], s);
    }
  } else if constexpr (RESIDENT) {
    float v[CH * 4];
#pragma unroll
    for (int i = 0; i < CH * 4; ++i) {
      const int c = lane + i * TPR;
      v[i] = c < nc ? __ldg(xr + c) : 0.f;
      amax = nan_max(amax, fabsf(v[i]));
    }
    amax = row_max<TPR, BT>(amax);
    s = amax > 0.f ? __fmul_rn(amax, INV_INT8_MAX) : 1.f;
#pragma unroll
    for (int i = 0; i < CH * 4; ++i) {
      const int c = lane + i * TPR;
      if (c < nc) qr[c] = (int8_t)quantize(v[i], s);
    }
  } else {
    for (int c = lane; c < nc; c += TPR) {
      if constexpr (VEC) {
        amax = abs_max4(amax, __ldg(reinterpret_cast<const float4*>(xr) + c));
      } else {
        amax = nan_max(amax, fabsf(__ldg(xr + c)));
      }
    }
    amax = row_max<TPR, BT>(amax);
    s = amax > 0.f ? __fmul_rn(amax, INV_INT8_MAX) : 1.f;
    for (int c = lane; c < nc; c += TPR) {
      if constexpr (VEC) {
        reinterpret_cast<uint32_t*>(qr)[c] =
            pack4(__ldg(reinterpret_cast<const float4*>(xr) + c), s);
      } else {
        qr[c] = (int8_t)quantize(__ldg(xr + c), s);
      }
    }
  }
  if (row < m && lane == 0) xs[row] = s;
}

template <int TPR, bool RESIDENT>
int launch(bool vec, const float* x, int8_t* q, float* s, int m, int k,
           cudaStream_t st) {
  constexpr int BT = TPR > NT ? TPR : NT;
  const int blocks = (m + BT / TPR - 1) / (BT / TPR);
  if (vec) {
    quantize_rows_kernel<TPR, RESIDENT, true><<<blocks, BT, 0, st>>>(x, q, s, m, k);
  } else {
    quantize_rows_kernel<TPR, RESIDENT, false><<<blocks, BT, 0, st>>>(x, q, s, m, k);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// xq = clamp(rint(x / xs), -127, 127), xs = rowmax|x| * f32(1/127) (1 for a
// zero row), for x [m, k] float32, xq [m, k] int8 and xs [m, 1] float32, all
// contiguous on the current device.  Launches on `stream` and returns the
// CUDA error of the launch (0 on success).
extern "C" int quantize_rows_fwd(const void* x, void* xq, void* xs, int m,
                                 int k, void* stream) {
  if (m <= 0 || k <= 0) return -1;
  const bool vec = k % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(xq) % 4 == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  int8_t* qp = static_cast<int8_t*>(xq);
  float* sp = static_cast<float*>(xs);
  int tpr = 32;                       // the fewest threads that hold the row
  while (tpr < MAX_TPR && tpr * CH * 4 < k) tpr *= 2;
  if (tpr * CH * 4 < k) return launch<MAX_TPR, false>(vec, xp, qp, sp, m, k, st);
  switch (tpr) {
    case 32: return launch<32, true>(vec, xp, qp, sp, m, k, st);
    case 64: return launch<64, true>(vec, xp, qp, sp, m, k, st);
    case 128: return launch<128, true>(vec, xp, qp, sp, m, k, st);
    case 256: return launch<256, true>(vec, xp, qp, sp, m, k, st);
    case 512: return launch<512, true>(vec, xp, qp, sp, m, k, st);
    default: return launch<1024, true>(vec, xp, qp, sp, m, k, st);
  }
}
