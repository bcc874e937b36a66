// RG-LRU linear recurrence (RecurrentGemma / Griffin) for Hopper.
//
// Replaces the Pallas TPU kernel `_rglru_kernel` / `rglru_scan` in
// src/repro/kernels/rglru_scan/kernel.py.  Same function: for a, x [B, T, D]
// float32 (a the decay gates in (0, 1)),
//   h_t = a_t * h_{t-1} + sqrt(max(1 - a_t^2, 0)) * x_t,   h_{-1} = 0,
// written for every t, in float32, each operation rounded as written
// (`__fmul_rn` and friends: no contraction into FMAs), which is the TPU
// kernel's literal step.
//
// Bound.  The recurrence does a handful of operations per element and reads
// a and x and writes h once: 12 bytes an element.  At RecurrentGemma-2B width
// (D = 2560; B = 1, T = 8192, or B = 8, T = 2048) that is 252 MB, 0.075 ms at
// the H100 SXM's 3.35 TB/s, so memory bounds it.
//
// Design.  The recurrence is sequential in T and independent across (b, d):
// one thread per (b, d) runs the whole of T (the TPU kernel's sequential
// sequence grid axis becomes this loop, and its VMEM carry a register).
// Neighbouring threads take neighbouring d, so each time step's loads and
// stores are coalesced along D.  The loads do not depend on h, so the loop
// takes U time steps at a time, issuing their 2U loads before the U
// dependent updates; that keeps enough bytes in flight while B * D threads
// are few (2560 at B = 1, 20 blocks).  Splitting T across threads (a
// chunked scan with a carry pass) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;        // threads a block, along D
constexpr int U = 16;          // time steps whose loads are issued together

__device__ __forceinline__ float step(float h, float a, float x) {
  const float g = sqrtf(fmaxf(__fsub_rn(1.0f, __fmul_rn(a, a)), 0.0f));
  return __fadd_rn(__fmul_rn(a, h), __fmul_rn(g, x));
}

__global__ void __launch_bounds__(NT)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ x,
                  float* __restrict__ out, int t_len, int d_len) {
  const int d = blockIdx.x * NT + threadIdx.x;
  if (d >= d_len) return;
  const size_t base = (size_t)blockIdx.y * t_len * d_len + d;
  float h = 0.0f;
  int t = 0;
  for (; t + U <= t_len; t += U) {
    float av[U], xv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const size_t i = base + (size_t)(t + u) * d_len;
      av[u] = __ldg(a + i);
      xv[u] = __ldg(x + i);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      h = step(h, av[u], xv[u]);
      out[base + (size_t)(t + u) * d_len] = h;
    }
  }
  for (; t < t_len; ++t) {
    const size_t i = base + (size_t)t * d_len;
    h = step(h, __ldg(a + i), __ldg(x + i));
    out[i] = h;
  }
}

}  // namespace

// out[b, t, d] = h_t for a, x, out [b, t, d] float32, contiguous on the current
// device.  Launches on `stream` and returns the CUDA error of the launch (0 on
// success).
extern "C" int rglru_scan_fwd(const void* a, const void* x, void* out, int b,
                              int t, int d, void* stream) {
  if (b <= 0 || t <= 0 || d <= 0 || b > 65535) return -1;
  const dim3 grid((d + NT - 1) / NT, b);
  rglru_scan_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(x),
      static_cast<float*>(out), t, d);
  return (int)cudaGetLastError();
}
