// w8a8 int8 matrix product with int32 accumulation for Hopper.
//
// Replaces the Pallas TPU kernel `_quant_kernel` / `quant_matmul` in
// src/repro/kernels/quant_matmul/kernel.py.  Same function: for xq [M, K] and
// wq [K, N] int8 (row-major), xs [M, 1] and ws [1, N] float32,
//   out[m, n] = float(sum_k xq[m, k] * wq[k, n]) * xs[m] * ws[n]
// with the sum held in int32 (exact: |sum| <= 127^2 * K < 2^31 for K up to
// 133144) and the two scales applied once per output element, in that
// order, each product rounded to float32 (`__fmul_rn`, never contracted).  So
// the result equals the plain version bit for bit.
//
// Bound at the path's shapes.  Under REPRO_QUANT=int8 every MMDiT stream
// projection is such a product; with two CFG-doubled requests the image
// stream has M = 16384 rows.  At (M, K, N) = (16384, 1536, 6144) the kernel
// does 2*M*K*N = 3.1e11 int8 operations and moves 25 MB of xq, 9 MB of wq and
// 403 MB of f32 output: 0.156 ms at the H100 SXM's dense int8 peak (1979
// TOP/s) against 0.130 ms at 3.35 TB/s, so operations bound it, barely; at
// (16384, 1536, 1536) the two are 0.039 and 0.038 ms.  The f32 output is most
// of the bytes.
//
// Design.  Each block of 256 threads (8 warps) computes a 128 x 128 output
// tile and walks K in steps of 64.  The products run on the tensor cores with
// `mma.sync.m16n8k32` (s8 x s8 -> s32), each warp owning a 64 x 32 sub-tile
// (4 x 4 instructions a 32-deep step, 64 int32 accumulators a thread).  The
// instruction wants B "col" (four consecutive k of one column in a 32-bit
// register), but wq is [K, N] row-major: each thread loads a 4 (k) x 4 (n)
// byte block as four 32-bit words and transposes it in registers with
// `__byte_perm`, so shared memory holds B as [n][k].  A and B rows in shared
// memory are 80 bytes apart (64 + 16 of padding), which puts the 32 lanes'
// fragment loads on 32 distinct banks.  B's 4-byte words are also swizzled
// within a row (word w of row n sits at w ^ ((n >> 3) & 15)): a warp's
// transposed stores walk 32 rows at one k, which without the swizzle would
// fall on 2 banks, and the fragment loads, whose 8 rows share n >> 3, stay
// on 32 distinct banks.  Two shared-memory buffers: the next
// K step's global loads are issued into registers before the current step's
// products and stored after them, with one barrier a step.  Ragged M, N and K
// are masked in the loads (zeros contribute nothing) and the stores; 16-byte
// loads of xq and 4-byte loads of wq when K % 16 == 0 and N % 4 == 0 (every
// path shape), byte loads otherwise.  wgmma and TMA are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;        // output tile rows
constexpr int BN = 128;        // output tile columns
constexpr int BK = 64;         // K step, bytes
constexpr int LDS = BK + 16;   // shared-memory row stride, bytes
constexpr int NT = 256;        // 8 warps: 2 along M x 4 along N
constexpr int WM = 64;         // warp tile rows
constexpr int WN = 32;         // warp tile columns
constexpr int MI = WM / 16;    // m16 tiles a warp
constexpr int NI = WN / 8;     // n8 tiles a warp

// byte offset of B's 4-byte word `w` (k = 4w .. 4w + 3) in row n
__device__ __forceinline__ int b_word(int n, int w) {
  return n * LDS + 4 * (w ^ ((n >> 3) & 15));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Registers a thread carries from device memory to shared memory for one K
// step: two 16-byte chunks of the A tile and two 4 x 4 blocks of the B tile.
struct Stage {
  uint4 a[2];
  uint32_t b[2][4];
};

template <bool VEC>
__device__ __forceinline__ void load_stage(Stage& s, const int8_t* __restrict__ xq,
                                           const int8_t* __restrict__ wq, int m,
                                           int k, int n, int m0, int n0, int k0,
                                           int tid) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * NT;          // 512 chunks: 128 rows x 4
    const int row = m0 + (c >> 2);
    const int col = k0 + (c & 3) * 16;
    if (VEC) {
      s.a[i] = (row < m && col < k)
                   ? __ldg(reinterpret_cast<const uint4*>(xq + (size_t)row * k + col))
                   : make_uint4(0, 0, 0, 0);
    } else {
      uint32_t w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t v = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cc = col + q * 4 + e;
          const uint32_t byte =
              (row < m && cc < k) ? (uint8_t)xq[(size_t)row * k + cc] : 0u;
          v |= byte << (8 * e);
        }
        w[q] = v;
      }
      s.a[i] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * NT;          // 512 blocks: 16 (k) x 32 (n)
    const int kr = k0 + (c >> 5) * 4;
    const int nc = n0 + (c & 31) * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kk = kr + j;
      if (VEC) {
        s.b[i][j] = (kk < k && nc < n)
                        ? __ldg(reinterpret_cast<const uint32_t*>(
                              wq + (size_t)kk * n + nc))
                        : 0u;
      } else {
        uint32_t v = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t byte = (kk < k && nc + e < n)
                                    ? (uint8_t)wq[(size_t)kk * n + nc + e]
                                    : 0u;
          v |= byte << (8 * e);
        }
        s.b[i][j] = v;
      }
    }
  }
}

__device__ __forceinline__ void store_stage(const Stage& s, int8_t* as,
                                            int8_t* bs, int tid) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * NT;
    *reinterpret_cast<uint4*>(as + (c >> 2) * LDS + (c & 3) * 16) = s.a[i];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * NT;
    const int kw = c >> 5;               // k word in the tile (k = 4 kw)
    const int nc = (c & 31) * 4;         // n offset in the tile
    // rows r0..r3 (k) each hold n0..n3 in bytes 0..3; out word j holds
    // column j's four k values, k ascending from byte 0
    const uint32_t* r = s.b[i];
    const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
    const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);
    const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
    const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
    *reinterpret_cast<uint32_t*>(bs + b_word(nc + 0, kw)) = __byte_perm(t0, t2, 0x5410);
    *reinterpret_cast<uint32_t*>(bs + b_word(nc + 1, kw)) = __byte_perm(t0, t2, 0x7632);
    *reinterpret_cast<uint32_t*>(bs + b_word(nc + 2, kw)) = __byte_perm(t1, t3, 0x5410);
    *reinterpret_cast<uint32_t*>(bs + b_word(nc + 3, kw)) = __byte_perm(t1, t3, 0x7632);
  }
}

// at most 128 registers a thread, so that two blocks share an SM: one
// block's products then cover the other's global loads
template <bool VEC>
__global__ void __launch_bounds__(NT, 2)
quant_matmul_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wq,
                    const float* __restrict__ xs, const float* __restrict__ ws,
                    float* __restrict__ out, int m, int k, int n) {
  __shared__ __align__(16) int8_t smem[2][(BM + BN) * LDS];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;               // groupID
  const int t = lane & 3;                // threadID_in_group
  const int wm = (warp >> 2) * WM;
  const int wn = (warp & 3) * WN;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int nk = (k + BK - 1) / BK;

  int acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  Stage st;
  load_stage<VEC>(st, xq, wq, m, k, n, m0, n0, 0, tid);
  store_stage(st, smem[0], smem[0] + BM * LDS, tid);
  __syncthreads();

  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load_stage<VEC>(st, xq, wq, m, k, n, m0, n0, (kt + 1) * BK, tid);
    const int8_t* as = smem[kt & 1];
    const int8_t* bs = as + BM * LDS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[MI][4];
      uint32_t bf[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int8_t* p = as + (wm + i * 16 + g) * LDS + kk + t * 4;
        af[i][0] = *reinterpret_cast<const uint32_t*>(p);
        af[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS);
        af[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        af[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int n = wn + j * 8 + g;
        bf[j][0] = *reinterpret_cast<const uint32_t*>(bs + b_word(n, kk / 4 + t));
        bf[j][1] = *reinterpret_cast<const uint32_t*>(bs + b_word(n, kk / 4 + 4 + t));
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
    if (kt + 1 < nk) {
      int8_t* nxt = smem[(kt + 1) & 1];
      store_stage(st, nxt, nxt + BM * LDS, tid);
    }
    __syncthreads();
  }

  // epilogue: acc -> float, times xs[row], times ws[col], each rounded
  const bool pair = (n & 1) == 0;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm + i * 16 + g + h * 8;
      if (row >= m) continue;
      const float xr = xs[row];
      float* orow = out + (size_t)row * n;
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int col = n0 + wn + j * 8 + t * 2;
        if (col >= n) continue;
        const float v0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * h]), xr), ws[col]);
        if (col + 1 < n) {
          const float v1 =
              __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * h + 1]), xr), ws[col + 1]);
          if (pair) {
            *reinterpret_cast<float2*>(orow + col) = make_float2(v0, v1);
          } else {
            orow[col] = v0;
            orow[col + 1] = v1;
          }
        } else {
          orow[col] = v0;
        }
      }
    }
  }
}

}  // namespace

// out = (xq @ wq) * xs * ws for xq [m, k], wq [k, n] int8, xs [m, 1], ws [1, n]
// float32, out [m, n] float32, all contiguous on the current device.  Launches
// on `stream` and returns the CUDA error of the launch (0 on success).
extern "C" int quant_matmul_fwd(const void* xq, const void* wq, const void* xs,
                                const void* ws, void* out, int m, int k, int n,
                                void* stream) {
  if (m <= 0 || k <= 0 || n <= 0) return -1;
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  const bool vec = k % 16 == 0 && n % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(xq) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(wq) % 4 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* a = static_cast<const int8_t*>(xq);
  const int8_t* b = static_cast<const int8_t*>(wq);
  const float* sa = static_cast<const float*>(xs);
  const float* sb = static_cast<const float*>(ws);
  float* o = static_cast<float*>(out);
  if (vec) {
    quant_matmul_kernel<true><<<grid, NT, 0, s>>>(a, b, sa, sb, o, m, k, n);
  } else {
    quant_matmul_kernel<false><<<grid, NT, 0, s>>>(a, b, sa, sb, o, m, k, n);
  }
  return (int)cudaGetLastError();
}
