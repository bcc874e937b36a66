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
// of the bytes.  The per-layer `ada` product (4, 1536, 9216) is bound by the
// 14 MB of wq: 0.0043 ms.
//
// Design.  `mma.sync.m16n8k32` (s8 x s8 -> s32) on 128-column output tiles,
// K in steps of 128 bytes through a `cp.async` ring in dynamic shared memory
// (one barrier a step; zero-filled copies mask ragged tiles).  Four warps a
// block; three routes by shape, chosen by the wrapper (`kernel.plan`):
//   route 0, large M: 128 x 128 tiles, 64 x 64 a warp, 3 stages, two blocks
//     an SM;
//   route 1, mid M (333 and 1332 rows): 64 x 128 tiles, 32 x 64 a warp, 4
//     stages, so that the grid fills the 132 SMs;
//   route 2, M <= 64: 16 x 128 tiles, 16 x 32 a warp, 4 stages, streaming wq.
// A grid under two blocks an SM splits K across blocks (split-K) as far as
// the partial sums' bytes stay within half the operands' (the ada product:
// 4 splits; the text encoder's (333, 16384, 4096): 2).  Each split writes
// its int32 partial sums; a second kernel adds them in int32 (exact, so the
// order does not matter) and applies the scales.  On the H100, 128 x 256 or
// 256 x 128 tiles, eight-warp blocks and 64-byte K steps measured slower,
// and loading the next step's fragments before the current products no
// faster.
// wq stays [K, N] row-major as the quantized weight holds it, so B lands in
// shared memory as raw [k][n] bytes, while the instruction wants four
// consecutive k of one column in a register.  The transpose happens on the
// way to the registers: a thread loads a 4 (k) x 4 (n) byte block as four
// 32-bit words and transposes it with `__byte_perm`; its four columns feed
// four different n8 tiles (column g of tile j is physical column 4g + j of
// the warp's 32-column group), and the epilogue undoes the permutation: a
// thread then holds 8 consecutive output columns of a row and stores them as
// two 16-byte stores.  A cooperative pass that transposes each stage into a
// second buffer, for `ldmatrix` fragment loads, measured slower at every
// shape tried: it adds a barrier and a shared-memory round trip a step.
// B's 16-byte chunks are XOR-swizzled by their row (chunk c of row r sits
// at c ^ (2 * ((r >> 2) & 3))), which puts the 32 lanes' words of every
// block load on 32 distinct banks; A rows sit 144 bytes apart (128 + 16 of
// padding), so its `ldmatrix.x4` fragment loads are conflict-free.  Ragged
// M, N and K are masked (zeros contribute nothing); 16-byte copies when
// K % 16 == 0 and N % 16 == 0 (every path shape), byte loads stored to
// shared memory otherwise.  No `__launch_bounds__` minimum: nothing
// spills.  wgmma and TMA are later work: s8 wgmma reads B only K-major,
// which needs a K-major copy of wq or a transpose in shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 128;        // K step, bytes
constexpr int LDA = BK + 16;   // A's shared-memory row stride, bytes

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(ok ? 16 : 0)   // 0: zero-fill
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// byte offset of B's 16-byte chunk `c` of row `r` in a stage of BN columns
template <int BN>
__device__ __forceinline__ int b_chunk(int r, int c) {
  return r * BN + 16 * (c ^ (((r >> 2) & 3) << 1));
}

// 16 bytes of a row from `src`, the first `valid` of them (0..16) real and
// the rest zeros, read a byte at a time (rows that are not 16-byte aligned)
__device__ __forceinline__ uint4 bytes16(const int8_t* src, int valid) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < 16; ++e)
    if (e < valid) w[e >> 2] |= (uint32_t)(uint8_t)src[e] << (8 * (e & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Start the copies of one K step by NT threads: A rows m0.. (BM x BK bytes)
// and B rows k0.. (BK x BN bytes).  Columns of A at or past `ke` (this
// split's end of K) and anything past M or N are zeros.
template <int BM, int BN, int NT, bool VEC>
__device__ __forceinline__ void load_stage(int8_t* as, int8_t* bs,
                                           const int8_t* __restrict__ xq,
                                           const int8_t* __restrict__ wq,
                                           int m, int k, int n, int m0, int n0,
                                           int k0, int ke, int tid) {
#pragma unroll
  for (int it = 0; it < (BM * (BK / 16) + NT - 1) / NT; ++it) {   // A: BM x BK/16
    const int c = tid + it * NT;
    if (BM * (BK / 16) % NT != 0 && c >= BM * (BK / 16)) break;
    const int r = c / (BK / 16), col = k0 + (c % (BK / 16)) * 16;
    int8_t* dst = as + r * LDA + (c % (BK / 16)) * 16;
    const bool ok = m0 + r < m && col < ke;
    const int8_t* src = xq + (size_t)(m0 + r) * k + col;
    if constexpr (VEC) {
      cp_async16(dst, ok ? src : xq, ok);
    } else {
      *reinterpret_cast<uint4*>(dst) = bytes16(src, ok ? min(16, ke - col) : 0);
    }
  }
#pragma unroll
  for (int it = 0; it < BK * (BN / 16) / NT; ++it) {   // B: BK x BN/16
    const int c = tid + it * NT;
    const int r = c / (BN / 16), ch = c % (BN / 16), col = n0 + ch * 16;
    int8_t* dst = bs + b_chunk<BN>(r, ch);
    const bool ok = k0 + r < ke && col < n;
    const int8_t* src = wq + (size_t)(k0 + r) * n + col;
    if constexpr (VEC) {
      cp_async16(dst, ok ? src : wq, ok);
    } else {
      *reinterpret_cast<uint4*>(dst) = bytes16(src, ok ? min(16, n - col) : 0);
    }
  }
}

// Output tile BM x BN over K columns [blockIdx.z * k_split, +k_split) of
// [0, K); warps of WM x WN, STAGES steps in flight.  SPLIT: write the int32
// partial sums to part[blockIdx.z] ([M, N] each) instead of the scaled
// output.
template <int BM, int BN, int WM, int WN, int STAGES, bool VEC, bool SPLIT>
__global__ void __launch_bounds__((BM / WM) * (BN / WN) * 32)
quant_matmul_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wq,
                    const float* __restrict__ xs, const float* __restrict__ ws,
                    float* __restrict__ out, int* __restrict__ part, int m,
                    int k, int n, int k_split) {
  constexpr int WARPS_N = BN / WN;
  constexpr int NT = (BM / WM) * WARPS_N * 32;
  constexpr int MI = WM / 16;         // m16 tiles a warp
  constexpr int NG = WN / 32;         // 32-column groups a warp (4 n8 tiles)
  constexpr int A_BYTES = BM * LDA;
  constexpr int STAGE_BYTES = A_BYTES + BK * BN;
  extern __shared__ __align__(16) int8_t smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;            // groupID
  const int t = lane & 3;             // threadID_in_group
  const int wm = (warp / WARPS_N) * WM;
  const int wn = (warp % WARPS_N) * WN;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int kb = blockIdx.z * k_split;
  const int ke = min(k, kb + k_split);
  const int nk = ke > kb ? (ke - kb + BK - 1) / BK : 0;

  int acc[MI][NG * 4][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NG * 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk)
      load_stage<BM, BN, NT, VEC>(smem + s * STAGE_BYTES, smem + s * STAGE_BYTES + A_BYTES,
                          xq, wq, m, k, n, m0, n0, kb + s * BK, ke, tid);
    cp_async_commit();
  }

  // this lane's ldmatrix row address in A and its B word within a chunk
  const int a_row = wm + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 16;
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // step kt has landed; step kt - 1's stage is free
    if (kt + STAGES - 1 < nk) {
      int8_t* st = smem + ((kt + STAGES - 1) % STAGES) * STAGE_BYTES;
      load_stage<BM, BN, NT, VEC>(st, st + A_BYTES, xq, wq, m, k, n, m0, n0,
                          kb + (kt + STAGES - 1) * BK, ke, tid);
    }
    cp_async_commit();

    const int8_t* as = smem + (kt % STAGES) * STAGE_BYTES;
    const int8_t* bs = as + A_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[MI][4];
      uint32_t bf[NG * 4][2];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        ldmatrix_x4(af[i], as + (a_row + i * 16) * LDA + kk + a_col);
#pragma unroll
      for (int q = 0; q < NG; ++q) {
        const int chunk = (wn + 32 * q) / 16 + (g >> 2);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // rows k = kk + 16h + 4t + i, columns 4g .. 4g + 3 of group q:
          // byte e of r[i] is (k_i, column 4g + e)
          uint32_t r[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int row = kk + 16 * h + 4 * t + i;
            r[i] = *reinterpret_cast<const uint32_t*>(bs + b_chunk<BN>(row, chunk) +
                                                      4 * (g & 3));
          }
          // word j: column 4g + j, its four k ascending from byte 0
          const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
          const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);
          const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
          const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
          bf[4 * q + 0][h] = __byte_perm(t0, t2, 0x5410);
          bf[4 * q + 1][h] = __byte_perm(t0, t2, 0x7632);
          bf[4 * q + 2][h] = __byte_perm(t1, t3, 0x5410);
          bf[4 * q + 3][h] = __byte_perm(t1, t3, 0x7632);
        }
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NG * 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
  }
  cp_async_wait<0>();

  // epilogue.  Tile j's accumulator column 2t + e is physical column
  // 4 (2t + e) + j of its group: the thread's 8 values of a row are the
  // consecutive columns 8t .. 8t + 7, value 4e + j.
  // (VEC: N % 16 == 0 and 16-byte aligned rows, so a column in range has
  // its whole run of 8 in range too)
#pragma unroll
  for (int q = 0; q < NG; ++q) {
    const int col = n0 + wn + 32 * q + 8 * t;
    if (col >= n) continue;
    float wsc[8];
    if constexpr (!SPLIT) {
#pragma unroll
      for (int c = 0; c < 8; ++c) wsc[c] = col + c < n ? ws[col + c] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < MI; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + i * 16 + g + 8 * h;
        if (row >= m) continue;
        int v[8];
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int j = 0; j < 4; ++j) v[4 * e + j] = acc[i][4 * q + j][2 * h + e];
        if constexpr (SPLIT) {
          int* dst = part + ((size_t)blockIdx.z * m + row) * n + col;
          if constexpr (VEC) {
            reinterpret_cast<int4*>(dst)[0] = make_int4(v[0], v[1], v[2], v[3]);
            reinterpret_cast<int4*>(dst)[1] = make_int4(v[4], v[5], v[6], v[7]);
          } else {
#pragma unroll
            for (int c = 0; c < 8; ++c)
              if (col + c < n) dst[c] = v[c];
          }
        } else {
          const float xr = xs[row];
          float o[8];
#pragma unroll
          for (int c = 0; c < 8; ++c)
            o[c] = __fmul_rn(__fmul_rn(__int2float_rn(v[c]), xr), wsc[c]);
          float* dst = out + (size_t)row * n + col;
          if constexpr (VEC) {
            reinterpret_cast<float4*>(dst)[0] = make_float4(o[0], o[1], o[2], o[3]);
            reinterpret_cast<float4*>(dst)[1] = make_float4(o[4], o[5], o[6], o[7]);
          } else {
#pragma unroll
            for (int c = 0; c < 8; ++c)
              if (col + c < n) dst[c] = o[c];
          }
        }
      }
    }
  }
}

// out = float(sum_s part[s]) * xs[row] * ws[col], the int32 sum exact
__global__ void __launch_bounds__(256)
quant_splitk_epilogue_kernel(const int* __restrict__ part, int splits,
                             const float* __restrict__ xs,
                             const float* __restrict__ ws,
                             float* __restrict__ out, int m, int n) {
  const size_t total = (size_t)m * n;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    int s = 0;
    for (int z = 0; z < splits; ++z) s += part[z * total + i];
    const int row = (int)(i / n), col = (int)(i % n);
    out[i] = __fmul_rn(__fmul_rn(__int2float_rn(s), xs[row]), ws[col]);
  }
}

template <int BM, int BN, int WM, int WN, int STAGES, bool VEC, bool SPLIT>
int launch_route(const int8_t* a, const int8_t* b, const float* sa,
                 const float* sb, float* o, int* part, int m, int k, int n,
                 int splits, cudaStream_t s) {
  constexpr int smem = STAGES * (BM * LDA + BK * BN);
  constexpr int NT = (BM / WM) * (BN / WN) * 32;
  auto kernel = quant_matmul_kernel<BM, BN, WM, WN, STAGES, VEC, SPLIT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int k_split = ((k + BK - 1) / BK + splits - 1) / splits * BK;
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, splits);
  kernel<<<grid, NT, smem, s>>>(a, b, sa, sb, o, part, m, k, n, k_split);
  return (int)cudaGetLastError();
}

template <int BM, int BN, int WM, int WN, int STAGES>
int launch_tiles(bool vec, bool split, const int8_t* a, const int8_t* b,
                 const float* sa, const float* sb, float* o, int* part, int m,
                 int k, int n, int splits, cudaStream_t s) {
  if (vec && split)
    return launch_route<BM, BN, WM, WN, STAGES, true, true>(
        a, b, sa, sb, o, part, m, k, n, splits, s);
  if (vec)
    return launch_route<BM, BN, WM, WN, STAGES, true, false>(
        a, b, sa, sb, o, part, m, k, n, 1, s);
  if (split)
    return launch_route<BM, BN, WM, WN, STAGES, false, true>(
        a, b, sa, sb, o, part, m, k, n, splits, s);
  return launch_route<BM, BN, WM, WN, STAGES, false, false>(
      a, b, sa, sb, o, part, m, k, n, 1, s);
}

}  // namespace

// out = (xq @ wq) * xs * ws for xq [m, k], wq [k, n] int8, xs [m, 1], ws [1, n]
// float32, out [m, n] float32, all contiguous on the current device.  `route`
// picks the tiles (0: 128 x 128, 1: 64 x 128, 2: 16 x 128); with `splits` > 1
// K is split across that many blocks per tile, and `part` is int32 scratch of
// [splits, m, n] that a second kernel sums.  Launches on `stream` and returns
// the CUDA error of the launches (0 on success), or -1 for arguments the
// kernels do not take.
extern "C" int quant_matmul_fwd(const void* xq, const void* wq, const void* xs,
                                const void* ws, void* out, void* part, int m,
                                int k, int n, int route, int splits,
                                void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || route < 0 || route > 2 || splits < 1 ||
      splits > 65535 || (splits > 1 && part == nullptr))
    return -1;
  const bool vec = k % 16 == 0 && n % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(xq) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(wq) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(part) % 16 == 0;
  const bool split = splits > 1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* a = static_cast<const int8_t*>(xq);
  const int8_t* b = static_cast<const int8_t*>(wq);
  const float* sa = static_cast<const float*>(xs);
  const float* sb = static_cast<const float*>(ws);
  float* o = static_cast<float*>(out);
  int* p = static_cast<int*>(part);
  int err;
  if (route == 0) {
    err = launch_tiles<128, 128, 64, 64, 3>(vec, split, a, b, sa, sb, o, p, m, k, n, splits, s);
  } else if (route == 1) {
    err = launch_tiles<64, 128, 32, 64, 4>(vec, split, a, b, sa, sb, o, p, m, k, n, splits, s);
  } else {
    err = launch_tiles<16, 128, 16, 32, 4>(vec, split, a, b, sa, sb, o, p, m, k, n, splits, s);
  }
  if (err != 0 || !split) return err;
  const size_t total = (size_t)m * n;
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  quant_splitk_epilogue_kernel<<<blocks, 256, 0, s>>>(p, splits, sa, sb, o, m, n);
  return (int)cudaGetLastError();
}
