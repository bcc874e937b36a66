// Flash-attention backward (FlashAttention-2 style) for Hopper.
//
// Replaces no Pallas kernel.  The JAX package's flash attention carries a
// custom_vjp whose backward, `_flash_bwd` in
// src/repro/kernels/flash_attention/ops.py, is the VJP of the plain jnp
// attention; XLA compiles it.  The port's forward is a CUDA kernel with no
// autograd rule of its own, so its torch.autograd.Function needs this kernel
// for a training path on the card (whisper's encoder): nothing plain runs
// there.  Same function as that VJP: for q [BH, Sq, D], k and v [BH, Sk, D]
// float32, the output o and its upstream gradient dO [BH, Sq, D], and the
// forward's row log-sum-exp lse [BH, Sq] of the scaled, masked scores
// (flash_attention.cu writes it; +inf for a row that sees no key),
//   P  = exp(q k^T * scale - lse), 0 where the causal or window mask hides
//        the key (and for keys past Sk),
//   Di = rowsum(dO o),
//   dV = P^T dO,   dS = P * (dO v^T - Di),
//   dQ = scale * dS k,   dK = scale * dS^T q,
// for any Sq and Sk, at head dims 8, 16, 32 and 64.  The plain version is
// attention_bwd_ref in ../ref.py.
//
// Bound.  Five products the size of the score matrix (S, dP, dV, dK, dQ):
// 10 BH Sq Sk D operations, against q, k, v, o and dO read once and dq, dk
// and dv written once.  At whisper-tiny's encoder (BH 24, S 1500, D 64) that
// is 3.46e10 operations on 55 MB: 0.2095 ms at the H100's f32-accurate
// product rate (three TF32 passes at 495 TFLOP/s, below), 0.516 ms at its
// f32 FMA rate of 67 TFLOP/s, 0.016 ms for the bytes, so operations bound
// it.  The design below does 7 such products (S and dP twice): 0.293 ms at
// three TF32 passes.
//
// Tolerance decision.  The gate is 1e-5 * max(1, max |ref|) against the
// plain f32 version.  One TF32 pass per product misses it by about 100x at
// (1500, 1500, 64); three passes (x = hi + lo, lo*hi + hi*lo + hi*hi, f32
// sums) hold it with 10x to spare (tests/test_torch_flash_attention.py
// emulates both).  The tensor cores truncate as they accumulate, so no mma
// chain sums more than 8 k steps: each 64-wide tile's product sums into
// fresh registers that join the running dK, dV or dQ with rounded f32 adds.
// The truncation biases S toward 0, and an error in S is a relative one in
// P = exp(S * scale - lse), where the forward's lse does not cancel it: S
// and dP sum in chains of 4 k steps (M_CHAIN_S).
//
// Design, one route by shape:
//
// * f32, D = 64 (whisper's encoder): split-TF32 mma.sync.m16n8k8 tiles for
//   all products, two kernels a call.
//   - flash_bwd_delta_kernel: Di = rowsum(dO o), one warp a row.
//   - flash_bwd_mma64_kernel: blocks of 4 warps in two roles, one grid.
//     A dK/dV block (bh, 64-key tile) keeps its K and V tiles in shared
//     memory and sweeps the query tiles that can see them, key-major as in
//     FlashAttention-2: S^T = K Q^T and dP^T = V dO^T with the warp's 16
//     keys as the mma M dimension, then P^T and dS^T = P^T (dP^T - Di) in
//     the accumulators, which with a permuted k index (k = t <-> query 2t,
//     k = t + 4 <-> 2t + 1) are the A fragments of dV += P^T dO and
//     dK += dS^T Q as they stand.  A dQ block (bh, 64-row query tile) keeps
//     Q and dO and sweeps the key tiles its rows can see: S = Q K^T,
//     dP = dO V^T, dS in the accumulators as the A fragment of dQ += dS K.
//     The streamed tiles (with lse and Di for the dK/dV role) come through
//     a 2-stage cp.async ring of 16-byte copies, zero-filled past the end.
//     Every tile row is 68 floats: the fragment loads, at (row g, column t)
//     or (row 2t, column g), hit 32 distinct banks.  Tiles wholly outside
//     the causal or window band are skipped; tiles inside it and inside
//     Sq and Sk skip the mask.  The dK/dV blocks come first in the grid and
//     the dQ blocks take their query tiles last-first, so that under a
//     causal mask the longest sweeps start first.
//   dQ scheme: a sweep of its own that recomputes S and dP (7 products for
//   5), chosen over summing each key tile's dQ part into a global dQ in
//   key-tile order from the dK/dV sweep.  The ordered sum would make each
//   block wait on the key tile before it for every query tile: no such
//   wait can hang the card when fewer blocks are resident than key tiles,
//   none stalls the causal sweep (the block of key tile j would wait for
//   the j tiles before it to reach its first query tile), and no zeroed
//   workspace is needed.  Every sum runs in a fixed order, with no atomics,
//   so a call gives the same bits every time, and no scratch grows with
//   Sq * Sk (Di is BH * Sq floats).
//
// * Head dims 8, 16 and 32 (the JAX package's kernel grid and toy sizes
//   only): f32 FMAs on the CUDA cores, three kernels a call, every sum in a
//   fixed order.  A rule by shape, not a fallback: nothing gives way at run
//   time.
//   - flash_bwd_delta_kernel, as above.
//   - flash_bwd_dkdv_kernel: one block of 256 threads per (bh, 64-key
//     tile).  Its K and V tiles stay in shared memory while it sweeps the
//     64-row q tiles that can see them (the causal band starts at the
//     tile's first key, the window band ends window - 1 rows past its
//     last).  For each q tile it recomputes S and dP = dO v^T (each thread
//     a 4 x 4 patch, rows and columns strided by 16), forms P and dS in
//     shared memory, and accumulates dV += P^T dO and dK += dS^T q in
//     registers.
//   - flash_bwd_dq_kernel: one block per (bh, 64-row q tile) sweeps the key
//     tiles its rows can see, recomputes S, dP and dS the same way and
//     accumulates dQ += dS k.
//   Shared-memory rows have odd strides (D + 1 and 65 floats), so that the
//   column reads of a warp hit distinct banks.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BQ = 64, BK = 64, NT = 256;
constexpr int LP = BK + 1;   // P and dS rows

__device__ __forceinline__ bool visible(int key, int row, int sk, int causal,
                                        int has_window, int window) {
  return key < sk && (!causal || key <= row) &&
         (!has_window || key > row - window);
}

// a [64][D] output tile over 256 threads: CG column groups of RD columns
// (strided by CG), RG row groups of RR rows (strided by RG)
template <int D>
struct OutTile {
  static constexpr int RD = D >= 32 ? D / 16 : 1;
  static constexpr int CG = D / RD;
  static constexpr int RG = NT / CG;
  static constexpr int RR = 64 / RG;
  static_assert(RD * CG == D && RG * RR == 64, "output tile");
};

// rows [r0, r0 + 64) of a [n, D] array into shared memory (stride D + 1),
// zero past n
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int r0,
                                          int n) {
  constexpr int LD = D + 1;
  for (int i = threadIdx.x; i < 64 * D; i += NT) {
    const int r = i / D, c = i % D;
    dst[r * LD + c] = r0 + r < n ? src[(size_t)(r0 + r) * D + c] : 0.f;
  }
}

// the 4 x 4 patch of S = q k^T and dP = dO v^T at rows ty + 16 i of the q
// tile and columns tx + 16 j of the key tile
template <int D>
__device__ __forceinline__ void scores(const float* sQ, const float* sO,
                                       const float* sK, const float* sV, int ty,
                                       int tx, float (&s)[4][4],
                                       float (&dp)[4][4]) {
  constexpr int LD = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = sQ[(ty + 16 * i) * LD + d];
      ov[i] = sO[(ty + 16 * i) * LD + d];
      kv[i] = sK[(tx + 16 * i) * LD + d];
      vv[i] = sV[(tx + 16 * i) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
      }
  }
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_delta_kernel(const float* __restrict__ o,
                       const float* __restrict__ dout,
                       float* __restrict__ delta, long long rows) {
  const long long row = (long long)blockIdx.x * (NT / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32)
    acc = fmaf(o[row * D + c], dout[row * D + c], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

template <int D>
constexpr int dkdv_smem_floats() {
  return 2 * BK * (D + 1) + 2 * BQ * (D + 1) + 2 * BQ * LP + 2 * BQ;
}

template <int D>
__global__ void __launch_bounds__(NT, 2)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dk,
                      float* __restrict__ dv, int sq, int sk, float scale,
                      int causal, int has_window, int window) {
  constexpr int LD = D + 1;
  using T = OutTile<D>;
  extern __shared__ float smem[];
  float* sK = smem;                 // [BK][LD]
  float* sV = sK + BK * LD;         // [BK][LD]
  float* sQ = sV + BK * LD;         // [BQ][LD]
  float* sO = sQ + BQ * LD;         // [BQ][LD]: dO
  float* sP = sO + BQ * LD;         // [BQ][LP]
  float* sS = sP + BQ * LP;         // [BQ][LP]: dS
  float* sL = sS + BQ * LP;         // [BQ]: lse
  float* sD = sL + BQ;              // [BQ]: Di

  const int bh = blockIdx.y, k0 = blockIdx.x * BK, tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int rg = tid / T::CG, cg = tid % T::CG;
  const size_t qoff = (size_t)bh * sq * D, koff = (size_t)bh * sk * D;
  load_rows<D>(sK, k + koff, k0, sk);
  load_rows<D>(sV, v + koff, k0, sk);

  float acc_k[T::RR][T::RD], acc_v[T::RR][T::RD];
#pragma unroll
  for (int i = 0; i < T::RR; ++i)
#pragma unroll
    for (int j = 0; j < T::RD; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  // the rows that can see a key of this tile: the causal band starts at its
  // first key, the window band ends window - 1 rows past its last
  int q_begin = 0, q_end = sq;
  if (causal) q_begin = k0 / BQ * BQ;
  if (has_window) q_end = min(sq, k0 + BK - 1 + window);

  for (int qt = q_begin; qt < q_end; qt += BQ) {
    __syncthreads();   // the previous tile's reads are done
    load_rows<D>(sQ, q + qoff, qt, sq);
    load_rows<D>(sO, dout + qoff, qt, sq);
    if (tid < BQ) {
      const int row = qt + tid;
      sL[tid] = row < sq ? lse[(size_t)bh * sq + row] : CUDART_INF_F;
      sD[tid] = row < sq ? delta[(size_t)bh * sq + row] : 0.f;
    }
    __syncthreads();
    float s[4][4], dp[4][4];
    scores<D>(sQ, sO, sK, sV, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, row = qt + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const bool ok = row < sq &&
                        visible(k0 + c, row, sk, causal, has_window, window);
        const float p = ok ? expf(s[i][j] * scale - sL[r]) : 0.f;
        sP[r * LP + c] = p;
        sS[r * LP + c] = p * (dp[i][j] - sD[r]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < BQ; ++r) {
      float pv[T::RR], sv[T::RR], ov[T::RD], qv[T::RD];
#pragma unroll
      for (int i = 0; i < T::RR; ++i) {
        pv[i] = sP[r * LP + rg + T::RG * i];
        sv[i] = sS[r * LP + rg + T::RG * i];
      }
#pragma unroll
      for (int j = 0; j < T::RD; ++j) {
        ov[j] = sO[r * LD + cg + T::CG * j];
        qv[j] = sQ[r * LD + cg + T::CG * j];
      }
#pragma unroll
      for (int i = 0; i < T::RR; ++i)
#pragma unroll
        for (int j = 0; j < T::RD; ++j) {
          acc_v[i][j] = fmaf(pv[i], ov[j], acc_v[i][j]);
          acc_k[i][j] = fmaf(sv[i], qv[j], acc_k[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < T::RR; ++i) {
    const int key = k0 + rg + T::RG * i;
    if (key >= sk) continue;
#pragma unroll
    for (int j = 0; j < T::RD; ++j) {
      const size_t at = koff + (size_t)key * D + cg + T::CG * j;
      dk[at] = acc_k[i][j] * scale;
      dv[at] = acc_v[i][j];
    }
  }
}

template <int D>
constexpr int dq_smem_floats() {
  return 2 * BQ * (D + 1) + 2 * BK * (D + 1) + BQ * LP + 2 * BQ;
}

template <int D>
__global__ void __launch_bounds__(NT, 2)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int sq, int sk, float scale, int causal, int has_window,
                    int window) {
  constexpr int LD = D + 1;
  using T = OutTile<D>;
  extern __shared__ float smem[];
  float* sQ = smem;                 // [BQ][LD]
  float* sO = sQ + BQ * LD;         // [BQ][LD]: dO
  float* sK = sO + BQ * LD;         // [BK][LD]
  float* sV = sK + BK * LD;         // [BK][LD]
  float* sS = sV + BK * LD;         // [BQ][LP]: dS
  float* sL = sS + BQ * LP;         // [BQ]
  float* sD = sL + BQ;              // [BQ]

  const int bh = blockIdx.y, q0 = blockIdx.x * BQ, tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int rg = tid / T::CG, cg = tid % T::CG;
  const size_t qoff = (size_t)bh * sq * D, koff = (size_t)bh * sk * D;
  load_rows<D>(sQ, q + qoff, q0, sq);
  load_rows<D>(sO, dout + qoff, q0, sq);
  if (tid < BQ) {
    const int row = q0 + tid;
    sL[tid] = row < sq ? lse[(size_t)bh * sq + row] : CUDART_INF_F;
    sD[tid] = row < sq ? delta[(size_t)bh * sq + row] : 0.f;
  }

  float acc[T::RR][T::RD];
#pragma unroll
  for (int i = 0; i < T::RR; ++i)
#pragma unroll
    for (int j = 0; j < T::RD; ++j) acc[i][j] = 0.f;

  // the keys this q tile can see, as in the forward
  int k_begin = 0, k_end = sk;
  if (causal) k_end = min(sk, q0 + BQ);
  if (has_window) k_begin = max(0, q0 - window + 1) / BK * BK;

  for (int kt = k_begin; kt < k_end; kt += BK) {
    __syncthreads();   // the previous tile's reads are done
    load_rows<D>(sK, k + koff, kt, sk);
    load_rows<D>(sV, v + koff, kt, sk);
    __syncthreads();
    float s[4][4], dp[4][4];
    scores<D>(sQ, sO, sK, sV, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, row = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const bool ok = row < sq &&
                        visible(kt + c, row, sk, causal, has_window, window);
        const float p = ok ? expf(s[i][j] * scale - sL[r]) : 0.f;
        sS[r * LP + c] = p * (dp[i][j] - sD[r]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float sv[T::RR], kv[T::RD];
#pragma unroll
      for (int i = 0; i < T::RR; ++i) sv[i] = sS[(rg + T::RG * i) * LP + c];
#pragma unroll
      for (int j = 0; j < T::RD; ++j) kv[j] = sK[c * LD + cg + T::CG * j];
#pragma unroll
      for (int i = 0; i < T::RR; ++i)
#pragma unroll
        for (int j = 0; j < T::RD; ++j) acc[i][j] = fmaf(sv[i], kv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < T::RR; ++i) {
    const int row = q0 + rg + T::RG * i;
    if (row >= sq) continue;
#pragma unroll
    for (int j = 0; j < T::RD; ++j)
      dq[qoff + (size_t)row * D + cg + T::CG * j] = acc[i][j] * scale;
  }
}

// ------------------------------------------------- tensor-core helpers
// (as in flash_attention.cu)

constexpr float kLog2e = 1.4426950408889634f;

// x ~ hi + lo, both TF32 (f32 bit patterns with the low 13 bits zero): hi
// is x cut to 10 mantissa bits, lo the exact remainder x - hi cut the same
// way, so hi + lo is x to 20 bits.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32: the two cross terms first, then hi * hi
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(ok ? 16 : 0)   // 0: zero-fill
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// ------------------------------------------- f32, D = 64: mma.sync tiles

constexpr int M_BT = 64, M_NT = 128, M_STAGES = 2;
constexpr int M_LD = 64 + 4;                 // every tile row, in floats
constexpr int M_TILE = M_BT * M_LD;          // one [64][M_LD] tile
constexpr int M_STAGE = 2 * M_TILE + 2 * M_BT;   // two tiles, lse and Di
constexpr int M_SMEM = (2 * M_TILE + M_STAGES * M_STAGE) * (int)sizeof(float);
// k steps per mma chain of S and dP.  An error in S is one in P's exponent,
// so its chains are shorter than the other products' (8): at whisper-tiny's
// encoder shape the kernel's distance from the plain version fell from
// 6.0e-6 to 3.9e-6 of max(1, max |ref|) for about 3 % more time
// (tools/flash_bwd_bench.py, PERF.md).
constexpr int M_CHAIN_S = 4;

// rows [r0, r0 + 64) of a [n, 64] array into a tile, zero past n; 16-byte
// cp.async copies, 8 a thread
__device__ __forceinline__ void load_tile64(float* dst, const float* src,
                                            int r0, int n) {
#pragma unroll
  for (int i = 0; i < M_BT * 64 / 4 / M_NT; ++i) {
    const int c = threadIdx.x + i * M_NT, row = c / 16, col = (c % 16) * 4;
    const bool ok = r0 + row < n;
    cp_async16(dst + row * M_LD + col,
               src + (size_t)(ok ? r0 + row : 0) * 64 + col, ok);
  }
}

__device__ __forceinline__ void zero(float (&x)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[i][e] = 0.f;
}

// acc += fresh, the rounded f32 add that joins an mma chain to a sum
__device__ __forceinline__ void join(float (&acc)[8][4], const float (&fresh)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] += fresh[i][e];
}

// out = A B^T over k = 0..63 for one warp's 16 rows of A (at a) and the 64
// rows of B: out[j] covers B's rows 8j..8j+7.  Both tiles row-major in
// shared memory; fragments at (row g, k t | t + 4).  Chains of M_CHAIN_S
// k steps, joined with f32 adds.
__device__ __forceinline__ void mma_nt(float (&out)[8][4], const float* a,
                                       const float* b, int g, int t) {
  zero(out);
#pragma unroll
  for (int k0 = 0; k0 < 8; k0 += M_CHAIN_S) {
    float f[8][4];
    zero(f);
#pragma unroll
    for (int kk = k0; kk < k0 + M_CHAIN_S; ++kk) {
      const float* ar = a + g * M_LD + 8 * kk + t;
      uint32_t ah[4], al[4];
      split(ar[0], ah[0], al[0]);
      split(ar[8 * M_LD], ah[1], al[1]);
      split(ar[4], ah[2], al[2]);
      split(ar[8 * M_LD + 4], ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float* br = b + (8 * j + g) * M_LD + 8 * kk + t;
        uint32_t bh[2], bl[2];
        split(br[0], bh[0], bl[0]);
        split(br[4], bh[1], bl[1]);
        mma_3xtf32(f[j], ah, al, bh, bl);
      }
    }
    join(out, f);
  }
}

// out = P B over k = 0..63 (one chain of eight k steps) for P in
// accumulator form (p[j] covers k = 8j..8j+7 of the warp's 16 rows) and B
// [64][64] row-major in shared memory: out[n] covers B's columns 8n..8n+7.
// The k index is permuted (k = t <-> column 2t of p[j], k = t + 4 <->
// 2t + 1), so the accumulator is the A fragment as it stands and B loads at
// (row 2t, g).
__device__ __forceinline__ void mma_nn(float (&out)[8][4], const float (&p)[8][4],
                                       const float* b, int g, int t) {
  zero(out);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint32_t ph[4], pl[4];
    split(p[j][0], ph[0], pl[0]);   // row g,     k t
    split(p[j][2], ph[1], pl[1]);   // row g + 8, k t
    split(p[j][1], ph[2], pl[2]);   // row g,     k t + 4
    split(p[j][3], ph[3], pl[3]);   // row g + 8, k t + 4
    const float* br = b + (8 * j + 2 * t) * M_LD + g;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      uint32_t bh[2], bl[2];
      split(br[8 * n], bh[0], bl[0]);
      split(br[M_LD + 8 * n], bh[1], bl[1]);
      mma_3xtf32(out[n], ph, pl, bh, bl);
    }
  }
}

struct BwdArgs {
  const float *q, *k, *v, *dout, *lse, *delta;
  float *dq, *dk, *dv;
  int sq, sk;
  float scale;
  int causal, has_window, window;
};

// The dK/dV role: keys [k0, k0 + 64) of head bh.  Accumulator element
// (j, e) of a warp sits at key 16 warp + g + 8 (e >> 1) of the tile and
// query 8j + 2t + (e & 1) of the streamed tile.
__device__ __forceinline__ void dkdv_tile(float* sm, const BwdArgs& a, int bh,
                                          int k0) {
  const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  float* sK = sm;                // [64][M_LD]
  float* sV = sK + M_TILE;       // [64][M_LD]
  float* ring = sV + M_TILE;     // [M_STAGES] x (Q, dO tiles, lse, Di)
  const int sq = a.sq, sk = a.sk;
  const float* qb = a.q + (size_t)bh * sq * 64;
  const float* ob = a.dout + (size_t)bh * sq * 64;
  const float* lb = a.lse + (size_t)bh * sq;
  const float* db = a.delta + (size_t)bh * sq;

  // the rows that can see a key of this tile: the causal band starts at its
  // first key, the window band ends window - 1 rows past its last
  int q_begin = 0, q_end = sq;
  if (a.causal) q_begin = k0;
  if (a.has_window) q_end = min(sq, k0 + M_BT - 1 + a.window);
  const int n_tiles = q_end > q_begin ? (q_end - q_begin + M_BT - 1) / M_BT : 0;

  auto load = [&](int tile) {
    const int qt = q_begin + tile * M_BT;
    float* st = ring + (tile % M_STAGES) * M_STAGE;
    load_tile64(st, qb, qt, sq);
    load_tile64(st + M_TILE, ob, qt, sq);
    if (tid < M_BT) {
      float* sL = st + 2 * M_TILE;
      if (qt + tid < sq) {
        cp_async4(sL + tid, lb + qt + tid);
        cp_async4(sL + M_BT + tid, db + qt + tid);
      } else {   // a row past Sq: P = exp(s - inf) = 0
        sL[tid] = CUDART_INF_F;
        sL[M_BT + tid] = 0.f;
      }
    }
  };
  load_tile64(sK, a.k + (size_t)bh * sk * 64, k0, sk);
  load_tile64(sV, a.v + (size_t)bh * sk * 64, k0, sk);
  if (n_tiles > 0) load(0);
  cp_async_commit();

  const float scale_log2 = a.scale * kLog2e;
  const int key0 = k0 + 16 * warp + g;   // this lane's keys: key0, key0 + 8
  float dk[8][4], dv[8][4];
  zero(dk);
  zero(dv);
  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) load(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* cQ = ring + (it % M_STAGES) * M_STAGE;
    const float* cO = cQ + M_TILE;
    const float* cL = cO + M_TILE;
    const float* cD = cL + M_BT;
    const int qt = q_begin + it * M_BT;

    float s[8][4], dp[8][4];
    mma_nt(s, sK + 16 * warp * M_LD, cQ, g, t);    // S^T = K Q^T
    mma_nt(dp, sV + 16 * warp * M_LD, cO, g, t);   // dP^T = V dO^T

    // P^T into s, dS^T into dp.  Rows past Sq read lse = inf and give 0;
    // keys past Sk give dK and dV rows that are never stored.
    auto probs = [&](auto masked) {
      constexpr bool MASKED = decltype(masked)::value;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(cL + 8 * j + 2 * t);
        const float2 d2 = *reinterpret_cast<const float2*>(cD + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lse = (e & 1) ? l2.y : l2.x, di = (e & 1) ? d2.y : d2.x;
          float p = exp2f(fmaf(s[j][e], scale_log2, -lse * kLog2e));
          if (MASKED && !visible(key0 + 8 * (e >> 1), qt + 8 * j + 2 * t + (e & 1),
                                 sk, a.causal, a.has_window, a.window))
            p = 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - di);
        }
      }
    };
    // the tile lies inside the band when its last key is at or before its
    // first row (causal) and its first key after its last row - window
    if ((a.causal && k0 + M_BT - 1 > qt) ||
        (a.has_window && k0 <= qt + M_BT - 1 - a.window))
      probs(std::true_type{});
    else
      probs(std::false_type{});

    float fresh[8][4];
    mma_nn(fresh, s, cO, g, t);    // dV += P^T dO
    join(dv, fresh);
    mma_nn(fresh, dp, cQ, g, t);   // dK += dS^T Q
    join(dk, fresh);
    __syncthreads();   // this stage's reads are done before it is refilled
  }
  cp_async_wait<0>();

  const size_t koff = (size_t)bh * sk * 64;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + 8 * i;
    if (key >= sk) continue;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const size_t at = koff + (size_t)key * 64 + 8 * n + 2 * t;
      *reinterpret_cast<float2*>(a.dk + at) =
          make_float2(dk[n][2 * i] * a.scale, dk[n][2 * i + 1] * a.scale);
      *reinterpret_cast<float2*>(a.dv + at) =
          make_float2(dv[n][2 * i], dv[n][2 * i + 1]);
    }
  }
}

// The dQ role: rows [q0, q0 + 64) of head bh.  Accumulator element (j, e)
// of a warp sits at row 16 warp + g + 8 (e >> 1) of the tile and key
// 8j + 2t + (e & 1) of the streamed tile.
__device__ __forceinline__ void dq_tile(float* sm, const BwdArgs& a, int bh,
                                        int q0) {
  const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  float* sQ = sm;                // [64][M_LD]
  float* sO = sQ + M_TILE;       // [64][M_LD]: dO
  float* ring = sO + M_TILE;     // [M_STAGES] x (K, V tiles)
  const int sq = a.sq, sk = a.sk;
  const float* kb = a.k + (size_t)bh * sk * 64;
  const float* vb = a.v + (size_t)bh * sk * 64;

  // the keys this q tile can see, as in the forward
  int k_begin = 0, k_end = sk;
  if (a.causal) k_end = min(sk, q0 + M_BT);
  if (a.has_window) k_begin = max(0, q0 - a.window + 1) / M_BT * M_BT;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + M_BT - 1) / M_BT : 0;

  auto load = [&](int tile) {
    float* st = ring + (tile % M_STAGES) * M_STAGE;
    load_tile64(st, kb, k_begin + tile * M_BT, sk);
    load_tile64(st + M_TILE, vb, k_begin + tile * M_BT, sk);
  };
  load_tile64(sQ, a.q + (size_t)bh * sq * 64, q0, sq);
  load_tile64(sO, a.dout + (size_t)bh * sq * 64, q0, sq);
  if (n_tiles > 0) load(0);
  cp_async_commit();

  const float scale_log2 = a.scale * kLog2e;
  const int row0 = q0 + 16 * warp + g;   // this lane's rows: row0, row0 + 8
  float lse2[2], di[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    const bool ok = row < sq;   // a row past Sq is never stored
    lse2[i] = ok ? a.lse[(size_t)bh * sq + row] * kLog2e : CUDART_INF_F;
    di[i] = ok ? a.delta[(size_t)bh * sq + row] : 0.f;
  }
  float dq[8][4];
  zero(dq);
  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) load(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* cK = ring + (it % M_STAGES) * M_STAGE;
    const float* cV = cK + M_TILE;
    const int kt = k_begin + it * M_BT;

    float s[8][4], dp[8][4];
    mma_nt(s, sQ + 16 * warp * M_LD, cK, g, t);    // S = Q K^T
    mma_nt(dp, sO + 16 * warp * M_LD, cV, g, t);   // dP = dO V^T

    // dS into dp.  Keys past Sk are masked: K's zero rows would add 0, but
    // exp(0 - lse) need not be finite.
    auto probs = [&](auto masked) {
      constexpr bool MASKED = decltype(masked)::value;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(fmaf(s[j][e], scale_log2, -lse2[e >> 1]));
          if (MASKED && !visible(kt + 8 * j + 2 * t + (e & 1), row0 + 8 * (e >> 1),
                                 sk, a.causal, a.has_window, a.window))
            p = 0.f;
          dp[j][e] = p * (dp[j][e] - di[e >> 1]);
        }
    };
    if (kt + M_BT > sk || (a.causal && kt + M_BT - 1 > q0) ||
        (a.has_window && kt <= q0 + M_BT - 1 - a.window))
      probs(std::true_type{});
    else
      probs(std::false_type{});

    float fresh[8][4];
    mma_nn(fresh, dp, cK, g, t);   // dQ += dS K
    join(dq, fresh);
    __syncthreads();   // this stage's reads are done before it is refilled
  }
  cp_async_wait<0>();

  const size_t qoff = (size_t)bh * sq * 64;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= sq) continue;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<float2*>(a.dq + qoff + (size_t)row * 64 + 8 * n + 2 * t) =
          make_float2(dq[n][2 * i] * a.scale, dq[n][2 * i + 1] * a.scale);
  }
}

// grid (BH, nk + nq): y < nk a dK/dV block of key tile y, else a dQ block of
// query tile nq - 1 - (y - nk)
__global__ void __launch_bounds__(M_NT, 2)
flash_bwd_mma64_kernel(BwdArgs a) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int nk = (a.sk + M_BT - 1) / M_BT, nq = (a.sq + M_BT - 1) / M_BT;
  const int y = blockIdx.y;
  if (y < nk)
    dkdv_tile(sm, a, blockIdx.x, y * M_BT);
  else
    dq_tile(sm, a, blockIdx.x, (nq - 1 - (y - nk)) * M_BT);
}

// cudaFuncSetAttribute once per kernel and device (bit d of `done`)
cudaError_t allow_smem(const void* kernel, int bytes, unsigned long long& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (done >> dev) & 1ull) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) done |= 1ull << dev;
  return err;
}

template <int D>
int launch(const float* q, const float* k, const float* v, const float* o,
           const float* lse, const float* dout, float* delta, float* dq,
           float* dk, float* dv, int bh, int sq, int sk, float scale,
           int causal, int has_window, int window, cudaStream_t stream) {
  static unsigned long long done_kv = 0, done_q = 0;
  constexpr int kv_bytes = dkdv_smem_floats<D>() * (int)sizeof(float);
  constexpr int q_bytes = dq_smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = allow_smem((const void*)flash_bwd_dkdv_kernel<D>, kv_bytes,
                               done_kv);
  if (err == cudaSuccess)
    err = allow_smem((const void*)flash_bwd_dq_kernel<D>, q_bytes, done_q);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)bh * sq;
  flash_bwd_delta_kernel<D><<<(unsigned)((rows + NT / 32 - 1) / (NT / 32)), NT,
                              0, stream>>>(o, dout, delta, rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  flash_bwd_dkdv_kernel<D><<<dim3((sk + BK - 1) / BK, bh), NT, kv_bytes,
                             stream>>>(q, k, v, dout, lse, delta, dk, dv, sq,
                                       sk, scale, causal, has_window, window);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<D><<<dim3((sq + BQ - 1) / BQ, bh), NT, q_bytes,
                           stream>>>(q, k, v, dout, lse, delta, dq, sq, sk,
                                     scale, causal, has_window, window);
  return (int)cudaGetLastError();
}

int launch_mma64(const BwdArgs& a, const float* o, float* delta, int bh,
                 cudaStream_t stream) {
  static unsigned long long done = 0;
  cudaError_t err = allow_smem((const void*)flash_bwd_mma64_kernel, M_SMEM, done);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)bh * a.sq;
  flash_bwd_delta_kernel<64><<<(unsigned)((rows + NT / 32 - 1) / (NT / 32)), NT,
                               0, stream>>>(o, a.dout, delta, rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int nk = (a.sk + M_BT - 1) / M_BT, nq = (a.sq + M_BT - 1) / M_BT;
  flash_bwd_mma64_kernel<<<dim3(bh, nk + nq), M_NT, M_SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// dq, dk, dv [bh, sq|sk, d] float32 of softmax(q k^T * scale) v under the
// masks, from q, o, dout [bh, sq, d], k, v [bh, sk, d] and the forward's lse
// [bh, sq], all contiguous float32 on the current device; delta: scratch of
// bh * sq floats (receives rowsum(dout o)).  Launches two kernels (head dim
// 64) or three (8, 16, 32) on `stream` and returns the CUDA error of the
// launches (0 on success), or -1 for another head dim.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* o, const void* lse,
                                   const void* dout, void* delta, void* dq,
                                   void* dk, void* dv, int bh, int sq, int sk,
                                   int d, float scale, int causal,
                                   int has_window, int window, void* stream) {
  const float *fq = static_cast<const float*>(q), *fk = static_cast<const float*>(k),
              *fv = static_cast<const float*>(v), *fo = static_cast<const float*>(o),
              *fl = static_cast<const float*>(lse),
              *fd = static_cast<const float*>(dout);
  float *fdel = static_cast<float*>(delta), *fdq = static_cast<float*>(dq),
        *fdk = static_cast<float*>(dk), *fdv = static_cast<float*>(dv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 8:  return launch<8>(fq, fk, fv, fo, fl, fd, fdel, fdq, fdk, fdv, bh, sq, sk, scale, causal, has_window, window, st);
    case 16: return launch<16>(fq, fk, fv, fo, fl, fd, fdel, fdq, fdk, fdv, bh, sq, sk, scale, causal, has_window, window, st);
    case 32: return launch<32>(fq, fk, fv, fo, fl, fd, fdel, fdq, fdk, fdv, bh, sq, sk, scale, causal, has_window, window, st);
    case 64: return launch_mma64(BwdArgs{fq, fk, fv, fd, fl, fdel, fdq, fdk, fdv, sq, sk, scale, causal, has_window, window}, fo, fdel, bh, st);
    default: return -1;
  }
}
