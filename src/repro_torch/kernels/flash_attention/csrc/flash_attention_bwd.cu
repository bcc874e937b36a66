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
// is 3.46e10 operations on 55 MB: 0.210 ms at the H100's f32-accurate product
// rate (three TF32 passes at 495 TFLOP/s, as the forward's mma.sync tiles
// take), 0.516 ms at its f32 FMA rate of 67 TFLOP/s, 0.016 ms for the bytes,
// so operations bound it.
//
// Design: f32 FMAs on the CUDA cores (mma/wgmma tiles in split TF32 are
// later work), three kernels a call, every sum in a fixed order, so a call
// gives the same bits every time:
// * flash_bwd_delta_kernel: Di = rowsum(dO o), one warp a row.
// * flash_bwd_dkdv_kernel: one block of 256 threads per (bh, 64-key tile).
//   Its K and V tiles stay in shared memory while it sweeps the 64-row q
//   tiles that can see them (the causal band starts at the tile's first
//   key, the window band ends window - 1 rows past its last).  For each q
//   tile it recomputes S and dP = dO v^T (each thread a 4 x 4 patch, rows
//   and columns strided by 16), forms P and dS in shared memory, and
//   accumulates dV += P^T dO and dK += dS^T q in registers.
// * flash_bwd_dq_kernel: one block per (bh, 64-row q tile) sweeps the key
//   tiles its rows can see, recomputes S, dP and dS the same way and
//   accumulates dQ += dS k.  dQ takes a pass of its own instead of f32
//   atomics from the dK/dV sweep (which would sum in a different order on
//   every call); it costs a second recomputation of S and dP, 7 products
//   where 5 are needed.
// Shared-memory rows have odd strides (D + 1 and 65 floats), so that the
// column reads of a warp hit distinct banks.

#include <cuda_runtime.h>
#include <math_constants.h>

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

}  // namespace

// dq, dk, dv [bh, sq|sk, d] float32 of softmax(q k^T * scale) v under the
// masks, from q, o, dout [bh, sq, d], k, v [bh, sk, d] and the forward's lse
// [bh, sq], all contiguous float32 on the current device; delta: scratch of
// bh * sq floats (receives rowsum(dout o)).  Launches three kernels on
// `stream` and returns the CUDA error of the launches (0 on success), or -1
// for a head dim other than 8, 16, 32 and 64.
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
    case 64: return launch<64>(fq, fk, fv, fo, fl, fd, fdel, fdq, fdk, fdv, bh, sq, sk, scale, causal, has_window, window, st);
    default: return -1;
  }
}
