// Blockwise online-softmax attention (FlashAttention forward) for Hopper.
//
// Replaces the Pallas TPU kernel `_attn_kernel` / `flash_attention` in
// src/repro/kernels/flash_attention/kernel.py.  Same function: for q, k, v of
// shape [BH, S, D] (f32 or bf16), out = softmax(q k^T * scale) v per head,
// with a padding guard, optional causal and sliding-window masks, masked
// probabilities zeroed explicitly, a row whose softmax sum is 0 giving 0,
// NEG_INF = -1e30 as the running-max floor, and rectangular Sq != Sk.  All
// sums are f32 (running max, sum and accumulator); the output is written in
// the input's dtype.
//
// Bound at the path's shapes.  4*BH*Sq*Sk*D operations against q, k, v and o
// read or written once.  The MMDiT joint attention at full SD3 width (BH 96
// for two CFG-doubled requests, S 4429, D 64, f32) does 4.8e11 operations on
// 436 MB: 1.1e3 operations a byte, bound by operations.  On the CUDA cores
// (f32 FMA, 67 TFLOP/s on an H100 SXM) that bound is 7.2 ms; on the tensor
// cores with three TF32 passes per product (below) it is 4.8e11 / (495e12 /
// 3) = 2.9 ms.  Flux's joint attention at published width (BH 24, S 4096
// image + 512 text tokens, D 128, f32, no CFG rows) does 2.6e11 operations
// on 226 MB: 1.58 ms at the 3xTF32 rate, 3.89 ms at the f32 FMA rate.  The
// text encoder's attention (BH 4, S 333, D 1024) does 1.8e9 operations on
// 22 MB: 0.027 ms at the f32 FMA rate, 0.011 ms at the 3xTF32 rate, 0.0065
// ms for its bytes.
//
// Tolerance decision.  The path's f32 gate is atol = rtol = 2e-5 against the
// plain f32 version.  One TF32 product keeps 10 mantissa bits and misses that
// gate by 4-50x at the path's shapes; split-precision TF32 (3xTF32) holds it
// with 20x to spare (tests/test_torch_flash_attention.py emulates both).  So
// every f32 operand x is split into TF32 parts hi and lo (split() below),
// and every product is lo*hi + hi*lo + hi*hi on the tensor cores
// (mma.sync.m16n8k8 TF32, or wgmma m64nNk8 at D = 128, f32 accumulators),
// for q k^T and for P v alike.  The tensor cores truncate as they
// accumulate, so no chain of sums runs longer than 8 k steps: each K/V
// tile (and each 64-wide slice of D = 1024) sums into fresh registers that
// join the running sums with rounded f32 adds.  Without that the D = 1024
// error crossed the gate (2.6e-5 at BH 8).
//
// Design, one route per shape (the wrapper asks flash_attention_scratch_floats
// for the scratch a route needs):
//
// * f32, D = 64 (the MMDiT shape): FlashAttention-2 layout, flash_mma64_kernel.
//   One block of 4 warps per (bh, 64 query rows); each warp owns 16 rows, and
//   its running max, sum and output accumulator stay in mma accumulator
//   registers for the whole K sweep.  q's fragments (pre-scaled by
//   scale*log2(e), so the softmax uses exp2) are split once per block.  K and
//   V stream in 64-key tiles through a 2-stage cp.async ring (16-byte
//   copies, zero-filled past Sk) with padded rows (72 and 68 floats) so that
//   the fragment loads hit 32 distinct banks.  The k index of each 8-wide mma
//   step is permuted (k = t <-> key 2t, k = t+4 <-> key 2t+1) so that the
//   score accumulator of q k^T is already P's A fragment for P v, and q and K
//   fragments load as float2.  Row max and sum are quad shuffles.  Tiles
//   wholly outside the causal or window band are skipped, and tiles with
//   nothing to mask skip the mask arithmetic.
// * f32, D = 128 (Flux's heads): a pre-pass, then a warp-specialised
//   wgmma kernel.  What bounds it: the 3xTF32 operations (1.58 ms at
//   (24, 4608, 128)); of bytes, each block reads its head's split planes
//   once, 8.1 GB from L2 a call at 128 query rows a block.  The route's
//   earlier mma.sync version reached 35 % of that bound: every warp split
//   every K and V element it read, and 253 registers left one 8-warp block
//   an SM.
//   (1) flash_split128_kernel splits K and V once a call into TF32 hi and
//   lo planes, V transposed with each 8-key group's keys in the order 0 2 4
//   6 1 3 5 7 (the D = 64 trick: the score accumulator is P's A fragment),
//   laid out tile by tile as the main kernel's shared memory holds them
//   (128-byte swizzled K-major atoms, the layout wgmma's descriptors read),
//   keys past Sk zero: 4*BH*ceil(Sk/32)*32*128 floats of scratch (226 MB at
//   Flux's shape).  (2) flash_wgmma128_kernel: one block a (bh, 128 query
//   rows), a producer warpgroup that copies each 32-key tile's K and V^T
//   halves with one TMA bulk copy each into rings of 3 and 2 stages on
//   mbarriers (so the padding guard is the pre-pass's zeros), and two
//   consumer warpgroups of 64 rows (setmaxnreg: 24 and 240 registers).
//   Each consumer keeps q hi in registers as wgmma's A fragments and q lo in
//   shared memory; q k^T is two chains of 8 k steps (D's halves) of three
//   m64n32k8 products into fresh accumulators joined by an f32 add, P v a
//   fresh m64n128 chain of 4 k steps of three products a tile, joined to
//   the output by an f32 FMA.  Chains: tests/test_torch_flash_attention.py
//   emulates this order with every tensor-core sum truncated: 3.0e-7 (cut)
//   and 1.9e-7 (rna) against float64 at (1, 4608, 4608, 128), a 67x margin
//   under the 2e-5 gate; accumulating P v into the output itself (one
//   chain of 1728 products over 4608 keys) reads 6.5e-6, and 4.6e-5 with
//   V + 1, over the gate.  The consumers take turns at the tensor cores
//   (named barriers: one issues its q k^T or P v products only after the
//   other issued its own), so that one's softmax runs beside the other's
//   products.  Tiles and turns by measurement (tools/flash_fwd128_bench.py
//   at (24, 4608, 128), H100 80GB HBM3, 700 W, the medians of three
//   turns): 3 K and 2 V^T stages, m64n128 P v, turns 2.19-2.29 ms (device
//   time 2.004 main kernel + 0.119 pre-pass, 74 % of the bound); 2 and 2
//   stages, m64n64 halves, no turns 2.36-2.42; turns with 2 K stages
//   2.55-2.72 (the warpgroup that lags holds its stage); the earlier
//   mma.sync version 4.49-4.71 (4.383 device) in the same run.  What is left: the
//   last of 6.5 waves of blocks runs 55 % full, about 6 % of the time.
//   168 registers at launch, 225 KB of shared memory, no spill.
// * f32, D = 1024 (the text encoder's head): a split-KV grid.  With 4 KB a
//   row of q there is no room for a long K sweep per block, and one block per
//   (bh, q tile) leaves most of the 132 SMs idle (84 blocks at BH 4).
//   flash_splitkv_kernel takes one (bh, 32 query rows, 64-key chunk): q k^T
//   over D in 64-wide slices, the chunk's softmax in shared memory, and P v in
//   128-column V tiles, all through one 3-stage cp.async ring; it writes the
//   chunk's unnormalised output with its row max m and row sum l to scratch
//   (a wholly masked chunk writes o = 0, m = NEG_INF, l = 0 and stops).
//   264 blocks at BH 4, two per SM.  flash_merge_kernel then forms
//   o = sum_i e^(m_i - M) o_i / sum_i e^(m_i - M) l_i over the chunks with
//   l_i > 0 (a row with none gives 0), for any number of chunks.  The
//   scratch holds C*BH*Sq*(D + 2) floats, C = ceil(Sk / 64): 33 MB at
//   (4, 333, 1024), growing with Sq*Sk.  Plain versions of both passes:
//   ref.py attention_partial_ref and merge_partials_ref.
// * Every other case (head dims 8, 16, 32, used only by the JAX package's
//   kernel grid and toy sizes, and bf16 inputs at any head dim): the CUDA-core
//   template flash_fwd_kernel, one block per (bh, q tile) sweeping all K/V
//   tiles, products as f32 FMAs on tiles kept in shared memory with odd row
//   strides, 64x64 tiles (16x16 at D = 1024; 116 KB of shared memory at
//   D = 128).  A rule by shape and type, not a fallback: nothing falls back
//   at run time.  Other head dims are refused (the wrapper raises).
//
// For training, the f32 routes at D <= 64 (the tensor-core tiles and the
// CUDA-core template) also write each row's log-sum-exp of the scaled,
// masked scores when the caller passes an lse array (one [BH, Sq] f32 store
// after the sweep; serving passes none and pays nothing).  The backward
// kernels (flash_attention_bwd.cu) recompute the probabilities from it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;   // the TPU kernel's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ------------------------------------------------ CUDA-core template

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
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int sq, int sk, float scale,
                 int causal, int has_window, int window) {
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
    if (lse != nullptr && tc == 0)   // the backward's row log-sum-exp
      lse[(size_t)bh * sq + qr] = l[i] == 0.f ? CUDART_INF_F : m[i] + logf(l[i]);
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);   // fully masked rows
#pragma unroll
    for (int c = 0; c < OC; ++c)
      store_from_f32(ob + (size_t)qr * D + tc + c * TC, acc[i][c] * inv);
  }
}


// ------------------------------------------------- tensor-core helpers

// x ~ hi + lo, both TF32 (f32 bit patterns with the low 13 bits zero): hi
// is x cut to 10 mantissa bits, lo the exact remainder x - hi cut the same
// way, so hi + lo is x to 20 bits.  Cutting costs one LOP3; rounding to
// nearest (cvt.rna.tf32.f32) compiles to a compare-and-select sequence on
// sm_90a that made the D = 64 kernel 1.4x slower (PERF.md).
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

// A fragment (16 x 8, row-major) from two row pairs: a0 (row g, k t),
// a1 (row g+8, k t), a2 (row g, k t+4), a3 (row g+8, k t+4); with the
// permuted k order, .x is k = t and .y is k = t+4
__device__ __forceinline__ void split_a(float2 top, float2 bot, uint32_t (&h)[4],
                                        uint32_t (&l)[4]) {
  split(top.x, h[0], l[0]);
  split(bot.x, h[1], l[1]);
  split(top.y, h[2], l[2]);
  split(bot.y, h[3], l[3]);
}

// B fragment (8 x 8, col-major): b0 (k t, n g), b1 (k t+4, n g)
__device__ __forceinline__ void split_b(float b0, float b1, uint32_t (&h)[2],
                                        uint32_t (&l)[2]) {
  split(b0, h[0], l[0]);
  split(b1, h[1], l[1]);
}

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

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ bool visible(int key, int row, int sk, int causal,
                                        int has_window, int window) {
  return key < sk && (!causal || key <= row) &&
         (!has_window || key > row - window);
}

// Online softmax of one tile's scores in a warp's mma accumulator layout:
// s[j][e] sits at row (e < 2 ? r0 : r1), key kt + 8j + 2t + (e & 1).  Masks
// (MASKED), moves the running max m_run (log2 units) and the lane's part of
// the row sums l_run, gives the accumulators' rescale factors in alpha, and
// leaves the probabilities in s.
template <bool MASKED, int NJ>
__device__ __forceinline__ void tile_softmax(float (&s)[NJ][4], float (&m_run)[2],
                                             float (&l_run)[2], float (&alpha)[2],
                                             int kt, int t, int r0, int r1, int sk,
                                             int causal, int has_window,
                                             int window) {
  float mx[2] = {kNegInf, kNegInf};
  uint32_t ok = 0xffffffffu;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (MASKED) {
        const bool vis = visible(kt + 8 * j + 2 * t + (e & 1), e < 2 ? r0 : r1,
                                 sk, causal, has_window, window);
        ok &= ~((uint32_t)!vis << (4 * j + e));
        s[j][e] = vis ? s[j][e] : kNegInf;
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float m_new = fmaxf(m_run[i], quad_max(mx[i]));
    alpha[i] = exp2f(m_run[i] - m_new);
    m_run[i] = m_new;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // zero masked probabilities explicitly: a fully masked tile must add
      // 0, not exp(NEG_INF - NEG_INF) = 1
      const float p = (!MASKED || ((ok >> (4 * j + e)) & 1u))
                          ? exp2f(s[j][e] - m_run[e >> 1]) : 0.f;
      s[j][e] = p;
      rs[e >> 1] += p;
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) l_run[i] = alpha[i] * l_run[i] + rs[i];
}

// ------------------------------------------- f32, D = 64: mma.sync tiles

constexpr int M64_BQ = 64, M64_BK = 64, M64_NT = 128, M64_STAGES = 2;
constexpr int M64_LDK = 64 + 8;   // float2 loads at (key g, dim 2t): 8g + 2t
constexpr int M64_LDV = 64 + 4;   // loads at (key 2t, dim g): 8t + g
constexpr int M64_SMEM =
    M64_STAGES * M64_BK * (M64_LDK + M64_LDV) * (int)sizeof(float);

__global__ void __launch_bounds__(M64_NT)
flash_mma64_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ o,
                   float* __restrict__ lse, int sq, int sk, float scale_log2,
                   int causal, int has_window, int window) {
  constexpr int D = 64, BQ = M64_BQ, BK = M64_BK, NT = M64_NT;
  constexpr int STAGES = M64_STAGES, LDK = M64_LDK, LDV = M64_LDV;
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);   // [STAGES][BK][LDK]
  float* sV = sK + STAGES * BK * LDK;            // [STAGES][BK][LDV]

  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const float* kb = k + (size_t)bh * sk * D;
  const float* vb = v + (size_t)bh * sk * D;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;   // this lane's two rows

  // the K range this q tile can see: the causal band ends at its last row,
  // the window band starts window-1 keys before its first row
  int k_begin = 0, k_end = sk;
  if (causal) k_end = min(sk, q0 + BQ);
  if (has_window) k_begin = max(0, q0 - window + 1) / BK * BK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  auto load_tile = [&](int tile) {
    const int kt = k_begin + tile * BK, stage = tile % STAGES;
    float* dK = sK + stage * BK * LDK;
    float* dV = sV + stage * BK * LDV;
#pragma unroll
    for (int i = 0; i < BK * D / 4 / NT; ++i) {   // 16-byte chunks
      const int c = tid + i * NT, row = c / (D / 4), col = (c % (D / 4)) * 4;
      const bool ok = kt + row < sk;              // padding guard: zero rows
      const size_t off = (size_t)(ok ? kt + row : 0) * D + col;
      cp_async16(dK + row * LDK + col, kb + off, ok);
      cp_async16(dV + row * LDV + col, vb + off, ok);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_tiles) load_tile(s);
    cp_async_commit();
  }

  // q fragments, pre-scaled and split once: step kk covers dims 8kk..8kk+7,
  // k = t <-> dim 8kk+2t and k = t+4 <-> dim 8kk+2t+1
  uint32_t qh[D / 8][4], ql[D / 8][4];
  {
    const float* qb = q + (size_t)bh * sq * D;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      float2 top = make_float2(0.f, 0.f), bot = top;
      if (r0 < sq) top = *reinterpret_cast<const float2*>(qb + (size_t)r0 * D + 8 * kk + 2 * t);
      if (r1 < sq) bot = *reinterpret_cast<const float2*>(qb + (size_t)r1 * D + 8 * kk + 2 * t);
      top.x *= scale_log2; top.y *= scale_log2;
      bot.x *= scale_log2; bot.y *= scale_log2;
      split_a(top, bot, qh[kk], ql[kk]);
    }
  }

  float acc[D / 8][4];   // output: n-tile n covers dims 8n..8n+7
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};   // rows r0, r1 (log2 units)
  float l_run[2] = {0.f, 0.f};           // this lane's part of the row sums

  for (int it = 0; it < n_tiles; ++it) {
    if (it + STAGES - 1 < n_tiles) load_tile(it + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncthreads();
    const float* cK = sK + (it % STAGES) * BK * LDK;
    const float* cV = sV + (it % STAGES) * BK * LDV;
    const int kt = k_begin + it * BK;

    // s = q k^T: n-tile j covers keys kt+8j..kt+8j+7
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const float2 kv =
            *reinterpret_cast<const float2*>(cK + (8 * j + g) * LDK + 8 * kk + 2 * t);
        uint32_t bh_[2], bl_[2];
        split_b(kv.x, kv.y, bh_, bl_);
        mma_3xtf32(s[j], qh[kk], ql[kk], bh_, bl_);
      }
    }

    // online softmax.  A tile inside Sk with no causal or window band
    // takes the unmasked instance (every tile of the MMDiT path but its
    // last).
    float alpha[2];
    if (kt + BK <= sk && !causal && !has_window)
      tile_softmax<false>(s, m_run, l_run, alpha, kt, t, r0, r1, sk, causal,
                          has_window, window);
    else
      tile_softmax<true>(s, m_run, l_run, alpha, kt, t, r0, r1, sk, causal,
                         has_window, window);

    // pv = P v over this tile: k step j covers keys kt+8j..; P's A fragment
    // is s[j] itself (k = t <-> key 2t, k = t+4 <-> key 2t+1).  The tensor
    // cores truncate as they accumulate, so each tile sums into fresh
    // registers and joins the running output with a rounded f32 FMA.
    float pv[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[n][e] = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      uint32_t ph[4], pl[4];
      split_a(make_float2(s[j][0], s[j][1]), make_float2(s[j][2], s[j][3]), ph, pl);
      const float* v0 = cV + (8 * j + 2 * t) * LDV + g;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t bh_[2], bl_[2];
        split_b(v0[8 * n], v0[LDV + 8 * n], bh_, bl_);
        mma_3xtf32(pv[n], ph, pl, bh_, bl_);
      }
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = fmaf(acc[n][e], alpha[e >> 1], pv[n][e]);
    __syncthreads();   // this stage's reads are done before it is refilled
  }
  cp_async_wait<0>();

  float* ob = o + (size_t)bh * sq * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i ? r1 : r0;
    const float l = quad_sum(l_run[i]);
    const float inv = 1.f / (l == 0.f ? 1.f : l);   // fully masked rows
    if (row >= sq) continue;
    if (lse != nullptr && t == 0)   // the backward's row log-sum-exp
      lse[(size_t)bh * sq + row] =
          l == 0.f ? CUDART_INF_F : (m_run[i] + log2f(l)) * kLn2;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(ob + (size_t)row * D + 8 * n + 2 * t) =
          make_float2(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
  }
}

// ------------------------------------------- f32, D = 128: wgmma tiles

// Hopper's warpgroup instructions, as PTX: the asynchronous TF32 products
// (A from shared memory or registers, B from shared memory through a
// descriptor), the mbarriers and bulk copies of the load ring, and the
// register hand-over between the producer and the consumer warpgroups.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A K-major operand in 128-byte swizzled atoms (8 rows of 128 bytes, the
// 16-byte chunk c of row r stored at chunk c ^ (r % 8)), atoms of a column
// stacked every 1024 bytes: start address, LBO 1 (unused when swizzled),
// SBO 1024, layout SWIZZLE_128B.  A k step of 8 TF32 values advances the
// start by 32 bytes within the atom's row.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3ffffu) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// byte offset of the float at (row r, column c < 32) of a column of atoms
__host__ __device__ constexpr int sw128(int r, int c) {
  return r * 128 + ((((c >> 2) ^ r) & 7) << 4) + (c & 3) * 4;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// ties registers to the instructions around it, so that the compiler
// neither reads an accumulator before wgmma_wait nor reuses an operand's
// register while a product still reads it
template <int R, int C, typename T>
__device__ __forceinline__ void fence_regs(T (&x)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) {
      if constexpr (std::is_same<T, float>::value)
        asm volatile("" : "+f"(x[i][j]) :: "memory");
      else
        asm volatile("" : "+r"(x[i][j]) :: "memory");
    }
}

__device__ __forceinline__ void wgmma_n32_ss(float (&d)[4][4], uint64_t a, uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n32_rs(float (&d)[4][4], const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n64_rs(float (&d)[8][4], const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n128_rs(float (&d)[16][4], const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// P v's m64nNk8 with A from registers, N = 8 * NJ (64 or 128)
template <int NJ>
__device__ __forceinline__ void wgmma_rs(float (&d)[NJ][4], const uint32_t (&a)[4],
                                         uint64_t b, int scale_d) {
  static_assert(NJ == 8 || NJ == 16, "m64n64k8 or m64n128k8");
  if constexpr (NJ == 8) wgmma_n64_rs(d, a, b, scale_d);
  else wgmma_n128_rs(d, a, b, scale_d);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
// returns once the barrier's phase of this parity has completed; a phase
// that has not completed after 2^35 cycles (about 20 s, where a tile load
// takes microseconds) traps, so a fault fails the launch instead of
// hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > (1ll << 35)) __trap();
  }
}
// one TMA bulk copy of `bytes` contiguous bytes, its completion counted on
// the barrier's transaction count
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// The split planes.  flash_split128_kernel writes, for each head and each
// tile of W128_BK keys, the 64 KB image that the main kernel's producer
// copies into shared memory as it stands: K hi and K lo (key rows, 128
// dims in four columns of 128-byte atoms), then V^T hi and V^T lo (128 dim
// rows, the tile's keys along the row), each TF32 part cut as split() cuts
// it, keys past Sk zero.  Within each 8-key group V^T holds the keys in
// the order 0 2 4 6 1 3 5 7, so that the score accumulator of q k^T is P's
// A fragment as it stands (k = t <-> key 2t, k = t+4 <-> key 2t+1).  Plain
// version: ref.py split_planes_ref.
constexpr int W128_BK = 32;                          // keys a K/V tile
constexpr int W128_PLANE = W128_BK * 128;            // floats of one plane
constexpr int W128_HALF = 2 * W128_PLANE * 4;        // bytes of K (or V^T) hi + lo
constexpr int W128_TILE_FLOATS = 4 * W128_PLANE;     // floats of a tile's image

__device__ __forceinline__ void split4(float4 x, float4& hi, float4& lo) {
  uint32_t h, l;
  split(x.x, h, l); hi.x = __uint_as_float(h); lo.x = __uint_as_float(l);
  split(x.y, h, l); hi.y = __uint_as_float(h); lo.y = __uint_as_float(l);
  split(x.z, h, l); hi.z = __uint_as_float(h); lo.z = __uint_as_float(l);
  split(x.w, h, l); hi.w = __uint_as_float(h); lo.w = __uint_as_float(l);
}

__global__ void __launch_bounds__(256)
flash_split128_kernel(const float* __restrict__ k, const float* __restrict__ v,
                      float* __restrict__ planes, int sk) {
  constexpr int D = 128, BK = W128_BK, NT = 256;
  __shared__ float sV[BK][D + 1];
  const int tile = blockIdx.x, bh = blockIdx.y, kt = tile * BK, tid = threadIdx.x;
  char* img = reinterpret_cast<char*>(
      planes + ((size_t)bh * gridDim.x + tile) * W128_TILE_FLOATS);
  const float* kb = k + (size_t)bh * sk * D;
  const float* vb = v + (size_t)bh * sk * D;
  // K: 16-byte chunk c of key row r (dims 4c..4c+3) to atom column c / 8
#pragma unroll
  for (int i = 0; i < BK * D / 4 / NT; ++i) {
    const int idx = tid + i * NT, r = idx / (D / 4), c = idx % (D / 4);
    const bool ok = kt + r < sk;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
    if (ok) {
      x = reinterpret_cast<const float4*>(kb + (size_t)(kt + r) * D)[c];
      y = reinterpret_cast<const float4*>(vb + (size_t)(kt + r) * D)[c];
    }
    float4 hi, lo;
    split4(x, hi, lo);
    const int off = (c >> 3) * (BK * 128) + sw128(r, 4 * (c & 7));
    *reinterpret_cast<float4*>(img + off) = hi;
    *reinterpret_cast<float4*>(img + 4 * W128_PLANE + off) = lo;
    sV[r][4 * c] = y.x; sV[r][4 * c + 1] = y.y;
    sV[r][4 * c + 2] = y.z; sV[r][4 * c + 3] = y.w;
  }
  __syncthreads();
  // V^T: chunk lc of dim row d holds tile slots 4lc..4lc+3, the keys
  // key0, key0+2, key0+4, key0+6 of 8-key group lc / 2
  char* vimg = img + W128_HALF;
#pragma unroll
  for (int i = 0; i < D * BK / 4 / NT; ++i) {
    const int idx = tid + i * NT, d = idx / (BK / 4), lc = idx % (BK / 4);
    const int key0 = 8 * (lc >> 1) + (lc & 1);
    float4 hi, lo;
    split4(make_float4(sV[key0][d], sV[key0 + 2][d], sV[key0 + 4][d],
                       sV[key0 + 6][d]), hi, lo);
    const int off = (lc >> 3) * (D * 128) + sw128(d, 4 * (lc & 7));
    *reinterpret_cast<float4*>(vimg + off) = hi;
    *reinterpret_cast<float4*>(vimg + 4 * W128_PLANE + off) = lo;
  }
}

// The main kernel: one block a (bh, 128 query rows), three warpgroups.
// Warpgroup 0 is the producer (24 registers): one thread walks the block's
// K/V tiles and copies each tile's K half (32 KB) and V^T half (32 KB) of
// the split planes into rings of W128_KS and W128_VS stages with one bulk
// copy each, signalled on an mbarrier; the consumers release a stage on
// another mbarrier (256 arrivals) once their products have read it.
// Warpgroups 1 and 2 (240 registers) own 64 query rows each.  Each keeps
// its q pre-scaled and split: hi as the A fragments of q k^T's 16 k steps
// in registers (64), lo in shared memory (32 KB, swizzled as K).  Per tile:
// S = q k^T as two chains of 8 k steps (D's halves) of three m64n32k8
// products (q lo * K hi from shared memory, q hi * K lo and q hi * K hi
// from registers) into fresh accumulators, joined by an f32 add; the online
// softmax of tile_softmax on S as it lies in the accumulators; P split
// once into its A fragments; then P v's 4 k steps of three products into
// a fresh accumulator (W128_PVN output columns at a time), joined to the
// output by a rounded f32 FMA.  No chain is longer than 8 k steps.
// stages of the K and V^T rings; the output columns a P v accumulator takes
// (64: two m64n64 halves of D, 128: all of D at once);
// and whether the two consumer warpgroups take turns at the tensor cores
// (W128_PP = 1: each issues a section of products, q k^T or P v, only when
// the other has issued its own, so that one's softmax runs beside the
// other's products)
constexpr int W128_KS = 3, W128_VS = 2, W128_PVN = 128, W128_PP = 1;
constexpr int W128_BQ = 128, W128_NT = 384;
constexpr int W128_QLO = 64 * 128 * 4;    // bytes of a consumer's q lo

template <int KS, int VS>
constexpr int w128_smem() {
  return 1024 + 2 * W128_QLO + (KS + VS) * W128_HALF + 2 * (KS + VS) * 8;
}

template <int KS, int VS, int PVN, int PP>
__global__ void __launch_bounds__(W128_NT, 1)
flash_wgmma128_kernel(const float* __restrict__ q, const float* __restrict__ planes,
                      float* __restrict__ o, int sq, int sk, float scale_log2,
                      int causal, int has_window, int window) {
  constexpr int D = 128, BQ = W128_BQ, BK = W128_BK, NJ = BK / 8;
  static_assert(BK == 32, "one atom column of V^T a tile; P v chains of 4");
  extern __shared__ uint8_t smem_raw[];
  // the swizzled atoms want 1024-byte alignment
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sbase = smem_raw + (base - raw);
  const uint32_t s_qlo = base;                     // [2][32 KB]
  const uint32_t s_k = s_qlo + 2 * W128_QLO;       // [KS][32 KB]
  const uint32_t s_v = s_k + KS * W128_HALF;       // [VS][32 KB]
  const uint32_t s_bar = s_v + VS * W128_HALF;     // full/empty of K, V
  const uint32_t full_k = s_bar, empty_k = s_bar + 8 * KS;
  const uint32_t full_v = s_bar + 16 * KS, empty_v = full_v + 8 * VS;

  const int bh = blockIdx.y, q0 = blockIdx.x * BQ, tid = threadIdx.x;
  int k_begin = 0, k_end = sk;
  if (causal) k_end = min(sk, q0 + BQ);
  if (has_window) k_begin = max(0, q0 - window + 1) / BK * BK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  if (tid == 0) {
    for (int s = 0; s < KS; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(empty_k + 8 * s, 256);
    }
    for (int s = 0; s < VS; ++s) {
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_v + 8 * s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {   // ------------------------------------ producer
    setmaxnreg_dec<24>();
    if (tid == 0) {
      const char* src = reinterpret_cast<const char*>(
          planes + ((size_t)bh * ((sk + BK - 1) / BK) + k_begin / BK) *
                       W128_TILE_FLOATS);
      for (int it = 0; it < n_tiles; ++it, src += 2 * W128_HALF) {
        const int ks = it % KS, vs = it % VS;
        mbar_wait(empty_k + 8 * ks, ((it / KS) & 1) ^ 1);
        mbar_expect_tx(full_k + 8 * ks, W128_HALF);
        bulk_load(s_k + ks * W128_HALF, src, W128_HALF, full_k + 8 * ks);
        mbar_wait(empty_v + 8 * vs, ((it / VS) & 1) ^ 1);
        mbar_expect_tx(full_v + 8 * vs, W128_HALF);
        bulk_load(s_v + vs * W128_HALF, src + W128_HALF, W128_HALF,
                  full_v + 8 * vs);
      }
    }
    return;
  }
  // ------------------------------------------------------------ consumers
  setmaxnreg_inc<240>();
  const int cw = tid / 128 - 1, ct = tid % 128;
  const int warp = ct >> 5, lane = ct & 31, g = lane >> 2, t = lane & 3;
  const int lr0 = 16 * warp + g;                   // rows within the 64
  const int r0 = q0 + 64 * cw + lr0, r1 = r0 + 8;  // this lane's two rows
  const uint32_t s_my_qlo = s_qlo + cw * W128_QLO;

  // q, pre-scaled by scale*log2(e): hi as the A fragment of k step kd (a0
  // row r0 dim 8kd+t, a1 row r1, a2 row r0 dim 8kd+t+4, a3 row r1), lo into
  // shared memory at the same places of a K-major swizzled 64 x 128 tile
  uint32_t qh[16][4];
  {
    const float* qb = q + (size_t)bh * sq * D;
    uint8_t* my_qlo = sbase + cw * W128_QLO;
#pragma unroll
    for (int kd = 0; kd < 16; ++kd)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = (e & 1) ? r1 : r0, lrow = lr0 + 8 * (e & 1);
        const int dim = 8 * kd + t + 4 * (e >> 1);
        const float x = row < sq ? qb[(size_t)row * D + dim] * scale_log2 : 0.f;
        uint32_t lo;
        split(x, qh[kd][e], lo);
        *reinterpret_cast<uint32_t*>(my_qlo + (dim >> 5) * 8192 +
                                     sw128(lrow, dim & 31)) = lo;
      }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + cw) : "memory");
  // turns (PP): named barrier 3 + w is warpgroup w's turn; each arrival
  // of the other warpgroup (128 threads) hands it one turn
  auto my_turn = [&] {
    if (PP) asm volatile("bar.sync %0, 256;\n" :: "r"(3 + cw) : "memory");
  };
  auto your_turn = [&] {
    if (PP) asm volatile("bar.arrive %0, 256;\n" :: "r"(4 - cw) : "memory");
  };
  if (cw == 1) your_turn();   // consumer 0 goes first

  float acc[D / 8][4];   // output: n-tile n covers dims 8n..8n+7
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};   // rows r0, r1 (log2 units)
  float l_run[2] = {0.f, 0.f};           // this lane's part of the row sums

  for (int it = 0; it < n_tiles; ++it) {
    const int ks = it % KS, vs = it % VS;
    const int kt = k_begin + it * BK;
    const uint32_t sK = s_k + ks * W128_HALF, sV = s_v + vs * W128_HALF;

    // S = q k^T: chain h sums dims 64h..64h+63 in 8 k steps of three
    // products into fresh registers (scale-d 0 on its first product)
    mbar_wait(full_k + 8 * ks, (it / KS) & 1);
    float c[2][NJ][4];
    my_turn();
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const int kd = 8 * h + kk;
        const uint64_t da = desc_sw128(s_my_qlo + (kd >> 2) * 8192 + (kd & 3) * 32);
        const uint64_t dkh = desc_sw128(sK + (kd >> 2) * (BK * 128) + (kd & 3) * 32);
        const uint64_t dkl = dkh + ((4 * W128_PLANE) >> 4);
        wgmma_n32_ss(c[h], da, dkh, kk);        // q lo * K hi
        wgmma_n32_rs(c[h], qh[kd], dkl, 1);     // q hi * K lo
        wgmma_n32_rs(c[h], qh[kd], dkh, 1);     // q hi * K hi
      }
    wgmma_commit();
    your_turn();
    wgmma_wait<0>();
    fence_regs(c[0]);
    fence_regs(c[1]);
    fence_regs(qh);
    mbar_arrive(empty_k + 8 * ks);
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = c[0][j][e] + c[1][j][e];

    // online softmax, as in flash_mma64_kernel
    float alpha[2];
    if (kt + BK <= sk && !causal && !has_window)
      tile_softmax<false>(s, m_run, l_run, alpha, kt, t, r0, r1, sk, causal,
                          has_window, window);
    else
      tile_softmax<true>(s, m_run, l_run, alpha, kt, t, r0, r1, sk, causal,
                         has_window, window);

    // P's A fragment of k step j (keys kt+8j..): a0 row r0 key 2t, a1 row
    // r1 key 2t, a2 row r0 key 2t+1, a3 row r1 key 2t+1; split once
    uint32_t ph[NJ][4], pl[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      split(s[j][0], ph[j][0], pl[j][0]);
      split(s[j][2], ph[j][1], pl[j][1]);
      split(s[j][1], ph[j][2], pl[j][2]);
      split(s[j][3], ph[j][3], pl[j][3]);
    }
    mbar_wait(full_v + 8 * vs, (it / VS) & 1);
    my_turn();
#pragma unroll
    for (int h = 0; h < D / PVN; ++h) {   // output dims PVN*h..
      float pv[PVN / 8][4];
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const uint64_t dvh = desc_sw128(sV + h * PVN * 128 + j * 32);
        const uint64_t dvl = dvh + ((4 * W128_PLANE) >> 4);
        wgmma_rs(pv, pl[j], dvh, j);            // P lo * V hi
        wgmma_rs(pv, ph[j], dvl, 1);            // P hi * V lo
        wgmma_rs(pv, ph[j], dvh, 1);            // P hi * V hi
      }
      wgmma_commit();
      if (h == D / PVN - 1) your_turn();
      wgmma_wait<0>();
      fence_regs(pv);
      fence_regs(ph);
      fence_regs(pl);
#pragma unroll
      for (int n = 0; n < PVN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[PVN / 8 * h + n][e] =
              fmaf(acc[PVN / 8 * h + n][e], alpha[e >> 1], pv[n][e]);
    }
    mbar_arrive(empty_v + 8 * vs);
  }
  if (cw == 0) my_turn();   // consumer 1's last hand-over

  float* ob = o + (size_t)bh * sq * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i ? r1 : r0;
    const float l = quad_sum(l_run[i]);
    const float inv = 1.f / (l == 0.f ? 1.f : l);   // fully masked rows
    if (row >= sq) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(ob + (size_t)row * D + 8 * n + 2 * t) =
          make_float2(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
  }
}

// ------------------------------------- f32, D = 1024: split-KV and merge

constexpr int SKV_D = 1024, SKV_BQ = 32, SKV_CK = 64, SKV_NT = 256;
constexpr int SKV_STAGES = 3;
constexpr int SKV_DS = 64;            // q k^T: dims per slice (16 slices)
constexpr int SKV_VC = 128;           // P v: output columns per V tile (8)
// warps tile a block as MT rows (one 16-row mma tile each) by NW / MT columns
constexpr int SKV_NW = SKV_NT / 32, SKV_MT = SKV_BQ / 16, SKV_WC = SKV_NW / SKV_MT;
constexpr int SKV_TN = SKV_CK / 8 / SKV_WC;   // q k^T n-tiles a warp owns
constexpr int SKV_WN = SKV_VC / 8 / SKV_WC;   // P v n-tiles a warp owns
static_assert(SKV_CK == 64 && SKV_NW % SKV_MT == 0 && SKV_BQ % SKV_NW == 0 &&
              SKV_TN * SKV_WC * 8 == SKV_CK && SKV_WN * SKV_WC * 8 == SKV_VC,
              "split-KV warp tiling");
constexpr int SKV_NS = SKV_D / SKV_DS, SKV_NV = SKV_D / SKV_VC;
constexpr int SKV_LDQ = SKV_DS + 8;   // 72: float2 loads, 8g + 2t
constexpr int SKV_LDV = SKV_VC + 4;   // 132: loads at (key 2t, col g): 8t + g
constexpr int SKV_LDP = SKV_CK + 8;   // 72
constexpr int SKV_STAGE_FLOATS =
    (SKV_BQ + SKV_CK) * SKV_LDQ > SKV_CK * SKV_LDV ? (SKV_BQ + SKV_CK) * SKV_LDQ
                                                   : SKV_CK * SKV_LDV;
constexpr int SKV_SMEM =
    (SKV_STAGES * SKV_STAGE_FLOATS + SKV_BQ * SKV_LDP) * (int)sizeof(float);

__host__ __device__ inline int skv_chunks(int sk) { return (sk + SKV_CK - 1) / SKV_CK; }

// scratch: o_part [C][BH][Sq][D], then m [C][BH][Sq], then l [C][BH][Sq]
__global__ void __launch_bounds__(SKV_NT)
flash_splitkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ part,
                     int nbh, int sq, int sk, float scale, int causal,
                     int has_window, int window) {
  constexpr int D = SKV_D, BQ = SKV_BQ, CK = SKV_CK, NT = SKV_NT;
  extern __shared__ float4 smem4[];
  float* sbuf = reinterpret_cast<float*>(smem4);   // [STAGES][STAGE_FLOATS]
  float* sP = sbuf + SKV_STAGES * SKV_STAGE_FLOATS; // [BQ][SKV_LDP]

  const int c = blockIdx.x, q0 = blockIdx.y * BQ, bh = blockIdx.z;
  const int c0 = c * CK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t rows = (size_t)nbh * sq;
  float* o_part = part + ((size_t)c * rows + (size_t)bh * sq) * D;
  float* m_part = part + (size_t)skv_chunks(sk) * rows * D + c * rows + (size_t)bh * sq;
  float* l_part = m_part + (size_t)skv_chunks(sk) * rows;

  // a chunk wholly outside every row's causal or window band adds nothing:
  // its partial is o = 0, m = NEG_INF, l = 0
  if ((causal && c0 > q0 + BQ - 1) ||
      (has_window && c0 + CK - 1 <= q0 - window)) {
    const int n_rows = min(BQ, sq - q0);
    for (int x = tid; x < n_rows * (D / 4); x += NT)
      reinterpret_cast<float4*>(o_part + (size_t)q0 * D)[x] =
          make_float4(0.f, 0.f, 0.f, 0.f);
    if (tid < n_rows) {
      m_part[q0 + tid] = kNegInf;
      l_part[q0 + tid] = 0.f;
    }
    return;
  }

  const float* qb = q + (size_t)bh * sq * D;
  const float* kb = k + (size_t)bh * sk * D;
  const float* vb = v + (size_t)bh * sk * D;

  // load i < SKV_NS: q and K slice i (dims 64i..); else V tile i - SKV_NS
  // (columns 128(i - SKV_NS)..) of the chunk's keys
  constexpr int N_LOADS = SKV_NS + SKV_NV;
  auto load = [&](int i) {
    float* dst = sbuf + (i % SKV_STAGES) * SKV_STAGE_FLOATS;
    if (i >= N_LOADS) {
      // nothing left to load: an empty group keeps the wait count uniform
    } else if (i < SKV_NS) {
      const int d0 = i * SKV_DS;
      for (int x = tid; x < (BQ + CK) * (SKV_DS / 4); x += NT) {
        const int row = x / (SKV_DS / 4), col = (x % (SKV_DS / 4)) * 4;
        const bool is_q = row < BQ;
        const int r = is_q ? q0 + row : c0 + row - BQ;
        const bool ok = r < (is_q ? sq : sk);
        const float* src = (is_q ? qb : kb) + (size_t)(ok ? r : 0) * D + d0 + col;
        cp_async16(dst + row * SKV_LDQ + col, src, ok);
      }
    } else {
      const int n0 = (i - SKV_NS) * SKV_VC;
      for (int x = tid; x < CK * (SKV_VC / 4); x += NT) {
        const int row = x / (SKV_VC / 4), col = (x % (SKV_VC / 4)) * 4;
        const bool ok = c0 + row < sk;
        cp_async16(dst + row * SKV_LDV + col,
                   vb + (size_t)(ok ? c0 + row : 0) * D + n0 + col, ok);
      }
    }
    cp_async_commit();
  };

  const int mt = warp % SKV_MT;     // 16-row tile: rows 16mt..16mt+15
  const int nb = warp / SKV_MT * SKV_TN;       // q k^T: key n-tiles nb..
  const int cb = warp / SKV_MT * 8 * SKV_WN;   // P v: its columns of a V tile
  float s[SKV_TN][4] = {};

  for (int i = 0; i < SKV_STAGES - 1; ++i) load(i);
  for (int i = 0; i < N_LOADS; ++i) {
    load(i + SKV_STAGES - 1);
    cp_async_wait<SKV_STAGES - 1>();
    __syncthreads();
    const float* cur = sbuf + (i % SKV_STAGES) * SKV_STAGE_FLOATS;
    if (i < SKV_NS) {
      const float* sQ = cur;
      const float* sK = cur + BQ * SKV_LDQ;
      // the tensor cores truncate as they accumulate: each slice sums into
      // fresh registers and joins s with a rounded f32 add
      float st[SKV_TN][4] = {};
#pragma unroll
      for (int kk = 0; kk < SKV_DS / 8; ++kk) {
        uint32_t ah[4], al[4];
        const float* qa = sQ + (16 * mt + g) * SKV_LDQ + 8 * kk + 2 * t;
        split_a(*reinterpret_cast<const float2*>(qa),
                *reinterpret_cast<const float2*>(qa + 8 * SKV_LDQ), ah, al);
#pragma unroll
        for (int jj = 0; jj < SKV_TN; ++jj) {
          const float2 kv = *reinterpret_cast<const float2*>(
              sK + (8 * (nb + jj) + g) * SKV_LDQ + 8 * kk + 2 * t);
          uint32_t bh_[2], bl_[2];
          split_b(kv.x, kv.y, bh_, bl_);
          mma_3xtf32(st[jj], ah, al, bh_, bl_);
        }
      }
#pragma unroll
      for (int jj = 0; jj < SKV_TN; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[jj][e] += st[jj][e];
      if (i == SKV_NS - 1) {
        // the chunk's scores to shared memory, then its softmax: each warp
        // takes BQ / NW rows, each lane keys lane and lane + 32
#pragma unroll
        for (int jj = 0; jj < SKV_TN; ++jj) {
          float* sp = sP + (16 * mt + g) * SKV_LDP + 8 * (nb + jj) + 2 * t;
          *reinterpret_cast<float2*>(sp) = make_float2(s[jj][0], s[jj][1]);
          *reinterpret_cast<float2*>(sp + 8 * SKV_LDP) = make_float2(s[jj][2], s[jj][3]);
        }
        __syncthreads();
        for (int rr = warp * (BQ / SKV_NW); rr < (warp + 1) * (BQ / SKV_NW); ++rr) {
          const int row = q0 + rr;
          float x[2], mx = kNegInf;
          bool vis[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            vis[h] = visible(c0 + lane + 32 * h, row, sk, causal, has_window, window);
            x[h] = vis[h] ? sP[rr * SKV_LDP + lane + 32 * h] * scale : kNegInf;
            mx = fmaxf(mx, x[h]);
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
          float sum = 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float p = vis[h] ? expf(x[h] - mx) : 0.f;   // masked: 0
            sP[rr * SKV_LDP + lane + 32 * h] = p;
            sum += p;
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            sum += __shfl_xor_sync(0xffffffffu, sum, off);
          if (lane == 0 && row < sq) {
            m_part[row] = mx;
            l_part[row] = sum;
          }
        }
      }
    } else {
      // o_part[:, 128 vt + cb ..] = P v over the chunk's 64 keys
      const float* sV = cur;
      const int vt = i - SKV_NS;
      float acc[SKV_WN][4] = {};
#pragma unroll
      for (int j = 0; j < CK / 8; ++j) {
        uint32_t ph[4], pl[4];
        const float* pa = sP + (16 * mt + g) * SKV_LDP + 8 * j + 2 * t;
        split_a(*reinterpret_cast<const float2*>(pa),
                *reinterpret_cast<const float2*>(pa + 8 * SKV_LDP), ph, pl);
        const float* v0 = sV + (8 * j + 2 * t) * SKV_LDV + cb + g;
#pragma unroll
        for (int n = 0; n < SKV_WN; ++n) {
          uint32_t bh_[2], bl_[2];
          split_b(v0[8 * n], v0[SKV_LDV + 8 * n], bh_, bl_);
          mma_3xtf32(acc[n], ph, pl, bh_, bl_);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = q0 + 16 * mt + g + 8 * h;
        if (row >= sq) continue;
#pragma unroll
        for (int n = 0; n < SKV_WN; ++n)
          *reinterpret_cast<float2*>(o_part + (size_t)row * D + vt * SKV_VC +
                                     cb + 8 * n + 2 * t) =
              make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
      }
    }
    __syncthreads();   // this stage's reads are done before it is refilled
  }
}

// o = sum_i e^(m_i - M) o_i / sum_i e^(m_i - M) l_i over the chunks with
// l_i > 0, M their largest m_i; a row with no such chunk gives 0.  Every
// o_i is written (0 where l_i = 0), so the loads need no branch.  One block
// a row, each thread four of its columns.  Every thread reads the row's m
// and l (one address across the block) in two passes, M first, then each
// chunk's weight beside its columns, so any number of chunks is taken.
__global__ void __launch_bounds__(SKV_D / 4)
flash_merge_kernel(const float* __restrict__ part, float* __restrict__ o,
                   int nbh, int sq, int nchunks) {
  constexpr int D = SKV_D;
  const size_t rows = (size_t)nbh * sq;
  const size_t r = (size_t)blockIdx.y * sq + blockIdx.x;
  const float* m = part + (size_t)nchunks * rows * D;
  const float* l = m + (size_t)nchunks * rows;
  float big = kNegInf;
  for (int c = 0; c < nchunks; ++c)
    if (l[c * rows + r] > 0.f) big = fmaxf(big, m[c * rows + r]);
  float den = 0.f;
  float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int c = 0; c < nchunks; ++c) {
    const float lc = l[c * rows + r];
    const float w = lc > 0.f ? expf(m[c * rows + r] - big) : 0.f;
    den += w * lc;
    const float4 x =
        reinterpret_cast<const float4*>(part + (c * rows + r) * D)[threadIdx.x];
    num.x += w * x.x; num.y += w * x.y; num.z += w * x.z; num.w += w * x.w;
  }
  const float inv = 1.f / (den == 0.f ? 1.f : den);
  reinterpret_cast<float4*>(o + r * D)[threadIdx.x] =
      make_float4(num.x * inv, num.y * inv, num.z * inv, num.w * inv);
}

// ------------------------------------------------------------- launches

// Lift a kernel's dynamic shared-memory limit, once per device (bit d of
// `done` marks device d).
cudaError_t allow_smem(const void* kernel, int bytes, unsigned long long& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (done >> dev) & 1ull) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) done |= 1ull << dev;
  return err;
}

int launch_mma64(const float* q, const float* k, const float* v, float* o,
                 float* lse, int bh, int sq, int sk, float scale, int causal,
                 int has_window, int window, cudaStream_t stream) {
  static unsigned long long done = 0;
  cudaError_t err = allow_smem((const void*)flash_mma64_kernel, M64_SMEM, done);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + M64_BQ - 1) / M64_BQ, bh);
  flash_mma64_kernel<<<grid, M64_NT, M64_SMEM, stream>>>(
      q, k, v, o, lse, sq, sk, scale * kLog2e, causal, has_window, window);
  return (int)cudaGetLastError();
}

// The D = 128 route: the split planes, then the main kernel.
int launch_split128(const float* k, const float* v, float* planes, int bh,
                    int sk, cudaStream_t stream) {
  if (sk <= 0) return 0;   // no key: the main kernel writes zeros
  flash_split128_kernel<<<dim3((sk + W128_BK - 1) / W128_BK, bh), 256, 0,
                          stream>>>(k, v, planes, sk);
  return (int)cudaGetLastError();
}

template <int KS, int VS, int PVN, int PP>
int launch_wgmma128(const float* q, const float* k, const float* v, float* o,
                    float* planes, int bh, int sq, int sk, float scale,
                    int causal, int has_window, int window, cudaStream_t stream) {
  int err = launch_split128(k, v, planes, bh, sk, stream);
  if (err != 0) return err;
  constexpr int smem = w128_smem<KS, VS>();
  auto kernel = flash_wgmma128_kernel<KS, VS, PVN, PP>;
  static unsigned long long done = 0;
  err = (int)allow_smem((const void*)kernel, smem, done);
  if (err != 0) return err;
  dim3 grid((sq + W128_BQ - 1) / W128_BQ, bh);
  kernel<<<grid, W128_NT, smem, stream>>>(q, planes, o, sq, sk,
                                          scale * kLog2e, causal, has_window,
                                          window);
  return (int)cudaGetLastError();
}

int launch_partials(const float* q, const float* k, const float* v,
                    float* scratch, int bh, int sq, int sk, float scale,
                    int causal, int has_window, int window, cudaStream_t stream) {
  static unsigned long long done = 0;
  cudaError_t err = allow_smem((const void*)flash_splitkv_kernel, SKV_SMEM, done);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(skv_chunks(sk), (sq + SKV_BQ - 1) / SKV_BQ, bh);
  flash_splitkv_kernel<<<grid, SKV_NT, SKV_SMEM, stream>>>(
      q, k, v, scratch, bh, sq, sk, scale, causal, has_window, window);
  return (int)cudaGetLastError();
}

int launch_merge(const float* scratch, float* o, int bh, int sq, int sk,
                 cudaStream_t stream) {
  flash_merge_kernel<<<dim3(sq, bh), SKV_D / 4, 0, stream>>>(
      scratch, o, bh, sq, skv_chunks(sk));
  return (int)cudaGetLastError();
}

template <typename T, int D, int BQ, int BK, int NT, int TC>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int bh, int sq, int sk, float scale, int causal, int has_window,
           int window, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * smem_floats<D, BQ, BK>();
  auto kernel = flash_fwd_kernel<T, D, BQ, BK, NT, TC>;
  static unsigned long long done = 0;
  cudaError_t err = allow_smem((const void*)kernel, (int)smem, done);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + BQ - 1) / BQ, bh);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, sq, sk, scale,
      causal, has_window, window);
  return (int)cudaGetLastError();
}

// the CUDA-core template: small heads at any dtype, every head in bf16
template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o,
             float* lse, int bh, int sq, int sk, int d, float scale,
             int causal, int has_window, int window, cudaStream_t st) {
  switch (d) {
    case 8:    return launch<T, 8, 64, 64, 128, 8>(q, k, v, o, lse, bh, sq, sk, scale, causal, has_window, window, st);
    case 16:   return launch<T, 16, 64, 64, 128, 16>(q, k, v, o, lse, bh, sq, sk, scale, causal, has_window, window, st);
    case 32:   return launch<T, 32, 64, 64, 128, 16>(q, k, v, o, lse, bh, sq, sk, scale, causal, has_window, window, st);
    default:   break;
  }
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (d == 64)
      return launch<T, 64, 64, 64, 128, 16>(q, k, v, o, lse, bh, sq, sk, scale, causal, has_window, window, st);
    if (d == 128)
      return launch<T, 128, 64, 64, 128, 16>(q, k, v, o, lse, bh, sq, sk, scale, causal, has_window, window, st);
    if (d == 1024)
      return launch<T, 1024, 16, 16, 256, 16>(q, k, v, o, lse, bh, sq, sk, scale, causal, has_window, window, st);
  }
  return -1;
}

}  // namespace

// Floats of device scratch that flash_attention_fwd needs for these
// arguments: the split planes of the f32 D = 128 route, the partials of
// the split-KV route, 0 for every other route.
extern "C" long long flash_attention_scratch_floats(int bh, int sq, int sk,
                                                    int d, int dtype) {
  if (dtype == 0 && d == 128)
    return (long long)bh * ((sk + W128_BK - 1) / W128_BK) * W128_TILE_FLOATS;
  if (dtype != 0 || d != SKV_D) return 0;
  return (long long)skv_chunks(sk) * bh * sq * (SKV_D + 2);
}

// q, k, v, o: contiguous [bh, sq|sk, d] device arrays of one dtype
// (0 = float32, 1 = bfloat16), 16-byte aligned; scratch: at least
// flash_attention_scratch_floats(...) floats.  lse: null, or (float32
// at D <= 64) a [bh, sq] float32 array that receives each row's
// log-sum-exp of the scaled, masked scores (+inf for a row that sees no
// key), which the backward needs; o's bits do not depend on it.  Launches
// on `stream` and returns the CUDA error of the launches (0 on success), or
// -1 for a head dim or dtype the kernels do not take.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, void* scratch, int bh, int sq,
                                   int sk, int d, int dtype, float scale,
                                   int causal, int has_window, int window,
                                   void* lse, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  if (dtype == 0 && d == 64)
    return launch_mma64(static_cast<const float*>(q), static_cast<const float*>(k),
                        static_cast<const float*>(v), static_cast<float*>(o),
                        lse_f, bh, sq, sk, scale, causal, has_window, window, st);
  if (lse != nullptr && (dtype != 0 || d == 128 || d == SKV_D)) return -1;
  if (dtype == 0 && d == 128)
    return launch_wgmma128<W128_KS, W128_VS, W128_PVN, W128_PP>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o),
        static_cast<float*>(scratch), bh, sq, sk, scale, causal, has_window,
        window, st);
  if (dtype == 0 && d == SKV_D) {
    const int err = launch_partials(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(scratch), bh, sq, sk,
        scale, causal, has_window, window, st);
    if (err != 0) return err;
    return launch_merge(static_cast<const float*>(scratch),
                        static_cast<float*>(o), bh, sq, sk, st);
  }
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, lse_f, bh, sq, sk, d, scale, causal,
                           has_window, window, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, nullptr, bh, sq, sk, d, scale,
                                   causal, has_window, window, st);
  return -1;
}

// The split-KV route's two passes on their own (f32, D = 1024), for holding
// each kernel against its plain version: the partials into scratch, and the
// merge of a scratch laid out as flash_attention_scratch_floats describes
// (o [C][bh][sq][1024], then m and l [C][bh][sq], C = ceil(sk / chunk)).
extern "C" int flash_attention_split_kv_chunk() { return SKV_CK; }

extern "C" int flash_attention_partials(const void* q, const void* k,
                                        const void* v, void* scratch, int bh,
                                        int sq, int sk, float scale, int causal,
                                        int has_window, int window,
                                        void* stream) {
  return launch_partials(static_cast<const float*>(q), static_cast<const float*>(k),
                         static_cast<const float*>(v), static_cast<float*>(scratch),
                         bh, sq, sk, scale, causal, has_window, window,
                         static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attention_merge(const void* scratch, void* o, int bh,
                                     int sq, int sk, void* stream) {
  return launch_merge(static_cast<const float*>(scratch), static_cast<float*>(o),
                      bh, sq, sk, static_cast<cudaStream_t>(stream));
}

// The D = 128 route's split planes on their own (f32 k and v [bh, sk,
// 128]), for holding the pre-pass against its plain version: planes of
// flash_attention_scratch_floats(bh, *, sk, 128, 0) floats, in tiles of
// flash_attention_d128_tile() keys.
extern "C" int flash_attention_d128_tile() { return W128_BK; }

extern "C" int flash_attention_split128(const void* k, const void* v,
                                        void* planes, int bh, int sk,
                                        void* stream) {
  return launch_split128(static_cast<const float*>(k), static_cast<const float*>(v),
                         static_cast<float*>(planes), bh, sk,
                         static_cast<cudaStream_t>(stream));
}
