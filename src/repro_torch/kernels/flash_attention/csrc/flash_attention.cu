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
// (mma.sync.m16n8k8 TF32, f32 accumulators), for q k^T and for P v alike.
// The tensor cores truncate as they accumulate, so no chain of mma sums runs
// longer than 8 k steps: each K/V tile (and each 64-wide slice of D = 1024)
// sums into fresh registers that join the running sums with rounded f32
// adds.  Without that the D = 1024 error crossed the gate (2.6e-5 at BH 8).
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
// * f32, D = 128 (Flux's heads): flash_mma128_kernel, the D = 64 design with
//   three changes.  (1) Registers: q's split fragments for the whole sweep
//   would take 128 registers and the output accumulator 64, so q sits in
//   shared memory (pre-scaled, 136-float rows) and is split on each read;
//   P v walks the output one 8-wide n-tile at a time over P split once, so
//   it holds 4 fresh accumulators, not 64.  (2) Chains: q k^T sums each
//   64-wide half of D as a chain of 8 mma k steps into fresh registers and
//   joins the halves with a rounded f32 add; P v over a 64-key tile is 8 k
//   steps.  (3) Tiles, by measurement at (24, 4608, 128) on an H100
//   (tools/flash_fwd128_bench.py): 8 warps (128 query rows) a block over
//   64-key tiles, 207 KB of shared memory (q 70 KB, a 2-stage K/V ring 137
//   KB) and 253 registers, one block an SM, took 4.48 ms; 4 warps over
//   64-key tiles (255 registers, one block) 6.36 ms; 4 warps over 32-key
//   tiles (168 registers, two blocks) 6.35 ms; 8 warps over 32-key tiles
//   5.60 ms.  Eight warps share each K/V tile, which halves the tile loads
//   a query row costs.  No variant spills.
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

// ------------------------------------------ f32, D = 128: mma.sync tiles

// BK keys a K/V tile and NW warps (16 query rows each) a block: chosen by
// measurement, see the header note.  q lives in shared memory (pre-scaled,
// split on each read): its split fragments would take 128 registers.
constexpr int M128_BK = 64, M128_NW = 8;
constexpr int M128_STAGES = 2;
constexpr int M128_LDQ = 128 + 8;   // float2 loads at (row g, dim 2t): 8g + 2t
constexpr int M128_LDK = 128 + 8;   // float2 loads at (key g, dim 2t): 8g + 2t
constexpr int M128_LDV = 128 + 4;   // loads at (key 2t, dim g): 8t + g

template <int BK, int NW>
constexpr int m128_smem() {
  return (16 * NW * M128_LDQ + M128_STAGES * BK * (M128_LDK + M128_LDV)) *
         (int)sizeof(float);
}

template <int BK, int NW>
__global__ void __launch_bounds__(32 * NW)
flash_mma128_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o,
                    int sq, int sk, float scale_log2, int causal,
                    int has_window, int window) {
  constexpr int D = 128, BQ = 16 * NW, NT = 32 * NW, NJ = BK / 8;
  constexpr int STAGES = M128_STAGES, LDQ = M128_LDQ, LDK = M128_LDK;
  constexpr int LDV = M128_LDV;
  static_assert(BK % 8 == 0 && NJ <= 8, "P v sums at most 8 k steps a chain");
  static_assert((BK * D / 4) % NT == 0 && (BQ * D / 4) % NT == 0, "loads");
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);   // [BQ][LDQ], pre-scaled
  float* sK = sQ + BQ * LDQ;                     // [STAGES][BK][LDK]
  float* sV = sK + STAGES * BK * LDK;            // [STAGES][BK][LDV]

  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const float* kb = k + (size_t)bh * sk * D;
  const float* vb = v + (size_t)bh * sk * D;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;   // this lane's two rows

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

  // q, pre-scaled by scale*log2(e), into shared memory while K/V load; the
  // first tile's barrier makes it visible
  {
    const float* qb = q + (size_t)bh * sq * D;
#pragma unroll
    for (int i = 0; i < BQ * D / 4 / NT; ++i) {
      const int c = tid + i * NT, row = c / (D / 4), col = (c % (D / 4)) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q0 + row < sq)
        x = *reinterpret_cast<const float4*>(qb + (size_t)(q0 + row) * D + col);
      x.x *= scale_log2; x.y *= scale_log2; x.z *= scale_log2; x.w *= scale_log2;
      *reinterpret_cast<float4*>(sQ + row * LDQ + col) = x;
    }
  }
  const float* qw = sQ + warp * 16 * LDQ;   // this warp's 16 rows

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

    // s = q k^T: n-tile j covers keys kt+8j..kt+8j+7.  D's two 64-wide
    // halves are each a chain of 8 mma k steps into fresh registers, joined
    // with a rounded f32 add (the tensor cores truncate as they accumulate).
    // Step kk of half h covers dims 64h+8kk..: k = t <-> dim 64h+8kk+2t,
    // k = t+4 <-> dim 64h+8kk+2t+1, for q and K alike.
    float s[NJ][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float st[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const int d0 = 64 * h + 8 * kk + 2 * t;
        uint32_t ah[4], al[4];
        split_a(*reinterpret_cast<const float2*>(qw + g * LDQ + d0),
                *reinterpret_cast<const float2*>(qw + (g + 8) * LDQ + d0), ah, al);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float2 kv =
              *reinterpret_cast<const float2*>(cK + (8 * j + g) * LDK + d0);
          uint32_t bh_[2], bl_[2];
          split_b(kv.x, kv.y, bh_, bl_);
          mma_3xtf32(st[j], ah, al, bh_, bl_);
        }
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (h == 0) s[j][e] = st[j][e];
          else s[j][e] += st[j][e];
        }
    }

    // online softmax, as in flash_mma64_kernel
    float alpha[2];
    if (kt + BK <= sk && !causal && !has_window)
      tile_softmax<false>(s, m_run, l_run, alpha, kt, t, r0, r1, sk, causal,
                          has_window, window);
    else
      tile_softmax<true>(s, m_run, l_run, alpha, kt, t, r0, r1, sk, causal,
                         has_window, window);

    // pv = P v over this tile, one output n-tile at a time: P is split once
    // (its A fragments are s[j] itself), each n-tile sums its NJ k steps
    // into fresh registers and joins the running output with a rounded
    // f32 FMA.  That order holds 4 accumulators instead of D / 2.
    uint32_t ph[NJ][4], pl[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      split_a(make_float2(s[j][0], s[j][1]), make_float2(s[j][2], s[j][3]),
              ph[j], pl[j]);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      float pv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float* v0 = cV + (8 * j + 2 * t) * LDV + 8 * n + g;
        uint32_t bh_[2], bl_[2];
        split_b(v0[0], v0[LDV], bh_, bl_);
        mma_3xtf32(pv, ph[j], pl[j], bh_, bl_);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = fmaf(acc[n][e], alpha[e >> 1], pv[e]);
    }
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

template <int BK, int NW>
int launch_mma128(const float* q, const float* k, const float* v, float* o,
                  int bh, int sq, int sk, float scale, int causal,
                  int has_window, int window, cudaStream_t stream) {
  constexpr int smem = m128_smem<BK, NW>();
  auto kernel = flash_mma128_kernel<BK, NW>;
  static unsigned long long done = 0;
  cudaError_t err = allow_smem((const void*)kernel, smem, done);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + 16 * NW - 1) / (16 * NW), bh);
  kernel<<<grid, 32 * NW, smem, stream>>>(
      q, k, v, o, sq, sk, scale * kLog2e, causal, has_window, window);
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
// arguments: 0 for every route but the split-KV one.
extern "C" long long flash_attention_scratch_floats(int bh, int sq, int sk,
                                                    int d, int dtype) {
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
    return launch_mma128<M128_BK, M128_NW>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), bh, sq, sk,
        scale, causal, has_window, window, st);
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
