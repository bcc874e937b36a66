// RG-LRU linear recurrence (RecurrentGemma / Griffin) for Hopper.
//
// Replaces the Pallas TPU kernel `_rglru_kernel` / `rglru_scan` in
// src/repro/kernels/rglru_scan/kernel.py.  Same function: for a, x [B, T, D]
// float32 (a the decay gates in (0, 1)),
//   h_t = a_t * h_{t-1} + sqrt(max(1 - a_t^2, 0)) * x_t,   h_{-1} = 0,
// written for every t, in float32, each operation of a step rounded as
// written (`__fmul_rn` and friends: no contraction into FMAs), which is the
// TPU kernel's literal step.
//
// Bound.  The recurrence does a handful of operations per element and reads
// a and x and writes h once: 12 bytes an element.  At RecurrentGemma-2B width
// (D = 2560) that is 252 MB at B = 1, T = 8192 (the served prefill), 0.075 ms
// at the H100 SXM's 3.35 TB/s, and 503 MB, 0.150 ms, at B = 8, T = 2048, so
// memory bounds it.
//
// Design: a single-pass scan split over time as well as over (b, d).
//   * A tile is 32 consecutive channels of one row b by TILE_T = NW * L =
//     256 consecutive steps.  A block takes one tile: warp w holds steps
//     [w L, (w + 1) L) of the tile, lane c channel c, so each of a thread's
//     L = 16 loads is one coalesced 128-byte row of a warp.  a and x are
//     read once, into registers, and h is written once: 12 bytes an
//     element.  (L and NW were chosen on the H100 against 8-32 steps a
//     thread and 2-16 warps: tools/rglru_scan_bench.py times the variants.)
//   * Reduce, then rescan.  Each thread runs its L steps from h = 0 with the
//     literal step, giving the pair (A, H) = (prod a, h_L).  The block
//     combines the warps' pairs in shared memory under
//     (a1, b1) . (a2, b2) = (a1 a2, b1 a2 + b2), which gives each warp its
//     carry-in within the tile and the tile's own pair.
//   * Carry across tiles along T: a single-pass chained scan with decoupled
//     look-back.  Warp 0 publishes the tile's pair (AGGREGATE), walks back
//     over its predecessors along T until it meets a tile that has published
//     its inclusive h (INCLUSIVE), then folds the pairs in between forward
//     from that h and publishes its own inclusive h = carry . (A, H).  Each
//     inclusive h is thus the same chain of roundings, tile after tile,
//     however far a walk went: the result is the same, bit for bit, from run
//     to run.  Tile ids come from an atomic counter in launch order, with T
//     above the channel groups in the id, so a tile only ever waits on tiles
//     whose blocks are already running or done: no deadlock whatever the
//     grid.  A tile's state and inclusive h share one 64-bit word, written
//     with st.release and read with ld.acquire at gpu scope, so the usual
//     walk (the predecessor is done) is one round trip to L2.
//   * Each thread then re-runs its L steps from registers, starting from its
//     carry-in (the only combined value), and writes h.
//   Why the look-back and not thread-block clusters: a cluster holds at most
//   8 (portable) blocks, so at T = 8192 a chain of 32 tiles would loop over
//   4 super-chunks one after another, each waiting out a full cluster round
//   trip; the look-back lets every tile of a chain load and reduce at once,
//   and its carry's latency hides behind the other resident tiles' loads.
//   At B = 1, D = 2560, T = 8192 the grid is 80 x 32 = 2560 tiles, enough to
//   fill 132 SMs many times over.
//
// Padding: a step past T loads a = 1, x = 0, which the literal step maps to
// (A, H) unchanged, and is not stored; a channel past D is not loaded or
// stored.  No input is padded in memory.
//
// Backward (rglru_scan_bwd_kernel).  Replaces no Pallas kernel: the JAX
// package's hybrid differentiates its associative-scan oracle, and the port's
// hybrid runs this scan's kernel, whose torch.autograd.Function needs a
// backward on the card.  For the upstream gradient dh and the forward's
// output h it computes, with g_t = dh_t + a_{t+1} g_{t+1} (g_T = 0),
//   dx_t = g_t sqrt(max(1 - a_t^2, 0)),
//   da_t = g_t (h_{t-1} - x_t a_t / sqrt(1 - a_t^2)),  h_{-1} = 0,
// the slope term 0 where 1 - a_t^2 <= 0: jax.vjp of the oracle.  g is the
// same linear recurrence run backwards in time with its coefficients
// shifted by one step, so the kernel is the forward's machinery reversed:
// a thread holds L steps (a_t for its L steps and the one after, dh_t),
// reduces them from the last to the first into a pair (A, G), the warps'
// pairs combine latest first, and the tiles chain by the same decoupled
// look-back, with tile ids handed out latest time tile first (T reversed
// in the id), so a tile only waits on tiles already running and the
// result is the same bits every run.  The rescan's epilogue computes dx
// and da as it goes, reading x_t and h_{t-1} (across the warp or tile edge
// where t is its first step).  __launch_bounds__(NT, 2) keeps two blocks
// on an SM (64 registers and a 36-byte spill; unbounded, the kernel took
// 86 registers and one block an SM, and kept fewer loads in flight); the
// bits are the same either way.  Bound: a, x, h, dh read once and da, dx
// written once, 24 bytes an element: 252 MB, 0.075 ms at the H100's
// 3.35 TB/s at the training shape (1, 4096, 2560).
//
// Workspace (the caller's scratch, rglru_scan_workspace() bytes): a tile
// counter and, for every tile and lane, a state word (the state in the low
// half, the inclusive h in the high half) and the tile's (A, H).
// rglru_scan_init_kernel zeroes the counter and the state words before the
// scan; both kernels launch on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int L = 16;             // time steps a thread holds
constexpr int NW = 16;            // warps a block, along T
constexpr int NT = 32 * NW;       // threads a block
constexpr int TILE_T = NW * L;    // time steps a tile
constexpr int TILE_D = 32;        // channels a tile: one warp's lanes
constexpr int EMPTY = 0, AGGREGATE = 1, INCLUSIVE = 2;

struct Plan {
  int n_cg;                 // channel groups of TILE_D
  int n_kt;                 // tiles along T
  long long tiles;          // B * n_kt * n_cg
};

Plan plan(int b, int t, int d) {
  Plan p;
  p.n_cg = (d + TILE_D - 1) / TILE_D;
  p.n_kt = (t + TILE_T - 1) / TILE_T;
  p.tiles = (long long)b * p.n_kt * p.n_cg;
  return p;
}

// byte offsets into the workspace: the counter, then the state words, then
// the pairs, each 8-byte slot array 16-byte aligned
constexpr size_t STATE_OFF = 16;
inline size_t agg_off(long long slots) { return STATE_OFF + 8 * slots; }
inline size_t workspace_bytes(long long slots) { return agg_off(slots) + 8 * slots; }

typedef unsigned long long u64;

__device__ __forceinline__ void store_release(u64* p, u64 v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ u64 load_acquire(const u64* p) {
  u64 v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ u64 state_word(int state, float h) {
  return ((u64)__float_as_uint(h) << 32) | (unsigned)state;
}

// the gated input sqrt(max(1 - a^2, 0)) * x, rounded as written
__device__ __forceinline__ float gated(float a, float x) {
  return __fmul_rn(sqrtf(fmaxf(__fsub_rn(1.0f, __fmul_rn(a, a)), 0.0f)), x);
}

// the literal step with the input already gated
__device__ __forceinline__ float step(float h, float a, float gx) {
  return __fadd_rn(__fmul_rn(a, h), gx);
}

// (a1, h1) <- (a1, h1) . (a2, h2)
__device__ __forceinline__ void combine(float& a1, float& h1, float a2, float h2) {
  h1 = __fmaf_rn(h1, a2, h2);
  a1 = __fmul_rn(a1, a2);
}

__global__ void rglru_scan_init_kernel(unsigned int* counter, u64* state,
                                       long long slots) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i == 0) *counter = 0u;
  for (; i < slots; i += stride) state[i] = EMPTY;
}

__global__ void __launch_bounds__(NT)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ x,
                  float* __restrict__ out, unsigned int* counter, u64* state,
                  float2* agg, int t_len, int d_len, int n_cg, int n_kt) {
  __shared__ unsigned int s_tile;
  __shared__ float s_a[NW][TILE_D], s_h[NW][TILE_D];
  __shared__ float s_carry[TILE_D];
  const int lane = threadIdx.x % TILE_D, w = threadIdx.x / TILE_D;
  if (threadIdx.x == 0) s_tile = atomicAdd(counter, 1u);
  __syncthreads();
  // tile id = (b * n_kt + k) * n_cg + cg: a tile's predecessor along T is
  // n_cg ids earlier, so it was handed out earlier
  const unsigned int tile = s_tile;
  const int cg = (int)(tile % (unsigned)n_cg);
  const unsigned int row = tile / (unsigned)n_cg;
  const int k = (int)(row % (unsigned)n_kt);
  const int b = (int)(row / (unsigned)n_kt);
  const int d = cg * TILE_D + lane;
  const int t0 = k * TILE_T + w * L;
  const bool d_ok = d < d_len;
  const size_t base = ((size_t)b * t_len + t0) * d_len + d;

  float av[L], gx[L];
#pragma unroll
  for (int u = 0; u < L; ++u) {
    const bool ok = d_ok && t0 + u < t_len;
    const size_t i = base + (size_t)u * d_len;
    av[u] = ok ? __ldcs(a + i) : 1.0f;
    gx[u] = ok ? __ldcs(x + i) : 0.0f;
  }
  float h = 0.0f, prod = 1.0f;
#pragma unroll
  for (int u = 0; u < L; ++u) {
    gx[u] = gated(av[u], gx[u]);
    h = step(h, av[u], gx[u]);
    prod = __fmul_rn(prod, av[u]);
  }
  s_a[w][lane] = prod;
  s_h[w][lane] = h;
  __syncthreads();

  // this warp's carry-in within the tile: the warps before it, combined
  float ea = 1.0f, eh = 0.0f;
  for (int v = 0; v < w; ++v) combine(ea, eh, s_a[v][lane], s_h[v][lane]);

  if (w == 0) {
    float ta = 1.0f, th = 0.0f;               // the tile's own pair
#pragma unroll
    for (int v = 0; v < NW; ++v) combine(ta, th, s_a[v][lane], s_h[v][lane]);
    const long long slot = (long long)tile * TILE_D + lane;
    const long long back = (long long)TILE_D * n_cg;  // one tile earlier in T
    float carry = 0.0f;                       // h just before the tile
    if (k > 0) {
      agg[slot] = make_float2(ta, th);
      store_release(state + slot, AGGREGATE);
      long long j = slot;
      u64 s;
      do {                                    // back to the nearest INCLUSIVE
        j -= back;
        while (((s = load_acquire(state + j)) & 3) == EMPTY) __nanosleep(32);
      } while ((s & 3) != INCLUSIVE);
      carry = __uint_as_float((unsigned)(s >> 32));
      for (j += back; j < slot; j += back) {  // then forward over the pairs
        const float2 p = __ldcg(agg + j);
        carry = __fmaf_rn(carry, p.x, p.y);
      }
    }
    store_release(state + slot, state_word(INCLUSIVE, __fmaf_rn(carry, ta, th)));
    s_carry[lane] = carry;
  }
  __syncthreads();

  h = __fmaf_rn(s_carry[lane], ea, eh);
#pragma unroll
  for (int u = 0; u < L; ++u) {
    h = step(h, av[u], gx[u]);
    if (d_ok && t0 + u < t_len) __stcs(out + base + (size_t)u * d_len, h);
  }
}

__global__ void __launch_bounds__(NT, 2)
rglru_scan_bwd_kernel(const float* __restrict__ a, const float* __restrict__ x,
                      const float* __restrict__ h,
                      const float* __restrict__ dh, float* __restrict__ da,
                      float* __restrict__ dx, unsigned int* counter,
                      u64* state, float2* agg, int t_len, int d_len, int n_cg,
                      int n_kt) {
  __shared__ unsigned int s_tile;
  __shared__ float s_a[NW][TILE_D], s_h[NW][TILE_D];
  __shared__ float s_carry[TILE_D];
  const int lane = threadIdx.x % TILE_D, w = threadIdx.x / TILE_D;
  if (threadIdx.x == 0) s_tile = atomicAdd(counter, 1u);
  __syncthreads();
  // tile id = (b * n_kt + kr) * n_cg + cg, kr counting time tiles from the
  // last: a tile's predecessor in the reverse chain (the next tile in time)
  // is n_cg ids earlier, so it was handed out earlier
  const unsigned int tile = s_tile;
  const int cg = (int)(tile % (unsigned)n_cg);
  const unsigned int row = tile / (unsigned)n_cg;
  const int kr = (int)(row % (unsigned)n_kt);
  const int b = (int)(row / (unsigned)n_kt);
  const int d = cg * TILE_D + lane;
  const int t0 = (n_kt - 1 - kr) * TILE_T + w * L;
  const bool d_ok = d < d_len;
  const size_t base = ((size_t)b * t_len + t0) * d_len + d;

  // av[u] = a_{t0+u} for u <= L (av[u + 1] is step u's coefficient), gv[u]
  // = dh_{t0+u}; both 0 past T, where g is 0
  float av[L + 1], gv[L];
#pragma unroll
  for (int u = 0; u <= L; ++u)
    av[u] = d_ok && t0 + u < t_len ? __ldg(a + base + (size_t)u * d_len) : 0.0f;
#pragma unroll
  for (int u = 0; u < L; ++u)
    gv[u] = d_ok && t0 + u < t_len ? __ldcs(dh + base + (size_t)u * d_len) : 0.0f;
  float g = 0.0f, prod = 1.0f;
#pragma unroll
  for (int u = L - 1; u >= 0; --u) {
    g = step(g, av[u + 1], gv[u]);
    prod = __fmul_rn(prod, av[u + 1]);
  }
  s_a[w][lane] = prod;
  s_h[w][lane] = g;
  __syncthreads();

  // this warp's carry-in within the tile: the warps after it, latest first
  float ea = 1.0f, eh = 0.0f;
  for (int v = NW - 1; v > w; --v) combine(ea, eh, s_a[v][lane], s_h[v][lane]);

  if (w == 0) {
    float ta = 1.0f, th = 0.0f;               // the tile's own pair
#pragma unroll
    for (int v = NW - 1; v >= 0; --v) combine(ta, th, s_a[v][lane], s_h[v][lane]);
    const long long slot = (long long)tile * TILE_D + lane;
    const long long back = (long long)TILE_D * n_cg;  // one tile later in T
    float carry = 0.0f;                       // g just after the tile
    if (kr > 0) {
      agg[slot] = make_float2(ta, th);
      store_release(state + slot, AGGREGATE);
      long long j = slot;
      u64 s;
      do {                                    // back to the nearest INCLUSIVE
        j -= back;
        while (((s = load_acquire(state + j)) & 3) == EMPTY) __nanosleep(32);
      } while ((s & 3) != INCLUSIVE);
      carry = __uint_as_float((unsigned)(s >> 32));
      for (j += back; j < slot; j += back) {  // then forward over the pairs
        const float2 p = __ldcg(agg + j);
        carry = __fmaf_rn(carry, p.x, p.y);
      }
    }
    store_release(state + slot, state_word(INCLUSIVE, __fmaf_rn(carry, ta, th)));
    s_carry[lane] = carry;
  }
  __syncthreads();

  g = __fmaf_rn(s_carry[lane], ea, eh);
#pragma unroll
  for (int u = L - 1; u >= 0; --u) {
    g = step(g, av[u + 1], gv[u]);
    if (d_ok && t0 + u < t_len) {
      const size_t i = base + (size_t)u * d_len;
      const float at = av[u];
      const float y = __fsub_rn(1.0f, __fmul_rn(at, at));
      const float root = sqrtf(fmaxf(y, 0.0f));
      const float slope = y > 0.0f ? -at / root : 0.0f;
      const float hp = t0 + u > 0 ? __ldg(h + i - d_len) : 0.0f;  // h_{t-1}
      __stcs(dx + i, __fmul_rn(g, root));
      __stcs(da + i, __fmul_rn(g, __fmaf_rn(__ldcs(x + i), slope, hp)));
    }
  }
}

}  // namespace

// Bytes of scratch rglru_scan_fwd (and rglru_scan_bwd) needs for [b, t, d]
// inputs.
extern "C" long long rglru_scan_workspace(int b, int t, int d) {
  if (b <= 0 || t <= 0 || d <= 0) return -1;
  return (long long)workspace_bytes(plan(b, t, d).tiles * TILE_D);
}

// out[b, t, d] = h_t for a, x, out [b, t, d] float32, contiguous on CUDA
// device `device`; `workspace` holds rglru_scan_workspace(b, t, d) bytes,
// 16-byte aligned, on the same device.  Launches rglru_scan_init_kernel, then
// rglru_scan_kernel, on `stream` (a stream of that device; the calling
// thread's current device is restored) and returns the CUDA error of the
// launches (0 on success).
extern "C" int rglru_scan_fwd(const void* a, const void* x, void* out,
                              void* workspace, int b, int t, int d, int device,
                              void* stream) {
  if (b <= 0 || t <= 0 || d <= 0 || b > 65535) return -1;
  const Plan p = plan(b, t, d);
  if (p.tiles > 0x7fffffffLL) return -1;
  int prev = device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long slots = p.tiles * TILE_D;
  char* ws = static_cast<char*>(workspace);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long init_blocks = (slots + 255) / 256;
  rglru_scan_init_kernel<<<(unsigned)(init_blocks < 1024 ? init_blocks : 1024),
                           256, 0, s>>>(
      reinterpret_cast<unsigned int*>(ws),
      reinterpret_cast<u64*>(ws + STATE_OFF), slots);
  err = cudaGetLastError();
  if (err == cudaSuccess) {
    rglru_scan_kernel<<<(unsigned)p.tiles, NT, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(x),
        static_cast<float*>(out), reinterpret_cast<unsigned int*>(ws),
        reinterpret_cast<u64*>(ws + STATE_OFF),
        reinterpret_cast<float2*>(ws + agg_off(slots)), t, d, p.n_cg, p.n_kt);
    err = cudaGetLastError();
  }
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}

// da, dx [b, t, d] of the scan at (a, x), given its output h and the
// upstream gradient dh: all float32, contiguous, on CUDA device `device`;
// `workspace` as for rglru_scan_fwd.  Launches rglru_scan_init_kernel, then
// rglru_scan_bwd_kernel, on `stream` and returns the CUDA error of the
// launches (0 on success).
extern "C" int rglru_scan_bwd(const void* a, const void* x, const void* h,
                              const void* dh, void* da, void* dx,
                              void* workspace, int b, int t, int d, int device,
                              void* stream) {
  if (b <= 0 || t <= 0 || d <= 0 || b > 65535) return -1;
  const Plan p = plan(b, t, d);
  if (p.tiles > 0x7fffffffLL) return -1;
  int prev = device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long slots = p.tiles * TILE_D;
  char* ws = static_cast<char*>(workspace);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long init_blocks = (slots + 255) / 256;
  rglru_scan_init_kernel<<<(unsigned)(init_blocks < 1024 ? init_blocks : 1024),
                           256, 0, s>>>(
      reinterpret_cast<unsigned int*>(ws),
      reinterpret_cast<u64*>(ws + STATE_OFF), slots);
  err = cudaGetLastError();
  if (err == cudaSuccess) {
    rglru_scan_bwd_kernel<<<(unsigned)p.tiles, NT, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(x),
        static_cast<const float*>(h), static_cast<const float*>(dh),
        static_cast<float*>(da), static_cast<float*>(dx),
        reinterpret_cast<unsigned int*>(ws),
        reinterpret_cast<u64*>(ws + STATE_OFF),
        reinterpret_cast<float2*>(ws + agg_off(slots)), t, d, p.n_cg, p.n_kt);
    err = cudaGetLastError();
  }
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}
