// Cross-channel local response normalization, forward and backward, float32
// and bfloat16, for Hopper.
//
// Forward (dl4j_lrn_fwd) replaces the TPU kernel
// deeplearning4j_tpu/ops/pallas_kernels.py:_lrn_kernel (driven by lrn ->
// _lrn_pallas -> _run_lrn_call). It computes, for each pixel row of an NHWC
// tensor viewed as [rows, C],
//
//     y[r, c] = x[r, c] / d[r, c]^beta,
//     d[r, c] = k + alpha * sum_{j=c-up}^{c+down} x[r, j]^2
//
// with up = n / 2, down = n - 1 - up and channels outside [0, C) counted as 0
// (the window of lrn_reference, asymmetric for even n).
//
// Backward (dl4j_lrn_bwd) replaces pallas_kernels.py:_lrn_bwd_kernel (driven
// by the custom VJP _lrn_bwd -> _lrn_bwd_pallas -> _run_lrn_call). Given x and
// the cotangent g it computes, with d recomputed from x as the TPU kernel does,
//
//     dx[r, i] = g_i d_i^-beta - 2 alpha beta x_i sum_{c=i-down}^{i+up} t_c,
//     t_c      = g_c x_c d_c^(-beta-1)
//
// where the sum runs over the TRANSPOSED window (c is in it iff i is in c's
// window, so up and down swap).
//
// Types: float32 and bfloat16 (the JAX kernels keep the input's type). Both
// compute in float32 registers; a bfloat16 result is rounded once, on its
// store (__float2bfloat16_rn), where the JAX kernel computes in bfloat16.
//
// Bound: memory, for both. The forward reads x and writes y, 2 elements'
// bytes per element (8 in float32, 4 in bfloat16); the backward reads x and g
// and writes dx, 3 (12 and 6). The arithmetic is a few dozen float operations
// per element (the windows, a power), far under the H100's ~20 float
// operations per byte of device-memory bandwidth. At AlexNet's shapes (batch
// 128: 24.8 M elements at C = 64, 4.8 M at C = 192) the float32 forward's
// least time is 0.0592 + 0.0115 ms at 3.35 TB/s, the backward's 0.0888 +
// 0.0173 ms.
//
// Both kernels take the same two paths. On the vector path, where a row is
// a whole number of 16-byte chunks (C a multiple of 4 in float32, of 8 in
// bfloat16), the tensors are 16-byte aligned and the window reaches at most
// 4 channels to a side (n <= 9, AlexNet's 5), a thread takes consecutive
// channels whose
// windows come from registers, and its results leave as one store,
// consecutive threads on consecutive addresses. Otherwise (C = 3, 67, an
// unaligned view, a wider window) a thread takes one channel and loops over
// its window. Unlike the TPU kernels there is no 128-lane channel padding and no
// 256-row block padding.
//
// K1 (lrn_fwd_kernel) needs no shared memory. A thread loads 16 bytes of
// channels straight from device memory (4 float32 or 8 bfloat16, so a
// bfloat16 thread moves as many bytes as a float32 one), consecutive lanes
// on consecutive 16-byte groups, and takes the 4 channels on either side
// that its windows reach from the lanes beside it by warp shuffles; only a
// warp's first and last lane load them again (from the cache) where the
// row runs on past the warp. Each element is read once and written once,
// and a grid of 256-thread blocks (up to 4 waves of what fits on the SMs,
// each thread striding over the rest) keeps enough loads in flight: at
// AlexNet's shapes it takes about as long as a device copy of the same
// bytes. It takes d^-beta as K2 does, exp2(-beta log2 d) on the
// special-function unit (lrn_y), where the plain version divides by a full
// pow, so the two round apart by a few float32 ulps (held to rtol 1e-5).
// Built first on K2's ring below, K1 took 1.5x as long on the
// H100: a barrier a tile and the trip through shared memory cost more than
// the ring hides when each element's window is read once.
//
// K2 (lrn_bwd_kernel): a persistent grid, as many 512-thread blocks as fit
// on the SMs at once, takes tiles of R = T / C rows, T = 8 KiB of x (2048
// float32 elements, 4096 bfloat16). Because [rows, C] is contiguous, a tile
// of x or g is one span of R C elements: it moves into a ring of 3
// shared-memory stages as cp.async copies (16-byte copies on the vector path;
// 4-byte ones in float32 and plain 2-byte loads in bfloat16 otherwise, since
// cp.async copies no fewer than 4 bytes), with the block's next two tiles in
// flight while it computes one. On the vector path a thread takes 4 channels
// ("a quad") in both types: three 4-value shared loads (16 bytes in float32,
// 8 in bfloat16) give it channels c - 4 .. c + 7. Each term is computed
// once: pass 1 takes d and p = d^-beta (exp2(-beta log2 d) on the
// special-function unit) and writes t = g x p / d to a shared row and g p
// beside it (over g in float32; in a float32 row of its own in bfloat16, so
// that it is not rounded); pass 2 sums t over the transposed window and
// writes dx = g p - 2 alpha beta x u straight to device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kFwdThreads = 256;
constexpr int kFwdWaves = 4;      // K1's grid: at most this many waves of blocks
constexpr int kThreads = 512;     // K2
constexpr int kTileBytes = 8192;  // of x (and of g) a K2 tile
constexpr int kStages = 3;

template <typename T>
__host__ __device__ constexpr int tile_elems() { return kTileBytes / (int)sizeof(T); }

// K2's shared memory: the ring's stages of x and g, then t and, in
// bfloat16, g p, both float32 (57,344 bytes in float32, 81,920 in bfloat16).
template <typename T>
constexpr size_t bwd_smem() {
  return 2 * (size_t)kStages * kTileBytes +
         (sizeof(T) == 4 ? 1 : 2) * (size_t)tile_elems<T>() * sizeof(float);
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// Four consecutive values as floats, and back: 16-byte accesses in float32,
// 8-byte ones in bfloat16.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load4(const bf16* p, float (&v)[4]) {
  const uint2 a = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a.y));
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(bf16* p, const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 a;
  a.x = *reinterpret_cast<const uint32_t*>(&lo);
  a.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = a;
}

// 16 bytes of values as floats, and back: 4 float32 or 8 bfloat16.
template <typename T>
constexpr int kVec16 = 16 / (int)sizeof(T);
__device__ __forceinline__ void load16(const float* p, float (&v)[4]) { load4(p, v); }
__device__ __forceinline__ void load16(const bf16* p, float (&v)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store16(float* p, const float (&v)[4]) { store4(p, v); }
__device__ __forceinline__ void store16(bf16* p, const float (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One tile of `src` (the span of `span` elements from `base`) into `dst`:
// 16-byte cp.async copies on the vector path, 4-byte ones otherwise in
// float32, plain loads in bfloat16 (which the ring's barrier orders as it
// does the copies).
template <typename T, bool kVec>
__device__ __forceinline__ void load_tile(const T* __restrict__ src,
                                          long long base, int span, T* dst) {
  if constexpr (kVec) {
    constexpr int kPer = 16 / (int)sizeof(T);
    for (int q = threadIdx.x; q < span / kPer; q += kThreads)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                   :: "r"(smem_addr(dst + kPer * q)), "l"(src + base + kPer * q));
  } else if constexpr (sizeof(T) == 4) {
    for (int e = threadIdx.x; e < span; e += kThreads)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                   :: "r"(smem_addr(dst + e)), "l"(src + base + e));
  } else {
    for (int e = threadIdx.x; e < span; e += kThreads) dst[e] = src[base + e];
  }
}

// Channels c - 4 .. c + 7 of a staged row (c a multiple of 4, C of 4) as
// floats: zero outside [0, C).
template <typename T>
__device__ __forceinline__ void quad_span(const T* row, int c, int C,
                                          float (&v)[12]) {
  float a[4] = {0.f, 0.f, 0.f, 0.f}, b[4], d[4] = {0.f, 0.f, 0.f, 0.f};
  if (c >= 4) load4(row + c - 4, a);
  load4(row + c, b);
  if (c + 4 < C) load4(row + c + 4, d);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[i] = a[i];
    v[4 + i] = b[i];
    v[8 + i] = d[i];
  }
}

template <typename T>
__device__ __forceinline__ float window_sq_sum(const T* row, int c, int C,
                                               int up, int down) {
  const int lo = c - up < 0 ? 0 : c - up;
  const int hi = c + down > C - 1 ? C - 1 : c + down;
  float acc = 0.f;
  for (int j = lo; j <= hi; ++j) {
    const float v = to_float(row[j]);
    acc += v * v;
  }
  return acc;
}

// The window's sum of squares for channel c + i of a span of channels
// c - 4 .. c + N - 5 held in registers.
template <int N>
__device__ __forceinline__ float span_sq_sum(const float (&v)[N], int i,
                                             int up, int down) {
  float sq = 0.f;
#pragma unroll
  for (int o = -4; o <= 4; ++o)
    if (o >= -up && o <= down) sq += v[4 + i + o] * v[4 + i + o];
  return sq;
}

// d^-beta on the special-function unit: exp2(-beta log2 d) (K2).
__device__ __forceinline__ float pow_neg(float d, float beta) {
  return exp2f(-beta * __log2f(d));
}

// K1's y = x d^-beta, with K2's power.
__device__ __forceinline__ float lrn_y(float x, float sq, float k, float alpha,
                                       float beta) {
  return x * pow_neg(k + alpha * sq, beta);
}

// ---------------------------------------------------------------- K1

template <typename T, bool kVec>
__global__ void __launch_bounds__(kFwdThreads)
lrn_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, long long rows,
               int C, float k, float alpha, float beta, int up, int down) {
  const long long total = rows * C;
  const long long stride = (long long)gridDim.x * kFwdThreads;
  const long long first = (long long)blockIdx.x * kFwdThreads + threadIdx.x;
  if constexpr (kVec) {
    constexpr int V = kVec16<T>;  // channels a thread: 16 bytes of them
    const int lane = threadIdx.x & 31;
    const long long groups = total / V;
    const int per_row = C / V;
    // the loop runs whole warps, so that every lane takes part in the shuffles
    for (long long q = first; q - lane < groups; q += stride) {
      const bool in = q < groups;
      float mid[V] = {};
      if (in) load16(x + V * q, mid);
      // channels c - 4 .. c + V + 3: the last 4 of the lane below, this
      // lane's V, the first 4 of the lane above
      float v[V + 8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[i] = __shfl_up_sync(0xffffffffu, mid[V - 4 + i], 1);
        v[V + 4 + i] = __shfl_down_sync(0xffffffffu, mid[i], 1);
      }
#pragma unroll
      for (int i = 0; i < V; ++i) v[4 + i] = mid[i];
      if (!in) continue;
      const int c = (int)(q % per_row) * V;
      float edge[4] = {0.f, 0.f, 0.f, 0.f};
      // the row starts here, or the lane below belongs to another warp
      if (c == 0 || lane == 0) {
        if (c > 0) load4(x + V * q - 4, edge);
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = edge[i];
      }
      if (c + V == C || lane == 31) {
        float next[4] = {0.f, 0.f, 0.f, 0.f};
        if (c + V < C) load4(x + V * q + V, next);
#pragma unroll
        for (int i = 0; i < 4; ++i) v[V + 4 + i] = next[i];
      }
      float out[V];
#pragma unroll
      for (int i = 0; i < V; ++i)
        out[i] = lrn_y(v[4 + i], span_sq_sum(v, i, up, down), k, alpha, beta);
      store16(y + V * q, out);
    }
  } else {
    for (long long e = first; e < total; e += stride) {
      const int c = (int)(e % C);
      const T* row = x + (e - c);
      y[e] = from_float<T>(
          lrn_y(to_float(row[c]), window_sq_sum(row, c, C, up, down), k, alpha, beta));
    }
  }
}

// ---------------------------------------------------------------- K2

// Pass 1 over a staged tile: for each element, d = k + alpha window(x^2),
// p = d^-beta, t = g x p / d into ts and g p into gps. Pass 2: dx = g p -
// 2 alpha beta x sum_{transposed window} t, written to device memory.
template <typename T, bool kVec>
__device__ __forceinline__ void bwd_pass1(const T* xs, const T* gs, float* ts,
                                          float* gps, int span, int C, float k,
                                          float alpha, float beta, int up,
                                          int down) {
  if (kVec) {
    for (int e = 4 * threadIdx.x; e < span; e += 4 * kThreads) {
      const int r = e / C, c = e - r * C;
      float v[12], gv[4], t[4], gp[4];
      quad_span(xs + r * C, c, C, v);
      load4(gs + e, gv);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float d = k + alpha * span_sq_sum(v, i, up, down);
        const float p = pow_neg(d, beta);
        t[i] = gv[i] * v[4 + i] * p * __frcp_rn(d);
        gp[i] = gv[i] * p;
      }
      store4(ts + e, t);
      store4(gps + e, gp);
    }
  } else {
    for (int e = threadIdx.x; e < span; e += kThreads) {
      const int r = e / C, c = e - r * C;
      const T* row = xs + r * C;
      const float d = k + alpha * window_sq_sum(row, c, C, up, down);
      const float p = pow_neg(d, beta);
      const float gv = to_float(gs[e]);
      ts[e] = gv * to_float(row[c]) * p * __frcp_rn(d);
      gps[e] = gv * p;
    }
  }
}

template <typename T, bool kVec>
__device__ __forceinline__ void bwd_pass2(const T* xs, const float* gps,
                                          const float* ts, T* __restrict__ dx,
                                          int span, int C, float coef, int up,
                                          int down) {
  if (kVec) {
    for (int e = 4 * threadIdx.x; e < span; e += 4 * kThreads) {
      const int r = e / C, c = e - r * C;
      float v[12], xv[4], gp[4], out[4];
      quad_span(ts + r * C, c, C, v);
      load4(xs + e, xv);
      load4(gps + e, gp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float u = 0.f;
#pragma unroll
        for (int o = -4; o <= 4; ++o)  // the transposed window: up and down swap
          if (o >= -down && o <= up) u += v[4 + i + o];
        out[i] = gp[i] - coef * xv[i] * u;
      }
      store4(dx + e, out);
    }
  } else {
    for (int e = threadIdx.x; e < span; e += kThreads) {
      const int r = e / C, i = e - r * C;
      const float* trow = ts + r * C;
      const int lo = i - down < 0 ? 0 : i - down;
      const int hi = i + up > C - 1 ? C - 1 : i + up;
      float u = 0.f;
      for (int c = lo; c <= hi; ++c) u += trow[c];
      dx[e] = from_float<T>(gps[e] - coef * to_float(xs[e]) * u);
    }
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
lrn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
               T* __restrict__ dx, long long rows, int C, float k,
               float alpha, float beta, int up, int down) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  constexpr int kTile = tile_elems<T>();
  float* ts = reinterpret_cast<float*>(ring + 2 * kStages * kTile);
  const float coef = 2.f * alpha * beta;
  const long long R = kTile / C;
  auto span_of = [&](long long tile) {
    const long long left = rows - tile * R;
    return (int)((left < R ? left : R) * C);
  };
  auto load = [&](long long tile, int s) {
    const long long base = tile * R * C;
    const int span = span_of(tile);
    load_tile<T, kVec>(x, base, span, ring + 2 * s * kTile);
    load_tile<T, kVec>(g, base, span, ring + (2 * s + 1) * kTile);
  };
  // block b takes tiles b, b + grid, ..., the next kStages - 1 in flight
  const long long tiles = (rows + R - 1) / R;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    const long long tile = blockIdx.x + (long long)s * gridDim.x;
    if (tile < tiles) load(tile, s);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (long long j = 0;; ++j) {
    const long long tile = blockIdx.x + j * gridDim.x;
    if (tile >= tiles) break;
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kStages - 2));
    __syncthreads();  // tile j has landed; tile j - 1's readers are done
    const long long next = tile + (long long)(kStages - 1) * gridDim.x;
    if (next < tiles) load(next, (int)((j + kStages - 1) % kStages));
    asm volatile("cp.async.commit_group;\n" ::);
    const int cs = (int)(j % kStages);
    const T* xs = ring + 2 * cs * kTile;
    T* gs = ring + (2 * cs + 1) * kTile;
    // float32 writes g p over g; bfloat16 keeps it in a float32 row of its own
    float* gps = sizeof(T) == 4 ? reinterpret_cast<float*>(gs) : ts + kTile;
    const int span = span_of(tile);
    bwd_pass1<T, kVec>(xs, gs, ts, gps, span, C, k, alpha, beta, up, down);
    __syncthreads();  // every t of the tile is in ts
    bwd_pass2<T, kVec>(xs, gps, ts, dx + tile * R * C, span, C, coef, up, down);
  }
  asm volatile("cp.async.wait_all;\n" ::);
}

// ------------------------------------------------------------ launching

constexpr int kMaxChannels = 2048;
constexpr int kMaxDevices = 64;

// Per device, filled by the first launch there: each instantiation's
// largest grid, indexed [bf16][vector path]. K2's is persistent (as many blocks as
// fit on every SM at once with its shared memory); K1's is kFwdWaves times
// that many.
struct Grids {
  int fwd[2][2];
  int bwd[2][2];
};
Grids g_grids[kMaxDevices];
bool g_ready[kMaxDevices];
std::mutex g_setup;

template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int threads, size_t smem, int sms,
                            int* grid) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem);
  if (e != cudaSuccess) return e;
  *grid = sms * (per_sm > 0 ? per_sm : 1);
  return cudaSuccess;
}

template <typename T>
cudaError_t setup_type(int sms, Grids* g) {
  const int t = sizeof(T) == 2;
  cudaError_t e;
  if ((e = resident_blocks(lrn_fwd_kernel<T, false>, kFwdThreads, 0, sms,
                           &g->fwd[t][0])) != cudaSuccess ||
      (e = resident_blocks(lrn_fwd_kernel<T, true>, kFwdThreads, 0, sms,
                           &g->fwd[t][1])) != cudaSuccess ||
      (e = resident_blocks(lrn_bwd_kernel<T, false>, kThreads, bwd_smem<T>(),
                           sms, &g->bwd[t][0])) != cudaSuccess ||
      (e = resident_blocks(lrn_bwd_kernel<T, true>, kThreads, bwd_smem<T>(),
                           sms, &g->bwd[t][1])) != cudaSuccess)
    return e;
  for (int vec = 0; vec < 2; ++vec) g->fwd[t][vec] *= kFwdWaves;
  return cudaSuccess;
}

cudaError_t setup(const Grids** out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(g_setup);
  if (!g_ready[dev]) {
    int sms = 0;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
        (e = setup_type<float>(sms, &g_grids[dev])) != cudaSuccess ||
        (e = setup_type<bf16>(sms, &g_grids[dev])) != cudaSuccess)
      return e;
    g_ready[dev] = true;
  }
  *out = &g_grids[dev];
  return cudaSuccess;
}

// The vector path's conditions: whole 16-byte chunks a row, 16-byte aligned
// tensors, a window of at most 4 channels to a side.
bool vector_path(int C, size_t elem, int up, int down, const void* a,
               const void* b, const void* c) {
  return C * elem % 16 == 0 && (uintptr_t)a % 16 == 0 &&
         (uintptr_t)b % 16 == 0 && (uintptr_t)c % 16 == 0 && up <= 4 &&
         down <= 4;
}

unsigned capped(long long blocks, int cap) {
  return (unsigned)(blocks < cap ? blocks : cap);
}

template <typename T>
int launch_fwd(const void* x, void* y, long long rows, int C, float k,
               float alpha, float beta, int up, int down, const Grids* g,
               cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  const int t = sizeof(T) == 2;
  const bool vec = vector_path(C, sizeof(T), up, down, x, y, y);
  const long long work = vec ? rows * C / kVec16<T> : rows * C;  // threads' worth
  const unsigned grid = capped((work + kFwdThreads - 1) / kFwdThreads, g->fwd[t][vec]);
  if (vec)
    lrn_fwd_kernel<T, true><<<grid, kFwdThreads, 0, s>>>(
        xp, yp, rows, C, k, alpha, beta, up, down);
  else
    lrn_fwd_kernel<T, false><<<grid, kFwdThreads, 0, s>>>(
        xp, yp, rows, C, k, alpha, beta, up, down);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const void* gr, void* dx, long long rows, int C,
               float k, float alpha, float beta, int up, int down,
               const Grids* g, cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(gr);
  T* dp = static_cast<T*>(dx);
  const int t = sizeof(T) == 2;
  const bool vec = vector_path(C, sizeof(T), up, down, x, gr, dx);
  const long long R = tile_elems<T>() / C;
  const unsigned grid = capped((rows + R - 1) / R, g->bwd[t][vec]);
  if (vec)
    lrn_bwd_kernel<T, true><<<grid, kThreads, bwd_smem<T>(), s>>>(
        xp, gp, dp, rows, C, k, alpha, beta, up, down);
  else
    lrn_bwd_kernel<T, false><<<grid, kThreads, bwd_smem<T>(), s>>>(
        xp, gp, dp, rows, C, k, alpha, beta, up, down);
  return (int)cudaGetLastError();
}

}  // namespace

// is_bf16: 0 for float32 tensors, 1 for bfloat16 ones.
extern "C" int dl4j_lrn_fwd(const void* x, void* y, long long rows, int C,
                            float k, float alpha, float beta, int n, int is_bf16,
                            void* stream) {
  if (C < 1 || C > kMaxChannels || n < 1 || rows < 0)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  const Grids* g = nullptr;
  cudaError_t e = setup(&g);
  if (e != cudaSuccess) return (int)e;
  const int up = n / 2, down = n - 1 - up;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? launch_fwd<__nv_bfloat16>(x, y, rows, C, k, alpha, beta, up,
                                          down, g, s)
              : launch_fwd<float>(x, y, rows, C, k, alpha, beta, up, down, g, s);
}

extern "C" int dl4j_lrn_bwd(const void* x, const void* g, void* dx,
                            long long rows, int C, float k, float alpha,
                            float beta, int n, int is_bf16, void* stream) {
  if (C < 1 || C > kMaxChannels || n < 1 || rows < 0)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  const Grids* grids = nullptr;
  cudaError_t e = setup(&grids);
  if (e != cudaSuccess) return (int)e;
  const int up = n / 2, down = n - 1 - up;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? launch_bwd<__nv_bfloat16>(x, g, dx, rows, C, k, alpha, beta,
                                          up, down, grids, s)
              : launch_bwd<float>(x, g, dx, rows, C, k, alpha, beta, up, down,
                                  grids, s);
}
