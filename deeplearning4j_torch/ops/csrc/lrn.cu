// Cross-channel local response normalization, forward and backward, float32,
// for Hopper.
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
// Bound: memory, for both. The forward reads x and writes y, 8 bytes per
// element; the backward reads x and g and writes dx, 12 bytes. The arithmetic
// is a few dozen float operations per element (the windows, a power), far
// under the H100's ~20 float operations per byte of device-memory bandwidth.
// At AlexNet's shapes (batch 128: 24.8 M elements at C = 64, 4.8 M at C =
// 192) the backward's least time is 0.0888 + 0.0173 ms at 3.35 TB/s.
//
// K1 (lrn_fwd_kernel, unchanged since it was first ported): one warp per row
// at a time, 8 warps per block, grid-stride over rows. The warp stages its
// row in shared memory with consecutive lanes on consecutive channels; each
// lane then works on channels lane, lane + 32, ... from shared memory and
// writes its results, coalesced. One row (256 bytes at C = 64) is in flight a
// warp, which bounds it at about 3x its byte bound.
//
// K2 (lrn_bwd_kernel): a persistent grid, as many 512-thread blocks as fit on
// the SMs at once, walks tiles of R = 2048 / C rows. Because [rows, C] is
// contiguous, a tile of x or g is one span of R C floats: it moves into a
// ring of 3 shared-memory stages as cp.async copies, with the block's next
// two tiles in flight while it computes one. Each term is
// computed once: pass 1 takes d = k + alpha window(x^2), p = d^-beta (as
// exp2(-beta log2 d) on the special-function unit) and writes t = g x p / d
// to a shared row and g p over g; pass 2 sums t over the transposed window
// and writes dx = g p - 2 alpha beta x u straight to device memory. Where C
// is a multiple of 4 and the window reaches at most 4 channels to a side (n
// <= 9, AlexNet's 5) a thread takes 4 consecutive channels: its windows come
// from three 16-byte shared loads held in registers and dx leaves as one
// 16-byte store, consecutive threads on consecutive addresses, and the
// tiles move as 16-byte copies. Otherwise (C not a multiple of 4, a tensor
// not 16-byte aligned, a wider window) a thread takes one channel and loops
// over its window, and the tiles move as 4-byte copies. Unlike the TPU kernels
// there is no 128-lane channel padding and no 256-row block padding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float window_sq_sum(const float* row, int c, int C,
                                               int up, int down) {
  const int lo = c - up < 0 ? 0 : c - up;
  const int hi = c + down > C - 1 ? C - 1 : c + down;
  float acc = 0.f;
  for (int j = lo; j <= hi; ++j) acc += row[j] * row[j];
  return acc;
}

__global__ void __launch_bounds__(kThreads)
lrn_fwd_kernel(const float* __restrict__ x, float* __restrict__ y,
               long long rows, int C, float k, float alpha, float beta,
               int up, int down) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* row_buf = smem + (size_t)warp * C;
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long r = (long long)blockIdx.x * kWarps + warp; r < rows;
       r += stride) {
    const float* xr = x + r * C;
    float* yr = y + r * C;
    for (int c = lane; c < C; c += 32) row_buf[c] = xr[c];
    __syncwarp();
    for (int c = lane; c < C; c += 32) {
      const float acc = window_sq_sum(row_buf, c, C, up, down);
      yr[c] = row_buf[c] / powf(k + alpha * acc, beta);
    }
    __syncwarp();  // the next row overwrites row_buf
  }
}

// ---------------------------------------------------------------- K2

constexpr int kBwdThreads = 512;
constexpr int kBwdTile = 2048;  // floats of x (and of g) a tile: kMaxChannels
constexpr int kBwdStages = 3;
// The ring's stages of x and g, then t: 57,344 bytes.
constexpr size_t kBwdSmem = (2 * kBwdStages + 1) * kBwdTile * sizeof(float);

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Tile `tile` of x and g (rows [tile R, tile R + R) of C floats, one
// contiguous span) into xs and gs: 16-byte cp.async copies on the 4-channel
// path, 4-byte ones otherwise.
template <bool kQuad>
__device__ __forceinline__ void bwd_load(const float* __restrict__ x,
                                         const float* __restrict__ g,
                                         long long base, int span, float* xs,
                                         float* gs) {
  if (kQuad) {
    for (int q = threadIdx.x; q < span / 4; q += kBwdThreads) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                   :: "r"(smem_addr(xs + 4 * q)), "l"(x + base + 4 * q));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                   :: "r"(smem_addr(gs + 4 * q)), "l"(g + base + 4 * q));
    }
  } else {
    for (int e = threadIdx.x; e < span; e += kBwdThreads) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                   :: "r"(smem_addr(xs + e)), "l"(x + base + e));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                   :: "r"(smem_addr(gs + e)), "l"(g + base + e));
    }
  }
}

// Channels c - 4 .. c + 7 of a staged row (c a multiple of 4, C of 4): zero
// outside [0, C).
__device__ __forceinline__ void quad_span(const float* row, int c, int C,
                                          float (&v)[12]) {
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 a = c >= 4 ? *reinterpret_cast<const float4*>(row + c - 4) : z;
  const float4 b = *reinterpret_cast<const float4*>(row + c);
  const float4 d = c + 4 < C ? *reinterpret_cast<const float4*>(row + c + 4) : z;
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  v[8] = d.x; v[9] = d.y; v[10] = d.z; v[11] = d.w;
}

// d^-beta on the special-function unit: exp2(-beta log2 d).
__device__ __forceinline__ float pow_neg(float d, float beta) {
  return exp2f(-beta * __log2f(d));
}

// Pass 1 over a staged tile: for each element, d = k + alpha window(x^2),
// p = d^-beta, t = g x p / d into ts and g p over g in gs. Pass 2: dx = g p -
// 2 alpha beta x sum_{transposed window} t, written to device memory.
// kQuad: a thread takes 4 consecutive channels, windows of at most 4 to
// either side from registers and 16-byte shared and device accesses;
// otherwise one channel, windows of any width from shared memory.
template <bool kQuad>
__device__ __forceinline__ void bwd_pass1(const float* xs, float* gs,
                                          float* ts, int span, int C, float k,
                                          float alpha, float beta, int up,
                                          int down) {
  if (kQuad) {
    for (int e = 4 * threadIdx.x; e < span; e += 4 * kBwdThreads) {
      const int r = e / C, c = e - r * C;
      float v[12];
      quad_span(xs + r * C, c, C, v);
      const float4 g4 = *reinterpret_cast<const float4*>(gs + e);
      const float gv[4] = {g4.x, g4.y, g4.z, g4.w};
      float t[4], gp[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float sq = 0.f;
#pragma unroll
        for (int o = -4; o <= 4; ++o)
          if (o >= -up && o <= down) sq += v[4 + i + o] * v[4 + i + o];
        const float d = k + alpha * sq;
        const float p = pow_neg(d, beta);
        t[i] = gv[i] * v[4 + i] * p * __frcp_rn(d);
        gp[i] = gv[i] * p;
      }
      *reinterpret_cast<float4*>(ts + e) = make_float4(t[0], t[1], t[2], t[3]);
      *reinterpret_cast<float4*>(gs + e) = make_float4(gp[0], gp[1], gp[2], gp[3]);
    }
  } else {
    for (int e = threadIdx.x; e < span; e += kBwdThreads) {
      const int r = e / C, c = e - r * C;
      const float* row = xs + r * C;
      const float d = k + alpha * window_sq_sum(row, c, C, up, down);
      const float p = pow_neg(d, beta);
      ts[e] = gs[e] * row[c] * p * __frcp_rn(d);
      gs[e] *= p;
    }
  }
}

template <bool kQuad>
__device__ __forceinline__ void bwd_pass2(const float* xs, const float* gs,
                                          const float* ts, float* __restrict__ dx,
                                          long long base, int span, int C,
                                          float coef, int up, int down) {
  if (kQuad) {
    for (int e = 4 * threadIdx.x; e < span; e += 4 * kBwdThreads) {
      const int r = e / C, c = e - r * C;
      float v[12];
      quad_span(ts + r * C, c, C, v);
      const float4 x4 = *reinterpret_cast<const float4*>(xs + e);
      const float4 gp4 = *reinterpret_cast<const float4*>(gs + e);
      const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
      const float gp[4] = {gp4.x, gp4.y, gp4.z, gp4.w};
      float out[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float u = 0.f;
#pragma unroll
        for (int o = -4; o <= 4; ++o)  // the transposed window: up and down swap
          if (o >= -down && o <= up) u += v[4 + i + o];
        out[i] = gp[i] - coef * xv[i] * u;
      }
      *reinterpret_cast<float4*>(dx + base + e) =
          make_float4(out[0], out[1], out[2], out[3]);
    }
  } else {
    for (int e = threadIdx.x; e < span; e += kBwdThreads) {
      const int r = e / C, i = e - r * C;
      const float* trow = ts + r * C;
      const int lo = i - down < 0 ? 0 : i - down;
      const int hi = i + up > C - 1 ? C - 1 : i + up;
      float u = 0.f;
      for (int c = lo; c <= hi; ++c) u += trow[c];
      dx[base + e] = gs[e] - coef * xs[e] * u;
    }
  }
}

// A persistent grid walks the tiles of R = kBwdTile / C rows: block b takes
// tiles b, b + grid, ..., with the next kBwdStages - 1 of its tiles in flight
// while it computes one.
template <bool kQuad>
__global__ void __launch_bounds__(kBwdThreads)
lrn_bwd_kernel(const float* __restrict__ x, const float* __restrict__ g,
               float* __restrict__ dx, long long rows, int C, float k,
               float alpha, float beta, int up, int down) {
  extern __shared__ __align__(16) float smem[];
  float* ts = smem + 2 * kBwdStages * kBwdTile;
  const float coef = 2.f * alpha * beta;
  const long long R = kBwdTile / C;
  const long long tiles = (rows + R - 1) / R;
  auto span_of = [&](long long tile) {
    const long long left = rows - tile * R;
    return (int)((left < R ? left : R) * C);
  };
#pragma unroll
  for (int s = 0; s < kBwdStages - 1; ++s) {
    const long long tile = blockIdx.x + (long long)s * gridDim.x;
    if (tile < tiles)
      bwd_load<kQuad>(x, g, tile * R * C, span_of(tile),
                     smem + 2 * s * kBwdTile, smem + (2 * s + 1) * kBwdTile);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (long long j = 0;; ++j) {
    const long long tile = blockIdx.x + j * gridDim.x;
    if (tile >= tiles) break;
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kBwdStages - 2));
    __syncthreads();  // tile j has landed; tile j - 1's readers are done
    const long long next = tile + (long long)(kBwdStages - 1) * gridDim.x;
    const int ns = (int)((j + kBwdStages - 1) % kBwdStages);
    if (next < tiles)
      bwd_load<kQuad>(x, g, next * R * C, span_of(next),
                     smem + 2 * ns * kBwdTile, smem + (2 * ns + 1) * kBwdTile);
    asm volatile("cp.async.commit_group;\n" ::);
    const int cs = (int)(j % kBwdStages);
    float* xs = smem + 2 * cs * kBwdTile;
    float* gs = xs + kBwdTile;
    const int span = span_of(tile);
    bwd_pass1<kQuad>(xs, gs, ts, span, C, k, alpha, beta, up, down);
    __syncthreads();  // every t of the tile is in ts
    bwd_pass2<kQuad>(xs, gs, ts, dx, tile * R * C, span, C, coef, up, down);
  }
  asm volatile("cp.async.wait_all;\n" ::);
}

constexpr int kMaxChannels = 2048;
constexpr int kMaxDevices = 64;
// Per device, 0 until the first launch there has read the SM count and
// raised the kernels' shared-memory limits: K1's grid cap (64 blocks per SM;
// its shared memory is 8 rows of up to kMaxChannels floats, 64 KiB) and K2's
// persistent grid for each of its two instantiations (as many blocks as fit
// on every SM at once with kBwdSmem each). Two threads racing on a first
// launch write the same values, so no lock is needed.
int g_grid_cap[kMaxDevices];
int g_bwd_grid[kMaxDevices][2];

template <bool kQuad>
cudaError_t setup_bwd(int sms, int* grid) {
  cudaError_t e = cudaFuncSetAttribute(lrn_bwd_kernel<kQuad>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)kBwdSmem);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, lrn_bwd_kernel<kQuad>, kBwdThreads, kBwdSmem);
  if (e != cudaSuccess) return e;
  *grid = sms * (per_sm > 0 ? per_sm : 1);
  return cudaSuccess;
}

cudaError_t setup(int* grid_cap, int** bwd_grid) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (g_grid_cap[dev] == 0) {
    int sms = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(lrn_fwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)(kWarps * kMaxChannels * sizeof(float)));
    if (e != cudaSuccess) return e;
    if ((e = setup_bwd<false>(sms, &g_bwd_grid[dev][0])) != cudaSuccess ||
        (e = setup_bwd<true>(sms, &g_bwd_grid[dev][1])) != cudaSuccess)
      return e;
    g_grid_cap[dev] = sms * 64;
  }
  *grid_cap = g_grid_cap[dev];
  *bwd_grid = g_bwd_grid[dev];
  return cudaSuccess;
}

unsigned grid_for(long long rows, int cap) {
  long long blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > cap) blocks = cap;  // grid-stride beyond
  return (unsigned)blocks;
}

}  // namespace

extern "C" int dl4j_lrn_fwd(const void* x, void* y, long long rows, int C,
                            float k, float alpha, float beta, int n,
                            void* stream) {
  if (C < 1 || C > kMaxChannels || n < 1) return (int)cudaErrorInvalidValue;
  int cap = 0;
  int* bwd_grid = nullptr;
  cudaError_t e = setup(&cap, &bwd_grid);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = (size_t)kWarps * C * sizeof(float);
  const int up = n / 2;
  lrn_fwd_kernel<<<grid_for(rows, cap), kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<float*>(y), rows, C, k, alpha,
      beta, up, n - 1 - up);
  return (int)cudaGetLastError();
}

extern "C" int dl4j_lrn_bwd(const void* x, const void* g, void* dx,
                            long long rows, int C, float k, float alpha,
                            float beta, int n, void* stream) {
  if (C < 1 || C > kMaxChannels || n < 1) return (int)cudaErrorInvalidValue;
  int cap = 0;
  int* bwd_grid = nullptr;
  cudaError_t e = setup(&cap, &bwd_grid);
  if (e != cudaSuccess) return (int)e;
  const int up = n / 2, down = n - 1 - up;
  const bool quad = C % 4 == 0 && (uintptr_t)x % 16 == 0 &&
                    (uintptr_t)g % 16 == 0 && (uintptr_t)dx % 16 == 0 &&
                    up <= 4 && down <= 4;
  const long long tiles = (rows + kBwdTile / C - 1) / (kBwdTile / C);
  const unsigned grid =
      (unsigned)(tiles < bwd_grid[quad] ? tiles : bwd_grid[quad]);
  const float* xp = static_cast<const float*>(x);
  const float* gp = static_cast<const float*>(g);
  float* dp = static_cast<float*>(dx);
  cudaStream_t s = (cudaStream_t)stream;
  if (quad)
    lrn_bwd_kernel<true><<<grid, kBwdThreads, kBwdSmem, s>>>(
        xp, gp, dp, rows, C, k, alpha, beta, up, down);
  else
    lrn_bwd_kernel<false><<<grid, kBwdThreads, kBwdSmem, s>>>(
        xp, gp, dp, rows, C, k, alpha, beta, up, down);
  return (int)cudaGetLastError();
}
