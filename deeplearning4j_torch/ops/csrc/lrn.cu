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
// is a few dozen float operations per element (the windows, one or two
// powf), far under the H100's ~20 float operations per byte of device-memory
// bandwidth. So the design only has to read and write each byte once,
// coalesced.
//
// Design: one warp per row at a time, 8 warps per block, grid-stride over
// rows. The warp stages its row in shared memory with consecutive lanes on
// consecutive channels (one 128-byte transaction per 32 channels); each lane
// then works on channels lane, lane + 32, ... from shared memory and writes
// its results, again coalesced. The backward stages x, then in a first pass
// writes t for every channel to a second shared row, and after __syncwarp
// sums t over the transposed window in a second pass; it recomputes d_i there
// rather than keeping a third row. Unlike the TPU kernels there is no
// 128-lane channel padding and no 256-row block padding: a row of C = 64
// moves 256 bytes, not 512, and the ragged end of the rows is just the end of
// the loop.

#include <cuda_runtime.h>

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

__global__ void __launch_bounds__(kThreads)
lrn_bwd_kernel(const float* __restrict__ x, const float* __restrict__ g,
               float* __restrict__ dx, long long rows, int C, float k,
               float alpha, float beta, int up, int down) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* xs = smem + (size_t)warp * 2 * C;  // the row of x
  float* ts = xs + C;                       // t_c = g_c x_c d_c^(-beta-1)
  const float coef = 2.f * alpha * beta;
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long r = (long long)blockIdx.x * kWarps + warp; r < rows;
       r += stride) {
    const float* xr = x + r * C;
    const float* gr = g + r * C;
    float* dr = dx + r * C;
    for (int c = lane; c < C; c += 32) xs[c] = xr[c];
    __syncwarp();
    for (int c = lane; c < C; c += 32) {
      const float d = k + alpha * window_sq_sum(xs, c, C, up, down);
      ts[c] = gr[c] * xs[c] * powf(d, -beta) / d;
    }
    __syncwarp();
    for (int i = lane; i < C; i += 32) {
      const int lo = i - down < 0 ? 0 : i - down;
      const int hi = i + up > C - 1 ? C - 1 : i + up;
      float u = 0.f;
      for (int c = lo; c <= hi; ++c) u += ts[c];
      const float d = k + alpha * window_sq_sum(xs, i, C, up, down);
      dr[i] = gr[i] * powf(d, -beta) - coef * xs[i] * u;
    }
    __syncwarp();  // the next row overwrites xs and ts
  }
}

constexpr int kMaxChannels = 2048;
constexpr int kMaxDevices = 64;
// Per device: the grid cap (64 blocks per SM), 0 until the first launch there
// has read the SM count and raised both kernels' shared-memory limits for
// kMaxChannels rows (forward 8 x 2048 x 4 bytes = 64 KiB, backward two rows
// per warp = 128 KiB, under the 227 KB a block may use). Two threads racing
// on a first launch write the same values, so no lock is needed.
int g_grid_cap[kMaxDevices];

cudaError_t setup(int* grid_cap) {
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
    e = cudaFuncSetAttribute(lrn_bwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)(2 * kWarps * kMaxChannels * sizeof(float)));
    if (e != cudaSuccess) return e;
    g_grid_cap[dev] = sms * 64;
  }
  *grid_cap = g_grid_cap[dev];
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
  cudaError_t e = setup(&cap);
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
  cudaError_t e = setup(&cap);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = (size_t)2 * kWarps * C * sizeof(float);
  const int up = n / 2;
  lrn_bwd_kernel<<<grid_for(rows, cap), kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(g),
      static_cast<float*>(dx), rows, C, k, alpha, beta, up, n - 1 - up);
  return (int)cudaGetLastError();
}
