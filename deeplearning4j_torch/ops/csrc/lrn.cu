// Cross-channel local response normalization, forward, float32, for Hopper.
//
// Replaces the TPU kernel deeplearning4j_tpu/ops/pallas_kernels.py:_lrn_kernel
// (driven by lrn -> _lrn_pallas -> _run_lrn_call). It computes, for each pixel
// row of an NHWC tensor viewed as [rows, C],
//
//     y[r, c] = x[r, c] / (k + alpha * sum_{j=c-up}^{c+down} x[r, j]^2)^beta
//
// with up = n / 2, down = n - 1 - up and channels outside [0, C) counted as 0
// (the window of lrn_reference, asymmetric for even n).
//
// Bound: memory. Each element is read once and written once, 8 bytes, while
// the arithmetic is about 2n + 20 float operations (the window, one powf):
// at AlexNet's n = 5 that is far under the H100's ~20 float operations per
// byte of device-memory bandwidth. So the design only has to read and write
// each byte once, coalesced.
//
// Design: one warp per row at a time, 8 warps per block, grid-stride over
// rows. The warp stages its row of x in shared memory with consecutive lanes
// on consecutive channels (one 128-byte transaction per 32 channels), then
// each lane computes its channels' window sums from shared memory and writes
// y, again coalesced. Unlike the TPU kernel there is no 128-lane channel
// padding and no 256-row block padding: a row of C = 64 moves 256 bytes, not
// 512, and the ragged end of the rows is just the end of the loop.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

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
      const int lo = c - up < 0 ? 0 : c - up;
      const int hi = c + down > C - 1 ? C - 1 : c + down;
      float acc = 0.f;
      for (int j = lo; j <= hi; ++j) acc += row_buf[j] * row_buf[j];
      yr[c] = row_buf[c] / powf(k + alpha * acc, beta);
    }
    __syncwarp();  // the next row overwrites row_buf
  }
}

constexpr int kMaxChannels = 2048;  // 8 rows x 2048 x 4 bytes = 64 KiB
constexpr int kMaxDevices = 64;
// Per device: the grid cap (64 blocks per SM), 0 until the first launch there
// has read the SM count and raised the kernel's shared-memory limit to
// kMaxChannels rows. Two threads racing on a first launch write the same
// values, so no lock is needed.
int g_grid_cap[kMaxDevices];

}  // namespace

extern "C" int dl4j_lrn_fwd(const void* x, void* y, long long rows, int C,
                            float k, float alpha, float beta, int n,
                            void* stream) {
  if (C < 1 || C > kMaxChannels || n < 1) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (g_grid_cap[dev] == 0) {
    int sms = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(lrn_fwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)(kWarps * kMaxChannels * sizeof(float)));
    if (e != cudaSuccess) return (int)e;
    g_grid_cap[dev] = sms * 64;
  }
  const size_t smem = (size_t)kWarps * C * sizeof(float);
  long long blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > g_grid_cap[dev]) blocks = g_grid_cap[dev];  // grid-stride beyond
  const int up = n / 2;
  lrn_fwd_kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<float*>(y), rows, C, k, alpha,
      beta, up, n - 1 - up);
  return (int)cudaGetLastError();
}
