// The int8 matrix product of the quantized serving path, for Hopper.
//
// dl4j_int8_matmul replaces the TPU kernel
// deeplearning4j_tpu/ops/pallas_kernels.py:_int8_matmul_kernel (driven by
// quantize.dense_qforward -> quant_matmul -> int8_matmul_pallas). It computes
//
//     out[b, n] = sum_k x[b, k] * w[n, k]      s8[B, K] x s8[N, K] -> s32[B, N]
//
// exactly, with the weights transposed so that each output channel is one
// contiguous row (quantize_tree's W_q). K <= 131071 keeps every sum inside
// int32 (the wrapper and this entry point both check).
//
// Bound: memory at the shapes serving gives it. A dense layer of N outputs
// over K inputs reads its N K weight bytes once per call, against 2 m N K
// operations for a batch of m <= 32 rows: at most 64 operations a byte, far
// under the ~590 at which the H100's int8 tensor cores (1,979 TOPS dense)
// would overtake its 3.35 TB/s. So the weights are streamed once, 16 bytes a
// lane, with the next step's loads issued before the current step's sums.
// This first kernel sums on the CUDA cores (__dp4a: four int8 products into
// an int32 a lane an instruction), whose rate bounds it at m = 32 to about
// twice the byte bound; tensor cores (mma.sync s8, wgmma) and TMA are later
// work.
//
// Design: one 256-thread block per tile of 16 output channels, 2 per warp,
// and per tile of MT batch rows (MT the smallest of 1, 2, 4, 8, 16, 32 that
// holds min(B, 32); a further grid axis loops over the tiles beyond 65535).
// K runs in steps of 512 bytes: the block stages the step's x rows in shared
// memory (MT x 512 bytes, zero past B and K), each lane loads its 16 bytes of
// its warp's two weight rows, and sums x[m] . w[n] for every row m of the
// tile into registers with four __dp4a. At the end a warp-shuffle reduction
// gives each (m, n) sum, the block gathers its MT x 16 tile in shared memory
// and writes it a row of 64 bytes at a time. The N and B edges are masked.
// Where K is a multiple of 16 and both operands start 16-byte aligned, rows
// move as int4 vectors; otherwise (row n starts at byte n K) a byte path
// inside the kernel loads and packs them, with bytes past K read as 0. The
// TPU kernel pads B to 32, K to 128 and N to 256-row blocks; nothing is
// padded here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChanPerWarp = 2;
constexpr int kChanPerBlock = kWarps * kChanPerWarp;
constexpr int kStep = 512;  // bytes of K per step: 16 a lane
constexpr int kMaxK = 2147483647 / (128 * 128);

// A lane's 16 bytes w[n, k .. k + 16) as four packed words; rows at or past
// N and bytes at or past K read as 0.
template <bool kVec>
__device__ __forceinline__ void load_w(const int8_t* __restrict__ w, int n,
                                       int N, int K, int k, int (&out)[4]) {
  out[0] = out[1] = out[2] = out[3] = 0;
  if (n >= N || k >= K) return;
  const int8_t* p = w + (long long)n * K + k;
  if (kVec) {  // K % 16 == 0, so the whole vector lies inside the row
    const int4 v = __ldg(reinterpret_cast<const int4*>(p));
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    unsigned word = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (k + 4 * i + j < K)
        word |= (unsigned)(uint8_t)p[4 * i + j] << (8 * j);
    }
    out[i] = (int)word;
  }
}

// The tile's rows x[m0 .. m0 + MT, k0 .. k0 + kStep) into xs ([MT][kStep]
// bytes), 0 past B and K.
template <int MT, bool kVec>
__device__ __forceinline__ void stage_x(const int8_t* __restrict__ x,
                                        long long m0, long long B, int K,
                                        int k0, int8_t* xs) {
  if (kVec) {
    constexpr int kVecsPerRow = kStep / 16;
    for (int i = threadIdx.x; i < MT * kVecsPerRow; i += kThreads) {
      const long long row = m0 + i / kVecsPerRow;
      const int k = k0 + (i % kVecsPerRow) * 16;
      int4 v = make_int4(0, 0, 0, 0);
      if (row < B && k < K) v = *reinterpret_cast<const int4*>(x + row * K + k);
      reinterpret_cast<int4*>(xs)[i] = v;
    }
  } else {
    for (int i = threadIdx.x; i < MT * kStep; i += kThreads) {
      const long long row = m0 + i / kStep;
      const int k = k0 + i % kStep;
      xs[i] = (row < B && k < K) ? x[row * K + k] : (int8_t)0;
    }
  }
}

template <int MT, bool kVec>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   int* __restrict__ out, long long B, int K, int N) {
  __shared__ __align__(16) int8_t xs[MT * kStep];
  __shared__ int tile[MT][kChanPerBlock];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * kChanPerBlock;
  const int nw = n0 + warp * kChanPerWarp;  // this warp's first channel
  const long long mtiles = (B + MT - 1) / MT;
  for (long long mt = blockIdx.y; mt < mtiles; mt += gridDim.y) {
    const long long m0 = mt * MT;
    int acc[kChanPerWarp][MT];
#pragma unroll
    for (int c = 0; c < kChanPerWarp; ++c)
#pragma unroll
      for (int m = 0; m < MT; ++m) acc[c][m] = 0;
    int wc[kChanPerWarp][4];
#pragma unroll
    for (int c = 0; c < kChanPerWarp; ++c)
      load_w<kVec>(w, nw + c, N, K, lane * 16, wc[c]);
    for (int k0 = 0; k0 < K; k0 += kStep) {
      __syncthreads();  // the last step's readers are done with xs and tile
      stage_x<MT, kVec>(x, m0, B, K, k0, xs);
      int wn[kChanPerWarp][4];  // the next step's weights, in flight meanwhile
#pragma unroll
      for (int c = 0; c < kChanPerWarp; ++c)
        load_w<kVec>(w, nw + c, N, K, k0 + kStep + lane * 16, wn[c]);
      __syncthreads();
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int4 xv = *reinterpret_cast<const int4*>(xs + m * kStep + lane * 16);
#pragma unroll
        for (int c = 0; c < kChanPerWarp; ++c) {
          int a = acc[c][m];
          a = __dp4a(xv.x, wc[c][0], a);
          a = __dp4a(xv.y, wc[c][1], a);
          a = __dp4a(xv.z, wc[c][2], a);
          a = __dp4a(xv.w, wc[c][3], a);
          acc[c][m] = a;
        }
      }
#pragma unroll
      for (int c = 0; c < kChanPerWarp; ++c)
#pragma unroll
        for (int i = 0; i < 4; ++i) wc[c][i] = wn[c][i];
    }
#pragma unroll
    for (int c = 0; c < kChanPerWarp; ++c) {
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        int v = acc[c][m];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane == m) tile[m][warp * kChanPerWarp + c] = v;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < MT * kChanPerBlock; i += kThreads) {
      const long long row = m0 + i / kChanPerBlock;
      const int n = n0 + i % kChanPerBlock;
      if (row < B && n < N) out[row * N + n] = tile[i / kChanPerBlock][i % kChanPerBlock];
    }
  }
}

template <int MT>
cudaError_t launch(const int8_t* x, const int8_t* w, int* out, long long B,
                   int K, int N, bool vec, cudaStream_t stream) {
  const long long mtiles = (B + MT - 1) / MT;
  const dim3 grid((unsigned)((N + kChanPerBlock - 1) / kChanPerBlock),
                  (unsigned)(mtiles < 65535 ? mtiles : 65535));
  if (vec)
    int8_matmul_kernel<MT, true><<<grid, kThreads, 0, stream>>>(x, w, out, B, K, N);
  else
    int8_matmul_kernel<MT, false><<<grid, kThreads, 0, stream>>>(x, w, out, B, K, N);
  return cudaGetLastError();
}

}  // namespace

extern "C" int dl4j_int8_matmul(const void* x, const void* w, void* out,
                                long long B, int K, int N, void* stream) {
  if (B < 1 || N < 1 || K < 1 || K > kMaxK) return (int)cudaErrorInvalidValue;
  const bool vec = K % 16 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)w % 16 == 0;
  const int8_t* xq = static_cast<const int8_t*>(x);
  const int8_t* wq = static_cast<const int8_t*>(w);
  int* o = static_cast<int*>(out);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (B <= 1) e = launch<1>(xq, wq, o, B, K, N, vec, s);
  else if (B <= 2) e = launch<2>(xq, wq, o, B, K, N, vec, s);
  else if (B <= 4) e = launch<4>(xq, wq, o, B, K, N, vec, s);
  else if (B <= 8) e = launch<8>(xq, wq, o, B, K, N, vec, s);
  else if (B <= 16) e = launch<16>(xq, wq, o, B, K, N, vec, s);
  else e = launch<32>(xq, wq, o, B, K, N, vec, s);
  return (int)e;
}
