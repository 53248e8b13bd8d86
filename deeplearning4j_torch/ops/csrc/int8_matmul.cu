// The int8 matrix product of the quantized serving path, for Hopper's int8
// tensor cores.
//
// dl4j_int8_matmul replaces the TPU kernel
// deeplearning4j_tpu/ops/pallas_kernels.py:_int8_matmul_kernel (driven by
// quantize.dense_qforward -> quant_matmul -> int8_matmul_pallas). It computes
//
//     out[b, n] = sum_k x[b, k] * w[n, k]      s8[B, K] x s8[N, K] -> s32[B, N]
//
// exactly, with the weights transposed so that each output channel is one
// contiguous row (quantize_tree's W_q). K <= 131071 keeps every sum, and
// every partial sum of a split K, inside int32 (the wrapper and this entry
// point both check).
//
// Bound: memory at the shapes serving gives it. A dense layer of N outputs
// over K inputs reads its N K weight bytes once per call, against 2 m N K
// operations for a batch of m <= 32 rows: at most 64 operations a byte, far
// under the ~590 at which the H100's int8 tensor cores (1,979 TOPS dense)
// would overtake its 3.35 TB/s. AlexNet's fc7 (K 4096, N 4096) moves 16 MiB
// of weights, 5.2 us at 3.35 TB/s; its output layer (4096, 1000) 4 MiB and
// fc6 (256, 4096) 1 MiB, where the launch and one memory round trip are most
// of the time. So the design has to keep the weight stream full on every SM
// and take the sums off the CUDA cores, where __dp4a (four products a lane an
// instruction) cost about twice the byte bound at m = 32.
//
// Design ("swap AB"): the products run on the tensor cores as
// mma.sync.m16n8k32 s8 x s8 -> s32 with the WEIGHTS in the A operand (16
// output channels x 32 of K) and x in the B operand (8 batch rows), so the
// serving batch is the product's n: a batch of 32 is NF = 4 n-fragments that
// share every A fragment. The sum over k is exact in any order, so each lane
// reads its fragments as 32 contiguous bytes of a row: within a 128-byte step
// of K, lane (g, t) (g = lane / 4, t = lane % 4) takes bytes [32 t, 32 t + 32)
// of weight rows g and g + 8 and of x row g, and k32 product j of the step
// uses bytes 8j .. 8j + 7 of that span as the fragment's k slots 4t .. 4t + 3
// and 16 + 4t .. 16 + 4t + 3. A and B apply the same map, so every k meets
// its own partner.
//
// A block of 4 warps owns 64 output channels (16 a warp) and one tile of up
// to 32 batch rows, over its share of K. Its steps stream through a ring of
// 2 shared-memory stages (64 weight rows + 8 NF x rows, 128 bytes each,
// 16-byte chunk c of row r stored at chunk c ^ (r & 7), so the fragment loads
// are free of bank conflicts) filled by 16-byte cp.async copies, the next
// step in flight while one is multiplied; x is staged once per step for the
// 4 warps. The ring is short so that six blocks fit on an SM, and the
// memory system has many steps in flight from many blocks. Where 64-channel
// tiles give too few blocks for two a SM (the output layer's 16 tiles, fc6's
// short K, fc7's 64 tiles), K is split over a thread block cluster of 2, 4 or
// 8 blocks, no more clusters than fit on the card at once (a second wave
// would double the call). Each block of a cluster owns a band of the tile's
// channels: the others store their partial sums for it straight into its
// shared memory, 8 bytes a store (distributed shared memory; a store does
// not wait on the peer, where a load from it would), and after one cluster
// barrier it adds them and writes its band. The int32 sums are exact and
// associative, so the result is bitwise the plain product whatever the
// split, and nothing is written to device memory but the output, once. Tiles
// of batch rows beyond the first 32 come from a second grid axis (looping
// beyond 65535).
//
// What bounds it at AlexNet's shapes (H100, chip_smoke.py): fc7 at bucket 1
// streams its 16 MiB at about 2 TB/s behind a fixed cost that every call
// pays (launch, one memory round trip, the cluster barrier), and fc6's 1 MiB
// is mostly that fixed cost. At bucket 32 a block's few steps (4 for fc7 over
// 8 blocks) never reach a steady pipeline, and the work besides the weight
// stream is as long as the stream: mma.sync's int8 rate (well under the
// wgmma peak), the split's partial sums (split x m x N x 4 bytes over
// distributed shared memory, 4 MiB for fc7) and the barriers. So fc7 runs at
// about 2x its byte bound, level with torch._int_mm.
//
// Where K is a multiple of 16 and both operands start 16-byte aligned, rows
// move as 16-byte cp.async copies (zero-filled past N, B and K); otherwise
// (row n starts at byte n K) a byte path inside the kernel stages them a
// byte at a time, with bytes past K read as 0. The TPU kernel pads B to 32,
// K to 128 and N to 256-row blocks; nothing is padded in device memory here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTileN = kWarps * 16;   // output channels a block
constexpr int kStep = 128;            // bytes of K a step: four k32 products
constexpr int kChunks = kStep / 16;   // 16-byte chunks a row of a step
constexpr int kStages = 2;
constexpr int kMaxSplit = 8;          // a portable cluster
constexpr int kBlocksPerSm = 2;       // the split's target
constexpr int kMaxK = 2147483647 / (128 * 128);
constexpr int kMaxDevices = 64;

template <int NF>
__host__ __device__ constexpr int stage_bytes() { return (kTileN + 8 * NF) * kStep; }

// int32s from one channel's partial sums to the next in the receive
// buffer: the 8 NF batch rows and 8 of padding, so that lanes g and g + 4
// share a bank at most.
template <int NF>
__host__ __device__ constexpr int recv_stride() { return 8 * NF + 8; }

// The ring, then the receive buffer of the split's partial sums (kTileN
// channels of recv_stride int32s).
template <int NF>
__host__ __device__ constexpr int smem_bytes() {
  return kStages * stage_bytes<NF>() + kTileN * recv_stride<NF>() * 4;
}
static_assert(smem_bytes<4>() <= 48 * 1024,
              "more dynamic shared memory needs cudaFuncAttributeMaxDynamicSharedMemorySize");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c of row r in a staged tile.
__device__ __forceinline__ int swizzled(int r, int c) {
  return r * kStep + ((c ^ (r & 7)) << 4);
}

// Step `step` of K: the block's 64 weight rows and 8 NF x rows into `stage`.
// On the 16-byte path each thread copies 16-byte chunks with cp.async,
// zero-filled outside the matrices; otherwise the block stages a row at a
// time, a byte a thread, with zeros outside them.
template <int NF, bool kVec>
__device__ __forceinline__ void load_step(const int8_t* __restrict__ x,
                                          const int8_t* __restrict__ w,
                                          long long m0, long long B, int n0,
                                          int N, int K, int step,
                                          uint8_t* stage) {
  const int k0 = step * kStep;
  constexpr int kRows = kTileN + 8 * NF;
  if (kVec) {
    for (int i = threadIdx.x; i < kRows * kChunks; i += kThreads) {
      const int r = i / kChunks, c = i % kChunks, k = k0 + 16 * c;
      const int8_t* src = r < kTileN ? w : x;
      const long long row = r < kTileN ? n0 + r : m0 + (r - kTileN);
      const bool in = row < (r < kTileN ? (long long)N : B) && k < K;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                   :: "r"(smem_addr(stage + swizzled(r, c))),
                      "l"(in ? src + row * K + k : src), "r"(in ? 16 : 0));
    }
  } else {
    static_assert(kThreads == kStep, "a thread per byte of a staged row");
    const int b = threadIdx.x, k = k0 + b;
    // Unrolled by 8: ptxas (CUDA 12.8) spilled 4-12 bytes at 1, 2 and full
    // unrolling.
#pragma unroll 8
    for (int r = 0; r < kRows; ++r) {
      const int8_t* src = r < kTileN ? w : x;
      const long long row = r < kTileN ? n0 + r : m0 + (r - kTileN);
      const bool in = row < (r < kTileN ? (long long)N : B) && k < K;
      stage[swizzled(r, b >> 4) + (b & 15)] = in ? (uint8_t)__ldg(src + row * K + k) : 0;
    }
  }
}

// The 32 bytes [32 t, 32 t + 32) of staged row r as eight words.
__device__ __forceinline__ void row_span(const uint8_t* tile, int r, int t,
                                         uint32_t (&v)[8]) {
  const uint4 lo = *reinterpret_cast<const uint4*>(tile + swizzled(r, 2 * t));
  const uint4 hi = *reinterpret_cast<const uint4*>(tile + swizzled(r, 2 * t + 1));
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

// The first half of a cluster barrier, with no memory ordering: this block
// has started. barrier.cluster.wait completes it.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// A cluster-wide barrier that also orders every block's shared-memory
// stores before the other blocks' loads after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}

// (v0, v1) into the shared memory of the cluster's block `rank`, at the
// (8-byte aligned) offset of `local` in this block's.
__device__ __forceinline__ void store_to_rank(int* local, int rank, int v0, int v1) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(smem_addr(local)), "r"(rank));
  asm volatile("st.shared::cluster.v2.u32 [%0], {%1, %2};\n"
               :: "r"(remote), "r"(v0), "r"(v1) : "memory");
}

__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// grid.x = 64-channel tiles x `split` (the cluster's size), grid.y = batch
// tiles of 8 NF rows. Cluster rank r sums steps [r T / split, (r+1) T / split)
// of the T = ceil(K / 128).
template <int NF, bool kVec>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   int* __restrict__ out, long long B, int K, int N, int split) {
  extern __shared__ __align__(128) uint8_t smem[];
  constexpr int MT = 8 * NF;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rank = cluster_rank();
  const int n0 = (blockIdx.x / split) * kTileN;
  const int steps = (K + kStep - 1) / kStep;
  const int s0 = (int)((long long)rank * steps / split);
  const int s1 = (int)((long long)(rank + 1) * steps / split);
  const int nsteps = s1 - s0;
  // Rank q owns the tile's channels [q chs, (q + 1) chs); its receive buffer
  // holds, for every rank r of the cluster, r's partial sums of them:
  // channel c of the band at recv[(r chs + c) stride + m], batch rows
  // contiguous.
  int* recv = reinterpret_cast<int*>(smem + kStages * stage_bytes<NF>());
  constexpr int stride = recv_stride<NF>();
  const int chs = kTileN / split;
  const long long mtiles = (B + MT - 1) / MT;
  cluster_arrive_relaxed();  // this block has started; waited on below
  bool peers_started = false;
  for (long long mt = blockIdx.y; mt < mtiles; mt += gridDim.y) {
    const long long m0 = mt * MT;
    int acc[NF][4];
#pragma unroll
    for (int f = 0; f < NF; ++f) acc[f][0] = acc[f][1] = acc[f][2] = acc[f][3] = 0;
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < nsteps)
        load_step<NF, kVec>(x, w, m0, B, n0, N, K, s0 + s,
                            smem + s * stage_bytes<NF>());
      asm volatile("cp.async.commit_group;\n" ::);
    }
    for (int it = 0; it < nsteps; ++it) {
      asm volatile("cp.async.wait_group %0;\n" :: "n"(kStages - 2));
      __syncthreads();  // step `it` has landed; step it - 1's readers are done
      const int next = it + kStages - 1;
      if (next < nsteps)
        load_step<NF, kVec>(x, w, m0, B, n0, N, K, s0 + next,
                            smem + (next % kStages) * stage_bytes<NF>());
      asm volatile("cp.async.commit_group;\n" ::);
      const uint8_t* stage = smem + (it % kStages) * stage_bytes<NF>();
      uint32_t a1[8], a2[8];
      row_span(stage, warp * 16 + g, t, a1);
      row_span(stage, warp * 16 + g + 8, t, a2);
      uint32_t b[NF][8];
#pragma unroll
      for (int f = 0; f < NF; ++f) row_span(stage, kTileN + f * 8 + g, t, b[f]);
#pragma unroll
      for (int j = 0; j < 4; ++j)  // the NF products of a k32 slice are independent
#pragma unroll
        for (int f = 0; f < NF; ++f)
          mma_s8(acc[f], a1[2 * j], a2[2 * j], a1[2 * j + 1], a2[2 * j + 1],
                 b[f][2 * j], b[f][2 * j + 1]);
    }
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();  // every warp is done with the ring before it refills
    if (!peers_started) {  // a peer's shared memory is there once it started
      cluster_wait();
      peers_started = true;
    }
    // Push each pair of partial sums to its owner (a store does not wait on
    // the peer). D[channel, batch row]: c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8,
    // 2t), c3 (g + 8, 2t + 1), so c0 c1 and c2 c3 are adjacent rows.
#pragma unroll
    for (int f = 0; f < NF; ++f) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ch = warp * 16 + g + 8 * h, q = ch / chs;
        store_to_rank(recv + (rank * chs + ch - q * chs) * stride + f * 8 + 2 * t, q,
                      acc[f][2 * h], acc[f][2 * h + 1]);
      }
    }
    cluster_sync();  // every partial of this rank's band has arrived
    for (int j = threadIdx.x; j < chs * MT; j += kThreads) {
      const int m = j / chs, c = j % chs;  // channels fastest: coalesced writes
      int sum = 0;
      for (int r = 0; r < split; ++r) sum += recv[(r * chs + c) * stride + m];
      const int ch = rank * chs + c;
      if (m0 + m < B && n0 + ch < N) out[(m0 + m) * N + n0 + ch] = sum;
    }
    if (mt + gridDim.y < mtiles) cluster_sync();  // recv is read before refills
  }
}

// Per device: the SM count, 0 until the first launch there has read it and
// asked every instantiation for the largest shared-memory carveout; and, per
// instantiation and split, how many clusters fit on the card at once, 0 until
// first asked. Two threads racing on a first launch write the same values,
// so no lock is needed.
int g_sms[kMaxDevices];
int g_clusters[kMaxDevices][4][2][4];  // [dev][NF - 1][vec][log2 split]

template <int NF>
cudaError_t carve() {  // smem_bytes stays under 48 KiB: no other attribute
  cudaError_t e = cudaFuncSetAttribute(int8_matmul_kernel<NF, true>,
                                       cudaFuncAttributePreferredSharedMemoryCarveout,
                                       (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(int8_matmul_kernel<NF, false>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

cudaError_t setup(int dev) {
  if (g_sms[dev] != 0) return cudaSuccess;
  cudaError_t e;
  if ((e = carve<1>()) != cudaSuccess || (e = carve<2>()) != cudaSuccess ||
      (e = carve<3>()) != cudaSuccess || (e = carve<4>()) != cudaSuccess)
    return e;
  int sms = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  g_sms[dev] = sms;
  return cudaSuccess;
}

cudaLaunchConfig_t config(dim3 grid, int smem, int split, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = split;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of `split` blocks of this instantiation that the card holds at
// once.
template <int NF, bool kVec>
cudaError_t max_clusters(int dev, int split, int* n) {
  int lg = 0;
  while ((1 << lg) < split) ++lg;
  int& cached = g_clusters[dev][NF - 1][kVec][lg];
  if (cached == 0) {
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = config(dim3(split, 1, 1), smem_bytes<NF>(), split, 0, &attr);
    int got = 0;
    cudaError_t e = cudaOccupancyMaxActiveClusters(
        &got, (void*)int8_matmul_kernel<NF, kVec>, &cfg);
    if (e != cudaSuccess) return e;
    cached = got > 0 ? got : 1;
  }
  *n = cached;
  return cudaSuccess;
}

// K's split: the least of 1, 2, 4, 8 that gives kBlocksPerSm blocks a SM, no
// more than one split a step of K, and no more clusters than the card holds
// at once (a second wave would double the call's time).
template <int NF, bool kVec>
cudaError_t plan_split(int dev, long long clusters, int steps, int* split) {
  const int sms = g_sms[dev];
  int s = 1;
  while (s < kMaxSplit && 2 * s <= steps && clusters * s < (long long)kBlocksPerSm * sms) {
    int fit = 0;
    cudaError_t e = max_clusters<NF, kVec>(dev, 2 * s, &fit);
    if (e != cudaSuccess) return e;
    if (clusters > fit) break;
    s *= 2;
  }
  *split = s;
  return cudaSuccess;
}

template <int NF, bool kVec>
cudaError_t launch_one(const int8_t* x, const int8_t* w, int* out, long long B,
                       int K, int N, int dev, cudaStream_t stream) {
  const long long mtiles = (B + 8 * NF - 1) / (8 * NF);
  const int ntiles = (N + kTileN - 1) / kTileN;
  const unsigned gy = (unsigned)(mtiles < 65535 ? mtiles : 65535);
  int split = 1;
  cudaError_t e = plan_split<NF, kVec>(dev, (long long)ntiles * gy,
                                       (K + kStep - 1) / kStep, &split);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(dim3((unsigned)(ntiles * split), gy, 1),
                                        smem_bytes<NF>(), split, stream, &attr);
  return cudaLaunchKernelEx(&cfg, int8_matmul_kernel<NF, kVec>, x, w, out, B, K,
                            N, split);
}

template <int NF>
cudaError_t launch(const int8_t* x, const int8_t* w, int* out, long long B,
                   int K, int N, bool vec, int dev, cudaStream_t stream) {
  return vec ? launch_one<NF, true>(x, w, out, B, K, N, dev, stream)
             : launch_one<NF, false>(x, w, out, B, K, N, dev, stream);
}

}  // namespace

extern "C" int dl4j_int8_matmul(const void* x, const void* w, void* out,
                                long long B, int K, int N, void* stream) {
  if (B < 1 || N < 1 || K < 1 || K > kMaxK) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if ((e = setup(dev)) != cudaSuccess) return (int)e;
  const bool vec = K % 16 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)w % 16 == 0;
  const int8_t* xq = static_cast<const int8_t*>(x);
  const int8_t* wq = static_cast<const int8_t*>(w);
  int* o = static_cast<int*>(out);
  cudaStream_t s = (cudaStream_t)stream;
  if (B <= 8) e = launch<1>(xq, wq, o, B, K, N, vec, dev, s);
  else if (B <= 16) e = launch<2>(xq, wq, o, B, K, N, vec, dev, s);
  else if (B <= 24) e = launch<3>(xq, wq, o, B, K, N, vec, dev, s);
  else e = launch<4>(xq, wq, o, B, K, N, vec, dev, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
