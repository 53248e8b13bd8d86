// Single-query attention against a KV cache (decode), float32 or bfloat16
// inputs with float32 sums, for Hopper.
//
// dl4j_decode_attention (K7) replaces the TPU kernel reached by
// deeplearning4j_tpu/ops/flash_attention.py:decode_attention, which runs
// _fwd_kernel through _fwd_call with one query row (q_block = 1) over a
// bucketed KV view under a key mask built from cache_len. For every batch
// row i and head hh, with n_i = min(cache_len[i], t_kv),
//
//     s_j = q[i, 0, hh] . k[i, j, hh] / sqrt(d),   j < n_i
//     o[i, 0, hh] = sum_j softmax(s)_j v[i, j, hh]
//
// and o = 0 where n_i <= 0 (a row no key may see, as under the flash arm's
// key mask). Keys at j >= n_i carry weight exactly 0 under the JAX mask and
// are never read here.
//
// Layout: q and o are [b, 1, h, d], contiguous; k and v are [b, t_kv, h, d]
// with any batch and key strides (in elements) and contiguous heads, so a
// per-layer slice of the decode step's [b, t_kv, layers, h, d] view is read
// in place. cache_len is [b] int32.
//
// Bound: bytes. One query row does 4 d flops per key (q.k and p.v) against
// 2 d elements of K and V read once: 1 flop a byte in float32, 2 in
// bfloat16, far under the card's ~20 float32 flops a byte of device memory.
// So there is no tensor-core work to do (a 64-row tile would waste 63 of its
// rows) and the aim is to stream the valid prefixes of K and V at the
// memory's rate, from enough blocks to fill the card, in one launch.
//
// Design: split-KV ("flash-decoding") in one launch.
// * Grid b * h * S blocks; the S blocks of one (row, head) form a thread
//   block cluster (S <= 8, the portable size, chosen by the wrapper from
//   b * h, t_kv and the SM count: cache_len lives on the device and the host
//   never reads it). A block has 4 warps, or 8 where it takes at least
//   kWideKeys keys of the bucket: there a block streams long enough that
//   twice the lanes (and twice the ring) keep more of its keys in flight.
// * Per-row split, on the device: block s of row i takes keys
//   [s c_i, min((s + 1) c_i, n_i)), c_i = ceil(n_i / S) rounded up to one
//   iteration of the block (its lane groups times kGroupKeys). A short row's
//   surplus blocks have no keys at all, and a long row's blocks carry n_i / S
//   keys each, not t_kv / S. A block with no keys does not return: it holds
//   m = -inf, l = 0 and takes part in the merge.
// * Lane groups: the warps are cut into groups of G lanes (G the power of
//   two that covers d in 16-byte pieces: 8 lanes for d 32 in float32, 16 for
//   d 128 in bfloat16, 32 for d 128 in float32; one element a lane where d
//   or the strides are not whole 16-byte pieces). A group takes one key at
//   a time: the dot product is summed across the group by butterfly
//   shuffles (every lane gets the same sum), and the group keeps a running
//   max m, sum l and a d-wide accumulator in float32 registers (online
//   softmax). The key loop has a block-uniform trip count (the shuffles need
//   the whole warp) and masks keys past the block's range instead of
//   branching around them.
// * Streaming (the 16-byte route): K and V pass through a ring of kStages
//   stages in shared memory, filled with cp.async.cg 16-byte copies, one
//   commit group a stage; a lane computes on stage it while the next
//   kStages - 1 are in flight. Each lane copies exactly the 16-byte pieces
//   it later reads itself, so the ring needs no __syncthreads: a lane's
//   cp.async.wait_group covers its own copies. cp.async and not
//   cp.async.bulk (TMA's one-dimensional copy): a key row of one head is
//   128-512 bytes, so one bulk copy and mbarrier per row would cost the
//   issuing thread about as much as the lanes' own copies, and every lane
//   group would then wait on rows other warps issued, behind a block-wide
//   barrier a stage. Keys past the range are zero-filled (src-size 0), never
//   read. The element route (d or a stride not a whole number of 16-byte
//   pieces) keeps register loads, kGroupKeys keys a group in flight.
// * Merge: each block merges its groups by their maxima into (m, l, acc[d])
//   and writes it into rank 0's shared memory, slot `rank`, through
//   distributed shared memory (a store does not wait on the peer). One
//   cluster barrier later rank 0 holds every partial: it merges them by
//   their maxima, divides by the merged sum and rounds once to the output
//   type. Rank 0 reads no other block's shared memory, so no block has to
//   stay resident for it and one barrier is enough; a barrier arrival at the
//   kernel's start, waited on just before the stores, makes sure rank 0 has
//   started before anyone writes to it. (Rank 0 pulling the partials
//   instead takes a second barrier, to keep the others resident until it
//   has read them, and the round trip of its remote loads: slower at every
//   cluster size on the card.) S = 1 is the same kernel with a plain launch
//   and no cluster barrier. There is no scratch in device memory and no
//   second kernel.
// * Heads wider than kMaxHeadDim (128), up to kWideMaxHeadDim (4096), take
//   the wide arm (K7w, decode_wide_ring_kernel; the JAX package's decode
//   takes any head_dim its gate passes, and the wrapper raises past 4096).
//   Its rows are 0.5-16 KB. The design:
//   - Scores once, K and V once. One block a (row, head, split), 256
//     threads, covers the whole head_dim. Its threads form groups of
//     `group` lanes (8 up to 256, the fewest that hold a row in at most 32
//     floats a lane: 8 lanes at head_dim 256, 128 at 2688); lane r of a
//     group holds pieces r, r + group, ... of q (in registers), of its
//     accumulator and of every row it reads: the same output columns
//     throughout. A tile gives each group one key; the group sums its score
//     over the whole head_dim once (shuffles, and across its warps through
//     shared memory, one barrier a tile, where a group spans warps), updates
//     its running max, sum and accumulator once (online softmax), and each
//     lane adds p V to its own columns. K and V are read once at every
//     head_dim. Few lanes a key and many floats a lane matter most: the
//     work is about 1 flop a byte, so what a tile costs is instructions and
//     shared-memory traffic, not arithmetic (an earlier cut with 32 lanes a
//     key and 8 floats a lane took 16.3 us where this one takes 10.0 at the
//     wide engine's shape on one split). A cluster over column chunks, summing partial dots through
//     distributed shared memory as K3w does, was the other layout; it loses
//     here: the cluster already carries the splits (chunks x splits <= 8
//     would take the splits from the rows that need them) and every tile
//     would wait on a cluster exchange where this layout sums within a
//     warp, or a block at 2688.
//   - Keys in flight. K and V pass through a ring of 2-6 stages in shared
//     memory (up to 192 KB: one block an SM), filled by 16-byte cp.async.cg
//     copies, one commit group a stage: a tile's V is issued with its K, and
//     the next stages - 1 tiles are in flight while a thread computes one.
//     Each thread copies exactly the pieces it later reads, zero-filling
//     (src-size 0, nothing read) a key past the block's range or a piece
//     past the row, so the ring needs no barrier and the loops no tests.
//     cp.async and not cp.async.bulk (TMA): both were measured on the card
//     (an H100 at 700 W). TMA with one bulk copy a row, issued by each
//     group's first lane and counted on an mbarrier a stage, was slower
//     (20.4 against 16.3 us at the wide engine's shape on one split, an
//     earlier cut of this kernel): a row is 0.5-10.5 KB, every copy is one
//     more serialized issue on a lane the whole warp waits for, and the
//     ring's shared-memory writes cost the same either way. What a tile
//     costs on the card is the copies' issue (about 45% at head_dim 256)
//     and the scores' chain; see PERF.md.
//   - Splits. The wrapper's rule for the wide arm counts bytes (K and V of
//     a key row times the bucket) against the SM count
//     (flash_attention.decode_wide_splits); each row's keys are split by
//     its own length on the device, as above.
//   - bfloat16 copies 16 bytes (8 elements) a piece and converts in
//     registers; a lane then holds twice the elements in the same pieces.
//   - The merge: the groups of a block by their maxima (one warp's
//     shuffles), then, on several splits, block b of the cluster takes
//     output columns [b slice, (b + 1) slice): every block pushes its
//     partial of those columns and its m and l into block b's shared memory
//     through distributed shared memory (a barrier arrival at the kernel's
//     start, waited on just before the stores, makes sure every block has
//     started), one cluster barrier, and each block merges and writes its
//     slice. One split writes its output directly. There is no scratch in
//     device memory and no second kernel. (K7's merge on rank 0 needs room
//     for eight d-wide partials beside the ring, 86 KB at head_dim 2688, or
//     a second cluster barrier to reuse the ring for them; on the card that
//     cut cost 1-4 us more a call than the slices.)
//   - No spill: every instance keeps its pieces in registers (ptxas, in
//     chip_smoke.py's build log, is held to no spill).
//   - wide_geometry computes the cut; dl4j_decode_wide_geometry exports it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxHeadDim = 128;
constexpr int kMaxSplits = 8;   // a portable cluster
constexpr int kStages = 3;      // the ring's depth (16-byte route)
constexpr int kGroupKeys = 4;   // keys a lane group takes an iteration
constexpr int kWideKeys = 512;  // bucket keys a block from which it has 8 warps

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// VEC consecutive elements at p into f[0, VEC), as float: one 16-byte load
// (4 float32 or 8 bfloat16) or, for VEC 1, one element. p may point into
// global or shared memory.
template <typename T, int VEC>
__device__ __forceinline__ void load(const T* p, float* f) {
  if constexpr (VEC == 1) {
    f[0] = to_float(p[0]);
  } else if constexpr (sizeof(T) == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  } else {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {   // bfloat16 is the top half of a float32
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global src to shared dst, or 16 zero bytes (nothing read)
// where !ok.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Until at most N of this thread's newest commit groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The first half of a cluster barrier, with no memory ordering: this block
// has started. cluster_wait completes it.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// A cluster-wide barrier that also orders every block's stores to shared
// memory (its peers' too) before the loads after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// `local`'s counterpart in the shared memory of the cluster's block `rank`,
// as a generic address: plain stores through it write that block's shared
// memory (distributed shared memory).
__device__ __forceinline__ float* rank_ptr(float* local, int rank) {
  float* remote;
  asm("mapa.u64 %0, %1, %2;\n" : "=l"(remote) : "l"(local), "r"(rank));
  return remote;
}

// Pieces of VEC elements a lane holds: a group of 32 lanes covers d = 128 at
// one element a lane in 4 pieces; every other group covers d in one.
template <int VEC, int G>
__host__ __device__ constexpr int pieces() { return G == 32 ? (kMaxHeadDim / VEC + 31) / 32 : 1; }

template <int G, int W>
__host__ __device__ constexpr int groups() { return W * (32 / G); }

// The ring: kStages x kGroupKeys x (K, V) x threads 16-byte slots, a lane's
// slots 16 bytes apart from its neighbours' (conflict-free reads).
template <int VEC, int W>
__host__ __device__ constexpr int ring_bytes() {
  return VEC > 1 ? kStages * kGroupKeys * 2 * W * 32 * 16 : 0;
}

// Floats of the merge area: the groups' accumulators (a row of pieces x VEC
// x G each), their m, l and weights, then, used on rank 0, a slot of acc[d],
// m, l for each block of the cluster.
template <int VEC, int G, int W>
__host__ __device__ constexpr int merge_floats() {
  return groups<G, W>() * pieces<VEC, G>() * VEC * G + 3 * groups<G, W>() +
         kMaxSplits * (kMaxHeadDim + 2);
}

template <int VEC, int G, int W>
__host__ __device__ constexpr int smem_bytes() {
  return ring_bytes<VEC, W>() + 4 * merge_floats<VEC, G, W>();
}
static_assert(smem_bytes<8, 16, 8>() <= 227 * 1024 && smem_bytes<4, 32, 8>() <= 227 * 1024,
              "a block's shared memory is at most 227 KB");

// W warps a block.
template <typename T, int VEC, int G, int W>
__global__ void __launch_bounds__(W * 32)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ cache_len,
                        T* __restrict__ o, int h, int t, int d, long long k_sb,
                        long long k_st, long long v_sb, long long v_st, int splits,
                        float scale) {
  constexpr bool kStaged = VEC > 1;
  constexpr int kThreads = W * 32;
  constexpr int P = pieces<VEC, G>();
  constexpr int E = P * VEC;              // elements of a row a lane holds
  constexpr int NG = groups<G, W>();      // lane groups a block
  constexpr int KG = kGroupKeys;
  constexpr int U = NG * KG;              // keys a block takes an iteration
  constexpr int STRIDE = E * G;           // a group's row in the merge area (>= d)
  constexpr int SLOT = kMaxHeadDim + 2;   // a block's partial on rank 0: acc[d], m, l
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  float* sm_acc = reinterpret_cast<float*>(smem + ring_bytes<VEC, W>());
  float* sm_m = sm_acc + NG * STRIDE;
  float* sm_l = sm_m + NG;
  float* sm_w = sm_l + NG;
  float* recv = sm_w + NG;                // rank 0: the cluster's partials

  const bool cluster = splits > 1;
  if (cluster) cluster_arrive_relaxed();  // this block has started; waited on below
  const int bh = blockIdx.x / splits;
  const int rank = blockIdx.x - bh * splits;   // = %cluster_ctarank
  const int i = bh / h, hh = bh - i * h;
  const int n = max(0, min(cache_len[i], t));
  const int per = (n + splits - 1) / splits;
  const int chunk = (per + U - 1) / U * U;
  const int lo = min(rank * chunk, n);
  const int hi = min(lo + chunk, n);
  const int iters = (hi - lo + U - 1) / U;   // 0 for a block with no keys
  const int lane = threadIdx.x & 31;
  const int r = lane & (G - 1);                        // lane within its group
  const int grp = (threadIdx.x >> 5) * (32 / G) + lane / G;
  const int pieces_d = (d + VEC - 1) / VEC;

  const T* qb = q + (long long)bh * d;
  float qf[E];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int piece = p * G + r;
    if (piece < pieces_d) {
      load<T, VEC>(qb + piece * VEC, qf + p * VEC);
    } else {
#pragma unroll
      for (int x = 0; x < VEC; ++x) qf[p * VEC + x] = 0.f;
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) qf[e] *= scale;

  const T* kb = k + i * k_sb + (long long)hh * d;
  const T* vb = v + i * v_sb + (long long)hh * d;
  float m = -INFINITY, l = 0.f, acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;

  // This lane's ring slot for key u of a stage (kv 0: K, 1: V).
  auto slot = [&](int stage, int u, int kv) {
    return reinterpret_cast<T*>(ring + (((stage * KG + u) * 2 + kv) * kThreads +
                                        threadIdx.x) * 16);
  };
  // Iteration it's keys into its stage (16-byte route; P = 1 there).
  auto issue = [&](int it) {
    const int stage = it % kStages;
#pragma unroll
    for (int u = 0; u < KG; ++u) {
      const int j = lo + it * U + u * NG + grp;
      const bool ok = j < hi && r < pieces_d;
      cp_async16(slot(stage, u, 0), ok ? kb + j * k_st + r * VEC : qb, ok);
      cp_async16(slot(stage, u, 1), ok ? vb + j * v_st + r * VEC : qb, ok);
    }
  };
  if constexpr (kStaged) {
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < iters) issue(s);
      cp_async_commit();
    }
  }

  for (int it = 0; it < iters; ++it) {
    float kf[KG][E], vf[KG][E];
    if constexpr (kStaged) {
      cp_async_wait<kStages - 2>();   // this lane's copies of stage it landed
#pragma unroll
      for (int u = 0; u < KG; ++u) {
        load<T, VEC>(slot(it % kStages, u, 0), kf[u]);
        load<T, VEC>(slot(it % kStages, u, 1), vf[u]);
      }
      // Refill the slot this lane read at it - 1.
      if (it + kStages - 1 < iters) issue(it + kStages - 1);
      cp_async_commit();
    } else {
#pragma unroll
      for (int u = 0; u < KG; ++u) {
        const int j = lo + it * U + u * NG + grp;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const int piece = p * G + r;
          if (j < hi && piece < pieces_d) {
            load<T, VEC>(kb + j * k_st + piece * VEC, kf[u] + p * VEC);
            load<T, VEC>(vb + j * v_st + piece * VEC, vf[u] + p * VEC);
          } else {
#pragma unroll
            for (int x = 0; x < VEC; ++x) kf[u][p * VEC + x] = vf[u][p * VEC + x] = 0.f;
          }
        }
      }
    }
    float s[KG];
    float m_new = m;
#pragma unroll
    for (int u = 0; u < KG; ++u) {
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) dot = fmaf(qf[e], kf[u][e], dot);
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      const bool valid = lo + it * U + u * NG + grp < hi;
      s[u] = valid ? dot : -INFINITY;
      m_new = fmaxf(m_new, s[u]);
    }
    if (m_new != -INFINITY) {   // else no key of this group yet
      const float corr = expf(m - m_new);   // 0 on the group's first key
      l *= corr;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] *= corr;
#pragma unroll
      for (int u = 0; u < KG; ++u) {
        const float p = expf(s[u] - m_new);   // 0 for a key past hi (its v is 0)
        l += p;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] = fmaf(p, vf[u][e], acc[e]);
      }
      m = m_new;
    }
  }
  if constexpr (kStaged) cp_async_wait<0>();   // only empty groups are left

  // Merge the block's groups by their maxima (m = -inf, l = 0, acc = 0 for a
  // block with no keys) into its slot on rank 0.
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int x = 0; x < VEC; ++x)
      sm_acc[grp * STRIDE + (p * G + r) * VEC + x] = acc[p * VEC + x];
  if (r == 0) {
    sm_m[grp] = m;
    sm_l[grp] = l;
  }
  __syncthreads();
  float mb = -INFINITY;
  for (int g = 0; g < NG; ++g) mb = fmaxf(mb, sm_m[g]);
  if (threadIdx.x < NG) {
    const float mg = sm_m[threadIdx.x];
    sm_w[threadIdx.x] = mg == -INFINITY ? 0.f : expf(mg - mb);
  }
  __syncthreads();
  float* dst = recv + rank * SLOT;
  if (cluster) {
    cluster_wait();   // every block of the cluster has started: rank 0 is there
    dst = rank_ptr(dst, 0);
  }
  for (int e = threadIdx.x; e < d; e += kThreads) {
    float sum = 0.f;
    for (int g = 0; g < NG; ++g) sum = fmaf(sm_w[g], sm_acc[g * STRIDE + e], sum);
    dst[e] = sum;
  }
  if (threadIdx.x == 0) {
    float lb = 0.f;
    for (int g = 0; g < NG; ++g) lb = fmaf(sm_w[g], sm_l[g], lb);
    dst[kMaxHeadDim] = mb;
    dst[kMaxHeadDim + 1] = lb;
  }
  if (cluster) cluster_sync();   // every partial has reached rank 0
  else __syncthreads();
  if (rank != 0) return;

  // Rank 0: merge the cluster's partials by their maxima, divide, round once.
  float w[kMaxSplits];
  float mc = -INFINITY, lc = 0.f;
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s)
    if (s < splits) mc = fmaxf(mc, recv[s * SLOT + kMaxHeadDim]);
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s) {
    const float ms = s < splits ? recv[s * SLOT + kMaxHeadDim] : -INFINITY;
    w[s] = ms == -INFINITY ? 0.f : expf(ms - mc);
    if (s < splits) lc = fmaf(w[s], recv[s * SLOT + kMaxHeadDim + 1], lc);
  }
  const float inv = lc > 0.f ? 1.f / lc : 0.f;   // lc = 0: no key, output 0
  T* out = o + (long long)bh * d;
  for (int e = threadIdx.x; e < d; e += kThreads) {
    float sum = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s)
      if (s < splits) sum = fmaf(w[s], recv[s * SLOT + e], sum);
    store(out + e, sum * inv);
  }
}

constexpr int kMaxDevices = 64;

// Dynamic shared memory above 48 KB must be allowed once per device and
// instantiation. Two threads racing on a first launch set the same value.
template <typename T, int VEC, int G, int W>
cudaError_t allow_smem() {
  constexpr int bytes = smem_bytes<VEC, G, W>();
  if constexpr (bytes <= 48 * 1024) {
    return cudaSuccess;
  } else {
    static bool allowed[kMaxDevices];
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
    if (!allowed[dev]) {
      e = cudaFuncSetAttribute(decode_attention_kernel<T, VEC, G, W>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (e != cudaSuccess) return e;
      allowed[dev] = true;
    }
    return cudaSuccess;
  }
}

template <typename T, int VEC, int G, int W>
cudaError_t launch_one(const void* q, const void* k, const void* v, const int* len,
                       void* o, int bh, int h, int t, int d, long long k_sb,
                       long long k_st, long long v_sb, long long v_st, int splits,
                       float scale, cudaStream_t s) {
  const cudaError_t e = allow_smem<T, VEC, G, W>();
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(bh * splits), 1, 1);
  cfg.blockDim = dim3(W * 32, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes<VEC, G, W>();
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = splits;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, decode_attention_kernel<T, VEC, G, W>,
                            static_cast<const T*>(q), static_cast<const T*>(k),
                            static_cast<const T*>(v), len, static_cast<T*>(o), h, t, d,
                            k_sb, k_st, v_sb, v_st, splits, scale);
}

// The element route (VEC 1) always runs 4 warps.
template <typename T, int VEC, int G>
cudaError_t launch_by_warps(bool wide, const void* q, const void* k, const void* v,
                            const int* len, void* o, int bh, int h, int t, int d,
                            long long k_sb, long long k_st, long long v_sb,
                            long long v_st, int splits, float scale, cudaStream_t s) {
  if constexpr (VEC > 1) {
    if (wide)
      return launch_one<T, VEC, G, 8>(q, k, v, len, o, bh, h, t, d, k_sb, k_st, v_sb,
                                      v_st, splits, scale, s);
  }
  return launch_one<T, VEC, G, 4>(q, k, v, len, o, bh, h, t, d, k_sb, k_st, v_sb, v_st,
                                  splits, scale, s);
}

template <typename T, int VEC>
cudaError_t launch_by_group(int G, bool wide, const void* q, const void* k,
                            const void* v, const int* len, void* o, int bh, int h,
                            int t, int d, long long k_sb, long long k_st,
                            long long v_sb, long long v_st, int splits, float scale,
                            cudaStream_t s) {
#define DL4J_DECODE(g)                                                            \
  return launch_by_warps<T, VEC, g>(wide, q, k, v, len, o, bh, h, t, d, k_sb,    \
                                    k_st, v_sb, v_st, splits, scale, s)
  switch (G) {
    case 1: DL4J_DECODE(1);
    case 2: DL4J_DECODE(2);
    case 4: DL4J_DECODE(4);
    case 8: DL4J_DECODE(8);
    case 16: DL4J_DECODE(16);
    default: DL4J_DECODE(32);
  }
#undef DL4J_DECODE
}

// --------------------------------------------------------- the wide arm, d > 128

constexpr int kRingThreads = 256;           // a block: 8 warps
constexpr int kRingWarps = kRingThreads / 32;
constexpr int kRingMinGroup = 8;            // lanes a key at least
constexpr int kRingMaxGroups = kRingThreads / kRingMinGroup;
constexpr int kWideMaxHeadDim = 4096;
constexpr int kRingMaxStages = 6;
constexpr int kRingBytes = 192 * 1024;      // the ring's aim: one block an SM
constexpr int kRingTwoKeyStage = 64 * 1024; // a group takes two keys a tile up to this stage

// 16-byte pieces (vec) or elements a thread holds at most: 32 floats.
__host__ __device__ constexpr int wide_most(int elem, bool vec_route) {
  return vec_route ? (elem == 4 ? 8 : 4) : 16;
}

// The pieces a thread holds, as instantiated, for `need` of them.
__host__ __device__ constexpr int wide_per(int need, int elem, bool vec_route) {
  if (!vec_route) return need <= 8 ? 8 : 16;
  if (elem == 2) return need <= 2 ? 2 : need;
  return need <= 2 ? 2 : need <= 4 ? 4 : need <= 6 ? 6 : 8;
}

// The wide arm's cut of a row and of its ring, for head_dim d, elements of
// `elem` bytes, on the 16-byte route or the element route. smem 0: refused.
struct WideGeometry {
  int vec;      // elements a piece: 16 bytes' worth (4 float32, 8 bfloat16), or 1
  int pieces;   // pieces of a row: ceil(d / vec)
  int group;    // threads that share a key (a power of two, kRingMinGroup..kRingThreads)
  int per;      // pieces a thread holds (the kernel's P)
  int keys;     // keys a group takes a tile (the kernel's KG: 1 or 2)
  int tile;     // keys a tile: groups x keys
  int stages;   // the ring's depth
  int row;      // ring bytes of one key's K (or V) row: per x group pieces
  int area;     // bytes of the ring, which the merge reuses after the key loop
  int smem;     // dynamic shared memory bytes
};

__host__ __device__ constexpr int round16(int bytes) { return (bytes + 15) / 16 * 16; }

// Bytes after the area: the warps' partial scores [2][warps][2], the groups' m,
// l and merge weights, the block's merged m and l, the cluster's partials of
// this block's output slice (cols + kMaxSplits floats) and their m and l.
__host__ __device__ constexpr int wide_tail_bytes(int cols) {
  return 2 * kRingWarps * 2 * 4 + 3 * kRingMaxGroups * 4 + 16 +
         round16((cols + 3 * kMaxSplits) * 4);
}

__host__ __device__ constexpr WideGeometry wide_geometry(int d, int elem, bool vec_route) {
  WideGeometry g{};
  g.vec = vec_route ? 16 / elem : 1;
  const int most = wide_most(elem, vec_route);
  g.pieces = (d + g.vec - 1) / g.vec;
  g.group = kRingMinGroup;
  while (g.group < kRingThreads && (g.pieces + g.group - 1) / g.group > most) g.group *= 2;
  const int need = (g.pieces + g.group - 1) / g.group;
  if (d <= kMaxHeadDim || d > kWideMaxHeadDim || need > most) return g;
  g.per = wide_per(need, elem, vec_route);
  const int groups = kRingThreads / g.group;
  g.row = round16(g.per * g.group * g.vec * elem);
  g.keys = groups * 2 * 2 * g.row <= kRingTwoKeyStage ? 2 : 1;
  g.tile = groups * g.keys;
  const int stage = g.tile * 2 * g.row;
  const int stages = kRingBytes / stage;
  g.stages = stages < 2 ? 2 : stages > kRingMaxStages ? kRingMaxStages : stages;
  const int cols = g.pieces * g.vec;
  const int ring = g.stages * stage;
  const int merge = round16(groups * cols * 4);
  g.area = ring > merge ? ring : merge;
  g.smem = g.area + wide_tail_bytes(cols);
  return g;
}
static_assert(wide_geometry(kWideMaxHeadDim, 4, true).smem <= 232448 &&
              wide_geometry(kWideMaxHeadDim, 4, false).smem <= 232448 &&
              wide_geometry(kWideMaxHeadDim, 2, true).smem <= 232448 &&
              wide_geometry(kWideMaxHeadDim, 2, false).smem <= 232448,
              "a block's shared memory is at most 227 KB");

// Until this thread's copies of the oldest stage in flight have landed: at
// most stages - 2 newer commit groups still in flight.
__device__ __forceinline__ void cp_async_wait_ring(int stages) {
  if (stages >= 4) cp_async_wait<2>();
  else if (stages == 3) cp_async_wait<1>();
  else cp_async_wait<0>();
}

// One element from global src to shared dst (the element route), or zero
// (nothing read) where !ok.
__device__ __forceinline__ void copy_elem(float* dst, const float* src, bool ok) {
  *dst = ok ? *src : 0.f;
}
__device__ __forceinline__ void copy_elem(bf16* dst, const bf16* src, bool ok) {
  *reinterpret_cast<unsigned short*>(dst) =
      ok ? *reinterpret_cast<const unsigned short*>(src) : (unsigned short)0;
}

// K7w: one block a (row, head, split), kRingThreads threads in groups of
// geo.group; thread r of a group holds pieces r, r + group, ... (P of them)
// of q (in registers), of its accumulator and of every ring row: its output
// columns. A tile gives each group KG keys: the group sums their scores over
// the whole head_dim once (its lanes' partial dots by shuffles, across its
// warps through shared memory, one barrier a tile), keeps a running max, sum
// and accumulator (online softmax) and adds p V to its columns. Every
// thread copies into the ring exactly the pieces it reads (zeros for a key
// past the range or a piece past the row), so the ring needs no barrier and
// the loops no tests.
template <typename T, int VEC, int P, int KG>
__global__ void __launch_bounds__(kRingThreads, 1)
decode_wide_ring_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ cache_len,
                        T* __restrict__ o, int h, int t, int d, long long k_sb,
                        long long k_st, long long v_sb, long long v_st, int splits,
                        float scale, WideGeometry geo) {
  const int G = geo.group, KT = geo.tile, NS = geo.stages;
  const int NG = kRingThreads / G;   // groups
  const int pieces = geo.pieces;
  const int cols = pieces * VEC;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  float* sm_acc = reinterpret_cast<float*>(smem);       // after the key loop
  float* red = reinterpret_cast<float*>(smem + geo.area);   // [2][warps][2] partial scores
  float* sm_m = red + 2 * kRingWarps * 2;               // [groups]
  float* sm_l = sm_m + kRingMaxGroups;
  float* sm_w = sm_l + kRingMaxGroups;
  float* sm_ml = sm_w + kRingMaxGroups;                 // the block's m and l
  float* recv = sm_ml + 4;                              // [splits][slice] partials
  float* recv_ml = recv + cols + kMaxSplits;            // [splits][2] their m, l

  const bool cluster = splits > 1;
  if (cluster) cluster_arrive_relaxed();  // this block has started; waited on below
  const int bh = blockIdx.x / splits;
  const int rank = blockIdx.x - bh * splits;   // = %cluster_ctarank
  const int i = bh / h, hh = bh - i * h;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = tid / G, r = tid - grp * G;
  const int n = max(0, min(cache_len[i], t));   // first: the copies wait on it

  const T* qb = q + (long long)bh * d;
  float qf[P * VEC];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int pc = p * G + r;
    if (pc < pieces) {
      load<T, VEC>(qb + pc * VEC, qf + p * VEC);
    } else {
#pragma unroll
      for (int x = 0; x < VEC; ++x) qf[p * VEC + x] = 0.f;
    }
  }

  const int per_split = (n + splits - 1) / splits;
  const int chunk = (per_split + KT - 1) / KT * KT;
  const int lo = min(rank * chunk, n);
  const int hi = min(lo + chunk, n);
  const int iters = (hi - lo + KT - 1) / KT;   // 0 for a block with no keys
  const T* kb = k + i * k_sb + (long long)hh * d;
  const T* vb = v + i * v_sb + (long long)hh * d;
  const int stage_bytes = KT * 2 * geo.row;
  // This thread's first piece in its group's first K row of stage 0 (V is a
  // row on, the next key two rows on).
  T* mine = reinterpret_cast<T*>(ring + grp * KG * 2 * geo.row) + r * VEC;
  const int v_off = geo.row / (int)sizeof(T);

  // Tile it's keys of this group, this thread's pieces, into its stage.
  auto issue = [&](int it) {
    const int j0 = lo + it * KT + grp * KG;
#pragma unroll
    for (int u = 0; u < KG; ++u) {
      T* dst = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(mine) +
                                    (it % NS) * stage_bytes) + u * 2 * v_off;
      const int j = j0 + u;
      const bool ok = j < hi;
      const T* ks = kb + (ok ? j * k_st : 0);
      const T* vs = vb + (ok ? j * v_st : 0);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int pc = p * G + r;
        const bool in = ok && pc < pieces;
        if constexpr (VEC > 1) {
          cp_async16(dst + p * G * VEC, in ? ks + pc * VEC : qb, in);
          cp_async16(dst + v_off + p * G * VEC, in ? vs + pc * VEC : qb, in);
        } else {
          copy_elem(dst + p * G, ks + (in ? pc : 0), in);
          copy_elem(dst + v_off + p * G, vs + (in ? pc : 0), in);
        }
      }
    }
    if constexpr (VEC > 1) cp_async_commit();
  };
  for (int s = 0; s < NS - 1; ++s) {
    if (s < iters) issue(s);
    else if constexpr (VEC > 1) cp_async_commit();
  }

  float m = -INFINITY, l = 0.f, acc[P * VEC];
#pragma unroll
  for (int e = 0; e < P * VEC; ++e) acc[e] = 0.f;
  for (int it = 0; it < iters; ++it) {
    if constexpr (VEC > 1) cp_async_wait_ring(NS);   // this thread's copies of tile it
    if (it + NS - 1 < iters) issue(it + NS - 1);     // the stage it read at it - 1
    else if constexpr (VEC > 1) cp_async_commit();
    const T* ks = reinterpret_cast<const T*>(reinterpret_cast<const unsigned char*>(mine) +
                                             (it % NS) * stage_bytes);

    // This group's keys' scores, over the whole head_dim.
    float part[KG][2];
#pragma unroll
    for (int u = 0; u < KG; ++u) part[u][0] = part[u][1] = 0.f;
#pragma unroll
    for (int u = 0; u < KG; ++u) {
#pragma unroll
      for (int p = 0; p < P; ++p) {
        float kf[VEC];
        load<T, VEC>(ks + u * 2 * v_off + p * G * VEC, kf);
#pragma unroll
        for (int x = 0; x < VEC; ++x)
          part[u][x & 1] = fmaf(qf[p * VEC + x], kf[x], part[u][x & 1]);
      }
    }
    float dot[KG];
#pragma unroll
    for (int u = 0; u < KG; ++u) dot[u] = (part[u][0] + part[u][1]) * scale;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      if (off < G) {
#pragma unroll
        for (int u = 0; u < KG; ++u) dot[u] += __shfl_xor_sync(0xffffffffu, dot[u], off);
      }
    if (G > 32) {   // a group of several warps: sum their partials, in warp order
      float* rd = red + (it & 1) * kRingWarps * 2;   // two buffers: one barrier a tile
      if (lane == 0) {
#pragma unroll
        for (int u = 0; u < KG; ++u) rd[warp * 2 + u] = dot[u];
      }
      __syncthreads();
      const int w0 = grp * (G / 32);
#pragma unroll
      for (int u = 0; u < KG; ++u) {
        dot[u] = 0.f;
#pragma unroll
        for (int w = 0; w < kRingWarps; ++w)
          if (w < G / 32) dot[u] += rd[(w0 + w) * 2 + u];
      }
    }

    // Online softmax over the group's keys, then p V into its columns.
    float m_new = m;
#pragma unroll
    for (int u = 0; u < KG; ++u) {
      dot[u] = lo + it * KT + grp * KG + u < hi ? dot[u] : -INFINITY;
      m_new = fmaxf(m_new, dot[u]);
    }
    if (m_new != -INFINITY) {   // else no key of this group yet
      const float corr = expf(m - m_new);   // 0 on the group's first key
      float pj[KG];
      l *= corr;
#pragma unroll
      for (int u = 0; u < KG; ++u) {
        pj[u] = expf(dot[u] - m_new);   // 0 for a key past hi (its V is 0)
        l += pj[u];
      }
#pragma unroll
      for (int p = 0; p < P; ++p) {
        float vf[KG][VEC];
#pragma unroll
        for (int u = 0; u < KG; ++u) load<T, VEC>(ks + (u * 2 + 1) * v_off + p * G * VEC, vf[u]);
#pragma unroll
        for (int x = 0; x < VEC; ++x) {
          float a = acc[p * VEC + x] * corr;
#pragma unroll
          for (int u = 0; u < KG; ++u) a = fmaf(pj[u], vf[u][x], a);
          acc[p * VEC + x] = a;
        }
      }
      m = m_new;
    }
  }
  if constexpr (VEC > 1) cp_async_wait<0>();   // only empty groups are left
  __syncthreads();   // the ring is read: its area takes the merge

  // Merge the block's groups by their maxima (m = -inf, l = 0, acc = 0 for a
  // group with no keys).
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int pc = p * G + r;
    if (pc < pieces) {
#pragma unroll
      for (int x = 0; x < VEC; ++x) sm_acc[grp * cols + pc * VEC + x] = acc[p * VEC + x];
    }
  }
  if (r == 0) {
    sm_m[grp] = m;
    sm_l[grp] = l;
  }
  __syncthreads();
  if (warp == 0) {   // lane g: group g's weight exp(m_g - mb), by warp shuffles
    const float mg = lane < NG ? sm_m[lane] : -INFINITY;
    float mx = mg;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float wg = mg == -INFINITY ? 0.f : expf(mg - mx);
    float sl = lane < NG ? wg * sm_l[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sl += __shfl_xor_sync(0xffffffffu, sl, off);
    if (lane < NG) sm_w[lane] = wg;
    if (lane == 0) {
      sm_ml[0] = mx;
      sm_ml[1] = sl;
    }
  }
  __syncthreads();
  const float mb = sm_ml[0], lb = sm_ml[1];
  T* out = o + (long long)bh * d;
  if (!cluster) {   // one block: divide and round once
    const float inv = lb > 0.f ? 1.f / lb : 0.f;   // lb = 0: no key, output 0
    for (int e = tid; e < d; e += kRingThreads) {
      float sum = 0.f;
      for (int g = 0; g < NG; ++g) sum = fmaf(sm_w[g], sm_acc[g * cols + e], sum);
      store(out + e, sum * inv);
    }
    return;
  }
  // Block b of the cluster merges and writes columns [b slice, (b + 1) slice):
  // every block pushes its partial of those columns, and its m and l, into
  // block b's shared memory (distributed shared memory; a store does not wait
  // on the peer), then one cluster barrier.
  const int slice = (d + splits - 1) / splits;
  cluster_wait();   // every block of the cluster has started: its recv is there
  for (int e = tid; e < d; e += kRingThreads) {
    float sum = 0.f;
    for (int g = 0; g < NG; ++g) sum = fmaf(sm_w[g], sm_acc[g * cols + e], sum);
    const int b = e / slice;
    *rank_ptr(recv + rank * slice + (e - b * slice), b) = sum;
  }
  if (tid < splits) {
    float* ml = rank_ptr(recv_ml + 2 * rank, tid);
    ml[0] = mb;
    ml[1] = lb;
  }
  cluster_sync();   // every partial has reached its block

  float ws[kMaxSplits];
  float mc = -INFINITY, lc = 0.f;
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s)
    if (s < splits) mc = fmaxf(mc, recv_ml[2 * s]);
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s) {
    const float ms = s < splits ? recv_ml[2 * s] : -INFINITY;
    ws[s] = ms == -INFINITY ? 0.f : expf(ms - mc);
    if (s < splits) lc = fmaf(ws[s], recv_ml[2 * s + 1], lc);
  }
  const float inv = lc > 0.f ? 1.f / lc : 0.f;   // lc = 0: no key, output 0
  const int c0 = rank * slice, c1 = min(d, c0 + slice);
  for (int e = c0 + tid; e < c1; e += kRingThreads) {
    float sum = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s)
      if (s < splits) sum = fmaf(ws[s], recv[s * slice + e - c0], sum);
    store(out + e, sum * inv);
  }
}

template <typename T, int VEC, int P, int KG>
cudaError_t launch_ring_as(const WideGeometry& geo, const void* q, const void* k,
                           const void* v, const int* len, void* o, int bh, int h, int t,
                           int d, long long k_sb, long long k_st, long long v_sb,
                           long long v_st, int splits, float scale, cudaStream_t s) {
  static bool allowed[kMaxDevices];   // the most any head_dim needs, once a device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!allowed[dev]) {
    e = cudaFuncSetAttribute(decode_wide_ring_kernel<T, VEC, P, KG>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (e != cudaSuccess) return e;
    allowed[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(bh * splits), 1, 1);
  cfg.blockDim = dim3(kRingThreads, 1, 1);
  cfg.dynamicSmemBytes = geo.smem;
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = splits;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, decode_wide_ring_kernel<T, VEC, P, KG>,
                            static_cast<const T*>(q), static_cast<const T*>(k),
                            static_cast<const T*>(v), len, static_cast<T*>(o), h, t, d, k_sb,
                            k_st, v_sb, v_st, splits, scale, geo);
}

// The instance for the geometry's pieces a thread.
template <typename T, int VEC>
cudaError_t launch_ring(const void* q, const void* k, const void* v, const int* len,
                        void* o, int bh, int h, int t, int d, long long k_sb,
                        long long k_st, long long v_sb, long long v_st, int splits,
                        float scale, cudaStream_t s) {
  const WideGeometry geo = wide_geometry(d, sizeof(T), VEC > 1);
  if (geo.smem == 0) return cudaErrorInvalidValue;
#define DL4J_WIDE(p)                                                                    \
  if (geo.per == p)                                                                      \
    return geo.keys == 2                                                                 \
        ? launch_ring_as<T, VEC, p, 2>(geo, q, k, v, len, o, bh, h, t, d, k_sb, k_st,    \
                                       v_sb, v_st, splits, scale, s)                     \
        : launch_ring_as<T, VEC, p, 1>(geo, q, k, v, len, o, bh, h, t, d, k_sb, k_st,    \
                                       v_sb, v_st, splits, scale, s)
  if constexpr (VEC == 1) {
    DL4J_WIDE(8);
    DL4J_WIDE(16);
  } else if constexpr (sizeof(T) == 2) {
    DL4J_WIDE(2);
    DL4J_WIDE(3);
    DL4J_WIDE(4);
  } else {
    DL4J_WIDE(2);
    DL4J_WIDE(4);
    DL4J_WIDE(6);
    DL4J_WIDE(8);
  }
#undef DL4J_WIDE
  return cudaErrorInvalidValue;
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const int* len, void* o,
                   int b, int h, int t, int d, long long k_sb, long long k_st,
                   long long v_sb, long long v_st, int splits, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  // The 16-byte route (and its cp.async ring) needs every row piece 16-byte
  // aligned: d, the strides and the base pointers.
  const bool vec = d % kVec == 0 && k_sb % kVec == 0 && k_st % kVec == 0 &&
                   v_sb % kVec == 0 && v_st % kVec == 0 && aligned16(q) &&
                   aligned16(k) && aligned16(v);
  const float scale = 1.f / sqrtf((float)d);
  if (d > kMaxHeadDim)
    return vec ? launch_ring<T, kVec>(q, k, v, len, o, b * h, h, t, d, k_sb, k_st, v_sb,
                                      v_st, splits, scale, s)
               : launch_ring<T, 1>(q, k, v, len, o, b * h, h, t, d, k_sb, k_st, v_sb, v_st,
                                   splits, scale, s);
  const int pieces_d = vec ? d / kVec : d;
  int G = 1;
  while (G < pieces_d && G < 32) G <<= 1;
  const bool wide = (t + splits - 1) / splits >= kWideKeys;
  return vec ? launch_by_group<T, kVec>(G, wide, q, k, v, len, o, b * h, h, t, d, k_sb,
                                        k_st, v_sb, v_st, splits, scale, s)
             : launch_by_group<T, 1>(G, wide, q, k, v, len, o, b * h, h, t, d, k_sb,
                                     k_st, v_sb, v_st, splits, scale, s);
}

}  // namespace

// q, o: [b, 1, h, d] contiguous; k, v: [b, t, h, d] with batch strides k_sb,
// v_sb and key strides k_st, v_st in elements (heads contiguous, d apart);
// cache_len: [b] int32. splits: blocks a (row, head), 1..8, one cluster.
// 128 < d <= 4096 runs the wide arm (K7w). is_bf16: 0 for float32, 1 for
// bfloat16. One launch; returns its cudaError_t (a refused cluster launch
// included).
extern "C" int dl4j_decode_attention(const void* q, const void* k, const void* v,
                                     const void* cache_len, void* o, int b, int h,
                                     int t, int d, long long k_sb, long long k_st,
                                     long long v_sb, long long v_st, int splits,
                                     int is_bf16, void* stream) {
  if (b < 0 || h < 1 || t < 1 || d < 1 || splits < 1 || splits > kMaxSplits ||
      (long long)b * h * splits > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  if (b == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const int* len = static_cast<const int*>(cache_len);
  cudaError_t e = is_bf16 ? launch<bf16>(q, k, v, len, o, b, h, t, d, k_sb, k_st, v_sb,
                                         v_st, splits, s)
                          : launch<float>(q, k, v, len, o, b, h, t, d, k_sb, k_st, v_sb,
                                          v_st, splits, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// K7w's geometry at head_dim d, bfloat16 or float32, on the 16-byte route
// (vec 1) or the element route (vec 0), as the launch takes it: out[0..6] =
// threads a block, threads a key (a group), pieces a thread, keys a group a
// tile, keys a tile, ring stages, dynamic shared memory bytes. Returns 0,
// or cudaErrorInvalidValue where the wide arm does not take d.
extern "C" int dl4j_decode_wide_geometry(int d, int is_bf16, int vec, long long* out) {
  const WideGeometry g = wide_geometry(d, is_bf16 ? 2 : 4, vec != 0);
  const long long vals[7] = {kRingThreads, g.group, g.per, g.keys, g.tile, g.stages, g.smem};
  for (int x = 0; x < 7; ++x) out[x] = vals[x];
  return g.smem > 0 ? 0 : (int)cudaErrorInvalidValue;
}
