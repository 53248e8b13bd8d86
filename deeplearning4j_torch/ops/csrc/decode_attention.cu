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
// memory's rate, from enough blocks to fill the card.
//
// Design: split-KV ("flash-decoding"), two launches.
// * Partial pass, grid (b * h, splits): block (bh, s) takes keys
//   [s * chunk, min((s + 1) * chunk, n_i)) and returns at once when that
//   range is empty. Its 4 warps are cut into lane groups of G lanes (G the
//   power of two that covers d in 16-byte pieces: 8 lanes for d 32 in
//   float32, 32 for d 128; one element a lane where d or the strides are not
//   whole 16-byte pieces). A group takes one key at a time, kUnroll keys in
//   flight: each lane loads its 16 bytes of k and of v, the dot product is
//   summed across the group by butterfly shuffles (every lane gets the same
//   sum), and the group keeps a running max m, sum l and a d-wide
//   accumulator in float32 registers (online softmax). The block then
//   merges its groups through shared memory by their maxima and writes one
//   partial (m, l, acc[d]) to a float32 scratch.
// * Combine pass, grid (b * h): merges the ceil(n_i / chunk) partials of
//   the row by their maxima, divides by the merged sum, and rounds once to
//   the output type.
// The wrapper (ops/flash_attention.py) picks the split count from the bucket
// length and the SM count (it cannot read cache_len without a sync) and
// allocates the scratch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxHeadDim = 128;
constexpr int kUnroll = 4;   // keys a lane group has in flight
constexpr int kCombineThreads = 128;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// VEC consecutive elements at p into f[0, VEC), as float: one 16-byte load
// (4 float32 or 8 bfloat16) or, for VEC 1, one element.
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

// Pieces of VEC elements a lane holds: a group of 32 lanes covers d = 128 at
// one element a lane in 4 pieces; every other group covers d in one.
template <int VEC, int G>
__host__ __device__ constexpr int pieces() { return G == 32 ? (kMaxHeadDim / VEC + 31) / 32 : 1; }

template <typename T, int VEC, int G>
__global__ void __launch_bounds__(kThreads)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ cache_len,
                      float* __restrict__ part_acc, float* __restrict__ part_ml,
                      int h, int t, int d, long long k_sb, long long k_st,
                      long long v_sb, long long v_st, int chunk, float scale) {
  constexpr int P = pieces<VEC, G>();
  constexpr int E = P * VEC;            // elements of a row a lane holds
  constexpr int NG = kWarps * (32 / G);  // lane groups a block
  constexpr int STRIDE = E * G;          // a group's row in shared memory (>= d)
  __shared__ float sm_acc[NG * STRIDE];
  __shared__ float sm_m[NG], sm_l[NG], sm_w[NG];

  const int bh = blockIdx.x, split = blockIdx.y;
  const int i = bh / h, hh = bh - i * h;
  const int n = min(cache_len[i], t);
  const int lo = split * chunk;
  if (lo >= n) return;   // the whole chunk lies past the valid prefix
  const int hi = min(lo + chunk, n);
  const int lane = threadIdx.x & 31;
  const int r = lane & (G - 1);                        // lane within its group
  const int grp = (threadIdx.x >> 5) * (32 / G) + lane / G;
  const int pieces_d = (d + VEC - 1) / VEC;

  float qf[E];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int piece = p * G + r;
    if (piece < pieces_d) {
      load<T, VEC>(q + (long long)bh * d + piece * VEC, qf + p * VEC);
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

  // Warp-uniform trip count: every lane runs every iteration (the shuffles
  // need the whole warp); a group whose key lies past hi loads nothing.
  for (int base = lo; base < hi; base += NG * kUnroll) {
    float kf[kUnroll][E], vf[kUnroll][E];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * NG + grp;
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
    float s[kUnroll];
    float m_new = m;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) dot = fmaf(qf[e], kf[u][e], dot);
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      const bool valid = base + u * NG + grp < hi;
      s[u] = valid ? dot : -INFINITY;
      m_new = fmaxf(m_new, s[u]);
    }
    if (m_new == -INFINITY) continue;   // no key of this group yet
    const float corr = expf(m - m_new);  // 0 on the group's first key
    l *= corr;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] *= corr;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float p = expf(s[u] - m_new);   // 0 for a key past hi
      l += p;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = fmaf(p, vf[u][e], acc[e]);
    }
    m = m_new;
  }

  // Merge the block's groups by their maxima.
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
  for (int g = 0; g < NG; ++g) mb = fmaxf(mb, sm_m[g]);   // finite: lo < n
  if (threadIdx.x < NG) {
    const float mg = sm_m[threadIdx.x];
    sm_w[threadIdx.x] = mg == -INFINITY ? 0.f : expf(mg - mb);
  }
  __syncthreads();
  const long long slot = (long long)bh * gridDim.y + split;
  for (int e = threadIdx.x; e < d; e += kThreads) {
    float sum = 0.f;
    for (int g = 0; g < NG; ++g) sum = fmaf(sm_w[g], sm_acc[g * STRIDE + e], sum);
    part_acc[slot * d + e] = sum;
  }
  if (threadIdx.x == 0) {
    float lb = 0.f;
    for (int g = 0; g < NG; ++g) lb = fmaf(sm_w[g], sm_l[g], lb);
    part_ml[2 * slot] = mb;
    part_ml[2 * slot + 1] = lb;
  }
}

template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
decode_combine_kernel(const float* __restrict__ part_acc,
                      const float* __restrict__ part_ml,
                      const int* __restrict__ cache_len, T* __restrict__ o,
                      int h, int t, int d, int splits, int chunk) {
  const int bh = blockIdx.x;
  const int n = min(cache_len[bh / h], t);
  T* out = o + (long long)bh * d;
  if (n <= 0) {   // no key to see: 0, as a fully masked flash row
    for (int e = threadIdx.x; e < d; e += kCombineThreads) store(out + e, 0.f);
    return;
  }
  const int used = (n + chunk - 1) / chunk;   // partials the first pass wrote
  const float* ml = part_ml + 2LL * bh * splits;
  float mb = -INFINITY;
  for (int s = 0; s < used; ++s) mb = fmaxf(mb, ml[2 * s]);
  float lb = 0.f;
  for (int s = 0; s < used; ++s) lb = fmaf(expf(ml[2 * s] - mb), ml[2 * s + 1], lb);
  const float inv = 1.f / lb;
  const float* acc = part_acc + (long long)bh * splits * d;
  for (int e = threadIdx.x; e < d; e += kCombineThreads) {
    float sum = 0.f;
    for (int s = 0; s < used; ++s) sum = fmaf(expf(ml[2 * s] - mb), acc[(long long)s * d + e], sum);
    store(out + e, sum * inv);
  }
}

template <typename T, int VEC, int G>
void launch_partial(dim3 grid, cudaStream_t s, const void* q, const void* k,
                    const void* v, const int* len, float* pacc, float* pml,
                    int h, int t, int d, long long k_sb, long long k_st,
                    long long v_sb, long long v_st, int chunk, float scale) {
  decode_partial_kernel<T, VEC, G><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      len, pacc, pml, h, t, d, k_sb, k_st, v_sb, v_st, chunk, scale);
}

template <typename T, int VEC>
void partial_by_group(int G, dim3 grid, cudaStream_t s, const void* q,
                      const void* k, const void* v, const int* len, float* pacc,
                      float* pml, int h, int t, int d, long long k_sb,
                      long long k_st, long long v_sb, long long v_st, int chunk,
                      float scale) {
#define DL4J_PARTIAL(g)                                                        \
  launch_partial<T, VEC, g>(grid, s, q, k, v, len, pacc, pml, h, t, d, k_sb,   \
                            k_st, v_sb, v_st, chunk, scale)
  switch (G) {
    case 1: DL4J_PARTIAL(1); break;
    case 2: DL4J_PARTIAL(2); break;
    case 4: DL4J_PARTIAL(4); break;
    case 8: DL4J_PARTIAL(8); break;
    case 16: DL4J_PARTIAL(16); break;
    default: DL4J_PARTIAL(32); break;
  }
#undef DL4J_PARTIAL
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* len, void* o,
           float* pacc, float* pml, int b, int h, int t, int d, long long k_sb,
           long long k_st, long long v_sb, long long v_st, int splits,
           cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = d % kVec == 0 && k_sb % kVec == 0 && k_st % kVec == 0 &&
                   v_sb % kVec == 0 && v_st % kVec == 0 && aligned16(q) &&
                   aligned16(k) && aligned16(v);
  const int pieces_d = vec ? d / kVec : d;
  int G = 1;
  while (G < pieces_d && G < 32) G <<= 1;
  const int chunk = (t + splits - 1) / splits;
  const float scale = 1.f / sqrtf((float)d);
  const dim3 grid(b * h, splits);
  if (vec)
    partial_by_group<T, kVec>(G, grid, s, q, k, v, len, pacc, pml, h, t, d,
                              k_sb, k_st, v_sb, v_st, chunk, scale);
  else
    partial_by_group<T, 1>(G, grid, s, q, k, v, len, pacc, pml, h, t, d, k_sb,
                           k_st, v_sb, v_st, chunk, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  decode_combine_kernel<T><<<b * h, kCombineThreads, 0, s>>>(
      pacc, pml, len, static_cast<T*>(o), h, t, d, splits, chunk);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o: [b, 1, h, d] contiguous; k, v: [b, t, h, d] with batch strides k_sb,
// v_sb and key strides k_st, v_st in elements (heads contiguous, d apart);
// cache_len: [b] int32; part_acc: [b * h * splits * d] float32 and part_ml:
// [b * h * splits * 2] float32 scratch. is_bf16: 0 for float32, 1 for
// bfloat16. Returns a cudaError_t.
extern "C" int dl4j_decode_attention(const void* q, const void* k, const void* v,
                                     const void* cache_len, void* o,
                                     void* part_acc, void* part_ml, int b, int h,
                                     int t, int d, long long k_sb, long long k_st,
                                     long long v_sb, long long v_st, int splits,
                                     int is_bf16, void* stream) {
  if (b < 0 || h < 1 || t < 1 || d < 1 || d > kMaxHeadDim || splits < 1 ||
      splits > t || (long long)b * h > 2147483647LL || splits > 65535)
    return (int)cudaErrorInvalidValue;
  if (b == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const int* len = static_cast<const int*>(cache_len);
  float* pacc = static_cast<float*>(part_acc);
  float* pml = static_cast<float*>(part_ml);
  return is_bf16 ? launch<bf16>(q, k, v, len, o, pacc, pml, b, h, t, d, k_sb, k_st,
                                v_sb, v_st, splits, s)
                 : launch<float>(q, k, v, len, o, pacc, pml, b, h, t, d, k_sb, k_st,
                                 v_sb, v_st, splits, s);
}
