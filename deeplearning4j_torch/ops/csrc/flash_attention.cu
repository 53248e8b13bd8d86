// Flash attention, forward and backward, float32 or bfloat16 inputs with
// float32 accumulation, for Hopper.
//
// Forward (dl4j_flash_fwd, K3) replaces the TPU kernel
// deeplearning4j_tpu/ops/flash_attention.py:_fwd_kernel (driven by
// flash_attention -> _flash -> _fwd_call). For every (batch, head) and query
// row i it computes, over the key rows j that the masks allow,
//
//     s_ij = scale * q_i . k_j,   lse_i = log sum_j exp(s_ij),
//     o_i  = sum_j exp(s_ij - lse_i) v_j
//
// with o_i = 0 and lse_i = NEG (-1e30) for a row that no key may see.
// The backward replaces _bwd_dkv_kernel (dl4j_flash_bwd_dkv, K4) and
// _bwd_dq_kernel (dl4j_flash_bwd_dq, K5), driven by the custom VJP
// _flash_bwd -> _bwd_calls. From q, k, v, the output cotangent do, the saved
// lse, di_i = rowsum(o_i * do_i) and the lse cotangent g_i, both recompute
// p_ij = exp(s_ij - lse_i) and
//
//     ds_ij = p_ij (do_i . v_j - di_i + g_i)
//     dv_j = sum_i p_ij do_i,  dk_j = scale sum_i ds_ij q_i   (K4)
//     dq_i = scale sum_j ds_ij k_j                             (K5)
//
// Masks compose by conjunction: causal (kv_pos[j] <= q_pos[i], positions
// compared as data), a key mask (km[b, j] > 0, shared by the heads) and
// segment ids (qs[b, i] == ks[b, j]). As in the TPU kernels, in bfloat16 p is
// rounded to the input type before the p.v product (K3) and p and ds before
// the dv and dk/dq products (K4, K5); every sum is float32.
//
// Layout: q, o, dq are [b, tq, h, d] and k, v, dk, dv [b, tk, h, d], the
// public layout of flash_attention, read in place (a row of d elements is
// contiguous, the next row of the same head is h * d further); lse, di and g
// are [b, tq, h] float32.
//
// Bound: operations. Per allowed (i, j) pair K3 does 4d flops (two dot
// products of length d), K4 8d (s, do.v, and the dv and dk updates) and K5 6d.
// At the char model's shape (b 4, h 4, d 128, t 8192, causal) K3 does
// 2.75e11 flops against 0.27 GB of float32 inputs and outputs: some 1,000
// flops per byte, far above the card's 20 float32 flops per byte of HBM
// bandwidth (67 TFLOP/s over 3.35 TB/s).
//
// Design, kept simple (CUDA cores, no tensor cores; wgmma and TMA are later
// work): one block of 256 threads per (batch * head, 64-row tile). K3 and K5
// hold a query tile and loop over the key tiles (the TPU's sequential grid
// axis becomes that loop); K4 holds a key tile and loops over the query tiles.
// Splitting dk/dv from dq keeps every output owned by one block: no atomics,
// and the results do not depend on the order blocks run in. Tiles are staged
// in shared memory as float32 with an odd row stride (d | 1), so the 16
// threads that read 16 different rows of a tile hit 16 different banks.
// Thread (ty, tx) = (tid / 16, tid % 16) owns tile rows 4ty..4ty+3; in a
// 64 x 64 score tile it holds columns tx + 16j (j < 4), in a 64 x d output
// tile columns tx + 16m (m < d/16). A row's 16 threads are one half-warp, so
// the row max and sum of the online softmax are warp shuffles. Each score
// tile goes through shared memory once, as p or ds, for the second product.
// Unlike the TPU kernels, head_dim is not padded to 128 lanes (d = 8 stages 8
// columns, not 128) and the time axes need no exact tiling: rows and columns
// past t are masked in the kernel. A whole tile is skipped, for every thread
// of the block alike, when min(kv_pos) > max(q_pos) over its rows (causal) or
// when its query and key segment-id ranges cannot meet (the TPU's _skip_when,
// with the minimum and maximum taken over the tile's data). Dynamic shared
// memory at d = 128 is 83,456 bytes (K3, two blocks per SM), 149,504 (K5)
// and 166,656 (K4), set with cudaFuncSetAttribute before each launch.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;       // query rows or key rows per tile
constexpr int kThreads = 256;   // 16 x 16
constexpr int kMaxHeadDim = 128;
constexpr int kPs = kTile + 1;  // row stride of a score tile in shared memory
constexpr float kNeg = -1e30f;  // the mask sentinel (finite: -inf NaNs grads)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and back: what the TPU kernel's .astype(v.dtype) does
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

struct Attn {
  const void* q;
  const void* k;
  const void* v;
  const float* km;  // [b, tk] key mask, or null
  const int* qs;    // [b, tq] query segment ids, or null (then ks is null)
  const int* ks;    // [b, tk] key segment ids
  const int* qp;    // [tq] query positions
  const int* kp;    // [tk] key positions
  int b, h, tq, tk, d;
  float scale;
  int causal;
};

__device__ __forceinline__ long long row_offset(int bi, int hi, int row, int t,
                                                int h, int d) {
  return ((long long)bi * t + row) * h * d + (long long)hi * d;
}

// dst[r * ld + c] = src(head (bi, hi), row row0 + r, column c) as float32,
// for r < kTile and c < d; rows past t are zero.
template <typename T>
__device__ void load_tile(float* dst, int ld, const T* src, int bi, int hi,
                          int row0, int t, int h, int d) {
  for (int i = threadIdx.x; i < kTile * d; i += kThreads) {
    const int r = i / d, c = i - r * d, row = row0 + r;
    dst[r * ld + c] =
        row < t ? to_f(src[row_offset(bi, hi, row, t, h, d) + c]) : 0.f;
  }
}

// Minimum and maximum of a[i0 .. i0 + kTile) within [0, n), in every lane.
__device__ void warp_range(const int* a, int i0, int n, int& lo, int& hi) {
  lo = INT_MAX;
  hi = INT_MIN;
  for (int i = (threadIdx.x & 31); i < kTile; i += 32) {
    if (i0 + i < n) {
      lo = min(lo, a[i0 + i]);
      hi = max(hi, a[i0 + i]);
    }
  }
  for (int off = 16; off; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
}

// False when no pair of the query tile at q0 and the key tile at k0 can be
// allowed. Every warp computes the same answer from the same data, so the
// whole block skips together.
__device__ bool tile_live(const Attn& a, int bi, int q0, int k0) {
  int qlo, qhi, klo, khi;
  if (a.causal) {
    warp_range(a.qp, q0, a.tq, qlo, qhi);
    warp_range(a.kp, k0, a.tk, klo, khi);
    if (klo > qhi) return false;
  }
  if (a.qs) {
    warp_range(a.qs + (long long)bi * a.tq, q0, a.tq, qlo, qhi);
    warp_range(a.ks + (long long)bi * a.tk, k0, a.tk, klo, khi);
    if (klo > qhi || khi < qlo) return false;
  }
  return true;
}

// What the mask needs of one row or column: its position, its segment id, and
// whether it exists (and, for a key, whether the key mask lets it be seen).
struct Info {
  int pos, seg, ok;
};

__device__ __forceinline__ Info query_info(const Attn& a, int bi, int row) {
  const bool in = row < a.tq;
  return {in ? a.qp[row] : 0, (in && a.qs) ? a.qs[(long long)bi * a.tq + row] : 0,
          in};
}

__device__ __forceinline__ Info key_info(const Attn& a, int bi, int col) {
  const bool in = col < a.tk;
  const long long at = (long long)bi * a.tk + col;
  return {in ? a.kp[col] : 0, (in && a.qs) ? a.ks[at] : 0,
          in && (!a.km || a.km[at] > 0.f)};
}

__device__ __forceinline__ bool allowed(const Attn& a, const Info& q,
                                        const Info& k) {
  return q.ok && k.ok && (!a.causal || k.pos <= q.pos) &&
         (!a.qs || q.seg == k.seg);
}

// info[i] = key_info (or query_info) of row0 + i, for i < kTile
__device__ void load_info(Info* info, const Attn& a, int bi, int row0,
                          bool keys) {
  for (int i = threadIdx.x; i < kTile; i += kThreads)
    info[i] = keys ? key_info(a, bi, row0 + i) : query_info(a, bi, row0 + i);
}

__device__ __forceinline__ float half_warp_max(float x) {
  for (int off = 8; off; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
  for (int off = 8; off; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__host__ __device__ constexpr int row_stride(int d) { return d | 1; }

// ---------------------------------------------------------------- K3: forward

size_t fwd_smem(int d) {
  return (2 * kTile * row_stride(d) + kTile * kPs) * sizeof(float) +
         kTile * sizeof(Info);
}

template <typename T, int DPT>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(Attn a, T* __restrict__ o, float* __restrict__ lse) {
  extern __shared__ float smem[];
  const int ld = row_stride(a.d);
  float* qt = smem;             // [kTile][ld] this block's queries
  float* kv = qt + kTile * ld;  // [kTile][ld] a key tile, then its value tile
  float* pt = kv + kTile * ld;  // [kTile][kPs] p of the tile
  Info* kinfo = reinterpret_cast<Info*>(pt + kTile * kPs);
  const T* Q = static_cast<const T*>(a.q);
  const T* K = static_cast<const T*>(a.k);
  const T* V = static_cast<const T*>(a.v);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int bi = blockIdx.y / a.h, hi = blockIdx.y - bi * a.h;
  const int q0 = blockIdx.x * kTile;

  load_tile(qt, ld, Q, bi, hi, q0, a.tq, a.h, a.d);
  Info qi[4];
  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    qi[i] = query_info(a, bi, q0 + 4 * ty + i);
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < DPT; ++n) acc[i][n] = 0.f;
  }

  for (int k0 = 0; k0 < a.tk; k0 += kTile) {
    if (!tile_live(a, bi, q0, k0)) continue;
    __syncthreads();  // the previous tile's v and p are no longer read
    load_tile(kv, ld, K, bi, hi, k0, a.tk, a.h, a.d);
    load_info(kinfo, a, bi, k0, true);
    __syncthreads();
    float s[4][4] = {};
    for (int c = 0; c < a.d; ++c) {
      float qv[4], kc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qt[(4 * ty + i) * ld + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kc[j] = kv[(tx + 16 * j) * ld + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kc[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mt = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = allowed(a, qi[i], kinfo[tx + 16 * j]) ? s[i][j] * a.scale : kNeg;
        mt = fmaxf(mt, s[i][j]);
      }
      const float mn = fmaxf(m[i], half_warp_max(mt));
      const float alpha = expf(m[i] - mn);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // a row with nothing allowed so far keeps p = 0 (exp(0) would be 1)
        const float p = mn <= kNeg / 2 ? 0.f : expf(s[i][j] - mn);
        rs += p;
        pt[(4 * ty + i) * kPs + tx + 16 * j] = round_to<T>(p);
      }
      l[i] = alpha * l[i] + half_warp_sum(rs);
      m[i] = mn;
#pragma unroll
      for (int n = 0; n < DPT; ++n) acc[i][n] *= alpha;
    }
    __syncthreads();  // every score of the key tile is taken
    load_tile(kv, ld, V, bi, hi, k0, a.tk, a.h, a.d);
    __syncthreads();
    for (int c = 0; c < kTile; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = pt[(4 * ty + i) * kPs + c];
#pragma unroll
      for (int n = 0; n < DPT; ++n) {
        const int col = tx + 16 * n;
        if (col < a.d) {
          const float vv = kv[c * ld + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][n] = fmaf(p[i], vv, acc[i][n]);
        }
      }
    }
  }

  T* O = o;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= a.tq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    const long long at = row_offset(bi, hi, row, a.tq, a.h, a.d);
#pragma unroll
    for (int n = 0; n < DPT; ++n) {
      const int col = tx + 16 * n;
      if (col < a.d) O[at + col] = from_f<T>(acc[i][n] * inv);
    }
    if (tx == 0)
      lse[((long long)bi * a.tq + row) * a.h + hi] =
          l[i] > 0.f ? m[i] + logf(l[i]) : kNeg;
  }
}

// ------------------------------------------------------------ K5: dq backward

struct Bwd {
  const void* dout;   // [b, tq, h, d], the input type
  const float* lse;   // [b, tq, h]
  const float* di;    // [b, tq, h]
  const float* gl;    // [b, tq, h]
};

size_t dq_smem(int d) {
  return (4 * kTile * row_stride(d) + kTile * kPs) * sizeof(float) +
         kTile * sizeof(Info);
}

template <typename T, int DPT>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(Attn a, Bwd g, T* __restrict__ dq) {
  extern __shared__ float smem[];
  const int ld = row_stride(a.d);
  float* qt = smem;               // [kTile][ld] queries
  float* dot = qt + kTile * ld;   // [kTile][ld] output cotangents
  float* kt = dot + kTile * ld;   // [kTile][ld] a key tile
  float* vt = kt + kTile * ld;    // [kTile][ld] its values
  float* dst = vt + kTile * ld;   // [kTile][kPs] ds of the tile
  Info* kinfo = reinterpret_cast<Info*>(dst + kTile * kPs);
  const T* K = static_cast<const T*>(a.k);
  const T* V = static_cast<const T*>(a.v);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int bi = blockIdx.y / a.h, hi = blockIdx.y - bi * a.h;
  const int q0 = blockIdx.x * kTile;

  load_tile(qt, ld, static_cast<const T*>(a.q), bi, hi, q0, a.tq, a.h, a.d);
  load_tile(dot, ld, static_cast<const T*>(g.dout), bi, hi, q0, a.tq, a.h, a.d);
  Info qi[4];
  float lse[4], dg[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    qi[i] = query_info(a, bi, row);
    const long long at = ((long long)bi * a.tq + row) * a.h + hi;
    lse[i] = qi[i].ok ? g.lse[at] : kNeg;
    dg[i] = qi[i].ok ? g.gl[at] - g.di[at] : 0.f;  // ds = p (dp - di + g)
#pragma unroll
    for (int n = 0; n < DPT; ++n) acc[i][n] = 0.f;
  }

  for (int k0 = 0; k0 < a.tk; k0 += kTile) {
    if (!tile_live(a, bi, q0, k0)) continue;
    __syncthreads();
    load_tile(kt, ld, K, bi, hi, k0, a.tk, a.h, a.d);
    load_tile(vt, ld, V, bi, hi, k0, a.tk, a.h, a.d);
    load_info(kinfo, a, bi, k0, true);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    for (int c = 0; c < a.d; ++c) {
      float qv[4], gv[4], kc[4], vc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = qt[(4 * ty + i) * ld + c];
        gv[i] = dot[(4 * ty + i) * ld + c];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kc[j] = kt[(tx + 16 * j) * ld + c];
        vc[j] = vt[(tx + 16 * j) * ld + c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kc[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vc[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = allowed(a, qi[i], kinfo[tx + 16 * j]) && lse[i] > kNeg / 2;
        const float p = ok ? expf(s[i][j] * a.scale - lse[i]) : 0.f;
        dst[(4 * ty + i) * kPs + tx + 16 * j] = round_to<T>(p * (dp[i][j] + dg[i]));
      }
    __syncthreads();
    for (int c = 0; c < kTile; ++c) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dst[(4 * ty + i) * kPs + c];
#pragma unroll
      for (int n = 0; n < DPT; ++n) {
        const int col = tx + 16 * n;
        if (col < a.d) {
          const float kk = kt[c * ld + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][n] = fmaf(ds[i], kk, acc[i][n]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= a.tq) continue;
    const long long at = row_offset(bi, hi, row, a.tq, a.h, a.d);
#pragma unroll
    for (int n = 0; n < DPT; ++n) {
      const int col = tx + 16 * n;
      if (col < a.d) dq[at + col] = from_f<T>(acc[i][n] * a.scale);
    }
  }
}

// ---------------------------------------------------------- K4: dk, dv backward

size_t dkv_smem(int d) {
  return (4 * kTile * row_stride(d) + 2 * kTile * kPs + 2 * kTile) * sizeof(float) +
         kTile * sizeof(Info);
}

template <typename T, int DPT>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(Attn a, Bwd g, T* __restrict__ dk, T* __restrict__ dv) {
  extern __shared__ float smem[];
  const int ld = row_stride(a.d);
  float* kt = smem;                // [kTile][ld] this block's keys
  float* vt = kt + kTile * ld;     // [kTile][ld] and values
  float* qt = vt + kTile * ld;     // [kTile][ld] a query tile
  float* dot = qt + kTile * ld;    // [kTile][ld] its output cotangents
  float* ptt = dot + kTile * ld;   // [kTile][kPs] p transposed (key row, query col)
  float* dstt = ptt + kTile * kPs; // [kTile][kPs] ds transposed
  float* qlse = dstt + kTile * kPs;  // [kTile] lse of the query tile
  float* qdg = qlse + kTile;         // [kTile] g - di of the query tile
  Info* qinfo = reinterpret_cast<Info*>(qdg + kTile);
  const T* Q = static_cast<const T*>(a.q);
  const T* DO = static_cast<const T*>(g.dout);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int bi = blockIdx.y / a.h, hi = blockIdx.y - bi * a.h;
  const int k0 = blockIdx.x * kTile;

  load_tile(kt, ld, static_cast<const T*>(a.k), bi, hi, k0, a.tk, a.h, a.d);
  load_tile(vt, ld, static_cast<const T*>(a.v), bi, hi, k0, a.tk, a.h, a.d);
  Info ki[4];
  float dka[4][DPT], dva[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ki[i] = key_info(a, bi, k0 + 4 * ty + i);
#pragma unroll
    for (int n = 0; n < DPT; ++n) dka[i][n] = dva[i][n] = 0.f;
  }

  for (int q0 = 0; q0 < a.tq; q0 += kTile) {
    if (!tile_live(a, bi, q0, k0)) continue;
    __syncthreads();  // the previous query tile, p and ds are no longer read
    load_tile(qt, ld, Q, bi, hi, q0, a.tq, a.h, a.d);
    load_tile(dot, ld, DO, bi, hi, q0, a.tq, a.h, a.d);
    load_info(qinfo, a, bi, q0, false);
    for (int r = threadIdx.x; r < kTile; r += kThreads) {
      const int row = q0 + r;
      const long long at = ((long long)bi * a.tq + row) * a.h + hi;
      qlse[r] = row < a.tq ? g.lse[at] : kNeg;
      qdg[r] = row < a.tq ? g.gl[at] - g.di[at] : 0.f;
    }
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};  // [key row i][query col j]
    for (int c = 0; c < a.d; ++c) {
      float kc[4], vc[4], qv[4], gv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kc[i] = kt[(4 * ty + i) * ld + c];
        vc[i] = vt[(4 * ty + i) * ld + c];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = qt[(tx + 16 * j) * ld + c];
        gv[j] = dot[(tx + 16 * j) * ld + c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(kc[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vc[i], gv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        const float lse = qlse[col];
        const bool ok = allowed(a, qinfo[col], ki[i]) && lse > kNeg / 2;
        const float p = ok ? expf(s[i][j] * a.scale - lse) : 0.f;
        ptt[(4 * ty + i) * kPs + col] = round_to<T>(p);
        dstt[(4 * ty + i) * kPs + col] = round_to<T>(p * (dp[i][j] + qdg[col]));
      }
    __syncthreads();
    for (int r = 0; r < kTile; ++r) {
      float p[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = ptt[(4 * ty + i) * kPs + r];
        ds[i] = dstt[(4 * ty + i) * kPs + r];
      }
#pragma unroll
      for (int n = 0; n < DPT; ++n) {
        const int col = tx + 16 * n;
        if (col < a.d) {
          const float dov = dot[r * ld + col], qv = qt[r * ld + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dva[i][n] = fmaf(p[i], dov, dva[i][n]);
            dka[i][n] = fmaf(ds[i], qv, dka[i][n]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + 4 * ty + i;
    if (row >= a.tk) continue;
    const long long at = row_offset(bi, hi, row, a.tk, a.h, a.d);
#pragma unroll
    for (int n = 0; n < DPT; ++n) {
      const int col = tx + 16 * n;
      if (col < a.d) {
        dk[at + col] = from_f<T>(dka[i][n] * a.scale);
        dv[at + col] = from_f<T>(dva[i][n]);
      }
    }
  }
}

// ------------------------------------------------------------------ launching

int dpt_for(int d) { return d <= 16 ? 1 : d <= 32 ? 2 : d <= 64 ? 4 : 8; }

bool valid(const Attn& a) {
  return a.q && a.k && a.v && a.qp && a.kp && (!a.qs == !a.ks) && a.b >= 1 &&
         a.h >= 1 && a.tq >= 1 && a.tk >= 1 && a.d >= 1 &&
         a.d <= kMaxHeadDim && (long long)a.b * a.h <= 65535;
}

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

dim3 grid_for(int t, const Attn& a) {
  return dim3((t + kTile - 1) / kTile, a.b * a.h);
}

template <typename T, int DPT>
cudaError_t fwd(const Attn& a, void* o, float* lse, cudaStream_t s) {
  const size_t smem = fwd_smem(a.d);
  cudaError_t e = prepare(flash_fwd_kernel<T, DPT>, smem);
  if (e != cudaSuccess) return e;
  flash_fwd_kernel<T, DPT><<<grid_for(a.tq, a), kThreads, smem, s>>>(
      a, static_cast<T*>(o), lse);
  return cudaGetLastError();
}

template <typename T, int DPT>
cudaError_t bwd_dq(const Attn& a, const Bwd& g, void* dq, cudaStream_t s) {
  const size_t smem = dq_smem(a.d);
  cudaError_t e = prepare(flash_bwd_dq_kernel<T, DPT>, smem);
  if (e != cudaSuccess) return e;
  flash_bwd_dq_kernel<T, DPT><<<grid_for(a.tq, a), kThreads, smem, s>>>(
      a, g, static_cast<T*>(dq));
  return cudaGetLastError();
}

template <typename T, int DPT>
cudaError_t bwd_dkv(const Attn& a, const Bwd& g, void* dk, void* dv,
                    cudaStream_t s) {
  const size_t smem = dkv_smem(a.d);
  cudaError_t e = prepare(flash_bwd_dkv_kernel<T, DPT>, smem);
  if (e != cudaSuccess) return e;
  flash_bwd_dkv_kernel<T, DPT><<<grid_for(a.tk, a), kThreads, smem, s>>>(
      a, g, static_cast<T*>(dk), static_cast<T*>(dv));
  return cudaGetLastError();
}

// One call of `Fn<T, DPT>::run(args...)` for the input type and head_dim.
template <template <typename, int> class Fn, typename... Args>
cudaError_t dispatch(int bf16, int d, Args... args) {
  const int dpt = dpt_for(d);
  const int width = dpt == 1 ? 0 : dpt == 2 ? 1 : dpt == 4 ? 2 : 3;
  switch ((bf16 ? 4 : 0) + width) {
    case 0: return Fn<float, 1>::run(args...);
    case 1: return Fn<float, 2>::run(args...);
    case 2: return Fn<float, 4>::run(args...);
    case 3: return Fn<float, 8>::run(args...);
    case 4: return Fn<__nv_bfloat16, 1>::run(args...);
    case 5: return Fn<__nv_bfloat16, 2>::run(args...);
    case 6: return Fn<__nv_bfloat16, 4>::run(args...);
    default: return Fn<__nv_bfloat16, 8>::run(args...);
  }
}

template <typename T, int DPT> struct Fwd {
  static cudaError_t run(Attn a, void* o, float* lse, cudaStream_t s) {
    return fwd<T, DPT>(a, o, lse, s);
  }
};
template <typename T, int DPT> struct Dq {
  static cudaError_t run(Attn a, Bwd g, void* dq, cudaStream_t s) {
    return bwd_dq<T, DPT>(a, g, dq, s);
  }
};
template <typename T, int DPT> struct Dkv {
  static cudaError_t run(Attn a, Bwd g, void* dk, void* dv, cudaStream_t s) {
    return bwd_dkv<T, DPT>(a, g, dk, dv, s);
  }
};

Attn make_attn(const void* q, const void* k, const void* v, const void* km,
               const void* qs, const void* ks, const void* qp, const void* kp,
               int b, int h, int tq, int tk, int d, float scale, int causal) {
  return {q, k, v, static_cast<const float*>(km), static_cast<const int*>(qs),
          static_cast<const int*>(ks), static_cast<const int*>(qp),
          static_cast<const int*>(kp), b, h, tq, tk, d, scale, causal};
}

}  // namespace

extern "C" int dl4j_flash_fwd(const void* q, const void* k, const void* v,
                              const void* km, const void* qs, const void* ks,
                              const void* qp, const void* kp, void* o, void* lse,
                              int b, int h, int tq, int tk, int d, float scale,
                              int causal, int bf16, void* stream) {
  const Attn a = make_attn(q, k, v, km, qs, ks, qp, kp, b, h, tq, tk, d, scale,
                           causal);
  if (!valid(a) || !o || !lse) return (int)cudaErrorInvalidValue;
  return (int)dispatch<Fwd>(bf16, d, a, o, static_cast<float*>(lse),
                            (cudaStream_t)stream);
}

extern "C" int dl4j_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* di, const void* gl, const void* km,
                                  const void* qs, const void* ks, const void* qp,
                                  const void* kp, void* dk, void* dv, int b,
                                  int h, int tq, int tk, int d, float scale,
                                  int causal, int bf16, void* stream) {
  const Attn a = make_attn(q, k, v, km, qs, ks, qp, kp, b, h, tq, tk, d, scale,
                           causal);
  const Bwd g = {dout, static_cast<const float*>(lse),
                 static_cast<const float*>(di), static_cast<const float*>(gl)};
  if (!valid(a) || !dout || !lse || !di || !gl || !dk || !dv)
    return (int)cudaErrorInvalidValue;
  return (int)dispatch<Dkv>(bf16, d, a, g, dk, dv, (cudaStream_t)stream);
}

extern "C" int dl4j_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* di, const void* gl, const void* km,
                                 const void* qs, const void* ks, const void* qp,
                                 const void* kp, void* dq, int b, int h, int tq,
                                 int tk, int d, float scale, int causal,
                                 int bf16, void* stream) {
  const Attn a = make_attn(q, k, v, km, qs, ks, qp, kp, b, h, tq, tk, d, scale,
                           causal);
  const Bwd g = {dout, static_cast<const float*>(lse),
                 static_cast<const float*>(di), static_cast<const float*>(gl)};
  if (!valid(a) || !dout || !lse || !di || !gl || !dq)
    return (int)cudaErrorInvalidValue;
  return (int)dispatch<Dq>(bf16, d, a, g, dq, (cudaStream_t)stream);
}
