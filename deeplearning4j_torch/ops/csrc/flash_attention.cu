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
// flops per byte, far above the card's 49 flops per byte at its float32-
// accurate tensor-core rate (495 TFLOP/s TF32 / 3, over 3.35 TB/s).
//
// K3's design: tensor cores, warp-level `mma.sync`. One block of 4 warps
// per (64-row query tile, batch * head); each warp owns 16 query rows and
// loops over the key tiles (64 keys in bfloat16, 32 in float32). S = Q K^T
// and O += P V run as m16n8k16 bf16 products for bfloat16 and as m16n8k8
// tf32 products for float32, the latter with the 3xTF32 split (x = big +
// small, big = x rounded to TF32 to nearest with ties away, small = x - big
// read as TF32; a b ~ a_s b_b + a_b b_s + a_b b_b, small terms first, a_s b_s
// dropped), which keeps float32 accuracy (within 2^-21 of each product) at a
// third of the TF32 rate; a split is three operations (see `split`). The
// tensor cores' float32 sums drop low bits rather than round, so in float32
// each tile's P V starts from zero and joins O with a rounded add (one run
// over 8192 keys drifted several times further from the plain version).
// The online softmax runs on the accumulator fragments, in log2 units
// (exp2): a thread holds rows lane/4 and lane/4 + 8 and columns
// 2 (lane % 4) + {0, 1} of every 8-column tile, so a row's max
// and sum are two shuffles within the quad. p goes from the S fragment
// straight into the A fragment of P V: in bfloat16 two neighbouring 8-key
// tiles, packed (and so rounded) to bfloat16 pairs, are one m16n8k16 A
// fragment; in float32 the A fragment of m16n8k8 holds keys lane % 4 and
// lane % 4 + 4, where S holds keys 2 (lane % 4) and 2 (lane % 4) + 1, so
// within each 8-key step the A column c stands for key 2c (c < 4) or
// 2(c - 4) + 1, and V's rows are read in that same order (P V sums over
// keys: any consistent order is exact). Q, K and V tiles sit in shared
// memory in the input type, head_dim padded with zeros to a multiple of 16
// (columns past d are never written back), rows 16 bytes longer than that so
// the fragment reads of 8 rows hit distinct banks; bfloat16 fragments come
// from `ldmatrix` (`.trans` for V), float32 ones from 32-bit loads. Tiles
// load with 16-byte `cp.async.cg` (zero-filled past t) where d * element size
// is a multiple of 16 and the tensors are 16-byte aligned, else element by
// element. K and V are double-buffered: the next live key tile (and its
// keys' positions, segment ids and key mask, by 4-byte `cp.async`) loads
// while the current one is computed. Each warp keeps the skip test's answer
// for 32 key tiles in its lanes (0 dead, 1 masked, 2 every pair allowed: no
// per-element mask), so the next live tile is a ballot and a causal block's
// dead tiles past its diagonal cost one read of the positions. The query
// tiles of one head run together (its K and V stay in L2), longest first
// (tile index reversed), so under a causal mask the short tiles fill the
// grid's tail. Dynamic shared memory at d = 128: 102,144 bytes float32 (two
// blocks, 8 warps, an SM), 88,576 bfloat16.
//
// K5 and K4, the backward, are built from K3's pieces and run on the tensor
// cores in the same two ways (3xTF32 m16n8k8 for float32, m16n8k16 bf16 for
// bfloat16; every sum float32). Each output is owned by one block, which
// loops over the other axis (the TPU's sequential grid axis becomes that
// loop): no atomics, and the results do not depend on the order blocks run
// in. K5 (dq) is K3's loop without the online softmax: one block of 4 warps
// per (64-row query tile, batch * head), each warp 16 query rows; the query
// tile and its dO tile are staged once, and the live key tiles (16 keys in
// float32, 64 in bfloat16) with their values double-buffered, found by K3's
// skip scan, longest query tiles first. Per key tile: S = Q K^T and
// dP = dO V^T (K3's score product twice), p = exp2(s scale log2e - lse
// log2e) on the fragment (0 where masked or where lse = NEG), ds = p (dp +
// g - di), and dQ += dS K (K3's P V product with K in V's place: in float32
// its permuted key order applies to K's rows as to V's; in bfloat16 ds is
// rounded to bfloat16 as it is packed, as the TPU kernel rounds it).
//
// K4 (dk, dv) runs the same four products transposed, on one block per
// (64-row key tile, batch * head) that stages its K and V once and double-
// buffers the live query tiles (32 queries in float32, 64 in bfloat16) with
// their dO, positions, segment ids, lse, g and di. A mirror of the skip scan
// walks the query tiles against the key tile: dead when the key tile's least
// position is past the query tile's greatest, or the segment ranges cannot
// meet; every pair allowed when there is no key mask and no segments, both
// tiles are whole, and the greatest key position is at most the least query
// position. Key tile 0, which every query sees under a causal mask, has the
// longest loop and runs first. The dK and dV accumulators are 2 x 16 x 4 =
// 128 floats a thread at d 128 for a warp that owns both, and a float32 warp
// that did (16-query tiles) spilled at ptxas's 255-register ceiling; 8-query
// tiles fit but ran slower. So K4 pairs its warps (FA2's split): 8 warps, two
// on each 16 key rows. The first of a pair computes S^T = K Q^T and P^T from
// each column's (query's) lse, hands P^T to its partner through shared
// memory (a named barrier of the two warps: the first arrives, the second
// waits), and adds P^T dO to dV; the second computes dP^T = V dO^T, dS^T =
// P^T (dP^T + g - di) and adds dS^T Q to dK. Each warp keeps 64
// accumulators, does two of the four products, and no product is computed
// twice; the block (256 threads) takes one SM.
//
// In all three, unlike the TPU kernels, head_dim is not padded to 128 lanes
// and the time axes need no exact tiling: rows and columns past t are masked
// in the kernel, and a whole tile that the skip test finds dead is skipped by
// every warp of the block alike (the TPU's _skip_when, with the minimum and
// maximum taken over the tile's data). Dynamic shared memory at d = 128:
// K5 101,760 bytes float32 (two blocks an SM), 105,984 bfloat16; K4 144,640
// float32, 123,392 bfloat16. Every kernel's shared memory is set with
// cudaFuncSetAttribute before each launch.
//
// These kernels take head_dim <= 128. Wider heads, and the backward with the
// JAX package's bfloat16 accumulator, run the sliced arms at the end of this
// file, built from the same pieces; their note is there.

#include <climits>
#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;       // the rows of a block's own tile, 16 a warp
constexpr int kThreads = 128;   // K3, K5: 4 warps of 16 rows
constexpr int kPairThreads = 256;  // K4: 4 pairs of warps, a pair on 16 key rows
constexpr int kMaxHeadDim = 128;
constexpr float kNeg = -1e30f;  // the mask sentinel (finite: -inf NaNs grads)
constexpr float kLog2e = 1.4426950408889634f;

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
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

// ---------------------------------------------------------------- K3: forward

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; bytes = 0 fills
// the 16 bytes with zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// 4 bytes likewise (cp.async.ca: the mask data of a key tile)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes));
}

// x = big + small to float32 accuracy, as TF32 operands of mma: big is x
// rounded to TF32 (10 mantissa bits) to nearest with ties away from zero, as
// cvt.rna.tf32.f32 rounds a finite x, in two integer operations (the cvt
// instruction costs several, for its NaN and infinity cases); small is
// x - big, whose 13 low bits the tensor cores ignore (truncating it to TF32,
// 2^-21 of x at most, as CUTLASS's fast 3xTF32 conversion counts on)
__device__ __forceinline__ void split(float x, unsigned& big, unsigned& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b at float32 accuracy (3xTF32): the two cross terms, then big big
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const unsigned (&ab)[4],
                                           const unsigned (&as)[4], unsigned bb0,
                                           unsigned bb1, unsigned bs0, unsigned bs1) {
  mma_tf32(c, as, bb0, bb1);
  mma_tf32(c, ab, bs0, bs1);
  mma_tf32(c, ab, bb0, bb1);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bfloat16 matrices; lanes 8i .. 8i + 7 give the row addresses of
// matrix i, and register i holds its row lane / 4, columns 2 (lane % 4) + {0,
// 1} (with .trans: rows 2 (lane % 4) + {0, 1} of column lane / 4).
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// Named barrier `id` (1 .. 15; 0 is __syncthreads') of `threads` threads:
// arrive without waiting (a producer), or wait for all of them (a consumer,
// who then sees the producers' shared-memory writes).
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// (lo, hi) rounded to a bfloat16 pair, lo in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// 2^x to about 2 ulp (MUFU.EX2, subnormal results flushed to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Key rows of a K3 key tile: 64 in bfloat16; 32 in float32, so that its
// double-buffered K and V tiles and the query tile (102,144 bytes at d 128)
// leave room for two blocks an SM.
template <typename T>
__host__ __device__ constexpr int fwd_keys() {
  return std::is_same<T, float>::value ? 32 : 64;
}

// Row stride, in elements, of a tile whose head_dim is padded to dp: 16
// bytes past it, so 8 rows read at one column fall in 8 distinct bank groups.
template <typename T>
__host__ __device__ constexpr int tile_ld(int dp) {
  return dp + 16 / static_cast<int>(sizeof(T));
}

template <int NK> struct KeyTile;

// the query tile, two K and two V tiles, two key tiles' mask data
template <typename T>
size_t fwd_smem(int dp) {
  return (kTile + 4 * fwd_keys<T>()) * tile_ld<T>(dp) * sizeof(T) +
         2 * sizeof(KeyTile<fwd_keys<T>()>);
}

// dst[r * LD + c] = src(head (bi, hi), row row0 + r, column c) for r < rows
// and c < DP: zero past t and past d, by the block's NT threads. With `vec`,
// 16-byte cp.async copies (the caller commits and waits; columns d .. DP are
// zeroed once at block start): a thread copies one 16-byte column of every
// (NT / chunks a row)-th row; otherwise element by element.
template <typename T, int DP, int NT = kThreads>
__device__ void stage_tile(T* dst, const T* src, int bi, int hi, int row0, int rows,
                           int t, int h, int d, bool vec) {
  constexpr int LD = tile_ld<T>(DP);
  constexpr int kPer = 16 / sizeof(T);       // elements a copy
  constexpr int kChunks = DP / kPer;         // copies a padded row: 2 .. 32
  constexpr int kStep = NT / kChunks;
  if (vec) {
    const int c = (threadIdx.x % kChunks) * kPer;
    if (c >= d) return;
    const long long stride = (long long)h * d;  // from one row of the head to the next
    const T* p = src + row_offset(bi, hi, row0, t, h, d) + c;
    for (int r = threadIdx.x / kChunks; r < rows; r += kStep) {
      const bool in = row0 + r < t;
      cp_async16(dst + r * LD + c, in ? p + r * stride : src, in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows * DP; i += NT) {
      const int r = i / DP, c = i - r * DP, row = row0 + r;
      dst[r * LD + c] = row < t && c < d ? src[row_offset(bi, hi, row, t, h, d) + c]
                                         : from_f<T>(0.f);
    }
  }
}

// Columns d .. DP of `rows` consecutive tile rows from t, which no 16-byte
// copy writes: zeroed once at block start.
template <typename T, int DP, int NT = kThreads>
__device__ void zero_padding(T* t, int rows, int d) {
  constexpr int LD = tile_ld<T>(DP);
  for (int i = threadIdx.x; i < rows * (DP - d); i += NT) {
    const int r = i / (DP - d);
    t[r * LD + d + (i - r * (DP - d))] = from_f<T>(0.f);
  }
}

// What the masks need of this block's own tile (its queries in K3 and K5, its
// keys in K4): the range of its positions and of its segment ids, and whether
// all its rows exist.
struct TileSpan {
  int plo, phi, slo, shi;
  bool whole;
};

__device__ TileSpan query_tile(const Attn& a, int bi, int q0) {
  TileSpan q{0, 0, 0, 0, q0 + kTile <= a.tq};
  if (a.causal) warp_range(a.qp, q0, a.tq, q.plo, q.phi);
  if (a.qs) warp_range(a.qs + (long long)bi * a.tq, q0, a.tq, q.slo, q.shi);
  return q;
}

__device__ TileSpan key_tile(const Attn& a, int bi, int k0) {
  TileSpan k{0, 0, 0, 0, k0 + kTile <= a.tk};
  if (a.causal) warp_range(a.kp, k0, a.tk, k.plo, k.phi);
  if (a.qs) warp_range(a.ks + (long long)bi * a.tk, k0, a.tk, k.slo, k.shi);
  return k;
}

// The skip test of tile `tile` (N rows) of the other side against the
// block's own tile, from one lane: key tiles against a query tile (KEYS: K3,
// K5) or query tiles against a key tile (K4). 0 when no pair can be allowed
// (or the tile lies past t): the least key position is past the greatest
// query position, or the segment ranges cannot meet; 2 when every pair is (no
// key mask, no segments, every row inside t, every key position <= every
// query position); 1 otherwise.
template <int N, bool KEYS>
__device__ int tile_state(const Attn& a, int bi, const TileSpan& own, int tile) {
  const int t = KEYS ? a.tk : a.tq, r0 = tile * N;
  if (tile >= (t + N - 1) / N) return 0;
  const int n = min(N, t - r0);
  const int* pos = KEYS ? a.kp : a.qp;
  const int* seg = (KEYS ? a.ks : a.qs) + (long long)bi * t + r0;
  int plo = INT_MAX, phi = INT_MIN, slo = INT_MAX, shi = INT_MIN;
#pragma unroll 16
  for (int i = 0; i < N; ++i)
    if (i < n) {
      if (a.causal) {
        plo = min(plo, pos[r0 + i]);
        phi = max(phi, pos[r0 + i]);
      }
      if (a.qs) {
        slo = min(slo, seg[i]);
        shi = max(shi, seg[i]);
      }
    }
  const int klo = KEYS ? plo : own.plo, khi = KEYS ? phi : own.phi;
  const int qlo = KEYS ? own.plo : plo, qhi = KEYS ? own.phi : phi;
  if ((a.causal && klo > qhi) || (a.qs && (slo > own.shi || shi < own.slo))) return 0;
  return !a.km && !a.qs && own.whole && n == N && (!a.causal || khi <= qlo) ? 2 : 1;
}

// The live tiles of the other side in order, 32 at a time: lane i of each
// warp holds the state of tile base + i, so the next live tile is a ballot
// away, and the masks' data are read once per 32 tiles (a causal block's run
// of dead tiles past its diagonal costs one read, not one a tile).
template <int N, bool KEYS = true>
struct TileScan {
  int base = -64, state = 0;

  // the first live tile at or after `tile` (its state in st), or the tile count
  __device__ int next(const Attn& a, int bi, const TileSpan& own, int tile, int& st) {
    const int tiles = ((KEYS ? a.tk : a.tq) + N - 1) / N;
    for (; tile < tiles; tile = base + 32) {
      if (tile >= base + 32) {
        base = tile;
        state = tile_state<N, KEYS>(a, bi, own, base + (threadIdx.x & 31));
      }
      const unsigned live =
          __ballot_sync(0xffffffffu, state != 0) & (0xffffffffu << (tile - base));
      if (live) {
        const int l = __ffs(live) - 1;
        st = __shfl_sync(0xffffffffu, state, l);
        return base + l;
      }
    }
    return tiles;
  }
};

// s[n][.] = q . k over the 8 key columns n (< BK / 8) of the key tile, for
// this warp's 16 rows r0 .. r0 + 15 of the query tile (unscaled, unmasked).
template <int DP, int BK>
__device__ __forceinline__ void tile_scores(float (&s)[BK / 8][4], const float* qt,
                                            const float* kt, int r0, int lane) {
  constexpr int LD = tile_ld<float>(DP);
  const int g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int ks = 0; ks < DP / 8; ++ks) {
    const float* qr = qt + (r0 + g) * LD + ks * 8 + c;
    unsigned ab[4], as[4];  // A: (g, c), (g + 8, c), (g, c + 4), (g + 8, c + 4)
    split(qr[0], ab[0], as[0]);
    split(qr[8 * LD], ab[1], as[1]);
    split(qr[4], ab[2], as[2]);
    split(qr[8 * LD + 4], ab[3], as[3]);
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      const float* kr = kt + (n * 8 + g) * LD + ks * 8 + c;  // B: (c, g), (c + 4, g)
      unsigned bb0, bs0, bb1, bs1;
      split(kr[0], bb0, bs0);
      split(kr[4], bb1, bs1);
      mma_3xtf32(s[n], ab, as, bb0, bb1, bs0, bs1);
    }
  }
}

template <int DP, int BK>
__device__ __forceinline__ void tile_scores(float (&s)[BK / 8][4],
                                            const __nv_bfloat16* qt,
                                            const __nv_bfloat16* kt, int r0, int lane) {
  constexpr int LD = tile_ld<__nv_bfloat16>(DP);
  const int i = lane & 7, m1 = (lane >> 3) & 1, m2 = lane >> 4;
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks) {
    unsigned qa[4];  // matrices: rows 0-7 | 8-15 x columns 0-7 | 8-15
    ldsm_x4(qa, qt + (r0 + i + 8 * m1) * LD + ks * 16 + 8 * m2);
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) {
      unsigned kb[4];  // keys 0-7 | 8-15 of the pair x columns 0-7 | 8-15
      ldsm_x4(kb, kt + (n * 16 + i + 8 * m2) * LD + ks * 16 + 8 * m1);
      mma_bf16(s[2 * n], qa, kb[0], kb[1]);
      mma_bf16(s[2 * n + 1], qa, kb[2], kb[3]);
    }
  }
}

// acc[n][.] += p v over the key tile, for the output columns n (< DP / 8).
// The tensor cores' float32 sums drop low bits, so in float32 each output
// column's tile sum starts from zero and joins acc with a rounded float add,
// rather than running on through every key of the row.
template <int DP, int BK>
__device__ __forceinline__ void tile_pv(float (&acc)[DP / 8][4],
                                        const float (&p)[BK / 8][4],
                                        const float* vt, int lane) {
  constexpr int LD = tile_ld<float>(DP);
  const int g = lane >> 2, c = lane & 3;
  // A column c is key 2c, column c + 4 key 2c + 1 of each 8-key step
  unsigned ab[BK / 8][4], as[BK / 8][4];
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    split(p[kk][0], ab[kk][0], as[kk][0]);
    split(p[kk][2], ab[kk][1], as[kk][1]);
    split(p[kk][1], ab[kk][2], as[kk][2]);
    split(p[kk][3], ab[kk][3], as[kk][3]);
  }
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      const float* vr = vt + (kk * 8 + 2 * c) * LD + n * 8 + g;
      unsigned bb0, bs0, bb1, bs1;
      split(vr[0], bb0, bs0);
      split(vr[LD], bb1, bs1);
      mma_3xtf32(t, ab[kk], as[kk], bb0, bb1, bs0, bs1);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[n][j] += t[j];
  }
}

template <int DP, int BK>
__device__ __forceinline__ void tile_pv(float (&acc)[DP / 8][4],
                                        const float (&p)[BK / 8][4],
                                        const __nv_bfloat16* vt, int lane) {
  constexpr int LD = tile_ld<__nv_bfloat16>(DP);
  const int i = lane & 7, m1 = (lane >> 3) & 1, m2 = lane >> 4;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    // two 8-key score tiles, rounded to bfloat16: one m16n8k16 A fragment
    const unsigned pa[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                            pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                            pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                            pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int n = 0; n < DP / 16; ++n) {
      unsigned vb[4];  // keys 0-7 | 8-15 x columns 0-7 | 8-15, transposed
      ldsm_x4_trans(vb, vt + (kk * 16 + i + 8 * m1) * LD + n * 16 + 8 * m2);
      mma_bf16(acc[2 * n], pa, vb[0], vb[1]);
      mma_bf16(acc[2 * n + 1], pa, vb[2], vb[3]);
    }
  }
}

// The mask data of a key tile's keys: positions, segment ids, key mask
template <int NK>
struct KeyTile {
  int pos[NK], seg[NK];
  float km[NK];
};

// K and V of the key tile at k0 (BK keys) into one buffer (cp.async or
// element-wise), and the mask data of its keys beside them (cp.async, zero
// past tk).
template <typename T, int DP, int BK = fwd_keys<T>()>
__device__ __forceinline__ void stage_keys(T* kt, T* vt, KeyTile<BK>* info,
                                           const Attn& a, int bi, int hi, int k0,
                                           bool vec) {
  stage_tile<T, DP>(kt, static_cast<const T*>(a.k), bi, hi, k0, BK, a.tk, a.h, a.d, vec);
  stage_tile<T, DP>(vt, static_cast<const T*>(a.v), bi, hi, k0, BK, a.tk, a.h, a.d, vec);
  const int j = threadIdx.x, k = k0 + j;
  if (j < BK) {
    const int in = k < a.tk ? 4 : 0, at = k < a.tk ? k : 0;
    const long long row = (long long)bi * a.tk + at;
    if (a.causal) cp_async4(&info->pos[j], a.kp + at, in);
    if (a.qs) cp_async4(&info->seg[j], a.ks + row, in);
    if (a.km) cp_async4(&info->km[j], a.km + row, in);
  }
}

// D16: head_dim padded to 16 * D16 (d <= 16, 32, 64, 128)
template <typename T, int D16>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(Attn a, int vec, T* __restrict__ o, float* __restrict__ lse) {
  constexpr int DP = 16 * D16;
  constexpr int LD = tile_ld<T>(DP);
  constexpr int BK = fwd_keys<T>();
  extern __shared__ __align__(16) unsigned char fwd_raw[];
  T* qt = reinterpret_cast<T*>(fwd_raw);  // [kTile][LD] this block's queries
  T* kb = qt + kTile * LD;                // [2][BK][LD] key tiles
  T* vb = kb + 2 * BK * LD;               // [2][BK][LD] their values
  KeyTile<BK>* kinfo = reinterpret_cast<KeyTile<BK>*>(vb + 2 * BK * LD);  // [2]
  const int lane = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2, c = lane & 3;
  const int bi = blockIdx.y / a.h, hi = blockIdx.y - bi * a.h;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;  // longest tiles first
  const float scale2 = a.scale * kLog2e;  // scores in log2 units: exp2 below

  if (vec) zero_padding<T, DP>(qt, kTile + 4 * BK, a.d);
  stage_tile<T, DP>(qt, static_cast<const T*>(a.q), bi, hi, q0, kTile, a.tq, a.h, a.d,
                    vec);
  const TileSpan qtile = query_tile(a, bi, q0);
  TileScan<BK> scan;
  const int tiles = (a.tk + BK - 1) / BK;
  int state;
  int tile = scan.next(a, bi, qtile, 0, state);
  if (tile < tiles) stage_keys<T, DP>(kb, vb, kinfo, a, bi, hi, tile * BK, vec);
  cp_async_commit();

  const Info qi[2] = {query_info(a, bi, q0 + r0 + g), query_info(a, bi, q0 + r0 + g + 8)};
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};  // l: this thread's columns only
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int buf = 0; tile < tiles; buf ^= 1) {
    int next_state;
    const int next = scan.next(a, bi, qtile, tile + 1, next_state);
    cp_async_wait_all();
    __syncthreads();  // this tile landed; every warp is done with the other buffer
    if (next < tiles)  // the next live tile loads while this one is computed
      stage_keys<T, DP>(kb + (buf ^ 1) * BK * LD, vb + (buf ^ 1) * BK * LD,
                        kinfo + (buf ^ 1), a, bi, hi, next * BK, vec);
    cp_async_commit();
    const KeyTile<BK>& ki = kinfo[buf];
    const int k0 = tile * BK;

    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    tile_scores<DP, BK>(s, qt, kb + buf * BK * LD, r0, lane);

    // s[n][2r + e] is row g + 8r, key n * 8 + 2c + e of the tile
    float mt[2] = {kNeg, kNeg};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float& x = s[n][j];
        const int col = n * 8 + 2 * c + (j & 1);
        x = state == 2 || allowed(a, qi[j >> 1],
                                  {ki.pos[col], ki.seg[col],
                                   k0 + col < a.tk && (!a.km || ki.km[col] > 0.f)})
                ? x * scale2 : kNeg;
        mt[j >> 1] = fmaxf(mt[j >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = fmaxf(m[r], quad_max(mt[r]));
      alpha[r] = exp2_approx(m[r] - mn);
      m[r] = mn;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = j >> 1;
        // a row with nothing allowed so far keeps p = 0 (exp(0) would be 1)
        const float p = m[r] <= kNeg / 2 ? 0.f : exp2_approx(s[n][j] - m[r]);
        s[n][j] = p;
        rs[r] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + rs[r];
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
    tile_pv<DP, BK>(acc, s, vb + buf * BK * LD, lane);
    tile = next;
    state = next_state;
  }
  cp_async_wait_all();  // nothing in flight at exit (Q, when no tile is live)

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float sum = quad_sum(l[r]);
    const int row = q0 + r0 + g + 8 * r;
    if (row >= a.tq) continue;
    const float inv = sum > 0.f ? 1.f / sum : 0.f;
    const long long at = row_offset(bi, hi, row, a.tq, a.h, a.d);
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n * 8 + 2 * c + e;
        if (col < a.d) o[at + col] = from_f<T>(acc[n][2 * r + e] * inv);
      }
    if (c == 0)  // m is in log2 units
      lse[((long long)bi * a.tq + row) * a.h + hi] =
          sum > 0.f ? (m[r] + log2f(sum)) / kLog2e : kNeg;
  }
}

// --------------------------------------------------------------- the backward

struct Bwd {
  const void* dout;   // [b, tq, h, d], the input type
  const float* lse;   // [b, tq, h]
  const float* di;    // [b, tq, h]
  const float* gl;    // [b, tq, h]
};

// lse in log2 units, or 1e30 (so that exp2(s - it) is 0) for a row that no
// key may see
__device__ __forceinline__ float lse_log2(float lse) {
  return lse > kNeg / 2 ? lse * kLog2e : -kNeg;
}

// ------------------------------------------------------------ K5: dq backward

// Key rows of a K5 key tile: 16 in float32, so that the query and dO tiles
// and the double-buffered K and V tiles (101,760 bytes at d 128) leave room
// for two blocks an SM; 64 in bfloat16 (105,984 bytes).
template <typename T>
__host__ __device__ constexpr int dq_keys() {
  return std::is_same<T, float>::value ? 16 : 64;
}

// the query and dO tiles, two K and two V tiles, two key tiles' mask data
template <typename T>
size_t dq_smem(int dp) {
  return (2 * kTile + 4 * dq_keys<T>()) * tile_ld<T>(dp) * sizeof(T) +
         2 * sizeof(KeyTile<dq_keys<T>()>);
}

// K3's loop without the online softmax: per live key tile, S = Q K^T and
// dP = dO V^T, p from the saved lse, ds = p (dp + g - di), dQ += dS K.
template <typename T, int D16>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dq_kernel(Attn a, Bwd bw, int vec, T* __restrict__ dq) {
  constexpr int DP = 16 * D16;
  constexpr int LD = tile_ld<T>(DP);
  constexpr int BK = dq_keys<T>();
  extern __shared__ __align__(16) unsigned char dq_raw[];
  T* qt = reinterpret_cast<T*>(dq_raw);  // [kTile][LD] this block's queries
  T* dot = qt + kTile * LD;              // [kTile][LD] their output cotangents
  T* kb = dot + kTile * LD;              // [2][BK][LD] key tiles
  T* vb = kb + 2 * BK * LD;              // [2][BK][LD] their values
  KeyTile<BK>* kinfo = reinterpret_cast<KeyTile<BK>*>(vb + 2 * BK * LD);  // [2]
  const int lane = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2, c = lane & 3;
  const int bi = blockIdx.y / a.h, hi = blockIdx.y - bi * a.h;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;  // longest tiles first
  const float scale2 = a.scale * kLog2e;

  if (vec) zero_padding<T, DP>(qt, 2 * kTile + 4 * BK, a.d);
  stage_tile<T, DP>(qt, static_cast<const T*>(a.q), bi, hi, q0, kTile, a.tq, a.h, a.d,
                    vec);
  stage_tile<T, DP>(dot, static_cast<const T*>(bw.dout), bi, hi, q0, kTile, a.tq, a.h,
                    a.d, vec);
  const TileSpan qtile = query_tile(a, bi, q0);
  TileScan<BK> scan;
  const int tiles = (a.tk + BK - 1) / BK;
  int state;
  int tile = scan.next(a, bi, qtile, 0, state);
  if (tile < tiles) stage_keys<T, DP, BK>(kb, vb, kinfo, a, bi, hi, tile * BK, vec);
  cp_async_commit();

  // this thread's rows g and g + 8: mask data, lse (log2 units), g - di
  Info qi[2];
  float lse2[2], dg[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + g + 8 * r;
    qi[r] = query_info(a, bi, row);
    const long long at = ((long long)bi * a.tq + row) * a.h + hi;
    lse2[r] = lse_log2(qi[r].ok ? bw.lse[at] : kNeg);
    dg[r] = qi[r].ok ? bw.gl[at] - bw.di[at] : 0.f;
  }
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int buf = 0; tile < tiles; buf ^= 1) {
    int next_state;
    const int next = scan.next(a, bi, qtile, tile + 1, next_state);
    cp_async_wait_all();
    __syncthreads();  // this tile landed; every warp is done with the other buffer
    if (next < tiles)
      stage_keys<T, DP, BK>(kb + (buf ^ 1) * BK * LD, vb + (buf ^ 1) * BK * LD,
                            kinfo + (buf ^ 1), a, bi, hi, next * BK, vec);
    cp_async_commit();
    const KeyTile<BK>& ki = kinfo[buf];
    const T* kt = kb + buf * BK * LD;
    const int k0 = tile * BK;

    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[n][j] = dp[n][j] = 0.f;
    tile_scores<DP, BK>(s, qt, kt, r0, lane);
    tile_scores<DP, BK>(dp, dot, vb + buf * BK * LD, r0, lane);

    // s[n][2r + e] is row g + 8r, key n * 8 + 2c + e of the tile: it becomes ds
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n * 8 + 2 * c + (j & 1), r = j >> 1;
        const bool ok =
            state == 2 || allowed(a, qi[r],
                                  {ki.pos[col], ki.seg[col],
                                   k0 + col < a.tk && (!a.km || ki.km[col] > 0.f)});
        const float p = ok ? exp2_approx(fmaf(s[n][j], scale2, -lse2[r])) : 0.f;
        s[n][j] = p * (dp[n][j] + dg[r]);
      }
    tile_pv<DP, BK>(acc, s, kt, lane);  // K's rows in V's place
    tile = next;
    state = next_state;
  }
  cp_async_wait_all();  // nothing in flight at exit

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + g + 8 * r;
    if (row >= a.tq) continue;
    const long long at = row_offset(bi, hi, row, a.tq, a.h, a.d);
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n * 8 + 2 * c + e;
        if (col < a.d) dq[at + col] = from_f<T>(acc[n][2 * r + e] * a.scale);
      }
  }
}

// ---------------------------------------------------------- K4: dk, dv backward

// Query rows of a K4 query tile: 32 in float32, 64 in bfloat16 (one block of
// 8 warps an SM: 144,640 and 123,392 bytes at d 128).
template <typename T>
__host__ __device__ constexpr int dkv_queries() {
  return std::is_same<T, float>::value ? 32 : 64;
}

// What a K4 query tile's queries bring: positions, segment ids, lse, g, di
template <int NQ>
struct QueryTile {
  int pos[NQ], seg[NQ];
  float lse[NQ], gl[NQ], di[NQ];
};

// the key and value tiles, two Q and two dO tiles, P^T's fragments of the
// four warp pairs, two query tiles' data
template <typename T>
size_t dkv_smem(int dp) {
  constexpr int BQ = dkv_queries<T>();
  return (2 * kTile + 4 * BQ) * tile_ld<T>(dp) * sizeof(T) + 4 * 16 * BQ * sizeof(float) +
         2 * sizeof(QueryTile<BQ>);
}

// Q and dO of the query tile at q0 (BQ queries) into one buffer, and its
// queries' data beside them (cp.async, zero past tq).
template <typename T, int DP, int BQ>
__device__ __forceinline__ void stage_queries(T* qt, T* dot, QueryTile<BQ>* info,
                                              const Attn& a, const Bwd& bw, int bi,
                                              int hi, int q0, bool vec) {
  stage_tile<T, DP, kPairThreads>(qt, static_cast<const T*>(a.q), bi, hi, q0, BQ, a.tq,
                                  a.h, a.d, vec);
  stage_tile<T, DP, kPairThreads>(dot, static_cast<const T*>(bw.dout), bi, hi, q0, BQ,
                                  a.tq, a.h, a.d, vec);
  const int j = threadIdx.x, q = q0 + j;
  if (j < BQ) {
    const int in = q < a.tq ? 4 : 0, at = q < a.tq ? q : 0;
    const long long row = (long long)bi * a.tq + at, lrow = row * a.h + hi;
    if (a.causal) cp_async4(&info->pos[j], a.qp + at, in);
    if (a.qs) cp_async4(&info->seg[j], a.qs + row, in);
    cp_async4(&info->lse[j], bw.lse + lrow, in);
    cp_async4(&info->gl[j], bw.gl + lrow, in);
    cp_async4(&info->di[j], bw.di + lrow, in);
  }
}

// K5's four products transposed, split between a pair of warps on the same
// 16 key rows (FA2's split): per live query tile, the first warp computes
// S^T = K Q^T, P^T from each column's (query's) lse, hands P^T to its partner
// through shared memory and adds P^T dO to dV; the second computes
// dP^T = V dO^T, dS^T = P^T (dP^T + g - di) and adds dS^T Q to dK.
template <typename T, int D16>
__global__ void __launch_bounds__(kPairThreads, 1)
flash_bwd_dkv_kernel(Attn a, Bwd bw, int vec, T* __restrict__ dk, T* __restrict__ dv) {
  constexpr int DP = 16 * D16;
  constexpr int LD = tile_ld<T>(DP);
  constexpr int BQ = dkv_queries<T>();
  extern __shared__ __align__(16) unsigned char dkv_raw[];
  T* kt = reinterpret_cast<T*>(dkv_raw);  // [kTile][LD] this block's keys
  T* vt = kt + kTile * LD;                // [kTile][LD] and values
  T* qb = vt + kTile * LD;                // [2][BQ][LD] query tiles
  T* gb = qb + 2 * BQ * LD;               // [2][BQ][LD] their output cotangents
  float* pt = reinterpret_cast<float*>(gb + 2 * BQ * LD);  // [4][BQ / 8][32][4] P^T
  QueryTile<BQ>* qinfo = reinterpret_cast<QueryTile<BQ>*>(pt + 4 * 16 * BQ);  // [2]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pair = warp & 3, r0 = pair * 16;
  const bool dk_warp = warp >= 4;  // warps 0-3 own dV, 4-7 dK
  const int g = lane >> 2, c = lane & 3;
  const int bi = blockIdx.y / a.h, hi = blockIdx.y - bi * a.h;
  // key tile 0, which every query tile sees under a causal mask, first
  const int k0 = blockIdx.x * kTile;
  const float scale2 = a.scale * kLog2e;
  float4* pf = reinterpret_cast<float4*>(pt) + pair * (BQ / 8) * 32 + lane;

  if (vec) zero_padding<T, DP, kPairThreads>(kt, 2 * kTile + 4 * BQ, a.d);
  stage_tile<T, DP, kPairThreads>(kt, static_cast<const T*>(a.k), bi, hi, k0, kTile, a.tk,
                                  a.h, a.d, vec);
  stage_tile<T, DP, kPairThreads>(vt, static_cast<const T*>(a.v), bi, hi, k0, kTile, a.tk,
                                  a.h, a.d, vec);
  const TileSpan ktile = key_tile(a, bi, k0);
  TileScan<BQ, false> scan;
  const int tiles = (a.tq + BQ - 1) / BQ;
  int state;
  int tile = scan.next(a, bi, ktile, 0, state);
  if (tile < tiles) stage_queries<T, DP, BQ>(qb, gb, qinfo, a, bw, bi, hi, tile * BQ, vec);
  cp_async_commit();

  // this thread's key rows g and g + 8
  const Info ki[2] = {key_info(a, bi, k0 + r0 + g), key_info(a, bi, k0 + r0 + g + 8)};
  float acc[DP / 8][4];  // dV or dK
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int buf = 0; tile < tiles; buf ^= 1) {
    int next_state;
    const int next = scan.next(a, bi, ktile, tile + 1, next_state);
    cp_async_wait_all();
    // this tile landed; every warp is done with the other buffer and with
    // the last tile's P^T
    __syncthreads();
    if (next < tiles)
      stage_queries<T, DP, BQ>(qb + (buf ^ 1) * BQ * LD, gb + (buf ^ 1) * BQ * LD,
                               qinfo + (buf ^ 1), a, bw, bi, hi, next * BQ, vec);
    cp_async_commit();
    const QueryTile<BQ>& qi = qinfo[buf];
    const T* qt = qb + buf * BQ * LD;
    const T* dot = gb + buf * BQ * LD;

    // s[n][2r + e] is key row g + 8r, query n * 8 + 2c + e of the tile
    float s[BQ / 8][4];
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    if (!dk_warp) {
      tile_scores<DP, BQ>(s, kt, qt, r0, lane);
      const int q0 = tile * BQ;
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n * 8 + 2 * c + e;
          const float lse2 = lse_log2(qi.lse[col]);
          const Info q{qi.pos[col], qi.seg[col], q0 + col < a.tq};
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const bool ok = state == 2 || allowed(a, q, ki[r]);
            float& x = s[n][2 * r + e];
            x = ok ? exp2_approx(fmaf(x, scale2, -lse2)) : 0.f;
          }
        }
        pf[n * 32] = make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
      }
      bar_arrive(1 + pair, 64);
      tile_pv<DP, BQ>(acc, s, dot, lane);  // dV += P^T dO: dO's rows in V's place
    } else {
      tile_scores<DP, BQ>(s, vt, dot, r0, lane);  // dP^T
      bar_sync(1 + pair, 64);
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n) {
        const float4 p = pf[n * 32];
        const int col = n * 8 + 2 * c;
        const float dg0 = qi.gl[col] - qi.di[col], dg1 = qi.gl[col + 1] - qi.di[col + 1];
        s[n][0] = p.x * (s[n][0] + dg0);
        s[n][1] = p.y * (s[n][1] + dg1);
        s[n][2] = p.z * (s[n][2] + dg0);
        s[n][3] = p.w * (s[n][3] + dg1);
      }
      tile_pv<DP, BQ>(acc, s, qt, lane);  // dK += dS^T Q
    }
    tile = next;
    state = next_state;
  }
  cp_async_wait_all();  // nothing in flight at exit

  T* out = dk_warp ? dk : dv;
  const float mul = dk_warp ? a.scale : 1.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k0 + r0 + g + 8 * r;
    if (row >= a.tk) continue;
    const long long at = row_offset(bi, hi, row, a.tk, a.h, a.d);
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n * 8 + 2 * c + e;
        if (col < a.d) out[at + col] = from_f<T>(acc[n][2 * r + e] * mul);
      }
  }
}

// ------------------------------------------------------------------ launching

// D16: head_dim padded to 16 * D16
int d16_for(int d) { return d <= 16 ? 1 : d <= 32 ? 2 : d <= 64 ? 4 : 8; }

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

// the tiles of one head run together, so its data stay in L2
dim3 grid_for(int t, const Attn& a) {
  return dim3((t + kTile - 1) / kTile, a.b * a.h);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// whether tiles may load by 16-byte copies: rows of whole 16-byte chunks, and
// q, k, v (and dout, where there is one) 16-byte aligned
template <typename T>
int vec_copies(const Attn& a, const void* dout) {
  return a.d * sizeof(T) % 16 == 0 && aligned16(a.q) && aligned16(a.k) &&
         aligned16(a.v) && aligned16(dout);
}

template <typename T, int D16>
cudaError_t fwd(const Attn& a, void* o, float* lse, cudaStream_t s) {
  const size_t smem = fwd_smem<T>(16 * D16);
  cudaError_t e = prepare(flash_fwd_kernel<T, D16>, smem);
  if (e != cudaSuccess) return e;
  flash_fwd_kernel<T, D16><<<grid_for(a.tq, a), kThreads, smem, s>>>(
      a, vec_copies<T>(a, nullptr), static_cast<T*>(o), lse);
  return cudaGetLastError();
}

template <typename T, int D16>
cudaError_t bwd_dq(const Attn& a, const Bwd& g, void* dq, cudaStream_t s) {
  const size_t smem = dq_smem<T>(16 * D16);
  cudaError_t e = prepare(flash_bwd_dq_kernel<T, D16>, smem);
  if (e != cudaSuccess) return e;
  flash_bwd_dq_kernel<T, D16><<<grid_for(a.tq, a), kThreads, smem, s>>>(
      a, g, vec_copies<T>(a, g.dout), static_cast<T*>(dq));
  return cudaGetLastError();
}

template <typename T, int D16>
cudaError_t bwd_dkv(const Attn& a, const Bwd& g, void* dk, void* dv,
                    cudaStream_t s) {
  const size_t smem = dkv_smem<T>(16 * D16);
  cudaError_t e = prepare(flash_bwd_dkv_kernel<T, D16>, smem);
  if (e != cudaSuccess) return e;
  flash_bwd_dkv_kernel<T, D16><<<grid_for(a.tk, a), kPairThreads, smem, s>>>(
      a, g, vec_copies<T>(a, g.dout), static_cast<T*>(dk), static_cast<T*>(dv));
  return cudaGetLastError();
}

// One call of `Fn<T, D16>::run(args...)` for the input type and head_dim.
template <template <typename, int> class Fn, typename... Args>
cudaError_t dispatch(int bf16, int d, Args... args) {
  const int d16 = d16_for(d);
  const int width = d16 == 1 ? 0 : d16 == 2 ? 1 : d16 == 4 ? 2 : 3;
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

template <typename T, int D16> struct Fwd {
  static cudaError_t run(Attn a, void* o, float* lse, cudaStream_t s) {
    return fwd<T, D16>(a, o, lse, s);
  }
};
template <typename T, int D16> struct Dq {
  static cudaError_t run(Attn a, Bwd g, void* dq, cudaStream_t s) {
    return bwd_dq<T, D16>(a, g, dq, s);
  }
};
template <typename T, int D16> struct Dkv {
  static cudaError_t run(Attn a, Bwd g, void* dk, void* dv, cudaStream_t s) {
    return bwd_dkv<T, D16>(a, g, dk, dv, s);
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

// ============================================================== the sliced arms
//
// The sliced arms, for Hopper: the forward (K3), dk/dv (K4) and
// dq (K5) at any head_dim, and K4 and K5 with the bfloat16 backward
// accumulator at any head_dim. They are built from the pieces of the
// head_dim <= 128 kernels above and the note at the top of this file
// describes those (the mask logic, the skip scan, the tensor-core products on
// shared-memory tiles).
//
// They replace the same TPU kernels as K3-K5:
// deeplearning4j_tpu/ops/flash_attention.py:_fwd_kernel, _bwd_dkv_kernel and
// _bwd_dq_kernel, which take any head_dim their VMEM estimate passes (the
// JAX package pads head_dim to a multiple of 128 lanes; at 128-row blocks its
// gate passes up to 2,688, more at shorter t), and whose backward accumulates
// in bfloat16 when asked (bwd_acc_dtype="bfloat16").
//
// Design: slices over the grid, chunks through shared memory. The output
// columns (O in K3, dQ in K5, dK and dV in K4) are cut into slices of kChunk
// = 128; a block owns one slice of its tile (grid x = tile * slices + slice),
// so its accumulators are the d = 128 kernels' (a warp's 16 rows x 128
// columns in float32 fragments) whatever head_dim is, and nothing limits
// head_dim but the grid. The contractions over head_dim, S = Q K^T and dP =
// dO V^T, are summed over the whole head_dim: Q and K (dO and V) stream
// through shared memory in 128-wide chunks, and each chunk's product adds into
// the S (dP) fragments. A block computes S for itself, so every slice of a
// tile computes the same S (bit for bit: the same chunks in the same order,
// the same instructions), the same m, l and skip states, and only slice 0
// writes the lse. At head_dim 256 that is 1.5x the least work in K3 (S twice,
// P V once per slice); sharing S across the slices of a tile (a thread-block
// cluster and distributed shared memory) is later work.
//
// Each block walks the live tiles of the other side (K3's skip scan, K4's
// mirror of it) and, per tile, a sequence of steps, each one load into a
// two-slot ring in shared memory (16-byte cp.async.cg, zero-filled past t and
// past head_dim, or element by element where head_dim or the pointers are not
// 16-byte multiples) computed while the next step's load is in flight:
//   K3: Q and K chunk c (c < nc) -> S += Q_c K_c^T; then V's slice ->
//       the online softmax (K3's, on the fragments) and O += P V.
//   K5: Q and K chunk c -> S; dO and V chunk c -> dP; then K's slice ->
//       dS = P (dP + g - di) and dQ += dS K.
//   K4: K, Q, V and dO chunk c -> S^T (the first warp of a pair) and dP^T
//       (the second); then Q's and dO's slices -> P^T (handed to the partner
//       through shared memory, as K4's pairs do), dV += P^T dO, dS^T and
//       dK += dS^T Q.
// So Q (K3, K5) and K, V (K4) are read again for every tile of the other side:
// from L2, where one head's rows stay while its tiles run together. Key tiles
// are 32 rows in K3's float32 (64 in bfloat16, as in K3) and 32 in K5; query
// tiles 32 in K4. Dynamic shared memory: K3 102,144 bytes float32 (two blocks
// an SM), 71,168 bfloat16; K5 102,144 and 52,992; K4 212,224 and 113,920.
//
// The bfloat16 accumulator (ACC16; the wrapper passes the JAX block size jb):
// the JAX kernels keep dk, dv and dq in a bfloat16 scratch and, once for each
// block of their sequential sweep (jb query rows for K4, jb keys for K5), add
// that block's product: dv = bf16(dv + bf16(P_blk^T dO_blk)), dk = bf16(dk +
// bf16(bf16(dS_blk^T Q_blk) * bf16(scale))), dq likewise with dS_blk K_blk. So
// the result depends on jb. Here a warp sums its tiles' products within one
// JAX block in float32 (the float32 accumulator of the other arm, which starts
// each block at zero), and at the block's edge rounds it, scales it and adds
// it into its bfloat16 accumulator, kept as bfloat16 pairs in registers (32 a
// thread), so every rounding falls where the JAX kernels' does. A tile that
// straddles two JAX blocks (jb not a multiple of the tile) is multiplied once
// per block with the other block's columns zeroed. A skipped or fully masked
// block adds bf16(0), which leaves the sum as it was, as in the JAX kernels.
//
// Bound: operations, as K3-K5 (4d, 8d and 6d flops per allowed pair).

namespace {

constexpr int kChunk = 128;  // head_dim columns of a streamed chunk and of an output slice
constexpr int kSweepKeys = 32;     // K5's key tiles
constexpr int kSweepQueries = 32;  // K4's query tiles

__host__ __device__ inline int chunks(int d) { return (d + kChunk - 1) / kChunk; }

// dst[r * LD + c] = src(head (bi, hi), row row0 + r, column c0 + c) for r < rows
// and c < kChunk, zero past t and past d, by the block's NT threads: 16-byte
// cp.async copies with `vec` (zero-filled, reading nothing, past t and d; the
// caller commits and waits), else element by element.
template <typename T, int NT>
__device__ void stage_chunk(T* dst, const T* src, int bi, int hi, int row0, int rows, int t,
                            int h, int d, int c0, bool vec) {
  constexpr int LD = tile_ld<T>(kChunk);
  if (vec) {
    constexpr int kPer = 16 / sizeof(T);        // elements a copy
    constexpr int kCopies = kChunk / kPer;      // copies a chunk row: 32 or 16
    constexpr int kStep = NT / kCopies;
    const int c = (threadIdx.x % kCopies) * kPer;
    const bool col_in = c0 + c < d;             // d is a whole number of copies
    const long long stride = (long long)h * d;  // from one row of the head to the next
    const T* p = src + row_offset(bi, hi, row0, t, h, d) + c0 + c;
    for (int r = threadIdx.x / kCopies; r < rows; r += kStep) {
      const bool in = col_in && row0 + r < t;
      cp_async16(dst + r * LD + c, in ? p + r * stride : src, in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows * kChunk; i += NT) {
      const int r = i / kChunk, c = i - r * kChunk, row = row0 + r;
      dst[r * LD + c] = row < t && c0 + c < d
                            ? src[row_offset(bi, hi, row, t, h, d) + c0 + c]
                            : from_f<T>(0.f);
    }
  }
}

// The mask data of a key tile's keys (cp.async, zero past tk)
template <int BK>
__device__ __forceinline__ void stage_key_info(KeyTile<BK>* info, const Attn& a, int bi,
                                               int k0) {
  const int j = threadIdx.x, k = k0 + j;
  if (j < BK) {
    const int in = k < a.tk ? 4 : 0, at = k < a.tk ? k : 0;
    const long long row = (long long)bi * a.tk + at;
    if (a.causal) cp_async4(&info->pos[j], a.kp + at, in);
    if (a.qs) cp_async4(&info->seg[j], a.ks + row, in);
    if (a.km) cp_async4(&info->km[j], a.km + row, in);
  }
}

// What a query tile's queries bring to K4 (cp.async, zero past tq)
template <int BQ>
__device__ __forceinline__ void stage_query_info(QueryTile<BQ>* info, const Attn& a,
                                                 const Bwd& bw, int bi, int hi, int q0) {
  const int j = threadIdx.x, q = q0 + j;
  if (j < BQ) {
    const int in = q < a.tq ? 4 : 0, at = q < a.tq ? q : 0;
    const long long row = (long long)bi * a.tq + at, lrow = row * a.h + hi;
    if (a.causal) cp_async4(&info->pos[j], a.qp + at, in);
    if (a.qs) cp_async4(&info->seg[j], a.qs + row, in);
    cp_async4(&info->lse[j], bw.lse + lrow, in);
    cp_async4(&info->gl[j], bw.gl + lrow, in);
    cp_async4(&info->di[j], bw.di + lrow, in);
  }
}

// x rounded to bfloat16 (to nearest, ties to even) and back
__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Element e (0, 1) of a bfloat16 pair
__device__ __forceinline__ float bf16_at(unsigned pair, int e) {
  return __uint_as_float(e ? pair & 0xffff0000u : pair << 16);
}

// The bfloat16 accumulator's step at a JAX block's edge, for every element of
// a thread's fragments: acc = bf16(acc + bf16(bf16(part) * mul)), part = 0.
// acc[n][r] holds fragment elements 2r and 2r + 1 (one row) as a pair.
__device__ __forceinline__ void flush_acc16(unsigned (&acc)[kChunk / 8][2],
                                            float (&part)[kChunk / 8][4], float mul) {
#pragma unroll
  for (int n = 0; n < kChunk / 8; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float x0 = bf16r(bf16r(part[n][2 * r]) * mul);
      const float x1 = bf16r(bf16r(part[n][2 * r + 1]) * mul);
      acc[n][r] = pack_bf16(bf16_at(acc[n][r], 0) + x0, bf16_at(acc[n][r], 1) + x1);
      part[n][2 * r] = part[n][2 * r + 1] = 0.f;
    }
}

// acc += x V over one tile of the swept axis (keys in K5, queries in K4): x
// holds this warp's rows against the tile's N columns x0 .. x0 + N (of t), V
// the tile's N rows of this block's slice. With the bfloat16 accumulator, acc
// is the running float32 sum of the current JAX block (blk, of jb columns),
// flushed into acc16 whenever a tile reaches into a new block; a tile that
// straddles two blocks is multiplied once for each, the other's columns zeroed.
template <typename T, int N, bool ACC16>
__device__ __forceinline__ void swept_product(float (&acc)[kChunk / 8][4],
                                              unsigned (&acc16)[kChunk / 8][2], int& blk,
                                              const float (&x)[N / 8][4], const T* vt,
                                              int lane, int x0, int t, int jb, float mul) {
  if constexpr (!ACC16) {
    tile_pv<kChunk, N>(acc, x, vt, lane);
  } else {
    const int c = lane & 3;
    const int lo = x0 / jb, hi = (min(x0 + N, t) - 1) / jb;
    for (int b = lo; b <= hi; ++b) {
      if (b != blk) {
        flush_acc16(acc16, acc, mul);
        blk = b;
      }
      if (lo == hi) {
        tile_pv<kChunk, N>(acc, x, vt, lane);
      } else {
        float y[N / 8][4];
#pragma unroll
        for (int n = 0; n < N / 8; ++n)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            y[n][j] = (x0 + n * 8 + 2 * c + (j & 1)) / jb == b ? x[n][j] : 0.f;
        tile_pv<kChunk, N>(acc, y, vt, lane);
      }
    }
  }
}

// A thread's output value (row half r, column e of fragment n): the bfloat16
// accumulator, or the float32 one times mul.
template <bool ACC16>
__device__ __forceinline__ float out_value(const float (&acc)[kChunk / 8][4],
                                           const unsigned (&acc16)[kChunk / 8][2], int n,
                                           int r, int e, float mul) {
  if constexpr (ACC16) return bf16_at(acc16[n][r], e);
  else return acc[n][2 * r + e] * mul;
}

// ---------------------------------------------------------------- K3, sliced

template <typename T>
size_t fwd_wide_smem() {
  constexpr int BK = fwd_keys<T>();
  return 2 * (kTile + BK) * tile_ld<T>(kChunk) * sizeof(T) + 2 * sizeof(KeyTile<BK>);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_wide_kernel(Attn a, int vec, int slices, T* __restrict__ o, float* __restrict__ lse) {
  constexpr int DP = kChunk;
  constexpr int LD = tile_ld<T>(DP);
  constexpr int BK = fwd_keys<T>();
  constexpr int SLOT = (kTile + BK) * LD;  // a ring slot: Q and K chunks, or V's slice
  extern __shared__ __align__(16) unsigned char fwdw_raw[];
  T* ring = reinterpret_cast<T*>(fwdw_raw);                                   // [2][SLOT]
  KeyTile<BK>* kinfo = reinterpret_cast<KeyTile<BK>*>(ring + 2 * SLOT);      // [2]
  const int lane = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2, c = lane & 3;
  const int bi = blockIdx.y / a.h, hi = blockIdx.y - bi * a.h;
  const int qtile_i = blockIdx.x / slices, slice = blockIdx.x - qtile_i * slices;
  const int q0 = (gridDim.x / slices - 1 - qtile_i) * kTile;  // longest tiles first
  const int c_out = slice * kChunk, nc = chunks(a.d);
  const float scale2 = a.scale * kLog2e;
  const T* Q = static_cast<const T*>(a.q);
  const T* K = static_cast<const T*>(a.k);
  const T* V = static_cast<const T*>(a.v);

  // step s of key tile kt: chunk s of Q and K (s < nc), or V's slice (s = nc)
  auto load = [&](T* slot, int kt, int s, int par) {
    const int k0 = kt * BK;
    if (s < nc) {
      stage_chunk<T, kThreads>(slot, Q, bi, hi, q0, kTile, a.tq, a.h, a.d, s * kChunk, vec);
      stage_chunk<T, kThreads>(slot + kTile * LD, K, bi, hi, k0, BK, a.tk, a.h, a.d,
                               s * kChunk, vec);
      if (s == 0) stage_key_info<BK>(kinfo + par, a, bi, k0);
    } else {
      stage_chunk<T, kThreads>(slot + kTile * LD, V, bi, hi, k0, BK, a.tk, a.h, a.d, c_out,
                               vec);
    }
  };

  const TileSpan qtile = query_tile(a, bi, q0);
  TileScan<BK> scan;
  const int tiles = (a.tk + BK - 1) / BK;
  int state;
  int tile = scan.next(a, bi, qtile, 0, state);
  if (tile < tiles) load(ring, tile, 0, 0);
  cp_async_commit();

  const Info qi[2] = {query_info(a, bi, q0 + r0 + g), query_info(a, bi, q0 + r0 + g + 8)};
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};  // l: this thread's columns only
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  int slot = 0, par = 0;
  while (tile < tiles) {
    int next_state;
    const int next = scan.next(a, bi, qtile, tile + 1, next_state);
    const KeyTile<BK>& ki = kinfo[par];
    const int k0 = tile * BK;
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    for (int st = 0; st <= nc; ++st) {
      cp_async_wait_all();
      __syncthreads();  // this step landed; every warp is done with the other slot
      const T* cur = ring + slot * SLOT;
      T* nxt = ring + (slot ^ 1) * SLOT;
      if (st < nc) load(nxt, tile, st + 1, par);
      else if (next < tiles) load(nxt, next, 0, par ^ 1);
      cp_async_commit();
      slot ^= 1;
      if (st < nc) {
        tile_scores<DP, BK>(s, cur, cur + kTile * LD, r0, lane);
        continue;
      }
      // s[n][2r + e] is row g + 8r, key n * 8 + 2c + e of the tile
      float mt[2] = {kNeg, kNeg};
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float& x = s[n][j];
          const int col = n * 8 + 2 * c + (j & 1);
          x = state == 2 || allowed(a, qi[j >> 1],
                                    {ki.pos[col], ki.seg[col],
                                     k0 + col < a.tk && (!a.km || ki.km[col] > 0.f)})
                  ? x * scale2 : kNeg;
          mt[j >> 1] = fmaxf(mt[j >> 1], x);
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mn = fmaxf(m[r], quad_max(mt[r]));
        alpha[r] = exp2_approx(m[r] - mn);
        m[r] = mn;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = j >> 1;
          const float p = m[r] <= kNeg / 2 ? 0.f : exp2_approx(s[n][j] - m[r]);
          s[n][j] = p;
          rs[r] += p;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + rs[r];
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }
      tile_pv<DP, BK>(acc, s, cur + kTile * LD, lane);
    }
    tile = next;
    state = next_state;
    par ^= 1;
  }
  cp_async_wait_all();  // nothing in flight at exit

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float sum = quad_sum(l[r]);
    const int row = q0 + r0 + g + 8 * r;
    if (row >= a.tq) continue;
    const float inv = sum > 0.f ? 1.f / sum : 0.f;
    const long long at = row_offset(bi, hi, row, a.tq, a.h, a.d) + c_out;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n * 8 + 2 * c + e;
        if (c_out + col < a.d) o[at + col] = from_f<T>(acc[n][2 * r + e] * inv);
      }
    if (c == 0 && slice == 0)  // m is in log2 units
      lse[((long long)bi * a.tq + row) * a.h + hi] =
          sum > 0.f ? (m[r] + log2f(sum)) / kLog2e : kNeg;
  }
}

// ---------------------------------------------------------------- K5, sliced

template <typename T>
size_t dq_wide_smem() {
  return 2 * (kTile + kSweepKeys) * tile_ld<T>(kChunk) * sizeof(T) +
         2 * sizeof(KeyTile<kSweepKeys>);
}

template <typename T, bool ACC16>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dq_wide_kernel(Attn a, Bwd bw, int vec, int slices, int jb, T* __restrict__ dq) {
  constexpr int DP = kChunk;
  constexpr int LD = tile_ld<T>(DP);
  constexpr int BK = kSweepKeys;
  constexpr int SLOT = (kTile + BK) * LD;  // Q and K, or dO and V chunks, or K's slice
  extern __shared__ __align__(16) unsigned char dqw_raw[];
  T* ring = reinterpret_cast<T*>(dqw_raw);
  KeyTile<BK>* kinfo = reinterpret_cast<KeyTile<BK>*>(ring + 2 * SLOT);
  const int lane = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2, c = lane & 3;
  const int bi = blockIdx.y / a.h, hi = blockIdx.y - bi * a.h;
  const int qtile_i = blockIdx.x / slices, slice = blockIdx.x - qtile_i * slices;
  const int q0 = (gridDim.x / slices - 1 - qtile_i) * kTile;
  const int c_out = slice * kChunk, nc = chunks(a.d);
  const float scale2 = a.scale * kLog2e;
  const T* Q = static_cast<const T*>(a.q);
  const T* K = static_cast<const T*>(a.k);
  const T* V = static_cast<const T*>(a.v);
  const T* DO = static_cast<const T*>(bw.dout);

  // step s of key tile kt: Q and K chunk s (s < nc), dO and V chunk s - nc
  // (s < 2 nc), K's slice (s = 2 nc)
  auto load = [&](T* slot, int kt, int s, int par) {
    const int k0 = kt * BK;
    if (s < 2 * nc) {
      const bool scores = s < nc;
      const int c0 = (scores ? s : s - nc) * kChunk;
      stage_chunk<T, kThreads>(slot, scores ? Q : DO, bi, hi, q0, kTile, a.tq, a.h, a.d, c0,
                               vec);
      stage_chunk<T, kThreads>(slot + kTile * LD, scores ? K : V, bi, hi, k0, BK, a.tk, a.h,
                               a.d, c0, vec);
      if (s == 0) stage_key_info<BK>(kinfo + par, a, bi, k0);
    } else {
      stage_chunk<T, kThreads>(slot + kTile * LD, K, bi, hi, k0, BK, a.tk, a.h, a.d, c_out,
                               vec);
    }
  };

  const TileSpan qtile = query_tile(a, bi, q0);
  TileScan<BK> scan;
  const int tiles = (a.tk + BK - 1) / BK;
  int state;
  int tile = scan.next(a, bi, qtile, 0, state);
  if (tile < tiles) load(ring, tile, 0, 0);
  cp_async_commit();

  // this thread's rows g and g + 8: mask data, lse (log2 units), g - di
  Info qi[2];
  float lse2[2], dg[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + g + 8 * r;
    qi[r] = query_info(a, bi, row);
    const long long at = ((long long)bi * a.tq + row) * a.h + hi;
    lse2[r] = lse_log2(qi[r].ok ? bw.lse[at] : kNeg);
    dg[r] = qi[r].ok ? bw.gl[at] - bw.di[at] : 0.f;
  }
  float acc[DP / 8][4];      // dQ, or (ACC16) the current JAX block's sum
  unsigned acc16[DP / 8][2];  // ACC16: dQ as bfloat16 pairs
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    acc16[n][0] = acc16[n][1] = 0u;
  }
  const float mul16 = bf16r(a.scale);  // the JAX kernel's scale, a bfloat16 there
  int blk = -1;

  int slot = 0, par = 0;
  while (tile < tiles) {
    int next_state;
    const int next = scan.next(a, bi, qtile, tile + 1, next_state);
    const KeyTile<BK>& ki = kinfo[par];
    const int k0 = tile * BK;
    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[n][j] = dp[n][j] = 0.f;
    for (int st = 0; st <= 2 * nc; ++st) {
      cp_async_wait_all();
      __syncthreads();
      const T* cur = ring + slot * SLOT;
      T* nxt = ring + (slot ^ 1) * SLOT;
      if (st < 2 * nc) load(nxt, tile, st + 1, par);
      else if (next < tiles) load(nxt, next, 0, par ^ 1);
      cp_async_commit();
      slot ^= 1;
      if (st < nc) {
        tile_scores<DP, BK>(s, cur, cur + kTile * LD, r0, lane);
        continue;
      }
      if (st < 2 * nc) {
        tile_scores<DP, BK>(dp, cur, cur + kTile * LD, r0, lane);
        continue;
      }
      // s[n][2r + e] is row g + 8r, key n * 8 + 2c + e of the tile: it becomes ds
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = n * 8 + 2 * c + (j & 1), r = j >> 1;
          const bool ok =
              state == 2 || allowed(a, qi[r],
                                    {ki.pos[col], ki.seg[col],
                                     k0 + col < a.tk && (!a.km || ki.km[col] > 0.f)});
          const float p = ok ? exp2_approx(fmaf(s[n][j], scale2, -lse2[r])) : 0.f;
          s[n][j] = p * (dp[n][j] + dg[r]);
        }
      swept_product<T, BK, ACC16>(acc, acc16, blk, s, cur + kTile * LD, lane, k0, a.tk, jb,
                                  mul16);
    }
    tile = next;
    state = next_state;
    par ^= 1;
  }
  cp_async_wait_all();
  if constexpr (ACC16) flush_acc16(acc16, acc, mul16);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + g + 8 * r;
    if (row >= a.tq) continue;
    const long long at = row_offset(bi, hi, row, a.tq, a.h, a.d) + c_out;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n * 8 + 2 * c + e;
        if (c_out + col < a.d)
          dq[at + col] = from_f<T>(out_value<ACC16>(acc, acc16, n, r, e, a.scale));
      }
  }
}

// ---------------------------------------------------------------- K4, sliced

// a ring slot: K, Q, V and dO chunks (kTile, BQ, kTile, BQ rows); then P^T's
// fragments of the four warp pairs and two query tiles' data
template <typename T>
size_t dkv_wide_smem() {
  constexpr int BQ = kSweepQueries;
  return 2 * (2 * kTile + 2 * BQ) * tile_ld<T>(kChunk) * sizeof(T) +
         4 * 16 * BQ * sizeof(float) + 2 * sizeof(QueryTile<BQ>);
}

template <typename T, bool ACC16>
__global__ void __launch_bounds__(kPairThreads, 1)
flash_bwd_dkv_wide_kernel(Attn a, Bwd bw, int vec, int slices, int jb, T* __restrict__ dk,
                          T* __restrict__ dv) {
  constexpr int DP = kChunk;
  constexpr int LD = tile_ld<T>(DP);
  constexpr int BQ = kSweepQueries;
  constexpr int SLOT = (2 * kTile + 2 * BQ) * LD;
  constexpr int Q_AT = kTile * LD, V_AT = (kTile + BQ) * LD, DO_AT = (2 * kTile + BQ) * LD;
  extern __shared__ __align__(16) unsigned char dkvw_raw[];
  T* ring = reinterpret_cast<T*>(dkvw_raw);
  float* pt = reinterpret_cast<float*>(ring + 2 * SLOT);  // [4][BQ / 8][32][4] P^T
  QueryTile<BQ>* qinfo = reinterpret_cast<QueryTile<BQ>*>(pt + 4 * 16 * BQ);  // [2]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pair = warp & 3, r0 = pair * 16;
  const bool dk_warp = warp >= 4;  // warps 0-3 own dV, 4-7 dK
  const int g = lane >> 2, c = lane & 3;
  const int bi = blockIdx.y / a.h, hi = blockIdx.y - bi * a.h;
  const int ktile_i = blockIdx.x / slices, slice = blockIdx.x - ktile_i * slices;
  const int k0 = ktile_i * kTile;  // key tile 0, the longest under a causal mask, first
  const int c_out = slice * kChunk, nc = chunks(a.d);
  const float scale2 = a.scale * kLog2e;
  float4* pf = reinterpret_cast<float4*>(pt) + pair * (BQ / 8) * 32 + lane;
  const T* Q = static_cast<const T*>(a.q);
  const T* K = static_cast<const T*>(a.k);
  const T* V = static_cast<const T*>(a.v);
  const T* DO = static_cast<const T*>(bw.dout);

  // step s of query tile qt: K, Q, V and dO chunk s (s < nc), or Q's and dO's
  // slices (s = nc)
  auto load = [&](T* slot, int qt, int s, int par) {
    const int q0 = qt * BQ;
    const int c0 = s < nc ? s * kChunk : c_out;
    if (s < nc) {
      stage_chunk<T, kPairThreads>(slot, K, bi, hi, k0, kTile, a.tk, a.h, a.d, c0, vec);
      stage_chunk<T, kPairThreads>(slot + V_AT, V, bi, hi, k0, kTile, a.tk, a.h, a.d, c0,
                                   vec);
      if (s == 0) stage_query_info<BQ>(qinfo + par, a, bw, bi, hi, q0);
    }
    stage_chunk<T, kPairThreads>(slot + Q_AT, Q, bi, hi, q0, BQ, a.tq, a.h, a.d, c0, vec);
    stage_chunk<T, kPairThreads>(slot + DO_AT, DO, bi, hi, q0, BQ, a.tq, a.h, a.d, c0, vec);
  };

  const TileSpan ktile = key_tile(a, bi, k0);
  TileScan<BQ, false> scan;
  const int tiles = (a.tq + BQ - 1) / BQ;
  int state;
  int tile = scan.next(a, bi, ktile, 0, state);
  if (tile < tiles) load(ring, tile, 0, 0);
  cp_async_commit();

  // this thread's key rows g and g + 8
  const Info ki[2] = {key_info(a, bi, k0 + r0 + g), key_info(a, bi, k0 + r0 + g + 8)};
  float acc[DP / 8][4];      // dV or dK, or (ACC16) the current JAX block's sum
  unsigned acc16[DP / 8][2];  // ACC16: dV or dK as bfloat16 pairs
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    acc16[n][0] = acc16[n][1] = 0u;
  }
  const float mul16 = dk_warp ? bf16r(a.scale) : 1.f;
  int blk = -1;

  int slot = 0, par = 0;
  while (tile < tiles) {
    int next_state;
    const int next = scan.next(a, bi, ktile, tile + 1, next_state);
    const QueryTile<BQ>& qi = qinfo[par];
    const int q0 = tile * BQ;
    // s[n][2r + e] is key row g + 8r, query n * 8 + 2c + e of the tile
    float s[BQ / 8][4];
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    for (int st = 0; st <= nc; ++st) {
      cp_async_wait_all();
      // this step landed; every warp is done with the other slot and with the
      // last tile's P^T
      __syncthreads();
      const T* cur = ring + slot * SLOT;
      T* nxt = ring + (slot ^ 1) * SLOT;
      if (st < nc) load(nxt, tile, st + 1, par);
      else if (next < tiles) load(nxt, next, 0, par ^ 1);
      cp_async_commit();
      slot ^= 1;
      if (st < nc) {
        if (!dk_warp) tile_scores<DP, BQ>(s, cur, cur + Q_AT, r0, lane);   // S^T
        else tile_scores<DP, BQ>(s, cur + V_AT, cur + DO_AT, r0, lane);    // dP^T
        continue;
      }
      if (!dk_warp) {
#pragma unroll
        for (int n = 0; n < BQ / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = n * 8 + 2 * c + e;
            const float lse2 = lse_log2(qi.lse[col]);
            const Info q{qi.pos[col], qi.seg[col], q0 + col < a.tq};
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const bool ok = state == 2 || allowed(a, q, ki[r]);
              float& x = s[n][2 * r + e];
              x = ok ? exp2_approx(fmaf(x, scale2, -lse2)) : 0.f;
            }
          }
          pf[n * 32] = make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
        }
        bar_arrive(1 + pair, 64);
        // dV += P^T dO: dO's slice in V's place
        swept_product<T, BQ, ACC16>(acc, acc16, blk, s, cur + DO_AT, lane, q0, a.tq, jb,
                                    mul16);
      } else {
        bar_sync(1 + pair, 64);
#pragma unroll
        for (int n = 0; n < BQ / 8; ++n) {
          const float4 p = pf[n * 32];
          const int col = n * 8 + 2 * c;
          const float dg0 = qi.gl[col] - qi.di[col], dg1 = qi.gl[col + 1] - qi.di[col + 1];
          s[n][0] = p.x * (s[n][0] + dg0);
          s[n][1] = p.y * (s[n][1] + dg1);
          s[n][2] = p.z * (s[n][2] + dg0);
          s[n][3] = p.w * (s[n][3] + dg1);
        }
        // dK += dS^T Q
        swept_product<T, BQ, ACC16>(acc, acc16, blk, s, cur + Q_AT, lane, q0, a.tq, jb,
                                    mul16);
      }
    }
    tile = next;
    state = next_state;
    par ^= 1;
  }
  cp_async_wait_all();
  if constexpr (ACC16) flush_acc16(acc16, acc, mul16);

  T* out = dk_warp ? dk : dv;
  const float mul = dk_warp ? a.scale : 1.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k0 + r0 + g + 8 * r;
    if (row >= a.tk) continue;
    const long long at = row_offset(bi, hi, row, a.tk, a.h, a.d) + c_out;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n * 8 + 2 * c + e;
        if (c_out + col < a.d)
          out[at + col] = from_f<T>(out_value<ACC16>(acc, acc16, n, r, e, mul));
      }
  }
}

// ------------------------------------------------------------------ launching

// the arms take any head_dim; the grid bounds b * h (y) and tiles * slices (x)
bool valid_wide(const Attn& a) {
  const long long slices = chunks(a.d);
  return a.q && a.k && a.v && a.qp && a.kp && (!a.qs == !a.ks) && a.b >= 1 && a.h >= 1 &&
         a.tq >= 1 && a.tk >= 1 && a.d >= 1 && (long long)a.b * a.h <= 65535 &&
         ((long long)a.tq + kTile - 1) / kTile * slices <= INT_MAX &&
         ((long long)a.tk + kTile - 1) / kTile * slices <= INT_MAX;
}

// a tile's slices run together (its data stay in L2), then the head's next tile
dim3 grid_wide(int t, const Attn& a) {
  return dim3((unsigned)(((t + kTile - 1) / kTile) * chunks(a.d)), a.b * a.h);
}

template <typename T>
cudaError_t fwd_wide(const Attn& a, void* o, float* lse, cudaStream_t s) {
  const size_t smem = fwd_wide_smem<T>();
  cudaError_t e = prepare(flash_fwd_wide_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  flash_fwd_wide_kernel<T><<<grid_wide(a.tq, a), kThreads, smem, s>>>(
      a, vec_copies<T>(a, nullptr), chunks(a.d), static_cast<T*>(o), lse);
  return cudaGetLastError();
}

template <typename T, bool ACC16>
cudaError_t dq_wide(const Attn& a, const Bwd& g, int jb, void* dq, cudaStream_t s) {
  const size_t smem = dq_wide_smem<T>();
  cudaError_t e = prepare(flash_bwd_dq_wide_kernel<T, ACC16>, smem);
  if (e != cudaSuccess) return e;
  flash_bwd_dq_wide_kernel<T, ACC16><<<grid_wide(a.tq, a), kThreads, smem, s>>>(
      a, g, vec_copies<T>(a, g.dout), chunks(a.d), jb, static_cast<T*>(dq));
  return cudaGetLastError();
}

template <typename T, bool ACC16>
cudaError_t dkv_wide(const Attn& a, const Bwd& g, int jb, void* dk, void* dv,
                     cudaStream_t s) {
  const size_t smem = dkv_wide_smem<T>();
  cudaError_t e = prepare(flash_bwd_dkv_wide_kernel<T, ACC16>, smem);
  if (e != cudaSuccess) return e;
  flash_bwd_dkv_wide_kernel<T, ACC16><<<grid_wide(a.tk, a), kPairThreads, smem, s>>>(
      a, g, vec_copies<T>(a, g.dout), chunks(a.d), jb, static_cast<T*>(dk),
      static_cast<T*>(dv));
  return cudaGetLastError();
}

}  // namespace

// As dl4j_flash_fwd, at any head_dim.
extern "C" int dl4j_flash_wide_fwd(const void* q, const void* k, const void* v,
                                   const void* km, const void* qs, const void* ks,
                                   const void* qp, const void* kp, void* o, void* lse,
                                   int b, int h, int tq, int tk, int d, float scale,
                                   int causal, int bf16, void* stream) {
  const Attn a = make_attn(q, k, v, km, qs, ks, qp, kp, b, h, tq, tk, d, scale, causal);
  if (!valid_wide(a) || !o || !lse) return (int)cudaErrorInvalidValue;
  float* l = static_cast<float*>(lse);
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(bf16 ? fwd_wide<__nv_bfloat16>(a, o, l, s) : fwd_wide<float>(a, o, l, s));
}

// As dl4j_flash_bwd_dkv, at any head_dim; acc_block > 0: the bfloat16
// accumulator over JAX query blocks of acc_block rows (0: float32 sums).
extern "C" int dl4j_flash_wide_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* di,
                                       const void* gl, const void* km, const void* qs,
                                       const void* ks, const void* qp, const void* kp,
                                       void* dk, void* dv, int b, int h, int tq, int tk,
                                       int d, float scale, int causal, int bf16,
                                       int acc_block, void* stream) {
  const Attn a = make_attn(q, k, v, km, qs, ks, qp, kp, b, h, tq, tk, d, scale, causal);
  const Bwd g = {dout, static_cast<const float*>(lse), static_cast<const float*>(di),
                 static_cast<const float*>(gl)};
  if (!valid_wide(a) || !dout || !lse || !di || !gl || !dk || !dv || acc_block < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int jb = acc_block;
  cudaError_t e;
  if (bf16)
    e = jb ? dkv_wide<__nv_bfloat16, true>(a, g, jb, dk, dv, s)
           : dkv_wide<__nv_bfloat16, false>(a, g, 1, dk, dv, s);
  else
    e = jb ? dkv_wide<float, true>(a, g, jb, dk, dv, s)
           : dkv_wide<float, false>(a, g, 1, dk, dv, s);
  return (int)e;
}

// As dl4j_flash_bwd_dq, at any head_dim; acc_block > 0: the bfloat16
// accumulator over JAX key blocks of acc_block keys (0: float32 sums).
extern "C" int dl4j_flash_wide_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* di,
                                      const void* gl, const void* km, const void* qs,
                                      const void* ks, const void* qp, const void* kp,
                                      void* dq, int b, int h, int tq, int tk, int d,
                                      float scale, int causal, int bf16, int acc_block,
                                      void* stream) {
  const Attn a = make_attn(q, k, v, km, qs, ks, qp, kp, b, h, tq, tk, d, scale, causal);
  const Bwd g = {dout, static_cast<const float*>(lse), static_cast<const float*>(di),
                 static_cast<const float*>(gl)};
  if (!valid_wide(a) || !dout || !lse || !di || !gl || !dq || acc_block < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int jb = acc_block;
  cudaError_t e;
  if (bf16)
    e = jb ? dq_wide<__nv_bfloat16, true>(a, g, jb, dq, s)
           : dq_wide<__nv_bfloat16, false>(a, g, 1, dq, s);
  else
    e = jb ? dq_wide<float, true>(a, g, jb, dq, s) : dq_wide<float, false>(a, g, 1, dq, s);
  return (int)e;
}
