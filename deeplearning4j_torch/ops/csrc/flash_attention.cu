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
#include <initializer_list>
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

// acc[n][.] += p v over the key tile, for the output columns n (< DP / 8) of
// rows LD apart (float32: of a wider tile's, from where vt points). The
// tensor cores' float32 sums drop low bits, so in float32 each output
// column's tile sum starts from zero and joins acc with a rounded float add,
// rather than running on through every key of the row.
template <int DP, int BK, int LD = tile_ld<float>(DP)>
__device__ __forceinline__ void tile_pv(float (&acc)[DP / 8][4],
                                        const float (&p)[BK / 8][4],
                                        const float* vt, int lane) {
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
// The sliced arms, for Hopper: the forward (K3w) and dk/dv (K4w) at head_dim
// > 128, K4 with the JAX package's bfloat16 backward accumulator at any
// head_dim (K4a), and dq at head_dim > 128 (K5w) and with the accumulator
// (K5a). They reuse the mask logic, the skip scan and the mma.sync products of
// the head_dim <= 128 kernels above, whose note describes those.
//
// They replace the same TPU kernels as K3-K5:
// deeplearning4j_tpu/ops/flash_attention.py:_fwd_kernel (K3w), _bwd_dkv_kernel
// (K4w, K4a) and _bwd_dq_kernel (K5w, K5a), which take any head_dim their VMEM
// estimate passes (the JAX package pads head_dim to a multiple of 128 lanes;
// at 128-row blocks its gate passes up to 2,688, more at shorter t), and whose
// backward accumulates in bfloat16 when asked (bwd_acc_dtype="bfloat16").
//
// Bound: operations, as K3-K5: per allowed (i, j) pair 4d flops in K3w (S and
// P V), 8d in K4w (S^T, dP^T, dV, dK) and 6d in K5w, against inputs read once
// (at the wide char model's shape, b 4, t 8192, 4 heads of 256, causal: K3w
// 5.5e11 flops over 0.54 GB of float32 data, some 1,000 flops a byte, far above
// the card's 49 flops a byte at its float32-accurate tensor-core rate and 295
// in bfloat16).
//
// K3w, K4w and K5w: a tile's S computed once, shared across a thread-block
// cluster. Head_dim is cut into nc = ceil(d / 128) chunks of kChunk = 128
// columns. A tile of the block's own side (64 query rows in K3w and K5w, 64
// key rows in K4w) is one cluster of C blocks, one block for each chunk up
// to the portable cluster size of 8 (head_dim <= 1024). Block j (its rank)
// owns chunk j of every operand and the output slice j (columns 128 j ..):
//   K3w: S_j = Q_j K_j^T over its own 128 columns; then O_j += P V_j.
//   K4w: S^T_j = K_j Q_j^T (warps 0-3) and dP^T_j = V_j dO_j^T (warps 4-7);
//        then dV_j += P^T dO_j and dK_j += dS^T Q_j.
//   K5w: S_j = Q_j K_j^T and dP_j = dO_j V_j^T, both in one exchange; then
//        dS = P (dP + g - di) and dQ_j += dS K_j, K_j still in the ring slot
//        of the S step, so K's output slice needs no load of its own.
// The blocks then sum the C partials through distributed shared memory in
// rank order 0 .. C - 1: a pair (C = 2, head_dim <= 256) pushes its partial
// into the peer's shared memory by st.async, which counts its bytes on the
// peer's mbarrier, and adds the one it received once its own mbarrier's
// phase completes (a + b is b + a): no cluster barrier a tile, each block
// waits for its peer's data only. A larger cluster leaves each partial in
// its own block and, after a cluster barrier, every block reads its peers'
// (mapa + ld.shared::cluster). So every block holds the same S (S^T, dP^T)
// bit for bit (K5w also dP), and the same m, l, P and skip states; rank 0
// alone writes the lse. The partial buffers are double-buffered: a block writes a
// buffer (its own, or the peer's) again two tiles later, after every block
// has moved past reading it (a block's tile i + 1 partial, which the others
// wait for, follows its reads of tile i's). A last cluster barrier keeps
// every block resident until its peers are done with it. This is the least
// work, 4d flops a pair in K3w, 8d in K4w and 6d in K5w, and each element of
// Q, K, V and dO is loaded once per pair of tiles: the resident operand, Q_j
// in K3w, K_j and V_j in K4w, Q_j and dO_j in K5w, stays in shared memory
// for the block's whole sweep, and only the other side streams, through a
// two-slot cp.async ring (the next tile loads while this one is computed).
//
// Above 1024 (nc > 8: the JAX gate admits these only at short t, 2,688 at t
// 128, 2,689 at t 64, more below) the passes P = ceil(nc / 8) and the cluster
// C = ceil(nc / P): block j owns the contraction chunks j, j + C, ... (at most
// P) and sums its partial over them, chunk by chunk through the ring, and in
// pass p (one cluster each) owns output slice p C + j. Every pass recomputes
// S: P times the least work in S, for shapes that are rare and short. The
// resident operand is then streamed with the other side (K3w's ring slot
// carries Q's chunk beside K's; K4w reloads its K and V chunks at each step,
// behind a barrier; K5w takes two ring steps a chunk, dO's beside V's and
// then Q's beside K's), so shared memory does not grow with head_dim. The
// steps of a tile visit the block's chunks so that its output chunk comes
// last, and the ring slot of the last step still holds what the products
// need.
//
// bfloat16 products on wgmma, float32 on mma.sync. In bfloat16, K3w's block
// is one warpgroup (128 threads, 64 query rows: wgmma's M of 64): S_j is
// m64n32k16 over the chunk's 128 columns, A (Q_j) and B (K_j) from shared
// memory, and O_j += P V_j is m64n128k16 with P in registers and V_j from
// shared memory read transposed (MN-major). K4w's 256 threads are two
// warpgroups: the first computes S^T_j (m64n64k16) and owns dV_j, the second
// dP^T_j and owns dK_j, each a 64 x 128 float32 accumulator (64 registers a
// thread); P^T passes from the first to the second through shared memory (a
// named barrier of each pair of warps w, w + 4), as in K4. The accumulator
// fragments of wgmma are mma.sync's, so the online softmax, the masks and the
// hand-over run on them unchanged. K5w's bfloat16 block is one warpgroup: S_j
// and dP_j are m64n32k16 (A Q_j or dO_j, B K_j or V_j, from shared memory),
// dQ_j += dS K_j is m64n128k16 with dS in registers and K_j read MN-major;
// its float32 block is two warpgroups (SPLIT): the first computes S_j and p,
// the second dP_j, they swap p and dP through shared memory (a named barrier
// of each pair of warps w, w + 4), both form the same dS, and each adds dS
// K_j to its own 64 of the 128 columns (32 accumulator registers a thread).
// bfloat16 tiles are laid out as wgmma reads them: a [rows x 128] tile is two
// 64-column halves, each rows x 128 bytes with the 128-byte swizzle (16-byte
// granule g of row r at g ^ (r % 8)), from 1024-byte aligned offsets; the
// same tile is a K-major operand (S's B) and an MN-major one (the P V
// product's B). In float32 the products are K3-K5's 3xTF32 m16n8k8 (tf32
// wgmma cannot read B transposed), on tiles padded 16 bytes a row.
//
// What bounds them now: per-tile latency, not the tensor cores. Variants of
// K3w probed on an H100 at the wide char model's shape (b 4, t 8192, 4 heads
// of 256, bfloat16) lost about as much time with every wgmma taken out as
// with the exchange or the tile loads taken out: the chain of a tile (the
// barriers, the exchange, the softmax) at few warps an SM sets the pace. So
// tiles are sized for blocks an SM: K3w's key tiles are 32 rows in bfloat16,
// three blocks an SM (67,344 bytes of shared memory, 168 registers), faster
// there than 48 rows at two blocks or 96 at one, and 24 in float32, two
// blocks (98,384 bytes); K4w's query tiles are 64 and 32 rows, one block of
// 8 warps an SM (183,824 and 178,448 bytes; 216,592 and 211,216 with the
// accumulator). A software pipeline that issued the next tile's S beside
// this tile's P V, with the exchange in between, needed a third ring slot
// and smaller K4w tiles, and lost more than it hid. K5w's key tiles are 32
// rows in both types; both layouts were measured in both types at the wide
// char model's shape (b 4, t 8192, 4 heads of 256, causal; dq_split set to
// one layout for both types in turn, an H100 SXM at 700 W): in bfloat16 one
// warpgroup, two
// blocks an SM (100,112 bytes, 216 registers), took 6.80 ms against 12.39
// for two warpgroups at one block (116,496 bytes); in float32 two
// warpgroups (186,128 bytes, 181 registers) took 24.56 against 27.42 for one
// (242 registers, 4 warps an SM), and 26.20 against 30.38 with the
// accumulator, which two warpgroups keep in registers (16 words a thread,
// 225 registers) and one in shared memory.
//
// Loads: rows of head_dim elements, h d apart. A tile loads by cp.async at the
// widest width that d * element size and every pointer allow: 16 bytes, 8 (a
// 600-byte bfloat16 row of 300), 4, or element by element (odd d in
// bfloat16); zero-filled (reading nothing) past t and past d.
//
// The bfloat16 accumulator (ACC16; the wrapper passes the JAX block size jb):
// the JAX kernels keep dk, dv and dq in a bfloat16 scratch and, once for each
// block of their sequential sweep (jb query rows for K4, jb keys for K5), add
// that block's product: dv = bf16(dv + bf16(P_blk^T dO_blk)), dk = bf16(dk +
// bf16(bf16(dS_blk^T Q_blk) * bf16(scale))), dq likewise with dS_blk K_blk. So
// the result depends on jb. Here a thread sums its tiles' products within one
// JAX block in float32 (the float32 accumulator, which starts each block at
// zero), and at the block's edge rounds it, scales it and adds it into its
// bfloat16 accumulator, so every rounding falls where the JAX kernels' does;
// each cluster block owns its own columns of dK, dV and dQ, so the accumulator
// needs nothing across the cluster. K4a keeps that accumulator as bfloat16
// pairs in shared memory (32 words a thread, a column of its own), as does
// K5a in bfloat16 (one warpgroup); K5a in float32 keeps its 16 words in
// registers. A tile that straddles two JAX blocks (jb not a multiple of the
// tile) is multiplied once per block with the other block's columns zeroed.
// A skipped or fully masked block adds bf16(0), which leaves the sum as it
// was, as in the JAX kernels.
//
namespace {

constexpr int kChunk = 128;      // head_dim columns of a chunk and of an output slice
constexpr int kMaxCluster = 8;   // the portable cluster size

__host__ __device__ inline int chunks(int d) { return (d + kChunk - 1) / kChunk; }

// How K3w, K4w and K5w cut head_dim: nc chunks over `passes` clusters of `cluster`
// blocks; `width` the bytes of a load (16, 8, 4, or the element size); `jb`
// the bfloat16 accumulator's JAX block.
struct Wide {
  int nc, passes, cluster, width, jb;
};

Wide wide_geometry(int d) {
  const int nc = chunks(d), passes = (nc + kMaxCluster - 1) / kMaxCluster;
  return {nc, passes, (nc + passes - 1) / passes, 0, 0};
}

// 8 or 4 bytes from global to shared memory, asynchronously (bytes = 0: zeros)
__device__ __forceinline__ void cp_async8(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes));
}

// Where column c (< 128) of row r of a [rows x kChunk] tile lies: padded rows
// (tile_ld) or, with SWZ, the swizzled bfloat16 layout of wgmma (see above).
template <typename T, bool SWZ>
__device__ __forceinline__ int tile_at(int r, int c, int rows) {
  if constexpr (SWZ) {
    const int w = c & 63;
    return (c >> 6) * rows * 64 + r * 64 + ((((w >> 3) ^ r) & 7) << 3) + (w & 7);
  } else {
    return r * tile_ld<T>(kChunk) + c;
  }
}

// Elements of a [rows x kChunk] tile in shared memory
template <typename T, bool SWZ>
__host__ __device__ constexpr int tile_elems(int rows) {
  return SWZ ? rows * kChunk : rows * tile_ld<T>(kChunk);
}

// A thread copies one column of W bytes of every (NT / copies a row)-th row.
// The loop is kept rolled: unrolled, its addresses are loop-invariant across
// the callers' tile loops and would be hoisted into registers.
template <typename T, int NT, bool SWZ, int W>
__device__ __forceinline__ void stage_w(T* dst, const T* src, int bi, int hi, int row0,
                                        int rows, int t, int h, int d, int c0) {
  constexpr int E = W / sizeof(T);  // elements a copy
  constexpr int PER = kChunk / E;    // copies a tile row (<= NT)
  const int c = (threadIdx.x % PER) * E;
  const bool col_in = c0 + c < d;  // d is a whole number of copies
  const long long stride = (long long)h * d;  // from one row of the head to the next
  const T* p = src + row_offset(bi, hi, row0, t, h, d) + c0 + c;
#pragma unroll 1
  for (int r = threadIdx.x / PER; r < rows; r += NT / PER) {
    const bool in = col_in && row0 + r < t;
    T* to = dst + tile_at<T, SWZ>(r, c, rows);
    const T* from = in ? p + r * stride : src;
    if constexpr (W == 16) cp_async16(to, from, in ? 16 : 0);
    else if constexpr (W == 8) cp_async8(to, from, in ? 8 : 0);
    else if constexpr (W == 4) cp_async4(to, from, in ? 4 : 0);
    else *to = in ? *from : from_f<T>(0.f);
  }
}

// dst(r, c) = src(head (bi, hi), row row0 + r, column c0 + c) for r < rows and
// c < kChunk, zero past t and past d, by the block's NT threads, `width`
// bytes a copy (cp.async: the caller commits and waits; element by element
// below 4 bytes).
template <typename T, int NT, bool SWZ>
__device__ void stage_chunk(T* dst, const T* src, int bi, int hi, int row0, int rows, int t,
                            int h, int d, int c0, int width) {
  switch (width) {
    case 16: stage_w<T, NT, SWZ, 16>(dst, src, bi, hi, row0, rows, t, h, d, c0); break;
    case 8: stage_w<T, NT, SWZ, 8>(dst, src, bi, hi, row0, rows, t, h, d, c0); break;
    case 4: stage_w<T, NT, SWZ, 4>(dst, src, bi, hi, row0, rows, t, h, d, c0); break;
    default:
      stage_w<T, NT, SWZ, sizeof(T)>(dst, src, bi, hi, row0, rows, t, h, d, c0);
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

// What a query tile's queries bring to K4w (cp.async, zero past tq)
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

// --------------------------------------------------------- clusters, wgmma

// A cluster-wide barrier that also orders every block's shared-memory stores
// before the loads (its peers' too) after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// `local`'s counterpart in the shared memory of the cluster's block `rank`
__device__ __forceinline__ unsigned rank_addr(const void* local, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(smem_u32(local)),
               "r"(rank));
  return r;
}

__device__ __forceinline__ float4 ld_cluster(unsigned addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr) : "memory");
  return v;
}

// An mbarrier in shared memory, for the pair's exchange: initialised with one
// arrival a phase; its phase completes when that arrival and the bytes it
// expects (complete_tx) have both come in.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// until the phase of parity `parity` has completed; acquires, at cluster
// scope, what the peer's st.async wrote
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}

// 16 bytes into the peer's shared memory (addr), asynchronously, counted
// on the peer's mbarrier (bar) when they land
__device__ __forceinline__ void st_async(unsigned addr, float4 v, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(addr),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

// The pair's mbarriers, one for each exchange buffer, set up before either
// block pushes into the other (the cluster barrier after)
__device__ __forceinline__ void pair_init(uint64_t* bars) {
  if (threadIdx.x == 0) {
    mbar_init(bars);
    mbar_init(bars + 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();
}

// s, this thread's fragments of a partial product over its block's chunks,
// becomes the sum over the cluster's C blocks, in rank order, so that every
// block holds the same sum bit for bit. buf: this exchange's buffer (NT
// threads' fragments, one float4 each a fragment), of two that exchanges
// take in turn (e counts them). A pair (PAIR, C = 2) pushes its partial into
// the peer's buffer with st.async, counted on the peer's mbarrier of that
// buffer, and waits on its own for the peer's: no cluster barrier, and a + b
// is b + a, so both hold the same sum. The peer writes a buffer again two
// exchanges later, only after this block's next push, which follows its
// reads of this one. Other clusters publish each block's partial and, after
// a cluster barrier, pull the peers' through distributed shared memory.
// Each path is its own instance of the kernels: compiled together, the
// other path's registers made the pair's instances spill more.
template <int NF, int NT, bool PAIR>
__device__ __forceinline__ void cluster_sum(float (&s)[NF][4], float4* buf, uint64_t* bars,
                                            int C, int rank, int e) {
  float4* mine = buf + threadIdx.x;
  if constexpr (PAIR) {
    const unsigned peer = rank_addr(mine, rank ^ 1), bar = rank_addr(bars + (e & 1), rank ^ 1);
#pragma unroll
    for (int n = 0; n < NF; ++n)
      st_async(peer + n * NT * 16, make_float4(s[n][0], s[n][1], s[n][2], s[n][3]), bar);
    if (threadIdx.x == 0) mbar_expect(bars + (e & 1), NF * NT * 16);
    mbar_wait(bars + (e & 1), (e >> 1) & 1);
#pragma unroll
    for (int n = 0; n < NF; ++n) {
      const float4 v = mine[n * NT];
      s[n][0] += v.x, s[n][1] += v.y, s[n][2] += v.z, s[n][3] += v.w;
    }
    return;
  }
  if (C == 1) return;
#pragma unroll
  for (int n = 0; n < NF; ++n) mine[n * NT] = make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
  cluster_sync();
  for (int r = 0; r < C; ++r) {
    const unsigned at = rank_addr(mine, r);
#pragma unroll
    for (int n = 0; n < NF; ++n) {
      const float4 v = r == rank ? mine[n * NT] : ld_cluster(at + n * NT * 16);
      if (r == 0) {
        s[n][0] = v.x, s[n][1] = v.y, s[n][2] = v.z, s[n][3] = v.w;
      } else {
        s[n][0] += v.x, s[n][1] += v.y, s[n][2] += v.z, s[n][3] += v.w;
      }
    }
  }
}

// wgmma's shared-memory matrix descriptor, 128-byte swizzle: lbo and sbo in
// bytes (K-major: sbo from one 8-row group to the next, lbo unused; MN-major:
// lbo from one 64-column half to the next, sbo from one 8-row group to the
// next along K)
__device__ __forceinline__ uint64_t gmma_desc(const void* p, int lbo, int sbo) {
  return (uint64_t)((smem_u32(p) & 0x3ffff) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n"
               "wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Orders the compiler's uses of wgmma's registers around the asynchronous
// product (its issue and its wait)
template <int NF>
__device__ __forceinline__ void fence_regs(float (&d)[NF][4]) {
#pragma unroll
  for (int n = 0; n < NF; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+f"(d[n][j])::"memory");
}

// shared-memory writes of the generic proxy (cp.async, plain stores) made
// visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d += A B^T, m64nNk16, A and B from shared memory, both K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[4][4], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_t(float (&d)[16][4], const unsigned (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_t(float (&d)[8][4], const unsigned (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// s[NF][.] += A B^T over one 128-column chunk: A the block's (warpgroup's) 64
// rows, B N rows, both [rows x 128] tiles of the type's layout. float32:
// 3xTF32 mma.sync, each warp its 16 rows r0 .. r0 + 15 of A. bfloat16: one
// wgmma a 16-column k-step, the warpgroup's 64 rows (warp w holds rows 16 w ..
// in mma.sync's fragment order), the k-step 32 bytes into the swizzled row.
template <int N>
__device__ __forceinline__ void chunk_scores(float (&s)[N / 8][4], const float* a,
                                             const float* b, int r0, int lane) {
  tile_scores<kChunk, N>(s, a, b, r0, lane);
}

template <int N>
__device__ __forceinline__ void chunk_scores(float (&s)[N / 8][4], const __nv_bfloat16* a,
                                             const __nv_bfloat16* b, int, int) {
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kChunk / 16; ++ks) {
    const int half = ks >> 2, at = (ks & 3) * 16;
    wgmma_ss(s, gmma_desc(a + half * kTile * 64 + at, 16, 1024),
             gmma_desc(b + half * N * 64 + at, 16, 1024));
  }
  wgmma_commit_wait();
  fence_regs(s);
}

// acc[NO][.] += x B over N rows of the swept axis: x the rows' fragments
// against B's N rows, B an [N x 128] tile of which acc covers NO * 8 columns
// from where b points (all 128, or one 64-column half). float32: K3-K5's
// tile_pv on the padded rows. bfloat16: one wgmma a k-step of 16 rows, x
// rounded to bfloat16 pairs in registers (A), B read MN-major (its columns
// contiguous; a half is its own 64-column block of the swizzled tile).
template <int N, int NO>
__device__ __forceinline__ void chunk_product(float (&acc)[NO][4],
                                              const float (&x)[N / 8][4], const float* b,
                                              int lane) {
  tile_pv<NO * 8, N, tile_ld<float>(kChunk)>(acc, x, b, lane);
}

template <int N, int NO>
__device__ __forceinline__ void chunk_product(float (&acc)[NO][4],
                                              const float (&x)[N / 8][4],
                                              const __nv_bfloat16* b, int) {
  unsigned pa[N / 16][4];
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    pa[kk][0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    pa[kk][1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    pa[kk][2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    pa[kk][3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
  }
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
    wgmma_rs_t(acc, pa[kk], gmma_desc(b + kk * 16 * 64, N * 128, 1024));
  wgmma_commit_wait();
  fence_regs(acc);
}

// x rounded to bfloat16 (to nearest, ties to even) and back
__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Element e (0, 1) of a bfloat16 pair
__device__ __forceinline__ float bf16_at(unsigned pair, int e) {
  return __uint_as_float(e ? pair & 0xffff0000u : pair << 16);
}

// A thread's bfloat16 accumulator over its NO fragments: element (n, r)
// holds fragment n's elements 2r and 2r + 1 (one row) as a pair. In
// registers (K5a) or in shared memory (K4a: a column of NT words for each
// (n, r), one word a thread).
template <int NO>
struct Acc16Regs {
  unsigned (&a)[NO][2];
  __device__ __forceinline__ unsigned& at(int n, int r) const { return a[n][r]; }
};

template <int NT>
struct Acc16Smem {
  unsigned* p;
  __device__ __forceinline__ unsigned& at(int n, int r) const {
    return p[(2 * n + r) * NT + threadIdx.x];
  }
};

// The bfloat16 accumulator's step at a JAX block's edge, for every element of
// a thread's fragments: acc = bf16(acc + bf16(bf16(part) * mul)), part = 0.
template <int NO, typename A>
__device__ __forceinline__ void flush_acc16(const A& acc, float (&part)[NO][4], float mul) {
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float x0 = bf16r(bf16r(part[n][2 * r]) * mul);
      const float x1 = bf16r(bf16r(part[n][2 * r + 1]) * mul);
      unsigned& a = acc.at(n, r);
      a = pack_bf16(bf16_at(a, 0) + x0, bf16_at(a, 1) + x1);
      part[n][2 * r] = part[n][2 * r + 1] = 0.f;
    }
}

// acc += x V over one tile of the swept axis (keys in K5, queries in K4): x
// holds this warp's rows against the tile's N columns x0 .. x0 + N (of t), V
// the tile's N rows of this block's slice (acc's columns of it). With the
// bfloat16 accumulator, acc is the running float32 sum of the current JAX
// block (blk, of jb columns), flushed into acc16 whenever a tile reaches into
// a new block; a tile that straddles two blocks is multiplied once for each,
// the other's columns zeroed.
template <typename T, int N, bool ACC16, int NO, typename A>
__device__ __forceinline__ void swept_product(float (&acc)[NO][4], const A& acc16, int& blk,
                                              const float (&x)[N / 8][4], const T* vt,
                                              int lane, int x0, int t, int jb, float mul) {
  if constexpr (!ACC16) {
    chunk_product<N>(acc, x, vt, lane);
  } else {
    const int c = lane & 3;
    const int lo = x0 / jb, hi = (min(x0 + N, t) - 1) / jb;
    for (int b = lo; b <= hi; ++b) {
      if (b != blk) {
        flush_acc16(acc16, acc, mul);
        blk = b;
      }
      if (lo == hi) {
        chunk_product<N>(acc, x, vt, lane);
      } else {
        float y[N / 8][4];
#pragma unroll
        for (int n = 0; n < N / 8; ++n)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            y[n][j] = (x0 + n * 8 + 2 * c + (j & 1)) / jb == b ? x[n][j] : 0.f;
        chunk_product<N>(acc, y, vt, lane);
      }
    }
  }
}

// A thread's output value (row half r, column e of fragment n): the bfloat16
// accumulator, or the float32 one times mul.
template <bool ACC16, int NO, typename A>
__device__ __forceinline__ float out_value(const float (&acc)[NO][4], const A& acc16, int n,
                                           int r, int e, float mul) {
  if constexpr (ACC16) return bf16_at(acc16.at(n, r), e);
  else return acc[n][2 * r + e] * mul;
}

// The dynamic shared memory, from its first 1024-byte boundary (the swizzled
// tiles' alignment; the kernels ask for 1024 bytes more)
__device__ __forceinline__ unsigned char* align1024(unsigned char* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// The chunk a block takes at step k (< steps) of a tile: its chunks are rank,
// rank + C, ...; the one of its output slice (index pass) comes last.
__host__ __device__ __forceinline__ int chunk_at(int k, int steps, int rank, int pass, int C) {
  return rank + C * ((pass + 1 + k) % steps);
}

// ------------------------------------------------------------- K3w, clustered

// Key rows of a K3w key tile: 32 in bfloat16 (wgmma's N), 24 in float32; and
// its blocks an SM: three in bfloat16 (67,344 bytes of shared memory, 168
// registers a thread), two in float32
template <typename T>
__host__ __device__ constexpr int cl_keys() {
  return std::is_same<T, float>::value ? 24 : 32;
}

template <typename T>
__host__ __device__ constexpr int fwd_blocks() {
  return std::is_same<T, float>::value ? 2 : 3;
}

// the resident query chunk (one pass), a two-slot ring of [Q chunk (passes >
// 1),] K chunk and V slice, two exchange buffers, two key tiles' mask data
template <typename T>
size_t fwd_cluster_smem(int passes) {
  constexpr bool SWZ = !std::is_same<T, float>::value;
  constexpr int BK = cl_keys<T>();
  const size_t q = tile_elems<T, SWZ>(kTile) * sizeof(T);
  const size_t kv = 2 * tile_elems<T, SWZ>(BK) * sizeof(T);
  return 1024 + (passes == 1 ? q : 0) + 2 * ((passes == 1 ? 0 : q) + kv) +
         2 * (BK / 8) * kThreads * sizeof(float4) + 2 * sizeof(KeyTile<BK>) +
         2 * sizeof(uint64_t);
}

// PAIR: a cluster of two, which exchanges by st.async (cluster_sum)
template <typename T, bool PAIR>
__global__ void __launch_bounds__(kThreads, fwd_blocks<T>())
flash_fwd_cluster_kernel(Attn a, Wide w, T* __restrict__ o, float* __restrict__ lse) {
  constexpr bool WG = !std::is_same<T, float>::value;  // bfloat16: wgmma, swizzled tiles
  constexpr int BK = cl_keys<T>();
  constexpr int NF = BK / 8;
  constexpr int QE = tile_elems<T, WG>(kTile), KE = tile_elems<T, WG>(BK);
  extern __shared__ unsigned char fc_raw[];
  const bool resident = w.passes == 1;  // Q's chunk loads once
  T* qres = reinterpret_cast<T*>(align1024(fc_raw));
  T* ring = qres + (resident ? QE : 0);
  const int slot_elems = (resident ? 0 : QE) + 2 * KE;  // [Q,] K, V
  float4* xbuf = reinterpret_cast<float4*>(ring + 2 * slot_elems);  // [2][NF][kThreads]
  KeyTile<BK>* kinfo = reinterpret_cast<KeyTile<BK>*>(xbuf + 2 * NF * kThreads);  // [2]
  uint64_t* bars = reinterpret_cast<uint64_t*>(kinfo + 2);  // [2] the pair's exchange
  const int lane = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2, c = lane & 3;
  const int bi = blockIdx.y / a.h, hi = blockIdx.y - bi * a.h;
  const int C = w.cluster, rank = blockIdx.x % C, unit = blockIdx.x / C;
  const int pass = unit % w.passes, tile_i = unit / w.passes;
  const int q0 = ((a.tq + kTile - 1) / kTile - 1 - tile_i) * kTile;  // longest tiles first
  const int slice = pass * C + rank;  // the output slice (none past nc)
  const bool has_out = slice < w.nc;
  const int steps = (w.nc - rank + C - 1) / C;  // this block's chunks
  const float scale2 = a.scale * kLog2e;
  const T* Q = static_cast<const T*>(a.q);
  const T* K = static_cast<const T*>(a.k);
  const T* V = static_cast<const T*>(a.v);

  // step k of key tile kt into a ring slot: [Q's and] K's chunk, and with the
  // last step V's slice
  auto load = [&](T* slot, int kt, int k, int par) {
    const int k0 = kt * BK, c0 = chunk_at(k, steps, rank, pass, C) * kChunk;
    T* kdst = slot + (resident ? 0 : QE);
    if (!resident)
      stage_chunk<T, kThreads, WG>(slot, Q, bi, hi, q0, kTile, a.tq, a.h, a.d, c0, w.width);
    stage_chunk<T, kThreads, WG>(kdst, K, bi, hi, k0, BK, a.tk, a.h, a.d, c0, w.width);
    if (k == steps - 1 && has_out)
      stage_chunk<T, kThreads, WG>(kdst + KE, V, bi, hi, k0, BK, a.tk, a.h, a.d,
                                   slice * kChunk, w.width);
    if (k == 0) stage_key_info<BK>(kinfo + par, a, bi, k0);
  };

  const TileSpan qtile = query_tile(a, bi, q0);
  TileScan<BK> scan;
  const int tiles = (a.tk + BK - 1) / BK;
  int state;
  int tile = scan.next(a, bi, qtile, 0, state);
  if (resident)
    stage_chunk<T, kThreads, WG>(qres, Q, bi, hi, q0, kTile, a.tq, a.h, a.d, rank * kChunk,
                                 w.width);
  if (tile < tiles) load(ring, tile, 0, 0);
  cp_async_commit();

  const Info qi[2] = {query_info(a, bi, q0 + r0 + g), query_info(a, bi, q0 + r0 + g + 8)};
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};  // l: this thread's columns only
  float acc[kChunk / 8][4];
#pragma unroll
  for (int n = 0; n < kChunk / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  if constexpr (PAIR) pair_init(bars);
  int slot = 0, par = 0, xchg = 0;
  while (tile < tiles) {
    int next_state;
    const int next = scan.next(a, bi, qtile, tile + 1, next_state);
    const KeyTile<BK>& ki = kinfo[par];
    const int k0 = tile * BK;
    float s[NF][4];
#pragma unroll
    for (int n = 0; n < NF; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    const T* kv = ring;
    for (int k = 0; k < steps; ++k) {
      cp_async_wait_all();
      if constexpr (WG) fence_proxy_async();
      __syncthreads();  // this step landed; every warp is done with the other slot
      const T* cur = ring + slot * slot_elems;
      T* nxt = ring + (slot ^ 1) * slot_elems;
      if (k + 1 < steps) load(nxt, tile, k + 1, par);
      else if (next < tiles) load(nxt, next, 0, par ^ 1);
      cp_async_commit();
      slot ^= 1;
      kv = cur + (resident ? 0 : QE);
      chunk_scores<BK>(s, resident ? qres : cur, kv, r0, lane);  // S_j += Q_c K_c^T
    }
    cluster_sum<NF, kThreads, PAIR>(s, xbuf + (xchg & 1) * NF * kThreads, bars, C, rank,
                                    xchg);  // S, the cluster's sum
    ++xchg;

    // s[n][2r + e] is row g + 8r, key n * 8 + 2c + e of the tile
    float mt[2] = {kNeg, kNeg};
#pragma unroll
    for (int n = 0; n < NF; ++n)
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
    for (int n = 0; n < NF; ++n)
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
    if (has_out) {
#pragma unroll
      for (int n = 0; n < kChunk / 8; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }
      chunk_product<BK>(acc, s, kv + KE, lane);  // O_j += P V_j
    }
    tile = next;
    state = next_state;
    par ^= 1;
  }
  cp_async_wait_all();  // nothing in flight at exit
  if (C > 1) cluster_sync();  // no block leaves while a peer may read its partials

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float sum = quad_sum(l[r]);
    const int row = q0 + r0 + g + 8 * r;
    if (row >= a.tq) continue;
    const float inv = sum > 0.f ? 1.f / sum : 0.f;
    const long long at = row_offset(bi, hi, row, a.tq, a.h, a.d) + slice * kChunk;
    if (has_out) {
#pragma unroll
      for (int n = 0; n < kChunk / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n * 8 + 2 * c + e;
          if (slice * kChunk + col < a.d) o[at + col] = from_f<T>(acc[n][2 * r + e] * inv);
        }
    }
    if (c == 0 && slice == 0)  // m is in log2 units
      lse[((long long)bi * a.tq + row) * a.h + hi] =
          sum > 0.f ? (m[r] + log2f(sum)) / kLog2e : kNeg;
  }
}

// ------------------------------------------------------------- K4w, clustered

// Query rows of a K4w query tile: 64 in bfloat16 (wgmma's N), 32 in float32
template <typename T>
__host__ __device__ constexpr int cl_queries() {
  return std::is_same<T, float>::value ? 32 : 64;
}

// K's and V's chunks, a two-slot ring of Q's and dO's chunks, two exchange
// buffers (S^T's and dP^T's partials), P^T's fragments of the four warp
// pairs, two query tiles' data, and (ACC16) the bfloat16 accumulator
template <typename T>
size_t dkv_cluster_smem(bool acc16) {
  constexpr bool SWZ = !std::is_same<T, float>::value;
  constexpr int BQ = cl_queries<T>();
  return 1024 + 2 * tile_elems<T, SWZ>(kTile) * sizeof(T) +
         4 * tile_elems<T, SWZ>(BQ) * sizeof(T) +
         2 * (BQ / 8) * kPairThreads * sizeof(float4) + 4 * (BQ / 8) * 32 * sizeof(float4) +
         2 * sizeof(QueryTile<BQ>) + (acc16 ? kChunk / 4 * kPairThreads * 4 : 0) +
         2 * sizeof(uint64_t);
}

// K4's four products over the cluster, split between a pair of warps on the
// same 16 key rows (FA2's split; in bfloat16 a warpgroup each): per live
// query tile, the first computes S^T_j = K_j Q_j^T, the second dP^T_j = V_j
// dO_j^T; the cluster sums them; the first takes P^T from each column's
// (query's) lse, hands it to its partner through shared memory and adds
// P^T dO_j to dV_j; the second computes dS^T = P^T (dP^T + g - di) and adds
// dS^T Q_j to dK_j.
template <typename T, bool ACC16, bool PAIR>
__global__ void __launch_bounds__(kPairThreads, 1)
flash_bwd_dkv_cluster_kernel(Attn a, Bwd bw, Wide w, T* __restrict__ dk,
                             T* __restrict__ dv) {
  constexpr bool WG = !std::is_same<T, float>::value;  // bfloat16: wgmma, swizzled tiles
  constexpr int BQ = cl_queries<T>();
  constexpr int NF = BQ / 8;
  constexpr int KE = tile_elems<T, WG>(kTile), QE = tile_elems<T, WG>(BQ);
  extern __shared__ unsigned char dc_raw[];
  T* kv = reinterpret_cast<T*>(align1024(dc_raw));  // K's chunk, then V's
  T* ring = kv + 2 * KE;                            // [2][Q, dO]
  float4* xbuf = reinterpret_cast<float4*>(ring + 4 * QE);  // [2][NF][kPairThreads]
  float4* pt = xbuf + 2 * NF * kPairThreads;                // [4][NF][32] P^T
  QueryTile<BQ>* qinfo = reinterpret_cast<QueryTile<BQ>*>(pt + 4 * NF * 32);  // [2]
  const Acc16Smem<kPairThreads> acc16{reinterpret_cast<unsigned*>(qinfo + 2)};
  uint64_t* bars =  // [2] the pair's exchange
      reinterpret_cast<uint64_t*>(acc16.p + (ACC16 ? kChunk / 4 * kPairThreads : 0));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pair = warp & 3, r0 = pair * 16;
  const bool dk_warp = warp >= 4;  // warps 0-3 own dV, 4-7 dK
  const int g = lane >> 2, c = lane & 3;
  const int bi = blockIdx.y / a.h, hi = blockIdx.y - bi * a.h;
  const int C = w.cluster, rank = blockIdx.x % C, unit = blockIdx.x / C;
  const int pass = unit % w.passes;
  const int k0 = unit / w.passes * kTile;  // key tile 0, the longest under a causal mask, first
  const int slice = pass * C + rank;       // the output slice (none past nc)
  const bool has_out = slice < w.nc;
  const int steps = (w.nc - rank + C - 1) / C;  // this block's chunks
  const bool resident = steps == 1;  // K's and V's chunks load once
  const float scale2 = a.scale * kLog2e;
  float4* pf = pt + pair * NF * 32 + lane;
  const T* Q = static_cast<const T*>(a.q);
  const T* K = static_cast<const T*>(a.k);
  const T* V = static_cast<const T*>(a.v);
  const T* DO = static_cast<const T*>(bw.dout);

  auto load_kv = [&](int k) {
    const int c0 = chunk_at(k, steps, rank, pass, C) * kChunk;
    stage_chunk<T, kPairThreads, WG>(kv, K, bi, hi, k0, kTile, a.tk, a.h, a.d, c0, w.width);
    stage_chunk<T, kPairThreads, WG>(kv + KE, V, bi, hi, k0, kTile, a.tk, a.h, a.d, c0,
                                     w.width);
  };
  // step k of query tile qt into a ring slot: Q's and dO's chunk
  auto load_q = [&](T* slot, int qt, int k, int par) {
    const int q0 = qt * BQ, c0 = chunk_at(k, steps, rank, pass, C) * kChunk;
    stage_chunk<T, kPairThreads, WG>(slot, Q, bi, hi, q0, BQ, a.tq, a.h, a.d, c0, w.width);
    stage_chunk<T, kPairThreads, WG>(slot + QE, DO, bi, hi, q0, BQ, a.tq, a.h, a.d, c0,
                                     w.width);
    if (k == 0) stage_query_info<BQ>(qinfo + par, a, bw, bi, hi, q0);
  };

  const TileSpan ktile = key_tile(a, bi, k0);
  TileScan<BQ, false> scan;
  const int tiles = (a.tq + BQ - 1) / BQ;
  int state;
  int tile = scan.next(a, bi, ktile, 0, state);
  load_kv(0);
  if (tile < tiles) load_q(ring, tile, 0, 0);
  cp_async_commit();

  // this thread's key rows g and g + 8
  const Info ki[2] = {key_info(a, bi, k0 + r0 + g), key_info(a, bi, k0 + r0 + g + 8)};
  float acc[kChunk / 8][4];  // dV or dK, or (ACC16) the current JAX block's sum
#pragma unroll
  for (int n = 0; n < kChunk / 8; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    if constexpr (ACC16) acc16.at(n, 0) = acc16.at(n, 1) = 0u;
  }
  const float mul16 = dk_warp ? bf16r(a.scale) : 1.f;
  int blk = -1;

  if constexpr (PAIR) pair_init(bars);
  int slot = 0, par = 0, xchg = 0;
  while (tile < tiles) {
    int next_state;
    const int next = scan.next(a, bi, ktile, tile + 1, next_state);
    const QueryTile<BQ>& qi = qinfo[par];
    const int q0 = tile * BQ;
    // s[n][2r + e] is key row g + 8r, query n * 8 + 2c + e of the tile
    float s[NF][4];
#pragma unroll
    for (int n = 0; n < NF; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    const T* cur = ring;
    for (int k = 0; k < steps; ++k) {
      cp_async_wait_all();
      if constexpr (WG) fence_proxy_async();
      // this step landed; every warp is done with the other slot and with the
      // last tile's P^T
      __syncthreads();
      cur = ring + slot * 2 * QE;
      T* nxt = ring + (slot ^ 1) * 2 * QE;
      if (k + 1 < steps) load_q(nxt, tile, k + 1, par);
      else if (next < tiles) load_q(nxt, next, 0, par ^ 1);
      cp_async_commit();
      slot ^= 1;
      if (!dk_warp) chunk_scores<BQ>(s, kv, cur, r0, lane);  // S^T_j += K_c Q_c^T
      else chunk_scores<BQ>(s, kv + KE, cur + QE, r0, lane);  // dP^T_j += V_c dO_c^T
      if (!resident && (k + 1 < steps || next < tiles)) {
        __syncthreads();  // every warp is done with this step's K and V chunks
        load_kv(k + 1 < steps ? k + 1 : 0);
        cp_async_commit();
      }
    }
    cluster_sum<NF, kPairThreads, PAIR>(s, xbuf + (xchg & 1) * NF * kPairThreads, bars, C,
                                        rank, xchg);
    ++xchg;
    if (!dk_warp) {
#pragma unroll
      for (int n = 0; n < NF; ++n) {
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
      if (has_out)  // dV_j += P^T dO_j
        swept_product<T, BQ, ACC16>(acc, acc16, blk, s, cur + QE, lane, q0, a.tq, w.jb,
                                    mul16);
    } else {
      bar_sync(1 + pair, 64);
#pragma unroll
      for (int n = 0; n < NF; ++n) {
        const float4 p = pf[n * 32];
        const int col = n * 8 + 2 * c;
        const float dg0 = qi.gl[col] - qi.di[col], dg1 = qi.gl[col + 1] - qi.di[col + 1];
        s[n][0] = p.x * (s[n][0] + dg0);
        s[n][1] = p.y * (s[n][1] + dg1);
        s[n][2] = p.z * (s[n][2] + dg0);
        s[n][3] = p.w * (s[n][3] + dg1);
      }
      if (has_out)  // dK_j += dS^T Q_j
        swept_product<T, BQ, ACC16>(acc, acc16, blk, s, cur, lane, q0, a.tq, w.jb, mul16);
    }
    tile = next;
    state = next_state;
    par ^= 1;
  }
  cp_async_wait_all();
  if (C > 1) cluster_sync();  // no block leaves while a peer may read its partials
  if (!has_out) return;
  if constexpr (ACC16) flush_acc16(acc16, acc, mul16);

  T* out = dk_warp ? dk : dv;
  const float mul = dk_warp ? a.scale : 1.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k0 + r0 + g + 8 * r;
    if (row >= a.tk) continue;
    const long long at = row_offset(bi, hi, row, a.tk, a.h, a.d) + slice * kChunk;
#pragma unroll
    for (int n = 0; n < kChunk / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n * 8 + 2 * c + e;
        if (slice * kChunk + col < a.d)
          out[at + col] = from_f<T>(out_value<ACC16>(acc, acc16, n, r, e, mul));
      }
  }
}

// ------------------------------------------------------------- K5w, clustered

// K5w's layout (the faster of the two, by type; see the note): in float32
// two warpgroups (SPLIT: the first computes S and its half of dQ_j's columns,
// the second dP and the other half), one block an SM; in bfloat16 one
// warpgroup for all three products, two blocks an SM. Key tiles of 32 keys
// (wgmma's N in bfloat16).
template <typename T>
__host__ __device__ constexpr bool dq_split() {
  return std::is_same<T, float>::value;
}

constexpr int kDqKeys = 32;

// K5w's ring steps a key tile, for block `rank`: one in one pass; above, two
// for each of its chunks
__host__ __device__ inline int dq_ring_steps(Wide w, int rank) {
  return w.passes == 1 ? 1 : 2 * ((w.nc - rank + w.cluster - 1) / w.cluster);
}

// Ring step k of a K5w key tile, block `rank` of pass `pass`: the chunk it
// loads, and which operands (`scores`: Q's and K's, `dots`: dO's and V's).
// In one pass K's and V's chunk `rank` (Q's and dO's stay resident); above,
// each of the block's chunks in chunk_at's order, dO's and V's, then Q's
// and K's, so that the last step holds K's chunk of the output slice.
struct DqStep {
  int chunk;
  bool scores, dots;
};

__host__ __device__ inline DqStep dq_ring_step(Wide w, int k, int rank, int pass) {
  if (w.passes == 1) return {rank, true, true};
  const int steps = dq_ring_steps(w, rank) / 2;
  return {chunk_at(k >> 1, steps, rank, pass, w.cluster), (k & 1) != 0, (k & 1) == 0};
}

template <typename T>
__host__ __device__ constexpr int dq_threads() {
  return dq_split<T>() ? kPairThreads : kThreads;
}

template <typename T>
__host__ __device__ constexpr int dq_blocks() {
  return dq_split<T>() ? 1 : 2;
}

// Q's and dO's chunks (one pass), a two-slot ring of K's and V's chunks
// (one pass) or of a Q or dO chunk beside a K or V chunk (passes > 1), two
// exchange buffers, (SPLIT) P's and dP's hand-over of the four warp pairs,
// two key tiles' mask data, (ACC16, one warpgroup) the bfloat16 accumulator
template <typename T>
size_t dq_cluster_smem(int passes, bool acc16) {
  constexpr bool SWZ = !std::is_same<T, float>::value, SPLIT = dq_split<T>();
  constexpr int NF = kDqKeys / 8;
  const size_t q = tile_elems<T, SWZ>(kTile) * sizeof(T);
  const size_t k = tile_elems<T, SWZ>(kDqKeys) * sizeof(T);
  const bool one = passes == 1;
  return 1024 + (one ? 2 * q : 0) + 2 * (one ? 2 * k : q + k) +
         2 * 2 * NF * kThreads * sizeof(float4) + (SPLIT ? 2 * 4 * NF * 32 * sizeof(float4) : 0) +
         2 * sizeof(KeyTile<kDqKeys>) + (acc16 && !SPLIT ? kChunk / 4 * kThreads * 4 : 0) +
         2 * sizeof(uint64_t);
}

// K5's products over the cluster: per live key tile, S_j = Q_j K_j^T and
// dP_j = dO_j V_j^T over the block's own columns, summed across the cluster
// (both in one exchange); p from the saved lse, dS = p (dP + g - di), and
// dQ_j += dS K_j over the block's own output columns, K_j read from the ring
// slot of the tile's last step. SPLIT: the first warpgroup computes S and
// p, the second dP; they swap p and dP through shared memory (a named
// barrier of each pair of warps w, w + 4), both form the same dS, and each
// adds dS K_j to its 64 of the 128 columns.
template <typename T, bool ACC16, bool PAIR>
__global__ void __launch_bounds__(dq_threads<T>(), dq_blocks<T>())
flash_bwd_dq_cluster_kernel(Attn a, Bwd bw, Wide w, T* __restrict__ dq) {
  constexpr bool WG = !std::is_same<T, float>::value;  // bfloat16: wgmma, swizzled tiles
  constexpr bool SPLIT = dq_split<T>();
  constexpr int NT = dq_threads<T>();
  constexpr int BK = kDqKeys;
  constexpr int NF = BK / 8;
  constexpr int NX = SPLIT ? NF : 2 * NF;              // fragments a thread exchanges
  constexpr int NO = SPLIT ? kChunk / 16 : kChunk / 8;  // output fragments a thread
  constexpr int QE = tile_elems<T, WG>(kTile), KE = tile_elems<T, WG>(BK);
  extern __shared__ unsigned char dqc_raw[];
  const bool resident = w.passes == 1;  // Q's and dO's chunks load once
  T* qres = reinterpret_cast<T*>(align1024(dqc_raw));  // [Q, dO] (one pass)
  T* ring = qres + (resident ? 2 * QE : 0);
  const int slot_elems = resident ? 2 * KE : QE + KE;  // [K, V], or [Q or dO, K or V]
  float4* xbuf = reinterpret_cast<float4*>(ring + 2 * slot_elems);  // [2][NX][NT]
  float4* hand = xbuf + 2 * NX * NT;  // SPLIT: [2][4][NF][32], p then dP
  KeyTile<BK>* kinfo = reinterpret_cast<KeyTile<BK>*>(hand + (SPLIT ? 2 * 4 * NF * 32 : 0));
  unsigned* acc16_smem = reinterpret_cast<unsigned*>(kinfo + 2);
  uint64_t* bars =  // [2] the pair's exchange
      reinterpret_cast<uint64_t*>(acc16_smem + (ACC16 && !SPLIT ? kChunk / 4 * NT : 0));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = SPLIT ? warp >> 2 : 0;  // SPLIT: 0 computes S, 1 dP
  const int r0 = (warp & 3) * 16;
  const int g = lane >> 2, c = lane & 3;
  const int bi = blockIdx.y / a.h, hi = blockIdx.y - bi * a.h;
  const int C = w.cluster, rank = blockIdx.x % C, unit = blockIdx.x / C;
  const int pass = unit % w.passes, tile_i = unit / w.passes;
  const int q0 = ((a.tq + kTile - 1) / kTile - 1 - tile_i) * kTile;  // longest tiles first
  const int slice = pass * C + rank;  // the output slice (none past nc)
  const bool has_out = slice < w.nc;
  const int ring_steps = dq_ring_steps(w, rank);
  const float scale2 = a.scale * kLog2e;
  const T* Q = static_cast<const T*>(a.q);
  const T* K = static_cast<const T*>(a.k);
  const T* V = static_cast<const T*>(a.v);
  const T* DO = static_cast<const T*>(bw.dout);

  // ring step k of key tile kt (dq_ring_step): K's and V's chunks (one
  // pass), else a Q or dO chunk beside a K or V chunk
  auto load = [&](T* slot, int kt, int k, int par) {
    const int k0 = kt * BK;
    const DqStep st = dq_ring_step(w, k, rank, pass);
    const int c0 = st.chunk * kChunk;
    if (resident) {
      stage_chunk<T, NT, WG>(slot, K, bi, hi, k0, BK, a.tk, a.h, a.d, c0, w.width);
      stage_chunk<T, NT, WG>(slot + KE, V, bi, hi, k0, BK, a.tk, a.h, a.d, c0, w.width);
    } else {
      stage_chunk<T, NT, WG>(slot, st.scores ? Q : DO, bi, hi, q0, kTile, a.tq, a.h, a.d, c0,
                             w.width);
      stage_chunk<T, NT, WG>(slot + QE, st.scores ? K : V, bi, hi, k0, BK, a.tk, a.h, a.d, c0,
                             w.width);
    }
    if (k == 0) stage_key_info<BK>(kinfo + par, a, bi, k0);
  };

  const TileSpan qtile = query_tile(a, bi, q0);
  TileScan<BK> scan;
  const int tiles = (a.tk + BK - 1) / BK;
  int state;
  int tile = scan.next(a, bi, qtile, 0, state);
  if (resident) {
    stage_chunk<T, NT, WG>(qres, Q, bi, hi, q0, kTile, a.tq, a.h, a.d, rank * kChunk, w.width);
    stage_chunk<T, NT, WG>(qres + QE, DO, bi, hi, q0, kTile, a.tq, a.h, a.d, rank * kChunk,
                           w.width);
  }
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
  float acc[NO][4];  // dQ_j (this warpgroup's columns), or (ACC16) the JAX block's sum
  unsigned acc16r[NO][2];
  const auto acc16 = [&] {
    if constexpr (SPLIT) return Acc16Regs<NO>{acc16r};
    else return Acc16Smem<NT>{acc16_smem};
  }();
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    if constexpr (ACC16) acc16.at(n, 0) = acc16.at(n, 1) = 0u;
  }
  const float mul16 = bf16r(a.scale);  // the JAX kernel's scale, a bfloat16 there
  int blk = -1;

  if constexpr (PAIR) pair_init(bars);
  int slot = 0, par = 0, xchg = 0;
  while (tile < tiles) {
    int next_state;
    const int next = scan.next(a, bi, qtile, tile + 1, next_state);
    const KeyTile<BK>& ki = kinfo[par];
    const int k0 = tile * BK;
    // sd[n][2r + e] is row g + 8r, key n * 8 + 2c + e of the tile: S in
    // fragments 0 .. NF - 1 and dP after them, or (SPLIT) this warpgroup's one
    float sd[NX][4];
#pragma unroll
    for (int n = 0; n < NX; ++n) sd[n][0] = sd[n][1] = sd[n][2] = sd[n][3] = 0.f;
    float (&s)[NF][4] = *reinterpret_cast<float (*)[NF][4]>(&sd[0]);
    float (&dp)[NF][4] = *reinterpret_cast<float (*)[NF][4]>(&sd[NX - NF]);
    const T* cur = ring;
    for (int k = 0; k < ring_steps; ++k) {
      cp_async_wait_all();
      if constexpr (WG) fence_proxy_async();
      // this step landed; every warp is done with the other slot and with the
      // last tile's hand-over
      __syncthreads();
      cur = ring + slot * slot_elems;
      T* nxt = ring + (slot ^ 1) * slot_elems;
      if (k + 1 < ring_steps) load(nxt, tile, k + 1, par);
      else if (next < tiles) load(nxt, next, 0, par ^ 1);
      cp_async_commit();
      slot ^= 1;
      const DqStep st = dq_ring_step(w, k, rank, pass);
      if (st.scores && wg == 0)  // S_j += Q_c K_c^T
        chunk_scores<BK>(s, resident ? qres : cur, resident ? cur : cur + QE, r0, lane);
      if (st.dots && wg == (SPLIT ? 1 : 0))  // dP_j += dO_c V_c^T
        chunk_scores<BK>(dp, resident ? qres + QE : cur, cur + (resident ? KE : QE), r0,
                         lane);
    }
    cluster_sum<NX, NT, PAIR>(sd, xbuf + (xchg & 1) * NX * NT, bars, C, rank, xchg);
    ++xchg;

    // p, masked, from S (the first warpgroup's fragments)
    auto prob = [&](int n, int j) {
      const int col = n * 8 + 2 * c + (j & 1), r = j >> 1;
      const bool ok = state == 2 || allowed(a, qi[r],
                                            {ki.pos[col], ki.seg[col],
                                             k0 + col < a.tk && (!a.km || ki.km[col] > 0.f)});
      return ok ? exp2_approx(fmaf(s[n][j], scale2, -lse2[r])) : 0.f;
    };
    if constexpr (SPLIT) {
      // the pair swaps p and dP, and both form dS = p (dP + g - di) alike
      float4* mine = hand + (wg * 4 + (warp & 3)) * NF * 32 + lane;
      const float4* theirs = hand + ((wg ^ 1) * 4 + (warp & 3)) * NF * 32 + lane;
#pragma unroll
      for (int n = 0; n < NF; ++n) {
        if (wg == 0)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[n][j] = prob(n, j);
        mine[n * 32] = make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
      }
      bar_sync(1 + (warp & 3), 64);
#pragma unroll
      for (int n = 0; n < NF; ++n) {
        const float4 o = theirs[n * 32];
        const float other[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = wg == 0 ? s[n][j] : other[j], d = wg == 0 ? other[j] : s[n][j];
          s[n][j] = p * (d + dg[j >> 1]);
        }
      }
    } else {
#pragma unroll
      for (int n = 0; n < NF; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[n][j] = prob(n, j) * (dp[n][j] + dg[j >> 1]);
    }
    if (has_out)  // dQ_j += dS K_j, K_j (K's output chunk) in the last step's slot
      swept_product<T, BK, ACC16>(acc, acc16, blk, s,
                                  (resident ? cur : cur + QE) + tile_at<T, WG>(0, 64 * wg, BK),
                                  lane, k0, a.tk, w.jb, mul16);
    tile = next;
    state = next_state;
    par ^= 1;
  }
  cp_async_wait_all();  // nothing in flight at exit
  if (C > 1) cluster_sync();  // no block leaves while a peer may read its partials
  if (!has_out) return;
  if constexpr (ACC16) flush_acc16(acc16, acc, mul16);

  const int c_out = slice * kChunk + 64 * wg;  // this warpgroup's first column
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + g + 8 * r;
    if (row >= a.tq) continue;
    const long long at = row_offset(bi, hi, row, a.tq, a.h, a.d) + c_out;
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n * 8 + 2 * c + e;
        if (c_out + col < a.d)
          dq[at + col] = from_f<T>(out_value<ACC16>(acc, acc16, n, r, e, a.scale));
      }
  }
}

// ------------------------------------------------------------------ launching

// the arms take any head_dim; the grid bounds b * h (y) and tiles * passes *
// cluster (x)
bool valid_wide(const Attn& a) {
  const Wide w = wide_geometry(a.d);
  const long long per_tile = (long long)w.passes * w.cluster;
  return a.q && a.k && a.v && a.qp && a.kp && (!a.qs == !a.ks) && a.b >= 1 && a.h >= 1 &&
         a.tq >= 1 && a.tk >= 1 && a.d >= 1 && (long long)a.b * a.h <= 65535 &&
         ((long long)a.tq + kTile - 1) / kTile * per_tile <= INT_MAX &&
         ((long long)a.tk + kTile - 1) / kTile * per_tile <= INT_MAX;
}

// The widest load (16, 8 or 4 bytes, else one element) that rows of d
// elements of T and every pointer given allow
template <typename T>
int load_width(int d, std::initializer_list<const void*> ptrs) {
  for (int w : {16, 8, 4}) {
    bool ok = d * sizeof(T) % w == 0;
    for (const void* p : ptrs) ok = ok && reinterpret_cast<uintptr_t>(p) % w == 0;
    if (ok) return w;
  }
  return sizeof(T);
}

// K3w, K4w, K5w: one cluster of w.cluster blocks for each (tile, pass); a
// cluster of 1 launches plainly
template <typename... P, typename... Args>
cudaError_t launch_cluster(void (*kernel)(P...), int t, const Attn& a, const Wide& w,
                           int threads, size_t smem, cudaStream_t s, Args... args) {
  cudaError_t e = prepare(kernel, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(((t + kTile - 1) / kTile) * w.passes * w.cluster), a.b * a.h);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = w.cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = w.cluster > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename T>
cudaError_t fwd_wide(const Attn& a, void* o, float* lse, cudaStream_t s) {
  Wide w = wide_geometry(a.d);
  w.width = load_width<T>(a.d, {a.q, a.k, a.v});
  const auto kernel = w.cluster == 2 ? flash_fwd_cluster_kernel<T, true>
                                     : flash_fwd_cluster_kernel<T, false>;
  return launch_cluster(kernel, a.tq, a, w, kThreads, fwd_cluster_smem<T>(w.passes), s, a, w,
                        static_cast<T*>(o), lse);
}

template <typename T, bool ACC16>
cudaError_t dq_wide(const Attn& a, const Bwd& g, int jb, void* dq, cudaStream_t s) {
  Wide w = wide_geometry(a.d);
  w.width = load_width<T>(a.d, {a.q, a.k, a.v, g.dout});
  w.jb = jb;
  const auto kernel = w.cluster == 2 ? flash_bwd_dq_cluster_kernel<T, ACC16, true>
                                     : flash_bwd_dq_cluster_kernel<T, ACC16, false>;
  return launch_cluster(kernel, a.tq, a, w, dq_threads<T>(), dq_cluster_smem<T>(w.passes, ACC16),
                        s, a, g, w, static_cast<T*>(dq));
}

template <typename T, bool ACC16>
cudaError_t dkv_wide(const Attn& a, const Bwd& g, int jb, void* dk, void* dv,
                     cudaStream_t s) {
  Wide w = wide_geometry(a.d);
  w.width = load_width<T>(a.d, {a.q, a.k, a.v, g.dout});
  w.jb = jb;
  const auto kernel = w.cluster == 2 ? flash_bwd_dkv_cluster_kernel<T, ACC16, true>
                                     : flash_bwd_dkv_cluster_kernel<T, ACC16, false>;
  return launch_cluster(kernel, a.tk, a, w, kPairThreads, dkv_cluster_smem<T>(ACC16), s, a, g,
                        w, static_cast<T*>(dk), static_cast<T*>(dv));
}

}  // namespace

// The sliced arms' geometry at head_dim d (bf16: bfloat16 inputs), as the
// launches take it: out = {chunks, passes, cluster, K3w's dynamic shared
// bytes, K4w's, K4a's, K5w's, K5a's}.
extern "C" int dl4j_flash_wide_geometry(int d, int bf16, long long* out) {
  if (d < 1 || !out) return (int)cudaErrorInvalidValue;
  const Wide w = wide_geometry(d);
  out[0] = w.nc;
  out[1] = w.passes;
  out[2] = w.cluster;
  out[3] = (long long)(bf16 ? fwd_cluster_smem<__nv_bfloat16>(w.passes)
                            : fwd_cluster_smem<float>(w.passes));
  out[4] = (long long)(bf16 ? dkv_cluster_smem<__nv_bfloat16>(false)
                            : dkv_cluster_smem<float>(false));
  out[5] = (long long)(bf16 ? dkv_cluster_smem<__nv_bfloat16>(true)
                            : dkv_cluster_smem<float>(true));
  for (int acc16 = 0; acc16 < 2; ++acc16)
    out[6 + acc16] =
        (long long)(bf16 ? dq_cluster_smem<__nv_bfloat16>(w.passes, acc16)
                         : dq_cluster_smem<float>(w.passes, acc16));
  return 0;
}

// K5w's ring steps of one key tile at head_dim d, as block `rank` of pass
// `pass` takes them (dq_ring_step): out[2i] the chunk of step i, out[2i + 1]
// its operands (0: K's and V's, 1: dO's and V's, 2: Q's and K's). Returns
// the number of steps, or -1 (rank or pass out of range, or more than cap).
extern "C" int dl4j_flash_wide_dq_ring(int d, int rank, int pass, int* out, int cap) {
  if (d < 1 || !out) return -1;
  const Wide w = wide_geometry(d);
  if (rank < 0 || rank >= w.cluster || pass < 0 || pass >= w.passes) return -1;
  const int n = dq_ring_steps(w, rank);
  if (n > cap) return -1;
  for (int k = 0; k < n; ++k) {
    const DqStep st = dq_ring_step(w, k, rank, pass);
    out[2 * k] = st.chunk;
    out[2 * k + 1] = st.scores && st.dots ? 0 : st.dots ? 1 : 2;
  }
  return n;
}

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
