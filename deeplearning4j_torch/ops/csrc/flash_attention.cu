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
// K4 and K5 (kept simple: CUDA cores; tensor cores are later work): one
// block of 256 threads per (batch * head, 64-row tile). K5 holds a query tile
// and loops over the key tiles (the TPU's sequential grid axis becomes that
// loop); K4 holds a key tile and loops over the query tiles. Splitting dk/dv
// from dq keeps every output owned by one block: no atomics, and the results
// do not depend on the order blocks run in. Tiles are staged in shared memory
// as float32 with an odd row stride (d | 1), so the 16 threads that read 16
// different rows of a tile hit 16 different banks. Thread (ty, tx) =
// (tid / 16, tid % 16) owns tile rows 4ty..4ty+3; in a 64 x 64 score tile it
// holds columns tx + 16j (j < 4), in a 64 x d output tile columns tx + 16m
// (m < d/16). Each score tile goes through shared memory once, as p or ds,
// for the second product.
//
// In all three, unlike the TPU kernels, head_dim is not padded to 128 lanes
// and the time axes need no exact tiling: rows and columns past t are masked
// in the kernel. A whole tile is skipped, for every thread of the block
// alike, when min(kv_pos) > max(q_pos) over its rows (causal) or when its
// query and key segment-id ranges cannot meet (the TPU's _skip_when, with the
// minimum and maximum taken over the tile's data). Dynamic shared memory at
// d = 128 is 149,504 bytes (K5) and 166,656 (K4). Every kernel's shared
// memory is set with cudaFuncSetAttribute before each launch.

#include <climits>
#include <cstdint>
#include <type_traits>
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

__host__ __device__ constexpr int row_stride(int d) { return d | 1; }

// ---------------------------------------------------------------- K3: forward

constexpr int kFwdThreads = 128;  // 4 warps of 16 query rows

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

// Row stride, in elements, of a K3 tile whose head_dim is padded to dp: 16
// bytes past it, so 8 rows read at one column fall in 8 distinct bank groups.
template <typename T>
__host__ __device__ constexpr int fwd_ld(int dp) {
  return dp + 16 / static_cast<int>(sizeof(T));
}

template <int NK> struct KeyTile;

// the query tile, two K and two V tiles, two key tiles' mask data
template <typename T>
size_t fwd_smem(int dp) {
  return (kTile + 4 * fwd_keys<T>()) * fwd_ld<T>(dp) * sizeof(T) +
         2 * sizeof(KeyTile<fwd_keys<T>()>);
}

// dst[r * LD + c] = src(head (bi, hi), row row0 + r, column c) for r < rows
// and c < DP: zero past t and past d. With `vec`, 16-byte cp.async copies
// (the caller commits and waits; columns d .. DP are zeroed once at block
// start): a thread copies one 16-byte column of every (128 / chunks a row)-th
// row; otherwise element by element.
template <typename T, int DP>
__device__ void stage_tile(T* dst, const T* src, int bi, int hi, int row0, int rows,
                           int t, int h, int d, bool vec) {
  constexpr int LD = fwd_ld<T>(DP);
  constexpr int kPer = 16 / sizeof(T);       // elements a copy
  constexpr int kChunks = DP / kPer;         // copies a padded row: 2 .. 32
  constexpr int kStep = kFwdThreads / kChunks;
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
    for (int i = threadIdx.x; i < rows * DP; i += kFwdThreads) {
      const int r = i / DP, c = i - r * DP, row = row0 + r;
      dst[r * LD + c] = row < t && c < d ? src[row_offset(bi, hi, row, t, h, d) + c]
                                         : from_f<T>(0.f);
    }
  }
}

// What the masks need of this block's query tile: the range of its positions
// and of its segment ids, and whether all its rows exist.
struct QTile {
  int plo, phi, slo, shi;
  bool whole;
};

__device__ QTile query_tile(const Attn& a, int bi, int q0) {
  QTile q{0, 0, 0, 0, q0 + kTile <= a.tq};
  if (a.causal) warp_range(a.qp, q0, a.tq, q.plo, q.phi);
  if (a.qs) warp_range(a.qs + (long long)bi * a.tq, q0, a.tq, q.slo, q.shi);
  return q;
}

// tile_live's test of key tile `tile` (NK keys) against the query tile, from
// one lane: 0 when no pair can be allowed (or the tile lies past tk), 2 when
// every pair is (no key mask, no segments, every row and key inside t, every
// key position <= every query position), 1 otherwise.
template <int NK>
__device__ int key_tile_state(const Attn& a, int bi, const QTile& q, int tile) {
  const int k0 = tile * NK;
  if (tile >= (a.tk + NK - 1) / NK) return 0;
  const int n = min(NK, a.tk - k0);
  int plo = INT_MAX, phi = INT_MIN, slo = INT_MAX, shi = INT_MIN;
  const int* seg = a.ks + (long long)bi * a.tk + k0;
#pragma unroll 16
  for (int i = 0; i < NK; ++i)
    if (i < n) {
      if (a.causal) {
        plo = min(plo, a.kp[k0 + i]);
        phi = max(phi, a.kp[k0 + i]);
      }
      if (a.qs) {
        slo = min(slo, seg[i]);
        shi = max(shi, seg[i]);
      }
    }
  if ((a.causal && plo > q.phi) || (a.qs && (slo > q.shi || shi < q.slo))) return 0;
  return !a.km && !a.qs && q.whole && n == NK && (!a.causal || phi <= q.plo) ? 2 : 1;
}

// The live key tiles in order, 32 at a time: lane i of each warp holds the
// state of tile base + i, so the next live tile is a ballot away, and the
// masks' data are read once per 32 tiles (a causal block's run of dead tiles
// past its diagonal costs one read, not one a tile).
template <int NK>
struct TileScan {
  int base = -64, state = 0;

  // the first live tile at or after `tile` (its state in st), or the tile count
  __device__ int next(const Attn& a, int bi, const QTile& q, int tile, int& st) {
    const int tiles = (a.tk + NK - 1) / NK;
    for (; tile < tiles; tile = base + 32) {
      if (tile >= base + 32) {
        base = tile;
        state = key_tile_state<NK>(a, bi, q, base + (threadIdx.x & 31));
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
  constexpr int LD = fwd_ld<float>(DP);
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
  constexpr int LD = fwd_ld<__nv_bfloat16>(DP);
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
  constexpr int LD = fwd_ld<float>(DP);
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
  constexpr int LD = fwd_ld<__nv_bfloat16>(DP);
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

// K and V of the key tile at k0 into one buffer (cp.async or element-wise),
// and the mask data of its keys beside them (cp.async, zero past tk).
template <typename T, int DP>
__device__ __forceinline__ void stage_keys(T* kt, T* vt, KeyTile<fwd_keys<T>()>* info,
                                           const Attn& a, int bi, int hi, int k0,
                                           bool vec) {
  constexpr int BK = fwd_keys<T>();
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
__global__ void __launch_bounds__(kFwdThreads, 2)
flash_fwd_kernel(Attn a, int vec, T* __restrict__ o, float* __restrict__ lse) {
  constexpr int DP = 16 * D16;
  constexpr int LD = fwd_ld<T>(DP);
  constexpr int BK = fwd_keys<T>();
  constexpr float kLog2e = 1.4426950408889634f;
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

  if (vec)  // the padding columns of every tile, which no copy writes
    for (int i = threadIdx.x; i < (kTile + 4 * BK) * (DP - a.d); i += kFwdThreads) {
      const int r = i / (DP - a.d);
      qt[r * LD + a.d + (i - r * (DP - a.d))] = from_f<T>(0.f);
    }
  stage_tile<T, DP>(qt, static_cast<const T*>(a.q), bi, hi, q0, kTile, a.tq, a.h, a.d,
                    vec);
  const QTile qtile = query_tile(a, bi, q0);
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

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T, int D16>
cudaError_t fwd(const Attn& a, void* o, float* lse, cudaStream_t s) {
  const size_t smem = fwd_smem<T>(16 * D16);
  const int vec = a.d * sizeof(T) % 16 == 0 && aligned16(a.q) && aligned16(a.k) &&
                  aligned16(a.v);
  cudaError_t e = prepare(flash_fwd_kernel<T, D16>, smem);
  if (e != cudaSuccess) return e;
  // the query tiles of one head run together, so its K and V stay in L2
  flash_fwd_kernel<T, D16><<<grid_for(a.tq, a), kFwdThreads, smem, s>>>(
      a, vec, static_cast<T*>(o), lse);
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

// K3's D16 is dispatch's DPT: d <= 16, 32, 64, 128 give 1, 2, 4, 8
template <typename T, int D16> struct Fwd {
  static cudaError_t run(Attn a, void* o, float* lse, cudaStream_t s) {
    return fwd<T, D16>(a, o, lse, s);
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
