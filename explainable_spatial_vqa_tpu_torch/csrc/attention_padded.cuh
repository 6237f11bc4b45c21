// K1 at every head dim up to kAttnMaxHeadDim (512) that has no kernel of its
// own (attention.cuh builds one per multiple of 8 up to 128), and the
// attention of K2 and K3 at head dims 256, 384 and 512.  Replaces, at those
// head dims,
// explainable_spatial_vqa_tpu/ops/pallas_attention.py:_fused_attention_bhld,
// which the JAX package runs at any head dim, and the per-head loops of
// ops/pallas_block.py:_block_kernel and :_tiled_kernel.
//
// Arithmetic: attention.cuh's, on the true head dim D: scores in float32
// scaled by 1/sqrt(D), -1e30 on masked keys, a float32 softmax with
// sum + 1e-30; bf16 weights normalised and then rounded to bf16, float32
// weights not rounded; P V summed in float32.
//
// Design.  One instantiation serves every head dim whose padded depth DP
// (padded_depth: D rounded up to 16, or past 128 G = ceil(D / 128) slices
// each rounded up to 16) is its own: D is a run-time argument, the columns
// D .. DP - 1 of every row of Q, K and V in shared memory hold zeros
// (written once a block), which add nothing to a score and make the extra
// output columns zero, which are not stored.  So 17 depths (16, 32, ...,
// 128, 160, 192, 224, 256; 288, 336, 384; 448, 512) cover the 512 head
// dims.
//   * Loads.  K and V stream through attention.cuh's ring of kAttnStages
//     32-key stages with cp.async, kAttnStages - 1 tiles ahead
//     (padded_copy): 16 bytes a copy at a head dim whose rows are whole
//     16-byte chunks (and 16-byte aligned bases and strides).  Elsewhere the
//     deep float32 kernels (D = 275's rows of 1100 bytes) shift each row in
//     shared memory to its source's offset from a 16-byte boundary and copy
//     its middle 16 bytes at a time, its ends 4 (the short kernels too).
//     Every other row that is not whole 16-byte chunks (D = 25: a bf16 head
//     starts every 50 bytes; bf16 rows past 256 keys at odd D) a warp copies
//     element by element, synchronously, into the same ring: the stage it
//     fills was released by the barrier that ended its last tile.
//   * Registers.  Each warp holds one 32-key tile's scores (16 floats a
//     lane) and its share of a 16-row group's output.  Past 128 G warps
//     share a group (G = 2 at DP = 160-256, 3 at 288-384, 4 at 448-512),
//     each a slice of the depth (DG = DP / G, at most 128 columns, 64
//     output floats a lane): each sums the scores over its slice of Q's and
//     K's columns, the slices meet in shared memory (a 2 KB exchange a warp
//     a tile), and every warp of the group adds them in the same order, so
//     all hold the same scores and softmax state and multiply by their own
//     slice of V's columns.  At DP = 256 the float32 kernel's shared memory
//     (Q's 64 rows, the ring, the exchange) is 211 KB, under the H100's 227
//     KB a block, where attention_kernel_f32's 14 warps would need 366 KB.
//   * Past 256 (the deep kernel, attention_kernel_deep_f32: the same code
//     as attention_kernel_padded_f32 under a name of its own, so that the
//     launch counts tell them apart) a block is 2 groups of 16
//     rows (8 warps at four a group), in float32 at three a group (288-384)
//     3 groups, 9 warps (padded_rows), and the ring keeps as many of its
//     kAttnStages stages as fit (padded_stages): float32 at DP = 512 holds Q's 32 rows,
//     two 32-key stages and the exchange in 210 KB.
//   * float32 q, k, v (attention_kernel_padded_f32): the online softmax of
//     attention_kernel_f32, K's and V's tiles alternating in the ring, both
//     products in 3xTF32.
//   * bf16 q, k, v (attention_kernel_padded, depths up to 128; past 128
//     attention_wide.cuh's wgmma kernels take every row): the weights are
//     rounded, so they are normalised first: a first pass over K's tiles
//     takes each row's max and sum online, one tile at a time; a second
//     recomputes each tile's scores (the same products in the same order),
//     normalises, rounds to bf16 and multiplies by V on the tensor cores.
//   * A block is 8 warps up to 256 (4 groups of 16 rows past 128, 8 up to
//     it), 2 or 3 groups past 256, or one group where L <= 16 (the box decoders'
//     L = 8 and 10) up to depth 128.
//   * Past 128, rows of at most 16 keys (the box decoders at d_model
//     768-2048; K2's and K3's attention at 256-512 on such rows) take the
//     short kernels (attention_kernel_short_f32, attention_kernel_short): a
//     block of G warps per (batch, head) whose shared memory holds only Q's,
//     K's and V's 16 rows and the exchange (58 KB in bf16 at depth 512, 103
//     KB in float32, where the padded kernels reserved the whole ring,
//     158-173 KB, and one block filled an SM), copied in one batch, and one
//     16-key tile: 2-7 blocks an SM, at most two waves at B = 128, H = 4.
//     bf16 takes one pass, its row max and sum from the tile's scores in
//     registers: over a single tile the padded kernel's first pass ends with
//     sum * exp(-inf) + cs = cs, so the result is the padded kernel's, bit
//     for bit.
//
// Bound on the H100: as attention.cuh's kernels, the bytes of q, k, v and the
// output at the box decoders' lengths, 4 L^2 D operations (in 3xTF32 for
// float32) at the encoders'.  The padded columns and the narrow loads cost
// work the bound does not count; a right kernel first (PERF.md §6).
//
// Past padded depth 128 attention_wide.cuh's kernels, designed for Hopper,
// take the calls past 16 keys: bf16 at every depth, in rows of any width
// and offset, up to 256 keys in one pass (attention_kernel_wgmma at 160-256,
// attention_kernel_wgmma_deep at 288-512: the executor's fusion layers at
// d_model 768, 1100 and 1280, K3's attention at head dims 384 and 512) and
// past them in two (attention_kernel_wgmma_2pass_deep),
// float32 in rows of whole 16-byte chunks at depth 256 alone, at any length
// (attention_kernel_split_f32); attention_f32_wide.cuh's
// attention_kernel_wide_f32 takes float32 rows of whole 16-byte chunks past
// 16 keys at every other depth past 128 (K2's attention at 384 and 512, K1
// at d_model 544-2048).  The kernels here keep the rest: rows of <= 16 keys
// (the short kernels past depth 128), and float32 rows that are not whole
// 16-byte chunks (D = 275's).
#pragma once

#include "attention.cuh"
#include "attention_f32_wide.cuh"
#include "attention_wide.cuh"

namespace esv {

// The warps sharing a 16-row group at head dim D (1 <= D <= kAttnMaxHeadDim):
// one up to 128, past it one for each 128 columns or part of them
__host__ __device__ constexpr int padded_slices(int D) { return D > 128 ? (D + 127) / 128 : 1; }

// The padded depth of head dim D: D rounded up to 16, or past 128 G =
// padded_slices(D) times its G-th part rounded up to 16 (a depth slice of
// each of G warps)
__host__ __device__ constexpr int padded_depth(int D) {
  return padded_slices(D) * (((D + padded_slices(D) - 1) / padded_slices(D) + 15) / 16 * 16);
}

// warps sharing a 16-row group at depth DP: one up to 128, then one for each
// 128 columns or part of them (2 at 160-256, 3 at 288-384, 4 at 448-512)
template <int DP>
__host__ __device__ constexpr int padded_group() {
  return padded_slices(DP);
}

// Row groups a block past 16 keys: 8 warps up to depth 256 (8 / G groups);
// past it 2 groups, but 3 for float32 at three warps a group (depths
// 288-384: 9 warps; fewer copies of K's and V's tiles per query row took
// D = 275, L = 210 from 1.85 to 1.48 ms on the H100, K2's attention at 384
// from 1.75 to 1.59: PERF.md §6)
template <int DP, typename T>
__host__ __device__ constexpr int padded_rows() {
  return std::is_same<T, float>::value && padded_group<DP>() == 3 ? 3 : 8 / padded_group<DP>();
}

// The padded kernels' shared memory: Q's 16 R rows and S ring stages, of
// LD elements each, and past 128 the exchange of partial scores (16 x 32
// floats a warp)
template <typename T, int DP, int R, int S = kAttnStages>
__host__ __device__ constexpr size_t padded_smem_bytes() {
  return sizeof(T) * (size_t)(16 * R + S * kAttnKeys) * attn_ld<T, DP>() +
         (padded_group<DP>() > 1 ? sizeof(float) * 16 * 32 * padded_group<DP>() * R : 0);
}

// The ring's stages at depth DP with R groups a block: kAttnStages where
// they fit in the H100's 227 KB a block, else as many as fit (at least 2:
// the tile in use and the next)
template <typename T, int DP, int R>
__host__ __device__ constexpr int padded_stages() {
  return padded_smem_bytes<T, DP, R, kAttnStages>() <= kPaddedSmemMax ? kAttnStages
         : padded_smem_bytes<T, DP, R, 3>() <= kPaddedSmemMax         ? 3
                                                                      : 2;
}

// How a block copies its head's rows (padded_copy, padded_load_rows):
//   * kCopyWhole: every row is whole 16-byte chunks on 16-byte boundaries
//     (the launch's `aligned`), 16-byte cp.async copies;
//   * kCopyMiddle (float32, kNarrow): the rows of q, k and v all start
//     `shift` floats past a 16-byte boundary (rs * 4 % 16 == 0): each row
//     lands `shift` floats into its shared-memory row, so its middle copies
//     16 bytes at a time, both sides on 16-byte boundaries, and its ends 4;
//     the kernels read every row from column `shift` (columns 0 .. shift - 1
//     are never written or read; LD leaves 4 columns past DP);
//   * kCopyElements (every other row): element by element, synchronously.
// kNarrow (kCopyMiddle) is compiled into the deep float32 kernels (D = 275)
// and the short kernels alone: its code took the padded kernels at depth 32
// past 128 registers a thread and doubled D = 25's time (PERF.md §6).
enum PaddedCopy : int { kCopyElements = 0, kCopyWhole = 1, kCopyMiddle = 2 };
struct PaddedRows {
  int copy, shift;
};

template <bool kNarrow, typename T>
__device__ __forceinline__ PaddedRows padded_copy(int aligned, const T* q, const T* k, const T* v,
                                                  long long rs) {
  const uintptr_t a[3] = {reinterpret_cast<uintptr_t>(q), reinterpret_cast<uintptr_t>(k),
                          reinterpret_cast<uintptr_t>(v)};
  if (aligned) return {kCopyWhole, 0};
  if (kNarrow && std::is_same<T, float>::value && (rs * 4) % 16 == 0 &&
      a[0] % 16 == a[1] % 16 && a[1] % 16 == a[2] % 16)
    return {kCopyMiddle, (int)(a[0] % 16 / 4)};
  return {kCopyElements, 0};
}

// One row of D elements from s into shared memory at d by `rows`
// (padded_copy), a warp's lanes in turn; zeros where !ok
template <bool kNarrow, typename T>
__device__ __forceinline__ void padded_copy_one(T* d, const T* s, bool ok, int D, PaddedRows rows,
                                                int lane) {
  if (rows.copy == kCopyWhole) {
    constexpr int kPer = 16 / (int)sizeof(T);
    for (int c = lane; c < D / kPer; c += 32) cp_async16(d + c * kPer, s + c * kPer, ok);
  } else if (kNarrow && std::is_same<T, float>::value && rows.copy == kCopyMiddle) {
    // 4-byte ends, a 16-byte middle
    const int head = min((4 - rows.shift) % 4, D), chunks = (D - head) / 4;
    const int tail = head + 4 * chunks;  // the ends: at most 3 floats each
    d += rows.shift;
    if (lane < head) cp_async4_fill(d + lane, s + lane, ok ? 4 : 0);
    for (int c = lane; c < chunks; c += 32) cp_async16(d + head + 4 * c, s + head + 4 * c, ok);
    if (lane < D - tail) cp_async4_fill(d + tail + lane, s + tail + lane, ok ? 4 : 0);
  } else {
    const T zero = from_float<T>(0.f);
    for (int c = lane; c < D; c += 32) d[c] = ok ? s[c] : zero;
  }
}

// rows [row0, row0 + kRows) of a strided head of D columns into shared memory
// rows of stride LD, a warp a row, by `rows` (padded_copy); rows at or past L
// read as zeros
template <typename T, int LD, int kRows, int W, bool kNarrow>
__device__ __forceinline__ void padded_load_rows(T* dst, const T* src, long long rs, int row0,
                                                 int L, int D, PaddedRows rows) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kRows; r += W) {
    const bool ok = row0 + r < L;
    padded_copy_one<kNarrow>(dst + r * LD, src + (long long)(ok ? row0 + r : 0) * rs, ok, D, rows,
                             lane);
  }
}

// The columns D .. DP - 1 of `rows` shared-memory rows set to zero
template <typename T, int LD, int DP, int W>
__device__ __forceinline__ void padded_zero_cols(T* base, int rows, int D) {
  const int width = DP - D;
  if (width <= 0) return;
  const T zero = from_float<T>(0.f);
  for (int i = threadIdx.x; i < rows * width; i += 32 * W)
    base[i / width * LD + D + i % width] = zero;
}

// K's and V's tiles through a ring of S stages, as attention.cuh's
// AttnStream, with the rows loaded by padded_load_rows: with kAlternate tile
// i is K's (even i) or V's (odd i) tile i / 2, else K's tile i.  Tile i +
// S - 1 is issued into the stage of tile i - 1, which the barrier that
// ended tile i - 1's use released.
template <typename T, int LD, int W, bool kAlternate, int S, bool kNarrow>
struct PaddedStream {
  T* ring;
  const T* k;
  const T* v;
  long long rs;
  int L, D, total, issued;
  PaddedRows rows;

  __device__ __forceinline__ PaddedStream(T* ring_, const T* k_, const T* v_, long long rs_,
                                          int L_, int D_, int total_, PaddedRows rows_)
      : ring(ring_), k(k_), v(v_), rs(rs_), L(L_), D(D_), total(total_), issued(0),
        rows(rows_) {
#pragma unroll
    for (int i = 0; i < S - 1; ++i) issue();
  }

  __device__ __forceinline__ void issue() {
    if (issued < total) {
      const bool is_k = !kAlternate || issued % 2 == 0;
      const int kt = kAlternate ? issued / 2 : issued;
      padded_load_rows<T, LD, kAttnKeys, W, kNarrow>(ring + (issued % S) * kAttnKeys * LD,
                                                     is_k ? k : v,
                                            rs, kt * kAttnKeys, L, D, rows);
    }
    cp_async_commit();
    ++issued;
  }

  __device__ __forceinline__ const T* next(int i) {
    issue();
    cp_async_wait<S - 1>();
    __syncthreads();
    return ring + (i % S) * kAttnKeys * LD;
  }
};

// Past 128 (G = 2 to 4): each warp of a group has summed its slice of the
// depth into s (NT 8-key fragments); the slices meet in xs ([warps][4 NT][32]
// floats, fragment order) and every warp of the group takes s = slice 0 +
// slice 1 + ..., the same sum in the same order.  Every thread of the block
// reaches the barrier.
template <int G, int NT>
__device__ __forceinline__ void group_scores(float (&s)[NT][4], float* xs, bool active) {
  if constexpr (G > 1) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, first = warp - warp % G;
    if (active) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) xs[(warp * 4 * NT + n * 4 + c) * 32 + lane] = s[n][c];
    }
    __syncthreads();
    if (active) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float acc = xs[(first * 4 * NT + n * 4 + c) * 32 + lane];
#pragma unroll
          for (int j = 1; j < G; ++j) acc += xs[((first + j) * 4 * NT + n * 4 + c) * 32 + lane];
          s[n][c] = acc;
        }
    }
  }
}

// s scaled and masked for key tile kt (of 32 keys; its first 16 where NT =
// 2): -inf past L, -1e30 on masked keys
template <int NT>
__device__ __forceinline__ void padded_mask(float (&s)[NT][4], const float* mrow, int kt, int L,
                                            float scale) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int key = kt * kAttnKeys + n * 8 + 2 * t + (c & 1);
      float& x = s[n][c];
      x = key >= L ? -INFINITY : (mrow == nullptr || mrow[key] > 0.f ? x * scale : -1e30f);
    }
}

// this warp's rows row and row + 8, if below L, of its output columns col0 +
// 8 dn + {0, 1} that lie below D, one element a store
template <int DG, int N, typename TO>
__device__ __forceinline__ void padded_store(TO* op, long long out_rs, int row, int L, int D,
                                             int col0, const float (&o)[N][4]) {
#pragma unroll
  for (int dn = 0; dn < DG / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = col0 + dn * 8 + e;
      if (col < D) {
        if (row < L) op[(long long)row * out_rs + col] = from_float<TO>(o[dn][e]);
        if (row + 8 < L) op[(long long)(row + 8) * out_rs + col] = from_float<TO>(o[dn][2 + e]);
      }
    }
}

// The padded kernels' arguments, as launch_padded_kernel passes them
#define ESV_PADDED_PARAMS(T)                                                                  \
  const T *__restrict__ q, const T *__restrict__ k, const T *__restrict__ v,                  \
      const float *__restrict__ mask, TO *__restrict__ out, int L, int D, long long in_bs,    \
      long long in_rs, long long out_bs, long long out_rs, float scale, int aligned
#define ESV_PADDED_ARGS q, k, v, mask, out, L, D, in_bs, in_rs, out_bs, out_rs, scale, aligned

// float32 q, k, v at depth DG * G, R groups of 16 rows a block
template <typename TO, int DG, int G, int R>
__device__ __forceinline__ void padded_attention_f32(ESV_PADDED_PARAMS(float)) {
  constexpr int W = G * R, DP = G * DG, LD = attn_ld<float, DP>();
  constexpr int S = padded_stages<float, DP, R>();
  static_assert(DG % 16 == 0 && DG <= 128 && DP <= kAttnMaxHeadDim, "depth");
  extern __shared__ __align__(16) unsigned char attn_smem[];
  float* qs = reinterpret_cast<float*>(attn_smem);   // [16 R][LD]
  float* ring = qs + 16 * R * LD;                     // [S][32][LD]
  float* xs = ring + S * kAttnKeys * LD;              // [W][16][32], G > 1

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * 16 * R;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int grp = warp / G, part = warp % G;
  const long long in_off = (long long)b * in_bs + (long long)h * D;
  const float* mrow = mask == nullptr ? nullptr : mask + (long long)b * L;
  const bool active = q0 + grp * 16 < L;
  // the narrow copies (rows shifted in shared memory) in the deep kernels alone
  constexpr bool kNarrow = G > 2;
  const PaddedRows rows = padded_copy<kNarrow>(aligned, q + in_off, k + in_off, v + in_off, in_rs);
  const int shift = kNarrow ? rows.shift : 0;
  const int col0 = shift + part * DG;  // this warp's slice of each row in shared memory

  padded_zero_cols<float, LD, DP, W>(qs + shift, 16 * R + S * kAttnKeys, D);
  padded_load_rows<float, LD, 16 * R, W, kNarrow>(qs, q + in_off, in_rs, q0, L, D, rows);
  cp_async_commit();
  const int ntiles = (L + kAttnKeys - 1) / kAttnKeys;
  PaddedStream<float, LD, W, true, S, kNarrow> st(ring, k + in_off, v + in_off, in_rs, L, D,
                                                  2 * ntiles, rows);
  const float* qw = qs + grp * 16 * LD + col0;
  AttnOut<float, DG> o;
  float m[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll
  for (int dn = 0; dn < DG / 8; ++dn)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[dn][c] = 0.f;
  for (int kt = 0; kt < ntiles; ++kt) {
    float s[4][4];
    const float* ks = st.next(2 * kt);
    if (active) tile_scores<DG, LD>(qw, ks + col0, s);
    group_scores<G>(s, xs, active);
    __syncthreads();
    if (active) {
      padded_mask(s, mrow, kt, L, scale);
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float tm = -INFINITY;
#pragma unroll
        for (int n = 0; n < 4; ++n) tm = fmaxf(tm, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
        tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 1));
        tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 2));
        const float mn = fmaxf(m[r], tm);  // finite: tile kt holds key kt * 32 < L
        alpha[r] = expf(m[r] - mn);        // 0 on the first tile
        m[r] = mn;
        sum[r] *= alpha[r];
      }
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[n][c] = expf(s[n][c] - m[c / 2]);
          sum[c / 2] += s[n][c];
        }
#pragma unroll
      for (int dn = 0; dn < DG / 8; ++dn)
#pragma unroll
        for (int c = 0; c < 4; ++c) o[dn][c] *= alpha[c / 2];
    }
    const float* vs = st.next(2 * kt + 1);
    if (active) tile_pv<DG, LD>(s, vs + col0, o);
    __syncthreads();
  }
  if (!active) return;
  float denom[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    denom[r] = sum[r] + 1e-30f;
  }
#pragma unroll
  for (int dn = 0; dn < DG / 8; ++dn)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[dn][c] /= denom[c / 2];
  padded_store<DG>(out + (long long)b * out_bs + (long long)h * D, out_rs, q0 + grp * 16 + g, L,
                   D, part * DG + 2 * t, o);
}

// bf16 q, k, v at depth DG * G, R groups of 16 rows a block: the row max and
// sum in a first pass over K's tiles, the normalised weights rounded to bf16
// times V in a second
template <typename TO, int DG, int G, int R>
__device__ __forceinline__ void padded_attention_bf16(ESV_PADDED_PARAMS(__nv_bfloat16)) {
  using T = __nv_bfloat16;
  constexpr int W = G * R, DP = G * DG, LD = attn_ld<T, DP>();
  constexpr int S = padded_stages<T, DP, R>();
  static_assert(DG % 16 == 0 && DG <= 128 && DP <= kAttnMaxHeadDim &&
                    attn_depth<T, DG>() == DG, "depth");
  extern __shared__ __align__(16) unsigned char attn_smem[];
  T* qs = reinterpret_cast<T*>(attn_smem);                              // [16 R][LD]
  T* ring = qs + 16 * R * LD;                                           // [S][32][LD]
  float* xs = reinterpret_cast<float*>(ring + S * kAttnKeys * LD);      // [W][16][32]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * 16 * R;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int grp = warp / G, part = warp % G;
  const long long in_off = (long long)b * in_bs + (long long)h * D;
  const T* kb = k + in_off;
  const T* vb = v + in_off;
  const float* mrow = mask == nullptr ? nullptr : mask + (long long)b * L;
  const bool active = q0 + grp * 16 < L;
  const PaddedRows rows = padded_copy<false>(aligned, q + in_off, kb, vb, in_rs);

  padded_zero_cols<T, LD, DP, W>(qs, 16 * R + S * kAttnKeys, D);
  padded_load_rows<T, LD, 16 * R, W, false>(qs, q + in_off, in_rs, q0, L, D, rows);
  cp_async_commit();
  const int ntiles = (L + kAttnKeys - 1) / kAttnKeys;
  const T* qw = qs + grp * 16 * LD + part * DG;

  // the scaled, masked scores of the group's 16 rows against key tile kt,
  // the same in both passes; the barrier after them frees the tile's stage
  const auto scores = [&](const T* ks, int kt, float (&s)[4][4]) {
    if (active) tile_scores_tc<DG, LD>(qw, ks + part * DG, s);
    group_scores<G>(s, xs, active);
    __syncthreads();
    if (active) padded_mask(s, mrow, kt, L, scale);
  };

  // pass 1: each row's max and sum, online over the tiles
  float m[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
  {
    PaddedStream<T, LD, W, false, S, false> st(ring, kb, vb, in_rs, L, D, ntiles, rows);
    for (int kt = 0; kt < ntiles; ++kt) {
      float s[4][4];
      scores(st.next(kt), kt, s);
      if (!active) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float tm = -INFINITY;
#pragma unroll
        for (int n = 0; n < 4; ++n) tm = fmaxf(tm, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
        tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 1));
        tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 2));
        const float mn = fmaxf(m[r], tm);  // finite: tile kt holds key kt * 32 < L
        float cs = 0.f;
#pragma unroll
        for (int n = 0; n < 4; ++n) cs += expf(s[n][2 * r] - mn) + expf(s[n][2 * r + 1] - mn);
        cs += __shfl_xor_sync(0xffffffffu, cs, 1);
        cs += __shfl_xor_sync(0xffffffffu, cs, 2);
        sum[r] = sum[r] * expf(m[r] - mn) + cs;  // 0 before the first tile
        m[r] = mn;
      }
    }
  }
  const float denom[2] = {sum[0] + 1e-30f, sum[1] + 1e-30f};

  // pass 2: the weights normalised, rounded to bf16 and packed into P V's A
  // fragments, times this warp's half (or all) of V's columns
  AttnOut<T, DG> o;
#pragma unroll
  for (int dn = 0; dn < DG / 8; ++dn)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[dn][c] = 0.f;
  PaddedStream<T, LD, W, true, S, false> st(ring, kb, vb, in_rs, L, D, 2 * ntiles, rows);
  for (int kt = 0; kt < ntiles; ++kt) {
    float s[4][4];
    scores(st.next(2 * kt), kt, s);
    uint32_t p[4][2];
    if (active) {
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          p[n][r] = pack_bf16x2(expf(s[n][2 * r] - m[r]) / denom[r],
                                expf(s[n][2 * r + 1] - m[r]) / denom[r]);
    }
    const T* vs = st.next(2 * kt + 1);
    if (active) tile_pv<DG, LD>(p, vs + part * DG, o);
    __syncthreads();
  }
  if (active)
    padded_store<DG>(out + (long long)b * out_bs + (long long)h * D, out_rs, q0 + grp * 16 + g,
                     L, D, part * DG + 2 * t, o);
}

// The kernels: float32 up to depth 256 (G <= 2) attention_kernel_padded_f32,
// past it (G = 3 or 4) the same code as attention_kernel_deep_f32, counted
// apart; bf16 up to depth 128 attention_kernel_padded (past it
// attention_wide.cuh's wgmma kernels take every row past 16 keys)
template <typename TO, int DG, int G, int R>
__global__ void __launch_bounds__(32 * G * R, 1)
    attention_kernel_padded_f32(ESV_PADDED_PARAMS(float)) {
  static_assert(G <= 2, "past depth 256: attention_kernel_deep_f32");
  padded_attention_f32<TO, DG, G, R>(ESV_PADDED_ARGS);
}

template <typename TO, int DG, int G, int R>
__global__ void __launch_bounds__(32 * G * R, 1)
    attention_kernel_deep_f32(ESV_PADDED_PARAMS(float)) {
  static_assert(G > 2, "up to depth 256: attention_kernel_padded_f32");
  padded_attention_f32<TO, DG, G, R>(ESV_PADDED_ARGS);
}

template <typename TO, int DG, int G, int R>
__global__ void __launch_bounds__(32 * G * R, 1)
    attention_kernel_padded(ESV_PADDED_PARAMS(__nv_bfloat16)) {
  static_assert(G == 1, "past depth 128: attention_wide.cuh's wgmma kernels");
  padded_attention_bf16<TO, DG, G, R>(ESV_PADDED_ARGS);
}

// The short kernels' shared memory at depth DP: Q's, K's and V's 16 rows and
// the exchange of partial scores (16 x 16 floats a warp)
template <typename T, int DP>
__host__ __device__ constexpr size_t short_smem_bytes() {
  return sizeof(T) * (size_t)3 * 16 * attn_ld<T, DP>() +
         sizeof(float) * 16 * 16 * (size_t)padded_group<DP>();
}

// q, k, v of type T at depth DG * G past 128, L <= 16: one (batch, head) a
// block of G warps, each a slice of the depth (the header's Design).  The
// padded kernels' arithmetic over their one tile, on its 16 keys: float32
// the online softmax (its rescaling by exp(-inf) = 0 of nothing), bf16 the
// row max and sum from the tile's scores, the weights normalised, rounded
// and times V in the same pass (the padded kernel's first pass ends with
// sum = 0 * exp(-inf) + cs = cs, its second recomputes the same scores: its
// weights and output bit for bit)
template <typename T, typename TO, int DG, int G>
__device__ __forceinline__ void short_attention(ESV_PADDED_PARAMS(T)) {
  constexpr int DP = G * DG, LD = attn_ld<T, DP>();
  constexpr bool kF32 = std::is_same<T, float>::value;
  static_assert(G > 1 && DG % 16 == 0 && DG <= 128 && DP <= kAttnMaxHeadDim &&
                    attn_depth<T, DG>() == DG, "depth");
  extern __shared__ __align__(16) unsigned char attn_smem[];
  T* qs = reinterpret_cast<T*>(attn_smem);              // [16][LD]
  T* ks = qs + 16 * LD;                                 // [16][LD]
  T* vs = ks + 16 * LD;                                 // [16][LD]
  float* xs = reinterpret_cast<float*>(vs + 16 * LD);   // [G][8][32]

  const int b = blockIdx.z, h = blockIdx.y;
  const int part = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const long long in_off = (long long)b * in_bs + (long long)h * D;
  const float* mrow = mask == nullptr ? nullptr : mask + (long long)b * L;
  const PaddedRows rows = padded_copy<true>(aligned, q + in_off, k + in_off, v + in_off, in_rs);
  const int col0 = rows.shift + part * DG;  // this warp's slice of each row in shared memory

  // Q's, K's and V's rows (contiguous in shared memory) in one batch of
  // copies, a warp a row; rows past L read as zeros
  padded_zero_cols<T, LD, DP, G>(qs + rows.shift, 3 * 16, D);
  for (int r = part; r < 3 * 16; r += G) {
    const bool ok = r % 16 < L;
    const T* src = r < 16 ? q : r < 32 ? k : v;
    padded_copy_one<true>(qs + r * LD, src + in_off + (long long)(ok ? r % 16 : 0) * in_rs, ok, D,
                          rows, lane);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // the scores of the 16 rows against the 16 keys, summed over the slices
  float s[2][4];
  if constexpr (kF32) tile_scores<DG, LD>(qs + col0, ks + col0, s);
  else tile_scores_tc<DG, LD>(qs + col0, ks + col0, s);
  group_scores<G>(s, xs, true);
  padded_mask(s, mrow, 0, L, scale);
  float m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float tm = -INFINITY;
#pragma unroll
    for (int n = 0; n < 2; ++n) tm = fmaxf(tm, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
    tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 1));
    m[r] = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 2));  // finite: key 0 < L
  }
  AttnOut<T, DG> o;
#pragma unroll
  for (int dn = 0; dn < DG / 8; ++dn)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[dn][c] = 0.f;
  float denom[2];
  if constexpr (kF32) {
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[n][c] = expf(s[n][c] - m[c / 2]);
        sum[c / 2] += s[n][c];
      }
    tile_pv<DG, LD>(s, vs + col0, o);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      denom[r] = sum[r] + 1e-30f;
    }
#pragma unroll
    for (int dn = 0; dn < DG / 8; ++dn)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[dn][c] /= denom[c / 2];
  } else {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float cs = 0.f;
#pragma unroll
      for (int n = 0; n < 2; ++n) cs += expf(s[n][2 * r] - m[r]) + expf(s[n][2 * r + 1] - m[r]);
      cs += __shfl_xor_sync(0xffffffffu, cs, 1);
      cs += __shfl_xor_sync(0xffffffffu, cs, 2);
      denom[r] = cs + 1e-30f;
    }
    uint32_t p[2][2];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        p[n][r] = pack_bf16x2(expf(s[n][2 * r] - m[r]) / denom[r],
                              expf(s[n][2 * r + 1] - m[r]) / denom[r]);
    tile_pv<DG, LD>(p, vs + col0, o);
  }
  padded_store<DG>(out + (long long)b * out_bs + (long long)h * D, out_rs, g, L, D,
                   part * DG + 2 * t, o);
}

// The short kernels: float32 q, k, v (attention_kernel_short_f32) and bf16
// (attention_kernel_short), counted apart
template <typename TO, int DG, int G>
__global__ void __launch_bounds__(32 * G) attention_kernel_short_f32(ESV_PADDED_PARAMS(float)) {
  short_attention<float, TO, DG, G>(ESV_PADDED_ARGS);
}

template <typename TO, int DG, int G>
__global__ void __launch_bounds__(32 * G)
    attention_kernel_short(ESV_PADDED_PARAMS(__nv_bfloat16)) {
  short_attention<__nv_bfloat16, TO, DG, G>(ESV_PADDED_ARGS);
}

#undef ESV_PADDED_PARAMS
#undef ESV_PADDED_ARGS

// 1 where every row of every head is whole 16-byte chunks on 16-byte
// boundaries (the kernels' `aligned`: 16-byte copies), else 0
template <typename T>
static int padded_aligned(const T* q, const T* k, const T* v, int D, long long in_bs,
                          long long in_rs) {
  return aligned16(q) && aligned16(k) && aligned16(v) && (D * sizeof(T)) % 16 == 0 &&
         (in_bs * sizeof(T)) % 16 == 0 && (in_rs * sizeof(T)) % 16 == 0;
}

// One instantiation, Kernel, of R groups a block, counted as Kind; its
// shared-memory attribute is set once per device
template <int DP, int R, auto Kernel, AttnKernel Kind, typename T, typename TO>
static cudaError_t launch_padded_kernel(const T* q, const T* k, const T* v, const float* mask,
                                        TO* out, int B, int H, int L, int D, long long in_bs,
                                        long long in_rs, long long out_bs, long long out_rs,
                                        cudaStream_t stream) {
  constexpr int G = padded_group<DP>();
  constexpr size_t smem = padded_smem_bytes<T, DP, R, padded_stages<T, DP, R>()>();
  static_assert(smem <= kPaddedSmemMax, "shared memory");
  int dev;
  const cudaError_t err = once_per_device<KernelSite<Kernel> >(&dev, [](int) {
    return cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  });
  if (err != cudaSuccess) return err;
  const dim3 grid((L + 16 * R - 1) / (16 * R), H, B);
  const float scale = 1.0f / sqrtf((float)D);  // of the true head dim, as the TPU kernel's
  Kernel<<<grid, 32 * G * R, smem, stream>>>(q, k, v, mask, out, L, D, in_bs, in_rs, out_bs,
                                             out_rs, scale,
                                             padded_aligned(q, k, v, D, in_bs, in_rs));
  return counted_launch(Kind);
}

// Kernel, a short kernel at depth DP past 128 (L <= 16), counted as Kind: a
// block of G warps per (batch, head); its shared-memory attribute and the
// whole of the SM's 228 KB as shared memory (so that 2-7 blocks share an SM)
// set once per device
template <int DP, auto Kernel, AttnKernel Kind, typename T, typename TO>
static cudaError_t launch_short_kernel(const T* q, const T* k, const T* v, const float* mask,
                                       TO* out, int B, int H, int L, int D, long long in_bs,
                                       long long in_rs, long long out_bs, long long out_rs,
                                       cudaStream_t stream) {
  constexpr size_t smem = short_smem_bytes<T, DP>();
  static_assert(DP > 128 && smem <= kPaddedSmemMax, "depth, shared memory");
  int dev;
  const cudaError_t err = once_per_device<KernelSite<Kernel> >(&dev, [](int) {
    const cudaError_t e =
        cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(Kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                (int)cudaSharedmemCarveoutMaxShared);
  });
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf((float)D);  // of the true head dim, as the TPU kernel's
  Kernel<<<dim3(1, H, B), 32 * padded_group<DP>(), smem, stream>>>(
      q, k, v, mask, out, L, D, in_bs, in_rs, out_bs, out_rs, scale,
      padded_aligned(q, k, v, D, in_bs, in_rs));
  return counted_launch(Kind);
}

// attention_kernel_short_f32 for float32 q, k, v, attention_kernel_short for
// bf16, at depth DP past 128
template <int DP, typename T, typename TO>
static cudaError_t launch_attention_short(const T* q, const T* k, const T* v, const float* mask,
                                          TO* out, int B, int H, int L, int D, long long in_bs,
                                          long long in_rs, long long out_bs, long long out_rs,
                                          cudaStream_t stream) {
  constexpr int G = padded_group<DP>(), DG = DP / G;
  if constexpr (std::is_same<T, float>::value)
    return launch_short_kernel<DP, attention_kernel_short_f32<TO, DG, G>, kAttnKernelShortF32>(
        q, k, v, mask, out, B, H, L, D, in_bs, in_rs, out_bs, out_rs, stream);
  else
    return launch_short_kernel<DP, attention_kernel_short<TO, DG, G>, kAttnKernelShort>(
        q, k, v, mask, out, B, H, L, D, in_bs, in_rs, out_bs, out_rs, stream);
}

// attention_kernel_padded_f32 (past depth 256 attention_kernel_deep_f32) for
// float32 q, k, v, attention_kernel_padded for bf16 (depths up to 128), at
// depth DP with R groups a block
template <int DP, int R, typename T, typename TO>
static cudaError_t launch_padded_r(const T* q, const T* k, const T* v, const float* mask, TO* out,
                                   int B, int H, int L, int D, long long in_bs, long long in_rs,
                                   long long out_bs, long long out_rs, cudaStream_t stream) {
  constexpr int G = padded_group<DP>(), DG = DP / G;
  if constexpr (std::is_same<T, float>::value && G <= 2)
    return launch_padded_kernel<DP, R, attention_kernel_padded_f32<TO, DG, G, R>,
                                kAttnKernelPaddedF32>(q, k, v, mask, out, B, H, L, D, in_bs,
                                                      in_rs, out_bs, out_rs, stream);
  else if constexpr (std::is_same<T, float>::value)
    return launch_padded_kernel<DP, R, attention_kernel_deep_f32<TO, DG, G, R>,
                                kAttnKernelDeepF32>(q, k, v, mask, out, B, H, L, D, in_bs, in_rs,
                                                    out_bs, out_rs, stream);
  else
    return launch_padded_kernel<DP, R, attention_kernel_padded<TO, DG, G, R>, kAttnKernelPadded>(
        q, k, v, mask, out, B, H, L, D, in_bs, in_rs, out_bs, out_rs, stream);
}

// Head dim D, whose padded depth is DP: past depth 128 the short kernels
// where L <= 16, and attention_wide.cuh's kernels where they take the call
// (wide_takes; bf16 at every depth up to 256 keys, float32 at 256 alone),
// bf16 past 256 keys on attention_wide.cuh's two-pass kernel at every depth,
// attention_f32_wide.cuh's kernel float32 at the other depths (wide_takes);
// else one group a block where L <= 16 (depths up to 128), else 8 warps up
// to depth 256 and 2 or 3 groups past it (padded_rows).  The pointers need only
// their types' alignment.
template <int DP, typename T, typename TO>
static cudaError_t launch_attention_padded(const T* q, const T* k, const T* v, const float* mask,
                                           TO* out, int B, int H, int L, int D, long long in_bs,
                                           long long in_rs, long long out_bs, long long out_rs,
                                           cudaStream_t stream) {
  if (L < 1 || L > kAttnMaxLen || D < 1 || D > kAttnMaxHeadDim || padded_depth(D) != DP)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(q) % sizeof(T) || reinterpret_cast<uintptr_t>(k) % sizeof(T) ||
      reinterpret_cast<uintptr_t>(v) % sizeof(T) || reinterpret_cast<uintptr_t>(out) % sizeof(TO))
    return cudaErrorMisalignedAddress;
  if constexpr (DP > 128) {
    if (L <= 16)
      return launch_attention_short<DP, T, TO>(q, k, v, mask, out, B, H, L, D, in_bs, in_rs,
                                               out_bs, out_rs, stream);
  }
  if constexpr (DP > 128 && (DP == 256 || !std::is_same<T, float>::value)) {
    if (wide_takes<T, TO>(q, k, v, out, L, D, in_bs, in_rs, out_bs, out_rs))
      return launch_attention_wide<DP, T, TO>(q, k, v, mask, out, B, H, L, D, in_bs, in_rs,
                                              out_bs, out_rs, stream);
  }
  if constexpr (DP > 128 && !std::is_same<T, float>::value) {
    // bf16 past kWgmmaMaxKeys keys, rows of any width and offset
    return launch_attention_wgmma_2pass_deep<DP, TO>(q, k, v, mask, out, B, H, L, D, in_bs,
                                                     in_rs, out_bs, out_rs, stream);
  } else {
    if constexpr (DP > 128 && DP != 256 && std::is_same<T, float>::value) {
      if (wide_takes<T, TO>(q, k, v, out, L, D, in_bs, in_rs, out_bs, out_rs))
        return launch_attention_wide_f32<DP, TO>(q, k, v, mask, out, B, H, L, D, in_bs, in_rs,
                                                 out_bs, out_rs, stream);
    }
    if constexpr (DP <= 128) {
      if (L <= 16)
        return launch_padded_r<DP, 1, T, TO>(q, k, v, mask, out, B, H, L, D, in_bs, in_rs,
                                             out_bs, out_rs, stream);
    }
    return launch_padded_r<DP, padded_rows<DP, T>(), T, TO>(q, k, v, mask, out, B, H, L, D,
                                                            in_bs, in_rs, out_bs, out_rs, stream);
  }
}

// The head dims of K2's and K3's attention: the multiples of 128 up to
// kAttnMaxHeadDim (JAX's fused block takes a head dim that is a multiple of
// 128, models/layers.py:_fused_eligible)
__host__ __device__ constexpr bool block_head_dim(int D) {
  return D > 0 && D % 128 == 0 && D <= kAttnMaxHeadDim;
}

// The attention of K2 (float32 q, k, v) and K3 (q, k, v in the weights'
// type), TO the weights' type, at one head dim D of block_head_dim: 128 on
// launch_attention_dim's kernels (K3 past 16 keys on attention_wide.cuh's
// wgmma kernels, one pass up to 256 keys and two past it), 256 on
// attention_wide.cuh's (K2 past 16 keys, K3 from 17 to 256) or the padded
// ones, 384 and 512 on attention_f32_wide.cuh's kernel (K2 past 16 keys),
// attention_wide.cuh's attention_kernel_wgmma_deep (K3 from 17 to 256 keys)
// and attention_kernel_wgmma_2pass_deep (K3 past 256 keys, at 256 too); past
// 128 the short kernels at L <= 16.
// fused_block.cu compiles each head dim in a translation unit of its own and
// picks among them at run time.
template <int D, typename T, typename TO>
static cudaError_t launch_block_attention(const T* q, const T* k, const T* v, const float* mask,
                                          TO* out, int B, int H, int L, long long in_bs,
                                          long long in_rs, long long out_bs, long long out_rs,
                                          cudaStream_t stream) {
  static_assert(block_head_dim(D), "a head dim of K2 and K3");
  if (L > kAttnMaxLen) return cudaErrorInvalidValue;
  if constexpr (D == 128)
    return launch_attention_dim<128, T, TO>(q, k, v, mask, out, B, H, L, in_bs, in_rs, out_bs,
                                            out_rs, stream);
  else
    return launch_attention_padded<D, T, TO>(q, k, v, mask, out, B, H, L, D, in_bs, in_rs,
                                             out_bs, out_rs, stream);
}

}  // namespace esv
