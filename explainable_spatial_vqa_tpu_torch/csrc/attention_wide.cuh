// K1 at the head dims whose padded depth is 256 (225-256, among them 256: 4
// heads at d_model 1024), and the attention of K2 and K3 at head dim 256, on
// kernels designed for Hopper.  Replaces, at those head dims,
// explainable_spatial_vqa_tpu/ops/pallas_attention.py:_fused_attention_bhld
// and the per-head attention of ops/pallas_block.py:_block_kernel (:135-140,
// float32 q, k, v) and :_tiled_kernel (q, k, v rounded to bf16).
//
// Arithmetic: attention.cuh's, on the true head dim D (the columns D .. 255
// of Q, K and V read as zeros): scores in float32 scaled by 1/sqrt(D), -1e30
// on masked keys and -inf past L, a float32 softmax with sum + 1e-30; bf16
// weights normalised and then rounded to bf16; P V summed in float32.
//
// attention_kernel_split_f32: float32 q, k, v, any L (K2's attention at
// d_model 1024, K1 in float32).  Both products in 3xTF32 on mma.sync, the
// softmax online over tiles of kSplitKeys keys.  Bound on the H100: the
// three TF32 products, 12 L^2 D operations a head at 495 TFLOP/s (0.1375 ms
// at B=128, H=4, L=208).  What held attention_padded.cuh's kernel (0.99 ms
// there): each warp split its fragments into TF32 hi and lo parts at every
// load (Q once per key tile, each K and V tile by every row group), five
// block barriers per 32-key tile, and a block-wide exchange of partial scores.
// Here:
//   * a producer warpgroup loads each float4 of Q once per block and each
//     K and V tile once per block, splits it into hi and lo planes in shared
//     memory (V transposed, its keys permuted within each 8 so that ldmatrix
//     gives P V's B fragments in the order the score fragments hold P), and
//     paces a ring of kSplitStages tiles (a K stage and a V stage) by
//     full/empty mbarriers; two loader groups, one for K's tiles and one for
//     V's, each keep the loads of their next tile in flight in registers
//     while they wait for their stage;
//   * the consumers load every fragment with ldmatrix from the planes (four
//     registers an instruction) and never split K or V;
//   * two warps share a 16-row group, each half of the output columns; each
//     sums the scores over half the depth and the two swap halves through
//     shared memory under a pair barrier (bar.sync id, 64: the pair alone),
//     both adding them in one order;
//   * a block is kSplitGroups groups (64 query rows), within the 227 KB of
//     shared memory: Q's planes 130 KB, the ring 80 KB, the exchange 16 KB.
// What holds it (PERF.md §6): at B=128, L=208 its consumers alone take
// ~0.60 ms and its producers alone ~0.50 ms, and the ring's one K and one V
// stage couple them; a release arrive waits for the thread's loads in
// flight, so a deeper register prefetch gained nothing.  On wgmma, with Q's
// planes in shared memory, the key tiles stay at 16 (m64n16 score products)
// and it ran 2x slower.
//
// attention_kernel_wgmma: bf16 q, k, v, 17 <= L <= 256 (K3's attention at
// d_model 1024, K1 in bf16).  One pass, as attention_kernel_onepass does at
// D <= 64, on wgmma.  Bound on the H100: the bytes of q, k, v and the output
// (0.0651 ms at B=128, H=4, L=208), under the tensor cores' 4 L^2 D
// operations at 989 TFLOP/s.  attention_padded.cuh's kernel (1.00 ms there) took
// two passes over K (every score twice) with three to five block barriers a
// 32-key tile.  Here a block is 128 query rows: two consumer warpgroups of 64
// rows and a producer warpgroup that copies Q (in 64-column boxes) and then
// K's tiles of 64 keys (two 128-column halves each) and V's (one half of the
// columns at a time) by cp.async into a ring of 16 KB stages in the 128-byte
// swizzle, each stage on full/empty mbarriers.  Each consumer holds its
// rows' scores against every key in registers (wgmma m64n64k16, Q and K both
// K-major from shared memory; at most 4 tiles, 128 floats a thread), takes
// the exact row max and sum, normalises with div_by, rounds to bf16 straight
// into wgmma's A-register fragments (64 registers), and multiplies by V as an
// MN-major B operand (the transpose bit), one 128-column half of the output
// at a time (64 floats a thread).  Rows past L read as zeros (cp.async's
// zero fill), so a sequence never reads the next one's rows.
//
// Both take rows whose elements are whole 16-byte chunks (D * sizeof(T) % 16
// == 0, bases and strides aligned); attention_padded.cuh's launcher routes
// everything else at padded depth 256, rows of <= 16 keys and bf16 rows past
// 256 keys to the padded kernels.
#pragma once

#include "attention.cuh"
#include "hopper.cuh"

namespace esv {

// ---- float32: attention_kernel_split_f32 ----

constexpr int kSplitDepth = 256;   // the padded depth
constexpr int kSplitGroups = 4;    // 16-row groups a block, two warps each
constexpr int kSplitKeys = 16;     // keys a tile
constexpr int kSplitStages = 2;    // ring stages (K's and V's tiles alternate)
constexpr int kSplitProducers = 4; // producer warps
constexpr int kSplitLd = kSplitDepth + 4;   // Q's and K's plane rows: 260 words, 4 mod 32
constexpr int kSplitLdV = kSplitKeys + 4;   // V's transposed plane rows
constexpr int kSplitPlane = kSplitKeys * kSplitLd > kSplitDepth * kSplitLdV
                                ? kSplitKeys * kSplitLd
                                : kSplitDepth * kSplitLdV;  // floats of one plane of a stage
constexpr int kSplitThreads = 32 * (2 * kSplitGroups + kSplitProducers);
static_assert(kSplitKeys % 16 == 0, "score fragments in pairs of 8-key tiles");

// Q's planes, the ring's, the exchange and the mbarriers (Q's, full and
// empty per stage), in bytes
constexpr size_t split_smem_bytes() {
  return 4 * ((size_t)2 * 16 * kSplitGroups * kSplitLd + (size_t)2 * kSplitStages * kSplitPlane +
              (size_t)kSplitGroups * 4 * 16 * kSplitKeys) +
         8 * (1 + 2 * kSplitStages);
}

__device__ __forceinline__ float4 ldg_f4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// x's TF32 split (split_tf32's rule) into float4s of hi and lo bits
__device__ __forceinline__ void split4(const float4& x, float4& hi, float4& lo) {
  uint32_t h[4], l[4];
  split_tf32(x.x, h[0], l[0]);
  split_tf32(x.y, h[1], l[1]);
  split_tf32(x.z, h[2], l[2]);
  split_tf32(x.w, h[3], l[3]);
  hi = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]),
                   __uint_as_float(h[3]));
  lo = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]),
                   __uint_as_float(l[3]));
}

// s[n] (+)= Q K^T over the 8-deep slices [kk0, kk1) of a 16-row group (Q's
// planes at qh, ql) and the tile's kSplitKeys keys (K's planes at kh, kl),
// each slice summed by the tensor cores into a fresh accumulator and added in
// float32 (mma_3xtf32_add).  ldmatrix gives TF32 fragments: an 8 x 8 b16
// matrix is 8 rows of 4 floats, lane (g, t) receiving row g's word t.
template <int NT>
__device__ __forceinline__ void split_scores(const float* qh, const float* ql, const float* kh,
                                             const float* kl, int kk0, int kk1,
                                             float (&s)[NT][4]) {
  const int lane = threadIdx.x % 32;
  // A: rows 0-7 / 8-15 at columns 0-3, then at 4-7; B: keys 0-7 at depth
  // 0-3 and 4-7, then keys 8-15
  const int arow = lane % 8 + 8 * ((lane / 8) % 2), acol = 4 * (lane / 16);
  const int brow = lane % 8 + 8 * (lane / 16), bcol = 4 * ((lane / 8) % 2);
#pragma unroll 4
  for (int kk = kk0; kk < kk1; ++kk) {
    uint32_t ahi[4], alo[4];
    ldmatrix_x4(ahi, qh + arow * kSplitLd + 8 * kk + acol);
    ldmatrix_x4(alo, ql + arow * kSplitLd + 8 * kk + acol);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t bh[4], bl[4];
      ldmatrix_x4(bh, kh + (16 * np + brow) * kSplitLd + 8 * kk + bcol);
      ldmatrix_x4(bl, kl + (16 * np + brow) * kSplitLd + 8 * kk + bcol);
      const uint32_t bh0[2] = {bh[0], bh[1]}, bl0[2] = {bl[0], bl[1]};
      const uint32_t bh1[2] = {bh[2], bh[3]}, bl1[2] = {bl[2], bl[3]};
      mma_3xtf32_add(s[2 * np], ahi, alo, bh0, bl0);
      mma_3xtf32_add(s[2 * np + 1], ahi, alo, bh1, bl1);
    }
  }
}

// o += w V over the tile's keys for 128 output columns from col0: w the
// weights in score-fragment order (split here, once), V's transposed planes
// (row = column, keys permuted within each 8: position t holds key 2t and
// t + 4 key 2t + 1, the order of the A fragment's columns t and t + 4)
template <int NT>
__device__ __forceinline__ void split_pv(const float (&w)[NT][4], const float* vh, const float* vl,
                                         int col0, float (&o)[16][4]) {
  const int lane = threadIdx.x % 32;
  const int brow = lane % 8 + 8 * (lane / 16), bcol = 4 * ((lane / 8) % 2);
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const float af[4] = {w[n][0], w[n][2], w[n][1], w[n][3]};
    uint32_t ahi[4], alo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(af[i], ahi[i], alo[i]);
#pragma unroll
    for (int cp = 0; cp < 8; ++cp) {
      uint32_t bh[4], bl[4];
      ldmatrix_x4(bh, vh + (col0 + 16 * cp + brow) * kSplitLdV + 8 * n + bcol);
      ldmatrix_x4(bl, vl + (col0 + 16 * cp + brow) * kSplitLdV + 8 * n + bcol);
      const uint32_t bh0[2] = {bh[0], bh[1]}, bl0[2] = {bl[0], bl[1]};
      const uint32_t bh1[2] = {bh[2], bh[3]}, bl1[2] = {bl[2], bl[3]};
      mma_3xtf32(o[2 * cp], ahi, alo, bh0, bl0);
      mma_3xtf32(o[2 * cp + 1], ahi, alo, bh1, bl1);
    }
  }
}

// float32 q, k, v at a head dim D with padded depth 256 (D % 4 == 0), any L:
// kSplitGroups groups of 16 query rows a block, two warps a group, and
// kSplitProducers producer warps (the header's Design)
template <typename TO>
__global__ void __launch_bounds__(kSplitThreads, 1) attention_kernel_split_f32(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ mask, TO* __restrict__ out, int L, int D, long long in_bs,
    long long in_rs, long long out_bs, long long out_rs, float scale) {
  constexpr int G = kSplitGroups, T = kSplitKeys, NT = T / 8, S = kSplitStages;
  constexpr int kConsumers = 2 * G, kProducerThreads = 32 * kSplitProducers;
  constexpr int kChunks = kSplitDepth / 4;  // float4s of a padded row
  extern __shared__ __align__(16) unsigned char attn_smem[];
  float* qhi = reinterpret_cast<float*>(attn_smem);  // [16 G][kSplitLd]
  float* qlo = qhi + 16 * G * kSplitLd;
  float* ring = qlo + 16 * G * kSplitLd;              // [S][hi, lo][kSplitPlane]
  float* xs = ring + 2 * S * kSplitPlane;             // [G][tile parity][half][16 T]
  const uint32_t qbar = smem_u32(xs + G * 4 * 16 * T);
  const auto full = [&](int s) { return qbar + 8 * (1 + s); };
  const auto empty = [&](int s) { return qbar + 8 * (1 + S + s); };

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * 16 * G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long in_off = (long long)b * in_bs + (long long)h * D;
  const int ntiles = (L + T - 1) / T, chunks = D / 4;
  if (threadIdx.x == 0) {
    mbar_init(qbar, kProducerThreads);
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), kProducerThreads / 2);  // one loader group a stage
      mbar_init(empty(s), kConsumers);
    }
  }
  __syncthreads();

  if (warp >= kConsumers) {  // producers: Q, then K's and V's tiles
    const int p = threadIdx.x - 32 * kConsumers;
    // Q's rows, kQPer float4s a thread at a time, all loads before the stores
    constexpr int kQPer = 16, kQRounds = 16 * G * kChunks / (kProducerThreads * kQPer);
    static_assert(16 * G * kChunks % (kProducerThreads * kQPer) == 0, "Q's rounds");
#pragma unroll 1
    for (int round = 0; round < kQRounds; ++round) {
      float4 x[kQPer];
#pragma unroll
      for (int j = 0; j < kQPer; ++j) {
        const int i = p + kProducerThreads * (round * kQPer + j), r = i / kChunks, c = i % kChunks;
        x[j] = q0 + r < L && c < chunks ? ldg_f4(q + in_off + (q0 + r) * in_rs + 4 * c)
                                        : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int j = 0; j < kQPer; ++j) {
        const int i = p + kProducerThreads * (round * kQPer + j), r = i / kChunks, c = i % kChunks;
        float4 hi, lo;
        split4(x[j], hi, lo);
        *reinterpret_cast<float4*>(qhi + r * kSplitLd + 4 * c) = hi;
        *reinterpret_cast<float4*>(qlo + r * kSplitLd + 4 * c) = lo;
      }
    }
    mbar_arrive(qbar);
    // the tiles: stage 0 holds K's, stage 1 V's; the first kSplitProducers /
    // 2 warps load and split K's tiles (as rows of keys), the others V's
    // (transposed).  Each group's loads of its next tile are in flight while
    // it waits for its stage: a whole tile of the consumers' work (a
    // release arrive waits for the thread's earlier loads, so one producer
    // for both kinds drained them every half tile).  Thread p of a group
    // takes float4s e = p + kGroup j: of K's tile (key e / kChunks, chunk e %
    // kChunks), of V's (key e % T, chunk e / T).
    constexpr int kGroup = kProducerThreads / 2, kPer = T * kChunks / kGroup;
    static_assert(S == 2 && T * kChunks % kGroup == 0, "a stage for each kind, a tile's float4s");
    const bool is_k = p < kGroup;
    const int pg = p % kGroup, stage = is_k ? 0 : 1;
    const float* src = is_k ? k : v;
    float* hi = ring + 2 * stage * kSplitPlane;
    float* lo = hi + kSplitPlane;
    float4 x[kPer];
    const auto load = [&](int kt) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int e = pg + kGroup * j;
        const int r = is_k ? e / kChunks : e % T, c = is_k ? e % kChunks : e / T;
        x[j] = kt * T + r < L && c < chunks ? ldg_f4(src + in_off + (kt * T + r) * in_rs + 4 * c)
                                            : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    };
    load(0);
#pragma unroll 1
    for (int kt = 0; kt < ntiles; ++kt) {
      mbar_wait_bounded(empty(stage), (kt & 1) ^ 1);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int e = pg + kGroup * j;
        float4 xh, xl;
        split4(x[j], xh, xl);
        if (is_k) {
          const int at = e / kChunks * kSplitLd + 4 * (e % kChunks);
          *reinterpret_cast<float4*>(hi + at) = xh;
          *reinterpret_cast<float4*>(lo + at) = xl;
        } else {
          const int r = e % T, c = e / T;
          const int at = 4 * c * kSplitLdV + r / 8 * 8 + r % 2 * 4 + r % 8 / 2;
          hi[at] = xh.x;
          hi[at + kSplitLdV] = xh.y;
          hi[at + 2 * kSplitLdV] = xh.z;
          hi[at + 3 * kSplitLdV] = xh.w;
          lo[at] = xl.x;
          lo[at + kSplitLdV] = xl.y;
          lo[at + 2 * kSplitLdV] = xl.z;
          lo[at + 3 * kSplitLdV] = xl.w;
        }
      }
      mbar_arrive(full(stage));
      if (kt + 1 < ntiles) load(kt + 1);
    }
    return;
  }

  // consumers: warp `half` of group grp, rows 16 grp .. of the block, output
  // columns 128 half ..
  const int grp = warp / 2, half = warp % 2, g = lane / 4, t = lane % 4;
  const bool active = q0 + 16 * grp < L;  // a group wholly past L keeps the barriers only
  const float* mrow = mask == nullptr ? nullptr : mask + (long long)b * L;
  const float* qh = qhi + 16 * grp * kSplitLd;
  const float* ql = qlo + 16 * grp * kSplitLd;
  float o[16][4];
#pragma unroll
  for (int dn = 0; dn < 16; ++dn)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[dn][c] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
  mbar_wait_bounded(qbar, 0);
#pragma unroll 1
  for (int kt = 0; kt < ntiles; ++kt) {
    const int sk = (2 * kt) % S, sv = (2 * kt + 1) % S;
    // the tile's key mask (keys kt T + 8n + 2t + e), in flight during the scores
    float kept[NT][2];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = kt * T + n * 8 + 2 * t + e;
        kept[n][e] = mrow == nullptr || key >= L ? 1.f : __ldg(mrow + key);
      }
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = 0.f;
    mbar_wait_bounded(full(sk), ((2 * kt) / S) & 1);
    if (active) {
      const float* kh = ring + 2 * sk * kSplitPlane;
      split_scores<NT>(qh, ql, kh, kh + kSplitPlane, 16 * half, 16 * half + 16, s);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(sk));
    if (!active) {
      mbar_wait_bounded(full(sv), ((2 * kt + 1) / S) & 1);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(sv));
      continue;
    }
    // the pair's halves meet: each adds the other's to its own (float
    // addition commutes, so both hold the same sums); the buffer
    // alternates by tile, so one pair barrier a tile suffices
    float* mine = xs + ((grp * 2 + kt % 2) * 2 + half) * 16 * T;
    float* other = xs + ((grp * 2 + kt % 2) * 2 + (half ^ 1)) * 16 * T;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) mine[(n * 4 + c) * 32 + lane] = s[n][c];
    asm volatile("bar.sync %0, 64;\n" ::"r"(1 + grp) : "memory");
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] += other[(n * 4 + c) * 32 + lane];
    // scaled and masked: -inf past L, -1e30 on masked keys; the online softmax
    float tm[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = kt * T + n * 8 + 2 * t + (c & 1);
        float& x = s[n][c];
        x = key >= L ? -INFINITY : (kept[n][c & 1] > 0.f ? x * scale : -1e30f);
        tm[c / 2] = fmaxf(tm[c / 2], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tm[r] = fmaxf(tm[r], __shfl_xor_sync(0xffffffffu, tm[r], 1));
      tm[r] = fmaxf(tm[r], __shfl_xor_sync(0xffffffffu, tm[r], 2));
      const float mn = fmaxf(m[r], tm[r]);  // finite: tile kt holds key kt * T < L
      alpha[r] = expf(m[r] - mn);           // 0 on the first tile
      m[r] = mn;
      sum[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[n][c] = expf(s[n][c] - m[c / 2]);
        sum[c / 2] += s[n][c];
      }
    // o *= alpha, skipped where every alpha of the warp is 1 (exact either way)
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int dn = 0; dn < 16; ++dn)
#pragma unroll
        for (int c = 0; c < 4; ++c) o[dn][c] *= alpha[c / 2];
    }
    mbar_wait_bounded(full(sv), ((2 * kt + 1) / S) & 1);
    const float* vh = ring + 2 * sv * kSplitPlane;
    split_pv<NT>(s, vh, vh + kSplitPlane, 128 * half, o);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(sv));
  }
  if (!active) return;
  float denom[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    denom[r] = sum[r] + 1e-30f;
  }
  TO* op = out + (long long)b * out_bs + (long long)h * D;
  const int row = q0 + 16 * grp + g;
#pragma unroll
  for (int dn = 0; dn < 16; ++dn) {
    const int col = 128 * half + 8 * dn + 2 * t;  // D % 4 == 0: col + 1 < D with col
    if (col < D) {
      if (row < L)
        store2(op + (long long)row * out_rs + col, o[dn][0] / denom[0], o[dn][1] / denom[0]);
      if (row + 8 < L)
        store2(op + (long long)(row + 8) * out_rs + col, o[dn][2] / denom[1],
               o[dn][3] / denom[1]);
    }
  }
}

// ---- bf16: attention_kernel_wgmma ----

constexpr int kWgmmaKeys = 64;        // keys a tile (the N of the score products)
constexpr int kWgmmaMaxKeys = 256;    // the longest row: scores of 4 tiles in registers
constexpr int kWgmmaStages = 8;       // ring stages of 16 KB
constexpr int kWgmmaBox = 8192;       // 64 rows of 128 bytes, one swizzle box
constexpr int kWgmmaStage = 2 * kWgmmaBox;
constexpr int kWgmmaThreads = 3 * 128;  // two consumer warpgroups, one producer
// Q's 128 rows (8 boxes), the ring, the mbarriers, and 1 KB to align the
// boxes to the swizzle's 1 KB atoms
constexpr size_t wgmma_smem_bytes() {
  return 1024 + 8 * kWgmmaBox + (size_t)kWgmmaStages * kWgmmaStage + 8 * (1 + 2 * kWgmmaStages);
}

#define ESV_ACC32                                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define ESV_ACC32_OPERANDS(d)                                                                  \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),          \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),  \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),            \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),            \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d (+)= A[64 x 16] B[64 x 16]^T, both K-major in shared memory; scale_d 0
// overwrites d
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da, uint64_t db,
                                                   int scale_d) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ESV_ACC32
               ", %32, %33, p, 1, 1, 0, 0;\n}\n"
               : ESV_ACC32_OPERANDS(d)
               : "l"(da), "l"(db), "r"(scale_d));
}
// d (+)= A[64 x 16] B[16 x 64], A from registers (this thread's fragment, as
// mma.m16n8k16's for its warp's 16 rows), B MN-major in shared memory
__device__ __forceinline__ void wgmma_m64n64k16_rs_mn(float (&d)[32], const uint32_t (&a)[4],
                                                      uint64_t db, int scale_d) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ESV_ACC32
               ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
               : ESV_ACC32_OPERANDS(d)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// bf16 q, k, v at a head dim D with padded depth 256 (D % 8 == 0), 16 < L <=
// 256: one block of 128 query rows (the header's Design)
template <typename TO>
__global__ void __launch_bounds__(kWgmmaThreads, 1) attention_kernel_wgmma(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ mask, TO* __restrict__ out,
    int L, int D, long long in_bs, long long in_rs, long long out_bs, long long out_rs,
    float scale) {
  static_assert(std::is_same<TO, __nv_bfloat16>::value, "bf16 out");
  constexpr int S = kWgmmaStages, kTiles = kWgmmaMaxKeys / kWgmmaKeys;
  extern __shared__ __align__(1024) unsigned char wgmma_smem[];
  const uint32_t qs = (smem_u32(wgmma_smem) + 1023) & ~1023u;  // [warpgroup][4 boxes]
  const uint32_t ring = qs + 8 * kWgmmaBox;                     // [S][2 boxes]
  const uint32_t qbar = ring + S * kWgmmaStage;
  const auto full = [&](int s) { return qbar + 8 * (1 + s); };
  const auto empty = [&](int s) { return qbar + 8 * (1 + S + s); };

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * 128;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const long long in_off = (long long)b * in_bs + (long long)h * D;
  const int nt = (L + kWgmmaKeys - 1) / kWgmmaKeys, chunks = D / 8;
  if (threadIdx.x == 0) {
    mbar_init(qbar, 128);
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 128);   // the producers' cp.async arrivals
      mbar_init(empty(s), 8);    // each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // producer: Q, then K's tiles (two column halves each), then V's by half
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    // element (row, 16-byte chunk cc) of a box of 64 rows at row * 128 + (cc ^ row % 8) * 16
    for (int i = tid; i < 128 * 32; i += 128) {
      const int row = i / 32, cc = i % 32, r = row % 64;
      const bool ok = q0 + row < L && cc < chunks;
      cp_async16_to(qs + (row / 64 * 4 + cc / 8) * kWgmmaBox + r * 128 + ((cc % 8 ^ r % 8) << 4),
                    q + in_off + (ok ? (long long)(q0 + row) * in_rs + 8 * cc : 0), ok);
    }
    cp_async_arrive(qbar);
    for (int i = 0; i < 4 * nt; ++i) {
      const bool is_k = i < 2 * nt;
      const int j = is_k ? i / 2 : (i - 2 * nt) % nt, cb = is_k ? i % 2 : (i - 2 * nt) / nt;
      const __nv_bfloat16* src = (is_k ? k : v) + in_off;
      const int stage = i % S;
      mbar_wait_bounded(empty(stage), ((i / S) & 1) ^ 1);
      const uint32_t dst = ring + stage * kWgmmaStage;
#pragma unroll
      for (int e = tid; e < 64 * 16; e += 128) {
        const int row = e / 16, cc = e % 16, key = j * kWgmmaKeys + row, col = 16 * cb + cc;
        const bool ok = key < L && col < chunks;
        cp_async16_to(dst + cc / 8 * kWgmmaBox + row * 128 + ((cc % 8 ^ row % 8) << 4),
                      src + (ok ? (long long)key * in_rs + 8 * col : 0), ok);
      }
      cp_async_arrive(full(stage));
    }
    cp_async_wait_all();
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const bool active = q0 + 64 * wg < L;  // a warpgroup wholly past L keeps the barriers only
  const float* mrow = mask == nullptr ? nullptr : mask + (long long)b * L;
  const uint32_t qw = qs + wg * 4 * kWgmmaBox;
  int stage = 0;
  uint32_t phase = 0;
  const auto release = [&]() {  // this warp is done with the stage
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(stage));
    if (++stage == S) {
      stage = 0;
      phase ^= 1;
    }
  };
  mbar_wait_bounded(qbar, 0);

  // scores: s[j][4n + 2r + e] is row 16 warp + g + 8r against key 64 j + 8n + 2t + e
  float s[kTiles][32];
#pragma unroll
  for (int j = 0; j < kTiles; ++j) {
    if (j < nt) {
#pragma unroll
      for (int dh = 0; dh < 2; ++dh) {  // columns 128 dh ..
        mbar_wait_bounded(full(stage), phase);
        fence_proxy_async();
        if (active) {
          const uint32_t kst = ring + stage * kWgmmaStage;
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 8; ++kk)
            wgmma_m64n64k16_ss(s[j], sw128_desc(qw + (2 * dh + kk / 4) * kWgmmaBox + 32 * (kk % 4)),
                               sw128_desc(kst + kk / 4 * kWgmmaBox + 32 * (kk % 4)),
                               dh > 0 || kk > 0);
          wgmma_commit();
          wgmma_wait<0>();
          fence_operands(s[j]);
        }
        release();
      }
    }
  }

  // the exact row max and sum, the weights normalised (div_by) and rounded
  // to bf16 into P V's A fragments: p[j][kk] holds keys 64 j + 16 kk ..
  uint32_t p[kTiles][4][4];
  if (active) {
    float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kTiles; ++j) {
      if (j < nt) {
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int key = j * kWgmmaKeys + 8 * n + 2 * t;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool past = key + e >= L;
            const bool kp = past || mrow == nullptr || __ldg(mrow + key + e) > 0.f;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              float& x = s[j][4 * n + 2 * r + e];
              x = past ? -INFINITY : (kp ? x * scale : -1e30f);
              m[r] = fmaxf(m[r], x);
            }
          }
        }
      }
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
      m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
    }
#pragma unroll
    for (int j = 0; j < kTiles; ++j) {
      if (j < nt) {
#pragma unroll
        for (int c = 0; c < 32; ++c) {
          s[j][c] = expf(s[j][c] - m[c % 4 / 2]);
          sum[c % 4 / 2] += s[j][c];
        }
      }
    }
    float denom[2], inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      denom[r] = sum[r] + 1e-30f;
      inv[r] = __frcp_rn(denom[r]);
    }
#pragma unroll
    for (int j = 0; j < kTiles; ++j) {
      if (j < nt) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int a = 0; a < 4; ++a) {  // a: n = 2 kk + a / 2, row g + 8 (a % 2)
            const int c = 8 * kk + 2 * a, r = a % 2;
            p[j][kk][a] = pack_bf16x2(div_by(s[j][c], denom[r], inv[r]),
                                      div_by(s[j][c + 1], denom[r], inv[r]));
          }
      }
    }
  }

  // P V, one half of the output columns at a time: o[nb][4n + 2r + e] is row
  // 16 warp + g + 8r, column 128 half + 64 nb + 8n + 2t + e
  TO* op = out + (long long)b * out_bs + (long long)h * D;
  const int row = q0 + 64 * wg + 16 * warp + g;
#pragma unroll 1
  for (int half = 0; half < 2; ++half) {
    float o[2][32];
#pragma unroll
    for (int j = 0; j < kTiles; ++j) {
      if (j < nt) {
        mbar_wait_bounded(full(stage), phase);
        fence_proxy_async();
        if (active) {
          const uint32_t vst = ring + stage * kWgmmaStage;
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int nb = 0; nb < 2; ++nb)
              wgmma_m64n64k16_rs_mn(o[nb], p[j][kk],
                                    sw128_desc_mn(vst + nb * kWgmmaBox + kk * 16 * 128, kWgmmaBox),
                                    j > 0 || kk > 0);
          wgmma_commit();
          wgmma_wait<0>();
          fence_operands(o[0]);
          fence_operands(o[1]);
        }
        release();
      }
    }
    if (active) {
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int col = 128 * half + 64 * nb + 8 * n + 2 * t;  // D % 8 == 0
          if (col < D) {
            if (row < L) store2(op + (long long)row * out_rs + col, o[nb][4 * n], o[nb][4 * n + 1]);
            if (row + 8 < L)
              store2(op + (long long)(row + 8) * out_rs + col, o[nb][4 * n + 2], o[nb][4 * n + 3]);
          }
        }
    }
  }
}

#undef ESV_ACC32
#undef ESV_ACC32_OPERANDS

// Whether the kernels above take a call at padded depth 256: rows of whole
// 16-byte chunks (D * sizeof(T) % 16 == 0, q, k, v and their strides 16-byte
// aligned), an output written two elements at a time, and L past 16 (bf16:
// up to kWgmmaMaxKeys)
template <typename T, typename TO>
static bool wide_takes(const T* q, const T* k, const T* v, const TO* out, int L, int D,
                       long long in_bs, long long in_rs, long long out_bs, long long out_rs) {
  const bool f32 = std::is_same<T, float>::value;
  return L > 16 && (f32 || L <= kWgmmaMaxKeys) && (D * sizeof(T)) % 16 == 0 && aligned16(q) &&
         aligned16(k) && aligned16(v) && (in_bs * sizeof(T)) % 16 == 0 &&
         (in_rs * sizeof(T)) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(out) % (2 * sizeof(TO)) == 0 && out_bs % 2 == 0 &&
         out_rs % 2 == 0;
}

// Kernel's shared-memory attribute, set once per device
template <auto Kernel, size_t kSmem>
static cudaError_t wide_attribute() {
  int dev;
  return once_per_device<KernelSite<Kernel> >(&dev, [](int) {
    return cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  });
}

// attention_kernel_split_f32 (float32 q, k, v) or attention_kernel_wgmma
// (bf16) on a call wide_takes
template <typename T, typename TO>
static cudaError_t launch_attention_wide(const T* q, const T* k, const T* v, const float* mask,
                                         TO* out, int B, int H, int L, int D, long long in_bs,
                                         long long in_rs, long long out_bs, long long out_rs,
                                         cudaStream_t stream) {
  const float scale = 1.0f / sqrtf((float)D);  // of the true head dim, as the TPU kernel's
  if constexpr (std::is_same<T, float>::value) {
    const cudaError_t err = wide_attribute<attention_kernel_split_f32<TO>, split_smem_bytes()>();
    if (err != cudaSuccess) return err;
    const dim3 grid((L + 16 * kSplitGroups - 1) / (16 * kSplitGroups), H, B);
    attention_kernel_split_f32<TO><<<grid, kSplitThreads, split_smem_bytes(), stream>>>(
        q, k, v, mask, out, L, D, in_bs, in_rs, out_bs, out_rs, scale);
    return counted_launch(kAttnKernelSplitF32);
  } else {
    const cudaError_t err = wide_attribute<attention_kernel_wgmma<TO>, wgmma_smem_bytes()>();
    if (err != cudaSuccess) return err;
    attention_kernel_wgmma<TO><<<dim3((L + 127) / 128, H, B), kWgmmaThreads, wgmma_smem_bytes(),
                                 stream>>>(q, k, v, mask, out, L, D, in_bs, in_rs, out_bs, out_rs,
                                           scale);
    return counted_launch(kAttnKernelWgmma);
  }
}

}  // namespace esv
