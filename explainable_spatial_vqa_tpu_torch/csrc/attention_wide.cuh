// Attention kernels designed for Hopper.  Replace, at the head dims and
// lengths below, explainable_spatial_vqa_tpu/ops/pallas_attention.py:
// _fused_attention_bhld and the per-head attention of ops/pallas_block.py:
// _block_kernel (:135-140, float32 q, k, v) and :_tiled_kernel (q, k, v
// rounded to bf16):
//   * K1 in float32 at the head dims whose padded depth is 256 (225-256,
//     among them 256: 4 heads at d_model 1024) and K2's attention at head
//     dim 256 (attention_kernel_split_f32);
//   * K1 in bf16 of 17-256 keys at head dims 72-128 (multiples of 8) and at
//     every padded depth past 128, in rows of any width and offset, and
//     K3's attention at head dims 128-512 (attention_kernel_wgmma at padded
//     depths 80-128 and 160-256; attention_kernel_wgmma_deep, the same code,
//     at 288-512: d_model 768, 1100 and 1280 at 4 heads, K3 at d_model 1536
//     and 2048), and K1 and K3 in bf16 past 256 keys at every multiple of 8
//     up to 128 (attention_kernel_wgmma_2pass) and at every padded depth
//     past 128, in rows of any width (attention_kernel_wgmma_2pass_deep; K3's
//     attention at head dims 256-512).
//
// Arithmetic: attention.cuh's, on the true head dim D (the columns D .. DP - 1
// of Q, K and V read as zeros, DP the padded depth): scores in float32
// scaled by 1/sqrt(D), -1e30 on masked keys and -inf past L, a float32
// softmax with sum + 1e-30; bf16 weights normalised and then rounded to
// bf16; P V summed in float32.
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
// The bf16 kernels on wgmma.  Bound on the H100: the bytes of q, k, v and
// the output (0.0651 ms at B=128, H=4, L=208, D=256; 0.0306 at D=120; 0.1402
// at K3's B=128, L=224, D=512), under the tensor cores' 4 L^2 D operations
// at 989 TFLOP/s up to ~1000 keys; past that the operations (the two-pass
// kernel does 6 L^2 D: pass 2 recomputes the scores).  What held the
// kernels they replace (PERF.md §6): the ring (attention.cuh's
// attention_kernel, 2.3-3.8x SDPA at D = 72-128) spilled 476-2664 bytes at
// 255 registers holding 224 keys' scores as mma.sync fragments, with a block
// barrier per 32-key tile, and past 224 keys took its two passes in 224-key
// chunks (3.6x SDPA at L = 1025); the padded and deep kernels past depth 128
// (attention_padded.cuh: 7.7x SDPA at D = 192, 3.4x at K3's 512) share a
// 16-row group among two to four warps, each a slice of the depth, exchange
// partial scores through shared memory and take two passes over K with
// three to five block barriers a 32-key tile, and copied rows that are not
// whole 16-byte chunks (D = 275: a bf16 head of 550 bytes, every other one
// 2 bytes off a 4-byte boundary) element by element, synchronously, with
// nothing to overlap (4.17 ms at d_model 1100, 1.8x the plain version).
// Here a block is two consumer warpgroups of 64 query rows and a producer
// warpgroup that copies Q (in 64-column boxes) and then K's and V's tiles of
// 64 keys into a ring of wgmma_stages stages of 16 KB (two 64-column boxes)
// in the 128-byte swizzle, each stage on full/empty mbarriers: kWgmmaStages
// (8) up to depth 384, 7 at 448 and 6 at 512, where Q's boxes take 112 and
// 128 KB of the 227.  Rows of whole 16-byte chunks on 16-byte boundaries
// come by cp.async, 16 bytes a copy, which arrives on the stage's barrier
// itself.  Past depth 128 any other row (D % 8 != 0, as D = 275's, or a base
// or stride off 16 bytes) takes a second instantiation of the same kernel
// (kNarrow, which launch_attention_wgmma picks at run time, in the same
// translation unit): its producer builds each swizzled 16-byte chunk from
// the 4-byte words of its aligned floor (4 or 5, realigned by __byte_perm
// where the row starts 2 bytes off a word), kNarrowBatch chunks' loads in
// flight at once, stores it in one 16-byte write, fences the async proxy
// and arrives: its loads wait in the producer warpgroup while the
// consumers' products run; its output goes out element by element where a
// head's rows start off a pair's boundary (odd D).
// K's and V's rows come in pieces of 128 columns, a stage each (the last
// piece narrower: 160 = 128 + 32, 336 = 2 x 128 + 80).  The score products
// are wgmma m64n64k16 over the padded depth (Q and K both K-major from
// shared memory; DP / 16 of them a tile, the pieces in order into one
// accumulator, the columns past D zero-filled by the copies); P V multiplies
// the weights, rounded to bf16 straight into wgmma's A-register fragments, by V
// as an MN-major B operand (the transpose bit), 64 columns a product (the
// columns past D zeros and not stored).  Both hold their consumers to
// ptxas's 168 registers a thread at 384 threads: past it ptxas spills and
// serialises every wgmma (PERF.md §6).
// The block's first step writes the key mask as bits in shared memory (a
// warp's ballot a word), so each tile's masking reads two words: the
// mask's float loads in the softmax took a third of the time (PERF.md §6).
//   * attention_kernel_wgmma<TO, DP> (DP 80-256) and
//     attention_kernel_wgmma_deep<TO, DP> (DP 288-512; the same code under
//     a name of its own, so that the launch counts tell them apart): 17 <=
//     L <= 256, one pass.  Each consumer issues every tile's score products
//     before it waits (past depth 256, where a row's 4 tiles of 3 or 4
//     pieces outnumber the stages, one product in flight: each wait frees
//     the stage of the product before), holds its rows' scores against
//     every key in registers (at most 4 tiles, 128 floats a thread), takes
//     the exact row max and sum, normalises with div_by, rounds to bf16 (64
//     registers of A fragments) and issues every tile's P V before it
//     waits, one 128-column piece of the output at a time (64 floats a
//     thread).  The register budget does not grow with the depth.
//   * attention_kernel_wgmma_2pass<TO, DP>: DP <= 128, L > 256, two passes
//     over 64-key tiles.  Pass 1 takes each tile's scores, the running row
//     max (the quad's) and the thread's share of the sum, rescaled when the
//     max grows; pass 2 recomputes each tile's scores with the same products
//     in the same order (so the same sums), normalises exp(s - max) against
//     the final max and sum, rounds to bf16 into the A fragments and
//     accumulates P V in float32 (32 or 64 floats a thread).  The producer
//     sends K's tiles (pass 1), then K's and V's tile j in turn (pass 2).
//     Tile j + 1's products in flight during tile j's arithmetic, a
//     persistent block an SM, ran slower or no faster: ptxas serialised
//     the pipelined wgmma, and persistence gained 0-3% (PERF.md §6).
//   * attention_kernel_wgmma_2pass_deep<TO, DP[, kNarrow]>: DP 160-512, L >
//     256, rows of any width (the one-pass kernel's producer copies, narrow
//     ones included).  The same two passes, each tile's score products
//     chained over the 128-column pieces of K in order, one in flight while
//     the next stage is taken (each wait frees the stage of the piece
//     before), in both passes alike.  What limits it is registers: a
//     warpgroup's float32 output over DP columns is DP / 2 floats a thread
//     (256 at depth 512) beside a tile's 32 scores and 16 words of weights,
//     and the consumers have 232, so a warpgroup holds at most two pieces
//     (128 floats a thread) of the output.  Up to depth 256 that is every
//     column; past it two blocks share 128 query rows, each over half of
//     the output columns and both score passes (layout (A): 10 L^2 D
//     operations against the bound's 4 at depth 512; two_pass_deep_chunks).
// Rows past L read as zeros (cp.async's zero fill, or no load), so a
// sequence never reads the next one's rows.
//
// The float32 kernel takes rows whose elements are whole 16-byte chunks (D
// * sizeof(T) % 16 == 0, bases and strides aligned), as launch_attention_dim
// (attention.cuh) requires at the head dims 8-128; the bf16 ones take any
// row past padded depth 128.  attention_padded.cuh's launcher sends bf16
// rows past 256 keys past depth 128 to attention_kernel_wgmma_2pass_deep, and
// everything else, rows of <= 16 keys (its short kernels) and float32 at
// depths other than 256, to its own kernels or attention_f32_wide.cuh's.
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

// ---- bf16 on wgmma: attention_kernel_wgmma[_deep], attention_kernel_wgmma_2pass ----

constexpr int kWgmmaKeys = 64;        // keys a tile (the N of the score products)
constexpr int kWgmmaMaxKeys = 256;    // the one-pass kernel's longest row: 4 tiles' scores
constexpr int kWgmmaStages = 8;       // ring stages of 16 KB, at most (wgmma_stages)
constexpr int kWgmmaBox = 8192;       // 64 rows of 128 bytes, one swizzle box
constexpr int kWgmmaStage = 2 * kWgmmaBox;
constexpr int kWgmmaThreads = 3 * 128;  // two consumer warpgroups, one producer
constexpr int kWgmmaRows = 128;         // query rows an item (a warpgroup 64)
constexpr size_t kPaddedSmemMax = 232448;  // the H100's 227 KB of shared memory a block
static_assert(kWgmmaMaxKeys == kOnePassKeys, "launch_attention_dim's one-pass rows");

// At padded depth DP (the head dim rounded up to 16, or past 128
// attention_padded.cuh's padded_depth): K's and V's columns in pieces of 128
// (the last of DP - 128 (P - 1) columns: 160 = 128 + 32, 336 = 128 + 128 +
// 80), a ring stage each; a piece's 16-deep slices; Q's 64-column boxes a
// warpgroup; and a piece's V boxes of 64 columns (P V's N is 64 a box; past
// D the columns are zeros and not stored)
template <int DP>
__host__ __device__ constexpr int wgmma_pieces() {
  return (DP + 127) / 128;
}
template <int DP>
__host__ __device__ constexpr int wgmma_width(int piece) {
  return piece + 1 < wgmma_pieces<DP>() ? 128 : DP - 128 * (wgmma_pieces<DP>() - 1);
}
template <int DP>
__host__ __device__ constexpr int wgmma_slices(int piece) {
  return wgmma_width<DP>(piece) / 16;
}
template <int DP>
__host__ __device__ constexpr int wgmma_qboxes() {
  return (DP + 63) / 64;
}
template <int DP>
__host__ __device__ constexpr int wgmma_vboxes(int piece) {
  return (wgmma_width<DP>(piece) + 63) / 64;
}
// Q's 128 rows (2 Q-box groups), S ring stages, the mbarriers (Q's, and full
// and empty per stage), the key mask's bits, and 1 KB to align the boxes to
// the swizzle's 1 KB atoms
template <int DP>
constexpr size_t wgmma_smem_at(int S) {
  return 1024 + (size_t)2 * wgmma_qboxes<DP>() * kWgmmaBox + (size_t)S * kWgmmaStage +
         8 * (1 + 2 * (size_t)S) + 4 * (kAttnMaxLen / 32);
}
// The ring's stages at depth DP: kWgmmaStages where they fit in the 227 KB
// (every depth up to 384), else as many as fit (7 at 448, 6 at 512: Q's
// boxes take 112 and 128 KB there)
template <int DP>
constexpr int wgmma_stages() {
  int s = kWgmmaStages;
  while (s > 2 && wgmma_smem_at<DP>(s) > kPaddedSmemMax) --s;
  return s;
}
template <int DP>
constexpr size_t wgmma_smem_bytes() {
  return wgmma_smem_at<DP>(wgmma_stages<DP>());
}

// The consumers' side of a ring of S stages: stages taken in the order the
// producer fills them, and released in that order by every consumer warp
// once the products that read them are done
template <int S>
struct WgmmaRing {
  uint32_t base, bars;  // the stages; full(s) at bars + 8 s, empty(s) at bars + 8 (S + s)
  int taken, released;
  __device__ uint32_t take() {  // the next stage, once filled
    const int st = taken % S;
    mbar_wait_bounded(bars + 8 * st, (taken / S) & 1);
    fence_proxy_async();
    ++taken;
    return base + st * kWgmmaStage;
  }
  __device__ void release(int upto) {  // this warp is done with the stages taken before upto
    __syncwarp();
    for (; released < upto; ++released)
      if (threadIdx.x % 32 == 0) mbar_arrive(bars + 8 * (S + released % S));
  }
};

// A block's item, query rows q0 = kWgmmaRows blockIdx.x .. of head
// blockIdx.y of batch blockIdx.z, and its shared memory: Q's boxes, the
// ring's S stages and the mbarriers by shared-window address, and the key
// mask as bits (bit i of keep[w]: key 32 w + i lies below L and is kept)
template <int DP>
struct WgmmaBlock {
  static constexpr int S = wgmma_stages<DP>();
  uint32_t qs, ring, bars;
  const uint32_t* keep;
  int b, h, q0;
  __device__ uint32_t qfull() const { return bars; }
  __device__ uint32_t full(int s) const { return bars + 8 * (1 + s); }
  __device__ uint32_t empty(int s) const { return bars + 8 * (1 + S + s); }
  __device__ WgmmaRing<S> consumer_ring() const { return {ring, bars + 8, 0, 0}; }
};

// The block's layout in dynamic shared memory, its mbarriers initialised
// (Q's and the ring's full by the producers' 128 cp.async arrivals, the
// empties by the consumer warps) and its key mask's bits written, a warp's
// ballot a word; ends with a block barrier
template <int DP>
__device__ __forceinline__ WgmmaBlock<DP> wgmma_block(unsigned char* smem, const float* mask,
                                                      int L) {
  constexpr int S = WgmmaBlock<DP>::S;
  WgmmaBlock<DP> blk;
  blk.qs = (smem_u32(smem) + 1023) & ~1023u;                   // [warpgroup][QB boxes]
  blk.ring = blk.qs + 2 * wgmma_qboxes<DP>() * kWgmmaBox;      // [S][2 boxes]
  blk.bars = blk.ring + S * kWgmmaStage;
  uint32_t* keep = reinterpret_cast<uint32_t*>(
      smem + (blk.bars + 8 * (1 + 2 * S) - smem_u32(smem)));
  blk.keep = keep;
  blk.b = blockIdx.z;
  blk.h = blockIdx.y;
  blk.q0 = blockIdx.x * kWgmmaRows;
  if (threadIdx.x == 0) {
    mbar_init(blk.qfull(), 128);
    for (int s = 0; s < S; ++s) {
      mbar_init(blk.full(s), 128);
      mbar_init(blk.empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const float* mrow = mask == nullptr ? nullptr : mask + (long long)blk.b * L;
  for (int w = threadIdx.x / 32; 32 * w < L; w += kWgmmaThreads / 32) {
    const int key = 32 * w + threadIdx.x % 32;
    const uint32_t bits =
        __ballot_sync(0xffffffffu, key < L && (mrow == nullptr || __ldg(mrow + key) > 0.f));
    if (threadIdx.x % 32 == 0) keep[w] = bits;
  }
  __syncthreads();
  return blk;
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

// ---- the producer's copies ----

// chunks whose loads a producer thread has in flight at once: 4 spilled
// 48-68 bytes at the producer's 40 registers and slowed the cp.async path of
// the same kernels by 21-31% (PERF.md §6)
constexpr int kNarrowBatch = 2;

// The 4-byte words from the aligned floor of src (a bf16 row's element, at
// a 2-byte boundary) that hold its first `valid` elements (at most 8: a
// 16-byte chunk), 4 or 5 of them; no load and 0 for the others
__device__ __forceinline__ void narrow_load(uint32_t (&w)[5], const __nv_bfloat16* src,
                                            int valid) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uint32_t* p = reinterpret_cast<const uint32_t*>(a & ~(uintptr_t)3);
  const int last = valid > 0 ? ((int)(a >> 1 & 1) + min(valid, 8) - 1) / 2 : -1;
#pragma unroll
  for (int j = 0; j < 5; ++j) w[j] = j <= last ? __ldg(p + j) : 0u;
}

// The chunk narrow_load fetched for src, realigned where src lies 2 bytes
// past a word (each element pair the high half of one word and the low half
// of the next), its elements at or past `valid` zeros, stored in one 16-byte
// write at the shared-window address dst
__device__ __forceinline__ void narrow_store(uint32_t dst, const uint32_t (&w)[5],
                                             const __nv_bfloat16* src, int valid) {
  const bool odd = reinterpret_cast<uintptr_t>(src) & 2;
  uint32_t x[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t y = odd ? __byte_perm(w[i], w[i + 1], 0x5432) : w[i];
    x[i] = 2 * i + 1 < valid ? y : 2 * i < valid ? y & 0xffffu : 0u;
  }
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst), "r"(x[0]), "r"(x[1]),
               "r"(x[2]), "r"(x[3])
               : "memory");
}

// This thread's n narrow chunks, the loads of kNarrowBatch in flight before
// their stores: at(j, dst, src, valid) gives chunk j's shared-window
// address, its first element (an address in the tensor, also where nothing
// is read) and its elements below D (0 past L)
template <typename At>
__device__ __forceinline__ void narrow_copy(int n, At at) {
  for (int j0 = 0; j0 < n; j0 += kNarrowBatch) {
    uint32_t w[kNarrowBatch][5];
#pragma unroll
    for (int i = 0; i < kNarrowBatch; ++i) {
      uint32_t dst;
      const __nv_bfloat16* src;
      int valid;
      at(j0 + i, dst, src, valid);
      narrow_load(w[i], src, j0 + i < n ? valid : 0);
    }
#pragma unroll
    for (int i = 0; i < kNarrowBatch; ++i) {
      if (j0 + i < n) {
        uint32_t dst;
        const __nv_bfloat16* src;
        int valid;
        at(j0 + i, dst, src, valid);
        narrow_store(dst, w[i], src, valid);
      }
    }
  }
}

// The producer's copies in the 128-byte swizzle: element (row, 16-byte
// chunk cc) of a box of 64 rows at row * 128 + (cc ^ row % 8) * 16; by
// cp.async, or narrow (kNarrow: the header's Design), each compiled apart.
// Q's 128 rows from q0 (src: the head's first row), its DP / 8 chunks a row
// in wgmma_qboxes boxes a 64-row warpgroup; rows past L and columns at or
// past D read as zeros
template <int DP, bool kNarrow>
__device__ __forceinline__ void wgmma_copy_q(uint32_t qs, const __nv_bfloat16* src, long long rs,
                                             int q0, int L, int D, int tid) {
  constexpr int QC = DP / 8, QB = wgmma_qboxes<DP>();
  const auto at = [&](int i, int& row, int& cc) {
    row = i / QC;
    cc = i % QC;
    return qs + (row / 64 * QB + cc / 8) * kWgmmaBox + row % 64 * 128 +
           ((cc % 8 ^ row % 8) << 4);
  };
  if constexpr (kNarrow) {
    narrow_copy(QC, [&](int j, uint32_t& dst, const __nv_bfloat16*& s, int& valid) {
      int row, cc;
      dst = at(tid + 128 * j, row, cc);
      s = src + (long long)min(q0 + row, L - 1) * rs + 8 * cc;
      valid = q0 + row < L ? D - 8 * cc : 0;
    });
  } else {
    const int chunks = D / 8;
    for (int i = tid; i < 128 * QC; i += 128) {
      int row, cc;
      const uint32_t dst = at(i, row, cc);
      const bool ok = q0 + row < L && cc < chunks;
      cp_async16_to(dst, src + (ok ? (long long)(q0 + row) * rs + 8 * cc : 0), ok);
    }
  }
}
// A tile: keys key0 .. key0 + 63, columns from 128 cb (piece cb), its first
// `width` chunks (the two boxes of a stage hold 16); keys past L and columns
// at or past D read as zeros, chunks past `width` are not written.  Thread
// tid takes chunk tid % 16 of rows tid / 16 + 8 j.
template <bool kNarrow>
__device__ __forceinline__ void wgmma_copy_tile(uint32_t dst, const __nv_bfloat16* src,
                                                long long rs, int key0, int cb, int width, int L,
                                                int D, int tid) {
  if constexpr (kNarrow) {
    const int cc = tid % 16, col = 8 * (16 * cb + cc);
    if (cc < width)
      narrow_copy(8, [&](int j, uint32_t& d, const __nv_bfloat16*& s, int& valid) {
        const int row = tid / 16 + 8 * j, key = key0 + row;
        d = dst + cc / 8 * kWgmmaBox + row * 128 + ((cc % 8 ^ row % 8) << 4);
        s = src + (long long)min(key, L - 1) * rs + col;
        valid = key < L ? D - col : 0;
      });
  } else {
    const int chunks = D / 8;
#pragma unroll
    for (int e = tid; e < 64 * 16; e += 128) {
      const int row = e / 16, cc = e % 16, key = key0 + row, col = 16 * cb + cc;
      if (cc >= width) continue;
      const bool ok = key < L && col < chunks;
      cp_async16_to(dst + cc / 8 * kWgmmaBox + row * 128 + ((cc % 8 ^ row % 8) << 4),
                    src + (ok ? (long long)key * rs + 8 * col : 0), ok);
    }
  }
}
// This producer thread's arrival on a stage's (or Q's) barrier, one of its
// 128, once its copies are in: cp.async's own arrival (.noinc), or after the
// narrow copies' stores a proxy fence (the consumers' wgmma reads through
// the async proxy) and a plain arrival
template <bool kNarrow>
__device__ __forceinline__ void wgmma_filled(uint32_t bar) {
  if constexpr (kNarrow) {
    fence_proxy_async();
    mbar_arrive(bar);
  } else {
    cp_async_arrive(bar);
  }
}

// s (+)= the scores of the warpgroup's 64 rows (Q at qw) against a tile's 64
// keys (K at kst) over piece dh of the depth (columns 128 dh ..), one
// m64n64k16 product a 16-deep slice, Q and K both K-major; the first slice
// of piece 0 overwrites s, so the pieces, taken in order, add every slice of
// the depth in one chain.  Issued and committed as one group: the caller
// waits (wgmma_wait) before it reads s.  The same products in the same
// order give the same sums (the two-pass kernels rely on it).
template <int DP>
__device__ __forceinline__ void wgmma_scores(float (&s)[32], uint32_t qw, uint32_t kst, int dh) {
  fence_operands(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < wgmma_slices<DP>(dh); ++kk)
    wgmma_m64n64k16_ss(s, sw128_desc(qw + (2 * dh + kk / 4) * kWgmmaBox + 32 * (kk % 4)),
                       sw128_desc(kst + kk / 4 * kWgmmaBox + 32 * (kk % 4)), dh > 0 || kk > 0);
  wgmma_commit();
}

// s[4 n + 2 r + e], row g + 8 r against key key0 + 8 n + 2 t + e (key0 a
// multiple of 64): scaled, -1e30 on masked keys (their bits clear in keep),
// -inf past L
__device__ __forceinline__ void wgmma_mask(float (&s)[32], int key0, int L, const uint32_t* keep,
                                           float scale, int t) {
  const uint32_t words[2] = {keep[key0 / 32], keep[key0 / 32 + 1]};  // past L: not read
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int key = key0 + 8 * n + 2 * t;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool past = key + e >= L;
      const bool kp = (words[n / 4] >> (8 * n % 32 + 2 * t + e)) & 1u;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float& x = s[4 * n + 2 * r + e];
        x = past ? -INFINITY : (kp ? x * scale : -1e30f);
      }
    }
  }
}

// The weights of a tile normalised (div_by) and rounded to bf16 into P V's A
// fragments: p[kk] holds keys 16 kk .., p[kk][a] row g + 8 (a % 2), keys
// 16 kk + 8 (a / 2) + 2 t, + 1.  kExp: s holds the scores (exp(s - m) taken
// here), else exp(s - m) already
template <bool kExp>
__device__ __forceinline__ void wgmma_weights(const float (&s)[32], const float (&m)[2],
                                              const float (&denom)[2], const float (&inv)[2],
                                              uint32_t (&p)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int c = 8 * kk + 2 * a, r = a % 2;
      const float x0 = kExp ? expf(s[c] - m[r]) : s[c];
      const float x1 = kExp ? expf(s[c + 1] - m[r]) : s[c + 1];
      p[kk][a] = pack_bf16x2(div_by(x0, denom[r], inv[r]), div_by(x1, denom[r], inv[r]));
    }
}

// The two-pass kernels' first pass over a tile's scores s: the running row
// max m (the quad's) and this thread's share of the sum, rescaled when the
// max grows
__device__ __forceinline__ void wgmma_running_sum(const float (&s)[32], float (&m)[2],
                                                  float (&sum)[2]) {
  float tm[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int c = 0; c < 32; ++c) tm[c % 4 / 2] = fmaxf(tm[c % 4 / 2], s[c]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    tm[r] = fmaxf(tm[r], __shfl_xor_sync(0xffffffffu, tm[r], 1));
    tm[r] = fmaxf(tm[r], __shfl_xor_sync(0xffffffffu, tm[r], 2));
    const float mn = fmaxf(m[r], tm[r]);  // finite: a tile holds a key below L
    sum[r] *= expf(m[r] - mn);            // 0 on the first tile
    m[r] = mn;
  }
#pragma unroll
  for (int c = 0; c < 32; ++c) sum[c % 4 / 2] += expf(s[c] - m[c % 4 / 2]);
}

// The quad's shares of a row's sum added, denom = sum + 1e-30 and its
// reciprocal (div_by's)
__device__ __forceinline__ void wgmma_denominators(float (&sum)[2], float (&denom)[2],
                                                   float (&inv)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    denom[r] = sum[r] + 1e-30f;
    inv[r] = __frcp_rn(denom[r]);
  }
}

// o[nb] (+)= P[64 x 64 keys] V[64 keys x the nb-th 64-column box of the
// stage at vst], V MN-major (the transpose bit); accumulate 0 overwrites o.
// Issued and committed as one group; p and o are the products' until the
// caller has waited for it.
template <int NB>
__device__ __forceinline__ void wgmma_pv(float (&o)[NB][32], const uint32_t (&p)[4][4],
                                         uint32_t vst, bool accumulate) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) fence_operands(o[nb]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      wgmma_m64n64k16_rs_mn(o[nb], p[kk], sw128_desc_mn(vst + nb * kWgmmaBox + kk * 16 * 128,
                                                        kWgmmaBox),
                            accumulate || kk > 0);
  wgmma_commit();
}

// o[nb][4 n + 2 r + e]: row `row` + 8 r, column col0 + 64 nb + 8 n + 2 t + e,
// stored below L and D: two elements a store (D % 8 == 0) where !kNarrow;
// else a pair a store where `pairs` (every row of the head starts on a
// pair's boundary; at odd D the last column alone), else an element a store
template <int NB, bool kNarrow, typename TO>
__device__ __forceinline__ void wgmma_store(TO* op, long long out_rs, int row, int L, int D,
                                            int col0, const float (&o)[NB][32], int t,
                                            bool pairs) {
  if (!kNarrow || pairs) {
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = col0 + 64 * nb + 8 * n + 2 * t;
        if (kNarrow ? col + 1 < D : col < D) {
          if (row < L) store2(op + (long long)row * out_rs + col, o[nb][4 * n], o[nb][4 * n + 1]);
          if (row + 8 < L)
            store2(op + (long long)(row + 8) * out_rs + col, o[nb][4 * n + 2], o[nb][4 * n + 3]);
        } else if (kNarrow && col < D) {
          if (row < L) op[(long long)row * out_rs + col] = from_float<TO>(o[nb][4 * n]);
          if (row + 8 < L)
            op[(long long)(row + 8) * out_rs + col] = from_float<TO>(o[nb][4 * n + 2]);
        }
      }
    return;
  }
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = col0 + 64 * nb + 8 * n + 2 * t + e % 2, r = row + 8 * (e / 2);
        if (col < D && r < L) op[(long long)r * out_rs + col] = from_float<TO>(o[nb][4 * n + e]);
      }
}

// The one-pass kernel's producer warpgroup: Q, then K's tiles (P column
// pieces each), then V's by piece, by cp.async or narrow (kNarrow), each
// stage once the consumers have released it
template <int DP, bool kNarrow>
__device__ __forceinline__ void wgmma_one_pass_produce(const WgmmaBlock<DP>& blk,
                                                       const __nv_bfloat16* q,
                                                       const __nv_bfloat16* k,
                                                       const __nv_bfloat16* v, long long rs,
                                                       int L, int D, int tid) {
  constexpr int S = WgmmaBlock<DP>::S, P = wgmma_pieces<DP>();
  const int nt = (L + kWgmmaKeys - 1) / kWgmmaKeys;
  wgmma_copy_q<DP, kNarrow>(blk.qs, q, rs, blk.q0, L, D, tid);
  wgmma_filled<kNarrow>(blk.qfull());
  for (int n = 0; n < 2 * P * nt; ++n) {
    const bool is_k = n < P * nt;
    const int j = is_k ? n / P : (n - P * nt) % nt;
    const int cb = is_k ? n % P : (n - P * nt) / nt, stage = n % S;
    mbar_wait_bounded(blk.empty(stage), ((n / S) & 1) ^ 1);
    wgmma_copy_tile<kNarrow>(blk.ring + stage * kWgmmaStage, is_k ? k : v, rs, j * kWgmmaKeys,
                             cb, is_k ? wgmma_width<DP>(cb) / 8 : 8 * wgmma_vboxes<DP>(cb), L,
                             D, tid);
    wgmma_filled<kNarrow>(blk.full(stage));
  }
  cp_async_wait_all();
}

// The wgmma kernels' arguments, as launch_wgmma_kernel passes them
#define ESV_WGMMA_PARAMS                                                                      \
  const __nv_bfloat16 *__restrict__ q, const __nv_bfloat16 *__restrict__ k,                   \
      const __nv_bfloat16 *__restrict__ v, const float *__restrict__ mask,                    \
      TO *__restrict__ out, int L, int D, long long in_bs, long long in_rs, long long out_bs, \
      long long out_rs, float scale
#define ESV_WGMMA_ARGS q, k, v, mask, out, L, D, in_bs, in_rs, out_bs, out_rs, scale

// bf16 q, k, v at a head dim D of padded depth DP (DP 80-128 or 160-512; at
// 80-128 D % 8 == 0), 16 < L <= 256: a block of kWgmmaRows query rows, one
// pass (the header's Design).  kNarrow (past depth 128): rows that are not
// whole 16-byte chunks, the producer's narrow copies; compiled apart, for
// the narrow producer's code in the same kernel cost the cp.async path 6-10%
// at depth 336 (PERF.md §6)
template <typename TO, int DP, bool kNarrow>
__device__ __forceinline__ void wgmma_one_pass(ESV_WGMMA_PARAMS) {
  static_assert(std::is_same<TO, __nv_bfloat16>::value, "bf16 out");
  static_assert(DP % 16 == 0 && DP > 64 && DP <= kAttnMaxHeadDim, "padded depth");
  constexpr int S = WgmmaBlock<DP>::S, kTiles = kWgmmaMaxKeys / kWgmmaKeys;
  constexpr int P = wgmma_pieces<DP>(), QB = wgmma_qboxes<DP>();
  // up to depth 256 every piece of K's tiles fits in the ring, and every
  // score product is issued before the first wait; past it (3 or 4 pieces a
  // tile, 6-8 stages) the ring streams them: each product's wait frees the
  // stage of the one before
  constexpr bool kStream = P * kTiles > S;
  extern __shared__ __align__(1024) unsigned char wgmma_smem[];
  const WgmmaBlock<DP> blk = wgmma_block<DP>(wgmma_smem, mask, L);
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128, b = blk.b, h = blk.h, q0 = blk.q0;
  const int nt = (L + kWgmmaKeys - 1) / kWgmmaKeys;
  const long long in_off = (long long)b * in_bs + (long long)h * D;

  static_assert(!kNarrow || DP > 128, "narrow rows only past depth 128");
  if (wg == 2) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    wgmma_one_pass_produce<DP, kNarrow>(blk, q + in_off, k + in_off, v + in_off, in_rs, L, D, tid);
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const bool active = q0 + 64 * wg < L;  // a warpgroup wholly past L keeps the barriers only
  const uint32_t qw = blk.qs + wg * QB * kWgmmaBox;
  WgmmaRing<S> ring = blk.consumer_ring();
  mbar_wait_bounded(blk.qfull(), 0);

  // scores: s[j][4n + 2r + e] is row 16 warp + g + 8r against key 64 j + 8n + 2t + e;
  // every tile's products issued before the first wait (kStream: the one
  // before each in flight)
  float s[kTiles][32];
#pragma unroll
  for (int j = 0; j < kTiles; ++j) {
    if (j < nt) {
#pragma unroll
      for (int dh = 0; dh < P; ++dh) {  // columns 128 dh ..
        const uint32_t kst = ring.take();
        if (active) wgmma_scores<DP>(s[j], qw, kst, dh);
        if constexpr (kStream) {
          wgmma_wait<1>();
          ring.release(ring.taken - 1);
        }
      }
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < kTiles; ++j) fence_operands(s[j]);
  ring.release(ring.taken);

  // the exact row max and sum, the weights normalised (div_by) and rounded
  // to bf16 into P V's A fragments: p[j][kk] holds keys 64 j + 16 kk ..
  uint32_t p[kTiles][4][4];
  if (active) {
    float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kTiles; ++j) {
      if (j < nt) {
        wgmma_mask(s[j], j * kWgmmaKeys, L, blk.keep, scale, t);
#pragma unroll
        for (int c = 0; c < 32; ++c) m[c % 4 / 2] = fmaxf(m[c % 4 / 2], s[j][c]);
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
    for (int j = 0; j < kTiles; ++j)
      if (j < nt) wgmma_weights<false>(s[j], m, denom, inv, p[j]);
  }

  // P V, one piece of the output columns at a time (NB 64-column boxes),
  // every tile's products issued before the wait: o[nb][4n + 2r + e] is row
  // 16 warp + g + 8r, column 128 half + 64 nb + 8n + 2t + e
  TO* op = out + (long long)b * out_bs + (long long)h * D;
  // rows of whole 16-byte chunks: an output of pairs (wide_takes' and
  // launch_attention_dim's calls); else pairs where this head's rows allow
  const bool pairs = !kNarrow || (reinterpret_cast<uintptr_t>(op) % (2 * sizeof(TO)) == 0 &&
                                  out_rs % 2 == 0);
  const int row = q0 + 64 * wg + 16 * warp + g;
  const auto pv_piece = [&](auto boxes, int half) {
    constexpr int NB = decltype(boxes)::value;
    float o[NB][32];
#pragma unroll
    for (int j = 0; j < kTiles; ++j) {
      if (j < nt) {
        const uint32_t vst = ring.take();
        if (active) wgmma_pv<NB>(o, p[j], vst, j > 0);
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_operands(o[nb]);
    ring.release(ring.taken);
    if (active) wgmma_store<NB, kNarrow>(op, out_rs, row, L, D, 128 * half, o, t, pairs);
  };
  // the pieces of 128 columns in a loop, then the last where it is narrower
  constexpr int kWhole = wgmma_width<DP>(P - 1) == 128 ? P : P - 1;
#pragma unroll 1
  for (int half = 0; half < kWhole; ++half) pv_piece(std::integral_constant<int, 2>(), half);
  if constexpr (kWhole < P)
    pv_piece(std::integral_constant<int, wgmma_vboxes<DP>(P - 1)>(), P - 1);
}

// The one-pass kernel up to depth 256 (attention_kernel_wgmma) and past it
// (attention_kernel_wgmma_deep): the same code under names of their own, so
// that the launch counts tell them apart
template <typename TO, int DP, bool kNarrow = false>
__global__ void __launch_bounds__(kWgmmaThreads, 1) attention_kernel_wgmma(ESV_WGMMA_PARAMS) {
  static_assert(DP <= 256, "past depth 256: attention_kernel_wgmma_deep");
  wgmma_one_pass<TO, DP, kNarrow>(ESV_WGMMA_ARGS);
}

template <typename TO, int DP, bool kNarrow = false>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
    attention_kernel_wgmma_deep(ESV_WGMMA_PARAMS) {
  static_assert(DP > 256, "up to depth 256: attention_kernel_wgmma");
  wgmma_one_pass<TO, DP, kNarrow>(ESV_WGMMA_ARGS);
}


// bf16 q, k, v at a head dim D of padded depth DP (D % 8 == 0, DP <= 128),
// rows past 256 keys: a block of kWgmmaRows query rows, two passes over K
// (the header's Design)
template <typename TO, int DP>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
    attention_kernel_wgmma_2pass(ESV_WGMMA_PARAMS) {
  static_assert(std::is_same<TO, __nv_bfloat16>::value, "bf16 out");
  static_assert(DP % 16 == 0 && DP <= 128, "padded depth: one piece");
  constexpr int S = WgmmaBlock<DP>::S, QB = wgmma_qboxes<DP>(), NB = wgmma_vboxes<DP>(0);
  extern __shared__ __align__(1024) unsigned char wgmma_smem[];
  const WgmmaBlock<DP> blk = wgmma_block<DP>(wgmma_smem, mask, L);
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128, b = blk.b, h = blk.h, q0 = blk.q0;
  const int nt = (L + kWgmmaKeys - 1) / kWgmmaKeys;
  const long long in_off = (long long)b * in_bs + (long long)h * D;

  if (wg == 2) {  // producer: Q; K's tiles (pass 1); K's and V's tile j in turn (pass 2)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    wgmma_copy_q<DP, false>(blk.qs, q + in_off, in_rs, q0, L, D, tid);
    wgmma_filled<false>(blk.qfull());
    for (int n = 0; n < 3 * nt; ++n) {
      const bool is_k = n < nt || (n - nt) % 2 == 0;
      const int j = n < nt ? n : (n - nt) / 2, stage = n % S;
      mbar_wait_bounded(blk.empty(stage), ((n / S) & 1) ^ 1);
      wgmma_copy_tile<false>(blk.ring + stage * kWgmmaStage, (is_k ? k : v) + in_off, in_rs,
                             j * kWgmmaKeys, 0, is_k ? DP / 8 : 8 * NB, L, D, tid);
      wgmma_filled<false>(blk.full(stage));
    }
    cp_async_wait_all();
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const bool active = q0 + 64 * wg < L;  // a warpgroup wholly past L only takes stages
  const uint32_t qw = blk.qs + wg * QB * kWgmmaBox;
  WgmmaRing<S> ring = blk.consumer_ring();
  mbar_wait_bounded(blk.qfull(), 0);
  // a tile's scores: s[4n + 2r + e] is row 16 warp + g + 8r against key
  // 64 j + 8n + 2t + e, scaled and masked
  const auto scores = [&](float (&s)[32], int j) {
    const uint32_t kst = ring.take();
    if (active) wgmma_scores<DP>(s, qw, kst, 0);
    wgmma_wait<0>();
    fence_operands(s);
    ring.release(ring.taken);
    if (active) wgmma_mask(s, j * kWgmmaKeys, L, blk.keep, scale, t);
  };

  // pass 1: each row's running max and sum (wgmma_running_sum)
  float m[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll 1
  for (int j = 0; j < nt; ++j) {
    float s[32];
    scores(s, j);
    if (active) wgmma_running_sum(s, m, sum);
  }
  float denom[2], inv[2];
  wgmma_denominators(sum, denom, inv);

  // pass 2: each tile's scores again (the same products in the same order),
  // exp(s - max) normalised and rounded to bf16 into P V's A fragments,
  // times V: o[nb][4n + 2r + e] is row 16 warp + g + 8r, column 64 nb + 8n
  // + 2t + e
  float o[NB][32];
#pragma unroll 1
  for (int j = 0; j < nt; ++j) {
    float s[32];
    scores(s, j);
    uint32_t p[4][4];
    if (active) wgmma_weights<true>(s, m, denom, inv, p);
    const uint32_t vst = ring.take();
    if (active) wgmma_pv<NB>(o, p, vst, j > 0);
    wgmma_wait<0>();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_operands(o[nb]);
    ring.release(ring.taken);
  }
  if (active)  // launch_attention_dim's rows: whole 16-byte chunks, an aligned output
    wgmma_store<NB, false>(out + (long long)b * out_bs + (long long)h * D, out_rs,
                           q0 + 64 * wg + 16 * warp + g, L, D, 0, o, t, true);
}

// The two-pass kernel past depth 128 (layout (A), PERF.md §6): a block is
// kWgmmaRows query rows, a warpgroup 64 of them, over the output's columns
// in chunks of kTwoPassDeepPieces pieces (64 P V accumulators a thread each;
// the registers hold no more), two_pass_deep_chunks blocks an item, each
// taking both score passes over the whole depth: one block up to depth 256,
// two past it.  measure/attention_variants.py's twopass_deep_shared is the
// layout it was timed against (two warpgroups on 64 rows, each over half of
// the pieces, their partial scores added in shared memory).
constexpr int kTwoPassDeepPieces = 2;
template <int DP>
__host__ __device__ constexpr int two_pass_deep_chunks() {
  return (wgmma_pieces<DP>() + kTwoPassDeepPieces - 1) / kTwoPassDeepPieces;
}

// attention_kernel_wgmma_2pass_deep's producer warpgroup: Q's 128 rows from
// q0, then K's pieces of every tile (pass 1), then each tile's K pieces and
// the block's `pieces` V pieces from c0 (pass 2), each a stage once the
// consumers have released it, by cp.async or narrow (kNarrow); V's two
// 64-column boxes whole (past D zeros)
template <int DP, bool kNarrow>
__device__ __forceinline__ void wgmma_two_pass_produce(const WgmmaBlock<DP>& blk,
                                                       const __nv_bfloat16* q,
                                                       const __nv_bfloat16* k,
                                                       const __nv_bfloat16* v, long long rs,
                                                       int q0, int c0, int pieces, int L, int D,
                                                       int tid) {
  constexpr int S = WgmmaBlock<DP>::S, P = wgmma_pieces<DP>();
  const int nt = (L + kWgmmaKeys - 1) / kWgmmaKeys, per = P + pieces;
  wgmma_copy_q<DP, kNarrow>(blk.qs, q, rs, q0, L, D, tid);
  wgmma_filled<kNarrow>(blk.qfull());
  for (int n = 0; n < nt * (P + per); ++n) {
    const int m = n - P * nt;  // pass 2's stages from 0
    const int j = m < 0 ? n / P : m / per, i = m < 0 ? n % P : m % per;
    const int cb = i < P ? i : c0 + i - P, stage = n % S;
    mbar_wait_bounded(blk.empty(stage), ((n / S) & 1) ^ 1);
    wgmma_copy_tile<kNarrow>(blk.ring + stage * kWgmmaStage, i < P ? k : v, rs, j * kWgmmaKeys,
                             cb, i < P ? wgmma_width<DP>(cb) / 8 : 16, L, D, tid);
    wgmma_filled<kNarrow>(blk.full(stage));
  }
  cp_async_wait_all();
}

// bf16 q, k, v at a head dim D of padded depth DP (160-512, rows of any width
// and offset), rows past kWgmmaMaxKeys keys: attention_kernel_wgmma_2pass's
// arithmetic over K's and V's pieces of 128 columns (the header's Design),
// in layout (A) above.  Block blockIdx.x is query rows kWgmmaRows (blockIdx.x
// / C) .. and output column chunk blockIdx.x % C.  The producer sends K's
// pieces of every tile (pass 1), then K's pieces of tile j and V's pieces
// of the block's columns in turn (pass 2), each a ring stage that both
// consumer warpgroups take and release in order.  Every tile's score
// products chain over the pieces in order, each wait freeing the stage of
// the piece before: both passes take the same products in the same order,
// the same sums, bit for bit.  kNarrow: rows that are not whole 16-byte
// chunks, the producer's narrow copies (compiled apart, as
// attention_kernel_wgmma's)
template <typename TO, int DP, bool kNarrow = false>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
    attention_kernel_wgmma_2pass_deep(ESV_WGMMA_PARAMS) {
  static_assert(std::is_same<TO, __nv_bfloat16>::value, "bf16 out");
  static_assert(DP % 16 == 0 && DP > 128 && DP <= kAttnMaxHeadDim, "padded depth past 128");
  constexpr int S = WgmmaBlock<DP>::S, P = wgmma_pieces<DP>(), QB = wgmma_qboxes<DP>();
  constexpr int C = two_pass_deep_chunks<DP>();
  // the output pieces a block holds
  constexpr int PC = P < kTwoPassDeepPieces ? P : kTwoPassDeepPieces;
  static_assert(S >= PC, "pass 2 holds every V piece of a tile at once");
  extern __shared__ __align__(1024) unsigned char wgmma_smem[];
  const WgmmaBlock<DP> blk = wgmma_block<DP>(wgmma_smem, mask, L);
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128, b = blk.b, h = blk.h;
  const int q0 = blockIdx.x / C * kWgmmaRows, c0 = PC * (blockIdx.x % C);
  const int pieces = min(PC, P - c0);  // the block's output pieces, from c0
  const int nt = (L + kWgmmaKeys - 1) / kWgmmaKeys;
  const long long in_off = (long long)b * in_bs + (long long)h * D;

  if (wg == 2) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    wgmma_two_pass_produce<DP, kNarrow>(blk, q + in_off, k + in_off, v + in_off, in_rs, q0, c0,
                                        pieces, L, D, tid);
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int row0 = q0 + 64 * wg;
  const bool active = row0 < L;  // else the warpgroup only takes the stages
  const uint32_t qw = blk.qs + wg * QB * kWgmmaBox;
  WgmmaRing<S> ring = blk.consumer_ring();
  mbar_wait_bounded(blk.qfull(), 0);
  // a tile's scores: s[4n + 2r + e] is row 16 warp + g + 8r against key
  // 64 j + 8n + 2t + e, scaled and masked; the pieces chained in order, one
  // product in flight while the next stage is taken
  const auto scores = [&](float (&s)[32], int j) {
#pragma unroll
    for (int dh = 0; dh < P; ++dh) {
      const uint32_t kst = ring.take();
      if (active) wgmma_scores<DP>(s, qw, kst, dh);
      wgmma_wait<1>();
      ring.release(ring.taken - 1);
    }
    wgmma_wait<0>();
    fence_operands(s);
    ring.release(ring.taken);
    if (active) wgmma_mask(s, j * kWgmmaKeys, L, blk.keep, scale, t);
  };

  // pass 1: each row's running max and sum (wgmma_running_sum)
  float m[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll 1
  for (int j = 0; j < nt; ++j) {
    float s[32];
    scores(s, j);
    if (active) wgmma_running_sum(s, m, sum);
  }
  float denom[2], inv[2];
  wgmma_denominators(sum, denom, inv);

  // pass 2: each tile's scores again, exp(s - max) normalised and rounded to
  // bf16 into P V's A fragments, times V's pieces of the block's columns:
  // o[i][nb][4n + 2r + e] is row 16 warp + g + 8r, column 128 (c0 + i) +
  // 64 nb + 8n + 2t + e
  float o[PC][2][32];
#pragma unroll 1
  for (int j = 0; j < nt; ++j) {
    float s[32];
    scores(s, j);
    uint32_t p[4][4];
    if (active) wgmma_weights<true>(s, m, denom, inv, p);
#pragma unroll
    for (int i = 0; i < PC; ++i) {  // V's stages, in the producer's order
      if (i < pieces) {
        const uint32_t vst = ring.take();
        if (active) wgmma_pv<2>(o[i], p, vst, j > 0);
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < PC; ++i)
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) fence_operands(o[i][nb]);
    ring.release(ring.taken);
  }
  if (!active) return;
  TO* op = out + (long long)b * out_bs + (long long)h * D;
  // rows of whole 16-byte chunks: an output of pairs; else pairs where this
  // head's rows allow
  const bool pairs = !kNarrow || (reinterpret_cast<uintptr_t>(op) % (2 * sizeof(TO)) == 0 &&
                                  out_rs % 2 == 0);
#pragma unroll
  for (int i = 0; i < PC; ++i)
    if (i < pieces)
      wgmma_store<2, kNarrow>(op, out_rs, row0 + 16 * warp + g, L, D, 128 * (c0 + i), o[i], t,
                              pairs);
}

#undef ESV_ACC32
#undef ESV_ACC32_OPERANDS
#undef ESV_WGMMA_PARAMS
#undef ESV_WGMMA_ARGS

// Whether the kernels above take a call at a padded depth past 128 (bf16 at
// every one, float32 at 256 only: launch_attention_padded) past 16 keys:
// bf16 up to kWgmmaMaxKeys in rows of any width and offset (launch_wgmma_kernel
// picks the copy); float32 in rows of whole 16-byte chunks (D * sizeof(T) %
// 16 == 0, q, k, v and their strides 16-byte aligned) and an output written
// two elements at a time
template <typename T, typename TO>
static bool wide_takes(const T* q, const T* k, const T* v, const TO* out, int L, int D,
                       long long in_bs, long long in_rs, long long out_bs, long long out_rs) {
  if (!std::is_same<T, float>::value) return L > 16 && L <= kWgmmaMaxKeys;
  return L > 16 && (D * sizeof(T)) % 16 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
         (in_bs * sizeof(T)) % 16 == 0 && (in_rs * sizeof(T)) % 16 == 0 &&
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

// Kernel (attention_kernel_wgmma[_deep] or attention_kernel_wgmma_2pass[_deep]
// at depth DP) on blocks of kWgmmaRows query rows, C blocks an item (the
// column chunks of attention_kernel_wgmma_2pass_deep), counted under `kind`
template <auto Kernel, int DP, typename TO, int C = 1>
static cudaError_t launch_wgmma_kernel(AttnKernel kind, const __nv_bfloat16* q,
                                       const __nv_bfloat16* k, const __nv_bfloat16* v,
                                       const float* mask, TO* out, int B, int H, int L, int D,
                                       long long in_bs, long long in_rs, long long out_bs,
                                       long long out_rs, cudaStream_t stream) {
  // bytes: 181,896 at depths 160-192, 198,280 at 224, 214,664 at 288, 231,048
  // at 336-384 (8 stages), 231,032 at 448 (7), 231,016 at 512 (6)
  static_assert(wgmma_smem_bytes<DP>() <= kPaddedSmemMax, "shared memory");
  const cudaError_t err = wide_attribute<Kernel, wgmma_smem_bytes<DP>()>();
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf((float)D);  // of the true head dim, as the TPU kernel's
  Kernel<<<dim3((L + kWgmmaRows - 1) / kWgmmaRows * C, H, B), kWgmmaThreads,
           wgmma_smem_bytes<DP>(), stream>>>(q, k, v, mask, out, L, D, in_bs, in_rs, out_bs,
                                             out_rs, scale);
  return counted_launch(kind);
}

// Whether a bf16 call past depth 128 takes the wgmma kernels' cp.async copies
// (rows of whole 16-byte chunks on 16-byte boundaries, an output written two
// elements at a time), not the instantiation with the producer's narrow copies
template <typename TO>
static bool wgmma_whole_chunks(const __nv_bfloat16* q, const __nv_bfloat16* k,
                               const __nv_bfloat16* v, const TO* out, int D, long long in_bs,
                               long long in_rs, long long out_bs, long long out_rs) {
  return D % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) && in_bs % 8 == 0 &&
         in_rs % 8 == 0 && reinterpret_cast<uintptr_t>(out) % (2 * sizeof(TO)) == 0 &&
         out_bs % 2 == 0 && out_rs % 2 == 0;
}

// bf16 at a head dim D of padded depth DP, 16 < L <= kWgmmaMaxKeys: one pass
// (launch_attention_dim at D = 72-128, launch_attention_wide at depths
// 160-512 in rows of any width), past depth 256 as
// attention_kernel_wgmma_deep; rows that are not whole 16-byte chunks on
// 16-byte boundaries (past depth 128 only) on the instantiation with the
// producer's narrow copies, chosen here
template <int DP, typename TO>
static cudaError_t launch_attention_wgmma(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                          const __nv_bfloat16* v, const float* mask, TO* out,
                                          int B, int H, int L, int D, long long in_bs,
                                          long long in_rs, long long out_bs, long long out_rs,
                                          cudaStream_t stream) {
  if constexpr (DP > 128) {
    if (!wgmma_whole_chunks(q, k, v, out, D, in_bs, in_rs, out_bs, out_rs)) {
      if constexpr (DP > 256)
        return launch_wgmma_kernel<attention_kernel_wgmma_deep<TO, DP, true>, DP, TO>(
            kAttnKernelWgmmaDeep, q, k, v, mask, out, B, H, L, D, in_bs, in_rs, out_bs, out_rs,
            stream);
      else
        return launch_wgmma_kernel<attention_kernel_wgmma<TO, DP, true>, DP, TO>(
            kAttnKernelWgmma, q, k, v, mask, out, B, H, L, D, in_bs, in_rs, out_bs, out_rs,
            stream);
    }
  }
  if constexpr (DP > 256)
    return launch_wgmma_kernel<attention_kernel_wgmma_deep<TO, DP>, DP, TO>(
        kAttnKernelWgmmaDeep, q, k, v, mask, out, B, H, L, D, in_bs, in_rs, out_bs, out_rs,
        stream);
  else
    return launch_wgmma_kernel<attention_kernel_wgmma<TO, DP>, DP, TO>(
        kAttnKernelWgmma, q, k, v, mask, out, B, H, L, D, in_bs, in_rs, out_bs, out_rs, stream);
}

// bf16 at a head dim D of padded depth DP <= 128, L > kWgmmaMaxKeys: two
// passes (launch_attention_dim)
template <int DP, typename TO>
static cudaError_t launch_attention_wgmma_2pass(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                                const __nv_bfloat16* v, const float* mask,
                                                TO* out, int B, int H, int L, int D,
                                                long long in_bs, long long in_rs,
                                                long long out_bs, long long out_rs,
                                                cudaStream_t stream) {
  return launch_wgmma_kernel<attention_kernel_wgmma_2pass<TO, DP>, DP, TO>(
      kAttnKernelWgmma2Pass, q, k, v, mask, out, B, H, L, D, in_bs, in_rs, out_bs, out_rs,
      stream);
}

// bf16 at a head dim D of padded depth DP past 128, L > kWgmmaMaxKeys, rows
// of any width and offset: two passes (launch_attention_padded), on the
// instantiation with the producer's narrow copies where the rows are not
// whole 16-byte chunks on 16-byte boundaries
template <int DP, typename TO>
static cudaError_t launch_attention_wgmma_2pass_deep(const __nv_bfloat16* q,
                                                     const __nv_bfloat16* k,
                                                     const __nv_bfloat16* v, const float* mask,
                                                     TO* out, int B, int H, int L, int D,
                                                     long long in_bs, long long in_rs,
                                                     long long out_bs, long long out_rs,
                                                     cudaStream_t stream) {
  constexpr int C = two_pass_deep_chunks<DP>();  // blocks an item
  if (!wgmma_whole_chunks(q, k, v, out, D, in_bs, in_rs, out_bs, out_rs))
    return launch_wgmma_kernel<attention_kernel_wgmma_2pass_deep<TO, DP, true>, DP, TO, C>(
        kAttnKernelWgmma2PassDeep, q, k, v, mask, out, B, H, L, D, in_bs, in_rs, out_bs, out_rs,
        stream);
  return launch_wgmma_kernel<attention_kernel_wgmma_2pass_deep<TO, DP>, DP, TO, C>(
      kAttnKernelWgmma2PassDeep, q, k, v, mask, out, B, H, L, D, in_bs, in_rs, out_bs, out_rs,
      stream);
}

// On a call wide_takes at padded depth DP: attention_kernel_split_f32
// (float32 q, k, v; DP = 256 only) or the one-pass wgmma kernel (bf16)
template <int DP, typename T, typename TO>
static cudaError_t launch_attention_wide(const T* q, const T* k, const T* v, const float* mask,
                                         TO* out, int B, int H, int L, int D, long long in_bs,
                                         long long in_rs, long long out_bs, long long out_rs,
                                         cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    static_assert(DP == kSplitDepth, "float32: attention_kernel_split_f32's depth alone");
    const cudaError_t err = wide_attribute<attention_kernel_split_f32<TO>, split_smem_bytes()>();
    if (err != cudaSuccess) return err;
    const float scale = 1.0f / sqrtf((float)D);  // of the true head dim, as the TPU kernel's
    const dim3 grid((L + 16 * kSplitGroups - 1) / (16 * kSplitGroups), H, B);
    attention_kernel_split_f32<TO><<<grid, kSplitThreads, split_smem_bytes(), stream>>>(
        q, k, v, mask, out, L, D, in_bs, in_rs, out_bs, out_rs, scale);
    return counted_launch(kAttnKernelSplitF32);
  } else {
    return launch_attention_wgmma<DP, TO>(q, k, v, mask, out, B, H, L, D, in_bs, in_rs, out_bs,
                                          out_rs, stream);
  }
}

}  // namespace esv
