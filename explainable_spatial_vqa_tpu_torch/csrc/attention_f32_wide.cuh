// K1 in float32 at the padded depths 160-224 and 288-512, and K2's per-head
// attention at head dims 384 and 512: attention_kernel_wide_f32.  Replaces,
// at those depths,
// explainable_spatial_vqa_tpu/ops/pallas_attention.py:_fused_attention_bhld
// (:45-77) on float32 q, k, v and the per-head attention of
// ops/pallas_block.py:_block_kernel (:135-145).  launch_attention_padded
// (attention_padded.cuh) sends it the float32 calls past 16 keys whose rows
// are whole 16-byte chunks (wide_takes); the padded and deep float32 kernels
// keep the other rows (D = 275's), the short kernels L <= 16, and
// attention_kernel_split_f32 (attention_wide.cuh) depth 256.
//
// Arithmetic: attention.cuh's float32 path on the true head dim D: scores
// over the depth in 3xTF32 (split_tf32: hi rounded to nearest, lo exact;
// mma_3xtf32's three products in their order), each 8-deep slice summed by
// the tensor cores into a fresh accumulator and added in float32, scaled by
// 1/sqrt(D), -1e30 on masked keys and -inf past L; the softmax online over
// tiles of kF32WideKeys keys with sum + 1e-30; float32 weights, not rounded,
// times V in 3xTF32.  A 16-row group's G warps each sum the scores over
// their DG = DP / G columns, and the G partial sums are added in the order
// of the slices, 0 first, by every warp of the group.
//
// Bound on the H100: the three TF32 products, 12 L^2 D operations a head at
// 495 TFLOP/s (0.2803 ms for K2's attention at d_model 2048, B=128, H=4,
// L=210; the bytes, 0.07 ms, are less).  What held the padded and deep
// kernels it replaces (attention_padded.cuh's padded_attention_f32, PERF.md
// §6): every warp split its Q, K and V fragments into TF32 hi and lo parts
// at every load, each row group splitting the same K and V again, from
// 4-byte scalar loads; two block barriers a 32-key tile stalled all 8-9
// warps; the ring held 2-4 stages of whole rows, filled by the consumers
// themselves; and a block held 32-48 query rows at one block an SM.  Here:
//   * 2-4 producer warps stream K and V in pieces of DG columns and
//     kF32WideKeys keys, a ring stage each (f32w_stages: 6-12 stages, every
//     depth), in order, paced by full/empty mbarriers.  Each thread copies
//     its float4s of piece n + kF32WideAhead raw into that piece's stage
//     with cp.async (a release arrive after loads into registers would wait
//     for them), then splits its float4s of piece n in place, once for the
//     block, into hi and lo planes of rows of keys;
//   * the consumers load K's fragments with ldmatrix from the planes and
//     V's with 4-byte loads (conflict-free), and never split them; Q stays
//     raw in shared memory (its planes would not fit past depth 256 beside
//     the ring) and each warp splits its Q fragments once a key tile, after
//     one ldmatrix a slice;
//   * a 16-row group's partial scores meet in shared memory under a named
//     barrier of the group's G warps alone (bar.sync id, 32 G), the buffer
//     alternating by tile, so one barrier a tile suffices;
//   * 16 warps a block (128 registers a thread) at depths 160-224 and
//     448-512: 7 row groups of two warps (112 query rows: two blocks cover
//     the encoders' 208-210 keys) and 2 producers at 160-224, 3 row groups of
//     four (48 rows) and 4 producers at 448-512; at 288-384 12 warps (168
//     registers), 3 row groups of three and 3 producers.  The warps are
//     latency-bound on mma.sync, and more of them hide more: 12 warps at
//     160-224 and 448-512 (4 and 2 row groups) ran slower, though ptxas
//     spills up to 48 bytes at 512 with 16; at 288-384, where 16 warps would
//     add only producers, 12 ran faster (measure/attention_variants.py's
//     f32wide_warps12, f32wide_warps16 and f32wide_rows2, PERF.md §6).
#pragma once

#include "attention_wide.cuh"

namespace esv {

constexpr int kF32WideKeys = 16;       // keys a tile (a piece's rows)
constexpr int kF32WideMaxStages = 12;  // ring stages, at most (f32w_stages)
constexpr int kF32WideAhead = 1;       // pieces the producers copy ahead of the one they split

// At padded depth DP past 128 (but 256): G warps a 16-row group (one for
// each 128 columns or part of them, as attention_padded.cuh's padded_slices:
// 2 at 160-224, 3 at 288-384, 4 at 448-512), each a slice of
// DG = DP / G columns (a multiple of 16: padded_depth), R row groups a block
// (7 at G = 2, else 3: 9-14 consumer warps), and the block's warps: 16 (128
// registers a thread), but 12 at G = 3 (168), where more warps would be
// producers alone; the producers take the warps the consumers leave
template <int DP>
__host__ __device__ constexpr int f32w_group() {
  return (DP + 127) / 128;
}
template <int DP>
__host__ __device__ constexpr int f32w_slice() {
  return DP / f32w_group<DP>();
}
template <int DP>
__host__ __device__ constexpr int f32w_rows() {
  return f32w_group<DP>() == 2 ? 7 : 3;
}
template <int DP>
__host__ __device__ constexpr int f32w_warps() {
  return f32w_group<DP>() == 3 ? 12 : 16;
}
template <int DP>
__host__ __device__ constexpr int f32w_producers() {
  return f32w_warps<DP>() - f32w_rows<DP>() * f32w_group<DP>();
}
// The floats of one plane (hi or lo) of a ring stage: a piece of K or V as
// rows of keys, DG + 4 words a row
template <int DP>
__host__ __device__ constexpr int f32w_plane() {
  return kF32WideKeys * (f32w_slice<DP>() + 4);
}
// Q's raw rows (DP + 4 words a row), S stages of two planes, the exchange of
// partial scores (R groups, two tile parities, G warps, 16 x kF32WideKeys
// floats) and the mbarriers (Q's, full and empty per stage), in bytes
template <int DP>
__host__ __device__ constexpr size_t f32w_smem_at(int S) {
  return 4 * ((size_t)16 * f32w_rows<DP>() * (DP + 4) + (size_t)S * 2 * f32w_plane<DP>() +
              (size_t)f32w_rows<DP>() * 2 * f32w_group<DP>() * 16 * kF32WideKeys) +
         8 * (1 + 2 * (size_t)S);
}
// The ring's stages: kF32WideMaxStages where they fit in the 227 KB, else as
// many as fit
template <int DP>
__host__ __device__ constexpr int f32w_stages() {
  int s = kF32WideMaxStages;
  while (s > 2 && f32w_smem_at<DP>(s) > kPaddedSmemMax) --s;
  return s;
}

// float32 q, k, v at a head dim D (D % 4 == 0) of padded depth DP (160-224,
// 288-512), 16 < L <= kAttnMaxLen: R groups of 16 query rows a block, G
// warps a group, and the producer warps (the header's design)
template <typename TO, int DP>
__global__ void __launch_bounds__(32 * f32w_warps<DP>(), 1) attention_kernel_wide_f32(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ mask, TO* __restrict__ out, int L, int D, long long in_bs,
    long long in_rs, long long out_bs, long long out_rs, float scale) {
  constexpr int G = f32w_group<DP>(), DG = f32w_slice<DP>(), R = f32w_rows<DP>();
  constexpr int T = kF32WideKeys, NT = T / 8, S = f32w_stages<DP>(), A = kF32WideAhead;
  constexpr int LDQ = DP + 4, LDK = DG + 4, PLANE = f32w_plane<DP>();
  constexpr int kConsumers = R * G, kProducerWarps = f32w_producers<DP>();
  constexpr int NP = 32 * kProducerWarps;
  constexpr int kUnits = T * DG / 4, kPerThread = (kUnits + NP - 1) / NP;  // a piece's float4s
  static_assert(G > 1 && DG % 16 == 0 && DG <= 128 && DP <= kAttnMaxHeadDim && T % 16 == 0,
                "depth, tile");
  // S > G + A: the producers never wait for a stage that is freed only once
  // a piece they have yet to split is in; and a consumer that takes piece n
  // has taken n - G, so (the pieces are filled in order) the stage's
  // previous piece, n - S, is in and the full barrier's parity names n's
  // phase
  static_assert(S > G + A, "stages");
  extern __shared__ __align__(16) unsigned char attn_smem[];
  float* qs = reinterpret_cast<float*>(attn_smem);  // [16 R][LDQ]
  float* ring = qs + 16 * R * LDQ;                  // [S][hi, lo][PLANE]
  float* xs = ring + 2 * S * PLANE;                 // [R][tile parity][G][16 T]
  const uint32_t qbar = smem_u32(xs + R * 2 * G * 16 * T);
  const auto full = [&](int s) { return qbar + 8 * (1 + s); };
  const auto empty = [&](int s) { return qbar + 8 * (1 + S + s); };

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * 16 * R;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long in_off = (long long)b * in_bs + (long long)h * D;
  const int ntiles = (L + T - 1) / T, chunks = D / 4;
  if (threadIdx.x == 0) {
    mbar_init(qbar, NP);
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), kProducerWarps);  // each producer warp's first lane
      mbar_init(empty(s), R);              // the R warps of a slice, one from each group
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumers) {  // producers: Q once, then piece n = (tile, K or V, slice) in turn
    const int p = threadIdx.x - 32 * kConsumers;
    for (int i = p; i < 16 * R * (DP / 4); i += NP) {  // Q raw; zeros past L and D
      const int r = i / (DP / 4), c = i % (DP / 4);
      const bool ok = q0 + r < L && c < chunks;
      cp_async16(qs + r * LDQ + 4 * c, q + in_off + (ok ? (long long)(q0 + r) * in_rs + 4 * c : 0),
                 ok);
    }
    cp_async_arrive(qbar);
    // piece n: tile n / 2G, K's (n % 2G < G) or V's, columns DG (n % G) ..,
    // as rows of keys; every producer thread takes the float4s u = p, p +
    // NP, ... of each piece in turn (key u / (DG / 4), chunk u % (DG / 4):
    // their offsets in a stage and in a tile of the head's rows kept in
    // registers), copying piece n + A raw into its stage's hi plane before it
    // splits its float4s of piece n in place
    int at[kPerThread], key_of[kPerThread], chunk_of[kPerThread];
    long long from[kPerThread];
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int u = p + NP * i;
      key_of[i] = u < kUnits ? u / (DG / 4) : T;  // T: no float4 of this thread
      chunk_of[i] = u % (DG / 4);
      at[i] = key_of[i] * LDK + 4 * chunk_of[i];
      from[i] = (long long)key_of[i] * in_rs + 4 * chunk_of[i];
    }
    const int total = 2 * G * ntiles;
    const auto copy = [&](int n) {
      const int st = n % S, kt = n / (2 * G), col0 = n % G * DG;
      mbar_wait_bounded(empty(st), ((n / S) & 1) ^ 1);
      float* dst = ring + 2 * st * PLANE;
      const float* head = (n % (2 * G) < G ? k : v) + in_off;
      const float* tile = head + (long long)kt * T * in_rs + col0;
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        const bool ok = kt * T + key_of[i] < L && col0 / 4 + chunk_of[i] < chunks;
        if (key_of[i] < T) cp_async16(dst + at[i], ok ? tile + from[i] : head, ok);
      }
    };
    const auto split = [&](int n) {  // this thread's copies of piece n landed
      float* hi = ring + 2 * (n % S) * PLANE;
      float* lo = hi + PLANE;
      float4 x[kPerThread];
#pragma unroll
      for (int i = 0; i < kPerThread; ++i)
        if (key_of[i] < T) x[i] = *reinterpret_cast<const float4*>(hi + at[i]);
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        if (key_of[i] < T) {
          float4 xh, xl;
          split4(x[i], xh, xl);
          *reinterpret_cast<float4*>(hi + at[i]) = xh;
          *reinterpret_cast<float4*>(lo + at[i]) = xl;
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(full(n % S));
    };
#pragma unroll 1
    for (int n = 0; n < total + A; ++n) {
      if (n < total) copy(n);
      cp_async_commit();
      if (n >= A) {
        cp_async_wait<A>();
        split(n - A);
      }
    }
    return;
  }

  // consumers: warp `part` of group grp, rows 16 grp .. of the block, the
  // columns DG part .. of the depth and of the output
  const int grp = warp / G, part = warp % G, g = lane / 4, t = lane % 4;
  const bool active = q0 + 16 * grp < L;  // a group wholly past L keeps the stages' barriers only
  const float* mrow = mask == nullptr ? nullptr : mask + (long long)b * L;
  const float* qw = qs + 16 * grp * LDQ + part * DG;
  // ldmatrix rows and columns (a 8 x 8 b16 matrix is 8 rows of 4 floats):
  // A rows 0-7 / 8-15 at columns 0-3, then 4-7; B keys (or output columns)
  // 0-7 at depth (or keys) 0-3 and 4-7, then 8-15
  const int arow = lane % 8 + 8 * ((lane / 8) % 2), acol = 4 * (lane / 16);
  const int brow = lane % 8 + 8 * (lane / 16), bcol = 4 * ((lane / 8) % 2);
  // piece indices of tile kt: this warp's slice of K's, then of V's
  const auto kpiece = [&](int kt) { return 2 * G * kt + part; };
  const auto vpiece = [&](int kt) { return 2 * G * kt + G + part; };
  const auto take = [&](int n) { mbar_wait_bounded(full(n % S), (n / S) & 1); };
  const auto release = [&](int n) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(n % S));
  };
  mbar_wait_bounded(qbar, 0);
  if (!active) {  // the stages, each taken and released in turn
#pragma unroll 1
    for (int kt = 0; kt < ntiles; ++kt) {
      take(kpiece(kt));
      release(kpiece(kt));
      take(vpiece(kt));
      release(vpiece(kt));
    }
    return;
  }

  // this warp's slice of tile kt's scores (Q split here, once a tile), the
  // tile's key mask read beside it (keys kt T + 8n + 2t + e), and the
  // slice written to the group's exchange; K's stage released
  const auto scores = [&](int kt, float (&s)[NT][4], float (&kept)[NT][2]) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = kt * T + n * 8 + 2 * t + e;
        kept[n][e] = mrow == nullptr || key >= L ? 1.f : __ldg(mrow + key);
      }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = 0.f;
    const int nk = kpiece(kt);
    take(nk);
    const float* kh = ring + 2 * (nk % S) * PLANE;
    const float* kl = kh + PLANE;
#pragma unroll 4
    for (int kk = 0; kk < DG / 8; ++kk) {
      uint32_t qa[4], ahi[4], alo[4];
      ldmatrix_x4(qa, qw + arow * LDQ + 8 * kk + acol);
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(qa[i]), ahi[i], alo[i]);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bh[4], bl[4];
        ldmatrix_x4(bh, kh + (16 * np + brow) * LDK + 8 * kk + bcol);
        ldmatrix_x4(bl, kl + (16 * np + brow) * LDK + 8 * kk + bcol);
        const uint32_t bh0[2] = {bh[0], bh[1]}, bl0[2] = {bl[0], bl[1]};
        const uint32_t bh1[2] = {bh[2], bh[3]}, bl1[2] = {bl[2], bl[3]};
        mma_3xtf32_add(s[2 * np], ahi, alo, bh0, bl0);
        mma_3xtf32_add(s[2 * np + 1], ahi, alo, bh1, bl1);
      }
    }
    release(nk);
    float* mine = xs + ((grp * 2 + kt % 2) * G + part) * 16 * T;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) mine[(n * 4 + c) * 32 + lane] = s[n][c];
  };
  float o[DG / 8][4];
#pragma unroll
  for (int dn = 0; dn < DG / 8; ++dn)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[dn][c] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
  // once the group's slices of tile kt are in (a barrier of its G warps
  // alone): every warp adds them in the slices' order, scales and masks
  // them (-inf past L, -1e30 on masked keys) and takes the online softmax;
  // s becomes the tile's weights and o is rescaled
  const auto softmax = [&](int kt, float (&s)[NT][4], const float (&kept)[NT][2]) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + grp), "r"(32 * G) : "memory");
    const float* xg = xs + (grp * 2 + kt % 2) * G * 16 * T;
    float tm[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = xg[(n * 4 + c) * 32 + lane];
#pragma unroll
        for (int j = 1; j < G; ++j) x += xg[j * 16 * T + (n * 4 + c) * 32 + lane];
        const int key = kt * T + n * 8 + 2 * t + (c & 1);
        x = key >= L ? -INFINITY : (kept[n][c & 1] > 0.f ? x * scale : -1e30f);
        s[n][c] = x;
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
      for (int dn = 0; dn < DG / 8; ++dn)
#pragma unroll
        for (int c = 0; c < 4; ++c) o[dn][c] *= alpha[c / 2];
    }
  };
  // o += w V over tile kt's keys: the A fragment of each 8-key slice takes
  // keys 2t, 2t + 1 at columns t, t + 4, and the B fragment V's rows 2t and
  // 2t + 1 at column g (4-byte loads, conflict-free: LDK % 32 is 4 or 20);
  // V's stage released
  const auto pv = [&](int kt, const float (&w)[NT][4]) {
    const int nv = vpiece(kt);
    take(nv);
    const float* vh = ring + 2 * (nv % S) * PLANE + 2 * t * LDK + g;
    const float* vl = vh + PLANE;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float af[4] = {w[n][0], w[n][2], w[n][1], w[n][3]};
      uint32_t ahi[4], alo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(af[i], ahi[i], alo[i]);
#pragma unroll
      for (int dn = 0; dn < DG / 8; ++dn) {
        const int a = 8 * n * LDK + 8 * dn;
        const uint32_t bh[2] = {__float_as_uint(vh[a]), __float_as_uint(vh[a + LDK])};
        const uint32_t bl[2] = {__float_as_uint(vl[a]), __float_as_uint(vl[a + LDK])};
        mma_3xtf32(o[dn], ahi, alo, bh, bl);
      }
    }
    release(nv);
  };
#pragma unroll 1
  for (int kt = 0; kt < ntiles; ++kt) {
    float s[NT][4], kept[NT][2];
    scores(kt, s, kept);
    softmax(kt, s, kept);
    pv(kt, s);
  }
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
  for (int dn = 0; dn < DG / 8; ++dn) {
    const int col = part * DG + 8 * dn + 2 * t;  // D % 4 == 0: col + 1 < D with col
    if (col < D) {
      if (row < L)
        store2(op + (long long)row * out_rs + col, o[dn][0] / denom[0], o[dn][1] / denom[0]);
      if (row + 8 < L)
        store2(op + (long long)(row + 8) * out_rs + col, o[dn][2] / denom[1],
               o[dn][3] / denom[1]);
    }
  }
}

// attention_kernel_wide_f32 at depth DP on a call wide_takes (float32 rows of
// whole 16-byte chunks, an output written in pairs, 16 < L <= kAttnMaxLen):
// a block of 16 f32w_rows query rows of one (batch, head)
template <int DP, typename TO>
static cudaError_t launch_attention_wide_f32(const float* q, const float* k, const float* v,
                                             const float* mask, TO* out, int B, int H, int L,
                                             int D, long long in_bs, long long in_rs,
                                             long long out_bs, long long out_rs,
                                             cudaStream_t stream) {
  // bytes: 231,368 at 160 (12 stages), 231,832 at 192 (9), 220,008 at 224
  // (6), 228,296 at 288 (12), 232,360 at 336 (10), 228,232 at 384 (8),
  // 230,280 at 448 (8), 225,128 at 512 (6)
  constexpr size_t smem = f32w_smem_at<DP>(f32w_stages<DP>());
  static_assert(DP > 128 && DP != 256 && smem <= kPaddedSmemMax, "depth, shared memory");
  const cudaError_t err = wide_attribute<attention_kernel_wide_f32<TO, DP>, smem>();
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf((float)D);  // of the true head dim, as the TPU kernel's
  constexpr int kRows = 16 * f32w_rows<DP>();
  attention_kernel_wide_f32<TO, DP><<<dim3((L + kRows - 1) / kRows, H, B), 32 * f32w_warps<DP>(),
                                      smem, stream>>>(q, k, v, mask, out, L, D, in_bs, in_rs,
                                                      out_bs, out_rs, scale);
  return counted_launch(kAttnKernelWideF32);
}

}  // namespace esv
