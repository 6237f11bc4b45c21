// K2 and K3: one post-LN transformer encoder block, CUDA C++ for sm_90a.
//
// K2 replaces explainable_spatial_vqa_tpu/ops/pallas_block.py:_block_kernel, the
// Pallas kernel that computes a whole block for one sequence per grid cell
// with all of the block's weights resident in VMEM:
//     q, k, v = x Wq + bq, x Wk + bk, x Wv + bv      (float32 results)
//     a  = per-head masked attention on the float32 q, k, v
//     x1 = LN1(x + a Wo + bo)                         (float32)
//     y  = LN2(x1 + relu(x1 W1 + b1) W2 + b2)         (in x's type)
// Each product rounds its left operand to the weights' type and accumulates in
// float32; LayerNorm uses float32 statistics and eps 1e-6.
//
// K3 replaces pallas_block.py:_tiled_kernel, the same block over batch_tile
// sequences per grid cell with the FFN in ffn_chunks row chunks.  Its
// arithmetic differs from K2's in one place: q, k and v are rounded to the
// weights' type after the bias, and the attention is K1's on them (float32
// scores and softmax, weights rounded to that type, float32 sums, the output
// in that type, which is the rounding the out projection applies to it).
//
// Bound on the H100: at the serving shape (128 sequences of L = 210, d = 512,
// 4 heads, ffn 2048, bf16) one block is ~180 GFLOP against ~61 MB of
// activations and weights, so it is bound by the tensor cores' operations
// (~0.18 ms at 989 TFLOP/s), not by memory.  K3 at the block bench's L = 224
// is ~194 GFLOP, ~0.20 ms with its bf16 attention at the same rate.
//
// Design: the TPU keeps ~6.3 MB of bf16 weights in VMEM for every sequence
// or tile of sequences; an SM has 227 KB of shared memory, so here the block
// is a short sequence of kernels over all B*L rows at once, with intermediates
// in device memory (scratch allocated by the caller), not the TPU's grid:
//   (a) a tiled GEMM with bias and optional ReLU fused into its epilogue, for
//       the QKV projection (one GEMM against the stacked [Wq; Wk; Wv]), the
//       out projection and the two FFN products.  With bf16 weights it runs on
//       the tensor cores through WMMA (16x16x16 bf16 tiles, float32
//       accumulators, 128x128 block tiles, the next K slice prefetched into
//       registers); with float32 weights it runs in float32 on the CUDA
//       cores, so the float32 path is not rounded to TF32;
//       For K3's QKV product, whose float32 sums are rounded to bf16 next,
//       each 32-deep slice is summed by the tensor cores into a fresh
//       fragment and the slices are added with Kahan's compensation.  The
//       tensor cores' accumulator rounds more coarsely than float32
//       additions; over all of K it rounded more q, k, v the other way from
//       the exact sum than float32 sums do, and each such rounding of a key
//       or value moves the attention of every query of its sequence
//       (chip_smoke.py phase 3 checks the kernel against float32 sums);
//   (b) the attention kernel of K1 (attention.cuh): on the float32 q, k, v
//       for K2, on q, k, v in the weights' type for K3 (the QKV GEMM's
//       epilogue rounds them);
//   (c) a residual-add + LayerNorm kernel, one warp per row.
// K3's batch_tile does not reach this file: the GEMMs tile all rows by 128.
// Its ffn_chunks splits the FFN into that many pairs of GEMMs over row
// chunks, so the hidden scratch holds B*L/ffn_chunks rows.  Neither changes
// the result.  No wgmma, TMA or warp specialisation yet, and the attention
// runs on the CUDA cores even on K3's bf16 q, k, v: those are the next steps.
//
// C interface, bound with ctypes (every pointer and the stream a void*):
//   int esv_encoder_block(x, mask, w_qkv, b_qkv, w_o, b_o, w_1, b_1, w_2, b_2,
//                         ln1_scale, ln1_bias, ln2_scale, ln2_bias, out,
//                         qkv, attn, proj, x1, hidden,
//                         B, L, d, H, ffn, x_dtype, w_dtype, stream)
//   int esv_encoder_block_tiled(the same 20 pointers,
//                               B, L, d, H, ffn, ffn_chunks, x_dtype, w_dtype, stream)
// Weights are row-major (out_features, in_features) in w_dtype; biases and
// LayerNorm parameters float32; mask a (B, L) float32 key mask or null.
// Scratch: proj and x1 (B*L, d) float32; qkv (B*L, 3d) and attn (B*L, d)
// float32 for K2, in w_dtype for K3; hidden (B*L, ffn) in w_dtype for K2,
// (B*L/ffn_chunks, ffn) for K3.  out is (B, L, d) in x_dtype.  Returns the
// first CUDA error of the launches (0 on success).

#include <mma.h>

#include <cstdint>

#include "attention.cuh"

namespace esv {

using bf16 = __nv_bfloat16;

// ---- (a) GEMM: C[m, n] = act(sum_k round_W(A[m, k]) * W[n, k] + bias[n]) ----

// bf16 weights: tensor cores via WMMA.  A 128x128 tile per block of 8 warps
// (2 x 4), each warp a 64x32 slice as 4x2 fragments of 16x16; K advances 32 at
// a time.  Each thread stages 16 elements of one row of A and of W: the next K
// slice is fetched into registers (16-byte loads where the row is aligned and
// whole) while the tensor cores work on the current one.
constexpr int kWmmaTile = 128, kWmmaK = 32, kWmmaThreads = 256, kWmmaLd = kWmmaK + 8;

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&p);
}

// 16 elements of a row starting at src, rounded to bf16 and packed; elements
// at and past `valid` read as zero.
template <typename T>
__device__ __forceinline__ void fetch16(const T* __restrict__ src, int valid, bool vec,
                                        uint4 (&dst)[2]) {
  unsigned w[8];
  if (vec && valid == 16) {
    if constexpr (std::is_same<T, bf16>::value) {
      dst[0] = reinterpret_cast<const uint4*>(src)[0];
      dst[1] = reinterpret_cast<const uint4*>(src)[1];
      return;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 f = reinterpret_cast<const float4*>(src)[i];
        w[2 * i] = pack_bf16x2(f.x, f.y);
        w[2 * i + 1] = pack_bf16x2(f.z, f.w);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float lo = 2 * i < valid ? to_float(src[2 * i]) : 0.f;
      const float hi = 2 * i + 1 < valid ? to_float(src[2 * i + 1]) : 0.f;
      w[i] = pack_bf16x2(lo, hi);
    }
  }
  dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
  dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

template <typename TA, typename TC, bool kRelu, bool kCompensated>
__global__ void __launch_bounds__(kWmmaThreads) gemm_bf16_wmma(
    const TA* __restrict__ A, const bf16* __restrict__ W, const float* __restrict__ bias,
    TC* __restrict__ C, int M, int N, int K, bool vec) {
  using namespace nvcuda;
  using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
  using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
  __shared__ __align__(128) bf16 As[kWmmaTile][kWmmaLd];
  __shared__ __align__(128) bf16 Ws[kWmmaTile][kWmmaLd];
  __shared__ __align__(128) float stage[kWmmaThreads / 32][16][16];

  const int m0 = blockIdx.y * kWmmaTile, n0 = blockIdx.x * kWmmaTile;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;
  const int lrow = tid / 2, lcol = (tid % 2) * 16;  // this thread's staged row and columns
  const int am = m0 + lrow, wr = n0 + lrow;
  const TA* arow = A + (long long)min(am, M - 1) * K;
  const bf16* wrow = W + (long long)min(wr, N - 1) * K;

  // acc: the running sums; comp: Kahan's compensation, used with kCompensated
  Acc acc[4][2], comp[kCompensated ? 4 : 1][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  if constexpr (kCompensated) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(comp[i][j], 0.f);
  }

  uint4 a_reg[2], w_reg[2];
  auto fetch = [&](int k0) {
    const int k = k0 + lcol, left = max(0, min(16, K - k));
    fetch16(arow + k, am < M ? left : 0, vec, a_reg);
    fetch16(wrow + k, wr < N ? left : 0, vec, w_reg);
  };
  fetch(0);
  for (int k0 = 0; k0 < K; k0 += kWmmaK) {
    *reinterpret_cast<uint4*>(&As[lrow][lcol]) = a_reg[0];
    *reinterpret_cast<uint4*>(&As[lrow][lcol + 8]) = a_reg[1];
    *reinterpret_cast<uint4*>(&Ws[lrow][lcol]) = w_reg[0];
    *reinterpret_cast<uint4*>(&Ws[lrow][lcol + 8]) = w_reg[1];
    __syncthreads();
    if (k0 + kWmmaK < K) fetch(k0 + kWmmaK);
    if constexpr (kCompensated) {
      // the slice's 32 products summed by the tensor cores into a fresh
      // fragment, then added to the running sum with Kahan's compensation:
      // the tensor cores' own accumulation rounds more coarsely than float32
      // additions, and it then spans 32 products instead of all K
      FragB bfr[2][2];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(bfr[kk][j], &Ws[wn + 16 * j][16 * kk], kWmmaLd);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        FragA af[2];
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
          wmma::load_matrix_sync(af[kk], &As[wm + 16 * i][16 * kk], kWmmaLd);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          Acc part;
          wmma::fill_fragment(part, 0.f);
          wmma::mma_sync(part, af[0], bfr[0][j], part);
          wmma::mma_sync(part, af[1], bfr[1][j], part);
#pragma unroll
          for (int e = 0; e < part.num_elements; ++e) {
            const float y = part.x[e] - comp[i][j].x[e];
            const float t = acc[i][j].x[e] + y;
            comp[i][j].x[e] = (t - acc[i][j].x[e]) - y;
            acc[i][j].x[e] = t;
          }
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < kWmmaK; kk += 16) {
        FragA af[4];
        FragB bfr[2];
#pragma unroll
        for (int i = 0; i < 4; ++i) wmma::load_matrix_sync(af[i], &As[wm + 16 * i][kk], kWmmaLd);
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(bfr[j], &Ws[wn + 16 * j][kk], kWmmaLd);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
  // epilogue: each fragment through the warp's 16x16 stage, bias and ReLU fused
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(&stage[warp][0][0], acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int m = m0 + wm + 16 * i + e / 16, n = n0 + wn + 16 * j + e % 16;
        if (m < M && n < N) {
          float val = stage[warp][e / 16][e % 16] + bias[n];
          if (kRelu) val = fmaxf(val, 0.f);
          C[(long long)m * N + n] = from_float<TC>(val);
        }
      }
      __syncwarp();
    }
}

// float32 weights: float32 FMAs on the CUDA cores.  256 threads, each a 4x4
// block of the 64x64 tile; K advances 16 at a time.  A and W tiles are stored
// k-major so a thread's four rows (columns) are contiguous.
constexpr int kTileM = 64, kTileN = 64, kSimtK = 16, kSimtThreads = 256;

template <typename TA, typename TC, bool kRelu>
__global__ void __launch_bounds__(kSimtThreads) gemm_f32_simt(
    const TA* __restrict__ A, const float* __restrict__ W, const float* __restrict__ bias,
    TC* __restrict__ C, int M, int N, int K) {
  __shared__ __align__(16) float As[kSimtK][kTileM + 4];
  __shared__ __align__(16) float Ws[kSimtK][kTileN + 4];
  const int m0 = blockIdx.y * kTileM, n0 = blockIdx.x * kTileN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int lrow = tid / 4, lk = (tid % 4) * 4;  // loader: 4 elements of one row

  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kSimtK) {
    const int am = m0 + lrow, wnr = n0 + lrow;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int kk = k0 + lk + u;
      As[lk + u][lrow] = (am < M && kk < K) ? to_float(A[(long long)am * K + kk]) : 0.f;
      Ws[lk + u][lrow] = (wnr < N && kk < K) ? W[(long long)wnr * K + kk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSimtK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 w = *reinterpret_cast<const float4*>(&Ws[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (m < M && n < N) {
        float val = acc[i][j] + bias[n];
        if (kRelu) val = fmaxf(val, 0.f);
        C[(long long)m * N + n] = from_float<TC>(val);
      }
    }
  }
}

// kCompensated (bf16 weights only): each 32-deep slice summed by the tensor
// cores apart and the slices added with Kahan's compensation, for products
// whose float32 sums are rounded to bf16 next (K3's q, k, v).
template <typename TA, typename TC, bool kRelu, bool kCompensated = false>
cudaError_t gemm(const TA* A, const void* W, int w_dtype, const float* bias, TC* C, int M, int N,
                 int K, cudaStream_t s) {
  if (w_dtype == kBFloat16) {
    // 16-byte loads need 16-byte aligned rows: aligned bases and K % 8 == 0
    const bool vec = K % 8 == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(W) % 16 == 0;
    const dim3 grid((N + kWmmaTile - 1) / kWmmaTile, (M + kWmmaTile - 1) / kWmmaTile);
    gemm_bf16_wmma<TA, TC, kRelu, kCompensated>
        <<<grid, kWmmaThreads, 0, s>>>(A, static_cast<const bf16*>(W), bias, C, M, N, K, vec);
  } else {
    const dim3 grid((N + kTileN - 1) / kTileN, (M + kTileM - 1) / kTileM);
    gemm_f32_simt<TA, TC, kRelu><<<grid, kSimtThreads, 0, s>>>(A, static_cast<const float*>(W), bias, C, M, N, K);
  }
  return cudaGetLastError();
}

// ---- (c) out[m] = LN(res[m] + y[m]) * scale + bias, float32 statistics ----

constexpr int kLnThreads = 256;

template <typename TR, typename TO>
__global__ void __launch_bounds__(kLnThreads) add_layernorm(
    const TR* __restrict__ res, const float* __restrict__ y, const float* __restrict__ scale,
    const float* __restrict__ bias, TO* __restrict__ out, int M, int N, float eps) {
  const int row = blockIdx.x * (kLnThreads / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= M) return;
  const TR* r = res + (long long)row * N;
  const float* yr = y + (long long)row * N;
  float sum = 0.f;
  for (int j = lane; j < N; j += 32) sum += to_float(r[j]) + yr[j];
  const float mean = warp_sum(sum) / N;
  float sq = 0.f;
  for (int j = lane; j < N; j += 32) {
    const float t = to_float(r[j]) + yr[j] - mean;
    sq += t * t;
  }
  const float inv = 1.0f / sqrtf(warp_sum(sq) / N + eps);
  TO* o = out + (long long)row * N;
  for (int j = lane; j < N; j += 32) {
    const float t = to_float(r[j]) + yr[j];
    o[j] = from_float<TO>((t - mean) * inv * scale[j] + bias[j]);
  }
}

template <typename TR, typename TO>
cudaError_t layernorm(const TR* res, const float* y, const float* scale, const float* bias, TO* out,
                      int M, int N, cudaStream_t s) {
  const int rows_per_block = kLnThreads / 32;
  add_layernorm<TR, TO><<<(M + rows_per_block - 1) / rows_per_block, kLnThreads, 0, s>>>(
      res, y, scale, bias, out, M, N, 1e-6f);
  return cudaGetLastError();
}

// ---- the block ----

template <typename TX, typename TW>
cudaError_t encoder_block(const TX* x, const float* mask, const TW* w_qkv, const float* b_qkv,
                          const TW* w_o, const float* b_o, const TW* w_1, const float* b_1,
                          const TW* w_2, const float* b_2, const float* ln1_s, const float* ln1_b,
                          const float* ln2_s, const float* ln2_b, TX* out, float* qkv, float* attn,
                          float* proj, float* x1, TW* hidden, int B, int L, int d, int H, int ffn,
                          cudaStream_t s) {
  const int M = B * L, wd = std::is_same<TW, bf16>::value ? kBFloat16 : kFloat32;
  cudaError_t err;
  if ((err = gemm<TX, float, false>(x, w_qkv, wd, b_qkv, qkv, M, 3 * d, d, s))) return err;
  // heads read q, k and v straight out of the (B, L, 3d) projection buffer
  const long long qkv_bs = (long long)L * 3 * d, qkv_rs = 3 * d;
  if ((err = launch_attention<float>(qkv, qkv + d, qkv + 2 * d, mask, attn, B, H, L, d / H, qkv_bs,
                                     qkv_rs, (long long)L * d, d, s)))
    return err;
  if ((err = gemm<float, float, false>(attn, w_o, wd, b_o, proj, M, d, d, s))) return err;
  if ((err = layernorm<TX, float>(x, proj, ln1_s, ln1_b, x1, M, d, s))) return err;
  if ((err = gemm<float, TW, true>(x1, w_1, wd, b_1, hidden, M, ffn, d, s))) return err;
  if ((err = gemm<TW, float, false>(hidden, w_2, wd, b_2, proj, M, d, ffn, s))) return err;
  return layernorm<float, TX>(x1, proj, ln2_s, ln2_b, out, M, d, s);
}

// K3: q, k, v and the attention output in the weights' type; the FFN in
// `chunks` row chunks (B*L % chunks == 0, checked by the caller).
template <typename TX, typename TW>
cudaError_t encoder_block_tiled(const TX* x, const float* mask, const TW* w_qkv,
                                const float* b_qkv, const TW* w_o, const float* b_o,
                                const TW* w_1, const float* b_1, const TW* w_2, const float* b_2,
                                const float* ln1_s, const float* ln1_b, const float* ln2_s,
                                const float* ln2_b, TX* out, TW* qkv, TW* attn, float* proj,
                                float* x1, TW* hidden, int B, int L, int d, int H, int ffn,
                                int chunks, cudaStream_t s) {
  const int M = B * L, wd = std::is_same<TW, bf16>::value ? kBFloat16 : kFloat32;
  if (chunks < 1 || M % chunks) return cudaErrorInvalidValue;
  cudaError_t err;
  if ((err = gemm<TX, TW, false, true>(x, w_qkv, wd, b_qkv, qkv, M, 3 * d, d, s))) return err;
  const long long qkv_bs = (long long)L * 3 * d, qkv_rs = 3 * d;
  if ((err = launch_attention<TW>(qkv, qkv + d, qkv + 2 * d, mask, attn, B, H, L, d / H, qkv_bs,
                                  qkv_rs, (long long)L * d, d, s)))
    return err;
  if ((err = gemm<TW, float, false>(attn, w_o, wd, b_o, proj, M, d, d, s))) return err;
  if ((err = layernorm<TX, float>(x, proj, ln1_s, ln1_b, x1, M, d, s))) return err;
  const int rows = M / chunks;
  for (int c = 0; c < chunks; ++c) {
    const long long r0 = (long long)c * rows * d;
    if ((err = gemm<float, TW, true>(x1 + r0, w_1, wd, b_1, hidden, rows, ffn, d, s))) return err;
    if ((err = gemm<TW, float, false>(hidden, w_2, wd, b_2, proj + r0, rows, d, ffn, s)))
      return err;
  }
  return layernorm<float, TX>(x1, proj, ln2_s, ln2_b, out, M, d, s);
}

}  // namespace esv

extern "C" int esv_encoder_block(const void* x, const void* mask, const void* w_qkv,
                                 const void* b_qkv, const void* w_o, const void* b_o,
                                 const void* w_1, const void* b_1, const void* w_2,
                                 const void* b_2, const void* ln1_s, const void* ln1_b,
                                 const void* ln2_s, const void* ln2_b, void* out, void* qkv,
                                 void* attn, void* proj, void* x1, void* hidden, int B, int L,
                                 int d, int H, int ffn, int x_dtype, int w_dtype, void* stream) {
  using esv::bf16;
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ESV_BLOCK(TX, TW)                                                                        \
  return esv::encoder_block<TX, TW>(                                                             \
      static_cast<const TX*>(x), f(mask), static_cast<const TW*>(w_qkv), f(b_qkv),               \
      static_cast<const TW*>(w_o), f(b_o), static_cast<const TW*>(w_1), f(b_1),                  \
      static_cast<const TW*>(w_2), f(b_2), f(ln1_s), f(ln1_b), f(ln2_s), f(ln2_b),               \
      static_cast<TX*>(out), static_cast<float*>(qkv), static_cast<float*>(attn),                \
      static_cast<float*>(proj), static_cast<float*>(x1), static_cast<TW*>(hidden), B, L, d, H, \
      ffn, s)
  if (x_dtype == esv::kFloat32 && w_dtype == esv::kFloat32) { ESV_BLOCK(float, float); }
  if (x_dtype == esv::kFloat32 && w_dtype == esv::kBFloat16) { ESV_BLOCK(float, bf16); }
  if (x_dtype == esv::kBFloat16 && w_dtype == esv::kFloat32) { ESV_BLOCK(bf16, float); }
  if (x_dtype == esv::kBFloat16 && w_dtype == esv::kBFloat16) { ESV_BLOCK(bf16, bf16); }
#undef ESV_BLOCK
  return cudaErrorInvalidValue;
}

extern "C" int esv_encoder_block_tiled(const void* x, const void* mask, const void* w_qkv,
                                       const void* b_qkv, const void* w_o, const void* b_o,
                                       const void* w_1, const void* b_1, const void* w_2,
                                       const void* b_2, const void* ln1_s, const void* ln1_b,
                                       const void* ln2_s, const void* ln2_b, void* out, void* qkv,
                                       void* attn, void* proj, void* x1, void* hidden, int B,
                                       int L, int d, int H, int ffn, int ffn_chunks, int x_dtype,
                                       int w_dtype, void* stream) {
  using esv::bf16;
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ESV_TILED(TX, TW)                                                                        \
  return esv::encoder_block_tiled<TX, TW>(                                                       \
      static_cast<const TX*>(x), f(mask), static_cast<const TW*>(w_qkv), f(b_qkv),               \
      static_cast<const TW*>(w_o), f(b_o), static_cast<const TW*>(w_1), f(b_1),                  \
      static_cast<const TW*>(w_2), f(b_2), f(ln1_s), f(ln1_b), f(ln2_s), f(ln2_b),               \
      static_cast<TX*>(out), static_cast<TW*>(qkv), static_cast<TW*>(attn),                      \
      static_cast<float*>(proj), static_cast<float*>(x1), static_cast<TW*>(hidden), B, L, d, H,  \
      ffn, ffn_chunks, s)
  if (x_dtype == esv::kFloat32 && w_dtype == esv::kFloat32) { ESV_TILED(float, float); }
  if (x_dtype == esv::kFloat32 && w_dtype == esv::kBFloat16) { ESV_TILED(float, bf16); }
  if (x_dtype == esv::kBFloat16 && w_dtype == esv::kFloat32) { ESV_TILED(bf16, float); }
  if (x_dtype == esv::kBFloat16 && w_dtype == esv::kBFloat16) { ESV_TILED(bf16, bf16); }
#undef ESV_TILED
  return cudaErrorInvalidValue;
}
