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
//   (a) a GEMM with bias and optional ReLU fused into its epilogue, for the
//       QKV projection (one GEMM against the stacked [Wq; Wk; Wv]), the out
//       projection and the two FFN products.  With bf16 weights and a bf16
//       left operand it is gemm_bf16_wgmma: persistent blocks of one TMA
//       producer warp and two consumer warpgroups, a 4-stage ring of 128x64
//       tiles of A and W filled by cp.async.bulk.tensor with mbarrier
//       full/empty handshakes, wgmma.m64n128k16 (bf16, float32
//       accumulators) on 128x128 output tiles, bias and ReLU in the
//       epilogue.  The consumers take whole tiles in turn (ping-pong), so
//       one's epilogue overlaps the other's products.  It reaches ~320
//       TFLOP/s on the products with K = 512 and ~560 on FFN2 (K = 2048):
//       what is left is a cost per tile that a longer K hides (PERF.md
//       §6).  To give TMA bf16 operands, the producers write what each
//       product rounds its operand to anyway: the attention writes its
//       output in bf16 (the out projection's rounding), and LN1 writes x1
//       twice, float32 for the residual and bf16 for FFN1 (x1.astype(w_dtype)
//       in the TPU kernel).  A float32 x with bf16 weights (a combination
//       the wrappers accept) is rounded to bf16 by one pass into the x1w
//       scratch for the QKV product.  With float32 weights every product
//       is gemm_tf32_wgmma, 3xTF32 on the tensor cores (see "float32 A and
//       W" below): not rounded to TF32 once, but each operand split into
//       two TF32 parts, which carries ~2^-22 |x| of error per operand, as
//       K2's float32 attention does; a bf16 x with float32 weights is
//       widened to float32 into the x1 scratch first.
//       For K3's QKV product, whose float32 sums are rounded to bf16 next,
//       each 32-deep slice is summed by the tensor cores into a fresh
//       accumulator (wgmma with scale-d 0) and the slices are added with
//       Kahan's compensation; the two consumers then share each tile, 64
//       rows each, for the registers.  A key or value rounded the other way
//       from the plain version's moves the attention of every query of its
//       sequence, so each q, k, v is the correctly rounded one: where its
//       compensated sum lies close to a bf16 tie, exact_fixup rounds it from
//       the exact sum (float64) instead (see "K3's q, k and v" below);
//   (b) the attention kernels of K1 (attention.cuh at head dim 128, K3's
//       past 16 keys on attention_wide.cuh's attention_kernel_wgmma up to
//       256 keys and attention_kernel_wgmma_2pass past them;
//       attention_wide.cuh at 256: attention_kernel_split_f32 for K2 and
//       attention_kernel_wgmma for K3, attention_padded.cuh's short kernels
//       at 16 keys or fewer (attention_kernel_short_f32 for K2,
//       attention_kernel_short for K3, at 384 and 512 too); at 384 and 512
//       attention_f32_wide.cuh's attention_kernel_wide_f32 for K2 past 16
//       keys, for K3 attention_wide.cuh's
//       attention_kernel_wgmma_deep from 17 to 256 keys and
//       attention_kernel_wgmma_2pass_deep past them, at 256 too): on K2's
//       float32 q, k, v
//       both products in 3xTF32 on the tensor cores with an online softmax,
//       the output written in the
//       weights' type; on K3's q, k, v in the weights' type (the QKV GEMM's
//       epilogue rounds them) float32 tensor-core scores and a bf16
//       tensor-core P V;
//   (c) a residual-add + LayerNorm kernel, one warp per row.
// K3's batch_tile does not reach this file: the GEMMs tile all rows by 128.
// Its ffn_chunks splits the FFN into that many pairs of GEMMs over row
// chunks, so the hidden scratch holds B*L/ffn_chunks rows.  Neither changes
// the result.
//
// C interface, bound with ctypes (every pointer and the stream a void*):
//   int esv_encoder_block(x, mask, w_qkv, b_qkv, w_o, b_o, w_1, b_1, w_2, b_2,
//                         ln1_scale, ln1_bias, ln2_scale, ln2_bias, out,
//                         qkv, attn, proj, x1, x1w, hidden,
//                         B, L, d, H, ffn, x_dtype, w_dtype, stream)
//   int esv_encoder_block_tiled(the same 21 pointers,
//                               B, L, d, H, ffn, ffn_chunks, x_dtype, w_dtype, stream)
//   int esv_block_gemm(A, W, bias, C, absmax, M, N, K, a_dtype, w_dtype, c_dtype, relu,
//                      compensated, stream)
// Weights are row-major (out_features, in_features) in w_dtype; with float32
// weights each matrix (N, K) is passed as its TF32 split, a (2N, K) float32
// array whose rows [0, N) hold the hi parts and [N, 2N) the lo parts
// (split_tf32's rule, computed once by ops/fused_block.py:split_tf32).
// Biases and LayerNorm parameters float32; mask a (B, L) float32 key mask or
// null.
// Scratch: proj and x1 (B*L, d) float32; attn (B*L, d) and x1w (B*L, d) in
// w_dtype (x1w, x1 rounded to bf16 and, before LN1, a float32 x rounded to
// bf16, is null with float32 weights; before LN1 x1 holds a bf16 x widened
// for float32 weights); qkv (B*L, 3d) float32 for K2, in
// w_dtype for K3; hidden (B*L, ffn) in w_dtype for K2, (B*L/ffn_chunks, ffn)
// for K3.  out is (B, L, d) in x_dtype.
// esv_block_gemm computes C = act(A W^T + bias), A (M, K), W (N, K), C (M, N)
// in c_dtype, relu 0 or 1: the block's product alone.  A is in the weights'
// type, W is (N, K) bf16 or, with float32 weights, the (2N, K) split; the
// bases must be 16-byte aligned and K and N multiples of 8 (bf16) or 4
// (float32): TMA's rules.  compensated 1 (bf16 weights only) takes K3's
// QKV product: compensated sums, and with a bf16 C the correctly rounded
// ones, with absmax (M + N floats and ceil(M N / 32) words) as scratch;
// absmax is null otherwise.
//   int esv_block_attention(q, k, v, mask, out, B, H, L, D, in_batch_stride,
//                            in_row_stride, out_batch_stride, out_row_stride,
//                            dtype, out_dtype, stream)
// is the blocks' attention alone (block_attention, D 128, 256, 384 or
// 512), with esv_attention's arguments (fused_attention.cu): K2's on float32 q, k,
// v from the (B, L, 3d) buffer, K3's on bf16 (dtype 1), timed apart by
// chip_smoke.py and measure/attention_variants.py.
//   const char* esv_block_attention_kernel(int i)
//   long long esv_block_attention_launches(int i)
// name the attention kernel function i (attention.cuh's AttnKernel: 0
// attention_kernel_f32, 1 attention_kernel, 3 attention_kernel_padded_f32,
// 4 attention_kernel_padded, 5 attention_kernel_split_f32, 6
// attention_kernel_wgmma, 7 attention_kernel_wgmma_2pass, 8
// attention_kernel_deep_f32, 9 attention_kernel_wgmma_deep, 10
// attention_kernel_short_f32, 11 attention_kernel_short, 12
// attention_kernel_wide_f32, 13 attention_kernel_wgmma_2pass_deep) and count
// the launches
// of it that this library's blocks and esv_block_attention have made since
// it was loaded.
// H is d / 128, d / 256, d / 384 or d / 512 (the attention's head dims: the
// multiples of 128 up to kAttnMaxHeadDim, attention_padded.cuh:
// block_head_dim), L at most kAttnMaxLen.  Returns the first CUDA error of
// the launches (0 on success).

#include <cuda.h>
#include <cudaTypedefs.h>

#include <algorithm>
#include <array>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <tuple>

#include "attention_padded.cuh"

namespace esv {

using bf16 = __nv_bfloat16;

// K2's and K3's attention at head dim D (attention_padded.cuh:
// launch_block_attention): defined and instantiated for the blocks' three
// type pairs in the translation unit of D (ops/_build.py:
// BLOCK_ATTENTION_DIMS, -DESV_BLOCK_HEAD_DIM=<D>), so that each head dim's
// attention kernels compile beside the rest of the library, not after it
template <int D, typename T, typename TO>
cudaError_t block_attention_at(const T* q, const T* k, const T* v, const float* mask, TO* out,
                               int B, int H, int L, long long in_bs, long long in_rs,
                               long long out_bs, long long out_rs, cudaStream_t stream);

}  // namespace esv

#ifdef ESV_BLOCK_HEAD_DIM

namespace esv {

template <int D, typename T, typename TO>
cudaError_t block_attention_at(const T* q, const T* k, const T* v, const float* mask, TO* out,
                               int B, int H, int L, long long in_bs, long long in_rs,
                               long long out_bs, long long out_rs, cudaStream_t stream) {
  return launch_block_attention<D, T, TO>(q, k, v, mask, out, B, H, L, in_bs, in_rs, out_bs,
                                          out_rs, stream);
}

#define ESV_AT(T, TO)                                                                          \
  template cudaError_t block_attention_at<ESV_BLOCK_HEAD_DIM, T, TO>(                          \
      const T*, const T*, const T*, const float*, TO*, int, int, int, long long, long long,    \
      long long, long long, cudaStream_t);
ESV_AT(float, float)
ESV_AT(float, bf16)
ESV_AT(bf16, bf16)
#undef ESV_AT

}  // namespace esv

#else

namespace esv {

// The blocks' attention at head dim D, one of block_head_dim's (each in its
// own unit); any other D returns cudaErrorInvalidValue
template <typename T, typename TO>
static cudaError_t block_attention(const T* q, const T* k, const T* v, const float* mask, TO* out,
                                   int B, int H, int L, int D, long long in_bs, long long in_rs,
                                   long long out_bs, long long out_rs, cudaStream_t stream) {
  static_assert(kAttnMaxHeadDim == 512, "the multiples of 128 below");
  switch (D) {
    case 128:
      return block_attention_at<128, T, TO>(q, k, v, mask, out, B, H, L, in_bs, in_rs, out_bs,
                                            out_rs, stream);
    case 256:
      return block_attention_at<256, T, TO>(q, k, v, mask, out, B, H, L, in_bs, in_rs, out_bs,
                                            out_rs, stream);
    case 384:
      return block_attention_at<384, T, TO>(q, k, v, mask, out, B, H, L, in_bs, in_rs, out_bs,
                                            out_rs, stream);
    case 512:
      return block_attention_at<512, T, TO>(q, k, v, mask, out, B, H, L, in_bs, in_rs, out_bs,
                                            out_rs, stream);
  }
  return cudaErrorInvalidValue;
}

// ---- (a) GEMM: C[m, n] = act(sum_k round_W(A[m, k]) * W[n, k] + bias[n]) ----

// -- bf16 A and W: wgmma fed by TMA --

constexpr int kGemmBM = 128, kGemmBN = 128, kGemmBK = 64, kGemmStages = 4;
constexpr int kGemmConsumers = 2;  // consumer warpgroups
constexpr int kGemmThreads = 128 * (kGemmConsumers + 1);
constexpr int kGemmABytes = kGemmBM * kGemmBK * 2, kGemmWBytes = kGemmBN * kGemmBK * 2;
static_assert(kGemmBK * 2 == 128, "one 128-byte swizzle row per tile row");
// the ring, its barriers, and 1 KB to align the ring to the swizzle's 1 KB atoms
constexpr int kGemmSmem = kGemmStages * (kGemmABytes + kGemmWBytes) + 2 * kGemmStages * 8 + 1024;

// box (64 K, 128 rows) at (k0, row0) of a 2-D tensor map into shared memory
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int k0, int row0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k0), "r"(row0)
      : "memory");
}

// d (+)= A[64 x 16] W[128 x 16]^T; scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// -- K3's q, k and v, correctly rounded --
// K3 rounds its QKV sums to bf16, as the plain version rounds the float32
// value of the exact sum (its float64 sum).  The compensated tensor-core sum
// lies close to it, so the two round apart only where the sum lies close to
// a bf16 rounding boundary (a tie between two bf16 numbers).  The epilogue
// flags those elements in a bitmap, and exact_fixup then rounds each of them
// from its exact sum, in float64 from A's row and W's row.  "Close" is
// kSumSlack * max|A row| * max|W row| plus 2^-20 |v| (the float32 roundings
// after the sum).  On 68 draws of K3's inputs at the block bench's shape
// (d = 512) the compensated sums lay within 2^-19.37 of max|A row| max|W
// row| of the exact ones (chip_smoke.py phase 3 and --k3-draws print the
// largest error of each draw and check that no q, k or v rounds otherwise
// than the plain version's); kSumSlack is 2^-18, and about 0.5% of q, k and
// v then take the exact sum.

constexpr float kSumSlack = 1.0f / 262144;

struct ExactRounding {
  const bf16* a;       // A (M, K) and W (N, K), for the exact sums
  const bf16* w;
  const float* amax;   // max |A[m, :]| (M) and max |W[n, :]| (N)
  const float* wmax;
  uint32_t* flags;     // one bit per element of C, row-major, zeroed first
};

// the largest |element| of each row of a (rows, K) bf16 matrix, a warp a row,
// 8 elements a load (K % 8 == 0, rows 16-byte aligned)
__global__ void __launch_bounds__(256) row_absmax(const bf16* __restrict__ a, int rows, int K,
                                                  float* __restrict__ out) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  const uint4* r = reinterpret_cast<const uint4*>(a + (long long)row * K);
  uint32_t m = 0;  // of the magnitudes' bits: they order as the magnitudes do
  for (int c = lane; c < K / 8; c += 32) {
    const uint4 v = r[c];
    const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      m = max(m, max((words[j] << 16) & 0x7fff0000u, words[j] & 0x7fff0000u));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (lane == 0) out[row] = __uint_as_float(m);
}

// how far float32 v lies from the nearest tie between two bf16 numbers (its
// low 16 bits 0x8000), for a normal v
__device__ __forceinline__ float bf16_tie_distance(float v) {
  const uint32_t bits = __float_as_uint(v);
  const float ulp = __uint_as_float(bits & 0x7f800000u) * 1.1920928955078125e-7f;  // 2^-23
  return fabsf((float)((int)(bits & 0xffffu) - 0x8000)) * ulp;
}

// flags element (m, n) of C if v, its compensated sum + bias, lies close to
// a bf16 tie
__device__ __forceinline__ void flag_if_near(float v, int m, int n, int N,
                                             const ExactRounding& ex) {
  if (bf16_tie_distance(v) <= kSumSlack * ex.amax[m] * ex.wmax[n] +
                                  9.5367431640625e-7f * fabsf(v)) {  // 2^-20
    const long long i = (long long)m * N + n;
    atomicOr(ex.flags + i / 32, 1u << (i % 32));
  }
}

// C[m, n] = sum_k A[m, k] W[n, k] rounded once to float32, plus the bias,
// for each flagged element.  A product of two bf16 numbers has 16
// significant bits, so the products are exact in float64 and so are their
// sums while they span less than 2^37: the order does not matter.  Each warp
// reads 32 words of the bitmap at a time and takes their elements one by
// one, each lane 8 products of every 256 (K % 8 == 0, rows 16-byte aligned),
// so a row's loads are coalesced.
template <typename TC>
__global__ void __launch_bounds__(256) exact_fixup(const ExactRounding ex,
                                                   const float* __restrict__ bias,
                                                   TC* __restrict__ C, int M, int N, int K) {
  const long long words = ((long long)M * N + 31) / 32;
  const long long warps = (long long)gridDim.x * blockDim.x / 32;
  const int lane = threadIdx.x % 32;
  for (long long base = (blockIdx.x * (long long)blockDim.x + threadIdx.x) / 32 * 32;
       base < words; base += warps * 32) {
    const uint32_t word = base + lane < words ? ex.flags[base + lane] : 0u;
    for (unsigned todo = __ballot_sync(0xffffffffu, word != 0); todo != 0; todo &= todo - 1) {
      const int src = __ffs(todo) - 1;
      for (uint32_t bits = __shfl_sync(0xffffffffu, word, src); bits != 0; bits &= bits - 1) {
        const long long i = (base + src) * 32 + __ffs(bits) - 1;
        const long long m = i / N, n = i % N;
        const uint4* a4 = reinterpret_cast<const uint4*>(ex.a + m * K);
        const uint4* w4 = reinterpret_cast<const uint4*>(ex.w + n * K);
        double s = 0.0;
#pragma unroll 2
        for (int c = lane; c < K / 8; c += 32) {
          const uint4 av = a4[c], wv = w4[c];
          const uint32_t aw[4] = {av.x, av.y, av.z, av.w}, ww[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {  // two bf16 a word, the lower first
            s = fma((double)__uint_as_float(aw[j] << 16), (double)__uint_as_float(ww[j] << 16),
                    s);
            s = fma((double)__uint_as_float(aw[j] & 0xffff0000u),
                    (double)__uint_as_float(ww[j] & 0xffff0000u), s);
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane == 0) C[i] = from_float<TC>((float)s + bias[n]);
      }
    }
  }
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// One block per SM walks the 128x128 output tiles (n fastest, so the blocks
// in flight share rows of A in L2); warpgroup 2's first thread produces, the
// A and W slices of the block's tiles in order.  Warpgroups 0 and 1 consume:
//   * ping-pong (uncompensated products): warpgroup w takes the block's tiles
//     w, w + 2, ..., all 128 rows of each, and the two take turns at the
//     tensor cores (named barriers 1 and 2), so one writes its epilogue while
//     the other's products run;
//   * cooperative (kCompensated, whose Kahan sums need 64 more registers a
//     thread): both take every tile, 64 rows each; with a bf16 output, the
//     elements close to a bf16 tie flagged for exact_fixup (ex).
template <typename TC, bool kRelu, bool kCompensated>
__global__ void __launch_bounds__(kGemmThreads, 1) gemm_bf16_wgmma(
    const __grid_constant__ CUtensorMap tma_a, const __grid_constant__ CUtensorMap tma_w,
    const float* __restrict__ bias, TC* __restrict__ C, int M, int N, int K,
    const ExactRounding ex) {
  constexpr bool kPingPong = !kCompensated;
  constexpr bool kExact = kCompensated && std::is_same<TC, bf16>::value;
  constexpr int kHalves = kPingPong ? 2 : 1;  // 64-row halves of a tile per warpgroup
  extern __shared__ __align__(1024) unsigned char gemm_smem[];
  const uint32_t a_ring = (smem_u32(gemm_smem) + 1023) & ~1023u;
  const uint32_t w_ring = a_ring + kGemmStages * kGemmABytes;
  const uint32_t bars = w_ring + kGemmStages * kGemmWBytes;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kGemmStages + s); };
  const int tiles_n = (N + kGemmBN - 1) / kGemmBN;
  const int tiles = (M + kGemmBM - 1) / kGemmBM * tiles_n;
  const int kslices = (K + kGemmBK - 1) / kGemmBK;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kGemmStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kPingPong ? 1 : kGemmConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kGemmConsumers) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / tiles_n * kGemmBM, n0 = tile % tiles_n * kGemmBN;
        for (int ks = 0; ks < kslices; ++ks) {
          mbar_wait(empty(stage), phase ^ 1);
          // out-of-bounds zeros count towards the bytes too
          mbar_expect_tx(full(stage), kGemmABytes + kGemmWBytes);
          tma_load_2d(a_ring + stage * kGemmABytes, &tma_a, full(stage), ks * kGemmBK, m0);
          tma_load_2d(w_ring + stage * kGemmWBytes, &tma_w, full(stage), ks * kGemmBK, n0);
          if (++stage == kGemmStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {  // consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int warp = tid / 32, g = (tid % 32) / 4, t = tid % 4;
    const int step = kPingPong ? kGemmConsumers : 1;
    // i: the tile's place in the block's sequence, which fixes the ring
    // position of its first slice
    for (int i = kPingPong ? wg : 0, tile = blockIdx.x + i * gridDim.x; tile < tiles;
         i += step, tile += step * gridDim.x) {
      const int m0 = tile / tiles_n * kGemmBM, n0 = tile % tiles_n * kGemmBN;
      int stage = i * kslices % kGemmStages;
      uint32_t phase = (i * kslices / kGemmStages) & 1;
      // wait for the other warpgroup to have issued the previous tile: a
      // stage's full barrier is then at most one phase behind this wait
      if (kPingPong && i > 0) named_sync(1 + wg, 2 * 128);
      float acc[kHalves][64];
      float comp[kCompensated ? 64 : 1];  // Kahan's compensation
      if constexpr (kCompensated) {
#pragma unroll
        for (int e = 0; e < 64; ++e) acc[0][e] = comp[e] = 0.f;
      }
      int prev = 0;
      for (int ks = 0; ks < kslices; ++ks) {
        mbar_wait(full(stage), phase);
        const uint32_t a_t = a_ring + stage * kGemmABytes + (kPingPong ? 0 : wg * 64 * 128);
        const uint32_t w_t = w_ring + stage * kGemmWBytes;
        if constexpr (!kCompensated) {
#pragma unroll
          for (int h = 0; h < kHalves; ++h) fence_operands(acc[h]);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kGemmBK / 16; ++kk)
#pragma unroll
            for (int h = 0; h < kHalves; ++h)
              wgmma_m64n128k16(acc[h], sw128_desc(a_t + h * 64 * 128 + 32 * kk),
                               sw128_desc(w_t + 32 * kk), (ks > 0 || kk > 0) ? 1 : 0);
          wgmma_commit();
#pragma unroll
          for (int h = 0; h < kHalves; ++h) fence_operands(acc[h]);
          if (ks > 0) {  // the previous slice's products are done: free its stage
            wgmma_wait<1>();
            if (tid == 0) mbar_arrive(empty(prev));
          }
        } else {
          // each 32-deep slice summed by the tensor cores into a fresh
          // accumulator, then added to the running sum with Kahan's
          // compensation
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float part[64];
            fence_operands(part);
            wgmma_fence();
            wgmma_m64n128k16(part, sw128_desc(a_t + 64 * half), sw128_desc(w_t + 64 * half), 0);
            wgmma_m64n128k16(part, sw128_desc(a_t + 64 * half + 32),
                             sw128_desc(w_t + 64 * half + 32), 1);
            wgmma_commit();
            wgmma_wait<0>();
            fence_operands(part);
#pragma unroll
            for (int e = 0; e < 64; ++e) {
              const float y = part[e] - comp[e];
              const float s = acc[0][e] + y;
              comp[e] = (s - acc[0][e]) - y;
              acc[0][e] = s;
            }
          }
          if (tid == 0) mbar_arrive(empty(stage));
        }
        prev = stage;
        if (++stage == kGemmStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      // the other warpgroup's next tile may start, if there is one
      if (kPingPong && tile + gridDim.x < tiles) named_arrive(2 - wg, 2 * 128);
      if constexpr (!kCompensated) {
        wgmma_wait<0>();
#pragma unroll
        for (int h = 0; h < kHalves; ++h) fence_operands(acc[h]);
        if (tid == 0) mbar_arrive(empty(prev));
      }
      // epilogue: acc[h][4j + 2r + e] is row 64 h' + 16 warp + g + 8r, column
      // 8j + 2t + e, where h' is h (ping-pong) or wg (cooperative)
#pragma unroll
      for (int h = 0; h < kHalves; ++h) {
        const int row = m0 + (kPingPong ? h : wg) * 64 + warp * 16 + g;
#pragma unroll
        for (int j = 0; j < kGemmBN / 8; ++j) {
          const int col = n0 + 8 * j + 2 * t;
          if (col < N) {  // N % 8 == 0, so col + 1 < N too
            const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              if (row + 8 * r < M) {
                float v0 = acc[h][4 * j + 2 * r] + b0, v1 = acc[h][4 * j + 2 * r + 1] + b1;
                if constexpr (kExact) {
                  flag_if_near(v0, row + 8 * r, col, N, ex);
                  flag_if_near(v1, row + 8 * r, col + 1, N, ex);
                }
                if (kRelu) {
                  v0 = fmaxf(v0, 0.f);
                  v1 = fmaxf(v1, 0.f);
                }
                store2(C + (long long)(row + 8 * r) * N + col, v0, v1);
              }
            }
          }
        }
      }
    }
  }
}

// Tensor maps, encoded by cuTensorMapEncodeTiled looked up at run time (no
// link to libcuda) and cached by (base, rows, K): the descriptor depends on
// nothing else.
static PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  static std::once_flag once;
  std::call_once(once, [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  });
  return fn;
}

// A (rows, K) row-major matrix of bf16 (elem 2) or float32 (elem 4) elements,
// read in boxes of one 128-byte row (64 bf16 or 32 floats) by kGemmBM rows
// (kGemmBN rows of W, the same), swizzled 128B.
static cudaError_t tensor_map(CUtensorMap* map, const void* base, int rows, int K, int elem) {
  static std::mutex lock;
  static std::map<std::tuple<uintptr_t, int, int, int>, std::array<uint64_t, 16>> cache;
  static_assert(sizeof(CUtensorMap) == sizeof(std::array<uint64_t, 16>), "tensor map size");
  const auto key = std::make_tuple(reinterpret_cast<uintptr_t>(base), rows, K, elem);
  std::lock_guard<std::mutex> guard(lock);
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    std::memcpy(map, hit->second.data(), sizeof(CUtensorMap));
    return cudaSuccess;
  }
  const auto encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  cuuint64_t strides[1] = {(cuuint64_t)K * elem};
  cuuint32_t box[2] = {(cuuint32_t)(128 / elem), kGemmBM};
  cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r =
      encode(map, elem == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
             const_cast<void*>(base), dims, strides, box, elem_strides,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  if (cache.size() >= 1024) cache.clear();
  std::memcpy(cache[key].data(), map, sizeof(CUtensorMap));
  return cudaSuccess;
}

// absmax: scratch for the correctly rounded product (kCompensated with a
// bf16 C), null otherwise: M + N floats (the row maxima of A and W), then
// ceil(M N / 32) words (the flags).  The SM count and the kernel's
// shared-memory attribute are set once per device.
template <typename TC, bool kRelu, bool kCompensated>
cudaError_t gemm_wgmma(const bf16* A, const bf16* W, const float* bias, TC* C, int M, int N, int K,
                       float* absmax, cudaStream_t s) {
  constexpr bool kExact = kCompensated && std::is_same<TC, bf16>::value;
  if (M < 1 || N < 1 || K < 1 || (kExact && absmax == nullptr)) return cudaErrorInvalidValue;
  if (!aligned16(A) || !aligned16(W) || K % 8 || N % 8 ||
      reinterpret_cast<uintptr_t>(C) % (2 * sizeof(TC)))
    return cudaErrorMisalignedAddress;
  alignas(64) CUtensorMap ta, tw;
  cudaError_t err;
  if ((err = tensor_map(&ta, A, M, K, 2)) || (err = tensor_map(&tw, W, N, K, 2))) return err;
  const auto kernel = gemm_bf16_wgmma<TC, kRelu, kCompensated>;
  static int sms[kMaxDevices];
  int dev;
  using Site = KernelSite<gemm_bf16_wgmma<TC, kRelu, kCompensated> >;
  err = once_per_device<Site>(&dev, [&](int d) {
    const cudaError_t e = cudaDeviceGetAttribute(&sms[d], cudaDevAttrMultiProcessorCount, d);
    return e != cudaSuccess
               ? e
               : cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      kGemmSmem);
  });
  if (err != cudaSuccess) return err;
  ExactRounding ex{A, W, absmax, nullptr, nullptr};
  const long long words = ((long long)M * N + 31) / 32;
  if constexpr (kExact) {
    ex.wmax = absmax + M;
    ex.flags = reinterpret_cast<uint32_t*>(absmax + M + N);
    row_absmax<<<(M + 7) / 8, 256, 0, s>>>(A, M, K, absmax);
    row_absmax<<<(N + 7) / 8, 256, 0, s>>>(W, N, K, absmax + M);
    if ((err = cudaGetLastError()) || (err = cudaMemsetAsync(ex.flags, 0, words * 4, s)))
      return err;
  }
  const long long tiles =
      (long long)((M + kGemmBM - 1) / kGemmBM) * ((N + kGemmBN - 1) / kGemmBN);
  kernel<<<(int)std::min<long long>(tiles, sms[dev]), kGemmThreads, kGemmSmem, s>>>(
      ta, tw, bias, C, M, N, K, ex);
  if constexpr (kExact) {
    if ((err = cudaGetLastError())) return err;
    exact_fixup<TC><<<(int)std::min<long long>((words + 255) / 256, 8LL * sms[dev]), 256, 0, s>>>(
        ex, bias, C, M, N, K);
  }
  return cudaGetLastError();
}

// -- an operand in another type than the product's, converted into scratch --
// TMA reads an operand as it lies in memory, so a float32 x with bf16 weights
// is rounded to bf16 by this pass (the product rounds it anyway), and a bf16
// x with float32 weights is widened to float32 (exactly), before the QKV
// product.
template <typename TS, typename TD>
__global__ void convert_elements(const TS* __restrict__ src, TD* __restrict__ dst, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    dst[i] = from_float<TD>(to_float(src[i]));
}

// -- float32 A and W: 3xTF32 wgmma fed by TMA --
// Replaces the float32 products of explainable_spatial_vqa_tpu/ops/pallas_block.py
// ::_block_kernel (:113) and ::_tiled_kernel (:197), jnp.dot(xc, w,
// preferred_element_type=float32) with float32 xc and w.  Each operand x is
// split as split_tf32 does (attention.cuh): hi, x rounded to TF32, and lo =
// x - hi, of which the tensor cores read the top bits; the product is
// a_lo w_hi + a_hi w_lo + a_hi w_hi (mma_3xtf32's order), ~2^-22 |x| of error
// per operand and float32 sums.  Bound on the H100: three TF32 products at
// 495 TFLOP/s, 2 M N K x 3 operations (0.35 ms for K2's four products at
// B*L = 26,880, d = 512, ffn 2048), above the bytes at every block shape.
//
// The weights are static, so they are split once (ops/fused_block.py:
// split_tf32, cached with the model's fused weights) into a (2N, K) array,
// W_hi over W_lo, and TMA feeds both halves to wgmma's B operand straight
// from shared memory.  The activations change every call: A's float32 slice
// goes through shared memory into registers, where each consumer splits it
// and issues wgmma with A from registers for the hi and lo parts.  Writing
// A_hi and A_lo to device memory from the producing kernels would cost
// FFN1's hidden alone ~0.9 GB of traffic a block at B = 128.
//
// Layout: the producer's ring as gemm_bf16_wgmma's, 4 stages of three 128 x
// 32 float32 slices (A, W_hi, W_lo; one 128-byte swizzle row per tile row,
// 48 KB a stage).  Each 32-deep slice is summed by the tensor cores into a
// fresh accumulator (scale-d 0) and added to the running sum in float32:
// the tensor cores' accumulation rounds more coarsely than float32
// additions (see mma_3xtf32_add in attention.cuh), and summing all of K
// there (~770 of those roundings in a row for K = 2048) puts K2's FFN2
// product ~7x further from the plain version and saves a few percent of
// its time at most (PERF.md §6, measure/gemm_variants.py).  The fresh
// accumulator costs 64 registers a thread, so both consumer warpgroups take
// every tile, 64 rows each (the compensated bf16 product's arrangement):
// while one waits for its slice's products and adds them, the other's run.
constexpr int kTf32BK = 32;                                // floats of a 128-byte row
constexpr int kTf32Bytes = kGemmBM * kTf32BK * 4;          // one A, W_hi or W_lo slice
constexpr int kTf32Smem = kGemmStages * 3 * kTf32Bytes + 2 * kGemmStages * 8 + 1024;
static_assert(kGemmBM == kGemmBN, "A's and W's slices share one tensor-map box");

__device__ __forceinline__ float lds_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

// One block per SM walks the 128x128 output tiles, n fastest; warpgroup 2's
// first thread produces, warpgroups 0 and 1 consume rows 0-63 and 64-127 of
// every tile.  tma_whi and tma_wlo map the two (N, K) halves of W's split.
template <typename TC, bool kRelu>
__global__ void __launch_bounds__(kGemmThreads, 1) gemm_tf32_wgmma(
    const __grid_constant__ CUtensorMap tma_a, const __grid_constant__ CUtensorMap tma_whi,
    const __grid_constant__ CUtensorMap tma_wlo, const float* __restrict__ bias,
    TC* __restrict__ C, int M, int N, int K) {
  extern __shared__ __align__(1024) unsigned char gemm_smem[];
  const uint32_t a_ring = (smem_u32(gemm_smem) + 1023) & ~1023u;
  const uint32_t hi_ring = a_ring + kGemmStages * kTf32Bytes;
  const uint32_t lo_ring = hi_ring + kGemmStages * kTf32Bytes;
  const uint32_t bars = lo_ring + kGemmStages * kTf32Bytes;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kGemmStages + s); };
  const int tiles_n = (N + kGemmBN - 1) / kGemmBN;
  const int tiles = (M + kGemmBM - 1) / kGemmBM * tiles_n;
  const int kslices = (K + kTf32BK - 1) / kTf32BK;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kGemmStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kGemmConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kGemmConsumers) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / tiles_n * kGemmBM, n0 = tile % tiles_n * kGemmBN;
        for (int ks = 0; ks < kslices; ++ks) {
          mbar_wait(empty(stage), phase ^ 1);
          // out-of-bounds zeros count towards the bytes too
          mbar_expect_tx(full(stage), 3 * kTf32Bytes);
          tma_load_2d(a_ring + stage * kTf32Bytes, &tma_a, full(stage), ks * kTf32BK, m0);
          tma_load_2d(hi_ring + stage * kTf32Bytes, &tma_whi, full(stage), ks * kTf32BK, n0);
          tma_load_2d(lo_ring + stage * kTf32Bytes, &tma_wlo, full(stage), ks * kTf32BK, n0);
          if (++stage == kGemmStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {  // consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int warp = tid / 32, g = (tid % 32) / 4, t = tid % 4;
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile / tiles_n * kGemmBM, n0 = tile % tiles_n * kGemmBN;
      float acc[64];
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[e] = 0.f;
      for (int ks = 0; ks < kslices; ++ks) {
        mbar_wait(full(stage), phase);
        // this thread's A elements: tile rows 64 wg + 16 warp + g + 8 r,
        // columns 8 kk + t + 4 j, in 16-byte chunk (2 kk + j) ^ g of the row
        // (the 128-byte swizzle; the rows are g modulo 8)
        const uint32_t a_row =
            a_ring + stage * kTf32Bytes + (64 * wg + 16 * warp + g) * 128 + 4 * t;
        uint32_t hi[4][4], lo[4][4];  // [kk][2 j + r]
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int r = 0; r < 2; ++r)
              split_tf32(lds_f32(a_row + r * 8 * 128 + (((2 * kk + j) ^ g) << 4)),
                         hi[kk][2 * j + r], lo[kk][2 * j + r]);
        const uint32_t whi = hi_ring + stage * kTf32Bytes, wlo = lo_ring + stage * kTf32Bytes;
        float part[64];
        fence_operands(part);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_m64n128k8_tf32(part, lo[kk], sw128_desc(whi + 32 * kk), kk > 0 ? 1 : 0);
          wgmma_m64n128k8_tf32(part, hi[kk], sw128_desc(wlo + 32 * kk), 1);
          wgmma_m64n128k8_tf32(part, hi[kk], sw128_desc(whi + 32 * kk), 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(part);
        if (tid == 0) mbar_arrive(empty(stage));
#pragma unroll
        for (int e = 0; e < 64; ++e) acc[e] += part[e];
        if (++stage == kGemmStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      // epilogue: acc[4j + 2r + e] is row 64 wg + 16 warp + g + 8r, column
      // 8j + 2t + e
      const int row = m0 + wg * 64 + warp * 16 + g;
#pragma unroll
      for (int j = 0; j < kGemmBN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        if (col < N) {  // N % 4 == 0, so col + 1 < N too
          const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            if (row + 8 * r < M) {
              float v0 = acc[4 * j + 2 * r] + b0, v1 = acc[4 * j + 2 * r + 1] + b1;
              if (kRelu) {
                v0 = fmaxf(v0, 0.f);
                v1 = fmaxf(v1, 0.f);
              }
              store2(C + (long long)(row + 8 * r) * N + col, v0, v1);
            }
          }
        }
      }
    }
  }
}

// W is the (2N, K) split: W_hi's rows, then W_lo's.  The SM count and the
// kernel's shared-memory attribute are set once per device.
template <typename TC, bool kRelu>
cudaError_t gemm_tf32(const float* A, const float* W, const float* bias, TC* C, int M, int N,
                      int K, cudaStream_t s) {
  if (M < 1 || N < 1 || K < 1) return cudaErrorInvalidValue;
  if (!aligned16(A) || !aligned16(W) || K % 4 || N % 4 ||
      reinterpret_cast<uintptr_t>(C) % (2 * sizeof(TC)))
    return cudaErrorMisalignedAddress;
  alignas(64) CUtensorMap ta, thi, tlo;
  cudaError_t err;
  if ((err = tensor_map(&ta, A, M, K, 4)) || (err = tensor_map(&thi, W, N, K, 4)) ||
      (err = tensor_map(&tlo, W + (long long)N * K, N, K, 4)))
    return err;
  const auto kernel = gemm_tf32_wgmma<TC, kRelu>;
  static int sms[kMaxDevices];
  int dev;
  err = once_per_device<KernelSite<gemm_tf32_wgmma<TC, kRelu> > >(&dev, [&](int d) {
    const cudaError_t e = cudaDeviceGetAttribute(&sms[d], cudaDevAttrMultiProcessorCount, d);
    return e != cudaSuccess
               ? e
               : cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      kTf32Smem);
  });
  if (err != cudaSuccess) return err;
  const long long tiles =
      (long long)((M + kGemmBM - 1) / kGemmBM) * ((N + kGemmBN - 1) / kGemmBN);
  kernel<<<(int)std::min<long long>(tiles, sms[dev]), kGemmThreads, kTf32Smem, s>>>(
      ta, thi, tlo, bias, C, M, N, K);
  return cudaGetLastError();
}

// A in the weights' type: bf16 A and W take gemm_wgmma, float32 A and the
// (2N, K) split of float32 W gemm_tf32.  kCompensated (bf16 weights only):
// each 32-deep slice summed by the tensor cores apart and the slices added
// with Kahan's compensation, for products whose float32 sums are rounded to
// bf16 next (K3's q, k, v); with a bf16 C each element is rounded from the
// exact sum where the two could round apart, with absmax (gemm_wgmma) as
// scratch.  Float32 weights ignore it: their slices are added in float32.
template <typename TA, typename TC, bool kRelu, bool kCompensated = false>
cudaError_t gemm(const TA* A, const void* W, int w_dtype, const float* bias, TC* C, int M, int N,
                 int K, cudaStream_t s, float* absmax = nullptr) {
  if (w_dtype == kBFloat16) {
    if constexpr (std::is_same<TA, bf16>::value)
      return gemm_wgmma<TC, kRelu, kCompensated>(A, static_cast<const bf16*>(W), bias, C, M, N,
                                                 K, absmax, s);
  } else if (w_dtype == kFloat32) {
    if constexpr (std::is_same<TA, float>::value)
      return gemm_tf32<TC, kRelu>(A, static_cast<const float*>(W), bias, C, M, N, K, s);
  }
  return cudaErrorInvalidValue;
}

// ---- (c) out[m] = LN(res[m] + y[m]) * scale + bias, float32 statistics ----
// out2, where not null, gets the same values rounded to TO2.

constexpr int kLnThreads = 256;

template <typename TR, typename TO, typename TO2>
__global__ void __launch_bounds__(kLnThreads) add_layernorm(
    const TR* __restrict__ res, const float* __restrict__ y, const float* __restrict__ scale,
    const float* __restrict__ bias, TO* __restrict__ out, TO2* __restrict__ out2, int M, int N,
    float eps) {
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
  TO2* o2 = out2 == nullptr ? nullptr : out2 + (long long)row * N;
  for (int j = lane; j < N; j += 32) {
    const float t = to_float(r[j]) + yr[j];
    const float val = (t - mean) * inv * scale[j] + bias[j];
    o[j] = from_float<TO>(val);
    if (o2 != nullptr) o2[j] = from_float<TO2>(val);
  }
}

template <typename TR, typename TO, typename TO2 = TO>
cudaError_t layernorm(const TR* res, const float* y, const float* scale, const float* bias, TO* out,
                      TO2* out2, int M, int N, cudaStream_t s) {
  const int rows_per_block = kLnThreads / 32;
  add_layernorm<TR, TO, TO2><<<(M + rows_per_block - 1) / rows_per_block, kLnThreads, 0, s>>>(
      res, y, scale, bias, out, out2, M, N, 1e-6f);
  return cudaGetLastError();
}

// ---- the block ----

// The QKV product, x W_qkv^T + b, with x in the weights' type: with bf16
// weights a float32 x is rounded to bf16 into `spare` (the (B*L, d) x1w
// scratch, free until LN1) first, with float32 weights a bf16 x is widened
// into `spare32` (the x1 scratch, free until LN1).  absmax: the correctly
// rounded product's scratch (gemm), or null.
template <bool kCompensated, typename TX, typename TW, typename TC>
cudaError_t qkv_gemm(const TX* x, TW* spare, float* spare32, const TW* w, const float* b, TC* qkv,
                     int M, int d, float* absmax, cudaStream_t s) {
  const int wd = std::is_same<TW, bf16>::value ? kBFloat16 : kFloat32;
  if constexpr (!std::is_same<TX, TW>::value) {
    TW* xw = std::is_same<TW, bf16>::value ? spare : reinterpret_cast<TW*>(spare32);
    convert_elements<TX, TW><<<1024, 256, 0, s>>>(x, xw, (long long)M * d);
    if (cudaError_t err = cudaGetLastError()) return err;
    return gemm<TW, TC, false, kCompensated>(xw, w, wd, b, qkv, M, 3 * d, d, s, absmax);
  } else {
    return gemm<TX, TC, false, kCompensated>(x, w, wd, b, qkv, M, 3 * d, d, s, absmax);
  }
}

// x1 as FFN1's left operand: bf16 weights read LN1's bf16 copy, float32
// weights the float32 x1
template <typename TW>
const TW* ffn1_operand(const float* x1, const TW* x1w) {
  if constexpr (std::is_same<TW, float>::value) return x1;
  else return x1w;
}

template <typename TX, typename TW>
cudaError_t encoder_block(const TX* x, const float* mask, const TW* w_qkv, const float* b_qkv,
                          const TW* w_o, const float* b_o, const TW* w_1, const float* b_1,
                          const TW* w_2, const float* b_2, const float* ln1_s, const float* ln1_b,
                          const float* ln2_s, const float* ln2_b, TX* out, float* qkv, TW* attn,
                          float* proj, float* x1, TW* x1w, TW* hidden, int B, int L, int d, int H,
                          int ffn, cudaStream_t s) {
  const int M = B * L, wd = std::is_same<TW, bf16>::value ? kBFloat16 : kFloat32;
  if (L < 1 || L > kAttnMaxLen || H < 1 || d % H || !block_head_dim(d / H))
    return cudaErrorInvalidValue;
  TW* x1_copy = std::is_same<TW, bf16>::value ? x1w : nullptr;
  cudaError_t err;
  if ((err = qkv_gemm<false>(x, x1w, x1, w_qkv, b_qkv, qkv, M, d, nullptr, s))) return err;
  // heads read q, k and v straight out of the (B, L, 3d) projection buffer;
  // the output is rounded to the weights' type, the out projection's rounding
  const long long qkv_bs = (long long)L * 3 * d, qkv_rs = 3 * d;
  if ((err = block_attention<float, TW>(qkv, qkv + d, qkv + 2 * d, mask, attn, B, H, L, d / H,
                                        qkv_bs, qkv_rs, (long long)L * d, d, s)))
    return err;
  if ((err = gemm<TW, float, false>(attn, w_o, wd, b_o, proj, M, d, d, s))) return err;
  if ((err = layernorm<TX, float, TW>(x, proj, ln1_s, ln1_b, x1, x1_copy, M, d, s))) return err;
  if ((err = gemm<TW, TW, true>(ffn1_operand(x1, x1w), w_1, wd, b_1, hidden, M, ffn, d, s)))
    return err;
  if ((err = gemm<TW, float, false>(hidden, w_2, wd, b_2, proj, M, d, ffn, s))) return err;
  return layernorm<float, TX>(x1, proj, ln2_s, ln2_b, out, static_cast<TX*>(nullptr), M, d, s);
}

// K3: q, k, v and the attention output in the weights' type; the FFN in
// `chunks` row chunks (B*L % chunks == 0, checked by the caller).
template <typename TX, typename TW>
cudaError_t encoder_block_tiled(const TX* x, const float* mask, const TW* w_qkv,
                                const float* b_qkv, const TW* w_o, const float* b_o,
                                const TW* w_1, const float* b_1, const TW* w_2, const float* b_2,
                                const float* ln1_s, const float* ln1_b, const float* ln2_s,
                                const float* ln2_b, TX* out, TW* qkv, TW* attn, float* proj,
                                float* x1, TW* x1w, TW* hidden, int B, int L, int d, int H,
                                int ffn, int chunks, cudaStream_t s) {
  const int M = B * L, wd = std::is_same<TW, bf16>::value ? kBFloat16 : kFloat32;
  if (chunks < 1 || M % chunks || L < 1 || L > kAttnMaxLen || H < 1 || d % H ||
      !block_head_dim(d / H))
    return cudaErrorInvalidValue;
  TW* x1_copy = std::is_same<TW, bf16>::value ? x1w : nullptr;
  cudaError_t err;
  // proj, free until the out projection, holds the row maxima of x and W_qkv
  // and the flags of the correctly rounded product (M + 3d floats and
  // ceil(3 M d / 32) words, within M d for M >= 8)
  if ((err = qkv_gemm<true>(x, x1w, x1, w_qkv, b_qkv, qkv, M, d, proj, s))) return err;
  const long long qkv_bs = (long long)L * 3 * d, qkv_rs = 3 * d;
  if ((err = block_attention<TW, TW>(qkv, qkv + d, qkv + 2 * d, mask, attn, B, H, L, d / H,
                                     qkv_bs, qkv_rs, (long long)L * d, d, s)))
    return err;
  if ((err = gemm<TW, float, false>(attn, w_o, wd, b_o, proj, M, d, d, s))) return err;
  if ((err = layernorm<TX, float, TW>(x, proj, ln1_s, ln1_b, x1, x1_copy, M, d, s))) return err;
  const TW* x1a = ffn1_operand(x1, x1w);
  const int rows = M / chunks;
  for (int c = 0; c < chunks; ++c) {
    const long long r0 = (long long)c * rows * d;
    if ((err = gemm<TW, TW, true>(x1a + r0, w_1, wd, b_1, hidden, rows, ffn, d, s))) return err;
    if ((err = gemm<TW, float, false>(hidden, w_2, wd, b_2, proj + r0, rows, d, ffn, s)))
      return err;
  }
  return layernorm<float, TX>(x1, proj, ln2_s, ln2_b, out, static_cast<TX*>(nullptr), M, d, s);
}

}  // namespace esv

#define ESV_BLOCK_ARGS(TX, TW)                                                              \
  static_cast<const TX*>(x), f(mask), static_cast<const TW*>(w_qkv), f(b_qkv),              \
      static_cast<const TW*>(w_o), f(b_o), static_cast<const TW*>(w_1), f(b_1),             \
      static_cast<const TW*>(w_2), f(b_2), f(ln1_s), f(ln1_b), f(ln2_s), f(ln2_b),          \
      static_cast<TX*>(out)

extern "C" int esv_encoder_block(const void* x, const void* mask, const void* w_qkv,
                                 const void* b_qkv, const void* w_o, const void* b_o,
                                 const void* w_1, const void* b_1, const void* w_2,
                                 const void* b_2, const void* ln1_s, const void* ln1_b,
                                 const void* ln2_s, const void* ln2_b, void* out, void* qkv,
                                 void* attn, void* proj, void* x1, void* x1w, void* hidden, int B,
                                 int L, int d, int H, int ffn, int x_dtype, int w_dtype,
                                 void* stream) {
  using esv::bf16;
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ESV_BLOCK(TX, TW)                                                                      \
  return esv::encoder_block<TX, TW>(ESV_BLOCK_ARGS(TX, TW), static_cast<float*>(qkv),          \
                                    static_cast<TW*>(attn), static_cast<float*>(proj),         \
                                    static_cast<float*>(x1), static_cast<TW*>(x1w),            \
                                    static_cast<TW*>(hidden), B, L, d, H, ffn, s)
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
                                       void* attn, void* proj, void* x1, void* x1w, void* hidden,
                                       int B, int L, int d, int H, int ffn, int ffn_chunks,
                                       int x_dtype, int w_dtype, void* stream) {
  using esv::bf16;
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ESV_TILED(TX, TW)                                                                      \
  return esv::encoder_block_tiled<TX, TW>(ESV_BLOCK_ARGS(TX, TW), static_cast<TW*>(qkv),       \
                                          static_cast<TW*>(attn), static_cast<float*>(proj),   \
                                          static_cast<float*>(x1), static_cast<TW*>(x1w),      \
                                          static_cast<TW*>(hidden), B, L, d, H, ffn,           \
                                          ffn_chunks, s)
  if (x_dtype == esv::kFloat32 && w_dtype == esv::kFloat32) { ESV_TILED(float, float); }
  if (x_dtype == esv::kFloat32 && w_dtype == esv::kBFloat16) { ESV_TILED(float, bf16); }
  if (x_dtype == esv::kBFloat16 && w_dtype == esv::kFloat32) { ESV_TILED(bf16, float); }
  if (x_dtype == esv::kBFloat16 && w_dtype == esv::kBFloat16) { ESV_TILED(bf16, bf16); }
#undef ESV_TILED
  return cudaErrorInvalidValue;
}

#undef ESV_BLOCK_ARGS

extern "C" int esv_block_gemm(const void* A, const void* W, const void* bias, void* C,
                              void* absmax, int M, int N, int K, int a_dtype, int w_dtype,
                              int c_dtype, int relu, int compensated, void* stream) {
  using esv::bf16;
  const float* b = static_cast<const float*>(bias);
  float* mx = static_cast<float*>(absmax);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((a_dtype != esv::kFloat32 && a_dtype != esv::kBFloat16) ||
      (w_dtype != esv::kFloat32 && w_dtype != esv::kBFloat16) ||
      (compensated && (w_dtype != esv::kBFloat16 || relu)))
    return cudaErrorInvalidValue;
#define ESV_GEMM(TA, TC, RELU)                                                               \
  return esv::gemm<TA, TC, RELU>(static_cast<const TA*>(A), W, w_dtype, b, static_cast<TC*>(C), \
                                 M, N, K, s)
#define ESV_GEMM_RELU(TA, TC)                                                                \
  if (compensated)                                                                         \
    return esv::gemm<TA, TC, false, true>(static_cast<const TA*>(A), W, w_dtype, b,         \
                                          static_cast<TC*>(C), M, N, K, s, mx);            \
  if (relu) { ESV_GEMM(TA, TC, true); }                                                    \
  ESV_GEMM(TA, TC, false)
  if (a_dtype == esv::kBFloat16 && c_dtype == esv::kFloat32) { ESV_GEMM_RELU(bf16, float); }
  if (a_dtype == esv::kBFloat16 && c_dtype == esv::kBFloat16) { ESV_GEMM_RELU(bf16, bf16); }
  if (a_dtype == esv::kFloat32 && c_dtype == esv::kFloat32) { ESV_GEMM_RELU(float, float); }
  if (a_dtype == esv::kFloat32 && c_dtype == esv::kBFloat16) { ESV_GEMM_RELU(float, bf16); }
#undef ESV_GEMM_RELU
#undef ESV_GEMM
  return cudaErrorInvalidValue;
}

extern "C" int esv_block_attention(const void* q, const void* k, const void* v, const void* mask,
                                   void* out, int B, int H, int L, int D, long long in_bs,
                                   long long in_rs, long long out_bs, long long out_rs, int dtype,
                                   int out_dtype, void* stream) {
  using esv::bf16;
  const float* m = static_cast<const float*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ESV_BLOCK_ATTENTION(T, TO)                                                         \
  return esv::block_attention<T, TO>(static_cast<const T*>(q), static_cast<const T*>(k),   \
                                     static_cast<const T*>(v), m, static_cast<TO*>(out), B, \
                                     H, L, D, in_bs, in_rs, out_bs, out_rs, s)
  if (dtype == esv::kFloat32 && out_dtype == esv::kFloat32) { ESV_BLOCK_ATTENTION(float, float); }
  if (dtype == esv::kFloat32 && out_dtype == esv::kBFloat16) { ESV_BLOCK_ATTENTION(float, bf16); }
  if (dtype == esv::kBFloat16 && out_dtype == esv::kBFloat16) { ESV_BLOCK_ATTENTION(bf16, bf16); }
#undef ESV_BLOCK_ATTENTION
  return cudaErrorInvalidValue;
}

extern "C" const char* esv_block_attention_kernel(int i) {
  return i >= 0 && i < esv::kAttnKernels ? esv::kAttnKernelNames[i] : nullptr;
}

extern "C" long long esv_block_attention_launches(int i) {
  return i >= 0 && i < esv::kAttnKernels ? esv::attention_launches()[i].load() : -1;
}

#endif
