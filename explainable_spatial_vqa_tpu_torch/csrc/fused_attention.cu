// K1: fused masked attention, CUDA C++ for sm_90a.
//
// Replaces explainable_spatial_vqa_tpu/ops/pallas_attention.py:_fused_attention_bhld,
// the Pallas kernel that computes softmax(mask(Q K^T / sqrt(D))) V for one
// (batch, head) per grid cell with the whole (L, L) score tile in VMEM.
//
// The TPU kernel is generic in the head dim, and so is this one, from 1 to
// kAttnMaxHeadDim (512, attention.cuh).  Every multiple of 8 from 8 to 128 (ESV_K1_HEAD_DIMS) is an
// instantiation of its own of attention.cuh's kernels with its loads and
// fragment loops folded to constants: the models' 24, 48, 64 and 128 (4
// heads at d_model 96 and 192, the CoGenT protocol's executors; 256, the
// baselines, the CoT IQAP and HierarchicalGenerator; 512, the thesis
// executor) and every other multiple a user may give them (4 heads at
// d_model 32, ..., 480).  bf16 scores at D % 16 == 8 take their m16n8k16
// products over a depth zero-padded by 8 in shared memory (attention.cuh:
// attn_depth).  Every other head dim (25 at the protocol's --d_model 100, 256
// at 1024, 275 at 1100, 384 and 512 at 1536 and 2048) takes
// attention_padded.cuh's kernels at its padded depth (ESV_K1_PAD_DEPTHS),
// with the head dim a run-time argument: past 256 its deep kernel in
// float32 (attention_kernel_deep_f32; float32 rows of whole 16-byte chunks
// past 16 keys at every padded depth past 128 but 256 go to
// attention_f32_wide.cuh's attention_kernel_wide_f32), past 128 its short
// kernels at L <= 16 (attention_kernel_short_f32, attention_kernel_short:
// the box decoders at d_model 768-2048); bf16 rows past 16 keys past depth
// 128, of any width, go to attention_wide.cuh's attention_kernel_wgmma
// (160-256) and attention_kernel_wgmma_deep (288-512) up to 256 keys, and
// past them to attention_kernel_wgmma_2pass_deep (160-512).
//
// Bound on the H100: the bytes of q, k, v and the output at the models'
// lengths (L = 8 or 10 in the box decoders, 196-246 in the encoders); at
// L <= 16 the launch itself dominates.  The kernels are attention.cuh's
// (mma.sync on the tensor cores: P V in bf16, or both products in 3xTF32
// for float32, each warp's 16 rows of scores in registers) and
// attention_wide.cuh's (wgmma).  bf16 weights are normalised before they are
// rounded, exactly as the TPU kernel does: past 16 keys, at D <= 64 up to
// 256 keys (the d 256 encoders) in one pass over K and V held whole in
// shared memory (attention_kernel_onepass), at D = 72-128 up to 256 keys in
// one pass on wgmma (attention_kernel_wgmma; so too past depth 128 in rows
// of whole 16-byte chunks, past 256 as attention_kernel_wgmma_deep), and
// past 256 keys at every D in two passes on wgmma
// (attention_kernel_wgmma_2pass, past depth 128
// attention_kernel_wgmma_2pass_deep); at L <= 16 one
// warp's cp.async ring (attention_kernel), past depth 128 a block of G
// warps per (batch, head) (attention_kernel_short).  float32 weights are
// not rounded, and their softmax runs online.
//
// Translation units: this file is compiled once for the C entries below,
// once for each group of one or two head dims (ops/_build.py:
// K1_DIM_GROUPS), with -DESV_HEAD_DIM_A=<dim> [-DESV_HEAD_DIM_B=<dim>],
// which instantiates attention_at_dim at those dims for the three type
// pairs, and once for each group of one or two padded depths
// (K1_PAD_GROUPS), with -DESV_PAD_DEPTH_A=<depth> [-DESV_PAD_DEPTH_B=<depth>],
// which instantiates attention_at_depth.  The units compile in parallel and
// link into one
// library; the launch counts are one for the library (attention.cuh:
// attention_launches).
//
// C interface, bound with ctypes (every pointer and the stream a void*):
//   int esv_attention(q, k, v, mask, out, B, H, L, D, in_batch_stride,
//                     in_row_stride, out_batch_stride, out_row_stride, dtype,
//                     out_dtype, stream)
// mask is a (B, L) float32 key mask (keep where > 0) or null; dtype is 0 for
// float32, 1 for bfloat16 (q, k and v share it); out_dtype is the output's,
// either float32 or dtype.  D is 1 to kAttnMaxHeadDim; at D in ESV_K1_HEAD_DIMS q, k, v
// and their strides must be 16-byte aligned.  L is 1 to kAttnMaxLen.
// Returns the CUDA error of the launch (0 on success; cudaErrorInvalidValue
// for another D or L).
//   int esv_attention_fma_scores(the same arguments)
// runs every call past 16 keys on the ring (attention_kernel<bf16, bf16,
// 128, 8>: bf16 q, k, v and output, D = 128 only) with its scores summed
// in FMA chains on the CUDA cores instead of on the tensor cores: a variant
// that no wrapper launches, kept so that chip_smoke.py can time it and hold
// it against the plain version beside the kernel (PERF.md §6).
//   const char* esv_attention_kernel(int i)
//   long long esv_attention_launches(int i)
// name K1's kernel function i (0: attention_kernel_f32, 1: attention_kernel,
// 2: attention_kernel_onepass, 3: attention_kernel_padded_f32, 4:
// attention_kernel_padded, 5: attention_kernel_split_f32, 6:
// attention_kernel_wgmma, 7: attention_kernel_wgmma_2pass, 8:
// attention_kernel_deep_f32, 9: attention_kernel_wgmma_deep, 10:
// attention_kernel_short_f32, 11: attention_kernel_short, 12:
// attention_kernel_wide_f32, 13: attention_kernel_wgmma_2pass_deep; null
// and -1 past the last) and count the
// launches of it that this library's entries have made since it was loaded:
// which kernel a call takes is decided in launch_attention_dim and
// launch_attention_padded alone, and the counts say which ran.
//   int esv_attention_max_len()
// the longest row the entry takes (kAttnMaxLen).
//   int esv_attention_max_head_dim()
// the widest head dim the entry takes (kAttnMaxHeadDim).

#include "attention_padded.cuh"

#define ESV_K1_HEAD_DIMS 8, 16, 24, 32, 40, 48, 56, 64, 72, 80, 88, 96, 104, 112, 120, 128
#define ESV_K1_PAD_DEPTHS 16, 32, 48, 64, 80, 96, 112, 128, 160, 192, 224, 256, 288, 336, 384, 448, 512

namespace esv {

// K1 at head dim D for q, k, v of type T and an output of type TO: defined
// and instantiated in the unit of D's group, called from the C entry
template <int D, typename T, typename TO>
cudaError_t attention_at_dim(const T* q, const T* k, const T* v, const float* mask, TO* out,
                             int B, int H, int L, long long in_bs, long long in_rs,
                             long long out_bs, long long out_rs, cudaStream_t stream);

// K1 at a head dim D whose padded depth is DP: defined and instantiated in
// the unit of DP's group
template <int DP, typename T, typename TO>
cudaError_t attention_at_depth(const T* q, const T* k, const T* v, const float* mask, TO* out,
                               int B, int H, int L, int D, long long in_bs, long long in_rs,
                               long long out_bs, long long out_rs, cudaStream_t stream);

}  // namespace esv

#ifdef ESV_HEAD_DIM_A

namespace esv {

template <int D, typename T, typename TO>
cudaError_t attention_at_dim(const T* q, const T* k, const T* v, const float* mask, TO* out,
                             int B, int H, int L, long long in_bs, long long in_rs,
                             long long out_bs, long long out_rs, cudaStream_t stream) {
  return launch_attention_dim<D, T, TO>(q, k, v, mask, out, B, H, L, in_bs, in_rs, out_bs,
                                        out_rs, stream);
}

#define ESV_AT_DIM(D, T, TO)                                                                   \
  template cudaError_t attention_at_dim<D, T, TO>(const T*, const T*, const T*, const float*,   \
                                                  TO*, int, int, int, long long, long long,     \
                                                  long long, long long, cudaStream_t);
#define ESV_INSTANTIATE(D)                \
  ESV_AT_DIM(D, float, float)             \
  ESV_AT_DIM(D, float, __nv_bfloat16)     \
  ESV_AT_DIM(D, __nv_bfloat16, __nv_bfloat16)
ESV_INSTANTIATE(ESV_HEAD_DIM_A)
#ifdef ESV_HEAD_DIM_B
ESV_INSTANTIATE(ESV_HEAD_DIM_B)
#endif

}  // namespace esv

#elif defined(ESV_PAD_DEPTH_A)

namespace esv {

template <int DP, typename T, typename TO>
cudaError_t attention_at_depth(const T* q, const T* k, const T* v, const float* mask, TO* out,
                               int B, int H, int L, int D, long long in_bs, long long in_rs,
                               long long out_bs, long long out_rs, cudaStream_t stream) {
  return launch_attention_padded<DP, T, TO>(q, k, v, mask, out, B, H, L, D, in_bs, in_rs, out_bs,
                                            out_rs, stream);
}

#define ESV_AT_DEPTH(DP, T, TO)                                                                \
  template cudaError_t attention_at_depth<DP, T, TO>(const T*, const T*, const T*,             \
                                                     const float*, TO*, int, int, int, int,    \
                                                     long long, long long, long long,          \
                                                     long long, cudaStream_t);
#define ESV_INSTANTIATE_DEPTH(DP)          \
  ESV_AT_DEPTH(DP, float, float)           \
  ESV_AT_DEPTH(DP, float, __nv_bfloat16)   \
  ESV_AT_DEPTH(DP, __nv_bfloat16, __nv_bfloat16)
ESV_INSTANTIATE_DEPTH(ESV_PAD_DEPTH_A)
#ifdef ESV_PAD_DEPTH_B
ESV_INSTANTIATE_DEPTH(ESV_PAD_DEPTH_B)
#endif

}  // namespace esv

#else

namespace esv {

// The head dims Ds, chosen by D at run time; any other D returns
// cudaErrorInvalidValue
template <typename T, typename TO, int... Ds>
static cudaError_t attention_by_dim(const T* q, const T* k, const T* v, const float* mask, TO* out,
                                    int B, int H, int L, int D, long long in_bs, long long in_rs,
                                    long long out_bs, long long out_rs, cudaStream_t stream) {
  cudaError_t err = cudaErrorInvalidValue;
  (void)((D == Ds && ((err = attention_at_dim<Ds, T, TO>(q, k, v, mask, out, B, H, L, in_bs,
                                                         in_rs, out_bs, out_rs, stream)),
                      true)) || ...);
  return err;
}

// Every other head dim up to kAttnMaxHeadDim, at its padded depth
// (padded_depth) among DPs
template <typename T, typename TO, int... DPs>
static cudaError_t attention_by_depth(const T* q, const T* k, const T* v, const float* mask,
                                      TO* out, int B, int H, int L, int D, long long in_bs,
                                      long long in_rs, long long out_bs, long long out_rs,
                                      cudaStream_t stream) {
  if (D < 1 || D > kAttnMaxHeadDim) return cudaErrorInvalidValue;
  const int dp = padded_depth(D);
  cudaError_t err = cudaErrorInvalidValue;
  (void)((dp == DPs && ((err = attention_at_depth<DPs, T, TO>(q, k, v, mask, out, B, H, L, D,
                                                              in_bs, in_rs, out_bs, out_rs,
                                                              stream)),
                        true)) || ...);
  return err;
}

// whether D is one of Ds
template <int... Ds>
static bool exact_dim(int D) {
  return ((D == Ds) || ...);
}

}  // namespace esv

extern "C" int esv_attention(const void* q, const void* k, const void* v, const void* mask,
                             void* out, int B, int H, int L, int D, long long in_bs,
                             long long in_rs, long long out_bs, long long out_rs, int dtype,
                             int out_dtype, void* stream) {
  using bf16 = __nv_bfloat16;
  const float* m = static_cast<const float*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L > esv::kAttnMaxLen) return cudaErrorInvalidValue;
  const bool exact = esv::exact_dim<ESV_K1_HEAD_DIMS>(D);
#define ESV_ATTENTION(T, TO)                                                                   \
  return exact ? esv::attention_by_dim<T, TO, ESV_K1_HEAD_DIMS>(                               \
                     static_cast<const T*>(q), static_cast<const T*>(k),                        \
                     static_cast<const T*>(v), m, static_cast<TO*>(out), B, H, L, D, in_bs,     \
                     in_rs, out_bs, out_rs, s)                                                 \
               : esv::attention_by_depth<T, TO, ESV_K1_PAD_DEPTHS>(                            \
                     static_cast<const T*>(q), static_cast<const T*>(k),                        \
                     static_cast<const T*>(v), m, static_cast<TO*>(out), B, H, L, D, in_bs,     \
                     in_rs, out_bs, out_rs, s)
  if (dtype == esv::kFloat32 && out_dtype == esv::kFloat32) { ESV_ATTENTION(float, float); }
  if (dtype == esv::kFloat32 && out_dtype == esv::kBFloat16) { ESV_ATTENTION(float, bf16); }
  if (dtype == esv::kBFloat16 && out_dtype == esv::kBFloat16) { ESV_ATTENTION(bf16, bf16); }
#undef ESV_ATTENTION
  return cudaErrorInvalidValue;
}

extern "C" int esv_attention_fma_scores(const void* q, const void* k, const void* v,
                                        const void* mask, void* out, int B, int H, int L, int D,
                                        long long in_bs, long long in_rs, long long out_bs,
                                        long long out_rs, int dtype, int out_dtype,
                                        void* stream) {
  using bf16 = __nv_bfloat16;
  if (dtype != esv::kBFloat16 || out_dtype != esv::kBFloat16 || D != 128)
    return cudaErrorInvalidValue;
  return esv::launch_attention_dim<128, bf16, bf16, true>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(mask), static_cast<bf16*>(out), B, H, L, in_bs, in_rs, out_bs,
      out_rs, static_cast<cudaStream_t>(stream));
}

extern "C" const char* esv_attention_kernel(int i) {
  return i >= 0 && i < esv::kAttnKernels ? esv::kAttnKernelNames[i] : nullptr;
}

extern "C" long long esv_attention_launches(int i) {
  return i >= 0 && i < esv::kAttnKernels ? esv::attention_launches()[i].load() : -1;
}

extern "C" int esv_attention_max_len() { return esv::kAttnMaxLen; }

extern "C" int esv_attention_max_head_dim() { return esv::kAttnMaxHeadDim; }

#endif
