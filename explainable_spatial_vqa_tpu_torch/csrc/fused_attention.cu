// K1: fused masked attention, CUDA C++ for sm_90a.
//
// Replaces explainable_spatial_vqa_tpu/ops/pallas_attention.py:_fused_attention_bhld,
// the Pallas kernel that computes softmax(mask(Q K^T / sqrt(D))) V for one
// (batch, head) per grid cell with the whole (L, L) score tile in VMEM.
//
// The TPU kernel is generic in the head dim; this one is built for D = 24,
// 48, 64 and 128, every head dim the models send it (4 heads at d_model 96
// and 192, the CoGenT protocol's executors; 256, the baselines, the CoT IQAP
// and HierarchicalGenerator; 512, the thesis executor).  bf16 scores at
// D = 24 take their m16n8k16 products over a depth zero-padded to 32 in
// shared memory (attention.cuh: attn_depth).
//
// Bound on the H100: the bytes of q, k, v and the output at the models'
// lengths (L = 8 or 10 in the box decoders, 196-246 in the encoders); at
// L <= 16 the launch itself dominates.  The kernels are attention.cuh's:
// mma.sync on the tensor cores (P V in bf16, or both products in 3xTF32 for
// float32), each warp's 16 rows of scores in registers.  bf16 weights are
// normalised before they are rounded, exactly as the TPU kernel does: at
// D <= 64 and 16 < L <= 256 (the d 256 encoders) in one pass over K and V
// held whole in shared memory (attention_kernel_onepass); otherwise K and V
// stream through a cp.async ring, in two passes past 224 keys.  float32
// weights are not rounded, and their softmax runs online.
//
// C interface, bound with ctypes (every pointer and the stream a void*):
//   int esv_attention(q, k, v, mask, out, B, H, L, D, in_batch_stride,
//                     in_row_stride, out_batch_stride, out_row_stride, dtype,
//                     out_dtype, stream)
// mask is a (B, L) float32 key mask (keep where > 0) or null; dtype is 0 for
// float32, 1 for bfloat16 (q, k and v share it); out_dtype is the output's,
// either float32 or dtype.  q, k, v and their strides must be 16-byte
// aligned; D is one of 24, 48, 64 and 128.  Returns the CUDA error of the
// launch (0 on success; cudaErrorInvalidValue for another D).
//   int esv_attention_fma_scores(the same arguments)
// is the bf16 kernel (bf16 q, k, v and output, D = 128 only) with its scores summed
// in FMA chains on the CUDA cores instead of on the tensor cores: a variant
// that no wrapper launches, kept so that chip_smoke.py can time it and hold
// it against the plain version beside the kernel (PERF.md §6).
//   const char* esv_attention_kernel(int i)
//   long long esv_attention_launches(int i)
// name K1's kernel function i (0: attention_kernel_f32, 1: attention_kernel,
// 2: attention_kernel_onepass; null and -1 past the last) and count the
// launches of it that this library's entries have made since it was loaded:
// which kernel a call takes is decided in launch_attention_dim alone, and
// the counts say which ran.

#include "attention.cuh"

extern "C" int esv_attention(const void* q, const void* k, const void* v, const void* mask,
                             void* out, int B, int H, int L, int D, long long in_bs,
                             long long in_rs, long long out_bs, long long out_rs, int dtype,
                             int out_dtype, void* stream) {
  using bf16 = __nv_bfloat16;
  const float* m = static_cast<const float*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ESV_ATTENTION(T, TO)                                                                   \
  return esv::launch_attention<T, TO, 24, 48, 64, 128>(                                        \
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), m,          \
      static_cast<TO*>(out), B, H, L, D, in_bs, in_rs, out_bs, out_rs, s)
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
