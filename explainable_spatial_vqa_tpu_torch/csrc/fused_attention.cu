// K1: fused masked attention, CUDA C++ for sm_90a.
//
// Replaces explainable_spatial_vqa_tpu/ops/pallas_attention.py:_fused_attention_bhld,
// the Pallas kernel that computes softmax(mask(Q K^T / sqrt(D))) V for one
// (batch, head) per grid cell with the whole (L, L) score tile in VMEM.
//
// Bound on the H100: the work is 4*L*L*D operations against 4*L*D elements
// moved per (batch, head), so at the lengths of this model (L = 10 in the box
// decoder, L = 210 in the fusion encoder, D = 128) it does at most ~105
// operations per byte in bf16, below the ~295 the card needs to be limited by
// its tensor cores: the bound is the bytes of q, k, v and the output.
//
// Design: one block per (batch, head, 32 queries).  Q and one tile of K or V
// sit in shared memory in float32; the scores of the block's 32 queries are
// kept whole in shared memory, so the softmax normalises before the weights
// are rounded to the input type, exactly as the TPU kernel does.  Products run
// on the CUDA cores in float32 (fmaf), which keeps the float32 path exact and
// the kernel simple; moving them to tensor cores is later work.
//
// C interface, bound with ctypes (every pointer and the stream a void*):
//   int esv_attention(q, k, v, mask, out, B, H, L, D, in_batch_stride,
//                     in_row_stride, out_batch_stride, out_row_stride, dtype, stream)
// mask is a (B, L) float32 key mask (keep where > 0) or null; dtype is 0 for
// float32, 1 for bfloat16 (q, k, v and out share it).  Returns the CUDA error
// of the launch (0 on success).

#include "attention.cuh"

extern "C" int esv_attention(const void* q, const void* k, const void* v, const void* mask,
                             void* out, int B, int H, int L, int D, long long in_bs,
                             long long in_rs, long long out_bs, long long out_rs, int dtype,
                             void* stream) {
  const float* m = static_cast<const float*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == esv::kFloat32) {
    return esv::launch_attention<float>(static_cast<const float*>(q), static_cast<const float*>(k),
                                        static_cast<const float*>(v), m, static_cast<float*>(out),
                                        B, H, L, D, in_bs, in_rs, out_bs, out_rs, s);
  }
  if (dtype == esv::kBFloat16) {
    using bf16 = __nv_bfloat16;
    return esv::launch_attention<bf16>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                       static_cast<const bf16*>(v), m, static_cast<bf16*>(out),
                                       B, H, L, D, in_bs, in_rs, out_bs, out_rs, s);
  }
  return cudaErrorInvalidValue;
}
