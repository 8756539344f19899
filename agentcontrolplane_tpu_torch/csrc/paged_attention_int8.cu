// Paged decode attention for Hopper (sm_90a): the int8 page walk.
//
// Replaces the TPU Pallas kernel agentcontrolplane_tpu/ops/pallas/
// paged_attention.py, _kernel with quantized=True (:82-93, :116-126,
// :153-158; operands :240-253, through the pl.pallas_call at :265), in both
// epilogue forms: int8 pages [NP, P, H_kv, d] with f32 scale twins
// [NP, P, H_kv], each row dequantized as value * scale (ops/quant.py
// kv_dequantize) before the f32 online softmax. q, k_new, v_new and out
// stay float32 or bfloat16. The kernel template, its design and its bound
// are in paged_attention.cuh.
//
// Bound: bytes — rows x H_kv x d x 2 bytes of int8 K and V plus
// rows x H_kv x 2 x 4 bytes of scales, about 0.52x the bf16 walk's bytes
// at d = 128; the walk takes the same number of steps as the bf16 one.

#include "paged_attention.cuh"

// Plain C entry for ctypes. dtype is q's (and k_new's, v_new's, out's):
// 0 = float32, 1 = bfloat16; the pages are int8 and k_scales/v_scales f32.
// k_new/v_new may be null when with_self == 0. Launches on `stream` and
// returns cudaGetLastError() (0 = launched); the caller raises otherwise.
extern "C" int acp_paged_decode_attention_int8(
    const void* q, const void* k_pages, const void* v_pages, const void* k_scales,
    const void* v_scales, const void* block_tables, const void* seq_lens, const void* k_new,
    const void* v_new, void* out, int S, int H, int H_kv, int d, int P, int max_pages,
    int dtype, int with_self, void* stream) {
  if (!acp::valid_shape(S, H, H_kv, P, max_pages) || k_scales == nullptr ||
      v_scales == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const acp::Args a{q, k_pages, v_pages,
                    static_cast<const float*>(k_scales), static_cast<const float*>(v_scales),
                    static_cast<const int*>(block_tables), static_cast<const int*>(seq_lens),
                    k_new, v_new, out, S, H, H_kv, P, max_pages, with_self,
                    static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  if (dtype == 0) {
    err = acp::dispatch_d<float, int8_t>(d, a);
  } else if (dtype == 1) {
    err = acp::dispatch_d<__nv_bfloat16, int8_t>(d, a);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
