// Paged decode attention for Hopper (sm_90a): the f32/bf16 page walk.
//
// Replaces the TPU Pallas kernel agentcontrolplane_tpu/ops/pallas/
// paged_attention.py (_kernel/_paged_state with quantized=False, :56-275,
// through the pl.pallas_call at :265) in both epilogue forms. The kernel
// template, its design and its bound are in paged_attention.cuh; the int8
// walk is built from the same template in paged_attention_int8.cu.

#include "paged_attention.cuh"

// Plain C entry for ctypes. dtype: 0 = float32, 1 = bfloat16 (q, pages,
// k_new, v_new and out share it). k_new/v_new may be null when
// with_self == 0. Launches on `stream` and returns cudaGetLastError()
// (0 = launched); the caller raises on anything else.
extern "C" int acp_paged_decode_attention(const void* q, const void* k_pages,
                                          const void* v_pages, const void* block_tables,
                                          const void* seq_lens, const void* k_new,
                                          const void* v_new, void* out, int S, int H,
                                          int H_kv, int d, int P, int max_pages,
                                          int dtype, int with_self, void* stream) {
  if (!acp::valid_shape(S, H, H_kv, P, max_pages))
    return static_cast<int>(cudaErrorInvalidValue);
  const acp::Args a{q, k_pages, v_pages, nullptr, nullptr,
                    static_cast<const int*>(block_tables), static_cast<const int*>(seq_lens),
                    k_new, v_new, out, S, H, H_kv, P, max_pages, with_self,
                    static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  if (dtype == 0) {
    err = acp::dispatch_d<float, float>(d, a);
  } else if (dtype == 1) {
    err = acp::dispatch_d<__nv_bfloat16, __nv_bfloat16>(d, a);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
