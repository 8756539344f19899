// Paged decode attention for Hopper (sm_90a): the f32/bf16 page walk.
//
// Replaces the TPU Pallas kernel agentcontrolplane_tpu/ops/pallas/
// paged_attention.py (_kernel/_paged_state with quantized=False, :56-275,
// through the pl.pallas_call at :265) in its three epilogue forms: the two
// normalized ones (acp_paged_decode_attention) and the unnormalized state
// over a slice of every page that the context-parallel wrapper merges
// across ranks (acp_paged_decode_state; :399-460). The kernel template, its
// design and its bound are in paged_attention.cuh; the int8 walk is built
// from the same template in paged_attention_int8.cu.

#include "paged_attention.cuh"

namespace {
// dtype: 0 = float32, 1 = bfloat16 (q, pages, k_new, v_new and out share it)
int dispatch(int dtype, int d, const acp::Args& a) {
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
}  // namespace

// Plain C entry for ctypes. dtype: 0 = float32, 1 = bfloat16 (q, pages,
// k_new, v_new and out share it). k_new/v_new may be null when
// with_self == 0. The walk is cut into n_split runs of table columns, one
// block each; with n_split > 1, ws ([S, H_kv, n_split, n_rep * (d + 2)]
// f32) holds the splits' partials and counters ([S * H_kv] int32, zero on
// entry, zero again on exit) their tickets. Launches on `stream` and
// returns cudaGetLastError() (0 = launched); the caller raises on anything
// else.
extern "C" int acp_paged_decode_attention(const void* q, const void* k_pages,
                                          const void* v_pages, const void* block_tables,
                                          const void* seq_lens, const void* k_new,
                                          const void* v_new, void* out, void* ws,
                                          void* counters, int S, int H, int H_kv,
                                          int d, int P, int max_pages, int dtype,
                                          int with_self, int n_split, void* stream) {
  if (!acp::valid_shape(S, H, H_kv, P, max_pages) ||
      !acp::valid_split(n_split, max_pages, ws, counters))
    return static_cast<int>(cudaErrorInvalidValue);
  const acp::Args a{q, k_pages, v_pages, nullptr, nullptr,
                    static_cast<const int*>(block_tables), static_cast<const int*>(seq_lens),
                    k_new, v_new, out, nullptr, nullptr, nullptr, static_cast<float*>(ws),
                    static_cast<int*>(counters), S, H, H_kv, P, max_pages, 0, P,
                    with_self ? acp::kCachePlusNew : acp::kClassic, n_split,
                    static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, d, a);
}

// The state form: this rank's P rows of every page sit at within-page
// offset pos_base of pages holding global_page_size tokens; writes the f32
// unnormalized acc [S, H, d], m [S, H] and l [S, H]. ws, counters and
// n_split as above.
extern "C" int acp_paged_decode_state(const void* q, const void* k_pages, const void* v_pages,
                                      const void* block_tables, const void* seq_lens,
                                      void* acc, void* m, void* l, void* ws, void* counters,
                                      int S, int H, int H_kv, int d, int P, int max_pages,
                                      int pos_base, int global_page_size, int dtype,
                                      int n_split, void* stream) {
  if (!acp::valid_shape(S, H, H_kv, P, max_pages) ||
      !acp::valid_split(n_split, max_pages, ws, counters) ||
      !acp::valid_slice(P, pos_base, global_page_size))
    return static_cast<int>(cudaErrorInvalidValue);
  const acp::Args a{q, k_pages, v_pages, nullptr, nullptr,
                    static_cast<const int*>(block_tables), static_cast<const int*>(seq_lens),
                    nullptr, nullptr, nullptr, static_cast<float*>(acc), static_cast<float*>(m),
                    static_cast<float*>(l), static_cast<float*>(ws), static_cast<int*>(counters),
                    S, H, H_kv, P, max_pages, pos_base, global_page_size, acp::kState,
                    n_split, static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, d, a);
}
