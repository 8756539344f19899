// Paged decode attention for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU Pallas kernel agentcontrolplane_tpu/ops/pallas/
// paged_attention.py (_kernel/_paged_state, :56-275, through the single
// pl.pallas_call at :265) in both of its forms:
//   with_self = 1: paged_decode_attention_cache_plus_new + _fold_self_term
//                  (:298-345) — the walk over the read-only pages, then one
//                  more online-softmax fold of the unwritten token's
//                  k_new/v_new; seq_lens EXCLUDE the new token.
//   with_self = 0: paged_decode_attention (:278-295) — the walk, normalized
//                  as acc / max(l, 1e-30); seq_lens INCLUDE the token.
//
// What bounds it: bytes. A call reads every valid K/V row of every slot
// once (rows x H_kv x d x 2 x dtype bytes) and the arithmetic is 4 f32
// flops per element of each row on the CUDA cores, far below the card's
// ratio of flops to bytes; chip_smoke.py prints the bound beside the
// measured time. At 8 slots the grid (S x H_kv = 64 blocks) under-fills the
// card's 132 SMs and each block walks its slot's rows one step at a time,
// so this simple version is latency-bound; splitting the walk along pages
// is later work.
//
// Design (right and simple first, not a block-by-block copy of Pallas):
// - grid (S, H_kv): one block per (slot, KV head), 8 warps. The block loads
//   the n_rep = H / H_kv query rows of its GQA group once, pre-scaled by
//   1/sqrt(d) in f32, and never repeats K/V per query head.
// - A warp is cut into groups of LANES lanes that each own one token row:
//   LANES * 16 bytes covers the row, so every load is a 16-byte vector and a
//   group reads its row contiguously (a row is d elements at stride H_kv*d).
//   A group issues kRows rows' loads before using any, to keep more bytes
//   in flight in a walk that is otherwise one memory latency per row.
// - The block walks only ceil(seq_len / P) pages of its own block-table row
//   (clamped to max_pages). Each group keeps its own f32 online-softmax state
//   (m, l, acc); the n_rep dot products reduce with warp shuffles inside the
//   group. Positions >= seq_len inside the walked pages are masked to -1e30
//   exactly as the reference does.
// - Groups merge by shuffles, warps through shared memory, with the same
//   max/sum algebra; warp 0 runs the epilogue and writes in q's dtype.
// - No atomics: results are deterministic run to run.
// - seq_len == 0 walks nothing: mode 1 returns v_new, mode 0 zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 8;  // a power of two (the warp merge halves it)
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 4;  // token rows in flight per lane group per step

template <typename T>
struct VecWidth;
template <>
struct VecWidth<float> {
  static constexpr int N = 4;  // 16 bytes
};
template <>
struct VecWidth<__nv_bfloat16> {
  static constexpr int N = 8;  // 16 bytes
};

__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __bfloat162float(h[i].x);
    out[2 * i + 1] = __bfloat162float(h[i].y);
  }
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int D, int NREP>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q,             // [S, H, D]
                    const T* __restrict__ k_pages,       // [NP, P, H_kv, D]
                    const T* __restrict__ v_pages,       // [NP, P, H_kv, D]
                    const int* __restrict__ block_tables,  // [S, max_pages]
                    const int* __restrict__ seq_lens,      // [S]
                    const T* __restrict__ k_new,         // [S, H_kv, D] or null
                    const T* __restrict__ v_new,         // [S, H_kv, D] or null
                    T* __restrict__ out,                 // [S, H, D]
                    int H, int H_kv, int P, int max_pages, int n_rep,
                    int with_self) {
  constexpr int VEC = VecWidth<T>::N;
  constexpr int LANES = (D / VEC) < 32 ? (D / VEC) : 32;  // lanes per row
  constexpr int VPL = D / (VEC * LANES);                  // vectors per lane
  constexpr int EPL = VEC * VPL;                          // elements per lane
  constexpr int GPW = 32 / LANES;                         // groups per warp
  constexpr int NG = kWarps * GPW;                        // groups per block

  const int s = blockIdx.x;
  const int kv = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gl = lane % LANES;                // lane within its group
  const int gid = warp * GPW + lane / LANES;  // group within the block
  const float scale = 1.0f / sqrtf(static_cast<float>(D));

  // element e of this lane's slice sits at column col(e) of the row
  auto col = [&](int vv, int j) { return (vv * LANES + gl) * VEC + j; };

  // the GQA group's query rows, pre-scaled (rows >= n_rep stay zero)
  float qr[NREP][EPL];
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    if (r < n_rep) {
      const T* qrow = q + (static_cast<int64_t>(s) * H + kv * n_rep + r) * D;
#pragma unroll
      for (int vv = 0; vv < VPL; ++vv) load16(qrow + col(vv, 0), &qr[r][vv * VEC]);
#pragma unroll
      for (int e = 0; e < EPL; ++e) qr[r][e] *= scale;
    } else {
#pragma unroll
      for (int e = 0; e < EPL; ++e) qr[r][e] = 0.0f;
    }
  }

  float m[NREP], l[NREP], acc[NREP][EPL];
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[r][e] = 0.0f;
  }

  const int seq_len = seq_lens[s];
  int n_pages = (seq_len + P - 1) / P;
  if (n_pages > max_pages) n_pages = max_pages;
  if (n_pages < 0) n_pages = 0;
  const int n_rows = n_pages * P;
  const int* table = block_tables + static_cast<int64_t>(s) * max_pages;
  const int64_t row_stride = static_cast<int64_t>(H_kv) * D;

  // Each step a group loads kRows rows' K and V (all loads issued before
  // any use, so kRows row fetches are in flight at once) and folds them
  // into (m, l, acc) with one rescale. The page ids of the next step are
  // read while this step's rows land, so the walk pays one memory latency
  // per step, not two. The trip count is uniform for every lane of the
  // block: shuffles need the whole warp, so a group past the end idles.
  constexpr int kStep = NG * kRows;
  int page_of[kRows];
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    const int t = u * NG + gid;
    page_of[u] = t < n_rows ? table[t / P] : 0;
  }
  for (int base = 0; base < n_rows; base += kStep) {
    float kr[kRows][EPL], vr[kRows][EPL];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int t = base + u * NG + gid;
      if (t < n_rows) {
        const int64_t off = (static_cast<int64_t>(page_of[u]) * P + (t % P)) * row_stride +
                            static_cast<int64_t>(kv) * D;
#pragma unroll
        for (int vv = 0; vv < VPL; ++vv) {
          load16(k_pages + off + col(vv, 0), &kr[u][vv * VEC]);
          load16(v_pages + off + col(vv, 0), &vr[u][vv * VEC]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) kr[u][e] = vr[u][e] = 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int t = base + kStep + u * NG + gid;
      page_of[u] = t < n_rows ? table[t / P] : 0;
    }
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      float logit[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        float dot = 0.0f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) dot = fmaf(qr[r][e], kr[u][e], dot);
#pragma unroll
        for (int o = LANES / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
        logit[u] = base + u * NG + gid < seq_len ? dot : kNegInf;
      }
      float m_new = m[r];
#pragma unroll
      for (int u = 0; u < kRows; ++u)
        if (base + u * NG + gid < n_rows) m_new = fmaxf(m_new, logit[u]);
      const float corr = expf(m[r] - m_new);
      float p[kRows];
      float p_sum = 0.0f;
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        p[u] = base + u * NG + gid < n_rows ? expf(logit[u] - m_new) : 0.0f;
        p_sum += p[u];
      }
      l[r] = l[r] * corr + p_sum;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        float a = acc[r][e] * corr;
#pragma unroll
        for (int u = 0; u < kRows; ++u) a = fmaf(p[u], vr[u][e], a);
        acc[r][e] = a;
      }
      m[r] = m_new;
    }
  }

  // merge the groups of this warp (lanes at the same gl hold the same
  // columns); afterwards every lane holds its warp's state for its columns
#pragma unroll
  for (int o = LANES; o < 32; o <<= 1) {
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m[r], o);
      const float l_o = __shfl_xor_sync(0xffffffffu, l[r], o);
      const float m_new = fmaxf(m[r], m_o);
      const float a = expf(m[r] - m_new);
      const float b = expf(m_o - m_new);
      l[r] = l[r] * a + l_o * b;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const float acc_o = __shfl_xor_sync(0xffffffffu, acc[r][e], o);
        acc[r][e] = acc[r][e] * a + acc_o * b;
      }
      m[r] = m_new;
    }
  }

  // merge the warps into warp 0 by halving rounds through shared memory
  // (half the warps write, the other half fold), so the staging buffer
  // holds kWarps/2 states: 32 KB at d=256 with a group of 8
  __shared__ float sm_m[kWarps / 2][NREP];
  __shared__ float sm_l[kWarps / 2][NREP];
  __shared__ float sm_acc[kWarps / 2][NREP][D];
#pragma unroll
  for (int half = kWarps / 2; half >= 1; half /= 2) {
    if (warp >= half && warp < 2 * half && lane < LANES) {
      const int w = warp - half;
#pragma unroll
      for (int r = 0; r < NREP; ++r) {
        sm_m[w][r] = m[r];
        sm_l[w][r] = l[r];
#pragma unroll
        for (int vv = 0; vv < VPL; ++vv)
#pragma unroll
          for (int j = 0; j < VEC; ++j) sm_acc[w][r][col(vv, j)] = acc[r][vv * VEC + j];
      }
    }
    __syncthreads();
    if (warp < half) {
#pragma unroll
      for (int r = 0; r < NREP; ++r) {
        const float m_o = sm_m[warp][r];
        const float l_o = sm_l[warp][r];
        const float m_new = fmaxf(m[r], m_o);
        const float a = expf(m[r] - m_new);
        const float b = expf(m_o - m_new);
        l[r] = l[r] * a + l_o * b;
#pragma unroll
        for (int vv = 0; vv < VPL; ++vv)
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const int e = vv * VEC + j;
            acc[r][e] = acc[r][e] * a + sm_acc[warp][r][col(vv, j)] * b;
          }
        m[r] = m_new;
      }
    }
    __syncthreads();
  }
  if (warp != 0) return;

  // epilogue: optional self-term fold, normalization, store in q's dtype
  float kn[EPL], vn[EPL];
  if (with_self) {
    const int64_t nrow = (static_cast<int64_t>(s) * H_kv + kv) * D;
#pragma unroll
    for (int vv = 0; vv < VPL; ++vv) {
      load16(k_new + nrow + col(vv, 0), &kn[vv * VEC]);
      load16(v_new + nrow + col(vv, 0), &vn[vv * VEC]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < EPL; ++e) kn[e] = vn[e] = 0.0f;
  }
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    float o_scale = 1.0f;
    float p_self = 0.0f;
    if (with_self) {
      float self_logit = 0.0f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) self_logit = fmaf(qr[r][e], kn[e], self_logit);
#pragma unroll
      for (int o = LANES / 2; o > 0; o >>= 1)
        self_logit += __shfl_xor_sync(0xffffffffu, self_logit, o);
      const float m2 = fmaxf(m[r], self_logit);
      const float corr = expf(m[r] - m2);
      p_self = expf(self_logit - m2);
      const float l2 = l[r] * corr + p_self;
      o_scale = corr;
      l[r] = l2;
    }
    const float inv = 1.0f / fmaxf(l[r], 1e-30f);
    if (lane < LANES && r < n_rep) {
      T* orow = out + (static_cast<int64_t>(s) * H + kv * n_rep + r) * D;
#pragma unroll
      for (int vv = 0; vv < VPL; ++vv)
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const int e = vv * VEC + j;
          const float num = with_self ? acc[r][e] * o_scale + p_self * vn[e] : acc[r][e];
          store1(orow + col(vv, j), num * inv);
        }
    }
  }
}

template <typename T, int D, int NREP>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const int* block_tables, const int* seq_lens, const void* k_new,
                   const void* v_new, void* out, int S, int H, int H_kv, int P,
                   int max_pages, int with_self, cudaStream_t stream) {
  const dim3 grid(S, H_kv);
  paged_decode_kernel<T, D, NREP><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), block_tables, seq_lens,
      static_cast<const T*>(k_new), static_cast<const T*>(v_new), static_cast<T*>(out),
      H, H_kv, P, max_pages, H / H_kv, with_self);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_rep(int n_rep, const void* q, const void* k_pages,
                         const void* v_pages, const int* block_tables,
                         const int* seq_lens, const void* k_new, const void* v_new,
                         void* out, int S, int H, int H_kv, int P, int max_pages,
                         int with_self, cudaStream_t stream) {
#define ACP_REP(NR)                                                                  \
  return launch<T, D, NR>(q, k_pages, v_pages, block_tables, seq_lens, k_new, v_new, \
                          out, S, H, H_kv, P, max_pages, with_self, stream)
  if (n_rep <= 1) ACP_REP(1);
  if (n_rep <= 2) ACP_REP(2);
  if (n_rep <= 4) ACP_REP(4);
  if (n_rep <= 8) ACP_REP(8);
#undef ACP_REP
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_d(int d, int n_rep, const void* q, const void* k_pages,
                       const void* v_pages, const int* block_tables, const int* seq_lens,
                       const void* k_new, const void* v_new, void* out, int S, int H,
                       int H_kv, int P, int max_pages, int with_self,
                       cudaStream_t stream) {
#define ACP_D(DD)                                                                  \
  return dispatch_rep<T, DD>(n_rep, q, k_pages, v_pages, block_tables, seq_lens, \
                             k_new, v_new, out, S, H, H_kv, P, max_pages,       \
                             with_self, stream)
  switch (d) {
    case 16: ACP_D(16);
    case 32: ACP_D(32);
    case 64: ACP_D(64);
    case 128: ACP_D(128);
    case 256: ACP_D(256);
    default: break;
  }
#undef ACP_D
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry for ctypes. dtype: 0 = float32, 1 = bfloat16. k_new/v_new
// may be null when with_self == 0. Launches on `stream` and returns
// cudaGetLastError() (0 = launched); the caller raises on anything else.
extern "C" int acp_paged_decode_attention(const void* q, const void* k_pages,
                                          const void* v_pages, const void* block_tables,
                                          const void* seq_lens, const void* k_new,
                                          const void* v_new, void* out, int S, int H,
                                          int H_kv, int d, int P, int max_pages,
                                          int dtype, int with_self, void* stream) {
  if (S <= 0 || H_kv <= 0 || H % H_kv != 0 || H / H_kv > 8 || P <= 0 || max_pages <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_rep = H / H_kv;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tables = static_cast<const int*>(block_tables);
  const int* lens = static_cast<const int*>(seq_lens);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_d<float>(d, n_rep, q, k_pages, v_pages, tables, lens, k_new, v_new, out,
                            S, H, H_kv, P, max_pages, with_self, st);
  } else if (dtype == 1) {
    err = dispatch_d<__nv_bfloat16>(d, n_rep, q, k_pages, v_pages, tables, lens, k_new,
                                    v_new, out, S, H, H_kv, P, max_pages, with_self, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
