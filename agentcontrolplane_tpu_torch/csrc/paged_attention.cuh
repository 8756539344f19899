// Paged decode attention for Hopper (sm_90a), hand-written CUDA C++: the
// kernel template shared by the two libraries built from it,
//   paged_attention.cu       — the f32/bf16 walk (pages in q's dtype),
//   paged_attention_int8.cu  — the int8 walk (int8 pages + f32 scales).
// Each .cu is compiled by its own nvcc process, so the two build at once.
//
// Replaces the TPU Pallas kernel agentcontrolplane_tpu/ops/pallas/
// paged_attention.py (_kernel/_paged_state, :56-275, through the single
// pl.pallas_call at :265) in its three epilogue forms (`mode`):
//   kCachePlusNew (1): paged_decode_attention_cache_plus_new +
//                  _fold_self_term (:298-345) — the walk over the read-only
//                  pages, then one more online-softmax fold of the unwritten
//                  token's k_new/v_new; seq_lens EXCLUDE the new token.
//   kClassic (0):  paged_decode_attention (:278-295) — the walk, normalized
//                  as acc / max(l, 1e-30); seq_lens INCLUDE the token.
//   kState (2):    _paged_state itself (:189-275) as the context-parallel
//                  wrapper runs it (:399-460): the walk over this rank's
//                  [P_local] rows of every page, whose local row r of page
//                  j sits at global position j * global_page_size +
//                  pos_base + r (:94-98, :164-166), written UNNORMALIZED as
//                  f32 acc [S, H, d], m [S, H], l [S, H] for the sp ranks to
//                  merge. A rank that holds no valid row of a lane writes
//                  m = -1e30 (the reference's NEG_INF, never -inf, so the
//                  merge's exp(m - max m) stays finite), l = 0 and acc = 0.
// and in both of its page types: KV = T (quantized=False) or KV = int8_t
// (quantized=True, :82-93, :116-126, :153-158, operands :240-253), where
// each row also carries one f32 scale per KV head in [NP, P, H_kv] twins.
//
// What bounds it: bytes. A call reads every valid K/V row of every slot
// once (rows x H_kv x d x 2 x sizeof(KV), plus rows x H_kv x 2 x 4 bytes of
// scales for int8) and the arithmetic is about 4 f32 flops per element of
// each row on the CUDA cores, far below the card's ratio of flops to bytes;
// chip_smoke.py prints the bound beside the measured time. At 8 slots the
// grid (S x H_kv = 64 blocks) under-fills the card's 132 SMs and each block
// walks its slot's rows one step at a time, so this simple version is
// latency-bound; splitting the walk along pages is later work.
//
// Design (right and simple first, not a block-by-block copy of Pallas):
// - grid (S, H_kv): one block per (slot, KV head), 8 warps. The block loads
//   the n_rep = H / H_kv query rows of its GQA group once, pre-scaled by
//   1/sqrt(d) in f32, and never repeats K/V per query head.
// - A warp is cut into groups of LANES lanes that each own one token row.
//   A lane owns VEC = 16 / sizeof(T) columns per vector (col() below), so q,
//   k_new, v_new and out move as 16-byte vectors. Pages of type T use the
//   same 16-byte loads; int8 pages give a lane the SAME columns, read as a
//   VEC-byte load (8 bytes, a uint2, at bf16; 4 at f32), which keeps the
//   bf16 walk's column mapping and register footprint (a 16-byte int8 load
//   would double the elements per lane and spill at a group of 8).
//   A group issues kRows rows' loads (with their scales) before using any,
//   to keep more bytes in flight in a walk that is otherwise one memory
//   latency per row.
// - int8 dequantization is per element, value * scale in f32 — exactly
//   ops/quant.py::kv_dequantize, as the Pallas kernel does it in VMEM — not
//   folded into the dot product and p (which would round differently).
// - The block walks only ceil(seq_len / P) pages of its own block-table row
//   (clamped to max_pages). Rows at or past seq_len inside the last walked
//   page are never loaded: their values and scales may be stale junk (the
//   trash page's and a freed page's rows), so they enter as exact zeros
//   with p = 0 and -1e30 logits, and cannot reach the output however large
//   the junk is. Each group keeps its own f32 online-softmax state (m, l,
//   acc); the n_rep dot products reduce with warp shuffles inside the group.
// - Groups merge by shuffles, warps through shared memory, with the same
//   max/sum algebra; warp 0 runs the epilogue and writes in q's dtype.
// - No atomics: results are deterministic run to run.
// - seq_len == 0 walks nothing: mode 1 returns v_new, mode 0 zeros, mode 2
//   the empty state.
// - Context parallelism changes only which rows are valid: with
//   G = global_page_size (= P unless the pool holds a slice of each page)
//   the walk covers ceil(seq_len / G) pages, every local row of all but the
//   last is valid, and the last page's first
//   clamp(seq_len - (n_pages - 1) * G - pos_base, 0, P) rows are. So the
//   valid rows stay a prefix of the walk's row order, and the loop below is
//   the same for every form.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace acp {

constexpr float kNegInf = -1e30f;
constexpr int kClassic = 0;
constexpr int kCachePlusNew = 1;
constexpr int kState = 2;
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

// Load N consecutive elements of type E as floats (one vector load).
template <typename E, int N>
struct Vec;

template <>
struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
};

template <>
struct Vec<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* out) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = __bfloat162float(h[i].x);
      out[2 * i + 1] = __bfloat162float(h[i].y);
    }
  }
};

template <>
struct Vec<int8_t, 8> {  // 8 bytes: the int8 twin of a bf16 lane's 8 columns
  static __device__ __forceinline__ void load(const int8_t* p, float* out) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    const char4* c = reinterpret_cast<const char4*>(&v);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      out[4 * i] = static_cast<float>(c[i].x);
      out[4 * i + 1] = static_cast<float>(c[i].y);
      out[4 * i + 2] = static_cast<float>(c[i].z);
      out[4 * i + 3] = static_cast<float>(c[i].w);
    }
  }
};

template <>
struct Vec<int8_t, 4> {  // 4 bytes: the int8 twin of an f32 lane's 4 columns
  static __device__ __forceinline__ void load(const int8_t* p, float* out) {
    const char4 c = *reinterpret_cast<const char4*>(p);
    out[0] = static_cast<float>(c.x);
    out[1] = static_cast<float>(c.y);
    out[2] = static_cast<float>(c.z);
    out[3] = static_cast<float>(c.w);
  }
};

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// T: q, k_new, v_new and out (float or bf16). KV: the pages (T or int8_t);
// k_scales/v_scales are read only when KV is int8_t.
template <typename T, typename KV, int D, int NREP>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q,               // [S, H, D]
                    const KV* __restrict__ k_pages,        // [NP, P, H_kv, D]
                    const KV* __restrict__ v_pages,        // [NP, P, H_kv, D]
                    const float* __restrict__ k_scales,    // [NP, P, H_kv] (int8)
                    const float* __restrict__ v_scales,    // [NP, P, H_kv] (int8)
                    const int* __restrict__ block_tables,  // [S, max_pages]
                    const int* __restrict__ seq_lens,      // [S]
                    const T* __restrict__ k_new,           // [S, H_kv, D] or null
                    const T* __restrict__ v_new,           // [S, H_kv, D] or null
                    T* __restrict__ out,                   // [S, H, D] (modes 0, 1)
                    float* __restrict__ acc_out,           // [S, H, D] (mode 2)
                    float* __restrict__ m_out,             // [S, H] (mode 2)
                    float* __restrict__ l_out,             // [S, H] (mode 2)
                    int H, int H_kv, int P, int max_pages, int n_rep,
                    int pos_base, int global_page_size, int mode) {
  constexpr bool kInt8 = std::is_same<KV, int8_t>::value;
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
      for (int vv = 0; vv < VPL; ++vv) Vec<T, VEC>::load(qrow + col(vv, 0), &qr[r][vv * VEC]);
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

  // rows at or past seq_len (the masked tail of the last page, and every
  // row of a page slice that starts past it) are never loaded
  const int seq_len = seq_lens[s];
  const int G = global_page_size;
  const int n_pages = seq_len > 0 ? (seq_len + G - 1) / G : 0;
  int n_valid;
  if (n_pages == 0) {
    n_valid = 0;
  } else if (n_pages > max_pages) {
    n_valid = max_pages * P;  // every row of the walked pages precedes seq_len
  } else {
    int rem = seq_len - (n_pages - 1) * G - pos_base;
    rem = rem < 0 ? 0 : (rem > P ? P : rem);
    n_valid = (n_pages - 1) * P + rem;
  }
  const int* table = block_tables + static_cast<int64_t>(s) * max_pages;
  const int64_t row_stride = static_cast<int64_t>(H_kv) * D;

  // Each step a group loads kRows rows' K and V (and, for int8, their two
  // scales; all loads issued before any use, so kRows row fetches are in
  // flight at once) and folds them into (m, l, acc) with one rescale. The
  // page ids of the next step are read while this step's rows land, so the
  // walk pays one memory latency per step, not two. The trip count is
  // uniform for every lane of the block: shuffles need the whole warp, so a
  // group past the end idles.
  constexpr int kStep = NG * kRows;
  int page_of[kRows];
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    const int t = u * NG + gid;
    page_of[u] = t < n_valid ? table[t / P] : 0;
  }
  for (int base = 0; base < n_valid; base += kStep) {
    float kr[kRows][EPL], vr[kRows][EPL];
    float ksr[kRows], vsr[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int t = base + u * NG + gid;
      if (t < n_valid) {
        const int64_t prow = static_cast<int64_t>(page_of[u]) * P + (t % P);
        const int64_t off = prow * row_stride + static_cast<int64_t>(kv) * D;
        if constexpr (kInt8) {
          ksr[u] = k_scales[prow * H_kv + kv];
          vsr[u] = v_scales[prow * H_kv + kv];
        }
#pragma unroll
        for (int vv = 0; vv < VPL; ++vv) {
          Vec<KV, VEC>::load(k_pages + off + col(vv, 0), &kr[u][vv * VEC]);
          Vec<KV, VEC>::load(v_pages + off + col(vv, 0), &vr[u][vv * VEC]);
        }
      } else {
        ksr[u] = vsr[u] = 0.0f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) kr[u][e] = vr[u][e] = 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int t = base + kStep + u * NG + gid;
      page_of[u] = t < n_valid ? table[t / P] : 0;
    }
    if constexpr (kInt8) {
#pragma unroll
      for (int u = 0; u < kRows; ++u)
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          kr[u][e] *= ksr[u];
          vr[u][e] *= vsr[u];
        }
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
        logit[u] = base + u * NG + gid < n_valid ? dot : kNegInf;
      }
      float m_new = m[r];
#pragma unroll
      for (int u = 0; u < kRows; ++u) m_new = fmaxf(m_new, logit[u]);
      const float corr = expf(m[r] - m_new);
      float p[kRows];
      float p_sum = 0.0f;
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        p[u] = base + u * NG + gid < n_valid ? expf(logit[u] - m_new) : 0.0f;
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

  if (mode == kState) {
    // the unnormalized state, in f32, for the sp ranks' merge
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      if (r >= n_rep) continue;
      const int64_t h = static_cast<int64_t>(s) * H + kv * n_rep + r;
      if (lane < LANES) {
        float* arow = acc_out + h * D;
#pragma unroll
        for (int vv = 0; vv < VPL; ++vv)
#pragma unroll
          for (int j = 0; j < VEC; ++j) arow[col(vv, j)] = acc[r][vv * VEC + j];
      }
      if (lane == 0) {
        m_out[h] = m[r];
        l_out[h] = l[r];
      }
    }
    return;
  }

  // epilogue: optional self-term fold, normalization, store in q's dtype.
  // The new token's k/v are full precision (not yet written), so no scale
  // applies to them.
  const bool with_self = mode == kCachePlusNew;
  float kn[EPL], vn[EPL];
  if (with_self) {
    const int64_t nrow = (static_cast<int64_t>(s) * H_kv + kv) * D;
#pragma unroll
    for (int vv = 0; vv < VPL; ++vv) {
      Vec<T, VEC>::load(k_new + nrow + col(vv, 0), &kn[vv * VEC]);
      Vec<T, VEC>::load(v_new + nrow + col(vv, 0), &vn[vv * VEC]);
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

// The launch arguments, gathered so the dispatch below stays readable.
struct Args {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const float* k_scales;
  const float* v_scales;
  const int* block_tables;
  const int* seq_lens;
  const void* k_new;
  const void* v_new;
  void* out;       // modes 0, 1
  float* acc_out;  // mode 2
  float* m_out;
  float* l_out;
  int S, H, H_kv, P, max_pages;
  int pos_base, global_page_size, mode;
  cudaStream_t stream;
};

template <typename T, typename KV, int D, int NREP>
cudaError_t launch(const Args& a) {
  const dim3 grid(a.S, a.H_kv);
  paged_decode_kernel<T, KV, D, NREP><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const KV*>(a.k_pages),
      static_cast<const KV*>(a.v_pages), a.k_scales, a.v_scales, a.block_tables, a.seq_lens,
      static_cast<const T*>(a.k_new), static_cast<const T*>(a.v_new), static_cast<T*>(a.out),
      a.acc_out, a.m_out, a.l_out, a.H, a.H_kv, a.P, a.max_pages, a.H / a.H_kv, a.pos_base,
      a.global_page_size, a.mode);
  return cudaGetLastError();
}

template <typename T, typename KV, int D>
cudaError_t dispatch_rep(const Args& a) {
  const int n_rep = a.H / a.H_kv;
  if (n_rep <= 1) return launch<T, KV, D, 1>(a);
  if (n_rep <= 2) return launch<T, KV, D, 2>(a);
  if (n_rep <= 4) return launch<T, KV, D, 4>(a);
  if (n_rep <= 8) return launch<T, KV, D, 8>(a);
  return cudaErrorInvalidValue;
}

template <typename T, typename KV>
cudaError_t dispatch_d(int d, const Args& a) {
  switch (d) {
    case 16: return dispatch_rep<T, KV, 16>(a);
    case 32: return dispatch_rep<T, KV, 32>(a);
    case 64: return dispatch_rep<T, KV, 64>(a);
    case 128: return dispatch_rep<T, KV, 128>(a);
    case 256: return dispatch_rep<T, KV, 256>(a);
    default: return cudaErrorInvalidValue;
  }
}

// Shape checks shared by the C entry points.
inline bool valid_shape(int S, int H, int H_kv, int P, int max_pages) {
  return S > 0 && H_kv > 0 && H % H_kv == 0 && H / H_kv <= 8 && P > 0 && max_pages > 0;
}

// The state form's slice: pos_base + P rows must fit in one global page.
inline bool valid_slice(int P, int pos_base, int global_page_size) {
  return pos_base >= 0 && global_page_size >= P && pos_base + P <= global_page_size;
}

}  // namespace acp
