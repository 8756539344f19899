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
// each row on the CUDA cores, below the card's ratio of flops to bytes;
// chip_smoke.py prints the bound beside the measured time. The walk of one
// (slot, KV head) is up to 2048 rows; walked by one block, one step after
// another, it is latency-bound with too few blocks to fill 132 SMs. So:
//
// Design (split-KV, one launch; right and simple first, not a block-by-
// block copy of Pallas, whose grid runs in order on one core):
// - grid (S, H_kv, n_split): block z walks the fixed run of table columns
//   [z * pps, min((z + 1) * pps, max_pages)), pps = ceil(max_pages /
//   n_split). The wrapper picks n_split from shapes only (max_pages, rows
//   per page, S x H_kv and the SM count: about two waves of blocks, at
//   least 128 rows a split), never from seq_lens, so it never reads the
//   lengths on the host and stays capturable in a CUDA graph. A block whose
//   run starts at or past its lane's valid rows loads nothing and leaves at
//   once: only the n_live splits that hold valid rows take part (an empty
//   state would add exactly nothing to the merge), and a lane with no valid
//   row is answered by block 0 alone.
// - 8 warps. The block loads the n_rep = H / H_kv query rows of its GQA
//   group once, pre-scaled by 1/sqrt(d) in f32, and never repeats K/V per
//   query head.
// - Loads overlap the math: a ring of kStages tiles in dynamic shared
//   memory, each the K and V rows (and, int8, their f32 scales) of ROWS
//   consecutive walk rows of this KV head, filled with 16-byte
//   cp.async.cg copies (4-byte cp.async.ca for scales) and waited on with
//   cp.async.wait_group, so tiles i+1 and i+2 are in flight while tile i is
//   consumed. The block reads its own table entries; a tile may span pages
//   (or a page several tiles), so any page size works.
// - A warp is cut into groups of LANES lanes; a group takes RPG rows of
//   each tile. A lane owns VEC = 16 / sizeof(T) columns per vector (col()
//   below), so q, k_new, v_new and out move as 16-byte vectors; int8 rows
//   give a lane the SAME columns as a VEC-byte read of shared memory. Each
//   group keeps its own f32 online-softmax state (m, l, acc) and rescales
//   once per tile; the n_rep dot products reduce with warp shuffles inside
//   the group. K/V live in shared memory, so a lane holds only q, acc and
//   one row at a time in registers.
// - int8 dequantization is per element, value * scale in f32 — exactly
//   ops/quant.py::kv_dequantize, as the Pallas kernel does it in VMEM — not
//   folded into the dot product and p (which would round differently).
// - Rows at or past seq_len (the masked tail of the last walked page, and
//   every row of a page slice past it) are never loaded, in any split:
//   their values and scales may be stale junk (the trash page's and a
//   freed page's rows), so they enter as exact zeros with p = 0 and -1e30
//   logits, and cannot reach the output however large the junk is.
// - Groups merge by shuffles, warps through shared memory (the ring's
//   space, reused), with the same max/sum algebra, into warp 0.
// - Splits merge in the same launch: with n_live > 1 each live block
//   writes its f32 (acc, m, l) to the wrapper's workspace, fences, and
//   takes a ticket with one atomicAdd on its (slot, KV head) counter. The
//   block that draws the last ticket merges every live split's partial IN
//   SPLIT ORDER with ops/paged.py::merge_sp_states' algebra (m_g = max m,
//   sums of l and acc scaled by exp(m - m_g)) — all its threads at once,
//   through shared memory, with the partials' loads batched so the merge
//   pays a few memory latencies, not one per split — runs the form's
//   epilogue and resets the counter to 0 for the next launch. The ticket
//   is the only atomic; the arithmetic has none, so two launches are
//   bitwise equal. A lane whose valid rows fall in one split (every short
//   context) goes straight to its epilogue: no workspace, no ticket, the
//   cost of an unsplit walk.
// - The kernel allocates nothing: workspace and counters (zeroed once,
//   left zeroed by every launch) come from the wrapper.
// - seq_len == 0 walks nothing: mode 1 returns v_new, mode 0 zeros, mode 2
//   the empty state.
// - Context parallelism changes only which rows are valid: with
//   G = global_page_size (= P unless the pool holds a slice of each page)
//   the walk covers ceil(seq_len / G) pages, every local row of all but the
//   last is valid, and the last page's first
//   clamp(seq_len - (n_pages - 1) * G - pos_base, 0, P) rows are. So the
//   valid rows stay a prefix of the walk's row order, and each split walks
//   the part of that prefix that falls in its columns, in every form.

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
constexpr int kStages = 3;          // tiles in the shared-memory ring
constexpr int kStageBytes = 32768;  // K and V bytes a tile aims at
constexpr int kMaxRowsPerGroup = 4;  // rows a lane group folds per tile
constexpr int kMaxSplits = 256;      // splits of one walk (the wrapper's MAX_SPLITS)

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

// Asynchronous copies from device memory into shared memory (sm_80+).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Compile-time geometry of one instantiation: the lanes' column mapping,
// the tile of rows a ring stage holds, and the shared memory it takes.
template <typename T, typename KV, int D>
struct Layout {
  static constexpr bool kInt8 = std::is_same<KV, int8_t>::value;
  static constexpr int VEC = VecWidth<T>::N;
  static constexpr int LANES = (D / VEC) < 32 ? (D / VEC) : 32;  // lanes per row
  static constexpr int VPL = D / (VEC * LANES);                  // vectors per lane
  static constexpr int EPL = VEC * VPL;                          // elements per lane
  static constexpr int GPW = 32 / LANES;                         // groups per warp
  static constexpr int NG = kWarps * GPW;                        // groups per block
  static constexpr int ROW_BYTES = D * static_cast<int>(sizeof(KV));
  static constexpr int RPG_FIT = kStageBytes / (2 * ROW_BYTES * NG);
  static constexpr int RPG = RPG_FIT < 1 ? 1 : (RPG_FIT > kMaxRowsPerGroup ? kMaxRowsPerGroup
                                                                           : RPG_FIT);
  static constexpr int ROWS = NG * RPG;  // rows per tile
  static constexpr int CHUNKS = ROW_BYTES / 16;  // 16-byte copies per row
  static constexpr int KV_BYTES = ROWS * ROW_BYTES;
  static constexpr int STAGE_BYTES = 2 * KV_BYTES + (kInt8 ? 2 * ROWS * 4 : 0);
  static constexpr int PIPE_BYTES = kStages * STAGE_BYTES;
  static_assert(ROW_BYTES % 16 == 0, "a K/V row must be whole 16-byte copies");
  static_assert(STAGE_BYTES % 16 == 0, "ring stages must stay 16-byte aligned");

  // the largest of the ring, the warp merge's staging (kWarps/2 states of
  // NREP rows) and the split merge's (m, l, corr of up to kMaxSplits
  // splits, the merged m, l and acc)
  template <int NREP>
  static constexpr int smem_bytes() {
    constexpr int warps = (kWarps / 2) * NREP * (D + 2) * 4;
    constexpr int splits = (3 * kMaxSplits * NREP + 2 * NREP + 3 + NREP * D) * 4;
    constexpr int merge = warps > splits ? warps : splits;
    return PIPE_BYTES > merge ? PIPE_BYTES : merge;
  }
};

// T: q, k_new, v_new and out (float or bf16). KV: the pages (T or int8_t);
// k_scales/v_scales are read only when KV is int8_t. ws/counters are used
// only when a lane's valid rows span more than one split.
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
                    float* __restrict__ ws,   // acc [S*H_kv][n_split][n_rep][D], then
                                              // (m, l) [S*H_kv][n_split][2][n_rep]
                    int* __restrict__ counters,            // [S * H_kv], zero
                    int H, int H_kv, int P, int max_pages, int n_rep,
                    int pos_base, int global_page_size, int mode, int n_split) {
  using L = Layout<T, KV, D>;
  constexpr int VEC = L::VEC;
  constexpr int LANES = L::LANES;
  constexpr int VPL = L::VPL;
  constexpr int EPL = L::EPL;
  constexpr int GPW = L::GPW;
  constexpr int NG = L::NG;
  constexpr int RPG = L::RPG;
  constexpr int ROWS = L::ROWS;
  extern __shared__ __align__(16) unsigned char smem[];

  const int s = blockIdx.x;
  const int kv = blockIdx.y;
  const int z = blockIdx.z;
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

  // the lane's valid rows are a prefix [0, n_valid) of its walk order
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
  // this split's part of it: the rows of table columns [z*pps, (z+1)*pps)
  const int pps = (max_pages + n_split - 1) / n_split;
  const int64_t split_rows = static_cast<int64_t>(pps) * P;
  // Splits past the valid rows hold nothing: their blocks leave at once and
  // take no part in the merge (an empty state would add exactly nothing to
  // it). A lane with no valid row is answered by block 0 alone.
  const int n_live = n_valid == 0 ? 1 : static_cast<int>((n_valid + split_rows - 1) / split_rows);
  if (z >= n_live) return;
  const int row_begin = static_cast<int>(z * split_rows);
  const int64_t last = row_begin + split_rows;
  const int row_end = last < n_valid ? static_cast<int>(last) : n_valid;

  const int n_rows = row_end - row_begin;
  const int n_tiles = (n_rows + ROWS - 1) / ROWS;  // the same for the whole block
  const int* table = block_tables + static_cast<int64_t>(s) * max_pages;
  const int64_t row_stride = static_cast<int64_t>(H_kv) * D;

  // Fill ring stage (tile % kStages) with tile `tile`'s valid rows; always
  // commits a group (empty past the last tile) so the wait count is fixed.
  auto fill = [&](int tile) {
    if (tile < n_tiles) {
      const int base = row_begin + tile * ROWS;
      const int rows = min(ROWS, row_end - base);
      unsigned char* st = smem + (tile % kStages) * L::STAGE_BYTES;
      for (int c = threadIdx.x; c < rows * L::CHUNKS; c += kThreads) {
        const int row = c / L::CHUNKS;
        const int piece = c % L::CHUNKS;
        const int t = base + row;
        const int64_t prow = static_cast<int64_t>(table[t / P]) * P + (t % P);
        const int64_t off = (prow * row_stride + static_cast<int64_t>(kv) * D) *
                                static_cast<int64_t>(sizeof(KV)) + piece * 16;
        cp_async16(st + row * L::ROW_BYTES + piece * 16,
                   reinterpret_cast<const unsigned char*>(k_pages) + off);
        cp_async16(st + L::KV_BYTES + row * L::ROW_BYTES + piece * 16,
                   reinterpret_cast<const unsigned char*>(v_pages) + off);
      }
      if constexpr (L::kInt8) {
        float* sc = reinterpret_cast<float*>(st + 2 * L::KV_BYTES);
        for (int row = threadIdx.x; row < rows; row += kThreads) {
          const int t = base + row;
          const int64_t prow = static_cast<int64_t>(table[t / P]) * P + (t % P);
          cp_async4(sc + row, k_scales + prow * H_kv + kv);
          cp_async4(sc + ROWS + row, v_scales + prow * H_kv + kv);
        }
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) fill(i);
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile i landed
    __syncthreads();  // everyone's copies landed; everyone is done with tile i-1
    fill(i + kStages - 1);  // into tile i-1's stage
    const unsigned char* st = smem + (i % kStages) * L::STAGE_BYTES;
    const KV* sk = reinterpret_cast<const KV*>(st);
    const KV* sv = reinterpret_cast<const KV*>(st + L::KV_BYTES);
    const float* sks = reinterpret_cast<const float*>(st + 2 * L::KV_BYTES);
    const int tile_rows = min(ROWS, n_rows - i * ROWS);

    // logits of this group's RPG rows, then one rescale, then the values
    bool ok[RPG];
    float p[NREP][RPG];
#pragma unroll
    for (int u = 0; u < RPG; ++u) {
      const int row = u * NG + gid;
      ok[u] = row < tile_rows;
      float kr[EPL];
      if (ok[u]) {
#pragma unroll
        for (int vv = 0; vv < VPL; ++vv)
          Vec<KV, VEC>::load(sk + row * D + col(vv, 0), &kr[vv * VEC]);
        if constexpr (L::kInt8) {
          const float ks = sks[row];
#pragma unroll
          for (int e = 0; e < EPL; ++e) kr[e] *= ks;
        }
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) kr[e] = 0.0f;
      }
#pragma unroll
      for (int r = 0; r < NREP; ++r) {
        float dot = 0.0f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) dot = fmaf(qr[r][e], kr[e], dot);
#pragma unroll
        for (int o = LANES / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
        p[r][u] = ok[u] ? dot : kNegInf;
      }
    }
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      float m_new = m[r];
#pragma unroll
      for (int u = 0; u < RPG; ++u) m_new = fmaxf(m_new, p[r][u]);
      const float corr = expf(m[r] - m_new);
      float p_sum = 0.0f;
#pragma unroll
      for (int u = 0; u < RPG; ++u) {
        p[r][u] = ok[u] ? expf(p[r][u] - m_new) : 0.0f;
        p_sum += p[r][u];
      }
      l[r] = l[r] * corr + p_sum;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[r][e] *= corr;
      m[r] = m_new;
    }
#pragma unroll
    for (int u = 0; u < RPG; ++u) {
      if (!ok[u]) continue;
      const int row = u * NG + gid;
      float vr[EPL];
#pragma unroll
      for (int vv = 0; vv < VPL; ++vv)
        Vec<KV, VEC>::load(sv + row * D + col(vv, 0), &vr[vv * VEC]);
      if constexpr (L::kInt8) {
        const float vs = sks[ROWS + row];
#pragma unroll
        for (int e = 0; e < EPL; ++e) vr[e] *= vs;
      }
#pragma unroll
      for (int r = 0; r < NREP; ++r)
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[r][e] = fmaf(p[r][u], vr[e], acc[r][e]);
    }
  }
  cp_async_wait<0>();  // only empty groups can be pending; the ring is reused below
  __syncthreads();

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

  // merge the warps into warp 0 by halving rounds through the ring's
  // shared memory (half the warps write, the other half fold)
  float* sm_m = reinterpret_cast<float*>(smem);  // [kWarps/2][NREP]
  float* sm_l = sm_m + (kWarps / 2) * NREP;      // [kWarps/2][NREP]
  float* sm_acc = sm_l + (kWarps / 2) * NREP;    // [kWarps/2][NREP][D]
#pragma unroll
  for (int half = kWarps / 2; half >= 1; half /= 2) {
    if (warp >= half && warp < 2 * half && lane < LANES) {
      const int w = warp - half;
#pragma unroll
      for (int r = 0; r < NREP; ++r) {
        sm_m[w * NREP + r] = m[r];
        sm_l[w * NREP + r] = l[r];
#pragma unroll
        for (int vv = 0; vv < VPL; ++vv)
#pragma unroll
          for (int j = 0; j < VEC; ++j)
            sm_acc[(w * NREP + r) * D + col(vv, j)] = acc[r][vv * VEC + j];
      }
    }
    __syncthreads();
    if (warp < half) {
#pragma unroll
      for (int r = 0; r < NREP; ++r) {
        const float m_o = sm_m[warp * NREP + r];
        const float l_o = sm_l[warp * NREP + r];
        const float m_new = fmaxf(m[r], m_o);
        const float a = expf(m[r] - m_new);
        const float b = expf(m_o - m_new);
        l[r] = l[r] * a + l_o * b;
#pragma unroll
        for (int vv = 0; vv < VPL; ++vv)
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const int e = vv * VEC + j;
            acc[r][e] = acc[r][e] * a + sm_acc[(warp * NREP + r) * D + col(vv, j)] * b;
          }
        m[r] = m_new;
      }
    }
    __syncthreads();
  }
  if (n_live > 1) {
    // publish this split's partial, then take a ticket; the block that
    // draws the last one merges every live split's partial in split order
    const int pair = s * H_kv + kv;
    const int64_t pairs = static_cast<int64_t>(gridDim.x) * gridDim.y;
    float* acc_ws = ws + static_cast<int64_t>(pair) * n_split * n_rep * D;  // [n_split][n_rep][D]
    float* ml_ws = ws + pairs * n_split * n_rep * D +
                   static_cast<int64_t>(pair) * n_split * 2 * n_rep;  // [n_split][m, l][n_rep]
    if (warp == 0) {
      float* part = acc_ws + static_cast<int64_t>(z) * n_rep * D;
#pragma unroll
      for (int r = 0; r < NREP; ++r) {
        if (r >= n_rep) continue;
        if (lane < LANES) {
#pragma unroll
          for (int vv = 0; vv < VPL; ++vv)
#pragma unroll
            for (int j = 0; j < VEC; ++j) part[r * D + col(vv, j)] = acc[r][vv * VEC + j];
        }
        if (lane == 0) {
          ml_ws[z * 2 * n_rep + r] = m[r];
          ml_ws[z * 2 * n_rep + n_rep + r] = l[r];
        }
      }
      __threadfence();  // the partial is visible device-wide before the ticket
    }
    __syncthreads();
    int last = 0;
    if (threadIdx.x == 0) last = atomicAdd(counters + pair, 1) == n_live - 1;
    if (!__syncthreads_or(last)) return;  // the same for the whole block
    __threadfence();

    // the merge, by the whole block through shared memory (m_g = max m,
    // corr = exp(m - m_g), l_g and acc_g summed in split order)
    float* sm_mz = reinterpret_cast<float*>(smem);  // [n_live][n_rep]
    float* sm_lz = sm_mz + n_live * n_rep;         // [n_live][n_rep]
    float* sm_corr = sm_lz + n_live * n_rep;       // [n_live][n_rep]
    float* sm_mg = sm_corr + n_live * n_rep;       // [n_rep]
    float* sm_lg = sm_mg + NREP;                    // [n_rep]
    float* sm_accg = sm_mz + ((3 * n_live * n_rep + 2 * NREP + 3) & ~3);  // [n_rep][D]
    for (int t = threadIdx.x; t < n_live * n_rep; t += kThreads) {
      const int zz = t / n_rep, r = t % n_rep;
      sm_mz[t] = __ldcg(ml_ws + zz * 2 * n_rep + r);
      sm_lz[t] = __ldcg(ml_ws + zz * 2 * n_rep + n_rep + r);
    }
    __syncthreads();
    if (threadIdx.x < n_rep) {
      float m_g = kNegInf;
      for (int zz = 0; zz < n_live; ++zz) m_g = fmaxf(m_g, sm_mz[zz * n_rep + threadIdx.x]);
      sm_mg[threadIdx.x] = m_g;
    }
    __syncthreads();
    for (int t = threadIdx.x; t < n_live * n_rep; t += kThreads)
      sm_corr[t] = expf(sm_mz[t] - sm_mg[t % n_rep]);
    __syncthreads();
    if (threadIdx.x < n_rep) {
      float l_g = 0.0f;
      for (int zz = 0; zz < n_live; ++zz)
        l_g += sm_lz[zz * n_rep + threadIdx.x] * sm_corr[zz * n_rep + threadIdx.x];
      sm_lg[threadIdx.x] = l_g;
    }
    // acc: one float4 of columns per thread and item, loads batched
    // kBatch splits at a time, summed in split order
    constexpr int kBatch = 4;
    const int quads = n_rep * (D / 4);
    const float4* src = reinterpret_cast<const float4*>(acc_ws);
    for (int i = threadIdx.x; i < quads; i += kThreads) {
      const int r = i / (D / 4);
      float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int z0 = 0; z0 < n_live; z0 += kBatch) {
        float4 v[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k)
          if (z0 + k < n_live) v[k] = __ldcg(src + (z0 + k) * quads + i);
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          if (z0 + k >= n_live) break;
          const float c = sm_corr[(z0 + k) * n_rep + r];
          a.x = fmaf(v[k].x, c, a.x);
          a.y = fmaf(v[k].y, c, a.y);
          a.z = fmaf(v[k].z, c, a.z);
          a.w = fmaf(v[k].w, c, a.w);
        }
      }
      reinterpret_cast<float4*>(sm_accg)[i] = a;
    }
    __syncthreads();
    if (threadIdx.x == 0) counters[pair] = 0;  // ready for the next launch
    if (warp != 0) return;
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      if (r >= n_rep) continue;
      m[r] = sm_mg[r];
      l[r] = sm_lg[r];
#pragma unroll
      for (int vv = 0; vv < VPL; ++vv)
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[r][vv * VEC + j] = sm_accg[r * D + col(vv, j)];
    }
  } else if (warp != 0) {
    return;
  }

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
  float* ws;      // n_split > 1: f32 acc [S*H_kv, n_split, n_rep, d], then m, l
  int* counters;  // n_split > 1: [S * H_kv] int32, zero
  int S, H, H_kv, P, max_pages;
  int pos_base, global_page_size, mode, n_split;
  cudaStream_t stream;
};

// The launch helpers have internal linkage: each library keeps its own
// opt-in flags (a static local of an external template would be one object
// shared by every library loaded in the process).
namespace {

template <typename T, typename KV, int D, int NREP>
cudaError_t launch(const Args& a) {
  constexpr int smem = Layout<T, KV, D>::template smem_bytes<NREP>();
  auto kernel = paged_decode_kernel<T, KV, D, NREP>;
  if (smem > 48 * 1024) {
    // above 48 KB a kernel must opt in, once per device; a benign race
    // between host threads sets it twice
    static bool opted_in[64] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= 64 || !opted_in[dev]) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
      if (dev < 64) opted_in[dev] = true;
    }
  }
  const dim3 grid(a.S, a.H_kv, a.n_split);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const KV*>(a.k_pages),
      static_cast<const KV*>(a.v_pages), a.k_scales, a.v_scales, a.block_tables, a.seq_lens,
      static_cast<const T*>(a.k_new), static_cast<const T*>(a.v_new), static_cast<T*>(a.out),
      a.acc_out, a.m_out, a.l_out, a.ws, a.counters, a.H, a.H_kv, a.P, a.max_pages,
      a.H / a.H_kv, a.pos_base, a.global_page_size, a.mode, a.n_split);
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

}  // namespace

// Shape checks shared by the C entry points.
inline bool valid_shape(int S, int H, int H_kv, int P, int max_pages) {
  return S > 0 && H_kv > 0 && H % H_kv == 0 && H / H_kv <= 8 && P > 0 && max_pages > 0;
}

// The state form's slice: pos_base + P rows must fit in one global page.
inline bool valid_slice(int P, int pos_base, int global_page_size) {
  return pos_base >= 0 && global_page_size >= P && pos_base + P <= global_page_size;
}

// The split: 1 <= n_split <= min(max_pages, kMaxSplits); more than one
// needs the workspace and the counters.
inline bool valid_split(int n_split, int max_pages, const void* ws, const void* counters) {
  return n_split >= 1 && n_split <= max_pages && n_split <= kMaxSplits &&
         (n_split == 1 || (ws != nullptr && counters != nullptr));
}

}  // namespace acp
