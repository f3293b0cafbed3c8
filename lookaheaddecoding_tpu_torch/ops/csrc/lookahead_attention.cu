// Composite-mask lookahead attention for Hopper (sm_90a), CUDA C++.
//
// Replaces the three Pallas bodies of
// lookaheaddecoding_tpu/ops/lookahead_attention.py:
//   - _kernel_single (lookahead_attention: whole cache in one KV block,
//     direct softmax),
//   - _kernel (lookahead_attention: online softmax over KV blocks with
//     live-block skipping), and
//   - _paged_kernel (paged_lookahead_attention: the same function for B
//     lanes whose K/V lie in one shared page pool, each lane with its own
//     kv_len and logical -> physical page table).
// One __global__ covers all three. The split of the first two was a TPU
// choice about per-program overhead, not a different function; the paged
// call is the flat call with a lane axis on the grid and one address
// translation where a key row is loaded, so the flat call is the case of
// one lane and no table, and a lane of the paged call gives the flat
// call's bits on the same logical cache (same tiles, same order).
//
// What it computes: out[s, h*D:(h+1)*D] = softmax_c(q[s,h].k[g,c] / sqrt(D)
// over visible c) . v[g,c], with GQA head h -> KV head g = h / rep, fp32
// accumulation, the probabilities rounded to the input type before the PV
// product (as the TPU kernel does), output in the input type.
// int8-KV mode (the cache of models/llama.py:make_kv_cache(quant="int8")):
// k and v are int8 with one float32 scale a slot and KV head, [Hkv, M]. The
// bytes are converted in shared memory; the score is multiplied by
// k_scale[g, c] after the QK product, the denominator sums the unscaled p,
// and p is multiplied by v_scale[g, c] and then rounded to q's type before
// the PV product, so no dequantized copy of the cache exists anywhere.
// Paged mode: logical key column c of lane b lies at pool slot
//   tables[b, c / page_size] * page_size + c % page_size.
// The TPU kernel walks whole pages (its key block is a page, hence its
// page_size % 128 rule); here the key tile stays BK columns whatever the
// page size, and every key row of a tile is translated on its own, so any
// page_size works and the tile order is the flat call's. A block reads its
// lane's kv_len and table row itself. It loads nothing past the last live
// column of its rows (kv_len + S at most), so the table entries of logical
// pages a lane does not own (they point at its trash page) are not
// followed for any row that counts.
// Visibility (the TPU kernel's _block_mask), in logical columns:
//   composite mode: committed slots c < kv_len are visible to every row
//     (with a sliding window sw only when c > kv_len + rel_pos(s) - sw);
//     slots kv_len + rj, rj in [0, S), follow the within-composite mask
//     spec_visible(s, rj), derived here from index arithmetic.
//   causal mode: c <= kv_len + s (and c > kv_len + s - sw with a window).
// s is the row's composite index: row0 + the row of the call. A
// lookahead-parallel rank passes its share of the composite rows with
// row0 at its first one (models/llama.py), and gets those rows of the
// whole call.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): at
// the headline composite call (S=240, Hq=32, Hkv=4, D=64, kv_len=512, so
// 752 live columns) it moves q 0.98 MB + live K/V 0.77 MB + out 0.98 MB
// ~= 2.7 MB (~0.8 us). Its rows see 124,980 (row, key) pairs (240*512
// committed, 2,100 of the sparse within-composite mask), so it does
// 4*64*32*124,980 ~= 1.02 GFLOP (~1.04 us): compute-bound at ~1.04 us a
// call, 22 calls a decode step. The paged call of four lanes does four
// times that work on four times the bytes. Head dims 32, 48, 64, 80, 96,
// 112, 128 and 256 are instantiated. At D=256 with Gemma-2B's heads (Hq=8, Hkv=1) the
// same call moves the same bytes and does the same FLOPs (Hq*D is 2048 in
// both), but its 1,920 GQA rows are only 30 row tiles.
// Every D is a multiple of 16, which is all either kernel assumes of it: the
// mma kernel takes D / 16 k16 steps of Q K^T and D / 8 n8 tiles of P V, in
// ldmatrix .x4 pairs (3 pairs at D = 48, 5 at D = 80, 6 at D = 96, 7 at
// D = 112), and its rows move in 16-byte cp.async pieces (bf16 rows of
// D / 8 pieces, int8 rows of D / 16: two at D = 32, three at D = 48, five at
// D = 80, seven at D = 112); a tile row of D + 8 bf16 keeps every row
// 16-byte aligned and puts the eight rows of an ldmatrix matrix on eight
// different groups of four banks at each D (a row stride of 20, 28, 44, 52
// or 60 words at D = 32, 48, 80, 96, 112). The FMA kernel gives each thread D / 8 output
// dims. D <= 128 takes the key-group rule of D = 64 (below), so flat and
// paged calls keep the same bits lane by lane at every D.
//
// What the design does about that bound. Both kernels below never read a
// KV tile past the last live column of their rows (nor below the sliding
// window), so work and traffic follow the live context, not the cache
// capacity; K/V tiles are read once per block of 64 query rows. They are
// chosen by q's dtype:
//   - bfloat16 q (attention_mma_kernel): FlashAttention-2 on the tensor
//     cores, mma.sync m16n8k16 bf16 x bf16 -> f32 for Q K^T and P V, the
//     online softmax on the accumulators, P kept in registers, K/V tiles
//     double-buffered by cp.async (an int8 tile converted exactly to bf16
//     once in shared memory), two partial softmax states a row (even and
//     odd key tiles) so that a call of few row tiles can run them in two
//     key groups of warps; at D=256 key tiles of 32 and always two key
//     groups, so that a thread holds one state. See the kernel.
//   - float32 q (lookahead_attention_kernel), the parity dtype: per-thread
//     fp32 FMAs from shared memory (4 rows x 8 columns a thread), which on
//     the tensor cores would go through TF32.
// wgmma, TMA loads and a split over KV for the one-row call are later
// work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (lookaheaddecoding_tpu_torch/ops/_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "mma_sync.cuh"

namespace {

constexpr int BR = 64;         // query rows (GQA rows of one KV head) a block
constexpr int BK = 64;         // keys a KV tile
constexpr int TX = 8;          // threads sharing one group of rows
constexpr int TY = BR / 4;     // row groups a block
constexpr int RPT = BR / TY;   // rows a thread (4)
constexpr int CPT = BK / TX;   // key columns a thread (8)
constexpr int NT = TX * TY;    // threads a block (128)

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<signed char>(signed char x) { return (float)x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

struct Geometry {
  int s_len;           // S query positions
  int rep;             // query heads per KV head
  int hq;              // query heads
  int m;               // logical cache capacity M (paged: NB * page_size)
  int pool_slots;      // slots a KV head in k/v (flat: M)
  int page_size;       // 0: flat cache, column c lies at slot c
  int nb;              // table entries a lane
  int level, window, guess_size;
  int causal;          // 1: prefill / AR mode
  int sliding_window;  // 0: full attention
  int row0;            // composite index of query row 0 (an la rank's first row)
  float scale_log2;    // log2(e) / sqrt(D)
};

// Position of composite row qi relative to the last confirmed token
// (core/layout.py rel_pos). qi >= 0, so C++ / and % match floor division.
__device__ __forceinline__ int rel_pos(int qi, const Geometry& g) {
  const int nw = (g.level - 1) * g.window;
  return qi < nw ? qi / g.window + qi % g.window : 1 + (qi - nw) % g.guess_size;
}

// Within-composite visibility (core/layout.py _build_spec_mask). Both ids
// lie in [0, S); the guess-region terms are formed only for ids >= nw, so
// no negative operand reaches / or % (the TPU code masks those instead).
__device__ __forceinline__ bool spec_visible(int qi, int rj, const Geometry& g) {
  const int w = g.window, nw = (g.level - 1) * w;
  if (qi < nw) {
    if (rj >= nw) return false;
    const int lq = qi / w, pq = qi % w, lk = rj / w, pk = rj % w;
    return (lk == 0 && pk <= pq) || (lk >= 1 && lk <= lq && pk == pq);
  }
  if (rj == 0) return true;  // every n-gram token sees the last token
  if (rj < nw) return false;
  const int gs = g.guess_size;
  return (rj - nw) / gs == (qi - nw) / gs && (rj - nw) % gs <= (qi - nw) % gs;
}

// s is a composite row index (row0 + the call's row); rows see no
// speculative slot past their own, so rj < row0 + s_len bounds rj.
__device__ __forceinline__ bool visible(int s, int c, int kv_len, const Geometry& g) {
  const int sw = g.sliding_window;
  if (g.causal) return c <= kv_len + s && (sw == 0 || c > kv_len + s - sw);
  if (c < kv_len) return sw == 0 || c > kv_len + rel_pos(s, g) - sw;
  const int rj = c - kv_len;
  return rj < g.row0 + g.s_len && spec_visible(s, rj, g);
}

// float32 q (T = float). Grid (row tiles, KV heads, lanes). Block: NT
// threads, BR GQA rows t = s*rep + r of KV head blockIdx.y; thread (ty, tx)
// owns rows ty*RPT + i and, in each KV tile, key columns tx + TX*j and
// output dims tx + TX*j. KV is T, or signed char in int8-KV mode (then
// k_scale and v_scale are read).
template <typename T, typename KV, int D>
__global__ void __launch_bounds__(NT)
lookahead_attention_kernel(const T* __restrict__ q, const KV* __restrict__ k,
                           const KV* __restrict__ v, const float* __restrict__ k_scale,
                           const float* __restrict__ v_scale,
                           const int* __restrict__ kv_len_ptr, const int* __restrict__ tables,
                           T* __restrict__ out, Geometry g) {
  constexpr bool QUANT = !std::is_same<T, KV>::value;
  constexpr int DPT = D / TX;  // output dims a thread
  constexpr int QS = D + 1;    // padded row strides: no bank conflicts
  constexpr int PS = BK + 1;
  extern __shared__ float smem[];
  float* sq = smem;             // [BR][QS]
  float* sk = sq + BR * QS;     // [BK][QS]
  float* sv = sk + BK * QS;     // [BK][D]
  float* sp = sv + BK * D;      // [BR][PS]
  float* sks = sp + BR * PS;    // [BK] k scales of the tile (int8-KV mode)
  float* svs = sks + BK;        // [BK] v scales
  int* sslot = reinterpret_cast<int*>(svs + BK);  // [BK] pool slot of each key, -1: not loaded

  const int tid = threadIdx.x, ty = tid / TX, tx = tid % TX;
  const int head_kv = blockIdx.y;
  const int n_rows = g.s_len * g.rep;
  const int t0 = blockIdx.x * BR;
  const int lane = blockIdx.z;
  const int kv_len = kv_len_ptr[lane];
  const int* table = g.page_size ? tables + (size_t)lane * g.nb : nullptr;
  const KV* kh = k + (size_t)head_kv * g.pool_slots * D;
  const KV* vh = v + (size_t)head_kv * g.pool_slots * D;
  q += (size_t)lane * g.s_len * g.hq * D;
  out += (size_t)lane * g.s_len * g.hq * D;

  for (int idx = tid; idx < BR * D; idx += NT) {
    const int row = idx / D, d = idx % D, t = t0 + row;
    float x = 0.f;
    if (t < n_rows) {
      const int s = t / g.rep, h = head_kv * g.rep + t % g.rep;
      x = to_f<T>(q[((size_t)s * g.hq + h) * D + d]);
    }
    sq[row * QS + d] = x;
  }

  // Live columns of this block's rows: row s sees nothing past kv_len + s
  // in either mode (the spec mask is lower-triangular), and nothing below
  // the sliding window (rel_pos >= 0 in composite mode).
  const int s_lo = t0 / g.rep;
  const int s_hi = (min(t0 + BR, n_rows) - 1) / g.rep;
  const int col_end = min(kv_len + g.row0 + s_hi + 1, g.m);
  int col_begin = 0;
  if (g.sliding_window) {
    col_begin = max(kv_len + (g.causal ? g.row0 + s_lo : 0) - g.sliding_window + 1, 0);
  }
  const int tile_begin = col_begin / BK;
  const int tile_end = (col_end + BK - 1) / BK;

  float m_run[RPT], l_run[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DPT; ++e) acc[i][e] = 0.f;
  }

  for (int tile = tile_begin; tile < tile_end; ++tile) {
    const int c0 = tile * BK;
    __syncthreads();  // the previous tile's K/V/P reads are done
    if (table == nullptr) {
      // flat cache: column c lies at slot c. Columns past the last live one
      // are not loaded.
      for (int idx = tid; idx < BK * D; idx += NT) {
        const int kk = idx / D, d = idx % D, c = c0 + kk;
        const bool ok = c < col_end;
        sk[kk * QS + d] = ok ? to_f<KV>(kh[(size_t)c * D + d]) : 0.f;
        sv[kk * D + d] = ok ? to_f<KV>(vh[(size_t)c * D + d]) : 0.f;
      }
      if (QUANT) {
        for (int kk = tid; kk < BK; kk += NT) {
          const int c = c0 + kk;
          sks[kk] = c < col_end ? k_scale[(size_t)head_kv * g.pool_slots + c] : 0.f;
          svs[kk] = c < col_end ? v_scale[(size_t)head_kv * g.pool_slots + c] : 0.f;
        }
      }
    } else {
      // paged cache: the pool slot of each key column of the tile, through
      // the lane's table. Columns past the last live one are not loaded
      // (their table entry may belong to no page).
      for (int kk = tid; kk < BK; kk += NT) {
        const int c = c0 + kk;
        const int slot = c < col_end ? table[c / g.page_size] * g.page_size + c % g.page_size : -1;
        sslot[kk] = slot;
        if (QUANT) {
          sks[kk] = slot >= 0 ? k_scale[(size_t)head_kv * g.pool_slots + slot] : 0.f;
          svs[kk] = slot >= 0 ? v_scale[(size_t)head_kv * g.pool_slots + slot] : 0.f;
        }
      }
      __syncthreads();
      for (int idx = tid; idx < BK * D; idx += NT) {
        const int kk = idx / D, d = idx % D, slot = sslot[kk];
        sk[kk * QS + d] = slot >= 0 ? to_f<KV>(kh[(size_t)slot * D + d]) : 0.f;
        sv[kk * D + d] = slot >= 0 ? to_f<KV>(vh[(size_t)slot * D + d]) : 0.f;
      }
    }
    __syncthreads();

    float sc[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[RPT], kb[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qa[i] = sq[(ty * RPT + i) * QS + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kb[j] = sk[(tx + TX * j) * QS + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) sc[i][j] = fmaf(qa[i], kb[j], sc[i][j]);
    }

    // Mask and online softmax. The TX threads of a row group are adjacent
    // lanes of one warp, so row reductions are three xor shuffles.
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = ty * RPT + i, t = t0 + row, s = t / g.rep;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = c0 + tx + TX * j;
        const bool vis = t < n_rows && c < g.m && visible(g.row0 + s, c, kv_len, g);
        const float scaled = QUANT ? sc[i][j] * g.scale_log2 * sks[tx + TX * j]
                                   : sc[i][j] * g.scale_log2;
        sc[i][j] = vis ? scaled : -INFINITY;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[i], mx);
      // rows with nothing visible yet: keep every exponent argument finite
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = m_run[i] == -INFINITY ? 0.f : exp2f(m_run[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = exp2f(sc[i][j] - m_use);
        psum += p;
        const float pv = QUANT ? p * svs[tx + TX * j] : p;
        sp[row * PS + tx + TX * j] = to_f<T>(from_f<T>(pv));
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l_run[i] = alpha * l_run[i] + psum;
      m_run[i] = m_new;
#pragma unroll
      for (int e = 0; e < DPT; ++e) acc[i][e] *= alpha;
    }
    __syncwarp();  // a row group's P row is written and read by one warp

#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float pa[RPT], vb[DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pa[i] = sp[(ty * RPT + i) * PS + kk];
#pragma unroll
      for (int e = 0; e < DPT; ++e) vb[e] = sv[kk * D + tx + TX * e];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int e = 0; e < DPT; ++e) acc[i][e] = fmaf(pa[i], vb[e], acc[i][e]);
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int t = t0 + ty * RPT + i;
    if (t >= n_rows) continue;
    const int s = t / g.rep, h = head_kv * g.rep + t % g.rep;
    const float inv = 1.f / fmaxf(l_run[i], 1e-30f);
#pragma unroll
    for (int e = 0; e < DPT; ++e)
      out[((size_t)s * g.hq + h) * D + tx + TX * e] = from_f<T>(acc[i][e] * inv);
  }
}

// ---------------------------------------------------------------------------
// bfloat16 q: FlashAttention-2 on mma.sync (m16n8k16, bf16 x bf16 -> f32).
// ---------------------------------------------------------------------------

constexpr int MW = 4;          // warps of a key group: 16 GQA rows each (one m16 tile)
constexpr int MBR = 16 * MW;   // GQA rows a block
constexpr int GNT = 32 * MW;   // threads of a key group

// Shared memory of one block of G key groups: the Q tile; for each group
// two stages of K/V tiles as they arrive (bf16 rows padded by 16 bytes, so
// the eight rows of an ldmatrix matrix fall on eight different groups of
// four banks; int8 rows as bytes, with the tile's k and v scales) and, in
// int8-KV mode, the stage's K and V converted to bf16; then the composite
// mask words. After the key loop the stages hold group 1's partial state.
// A key tile is KT keys: 64 up to D = 128, 32 at D = 256, where a 64-key
// group of two stages would take 135 KB and two groups would not fit.
template <typename KV, int D, int G>
struct MmaLayout {
  static constexpr bool QUANT = std::is_same<KV, signed char>::value;
  static constexpr int KT = D > 128 ? 32 : 64;        // keys a tile
  static constexpr int RS = D + 8;                    // bf16 tile row stride (elements)
  static constexpr int Q_BYTES = MBR * RS * 2;
  static constexpr int TILE_BYTES = KT * RS * 2;      // one bf16 K or V tile
  static constexpr int RAW_ROW = QUANT ? D : RS * 2;  // row stride of a tile as it arrives (bytes)
  static constexpr int RAW_BYTES = KT * RAW_ROW;
  static constexpr int STAGE_BYTES = 2 * RAW_BYTES + (QUANT ? 2 * KT * 4 : 0);
  static constexpr int CONV_BYTES = QUANT ? 2 * TILE_BYTES : 0;
  static constexpr int GROUP_BYTES = 2 * STAGE_BYTES + CONV_BYTES;
  static constexpr int FIXED_BYTES = Q_BYTES + G * GROUP_BYTES;
  static constexpr int PART_FLOATS = 4 + D / 2;       // a thread's m, l (two rows) and O
  static_assert(RAW_BYTES % 16 == 0 && STAGE_BYTES % 16 == 0, "16-byte aligned tiles");
  static_assert(G == 1 || PART_FLOATS * GNT * 4 <= G * GROUP_BYTES, "the partials fit");
  static_assert(D <= 128 || G == 2, "at D = 256 a thread holds one partial state");
  static_assert(FIXED_BYTES <= 227 * 1024 - 4096, "the tiles and the mask words fit");
};

__device__ __forceinline__ void group_sync(int kg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + kg), "n"(GNT) : "memory");
}

// Grid (row tiles, KV heads, lanes), as the FMA kernel's. Warp w of a key
// group owns the 16 GQA rows t0 + 16 w + [0, 16) (t = s * rep + r) of KV
// head blockIdx.y; lane (gq, qq) holds rows gq and gq + 8 of them.
//
// Every row keeps two partial softmax states, one over the live key tiles
// of even index and one over those of odd index, merged at the end (even
// state first, a state that saw no key weighted by an exact 0). With G = 2
// a block has two key groups of four warps, one a state, each walking its
// tiles with its own double-buffered cp.async stages and barrier: an
// S = 240 call has only 120 row tiles for 132 SMs, and one group of four
// warps would leave each SM waiting on its loads. With G = 1 (a grid with
// more blocks than SMs, as the paged call of four lanes) one group walks
// every tile and holds both states. The two give the same bits: the same
// operations in the same order on each state (the arithmetic is written
// with explicit roundings, so no contraction differs between them). At
// D = 256 a state is 128 floats of O a thread, so a thread holds one: the
// block always has two key groups (G = 2), over key tiles of 32 (MmaLayout),
// whatever the grid; the even and odd states are then those of 32-key
// tiles, and D = 256 has one launch, hence one set of bits.
//
// Per tile: S = Q K^T on the tensor cores, the mask and the online softmax
// on the accumulators (row max and sum across the lane quad by two xor
// shuffles), P repacked in registers as the A operand of O += P V (the C
// layout of the first product is the A layout of the second), V's B
// fragments by ldmatrix.trans. spec_words: 32-bit words a composite row's
// mask takes.
template <typename KV, int D, int G>
__global__ void __launch_bounds__(GNT * G)
attention_mma_kernel(const __nv_bfloat16* __restrict__ q, const KV* __restrict__ k,
                     const KV* __restrict__ v, const float* __restrict__ k_scale,
                     const float* __restrict__ v_scale, const int* __restrict__ kv_len_ptr,
                     const int* __restrict__ tables, __nv_bfloat16* __restrict__ out,
                     Geometry g, int spec_words) {
  using L = MmaLayout<KV, D, G>;
  constexpr bool QUANT = L::QUANT;
  constexpr int NT_ = GNT * G;  // threads a block
  constexpr int NS = 3 - G;     // partial states a thread holds
  constexpr int KT = L::KT;     // keys a tile
  constexpr int KD = D / 16;    // k16 steps of Q K^T
  constexpr int ND = D / 8;     // n8 tiles of the output
  constexpr int NK = KT / 8;    // n8 tiles of a key tile
  extern __shared__ __align__(16) unsigned char mma_smem[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(mma_smem);
  unsigned* spec = reinterpret_cast<unsigned*>(mma_smem + L::FIXED_BYTES);

  const int tid = threadIdx.x, kg = G == 2 ? tid / GNT : 0, gtid = tid % GNT;
  const int warp = gtid / 32, lane = tid % 32, gq = lane >> 2, qq = lane & 3;
  unsigned char* stages = mma_smem + L::Q_BYTES + kg * L::GROUP_BYTES;
  __nv_bfloat16* conv = reinterpret_cast<__nv_bfloat16*>(stages + 2 * L::STAGE_BYTES);
  const int head_kv = blockIdx.y, b = blockIdx.z;
  const int n_rows = g.s_len * g.rep, t0 = blockIdx.x * MBR;
  const int kv_len = kv_len_ptr[b];
  const int* table = g.page_size ? tables + (size_t)b * g.nb : nullptr;
  const unsigned char* kh =
      reinterpret_cast<const unsigned char*>(k + (size_t)head_kv * g.pool_slots * D);
  const unsigned char* vh =
      reinterpret_cast<const unsigned char*>(v + (size_t)head_kv * g.pool_slots * D);
  q += (size_t)b * g.s_len * g.hq * D;
  out += (size_t)b * g.s_len * g.hq * D;

  // Live columns of this block's rows, as in the FMA kernel.
  const int s_lo = t0 / g.rep;
  const int s_hi = (min(t0 + MBR, n_rows) - 1) / g.rep;
  const int col_end = min(kv_len + g.row0 + s_hi + 1, g.m);
  int col_begin = 0;
  if (g.sliding_window)
    col_begin = max(kv_len + (g.causal ? g.row0 + s_lo : 0) - g.sliding_window + 1, 0);
  const int tile_begin = col_begin / KT;
  const int tile_end = (col_end + KT - 1) / KT;

  // The Q tile, rows past n_rows zero.
  constexpr int QCH = D / 8;  // 16-byte pieces a row
  for (int i = tid; i < MBR * QCH; i += NT_) {
    const int row = i / QCH, ch = i % QCH, t = t0 + row;
    const bool live = t < n_rows;
    const int s = live ? t / g.rep : 0, h = head_kv * g.rep + (live ? t % g.rep : 0);
    cp_async16_zfill(sq + row * L::RS + ch * 8, q + ((size_t)s * g.hq + h) * D + ch * 8,
                     live ? 16 : 0);
  }
  cp_async_commit();

  // Key tile `tile` into a stage of this key group: each key row through
  // the lane's table (paged) or at its own slot (flat); rows from col_end
  // on, which no row of the block sees, are zero-filled and their table
  // entries not read.
  auto load_tile = [&](int tile, unsigned char* st) {
    constexpr int CPR = D * (int)sizeof(KV) / 16;  // 16-byte pieces a key row
    const int c0 = tile * KT;
    for (int i = gtid; i < KT * CPR; i += GNT) {
      const int r = i / CPR, ch = i % CPR, c = c0 + r;
      const int slot = c >= col_end ? -1
                       : table     ? table[c / g.page_size] * g.page_size + c % g.page_size
                                   : c;
      const size_t off = (size_t)max(slot, 0) * D * sizeof(KV) + ch * 16;
      const int n = slot >= 0 ? 16 : 0;
      cp_async16_zfill(st + r * L::RAW_ROW + ch * 16, kh + off, n);
      cp_async16_zfill(st + L::RAW_BYTES + r * L::RAW_ROW + ch * 16, vh + off, n);
    }
    if constexpr (QUANT) {
      float* sc = reinterpret_cast<float*>(st + 2 * L::RAW_BYTES);
      for (int r = gtid; r < KT; r += GNT) {
        const int c = c0 + r;
        const int slot = c >= col_end ? -1
                         : table     ? table[c / g.page_size] * g.page_size + c % g.page_size
                                     : c;
        const size_t at = (size_t)head_kv * g.pool_slots + max(slot, 0);
        cp_async4_zfill(sc + r, k_scale + at, slot >= 0 ? 4 : 0);
        cp_async4_zfill(sc + KT + r, v_scale + at, slot >= 0 ? 4 : 0);
      }
    }
  };

  // this group's tiles: first, first + G, ... below tile_end (G = 2: those
  // of index parity kg); the first one's copy starts before the mask words
  // are worked out
  const int first = G == 2 ? tile_begin + (kg + 2 - tile_begin % 2) % 2 : tile_begin;
  if (first < tile_end) load_tile(first, stages);
  cp_async_commit();

  // Composite mode: bit rj % 32 of word (s - s_lo) * spec_words + rj / 32
  // is spec_visible(s, rj), once a block, so the tiles' masks are lookups.
  if (!g.causal) {
    const int words = (s_hi - s_lo + 1) * spec_words;
    for (int i = tid; i < words; i += NT_) {
      const int s = s_lo + i / spec_words, rj0 = (i % spec_words) * 32;
      unsigned bits = 0;
      for (int e = 0; e < 32; ++e)
        if (rj0 + e < g.row0 + g.s_len && spec_visible(g.row0 + s, rj0 + e, g)) bits |= 1u << e;
      spec[i] = bits;
    }
  }

  // This thread's two rows (gq and gq + 8 of its warp): composite mode sees
  // committed column c when c > lo (lo = -1 without a window) and
  // speculative column kv_len + rj by the mask words; causal mode sees
  // lo < c <= hi. A row past n_rows sees nothing.
  const int wr0 = t0 + warp * 16;
  const bool warp_live = wr0 < n_rows, warp_full = wr0 + 16 <= n_rows;
  bool row_live[2];
  int lo[2], hi[2], srow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = wr0 + gq + 8 * r;
    row_live[r] = t < n_rows;
    const int s = row_live[r] ? t / g.rep : s_lo;
    srow[r] = s - s_lo;
    const int base = g.causal ? kv_len + g.row0 + s : kv_len + rel_pos(g.row0 + s, g);
    lo[r] = g.sliding_window ? base - g.sliding_window : -1;
    hi[r] = kv_len + g.row0 + s;
  }

  float o[NS][ND][4], m_run[NS][2], l_run[NS][2];
#pragma unroll
  for (int n = 0; n < NS; ++n) {
#pragma unroll
    for (int j = 0; j < ND; ++j) o[n][j][0] = o[n][j][1] = o[n][j][2] = o[n][j][3] = 0.f;
    m_run[n][0] = m_run[n][1] = -INFINITY;
    l_run[n][0] = l_run[n][1] = 0.f;
  }

  cp_async_wait<1>();
  __syncthreads();  // the Q tile and the mask words are in place

  // One key tile into one partial state (oo, mm, ll).
  auto attend = [&](int c0, const __nv_bfloat16* sk, const __nv_bfloat16* sv,
                    const float* scales, float (&oo)[ND][4], float (&mm)[2], float (&ll)[2]) {
    // S = Q K^T: the Q fragments from the Q tile (read again each tile,
    // which leaves their registers to the two states), an x4 ldmatrix of K
    // rows the B fragments of two n8 key tiles (keys as columns, d as k).
    float sc[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t qf[4];
      ldmatrix_x4(qf, sq + (warp * 16 + (lane & 15)) * L::RS + kd * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int jp = 0; jp < NK / 2; ++jp) {
        uint32_t bk[4];
        ldmatrix_x4(bk, sk + (16 * jp + (lane & 7) + ((lane >> 4) << 3)) * L::RS + kd * 16 +
                            ((lane >> 3) & 1) * 8);
        mma_bf16(sc[2 * jp], qf, bk[0], bk[1]);
        mma_bf16(sc[2 * jp + 1], qf, bk[2], bk[3]);
      }
    }
    // A tile every row of the warp sees whole needs no mask.
    const bool whole =
        warp_full && g.sliding_window == 0 &&
        (g.causal ? c0 + KT - 1 <= kv_len + g.row0 + wr0 / g.rep && c0 + KT <= g.m
                  : c0 + KT <= kv_len);
    // accumulator (j, 2 r + e) is row gq + 8 r, key column c0 + 8 j + 2 qq + e
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cc = 8 * j + 2 * qq + e, c = c0 + cc;
          bool vis = true;
          if (!whole) {
            if (!row_live[r] || c >= g.m) {
              vis = false;
            } else if (g.causal) {
              vis = c > lo[r] && c <= hi[r];
            } else if (c < kv_len) {
              vis = c > lo[r];
            } else {
              const int rj = c - kv_len;
              vis = rj < g.row0 + g.s_len &&
                    ((spec[srow[r] * spec_words + (rj >> 5)] >> (rj & 31)) & 1u);
            }
          }
          float x = __fmul_rn(sc[j][2 * r + e], g.scale_log2);
          if (QUANT) x = __fmul_rn(x, scales[cc]);
          sc[j][2 * r + e] = vis ? x : -INFINITY;
          mx = fmaxf(mx, sc[j][2 * r + e]);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(mm[r], mx);
      // rows with nothing visible yet: keep every exponent argument finite
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = mm[r] == -INFINITY ? 0.f : exp2f(__fsub_rn(mm[r], m_new));
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(__fsub_rn(sc[j][2 * r + e], m_use));
          psum = __fadd_rn(psum, p);
          sc[j][2 * r + e] = QUANT ? __fmul_rn(p, scales[KT + 8 * j + 2 * qq + e]) : p;
        }
      }
      psum = __fadd_rn(psum, __shfl_xor_sync(0xffffffffu, psum, 1));
      psum = __fadd_rn(psum, __shfl_xor_sync(0xffffffffu, psum, 2));
      ll[r] = __fmaf_rn(alpha, ll[r], psum);
      mm[r] = m_new;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        oo[j][2 * r] = __fmul_rn(oo[j][2 * r], alpha);
        oo[j][2 * r + 1] = __fmul_rn(oo[j][2 * r + 1], alpha);
      }
    }
    // O += P V: P rounded to bf16 (after v_scale in int8-KV mode) as the A
    // fragments of the KT / 16 k16 key steps.
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16x2(sc[2 * kk][0], sc[2 * kk][1]),
                              pack_bf16x2(sc[2 * kk][2], sc[2 * kk][3]),
                              pack_bf16x2(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                              pack_bf16x2(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int jp = 0; jp < ND / 2; ++jp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, sv + (16 * kk + (lane & 15)) * L::RS + 16 * jp + (lane >> 4) * 8);
        mma_bf16(oo[2 * jp], pa, bv[0], bv[1]);
        mma_bf16(oo[2 * jp + 1], pa, bv[2], bv[3]);
      }
    }
  };

  for (int tile = first, it = 0; tile < tile_end; tile += G, ++it) {
    unsigned char* st = stages + (it & 1) * L::STAGE_BYTES;
    if (tile + G < tile_end) load_tile(tile + G, stages + ((it + 1) & 1) * L::STAGE_BYTES);
    cp_async_commit();
    cp_async_wait<1>();
    group_sync(kg);  // this tile is in place for the whole group
    const __nv_bfloat16 *sk, *sv;
    const float* scales = reinterpret_cast<const float*>(st + 2 * L::RAW_BYTES);
    if constexpr (QUANT) {
      // the stage's int8 K and V as exact bf16, 16 bytes a thread a turn
      constexpr int PPR = D / 16;
      for (int i = gtid; i < 2 * KT * PPR; i += GNT) {
        const int which = i / (KT * PPR), r = i / PPR % KT, ch = i % PPR;
        const uint4 w = *reinterpret_cast<const uint4*>(st + which * L::RAW_BYTES + r * D + ch * 16);
        const uint32_t words[4] = {w.x, w.y, w.z, w.w};
        uint32_t pairs[8];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pairs[2 * e] = int8_pair(__byte_perm(words[e], 0, 0x0100));
          pairs[2 * e + 1] = int8_pair(__byte_perm(words[e], 0, 0x0302));
        }
        uint4* dst = reinterpret_cast<uint4*>(conv + which * KT * L::RS + r * L::RS + ch * 16);
        dst[0] = make_uint4(pairs[0], pairs[1], pairs[2], pairs[3]);
        dst[1] = make_uint4(pairs[4], pairs[5], pairs[6], pairs[7]);
      }
      group_sync(kg);
      sk = conv;
      sv = conv + KT * L::RS;
    } else {
      sk = reinterpret_cast<const __nv_bfloat16*>(st);
      sv = reinterpret_cast<const __nv_bfloat16*>(st + L::RAW_BYTES);
    }
    if (warp_live) {
      if constexpr (G == 1) {
        if (tile & 1) attend(tile * KT, sk, sv, scales, o[NS - 1], m_run[NS - 1], l_run[NS - 1]);
        else attend(tile * KT, sk, sv, scales, o[0], m_run[0], l_run[0]);
      } else {
        attend(tile * KT, sk, sv, scales, o[0], m_run[0], l_run[0]);
      }
    }
    group_sync(kg);  // every warp of the group is done with this stage before it is refilled
  }

  // The odd state: this thread's second state (G = 1), or group 1's, which
  // it leaves in shared memory, field f of thread i at [f][i] (G = 2).
  float* part = reinterpret_cast<float*>(mma_smem + L::Q_BYTES);
  if constexpr (G == 2) {
    cp_async_wait<0>();
    __syncthreads();  // both groups are done with their stages
    if (kg == 1) {
      part[0 * GNT + gtid] = m_run[0][0];
      part[1 * GNT + gtid] = m_run[0][1];
      part[2 * GNT + gtid] = l_run[0][0];
      part[3 * GNT + gtid] = l_run[0][1];
#pragma unroll
      for (int j = 0; j < ND; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[(4 + 4 * j + e) * GNT + gtid] = o[0][j][e];
    }
    __syncthreads();
    if (kg == 1) return;
  }
  auto odd = [&](int f, float reg) { return G == 1 ? reg : part[f * GNT + gtid]; };

  // Merge, even state first: out = (O0 a0 + O1 a1) / (l0 a0 + l1 a1), in bf16,
  // two columns a store.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m1 = odd(r, m_run[NS - 1][r]), l1 = odd(2 + r, l_run[NS - 1][r]);
    const float m = fmaxf(m_run[0][r], m1);
    const float a0 = m_run[0][r] == -INFINITY ? 0.f : exp2f(__fsub_rn(m_run[0][r], m));
    const float a1 = m1 == -INFINITY ? 0.f : exp2f(__fsub_rn(m1, m));
    const float l = __fmaf_rn(l_run[0][r], a0, __fmul_rn(l1, a1));
    const int t = wr0 + gq + 8 * r;
    if (!row_live[r]) continue;
    const int s = t / g.rep, h = head_kv * g.rep + t % g.rep;
    const float inv = 1.f / fmaxf(l, 1e-30f);
    uint32_t* dst = reinterpret_cast<uint32_t*>(out + ((size_t)s * g.hq + h) * D + 2 * qq);
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      float y[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float o1 = odd(4 + 4 * j + 2 * r + e, o[NS - 1][j][2 * r + e]);
        y[e] = __fmul_rn(__fmaf_rn(o[0][j][2 * r + e], a0, __fmul_rn(o1, a1)), inv);
      }
      dst[4 * j] = pack_bf16x2(y[0], y[1]);
    }
  }
}

struct Pointers {
  const void *q, *k, *v, *k_scale, *v_scale, *kv_len, *tables;
  void* out;
};

template <typename T, typename KV, int D>
cudaError_t launch_fma(const Pointers& a, int lanes, int hkv, const Geometry& g,
                       cudaStream_t stream) {
  constexpr int smem =
      (BR * (D + 1) + BK * (D + 1) + BK * D + BR * (BK + 1) + 2 * BK) * sizeof(float) +
      BK * sizeof(int);
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(lookahead_attention_kernel<T, KV, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid((g.s_len * g.rep + BR - 1) / BR, hkv, lanes);
  lookahead_attention_kernel<T, KV, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const KV*>(a.k), static_cast<const KV*>(a.v),
      static_cast<const float*>(a.k_scale), static_cast<const float*>(a.v_scale),
      static_cast<const int*>(a.kv_len), static_cast<const int*>(a.tables),
      static_cast<T*>(a.out), g);
  return cudaGetLastError();
}

template <typename KV, int D, int G>
cudaError_t launch_mma_g(const Pointers& a, int lanes, int hkv, const Geometry& g,
                         int spec_words, cudaStream_t stream) {
  using L = MmaLayout<KV, D, G>;
  // composite mode: the mask words of every query position a block's rows hold
  const int smem = L::FIXED_BYTES + ((MBR - 1) / g.rep + 2) * spec_words * 4;
  static int configured = 48 * 1024;
  if (smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(attention_mma_kernel<KV, D, G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = smem;
  }
  const dim3 grid((g.s_len * g.rep + MBR - 1) / MBR, hkv, lanes);
  attention_mma_kernel<KV, D, G><<<grid, GNT * G, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const KV*>(a.k),
      static_cast<const KV*>(a.v), static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale), static_cast<const int*>(a.kv_len),
      static_cast<const int*>(a.tables), static_cast<__nv_bfloat16*>(a.out), g, spec_words);
  return cudaGetLastError();
}

// Two key groups a block where the grid leaves SMs without a block (the
// flat calls), one where it does not (the paged call of several lanes):
// the same bits either way. D = 256: always two (one state a thread).
template <typename KV, int D>
cudaError_t launch_mma(const Pointers& a, int lanes, int hkv, const Geometry& g,
                       cudaStream_t stream) {
  const int spec_words = g.causal ? 0 : (g.row0 + g.s_len + 31) / 32;
  if constexpr (D > 128) {
    return launch_mma_g<KV, D, 2>(a, lanes, hkv, g, spec_words, stream);
  } else {
    int sms = 0;
    const cudaError_t e = sm_count(&sms);
    if (e != cudaSuccess) return e;
    const long long blocks = (long long)((g.s_len * g.rep + MBR - 1) / MBR) * hkv * lanes;
    if (blocks <= sms) return launch_mma_g<KV, D, 2>(a, lanes, hkv, g, spec_words, stream);
    return launch_mma_g<KV, D, 1>(a, lanes, hkv, g, spec_words, stream);
  }
}

// float32 q: the FMA kernel; bfloat16 q: the mma kernel.
template <typename T, typename KV, int D>
cudaError_t launch(const Pointers& a, int lanes, int hkv, const Geometry& g, cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) return launch_fma<T, KV, D>(a, lanes, hkv, g, stream);
  else return launch_mma<KV, D>(a, lanes, hkv, g, stream);
}

template <typename T, typename KV>
cudaError_t launch_d(int d, const Pointers& a, int lanes, int hkv, const Geometry& g,
                     cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, KV, 32>(a, lanes, hkv, g, stream);
    case 48: return launch<T, KV, 48>(a, lanes, hkv, g, stream);
    case 64: return launch<T, KV, 64>(a, lanes, hkv, g, stream);
    case 80: return launch<T, KV, 80>(a, lanes, hkv, g, stream);
    case 96: return launch<T, KV, 96>(a, lanes, hkv, g, stream);
    case 112: return launch<T, KV, 112>(a, lanes, hkv, g, stream);
    case 128: return launch<T, KV, 128>(a, lanes, hkv, g, stream);
    case 256: return launch<T, KV, 256>(a, lanes, hkv, g, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_kv(int kv_int8, int d, const Pointers& a, int lanes, int hkv,
                      const Geometry& g, cudaStream_t stream) {
  if (kv_int8) return launch_d<T, signed char>(d, a, lanes, hkv, g, stream);
  return launch_d<T, T>(d, a, lanes, hkv, g, stream);
}

}  // namespace

// dtype (of q and out): 0 float32, 1 bfloat16. q [lanes, S, Hq, D]; k/v
// [Hkv, pool_slots, D] of q's type, or int8 with float32 k_scale/v_scale
// [Hkv, pool_slots] when kv_int8 is 1 (the scales are not read otherwise);
// kv_len [lanes] int32 on the device; out [lanes, S, Hq*D]; all contiguous.
// Flat call: lanes 1, tables null, page_size 0, nb 0, m = pool_slots = M.
// Paged call: tables [lanes, nb] int32 on the device, m = nb * page_size
// logical columns, pool_slots a multiple of page_size. Returns the CUDA
// error code of the launch (0 on success).
extern "C" int lookahead_attention_launch(const void* q, const void* k, const void* v,
                                          const void* k_scale, const void* v_scale,
                                          const void* kv_len, const void* tables, void* out,
                                          int dtype, int kv_int8, int lanes, int s_len, int hq,
                                          int hkv, int m, int pool_slots, int page_size, int nb,
                                          int d, int level, int window, int guess_size,
                                          int causal, int sliding_window, int row0,
                                          void* stream) {
  if (lanes <= 0 || s_len <= 0 || hkv <= 0 || hq % hkv != 0 || row0 < 0)
    return (int)cudaErrorInvalidValue;
  if (kv_int8 && (k_scale == nullptr || v_scale == nullptr)) return (int)cudaErrorInvalidValue;
  if (page_size < 0 || (page_size > 0 && (tables == nullptr || nb <= 0 || m != nb * page_size)))
    return (int)cudaErrorInvalidValue;
  if (page_size == 0 && (lanes != 1 || m != pool_slots)) return (int)cudaErrorInvalidValue;
  const Pointers a = {q, k, v, k_scale, v_scale, kv_len, tables, out};
  Geometry g;
  g.s_len = s_len;
  g.rep = hq / hkv;
  g.hq = hq;
  g.m = m;
  g.pool_slots = pool_slots;
  g.page_size = page_size;
  g.nb = nb;
  g.level = level;
  g.window = window;
  g.guess_size = guess_size;
  g.causal = causal;
  g.sliding_window = sliding_window;
  g.row0 = row0;
  g.scale_log2 = 1.4426950408889634f / sqrtf((float)d);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (dtype) {
    case 0: e = launch_kv<float>(kv_int8, d, a, lanes, hkv, g, st); break;
    case 1: e = launch_kv<__nv_bfloat16>(kv_int8, d, a, lanes, hkv, g, st); break;
    default: e = cudaErrorInvalidValue;
  }
  return (int)e;
}
