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
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): at
// the headline composite call (S=240, Hq=32, Hkv=4, D=64, kv_len=512, so
// 752 live columns) it moves q 0.98 MB + live K/V 0.77 MB + out 0.98 MB
// ~= 2.7 MB (~0.8 us). Its rows see 124,980 (row, key) pairs (240*512
// committed, 2,100 of the sparse within-composite mask), so it does
// 4*64*32*124,980 ~= 1.02 GFLOP (~1.04 us): compute-bound at ~1.04 us a
// call, 22 calls a decode step. The paged call of four lanes does four
// times that work on four times the bytes.
//
// What this design does about that bound: this first version is the simple
// correct kernel, not a fast one. It never reads a KV tile past the last
// live column of its rows (nor below the sliding window), so its work and
// traffic follow the live context and not the cache capacity; K/V tiles
// are read once per block of 64 query rows. The products are per-thread
// fp32 FMAs from shared memory (4 rows x 8 columns per thread), which
// reach a small share of the tensor-core bound; mma/wgmma tiles, TMA loads
// and a split over KV for single-row calls are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (lookaheaddecoding_tpu_torch/ops/_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

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
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <> __device__ __forceinline__ float to_f<signed char>(signed char x) { return (float)x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as a TPU astype
}

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

__device__ __forceinline__ bool visible(int s, int c, int kv_len, const Geometry& g) {
  const int sw = g.sliding_window;
  if (g.causal) return c <= kv_len + s && (sw == 0 || c > kv_len + s - sw);
  if (c < kv_len) return sw == 0 || c > kv_len + rel_pos(s, g) - sw;
  const int rj = c - kv_len;
  return rj < g.s_len && spec_visible(s, rj, g);
}

// Grid (row tiles, KV heads, lanes). Block: NT threads, BR GQA rows t = s*rep + r
// of KV head blockIdx.y; thread (ty, tx) owns rows ty*RPT + i and, in each
// KV tile, key columns tx + TX*j and output dims tx + TX*j. KV is T, or
// signed char in int8-KV mode (then k_scale and v_scale are read).
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
  const int col_end = min(kv_len + s_hi + 1, g.m);
  int col_begin = 0;
  if (g.sliding_window) {
    col_begin = max(kv_len + (g.causal ? s_lo : 0) - g.sliding_window + 1, 0);
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
        const bool vis = t < n_rows && c < g.m && visible(s, c, kv_len, g);
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

struct Pointers {
  const void *q, *k, *v, *k_scale, *v_scale, *kv_len, *tables;
  void* out;
};

template <typename T, typename KV, int D>
cudaError_t launch(const Pointers& a, int lanes, int hkv, const Geometry& g, cudaStream_t stream) {
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

template <typename T, typename KV>
cudaError_t launch_d(int d, const Pointers& a, int lanes, int hkv, const Geometry& g,
                     cudaStream_t stream) {
  switch (d) {
    case 64: return launch<T, KV, 64>(a, lanes, hkv, g, stream);
    case 128: return launch<T, KV, 128>(a, lanes, hkv, g, stream);
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
                                          int causal, int sliding_window, void* stream) {
  if (lanes <= 0 || s_len <= 0 || hkv <= 0 || hq % hkv != 0) return (int)cudaErrorInvalidValue;
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
