// Tiles, loaders and the product kernels shared by quant_matmul.cu (the
// int8, int4 and pipelined int4 products) and int4_micro.cu (the int4
// product's micro-benchmark variants). See quant_matmul.cu for what the
// kernels compute and what bounds them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Tile knobs of the one-row variant (T <= 8), for
// scripts/torch_matmul_tile_sweep.py, which builds this file with other
// values and times them; the defaults are what the package runs.
#ifndef QM_ROW_BN
#define QM_ROW_BN 64  // output columns a block: 64, 32 or 16
#endif
#ifndef QM_SKIP_DEAD_ROWS
// threads whose rows lie past T skip the FMAs: 0 nowhere, 1 in the one-row
// variant, 2 in the [64, 64] variant too (slower there: see PERF.md)
#define QM_SKIP_DEAD_ROWS 1
#endif

constexpr int NT = 256;  // threads a block

// INT4_SHIFT is INT4 with the nibbles decoded by 32-bit shifts
// (int4_micro.cu); the tiles and the order of the sum are INT4's.
constexpr int INT8 = 0, INT4 = 1, INT4_PIPE = 2, INT4_SHIFT = 3;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

struct Problem {
  int t, k, n;
  int k_lim;  // weight rows that meet x: K (int8) or K/2 (int4)
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Signed byte j of a 32-bit word.
__device__ __forceinline__ int sbyte(uint32_t w, int j) {
  return (int)(w << (24 - 8 * j)) >> 24;
}

// Tile geometry of one kernel variant. BT rows x BN columns a block, BK
// stored weight rows a K tile, RT x CT outputs a thread.
template <int MODE, int BT, int BN_, int BK, int RT, int CT>
struct Geo {
  static constexpr int BN = BN_;                         // output columns a block
  static constexpr int BNP = BN + 4;                     // weight tile row stride (floats)
  static constexpr int NCH = BN / 16;                    // 16-byte pieces a weight-tile row
  static constexpr int NP = MODE == INT8 ? 1 : 2;        // weight planes, x halves
  static constexpr int TXN = BN / CT;                    // thread columns
  static constexpr int BTP = RT == 4 ? BT + 4 : BT;      // x tile row stride
  static constexpr int W_CHUNKS = BK * NCH;              // 16-byte pieces a tile
  static constexpr int WCH = (W_CHUNKS + NT - 1) / NT;   // pieces a thread
  static constexpr int XE = NP * BT * BK / NT;           // x elements a thread
  static constexpr int SW = NP * BK * BNP;               // floats: weight tiles
  static constexpr int SX = NP * BK * BTP;               // floats: x tiles
  static_assert(BN % 16 == 0, "weight rows are read in 16-byte pieces");
  static_assert(TXN * (BT / RT) == NT, "thread grid must cover the tile");
  static_assert((NP * BT * BK) % NT == 0, "x tile must split over the threads");
  static_assert(RT == 1 || RT == 4, "rows a thread");
  static_assert(CT == 1 || CT == 4, "columns a thread");
};

// 16 packed bytes of weight-tile piece c -> float32 in the weight tile(s).
template <typename G, int MODE>
__device__ __forceinline__ void store_w_piece(float* sw, int c, const uint4& v, int bk) {
  const int row = c / G::NCH, col = (c % G::NCH) * 16;
  const uint32_t words[4] = {v.x, v.y, v.z, v.w};
  float* lo = sw + row * G::BNP + col;
  float* hi = lo + bk * G::BNP;  // second plane (int4 only)
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    float a[4], b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int byte = sbyte(words[w], j);
      if (MODE == INT4_SHIFT) {
        // both nibbles straight from the 32-bit word: left to the top of
        // the word, then an arithmetic shift back (sign extension)
        a[j] = (float)((int)(words[w] << (28 - 8 * j)) >> 28);
        b[j] = (float)((int)(words[w] << (24 - 8 * j)) >> 28);
      } else if (MODE == INT8) {
        a[j] = (float)byte;
        b[j] = 0.f;
      } else {
        a[j] = (float)(((byte & 15) ^ 8) - 8);  // low nibble, sign-extended
        b[j] = (float)(byte >> 4);              // high nibble, arithmetic shift
      }
    }
    *reinterpret_cast<float4*>(lo + 4 * w) = make_float4(a[0], a[1], a[2], a[3]);
    if (MODE != INT8) *reinterpret_cast<float4*>(hi + 4 * w) = make_float4(b[0], b[1], b[2], b[3]);
  }
}

// Address and validity of weight-tile piece c of the K tile at stored row
// row0, for output columns from n0.
template <typename G>
__device__ __forceinline__ const signed char* w_piece(const signed char* w, int c, int row0,
                                                      int n0, const Problem& p) {
  const int gr = row0 + c / G::NCH, gc = n0 + (c % G::NCH) * 16;
  return (gr < p.k_lim && gc < p.n) ? w + (size_t)gr * p.n + gc : nullptr;
}

template <typename G>
__device__ __forceinline__ void load_w_regs(uint4 (&r)[G::WCH], const signed char* w, int row0,
                                            int n0, const Problem& p) {
#pragma unroll
  for (int i = 0; i < G::WCH; ++i) {
    const int c = threadIdx.x + i * NT;
    const signed char* src = c < G::W_CHUNKS ? w_piece<G>(w, c, row0, n0, p) : nullptr;
    r[i] = src ? *reinterpret_cast<const uint4*>(src) : make_uint4(0, 0, 0, 0);
  }
}

template <typename G, int MODE, int BK>
__device__ __forceinline__ void store_w_regs(float* sw, const uint4 (&r)[G::WCH]) {
#pragma unroll
  for (int i = 0; i < G::WCH; ++i) {
    const int c = threadIdx.x + i * NT;
    if (c < G::W_CHUNKS) store_w_piece<G, MODE>(sw, c, r[i], BK);
  }
}

// x elements of the K tile at column k0 (of each half, for int4): element
// idx of a thread is (half, row, column) with the column fastest, so a warp
// reads along K. Columns past k_lim and rows past T read as zero.
template <typename T, typename G, int BT, int BK>
__device__ __forceinline__ void load_x_regs(T (&r)[G::XE], const T* x, int t0, int k0,
                                            const Problem& p) {
#pragma unroll
  for (int i = 0; i < G::XE; ++i) {
    const int idx = threadIdx.x + i * NT;
    const int half = idx / (BT * BK), rem = idx % (BT * BK);
    const int gt = t0 + rem / BK, kk = k0 + rem % BK;
    r[i] = (gt < p.t && kk < p.k_lim) ? x[(size_t)gt * p.k + half * p.k_lim + kk]
                                       : from_f<T>(0.f);
  }
}

// The x tiles are stored transposed, [half][k][row], so a thread reads its
// rows of one k as one vector.
template <typename T, typename G, int BT, int BK>
__device__ __forceinline__ void store_x_regs(float* sx, const T (&r)[G::XE]) {
#pragma unroll
  for (int i = 0; i < G::XE; ++i) {
    const int idx = threadIdx.x + i * NT;
    const int half = idx / (BT * BK), rem = idx % (BT * BK);
    sx[(half * BK + rem % BK) * G::BTP + rem / BK] = to_f<T>(r[i]);
  }
}

template <int R>
__device__ __forceinline__ void load_vec(float (&out)[R], const float* p) {
  if constexpr (R == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  } else {
    out[0] = p[0];
  }
}

// One K tile of the chain: ascending stored row, low plane before high.
template <typename G, int BK, int RT, int CT>
__device__ __forceinline__ void fma_tile(float (&acc)[RT][CT], const float* sw, const float* sx,
                                         int ty, int tx) {
#pragma unroll 8
  for (int kk = 0; kk < BK; ++kk) {
#pragma unroll
    for (int h = 0; h < G::NP; ++h) {
      float a[RT], b[CT];
      load_vec<RT>(a, sx + (h * BK + kk) * G::BTP + ty * RT);
      load_vec<CT>(b, sw + (h * BK + kk) * G::BNP + tx * CT);
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

template <typename T, int RT, int CT>
__device__ __forceinline__ void write_out(T* out, const float* scale, const float (&acc)[RT][CT],
                                          int t0, int n0, int ty, int tx, const Problem& p) {
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int gt = t0 + ty * RT + i;
    if (gt >= p.t) continue;
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      const int gn = n0 + tx * CT + j;
      if (gn < p.n) out[(size_t)gt * p.n + gn] = from_f<T>(acc[i][j] * scale[gn]);
    }
  }
}

// int8 and int4 products. Grid (column tiles, row tiles). The next tile's
// global loads go into registers before the FMAs of this tile run.
template <typename T, int MODE, int BT, int BN, int BK, int RT, int CT>
__global__ void __launch_bounds__(NT)
quant_matmul_kernel(const T* __restrict__ x, const signed char* __restrict__ w,
                    const float* __restrict__ scale, T* __restrict__ out, Problem p) {
  using G = Geo<MODE, BT, BN, BK, RT, CT>;
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  float* sw = reinterpret_cast<float*>(smem_bytes);  // [NP][BK][BNP]
  float* sx = sw + G::SW;                            // [NP][BK][BTP]

  const int tx = threadIdx.x % G::TXN, ty = threadIdx.x / G::TXN;
  const int n0 = blockIdx.x * BN, t0 = blockIdx.y * BT;
  const int n_tiles = (p.k_lim + BK - 1) / BK;
  // a thread whose rows all lie past T has no output: it fills the tiles
  // with the others and skips the FMAs and their shared-memory reads
  constexpr bool SKIP = QM_SKIP_DEAD_ROWS == 2 || (QM_SKIP_DEAD_ROWS == 1 && RT == 1);
  const bool live = !SKIP || t0 + ty * RT < p.t;

  float acc[RT][CT];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < CT; ++j) acc[i][j] = 0.f;

  uint4 wr[G::WCH];
  T xr[G::XE];
  load_w_regs<G>(wr, w, 0, n0, p);
  load_x_regs<T, G, BT, BK>(xr, x, t0, 0, p);
  for (int tile = 0; tile < n_tiles; ++tile) {
    __syncthreads();  // the previous tile's FMAs are done
    store_w_regs<G, MODE, BK>(sw, wr);
    store_x_regs<T, G, BT, BK>(sx, xr);
    __syncthreads();
    if (tile + 1 < n_tiles) {
      load_w_regs<G>(wr, w, (tile + 1) * BK, n0, p);
      load_x_regs<T, G, BT, BK>(xr, x, t0, (tile + 1) * BK, p);
    }
    if (live) fma_tile<G, BK, RT, CT>(acc, sw, sx, ty, tx);
  }
  write_out<T, RT, CT>(out, scale, acc, t0, n0, ty, tx, p);
}

// Packed tile `tile` into ring stage `stage` by cp.async; pieces outside
// the weight are zero-filled.
template <typename G, int BK>
__device__ __forceinline__ void ring_fill(unsigned char* stage, const signed char* w, int tile,
                                          int n0, const Problem& p) {
#pragma unroll
  for (int i = 0; i < G::WCH; ++i) {
    const int c = threadIdx.x + i * NT;
    if (c >= G::W_CHUNKS) continue;
    const signed char* src = w_piece<G>(w, c, tile * BK, n0, p);
    if (src) {
      cp_async16(stage + c * 16, src);
    } else {
      *reinterpret_cast<uint4*>(stage + c * 16) = make_uint4(0, 0, 0, 0);
    }
  }
  cp_async_commit();
}

template <typename T, typename G, int BT, int BK>
__device__ __forceinline__ void unpack_tile(float* sw, float* sx, const unsigned char* stage,
                                            const T* x, int t0, int tile, const Problem& p) {
#pragma unroll
  for (int i = 0; i < G::WCH; ++i) {
    const int c = threadIdx.x + i * NT;
    if (c < G::W_CHUNKS)
      store_w_piece<G, INT4>(sw, c, *reinterpret_cast<const uint4*>(stage + c * 16), BK);
  }
  T xr[G::XE];
  load_x_regs<T, G, BT, BK>(xr, x, t0, tile * BK, p);
  store_x_regs<T, G, BT, BK>(sx, xr);
}

// Pipelined int4 product: two ring stages of packed bytes and two sets of
// float32 tiles. In the interval of tile k the threads unpack tile k+1,
// run the FMAs of tile k, and the copy of tile k+2 is in flight.
template <typename T, int BT, int BN, int BK, int RT, int CT>
__global__ void __launch_bounds__(NT)
int4_matmul_pipe_kernel(const T* __restrict__ x, const signed char* __restrict__ w,
                        const float* __restrict__ scale, T* __restrict__ out, Problem p) {
  using G = Geo<INT4_PIPE, BT, BN, BK, RT, CT>;
  constexpr int SET = G::SW + G::SX;  // floats of one set of tiles
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  float* tiles = reinterpret_cast<float*>(smem_bytes);                    // [2][SET]
  unsigned char* ring = smem_bytes + 2 * SET * sizeof(float);             // [2][BK*BN]

  const int tx = threadIdx.x % G::TXN, ty = threadIdx.x / G::TXN;
  const int n0 = blockIdx.x * BN, t0 = blockIdx.y * BT;
  const int n_tiles = (p.k_lim + BK - 1) / BK;
  // a thread whose rows all lie past T has no output: it fills the tiles
  // with the others and skips the FMAs and their shared-memory reads
  constexpr bool SKIP = QM_SKIP_DEAD_ROWS == 2 || (QM_SKIP_DEAD_ROWS == 1 && RT == 1);
  const bool live = !SKIP || t0 + ty * RT < p.t;

  float acc[RT][CT];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < CT; ++j) acc[i][j] = 0.f;

  ring_fill<G, BK>(ring, w, 0, n0, p);
  cp_async_wait_all();
  __syncthreads();
  unpack_tile<T, G, BT, BK>(tiles, tiles + G::SW, ring, x, t0, 0, p);
  if (n_tiles > 1) ring_fill<G, BK>(ring + BK * BN, w, 1, n0, p);

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int cur = tile & 1, nxt = cur ^ 1;
    // after this barrier: tile+1's bytes have landed in stage nxt, the
    // float tiles of set cur are written, the FMAs of tile-1 on set nxt are
    // done, and stage cur (unpacked in the interval before) is free
    cp_async_wait_all();
    __syncthreads();
    if (tile + 2 < n_tiles) ring_fill<G, BK>(ring + cur * BK * BN, w, tile + 2, n0, p);
    if (tile + 1 < n_tiles) {
      float* set = tiles + nxt * SET;
      unpack_tile<T, G, BT, BK>(set, set + G::SW, ring + nxt * BK * BN, x, t0, tile + 1, p);
    }
    const float* set = tiles + cur * SET;
    if (live) fma_tile<G, BK, RT, CT>(acc, set, set + G::SW, ty, tx);
  }
  write_out<T, RT, CT>(out, scale, acc, t0, n0, ty, tx, p);
}

template <typename K>
cudaError_t configure(K kernel, int smem, bool* configured) {
  if (*configured || smem <= 48 * 1024) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) *configured = true;
  return e;
}

template <typename T, int MODE, int BT, int BN, int BK, int RT, int CT>
cudaError_t launch_tile(const void* x, const void* w, const void* scale, void* out,
                        const Problem& p, cudaStream_t stream) {
  using G = Geo<MODE, BT, BN, BK, RT, CT>;
  const dim3 grid((p.n + BN - 1) / BN, (p.t + BT - 1) / BT);
  static bool configured = false;
  if constexpr (MODE == INT4_PIPE) {
    constexpr int smem = 2 * (G::SW + G::SX) * (int)sizeof(float) + 2 * BK * BN;
    cudaError_t e = configure(int4_matmul_pipe_kernel<T, BT, BN, BK, RT, CT>, smem, &configured);
    if (e != cudaSuccess) return e;
    int4_matmul_pipe_kernel<T, BT, BN, BK, RT, CT><<<grid, NT, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const signed char*>(w),
        static_cast<const float*>(scale), static_cast<T*>(out), p);
  } else {
    constexpr int smem = (G::SW + G::SX) * (int)sizeof(float);
    cudaError_t e = configure(quant_matmul_kernel<T, MODE, BT, BN, BK, RT, CT>, smem, &configured);
    if (e != cudaSuccess) return e;
    quant_matmul_kernel<T, MODE, BT, BN, BK, RT, CT><<<grid, NT, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const signed char*>(w),
        static_cast<const float*>(scale), static_cast<T*>(out), p);
  }
  return cudaGetLastError();
}

// T <= 8: [256 / QM_ROW_BN, QM_ROW_BN] tiles ([4, 64] as built by the
// package), one output a thread, deep K tiles (128 int8 rows, 64 packed
// rows). Larger T: [64, 64] tiles, 4 x 4 outputs a thread, 32 stored rows a
// K tile.
template <typename T, int MODE>
cudaError_t launch_mode(const void* x, const void* w, const void* scale, void* out,
                        const Problem& p, cudaStream_t stream) {
  constexpr int BK_SMALL = MODE == INT8 ? 128 : 64;
  constexpr int BN_ROW = QM_ROW_BN;
  if (p.t <= 8)
    return launch_tile<T, MODE, NT / BN_ROW, BN_ROW, BK_SMALL, 1, 1>(x, w, scale, out, p, stream);
  return launch_tile<T, MODE, 64, 64, 32, 4, 4>(x, w, scale, out, p, stream);
}

}  // namespace
