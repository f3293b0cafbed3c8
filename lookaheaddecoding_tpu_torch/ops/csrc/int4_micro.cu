// Two variants of the int4 unpack-matmul for Hopper (sm_90a), CUDA C++, for
// the micro-benchmark scripts/torch_int4_micro.py.
//
// Replaces the two Pallas bodies of scripts/int4_micro.py:
//   - _kernel_shift: the int4 product with both nibbles sign-extended by
//     32-bit shifts ((p << 28) >> 28 and p >> 4), K blocks inner;
//   - kern (shift_matmul(kb_outer=True)): the same unpack with K blocks
//     outer and a full-width [T, N] float32 accumulator.
// Both compute y = (x[:, :K/2] @ lo + x[:, K/2:] @ hi) * scale on the
// split-half packed weight of ops/quant.py, as quant_matmul.cu's int4
// kernel does; see there for the formats.
//
// Shift variant: the int4 kernel with the decode of a packed 32-bit word
// done by shifts of the word itself (each nibble moved to the top of the
// word, then shifted back arithmetically) instead of the int4 kernel's own
// decode. In bfloat16 it is quant_matmul_mma.cuh's tensor-core kernel with
// the shift decode policy (the int4 kernel uses the magic-number one); in
// float32 it is quant_matmul.cuh's FMA kernel with shifts in place of byte
// extraction and ((b & 15) ^ 8) - 8. Both decodes give the same exact
// values into the same order of the sum, so the result is the int4
// kernel's bit for bit in either type; the question it answers is whether
// the decode costs time.
//
// K-outer variant: on the TPU the grid ran in order, so "K blocks outer"
// meant every N block of K slab 0, then slab 1, into a [T, N] scratch. On
// a GPU blocks run in no order, so the same schedule is a split over K
// into slabs of slab_rows packed rows (256 from the wrapper), each slab's
// partial sum taken in float32 from zero, the partials added in an order
// fixed by K alone. Two designs, by x's dtype:
//   - bfloat16 x (int4_kouter_mma_kernel): one launch, no workspace. A
//     slab's partial runs on the tensor cores through B7 shift's template
//     (quant_matmul_mma.cuh, DEC_SHIFT): per k16 step in ascending k the
//     lo-plane product, then the hi-plane product. The slabs are dealt in
//     contiguous runs to the KS blocks of a thread-block cluster (rank r:
//     slabs [r slabs / KS, (r + 1) slabs / KS)), KS the largest power of
//     two up to min(slabs, 8); a block adds its slabs' partials in slab
//     order and the cluster adds the blocks' sums in rank order through
//     distributed shared memory (B4's finish). Where KS = slabs (at most 8,
//     a power of two: K = 2048 has 4) that is the strict slab-order fold of
//     the plain version; where a rank holds several slabs (K = 5632: 11
//     slabs on 8 ranks; K = 11008: 22) the fold is grouped by rank. Tiles
//     of 16 rows by 128, 64, 32 or 16 columns, as B4's small ones; they
//     choose no part of the sum.
//   - float32 x (int4_kouter_partial_kernel): the FMA design. A block
//     owns (K slab, N tile, row tile), sums its slab as the int4 chain does
//     (ascending packed row, low nibble then high) into a float32 workspace
//     [slabs, T, N], and a second small kernel adds the slabs in slab
//     order, applies the scale and writes y.
// Either way the order of the sum depends on K alone, never on T or on the
// card, so a row alone gives the bits of the same row among many. It is
// grouped otherwise than the int4 kernel's, so the two differ in the last
// float32 bits.
//
// What bounds them on an H100 SXM: as the int4 kernel, the T <= 8 call is
// bound by the weight's bytes (K*N/2 at 3.35 TB/s: 1.7 us at (2048, 5632));
// the float32 K-outer design also writes and reads slabs * T * N * 4 bytes
// of partial sums. The split is what lets a one-row call fill the card: at
// T = 8 on (2048, 5632) the bfloat16 design runs 44 column tiles of 128 on
// each of 4 ranks, 176 blocks of one slab each.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (lookaheaddecoding_tpu_torch/ops/_build.py).

#include <type_traits>

#include "quant_matmul.cuh"
#include "quant_matmul_mma.cuh"

namespace {

// One K slab of the product: the tiles of quant_matmul_kernel over packed
// rows [slab * slab_rows, (slab + 1) * slab_rows), the float32 partial sum
// written unscaled to part[slab, t, n]. Grid (column tiles, row tiles,
// slabs). slab_rows is a multiple of BK, so no tile straddles two slabs.
template <typename T, int BT, int BN, int BK, int RT, int CT>
__global__ void __launch_bounds__(NT)
int4_kouter_partial_kernel(const T* __restrict__ x, const signed char* __restrict__ w,
                           float* __restrict__ part, Problem p, int slab_rows) {
  using G = Geo<INT4_SHIFT, BT, BN, BK, RT, CT>;
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  float* sw = reinterpret_cast<float*>(smem_bytes);  // [2][BK][BNP]
  float* sx = sw + G::SW;                            // [2][BK][BTP]

  const int tx = threadIdx.x % G::TXN, ty = threadIdx.x / G::TXN;
  const int n0 = blockIdx.x * BN, t0 = blockIdx.y * BT;
  const int row_begin = blockIdx.z * slab_rows;
  const int row_end = min(row_begin + slab_rows, p.k_lim);
  const int n_tiles = (row_end - row_begin + BK - 1) / BK;
  const bool live = RT != 1 || t0 + ty * RT < p.t;

  float acc[RT][CT];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < CT; ++j) acc[i][j] = 0.f;

  uint4 wr[G::WCH];
  T xr[G::XE];
  load_w_regs<G>(wr, w, row_begin, n0, p);
  load_x_regs<T, G, BT, BK>(xr, x, t0, row_begin, p);
  for (int tile = 0; tile < n_tiles; ++tile) {
    __syncthreads();  // the previous tile's FMAs are done
    store_w_regs<G, INT4_SHIFT, BK>(sw, wr);
    store_x_regs<T, G, BT, BK>(sx, xr);
    __syncthreads();
    if (tile + 1 < n_tiles) {
      load_w_regs<G>(wr, w, row_begin + (tile + 1) * BK, n0, p);
      load_x_regs<T, G, BT, BK>(xr, x, t0, row_begin + (tile + 1) * BK, p);
    }
    if (live) fma_tile<G, BK, RT, CT>(acc, sw, sx, ty, tx);
  }
  float* dst = part + (size_t)blockIdx.z * p.t * p.n;
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int gt = t0 + ty * RT + i;
    if (gt >= p.t) continue;
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      const int gn = n0 + tx * CT + j;
      if (gn < p.n) dst[(size_t)gt * p.n + gn] = acc[i][j];
    }
  }
}

// y[t, n] = (part[0, t, n] + part[1, t, n] + ...) * scale[n], slabs added
// in slab order. One thread an output.
template <typename T>
__global__ void __launch_bounds__(NT)
int4_kouter_reduce_kernel(const float* __restrict__ part, const float* __restrict__ scale,
                          T* __restrict__ out, int slabs, int t, int n) {
  const size_t total = (size_t)t * n;
  const size_t idx = (size_t)blockIdx.x * NT + threadIdx.x;
  if (idx >= total) return;
  float sum = part[idx];
  for (int s = 1; s < slabs; ++s) sum += part[(size_t)s * total + idx];
  out[idx] = from_f<T>(sum * scale[idx % n]);
}

template <typename T, int BT, int BN, int BK, int RT, int CT>
cudaError_t launch_kouter_tile(const void* x, const void* w, float* part, const Problem& p,
                               int slab_rows, int slabs, cudaStream_t stream) {
  using G = Geo<INT4_SHIFT, BT, BN, BK, RT, CT>;
  if (slab_rows % BK != 0) return cudaErrorInvalidValue;
  constexpr int smem = (G::SW + G::SX) * (int)sizeof(float);
  static bool configured = false;
  cudaError_t e =
      configure(int4_kouter_partial_kernel<T, BT, BN, BK, RT, CT>, smem, &configured);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.n + BN - 1) / BN, (p.t + BT - 1) / BT, slabs);
  int4_kouter_partial_kernel<T, BT, BN, BK, RT, CT><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const signed char*>(w), part, p, slab_rows);
  return cudaGetLastError();
}

// The int4 kernel's two tile shapes: [4, 64] with one output a thread for
// T <= 8, [64, 64] with 4 x 4 outputs a thread above.
template <typename T>
cudaError_t launch_kouter(const void* x, const void* w, const void* scale, void* out,
                          float* part, const Problem& p, int slab_rows, cudaStream_t stream) {
  const int slabs = (p.k_lim + slab_rows - 1) / slab_rows;
  cudaError_t e =
      p.t <= 8 ? launch_kouter_tile<T, 4, 64, 64, 1, 1>(x, w, part, p, slab_rows, slabs, stream)
               : launch_kouter_tile<T, 64, 64, 32, 4, 4>(x, w, part, p, slab_rows, slabs, stream);
  if (e != cudaSuccess) return e;
  const size_t total = (size_t)p.t * p.n;
  int4_kouter_reduce_kernel<T><<<(unsigned)((total + NT - 1) / NT), NT, 0, stream>>>(
      part, static_cast<const float*>(scale), static_cast<T*>(out), slabs, p.t, p.n);
  return cudaGetLastError();
}

// The bfloat16 K-outer product on the tensor cores. Grid (column tiles,
// row tiles, KS), a cluster of the KS blocks along z. Block rank r walks
// the ring tiles (BK2 packed rows) of its run of slabs as quant_mma_kernel
// walks its chunks, takes each slab's partial in acc from zero and adds it
// to sum at the slab's last tile; finish adds the ranks' sums in rank order.
template <typename G, int KS>
__global__ void __launch_bounds__(G::NTH)
int4_kouter_mma_kernel(const __nv_bfloat16* __restrict__ x, const signed char* __restrict__ w,
                       const float* __restrict__ scale, __nv_bfloat16* __restrict__ out,
                       Problem p, int x_vec, int slab_tiles) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / G::WARPS_N, wn = warp % G::WARPS_N;
  const int n0 = blockIdx.x * G::BN, t0 = blockIdx.y * G::BM;
  const int n_steps = (p.k_lim + 15) / 16;  // the chain's k16 steps: K alone sets them
  constexpr int SPT = G::BK2 / 16;
  // this rank's run of slabs, in ring tiles: K alone sets it
  const int k_tiles = (p.k_lim + G::BK2 - 1) / G::BK2;
  const int slabs = (k_tiles + slab_tiles - 1) / slab_tiles;
  const int rank = KS > 1 ? (int)blockIdx.z : 0;
  const int first = rank * slabs / KS * slab_tiles;
  const int n_local = min((rank + 1) * slabs / KS * slab_tiles, k_tiles) - first;
  const Filler<G> fill(t0, n0, p);

#pragma unroll
  for (int s = 0; s < G::STAGES - 1; ++s) {
    if (s < n_local) fill(smem_bytes + s * G::STAGE_BYTES, x, w, first + s, p, x_vec);
    cp_async_commit();
  }
  float acc[G::MT][G::NT8][4] = {}, sum[G::MT][G::NT8][4] = {};
  for (int lt = 0; lt < n_local; ++lt) {
    cp_async_wait<G::STAGES - 2>();
    __syncthreads();  // lt's stage has landed; lt - 1's stage is free
    const int nt = lt + G::STAGES - 1;
    if (nt < n_local)
      fill(smem_bytes + (nt % G::STAGES) * G::STAGE_BYTES, x, w, first + nt, p, x_vec);
    cp_async_commit();
    const int tile = first + lt;
    mma_tile_regs<G, DEC_SHIFT>(acc, smem_bytes + (lt % G::STAGES) * G::STAGE_BYTES,
                                n_steps - tile * SPT, wm, wn, lane);
    if ((tile + 1) % slab_tiles == 0 || lt + 1 == n_local) {
      // the slab's partial into the run's sum, in slab order
#pragma unroll
      for (int mi = 0; mi < G::MT; ++mi)
#pragma unroll
        for (int j = 0; j < G::NT8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sum[mi][j][e] = __fadd_rn(sum[mi][j][e], acc[mi][j][e]);
            acc[mi][j][e] = 0.f;
          }
    }
  }
  finish<G, KS>(sum, smem_bytes, out, scale, t0, n0, wm, wn, lane, p);
}

template <typename G, int KS>
cudaError_t launch_kouter_mma_tile(const void* x, const void* w, const void* scale, void* out,
                                   const Problem& p, bool x_vec, int slab_rows,
                                   cudaStream_t stream) {
  if (slab_rows % G::BK2 != 0) return cudaErrorInvalidValue;
  constexpr int ring = G::STAGES * G::STAGE_BYTES;
  constexpr int smem = ring > G::RED_BYTES ? ring : G::RED_BYTES;
  static bool configured = false;
  return launch_tiles<G, KS>(int4_kouter_mma_kernel<G, KS>, smem, &configured, x, w, scale, out,
                             p, stream, (int)x_vec, slab_rows / G::BK2);
}

// 16-row tiles, the widest of 128, 64, 32 and 16 columns that leaves at
// most an eighth of the SMs without a block (B4's rule for its small tiles).
template <int KS>
cudaError_t launch_kouter_ks(const void* x, const void* w, const void* scale, void* out,
                             const Problem& p, bool x_vec, int slab_rows, int sms,
                             cudaStream_t stream) {
  constexpr int SS = QM_MMA_SMALL_STAGES;
  auto fills = [&](int bn) {
    return (long long)(p.t + 15) / 16 * ((p.n + bn - 1) / bn) * KS >= sms - sms / 8;
  };
  if (fills(128))
    return launch_kouter_mma_tile<MmaGeo<16, 128, 1, 4, 32, SS>, KS>(x, w, scale, out, p, x_vec,
                                                                     slab_rows, stream);
  if (fills(64))
    return launch_kouter_mma_tile<MmaGeo<16, 64, 1, 2, 32, SS>, KS>(x, w, scale, out, p, x_vec,
                                                                    slab_rows, stream);
  if (fills(32))
    return launch_kouter_mma_tile<MmaGeo<16, 32, 1, 1, 32, SS>, KS>(x, w, scale, out, p, x_vec,
                                                                    slab_rows, stream);
  return launch_kouter_mma_tile<MmaGeo<16, 16, 1, 1, 32, SS>, KS>(x, w, scale, out, p, x_vec,
                                                                  slab_rows, stream);
}

// KS, the ranks of the cluster: the largest power of two up to the slab
// count and 8 (a portable cluster), so every rank holds a slab.
cudaError_t launch_kouter_mma(const void* x, const void* w, const void* scale, void* out,
                              const Problem& p, int slab_rows, cudaStream_t stream) {
  // the fill keeps 32-bit element offsets into x
  if ((long long)p.t * p.k >= (1LL << 31)) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0) return cudaErrorMisalignedAddress;
  const bool x_vec = p.k_lim % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  int sms = 0;
  const cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  const int slabs = (p.k_lim + slab_rows - 1) / slab_rows;
  switch (slabs >= 8 ? 8 : slabs >= 4 ? 4 : slabs >= 2 ? 2 : 1) {
    case 8: return launch_kouter_ks<8>(x, w, scale, out, p, x_vec, slab_rows, sms, stream);
    case 4: return launch_kouter_ks<4>(x, w, scale, out, p, x_vec, slab_rows, sms, stream);
    case 2: return launch_kouter_ks<2>(x, w, scale, out, p, x_vec, slab_rows, sms, stream);
    default: return launch_kouter_ks<1>(x, w, scale, out, p, x_vec, slab_rows, sms, stream);
  }
}

template <typename T>
cudaError_t launch_variant(int variant, const void* x, const void* w, const void* scale,
                           void* out, float* part, const Problem& p, int slab_rows,
                           cudaStream_t stream) {
  if (variant == 0) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value)
      return launch_mma<false, DEC_SHIFT>(x, w, scale, out, p, stream);
    else
      return launch_mode<T, INT4_SHIFT>(x, w, scale, out, p, stream);
  }
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return launch_kouter_mma(x, w, scale, out, p, slab_rows, stream);
  else
    return launch_kouter<T>(x, w, scale, out, part, p, slab_rows, stream);
}

}  // namespace

// variant: 0 shift decode, 1 K-outer. dtype: 0 float32, 1 bfloat16.
// x [t, k], w int8 [w_rows, n] with w_rows >= k2 = k/2, scale float32 [n],
// out [t, n]; all contiguous, w 16-byte aligned, n a multiple of 16. The
// K-outer variant also takes slab_rows, a positive multiple of 64, and in
// float32 part, float32 [ceil(k2 / slab_rows), t, n] (bfloat16 needs no
// workspace: part may be null). Returns the CUDA error code of the launch
// (0 on success).
extern "C" int int4_micro_launch(const void* x, const void* w, const void* scale, void* out,
                                 void* part, int variant, int dtype, int t, int k, int n,
                                 int w_rows, int k2, int slab_rows, void* stream) {
  if (t <= 0 || k <= 0 || n <= 0 || n % 16 != 0) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(w) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  if (k % 2 != 0 || k2 != k / 2 || w_rows < k2) return (int)cudaErrorInvalidValue;
  if (variant != 0 && variant != 1) return (int)cudaErrorInvalidValue;
  if (variant == 1 && (slab_rows <= 0 || slab_rows % 64 != 0)) return (int)cudaErrorInvalidValue;
  if (variant == 1 && dtype == 0 && part == nullptr) return (int)cudaErrorInvalidValue;
  Problem p;
  p.t = t;
  p.k = k;
  p.n = n;
  p.k_lim = k2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(part);
  cudaError_t e;
  switch (dtype) {
    case 0: e = launch_variant<float>(variant, x, w, scale, out, ws, p, slab_rows, st); break;
    case 1:
      e = launch_variant<__nv_bfloat16>(variant, x, w, scale, out, ws, p, slab_rows, st);
      break;
    default: e = cudaErrorInvalidValue;
  }
  return (int)e;
}
