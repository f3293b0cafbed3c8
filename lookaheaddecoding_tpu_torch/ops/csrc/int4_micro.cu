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
// a GPU blocks run in no order, so the same schedule is a split over K:
// a block owns (K slab, N tile, row tile), sums its slab as the int4 chain
// does (ascending packed row, low nibble then high) and writes the partial
// sum to a float32 workspace [slabs, T, N]; a second small kernel adds the
// slabs in slab order, applies the scale and writes y. The order of the
// sum is fixed (no atomics), and the slab size depends on nothing but the
// launch argument, so a row alone gives the bits of the same row among
// many. Its sum is grouped otherwise than the int4 kernel's, so the two
// differ in the last float32 bits.
//
// What bounds them on an H100 SXM: as the int4 kernel, the T <= 8 call is
// bound by the weight's bytes (K*N/2 at 3.35 TB/s: 1.7 us at (2048, 5632));
// the K-outer variant also writes and reads slabs * T * N * 4 bytes of
// partial sums. The split is what lets a one-row call fill the card: the
// int4 kernel's float32 design runs N/64 blocks, this one slabs times as
// many (the bfloat16 tensor-core design narrows its tiles instead).
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
  return launch_kouter<T>(x, w, scale, out, part, p, slab_rows, stream);
}

}  // namespace

// variant: 0 shift decode, 1 K-outer. dtype: 0 float32, 1 bfloat16.
// x [t, k], w int8 [w_rows, n] with w_rows >= k2 = k/2, scale float32 [n],
// out [t, n]; all contiguous, w 16-byte aligned, n a multiple of 16. The
// K-outer variant also takes part, float32 [ceil(k2 / slab_rows), t, n], and
// slab_rows, a positive multiple of 64. Returns the CUDA error code of the
// launch (0 on success).
extern "C" int int4_micro_launch(const void* x, const void* w, const void* scale, void* out,
                                 void* part, int variant, int dtype, int t, int k, int n,
                                 int w_rows, int k2, int slab_rows, void* stream) {
  if (t <= 0 || k <= 0 || n <= 0 || n % 16 != 0) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(w) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  if (k % 2 != 0 || k2 != k / 2 || w_rows < k2) return (int)cudaErrorInvalidValue;
  if (variant != 0 && variant != 1) return (int)cudaErrorInvalidValue;
  if (variant == 1 && (part == nullptr || slab_rows <= 0 || slab_rows % 64 != 0))
    return (int)cudaErrorInvalidValue;
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
