// Quantized-weight matrix products for Hopper (sm_90a), CUDA C++.
//
// Replaces the three Pallas bodies of
// lookaheaddecoding_tpu/ops/quant_matmul.py:
//   - _int8_kernel  (int8_matmul):  y = (x @ q) * scale
//   - _kernel       (int4_matmul):  y = (x[:, :K/2] @ lo + x[:, K/2:] @ hi)
//                                       * scale
//   - _kernel_pipe  (int4_matmul, pipeline=True): the same product with the
//     unpack of one K block overlapping the product of the block before.
// x [T, K] float32 or bfloat16; q int8 [K, N]; q4 int8 [K2p, N], split-half
// packed (byte row r = input row r in the low nibble, input row r + K/2 in
// the high nibble, zero rows from K/2 to K2p); scale float32 [1, N]; the
// sum is float32, the scale is applied once after it, y is in x's type.
//
// What bounds them on an H100 SXM (3.35 TB/s; 989 TFLOP/s bfloat16 on the
// tensor cores, 67 TFLOP/s float32 outside them): a call with few rows
// (T <= ~64) reads every weight byte once for 2T operations a weight, so it
// is bound by bytes: (K, N) = (2048, 11264) is 11.5 MB as int4 (3.5 us at
// T = 1). The composite call (T = 240) does 2*240*K*N = 11.1 GFLOP on the
// same bytes: bound by operations, 11 us on the tensor cores in bfloat16,
// 166 us for a float32 x outside them.
//
// bfloat16 x (quant_matmul_mma.cuh): every product runs on the tensor
// cores, mma.sync m16n8k16 bf16 x bf16 -> f32, as the TPU bodies'
// dot_generals with preferred_element_type=float32 ran on its matrix unit
// (the int8 body casts its block to x's type first). A nibble (-8..7) and
// a byte (-128..127) are exact in bf16, so every product is exact in
// float32. The weight bytes and the halves of x (two for int4, one for
// int8) come through a ring of shared memory by cp.async, 16-byte pieces
// zero-filled past k_lim and N (x element by element where k_lim is not a
// multiple of 8), so the ring holds bytes, not float32 expansions; x rows
// are swizzled rather than padded. int4 (B4) turns each warp's B fragments
// into bf16 pairs in registers with the magic-number decode; the same byte
// feeds the lo-plane mma (against x's first half) and the hi-plane mma
// (against the second). int8 (B3) decodes a byte in registers too, split
// into its two nibbles and joined by two exact fma.rn.bf16x2 (int8_pair:
// bf16 has too few bits for one magic constant over 256 values); one mma a
// k16 step. Pipelined int4
// (B5) decodes packed tile k+1 into one of two bf16 plane buffers, in B4's
// column order, while the mma of tile k read the other by ldmatrix.trans:
// the TPU body's double buffer. K is cut into chunks (32 packed int4 rows,
// 64 int8 rows), dealt out to the KS blocks of a thread-block cluster (KS =
// 4 from 4096 input rows, K/2 >= 2048 for int4 and K >= 4096 for int8, and
// for a weight of N <= 512 from 1024 input rows; else 1), whose partial
// sums are added in rank order through distributed shared memory, 16 bytes
// a thread: a one-row call of a long K, or any call of a narrow weight,
// gets KS times the blocks, and a composite call reads x no more often
// than one block would. Tile shapes follow T and N: T <= 16 tiles of 16
// rows; larger T [64, 128] ([80, 128] where that fills the SMs better,
// [48, 128] where K is split), 4 warps of 64 (80, 48) x 32 outputs, so each
// decoded B fragment feeds four (five, three) m16 tiles, or [64, 64] where
// those give too few blocks, or 16-row tiles where even those leave half
// the SMs idle. The output leaves as 16-byte stores of 8 columns.
//
// The order of the sum is fixed by the weight's shape alone (K, and N
// through the split): within each cluster block,
// every output element takes, per k16 step of its chunks in ascending k,
// the lo-plane product and then the hi-plane product (int8: the one
// product of the step); the blocks' sums are
// then added in rank order. T, the tile shape and the ring depth choose
// none of it. So a row alone gives the bits of the same row among 240, and
// B5 gives B4's bits. y = bf16(sum * scale[n]), rounded once.
// A bfloat16 call of any T >= 1, any K and N a multiple of 16 runs here; a
// shape it refuses (T * K >= 2^31) raises in the wrapper, never falls back.
//
// float32 x (quant_matmul.cuh, the parity dtype): on the tensor cores it
// would go through TF32, so int4 and int8 stay float32 FMAs from shared
// memory, one chain acc = fmaf(x[t, k], w[k, n], acc) over ascending k
// (int4: the low-nibble term, then the high-nibble term, of packed row r).
// Two tile shapes:
// T <= 8 [4, 64] with one output a thread (threads of rows past T skip the
// FMAs), larger T [64, 64] with 4 x 4 outputs a thread; the pipelined int4
// variant moves packed tiles through a two-stage cp.async ring.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (lookaheaddecoding_tpu_torch/ops/_build.py).

#include <type_traits>

#include "quant_matmul.cuh"
#include "quant_matmul_mma.cuh"

namespace {

// float32 x: the FMA kernels, every mode; bfloat16 x: every mode on the
// tensor cores.
template <typename T>
cudaError_t launch_dtype(int mode, const void* x, const void* w, const void* scale, void* out,
                         const Problem& p, cudaStream_t stream) {
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  switch (mode) {
    case INT8:
      if constexpr (BF16) return launch_mma<false, DEC_INT8>(x, w, scale, out, p, stream);
      else return launch_mode<T, INT8>(x, w, scale, out, p, stream);
    case INT4:
      if constexpr (BF16) return launch_mma<false, DEC_MAGIC>(x, w, scale, out, p, stream);
      else return launch_mode<T, INT4>(x, w, scale, out, p, stream);
    case INT4_PIPE:
      if constexpr (BF16) return launch_mma<true, DEC_MAGIC>(x, w, scale, out, p, stream);
      else return launch_mode<T, INT4_PIPE>(x, w, scale, out, p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// mode: 0 int8, 1 int4, 2 pipelined int4. dtype: 0 float32, 1 bfloat16.
// x [t, k], w int8 [w_rows, n] (w_rows = k for int8; >= k2 = k/2 for int4),
// scale float32 [n], out [t, n]; all contiguous, w 16-byte aligned, n a
// multiple of 16. Returns the CUDA error code of the launch (0 on success).
extern "C" int quant_matmul_launch(const void* x, const void* w, const void* scale, void* out,
                                   int mode, int dtype, int t, int k, int n, int w_rows, int k2,
                                   void* stream) {
  if (t <= 0 || k <= 0 || n <= 0 || n % 16 != 0) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(w) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  Problem p;
  p.t = t;
  p.k = k;
  p.n = n;
  if (mode == INT8) {
    if (w_rows != k) return (int)cudaErrorInvalidValue;
    p.k_lim = k;
  } else {
    if (k % 2 != 0 || k2 != k / 2 || w_rows < k2) return (int)cudaErrorInvalidValue;
    p.k_lim = k2;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (dtype) {
    case 0: e = launch_dtype<float>(mode, x, w, scale, out, p, st); break;
    case 1: e = launch_dtype<__nv_bfloat16>(mode, x, w, scale, out, p, st); break;
    default: e = cudaErrorInvalidValue;
  }
  return (int)e;
}
