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
// What bounds them on an H100 SXM (3.35 TB/s; 67 TFLOP/s float32 outside
// the tensor cores, 989 TFLOP/s bfloat16 inside them): the autoregressive
// call (T = 1) reads every weight byte once and does two operations a
// weight, so it is bound by bytes: (K, N) = (2048, 5632) is 11.5 MB as
// int8 (3.4 us) and 5.8 MB as int4 (1.7 us). The composite call (T = 240)
// does 2*240*K*N = 5.5 GFLOP on the same bytes, bound by operations for a
// float32 x (83 us) and by bytes for a bfloat16 x on the tensor cores.
//
// What this design does about that: it is the simple correct version. The
// TPU grid ran in order and carried the sum from one K step to the next;
// here a block owns an output tile [BT, 64], loops over K inside the block,
// keeps the float32 sum in registers and applies scale[n] at the end.
// Weight tiles are read once a block with 16-byte loads along N, converted
// (int8) or unpacked (int4: low nibble ((b & 15) ^ 8) - 8, high nibble by
// an arithmetic shift of the signed byte) into float32 tiles in shared
// memory, and the products are per-thread float32 FMAs from there. They
// never reach the tensor cores, so a bfloat16 composite call stays far
// above its bound; mma/wgmma tiles and TMA loads are later work.
//
// Every output element is one chain acc = fmaf(x[t, k], w[k, n], acc) over
// ascending k (int4: packed row r gives the low-nibble term, then the
// high-nibble term), whatever T and whatever the tile shape: the one-row
// autoregressive call and a row of the composite call give the same bits,
// and the pipelined int4 kernel gives the plain int4 kernel's bits. There
// is no split over K, so a one-row call runs N/64 blocks and is bound by
// the length of that chain, not by the card's memory rate.
//
// Two tile shapes: T <= 8 runs [4 rows, 64 columns] tiles with one output a
// thread (one chain a thread, deep K tiles); larger T runs [64, 64] tiles
// with 4 x 4 outputs a thread. In the one-row variant the threads of rows
// past T fill the tiles with the others and skip the FMAs: at T = 1 their
// shared-memory reads were as much of the time as the chain itself.
//
// The pipelined variant moves packed tiles through a two-stage ring in
// shared memory filled by cp.async: while the FMAs of tile k run, tile k+1
// is unpacked into the second set of float32 tiles and tile k+2 is in
// flight.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (lookaheaddecoding_tpu_torch/ops/_build.py).

#include "quant_matmul.cuh"

namespace {

template <typename T>
cudaError_t launch_dtype(int mode, const void* x, const void* w, const void* scale, void* out,
                         const Problem& p, cudaStream_t stream) {
  switch (mode) {
    case INT8: return launch_mode<T, INT8>(x, w, scale, out, p, stream);
    case INT4: return launch_mode<T, INT4>(x, w, scale, out, p, stream);
    case INT4_PIPE: return launch_mode<T, INT4_PIPE>(x, w, scale, out, p, stream);
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
