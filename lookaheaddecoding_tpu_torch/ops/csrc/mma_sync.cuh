// Device helpers shared by the port's kernels (quant_matmul.cuh,
// quant_matmul_mma.cuh, lookahead_attention.cu): cp.async copies into
// shared memory, ldmatrix and mma.sync.m16n8k16 bf16 x bf16 -> f32 (the
// fragment layouts are written out at the top of quant_matmul_mma.cuh), the
// exact int8 -> bf16 pair decode, and the device's SM count.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16-byte copy of which the first src_bytes come from gmem, the rest zero.
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

// 4-byte copy (.ca: 4 is not a size .cg takes), zero-filled like the above.
__device__ __forceinline__ void cp_async4_zfill(void* smem, const void* gmem, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a @ b on one m16n8k16 tile, float32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lower, float upper) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lower, upper);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d holds two int8 values in its bytes 0 and 2 (bytes 1 and 3 are not
// read): the two as a bf16 pair (lower half from byte 0), exactly. bf16 has
// 8 significant bits, so no one magic constant takes a byte's 256 values;
// the byte is split into its low nibble lo (0..15) and its signed high
// nibble h (-8..7), b = 16 h + lo. (lo | 0x4300) is bf16 128 + lo and
// ((h & 15) ^ 8) | 0x4300 is 136 + h; the first fma gives 16 (136 + h) -
// 2304 = 16 h - 128, the second (128 + lo) + (16 h - 128) = b. Each result
// is exact in bf16 (a multiple of 16 of magnitude at most 256, then an
// integer of magnitude at most 128), so neither fma rounds. The int8
// weight product (B3) and the attention kernel's int8 KV tiles use it.
__device__ __forceinline__ uint32_t int8_pair(uint32_t d) {
  constexpr uint32_t LO_MAGIC = 0x43004300u;    // bf16 128 twice; | the low nibble
  constexpr uint32_t HI_MAGIC = 0x43084308u;    // bf16 136 twice; ^ the high nibble
  constexpr uint32_t SIXTEEN = 0x41804180u;     // bf16 16 twice
  constexpr uint32_t MINUS_2304 = 0xC510C510u;  // bf16 -2304 twice
  constexpr uint32_t ONE = 0x3F803F80u;         // bf16 1.0 twice
  const uint32_t l = (d & 0x000F000Fu) | LO_MAGIC;
  const uint32_t h = ((d >> 4) & 0x000F000Fu) ^ HI_MAGIC;
  uint32_t a, b;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(a) : "r"(h), "r"(SIXTEEN), "r"(MINUS_2304));
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(b) : "r"(l), "r"(ONE), "r"(a));
  return b;
}

// The SMs of the current device, queried once a device: the query is host
// time that a one-row call would otherwise pay at every launch.
inline cudaError_t sm_count(int* sms) {
  static int cached[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && cached[dev] > 0) {
    *sms = cached[dev];
    return cudaSuccess;
  }
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && dev < 64) cached[dev] = *sms;
  return e;
}

}  // namespace
