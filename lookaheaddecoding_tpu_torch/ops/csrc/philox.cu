// The decode state's random stream: Philox4x32-10 (Salmon et al., SC'11;
// the Random123 library) for B lanes, each under its own key and draw
// counter. The counterpart of the JAX package's jax.random draws from
// DecodeState.rng (lookaheaddecoding_tpu/core/step.py:104, :207, :217;
// ops/sampling.py:77-104), which XLA computes on the TPU inside the jitted
// step. It replaces no Pallas kernel: the port needs it because a CUDA-graph
// replay, and every iteration of a WHILE node, must draw from the state's
// current counter, which no host-side generator can give it.
//
// philox_launch(key, draws, out, lanes, n, tag, raw, stream):
//   key    int32 [lanes, 2]: lane b's key, two u32 words (low first)
//   draws  int64 [lanes]:    lane b's counter, read here from device memory
//                            (never a launch argument, so a captured launch
//                            sees the value the step left on each replay)
//   out    [lanes, n]: float32 uniforms u = (w >> 8) * 2^-24, or, when raw
//          is set, the int32 bits of the u32 words w
//   word k of block j of lane b is element 4j + k of row b:
//     Philox4x32-10(counter = (j, draws_lo, draws_hi, tag), key[b])
// Returns the cudaError_t of the launch.
//
// One thread a block of four outputs, 256 threads a block, grid (blocks
// of a row / 256, lanes). The work is ten rounds of two 32x32 -> 64-bit
// products a thread: a few hundred integer operations for 16 bytes
// written. At the main path's size (192,140 uniforms a lane, B = 1 to 4:
// 0.77 to 3.1 MB) the bound is the write, some 0.23 to 0.92 us at
// 3.35 TB/s, below a launch; the kernel's design is simply to write
// whole rows with 16-byte stores when the row length allows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += kW0;
      k.y += kW1;
    }
    const uint32_t hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
    const uint32_t hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

__device__ __forceinline__ float to_uniform(uint32_t w) {
  return (float)(w >> 8) * (1.0f / 16777216.0f);
}

__global__ void philox_kernel(const int* __restrict__ key,
                              const long long* __restrict__ draws,
                              void* __restrict__ out, int n, uint32_t tag,
                              int raw) {
  const int lane = blockIdx.y;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int blocks = (n + 3) / 4;
  if (j >= blocks) return;
  const unsigned long long d = (unsigned long long)draws[lane];
  const uint2 k = make_uint2((uint32_t)key[2 * lane],
                             (uint32_t)key[2 * lane + 1]);
  const uint4 w = philox4x32_10(
      make_uint4((uint32_t)j, (uint32_t)d, (uint32_t)(d >> 32), tag), k);
  const long long base = (long long)lane * n + 4LL * j;
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
  if (raw) {
    int* o = static_cast<int*>(out) + base;
    if ((n & 3) == 0) {
      *reinterpret_cast<int4*>(o) = make_int4((int)w.x, (int)w.y,
                                              (int)w.z, (int)w.w);
    } else {
      for (int q = 0; q < 4 && 4 * j + q < n; ++q) o[q] = (int)words[q];
    }
  } else {
    float* o = static_cast<float*>(out) + base;
    if ((n & 3) == 0) {
      *reinterpret_cast<float4*>(o) =
          make_float4(to_uniform(w.x), to_uniform(w.y), to_uniform(w.z),
                      to_uniform(w.w));
    } else {
      for (int q = 0; q < 4 && 4 * j + q < n; ++q) o[q] = to_uniform(words[q]);
    }
  }
}

}  // namespace

extern "C" int philox_launch(const void* key, const void* draws, void* out,
                             int lanes, int n, int tag, int raw,
                             void* stream) {
  if (lanes <= 0 || n <= 0) return 0;
  const int threads = 256;
  const int blocks = (n + 3) / 4;
  const dim3 grid((blocks + threads - 1) / threads, lanes);
  philox_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(key), static_cast<const long long*>(draws), out,
      n, (uint32_t)tag, raw);
  return (int)cudaGetLastError();
}
