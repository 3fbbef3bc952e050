// Pieces of the belief-sweep kernels (denoise_sweep_cluster.cu) that do not depend on the
// cluster plan: the tile and block sizes, the LayerNorm epsilon, the activations and the
// Philox draw. Biases, LayerNorm, silu(cond), the score clip and the p_sample update are
// float32 in every kernel.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace aid {

constexpr int TB = 16;        // batch rows per cluster (one m16 tile)
constexpr int THREADS = 256;  // threads per block, 8 warps
constexpr float LN_EPS = 1e-6f;

__device__ __forceinline__ float silu(float x) { return x / (1.f + expf(-x)); }

__device__ __forceinline__ float gelu_tanh(float x) {
  const float k = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.f + tanhf(k * (x + 0.044715f * x * x * x)));
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    if (i) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const unsigned hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// N(0, 1) for (row, column) at sweep step `step`; philox_normal() in ops/denoise.py is
// the same draw in plain tensor ops. Every sweep variant draws the same numbers.
__device__ __forceinline__ float philox_normal(unsigned seed, unsigned row, unsigned step,
                                               unsigned col) {
  const uint4 r = philox4x32_10(make_uint4(step, col, 0u, 0u), make_uint2(seed, row));
  const float u1 = (float)((r.x >> 8) + 1u) * (1.f / 16777216.f);  // (0, 1]
  const float u2 = (float)(r.y >> 8) * (1.f / 16777216.f);         // [0, 1)
  return sqrtf(-2.f * logf(u1)) * cosf(6.283185307179586f * u2);
}

}  // namespace aid
