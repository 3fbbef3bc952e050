// Pieces shared by the belief-sweep kernels: the float32 kernels (denoise_sweep.cu,
// denoise_sweep_v2.cu) use all of it; the bfloat16 kernels (denoise_sweep_bf16.cu) use the
// constants, activations and the Philox draw.
//
// Block plan of the float32 kernels: TB batch rows per block, THREADS threads; activations
// live in shared memory (or, for v2's wide modulation output, in a per-block device-memory
// scratch) and weights are streamed from global memory (L2-resident at the widths the port
// serves). Products and sums in float32. Biases, LayerNorm, silu(cond), the score clip and
// the p_sample update are float32 in every kernel.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace aid {

constexpr int TB = 16;        // batch rows per block; ROWS_PER_BLOCK in ops/denoise.py
constexpr int THREADS = 256;  // threads per block, 8 warps
constexpr float LN_EPS = 1e-6f;

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

enum Epilogue { EPI_STORE = 0, EPI_ADD = 1, EPI_GELU = 2, EPI_SILU = 3 };

__device__ __forceinline__ float silu(float x) { return x / (1.f + expf(-x)); }

__device__ __forceinline__ float gelu_tanh(float x) {
  const float k = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.f + tanhf(k * (x + 0.044715f * x * x * x)));
}

template <int E>
__device__ __forceinline__ void store(float* y, float v) {
  if (E == EPI_STORE) *y = v;
  if (E == EPI_ADD) *y += v;
  if (E == EPI_GELU) *y = gelu_tanh(v);
  if (E == EPI_SILU) *y = silu(v);
}

// How one matmul operand pair is read for a stored weight type (float32 only).
template <typename WT>
struct Operand;

template <>
struct Operand<float> {
  static __device__ __forceinline__ float w(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ float x(float v) { return v; }
};

// y[r, c] (E)= bias[c] + sum_k x[r, k] * W[k, c] for all TB rows and c < out.
// x is in shared memory (row stride ldx, ldx % 4 == 0); W (in, out) and bias are in global
// memory; y (row stride ldy) is in shared memory or in the block's device scratch.
// Thread item = (column c, row group g): it owns rows g*RPT..g*RPT+RPT-1, so neighbouring
// threads read neighbouring weight columns (coalesced) and narrow outputs split the rows.
template <typename WT, int RPT, int E>
__device__ __forceinline__ void mm_rows(const float* __restrict__ x, int ldx, int in,
                                        const WT* __restrict__ W,
                                        const float* __restrict__ bias, int out,
                                        float* __restrict__ y, int ldy) {
  using Op = Operand<WT>;
  constexpr int G = TB / RPT;
  for (int item = threadIdx.x; item < out * G; item += THREADS) {
    const int c = item % out;
    const int r0 = (item / out) * RPT;
    const WT* w = W + c;
    float acc[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) acc[r] = 0.f;
    int k = 0;
    for (; k + 4 <= in; k += 4) {
      const float w0 = Op::w(w + (size_t)(k + 0) * out);
      const float w1 = Op::w(w + (size_t)(k + 1) * out);
      const float w2 = Op::w(w + (size_t)(k + 2) * out);
      const float w3 = Op::w(w + (size_t)(k + 3) * out);
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const float4 xv = *reinterpret_cast<const float4*>(x + (r0 + r) * ldx + k);
        acc[r] = fmaf(Op::x(xv.x), w0, acc[r]);
        acc[r] = fmaf(Op::x(xv.y), w1, acc[r]);
        acc[r] = fmaf(Op::x(xv.z), w2, acc[r]);
        acc[r] = fmaf(Op::x(xv.w), w3, acc[r]);
      }
    }
    for (; k < in; ++k) {
      const float w0 = Op::w(w + (size_t)k * out);
#pragma unroll
      for (int r = 0; r < RPT; ++r) acc[r] = fmaf(Op::x(x[(r0 + r) * ldx + k]), w0, acc[r]);
    }
    const float b = bias ? __ldg(bias + c) : 0.f;
#pragma unroll
    for (int r = 0; r < RPT; ++r) store<E>(y + (size_t)(r0 + r) * ldy + c, acc[r] + b);
  }
}

// Split the TB rows into as many row groups as one pass of the block's threads holds.
template <typename WT, int E>
__device__ __forceinline__ void mm(const float* x, int ldx, int in, const WT* W,
                                   const float* bias, int out, float* y, int ldy) {
  if (out * 16 <= THREADS) mm_rows<WT, 1, E>(x, ldx, in, W, bias, out, y, ldy);
  else if (out * 8 <= THREADS) mm_rows<WT, 2, E>(x, ldx, in, W, bias, out, y, ldy);
  else if (out * 4 <= THREADS) mm_rows<WT, 4, E>(x, ldx, in, W, bias, out, y, ldy);
  else if (out * 2 <= THREADS) mm_rows<WT, 8, E>(x, ldx, in, W, bias, out, y, ldy);
  else mm_rows<WT, 16, E>(x, ldx, in, W, bias, out, y, ldy);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// x[r, :] = LN(h[r, :]) * (1 + mod[r, :H]) + mod[r, H:2H], LN without affine; a warp per
// row. `mod` has row stride ldm and may lie in the block's device scratch, written earlier
// in this launch: it is read with plain (coherent) loads, never __ldg, and carries no
// __restrict__.
__device__ __forceinline__ void adaln(const float* __restrict__ h, const float* mod, int ldm,
                                      float* __restrict__ x, int H) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < TB; r += THREADS / 32) {
    const float* hr = h + r * H;
    float s = 0.f;
    for (int c = lane; c < H; c += 32) s += hr[c];
    const float mean = warp_sum(s) / H;
    float v = 0.f;
    for (int c = lane; c < H; c += 32) {
      const float d = hr[c] - mean;
      v += d * d;
    }
    const float rstd = rsqrtf(warp_sum(v) / H + LN_EPS);
    const float* mr = mod + (size_t)r * ldm;
    for (int c = lane; c < H; c += 32)
      x[r * H + c] = (hr[c] - mean) * rstd * (1.f + mr[c]) + mr[H + c];
  }
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

// Load the block's rows of z0 (zeros past B and in the padded columns).
__device__ __forceinline__ void load_latent(const float* __restrict__ z0, float* z, int row0,
                                            int B, int D, int Dp) {
  for (int i = threadIdx.x; i < TB * Dp; i += THREADS) {
    const int r = i / Dp, c = i % Dp, row = row0 + r;
    z[i] = (row < B && c < D) ? z0[(size_t)row * D + c] : 0.f;
  }
}

// sc = silu(obs_emb + t_emb) for the block's rows at one step.
__device__ __forceinline__ void load_cond(const float* __restrict__ obs_emb,
                                          const float* __restrict__ te, float* sc, int row0,
                                          int B, int H) {
  for (int i = threadIdx.x; i < TB * H; i += THREADS) {
    const int r = i / H, c = i % H, row = row0 + r;
    sc[i] = silu((row < B ? obs_emb[(size_t)row * H + c] : 0.f) + te[c]);
  }
}

// The p_sample update of step s with the clipped, scaled score (coefficient row cf).
__device__ __forceinline__ void p_sample_update(float* z, const float* score, const float* cf,
                                                int Dp, int D, float mult, int stochastic,
                                                unsigned seed, int row0, int s) {
  const float s1 = cf[0], s2 = cf[1], c1 = cf[2], c2 = cf[3], sd = cf[4], mask = cf[5];
  for (int i = threadIdx.x; i < TB * D; i += THREADS) {
    const int r = i / D, c = i % D;
    const float zi = z[r * Dp + c];
    const float sco = fminf(fmaxf(score[r * Dp + c], -10.f), 10.f) * mult;
    const float pz0 = (zi + s1 * sco) * s2;
    float m = c1 * pz0 + c2 * zi;
    if (stochastic && mask != 0.f) m += mask * sd * philox_normal(seed, row0 + r, s, c);
    z[r * Dp + c] = m;
  }
}

// Store the block's rows of the final latent.
__device__ __forceinline__ void store_latent(const float* z, float* __restrict__ out, int row0,
                                             int B, int D, int Dp) {
  for (int i = threadIdx.x; i < TB * D; i += THREADS) {
    const int r = i / D, c = i % D, row = row0 + r;
    if (row < B) out[(size_t)row * D + c] = z[r * Dp + c];
  }
}

}  // namespace aid
