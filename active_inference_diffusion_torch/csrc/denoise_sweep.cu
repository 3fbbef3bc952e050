// The fused K-step reverse-diffusion belief sweep, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel active_inference_diffusion_tpu/ops/denoise.py::_denoise_kernel
// (v1, reached through fused_denoise_sweep). One launch runs the whole sweep. Each block
// owns TB batch rows and loops over the K steps and the L DiT blocks itself:
//   cond = silu(obs_emb + t_emb[step])
//   h = latent_proj(z)
//   L x [ h += out_proj(v_proj(adaLN1(h))); h += fc2(gelu_tanh(fc1(adaLN2(h)))) ]
//   score = clip(out_fc2(silu(out_fc1(adaLN_final(h)))), +-10) * output_multiplier
//   z = c1 * (z + s1 * score) * s2 + c2 * z + noise_mask * sqrt(pv) * eps
// with eps from a counter-based Philox4x32-10 and Box-Muller, keyed by (seed, global row)
// and counted by (step, column), so the draw does not depend on TB.
//
// What bounds it on the card. At the flagship width (B 256, latent 32, hidden 128, L 6,
// K 25) the trunk is 1.42M f32 parameters (5.7 MB): far over one SM's 227 KB of shared
// memory, well inside the 50 MB L2. One sweep is ~18 GFLOP at B 256, a chain of
// K x (4L + 3) dependent matmuls of TB rows each. The TPU kernel kept all weights in VMEM;
// here they cannot stay on chip, so the bound is the dependent chain: per matmul, weights
// re-read from L2 and a block-wide barrier, with only ceil(B / TB) blocks in flight.
//
// What this simple design does about it. Weights are read once per matmul per block and
// reused across the block's TB rows (held in registers as TB/G accumulators); all
// activations (latent, residual stream, normalised input, silu(cond), modulation, MLP
// hidden) stay in shared memory for all K steps, so nothing but the final latent goes
// back to device memory. Thread items are (column, row group): neighbouring threads read
// neighbouring weight columns of the (in, out) layout, so every weight load is coalesced,
// and narrow outputs split the rows among more threads instead of idling them. Each
// thread accumulates in f32 in the order k = 0..in-1. No tensor cores, TMA or clusters
// yet: those are for later work.
//
// Plain C interface, bound from Python with ctypes (ops/_build.py, ops/denoise.py).

#include <cuda_runtime.h>
#include <stdint.h>

// Float offsets of each trunk array in the packed weight buffer. Same fields, same
// order as PACK_ORDER in ops/denoise.py. Per-layer arrays are stacked on a leading
// L axis; matmul weights are (in, out) row-major.
struct TrunkOffsets {
  long long lp_w, lp_b;
  long long mod1_w, mod1_b, v_w, v_b, o_w, o_b;
  long long mod2_w, mod2_b, f1_w, f1_b, f2_w, f2_b;
  long long modf_w, modf_b, out1_w, out1_b, out2_w;
};

namespace {

constexpr int TB = 16;        // batch rows per block; ROWS_PER_BLOCK in ops/denoise.py
constexpr int THREADS = 256;  // threads per block, 8 warps
constexpr float LN_EPS = 1e-6f;

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// Dynamic shared memory in floats; sweep_smem_bytes() in ops/denoise.py mirrors it.
__host__ __device__ inline size_t smem_floats(int D, int H) {
  return (size_t)TB * (2 * round4(D) + 9 * H);
}

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

// y[r, c] (E)= bias[c] + sum_k x[r, k] * W[k, c] for all TB rows and c < out.
// x and y are in shared memory (row strides ldx, ldy; ldx % 4 == 0), W (in, out) and bias
// in global memory. Thread item = (column c, row group g): it owns rows g*RPT..g*RPT+RPT-1.
template <int RPT, int E>
__device__ __forceinline__ void mm_rows(const float* __restrict__ x, int ldx, int in,
                                        const float* __restrict__ W,
                                        const float* __restrict__ bias, int out,
                                        float* __restrict__ y, int ldy) {
  constexpr int G = TB / RPT;
  for (int item = threadIdx.x; item < out * G; item += THREADS) {
    const int c = item % out;
    const int r0 = (item / out) * RPT;
    const float* w = W + c;
    float acc[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) acc[r] = 0.f;
    int k = 0;
    for (; k + 4 <= in; k += 4) {
      const float w0 = __ldg(w + (size_t)(k + 0) * out);
      const float w1 = __ldg(w + (size_t)(k + 1) * out);
      const float w2 = __ldg(w + (size_t)(k + 2) * out);
      const float w3 = __ldg(w + (size_t)(k + 3) * out);
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const float4 xv = *reinterpret_cast<const float4*>(x + (r0 + r) * ldx + k);
        acc[r] = fmaf(xv.x, w0, acc[r]);
        acc[r] = fmaf(xv.y, w1, acc[r]);
        acc[r] = fmaf(xv.z, w2, acc[r]);
        acc[r] = fmaf(xv.w, w3, acc[r]);
      }
    }
    for (; k < in; ++k) {
      const float w0 = __ldg(w + (size_t)k * out);
#pragma unroll
      for (int r = 0; r < RPT; ++r) acc[r] = fmaf(x[(r0 + r) * ldx + k], w0, acc[r]);
    }
    const float b = bias ? __ldg(bias + c) : 0.f;
#pragma unroll
    for (int r = 0; r < RPT; ++r) store<E>(y + (r0 + r) * ldy + c, acc[r] + b);
  }
}

// Split the TB rows into as many row groups as one pass of the block's threads holds.
template <int E>
__device__ __forceinline__ void mm(const float* x, int ldx, int in, const float* W,
                                   const float* bias, int out, float* y, int ldy) {
  if (out * 16 <= THREADS) mm_rows<1, E>(x, ldx, in, W, bias, out, y, ldy);
  else if (out * 8 <= THREADS) mm_rows<2, E>(x, ldx, in, W, bias, out, y, ldy);
  else if (out * 4 <= THREADS) mm_rows<4, E>(x, ldx, in, W, bias, out, y, ldy);
  else if (out * 2 <= THREADS) mm_rows<8, E>(x, ldx, in, W, bias, out, y, ldy);
  else mm_rows<16, E>(x, ldx, in, W, bias, out, y, ldy);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// x[r, :] = LN(h[r, :]) * (1 + mod[r, :H]) + mod[r, H:], LN without affine; a warp per row.
__device__ __forceinline__ void adaln(const float* __restrict__ h, const float* __restrict__ mod,
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
    const float* mr = mod + r * 2 * H;
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
// the same draw in plain tensor ops.
__device__ __forceinline__ float philox_normal(unsigned seed, unsigned row, unsigned step,
                                               unsigned col) {
  const uint4 r = philox4x32_10(make_uint4(step, col, 0u, 0u), make_uint2(seed, row));
  const float u1 = (float)((r.x >> 8) + 1u) * (1.f / 16777216.f);  // (0, 1]
  const float u2 = (float)(r.y >> 8) * (1.f / 16777216.f);         // [0, 1)
  return sqrtf(-2.f * logf(u1)) * cosf(6.283185307179586f * u2);
}

__global__ void __launch_bounds__(THREADS)
denoise_sweep_kernel(const float* __restrict__ z0,       // (B, D)
                     const float* __restrict__ obs_emb,  // (B, H)
                     const float* __restrict__ t_embs,   // (K, H), row s = timestep K-1-s
                     const float* __restrict__ coeffs,   // (K, 8): s1 s2 c1 c2 sd mask 0 0
                     const float* __restrict__ wbuf, TrunkOffsets off,
                     const long long* __restrict__ seed_ptr, float* __restrict__ out,
                     int B, int D, int H, int L, int K, float mult, int stochastic) {
  extern __shared__ __align__(16) float smem[];
  const int Dp = round4(D);
  const int H2 = 2 * H, H4 = 4 * H;
  float* z = smem;               // TB x Dp  latent
  float* score = z + TB * Dp;    // TB x Dp  score
  float* h = score + TB * Dp;    // TB x H   residual stream
  float* x = h + TB * H;         // TB x H   normalised + modulated input
  float* sc = x + TB * H;        // TB x H   silu(obs_emb + t_emb)
  float* mod = sc + TB * H;      // TB x 2H  adaLN scale | shift
  float* mlp = mod + TB * H2;    // TB x 4H  MLP hidden; also v_proj and out_fc1 outputs

  const int row0 = blockIdx.x * TB;
  const unsigned seed = stochastic ? (unsigned)(*seed_ptr & 0xFFFFFFFFll) : 0u;

  // Rows past B (the ragged edge) compute on zeros and are never stored.
  for (int i = threadIdx.x; i < TB * Dp; i += THREADS) {
    const int r = i / Dp, c = i % Dp, row = row0 + r;
    z[i] = (row < B && c < D) ? z0[(size_t)row * D + c] : 0.f;
  }

  for (int s = 0; s < K; ++s) {
    const float* te = t_embs + (size_t)s * H;
    for (int i = threadIdx.x; i < TB * H; i += THREADS) {
      const int r = i / H, c = i % H, row = row0 + r;
      sc[i] = silu((row < B ? obs_emb[(size_t)row * H + c] : 0.f) + te[c]);
    }
    __syncthreads();
    mm<EPI_STORE>(z, Dp, D, wbuf + off.lp_w, wbuf + off.lp_b, H, h, H);
    __syncthreads();
    for (int l = 0; l < L; ++l) {
      const size_t lh = (size_t)l * H;
      mm<EPI_STORE>(sc, H, H, wbuf + off.mod1_w + lh * H2, wbuf + off.mod1_b + l * H2, H2, mod, H2);
      __syncthreads();
      adaln(h, mod, x, H);
      __syncthreads();
      mm<EPI_STORE>(x, H, H, wbuf + off.v_w + lh * H, wbuf + off.v_b + lh, H, mlp, H);
      __syncthreads();
      mm<EPI_ADD>(mlp, H, H, wbuf + off.o_w + lh * H, wbuf + off.o_b + lh, H, h, H);
      __syncthreads();
      mm<EPI_STORE>(sc, H, H, wbuf + off.mod2_w + lh * H2, wbuf + off.mod2_b + l * H2, H2, mod, H2);
      __syncthreads();
      adaln(h, mod, x, H);
      __syncthreads();
      mm<EPI_GELU>(x, H, H, wbuf + off.f1_w + lh * H4, wbuf + off.f1_b + l * H4, H4, mlp, H4);
      __syncthreads();
      mm<EPI_ADD>(mlp, H4, H4, wbuf + off.f2_w + (size_t)l * H4 * H, wbuf + off.f2_b + lh, H, h, H);
      __syncthreads();
    }
    mm<EPI_STORE>(sc, H, H, wbuf + off.modf_w, wbuf + off.modf_b, H2, mod, H2);
    __syncthreads();
    adaln(h, mod, x, H);
    __syncthreads();
    mm<EPI_SILU>(x, H, H, wbuf + off.out1_w, wbuf + off.out1_b, H / 2, mlp, H / 2);
    __syncthreads();
    mm<EPI_STORE>(mlp, H / 2, H / 2, wbuf + off.out2_w, nullptr, D, score, Dp);
    __syncthreads();

    const float* cf = coeffs + s * 8;
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
    // The next step's first barrier orders these writes before latent_proj reads z.
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TB * D; i += THREADS) {
    const int r = i / D, c = i % D, row = row0 + r;
    if (row < B) out[(size_t)row * D + c] = z[r * Dp + c];
  }
}

}  // namespace

extern "C" {

// Launch the sweep on `stream`. Returns cudaGetLastError() after the launch (0 = success);
// smem_bytes must equal the kernel's own plan (the caller checks it against the card).
int aid_denoise_sweep(const float* z0, const float* obs_emb, const float* t_embs,
                      const float* coeffs, const float* wbuf, TrunkOffsets off,
                      const long long* seed, float* out, int B, int D, int H, int L, int K,
                      float mult, int stochastic, size_t smem_bytes, cudaStream_t stream) {
  if (smem_bytes != smem_floats(D, H) * sizeof(float) || H % 8 != 0 || B <= 0 || K <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      denoise_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + TB - 1) / TB);
  denoise_sweep_kernel<<<grid, THREADS, smem_bytes, stream>>>(
      z0, obs_emb, t_embs, coeffs, wbuf, off, seed, out, B, D, H, L, K, mult, stochastic);
  return (int)cudaGetLastError();
}

const char* aid_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
