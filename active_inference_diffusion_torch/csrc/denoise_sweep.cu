// The fused K-step reverse-diffusion belief sweep (v1), for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel active_inference_diffusion_tpu/ops/denoise.py::_denoise_kernel
// (reached through fused_denoise_sweep) with float32 weights (aid_denoise_sweep); its
// bfloat16 mode is denoise_sweep_bf16.cu. One launch runs the whole sweep. Each block owns
// TB batch rows and loops over the K steps and the L DiT blocks itself:
//   cond = silu(obs_emb + t_emb[step])
//   h = latent_proj(z)
//   L x [ h += out_proj(v_proj(adaLN1(h))); h += fc2(gelu_tanh(fc1(adaLN2(h)))) ]
//   score = clip(out_fc2(silu(out_fc1(adaLN_final(h)))), +-10) * output_multiplier
//   z = c1 * (z + s1 * score) * s2 + c2 * z + noise_mask * sqrt(pv) * eps
// with eps from a counter-based Philox4x32-10 and Box-Muller, keyed by (seed, global row)
// and counted by (step, column), so the draw depends neither on TB nor on the variant.
//
// What bounds it on the card. The work is 2 x (trunk weights) x B x K operations: 18.2
// GFLOP at the flagship width (B 256, latent 32, hidden 128, L 6, K 25), 145.8 GFLOP at
// the humanoid_state.yaml width (latent 64, hidden 256, K 50). The trunk (5.7 MB at the
// humanoid width) is far over one SM's 227 KB of shared memory and
// well inside the 50 MB L2. The TPU kernel kept all weights in VMEM; here they cannot stay
// on chip, so the bound in practice is the dependent chain: per matmul, weights re-read
// from L2 and a block-wide barrier, with only ceil(B / TB) blocks in flight.
//
// What this simple design does about it. Weights are read once per matmul per block and
// reused across the block's TB rows (held in registers as TB/G accumulators); all
// activations (latent, residual stream, normalised input, silu(cond), modulation, MLP
// hidden) stay in shared memory for all K steps, so nothing but the final latent goes
// back to device memory. The products run on the CUDA cores in float32. No tensor cores,
// TMA or clusters yet: later work (the bfloat16 kernels have them).
//
// Plain C interface, bound from Python with ctypes (ops/_build.py, ops/denoise.py).

#include "sweep_common.cuh"

using namespace aid;

// Element offsets of each trunk array: the *_w fields into the weight buffer (of the
// weight type), the *_b fields into the float32 bias buffer. Same fields, same order as
// PACK_ORDER["v1"] in ops/denoise.py. Per-layer arrays are stacked on a leading L axis;
// matmul weights are (in, out) row-major.
struct TrunkOffsets {
  long long lp_w, lp_b;
  long long mod1_w, mod1_b, v_w, v_b, o_w, o_b;
  long long mod2_w, mod2_b, f1_w, f1_b, f2_w, f2_b;
  long long modf_w, modf_b, out1_w, out1_b, out2_w;
};

namespace {

// Dynamic shared memory in floats; sweep_smem_bytes(..., "v1") in ops/denoise.py mirrors it.
__host__ __device__ inline size_t smem_floats(int D, int H) {
  return (size_t)TB * (2 * round4(D) + 9 * H);
}

template <typename WT>
__global__ void __launch_bounds__(THREADS)
denoise_sweep_kernel(const float* __restrict__ z0,       // (B, D)
                     const float* __restrict__ obs_emb,  // (B, H)
                     const float* __restrict__ t_embs,   // (K, H), row s = timestep K-1-s
                     const float* __restrict__ coeffs,   // (K, 8): s1 s2 c1 c2 sd mask 0 0
                     const WT* __restrict__ wbuf, const float* __restrict__ bbuf,
                     TrunkOffsets off, const long long* __restrict__ seed_ptr,
                     float* __restrict__ out, int B, int D, int H, int L, int K, float mult,
                     int stochastic) {
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
  load_latent(z0, z, row0, B, D, Dp);
  for (int s = 0; s < K; ++s) {
    load_cond(obs_emb, t_embs + (size_t)s * H, sc, row0, B, H);
    __syncthreads();
    mm<WT, EPI_STORE>(z, Dp, D, wbuf + off.lp_w, bbuf + off.lp_b, H, h, H);
    __syncthreads();
    for (int l = 0; l < L; ++l) {
      const size_t lh = (size_t)l * H;
      mm<WT, EPI_STORE>(sc, H, H, wbuf + off.mod1_w + lh * H2, bbuf + off.mod1_b + l * H2, H2,
                        mod, H2);
      __syncthreads();
      adaln(h, mod, H2, x, H);
      __syncthreads();
      mm<WT, EPI_STORE>(x, H, H, wbuf + off.v_w + lh * H, bbuf + off.v_b + lh, H, mlp, H);
      __syncthreads();
      mm<WT, EPI_ADD>(mlp, H, H, wbuf + off.o_w + lh * H, bbuf + off.o_b + lh, H, h, H);
      __syncthreads();
      mm<WT, EPI_STORE>(sc, H, H, wbuf + off.mod2_w + lh * H2, bbuf + off.mod2_b + l * H2, H2,
                        mod, H2);
      __syncthreads();
      adaln(h, mod, H2, x, H);
      __syncthreads();
      mm<WT, EPI_GELU>(x, H, H, wbuf + off.f1_w + lh * H4, bbuf + off.f1_b + l * H4, H4, mlp,
                       H4);
      __syncthreads();
      mm<WT, EPI_ADD>(mlp, H4, H4, wbuf + off.f2_w + (size_t)l * H4 * H, bbuf + off.f2_b + lh,
                      H, h, H);
      __syncthreads();
    }
    mm<WT, EPI_STORE>(sc, H, H, wbuf + off.modf_w, bbuf + off.modf_b, H2, mod, H2);
    __syncthreads();
    adaln(h, mod, H2, x, H);
    __syncthreads();
    mm<WT, EPI_SILU>(x, H, H, wbuf + off.out1_w, bbuf + off.out1_b, H / 2, mlp, H / 2);
    __syncthreads();
    mm<WT, EPI_STORE>(mlp, H / 2, H / 2, wbuf + off.out2_w, nullptr, D, score, Dp);
    __syncthreads();
    p_sample_update(z, score, coeffs + s * 8, Dp, D, mult, stochastic, seed, row0, s);
    // The next step's first barrier orders these writes before latent_proj reads z.
  }
  __syncthreads();
  store_latent(z, out, row0, B, D, Dp);
}

template <typename WT>
int launch(const float* z0, const float* obs_emb, const float* t_embs, const float* coeffs,
           const WT* wbuf, const float* bbuf, TrunkOffsets off, const long long* seed,
           float* out, int B, int D, int H, int L, int K, float mult, int stochastic,
           size_t smem_bytes, cudaStream_t stream) {
  if (smem_bytes != smem_floats(D, H) * sizeof(float) || H % 8 != 0 || B <= 0 || K <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      denoise_sweep_kernel<WT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + TB - 1) / TB);
  denoise_sweep_kernel<WT><<<grid, THREADS, smem_bytes, stream>>>(
      z0, obs_emb, t_embs, coeffs, wbuf, bbuf, off, seed, out, B, D, H, L, K, mult,
      stochastic);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch the sweep on `stream`. Returns cudaGetLastError() after the launch (0 = success);
// smem_bytes must equal the kernel's own plan (the caller checks it against the card).
int aid_denoise_sweep(const float* z0, const float* obs_emb, const float* t_embs,
                      const float* coeffs, const float* wbuf, const float* bbuf,
                      TrunkOffsets off, const long long* seed, float* out, int B, int D, int H,
                      int L, int K, float mult, int stochastic, size_t smem_bytes,
                      cudaStream_t stream) {
  return launch<float>(z0, obs_emb, t_embs, coeffs, wbuf, bbuf, off, seed, out, B, D, H, L, K,
                       mult, stochastic, smem_bytes, stream);
}

const char* aid_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
