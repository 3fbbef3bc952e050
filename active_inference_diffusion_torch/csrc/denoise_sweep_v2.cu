// The fused K-step reverse-diffusion belief sweep, v2 algebra, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel active_inference_diffusion_tpu/ops/denoise.py::_denoise_kernel_v2
// (reached through fused_denoise_sweep_v2, denoiser_kernel="v2") with float32 weights
// (aid_denoise_sweep_v2); its bfloat16 mode is denoise_sweep_bf16.cu. It computes the
// same sweep as denoise_sweep.cu with two exact algebraic fusions, made on the host when
// the weights are packed (ops/denoise.py::extract_trunk_weights_v2):
//   - the single-token attention out_proj(v_proj(x)) is one matmul with vo_w = Wv @ Wo,
//     vo_b = bv @ Wo + bo (composed in float32, then cast to the weight type);
//   - all 2L+1 adaLN modulations depend only on the conditioning, so each step computes
//     them as ONE (TB, H) @ (H, L*4H + 2H) product: [mod1_0 | mod2_0 | ... | mod_final].
// Noise, coefficients and the p_sample update are those of v1, so with the same seed the
// two variants draw the same eps.
//
// What bounds it on the card. 2 x 5,300,224 weights x B x K operations at the
// humanoid_state.yaml width (v1: 5,693,440; the v/o fusion saves L*H^2 per row and step);
// in practice, as for v1, the dependent chain of matmuls and block barriers with ceil(B/TB)
// blocks in flight. v2 has 4L+3 -> 3L+4 matmul phases per step (22 instead of 27 at L 6).
//
// What the design does about shared memory. The wide modulation output is TB x (L*4H + 2H)
// floats: 425,984 B at hidden 256 and TB 16, over the 232,448 B a block may use. It goes
// to a per-block scratch in device memory instead (the wrapper allocates ceil(B/TB) x TB x
// (L*4H + 2H) floats with torch.empty: 6.8 MB at B 256, hidden 256, so it stays in L2).
// Each step writes it once and the 2L+1 adaLN sites read it back after a block barrier,
// with plain loads (never the non-coherent __ldg path: the data is written in this launch).
// Everything else stays in shared memory: TB x (2 * round4(D) + 7H) floats.
//
// Plain C interface, bound from Python with ctypes (ops/_build.py, ops/denoise.py).

#include "sweep_common.cuh"

using namespace aid;

// Element offsets of each trunk array: *_w into the weight buffer, *_b into the float32
// bias buffer. Same fields, same order as PACK_ORDER["v2"] in ops/denoise.py.
struct TrunkOffsetsV2 {
  long long lp_w, lp_b, mod_w, mod_b, vo_w, vo_b, f1_w, f1_b, f2_w, f2_b;
  long long out1_w, out1_b, out2_w;
};

namespace {

// Dynamic shared memory in floats; sweep_smem_bytes(..., "v2") in ops/denoise.py mirrors it.
__host__ __device__ inline size_t smem_floats(int D, int H) {
  return (size_t)TB * (2 * round4(D) + 7 * H);
}

template <typename WT>
__global__ void __launch_bounds__(THREADS)
denoise_sweep_v2_kernel(const float* __restrict__ z0,       // (B, D)
                        const float* __restrict__ obs_emb,  // (B, H)
                        const float* __restrict__ t_embs,   // (K, H), row s = timestep K-1-s
                        const float* __restrict__ coeffs,   // (K, 8): s1 s2 c1 c2 sd mask 0 0
                        const WT* __restrict__ wbuf, const float* __restrict__ bbuf,
                        TrunkOffsetsV2 off, const long long* __restrict__ seed_ptr,
                        float* scratch,  // ceil(B/TB) x TB x M, M = L*4H + 2H
                        float* __restrict__ out, int B, int D, int H, int L, int K,
                        float mult, int stochastic) {
  extern __shared__ __align__(16) float smem[];
  const int Dp = round4(D);
  const int H2 = 2 * H, H4 = 4 * H, M = L * H4 + H2;
  float* z = smem;               // TB x Dp  latent
  float* score = z + TB * Dp;    // TB x Dp  score
  float* h = score + TB * Dp;    // TB x H   residual stream
  float* x = h + TB * H;         // TB x H   normalised + modulated input
  float* sc = x + TB * H;        // TB x H   silu(obs_emb + t_emb)
  float* mlp = sc + TB * H;      // TB x 4H  MLP hidden; also the out_fc1 output
  float* mods = scratch + (size_t)blockIdx.x * TB * M;  // TB x M, device memory

  const int row0 = blockIdx.x * TB;
  const unsigned seed = stochastic ? (unsigned)(*seed_ptr & 0xFFFFFFFFll) : 0u;

  load_latent(z0, z, row0, B, D, Dp);
  for (int s = 0; s < K; ++s) {
    load_cond(obs_emb, t_embs + (size_t)s * H, sc, row0, B, H);
    __syncthreads();
    // Two independent products in one phase: every modulation of the step, and latent_proj.
    mm<WT, EPI_STORE>(sc, H, H, wbuf + off.mod_w, bbuf + off.mod_b, M, mods, M);
    mm<WT, EPI_STORE>(z, Dp, D, wbuf + off.lp_w, bbuf + off.lp_b, H, h, H);
    __syncthreads();
    for (int l = 0; l < L; ++l) {
      const size_t lh = (size_t)l * H;
      adaln(h, mods + l * H4, M, x, H);
      __syncthreads();
      mm<WT, EPI_ADD>(x, H, H, wbuf + off.vo_w + lh * H, bbuf + off.vo_b + lh, H, h, H);
      __syncthreads();
      adaln(h, mods + l * H4 + H2, M, x, H);
      __syncthreads();
      mm<WT, EPI_GELU>(x, H, H, wbuf + off.f1_w + lh * H4, bbuf + off.f1_b + l * H4, H4, mlp,
                       H4);
      __syncthreads();
      mm<WT, EPI_ADD>(mlp, H4, H4, wbuf + off.f2_w + (size_t)l * H4 * H, bbuf + off.f2_b + lh,
                      H, h, H);
      __syncthreads();
    }
    adaln(h, mods + L * H4, M, x, H);
    __syncthreads();
    mm<WT, EPI_SILU>(x, H, H, wbuf + off.out1_w, bbuf + off.out1_b, H / 2, mlp, H / 2);
    __syncthreads();
    mm<WT, EPI_STORE>(mlp, H / 2, H / 2, wbuf + off.out2_w, nullptr, D, score, Dp);
    __syncthreads();
    p_sample_update(z, score, coeffs + s * 8, Dp, D, mult, stochastic, seed, row0, s);
    // The next step's first barrier orders these writes (and this step's last reads of
    // mods) before the next modulation product and latent_proj.
  }
  __syncthreads();
  store_latent(z, out, row0, B, D, Dp);
}

template <typename WT>
int launch(const float* z0, const float* obs_emb, const float* t_embs, const float* coeffs,
           const WT* wbuf, const float* bbuf, TrunkOffsetsV2 off, const long long* seed,
           float* scratch, float* out, int B, int D, int H, int L, int K, float mult,
           int stochastic, size_t smem_bytes, cudaStream_t stream) {
  if (smem_bytes != smem_floats(D, H) * sizeof(float) || H % 8 != 0 || B <= 0 || K <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(denoise_sweep_v2_kernel<WT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + TB - 1) / TB);
  denoise_sweep_v2_kernel<WT><<<grid, THREADS, smem_bytes, stream>>>(
      z0, obs_emb, t_embs, coeffs, wbuf, bbuf, off, seed, scratch, out, B, D, H, L, K, mult,
      stochastic);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch the v2 sweep on `stream`. Returns cudaGetLastError() after the launch (0 =
// success). `scratch` holds ceil(B/TB) * TB * (L*4H + 2H) floats; smem_bytes must equal
// the kernel's own plan.
int aid_denoise_sweep_v2(const float* z0, const float* obs_emb, const float* t_embs,
                         const float* coeffs, const float* wbuf, const float* bbuf,
                         TrunkOffsetsV2 off, const long long* seed, float* scratch, float* out,
                         int B, int D, int H, int L, int K, float mult, int stochastic,
                         size_t smem_bytes, cudaStream_t stream) {
  return launch<float>(z0, obs_emb, t_embs, coeffs, wbuf, bbuf, off, seed, scratch, out, B, D,
                       H, L, K, mult, stochastic, smem_bytes, stream);
}

const char* aid_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
