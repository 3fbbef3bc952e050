// The fused K-step reverse-diffusion belief sweep, v1 and v2 algebra, with float32 or
// bfloat16 weights, for NVIDIA Hopper (sm_90a): four kernels from one template.
//
// Replaces the TPU kernels active_inference_diffusion_tpu/ops/denoise.py::_denoise_kernel
// (aid_denoise_sweep: float32, aid_denoise_sweep_bf16: bfloat16) and ::_denoise_kernel_v2
// (aid_denoise_sweep_v2, aid_denoise_sweep_v2_bf16). One launch runs the whole sweep:
//   cond = silu(obs_emb + t_emb[step])
//   h = latent_proj(z)
//   L x [ h += out_proj(v_proj(adaLN1(h))); h += fc2(gelu_tanh(fc1(adaLN2(h)))) ]
//   score = clip(out_fc2(silu(out_fc1(adaLN_final(h)))), +-10) * output_multiplier
//   z = c1 * (z + s1 * score) * s2 + c2 * z + noise_mask * sqrt(pv) * eps
// v2 runs the same sweep with out_proj(v_proj(x)) as one product x @ (Wv Wo) and its 2L+1
// modulations packed side by side (ops/denoise.py::extract_trunk_weights_v2). eps is a
// counter-based Philox4x32-10 with Box-Muller, keyed by (seed, global row) and counted by
// (step, latent column), so the draw depends neither on the tiling nor on the variant.
//
// Numerics by operand type T (the type of the stored weights):
// - bfloat16: rounding sites are the TPU's `x.astype(w.dtype)`: every product's activation
//   operand (z before latent_proj, silu(cond), each adaLN output, v_proj's output in v1, the
//   gelu MLP hidden and the silu out_fc1 output) is rounded to bfloat16 once, where it is
//   written; products are bf16 x bf16 (exact) on mma.sync m16n8k16, summed in float32.
// - float32: nothing is rounded; products are accurate to float32 by 3xTF32 on mma.sync
//   m16n8k8: each operand x splits into hi = tf32(x) and lo = x - hi in registers (the
//   weights from their stored float32, never stored split; split_tf32), and a k-step sums
//   a_lo b_hi + a_hi b_lo + a_hi b_hi; the dropped a_lo b_lo is 2^-22 of the product.
// - both: each k-step's mma sums from zero and the k-steps are added in float32, so the
//   tensor cores' own accumulation never carries across k-steps. Biases, LayerNorm (eps
//   1e-6, no affine), silu(cond), the +-10 clip x output_multiplier and the p_sample update
//   are float32.
//
// What bounds it on the card. 2 x 5,693,440 (v1) / 5,300,224 (v2) weights x B x K
// operations at the humanoid_state.yaml width (latent 64, hidden 256, L 6): 146 / 136
// GFLOP at B 256, K 50, 0.15 ms at the tensor cores' 989 TFLOP/s in bf16 and 2.2 / 2.0 ms
// at float32's 67 TFLOP/s. The trunk (11.4 MB in bf16, 22.8 MB in float32) fits L2, not an
// SM; each 16-row tile runs a chain of K x (4L+3) dependent products. So the limit is how
// fast one tile's chain can stream its weights and pass its barriers, not the arithmetic.
//
// The design.
// - Tensor cores through mma.sync: a tile's 16 batch rows are exactly one M tile. Not
//   wgmma: it needs 64-row tiles, which would cut the tiles at B 256 from 16 to 4 and leave
//   3/4 of each product's rows empty at B <= 48. A fragments come from the operand copies
//   in shared memory by ldmatrix (a k-step is 32 bytes of a row in both types: 16 bf16 or 8
//   float32, whose 16 x 8 tile ldmatrix.x4 loads as four 8 x 4-word matrices); B fragments
//   from the pack's kernel-order buffer (PackedTrunk.kernel), laid out per product, per
//   cluster rank, per chunk of <= 16 n-tiles and per piece of k-steps in fragment order
//   (lane-contiguous 8 bytes), so a warp's B load is 256 contiguous bytes.
// - A cluster of CLUSTER CTAs runs each 16-row tile. Rank j computes columns
//   [j N/C, (j+1) N/C) of every product, so it streams only 1/C of the weights, and writes
//   the next product's operand into every CTA's shared memory (DSMEM). The float32
//   residual stream h and the modulation stay distributed: rank j keeps only its
//   h-columns [j H/C, (j+1) H/C) and the scale and shift of those columns, which it
//   computes itself. An adaLN exchanges each rank's row sums and squared deviations (16
//   rows x 2 floats), and after a cluster barrier every rank normalises its own columns
//   and writes them into every CTA: two cluster barriers an adaLN, 6L + 4 a step in v1 and
//   5L + 4 in v2. v2 computes its 2L+1 modulation sites one at a time, as v1 computes mod1,
//   mod2 and mod_final, so no variant needs device scratch.
// - Each chunk's weight slice (its float32 biases at the head of its first piece) is
//   staged into shared memory ahead of use with the 1-D bulk copy (cp.async.bulk ...
//   mbarrier::complete_tx::bytes) into a ring of STAGES slots of SLOT_BYTES; one thread
//   refills a slot after the block barrier that frees it, so the next pieces load while a
//   product's epilogue and the cluster barrier run. The pack's piece table lists each
//   piece's offset and size for each rank. A float32 piece holds half the k-steps of a
//   bf16 one, so a float32 sweep has about twice the pieces.
// - Every rank takes a final cluster barrier before it exits, since a peer may still write
//   into its shared memory.
// The cluster is 8, portable: humanoid_state.yaml acts on one 16-row tile (8 environments,
// 10 evaluation episodes), where 8 CTAs beat 4 and match a non-portable 16. On the H100 a
// cluster of 8 fits 15 times at once (cudaOccupancyMaxActiveClusters), so B 256 (16 tiles)
// runs in two waves.
//
// Shared memory. Operand rows are padded by 16 bytes (8 bf16, 4 float32), which keeps
// ldmatrix free of bank conflicts. The float32 plan at latent 64, hidden 256 is 230,464 B
// of the 232,448 B a block may use; the MLP hidden's operand copy is 65,792 B of it. Where
// the operand copies do not fit (or the piece table outgrows MAX_PIECES), the streamed
// plan keeps one copy of each per cluster in global memory (the arena, a few hundred KB a
// cluster, which stays in L2), written once by the rank that computes the columns and
// read through L2; the ring, the partials, the rank's slices of h and of the modulation
// and the adaLN statistics stay in shared memory, so its shared memory grows with the
// hidden width only (149 KB at hidden 1280).
//
// Widths: the kernel's hidden width H is a multiple of 8 x CLUSTER; a model's hidden
// width Hr is padded to it with zero weights at the end of every hidden axis (the scale
// and the shift halves of a modulation each), and the adaLN statistics count the Hr real
// columns only. The latent and out_fc1's width are padded to a multiple of 8 x CLUSTER
// with zero weights. ops/denoise.py mirrors both plans (sweep_smem_bytes), builds the
// layout (kernel_layout) and picks the plan (kernel_plan).
//
// Plain C interface, bound from Python with ctypes (ops/_build.py, ops/denoise.py).

#include <cooperative_groups.h>

#include "sweep_common.cuh"

namespace cg = cooperative_groups;
using namespace aid;

namespace {

constexpr int CLUSTER = 8;                       // CTAs per 16-row tile; KERNEL_CLUSTER in ops/denoise.py
constexpr int WARPS = THREADS / 32;
constexpr int SLOT_BYTES = 32768 + 512;          // one staged piece: fragments and a bias head
constexpr int STAGES = 3;                        // slots in the ring
constexpr int MAX_TILES = 2;                     // n-tiles a warp holds per chunk
constexpr int CHUNK_TILES = WARPS * MAX_TILES;   // n-tiles per chunk (128 columns)
constexpr int RED_FLOATS = TB * (CHUNK_TILES * 8 + 8);  // split-K partials of one chunk
constexpr int FRAG_BYTES = 32 * 8;               // one (n-tile, k-step) B fragment, a warp
constexpr int MAX_PIECES = 256;                  // entries of a rank's piece table
constexpr int UNROLL = 4;                        // k-steps whose fragments a warp loads at once
constexpr int ROW_PAD = 16;                      // bytes of padding after each operand row

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// ---- PTX wrappers ----------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// One bulk copy of `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// memory into this CTA's shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (lower address)
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x = hi + lo for 3xTF32, in integer and float adds rather than cvt.rna.tf32 (a
// conversion, at a fraction of the add rate): hi is x rounded to tf32's 10 mantissa bits
// (half away from zero: add half an ulp, clear the 13 low bits); lo = x - hi is exact in
// float32 and goes to the tensor cores as it is, which read the top 19 bits of a tf32
// operand, so lo is truncated to tf32 there (2^-11 of lo, at most 2^-22 of x).
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& hi, uint32_t& lo) {
  hi = (x + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__uint_as_float(x) - __uint_as_float(hi));
}

// d += A (16 x 8, tf32) @ B (8 x 8, tf32) on the tensor cores.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- the operand type ------------------------------------------------------------------

// What differs between the float32 and the bfloat16 kernels: the operand copies' element,
// the elements of one k-step, how a value is written into a copy, and the k-step's product.
// A k-step is 32 bytes of an operand row in both, and a B fragment 8 bytes a lane.
template <typename T>
struct Operand;

template <>
struct Operand<__nv_bfloat16> {
  static constexpr int KSTEP = 16;
  struct A { uint32_t x[4]; };
  static __device__ __forceinline__ A split(const uint32_t (&a)[4]) {
    return A{{a[0], a[1], a[2], a[3]}};
  }
  // acc += A (16 x 16) @ B (16 x 8): one k-step's 16 exact products summed from zero.
  static __device__ __forceinline__ void mma(float (&acc)[4], const A& a, uint2 b) {
    float d0, d1, d2, d3;
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
        : "=f"(d0), "=f"(d1), "=f"(d2), "=f"(d3)
        : "r"(a.x[0]), "r"(a.x[1]), "r"(a.x[2]), "r"(a.x[3]), "r"(b.x), "r"(b.y), "f"(0.f));
    acc[0] += d0, acc[1] += d1, acc[2] += d2, acc[3] += d3;
  }
  static __device__ __forceinline__ __nv_bfloat16 from(float v) { return __float2bfloat16_rn(v); }
  static __device__ __forceinline__ void store2(__nv_bfloat16* dst, float a, float b) {
    *reinterpret_cast<uint32_t*>(dst) = pack_bf16(a, b);
  }
  // Write 8 values (16 bytes) at the same shared offset in every CTA of the cluster.
  static __device__ __forceinline__ void broadcast8(__nv_bfloat16* dst, const float (&v)[8]) {
    cg::cluster_group cluster = cg::this_cluster();
    const uint4 w = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                               pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
#pragma unroll
    for (int q = 0; q < CLUSTER; ++q) *cluster.map_shared_rank(reinterpret_cast<uint4*>(dst), q) = w;
  }
  // Write 8 values (16 bytes) once, into the cluster's arena.
  static __device__ __forceinline__ void store8(__nv_bfloat16* dst, const float (&v)[8]) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                                pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
  }
};

template <>
struct Operand<float> {
  static constexpr int KSTEP = 8;
  struct A { uint32_t hi[4], lo[4]; };
  static __device__ __forceinline__ A split(const uint32_t (&a)[4]) {
    A s;
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(a[i], s.hi[i], s.lo[i]);
    return s;
  }
  // acc += A (16 x 8) @ B (8 x 8) to float32 accuracy (3xTF32), the k-step summed from
  // zero: the two small terms in one accumulator, the large one in another, so the three
  // mma form chains of two and one, not of three.
  static __device__ __forceinline__ void mma(float (&acc)[4], const A& a, uint2 b) {
    uint32_t h0, h1, l0, l1;
    split_tf32(b.x, h0, l0);
    split_tf32(b.y, h1, l1);
    float big[4] = {0.f, 0.f, 0.f, 0.f}, small[4] = {0.f, 0.f, 0.f, 0.f};
    mma_tf32(small, a.lo, h0, h1);
    mma_tf32(small, a.hi, l0, l1);
    mma_tf32(big, a.hi, h0, h1);
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] += big[i] + small[i];
  }
  static __device__ __forceinline__ float from(float v) { return v; }
  static __device__ __forceinline__ void store2(float* dst, float a, float b) {
    *reinterpret_cast<float2*>(dst) = make_float2(a, b);
  }
  // Write 8 values (32 bytes) at the same shared offset in every CTA of the cluster.
  static __device__ __forceinline__ void broadcast8(float* dst, const float (&v)[8]) {
    cg::cluster_group cluster = cg::this_cluster();
    const float4 w0 = make_float4(v[0], v[1], v[2], v[3]), w1 = make_float4(v[4], v[5], v[6], v[7]);
#pragma unroll
    for (int q = 0; q < CLUSTER; ++q) {
      float4* p = cluster.map_shared_rank(reinterpret_cast<float4*>(dst), q);
      p[0] = w0;
      p[1] = w1;
    }
  }
  // Write 8 values (32 bytes) once, into the cluster's arena.
  static __device__ __forceinline__ void store8(float* dst, const float (&v)[8]) {
    reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
};

// Write 8 values of an operand copy: into every CTA's shared memory (resident plan) or
// once into the cluster's arena (streamed).
template <typename T, bool S>
__device__ __forceinline__ void put8(T* dst, const float (&v)[8]) {
  if constexpr (S)
    Operand<T>::store8(dst, v);
  else
    Operand<T>::broadcast8(dst, v);
}

// Shared-memory plan (bytes) for operand type T and placement S; sweep_smem_bytes in
// ops/denoise.py mirrors its shared memory, and aid_sweep_arena_bytes reports its arena. Operand copies are T with ROW_PAD bytes of row
// padding; the residual stream and the modulation are the rank's float32 slices, z's
// float32 slice too; the adaLN statistics are CLUSTER x TB float2, one per rank and row.
// The split-K partials are double-buffered. Resident (S false): the operand copies and z's
// slice follow the fixed part in shared memory, whose piece table holds MAX_PIECES
// entries. Streamed (S true): they live in the cluster's `arena` bytes of global memory,
// one copy a cluster read through L2, with every rank's z slice; the piece table is read
// from global memory. Offsets zb..zs count from the operands' base. Strides (ld*) are in
// elements of T.
struct Plan {
  int Dp, HC, DC, NP1, ldz, ldh, ldm;
  size_t bars, table, red, hf, mf, st, zb, scb, xb, mb, zs, bytes, arena;
};

template <typename T, bool S>
__host__ __device__ inline Plan make_plan(int D, int H) {
  constexpr int E = (int)sizeof(T), PAD = ROW_PAD / E;
  Plan p;
  p.Dp = round_up(D, 8 * CLUSTER);       // padded latent
  p.NP1 = round_up(H / 2, 8 * CLUSTER);  // padded out_fc1 width
  p.HC = H / CLUSTER;
  p.DC = p.Dp / CLUSTER;
  p.ldz = p.Dp + PAD;
  p.ldh = H + PAD;
  p.ldm = (4 * H > p.NP1 ? 4 * H : p.NP1) + PAD;
  p.bars = (size_t)STAGES * SLOT_BYTES;
  p.table = p.bars + 64;
  p.red = p.table + (S ? 0 : MAX_PIECES * 8);
  p.hf = p.red + 2 * RED_FLOATS * 4;
  p.mf = p.hf + (size_t)TB * p.HC * 4;
  p.st = p.mf + (size_t)TB * 2 * p.HC * 4;
  const size_t fixed = p.st + (size_t)CLUSTER * TB * 8;
  size_t o = S ? 0 : fixed;
  p.zb = o;
  o += (size_t)TB * p.ldz * E;
  p.scb = o;
  o += (size_t)TB * p.ldh * E;
  p.xb = o;
  o += (size_t)TB * p.ldh * E;
  p.mb = o;
  o += (size_t)TB * p.ldm * E;
  p.zs = o;
  o += (size_t)(S ? CLUSTER : 1) * TB * p.DC * 4;
  p.bytes = S ? fixed : o;
  p.arena = S ? o : 0;
  return p;
}

struct Args {
  const float* z0;       // (B, D)
  const float* obs_emb;  // (B, Hr)
  const float* t_embs;   // (K, Hr), row s = timestep K-1-s
  const float* coeffs;   // (K, 8): s1 s2 c1 c2 sd mask 0 0
  const void* wk;        // kernel-order weights (of the operand type) with float32 bias heads
  const uint2* pieces;   // (CLUSTER, P): (offset in 16-byte units, bytes) of each piece of a step
  const long long* seed;
  float* out;            // (B, D)
  char* arena;           // streamed plan: Plan::arena bytes per cluster; else unused
  int B, D, H, Hr, L, K, P;  // H: the kernel's hidden width, Hr <= H the model's
  const float* mult;     // the score network's output_multiplier, read at launch
  int stochastic;
};

// ---- per-CTA state ---------------------------------------------------------------------

// What a product's epilogue does with its rank's columns (8 at a time, one row):
//   E_MOD         the modulation of the rank's h-columns, scale | shift, into its mf;
//   E_STORE_H     h = value, E_ADD_H h += value, into the rank's hf;
//   E_BCAST(_GELU, _SILU)  the next product's operand (value, gelu, silu), in every CTA;
//   E_SCORE       p_sample of the rank's latent columns, then z's operand, in every CTA.
enum Epi { E_MOD, E_STORE_H, E_ADD_H, E_BCAST, E_BCAST_GELU, E_BCAST_SILU, E_SCORE };

template <typename T>
struct Ctx {
  Args a;
  Plan p;
  char* ring;
  uint32_t bars;  // shared address of STAGES mbarriers
  float* red;     // two buffers of RED_FLOATS
  T *zb, *scb, *xb, *mb;
  float *hf, *mf, *zs;
  float2* st;     // adaLN statistics: (row sum, squared deviations) of each rank and row
  const uint2* table;  // this rank's piece table: in shared memory, or global when streamed
  int rank, row0, step;
  unsigned seed;
  float mult;        // *a.mult
  float cf[6];       // the step's s1 s2 c1 c2 sd mask
  int pc;            // pieces consumed (or being consumed) in the sweep
  int pc0;           // pieces consumed before this step
  int issued;        // pieces issued (thread 0)
  int total;         // pieces in the whole sweep
  int chunks;        // chunks run so far: selects the partials buffer
};

// Issue the pieces that fit the ring. Called by all threads right after a block barrier
// that follows the last read of every piece before c.pc (a slot is only read, never
// written, by the threads, so the barrier alone orders those reads before the copy).
template <typename T>
__device__ __forceinline__ void refill(Ctx<T>& c) {
  if (threadIdx.x != 0) return;
  while (c.issued < c.total && c.issued < c.pc + STAGES) {
    const uint2 e = c.table[c.issued % c.a.P];
    const int slot = c.issued % STAGES;
    bulk_load(smem_addr(c.ring + (size_t)slot * SLOT_BYTES),
              reinterpret_cast<const char*>(c.a.wk) + (size_t)e.x * 16, e.y, c.bars + 8 * slot);
    ++c.issued;
  }
}

__device__ __forceinline__ void store8(float* dst, const float (&v)[8]) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

// Epilogue of one item: 8 columns [col, col+8) of the rank's slice, row r; v holds the
// float32 sums with the bias added. `bf` (row stride ld) is the rank's slice of the
// destination operand buffer for the broadcast kinds.
template <typename T, int E, bool S>
__device__ __forceinline__ void epilogue(Ctx<T>& c, int r, int col, float (&v)[8], T* bf,
                                         int ld) {
  const int HC = c.p.HC;
  if (E == E_MOD) {
    store8(c.mf + r * 2 * HC + col, v);
    return;
  }
  if (E == E_STORE_H || E == E_ADD_H) {
    float* h = c.hf + r * HC + col;
    if (E == E_ADD_H) {
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] += h[k];  // this thread's own item
    }
    store8(h, v);
    return;
  }
  if (E == E_SCORE) {
    const float s1 = c.cf[0], s2 = c.cf[1], c1 = c.cf[2], c2 = c.cf[3], sd = c.cf[4];
    const float mask = c.cf[5];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int lc = col + k, gc = c.rank * c.p.DC + lc;
      float m = 0.f;
      if (gc < c.a.D) {
        const float zi = c.zs[r * c.p.DC + lc];
        const float sco = fminf(fmaxf(v[k], -10.f), 10.f) * c.mult;
        const float pz0 = (zi + s1 * sco) * s2;
        m = c1 * pz0 + c2 * zi;
        if (c.a.stochastic && mask != 0.f)
          m += mask * sd * philox_normal(c.seed, c.row0 + r, c.step, gc);
      }
      c.zs[r * c.p.DC + lc] = m;
      v[k] = m;
    }
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (E == E_BCAST_GELU) v[k] = gelu_tanh(v[k]);
    if (E == E_BCAST_SILU) v[k] = silu(v[k]);
  }
  put8<T, S>(bf + r * ld + col, v);
}

// One k-step's A fragment (16 rows x 32 bytes) of a product. Resident: ldmatrix.x4 from
// shared memory at a_row (lane i gives row i % 16 of half i / 16). Streamed: the same
// fragment, word lane % 4 of rows lane / 4 and + 8 in each 16-byte half, from the arena at
// a_g through L2 (ld.global.cg: the peers' writes are ordered by the cluster barrier, and
// L1 is not coherent across the cluster's SMs).
template <bool S>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], uint32_t a_row, const char* a_g,
                                       int row_bytes, int kk) {
  if constexpr (S) {
    const char* q = a_g + kk * 32;
    a[0] = __ldcg(reinterpret_cast<const unsigned*>(q));
    a[1] = __ldcg(reinterpret_cast<const unsigned*>(q + 8 * row_bytes));
    a[2] = __ldcg(reinterpret_cast<const unsigned*>(q + 16));
    a[3] = __ldcg(reinterpret_cast<const unsigned*>(q + 8 * row_bytes + 16));
  } else {
    ldmatrix_x4(a, a_row + kk * 32);
  }
}

// One product: the rank's NT n-tiles (8 columns each) of A (TB x KSTEP KS, row stride lda
// elements; shared memory, or the arena when S) @ W + bias, then the epilogue E. Ends
// without a block barrier: the caller puts a cluster barrier (when peers read what it
// wrote) or nothing before the next product, whose partials go to the other buffer and
// whose first piece ends in a barrier.
template <typename T, int E, bool S>
__device__ void product(Ctx<T>& c, const T* A, int lda, int KS, int NT, T* bf = nullptr,
                        int ld = 0) {
  using Op = Operand<T>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row_bytes = lda * (int)sizeof(T);
  uint32_t a_row = 0;
  const char* a_g = nullptr;
  if constexpr (S)
    a_g = reinterpret_cast<const char*>(A) + (lane >> 2) * row_bytes + 4 * (lane & 3);
  else
    a_row = smem_addr(A) + (lane & 15) * row_bytes + (lane >> 4) * 16;
  for (int n0 = 0; n0 < NT; n0 += CHUNK_TILES) {
    const int ntc = min(CHUNK_TILES, NT - n0);
    const int wn_count = ntc >= 8 ? 8 : ntc >= 4 ? 4 : ntc >= 2 ? 2 : 1;
    const int wk_count = WARPS / wn_count;
    const int wn = warp % wn_count, wk = warp / wn_count;
    float* red = c.red + (c.chunks++ & 1) * RED_FLOATS;
    // A chunk has at most TB x CHUNK_TILES = THREADS epilogue items (a row, 8 columns):
    // thread i owns item i, and takes its 8 biases from the head of the chunk's first piece.
    const int item = threadIdx.x, r = item / ntc, j = item % ntc, col = (n0 + j) * 8;
    float4 b0 = make_float4(0.f, 0.f, 0.f, 0.f), b1 = b0;
    float acc[MAX_TILES][4];
#pragma unroll
    for (int i = 0; i < MAX_TILES; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    for (int kb = 0; kb < KS;) {
      const uint2 e = c.table[c.pc - c.pc0];
      const int head = kb == 0 ? ntc * 8 * 4 : 0;  // the chunk's float32 biases
      const int ksp = (int)((e.y - head) / (uint32_t)(ntc * FRAG_BYTES));
      const int slot = c.pc % STAGES;
      const uint32_t parity = (uint32_t)((c.pc / STAGES) & 1);
      for (long long spins = 0; !mbar_try_wait(c.bars + 8 * slot, parity);)
        if (++spins > (1ll << 28)) __trap();  // a piece that never lands faults, not hangs
      const char* piece = c.ring + (size_t)slot * SLOT_BYTES;
      if (head && item < TB * ntc) {
        b0 = *reinterpret_cast<const float4*>(piece + j * 32);
        b1 = *reinterpret_cast<const float4*>(piece + j * 32 + 16);
      }
      const char* w = piece + head + lane * 8;
      const int kend = kb + ksp;
      int kk = kb + ((wk - kb) % wk_count + wk_count) % wk_count;
      // UNROLL k-steps at a time: every fragment load is issued before the first product.
      for (; kk + (UNROLL - 1) * wk_count < kend; kk += UNROLL * wk_count) {
        uint32_t a[UNROLL][4];
        uint2 b[UNROLL][MAX_TILES];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          load_a<S>(a[u], a_row, a_g, row_bytes, kk + u * wk_count);
#pragma unroll
          for (int i = 0; i < MAX_TILES; ++i) {
            const int nt = min(wn + i * wn_count, ntc - 1);
            b[u][i] = *reinterpret_cast<const uint2*>(
                w + (size_t)(nt * ksp + (kk + u * wk_count - kb)) * FRAG_BYTES);
          }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const typename Op::A af = Op::split(a[u]);
#pragma unroll
          for (int i = 0; i < MAX_TILES; ++i)
            if (wn + i * wn_count < ntc) Op::mma(acc[i], af, b[u][i]);
        }
      }
      for (; kk < kend; kk += wk_count) {
        uint32_t a[4];
        load_a<S>(a, a_row, a_g, row_bytes, kk);
        const typename Op::A af = Op::split(a);
#pragma unroll
        for (int i = 0; i < MAX_TILES; ++i) {
          const int nt = wn + i * wn_count;
          if (nt < ntc) {
            const uint2 b = *reinterpret_cast<const uint2*>(
                w + (size_t)(nt * ksp + (kk - kb)) * FRAG_BYTES);
            Op::mma(acc[i], af, b);
          }
        }
      }
      kb = kend;
      ++c.pc;
      if (kb == KS) {  // the chunk's split-K partials
        const int ldr = ntc * 8 + 8, g = lane >> 2, t = lane & 3;
#pragma unroll
        for (int i = 0; i < MAX_TILES; ++i) {
          const int nt = wn + i * wn_count;
          if (nt < ntc) {
            float* p = red + (wk * TB + g) * ldr + nt * 8 + 2 * t;
            *reinterpret_cast<float2*>(p) = make_float2(acc[i][0], acc[i][1]);
            *reinterpret_cast<float2*>(p + 8 * ldr) = make_float2(acc[i][2], acc[i][3]);
          }
        }
      }
      __syncthreads();  // every read of this piece's slot is done (and the partials written)
      refill(c);
    }
    if (item < TB * ntc) {
      const int ldr = ntc * 8 + 8;
      float v[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      for (int q = 0; q < wk_count; ++q) {
        const float* p = red + (q * TB + r) * ldr + j * 8;
        const float4 p0 = *reinterpret_cast<const float4*>(p);
        const float4 p1 = *reinterpret_cast<const float4*>(p + 4);
        v[0] += p0.x, v[1] += p0.y, v[2] += p0.z, v[3] += p0.w;
        v[4] += p1.x, v[5] += p1.y, v[6] += p1.z, v[7] += p1.w;
      }
      epilogue<T, E, S>(c, r, col, v, bf, ld);
    }
  }
}

// x = LN(h) * (1 + scale) + shift for the rank's h-columns, into xb (every CTA's, or the
// arena's; rounded to bf16 in the bf16 kernels). Half-warp r (of warp r / 2) handles row
// r, 8 columns a lane. Each rank's (row sum, squared deviations from its own mean) go to
// every CTA; after a cluster barrier the row's mean and variance are combined from them
// (Chan et al.'s pairwise update), as LayerNorm's two passes compute them. Called after a
// block barrier that follows the writes of hf and mf; ends in a cluster barrier, so xb is
// whole. Every read of st precedes the second barrier, which precedes the next adaLN's
// writes of it; every read of xb precedes the next adaLN's first barrier.
//
// adaln_whole: every column of the kernel's width is the model's, and a lane's 8 columns
// of a rank's slice (at most 128 of them) stay in registers: the resident plan at a width
// that needs no padding.
constexpr int ADALN_PASS = 8 * 16;  // columns of one pass: 8 a lane of a half-warp

template <typename T>
__device__ void adaln_whole(Ctx<T>& c, cg::cluster_group& cluster) {
  const int lane = threadIdx.x & 31, col = 8 * (lane & 15);
  const int r = 2 * (threadIdx.x >> 5) + (lane >> 4);
  const int HC = c.p.HC;
  const bool mine = col < HC;
  float h[8];
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) h[k] = 0.f;
  if (mine) {
    const float4 h0 = *reinterpret_cast<const float4*>(c.hf + r * HC + col);
    const float4 h1 = *reinterpret_cast<const float4*>(c.hf + r * HC + col + 4);
    h[0] = h0.x, h[1] = h0.y, h[2] = h0.z, h[3] = h0.w;
    h[4] = h1.x, h[5] = h1.y, h[6] = h1.z, h[7] = h1.w;
#pragma unroll
    for (int k = 0; k < 8; ++k) s += h[k];
  }
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  const float own_mean = s / HC;
  float m2 = 0.f;
  if (mine) {
#pragma unroll
    for (int k = 0; k < 8; ++k) m2 += (h[k] - own_mean) * (h[k] - own_mean);
  }
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) m2 += __shfl_xor_sync(0xffffffffu, m2, o);
  if ((lane & 15) == 0) {
    const float2 stat = make_float2(s, m2);
#pragma unroll
    for (int q = 0; q < CLUSTER; ++q) *cluster.map_shared_rank(c.st + c.rank * TB + r, q) = stat;
  }
  cluster.sync();
  const float H = (float)c.a.H;
  float total = 0.f;
#pragma unroll
  for (int q = 0; q < CLUSTER; ++q) total += c.st[q * TB + r].x;
  const float mean = total / H;
  float var = 0.f;
#pragma unroll
  for (int q = 0; q < CLUSTER; ++q) {
    const float2 e = c.st[q * TB + r];
    const float d = e.x / HC - mean;
    var += e.y + HC * d * d;
  }
  const float rstd = rsqrtf(var / H + LN_EPS);
  if (mine) {
    const float* m = c.mf + r * 2 * HC + col;
    float x[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) x[k] = (h[k] - mean) * rstd * (1.f + m[k]) + m[HC + k];
    Operand<T>::broadcast8(c.xb + r * c.p.ldh + c.rank * HC + col, x);
  }
  cluster.sync();
}

// adaln_masked: the LayerNorm is over the model's Hr columns. Rank q's real columns are
// the first n_q = clamp(Hr - q HC, 0, HC) of its slice (the kernel's width H pads the
// model's with zero columns at the end); the padded ones enter no sum and are written as
// 0. Passes of ADALN_PASS columns, read from shared memory each time: the streamed plan's
// slices may be wider than one pass.
__device__ __forceinline__ int real_columns(int Hr, int HC, int q) {
  return min(max(Hr - q * HC, 0), HC);
}

template <typename T, bool S>
__device__ void adaln_masked(Ctx<T>& c, cg::cluster_group& cluster) {
  const int lane = threadIdx.x & 31;
  const int r = 2 * (threadIdx.x >> 5) + (lane >> 4);
  const int HC = c.p.HC, Hr = c.a.Hr, own = real_columns(Hr, HC, c.rank);
  const int col0 = 8 * (lane & 15);
  const float* hrow = c.hf + r * HC;
  float s = 0.f;
  for (int col = col0; col < HC; col += ADALN_PASS) {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (col + k < own) s += hrow[col + k];
  }
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  const float own_mean = own > 0 ? s / own : 0.f;
  float m2 = 0.f;
  for (int col = col0; col < HC; col += ADALN_PASS) {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (col + k < own) m2 += (hrow[col + k] - own_mean) * (hrow[col + k] - own_mean);
  }
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) m2 += __shfl_xor_sync(0xffffffffu, m2, o);
  if ((lane & 15) == 0) {
    const float2 stat = make_float2(s, m2);
#pragma unroll
    for (int q = 0; q < CLUSTER; ++q) *cluster.map_shared_rank(c.st + c.rank * TB + r, q) = stat;
  }
  cluster.sync();
  float total = 0.f;
#pragma unroll
  for (int q = 0; q < CLUSTER; ++q) total += c.st[q * TB + r].x;
  const float mean = total / Hr;
  float var = 0.f;
#pragma unroll
  for (int q = 0; q < CLUSTER; ++q) {
    const int n = real_columns(Hr, HC, q);
    if (n > 0) {
      const float2 e = c.st[q * TB + r];
      const float d = e.x / n - mean;
      var += e.y + n * d * d;
    }
  }
  const float rstd = rsqrtf(var / Hr + LN_EPS);
  const float* m = c.mf + r * 2 * HC;
  for (int col = col0; col < HC; col += ADALN_PASS) {
    float x[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      x[k] = col + k < own
                 ? (hrow[col + k] - mean) * rstd * (1.f + m[col + k]) + m[HC + col + k]
                 : 0.f;
    put8<T, S>(c.xb + r * c.p.ldh + c.rank * HC + col, x);
  }
  cluster.sync();
}

template <typename T, bool S>
__device__ __forceinline__ void adaln(Ctx<T>& c, cg::cluster_group& cluster) {
  if (!S && c.a.Hr == c.a.H)
    adaln_whole(c, cluster);
  else
    adaln_masked<T, S>(c, cluster);
}

template <typename T, int V, bool S>  // V 1: v1 algebra, 2: v2; S: the streamed plan
__global__ void __launch_bounds__(THREADS, 1) denoise_sweep_cluster_kernel(Args a) {
  extern __shared__ __align__(128) char smem[];
  constexpr int KSTEP = Operand<T>::KSTEP;
  cg::cluster_group cluster = cg::this_cluster();
  Ctx<T> c;
  c.a = a;
  c.p = make_plan<T, S>(a.D, a.H);
  const Plan& p = c.p;
  c.rank = (int)cluster.block_rank();
  const int cluster_id = (int)(blockIdx.x / CLUSTER);
  char* ops = S ? a.arena + (size_t)cluster_id * p.arena : smem;
  c.ring = smem;
  c.bars = smem_addr(smem + p.bars);
  c.red = reinterpret_cast<float*>(smem + p.red);
  c.hf = reinterpret_cast<float*>(smem + p.hf);
  c.mf = reinterpret_cast<float*>(smem + p.mf);
  c.st = reinterpret_cast<float2*>(smem + p.st);
  c.zb = reinterpret_cast<T*>(ops + p.zb);
  c.scb = reinterpret_cast<T*>(ops + p.scb);
  c.xb = reinterpret_cast<T*>(ops + p.xb);
  c.mb = reinterpret_cast<T*>(ops + p.mb);
  c.zs = reinterpret_cast<float*>(ops + p.zs) + (S ? c.rank * TB * p.DC : 0);
  c.table = S ? a.pieces + (size_t)c.rank * a.P : reinterpret_cast<const uint2*>(smem + p.table);
  c.row0 = cluster_id * TB;
  c.seed = a.stochastic ? (unsigned)(*a.seed & 0xFFFFFFFFll) : 0u;
  c.mult = *a.mult;
  c.pc = c.pc0 = c.issued = c.chunks = 0;
  c.total = a.K * a.P;
  const int H = a.H, Hr = a.Hr, D = a.D, L = a.L, HC = p.HC, DC = p.DC;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(c.bars + 8 * s), "r"(1)
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (!S)
    for (int i = threadIdx.x; i < a.P; i += THREADS)
      const_cast<uint2*>(c.table)[i] = a.pieces[(size_t)c.rank * a.P + i];
  // The latent's operand copy (the whole of it in every CTA; in the arena each rank writes
  // its own columns), and this rank's float32 columns of it. Rows past B (the ragged edge)
  // compute on zeros and are never stored.
  for (int i = threadIdx.x; i < TB * p.Dp; i += THREADS) {
    const int r = i / p.Dp, col = i % p.Dp, row = c.row0 + r;
    const bool own = col / DC == c.rank;
    if (S && !own) continue;
    const float v = (row < a.B && col < D) ? a.z0[(size_t)row * D + col] : 0.f;
    c.zb[r * p.ldz + col] = Operand<T>::from(v);
    if (own) c.zs[r * DC + col % DC] = v;
  }
  __syncthreads();
  refill(c);
  cluster.sync();  // every CTA of the cluster runs before any DSMEM access

  const int pad = ROW_PAD / (int)sizeof(T);
  const int ksh = H / KSTEP, nth = HC / 8, ntm = 2 * HC / 8, ld4 = 4 * H + pad;
  const int ld1 = p.NP1 + pad, nc1 = p.NP1 / CLUSTER;
  // silu(cond) over the kernel's H columns, 0 past the model's Hr: every rank computes all
  // of them into its own copy (resident), or its own HC columns into the arena (streamed).
  const int sc_span = S ? HC : H, sc_base = S ? c.rank * HC : 0;
  for (int s = 0; s < a.K; ++s) {
    c.step = s;
    c.pc0 = s * a.P;
#pragma unroll
    for (int k = 0; k < 6; ++k) c.cf[k] = __ldg(a.coeffs + s * 8 + k);
    const float* te = a.t_embs + (size_t)s * Hr;
    for (int i = threadIdx.x; i < TB * sc_span / 2; i += THREADS) {
      const int r = i / (sc_span / 2), col = sc_base + 2 * (i % (sc_span / 2)), row = c.row0 + r;
      float v[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float e = row < a.B && col + k < Hr ? a.obs_emb[(size_t)row * Hr + col + k] : 0.f;
        v[k] = col + k < Hr ? silu(e + te[col + k]) : 0.f;
      }
      Operand<T>::store2(c.scb + r * p.ldh + col, v[0], v[1]);
    }
    if (S)
      cluster.sync();  // the peers' columns of silu(cond)
    else
      __syncthreads();
    // hf and mf are the rank's own: a block barrier orders their writes before adaln's
    // reads, and adaln's cluster barriers its reads before the next writes. Every read of
    // mb, scb and zb precedes a cluster barrier that precedes the next write of it by any
    // rank.
    product<T, E_STORE_H, S>(c, c.zb, p.ldz, p.Dp / KSTEP, nth);        // latent_proj
    for (int l = 0; l < L; ++l) {
      product<T, E_MOD, S>(c, c.scb, p.ldh, ksh, ntm);                  // mod1 / site 2l
      __syncthreads();
      adaln<T, S>(c, cluster);
      if (V == 1) {
        product<T, E_BCAST, S>(c, c.xb, p.ldh, ksh, nth, c.mb + c.rank * HC, p.ldh);  // v_proj
        cluster.sync();
        product<T, E_ADD_H, S>(c, c.mb, p.ldh, ksh, nth);               // out_proj
      } else {
        product<T, E_ADD_H, S>(c, c.xb, p.ldh, ksh, nth);               // x @ (Wv Wo)
      }
      product<T, E_MOD, S>(c, c.scb, p.ldh, ksh, ntm);                  // mod2 / site 2l+1
      __syncthreads();
      adaln<T, S>(c, cluster);
      product<T, E_BCAST_GELU, S>(c, c.xb, p.ldh, ksh, 4 * nth, c.mb + c.rank * 4 * HC, ld4);
      cluster.sync();
      product<T, E_ADD_H, S>(c, c.mb, ld4, 4 * H / KSTEP, nth);         // fc2
    }
    product<T, E_MOD, S>(c, c.scb, p.ldh, ksh, ntm);                    // final / site 2L
    __syncthreads();
    adaln<T, S>(c, cluster);
    product<T, E_BCAST_SILU, S>(c, c.xb, p.ldh, ksh, nc1 / 8, c.mb + c.rank * nc1, ld1);
    cluster.sync();
    product<T, E_SCORE, S>(c, c.mb, ld1, p.NP1 / KSTEP, DC / 8, c.zb + c.rank * DC, p.ldz);
    cluster.sync();  // z's operand copy is whole again; after the last step, the final barrier
  }
  for (int i = threadIdx.x; i < TB * DC; i += THREADS) {
    const int r = i / DC, col = c.rank * DC + i % DC, row = c.row0 + r;
    if (row < a.B && col < D) a.out[(size_t)row * D + col] = c.zs[i];
  }
}

template <typename T, int V, bool S>
cudaLaunchConfig_t config(int B, size_t smem_bytes, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((B + TB - 1) / TB * CLUSTER));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T, int V, bool S>
int prepare(size_t smem_bytes) {
  return (int)cudaFuncSetAttribute(denoise_sweep_cluster_kernel<T, V, S>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
}

template <typename T, int V, bool S>
int launch_plan(const Args& a, size_t smem_bytes, cudaStream_t stream) {
  const Plan p = make_plan<T, S>(a.D, a.H);
  if (smem_bytes != p.bytes || (S && a.arena == nullptr) ||
      (!S && (a.P > MAX_PIECES || p.HC > ADALN_PASS)))
    return (int)cudaErrorInvalidValue;
  int err = prepare<T, V, S>(smem_bytes);
  if (err) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config<T, V, S>(a.B, smem_bytes, stream, attr);
  cudaLaunchKernelEx(&cfg, denoise_sweep_cluster_kernel<T, V, S>, a);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int launch(const Args& a, int streamed, size_t smem_bytes, cudaStream_t stream) {
  if (a.B <= 0 || a.K <= 0 || a.P <= 0 || a.H % (8 * CLUSTER) != 0 || a.Hr > a.H ||
      a.Hr <= a.H - 8 * CLUSTER)
    return (int)cudaErrorInvalidValue;
  return streamed ? launch_plan<T, V, true>(a, smem_bytes, stream)
                  : launch_plan<T, V, false>(a, smem_bytes, stream);
}

template <typename T, int V, bool S>
int max_clusters(size_t smem_bytes, int* count) {
  int err = prepare<T, V, S>(smem_bytes);
  if (err) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config<T, V, S>(TB * 132, smem_bytes, nullptr, attr);
  return (int)cudaOccupancyMaxActiveClusters(count, (void*)denoise_sweep_cluster_kernel<T, V, S>,
                                             &cfg);
}

template <typename T>
int max_clusters_of(int variant, int streamed, size_t smem_bytes, int* count) {
  if (streamed)
    return variant == 1 ? max_clusters<T, 1, true>(smem_bytes, count)
                        : max_clusters<T, 2, true>(smem_bytes, count);
  return variant == 1 ? max_clusters<T, 1, false>(smem_bytes, count)
                      : max_clusters<T, 2, false>(smem_bytes, count);
}

Args make_args(const float* z0, const float* obs_emb, const float* t_embs, const float* coeffs,
               const void* wk, const uint2* pieces, const long long* seed, float* out,
               void* arena, int B, int D, int H, int Hr, int L, int K, int P,
               const float* mult, int stochastic) {
  Args a;
  a.z0 = z0, a.obs_emb = obs_emb, a.t_embs = t_embs, a.coeffs = coeffs;
  a.wk = wk, a.pieces = pieces, a.seed = seed, a.out = out;
  a.arena = static_cast<char*>(arena);
  a.B = B, a.D = D, a.H = H, a.Hr = Hr, a.L = L, a.K = K, a.P = P;
  a.mult = mult, a.stochastic = stochastic;
  return a;
}

}  // namespace

// Each sweep entry point launches its kernel on `stream` as clusters of CLUSTER CTAs, one
// cluster per 16 batch rows, and returns cudaGetLastError() after the launch (0 = success).
// `wk` and `pieces` are the pack's kernel-order weights (biases included) and piece table
// (CLUSTER x P); H is the kernel's hidden width (a multiple of 8 x CLUSTER) and Hr the
// model's (H - 8 x CLUSTER < Hr <= H), the row stride of obs_emb and t_embs. `streamed`
// selects the plan (0 resident, 1 streamed, with `arena` of Plan::arena bytes per
// cluster); smem_bytes must equal that plan's own.
#define AID_SWEEP(NAME, T, V)                                                                  \
  int NAME(const float* z0, const float* obs_emb, const float* t_embs, const float* coeffs,   \
           const void* wk, const uint2* pieces, const long long* seed, float* out,             \
           void* arena, int B, int D, int H, int Hr, int L, int K, int P, const float* mult,   \
           int stochastic, int streamed, size_t smem_bytes, cudaStream_t stream) {             \
    return launch<T, V>(make_args(z0, obs_emb, t_embs, coeffs, wk, pieces, seed, out, arena,   \
                                  B, D, H, Hr, L, K, P, mult, stochastic),                    \
                        streamed, smem_bytes, stream);                                        \
  }

extern "C" {

AID_SWEEP(aid_denoise_sweep, float, 1)                   // v1, float32 weights
AID_SWEEP(aid_denoise_sweep_v2, float, 2)                // v2, float32 weights
AID_SWEEP(aid_denoise_sweep_bf16, __nv_bfloat16, 1)      // v1, bfloat16 weights
AID_SWEEP(aid_denoise_sweep_v2_bf16, __nv_bfloat16, 2)   // v2, bfloat16 weights

// How many clusters of the kernel (variant 1 or 2; bf16 0 for float32 weights, 1 for
// bfloat16; streamed 0 or 1, the plan) with this shared memory can be resident at once on
// the current device (cudaOccupancyMaxActiveClusters), into *count.
int aid_sweep_max_clusters(int variant, int bf16, int streamed, size_t smem_bytes, int* count) {
  return bf16 ? max_clusters_of<__nv_bfloat16>(variant, streamed, smem_bytes, count)
              : max_clusters_of<float>(variant, streamed, smem_bytes, count);
}

int aid_sweep_cluster_size() { return CLUSTER; }

// Bytes of the streamed plan's arena for one cluster (Plan::arena), for the operand type
// (bf16 0 or 1) and the kernel's widths; ops/denoise.py's arena_bytes mirrors it.
long long aid_sweep_arena_bytes(int bf16, int D, int H) {
  return (long long)(bf16 ? make_plan<__nv_bfloat16, true>(D, H).arena
                          : make_plan<float, true>(D, H).arena);
}

const char* aid_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
