// Forward flash attention for Hopper (sm_90a), bf16 in, f32 accumulate.
//
// Replaces the Pallas TPU kernel apex_studio_tpu/ops/attention/pallas_flash.py
// (_flash_kernel, launched by _flash_call). Same function: exact softmax
// attention over BSHD q/k/v with an online softmax in base 2, an optional
// additive key-padding bias [B, Sk], a ragged-Sk tail mask and an optional
// causal mask (top-left aligned; the wrapper only accepts Sq == Sk).
//
// Design (TMA + wgmma, warp-specialised):
// - One block per (128-query tile, batch*head), 384 threads in three
//   warpgroups. Warpgroups 0 and 1 are consumers: each owns 64 query rows,
//   its 64 x 128 f32 scores and its 64 x D f32 output accumulator in
//   registers (setmaxnreg raises them to 240 registers a thread). One warp of
//   warpgroup 2 is the producer (the warpgroup drops to 24 registers). The
//   body is a single producer/consumer branch that never reconverges; after
//   the split the roles meet only at mbarriers.
// - Loads by TMA. Tensor maps describe q, k and v as 4-D BSHD tensors through
//   their real strides, so views of a fused projection are read in place.
//   The producer loads Q once, then fills a ring of STAGES stages of 128-key
//   K and V tiles with cp.async.bulk.tensor; each tile has a full barrier
//   (transaction bytes) and an empty barrier (one arrival per consumer warp),
//   K and V separately, so K of tile j+1 can land while V of tile j is read.
//   Rows past Sq or Sk are out of bounds for the map and arrive as zeros.
// - Shared memory layout: every tile is D/64 panels of [128 rows][64 bf16]
//   (128-byte rows) in the 128-byte swizzle that TMA writes and wgmma reads.
//   At D = 128: Q 32 KB + 2 stages x (K 32 KB + V 32 KB) = 160 KB, one block
//   an SM.
// - Products by wgmma. S = Q K^T is m64n128k16 with both operands from shared
//   memory (K-major descriptors; k-steps walk 32 bytes inside a panel, then
//   step to the next panel). P stays in registers, rounded to bf16, and is the
//   A operand of O += P V (m64n{D}k16); V is the B operand read transposed
//   (MN-major descriptor: leading offset = one panel, stride offset = eight
//   key rows).
// - Softmax overlapped with products: inside a consumer the Q K^T of tile j+1
//   is started together with the P V of tile j, and the softmax of tile j+1
//   runs while P V is still in flight; the two consumer warpgroups run
//   unsynchronised, so one's softmax also overlaps the other's products.
// - Running max and sum live in registers; scores are scaled by
//   scale*log2(e) in f32 and exponentiated with ex2. Without a bias (and with
//   a positive scale) the scaling is folded into the exponent's subtraction,
//   2^(s*scale - m*scale), one fused multiply-add a score. The accumulator
//   layout of wgmma (rows lane/4 and lane/4 + 8 of a warp's 16, column pairs
//   (lane%4)*2 of every 8) makes row reductions two quad shuffles.
// - Bias: each consumer thread fetches one of the tile's 128 values (times
//   log2 e, -inf past Sk) while the tile's products run; the warpgroup shares
//   them through a small double-buffered shared array and one named barrier.
// - Masked keys: the tail (k >= Sk) and the causal upper triangle get -inf
//   and drop out; a bias of -1e30 stays finite, so a row whose keys are all
//   masked by the bias averages V uniformly, as the JAX reference does. The
//   mask is paid only on tiles that the tail or the diagonal crosses; causal
//   tiles wholly above the diagonal are skipped.
// - Head dims: any multiple of 8 from 16 to 128 (the Pallas kernel takes any
//   head dim; SAM2's Hiera launches 56, 72 or 96 and its mask decoder 32 and
//   16). The template width DP is 64 for d <= 64 and 128 above. The tensor
//   maps' innermost extent is the real d, while the box stays 64 columns
//   wide, so TMA fills the columns past d with zeros in shared memory (and
//   still counts the whole box in the transaction bytes). Zero columns add
//   nothing to Q K^T, and the output columns past d that P V forms from V's
//   zero columns are never stored. So the function is exactly the one at the
//   real d; the scale is the real d's, passed by the wrapper. The cost: the
//   products run at the padded width (d = 56 pays 64/56 of the operations).
//
// Bound on an H100 SXM at the Flux Dev 1024px shape (B=1, S=4608, H=24,
// D=128): 4*B*H*Sq*Sk*D = 2.61e11 FLOP -> 0.264 ms at 989 TFLOP/s bf16, while
// q/k/v/o are 113 MB -> 0.034 ms at 3.35 TB/s. The kernel is bound by tensor
// core operations. What keeps it from the bound: 864 blocks on 132 SMs are 6.5
// waves with one block an SM, so a block's first loads and its output stores
// overlap nothing (a persistent schedule would hide them); and the part of the
// softmax's f32 and ex2 work (about 5 operations a score) that the other
// warpgroup's products do not cover.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BLOCK_M = 128;        // query rows a block
constexpr int BLOCK_N = 128;        // keys a tile
constexpr int NUM_CONSUMER_WARPS = 8;
constexpr int NUM_THREADS = 384;    // two consumer warpgroups + the producer's
constexpr int STAGES = 2;
constexpr int PANEL_BYTES = 128 * 128;  // [128 rows][64 bf16]
constexpr float LOG2E = 1.4426950408889634f;

// ---- small PTX wrappers ------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase differs from `parity`. With TRAP, a barrier
// that never flips (a fault in the pipeline) traps, so that the launch reports
// an error instead of hanging the card. Only the producer waits so: an exit
// edge between a consumer's asynchronous products makes ptxas serialise them
// and spill.
template <bool TRAP>
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (TRAP && spins > (1u << 24)) __trap();
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins accumulator registers at this point of the program, so that code that
// reads or writes them is not moved across the wait before it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle. Offsets in bytes.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A read-only global load that stays where it is written: placed before a
// wait, its latency passes behind the products in flight.
__device__ __forceinline__ float ldg_pinned(const float* p) {
  float y;
  asm volatile("ld.global.nc.f32 %0, [%1];\n" : "=f"(y) : "l"(p));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

#define ACC8(d, i)                                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define ACC32(d, i) ACC8(d, i), ACC8(d, i + 8), ACC8(d, i + 16), ACC8(d, i + 24)
#define REGS32                                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "            \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
#define REGS64                                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "            \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "   \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "   \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "

// d (64 x 128, f32) = a (64 x 16, shared, K-major) * b (128 x 16, shared,
// K-major)^T, added to d when accumulate != 0.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " REGS64
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : ACC32(d, 0), ACC32(d, 32)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 128, f32) += a (64 x 16, registers) * b (16 x 128, shared, MN-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " REGS64
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : ACC32(d, 0), ACC32(d, 32)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

// d (64 x 64, f32) += a (64 x 16, registers) * b (16 x 64, shared, MN-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : ACC32(d, 0)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

// ---- the kernel --------------------------------------------------------------------

template <int D>
struct Tiles {
  static_assert(D == 64 || D == 128, "the template widths are 64 and 128");
  static constexpr int PANELS = D / 64;
  static constexpr int TILE_BYTES = PANELS * PANEL_BYTES;  // 128 rows x D bf16
  // +1024: the tiles start at the next 1024-byte boundary (the swizzle's period).
  static constexpr int SMEM_BYTES = (1 + 2 * STAGES) * TILE_BYTES + 1024;
};

// One tile of the online softmax on a consumer thread's 2 rows x 64 scores.
// In: raw products in s; sbias, when not null, the tile's 128 bias values in
// shared memory, already times log2 e. Out: p = 2^(x - m) in s, the rows'
// rescale factors in corr, m_run and l_run (a quad's partial sum) brought up
// to date.
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m_run)[2], float (&l_run)[2],
                                             float (&corr)[2], const float* sbias,
                                             float scale_log2, int k0, int Sk, int row_a, int t4,
                                             bool tail, bool diag) {
  // Without a bias and with a positive scale the scaling folds into the
  // exponent's subtraction, 2^(s*scale - m*scale): one fused multiply-add a
  // score. Otherwise x = s*scale (+ bias) is formed first.
  const bool fold = sbias == nullptr && scale_log2 > 0.f;
  const float mul = fold ? scale_log2 : 1.f;
  if (sbias != nullptr) {
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      const float2 bb = *reinterpret_cast<const float2*>(sbias + nt * 8 + t4 * 2);
      s[4 * nt + 0] = fmaf(s[4 * nt + 0], scale_log2, bb.x);
      s[4 * nt + 1] = fmaf(s[4 * nt + 1], scale_log2, bb.y);
      s[4 * nt + 2] = fmaf(s[4 * nt + 2], scale_log2, bb.x);
      s[4 * nt + 3] = fmaf(s[4 * nt + 3], scale_log2, bb.y);
    }
  } else if (!fold) {
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] *= scale_log2;
  }
  if (tail || diag) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int col = k0 + (i >> 2) * 8 + t4 * 2 + (i & 1);
      const int row = row_a + ((i >> 1) & 1) * 8;
      if ((tail && col >= Sk) || (diag && col > row)) s[i] = -INFINITY;
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * nt + 0], s[4 * nt + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * nt + 2], s[4 * nt + 3]));
  }
  float rsum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    mx[r] = fmaxf(m_run[r], mx[r] * mul);
    const float m_use = mx[r] == -INFINITY ? 0.f : mx[r];
    corr[r] = ex2(m_run[r] - m_use);
    m_run[r] = mx[r];
    mx[r] = m_use;
  }
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    s[4 * nt + 0] = ex2(fmaf(s[4 * nt + 0], mul, -mx[0]));
    s[4 * nt + 1] = ex2(fmaf(s[4 * nt + 1], mul, -mx[0]));
    s[4 * nt + 2] = ex2(fmaf(s[4 * nt + 2], mul, -mx[1]));
    s[4 * nt + 3] = ex2(fmaf(s[4 * nt + 3], mul, -mx[1]));
    rsum[0] += s[4 * nt + 0] + s[4 * nt + 1];
    rsum[1] += s[4 * nt + 2] + s[4 * nt + 3];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * corr[r] + rsum[r];
}

// S = Q K^T for one consumer warpgroup: starts and commits, does not wait.
template <int D>
__device__ __forceinline__ void qk_product(float (&s)[64], uint64_t desc_q, uint64_t desc_k) {
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const uint32_t off = ((ks / 4) * PANEL_BYTES + (ks % 4) * 32) >> 4;
    wgmma_ss_n128(s, desc_q + off, desc_k + off, ks > 0);
  }
  wgmma_commit();
}

// O += P V for one consumer warpgroup: starts and commits, does not wait.
template <int NO>
__device__ __forceinline__ void pv_product(float (&acc)[NO], const uint32_t (&p)[32],
                                           uint64_t desc_v) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BLOCK_N / 16; ++kk)
    wgmma_rs(acc, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
             desc_v + ((kk * 16 * 128) >> 4));
  wgmma_commit();
}

// Rescales the output accumulators by the rows' factors and rounds P to bf16:
// the accumulators of key n-tiles (2kk, 2kk+1) are the A operand of key
// k-step kk.
template <int NO>
__device__ __forceinline__ void rescale_pack(float (&acc)[NO], const float (&s)[64],
                                             uint32_t (&p)[32], const float (&corr)[2]) {
#pragma unroll
  for (int nt = 0; nt < NO / 4; ++nt) {
    acc[4 * nt + 0] *= corr[0];
    acc[4 * nt + 1] *= corr[0];
    acc[4 * nt + 2] *= corr[1];
    acc[4 * nt + 3] *= corr[1];
  }
#pragma unroll
  for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
    p[4 * kk + 0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    p[4 * kk + 1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    p[4 * kk + 2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    p[4 * kk + 3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

template <int D>
__global__ void __launch_bounds__(NUM_THREADS, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v, const float* __restrict__ bias,
                     bf16* __restrict__ o, int H, int Sq, int Sk, int d, int64_t o_sb,
                     int64_t o_ss, int64_t o_sh, int64_t bias_sb, float scale_log2, int causal) {
  constexpr int PANELS = Tiles<D>::PANELS;
  constexpr int TILE_BYTES = Tiles<D>::TILE_BYTES;
  constexpr int NO = D / 2;       // output accumulators a thread

  extern __shared__ unsigned char smem_raw[];
  // Q full; then per stage: K full, V full, K empty, V empty.
  __shared__ __align__(8) uint64_t bars[1 + 4 * STAGES];
  // A tile's bias values times log2 e, per consumer warpgroup, two tiles deep.
  __shared__ __align__(16) float sbias[2][2][BLOCK_N];

  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + TILE_BYTES;
  const uint32_t sV = sK + STAGES * TILE_BYTES;
  const uint32_t bar_q = smem_u32(&bars[0]);
  const uint32_t bar_full_k = smem_u32(&bars[1]);
  const uint32_t bar_full_v = smem_u32(&bars[1 + STAGES]);
  const uint32_t bar_empty_k = smem_u32(&bars[1 + 2 * STAGES]);
  const uint32_t bar_empty_v = smem_u32(&bars[1 + 3 * STAGES]);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * BLOCK_M;

  int n_tiles = (Sk + BLOCK_N - 1) / BLOCK_N;
  if (causal) {
    // Tiles wholly above the diagonal are skipped.
    const int q_hi = min(q0 + BLOCK_M - 1, Sq - 1);
    n_tiles = min(n_tiles, q_hi / BLOCK_N + 1);
  }

  if (tid == 0) {
    mbar_init(bar_q, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full_k + 8 * s, 1);
      mbar_init(bar_full_v + 8 * s, 1);
      mbar_init(bar_empty_k + 8 * s, NUM_CONSUMER_WARPS);
      mbar_init(bar_empty_v + 8 * s, NUM_CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= NUM_CONSUMER_WARPS) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (warp == NUM_CONSUMER_WARPS && lane == 0) {
      mbar_expect_tx(bar_q, TILE_BYTES);
#pragma unroll
      for (int p = 0; p < PANELS; ++p)
        tma_load_4d(sQ + p * PANEL_BYTES, &map_q, bar_q, p * 64, q0, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int stage = j % STAGES;
        const uint32_t free_parity = ((j / STAGES) & 1) ^ 1;  // the first round passes
        mbar_wait<true>(bar_empty_k + 8 * stage, free_parity);
        mbar_expect_tx(bar_full_k + 8 * stage, TILE_BYTES);
#pragma unroll
        for (int p = 0; p < PANELS; ++p)
          tma_load_4d(sK + stage * TILE_BYTES + p * PANEL_BYTES, &map_k, bar_full_k + 8 * stage,
                      p * 64, j * BLOCK_N, h, b);
        mbar_wait<true>(bar_empty_v + 8 * stage, free_parity);
        mbar_expect_tx(bar_full_v + 8 * stage, TILE_BYTES);
#pragma unroll
        for (int p = 0; p < PANELS; ++p)
          tma_load_4d(sV + stage * TILE_BYTES + p * PANEL_BYTES, &map_v, bar_full_v + 8 * stage,
                      p * 64, j * BLOCK_N, h, b);
      }
    }
  } else {
    // ---- consumers ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = warp >> 2;
    const int g = lane >> 2;  // row within the 8-row group of an accumulator
    const int t4 = lane & 3;  // column pair within the accumulator
    const int row_a = q0 + warp * 16 + g;  // this thread's rows: row_a and row_a + 8
    const float* biasb = bias ? bias + b * bias_sb : nullptr;

    // K-major operands: 8-row groups are 1024 bytes apart; the leading offset
    // is not used by a swizzled K-major layout.
    const uint64_t desc_q = make_desc(sQ + wg * 64 * 128, 16, 1024);
    const uint64_t desc_k = make_desc(sK, 16, 1024);
    // V is the transposed (MN-major) B operand: 64-column panels are
    // PANEL_BYTES apart (leading offset), 8-key groups 1024 bytes (stride).
    const uint64_t desc_v = make_desc(sV, PANEL_BYTES, 1024);

    float acc[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[i] = 0.f;
    float s[64];
    uint32_t p[32];
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};
    float corr[2];

    auto start_qk = [&](int j) {
      const int stage = j % STAGES;
      mbar_wait<false>(bar_full_k + 8 * stage, (j / STAGES) & 1);
      qk_product<D>(s, desc_q, desc_k + ((stage * TILE_BYTES) >> 4));
    };
    auto start_pv = [&](int j) {
      const int stage = j % STAGES;
      mbar_wait<false>(bar_full_v + 8 * stage, (j / STAGES) & 1);
      pv_product(acc, p, desc_v + ((stage * TILE_BYTES) >> 4));
    };
    // This thread's one bias value of tile j (times log2 e; -inf past Sk),
    // fetched while the tile's products run.
    const int wg_tid = tid & 127;
    auto fetch_bias = [&](int j) {
      const int col = j * BLOCK_N + wg_tid;
      return biasb == nullptr ? 0.f : col < Sk ? ldg_pinned(biasb + col) * LOG2E : -INFINITY;
    };
    auto softmax = [&](int j, float bias_j) {
      const int k0 = j * BLOCK_N;
      const bool tail = k0 + BLOCK_N > Sk;
      const bool diag = causal && (k0 + BLOCK_N - 1 > q0 + wg * 64);
      const float* sb = nullptr;
      if (biasb != nullptr) {
        // The warpgroup shares the tile's 128 values through shared memory.
        // Two buffers: a warp ahead by a tile writes the other one.
        sb = sbias[wg][j & 1];
        sbias[wg][j & 1][wg_tid] = bias_j;
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      }
      softmax_tile(s, m_run, l_run, corr, sb, scale_log2, k0, Sk, row_a, t4, tail, diag);
    };

    mbar_wait<false>(bar_q, 0);
    start_qk(0);
    float bias_j = fetch_bias(0);
    wgmma_wait<0>();
    fence_regs(s);
    if (lane == 0) mbar_arrive(bar_empty_k);
    softmax(0, bias_j);
    rescale_pack(acc, s, p, corr);  // acc is still zero: the rescale is harmless

    for (int j = 1; j < n_tiles; ++j) {
      // Q K^T of tile j and P V of tile j-1 go out together; the softmax of
      // tile j runs while P V is in flight.
      start_qk(j);
      start_pv(j - 1);
      bias_j = fetch_bias(j);
      wgmma_wait<1>();
      fence_regs(s);
      if (lane == 0) mbar_arrive(bar_empty_k + 8 * (j % STAGES));
      softmax(j, bias_j);
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(bar_empty_v + 8 * ((j - 1) % STAGES));
      rescale_pack(acc, s, p, corr);
    }
    start_pv(n_tiles - 1);
    wgmma_wait<0>();
    fence_regs(acc);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    }
    const float inv0 = 1.f / fmaxf(l_run[0], 1e-30f);
    const float inv1 = 1.f / fmaxf(l_run[1], 1e-30f);
    bf16* ob = o + b * o_sb + h * o_sh;
#pragma unroll
    for (int nt = 0; nt < NO / 4; ++nt) {
      // d is a multiple of 8, so a column pair is wholly inside or past it.
      const int col = nt * 8 + t4 * 2;
      if (col >= d) continue;
      if (row_a < Sq) {
        *reinterpret_cast<uint32_t*>(ob + row_a * o_ss + col) =
            pack_bf16(acc[4 * nt + 0] * inv0, acc[4 * nt + 1] * inv0);
      }
      if (row_a + 8 < Sq) {
        *reinterpret_cast<uint32_t*>(ob + (row_a + 8) * o_ss + col) =
            pack_bf16(acc[4 * nt + 2] * inv1, acc[4 * nt + 3] * inv1);
      }
    }
  }
}

// ---- host side ---------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so that nothing links libcuda.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault) != cudaSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

constexpr int ERR_NO_ENCODER = 100000;  // cuTensorMapEncodeTiled not found
constexpr int ERR_MAP_BASE = 101000;    // + 1000 * (0 q, 1 k, 2 v) + CUresult

// A [B, S, H, D] bf16 tensor with strides (sb, ss, sh, 1) in elements, as a
// 4-D map (D, S, H, B) with boxes of [128 rows][64 columns], 128-byte swizzle.
// Out-of-bounds rows, and columns past the real D, read as zeros.
CUresult encode_bshd(CUtensorMap* map, const void* ptr, int B, int S, int H, int D, int64_t sb,
                     int64_t ss, int64_t sh) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  // A dimension of size 1 is never stepped over: any valid stride serves.
  const int64_t row = (int64_t)D * (int64_t)sizeof(bf16);
  const cuuint64_t strides[3] = {
      (cuuint64_t)(S > 1 ? ss * (int64_t)sizeof(bf16) : row),
      (cuuint64_t)(H > 1 ? sh * (int64_t)sizeof(bf16) : row),
      (cuuint64_t)(B > 1 ? sb * (int64_t)sizeof(bf16) : row)};
  const cuuint32_t box[4] = {64, 128, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// D is the template width (64 or 128), d the real head dim (d <= D).
template <int D>
int launch(const void* q, const void* k, const void* v, const void* bias, void* o, int B, int H,
           int Sq, int Sk, int d, const int64_t* st, float scale_log2, int causal,
           cudaStream_t stream) {
  if (encode_tiled() == nullptr) return ERR_NO_ENCODER;
  CUtensorMap map_q, map_k, map_v;
  CUresult res = encode_bshd(&map_q, q, B, Sq, H, d, st[0], st[1], st[2]);
  if (res != CUDA_SUCCESS) return ERR_MAP_BASE + (int)res;
  res = encode_bshd(&map_k, k, B, Sk, H, d, st[3], st[4], st[5]);
  if (res != CUDA_SUCCESS) return ERR_MAP_BASE + 1000 + (int)res;
  res = encode_bshd(&map_v, v, B, Sk, H, d, st[6], st[7], st[8]);
  if (res != CUDA_SUCCESS) return ERR_MAP_BASE + 2000 + (int)res;

  // The shared-memory attribute is set once per device and head dim.
  constexpr int MAX_DEVICES = 64;
  static bool attr_set[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES || !attr_set[dev]) {
    err = cudaFuncSetAttribute(flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Tiles<D>::SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    if (dev < MAX_DEVICES) attr_set[dev] = true;
  }
  dim3 grid((Sq + BLOCK_M - 1) / BLOCK_M, B * H);
  flash_fwd_kernel<D><<<grid, NUM_THREADS, Tiles<D>::SMEM_BYTES, stream>>>(
      map_q, map_k, map_v, static_cast<const float*>(bias), static_cast<bf16*>(o), H, Sq, Sk, d,
      st[9], st[10], st[11], st[12], scale_log2, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// strides: 13 int64 values, in elements: q (b, s, h), k (b, s, h), v (b, s, h),
// o (b, s, h), bias (b). The head dim D is a multiple of 8 from 16 to 128 and
// contiguous; q/k/v base pointers are 16-byte aligned and their strides
// multiples of 8 elements; o's rows are 4-byte aligned. bias may be null.
// Returns 0 on success; the cudaError_t of the launch; 100000 when
// cuTensorMapEncodeTiled is not to be had; or 101000 + 1000 * (0 q, 1 k, 2 v) + CUresult
// when a tensor map could not be encoded.
extern "C" int apex_flash_attn_fwd_bf16(const void* q, const void* k, const void* v,
                                        const void* bias, void* o, int B, int H, int Sq, int Sk,
                                        int D, const int64_t* strides, float scale_log2,
                                        int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D % 8 != 0 || D < 16 || D > 128) return (int)cudaErrorInvalidValue;
  if (D <= 64)
    return launch<64>(q, k, v, bias, o, B, H, Sq, Sk, D, strides, scale_log2, causal, s);
  return launch<128>(q, k, v, bias, o, B, H, Sq, Sk, D, strides, scale_log2, causal, s);
}

// Shared memory a block asks for at head dim D, for the record (bytes; 0 for
// a head dim the kernel does not take).
extern "C" int apex_flash_attn_smem_bytes(int D) {
  if (D % 8 != 0 || D < 16 || D > 128) return 0;
  return D <= 64 ? Tiles<64>::SMEM_BYTES : Tiles<128>::SMEM_BYTES;
}
