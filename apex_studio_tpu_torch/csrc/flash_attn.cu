// Forward flash attention for Hopper (sm_90a), bf16 in, f32 accumulate.
//
// Replaces the Pallas TPU kernel apex_studio_tpu/ops/attention/pallas_flash.py
// (_flash_kernel, launched by _flash_call). Same function: exact softmax
// attention over BSHD q/k/v with an online softmax in base 2, an optional
// additive key-padding bias [B, Sk], a ragged-Sk tail mask and an optional
// causal mask (top-left aligned; the wrapper only accepts Sq == Sk).
//
// Design (simple and correct first):
// - One block per (64-query tile, batch*head); 4 warps, each owns 16 rows.
// - K/V tiles of 64 keys are staged in shared memory with cp.async and
//   double-buffered: tile j+1 loads while tile j computes.
// - S = Q K^T and O += P V run on the tensor cores with mma.sync m16n8k16
//   (bf16 x bf16 -> f32). Q fragments stay in registers for the whole sweep;
//   P is re-packed from the S accumulators into A fragments without touching
//   shared memory. ldmatrix (.trans for V) feeds the B operands; rows are
//   padded by 8 elements so the eight row addresses hit distinct banks.
// - Running max and sum live in registers; scores are scaled by
//   scale*log2(e) in f32 and exponentiated with exp2f.
// - Masked keys: the tail (k >= Sk) and the causal upper triangle get -inf
//   and drop out; a bias of -1e30 stays finite, so a row whose keys are all
//   masked by the bias averages V uniformly, as the JAX reference does.
// - BSHD is read and written through strides; tails are masked in-kernel
//   (zero-filled shared rows, guarded stores): no fold, pad or transpose copy.
//
// Bound on an H100 SXM at the Flux Dev 1024px shape (B=1, S=4608, H=24,
// D=128): 4*B*H*Sq*Sk*D = 2.61e11 FLOP -> 0.264 ms at 989 TFLOP/s bf16, while
// q/k/v/o are 113 MB -> 0.034 ms at 3.35 TB/s. The kernel is bound by tensor
// core operations; mma.sync cannot reach the wgmma rate, so a TMA + wgmma
// redesign is the next step for speed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BLOCK_M = 64;
constexpr int BLOCK_N = 64;
constexpr int NUM_THREADS = 128;
constexpr int PAD = 8;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                            uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                                  uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Stage rows [row0, row0 + 64) of one (batch, head) slice into shared memory
// (row stride D + PAD). Rows at or past n_valid are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g, int64_t row_stride, int row0,
                                          int n_valid, int tid) {
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  constexpr int LD = D + PAD;
#pragma unroll
  for (int c = tid; c < 64 * CHUNKS; c += NUM_THREADS) {
    const int r = c / CHUNKS;
    const int col = (c % CHUNKS) * 8;
    bf16* dst = s + r * LD + col;
    if (row0 + r < n_valid) {
      cp_async_16(smem_u32(dst), g + (int64_t)(row0 + r) * row_stride + col);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NUM_THREADS)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const float* __restrict__ bias,
                     bf16* __restrict__ o, int H, int Sq, int Sk, int64_t q_sb, int64_t q_ss,
                     int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
                     int64_t v_ss, int64_t v_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh,
                     int64_t bias_sb, float scale_log2, int causal) {
  constexpr int LD = D + PAD;
  constexpr int KSTEPS = D / 16;    // k-steps of Q K^T
  constexpr int NT_S = BLOCK_N / 8; // n-tiles of S per warp
  constexpr int NT_O = D / 8;       // n-tiles of O per warp

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + BLOCK_M * LD;      // two stages
  bf16* sV = sK + 2 * BLOCK_N * LD;  // two stages

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // row within the 8-row group of an mma fragment
  const int t4 = lane & 3;  // column pair within the fragment
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * BLOCK_M;

  const bf16* qb = q + b * q_sb + h * q_sh;
  const bf16* kb = k + b * k_sb + h * k_sh;
  const bf16* vb = v + b * v_sb + h * v_sh;
  bf16* ob = o + b * o_sb + h * o_sh;
  const float* biasb = bias ? bias + b * bias_sb : nullptr;

  int n_tiles = (Sk + BLOCK_N - 1) / BLOCK_N;
  if (causal) {
    // Tiles wholly above the diagonal are skipped.
    const int q_hi = min(q0 + BLOCK_M - 1, Sq - 1);
    n_tiles = min(n_tiles, q_hi / BLOCK_N + 1);
  }

  load_tile<D>(sQ, qb, q_ss, q0, Sq, tid);
  load_tile<D>(sK, kb, k_ss, 0, Sk, tid);
  load_tile<D>(sV, vb, v_ss, 0, Sk, tid);
  cp_async_commit();

  uint32_t qf[KSTEPS][4];
  float acc[NT_O][4];
#pragma unroll
  for (int i = 0; i < NT_O; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  const int row_a = q0 + warp * 16 + g;  // this thread's rows: row_a and row_a + 8

  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j & 1;
    if (j + 1 < n_tiles) {
      const int ns = stage ^ 1;
      load_tile<D>(sK + ns * BLOCK_N * LD, kb, k_ss, (j + 1) * BLOCK_N, Sk, tid);
      load_tile<D>(sV + ns * BLOCK_N * LD, vb, v_ss, (j + 1) * BLOCK_N, Sk, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (j == 0) {
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        const bf16* p = sQ + (warp * 16 + (lane & 15)) * LD + ks * 16 + (lane >> 4) * 8;
        ldmatrix_x4(smem_u32(p), qf[ks][0], qf[ks][1], qf[ks][2], qf[ks][3]);
      }
    }

    // S = Q K^T for this warp's 16 rows x 64 keys.
    const bf16* sKs = sK + stage * BLOCK_N * LD;
    float s[NT_S][4];
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ks += 2) {
#pragma unroll
      for (int nt = 0; nt < NT_S; ++nt) {
        const bf16* p = sKs + (nt * 8 + (lane & 7)) * LD + ks * 16 + (lane >> 3) * 8;
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4(smem_u32(p), b0, b1, b2, b3);
        mma_16816(s[nt], qf[ks], b0, b1);
        mma_16816(s[nt], qf[ks + 1], b2, b3);
      }
    }

    // Scale into base 2, add the bias, mask the tail and the diagonal.
    const int k0 = j * BLOCK_N;
    const bool tail = k0 + BLOCK_N > Sk;
    const bool diag = causal && (k0 + BLOCK_N - 1 > q0);
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + t4 * 2 + (e & 1);
        const int row = row_a + (e >> 1) * 8;
        float x = s[nt][e] * scale_log2;
        if (biasb != nullptr && col < Sk) x += __ldg(biasb + col) * LOG2E;
        if (tail && col >= Sk) x = -INFINITY;
        if (diag && col > row) x = -INFINITY;
        s[nt][e] = x;
      }
    }

    // Online softmax: rows are shared by the 4 threads of a quad.
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
    float corr[2];
    float rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_use = mx[r] == -INFINITY ? 0.f : mx[r];
      corr[r] = exp2f(m_run[r] - m_use);
      m_run[r] = mx[r];
      mx[r] = m_use;
    }
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - mx[0]);
      s[nt][1] = exp2f(s[nt][1] - mx[0]);
      s[nt][2] = exp2f(s[nt][2] - mx[1]);
      s[nt][3] = exp2f(s[nt][3] - mx[1]);
      rsum[0] += s[nt][0] + s[nt][1];
      rsum[1] += s[nt][2] + s[nt][3];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * corr[r] + rsum[r];
#pragma unroll
    for (int nt = 0; nt < NT_O; ++nt) {
      acc[nt][0] *= corr[0];
      acc[nt][1] *= corr[0];
      acc[nt][2] *= corr[1];
      acc[nt][3] *= corr[1];
    }

    // O += P V: the S accumulators of key n-tiles (2kk, 2kk+1) are the
    // A fragment of key k-step kk.
    const bf16* sVs = sV + stage * BLOCK_N * LD;
#pragma unroll
    for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int nt = 0; nt < NT_O; nt += 2) {
        const bf16* p = sVs + (kk * 16 + (lane & 15)) * LD + nt * 8 + (lane >> 4) * 8;
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4_trans(smem_u32(p), b0, b1, b2, b3);
        mma_16816(acc[nt], a, b0, b1);
        mma_16816(acc[nt + 1], a, b2, b3);
      }
    }
    __syncthreads();  // the next iteration's prefetch overwrites this stage
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  const float inv0 = 1.f / fmaxf(l_run[0], 1e-30f);
  const float inv1 = 1.f / fmaxf(l_run[1], 1e-30f);
#pragma unroll
  for (int nt = 0; nt < NT_O; ++nt) {
    const int col = nt * 8 + t4 * 2;
    if (row_a < Sq) {
      *reinterpret_cast<uint32_t*>(ob + row_a * o_ss + col) =
          pack_bf16(acc[nt][0] * inv0, acc[nt][1] * inv0);
    }
    if (row_a + 8 < Sq) {
      *reinterpret_cast<uint32_t*>(ob + (row_a + 8) * o_ss + col) =
          pack_bf16(acc[nt][2] * inv1, acc[nt][3] * inv1);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias, void* o, int B,
                   int H, int Sq, int Sk, const int64_t* st, float scale_log2, int causal,
                   cudaStream_t stream) {
  constexpr int LD = D + PAD;
  const int smem = (BLOCK_M + 4 * BLOCK_N) * LD * (int)sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BLOCK_M - 1) / BLOCK_M, B * H);
  flash_fwd_kernel<D><<<grid, NUM_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(bias), static_cast<bf16*>(o), H, Sq, Sk, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], st[12], scale_log2,
      causal);
  return cudaGetLastError();
}

}  // namespace

// strides: 13 int64 values, in elements: q (b, s, h), k (b, s, h), v (b, s, h),
// o (b, s, h), bias (b). The head dim is contiguous. bias may be null.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int apex_flash_attn_fwd_bf16(const void* q, const void* k, const void* v,
                                        const void* bias, void* o, int B, int H, int Sq, int Sk,
                                        int D, const int64_t* strides, float scale_log2,
                                        int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return (int)launch<64>(q, k, v, bias, o, B, H, Sq, Sk, strides, scale_log2, causal, s);
    case 128:
      return (int)launch<128>(q, k, v, bias, o, B, H, Sq, Sk, strides, scale_log2, causal, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
