// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 accumulation.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention / _kernel): causal or full attention with GQA, scale
// 1/sqrt(D), fp32 online softmax (m, l, acc), causal tiles above the
// diagonal skipped, P rounded to bf16 before P V, output acc / max(l, 1e-37)
// in bf16.
//
// What bounds it on an H100: at the serving shape (b=8, 32 heads, D=64,
// S=512, causal) the function moves ~67 MB of q/k/v/o and needs ~8.6 GFLOP
// (~128 FLOP/byte, under the ~295 FLOP/byte bf16 ridge), so its bound is
// bytes: 0.020 ms at 3.35 TB/s; at D = 128 and S = 4096 it is the
// FLOPs. In practice the tensor cores, the exponentials and the copies
// into shared memory bound it: at D=64 a tile needs one exp per 256 FLOP
// of products, which is the H100's ratio of bf16 to MUFU throughput (at
// D = 128 one per 512), and mma.sync reaches only part of the tensor-core
// rate. So every head dim from 64 up (stablelm, zamba2, granite-moe at 64;
// phi-3-vision at 96; yi-6b, deepseek-7b, phi3-medium-14b, phi3.5-moe at
// 128) runs a wgmma kernel; D = 16 and 32, which only the reduced configs
// use, keep an mma.sync kernel.
//
// Common to both kernels:
//   * one block owns one (b*h, q tile) pair and loops over the kv tiles
//     itself with m/l/acc in registers (the TPU kernel carries them across
//     a sequential grid axis, which GPU blocks do not have); the q tiles
//     are dispatched heaviest first, so the causal blocks with the most kv
//     tiles start first and the short ones fill the tail;
//   * K/V tiles of 64 rows come into a ring of stages in shared memory:
//     the next tiles are in flight while tile t is computed; rows past skv
//     are zero-filled by the copy and masked;
//   * the mask runs only on tiles that cross a warp's diagonal or the
//     ragged skv edge; a warp (warpgroup) whose rows all precede a tile
//     skips it;
//   * softmax in base 2: ex2.approx(s * scale * log2(e) - m * scale *
//     log2(e)), the scale folded into one FMA;
//   * the output is staged in the warp's own Q rows in shared memory and
//     stored 16 bytes at a time;
//   * when asked (a non-null `lse`), each query row's log-sum-exp L, fp32
//     (b, h, sq), which the training backward reads (row_lse); with a null
//     pointer the kernel computes and stores exactly what it did without.
// D = 64, 96, 128 (flash_attention_wgmma_kernel<D>): two warpgroups share
//   each kv tile, 64 query rows each (128-row q tiles, 256 threads); S =
//   Q K^T and O += P V on wgmma, the head dim in 64-column panels in the
//   128-byte swizzle; 2 resident blocks per SM. D = 64 copies its tiles
//   by cp.async into 3 stages; D = 96 and 128 by the Tensor Memory
//   Accelerator into 2 (the note above the kernel, WgCfg, gives the
//   arithmetic).
// D = 16, 32 (flash_attention_kernel<D>): 4 warps; each warp owns 32 query
//   rows (two m16 tiles sharing every K and V fragment); K/V tiles by
//   cp.async (16 bytes a thread) into 3 stages; fragments from ldmatrix
//   (Q, K) and ldmatrix.trans (V), rows padded by 8 elements so the 8 row
//   addresses of each 8x8 matrix fall in distinct banks; S and O on
//   mma.sync.m16n8k16, P re-packed from the S accumulators (the C layout
//   of m16n8 is the A layout of m16k16).
// repro_flash_attention_occupancy reports each instantiation's resident
// blocks per SM and the shape chosen for it. The causal mask is row +
// q_offset >= col, as in repro.models.attention.chunked_attention; q, k, v
// are read in the model layout (b, s, heads, D) through strides and o is
// written (b, Sq, H, D).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_N = 64;   // kv rows per loop iteration
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Cfg {
  static constexpr int MT = 2;                   // 16-row m-tiles a warp
  static constexpr int THREADS = 128;            // 4 warps
  static constexpr int BM = THREADS / 32 * 16 * MT;  // query rows per block
  static constexpr int SD = D + 8;               // padded row, elements
  static constexpr int STAGES = 3;               // kv tiles in the ring
  static constexpr int SMEM = (BM + 2 * STAGES * BLOCK_N) * SD * 2;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; `full` false zero-fills and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The row log-sum-exp of the natural-log scores s = q.k * scale, as the
// backward reads it (repro/models/attention.py _flash_fwd_stats: L = max(s)
// + ln(l)), from the base-2 running state of unscaled scores: the maximum
// m and l = sum 2^((q.k - m) * scale_log2) = sum e^(s - m * scale).
__device__ __forceinline__ float row_lse(float m, float l, float scale_log2) {
  constexpr float LN2 = 0.6931471805599453f;
  return (m * scale_log2 + log2f(fmaxf(l, 1e-37f))) * LN2;
}

// two floats -> one register of two bf16, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows [row0, row0 + ROWS) of one head -> shared memory (row stride SD);
// rows at or past `nrows` are zero-filled.
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long row_stride, int row0,
                                          int nrows) {
  constexpr int SD = Cfg<D>::SD, CHUNKS = D / 8, T = Cfg<D>::THREADS;
#pragma unroll
  for (int i = 0; i < (ROWS * CHUNKS + T - 1) / T; ++i) {
    const int idx = threadIdx.x + i * T;
    if ((ROWS * CHUNKS) % T && idx >= ROWS * CHUNKS) break;
    const int r = idx / CHUNKS, c = idx % CHUNKS;
    const bool ok = row0 + r < nrows;
    const __nv_bfloat16* p =
        ok ? src + static_cast<long long>(row0 + r) * row_stride + c * 8 : src;
    cp_async16(smem_u32(dst + r * SD + c * 8), p, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, 2)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, int sq, int skv, int h,
                       int g, long long q_sb, long long q_ss, long long q_sh,
                       long long k_sb, long long k_ss, long long k_sh,
                       long long v_sb, long long v_ss, long long v_sh,
                       int q_offset, int causal, float scale_log2) {
  static_assert(D == 16 || D == 32, "the wgmma kernel takes D >= 64");
  constexpr int BM = Cfg<D>::BM, SD = Cfg<D>::SD, MT = Cfg<D>::MT;
  constexpr int STAGES = Cfg<D>::STAGES;
  constexpr int WROWS = 16 * MT;        // query rows per warp
  constexpr int KSTEPS = D / 16;        // k-steps of Q K^T
  constexpr int DTILES = D / 8;         // n-tiles of P V
  constexpr int NTILES = BLOCK_N / 8;   // n-tiles of S
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + BM * SD;                 // [STAGES][BLOCK_N][SD]
  __nv_bfloat16* sV = sK + STAGES * BLOCK_N * SD;   // [STAGES][BLOCK_N][SD]

  const int bi = blockIdx.x / h, hi = blockIdx.x % h;
  const int gi = hi / (h / g);
  const int m0 = (gridDim.y - 1 - blockIdx.y) * BM;  // heaviest tiles first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane >> 2, tig = lane & 3;

  const __nv_bfloat16* qb = q + bi * q_sb + hi * q_sh;
  const __nv_bfloat16* kb = k + bi * k_sb + gi * k_sh;
  const __nv_bfloat16* vb = v + bi * v_sb + gi * v_sh;

  // the last kv column any row of this block may see
  const int n_end = causal ? min(skv, q_offset + m0 + BM) : skv;
  const int ntiles = (n_end + BLOCK_N - 1) / BLOCK_N;

  // prologue: Q and kv tiles 0 .. STAGES-2, one commit group per tile
  load_rows<D, BM>(sQ, qb, q_ss, m0, sq);
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < ntiles) {
      load_rows<D, BLOCK_N>(sK + t * BLOCK_N * SD, kb, k_ss, t * BLOCK_N, skv);
      load_rows<D, BLOCK_N>(sV + t * BLOCK_N * SD, vb, v_ss, t * BLOCK_N, skv);
    }
    cp_async_commit();
  }

  // absolute position of this warp's first row; m-tile mi's rows of this
  // thread are pos_lo + mi * 16 + grp and that + 8
  const int pos_lo = q_offset + m0 + warp * WROWS;

  uint32_t qf[MT][KSTEPS][4];
  float acc[MT][DTILES][4];
  float m_run[MT][2], l_run[MT][2];  // raw (unscaled) row maxima, sums
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
    for (int dt = 0; dt < DTILES; ++dt)
      acc[mi][dt][0] = acc[mi][dt][1] = acc[mi][dt][2] = acc[mi][dt][3] = 0.f;
    m_run[mi][0] = m_run[mi][1] = NEG_INF;
    l_run[mi][0] = l_run[mi][1] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    const int stage = t % STAGES;
    const int ahead = t + STAGES - 1;  // the tile to bring in now
    if (ahead < ntiles) {
      const int st = ahead % STAGES;
      load_rows<D, BLOCK_N>(sK + st * BLOCK_N * SD, kb, k_ss,
                            ahead * BLOCK_N, skv);
      load_rows<D, BLOCK_N>(sV + st * BLOCK_N * SD, vb, v_ss,
                            ahead * BLOCK_N, skv);
    }
    cp_async_commit();  // possibly empty: keeps the group count regular
    cp_async_wait<STAGES - 1>();  // groups up to tile t have landed
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks)
          ldsm_x4(qf[mi][ks],
                  smem_u32(sQ + (warp * WROWS + mi * 16 + (lane & 15)) * SD +
                           ks * 16 + (lane >> 4) * 8));
    }
    const int n0 = t * BLOCK_N;
    if (!causal || n0 <= pos_lo + WROWS - 1) {  // else every row of the
      const __nv_bfloat16* kt = sK + stage * BLOCK_N * SD;  // warp precedes
      const __nv_bfloat16* vt = sV + stage * BLOCK_N * SD;  // the tile

      // S = Q K^T for this warp's rows x 64 columns; each K fragment
      // serves every m-tile
      float s[MT][NTILES][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int nt = 0; nt < NTILES; ++nt)
          s[mi][nt][0] = s[mi][nt][1] = s[mi][nt][2] = s[mi][nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
#pragma unroll
        for (int np = 0; np < NTILES / 2; ++np) {
          uint32_t b[4];
          ldsm_x4(b, smem_u32(kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3))
                                       * SD + ks * 16 + ((lane >> 3) & 1) * 8));
#pragma unroll
          for (int mi = 0; mi < MT; ++mi) {
            mma_bf16(s[mi][2 * np], qf[mi][ks], b[0], b[1]);
            mma_bf16(s[mi][2 * np + 1], qf[mi][ks], b[2], b[3]);
          }
        }
      }

      // the mask, only on tiles that cross the diagonal or the skv edge
      if ((causal && n0 + BLOCK_N - 1 > pos_lo) || n0 + BLOCK_N > skv) {
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int nt = 0; nt < NTILES; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int col = n0 + nt * 8 + tig * 2 + (i & 1);
              const int pos = pos_lo + mi * 16 + grp + (i >> 1) * 8;
              if (col >= skv || (causal && col > pos)) s[mi][nt][i] = NEG_INF;
            }
      }

      // online softmax in base 2, the scale folded into one FMA
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        float mx0 = m_run[mi][0], mx1 = m_run[mi][1];
#pragma unroll
        for (int nt = 0; nt < NTILES; ++nt) {
          mx0 = fmaxf(mx0, fmaxf(s[mi][nt][0], s[mi][nt][1]));
          mx1 = fmaxf(mx1, fmaxf(s[mi][nt][2], s[mi][nt][3]));
        }
        // the four threads of a quad hold one row between them
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
        const float corr0 = fast_exp2((m_run[mi][0] - mx0) * scale_log2);
        const float corr1 = fast_exp2((m_run[mi][1] - mx1) * scale_log2);
        const float mb0 = mx0 * scale_log2, mb1 = mx1 * scale_log2;
        float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
        for (int nt = 0; nt < NTILES; ++nt) {
          s[mi][nt][0] = fast_exp2(fmaf(s[mi][nt][0], scale_log2, -mb0));
          s[mi][nt][1] = fast_exp2(fmaf(s[mi][nt][1], scale_log2, -mb0));
          s[mi][nt][2] = fast_exp2(fmaf(s[mi][nt][2], scale_log2, -mb1));
          s[mi][nt][3] = fast_exp2(fmaf(s[mi][nt][3], scale_log2, -mb1));
          sum0 += s[mi][nt][0] + s[mi][nt][1];
          sum1 += s[mi][nt][2] + s[mi][nt][3];
        }
        sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
        sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
        sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
        sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
        l_run[mi][0] = l_run[mi][0] * corr0 + sum0;
        l_run[mi][1] = l_run[mi][1] * corr1 + sum1;
        m_run[mi][0] = mx0;
        m_run[mi][1] = mx1;
#pragma unroll
        for (int dt = 0; dt < DTILES; ++dt) {
          acc[mi][dt][0] *= corr0;
          acc[mi][dt][1] *= corr0;
          acc[mi][dt][2] *= corr1;
          acc[mi][dt][3] *= corr1;
        }
      }

      // O += P V, P in bf16 as the reference casts it; each V fragment
      // serves every m-tile
#pragma unroll
      for (int kt2 = 0; kt2 < BLOCK_N / 16; ++kt2) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          a[mi][0] = pack_bf16(s[mi][2 * kt2][0], s[mi][2 * kt2][1]);
          a[mi][1] = pack_bf16(s[mi][2 * kt2][2], s[mi][2 * kt2][3]);
          a[mi][2] = pack_bf16(s[mi][2 * kt2 + 1][0], s[mi][2 * kt2 + 1][1]);
          a[mi][3] = pack_bf16(s[mi][2 * kt2 + 1][2], s[mi][2 * kt2 + 1][3]);
        }
#pragma unroll
        for (int dp = 0; dp < DTILES / 2; ++dp) {
          uint32_t b[4];
          ldsm_x4_t(b, smem_u32(vt + (kt2 * 16 + (lane & 7) +
                                      ((lane >> 3) & 1) * 8) * SD +
                                dp * 16 + (lane >> 4) * 8));
#pragma unroll
          for (int mi = 0; mi < MT; ++mi) {
            mma_bf16(acc[mi][2 * dp], a[mi], b[0], b[1]);
            mma_bf16(acc[mi][2 * dp + 1], a[mi], b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();  // the next iteration's copies overwrite this stage
  }

  // normalise, stage the warp's rows in its own Q rows, store 16 bytes at
  // a time
  __nv_bfloat16* so = sQ + warp * WROWS * SD;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
    const float inv0 = 1.f / fmaxf(l_run[mi][0], 1e-37f);
    const float inv1 = 1.f / fmaxf(l_run[mi][1], 1e-37f);
#pragma unroll
    for (int dt = 0; dt < DTILES; ++dt) {
      const int col = dt * 8 + tig * 2;
      *reinterpret_cast<uint32_t*>(so + (mi * 16 + grp) * SD + col) =
          pack_bf16(acc[mi][dt][0] * inv0, acc[mi][dt][1] * inv0);
      *reinterpret_cast<uint32_t*>(so + (mi * 16 + grp + 8) * SD + col) =
          pack_bf16(acc[mi][dt][2] * inv1, acc[mi][dt][3] * inv1);
    }
  }
  if (lse != nullptr && tig == 0) {
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = m0 + warp * WROWS + mi * 16 + grp + hf * 8;
        if (row < sq)
          lse[static_cast<long long>(blockIdx.x) * sq + row] =
              row_lse(m_run[mi][hf], l_run[mi][hf], scale_log2);
      }
  }
  __syncwarp();
  const long long o_row = static_cast<long long>(h) * D;
  __nv_bfloat16* ob = o + static_cast<long long>(bi) * sq * o_row + hi * D;
  constexpr int CHUNKS = D / 8;
  for (int idx = lane; idx < WROWS * CHUNKS; idx += 32) {
    const int r = idx / CHUNKS, c = idx % CHUNKS;
    const int row = m0 + warp * WROWS + r;
    if (row < sq)
      *reinterpret_cast<uint4*>(ob + row * o_row + c * 8) =
          *reinterpret_cast<const uint4*>(so + r * SD + c * 8);
  }
}

// ---------------------------------------------------------------------------
// D = 64, 96, 128: the warpgroup (wgmma) kernel.
//
// Two consumer warpgroups of 4 warps share each kv tile; warpgroup wg owns
// query rows [64 wg, 64 wg + 64) of a 128-row q tile. The head dim is cut
// into panels of 64 columns (128 bytes a row), each laid out in the
// 128-byte swizzle (16-byte piece c of row r at c ^ (r % 8)), which is
// also free of bank conflicts for the epilogue's stores; D = 96's second
// panel holds 32 columns. S = Q K^T is D / 16 k-steps of wgmma.m64n64k16
// with both operands read from shared memory through descriptors
// (K-major; a k-step's 32 bytes lie in one panel). O += P V is one
// wgmma.m64nDk16 a k-step of 16 kv rows, P from registers (the S
// accumulators re-packed to bf16: the wgmma accumulator layout of each
// warp is the m16n8 C layout, and its A register fragment the m16k16 A
// layout) and V read transposed through an MN-major descriptor whose
// leading byte offset is the panel stride (so n = 96 and 128 span two
// panels in one instruction).
constexpr int WG_BM = 128;                 // query rows per block
constexpr int WG_THREADS = 256;            // two warpgroups
constexpr int WG_PANEL = BLOCK_N * 128;    // bytes of one 64-row panel
constexpr int WG_Q_PANEL = WG_BM * 128;    // bytes of one 128-row panel
constexpr int WG_HEADS = 32;               // heads a launch-order group

// The shape of the kernel at head dim D (H100: 227 KB of shared memory a
// block, 228 KB and 65,536 registers an SM; two blocks an SM need <= 128
// registers a thread):
//   D = 64: Q 16 KB, a K + V stage 16 KB, 3 stages: 66,560 B with the
//     1 KB alignment pad; tiles copied by cp.async (16 bytes a thread);
//     <= 128 registers: 2 blocks an SM.
//   D = 96, 128: Q 32 KB (two panels), a K + V stage 32 KB, 2 stages:
//     99,328 B, so 2 blocks an SM if a thread stays at <= 128 registers.
//     O alone takes D / 2 of them (48, 64) and S 32. Copying a stage by
//     cp.async costs every thread 8 copies and their addresses: D = 128
//     then needs more than 128 registers and spills, and the kernel runs
//     1.25-1.45x slower (scripts/compare_k1.py --variants cp.async). So the
//     Tensor Memory Accelerator copies the tiles: one thread issues a
//     64-column box a panel (rows past the end, and D = 96's columns past
//     96, read as zeros) into the same swizzled layout, completing on an
//     mbarrier a stage; no other thread spends an instruction or a
//     register on it (D = 128: 124 registers, no spill). A design with one
//     block an SM (4 stages, each tile's P V running under the next
//     tile's softmax) was slower than two blocks.
template <int D>
struct WgCfg {
  static constexpr int NP = (D + 63) / 64;               // panels
  static constexpr int TILE = NP * WG_PANEL;             // K or V tile, bytes
  static constexpr bool TMA = D != 64;
  static constexpr int STAGES = TMA ? 2 : 3;
  static constexpr int SMEM = 1024 + NP * WG_Q_PANEL + 2 * STAGES * TILE;
};

// byte offset of 16-byte piece c of row r in a 128-byte-swizzled tile
__device__ __forceinline__ int sw128(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// shared-memory matrix descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

#define WG_R32                                                            \
  "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19," \
  "%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"
#define WG_R48                                                            \
  WG_R32 ",%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47"
#define WG_R64                                                            \
  WG_R48 ",%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63"
#define WG_OUT16(d)                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define WG_OUT32(d) WG_OUT16(d), WG_OUT16((d + 16))
#define WG_OUT48(d) WG_OUT32(d), WG_OUT16((d + 32))
#define WG_OUT64(d) WG_OUT32(d), WG_OUT32((d + 32))

// d (+)= A B, m64n64k16, A and B from shared memory (both K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" WG_R32
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_OUT32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B, m64nNk16 with N = 2 x the accumulators (64, 96, 128), A from
// registers, B from shared memory read transposed
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" WG_R32
      "}, {%32,%33,%34,%35}, %36, p, 1, 1, 1;\n}\n"
      : WG_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[48], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {" WG_R48
      "}, {%48,%49,%50,%51}, %52, p, 1, 1, 1;\n}\n"
      : WG_OUT48(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" WG_R64
      "}, {%64,%65,%66,%67}, %68, p, 1, 1, 1;\n}\n"
      : WG_OUT64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// mbarrier: `count` arrivals complete a phase
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
// one arrival, and `bytes` more to land before the phase completes
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
// until the phase of parity `phase` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int phase) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(phase)
        : "memory");
  } while (!done);
}

// One box of the tensor map `map` (4-d: head dim, rows, heads, batch) at
// (c0, c1, c2, c3) -> shared memory at dst, completing on mbarrier bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, int c3,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// Rows [row0, row0 + ROWS) of one head (D bf16 each) -> panels of ROWS
// 128-byte-swizzled rows by cp.async; rows at or past `nrows` are
// zero-filled.
template <int D, int ROWS>
__device__ __forceinline__ void load_sw(unsigned char* dst,
                                        const __nv_bfloat16* src,
                                        long long row_stride, int row0,
                                        int nrows) {
  constexpr int CH = D / 8;   // 16-byte pieces a row
  static_assert(ROWS * CH % WG_THREADS == 0, "pieces per thread");
#pragma unroll
  for (int i = 0; i < ROWS * CH / WG_THREADS; ++i) {
    const int idx = threadIdx.x + i * WG_THREADS;
    const int r = idx / CH, c = idx % CH;
    const bool ok = row0 + r < nrows;
    const __nv_bfloat16* p =
        ok ? src + static_cast<long long>(row0 + r) * row_stride + c * 8 : src;
    cp_async16(smem_u32(dst + (c >> 3) * ROWS * 128 + sw128(r, c & 7)), p,
               ok);
  }
}

// The mask (on tiles that cross the diagonal or the skv edge) and the
// online softmax of one tile's scores s, in base 2 with the scale folded
// into one FMA: m and l updated, P packed to bf16 (as the reference casts
// it) into pa, and the factor that rescales O returned in corr.
__device__ __forceinline__ void softmax_tile(float (&s)[32], float (&m_run)[2],
                                             float (&l_run)[2],
                                             uint32_t (&pa)[BLOCK_N / 16][4],
                                             float (&corr)[2], int n0,
                                             int pos_lo, int skv, int causal,
                                             float scale_log2) {
  constexpr int NTILES = BLOCK_N / 8;
  const int lane = threadIdx.x % 32, grp = lane >> 2, tig = lane & 3;
  if ((causal && n0 + BLOCK_N - 1 > pos_lo) || n0 + BLOCK_N > skv) {
#pragma unroll
    for (int nt = 0; nt < NTILES; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = n0 + nt * 8 + tig * 2 + (i & 1);
        const int pos = pos_lo + grp + (i >> 1) * 8;
        if (col >= skv || (causal && col > pos)) s[4 * nt + i] = NEG_INF;
      }
  }
  float mx0 = m_run[0], mx1 = m_run[1];
#pragma unroll
  for (int nt = 0; nt < NTILES; ++nt) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * nt], s[4 * nt + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * nt + 2], s[4 * nt + 3]));
  }
  // the four threads of a quad hold one row between them
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  corr[0] = fast_exp2((m_run[0] - mx0) * scale_log2);
  corr[1] = fast_exp2((m_run[1] - mx1) * scale_log2);
  const float mb0 = mx0 * scale_log2, mb1 = mx1 * scale_log2;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < NTILES; ++nt) {
    s[4 * nt] = fast_exp2(fmaf(s[4 * nt], scale_log2, -mb0));
    s[4 * nt + 1] = fast_exp2(fmaf(s[4 * nt + 1], scale_log2, -mb0));
    s[4 * nt + 2] = fast_exp2(fmaf(s[4 * nt + 2], scale_log2, -mb1));
    s[4 * nt + 3] = fast_exp2(fmaf(s[4 * nt + 3], scale_log2, -mb1));
    sum0 += s[4 * nt] + s[4 * nt + 1];
    sum1 += s[4 * nt + 2] + s[4 * nt + 3];
  }
  sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
  sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
  sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
  sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
  l_run[0] = l_run[0] * corr[0] + sum0;
  l_run[1] = l_run[1] * corr[1] + sum1;
  m_run[0] = mx0;
  m_run[1] = mx1;
#pragma unroll
  for (int kt = 0; kt < BLOCK_N / 16; ++kt) {
    pa[kt][0] = pack_bf16(s[8 * kt], s[8 * kt + 1]);
    pa[kt][1] = pack_bf16(s[8 * kt + 2], s[8 * kt + 3]);
    pa[kt][2] = pack_bf16(s[8 * kt + 4], s[8 * kt + 5]);
    pa[kt][3] = pack_bf16(s[8 * kt + 6], s[8 * kt + 7]);
  }
}

template <int D>
__global__ void __launch_bounds__(WG_THREADS, 2)
flash_attention_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             __nv_bfloat16* __restrict__ o,
                             float* __restrict__ lse, int sq, int skv,
                             int h, int g, long long q_sb, long long q_ss,
                             long long q_sh, long long k_sb, long long k_ss,
                             long long k_sh, long long v_sb, long long v_ss,
                             long long v_sh, int q_offset, int causal,
                             float scale_log2, int heads,
                             const __grid_constant__ CUtensorMap q_map,
                             const __grid_constant__ CUtensorMap k_map,
                             const __grid_constant__ CUtensorMap v_map) {
  using C = WgCfg<D>;
  constexpr int STAGES = C::STAGES, NP = C::NP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[STAGES + 1];  // (TMA) tiles, Q
  // the swizzle repeats every 1024 bytes: align the tiles to it
  unsigned char* sm =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sQ = sm;                          // [NP][WG_BM][128 B]
  unsigned char* sK = sQ + NP * WG_Q_PANEL;        // [STAGES][NP] panels
  unsigned char* sV = sK + STAGES * C::TILE;       // [STAGES][NP] panels

  // this block's (batch x head, q tile): in launch order, groups of
  // `heads` heads each walk their q tiles heaviest first (one group of
  // all heads on the cp.async path)
  int bh = blockIdx.x, qt = gridDim.y - 1 - blockIdx.y;
  if constexpr (C::TMA) {
    const int n = blockIdx.x + gridDim.x * blockIdx.y, nq = gridDim.y;
    const int grp0 = n / (heads * nq) * heads;
    const int gsz = min(heads, static_cast<int>(gridDim.x) - grp0);
    const int in = n - grp0 * nq;
    bh = grp0 + in % gsz;
    qt = nq - 1 - in / gsz;
  }
  const int bi = bh / h, hi = bh % h;
  const int gi = hi / (h / g);
  const int m0 = qt * WG_BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp >> 2, ww = warp & 3;
  const int grp = lane >> 2, tig = lane & 3;

  const __nv_bfloat16* kb = k + bi * k_sb + gi * k_sh;
  const __nv_bfloat16* vb = v + bi * v_sb + gi * v_sh;

  const int n_end = causal ? min(skv, q_offset + m0 + WG_BM) : skv;
  const int ntiles = (n_end + BLOCK_N - 1) / BLOCK_N;

  // tile t's K and V into stage t % STAGES: by TMA from one thread, or by
  // cp.async from every thread
  auto load_tile = [&](int t) {
    const int st = t % STAGES;
    if constexpr (C::TMA) {
      if (threadIdx.x == 0) {
        const uint32_t bar = smem_u32(&bars[st]);
        mbar_expect(bar, 2 * C::TILE);
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          tma_load(smem_u32(sK + st * C::TILE + p * WG_PANEL), &k_map,
                   64 * p, t * BLOCK_N, gi, bi, bar);
          tma_load(smem_u32(sV + st * C::TILE + p * WG_PANEL), &v_map,
                   64 * p, t * BLOCK_N, gi, bi, bar);
        }
      }
    } else {
      load_sw<D, BLOCK_N>(sK + st * C::TILE, kb, k_ss, t * BLOCK_N, skv);
      load_sw<D, BLOCK_N>(sV + st * C::TILE, vb, v_ss, t * BLOCK_N, skv);
    }
  };

  // prologue: Q and kv tiles 0 .. STAGES-2
  if constexpr (C::TMA) {
    if (threadIdx.x == 0) {
#pragma unroll
      for (int i = 0; i <= STAGES; ++i) mbar_init(smem_u32(&bars[i]), 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      const uint32_t bar = smem_u32(&bars[STAGES]);
      mbar_expect(bar, NP * WG_Q_PANEL);
#pragma unroll
      for (int p = 0; p < NP; ++p)
        tma_load(smem_u32(sQ + p * WG_Q_PANEL), &q_map, 64 * p, m0, hi, bi,
                 bar);
    }
#pragma unroll
    for (int t = 0; t < STAGES - 1; ++t)
      if (t < ntiles) load_tile(t);
  } else {
    load_sw<D, WG_BM>(sQ, q + bi * q_sb + hi * q_sh, q_ss, m0, sq);
#pragma unroll
    for (int t = 0; t < STAGES - 1; ++t) {
      if (t < ntiles) load_tile(t);
      cp_async_commit();
    }
  }

  // first absolute position of the warpgroup's and of the warp's rows
  const int pos_wg = q_offset + m0 + wg * 64;
  const int pos_lo = pos_wg + ww * 16;
  const uint32_t q_tile = smem_u32(sQ + wg * 64 * 128);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF};  // raw (unscaled) row maxima
  float l_run[2] = {0.f, 0.f};

  for (int t = 0; t < ntiles; ++t) {
    const int stage = t % STAGES;
    const int ahead = t + STAGES - 1;  // the tile to bring in now, into the
    if (ahead < ntiles) load_tile(ahead);  // stage freed by the last sync
    if constexpr (C::TMA) {
      if (t == 0) mbar_wait(smem_u32(&bars[STAGES]), 0);
      mbar_wait(smem_u32(&bars[stage]), (t / STAGES) & 1);
    } else {
      cp_async_commit();
      cp_async_wait<STAGES - 1>();  // groups up to tile t have landed
      fence_proxy_async();          // ... and are visible to wgmma
      __syncthreads();
    }
    const int n0 = t * BLOCK_N;
    // skipped when the warpgroup's rows all precede the tile, or (D >= 96)
    // lie past sq
    if ((!causal || n0 <= pos_wg + 63) && (!C::TMA || m0 + wg * 64 < sq)) {
      const uint32_t kt = smem_u32(sK + stage * C::TILE);
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {  // 32 bytes of a panel a k-step
        const int off = (ks & 3) * 32;
        wgmma_ss(s, gmma_desc(q_tile + (ks >> 2) * WG_Q_PANEL + off, 16, 1024),
                 gmma_desc(kt + (ks >> 2) * WG_PANEL + off, 16, 1024), ks);
      }
      wgmma_commit();
      wgmma_wait0();
      uint32_t pa[BLOCK_N / 16][4];
      float corr[2];
      softmax_tile(s, m_run, l_run, pa, corr, n0, pos_lo, skv, causal,
                   scale_log2);
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        acc[4 * nt] *= corr[0];
        acc[4 * nt + 1] *= corr[0];
        acc[4 * nt + 2] *= corr[1];
        acc[4 * nt + 3] *= corr[1];
      }
      // O += P V: 4 k-steps of 16 kv rows, N = D across the panels
      const uint32_t vt = smem_u32(sV + stage * C::TILE);
      wgmma_fence();
#pragma unroll
      for (int kt2 = 0; kt2 < BLOCK_N / 16; ++kt2)
        wgmma_rs(acc, pa[kt2], gmma_desc(vt + kt2 * 16 * 128,
                                         D == 64 ? 16 : WG_PANEL, 1024));
      wgmma_commit();
      wgmma_wait0();
    }
    __syncthreads();  // the next iteration's copies overwrite a stage
  }

  // normalise, stage the warp's 16 rows in its own (swizzled) Q rows,
  // store 16 bytes at a time
  const float inv0 = 1.f / fmaxf(l_run[0], 1e-37f);
  const float inv1 = 1.f / fmaxf(l_run[1], 1e-37f);
  const int r0 = wg * 64 + ww * 16;  // the warp's first row in the q tile
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    unsigned char* panel = sQ + (nt >> 3) * WG_Q_PANEL;
    const int ra = r0 + grp, rb = ra + 8;
    *reinterpret_cast<uint32_t*>(panel + sw128(ra, nt & 7) + tig * 4) =
        pack_bf16(acc[4 * nt] * inv0, acc[4 * nt + 1] * inv0);
    *reinterpret_cast<uint32_t*>(panel + sw128(rb, nt & 7) + tig * 4) =
        pack_bf16(acc[4 * nt + 2] * inv1, acc[4 * nt + 3] * inv1);
  }
  if (lse != nullptr && tig == 0) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = m0 + r0 + grp + hf * 8;
      if (row < sq)
        lse[static_cast<long long>(bh) * sq + row] =
            row_lse(m_run[hf], l_run[hf], scale_log2);
    }
  }
  __syncwarp();
  const long long o_row = static_cast<long long>(h) * D;
  __nv_bfloat16* ob = o + static_cast<long long>(bi) * sq * o_row + hi * D;
  constexpr int CH = D / 8;
#pragma unroll
  for (int i = 0; i < 16 * CH / 32; ++i) {
    const int idx = lane + 32 * i;
    const int r = idx / CH, c = idx % CH;
    const int row = m0 + r0 + r;
    if (row < sq)
      *reinterpret_cast<uint4*>(ob + row * o_row + c * 8) =
          *reinterpret_cast<const uint4*>(sQ + (c >> 3) * WG_Q_PANEL +
                                          sw128(r0 + r, c & 7));
  }
}

// cuTensorMapEncodeTiled, a libcuda function, found through the runtime
// so the library needs no link against libcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// bytes of L2 cache on the current device (read once)
double l2_bytes() {
  static int bytes = 0;
  if (bytes == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&bytes, cudaDevAttrL2CacheSize, dev) !=
            cudaSuccess)
      bytes = 50 << 20;
  }
  return bytes;
}

// A tensor map of one (b, rows, heads, D) operand read through its element
// strides: boxes of 64 columns (one 128-byte-swizzled panel) by `box_rows`
// rows of one head; what lies outside the tensor reads as zeros.
int make_map(CUtensorMap* map, const void* base, int d, int rows, int heads,
             int batch, long long s_row, long long s_head, long long s_batch,
             int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s_row) * 2,
                                 static_cast<cuuint64_t>(s_head) * 2,
                                 static_cast<cuuint64_t>(s_batch) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return static_cast<int>(encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

// Raises the kernel's dynamic shared memory limit once (above 48 KB it
// must be asked for).
template <int D>
cudaError_t configure() {
  static bool done = false;
  if (done) return cudaSuccess;
  cudaError_t err;
  if constexpr (D >= 64)
    err = cudaFuncSetAttribute(flash_attention_wgmma_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               WgCfg<D>::SMEM);
  else
    err = cudaFuncSetAttribute(flash_attention_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Cfg<D>::SMEM);
  if (err == cudaSuccess) done = true;
  return err;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int b, int sq, int skv, int h, int g, long long q_sb, long long q_ss,
           long long q_sh, long long k_sb, long long k_ss, long long k_sh,
           long long v_sb, long long v_ss, long long v_sh, int q_offset,
           int causal, float scale_log2, cudaStream_t stream) {
  const cudaError_t err = configure<D>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const __nv_bfloat16* qp = static_cast<const __nv_bfloat16*>(q);
  const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(k);
  const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(v);
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(o);
  if constexpr (D >= 64) {
    CUtensorMap q_map{}, k_map{}, v_map{};
    int heads = b * h;
    if constexpr (WgCfg<D>::TMA) {
      // while the K and V of the whole call fill more than half the L2,
      // groups of WG_HEADS heads in launch order, so the blocks resident
      // at once (2 an SM) read the K and V of about 264 / (q tiles) heads,
      // which L2 keeps (deepseek-7b's prefill, 4 q tiles: 66 heads, 17 MB,
      // of 67 MB); else every head's heaviest q tile first, the better
      // spread of work over the last wave
      if (4.0 * b * g * skv * D > 0.5 * l2_bytes()) heads = WG_HEADS;
      int rc = make_map(&q_map, q, D, sq, h, b, q_ss, q_sh, q_sb, WG_BM);
      if (!rc) rc = make_map(&k_map, k, D, skv, g, b, k_ss, k_sh, k_sb, BLOCK_N);
      if (!rc) rc = make_map(&v_map, v, D, skv, g, b, v_ss, v_sh, v_sb, BLOCK_N);
      if (rc) return rc;
    }
    const dim3 grid(b * h, (sq + WG_BM - 1) / WG_BM);
    flash_attention_wgmma_kernel<D>
        <<<grid, WG_THREADS, WgCfg<D>::SMEM, stream>>>(
            qp, kp, vp, op, lse, sq, skv, h, g, q_sb, q_ss, q_sh, k_sb, k_ss,
            k_sh, v_sb, v_ss, v_sh, q_offset, causal, scale_log2, heads,
            q_map, k_map, v_map);
  } else {
    const dim3 grid(b * h, (sq + Cfg<D>::BM - 1) / Cfg<D>::BM);
    flash_attention_kernel<D><<<grid, Cfg<D>::THREADS, Cfg<D>::SMEM,
                                stream>>>(
        qp, kp, vp, op, lse, sq, skv, h, g, q_sb, q_ss, q_sh, k_sb, k_ss,
        k_sh, v_sb, v_ss, v_sh, q_offset, causal, scale_log2);
  }
  return 0;
}

template <int D>
int occupancy(int* blocks, int* smem_bytes, int* wgmma, int* stages,
              int* tma) {
  const cudaError_t err = configure<D>();
  if (err != cudaSuccess) return static_cast<int>(err);
  if constexpr (D >= 64) {
    *smem_bytes = WgCfg<D>::SMEM;
    *wgmma = 1;
    *stages = WgCfg<D>::STAGES;
    *tma = WgCfg<D>::TMA;
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, flash_attention_wgmma_kernel<D>, WG_THREADS,
        WgCfg<D>::SMEM));
  } else {
    *smem_bytes = Cfg<D>::SMEM;
    *wgmma = 0;
    *stages = Cfg<D>::STAGES;
    *tma = 0;
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, flash_attention_kernel<D>, Cfg<D>::THREADS, Cfg<D>::SMEM));
  }
}

}  // namespace

// Strides are in elements; the head dimension is contiguous and every
// other stride is a multiple of 8 (the wrapper checks both). `lse` is null,
// or fp32 (b, h, sq) contiguous and receives each query row's log-sum-exp
// (row_lse). Returns the launch's cudaGetLastError().
extern "C" int repro_flash_attention_bf16(
    const void* q, const void* k, const void* v, void* o, void* lse, int b,
    int sq, int skv, int h, int g, int d, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, int q_offset, int causal,
    float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  const float sl2 = scale * LOG2E;
  int rc;
  switch (d) {
    case 16:
      rc = launch<16>(q, k, v, o, lse_f, b, sq, skv, h, g, q_sb, q_ss, q_sh,
                      k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, q_offset, causal,
                      sl2, s);
      break;
    case 32:
      rc = launch<32>(q, k, v, o, lse_f, b, sq, skv, h, g, q_sb, q_ss, q_sh,
                      k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, q_offset, causal,
                      sl2, s);
      break;
    case 64:
      rc = launch<64>(q, k, v, o, lse_f, b, sq, skv, h, g, q_sb, q_ss, q_sh,
                      k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, q_offset, causal,
                      sl2, s);
      break;
    case 96:
      rc = launch<96>(q, k, v, o, lse_f, b, sq, skv, h, g, q_sb, q_ss, q_sh,
                      k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, q_offset, causal,
                      sl2, s);
      break;
    case 128:
      rc = launch<128>(q, k, v, o, lse_f, b, sq, skv, h, g, q_sb, q_ss, q_sh,
                      k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, q_offset, causal,
                      sl2, s);
      break;
    default:
      rc = static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc) return rc;
  return static_cast<int>(cudaGetLastError());
}

// The shape chosen for head dim d: resident blocks per SM, dynamic shared
// memory in bytes, whether it runs the wgmma kernel (else mma.sync), the
// stages of its kv ring, and whether the Tensor Memory Accelerator copies
// its tiles (else cp.async) (WgCfg, Cfg). Returns a CUDA error code.
extern "C" int repro_flash_attention_occupancy(int d, int device, int* blocks,
                                               int* smem_bytes, int* wgmma,
                                               int* stages, int* tma) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (d) {
    case 16: return occupancy<16>(blocks, smem_bytes, wgmma, stages, tma);
    case 32: return occupancy<32>(blocks, smem_bytes, wgmma, stages, tma);
    case 64: return occupancy<64>(blocks, smem_bytes, wgmma, stages, tma);
    case 96: return occupancy<96>(blocks, smem_bytes, wgmma, stages, tma);
    case 128: return occupancy<128>(blocks, smem_bytes, wgmma, stages, tma);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
