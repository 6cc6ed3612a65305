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
// bytes: 0.020 ms at 3.35 TB/s. In practice the tensor cores and the
// exponentials bound it: at D=64 a tile needs one exp per 256 FLOP of
// products, which is the H100's ratio of bf16 to MUFU throughput, and
// mma.sync reaches only part of the tensor-core rate. So D=64, the head
// dim of every served model, gets a wgmma kernel; the other head dims
// keep an mma.sync kernel.
//
// Common to both kernels:
//   * one block owns one (b*h, q tile) pair and loops over the kv tiles
//     itself with m/l/acc in registers (the TPU kernel carries them across
//     a sequential grid axis, which GPU blocks do not have); grid
//     (b*h, q tiles) with the q tile index reversed, so the causal blocks
//     with the most kv tiles are dispatched first and the short ones fill
//     the tail;
//   * K/V tiles of 64 rows come in by cp.async (16 bytes a thread, loops
//     unrolled at compile time) into a 3-stage ring in shared memory
//     (2 stages at D = 128): tiles t+1 and t+2 are in flight while tile t
//     is computed; rows past skv are zero-filled by the copy (src-size 0)
//     and masked;
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
// D = 64 (flash_attention_wgmma_kernel): two warpgroups share each kv
//   tile, 64 query rows each (128-row q tiles, 256 threads); S = Q K^T and
//   O += P V on wgmma.m64n64k16 (see the note above the kernel); tiles in
//   the 128-byte swizzle; ~66 KB of shared memory and <= 128 registers a
//   thread: 2 resident blocks per SM.
// D = 16, 32, 96, 128 (flash_attention_kernel): 4 warps; each warp owns
//   32 query rows (two m16 tiles sharing every K and V fragment) for
//   D <= 64, 16 rows for D = 96 and 128; fragments from ldmatrix (Q, K) and
//   ldmatrix.trans (V), rows padded by 8 elements so the 8 row addresses
//   of each 8x8 matrix fall in distinct banks; S and O on
//   mma.sync.m16n8k16, P re-packed from the S accumulators (the C layout
//   of m16n8 is the A layout of m16k16). D = 96 (phi-3-vision) needs no
//   code of its own: 6 k-steps and 12 n-tiles, rows of 104 elements
//   (208 B: 16-byte aligned, and the 8 row addresses of an ldmatrix fall
//   in distinct banks), 64-row q tiles, 3 stages, 93,184 B.
// repro_flash_attention_occupancy reports each instantiation's resident
// blocks per SM. The causal mask is row + q_offset >= col, as in
// repro.models.attention.chunked_attention; q, k, v are read in the model
// layout (b, s, heads, D) through strides and o is written (b, Sq, H, D).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_N = 64;   // kv rows per loop iteration
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Cfg {
  static constexpr int MT = D <= 64 ? 2 : 1;     // 16-row m-tiles a warp
  static constexpr int THREADS = 128;            // 4 warps
  static constexpr int BM = THREADS / 32 * 16 * MT;  // query rows per block
  static constexpr int SD = D + 8;               // padded row, elements
  // kv tiles in the shared-memory ring: 2 at D = 128 keep two blocks per SM
  static constexpr int STAGES = D == 128 ? 2 : 3;
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
  static_assert(D % 16 == 0 && D <= 128,
                "D must be 16, 32, 64, 96 or 128");
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
// D = 64: the warpgroup (wgmma) kernel.
//
// Two consumer warpgroups of 4 warps share each kv tile; warpgroup wg owns
// query rows [64 wg, 64 wg + 64) of a 128-row q tile. S = Q K^T is
// wgmma.m64n64k16 with both operands read from shared memory through
// descriptors (K-major, 128-byte swizzle); O += P V is wgmma.m64n64k16 with
// P from registers (the S accumulators re-packed to bf16: the wgmma
// accumulator layout of each warp is the m16n8 C layout, and its A register
// fragment the m16k16 A layout) and V read transposed through an MN-major
// descriptor. Tiles are copied by cp.async into a 3-stage ring laid out in
// the 128-byte swizzle (16-byte piece c of row r at c ^ (r % 8)), which is
// also free of bank conflicts for the epilogue's stores.
constexpr int WG_BM = 128;                 // query rows per block
constexpr int WG_THREADS = 256;            // two warpgroups
constexpr int WG_STAGES = 3;               // kv tiles in the ring
constexpr int WG_TILE = BLOCK_N * 128;     // bytes of one 64 x 64 bf16 tile
constexpr int WG_SMEM = 1024 + WG_BM * 128 + 2 * WG_STAGES * WG_TILE;

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

#define WG_D32                                                            \
  "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19," \
  "%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}"
#define WG_OUT32(d)                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),     \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),     \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),     \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),     \
      "+f"(d[31])

// d (+)= A B, A and B from shared memory (both K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_OUT32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B, A from registers, B from shared memory read transposed
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", {%32,%33,%34,%35}, %36, p, 1, 1, 1;\n}\n"
      : WG_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Rows [row0, row0 + ROWS) of one head (64 bf16 each) -> a 128-byte-swizzled
// tile; rows at or past `nrows` are zero-filled.
template <int ROWS>
__device__ __forceinline__ void load_sw(unsigned char* dst,
                                        const __nv_bfloat16* src,
                                        long long row_stride, int row0,
                                        int nrows) {
#pragma unroll
  for (int i = 0; i < ROWS * 8 / WG_THREADS; ++i) {
    const int idx = threadIdx.x + i * WG_THREADS;
    const int r = idx >> 3, c = idx & 7;
    const bool ok = row0 + r < nrows;
    const __nv_bfloat16* p =
        ok ? src + static_cast<long long>(row0 + r) * row_stride + c * 8 : src;
    cp_async16(smem_u32(dst + sw128(r, c)), p, ok);
  }
}

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
                             float scale_log2) {
  constexpr int D = 64, NTILES = BLOCK_N / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the swizzle repeats every 1024 bytes: align the tiles to it
  unsigned char* sm =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sQ = sm;                                // [WG_BM][128 B]
  unsigned char* sK = sQ + WG_BM * 128;                  // [STAGES] tiles
  unsigned char* sV = sK + WG_STAGES * WG_TILE;          // [STAGES] tiles

  const int bi = blockIdx.x / h, hi = blockIdx.x % h;
  const int gi = hi / (h / g);
  const int m0 = (gridDim.y - 1 - blockIdx.y) * WG_BM;  // heaviest first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp >> 2, ww = warp & 3;
  const int grp = lane >> 2, tig = lane & 3;

  const __nv_bfloat16* qb = q + bi * q_sb + hi * q_sh;
  const __nv_bfloat16* kb = k + bi * k_sb + gi * k_sh;
  const __nv_bfloat16* vb = v + bi * v_sb + gi * v_sh;

  const int n_end = causal ? min(skv, q_offset + m0 + WG_BM) : skv;
  const int ntiles = (n_end + BLOCK_N - 1) / BLOCK_N;

  load_sw<WG_BM>(sQ, qb, q_ss, m0, sq);
#pragma unroll
  for (int t = 0; t < WG_STAGES - 1; ++t) {
    if (t < ntiles) {
      load_sw<BLOCK_N>(sK + t * WG_TILE, kb, k_ss, t * BLOCK_N, skv);
      load_sw<BLOCK_N>(sV + t * WG_TILE, vb, v_ss, t * BLOCK_N, skv);
    }
    cp_async_commit();
  }

  // first absolute position of the warpgroup's and of the warp's rows
  const int pos_wg = q_offset + m0 + wg * 64;
  const int pos_lo = pos_wg + ww * 16;
  const uint64_t q_desc = gmma_desc(smem_u32(sQ + wg * 64 * 128), 16, 1024);

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF};  // raw (unscaled) row maxima
  float l_run[2] = {0.f, 0.f};

  for (int t = 0; t < ntiles; ++t) {
    const int stage = t % WG_STAGES;
    const int ahead = t + WG_STAGES - 1;
    if (ahead < ntiles) {
      const int st = ahead % WG_STAGES;
      load_sw<BLOCK_N>(sK + st * WG_TILE, kb, k_ss, ahead * BLOCK_N, skv);
      load_sw<BLOCK_N>(sV + st * WG_TILE, vb, v_ss, ahead * BLOCK_N, skv);
    }
    cp_async_commit();
    cp_async_wait<WG_STAGES - 1>();  // groups up to tile t have landed
    fence_proxy_async();             // ... and are visible to wgmma
    __syncthreads();
    const int n0 = t * BLOCK_N;
    if (!causal || n0 <= pos_wg + 63) {  // else the warpgroup precedes it
      const uint32_t kt = smem_u32(sK + stage * WG_TILE);
      const uint32_t vt = smem_u32(sV + stage * WG_TILE);
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)  // 32 bytes of K per k-step
        wgmma_ss(s, q_desc + 2 * ks, gmma_desc(kt + 32 * ks, 16, 1024), ks);
      wgmma_commit();
      wgmma_wait0();

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
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float corr0 = fast_exp2((m_run[0] - mx0) * scale_log2);
      const float corr1 = fast_exp2((m_run[1] - mx1) * scale_log2);
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
      l_run[0] = l_run[0] * corr0 + sum0;
      l_run[1] = l_run[1] * corr1 + sum1;
      m_run[0] = mx0;
      m_run[1] = mx1;
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        acc[4 * nt] *= corr0;
        acc[4 * nt + 1] *= corr0;
        acc[4 * nt + 2] *= corr1;
        acc[4 * nt + 3] *= corr1;
      }
      // O += P V, P in bf16 as the reference casts it
      uint32_t pa[BLOCK_N / 16][4];
#pragma unroll
      for (int kt2 = 0; kt2 < BLOCK_N / 16; ++kt2) {
        pa[kt2][0] = pack_bf16(s[8 * kt2], s[8 * kt2 + 1]);
        pa[kt2][1] = pack_bf16(s[8 * kt2 + 2], s[8 * kt2 + 3]);
        pa[kt2][2] = pack_bf16(s[8 * kt2 + 4], s[8 * kt2 + 5]);
        pa[kt2][3] = pack_bf16(s[8 * kt2 + 6], s[8 * kt2 + 7]);
      }
      wgmma_fence();
#pragma unroll
      for (int kt2 = 0; kt2 < BLOCK_N / 16; ++kt2)  // 16 kv rows a k-step
        wgmma_rs(acc, pa[kt2],
                 gmma_desc(vt + kt2 * 16 * 128, 16, 1024));
      wgmma_commit();
      wgmma_wait0();
    }
    __syncthreads();  // the next iteration's copies overwrite this stage
  }

  // normalise, stage the warp's 16 rows in its own (swizzled) Q rows,
  // store 16 bytes at a time
  const float inv0 = 1.f / fmaxf(l_run[0], 1e-37f);
  const float inv1 = 1.f / fmaxf(l_run[1], 1e-37f);
  const int r0 = wg * 64 + ww * 16;  // the warp's first row in the q tile
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const int ra = r0 + grp, rb = ra + 8;
    *reinterpret_cast<uint32_t*>(sQ + sw128(ra, nt) + tig * 4) =
        pack_bf16(acc[4 * nt] * inv0, acc[4 * nt + 1] * inv0);
    *reinterpret_cast<uint32_t*>(sQ + sw128(rb, nt) + tig * 4) =
        pack_bf16(acc[4 * nt + 2] * inv1, acc[4 * nt + 3] * inv1);
  }
  if (lse != nullptr && tig == 0) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = m0 + r0 + grp + hf * 8;
      if (row < sq)
        lse[static_cast<long long>(blockIdx.x) * sq + row] =
            row_lse(m_run[hf], l_run[hf], scale_log2);
    }
  }
  __syncwarp();
  const long long o_row = static_cast<long long>(h) * D;
  __nv_bfloat16* ob = o + static_cast<long long>(bi) * sq * o_row + hi * D;
#pragma unroll
  for (int i = 0; i < 16 * 8 / 32; ++i) {
    const int idx = lane + 32 * i;
    const int r = idx >> 3, c = idx & 7;
    const int row = m0 + r0 + r;
    if (row < sq)
      *reinterpret_cast<uint4*>(ob + row * o_row + c * 8) =
          *reinterpret_cast<const uint4*>(sQ + sw128(r0 + r, c));
  }
}

// Raises the kernel's dynamic shared memory limit once (above 48 KB it
// must be asked for).
template <int D>
cudaError_t configure() {
  static bool done = false;
  if (done) return cudaSuccess;
  cudaError_t err;
  if constexpr (D == 64)
    err = cudaFuncSetAttribute(flash_attention_wgmma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               WG_SMEM);
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
  if constexpr (D == 64) {
    const dim3 grid(b * h, (sq + WG_BM - 1) / WG_BM);
    flash_attention_wgmma_kernel<<<grid, WG_THREADS, WG_SMEM, stream>>>(
        qp, kp, vp, op, lse, sq, skv, h, g, q_sb, q_ss, q_sh, k_sb, k_ss,
        k_sh, v_sb, v_ss, v_sh, q_offset, causal, scale_log2);
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
int occupancy(int* blocks, int* smem_bytes) {
  const cudaError_t err = configure<D>();
  if (err != cudaSuccess) return static_cast<int>(err);
  if constexpr (D == 64) {
    *smem_bytes = WG_SMEM;
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, flash_attention_wgmma_kernel, WG_THREADS, WG_SMEM));
  } else {
    *smem_bytes = Cfg<D>::SMEM;
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

// Resident blocks per SM of the instantiation for head dim d, and its
// dynamic shared memory in bytes. Returns a CUDA error code.
extern "C" int repro_flash_attention_occupancy(int d, int device, int* blocks,
                                               int* smem_bytes) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (d) {
    case 16: return occupancy<16>(blocks, smem_bytes);
    case 32: return occupancy<32>(blocks, smem_bytes);
    case 64: return occupancy<64>(blocks, smem_bytes);
    case 96: return occupancy<96>(blocks, smem_bytes);
    case 128: return occupancy<128>(blocks, smem_bytes);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
