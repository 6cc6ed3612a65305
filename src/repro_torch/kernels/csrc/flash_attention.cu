// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 accumulation.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention / _kernel): causal or full attention with GQA, scale
// 1/sqrt(D), fp32 online softmax (m, l, acc), causal tiles above the
// diagonal skipped, output acc / max(l, 1e-37) in bf16.
//
// What bounds it on an H100: at the serving shapes (b=8, 32 heads, D=64,
// S=512) the causal work is ~8.6 GFLOP per layer against ~25 MB of
// q/k/v/o, ~340 FLOP/byte, so a tensor-core kernel sits near the ridge
// (~295 FLOP/byte for bf16) and a CUDA-core one is bound by its FMAs. This
// kernel therefore does both products on the tensor cores with
// mma.sync.m16n8k16 (bf16 -> fp32); wgmma, TMA and a producer warp are
// later work.
//
// Design. The TPU kernel walks a sequential grid (BH, q-tile, kv-tile) and
// carries m/l/acc in VMEM scratch from one grid step to the next. Blocks on
// a GPU run in parallel in no order, so here one block owns one
// (q-tile, b*h) pair and loops over the kv tiles itself, with m/l/acc in
// registers for the whole loop:
//   * grid (ceil(Sq/64), B*H), 4 warps; each warp owns 16 query rows whose
//     Q fragments stay in registers;
//   * per kv tile (64 rows): K and V are staged in shared memory (rows
//     padded by 8 elements so the fragment reads are bank-conflict free),
//     S = Q K^T by mma, the causal / length mask, the online-softmax update
//     with quad shuffles, then O += P V by mma with P re-packed from the S
//     accumulators (the C layout of m16n8 is the A layout of m16k16);
//   * ragged Sq / Skv are masked (zero-filled rows, -1e30 scores), not
//     asserted away; the causal mask is row + q_offset >= col, as in
//     repro.models.attention.chunked_attention;
//   * q, k, v are read in the model layout (b, s, heads, D) through their
//     strides, so no transpose is materialised; o is written (b, Sq, H, D).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_M = 64;   // query rows per block, 16 per warp
constexpr int BLOCK_N = 64;   // kv rows per loop iteration
constexpr int THREADS = 128;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> one register of two bf16, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo,
                                             __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// Stage rows [row0, row0 + 64) of one head into shared memory (row stride
// D + 8 elements); rows at or past `nrows` are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long row_stride, int row0,
                                          int nrows) {
  constexpr int SD = D + 8;
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < BLOCK_N * CHUNKS; idx += THREADS) {
    const int r = idx / CHUNKS, c = idx % CHUNKS;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nrows)
      val = *reinterpret_cast<const uint4*>(
          src + static_cast<long long>(row0 + r) * row_stride + c * 8);
    *reinterpret_cast<uint4*>(dst + r * SD + c * 8) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ o, int sq, int skv, int h,
                       int g, long long q_sb, long long q_ss, long long q_sh,
                       long long k_sb, long long k_ss, long long k_sh,
                       long long v_sb, long long v_ss, long long v_sh,
                       int q_offset, int causal, float scale) {
  static_assert(D % 16 == 0 && D <= 128, "D must be 16, 32, 64 or 128");
  constexpr int SD = D + 8;
  constexpr int KSTEPS = D / 16;        // k-steps of Q K^T
  constexpr int DTILES = D / 8;         // n-tiles of P V
  constexpr int NTILES = BLOCK_N / 8;   // n-tiles of S
  __shared__ __align__(16) __nv_bfloat16 sK[BLOCK_N * SD];
  __shared__ __align__(16) __nv_bfloat16 sV[BLOCK_N * SD];

  const int m0 = blockIdx.x * BLOCK_M;
  const int bi = blockIdx.y / h, hi = blockIdx.y % h;
  const int gi = hi / (h / g);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane >> 2, tig = lane & 3;

  const __nv_bfloat16* qb = q + bi * q_sb + hi * q_sh;
  const __nv_bfloat16* kb = k + bi * k_sb + gi * k_sh;
  const __nv_bfloat16* vb = v + bi * v_sb + gi * v_sh;

  // Q tile -> shared memory (sK doubles as its staging area) -> registers
  load_tile<D>(sK, qb, q_ss, m0, sq);
  __syncthreads();
  const int r0 = warp * 16 + grp;  // this thread's rows: r0 and r0 + 8
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    const __nv_bfloat16* p = sK + r0 * SD + ks * 16 + tig * 2;
    qf[ks][0] = *reinterpret_cast<const uint32_t*>(p);
    qf[ks][1] = *reinterpret_cast<const uint32_t*>(p + 8 * SD);
    qf[ks][2] = *reinterpret_cast<const uint32_t*>(p + 8);
    qf[ks][3] = *reinterpret_cast<const uint32_t*>(p + 8 * SD + 8);
  }
  __syncthreads();

  float acc[DTILES][4];
#pragma unroll
  for (int dt = 0; dt < DTILES; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF};
  float l_run[2] = {0.f, 0.f};
  // absolute positions of this thread's two rows, for the causal mask
  const int pos0 = q_offset + m0 + r0, pos1 = pos0 + 8;

  // the last kv column any row of this tile may see
  int n_end = skv;
  if (causal) n_end = min(skv, q_offset + m0 + BLOCK_M);

  for (int n0 = 0; n0 < n_end; n0 += BLOCK_N) {
    load_tile<D>(sK, kb, k_ss, n0, skv);
    load_tile<D>(sV, vb, v_ss, n0, skv);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 columns
    float s[NTILES][4];
#pragma unroll
    for (int nt = 0; nt < NTILES; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        const __nv_bfloat16* p = sK + (nt * 8 + grp) * SD + ks * 16 + tig * 2;
        mma_bf16(s[nt], qf[ks], *reinterpret_cast<const uint32_t*>(p),
                 *reinterpret_cast<const uint32_t*>(p + 8));
      }
    }

    // scale, mask, and the running row maxima
    float mx0 = m_run[0], mx1 = m_run[1];
#pragma unroll
    for (int nt = 0; nt < NTILES; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = n0 + nt * 8 + tig * 2 + (i & 1);
        const int pos = i < 2 ? pos0 : pos1;
        const bool ok = col < skv && (!causal || col <= pos);
        s[nt][i] = ok ? s[nt][i] * scale : NEG_INF;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    // the four threads of a quad hold one row between them
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));

    const float corr0 = __expf(m_run[0] - mx0);
    const float corr1 = __expf(m_run[1] - mx1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NTILES; ++nt) {
      s[nt][0] = __expf(s[nt][0] - mx0);
      s[nt][1] = __expf(s[nt][1] - mx0);
      s[nt][2] = __expf(s[nt][2] - mx1);
      s[nt][3] = __expf(s[nt][3] - mx1);
      sum0 += s[nt][0] + s[nt][1];
      sum1 += s[nt][2] + s[nt][3];
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
    for (int dt = 0; dt < DTILES; ++dt) {
      acc[dt][0] *= corr0;
      acc[dt][1] *= corr0;
      acc[dt][2] *= corr1;
      acc[dt][3] *= corr1;
    }

    // O += P V, P in bf16 as the reference casts it
#pragma unroll
    for (int kt = 0; kt < BLOCK_N / 16; ++kt) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kt][0], s[2 * kt][1]);
      a[1] = pack_bf16(s[2 * kt][2], s[2 * kt][3]);
      a[2] = pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]);
      a[3] = pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3]);
#pragma unroll
      for (int dt = 0; dt < DTILES; ++dt) {
        const __nv_bfloat16* p = sV + (kt * 16 + tig * 2) * SD + dt * 8 + grp;
        mma_bf16(acc[dt], a, pack_raw(p[0], p[SD]),
                 pack_raw(p[8 * SD], p[9 * SD]));
      }
    }
    __syncthreads();  // the next tile overwrites sK / sV
  }

  const float inv0 = 1.f / fmaxf(l_run[0], 1e-37f);
  const float inv1 = 1.f / fmaxf(l_run[1], 1e-37f);
  const int row0 = m0 + r0, row1 = row0 + 8;
  const long long o_row = static_cast<long long>(h) * D;
  __nv_bfloat16* ob = o + static_cast<long long>(bi) * sq * o_row + hi * D;
#pragma unroll
  for (int dt = 0; dt < DTILES; ++dt) {
    const int col = dt * 8 + tig * 2;
    if (row0 < sq)
      *reinterpret_cast<uint32_t*>(ob + row0 * o_row + col) =
          pack_bf16(acc[dt][0] * inv0, acc[dt][1] * inv0);
    if (row1 < sq)
      *reinterpret_cast<uint32_t*>(ob + row1 * o_row + col) =
          pack_bf16(acc[dt][2] * inv1, acc[dt][3] * inv1);
  }
}

template <int D>
void launch(const void* q, const void* k, const void* v, void* o, int b,
            int sq, int skv, int h, int g, long long q_sb, long long q_ss,
            long long q_sh, long long k_sb, long long k_ss, long long k_sh,
            long long v_sb, long long v_ss, long long v_sh, int q_offset,
            int causal, float scale, cudaStream_t stream) {
  const dim3 grid((sq + BLOCK_M - 1) / BLOCK_M, b * h);
  flash_attention_kernel<D><<<grid, THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      sq, skv, h, g, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
      q_offset, causal, scale);
}

}  // namespace

// Strides are in elements; the head dimension is contiguous and every
// other stride is a multiple of 8 (the wrapper checks both). Returns the
// launch's cudaGetLastError().
extern "C" int repro_flash_attention_bf16(
    const void* q, const void* k, const void* v, void* o, int b, int sq,
    int skv, int h, int g, int d, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, int q_offset, int causal,
    float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16:
      launch<16>(q, k, v, o, b, sq, skv, h, g, q_sb, q_ss, q_sh, k_sb, k_ss,
                 k_sh, v_sb, v_ss, v_sh, q_offset, causal, scale, s);
      break;
    case 32:
      launch<32>(q, k, v, o, b, sq, skv, h, g, q_sb, q_ss, q_sh, k_sb, k_ss,
                 k_sh, v_sb, v_ss, v_sh, q_offset, causal, scale, s);
      break;
    case 64:
      launch<64>(q, k, v, o, b, sq, skv, h, g, q_sb, q_ss, q_sh, k_sb, k_ss,
                 k_sh, v_sb, v_ss, v_sh, q_offset, causal, scale, s);
      break;
    case 128:
      launch<128>(q, k, v, o, b, sq, skv, h, g, q_sb, q_ss, q_sh, k_sb, k_ss,
                  k_sh, v_sb, v_ss, v_sh, q_offset, causal, scale, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
