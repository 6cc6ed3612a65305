// Flash-attention backward for Hopper (sm_90a): dq, dk, dv of causal or
// full attention with GQA, bf16 in and out, fp32 accumulation.
//
// Replaces no TPU kernel: the JAX package's backward is plain JAX
// (src/repro/models/attention.py _flash_bwd_rule), which the port ran as
// plain PyTorch in fp32 (models/attention.py _flash_bwd). It takes what the
// forward (csrc/flash_attention.cu) saved: q, k, v, o and the row
// log-sum-exp L, fp32 (b, h, sq), and rebuilds each probability tile
// P = exp(q.k * scale - L); with delta = rowsum(do * o):
//   dv = P^T do,  dP = do v^T,  dS = P * (dP - delta),
//   dq = scale * dS k,  dk = scale * dS^T q.
// P and dS are rounded to bf16 before their products, as the forward
// rounds P before P V; every product is bf16 on the tensor cores with fp32
// accumulation.
//
// What bounds it on an H100: at stablelm-1.6b's training shape (b 8, S 512,
// 32 heads of 64, causal) a call needs ~30 GFLOP (seven products over the
// causal triangle, the scores and dP computed in both passes below) and
// moves ~135 MB (q, k, v, o, do read, dq, dk, dv written once), ~225 FLOP
// a byte: under the bf16 ridge (~295), so the bytes bound it (0.040 ms at
// 3.35 TB/s; the products alone 0.030 ms at 989 TFLOP/s). In practice the
// exponentials and the serial chain of products inside a tile bound it:
// every tile issues two products whose results the next two need. So the
// design keeps every intermediate on the chip and overlaps what it can:
//   * two kernels, neither with atomics, every sum in a fixed order (two
//     calls give the same bits): flash_attention_bwd_dq_kernel owns one
//     (b, head, 64 query rows) and walks the kv tiles up to the diagonal;
//     flash_attention_bwd_dkdv_kernel owns one (b, kv head, 64 kv rows) and
//     walks the query tiles from the diagonal on, for every query head of
//     its GQA group in turn. The dq kernel runs first and also writes
//     delta and L * log2(e) for its rows into a scratch (b*h, 2, sq
//     rounded up to 64), the rows past sq padded so that P reads 0 there,
//     which the dkdv kernel then copies in whole tiles;
//   * one warpgroup (128 threads) a block, 64 rows a warpgroup, every
//     product on wgmma: S and dP (and S^T, dP^T) with both operands read
//     from shared memory, dq, dk and dv with P or dS from registers (the
//     accumulators re-packed to bf16) and the other operand read
//     transposed, as csrc/flash_attention.cu does O += P V;
//   * the resident operands (K and V in dkdv, Q and dO in dq) and a ring of
//     the walked tiles come into shared memory by the Tensor Memory
//     Accelerator, 64-column 128-byte-swizzled panels, completing on an
//     mbarrier a stage: no thread spends registers on the copies, which the
//     two fp32 accumulators of dkdv (dk and dv, D each) need;
//   * inside a tile, the second product of a pair runs while the first's
//     result is used: the scores' exponentials under dP, dS under dv;
//   * the causal tiles above the diagonal are never visited; the mask runs
//     only on the diagonal tile and the ragged edge; rows past the end are
//     read as zeros by the copies and never stored;
//   * D = 64: 3 stages and 3 resident blocks an SM; D = 96, 128: 2 and 2
//     (BwdCfg). D = 16 and 32 reach it padded to 64 by the wrapper.
// The helpers below repeat csrc/flash_attention.cu's (each source is
// built into its own library, and a shared header would escape the build's
// digest of the source).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;             // rows of every q and kv tile
constexpr int THREADS = 128;         // one warpgroup
constexpr int PANEL = TILE * 128;    // bytes of 64 rows x 64 bf16 columns
constexpr int STAT_BYTES = 2 * TILE * 4;  // a tile's L * log2(e) and delta
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct BwdCfg {
  static constexpr int NP = (D + 63) / 64;            // 64-column panels
  static constexpr int T = NP * PANEL;                // one tile, bytes
  static constexpr int STAGES = D == 64 ? 3 : 2;      // walked tiles in flight
  static constexpr int BLOCKS = D == 64 ? 3 : 2;      // resident an SM
  // dq: Q and dO resident, a ring of K and V, its rows' L and delta
  static constexpr int DQ_SMEM = 1024 + 2 * T + STAGES * 2 * T + STAT_BYTES;
  // dkdv: K and V resident, a ring of Q, dO and their rows' L and delta
  static constexpr int DKDV_SMEM =
      1024 + 2 * T + STAGES * 2 * T + STAGES * STAT_BYTES;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats -> one register of two bf16, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// byte offset of 16-byte piece c of row r in a 128-byte-swizzled panel
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
// until at most N of this warpgroup's committed groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
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

// `bytes` contiguous bytes (a multiple of 16, both ends 16-byte aligned)
// global -> shared, completing on mbarrier bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The NP panels of one 64-row tile (rows row0.., head `head`, batch bi)
// of the operand `map` into dst, completing on bar.
template <int NP>
__device__ __forceinline__ void tile_load(unsigned char* dst,
                                          const CUtensorMap* map, int row0,
                                          int head, int bi, uint32_t bar) {
#pragma unroll
  for (int p = 0; p < NP; ++p)
    tma_load(smem_u32(dst + p * PANEL), map, 64 * p, row0, head, bi, bar);
}

// acc (+)= A B^T over the head dim: A and B are 64-row tiles of NP panels
// (K-major), D / 16 k-steps of wgmma.m64n64k16, the first overwriting acc.
template <int D>
__device__ __forceinline__ void product_ss(float (&acc)[32], uint32_t a,
                                           uint32_t b) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {  // 32 bytes of a panel a k-step
    const int off = (ks >> 2) * PANEL + (ks & 3) * 32;
    wgmma_ss(acc, gmma_desc(a + off, 16, 1024), gmma_desc(b + off, 16, 1024),
             ks);
  }
}

// acc += A B: A the 64 x 64 bf16 fragments in registers (4 k-steps of 16),
// B the 64-row tile at b read transposed, N = D across its panels
template <int D>
__device__ __forceinline__ void product_rs(float (&acc)[D / 2],
                                           const uint32_t (&a)[4][4],
                                           uint32_t b) {
#pragma unroll
  for (int kt = 0; kt < 4; ++kt)
    wgmma_rs(acc, a[kt], gmma_desc(b + kt * 16 * 128, D == 64 ? 16 : PANEL,
                                   1024));
}

// A 64 x 64 accumulator (the wgmma layout: each warp 16 rows; element
// 4 nt + i of a thread at row grp + 8 (i >> 1), column 8 nt + 2 tig +
// (i & 1)) -> the bf16 A fragments of its 4 k-steps of 16 columns.
__device__ __forceinline__ void pack_a(const float (&x)[32],
                                       uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kt = 0; kt < 4; ++kt) {
    a[kt][0] = pack_bf16(x[8 * kt], x[8 * kt + 1]);
    a[kt][1] = pack_bf16(x[8 * kt + 2], x[8 * kt + 3]);
    a[kt][2] = pack_bf16(x[8 * kt + 4], x[8 * kt + 5]);
    a[kt][3] = pack_bf16(x[8 * kt + 6], x[8 * kt + 7]);
  }
}

// acc * scale in bf16 -> the warp's 16 rows (r0..) of the swizzled tile
// `tile`, then rows row0 + r0 + r < nrows stored 16 bytes at a time to
// `out` (row stride `row_stride` elements).
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2],
                                           float scale, unsigned char* tile,
                                           __nv_bfloat16* out,
                                           long long row_stride, int row0,
                                           int nrows) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane >> 2, tig = lane & 3;
  const int r0 = warp * 16;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    unsigned char* panel = tile + (nt >> 3) * PANEL;
    const int ra = r0 + grp, rb = ra + 8;
    *reinterpret_cast<uint32_t*>(panel + sw128(ra, nt & 7) + tig * 4) =
        pack_bf16(acc[4 * nt] * scale, acc[4 * nt + 1] * scale);
    *reinterpret_cast<uint32_t*>(panel + sw128(rb, nt & 7) + tig * 4) =
        pack_bf16(acc[4 * nt + 2] * scale, acc[4 * nt + 3] * scale);
  }
  __syncwarp();
  constexpr int CH = D / 8;
#pragma unroll
  for (int i = 0; i < 16 * CH / 32; ++i) {
    const int idx = lane + 32 * i;
    const int r = idx / CH, c = idx % CH;
    const int row = row0 + r0 + r;
    if (row < nrows)
      *reinterpret_cast<uint4*>(out + row * row_stride + c * 8) =
          *reinterpret_cast<const uint4*>(tile + (c >> 3) * PANEL +
                                          sw128(r0 + r, c & 7));
  }
}

// ---------------------------------------------------------------------------
// dq, and the rows' delta and L * log2(e) for the dkdv kernel
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(THREADS, BwdCfg<D>::BLOCKS)
flash_attention_bwd_dq_kernel(
    const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, __nv_bfloat16* __restrict__ dq,
    float* __restrict__ stats, int sq, int skv, int h, int g, int sq_pad,
    long long o_sb, long long o_ss, long long o_sh, long long d_sb,
    long long d_ss, long long d_sh, int causal, float scale,
    float scale_log2, const __grid_constant__ CUtensorMap q_map,
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map,
    const __grid_constant__ CUtensorMap do_map) {
  using C = BwdCfg<D>;
  constexpr int STAGES = C::STAGES, NP = C::NP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[STAGES + 1];  // kv stages, Q + dO
  unsigned char* sm =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sQ = sm;
  unsigned char* sdO = sQ + C::T;
  unsigned char* sK = sdO + C::T;                  // [STAGES] tiles
  unsigned char* sV = sK + STAGES * C::T;          // [STAGES] tiles
  float* sStat = reinterpret_cast<float*>(sV + STAGES * C::T);  // L2, delta

  const int bh = blockIdx.x, qt = gridDim.y - 1 - blockIdx.y;  // heaviest
  const int bi = bh / h, hi = bh % h, gi = hi / (h / g);     // first
  const int m0 = qt * TILE;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane >> 2, tig = lane & 3;
  const int n_end = causal ? min(skv, m0 + TILE) : skv;
  const int ntiles = (n_end + TILE - 1) / TILE;

  auto load_kv = [&](int t) {
    const uint32_t bar = smem_u32(&bars[t % STAGES]);
    mbar_expect(bar, 2 * C::T);
    tile_load<NP>(sK + (t % STAGES) * C::T, &k_map, t * TILE, gi, bi, bar);
    tile_load<NP>(sV + (t % STAGES) * C::T, &v_map, t * TILE, gi, bi, bar);
  };
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i <= STAGES; ++i) mbar_init(smem_u32(&bars[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const uint32_t bar = smem_u32(&bars[STAGES]);
    mbar_expect(bar, 2 * C::T);
    tile_load<NP>(sQ, &q_map, m0, hi, bi, bar);
    tile_load<NP>(sdO, &do_map, m0, hi, bi, bar);
#pragma unroll
    for (int t = 0; t < STAGES - 1; ++t)
      if (t < ntiles) load_kv(t);
  }

  // delta = rowsum(dO * O) in fp32, two threads a row, in column order
  {
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
    const int row = m0 + r;
    float acc = 0.f;
    if (row < sq) {
      const __nv_bfloat16* op = o + bi * o_sb + row * o_ss + hi * o_sh;
      const __nv_bfloat16* dp = dout + bi * d_sb + row * d_ss + hi * d_sh;
#pragma unroll
      for (int c = half * D / 16; c < (half + 1) * D / 16; ++c) {
        const uint4 a = *reinterpret_cast<const uint4*>(op + c * 8);
        const uint4 b = *reinterpret_cast<const uint4*>(dp + c * 8);
        const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
        const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 fa = __bfloat1622float2(a2[j]);
          const float2 fb = __bfloat1622float2(b2[j]);
          acc = fmaf(fa.x, fb.x, acc);
          acc = fmaf(fa.y, fb.y, acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      // rows past sq: P reads exp2(-inf) = 0 there, and delta 0
      const float l2 =
          row < sq ? lse[static_cast<long long>(bh) * sq + row] * LOG2E
                   : INFINITY;
      const float dl = row < sq ? acc : 0.f;
      sStat[r] = l2;
      sStat[TILE + r] = dl;
      float* st = stats + static_cast<long long>(bh) * 2 * sq_pad + m0 + r;
      st[0] = l2;
      st[sq_pad] = dl;
    }
  }
  __syncthreads();  // the rows' L2 and delta
  const int ra = warp * 16 + grp;  // this thread's rows: ra, ra + 8
  const float l2[2] = {sStat[ra], sStat[ra + 8]};
  const float dl[2] = {sStat[TILE + ra], sStat[TILE + ra + 8]};
  const int pos = m0 + ra;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const int stage = t % STAGES;
    if (threadIdx.x == 0 && t + STAGES - 1 < ntiles) load_kv(t + STAGES - 1);
    if (t == 0) mbar_wait(smem_u32(&bars[STAGES]), 0);
    mbar_wait(smem_u32(&bars[stage]), (t / STAGES) & 1);
    const uint32_t kt = smem_u32(sK + stage * C::T);
    const uint32_t vt = smem_u32(sV + stage * C::T);
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    wgmma_fence();
    product_ss<D>(s, smem_u32(sQ), kt);   // S = Q K^T
    wgmma_commit();
    product_ss<D>(dp, smem_u32(sdO), vt);  // dP = dO V^T
    wgmma_commit();
    wgmma_wait<1>();
    // P = exp2(S * scale * log2(e) - L * log2(e)), masked on the diagonal
    // tile and the ragged kv edge
    const int n0 = t * TILE;
    const bool edge =
        (causal && n0 + TILE - 1 > m0 + warp * 16) || n0 + TILE > skv;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float p = fast_exp2(fmaf(s[4 * nt + i], scale_log2, -l2[i >> 1]));
        if (edge) {
          const int col = n0 + nt * 8 + tig * 2 + (i & 1);
          if (col >= skv || (causal && col > pos + (i >> 1) * 8)) p = 0.f;
        }
        s[4 * nt + i] = p;
      }
    wgmma_wait<0>();
    // dS = P (dP - delta), in bf16
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] *= dp[i] - dl[(i >> 1) & 1];
    uint32_t ds[4][4];
    pack_a(s, ds);
    wgmma_fence();
    product_rs<D>(acc, ds, kt);  // dQ += dS K
    wgmma_commit();
    wgmma_wait<0>();
    __syncthreads();  // the next iteration's copies overwrite a stage
  }
  const long long row_stride = static_cast<long long>(h) * D;
  store_rows<D>(acc, scale, sQ,
                dq + static_cast<long long>(bi) * sq * row_stride + hi * D,
                row_stride, m0, sq);
}

// ---------------------------------------------------------------------------
// dk and dv
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(THREADS, BwdCfg<D>::BLOCKS)
flash_attention_bwd_dkdv_kernel(
    const float* __restrict__ stats, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int sq, int skv, int h, int g,
    int sq_pad, int causal, float scale, float scale_log2,
    const __grid_constant__ CUtensorMap q_map,
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map,
    const __grid_constant__ CUtensorMap do_map) {
  using C = BwdCfg<D>;
  constexpr int STAGES = C::STAGES, NP = C::NP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[STAGES + 1];  // q stages, K + V
  unsigned char* sm =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sK = sm;
  unsigned char* sV = sK + C::T;
  unsigned char* sQ = sV + C::T;                   // [STAGES] tiles
  unsigned char* sdO = sQ + STAGES * C::T;         // [STAGES] tiles
  float* sStat = reinterpret_cast<float*>(sdO + STAGES * C::T);
  //               [STAGES][L2 (64), delta (64)]

  const int bg = blockIdx.x, kt = blockIdx.y;  // kv tile 0 has most work
  const int bi = bg / g, gi = bg % g, m = h / g;
  const int n0 = kt * TILE;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane >> 2, tig = lane & 3;
  // the q tiles that see this kv tile, for each of the group's m heads
  const int nq = (sq + TILE - 1) / TILE;
  const int qt0 = causal ? kt : 0;
  const int nqt = max(0, nq - qt0);
  const int n_it = m * nqt;

  auto load_q = [&](int it) {
    const int st = it % STAGES;
    const int hi = gi * m + it / nqt, q0 = (qt0 + it % nqt) * TILE;
    const uint32_t bar = smem_u32(&bars[st]);
    mbar_expect(bar, 2 * C::T + STAT_BYTES);
    tile_load<NP>(sQ + st * C::T, &q_map, q0, hi, bi, bar);
    tile_load<NP>(sdO + st * C::T, &do_map, q0, hi, bi, bar);
    const float* src =
        stats + (static_cast<long long>(bi) * h + hi) * 2 * sq_pad + q0;
    bulk_load(smem_u32(sStat + st * 2 * TILE), src, TILE * 4, bar);
    bulk_load(smem_u32(sStat + st * 2 * TILE + TILE), src + sq_pad, TILE * 4,
              bar);
  };
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i <= STAGES; ++i) mbar_init(smem_u32(&bars[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the barriers' init
  if (threadIdx.x == 0) {
    if (n_it > 0) {
      const uint32_t bar = smem_u32(&bars[STAGES]);
      mbar_expect(bar, 2 * C::T);
      tile_load<NP>(sK, &k_map, n0, gi, bi, bar);
      tile_load<NP>(sV, &v_map, n0, gi, bi, bar);
#pragma unroll
      for (int it = 0; it < STAGES - 1; ++it)
        if (it < n_it) load_q(it);
    }
  }

  const int pos = n0 + warp * 16 + grp;  // this thread's kv rows: pos, +8
  const uint32_t k_tile = smem_u32(sK), v_tile = smem_u32(sV);
  float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int stage = it % STAGES;
    if (threadIdx.x == 0 && it + STAGES - 1 < n_it) load_q(it + STAGES - 1);
    if (it == 0) mbar_wait(smem_u32(&bars[STAGES]), 0);
    mbar_wait(smem_u32(&bars[stage]), (it / STAGES) & 1);
    const int q0 = (qt0 + it % nqt) * TILE;
    const uint32_t qt = smem_u32(sQ + stage * C::T);
    const uint32_t dot = smem_u32(sdO + stage * C::T);
    const float* l2 = sStat + stage * 2 * TILE;
    const float* dl = l2 + TILE;
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    wgmma_fence();
    product_ss<D>(s, k_tile, qt);    // S^T = K Q^T
    wgmma_commit();
    product_ss<D>(dp, v_tile, dot);  // dP^T = V dO^T
    wgmma_commit();
    wgmma_wait<1>();
    // P^T: column c is query row q0 + c; masked on the diagonal tile
    const bool edge = causal && q0 < n0 + TILE - 1;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 l = *reinterpret_cast<const float2*>(l2 + nt * 8 + tig * 2);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float p = fast_exp2(fmaf(s[4 * nt + i], scale_log2,
                                 -((i & 1) ? l.y : l.x)));
        if (edge && q0 + nt * 8 + tig * 2 + (i & 1) < pos + (i >> 1) * 8)
          p = 0.f;
        s[4 * nt + i] = p;
      }
    }
    uint32_t pa[4][4];
    pack_a(s, pa);
    wgmma_fence();
    product_rs<D>(acc_v, pa, dot);  // dV += P^T dO
    wgmma_commit();
    wgmma_wait<1>();  // dP^T has landed; dV runs on
    // dS^T = P^T (dP^T - delta), in bf16
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 d = *reinterpret_cast<const float2*>(dl + nt * 8 + tig * 2);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        s[4 * nt + i] *= dp[4 * nt + i] - ((i & 1) ? d.y : d.x);
    }
    uint32_t ds[4][4];
    pack_a(s, ds);
    wgmma_fence();
    product_rs<D>(acc_k, ds, qt);  // dK += dS^T Q
    wgmma_commit();
    wgmma_wait<0>();
    __syncthreads();  // the next iteration's copies overwrite a stage
  }
  const long long row_stride = static_cast<long long>(g) * D;
  const long long base = static_cast<long long>(bi) * skv * row_stride + gi * D;
  store_rows<D>(acc_k, scale, sK, dk + base, row_stride, n0, skv);
  store_rows<D>(acc_v, 1.f, sV, dv + base, row_stride, n0, skv);
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

// A tensor map of one (b, rows, heads, D) operand read through its element
// strides: boxes of 64 columns (one 128-byte-swizzled panel) by 64 rows of
// one head; what lies outside the tensor reads as zeros.
int make_map(CUtensorMap* map, const void* base, int d, int rows, int heads,
             int batch, long long s_row, long long s_head, long long s_batch) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s_row) * 2,
                                 static_cast<cuuint64_t>(s_head) * 2,
                                 static_cast<cuuint64_t>(s_batch) * 2};
  const cuuint32_t box[4] = {64, TILE, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return static_cast<int>(encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

// Raises both kernels' dynamic shared memory limit once (above 48 KB it
// must be asked for).
template <int D>
cudaError_t configure() {
  static bool done = false;
  if (done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_bwd_dq_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, BwdCfg<D>::DQ_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_attention_bwd_dkdv_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               BwdCfg<D>::DKDV_SMEM);
  if (err == cudaSuccess) done = true;
  return err;
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  void *dq, *dk, *dv;
  float* stats;
  int b, sq, skv, h, g;
  long long q_s[3], k_s[3], v_s[3], o_s[3], d_s[3];  // batch, row, head
  int causal;
  float scale;
};

template <int D>
int launch(const Args& a, cudaStream_t stream) {
  cudaError_t err = configure<D>();
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap q_map{}, k_map{}, v_map{}, do_map{};
  int rc = make_map(&q_map, a.q, D, a.sq, a.h, a.b, a.q_s[1], a.q_s[2],
                    a.q_s[0]);
  if (!rc)
    rc = make_map(&do_map, a.dout, D, a.sq, a.h, a.b, a.d_s[1], a.d_s[2],
                  a.d_s[0]);
  if (!rc)
    rc = make_map(&k_map, a.k, D, a.skv, a.g, a.b, a.k_s[1], a.k_s[2],
                  a.k_s[0]);
  if (!rc)
    rc = make_map(&v_map, a.v, D, a.skv, a.g, a.b, a.v_s[1], a.v_s[2],
                  a.v_s[0]);
  if (rc) return rc;
  const int nq = (a.sq + TILE - 1) / TILE, nk = (a.skv + TILE - 1) / TILE;
  const int sq_pad = nq * TILE;
  const float sl2 = a.scale * LOG2E;
  flash_attention_bwd_dq_kernel<D>
      <<<dim3(a.b * a.h, nq), THREADS, BwdCfg<D>::DQ_SMEM, stream>>>(
          static_cast<const __nv_bfloat16*>(a.o),
          static_cast<const __nv_bfloat16*>(a.dout), a.lse,
          static_cast<__nv_bfloat16*>(a.dq), a.stats, a.sq, a.skv, a.h, a.g,
          sq_pad, a.o_s[0], a.o_s[1], a.o_s[2], a.d_s[0], a.d_s[1], a.d_s[2],
          a.causal, a.scale, sl2, q_map, k_map, v_map, do_map);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_attention_bwd_dkdv_kernel<D>
      <<<dim3(a.b * a.g, nk), THREADS, BwdCfg<D>::DKDV_SMEM, stream>>>(
          a.stats, static_cast<__nv_bfloat16*>(a.dk),
          static_cast<__nv_bfloat16*>(a.dv), a.sq, a.skv, a.h, a.g, sq_pad,
          a.causal, a.scale, sl2, q_map, k_map, v_map, do_map);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int occupancy(int* dq_blocks, int* dkdv_blocks, int* dq_smem,
              int* dkdv_smem, int* stages) {
  const cudaError_t err = configure<D>();
  if (err != cudaSuccess) return static_cast<int>(err);
  *dq_smem = BwdCfg<D>::DQ_SMEM;
  *dkdv_smem = BwdCfg<D>::DKDV_SMEM;
  *stages = BwdCfg<D>::STAGES;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      dq_blocks, flash_attention_bwd_dq_kernel<D>, THREADS,
      BwdCfg<D>::DQ_SMEM);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        dkdv_blocks, flash_attention_bwd_dkdv_kernel<D>, THREADS,
        BwdCfg<D>::DKDV_SMEM);
  return static_cast<int>(e);
}

}  // namespace

// q, dout, o (b, sq, h, d), k, v (b, skv, g, d), bf16, read through their
// element strides (the head dim contiguous, the others multiples of 8: the
// wrapper checks both); lse fp32 (b, h, sq) contiguous, as the forward
// writes it; dq (b, sq, h, d) and dk, dv (b, skv, g, d) contiguous, bf16;
// stats fp32 scratch of b * h * 2 * (sq rounded up to 64). d is 64, 96 or
// 128. Launches the dq kernel, then the dkdv kernel, on `stream`. Returns
// the launches' cudaGetLastError().
extern "C" int repro_flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* stats, int b, int sq, int skv, int h, int g, int d,
    const long long* q_s, const long long* k_s, const long long* v_s,
    const long long* o_s, const long long* d_s, int causal, float scale,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a{q, k, v, o, dout, static_cast<const float*>(lse), dq, dk, dv,
         static_cast<float*>(stats), b, sq, skv, h, g, {}, {}, {}, {}, {},
         causal, scale};
  for (int i = 0; i < 3; ++i) {
    a.q_s[i] = q_s[i];
    a.k_s[i] = k_s[i];
    a.v_s[i] = v_s[i];
    a.o_s[i] = o_s[i];
    a.d_s[i] = d_s[i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return launch<64>(a, s);
    case 96: return launch<96>(a, s);
    case 128: return launch<128>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Resident blocks per SM and dynamic shared memory of both kernels at head
// dim d, and the stages of their rings (BwdCfg). Returns a CUDA error code.
extern "C" int repro_flash_attention_bwd_occupancy(int d, int device,
                                                   int* dq_blocks,
                                                   int* dkdv_blocks,
                                                   int* dq_smem,
                                                   int* dkdv_smem,
                                                   int* stages) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (d) {
    case 64:
      return occupancy<64>(dq_blocks, dkdv_blocks, dq_smem, dkdv_smem, stages);
    case 96:
      return occupancy<96>(dq_blocks, dkdv_blocks, dq_smem, dkdv_smem, stages);
    case 128:
      return occupancy<128>(dq_blocks, dkdv_blocks, dq_smem, dkdv_smem,
                            stages);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
