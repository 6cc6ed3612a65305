// Mamba-2 SSD chunked scan for Hopper (sm_90a): bf16 x/B/C in, fp32
// dt/A/state, bf16 products on the tensor cores with fp32 accumulation,
// bf16 y out.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py
// (ssd_scan_kernel / _kernel) and computes what the pure-JAX
// src/repro/models/ssm.py::ssd_scan computes. For each (b, head) and each
// chunk of Q steps, with cum the inclusive cumsum of dt*A inside the chunk:
//   W_ij  = exp(cum_i - cum_j) dt_j (C_i . B_j)  for j <= i, else 0
//   y_i   = sum_j W_ij x_j + (C_i exp(cum_i)) . S_in
//   S_out = exp(cum_last) S_in + sum_j (B_j sw_j)^T x_j,
//           sw_j = exp(cum_last - cum_j) dt_j
// Only differences that are <= 0 are exponentiated (cum_i - cum_j for
// j <= i, cum_last - cum_j, cum_i), so nothing overflows however large dt
// grows; exp(cum_i) * exp(-cum_j) is never formed.
//
// What bounds it on an H100: at the serving shape (b 8, s 512, 64 heads,
// P = N = 64, Q = 128) it moves ~78 MB (x, y, B/C, dt, final state) and
// needs ~8.6 GFLOP, so the bound is bytes (0.023 ms at 3.35 TB/s). The
// design keeps the products off the fp32 CUDA cores and the next chunk's
// loads in flight:
//   * one block of 8 warps per (b, head) loops over the chunks in order
//     (the Pallas grid's sequential chunk axis relies on TPU grid order;
//     GPU blocks run in no order); its N x P fp32 state stays in the
//     registers of mma accumulators for the whole sequence, and a bf16
//     copy of it (below) in shared memory for the other warps to read;
//   * all products run on mma.sync.m16n8k16 (bf16 operands, fp32
//     accumulation), with operands rounded to bf16 exactly where the
//     reference rounds them (ssm.py:111 the weights W, :116 sw, :134
//     C exp(cum)), so the kernel repeats the plain version's roundings:
//       - G = C B^T per 16 x 16 tile, turned in registers into the A
//         fragment of W (the C layout of m16n8 is the A layout of m16k16),
//         then y += W x (x through ldmatrix.trans);
//       - y += bf16(C exp(cum)) . S_in with S_in split into two bf16
//         halves, S_hi = bf16(S) and S_lo = bf16(S - S_hi), two mma: the
//         product is within ~2^-17 of fp32 S_in (the reference keeps S_in
//         in fp32);
//       - S_out: A = (B sw)^T through ldmatrix.trans and scaled in
//         registers, B = x;
//   * x, B and C of chunk c+1 come in by cp.async into the second of two
//     stages while chunk c is computed; warp 0 also holds chunk c+1's dt
//     in registers; rows past s are zero-filled by the copy (src-size 0)
//     and never read, so they act as dt = 0 (no decay, no state write);
//   * balanced warps: warp w takes 16-row causal row tile r (w for
//     w < 4, 11 - w above) over all P columns, so the two warps that
//     share an SM sub-partition (w and w + 4) hold tiles r and 7 - r and
//     every sub-partition does the same work; warps 0..3, whose tiles are
//     the short ones, also hold and update the state, 16 of its N rows
//     each over all P columns (at the 128-register cap this spills a few
//     bytes, and is still the faster split);
//   * tiles in shared memory are bf16 with rows XOR-swizzled in 16-byte
//     pieces (no padding), so ldmatrix and the 32-bit stores are free of
//     bank conflicts: two stages of x, B, C (2 x 48 KB), S_hi/S_lo (16 KB)
//     and cum/dt (1 KB), 115,712 bytes at P = N = 64, Q = 128: two blocks
//     per SM with 256 threads of at most 128 registers
//     (repro_ssd_scan_occupancy reports it);
//   * at N = 128 (P = 64) the state is 32 KB: its 8 row tiles take all 8
//     warps, each beside its row tile of y, and the two stages (2 x 80 KB)
//     with S_hi/S_lo (32 KB) come to 197,632 bytes, one block per SM, so
//     the kernel is built for one block of at most 255 registers a thread
//     (no spill).
// x, B and C are read in the model layout through strides (column slices
// of the conv output); head h reads group h / (nh / g), so B/C are never
// repeated to every head and nothing is transposed in HBM. init_state
// (optional) seeds the state and the final state is written out.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int QMAX = 128;
constexpr float LOG2E = 1.4426950408889634f;

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

__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
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

// two floats -> one register of two bf16, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// both bf16 halves of `r` times (f_lo, f_hi), rounded back to bf16
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t r, float f_lo,
                                                 float f_hi) {
  const float2 v =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r));
  return pack_bf16(v.x * f_lo, v.y * f_hi);
}

// 2^x for x <= 0 (results below 2^-126 flush to 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Element offset of (row, col) in a tile of W-element rows whose 16-byte
// pieces are XOR-swizzled so that 8 consecutive rows' pieces at one column
// fall in distinct banks (W = 16, 64 or 128; a row of 128 spans two
// 128-byte lines, and only the piece's place within its line is swizzled).
template <int W>
__device__ __forceinline__ int swz(int row, int col) {
  constexpr int WC = W / 8;                   // 16-byte pieces per row
  constexpr int RPL = WC >= 8 ? 1 : 8 / WC;   // rows per 128-byte line
  constexpr int M = WC >= 8 ? 8 : WC;         // pieces swizzled together
  return row * W + (((col >> 3) ^ ((row / RPL) % M)) << 3) + (col & 7);
}

template <int P, int N>
struct Cfg {
  static constexpr int NP = N < 16 ? 16 : N;   // N padded to the mma depth
  static constexpr int STAGE = QMAX * (P + 2 * NP);  // x, B, C (elements)
  static constexpr int SMEM =
      (2 * STAGE + 2 * NP * P) * 2 + 2 * QMAX * 4;
  // blocks per SM the registers are budgeted for: two while two blocks'
  // shared memory fits an SM (228 KB), else one
  static constexpr int MIN_BLOCKS = 2 * (SMEM + 1024) <= 233472 ? 2 : 1;
};

// Rows [t0, t0 + L) of x, B and C -> one stage; rows L..QP-1 and B/C's
// columns past N are zero-filled.
template <int P, int N>
__device__ __forceinline__ void load_chunk(
    __nv_bfloat16* xs, __nv_bfloat16* bs, __nv_bfloat16* cs,
    const __nv_bfloat16* xb, const __nv_bfloat16* bb,
    const __nv_bfloat16* cb, long long x_ss, long long b_ss, long long c_ss,
    int t0, int L, int QP) {
  constexpr int NP = Cfg<P, N>::NP, XC = P / 8, BC = NP / 8;
  for (int idx = threadIdx.x; idx < QP * XC; idx += THREADS) {
    const int r = idx / XC, c = idx % XC;
    const bool ok = r < L;
    cp_async16(smem_u32(xs + swz<P>(r, c * 8)),
               ok ? xb + (t0 + r) * x_ss + c * 8 : xb, ok);
  }
  for (int idx = threadIdx.x; idx < QP * BC; idx += THREADS) {
    const int r = idx / BC, c = idx % BC;
    const bool ok = r < L && c * 8 < N;
    cp_async16(smem_u32(bs + swz<NP>(r, c * 8)),
               ok ? bb + (t0 + r) * b_ss + c * 8 : bb, ok);
    cp_async16(smem_u32(cs + swz<NP>(r, c * 8)),
               ok ? cb + (t0 + r) * c_ss + c * 8 : cb, ok);
  }
}

template <int P, int N>
__global__ void __launch_bounds__(THREADS, Cfg<P, N>::MIN_BLOCKS)
ssd_scan_kernel(const __nv_bfloat16* __restrict__ x,
                const float* __restrict__ dt, const float* __restrict__ A,
                const __nv_bfloat16* __restrict__ B,
                const __nv_bfloat16* __restrict__ C,
                const float* __restrict__ init_state,
                __nv_bfloat16* __restrict__ y, float* __restrict__ state_out,
                int s, int nh, int g, int Q, long long x_sb, long long x_ss,
                long long x_sh, long long dt_sb, long long dt_ss,
                long long dt_sh, long long b_sb, long long b_ss,
                long long b_sg, long long c_sb, long long c_ss,
                long long c_sg) {
  using Cf = Cfg<P, N>;
  constexpr int NP = Cf::NP;
  constexpr int PY = P / 8;        // n8 tiles of a row of y or of the state
  constexpr int KN = NP / 16;      // k-steps over the state size
  constexpr int MT = NP / 16;      // 16-row tiles of the state
  static_assert(P == 16 || P == 64, "P is 16 or 64");
  static_assert(NP == 16 || NP == 64 || NP == 128,
                "N is at most 16, 64 or 128");
  static_assert(MT <= THREADS / 32, "a warp for each row tile of the state");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* stage0 = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* s_hi = stage0 + 2 * Cf::STAGE;   // [NP][P]
  __nv_bfloat16* s_lo = s_hi + NP * P;            // [NP][P]
  // [QMAX]: (cum in log2 units, dt) of each step of the chunk
  float2* cd = reinterpret_cast<float2*>(s_lo + NP * P);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane >> 2, tig = lane & 3;
  const int bi = blockIdx.x / nh, h = blockIdx.x % nh;
  const int gi = h / (nh / g);
  const float a2 = A[h] * LOG2E;
  const __nv_bfloat16* xb = x + bi * x_sb + h * x_sh;
  const __nv_bfloat16* bb = B + bi * b_sb + gi * b_sg;
  const __nv_bfloat16* cb = C + bi * c_sb + gi * c_sg;
  const float* dtb = dt + bi * dt_sb + h * dt_sh;
  // y (b, s, nh, P) and the states (b, nh, P, N) are contiguous
  const long long y_ss = static_cast<long long>(nh) * P;
  __nv_bfloat16* yb = y + static_cast<long long>(bi) * s * y_ss + h * P;
  const long long st0 = static_cast<long long>(blockIdx.x) * P * N;

  const int QP = (Q + 15) & ~15;   // rows handled per chunk
  const int RT = QP / 16;          // 16-row tiles per chunk
  const int nchunks = (s + Q - 1) / Q;

  // Warps 0 .. MT-1 hold the state, 16 of its rows each over all P
  // columns, in the registers of an mma accumulator (a C fragment): warps
  // 0..3 at N <= 64, all 8 at N = 128.
  const bool has_state = warp < MT;
  const int sn0 = warp * 16;
  float st[PY][4];
#pragma unroll
  for (int nt = 0; nt < PY; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = sn0 + grp + (e >> 1) * 8, p = nt * 8 + tig * 2 + (e & 1);
      st[nt][e] = has_state && init_state && n < N
                      ? init_state[st0 + static_cast<long long>(p) * N + n]
                      : 0.f;
    }
  // the state as S_hi + S_lo in shared memory: S_in of the next chunk
  auto write_state = [&]() {
#pragma unroll
    for (int nt = 0; nt < PY; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int n = sn0 + grp + half * 8, p = nt * 8 + tig * 2;
        const float v0 = st[nt][2 * half], v1 = st[nt][2 * half + 1];
        const float h0 = round_bf16(v0), h1 = round_bf16(v1);
        *reinterpret_cast<uint32_t*>(s_hi + swz<P>(n, p)) = pack_bf16(h0, h1);
        *reinterpret_cast<uint32_t*>(s_lo + swz<P>(n, p)) =
            pack_bf16(v0 - h0, v1 - h1);
      }
  };
  if (has_state) write_state();

  load_chunk<P, N>(stage0, stage0 + QMAX * P, stage0 + QMAX * (P + NP), xb,
                   bb, cb, x_ss, b_ss, c_ss, 0, min(Q, s), QP);
  cp_async_commit();
  // warp 0 holds the dt of the chunk to come, four steps a lane
  float dtr[4] = {0.f, 0.f, 0.f, 0.f};
  if (warp == 0) {
    const int L0 = min(Q, s);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = lane * 4 + e;
      dtr[e] = j < L0 ? dtb[j * dt_ss] : 0.f;
    }
  }

  // this warp's row tile of y: the two warps of each SM sub-partition (w
  // and w + 4) hold tiles r and 7 - r, and warps 0..3, with the short
  // tiles, also update the state, so the sub-partitions and the warps
  // carry near-equal work
  const int rt = warp < 4 ? warp : 11 - warp, i0 = rt * 16;
  for (int c = 0; c < nchunks; ++c) {
    const int t0 = c * Q, L = min(Q, s - t0);
    __nv_bfloat16* xs = stage0 + (c & 1) * Cf::STAGE;
    __nv_bfloat16* bs = xs + QMAX * P;
    __nv_bfloat16* cs = bs + QMAX * NP;
    if (c + 1 < nchunks) {
      __nv_bfloat16* nx = stage0 + ((c + 1) & 1) * Cf::STAGE;
      const int t1 = t0 + Q;
      load_chunk<P, N>(nx, nx + QMAX * P, nx + QMAX * (P + NP), xb, bb, cb,
                       x_ss, b_ss, c_ss, t1, min(Q, s - t1), QP);
    }
    cp_async_commit();  // possibly empty: keeps the group count regular

    // inclusive cumsum of dt*A*log2(e) over the chunk (warp 0)
    if (warp == 0) {
      float v[4];
      v[0] = dtr[0] * a2;
#pragma unroll
      for (int e = 1; e < 4; ++e) v[e] = v[e - 1] + dtr[e] * a2;
      float run = v[3];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, run, off);
        if (lane >= off) run += u;
      }
      const float before = run - v[3];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        cd[lane * 4 + e] = make_float2(v[e] + before, dtr[e]);
      if (c + 1 < nchunks) {
        const int t1 = t0 + Q, L1 = min(Q, s - t1);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = lane * 4 + e;
          dtr[e] = j < L1 ? dtb[(t1 + j) * dt_ss] : 0.f;
        }
      }
    }
    cp_async_wait_1();  // every group but the newest has landed: chunk c
    __syncthreads();
    const float cl = cd[QMAX - 1].x;  // rows past L add nothing to cum

    // ---- y for this warp's row tile over all P columns
    if (rt < RT && i0 < L) {
      uint32_t cf[KN][4];
#pragma unroll
      for (int ks = 0; ks < KN; ++ks)
        ldsm_x4(cf[ks], smem_u32(cs + swz<NP>(i0 + (lane & 15),
                                              ks * 16 + (lane >> 4) * 8)));
      float acc[PY][4];
#pragma unroll
      for (int nt = 0; nt < PY; ++nt)
        acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
      const int ia = i0 + grp, ib = ia + 8;
      const float cia = cd[ia].x, cib = cd[ib].x;
#pragma unroll 1
      for (int jt = 0; jt <= rt; ++jt) {
        const int j0 = jt * 16;
        if (j0 >= L) break;
        // G = C_i . B_j, 16 x 16
        float gacc[2][4];
#pragma unroll
        for (int u = 0; u < 2; ++u)
          gacc[u][0] = gacc[u][1] = gacc[u][2] = gacc[u][3] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KN; ++ks) {
          uint32_t b[4];
          ldsm_x4(b, smem_u32(bs + swz<NP>(j0 + (lane & 7) +
                                               ((lane >> 4) << 3),
                                           ks * 16 + ((lane >> 3) & 1) * 8)));
          mma_bf16(gacc[0], cf[ks], b[0], b[1]);
          mma_bf16(gacc[1], cf[ks], b[2], b[3]);
        }
        // W in bf16, as the A fragment of W x; computed for every
        // element and then selected, so no branch splits the warp
        const int jb = j0 + tig * 2;
        const float2 cj[4] = {cd[jb], cd[jb + 1], cd[jb + 8], cd[jb + 9]};
        float w[2][4];
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = jb + u * 8 + (e & 1);
            const float2 c = cj[u * 2 + (e & 1)];
            const float v = fast_exp2((e < 2 ? cia : cib) - c.x) *
                            gacc[u][e] * c.y;
            w[u][e] = j <= (e < 2 ? ia : ib) ? v : 0.f;
          }
        uint32_t wa[4];
        wa[0] = pack_bf16(w[0][0], w[0][1]);
        wa[1] = pack_bf16(w[0][2], w[0][3]);
        wa[2] = pack_bf16(w[1][0], w[1][1]);
        wa[3] = pack_bf16(w[1][2], w[1][3]);
        const int xr = j0 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int pp = 0; pp < PY / 2; ++pp) {
          uint32_t b[4];
          ldsm_x4_t(b, smem_u32(xs + swz<P>(xr, pp * 16 + (lane >> 4) * 8)));
          mma_bf16(acc[2 * pp], wa, b[0], b[1]);
          mma_bf16(acc[2 * pp + 1], wa, b[2], b[3]);
        }
      }
      // y += bf16(C_i exp(cum_i)) . (S_hi + S_lo)
      const float ea = fast_exp2(cia), eb = fast_exp2(cib);
#pragma unroll
      for (int ks = 0; ks < KN; ++ks) {
        uint32_t ce[4];
        ce[0] = scale_bf16x2(cf[ks][0], ea, ea);
        ce[1] = scale_bf16x2(cf[ks][1], eb, eb);
        ce[2] = scale_bf16x2(cf[ks][2], ea, ea);
        ce[3] = scale_bf16x2(cf[ks][3], eb, eb);
        const int sr = ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int pp = 0; pp < PY / 2; ++pp) {
          const int off = swz<P>(sr, pp * 16 + (lane >> 4) * 8);
          uint32_t b[4];
          ldsm_x4_t(b, smem_u32(s_hi + off));
          mma_bf16(acc[2 * pp], ce, b[0], b[1]);
          mma_bf16(acc[2 * pp + 1], ce, b[2], b[3]);
          ldsm_x4_t(b, smem_u32(s_lo + off));
          mma_bf16(acc[2 * pp], ce, b[0], b[1]);
          mma_bf16(acc[2 * pp + 1], ce, b[2], b[3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < PY; ++nt) {
        const int p = nt * 8 + tig * 2;
        if (ia < L)
          *reinterpret_cast<uint32_t*>(yb + (t0 + ia) * y_ss + p) =
              pack_bf16(acc[nt][0], acc[nt][1]);
        if (ib < L)
          *reinterpret_cast<uint32_t*>(yb + (t0 + ib) * y_ss + p) =
              pack_bf16(acc[nt][2], acc[nt][3]);
      }
    }

    // ---- S_out = exp(cum_last) S_in + sum_j (B_j sw_j)^T x_j, in registers
    if (has_state) {
      const float decay = fast_exp2(cl);
#pragma unroll
      for (int nt = 0; nt < PY; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[nt][e] *= decay;
#pragma unroll 1
      for (int j0 = 0; j0 < L; j0 += 16) {
        uint32_t ba[4];
        ldsm_x4_t(ba, smem_u32(bs + swz<NP>(j0 + (lane & 7) +
                                                ((lane >> 4) << 3),
                                            sn0 + ((lane >> 3) & 1) * 8)));
        const int ja = j0 + tig * 2;
        const float2 c0 = cd[ja], c1 = cd[ja + 1], c8 = cd[ja + 8],
                     c9 = cd[ja + 9];
        const float sw0 = round_bf16(fast_exp2(cl - c0.x) * c0.y);
        const float sw1 = round_bf16(fast_exp2(cl - c1.x) * c1.y);
        const float sw8 = round_bf16(fast_exp2(cl - c8.x) * c8.y);
        const float sw9 = round_bf16(fast_exp2(cl - c9.x) * c9.y);
        ba[0] = scale_bf16x2(ba[0], sw0, sw1);
        ba[1] = scale_bf16x2(ba[1], sw0, sw1);
        ba[2] = scale_bf16x2(ba[2], sw8, sw9);
        ba[3] = scale_bf16x2(ba[3], sw8, sw9);
        const int xr = j0 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int pp = 0; pp < PY / 2; ++pp) {
          uint32_t b[4];
          ldsm_x4_t(b, smem_u32(xs + swz<P>(xr, pp * 16 + (lane >> 4) * 8)));
          mma_bf16(st[2 * pp], ba, b[0], b[1]);
          mma_bf16(st[2 * pp + 1], ba, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // every warp has read S_in, cum and this stage
    if (has_state && c + 1 < nchunks) write_state();
  }

  if (has_state) {
#pragma unroll
    for (int nt = 0; nt < PY; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = sn0 + grp + (e >> 1) * 8;
        const int p = nt * 8 + tig * 2 + (e & 1);
        if (n < N)
          state_out[st0 + static_cast<long long>(p) * N + n] = st[nt][e];
      }
  }
}

template <int P, int N>
cudaError_t configure() {
  static bool done = false;
  if (done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Cfg<P, N>::SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_scan_kernel<P, N>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) done = true;
  return err;
}

template <int P, int N>
int launch(const void* x, const float* dt, const float* A, const void* B,
           const void* C, const float* init_state, void* y, float* state_out,
           int b, int s, int nh, int g, int Q, long long x_sb, long long x_ss,
           long long x_sh, long long dt_sb, long long dt_ss, long long dt_sh,
           long long b_sb, long long b_ss, long long b_sg, long long c_sb,
           long long c_ss, long long c_sg, cudaStream_t stream) {
  const cudaError_t err = configure<P, N>();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_kernel<P, N><<<b * nh, THREADS, Cfg<P, N>::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(x), dt, A,
      static_cast<const __nv_bfloat16*>(B),
      static_cast<const __nv_bfloat16*>(C), init_state,
      static_cast<__nv_bfloat16*>(y), state_out, s, nh, g, Q, x_sb, x_ss,
      x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, b_sg, c_sb, c_ss, c_sg);
  return 0;
}

template <int P, int N>
int occupancy(int* blocks, int* smem_bytes) {
  const cudaError_t err = configure<P, N>();
  if (err != cudaSuccess) return static_cast<int>(err);
  *smem_bytes = Cfg<P, N>::SMEM;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, ssd_scan_kernel<P, N>, THREADS, Cfg<P, N>::SMEM));
}

}  // namespace

// x (b, s, nh, P) and B/C (b, s, g, N) bf16 through their strides (in
// elements; the last dim contiguous, every other stride a multiple of 8
// and the start 16-byte aligned, which the wrapper checks); dt (b, s, nh)
// fp32 through its strides; A (nh,) fp32; init_state (b, nh, P, N) fp32
// contiguous or null; y (b, s, nh, P) bf16 and state_out (b, nh, P, N)
// fp32 contiguous. Q is the chunk: a multiple of 8, at most 128. Returns
// the launch's cudaGetLastError().
extern "C" int repro_ssd_scan_bf16(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, const void* init_state, void* y, void* state_out, int b,
    int s, int nh, int g, int Q, int P, int N, long long x_sb,
    long long x_ss, long long x_sh, long long dt_sb, long long dt_ss,
    long long dt_sh, long long b_sb, long long b_ss, long long b_sg,
    long long c_sb, long long c_ss, long long c_sg, int device,
    void* stream) {
  if (Q % 8 || Q < 8 || Q > QMAX || s < 1 || g < 1 || nh % g)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dtp = static_cast<const float*>(dt);
  const float* Ap = static_cast<const float*>(A);
  const float* init = static_cast<const float*>(init_state);
  float* out = static_cast<float*>(state_out);
  int rc;
  if (P == 64 && N == 64)
    rc = launch<64, 64>(x, dtp, Ap, B, C, init, y, out, b, s, nh, g, Q, x_sb,
                        x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, b_sg,
                        c_sb, c_ss, c_sg, st);
  else if (P == 64 && N == 128)
    rc = launch<64, 128>(x, dtp, Ap, B, C, init, y, out, b, s, nh, g, Q,
                         x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss,
                         b_sg, c_sb, c_ss, c_sg, st);
  else if (P == 16 && N == 8)
    rc = launch<16, 8>(x, dtp, Ap, B, C, init, y, out, b, s, nh, g, Q, x_sb,
                       x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, b_sg,
                       c_sb, c_ss, c_sg, st);
  else
    rc = static_cast<int>(cudaErrorInvalidValue);
  if (rc) return rc;
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM of the (P, N) instantiation and its dynamic
// shared memory in bytes. Returns a CUDA error code.
extern "C" int repro_ssd_scan_occupancy(int P, int N, int device, int* blocks,
                                        int* smem_bytes) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (P == 64 && N == 64) return occupancy<64, 64>(blocks, smem_bytes);
  if (P == 64 && N == 128) return occupancy<64, 128>(blocks, smem_bytes);
  if (P == 16 && N == 8) return occupancy<16, 8>(blocks, smem_bytes);
  return static_cast<int>(cudaErrorInvalidValue);
}
