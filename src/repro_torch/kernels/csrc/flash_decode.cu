// Flash-decode for Hopper (sm_90a): one new query row per head against a
// padded KV cache, bf16 in, fp32 softmax and accumulation.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_decode.py
// (flash_decode / _kernel): per (b, h) one query row, kv blocks past
// kv_len[b] skipped, columns masked, online softmax, acc / max(l, 1e-37).
//
// What bounds it on an H100: bytes. Each cache row is used for one dot
// product and one axpy per query head (2-16 FLOP per byte), far below the
// ~295 FLOP/byte ridge, so the time is the K/V bytes up to kv_len over the
// 3.35 TB/s of HBM. Reaching that rate takes enough rows in flight on
// every SM; a grid of one block per (b, kv head) has 64 blocks at GQA 4:1
// (b = 8), 32 for yi-6b and KVH at batch 1, on 132 SMs.
//
// Design, against that bound:
//   * split-KV: the grid is (b * kvh, n_split). The host picks n_split
//     from what it knows without reading kv_len (S, b * kvh and the SM
//     count: about two blocks per SM, but at least 256 rows of S per
//     split, see flash_decode.py split_count);
//     each block reads kv_len[b] on the device, cuts the first kv_len[b]
//     rows into 16-row tiles and takes its even share of them. A block
//     whose share is empty writes an empty partial (m = -1e30, the finite
//     stand-in for -inf used throughout, l = 0, acc = 0), which weighs
//     e^(-1e30 - M) = 0 in the merge. Rows past kv_len are never read;
//   * one block serves all GROUP = H/KVH query heads of its kv head, so
//     each K/V row is read from memory once;
//   * each of the 4 warps walks its own tiles (t, t + 4, ...) through its
//     own 3-stage ring in shared memory, filled by cp.async (16 bytes a
//     lane, rows past kv_len zero-filled without a read): two tiles are in
//     flight while one is used, and no block barrier sits in the loop;
//   * S = Q K^T and O += P V on mma.sync.m16n8k16 for every GROUP: the
//     GROUP query rows (zero-padded to 16) are the A operand, K and V come
//     from shared memory by ldmatrix / ldmatrix.trans, exactly as in
//     flash_attention.cu. The tensor cores idle at these ratios whatever
//     the padding, and the CUDA cores are left the softmax alone; the
//     head dim is consumed in k-steps of 16, so D = 96 needs no lane
//     layout of its own (a design that shares each row among D / 8 lanes
//     and reduces over them by halving needs a power of two there);
//   * rows of SD = D + 8 elements keep the 8 row addresses of every
//     ldmatrix in distinct banks at each D;
//   * the block merges its warps through shared memory with the
//     log-sum-exp rule. With n_split = 1 it writes the output; otherwise
//     it writes its partial (m, l, unnormalised acc per head, fp32) to a
//     workspace, and the last block of each (b, kv head) to finish (an
//     atomicAdd ticket on a per-(b, kv head) counter, behind a
//     __threadfence) merges the n_split partials and writes
//     O / max(L, 1e-37). It then resets its counter to 0, so a later call,
//     or a replay of a captured CUDA graph, finds the counters at zero.
//     One launch per call; the wrapper keeps one counter array per
//     (device, stream, b * g), since calls on two streams would race on
//     it, and never frees one, since a captured graph keeps its address.
// Softmax in base 2 with the scale folded into one FMA, as in
// flash_attention.cu; P is rounded to bf16 before P V, as the reference
// casts it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 16;        // cache rows per warp tile
constexpr int STAGES = 3;       // tiles in each warp's ring
constexpr int MAX_SPLIT = 64;   // flash_decode.py MAX_SPLIT
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Cfg {
  static constexpr int SD = D + 8;                       // padded row
  static constexpr int RING = STAGES * 2 * TILE * SD;    // elements a warp
  static constexpr int SMEM = WARPS * RING * 2;          // bytes a block
};

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const int* kv_len;
  __nv_bfloat16* o;
  float* part;     // n_split > 1: [b*g][n_split][GROUP][D] acc, then m, l
  int* counters;   // n_split > 1: [b*g] tickets, zero between calls
  int S, g, n_split;
  long long q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  float scale_log2;
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

// two floats -> one register of two bf16, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D, int GROUP>
__global__ void __launch_bounds__(THREADS)
flash_decode_kernel(const Args a) {
  constexpr int SD = Cfg<D>::SD, KSTEPS = D / 16, DTILES = D / 8;
  constexpr int CHUNKS = D / 8;  // 16-byte pieces of a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float sm_w[MAX_SPLIT][GROUP];  // the split merge's weights
  __shared__ float sm_L[GROUP];
  __shared__ int sm_last;

  const int bg = blockIdx.x;  // b * g + kv head
  const int bi = bg / a.g, gi = bg % a.g;
  const int split = blockIdx.y, n_split = a.n_split;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane >> 2, tig = lane & 3;
  const int n = min(a.kv_len[bi], a.S);

  // this block's tiles [t0, t1): the n rows in 16-row tiles, dealt evenly
  // to the splits; this warp's tiles are t0 + warp + WARPS * i, i < nk
  const int tiles = (n + TILE - 1) / TILE;
  const int per = (tiles + n_split - 1) / n_split;
  const int t0 = min(split * per, tiles), t1 = min(t0 + per, tiles);
  const int nk = t1 - t0 > warp ? (t1 - t0 - warp + WARPS - 1) / WARPS : 0;

  __nv_bfloat16* ring =
      reinterpret_cast<__nv_bfloat16*>(smem_raw) + warp * Cfg<D>::RING;
  const __nv_bfloat16* kb = a.k + bi * a.k_sb + gi * a.k_sh;
  const __nv_bfloat16* vb = a.v + bi * a.v_sb + gi * a.v_sh;

  // the warp's i-th tile -> stage i % STAGES (K, then V)
  auto fetch = [&](int i) {
    __nv_bfloat16* sk = ring + (i % STAGES) * 2 * TILE * SD;
    __nv_bfloat16* sv = sk + TILE * SD;
    const int row0 = (t0 + warp + i * WARPS) * TILE;
#pragma unroll
    for (int it = 0; it < TILE * CHUNKS / 32; ++it) {
      const int idx = lane + 32 * it;
      const int r = idx / CHUNKS, c = (idx % CHUNKS) * 8;
      const bool ok = row0 + r < n;
      const long long row = ok ? row0 + r : 0;
      cp_async16(smem_u32(sk + r * SD + c), kb + row * a.k_ss + c, ok);
      cp_async16(smem_u32(sv + r * SD + c), vb + row * a.v_ss + c, ok);
    }
  };

  // Q as the A operand: row grp is query head gi * GROUP + grp (zero for
  // grp >= GROUP), rows 8-15 are zero
  uint32_t qf[KSTEPS][2];
  {
    const bool real = grp < GROUP;
    const int head = gi * GROUP + (real ? grp : 0);
    const __nv_bfloat16* qp = a.q + bi * a.q_sb + head * a.q_sh + tig * 2;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      qf[ks][0] = real ? *reinterpret_cast<const uint32_t*>(qp + ks * 16) : 0u;
      qf[ks][1] =
          real ? *reinterpret_cast<const uint32_t*>(qp + ks * 16 + 8) : 0u;
    }
  }

  // row grp's running max (raw score units), sum and P V; acc[dt][2..3]
  // belong to the zero rows 8-15 and stay 0
  float acc[DTILES][4];
#pragma unroll
  for (int dt = 0; dt < DTILES; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float m_run = NEG_INF, l_run = 0.f;
  const float sl2 = a.scale_log2;

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < nk) fetch(i);
    cp_async_commit();
  }
  for (int i = 0; i < nk; ++i) {
    if (i + STAGES - 1 < nk) fetch(i + STAGES - 1);
    cp_async_commit();  // possibly empty: keeps the group count regular
    cp_async_wait<STAGES - 1>();
    __syncwarp();       // every lane's copies of tile i have landed
    const __nv_bfloat16* sk = ring + (i % STAGES) * 2 * TILE * SD;
    const __nv_bfloat16* sv = sk + TILE * SD;

    // S = Q K^T: GROUP rows x 16 cache rows (two n-tiles)
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      uint32_t b[4];
      ldsm_x4(b, smem_u32(sk + ((lane & 7) + ((lane >> 4) << 3)) * SD +
                          ks * 16 + ((lane >> 3) & 1) * 8));
      const uint32_t qa[4] = {qf[ks][0], 0u, qf[ks][1], 0u};
      mma_bf16(s[0], qa, b[0], b[1]);
      mma_bf16(s[1], qa, b[2], b[3]);
    }
    const int row0 = (t0 + warp + i * WARPS) * TILE;
    if (row0 + TILE > n) {  // the tile that crosses kv_len
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (row0 + nt * 8 + tig * 2 + e >= n) s[nt][e] = NEG_INF;
    }

    // online softmax of row grp; the quad holds its 16 columns
    float mx = fmaxf(fmaxf(s[0][0], s[0][1]), fmaxf(s[1][0], s[1][1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    mx = fmaxf(mx, m_run);
    const float corr = fast_exp2((m_run - mx) * sl2);
    const float mb = mx * sl2;
    const float p00 = fast_exp2(fmaf(s[0][0], sl2, -mb));
    const float p01 = fast_exp2(fmaf(s[0][1], sl2, -mb));
    const float p10 = fast_exp2(fmaf(s[1][0], sl2, -mb));
    const float p11 = fast_exp2(fmaf(s[1][1], sl2, -mb));
    float sum = (p00 + p01) + (p10 + p11);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l_run = l_run * corr + sum;
    m_run = mx;
#pragma unroll
    for (int dt = 0; dt < DTILES; ++dt) {
      acc[dt][0] *= corr;
      acc[dt][1] *= corr;
    }

    // O += P V, P in bf16; the 16 cache rows are one k-step
    const uint32_t pa[4] = {pack_bf16(p00, p01), 0u, pack_bf16(p10, p11),
                            0u};
#pragma unroll
    for (int dp = 0; dp < DTILES / 2; ++dp) {
      uint32_t b[4];
      ldsm_x4_t(b, smem_u32(sv + ((lane & 7) + ((lane >> 3) & 1) * 8) * SD +
                            dp * 16 + (lane >> 4) * 8));
      mma_bf16(acc[2 * dp], pa, b[0], b[1]);
      mma_bf16(acc[2 * dp + 1], pa, b[2], b[3]);
    }
    __syncwarp();  // the next iteration's copies overwrite a used stage
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the rings: reuse them

  // merge the warps: M = max_w m_w, L = sum_w l_w e^(M_w - M), O likewise
  float* sm_m = reinterpret_cast<float*>(smem_raw);  // [WARPS][GROUP]
  float* sm_l = sm_m + WARPS * GROUP;                 // [WARPS][GROUP]
  float* sm_acc = sm_l + WARPS * GROUP;               // [WARPS][GROUP][D]
  if (grp < GROUP) {
    if (tig == 0) {
      sm_m[warp * GROUP + grp] = m_run;
      sm_l[warp * GROUP + grp] = l_run;
    }
    float* row = sm_acc + (warp * GROUP + grp) * D + tig * 2;
#pragma unroll
    for (int dt = 0; dt < DTILES; ++dt)
      *reinterpret_cast<float2*>(row + dt * 8) =
          make_float2(acc[dt][0], acc[dt][1]);
  }
  __syncthreads();

  const long long nblk = static_cast<long long>(gridDim.x) * n_split;
  const long long slot = static_cast<long long>(bg) * n_split + split;
  float* part_acc = a.part;                       // [nblk][GROUP][D]
  float* part_m = a.part + nblk * GROUP * D;      // [nblk][GROUP]
  float* part_l = part_m + nblk * GROUP;          // [nblk][GROUP]
  __nv_bfloat16* ob = a.o + static_cast<long long>(bg) * GROUP * D;
  for (int idx = threadIdx.x; idx < GROUP * D; idx += THREADS) {
    const int j = idx / D, d = idx % D;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, sm_m[w * GROUP + j]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float wt = fast_exp2((sm_m[w * GROUP + j] - M) * sl2);
      L = fmaf(sm_l[w * GROUP + j], wt, L);
      O = fmaf(sm_acc[(w * GROUP + j) * D + d], wt, O);
    }
    if (n_split == 1) {
      ob[idx] = __float2bfloat16(O / fmaxf(L, 1e-37f));
    } else {
      part_acc[slot * GROUP * D + idx] = O;
      if (d == 0) {
        part_m[slot * GROUP + j] = M;
        part_l[slot * GROUP + j] = L;
      }
    }
  }
  if (n_split == 1) return;

  // the last block of this (b, kv head) to finish merges the splits
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    sm_last = atomicAdd(a.counters + bg, 1) == n_split - 1;
  __syncthreads();
  if (!sm_last) return;
  __threadfence();
  // the n_split partials of this (b, kv head), read from L2 in one round
  // of loads: every (split, head) max and sum into shared memory, and the
  // acc rows of the first PRE splits into registers; the weights
  // e^(m_s - M) then come from shared memory
  const long long first = static_cast<long long>(bg) * n_split;
  constexpr int PER = (GROUP * D + THREADS - 1) / THREADS;
  constexpr int PRE = 4;
  const float* pa = part_acc + first * GROUP * D;
  float pre[PRE][PER];
#pragma unroll
  for (int u = 0; u < PRE; ++u)
#pragma unroll
    for (int r = 0; r < PER; ++r) {
      const int idx = threadIdx.x + r * THREADS;
      pre[u][r] = u < n_split && idx < GROUP * D
                      ? __ldcg(pa + u * GROUP * D + idx)
                      : 0.f;
    }
  float* sm_pm = reinterpret_cast<float*>(smem_raw);   // [n_split][GROUP]
  float* sm_pl = sm_pm + MAX_SPLIT * GROUP;            // [n_split][GROUP]
  for (int t = threadIdx.x; t < n_split * GROUP; t += THREADS) {
    sm_pm[t] = __ldcg(part_m + first * GROUP + t);
    sm_pl[t] = __ldcg(part_l + first * GROUP + t);
  }
  __syncthreads();
  if (threadIdx.x < GROUP) {
    const int j = threadIdx.x;
    float M = NEG_INF;
    for (int sp = 0; sp < n_split; ++sp) M = fmaxf(M, sm_pm[sp * GROUP + j]);
    float L = 0.f;
    for (int sp = 0; sp < n_split; ++sp) {
      const float wt = fast_exp2((sm_pm[sp * GROUP + j] - M) * sl2);
      sm_w[sp][j] = wt;
      L = fmaf(sm_pl[sp * GROUP + j], wt, L);
    }
    sm_L[j] = L;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < PER; ++r) {
    const int idx = threadIdx.x + r * THREADS;
    if (idx >= GROUP * D) continue;
    const int j = idx / D;
    float O = 0.f;
#pragma unroll
    for (int u = 0; u < PRE; ++u)
      if (u < n_split) O = fmaf(pre[u][r], sm_w[u][j], O);
    for (int sp = PRE; sp < n_split; ++sp)
      O = fmaf(__ldcg(pa + sp * GROUP * D + idx), sm_w[sp][j], O);
    ob[idx] = __float2bfloat16(O / fmaxf(sm_L[j], 1e-37f));
  }
  if (threadIdx.x == 0) a.counters[bg] = 0;  // ready for the next call
}

// Raises the kernel's dynamic shared memory limit once (above 48 KB it
// must be asked for).
template <int D, int GROUP>
cudaError_t configure() {
  static bool done = false;
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_decode_kernel<D, GROUP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<D>::SMEM);
  if (err == cudaSuccess) done = true;
  return err;
}

template <int D, int GROUP>
int launch(const Args& a, int b, cudaStream_t stream) {
  const cudaError_t err = configure<D, GROUP>();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_decode_kernel<D, GROUP>
      <<<dim3(b * a.g, a.n_split), THREADS, Cfg<D>::SMEM, stream>>>(a);
  return 0;
}

template <int D, int GROUP>
int occupancy(int* blocks, int* smem_bytes) {
  const cudaError_t err = configure<D, GROUP>();
  if (err != cudaSuccess) return static_cast<int>(err);
  *smem_bytes = Cfg<D>::SMEM;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, flash_decode_kernel<D, GROUP>, THREADS, Cfg<D>::SMEM));
}

// The two things the C interface does with an instantiation.
struct Launch {
  const Args& a;
  int b;
  cudaStream_t stream;
  template <int D, int GROUP>
  int run() const { return launch<D, GROUP>(a, b, stream); }
};

struct Occupancy {
  int* blocks;
  int* smem_bytes;
  template <int D, int GROUP>
  int run() const { return occupancy<D, GROUP>(blocks, smem_bytes); }
};

// fn.run<D, GROUP>() for the instantiation of (d, group);
// cudaErrorInvalidValue for any other pair
template <int D, typename Fn>
int with_group(int group, const Fn& fn) {
  switch (group) {
    case 1: return fn.template run<D, 1>();
    case 2: return fn.template run<D, 2>();
    case 4: return fn.template run<D, 4>();
    case 8: return fn.template run<D, 8>();
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename Fn>
int with_instance(int d, int group, const Fn& fn) {
  switch (d) {
    case 16: return with_group<16>(group, fn);
    case 32: return with_group<32>(group, fn);
    case 64: return with_group<64>(group, fn);
    case 96: return with_group<96>(group, fn);
    case 128: return with_group<128>(group, fn);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (b, H, D) through strides q_sb / q_sh; caches (b, S, KVH, D) through
// k_* / v_* strides; kv_len (b,) int32 on the device; o (b, H, D)
// contiguous. With n_split > 1, `part` holds b * KVH * n_split * H/KVH *
// (D + 2) floats and `counters` b * KVH int32 zeros (left at zero). Strides
// are in elements; the head dimension is contiguous and every other
// stride is a multiple of 8 (the wrapper checks both). Returns the
// launch's cudaGetLastError().
extern "C" int repro_flash_decode_bf16(
    const void* q, const void* k, const void* v, const void* kv_len, void* o,
    void* part, void* counters, int b, int S, int h, int g, int d,
    int n_split, long long q_sb, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_split < 1 || n_split > MAX_SPLIT || h % g)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const __nv_bfloat16*>(q),
               static_cast<const __nv_bfloat16*>(k),
               static_cast<const __nv_bfloat16*>(v),
               static_cast<const int*>(kv_len),
               static_cast<__nv_bfloat16*>(o),
               static_cast<float*>(part),
               static_cast<int*>(counters),
               S, g, n_split, q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
               scale * LOG2E};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = with_instance(d, h / g, Launch{a, b, s});
  if (rc) return rc;
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM of the instantiation for head dim d and `group`
// query heads per kv head, and its dynamic shared memory in bytes.
// Returns a CUDA error code.
extern "C" int repro_flash_decode_occupancy(int d, int group, int device,
                                            int* blocks, int* smem_bytes) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return with_instance(d, group, Occupancy{blocks, smem_bytes});
}
