// The trainer's AdamW step (B8) for Hopper (sm_90a): the chunks' gradients
// combined, the global norm, the clip and AdamW over every leaf of a
// parameter tree, in two passes, each one launch over all the leaves.
//
// Replaces no TPU kernel: the JAX package's optimizer
// (src/repro/train/optimizer.py:70 adamw_update) is plain JAX, and the port
// ran it, after the trainer's combine of its chunks' gradients, as some
// twenty eager fp32 passes a leaf (kernels/adamw_step.py adamw_step_plain
// keeps them). For each element of a leaf, with the K chunks' gradients g_c in
// the leaf's dtype (bf16 or fp32), their example counts n_c and
// N = sum_c n_c:
//   g = ((g_0 n_0 + g_1 n_1) + ... + g_K-1 n_K-1) * (1 / N)   the combine
//   norm pass:   norm = sqrt(sum of g * g over every element of every leaf),
//                scale = min((1 / max(norm, 1e-9)) * clip, 1)
//   update pass: g *= scale; m = m b1 + g (1 - b1); v = v b2 + (g g)(1 - b2)
//                u = (m (1 / bc1)) / (sqrt(v (1 / bc2)) + eps) + wd w
//                w -= lr u; the parameter = w in its own dtype
// Every product and sum is rounded to fp32 where PyTorch's eager chain on
// the card rounds it (it divides by a host scalar as a product with the
// scalar's fp32 reciprocal, and `clip / norm` is `norm.reciprocal() *
// clip`), with no multiply-add contraction, so the update comes out as the
// plain version's for the same scale. The norm is summed in fp64 in
// another order than torch.sum's.
//
// What bounds it on an H100: about one FLOP a byte, so HBM. At
// stablelm-1.6b (1.645e9 parameters in bf16) and K = 4 the norm pass reads
// 2K = 8 B a parameter and the update pass 2K + 12 and writes 12 + 2:
// 42 B a parameter, 69.1 GB, 20.6 ms at 3.35 TB/s (the eager chain moved
// some 280 B a parameter, with the combined fp32 gradient in device memory
// between them). So the design keeps the combined gradient in registers
// and the HBM busy:
//   * one launch a pass over all leaves: a table on the card holds each
//     leaf's size, dtype, first tile and addresses; the leaves are cut into
//     tiles of 2048 elements (8 a thread), and a persistent grid (the SMs
//     times the blocks resident on each) walks them, block b taking tiles
//     b, b + grid, ...; the ragged end of each leaf is masked;
//   * 16 bytes a load, neighbouring threads on neighbouring addresses; up
//     to 64 bytes of gradients a thread (4 bf16 or 2 fp32 chunks) and, in
//     the update pass, m, v and master issued before the first product;
//     the streaming hint on every load and store (each byte is touched once
//     a pass, and a pass outgrows L2);
//   * a norm that repeats its bits: each block sums its elements' squares
//     in fp64 in a fixed order into one partial; a one-block kernel sums
//     the partials in a fixed order. No atomics; the grid depends only on
//     the card;
//   * the norm and the scale stay on the card: the update pass reads the
//     scale there; nothing waits for the host.
// Every tensor keeps its address (CUDA graphs read the weights where they
// were captured); the kernels allocate nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 8;                      // elements a thread a tile
constexpr long long TILE = THREADS * VEC;   // elements a tile

// The table (int64), for L leaves and K chunks:
//   tiles[L + 1]  the first tile of each leaf, then the total
//   n[L]          elements
//   fp32[L]       1: the leaf (gradients and parameter) is fp32, 0: bf16
//   grad[L * K]   the chunks' gradients, leaf-major
//   count[K]      each chunk's example count, as the bits of a double
// and the state table: m[L], v[L], master[L], param[L].
struct Table {
  const long long* tiles;
  const long long* n;
  const long long* fp32;
  const long long* grad;
  const long long* count;
  __device__ Table(const long long* t, int L, int K)
      : tiles(t), n(t + L + 1), fp32(t + 2 * L + 1), grad(t + 3 * L + 1),
        count(t + 3 * L + 1 + static_cast<long long>(L) * K) {}
};

struct Hyper {
  float lr, b1, omb1, b2, omb2, rbc1, rbc2, eps, wd;
};

// the largest leaf whose first tile is at or before tile t
__device__ __forceinline__ int find_leaf(const long long* tiles, int L,
                                         long long t) {
  int lo = 0, hi = L - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(tiles + mid) <= t) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// 8 elements of one chunk's gradient, as loaded
template <typename T> struct Raw;
template <> struct Raw<__nv_bfloat16> { uint4 u; };
template <> struct Raw<float> { float4 a, b; };

__device__ __forceinline__ Raw<__nv_bfloat16> load_raw(
    const __nv_bfloat16* p, int rem) {
  Raw<__nv_bfloat16> r;
  if (rem >= VEC) {
    r.u = __ldcs(reinterpret_cast<const uint4*>(p));
  } else {
    const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
    unsigned int w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned int lo = 2 * i < rem ? h[2 * i] : 0u;
      const unsigned int hi = 2 * i + 1 < rem ? h[2 * i + 1] : 0u;
      w[i] = lo | (hi << 16);
    }
    r.u = make_uint4(w[0], w[1], w[2], w[3]);
  }
  return r;
}

__device__ __forceinline__ Raw<float> load_raw(const float* p, int rem) {
  Raw<float> r;
  if (rem >= VEC) {
    r.a = __ldcs(reinterpret_cast<const float4*>(p));
    r.b = __ldcs(reinterpret_cast<const float4*>(p) + 1);
  } else {
    float x[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) x[i] = i < rem ? p[i] : 0.f;
    r.a = make_float4(x[0], x[1], x[2], x[3]);
    r.b = make_float4(x[4], x[5], x[6], x[7]);
  }
  return r;
}

__device__ __forceinline__ void widen(const Raw<__nv_bfloat16>& r,
                                      float (&x)[VEC]) {
  const unsigned int w[4] = {r.u.x, r.u.y, r.u.z, r.u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void widen(const Raw<float>& r, float (&x)[VEC]) {
  x[0] = r.a.x; x[1] = r.a.y; x[2] = r.a.z; x[3] = r.a.w;
  x[4] = r.b.x; x[5] = r.b.y; x[6] = r.b.z; x[7] = r.b.w;
}

// the combined gradient of 8 elements from element e of leaf `leaf`;
// rem = the elements left in the leaf from e (the ragged end reads fewer
// and gives zeros past it)
template <typename T>
__device__ __forceinline__ void combine(const Table& tab, int leaf, int K,
                                        float inv_n, long long e, int rem,
                                        float (&g)[VEC]) {
  constexpr int KG = 64 / (VEC * static_cast<int>(sizeof(T)));
  const long long* gp = tab.grad + static_cast<long long>(leaf) * K;
  for (int c0 = 0; c0 < K; c0 += KG) {
    Raw<T> raw[KG];
#pragma unroll
    for (int j = 0; j < KG; ++j)
      if (c0 + j < K)
        raw[j] = load_raw(reinterpret_cast<const T*>(__ldg(gp + c0 + j)) + e,
                          rem);
#pragma unroll
    for (int j = 0; j < KG; ++j) {
      if (c0 + j < K) {
        const float w = __double2float_rn(
            __longlong_as_double(__ldg(tab.count + c0 + j)));
        float x[VEC];
        widen(raw[j], x);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float t = __fmul_rn(x[i], w);
          g[i] = c0 + j == 0 ? t : __fadd_rn(g[i], t);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) g[i] = __fmul_rn(g[i], inv_n);
}

// a fixed-order sum over the block, in thread 0
__device__ __forceinline__ double block_sum(double s) {
  __shared__ double warp_sums[THREADS / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = s;
  __syncthreads();
  double total = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < THREADS / 32; ++w) total += warp_sums[w];
  return total;
}

__global__ void __launch_bounds__(THREADS) adamw_norm_kernel(
    const long long* __restrict__ table, int L, int K, float inv_n,
    double* __restrict__ partial) {
  const Table tab(table, L, K);
  const long long T = __ldg(tab.tiles + L);
  double ss = 0.0;
  for (long long t = blockIdx.x; t < T; t += gridDim.x) {
    const int leaf = find_leaf(tab.tiles, L, t);
    const long long e =
        (t - __ldg(tab.tiles + leaf)) * TILE + threadIdx.x * VEC;
    const long long n = __ldg(tab.n + leaf);
    if (e >= n) continue;
    const int rem = n - e < VEC ? static_cast<int>(n - e) : VEC;
    float g[VEC];
    if (__ldg(tab.fp32 + leaf))
      combine<float>(tab, leaf, K, inv_n, e, rem, g);
    else
      combine<__nv_bfloat16>(tab, leaf, K, inv_n, e, rem, g);
    float part = 0.f;   // zeros past the end add nothing
#pragma unroll
    for (int i = 0; i < VEC; ++i) part = __fadd_rn(part, __fmul_rn(g[i], g[i]));
    ss += static_cast<double>(part);
  }
  const double total = block_sum(ss);
  if (threadIdx.x == 0) partial[blockIdx.x] = total;
}

__global__ void __launch_bounds__(THREADS) adamw_norm_finish_kernel(
    const double* __restrict__ partial, int parts, float clip,
    float* __restrict__ out) {
  double s = 0.0;
  for (int i = threadIdx.x; i < parts; i += THREADS) s += partial[i];
  const double total = block_sum(s);
  if (threadIdx.x == 0) {
    const float norm = __double2float_rn(sqrt(total));
    // torch.clamp(norm, min=1e-9).reciprocal() * clip, clamped to 1; a
    // NaN norm gives a NaN scale, as there
    const float floor = norm < 1e-9f ? 1e-9f : norm;
    float scale = __fmul_rn(__frcp_rn(floor), clip);
    scale = scale > 1.f ? 1.f : scale;
    out[0] = norm;
    out[1] = scale;
  }
}

__device__ __forceinline__ void load8(const float* p, int rem,
                                      float (&x)[VEC]) {
  widen(load_raw(p, rem), x);
}

__device__ __forceinline__ void store8(float* p, int rem,
                                       const float (&x)[VEC]) {
  if (rem >= VEC) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(x[0], x[1], x[2], x[3]));
    __stcs(reinterpret_cast<float4*>(p) + 1,
           make_float4(x[4], x[5], x[6], x[7]));
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      if (i < rem) p[i] = x[i];
  }
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, int rem,
                                       const float (&x)[VEC]) {
  unsigned short h[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i)
    h[i] = __bfloat16_as_ushort(__float2bfloat16_rn(x[i]));
  if (rem >= VEC) {
    __stcs(reinterpret_cast<uint4*>(p),
           make_uint4(h[0] | (static_cast<unsigned int>(h[1]) << 16),
                      h[2] | (static_cast<unsigned int>(h[3]) << 16),
                      h[4] | (static_cast<unsigned int>(h[5]) << 16),
                      h[6] | (static_cast<unsigned int>(h[7]) << 16)));
  } else {
    unsigned short* q = reinterpret_cast<unsigned short*>(p);
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      if (i < rem) q[i] = h[i];
  }
}

template <typename T>
__device__ __forceinline__ void update8(const Table& tab,
                                        const long long* state, int L,
                                        int leaf, int K, float inv_n,
                                        float scale, const Hyper& h,
                                        long long e, int rem) {
  float* m = reinterpret_cast<float*>(__ldg(state + leaf)) + e;
  float* v = reinterpret_cast<float*>(__ldg(state + L + leaf)) + e;
  float* w = reinterpret_cast<float*>(__ldg(state + 2 * L + leaf)) + e;
  T* p = reinterpret_cast<T*>(__ldg(state + 3 * L + leaf)) + e;
  float mv[VEC], vv[VEC], wv[VEC], g[VEC];
  load8(m, rem, mv);
  load8(v, rem, vv);
  load8(w, rem, wv);
  combine<T>(tab, leaf, K, inv_n, e, rem, g);
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const float gi = __fmul_rn(g[i], scale);
    const float mi = __fadd_rn(__fmul_rn(mv[i], h.b1), __fmul_rn(gi, h.omb1));
    const float vi = __fadd_rn(__fmul_rn(vv[i], h.b2),
                               __fmul_rn(__fmul_rn(gi, gi), h.omb2));
    const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(vi, h.rbc2)), h.eps);
    const float u = __fadd_rn(__fdiv_rn(__fmul_rn(mi, h.rbc1), den),
                              __fmul_rn(h.wd, wv[i]));
    mv[i] = mi;
    vv[i] = vi;
    wv[i] = __fsub_rn(wv[i], __fmul_rn(h.lr, u));
  }
  store8(m, rem, mv);
  store8(v, rem, vv);
  store8(w, rem, wv);
  store8(p, rem, wv);
}

__global__ void __launch_bounds__(THREADS) adamw_update_kernel(
    const long long* __restrict__ table, const long long* __restrict__ state,
    int L, int K, float inv_n, const float* __restrict__ scale_p, Hyper h) {
  const Table tab(table, L, K);
  const long long T = __ldg(tab.tiles + L);
  const float scale = __ldg(scale_p);
  for (long long t = blockIdx.x; t < T; t += gridDim.x) {
    const int leaf = find_leaf(tab.tiles, L, t);
    const long long e =
        (t - __ldg(tab.tiles + leaf)) * TILE + threadIdx.x * VEC;
    const long long n = __ldg(tab.n + leaf);
    if (e >= n) continue;
    const int rem = n - e < VEC ? static_cast<int>(n - e) : VEC;
    if (__ldg(tab.fp32 + leaf))
      update8<float>(tab, state, L, leaf, K, inv_n, scale, h, e, rem);
    else
      update8<__nv_bfloat16>(tab, state, L, leaf, K, inv_n, scale, h, e,
                             rem);
  }
}

template <typename Kernel>
int occupancy_of(Kernel* kernel, int* blocks, int* registers,
                 int* local_bytes) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  *registers = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, THREADS, 0));
}

}  // namespace

// The norm pass: `table` as above on the card (every gradient 16-byte
// aligned and contiguous, each leaf's chunks in its dtype), `grid` blocks
// (at most the tiles), `partial` grid fp64 values of scratch, `out` two
// fp32 values written: the norm and the clip scale. Two launches on
// `stream`. Returns the last launch's cudaGetLastError().
extern "C" int repro_adamw_norm(const void* table, int L, int K, float inv_n,
                                int grid, void* partial, float clip,
                                void* out, int device, void* stream) {
  if (L < 1 || K < 1 || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  adamw_norm_kernel<<<grid, THREADS, 0, st>>>(
      static_cast<const long long*>(table), L, K, inv_n,
      static_cast<double*>(partial));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  adamw_norm_finish_kernel<<<1, THREADS, 0, st>>>(
      static_cast<const double*>(partial), grid, clip,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The update pass: `table` as the norm pass's, `state` the m, v, master
// (fp32) and parameter (the leaf's dtype) addresses, each 16-byte aligned
// and contiguous; `scale` the norm pass's clip scale on the card; the
// hyper-parameters as fp32 (1 - b1, 1 - b2 and the reciprocals of the bias
// corrections as PyTorch rounds them). m, v, master and the parameter are
// written in place. Returns the launch's cudaGetLastError().
extern "C" int repro_adamw_update(const void* table, const void* state,
                                  int L, int K, float inv_n,
                                  const void* scale, float lr, float b1,
                                  float omb1, float b2, float omb2,
                                  float rbc1, float rbc2, float eps,
                                  float wd, int grid, int device,
                                  void* stream) {
  if (L < 1 || K < 1 || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Hyper h{lr, b1, omb1, b2, omb2, rbc1, rbc2, eps, wd};
  adamw_update_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(table),
      static_cast<const long long*>(state), L, K, inv_n,
      static_cast<const float*>(scale), h);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM of the norm pass's kernel (which = 0) or the
// update pass's (1), its registers a thread and its local memory (spills)
// a thread in bytes. Returns a CUDA error code.
extern "C" int repro_adamw_occupancy(int which, int device, int* blocks,
                                     int* registers, int* local_bytes) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (which == 0)
    return occupancy_of(adamw_norm_kernel, blocks, registers, local_bytes);
  if (which == 1)
    return occupancy_of(adamw_update_kernel, blocks, registers,
                        local_bytes);
  return static_cast<int>(cudaErrorInvalidValue);
}
