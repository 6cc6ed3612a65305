// Flash-decode for Hopper (sm_90a): one new query row per head against a
// padded KV cache, bf16 in, fp32 softmax and accumulation.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_decode.py
// (flash_decode / _kernel): per (b, h) one query row, kv blocks past
// kv_len[b] skipped, columns masked, online softmax, acc / max(l, 1e-37).
//
// What bounds it on an H100: bytes. Each cache row is used for one dot
// product and one axpy per query head (2-8 FLOP per byte), far below the
// ~295 FLOP/byte ridge, so the time is the K/V bytes up to kv_len over the
// 3.35 TB/s of HBM.
//
// Design, against that bound:
//   * one block per (b, kv head) takes all H/KVH query heads of that kv
//     head, so each K/V row is read from memory once, not once per head
//     (the TPU kernel's grid re-reads it per query head);
//   * kv_len is read from device memory (the cache's pos + 1), so the host
//     never waits on it, and the loop stops there instead of scanning the
//     padded cache;
//   * the cache is read in its stored layout (b, S, kvh, D) through
//     strides: a layer's slice of the stacked cache is not transposed or
//     copied (the JAX wrapper transposes the whole cache per call);
//   * D/8 lanes share one row (16 bytes each, one coalesced row read), so
//     a warp reads 32*8/D rows at once and each lane group keeps its own
//     online-softmax state; the loop issues UNROLL rows' loads before
//     using them; at the end the block merges its row groups through
//     shared memory with the log-sum-exp rule.
// A split over blocks along the cache (a second merge pass) is not done:
// at batch 1 the grid has only KVH blocks (see ROADMAP.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ void unpack8(const uint4& raw, float (&out)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

template <int D, int GROUP>
__global__ void __launch_bounds__(THREADS)
flash_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const int* __restrict__ kv_len,
                    __nv_bfloat16* __restrict__ o, int S, int g,
                    long long q_sb, long long q_sh, long long k_sb,
                    long long k_ss, long long k_sh, long long v_sb,
                    long long v_ss, long long v_sh, float scale) {
  constexpr int LPR = D / 8;             // lanes per cache row
  constexpr int RPW = 32 / LPR;          // rows per warp per step
  constexpr int NSUB = WARPS * RPW;      // row groups in the block
  constexpr int UNROLL = GROUP >= 8 ? 2 : 4;
  constexpr int STEP = NSUB * UNROLL;    // rows per block iteration
  __shared__ float sm_m[NSUB][GROUP];
  __shared__ float sm_l[NSUB][GROUP];
  __shared__ float sm_acc[NSUB][GROUP][D];

  const int bi = blockIdx.x / g, gi = blockIdx.x % g;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = warp * RPW + lane / LPR;  // this lane's row group
  const int col = (lane % LPR) * 8;         // first of its 8 elements
  const int n = min(kv_len[bi], S);

  // the GROUP query heads of this kv head, pre-scaled
  float qv[GROUP][8];
#pragma unroll
  for (int j = 0; j < GROUP; ++j) {
    const uint4 raw = *reinterpret_cast<const uint4*>(
        q + bi * q_sb + (gi * GROUP + j) * q_sh + col);
    unpack8(raw, qv[j]);
#pragma unroll
    for (int e = 0; e < 8; ++e) qv[j][e] *= scale;
  }

  float m_run[GROUP], l_run[GROUP], acc[GROUP][8];
#pragma unroll
  for (int j = 0; j < GROUP; ++j) {
    m_run[j] = NEG_INF;
    l_run[j] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[j][e] = 0.f;
  }

  const __nv_bfloat16* kb = k + bi * k_sb + gi * k_sh + col;
  const __nv_bfloat16* vb = v + bi * v_sb + gi * v_sh + col;
  // the loop bound is uniform over the block, so every lane reaches the
  // shuffles below; rows past n are predicated off, not branched around
  for (int base = 0; base < n; base += STEP) {
    uint4 kr[UNROLL], vr[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = base + u * NSUB + sub;
      kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
      if (r < n) {
        kr[u] = *reinterpret_cast<const uint4*>(kb + r * k_ss);
        vr[u] = *reinterpret_cast<const uint4*>(vb + r * v_ss);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const bool valid = base + u * NSUB + sub < n;
      float kf[8], vf[8];
      unpack8(kr[u], kf);
      unpack8(vr[u], vf);
#pragma unroll
      for (int j = 0; j < GROUP; ++j) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) s = fmaf(qv[j][e], kf[e], s);
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        if (valid) {
          const float m_new = fmaxf(m_run[j], s);
          const float corr = __expf(m_run[j] - m_new);
          const float p = __expf(s - m_new);
          l_run[j] = l_run[j] * corr + p;
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[j][e] = fmaf(acc[j][e], corr, p * vf[e]);
          m_run[j] = m_new;
        }
      }
    }
  }

  // merge the row groups: O = sum_s acc_s e^(m_s - M) / sum_s l_s e^(m_s - M)
#pragma unroll
  for (int j = 0; j < GROUP; ++j) {
    if (lane % LPR == 0) {
      sm_m[sub][j] = m_run[j];
      sm_l[sub][j] = l_run[j];
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) sm_acc[sub][j][col + e] = acc[j][e];
  }
  __syncthreads();
  __nv_bfloat16* ob = o + (static_cast<long long>(bi) * g + gi) * GROUP * D;
  for (int idx = threadIdx.x; idx < GROUP * D; idx += THREADS) {
    const int j = idx / D, d = idx % D;
    float M = NEG_INF;
    for (int s = 0; s < NSUB; ++s) M = fmaxf(M, sm_m[s][j]);
    float L = 0.f, O = 0.f;
    for (int s = 0; s < NSUB; ++s) {
      const float w = __expf(sm_m[s][j] - M);
      L = fmaf(sm_l[s][j], w, L);
      O = fmaf(sm_acc[s][j][d], w, O);
    }
    ob[idx] = __float2bfloat16(O / fmaxf(L, 1e-37f));
  }
}

template <int D, int GROUP>
void launch(const void* q, const void* k, const void* v, const int* kv_len,
            void* o, int b, int S, int g, long long q_sb, long long q_sh,
            long long k_sb, long long k_ss, long long k_sh, long long v_sb,
            long long v_ss, long long v_sh, float scale, cudaStream_t stream) {
  flash_decode_kernel<D, GROUP><<<b * g, THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), kv_len,
      static_cast<__nv_bfloat16*>(o), S, g, q_sb, q_sh, k_sb, k_ss, k_sh,
      v_sb, v_ss, v_sh, scale);
}

template <int D>
int launch_group(int group, const void* q, const void* k, const void* v,
                 const int* kv_len, void* o, int b, int S, int g,
                 long long q_sb, long long q_sh, long long k_sb,
                 long long k_ss, long long k_sh, long long v_sb,
                 long long v_ss, long long v_sh, float scale,
                 cudaStream_t stream) {
  switch (group) {
    case 1:
      launch<D, 1>(q, k, v, kv_len, o, b, S, g, q_sb, q_sh, k_sb, k_ss, k_sh,
                   v_sb, v_ss, v_sh, scale, stream);
      return 0;
    case 2:
      launch<D, 2>(q, k, v, kv_len, o, b, S, g, q_sb, q_sh, k_sb, k_ss, k_sh,
                   v_sb, v_ss, v_sh, scale, stream);
      return 0;
    case 4:
      launch<D, 4>(q, k, v, kv_len, o, b, S, g, q_sb, q_sh, k_sb, k_ss, k_sh,
                   v_sb, v_ss, v_sh, scale, stream);
      return 0;
    case 8:
      launch<D, 8>(q, k, v, kv_len, o, b, S, g, q_sb, q_sh, k_sb, k_ss, k_sh,
                   v_sb, v_ss, v_sh, scale, stream);
      return 0;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (b, H, D) through strides q_sb / q_sh; caches (b, S, KVH, D) through
// k_* / v_* strides; kv_len (b,) int32 on the device; o (b, H, D)
// contiguous. Strides are in elements; the head dimension is contiguous and
// every other stride is a multiple of 8 (the wrapper checks both). Returns
// the launch's cudaGetLastError().
extern "C" int repro_flash_decode_bf16(
    const void* q, const void* k, const void* v, const void* kv_len, void* o,
    int b, int S, int h, int g, int d, long long q_sb, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(kv_len);
  const int group = h / g;
  int rc;
  switch (d) {
    case 16:
      rc = launch_group<16>(group, q, k, v, len, o, b, S, g, q_sb, q_sh, k_sb,
                            k_ss, k_sh, v_sb, v_ss, v_sh, scale, s);
      break;
    case 32:
      rc = launch_group<32>(group, q, k, v, len, o, b, S, g, q_sb, q_sh, k_sb,
                            k_ss, k_sh, v_sb, v_ss, v_sh, scale, s);
      break;
    case 64:
      rc = launch_group<64>(group, q, k, v, len, o, b, S, g, q_sb, q_sh, k_sb,
                            k_ss, k_sh, v_sb, v_ss, v_sh, scale, s);
      break;
    case 128:
      rc = launch_group<128>(group, q, k, v, len, o, b, S, g, q_sb, q_sh, k_sb,
                             k_ss, k_sh, v_sb, v_ss, v_sh, scale, s);
      break;
    default:
      rc = static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc) return rc;
  return static_cast<int>(cudaGetLastError());
}
