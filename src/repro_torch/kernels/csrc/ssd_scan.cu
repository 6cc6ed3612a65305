// Mamba-2 SSD chunked scan for Hopper (sm_90a): bf16 x/B/C in, fp32
// dt/A/state, fp32 arithmetic throughout, bf16 y out.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py
// (ssd_scan_kernel / _kernel) and computes what the pure-JAX
// src/repro/models/ssm.py::ssd_scan computes. For each (b, head) and each
// chunk of Q steps, with cum the inclusive cumsum of dt*A inside the chunk:
//   y_i   = sum_{j<=i} exp(cum_i - cum_j) dt_j (C_i . B_j) x_j
//           + exp(cum_i) C_i . S_in
//   S_out = exp(cum_last) S_in + sum_j exp(cum_last - cum_j) dt_j B_j x_j^T
// Only differences that are <= 0 are exponentiated (cum_i - cum_j for
// j <= i, cum_last - cum_j, cum_i), so nothing overflows however large dt
// grows; exp(cum_i) * exp(-cum_j) is never formed.
//
// What bounds it on an H100: at the serving shape (b 8, s 512, 64 heads,
// P = N = 64, Q = 128) it moves ~78 MB (x, y, B/C, dt, final state) and
// does ~13 GFLOP, so the bound is bytes (0.023 ms at 3.35 TB/s). This
// first version runs its products on the fp32 CUDA cores from shared
// memory (register tiles of 8x8, 8x4 and 4x4), so it is bound by those
// instead; mma.sync/wgmma for C.B^T and W.x, TMA and pipelining are later
// work.
//
// Design:
//   * one block per (b, head) loops over the chunks in order and keeps the
//     N x P fp32 state in shared memory (the Pallas grid's sequential chunk
//     axis relies on TPU grid order; GPU blocks run in no order);
//   * x, B and C are read in the model layout through strides (column
//     slices of the conv output); head h reads group h / (nh / g), so B/C
//     are never repeated to every head and nothing is transposed in HBM;
//   * a ragged last chunk is masked: steps past s are never read and act
//     as dt = 0 (no decay, no state write), so the final state is the
//     state at s; init_state (optional) seeds the state, and the final
//     state is written out;
//   * shared memory per block at Q = 128, P = N = 64: x (32 KB), B^T and
//     C^T (2 x 33 KB, rows padded by 4 floats against bank conflicts), the
//     Q x Q decay-masked weights (64 KB) and the state (16 KB): ~180 KB of
//     dynamic shared memory, opted in with cudaFuncSetAttribute.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int QMAX = 128;
constexpr int PAD = 4;  // floats added to each row of B^T / C^T

__device__ __forceinline__ void unpack8(const uint4& raw, float (&out)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float (&out)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

template <int P, int N>
constexpr int smem_floats(int Q) {
  return Q * P + 2 * N * (Q + PAD) + Q * Q + N * P + 3 * Q;
}

template <int P, int N>
__global__ void __launch_bounds__(THREADS)
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
  static_assert(P % 8 == 0 && N % 8 == 0, "P and N are multiples of 8");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int QS = Q + PAD;       // row stride of B^T and C^T
  float* xs = smem;             // [Q][P]   x_j
  float* bT = xs + Q * P;       // [N][QS]  B_j, transposed
  float* cT = bT + N * QS;      // [N][QS]  C_i, transposed
  float* wT = cT + N * QS;      // [Q][Q]   wT[j][i] = W_ij
  float* S = wT + Q * Q;        // [N][P]   the carried state
  float* cum = S + N * P;       // [Q]
  float* dts = cum + Q;         // [Q]
  float* dec = dts + Q;         // [Q]      exp(cum_last - cum_j) dt_j

  const int tid = threadIdx.x;
  const int bi = blockIdx.x / nh, h = blockIdx.x % nh;
  const int gi = h / (nh / g);
  const float a = A[h];
  const __nv_bfloat16* xb = x + bi * x_sb + h * x_sh;
  const __nv_bfloat16* bb = B + bi * b_sb + gi * b_sg;
  const __nv_bfloat16* cb = C + bi * c_sb + gi * c_sg;
  const float* dtb = dt + bi * dt_sb + h * dt_sh;
  // y (b, s, nh, P) and the states (b, nh, P, N) are contiguous
  const long long y_ss = static_cast<long long>(nh) * P;
  __nv_bfloat16* yb = y + static_cast<long long>(bi) * s * y_ss + h * P;
  const long long st0 = static_cast<long long>(blockIdx.x) * P * N;

  for (int idx = tid; idx < P * N; idx += THREADS) {
    const int p = idx / N, n = idx % N;
    S[n * P + p] = init_state ? init_state[st0 + idx] : 0.f;
  }

  const int QT = Q / 8;
  const int nchunks = (s + Q - 1) / Q;
  for (int c = 0; c < nchunks; ++c) {
    const int t0 = c * Q;
    const int L = min(Q, s - t0);  // valid steps in this chunk

    // ---- load the chunk: rows past L are zeros and are never read
    constexpr int XV = P / 8;
    for (int idx = tid; idx < Q * XV; idx += THREADS) {
      const int j = idx / XV, v = idx % XV;
      float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (j < L)
        unpack8(*reinterpret_cast<const uint4*>(xb + (t0 + j) * x_ss + v * 8),
                f);
      store8(xs + j * P + v * 8, f);
    }
    constexpr int NV = N / 8;
    for (int idx = tid; idx < Q * NV; idx += THREADS) {
      const int j = idx % Q, v = idx / Q;
      float fb[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      float fc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (j < L) {
        unpack8(*reinterpret_cast<const uint4*>(bb + (t0 + j) * b_ss + v * 8),
                fb);
        unpack8(*reinterpret_cast<const uint4*>(cb + (t0 + j) * c_ss + v * 8),
                fc);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        bT[(v * 8 + e) * QS + j] = fb[e];
        cT[(v * 8 + e) * QS + j] = fc[e];
      }
    }
    for (int j = tid; j < Q; j += THREADS)
      dts[j] = j < L ? dtb[(t0 + j) * dt_ss] : 0.f;
    __syncthreads();

    // ---- inclusive cumsum of dt*A over the chunk (warp 0)
    if (tid < 32) {
      float carry = 0.f;
      for (int base = 0; base < Q; base += 32) {
        const int j = base + tid;
        float v = j < Q ? dts[j] * a : 0.f;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, v, off);
          if (tid >= off) v += u;
        }
        v += carry;
        if (j < Q) cum[j] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();
    const float cum_last = cum[Q - 1];
    for (int j = tid; j < Q; j += THREADS)
      dec[j] = expf(cum_last - cum[j]) * dts[j];

    // ---- W_ij = exp(cum_i - cum_j) dt_j (C_i . B_j) for j <= i, else 0;
    //      tiles wholly above the diagonal are never read and not written
    for (int tile = tid; tile < QT * QT; tile += THREADS) {
      const int ti = tile / QT, tj = tile % QT;
      if (tj > ti) continue;
      const int i0 = ti * 8, j0 = tj * 8;
      float acc[8][8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[r][k] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float ci[8], bj[8];
        load8(cT + n * QS + i0, ci);
        load8(bT + n * QS + j0, bj);
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int k = 0; k < 8; ++k) acc[r][k] = fmaf(ci[r], bj[k], acc[r][k]);
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int j = j0 + k;
        const float cj = cum[j], dj = dts[j];
        float col[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int i = i0 + r;
          col[r] = j <= i ? expf(cum[i] - cj) * acc[r][k] * dj : 0.f;
        }
        store8(wT + j * Q + i0, col);
      }
    }
    __syncthreads();

    // ---- y_i = sum_{j<=i} W_ij x_j + exp(cum_i) C_i . S_in, rows < L
    constexpr int PT = P / 4;
    for (int tile = tid; tile < QT * PT; tile += THREADS) {
      const int ti = tile / PT, tp = tile % PT;
      const int i0 = ti * 8, p0 = tp * 4;
      if (i0 >= L) continue;
      float acc[8][4], accs[8][4];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[r][k] = accs[r][k] = 0.f;
      const int jend = min(i0 + 8, L);
      for (int j = 0; j < jend; ++j) {
        float w[8];
        load8(wT + j * Q + i0, w);
        const float4 xv = *reinterpret_cast<const float4*>(xs + j * P + p0);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          acc[r][0] = fmaf(w[r], xv.x, acc[r][0]);
          acc[r][1] = fmaf(w[r], xv.y, acc[r][1]);
          acc[r][2] = fmaf(w[r], xv.z, acc[r][2]);
          acc[r][3] = fmaf(w[r], xv.w, acc[r][3]);
        }
      }
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float ci[8];
        load8(cT + n * QS + i0, ci);
        const float4 sv = *reinterpret_cast<const float4*>(S + n * P + p0);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          accs[r][0] = fmaf(ci[r], sv.x, accs[r][0]);
          accs[r][1] = fmaf(ci[r], sv.y, accs[r][1]);
          accs[r][2] = fmaf(ci[r], sv.z, accs[r][2]);
          accs[r][3] = fmaf(ci[r], sv.w, accs[r][3]);
        }
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int i = i0 + r;
        if (i < L) {
          const float e = expf(cum[i]);
          __nv_bfloat162 lo = __floats2bfloat162_rn(
              fmaf(e, accs[r][0], acc[r][0]), fmaf(e, accs[r][1], acc[r][1]));
          __nv_bfloat162 hi = __floats2bfloat162_rn(
              fmaf(e, accs[r][2], acc[r][2]), fmaf(e, accs[r][3], acc[r][3]));
          uint2 packed;
          packed.x = *reinterpret_cast<uint32_t*>(&lo);
          packed.y = *reinterpret_cast<uint32_t*>(&hi);
          *reinterpret_cast<uint2*>(yb + (t0 + i) * y_ss + p0) = packed;
        }
      }
    }
    __syncthreads();  // S_in is read above and replaced below

    // ---- S_out = exp(cum_last) S_in + sum_{j<L} dec_j B_j x_j^T
    const float chunk_decay = expf(cum_last);
    constexpr int NT = N / 4;
    for (int tile = tid; tile < NT * PT; tile += THREADS) {
      const int tn = tile / PT, tp = tile % PT;
      const int n0 = tn * 4, p0 = tp * 4;
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[r][k] = 0.f;
      for (int j = 0; j < L; ++j) {
        const float d = dec[j];
        const float4 xv = *reinterpret_cast<const float4*>(xs + j * P + p0);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float bv = bT[(n0 + r) * QS + j] * d;
          acc[r][0] = fmaf(bv, xv.x, acc[r][0]);
          acc[r][1] = fmaf(bv, xv.y, acc[r][1]);
          acc[r][2] = fmaf(bv, xv.z, acc[r][2]);
          acc[r][3] = fmaf(bv, xv.w, acc[r][3]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float4* sp = reinterpret_cast<float4*>(S + (n0 + r) * P + p0);
        float4 sv = *sp;
        sv.x = fmaf(sv.x, chunk_decay, acc[r][0]);
        sv.y = fmaf(sv.y, chunk_decay, acc[r][1]);
        sv.z = fmaf(sv.z, chunk_decay, acc[r][2]);
        sv.w = fmaf(sv.w, chunk_decay, acc[r][3]);
        *sp = sv;
      }
    }
    __syncthreads();
  }

  for (int idx = tid; idx < P * N; idx += THREADS) {
    const int p = idx / N, n = idx % N;
    state_out[st0 + idx] = S[n * P + p];
  }
}

template <int P, int N>
int launch(const void* x, const float* dt, const float* A, const void* B,
           const void* C, const float* init_state, void* y, float* state_out,
           int b, int s, int nh, int g, int Q, long long x_sb, long long x_ss,
           long long x_sh, long long dt_sb, long long dt_ss, long long dt_sh,
           long long b_sb, long long b_ss, long long b_sg, long long c_sb,
           long long c_ss, long long c_sg, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_floats<P, N>(QMAX) * sizeof(float)));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const size_t bytes = smem_floats<P, N>(Q) * sizeof(float);
  ssd_scan_kernel<P, N><<<b * nh, THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), dt, A,
      static_cast<const __nv_bfloat16*>(B),
      static_cast<const __nv_bfloat16*>(C), init_state,
      static_cast<__nv_bfloat16*>(y), state_out, s, nh, g, Q, x_sb, x_ss,
      x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, b_sg, c_sb, c_ss, c_sg);
  return 0;
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
  else if (P == 16 && N == 8)
    rc = launch<16, 8>(x, dtp, Ap, B, C, init, y, out, b, s, nh, g, Q, x_sb,
                       x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, b_sg,
                       c_sb, c_ss, c_sg, st);
  else
    rc = static_cast<int>(cudaErrorInvalidValue);
  if (rc) return rc;
  return static_cast<int>(cudaGetLastError());
}
