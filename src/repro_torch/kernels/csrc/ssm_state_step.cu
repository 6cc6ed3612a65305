// Mamba-2 one-token state step for Hopper (sm_90a): fp32 state updated in
// place, bf16 x/B/C in, fp32 dt/A_log/D, fp32 read-out y.
//
// Replaces no TPU kernel: the JAX package's decode step
// (src/repro/models/ssm.py mamba2_decode_step) is plain jnp. For each
// (batch row b, head h), with dA = exp(dt * -exp(A_log[h])) and g the
// head's group h / (nh / groups):
//   S[p][n] = S[p][n] * dA + (x[p] * dt) * B[g][n]
//   y[p]    = sum_n S[p][n] C[g][n] + D[h] x[p]
// every product and sum rounded to fp32 where the plain version
// (kernels/ssm_state_step.py ssm_state_step_plain) rounds it, so the state
// comes out as the plain version's; only the read-out's summation order
// differs.
//
// What bounds it on an H100: at granite-4.0-h-micro's decode shape (b 128,
// 64 heads, P 64, N 128) the state is 268.4 MB and is read and written
// once (x, B, C, dt and y add 1.1 MB): 0.16 ms at 3.35 TB/s, against ~5
// FLOPs an element. So the design keeps the HBM busy:
//   * one pass: each thread streams its share of the state through
//     registers once, 16 bytes a load, neighbouring threads on
//     neighbouring addresses (a warp reads 512 contiguous bytes an
//     instruction), and issues all ITER of its loads before the first
//     FMA; the loads and stores carry the streaming hint (the state is
//     never reused within a step, and a step's states outgrow L2);
//   * a block of 256 threads holds 32 KB of state: one (b, head) pair at
//     N 128, two at N 64, so several blocks stay resident per SM to keep
//     bytes in flight (at most 64 registers a thread, no shared memory);
//   * a state row's N values sit in N / 4 neighbouring lanes, which sum
//     the read-out with shuffles; the row's first lane writes y.
// x, B and C are read through their strides in their own dtype (column
// slices of the conv output), B/C once per group, never repeated to every
// head; the state through its (b, head) strides (a cache slice), with its
// (P, N) tile contiguous.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ITER = 8;        // 16-byte pieces of state a thread holds

template <int P, int N>
struct Cfg {
  static constexpr int LANES = N / 4;             // threads along a row
  static constexpr int TPP = P * N / (4 * ITER);  // threads a pair
  static constexpr int PAIRS = THREADS / TPP;     // pairs a block
  static constexpr int ROWS = TPP / LANES;        // rows a pass covers
  static_assert(N % 4 == 0 && LANES <= 32 && 32 % LANES == 0,
                "a row spans a power-of-two share of a warp");
  static_assert(THREADS % TPP == 0 && TPP % LANES == 0 && ROWS * ITER == P,
                "the block holds whole pairs");
};

__device__ __forceinline__ float4 bf16x4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ float step(float s, float dA, float xdt, float b) {
  // the plain version's roundings: s * dA, (x dt) * B, then their sum
  return __fadd_rn(__fmul_rn(s, dA), __fmul_rn(xdt, b));
}

template <int P, int N>
__global__ void __launch_bounds__(THREADS, 4) ssm_state_step_kernel(
    float* __restrict__ state, const __nv_bfloat16* __restrict__ x,
    const float* __restrict__ dt, const float* __restrict__ A_log,
    const __nv_bfloat16* __restrict__ B, const __nv_bfloat16* __restrict__ C,
    const float* __restrict__ D, float* __restrict__ y, long long pairs,
    int nh, int heads_per_group, long long st_sb, long long st_sh,
    long long x_sb, long long x_sh, long long dt_sb, long long dt_sh,
    long long b_sb, long long b_sg, long long c_sb, long long c_sg) {
  using K = Cfg<P, N>;
  const int tid = threadIdx.x;
  const long long pair =
      static_cast<long long>(blockIdx.x) * K::PAIRS + tid / K::TPP;
  // a pair past the end still joins its warp's shuffles, and touches
  // nothing
  const bool valid = pair < pairs;
  const int t = tid % K::TPP;
  const int row0 = t / K::LANES, q = t % K::LANES;
  const long long bi = valid ? pair / nh : 0;
  const int h = valid ? static_cast<int>(pair % nh) : 0;
  float* st = state + bi * st_sb + h * st_sh + row0 * N + 4 * q;

  float4 s[ITER];
  float xv[ITER];
  float dtv = 0.f, a = 0.f, dv = 0.f;
  float4 bv = make_float4(0.f, 0.f, 0.f, 0.f), cv = bv;
  if (valid) {
#pragma unroll
    for (int i = 0; i < ITER; ++i)
      s[i] = __ldcs(reinterpret_cast<const float4*>(st + i * K::ROWS * N));
    const __nv_bfloat16* xp = x + bi * x_sb + h * x_sh + row0;
#pragma unroll
    for (int i = 0; i < ITER; ++i) xv[i] = __bfloat162float(xp[i * K::ROWS]);
    const int grp = h / heads_per_group;
    bv = bf16x4(B + bi * b_sb + grp * b_sg + 4 * q);
    cv = bf16x4(C + bi * c_sb + grp * c_sg + 4 * q);
    dtv = dt[bi * dt_sb + h * dt_sh];
    a = A_log[h];
    dv = D[h];
  } else {
#pragma unroll
    for (int i = 0; i < ITER; ++i) {
      s[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      xv[i] = 0.f;
    }
  }
  const float dA = expf(__fmul_rn(dtv, -expf(a)));
  float* yp = y + pair * P + row0;

#pragma unroll
  for (int i = 0; i < ITER; ++i) {
    const float xdt = __fmul_rn(xv[i], dtv);
    float4 v = s[i];
    v.x = step(v.x, dA, xdt, bv.x);
    v.y = step(v.y, dA, xdt, bv.y);
    v.z = step(v.z, dA, xdt, bv.z);
    v.w = step(v.w, dA, xdt, bv.w);
    if (valid) __stcs(reinterpret_cast<float4*>(st + i * K::ROWS * N), v);
    float part = v.x * cv.x;
    part = fmaf(v.y, cv.y, part);
    part = fmaf(v.z, cv.z, part);
    part = fmaf(v.w, cv.w, part);
#pragma unroll
    for (int off = K::LANES / 2; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (valid && q == 0)
      yp[i * K::ROWS] = __fadd_rn(part, __fmul_rn(dv, xv[i]));
  }
}

template <int P, int N>
int launch(float* state, const void* x, const float* dt, const float* A_log,
           const void* B, const void* C, const float* D, float* y, int b,
           int nh, int g, long long st_sb, long long st_sh, long long x_sb,
           long long x_sh, long long dt_sb, long long dt_sh, long long b_sb,
           long long b_sg, long long c_sb, long long c_sg,
           cudaStream_t stream) {
  using K = Cfg<P, N>;
  const long long pairs = static_cast<long long>(b) * nh;
  const long long blocks = (pairs + K::PAIRS - 1) / K::PAIRS;
  ssm_state_step_kernel<P, N><<<static_cast<unsigned>(blocks), THREADS, 0,
                                stream>>>(
      state, static_cast<const __nv_bfloat16*>(x), dt, A_log,
      static_cast<const __nv_bfloat16*>(B),
      static_cast<const __nv_bfloat16*>(C), D, y, pairs, nh, nh / g, st_sb,
      st_sh, x_sb, x_sh, dt_sb, dt_sh, b_sb, b_sg, c_sb, c_sg);
  return 0;
}

template <int P, int N>
int occupancy(int* blocks, int* registers, int* local_bytes) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, ssm_state_step_kernel<P, N>);
  if (err != cudaSuccess) return static_cast<int>(err);
  *registers = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, ssm_state_step_kernel<P, N>, THREADS, 0));
}

}  // namespace

// state (b, nh, P, N) fp32 through its (b, head) strides (in elements;
// the (P, N) tile contiguous, the strides multiples of 4, the start
// 16-byte aligned); x (b, nh, P) and B/C (b, g, N) bf16 through their
// strides (the last dim contiguous, every other stride a multiple of 8,
// the start 16-byte aligned); dt (b, nh) fp32 through its strides; A_log
// and D (nh,) fp32 contiguous; y (b, nh, P) fp32 contiguous, written.
// The state is updated in place. Returns the launch's cudaGetLastError().
extern "C" int repro_ssm_state_step(
    void* state, const void* x, const void* dt, const void* A_log,
    const void* B, const void* C, const void* D, void* y, int b, int nh,
    int g, int P, int N, long long st_sb, long long st_sh, long long x_sb,
    long long x_sh, long long dt_sb, long long dt_sh, long long b_sb,
    long long b_sg, long long c_sb, long long c_sg, int device,
    void* stream) {
  if (b < 1 || nh < 1 || g < 1 || nh % g)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* sp = static_cast<float*>(state);
  const float* dtp = static_cast<const float*>(dt);
  const float* ap = static_cast<const float*>(A_log);
  const float* dp = static_cast<const float*>(D);
  float* yp = static_cast<float*>(y);
  int rc;
  if (P == 64 && N == 128)
    rc = launch<64, 128>(sp, x, dtp, ap, B, C, dp, yp, b, nh, g, st_sb,
                         st_sh, x_sb, x_sh, dt_sb, dt_sh, b_sb, b_sg, c_sb,
                         c_sg, st);
  else if (P == 64 && N == 64)
    rc = launch<64, 64>(sp, x, dtp, ap, B, C, dp, yp, b, nh, g, st_sb, st_sh,
                        x_sb, x_sh, dt_sb, dt_sh, b_sb, b_sg, c_sb, c_sg, st);
  else if (P == 16 && N == 8)
    rc = launch<16, 8>(sp, x, dtp, ap, B, C, dp, yp, b, nh, g, st_sb, st_sh,
                       x_sb, x_sh, dt_sb, dt_sh, b_sb, b_sg, c_sb, c_sg, st);
  else
    rc = static_cast<int>(cudaErrorInvalidValue);
  if (rc) return rc;
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM of the (P, N) instantiation, its registers a
// thread and its local memory (spills) a thread in bytes. Returns a CUDA
// error code.
extern "C" int repro_ssm_state_step_occupancy(int P, int N, int device,
                                              int* blocks, int* registers,
                                              int* local_bytes) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (P == 64 && N == 128) return occupancy<64, 128>(blocks, registers,
                                                     local_bytes);
  if (P == 64 && N == 64) return occupancy<64, 64>(blocks, registers,
                                                   local_bytes);
  if (P == 16 && N == 8) return occupancy<16, 8>(blocks, registers,
                                                 local_bytes);
  return static_cast<int>(cudaErrorInvalidValue);
}
