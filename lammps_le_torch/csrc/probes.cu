// Hopper (sm_90a) kernels of the two arithmetic microprobes.
//
// They replace the Pallas kernels of lammps_le_tpu's
// benchmarks/probe_rcp.py (make_kernel, P1, and the reciprocal of its
// precision()) and benchmarks/probe_bf16.py (make_kernel, P2).  Each
// probe measures instructions, so each is written where nvcc cannot
// swap them: the approximate reciprocal is inline PTX, the exact one is
// 1.0f / x under the port's flags (IEEE-rounded, no --use_fast_math),
// and the bf16 chain runs on packed __nv_bfloat162 pairs.  Every kernel
// takes PyTorch's current stream, allocates nothing, and each C entry
// point returns cudaGetLastError().  The plain PyTorch versions are in
// lammps_le_torch/probes/probe_rcp.py and probe_bf16.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;

int blocks_for(long work) { return (int)((work + kThreads - 1) / kThreads); }

// ---------------------------------------------------------------------
// P1 <- benchmarks/probe_rcp.py:23 make_kernel (pallas_call :39) and the
// reciprocal of precision() (:59-70, pallas_call :63)
//
// acc <- 0, then reps times acc += r(x + acc) * 1e-7, r the approximate
// reciprocal (rcp.approx.ftz.f32: one MUFU.RCP, at most 1 ulp off) or
// the IEEE one (a MUFU.RCP seed refined by FFMAs, with a range check and
// a slow path).  Bound: operations.  Per element and step the exact
// chain issues 3 f32 instructions and the reciprocal's sequence on
// 128 lanes a clock per SM; the approximate chain 3 f32 instructions and
// one MUFU, whose pipe does 16 lanes a clock per SM (the CUDA C++
// Programming Guide's throughput table, compute capability 9.0), so it
// is bound by the MUFU pipe.  Design: one thread per element, acc in a
// register for the whole chain, serial through acc, so nothing hoists.
// The TPU kernel kept acc in VMEM scratch only because a carried plane
// spills there; a register needs none of that.

__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

template <bool kApprox>
__device__ __forceinline__ float rcp(float x) {
  return kApprox ? rcp_approx(x) : 1.0f / x;
}

template <bool kApprox>
__global__ void rcp_chain_kernel(const float* __restrict__ x,
                                 float* __restrict__ out, long n, int reps) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float xi = x[i];
  float acc = 0.f;
  for (int k = 0; k < reps; ++k) acc = acc + rcp<kApprox>(xi + acc) * 1e-7f;
  out[i] = acc;
}

// one reciprocal an element: precision()'s kernel (approximate), and
// the exact one beside it, whose instructions price the IEEE reciprocal
template <bool kApprox>
__global__ void rcp_kernel(const float* __restrict__ x,
                           float* __restrict__ out, long n) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = rcp<kApprox>(x[i]);
}

// ---------------------------------------------------------------------
// P2 <- benchmarks/probe_bf16.py:29 make_kernel (pallas_call :51)
//
// reps times, from a <- 0: dx = x - a, dy = x * 1.0001 - a, dz = x *
// 0.9999 - a, rsq = dx^2 + dy^2 + dz^2, den = max(rsq, 0.5625), r6 =
// den^3, ff = r6 * 1e-4 - den, a += ff * 1e-6: 17 arithmetic operations
// a step (the TPU probe divides its rate by 16), cast to f32 at the end.
// The constants are rounded to the chain's type first, as JAX's weak
// types round them (in bf16, 1.0001 and 0.9999 are 1).  Bound:
// operations, one instruction each (-fmad=false: no FMA) in f32; in bf16
// each thread owns two adjacent elements as one __nv_bfloat162 (Hopper's
// counterpart of the TPU's (8, 128, 2) packing) and each operation is one
// packed instruction for both.  x stays in a register, so the compiler
// computes x * 1.0001 and x * 0.9999 once, where the TPU kernel read x
// from VMEM and multiplied it anew each step; in bf16, where both
// constants are 1, it also folds x * 1 - a into one instruction.  The
// bound counts the instructions of the compiled step
// (probes.probe_bf16.step_instructions).

__global__ void chain_f32_kernel(const float* __restrict__ x,
                                 float* __restrict__ out, long n, int reps) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float xv = x[i];
  float a = 0.f;
  for (int k = 0; k < reps; ++k) {
    const float dx = xv - a;
    const float dy = xv * 1.0001f - a;
    const float dz = xv * 0.9999f - a;
    const float rsq = dx * dx + dy * dy + dz * dz;
    const float den = fmaxf(rsq, 0.5625f);
    const float r6 = den * den * den;
    const float ff = r6 * 0.0001f - den;
    a = a + ff * 1e-6f;
  }
  out[i] = a;
}

__global__ void chain_bf16x2_kernel(const unsigned int* __restrict__ x,
                                    float2* __restrict__ out, long n2,
                                    int reps) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n2) return;
  const __nv_bfloat162 c_up = __float2bfloat162_rn(1.0001f);
  const __nv_bfloat162 c_dn = __float2bfloat162_rn(0.9999f);
  const __nv_bfloat162 c_floor = __float2bfloat162_rn(0.5625f);
  const __nv_bfloat162 c_r6 = __float2bfloat162_rn(0.0001f);
  const __nv_bfloat162 c_ff = __float2bfloat162_rn(1e-6f);
  const unsigned int xb = x[i];
  __nv_bfloat162 xv;
  memcpy(&xv, &xb, sizeof xv);
  __nv_bfloat162 a = __float2bfloat162_rn(0.f);
  for (int k = 0; k < reps; ++k) {
    const __nv_bfloat162 dx = __hsub2(xv, a);
    const __nv_bfloat162 dy = __hsub2(__hmul2(xv, c_up), a);
    const __nv_bfloat162 dz = __hsub2(__hmul2(xv, c_dn), a);
    const __nv_bfloat162 rsq = __hadd2(
        __hadd2(__hmul2(dx, dx), __hmul2(dy, dy)), __hmul2(dz, dz));
    const __nv_bfloat162 den = __hmax2(rsq, c_floor);
    const __nv_bfloat162 r6 = __hmul2(__hmul2(den, den), den);
    const __nv_bfloat162 ff = __hsub2(__hmul2(r6, c_r6), den);
    a = __hadd2(a, __hmul2(ff, c_ff));
  }
  out[i] = __bfloat1622float2(a);
}

}  // namespace

// ---------------------------------------------------------------------
// C entry points (bound with ctypes by lammps_le_torch/probes/__init__.py)

extern "C" {

int lle_rcp_chain(const float* x, float* out, long n, int reps, int approx,
                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (approx)
    rcp_chain_kernel<true><<<blocks_for(n), kThreads, 0, s>>>(x, out, n,
                                                              reps);
  else
    rcp_chain_kernel<false><<<blocks_for(n), kThreads, 0, s>>>(x, out, n,
                                                               reps);
  return (int)cudaGetLastError();
}

int lle_rcp(const float* x, float* out, long n, int approx, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (approx)
    rcp_kernel<true><<<blocks_for(n), kThreads, 0, s>>>(x, out, n);
  else
    rcp_kernel<false><<<blocks_for(n), kThreads, 0, s>>>(x, out, n);
  return (int)cudaGetLastError();
}

int lle_chain_f32(const float* x, float* out, long n, int reps,
                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  chain_f32_kernel<<<blocks_for(n), kThreads, 0, s>>>(x, out, n, reps);
  return (int)cudaGetLastError();
}

// n: elements (even); x holds n bf16 values, out n floats
int lle_chain_bf16x2(const void* x, float* out, long n, int reps,
                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long n2 = n / 2;
  chain_bf16x2_kernel<<<blocks_for(n2), kThreads, 0, s>>>(
      (const unsigned int*)x, (float2*)out, n2, reps);
  return (int)cudaGetLastError();
}

}  // extern "C"
