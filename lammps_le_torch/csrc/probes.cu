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
// lammps_le_torch/probes/probe_rcp.py and probe_bf16.py.  The one-pass
// reciprocal's first form, one element a thread, stays beside its
// redesign with its own entry point: its exact kernel is the listing
// that prices the IEEE reciprocal (probe_rcp.rcp_price).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;

int blocks_for(long work) { return (int)((work + kThreads - 1) / kThreads); }

// the card's SM count (one device a process, read once)
int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

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

// one reciprocal an element, one element a thread: precision()'s first
// kernel (approximate), and the exact one beside it, whose
// instructions price the IEEE reciprocal (probe_rcp.rcp_price reads both
// listings)
template <bool kApprox>
__global__ void rcp_kernel(const float* __restrict__ x,
                           float* __restrict__ out, long n) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = rcp<kApprox>(x[i]);
}

// precision()'s kernel as redesigned: the same reciprocal an element over
// 16-byte loads and stores (float4), a grid of whole waves (a multiple
// of the SM count, blocks of kThreads), each thread walking the float4s
// at the grid's stride kRcpUnroll at a time with all its loads issued
// before its first reciprocal; the n % 4 tail elements by the first
// threads.  Bound: bytes (8 a element) — 0.5 us for the probe's 216,064
// floats at 3.35 TB/s, below a launch's own device time, so the
// design's aim is the fewest instructions and memory transactions in
// the one wave that the launch costs anyway.
constexpr int kRcpUnroll = 2;

template <bool kApprox>
__device__ __forceinline__ float4 rcp4(float4 v) {
  return make_float4(rcp<kApprox>(v.x), rcp<kApprox>(v.y), rcp<kApprox>(v.z),
                     rcp<kApprox>(v.w));
}

template <bool kApprox>
__global__ void __launch_bounds__(kThreads)
    rcp_vec_kernel(const float* __restrict__ x, float* __restrict__ out,
                   long n) {
  const long n4 = n / 4;
  const float4* __restrict__ x4 = reinterpret_cast<const float4*>(x);
  float4* __restrict__ o4 = reinterpret_cast<float4*>(out);
  const long stride = (long)gridDim.x * blockDim.x;
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  long i = t;
  for (; i + (kRcpUnroll - 1) * stride < n4; i += kRcpUnroll * stride) {
    float4 v[kRcpUnroll];
#pragma unroll
    for (int u = 0; u < kRcpUnroll; ++u) v[u] = x4[i + u * stride];
#pragma unroll
    for (int u = 0; u < kRcpUnroll; ++u)
      o4[i + u * stride] = rcp4<kApprox>(v[u]);
  }
  for (; i < n4; i += stride) o4[i] = rcp4<kApprox>(x4[i]);
  const long tail = 4 * n4 + t;
  if (tail < n) out[tail] = rcp<kApprox>(x[tail]);
}

// the redesigned rcp's grid for n elements: the blocks its float4 passes
// need, rounded up to whole waves of one block an SM, at most as many
// waves as the occupancy keeps resident at once
template <bool kApprox>
int rcp_vec_blocks(long n) {
  static int occ = 0;
  if (occ == 0)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, rcp_vec_kernel<kApprox>, kThreads, 0);
  const int sms = sm_count();
  const long need = (n / 4 + (long)kThreads * kRcpUnroll - 1) /
                    ((long)kThreads * kRcpUnroll);
  const long waves = (need + sms - 1) / sms;
  const long cap = occ > 0 ? occ : 1;
  return (int)((waves < 1 ? 1 : (waves < cap ? waves : cap)) * sms);
}

// an empty kernel: the launch floor, timed at rcp's own launch shape
__global__ void empty_kernel() {}

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

// one packed pair a thread, on a grid (chain_bf16x2_grid) that spreads
// the warps evenly over the SMs: blocks of 256 gave 28 of the 132 SMs a
// fourth block at 8 rows, and those SMs paced the run.  The chain is
// issue-bound, so the time follows the most pair-steps a warp scheduler
// holds; interleaving two or four pairs a thread was slower on the H100
// (PERF.md §6, P2).  Each operation rounds as the plain version's: one
// packed instruction each, no multiply and add fused.
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

// (blocks, threads) for n2 threads of chain_bf16x2_kernel: the warps
// spread evenly over the SMs (each SM's share rounded up), in as few
// equal blocks an SM as 1,024 threads a block and the occupancy
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor at that block size)
// allow, so every block of the one wave is resident at once and every SM
// but the last block's holds the same warps
void chain_bf16x2_grid(long n2, int* blocks, int* threads) {
  const int sms = sm_count();
  const long per_sm = ((n2 + 31) / 32 + sms - 1) / sms;
  long bps = (per_sm + 31) / 32;
  long per_block = (per_sm + bps - 1) / bps;
  for (;;) {
    int occ = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, chain_bf16x2_kernel, (int)(32 * per_block), 0);
    if (occ >= bps || per_block == 1) break;
    ++bps;
    per_block = (per_sm + bps - 1) / bps;
  }
  *threads = (int)(32 * per_block);
  *blocks = (int)((n2 + *threads - 1) / *threads);
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

// x and out 16-byte aligned (the wrapper checks)
int lle_rcp(const float* x, float* out, long n, int approx, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (approx)
    rcp_vec_kernel<true><<<rcp_vec_blocks<true>(n), kThreads, 0, s>>>(
        x, out, n);
  else
    rcp_vec_kernel<false><<<rcp_vec_blocks<false>(n), kThreads, 0, s>>>(
        x, out, n);
  return (int)cudaGetLastError();
}

// the first form: one element a thread
int lle_rcp_one(const float* x, float* out, long n, int approx,
                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (approx)
    rcp_kernel<true><<<blocks_for(n), kThreads, 0, s>>>(x, out, n);
  else
    rcp_kernel<false><<<blocks_for(n), kThreads, 0, s>>>(x, out, n);
  return (int)cudaGetLastError();
}

// an empty kernel at lle_rcp's launch shape for n elements
int lle_rcp_floor(long n, void* stream) {
  empty_kernel<<<rcp_vec_blocks<true>(n), kThreads, 0,
                 (cudaStream_t)stream>>>();
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
  const long n2 = n / 2;
  int blocks, threads;
  chain_bf16x2_grid(n2, &blocks, &threads);
  chain_bf16x2_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const unsigned int*)x, (float2*)out, n2, reps);
  return (int)cudaGetLastError();
}

}  // extern "C"
