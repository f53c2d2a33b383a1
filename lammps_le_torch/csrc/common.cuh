// Shared pieces of the Hopper kernels (step.cu, blocked.cu, tiled.cu): the
// stencil argument block, the block reductions, the one-block finishing
// pass of the stencil tallies and the per-pair stencil math.  Each .cu
// file is its own library, so the helpers have internal linkage in each.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// stencil arguments, passed by value (mirrored by kernels.StencilArgs);
// at file scope so the C entry points taking them keep external linkage.
// delta: column offsets of the 27 stencil offsets in _OFFSETS order
// (lammps_le_torch/ops/grid.py); P: the planes' row stride (all windows'
// columns for the window kernel)
struct StencilArgs {
  float lj1, lj2, lj3, lj4, cutsq, offe, floorsq;
  float inv_r0sq, neg_kf, sigf_sq, wca_cutsq, wca_floorsq, f_wca, e_wca;
  float epsf, e_fene, bond_reach_sq, r0sq;
  int has_bond, wca_is_lj, energy;
  int cap, P, n;
  int approx;  // the pair kernels' reciprocal: approximate (1) or IEEE
  int delta[27];
};

namespace {

constexpr int kThreads = 256;

// ---------------------------------------------------------------------
// block reductions (warp shuffles + shared memory) over a block of whole
// warps, up to 1024 threads, in one or two dimensions; the result is
// valid in thread 0

__device__ __forceinline__ int thread_rank() {
  return threadIdx.y * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ int block_rank() {
  return blockIdx.y * gridDim.x + blockIdx.x;
}

__device__ float block_sum(float v, float* sh) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int t = thread_rank(), lane = t & 31, warp = t >> 5;
  __syncthreads();
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  v = t < (int)(blockDim.x * blockDim.y) / 32 ? sh[t] : 0.f;
  if (warp == 0)
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ int block_sum_int(int v, int* sh) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int t = thread_rank(), lane = t & 31, warp = t >> 5;
  __syncthreads();
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  v = t < (int)(blockDim.x * blockDim.y) / 32 ? sh[t] : 0;
  if (warp == 0)
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// max of values >= 0 (every reduced quantity here is a square or a sum
// of square roots)
__device__ float block_max(float v, float* sh) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, o));
  const int t = thread_rank(), lane = t & 31, warp = t >> 5;
  __syncthreads();
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  v = t < (int)(blockDim.x * blockDim.y) / 32 ? sh[t] : 0.f;
  if (warp == 0)
    for (int o = 16; o > 0; o >>= 1)
      v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}

__device__ float block_bcast(float v, float* sh) {
  __syncthreads();
  if (thread_rank() == 0) sh[0] = v;
  __syncthreads();
  return sh[0];
}

// a thread's stencil tallies: weighted energies, bond sightings, clamps
struct PairTally {
  float e_lj, e_b;
  int nb, ncl;
};

// a block's tally partials, for stencil_finish_kernel
__device__ void block_tallies(PairTally t, int nlink, float* fpart,
                              int* ipart, float* shf, int* shi) {
  const float e_lj = block_sum(t.e_lj, shf);
  const float e_b = block_sum(t.e_b, shf);
  const int nb = block_sum_int(t.nb, shi);
  const int ncl = block_sum_int(t.ncl, shi);
  nlink = block_sum_int(nlink, shi);
  if (thread_rank() == 0) {
    const int b = block_rank();
    fpart[2 * b] = e_lj;
    fpart[2 * b + 1] = e_b;
    ipart[3 * b] = nb;
    ipart[3 * b + 1] = ncl;
    ipart[3 * b + 2] = nlink;
  }
}

// the block partials of a stencil launch reduced in a fixed order, in a
// one-block pass; the sums are valid in thread 0.  Each pair is seen from
// both sides: energies and clamps count twice
struct StencilSums {
  float e_lj, e_b;
  int nb, ncl, nlink;
};

__device__ StencilSums reduce_tallies(const float* __restrict__ fpart,
                                      const int* __restrict__ ipart,
                                      int nblocks, float* shf, int* shi) {
  StencilSums s = {0.f, 0.f, 0, 0, 0};
  for (int b = threadIdx.x; b < nblocks; b += blockDim.x) {
    s.e_lj += fpart[2 * b];
    s.e_b += fpart[2 * b + 1];
    s.nb += ipart[3 * b];
    s.ncl += ipart[3 * b + 1];
    s.nlink += ipart[3 * b + 2];
  }
  s.e_lj = block_sum(s.e_lj, shf);
  s.e_b = block_sum(s.e_b, shf);
  s.nb = block_sum_int(s.nb, shi);
  s.ncl = block_sum_int(s.ncl, shi);
  s.nlink = block_sum_int(s.nlink, shi);
  return s;
}

// FLAG_BOND_REACH: fewer than two sightings per interior link
// (engine.py:772-783)
__device__ __forceinline__ bool reach_bad(const StencilSums& s) {
  return 0.5f * (float)s.nb < (float)s.nlink - 0.5f;
}

// energies halved (engine.py:759,766); FLAG_BOND_REACH, and
// FLAG_FENE_CLAMP when a clamp fired
__global__ void stencil_finish_kernel(const float* __restrict__ fpart,
                                      const int* __restrict__ ipart,
                                      int nblocks, float* __restrict__ en,
                                      long long* __restrict__ out) {
  __shared__ float shf[32];
  __shared__ int shi[32];
  const StencilSums s = reduce_tallies(fpart, ipart, nblocks, shf, shi);
  if (threadIdx.x == 0) {
    en[0] = 0.5f * s.e_lj;
    en[1] = 0.5f * s.e_b;
    const long long clamps = s.ncl / 2;
    out[0] = (reach_bad(s) ? 64 : 0) | (clamps > 0 ? 8 : 0);
    out[1] = clamps;
  }
}

// ---------------------------------------------------------------------
// the reciprocal of the stencils' pair math (K1's _rcp,
// lammps_le_tpu/fast/pallas_step.py:283-289): with APPROX the
// approximate reciprocal (rcp.approx.ftz.f32, one MUFU.RCP) refined by one
// Newton step r * (2 - x * r), as the reference does on hardware
// (APPROX_RCP, pallas_step.py:128); without it IEEE division, bitwise the
// plain versions'.  Every argument is >= the floors or 0.1, never
// denormal, so the flush to zero changes nothing.

template <bool APPROX>
__device__ __forceinline__ float stencil_rcp(float x) {
  if (!APPROX) return 1.f / x;
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r * (2.f - x * r);
}

// one (i, j) slot pair of the LJ + FENE + exclusion stencil, op for op
// kernels_ref._pair_terms at unit i weight (engine.py:683-756) but for
// the reciprocal (stencil_rcp): returns the force factor (the force on i
// is (x_i - x_j) * ffac) and adds the pair's energies and bond tallies,
// times wgt, to the thread's sums.  rsq is |x_i - x_j|^2; bonded: j is
// i's chain neighbour either way (bj == u1i || bi == u1j); excl: j is
// i's extruder partner (bj == pi).  Every mask (cut, bond reach, WCA,
// the FENE clamp) is decided before a reciprocal.

// whether a pair can have a force or a tally: within the cut, or bonded.
// pair_force of any other pair returns 0 and adds nothing, so a caller
// may skip it (about 19 in 20 of a stencil's pairs lie past the cut)
__device__ __forceinline__ bool pair_acts(const StencilArgs& a, float rsq,
                                         bool bonded) {
  return rsq < a.cutsq || bonded;
}

template <bool APPROX>
__device__ __forceinline__ float pair_force(const StencilArgs& a, float rsq,
                                            bool bonded, bool excl,
                                            int wgt, PairTally& t) {
  const bool nz_pair = rsq > 0.f;
  const bool in_cut = rsq < a.cutsq;
  const bool w_b_m = a.has_bond && bonded && (rsq < a.bond_reach_sq);
  const bool lj_ok = in_cut && nz_pair && !bonded && !excl;
  float rsq_den;
  bool w12;
  if (a.wca_is_lj) {
    w12 = lj_ok || (w_b_m && (rsq < a.wca_cutsq));
    rsq_den = fmaxf(w12 ? rsq : 1.f, a.floorsq);
  } else {
    w12 = lj_ok;
    rsq_den = (bonded && nz_pair)
                  ? fmaxf(rsq, a.wca_floorsq)
                  : fmaxf((in_cut && nz_pair) ? rsq : 1.f, a.floorsq);
  }
  const float r2 = stencil_rcp<APPROX>(rsq_den);
  const float r6 = r2 * r2 * r2;
  float ffac = w12 ? r6 * (a.lj1 * r6 - a.lj2) * r2 : 0.f;
  if (a.energy && lj_ok)
    t.e_lj += (float)wgt * (r6 * (a.lj3 * r6 - a.lj4) - a.offe);
  if (w_b_m) {
    float rlog = 1.f - rsq * a.inv_r0sq;
    if (rlog < 0.1f) {
      t.ncl += wgt;
      rlog = 0.1f;
    }
    float fb = APPROX ? a.neg_kf * stencil_rcp<true>(rlog) : a.neg_kf / rlog;
    const float sr2 = a.sigf_sq * r2;
    const float sr6 = sr2 * sr2 * sr2;
    const bool wca = rsq < a.wca_cutsq;
    if (!a.wca_is_lj && wca) fb = fb + a.f_wca * sr6 * (sr6 - 0.5f) * r2;
    ffac = ffac + fb;
    t.nb += wgt;
    if (a.energy)
      t.e_b += (float)wgt *
               (a.e_fene * logf(rlog) +
                (wca ? a.e_wca * sr6 * (sr6 - 1.f) + a.epsf : 0.f));
  }
  return ffac;
}

int blocks_for(long work) { return (int)((work + kThreads - 1) / kThreads); }

}  // namespace
