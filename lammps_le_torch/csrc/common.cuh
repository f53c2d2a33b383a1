// Shared pieces of the Hopper kernels (step.cu, blocked.cu): the stencil
// argument block, the block reductions, the one-block finishing pass of
// the stencil tallies and the per-pair stencil math.  Each .cu file is
// its own library, so the helpers have internal linkage in each.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// stencil arguments, passed by value (mirrored by kernels.StencilArgs);
// at file scope so the C entry points taking them keep external linkage.
// delta: column offsets of the stencil's offsets (27 for the full
// stencil; the self cell + 13 forward ones for the Newton-half stencil)
struct StencilArgs {
  float lj1, lj2, lj3, lj4, cutsq, offe, floorsq;
  float inv_r0sq, neg_kf, sigf_sq, wca_cutsq, wca_floorsq, f_wca, e_wca;
  float epsf, e_fene, bond_reach_sq;
  int has_bond, wca_is_lj, energy;
  int cap, P, n;
  int delta[27];
};

namespace {

constexpr int kThreads = 256;

// ---------------------------------------------------------------------
// block reductions (kThreads threads, warp shuffles + shared memory)

__device__ float block_sum(float v, float* sh) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  v = threadIdx.x < kThreads / 32 ? sh[threadIdx.x] : 0.f;
  if (warp == 0)
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;  // valid in thread 0
}

__device__ int block_sum_int(int v, int* sh) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  v = threadIdx.x < kThreads / 32 ? sh[threadIdx.x] : 0;
  if (warp == 0)
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// max of values >= 0 (every reduced quantity here is a square or a sum
// of square roots)
__device__ float block_max(float v, float* sh) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  v = threadIdx.x < kThreads / 32 ? sh[threadIdx.x] : 0.f;
  if (warp == 0)
    for (int o = 16; o > 0; o >>= 1)
      v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}

__device__ float block_bcast(float v, float* sh) {
  __syncthreads();
  if (threadIdx.x == 0) sh[0] = v;
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
  if (threadIdx.x == 0) {
    fpart[2 * blockIdx.x] = e_lj;
    fpart[2 * blockIdx.x + 1] = e_b;
    ipart[3 * blockIdx.x] = nb;
    ipart[3 * blockIdx.x + 1] = ncl;
    ipart[3 * blockIdx.x + 2] = nlink;
  }
}

// energies halved (each pair seen from both sides, engine.py:759,766);
// FLAG_BOND_REACH when fewer than two sightings per interior link,
// FLAG_FENE_CLAMP when a clamp fired (engine.py:772-783)
__global__ void stencil_finish_kernel(const float* __restrict__ fpart,
                                      const int* __restrict__ ipart,
                                      int nblocks, float* __restrict__ en,
                                      long long* __restrict__ out) {
  __shared__ float shf[32];
  __shared__ int shi[32];
  float e_lj = 0.f, e_b = 0.f;
  int nb = 0, ncl = 0, nlink = 0;
  for (int b = threadIdx.x; b < nblocks; b += blockDim.x) {
    e_lj += fpart[2 * b];
    e_b += fpart[2 * b + 1];
    nb += ipart[3 * b];
    ncl += ipart[3 * b + 1];
    nlink += ipart[3 * b + 2];
  }
  e_lj = block_sum(e_lj, shf);
  e_b = block_sum(e_b, shf);
  nb = block_sum_int(nb, shi);
  ncl = block_sum_int(ncl, shi);
  nlink = block_sum_int(nlink, shi);
  if (threadIdx.x == 0) {
    en[0] = 0.5f * e_lj;
    en[1] = 0.5f * e_b;
    const long long clamps = ncl / 2;
    const bool reach = 0.5f * (float)nb < (float)nlink - 0.5f;
    out[0] = (reach ? 64 : 0) | (clamps > 0 ? 8 : 0);
    out[1] = clamps;
  }
}

// ---------------------------------------------------------------------
// one (i, j) slot pair of the LJ + FENE + exclusion stencil, op for op
// kernels_ref._pair_terms at unit i weight (engine.py:683-756): returns
// the force factor (the force on i is d * ffac) and adds the pair's
// energies and bond tallies, times wgt, to the thread's sums

__device__ __forceinline__ float pair_force(const StencilArgs& a, float dx,
                                            float dy, float dz, int bi,
                                            int u1i, int pi, int bj, int u1j,
                                            int wgt, PairTally& t) {
  const float rsq = dx * dx + dy * dy + dz * dz;
  const bool nz_pair = rsq > 0.f;
  const bool bonded = (bj == u1i) || (bi == u1j);
  const bool in_cut = rsq < a.cutsq;
  const bool w_b_m = a.has_bond && bonded && (rsq < a.bond_reach_sq);
  const bool lj_ok = in_cut && nz_pair && !bonded && (bj != pi);
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
  const float r2 = 1.f / rsq_den;
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
    float fb = a.neg_kf / rlog;
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
