// Hopper (sm_90a) kernel of the Newton-half force stencil, the force
// evaluation of grids past the whole-plane gate (engine.whole_planes_fit).
//
// newton_half_forces <- lammps_le_tpu/fast/blocked_kernel.py:90
// make_blocked_kernel (K3), whose body is the Newton-half offset loop
// pallas_step.py:249-510 make_offset_loop (K1).  The TPU kernel cuts the
// flat cell axis into lane chunks with [M | CL | M] windows only to fit
// its VMEM, folds the margin reactions in XLA, then folds the ghost faces
// z -> y -> x.  Here the same function is computed over the whole grid:
//
//   * the i side is a valid slot (a bead in an interior column) only;
//   * the self cell is seen with both pair orders at energy weight 1 and
//     no reaction; each of the 13 forward offsets d > 0 sees a pair once,
//     at weight 2, and the j slot at column (c + d) mod P takes the
//     reaction;
//   * the reactions that land on ghost columns fold onto the interior
//     cells they image, z -> y -> x (FastMaps.faces / fold_shifts).
//
// Every per-pair value is the plain version's bit for bit (-fmad=false,
// IEEE division: pair_force in common.cuh is kernels_ref._pair_terms op
// for op); only the order of the sums differs.
//
// Bound: f32 arithmetic.  At config 6 (1M beads, cap 9, P 358,144) the
// stencil examines 1M valid i slots x 9 j rows x 14 offsets = 126 M pairs
// of ~24 operations (3 GFLOP, ~45 us at 67 TFLOP/s), against ~110 MB of planes
// in and out (~33 us at 3.35 TB/s); the reaction buffers below add
// ~1 GB of traffic (~0.3 ms).
//
// Design: deterministic, with no atomics.  A Newton-half reaction is a
// scatter; with float atomics its sum order, and so the trajectory,
// would change from run to run.  Instead:
//
//   1. newton_pair_kernel: one thread per cell column p holds p's cap
//      i rows in registers (the row count is a template bound, MAXCAP >=
//      cap).  For the self cell and each forward offset it reads the cap
//      j rows of column (p + d) mod P once, accumulates its own rows'
//      forces, and sums the reaction on each j row over its i rows in
//      row order; that sum is written once to a per-offset buffer
//      R[o][:, j, p].  Tallies reduce per block (no atomics).
//   2. newton_gather_kernel: each slot (r, c) takes its own force minus
//      R[o][:, r, (c - d_o) mod P] over o in offset order.
//   3. fold_kernel, three launches (z, y, x): each a gather along the
//      axis' roll shifts, as the reference's masked rolls.
//   4. stencil_finish_kernel (common.cuh): energies, flags and clamps.
//
// The wrapper allocates the 14 (3, cap, P) work planes (own forces and
// the 13 reaction buffers; 0.54 GB at config 6), reused for the folds.

#include "common.cuh"

// per-axis ghost-fold roll shifts (lo, hi) of FastMaps.fold_shifts;
// mirrored by kernels.FoldArgs
struct FoldArgs {
  int shift[3][2];
};

namespace {

constexpr int kHalf = 14;  // the self cell + 13 forward offsets

template <int MAXCAP>
__global__ void __launch_bounds__(kThreads)
    newton_pair_kernel(const float* __restrict__ gx,
                       const int* __restrict__ bid,
                       const uint8_t* __restrict__ hn,
                       const int* __restrict__ pid,
                       const uint8_t* __restrict__ interior,
                       float* __restrict__ work, float* __restrict__ fpart,
                       int* __restrict__ ipart, StencilArgs a) {
  __shared__ float shf[32];
  __shared__ int shi[32];
  const int cap = a.cap, P = a.P, n = a.n;
  const long capP = (long)cap * P;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  PairTally tl = {0.f, 0.f, 0, 0};
  int nlink = 0;
  if (p < P) {
    float xi[MAXCAP], yi[MAXCAP], zi[MAXCAP];
    int bi[MAXCAP], u1i[MAXCAP], pi[MAXCAP];
    float fx[MAXCAP], fy[MAXCAP], fz[MAXCAP];
    unsigned int vmask = 0;  // bit i: row i is a valid i slot
    const bool col_in = interior[p] != 0;
#pragma unroll
    for (int i = 0; i < MAXCAP; ++i) {
      fx[i] = fy[i] = fz[i] = 0.f;
      if (i < cap) {
        const long t = (long)i * P + p;
        xi[i] = gx[t];
        yi[i] = gx[capP + t];
        zi[i] = gx[2 * capP + t];
        bi[i] = bid[t];
        u1i[i] = hn[t] ? bi[i] + 1 : n + 2;
        pi[i] = pid[t];
        if (col_in && bi[i] < n) {
          vmask |= 1u << i;
          nlink += hn[t] ? 1 : 0;
        }
      }
    }
    for (int o = 0; o < kHalf; ++o) {
      int cj = p + a.delta[o];  // delta in [0, P)
      if (cj >= P) cj -= P;
      const int wgt = o ? 2 : 1;
      float* R = work + (long)o * 3 * capP;
      for (int rj = 0; rj < cap; ++rj) {
        float rx = 0.f, ry = 0.f, rz = 0.f;
        if (vmask) {
          const long j = (long)rj * P + cj;
          const float xj = gx[j], yj = gx[capP + j], zj = gx[2 * capP + j];
          const int bj = bid[j];
          const int u1j = hn[j] ? bj + 1 : n + 2;
#pragma unroll
          for (int i = 0; i < MAXCAP; ++i) {
            if (!((vmask >> i) & 1u)) continue;
            const float dx = xi[i] - xj;
            const float dy = yi[i] - yj;
            const float dz = zi[i] - zj;
            const float ffac = pair_force(a, dx, dy, dz, bi[i], u1i[i],
                                          pi[i], bj, u1j, wgt, tl);
            const float cx = dx * ffac, cy = dy * ffac, cz = dz * ffac;
            fx[i] += cx;
            fy[i] += cy;
            fz[i] += cz;
            rx += cx;
            ry += cy;
            rz += cz;
          }
        }
        if (o) {  // the reaction on j row rj, seen from column p
          const long t = (long)rj * P + p;
          R[t] = rx;
          R[capP + t] = ry;
          R[2 * capP + t] = rz;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MAXCAP; ++i) {
      if (i < cap) {
        const long t = (long)i * P + p;
        work[t] = fx[i];
        work[capP + t] = fy[i];
        work[2 * capP + t] = fz[i];
      }
    }
  }
  block_tallies(tl, nlink, fpart, ipart, shf, shi);
}

// own force minus the reactions left on the slot, in offset order
__global__ void newton_gather_kernel(const float* __restrict__ work,
                                     float* __restrict__ gf, StencilArgs a) {
  const int P = a.P;
  const long capP = (long)a.cap * P;
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= capP) return;
  const int c = (int)(t % P);
  const long row = t - c;
  for (int k = 0; k < 3; ++k) {
    float v = work[k * capP + t];
    for (int o = 1; o < kHalf; ++o) {
      int cs = c - a.delta[o];
      if (cs < 0) cs += P;
      v = v - work[(3L * o + k) * capP + row + cs];
    }
    gf[k * capP + t] = v;
  }
}

// one ghost-fold axis (blocked_kernel.py:262-269):
// out[c] = in[c] * keep[c] + (in * m_lo)[c + s_lo] + (in * m_hi)[c + s_hi]
// (columns mod P), keep = 1 - m_lo - m_hi, over all 3 * cap rows
__global__ void fold_kernel(const float* __restrict__ in,
                            float* __restrict__ out,
                            const uint8_t* __restrict__ m_lo,
                            const uint8_t* __restrict__ m_hi, int s_lo,
                            int s_hi, long rows, int P) {
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= rows * P) return;
  const int c = (int)(t % P);
  const long row = t - c;
  int cl = c + s_lo, ch = c + s_hi;  // shifts in [0, P)
  if (cl >= P) cl -= P;
  if (ch >= P) ch -= P;
  const float lo_c = m_lo[c] ? 1.f : 0.f, hi_c = m_hi[c] ? 1.f : 0.f;
  const float keep = 1.f - lo_c - hi_c;
  const float lo = m_lo[cl] ? 1.f : 0.f, hi = m_hi[ch] ? 1.f : 0.f;
  out[t] = in[t] * keep + in[row + cl] * lo + in[row + ch] * hi;
}

template <int MAXCAP>
void launch_pair(const float* gx, const int* bid, const uint8_t* hn,
                 const int* pid, const uint8_t* interior, float* work,
                 float* fpart, int* ipart, const StencilArgs& a,
                 cudaStream_t s) {
  newton_pair_kernel<MAXCAP><<<blocks_for(a.P), kThreads, 0, s>>>(
      gx, bid, hn, pid, interior, work, fpart, ipart, a);
}

}  // namespace

extern "C" {

// the largest cap the pair kernel is built for
int lle_newton_max_cap() { return 32; }

int lle_newton_half_forces(const float* gx, const int* bid, const uint8_t* hn,
                           const int* pid, const uint8_t* interior,
                           const uint8_t* faces, float* work, float* gf,
                           float* fpart, int* ipart, float* en,
                           long long* out, StencilArgs a, FoldArgs f,
                           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int P = a.P;
  const long capP = (long)a.cap * P;
  if (a.cap <= 8)
    launch_pair<8>(gx, bid, hn, pid, interior, work, fpart, ipart, a, s);
  else if (a.cap <= 9)
    launch_pair<9>(gx, bid, hn, pid, interior, work, fpart, ipart, a, s);
  else if (a.cap <= 10)
    launch_pair<10>(gx, bid, hn, pid, interior, work, fpart, ipart, a, s);
  else if (a.cap <= 12)
    launch_pair<12>(gx, bid, hn, pid, interior, work, fpart, ipart, a, s);
  else if (a.cap <= 16)
    launch_pair<16>(gx, bid, hn, pid, interior, work, fpart, ipart, a, s);
  else if (a.cap <= 32)
    launch_pair<32>(gx, bid, hn, pid, interior, work, fpart, ipart, a, s);
  else
    return (int)cudaErrorInvalidValue;
  stencil_finish_kernel<<<1, kThreads, 0, s>>>(fpart, ipart, blocks_for(P),
                                               en, out);
  newton_gather_kernel<<<blocks_for(capP), kThreads, 0, s>>>(work, gf, a);
  // folds z -> y -> x: gf -> work plane 0 -> work plane 1 -> gf
  const float* src[3] = {gf, work, work + 3 * capP};
  float* dst[3] = {work, work + 3 * capP, gf};
  for (int k = 0; k < 3; ++k) {
    const int axis = 2 - k;
    fold_kernel<<<blocks_for(3 * capP), kThreads, 0, s>>>(
        src[k], dst[k], faces + (long)(2 * axis) * P,
        faces + (long)(2 * axis + 1) * P, f.shift[axis][0], f.shift[axis][1],
        3L * a.cap, P);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
