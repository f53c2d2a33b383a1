// Hopper (sm_90a) kernel of the tiled full stencil.
//
// tiled_stencil_forces <- lammps_le_tpu/fast/pallas_kernel.py:59
// make_pallas_kernel (K5): the full 27-offset LJ + FENE + exclusion
// stencil in K5's own formulas (kernels_ref.tiled_stencil_forces): the
// bonded test on the has-next bits, exclusion = bonded or partner, a bond
// only at rsq > 0, the bond's WCA as its own term at rsq floored to the
// WCA floor, the FENE log of 1 - rsq / r0^2 by division.  Every per-pair
// value is the plain version's bit for bit (-fmad=false, IEEE division);
// the order of the sums differs.
//
// On the TPU, XLA writes 27 pre-shifted copies of the planes to HBM for
// K5, because Mosaic cannot slice a lane axis at an unaligned offset.
// Here a block owns kTile consecutive columns; for each offset d the j
// columns of those columns are one contiguous range [c0 + d, c0 + d +
// kTile), which the block stages in shared memory from the unshifted
// planes, one slot a thread, coalesced along the columns (a column
// outside [0, P) stages a far-away empty slot: no wrap, as K5's pads).
// Thread (x, y) is the i slot of row y in column c0 + x; it reads the
// cap staged j rows of its column, so a warp (one row, 32 columns) reads
// 32 consecutive words, without bank conflicts.  It keeps one force sum
// per j row in registers, summed over the 27 offsets, and sums them over
// the j rows at the end, in K5's order.  A slot with no bead in an
// interior column contributes nothing (its pairs are all zero-weighted,
// as stencil_kernel in step.cu) and is skipped.  Tallies reduce per
// block and then in common.cuh's one-block finishing pass: no atomics.
//
// Bound: f32 operations, as stencil_kernel's in step.cu: the same pairs
// (chip_smoke.py computes the bound from a run's planes).  The staging
// cuts each j slot's reads from cap (one per i row of its column, through
// L1) to one; what it costs is two block-wide barriers per offset.

#include "common.cuh"

namespace {

constexpr int kTile = 32;  // columns of a block: one warp per i row
constexpr float kFar = -1.0e4f;  // coordinate of an empty slot (_FAR)

// one (i, j) slot pair in K5's formulas (pallas_kernel.py:124-175) at
// unit i weight: returns the force factor and adds the pair's energies
// and bond tallies to the thread's sums
__device__ __forceinline__ float tiled_pair(const StencilArgs& a, float dx,
                                            float dy, float dz, int bi,
                                            bool hi, int pi, int bj, bool hj,
                                            PairTally& t) {
  const float rsq = dx * dx + dy * dy + dz * dz;
  const bool nz_pair = rsq > 0.f;
  const bool bonded = (bj == bi + 1 && hi) || (bi == bj + 1 && hj);
  const bool in_cut = rsq < a.cutsq;
  float ffac = 0.f;
  if (in_cut && nz_pair && !(bonded || bj == pi)) {
    const float r2 = 1.f / fmaxf(rsq, a.floorsq);
    const float r6 = r2 * r2 * r2;
    ffac = r6 * (a.lj1 * r6 - a.lj2) * r2;
    if (a.energy) t.e_lj += r6 * (a.lj3 * r6 - a.lj4) - a.offe;
  }
  if (a.has_bond && bonded && nz_pair && rsq < a.bond_reach_sq) {
    float rlog = 1.f - rsq / a.r0sq;
    if (rlog < 0.1f) {
      t.ncl += 1;
      rlog = 0.1f;
    }
    float fb = a.neg_kf / rlog;
    const float rsq_w = fmaxf(rsq, a.wca_floorsq);
    const float sr2 = a.sigf_sq / rsq_w;
    const float sr6 = sr2 * sr2 * sr2;
    const bool wca = rsq < a.wca_cutsq;
    fb = fb + (wca ? a.f_wca * sr6 * (sr6 - 0.5f) / rsq_w : 0.f);
    ffac = ffac + fb;
    t.nb += 1;
    if (a.energy)
      t.e_b += a.e_fene * logf(rlog) +
               (wca ? a.e_wca * sr6 * (sr6 - 1.f) + a.epsf : 0.f);
  }
  return ffac;
}

// blockDim (kTile, cap); block b owns columns [b * kTile, b * kTile + kTile)
template <int MAXCAP>
__global__ void __launch_bounds__(kTile* MAXCAP)
    tiled_stencil_kernel(const float* __restrict__ gx,
                         const int* __restrict__ bid,
                         const uint8_t* __restrict__ hn,
                         const int* __restrict__ pid,
                         const uint8_t* __restrict__ interior,
                         float* __restrict__ gf, float* __restrict__ fpart,
                         int* __restrict__ ipart, StencilArgs a) {
  __shared__ float sx[MAXCAP][kTile], sy[MAXCAP][kTile], sz[MAXCAP][kTile];
  __shared__ int sb[MAXCAP][kTile];
  __shared__ uint8_t sh[MAXCAP][kTile];
  __shared__ float shf[32];
  __shared__ int shi[32];
  const int cap = a.cap, P = a.P, n = a.n;
  const long capP = (long)cap * P;
  const int x = threadIdx.x, r = threadIdx.y;
  const int c = blockIdx.x * kTile + x;
  const long t = (long)r * P + c;
  PairTally tl = {0.f, 0.f, 0, 0};
  int nlink = 0;
  bool valid = false, hi = false;
  float xi = 0.f, yi = 0.f, zi = 0.f;
  int bi = n, pi = -1;
  if (c < P) {
    bi = bid[t];
    valid = interior[c] && bi < n;
    if (valid) {
      xi = gx[t];
      yi = gx[capP + t];
      zi = gx[2 * capP + t];
      hi = hn[t] != 0;
      pi = pid[t];
      nlink = hi ? 1 : 0;
    }
  }
  float fx[MAXCAP], fy[MAXCAP], fz[MAXCAP];
#pragma unroll
  for (int j = 0; j < MAXCAP; ++j) fx[j] = fy[j] = fz[j] = 0.f;
  for (int o = 0; o < 27; ++o) {
    const int cj = c + a.delta[o];
    __syncthreads();  // the last offset's rows are read
    if (cj >= 0 && cj < P) {
      const long j = (long)r * P + cj;
      sx[r][x] = gx[j];
      sy[r][x] = gx[capP + j];
      sz[r][x] = gx[2 * capP + j];
      sb[r][x] = bid[j];
      sh[r][x] = hn[j];
    } else {
      sx[r][x] = sy[r][x] = sz[r][x] = kFar;
      sb[r][x] = n;
      sh[r][x] = 0;
    }
    __syncthreads();
    if (!valid) continue;
#pragma unroll
    for (int j = 0; j < MAXCAP; ++j) {
      if (j < cap) {
        const float dx = xi - sx[j][x];
        const float dy = yi - sy[j][x];
        const float dz = zi - sz[j][x];
        const float ffac = tiled_pair(a, dx, dy, dz, bi, hi, pi, sb[j][x],
                                      sh[j][x] != 0, tl);
        fx[j] += dx * ffac;
        fy[j] += dy * ffac;
        fz[j] += dz * ffac;
      }
    }
  }
  if (c < P) {
    float ox = 0.f, oy = 0.f, oz = 0.f;
#pragma unroll
    for (int j = 0; j < MAXCAP; ++j) {
      if (j < cap) {
        ox += fx[j];
        oy += fy[j];
        oz += fz[j];
      }
    }
    gf[t] = ox;
    gf[capP + t] = oy;
    gf[2 * capP + t] = oz;
  }
  block_tallies(tl, nlink, fpart, ipart, shf, shi);
}

template <int MAXCAP>
void launch_tiled(const float* gx, const int* bid, const uint8_t* hn,
                  const int* pid, const uint8_t* interior, float* gf,
                  float* fpart, int* ipart, const StencilArgs& a,
                  cudaStream_t s) {
  tiled_stencil_kernel<MAXCAP>
      <<<(a.P + kTile - 1) / kTile, dim3(kTile, a.cap), 0, s>>>(
          gx, bid, hn, pid, interior, gf, fpart, ipart, a);
}

}  // namespace

extern "C" {

// the largest cap the kernel is built for
int lle_tiled_max_cap() { return 16; }

// blocks of a launch over P columns: the size of its partials
int lle_tiled_blocks(int P) { return (P + kTile - 1) / kTile; }

int lle_tiled_stencil_forces(const float* gx, const int* bid,
                             const uint8_t* hn, const int* pid,
                             const uint8_t* interior, float* gf,
                             float* fpart, int* ipart, float* en,
                             long long* out, StencilArgs a, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (a.cap <= 8)
    launch_tiled<8>(gx, bid, hn, pid, interior, gf, fpart, ipart, a, s);
  else if (a.cap <= 9)
    launch_tiled<9>(gx, bid, hn, pid, interior, gf, fpart, ipart, a, s);
  else if (a.cap <= 12)
    launch_tiled<12>(gx, bid, hn, pid, interior, gf, fpart, ipart, a, s);
  else if (a.cap <= 16)
    launch_tiled<16>(gx, bid, hn, pid, interior, gf, fpart, ipart, a, s);
  else
    return (int)cudaErrorInvalidValue;
  stencil_finish_kernel<<<1, kThreads, 0, s>>>(fpart, ipart,
                                               lle_tiled_blocks(a.P), en, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
