// Hopper (sm_90a) kernel of the tiled full stencil.
//
// tiled_stencil_forces <- lammps_le_tpu/fast/pallas_kernel.py:59
// make_pallas_kernel (K5): the full 27-offset LJ + FENE + exclusion
// stencil in K5's own formulas (kernels_ref.tiled_stencil_forces,
// tiled_pair in common.cuh): the bonded test on the has-next bits,
// exclusion = bonded or partner, a bond only at rsq > 0, the bond's WCA
// as its own term at rsq floored to the WCA floor, the FENE log of 1 -
// rsq / r0^2 by division, IEEE division throughout.  Every per-pair value
// is the plain version's bit for bit (-fmad=false); the order of the sums
// differs.
//
// On the TPU, XLA writes 27 pre-shifted copies of the planes to HBM for
// K5, because Mosaic cannot slice a lane axis at an unaligned offset.
// Here K5 runs on the occupancy-following block body of K1, K3 and K4
// (stencil.cuh, form kTiled): a block owns 32 columns, a thread takes
// their occupied interior slots, the nine (dx, dy) pencils are staged in
// shared memory three at a time from the unshifted planes, each j loop
// ends at its column's last occupied row, and pairs past the cut that
// are not bonded are skipped (they add exactly nothing in K5's formulas).
// A j column outside [0, P) is a far-away empty slot, as K5's pads: it is
// not read and holds no rows.  Tallies reduce per block and then in
// common.cuh's one-block finishing pass: no atomics on floats, so a
// launch repeats itself bit for bit.
//
// Bound: device-memory bytes, as stencil_kernel's in step.cu: the same
// planes and pairs (chip_smoke.py computes the bound from a run's
// planes).

#include "stencil.cuh"

namespace {

__global__ void __launch_bounds__(kTileThreads)
    tiled_kernel(const float* __restrict__ gx, const int* __restrict__ bid,
                 const uint8_t* __restrict__ hn, const int* __restrict__ pid,
                 const uint8_t* __restrict__ interior,
                 float* __restrict__ gf, float* __restrict__ fpart,
                 int* __restrict__ ipart, StencilArgs a) {
  stencil_tile<kTiled, false>(gx, bid, hn, pid, interior, gf, nullptr,
                              fpart, ipart, a, a.P);
}

}  // namespace

extern "C" {

// the most rows a column may hold (the block body's)
int lle_tiled_max_cap() { return kMaxCap; }

// blocks of a launch over P columns: the size of its partials
int lle_tiled_blocks(int P) { return stencil_blocks(P, 1); }

// K5 divides exactly whatever a.approx says: one instance serves both
int lle_tiled_stencil_forces(const float* gx, const int* bid,
                             const uint8_t* hn, const int* pid,
                             const uint8_t* interior, float* gf,
                             float* fpart, int* ipart, float* en,
                             long long* out, StencilArgs a, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err = launch_stencil<tiled_kernel, tiled_kernel>(
      a, false, stencil_grid(a.P, 1), s, gx, bid, hn, pid, interior, gf,
      fpart, ipart, a);
  if (err != cudaSuccess) return (int)err;
  stencil_finish_kernel<<<1, kThreads, 0, s>>>(
      fpart, ipart, stencil_blocks(a.P, 1), en, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
