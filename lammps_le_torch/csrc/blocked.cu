// Hopper (sm_90a) kernels of the Newton-half force stencil, the force
// evaluation of grids past the whole-plane gate (engine.whole_planes_fit),
// and of the sharded stencil's windows.
//
// newton_half_forces <- lammps_le_tpu/fast/blocked_kernel.py:90
// make_blocked_kernel (K3), whose body is the Newton-half offset loop
// pallas_step.py:249-510 make_offset_loop (K1).  The TPU kernel cuts the
// flat cell axis into lane chunks with [M | CL | M] windows only to fit
// its VMEM, folds the margin reactions in XLA, then folds the ghost faces
// z -> y -> x.  Here the same function is computed over the whole grid
// (kernels_ref.newton_half_forces):
//
//   * the i side is a valid slot (a bead in an interior column) only;
//   * the self cell is seen with both pair orders at energy weight 1 and
//     no reaction; each of the 13 forward offsets d > 0 sees a pair once,
//     at weight 2, and the j slot at column (c + d) mod P takes the
//     reaction;
//   * the reactions that land on ghost columns fold onto the interior
//     cells they image, z -> y -> x (FastMaps.faces / fold_shifts).
//
// Design: one launch of the occupancy-following block (stencil.cuh), each
// occupied slot summing its own forward pairs (a valid slot) and the
// reactions of the pairs that see it from the 13 backward offsets (the
// same pairs, computed again in the same argument order), into gf, ghost
// columns included, those of ghost columns set aside in a scratch plane
// (gf gets zeros there).  Then the ghost fold: fold_code_kernel marks
// each interior column's ghost images, and fold_kernel has each interior
// slot add the reactions set aside on its images (every halo column is
// the image of one interior column, once: a fixed order, no atomics; no
// ghost slot is written twice), and stencil_finish_kernel
// (common.cuh): energies, flags and clamps.  It allocates nothing: no
// reaction planes, no gather.
//
// Replicas: R replicas' planes stacked on a leading axis run in one
// launch of each pass: the stencil's grid has a replica dimension
// (blockIdx.z, stencil.cuh), the fold one per replica (blockIdx.z) over
// the image codes, which the replicas share (one fold_code_kernel), and
// the finishing pass one block a replica.  Replica r is bitwise one
// launch on its planes.
//
// window_forces <- lammps_le_tpu/parallel/shard_step.py:55 _window_call
// (K4), whose body is the same offset loop over each slab's window
// [M | C | M] of the sharded stencil.  The same block runs over S windows
// of W = 2M + C columns laid side by side in the planes: a window is the
// period of its column rolls, (w + d) mod W, its own interior columns are
// the i side, and every occupied slot of it keeps the reactions it takes
// (no ghost fold: the caller folds the assembled planes).  A second grid
// dimension runs over the windows, so one launch covers every slab of a
// device; the tallies come out as raw sums, which the caller adds over
// devices before it halves them.
//
// Bound: f32 issue, as stencil_forces in step.cu; chip_smoke.py computes
// it from a run's planes.

#include "stencil.cuh"

// per-axis ghost-fold roll shifts (lo, hi) of FastMaps.fold_shifts;
// mirrored by kernels.FoldArgs
struct FoldArgs {
  int shift[3][2];
};

namespace {

// the Newton-half stencil over nwin periods of `period` columns: the whole
// grid (K3: the ghost columns' reactions set aside in ghost), or K4's
// windows (ghost null)
template <bool APPROX>
__global__ void __launch_bounds__(kTileThreads)
    newton_half_kernel(const float* __restrict__ gx,
                       const int* __restrict__ bid,
                       const uint8_t* __restrict__ hn,
                       const int* __restrict__ pid,
                       const uint8_t* __restrict__ colok,
                       float* __restrict__ gf, float* __restrict__ ghost,
                       float* __restrict__ fpart, int* __restrict__ ipart,
                       StencilArgs a, int period) {
  stencil_tile<kHalf, APPROX>(gx, bid, hn, pid, colok, gf, ghost, fpart,
                              ipart, a, period);
}

// K3's ghost fold (kernels_ref.ghost_fold), inverted: the ghost images of
// each interior column, coded per axis a in bits 2a (c + shift[a][0] lies
// on a's low face: the image there) and 2a + 1 (c + shift[a][1] on its
// high face); 0 for every other column.  A halo column is an image of
// exactly one interior column, once (its halo source), through the
// nonempty combinations of that column's axis images
__global__ void fold_code_kernel(const uint8_t* __restrict__ interior,
                                 const uint8_t* __restrict__ faces,
                                 FoldArgs f, int P,
                                 uint8_t* __restrict__ code) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= P) return;
  int v = 0;
  if (interior[c])
    for (int a = 0; a < 3; ++a)
      for (int s = 0; s < 2; ++s) {
        int g = c + f.shift[a][s];
        if (g >= P) g -= P;
        if (faces[(long)(2 * a + s) * P + g]) v |= 1 << (2 * a + s);
      }
  code[c] = (uint8_t)v;
}

// one thread a slot (blockIdx.y its row, blockIdx.z its replica): an
// interior slot with images adds the reactions set aside on its images
// (x outermost, then y, then z; low before high)
__global__ void fold_kernel(float* __restrict__ gf,
                            const float* __restrict__ ghost,
                            const uint8_t* __restrict__ code, FoldArgs f,
                            int cap, int P) {
  const long capP = (long)cap * P;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= P) return;
  const int v = code[c];
  if (v == 0) return;
  gf += 3 * capP * blockIdx.z;
  ghost += 3 * capP * blockIdx.z;
  const long row = (long)blockIdx.y * P, t = row + c;
  float sum[3] = {gf[t], gf[capP + t], gf[2 * capP + t]};
  for (int ix = 0; ix < 3; ++ix) {
    if (ix && !((v >> (ix - 1)) & 1)) continue;
    int cx = ix ? c + f.shift[0][ix - 1] : c;
    if (cx >= P) cx -= P;
    for (int iy = 0; iy < 3; ++iy) {
      if (iy && !((v >> (1 + iy)) & 1)) continue;
      int cy = iy ? cx + f.shift[1][iy - 1] : cx;
      if (cy >= P) cy -= P;
      for (int iz = 0; iz < 3; ++iz) {
        if (iz && !((v >> (3 + iz)) & 1)) continue;
        if ((ix | iy | iz) == 0) continue;
        int cz = iz ? cy + f.shift[2][iz - 1] : cy;
        if (cz >= P) cz -= P;
        for (int k = 0; k < 3; ++k) sum[k] += ghost[k * capP + row + cz];
      }
    }
  }
  for (int k = 0; k < 3; ++k) gf[k * capP + t] = sum[k];
}

// the raw tally sums of every block: [e_lj, e_b, bond sightings, clamp
// events, interior links]
__global__ void window_finish_kernel(const float* __restrict__ fpart,
                                     const int* __restrict__ ipart,
                                     int nblocks, float* __restrict__ out) {
  __shared__ float shf[32];
  __shared__ int shi[32];
  const StencilSums s = reduce_tallies(fpart, ipart, nblocks, shf, shi);
  if (threadIdx.x == 0) {
    out[0] = s.e_lj;
    out[1] = s.e_b;
    out[2] = (float)s.nb;
    out[3] = (float)s.ncl;
    out[4] = (float)s.nlink;
  }
}

}  // namespace

extern "C" {

// the most rows a column may hold
int lle_stencil_max_cap() { return kMaxCap; }

// blocks of the window kernel: the size of its tally partials (the
// whole-grid stencil's at nwin 1)
int lle_window_blocks(int period, int nwin) {
  return stencil_blocks(period, nwin);
}

// R replicas' planes stacked on a leading axis.  ghost: planes like gf,
// scratch for the ghost columns' reactions; code: P bytes of scratch for
// the fold's image codes; fpart / ipart: each replica's
// lle_window_blocks(P, 1) partials; en, out: 2 a replica
int lle_newton_half_forces(const float* gx, const int* bid, const uint8_t* hn,
                           const int* pid, const uint8_t* interior,
                           const uint8_t* faces, float* gf, float* ghost,
                           uint8_t* code, float* fpart, int* ipart,
                           float* en, long long* out, StencilArgs a,
                           FoldArgs f, int R, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err =
      launch_stencil<newton_half_kernel<true>, newton_half_kernel<false>>(
          a, true, stencil_grid(a.P, 1, R), s, gx, bid, hn, pid, interior,
          gf, ghost, fpart, ipart, a, a.P);
  if (err != cudaSuccess) return (int)err;
  fold_code_kernel<<<blocks_for(a.P), kThreads, 0, s>>>(interior, faces, f,
                                                         a.P, code);
  fold_kernel<<<dim3(blocks_for(a.P), a.cap, R), kThreads, 0, s>>>(
      gf, ghost, code, f, a.cap, a.P);
  // ~11,000 block partials at config 6: a full block reduces them
  stencil_finish_kernel<<<R, 1024, 0, s>>>(
      fpart, ipart, stencil_blocks(a.P, 1), en, out);
  return (int)cudaGetLastError();
}

// nwin windows of `period` columns side by side (a.P = nwin * period);
// ownint: each window's own interior columns
int lle_window_forces(const float* xw, const int* bid, const uint8_t* hn,
                      const int* pid, const uint8_t* ownint, float* f,
                      float* fpart, int* ipart, float* stats, StencilArgs a,
                      int period, int nwin, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err =
      launch_stencil<newton_half_kernel<true>, newton_half_kernel<false>>(
          a, true, stencil_grid(period, nwin), s, xw, bid, hn, pid, ownint,
          f, static_cast<float*>(nullptr), fpart, ipart, a, period);
  if (err != cudaSuccess) return (int)err;
  window_finish_kernel<<<1, kThreads, 0, s>>>(
      fpart, ipart, stencil_blocks(period, nwin), stats);
  return (int)cudaGetLastError();
}

}  // extern "C"
