// The pair stencil of the Hopper kernels K1 (stencil_forces, step.cu), K3
// (newton_half_forces), K4 (window_forces, blocked.cu) and K5
// (tiled_stencil_forces, tiled.cu): one block body whose work follows the
// cells' occupancy, in three forms (Form): K1's full stencil, the
// Newton-half one of K3 and K4, and K5's full stencil in its own pair
// formulas.
//
// <- lammps_le_tpu/fast/pallas_step.py:249 make_offset_loop (K1), the body
// of make_step_kernel (K2), make_blocked_kernel (blocked_kernel.py:90, K3),
// the sharded stencil's window call (shard_step.py:55, K4) and
// make_pallas_kernel (pallas_kernel.py:59, K5).
//
// Bound: f32 issue.  Placement packs each column's beads into its first
// rows (fast/place.py: rank -> row), so about one slot in three holds a
// bead at 100k and at config 6.  Each valid i meets ~100 occupied j slots
// (27 cells of ~3.5 beads), ~19 in 20 of them past the LJ cut: ~10 M
// slot pairs at 100k, ~100 M at config 6, against 7-70 MB of planes.
//
// Design.  A block owns kTile consecutive columns of one period (the
// whole grid, or one slab window of K4), and a thread takes the
// occupied slots of those columns (an "item"), one after another: no
// thread is given to an empty slot, and each item's loop over a j column
// ends at that column's last occupied row.  The j data of an offset
// (a, b, c) for the block's columns lie in one contiguous pencil of kSpan
// columns, shifted by a*sx + b*sy, so the block stages the nine (a, b)
// pencils in shared memory, three at a time (one a), each slot once,
// packed as a float4 (x, y, z, bead id with the has-next bit in its sign)
// beside its partner id, and the rows up to each column's last occupied
// one.  The pairs with the empty rows below it are computed as in the
// plain versions (their contributions are exactly zero), so the kernel
// is exact for any plane, packed or not: packing only makes it fast.
// A pair past the cut and not bonded adds exactly nothing (pair_acts):
// only its distance and bond test are computed.
//
// The full stencil (K1) sums, for each valid i, the 27 offsets' pairs
// d * ffac.  K5's form is the same loop with K5's pair function
// (tiled_pair in common.cuh: its own bonded test, exclusion, bond and
// WCA terms, IEEE division only) and K5's edge: a j column outside
// [0, P) is a far-away empty slot (no wrap), so it is neither read nor
// looped over.  Its i weight is the column's interior bit, as K1's.
// The Newton-half stencils (K3, K4) compute each pair
// (i, j = i + delta, delta in the self cell and the 13 forward offsets)
// on the i side, at the reference's weights (tallies, energies), and the
// j side takes its reaction by computing the same pair again, in the
// same argument order (dx = x_i - x_j: bitwise the same force), from the
// 13 backward offsets: each slot owns its whole sum, in a fixed order,
// with no reaction buffers, no float atomics and no gather.  Every
// occupied slot of a Newton-half period takes its reactions, ghost
// columns' too; K3 then folds those onto the interior cells they image
// (blocked.cu).  The pair work is the full stencil's: what the design
// buys is that no reaction leaves its block.
//
// Every per-pair value is the plain version's bit for bit in the IEEE
// form (-fmad=false, IEEE division); with the approximate reciprocal
// (StencilArgs.approx, stencil_rcp in common.cuh) the force factors
// differ from them by a few ulp.  The sums are taken in a fixed order,
// so a launch repeats itself bit for bit.  Tallies reduce per block, in
// a fixed grid sized from the period alone (not from the occupancy), as
// K2's captured graph needs.
//
// The shape (32 columns, 160 threads, three pencils at a time, one pair
// chain a thread) is the fastest of those chip_ab.py's kernels mode
// timed (PERF.md).

#pragma once

#include "common.cuh"

namespace {

constexpr int kTile = 32;         // columns a block owns: one a lane
constexpr int kTileThreads = 160;  // threads of a block
constexpr int kSpan = kTile + 2;  // columns of a staged pencil
constexpr int kGroup = 3;         // pencils staged at a time (one a)
// the index in the first group of the block's own pencil, (0, 0): the
// groups go a = 0, 1, -1, so that the own columns come first
constexpr int kOwn = 1;
constexpr int kMaxCap = 32;       // rows a column may hold
constexpr float kFar = -1.0e4f;   // coordinate of an empty slot (_FAR)

// the block body's forms: the pair function, the i side and the edge
enum Form {
  kFull,   // K1: pair_force, the 27 offsets, columns mod the period
  kHalf,   // K3, K4: pair_force, the Newton-half weights and reactions
  kTiled,  // K5: tiled_pair, the 27 offsets, no wrap past [0, P)
};

// dynamic shared memory of a block at `cap` rows; the full stencil
// stages no partners (it reads the i slot's from the plane)
inline int stencil_smem(int cap, bool half) {
  const int nst = kGroup * cap * kSpan, items = kTile * cap;
  return nst * 16 + items * 16      // staged slots, items' own slots
         + (half ? nst * 4 + items * 4 : 0)  // partners: staged, items'
         + items * 4                // item codes
         + 2 * kGroup * kSpan * 4   // rows to the last occupied one
         + 3 * items * 4            // the tile's forces
         + kGroup * kSpan;          // column masks
}

// blocks over the columns of each of nwin periods of each of R replicas
// (blockIdx.z: stencil_tile)
inline dim3 stencil_grid(int period, int nwin, int R = 1) {
  return dim3((period + kTile - 1) / kTile, nwin, R);
}

inline int stencil_blocks(int period, int nwin) {
  return ((period + kTile - 1) / kTile) * nwin;
}

// let kernel K take `bytes` of dynamic shared memory: past the default
// 48 KB (caps above 14) its limit is raised, once for the largest size
// asked (the step loop's first launch runs outside its graph's capture)
template <auto K>
cudaError_t allow_smem(int bytes) {
  static int allowed = 48 * 1024;
  if (bytes <= allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      (const void*)K, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) allowed = bytes;
  return err;
}

// launch KA (the approximate-reciprocal instance of a stencil kernel) or
// KX (the IEEE one), as a.approx asks, over `grid` with its shared memory
template <auto KA, auto KX, typename... Args>
cudaError_t launch_stencil(const StencilArgs& a, bool half, dim3 grid,
                           cudaStream_t s, Args... args) {
  if (a.cap > kMaxCap) return cudaErrorInvalidValue;
  const int smem = stencil_smem(a.cap, half);
  const cudaError_t err =
      a.approx ? allow_smem<KA>(smem) : allow_smem<KX>(smem);
  if (err != cudaSuccess) return err;
  if (a.approx)
    KA<<<grid, kTileThreads, smem, s>>>(args...);
  else
    KX<<<grid, kTileThreads, smem, s>>>(args...);
  return cudaSuccess;
}

__device__ __forceinline__ int slot_bid(float4 v) {
  return __float_as_int(v.w) & 0x7fffffff;
}

__device__ __forceinline__ int slot_u1(float4 v, int n) {
  return __float_as_int(v.w) < 0 ? slot_bid(v) + 1 : n + 2;
}

// a block's tally partials, as common.cuh block_tallies writes them, in
// one pass: each warp sums its lanes by shuffles, then thread 0 the
// warps in order (one barrier; up to 32 warps)
__device__ void tile_tallies(PairTally t, int nlink, float* fpart,
                             int* ipart) {
  __shared__ float sf[2][32];
  __shared__ int si[3][32];
  float e_lj = t.e_lj, e_b = t.e_b;
  int nb = t.nb, ncl = t.ncl;
  for (int o = 16; o > 0; o >>= 1) {
    e_lj += __shfl_down_sync(0xffffffffu, e_lj, o);
    e_b += __shfl_down_sync(0xffffffffu, e_b, o);
    nb += __shfl_down_sync(0xffffffffu, nb, o);
    ncl += __shfl_down_sync(0xffffffffu, ncl, o);
    nlink += __shfl_down_sync(0xffffffffu, nlink, o);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    sf[0][warp] = e_lj;
    sf[1][warp] = e_b;
    si[0][warp] = nb;
    si[1][warp] = ncl;
    si[2][warp] = nlink;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < (int)blockDim.x / 32; ++w) {
      e_lj += sf[0][w];
      e_b += sf[1][w];
      nb += si[0][w];
      ncl += si[1][w];
      nlink += si[2][w];
    }
    const int b = block_rank();
    fpart[2 * b] = e_lj;
    fpart[2 * b + 1] = e_b;
    ipart[3 * b] = nb;
    ipart[3 * b + 1] = ncl;
    ipart[3 * b + 2] = nlink;
  }
}

// One block of the stencil: columns [w0, w0 + kTile) of period
// blockIdx.y of replica blockIdx.z (columns base .. base + period - 1 of
// the replica's planes, the j column of offset d being (w + d) mod
// period; kTiled: w + d, empty outside [0, period)).  kHalf: the
// Newton-half stencil, whose every occupied slot is an item and keeps
// the reactions it takes, ghost columns included (else a full one, whose
// items are the i side's slots).  colok: the i side's columns (interior,
// or a window's own interior).  gf gets every slot of the block's columns,
// but with ghost non-null a column off the i side's gets zeros in gf and
// its reactions in ghost (K3, whose fold then reads them there); fpart /
// ipart the block's tallies (tile_tallies).
template <Form F, bool APPROX>
__device__ __forceinline__ void stencil_tile(
    const float* __restrict__ gx, const int* __restrict__ bid,
    const uint8_t* __restrict__ hn, const int* __restrict__ pid,
    const uint8_t* __restrict__ colok, float* __restrict__ gf,
    float* __restrict__ ghost, float* __restrict__ fpart,
    int* __restrict__ ipart, const StencilArgs& a, int period) {
  constexpr bool HALF = F == kHalf;
  extern __shared__ float4 sh4[];
  __shared__ int s_total;
  __shared__ unsigned int s_own;  // bit t: column w0 + t is on the i side
  const int cap = a.cap, P = a.P, n = a.n;
  const long capP = (long)cap * P;
  // replica blockIdx.z: its planes, forces and tally partials lie at its
  // stride; the argument block and colok are shared
  const long rz = blockIdx.z, nblk = (long)gridDim.x * gridDim.y;
  gx += rz * 3 * capP;
  bid += rz * capP;
  hn += rz * capP;
  pid += rz * capP;
  gf += rz * 3 * capP;
  if (ghost != nullptr) ghost += rz * 3 * capP;
  fpart += rz * 2 * nblk;
  ipart += rz * 3 * nblk;
  const int base = blockIdx.y * period, w0 = blockIdx.x * kTile;
  const int nst = kGroup * cap * kSpan, items = kTile * cap;
  // the layout stencil_smem sizes: staged slots [kGroup][cap][kSpan],
  // items' own slots [items], staged partners [kGroup][cap][kSpan] and
  // items' partners [items] (Newton-half only), item codes [items], row
  // counts [2][kGroup][kSpan], the tile's forces [3][cap][kTile], column
  // masks [kGroup][kSpan]
  float4* spos = sh4;
  float4* sself = spos + nst;
  int* spid = reinterpret_cast<int*>(sself + items);
  int* sipid = spid + (HALF ? nst : 0);
  int* sitem = sipid + (HALF ? items : 0);
  int* scnt = sitem + items;
  float* sout = reinterpret_cast<float*>(scnt + 2 * kGroup * kSpan);
  uint8_t* sok = reinterpret_cast<uint8_t*>(sout + 3 * items);

  for (int i = threadIdx.x; i < 3 * items; i += blockDim.x) sout[i] = 0.f;
  for (int i = threadIdx.x; i < 2 * kGroup * kSpan; i += blockDim.x)
    scnt[i] = 0;
  PairTally tl = {0.f, 0.f, 0, 0};
  int nlink = 0;
  __syncthreads();

  // pencil p = 3 (a + 1) + (b + 1); group gi stages pencils p0 .. p0 + 2,
  // p0 = 3, 6, 0.  The row counts alternate between two buffers: the
  // second group's staging zeroes the first's, for the third
  for (int gi = 0; gi < 3; ++gi) {
    const int p0 = ((gi + 1) % 3) * 3;
    int* cnt = scnt + (gi & 1) * kGroup * kSpan;
    if (gi) __syncthreads();  // the previous group's pairs are done
    if (gi == 1)
      for (int i = threadIdx.x; i < kGroup * kSpan; i += blockDim.x)
        scnt[i] = 0;
#pragma unroll 4
    for (int it = threadIdx.x; it < nst; it += blockDim.x) {
      const int k = it % kSpan, jr = it / kSpan;
      const int j = jr / cap, r = jr - j * cap;
      int w = w0 + a.delta[3 * (p0 + j) + 1] - 1 + k;
      if (F == kTiled && (w < 0 || w >= period)) {
        // K5's edge: a far-away empty slot, no j rows, not on the i side
        spos[it] = make_float4(kFar, kFar, kFar, __int_as_float(n));
        if (r == 0) sok[j * kSpan + k] = 0;
        continue;
      }
      w %= period;
      if (w < 0) w += period;
      const long t = (long)r * P + base + w;
      const int b = bid[t];
      spos[it] = make_float4(
          gx[t], gx[capP + t], gx[2 * capP + t],
          __int_as_float(hn[t] ? (b | (int)0x80000000) : b));
      if (HALF) spid[it] = pid[t];
      if (b < n) atomicMax(cnt + j * kSpan + k, r + 1);
      if (r == 0) sok[j * kSpan + k] = colok[base + w];
    }
    __syncthreads();
    if (gi == 0 && threadIdx.x < 32) {
      // the items: the occupied slots of the block's columns that take
      // part (the i side's columns; every column of the Newton-half
      // stencil), in column order; the own columns are pencil kOwn's,
      // k = t + 1
      const int t = threadIdx.x, kc = kOwn * kSpan + t + 1, w = w0 + t;
      const bool own = w < period && sok[kc];
      const bool on = w < period && (own || HALF);
      unsigned int rows = 0;
      if (on)
        for (int r = 0; r < cnt[kc]; ++r)
          if (slot_bid(spos[(kOwn * cap + r) * kSpan + t + 1]) < n)
            rows |= 1u << r;
      const int m = __popc(rows);
      int pre = m;
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, pre, o);
        if (t >= o) pre += v;
      }
      int idx = pre - m;
      for (unsigned int rr = rows; rr; rr &= rr - 1) {
        const int r = __ffs(rr) - 1, s = (kOwn * cap + r) * kSpan + t + 1;
        sitem[idx] = ((own ? 1 : 0) << 16) | (t << 8) | r;
        sself[idx] = spos[s];
        if (HALF) sipid[idx] = spid[s];
        if (own && __float_as_int(spos[s].w) < 0) ++nlink;
        ++idx;
      }
      const unsigned int owns = __ballot_sync(0xffffffffu, own);
      if (t == 31) {
        s_total = pre;
        s_own = owns;
      }
    }
    if (gi == 0) __syncthreads();
    const int total = s_total;
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int code = sitem[i], t = (code >> 8) & 0xff, r = code & 0xff;
      const bool own = (code >> 16) & 1;
      const float4 me = sself[i];
      const int bs = slot_bid(me), u1s = slot_u1(me, n);
      // a j slot is bonded to me either way (bj == u1i || bi == u1j) when
      // its bead is u1s, or when its packed id is bs - 1 with the link bit
      const int pred = (bs - 1) | (int)0x80000000;
      const int ps = HALF ? sipid[i] : pid[(long)r * P + base + w0 + t];
      float fx = 0.f, fy = 0.f, fz = 0.f;
      for (int jd = 0; jd < 9; ++jd) {
        // offset k = (a + 1) * 9 + (b + 1) * 3 + (c + 1) of _OFFSETS;
        // Newton-half: k > 13 forward (weight 2), 13 the self cell
        // (weight 1), k < 13 backward: the reaction of the pair that the
        // slot at -d sees forward (weight 0: tallied there)
        const int k = 3 * p0 + jd, j = jd / 3, jc = t + jd - 3 * j;
        const bool pull = HALF && k < 13;
        const int nj = (pull ? sok[j * kSpan + jc] != 0 : own)
                           ? cnt[j * kSpan + jc] : 0;
        const int wgt = pull ? 0 : (HALF && k != 13 ? 2 : 1);
        const int psx = pull ? -2 : ps;
        const int jb = j * cap * kSpan + jc;
        for (int rj = 0; rj < nj; ++rj) {
          const int s = jb + rj * kSpan;
          const float4 q = spos[s];
          // the pair is (me, q) pushed, (q, me) pulled: the same rsq and
          // force factor either way, and the force on me is d * ffac
          const float dx = me.x - q.x, dy = me.y - q.y, dz = me.z - q.z;
          const float rsq = dx * dx + dy * dy + dz * dz;
          const int wq = __float_as_int(q.w), bq = wq & 0x7fffffff;
          const bool bonded = (bq == u1s) || (wq == pred);
          if (!pair_acts(a, rsq, bonded)) continue;
          float ffac;
          if (F == kTiled) {
            ffac = tiled_pair(a, rsq, bonded, bq == ps, tl);
          } else {
            const int pq = pull ? spid[s] : -2;
            const bool excl = (bq == psx) || (bs == pq);
            ffac = pair_force<APPROX>(a, rsq, bonded, excl, wgt, tl);
          }
          fx += dx * ffac;
          fy += dy * ffac;
          fz += dz * ffac;
        }
      }
      const int o = r * kTile + t;
      sout[o] += fx;
      sout[items + o] += fy;
      sout[2 * items + o] += fz;
    }
  }
  __syncthreads();
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int r = it / kTile, t = it - r * kTile;
    if (w0 + t < period) {
      const long o = (long)r * P + base + w0 + t;
      const bool aside = ghost != nullptr && !((s_own >> t) & 1u);
      for (int k = 0; k < 3; ++k) {
        gf[k * capP + o] = aside ? 0.f : sout[k * items + it];
        if (aside) ghost[k * capP + o] = sout[k * items + it];
      }
    }
  }
  tile_tallies(tl, nlink, fpart, ipart);
}

}  // namespace
