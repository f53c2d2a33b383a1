// Hopper (sm_90a) kernels of the grid-resident LE step.
//
// They replace the fused multi-step Pallas kernel of the TPU engine,
// lammps_le_tpu/fast/pallas_step.py:make_step_kernel (its phases K2a-K2e)
// and the stencil body it shares, make_offset_loop (K1).  The state is
// the reference's: (3, cap, P) f32 coordinate planes over the flat
// halo-padded cell axis P (columns fastest), (cap, P) int32 bead-id and
// partner planes, (cap, P) uint8 has-next-link plane, (P,) uint8
// interior-column mask.  Every kernel takes PyTorch's current stream,
// allocates nothing, and each C entry point returns cudaGetLastError().
//
// Arithmetic follows the plain PyTorch versions in
// lammps_le_torch/fast/kernels_ref.py op for op: the file is built with
// -fmad=false and IEEE division/sqrt, so every per-slot and per-pair value
// is bitwise the plain one and only the order of the force and energy
// sums differs; but for the stencil's reciprocal, approximate by default
// as on the reference's hardware (stencil_rcp in common.cuh; IEEE with
// StencilArgs.approx 0).  Minimum image uses rintf (round half to even,
// as jnp.round / torch.round).
//
// K2's step loop (pallas_step.py:1002-1022) is the kernels' launch-
// controlled form: each takes a LaunchCtl in device memory, whose
// steps_done is its step index s inside the launch (only the step's last
// kernel advances it), and returns at once when the launch stopped (the
// reactive skin trigger fired) or s >= limit.  The host writes a
// launch's controls with launch_begin_kernel, launches one CUDA graph
// whose WHILE conditional node runs one controlled step an iteration
// (StepGraph: the reference's while_loop, whose condition is (s < limit)
// & (stopped == 0)), and reads the control block once.  The finishing
// passes (the stencil's fold kernel, the Langevin pass's last block)
// fold each step's flags, clamps and trigger into the block in a fixed
// order, with no float atomics, and the Langevin pass's last block sets
// the loop's condition.  A null LaunchCtl is the one-step chain: the
// arguments' own key, counter base and gamma2.
//
// Replicas: the chain's kernels (kick_drift_halo, the stencil, the
// springs, the Langevin pass) take R replicas' planes stacked on a
// leading axis, in one launch each.  A grid dimension runs over the
// replicas (blockIdx.y; the stencil's blockIdx.z), each replica's planes,
// partials, ticket words and outputs lie at its stride, and every
// constant (the argument blocks, interior, halo maps) is shared but the
// Langevin key, read per replica.  A replica's blocks do exactly what one
// unbatched launch's blocks do on its planes, and each finishing pass
// reduces its replica's partials in the same fixed order: replica r of a
// launch is bitwise one launch on its planes.  The step loop is one
// replica (R = 1).

#include <cstddef>
#include <vector>

#include "stencil.cuh"

#if CUDART_VERSION < 12030
// conditional graph nodes and cudaStreamBeginCaptureToGraph (K2's loop)
#error "step.cu needs CUDA 12.3 or later"
#endif

// kernel arguments, passed by value (mirrored by the ctypes Structures of
// lammps_le_torch/fast/kernels.py); at file scope so the C entry points
// taking them keep external linkage.  StencilArgs is in common.cuh.

struct SpringArgs {
  float box[3];
  float r0, neg_2k, k, r0sq, neg_k, sig_sq, wca_floorsq, wca_cutsq;
  float f_wca, e_wca, eps, e_fene;
  int harmonic, E, cap, P;
};

struct LangevinArgs {
  unsigned int k0, k1, base;  // run key words, sstep * 4 (mod 2^32)
  float gamma1, gamma2, kick, dt, bad_cut, trig_cut;
  int langevin, cap, P, n;
  int group;    // a (cap, P) 0/1 group plane weighs the Langevin force
  int zero;     // the random force's group mean is subtracted first
  float inv_n;  // 1/n in f32: zero's count without a group
  // the chain's replicas' key words, (R, 2), in place of k0, k1; null:
  // k0, k1 (one replica, and the step loop)
  const unsigned int* keys;
};

// a multi-step launch's controls and results (K2's scalar SMEM inputs and
// its stats rows, pallas_step.py:1012-1022).  stats: [e_lj, e_b (energy
// launches: the last step's unhalved sums), reach_bad, 2 * clamps (each
// step's clamp events halved as the chain counts them, times 2: the
// reference's unhalved convention), n_links, skin_bad, trig (last step),
// steps_done]
struct LaunchCtl {
  unsigned int sstep0, k0, k1;  // first step; the run's Langevin key
  int limit, do_drift, stopped, steps_done;
  int clamps, reach, skin, trig;
  float t0, t_slope;  // thermostat target at step 0 and its slope a step
  int iters;  // the launch's loop iterations (each must run a step)
  int pad[2];
  float stats[8];
};
static_assert(sizeof(LaunchCtl) == 24 * 4, "LaunchCtl is 24 words");

// the planes and work buffers one controlled step runs on (static: the
// addresses a captured graph holds)
struct StepPlanes {
  float *gx, *gv, *gf;
  const float* gxr;
  const int* bid;
  const uint8_t* hn;
  const int* pid;
  const uint8_t* interior;
  const int *halo_cols, *halo_src;
  const float* halo_shift;
  const int *exl, *exr;
  const uint8_t* active;
  float* eb;
  const float* lgm;
  float* fpart;
  int* ipart;
  float *lpart, *zpart;
  LaunchCtl* ctl;
  int H;
  float kick, dt;
};

namespace {

// the step index s of a controlled launch: the steps it has done, which
// only the step's last kernel (langevin_finish) advances, so that every
// kernel of a step reads the same s; 0 for the chain
__device__ __forceinline__ int step_of(const LaunchCtl* ctl) {
  return ctl != nullptr ? ctl->steps_done : 0;
}

// the step due in a controlled launch does not run
__device__ __forceinline__ bool step_off(const LaunchCtl* ctl) {
  return ctl != nullptr && (ctl->stopped || ctl->steps_done >= ctl->limit);
}

// nor does its kick + drift + halo on an event launch's first step (the
// host integrated it before the events, pallas_step.py:686-690)
__device__ __forceinline__ bool drift_off(const LaunchCtl* ctl) {
  return step_off(ctl) ||
         (ctl != nullptr && ctl->steps_done == 0 && !ctl->do_drift);
}

__global__ void launch_begin_kernel(LaunchCtl* ctl, unsigned int sstep0,
                                    unsigned int k0, unsigned int k1,
                                    int limit, int do_drift, float t0,
                                    float t_slope) {
  LaunchCtl z = {};
  z.sstep0 = sstep0;
  z.k0 = k0;
  z.k1 = k1;
  z.limit = limit;
  z.do_drift = do_drift;
  z.t0 = t0;
  z.t_slope = t_slope;
  *ctl = z;
}

// ---------------------------------------------------------------------
// kick_drift_halo <- pallas_step.py:731-751 (K2a)
//
// Bound: device-memory bytes (reads x, v, f, bid; writes x, v once) — a
// streaming pass at 12 float planes per slot.  Design: one thread per
// slot for the kick + drift; the halo columns (about a fifth of the
// columns at 100k beads) in a second launch that gathers each from its
// interior source column — the six masked rolls of the TPU kernel exist
// because a TPU lane gather is slow; here a gather is a plain load.

// gx_out / gv_out may be gx / gv (each slot reads its own values first);
// replica blockIdx.y
__global__ void kick_drift_kernel(const float* gx, const float* gv,
                                  const float* __restrict__ gf,
                                  const int* __restrict__ bid,
                                  const uint8_t* __restrict__ interior,
                                  float* gx_out, float* gv_out, int cap,
                                  int P, int n, float kick, float dt,
                                  const LaunchCtl* ctl) {
  const long capP = (long)cap * P;
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= capP || drift_off(ctl)) return;
  const long rp = 3 * capP * blockIdx.y;
  gx += rp;
  gv += rp;
  gf += rp;
  gx_out += rp;
  gv_out += rp;
  bid += capP * blockIdx.y;
  const int c = (int)(t % P);
  const float vf = (interior[c] && bid[t] < n) ? 1.f : 0.f;
  for (int k = 0; k < 3; ++k) {
    const long i = k * capP + t;
    const float v = gv[i] + (kick * gf[i]) * vf;
    gv_out[i] = v;
    gx_out[i] = gx[i] + (dt * v) * vf;
  }
}

__global__ void halo_kernel(float* __restrict__ gx, const int* halo_cols,
                            const int* halo_src, const float* halo_shift,
                            int H, int cap, int P, const LaunchCtl* ctl) {
  const long capP = (long)cap * P;
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long)H * cap || drift_off(ctl)) return;
  gx += 3 * capP * blockIdx.y;  // replica blockIdx.y
  const int r = (int)(t / H), h = (int)(t % H);
  const long dst = (long)r * P + halo_cols[h];
  const long src = (long)r * P + halo_src[h];
  for (int k = 0; k < 3; ++k)
    gx[k * capP + dst] = gx[k * capP + src] + halo_shift[k * H + h];
}

// ---------------------------------------------------------------------
// stencil_forces <- pallas_step.py:249-510, 753-774 (K1 / K2b), in the
// full 27-offset form of engine.make_kernel (engine.py:672-784): the
// occupancy-following block of stencil.cuh, each valid slot summing its
// own complete force over the 27 offsets' occupied rows (no Newton
// reactions, no ghost fold-back), in a fixed order.  Tallies (energies,
// bond sightings, clamps, links) reduce per block and then in a one-block
// finishing pass.

template <bool APPROX>
__global__ void __launch_bounds__(kTileThreads)
    stencil_kernel(const float* __restrict__ gx, const int* __restrict__ bid,
                   const uint8_t* __restrict__ hn,
                   const int* __restrict__ pid,
                   const uint8_t* __restrict__ interior,
                   float* __restrict__ gf, float* __restrict__ fpart,
                   int* __restrict__ ipart, StencilArgs a,
                   const LaunchCtl* ctl) {
  if (step_off(ctl)) return;
  stencil_tile<kFull, APPROX>(gx, bid, hn, pid, interior, gf, nullptr, fpart,
                              ipart, a, a.P);
}

cudaError_t stencil_launch(const float* gx, const int* bid, const uint8_t* hn,
                           const int* pid, const uint8_t* interior, float* gf,
                           float* fpart, int* ipart, const StencilArgs& a,
                           int R, const LaunchCtl* ctl, cudaStream_t s) {
  return launch_stencil<stencil_kernel<true>, stencil_kernel<false>>(
      a, false, stencil_grid(a.P, 1, R), s, gx, bid, hn, pid, interior, gf,
      fpart, ipart, a, ctl);
}

// ---------------------------------------------------------------------
// extruder_springs <- pallas_step.py:776-930 (K2c), the math of
// engine.make_extruder_pass (engine.py:857-897)
//
// Bound: launch latency — at most 8,192 springs, 12 scattered loads and 6
// atomic adds each.  Design: one thread per extruder slot gathers both
// anchors, takes the minimum image and adds +-force to the anchors'
// slots (spring_slot).  A bead carries at most one anchor
// (state.py:130-133), so the targets are unique and the atomics never
// contend; they only make a broken invariant safe, and each target's sum
// is its one add in any order.  Replaces the TPU one-hot-matmul block
// tables.  The chain launches springs_kernel; the step loop runs the
// same slots in the blocks after the first of the stencil's fold launch
// (fold_springs_kernel), which reads the stencil's finished output as
// they do, so that the springs are no node of their own.

__device__ __forceinline__ void spring_slot(const float* __restrict__ gx,
                                            float* __restrict__ gf,
                                            const int* __restrict__ exl,
                                            const int* __restrict__ exr,
                                            const uint8_t* __restrict__ active,
                                            float* __restrict__ eb_out,
                                            const SpringArgs& a, int e) {
  if (e >= a.E) return;
  const long capP = (long)a.cap * a.P;
  const long sl = exl[e], sr = exr[e];
  if (!active[e] || sl < 0 || sl >= capP || sr < 0 || sr >= capP) {
    eb_out[e] = 0.f;
    return;
  }
  float d[3];
  for (int k = 0; k < 3; ++k) {
    const float dk = gx[k * capP + sl] - gx[k * capP + sr];
    d[k] = dk - a.box[k] * rintf(dk / a.box[k]);
  }
  const float rsq = fmaxf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2], 1e-12f);
  float fb, eb;
  if (a.harmonic) {
    const float r = sqrtf(rsq);
    const float dr = r - a.r0;
    fb = a.neg_2k * dr / r;
    eb = a.k * dr * dr;
  } else {
    const float rlog = fmaxf(1.f - rsq / a.r0sq, 0.1f);
    fb = a.neg_k / rlog;
    const float rsq_w = fmaxf(rsq, a.wca_floorsq);
    const float sr2 = a.sig_sq / rsq_w;
    const float sr6 = sr2 * sr2 * sr2;
    const bool wca = rsq < a.wca_cutsq;
    fb = fb + (wca ? a.f_wca * sr6 * (sr6 - 0.5f) / rsq_w : 0.f);
    eb = a.e_fene * logf(rlog) +
         (wca ? a.e_wca * sr6 * (sr6 - 1.f) + a.eps : 0.f);
  }
  for (int k = 0; k < 3; ++k) {
    const float fk = d[k] * fb;
    atomicAdd(gf + k * capP + sl, fk);
    atomicAdd(gf + k * capP + sr, -fk);
  }
  eb_out[e] = eb;
}

// replica blockIdx.y: its planes and its E slots
__global__ void springs_kernel(const float* __restrict__ gx,
                               float* __restrict__ gf,
                               const int* __restrict__ exl,
                               const int* __restrict__ exr,
                               const uint8_t* __restrict__ active,
                               float* __restrict__ eb_out, SpringArgs a) {
  const long rp = 3L * a.cap * a.P * blockIdx.y, re = (long)a.E * blockIdx.y;
  spring_slot(gx + rp, gf + rp, exl + re, exr + re, active + re, eb_out + re,
              a, blockIdx.x * blockDim.x + threadIdx.x);
}

// the controlled step's stencil finishing pass and springs, one launch
// of 1 + blocks_for(E) blocks.  Block 0 folds the step's clamp events
// (halved) and reach bit into the control block and the unhalved
// energies and the link count into its stats rows, and counts the
// launch's loop iteration; blocks 1.. run one extruder slot a thread
__global__ void fold_springs_kernel(const float* __restrict__ fpart,
                                    const int* __restrict__ ipart,
                                    int nblocks, int energy,
                                    const float* __restrict__ gx,
                                    float* __restrict__ gf,
                                    const int* __restrict__ exl,
                                    const int* __restrict__ exr,
                                    const uint8_t* __restrict__ active,
                                    float* __restrict__ eb, SpringArgs pa,
                                    LaunchCtl* ctl) {
  __shared__ float shf[32];
  __shared__ int shi[32];
  if (blockIdx.x == 0 && threadIdx.x == 0) ctl->iters += 1;
  if (step_off(ctl)) return;
  if (blockIdx.x > 0) {
    spring_slot(gx, gf, exl, exr, active, eb, pa,
                (blockIdx.x - 1) * blockDim.x + threadIdx.x);
    return;
  }
  const StencilSums t = reduce_tallies(fpart, ipart, nblocks, shf, shi);
  if (threadIdx.x == 0) {
    ctl->clamps += t.ncl / 2;
    ctl->reach |= reach_bad(t) ? 1 : 0;
    if (energy) {
      ctl->stats[0] = t.e_lj;
      ctl->stats[1] = t.e_b;
    }
    ctl->stats[4] = (float)t.nlink;
  }
}

// ---------------------------------------------------------------------
// langevin_kick_monitor <- pallas_step.py:932-1000 (K2d + K2e);
// engine.py:1398-1455, with fix langevin's group (the weight w = valid *
// lgm, pallas_step.py:722-723) and zero (pallas_step.py:953-958)
//
// Bound: device-memory bytes (76 B a slot), beside the threefry integer
// work (3 x 20 rounds per slot of nonzero weight) and ~46 f32 operations
// a slot.  Design: one thread per slot draws its three noise words
// (where its weight is not 0: about one slot in three), applies the
// Langevin force and the final kick, and computes its squared
// displacement since the rebuild and its look-ahead; per-block top-2 /
// max, and the last block to finish merges them (last_block): one
// launch.  Without zero and group that is the whole kernel (the group
// weight is the valid mask).
//
// zero needs the grid-wide sum of noise * w before any slot can apply
// its force, so it adds one pass before: per block (four slots a
// thread, loads first) the three sums of noise * w and the sum of the
// group plane (members only draw their words), and its last block
// reduces the partials in a fixed order (no float atomics: bitwise the
// same run to run) into the three means.  Two launches with zero, one
// without.  The zero pass is latency-bound, not bound by its 8 B a slot:
// on an H100 80GB HBM3 at 700 W (chip_ab.py kernels, PERF.md) ~7.5 us of
// its ~9.5 at 100k beads are its launch, loads, reductions and ticket
// and ~2 its threefry; one launch whose blocks meet at a grid barrier
// between the sums and the main phase was no faster.  The main pass
// recomputes each slot's words rather than reading them stored by the
// zero pass: they cost it ~1.2 us at 100k, and storing the members'
// words (12 B each, written and read back: ~0.65 us of bytes) would save
// at most about half of that (not tried).
//
// The ticket words the last block counts on lie after each pass's
// partials; they start at 0 and each launch leaves them 0 (the counter
// wraps at the grid's size), so CUDA-graph replays start clean.  A step
// that step_off stops takes no ticket.

// the main pass's block; zero's pass: its block and the slots a thread
// sums (the fastest shapes chip_ab.py timed).  Their partials fit the
// buffers the wrappers size for blocks of kThreads slots (lle_blocks)
constexpr int kLanThreads = 512;
constexpr int kSumThreads = 256, kSumSlots = 4;
static_assert(kSumSlots == 4, "the zero pass adds its slots in pairs");

__device__ unsigned int rotl(unsigned int x, int r) {
  return (x << r) | (x >> (32 - r));
}

// threefry2x32, 20 rounds; first output word (engine._threefry2x32)
__device__ unsigned int threefry_x0(unsigned int k0, unsigned int k1,
                                    unsigned int c0, unsigned int c1) {
  const unsigned int ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[8] = {13, 15, 26, 6, 17, 29, 16, 24};
  unsigned int x0 = c0 + k0, x1 = c1 + k1;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[4 * (i % 2) + j]);
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (unsigned int)(i + 1);
  }
  return x0;
}

// a controlled step's key, threefry counter base (sstep0 + s) * 4 and
// gamma2 = g2base * sqrt(t0 + t_slope * s) (pallas_step.py:933-937; the
// argument block then carries g2base in gamma2), s = step_of(ctl)
__device__ __forceinline__ LangevinArgs step_args(LangevinArgs a,
                                                  const LaunchCtl* ctl) {
  if (ctl == nullptr && a.keys != nullptr) {
    // the chain's replica blockIdx.y: its key words
    a.k0 = a.keys[2 * blockIdx.y];
    a.k1 = a.keys[2 * blockIdx.y + 1];
  }
  if (ctl != nullptr) {
    const int s = ctl->steps_done;
    a.k0 = ctl->k0;
    a.k1 = ctl->k1;
    a.base = (ctl->sstep0 + (unsigned int)s) * 4u;
    a.gamma2 =
        a.gamma2 * sqrtf(fmaxf(ctl->t0 + ctl->t_slope * (float)s, 0.f));
  }
  return a;
}

__device__ __forceinline__ float lan_noise(const LangevinArgs& a, int b,
                                           int k) {
  const unsigned int x0 =
      threefry_x0(a.k0, a.k1, (unsigned int)b, a.base + (unsigned int)k);
  return (float)(x0 >> 8) * (1.f / 16777216.f) - 0.5f;
}

// whether this block is the launch's last to write its partials: thread
// 0, which wrote them, takes a ticket with an acquire-release atomic
// (its partials are visible before the ticket counts, and the last
// block sees every block's); the counter wraps to 0 at the grid's last
// ticket.  The same answer in every thread
__device__ bool last_block(float* ticket_word) {
  __shared__ int last;
  if (threadIdx.x == 0) {
    unsigned int old;
    asm volatile("atom.acq_rel.gpu.global.inc.u32 %0, [%1], %2;"
                 : "=r"(old)
                 : "l"(ticket_word), "r"(gridDim.x - 1)
                 : "memory");
    last = old == gridDim.x - 1;
  }
  __syncthreads();
  return last;
}

// zero's pass: per block the sums of noise * w (3) and of the group
// plane (w == 0 slots add exactly 0, so they draw no words); the last
// block reduces them in a fixed order into the means sum * inv_cnt,
// inv_cnt = 1 / max(sum lgm, 1) with a group and 1/n without
// (engine.py:1428-1434).  zpart: 4 partials a block, the 3 means, the
// ticket word
__global__ void __launch_bounds__(kSumThreads)
    langevin_sum_kernel(const int* __restrict__ bid,
                        const uint8_t* __restrict__ interior,
                        const float* __restrict__ lgm, float* zpart,
                        LangevinArgs a0, const LaunchCtl* ctl) {
  __shared__ float sh[32];
  if (step_off(ctl)) return;
  const LangevinArgs a = step_args(a0, ctl);
  const int capP = a.cap * a.P;
  // replica blockIdx.y: its planes, and its partials, means and ticket
  bid += (long)capP * blockIdx.y;
  if (a.group) lgm += (long)capP * blockIdx.y;
  zpart += (4L * gridDim.x + 4) * blockIdx.y;
  const int t0 = blockIdx.x * kSumThreads * kSumSlots + threadIdx.x;
  // a thread's slots t0 + j * kSumThreads: every load first, then the
  // members' words
  int b[kSumSlots];
  float w[kSumSlots];
  float cnt = 0.f;
#pragma unroll
  for (int j = 0; j < kSumSlots; ++j) {
    const int t = t0 + j * kSumThreads;
    b[j] = a.n;
    w[j] = 0.f;
    if (t < capP) {
      b[j] = bid[t];
      const float vf = (interior[t % a.P] && b[j] < a.n) ? 1.f : 0.f;
      const float g = a.group ? lgm[t] : 0.f;
      cnt += g;
      w[j] = a.group ? vf * g : vf;
    }
  }
  float x[kSumSlots][3], s[3];
#pragma unroll
  for (int j = 0; j < kSumSlots; ++j) {
    for (int k = 0; k < 3; ++k) x[j][k] = 0.f;
    if (w[j] != 0.f)
      for (int k = 0; k < 3; ++k) x[j][k] = lan_noise(a, b[j], k) * w[j];
  }
  // in pairs, to keep the sums' tree shallow (chip_smoke.py's
  // zero_group_phase bounds the round-off by the tree's depth)
  for (int k = 0; k < 3; ++k)
    s[k] = (x[0][k] + x[1][k]) + (x[2][k] + x[3][k]);
  for (int k = 0; k < 3; ++k) {
    const float r = block_sum(s[k], sh);
    if (threadIdx.x == 0) zpart[4 * blockIdx.x + k] = r;
  }
  cnt = block_sum(cnt, sh);
  if (threadIdx.x == 0) zpart[4 * blockIdx.x + 3] = cnt;
  const int nb = gridDim.x;
  if (!last_block(zpart + 4 * nb + 3)) return;
  // the partials of other blocks through L2 (__ldcg), in block order
  float m[4] = {0.f, 0.f, 0.f, 0.f};
  for (int blk = threadIdx.x; blk < nb; blk += blockDim.x) {
    const float4 q = __ldcg(reinterpret_cast<const float4*>(zpart) + blk);
    m[0] += q.x;
    m[1] += q.y;
    m[2] += q.z;
    m[3] += q.w;
  }
  for (int k = 0; k < 4; ++k) m[k] = block_sum(m[k], sh);
  if (threadIdx.x == 0) {
    const float inv = a.group ? 1.f / fmaxf(m[3], 1.f) : a.inv_n;
    for (int k = 0; k < 3; ++k) zpart[4 * nb + k] = m[k] * inv;
  }
}

// the launch's last block: the global top-2 from the block pairs: M =
// max m1_b, and the largest value != M is m1_b where m1_b != M, else m2_b
// (engine.py:1311-1312).  A controlled step s folds its skin bit and
// trigger into the control block (the trigger stops the launch:
// pallas_step.py:993-1004), advances steps_done to s + 1, writes the
// stats rows after it and, in the step loop's graph (cond not 0), sets
// the loop's condition: another step while !stopped && s + 1 < limit
// (pallas_step.py:1002-1004).  The chain's step writes [flag bits,
// trigger]
__device__ void langevin_finish(const float* part, int nblocks,
                                const LangevinArgs& a,
                                long long* __restrict__ out, LaunchCtl* ctl,
                                cudaGraphConditionalHandle cond, int s,
                                float* sh) {
  float m = 0.f, p = 0.f;
  for (int b = threadIdx.x; b < nblocks; b += blockDim.x) {
    m = fmaxf(m, __ldcg(part + 3 * b));
    p = fmaxf(p, __ldcg(part + 3 * b + 2));
  }
  const float M = block_bcast(block_max(m, sh), sh);
  p = block_max(p, sh);
  float m2 = 0.f;
  for (int b = threadIdx.x; b < nblocks; b += blockDim.x) {
    const float m1b = __ldcg(part + 3 * b);
    m2 = fmaxf(m2, m1b != M ? m1b : __ldcg(part + 3 * b + 1));
  }
  m2 = block_max(m2, sh);
  if (threadIdx.x == 0) {
    const bool bad = sqrtf(M) + sqrtf(m2) > a.bad_cut;
    const int trig = p > a.trig_cut ? 1 : 0;
    if (ctl == nullptr) {
      out[0] = bad ? 4 : 0;
      out[1] = trig;
    } else {
      ctl->skin |= bad ? 1 : 0;
      ctl->trig = trig;
      ctl->steps_done = s + 1;
      ctl->stopped |= trig;
      ctl->stats[2] = (float)ctl->reach;
      ctl->stats[3] = 2.f * (float)ctl->clamps;
      ctl->stats[5] = (float)ctl->skin;
      ctl->stats[6] = (float)trig;
      ctl->stats[7] = (float)(s + 1);
      if (cond)
        cudaGraphSetConditional(cond, !ctl->stopped && s + 1 < ctl->limit);
    }
  }
}

// gf_out / gv_out may be gf / gv (each slot reads its own values first).
// part: 3 partials a block (m1, m2, max look-ahead), the ticket word;
// mean: zero's means (zero's pass's buffer, its replicas mstride apart).
// Replica blockIdx.y: its planes, partials, ticket word, means and out
__global__ void __launch_bounds__(kLanThreads)
    langevin_kernel(const float* __restrict__ gx,
                    const float* __restrict__ gxr, const float* gv,
                    const float* gf, const int* __restrict__ bid,
                    const uint8_t* __restrict__ interior,
                    const float* __restrict__ lgm,
                    const float* __restrict__ mean, long mstride,
                    float* gf_out, float* gv_out, float* part,
                    long long* __restrict__ out, LangevinArgs a0,
                    LaunchCtl* ctl, cudaGraphConditionalHandle cond) {
  __shared__ float sh[32];
  const int s = step_of(ctl);
  if (step_off(ctl)) {
    // a loop iteration that finds the launch over ends the loop (the
    // condition set after each step keeps it from starting one)
    if (cond && blockIdx.x == 0 && threadIdx.x == 0)
      cudaGraphSetConditional(cond, 0);
    return;
  }
  const LangevinArgs a = step_args(a0, ctl);
  const int capP = a.cap * a.P;
  {
    const long r = blockIdx.y, rp = 3L * capP * r;
    gx += rp;
    gxr += rp;
    gv += rp;
    gf += rp;
    gf_out += rp;
    gv_out += rp;
    bid += capP * r;
    if (a.group) lgm += capP * r;
    if (mean != nullptr) mean += mstride * r;
    part += (3L * gridDim.x + 1) * r;
    if (out != nullptr) out += 2 * r;
  }
  const int t = blockIdx.x * kLanThreads + threadIdx.x;
  float dsq = 0.f, pred = 0.f;
  if (t < capP) {
    const int c = t % a.P;
    const int b = bid[t];
    const bool valid = interior[c] && b < a.n;
    const float vf = valid ? 1.f : 0.f;
    const float wl = a.group ? vf * lgm[t] : vf;
    float vn[3], d[3];
    for (int k = 0; k < 3; ++k) {
      const long i = (long)k * capP + t;
      const float v = gv[i];
      float f = gf[i];
      // a slot of weight 0 (empty, halo, outside the group) draws no
      // words: its force stays f, which f + term * 0 is (the stencils
      // write no -0 for the sign of the zero to change)
      if (a.langevin && wl != 0.f) {
        float noise = lan_noise(a, b, k);
        if (a.zero) noise = noise - mean[k];
        f = f + (a.gamma1 * v + a.gamma2 * noise) * wl;
      }
      const float v2 = v + (a.kick * f) * vf;
      gf_out[i] = f;
      gv_out[i] = v2;
      vn[k] = v2 + a.kick * f;
      d[k] = gx[i] - gxr[i];
    }
    if (valid) {
      dsq = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
      const float vsq = vn[0] * vn[0] + vn[1] * vn[1] + vn[2] * vn[2];
      pred = sqrtf(dsq) + a.dt * sqrtf(vsq);
    }
  }
  // top-2 of dsq within the block: the max, then the max of the rest
  const float m1 = block_bcast(block_max(dsq, sh), sh);
  const float m2 = block_max(dsq == m1 ? 0.f : dsq, sh);
  const float pm = block_max(pred, sh);
  if (threadIdx.x == 0) {
    part[3 * blockIdx.x] = m1;
    part[3 * blockIdx.x + 1] = m2;
    part[3 * blockIdx.x + 2] = pm;
  }
  if (last_block(part + 3 * gridDim.x))
    langevin_finish(part, gridDim.x, a, out, ctl, cond, s, sh);
}

// the launches of each kernel pair over R replicas; ctl null: the
// chain's one step
void kick_drift_launch(const float* gx, const float* gv, const float* gf,
                       const int* bid, const uint8_t* interior,
                       const int* halo_cols, const int* halo_src,
                       const float* halo_shift, float* gx_out, float* gv_out,
                       int cap, int P, int H, int n, float kick, float dt,
                       int R, const LaunchCtl* ctl, cudaStream_t s) {
  kick_drift_kernel<<<dim3(blocks_for((long)cap * P), R), kThreads, 0, s>>>(
      gx, gv, gf, bid, interior, gx_out, gv_out, cap, P, n, kick, dt, ctl);
  if (H > 0)
    halo_kernel<<<dim3(blocks_for((long)H * cap), R), kThreads, 0, s>>>(
        gx_out, halo_cols, halo_src, halo_shift, H, cap, P, ctl);
}

// part: R replicas' 3 partials a block and ticket word; zpart: their 4
// partials a block, 3 means and ticket word (zero's pass)
void langevin_launch(const float* gx, const float* gxr, const float* gv,
                     const float* gf, const int* bid,
                     const uint8_t* interior, const float* lgm,
                     float* gf_out, float* gv_out, float* part, float* zpart,
                     long long* out, LangevinArgs a, int R, LaunchCtl* ctl,
                     cudaGraphConditionalHandle cond, cudaStream_t s) {
  const int capP = a.cap * a.P;
  const float* mean = nullptr;
  long mstride = 0;
  if (a.langevin && a.zero) {
    const int nz = (capP + kSumThreads * kSumSlots - 1) /
                   (kSumThreads * kSumSlots);
    langevin_sum_kernel<<<dim3(nz, R), kSumThreads, 0, s>>>(bid, interior,
                                                            lgm, zpart, a,
                                                            ctl);
    mean = zpart + 4 * nz;
    mstride = 4L * nz + 4;
  }
  langevin_kernel<<<dim3((capP + kLanThreads - 1) / kLanThreads, R),
                    kLanThreads, 0, s>>>(gx, gxr, gv, gf, bid, interior, lgm,
                                         mean, mstride, gf_out, gv_out, part,
                                         out, a, ctl, cond);
}

// one controlled step, in place on the static planes, in the chain's
// order: kick + drift + halo, stencil (energies when sa.energy), its fold
// with the springs (pa.E > 0), Langevin + final kick + monitor.  la.gamma2
// is the run's g2base; the key, counter base and ramp come from the
// block.  cond: the step loop's condition (0 outside its graph)
cudaError_t step_ctl_launch(const StepPlanes& p, const StencilArgs& sa,
                            const SpringArgs& pa, const LangevinArgs& la,
                            cudaGraphConditionalHandle cond,
                            cudaStream_t s) {
  const int cap = sa.cap, P = sa.P;
  kick_drift_launch(p.gx, p.gv, p.gf, p.bid, p.interior, p.halo_cols,
                    p.halo_src, p.halo_shift, p.gx, p.gv, cap, P, p.H, sa.n,
                    p.kick, p.dt, 1, p.ctl, s);
  const cudaError_t err = stencil_launch(p.gx, p.bid, p.hn, p.pid,
                                         p.interior, p.gf, p.fpart, p.ipart,
                                         sa, 1, p.ctl, s);
  if (err != cudaSuccess) return err;
  fold_springs_kernel<<<1 + (pa.E > 0 ? blocks_for(pa.E) : 0), kThreads, 0,
                        s>>>(p.fpart, p.ipart, stencil_blocks(P, 1),
                             sa.energy, p.gx, p.gf, p.exl, p.exr, p.active,
                             p.eb, pa, p.ctl);
  langevin_launch(p.gx, p.gxr, p.gv, p.gf, p.bid, p.interior, p.lgm, p.gf,
                  p.gv, p.lpart, p.zpart, nullptr, la, 1, p.ctl, cond, s);
  return cudaGetLastError();
}

// K2's step loop as one CUDA graph: a WHILE conditional node (default
// value 1 at each launch) whose body is one controlled step, captured
// into it on a stream of the library's own.  The Langevin pass's last
// block sets the condition after each step, so a launch runs exactly
// the steps the trigger and the limit allow and no dead ones; the
// launch's limit lives in the control block, so one graph serves every
// limit.  Only the executable graph is launched; the graph is kept for
// its node count
struct StepGraph {
  cudaGraph_t graph = nullptr;
  cudaGraph_t body = nullptr;  // owned by graph
  cudaGraphExec_t exec = nullptr;
};

cudaError_t step_graph_build(StepGraph* g, const StepPlanes& p,
                             const StencilArgs& sa, const SpringArgs& pa,
                             const LangevinArgs& la) {
  cudaError_t err = cudaGraphCreate(&g->graph, 0);
  if (err != cudaSuccess) return err;
  cudaGraphConditionalHandle cond;
  err = cudaGraphConditionalHandleCreate(&cond, g->graph, 1,
                                         cudaGraphCondAssignDefault);
  if (err != cudaSuccess) return err;
  // aggregate initialisation zeroes the rest (the struct has no default
  // constructor)
  cudaGraphNodeParams np = {cudaGraphNodeTypeConditional};
  np.conditional.handle = cond;
  np.conditional.type = cudaGraphCondTypeWhile;
  np.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, g->graph, nullptr, 0, &np);
  if (err != cudaSuccess) return err;
  g->body = np.conditional.phGraph_out[0];
  cudaStream_t cs;
  err = cudaStreamCreateWithFlags(&cs, cudaStreamNonBlocking);
  if (err != cudaSuccess) return err;
  err = cudaStreamBeginCaptureToGraph(cs, g->body, nullptr, nullptr, 0,
                                      cudaStreamCaptureModeThreadLocal);
  if (err == cudaSuccess) {
    const cudaError_t step = step_ctl_launch(p, sa, pa, la, cond, cs);
    cudaGraph_t captured;
    err = cudaStreamEndCapture(cs, &captured);
    if (step != cudaSuccess) err = step;
  }
  cudaStreamDestroy(cs);
  if (err != cudaSuccess) return err;
  return cudaGraphInstantiate(&g->exec, g->graph, 0);
}

void step_graph_destroy(StepGraph* g) {
  if (g->exec) cudaGraphExecDestroy(g->exec);
  if (g->graph) cudaGraphDestroy(g->graph);
  delete g;
}

}  // namespace

// ---------------------------------------------------------------------
// C entry points (bound with ctypes by lammps_le_torch/fast/kernels.py)

extern "C" {

// each entry point of a chain kernel takes R replicas' planes stacked on
// a leading axis (R = 1: one run's)
int lle_kick_drift_halo(const float* gx, const float* gv, const float* gf,
                        const int* bid, const uint8_t* interior,
                        const int* halo_cols, const int* halo_src,
                        const float* halo_shift, float* gx_out,
                        float* gv_out, int cap, int P, int H, int n,
                        float kick, float dt, int R, void* stream) {
  kick_drift_launch(gx, gv, gf, bid, interior, halo_cols, halo_src,
                    halo_shift, gx_out, gv_out, cap, P, H, n, kick, dt, R,
                    nullptr, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// blocks of a one-thread-per-item launch: the size of the per-block
// partial buffers the wrappers allocate
int lle_blocks(long work) { return blocks_for(work); }

// the stencil's blocks (the size of its tally partials) and the most
// rows a column may hold
int lle_stencil_blocks(int P) { return stencil_blocks(P, 1); }
int lle_stencil_max_cap() { return kMaxCap; }

// fpart / ipart: each replica's lle_stencil_blocks partials; en, out: 2
// a replica
int lle_stencil_forces(const float* gx, const int* bid, const uint8_t* hn,
                       const int* pid, const uint8_t* interior, float* gf,
                       float* fpart, int* ipart, float* en, long long* out,
                       StencilArgs a, int R, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err = stencil_launch(gx, bid, hn, pid, interior, gf,
                                         fpart, ipart, a, R, nullptr, s);
  if (err != cudaSuccess) return (int)err;
  stencil_finish_kernel<<<R, kThreads, 0, s>>>(
      fpart, ipart, stencil_blocks(a.P, 1), en, out);
  return (int)cudaGetLastError();
}

int lle_extruder_springs(const float* gx, float* gf, const int* exl,
                         const int* exr, const uint8_t* active, float* eb,
                         SpringArgs a, int R, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (a.E > 0)
    springs_kernel<<<dim3(blocks_for(a.E), R), kThreads, 0, s>>>(
        gx, gf, exl, exr, active, eb, a);
  return (int)cudaGetLastError();
}

// part: a replica's 3 partials a block and a ticket word; zpart (zero
// only): its 4 partials a block, the 3 means and a ticket word; a
// replica's at its stride, each replica's fitting in the words that
// lle_blocks(capP) blocks would take.  The ticket words must
// be 0 at the first launch; every launch leaves them 0.  a.keys: the
// replicas' key words, or null for a.k0, a.k1 (R = 1)
int lle_langevin_kick_monitor(const float* gx, const float* gxr,
                              const float* gv, const float* gf,
                              const int* bid, const uint8_t* interior,
                              const float* lgm, float* gf_out, float* gv_out,
                              float* part, float* zpart, long long* out,
                              LangevinArgs a, int R, void* stream) {
  langevin_launch(gx, gxr, gv, gf, bid, interior, lgm, gf_out, gv_out, part,
                  zpart, out, a, R, nullptr, 0, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// the control block's size and the offsets of its stats rows and its
// iteration count, in 4-byte words (kernels.py reads them back)
int lle_ctl_words() { return (int)(sizeof(LaunchCtl) / 4); }
int lle_ctl_stats() { return (int)(offsetof(LaunchCtl, stats) / 4); }
int lle_ctl_iters() { return (int)(offsetof(LaunchCtl, iters) / 4); }

// the control kernel: a launch's first step, key, limit, drift flag and
// thermostat ramp, every tally, count and stats row zeroed
int lle_launch_begin(LaunchCtl* ctl, unsigned int sstep0, unsigned int k0,
                     unsigned int k1, int limit, int do_drift, float t0,
                     float t_slope, void* stream) {
  launch_begin_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      ctl, sstep0, k0, k1, limit, do_drift, t0, t_slope);
  return (int)cudaGetLastError();
}

// the next step of a controlled launch, run eagerly (an energy launch)
int lle_step_ctl(StepPlanes p, StencilArgs sa, SpringArgs pa,
                 LangevinArgs la, void* stream) {
  return (int)step_ctl_launch(p, sa, pa, la, 0, (cudaStream_t)stream);
}

// the step loop's graph on the static planes p (every kernel of a step
// launched once before, so that none loads during the capture): *out its
// handle, for lle_loop_launch, lle_loop_nodes and lle_loop_destroy.  Any
// failure returns its error and no graph
int lle_loop_create(StepPlanes p, StencilArgs sa, SpringArgs pa,
                    LangevinArgs la, void** out) {
  *out = nullptr;
  StepGraph* g = new StepGraph();
  const cudaError_t err = step_graph_build(g, p, sa, pa, la);
  if (err != cudaSuccess) {
    step_graph_destroy(g);
    return (int)err;
  }
  *out = g;
  return 0;
}

// a launch of the loop (after lle_launch_begin on the same stream)
int lle_loop_launch(void* graph, void* stream) {
  return (int)cudaGraphLaunch(static_cast<StepGraph*>(graph)->exec,
                              (cudaStream_t)stream);
}

// the nodes of the loop's body (one step), and how many are kernels
int lle_loop_nodes(void* graph, int* kernels, int* all) {
  cudaGraph_t body = static_cast<StepGraph*>(graph)->body;
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(body, nullptr, &n);
  if (err != cudaSuccess) return (int)err;
  std::vector<cudaGraphNode_t> nodes(n);
  err = cudaGraphGetNodes(body, nodes.data(), &n);
  if (err != cudaSuccess) return (int)err;
  *kernels = 0;
  *all = (int)n;
  for (cudaGraphNode_t node : nodes) {
    cudaGraphNodeType type;
    err = cudaGraphNodeGetType(node, &type);
    if (err != cudaSuccess) return (int)err;
    *kernels += type == cudaGraphNodeTypeKernel ? 1 : 0;
  }
  return 0;
}

void lle_loop_destroy(void* graph) {
  step_graph_destroy(static_cast<StepGraph*>(graph));
}

}  // extern "C"
