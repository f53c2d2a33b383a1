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
// sums differs.  Minimum image uses rintf (round half to even, as
// jnp.round / torch.round).

#include "common.cuh"

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
};

namespace {

// ---------------------------------------------------------------------
// kick_drift_halo <- pallas_step.py:731-751 (K2a)
//
// Bound: device-memory bytes (reads x, v, f, bid; writes x, v once) — a
// streaming pass at 12 float planes per slot.  Design: one thread per
// slot for the kick + drift; the halo columns (about a fifth of the
// columns at 100k beads) in a second launch that gathers each from its
// interior source column — the six masked rolls of the TPU kernel exist
// because a TPU lane gather is slow; here a gather is a plain load.

__global__ void kick_drift_kernel(const float* __restrict__ gx,
                                  const float* __restrict__ gv,
                                  const float* __restrict__ gf,
                                  const int* __restrict__ bid,
                                  const uint8_t* __restrict__ interior,
                                  float* __restrict__ gx_out,
                                  float* __restrict__ gv_out, int cap, int P,
                                  int n, float kick, float dt) {
  const long capP = (long)cap * P;
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= capP) return;
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
                            int H, int cap, int P) {
  const long capP = (long)cap * P;
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long)H * cap) return;
  const int r = (int)(t / H), h = (int)(t % H);
  const long dst = (long)r * P + halo_cols[h];
  const long src = (long)r * P + halo_src[h];
  for (int k = 0; k < 3; ++k)
    gx[k * capP + dst] = gx[k * capP + src] + halo_shift[k * H + h];
}

// ---------------------------------------------------------------------
// stencil_forces <- pallas_step.py:249-510, 753-774 (K1 / K2b), in the
// full 27-offset form of engine.make_kernel (engine.py:672-784)
//
// Bound: at 100k beads (cap 9, P 33664) about 74 M candidate slot pairs
// of ~40 flops and five 4-byte loads each; the planes (~7 MB) sit in L2,
// so the loads are L1/L2 traffic and the kernel is bound by load and FP32
// issue.  Design: one thread per (row i, column c) slot accumulates its
// own complete force over 27 offsets x cap j-rows — no Newton reactions,
// no atomics, no ghost fold-back, a fixed summation order.  Threads along
// c read neighbouring columns, so each j-row load of a warp is one
// coalesced line.  Tallies (energies, bond sightings, clamps, links)
// reduce per block and then in a one-block finishing pass.


__global__ void stencil_kernel(const float* __restrict__ gx,
                               const int* __restrict__ bid,
                               const uint8_t* __restrict__ hn,
                               const int* __restrict__ pid,
                               const uint8_t* __restrict__ interior,
                               float* __restrict__ gf,
                               float* __restrict__ fpart,
                               int* __restrict__ ipart, StencilArgs a) {
  __shared__ float shf[32];
  __shared__ int shi[32];
  const int cap = a.cap, P = a.P, n = a.n;
  const long capP = (long)cap * P;
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  PairTally tl = {0.f, 0.f, 0, 0};
  int nlink = 0;
  if (t < capP) {
    const int c = (int)(t % P);
    const int bi = bid[t];
    float fx = 0.f, fy = 0.f, fz = 0.f;
    if (interior[c] && bi < n) {
      const float xi = gx[t], yi = gx[capP + t], zi = gx[2 * capP + t];
      const int u1i = hn[t] ? bi + 1 : n + 2;
      const int pi = pid[t];
      nlink = hn[t] ? 1 : 0;
      for (int o = 0; o < 27; ++o) {
        const int cj = c + a.delta[o];  // in [0, P) for interior c
        for (int rj = 0; rj < cap; ++rj) {
          const long j = (long)rj * P + cj;
          const float dx = xi - gx[j];
          const float dy = yi - gx[capP + j];
          const float dz = zi - gx[2 * capP + j];
          const int bj = bid[j];
          const float ffac = pair_force(a, dx, dy, dz, bi, u1i, pi, bj,
                                        hn[j] ? bj + 1 : n + 2, 1, tl);
          fx += dx * ffac;
          fy += dy * ffac;
          fz += dz * ffac;
        }
      }
    }
    gf[t] = fx;
    gf[capP + t] = fy;
    gf[2 * capP + t] = fz;
  }
  block_tallies(tl, nlink, fpart, ipart, shf, shi);
}

// ---------------------------------------------------------------------
// extruder_springs <- pallas_step.py:776-930 (K2c), the math of
// engine.make_extruder_pass (engine.py:857-897)
//
// Bound: launch latency — at most 1024 springs, 12 scattered loads and 6
// atomic adds each.  Design: one thread per extruder slot gathers both
// anchors, takes the minimum image and adds +-force to the anchors'
// slots.  A bead carries at most one anchor (state.py:130-133), so the
// targets are unique and the atomics never contend; they only make a
// broken invariant safe.  Replaces the TPU one-hot-matmul block tables.


__global__ void springs_kernel(const float* __restrict__ gx,
                               float* __restrict__ gf,
                               const int* __restrict__ exl,
                               const int* __restrict__ exr,
                               const uint8_t* __restrict__ active,
                               float* __restrict__ eb_out, SpringArgs a) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
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

// ---------------------------------------------------------------------
// langevin_kick_monitor <- pallas_step.py:932-1000 (K2d + K2e);
// engine.py:1398-1455, with fix langevin's group (the weight w = valid *
// lgm, pallas_step.py:722-723) and zero (pallas_step.py:953-958)
//
// Bound: device-memory bytes plus the threefry integer work (3 x 20
// rounds per slot).  Design: one thread per slot draws its three noise
// words, applies the Langevin force and the final kick, and computes its
// squared displacement since the rebuild and its look-ahead; per-block
// top-2 / max, then a one-block finishing pass.  Without zero and group
// that is the whole kernel (the group weight is the valid mask).
//
// zero needs the grid-wide sum of noise * w before any slot can apply
// its force, so it adds a pass before: per block the three sums of
// noise * w and the sum of the group plane (members only draw their
// words), then a one-block pass that reduces the partials in a fixed
// order (no atomics: bitwise the same run to run) into the three means.
// The main pass then recomputes each slot's words rather than reading
// stored noise planes: ~230 integer operations a slot again (threefry is
// ~77 a word), against 12 B a slot written and read back; the main pass
// is bound by its 76 B a slot, under which the integer work runs.


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

__device__ __forceinline__ float lan_noise(const LangevinArgs& a, int b,
                                           int k) {
  const unsigned int x0 =
      threefry_x0(a.k0, a.k1, (unsigned int)b, a.base + (unsigned int)k);
  return (float)(x0 >> 8) * (1.f / 16777216.f) - 0.5f;
}

// zero, first pass: per block the sums of noise * w (3) and of the group
// plane; w == 0 slots add exactly 0, so they draw no words
__global__ void langevin_sum_kernel(const int* __restrict__ bid,
                                    const uint8_t* __restrict__ interior,
                                    const float* __restrict__ lgm,
                                    float* __restrict__ part,
                                    LangevinArgs a) {
  __shared__ float sh[32];
  const long capP = (long)a.cap * a.P;
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  float s[3] = {0.f, 0.f, 0.f}, cnt = 0.f;
  if (t < capP) {
    const int b = bid[t];
    const float vf = (interior[t % a.P] && b < a.n) ? 1.f : 0.f;
    cnt = a.group ? lgm[t] : 0.f;
    const float w = a.group ? vf * cnt : vf;
    if (w != 0.f)
      for (int k = 0; k < 3; ++k) s[k] = lan_noise(a, b, k) * w;
  }
  for (int k = 0; k < 3; ++k) {
    const float r = block_sum(s[k], sh);
    if (threadIdx.x == 0) part[4 * blockIdx.x + k] = r;
  }
  cnt = block_sum(cnt, sh);
  if (threadIdx.x == 0) part[4 * blockIdx.x + 3] = cnt;
}

// zero, finishing pass (one block): the partials reduced in a fixed
// order, then the means sum * inv_cnt, inv_cnt = 1 / max(sum lgm, 1) with
// a group and 1/n without (engine.py:1428-1434)
__global__ void langevin_mean_kernel(const float* __restrict__ part,
                                     int nblocks, float* __restrict__ mean,
                                     LangevinArgs a) {
  __shared__ float sh[32];
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  for (int b = threadIdx.x; b < nblocks; b += blockDim.x)
    for (int k = 0; k < 4; ++k) s[k] += part[4 * b + k];
  for (int k = 0; k < 4; ++k) s[k] = block_sum(s[k], sh);
  if (threadIdx.x == 0) {
    const float inv = a.group ? 1.f / fmaxf(s[3], 1.f) : a.inv_n;
    for (int k = 0; k < 3; ++k) mean[k] = s[k] * inv;
  }
}

__global__ void langevin_kernel(const float* __restrict__ gx,
                                const float* __restrict__ gxr,
                                const float* __restrict__ gv,
                                const float* __restrict__ gf,
                                const int* __restrict__ bid,
                                const uint8_t* __restrict__ interior,
                                const float* __restrict__ lgm,
                                const float* __restrict__ mean,
                                float* __restrict__ gf_out,
                                float* __restrict__ gv_out,
                                float* __restrict__ part, LangevinArgs a) {
  __shared__ float sh[32];
  const long capP = (long)a.cap * a.P;
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  float dsq = 0.f, pred = 0.f;
  if (t < capP) {
    const int c = (int)(t % a.P);
    const int b = bid[t];
    const bool valid = interior[c] && b < a.n;
    const float vf = valid ? 1.f : 0.f;
    const float wl = a.group ? vf * lgm[t] : vf;
    float vn[3], d[3];
    for (int k = 0; k < 3; ++k) {
      const long i = k * capP + t;
      const float v = gv[i];
      float f = gf[i];
      if (a.langevin) {
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
}

// global top-2 from the block pairs: M = max m1_b, and the largest value
// != M is m1_b where m1_b != M, else m2_b (engine.py:1311-1312)
__global__ void langevin_finish_kernel(const float* __restrict__ part,
                                       int nblocks, float bad_cut,
                                       float trig_cut,
                                       long long* __restrict__ out) {
  __shared__ float sh[32];
  float m = 0.f, p = 0.f;
  for (int b = threadIdx.x; b < nblocks; b += blockDim.x) {
    m = fmaxf(m, part[3 * b]);
    p = fmaxf(p, part[3 * b + 2]);
  }
  const float M = block_bcast(block_max(m, sh), sh);
  p = block_max(p, sh);
  float m2 = 0.f;
  for (int b = threadIdx.x; b < nblocks; b += blockDim.x)
    m2 = fmaxf(m2, part[3 * b] != M ? part[3 * b] : part[3 * b + 1]);
  m2 = block_max(m2, sh);
  if (threadIdx.x == 0) {
    out[0] = (sqrtf(M) + sqrtf(m2) > bad_cut) ? 4 : 0;
    out[1] = p > trig_cut ? 1 : 0;
  }
}

}  // namespace

// ---------------------------------------------------------------------
// C entry points (bound with ctypes by lammps_le_torch/fast/kernels.py)

extern "C" {

int lle_kick_drift_halo(const float* gx, const float* gv, const float* gf,
                        const int* bid, const uint8_t* interior,
                        const int* halo_cols, const int* halo_src,
                        const float* halo_shift, float* gx_out,
                        float* gv_out, int cap, int P, int H, int n,
                        float kick, float dt, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long capP = (long)cap * P;
  kick_drift_kernel<<<blocks_for(capP), kThreads, 0, s>>>(
      gx, gv, gf, bid, interior, gx_out, gv_out, cap, P, n, kick, dt);
  if (H > 0)
    halo_kernel<<<blocks_for((long)H * cap), kThreads, 0, s>>>(
        gx_out, halo_cols, halo_src, halo_shift, H, cap, P);
  return (int)cudaGetLastError();
}

// blocks of a one-thread-per-item launch: the size of the per-block
// partial buffers the wrappers allocate
int lle_blocks(long work) { return blocks_for(work); }

int lle_stencil_forces(const float* gx, const int* bid, const uint8_t* hn,
                       const int* pid, const uint8_t* interior, float* gf,
                       float* fpart, int* ipart, float* en, long long* out,
                       StencilArgs a, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nb = blocks_for((long)a.cap * a.P);
  stencil_kernel<<<nb, kThreads, 0, s>>>(gx, bid, hn, pid, interior, gf,
                                         fpart, ipart, a);
  stencil_finish_kernel<<<1, kThreads, 0, s>>>(fpart, ipart, nb, en, out);
  return (int)cudaGetLastError();
}

int lle_extruder_springs(const float* gx, float* gf, const int* exl,
                         const int* exr, const uint8_t* active, float* eb,
                         SpringArgs a, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (a.E > 0)
    springs_kernel<<<blocks_for(a.E), kThreads, 0, s>>>(gx, gf, exl, exr,
                                                        active, eb, a);
  return (int)cudaGetLastError();
}

// zpart: with zero, 4 partials a block and the 3 means after them
int lle_langevin_kick_monitor(const float* gx, const float* gxr,
                              const float* gv, const float* gf,
                              const int* bid, const uint8_t* interior,
                              const float* lgm, float* gf_out, float* gv_out,
                              float* part, float* zpart, long long* out,
                              LangevinArgs a, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nb = blocks_for((long)a.cap * a.P);
  const float* mean = nullptr;
  if (a.langevin && a.zero) {
    langevin_sum_kernel<<<nb, kThreads, 0, s>>>(bid, interior, lgm, zpart,
                                                a);
    langevin_mean_kernel<<<1, kThreads, 0, s>>>(zpart, nb, zpart + 4 * nb,
                                                a);
    mean = zpart + 4 * nb;
  }
  langevin_kernel<<<nb, kThreads, 0, s>>>(gx, gxr, gv, gf, bid, interior,
                                          lgm, mean, gf_out, gv_out, part,
                                          a);
  langevin_finish_kernel<<<1, kThreads, 0, s>>>(part, nb, a.bad_cut,
                                                a.trig_cut, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
