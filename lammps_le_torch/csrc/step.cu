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

#include <cuda_runtime.h>
#include <stdint.h>

// kernel arguments, passed by value (mirrored by the ctypes Structures of
// lammps_le_torch/fast/kernels.py); at file scope so the C entry points
// taking them keep external linkage

struct StencilArgs {
  float lj1, lj2, lj3, lj4, cutsq, offe, floorsq;
  float inv_r0sq, neg_kf, sigf_sq, wca_cutsq, wca_floorsq, f_wca, e_wca;
  float epsf, e_fene, bond_reach_sq;
  int has_bond, wca_is_lj, energy;
  int cap, P, n;
  int delta[27];
};

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
  float e_lj = 0.f, e_b = 0.f;
  int nb = 0, ncl = 0, nlink = 0;
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
          const float rsq = dx * dx + dy * dy + dz * dz;
          const int bj = bid[j];
          const int u1j = hn[j] ? bj + 1 : n + 2;
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
            e_lj += r6 * (a.lj3 * r6 - a.lj4) - a.offe;
          if (w_b_m) {
            float rlog = 1.f - rsq * a.inv_r0sq;
            if (rlog < 0.1f) {
              ++ncl;
              rlog = 0.1f;
            }
            float fb = a.neg_kf / rlog;
            const float sr2 = a.sigf_sq * r2;
            const float sr6 = sr2 * sr2 * sr2;
            const bool wca = rsq < a.wca_cutsq;
            if (!a.wca_is_lj && wca)
              fb = fb + a.f_wca * sr6 * (sr6 - 0.5f) * r2;
            ffac = ffac + fb;
            ++nb;
            if (a.energy)
              e_b += a.e_fene * logf(rlog) +
                     (wca ? a.e_wca * sr6 * (sr6 - 1.f) + a.epsf : 0.f);
          }
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
  e_lj = block_sum(e_lj, shf);
  e_b = block_sum(e_b, shf);
  nb = block_sum_int(nb, shi);
  ncl = block_sum_int(ncl, shi);
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
// engine.py:1398-1455
//
// Bound: device-memory bytes plus the threefry integer work (3 x 20
// rounds per slot).  Design: one thread per slot draws its three noise
// words, applies the Langevin force and the final kick, and computes its
// squared displacement since the rebuild and its look-ahead; per-block
// top-2 / max, then a one-block finishing pass.


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

__global__ void langevin_kernel(const float* __restrict__ gx,
                                const float* __restrict__ gxr,
                                const float* __restrict__ gv,
                                const float* __restrict__ gf,
                                const int* __restrict__ bid,
                                const uint8_t* __restrict__ interior,
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
    float vn[3], d[3];
    for (int k = 0; k < 3; ++k) {
      const long i = k * capP + t;
      const float v = gv[i];
      float f = gf[i];
      if (a.langevin) {
        const unsigned int x0 =
            threefry_x0(a.k0, a.k1, (unsigned int)b, a.base + (unsigned int)k);
        const float noise = (float)(x0 >> 8) * (1.f / 16777216.f) - 0.5f;
        f = f + (a.gamma1 * v + a.gamma2 * noise) * vf;
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

int blocks_for(long work) { return (int)((work + kThreads - 1) / kThreads); }

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

int lle_langevin_kick_monitor(const float* gx, const float* gxr,
                              const float* gv, const float* gf,
                              const int* bid, const uint8_t* interior,
                              float* gf_out, float* gv_out, float* part,
                              long long* out, LangevinArgs a, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nb = blocks_for((long)a.cap * a.P);
  langevin_kernel<<<nb, kThreads, 0, s>>>(gx, gxr, gv, gf, bid, interior,
                                          gf_out, gv_out, part, a);
  langevin_finish_kernel<<<1, kThreads, 0, s>>>(part, nb, a.bad_cut,
                                                a.trig_cut, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
