// Hand-written Hopper kernel for BoxMC photon tracing.
//
// K4 boxmc_trace replaces the TPU kernel
//   tenstream_tpu/boxmc/pallas_tracer.py::_make_kernel.<kernel> (run_boxmc_pallas)
//
// One (entry, source) per block: BOXMC_PHOTONS photons enter the box
// through the source face (direct: the sun's direction; diffuse:
// Lambertian about the inward normal, optionally restricted to one z
// hemisphere), walk with scattering-only free paths and implicit
// absorption (weight *= exp(-kabs * path)), scatter by Henyey-Greenstein,
// die by weight roulette (below 1e-4, survive with p 0.5 at twice the
// weight), and are tallied by exit face into T (ndir) / S (ndiff).  Weight
// still walking after max_iter steps is spread over the diffuse tallies in
// proportion (truncation redistribution).  All random numbers come from the
// TPU kernel's counter hash of (photon lane, seed and row, step, salt), so
// a photon's walk depends on nothing but its own counters.
//
// What bounds it on an H100: operations.  An entry reads 36 bytes and
// writes 4 * (ndir + ndiff); each photon-step does about 90 float32
// operations (a log, an exp, a sin/cos pair and three square roots among
// them) and four hashes, so bytes never matter.
//
// Design: one block of 256 threads per entry, each thread walks photons
// lane = tid, tid + 256, ... to their end in registers, and adds each
// photon's weight to a per-thread tally as it exits.  The TPU kernel kept
// all 5120 photons in lockstep in VMEM and reduced exit codes after its
// loop; a per-photon walk needs no alive masks and stops at the exit (the
// lockstep version keeps "moving" an exited photon by ~0 each step, which
// changes its weight by ulps).  The block reduces its tallies, leftover
// weight and photon-steps in shared memory by a fixed tree, with no float
// atomics, so a seed gives bit-identical rows every run.  A warp runs until
// its slowest photon dies: thick conservative entries walk to max_iter
// (divergence and imbalance are this design's cost).
//
// Arithmetic follows the JAX expressions term by term in IEEE float32:
// no fast math, logf/expf/sinf/cosf/sqrtf and IEEE division, and every
// product that feeds a sum is __fmul_rn, which the compiler never fuses
// into an FMA, so the walk rounds as the plain PyTorch version's does.

#include <stdint.h>

#include "boxmc_ops.h"

namespace {

constexpr int kThreads = 256;
constexpr float kBig = 1e30f;
constexpr float kRoulette = 1e-4f;
constexpr float kSurvive = 0.5f;
constexpr float kTwoPi = 6.283185307179586f;         // 2 pi rounded to float32
constexpr float kDeg2Rad = 0.017453292519943295f;    // pi / 180 rounded to float32
constexpr float kNorm = 1.0f / (float)BOXMC_PHOTONS;

// murmur3-finalizer-style hash of (lane, base, ctr, salt) in uint32: the
// TPU kernel's int32 arithmetic (pallas_tracer.py::_hash_uniform), whose
// multiplications wrap as these do; >> is its masked logical shift.  The
// constants are the unsigned images of its int32 constants; its last one,
// -2073453131, is 0x84699DB5 (its comment says 0x846CA68B, murmur3's).
__device__ __forceinline__ float hash_uniform(uint32_t lane, uint32_t base, uint32_t ctr,
                                              uint32_t salt) {
  uint32_t x = lane ^ (base * 0x9E3779B9u);
  x = x + ctr * 0x85EBCA6Bu + salt * 0xC2B2AE35u;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x84699DB5u;
  x ^= x >> 16;
  return (float)(x >> 8) * (1.0f / 16777216.0f);  // top 24 bits
}

__device__ __forceinline__ float axis_t(float p, float d, float hi) {
  const bool tiny = fabsf(d) < 1e-12f;
  const float d_safe = tiny ? 1e-12f : d;
  const float bound = d > 0.f ? hi : 0.f;
  const float t = (bound - p) / d_safe;
  return tiny ? kBig : fmaxf(t, 0.f);
}

__device__ __forceinline__ float hg_costheta(float u, float g) {
  const bool iso = fabsf(g) < 1e-4f;
  const float gs = iso ? 0.5f : g;
  const float g2 = __fmul_rn(gs, gs);
  const float frac = (1.f - g2) / ((1.f - gs) + __fmul_rn(2.f * gs, u));
  const float ct = ((1.f + g2) - __fmul_rn(frac, frac)) / (2.f * gs);
  const float r = iso ? __fmul_rn(2.f, u) - 1.f : ct;
  return fminf(fmaxf(r, -1.f), 1.f);
}

// new direction at angle acos(ct) from (dx, dy, dz) with azimuth phi
__device__ __forceinline__ void rotate_about(float& dx, float& dy, float& dz, float ct,
                                             float phi) {
  const float st = sqrtf(fmaxf(0.f, 1.f - __fmul_rn(ct, ct)));
  const float denom = sqrtf(fmaxf(1e-12f, 1.f - __fmul_rn(dz, dz)));
  const bool straight_up = fabsf(dz) > 0.99999f;
  const float ux = straight_up ? 1.f : dy / denom;
  const float uy = straight_up ? 0.f : -dx / denom;
  const float vx = uy * dz;
  const float vy = -ux * dz;
  const float vz = __fmul_rn(ux, dy) - __fmul_rn(uy, dx);
  const float cp = cosf(phi), sp = sinf(phi);
  const float nx = __fmul_rn(st, __fmul_rn(cp, ux) + __fmul_rn(sp, vx)) + __fmul_rn(ct, dx);
  const float ny = __fmul_rn(st, __fmul_rn(cp, uy) + __fmul_rn(sp, vy)) + __fmul_rn(ct, dy);
  const float nz = __fmul_rn(st * sp, vz) + __fmul_rn(ct, dz);
  const float norm =
      sqrtf(fmaxf(__fmul_rn(nx, nx) + __fmul_rn(ny, ny) + __fmul_rn(nz, nz), 1e-30f));
  dx = nx / norm;
  dy = ny / norm;
  dz = nz / norm;
}

__device__ __forceinline__ float face_select(int f, float v0, float v1, float v2, float v3,
                                             float v4, float v5) {
  return f == 0 ? v0 : f == 1 ? v1 : f == 2 ? v2 : f == 3 ? v3 : f == 4 ? v4 : v5;
}

template <bool LDIR, int NDIR, int NDIFF>
__global__ void __launch_bounds__(kThreads)
boxmc_trace_kernel(const float* __restrict__ params, float* __restrict__ out,
                   long long* __restrict__ steps, const BoxTables t, int max_iter) {
  constexpr int NC = NDIR + NDIFF;
  __shared__ float s_acc[NC + 1][kThreads];  // tallies per code, then the leftover
  __shared__ long long s_steps[kThreads];

  const int b = blockIdx.x;
  const float* p = params + (size_t)b * BOXMC_NPARAM;
  const float tauz = p[0], w0 = p[1], aspect = p[2], g = p[3];
  const float face_f = p[7], zsign = p[8];
  const int face = face_f < 0.5f ? 0 : face_f < 1.5f ? 1 : face_f < 2.5f ? 2
                 : face_f < 3.5f ? 3 : face_f < 4.5f ? 4 : 5;
  // the launch row is the hash's program id, as in the TPU kernel's grid
  const uint32_t base = ((uint32_t)(int)p[6] * 747796405u + (uint32_t)b) | 1u;

  const float bz = fmaxf(aspect, 1e-6f);
  const float kext = tauz / bz;
  const float ksca = w0 * kext;
  const float kabs = (1.f - w0) * kext;
  const float eps = 1e-6f;

  float sdx = 0.f, sdy = 0.f, sdz = 0.f;  // the sun's direction
  if (LDIR) {
    const float phi = p[4] * kDeg2Rad, theta = p[5] * kDeg2Rad;
    sdx = sinf(phi) * sinf(theta);
    sdy = cosf(phi) * sinf(theta);
    sdz = -cosf(theta);
  }

  float acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = 0.f;
  float left = 0.f;
  long long nstep = 0;

  for (int lane = threadIdx.x; lane < BOXMC_PHOTONS; lane += kThreads) {
    const uint32_t ln = (uint32_t)lane;
    const float u1 = hash_uniform(ln, base, 0u, 0u);
    const float u2 = hash_uniform(ln, base, 0u, 1u);
    float px = face_select(face, u1, u1, eps, 1.f - eps, u1, u1);
    float py = face_select(face, u2, u2, u2, u2, eps, 1.f - eps);
    float pz = face_select(face, bz * (1.f - eps), bz * eps, u1 * bz, u1 * bz, u2 * bz, u2 * bz);
    float dx, dy, dz;
    if (LDIR) {
      dx = sdx;
      dy = sdy;
      dz = sdz;
    } else {
      const float mu = sqrtf(hash_uniform(ln, base, 0u, 2u));
      const float sphi = hash_uniform(ln, base, 0u, 3u) * kTwoPi;
      const float st = sqrtf(fmaxf(0.f, 1.f - __fmul_rn(mu, mu)));
      const float a = st * cosf(sphi);
      const float bb = st * sinf(sphi);
      dx = face_select(face, a, a, mu, -mu, a, a);
      dy = face_select(face, bb, bb, a, a, mu, -mu);
      dz = face_select(face, -mu, mu, bb, bb, bb, bb);
      dz = zsign > 0.5f ? fabsf(dz) : (zsign < -0.5f ? -fabsf(dz) : dz);
    }
    float w = 1.f;
    bool scattered = false;
    bool dead = false;
    int i = 0;
    for (; i < max_iter; ++i) {
      const uint32_t ctr = (uint32_t)(i + 1);
      const float tx = axis_t(px, dx, 1.f);
      const float ty = axis_t(py, dy, 1.f);
      const float tz = axis_t(pz, dz, bz);
      const float dmax = fminf(tx, fminf(ty, tz));
      const float u = fmaxf(hash_uniform(ln, base, ctr, 0u), 1e-12f);
      const float s_free = ksca > 1e-12f ? -logf(u) / fmaxf(ksca, 1e-12f) : kBig;
      const float travel = fminf(s_free, dmax);
      w = w * expf(-kabs * travel);
      px = px + __fmul_rn(dx, travel);
      py = py + __fmul_rn(dy, travel);
      pz = pz + __fmul_rn(dz, travel);
      if (s_free >= dmax) {  // exits through the face it reached
        const int f = dmax == tz ? (dz > 0.f ? 0 : 1)
                    : dmax == tx ? (dx > 0.f ? 3 : 2) : (dy > 0.f ? 5 : 4);
        const int diffcode = dz > 0.f ? t.diff_up[f] : t.diff_dn[f];
        const int code = (LDIR && !scattered) ? t.dir_code[f] : diffcode;
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[c] += c == code ? w : 0.f;
        dead = true;
        break;
      }
      rotate_about(dx, dy, dz, hg_costheta(hash_uniform(ln, base, ctr, 1u), g),
                   hash_uniform(ln, base, ctr, 2u) * kTwoPi);
      scattered = true;
      if (w < kRoulette) {
        if (hash_uniform(ln, base, ctr, 3u) < kSurvive) {
          w = w / kSurvive;
        } else {
          dead = true;
          break;
        }
      }
    }
    nstep += dead ? i + 1 : i;
    if (!dead) left += w;  // still walking at max_iter
  }

  const int tid = threadIdx.x;
#pragma unroll
  for (int c = 0; c < NC; ++c) s_acc[c][tid] = acc[c];
  s_acc[NC][tid] = left;
  s_steps[tid] = nstep;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (tid < stride) {
#pragma unroll
      for (int c = 0; c <= NC; ++c) s_acc[c][tid] += s_acc[c][tid + stride];
      s_steps[tid] += s_steps[tid + stride];
    }
    __syncthreads();
  }
  if (tid == 0) {
    float s_mass = 0.f;
#pragma unroll
    for (int c = NDIR; c < NC; ++c) s_mass += s_acc[c][0];
    const float leftover = s_acc[NC][0];
    const float scale = s_mass > 0.f ? 1.f + leftover / fmaxf(s_mass, 1e-30f) : 1.f;
    float* o = out + (size_t)b * NC;
#pragma unroll
    for (int c = 0; c < NDIR; ++c) o[c] = s_acc[c][0] * kNorm;
#pragma unroll
    for (int c = NDIR; c < NC; ++c) o[c] = s_acc[c][0] * scale * kNorm;
    steps[b] = s_steps[0];
  }
}

template <bool LDIR, int NDIR, int NDIFF>
cudaError_t launch(const float* params, float* out, long long* steps, const BoxTables* t,
                   int batch, int max_iter, cudaStream_t stream) {
  boxmc_trace_kernel<LDIR, NDIR, NDIFF><<<batch, kThreads, 0, stream>>>(params, out, steps, *t,
                                                                       max_iter);
  return cudaGetLastError();
}

template <bool LDIR>
cudaError_t launch_layout(const float* params, float* out, long long* steps, const BoxTables* t,
                          int ndir, int ndiff, int batch, int max_iter, cudaStream_t stream) {
  if (ndir == 1 && ndiff == 2) return launch<LDIR, 1, 2>(params, out, steps, t, batch, max_iter, stream);
  if (ndir == 3 && ndiff == 6) return launch<LDIR, 3, 6>(params, out, steps, t, batch, max_iter, stream);
  if (ndir == 3 && ndiff == 10) return launch<LDIR, 3, 10>(params, out, steps, t, batch, max_iter, stream);
  if (ndir == 8 && ndiff == 10) return launch<LDIR, 8, 10>(params, out, steps, t, batch, max_iter, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" cudaError_t launch_boxmc_trace(const float* params, float* out, long long* steps,
                                          const BoxTables* t, int ldir, int ndir, int ndiff,
                                          int batch, int max_iter, cudaStream_t stream) {
  if (batch <= 0) return cudaSuccess;
  return ldir ? launch_layout<true>(params, out, steps, t, ndir, ndiff, batch, max_iter, stream)
              : launch_layout<false>(params, out, steps, t, ndir, ndiff, batch, max_iter, stream);
}
