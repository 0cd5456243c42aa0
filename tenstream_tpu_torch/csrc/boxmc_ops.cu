// Hand-written Hopper kernel for BoxMC photon tracing.
//
// K4 boxmc_trace replaces the TPU kernel
//   tenstream_tpu/boxmc/pallas_tracer.py::_make_kernel.<kernel> (run_boxmc_pallas)
//
// Each launch row is one (entry, source) with BOXMC_PHOTONS photons that
// enter the box through the source face (direct: the sun's direction;
// diffuse: Lambertian about the inward normal, optionally restricted to one
// z hemisphere), walk with scattering-only free paths and implicit
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
// them) and four hashes.  Walks differ in length by three orders of
// magnitude (a transparent box: one step; tau 100 and w0 0.99999: up to
// max_iter = 3000), so what wastes the card is idle lanes: a warp that
// waits for its slowest photon, a block that waits for its slowest entry,
// and a launch that waits for its slowest block.
//
// Design: photons, not entries, are the unit of work.  A launch runs three
// kernels.
//  1. boxmc_entry_kernel: each entry's starting constants (extinction,
//     hash seed, source face, the sun's direction), once per entry.
//  2. boxmc_trace_kernel: a persistent grid (as many blocks as fit on the
//     card) walks the launch's B * BOXMC_PHOTONS photons from one queue in
//     (entry, lane) order, the entries in the wrapper's order: longest
//     expected walks first, so that they overlap the many short ones instead
//     of ending the launch alone (the order changes no result).  A lane
//     holds one photon and does one step of it per loop trip; when its
//     photon exits, dies or reaches max_iter, the lane writes the photon's
//     record (a code byte and a weight) and takes the next photon from its
//     warp's pool (__ballot_sync / __popc give each idle lane its place).
//     A warp claims kChunk queue positions with one integer atomicAdd, a
//     chunk ahead of need, so that neither the atomic's latency nor one
//     counter shared by every warp on the card sets the pace.  A thick
//     entry's photons spread over the whole card.  Photon-steps add up per
//     entry in int64 atomics (exact in any order), and each warp adds its
//     loop trips to one counter once: photon-steps / (32 * trips) is the
//     lanes' utilisation.
//  3. boxmc_reduce_kernel: one block of 256 threads per entry sums the
//     records in a fixed order (thread t adds photons t, t + 256, ... in
//     turn, then a fixed tree, then the scattered mass in code order), so a
//     seed gives bit-identical rows every run, whatever order the photons
//     were walked in.  It is the order of the former one-block-per-entry
//     kernel, whose tallies these are bit for bit.
// What is left: a warp's lanes diverge between a step that exits (short)
// and one that scatters (long), and a launch lasts at least as long as its
// longest walk (up to max_iter steps on one lane).

// Arithmetic follows the JAX expressions term by term in IEEE float32:
// no fast math, logf/expf/sinf/cosf/sqrtf and IEEE division, and every
// product that feeds a sum is __fmul_rn, which the compiler never fuses
// into an FMA, so the walk rounds as the plain PyTorch version's does.

#include <stdint.h>

#include <algorithm>
#include <atomic>

#include "boxmc_ops.h"

namespace {

constexpr int kThreads = 256;  // both kernels; the reduction order depends on it
constexpr int kTraceBlocksPerSM = 4;  // 64 registers a thread: 32 warps an SM
constexpr int kChunk = 256;  // queue positions a warp claims at once (eight photons a lane)
constexpr int kMaxDevices = 64;  // device ordinals whose launch size is cached
constexpr int kCodeNone = 255;  // record: died in the roulette, or an exit tallied nowhere
constexpr int kCodeLeft = 254;  // record: still walking at max_iter
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

// What a photon of an entry starts from, computed once per entry by
// boxmc_entry_kernel with the same expressions (and so the same bits) as if
// each photon computed them itself.
struct __align__(16) EntryConsts {
  float bz, ksca, kabs, g;
  float sdx, sdy, sdz, zsign;  // the sun's direction (direct sources)
  uint32_t base;               // the hash's seed and row
  int face;
  int pad[2];
};

template <bool LDIR>
__global__ void __launch_bounds__(kThreads)
boxmc_entry_kernel(const float* __restrict__ params, EntryConsts* __restrict__ ec, int batch) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const float* pr = params + (size_t)b * BOXMC_NPARAM;
  const float tauz = pr[0], w0 = pr[1], aspect = pr[2];
  const float face_f = pr[7];
  EntryConsts e;
  e.face = face_f < 0.5f ? 0 : face_f < 1.5f ? 1 : face_f < 2.5f ? 2
         : face_f < 3.5f ? 3 : face_f < 4.5f ? 4 : 5;
  // the launch row is the hash's program id, as in the TPU kernel's grid
  e.base = ((uint32_t)(int)pr[6] * 747796405u + (uint32_t)b) | 1u;
  e.g = pr[3];
  e.bz = fmaxf(aspect, 1e-6f);
  const float kext = tauz / e.bz;
  e.ksca = w0 * kext;
  e.kabs = (1.f - w0) * kext;
  e.zsign = pr[8];
  e.sdx = e.sdy = e.sdz = 0.f;
  if (LDIR) {
    const float phi = pr[4] * kDeg2Rad, theta = pr[5] * kDeg2Rad;
    e.sdx = sinf(phi) * sinf(theta);
    e.sdy = cosf(phi) * sinf(theta);
    e.sdz = -cosf(theta);
  }
  e.pad[0] = e.pad[1] = 0;
  ec[b] = e;
}

template <bool LDIR>
__global__ void __launch_bounds__(kThreads, kTraceBlocksPerSM)
boxmc_trace_kernel(const EntryConsts* __restrict__ ec, const int* __restrict__ order,
                   uint8_t* __restrict__ rec_code,
                   float* __restrict__ rec_w, unsigned long long* __restrict__ steps,
                   unsigned int* __restrict__ queue, unsigned long long* __restrict__ trips_out,
                   const BoxTables t, int max_iter, unsigned int total) {
  __shared__ int s_tab[18];  // dir_code, diff_dn, diff_up
  if (threadIdx.x < 6) {
    s_tab[threadIdx.x] = t.dir_code[threadIdx.x];
    s_tab[6 + threadIdx.x] = t.diff_dn[threadIdx.x];
    s_tab[12 + threadIdx.x] = t.diff_up[threadIdx.x];
  }
  __syncthreads();

  const unsigned lane_id = threadIdx.x & 31u;
  const unsigned lt_mask = (1u << lane_id) - 1u;
  const float eps = 1e-6f;

  // the photon this lane holds
  bool have = false;
  unsigned int pid = 0;
  int b = -1;
  uint32_t ln = 0, base = 0;
  float bz = 0.f, ksca = 0.f, kabs = 0.f, g = 0.f;
  float px = 0.f, py = 0.f, pz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f, w = 0.f;
  bool scattered = false;
  int i = 0;
  // photon-steps of entry acc_b not yet added to steps[acc_b]
  int acc_b = -1;
  unsigned long long acc_steps = 0;
  // the warp's claimed queue positions [pool, pool_end), and the start of
  // the next chunk, claimed ahead (in lane 0 only, so that the atomic's
  // latency hides behind the steps until the pool runs short); the queue is
  // empty once a chunk starts at or beyond total
  unsigned pool = 0, pool_end = 0;
  unsigned next_chunk = lane_id == 0 ? atomicAdd(queue, (unsigned)kChunk) : 0u;
  bool exhausted = false;
  unsigned long long trips = 0;

  while (true) {
    // idle lanes take the next photons: from the warp's pool, and when that
    // runs short from a new chunk of the queue (one atomicAdd per kChunk)
    const unsigned need = __ballot_sync(0xffffffffu, !have);
    if (need != 0u && (pool < pool_end || !exhausted)) {
      const unsigned n = (unsigned)__popc(need);
      const unsigned rank = (unsigned)__popc(need & lt_mask);
      const unsigned avail = pool_end - pool;
      unsigned q = pool + rank;
      if (avail >= n) {
        pool += n;
      } else {
        unsigned start = total;
        if (!exhausted) {
          start = __shfl_sync(0xffffffffu, next_chunk, 0);
          exhausted = start + kChunk >= total;
          if (!exhausted && lane_id == 0) next_chunk = atomicAdd(queue, (unsigned)kChunk);
        }
        if (rank >= avail) q = start + (rank - avail);
        pool = start + (n - avail);
        pool_end = start >= total ? start : min(start + (unsigned)kChunk, total);
        if (pool > pool_end) pool = pool_end;
      }
      if (!have && q < total && (rank < avail || q < pool_end)) {
        const unsigned j = q / BOXMC_PHOTONS;  // the queue takes entries in the given order
        b = order[j];
        ln = q - j * BOXMC_PHOTONS;
        pid = (unsigned)b * BOXMC_PHOTONS + ln;
        const EntryConsts e = ec[b];
        const int face = e.face;
        base = e.base;
        g = e.g;
        bz = e.bz;
        ksca = e.ksca;
        kabs = e.kabs;

        const float u1 = hash_uniform(ln, base, 0u, 0u);
        const float u2 = hash_uniform(ln, base, 0u, 1u);
        px = face_select(face, u1, u1, eps, 1.f - eps, u1, u1);
        py = face_select(face, u2, u2, u2, u2, eps, 1.f - eps);
        pz = face_select(face, bz * (1.f - eps), bz * eps, u1 * bz, u1 * bz, u2 * bz, u2 * bz);
        if (LDIR) {
          dx = e.sdx;
          dy = e.sdy;
          dz = e.sdz;
        } else {
          const float mu = sqrtf(hash_uniform(ln, base, 0u, 2u));
          const float sphi = hash_uniform(ln, base, 0u, 3u) * kTwoPi;
          const float st = sqrtf(fmaxf(0.f, 1.f - __fmul_rn(mu, mu)));
          const float a = st * cosf(sphi);
          const float bb = st * sinf(sphi);
          const float zsign = e.zsign;
          dx = face_select(face, a, a, mu, -mu, a, a);
          dy = face_select(face, bb, bb, a, a, mu, -mu);
          dz = face_select(face, -mu, mu, bb, bb, bb, bb);
          dz = zsign > 0.5f ? fabsf(dz) : (zsign < -0.5f ? -fabsf(dz) : dz);
        }
        w = 1.f;
        scattered = false;
        i = 0;
        have = true;
      }
    }
    if (!__any_sync(0xffffffffu, have)) break;
    ++trips;
    if (!have) continue;

    // one step of the photon this lane holds
    int code = -2;  // -2: still walking
    unsigned nst = 0;
    if (i < max_iter) {
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
        const int diffcode = dz > 0.f ? s_tab[12 + f] : s_tab[6 + f];
        const int c = (LDIR && !scattered) ? s_tab[f] : diffcode;
        code = c < 0 ? kCodeNone : c;
        nst = (unsigned)i + 1u;
      } else {
        rotate_about(dx, dy, dz, hg_costheta(hash_uniform(ln, base, ctr, 1u), g),
                     hash_uniform(ln, base, ctr, 2u) * kTwoPi);
        scattered = true;
        if (w < kRoulette) {
          if (hash_uniform(ln, base, ctr, 3u) < kSurvive) {
            w = w / kSurvive;
          } else {
            code = kCodeNone;  // died in the roulette
            nst = (unsigned)i + 1u;
          }
        }
        if (code == -2) ++i;
      }
    }
    if (code == -2 && i >= max_iter) {  // still walking at max_iter
      code = kCodeLeft;
      nst = (unsigned)i;
    }
    if (code != -2) {
      rec_code[pid] = (uint8_t)code;
      rec_w[pid] = code == kCodeNone ? 0.f : w;
      if (b != acc_b) {
        if (acc_b >= 0 && acc_steps) atomicAdd(steps + acc_b, acc_steps);
        acc_b = b;
        acc_steps = 0;
      }
      acc_steps += nst;
      have = false;
    }
  }
  if (acc_b >= 0 && acc_steps) atomicAdd(steps + acc_b, acc_steps);
  if (lane_id == 0) atomicAdd(trips_out, trips);
}

template <int NDIR, int NC>
__global__ void __launch_bounds__(kThreads)
boxmc_reduce_kernel(const uint8_t* __restrict__ rec_code, const float* __restrict__ rec_w,
                    float* __restrict__ out) {
  __shared__ float s_acc[NC + 1][kThreads];  // tallies per code, then the leftover
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const uint8_t* rc = rec_code + (size_t)b * BOXMC_PHOTONS;
  const float* rw = rec_w + (size_t)b * BOXMC_PHOTONS;

  float acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = 0.f;
  float left = 0.f;
  for (int lane = tid; lane < BOXMC_PHOTONS; lane += kThreads) {
    const int code = rc[lane];
    const float w = rw[lane];
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c] += c == code ? w : 0.f;
    left += code == kCodeLeft ? w : 0.f;
  }

#pragma unroll
  for (int c = 0; c < NC; ++c) s_acc[c][tid] = acc[c];
  s_acc[NC][tid] = left;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (tid < stride) {
#pragma unroll
      for (int c = 0; c <= NC; ++c) s_acc[c][tid] += s_acc[c][tid + stride];
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
  }
}

template <bool LDIR>
cudaError_t launch_trace(const BoxmcLaunch* a, int max_iter, cudaStream_t stream) {
  // blocks resident on the current card, once per device ordinal
  static std::atomic<int> cached[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int grid_max = dev < kMaxDevices ? cached[dev].load() : 0;
  if (grid_max == 0) {
    int nsm = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, boxmc_trace_kernel<LDIR>,
                                                          kThreads, 0);
    if (err != cudaSuccess) return err;
    grid_max = nsm * (per_sm > 0 ? per_sm : 1);
    if (dev < kMaxDevices) cached[dev].store(grid_max);
  }
  const unsigned total = (unsigned)a->batch * BOXMC_PHOTONS;
  EntryConsts* ec = (EntryConsts*)a->entry_scratch;
  boxmc_entry_kernel<LDIR><<<(a->batch + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      a->params, ec, a->batch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int grid = (int)std::min<long>(grid_max, ((long)total + kThreads - 1) / kThreads);
  boxmc_trace_kernel<LDIR><<<grid, kThreads, 0, stream>>>(
      ec, a->order, a->rec_code, a->rec_w, (unsigned long long*)a->steps, a->queue,
      (unsigned long long*)a->trips, *a->tables, max_iter, total);
  return cudaGetLastError();
}

template <int NDIR, int NDIFF>
cudaError_t launch_reduce(const BoxmcLaunch* a, cudaStream_t stream) {
  boxmc_reduce_kernel<NDIR, NDIR + NDIFF><<<a->batch, kThreads, 0, stream>>>(
      a->rec_code, a->rec_w, a->out);
  return cudaGetLastError();
}

cudaError_t launch_reduce_layout(const BoxmcLaunch* a, int ndir, int ndiff, cudaStream_t stream) {
  if (ndir == 1 && ndiff == 2) return launch_reduce<1, 2>(a, stream);
  if (ndir == 3 && ndiff == 6) return launch_reduce<3, 6>(a, stream);
  if (ndir == 3 && ndiff == 10) return launch_reduce<3, 10>(a, stream);
  if (ndir == 8 && ndiff == 10) return launch_reduce<8, 10>(a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int boxmc_layout_ok(int ndir, int ndiff) {
  return (ndir == 1 && ndiff == 2) || (ndir == 3 && ndiff == 6) || (ndir == 3 && ndiff == 10) ||
         (ndir == 8 && ndiff == 10);
}

extern "C" int boxmc_entry_scratch_bytes(void) { return (int)sizeof(EntryConsts); }

extern "C" cudaError_t launch_boxmc_trace(const BoxmcLaunch* a, int ldir, int ndir, int ndiff,
                                          int max_iter, cudaStream_t stream) {
  if (a->batch <= 0) return cudaSuccess;
  if (!boxmc_layout_ok(ndir, ndiff)) return cudaErrorInvalidValue;
  cudaError_t err = ldir ? launch_trace<true>(a, max_iter, stream)
                         : launch_trace<false>(a, max_iter, stream);
  if (err != cudaSuccess) return err;
  return launch_reduce_layout(a, ndir, ndiff, stream);
}
