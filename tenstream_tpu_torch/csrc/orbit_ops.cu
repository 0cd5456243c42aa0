// Hand-written Hopper kernels for the diffuse transport operator.
//
// K2 orbit_contract replaces the TPU kernel
//   tenstream_tpu/pprts/pallas_ops.py::_contract_kernel (orbit_contract_pallas)
// K1 fused_A_dots replaces the TPU kernel
//   tenstream_tpu/pprts/pallas_ops.py::_fused_A_kernel (fused_A_dots)
//
// Both are compiled once for each table set of orbit_schemes.h: the orbit
// contraction, the shifts and the closure are compile-time code generated
// from the Python tables (orbit_<scheme>.h, a struct per set), so channel
// indices are immediates and the group sums unroll.  Sets run from 6 dofs
// and 11 orbit channels (3_6) to 30 dofs and 127 channels (3_30).
//
// What bounds them on an H100: bytes.  At 3_10 K2 reads 10 source and 24
// orbit values per cell and writes 10 (44 floats); K1 reads u, w and the
// orbit field and writes A(u) (54 floats per cell).  Both do ~2 flops per
// byte, far below the card's flop/byte balance, so the design goal is to
// touch device memory once per value.
//
// K2 (the simplest correct design): one thread per cell, threads of a block
// contiguous in the flattened cell index, so every load is coalesced.
//
// K1 has two designs, chosen per table set at compile time by whether the
// staged one's shared memory fits a block (3_10 and 3_6 do; 8_12 and up,
// 321-881 KB, do not).
//
// The staged K1 (3_10 and 3_6): 2.5-D blocking, so that each value comes
// from device memory once and each cell's contributions are computed once.
// A block owns a tile of
// kTX x kTY = 8 x 64 face columns (y fastest: every staged row is a run of
// 256 bytes) and marches down a range of z planes; the loop inside the block
// takes the place of the grid's z.  Its 215 KB of shared memory allow one
// block (19 warps) per SM.  For each
// plane it stages in shared memory, with cp.async three planes deep, the 10
// face dofs of u over the tile and a one-column halo on every side (periodic
// in x and y, so halo indices wrap; TMA cannot wrap) and the 24 orbit
// channels of the tile's cells and of the low halo cells.  Then (phase A)
// one thread per cell of the tile and of its low halo forms the cell's 10
// sources and its 10 dst contributions once, into shared memory; and (phase
// B) one thread per face column assembles S at face plane k from the cells
// that produce it (this plane's cell, its low x / y neighbour, and the cell
// above, carried in a register from the previous plane), adds the surface
// closure on face nz, and reads w (loaded a plane ahead, in registers),
// writes A(u) and accumulates the two dots.  (Sizes above are 3_10's.)
//
// The direct K1 (the larger sets): the same two phases per face plane, with
// only the contributions in shared memory (double-buffered, one barrier per
// plane: at 3_30 2 x 30 x 297 floats, 71 KB).  A block owns 8 x 32 face
// columns and 320 threads: 256 for the tile's cells and faces (a warp per
// row of 32 columns), 41 for the low halo's cells.  Phase A reads a cell's
// sources from u and its orbit channels straight from device memory (u
// through the read-only path, where the neighbouring cells' and phase B's
// reads of the same lines hit; the orbit field and w streamed, read once).
// The low halo's cells are computed twice, by this tile and their own
// (297 cells per 256 faces).
//
// In both, a block whose z range starts below the top first computes the
// plane above it, for the carried contribution.
//
// Halo mode (halo = 1, a rank's block of a decomposed field): u and the
// orbit field come padded by a one-cell ring that the neighbouring ranks
// filled, (nx + 2) x (ny + 2) per plane, and their halo indices read the
// ring instead of wrapping; w, albedo and A(u) are the block's.  Rows and
// columns past the ring are clamped to it: they feed only cells whose
// faces lie outside the block.  Nothing else changes, so on a rank that is
// its own neighbour the outputs equal the periodic launch's bit for bit.  The dots reduce per block
// into a partials buffer that a second one-block-per-batch kernel sums in a
// fixed order, so the result is deterministic.  Accumulation is float32
// like the JAX code.

#include <algorithm>
#include <atomic>

#include "orbit_schemes.h"
#include "orbit_tables.h"

namespace {

constexpr int kThreads = 256;  // K2 and the partials reduction

// the staged K1's blocking
constexpr int kTX = 8, kTY = 64;             // a block's tile of face columns, y fastest
constexpr int kRX = kTX + 2, kRY = kTY + 2;  // u region: the tile and a one-column halo
constexpr int kCX = kTX + 1, kCY = kTY + 1;  // cell region: the tile and the low halo
constexpr int kCells = kCX * kCY;
constexpr int kK1Threads = 608;              // >= kCells (585), a whole number of warps
constexpr int kUSlots = 3;                   // u planes k, k + 1 and the one in flight
constexpr int kOSlots = 2;
constexpr int kMinPlanes = 4;                // the fewest face planes a block marches over
constexpr int kMaxDevices = 64;              // device ordinals whose occupancy is cached
constexpr size_t kMaxSmem = 227 * 1024;      // a block's shared memory on sm_90

// the staged design's plane sizes (floats) and shared memory for table set T
template <class T> struct Staged {
  static constexpr int kUPlane = T::K1_ND * kRX * kRY;  // one staged u plane
  static constexpr int kOPlane = T::K1_NORB * kCells;   // one staged orbit plane
  static constexpr int kCPlane = T::K1_ND * kCells;     // one plane of contributions
  static constexpr size_t kSmem = sizeof(float) * (kUSlots * kUPlane + kOSlots * kOPlane + kCPlane);
  static constexpr bool kFits = kSmem <= kMaxSmem;
};

// the direct design's blocking
constexpr int kDX = 8, kDY = 32;             // a block's tile of face columns, y fastest
constexpr int kDCX = kDX + 1, kDCY = kDY + 1;  // cell region: the tile and the low halo
constexpr int kDCells = kDCX * kDCY;
constexpr int kDThreads = 320;               // >= kDCells (297), a whole number of warps
template <class T> constexpr size_t direct_smem() {
  return sizeof(float) * 2 * T::K1_ND * kDCells;
}

// both designs need: sources read at the cell's face or one above it
// (gshift in {0, 1}), dsts landing on the cell's face or one below it
// (cshift in {0, -1}), and a dst from the cell above only in its own column
template <class T> constexpr bool k1_shifts_ok() {
  for (int q = 0; q < T::K1_ND; ++q) {
    if (T::k1_gz(q) < 0 || T::k1_gz(q) > 1 || T::k1_gx(q) < 0 || T::k1_gx(q) > 1 ||
        T::k1_gy(q) < 0 || T::k1_gy(q) > 1)
      return false;
    if (T::k1_cz(q) < -1 || T::k1_cz(q) > 0 || T::k1_cx(q) < -1 || T::k1_cx(q) > 0 ||
        T::k1_cy(q) < -1 || T::k1_cy(q) > 0)
      return false;
    if (T::k1_cz(q) == -1 && (T::k1_cx(q) != 0 || T::k1_cy(q) != 0)) return false;
  }
  return true;
}
#define K1_CHECK_SHIFTS(q, T) \
  static_assert(k1_shifts_ok<T>(), #T ": shifts outside what K1's blocking handles");
TS_ORBIT_SCHEMES(K1_CHECK_SHIFTS)
#undef K1_CHECK_SHIFTS
static_assert(kCells <= kK1Threads && kTX * kTY <= kK1Threads && kK1Threads % 32 == 0,
              "K1 block too small");
static_assert(kTY % 32 == 0 && kRX <= kK1Threads, "K1 stages a region row with one warp");
static_assert(Staged<Orbit_3_10>::kFits, "3_10's K1 must keep the staged design");
static_assert(kDX * kDY + kDCY + kDX == kDCells && kDCells <= kDThreads &&
                  kDThreads % 32 == 0 && kDY == 32,
              "direct K1: a warp per tile row, then the low halo row and column");
static_assert(direct_smem<Orbit_3_30>() <= kMaxSmem, "direct K1's shared memory");

template <class T>
__global__ void __launch_bounds__(kThreads)
orbit_contract_kernel(const float* __restrict__ src, const float* __restrict__ orb,
                      float* __restrict__ out, int ncell) {
  constexpr int ND = T::K1_ND;
  const int b = blockIdx.y;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= ncell) return;
  const size_t n = (size_t)ncell;
  const float* sb = src + (size_t)b * ND * n + c;
  const float* ob = orb + (size_t)b * T::K1_NORB * n + c;
  float* outb = out + (size_t)b * ND * n + c;

  float sv[ND];
#pragma unroll
  for (int s = 0; s < ND; ++s) sv[s] = sb[s * n];
  float cv[ND];
  T::k1_contract([&](int ch) { return __ldg(ob + (size_t)ch * n); }, [&](int q) { return sv[q]; },
                 cv);
#pragma unroll
  for (int d = 0; d < ND; ++d) outb[d * n] = cv[d];
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Block-wide sum of two values; the result is valid in thread 0.
template <int NT>
__device__ __forceinline__ void block_sum2(float& a, float& b) {
  __shared__ float sa[NT / 32], sb[NT / 32];
  a = warp_sum(a);
  b = warp_sum(b);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane == 0) {
    sa[wid] = a;
    sb[wid] = b;
  }
  __syncthreads();
  if (wid == 0) {
    a = lane < NT / 32 ? sa[lane] : 0.f;
    b = lane < NT / 32 ? sb[lane] : 0.f;
    a = warp_sum(a);
    b = warp_sum(b);
  }
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned saddr = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(saddr), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ int pmod(int i, int n) {
  const int r = i % n;
  return r < 0 ? r + n : r;
}

// The staged design.  u, w, Au: (B, K1_ND, nz+1, nx, ny); orb: (B, K1_NORB,
// nz, nx, ny); albedo: (B, nx, ny); partials: (B, gridDim.x, 2).  Block x =
// (tile, z chunk) with the z chunk fastest; block y = batch.
template <class T>
__global__ void __launch_bounds__(kK1Threads)
fused_A_kernel(const float* __restrict__ u, const float* __restrict__ w,
               const float* __restrict__ orb, const float* __restrict__ albedo,
               float* __restrict__ Au, float* __restrict__ partials, int nz, int nx, int ny,
               int zsplit, int halo) {
  constexpr int K1_ND = T::K1_ND, K1_NORB = T::K1_NORB;
  constexpr int kUPlane = Staged<T>::kUPlane, kOPlane = Staged<T>::kOPlane;
  extern __shared__ float smem[];
  float* su = smem;                         // [kUSlots][K1_ND][kRX][kRY]
  float* so = su + kUSlots * kUPlane;       // [kOSlots][K1_NORB][kCX][kCY]
  float* sc = so + kOSlots * kOPlane;       // [K1_ND][kCX][kCY]
  __shared__ int s_row[kRX];                // region row a -> row offset of x = i0 - 1 + a in u

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y;
  const int tiles_y = (ny + kTY - 1) / kTY;
  const int tile = blockIdx.x / zsplit, zc = blockIdx.x - tile * zsplit;
  const int i0 = (tile / tiles_y) * kTX, j0 = (tile % tiles_y) * kTY;
  const int nplanes = nz + 1;
  const int per = (nplanes + zsplit - 1) / zsplit;
  const int k0 = zc * per, k1 = min(k0 + per, nplanes);  // face planes written here
  const int kstart = k0 > 0 ? k0 - 1 : 0;

  const int nxy = nx * ny;
  const size_t nface = (size_t)nplanes * nxy;
  // u's and the orbit field's planes: padded by the halo ring in halo mode
  const int pny = halo ? ny + 2 : ny;
  const int nxy_u = halo ? (nx + 2) * pny : nxy;
  const size_t nface_u = (size_t)nplanes * nxy_u, ncell_u = (size_t)nz * nxy_u;
  const float* ub = u + (size_t)b * K1_ND * nface_u;
  const float* wb = w + (size_t)b * K1_ND * nface;
  const float* ob = orb + (size_t)b * K1_NORB * ncell_u;
  float* Ab = Au + (size_t)b * K1_ND * nface;

  // (padded row i0 + a is x = i0 - 1 + a)
  if (tid < kRX) s_row[tid] = halo ? min(i0 + tid, nx + 1) * pny : pmod(i0 - 1 + tid, nx) * ny;
  // a region row's columns: lane l stages the columns j0 + l + 32 m (region
  // columns l + 32 m + 1); the halo columns j0 - 1 (region column 0) and
  // j0 + kTY (kRY - 1)
  int col_in[kTY / 32];
#pragma unroll
  for (int m = 0; m < kTY / 32; ++m)
    col_in[m] = halo ? min(j0 + lane + 32 * m + 1, ny + 1) : pmod(j0 + lane + 32 * m, ny);
  const int col_halo = halo ? (lane == 0 ? j0 : min(j0 + kTY + 1, ny + 1))
                            : (lane == 0 ? pmod(j0 - 1, ny) : pmod(j0 + kTY, ny));
  __syncthreads();

  // Staging goes by region rows: a warp copies one row of a dof (or orbit
  // channel) at a time, a lane per column.
  auto stage_u = [&](int kp) {  // face plane kp of u into its ring slot
    float* dst = su + (kp % kUSlots) * kUPlane;
    const float* src = ub + (size_t)kp * nxy_u;
    for (int r = warp; r < K1_ND * kRX; r += kK1Threads / 32) {
      const int q = r / kRX, a = r - q * kRX;
      const float* row = src + (size_t)q * nface_u + s_row[a];
      float* drow = dst + r * kRY;
#pragma unroll
      for (int m = 0; m < kTY / 32; ++m) cp_async4(drow + 1 + lane + 32 * m, row + col_in[m]);
      if (lane < 2) cp_async4(drow + (lane == 0 ? 0 : kRY - 1), row + col_halo);
    }
  };
  auto stage_orb = [&](int kp) {  // cell plane kp of the orbit field
    float* dst = so + (kp % kOSlots) * kOPlane;
    const float* src = ob + (size_t)kp * nxy_u;
    for (int r = warp; r < K1_NORB * kCX; r += kK1Threads / 32) {
      const int ch = r / kCX, a = r - ch * kCX;
      const float* row = src + (size_t)ch * ncell_u + s_row[a];
      float* drow = dst + r * kCY;
#pragma unroll
      for (int m = 0; m < kTY / 32; ++m) cp_async4(drow + 1 + lane + 32 * m, row + col_in[m]);
      if (lane == 0) cp_async4(drow, row + col_halo);
    }
  };

  // phase B's face column, and phase A's cell
  const int ti = tid / kTY, tj = tid - ti * kTY;
  const bool face_thread = tid < kTX * kTY && i0 + ti < nx && j0 + tj < ny;
  const size_t fcol = (size_t)(i0 + ti) * ny + (j0 + tj);
  const int ca = tid / kCY, cc = tid - ca * kCY;
  const bool cell_thread = tid < kCells;

  float carry[K1_ND];  // contributions of the cell above (dsts with k1_cz = -1)
#pragma unroll
  for (int d = 0; d < K1_ND; ++d) carry[d] = 0.f;
  float p1 = 0.f, p2 = 0.f;

  float wnext[K1_ND];  // w at this thread's face column, one plane ahead
#pragma unroll
  for (int d = 0; d < K1_ND; ++d)
    wnext[d] = face_thread && kstart == k0 && k0 < k1
                   ? wb[(size_t)d * nface + (size_t)k0 * nxy + fcol] : 0.f;
  if (kstart < k1) {
    stage_u(kstart);
    cp_async_commit();
    if (kstart + 1 <= nz) stage_u(kstart + 1);
    if (kstart < nz) stage_orb(kstart);
    cp_async_commit();
  }
  for (int kp = kstart; kp < k1; ++kp) {
    const bool out_plane = kp >= k0 && face_thread;
    // w of this plane arrived a step ago; w of the next plane is on its way
    float wv[K1_ND];
#pragma unroll
    for (int d = 0; d < K1_ND; ++d) wv[d] = wnext[d];
    if (face_thread && kp + 1 >= k0 && kp + 1 < k1) {
#pragma unroll
      for (int d = 0; d < K1_ND; ++d)
        wnext[d] = wb[(size_t)d * nface + (size_t)(kp + 1) * nxy + fcol];
    }
    __syncthreads();  // the slots refilled below are no longer read
    if (kp + 2 <= nz && kp + 2 <= k1) stage_u(kp + 2);
    if (kp + 1 < nz && kp + 1 < k1) stage_orb(kp + 1);
    cp_async_commit();
    cp_async_wait_all_but_newest();  // u planes kp, kp + 1 and orbit plane kp are here
    __syncthreads();

    // phase A: the contributions of the cells of plane kp
    if (kp < nz && cell_thread) {
      const float* o_pl = so + (kp % kOSlots) * kOPlane + tid;
      const float* u_pl0 = su + (kp % kUSlots) * kUPlane;
      const float* u_pl1 = su + ((kp + 1) % kUSlots) * kUPlane;
      auto o = [&](int ch) { return o_pl[ch * kCells]; };
      auto s = [&](int q) {
        const float* pl = T::k1_gz(q) ? u_pl1 : u_pl0;
        return pl[q * (kRX * kRY) + (ca + T::k1_gx(q)) * kRY + cc + T::k1_gy(q)];
      };
      float c[K1_ND];
      T::k1_contract(o, s, c);
#pragma unroll
      for (int d = 0; d < K1_ND; ++d) sc[d * kCells + tid] = c[d];
    }
    __syncthreads();

    // phase B: S, A(u) and the dots at face plane kp
    if (face_thread) {
      const int own = (ti + 1) * kCY + tj + 1;
      float S[K1_ND];
#pragma unroll
      for (int d = 0; d < K1_ND; ++d) {
        if (T::k1_cz(d) == -1) {
          S[d] = carry[d];
          carry[d] = kp < nz ? sc[d * kCells + own] : 0.f;
        } else {
          S[d] = kp < nz ? sc[d * kCells + own + T::k1_cx(d) * kCY + T::k1_cy(d)] : 0.f;
        }
      }
      if (out_plane) {
        const float* u_pl = su + (kp % kUSlots) * kUPlane + (ti + 1) * kRY + tj + 1;
        auto uf = [&](int q) { return u_pl[q * (kRX * kRY)]; };
        if (kp == nz) T::k1_closure(uf, albedo[(size_t)b * nxy + fcol], S);
#pragma unroll
        for (int d = 0; d < K1_ND; ++d) {
          const float a = uf(d) - S[d];
          Ab[(size_t)d * nface + (size_t)kp * nxy + fcol] = a;
          p1 += wv[d] * a;
          p2 += a * a;
        }
      }
    }
  }

  block_sum2<kK1Threads>(p1, p2);
  if (tid == 0) {
    float* pb = partials + ((size_t)b * gridDim.x + blockIdx.x) * 2;
    pb[0] = p1;
    pb[1] = p2;
  }
}

// The direct design, for table sets whose staged planes do not fit a
// block.  Arguments as the staged kernel's.
template <class T>
__global__ void __launch_bounds__(kDThreads)
fused_A_direct_kernel(const float* __restrict__ u, const float* __restrict__ w,
                      const float* __restrict__ orb, const float* __restrict__ albedo,
                      float* __restrict__ Au, float* __restrict__ partials, int nz, int nx,
                      int ny, int zsplit, int halo) {
  constexpr int ND = T::K1_ND, NORB = T::K1_NORB;
  extern __shared__ float smem[];  // [2][ND][kDCX][kDCY], plane kp in buffer kp & 1

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int tiles_y = (ny + kDY - 1) / kDY;
  const int tile = blockIdx.x / zsplit, zc = blockIdx.x - tile * zsplit;
  const int i0 = (tile / tiles_y) * kDX, j0 = (tile % tiles_y) * kDY;
  const int nplanes = nz + 1;
  const int per = (nplanes + zsplit - 1) / zsplit;
  const int k0 = zc * per, k1 = min(k0 + per, nplanes);  // face planes written here
  const int kstart = k0 > 0 ? k0 - 1 : 0;

  const int nxy = nx * ny;
  const size_t nface = (size_t)nplanes * nxy;
  // u's and the orbit field's planes: padded by the halo ring in halo mode
  const int pny = halo ? ny + 2 : ny;
  const int nxy_u = halo ? (nx + 2) * pny : nxy;
  const size_t nface_u = (size_t)nplanes * nxy_u, ncell_u = (size_t)nz * nxy_u;
  const float* ub = u + (size_t)b * ND * nface_u;
  const float* wb = w + (size_t)b * ND * nface;
  const float* ob = orb + (size_t)b * NORB * ncell_u;
  float* Ab = Au + (size_t)b * ND * nface;

  // phase A's cell, at region (ra, rc) of the tile and its low halo: threads
  // 0..255 the tile's cells (a warp per row), then the low halo row, then
  // the low halo column
  constexpr int kTile = kDX * kDY;
  int ra, rc;
  if (tid < kTile) {
    ra = tid / kDY + 1;
    rc = tid % kDY + 1;
  } else if (tid < kTile + kDCY) {
    ra = 0;
    rc = tid - kTile;
  } else {
    ra = tid - kTile - kDCY + 1;
    rc = 0;
  }
  const bool cell_thread = tid < kDCells;
  const int slot = ra * kDCY + rc;
  // the cell's row and column in u (wrapped, or padded in halo mode) and
  // the next ones
  int ci, cj, ci1, cj1;
  if (halo) {
    ci = min(i0 + ra, nx + 1);
    cj = min(j0 + rc, ny + 1);
    ci1 = min(ci + 1, nx + 1);
    cj1 = min(cj + 1, ny + 1);
  } else {
    ci = pmod(i0 - 1 + ra, nx);
    cj = pmod(j0 - 1 + rc, ny);
    ci1 = ci + 1 < nx ? ci + 1 : 0;
    cj1 = cj + 1 < ny ? cj + 1 : 0;
  }

  // phase B's face column
  const int ti = tid / kDY, tj = tid - ti * kDY;
  const bool face_thread = tid < kTile && i0 + ti < nx && j0 + tj < ny;
  const size_t fcol = (size_t)(i0 + ti) * ny + (j0 + tj);
  const size_t ucol = halo ? (size_t)(i0 + ti + 1) * pny + (j0 + tj + 1) : fcol;
  const int own = (ti + 1) * kDCY + tj + 1;

  float carry[ND];  // contributions of the cell above (dsts with k1_cz = -1)
#pragma unroll
  for (int d = 0; d < ND; ++d) carry[d] = 0.f;
  float p1 = 0.f, p2 = 0.f;

  for (int kp = kstart; kp < k1; ++kp) {
    float* sc = smem + (kp & 1) * (ND * kDCells);
    // phase A: the contributions of the cells of plane kp
    if (kp < nz && cell_thread) {
      const float* o_pl = ob + (size_t)kp * nxy_u + (size_t)ci * pny + cj;
      auto o = [&](int ch) { return __ldcs(o_pl + (size_t)ch * ncell_u); };
      auto s = [&](int q) {
        const int i = T::k1_gx(q) ? ci1 : ci, j = T::k1_gy(q) ? cj1 : cj;
        return __ldg(ub + (size_t)q * nface_u + (size_t)(kp + T::k1_gz(q)) * nxy_u +
                     (size_t)i * pny + j);
      };
      float c[ND];
      T::k1_contract(o, s, c);
#pragma unroll
      for (int d = 0; d < ND; ++d) sc[d * kDCells + slot] = c[d];
    }
    // plane kp's contributions are written; the buffer phase A of kp + 1
    // fills was last read in phase B of kp - 1, which every thread has left
    __syncthreads();

    // phase B: S, A(u) and the dots at face plane kp
    if (face_thread) {
      float S[ND];
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        if (T::k1_cz(d) == -1) {
          S[d] = carry[d];
          carry[d] = kp < nz ? sc[d * kDCells + own] : 0.f;
        } else {
          S[d] = kp < nz ? sc[d * kDCells + own + T::k1_cx(d) * kDCY + T::k1_cy(d)] : 0.f;
        }
      }
      if (kp >= k0) {
        const size_t f = (size_t)kp * nxy + fcol;
        const size_t fu = (size_t)kp * nxy_u + ucol;
        auto uf = [&](int q) { return __ldg(ub + (size_t)q * nface_u + fu); };
        if (kp == nz) T::k1_closure(uf, albedo[(size_t)b * nxy + fcol], S);
#pragma unroll
        for (int d = 0; d < ND; ++d) {
          const float a = uf(d) - S[d];
          Ab[(size_t)d * nface + f] = a;
          p1 += __ldcs(wb + (size_t)d * nface + f) * a;
          p2 += a * a;
        }
      }
    }
  }

  block_sum2<kDThreads>(p1, p2);
  if (tid == 0) {
    float* pb = partials + ((size_t)b * gridDim.x + blockIdx.x) * 2;
    pb[0] = p1;
    pb[1] = p2;
  }
}

// dots[b] = sum over the nblk block partials of batch b (fixed order)
__global__ void __launch_bounds__(kThreads)
reduce_partials_kernel(const float* __restrict__ partials, float* __restrict__ dots,
                       int nblk) {
  const int b = blockIdx.x;
  const float* pb = partials + (size_t)b * nblk * 2;
  float a = 0.f, c = 0.f;
  for (int q = threadIdx.x; q < nblk; q += blockDim.x) {
    a += pb[2 * q];
    c += pb[2 * q + 1];
  }
  block_sum2<kThreads>(a, c);
  if (threadIdx.x == 0) {
    dots[2 * b] = a;
    dots[2 * b + 1] = c;
  }
}

template <class T>
cudaError_t contract(const float* src, const float* orb, float* out, int batch, int ncell,
                     cudaStream_t stream) {
  dim3 grid((ncell + kThreads - 1) / kThreads, batch);
  orbit_contract_kernel<T><<<grid, kThreads, 0, stream>>>(src, orb, out, ncell);
  return cudaGetLastError();
}

// K1 of table set T: its kernel, block size, shared memory and tile
template <class T> struct K1 {
  static constexpr bool kStaged = Staged<T>::kFits;
  static constexpr int kThreadsPerBlock = kStaged ? kK1Threads : kDThreads;
  static constexpr size_t kSmem = kStaged ? Staged<T>::kSmem : direct_smem<T>();
  static constexpr int kTileX = kStaged ? kTX : kDX, kTileY = kStaged ? kTY : kDY;
  static auto kernel() {  // the other design is not instantiated for T
    if constexpr (kStaged)
      return &fused_A_kernel<T>;
    else
      return &fused_A_direct_kernel<T>;
  }
  static int tiles(int nx, int ny) {
    return ((nx + kTileX - 1) / kTileX) * ((ny + kTileY - 1) / kTileY);
  }
};

// K1 blocks of table set T resident on the current card (0 on an error).
// The shared-memory limit is an attribute of each device's context, so it is
// raised, and the occupancy read, once per device ordinal.
template <class T>
int k1_slots() {
  static std::atomic<int> cached[kMaxDevices];
  int dev = 0, nsm = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < kMaxDevices && cached[dev].load() > 0) return cached[dev].load();
  const auto fn = K1<T>::kernel();
  if (cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)K1<T>::kSmem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, K1<T>::kThreadsPerBlock,
                                                    K1<T>::kSmem) != cudaSuccess)
    return 0;
  const int slots = nsm * std::max(per_sm, 1);
  if (dev < kMaxDevices) cached[dev].store(slots);
  return slots;
}

// z chunks per tile: enough blocks to fill the card, at least kMinPlanes
// face planes each
template <class T>
int k1_zsplit(int batch, int nz, int nx, int ny) {
  const long tiles = (long)K1<T>::tiles(nx, ny) * std::max(batch, 1);
  const int zmax = std::max(1, (nz + 1) / kMinPlanes);
  const long fill = std::max(1L, (long)k1_slots<T>() / tiles);
  return (int)std::min<long>(fill, zmax);
}

template <class T>
int k1_blocks(int batch, int nz, int nx, int ny) {
  return K1<T>::tiles(nx, ny) * k1_zsplit<T>(batch, nz, nx, ny);
}

template <class T>
cudaError_t launch_k1(const float* u, const float* w, const float* orb, const float* albedo,
                      float* Au, float* partials, float* dots, int batch, int nz, int nx, int ny,
                      int halo, cudaStream_t stream) {
  if (k1_slots<T>() == 0) {
    const cudaError_t err = cudaGetLastError();
    return err != cudaSuccess ? err : cudaErrorUnknown;
  }
  const int zsplit = k1_zsplit<T>(batch, nz, nx, ny);
  const int nblk = K1<T>::tiles(nx, ny) * zsplit;
  dim3 grid(nblk, batch);
  K1<T>::kernel()<<<grid, K1<T>::kThreadsPerBlock, K1<T>::kSmem, stream>>>(
      u, w, orb, albedo, Au, partials, nz, nx, ny, zsplit, halo);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_partials_kernel<<<batch, kThreads, 0, stream>>>(partials, dots, nblk);
  return cudaGetLastError();
}

}  // namespace

extern "C" int orbit_scheme_dims(int inst, int* nd, int* norb) {
#define DIMS(q, T)       \
  if (inst == q) {       \
    *nd = T::K1_ND;      \
    *norb = T::K1_NORB;  \
    return 0;            \
  }
  TS_ORBIT_SCHEMES(DIMS)
#undef DIMS
  return -1;
}

extern "C" int fused_A_dots_blocks(int inst, int batch, int nz, int nx, int ny) {
#define BLOCKS(q, T) \
  if (inst == q) return k1_blocks<T>(batch, nz, nx, ny);
  TS_ORBIT_SCHEMES(BLOCKS)
#undef BLOCKS
  return 0;
}

extern "C" cudaError_t launch_orbit_contract(int inst, const float* src, const float* orb,
                                             float* out, int batch, int ncell,
                                             cudaStream_t stream) {
#define CONTRACT(q, T) \
  if (inst == q) return contract<T>(src, orb, out, batch, ncell, stream);
  TS_ORBIT_SCHEMES(CONTRACT)
#undef CONTRACT
  return cudaErrorInvalidValue;
}

extern "C" cudaError_t launch_fused_A_dots(int inst, const float* u, const float* w,
                                           const float* orb, const float* albedo, float* Au,
                                           float* partials, float* dots, int batch, int nz,
                                           int nx, int ny, int halo, cudaStream_t stream) {
#define LAUNCH(q, T)                                                                           \
  if (inst == q)                                                                               \
    return launch_k1<T>(u, w, orb, albedo, Au, partials, dots, batch, nz, nx, ny, halo, stream);
  TS_ORBIT_SCHEMES(LAUNCH)
#undef LAUNCH
  return cudaErrorInvalidValue;
}
