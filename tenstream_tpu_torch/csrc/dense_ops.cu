// Hand-written Hopper kernel for the diffuse transport operator on dense
// coefficients.
//
// K3 diffuse_apply_dense replaces the TPU kernel
//   tenstream_tpu/pprts/pallas_ops.py::_kernel (diffuse_apply_pallas)
//
// It computes S(x) = scatter(einsum(c, gather(x))) without the surface
// closure: for each dst dof d at a face,
//   out[d, face] = sum_s c[s, d, cell] * x[s, cell + gshift[s]],
//   cell = face + cshift[d],
// periodic in x and y, zero where the cell lies beyond z.
//
// What bounds it on an H100: bytes.  Per cell it reads the 100 (src, dst)
// coefficients once and does 100 multiply-adds on them: 0.5 flop per byte
// in float32, 1 with bfloat16 coefficients, far below the card's balance.
// The coefficient field is 10x (5x in bfloat16) the in- and output
// together, so the goal is that every coefficient and every source value
// comes from device memory once, with as few load instructions per byte as
// the card allows.
//
// Why the first design (one thread per face and dst dof) lost bfloat16's
// gain: each thread issued 10 scalar coefficient loads and 10 scalar source
// loads, so a cell cost 100 coefficient and 100 source load instructions,
// and the 10 dst threads of a face fetched the same sources again from
// L1/L2 (as many bytes per launch as the float32 coefficient field).  A
// bfloat16 scalar load moves half the bytes of a float32 one for the same
// instruction, so halving the coefficient bytes saved no time.
//
// The design, part by part:
// - Sources once, in shared memory.  A block owns a tile of kTX x kTY =
//   8 x 128 cells (y fastest) and marches down a range of z planes.  For
//   cell plane k it stages, for each source dof s, the face plane
//   k + gshift_z[s] over the tile and, where gshift_x[s] or gshift_y[s] is
//   1, a one-cell high halo row or column (indices wrap: x and y are
//   periodic, which TMA cannot do).  Each (dof, face plane) pair is read at
//   exactly one cell plane, so there is nothing to keep from one step to
//   the next: the ring is two steps deep, cp.async filling step k + 1 while
//   step k computes.  A tile of 4 x 256 cells (whole rows at ny = 256) was
//   no faster.
// - Coefficients in 16-byte vectors.  A thread owns kVec consecutive y
//   cells of one x row (4 in float32, 8 in bfloat16) and, for each dst dof
//   d, loads the 10 (s, d) vectors of its cells straight from the solver's
//   (B, s, d, z, x, y) layout: 25 load instructions per cell in float32,
//   12.5 in bfloat16, against 100 before; a warp's load covers 512
//   contiguous bytes.  The loads stream past L1 and are marked evict-first
//   in L2 (__ldcs), which keeps x's planes there for the neighbouring
//   tiles' halos.  Where ny is not a multiple of kVec or the field's base
//   is not 16-byte aligned, the same kernel is instantiated with
//   element loads and a mask (kVector = false).
// - Cell space, as the TPU kernel.  A cell's contribution to dst d goes to
//   face cell - cshift[d], so every output face is written exactly once, by
//   the block that owns its producing cell; the faces no cell produces
//   (face 0 of the dsts with cshift_z = -1, face nz of the others) are
//   written as 0 by the block that owns the cell plane next to them.  No
//   face is left for a memset: the binding allocates the output with
//   empty_like.  Dsts with cshift_y = 0 are stored as 16-byte vectors,
//   the others (their faces one column over) element by element.
// - The same sums.  Each output is one chain of multiply-adds over s = 0..9
//   starting from 0, as the first design's `acc += c * x`, and bfloat16 is
//   widened exactly, so the results equal the first design's bit for bit.
//   Compiled without fast-math.
// - No re-laid copy of the coefficient field (11.7 GB at a band chunk of
//   8 x 56 layers), any batch and any nz, nx, ny >= 1.
//
// The shift tables come at run time.  The design needs gshift in {0, 1}
// and cshift in {-1, 0} on every axis (a source read at most one step
// along the axis: only high halos; a face made by its own cell or the one
// before it); the wrapper and the binding refuse other tables.  3_10 and
// 8_10 meet this.  Unlike K1, K3 needs no rule for the z dsts' columns: it
// writes each cell's contributions where they land.
//
// Resources at 10 dofs (`nvcc -Xptxas -v` and the occupancy query, printed
// by chip_smoke.py's phases 2 and 3): 95,040 bytes of dynamic shared memory
// per block (2 steps x 10 dofs x 9 rows x 132 floats) and two blocks per
// SM.  float32: 256 threads per block (512 per SM), 128 registers (the
// launch bounds' cap).  bfloat16: 128 threads per block (256 per SM), 252
// registers (255 with element loads).  No variant spills.  One barrier per
// z step.
//
// Other dof counts.  The kernel is instantiated for each diffuse dof count
// of the cube schemes (6, 10, 12, 16, 18, 24, 30).  Up to 10 dofs it is the
// design above.  Above 10, a thread's sources no longer fit its registers
// beside the coefficients (30 x 4 floats each at 3_30), so for each dst it
// reads them from the staged step in shared memory as it goes (shared-memory
// bytes equal to the coefficient bytes, far below that memory's rate), and
// the two staged steps no longer leave room for two blocks per SM: one
// block per SM with the launch bounds' 255 registers, tiles of 8 rows up to
// 24 dofs (228,096 bytes) and of 6 rows at 30 (221,760 bytes).  The sums
// are the same chains over s from 0.
//
// Halo mode (a rank's block of a decomposed field): the staged high halo
// row and column come from two planes the neighbouring ranks sent (hx, hy:
// x just past the block's high x and y edges) instead of wrapping, and the
// faces the block's cells make past its high edges go to two extra outputs
// (ox, oy) instead of wrapping to the block's first faces, which are
// written as 0 here and filled by the previous ranks' ox / oy afterwards.
// Only addresses change, so the sums are the periodic launch's.  No source
// may read both halos (the corner is not staged); the binding refuses such
// tables.

#include <cuda_bf16.h>

#include <algorithm>
#include <atomic>

#include "dense_ops.h"
#include "orbit_schemes.h"  // TS_DENSE_NDS: the dof counts K3 is instantiated for

namespace {

constexpr int kTX = 8, kTY = 128;      // a block's tile of cells (at most), y fastest
constexpr int kRS = kTY + 4;           // staged row stride in floats (16-byte rows, halo column)
constexpr int kSteps = 2;              // staged steps: k computing, k + 1 arriving
constexpr int kMinPlanes = 4;          // the fewest cell planes a block marches over
constexpr int kWaves = 4;              // blocks per resident slot the z split aims at
constexpr int kMaxDevices = 64;        // device ordinals whose occupancy is cached
constexpr size_t kSmemPerSM = 228 * 1024;  // an SM's shared memory on sm_90 (1 KB per block reserved)

// Up to 10 dofs the sources sit in registers and two blocks share an SM;
// above, they are read from shared memory per dst, one block per SM.
template <int ND> __host__ __device__ constexpr bool src_in_regs() { return ND <= 10; }
template <int ND> __host__ __device__ constexpr int blocks_per_sm() { return src_in_regs<ND>() ? 2 : 1; }
template <int ND> __host__ __device__ constexpr size_t staged_bytes(int rows) {
  return sizeof(float) * (size_t)kSteps * ND * (rows + 1) * kRS;
}
// the most tile rows (up to kTX) whose staging fits blocks_per_sm blocks
template <int ND> __host__ __device__ constexpr int tile_rows() {
  int r = kTX;
  while (r > 1 && staged_bytes<ND>(r) * blocks_per_sm<ND>() >
                      kSmemPerSM - 1024 * (size_t)blocks_per_sm<ND>())
    --r;
  return r;
}

template <typename CT, int ND>
struct Geo {
  static constexpr int kTileX = tile_rows<ND>();           // rows of cells per tile
  static constexpr int kRows = kTileX + 1;                 // staged rows: the tile and a high halo row
  static constexpr int kSlice = kRows * kRS;               // floats of one staged dof
  static constexpr int kVec = 16 / sizeof(CT);             // cells per thread
  static constexpr int kThreads = kTileX * kTY / kVec;     // 256 (float), 128 (bfloat16) at 10 dofs
  static constexpr int kBlocks = blocks_per_sm<ND>();
  static constexpr size_t kSmem = sizeof(float) * (size_t)kSteps * ND * kSlice;
  static_assert(kSmem * kBlocks <= kSmemPerSM - 1024 * (size_t)kBlocks, "K3's blocks must fit an SM");
  static_assert(kThreads > kTileX && kThreads % 32 == 0, "K3's block");
};
static_assert(kTY % 32 == 0 && kRS % 4 == 0, "staged rows must stay 16-byte aligned");
#define K3_CHECK_ND(N) static_assert(N <= TS_DENSE_MAXD, "DenseTables holds TS_DENSE_MAXD dofs");
TS_DENSE_NDS(K3_CHECK_ND)
#undef K3_CHECK_ND
static_assert(Geo<float, 10>::kTileX == kTX && Geo<float, 10>::kBlocks == 2,
              "10 dofs keep the 8 x 128 tile and two blocks per SM");

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned saddr = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(saddr), "l"(gmem));
}
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned saddr = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(saddr), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// bfloat16 -> float is exact: the 16 bits are the float's high half
__device__ __forceinline__ float bf16_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }

// kVec coefficients of consecutive cells, widened to float
template <bool V>
__device__ __forceinline__ void load_coeffs(const float* p, int nvalid, float* v) {
  if (V) {
    const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = q < nvalid ? __ldcs(p + q) : 0.f;
  }
}
template <bool V>
__device__ __forceinline__ void load_coeffs(const __nv_bfloat16* p, int nvalid, float* v) {
  if (V) {
    const uint4 a = __ldcs(reinterpret_cast<const uint4*>(p));
    const unsigned w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      v[2 * h] = bf16_lo(w[h]);
      v[2 * h + 1] = bf16_hi(w[h]);
    }
  } else {
    const unsigned short* ps = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = q < nvalid ? bf16_lo(__ldcs(ps + q)) : 0.f;
  }
}

// x, out: (B, ND, nz+1, nx, ny); c: (B, ND, ND, nz, nx, ny) [src, dst].
// Block x = (tile, z chunk) with the z chunk fastest; block y = batch.
template <typename CT, int ND, bool kVector>
__global__ void __launch_bounds__(Geo<CT, ND>::kThreads, Geo<CT, ND>::kBlocks)
diffuse_apply_dense_kernel(const float* __restrict__ x, const CT* __restrict__ c,
                           float* __restrict__ out, const DenseTables t, const DenseHalo hal,
                           int nz, int nx, int ny, int zsplit, int xvec) {
  using G = Geo<CT, ND>;
  constexpr int kVec = G::kVec, kNT = G::kThreads, kTileX = G::kTileX, kSlice = G::kSlice;
  constexpr int kLanesPerRow = kTY / kVec;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);  // [kSteps][ND][kRows][kRS]
  __shared__ int s_row[G::kRows];                 // staged row a -> x offset (i0 + a, wrapped) * ny,
                                                  // -1 for the halo row hx in halo mode

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int tiles_y = (ny + kTY - 1) / kTY;
  const int tile = blockIdx.x / zsplit, zc = blockIdx.x - tile * zsplit;
  const int i0 = (tile / tiles_y) * kTileX, j0 = (tile % tiles_y) * kTY;
  const int hv = min(kTileX, nx - i0), wv = min(kTY, ny - j0);  // cells of the tile in x and y
  const int per = (nz + zsplit - 1) / zsplit;
  const int k0 = zc * per, k1 = min(k0 + per, nz);  // cell planes of this block

  const int nplanes = nz + 1;
  const int nxy = nx * ny;
  const size_t nface = (size_t)nplanes * nxy, ncell = (size_t)nz * nxy;
  const float* xb = x + (size_t)b * ND * nface;
  const CT* cb = c + (size_t)b * ND * ND * ncell;
  float* ob = out + (size_t)b * ND * nface;
  const bool halo = hal.hx != nullptr;
  const size_t nrow = (size_t)nplanes * ny, ncol = (size_t)nplanes * nx;  // per dof
  const float* hxb = halo ? hal.hx + (size_t)b * ND * nrow : nullptr;
  const float* hyb = halo ? hal.hy + (size_t)b * ND * ncol : nullptr;
  float* oxb = halo ? hal.ox + (size_t)b * ND * nrow : nullptr;
  float* oyb = halo ? hal.oy + (size_t)b * ND * ncol : nullptr;

  if (tid <= hv) s_row[tid] = i0 + tid < nx ? (i0 + tid) * ny : (halo ? -1 : (i0 + tid - nx) * ny);
  // the halo column (-1: hy in halo mode)
  const int jhalo = j0 + wv < ny ? j0 + wv : (halo ? -1 : j0 + wv - ny);
  __syncthreads();

  // step k's sources: dof s from face plane k + gz[s], its tile rows and
  // columns, plus the high halo row / column where gx[s] / gy[s] is 1
  auto stage = [&](int k) {
    float* dst = smem + (k % kSteps) * (ND * kSlice);
    for (int s = 0; s < ND; ++s) {
      const int kk = k + t.gz[s];
      const float* src = xb + (size_t)s * nface + (size_t)kk * nxy + j0;
      // the halo row of dof s and plane kk at column j0 (halo mode)
      const float* hrow = halo ? hxb + (size_t)s * nrow + (size_t)kk * ny + j0 : nullptr;
      float* ds = dst + s * kSlice;
      const int rows = hv + t.gx[s];
      if (xvec) {
        const int nch = wv >> 2;
        for (int e = tid; e < rows * nch; e += kNT) {
          const int a = e / nch, ch = e - a * nch;
          cp_async16(ds + a * kRS + 4 * ch, (s_row[a] >= 0 ? src + s_row[a] : hrow) + 4 * ch);
        }
      } else {
        for (int e = tid; e < rows * wv; e += kNT) {
          const int a = e / wv, q = e - a * wv;
          cp_async4(ds + a * kRS + q, (s_row[a] >= 0 ? src + s_row[a] : hrow) + q);
        }
      }
      if (t.gy[s])
        for (int a = tid; a < rows; a += kNT)
          cp_async4(ds + a * kRS + wv,
                    jhalo >= 0 ? src - j0 + s_row[a] + jhalo
                               : hyb + (size_t)s * ncol + (size_t)kk * nx + (i0 + a));
    }
  };

  // this thread's cells: row ta, columns c0 .. c0 + kVec - 1 of the tile
  const int ta = tid / kLanesPerRow, c0 = (tid - ta * kLanesPerRow) * kVec;
  const int i = i0 + ta, j = j0 + c0;
  const int nvalid = min(kVec, ny - j);
  const bool active = ta < hv && nvalid > 0;

  if (k0 < k1) stage(k0);
  cp_async_commit();
  for (int k = k0; k < k1; ++k) {
    cp_async_wait_all();  // step k's sources are here ...
    __syncthreads();      // ... from every thread, and step k - 1's slot is free
    if (k + 1 < k1) stage(k + 1);
    cp_async_commit();

    if (active) {
      const float* st = smem + (k % kSteps) * (ND * kSlice);
      // this cell row's results for dst d: the face the cells make, and the
      // face no cell makes next to it (plane 0 below a cz = -1 dst, plane nz
      // for the others)
      auto store = [&](int d, const float* acc) {
        const int cz = t.cz[d];
        const int kf = k - cz;
        const bool edge = cz == -1 ? k == 0 : k == nz - 1;
        const int kz = cz == -1 ? 0 : nz;
        const int fr = i - t.cx[d];  // the face row; nx is past the block
        // the face row's dof-d plane 0 and the stride between planes: the
        // block's (row nx wraps to 0), or ox's past the high x edge
        float* od;
        size_t ps = nxy;
        if (fr < nx) {
          od = ob + (size_t)d * nface + (size_t)fr * ny;
        } else if (halo) {
          od = oxb + (size_t)d * nrow;
          ps = ny;
        } else {
          od = ob + (size_t)d * nface;
        }
        if (kVector && t.cy[d] == 0) {
#pragma unroll
          for (int g = 0; g < kVec / 4; ++g) {
            reinterpret_cast<float4*>(od + (size_t)kf * ps + j)[g] =
                make_float4(acc[4 * g], acc[4 * g + 1], acc[4 * g + 2], acc[4 * g + 3]);
            if (edge)
              reinterpret_cast<float4*>(od + (size_t)kz * ps + j)[g] =
                  make_float4(0.f, 0.f, 0.f, 0.f);
          }
        } else {
#pragma unroll
          for (int q = 0; q < kVec; ++q) {
            if (q < nvalid) {
              const int fc = j + q - t.cy[d];  // the face column; ny is past the block
              if (fc < ny || !halo) {
                const int fj = fc < ny ? fc : 0;
                od[(size_t)kf * ps + fj] = acc[q];
                if (edge) od[(size_t)kz * ps + fj] = 0.f;
              } else {
                float* oy = oyb + (size_t)d * ncol + fr;
                oy[(size_t)kf * nx] = acc[q];
                if (edge) oy[(size_t)kz * nx] = 0.f;
              }
            }
          }
        }
        if (halo && t.cx[d] == -1 && i == 0) {  // row 0: the previous rank's cells make it
          float* oz = ob + (size_t)d * nface;
          for (int q = 0; q < nvalid; ++q) {
            oz[(size_t)kf * nxy + j + q] = 0.f;
            if (edge) oz[(size_t)kz * nxy + j + q] = 0.f;
          }
        }
        if (halo && t.cy[d] == -1 && j == 0) {  // column 0 likewise
          float* oz = ob + (size_t)d * nface + (size_t)fr * ny;
          oz[(size_t)kf * nxy] = 0.f;
          if (edge) oz[(size_t)kz * nxy] = 0.f;
        }
      };
      // kVec staged sources of dof s for this thread's cells, shifted by gy[s]
      auto sources = [&](int s, float* sv) {
        const float* row = st + s * kSlice + (ta + t.gx[s]) * kRS + c0;
        float r[kVec + 1];
#pragma unroll
        for (int h = 0; h < kVec / 4; ++h) {
          const float4 v = reinterpret_cast<const float4*>(row)[h];
          r[4 * h] = v.x; r[4 * h + 1] = v.y; r[4 * h + 2] = v.z; r[4 * h + 3] = v.w;
        }
        r[kVec] = row[kVec];
        const bool sh = t.gy[s] != 0;
#pragma unroll
        for (int q = 0; q < kVec; ++q) sv[q] = sh ? r[q + 1] : r[q];
      };

      if constexpr (src_in_regs<ND>()) {
        float sv[ND][kVec];
#pragma unroll
        for (int s = 0; s < ND; ++s) sources(s, sv[s]);
        const CT* ck = cb + (size_t)k * nxy + (size_t)i * ny + j;
        // float32 keeps the dst loop rolled: unrolled, the loads hoisted
        // across dsts spill at the 128 registers two blocks per SM allow
        // (5.38 against 4.72 ms at the band chunk on an H100 SXM at 700 W);
        // the bfloat16 vector kernel has 255 and unrolls
#pragma unroll (sizeof(CT) == 2 && kVector ? ND : 1)
        for (int d = 0; d < ND; ++d) {
          float cv[ND][kVec];
#pragma unroll
          for (int s = 0; s < ND; ++s)
            load_coeffs<kVector>(ck + (size_t)(s * ND + d) * ncell, nvalid, cv[s]);
          float acc[kVec];
#pragma unroll
          for (int q = 0; q < kVec; ++q) {
            acc[q] = 0.f;
#pragma unroll
            for (int s = 0; s < ND; ++s) acc[q] += cv[s][q] * sv[s][q];
          }
          store(d, acc);
        }
      } else {
        const CT* ck = cb + (size_t)k * nxy + (size_t)i * ny + j;
        for (int d = 0; d < ND; ++d) {
          float acc[kVec];
#pragma unroll
          for (int q = 0; q < kVec; ++q) acc[q] = 0.f;
#pragma unroll
          for (int s = 0; s < ND; ++s) {
            float cv[kVec], sv[kVec];
            load_coeffs<kVector>(ck + (size_t)(s * ND + d) * ncell, nvalid, cv);
            sources(s, sv);
#pragma unroll
            for (int q = 0; q < kVec; ++q) acc[q] += cv[q] * sv[q];
          }
          store(d, acc);
        }
      }
    }
  }
}

// (SMs, blocks of this kernel resident per SM) on the current card, (0, 0)
// on an error.  The shared-memory limit is an attribute of each device's
// context, so it is raised, and the occupancy read, once per device ordinal.
struct Slots {
  int nsm, per_sm;
};
template <typename CT, int ND, bool V>
Slots slots() {
  using G = Geo<CT, ND>;
  static std::atomic<int> cached_nsm[kMaxDevices], cached_per_sm[kMaxDevices];
  int dev = 0, nsm = 0, optin = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return {0, 0};
  if (dev < kMaxDevices && cached_per_sm[dev].load() > 0)  // stored after cached_nsm
    return {cached_nsm[dev].load(), cached_per_sm[dev].load()};
  auto fn = diffuse_apply_dense_kernel<CT, ND, V>;
  if (cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess ||
      (size_t)optin < G::kSmem ||
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::kSmem) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, G::kThreads, G::kSmem) !=
          cudaSuccess ||
      nsm < 1 || per_sm < 1)
    return {0, 0};
  if (dev < kMaxDevices) {
    cached_nsm[dev].store(nsm);
    cached_per_sm[dev].store(per_sm);
  }
  return {nsm, per_sm};
}

template <typename CT, int ND, bool V>
cudaError_t apply_nd(const float* x, const CT* c, float* out, const DenseTables* t,
                     const DenseHalo& h, int batch, int nz, int nx, int ny, int xvec,
                     cudaStream_t stream) {
  using G = Geo<CT, ND>;
  const Slots sl = slots<CT, ND, V>();
  if (sl.per_sm == 0) {
    const cudaError_t err = cudaGetLastError();
    return err != cudaSuccess ? err : cudaErrorInvalidConfiguration;
  }
  // z chunks per tile: enough blocks for kWaves waves over the card, at
  // least kMinPlanes cell planes each (one wave left a single band of 40
  // layers 7% slower, the band chunk the same)
  const long tiles = (long)((nx + G::kTileX - 1) / G::kTileX) * ((ny + kTY - 1) / kTY);
  const long tb = tiles * std::max(batch, 1);
  const long fill = std::max(1L, ((long)kWaves * sl.nsm * sl.per_sm + tb - 1) / tb);
  const int zsplit = (int)std::min<long>(fill, std::max(1, nz / kMinPlanes));
  dim3 grid((unsigned)(tiles * zsplit), batch);
  diffuse_apply_dense_kernel<CT, ND, V><<<grid, G::kThreads, G::kSmem, stream>>>(
      x, c, out, *t, h, nz, nx, ny, zsplit, xvec);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return ((size_t)p & 15) == 0; }

template <int ND>
cudaError_t launch_nd(const float* x, const void* c, int c_is_bf16, float* out,
                      const DenseTables* t, const DenseHalo& h, int batch, int nz, int nx, int ny,
                      cudaStream_t stream) {
  const int xvec = ny % 4 == 0 && aligned16(x) && aligned16(out) &&
                   (h.hx == nullptr || (aligned16(h.hx) && aligned16(h.ox)));
  if (c_is_bf16) {
    const __nv_bfloat16* cb = (const __nv_bfloat16*)c;
    if (ny % 8 == 0 && xvec && aligned16(c))
      return apply_nd<__nv_bfloat16, ND, true>(x, cb, out, t, h, batch, nz, nx, ny, xvec, stream);
    return apply_nd<__nv_bfloat16, ND, false>(x, cb, out, t, h, batch, nz, nx, ny, xvec, stream);
  }
  const float* cf = (const float*)c;
  if (ny % 4 == 0 && xvec && aligned16(c))
    return apply_nd<float, ND, true>(x, cf, out, t, h, batch, nz, nx, ny, xvec, stream);
  return apply_nd<float, ND, false>(x, cf, out, t, h, batch, nz, nx, ny, xvec, stream);
}

template <int ND>
cudaError_t config_nd(int c_is_bf16, int* threads, int* smem, int* blocks_per_sm) {
  if (c_is_bf16) {
    *threads = Geo<__nv_bfloat16, ND>::kThreads;
    *smem = (int)Geo<__nv_bfloat16, ND>::kSmem;
    *blocks_per_sm = slots<__nv_bfloat16, ND, true>().per_sm;
  } else {
    *threads = Geo<float, ND>::kThreads;
    *smem = (int)Geo<float, ND>::kSmem;
    *blocks_per_sm = slots<float, ND, true>().per_sm;
  }
  if (*blocks_per_sm == 0) {
    const cudaError_t err = cudaGetLastError();
    return err != cudaSuccess ? err : cudaErrorInvalidConfiguration;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" cudaError_t launch_diffuse_apply_dense(const float* x, const void* c, int c_is_bf16,
                                                  float* out, const DenseTables* t, int batch,
                                                  int nz, int nx, int ny, cudaStream_t stream) {
  const DenseHalo periodic = {nullptr, nullptr, nullptr, nullptr};
#define LAUNCH(N) \
  if (t->nd == N) return launch_nd<N>(x, c, c_is_bf16, out, t, periodic, batch, nz, nx, ny, stream);
  TS_DENSE_NDS(LAUNCH)
#undef LAUNCH
  return cudaErrorInvalidValue;  // no instantiation for this dof count
}

extern "C" cudaError_t launch_diffuse_apply_dense_halo(const float* x, const void* c,
                                                       int c_is_bf16, float* out,
                                                       const DenseTables* t, const DenseHalo* h,
                                                       int batch, int nz, int nx, int ny,
                                                       cudaStream_t stream) {
  if (h == nullptr || h->hx == nullptr || h->hy == nullptr || h->ox == nullptr ||
      h->oy == nullptr)
    return cudaErrorInvalidValue;
  for (int s = 0; s < t->nd; ++s)
    if (t->gx[s] && t->gy[s]) return cudaErrorInvalidValue;  // the corner is not staged
#define LAUNCH(N) \
  if (t->nd == N) return launch_nd<N>(x, c, c_is_bf16, out, t, *h, batch, nz, nx, ny, stream);
  TS_DENSE_NDS(LAUNCH)
#undef LAUNCH
  return cudaErrorInvalidValue;
}

extern "C" cudaError_t diffuse_apply_dense_config(int c_is_bf16, int nd, int* threads, int* smem,
                                                  int* blocks_per_sm_out) {
#define CONFIG(N) \
  if (nd == N) return config_nd<N>(c_is_bf16, threads, smem, blocks_per_sm_out);
  TS_DENSE_NDS(CONFIG)
#undef CONFIG
  return cudaErrorInvalidValue;
}
