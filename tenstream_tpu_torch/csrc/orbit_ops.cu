// Hand-written Hopper kernels for the diffuse transport operator.
//
// K2 orbit_contract replaces the TPU kernel
//   tenstream_tpu/pprts/pallas_ops.py::_contract_kernel (orbit_contract_pallas)
// K1 fused_A_dots replaces the TPU kernel
//   tenstream_tpu/pprts/pallas_ops.py::_fused_A_kernel (fused_A_dots)
//
// What bounds them on an H100: bytes.  Per cell K2 reads 10 source and
// 24 orbit values and writes 10 (44 floats); K1 reads u, w and the orbit
// field and writes A(u) (54 floats per cell).  Both do ~2 flops per byte,
// far below the card's flop/byte balance, so the design goal is to touch
// device memory once per value.
//
// Design (the simplest correct one): one thread per cell (K2) or per face
// position (K1), threads of a block contiguous in y so every load is
// coalesced.  The TPU kernels' (Z, X, dof, Y) layout and padded halo
// copies were Mosaic tiling constraints; here the kernels read the solver's
// natural (B, dof, z, x, y) layout and compute the +-1 shifts (periodic in
// x and y, zero halo in z) from indices, so no halo copy exists.  A K1
// thread re-reads the neighbour cells' sources that its x-/y-/z-inward dofs
// need; those re-reads hit L1/L2 because neighbouring threads load the same
// lines.  The dots reduce per block (warp shuffles, then shared memory) into
// a partials buffer that a second one-block-per-batch kernel sums in a fixed
// order, so the result is deterministic.  Accumulation is float32 like the
// JAX code.

#include "orbit_tables.h"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int wrap(int i, int n) {
  return i < 0 ? i + n : (i >= n ? i - n : i);
}

template <int ND>
__global__ void __launch_bounds__(kThreads)
orbit_contract_kernel(const float* __restrict__ src, const float* __restrict__ orb,
                      float* __restrict__ out, const OrbitTables t, int ncell) {
  const int b = blockIdx.y;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= ncell) return;
  const size_t n = (size_t)ncell;
  const float* sb = src + (size_t)b * ND * n + c;
  const float* ob = orb + (size_t)b * t.norb * n + c;
  float* outb = out + (size_t)b * ND * n + c;

  float sv[ND];
#pragma unroll
  for (int s = 0; s < ND; ++s) sv[s] = sb[s * n];

#pragma unroll
  for (int d = 0; d < ND; ++d) {
    float acc = 0.f;
    for (int g = 0; g < t.ngroups[d]; ++g) {
      const int m = t.gmask[d][g];
      float ssum = 0.f;
#pragma unroll
      for (int s = 0; s < ND; ++s)
        if ((m >> s) & 1) ssum += sv[s];
      acc += ob[(size_t)t.gorb[d][g] * n] * ssum;
    }
    outb[d * n] = acc;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Block-wide sum of two values; the result is valid in thread 0.
__device__ __forceinline__ void block_sum2(float& a, float& b) {
  __shared__ float sa[kThreads / 32], sb[kThreads / 32];
  a = warp_sum(a);
  b = warp_sum(b);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane == 0) {
    sa[wid] = a;
    sb[wid] = b;
  }
  __syncthreads();
  if (wid == 0) {
    a = lane < (int)(blockDim.x >> 5) ? sa[lane] : 0.f;
    b = lane < (int)(blockDim.x >> 5) ? sb[lane] : 0.f;
    a = warp_sum(a);
    b = warp_sum(b);
  }
}

template <int ND>
__global__ void __launch_bounds__(kThreads)
fused_A_kernel(const float* __restrict__ u, const float* __restrict__ w,
               const float* __restrict__ orb, const float* __restrict__ albedo,
               float* __restrict__ Au, float* __restrict__ partials, const OrbitTables t,
               int nz, int nx, int ny) {
  const int b = blockIdx.y;
  const int nxy = nx * ny;
  const size_t nface = (size_t)(nz + 1) * nxy;
  const size_t ncell = (size_t)nz * nxy;
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  float p1 = 0.f, p2 = 0.f;

  if (f < (int)nface) {
    const int k = f / nxy;
    const int r = f - k * nxy;
    const int i = r / ny;
    const int j = r - i * ny;
    const float* ub = u + (size_t)b * ND * nface;
    const float* ob = orb + (size_t)b * t.norb * ncell;

    float S[ND];
#pragma unroll
    for (int d = 0; d < ND; ++d) S[d] = 0.f;

    // every dst dof of this face is produced by one of <= TS_MAXC cells
    for (int cl = 0; cl < t.ncls; ++cl) {
      const int kc = k + t.ccz[cl];
      if (kc < 0 || kc >= nz) continue;  // zero halo in z
      const int ic = wrap(i + t.ccx[cl], nx);
      const int jc = wrap(j + t.ccy[cl], ny);
      float sv[ND];
#pragma unroll
      for (int s = 0; s < ND; ++s) {
        const int kf = kc + t.gz[s];
        const int xf = wrap(ic + t.gx[s], nx);
        const int yf = wrap(jc + t.gy[s], ny);
        sv[s] = ub[(size_t)s * nface + (size_t)kf * nxy + xf * ny + yf];
      }
      const float* oc = ob + (size_t)kc * nxy + ic * ny + jc;
      const int cm = t.cmask[cl];
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        if (!((cm >> d) & 1)) continue;
        float acc = 0.f;
        for (int g = 0; g < t.ngroups[d]; ++g) {
          const int m = t.gmask[d][g];
          float ssum = 0.f;
#pragma unroll
          for (int s = 0; s < ND; ++s)
            if ((m >> s) & 1) ssum += sv[s];
          acc += oc[(size_t)t.gorb[d][g] * ncell] * ssum;
        }
        S[d] = acc;
      }
    }

    // Lambertian surface closure on face nz: up-top dofs gain
    // albedo * w_d * sum of the down-top dofs
    if (k == nz) {
      float edn = 0.f;
#pragma unroll
      for (int s = 0; s < ND; ++s)
        if ((t.dn_mask >> s) & 1) edn += ub[(size_t)s * nface + f];
      const float alb = albedo[(size_t)b * nxy + r];
#pragma unroll
      for (int d = 0; d < ND; ++d)
        if (t.walb[d] != 0.f) S[d] += alb * edn * t.walb[d];
    }

    const float* wb = w + (size_t)b * ND * nface;
    float* Ab = Au + (size_t)b * ND * nface;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      const float a = ub[(size_t)d * nface + f] - S[d];
      Ab[(size_t)d * nface + f] = a;
      p1 += wb[(size_t)d * nface + f] * a;
      p2 += a * a;
    }
  }

  block_sum2(p1, p2);
  if (threadIdx.x == 0) {
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
  block_sum2(a, c);
  if (threadIdx.x == 0) {
    dots[2 * b] = a;
    dots[2 * b + 1] = c;
  }
}

template <int ND>
cudaError_t contract_nd(const float* src, const float* orb, float* out,
                        const OrbitTables* t, int batch, int ncell, cudaStream_t stream) {
  dim3 grid((ncell + kThreads - 1) / kThreads, batch);
  orbit_contract_kernel<ND><<<grid, kThreads, 0, stream>>>(src, orb, out, *t, ncell);
  return cudaGetLastError();
}

template <int ND>
cudaError_t fused_nd(const float* u, const float* w, const float* orb, const float* albedo,
                     float* Au, float* partials, float* dots, const OrbitTables* t,
                     int batch, int nz, int nx, int ny, cudaStream_t stream) {
  const int nblk = fused_A_dots_blocks(nz, nx, ny);
  dim3 grid(nblk, batch);
  fused_A_kernel<ND><<<grid, kThreads, 0, stream>>>(u, w, orb, albedo, Au, partials, *t,
                                                     nz, nx, ny);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_partials_kernel<<<batch, kThreads, 0, stream>>>(partials, dots, nblk);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fused_A_dots_blocks(int nz, int nx, int ny) {
  const long nface = (long)(nz + 1) * nx * ny;
  return (int)((nface + kThreads - 1) / kThreads);
}

extern "C" cudaError_t launch_orbit_contract(const float* src, const float* orb, float* out,
                                             const OrbitTables* t, int batch, int ncell,
                                             cudaStream_t stream) {
  if (t->nd != 10) return cudaErrorInvalidValue;  // built for 3_10 only
  return contract_nd<10>(src, orb, out, t, batch, ncell, stream);
}

extern "C" cudaError_t launch_fused_A_dots(const float* u, const float* w, const float* orb,
                                           const float* albedo, float* Au, float* partials,
                                           float* dots, const OrbitTables* t, int batch,
                                           int nz, int nx, int ny, cudaStream_t stream) {
  if (t->nd != 10) return cudaErrorInvalidValue;  // built for 3_10 only
  return fused_nd<10>(u, w, orb, albedo, Au, partials, dots, t, batch, nz, nx, ny, stream);
}
