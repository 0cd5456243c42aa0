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
// in float32 (1 with bfloat16 coefficients), far below the card's balance.
// The coefficient field is 10x the in- and output together, so the goal is
// to stream it through exactly once and to keep enough loads in flight.
//
// Design: one thread per (face position, dst dof), threads of a block
// contiguous in y.  c[:, d, cell] feeds only dst d of the one face that
// cell + cshift[d] maps to, so every coefficient is loaded by exactly one
// thread, once, coalesced along y.  A thread holds 10 coefficients and 10
// source values (40 registers), so an SM keeps many warps' loads in
// flight; one thread per face looping over its 10 dofs needs 172 registers,
// runs one block per SM and takes 1.6x as long on an H100 (256x256x40).
// Only the source values are shared: the 10 threads of a face and their
// neighbours read the same lines of x.  The dof is the fastest block
// index, so the 10 blocks of one tile of faces run close together in time
// and x (a tenth of the coefficient field) is served from L1/L2.  The TPU
// kernel's x-major halo-padded copies, its accumulation in cell space and
// its lane rolls were Mosaic's constraints; here the solver's own (B, src,
// dst, z, x, y) and (B, dof, z, x, y) layouts are read in place and the
// +-1 shifts come from indices, so no re-laid copy of the coefficient
// field exists.  bfloat16 coefficients are converted to float on load;
// products and sums are float32.

#include <cuda_bf16.h>

#include "dense_ops.h"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int wrap(int i, int n) {
  return i < 0 ? i + n : (i >= n ? i - n : i);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename CT, int ND>
__global__ void __launch_bounds__(kThreads)
diffuse_apply_dense_kernel(const float* __restrict__ x, const CT* __restrict__ c,
                           float* __restrict__ out, const DenseTables t, int nz, int nx,
                           int ny) {
  const int b = blockIdx.y;
  const int d = blockIdx.x % ND;
  const int nxy = nx * ny;
  const size_t nface = (size_t)(nz + 1) * nxy;
  const size_t ncell = (size_t)nz * nxy;
  const size_t f = (size_t)(blockIdx.x / ND) * blockDim.x + threadIdx.x;
  if (f >= nface) return;
  const int k = (int)(f / nxy);
  const int r = (int)(f - (size_t)k * nxy);
  const int i = r / ny;
  const int j = r - i * ny;

  float acc = 0.f;
  const int kc = k + t.cz[d];
  if (kc >= 0 && kc < nz) {  // zero beyond z
    const int ic = wrap(i + t.cx[d], nx);
    const int jc = wrap(j + t.cy[d], ny);
    const float* xb = x + (size_t)b * ND * nface;
    const CT* cc = c + ((size_t)b * ND * ND + d) * ncell + (size_t)kc * nxy + ic * ny + jc;
    float cv[ND], sv[ND];
#pragma unroll
    for (int s = 0; s < ND; ++s) cv[s] = to_f32(cc[(size_t)s * ND * ncell]);
#pragma unroll
    for (int s = 0; s < ND; ++s) {
      const int kf = kc + t.gz[s];
      const int xf = wrap(ic + t.gx[s], nx);
      const int yf = wrap(jc + t.gy[s], ny);
      sv[s] = xb[(size_t)s * nface + (size_t)kf * nxy + xf * ny + yf];
    }
#pragma unroll
    for (int s = 0; s < ND; ++s) acc += cv[s] * sv[s];
  }
  out[((size_t)b * ND + d) * nface + f] = acc;
}

template <typename CT, int ND>
cudaError_t apply_nd(const float* x, const CT* c, float* out, const DenseTables* t, int batch,
                     int nz, int nx, int ny, cudaStream_t stream) {
  const size_t nface = (size_t)(nz + 1) * nx * ny;
  dim3 grid((unsigned)((nface + kThreads - 1) / kThreads) * ND, batch);
  diffuse_apply_dense_kernel<CT, ND><<<grid, kThreads, 0, stream>>>(x, c, out, *t, nz, nx, ny);
  return cudaGetLastError();
}

}  // namespace

extern "C" cudaError_t launch_diffuse_apply_dense(const float* x, const void* c, int c_is_bf16,
                                                  float* out, const DenseTables* t, int batch,
                                                  int nz, int nx, int ny, cudaStream_t stream) {
  if (t->nd != 10) return cudaErrorInvalidValue;  // built for 3_10 only
  if (c_is_bf16)
    return apply_nd<__nv_bfloat16, 10>(x, (const __nv_bfloat16*)c, out, t, batch, nz, nx, ny,
                                       stream);
  return apply_nd<float, 10>(x, (const float*)c, out, t, batch, nz, nx, ny, stream);
}
