// Static shift tables of the dense diffuse-operator kernel (dense_ops.cu)
// and its binding (bind.cpp).  Plain C: no PyTorch headers, so the CUDA
// source compiles in seconds.
#pragma once

#include <cuda_runtime.h>

#define TS_DENSE_MAXD 30  // the most diffuse dofs per cell (3_30)

// One diffuse scheme's face<->cell shifts (z, x, y), passed to the kernel
// by value (724 bytes); entries from nd on are unused.
typedef struct {
  int nd;                                                       // diffuse dofs
  int gz[TS_DENSE_MAXD], gx[TS_DENSE_MAXD], gy[TS_DENSE_MAXD];  // src s read at cell + g*[s]
  int cz[TS_DENSE_MAXD], cx[TS_DENSE_MAXD], cy[TS_DENSE_MAXD];  // dst d made by cell face + c*[d]
} DenseTables;

// K3's halo mode on a rank's block: hx (B, nd, nz+1, ny) and hy (B, nd,
// nz+1, nx) are x at the planes just past the block's high x and y edges
// (the next ranks' first planes); the faces the block's cells make past
// those edges go to ox and oy of the same shapes (zero where no cell makes
// them), and the block's first faces that the previous ranks' cells make
// are written as 0.
typedef struct {
  const float *hx, *hy;
  float *ox, *oy;
} DenseHalo;

#ifdef __cplusplus
extern "C" {
#endif

// out[b, d, face] = sum_s c[b, s, d, cell] * x[b, s, cell + g(s)] with
// cell = face + c(d); periodic in x and y, zero beyond z.
// x, out: (B, nd, nz+1, nx, ny) float32; c: (B, nd, nd, nz, nx, ny)
// [src, dst], float32 or (c_is_bf16 != 0) bfloat16.  Every face of out is
// written.  The kernel is instantiated for the dof counts of TS_DENSE_NDS
// (orbit_schemes.h; else cudaErrorInvalidValue); every shift must be in g in
// {0, 1}, c in {-1, 0} (the binding checks them).
cudaError_t launch_diffuse_apply_dense(const float* x, const void* c, int c_is_bf16,
                                       float* out, const DenseTables* t, int batch, int nz,
                                       int nx, int ny, cudaStream_t stream);

cudaError_t launch_diffuse_apply_dense_halo(const float* x, const void* c, int c_is_bf16,
                                            float* out, const DenseTables* t, const DenseHalo* h,
                                            int batch, int nz, int nx, int ny,
                                            cudaStream_t stream);

// The launch configuration of the vector-load kernel for float32 or
// bfloat16 coefficients and nd dofs on the current device: threads per
// block, dynamic shared memory per block (bytes) and resident blocks per SM.
cudaError_t diffuse_apply_dense_config(int c_is_bf16, int nd, int* threads, int* smem_bytes,
                                       int* blocks_per_sm);

#ifdef __cplusplus
}
#endif
