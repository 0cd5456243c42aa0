// Tables of the diffuse-operator kernels (orbit_ops.cu) and their binding
// (bind.cpp).  Plain C: no PyTorch
// headers, so the CUDA source compiles in seconds.
#pragma once

#include <cuda_runtime.h>

#define TS_MAXD 10  // diffuse dofs per cell (3_10)

// One diffuse scheme's orbit-contraction tables for K2, passed to the kernel
// by value (about 0.8 KB of the 4 KB parameter space).
typedef struct {
  int nd;                         // diffuse dofs
  int norb;                       // orbit channels of the coefficient field
  int ngroups[TS_MAXD];           // orbit groups feeding dst d
  int gorb[TS_MAXD][TS_MAXD];     // orbit channel of group g of dst d
  int gmask[TS_MAXD][TS_MAXD];    // bit s set: source s belongs to group g
} OrbitTables;

#ifdef __cplusplus
extern "C" {
#endif

// contrib[b, d] = sum over groups (o, ss) of orb[b, o] * sum_{s in ss} src[b, s]
// src, out: (B, nd, ncell); orb: (B, norb, ncell).
cudaError_t launch_orbit_contract(const float* src, const float* orb, float* out,
                                  const OrbitTables* t, int batch, int ncell,
                                  cudaStream_t stream);

// K1 (compiled for the 3_10 tables of orbit_3_10.h): Au = u - S(u) with
// the face<->cell shifts, the orbit contraction and the surface albedo
// closure; dots[b] = (sum w*Au, sum Au*Au).  u, w, Au: (B, 10, nz+1, nx,
// ny); orb: (B, 24, nz, nx, ny); albedo: (B, nx, ny); partials: (B, nblk,
// 2) scratch, nblk from fused_A_dots_blocks; dots: (B, 2).
int fused_A_dots_blocks(int batch, int nz, int nx, int ny);
cudaError_t launch_fused_A_dots(const float* u, const float* w, const float* orb,
                                const float* albedo, float* Au, float* partials,
                                float* dots, int batch, int nz, int nx, int ny,
                                cudaStream_t stream);

#ifdef __cplusplus
}
#endif
