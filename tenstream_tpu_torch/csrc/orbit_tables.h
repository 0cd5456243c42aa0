// Interface of the diffuse-operator kernels (orbit_ops.cu) to their binding
// (bind.cpp).  Plain C: no PyTorch headers, so the CUDA source compiles in
// seconds.
//
// K1 and K2 are compiled for each table set of orbit_schemes.h (generated
// from the Python tables); `inst` is its index there, the position of its
// scheme in cuda_ops.py's ORBIT_SCHEMES.
#pragma once

#include <cuda_runtime.h>

#ifdef __cplusplus
extern "C" {
#endif

// Diffuse dofs and orbit channels of instantiation inst; 0 on success, -1
// for an index with no instantiation.
int orbit_scheme_dims(int inst, int* nd, int* norb);

// K2: contrib[b, d] = sum over groups (o, ss) of orb[b, o] * sum_{s in ss}
// src[b, s]; src, out: (B, nd, ncell); orb: (B, norb, ncell).
cudaError_t launch_orbit_contract(int inst, const float* src, const float* orb, float* out,
                                  int batch, int ncell, cudaStream_t stream);

// K1: Au = u - S(u) with the face<->cell shifts, the orbit contraction and
// the surface albedo closure; dots[b] = (sum w*Au, sum Au*Au).  u, w, Au:
// (B, nd, nz+1, nx, ny); orb: (B, norb, nz, nx, ny); albedo: (B, nx, ny);
// partials: (B, nblk, 2) scratch, nblk from fused_A_dots_blocks (0 for an
// unknown instantiation); dots: (B, 2).  With halo != 0, u and orb are
// padded by a one-cell ring, (.., nx + 2, ny + 2), that replaces the
// wrap in x and y.
int fused_A_dots_blocks(int inst, int batch, int nz, int nx, int ny);
cudaError_t launch_fused_A_dots(int inst, const float* u, const float* w, const float* orb,
                                const float* albedo, float* Au, float* partials, float* dots,
                                int batch, int nz, int nx, int ny, int halo,
                                cudaStream_t stream);

#ifdef __cplusplus
}
#endif
