// Static stream tables shared by the diffuse-operator kernels
// (orbit_ops.cu) and their binding (bind.cpp).  Plain C: no PyTorch
// headers, so the CUDA source compiles in seconds.
#pragma once

#include <cuda_runtime.h>

#define TS_MAXD 10  // diffuse dofs per cell (3_10)
#define TS_MAXC 5   // distinct producing-cell shifts of the dst dofs

// One diffuse scheme's orbit-contraction and shift tables, passed to the
// kernels by value (about 1.1 KB of the 4 KB parameter space).
typedef struct {
  int nd;                         // diffuse dofs
  int norb;                       // orbit channels of the coefficient field
  int ncls;                       // number of producing-cell classes
  int ngroups[TS_MAXD];           // orbit groups feeding dst d
  int gorb[TS_MAXD][TS_MAXD];     // orbit channel of group g of dst d
  int gmask[TS_MAXD][TS_MAXD];    // bit s set: source s belongs to group g
  int gz[TS_MAXD], gx[TS_MAXD], gy[TS_MAXD];     // src s read at cell + g*
  int ccz[TS_MAXC], ccx[TS_MAXC], ccy[TS_MAXC];  // class: cell = face + cc*
  int cmask[TS_MAXC];             // bit d set: dst d is produced by class
  int dn_mask;                    // down-top dofs summed by the albedo closure
  float walb[TS_MAXD];            // closure weight of dst d (0: none)
} OrbitTables;

#ifdef __cplusplus
extern "C" {
#endif

// contrib[b, d] = sum over groups (o, ss) of orb[b, o] * sum_{s in ss} src[b, s]
// src, out: (B, nd, ncell); orb: (B, norb, ncell).
cudaError_t launch_orbit_contract(const float* src, const float* orb, float* out,
                                  const OrbitTables* t, int batch, int ncell,
                                  cudaStream_t stream);

// Au = u - S(u) with the face<->cell shifts, the orbit contraction and the
// surface albedo closure; dots[b] = (sum w*Au, sum Au*Au).
// u, w, Au: (B, nd, nz+1, nx, ny); orb: (B, norb, nz, nx, ny);
// albedo: (B, nx, ny); partials: (B, nblk, 2) scratch, nblk from
// fused_A_dots_blocks; dots: (B, 2).
int fused_A_dots_blocks(int nz, int nx, int ny);
cudaError_t launch_fused_A_dots(const float* u, const float* w, const float* orb,
                                const float* albedo, float* Au, float* partials,
                                float* dots, const OrbitTables* t, int batch,
                                int nz, int nx, int ny, cudaStream_t stream);

#ifdef __cplusplus
}
#endif
