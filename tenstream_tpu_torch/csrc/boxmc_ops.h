// Exit tables of the BoxMC photon tracer (boxmc_ops.cu) and its binding
// (bind.cpp).  Plain C: no PyTorch headers, so the CUDA source compiles in
// seconds.
#pragma once

#include <cuda_runtime.h>

#define BOXMC_PHOTONS 5120  // photons per entry (the TPU kernel's 8 x 640 batch)
#define BOXMC_NPARAM 9      // tauz, w0, aspect, g, phi, theta, seed, face, zsign

// One scheme's exit classification, passed to the kernel by value: the
// tally code of a photon leaving through face f is dir_code[f] when it is
// still direct (-1: tallied nowhere), else diff_dn[f] / diff_up[f] by the
// sign of its z direction.  Diffuse codes are already offset by ndir.
typedef struct {
  int dir_code[6];
  int diff_dn[6];
  int diff_up[6];
} BoxTables;

#ifdef __cplusplus
extern "C" {
#endif

// Traces BOXMC_PHOTONS photons for each of `batch` entries; params is
// (batch, BOXMC_NPARAM) float32, out (batch, ndir + ndiff) float32 [T | S],
// steps (batch,) int64: photon-steps (loop iterations entered alive).
// (ldir, ndir, ndiff) must be one of the instantiated layouts: (1 or 0) x
// {(1, 2), (3, 6), (3, 10), (8, 10)}; others return cudaErrorInvalidValue.
cudaError_t launch_boxmc_trace(const float* params, float* out, long long* steps,
                               const BoxTables* t, int ldir, int ndir, int ndiff, int batch,
                               int max_iter, cudaStream_t stream);

#ifdef __cplusplus
}
#endif
