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

// One launch's buffers.  The wrapper allocates them: params (batch,
// BOXMC_NPARAM) float32; out (batch, ndir + ndiff) float32 [T | S]; steps
// (batch,) int64 and trips (1,) int64, both zeroed: photon-steps per entry
// (loop iterations entered alive) and the trace kernel's warp loop trips;
// queue (1,) uint32, zeroed: the photon queue's head; rec_code (batch *
// BOXMC_PHOTONS,) uint8 and rec_w (batch * BOXMC_PHOTONS,) float32: each
// photon's record (its tally code and weight); entry_scratch: each entry's
// starting constants, computed by the first of the launch's kernels.
typedef struct {
  const float* params;
  const int* order;  // (batch,) int32: the entries in the order the queue takes them
  float* out;
  long long* steps;
  long long* trips;
  unsigned int* queue;
  unsigned char* rec_code;
  float* rec_w;
  void* entry_scratch;  // batch * boxmc_entry_scratch_bytes() bytes, 16-byte aligned
  const BoxTables* tables;
  int batch;
} BoxmcLaunch;

#ifdef __cplusplus
extern "C" {
#endif

// Traces BOXMC_PHOTONS photons for each of the launch's entries (a trace
// kernel over all photons, then a reduction kernel per entry).  (ldir, ndir,
// ndiff) must be one of the instantiated layouts: (1 or 0) x {(1, 2), (3,
// 6), (3, 10), (8, 10)}, for which boxmc_layout_ok is 1; others return
// cudaErrorInvalidValue.
int boxmc_layout_ok(int ndir, int ndiff);
int boxmc_entry_scratch_bytes(void);
cudaError_t launch_boxmc_trace(const BoxmcLaunch* launch, int ldir, int ndir, int ndiff,
                               int max_iter, cudaStream_t stream);

#ifdef __cplusplus
}
#endif
