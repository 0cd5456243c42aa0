/* Minimal C host-model demo of the port's C API, the counterpart of the
 * JAX package's `capi/demo_pprts.c` (reference `c_wrapper/pprts.c`):
 * init -> set optical properties -> solve -> print mean fluxes.
 *
 *   demo_pprts [--cpu] [--solver NAME] [--out FILE]
 *
 * --cpu solves on the CPU (default: the CUDA card), --solver picks the
 * scheme (default "2str", as the JAX demo), --out writes edir, edn, eup
 * (nz+1, nx, ny) and abso (nz, nx, ny) as raw float32 one after another. */

#include "tenstream_tpu_torch.h"
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

int main(int argc, char **argv) {
  const char *solver = "2str", *out = NULL;
  for (int i = 1; i < argc; ++i) {
    if (!strcmp(argv[i], "--cpu")) tenstream_tpu_torch_set_device("cpu");
    else if (!strcmp(argv[i], "--solver") && i + 1 < argc) solver = argv[++i];
    else if (!strcmp(argv[i], "--out") && i + 1 < argc) out = argv[++i];
    else {
      fprintf(stderr, "usage: %s [--cpu] [--solver NAME] [--out FILE]\n", argv[0]);
      return 64;
    }
  }
  const int nz = 8, nx = 8, ny = 8;
  float dz[8];
  for (int k = 0; k < nz; ++k) dz[k] = 100.0f;

  if (tenstream_tpu_torch_init(nz, nx, ny, 100.0, 100.0, dz, 180.0, 40.0, solver)) return 1;

  int ncell = nz * nx * ny;
  int nlev = (nz + 1) * nx * ny;
  float *kabs = calloc(ncell, sizeof(float));
  float *ksca = calloc(ncell, sizeof(float));
  float *g = calloc(ncell, sizeof(float));
  for (int i = 0; i < ncell; ++i) {
    kabs[i] = 1e-4f;
    ksca[i] = 1e-3f;
    g[i] = 0.5f;
  }
  if (tenstream_tpu_torch_set_optical_properties(0.2, kabs, ksca, g, NULL)) return 2;
  if (tenstream_tpu_torch_solve(0, 1, 1364.0)) return 3;

  float *edir = calloc(nlev, sizeof(float));
  float *edn = calloc(nlev, sizeof(float));
  float *eup = calloc(nlev, sizeof(float));
  float *abso = calloc(ncell, sizeof(float));
  if (tenstream_tpu_torch_get_result(edir, edn, eup, abso)) return 4;

  double m_toa = 0, m_sfc = 0, m_up = 0;
  for (int i = 0; i < nx * ny; ++i) {
    m_toa += edir[i];
    m_sfc += edir[nz * nx * ny + i];
    m_up += eup[i];
  }
  printf("edir TOA %.2f sfc %.2f, eup TOA %.2f W/m2\n", m_toa / (nx * ny),
         m_sfc / (nx * ny), m_up / (nx * ny));
  if (out) {
    FILE *fh = fopen(out, "wb");
    if (!fh) return 5;
    fwrite(edir, sizeof(float), nlev, fh);
    fwrite(edn, sizeof(float), nlev, fh);
    fwrite(eup, sizeof(float), nlev, fh);
    fwrite(abso, sizeof(float), ncell, fh);
    fclose(fh);
  }

  tenstream_tpu_torch_destroy(1);
  free(kabs); free(ksca); free(g);
  free(edir); free(edn); free(eup); free(abso);
  return 0;
}
