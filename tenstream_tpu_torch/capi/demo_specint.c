/* Full-spectrum C host demo of the port's C API, the counterpart of the
 * JAX package's `capi/demo_specint.c` (reference `c_wrapper/pprts_rrtmg.c`):
 * hand the solver a host-model slab (plev/tlev + a liquid cloud) and get
 * broadband LW+SW fluxes / heating on the merged grid back.
 *
 *   demo_specint [--cpu] [--solver NAME] [--specint NAME] [--in FILE] [--out FILE]
 *
 * --cpu solves on the CPU (default: the CUDA card); --solver (default
 * "2str", as the JAX demo) and --specint (default "ecckd") name the scheme
 * and the gas optics.  --in reads the slab from FILE instead of the built-in
 * 10 x 6 x 6 one: int32 nz, nx, ny, float64 dx, dy, then float32 plev, tlev
 * (nz+1, nx, ny) [Pa, K] and lwc (nz, nx, ny) [g/kg], TOA first.  --out writes
 * int32 nz_merged, then float32 edir, edn, eup (nz_merged+1, nx, ny) and abso
 * (nz_merged, nx, ny). */

#include "tenstream_tpu_torch.h"
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

static int read_all(FILE *fh, void *dst, size_t size, size_t n) {
  return fread(dst, size, n, fh) == n ? 0 : 1;
}

int main(int argc, char **argv) {
  const char *solver = "2str", *specname = "ecckd", *in = NULL, *out = NULL;
  for (int i = 1; i < argc; ++i) {
    if (!strcmp(argv[i], "--cpu")) tenstream_tpu_torch_set_device("cpu");
    else if (!strcmp(argv[i], "--solver") && i + 1 < argc) solver = argv[++i];
    else if (!strcmp(argv[i], "--specint") && i + 1 < argc) specname = argv[++i];
    else if (!strcmp(argv[i], "--in") && i + 1 < argc) in = argv[++i];
    else if (!strcmp(argv[i], "--out") && i + 1 < argc) out = argv[++i];
    else {
      fprintf(stderr, "usage: %s [--cpu] [--solver NAME] [--specint NAME] [--in FILE] "
              "[--out FILE]\n", argv[0]);
      return 64;
    }
  }
  int32_t dims[3] = {10, 6, 6};
  double dxy[2] = {100.0, 100.0};
  FILE *fin = NULL;
  if (in) {
    fin = fopen(in, "rb");
    if (!fin || read_all(fin, dims, sizeof(int32_t), 3) || read_all(fin, dxy, sizeof(double), 2))
      return 5;
  }
  const int nz = dims[0], nx = dims[1], ny = dims[2];
  size_t nlev = (size_t)(nz + 1) * nx * ny;
  size_t nlay = (size_t)nz * nx * ny;
  float *plev = malloc(nlev * sizeof(float));
  float *tlev = malloc(nlev * sizeof(float));
  float *lwc = calloc(nlay, sizeof(float));
  float *reliq = malloc(nlay * sizeof(float));
  for (size_t i = 0; i < nlay; ++i) reliq[i] = 10.0f;

  if (fin) {
    if (read_all(fin, plev, sizeof(float), nlev) || read_all(fin, tlev, sizeof(float), nlev) ||
        read_all(fin, lwc, sizeof(float), nlay))
      return 5;
    fclose(fin);
  } else {
    /* ~100 m layers near the surface: p from a crude hydrostatic profile,
     * TOA-first ordering, Pa */
    for (int k = 0; k <= nz; ++k) {
      float z = (float)(nz - k) * 100.0f;
      float p = 101325.0f * (1.0f - 2.25577e-5f * z);
      float t = 288.15f - 0.0065f * z;
      for (int i = 0; i < nx * ny; ++i) {
        plev[k * nx * ny + i] = p;
        tlev[k * nx * ny + i] = t;
      }
    }
    /* a cloud block at layers 4..5 in the middle of the domain [g/kg] */
    for (int k = 4; k <= 5; ++k)
      for (int i = 2; i < 4; ++i)
        for (int j = 2; j < 4; ++j)
          lwc[(k * nx + i) * ny + j] = 0.3f;
  }

  int nz_merged = 0;
  const float *edir, *edn, *eup, *abso;
  if (tenstream_tpu_torch_specint(nz, nx, ny, dxy[0], dxy[1], 180.0, 40.0, 0.1, 0.25,
                                  specname, solver, plev, tlev, lwc, reliq, NULL, NULL, 1, 1,
                                  &nz_merged, &edir, &edn, &eup, &abso))
    return 1;

  double toa_up = 0, sfc_dn = 0, sfc_dir = 0;
  int ncol = nx * ny;
  for (int i = 0; i < ncol; ++i) {
    toa_up += eup[i] / ncol;
    sfc_dn += edn[(size_t)nz_merged * ncol + i] / ncol;
    sfc_dir += edir[(size_t)nz_merged * ncol + i] / ncol;
  }
  printf("specint: nz_merged=%d  TOA up (OLR+SWup) %.1f  sfc edn %.1f  "
         "sfc edir %.1f W/m2\n", nz_merged, toa_up, sfc_dn, sfc_dir);
  if (out) {
    size_t mlev = (size_t)(nz_merged + 1) * ncol, mlay = (size_t)nz_merged * ncol;
    FILE *fh = fopen(out, "wb");
    if (!fh) return 6;
    int32_t nzm = nz_merged;
    fwrite(&nzm, sizeof(int32_t), 1, fh);
    fwrite(edir, sizeof(float), mlev, fh);
    fwrite(edn, sizeof(float), mlev, fh);
    fwrite(eup, sizeof(float), mlev, fh);
    fwrite(abso, sizeof(float), mlay, fh);
    fclose(fh);
  }
  int ok = nz_merged > nz && toa_up > 50.0 && sfc_dir > 10.0;
  tenstream_tpu_torch_destroy(1);
  free(plev); free(tlev); free(lwc); free(reliq);
  return (in || ok) ? 0 : 2;
}
