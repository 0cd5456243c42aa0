/* C API of tenstream_tpu_torch, the PyTorch/CUDA solver.
 *
 * The same functions and semantics as the JAX package's C API
 * (`capi/tenstream_tpu.h`), after the reference's C wrapper
 * (`c_wrapper/f2c_pprts.h:48-53`, `c_wrapper/f2c_pprts_rrtm.F90:48-161`):
 * a host model (an LES or NWP code in C or Fortran) hands the solver flat
 * float32 arrays and gets its results back.  The library embeds CPython
 * and drives `tenstream_tpu_torch.capi.bridge`; the solves run on the
 * CUDA card (the hand-written kernels) unless `tenstream_tpu_torch_set_device`
 * asks for the CPU.  All arrays are C-contiguous float32.
 */

#ifndef TENSTREAM_TPU_TORCH_CAPI_H
#define TENSTREAM_TPU_TORCH_CAPI_H

#ifdef __cplusplus
extern "C" {
#endif

/* The device of every later solve: "cuda" (the default) or "cpu", the C
 * form of the Python entry points' `device=`.  A "cuda" request without a
 * CUDA device makes init and specint fail with a message: they never
 * solve on the CPU instead.  Returns 0. */
int tenstream_tpu_torch_set_device(const char *device);

/* Initialize the runtime and the solver.
 *  nz, nx, ny : grid dimensions (z = TOA..surface layers)
 *  dx, dy     : horizontal grid spacing [m]
 *  dz1d       : layer thicknesses [m], length nz (TOA first)
 *  phi0,theta0: sun azimuth/zenith [deg] (reference angle convention)
 *  solver_name: stream scheme, e.g. "3_10", or a 1-D solver "2str",
 *               "schwarzschild", "disort"
 * Returns 0 on success. */
int tenstream_tpu_torch_init(int nz, int nx, int ny, double dx, double dy,
                             const float *dz1d, double phi0, double theta0,
                             const char *solver_name);

/* Set per-cell optical properties; arrays are (nz, nx, ny) C-order,
 * planck is (nz+1, nx, ny) or NULL for solar-only. */
int tenstream_tpu_torch_set_optical_properties(double albedo, const float *kabs,
                                               const float *ksca, const float *g,
                                               const float *planck);

/* Run a solve; edirTOA is the TOA direct irradiance [W/m2]. */
int tenstream_tpu_torch_solve(int lthermal, int lsolar, double edirTOA);

/* Fetch results; edir/edn/eup are (nz+1, nx, ny), abso is (nz, nx, ny),
 * all W/m2 resp. W/m3.  Any pointer may be NULL to skip. */
int tenstream_tpu_torch_get_result(float *edir, float *edn, float *eup, float *abso);

/* Full-spectrum (gas-optics) heating-rate solve, reference
 * `f2c_pprts_rrtmg` (`c_wrapper/f2c_pprts_rrtm.F90:48-161`): the host
 * slab (nz layers) is merged with the background atmosphere and the
 * broadband LW/SW result comes back on the MERGED grid.  Out pointers
 * reference library-owned buffers (valid until the next specint call or
 * destroy), shaped (*nz_merged+1, nx, ny) for fluxes and
 * (*nz_merged, nx, ny) for abso, C-order float32.
 *  plev, tlev  : (nz+1, nx, ny) level pressure [Pa] / temperature [K],
 *                TOA first (as the JAX package's: Pa, TOA-first)
 *  lwc, reliq  : (nz, nx, ny) liquid water [g/kg] / eff. radius [um], or NULL
 *  iwc, reice  : ice water / eff. radius, or NULL
 *  specint     : "ecckd" | "repwvl" | "rrtmg_sw" | "synthck" | "gray"
 *  solver_name : stream scheme, e.g. "3_10", or "2str"
 * Self-contained: no prior tenstream_tpu_torch_init needed. */
int tenstream_tpu_torch_specint(int nz, int nx, int ny, double dx, double dy,
                                double phi0, double theta0,
                                double albedo_thermal, double albedo_solar,
                                const char *specint, const char *solver_name,
                                const float *plev, const float *tlev,
                                const float *lwc, const float *reliq,
                                const float *iwc, const float *reice,
                                int lthermal, int lsolar, int *nz_merged,
                                const float **edir, const float **edn,
                                const float **eup, const float **abso);

/* Tear down the solver (and optionally the embedded interpreter). */
int tenstream_tpu_torch_destroy(int finalize_runtime);

#ifdef __cplusplus
}
#endif

#endif /* TENSTREAM_TPU_TORCH_CAPI_H */
