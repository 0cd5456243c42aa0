/* C API of tenstream_tpu_torch: embeds CPython and drives
 * `tenstream_tpu_torch.capi.bridge` (reference `c_wrapper/f2c_pprts.F90`,
 * bind(C) wrappers around the Fortran solver).  The native layer owns the
 * interpreter and marshals flat float arrays; the solves are the same
 * PyTorch / CUDA code as from Python.
 *
 * Built by `tenstream_tpu_torch/capi/build.py` with
 *   TT_REPO_ROOT  the checkout holding the package (put on sys.path)
 *   TT_PYTHON     the interpreter whose installation is embedded: its path
 *                 is the embedded interpreter's program name, so it finds
 *                 the same prefix and site-packages (virtual environments
 *                 included)
 */

#include "tenstream_tpu_torch.h"

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdio.h>
#include <string.h>

static PyObject *g_mod = NULL; /* the bridge module */
static int g_nz = 0, g_nx = 0, g_ny = 0;
static char g_device[64] = "cuda";

static int ensure_python(void) {
  if (!Py_IsInitialized()) {
    PyConfig config;
    PyConfig_InitPythonConfig(&config);
    config.install_signal_handlers = 0;
    PyStatus st = PyConfig_SetBytesString(&config, &config.program_name, TT_PYTHON);
    if (!PyStatus_Exception(st)) st = Py_InitializeFromConfig(&config);
    PyConfig_Clear(&config);
    if (PyStatus_Exception(st)) {
      fprintf(stderr, "tenstream_tpu_torch: cannot start Python (%s)\n",
              st.err_msg ? st.err_msg : "unknown error");
      return 1;
    }
  }
  if (g_mod == NULL) {
    PyObject *sys_path = PySys_GetObject("path");
    PyObject *here = PyUnicode_FromString(TT_REPO_ROOT);
    PyList_Insert(sys_path, 0, here);
    Py_DECREF(here);
    g_mod = PyImport_ImportModule("tenstream_tpu_torch.capi.bridge");
    if (g_mod == NULL) {
      PyErr_Print();
      return 1;
    }
  }
  return 0;
}

static PyObject *mk_f32_bytes(const float *data, Py_ssize_t n) {
  return PyBytes_FromStringAndSize((const char *)data, n * (Py_ssize_t)sizeof(float));
}

static PyObject *bytes_or_none(const float *data, Py_ssize_t n) {
  if (data) return mk_f32_bytes(data, n);
  Py_INCREF(Py_None);
  return Py_None;
}

static int call_and_check(PyObject *ret) {
  if (ret == NULL) {
    PyErr_Print();
    return 1;
  }
  Py_DECREF(ret);
  return 0;
}

static int need_module(void) {
  if (g_mod == NULL) {
    fprintf(stderr, "tenstream_tpu_torch: call tenstream_tpu_torch_init first\n");
    return 1;
  }
  return 0;
}

int tenstream_tpu_torch_set_device(const char *device) {
  snprintf(g_device, sizeof(g_device), "%s", device ? device : "cuda");
  return 0;
}

int tenstream_tpu_torch_init(int nz, int nx, int ny, double dx, double dy,
                             const float *dz1d, double phi0, double theta0,
                             const char *solver_name) {
  if (ensure_python()) return 1;
  g_nz = nz;
  g_nx = nx;
  g_ny = ny;
  PyObject *dz = mk_f32_bytes(dz1d, nz);
  PyObject *ret = PyObject_CallMethod(g_mod, "init", "iiiddOddss", nz, nx, ny, dx, dy, dz,
                                      phi0, theta0, solver_name, g_device);
  Py_DECREF(dz);
  return call_and_check(ret);
}

int tenstream_tpu_torch_set_optical_properties(double albedo, const float *kabs,
                                               const float *ksca, const float *g,
                                               const float *planck) {
  if (need_module()) return 1;
  Py_ssize_t ncell = (Py_ssize_t)g_nz * g_nx * g_ny;
  Py_ssize_t nlev = (Py_ssize_t)(g_nz + 1) * g_nx * g_ny;
  PyObject *a = mk_f32_bytes(kabs, ncell);
  PyObject *b = mk_f32_bytes(ksca, ncell);
  PyObject *c = mk_f32_bytes(g, ncell);
  PyObject *p = bytes_or_none(planck, nlev);
  PyObject *ret =
      PyObject_CallMethod(g_mod, "set_optical_properties", "dOOOO", albedo, a, b, c, p);
  Py_DECREF(a);
  Py_DECREF(b);
  Py_DECREF(c);
  Py_DECREF(p);
  return call_and_check(ret);
}

int tenstream_tpu_torch_solve(int lthermal, int lsolar, double edirTOA) {
  if (need_module()) return 1;
  PyObject *ret = PyObject_CallMethod(g_mod, "solve", "iid", lthermal, lsolar, edirTOA);
  return call_and_check(ret);
}

int tenstream_tpu_torch_get_result(float *edir, float *edn, float *eup, float *abso) {
  if (need_module()) return 1;
  PyObject *ret = PyObject_CallMethod(g_mod, "get_result", NULL);
  if (ret == NULL) {
    PyErr_Print();
    return 1;
  }
  /* a tuple of 4 bytes objects, edir None without a direct solve */
  float *dsts[4] = {edir, edn, eup, abso};
  for (int i = 0; i < 4; ++i) {
    PyObject *item = PyTuple_GetItem(ret, i);
    if (dsts[i] == NULL || item == Py_None) continue;
    char *buf = NULL;
    Py_ssize_t len = 0;
    if (PyBytes_AsStringAndSize(item, &buf, &len) != 0) {
      PyErr_Print();
      Py_DECREF(ret);
      return 1;
    }
    memcpy(dsts[i], buf, (size_t)len);
  }
  Py_DECREF(ret);
  return 0;
}

/* bytes objects backing the specint out-pointers; kept alive until the
 * next call or destroy (the reference returns pointers into solver-owned
 * Fortran arrays the same way) */
static PyObject *g_specint_bufs = NULL;

int tenstream_tpu_torch_specint(int nz, int nx, int ny, double dx, double dy,
                                double phi0, double theta0,
                                double albedo_thermal, double albedo_solar,
                                const char *specint, const char *solver_name,
                                const float *plev, const float *tlev,
                                const float *lwc, const float *reliq,
                                const float *iwc, const float *reice,
                                int lthermal, int lsolar, int *nz_merged,
                                const float **edir, const float **edn,
                                const float **eup, const float **abso) {
  if (ensure_python()) return 1;
  Py_ssize_t nlev = (Py_ssize_t)(nz + 1) * nx * ny;
  Py_ssize_t nlay = (Py_ssize_t)nz * nx * ny;
  PyObject *pl = mk_f32_bytes(plev, nlev);
  PyObject *tl = mk_f32_bytes(tlev, nlev);
  PyObject *lw = bytes_or_none(lwc, nlay);
  PyObject *rl = bytes_or_none(reliq, nlay);
  PyObject *iw = bytes_or_none(iwc, nlay);
  PyObject *ri = bytes_or_none(reice, nlay);
  PyObject *ret = PyObject_CallMethod(
      g_mod, "specint", "iiiddddddssOOOOOOiis", nz, nx, ny, dx, dy, phi0, theta0,
      albedo_thermal, albedo_solar, specint, solver_name, pl, tl, lw, rl, iw, ri, lthermal,
      lsolar, g_device);
  Py_DECREF(pl);
  Py_DECREF(tl);
  Py_DECREF(lw);
  Py_DECREF(rl);
  Py_DECREF(iw);
  Py_DECREF(ri);
  if (ret == NULL) {
    PyErr_Print();
    return 1;
  }
  Py_XDECREF(g_specint_bufs);
  g_specint_bufs = ret; /* tuple (nz_merged, edir, edn, eup, abso) */
  *nz_merged = (int)PyLong_AsLong(PyTuple_GetItem(ret, 0));
  const float **dsts[4] = {edir, edn, eup, abso};
  for (int i = 0; i < 4; ++i) {
    if (dsts[i] == NULL) continue;
    *dsts[i] = (const float *)PyBytes_AsString(PyTuple_GetItem(ret, i + 1));
  }
  return 0;
}

int tenstream_tpu_torch_destroy(int finalize_runtime) {
  Py_XDECREF(g_specint_bufs);
  g_specint_bufs = NULL;
  if (g_mod) {
    PyObject *ret = PyObject_CallMethod(g_mod, "destroy", NULL);
    if (ret) Py_DECREF(ret);
    if (finalize_runtime) {
      Py_XDECREF(g_mod);
      g_mod = NULL;
      Py_FinalizeEx();
    }
  }
  return 0;
}
