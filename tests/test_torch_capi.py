"""(vi) The port's C API (`tenstream_tpu_torch/capi/`): the library and
both demos built with `cc` from the repository's sources at first use, run
on the CPU (`--cpu`) at the JAX demos' sizes and with their solvers (2str),
and held to the JAX package's C API bridge (`capi/capi_bridge.py`, i.e.
JAX's `PprtsSolver` and `setup_tenstr_atm` + `specint_pprts`) called in this
process on the same inputs.  Gates those of `tests/test_torch_solver.py`
and `tests/test_torch_specint.py`: fluxes within 0.1 W/m2, absorption within
1e-4 W/m3.  `demo_pprts` on 3_10 (the mockup table the bridge loads, the
path of K1/K2 on the card) is held bit for bit to the same solve through
the port's Python API.  Without CUDA, asking for the card (the default
device) fails loudly."""

import importlib.util
import os
import shutil
import subprocess

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLUX_ATOL = 0.1
ABSO_ATOL = 1e-4
DEMO_TIMEOUT = 300

pytestmark = pytest.mark.skipif(shutil.which("cc") is None, reason="no C compiler")


@pytest.fixture(scope="module")
def built():
    from tenstream_tpu_torch.capi.build import build

    return build()


@pytest.fixture(scope="module")
def jax_bridge():
    spec = importlib.util.spec_from_file_location("jax_capi_bridge",
                                                  os.path.join(REPO, "capi", "capi_bridge.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# every demo run of the module: (demo, arguments); "no_cuda" asks for the card
RUNS = {"pprts": ("demo_pprts", "--cpu"), "pprts_3_10": ("demo_pprts", "--cpu", "--solver", "3_10"),
        "specint": ("demo_specint", "--cpu"), "no_cuda": ("demo_pprts",)}


@pytest.fixture(scope="module")
def demos(built, tmp_path_factory):
    """The module's demo processes, started together so that they run
    beside each other and beside the JAX references: key -> (process, the
    path of its --out file)."""
    import torch

    tmp = tmp_path_factory.mktemp("demos")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = {}
    for key, (name, *args) in RUNS.items():
        out = str(tmp / f"{key}.bin")
        if key == "no_cuda":
            if torch.cuda.is_available():
                continue
        else:
            args += ["--out", out]
        procs[key] = (subprocess.Popen([built[name], *args], stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True, env=env), out)
    yield procs
    for proc, _ in procs.values():
        proc.kill()
        proc.communicate()


def _demo(demos, key, check=True):
    """The finished run `key`: (its stdout, stderr and exit code, its --out path)."""
    proc, out = demos[key]
    stdout, stderr = proc.communicate(timeout=DEMO_TIMEOUT)
    if check and proc.returncode:
        raise AssertionError(f"{RUNS[key]}: exit {proc.returncode}\n{stdout}\n{stderr}")
    return subprocess.CompletedProcess(RUNS[key], proc.returncode, stdout, stderr), out


def _check(got, want, abso_atol, label):
    for name, a, b in zip(("edir", "edn", "eup"), got[:3], want[:3]):
        np.testing.assert_allclose(a, b, atol=FLUX_ATOL, err_msg=f"{label} {name}")
    np.testing.assert_allclose(got[3], want[3], atol=abso_atol, err_msg=f"{label} abso")


def _pprts_fields(path, n=8):
    """demo_pprts's --out file: edir, edn, eup (n+1, n, n), abso (n, n, n)."""
    raw = np.fromfile(path, np.float32)
    lev, lay = (n + 1) * n * n, n * n * n
    assert raw.size == 3 * lev + lay
    return [raw[i * lev:(i + 1) * lev].reshape(n + 1, n, n) for i in range(3)] + [
        raw[3 * lev:].reshape(n, n, n)]


def test_demo_pprts(demos, jax_bridge):
    """`demo_pprts` (8 x 8 x 8, 2str: the JAX demo's scene) against JAX's solve."""
    run, out = _demo(demos, "pprts")
    assert "edir TOA" in run.stdout
    toa = float(run.stdout.split("edir TOA")[1].split()[0])
    assert abs(toa - 1364.0 * np.cos(np.deg2rad(40.0))) < 1.0
    got = _pprts_fields(out)

    nz = n = 8
    lay = nz * n * n
    f = lambda v, size: np.full(size, v, np.float32).tobytes()
    jax_bridge.init(nz, n, n, 100.0, 100.0, f(100.0, nz), 180.0, 40.0, "2str")
    jax_bridge.set_optical_properties(0.2, f(1e-4, lay), f(1e-3, lay), f(0.5, lay), None)
    jax_bridge.solve(0, 1, 1364.0)
    want = [np.frombuffer(b, np.float32).reshape(a.shape)
            for a, b in zip(got, jax_bridge.get_result())]
    jax_bridge.destroy()
    _check(got, want, ABSO_ATOL, "demo_pprts 2str")


def test_demo_pprts_3_10_is_the_python_solve(demos):
    """`demo_pprts --solver 3_10` through the bridge's mockup table: the same
    fields as the port's Python API gives for the same solve, bit for bit."""
    from tenstream_tpu_torch.optprop.facade import OptProp
    from tenstream_tpu_torch.optprop.lut import load_or_create_lut, mockup_axes
    from tenstream_tpu_torch.pprts.grid import Grid
    from tenstream_tpu_torch.pprts.solver import PprtsSolver
    from tenstream_tpu_torch.pprts.sun import sundir_from_angles

    n = 8
    lut = load_or_create_lut("3_10", mockup_axes(True), mockup_axes(False), n_photons=2000,
                             device="cpu")
    solver = PprtsSolver(Grid.create(n, n, n, 100.0, 100.0, np.full(n, 100.0, np.float32),
                                     device="cpu"), OptProp(lut, device="cpu"))
    solver.set_angles(sundir_from_angles(180.0, 40.0))
    ones = np.ones((n, n, n), np.float32)
    solver.set_optical_properties(0.2, 1e-4 * ones, 1e-3 * ones, 0.5 * ones)
    solver.solve(lthermal=False, lsolar=True, edirTOA=1364.0)
    _, out = _demo(demos, "pprts_3_10")
    for a, b in zip(_pprts_fields(out), solver.get_result()):
        np.testing.assert_array_equal(a, b.numpy())


def test_demo_specint(demos, jax_bridge):
    """`demo_specint` (the JAX demo's 10 x 6 x 6 slab, ecCKD, 2str) against
    JAX's merged-grid spectral solve of the same slab."""
    nz, nx, ny = 10, 6, 6
    # the demo's slab, built as its C code builds it
    z = (nz - np.arange(nz + 1, dtype=np.float32)) * np.float32(100.0)
    p = np.float32(101325.0) * (np.float32(1.0) - np.float32(2.25577e-5) * z)
    t = np.float32(288.15) - np.float32(0.0065) * z
    plev = np.broadcast_to(p[:, None, None], (nz + 1, nx, ny)).astype(np.float32)
    tlev = np.broadcast_to(t[:, None, None], (nz + 1, nx, ny)).astype(np.float32)
    lwc = np.zeros((nz, nx, ny), np.float32)
    lwc[4:6, 2:4, 2:4] = 0.3
    reliq = np.full((nz, nx, ny), 10.0, np.float32)
    res = jax_bridge.specint(nz, nx, ny, 100.0, 100.0, 180.0, 40.0, 0.1, 0.25, "ecckd", "2str",
                             plev.tobytes(), tlev.tobytes(), lwc.tobytes(), reliq.tobytes(),
                             None, None, 1, 1)
    jax_bridge.destroy()
    run, out = _demo(demos, "specint")
    nzm = int(run.stdout.split("nz_merged=")[1].split()[0])
    assert nzm > 10  # background layers were merged on top of the slab
    raw = np.fromfile(out, np.float32)
    assert int(raw[:1].view(np.int32)[0]) == nzm
    lev = (nzm + 1) * nx * ny
    got = [raw[1 + i * lev:1 + (i + 1) * lev].reshape(nzm + 1, nx, ny) for i in range(3)]
    got.append(raw[1 + 3 * lev:].reshape(nzm, nx, ny))
    assert res[0] == nzm
    want = [np.frombuffer(b, np.float32).reshape(a.shape) for a, b in zip(got, res[1:])]
    _check(got, want, ABSO_ATOL, "demo_specint")


def test_cuda_without_cuda_fails(demos):
    """The default device is the card: without CUDA, init returns nonzero
    with a message and nothing is solved on the CPU instead."""
    if "no_cuda" not in demos:
        pytest.skip("a CUDA device is present")
    run, _ = _demo(demos, "no_cuda", check=False)
    assert run.returncode == 1  # the demo's exit for a failed init
    assert "CUDA is not available" in run.stderr
    assert "edir TOA" not in run.stdout
