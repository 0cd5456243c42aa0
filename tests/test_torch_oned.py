"""The port's 1-D column solvers against the JAX package on the same seeded
inputs: `schwarzschild`, `disort_fluxes`, the `pprts/oned.py` column
drivers and `PprtsSolver` with solver_type "2str", "schwarzschild" and
"disort", with and without an OptProp.

Tolerances, each relative to the largest magnitude of the compared field:
two-stream and Schwarzschild 1e-5 (measured up to 3e-6: float32 in another
order of operations); DISORT 1e-4 (measured up to 2.3e-5: its batched
8x8 inverses, solves and products sum in another order than XLA's, through
up to 14 doublings).  The scenes have odd nz, more than one column and
albedo other than 0, so a reversed history or a swapped level shows."""

import os

import numpy as np
import pytest
import torch

from tenstream_tpu.core.config import Options as JOptions
from tenstream_tpu.ops.disort import disort_fluxes as jdisort
from tenstream_tpu.ops.planck import schwarzschild_radiance_step as jstep
from tenstream_tpu.ops.planck import stefan_boltzmann_radiance as jsb
from tenstream_tpu.ops.schwarzschild import schwarzschild as jschwarz
from tenstream_tpu.optprop.facade import OptProp as JOptProp
from tenstream_tpu.optprop.lut import load_or_create_lut, mockup_axes
from tenstream_tpu.pprts import oned as joned
from tenstream_tpu.pprts.grid import Grid as JGrid
from tenstream_tpu.pprts.solver import PprtsSolver as JSolver
from tenstream_tpu.pprts.sun import sundir_from_angles as jsun
from tenstream_tpu_torch.convert import lut_from_arrays
from tenstream_tpu_torch.core.config import Options
from tenstream_tpu_torch.ops.disort import disort_fluxes
from tenstream_tpu_torch.ops.planck import schwarzschild_radiance_step, stefan_boltzmann_radiance
from tenstream_tpu_torch.ops.schwarzschild import schwarzschild
from tenstream_tpu_torch.optprop.facade import OptProp
from tenstream_tpu_torch.pprts import oned
from tenstream_tpu_torch.pprts.grid import Grid
from tenstream_tpu_torch.pprts.solver import PprtsSolver
from tenstream_tpu_torch.pprts.sun import sundir_from_angles
import torch_jax_cache  # noqa: F401  (one XLA compile per program per run)

HERE = os.path.dirname(os.path.abspath(__file__))
RTOL_2STR = 1e-5
RTOL_DISORT = 1e-4
NZ, NX, NY = 7, 3, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small ops: one intra-op thread, no oversubscription when test
    files run in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(a, b, rtol, msg=""):
    """|port - JAX| <= rtol x max|JAX| over the field."""
    a = np.asarray(a, np.float64)
    b = b.detach().cpu().numpy().astype(np.float64) if isinstance(b, torch.Tensor) else b
    assert b.shape == a.shape, (msg, b.shape, a.shape)
    scale = max(float(np.abs(a).max()), 1e-30)
    err = float(np.abs(b - a).max())
    assert err <= rtol * scale, f"{msg}: max |port - JAX| {err:.3e} > {rtol} x {scale:.3e}"


def _column_scene(seed=0, thick=True):
    """Odd nz, 3x2 columns; w0, g and albedo vary; layer 3 is a thick
    anisotropic cloud (tau 30, g 0.85) when `thick`."""
    rng = np.random.default_rng(seed)
    dtau = rng.uniform(0.01, 2.0, (NZ, NX, NY)).astype(np.float32)
    w0 = rng.uniform(0.0, 0.99, (NZ, NX, NY)).astype(np.float32)
    g = rng.uniform(0.0, 0.9, (NZ, NX, NY)).astype(np.float32)
    if thick:
        dtau[3], w0[3], g[3] = 30.0, 0.999, 0.85
    albedo = rng.uniform(0.05, 0.5, (NX, NY)).astype(np.float32)
    planck = rng.uniform(50.0, 150.0, (NZ + 1, NX, NY)).astype(np.float32)
    return dtau, w0, g, albedo, planck


def _t(*arrays):
    return tuple(torch.as_tensor(a) for a in arrays)


def test_planck_helpers_match_jax():
    rng = np.random.default_rng(3)
    L, tau, bn, bf = (rng.uniform(0.0, 3.0, 50).astype(np.float32) for _ in range(4))
    tau[:10] = rng.uniform(0.0, 1e-3, 10).astype(np.float32)  # the thin-layer branch
    _close(jstep(L, tau, bn, bf), schwarzschild_radiance_step(*_t(L, tau, bn, bf)), 1e-6,
           "schwarzschild_radiance_step")
    T = np.array([200.0, 255.5, 300.0], np.float32)
    _close(jsb(T), stefan_boltzmann_radiance(T), 1e-6, "stefan_boltzmann_radiance")


@pytest.mark.parametrize("nmu", [2, 3])
@pytest.mark.parametrize("srfc", [False, True])
def test_schwarzschild_matches_jax(nmu, srfc):
    dtau, _, _, albedo, planck = _column_scene(1)
    se = (planck[-1] * 1.1).astype(np.float32) if srfc else None
    j = jschwarz(dtau * 0.3, albedo, planck, nmu=nmu, srfc_emission=se)
    t = schwarzschild(*_t(dtau * 0.3, albedo, planck), nmu=nmu,
                      srfc_emission=None if se is None else torch.as_tensor(se))
    for name, a, b in zip(("Edn", "Eup"), j, t):
        _close(a, b, RTOL_2STR, f"schwarzschild nmu={nmu} {name}")


@pytest.mark.parametrize("nstreams", [4, 8])
@pytest.mark.parametrize("kind", ["solar", "thermal", "both"])
def test_disort_matches_jax(nstreams, kind):
    dtau, w0, g, albedo, planck = _column_scene(2)
    solar = kind != "thermal"
    mu0, inc = (0.6, 1000.0) if solar else (None, 0.0)
    pl = planck if kind != "solar" else None
    j = jdisort(dtau, w0, g, mu0, inc, albedo, planck=pl, nstreams=nstreams)
    t = disort_fluxes(*_t(dtau, w0, g), mu0, inc, torch.as_tensor(albedo),
                      planck=None if pl is None else torch.as_tensor(pl), nstreams=nstreams)
    for name, a, b in zip(("S", "Edn", "Eup"), j, t):
        _close(a, b, RTOL_DISORT, f"disort {kind} N={nstreams} {name}")
    # energy: at the surface the absorbed flux is (1 - albedo) of what arrives
    if kind == "solar":
        S, Edn, Eup = (a.numpy() for a in t)
        np.testing.assert_allclose(Eup[-1], albedo * (Edn[-1] + 0.6 * S[-1]), rtol=1e-5)


def test_disort_planck_srfc_and_scalar_albedo_match_jax():
    dtau, w0, g, _, planck = _column_scene(4, thick=False)
    ps = (planck[-1] * 0.9).astype(np.float32)
    j = jdisort(dtau, w0, g, None, 0.0, 0.2, planck=planck, planck_srfc=ps, nstreams=4)
    t = disort_fluxes(*_t(dtau, w0, g), None, 0.0, 0.2, planck=torch.as_tensor(planck),
                      planck_srfc=torch.as_tensor(ps), nstreams=4)
    for name, a, b in zip(("S", "Edn", "Eup"), j, t):
        _close(a, b, RTOL_DISORT, f"disort planck_srfc {name}")


def _k_fields(seed=5):
    dtau, w0, g, albedo, planck = _column_scene(seed)
    dz = np.linspace(50.0, 350.0, NZ).astype(np.float32)[:, None, None] * np.ones(
        (NZ, NX, NY), np.float32)
    kext = dtau / dz
    return kext * (1 - w0), kext * w0, g, dz, albedo, planck


def test_oned_column_drivers_match_jax():
    kabs, ksca, g, dz, albedo, planck = _k_fields()
    j = joned.solve_twostream_columns(kabs, ksca, g, dz, 0.7, 900.0, albedo)
    t = oned.solve_twostream_columns(*_t(kabs, ksca, g, dz), 0.7, 900.0, torch.as_tensor(albedo))
    for name, a, b in zip(("S", "Edn", "Eup", "abso"), j, t):
        _close(a, b, RTOL_2STR, f"twostream columns solar {name}")
    j = joned.solve_twostream_columns(kabs, ksca, g, dz, -1.0, 0.0, albedo, planck=planck,
                                      planck_srfc=planck[-1] * 1.05)
    t = oned.solve_twostream_columns(*_t(kabs, ksca, g, dz), -1.0, 0.0, torch.as_tensor(albedo),
                                     planck=torch.as_tensor(planck),
                                     planck_srfc=torch.as_tensor(planck[-1] * 1.05))
    for name, a, b in zip(("S", "Edn", "Eup", "abso"), j, t):
        _close(a, b, RTOL_2STR, f"twostream columns thermal {name}")
    j = joned.solve_schwarzschild_columns(kabs, dz, albedo, planck, nmu=3)
    t = oned.solve_schwarzschild_columns(*_t(kabs, dz, albedo, planck), nmu=3)
    for name, a, b in zip(("Edn", "Eup", "abso"), j, t):
        _close(a, b, RTOL_2STR, f"schwarzschild columns {name}")


@pytest.fixture(scope="module")
def jlut():
    return load_or_create_lut("3_10", mockup_axes(True), mockup_axes(False), n_photons=2000,
                              basename=os.path.join(HERE, "data", "luts"))


def _solvers(solver_type, lut, opts):
    kabs, ksca, g, dz, albedo, planck = _k_fields(6)
    dz1 = dz[:, 0, 0]
    jopp = None if lut is None else JOptProp(lut)
    topp = None if lut is None else OptProp(lut_from_arrays(lut, "cpu"), device="cpu")
    js = JSolver(JGrid.create(NZ, NX, NY, 100.0, 100.0, dz1), jopp,
                 options=JOptions(dict(opts), read_env=False), solver_type=solver_type)
    ts = PprtsSolver(Grid.create(NZ, NX, NY, 100.0, 100.0, dz1, device="cpu"), topp,
                     options=Options(dict(opts), read_env=False), solver_type=solver_type)
    for s, sun in ((js, jsun), (ts, sundir_from_angles)):
        s.set_angles(sun(210.0, 35.0))
        s.set_optical_properties(0.0, kabs, ksca, g, planck=planck, albedo_2d=albedo)
    return js, ts


@pytest.mark.parametrize("solver_type,opts", [
    ("2str", {}), ("schwarzschild", {}), ("2str", {"schwarzschild": True}),
    ("disort", {}), ("disort", {"disort_streams": 4}),
])
@pytest.mark.parametrize("with_lut", [False, True])
@pytest.mark.parametrize("request_kind", ["solar", "thermal", "both"])
def test_solver_1d_solve_and_result_match_jax(jlut, solver_type, opts, with_lut, request_kind):
    """`solve` + `get_result` of the 1-D solver types, with no OptProp and
    with one (the 1-D path ignores its tables)."""
    js, ts = _solvers(solver_type, jlut if with_lut else None, opts)
    lsolar, lthermal = request_kind != "thermal", request_kind != "solar"
    js.solve(lthermal, lsolar, edirTOA=1000.0, uid=3)
    sol = ts.solve(lthermal, lsolar, edirTOA=1000.0, uid=3)
    assert ts.solver_type == solver_type and sol.niter_diff == 0
    rtol = RTOL_DISORT if solver_type == "disort" else RTOL_2STR
    for name, a, b in zip(("edir", "edn", "eup", "abso"), js.get_result(3), ts.get_result(3)):
        if a is None:
            assert b is None, name
            continue
        _close(a, b, rtol, f"{solver_type} {opts} {request_kind} {name}")


def test_solver_without_optprop_needs_a_1d_type():
    grid = Grid.create(4, 2, 2, 100.0, 100.0, 100.0, device="cpu")
    assert PprtsSolver(grid).solver_type == "2str"
    with pytest.raises(ValueError, match="needs an OptProp"):
        PprtsSolver(grid, solver_type="3_10")
