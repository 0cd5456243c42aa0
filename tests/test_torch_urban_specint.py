"""Buildings inside the port's `specint_pprts` against the JAX spectral
driver: an urban box (6 layers of 10 m under 4 geometric layers to 20
km, 4x4 columns of 20 m, a two-column block and a one-cell hut) with
building faces at 300 K, on the committed production LUT.

Cases: ecCKD 32+32 solar+thermal, a cold call and a regrouped warm call
(the bands reordered by difficulty, warm states gathered band by band);
gray solar; gray thermal raises as in JAX (no per-band Planck function).
A chunk of two differing lanes equals each lane solved alone.

Gates (port vs JAX): fluxes within 0.1 W/m2 and absorption within 1e-4
W/m3 in the air, the gates of `test_torch_specint.py`; per-face fluxes
within 0.1 W/m2.  A cell inside a building absorbs everything that
reaches its faces, up to ~100 W/m3 in 10 m cells: its absorption is the
small difference of face powers near 4e5 W, which float32 carries to a
few parts in 1e6.  Solid cells are held at 1e-4 of their absorption
(the largest difference seen is 2e-5 of it)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tenstream_tpu.atm import setup_standard_atmosphere as jsetup
from tenstream_tpu.optprop.facade import OptProp as JOptProp
from tenstream_tpu.optprop.lut import LUT as JLUT
from tenstream_tpu.pprts import buildings as jb
from tenstream_tpu.pprts.grid import Grid as JGrid
from tenstream_tpu.pprts.solver import PprtsSolver as JSolver
from tenstream_tpu.pprts.sun import sundir_from_angles as jsun
from tenstream_tpu.spectral.ecckd import EcckdGasOptics as JEcckd
from tenstream_tpu.spectral.specint import specint_pprts as jspecint
from tenstream_tpu_torch.convert import (
    atmosphere_from_arrays,
    buildings_from_arrays,
    buildings_from_object,
    lut_from_arrays,
)
from tenstream_tpu_torch.optprop.facade import OptProp
from tenstream_tpu_torch.pprts.grid import Grid
from tenstream_tpu_torch.pprts.solver import PprtsSolver
from tenstream_tpu_torch.pprts.sun import sundir_from_angles
from tenstream_tpu_torch.spectral import specint_pprts
from tenstream_tpu_torch.spectral.ecckd import EcckdGasOptics
import torch_jax_cache  # noqa: F401  (one XLA compile per program per run)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LUT_PATH = os.path.join(REPO, "data", "luts", "LUT_3_10_production.npz")
FLUX_ATOL = 0.1
ABSO_ATOL = 1e-4
ABSO_RTOL_SOLID = 1e-4
NX = NY = 4
DX = 20.0
SUN = (250.0, 35.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene():
    zlev = np.concatenate([np.geomspace(20e3, 60.0, 5)[:-1], np.arange(60.0, -1.0, -10.0)])
    jatm = jsetup(z_grid=zlev)
    nz = jatm.nlay
    solid = np.zeros((nz, NX, NY), bool)
    solid[-3:, 1:3, 1] = True  # a block three cells high
    solid[-1, 3, 3] = True  # a hut
    return jatm, solid


@pytest.fixture(scope="module")
def jlut():
    return JLUT.load(LUT_PATH)


def _solvers(jlut):
    jatm, solid = _scene()
    nz, dz = jatm.nlay, np.asarray(jatm.dz, np.float32)
    js = JSolver(JGrid.create(nz, NX, NY, DX, DX, dz), JOptProp(jlut, analytic_dir2dir=False))
    ts = PprtsSolver(Grid.create(nz, NX, NY, DX, DX, dz, device="cpu"),
                     OptProp(lut_from_arrays(jlut, "cpu"), analytic_dir2dir=False, device="cpu"))
    js.set_angles(jsun(*SUN))
    ts.set_angles(sundir_from_angles(*SUN))
    jbld = jb.Buildings(solid=jnp.asarray(solid), albedo=0.4, temp=jnp.asarray(300.0))
    tbld = buildings_from_object(jbld, device="cpu")
    return js, ts, jbld, tbld, jatm, solid


def _fluxes(fl, to_np):
    return {k: {q: to_np(v) for q, v in d.items()} for k, d in fl.items()}


@pytest.fixture(scope="module")
def ecckd_calls(jlut):
    """A cold call, then a warm call with another ground albedo on the
    frozen difficulty grouping, through both drivers."""
    js, ts, jbld, tbld, jatm, solid = _solvers(jlut)
    atm = atmosphere_from_arrays(jatm)
    out = []
    for albedo in (0.15, 0.25):
        rj = jspecint(js, jatm, albedo=albedo, lthermal=True, lsolar=True,
                      specint=JEcckd(n_gpt=32), band_chunk=8, buildings=jbld)
        rt = specint_pprts(ts, atm, albedo=albedo, lthermal=True, lsolar=True,
                           specint=EcckdGasOptics(n_gpt=32), band_chunk=8, buildings=tbld)
        out.append(([np.asarray(a) for a in rj], [a.numpy() for a in rt],
                    _fluxes(jbld.fluxes, np.asarray), _fluxes(tbld.fluxes, lambda t: t.numpy())))
    return out, ts, solid


def _check(res_j, res_t, solid, label):
    for name, a, b in zip(("edir", "edn", "eup"), res_j[:3], res_t[:3]):
        np.testing.assert_allclose(b, a, atol=FLUX_ATOL, err_msg=f"{label} {name}")
    np.testing.assert_allclose(res_t[3][~solid], res_j[3][~solid], atol=ABSO_ATOL,
                               err_msg=f"{label} abso in the air")
    np.testing.assert_allclose(res_t[3][solid], res_j[3][solid], rtol=ABSO_RTOL_SOLID,
                               err_msg=f"{label} abso in the buildings")


def _check_faces(fj, ft, label):
    assert fj.keys() == ft.keys()
    for k in fj:
        for q in ("edir", "incoming", "outgoing"):
            np.testing.assert_allclose(ft[k][q], fj[k][q], atol=FLUX_ATOL,
                                       err_msg=f"{label} {k} {q}")


@pytest.mark.parametrize("step", [0, 1], ids=["cold", "warm_regrouped"])
def test_urban_ecckd_matches_jax(ecckd_calls, step):
    (res_j, res_t, fj, ft), ts, solid = ecckd_calls[0][step], ecckd_calls[1], ecckd_calls[2]
    _check(res_j, res_t, solid, f"ecckd {step}")
    _check_faces(fj, ft, f"ecckd {step}")
    # shadow and sunlit roofs: something to compare
    assert ft["roof"]["edir"].max() > 100.0
    assert res_t[0][-1][solid.any(axis=0)].max() < 1.0
    if step == 1:
        keys = {key for key, _ in ts._band_rows["solar"].values()}
        assert all(isinstance(k[1], tuple) for k in keys)  # regrouped chunk keys


def test_urban_face_emission_is_the_spectral_planck_sum(ecckd_calls):
    """outgoing = albedo * incoming + (1 - albedo) * pi * sum_g B_g(300 K)."""
    (_, _, _, ft), ts = ecckd_calls[0][0], ecckd_calls[1]
    B = float(EcckdGasOptics(n_gpt=32).planck_at(300.0).astype(np.float64).sum())
    np.testing.assert_allclose(B * np.pi, 5.670374419e-8 * 300.0 ** 4, rtol=0.03)
    roof = ft["roof"]
    m = roof["incoming"] != 0
    want = 0.4 * roof["incoming"][m] + 0.6 * np.pi * B
    np.testing.assert_allclose(roof["outgoing"][m], want, rtol=1e-5)
    assert ts._buildings.fluxes is not None


def test_urban_static_planck_refused_as_jax(jlut):
    js, ts, _, _, jatm, solid = _solvers(jlut)
    planck = np.where(solid, 140.0, 0.0).astype(np.float32)
    with pytest.raises(ValueError, match="buildings.temp") as ej:
        jspecint(js, jatm, albedo=0.15, lthermal=True, lsolar=True, specint="ecckd",
                 buildings=jb.Buildings(solid=jnp.asarray(solid), albedo=0.4,
                                        planck=jnp.asarray(planck)))
    with pytest.raises(ValueError, match="buildings.temp") as et:
        specint_pprts(ts, atmosphere_from_arrays(jatm), albedo=0.15, lthermal=True,
                      lsolar=True, specint="ecckd",
                      buildings=buildings_from_arrays(solid, 0.4, planck=planck, device="cpu"))
    assert str(ej.value) == str(et.value)


def _rel(a, b):
    return float((a - b).abs().max()) / max(float(a.abs().max()), 1e-30)


@pytest.mark.parametrize("lthermal", [False, True], ids=["solar", "thermal"])
def test_chunk_of_two_differing_lanes_equals_each_alone(jlut, lthermal):
    """The building sources depend on each lane's direct beam (solar) and
    face Planck (thermal): two lanes that differ in both, as one chunk and
    each alone.  A source that broadcast lane 0 would fail here."""
    _, ts, _, tbld, jatm, _ = _solvers(jlut)
    ts.set_buildings(tbld)
    nz = jatm.nlay
    rng = np.random.default_rng(3)
    ka = torch.as_tensor(rng.uniform(1e-5, 1e-4, (2, nz, NX, NY)), dtype=torch.float32)
    ks = torch.as_tensor(rng.uniform(1e-5, 1e-4, (2, nz, NX, NY)), dtype=torch.float32)
    ka[1] *= 20.0
    g = torch.zeros_like(ka)
    alb = torch.full((NX, NY), 0.2)
    kw = dict(edirTOA=None if lthermal else np.array([300.0, 900.0], np.float32))
    if lthermal:
        T = torch.linspace(290.0, 230.0, nz + 1)
        planck = torch.stack([(5.67e-8 * T ** 4 / np.pi)[:, None, None].expand(nz + 1, NX, NY)
                              * f for f in (0.3, 0.1)])
        kw.update(planck=planck, planck_bldg=torch.stack(
            [torch.full((nz, NX, NY), v) for v in (40.0, 15.0)]))
    chunk = ts.solve_lanes(lthermal, not lthermal, ka, ks, g, alb, **kw)
    assert _rel(chunk.ediff[0], chunk.ediff[1]) > 0.1  # the lanes differ
    for i in range(2):
        lane = {k: (None if v is None else v[i:i + 1]) for k, v in kw.items()}
        alone = ts.solve_lanes(lthermal, not lthermal, ka[i:i + 1], ks[i:i + 1], g[i:i + 1],
                               alb, **lane)
        assert alone.niter[0] == chunk.niter[i], (i, alone.niter, chunk.niter)
        assert _rel(alone.ediff[0], chunk.ediff[i]) <= 1e-5, i
        assert _rel(alone.abso[0], chunk.abso[i]) <= 1e-5, i
        if not lthermal:
            assert _rel(alone.edir[0], chunk.edir[i]) <= 1e-5, i


def test_polish_that_diverges_returns_its_start():
    """The Richardson polish on an operator it cannot contract (random dense
    coefficients with row sums near 3): each lane stops once its residual
    passes `POLISH_DIVERGED` times its first one and returns its starting
    iterate, residual and omega, where the loop without the guard ran to
    NaN (phase 14 on the card).  A contractive operator polishes as
    before."""
    from tenstream_tpu_torch.pprts import ediff
    from tenstream_tpu_torch.streams import get_scheme

    scheme = get_scheme("3_10")
    g = torch.Generator().manual_seed(0)
    nz, nx, ny = 4, 3, 3
    c = torch.rand((2, 10, 10, nz, nx, ny), generator=g) * 0.3
    b = torch.rand((2, 10, nz + 1, nx, ny), generator=g)
    x0 = torch.rand((2, 10, nz + 1, nx, ny), generator=g)
    alb = torch.full((nx, ny), 0.2)
    r0 = [float(torch.linalg.vector_norm(b[i] + ediff._make_apply(scheme, c[i], alb)(x0[i])
                                         - x0[i])) for i in range(2)]
    x, it, om, res, _ = ediff.solve_richardson(scheme, c, b, alb, x0=x0, omega0=[0.9, 0.8],
                                               tol=[1e-6, 1e-6], precond="line", max_iter=200)
    assert torch.equal(x, x0) and om == [0.9, 0.8]
    assert max(it) < 30, it
    np.testing.assert_allclose(res, r0, rtol=1e-5)
    x, it, om, res, _ = ediff.solve_richardson(scheme, c * 0.1, b, alb, x0=x0,
                                               omega0=[0.9, 0.8], tol=[1e-3, 1e-3],
                                               precond="line", max_iter=200)
    assert all(r < 1e-3 for r in res) and not torch.equal(x, x0)
