"""The port's domain Monte Carlo (`pprts/mcdmda.py::solve_mcdmda`) against
the JAX package, and the port's solvers against it.

Gates:
- the key schedule and the draws bit for bit with JAX's (`split(key, 3)`,
  the six keys of every step's `split(key, 6)`, both `fold_in`s, the first
  free paths), and the float32 functions a photon's step evaluates (exp,
  log, sin, cos, sqrt, floor division and remainder) bit for bit with
  `jnp`'s on the CPU;
- the tallies against JAX's under the same key on `tests/test_mcdmda.py`'s
  cloud scene at 16,384 photons: every field within 1e-4 of its largest
  value, domain means within 1e-5 relative, niter equal (the walks are
  equal photon for photon; JAX sums its tallies in float32);
- physics: one MC run of `tests/test_plexrt.py`'s wedge scene at its
  150,000 photons (a module fixture) closes its energy within 1%, and the
  port's 3_10 `PprtsSolver` (on `opp_small`'s table) and `PlexrtSolver`
  (the committed 5_8 test table) meet the JAX tests' gates against it:
  domain-mean TOA eup within 0.04 x edirTOA x mu, surface edir + edn
  within 0.05 x edirTOA x mu, the surface field's correlation above 0.8
  (3_10) and 0.85 (wedge)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tenstream_tpu.pprts.mcdmda import solve_mcdmda as jsolve
from tenstream_tpu.pprts.sun import sundir_from_angles
from tenstream_tpu_torch.convert import lut_from_arrays
from tenstream_tpu_torch.core import prng
from tenstream_tpu_torch.optprop.facade import OptProp
from tenstream_tpu_torch.plexrt.mesh import fish_mesh
from tenstream_tpu_torch.plexrt.optprop import WedgeOptProp, load_or_create_wedge_lut
from tenstream_tpu_torch.plexrt.solver import PlexrtSolver
from tenstream_tpu_torch.pprts import mcdmda
from tenstream_tpu_torch.pprts.grid import Grid
from tenstream_tpu_torch.pprts.solver import PprtsSolver
import torch_jax_cache  # noqa: F401  (one XLA compile per program per run)

LUTDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "luts")
FIELD_RTOL = 1e-4  # of the field's largest value
MEAN_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _words(key):
    return tuple(int(v) for v in np.asarray(key))


def test_key_schedule_and_draws_bit_for_bit():
    key = jax.random.PRNGKey(3)
    k0, k1, kloop = jax.random.split(key, 3)
    assert mcdmda._split(_words(key), 3) == [_words(k) for k in (k0, k1, kloop)]
    assert mcdmda._fold_in(_words(kloop), 0) == _words(jax.random.fold_in(kloop, 0))
    pid = torch.tensor([0, 1, 7, 999, 4095, 70000], dtype=torch.int64)

    def draws(words):
        y0, y1 = prng.threefry2x32(*words, torch.zeros_like(pid), pid)
        return prng.to_uniform(y0 ^ y1).numpy()

    jkey, pkey = kloop, _words(kloop)
    for _ in range(4):
        jkey, ks, kc, kp, kr, ka2 = jax.random.split(jkey, 6)
        pkey, keys = mcdmda._step_keys(pkey)
        want = [kc, kp, ks, kr, ka2, jax.random.fold_in(ka2, 1), jax.random.fold_in(kr, 2)]
        assert pkey == _words(jkey)
        assert keys == [_words(k) for k in want]
        for k in want:
            ju = np.asarray(jax.random.uniform(k, (70001,)))[pid.numpy()]
            assert np.array_equal(draws(_words(k)), ju)


def _math_cases():
    rng = np.random.default_rng(4)
    u = rng.random(400_000).astype(np.float32)
    # cell walls (not 0: XLA flushes the denormal below it to zero)
    cell = (rng.integers(1, 256, 200_000) * 100.0).astype(np.float32)
    near = np.concatenate([np.nextafter(cell, np.float32(-1)), cell, np.nextafter(cell, 1e6),
                           rng.uniform(0, 25600, 200_000).astype(np.float32)])
    return {
        "exp": (jnp.exp, mcdmda._exp, np.concatenate([-u * 87.0, -u * 1e-3])),
        "log": (jnp.log, mcdmda._log, np.maximum(np.concatenate([u, u * 1e-6]), 1e-12)),
        "sin": (jnp.sin, lambda y: mcdmda._sincos(y)[0], np.concatenate(
            [u * np.float32(2 * np.pi), u * 1e-3])),
        "cos": (jnp.cos, lambda y: mcdmda._sincos(y)[1], np.concatenate(
            [u * np.float32(2 * np.pi), u * 1e-3])),
        "sqrt": (jnp.sqrt, mcdmda._sqrt, u),
        "floordiv": (lambda x: x // jnp.float32(100.0), lambda x: mcdmda._floordiv(x, 100.0),
                     near),
        "remainder": (lambda x: x % jnp.float32(25600.0),
                      lambda x: mcdmda._remainder(x, 25600.0),
                      np.concatenate([near, near + 25600.0, -near])),
    }


@pytest.mark.parametrize("fma", ["torch", "float64"])
@pytest.mark.parametrize("name", list(_math_cases()))
def test_float32_math_bit_for_bit(name, fma, monkeypatch):
    """Both ways to one rounding of a * b + c: torch's fused operations
    (where they round once, as on this CPU) and the float64 emulation."""
    if fma == "float64":
        monkeypatch.setitem(mcdmda._FAST, "cpu", dict(mcdmda._fast("cpu"), fma=False))
    else:
        assert mcdmda._fast("cpu")["fma"]
    jfn, pfn, x = _math_cases()[name]
    x = x.astype(np.float32)
    want = np.asarray(jax.jit(jfn)(x))
    got = pfn(torch.from_numpy(x)).numpy()
    bad = np.flatnonzero(want != got)
    assert bad.size == 0, (bad.size, x[bad[:5]], want[bad[:5]], got[bad[:5]])


def _cloud_scene():
    """tests/test_mcdmda.py::test_mc_vs_3_10_cloud_scene's scene."""
    nz, nx, ny = 6, 12, 12
    kabs = np.full((nz, nx, ny), 1e-4, np.float32)
    ksca = np.full((nz, nx, ny), 5e-4, np.float32)
    g = np.full((nz, nx, ny), 0.4, np.float32)
    ksca[2:4, 4:8, 4:8] += 0.01
    kabs[2:4, 4:8, 4:8] += 0.001
    dz = np.full(nz, 100.0, np.float32)
    return kabs, ksca, g, dz, 0.2, sundir_from_angles(160.0, 35.0), 1000.0


@pytest.fixture(scope="module")
def jax_cloud_scene():
    kabs, ksca, g, dz, albedo, sundir, edir_toa = _cloud_scene()
    args = (kabs, ksca, g, dz, 100.0, 100.0, albedo, sundir, edir_toa)
    return args, jsolve(jax.random.PRNGKey(3), *args, n_photons=16384)


@pytest.mark.parametrize("path", ["compacting", "segments"])
def test_mc_matches_jax(jax_cloud_scene, path, monkeypatch):
    """Both walks (compacting every step; the masked segments the card
    replays from CUDA graphs, here from the second step on) equal JAX's."""
    args, ref = jax_cloud_scene
    if path == "segments":
        monkeypatch.setitem(mcdmda.DENSE_MAX, "cpu", 16383)
    mcdmda.reset_stats()
    got = mcdmda.solve_mcdmda(_words(jax.random.PRNGKey(3)), *args, n_photons=16384,
                              device="cpu")
    assert got.niter == int(ref.niter)
    assert mcdmda.STATS["steps"] == got.niter and mcdmda.STATS["photons"] == 16384
    for name in ("abso", "eup_toa", "edn_srfc", "sfc_absorbed"):
        want = np.asarray(getattr(ref, name), np.float64)
        have = getattr(got, name).numpy().astype(np.float64)
        assert have.shape == want.shape
        scale = np.abs(want).max()
        np.testing.assert_allclose(have, want, rtol=0, atol=FIELD_RTOL * scale, err_msg=name)
        assert abs(have.mean() - want.mean()) <= MEAN_RTOL * abs(want.mean()), name
    np.testing.assert_allclose(float(got.leftover), float(ref.leftover), rtol=1e-5, atol=1e-9)


def _sundir(phi_deg, theta_deg):
    """tests/test_plexrt.py's sun convention."""
    p, t = np.deg2rad(phi_deg), np.deg2rad(theta_deg)
    return np.array([np.sin(p) * np.sin(t), np.cos(p) * np.sin(t), -np.cos(t)])


def _wedge_scene():
    """tests/test_plexrt.py::test_wedge_solver_vs_domain_mc's scene."""
    nz, nx, ny = 6, 8, 8
    dz = np.full(nz, 100.0, np.float32)
    kabs = np.full((nz, nx, ny), 1e-4, np.float32)
    ksca = np.full((nz, nx, ny), 3e-4, np.float32)
    gg = np.full((nz, nx, ny), 0.5, np.float32)
    kabs[2:4, 3:6, 3:6] += 2e-3
    ksca[2:4, 3:6, 3:6] += 2e-2
    return kabs, ksca, gg, dz, 0.2, _sundir(30.0, 40.0), 1000.0


@pytest.fixture(scope="module")
def mc_wedge_scene():
    kabs, ksca, gg, dz, albedo, sundir, edir_toa = _wedge_scene()
    return mcdmda.solve_mcdmda(prng.Threefry.from_seed(5), kabs, ksca, gg, dz, 100.0, 100.0,
                               albedo, sundir, edir_toa, n_photons=150000, device="cpu")


def _check_vs_mc(mc, edir, edn, eup, cc_min):
    mu = np.cos(np.deg2rad(40.0))
    mc_eup = float(mc.eup_toa.mean())
    mc_dn = mc.edn_srfc.numpy()
    dn = edir[-1] + edn[-1]
    assert abs(float(eup[0].mean()) - mc_eup) < 0.04 * 1000.0 * mu, (eup[0].mean(), mc_eup)
    assert abs(float(dn.mean()) - float(mc_dn.mean())) < 0.05 * 1000.0 * mu, (
        dn.mean(), mc_dn.mean())
    cc = np.corrcoef(mc_dn.ravel(), dn.ravel())[0, 1]
    assert cc > cc_min, cc


def test_mc_energy_closes(mc_wedge_scene):
    mc = mc_wedge_scene
    dz = _wedge_scene()[3]
    total = (float(mc.eup_toa.mean()) + float((mc.abso.numpy() * dz[:, None, None]).sum(0).mean())
             + float(mc.sfc_absorbed.mean()))
    incoming = 1000.0 * np.cos(np.deg2rad(40.0))
    assert abs(total - incoming) / incoming < 0.01, (total, incoming)
    assert float(mc.leftover) < 1e-3


def test_port_3_10_solver_vs_mc(mc_wedge_scene, opp_small):
    kabs, ksca, gg, dz, albedo, sundir, edir_toa = _wedge_scene()
    nz, nx, ny = kabs.shape
    solver = PprtsSolver(Grid.create(nz, nx, ny, 100.0, 100.0, 100.0, device="cpu"),
                         OptProp(lut_from_arrays(opp_small.lut, "cpu"), device="cpu"))
    solver.set_optical_properties(albedo, kabs, ksca, gg)
    solver.set_angles(sundir)
    solver.solve(lthermal=False, lsolar=True, edirTOA=edir_toa)
    edir, edn, eup, _ = (a.numpy() for a in solver.get_result())
    _check_vs_mc(mc_wedge_scene, edir, edn, eup, 0.8)


def test_port_wedge_solver_vs_mc(mc_wedge_scene):
    kabs, ksca, gg, dz, albedo, sundir, edir_toa = _wedge_scene()
    nz, nx, ny = kabs.shape
    opp = WedgeOptProp(load_or_create_wedge_lut(n_photons=1500, basename=LUTDIR, device="cpu"))
    solver = PlexrtSolver(fish_mesh(nz, nx, ny, 100.0, 100.0, 100.0), opp)
    per_tri = lambda a: np.repeat(a[:, None], 2, axis=1)
    solver.set_optical_properties(albedo, per_tri(kabs), per_tri(ksca), per_tri(gg))
    solver.set_angles(sundir)
    sol = solver.solve(lthermal=False, lsolar=True, edirTOA=edir_toa)
    edir, edn, eup, _ = (a.numpy() for a in solver.get_result(sol))
    # the surface field per column: the two triangles averaged
    _check_vs_mc(mc_wedge_scene, edir.mean(axis=1), edn.mean(axis=1), eup.mean(axis=1), 0.85)
