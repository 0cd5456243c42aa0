"""(v) The main path decomposed: `specint_pprts` (ecCKD 32 + 32 in chunks
of 8, McICA on a partial cloud fraction, atm_collapse) on a 2 x 2 gloo
group of CPU processes against the port's undecomposed call, two steps
(a cold call and a warm one with the condensate changed, which runs on
the regrouped chunks).  Every rank draws McICA's numbers of its columns'
global positions: its block of the masks equals the undecomposed draw
bit for bit.

Gates: the chunks' iteration counts within 2 of the one-rank call's in
every band, fluxes within 0.1 W/m2 and absorption within 1e-4 W/m3 (the
kernel gates of `chip_smoke.py`): the decomposed call sums its dots and
norms in another order, so each band's solve rounds differently."""

import numpy as np
import pytest
import torch

from tenstream_tpu_torch.atm import setup_standard_atmosphere
from tenstream_tpu_torch.core.config import Options
from tenstream_tpu_torch.core.prng import Threefry
from tenstream_tpu_torch.optprop.facade import OptProp
from tenstream_tpu_torch.optprop.lut import LUT
from tenstream_tpu_torch.pprts.grid import Grid
from tenstream_tpu_torch.pprts.solver import PprtsSolver
from tenstream_tpu_torch.pprts.sun import sundir_from_angles
from tenstream_tpu_torch.spectral.ecckd import EcckdGasOptics
from tenstream_tpu_torch.spectral.mcica import mcica_subcolumns
from tenstream_tpu_torch.spectral.specint import specint_pprts
from torch_mesh_ranks import REPO, assemble, run_ranks

N = 8
DX = 500.0
NGPT, CHUNK = 32, 8
SUN = (120.0, 40.0)
LUT_PATH = f"{REPO}/data/luts/LUT_3_10_c54b559e13692ba9.npz"
FLUX_ATOL, ABSO_ATOL = 0.1, 1e-4
NITER_SLACK = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene():
    zlev = np.concatenate([np.geomspace(20e3, 3000.0, 8), np.arange(2500.0, -1.0, -500.0)])
    atm = setup_standard_atmosphere(z_grid=zlev)
    nlay = atm.nlay
    rng = np.random.default_rng(2)
    lwc = np.zeros((nlay, N, N), np.float32)
    lwc[nlay - 4:nlay - 2] = rng.uniform(0.05, 0.3, (2, N, N))
    cf = np.zeros((nlay, N, N), np.float32)
    cf[nlay - 4:nlay - 2] = rng.uniform(0.2, 0.9, (2, N, N))
    return zlev, atm, lwc, cf


def _collapse(atm):
    solver = PprtsSolver(Grid.create(atm.nlay, N, N, DX, DX, atm.dz.astype(np.float32),
                                     device="cpu"), solver_type="2str")
    l1d = np.asarray(solver._l1d, bool)
    return int(np.argmin(l1d)) if not l1d.all() else len(l1d)


def _niters(solver):
    return np.asarray([n for key in sorted(solver.solutions, key=repr)
                       for n in solver.solutions[key].niter_diff])


def test_decomposed_specint(tmp_path):
    zlev, atm, lwc, cf = _scene()
    K = _collapse(atm)
    assert K > 1
    # the undecomposed call
    solver = PprtsSolver(Grid.create(atm.nlay, N, N, DX, DX, atm.dz.astype(np.float32),
                                     device="cpu"),
                         OptProp(LUT.load(LUT_PATH, device="cpu"), device="cpu"),
                         options=Options({"atm_collapse": K, "specint_cache": "f32"},
                                         read_env=False))
    solver.set_angles(sundir_from_angles(*SUN))
    want, step_lwc = [], lwc
    for step in range(2):
        res = specint_pprts(solver, atm, albedo=0.15, lthermal=True, lsolar=True,
                            specint=EcckdGasOptics(n_gpt=NGPT), lwc=step_lwc, cld_frac=cf,
                            band_chunk=CHUNK)
        want.append([a.numpy() for a in res])
        step_lwc = step_lwc * np.float32(1.05)
    want_iters = _niters(solver)

    layout = (2, 2)
    res = run_ranks("specint", layout, dict(
        shape=np.array([atm.nlay, N, N]), dx=DX, dz=atm.dz.astype(np.float32), lut=LUT_PATH,
        zlev=zlev, lwc=lwc, cfrac=cf, ngpt=NGPT, chunk=CHUNK, collapse=K, sun=np.array(SUN)),
        tmp_path)
    masks = mcica_subcolumns(Threefry.from_seed(712).fold_in(0), torch.as_tensor(cf), NGPT)
    np.testing.assert_array_equal(assemble([r["masks"] for r in res], layout), masks.numpy())
    for r in res:  # every rank ran the same iterations, as many as the one-rank call
        np.testing.assert_array_equal(r["niters"], res[0]["niters"])
    assert res[0]["niters"].shape == want_iters.shape
    assert np.abs(res[0]["niters"] - want_iters).max() <= NITER_SLACK
    for step in range(2):
        for k, name in enumerate(("edir", "edn", "eup", "abso")):
            got = assemble([r[f"{name}{step}"] for r in res], layout)
            np.testing.assert_allclose(got, want[step][k], atol=ABSO_ATOL if k == 3 else FLUX_ATOL,
                                       err_msg=f"step {step} {name}")
