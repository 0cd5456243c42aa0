"""The port's wedge solvers decomposed over gloo groups of CPU processes
(`PlexrtSolver.set_mesh` on (x, y) blocks, `PlexrtSolverIcon.set_mesh` on
ranges of the flat cell axis with ghost-cell exchanges), their NCA and
`specint_plexrt`, each rank feeding and reading its part.

(i) The fish solver on 2x1 and 2x2 against the JAX package's sharded
`PlexrtSolver` (on 2 x 2 devices) on the scene of `tests/test_plexrt.py`'s
sharded test, and against the port's undecomposed solve.  (ii) The ICON
solver on 2 and 4 ranks against JAX's `PlexrtSolverIcon` sharded over 4
devices on the scene of `tests/test_plexrt_icon.py`'s, and against the
undecomposed solve.  (iii)
NCA on both meshes, decomposed.  (iv) `specint_plexrt` (ecCKD, `max_gpt`
4, one chunk) on 2x2 against the undecomposed call.  (v) The ghost
exchange's lists on a distorted mesh against a brute-force gather, the
partition of a cell axis against JAX's `device_put`, and one rank bit for
bit the undecomposed solves.

Gates: against JAX and against the undecomposed solve, those of the JAX
sharded tests (rtol 5e-4, atol 1e-3), NCA within rtol 1e-4; a BiCGStab
solve's niter within 8 (its count moves by up to 8 under one float32
rounding of the inputs, ROADMAP section 3), a spectral lane's within 44
(`tests/test_torch_specint_plexrt.py`'s gate: the decomposed dots round
differently) and the fixed point's within 1.  Each group is spawned once (`tests/torch_mesh_ranks.py`, with
its timeout) and runs every case of its layout."""

import concurrent.futures
import os
import warnings

import jax
import numpy as np
import pytest
import torch

from tenstream_tpu.parallel.mesh import make_mesh as jmake_mesh
from tenstream_tpu.plexrt import icon as jicon
from tenstream_tpu.plexrt.mesh import fish_mesh as jfish
from tenstream_tpu.plexrt.optprop import WedgeOptProp as JOptProp
from tenstream_tpu.plexrt.optprop import load_or_create_wedge_lut as jload
from tenstream_tpu.plexrt.solver import PlexrtSolver as JSolver
from tenstream_tpu.plexrt.solver_unstructured import PlexrtSolverIcon as JSolverIcon
from tenstream_tpu_torch.atm import setup_standard_atmosphere
from tenstream_tpu_torch.parallel.mesh import GhostExchange, cell_partition
from tenstream_tpu_torch.plexrt import icon
from tenstream_tpu_torch.plexrt.mesh import fish_mesh
from tenstream_tpu_torch.plexrt.optprop import WedgeOptProp, load_or_create_wedge_lut
from tenstream_tpu_torch.plexrt.solver import PlexrtSolver
from tenstream_tpu_torch.plexrt.solver_unstructured import PlexrtSolverIcon
from tenstream_tpu_torch.spectral.ecckd import EcckdGasOptics
from tenstream_tpu_torch.spectral.specint_plexrt import specint_plexrt
import torch_jax_cache  # noqa: F401  (one XLA compile per program per run)
from torch_mesh_ranks import assemble, run_ranks

LUTDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "luts")
NZ, N = 4, 8  # both JAX tests' scenes: 4 layers, 8 x 8 rectangles (128 ICON cells)
SUN = (25.0, 35.0)
ALBEDO, TOA = 0.2, 1000.0
JAX_TOL = ONE_TOL = dict(rtol=5e-4, atol=1e-3)
NITER_SLACK = {"bicgstab": 8, "fixedpoint": 1, "spectral": 44}
SPEC_N, MAX_GPT = 4, 4
LAYOUTS = ((1, 1), (2, 1), (2, 2))
FIELDS = ("edir", "edn", "eup", "abso")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sundir(phi_deg, theta_deg):
    p, t = np.deg2rad(phi_deg), np.deg2rad(theta_deg)
    return np.array([np.sin(p) * np.sin(t), np.cos(p) * np.sin(t), -np.cos(t)])


def _icon_cells(a):
    """(nz, 2, n, n) -> the ICON order c = 2 (i n + j) + o."""
    return np.ascontiguousarray(np.moveaxis(a, 1, -1).reshape(a.shape[0], -1))


def _distorted(n):
    base = icon.trimesh_from_structured(n, n, 100.0, 100.0)
    rng = np.random.default_rng(2)
    return icon.trimesh_from_points(base.verts + rng.uniform(-18.0, 18.0, base.verts.shape),
                                    base.tris)


def _inputs():
    """Every rank's inputs: the JAX tests' scenes, a Planck field for the
    thermal solves and NCA, a distorted mesh's field and the spectral scene."""
    rng = np.random.default_rng(11)  # tests/test_plexrt.py's sharded scene
    fish = dict(
        fish_ka=(1e-4 + 1e-3 * rng.random((NZ, 2, N, N))).astype(np.float32),
        fish_ks=(1e-4 + 8e-3 * rng.random((NZ, 2, N, N))).astype(np.float32),
        fish_g=np.full((NZ, 2, N, N), 0.4, np.float32))
    rng = np.random.default_rng(3)  # tests/test_plexrt_icon.py's
    nc = 2 * N * N
    ic = dict(icon_ka=(1e-4 + 1e-3 * rng.random((NZ, nc))).astype(np.float32),
              icon_ks=(1e-4 + 8e-3 * rng.random((NZ, nc))).astype(np.float32),
              icon_g=np.full((NZ, nc), 0.4, np.float32))
    rng = np.random.default_rng(5)
    planck = (np.linspace(2.0, 5.0, NZ + 1)[:, None, None, None]
              + 0.5 * rng.random((NZ + 1, 2, N, N))).astype(np.float32)
    d = _distorted(6)
    lwc = np.zeros((5, 2, SPEC_N, SPEC_N), np.float32)
    lwc[3, :, 0, 1] = 0.3
    lwc[2, 1, 3, 2] = 0.2
    return dict(lutdir=LUTDIR, sundir=_sundir(*SUN), albedo=ALBEDO, toa=TOA,
                fish_shape=np.array([NZ, N]), fish_planck=planck, **fish,
                icon_n=np.array([N, N]), icon_dz=np.full(NZ, 80.0, np.float32),
                icon_planck=_icon_cells(planck), **ic,
                dist_verts=d.verts, dist_tris=d.tris,
                dist_field=np.random.default_rng(9).random((2, d.ncell, 3)).astype(np.float32),
                zlev=np.linspace(5e3, 0.0, 6), max_gpt=MAX_GPT, spec_lwc=lwc,
                spec_lwc_icon=_icon_cells(lwc))


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """Each layout's ranks, spawned once per module and all layouts at once,
    beside this process's references: layout -> rank outputs."""
    pool = concurrent.futures.ThreadPoolExecutor(len(LAYOUTS))
    done = {}
    for layout in LAYOUTS:
        # the spectral cases run on 2x2 and one rank
        inp = {k: v for k, v in inputs.items() if k != "zlev" or layout != (2, 1)}
        done[layout] = pool.submit(run_ranks, "wedge", layout, inp,
                                   tmp_path_factory.mktemp("wedge"))
    yield lambda layout: done[layout].result()
    pool.shutdown()


def _opp():
    return WedgeOptProp(load_or_create_wedge_lut(n_photons=1500, basename=LUTDIR, device="cpu"))


def _run(solver, inp, prefix):
    """The undecomposed counterpart of `torch_mesh_ranks._wedge_run`."""
    solver.set_angles(inp["sundir"])
    ka, ks, g, planck = (inp[prefix + k] for k in ("ka", "ks", "g", "planck"))
    solver.set_optical_properties(ALBEDO, ka, ks, g)
    sol = solver.solve(lthermal=False, lsolar=True, edirTOA=TOA)
    out = {k: a.numpy() for k, a in zip(FIELDS, solver.get_result(sol))}
    solver.set_optical_properties(ALBEDO, ka, ks, g, planck=planck)
    sol_t = solver.solve(lthermal=True, lsolar=False)
    out["thermal_eup"] = solver.get_result(sol_t)[2].numpy()
    out["nca"] = solver.nca_absorption(sol_t).numpy()
    out["niter"] = np.asarray([sol.niter_diff, sol_t.niter_diff])
    return out


def _spec(inp, which):
    atm = setup_standard_atmosphere(z_grid=inp["zlev"])
    dz = np.asarray(atm.dz, np.float32)
    if which == "fish":
        solver = PlexrtSolver(fish_mesh(atm.nlay, SPEC_N, SPEC_N, 500.0, 500.0, dz), _opp())
        lwc = inp["spec_lwc"]
    else:
        solver = PlexrtSolverIcon(icon.trimesh_from_structured(SPEC_N, SPEC_N, 500.0, 500.0), dz,
                                  _opp())
        lwc = inp["spec_lwc_icon"]
    solver.set_angles(inp["sundir"])
    lanes, seen = solver.solve_lanes, []

    def lanes_seen(*a, **k):
        sol = lanes(*a, **k)
        seen.extend(sol.niter_diff.tolist())
        return sol

    solver.solve_lanes = lanes_seen
    res = specint_plexrt(solver, atm, 0.2, True, True, specint=EcckdGasOptics(n_gpt=32), lwc=lwc,
                         max_gpt=MAX_GPT, band_chunk=MAX_GPT)
    out = {k: getattr(res, k).numpy() for k in FIELDS}
    out["niter"] = np.asarray(seen)
    return out


@pytest.fixture(scope="module")
def one(inputs):
    """The port's undecomposed runs, keyed as the ranks' outputs."""
    out = {}
    for ds in ("bicgstab", "fixedpoint"):
        r = _run(PlexrtSolver(fish_mesh(NZ, N, N, 100.0, 100.0, 100.0), _opp(), diff_solver=ds),
                 inputs, "fish_")
        out.update({f"fish_{ds}_{k}": v for k, v in r.items()})
    r = _run(PlexrtSolverIcon(icon.trimesh_from_structured(N, N, 100.0, 100.0),
                              inputs["icon_dz"], _opp()), inputs, "icon_")
    out.update({f"icon_{k}": v for k, v in r.items()})
    for which in ("fish", "icon"):
        out.update({f"spec_{which}_{k}": v for k, v in _spec(inputs, which).items()})
    return out


def _glob(res, key, layout, icon_axis=False):
    """The global array of a rank output: blocks for the fish mesh, cell
    ranges (last axis) for the ICON mesh."""
    if icon_axis:
        return np.concatenate([r[key] for r in res], axis=-1)
    return assemble([r[key] for r in res], layout)


def _check_niter(got, want, ds, what):
    assert np.all(np.abs(np.asarray(got, int) - np.asarray(want, int)) <= NITER_SLACK[ds]), \
        (what, got, want)


def _same_on_ranks(res, key):
    """Equal on every rank; of the exchange stats the counts of exchanges
    and of all-reduces (the messages per exchange follow each rank's
    neighbours)."""
    sel = [0, 2] if key.endswith("stats") else slice(None)
    for r in res[1:]:
        np.testing.assert_array_equal(r[key][sel], res[0][key][sel], err_msg=key)


@pytest.fixture(scope="module")
def jax_opp():
    return JOptProp(jload(n_photons=1500, basename=LUTDIR))


def _jax_solar(js, inputs, prefix):
    """A JAX solver's solar solve of the scene: (niter, fields)."""
    js.set_optical_properties(ALBEDO, *(inputs[prefix + k] for k in ("ka", "ks", "g")))
    js.set_angles(inputs["sundir"])
    jsol = js.solve(lthermal=False, lsolar=True, edirTOA=TOA)
    return int(np.asarray(jsol.niter_diff)), [np.asarray(a) for a in js.get_result(jsol)]


@pytest.fixture(scope="module")
def jax_fish(inputs, jax_opp):
    """JAX's sharded fish solve on 2 x 2 devices, the reference of every
    layout: the JAX test holds any sharding to the unsharded solve."""
    js = JSolver(jfish(NZ, N, N, 100.0, 100.0, 100.0), jax_opp)
    js.set_mesh(jmake_mesh(jax.devices()[:4], nxproc=2, nyproc=2))
    return _jax_solar(js, inputs, "fish_")


@pytest.fixture(scope="module")
def jax_icon(inputs, jax_opp):
    """JAX's ICON solve sharded over 4 devices' ranges of cells, the
    reference of every layout."""
    js = JSolverIcon(jicon.trimesh_from_structured(N, N, 100.0, 100.0), inputs["icon_dz"],
                     jax_opp)
    js.set_mesh(jmake_mesh(jax.devices()[:4]))
    return _jax_solar(js, inputs, "icon_")


@pytest.mark.skipif(len(jax.devices()) < 4, reason="needs 4 virtual devices")
@pytest.mark.parametrize("layout", [(2, 1), (2, 2)], ids=lambda v: f"{v[0]}x{v[1]}")
def test_fish_decomposed(layout, inputs, ranks, one, jax_fish):
    """(i) The fish solver on (x, y) blocks."""
    res = ranks(layout)
    for ds in ("bicgstab", "fixedpoint"):
        p = f"fish_{ds}_"
        for k in ("niter", "stats"):
            _same_on_ranks(res, p + k)  # every rank iterated and exchanged alike
        for r in res:  # the global field on every rank
            np.testing.assert_array_equal(r[p + "edn_global"], _glob(res, p + "edn", layout))
        _check_niter(res[0][p + "niter"], one[p + "niter"], ds, p)
        for k in FIELDS + ("thermal_eup",):
            np.testing.assert_allclose(_glob(res, p + k, layout), one[p + k], **ONE_TOL,
                                       err_msg=f"one rank, {p}{k}")
    # the direct sweep exchanges once per inner step and layer, all planes together
    assert res[0]["fish_bicgstab_stats"][0] >= NZ * 24

    niter, fields = jax_fish
    _check_niter(res[0]["fish_bicgstab_niter"][:1], [niter], "bicgstab", "JAX")
    for k, want in zip(FIELDS, fields):
        np.testing.assert_allclose(_glob(res, "fish_bicgstab_" + k, layout), want,
                                   **JAX_TOL, err_msg=f"JAX sharded, {k}")


@pytest.mark.skipif(len(jax.devices()) < 4, reason="needs 4 virtual devices")
@pytest.mark.parametrize("layout", [(2, 1), (2, 2)], ids=lambda v: f"{v[0] * v[1]}ranks")
def test_icon_decomposed(layout, inputs, ranks, one, jax_icon):
    """(ii) The ICON solver on ranges of its 128 cells."""
    res = ranks(layout)
    for k in ("icon_niter", "icon_stats"):
        _same_on_ranks(res, k)
    parts = cell_partition(2 * N * N, len(res))
    for r, (lo, hi) in zip(res, parts):  # scatter_global(cell_axis=) reads the rank's cells only
        assert tuple(r["icon_scatter_asked"]) == (lo, hi)
        np.testing.assert_array_equal(r["icon_scatter"], inputs["icon_ka"][:, lo:hi])
    for r in res:
        np.testing.assert_array_equal(r["icon_edn_global"],
                                      _glob(res, "icon_edn", layout, icon_axis=True))
    _check_niter(res[0]["icon_niter"], one["icon_niter"], "bicgstab", "icon")
    for k in FIELDS + ("thermal_eup",):
        np.testing.assert_allclose(_glob(res, "icon_" + k, layout, icon_axis=True),
                                   one["icon_" + k], **ONE_TOL, err_msg=f"one rank, {k}")

    niter, fields = jax_icon
    _check_niter(res[0]["icon_niter"][:1], [niter], "bicgstab", "JAX")
    for k, want in zip(FIELDS, fields):
        np.testing.assert_allclose(_glob(res, "icon_" + k, layout, icon_axis=True), want,
                                   **JAX_TOL, err_msg=f"JAX sharded, {k}")


@pytest.mark.parametrize("layout", [(2, 1), (2, 2)], ids=lambda v: f"{v[0]}x{v[1]}")
@pytest.mark.parametrize("which", ["fish_bicgstab", "fish_fixedpoint", "icon"])
def test_nca_decomposed(which, layout, ranks, one):
    """(iii) NCA on a decomposed thermal solve: the neighbours' fluxes
    through the halo or ghost-cell exchange."""
    res = ranks(layout)
    got = _glob(res, which + "_nca", layout, icon_axis=which == "icon")
    np.testing.assert_allclose(got, one[which + "_nca"], rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("which", ["fish", "icon"])
def test_specint_decomposed(which, ranks, one):
    """(iv) `specint_plexrt`, ecCKD solar and thermal, one chunk of 4
    g-points each, on 2x2 ranks (4 ranks of the ICON mesh's 32 cells)."""
    res = ranks((2, 2))
    p = f"spec_{which}_"
    _same_on_ranks(res, p + "niter")
    _check_niter(res[0][p + "niter"], one[p + "niter"], "spectral", p)
    for k in FIELDS:
        np.testing.assert_allclose(_glob(res, p + k, (2, 2), icon_axis=which == "icon"),
                                   one[p + k], **ONE_TOL, err_msg=f"{p}{k}")


def test_one_rank_bit_for_bit(ranks, one):
    """(v) A one-rank group is the undecomposed solve bit for bit: every
    roll, ghost exchange and all-reduce is a copy there."""
    (res,) = ranks((1, 1))
    for key, want in one.items():
        np.testing.assert_array_equal(res[key], want, err_msg=key)


class _Rank:
    """The layout of one rank, for building its exchange without a group."""

    def __init__(self, rank, world):
        self.rank, self.world = rank, world
        self.stats = {"exchanges": 0}


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_ghost_lists(world):
    """(v) Every rank's send and receive lists on a distorted mesh: the
    messages, delivered by hand, give each rank's cells exactly the
    brute-force gather of the global field, and carry only the ghosts."""
    d = _distorted(6)
    idx, valid = d.exchange_index(), d.nbr >= 0
    field = np.random.default_rng(9).random((2, d.ncell * 3)).astype(np.float32)
    parts = cell_partition(d.ncell, world)
    exs = [GhostExchange(_Rank(r, world), idx, valid, 3, "cpu") for r in range(world)]
    local = [torch.as_tensor(field[:, lo * 3:hi * 3]) for lo, hi in parts]
    for r, ex in enumerate(exs):
        got = [local[q].index_select(-1, dict(exs[q].sends)[r]) for q, _ in ex.recvs]
        assert [g.shape[-1] for g in got] == [n for _, n in ex.recvs]
        ext = torch.cat([local[r]] + got, dim=-1)
        lo, hi = parts[r]
        out = ext.index_select(-1, ex.index_local.reshape(-1)).reshape(2, hi - lo, 3).numpy()
        want = field[:, idx[lo:hi]]
        np.testing.assert_array_equal(np.where(valid[lo:hi], out, 0), np.where(valid[lo:hi],
                                                                               want, 0))
        # the ghosts are the cells of other ranks that this rank's cells touch, no more
        far = idx[lo:hi][valid[lo:hi]]
        far = np.unique(far[(far // 3 < lo) | (far // 3 >= hi)])
        assert ex.n_ghosts == far.size == sum(n for _, n in ex.recvs)
        assert (world == 1) == (ex.n_ghosts == 0)


def test_ghost_exchange_on_ranks(inputs, ranks):
    """(v) The ghost exchange through a real gloo group of 4 ranks against
    the brute-force gather."""
    res = ranks((2, 2))
    d = icon.trimesh_from_points(inputs["dist_verts"], inputs["dist_tris"])
    got = np.concatenate([r["dist_gather"] for r in res], axis=1)
    want = inputs["dist_field"].reshape(2, -1)[:, d.exchange_index()] * d.exchange_mask()
    np.testing.assert_array_equal(got, want)
    assert all(0 < int(r["dist_ghosts"][0]) < d.ncell for r in res)


def test_cell_partition_like_jax():
    """(v) A flat cell axis splits as JAX's `device_put` places
    `P(("x", "y"))` on the same mesh, and where the world size does not
    divide it both refuse."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    for nc, world in ((128, 4), (72, 3), (10, 4)):
        mesh = jmake_mesh(jax.devices()[:world])
        sharding = NamedSharding(mesh, P(None, ("x", "y")))
        if nc % world:
            with pytest.raises(ValueError):
                jax.device_put(np.zeros((2, nc), np.float32), sharding)
            with pytest.raises(ValueError):
                cell_partition(nc, world)
            continue
        a = jax.device_put(np.zeros((2, nc), np.float32), sharding)
        flat = list(mesh.devices.reshape(-1))
        want = sorted((flat.index(s.device), s.index[1].start, s.index[1].stop)
                      for s in a.addressable_shards)
        assert [(lo, hi) for _, lo, hi in want] == cell_partition(nc, world)
