"""The port's wedge tables, lookups and tuple BiCGStab against the JAX
package (`plexrt/optprop.py` lookup half, `ops/interp.py::interp_multilinear`
against the port's channels-first `interp_multilinear_cf`,
`ops/krylov.py::bicgstab_tree`), table creation through the port's
entry points on tiny grids, and the sharded solve refusing by name.

Gates: cache keys and file names equal; lookups within 1e-6 of the
value's magnitude (float32 sums of 2^k corner products in the JAX corner
order); BiCGStab the same iteration count and x within 1e-5.  No JAX
solve: the file takes a few seconds."""

import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tenstream_tpu.ops import interp as jinterp
from tenstream_tpu.ops.krylov import bicgstab_tree as jbicgstab
from tenstream_tpu.plexrt import icon as jicon
from tenstream_tpu.plexrt import optprop as jopt
from tenstream_tpu_torch.convert import wedge_lut_from_arrays
from tenstream_tpu_torch.ops import interp as tinterp
from tenstream_tpu_torch.ops.krylov import bicgstab_tree
from tenstream_tpu_torch.plexrt import icon as ticon
from tenstream_tpu_torch.plexrt import optprop as topt
from tenstream_tpu_torch.plexrt.mesh import fish_mesh
from tenstream_tpu_torch.plexrt.solver import PlexrtSolver
from tenstream_tpu_torch.plexrt.solver_unstructured import PlexrtSolverIcon
import torch_jax_cache  # noqa: F401  (one XLA compile per program per run)

HERE = os.path.dirname(os.path.abspath(__file__))
LUTDIR = os.path.join(HERE, "data", "luts")
LOOKUP_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def axes_18_8(mod):
    """The 18_8 test table's axes (`tests/test_wedge_schemes.py::opp18`)."""
    return mod.WedgeAxes(
        tau=np.array([1e-10, 0.5, 2.0, 8.0], np.float32),
        w0=np.array([0.0, 0.7, 0.99999], np.float32),
        aspect=np.array([0.5, 1.0, 2.0], np.float32),
        g=np.array([0.0, 0.5], np.float32),
        phi=np.linspace(0.0, 360.0, 5).astype(np.float32),
        theta=np.array([0.0, 40.0, 75.0], np.float32),
    )


def _port_axes(a):
    return topt.WedgeAxes(a.tau, a.w0, a.aspect, a.g, a.phi, a.theta)


TABLES = {  # name -> (daxes(mod), faxes(mod) or None, n_photons, basename, scheme)
    "test": (lambda m: m.test_axes(), None, 1500, LUTDIR, "5_8"),
    "18_8": (axes_18_8, None, 1000, LUTDIR, "18_8"),
    "default": (lambda m: m.default_axes(), None, 4000, None, "5_8"),
    "production": (lambda m: m.production_axes()[0], lambda m: m.production_axes()[1], 4000,
                   None, "5_8"),
}


def _load(mod, name, device="cpu"):
    da, fa, n, base, scheme = TABLES[name]
    kw = dict(device=device) if mod is topt else {}
    return mod.load_or_create_wedge_lut(da(mod), None if fa is None else fa(mod), n, base,
                                        scheme=scheme, **kw)


@pytest.mark.parametrize("name", sorted(TABLES))
def test_cache_keys_and_tables_equal(name):
    """The port names the same committed file as the JAX package and loads
    the same tables from it."""
    j, t = _load(jopt, name), _load(topt, name)
    assert t.daxes.hash() == j.daxes.hash() and t.faxes.hash() == j.faxes.hash()
    assert (t.scheme, t.apex) == (j.scheme, j.apex)
    for k in ("dir2dir", "dir2diff", "diff2diff"):
        np.testing.assert_array_equal(getattr(t, k).numpy(), np.asarray(getattr(j, k)))
    if name == "default":
        path = topt.wedge_lut_path(t.daxes, t.faxes, 4000)
        assert os.path.basename(path) == "WEDGE_LUT_5_8_2557284b9366b4c4.npz"


def test_apex_key_matches_jax():
    """An apex enters the key with four decimals, as in the JAX package."""
    da = jopt.test_axes()
    fa = jopt.WedgeAxes(da.tau, da.w0, da.aspect, da.g)
    for apex in ((0.5, 0.8660254), (0.31, 1.2)):
        ak = f"{apex[0]:.4f},{apex[1]:.4f}"
        import hashlib

        key = hashlib.sha256((da.hash() + fa.hash() + "5000" + ak).encode()).hexdigest()[:16]
        path = topt.wedge_lut_path(_port_axes(da), _port_axes(fa), 5000, "/x", apex=apex)
        assert path == os.path.join("/x", f"WEDGE_LUT_5_8_{key}.npz")


@pytest.mark.parametrize("k,payload", [(3, (2, 3)), (4, ()), (6, (4, 5))])
def test_interp_multilinear_matches_jax(k, payload):
    rng = np.random.default_rng(k)
    dims = tuple(int(d) for d in rng.integers(2, 6, k))
    table = rng.random(dims + payload).astype(np.float32)
    fracs = [rng.uniform(-0.5, d - 0.5, (3, 2, 5)).astype(np.float32) for d in dims]
    fracs[-1] = fracs[-1][:1, :, :1]  # a broadcast frac, as the per-orientation phi
    want = np.asarray(jinterp.interp_multilinear(jnp.asarray(table),
                                                 [jnp.broadcast_to(f, (3, 2, 5)) for f in fracs]))
    got = tinterp.interp_multilinear_cf(torch.as_tensor(table), [torch.as_tensor(f) for f in fracs])
    got = got.movedim(tuple(range(len(payload))), tuple(range(-len(payload), 0)))  # JAX's B + C
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=LOOKUP_RTOL, atol=LOOKUP_RTOL)


@pytest.mark.parametrize("name", ["test", "18_8", "default"])
def test_wedge_optprop_lookups_match_jax(name):
    jl = _load(jopt, name)
    jo, to = jopt.WedgeOptProp(jl), topt.WedgeOptProp(wedge_lut_from_arrays(jl, device="cpu"))
    rng = np.random.default_rng(5)
    shp = (3, 2, 4, 4)
    tauz = (10.0 ** rng.uniform(-4, 2.2, shp)).astype(np.float32)
    w0 = rng.uniform(0.0, 1.0, shp).astype(np.float32)
    g = rng.uniform(0.0, 0.9, shp).astype(np.float32)
    aspect = rng.uniform(0.1, 6.0, (3, 1, 1, 1)).astype(np.float32)
    phi = (rng.uniform(-200.0, 500.0) + np.array([0.0, 180.0], np.float32)[:, None, None])
    phi = phi.astype(np.float32)
    theta = 37.5
    t = torch.as_tensor
    outs = [(jo.diff_coeffs(tauz, w0, g, aspect),
             to.diff_coeffs(t(tauz), t(w0), t(g), t(aspect)))]
    outs += list(zip(jo.dir_coeffs(tauz, w0, g, aspect, phi, theta),
                     to.dir_coeffs(t(tauz), t(w0), t(g), t(aspect), t(phi), theta)))
    for want, got in outs:
        want = np.asarray(want)
        got = got.movedim((0, 1), (-2, -1))  # the port's lookups are channels-first
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=LOOKUP_RTOL, atol=LOOKUP_RTOL)


def _tuple_system(sym: bool, seed: int):
    rng = np.random.default_rng(seed)
    n = 19
    X = rng.normal(size=(n, n)).astype(np.float32) * 0.2
    M = (X @ X.T + 2.0 * np.eye(n)) if sym else (3.0 * np.eye(n) + X)
    M = M.astype(np.float32)
    b = (rng.normal(size=(3, 4)).astype(np.float32), rng.normal(size=(7,)).astype(np.float32))

    def apply(x, cat, lib):
        v = cat([x[0].reshape(-1), x[1]])
        y = lib(M) @ v
        return (y[:12].reshape(3, 4), y[12:])

    return M, b, apply


@pytest.mark.parametrize("sym", [True, False], ids=["spd", "nonsymmetric"])
def test_bicgstab_tree_matches_jax(sym):
    M, b, apply = _tuple_system(sym, 2 if sym else 3)
    xj, ij, rj, tj = jbicgstab(lambda x: apply(x, jnp.concatenate, jnp.asarray),
                               tuple(map(jnp.asarray, b)), rtol=1e-6)
    # the port's leaves lead with a lane dimension: one lane here
    one_lane = lambda x: tuple(a[None] for a in apply(tuple(c[0] for c in x), torch.cat,
                                                      torch.as_tensor))
    xt, it, rt, tt = bicgstab_tree(one_lane, tuple(torch.as_tensor(a)[None] for a in b), rtol=1e-6)
    assert int(it[0]) == int(ij)
    np.testing.assert_allclose(float(tt[0]), float(tj), rtol=1e-6)
    assert float(rt[0]) <= float(tt[0])
    for a, c in zip(xj, xt):
        np.testing.assert_allclose(c[0].numpy(), np.asarray(a), atol=1e-5)


def test_bicgstab_lanes_stop_on_their_own():
    """A lane stops at its own tolerance and keeps its state while another
    iterates: each lane equals its system solved alone."""
    M, b, _ = _tuple_system(False, 4)
    rng = np.random.default_rng(9)
    b2 = (10 * rng.normal(size=(3, 4)).astype(np.float32), rng.normal(size=(7,)).astype(np.float32))
    Mt = torch.as_tensor(M)

    def lanes_apply(x):
        v = torch.cat([x[0].reshape(x[0].shape[0], -1), x[1]], dim=1)
        y = v @ Mt.T
        return (y[:, :12].reshape(-1, 3, 4), y[:, 12:])

    bl = tuple(torch.stack([torch.as_tensor(p), torch.as_tensor(q)]) for p, q in zip(b, b2))
    xl, il, rl, tl = bicgstab_tree(lanes_apply, bl, rtol=1e-6)
    for lane in range(2):
        x1, i1, r1, t1 = bicgstab_tree(lanes_apply, tuple(a[lane:lane + 1] for a in bl), rtol=1e-6)
        assert int(il[lane]) == int(i1[0])
        for a, c in zip(xl, x1):
            np.testing.assert_allclose(a[lane].numpy(), c[0].numpy(), atol=1e-6)
        np.testing.assert_allclose(float(tl[lane]), float(t1[0]), rtol=1e-6)


# ---------------------------------------------------------------------------
# table creation: what used to refuse now traces (tests/test_torch_wedge_*.py
# hold the tracer and the tables to JAX's)
# ---------------------------------------------------------------------------

def _tiny_axes(mod):
    f = lambda *v: np.array(v, np.float32)
    return mod.WedgeAxes(f(1e-10, 1.0), f(0.0, 0.9), f(1.0, 2.0), f(0.0), f(0.0, 360.0), f(0.0))


def test_create_wedge_lut_refuses():
    """create_wedge_lut traces a table on the CPU: the tables' shapes, row
    sums within 1, a transparent cell's beam straight through."""
    a = _tiny_axes(topt)
    lut = topt.create_wedge_lut(a, topt.WedgeAxes(a.tau, a.w0, a.aspect, a.g), 200,
                                device="cpu")
    assert lut.dir2dir.shape == (2, 2, 2, 1, 2, 1, topt.n_dir_src(), 5)
    assert lut.dir2diff.shape == (2, 2, 2, 1, 2, 1, 4, 8) and lut.diff2diff.shape == (2, 2, 2, 1, 8, 8)
    for t in (lut.dir2dir + 0, lut.diff2diff):
        assert (t.sum(-1) <= 1.0 + 1e-3).all() and (t >= 0).all()
    # theta 0, tau 0: the top source's photons all leave through the bottom
    np.testing.assert_allclose(lut.dir2dir[0, 0, 0, 0, 0, 0, 0].numpy(), [0, 0, 0, 0, 1], atol=1e-6)


def test_missing_table_refuses_and_writes_nothing(tmp_path, monkeypatch):
    """A missing table is traced into its cache file; the port loads it back
    unchanged, and the JAX package finds it under the same key without
    tracing."""
    axes = _tiny_axes(topt)
    made = topt.load_or_create_wedge_lut(axes, n_photons=100, basename=str(tmp_path), device="cpu")
    path = topt.wedge_lut_path(axes, topt.WedgeAxes(axes.tau, axes.w0, axes.aspect, axes.g), 100,
                               str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == [os.path.basename(path)]  # no checkpoint: a small grid
    again = topt.load_or_create_wedge_lut(axes, n_photons=100, basename=str(tmp_path), device="cpu")
    monkeypatch.setattr(jopt, "create_wedge_lut", None)  # would raise if it tried to trace
    j = jopt.load_or_create_wedge_lut(_tiny_axes(jopt), n_photons=100, basename=str(tmp_path))
    for k in ("dir2dir", "dir2diff", "diff2diff"):
        assert torch.equal(getattr(made, k), getattr(again, k))
        np.testing.assert_array_equal(getattr(made, k).numpy(), np.asarray(getattr(j, k)))


def test_wedge_lut_for_mesh_without_a_committed_table_refuses(tmp_path):
    """wedge_lut_for_mesh traces the table at the mesh's mean cell shape,
    under the name the JAX package gives it."""
    m = ticon.trimesh_equilateral(3, 3, 100.0)
    lut = topt.wedge_lut_for_mesh(m, _tiny_axes(topt), n_photons=100, basename=str(tmp_path),
                                  device="cpu")
    np.testing.assert_allclose(lut.apex, (0.5, np.sqrt(3) / 2), atol=1e-6)
    # the shape the JAX package traces at
    assert np.allclose(topt.mesh_cell_shapes(m), jopt.mesh_cell_shapes(jicon.trimesh_equilateral(
        3, 3, 100.0)))
    a = _tiny_axes(topt)
    path = topt.wedge_lut_path(a, topt.WedgeAxes(a.tau, a.w0, a.aspect, a.g), 100, str(tmp_path),
                               apex=lut.apex)
    assert os.listdir(tmp_path) == [os.path.basename(path)]


def test_shape_blended_optprops_refuse(tmp_path):
    """wedge_optprop_for_mesh: one mean-shape table for a uniform mesh, four
    corner tables blended per cell for a distorted one; a blend needs a
    table."""
    axes = _tiny_axes(topt)
    kw = dict(n_photons=100, basename=str(tmp_path), device="cpu")
    uniform = topt.wedge_optprop_for_mesh(ticon.trimesh_equilateral(3, 3, 100.0), axes, **kw)
    assert isinstance(uniform, topt.WedgeOptProp)
    base = ticon.trimesh_from_structured(3, 3, 100.0, 100.0)
    rng = np.random.default_rng(2)
    m = ticon.trimesh_from_points(base.verts + rng.uniform(-18.0, 18.0, base.verts.shape),
                                  base.tris)
    blend = topt.wedge_optprop_for_mesh(m, axes, **kw)
    assert isinstance(blend, topt.WedgeOptPropShaped) and len(blend.luts) == 4
    np.testing.assert_allclose(blend._w.sum(0).numpy(), 1.0, atol=1e-6)
    assert len(os.listdir(tmp_path)) == 5
    with pytest.raises(ValueError, match="at least one"):
        topt.WedgeOptPropShaped([])


def test_icon_solver_refuses_a_shaped_optprop():
    """The ICON solver binds a shaped optprop's cells (the per-cell apexes,
    cy at least 1e-6) and leaves the azimuth map to it, as JAX's does."""
    class Shaped:
        lut = None
        device = torch.device("cpu")

        def bind_cells(self, cx, cy):
            self.cells = (cx, cy)

    opp = Shaped()
    mesh = ticon.trimesh_from_structured(2, 2, 100.0, 100.0)
    s = PlexrtSolverIcon(mesh, 100.0, opp)
    assert not s._use_param_phi and s._table_apex == (1.0, 1.0)
    np.testing.assert_allclose(opp.cells, topt.mesh_cell_shapes(mesh))


def test_wedge_set_mesh_refuses():
    """Both wedge solvers decompose over a process group
    (`tests/test_torch_parallel_wedge.py`); without one `set_mesh` refuses,
    and `set_mesh(None)` leaves the solve undecomposed."""
    opp = topt.WedgeOptProp(_load(topt, "test"))
    solvers = [PlexrtSolver(fish_mesh(2, 2, 2, 100.0, 100.0, 100.0), opp),
               PlexrtSolverIcon(ticon.trimesh_from_structured(2, 2, 100.0, 100.0), 100.0, opp)]
    for s in solvers:
        with pytest.raises(RuntimeError, match="process group"):
            s.set_mesh(object())
        s.set_mesh(None)
        assert s._pmesh is None and s.cell_shape()[1:] in ((2, 2, 2), (8,))


def test_create_lut_tool_refuses_wedge_schemes(tmp_path, monkeypatch):
    """`create_lut wedge_18_8 --preset mockup` traces the 18_8 table of the
    test axes (here made tiny) with the wedge tracer."""
    from tenstream_tpu_torch.tools.create_lut import main

    monkeypatch.setattr(topt, "test_axes", lambda: _tiny_axes(topt))
    main(["wedge_18_8", "--preset", "mockup", "--device", "cpu", "--photons", "100",
          "--out", str(tmp_path)])
    (name,) = os.listdir(tmp_path)
    assert name.startswith("WEDGE_LUT_18_8_")
    z = np.load(tmp_path / name)
    assert z["dir2dir"].shape[-2:] == (15, 18) and z["diff2diff"].shape[-2:] == (8, 8)


def test_shape_warning_on_a_far_shape():
    """Cells far from the table's triangle warn, as in the JAX package."""
    opp = topt.WedgeOptProp(_load(topt, "test"))
    with pytest.warns(UserWarning, match="deviate"):
        s = PlexrtSolverIcon(ticon.trimesh_equilateral(2, 2, 100.0), 100.0, opp)
    assert s._use_param_phi
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        s = PlexrtSolverIcon(ticon.trimesh_from_structured(2, 2, 100.0, 100.0), 100.0, opp)
    assert not s._use_param_phi
