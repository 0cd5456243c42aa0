"""The port's wedge tables, lookups and tuple BiCGStab against the JAX
package (`plexrt/optprop.py` lookup half, `ops/interp.py::interp_multilinear`
against the port's channels-first `interp_multilinear_cf`,
`ops/krylov.py::bicgstab_tree`), and every wedge entry point the port
leaves out refusing by name.

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

HERE = os.path.dirname(os.path.abspath(__file__))
LUTDIR = os.path.join(HERE, "data", "luts")
LOOKUP_RTOL = 1e-6
ITEM = "M18 remainder"


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
# refusals: what the port leaves out raises NotImplementedError naming its item
# ---------------------------------------------------------------------------

def test_create_wedge_lut_refuses():
    with pytest.raises(NotImplementedError, match=ITEM):
        topt.create_wedge_lut(topt.test_axes(), None, 100)


def test_missing_table_refuses_and_writes_nothing(tmp_path):
    axes = topt.WedgeAxes(np.array([1e-10, 1.0], np.float32), np.array([0.0, 0.9], np.float32),
                          np.array([1.0, 2.0], np.float32), np.array([0.0], np.float32),
                          np.array([0.0, 360.0], np.float32), np.array([0.0], np.float32))
    with pytest.raises(NotImplementedError, match=ITEM):
        topt.load_or_create_wedge_lut(axes, n_photons=100, basename=str(tmp_path), device="cpu")
    assert os.listdir(tmp_path) == []


def test_wedge_lut_for_mesh_without_a_committed_table_refuses(tmp_path):
    m = ticon.trimesh_equilateral(3, 3, 100.0)
    with pytest.raises(NotImplementedError, match=ITEM):
        topt.wedge_lut_for_mesh(m, basename=str(tmp_path), device="cpu")
    # the shape the JAX package would trace at
    assert np.allclose(topt.mesh_cell_shapes(m), jopt.mesh_cell_shapes(jicon.trimesh_equilateral(
        3, 3, 100.0)))


def test_shape_blended_optprops_refuse():
    m = ticon.trimesh_equilateral(3, 3, 100.0)
    with pytest.raises(NotImplementedError, match=ITEM):
        topt.wedge_optprop_for_mesh(m)
    with pytest.raises(NotImplementedError, match=ITEM):
        topt.WedgeOptPropShaped([])


def test_icon_solver_refuses_a_shaped_optprop():
    class Shaped:
        lut = None
        device = torch.device("cpu")

        def bind_cells(self, cx, cy):
            pass

    with pytest.raises(NotImplementedError, match=ITEM):
        PlexrtSolverIcon(ticon.trimesh_from_structured(2, 2, 100.0, 100.0), 100.0, Shaped())


def test_wedge_set_mesh_refuses():
    opp = topt.WedgeOptProp(_load(topt, "test"))
    solvers = [PlexrtSolver(fish_mesh(2, 2, 2, 100.0, 100.0, 100.0), opp),
               PlexrtSolverIcon(ticon.trimesh_from_structured(2, 2, 100.0, 100.0), 100.0, opp)]
    for s in solvers:
        with pytest.raises(NotImplementedError, match="M19"):
            s.set_mesh(object())


def test_create_lut_tool_refuses_wedge_schemes():
    from tenstream_tpu_torch.tools.create_lut import main

    with pytest.raises(NotImplementedError, match=ITEM):
        main(["wedge_5_8", "--preset", "mockup", "--device", "cpu"])


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
