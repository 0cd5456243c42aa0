"""The port's domain decomposition (`tenstream_tpu_torch/parallel/mesh.py`)
on gloo groups of CPU processes: the halo exchanges, the three kernels'
plain versions in halo mode on each rank's block against the JAX kernels
on the global field, `scatter_global` / `gather_to_host`, and the checks
that need no group.

Each rank is a process of its own (`tests/torch_mesh_ranks.py`, torch and
numpy only) and every run has a timeout, so a collective called in another
order on some rank fails the test instead of hanging the run.  The JAX
references run in this process: the Pallas kernels in interpret mode, as
`tests/test_torch_kernels.py` and `tests/test_torch_dense.py` run them, on
the global field.

Tolerances: the plain versions' own against JAX (`tests/test_torch_kernels.py`:
fields atol 3e-6, dots rtol 2e-5); data movement (rolls, flips, rings,
gathers) is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tenstream_tpu.optprop.facade import _diff_pair_orbits
from tenstream_tpu.pprts import operators as jops
from tenstream_tpu.pprts import pallas_ops
from tenstream_tpu.streams import get_scheme as jget
from tenstream_tpu_torch.pprts import edir as tedir
from tenstream_tpu_torch.pprts.precond import make_two_level_pc
from tenstream_tpu_torch.streams import get_scheme as tget
import torch_jax_cache  # noqa: F401  (one XLA compile per program per run)
from torch_mesh_ranks import assemble, blocks_of, run_ranks

FIELD_ATOL = 3e-6
DOT_RTOL = 2e-5
LAYOUTS = [(2, 1), (2, 2)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ops_inputs(B=2, nz=4, nx=8, ny=12, seed=0):
    js = jget("3_10")
    idx, norb = _diff_pair_orbits(js, with_mz=False)
    nd = js.ndiff
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.random(s).astype(np.float32)
    return dict(scheme="3_10", f=r(3, nx, ny), u=r(B, nd, nz + 1, nx, ny),
                w=r(B, nd, nz + 1, nx, ny), orb=r(B, norb, nz, nx, ny) * np.float32(0.1),
                alb=r(B, nx, ny) * np.float32(0.8), c=r(B, nd, nd, nz, nx, ny) * np.float32(0.1)), \
        np.asarray(idx, np.int64)


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda v: f"{v[0]}x{v[1]}")
def test_halo_ops_against_jax(layout, tmp_path):
    """(i) Each rank's block of K1's plain halo mode, of K3's plain halo mode
    with its edge faces sent on, and of S(x) by gather -> K2's plain
    version -> scatter with halos, reassembled, equals JAX's
    `fused_A_dots`, `diffuse_apply_pallas` and `orbit_contract_pallas`
    (interpret mode) on the global field; the halo primitives equal
    numpy's roll, flip and wrap on the global field."""
    inp, idx = _ops_inputs()
    res = run_ranks("ops", layout, inp, tmp_path)
    g = lambda k: assemble([r[k] for r in res], layout)
    f = inp["f"]
    np.testing.assert_array_equal(g("roll_xp"), np.roll(f, 1, -2))
    np.testing.assert_array_equal(g("roll_xm"), np.roll(f, -1, -2))
    np.testing.assert_array_equal(g("roll_yp"), np.roll(f, 1, -1))
    np.testing.assert_array_equal(g("roll_ym"), np.roll(f, -1, -1))
    np.testing.assert_array_equal(g("flip_x"), f[:, ::-1])
    np.testing.assert_array_equal(g("flip_y"), f[:, :, ::-1])
    wrapped = np.pad(f, ((0, 0), (1, 1), (1, 1)), mode="wrap")
    for r, blk in zip(res, blocks_of(np.arange(f.shape[1] * f.shape[2]).reshape(f.shape[1:]),
                                     layout)):
        i0, j0 = blk[0, 0] // f.shape[2], blk[0, 0] % f.shape[2]
        bx, by = blk.shape
        np.testing.assert_array_equal(r["pad"], wrapped[:, i0:i0 + bx + 2, j0:j0 + by + 2])
        np.testing.assert_array_equal(r["gathered"], f)
    js = jget("3_10")
    ib = idx.tobytes()
    for b in range(inp["u"].shape[0]):
        u, w, orb, alb = (jnp.asarray(inp[k][b]) for k in ("u", "w", "orb", "alb"))
        Au_j, p1, p2 = pallas_ops.fused_A_dots(js, ib, pallas_ops.prepare_orbit_fused(orb), u, w,
                                               alb, interpret=True)
        np.testing.assert_allclose(g("Au")[b], np.asarray(Au_j), atol=FIELD_ATOL)
        for r in res:  # the all-reduced dots, the same on every rank
            np.testing.assert_allclose(r["dots"][b], [float(p1), float(p2)], rtol=DOT_RTOL)
        np.testing.assert_allclose(sum(r["dots_local"][b] for r in res), res[0]["dots"][b],
                                   rtol=1e-6)
        S_pal = pallas_ops.diffuse_apply_pallas_orbit(js, ib, orb, u, tz=2, tx=4, interpret=True)
        closure = jops.diffuse_scatter(js, jops.OrbitCoeff(orb, idx), u, jnp.asarray(inp["alb"][0])) \
            - jops.diffuse_scatter(js, jops.OrbitCoeff(orb, idx), u)
        np.testing.assert_allclose(g("S_orbit")[b], np.asarray(S_pal + closure), atol=FIELD_ATOL)
        c = jnp.asarray(inp["c"][b])
        S_dense = pallas_ops.diffuse_apply_pallas(js, pallas_ops.prepare_coeff_pallas(c), u, tx=4,
                                                  interpret=True)
        np.testing.assert_allclose(g("S_dense")[b], np.asarray(S_dense), atol=FIELD_ATOL)


def test_scatter_global_asks_for_own_blocks(tmp_path):
    """(vi) `scatter_global`'s callable is asked for this rank's block only
    (the tuple of slices JAX's `make_array_from_callback` passes: whole
    leading dims, the block's x and y), once per call; and (vii)
    `gather_to_host` gives every rank the whole field."""
    layout = (2, 2)
    full = np.random.default_rng(3).random((2, 8, 6)).astype(np.float32)
    res = run_ranks("scatter", layout, dict(full=full), tmp_path)
    for r, blk in zip(res, blocks_of(full, layout)):
        np.testing.assert_array_equal(r["block"], blk)
        np.testing.assert_array_equal(r["block_from_array"], blk)
        np.testing.assert_array_equal(r["gathered"], full)
    asked = sorted(tuple(r["asked"].ravel()) for r in res)
    # one call per rank: (None, None) for the leading dim, then x and y
    want = sorted((-1, -1, px * 4, px * 4 + 4, py * 3, py * 3 + 3)
                  for px in range(2) for py in range(2))
    assert asked == want


class _OneRank:
    """A mesh of one rank for the checks that need no process group: it
    owns the whole field and is its own neighbour."""

    px = py = 0
    world = 1

    def all_gather_axis(self, t, axis):
        return [t]

    def all_reduce(self, t, op="sum"):
        return t.clone()

    def all_gather_blocks(self, t):
        return t

    def global_shape(self, nx, ny):
        return nx, ny


@pytest.mark.parametrize("ds", [1, 2])
def test_sharded_cyclic_solve_one_rank_is_exact(ds):
    """With one rank along the axis the ring composes with identities only,
    so `cyclic_affine_solve_sharded` equals `cyclic_affine_solve` bit for
    bit, lanes included."""
    rng = np.random.default_rng(ds)
    A = torch.as_tensor((rng.random((ds, ds, 7, 5, 3)) * 0.4).astype(np.float32))
    B = torch.as_tensor(rng.random((ds, 7, 5, 3)).astype(np.float32))
    for axis in (0, 1):
        want = tedir.cyclic_affine_solve(A, B, axis)
        got = tedir.cyclic_affine_solve_sharded(A, B, axis, _OneRank())
        assert torch.equal(got, want)


def test_two_level_refuses_a_block_it_does_not_divide():
    """The pooling factor comes from the global grid; a block it does not
    divide is refused with a message, not solved with another factor."""

    class Layout(_OneRank):
        def global_shape(self, nx, ny):
            return 4 * nx, 4 * ny

    scheme = tget("3_10")
    coeff = torch.rand((1, 10, 10, 3, 12, 12)) * 0.1
    with pytest.raises(ValueError, match="does not divide this rank's 12 x 12 block"):
        make_two_level_pc(scheme, coeff, torch.full((12, 12), 0.2), coarse_target=6,
                          mesh=Layout())


def test_mesh_needs_a_process_group():
    """Without `init_distributed` there is no mesh, and `set_mesh` raises."""
    import torch.distributed as dist

    from tenstream_tpu_torch.parallel.mesh import make_mesh
    from tenstream_tpu_torch.pprts.grid import Grid
    from tenstream_tpu_torch.pprts.solver import PprtsSolver

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(1, 1)
    solver = PprtsSolver(Grid.create(2, 4, 4, 100.0, 100.0, 100.0, device="cpu"),
                         solver_type="2str")
    with pytest.raises(RuntimeError, match="process group"):
        solver.set_mesh(object())
