"""(ii) The port's `solve_edir_sharded` on gloo groups of 2 x 1 and 2 x 2
CPU processes against the JAX package's `solve_edir_sharded` on a 2- and
a 4-device mesh (the virtual CPU devices of `tests/conftest.py`), for a
sun in each octant.  Each rank solves its block; the blocks reassembled
are held to JAX's global result.

Tolerance: 1e-5 of the incoming beam (atol 1e-2 W on fields of ~1e3 W;
the largest difference seen is 6.1e-5 W): the affine scans compose in
another order than JAX's associative scan, so float32 rounding differs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tenstream_tpu.parallel.mesh import make_mesh as jmake_mesh
from tenstream_tpu.pprts.edir import solve_edir_sharded as jsolve_edir_sharded
from tenstream_tpu.streams import get_scheme as jget
import torch_jax_cache  # noqa: F401  (one XLA compile per program per run)
from torch_mesh_ranks import assemble, run_ranks

EDIR_ATOL = 1e-2  # W, on fields of ~1e3 W
N_INNER = 4


def _inputs(nz=3, nx=8, ny=8, seed=1):
    """Random direct transfer blocks: transmissions in [0, 0.3) per
    (src, dst), a beam of 1000 W per top dof."""
    js = jget("3_10")
    nd = js.ndir
    rng = np.random.default_rng(seed)
    c = (rng.random((nd, nd, nz, nx, ny)) * 0.3).astype(np.float32)
    inc = np.full((js.dirtop.dof, nx, ny), 1000.0, np.float32)
    return c, inc


@pytest.mark.skipif(len(jax.devices()) < 4, reason="needs 4 virtual devices")
@pytest.mark.parametrize("layout", [(2, 1), (2, 2)], ids=lambda v: f"{v[0]}x{v[1]}")
def test_solve_edir_sharded_against_jax(layout, tmp_path):
    c, inc = _inputs()
    res = run_ranks("edir", layout, dict(scheme="3_10", dir2dir=c, inc=inc, n_inner=N_INNER),
                    tmp_path)
    nxp, nyp = layout
    mesh = jmake_mesh(jax.devices()[:nxp * nyp], nxproc=nxp, nyproc=nyp)
    for xinc in (0, 1):
        for yinc in (0, 1):
            want = np.asarray(jsolve_edir_sharded(jget("3_10"), jnp.asarray(c), jnp.asarray(inc),
                                                  xinc, yinc, mesh, n_inner=N_INNER, aitken=True,
                                                  cleanup=True))
            got = assemble([r[f"edir_{xinc}{yinc}"] for r in res], layout)
            np.testing.assert_allclose(got, want, atol=EDIR_ATOL, err_msg=f"octant {xinc}{yinc}")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
