"""The port's BoxMC schemes, general tracer and closed-form dir2dir table
against the JAX package's.

The schemes are plain data and must be equal.  The general tracer
(`boxmc/tracer.py::run_boxmc`) draws from a `torch.Generator`, the JAX one
from a threefry key, so the two are compared in distribution: 20,000
photons each, every tally within 0.02 (as `tests/test_pallas_tracer.py`
holds the TPU kernel against the JAX tracer), on one scheme of each
source and classification rule.  The physical checks of
`tests/test_boxmc.py` run on the port's tracer with their tolerances.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tenstream_tpu.boxmc import direct_transmission as jdt
from tenstream_tpu.boxmc import pallas_tracer as jpt
from tenstream_tpu.boxmc import schemes as jschemes
from tenstream_tpu.boxmc.tracer import run_boxmc as jrun
from tenstream_tpu.ops.eddington import eddington_coeff_ec
from tenstream_tpu_torch.boxmc import direct_transmission as tdt
from tenstream_tpu_torch.boxmc import schemes as tschemes
from tenstream_tpu_torch.boxmc.cuda_tracer import kernel_refusal
from tenstream_tpu_torch.boxmc.tracer import run_boxmc
from tenstream_tpu_torch.optprop import lut as tlut
import torch_jax_cache  # noqa: F401  (one XLA compile per program per run)

N = 20000


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain tracers issue thousands of small ops: one intra-op thread
    runs them as fast as many, and does not oversubscribe the CPU when
    test files run in parallel (where many threads made them 100x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gen(seed=7):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("name", sorted(jschemes.BOX_SCHEMES))
def test_box_schemes_equal(name):
    a, b = jschemes.get_box_scheme(name), tschemes.get_box_scheme(name)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    for f in range(6):
        np.testing.assert_array_equal(tschemes.face_normal(f), jschemes.face_normal(f))


def test_box_scheme_registry_equal():
    assert sorted(tschemes.BOX_SCHEMES) == sorted(jschemes.BOX_SCHEMES)
    with pytest.raises(KeyError):
        tschemes.get_box_scheme("no_such_scheme")


# one scheme of each rule: sectored sources and top exits (3_16), quadrant
# sources and exits (3_24), main + quadrant mu windows (3_30), sub-face
# direct sources with positional classification (8_10), main + sectors
# (8_18), mu rings (8_12), and the periodic column
@pytest.mark.parametrize("scheme,src,ldir,kw", [
    ("3_16", 0, False, {}), ("3_16", 5, False, {}), ("3_24", 3, False, {}),
    ("3_30", 1, False, {}), ("8_10", 0, True, {}), ("8_10", 5, True, {}),
    ("8_18", 4, False, {}), ("8_12", 2, False, {}), ("3_10", 1, False, {"periodic_xy": True}),
])
def test_general_tracer_matches_jax(scheme, src, ldir, kw):
    args = (0.5, 0.9, 0.5, 1.0, 30.0, 40.0)  # tauz, w0, g, aspect, phi, theta
    Tj, Sj = jrun(jax.random.PRNGKey(src), scheme, src, ldir, *args, n_photons=N, **kw)
    T, S = run_boxmc(_gen(src), scheme, src, ldir, *args, n_photons=N, **kw)
    assert T.shape == (jschemes.get_box_scheme(scheme).ndir,) and S.shape == Sj.shape
    np.testing.assert_allclose(T.numpy(), np.asarray(Tj), atol=0.02)
    np.testing.assert_allclose(S.numpy(), np.asarray(Sj), atol=0.02)
    assert float(T.sum() + S.sum()) <= 1.0 + 1e-5


def test_general_tracer_batched_entries():
    """A batch of entries traces each entry as a call of its own would."""
    tau = torch.tensor([0.0, 1.3, 1.3])
    T, S = run_boxmc(_gen(), "3_10", 0, True, tau, 0.0, 0.0, 1.0, 0.0, 0.0, n_photons=N)
    assert T.shape == (3, 3) and S.shape == (3, 10)
    np.testing.assert_allclose(T[:, 0].numpy(), np.exp(-tau.numpy()), atol=5e-3)
    assert float(S.abs().max()) == 0.0


# ---------------------------------------------------------------------------
# physical checks of tests/test_boxmc.py on the port's tracer
# ---------------------------------------------------------------------------


def test_direct_vertical_beer_lambert():
    T, S = run_boxmc(_gen(), "3_10", 0, True, 1.3, 0.0, 0.0, 1.0, 0.0, 0.0, n_photons=N)
    np.testing.assert_allclose(float(T[0]), np.exp(-1.3), atol=5e-3)
    assert T[1] == 0 and T[2] == 0 and float(S.sum()) < 1e-6


def test_direct_energy_conservation_conservative():
    T, S = run_boxmc(_gen(), "3_10", 0, True, 2.0, 1.0, 0.5, 1.0, 30.0, 40.0, n_photons=N)
    assert abs(float(T.sum() + S.sum()) - 1.0) < 2e-3


def test_direct_xy_symmetry():
    T, _ = run_boxmc(_gen(), "3_10", 0, True, 0.5, 0.0, 0.0, 1.0, 45.0, 60.0, n_photons=4 * N)
    assert abs(float(T[1] - T[2])) < 0.02, T


def test_diffuse_energy_conservation():
    T, S = run_boxmc(_gen(), "3_10", 1, False, 1.0, 1.0, 0.3, 1.0, n_photons=N)
    assert abs(float(S.sum()) - 1.0) < 2e-3 and T.numel() == 3 and float(T.sum()) == 0


def test_diffuse_1d_limit_vs_eddington():
    tauz, w0, g = 1.0, 0.5, 0.3
    _, S = run_boxmc(_gen(), "3_10", 1, False, tauz, w0, g, 1.0, n_photons=4 * N,
                     periodic_xy=True)
    assert float(S[:2].sum()) > 0.4 and float(S[2:].sum()) < 1e-6
    a11, a12, _, _, _ = eddington_coeff_ec(tauz, w0, g, 1.0)
    assert abs(float(S[1]) - float(a11)) < 0.06 and abs(float(S[0]) - float(a12)) < 0.03


def test_diffuse_updown_mirror_symmetry():
    _, S_dn = run_boxmc(_gen(1), "3_10", 1, False, 0.8, 0.6, 0.0, 1.0, n_photons=2 * N)
    _, S_up = run_boxmc(_gen(2), "3_10", 0, False, 0.8, 0.6, 0.0, 1.0, n_photons=2 * N)
    mirror = [1, 0, 4, 5, 2, 3, 8, 9, 6, 7]
    np.testing.assert_allclose(S_up.numpy(), S_dn.numpy()[mirror], atol=0.02)


def test_crashed_tpu_block_traces():
    """The block that crashed the TPU worker (8_10 direct src 0, round 1,
    entries from 245760 of the production direct grid's phi <= 45 half):
    its first entries trace to finite, conserving tallies here."""
    ax = tlut.production_axes(True)
    lo_axes = tlut.LUTAxes(ax.tau, ax.w0, ax.aspect, ax.g, ax.phi[:4], ax.theta)
    entries = tlut._entry_grid(lo_axes, True)[245760:245760 + 16]
    T, S = tlut._trace_entries("8_10", entries, 0, True, 512, 11, device="cpu")
    assert np.isfinite(T).all() and np.isfinite(S).all()
    assert (T.sum(1) + S.sum(1)).max() <= 1.0 + 1e-5


# ---------------------------------------------------------------------------
# the 3_16 fault of the reference's K4 route
# ---------------------------------------------------------------------------


def test_3_16_reference_kernel_fault_and_port_route():
    """The JAX package sends 3_16 through its TPU kernel on an accelerator,
    but that kernel knows no azimuth sectors: for diffuse source 0 it puts
    nothing into the sectored top dofs 2-7 that its own jnp tracer fills.
    The port's K4 refuses 3_16, and `_trace_entries` sends it to the
    general tracer, which agrees with the JAX tracer."""
    entry = np.array([[0.5, 0.9, 1.0, 0.5, 0.0, 0.0]], np.float32)
    with pltpu.force_tpu_interpret_mode():
        _, Sk = jpt.run_boxmc_pallas(jnp.asarray(entry), "3_16", 0, False, seed=1)
    Sk = np.asarray(Sk)[0]
    _, Sj = jrun(jax.random.PRNGKey(3), "3_16", 0, False, 0.5, 0.9, 0.5, 1.0, n_photons=N)
    Sj = np.asarray(Sj)
    assert (Sk[2:8] == 0).all() and (Sj[2:8] > 0.003).all()  # the fault
    assert abs(Sk[15] - Sj[15]) > 0.1
    assert kernel_refusal("3_16", False) and kernel_refusal("3_16", True)
    T, S = tlut._trace_entries("3_16", entry[:, :4], 0, False, N, 5, device="cpu")
    assert T.shape == (1, 3)
    np.testing.assert_allclose(S[0], Sj, atol=0.02)


# ---------------------------------------------------------------------------
# closed-form dir2dir table
# ---------------------------------------------------------------------------


def test_dir2dir_table_matches_jax():
    ax = tlut.mockup_axes(True)
    args = ("3_10", ax.tau, ax.aspect, ax.phi, np.array([0.0, 40.0, 80.0, 89.0], np.float32))
    got, want = tdt.dir2dir_table(*args), jdt.dir2dir_table(*args)
    assert got.shape == want.shape == (5, 4, 3, 4, 3, 3) and got.dtype == np.float32
    # the closed form's float32 cancellation (ROADMAP, faults found)
    np.testing.assert_allclose(got, want, atol=5e-5)
    for name in sorted(jschemes.BOX_SCHEMES):
        assert tdt.supports_scheme(name) == jdt.supports_scheme(name), name
    with pytest.raises(ValueError):
        tdt.dir2dir_table("8_10", *args[1:])
