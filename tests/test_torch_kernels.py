"""Kernels K1 (`fused_A_dots`) and K2 (`orbit_contract`) of the port.

On the CPU the wrappers run their plain PyTorch versions; those are held
against the JAX Pallas kernels in interpret mode and against the JAX XLA
path (`diffuse_scatter` plus `jnp.vdot`), on odd and wrapping shapes and
with a batch of B > 1.  The compile-time tables of K1 and K2 (one generated
header per table set of `cuda_ops.ORBIT_SCHEMES`) are parsed against the
Python tables and their contraction evaluated in numpy, and every cube
scheme is checked to find exactly one instantiation.  The CUDA kernels
themselves are compared with the plain versions in `test_torch_cuda.py`.

Tolerances: fields are sums of at most ~24 float32 products in another
order (atol 3e-6 on O(1) values); the dots sum ~1e4 terms (rtol 2e-5)."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tenstream_tpu.optprop.facade import _diff_pair_orbits
from tenstream_tpu.pprts import operators as jops
from tenstream_tpu.pprts import pallas_ops
from tenstream_tpu.streams import get_scheme as jget
from tenstream_tpu_torch.pprts import cuda_ops
from tenstream_tpu_torch.streams import get_scheme as tget
import torch_jax_cache  # noqa: F401  (one XLA compile per program per run)

FIELD_ATOL = 3e-6
DOT_RTOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops: one intra-op thread runs them as fast as many
    and does not oversubscribe the CPU when test files run in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _orbit_idx(name):
    if name == "3_10":
        idx, norb = _diff_pair_orbits(jget(name), with_mz=False)
        return np.asarray(idx, np.int64), norb
    nd = jget(name).ndiff
    norb = max(4, nd)
    return np.random.default_rng(1).integers(0, norb, (nd, nd)), norb


def _inputs(name, B, nz, nx, ny, seed=0):
    nd = jget(name).ndiff
    idx, norb = _orbit_idx(name)
    rng = np.random.default_rng(seed)
    orb = (rng.random((B, norb, nz, nx, ny)) * 0.1).astype(np.float32)
    u = rng.random((B, nd, nz + 1, nx, ny)).astype(np.float32)
    w = rng.random((B, nd, nz + 1, nx, ny)).astype(np.float32)
    alb = (rng.random((B, nx, ny)) * 0.8).astype(np.float32)
    src = rng.random((B, nd, nz, nx, ny)).astype(np.float32)
    return idx, orb, u, w, alb, src


# ---------------------------------------------------------------------------
# plain versions against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,B,nz,nx,ny", [
    ("3_10", 1, 6, 8, 16), ("3_10", 2, 5, 6, 10), ("3_10", 1, 1, 1, 3), ("3_6", 2, 3, 4, 5),
    ("1_2", 1, 4, 3, 2)])
def test_fused_A_dots_plain_vs_xla(name, B, nz, nx, ny):
    js, ts = jget(name), tget(name)
    idx, orb, u, w, alb, _ = _inputs(name, B, nz, nx, ny)
    Au, dots = cuda_ops.fused_A_dots(ts, idx, *(torch.as_tensor(a) for a in (orb, u, w, alb)))
    assert Au.shape == u.shape and dots.shape == (B, 2)
    for b in range(B):
        ref = u[b] - np.asarray(jops.diffuse_scatter(
            js, jops.OrbitCoeff(jnp.asarray(orb[b]), idx), jnp.asarray(u[b]), jnp.asarray(alb[b])))
        np.testing.assert_allclose(Au[b].numpy(), ref, atol=FIELD_ATOL)
        np.testing.assert_allclose(dots[b, 0].item(), float(jnp.vdot(w[b], ref)), rtol=DOT_RTOL)
        np.testing.assert_allclose(dots[b, 1].item(), float(jnp.vdot(ref, ref)), rtol=DOT_RTOL)


@pytest.mark.parametrize("name,nz,nx,ny", [("3_10", 5, 6, 10), ("1_2", 3, 4, 8)])
def test_fused_A_dots_plain_vs_pallas_interpret(name, nz, nx, ny):
    idx, orb, u, w, alb, _ = _inputs(name, 1, nz, nx, ny, seed=3)
    Au_j, p1, p2 = pallas_ops.fused_A_dots(
        jget(name), idx.tobytes(), pallas_ops.prepare_orbit_fused(jnp.asarray(orb[0])),
        jnp.asarray(u[0]), jnp.asarray(w[0]), jnp.asarray(alb[0]), interpret=True)
    Au, dots = cuda_ops.fused_A_dots_plain(tget(name), idx,
                                           *(torch.as_tensor(a) for a in (orb, u, w, alb)))
    np.testing.assert_allclose(Au[0].numpy(), np.asarray(Au_j), atol=FIELD_ATOL)
    np.testing.assert_allclose(dots[0].numpy(), [float(p1), float(p2)], rtol=DOT_RTOL)


@pytest.mark.parametrize("name,B,nz,nx,ny", [("3_10", 2, 5, 8, 16), ("3_10", 1, 3, 1, 7),
                                             ("3_6", 1, 4, 6, 6)])
def test_orbit_contract_plain_vs_pallas_and_xla(name, B, nz, nx, ny):
    js, ts = jget(name), tget(name)
    idx, orb, u, _, alb, src = _inputs(name, B, nz, nx, ny, seed=5)
    out = cuda_ops.orbit_contract(ts, idx, torch.as_tensor(orb), torch.as_tensor(src))
    for b in range(B):
        ref = jops._orbit_contrib(jops.OrbitCoeff(jnp.asarray(orb[b]), idx), jnp.asarray(src[b]))
        np.testing.assert_allclose(out[b].numpy(), np.asarray(ref), atol=FIELD_ATOL)
        pal = pallas_ops.orbit_contract_pallas(idx.tobytes(), jnp.asarray(orb[b]),
                                               jnp.asarray(src[b]), interpret=True)
        np.testing.assert_allclose(out[b].numpy(), np.asarray(pal), atol=FIELD_ATOL)
    # S(x) = gather -> K2 -> scatter + closure, against the XLA operator
    S = cuda_ops.diffuse_apply_orbit(ts, idx, torch.as_tensor(orb[0]), torch.as_tensor(u[0]),
                                     torch.as_tensor(alb[0]))
    ref = jops.diffuse_scatter(js, jops.OrbitCoeff(jnp.asarray(orb[0]), idx), jnp.asarray(u[0]),
                               jnp.asarray(alb[0]))
    np.testing.assert_allclose(S.numpy(), np.asarray(ref), atol=FIELD_ATOL)


def test_cpu_wrappers_count_no_launch():
    ts = tget("3_10")
    idx, orb, u, w, alb, src = _inputs("3_10", 1, 2, 3, 4)
    cuda_ops.reset_launch_counts()
    cuda_ops.fused_A_dots(ts, idx, *(torch.as_tensor(a) for a in (orb, u, w, alb)))
    cuda_ops.orbit_contract(ts, idx, torch.as_tensor(orb), torch.as_tensor(src))
    assert cuda_ops.LAUNCHES == {"fused_A_dots": 0, "orbit_contract": 0,
                                 "diffuse_apply_dense": 0, "boxmc_trace": 0}


# ---------------------------------------------------------------------------
# the CUDA kernels' tables: the generated headers, parsed and emulated
# ---------------------------------------------------------------------------

def _real_orbit_idx(name):
    idx, norb = _diff_pair_orbits(jget(name), with_mz=False)
    return np.asarray(idx, np.int64), norb


def _emulate_contract(text, orb, src):
    """numpy evaluation of a generated header's contraction (`k1_contract`,
    which K1 and K2 run): c[d] = sum over groups of o(orbit) * (sum of s(src))."""
    out = np.zeros_like(src)
    o = np.moveaxis(orb, 1, 0)
    sv = np.moveaxis(src, 1, 0)
    rows = re.findall(r"^\s*c\[(\d+)\] = (.*);$", text, re.M)
    assert len(rows) == src.shape[1]
    for d, expr in rows:
        out[:, int(d)] = eval(re.sub(r"([os])\((\d+)\)", r"\1[\2]", expr), {}, {"o": o, "s": sv})
    return out


@pytest.mark.parametrize("name", ["3_10", "3_6", "1_2"])
def test_kernel_tables_emulated(name):
    """K2 finds its instantiation by the scheme's tables and runs that set's
    generated contraction, which equals the plain K2; 1_2 has none."""
    ts = tget(name)
    idx, norb = _real_orbit_idx(name)
    _, orb, _, _, _, src = _inputs(name, 2, 3, 5, 4, seed=8)
    orb = (np.random.default_rng(8).random((2, norb, 3, 5, 4)) * 0.1).astype(np.float32)
    if name not in cuda_ops.ORBIT_SCHEMES:
        with pytest.raises(ValueError, match="matches none"):
            cuda_ops._orbit_instantiation(ts, idx, norb)
        return
    inst = cuda_ops._orbit_instantiation(ts, idx, norb)
    assert cuda_ops.ORBIT_SCHEMES[inst] == name
    emu = _emulate_contract(cuda_ops.orbit_header_text(name), orb.astype(np.float64),
                            src.astype(np.float64))
    out = cuda_ops.orbit_contract_plain(idx, torch.as_tensor(orb), torch.as_tensor(src))
    np.testing.assert_allclose(out.numpy(), emu, atol=FIELD_ATOL)


def _header_functions(text, nd):
    """name -> list of the nd values of the generated constexpr ternaries."""
    out = {}
    for name, body in re.findall(r"constexpr int (k1_\w+)\(int \w\) \{\s*return (.*?);", text):
        vals = dict((int(q), int(v)) for q, v in re.findall(r"== (\d+) \? (-?\d+)", body))
        out[name] = [vals.get(q, int(body.rsplit(": ", 1)[1])) for q in range(nd)]
    return out


def _check_header(name):
    """The committed header of table set `name` is what its generator writes,
    and the generator writes the plain version's tables."""
    path = os.path.join(cuda_ops.CSRC, cuda_ops.orbit_header_name(name))
    with open(path) as f:
        text = f.read()
    assert text == cuda_ops.orbit_header_text(name)  # load_extension refuses a stale copy too
    idx, norb = _real_orbit_idx(name)
    nd = idx.shape[0]
    groups = cuda_ops.orbit_groups(idx)
    # the contraction: c[d] = sum over groups of o(orbit) * (sum of s(src))
    rows = dict(re.findall(r"^\s*c\[(\d+)\] = (.*);$", text, re.M))
    assert len(rows) == nd and f"static constexpr int K1_NORB = {norb};" in text
    assert f"static constexpr int K1_ND = {nd};" in text and f"struct Orbit_{name} {{" in text
    for d in range(nd):
        terms = re.findall(r"o\((\d+)\) \* \(?((?:s\(\d+\)(?: \+ )?)+)\)?", rows[str(d)])
        got = tuple((int(o), tuple(int(q) for q in re.findall(r"s\((\d+)\)", ss)))
                    for o, ss in terms)
        assert got == groups[d]
    # the shifts and the closure
    fn = _header_functions(text, nd)
    cshift, gshift = cuda_ops._shift_tables(tget(name))
    for q, ax in enumerate("zxy"):
        assert fn[f"k1_g{ax}"] == [g[q] for g in gshift]
        assert fn[f"k1_c{ax}"] == [c[q] for c in cshift]
    dn, up = cuda_ops.surface_closure_rows(tget(name))
    assert "const float edn = " + " + ".join(f"u({d})" for d in dn) + ";" in text
    for d, wt in up:
        assert f"S[{d}] += alb * edn * {float(np.float32(wt))!r}f;" in text


def _check_contraction(name):
    """The generated contraction, evaluated in numpy, against the plain K2
    (the same per-cell sums) on random inputs."""
    idx, norb = _real_orbit_idx(name)
    rng = np.random.default_rng(4)
    orb = (rng.random((1, norb, 3, 4, 5)) * 0.1)
    src = rng.random((1, idx.shape[0], 3, 4, 5))
    got = _emulate_contract(cuda_ops.orbit_header_text(name), orb, src)
    ref = cuda_ops.orbit_contract_plain(idx, torch.as_tensor(orb, dtype=torch.float32),
                                        torch.as_tensor(src, dtype=torch.float32))
    np.testing.assert_allclose(got, ref.numpy(), atol=FIELD_ATOL)


def test_k1_header_is_generated_from_the_tables():
    _check_header("3_10")


def test_k1_header_contraction_emulated():
    _check_contraction("3_10")


@pytest.mark.parametrize("name", cuda_ops.ORBIT_SCHEMES[1:])
def test_orbit_header_is_generated_from_the_tables(name):
    """Every other generated header, as 3_10's above."""
    _check_header(name)
    _check_contraction(name)


def test_orbit_index_header_is_generated():
    """`csrc/orbit_schemes.h` is what its generator writes and lists every
    table set in ORBIT_SCHEMES' order (the instantiation index)."""
    headers = cuda_ops.generated_headers()
    assert set(headers) == {cuda_ops.orbit_header_name(n) for n in cuda_ops.ORBIT_SCHEMES} | {
        cuda_ops.ORBIT_INDEX_HEADER}
    with open(os.path.join(cuda_ops.CSRC, cuda_ops.ORBIT_INDEX_HEADER)) as f:
        text = f.read()
    assert text == cuda_ops.orbit_index_text()
    listed = re.findall(r"X\((\d+), Orbit_(\w+)\)", text)
    assert listed == [(str(q), n) for q, n in enumerate(cuda_ops.ORBIT_SCHEMES)]
    cuda_ops._check_headers()


@pytest.mark.parametrize("name", ["3_10", "8_10", "3_6", "8_12", "3_16", "8_16", "8_18", "3_24",
                                  "3_30"])
def test_every_cube_scheme_has_an_instantiation(name):
    """Each cube scheme's diffuse tables equal exactly one compiled set
    (8_10 3_10's, 8_16 3_16's, the others their own), and K3 is built for
    its dof count."""
    ts = tget(name)
    idx, norb = _real_orbit_idx(name)
    inst = cuda_ops._orbit_instantiation(ts, idx, norb)
    own = {"8_10": "3_10", "8_16": "3_16"}.get(name, name)
    assert cuda_ops.ORBIT_SCHEMES[inst] == own
    matches = [n for n in cuda_ops.ORBIT_SCHEMES
               if _real_orbit_idx(n)[0].shape == idx.shape
               and np.array_equal(_real_orbit_idx(n)[0], idx)
               and cuda_ops._scheme_tables(tget(n)) == cuda_ops._scheme_tables(ts)]
    assert matches == [own]
    assert cuda_ops._dense_tables(ts)[0] == ts.ndiff in cuda_ops.DENSE_NDS


def test_k1_refuses_other_tables():
    idx, norb = _orbit_idx("3_10")
    assert cuda_ops._orbit_instantiation(tget("3_10"), idx, norb) == 0  # the compiled tables
    for scheme, bad_idx, bad_norb in ((tget("3_10"), idx[::-1], norb), (tget("3_10"), idx, 25),
                                      (tget("3_6"), _orbit_idx("3_6")[0], 6)):
        with pytest.raises(ValueError, match="matches none"):
            cuda_ops._orbit_instantiation(scheme, bad_idx, bad_norb)
