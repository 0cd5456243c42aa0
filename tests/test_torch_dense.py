"""The dense diffuse-coefficient path of the port against the JAX package:
kernel K3's plain version (`diffuse_apply_dense_plain`), the dense forms of
the operators, the dense LUT lookup and assembly, and the diffuse solvers,
preconditioners, thermal source and absorption on a dense field.

K3 on the CPU is its plain PyTorch version; it is held against the JAX
Pallas kernel in interpret mode and against the JAX XLA path
(`diffuse_scatter` on the dense field).  The shift tables the CUDA kernel
indexes by, and its blocking (tiles, the z march, halo staging with wrap,
cell-to-face writes, the zero faces), are checked by numpy emulations at
ragged shapes, and its shift-range refusal by altered tables.  The CUDA
kernel itself is compared with the plain version in `test_torch_cuda.py`.

Tolerances: S(x) sums 10 float32 products per value in another order
(atol 3e-6 on O(1) values, float32).  With bfloat16 coefficients both
sides read the same bfloat16 values and multiply and add in float32, so
the same sums in another order remain: held at 5e-6.  Interpolated
coefficients agree to a few float32 ulps (atol 2e-6); solver tolerances as
in `test_torch_ediff.py`."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tenstream_tpu.optprop.facade import OptProp as JOptProp
from tenstream_tpu.optprop.facade import _diff_pair_orbits
from tenstream_tpu.optprop.lut import load_or_create_lut, mockup_axes
from tenstream_tpu.pprts import absorption as jabso
from tenstream_tpu.pprts import coeffs as jc
from tenstream_tpu.pprts import ediff as jediff
from tenstream_tpu.pprts import operators as jops
from tenstream_tpu.pprts import pallas_ops
from tenstream_tpu.pprts import precond as jprecond
from tenstream_tpu.pprts import sources as jsources
from tenstream_tpu.pprts import sun as jsun
from tenstream_tpu.streams import get_scheme as jget
from tenstream_tpu_torch.convert import lut_from_arrays
from tenstream_tpu_torch.optprop.facade import OptProp
from tenstream_tpu_torch.pprts import absorption as tabso
from tenstream_tpu_torch.pprts import coeffs as tc
from tenstream_tpu_torch.pprts import cuda_ops
from tenstream_tpu_torch.pprts import ediff as tediff
from tenstream_tpu_torch.pprts import operators as tops
from tenstream_tpu_torch.pprts import precond as tprecond
from tenstream_tpu_torch.pprts import sources as tsources
from tenstream_tpu_torch.pprts import sun as tsun
from tenstream_tpu_torch.streams import get_scheme as tget
import torch_jax_cache  # noqa: F401  (one XLA compile per program per run)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELD_ATOL = 3e-6
BF16_ATOL = 5e-6
INTERP_ATOL = 2e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops: one intra-op thread runs them as fast as many
    and does not oversubscribe the CPU when test files run in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16_values(a: np.ndarray) -> np.ndarray:
    """a rounded to bfloat16, as float32 (both packages then read the same
    bfloat16 values)."""
    return torch.as_tensor(a).to(torch.bfloat16).float().numpy()


def _inputs(name, B, nz, nx, ny, seed=0, bf16=False):
    nd = jget(name).ndiff
    rng = np.random.default_rng(seed)
    c = (rng.random((B, nd, nd, nz, nx, ny)) * 0.1).astype(np.float32)
    x = rng.random((B, nd, nz + 1, nx, ny)).astype(np.float32)
    alb = (rng.random((B, nx, ny)) * 0.8).astype(np.float32)
    return (_bf16_values(c) if bf16 else c), x, alb


def _coeff_pair(c, bf16):
    """The same coefficient values as a JAX array and a torch tensor, in
    float32 or bfloat16 storage."""
    if bf16:
        return jnp.asarray(c).astype(jnp.bfloat16), torch.as_tensor(c).to(torch.bfloat16)
    return jnp.asarray(c), torch.as_tensor(c)


# ---------------------------------------------------------------------------
# K3's plain version against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("name,nz,nx,ny", [("3_10", 5, 8, 16), ("3_10", 1, 4, 3), ("1_2", 3, 4, 8)])
def test_dense_apply_plain_vs_pallas_interpret(name, nz, nx, ny, bf16):
    c, x, _ = _inputs(name, 1, nz, nx, ny, seed=2, bf16=bf16)
    cj, ct = _coeff_pair(c[0], bf16)
    ref = pallas_ops.diffuse_apply_pallas(jget(name), pallas_ops.prepare_coeff_pallas(cj),
                                          jnp.asarray(x[0]), tx=4, interpret=True)
    out = cuda_ops.diffuse_apply_dense_plain(tget(name), ct[None], torch.as_tensor(x))
    assert out.dtype == torch.float32 and out.shape == x.shape
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref),
                               atol=BF16_ATOL if bf16 else FIELD_ATOL)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("name,B,nz,nx,ny", [("3_10", 2, 5, 6, 10), ("3_10", 1, 1, 1, 3),
                                             ("3_6", 2, 3, 4, 5), ("8_10", 1, 2, 3, 4)])
def test_dense_apply_vs_xla(name, B, nz, nx, ny, bf16):
    """The wrapper (on the CPU: the plain version) against the JAX XLA
    operator on the dense field, without the surface closure."""
    c, x, _ = _inputs(name, B, nz, nx, ny, seed=4, bf16=bf16)
    _, ct = _coeff_pair(c, bf16)
    cuda_ops.reset_launch_counts()
    out = cuda_ops.diffuse_apply_dense(tget(name), ct, torch.as_tensor(x))
    assert cuda_ops.LAUNCHES["diffuse_apply_dense"] == 0  # no launch on the CPU
    for b in range(B):
        cj, _ = _coeff_pair(c[b], bf16)
        ref = jops.diffuse_scatter(jget(name), cj, jnp.asarray(x[b]))
        np.testing.assert_allclose(out[b].numpy(), np.asarray(ref),
                                   atol=BF16_ATOL if bf16 else FIELD_ATOL)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_diffuse_scatter_dense_with_closure(bf16):
    """`operators.diffuse_scatter` on the dense field, surface closure
    included, and `ediff._make_apply`'s dense branch (K3 + closure)."""
    c, x, alb = _inputs("3_10", 1, 4, 5, 6, seed=6, bf16=bf16)
    cj, ct = _coeff_pair(c[0], bf16)
    ref = np.asarray(jops.diffuse_scatter(jget("3_10"), cj, jnp.asarray(x[0]),
                                          jnp.asarray(alb[0])))
    atol = BF16_ATOL if bf16 else FIELD_ATOL
    out = tops.diffuse_scatter(tget("3_10"), ct, torch.as_tensor(x[0]), torch.as_tensor(alb[0]))
    np.testing.assert_allclose(out.numpy(), ref, atol=atol)
    S = tediff._make_apply(tget("3_10"), ct, torch.as_tensor(alb[0]))
    np.testing.assert_allclose(S(torch.as_tensor(x[0])).numpy(), ref, atol=atol)


def test_orbit_full_and_dst_sums():
    idx, norb = _diff_pair_orbits(jget("3_10"), with_mz=False)
    rng = np.random.default_rng(9)
    orb = (rng.random((norb, 3, 4, 5)) * 0.1).astype(np.float32)
    jo, to = jops.OrbitCoeff(jnp.asarray(orb), idx), tops.OrbitCoeff(torch.as_tensor(orb), idx)
    full = tops.diff_coeff_full(to)
    np.testing.assert_array_equal(full.numpy(), np.asarray(jops.diff_coeff_full(jo)))
    assert tops.diff_coeff_full(full) is full
    for coeff_t, coeff_j in ((to, jo), (full, jo.full()), (to.astype(torch.bfloat16),
                                                           jo.astype(jnp.bfloat16)),
                             (full.to(torch.bfloat16), jo.full().astype(jnp.bfloat16))):
        sums = tops.diff_dst_sums(coeff_t)
        assert sums.dtype == torch.float32
        np.testing.assert_allclose(sums.numpy(), np.asarray(
            jops.diff_dst_sums(coeff_j, jnp.float32)), atol=FIELD_ATOL)


# ---------------------------------------------------------------------------
# the CUDA kernel's tables, emulated in numpy
# ---------------------------------------------------------------------------

def _emulate_dense_apply(itab, c, x):
    """numpy replica of dense_ops.cu::diffuse_apply_dense_kernel's indexing."""
    nd = itab[0]
    gz, gx, gy, cz, cx, cy = (itab[1 + nd * q: 1 + nd * (q + 1)] for q in range(6))
    B, _, nz1, nx, ny = x.shape
    nz = nz1 - 1
    out = np.zeros_like(x)
    k, i, j = np.meshgrid(np.arange(nz1), np.arange(nx), np.arange(ny), indexing="ij")
    for d in range(nd):
        kc = k + cz[d]
        valid = (kc >= 0) & (kc < nz)
        kcc = np.clip(kc, 0, nz - 1)
        ic, jc = (i + cx[d]) % nx, (j + cy[d]) % ny
        acc = sum(c[:, s, d, kcc, ic, jc]
                  * x[:, s, np.clip(kcc + gz[s], 0, nz), (ic + gx[s]) % nx, (jc + gy[s]) % ny]
                  for s in range(nd))
        out[:, d] = np.where(valid, acc, 0.0)
    return out


@pytest.mark.parametrize("name", ["3_10", "3_6", "1_2"])
def test_dense_kernel_tables_emulated(name):
    ts = tget(name)
    c, x, _ = _inputs(name, 2, 3, 5, 4, seed=8)
    if ts.ndiff not in cuda_ops.DENSE_NDS:  # no K3 for 1_2's 2 dofs; its plain twin takes any
        with pytest.raises(ValueError, match="K3 is instantiated for"):
            cuda_ops._dense_tables(ts)
        return
    nd = ts.ndiff
    itab = cuda_ops._dense_tables(ts)
    assert len(itab) == 1 + 6 * nd and itab[0] == nd and set(itab[1:]) <= {-1, 0, 1}
    emu = _emulate_dense_apply(itab, c.astype(np.float64), x.astype(np.float64))
    out = cuda_ops.diffuse_apply_dense_plain(ts, torch.as_tensor(c), torch.as_tensor(x))
    np.testing.assert_allclose(out.numpy(), emu, atol=FIELD_ATOL)


def _k3_tile():
    """K3's tile of cells (kTX x kTY), read from its source."""
    src = open(os.path.join(REPO, "tenstream_tpu_torch", "csrc", "dense_ops.cu")).read()
    m = re.search(r"constexpr int kTX = (\d+), kTY = (\d+);", src)
    return int(m.group(1)), int(m.group(2))


def _emulate_k3_blocks(itab, c, x, tx, ty, vec, zsplit):
    """numpy replica of the decomposition of dense_ops.cu's
    diffuse_apply_dense_kernel: blocks over (tile, z chunk, batch), the z
    march, each step's sources staged with their high halo (indices
    wrapped; what is not staged is NaN), threads of vec cells, each cell's
    contributions written to its faces and the faces no cell makes written
    as 0.  Returns the output (NaN where never written) and the number of
    writes per output element."""
    nd = itab[0]
    gz, gx, gy, cz, cx, cy = (itab[1 + nd * q: 1 + nd * (q + 1)] for q in range(6))
    B, _, nz1, nx, ny = x.shape
    nz = nz1 - 1
    out = np.full(x.shape, np.nan)
    writes = np.zeros(x.shape, np.int64)
    tiles_y = -(-ny // ty)
    tiles = -(-nx // tx) * tiles_y
    per = -(-nz // zsplit)
    lanes = ty // vec
    tid = np.arange(tx * ty // vec)
    ta, c0 = tid // lanes, (tid % lanes) * vec
    for b, blk in np.ndindex(B, tiles * zsplit):
        tile, zc = divmod(blk, zsplit)
        i0, j0 = (tile // tiles_y) * tx, (tile % tiles_y) * ty
        hv, wv = min(tx, nx - i0), min(ty, ny - j0)
        rows = np.array([i0 + a if i0 + a < nx else i0 + a - nx for a in range(hv + 1)])
        jhalo = j0 + wv if j0 + wv < ny else j0 + wv - ny
        # the thread's cells: row ta, columns c0 + q of the tile
        a_, col = np.repeat(ta, vec), (c0[:, None] + np.arange(vec)).ravel()
        live = (a_ < hv) & (col < wv)
        a_, col = a_[live], col[live]
        i, j = i0 + a_, j0 + col
        for k in range(zc * per, min(zc * per + per, nz)):
            st = np.full((nd, tx + 1, ty + 4), np.nan)
            for s in range(nd):
                r = rows[:hv + gx[s]]
                st[s, :len(r), :wv] = x[b, s, k + gz[s]][r][:, j0:j0 + wv]
                if gy[s]:
                    st[s, :len(r), wv] = x[b, s, k + gz[s], r, jhalo]
            sv = np.stack([st[s, a_ + gx[s], col + gy[s]] for s in range(nd)])
            for d in range(nd):
                acc = sum(c[b, s, d, k, i, j] * sv[s] for s in range(nd))
                fi = np.where(i - cx[d] < nx, i - cx[d], 0)
                fj = np.where(j - cy[d] < ny, j - cy[d], 0)
                np.add.at(writes[b, d], (k - cz[d], fi, fj), 1)
                out[b, d, k - cz[d], fi, fj] = acc
                if (k == 0) if cz[d] == -1 else (k == nz - 1):
                    kz = 0 if cz[d] == -1 else nz
                    np.add.at(writes[b, d], (kz, fi, fj), 1)
                    out[b, d, kz, fi, fj] = 0.0
    return out, writes


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,nz,nx,ny", [(3, 7, 13, 130), (1, 1, 9, 67), (2, 5, 6, 10),
                                        (1, 1, 1, 1), (3, 1, 17, 129)])
def test_dense_kernel_blocks_emulated(B, nz, nx, ny, bf16):
    """K3's blocking at ragged shapes (nx, ny not multiples of the tile or
    of the vector width, nz = 1, B = 3), with the kernel's tile and with
    small tiles that make many blocks, over several z splits (one leaving a
    block no plane): every output element is written exactly once, and the
    result is the plain version's."""
    ts = tget("3_10")
    itab = cuda_ops._dense_tables(ts)
    c, x, _ = _inputs("3_10", B, nz, nx, ny, seed=nz + nx, bf16=bf16)
    ref = cuda_ops.diffuse_apply_dense_plain(ts, torch.as_tensor(c), torch.as_tensor(x)).numpy()
    vec = 8 if bf16 else 4
    kx, ky = _k3_tile()
    for tx, ty in ((kx, ky), (2, 2 * vec), (3, 4 * vec)):
        for zsplit in sorted({1, 2, 3, 5, max(1, nz // 4)}):  # 5 at nz = 7: an empty z chunk
            out, writes = _emulate_k3_blocks(itab, c.astype(np.float64), x.astype(np.float64),
                                             tx, ty, vec, zsplit)
            assert (writes == 1).all(), (tx, ty, zsplit, np.argwhere(writes != 1)[:5])
            np.testing.assert_allclose(out, ref, atol=FIELD_ATOL)


def _k3_tile_rows(nd):
    """dense_ops.cu's tile_rows<ND>: the most rows (up to kTX) whose two
    staged steps (nd dofs x (rows + 1) x 132 floats each) fit the blocks per
    SM (two up to 10 dofs, one above) in 228 KB, 1 KB reserved per block."""
    kx, ky = _k3_tile()
    blocks = 2 if nd <= 10 else 1
    rows = kx
    while rows > 1 and 4 * 2 * nd * (rows + 1) * (ky + 4) * blocks > 228 * 1024 - 1024 * blocks:
        rows -= 1
    return rows


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("name,B,nz,nx,ny", [("3_30", 2, 3, 13, 130), ("3_30", 1, 5, 6, 10),
                                             ("8_12", 1, 4, 9, 67)])
def test_dense_kernel_blocks_emulated_wide(name, B, nz, nx, ny, bf16):
    """K3's blocking at more than 10 dofs, with the tile rows its shared
    memory allows there (6 at 3_30, 8 up to 24 dofs): every output element
    written exactly once, the result the plain version's."""
    ts = tget(name)
    itab = cuda_ops._dense_tables(ts)
    c, x, _ = _inputs(name, B, nz, nx, ny, seed=nz + nx, bf16=bf16)
    ref = cuda_ops.diffuse_apply_dense_plain(ts, torch.as_tensor(c), torch.as_tensor(x)).numpy()
    vec = 8 if bf16 else 4
    rows = _k3_tile_rows(ts.ndiff)
    assert rows == {30: 6}.get(ts.ndiff, 8) and _k3_tile_rows(10) == 8
    for zsplit in (1, 2):
        out, writes = _emulate_k3_blocks(itab, c.astype(np.float64), x.astype(np.float64),
                                         rows, _k3_tile()[1], vec, zsplit)
        assert (writes == 1).all(), (zsplit, np.argwhere(writes != 1)[:5])
        np.testing.assert_allclose(out, ref, atol=FIELD_ATOL)


@pytest.mark.parametrize("name", ["3_10", "8_10"])
def test_dense_kernel_shift_range_accepts(name):
    cshift, gshift = cuda_ops._shift_tables(tget(name))
    cuda_ops._k3_shift_refusal(name, cshift, gshift)
    assert len(cuda_ops._dense_tables(tget(name))) == 61


@pytest.mark.parametrize("table,dof,shift", [("g", 0, (-1, 0, 0)), ("g", 2, (0, 2, 0)),
                                             ("g", 6, (0, 0, -1)), ("c", 1, (1, 0, 0)),
                                             ("c", 3, (0, -2, 0)), ("c", 7, (0, 0, 1))])
def test_dense_kernel_shift_range_refuses(table, dof, shift):
    """Tables outside gshift in {0, 1} / cshift in {-1, 0} are refused with
    a message naming the dof."""
    cshift, gshift = (list(t) for t in cuda_ops._shift_tables(tget("3_10")))
    (gshift if table == "g" else cshift)[dof] = shift
    with pytest.raises(ValueError, match=rf"{table}shift outside at dofs \[{dof}\]"):
        cuda_ops._k3_shift_refusal("3_10 altered", tuple(cshift), tuple(gshift))


# ---------------------------------------------------------------------------
# dense lookup and assembly
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jlut():
    return load_or_create_lut("3_10", mockup_axes(True), mockup_axes(False), n_photons=2000,
                              basename=os.path.join(REPO, "tests", "data", "luts"))


class _UnsymLUT:
    """The test LUT with a diffuse table that breaks the cube symmetry."""

    def __init__(self, jl):
        rng = np.random.default_rng(21)
        d = np.asarray(jl.diff2diff, np.float32)
        self.scheme, self.dir_axes, self.diff_axes = jl.scheme, jl.dir_axes, jl.diff_axes
        self.dir2dir, self.dir2diff = jl.dir2dir, jl.dir2diff
        self.diff2diff = (d * (1.0 - 0.2 * rng.random(d.shape[-2:]))).astype(np.float32)


@pytest.fixture(scope="module", params=["symmetrized", "unsymmetrized"])
def opps(request, jlut):
    jl = jlut if request.param == "symmetrized" else _UnsymLUT(jlut)
    jo, to = JOptProp(jl), OptProp(lut_from_arrays(jl, device="cpu"), device="cpu")
    sym = request.param == "symmetrized"
    assert (jo._solver_orbit_idx is not None) == sym == (to._solver_orbit_idx is not None)
    return jo, to


def _optical_fields(per_layer_aspect):
    rng = np.random.default_rng(7)
    nz, nx, ny = 3, 5, 6
    tau = (10.0 ** rng.uniform(-3, 1.5, (nz, nx, ny))).astype(np.float32)
    w0 = rng.uniform(0.0, 1.0, (nz, nx, ny)).astype(np.float32)
    g = rng.uniform(0.0, 0.9, (nz, nx, ny)).astype(np.float32)
    asp = (np.array([0.1, 0.7, 1.9], np.float32)[:, None, None] if per_layer_aspect
           else rng.uniform(0.05, 2.5, (nz, nx, ny)).astype(np.float32))
    return tau, w0, g, asp


@pytest.mark.parametrize("per_layer", [True, False], ids=["onehot", "multilinear"])
def test_diff_coeffs_dense(opps, per_layer):
    jo, to = opps
    f = _optical_fields(per_layer)
    j = jo.diff_coeffs(*f)
    t = to.diff_coeffs(*(torch.as_tensor(a) for a in f))
    assert tuple(t.shape) == (10, 10, 3, 5, 6)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=INTERP_ATOL)


def _scene():
    rng = np.random.default_rng(11)
    nz, nx, ny = 5, 6, 4
    kabs = (1e-5 + 1e-3 * rng.random((nz, nx, ny))).astype(np.float32)
    ksca = (1e-5 + 5e-3 * rng.random((nz, nx, ny))).astype(np.float32)
    g = rng.uniform(0.0, 0.9, (nz, nx, ny)).astype(np.float32)
    dz = np.array([500.0, 250.0, 120.0, 60.0, 40.0], np.float32)  # dx = 100: two 1-D layers
    return kabs, ksca, g, dz


@pytest.mark.parametrize("need_dir", [True, False], ids=["solar", "thermal"])
def test_assemble_coeffs_dense(opps, need_dir):
    jo, to = opps
    kabs, ksca, g, dz = _scene()
    l1d = np.array([True, True, False, False, False])
    sun_dir = jsun.sundir_from_angles(215.0, 38.0)
    js, ts = jsun.suninfo_from_sundir(sun_dir), tsun.suninfo_from_sundir(sun_dir)
    jcf, _ = jax.jit(lambda kabs, ksca, g, dz3d: jc.assemble_coeffs(
        jo.scheme, jo, kabs, ksca, g, dz3d, 100.0, l1d, js, need_dir, orbit=False))(
        jnp.asarray(kabs), jnp.asarray(ksca), jnp.asarray(g), jnp.asarray(dz)[:, None, None])
    tcf, _ = tc.assemble_coeffs(to.scheme, to, torch.as_tensor(kabs), torch.as_tensor(ksca),
                                torch.as_tensor(g), torch.as_tensor(dz)[:, None, None], 100.0,
                                l1d, ts, need_dir, orbit=False)
    assert isinstance(tcf.diff2diff, torch.Tensor) and tuple(tcf.diff2diff.shape) == (10, 10, 5, 6, 4)
    np.testing.assert_allclose(tcf.diff2diff.numpy(), np.asarray(jcf.diff2diff), atol=INTERP_ATOL)
    if need_dir:
        np.testing.assert_allclose(tcf.dir2diff.numpy(), np.asarray(jcf.dir2diff), atol=2e-5)
    else:
        assert tcf.dir2dir is None and tcf.dir2diff is None
    if to._solver_orbit_idx is None:
        with pytest.raises(ValueError, match="symmetrized"):
            tc.assemble_coeffs(to.scheme, to, torch.as_tensor(kabs), torch.as_tensor(ksca),
                               torch.as_tensor(g), torch.as_tensor(dz)[:, None, None], 100.0,
                               l1d, ts, need_dir, orbit=True)


# ---------------------------------------------------------------------------
# solvers, preconditioners, sources and absorption on a dense field
# ---------------------------------------------------------------------------

NZ, NX, NY = 6, 16, 16


def _system(seed=0, bf16=False):
    """A dense system: the orbit field of `test_torch_ediff.py` expanded,
    with a few cells zeroed as a building mask would."""
    idx, norb = _diff_pair_orbits(jget("3_10"), with_mz=False)
    rng = np.random.default_rng(seed)
    orb = (rng.random((norb, NZ, NX, NY)) * 0.09).astype(np.float32)
    c = orb[idx.ravel()].reshape(10, 10, NZ, NX, NY).copy()
    c[:, :, 3:, 4:7, 9:11] = 0.0
    if bf16:
        c = _bf16_values(c)
    b = rng.random((10, NZ + 1, NX, NY)).astype(np.float32)
    alb = (rng.random((NX, NY)) * 0.5).astype(np.float32)
    return _coeff_pair(c, bf16) + (b, alb)


@pytest.mark.parametrize("precond,warm,bf16", [("none", False, False), ("line", True, False),
                                               ("two_level", False, False),
                                               ("two_level", True, True)])
def test_bicgstab_dense_matches_jax(precond, warm, bf16):
    cj, ct, b, alb = _system(bf16=bf16)
    x0 = 0.7 * b if warm else None
    xj, nj, rj = jediff.solve_bicgstab(
        jget("3_10"), cj, jnp.asarray(b), jnp.asarray(alb),
        x0=None if x0 is None else jnp.asarray(x0), rtol=1e-6, atol=1e-10, maxiter=200,
        precond=precond)
    xt, nt, rt, syncs = tediff.solve_bicgstab(
        tget("3_10"), ct, torch.as_tensor(b), torch.as_tensor(alb),
        x0=None if x0 is None else torch.as_tensor(x0), rtol=1e-6, atol=1e-10, maxiter=200,
        precond=precond)
    assert abs(nt - int(nj)) <= 2 and syncs == nt + 1
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-4)
    assert rt <= 1e-6 * np.linalg.norm(b) and float(rj) <= 1e-6 * np.linalg.norm(b)


@pytest.mark.parametrize("precond", ["line", "two_level"])
def test_richardson_dense_matches_jax(precond):
    cj, ct, b, alb = _system(1)
    xj, nj, _, rj = jediff.solve_richardson(jget("3_10"), cj, jnp.asarray(b), jnp.asarray(alb),
                                            rtol=1e-6, atol=1e-10, max_iter=300, precond=precond)
    xt, nt, _, rt, syncs = tediff.solve_richardson(
        tget("3_10"), ct, torch.as_tensor(b), torch.as_tensor(alb), rtol=1e-6, atol=1e-10,
        max_iter=300, precond=precond)
    assert abs(nt - int(nj)) <= 2 and syncs == nt
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-4)
    np.testing.assert_allclose(rt, float(rj), rtol=1e-2)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_preconditioners_dense_match_jax(bf16):
    """Line and two-level preconditioners built from a dense (masked)
    field: one pass of float32 arithmetic, atol 2e-5 of the O(1) result."""
    cj, ct, b, alb = _system(3, bf16=bf16)
    r = np.random.default_rng(4).standard_normal(b.shape).astype(np.float32)
    np.testing.assert_allclose(tprecond._mean_coeff(ct).numpy(),
                               np.asarray(jprecond._mean_coeff(cj)), atol=FIELD_ATOL)
    Mt = tediff.make_line_pc(tget("3_10"), ct, torch.as_tensor(alb))(torch.as_tensor(r))
    Mj = jediff.make_line_pc(jget("3_10"), cj, jnp.asarray(alb))(jnp.asarray(r))
    Vt = tediff.vertical_line_solve(tget("3_10"), ct, torch.as_tensor(r), torch.as_tensor(alb))
    np.testing.assert_allclose(Mt.numpy(), np.asarray(Mj), atol=2e-5)
    np.testing.assert_allclose(Vt.numpy(), Mt.numpy(), atol=2e-5)
    M2t = tprecond.make_two_level_pc(tget("3_10"), ct, torch.as_tensor(alb), cf=4)
    M2j = jax.jit(lambda c, a, rr: jprecond.make_two_level_pc(jget("3_10"), c, a, cf=4)(rr))
    np.testing.assert_allclose(M2t(torch.as_tensor(r)).numpy(),
                               np.asarray(M2j(cj, jnp.asarray(alb), jnp.asarray(r))),
                               atol=2e-5 * np.abs(r).max())


def test_thermal_source_and_absorption_dense():
    """`thermal_source` and `calc_flx_div` on a dense field with zeroed
    (solid) cells, where the emissivity 1 - sum(dst) is 1 as in the JAX
    package.  Sources are O(1e5) W (face areas of 1e4 m2).  `b_eff`
    cancels ((b_far - b_near) mu / tau against the expm1 term) on these
    random per-cell Planck values at tau down to 1e-3, and the two
    frameworks' float32 expm1 differ in the last bits: rtol 2e-4.  The
    absorption is fed one source on both sides: rtol 1e-5."""
    cj, ct, b, alb = _system(5)
    rng = np.random.default_rng(6)
    planck = (2.0 + 4.0 * rng.random((NZ + 1, NX, NY))).astype(np.float32)
    kabs = (1e-5 + 1e-3 * rng.random((NZ, NX, NY))).astype(np.float32)
    dz = np.full((NZ, NX, NY), 100.0, np.float32)
    l1d = np.zeros(NZ, bool)
    l1d[0] = True
    bj = jsources.thermal_source(jget("3_10"), cj, jnp.asarray(planck), jnp.asarray(kabs),
                                 jnp.asarray(dz), 100.0, 100.0, jnp.asarray(alb), l1d)
    bt = tsources.thermal_source(tget("3_10"), ct, torch.as_tensor(planck), torch.as_tensor(kabs),
                                 torch.as_tensor(dz), 100.0, 100.0, torch.as_tensor(alb), l1d)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=2e-4, atol=1e-3)
    a11 = rng.random((NZ, NX, NY)).astype(np.float32) * 0.5
    a12 = rng.random((NZ, NX, NY)).astype(np.float32) * 0.4
    vol = dz * 1e4
    aj = jabso.calc_flx_div(jget("3_10"), jc.CoeffFields(None, None, cj), jnp.asarray(b),
                            jnp.asarray(vol), l1d, jnp.asarray(kabs), jnp.asarray(dz),
                            jnp.asarray(a11), jnp.asarray(a12), b_thermal=bj)
    at = tabso.calc_flx_div(tget("3_10"), ct, torch.as_tensor(b), torch.as_tensor(vol), l1d,
                            torch.as_tensor(kabs), torch.as_tensor(dz), torch.as_tensor(a11),
                            torch.as_tensor(a12), b_thermal=torch.as_tensor(np.array(bj)))
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=1e-5, atol=1e-8)
