"""The CUDA kernels K1 (`fused_A_dots`), K2 (`orbit_contract`), K3
(`diffuse_apply_dense`) and K4 (`boxmc_trace`) against their plain PyTorch
versions, on the card, K1 and K3 also in their halo mode (a decomposed
solve's block: against the periodic launch bit for bit where the ring is
the block's own wrap, against the plain halo version otherwise); and the
1-D column solvers (Schwarzschild, DISORT,
`PprtsSolver`'s 1-D types), the wedge solvers (`plexrt`, with NCA and
`specint_plexrt`) and the wedge photon tracer and table creation on the card
against the CPU; a wedge solve on a one-rank NCCL group against the
undecomposed one, and the port's C library's demo against the Python API,
bit for bit.

These tests need an NVIDIA GPU (marker `cuda`) and skip without one.  The
file imports neither JAX nor the JAX package, so it also runs on a GPU
machine that has only PyTorch; there, skip `tests/conftest.py` (which sets
JAX up for the CPU tests):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances: fields are sums of float32 products in another order (atol
3e-6 on O(1) values at 3_10's 24 channels, and per dst at most 30 groups of
coefficients in [0, 0.1) at the larger schemes: atol 1e-5 there); the dots
sum ~1e5 terms (rtol 2e-5).  K3 sums nd float32 products per value in the
plain version's order or another (atol 3e-6 at 10 dofs, 1e-5 at up to 30);
kernel and plain version read the same bfloat16 coefficients as float32, so
the bound is the same for both types.  K4
and its plain version do the same IEEE float32 arithmetic per photon (K4
stops a photon at its exit, the plain version too); a rare flipped
comparison moves one photon's weight (1/5120), so tallies are held at
three photons' weight (6e-4), their mean at 1e-5 and the photon-steps at
0.1%.  Where both sum the photons' records in K4's order, they agree bit
for bit.  K1 and K2 are compiled for the table sets of
`cuda_ops.ORBIT_SCHEMES` and refuse other tables; K3 for the dof counts of
`cuda_ops.DENSE_NDS`."""

import numpy as np
import pytest
import torch

from tenstream_tpu_torch.boxmc import cuda_tracer
from tenstream_tpu_torch.optprop.facade import diff_pair_orbits
from tenstream_tpu_torch.pprts import cuda_ops
from tenstream_tpu_torch.streams import get_scheme

FIELD_ATOL = 3e-6
WIDE_FIELD_ATOL = 1e-5  # schemes with more than 10 diffuse dofs
DOT_RTOL = 2e-5
# one scheme per K1/K2 instantiation, and the schemes that share one
SCHEMES = ("3_10", "3_6", "8_12", "3_16", "8_18", "3_24", "3_30", "8_10", "8_16")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda is unavailable)")
    return torch.device("cuda")


def _inputs(name, B, nz, nx, ny, seed):
    scheme = get_scheme(name)
    nd = scheme.ndiff
    if name in SCHEMES:
        idx, norb = diff_pair_orbits(scheme, with_mz=False)
        idx = np.asarray(idx, np.int64)
    else:
        norb = max(4, nd)
        idx = np.random.default_rng(1).integers(0, norb, (nd, nd))
    rng = np.random.default_rng(seed)
    orb = (rng.random((B, norb, nz, nx, ny)) * 0.1).astype(np.float32)
    u = rng.random((B, nd, nz + 1, nx, ny)).astype(np.float32)
    w = rng.random((B, nd, nz + 1, nx, ny)).astype(np.float32)
    alb = (rng.random((B, nx, ny)) * 0.8).astype(np.float32)
    src = rng.random((B, nd, nz, nx, ny)).astype(np.float32)
    return scheme, idx, orb, u, w, alb, src


@pytest.mark.cuda
@pytest.mark.parametrize("name,B,nz,nx,ny", [("3_10", 2, 5, 6, 10), ("3_10", 1, 39, 64, 64),
                                             ("3_10", 1, 4, 3, 33), ("3_10", 3, 1, 1, 1),
                                             ("3_10", 1, 7, 33, 65), ("3_10", 1, 39, 256, 256),
                                             ("3_10", 8, 24, 64, 64)]
                         + [(n, B, nz, nx, ny) for n in SCHEMES[1:]
                            for B, nz, nx, ny in ((2, 5, 6, 10), (1, 7, 33, 65), (3, 1, 1, 1),
                                                  (1, 39, 64, 64))])
def test_cuda_kernels_match_plain(cuda_device, name, B, nz, nx, ny):
    """K1 and K2 of every instantiation, against their plain versions."""
    ts, idx, orb, u, w, alb, src = _inputs(name, B, nz, nx, ny, seed=2)
    atol = FIELD_ATOL if ts.ndiff <= 10 else WIDE_FIELD_ATOL
    dev = lambda a: torch.as_tensor(a, device=cuda_device)
    cuda_ops.reset_launch_counts()
    Au, dots = cuda_ops.fused_A_dots(ts, idx, dev(orb), dev(u), dev(w), dev(alb))
    out = cuda_ops.orbit_contract(ts, idx, dev(orb), dev(src))
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES == {"fused_A_dots": 1, "orbit_contract": 1,
                                 "diffuse_apply_dense": 0, "boxmc_trace": 0}
    Au_p, dots_p = cuda_ops.fused_A_dots_plain(ts, idx, dev(orb), dev(u), dev(w), dev(alb))
    out_p = cuda_ops.orbit_contract_plain(idx, dev(orb), dev(src))
    np.testing.assert_allclose(Au.cpu().numpy(), Au_p.cpu().numpy(), atol=atol)
    np.testing.assert_allclose(dots.cpu().numpy(), dots_p.cpu().numpy(), rtol=DOT_RTOL)
    np.testing.assert_allclose(out.cpu().numpy(), out_p.cpu().numpy(), atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,nz,nx,ny", [(2, 5, 6, 10), (1, 40, 64, 64), (1, 4, 3, 33),
                                        (1, 1, 1, 1), (3, 7, 13, 130), (1, 1, 9, 67),
                                        (2, 3, 9, 136)])
def test_cuda_dense_apply_matches_plain(cuda_device, dtype, B, nz, nx, ny):
    """Ragged shapes too (nx, ny not multiples of K3's 8 x 128 tile or of its
    vector width, nz = 1, B = 3).  Each call runs right after a NaN-filled
    block of the output's size was freed: the caching allocator hands K3
    that block, so a face the kernel never writes shows as NaN."""
    ts = get_scheme("3_10")
    rng = np.random.default_rng(3)
    c = torch.as_tensor((rng.random((B, 10, 10, nz, nx, ny)) * 0.1).astype(np.float32),
                        device=cuda_device).to(dtype)
    x = torch.as_tensor(rng.random((B, 10, nz + 1, nx, ny)).astype(np.float32),
                        device=cuda_device)
    cuda_ops.reset_launch_counts()
    torch.full_like(x, float("nan"))
    out = cuda_ops.diffuse_apply_dense(ts, c, x)
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["diffuse_apply_dense"] == 1
    ref = cuda_ops.diffuse_apply_dense_plain(ts, c, x)
    assert out.dtype == torch.float32 and out.shape == x.shape
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), atol=FIELD_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,nz,nx,ny", [(2, 5, 6, 10), (1, 39, 64, 64), (3, 7, 13, 130),
                                        (1, 1, 9, 67)])
@pytest.mark.parametrize("name", ["3_6", "8_12", "3_16", "8_18", "3_24", "3_30"])
def test_cuda_dense_apply_by_dof_count(cuda_device, name, dtype, B, nz, nx, ny):
    """K3 at every other dof count it is instantiated for, at ragged shapes,
    right after a NaN-filled block of the output's size was freed."""
    ts = get_scheme(name)
    nd = ts.ndiff
    rng = np.random.default_rng(nd)
    c = torch.as_tensor((rng.random((B, nd, nd, nz, nx, ny)) * 0.1).astype(np.float32),
                        device=cuda_device).to(dtype)
    x = torch.as_tensor(rng.random((B, nd, nz + 1, nx, ny)).astype(np.float32),
                        device=cuda_device)
    cuda_ops.reset_launch_counts()
    torch.full_like(x, float("nan"))
    out = cuda_ops.diffuse_apply_dense(ts, c, x)
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["diffuse_apply_dense"] == 1
    ref = cuda_ops.diffuse_apply_dense_plain(ts, c, x)
    atol = FIELD_ATOL if nd <= 10 else WIDE_FIELD_ATOL
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), atol=atol)


@pytest.mark.cuda
def test_cuda_dense_apply_rejects_bad_inputs(cuda_device):
    ts = get_scheme("3_10")
    c = torch.zeros((1, 10, 10, 2, 3, 4), device=cuda_device)
    x = torch.zeros((1, 10, 3, 3, 4), device=cuda_device)
    with pytest.raises(ValueError):  # mixed devices: no quiet step down to the plain version
        cuda_ops.diffuse_apply_dense(ts, c.cpu(), x)
    with pytest.raises(RuntimeError):
        cuda_ops.diffuse_apply_dense(ts, c.half(), x)
    with pytest.raises(RuntimeError):
        cuda_ops.diffuse_apply_dense(ts, c[:, :, :, :1], x)
    with pytest.raises(RuntimeError):
        cuda_ops.diffuse_apply_dense(ts, c, x.double())
    ts2 = get_scheme("1_2")
    with pytest.raises(ValueError, match="K3 is instantiated for"):  # no 2-dof instantiation
        cuda_ops.diffuse_apply_dense(ts2, torch.zeros((1, 2, 2, 2, 3, 4), device=cuda_device),
                                     torch.zeros((1, 2, 3, 3, 4), device=cuda_device))
    itab = list(cuda_ops._dense_tables(ts))
    itab[1] = -1  # gshift_z[0] outside {0, 1}: the binding refuses it too
    with pytest.raises(RuntimeError, match="gshift"):
        cuda_ops.load_extension().diffuse_apply_dense(x, c, itab)


@pytest.mark.cuda
def test_cuda_dense_apply_unaligned_views(cuda_device):
    """Fields whose base is not 16-byte aligned (contiguous views one element
    into a larger buffer) take K3's element loads and match the plain version."""
    ts = get_scheme("3_10")
    rng = np.random.default_rng(5)
    B, nz, nx, ny = 2, 3, 9, 128
    nc, nf = B * 100 * nz * nx * ny, B * 10 * (nz + 1) * nx * ny
    for dtype in (torch.float32, torch.bfloat16):
        cbuf = torch.as_tensor((rng.random(nc + 1) * 0.1).astype(np.float32),
                               device=cuda_device).to(dtype)
        xbuf = torch.as_tensor(rng.random(nf + 1).astype(np.float32), device=cuda_device)
        c = cbuf[1:].view(B, 10, 10, nz, nx, ny)
        x = xbuf[1:].view(B, 10, nz + 1, nx, ny)
        out = cuda_ops.diffuse_apply_dense(ts, c, x)
        ref = cuda_ops.diffuse_apply_dense_plain(ts, c, x)
        np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), atol=FIELD_ATOL)


@pytest.mark.cuda
def test_cuda_dense_launch_config(cuda_device):
    """K3 runs two blocks per SM at up to 10 dofs (the shared memory of its
    two staged steps), one above."""
    for dtype in (torch.float32, torch.bfloat16):
        cfg = cuda_ops.dense_launch_config(dtype)
        assert cfg["blocks_per_sm"] >= 2 and cfg["smem_bytes"] > 48 * 1024, cfg
        for nd in cuda_ops.DENSE_NDS:
            cfg = cuda_ops.dense_launch_config(dtype, nd)
            assert cfg["blocks_per_sm"] >= (2 if nd <= 10 else 1), (nd, cfg)


@pytest.mark.cuda
def test_cuda_wrappers_reject_bad_inputs(cuda_device):
    ts, idx, orb, u, w, alb, _ = _inputs("3_10", 1, 2, 3, 4, seed=0)
    dev = lambda a: torch.as_tensor(a, device=cuda_device)
    with pytest.raises(ValueError):
        cuda_ops.fused_A_dots(ts, idx, dev(orb), torch.as_tensor(u), dev(w), dev(alb))
    with pytest.raises(RuntimeError):
        cuda_ops.fused_A_dots(ts, idx, dev(orb), dev(u).double(), dev(w), dev(alb))
    with pytest.raises(RuntimeError):
        cuda_ops.fused_A_dots(ts, idx, dev(orb), dev(u)[..., ::2], dev(w)[..., ::2], dev(alb))
    ts2, idx2, orb2, u2, w2, alb2, src2 = _inputs("1_2", 1, 2, 3, 4, seed=0)
    with pytest.raises(ValueError, match="matches none"):  # no instantiation for 1_2's tables
        cuda_ops.orbit_contract(ts2, idx2, dev(orb2), dev(src2))
    with pytest.raises(ValueError, match="matches none"):
        cuda_ops.fused_A_dots(ts2, idx2, dev(orb2), dev(u2), dev(w2), dev(alb2))
    with pytest.raises(ValueError, match="matches none"):  # a reversed 3_10 orbit table
        cuda_ops.fused_A_dots(ts, idx[::-1].copy(), dev(orb), dev(u), dev(w), dev(alb))


_K4_ENTRIES = np.array([[1e-10, 0.5, 1.0, 0.0, 0.0, 0.0], [2.0, 0.0, 1.0, 0.0, 30.0, 40.0],
                        [1.0, 0.9, 1.0, 0.85, 30.0, 40.0], [20.0, 0.99999, 1.0, 0.85, 30.0, 40.0],
                        [0.5, 0.9, 0.02, 0.5, 10.0, 85.0], [0.5, 0.9, 7.45, 0.0, 60.0, 20.0],
                        [100.0, 0.99999, 1.0, 0.85, 45.0, 45.0]], np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("scheme,src,ldir", [("3_10", 0, True), ("3_10", 2, True),
                                             ("3_10", 0, False), ("3_10", 5, False),
                                             ("3_6", 3, False), ("1_2", 1, False),
                                             ("8_10", 7, False)])
def test_cuda_boxmc_matches_plain(cuda_device, scheme, src, ldir):
    rows = cuda_tracer.entry_rows(_K4_ENTRIES, scheme, src, ldir, 11, cuda_device)
    cuda_ops.reset_launch_counts()
    out, steps = cuda_tracer.boxmc_trace(rows, scheme, ldir)
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["boxmc_trace"] == 1
    ref, ref_steps = cuda_tracer.boxmc_trace_plain(rows, scheme, ldir)
    d = (out - ref).abs()
    assert d.max().item() <= 6e-4 and d.mean().item() <= 1e-5, (d.max().item(), d.mean().item())
    np.testing.assert_allclose(steps.cpu().numpy(), ref_steps.cpu().numpy(), rtol=1e-3)
    assert out.sum(1).max().item() <= 1.0 + 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("scheme,src,ldir", [("3_10", 0, True), ("3_10", 2, False),
                                             ("3_6", 3, False), ("8_10", 7, False)])
def test_cuda_boxmc_bit_identical_to_ordered_plain(cuda_device, scheme, src, ldir):
    """The plain version sums the photons' records in K4's order: where each
    photon's walk rounds alike (IEEE float32, no contraction), the tallies
    and photon-steps are equal bit for bit."""
    rows = cuda_tracer.entry_rows(_K4_ENTRIES, scheme, src, ldir, 3, cuda_device)
    out, steps = cuda_tracer.boxmc_trace(rows, scheme, ldir)
    ref, ref_steps = cuda_tracer.boxmc_trace_plain(rows, scheme, ldir)
    assert torch.equal(out, ref) and torch.equal(steps, ref_steps)


@pytest.mark.cuda
def test_cuda_boxmc_row_independent_of_its_neighbours(cuda_device):
    """A thick entry in row 4095 gets the same tallies whether the other 4095
    rows are thin or thick: the photons walked beside it do not touch it."""
    thick = np.array([100.0, 0.99999, 1.0, 0.85, 0.0, 0.0], np.float32)
    res = []
    for other in ([1e-10, 0.5, 1.0, 0.0, 0.0, 0.0], [5.0, 0.9, 1.0, 0.85, 0.0, 0.0]):
        ent = np.tile(np.array(other, np.float32), (4096, 1))
        ent[4095] = thick
        rows = cuda_tracer.entry_rows(ent, "3_10", 0, False, 13, cuda_device)
        out, steps = cuda_tracer.boxmc_trace(rows, "3_10", False)
        res.append((out[4095], steps[4095], steps[:4095].sum().item()))
    assert res[0][2] < res[1][2]  # the neighbours did walk differently
    assert torch.equal(res[0][0], res[1][0]) and torch.equal(res[0][1], res[1][1])


@pytest.mark.cuda
def test_cuda_boxmc_repeats_bit_for_bit(cuda_device):
    rows = cuda_tracer.entry_rows(_K4_ENTRIES, "3_10", 1, False, 5, cuda_device)
    a, sa = cuda_tracer.boxmc_trace(rows, "3_10", False)
    b, sb = cuda_tracer.boxmc_trace(rows, "3_10", False)
    assert torch.equal(a, b) and torch.equal(sa, sb)
    T, S = cuda_tracer.run_boxmc_cuda(_K4_ENTRIES, "3_10", 1, False, seed=5, device=cuda_device)
    assert T.shape == (7, 3) and S.shape == (7, 10) and bool((T == 0).all())
    assert torch.equal(S, a[:, 3:])


@pytest.mark.cuda
def test_cuda_boxmc_refuses_schemes_it_cannot_represent(cuda_device):
    for scheme, ldir in (("3_16", False), ("3_16", True), ("8_16", False), ("8_10", True),
                         ("3_24", False)):
        with pytest.raises(ValueError, match="K4 cannot trace"):
            cuda_tracer.run_boxmc_cuda(_K4_ENTRIES, scheme, 0, ldir, device=cuda_device)
    rows = cuda_tracer.entry_rows(_K4_ENTRIES, "3_10", 0, False, 0, cuda_device)
    for bad in (rows[:, :8].contiguous(), rows.double(), rows.t().contiguous().t()):
        with pytest.raises(ValueError, match="contiguous float32"):
            cuda_tracer.boxmc_trace(bad, "3_10", False)


@pytest.mark.cuda
def test_cuda_binding_checks_raise(cuda_device):
    """The binding's own checks raise (their messages are literals: one that
    formats a number crashed the process with the CUDA build toolchain)."""
    ext = cuda_ops.load_extension()
    rows = cuda_tracer.entry_rows(_K4_ENTRIES, "3_10", 0, False, 0, cuda_device)
    tab = list(cuda_tracer._tables("3_10"))
    order = cuda_tracer.launch_order(rows)
    for args in ((rows[:, :8].contiguous(), order, 0, 3, 10, tab, 100),
                 (rows, order, 0, 3, 10, tab[:17], 100), (rows, order, 0, 3, 10, tab, -1),
                 (rows, order, 0, 3, 10, [20] * 18, 100), (rows, order.long(), 0, 3, 10, tab, 100),
                 (rows, order[:6], 0, 3, 10, tab, 100), (rows, order, 0, 3, 7, tab, 100)):
        with pytest.raises(RuntimeError):
            ext.boxmc_trace(*args)
    ts, idx, orb, u, w, alb, _ = _inputs("3_10", 1, 2, 3, 4, seed=0)
    dev = lambda a: torch.as_tensor(a, device=cuda_device)
    with pytest.raises(RuntimeError):  # 9 dofs where 3_10's K1 is compiled for 10
        ext.fused_A_dots(dev(u)[:, :9].contiguous(), dev(w)[:, :9].contiguous(), dev(orb),
                         dev(alb), 0)
    with pytest.raises(RuntimeError):  # 3_10's fields on 3_6's instantiation
        ext.fused_A_dots(dev(u), dev(w), dev(orb), dev(alb), 1)
    for inst in (-1, len(cuda_ops.ORBIT_SCHEMES)):  # no instantiation with this index
        with pytest.raises(RuntimeError):
            ext.fused_A_dots(dev(u), dev(w), dev(orb), dev(alb), inst)


def _wrap_pad(t):
    """t (..., nx, ny) with the periodic one-cell ring: what `Mesh.pad`
    gives a rank that is its own neighbour."""
    t = torch.cat([t[..., -1:, :], t, t[..., :1, :]], dim=-2)
    return torch.cat([t[..., -1:], t, t[..., :1]], dim=-1).contiguous()


def _random_ring(t, seed):
    """t padded by a one-cell ring of other random values (a neighbour's)."""
    g = torch.Generator(device=t.device).manual_seed(seed)
    p = torch.rand(tuple(t.shape[:-2]) + (t.shape[-2] + 2, t.shape[-1] + 2), generator=g,
                   device=t.device) * float(t.max())
    p[..., 1:-1, 1:-1] = t
    return p


HALO_SHAPES = ((2, 5, 6, 10), (1, 39, 64, 64), (1, 7, 33, 65), (2, 4, 9, 136))


@pytest.mark.cuda
@pytest.mark.parametrize("B,nz,nx,ny", HALO_SHAPES)
@pytest.mark.parametrize("name", ["3_10", "3_6", "8_12", "3_16", "8_18", "3_24", "3_30"])
def test_cuda_k1_halo_mode(cuda_device, name, B, nz, nx, ny):
    """K1's halo mode (staged design at 3_10 / 3_6, direct above): with the
    periodic ring (a rank that is its own neighbour) it gives the periodic
    launch's outputs bit for bit; with another ring, its plain version's."""
    ts, idx, orb, u, w, alb, _ = _inputs(name, B, nz, nx, ny, seed=4)
    atol = FIELD_ATOL if ts.ndiff <= 10 else WIDE_FIELD_ATOL
    dev = lambda a: torch.as_tensor(a, device=cuda_device)
    orb, u, w, alb = dev(orb), dev(u), dev(w), dev(alb)
    Au, dots = cuda_ops.fused_A_dots(ts, idx, orb, u, w, alb)
    cuda_ops.reset_launch_counts()
    Au_h, dots_h = cuda_ops.fused_A_dots(ts, idx, _wrap_pad(orb), _wrap_pad(u), w, alb, halo=True)
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["fused_A_dots"] == 1 and cuda_ops.HALO_LAUNCHES["fused_A_dots"] == 1
    assert torch.equal(Au_h, Au) and torch.equal(dots_h, dots)
    up, op = _random_ring(u, 1), _random_ring(orb, 2)
    Au_r, dots_r = cuda_ops.fused_A_dots(ts, idx, op, up, w, alb, halo=True)
    Au_p, dots_p = cuda_ops.fused_A_dots_plain(ts, idx, op, up, w, alb, halo=True)
    np.testing.assert_allclose(Au_r.cpu().numpy(), Au_p.cpu().numpy(), atol=atol)
    np.testing.assert_allclose(dots_r.cpu().numpy(), dots_p.cpu().numpy(), rtol=DOT_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,nz,nx,ny", HALO_SHAPES)
@pytest.mark.parametrize("name", ["3_10", "3_6", "3_16", "3_30"])
def test_cuda_k3_halo_mode(cuda_device, name, dtype, B, nz, nx, ny):
    """K3's halo mode: with the block's own first planes as halos and its
    edge outputs folded back onto itself it gives the periodic launch's
    output bit for bit; with other halo planes, its plain version's three
    outputs.  Run right after a NaN-filled block of the output's size was
    freed, so a face the kernel never writes shows."""
    ts = get_scheme(name)
    nd = ts.ndiff
    rng = np.random.default_rng(nd + 1)
    c = torch.as_tensor((rng.random((B, nd, nd, nz, nx, ny)) * 0.1).astype(np.float32),
                        device=cuda_device).to(dtype)
    x = torch.as_tensor(rng.random((B, nd, nz + 1, nx, ny)).astype(np.float32),
                        device=cuda_device)
    ref = cuda_ops.diffuse_apply_dense(ts, c, x)
    cshift, _ = cuda_ops._shift_tables(ts)
    cuda_ops.reset_launch_counts()
    torch.full_like(x, float("nan"))
    out, ox, oy = cuda_ops.diffuse_apply_dense(
        ts, c, x, halo=(x[..., 0, :].contiguous(), x[..., :, 0].contiguous()))
    torch.cuda.synchronize()
    assert cuda_ops.HALO_LAUNCHES["diffuse_apply_dense"] == 1
    for d, (_, cx, cy) in enumerate(cshift):
        if cx == -1:
            out[:, d, :, 0, :] = ox[:, d]
        elif cy == -1:
            out[:, d, :, :, 0] = oy[:, d]
    assert torch.equal(out, ref)
    hx = torch.as_tensor(rng.random((B, nd, nz + 1, ny)).astype(np.float32), device=cuda_device)
    hy = torch.as_tensor(rng.random((B, nd, nz + 1, nx)).astype(np.float32), device=cuda_device)
    torch.full_like(x, float("nan"))
    got = cuda_ops.diffuse_apply_dense(ts, c, x, halo=(hx, hy))
    want = cuda_ops.diffuse_apply_dense_plain(ts, c, x, halo=(hx, hy))
    atol = FIELD_ATOL if nd <= 10 else WIDE_FIELD_ATOL
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), atol=atol)


def _chunk_solve(device, plain: bool):
    """A chunk of 8 bands (clouds of growing optical depth, one lane
    warm-started from its own solution) solved as one batch on the card,
    through K1/K2 or through their plain versions; returns the result and
    the kernel launches of the second solve."""
    import glob
    import os

    from tenstream_tpu_torch.core.config import Options
    from tenstream_tpu_torch.optprop.facade import OptProp
    from tenstream_tpu_torch.optprop.lut import LUT
    from tenstream_tpu_torch.pprts import ediff
    from tenstream_tpu_torch.pprts.grid import Grid
    from tenstream_tpu_torch.pprts.solver import PprtsSolver
    from tenstream_tpu_torch.pprts.sun import sundir_from_angles

    here = os.path.dirname(os.path.abspath(__file__))
    lut = LUT.load(sorted(glob.glob(os.path.join(here, "data", "luts", "LUT_3_10_*.npz")))[0],
                   device=device)
    B, nz, nx, ny = 8, 10, 16, 16
    rng = np.random.default_rng(3)
    ka = (1e-5 + 2e-4 * rng.random((B, nz, nx, ny))).astype(np.float32)
    ks = (1e-5 + 1e-4 * rng.random((B, nz, nx, ny))).astype(np.float32)
    for i in range(B):
        ks[i, 3:7, 4:12, 4:12] += 0.01 * 4 ** (i / 2)
    g = np.full((B, nz, nx, ny), 0.5, np.float32)
    s = PprtsSolver(Grid.create(nz, nx, ny, 100.0, 100.0, 100.0, device=device),
                    OptProp(lut, device=device), options=Options({}, read_env=False))
    s.set_angles(sundir_from_angles(40.0, 35.0))
    alb = torch.full((nx, ny), 0.2, device=device)
    toa = np.linspace(100.0, 800.0, B).astype(np.float32)
    saved = (ediff.fused_A_dots, cuda_ops.orbit_contract)
    if plain:
        ediff.fused_A_dots = lambda scheme, idx, orb, u, w, a: cuda_ops.fused_A_dots_plain(
            scheme, idx, orb, u, w, a)
        cuda_ops.orbit_contract = lambda scheme, idx, orb, src: cuda_ops.orbit_contract_plain(
            idx, orb, src)
    try:
        first = s.solve_lanes(False, True, ka, ks, g, alb, edirTOA=toa)
        x0 = torch.zeros_like(first.ediff)
        x0[0] = first.ediff[0]
        cuda_ops.reset_launch_counts()
        r = s.solve_lanes(False, True, ka, ks, g, alb, edirTOA=toa, x0=x0,
                          omega0=[first.omega[0]] + [1.0] * (B - 1))
        torch.cuda.synchronize()
        return r, dict(cuda_ops.LAUNCHES)
    finally:
        ediff.fused_A_dots, cuda_ops.orbit_contract = saved


@pytest.mark.cuda
def test_cuda_batched_chunk_matches_plain(cuda_device):
    """The band-batched solve through K1 (B = 8 per launch, per-lane dots)
    and K2 against the same chunk through their plain versions: the same
    per-lane iterations, and fields within float32 round-off of their
    magnitude; the lane that converges at once is frozen at its warm
    state in both."""
    r, launches = _chunk_solve(cuda_device, plain=False)
    p, plain_launches = _chunk_solve(cuda_device, plain=True)
    assert launches["fused_A_dots"] > 0 and launches["orbit_contract"] > 0
    assert plain_launches["fused_A_dots"] == plain_launches["orbit_contract"] == 0
    assert r.niter == p.niter and r.niter_bicgstab == p.niter_bicgstab, (r.niter, p.niter)
    assert r.niter[0] == 1 and max(r.niter) > 1
    # one K1 launch for the warm seed, two per BiCGStab iteration of the chunk
    assert launches["fused_A_dots"] == 1 + 2 * max(r.niter_bicgstab)
    for a, b in ((r.ediff, p.ediff), (r.edir, p.edir), (r.abso, p.abso)):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    assert all(res <= 1.5 * tol for res, tol in zip(r.res, r.tol))


@pytest.mark.cuda
def test_cuda_spectral_host_cache_matches_f32(cuda_device):
    """`specint_pprts` on the card with the warm states kept in pinned host
    memory (copied without waiting, collected one chunk later) against the
    f32 device cache: the same iterations, and fluxes within float32
    round-off of their magnitude, on a cold and a warm perturbed call."""
    import glob
    import os

    from tenstream_tpu_torch.atm import setup_standard_atmosphere
    from tenstream_tpu_torch.core.config import Options
    from tenstream_tpu_torch.optprop.facade import OptProp
    from tenstream_tpu_torch.optprop.lut import LUT
    from tenstream_tpu_torch.pprts.grid import Grid
    from tenstream_tpu_torch.pprts.solver import PprtsSolver
    from tenstream_tpu_torch.pprts.sun import sundir_from_angles
    from tenstream_tpu_torch.spectral import specint_pprts
    from tenstream_tpu_torch.spectral.ecckd import EcckdGasOptics

    here = os.path.dirname(os.path.abspath(__file__))
    opp = OptProp(LUT.load(sorted(glob.glob(os.path.join(here, "data", "luts",
                                                         "LUT_3_10_*.npz")))[0],
                           device=cuda_device), device=cuda_device)
    z_low = np.arange(0.0, 2401.0, 100.0)
    zlev = np.concatenate([np.geomspace(2650.0, 20e3, 16)[::-1], z_low[::-1][1:]])
    atm = setup_standard_atmosphere(z_grid=zlev)
    n = 16
    lwc = np.zeros((atm.nlay, n, n), np.float32)
    lwc[25:27, 3:9, 4:12] = 0.4
    out = {}
    for mode in ("f32", "host"):
        s = PprtsSolver(Grid.create(atm.nlay, n, n, 100.0, 100.0, atm.dz.astype(np.float32),
                                    device=cuda_device), opp,
                        options=Options({"atm_collapse": 16, "specint_cache": mode},
                                        read_env=False))
        s.set_angles(sundir_from_angles(120.0, 40.0))
        res = []
        for step in range(2):
            r = specint_pprts(s, atm, albedo=0.15, lthermal=True, lsolar=True,
                              specint=EcckdGasOptics(n_gpt=16), lwc=np.roll(lwc, step, axis=1),
                              band_chunk=8)
            res.append(([a.cpu() for a in r],
                        sorted((k, tuple(v.niter_diff)) for k, v in s.solutions.items())))
        if mode == "host":
            assert all(v.ediff.device.type == "cpu" and v.ediff.is_pinned()
                       for v in s.solutions.values())
        out[mode] = res
    for (rf, nf), (rh, nh) in zip(out["f32"], out["host"]):
        assert nf == nh
        for a, b in zip(rf, rh):
            assert float((a - b).abs().max()) <= 1e-5 * float(a.abs().max())


def _solve_8_10(device, plain):
    """The 5x6x6 box-cloud scene of `tests/test_torch_8_10.py` on the
    committed 8_10 production table, solar, through K1/K2 or their plain
    versions; returns the result and the kernel launches."""
    import os

    from tenstream_tpu_torch.optprop.facade import OptProp
    from tenstream_tpu_torch.optprop.lut import LUT
    from tenstream_tpu_torch.pprts import ediff
    from tenstream_tpu_torch.pprts.grid import Grid
    from tenstream_tpu_torch.pprts.solver import PprtsSolver
    from tenstream_tpu_torch.pprts.sun import sundir_from_angles

    here = os.path.dirname(os.path.abspath(__file__))
    lut = LUT.load(os.path.join(here, "..", "data", "luts", "LUT_8_10_production.npz"),
                   device=device)
    nz, nx, ny = 5, 6, 6
    ka = np.full((nz, nx, ny), 1e-5, np.float32)
    ks = np.full((nz, nx, ny), 2e-5, np.float32)
    g = np.zeros((nz, nx, ny), np.float32)
    ka[1:3, 2:4, 1:4], ks[1:3, 2:4, 1:4], g[1:3, 2:4, 1:4] = 2e-3, 1.5e-2, 0.85
    s = PprtsSolver(Grid.create(nz, nx, ny, 100.0, 100.0, 100.0, device=device),
                    OptProp(lut, device=device))
    s.set_optical_properties(0.15, ka, ks, g)
    s.set_angles(sundir_from_angles(210.0, 60.0))
    saved = (ediff.fused_A_dots, cuda_ops.orbit_contract)
    if plain:
        ediff.fused_A_dots = lambda scheme, idx, orb, u, w, a: cuda_ops.fused_A_dots_plain(
            scheme, idx, orb, u, w, a)
        cuda_ops.orbit_contract = lambda scheme, idx, orb, src: cuda_ops.orbit_contract_plain(
            idx, orb, src)
    try:
        cuda_ops.reset_launch_counts()
        sol = s.solve(lthermal=False, lsolar=True, edirTOA=1000.0)
        res = s.get_result()
        torch.cuda.synchronize()
        return sol, res, dict(cuda_ops.LAUNCHES)
    finally:
        ediff.fused_A_dots, cuda_ops.orbit_contract = saved


@pytest.mark.cuda
def test_cuda_8_10_solve_through_k1_matches_plain(cuda_device):
    """8_10 shares 3_10's diffuse tables, so K1 (compiled for them) and K2
    run its diffuse solve: the same iterations and fields as the plain
    versions (the CPU parity with JAX: `tests/test_torch_8_10.py`)."""
    sol, res, launches = _solve_8_10(cuda_device, plain=False)
    psol, pres, plain_launches = _solve_8_10(cuda_device, plain=True)
    assert launches["fused_A_dots"] > 0 and launches["orbit_contract"] > 0
    assert plain_launches["fused_A_dots"] == plain_launches["orbit_contract"] == 0
    assert sol.niter_diff == psol.niter_diff
    for a, b in zip(res, pres):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


def _column_fields(nz=9, nx=5, ny=4, seed=21):
    """Odd nz, several columns, albedo other than 0, a thick anisotropic
    layer: the 1-D solvers' test scene."""
    rng = np.random.default_rng(seed)
    dtau = rng.uniform(0.01, 2.0, (nz, nx, ny)).astype(np.float32)
    w0 = rng.uniform(0.0, 0.99, (nz, nx, ny)).astype(np.float32)
    g = rng.uniform(0.0, 0.9, (nz, nx, ny)).astype(np.float32)
    dtau[4], w0[4], g[4] = 30.0, 0.999, 0.85
    albedo = rng.uniform(0.05, 0.5, (nx, ny)).astype(np.float32)
    planck = rng.uniform(50.0, 150.0, (nz + 1, nx, ny)).astype(np.float32)
    return dtau, w0, g, albedo, planck


def _near(a, b, rtol):
    """|card - CPU| <= rtol x max|CPU| over the field."""
    a, b = a.cpu(), b.cpu()
    assert float((a - b).abs().max()) <= rtol * float(b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("nstreams", [4, 8])
def test_cuda_disort_matches_cpu(cuda_device, nstreams):
    """DISORT's batched inverses, solves and products on the card (in true
    float32: the process's TF32 setting is left as it was) against the
    CPU, solar and thermal at once, within 1e-4 of each field's magnitude
    (the bound the CPU holds against JAX, `tests/test_torch_oned.py`)."""
    from tenstream_tpu_torch.ops.disort import disort_fluxes

    dtau, w0, g, albedo, planck = _column_fields()
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        outs = [disort_fluxes(*(torch.as_tensor(a, device=dev) for a in (dtau, w0, g)), 0.6,
                              1000.0, torch.as_tensor(albedo, device=dev),
                              planck=torch.as_tensor(planck, device=dev), nstreams=nstreams)
                for dev in (cuda_device, "cpu")]
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    for a, b in zip(*outs):
        _near(a, b, 1e-4)


@pytest.mark.cuda
def test_cuda_schwarzschild_matches_cpu(cuda_device):
    from tenstream_tpu_torch.ops.schwarzschild import schwarzschild

    dtau, _, _, albedo, planck = _column_fields()
    outs = [schwarzschild(*(torch.as_tensor(a, device=dev) for a in (dtau * 0.3, albedo, planck)),
                          nmu=3) for dev in (cuda_device, "cpu")]
    for a, b in zip(*outs):
        _near(a, b, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("solver_type", ["2str", "schwarzschild", "disort"])
def test_cuda_1d_solver_types_match_cpu(cuda_device, solver_type):
    """`PprtsSolver` with a 1-D solver type, no OptProp: a solar+thermal
    solve on the card and on the CPU."""
    from tenstream_tpu_torch.pprts.grid import Grid
    from tenstream_tpu_torch.pprts.solver import PprtsSolver
    from tenstream_tpu_torch.pprts.sun import sundir_from_angles

    dtau, w0, g, albedo, planck = _column_fields(seed=22)
    dz = np.linspace(50.0, 400.0, dtau.shape[0]).astype(np.float32)
    kext = dtau / dz[:, None, None]
    results = []
    for dev in (cuda_device, "cpu"):
        s = PprtsSolver(Grid.create(dz.size, dtau.shape[1], dtau.shape[2], 100.0, 100.0, dz,
                                    device=dev), solver_type=solver_type)
        s.set_angles(sundir_from_angles(210.0, 35.0))
        s.set_optical_properties(0.0, kext * (1 - w0), kext * w0, g, planck=planck,
                                 albedo_2d=albedo)
        s.solve(lthermal=True, lsolar=True, edirTOA=1000.0)
        results.append(s.get_result())
    for a, b in zip(*results):
        _near(a, b, 1e-4 if solver_type == "disort" else 1e-5)


def _wedge_scene(nz, ncell_shape, seed=31):
    """An absorbing scene on which both wedge solvers converge at their
    defaults (the JAX wedge tests' optical depths), with a cloud."""
    rng = np.random.default_rng(seed)
    shp = (nz,) + ncell_shape
    ka = (1e-4 + 1e-3 * rng.random(shp)).astype(np.float32)
    ks = (1e-4 + 5e-3 * rng.random(shp)).astype(np.float32)
    ks[1:3] += 0.02 * (rng.random(shp[1:]) < 0.3)
    g = rng.uniform(0.0, 0.8, shp).astype(np.float32)
    planck = (np.linspace(2.0, 6.0, nz + 1).reshape((-1,) + (1,) * len(ncell_shape))
              * np.ones(ncell_shape)).astype(np.float32)
    return ka, ks, g, planck


def _wedge_opp(device):
    import os

    from tenstream_tpu_torch.plexrt.optprop import WedgeOptProp, load_or_create_wedge_lut

    lutdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "luts")
    return WedgeOptProp(load_or_create_wedge_lut(n_photons=1500, basename=lutdir, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fish", "icon"])
def test_cuda_wedge_solvers_match_cpu(cuda_device, kind):
    """Both wedge solvers (plain PyTorch, no kernel) on the card against the
    CPU: a solar+thermal solve and NCA, fluxes within 5e-5 of their
    magnitude, absorption within 1e-4 W/m3 (`chip_smoke.py` phase 27's
    gates on converged solves)."""
    from tenstream_tpu_torch.plexrt import icon
    from tenstream_tpu_torch.plexrt.mesh import fish_mesh
    from tenstream_tpu_torch.plexrt.solver import PlexrtSolver
    from tenstream_tpu_torch.plexrt.solver_unstructured import PlexrtSolverIcon
    from tenstream_tpu_torch.pprts.sun import sundir_from_angles

    nz, n = 6, 5
    mesh = icon.trimesh_from_structured(n, n, 100.0, 100.0)
    cells = (2, n, n) if kind == "fish" else (mesh.ncell,)
    ka, ks, g, planck = _wedge_scene(nz, cells)
    results = []
    for dev in (cuda_device, "cpu"):
        opp = _wedge_opp(dev)
        s = (PlexrtSolver(fish_mesh(nz, n, n, 100.0, 100.0, 100.0), opp) if kind == "fish"
             else PlexrtSolverIcon(mesh, np.full(nz, 100.0, np.float32), opp))
        assert s.device.type == torch.device(dev).type
        s.set_angles(sundir_from_angles(210.0, 35.0))
        s.set_optical_properties(0.2, ka, ks, g, planck=planck)
        sol = s.solve(lthermal=True, lsolar=True, edirTOA=1000.0)
        assert sol.diff_res <= sol.diff_tol
        results.append(list(s.get_result(sol)) + [s.nca_absorption(sol)])
    for a, b in zip(results[0][:3], results[1][:3]):
        _near(a, b, 5e-5)
    for a, b in zip(results[0][3:], results[1][3:]):
        assert float((a.cpu() - b).abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("diff_solver", ["bicgstab", "fixedpoint"])
@pytest.mark.parametrize("kind", ["fish", "icon"])
def test_cuda_specint_plexrt_matches_cpu(cuda_device, kind, diff_solver):
    """`specint_plexrt` (ecCKD, max_gpt 6 in chunks of 4: lanes that stop
    apart) on the card against the CPU, with each diffuse solver; every
    lane converges on both devices."""
    from tenstream_tpu_torch.atm import setup_standard_atmosphere
    from tenstream_tpu_torch.plexrt import icon
    from tenstream_tpu_torch.plexrt.mesh import fish_mesh
    from tenstream_tpu_torch.plexrt.solver import PlexrtSolver
    from tenstream_tpu_torch.plexrt.solver_unstructured import PlexrtSolverIcon
    from tenstream_tpu_torch.pprts.sun import sundir_from_angles
    from tenstream_tpu_torch.spectral.specint_plexrt import specint_plexrt

    atm = setup_standard_atmosphere(nlay=6, ztop=6e3)
    dz = atm.dz.astype(np.float32)
    n = 4
    mesh = icon.trimesh_from_structured(n, n, 500.0, 500.0)
    cells = (2, n, n) if kind == "fish" else (mesh.ncell,)
    lwc = np.zeros((atm.nlay,) + cells, np.float32)
    lwc[4, ..., :2] = 0.3
    results = []
    for dev in (cuda_device, "cpu"):
        opp = _wedge_opp(dev)
        s = (PlexrtSolver(fish_mesh(atm.nlay, n, n, 500.0, 500.0, dz), opp,
                          diff_solver=diff_solver) if kind == "fish"
             else PlexrtSolverIcon(mesh, dz, opp, diff_solver=diff_solver))
        s.set_angles(sundir_from_angles(150.0, 30.0))
        lanes = s.solve_lanes

        def converged(*a, **k):
            sol = lanes(*a, **k)
            assert bool((sol.diff_res <= sol.diff_tol).all()), (sol.diff_res, sol.diff_tol)
            return sol

        s.solve_lanes = converged
        results.append(specint_plexrt(s, atm, 0.2, True, True, lwc=lwc, max_gpt=6,
                                      band_chunk=4))
    for a, b in zip(results[0][:3], results[1][:3]):
        _near(a, b, 5e-5)
    assert float((results[0].abso.cpu() - results[1].abso).abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("scheme,apex", [("5_8", None), ("18_8", (0.5, 0.866)), ("5_5", None)])
def test_cuda_wedge_tracer_matches_cpu(cuda_device, scheme, apex):
    """The wedge photon tracer (`plexrt/wedge_boxmc.py`) on the card against
    the CPU under the same keys: equal draws, so only float32 rounding can
    move a photon (every coefficient within two photons' weight + 1e-5)."""
    from tenstream_tpu_torch.core import prng
    from tenstream_tpu_torch.plexrt.wedge_boxmc import WEDGE_SCHEMES, run_wedge_boxmc

    n = 2000
    entries = np.array([(1.5, 0.9, 0.5, 1.0, 30.0, 40.0), (15.0, 0.99999, 0.85, 0.4, 200.0, 75.0),
                        (0.1, 0.5, 0.0, 2.5, 100.0, 0.0)], np.float32)
    keys = prng.fold_in_keys(prng.Threefry.from_seed(3).words(), torch.arange(len(entries)))
    for ldir in (True, False):
        src = WEDGE_SCHEMES[scheme][1] - 1 if not ldir else 1
        out = [run_wedge_boxmc(keys, src, ldir, *entries.T, n_photons=n, scheme=scheme, apex=apex,
                               device=dev) for dev in (cuda_device, "cpu")]
        for a, b in zip(*out):
            assert (a.cpu() - b).abs().max().item() <= 2.0 / n + 1e-5


@pytest.mark.cuda
def test_cuda_create_wedge_lut_matches_cpu(cuda_device, tmp_path):
    """A wedge table traced on the card equals the CPU's within two photons'
    weight, and loads back from its cache file."""
    from tenstream_tpu_torch.plexrt import optprop as W

    f = lambda *v: np.array(v, np.float32)
    a = W.WedgeAxes(f(0.5, 4.0), f(0.5, 0.99), f(0.5, 1.0), f(0.0, 0.85),
                    np.linspace(0.0, 360.0, 3).astype(np.float32), f(20.0, 60.0))
    luts = [W.load_or_create_wedge_lut(a, n_photons=400, basename=str(tmp_path / d), apex=(0.5, 0.866),
                                       device=d) for d in ("cuda", "cpu")]
    again = W.load_or_create_wedge_lut(a, n_photons=400, basename=str(tmp_path / "cuda"),
                                       apex=(0.5, 0.866), device="cuda")
    for k in ("dir2dir", "dir2diff", "diff2diff"):
        assert (getattr(luts[0], k).cpu() - getattr(luts[1], k)).abs().max().item() <= 2 / 400 + 1e-5
        assert torch.equal(getattr(again, k), getattr(luts[0], k))


def _free_port() -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fish", "icon"])
def test_cuda_wedge_one_rank_nccl_bit_for_bit(cuda_device, kind):
    """A wedge solve decomposed over a one-rank NCCL group (`set_mesh`) is
    the undecomposed solve bit for bit: solar + thermal fields, niter and
    NCA (every halo and ghost exchange a copy, every all-reduce the sum of
    one)."""
    import torch.distributed as dist

    from tenstream_tpu_torch.parallel.mesh import init_distributed, make_mesh
    from tenstream_tpu_torch.plexrt import icon
    from tenstream_tpu_torch.plexrt.mesh import fish_mesh
    from tenstream_tpu_torch.plexrt.solver import PlexrtSolver
    from tenstream_tpu_torch.plexrt.solver_unstructured import PlexrtSolverIcon
    from tenstream_tpu_torch.pprts.sun import sundir_from_angles

    nz, n = 6, 8
    mesh = icon.trimesh_from_structured(n, n, 100.0, 100.0)
    cells = (2, n, n) if kind == "fish" else (mesh.ncell,)
    ka, ks, g, planck = _wedge_scene(nz, cells)
    init_distributed(f"localhost:{_free_port()}", num_processes=1, process_id=0, device="cuda")
    try:
        out = []
        for decomposed in (False, True):
            opp = _wedge_opp(cuda_device)
            s = (PlexrtSolver(fish_mesh(nz, n, n, 100.0, 100.0, 100.0), opp) if kind == "fish"
                 else PlexrtSolverIcon(mesh, np.full(nz, 100.0, np.float32), opp))
            if decomposed:
                s.set_mesh(make_mesh(1, 1))
            s.set_angles(sundir_from_angles(210.0, 35.0))
            s.set_optical_properties(0.2, ka, ks, g, planck=planck)
            sol = s.solve(lthermal=True, lsolar=True, edirTOA=1000.0)
            out.append(([a.cpu() for a in s.get_result(sol)] + [s.nca_absorption(sol).cpu()],
                        sol.niter_diff))
        assert out[0][1] == out[1][1]
        for a, b in zip(out[0][0], out[1][0]):
            assert torch.equal(a, b)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_cuda_capi_demo_is_the_python_solve(cuda_device, tmp_path):
    """The port's C library and `demo_pprts` built with cc, run on the card
    with 3_10 (K1/K2 on its path): its fields are the same solve through the
    Python API bit for bit."""
    import os
    import subprocess

    from tenstream_tpu_torch.capi.build import build
    from tenstream_tpu_torch.optprop.facade import OptProp
    from tenstream_tpu_torch.optprop.lut import load_or_create_lut, mockup_axes
    from tenstream_tpu_torch.pprts.grid import Grid
    from tenstream_tpu_torch.pprts.solver import PprtsSolver
    from tenstream_tpu_torch.pprts.sun import sundir_from_angles

    paths = build()
    out = str(tmp_path / "fields.bin")
    run = subprocess.run([paths["demo_pprts"], "--solver", "3_10", "--out", out],
                         capture_output=True, text=True, timeout=600, env=dict(os.environ))
    assert run.returncode == 0, run.stderr[-3000:]
    n = 8
    raw = np.fromfile(out, np.float32)
    lev = (n + 1) * n * n
    got = [raw[k * lev:(k + 1) * lev] for k in range(3)] + [raw[3 * lev:]]
    lut = load_or_create_lut("3_10", mockup_axes(True), mockup_axes(False), n_photons=2000,
                             device=cuda_device)
    solver = PprtsSolver(Grid.create(n, n, n, 100.0, 100.0, np.full(n, 100.0, np.float32),
                                     device=cuda_device), OptProp(lut, device=cuda_device))
    solver.set_angles(sundir_from_angles(180.0, 40.0))
    ones = np.ones((n, n, n), np.float32)
    solver.set_optical_properties(0.2, 1e-4 * ones, 1e-3 * ones, 0.5 * ones)
    cuda_ops.reset_launch_counts()
    solver.solve(lthermal=False, lsolar=True, edirTOA=1364.0)
    assert cuda_ops.LAUNCHES["fused_A_dots"] > 0
    for a, b in zip(got, solver.get_result()):
        np.testing.assert_array_equal(a, b.reshape(-1).cpu().numpy())


@pytest.mark.cuda
def test_cuda_ecckd_on_the_card_is_the_host(cuda_device):
    """ecCKD's gas optics on the card (the backend `specint_pprts` builds
    from the name "ecckd" for a solver there) give the host's bit for bit
    on a per-column atmosphere: every blend step is one multiply or add."""
    from tenstream_tpu_torch.atm import setup_tenstr_atm, setup_standard_atmosphere
    from tenstream_tpu_torch.spectral.specint import gas_backend

    std = setup_standard_atmosphere(z_grid=np.linspace(20e3, 0.0, 21))
    rng = np.random.default_rng(3)
    shape = (std.nlay + 1, 5, 4)
    plev = np.broadcast_to(std.plev[:, None, None], shape) * (1 + 0.01 * rng.random(shape))
    tlev = np.broadcast_to(std.tlev[:, None, None], shape) + rng.standard_normal(shape)
    atm = setup_tenstr_atm(plev, tlev)
    host, card = gas_backend("ecckd", torch.device("cpu")), gas_backend("ecckd", cuda_device)
    assert card.device.type == "cuda"
    for kind, keys in (("solar", ("tau", "w0", "weight")), ("thermal", ("tau", "planck"))):
        a, b = getattr(host, kind)(atm), getattr(card, kind)(atm)
        for k in keys:
            assert getattr(b, k).device.type == "cuda"
            assert torch.equal(getattr(a, k), getattr(b, k).cpu()), (kind, k)
