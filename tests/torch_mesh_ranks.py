"""Ranks of a gloo process group on the CPU for the decomposed port
(`tenstream_tpu_torch.parallel`): `run_ranks` starts one process per rank
on this file, each rank runs one task of `TASKS` on its block and writes
its arrays to an npz, and the caller reassembles them (`assemble`).

The ranks import torch and numpy only, never JAX, so they start in a few
seconds; the JAX references run in the test process.  Every run has a
timeout: collectives called in a different order on two ranks hang rather
than fail, and a hang must fail the test, not the whole run.

    python tests/torch_mesh_ranks.py TASK RANK NXPROC NYPROC PORT INPUTS OUTDIR
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
RANK_TIMEOUT = 240.0  # [s] for the whole group of one run


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(task: str, layout, inputs: dict, tmp_path, timeout: float = RANK_TIMEOUT):
    """Run `task` on an nxproc x nyproc gloo group; returns each rank's
    output dict, in rank order."""
    nxp, nyp = layout
    world = nxp * nyp
    tmp = str(tmp_path)
    inp = os.path.join(tmp, f"{task}_{nxp}x{nyp}_in.npz")
    out = os.path.join(tmp, f"{task}_{nxp}x{nyp}_out")
    os.makedirs(out, exist_ok=True)
    np.savez(inp, **inputs)
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
    for attempt in range(2):  # a port taken between choosing and binding it: once more
        port = _free_port()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), task, str(r), str(nxp), str(nyp),
             str(port), inp, out], env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]
        deadline = time.monotonic() + timeout
        logs = [""] * world
        hung = False
        for r, p in enumerate(procs):
            try:
                logs[r] = p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0]
            except subprocess.TimeoutExpired:
                hung = True
                break
        if hung:
            for p in procs:
                p.kill()
            for r, p in enumerate(procs):
                logs[r] = logs[r] or (p.communicate()[0] or "")
            raise AssertionError(f"{task} on {nxp}x{nyp} did not finish in {timeout:.0f} s "
                                 "(a collective called in another order on some rank?):\n"
                                 + "\n".join(f"--- rank {r}\n{lg[-3000:]}"
                                             for r, lg in enumerate(logs)))
        codes = [p.returncode for p in procs]
        if all(c == 0 for c in codes):
            return [dict(np.load(os.path.join(out, f"rank{r}.npz"))) for r in range(world)]
        if attempt == 0 and any("EADDRINUSE" in lg or "address already in use" in lg.lower()
                                for lg in logs):
            continue
        raise AssertionError(f"{task} on {nxp}x{nyp}: exit codes {codes}:\n"
                             + "\n".join(f"--- rank {r}\n{lg[-4000:]}"
                                         for r, lg in enumerate(logs)))


def assemble(blocks, layout) -> np.ndarray:
    """The global array from the ranks' blocks (last two dims x, y)."""
    nxp, nyp = layout
    rows = [np.concatenate(blocks[px * nyp:(px + 1) * nyp], axis=-1) for px in range(nxp)]
    return np.concatenate(rows, axis=-2)


def blocks_of(a: np.ndarray, layout):
    """The ranks' blocks of a global array, in rank order."""
    nxp, nyp = layout
    bx, by = a.shape[-2] // nxp, a.shape[-1] // nyp
    return [a[..., px * bx:(px + 1) * bx, py * by:(py + 1) * by]
            for px in range(nxp) for py in range(nyp)]


# ---------------------------------------------------------------------------
# the ranks' side: torch and numpy only
# ---------------------------------------------------------------------------

def _t(a):
    import torch

    return torch.as_tensor(np.ascontiguousarray(a))


def _np(t):
    return t.detach().cpu().numpy()


def task_ops(mesh, inp):
    """The halo primitives and the three kernels' plain versions in halo
    mode on this rank's block."""
    from tenstream_tpu_torch.optprop.facade import diff_pair_orbits
    from tenstream_tpu_torch.pprts import cuda_ops
    from tenstream_tpu_torch.streams import get_scheme

    sx, sy = mesh.block(*inp["f"].shape[-2:])
    blk = lambda a: _t(a[..., sx, sy])
    f = blk(inp["f"])
    out = dict(roll_xp=mesh.roll(f, 1, -2), roll_xm=mesh.roll(f, -1, -2),
               roll_yp=mesh.roll(f, 1, -1), roll_ym=mesh.roll(f, -1, -1), pad=mesh.pad(f),
               flip_x=mesh.flip(f, -2), flip_y=mesh.flip(f, -1),
               gathered=mesh.all_gather_blocks(f))
    scheme = get_scheme(str(inp["scheme"]))
    idx, _ = diff_pair_orbits(scheme, with_mz=False)
    idx = np.asarray(idx, np.int64)
    u, w, orb, alb = (blk(inp[k]) for k in ("u", "w", "orb", "alb"))
    Au, dots = cuda_ops.fused_A_dots_plain(scheme, idx, mesh.pad(orb), mesh.pad(u), w, alb,
                                           halo=True)
    out.update(Au=Au, dots=mesh.all_reduce(dots), dots_local=dots)
    out["S_orbit"] = cuda_ops.diffuse_apply_orbit(scheme, idx, orb, u, alb[0], mesh)
    out["S_dense"] = cuda_ops.diffuse_apply_dense_mesh(scheme, blk(inp["c"]), u, mesh)
    return {k: _np(v) for k, v in out.items()}


def task_edir(mesh, inp):
    """`solve_edir_sharded` for each sun octant on this rank's block."""
    from tenstream_tpu_torch.pprts.edir import solve_edir_sharded
    from tenstream_tpu_torch.streams import get_scheme

    sx, sy = mesh.block(*inp["dir2dir"].shape[-2:])
    c, inc = _t(inp["dir2dir"][..., sx, sy]), _t(inp["inc"][..., sx, sy])
    scheme = get_scheme(str(inp["scheme"]))
    out = {}
    for xinc in (0, 1):
        for yinc in (0, 1):
            out[f"edir_{xinc}{yinc}"] = _np(solve_edir_sharded(
                scheme, c, inc, xinc, yinc, mesh, n_inner=int(inp["n_inner"]), aitken=True,
                cleanup=True))
    return out


def _solver(mesh, inp, opts=None):
    from tenstream_tpu_torch.core.config import Options
    from tenstream_tpu_torch.optprop.facade import OptProp
    from tenstream_tpu_torch.optprop.lut import LUT
    from tenstream_tpu_torch.pprts.grid import Grid
    from tenstream_tpu_torch.pprts.solver import PprtsSolver

    nz, nx, ny = (int(v) for v in inp["shape"])
    grid = Grid.create(nz, nx, ny, float(inp["dx"]), float(inp["dx"]),
                       _t(inp["dz"]) if "dz" in inp else float(inp["dx"]), device="cpu")
    opp = OptProp(LUT.load(str(inp["lut"]), device="cpu"), device="cpu")
    solver = PprtsSolver(grid, opp, options=Options(opts or {}, read_env=False))
    solver.set_mesh(mesh)
    return solver


def _result(solver, uid=0):
    edir, edn, eup, abso = solver.get_result(uid)
    out = dict(edn=_np(edn), eup=_np(eup), abso=_np(abso))
    if edir is not None:
        out["edir"] = _np(edir)
    return out


def task_solve(mesh, inp):
    """A solar+thermal single-band solve on this rank's block, with the
    per-lane iteration counts."""
    from tenstream_tpu_torch.parallel.mesh import gather_to_host, shard_fields
    from tenstream_tpu_torch.pprts.sun import sundir_from_angles

    opts = {"diff_precond": str(inp["precond"])} if "precond" in inp else None
    solver = _solver(mesh, inp, opts)
    ka, ks, g, planck = shard_fields(mesh, inp["ka"], inp["ks"], inp["g"], inp["planck"])
    solver.set_optical_properties(float(inp["albedo"]), ka, ks, g, planck=planck)
    solver.set_angles(sundir_from_angles(*(float(v) for v in inp["sun"])))
    sol = solver.solve(lthermal=True, lsolar=True, edirTOA=float(inp["toa"]))
    out = _result(solver)
    out["niter"] = np.asarray([sol.niter_diff, sol.thermal.niter_diff])
    out["edn_global"] = gather_to_host(solver.get_result()[1], mesh)
    return out


def task_buildings(mesh, inp):
    """A solar+thermal solve with buildings (dense coefficients: K3's halo
    mode) on this rank's block, with the face fluxes."""
    from tenstream_tpu_torch.parallel.mesh import shard_fields
    from tenstream_tpu_torch.pprts.buildings import Buildings
    from tenstream_tpu_torch.pprts.sun import sundir_from_angles

    solver = _solver(mesh, inp)
    ka, ks, g, planck, solid, bpl = shard_fields(mesh, inp["ka"], inp["ks"], inp["g"],
                                                inp["planck"], inp["solid"], inp["bplanck"])
    solver.set_buildings(Buildings(solid=solid, albedo=float(inp["balbedo"]), planck=bpl))
    solver.set_optical_properties(float(inp["albedo"]), ka, ks, g, planck=planck)
    solver.set_angles(sundir_from_angles(*(float(v) for v in inp["sun"])))
    sol = solver.solve(lthermal=True, lsolar=True, edirTOA=float(inp["toa"]))
    out = _result(solver)
    out["niter"] = np.asarray([sol.niter_diff, sol.thermal.niter_diff])
    for kind, d in solver.get_building_fluxes().items():
        out[f"bf_{kind}"] = _np(d["incoming"])
    return out


def task_specint(mesh, inp):
    """`specint_pprts` (ecCKD, McICA) on this rank's block, the chunks'
    iteration counts and this block's McICA masks."""
    from tenstream_tpu_torch.atm import setup_standard_atmosphere
    from tenstream_tpu_torch.core.prng import Threefry
    from tenstream_tpu_torch.parallel.mesh import shard_fields
    from tenstream_tpu_torch.pprts.sun import sundir_from_angles
    from tenstream_tpu_torch.spectral.ecckd import EcckdGasOptics
    from tenstream_tpu_torch.spectral.mcica import mcica_subcolumns
    from tenstream_tpu_torch.spectral.specint import specint_pprts

    opts = {"atm_collapse": int(inp["collapse"]), "specint_cache": "f32"}
    solver = _solver(mesh, inp, opts)
    solver.set_angles(sundir_from_angles(*(float(v) for v in inp["sun"])))
    atm = setup_standard_atmosphere(z_grid=inp["zlev"])
    lwc, cfrac = shard_fields(mesh, inp["lwc"], inp["cfrac"])
    sx, sy = mesh.block(*inp["lwc"].shape[-2:])
    block = ((sx, sy), tuple(inp["lwc"].shape[-2:]))
    masks = mcica_subcolumns(Threefry.from_seed(712).fold_in(0), cfrac, int(inp["ngpt"]),
                             block=block)
    out = {"masks": _np(masks)}
    for step in range(2):
        res = specint_pprts(solver, atm, albedo=0.15, lthermal=True, lsolar=True,
                            specint=EcckdGasOptics(n_gpt=int(inp["ngpt"])), lwc=lwc,
                            cld_frac=cfrac, band_chunk=int(inp["chunk"]))
        for k in ("edir", "edn", "eup", "abso"):
            out[f"{k}{step}"] = _np(getattr(res, k))
        lwc = lwc * 1.05
    out["niters"] = np.asarray([n for key in sorted(solver.solutions, key=repr)
                                for n in (solver.solutions[key].niter_diff
                                          if isinstance(solver.solutions[key].niter_diff, list)
                                          else [solver.solutions[key].niter_diff])])
    return out


def task_scatter(mesh, inp):
    """`scatter_global` with a callable that records what it is asked for,
    and `gather_to_host` of the blocks."""
    from tenstream_tpu_torch.parallel.mesh import gather_to_host, scatter_global

    full = inp["full"]
    asked = []

    def cb(index):
        asked.append([(s.start, s.stop) for s in index])
        return full[index]

    blk = scatter_global(mesh, cb, global_shape=full.shape, dtype=np.float32)
    blk2 = scatter_global(mesh, full)
    starts = np.asarray([[a if a is not None else -1 for se in q for a in se] for q in asked])
    return dict(block=_np(blk), block_from_array=_np(blk2), asked=starts,
                gathered=gather_to_host(blk, mesh))


def _wedge_run(solver, fields, planck, inp, outp, out):
    """A solar solve, then a thermal one with NCA, of `solver` on this
    rank's `fields`; writes its results, niter and exchanges under
    `outp`."""
    from tenstream_tpu_torch.parallel.mesh import gather_to_host

    pm = solver._pmesh
    solver.set_angles(np.asarray(inp["sundir"]))
    solver.set_optical_properties(float(inp["albedo"]), *fields)
    pm.reset_stats()
    sol = solver.solve(lthermal=False, lsolar=True, edirTOA=float(inp["toa"]))
    out[outp + "stats"] = np.asarray([pm.stats[k] for k in ("exchanges", "messages",
                                                           "reductions")])
    for k, a in zip(("edir", "edn", "eup", "abso"), solver.get_result(sol)):
        out[outp + k] = _np(a)
    solver.set_optical_properties(float(inp["albedo"]), *fields, planck=planck)
    sol_t = solver.solve(lthermal=True, lsolar=False)
    out[outp + "thermal_eup"] = _np(solver.get_result(sol_t)[2])
    out[outp + "nca"] = _np(solver.nca_absorption(sol_t))
    out[outp + "niter"] = np.asarray([sol.niter_diff, sol_t.niter_diff])
    # the global field on every rank
    cell_axis = None if hasattr(solver, "grid") else -1
    out[outp + "edn_global"] = gather_to_host(solver.get_result(sol)[1], pm, cell_axis=cell_axis)


def task_wedge(mesh, inp):
    """The wedge solvers on this rank's part: the fish solver (BiCGStab and
    the fixed point) on its (x, y) block, the ICON solver on its range of
    cells, each solar then thermal with NCA, and `specint_plexrt` on
    both where the inputs hold an atmosphere; the ghost exchange of a
    distorted mesh's field."""
    from tenstream_tpu_torch.parallel.mesh import GhostExchange, scatter_global, shard_fields
    from tenstream_tpu_torch.plexrt import icon
    from tenstream_tpu_torch.plexrt.mesh import fish_mesh
    from tenstream_tpu_torch.plexrt.optprop import WedgeOptProp, load_or_create_wedge_lut
    from tenstream_tpu_torch.plexrt.solver import PlexrtSolver
    from tenstream_tpu_torch.plexrt.solver_unstructured import PlexrtSolverIcon

    opp = WedgeOptProp(load_or_create_wedge_lut(n_photons=1500, basename=str(inp["lutdir"]),
                                                device="cpu"))
    nz, n = (int(v) for v in inp["fish_shape"])
    out = {}
    fish = shard_fields(mesh, *(inp["fish_" + k] for k in ("ka", "ks", "g", "planck")))
    for ds in ("bicgstab", "fixedpoint"):
        solver = PlexrtSolver(fish_mesh(nz, n, n, 100.0, 100.0, 100.0), opp, diff_solver=ds)
        solver.set_mesh(mesh)
        _wedge_run(solver, fish[:3], fish[3], inp, f"fish_{ds}_", out)
    m = icon.trimesh_from_structured(*(int(v) for v in inp["icon_n"]), 100.0, 100.0)
    ic = shard_fields(mesh, *(inp["icon_" + k] for k in ("ka", "ks", "g", "planck")),
                      cell_axis=-1)
    solver = PlexrtSolverIcon(m, inp["icon_dz"], opp)
    solver.set_mesh(mesh)
    _wedge_run(solver, ic[:3], ic[3], inp, "icon_", out)
    asked = []

    def reader(index):  # a host model's reader: asked for this rank's cells only
        asked.append([(s.start, s.stop) for s in index])
        return inp["icon_ka"][index]

    blk = scatter_global(mesh, reader, global_shape=inp["icon_ka"].shape, dtype=np.float32,
                         cell_axis=-1)
    out["icon_scatter"] = _np(blk)
    out["icon_scatter_asked"] = np.asarray([-1 if v is None else v for v in asked[0][-1]])

    d = icon.trimesh_from_points(inp["dist_verts"], inp["dist_tris"])
    ex = GhostExchange(mesh, d.exchange_index(), d.nbr >= 0, 3, "cpu")
    (fld,) = shard_fields(mesh, inp["dist_field"], cell_axis=-2)  # (2, nc, 3)
    got = ex.gather(fld.reshape(fld.shape[0], -1))
    lo, hi = mesh.cell_range(d.ncell)
    out["dist_gather"] = _np(got * _t(d.exchange_mask()[lo:hi]))
    out["dist_ghosts"] = np.asarray([ex.n_ghosts])

    if "zlev" in inp:
        from tenstream_tpu_torch.atm import setup_standard_atmosphere
        from tenstream_tpu_torch.spectral.ecckd import EcckdGasOptics
        from tenstream_tpu_torch.spectral.specint_plexrt import specint_plexrt

        atm = setup_standard_atmosphere(z_grid=inp["zlev"])
        dz = np.asarray(atm.dz, np.float32)
        n = inp["spec_lwc"].shape[-1]
        for which in ("fish", "icon"):
            if which == "fish":
                solver = PlexrtSolver(fish_mesh(atm.nlay, n, n, 500.0, 500.0, dz), opp)
                (lwc,) = shard_fields(mesh, inp["spec_lwc"])
            else:
                solver = PlexrtSolverIcon(icon.trimesh_from_structured(n, n, 500.0, 500.0), dz,
                                          opp)
                (lwc,) = shard_fields(mesh, inp["spec_lwc_icon"], cell_axis=-1)
            solver.set_mesh(mesh)
            solver.set_angles(np.asarray(inp["sundir"]))
            lanes, seen = solver.solve_lanes, []

            def lanes_seen(*a, **k):
                sol = lanes(*a, **k)
                seen.extend(sol.niter_diff.tolist())
                return sol

            solver.solve_lanes = lanes_seen
            res = specint_plexrt(solver, atm, 0.2, True, True, specint=EcckdGasOptics(n_gpt=32),
                                 lwc=lwc, max_gpt=int(inp["max_gpt"]),
                                 band_chunk=int(inp["max_gpt"]))
            for k in ("edir", "edn", "eup", "abso"):
                out[f"spec_{which}_{k}"] = _np(getattr(res, k))
            out[f"spec_{which}_niter"] = np.asarray(seen)
    return out


TASKS = dict(ops=task_ops, edir=task_edir, solve=task_solve, buildings=task_buildings,
             specint=task_specint, scatter=task_scatter, wedge=task_wedge)


def main(argv):
    import torch
    import torch.distributed as dist

    from tenstream_tpu_torch.parallel.mesh import init_distributed, make_mesh

    task, rank, nxp, nyp, port, inp_path, out_dir = argv
    rank, nxp, nyp = int(rank), int(nxp), int(nyp)
    torch.set_num_threads(1)
    init_distributed(f"localhost:{port}", num_processes=nxp * nyp, process_id=rank,
                     device="cpu")
    mesh = make_mesh(nxp, nyp)
    inp = dict(np.load(inp_path, allow_pickle=False))
    out = TASKS[task](mesh, inp)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
