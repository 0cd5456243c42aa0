#!/usr/bin/env python3
"""The port's main path and its wedge path decomposed over the cards of one
host (card only).

    torchrun --standalone --nproc_per_node 4 tools/torch_multigpu.py \\
        [--configs replica,strong,weak] [--chunk 8] [--out results.jsonl]
    torchrun --standalone --nproc_per_node 4 tools/torch_multigpu.py \\
        --configs wedge_replica,wedge_strong,wedge_weak,icon_replica,icon

One process per card, an NCCL group, a 2 x 2 `Mesh`.  bench.py's scene
(`chip_smoke.build_bench_atm`: its z grid of 39 layers, its cloud field
from --seed, ecCKD 32 + 32, atm_collapse 16, the f32 warm cache, sun
(120, 40), albedo 0.15) through `specint_pprts`, a cold call and one
perturbed step (the cloud field rolled one cell along x) per
configuration:

  * replica -- every card solves the 256 x 256 scene alone (no mesh): one
               card's columns/s and iterations, taken with all four busy;
  * strong  -- the 256 x 256 scene on 2 x 2 cards (blocks of 128 x 128);
  * weak    -- 1024 x 1024 on 2 x 2 cards (blocks of 512 x 512).

The wedge path (`chip_smoke.py` phases 25-27, `WEDGE_EXACT`, the committed
full-density 5_8 table, sun (120, 40), albedo 0.15):

  * wedge_replica -- phase 26's `specint_plexrt` (ecCKD 32 + 32 in chunks of
               8, bench.py's cloud field on both orientations) on the
               256 x 256 fish mesh, every card alone;
  * wedge_strong  -- the same on 2 x 2 cards (blocks of 128 x 128);
  * wedge_weak    -- a 512 x 512 fish mesh on 2 x 2 cards (blocks of 256 x 256);
  * icon_replica  -- phase 25's band, a solar and a thermal solve, on
               trimesh_from_structured(512, 512) (524,288 cells), every card
               alone;
  * icon          -- the same over 4 ranks (131,072 cells each, ghost-cell
               exchanges).

For each wedge configuration: the wall (the slowest rank), triangle
columns/s and per card, niter (per lane or solve), the peak device memory
of every card, the exchanges and all-reduces per solve, and the NCCL share
of device time over a profiled window (the first solar chunk, or one solar
solve, stopped after 25 diffuse steps).

For each: the wall of each step (the slowest rank), columns/s of the
perturbed step, niter per chunk (strong against the replica's, band for
band), the peak device memory of every card, and, from one more perturbed
step under torch.profiler on every rank, the share of the device's kernel
time spent in NCCL kernels.  A watchdog (`utils/chip.py`'s `Deadline`,
--deadline) and the group's timeout end a rank that waits too long.  A rank that runs out of memory exits with
code 5, which ends the whole group (torchrun), so run the weak case again
with --chunk 4 if it does.  Each configuration prints one JSON line and,
with --out, appends it (with the per-band iterations) to that file.

`--device cpu --n 16` rehearses the same program on the CPU with a gloo
group (replica and strong at 16 x 16, weak at 32 x 32), e.g.
`torchrun --standalone --nproc_per_node 4 tools/torch_multigpu.py --device cpu --n 16`.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

RC_OOM = 5
SIZES = {"replica": 256, "strong": 256, "weak": 1024}
WEDGE_SIZES = {"wedge_replica": 256, "wedge_strong": 256, "wedge_weak": 512,
               "icon_replica": 512, "icon": 512}
PROFILE_STEPS = 25  # diffuse steps of the profiled wedge window
LAYOUT = (2, 2)


def _log(rank, *a):
    if rank == 0:
        print(*a, flush=True)


def _nccl_share(prof) -> float:
    """NCCL kernels' share of the device time of the profiled kernels."""
    total = nccl = 0.0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        if t <= 0:
            continue
        total += t
        if "nccl" in e.key.lower():
            nccl += t
    return nccl / total if total > 0 else float("nan")


def run_config(name, chunk, seed, opp, mesh, rank, smi, dev):
    import chip_smoke as cs
    from tenstream_tpu_torch.core.config import Options
    from tenstream_tpu_torch.pprts.grid import Grid
    from tenstream_tpu_torch.pprts.solver import PprtsSolver
    from tenstream_tpu_torch.pprts.sun import sundir_from_angles
    from tenstream_tpu_torch.spectral.ecckd import EcckdGasOptics
    from tenstream_tpu_torch.spectral.specint import specint_pprts

    n = SIZES[name]
    atm, lwc = cs.build_bench_atm(n, n, seed)
    cuda = dev == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    use_mesh = name != "replica"
    solver = PprtsSolver(Grid.create(atm.nlay, n, n, 100.0, 100.0, atm.dz.astype(np.float32),
                                     device=dev), opp,
                         options=Options({"specint_cache": "f32",
                                          "atm_collapse": cs.K_COLLAPSE}, read_env=False))
    solver.set_angles(sundir_from_angles(*cs.SPECTRAL_SUN))
    if use_mesh:
        solver.set_mesh(mesh)
    gas = EcckdGasOptics(n_gpt=cs.NGPT)

    def block(a):
        if not use_mesh:
            return a
        sx, sy = mesh.block(n, n)
        return np.ascontiguousarray(a[:, sx, sy])

    def step(field):
        sync()
        dist.barrier()
        t0 = time.perf_counter()
        res = specint_pprts(solver, atm, albedo=0.15, lthermal=True, lsolar=True, specint=gas,
                            lwc=block(field), band_chunk=chunk)
        sync()
        wall = time.perf_counter() - t0
        for a in res:
            if a is not None and not bool(torch.isfinite(a).all()):
                raise AssertionError(f"{name}: non-finite result")
        return res, wall

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    out = {"config": name, "n": n, "chunk": chunk, "layout": list(LAYOUT) if use_mesh else [1, 1],
           "card": smi}
    try:
        _, cold = step(lwc)
        pert_field = np.roll(lwc, 1, axis=1)
        _, pert = step(pert_field)
        solver.check_convergence()
    except torch.cuda.OutOfMemoryError:
        print(f"rank {rank}: {name} at chunks of {chunk} ran out of device memory "
              f"({torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB peak)", flush=True)
        sys.stdout.flush()
        os._exit(RC_OOM)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else float("nan")
    iters = {}
    for tag, rows in solver._band_rows.items():
        for gid, (key, row) in rows.items():
            iters[f"{tag}{gid}"] = int(solver.solutions[key].niter_diff[row])
    acts = [torch.profiler.ProfilerActivity.CPU] + (
        [torch.profiler.ProfilerActivity.CUDA] if cuda else [])
    with torch.profiler.profile(activities=acts) as prof:
        step(np.roll(pert_field, 1, axis=2))
    share = _nccl_share(prof) if cuda else float("nan")
    walls = torch.tensor([cold, pert, peak, share], dtype=torch.float64, device=dev)
    gathered = [torch.zeros_like(walls) for _ in range(dist.get_world_size())]
    dist.all_gather(gathered, walls)
    g = torch.stack(gathered).cpu().numpy()
    cols = n * n * (1 if use_mesh else dist.get_world_size())
    out.update(cold_s=float(g[:, 0].max()), perturbed_s=float(g[:, 1].max()),
               columns_per_s=cols / float(g[:, 1].max()),
               columns_per_s_per_card=cols / float(g[:, 1].max()) / dist.get_world_size(),
               peak_gib_per_card=[float(v) for v in g[:, 2]],
               nccl_share_of_device_time=[float(v) for v in g[:, 3]],
               niter=iters, niter_sum=int(sum(iters.values())),
               niter_max=int(max(iters.values())))
    return out


def run_wedge_config(name, seed, wopp, mesh, rank, smi, dev):
    """One wedge configuration (see the module docstring)."""
    import chip_smoke as cs
    from tenstream_tpu_torch.parallel.mesh import shard_fields
    from tenstream_tpu_torch.plexrt import icon
    from tenstream_tpu_torch.plexrt.mesh import fish_mesh
    from tenstream_tpu_torch.plexrt.solver import PlexrtSolver
    from tenstream_tpu_torch.plexrt.solver_unstructured import PlexrtSolverIcon
    from tenstream_tpu_torch.pprts.sun import sundir_from_angles
    from tenstream_tpu_torch.spectral.ecckd import EcckdGasOptics
    from tenstream_tpu_torch.spectral.specint_plexrt import specint_plexrt

    n = WEDGE_SIZES[name]
    cuda = dev == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    pmesh = None if name.endswith("replica") else mesh
    sun = sundir_from_angles(*cs.SPECTRAL_SUN)
    spectral = name.startswith("wedge")
    if spectral:
        atm, lwc = cs.build_bench_atm(n, n, seed)
        (lwc2,) = ((cs.both_orientations(lwc),) if pmesh is None else
                   shard_fields(pmesh, cs.both_orientations(lwc)))
        gas = EcckdGasOptics(n_gpt=cs.NGPT)
        make = lambda **kw: PlexrtSolver(fish_mesh(atm.nlay, n, n, 100.0, 100.0,
                                                   atm.dz.astype(np.float32)), wopp,
                                         **{**cs.WEDGE_EXACT, **kw})
        columns = 2 * n * n
    else:
        tri = icon.trimesh_from_structured(n, n, 100.0, 100.0)
        dz, fields, planck = cs.wedge_scene(n, seed)
        cells = tuple(cs.icon_cells(a) for a in fields + (planck,))
        blocks = cells if pmesh is None else shard_fields(pmesh, *cells, cell_axis=-1)
        make = lambda **kw: PlexrtSolverIcon(tri, dz, wopp, **{**cs.WEDGE_EXACT, **kw})
        columns = tri.ncell

    def solver_for(**kw):
        s = make(**kw)
        s.set_angles(sun)
        if pmesh is not None:
            s.set_mesh(pmesh)
        return s

    def run(s, solar_only=False):
        """The configuration's work: (niter per solve, solves)."""
        niters, lanes = [], s.solve_lanes

        def seen(*a, **k):
            sol = lanes(*a, **k)
            niters.extend(sol.niter_diff.tolist())
            if not bool((sol.diff_res <= sol.diff_tol).all()) and s.diff_iters > PROFILE_STEPS:
                raise AssertionError(f"{name}: a lane stopped above its tolerance")
            return sol

        s.solve_lanes = seen
        try:
            if spectral:
                res = specint_plexrt(s, atm, cs.WEDGE_ALBEDO, not solar_only, True, specint=gas,
                                     lwc=lwc2, band_chunk=cs.WEDGE_CHUNK,
                                     max_gpt=cs.WEDGE_CHUNK if solar_only else None)
                fields_out = list(res)
            else:
                s.set_optical_properties(cs.WEDGE_ALBEDO, *blocks[:3])
                fields_out = list(s.get_result(s.solve(lthermal=False, lsolar=True,
                                                       edirTOA=1000.0)))
                if not solar_only:
                    s.set_optical_properties(cs.WEDGE_ALBEDO, *blocks[:3], planck=blocks[3])
                    fields_out += list(s.get_result(s.solve(lthermal=True, lsolar=False)))[1:]
        finally:
            del s.solve_lanes
        for a in fields_out:
            if a is not None and not bool(torch.isfinite(a).all()):
                raise AssertionError(f"{name}: non-finite result")
        return niters

    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    out = {"config": name, "n": n, "triangle_columns": columns,
           "layout": [1, 1] if pmesh is None else list(LAYOUT), "card": smi}
    solver = solver_for()
    if pmesh is not None:
        pmesh.reset_stats()
    sync()
    dist.barrier()
    t0 = time.perf_counter()
    niters = run(solver)
    sync()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else float("nan")
    if pmesh is not None:
        out.update({f"{k}_per_solve": pmesh.stats[k] / max(1, len(niters) if not spectral else
                                                                 -(-len(niters) // cs.WEDGE_CHUNK))
                    for k in ("exchanges", "reductions")})
    del solver
    acts = [torch.profiler.ProfilerActivity.CPU] + (
        [torch.profiler.ProfilerActivity.CUDA] if cuda else [])
    solver = solver_for(diff_iters=PROFILE_STEPS)
    with torch.profiler.profile(activities=acts) as prof:
        run(solver, solar_only=True)
        sync()
    share = _nccl_share(prof) if cuda and pmesh is not None else float("nan")
    del solver
    vals = torch.tensor([wall, peak, share], dtype=torch.float64, device=dev)
    gathered = [torch.zeros_like(vals) for _ in range(dist.get_world_size())]
    dist.all_gather(gathered, vals)
    g = torch.stack(gathered).cpu().numpy()
    total = columns * (1 if pmesh is not None else dist.get_world_size())
    slowest = float(g[:, 0].max())
    out.update(wall_s=slowest, walls_s=[float(v) for v in g[:, 0]],
               triangle_columns_per_s=total / slowest,
               triangle_columns_per_s_per_card=total / slowest / dist.get_world_size(),
               peak_gib_per_card=[float(v) for v in g[:, 1]],
               nccl_share_of_device_time=[float(v) for v in g[:, 2]],
               niter=niters, niter_sum=int(sum(niters)), niter_max=int(max(niters)))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--configs", default="replica,strong,weak")
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", default=None, help="JSON lines file to append the results to")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--n", type=int, default=256, help="replica and strong size (weak: 4x)")
    ap.add_argument("--deadline", type=float, default=1500.0,
                    help="[s] before the watchdog exits")
    args = ap.parse_args()
    dev = args.device
    if dev == "cuda" and not torch.cuda.is_available():
        print("torch_multigpu: needs CUDA cards", file=sys.stderr)
        sys.exit(2)
    SIZES.update(replica=args.n, strong=args.n, weak=4 * args.n)
    WEDGE_SIZES.update(wedge_replica=args.n, wedge_strong=args.n, wedge_weak=2 * args.n,
                       icon_replica=2 * args.n, icon=2 * args.n)

    from tenstream_tpu_torch.optprop.facade import OptProp
    from tenstream_tpu_torch.optprop.lut import LUT
    from tenstream_tpu_torch.parallel.mesh import make_mesh
    from tenstream_tpu_torch.pprts import cuda_ops
    from tenstream_tpu_torch.utils.chip import Deadline

    Deadline(args.deadline).start()
    rank = int(os.environ["RANK"])
    if dev == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    else:
        torch.set_num_threads(1)
    dist.init_process_group("nccl" if dev == "cuda" else "gloo",
                            timeout=datetime.timedelta(seconds=240))
    world = dist.get_world_size()
    if world != LAYOUT[0] * LAYOUT[1]:
        raise SystemExit(f"run with {LAYOUT[0] * LAYOUT[1]} processes, not {world}")
    mesh = make_mesh(*LAYOUT)
    smi = "cpu"
    t0 = time.perf_counter()
    if dev == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip().splitlines()
        smi = smi[int(os.environ.get("LOCAL_RANK", rank)) % len(smi)]
        # rank 0 builds the kernels; the others load its build (the wedge path runs none)
        if any(c in SIZES for c in args.configs.split(",")):
            if rank == 0:
                cuda_ops.load_extension()
            dist.barrier()
            if rank != 0:
                cuda_ops.load_extension()
    _log(rank, f"torch_multigpu: {world} x {smi}; {mesh}; kernels ready in "
         f"{time.perf_counter() - t0:.1f} s")
    configs = args.configs.split(",")
    if any(c in SIZES for c in configs):
        opp = OptProp(LUT.load(os.path.join(REPO, "data", "luts", "LUT_3_10_production.npz"),
                               device=dev), device=dev)
    if any(c in WEDGE_SIZES for c in configs):
        import chip_smoke as cs

        wopp = cs.wedge_opp(dev)[0]
    results = {}
    for name in configs:
        if name in WEDGE_SIZES:
            r = run_wedge_config(name, args.seed, wopp, mesh, rank, smi, dev)
        else:
            r = run_config(name, args.chunk, args.seed, opp, mesh, rank, smi, dev)
        results[name] = r
        for base in ("wedge", "icon"):
            rep = results.get(f"{base}_replica")
            if rep is not None and name.startswith(base) and name != f"{base}_replica":
                r["per_card_vs_one_card"] = (r["triangle_columns_per_s_per_card"]
                                             / rep["triangle_columns_per_s_per_card"])
                r["niter_vs_one_card"] = dict(
                    sum=[r["niter_sum"], rep["niter_sum"]],
                    max_abs_diff=(max(abs(a - b) for a, b in zip(r["niter"], rep["niter"]))
                                  if r["n"] == rep["n"] else None))
        if name == "strong" and "replica" in results:
            rep = results["replica"]["niter"]
            diff = {b: (r["niter"][b], rep[b]) for b in r["niter"] if r["niter"][b] != rep.get(b)}
            r["niter_vs_replica"] = dict(bands=len(r["niter"]), equal=len(r["niter"]) - len(diff),
                                         max_abs_diff=max([abs(a - b) for a, b in diff.values()],
                                                          default=0))
        if name == "weak" and "replica" in results:
            r["weak_efficiency"] = (r["columns_per_s_per_card"]
                                    / results["replica"]["columns_per_s_per_card"])
        if name == "strong" and "replica" in results:
            r["strong_speedup"] = (r["columns_per_s"]
                                   / results["replica"]["columns_per_s_per_card"])
        line = {k: v for k, v in r.items() if k != "niter"}
        _log(rank, json.dumps(line))
        if rank == 0 and args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(r) + "\n")
        if dev == "cuda":
            torch.cuda.empty_cache()
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
