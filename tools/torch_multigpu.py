#!/usr/bin/env python3
"""The port's main path decomposed over the cards of one host (card only).

    torchrun --standalone --nproc_per_node 4 tools/torch_multigpu.py \\
        [--configs replica,strong,weak] [--chunk 8] [--out results.jsonl]

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
        # rank 0 builds the kernels; the others load its build
        if rank == 0:
            cuda_ops.load_extension()
        dist.barrier()
        if rank != 0:
            cuda_ops.load_extension()
    _log(rank, f"torch_multigpu: {world} x {smi}; {mesh}; kernels ready in "
         f"{time.perf_counter() - t0:.1f} s")
    opp = OptProp(LUT.load(os.path.join(REPO, "data", "luts", "LUT_3_10_production.npz"),
                           device=dev), device=dev)
    results = {}
    for name in args.configs.split(","):
        r = run_config(name, args.chunk, args.seed, opp, mesh, rank, smi, dev)
        results[name] = r
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
        torch.cuda.empty_cache()
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
