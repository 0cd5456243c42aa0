#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`tenstream_tpu_torch`) once on an NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printing its lines; any failure raises (non-zero exit):

  1. device   -- requires CUDA; prints the card's name and power limit.
  2. build    -- builds the diffuse-solve kernels (csrc/) and times it.
  3. kernels  -- K1 fused_A_dots and K2 orbit_contract against their plain
                 PyTorch versions on the card, at the main path's shapes and
                 at an odd batched shape; times both versions.
  4. main     -- the 3_10 PprtsSolver on a 100 m LES column (bench.py's
                 vertical structure, nz = 39) at 256 x 256 columns with the
                 production LUT: a cold solar+thermal solve, then a warm
                 re-solve of the cloud field rolled by one cell.  Checks
                 finite results, res <= 1.5 tol, and that both kernels ran.
  5. parity   -- the same scene at 64 x 64 through the kernels and through
                 the plain versions on the card: fluxes within 0.1 W/m2,
                 absorption within 1e-4 W/m3.
  6. profile  -- the warm re-solve again: host time per solver stage, then
                 under torch.profiler the device busy share and the kernels
                 with the most device time.

The line before the last is a JSON object describing each kernel; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
LUT_PATH = os.path.join(REPO, "data", "luts", "LUT_3_10_production.npz")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores, published
FIELD_ATOL = 5e-6  # O(1) random fields: sums of <= 24 float32 products
DOT_RTOL = 2e-5  # dots over up to 2.6e7 terms, block partials vs torch's sum
FLUX_ATOL = 0.1  # W/m2, the golden regression gate
ABSO_ATOL = 1e-4  # W/m3
NX = NY = 256  # BASELINE.md's LES width: the main path's columns
NZ = 39  # bench.py's vertical structure
KERNELS = {
    "fused_A_dots": ("K1", "tenstream_tpu/pprts/pallas_ops.py:264"),
    "orbit_contract": ("K2", "tenstream_tpu/pprts/pallas_ops.py:100"),
}


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, n: int) -> float:
    """Mean device time per call of fn over n calls (after 3 warm-ups)."""
    for _ in range(3):
        fn()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


# ---------------------------------------------------------------------------
# scene
# ---------------------------------------------------------------------------

def build_scene(nx: int, ny: int, seed: int):
    """bench.py's column (100 m layers below 2.3 km, geometric layers to
    20 km, nz = 39), a clear-sky background and boundary-layer cloud blocks
    placed as bench.py places them (ksca 1e-2..5e-2 /m, g = 0.85)."""
    z_low = np.arange(0.0, 24 * 100.0 + 1.0, 100.0)
    z_high = np.geomspace(24 * 100.0 + 250.0, 20e3, 16)
    zlev = np.concatenate([z_high[::-1], z_low[::-1][1:]])  # TOA -> surface
    dz = (zlev[:-1] - zlev[1:]).astype(np.float32)
    nz = dz.size
    zc = zlev[:-1]  # layer tops
    zmid = 0.5 * (zlev[:-1] + zlev[1:])
    rng = np.random.default_rng(seed)
    rho = np.exp(-zmid / 8e3)[:, None, None]
    kabs = np.broadcast_to(2e-6 * rho, (nz, nx, ny)).astype(np.float32).copy()
    ksca = np.broadcast_to(1.2e-5 * rho, (nz, nx, ny)).astype(np.float32).copy()
    g = np.zeros((nz, nx, ny), np.float32)
    lwc = np.zeros((nz, nx, ny), np.float32)
    cloudy = np.where((zc > 600.0) & (zc < 2000.0))[0]
    for _ in range(nx * ny // 16):
        i, j = rng.integers(0, nx), rng.integers(0, ny)
        k = rng.choice(cloudy)
        di, dj = rng.integers(1, 4), rng.integers(1, 4)
        lwc[k:k + 2, i:i + di, j:j + dj] = rng.uniform(0.1, 0.6)
    cloud = lwc > 0
    kc = 1e-2 + (lwc - 0.1) / 0.5 * 4e-2
    ksca = np.where(cloud, kc, ksca).astype(np.float32)
    kabs = np.where(cloud, 0.05 * kc, kabs).astype(np.float32)
    g = np.where(cloud, 0.85, g).astype(np.float32)
    # broadband Planck radiance sigma T^4 / pi of a standard lapse-rate profile
    T = np.maximum(288.15 - 6.5e-3 * zlev, 216.65)
    planck = (5.670374419e-8 * T ** 4 / np.pi).astype(np.float32)[:, None, None] * np.ones(
        (nx, ny), np.float32)
    return dz, kabs, ksca, g, planck


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        sys.exit(2)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"{torch.cuda.device_count()} card(s)")
    return name, smi


def phase_build(cuda_ops):
    t0 = time.time()
    cuda_ops.load_extension()
    log(f"build: kernels built and loaded in {time.time() - t0:.1f} s")


def _k_inputs(B, nz, nx, ny, norb, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.rand(s, device="cuda", generator=g)
    return (r(B, norb, nz, nx, ny) * 0.1, r(B, 10, nz + 1, nx, ny), r(B, 10, nz + 1, nx, ny),
            r(B, nx, ny) * 0.8, r(B, 10, nz, nx, ny))


def _kernel_cost(cuda_ops, scheme, idx, B, nz, nx, ny, norb):
    """(bytes, flops) each kernel needs: inputs read once, outputs written once."""
    groups = cuda_ops.orbit_groups(idx)
    per_cell = sum(len(ss) + 1 for gd in groups for _, ss in gd)
    nxy, nd = nx * ny, scheme.ndiff
    k1_bytes = 4 * B * (3 * nd * (nz + 1) * nxy + norb * nz * nxy + nxy + 2)
    k1_flops = B * (nz * nxy * per_cell + (nz + 1) * nxy * nd * 5)
    k2_bytes = 4 * B * nz * nxy * (2 * nd + norb)
    k2_flops = B * nz * nxy * per_cell
    return {"fused_A_dots": (k1_bytes, k1_flops), "orbit_contract": (k2_bytes, k2_flops)}


def phase_kernels(cuda_ops, scheme, idx, nz, nx, ny):
    norb = int(idx.max()) + 1
    report = {}
    for (B, z, x, y, tag) in ((2, 5, 6, 10, "odd"), (1, nz, nx, ny, "main")):
        orb, u, w, alb, src = _k_inputs(B, z, x, y, norb, seed=z + x)
        Au, dots = cuda_ops.fused_A_dots(scheme, idx, orb, u, w, alb)
        Au_p, dots_p = cuda_ops.fused_A_dots_plain(scheme, idx, orb, u, w, alb)
        c = cuda_ops.orbit_contract(scheme, idx, orb, src)
        c_p = cuda_ops.orbit_contract_plain(idx, orb, src)
        torch.cuda.synchronize()
        e1 = (Au - Au_p).abs().max().item()
        r1 = ((Au - Au_p).abs() / Au_p.abs().clamp(min=1e-6)).max().item()
        d1 = ((dots - dots_p).abs() / dots_p.abs()).max().item()
        e2 = (c - c_p).abs().max().item()
        r2 = ((c - c_p).abs() / c_p.abs().clamp(min=1e-6)).max().item()
        log(f"kernels {tag} B={B} nz={z} nx={x} ny={y}: K1 max abs {e1:.3e} rel {r1:.3e}, "
            f"dots rel {d1:.3e}; K2 max abs {e2:.3e} rel {r2:.3e}")
        if not (e1 <= FIELD_ATOL and d1 <= DOT_RTOL and e2 <= FIELD_ATOL):
            raise AssertionError(f"kernel disagrees with its plain version at {tag} shape "
                                 f"(field atol {FIELD_ATOL}, dot rtol {DOT_RTOL})")
        if tag == "main":
            cost = _kernel_cost(cuda_ops, scheme, idx, B, z, x, y, norb)
            times = {
                "fused_A_dots": (cuda_ms(lambda: cuda_ops.fused_A_dots(scheme, idx, orb, u, w, alb), 20),
                                 cuda_ms(lambda: cuda_ops.fused_A_dots_plain(scheme, idx, orb, u, w, alb), 5)),
                "orbit_contract": (cuda_ms(lambda: cuda_ops.orbit_contract(scheme, idx, orb, src), 20),
                                   cuda_ms(lambda: cuda_ops.orbit_contract_plain(idx, orb, src), 5)),
            }
            for name, err in (("fused_A_dots", e1), ("orbit_contract", e2)):
                nbytes, flops = cost[name]
                tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
                ms, plain_ms = times[name]
                report[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                    bound_ms=max(tb, tf),
                                    bound_by="bytes" if tb >= tf else "operations",
                                    bytes=nbytes, flops=flops)
                log(f"kernels timing {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, bound "
                    f"{max(tb, tf):.4f} ms by {report[name]['bound_by']}, {nbytes / 1e9:.3f} GB)")
        del orb, u, w, alb, src, Au, Au_p, c, c_p
    log('kernels: ["K1 fused_A_dots", "K2 orbit_contract"]')
    return report


def make_solver(nx, ny, seed, opp, Grid, PprtsSolver, sundir):
    dz, kabs, ksca, g, planck = build_scene(nx, ny, seed)
    solver = PprtsSolver(Grid.create(dz.size, nx, ny, 100.0, 100.0, dz, device="cuda"), opp)
    solver.set_angles(sundir)
    return solver, (kabs, ksca, g, planck)


def solve_and_report(solver, fields, cuda_ops, label, albedo=0.15, edir_toa=1000.0):
    """One solar+thermal solve; per sub-solve wall time and kernel launches."""
    kabs, ksca, g, planck = fields
    solver.set_optical_properties(albedo, kabs, ksca, g, planck=planck)
    timing = {}
    run = solver._run

    def timed_run(lthermal, lsolar, *a):
        before = dict(cuda_ops.LAUNCHES)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        sol = run(lthermal, lsolar, *a)
        e1.record()
        torch.cuda.synchronize()
        launches = {k: cuda_ops.LAUNCHES[k] - before[k] for k in before}
        timing["thermal" if lthermal else "solar"] = (e0.elapsed_time(e1), launches)
        return sol

    solver._run = timed_run
    try:
        sol = solver.solve(lthermal=True, lsolar=True, edirTOA=edir_toa)
        edir, edn, eup, abso = solver.get_result()
    finally:
        del solver._run
    for kind, s in (("solar", sol), ("thermal", sol.thermal)):
        ms, launches = timing[kind]
        if not np.isfinite(s.diff_res) or s.diff_res > 1.5 * s.diff_tol:
            raise AssertionError(f"{label} {kind}: residual {s.diff_res:.4e} > 1.5 x tol "
                                 f"{s.diff_tol:.4e}")
        log(f"main {label} {kind}: bicgstab {s.niter_bicgstab} + polish {s.niter_polish} "
            f"iterations, res/tol {s.diff_res / s.diff_tol:.4f}, host syncs {s.host_syncs}, "
            f"wall {ms:.1f} ms, launches K1 {launches['fused_A_dots']} "
            f"K2 {launches['orbit_contract']}")
    for name, a in (("edir", edir), ("edn", edn), ("eup", eup), ("abso", abso)):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{label}: non-finite {name}")
    log(f"main {label} fluxes [W/m2]: TOA edir {edir[0].mean().item():.3f} edn "
        f"{edn[0].mean().item():.3f} eup {eup[0].mean().item():.3f}; surface edir "
        f"{edir[-1].mean().item():.3f} edn {edn[-1].mean().item():.3f} eup "
        f"{eup[-1].mean().item():.3f}; abso mean {abso.mean().item():.4e} W/m3")
    return edir, edn, eup, abso


def phase_main(cuda_ops, opp, Grid, PprtsSolver, sundir, seed):
    solver, fields = make_solver(NX, NY, seed, opp, Grid, PprtsSolver, sundir)
    cuda_ops.reset_launch_counts()
    t0 = time.time()
    solve_and_report(solver, fields, cuda_ops, "cold")
    kabs, ksca, g, planck = fields
    rolled = tuple(np.roll(a, 1, axis=1) for a in (kabs, ksca, g)) + (planck,)
    solve_and_report(solver, rolled, cuda_ops, "warm")
    launches = dict(cuda_ops.LAUNCHES)
    log(f"main: cold + warm at {NX}x{NY}x{NZ} in {time.time() - t0:.1f} s wall; "
        f"launches {launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    return launches


def phase_profile(opp, Grid, PprtsSolver, sundir, seed, top=12):
    """Where the time of a warm re-solve goes.  As in phase 4 the cloud
    field is rolled by one cell and re-solved from the cached solution:
    once with each solver stage timed on the host around a synchronise,
    then (rolled back) under torch.profiler, whose kernel durations give
    the device busy time and the kernels with the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import tenstream_tpu_torch.pprts.solver as solver_mod

    solver, (kabs, ksca, g, planck) = make_solver(NX, NY, seed, opp, Grid, PprtsSolver, sundir)

    def resolve(shift):
        solver.set_optical_properties(
            0.15, *(np.roll(a, shift, axis=1) for a in (kabs, ksca, g)), planck=planck)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sol = solver.solve(lthermal=True, lsolar=True, edirTOA=1000.0)
        torch.cuda.synchronize()
        return sol, (time.perf_counter() - t0) * 1e3

    resolve(0)
    stages = {}

    def timed(name, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            stages[name] = stages.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
            return out
        return run

    names = ("assemble_coeffs", "solve_edir", "thermal_source", "solve_bicgstab",
             "solve_richardson", "calc_flx_div")
    saved = {n: getattr(solver_mod, n) for n in names}
    for n in names:
        setattr(solver_mod, n, timed(n, saved[n]))
    try:
        sol, wall_ms = resolve(1)
    finally:
        for n in names:
            setattr(solver_mod, n, saved[n])
    other = wall_ms - sum(stages.values())
    log(f"profile stages of the warm {NX}x{NY}x{NZ} solar+thermal re-solve (wall {wall_ms:.1f} ms, "
        f"bicgstab {sol.niter_bicgstab}+{sol.thermal.niter_bicgstab} iterations): "
        + ", ".join(f"{n} {ms:.1f} ms" for n, ms in stages.items()) + f", other {other:.1f} ms")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sol_p, wall_prof_ms = resolve(0)
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            t, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, n + 1)
    busy_ms = sum(t for t, _ in by_name.values())
    if busy_ms == 0:
        log("profile: the profiler recorded no device time; device busy share not measured")
        return
    log(f"profile device: busy {busy_ms:.1f} ms in {sum(n for _, n in by_name.values())} kernels "
        f"= {100 * busy_ms / wall_ms:.1f}% of the unprofiled wall {wall_ms:.1f} ms "
        f"(profiled wall {wall_prof_ms:.1f} ms; bicgstab "
        f"{sol_p.niter_bicgstab}+{sol_p.thermal.niter_bicgstab} iterations)")
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        log(f"profile   {t:9.2f} ms {n:6d} launches  {name[:100]}")


def phase_parity(cuda_ops, ediff, opp, Grid, PprtsSolver, sundir, seed):
    """64x64 scene through the kernels, then through the plain versions."""
    outs = []
    for plain in (False, True):
        solver, fields = make_solver(64, 64, seed, opp, Grid, PprtsSolver, sundir)
        saved = (ediff.fused_A_dots, cuda_ops.orbit_contract)
        if plain:
            ediff.fused_A_dots = (lambda scheme, idx, orb, u, w, alb:
                                  cuda_ops.fused_A_dots_plain(scheme, idx, orb, u, w, alb))
            cuda_ops.orbit_contract = (lambda scheme, idx, orb, src:
                                       cuda_ops.orbit_contract_plain(idx, orb, src))
        try:
            outs.append(solve_and_report(solver, fields, cuda_ops,
                                         "parity-plain" if plain else "parity-kernels"))
        finally:
            ediff.fused_A_dots, cuda_ops.orbit_contract = saved
    errs = [(a - b).abs().max().item() for a, b in zip(*outs)]
    log(f"parity 64x64x39 kernels vs plain: max abs edir {errs[0]:.3e} edn {errs[1]:.3e} "
        f"eup {errs[2]:.3e} W/m2, abso {errs[3]:.3e} W/m3")
    if max(errs[:3]) > FLUX_ATOL or errs[3] > ABSO_ATOL:
        raise AssertionError(f"kernel and plain solves differ (flux atol {FLUX_ATOL}, "
                             f"abso atol {ABSO_ATOL})")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()

    name, smi = phase_device()
    from tenstream_tpu_torch.optprop.facade import OptProp
    from tenstream_tpu_torch.optprop.lut import LUT
    from tenstream_tpu_torch.pprts import cuda_ops, ediff
    from tenstream_tpu_torch.pprts.grid import Grid
    from tenstream_tpu_torch.pprts.solver import PprtsSolver
    from tenstream_tpu_torch.pprts.sun import sundir_from_angles

    phase_build(cuda_ops)
    opp = OptProp(LUT.load(LUT_PATH, device="cuda"), device="cuda")
    idx = opp._solver_orbit_idx
    report = phase_kernels(cuda_ops, opp.scheme, idx, NZ, NX, NY)
    sundir = sundir_from_angles(250.0, 35.0)
    launches = phase_main(cuda_ops, opp, Grid, PprtsSolver, sundir, args.seed)
    phase_parity(cuda_ops, ediff, opp, Grid, PprtsSolver, sundir, args.seed)
    phase_profile(opp, Grid, PprtsSolver, sundir, args.seed)

    kernels = []
    for kname, (tag, replaces) in KERNELS.items():
        r = report[kname]
        kernels.append(dict(name=f"{tag} {kname}", route="cuda",
                            source="tenstream_tpu_torch/csrc/orbit_ops.cu", replaces=replaces,
                            launches=launches[kname], max_abs_err=r["max_abs_err"], ms=r["ms"],
                            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                            bound_by=r["bound_by"], library_ms=None))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
