#!/usr/bin/env python3
"""The wedge solvers on bench.py's column, on the CPU, in the JAX package
and in the port: why `chip_smoke.py` phases 25-27 gate their solves on
`WEDGE_EXACT` and not on the solvers' defaults.

    python tools/torch_wedge_column.py [--n 8] [--seed 7]

bench.py's column (24 layers of 100 m under 15 geometric layers up to
2.5 km), dx = dy = 100 m, phase 4's band on both orientations, the
committed full-density 5_8 table, sun (120, 40), albedo 0.15:

1. the direct sweep of a transparent column: the beam reaching the
   surface against n_inner (the side-exchange sweeps per layer);
2. a solar solve with the defaults (n_inner 24, BiCGStab, diff_iters
   300) in both packages: niter, res / tol and the energy balance;
3. the same in the port with `chip_smoke.WEDGE_EXACT`.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import chip_smoke as cs  # noqa: E402


def balance(edir, edn, eup, abso, dz):
    dzv = np.asarray(dz, np.float64)[:, None, None, None]
    return float(eup[0].mean() + (abso * dzv).sum(0).mean() + (edir[-1] + edn[-1] - eup[-1]).mean())


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=8)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    torch.set_num_threads(4)

    from tenstream_tpu_torch.plexrt.mesh import fish_mesh
    from tenstream_tpu_torch.plexrt.solver import PlexrtSolver
    from tenstream_tpu_torch.pprts.sun import sundir_from_angles

    n = args.n
    dz, fields, planck = cs.wedge_scene(n, args.seed)
    opp = cs.wedge_opp("cpu")[0]
    sun = sundir_from_angles(*cs.SPECTRAL_SUN)
    mu = float(np.cos(np.deg2rad(cs.SPECTRAL_SUN[1])))
    print(f"column dz (m): {np.round(dz.astype(np.float64), 1).tolist()}; dx 100 m")

    clear = np.full_like(fields[0], 1e-10)
    for n_inner in (24, 48, 64, 96, 128):
        s = PlexrtSolver(fish_mesh(len(dz), n, n, 100.0, 100.0, dz), opp, n_inner=n_inner)
        s.set_angles(sun)
        s.set_optical_properties(cs.WEDGE_ALBEDO, clear, clear, clear)
        edir = s.get_result(s.solve(lthermal=False, lsolar=True, edirTOA=1000.0))[0]
        top, sfc = edir[0].mean().item(), edir[-1].mean().item()
        print(f"transparent column, n_inner {n_inner:3d}: surface edir {sfc:.4f} of {top:.4f} "
              f"W/m2 ({100 * sfc / top:.2f}%)")

    import jax

    jax.config.update("jax_platforms", "cpu")
    from tenstream_tpu.plexrt.mesh import fish_mesh as jfish
    from tenstream_tpu.plexrt.optprop import WedgeOptProp as JOptProp
    from tenstream_tpu.plexrt.optprop import default_axes, load_or_create_wedge_lut
    from tenstream_tpu.plexrt.solver import PlexrtSolver as JSolver

    jopp = JOptProp(load_or_create_wedge_lut(default_axes(), None, cs.WEDGE_PHOTONS))
    runs = [("JAX defaults", JSolver(jfish(len(dz), n, n, 100.0, 100.0, dz), jopp)),
            ("port defaults", PlexrtSolver(fish_mesh(len(dz), n, n, 100.0, 100.0, dz), opp)),
            ("port WEDGE_EXACT", PlexrtSolver(fish_mesh(len(dz), n, n, 100.0, 100.0, dz), opp,
                                              **cs.WEDGE_EXACT))]
    for label, s in runs:
        s.set_angles(sun)
        s.set_optical_properties(cs.WEDGE_ALBEDO, *fields)
        sol = s.solve(lthermal=False, lsolar=True, edirTOA=1000.0)
        res = [np.asarray(a) for a in s.get_result(sol)]
        bal = balance(*res, dz)
        print(f"{label:17s} solar: niter {int(sol.niter_diff)}, res/tol "
              f"{float(sol.diff_res) / float(sol.diff_tol):.4g}, surface edir "
              f"{res[0][-1].mean():.4f}, balance {bal:.4f} of {1000 * mu:.4f} W/m2 "
              f"({100 * abs(bal - 1000 * mu) / (1000 * mu):.4f}% off)")


if __name__ == "__main__":
    main()
