"""The 3_10 and wedge solvers against the domain Monte Carlo on a crop of
bench.py's column, in both packages on the CPU (a few minutes at 32x32).

    python tools/torch_mc_column.py [--n 32] [--seed 7] [--photons-per-column 256]

`chip_smoke.py` phase 29's comparison at n x n: phase 4's band (bench.py's
39 layers and cloud blocks) with albedo 0.15 and the sun at (120, 40); the
Monte Carlo with 256 photons per column (the port's `solve_mcdmda`, which
draws and walks as JAX's does photon for photon, `tests/test_torch_mcdmda.py`;
JAX's is not run: on the CPU it steps every photon until the last one
stops); the solar solves of the 3_10 `PprtsSolver` on the production LUT
and of the 5_8 `PlexrtSolver` on the committed full-density wedge table
with `chip_smoke.WEDGE_EXACT`, each in the JAX package and in the port.
Prints, per solver, the domain-mean TOA eup and surface edir + edn beside
the MC's and the correlation of the surface field summed over 4 x 4
columns (the phase's gates: 0.04 and 0.05 x 1000 mu, 0.8 and 0.85), and
the correlation of the two solvers' surface fields with each other.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, REPO)

import numpy as np


def blocks(a, b=4):
    n = a.shape[0] // b
    return a.reshape(n, b, n, b).sum((1, 3)).ravel()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--photons-per-column", type=int, default=256)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import chip_smoke as cs
    from tenstream_tpu.optprop.facade import OptProp as JOptProp
    from tenstream_tpu.optprop.lut import LUT as JLUT
    from tenstream_tpu.plexrt.mesh import fish_mesh as jfish
    from tenstream_tpu.plexrt.optprop import WedgeOptProp as JWedgeOptProp
    from tenstream_tpu.plexrt.optprop import default_axes as jdefault_axes
    from tenstream_tpu.plexrt.optprop import load_or_create_wedge_lut as jwedge_lut
    from tenstream_tpu.plexrt.solver import PlexrtSolver as JPlexrt
    from tenstream_tpu.pprts.grid import Grid as JGrid
    from tenstream_tpu.pprts.solver import PprtsSolver as JSolver
    from tenstream_tpu_torch.core.prng import Threefry
    from tenstream_tpu_torch.optprop.facade import OptProp
    from tenstream_tpu_torch.optprop.lut import LUT
    from tenstream_tpu_torch.plexrt.mesh import fish_mesh
    from tenstream_tpu_torch.plexrt.solver import PlexrtSolver
    from tenstream_tpu_torch.pprts import mcdmda
    from tenstream_tpu_torch.pprts.grid import Grid
    from tenstream_tpu_torch.pprts.solver import PprtsSolver
    from tenstream_tpu_torch.pprts.sun import sundir_from_angles

    n = args.n
    dz, kabs, ksca, g = cs.mc_scene(n, args.seed)
    nz = dz.size
    sun = sundir_from_angles(*cs.SPECTRAL_SUN)
    mu = float(np.cos(np.deg2rad(cs.SPECTRAL_SUN[1])))
    albedo = cs.WEDGE_ALBEDO
    t0 = time.time()
    mc = mcdmda.solve_mcdmda(Threefry.from_seed(args.seed), kabs, ksca, g, dz, 100.0, 100.0,
                             albedo, sun, 1000.0, n_photons=args.photons_per_column * n * n,
                             device="cpu")
    mc_eup, mc_dn = float(mc.eup_toa.mean()), mc.edn_srfc.numpy().astype(np.float64)
    print(f"MC {n}x{n}x{nz}: {args.photons_per_column * n * n} photons, niter {mc.niter}, "
          f"{time.time() - t0:.1f} s; TOA eup {mc_eup:.4f}, surface edn {mc_dn.mean():.4f} W/m2")

    per_tri = lambda a: np.repeat(a[:, None], 2, axis=1)
    solvers = {
        "3_10 jax": lambda: JSolver(JGrid.create(nz, n, n, 100.0, 100.0, dz),
                                    JOptProp(JLUT.load(cs.LUT_PATH))),
        "3_10 port": lambda: PprtsSolver(Grid.create(nz, n, n, 100.0, 100.0, dz, device="cpu"),
                                         OptProp(LUT.load(cs.LUT_PATH, device="cpu"),
                                                 device="cpu")),
        "wedge jax": lambda: JPlexrt(jfish(nz, n, n, 100.0, 100.0, dz), JWedgeOptProp(
            jwedge_lut(jdefault_axes(), None, cs.WEDGE_PHOTONS)), **cs.WEDGE_EXACT),
        "wedge port": lambda: PlexrtSolver(fish_mesh(nz, n, n, 100.0, 100.0, dz),
                                           cs.wedge_opp("cpu")[0], **cs.WEDGE_EXACT),
    }
    maps = {}
    for name, make in solvers.items():
        t0 = time.time()
        s = make()
        wedge = name.startswith("wedge")
        fields = [per_tri(a) if wedge else a for a in (kabs, ksca, g)]
        s.set_optical_properties(albedo, *fields)
        s.set_angles(sun)
        if wedge:
            edir, edn, eup, _ = (np.asarray(a) for a in s.get_result(
                s.solve(lthermal=False, lsolar=True, edirTOA=1000.0)))
            edir, edn, eup = (a.mean(axis=1) for a in (edir, edn, eup))
        else:
            s.solve(lthermal=False, lsolar=True, edirTOA=1000.0)
            edir, edn, eup, _ = (np.asarray(a) for a in s.get_result())
        dn = (edir[-1] + edn[-1]).astype(np.float64)
        maps[name] = dn
        cc = np.corrcoef(blocks(mc_dn), blocks(dn))[0, 1]
        print(f"{name:10s} ({time.time() - t0:.1f} s): TOA eup {eup[0].mean():.4f} vs MC "
              f"{mc_eup:.4f} ({eup[0].mean() - mc_eup:+.4f}, gate {0.04 * 1000 * mu:.2f}); "
              f"surface edir+edn {dn.mean():.4f} vs {mc_dn.mean():.4f} "
              f"({dn.mean() - mc_dn.mean():+.4f}, gate {0.05 * 1000 * mu:.2f}); correlation of "
              f"the 4x4 sums {cc:.4f}")
    for pkg in ("jax", "port"):
        a, b = maps[f"3_10 {pkg}"], maps[f"wedge {pkg}"]
        print(f"{pkg}: 3_10 vs wedge surface field: correlation of the 4x4 sums "
              f"{np.corrcoef(blocks(a), blocks(b))[0, 1]:.4f}, per column "
              f"{np.corrcoef(a.ravel(), b.ravel())[0, 1]:.4f}")


if __name__ == "__main__":
    main()
