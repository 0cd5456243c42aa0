"""The ANN coefficient backend against the LUT on bench.py's column, in both
packages on the CPU (~1 minute).

    python tools/torch_ann_column.py [--n 8] [--seed 7]

Solves phase 4's band of `chip_smoke.py` (bench.py's 39 layers, its cloud
blocks) on an n x n crop with the committed production LUT and with the
committed net (`data/ann/ANN_3_10_production.npz`), solar and thermal
apart, in the JAX package and in the port, and prints the domain means of
edn and eup per case.  Then, for each layer of the column's clear air, the
net's diffuse row sums (sum over destinations of diff2diff) beside the
LUT's: a net whose rows do not sum as the table's changes the layers'
emissivity (1 - row sum), which the thin upper layers amplify.
"""

from __future__ import annotations

import argparse
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, REPO)

import numpy as np


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=8)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import torch

    import chip_smoke
    from tenstream_tpu.optprop.ann import AnnOptProp as JAnn
    from tenstream_tpu.optprop.facade import OptProp as JOptProp
    from tenstream_tpu.optprop.lut import LUT as JLUT
    from tenstream_tpu.pprts.grid import Grid as JGrid
    from tenstream_tpu.pprts.solver import PprtsSolver as JSolver
    from tenstream_tpu_torch.optprop.ann import AnnOptProp
    from tenstream_tpu_torch.optprop.facade import OptProp
    from tenstream_tpu_torch.optprop.lut import LUT
    from tenstream_tpu_torch.pprts.grid import Grid
    from tenstream_tpu_torch.pprts.solver import PprtsSolver
    from tenstream_tpu_torch.pprts.sun import sundir_from_angles

    n = args.n
    dz, kabs, ksca, g, planck = chip_smoke.build_scene(n, n, args.seed)
    nz = dz.size
    sun = sundir_from_angles(*chip_smoke.SUN)
    ann_path = os.path.join(REPO, "data", "ann", "ANN_3_10_production.npz")
    backends = {
        "jax": (lambda: JOptProp(JLUT.load(chip_smoke.LUT_PATH)), lambda: JAnn.load(ann_path),
                lambda opp: JSolver(JGrid.create(nz, n, n, 100.0, 100.0, dz), opp)),
        "port": (lambda: OptProp(LUT.load(chip_smoke.LUT_PATH, device="cpu"), device="cpu"),
                 lambda: AnnOptProp.load(ann_path, device="cpu"),
                 lambda opp: PprtsSolver(Grid.create(nz, n, n, 100.0, 100.0, dz, device="cpu"),
                                         opp)),
    }
    for pkg, (lut, ann, make) in backends.items():
        for name, opp in (("LUT", lut()), ("ANN", ann())):
            for part, (lth, lso) in (("solar", (False, True)), ("thermal", (True, False))):
                s = make(opp)
                s.set_optical_properties(0.15, kabs, ksca, g, planck=planck)
                s.set_angles(sun)
                s.solve(lthermal=lth, lsolar=lso, edirTOA=1000.0)
                edir, edn, eup, abso = (np.asarray(a) for a in s.get_result())
                print(f"{pkg:4s} {name} {part:7s}: domain mean edn {edn.mean():9.4f} eup "
                      f"{eup.mean():9.4f} W/m2, TOA eup {eup[0].mean():9.4f}, surface edn "
                      f"{edn[-1].mean():9.4f}, abso {abso.mean():.4e} W/m3")

    # the diffuse row sums of the clear-air layers, LUT against net
    opp, net = backends["port"][0](), backends["port"][1]()
    tauz = torch.as_tensor((kabs[:, 0, 0] + ksca[:, 0, 0]) * dz)
    w0 = torch.as_tensor(ksca[:, 0, 0] / (kabs[:, 0, 0] + ksca[:, 0, 0]))
    gg = torch.as_tensor(g[:, 0, 0])
    asp = torch.as_tensor(dz / 100.0)
    r_lut = opp.diff_coeffs(tauz, w0, gg, asp).sum(1).mean(0)
    r_ann = net.diff_coeffs(tauz, w0, gg, asp).sum(1).mean(0)
    print("layer  tau        aspect   LUT row sum  ANN row sum  (mean over sources)")
    for k in range(nz):
        print(f"{k:5d}  {tauz[k].item():.3e}  {asp[k].item():7.3f}  {r_lut[k].item():.6f}     "
              f"{r_ann[k].item():.6f}")


if __name__ == "__main__":
    main()
