#!/usr/bin/env python3
"""How far the port's float32 1-D spectral path is from the same code in
float64, on the CPU: the float32 rounding that `chip_smoke.py` phase 19's
card-vs-CPU crop gates have to allow for.

    python tools/torch_float32_rounding.py [--n 16] [--seed 7]

Runs phase 19 (a)'s call -- 2str columns through `specint_pprts`, RRTMG_SW
112 solar g-points and ecCKD 32 longwave ones, on bench.py's scene (its z
grid of 39 layers, its cloud field from --seed, rolled by one cell as in
phase 18's perturbed step), cropped to n x n columns -- once as the port
computes it (float32) and once with every port module's working type
`ireals` set to float64, and prints each field's largest difference and
its largest magnitude.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=cs.CROP)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()

    atm, lwc = cs.build_bench_atm(cs.NX, cs.NY, args.seed)
    lwc = np.roll(lwc, 1, axis=1)[:, :args.n, :args.n]
    dz = atm.dz.astype(np.float32)
    calls = cs.gas_calls("rrtmg_sw")

    def run():
        s = cs.oned_solver("2str", atm.nlay, args.n, args.n, dz, 100.0, "cpu", cs.SPECTRAL_SUN)
        return cs.oned_specint(s, atm, lwc, calls)[0]

    r32 = run()
    for name, mod in list(sys.modules.items()):
        if name.startswith("tenstream_tpu_torch") and hasattr(mod, "ireals"):
            mod.ireals = torch.float64
    r64 = run()
    for name, a, b in zip(("edir", "edn", "eup", "abso"), r32, r64):
        err = float((a.double() - b).abs().max())
        scale = float(b.abs().max())
        print(f"{name}: float32 - float64 max abs {err:.3e} ({err / scale:.2e} of the largest "
              f"magnitude {scale:.3f}); dtypes {a.dtype}, {b.dtype}")


if __name__ == "__main__":
    main()
