#!/usr/bin/env python3
"""How far the wedge solvers' iteration counts move under float32
rounding alone, on the CPU: the spread that the port-vs-JAX niter gates of
`tests/test_torch_plexrt_solver.py` and `tests/test_torch_plexrt_icon.py`
have to allow for.

    python tools/torch_wedge_niter_spread.py [--k 6]

Runs each test's solve sequence (the 5_8 and 18_8 structured solvers with
both diffuse solvers, the ICON solver on its structured and equilateral
meshes) once as given, and k more times with every input field multiplied
by 1 + 1e-7 x N(0, 1) (about one float32 rounding), in the JAX package
and in the port, and once more in the port with every port module's
working type `ireals` set to float64.  Prints per solve the niter of each
run and the largest gap between the two packages on the unperturbed
inputs; the fields' differences stay at the test gates throughout.

Then the lanes of `tests/test_torch_specint_plexrt.py` (ecCKD, max_gpt 5)
on both solvers with each diffuse solver, in each package at band chunks
of 2 (the test's) and of 1: the same g-points on the same inputs, only
the batch around a lane differs, which moves the float32 reductions'
order.  Prints each lane's niter per chunking and the largest move.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import test_torch_plexrt_icon as ticon_test  # noqa: E402
import test_torch_plexrt_solver as tsolver_test  # noqa: E402
import test_torch_specint_plexrt as tspec_test  # noqa: E402


def perturbed(fn, k, rng):
    """`fn` (a scene builder) with its float fields jittered by ~1 ulp."""
    def scene():
        out = fn()
        if k == 0:
            return out
        return tuple((a * (1.0 + 1e-7 * rng.standard_normal(a.shape))).astype(np.float32)
                     for a in out)
    return scene


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k", type=int, default=6)
    args = ap.parse_args()
    torch.set_num_threads(1)

    runs = {}  # (solver label, case) -> {"jax": [...], "port": [...], "port64": n}
    setups = [(f"fish {scheme} {mode}", tsolver_test, dict(scheme=scheme, mode=mode))
              for scheme in ("5_8", "18_8") for mode in ("bicgstab", "fixedpoint")]
    setups += [(f"icon {kind}", ticon_test, dict(kind=kind))
               for kind in ("structured", "equilateral")]
    for label, mod, kw in setups:
        base = mod.scene if mod is tsolver_test else (lambda kind=kw["kind"]: ticon_test.scene(
            ticon_test.MESHES[kind](ticon_test.jicon)))
        for k in range(args.k + 1):
            rng = np.random.default_rng(100 + k)
            scene = perturbed(base, k, rng)
            for who in ("jax", "port"):
                out = mod.run_for_spread(who, scene, **kw)
                for case, n in out.items():
                    runs.setdefault((label, case), {"jax": [], "port": []})[who].append(n)
        for name, m in list(sys.modules.items()):
            if name.startswith("tenstream_tpu_torch") and hasattr(m, "ireals"):
                m.ireals = torch.float64
        for case, n in mod.run_for_spread("port", base, **kw).items():
            runs[label, case]["port64"] = n
        for name, m in list(sys.modules.items()):
            if name.startswith("tenstream_tpu_torch") and hasattr(m, "ireals"):
                m.ireals = torch.float32

    worst_gap, worst_spread = 0, 0
    for (label, case), r in runs.items():
        gap = abs(r["jax"][0] - r["port"][0])
        spread = max(max(r["jax"]) - min(r["jax"]), max(r["port"]) - min(r["port"]))
        worst_gap, worst_spread = max(worst_gap, gap), max(worst_spread, spread)
        print(f"{label:26s} {case:18s} jax {r['jax']} port {r['port']} port float64 "
              f"{r['port64']}: gap {gap}, spread within one package {spread}")
    print(f"largest port-vs-JAX gap {worst_gap}; largest spread of one package under ~1-ulp "
          f"input changes {worst_spread}")

    for diff_solver in ("bicgstab", "fixedpoint"):
        worst_move = 0
        for which in ("fish", "icon"):
            c = tspec_test.CHUNK
            by_chunk = {chunk: tspec_test.lane_niters(which, chunk, diff_solver)
                        for chunk in (c, 1)}
            for who in ("jax", "port"):
                a, b = by_chunk[c][who], by_chunk[1][who]
                move = max(abs(x - y) for x, y in zip(a, b))
                worst_move = max(worst_move, move)
                print(f"specint {diff_solver} {which} {who}: lanes at chunks of {c} {a}, of 1 {b}: "
                      f"largest move {move}")
            gap = max(abs(x - y) for x, y in zip(by_chunk[c]["jax"], by_chunk[c]["port"]))
            print(f"specint {diff_solver} {which}: port-vs-JAX gap at chunks of {c} {gap}")
        print(f"{diff_solver}: largest move of a lane's niter with its chunking alone {worst_move}")


if __name__ == "__main__":
    main()
