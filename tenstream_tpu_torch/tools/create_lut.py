"""Generate BoxMC transfer-coefficient LUTs with the port (reference
`src/createLUT.F90`; the port of `tools/create_lut.py`).

    python -m tenstream_tpu_torch.tools.create_lut 3_10 [--preset default|mockup|bench|production]
        [--photons N] [--out DIR] [--no-kernel] [--device cuda|cpu]
        [--max-rounds N] [--dir-max-rounds N] [--compose-dir-from DONOR_LUT]
    python -m tenstream_tpu_torch.tools.create_lut wedge_5_8 [--preset mockup|default]
        [--photons N] [--out DIR] [--device cuda|cpu]

Tables are written in the JAX package's npz format under the output dir
(default `data/luts`, or $TENSTREAM_TPU_LUT_DIR), keyed by the axis
configuration; interrupted runs resume from per-source checkpoints.  On
`--device cuda` (the default) K4 traces on the card; `--device cpu` runs
its plain PyTorch version.  `--no-kernel` sends every source to the
general tracer.  `wedge_5_8` and `wedge_18_8` trace wedge tables with the
wedge tracer (`plexrt.wedge_boxmc`) on the test axes (`mockup`) or the
full-density axes (any other preset).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def bench_axes():
    """The benchmark scene's table axes (a copy of `bench.py::bench_lut_axes`,
    which imports the JAX package; `tests/test_torch_lutgen.py` holds the
    two equal)."""
    from tenstream_tpu_torch.optprop.lut import LUTAxes

    tau = np.array([1e-10, 1e-4, 1e-3, 1e-2, 0.05, 0.15, 0.4, 0.8, 1.5, 3.0, 6.0, 12.0, 30.0,
                    100.0], np.float32)
    w0 = np.array([0.0, 0.35, 0.6, 0.8, 0.9, 0.95, 0.98, 0.995, 0.99999], np.float32)
    aspect = np.array([0.02, 0.05, 0.1, 0.2, 0.35, 0.55, 0.8, 1.0, 1.3, 2.0, 3.5, 7.45],
                      np.float32)
    g = np.array([0.0, 0.25, 0.5, 0.85], np.float32)
    phi = np.linspace(0.0, 90.0, 7).astype(np.float32)
    theta = np.array([0.0, 15.0, 30.0, 42.5, 55.0, 67.5, 80.0], np.float32)
    return LUTAxes(tau, w0, aspect, g, phi, theta), LUTAxes(tau, w0, aspect, g)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scheme", help="stream scheme, e.g. 3_10")
    ap.add_argument("--preset", default="default", choices=["default", "mockup", "bench", "production"])
    ap.add_argument("--photons", type=int, default=10000)
    ap.add_argument("--out", default=None)
    ap.add_argument("--no-kernel", action="store_true",
                    help="trace every source with the general tracer instead of K4")
    ap.add_argument("--device", default="cuda", help="where tracing runs (cuda or cpu)")
    ap.add_argument("--max-rounds", type=int, default=None,
                    help="production preset: cap adaptive rounds per entry. Staged generation "
                    "(breadth-first): run once with a low cap to get a COMPLETE table quickly, "
                    "then re-run with a higher cap; checkpoints make every pass incremental.")
    ap.add_argument("--dir-max-rounds", type=int, default=None,
                    help="production preset: cap for the dir2diff sources")
    ap.add_argument("--compose-dir-from", default=None, metavar="DONOR_LUT",
                    help="production preset: compose the table from the converged diffuse "
                    "checkpoints plus this donor LUT's direct tables (dir2dir regenerated in "
                    "closed form) instead of waiting for the full adaptive dir2diff pass")
    args = ap.parse_args(argv)

    if args.scheme.startswith("wedge_"):
        # wedge tables (plexrt solvers): fixed photon counts over the wedge
        # parameter space, mirror-symmetrized
        from tenstream_tpu_torch.plexrt import optprop as W

        axes = W.test_axes() if args.preset == "mockup" else W.default_axes()
        t0 = time.time()
        lut = W.load_or_create_wedge_lut(axes, n_photons=args.photons, basename=args.out,
                                         scheme=args.scheme[len("wedge_"):], device=args.device,
                                         verbose=True)
        print(f"done in {time.time() - t0:.1f}s; dir table {tuple(lut.dir2dir.shape)}, "
              f"diff table {tuple(lut.diff2diff.shape)}")
        return

    from tenstream_tpu_torch.optprop import lut as L

    use_kernel = False if args.no_kernel else None
    if args.preset == "production":
        base = args.out or L.lut_basename()
        out_path = os.path.join(base, f"LUT_{args.scheme}_production.npz")
        ckdir = os.path.join(base, f"ckpt_{args.scheme}_production")
        t0 = time.time()
        if args.compose_dir_from:
            lut, meta = L.compose_production_lut(args.scheme, args.compose_dir_from,
                                                 checkpoint_dir=ckdir, device=args.device)
            lut.save(out_path, meta=meta)
            print(f"composed in {time.time() - t0:.1f}s -> {out_path}")
            print("meta:", meta)
            return
        kw = {}
        if args.max_rounds is not None:
            kw["max_rounds"] = args.max_rounds
        if args.dir_max_rounds is not None:
            kw["dir_max_rounds"] = args.dir_max_rounds
        lut, meta = L.create_production_lut(
            args.scheme, L.production_axes(True), L.production_axes(False),
            checkpoint_dir=ckdir, use_kernel=use_kernel, device=args.device, **kw)
        lut.save(out_path, meta=meta)
        print(f"done in {time.time() - t0:.1f}s -> {out_path}")
        print("meta:", meta)
        return

    if args.preset == "bench":
        da, fa = bench_axes()
    else:
        axes = L.mockup_axes if args.preset == "mockup" else L.default_axes
        da, fa = axes(True), axes(False)
    t0 = time.time()
    lut = L.load_or_create_lut(args.scheme, da, fa, n_photons=args.photons,
                               basename=args.out, verbose=True, use_kernel=use_kernel,
                               device=args.device)
    print(f"done in {time.time() - t0:.1f}s; dir table {tuple(lut.dir2dir.shape)}, "
          f"diff table {tuple(lut.diff2diff.shape)}")


if __name__ == "__main__":
    main()
