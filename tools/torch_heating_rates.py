#!/usr/bin/env python3
"""Heating rates of bench.py's scene from the JAX package and from the
PyTorch port, on the CPU.

    JAX_PLATFORMS=cpu python tools/torch_heating_rates.py [--n 64] [--seed 7] [--lut PATH]

Builds bench.py's scene at n x n columns (its z grid of 39 layers and its
cloud field, nx * ny / 16 boxes from --seed), solves the full spectrum
(ecCKD 32+32, band chunks of 8, atm_collapse over the leading 16 1-D
layers, the production LUT or the table at --lut, whose scheme the solvers
take, sun (120, 40), albedo 0.15) with both packages, and prints, for the layers below the collapsed super-layer, the
largest |heating rate| (K/day, `abso2hr`), the cell it sits in and the
liquid water there and above, the number of cells above 100 K/day, and
the largest |heating rate| in clear and in cloudy cells.  Cloud-top cells
(cloud under clear air) cool by thermal emission through their top face
and reach about 100 K/day; `chip_smoke.py` phase 12 holds every other
cell below 100 K/day.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
K = 16
LUT_PATH = os.path.join(REPO, "data", "luts", "LUT_3_10_production.npz")


def bench_scene(n, seed):
    from tenstream_tpu.atm import setup_standard_atmosphere

    z_low = np.arange(0.0, 24 * 100.0 + 1.0, 100.0)
    z_high = np.geomspace(24 * 100.0 + 250.0, 20e3, 16)
    atm = setup_standard_atmosphere(z_grid=np.concatenate([z_high[::-1], z_low[::-1][1:]]))
    rng = np.random.default_rng(seed)
    lwc = np.zeros((atm.nlay, n, n), np.float32)
    zc = atm.zlev[:-1]
    cloudy = np.where((zc > 600.0) & (zc < 2000.0))[0]
    for _ in range(n * n // 16):
        i, j = rng.integers(0, n), rng.integers(0, n)
        k = rng.choice(cloudy)
        di, dj = rng.integers(1, 4), rng.integers(1, 4)
        lwc[k:k + 2, i:i + di, j:j + dj] = rng.uniform(0.1, 0.6)
    return atm, lwc


def report(label, abso, atm, lwc):
    from tenstream_tpu.atm import abso2hr

    hr = np.asarray(abso2hr(abso[1:], atm.play[K:, None, None], atm.tlay[K:, None, None]))
    k, i, j = np.unravel_index(np.abs(hr).argmax(), hr.shape)
    cloud = lwc[K:] > 0
    top = cloud & np.concatenate([~(lwc[K - 1:K] > 0), ~cloud[:-1]], 0)
    print(f"{label}: max |HR| {np.abs(hr).max():.4f} K/day at layer {k + K} ({i}, {j}), lwc "
          f"{lwc[k + K, i, j]:.3f} there, {lwc[k + K - 1, i, j]:.3f} above; "
          f"{int((np.abs(hr) > 100).sum())} of {hr.size} cells above 100 K/day; max |HR| in clear "
          f"cells {np.abs(hr[~cloud]).max():.4f}, in cloud-top cells {np.abs(hr[top]).max():.4f}, "
          f"in other cloud cells {np.abs(hr[cloud & ~top]).max():.4f}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--lut", default=LUT_PATH, help="the table (and so the scheme) to solve with")
    args = ap.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    from tenstream_tpu.core.config import Options as JOptions
    from tenstream_tpu.optprop.facade import OptProp as JOptProp
    from tenstream_tpu.optprop.lut import LUT as JLUT
    from tenstream_tpu.pprts.grid import Grid as JGrid
    from tenstream_tpu.pprts.solver import PprtsSolver as JSolver
    from tenstream_tpu.pprts.sun import sundir_from_angles as jsun
    from tenstream_tpu.spectral.specint import specint_pprts as jspecint
    from tenstream_tpu_torch.convert import atmosphere_from_arrays
    from tenstream_tpu_torch.core.config import Options
    from tenstream_tpu_torch.optprop.facade import OptProp
    from tenstream_tpu_torch.optprop.lut import LUT
    from tenstream_tpu_torch.pprts.grid import Grid
    from tenstream_tpu_torch.pprts.solver import PprtsSolver
    from tenstream_tpu_torch.pprts.sun import sundir_from_angles
    from tenstream_tpu_torch.spectral import specint_pprts

    n = args.n
    atm, lwc = bench_scene(n, args.seed)
    dz = np.asarray(atm.dz, np.float32)
    opts = {"atm_collapse": K, "specint_cache": "f32"}
    kw = dict(albedo=0.15, lthermal=True, lsolar=True, specint="ecckd", lwc=lwc, band_chunk=8)

    js = JSolver(JGrid.create(atm.nlay, n, n, 100.0, 100.0, dz), JOptProp(JLUT.load(args.lut)),
                 options=JOptions(dict(opts), read_env=False))
    js.set_angles(jsun(120.0, 40.0))
    t0 = time.time()
    rj = jspecint(js, atm, **kw)
    report(f"JAX package {n}x{n} ({time.time() - t0:.0f} s)", np.asarray(rj.abso), atm, lwc)

    ts = PprtsSolver(Grid.create(atm.nlay, n, n, 100.0, 100.0, dz, device="cpu"),
                     OptProp(LUT.load(args.lut, device="cpu"), device="cpu"),
                     options=Options(dict(opts), read_env=False))
    ts.set_angles(sundir_from_angles(120.0, 40.0))
    t0 = time.time()
    rt = specint_pprts(ts, atmosphere_from_arrays(atm), **kw)
    report(f"port {n}x{n} ({time.time() - t0:.0f} s)", rt.abso.numpy(), atm, lwc)
    print(f"port vs JAX: max |abso| difference "
          f"{np.abs(rt.abso.numpy() - np.asarray(rj.abso)).max():.3e} W/m3")


if __name__ == "__main__":
    main()
