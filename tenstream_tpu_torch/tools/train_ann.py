"""Train the ANN transfer-coefficient backend on a LUT and save it (the
port of `tools/train_ann.py`; reference `misc/LUT_to_ANN.py`).

    python -m tenstream_tpu_torch.tools.train_ann --lut data/luts/LUT_3_10_production.npz \\
        --out data/ann/ANN_3_10_production.npz [--hidden 128,128,128] [--epochs 150] \\
        [--batch 8192] [--seed 0] [--device cuda|cpu]

Prints the train losses and the off-grid report: mean / max |err| of the
net against the LUT's multilinear interpolation (the port's `OptProp`) on
a cloud of random off-grid samples, for diff2diff (4096 samples) and, at
four fixed off-grid sun positions, dir2dir and dir2diff (1024 each): the
interpolation quality between grid points, not memorisation.  The net is
written in the JAX package's npz layout (`AnnOptProp.save`).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

SUNS = ((12.0, 23.0), (37.0, 48.0), (71.0, 66.0), (84.0, 11.0))


def off_grid_errors(ann, opp, lut, n: int = 4096) -> dict:
    """{"diff2diff" | "dir2dir" | "dir2diff": (mean |err|, max |err|)} of the
    net against the table's interpolation on random off-grid samples
    (`numpy.random.default_rng(1)`, as the JAX tool draws them)."""
    rng = np.random.default_rng(1)
    dev = opp.device
    t = lambda a: torch.as_tensor(a, device=dev)

    def draw(ax, m):
        tau = np.exp(rng.uniform(np.log(ax.tau[0] + 1e-12), np.log(ax.tau[-1]), m))
        w0 = rng.uniform(ax.w0[0], ax.w0[-1], m)
        asp = np.exp(rng.uniform(np.log(ax.aspect[0]), np.log(ax.aspect[-1]), m))
        g = rng.uniform(ax.g[0], ax.g[-1], m)
        return [t(a.astype(np.float32)) for a in (tau, w0, g, asp)]

    out = {}
    args = draw(lut.diff_axes, n)
    err = (opp.diff_coeffs(*args) - ann.diff_coeffs(*args)).abs()
    out["diff2diff"] = (float(err.mean()), float(err.max()))
    args = draw(lut.dir_axes, n // 4)
    errs = {"dir2dir": [], "dir2diff": []}
    for phi, theta in SUNS:
        t_lut, s_lut = opp.dir_coeffs(*args, phi, theta)
        t_ann, s_ann = ann.dir_coeffs(*args, phi, theta)
        errs["dir2dir"].append((t_lut - t_ann).abs().reshape(-1))
        errs["dir2diff"].append((s_lut - s_ann).abs().reshape(-1))
    for name, es in errs.items():
        e = torch.cat(es)
        out[name] = (float(e.mean()), float(e.max()))
    return out


def train(lut_path: str, hidden=(128, 128, 128), epochs: int = 150, batch: int = 8192,
          seed: int = 0, device="cuda", out: str = None, log=print):
    """Train on the table at `lut_path`, report, and save to `out` (if
    given): (net, {"wall": s, "dir_loss", "diff_loss", "errors": ...})."""
    from tenstream_tpu_torch.optprop.ann import AnnOptProp
    from tenstream_tpu_torch.optprop.facade import OptProp
    from tenstream_tpu_torch.optprop.lut import LUT

    lut = LUT.load(lut_path, device=device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    ann = AnnOptProp(lut, hidden=tuple(hidden), epochs=epochs, batch=batch, seed=seed,
                     device=device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log(f"trained in {wall:.1f}s: dir_loss {ann.dir_loss:.3e} diff_loss {ann.diff_loss:.3e}")
    errors = off_grid_errors(ann, OptProp(lut, device=device), lut)
    for name, (mean, mx) in errors.items():
        log(f"{name} off-grid vs LUT-interp: mean |err| {mean:.3e} max {mx:.3e}")
    if out is not None:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        ann.save(out)
        log(f"saved -> {out} ({os.path.getsize(out) / 1e3:.1f} kB)")
    return ann, dict(wall=wall, dir_loss=ann.dir_loss, diff_loss=ann.diff_loss, errors=errors)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lut", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--hidden", default="128,128,128")
    ap.add_argument("--epochs", type=int, default=150)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="where the net trains (cuda or cpu)")
    args = ap.parse_args(argv)
    train(args.lut, tuple(int(h) for h in args.hidden.split(",")), args.epochs, args.batch,
          args.seed, args.device, args.out)


if __name__ == "__main__":
    main()
