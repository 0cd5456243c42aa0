"""Estimate how long a production-density LUT pass of the port takes on the
card for a scheme that K4 refuses (3_16, 3_24, 3_30, 8_12, 8_16, 8_18: the
general tracer traces them), from a measured rate.

    python tools/torch_lut_pass_estimate.py [3_30 8_16 ...] [--sample 2048] [--rounds 4]

For each scheme it traces a random sample of the production axes' diffuse
entries (one orbit-representative source) and direct entries (source 0, phi
<= 45 as `create_production_lut` traces them) with the general tracer, one
round of 5120 photons each, on the card, and times it.  A pass of `--rounds`
rounds per entry (the staged first pass of `create_lut --preset production
--max-rounds 4`; the adaptive pass takes up to 64) then costs

    rounds x (diffuse entries x representative sources x s per diffuse entry-round
              + direct entries x direct sources x s per direct entry-round)

which it prints with the counts.  The sample is drawn from `--seed`; the
estimate holds as far as the sample's mix of thin and thick entries holds
for the whole grid.  Needs a GPU; imports no JAX."""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("schemes", nargs="*", default=["3_30", "8_16"])
    ap.add_argument("--sample", type=int, default=2048)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU (torch.cuda is unavailable)")

    from tenstream_tpu_torch.boxmc.cuda_tracer import kernel_refusal
    from tenstream_tpu_torch.boxmc.schemes import get_box_scheme
    from tenstream_tpu_torch.optprop import lut as L

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    rng = np.random.default_rng(args.seed)
    diff_entries = L._entry_grid(L.production_axes(False), False)
    dax = L.production_axes(True)
    nphi_lo = (len(dax.phi) + 1) // 2
    dir_entries = L._entry_grid(L.LUTAxes(dax.tau, dax.w0, dax.aspect, dax.g, dax.phi[:nphi_lo],
                                          dax.theta), True)
    for scheme in args.schemes:
        box = get_box_scheme(scheme)
        reps, _ = L._diff_orbits(scheme)
        per = {}
        for kind, entries, src, ldir in (("diffuse", diff_entries, reps[0], False),
                                         ("direct", dir_entries, 0, True)):
            refused = kernel_refusal(scheme, ldir)
            pick = entries[rng.choice(entries.shape[0], args.sample, replace=False)]
            L._trace_entries(scheme, pick[:64], src, ldir, 5120, args.seed, use_kernel=False,
                             max_iter=1500)  # warm-up: first launches and allocations
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            L._trace_entries(scheme, pick, src, ldir, 5120, args.seed + 1, use_kernel=False,
                             max_iter=1500)
            torch.cuda.synchronize()
            per[kind] = (time.perf_counter() - t0) / args.sample
            print(f"{scheme} {kind} source {src}: {args.sample} entries x 5120 photons in "
                  f"{per[kind] * args.sample:.2f} s = {per[kind] * 1e3:.3f} ms per entry-round "
                  f"(general tracer; K4 {'refuses' if refused else 'would take'} it)")
        n_diff = diff_entries.shape[0] * len(reps)
        n_dir = dir_entries.shape[0] * box.ndir
        total = args.rounds * (n_diff * per["diffuse"] + n_dir * per["direct"])
        print(f"{scheme}: a production pass of {args.rounds} rounds = {args.rounds} x "
              f"({diff_entries.shape[0]} diffuse entries x {len(reps)} sources + "
              f"{dir_entries.shape[0]} direct entries x {box.ndir} sources) = "
              f"{total:.0f} s = {total / 3600:.2f} h on one card ({smi})")


if __name__ == "__main__":
    main()
