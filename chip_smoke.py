#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`tenstream_tpu_torch`) once on an NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printing its lines; any failure raises (non-zero exit):

  1. device   -- requires CUDA; prints the card's name and power limit.
  2. build    -- builds the kernels (csrc/) and times it; then `nvcc
                 -Xptxas -v` on each CUDA source prints every kernel's
                 registers, shared memory and spills.  Phases 25-28, which
                 launch no kernel, and phase 32 run meanwhile.
  3. kernels  -- K1 fused_A_dots, K2 orbit_contract and K3
                 diffuse_apply_dense (float32 and bfloat16 coefficients)
                 against their plain PyTorch versions on the card, at their
                 paths' shapes and at odd and tiny batched shapes: K1 and K2
                 at the spectral path's band chunk (B = 8, the 24 layers of
                 the collapsed solve grid) and at a single band of 39 layers;
                 times them, their plain versions and, beside K2 and K3, the
                 one einsum that computes the contraction each contains; K3 also
                 at the urban spectral path's band chunk (B = 8, 56 layers) and at
                 ragged shapes, each call right after a NaN-filled block of
                 its output's size was freed (a face K3 never writes shows),
                 with its launch configuration (threads, shared memory,
                 blocks per SM).
  4. cloud    -- the single-band cloud path (orbit coefficients, K1 and K2): the 3_10
                 PprtsSolver on a 100 m LES column (bench.py's vertical
                 structure, nz = 39) at 256 x 256 columns with the
                 production LUT: a cold solar+thermal solve, then a warm
                 re-solve of the cloud field rolled by one cell.  Checks
                 finite results, res <= 1.5 tol, and that both kernels ran.
  5. parity   -- the same scene at 64 x 64 through the kernels and through
                 the plain versions on the card: fluxes within 0.1 W/m2,
                 absorption within 1e-4 W/m3.
  6. urban    -- the urban path (buildings force dense coefficients, K3):
                 256 x 256 columns of 20 m, 40 layers of 10 m, clear air, a
                 street grid of building blocks made from --seed, solar +
                 thermal cold, then warm with the sun moved by a few
                 degrees.  Checks finite results, res <= 1.5 tol, shadows
                 under the buildings, the face fluxes, and that K3 ran and
                 K1/K2 did not.
  7. urban parity -- the urban scene at 64 x 64 through K3 and through its
                 plain version, same gates and the same iteration counts.
  8. dense vs orbit -- the 64 x 64 cloud scene with
                 pprts_orbit_coeffs=False (K3's path) against the orbit
                 solve (K1/K2's path), same gates.
 12. spectral -- the main path, bench.py's run through the port: ecCKD
                 32 + 32 g-points on bench.py's scene (its z grid of 39
                 layers, its cloud field from --seed) at 256 x 256 columns,
                 the production LUT, sun (120, 40), albedo 0.15, band chunks
                 of 8 solved as one batch through K1/K2, atm_collapse over
                 the leading 1-D layers (16: a solve grid of 24 layers) and
                 the f32 warm cache: a cold solve, an identical warm re-solve
                 and a perturbed step (the cloud field rolled one cell).
                 Prints each solve's wall, its K1/K2
                 launches, columns/s of the perturbed step, niter and
                 res/tol per chunk and the broadband fluxes; checks finite
                 results, res <= 1.5 tol and niter < 3000 in every lane, TOA
                 edir = sum of the solar weights x mu within 1%, both kernels
                 launched, heating rates (abso2hr) finite, and below 100 K/day
                 in every cell but the cloud tops (cloud under clear air,
                 which cool by about 100 K/day; printed).
 13. spectral parity -- the same spectral solve at 64 x 64 through the
                 kernels and through their plain versions: fluxes within 0.1
                 W/m2, absorption within 1e-4 W/m3, the same niter per band.
  9. profile  -- (run after 12 and 13) the warm re-solve of each path again:
                 the single-band cloud and urban solves and the spectral solve
                 of phase 12's solver: host time per stage, then under
                 torch.profiler the device busy share and the kernels with the
                 most device time.
 14. urban spectral -- this slice's path: buildings inside specint_pprts.
                 Phase 6's street grid (its solid mask) at the bottom of the
                 standard atmosphere: 40 layers of 10 m under 16 geometric
                 layers to 20 km (56), 256 x 256 columns of 20 m, faces at
                 300 K (Buildings.temp), ecCKD 32 + 32 in chunks of 8 through
                 K3 (dense coefficients, no atm_collapse), the f32 warm cache:
                 a cold call, an identical warm call, the sun moved to
                 (253, 37), and the sun moved back under torch.profiler.
                 Prints walls, columns/s, niter per chunk, launches, peak
                 memory, K3's time, bound and einsum at the chunk's shape and
                 the device busy share; checks every lane converged, finite
                 fields, TOA edir = sum of the solar weights x mu within 1%,
                 phase 6's shadow and face checks (the open columns against
                 the direct beam at the box's top, the faces' emission the sum
                 of the per-g-point Planck at 300 K), K3 launched, K1/K2 not.
 15. urban spectral parity -- the same at 64 x 64 through K3 and through its
                 plain version: fluxes 0.1 W/m2, absorption 1e-4 W/m3, face
                 fluxes 0.1 W/m2, every band's niter equal.
 16. options  -- the McICA draws (threefry) on the card against the same
                 draws on the CPU (sha256), then at 32 x 32 (the 8_10 solve at
                 64 x 64), each through the kernels and through their plain
                 versions with phase 13's gates: McICA on bench.py's scene with
                 a partial cloud fraction, three steps of the adaptive spectral skip (equal
                 skip counts), one 8_10 solve on the committed production
                 table through K1/K2.
 17. terrain  -- ex_pprts_hill.py's Gaussian hill at 64 x 64 columns of 100 m
                 (20 sigma layers) with pprts_geometric_coeffs, kernels
                 against plain; the slope-corrected surface direct beam
                 brightens the flank facing the sun and dims the other.
 18. gas optics -- phase 12's scene, solver and options at 128 x 128 with the
                 other spectra, a fresh solver each: RRTMG_SW's 112 solar
                 g-points with ecCKD's 32 longwave ones (two specint_pprts
                 calls per step: milestone config (3)) and repwvl 15 + 15;
                 a cold and a perturbed step.  Prints walls, columns/s, K1/K2
                 launches, niter per chunk and peak memory; phase 12's gates
                 (lanes converged, TOA edir, heating rates) and K1/K2
                 launched.
 19. oned     -- the 1-D solvers: 2str columns through specint_pprts with
                 RRTMG_SW + ecCKD LW on phase 18's scene at 256 x 256; a
                 Schwarzschild (thermal) and a DISORT (8 streams per
                 hemisphere, solar + thermal) solve of phase 4's band at
                 256 x 256; DISORT through specint_pprts with ecCKD 32 + 32 at
                 64 x 64.  Prints walls, peak memory, a batched inverse of
                 the band's 8x8 operators and (not gated) 2str against 3_10
                 (phase 18's field at 128 x 128) and DISORT against 2str; gates finite fields, TOA edir, and
                 each call on an 8 x 8 crop on the card against the CPU
                 (fluxes within 5e-5 of their magnitude, absorption 1e-4
                 W/m3), with DISORT's TF32 control printed beside it.
 20. gas optics parity -- phase 18's two spectra at 32 x 32 through K1/K2
                 and through their plain versions: phase 13's gates (RRTMG_SW
                 without its ecCKD longwave, which phase 13 holds).
 21. kernels by scheme -- K1, K2 and K3 (float32 and bfloat16) of every
                 instantiation (the table sets of cuda_ops.ORBIT_SCHEMES: 3_10,
                 3_6, 8_12, 3_16, 8_18, 3_24, 3_30) against their plain
                 versions, at one band of 39 layers at 256 x 256, at a
                 ragged batched shape and (K1, K2) at phase 24's band chunk
                 (4, the 24 layers of the collapsed grid, 256 x 256), timed
                 there too; at the band each one's time, bound,
                 plain time and (K2, K3) the one einsum; each instantiation's
                 registers, shared memory and spills (phase 2's ptxas lines)
                 and K3's launch configuration.
 22. schemes  -- the other cube schemes (3_6, 3_16, 3_24, 3_30, 8_12, 8_16,
                 8_18), each on its committed test table (tests/data/luts/,
                 the JAX package's own scheme-test tables: coarse axes, tau
                 up to 3 and aspect up to 2, so bench.py's cloud and upper
                 layers are clamped), on phase 4's band at 256 x 256 x 39: a
                 cold solar+thermal solve (phase 12 holds the warm path).
                 Prints walls, niter, res/tol, K1/K2
                 launches and peak memory; gates finite results, res <= 1.5
                 tol, niter < 3000, K1 and K2 launched (K3 not), and the
                 JAX end-to-end energy balance of the solar part within 6%
                 of the incoming beam.
 23. schemes parity -- each of those schemes on the 64 x 64 cloud scene
                 through K1/K2, through their plain versions and on dense
                 coefficients through K3: fluxes within 0.1 W/m2, absorption
                 within 1e-4 W/m3, iterations per sub-solve within 4 of
                 the plain versions' and within 12 of the orbit solve's
                 (printed; NITER_SLACK says why not equal).
 24. spectral 3_30 -- phase 12's full-spectrum run (ecCKD 32 + 32, bench.py's
                 scene at 256 x 256 x 39, atm_collapse 16, specint_cache
                 f32) on a 3_30 solver with its test table in band chunks of
                 4 (at 8 the cold call does not fit the card): a cold call;
                 wall, columns/s, niter per chunk,
                 K1/K2 launches, peak memory; phase 12's gates, with every
                 cloud cell exempt from the heating-rate bound where the
                 clouds' solar w0 lies above the table's w0 axis (printed):
                 the test table's axes end at w0 0.9, so its clouds absorb
                 some 200-400 K/day, as the JAX package's do on the same
                 table (tools/torch_heating_rates.py --lut).
 25. wedge    -- the structured wedge solver (PlexrtSolver 5_8, plain PyTorch: no
                 kernel) on the committed full-density table, phase 4's band on both
                 orientations of a fish mesh at 256 x 256 (131,072 triangle columns)
                 on bench.py's 39 layers, sun (120, 40), albedo 0.15: a solar and a
                 thermal solve on the solvers' defaults, twice, the second profiled (walls,
                 niter, res/tol, peak memory, busy share and launches; the balance is
                 printed, not gated: the defaults do not solve this column, in the JAX
                 package either, tools/torch_wedge_column.py), then on WEDGE_EXACT
                 (the solvers' own options n_inner 128, fixed point): converged below
                 diff_iters, TOA edir = 1000 mu within 1e-5, the solar energy balance
                 within 1% of the incoming beam; then 18_8 on its test table at 64 x 64,
                 held to the same; K1-K4 never launched.
 26. wedge spectral -- specint_plexrt with ecCKD 32 + 32 on phase 25's mesh with
                 bench.py's cloud field on both orientations, WEDGE_EXACT, band chunks
                 of 8: one cold call (no perturbed step: without a warm start it
                 repeats the cold call's work): wall, triangle columns/s, niter per
                 chunk, peak memory; every lane converged, TOA edir within 1% of the
                 sum of the solar weights x mu, heating rates below 100 K/day outside
                 cloud tops; the first thermal chunk profiled over 25 steps.
 27. wedge ICON -- trimesh_from_structured(256, 256) written as an ICON grid file and
                 read back (topology equal), PlexrtSolverIcon on phase 25's scene as in
                 phase 25 (the balance with the direct and diffuse outflow through the
                 open boundary counted), NCA; rotating mesh and sun together at 16 x 16
                 leaves every flux within the JAX test's gates; both wedge solvers on an
                 8 x 8 crop on the card against the CPU, monochromatic and through
                 specint_plexrt (max_gpt 8: the fish solver's solar and thermal lanes
                 on the fixed point; the ICON solver's 8 solar lanes on BiCGStab at
                 16 x 16, where every one of them converges), within 5e-5 of the
                 largest flux and 1e-4 W/m3.
 28. wedge tables -- wedge table creation with the wedge photon tracer (plain
                 PyTorch: no TPU kernel lies on it): (a) create_wedge_lut at apex
                 (0.5, 0.866) on axes of two values each (three phi) at 400 photons,
                 on the card and on the CPU from one seed: every coefficient within
                 two photons' weight + 1e-5, the count that differs at all printed;
                 (b) the ICON user's table, wedge_lut_for_mesh(trimesh_equilateral(
                 256, 256, 100), n_photons=2000) traced on the card: wall, photons/s,
                 photon-steps/s, the live share per step, peak memory, the busy share
                 (on its diffuse sources, profiled), finite rows within 1; (c)
                 PlexrtSolverIcon on that mesh with (b)'s table on phase 25's scene
                 and WEDGE_EXACT: converged, TOA edir, the solar balance with the
                 lateral escape within 1%, and (not gated) the flux difference from
                 the canonical test table of the same axes; (d) WedgeOptPropShaped
                 from wedge_optprop_for_mesh (four corner tables traced on the card)
                 on a distorted 16 x 16 mesh, card against CPU with phase 19's gates;
                 (e) K1-K4 never launched.
 29. mcdmda   -- the domain Monte Carlo (pprts/mcdmda.py, plain PyTorch: no TPU
                 kernel lies on it) on phase 4's band at 256 x 256 x 39, albedo
                 0.15, sun (120, 40), 2^24 photons (256 per column): (a) wall,
                 photons/s, photon-steps/s, the live share per step, niter,
                 leftover, peak memory, the busy share of its first 32 steps
                 (profiled); its own energy closes within 1%; an 8 x 8 crop with
                 the same key on the card and on the CPU, every tally within 1e-4
                 of its field's largest value and niter equal; K1-K4 never
                 launched; (b) (after 21-24) the solar solves of the same band
                 against it at the JAX tests' tolerances: the 3_10 PprtsSolver on
                 the production LUT through K1/K2 and phase 25's PlexrtSolver 5_8
                 WEDGE_EXACT solve: domain-mean TOA eup within 0.04 x 1000 mu,
                 surface edir + edn within 0.05 x 1000 mu, the correlation of the
                 surface field summed over 4 x 4 columns above 0.8 (3_10; the
                 wedge's printed against the JAX test's 0.85, which the JAX wedge
                 solver misses on this band too: tools/torch_mc_column.py).
 30. ann      -- the ANN coefficient backend (optprop/ann.py): (a) the committed
                 net on the card against the LUT facade on the 512 draws of
                 tests/test_ann.py::test_production_ann_committed (diffuse and
                 dir2diff mean |err| below 0.01, dir2dir within 1e-5); (b)
                 phase 4's band at 256 x 256 x 39 through PprtsSolver(grid,
                 AnnOptProp), solar + thermal, cold and warm with the cloud field
                 rolled one cell: walls, K3 launches (a net has no orbit
                 channels: dense coefficients), peak memory; every lane at res <=
                 1.5 tol and niter < 3000, K3 launched and K1/K2 not, edir equal
                 to the LUT solve's within 1e-4 x edirTOA (the domain-mean edn and
                 eup against the LUT solve printed, not gated); (c) an 8 x 8
                 crop through K3 and through its plain version (equal
                 iterations) and on the CPU (phase 19's gates); (d)
                 tools/train_ann on the production LUT with the committed net's
                 settings (hidden 128,128,128, batch 8192) but 75 epochs of its
                 150: wall, losses, off-grid diff2diff and dir2diff mean |err|
                 against the LUT below 0.01.
 31. decomposed -- the cube solver and the main path over a torch.distributed
                 group (parallel/mesh.py): (a) phase 12's run at 256 x 256 x 39 on
                 a one-rank NCCL group, the solver on a Mesh (every shift a halo
                 exchange, K1 in halo mode, K2 between halo-aware gather and
                 scatter), its cold, identical warm and perturbed steps
                 held to phase 12's: every band's niter equal, fields within
                 0.1 W/m2 and 1e-4 W/m3 (the largest differences printed, and
                 whether they are 0), K1 launched in halo mode only; (b) four
                 processes (this script with --decomposed-rank) in a 2 x 2 gloo
                 group, all on cuda:0 (NCCL takes one rank per card), with blocks
                 of 32 x 32 of the 64 x 64 cloud scene: one solar + thermal band
                 on orbit coefficients (K1/K2) and one on dense ones (K3),
                 through the kernels' halo mode and through their plain
                 versions, each held to this process's one-rank solve and to
                 the other (0.1 W/m2, 1e-4 W/m3, niter within NITER_SLACK); (c)
                 K1 and K3 in halo mode against the periodic launch at the same
                 block (a periodic ring: bit for bit) and against their plain
                 halo versions (another ring), timed beside the periodic
                 launch (K1 at the main path's chunk and at a 128 x 128 block,
                 K3 at one band and at 31 (b)'s block), and K2 at the 128 x 128
                 block.
 32. wedge decomposed -- the wedge solvers over a torch.distributed group
                 (set_mesh; no kernel): (a) on a one-rank NCCL group at full
                 width, phase 25's WEDGE_EXACT band on the 256 x 256 x 39 fish
                 mesh and phase 27's gated ICON solve with NCA, each held bit for
                 bit to that phase's run (niter equal, every field's largest
                 difference 0), then specint_plexrt's first chunk of 8 g-points
                 of each spectrum decomposed, bit for bit the same two chunks
                 of phase 26's call;
                 walls side by side and the exchanges per solve; (b) four
                 processes (this script with --wedge-rank) in a 2 x 2 gloo group
                 on cuda:0 solve phase 25's band at 64 x 64 on the fish mesh
                 (blocks of 32 x 32) and the ICON mesh (2048 cells each), solar
                 and thermal with NCA, held to this process's one-rank solve
                 (0.1 W/m2, 1e-4 W/m3, NCA 1e-4 W/m3, fixed-point niter equal);
                 K1-K4 never launched.
 33. capi     -- the port's C bridge (tenstream_tpu_torch/capi/): the library
                 and demos built with cc; demo_pprts on 3_10 on the card held
                 bit for bit to the same solve through the Python API;
                 tenstream_tpu_torch_specint on bench.py's slab at 256 x 256 x 39
                 (plev, tlev, liquid water in g/kg; ecCKD on the card; 3_10) in
                 the demo's process held bit for bit to bridge.specint called
                 here; walls, peak device memory and K1/K2 launches of both;
                 ecCKD on the card held bit for bit to ecCKD on the host on
                 the slab's 16 x 16 corner.
 10. boxmc    -- K4 boxmc_trace, the BoxMC photon tracer: one launch of 4096
                 entries drawn with --seed from the production diffuse grid
                 for the orbit-representative sources 0 and 2 and one from
                 the production direct grid for direct source 0, with the
                 tau-100 / w0-0.99999 corner swapped into the last 6 rows;
                 each timed (with the lanes' utilisation), repeated
                 (bit-identical), checked for row sums <= 1, and held against
                 its plain version on the same rows (per tally 6e-4: three
                 photons' weight, mean 1e-5; the count of tallies that differ
                 at all is printed): source 0's whole launch, the other two on
                 a launch of their first 1024 rows (without the thick corner,
                 whose ~1e6-step walks set the plain version's time).
 11. lut      -- the LUT generation path end to end: create_production_lut
                 for 3_10 on the production axes with 4 rounds per entry
                 (the staged first pass of `--max-rounds 4`), timed per
                 table, with its own energy gate, row sums <= 1 + 1e-3, and
                 diff2diff against the committed table (99.9% within 5
                 combined standard errors, mean signed difference <= 1e-3);
                 then the 64 x 64 cloud scene solved with the generated and
                 the committed table (edir within 0.1 W/m2); then a resume
                 on mockup axes from a checkpoint directory, which must
                 launch K4 zero times.

With --seed 7 (the default), phases 10 and 11 also hold K4's results (each
launch's tallies and photon-steps, the generated table) against sha256
digests recorded from the earlier K4 design, and phase 3 holds K3's
outputs at every (type, shape) it checks against digests recorded from
the first K3 design: they must be equal bit for bit.

The phases run in the order 1, 25-27, 32, 28 and 29 (a) (while 2 builds), 3-8, 12, 13, 9,
31, 33, 14-24, 29 (b), 30, 10, 11.  Each path resets
the kernel launch counts before it runs and reads them after; the kernels
JSON takes K1's and K2's launches from phase 12 (the main path), K3's from
phase 14 (the urban spectral path, where its entry is timed; its launches on
the ANN path, phase 30 (b), under "launches_ann") and K4's from the LUT pass;
each entry also gives its launches on phase 32 (a)'s decomposed wedge path
("launches_wedge_decomposed", 0) and in phase 33's C-bridge specint
("launches_capi");
two more entries are K1's and K3's halo modes, launched on phase 31 (a) and
31 (b), timed in 31 (c); under "instantiations" K1-K3 list each table set or dof
count with its phase-21 time and bound and its launches (3_10's on the
paths above, the others' in phase 22 for K1/K2 and in phase 23's dense
solves for K3; 3_30's K1/K2 also under "launches_spectral", phase 24's).  The line before the last is a JSON
object describing each kernel; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import glob
import hashlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings

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
NX = NY = 256  # BASELINE.md's LES width: both paths' columns
NZ = 39  # bench.py's vertical structure (the cloud and spectral paths)
K_COLLAPSE = 16  # its leading 1-D layers (dz 350-2521 m >= 2 dx), folded by atm_collapse
NZ_SOLVE = NZ - (K_COLLAPSE - 1)  # the spectral path's solve grid
CHUNK = 8  # bands per batched solve (bench.py's band_chunk)
NGPT = 32  # ecCKD g-points per spectrum (bench.py)
SPECTRAL_SUN = (120.0, 40.0)  # bench.py's sun
HR_MAX = 100.0  # K/day
GAS_SETS = ("rrtmg_sw", "repwvl")  # phase 18's spectra: RRTMG_SW 112 (+ ecCKD 32 LW), repwvl
GAS_N = 128  # columns per side of phase 18
REPWVL_NWVL = 15  # the UCLA-LES offline benchmark's `-specint repwvl` table
DISORT_STREAMS = 8  # per hemisphere (PprtsSolver's `disort_streams` default)
SMALL_N = 32  # columns per side of phases 16's and 20's spectral runs through kernels and plain
CROP = 8  # columns per side of the card-vs-CPU crops (phases 19, 27)
ICON_CROP = 16  # the ICON BiCGStab crop: every lane of its first solar chunk converges there
# card vs CPU on the crops: fluxes within 5e-5 of the field's largest magnitude (the float32
# rounding of the 2str RRTMG_SW + ecCKD crop is 1.5e-5 of it, 1.4e-2 W/m2 against the same code
# in float64: tools/torch_float32_rounding.py), absorption within 1e-4 W/m3
CROP_FLUX_RTOL = 5e-5
CROP_ABSO_ATOL = 1e-4  # W/m3
URBAN_NZ, URBAN_DZ, URBAN_DX = 40, 10.0, 20.0  # the urban path: aspect 0.5, all layers 3-D
URBAN_SKY = 16  # geometric layers from the urban box's top (400 m) to 20 km: all 1-D
URBAN_SPEC_NZ = URBAN_NZ + URBAN_SKY  # the urban spectral path's column
LUT_8_10_PATH = os.path.join(REPO, "data", "luts", "LUT_8_10_production.npz")
URBAN_ALBEDO, BUILDING_ALBEDO, BUILDING_T = 0.15, 0.4, 300.0
SUN = (250.0, 35.0)  # phi, theta [deg]
SUN_MOVED = (253.0, 37.0)  # the urban warm solve's sun
CSRC = "tenstream_tpu_torch/csrc/"
# wrapper name -> (tag, CUDA source, line of the kernel in it, TPU kernel it replaces)
KERNELS = {
    "fused_A_dots": ("K1", CSRC + "orbit_ops.cu", 207, "tenstream_tpu/pprts/pallas_ops.py:264"),
    "orbit_contract": ("K2", CSRC + "orbit_ops.cu", 141, "tenstream_tpu/pprts/pallas_ops.py:100"),
    "diffuse_apply_dense": ("K3", CSRC + "dense_ops.cu", 201,
                            "tenstream_tpu/pprts/pallas_ops.py:64"),
    "boxmc_trace": ("K4", CSRC + "boxmc_ops.cu", 189, "tenstream_tpu/boxmc/pallas_tracer.py:118"),
}
# K4's float32 operations per photon-step, counted from boxmc_ops.cu.  Every
# step does the move: three axis distances 15, their minimum 2, the free path
# 7, travel 1, weight 3, position 6, exit test 1.  A step that does not exit
# also scatters: Henyey-Greenstein 16, azimuth 1, rotation 46, roulette test 1.
# A log, an exp, a sin/cos pair and a square root count one operation each and
# the integer hashes none, so the count is a floor on the work.
K4_FLOPS_MOVE = 35
K4_FLOPS_SCATTER = 64


def k4_flops(nsteps: int, entries: int) -> int:
    """A floor on K4's float32 operations for `nsteps` photon-steps over
    `entries` entries: a photon ends its walk at most once, so at most one
    step per photon (5120 per entry) skips the scattering."""
    exits = min(nsteps, entries * 5120)
    return nsteps * K4_FLOPS_MOVE + (nsteps - exits) * K4_FLOPS_SCATTER
K4_BYTES_PER_ENTRY = 9 * 4 + 13 * 4 + 8  # params row in; [T | S] row and photon-steps out
K4_TALLY_ATOL = 6e-4  # three photons' weight (1 / 5120 each): a rare flip of a comparison
K4_MEAN_ATOL = 1e-5
LUT_ROUNDS = 4
# sha256 of K4's results with --seed 7 (the default), recorded from the earlier K4
# design (one block per entry) before the photon-queue redesign: phase 10's `out` and `steps`
# per source, phase 11's three tables.  The redesigned K4 must give them bit
# for bit: only its scheduling changed, not a photon's arithmetic or the
# order of the sums.
DIGEST_SEED = 7
K4_DIGESTS = {
    "diffuse src 0 out": "59b0df5de40fc72f16ea69e85e2ca7ae3cc3555e7bc8c68052ba6be774baceff",
    "diffuse src 0 steps": "639426a40ca91abb7008f7e7d7603c76dbc795f0e820c3925f8495254ace14db",
    "diffuse src 2 out": "9a3089cb017422b7dab6b280bffddab7c2186f2dd530ae2c2b76b252aab200d4",
    "diffuse src 2 steps": "76f9bb1bd592826efa949e60377d1740162611bcd67b0253e6e7aac3faca5032",
    "direct src 0 out": "477c083ff67ef1cbed86c61e83c1987b7a39598974c735ac242897f7448e0b69",
    "direct src 0 steps": "50777eb294ea1d61be3cd45316083af036b7fc58c36f314beb6f322d9cfa98d2",
}
LUT_DIGESTS = {
    "dir2dir": "5ad6d7bc990928c78b089befe7694a8ed83b4249e7f24c71f993ceeface1827f",
    "dir2diff": "d497d376c61bb167543f7cfbdccb34b5416f0eb184267db202966515f87eefac",
    "diff2diff": "1b4a534250dbf4408aefc7f3d1775717d4f848bb8233520fc0ddf6c55670d641",
}
# K3's phase-3 cases (B, nz, nx, ny): odd and ragged shapes (nx, ny not multiples of
# the tile or of the vector width, nz = 1, B = 3), one band of the urban path, the urban
# spectral path's band chunk
K3_CASES = ((2, 5, 6, 10), (3, 7, 13, 130), (1, 1, 9, 67), (1, URBAN_NZ, NX, NY),
            (CHUNK, URBAN_SPEC_NZ, NX, NY))
# sha256 of K3's outputs on phase 3's inputs with --seed 7, recorded from the first K3
# design (one thread per face and dst dof) before the 2.5-D redesign: the redesigned K3
# must give them bit for bit, since each output is still one chain of float32 multiply-adds
# over the sources in order.
K3_DIGESTS = {
    "f32 B=2 nz=5 nx=6 ny=10":
        "30e1a8764c7025bb896d3478e1e0b0fedea50374f5aeeec93c9e935ba83d91c5",
    "f32 B=3 nz=7 nx=13 ny=130":
        "30b73273f4456e8440029fc25438ca25a429339073bc07f9c90e62baf7b1ff76",
    "f32 B=1 nz=1 nx=9 ny=67":
        "967f44ad45fc33d9dc947f3d8d70c7ad6c3bf65663760eddd36922ba0c8d5449",
    "f32 B=1 nz=40 nx=256 ny=256":
        "44301905dffc2a9d4d9b1d7bf110fba99a84c2e88cbf639fb8cd0117783d127f",
    "f32 B=8 nz=56 nx=256 ny=256":
        "836f26ce7cf771d031b1b747b50cd970cc372b0773c31f38b9d504f4797171cf",
    "bf16 B=2 nz=5 nx=6 ny=10":
        "22f00b2a28d247e3ae190bde1a47e57ec05f0c0110f91f0fd1ba082b9cbb4ba4",
    "bf16 B=3 nz=7 nx=13 ny=130":
        "26e0b5b1f0b137f5d9171082ba236793323bc73249f9c21632e48f407410c1cb",
    "bf16 B=1 nz=1 nx=9 ny=67":
        "aef9c465f0a2871219e93f40253a93f22b4a5719cea2eb51be48676fc824eec1",
    "bf16 B=1 nz=40 nx=256 ny=256":
        "5d6aa73e796c148fd359ae4b023d940490bda5492da67a40b8ddf671474841ea",
    "bf16 B=8 nz=56 nx=256 ny=256":
        "50055738fc31280a21b159ef66a1134e8cf16fd8b7cc94e6317087ded6cc8675",
}


def log(*a):
    print(*a, flush=True)


def sha256(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()


def check_digests(label: str, got: dict, want: dict, seed: int,
                  earlier: str = "the earlier K4") -> None:
    """Hold results against the recorded digests (only for DIGEST_SEED)."""
    if seed != DIGEST_SEED or not want:
        log(f"{label} digests (not checked: seed {seed}): {json.dumps(got)}")
        return
    bad = [k for k in want if got.get(k) != want[k]]
    log(f"{label} digests: {'all equal to ' + earlier if not bad else 'DIFFER in ' + str(bad)}")
    if bad:
        raise AssertionError(f"{label}: results differ from {earlier} ({bad}): "
                             f"{json.dumps(got)}")


def cuda_ms(fn, n: int, repeats: int = 3) -> float:
    """Device time per call of fn: the median over `repeats` runs of n calls
    each (after 3 warm-ups)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(repeats):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(n):
            fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / n)
    return sorted(times)[len(times) // 2]


# ---------------------------------------------------------------------------
# scenes
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


def bench_zlev():
    """bench.py's z grid, TOA -> surface: 24 layers of 100 m over 16
    geometric layers to 20 km."""
    z_low = np.arange(0.0, 24 * 100.0 + 1.0, 100.0)
    z_high = np.geomspace(24 * 100.0 + 250.0, 20e3, 16)
    return np.concatenate([z_high[::-1], z_low[::-1][1:]])


def build_bench_atm(nx: int, ny: int, seed: int):
    """bench.py's `build_scene` through the port: the standard atmosphere on
    bench.py's z grid and its liquid water field (nx * ny / 16 boxes of
    0.1-0.6 g/m3 between 600 m and 2 km), drawn from `seed`."""
    from tenstream_tpu_torch.atm import setup_standard_atmosphere

    atm = setup_standard_atmosphere(z_grid=bench_zlev())
    rng = np.random.default_rng(seed)
    lwc = np.zeros((atm.nlay, nx, ny), np.float32)
    zc = atm.zlev[:-1]
    cloudy = np.where((zc > 600.0) & (zc < 2000.0))[0]
    for _ in range(nx * ny // 16):
        i, j = rng.integers(0, nx), rng.integers(0, ny)
        k = rng.choice(cloudy)
        di, dj = rng.integers(1, 4), rng.integers(1, 4)
        lwc[k:k + 2, i:i + di, j:j + dj] = rng.uniform(0.1, 0.6)
    return atm, lwc


def build_urban_scene(nx: int, ny: int, seed: int):
    """An urban LES box: 40 layers of 10 m over columns of 20 m, clear air
    (kabs 5e-6, ksca 1.5e-5 /m), and a street grid of buildings: every lot
    of 8 x 8 columns holds one block 2..6 columns wide each way and 1..12
    cells high at a random place inside the lot, about a quarter of the
    ground in all.  Faces emit at 300 K.  z index 0 is the top layer."""
    nz = URBAN_NZ
    rng = np.random.default_rng(seed)
    dz = np.full(nz, URBAN_DZ, np.float32)
    kabs = np.full((nz, nx, ny), 5e-6, np.float32)
    ksca = np.full((nz, nx, ny), 1.5e-5, np.float32)
    g = np.zeros((nz, nx, ny), np.float32)
    solid = np.zeros((nz, nx, ny), bool)
    lot = 8
    for i0 in range(0, nx - lot + 1, lot):
        for j0 in range(0, ny - lot + 1, lot):
            wx, wy = rng.integers(2, 7, 2)
            h = rng.integers(1, 13)
            i = i0 + rng.integers(0, lot - wx + 1)
            j = j0 + rng.integers(0, lot - wy + 1)
            solid[nz - h:, i:i + wx, j:j + wy] = True
    zlev = URBAN_DZ * np.arange(nz, -1, -1)
    sigma = 5.670374419e-8
    T = 293.15 - 6.5e-3 * zlev
    planck = (sigma * T ** 4 / np.pi).astype(np.float32)[:, None, None] * np.ones(
        (nx, ny), np.float32)
    bplanck = np.where(solid, sigma * BUILDING_T ** 4 / np.pi, 0.0).astype(np.float32)
    return dz, (kabs, ksca, g, planck), solid, bplanck


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


def ptxas_report(cuda_ops) -> list:
    """nvcc -Xptxas -v on each CUDA source: registers, spills and shared
    memory per kernel.  Each source compiles on its own, beside the build."""
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "nvcc")
    out_dir = os.path.join(cuda_ops.BUILD_DIR, "ptxas")
    os.makedirs(out_dir, exist_ok=True)
    srcs = [s for s in cuda_ops.SOURCES if s.endswith(".cu")]

    def one(src):
        cmd = [nvcc, *cuda_ops.CUDA_FLAGS, "-Xptxas", "-v", "-I", cuda_ops.CSRC, "-c",
               os.path.join(cuda_ops.CSRC, src), "-o", os.path.join(out_dir, src + ".o")]
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if r.returncode:
            raise RuntimeError(f"nvcc failed on {src}:\n{r.stderr[-4000:]}")
        return src, r.stderr

    lines = []
    with concurrent.futures.ThreadPoolExecutor(len(srcs)) as ex:
        for src, err in ex.map(one, srcs):
            fn = None
            for ln in err.splitlines():
                if "Compiling entry function" in ln:
                    fn, spill = ln.split("'")[1], ""
                elif "spill stores" in ln and fn:
                    spill = ln.split(",", 1)[1].strip()
                elif "Used" in ln and "registers" in ln and fn:
                    m = re.search(r"_cu_[0-9a-f]{8}(\d+)", fn)  # <len><name> in the mangling
                    if m:
                        end = m.end() + int(m.group(1))
                        targs = ""  # the template arguments, up to the end of the list
                        if fn[end:end + 1] == "I":
                            stop = fn.find("EEv", end)
                            targs = fn[end:stop + 1] if stop > 0 else fn[end:end + 40]
                        fn = fn[m.end():end] + targs
                    lines.append(f"{src} {fn}: {ln.split(':', 1)[1].strip()}; {spill}")
                    fn = None
    return lines


def phase_build(cuda_ops):
    """Build and load the extension, then the ptxas report: (the report's
    lines, the line on the build's times); the caller logs them."""
    t0 = time.time()
    cuda_ops.load_extension()
    t_ext = time.time() - t0
    lines = ptxas_report(cuda_ops)
    return lines, (f"build: kernels built and loaded in {t_ext:.1f} s, then the ptxas report in "
                   f"{time.time() - t0 - t_ext:.1f} s")


def log_build(built):
    lines, text = built
    log(text)
    for ln in lines:
        log(f"build ptxas {ln}")
    return lines


def _k_inputs(B, nz, nx, ny, norb, seed, nd=10):
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.rand(s, device="cuda", generator=g)
    return (r(B, norb, nz, nx, ny) * 0.1, r(B, nd, nz + 1, nx, ny), r(B, nd, nz + 1, nx, ny),
            r(B, nx, ny) * 0.8, r(B, nd, nz, nx, ny))


def _kernel_cost(cuda_ops, scheme, idx, B, nz, nx, ny, norb):
    """(bytes, flops) each orbit kernel needs: inputs read once, outputs written once."""
    groups = cuda_ops.orbit_groups(idx)
    per_cell = sum(len(ss) + 1 for gd in groups for _, ss in gd)
    nxy, nd = nx * ny, scheme.ndiff
    k1_bytes = 4 * B * (3 * nd * (nz + 1) * nxy + norb * nz * nxy + nxy + 2)
    k1_flops = B * (nz * nxy * per_cell + (nz + 1) * nxy * nd * 5)
    k2_bytes = 4 * B * nz * nxy * (2 * nd + norb)
    k2_flops = B * nz * nxy * per_cell
    return {"fused_A_dots": (k1_bytes, k1_flops), "orbit_contract": (k2_bytes, k2_flops)}


def _report_entry(name, err, ms, plain_ms, nbytes, flops, library_ms=None):
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
    bound = max(tb, tf)
    by = "bytes" if tb >= tf else "operations"
    lib = "" if library_ms is None else f", one einsum {library_ms:.4f} ms"
    log(f"kernels timing {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms{lib}, bound {bound:.4f} ms "
        f"by {by}, {nbytes / 1e9:.3f} GB, {100 * bound / ms:.1f}% of the bound's rate)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=library_ms)


def _orbit_group_tensor(cuda_ops, idx, norb):
    """M[d, o, s] = 1 where source s enters dst d through orbit channel o:
    K2's contraction as one einsum (the yardstick; the port never calls it)."""
    nd = idx.shape[0]
    M = torch.zeros((nd, norb, nd), device="cuda")
    for d, groups in enumerate(cuda_ops.orbit_groups(idx)):
        for o, ss in groups:
            M[d, o, list(ss)] = 1.0
    return M


def phase_kernels(cuda_ops, scheme, idx, nx, ny):
    """K1 and K2 against their plain versions at the main path's shape (a
    band chunk of 8 on the collapsed solve grid), at the single-band cloud
    path's shape and at odd shapes."""
    norb = int(idx.max()) + 1
    report = {}
    for (B, z, x, y, tag) in ((2, 5, 6, 10, "odd"), (3, 1, 1, 1, "tiny"), (1, 7, 33, 65, "odd"),
                              (CHUNK, NZ_SOLVE, nx, ny, "main"), (1, NZ, nx, ny, "single")):
        orb, u, w, alb, src = _k_inputs(B, z, x, y, norb, seed=z + x)
        Au, dots = cuda_ops.fused_A_dots(scheme, idx, orb, u, w, alb)
        Au_p, dots_p = cuda_ops.fused_A_dots_plain(scheme, idx, orb, u, w, alb)
        torch.cuda.synchronize()
        e1 = (Au - Au_p).abs().max().item()
        r1 = ((Au - Au_p).abs() / Au_p.abs().clamp(min=1e-6)).max().item()
        d1 = ((dots - dots_p).abs() / dots_p.abs()).max().item()
        del Au, Au_p
        line = (f"kernels {tag} B={B} nz={z} nx={x} ny={y}: K1 max abs {e1:.3e} rel {r1:.3e}, "
                f"dots rel {d1:.3e}")
        c = cuda_ops.orbit_contract(scheme, idx, orb, src)
        c_p = cuda_ops.orbit_contract_plain(idx, orb, src)
        torch.cuda.synchronize()
        e2 = (c - c_p).abs().max().item()
        r2 = ((c - c_p).abs() / c_p.abs().clamp(min=1e-6)).max().item()
        line += f"; K2 max abs {e2:.3e} rel {r2:.3e}"
        log(line)
        if not (e1 <= FIELD_ATOL and d1 <= DOT_RTOL and e2 <= FIELD_ATOL):
            raise AssertionError(f"kernel disagrees with its plain version at {tag} shape "
                                 f"(field atol {FIELD_ATOL}, dot rtol {DOT_RTOL})")
        cost = _kernel_cost(cuda_ops, scheme, idx, B, z, x, y, norb)
        if tag == "single":  # a single band of 39 layers (the cloud path, phases 4-8)
            for name, fn in (("fused_A_dots", lambda: cuda_ops.fused_A_dots(
                    scheme, idx, orb, u, w, alb)), ("orbit_contract", lambda: cuda_ops.orbit_contract(
                    scheme, idx, orb, src))):
                ms = cuda_ms(fn, 20)
                nbytes = cost[name][0]
                bound = nbytes / HBM_BYTES_PER_S * 1e3
                log(f"kernels timing {name} at B={B} nz={z}: {ms:.4f} ms (bound {bound:.4f} ms by "
                    f"bytes, {nbytes / 1e9:.3f} GB, {100 * bound / ms:.1f}% of the bound's rate)")
                report[name]["single_band_ms"] = ms
                report[name]["single_band_bound_ms"] = bound
        if tag == "main":
            M = _orbit_group_tensor(cuda_ops, idx, norb)
            orb3, src3 = orb.view(B, norb, -1), src.view(B, 10, -1)
            lib = torch.einsum("dos,boc,bsc->bdc", M, orb3, src3)
            lib_err = (lib.view_as(c) - c_p).abs().max().item()
            log(f"kernels K2 yardstick einsum('dos,boc,bsc->bdc') max abs vs plain {lib_err:.3e}")
            del lib
            k1_args, k2_args = (scheme, idx, orb, u, w, alb), (scheme, idx, orb, src)
            report["fused_A_dots"] = _report_entry(
                "fused_A_dots", e1, cuda_ms(lambda: cuda_ops.fused_A_dots(*k1_args), 20),
                cuda_ms(lambda: cuda_ops.fused_A_dots_plain(*k1_args), 5), *cost["fused_A_dots"])
            report["orbit_contract"] = _report_entry(
                "orbit_contract", e2, cuda_ms(lambda: cuda_ops.orbit_contract(*k2_args), 20),
                cuda_ms(lambda: cuda_ops.orbit_contract_plain(idx, orb, src), 5),
                *cost["orbit_contract"],
                cuda_ms(lambda: torch.einsum("dos,boc,bsc->bdc", M, orb3, src3), 5))
            del M, orb3, src3
        del c, c_p
        del orb, u, w, alb, src
    return report


def k3_inputs(B, nz, nx, ny, dtype, seed, nd=10):
    """Phase 3's K3 inputs: coefficients in [0, 0.1) as `dtype`, sources in [0, 1)."""
    g = torch.Generator(device="cuda").manual_seed(seed + nz + nx)
    c = (torch.rand((B, nd, nd, nz, nx, ny), device="cuda", generator=g) * 0.1).to(dtype)
    x = torch.rand((B, nd, nz + 1, nx, ny), device="cuda", generator=g)
    return c, x


def k3_on_nan(cuda_ops, scheme, c, x):
    """K3 right after a NaN-filled block of the output's size was freed: the
    caching allocator hands K3 that block, so a face it never wrote shows
    as NaN."""
    torch.full_like(x, float("nan"))
    return cuda_ops.diffuse_apply_dense(scheme, c, x)


def phase_kernel_dense(cuda_ops, scheme, nx, ny, seed):
    """K3 against its plain version, with float32 and bfloat16 coefficients,
    at K3_CASES: the urban spectral path's band chunk (B = 8, 56 layers: K3's
    main path), the single-band urban path's shape (B = 1, 40 layers) and
    odd and ragged batched shapes; each output's sha256 against K3_DIGESTS.
    The bound counts the coefficient field, x and the result once each.
    Beside it the one PyTorch call that computes the contraction K3
    contains, on sources gathered beforehand and without the scatter: the
    einsum (float32 coefficients only; it is used nowhere in the package).
    The JSON entry is the chunk's float32 reading; the single-band and
    bfloat16 readings ride along under their own keys."""
    nd = scheme.ndiff
    entry, digests, config = {}, {}, {}
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        config[tag] = cfg = cuda_ops.dense_launch_config(dtype)
        log(f"kernels K3 launch {tag}: {cfg['threads']} threads and {cfg['smem_bytes']} bytes of "
            f"shared memory per block, {cfg['blocks_per_sm']} blocks per SM")
        for (B, z, x_, y) in K3_CASES:
            c, x = k3_inputs(B, z, x_, y, dtype, seed)
            out = k3_on_nan(cuda_ops, scheme, c, x)
            ref = cuda_ops.diffuse_apply_dense_plain(scheme, c, x)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            digests[f"{tag} B={B} nz={z} nx={x_} ny={y}"] = sha256(out)
            del out, ref
            log(f"kernels K3 {tag} B={B} nz={z} nx={x_} ny={y}: max abs {err:.3e}")
            if not err <= FIELD_ATOL:
                raise AssertionError(f"K3 ({tag}) disagrees with its plain version "
                                     f"(field atol {FIELD_ATOL})")
            if x_ == nx:
                ms = cuda_ms(lambda: cuda_ops.diffuse_apply_dense(scheme, c, x), 20)
                plain_ms = cuda_ms(lambda: cuda_ops.diffuse_apply_dense_plain(scheme, c, x), 3)
                lib_ms = None
                if dtype == torch.float32:
                    src = cuda_ops.gather_diff_src(scheme, x).contiguous()
                    lib_ms = cuda_ms(lambda: torch.einsum("bsdzxy,bszxy->bdzxy", c, src), 3)
                    del src
                ncell, nface = z * x_ * y, (z + 1) * x_ * y
                nbytes = B * (nd * nd * ncell * c.element_size() + 2 * nd * nface * 4)
                flops = B * 2 * nd * nd * ncell
                entry[tag, B] = _report_entry(
                    f"diffuse_apply_dense ({tag} coefficients, B={B} nz={z})", err, ms, plain_ms,
                    nbytes, flops, lib_ms)
            del c, x
            torch.cuda.empty_cache()
    check_digests("kernels K3", digests, K3_DIGESTS, seed, "the first K3 design")
    report = dict(entry["f32", CHUNK])
    one = entry["f32", 1]
    report.update(single_band_ms=one["ms"], single_band_bound_ms=one["bound_ms"],
                  single_band_library_ms=one["library_ms"], launch_config=config)
    for B, key in ((CHUNK, ""), (1, "single_band_")):
        bf = entry["bf16", B]
        report.update({f"{key}{k}_bf16": bf[k] for k in ("ms", "bound_ms", "max_abs_err")})
    return report


def make_solver(nx, ny, seed, opp, Grid, PprtsSolver, sundir, options=None):
    dz, kabs, ksca, g, planck = build_scene(nx, ny, seed)
    solver = PprtsSolver(Grid.create(dz.size, nx, ny, 100.0, 100.0, dz, device="cuda"), opp,
                         options=options)
    solver.set_angles(sundir)
    return solver, (kabs, ksca, g, planck)


def make_urban_solver(nx, ny, seed, opp, Grid, PprtsSolver, Buildings, sundir):
    dz, fields, solid, bplanck = build_urban_scene(nx, ny, seed)
    solver = PprtsSolver(Grid.create(dz.size, nx, ny, URBAN_DX, URBAN_DX, dz, device="cuda"), opp)
    solver.set_angles(sundir)
    solver.set_buildings(Buildings(solid=solid, albedo=BUILDING_ALBEDO, planck=bplanck))
    return solver, fields, solid


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
        log(f"{label} {kind}: bicgstab {s.niter_bicgstab} + polish {s.niter_polish} "
            f"iterations, res/tol {s.diff_res / s.diff_tol:.4f}, host syncs {s.host_syncs}, "
            f"wall {ms:.1f} ms, launches K1 {launches['fused_A_dots']} "
            f"K2 {launches['orbit_contract']} K3 {launches['diffuse_apply_dense']}")
    for name, a in (("edir", edir), ("edn", edn), ("eup", eup), ("abso", abso)):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{label}: non-finite {name}")
    log(f"{label} fluxes [W/m2]: TOA edir {edir[0].mean().item():.3f} edn "
        f"{edn[0].mean().item():.3f} eup {eup[0].mean().item():.3f}; surface edir "
        f"{edir[-1].mean().item():.3f} edn {edn[-1].mean().item():.3f} eup "
        f"{eup[-1].mean().item():.3f}; abso mean {abso.mean().item():.4e} W/m3")
    iters = (sol.niter_bicgstab, sol.niter_polish, sol.thermal.niter_bicgstab,
             sol.thermal.niter_polish)
    return (edir, edn, eup, abso), iters


def _compare_solves(label, outs):
    errs = [(a - b).abs().max().item() for a, b in zip(*outs)]
    log(f"{label}: max abs edir {errs[0]:.3e} edn {errs[1]:.3e} eup {errs[2]:.3e} W/m2, "
        f"abso {errs[3]:.3e} W/m3")
    if max(errs[:3]) > FLUX_ATOL or errs[3] > ABSO_ATOL:
        raise AssertionError(f"{label}: the solves differ (flux atol {FLUX_ATOL}, abso atol "
                             f"{ABSO_ATOL})")


def phase_main(cuda_ops, opp, Grid, PprtsSolver, sundir, seed):
    solver, fields = make_solver(NX, NY, seed, opp, Grid, PprtsSolver, sundir)
    torch.cuda.reset_peak_memory_stats()
    cuda_ops.reset_launch_counts()
    t0 = time.time()
    solve_and_report(solver, fields, cuda_ops, "main cold")
    kabs, ksca, g, planck = fields
    rolled = tuple(np.roll(a, 1, axis=1) for a in (kabs, ksca, g)) + (planck,)
    solve_and_report(solver, rolled, cuda_ops, "main warm")
    launches = dict(cuda_ops.LAUNCHES)
    log(f"main: cold + warm at {NX}x{NY}x{NZ} in {time.time() - t0:.1f} s wall; "
        f"launches {launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    for name in ("fused_A_dots", "orbit_contract"):
        if launches[name] == 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    return launches


def check_urban(solver, solid, outs, label, fluxes=None, B_face=None, box_top=0):
    """Shadows under the buildings, sun in the open, and the face fluxes:
    `fluxes` (default `solver.get_building_fluxes()`) against the faces'
    emission B_face (default the static `Buildings.planck`).  The open
    columns are held to the direct irradiance at the urban box's top,
    level `box_top`."""
    edir = outs[0]
    cols = torch.as_tensor(solid.any(axis=0), device=edir.device)
    under = edir[-1][cols].max().item()
    clear = edir[box_top].mean().item()
    lit = edir[-1][~cols].max().item()
    log(f"{label}: {100 * solid.any(axis=0).mean():.1f}% of the columns hold a building; surface "
        f"edir under them at most {under:.3e} W/m2, in the open up to {lit:.1f} of {clear:.1f} "
        "W/m2 at the box's top")
    if not under < 1.0:
        raise AssertionError(f"{label}: direct irradiance {under} W/m2 under a solid column")
    if not lit > 0.9 * clear:
        raise AssertionError(f"{label}: no open column sees 90% of the clear direct irradiance")
    from tenstream_tpu_torch.pprts.buildings import face_masks

    b = solver._buildings
    fl = solver.get_building_fluxes() if fluxes is None else fluxes
    B_face = b.planck if B_face is None else B_face
    for kind, m in face_masks(b).items():
        f = fl[kind]
        for q in ("edir", "incoming", "outgoing"):
            if not bool(torch.isfinite(f[q]).all()):
                raise AssertionError(f"{label}: non-finite {q} on {kind} faces")
        want = torch.where(m, b.albedo * f["incoming"] + (1.0 - b.albedo) * np.pi * B_face,
                           torch.zeros_like(f["incoming"]))
        err = (f["outgoing"] - want).abs().max().item()
        if err > 1e-3 * max(1.0, want.abs().max().item()):
            raise AssertionError(f"{label}: outgoing != albedo incoming + (1 - albedo) pi B on "
                                 f"{kind} faces (max abs {err})")
    roof, wall = fl["roof"], fl["wall_x_low"]
    nroof = int(face_masks(b)["roof"].sum())
    log(f"{label} face fluxes [W/m2]: {nroof} roof faces, mean incoming "
        f"{roof['incoming'].sum().item() / nroof:.1f} (direct {roof['edir'].sum().item() / nroof:.1f}"
        f"), mean outgoing {roof['outgoing'].sum().item() / nroof:.1f}; x-low walls incoming up to "
        f"{wall['incoming'].max().item():.1f}")


def phase_urban(cuda_ops, opp, Grid, PprtsSolver, Buildings, sundir_from_angles, seed):
    solver, fields, solid = make_urban_solver(NX, NY, seed, opp, Grid, PprtsSolver, Buildings,
                                              sundir_from_angles(*SUN))
    torch.cuda.reset_peak_memory_stats()
    cuda_ops.reset_launch_counts()
    t0 = time.time()
    outs, _ = solve_and_report(solver, fields, cuda_ops, "urban cold", albedo=URBAN_ALBEDO)
    check_urban(solver, solid, outs, "urban cold")
    solver.set_angles(sundir_from_angles(*SUN_MOVED))
    outs, _ = solve_and_report(solver, fields, cuda_ops, "urban warm", albedo=URBAN_ALBEDO)
    check_urban(solver, solid, outs, "urban warm")
    launches = dict(cuda_ops.LAUNCHES)
    log(f"urban: cold + warm at {NX}x{NY}x{URBAN_NZ} in {time.time() - t0:.1f} s wall; "
        f"launches {launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    if launches["diffuse_apply_dense"] == 0:
        raise AssertionError("kernel diffuse_apply_dense was not launched on the urban path")
    if launches["fused_A_dots"] or launches["orbit_contract"]:
        raise AssertionError("the urban path launched an orbit kernel")
    return launches


def phase_profile(resolve, label, stages_of, top=12, warm=False, window=False):
    """Where the time of a warm re-solve goes.  `resolve(i)` changes the
    scene a little (i odd) or back (i even), re-solves from the cached
    solution (after one unmeasured re-solve unless the solver is `warm`
    already) and returns a line on its iterations: once with each stage
    (`stages_of`: (owner, attribute name) pairs) timed on the host around a
    synchronise, then (changed back) under torch.profiler, whose kernel
    durations give the device busy time and the kernels with the most
    device time (`window`: resolve(2) solves a part of what resolve(1)
    does, and the busy share is of its own wall)."""
    def timed_resolve(i):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        text = resolve(i)
        torch.cuda.synchronize()
        return text, (time.perf_counter() - t0) * 1e3

    if not warm:
        timed_resolve(0)
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

    saved = [(owner, n, getattr(owner, n)) for owner, n in stages_of]
    for owner, n, fn in saved:
        setattr(owner, n, timed(n, fn))
    try:
        text, wall_ms = timed_resolve(1)
    finally:
        for owner, n, fn in saved:
            setattr(owner, n, fn)
    other = wall_ms - sum(stages.values())
    log(f"profile {label}: stages of the warm re-solve (wall {wall_ms:.1f} ms, {text}): "
        + ", ".join(f"{n} {ms:.1f} ms" for n, ms in stages.items()) + f", other {other:.1f} ms")

    (text_p, wall_prof_ms), by_name = device_kernels(lambda: timed_resolve(2))
    busy_ms = sum(t for t, _ in by_name.values())
    if busy_ms == 0:
        log(f"profile {label}: the profiler recorded no device time; device busy share not "
            "measured")
        return
    if window:  # the profiled re-solve is a part of the timed one: its share is of itself
        share = f"{100 * busy_ms / wall_prof_ms:.1f}% of the profiled wall {wall_prof_ms:.1f} ms"
    else:
        share = (f"{100 * busy_ms / wall_ms:.1f}% of the unprofiled wall {wall_ms:.1f} ms "
                 f"(profiled wall {wall_prof_ms:.1f} ms)")
    log(f"profile {label} device: busy {busy_ms:.1f} ms in "
        f"{sum(n for _, n in by_name.values())} kernels = {share}; {text_p}")
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        log(f"profile {label}   {t:9.2f} ms {n:6d} launches  {name[:100]}")


def device_kernels(fn):
    """fn() under torch.profiler, tracing the device only: (its result,
    {kernel name: (device ms, launches)}).  The trace's raw events are read
    directly: building the profiler's event tree for a spectral call's
    ~400k kernels takes minutes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            t, n = by_name.get(e.name(), (0.0, 0))
            by_name[e.name()] = (t + (e.end_ns() - e.start_ns()) / 1e6, n + 1)
    return out, by_name


def _solver_stages():
    import tenstream_tpu_torch.pprts.solver as solver_mod

    names = ("assemble_coeffs", "mask_coeffs", "solve_edir", "building_sources",
             "thermal_source", "solve_bicgstab", "solve_richardson", "calc_flx_div")
    return [(solver_mod, n) for n in names]


def _mono_iters(sol) -> str:
    return f"bicgstab {sol.niter_bicgstab}+{sol.thermal.niter_bicgstab} iterations"


def profile_main(opp, Grid, PprtsSolver, sundir, seed):
    """As in phase 4, the cloud field is rolled by one cell and back."""
    solver, (kabs, ksca, g, planck) = make_solver(NX, NY, seed, opp, Grid, PprtsSolver, sundir)

    def resolve(i):
        solver.set_optical_properties(
            0.15, *(np.roll(a, i % 2, axis=1) for a in (kabs, ksca, g)), planck=planck)
        return _mono_iters(solver.solve(lthermal=True, lsolar=True, edirTOA=1000.0))

    phase_profile(resolve, f"cloud {NX}x{NY}x{NZ} solar+thermal", _solver_stages())


def profile_urban(opp, Grid, PprtsSolver, Buildings, sundir_from_angles, seed):
    """As in phase 6, the sun moves by a few degrees and back."""
    solver, fields, _ = make_urban_solver(NX, NY, seed, opp, Grid, PprtsSolver, Buildings,
                                          sundir_from_angles(*SUN))
    kabs, ksca, g, planck = fields
    solver.set_optical_properties(URBAN_ALBEDO, kabs, ksca, g, planck=planck)

    def resolve(i):
        solver.set_angles(sundir_from_angles(*(SUN_MOVED if i % 2 else SUN)))
        return _mono_iters(solver.solve(lthermal=True, lsolar=True, edirTOA=1000.0))

    phase_profile(resolve, f"urban {NX}x{NY}x{URBAN_NZ} solar+thermal", _solver_stages())


def profile_spectral(spec):
    """Phase 12's solver: the cloud field rolled by one cell and back, a
    warm re-solve of the whole spectrum (timed by stages), then of one
    chunk of each spectrum (profiled)."""
    import tenstream_tpu_torch.spectral.specint as specint_mod
    from tenstream_tpu_torch.pprts.solver import PprtsSolver
    from tenstream_tpu_torch.spectral.ecckd import EcckdGasOptics

    solver, atm, lwc, gas = spec

    def resolve(i):
        # the profiled re-solve (i = 2) takes one chunk of each spectrum: the whole spectrum
        # puts ~150k kernels into the trace
        specint_mod.specint_pprts(solver, atm, albedo=0.15, lthermal=True, lsolar=True,
                                  specint=gas, lwc=np.roll(lwc, i % 2, axis=1),
                                  band_chunk=CHUNK, bands=(0, CHUNK) if i == 2 else None)
        it = [n for (_, g), n in _band_niters(solver).items() if i != 2 or g < CHUNK]
        return (f"{len(it)} bands, niter sum {sum(it)}, max {max(it)}"
                + (f"; profiled: g-points 0-{CHUNK - 1} of each spectrum" if i == 2 else ""))

    stages = _solver_stages() + [(PprtsSolver, "_collapse"), (specint_mod, "delta_scale"),
                                 (EcckdGasOptics, "solar"), (EcckdGasOptics, "thermal"),
                                 (EcckdGasOptics, "cloud_optprops_gpt")]
    # phase 12's solver holds the perturbed step's states: resolve(1) is a one-cell change
    phase_profile(resolve, f"spectral {NX}x{NY}x{NZ} ecCKD {NGPT}+{NGPT}", stages, warm=True,
                  window=True)


@contextlib.contextmanager
def kernels_or_plain(cuda_ops, ediff, plain: bool):
    """Run the block on the kernels K1-K3 or (plain) on their plain PyTorch
    versions, on the card either way."""
    saved = (ediff.fused_A_dots, cuda_ops.orbit_contract, ediff.diffuse_apply_dense)
    if plain:
        ediff.fused_A_dots = (lambda scheme, idx, orb, u, w, alb:
                              cuda_ops.fused_A_dots_plain(scheme, idx, orb, u, w, alb))
        cuda_ops.orbit_contract = (lambda scheme, idx, orb, src:
                                   cuda_ops.orbit_contract_plain(idx, orb, src))
        ediff.diffuse_apply_dense = cuda_ops.diffuse_apply_dense_plain
    try:
        yield
    finally:
        ediff.fused_A_dots, cuda_ops.orbit_contract, ediff.diffuse_apply_dense = saved


def phase_parity(cuda_ops, ediff, opp, Grid, PprtsSolver, sundir, seed):
    """64x64 cloud scene through K1/K2, then through their plain versions."""
    outs = []
    for plain in (False, True):
        solver, fields = make_solver(64, 64, seed, opp, Grid, PprtsSolver, sundir)
        with kernels_or_plain(cuda_ops, ediff, plain):
            outs.append(solve_and_report(solver, fields, cuda_ops,
                                         "parity plain" if plain else "parity kernels")[0])
    _compare_solves(f"parity 64x64x{NZ} kernels vs plain", outs)


def phase_urban_parity(cuda_ops, ediff, opp, Grid, PprtsSolver, Buildings, sundir, seed):
    """64x64 urban scene through K3, then through its plain version."""
    outs, iters = [], []
    for plain in (False, True):
        solver, fields, _ = make_urban_solver(64, 64, seed, opp, Grid, PprtsSolver, Buildings,
                                              sundir)
        with kernels_or_plain(cuda_ops, ediff, plain):
            o, it = solve_and_report(solver, fields, cuda_ops,
                                     "urban parity plain" if plain else "urban parity kernel",
                                     albedo=URBAN_ALBEDO)
        outs.append(o)
        iters.append(it)
    _compare_solves(f"urban parity 64x64x{URBAN_NZ} K3 vs plain", outs)
    if iters[0] != iters[1]:
        raise AssertionError(f"urban parity: iteration counts differ, {iters[0]} vs {iters[1]}")


def phase_dense_vs_orbit(cuda_ops, opp, Grid, PprtsSolver, Options, sundir, seed):
    """64x64 cloud scene on dense coefficients (K3) and on orbit
    coefficients (K1/K2): the two kernel families against each other."""
    outs = []
    for dense in (True, False):
        opts = Options({"pprts_orbit_coeffs": False}, read_env=False) if dense else None
        solver, fields = make_solver(64, 64, seed, opp, Grid, PprtsSolver, sundir, options=opts)
        outs.append(solve_and_report(solver, fields, cuda_ops,
                                     "dense-vs-orbit " + ("dense" if dense else "orbit"))[0])
    _compare_solves(f"dense vs orbit 64x64x{NZ}", outs)


def make_spectral_solver(nx, ny, seed, opp, cache="f32"):
    """bench.py's scene and solver set-up through the port: atm_collapse over
    the leading run of 1-D layers, the warm cache `cache`."""
    from tenstream_tpu_torch.core.config import Options
    from tenstream_tpu_torch.pprts.grid import Grid
    from tenstream_tpu_torch.pprts.solver import PprtsSolver
    from tenstream_tpu_torch.pprts.sun import sundir_from_angles
    from tenstream_tpu_torch.spectral.ecckd import EcckdGasOptics

    atm, lwc = build_bench_atm(nx, ny, seed)
    grid = Grid.create(atm.nlay, nx, ny, 100.0, 100.0, atm.dz.astype(np.float32), device="cuda")
    solver = PprtsSolver(grid, opp, options=Options({"specint_cache": cache}, read_env=False))
    l1d = np.asarray(solver._l1d, bool)
    K = int(np.argmin(l1d)) if not l1d.all() else len(l1d)
    if K != K_COLLAPSE:
        raise AssertionError(f"bench.py's column has {K} leading 1-D layers, expected "
                             f"{K_COLLAPSE}")
    solver.options.set("atm_collapse", K)
    solver.set_angles(sundir_from_angles(*SPECTRAL_SUN))
    return solver, atm, lwc, EcckdGasOptics(n_gpt=NGPT)


def _band_niters(solver) -> dict:
    """{(spectrum, band): niter} of the last spectral call."""
    out = {}
    for tag, rows in solver._band_rows.items():
        for gid, (key, row) in rows.items():
            sol = solver.solutions.get(key)
            if sol is not None:
                out[(tag, gid)] = sol.niter_diff[row]
    return out


def spectral_solve(spec, lwc, cuda_ops, label, report_chunks=True, gas=None, lsolar=True,
                   lthermal=True, chunk=CHUNK, **kw):
    """One spectral call through `specint_pprts` (`kw`: its other inputs;
    `gas` in place of the spec's backend): its wall, its kernel launches,
    the per-chunk iterations and the lane checks."""
    from tenstream_tpu_torch.spectral import specint_pprts

    solver, atm, _, spec_gas = spec
    before = dict(cuda_ops.LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = specint_pprts(solver, atm, albedo=0.15, lthermal=lthermal, lsolar=lsolar,
                        specint=spec_gas if gas is None else gas, lwc=lwc, band_chunk=chunk,
                        **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: cuda_ops.LAUNCHES[k] - before[k] for k in before}
    niters = []
    for key, sol in sorted(solver.solutions.items(), key=str):
        n, r, t = sol.niter_diff, sol.diff_res, sol.diff_tol
        niters += n
        bad = [i for i in range(len(n)) if not (r[i] <= 1.5 * t[i]) or n[i] >= 3000]
        if report_chunks:
            log(f"{label} chunk {key}: niter min/med/max = {min(n)}/{int(np.median(n))}/{max(n)}, "
                f"res max = {max(r):.3e} (tol {max(t):.3e}), max res/tol "
                f"{max(a / b for a, b in zip(r, t)):.4f}")
        if bad:
            raise AssertionError(f"{label} chunk {key}: lanes {bad} above 1.5 tol or at maxiter")
    check_finite(label, res)
    edir = "" if res.edir is None else (
        f"TOA edir {res.edir[0].mean().item():.3f}, surface edir "
        f"{res.edir[-1].mean().item():.3f}, ")
    log(f"{label}: wall {wall * 1e3:.1f} ms, {len(niters)} bands, niter sum {sum(niters)} "
        f"(max {max(niters)}), launches K1 {launches['fused_A_dots']} K2 "
        f"{launches['orbit_contract']} K3 {launches['diffuse_apply_dense']}; {edir}TOA up "
        f"{res.eup[0].mean().item():.3f} W/m2")
    return res, wall, launches


def check_finite(label, res):
    for name, a in zip(("edir", "edn", "eup", "abso"), res):
        if a is not None and not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{label}: non-finite {name}")


def heating_rates(res, atm, K):
    """abso2hr on the solve grid: the super-layer's air is the column mass of
    the K folded layers over their height."""
    from tenstream_tpu_torch.atm import abso2hr
    from tenstream_tpu_torch.core.types import GRAV, R_DRY_AIR

    play, tlay = atm.play, atm.tlay
    t0 = float(np.mean(tlay[:K]))
    rho0 = (atm.plev[K] - atm.plev[0]) / GRAV / float(atm.dz[:K].sum())
    play_s = np.concatenate([[rho0 * R_DRY_AIR * t0], play[K:]])
    tlay_s = np.concatenate([[t0], tlay[K:]])
    return abso2hr(res.abso, play_s[:, None, None], tlay_s[:, None, None])


def phase_spectral(cuda_ops, opp, seed, smi):
    """The main path: bench.py's full-spectrum solve at 256 x 256."""
    from tenstream_tpu_torch.spectral.specint import resolve_cache_mode

    spec = make_spectral_solver(NX, NY, seed, opp)
    solver, atm, lwc, gas = spec
    auto = resolve_cache_mode("auto", NGPT, solver.scheme.ndiff, solver.nz_solve, NX, NY)
    log(f"spectral: {NX}x{NY}x{NZ}, atm_collapse {K_COLLAPSE} (solve grid {solver.nz_solve} "
        f"layers), ecCKD {NGPT}+{NGPT}, chunks of {CHUNK}; specint_cache f32 "
        f"(auto would resolve to {auto!r} here)")
    torch.cuda.reset_peak_memory_stats()
    cuda_ops.reset_launch_counts()
    walls = {}
    # the first three steps' results and per-band iterations, for phase 31 (a)
    steps = []
    keep = lambda r: steps.append((tuple(a.cpu() for a in r), _band_niters(solver)))
    res, walls["cold"], _ = spectral_solve(spec, lwc, cuda_ops, "spectral cold")
    keep(res)
    res, walls["warm identical"], _ = spectral_solve(spec, lwc, cuda_ops, "spectral warm")
    keep(res)
    lwc = np.roll(lwc, 1, axis=1)
    res, pert, _ = spectral_solve(spec, lwc, cuda_ops, "spectral perturbed 1")
    keep(res)
    launches = dict(cuda_ops.LAUNCHES)
    spec = (solver, atm, lwc, gas)
    log(f"spectral: walls " + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in walls.items())
        + f", perturbed {pert * 1e3:.1f} ms = {NX * NY / pert:.1f} columns/s ({smi}); "
        f"launches {launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    check_spectral_result("spectral", res, atm, lwc, gas.solar(atm).weight)
    for name in ("fused_A_dots", "orbit_contract"):
        if launches[name] == 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    return launches, spec, steps


def check_toa(label, edir, weight, mu):
    """TOA direct irradiance = the sum of the solar weights x mu, within 1%."""
    want = float(weight.sum()) * mu
    toa = edir[0].mean().item()
    log(f"{label}: TOA edir {toa:.3f} W/m2 vs sum of the solar weights x mu {want:.3f}")
    if abs(toa - want) > 0.01 * want:
        raise AssertionError(f"{label}: TOA edir {toa} differs from {want} by more than 1%")


def check_spectral_result(label, res, atm, lwc, weight, K=K_COLLAPSE, exempt_clouds=False):
    """Phase 12's gates on a solar+thermal result of bench.py's scene: the
    TOA edir, and heating rates finite and below HR_MAX outside the cloud
    tops (outside every cloud cell with `exempt_clouds`: a table whose axes
    cannot represent the clouds, phase 24)."""
    check_toa(label, res.edir, weight, float(np.cos(np.deg2rad(SPECTRAL_SUN[1]))))
    hr = heating_rates(res, atm, K)
    # cloud-top cells (cloud under clear air) cool through their top face by
    # about 100 K/day; the JAX package reaches 104 K/day there on this scene
    # at 64x64 (tools/torch_heating_rates.py): every other cell stays below
    cloud = torch.as_tensor(lwc[max(K - 1, 0):] > 0, device=hr.device)
    top = cloud[1:] & ~cloud[:-1]
    exempt = cloud[1:] if exempt_clouds else top
    what = "cloud" if exempt_clouds else "cloud-top"
    hr_lay = hr[1:].abs()
    k, i, j = np.unravel_index(int(hr.abs().argmax()), tuple(hr.shape))
    hr_other = max(hr_lay[~exempt].max().item(), hr[0].abs().max().item())
    log(f"{label}: heating rates max |{hr.abs().max().item():.2f}| K/day at solve layer {k} "
        f"({i}, {j}); {what} cells up to {hr_lay[exempt].max().item():.2f} K/day "
        f"({int((hr_lay[exempt] > HR_MAX).sum())} of {int(exempt.sum())} above {HR_MAX:.0f}), "
        f"every other cell up to {hr_other:.2f} K/day; column mean at the surface layer "
        f"{hr[-1].mean().item():.3f} K/day")
    if not (bool(torch.isfinite(hr).all()) and hr_other < HR_MAX):
        raise AssertionError(f"{label}: heating rates non-finite or above {HR_MAX} K/day "
                             f"outside the {what} cells")


def phase_spectral_parity(cuda_ops, ediff, opp, seed):
    """The 64 x 64 spectral solve through K1/K2 and through their plain
    versions: fluxes, absorption and the iterations of every band."""
    outs, iters = [], []
    for plain in (False, True):
        spec = make_spectral_solver(64, 64, seed, opp)
        with kernels_or_plain(cuda_ops, ediff, plain):
            res, _, launches = spectral_solve(
                spec, spec[2], cuda_ops, "spectral parity " + ("plain" if plain else "kernels"),
                report_chunks=False)
        if plain != (launches["fused_A_dots"] == 0):
            raise AssertionError("spectral parity: K1 launched where it should not, or not at all")
        outs.append(tuple(res))
        iters.append(_band_niters(spec[0]))
    _compare_solves(f"spectral parity 64x64x{NZ} kernels vs plain", outs)
    differ = {k: (iters[0][k], iters[1][k]) for k in iters[0] if iters[0][k] != iters[1].get(k)}
    log(f"spectral parity: {len(iters[0])} bands, niter equal in "
        f"{len(iters[0]) - len(differ)}" + (f"; differ {differ}" if differ else ""))
    if differ or iters[0].keys() != iters[1].keys():
        raise AssertionError(f"spectral parity: per-band iterations differ {differ}")


# ---------------------------------------------------------------------------
# the urban spectral path (K3 at band chunks of 8) and the 3-D options
# ---------------------------------------------------------------------------

def urban_spectral_zlev():
    """The urban box's 40 layers of 10 m under 16 geometric layers from its
    top (400 m) to 20 km, TOA -> surface: 56 layers."""
    z_sky = np.geomspace(URBAN_NZ * URBAN_DZ, 20e3, URBAN_SKY + 1)
    return np.concatenate([z_sky[::-1], URBAN_DZ * np.arange(URBAN_NZ - 1, -1, -1)])


def make_urban_spectral(nx, ny, seed, opp):
    """Phase 6's street grid (its solid mask only) at the bottom of the
    standard atmosphere on `urban_spectral_zlev`, building faces at 300 K,
    the f32 warm cache, sun (250, 35)."""
    from tenstream_tpu_torch.atm import setup_standard_atmosphere
    from tenstream_tpu_torch.core.config import Options
    from tenstream_tpu_torch.pprts.buildings import Buildings
    from tenstream_tpu_torch.pprts.grid import Grid
    from tenstream_tpu_torch.pprts.solver import PprtsSolver
    from tenstream_tpu_torch.pprts.sun import sundir_from_angles
    from tenstream_tpu_torch.spectral.ecckd import EcckdGasOptics

    atm = setup_standard_atmosphere(z_grid=urban_spectral_zlev())
    solid = np.concatenate([np.zeros((URBAN_SKY, nx, ny), bool),
                            build_urban_scene(nx, ny, seed)[2]])
    grid = Grid.create(atm.nlay, nx, ny, URBAN_DX, URBAN_DX, atm.dz.astype(np.float32),
                       device="cuda")
    solver = PprtsSolver(grid, opp, options=Options({"specint_cache": "f32"}, read_env=False))
    l1d = np.asarray(solver._l1d, bool)
    if not (l1d[:URBAN_SKY].all() and not l1d[URBAN_SKY:].any()):
        raise AssertionError(f"urban spectral column: expected {URBAN_SKY} 1-D layers over the "
                             f"box's {URBAN_NZ} 3-D ones, got l1d {l1d.tolist()}")
    solver.set_angles(sundir_from_angles(*SUN))
    b = Buildings(solid=torch.as_tensor(solid, device="cuda"), albedo=BUILDING_ALBEDO,
                  temp=BUILDING_T)
    return (solver, atm, None, EcckdGasOptics(n_gpt=NGPT)), b, solid


def check_urban_spectral(spec, b, solid, res, label, sun):
    """TOA edir against the solar weights, and phase 6's urban checks on the
    spectral result with the faces' broadband emission sum_g B_g(300 K)."""
    solver, atm, _, gas = spec
    mu = float(np.cos(np.deg2rad(sun[1])))
    want = float(gas.solar(atm).weight.sum()) * mu
    toa = res.edir[0].mean().item()
    B_sum = float(gas.planck_at(BUILDING_T).astype(np.float64).sum())
    log(f"{label}: TOA edir {toa:.3f} W/m2 vs sum of the solar weights x mu {want:.3f}; faces "
        f"emit pi sum_g B_g(300 K) = {np.pi * B_sum:.2f} W/m2")
    if abs(toa - want) > 0.01 * want:
        raise AssertionError(f"{label}: TOA edir {toa} differs from {want} by more than 1%")
    check_urban(solver, solid, tuple(res), label, fluxes=b.fluxes, B_face=B_sum,
                box_top=URBAN_SKY)


def phase_urban_spectral(cuda_ops, opp, seed, smi, k3):
    """This slice's path: buildings inside specint_pprts at 256 x 256, ecCKD
    32 + 32 in chunks of 8 through K3: a cold call, an identical warm call,
    a call with the sun moved, and the sun moved back under torch.profiler
    (one chunk of each spectrum)."""
    from tenstream_tpu_torch.pprts.sun import sundir_from_angles

    spec, b, solid = make_urban_spectral(NX, NY, seed, opp)
    solver = spec[0]
    log(f"urban spectral: {NX}x{NY}x{URBAN_SPEC_NZ} ({URBAN_NZ} layers of {URBAN_DZ:.0f} m under "
        f"{URBAN_SKY} to 20 km, columns of {URBAN_DX:.0f} m), {100 * solid.any(axis=0).mean():.1f}% "
        f"of the columns built on, ecCKD {NGPT}+{NGPT} in chunks of {CHUNK}, specint_cache f32, "
        "no atm_collapse (buildings forbid it)")
    torch.cuda.reset_peak_memory_stats()
    cuda_ops.reset_launch_counts()
    walls = {}
    for tag, sun in (("cold", SUN), ("warm identical", SUN), ("sun moved", SUN_MOVED)):
        solver.set_angles(sundir_from_angles(*sun))
        res, walls[tag], _ = spectral_solve(spec, None, cuda_ops, f"urban spectral {tag}",
                                            buildings=b)
        check_urban_spectral(spec, b, solid, res, f"urban spectral {tag}", sun)
    launches = dict(cuda_ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"urban spectral: walls " + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in walls.items())
        + f"; sun moved = {NX * NY / walls['sun moved']:.1f} columns/s ({smi}); launches "
        f"{launches}; peak device memory {peak:.2f} GiB")
    log(f"urban spectral: K3 at this chunk's shape (B={CHUNK}, nz={URBAN_SPEC_NZ}, {NX}x{NY}): "
        f"{k3['ms']:.4f} ms per launch, byte bound {k3['bound_ms']:.4f} ms "
        f"({100 * k3['bound_ms'] / k3['ms']:.1f}%), one einsum on gathered sources "
        f"{k3['library_ms']:.4f} ms; bfloat16 coefficients {k3['ms_bf16']:.4f} ms (bound "
        f"{k3['bound_ms_bf16']:.4f} ms, {100 * k3['bound_ms_bf16'] / k3['ms_bf16']:.1f}%); "
        f"{launches['diffuse_apply_dense']} launches = "
        f"{launches['diffuse_apply_dense'] * k3['ms'] / 1e3:.2f} s of K3 in the three calls")
    if launches["diffuse_apply_dense"] == 0:
        raise AssertionError("kernel diffuse_apply_dense was not launched on the urban "
                             "spectral path")
    if launches["fused_A_dots"] or launches["orbit_contract"]:
        raise AssertionError("the urban spectral path launched an orbit kernel")

    def sun_back():
        solver.set_angles(sundir_from_angles(*SUN))
        return spectral_solve(spec, None, cuda_ops, "urban spectral profiled (sun back, "
                              f"g-points 0-{CHUNK - 1})", buildings=b, bands=(0, CHUNK))

    # the profiled window is one chunk of each spectrum: the whole call puts ~400k kernels into
    # the trace, and reading it took longer than the call
    (_, wall_p, _), by_name = device_kernels(sun_back)
    busy = sum(t for t, _ in by_name.values())
    if busy == 0:
        log("urban spectral profile: the profiler recorded no device time; busy share not "
            "measured")
    else:
        log(f"urban spectral profile (sun back, g-points 0-{CHUNK - 1} of each spectrum): device "
            f"busy {busy:.1f} ms in {sum(n for _, n in by_name.values())} kernels = "
            f"{100 * busy / (wall_p * 1e3):.1f}% of the profiled call's wall {wall_p * 1e3:.1f} "
            f"ms (the unprofiled sun-moved call, all g-points: {walls['sun moved'] * 1e3:.1f} ms)")
        for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
            log(f"urban spectral profile   {t:9.2f} ms {n:6d} launches  {name[:100]}")
    return launches


def _compare_faces(label, faces):
    err = max((faces[0][k][q] - faces[1][k][q]).abs().max().item()
              for k in faces[0] for q in ("edir", "incoming", "outgoing"))
    log(f"{label}: face fluxes max abs {err:.3e} W/m2")
    if err > FLUX_ATOL:
        raise AssertionError(f"{label}: face fluxes differ by {err} > {FLUX_ATOL} W/m2")


def _compare_band_niters(label, iters):
    differ = {k: (iters[0][k], iters[1].get(k)) for k in iters[0]
              if iters[0][k] != iters[1].get(k)}
    log(f"{label}: {len(iters[0])} bands, niter equal in {len(iters[0]) - len(differ)}"
        + (f"; differ {differ}" if differ else ""))
    if differ or iters[0].keys() != iters[1].keys():
        raise AssertionError(f"{label}: per-band iterations differ {differ}")


def phase_urban_spectral_parity(cuda_ops, ediff, opp, seed):
    """The urban spectral scene at 64 x 64 through K3 and through its plain
    version: fluxes, absorption, face fluxes and every band's niter."""
    outs, iters, faces = [], [], []
    for plain in (False, True):
        spec, b, solid = make_urban_spectral(64, 64, seed, opp)
        with kernels_or_plain(cuda_ops, ediff, plain):
            res, _, launches = spectral_solve(
                spec, None, cuda_ops, "urban spectral parity " + ("plain" if plain else "K3"),
                report_chunks=False, buildings=b)
        if plain != (launches["diffuse_apply_dense"] == 0):
            raise AssertionError("urban spectral parity: K3 launched where it should not, or not "
                                 "at all")
        outs.append(tuple(res))
        iters.append(_band_niters(spec[0]))
        faces.append(b.fluxes)
    _compare_solves(f"urban spectral parity 64x64x{URBAN_SPEC_NZ} K3 vs plain", outs)
    _compare_faces("urban spectral parity", faces)
    _compare_band_niters("urban spectral parity", iters)


def phase_options(cuda_ops, ediff, opp, seed):
    """The 3-D options, each through the kernels and through their plain
    versions with phase 13's gates: at SMALL_N x SMALL_N McICA on bench.py's scene with a
    partial cloud fraction, the adaptive spectral skip over three steps
    (equal skip counts), and at 64 x 64 one 8_10 solve on the committed
    production table; before them the McICA draws on the card against the
    same draws on the CPU."""
    from tenstream_tpu_torch.core.prng import Threefry
    from tenstream_tpu_torch.optprop.facade import OptProp
    from tenstream_tpu_torch.optprop.lut import LUT
    from tenstream_tpu_torch.pprts.grid import Grid
    from tenstream_tpu_torch.pprts.solver import PprtsSolver
    from tenstream_tpu_torch.pprts.sun import sundir_from_angles

    key = Threefry.from_seed(712).fold_in(1)
    shape = (NGPT, NZ, 64, 64)
    got = {dev: (sha256(key.bits(shape, dev)), sha256(key.uniform(shape, dev)))
           for dev in ("cuda", "cpu")}
    log(f"options threefry: {shape} bits and uniforms on the card {got['cuda'][0][:16]} / "
        f"{got['cuda'][1][:16]}, on the CPU {got['cpu'][0][:16]} / {got['cpu'][1][:16]}")
    if got["cuda"] != got["cpu"]:
        raise AssertionError("threefry: the draws on the card differ from those on the CPU")

    outs, iters, cf = [], [], None
    for plain in (False, True):
        spec = make_spectral_solver(SMALL_N, SMALL_N, seed, opp)
        lwc = spec[2]
        if cf is None:  # partly cloudy cells: 30-100% of each cloudy cell
            rng = np.random.default_rng(seed)
            cf = np.where(lwc > 0, rng.uniform(0.3, 1.0, lwc.shape), 0.0).astype(np.float32)
        with kernels_or_plain(cuda_ops, ediff, plain):
            res, _, launches = spectral_solve(
                spec, lwc, cuda_ops, "options McICA " + ("plain" if plain else "kernels"),
                report_chunks=False, cld_frac=cf)
        if plain != (launches["fused_A_dots"] == 0):
            raise AssertionError("options McICA: K1 launched where it should not, or not at all")
        outs.append(tuple(res))
        iters.append(_band_niters(spec[0]))
    _compare_solves(f"options McICA {SMALL_N}x{SMALL_N}x{NZ} kernels vs plain", outs)
    _compare_band_niters("options McICA", iters)

    runs = []
    for plain in (False, True):
        spec = make_spectral_solver(SMALL_N, SMALL_N, seed, opp)
        steps = []
        with kernels_or_plain(cuda_ops, ediff, plain):
            for t in (0.0, 60.0, 120.0):
                res, wall, _ = spectral_solve(
                    spec, spec[2], cuda_ops, f"options adaptive {'plain' if plain else 'kernels'} "
                    f"t={t:.0f}", report_chunks=False, time=t, max_solution_err=1.0,
                    max_solution_time=3600.0)
                steps.append((tuple(res), spec[0]._spectral_skips, wall))
        runs.append(steps)
    for (ra, na, wa), (rb, nb, wb) in zip(*runs):
        _compare_solves("options adaptive kernels vs plain", (ra, rb))
        if na != nb:
            raise AssertionError(f"options adaptive: skip counts differ, {na} vs {nb}")
    log(f"options adaptive: skips after each step {[n for _, n, _ in runs[0]]} (kernels) = "
        f"{[n for _, n, _ in runs[1]]} (plain); walls with the kernels "
        + ", ".join(f"{w * 1e3:.1f} ms" for _, _, w in runs[0]))
    if runs[0][-1][1] == 0:
        raise AssertionError("options adaptive: the identical third step skipped no chunk")

    opp810 = OptProp(LUT.load(LUT_8_10_PATH, device="cuda"), device="cuda")
    outs, iters = [], []
    for plain in (False, True):
        solver, fields = make_solver(64, 64, seed, opp810, Grid, PprtsSolver,
                                     sundir_from_angles(*SUN))
        cuda_ops.reset_launch_counts()
        with kernels_or_plain(cuda_ops, ediff, plain):
            o, it = solve_and_report(solver, fields, cuda_ops,
                                     "options 8_10 " + ("plain" if plain else "kernels"))
        if plain != (cuda_ops.LAUNCHES["fused_A_dots"] == 0):
            raise AssertionError("options 8_10: K1 launched where it should not, or not at all")
        outs.append(o)
        iters.append(it)
    _compare_solves(f"options 8_10 64x64x{NZ} kernels vs plain", outs)
    if iters[0] != iters[1]:
        raise AssertionError(f"options 8_10: iteration counts differ, {iters[0]} vs {iters[1]}")


# ---------------------------------------------------------------------------
# the other gas optics and the 1-D solvers (phases 18-20)
# ---------------------------------------------------------------------------

def gas_calls(which: str):
    """The specint_pprts calls of one radiation step: (backend, lsolar,
    lthermal).  RRTMG_SW has no thermal spectrum, so its step pairs it
    with ecCKD's longwave (milestone config (3), the JAX package's
    `examples/ex_pprts_rrtmg_lw_sw.py`); repwvl does both."""
    from tenstream_tpu_torch.spectral.ecckd import EcckdGasOptics
    from tenstream_tpu_torch.spectral.repwvl import RepwvlOptics
    from tenstream_tpu_torch.spectral.rrtmg_sw import RrtmgSwOptics

    if which == "rrtmg_sw":
        return [("rrtmg_sw 112 SW", RrtmgSwOptics(), True, False),
                (f"ecCKD {NGPT} LW", EcckdGasOptics(n_gpt=NGPT), False, True)]
    return [(f"repwvl {REPWVL_NWVL}+{REPWVL_NWVL}", RepwvlOptics(n_wvl=REPWVL_NWVL), True, True)]


def combine(parts):
    """One SpectralResult from a solar call and a thermal call."""
    from tenstream_tpu_torch.spectral.specint import SpectralResult

    edir = next((p.edir for p in parts if p.edir is not None), None)
    return SpectralResult(edir, *(sum(getattr(p, n) for p in parts) for n in ("edn", "eup", "abso")))


def solar_weight(calls, atm):
    return next(gas.solar(atm).weight for _, gas, lsolar, _ in calls if lsolar)


def spectral_step(spec, lwc, calls, cuda_ops, label, report_chunks=True):
    """One radiation step of `calls` through `spectral_solve`: the combined
    result, the summed wall and launches."""
    parts, wall, launches = [], 0.0, {}
    for name, gas, lsolar, lthermal in calls:
        res, w, l = spectral_solve(spec, lwc, cuda_ops, f"{label} {name}", report_chunks,
                                   gas=gas, lsolar=lsolar, lthermal=lthermal)
        parts.append(res)
        wall += w
        launches = {k: launches.get(k, 0) + v for k, v in l.items()}
    return combine(parts), wall, launches


def phase_gas_optics(cuda_ops, opp, seed, smi):
    """Phase 18: phase 12's scene and solver set-up at GAS_N x GAS_N with
    the RRTMG_SW (+ ecCKD LW) and the repwvl spectra, a fresh solver each: a
    cold step and a perturbed step (the cloud field rolled by one cell)."""
    out = {}
    n = GAS_N
    for which in GAS_SETS:
        calls = gas_calls(which)
        spec = make_spectral_solver(n, n, seed, opp)
        solver, atm, lwc, _ = spec
        label = f"gas optics {which}"
        ngpt = {n: int(g.solar(atm).tau.shape[0] if ls else g.thermal(atm).tau.shape[0])
                for n, g, ls, _ in calls}
        log(f"{label}: {n}x{n}x{NZ}, atm_collapse {K_COLLAPSE}, chunks of {CHUNK}, "
            f"specint_cache f32, g-points {ngpt}")
        torch.cuda.reset_peak_memory_stats()
        cuda_ops.reset_launch_counts()
        _, cold, _ = spectral_step(spec, lwc, calls, cuda_ops, f"{label} cold")
        lwc = np.roll(lwc, 1, axis=1)
        res, pert, _ = spectral_step(spec, lwc, calls, cuda_ops, f"{label} perturbed")
        launches = dict(cuda_ops.LAUNCHES)
        log(f"{label}: cold {cold * 1e3:.1f} ms, perturbed {pert * 1e3:.1f} ms = "
            f"{n * n / pert:.1f} columns/s ({smi}); launches {launches}; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        check_spectral_result(label, res, atm, lwc, solar_weight(calls, atm))
        for name in ("fused_A_dots", "orbit_contract"):
            if launches[name] == 0:
                raise AssertionError(f"{label}: kernel {name} was not launched")
        out[which] = tuple(float(a.mean()) for a in (res.eup[0], res.edn[-1], res.edir[-1]))
        del spec, solver, res
        torch.cuda.empty_cache()
    return out


def oned_specint(solver, atm, lwc, calls, label=None):
    """One radiation step of `calls` through specint_pprts on a 1-D solver:
    the combined result and its wall."""
    from tenstream_tpu_torch.spectral import specint_pprts

    if solver.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = combine([specint_pprts(solver, atm, albedo=0.15, lthermal=lthermal, lsolar=lsolar,
                                 specint=gas, lwc=lwc, band_chunk=CHUNK)
                   for _, gas, lsolar, lthermal in calls])
    if solver.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if label is not None:
        check_finite(label, res)
    return res, wall


def crop_errors(outs):
    """Max |card - CPU| of each field, and of the fluxes over their largest
    magnitude."""
    errs = [(a - b).abs().max().item() for a, b in zip(*outs)]
    rel = max(e / max(b.abs().max().item(), 1e-30) for e, b in zip(errs[:-1], outs[1]))
    return errs, rel


def card_vs_cpu(label, run, n=None):
    """`run(device)` on an n x n crop (default CROP), on the card and on the
    CPU (the port on both): fluxes within CROP_FLUX_RTOL of their largest
    magnitude, absorption within CROP_ABSO_ATOL; TF32 or the device's linear
    algebra would show here."""
    outs = [tuple(a.cpu() for a in run(dev) if a is not None) for dev in ("cuda", "cpu")]
    hold_crop(label, outs, n or CROP)
    return outs[1]


def hold_crop(label, outs, n):
    """(card fields, CPU fields) of an n x n crop within phase 19's gates."""
    errs, rel = crop_errors(outs)
    log(f"{label} {n}x{n} crop, card vs CPU: max abs "
        + ", ".join(f"{e:.3e}" for e in errs[:-1]) + f" W/m2 ({rel:.2e} of the largest flux), "
        f"abso {errs[-1]:.3e} W/m3")
    if rel > CROP_FLUX_RTOL or errs[-1] > CROP_ABSO_ATOL:
        raise AssertionError(f"{label}: card and CPU differ on the crop (flux rtol "
                             f"{CROP_FLUX_RTOL}, abso atol {CROP_ABSO_ATOL})")


@contextlib.contextmanager
def cpu_threads(n):
    """torch's CPU threads for an n x n wedge crop: one runs an 8 x 8 crop's
    small tensors fastest, four a 16 x 16 one (measured on the chip machine's CPU)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 1 if n <= 8 else 4))
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def oned_solver(solver_type, nz, nx, ny, dz, dx, device, sun):
    from tenstream_tpu_torch.pprts.grid import Grid
    from tenstream_tpu_torch.pprts.solver import PprtsSolver
    from tenstream_tpu_torch.pprts.sun import sundir_from_angles

    s = PprtsSolver(Grid.create(nz, nx, ny, dx, dx, dz, device=device), solver_type=solver_type)
    s.set_angles(sundir_from_angles(*sun))
    return s


def phase_oned(seed, smi, means_3d):
    """Phase 19: the 1-D solvers.  (a) 2str through specint_pprts with
    RRTMG_SW 112 + ecCKD 32 LW on phase 18's scene at 256 x 256; (b) a
    Schwarzschild thermal solve and a DISORT solar+thermal solve of phase
    4's band at 256 x 256; (c) DISORT through specint_pprts with ecCKD 32 +
    32 at 64 x 64.  Each also on a CROP x CROP crop on the card and on the CPU."""
    atm, lwc = build_bench_atm(NX, NY, seed)
    lwc = np.roll(lwc, 1, axis=1)  # phase 18's perturbed field
    dz = atm.dz.astype(np.float32)
    calls = gas_calls("rrtmg_sw")
    mu_spec = float(np.cos(np.deg2rad(SPECTRAL_SUN[1])))

    # (a) the example's flow at bench width
    torch.cuda.reset_peak_memory_stats()
    solver = oned_solver("2str", atm.nlay, NX, NY, dz, 100.0, "cuda", SPECTRAL_SUN)
    oned_specint(solver, atm, lwc, calls, "2str warm-up")
    res, wall = oned_specint(solver, atm, lwc, calls, "2str rrtmg_sw")
    log(f"oned 2str rrtmg_sw 112 + ecCKD {NGPT} LW at {NX}x{NY}x{NZ}: wall {wall * 1e3:.1f} ms = "
        f"{NX * NY / wall:.1f} columns/s ({smi}); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    check_toa("oned 2str rrtmg_sw", res.edir, solar_weight(calls, atm), mu_spec)
    # against phase 18's 3-D perturbed step, on its field at GAS_N x GAS_N
    atm_g, lwc_g = build_bench_atm(GAS_N, GAS_N, seed)
    res_g, _ = oned_specint(oned_solver("2str", atm_g.nlay, GAS_N, GAS_N, dz, 100.0, "cuda",
                                        SPECTRAL_SUN), atm_g, np.roll(lwc_g, 1, axis=1), calls)
    m2 = tuple(float(a.mean()) for a in (res_g.eup[0], res_g.edn[-1], res_g.edir[-1]))
    m3 = means_3d["rrtmg_sw"]
    del res_g
    log(f"oned 2str vs 3_10 (phase 18 rrtmg_sw, perturbed step, {GAS_N}x{GAS_N}), domain means: "
        f"TOA up {m2[0]:.3f}"
        f" vs {m3[0]:.3f}, surface diffuse down {m2[1]:.3f} vs {m3[1]:.3f}, surface edir "
        f"{m2[2]:.3f} vs {m3[2]:.3f} W/m2 (not gated)")
    c = min(CROP, NX)
    card_vs_cpu("oned 2str rrtmg_sw", lambda dev: oned_specint(
        oned_solver("2str", atm.nlay, c, c, dz, 100.0, dev, SPECTRAL_SUN), atm,
        lwc[:, :c, :c], calls)[0])
    del solver, res

    # (b) phase 4's band: Schwarzschild (thermal), DISORT (solar + thermal)
    dz4, kabs, ksca, g, planck = build_scene(NX, NY, seed)
    mu4 = float(np.cos(np.deg2rad(SUN[1])))
    results = {}
    for st, lsolar in (("schwarzschild", False), ("disort", True), ("2str", True)):
        def band(dev, n=NX, st=st, lsolar=lsolar):
            s = oned_solver(st, dz4.size, n, n, dz4, 100.0, dev, SUN)
            s.set_optical_properties(0.15, *(a[:, :n, :n] for a in (kabs, ksca, g)),
                                     planck=planck[:, :n, :n])
            s.solve(lthermal=True, lsolar=lsolar, edirTOA=1000.0)
            return s.get_result()

        torch.cuda.reset_peak_memory_stats()
        band("cuda")  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = band("cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check_finite(f"oned {st} band", out)
        results[st] = out
        log(f"oned {st} band {'solar+thermal' if lsolar else 'thermal'} at {NX}x{NY}x{NZ}: wall "
            f"{wall * 1e3:.1f} ms; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; TOA up "
            f"{out[2][0].mean().item():.3f}, surface down {out[1][-1].mean().item():.3f} W/m2")
        if lsolar:
            check_toa(f"oned {st} band", out[0], np.array([1000.0]), mu4)
        if st != "2str":
            cpu = card_vs_cpu(f"oned {st} band", lambda dev: band(dev, min(CROP, NX)))
        if st == "disort":
            # the control: DISORT's products with TF32 allowed, against the CPU
            import tenstream_tpu_torch.ops.disort as disort_mod

            saved = disort_mod._true_float32, torch.backends.cuda.matmul.allow_tf32
            disort_mod._true_float32 = contextlib.nullcontext
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                tf32 = tuple(a.cpu() for a in band("cuda", min(CROP, NX)))
            finally:
                disort_mod._true_float32, torch.backends.cuda.matmul.allow_tf32 = saved
            errs, rel = crop_errors((tf32, cpu))
            log(f"oned disort band crop with TF32 allowed (the control), card vs CPU: "
                f"{rel:.2e} of the largest flux, abso {errs[-1]:.3e} W/m3 (gate {CROP_FLUX_RTOL}: "
                f"{'caught' if rel > CROP_FLUX_RTOL else 'not caught'}; not gated)")
    d, t = results["disort"], results["2str"]
    log(f"oned DISORT-{2 * DISORT_STREAMS} vs 2str, phase 4's band, domain means: TOA up "
        f"{d[2][0].mean().item():.3f} vs {t[2][0].mean().item():.3f}, surface down "
        f"{d[1][-1].mean().item():.3f} vs {t[1][-1].mean().item():.3f} W/m2 (not gated)")
    del results, d, t
    mats = torch.eye(8, device="cuda") - 0.1 * torch.rand((NZ * NX * NY, 8, 8), device="cuda")
    rhs = torch.rand((NZ * NX * NY, 8, 1), device="cuda")
    inv_ms = cuda_ms(lambda: torch.linalg.inv(mats), 3)
    solve_ms = cuda_ms(lambda: torch.linalg.solve(mats, rhs), 3)
    log(f"oned: batched torch.linalg.inv of {NZ * NX * NY} 8x8 float32 matrices {inv_ms:.3f} ms, "
        f"torch.linalg.solve with one right-hand side {solve_ms:.3f} ms ({smi})")
    del mats, rhs

    # (c) DISORT through specint_pprts, ecCKD 32 + 32 at 64 x 64
    from tenstream_tpu_torch.spectral.ecckd import EcckdGasOptics

    atm64, lwc64 = build_bench_atm(64, 64, seed)
    ck = [(f"ecCKD {NGPT}+{NGPT}", EcckdGasOptics(n_gpt=NGPT), True, True)]
    torch.cuda.reset_peak_memory_stats()
    dz = atm64.dz.astype(np.float32)
    solver = oned_solver("disort", atm64.nlay, 64, 64, dz, 100.0, "cuda", SPECTRAL_SUN)
    oned_specint(solver, atm64, lwc64, ck, "disort warm-up")
    res, wall = oned_specint(solver, atm64, lwc64, ck, "disort ecCKD")
    log(f"oned disort ecCKD {NGPT}+{NGPT} at 64x64x{NZ} ({DISORT_STREAMS} streams per "
        f"hemisphere): wall {wall * 1e3:.1f} ms; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    check_toa("oned disort ecCKD", res.edir, solar_weight(ck, atm64), mu_spec)
    r2, _ = oned_specint(oned_solver("2str", atm64.nlay, 64, 64, dz, 100.0, "cuda",
                                     SPECTRAL_SUN), atm64, lwc64, ck)
    log(f"oned DISORT-{2 * DISORT_STREAMS} vs 2str, ecCKD {NGPT}+{NGPT} at 64x64, domain means: "
        f"TOA up {res.eup[0].mean().item():.3f} vs {r2.eup[0].mean().item():.3f}, surface down "
        f"{res.edn[-1].mean().item():.3f} vs {r2.edn[-1].mean().item():.3f} W/m2 (not gated)")
    c = min(CROP, lwc64.shape[1])
    card_vs_cpu("oned disort ecCKD", lambda dev: oned_specint(
        oned_solver("disort", atm64.nlay, c, c, dz, 100.0, dev, SPECTRAL_SUN), atm64,
        lwc64[:, :c, :c], ck)[0])
    del solver, res, r2
    torch.cuda.empty_cache()


def phase_gas_optics_parity(cuda_ops, ediff, opp, seed):
    """Phase 20: phase 18's two spectra at SMALL_N x SMALL_N through K1/K2 and
    through their plain versions on the card, with phase 13's gates.  The
    RRTMG_SW step's ecCKD longwave is left out: phase 13 holds the same
    ecCKD spectrum on the same scene at 64 x 64 already."""
    for which in GAS_SETS:
        outs, iters = [], []
        calls = [c for c in gas_calls(which) if not c[0].startswith("ecCKD")]
        for plain in (False, True):
            spec = make_spectral_solver(SMALL_N, SMALL_N, seed, opp)
            with kernels_or_plain(cuda_ops, ediff, plain):
                res, _, launches = spectral_step(
                    spec, spec[2], calls, cuda_ops,
                    f"gas optics parity {which} " + ("plain" if plain else "kernels"),
                    report_chunks=False)
            if plain != (launches["fused_A_dots"] == 0):
                raise AssertionError(f"gas optics parity {which}: K1 launched where it should "
                                     "not, or not at all")
            outs.append(tuple(res))
            iters.append(_band_niters(spec[0]))
        _compare_solves(f"gas optics parity {which} {SMALL_N}x{SMALL_N}x{NZ} kernels vs plain",
                        outs)
        _compare_band_niters(f"gas optics parity {which}", iters)


def gaussian_hill(nz, nx, ny, dx, ztop, hill_height, hill_sigma):
    """`examples/ex_pprts_hill.py`'s terrain: sigma-coordinate layer
    thicknesses (nz equal layers between the surface and ztop) over a
    Gaussian hill, its height field and gradients."""
    x = (np.arange(nx) - nx / 2.0) * dx
    y = (np.arange(ny) - ny / 2.0) * dx
    xx, yy = np.meshgrid(x, y, indexing="ij")
    h = hill_height * np.exp(-(xx ** 2 + yy ** 2) / (2.0 * hill_sigma ** 2))
    dz3d = np.broadcast_to((ztop - h)[None] / nz, (nz, nx, ny)).astype(np.float32)
    return dz3d, h.astype(np.float32), np.gradient(h, dx, axis=0), np.gradient(h, dx, axis=1)


def phase_terrain(cuda_ops, ediff, opp):
    """`ex_pprts_hill.py`'s scene at 64 x 64 columns of 100 m (20 sigma
    layers to 2 km over an 800 m hill, every layer 3-D) with
    pprts_geometric_coeffs, sun from +x at 50 degrees: the kernels against
    their plain versions, and the slope-corrected surface direct beam."""
    from tenstream_tpu_torch.core.config import Options
    from tenstream_tpu_torch.pprts.grid import Grid
    from tenstream_tpu_torch.pprts.postprocess import slope_correction_srfc_edir
    from tenstream_tpu_torch.pprts.solver import PprtsSolver
    from tenstream_tpu_torch.pprts.sun import sundir_from_angles

    nz, n, dx = 20, 64, 100.0
    dz3d, h, hx, hy = gaussian_hill(nz, n, n, dx, 2000.0, 800.0, 400.0)
    sun = sundir_from_angles(90.0, 50.0)
    outs, iters = [], []
    for plain in (False, True):
        solver = PprtsSolver(Grid.create(nz, n, n, dx, dx, dz3d, device="cuda"), opp,
                             options=Options({"pprts_geometric_coeffs": True}, read_env=False))
        if np.asarray(solver._l1d).any():
            raise AssertionError("terrain: a 1-D layer; the geometric blocks would not be used")
        solver.set_optical_properties(0.2, np.full((nz, n, n), 5e-5, np.float32),
                                      np.full((nz, n, n), 2e-4, np.float32),
                                      np.full((nz, n, n), 0.4, np.float32))
        solver.set_terrain(h)
        solver.set_angles(sun)
        cuda_ops.reset_launch_counts()
        with kernels_or_plain(cuda_ops, ediff, plain):
            sol = solver.solve(lthermal=False, lsolar=True, edirTOA=1364.0)
            res = solver.get_result()
        if plain != (cuda_ops.LAUNCHES["fused_A_dots"] == 0):
            raise AssertionError("terrain: K1 launched where it should not, or not at all")
        if not np.isfinite(sol.diff_res) or sol.diff_res > 1.5 * sol.diff_tol:
            raise AssertionError(f"terrain: residual {sol.diff_res} > 1.5 x tol {sol.diff_tol}")
        abso = res[3]
        outs.append((res[0], res[1], res[2], abso))
        iters.append(sol.niter_diff)
    _compare_solves(f"terrain 64x64x{nz} geometric coefficients kernels vs plain", outs)
    if iters[0] != iters[1]:
        raise AssertionError(f"terrain: iteration counts differ, {iters[0]} vs {iters[1]}")
    edir = outs[0][0][-1]
    corr = slope_correction_srfc_edir(edir, hx, hy, sun)
    mid, w = n // 2, n // 8
    log(f"terrain: surface edir across the hill at y = {mid}: flat / slope-corrected "
        + ", ".join(f"x={i} {edir[i, mid].item():.1f}/{corr[i, mid].item():.1f}"
                    for i in range(max(0, mid - 12), min(n, mid + 13), 4)) + " W/m2")
    # the flank facing the sun (+x) brightens, the other dims (test_topography.py)
    flank = lambda a, lo, hi: a[lo:hi, mid].sum().item()
    sunny = flank(corr, mid + 1, mid + 1 + w) / flank(edir, mid + 1, mid + 1 + w)
    shady = flank(corr, mid - w, mid) / max(flank(edir, mid - w, mid), 1e-30)
    log(f"terrain: slope correction over {w} cells of each flank: x {sunny:.3f} facing the sun, "
        f"x {shady:.3f} facing away")
    if not (sunny > 1.05 and shady < 0.95):
        raise AssertionError(f"terrain: the slope correction does not brighten the flank facing "
                             f"the sun ({sunny:.3f}) and dim the other ({shady:.3f})")


# ---------------------------------------------------------------------------
# the LUT generation path (K4)
# ---------------------------------------------------------------------------

def _k4_sample(L, direct: bool, n: int, rng):
    grid = L._entry_grid(L.production_axes(direct), direct)
    return grid[np.sort(rng.choice(len(grid), n, replace=False))]


K4_PLAIN_ROWS = 1024  # rows of phase 10's second and third launches held to the plain version


def phase_boxmc(ct, L, seed):
    """K4 at the LUT path's launch shape (4096 entries, the thick conservative
    corner swapped into the last rows), against its plain version on the
    same launch."""
    rng = np.random.default_rng(seed)
    corner = np.array([[100.0, 0.99999, a, g] for a in (0.02, 1.0, 7.451) for g in (0.0, 0.85)],
                      np.float32)
    runs = (("diffuse src 0", False, 0), ("diffuse src 2", False, 2), ("direct src 0", True, 0))
    report, digests = {}, {}
    for label, ldir, src in runs:
        ent = _k4_sample(L, ldir, 4096, rng)
        ent[-len(corner):, :4] = corner
        if ldir:
            ent[-len(corner):, 4:] = 45.0  # phi, theta
        rows = ct.entry_rows(ent, "3_10", src, ldir, seed, "cuda")
        out, steps = ct.boxmc_trace(rows, "3_10", ldir)
        out2, steps2 = ct.boxmc_trace(rows, "3_10", ldir)
        torch.cuda.synchronize()
        if not (torch.equal(out, out2) and torch.equal(steps, steps2)):
            raise AssertionError(f"boxmc {label}: the same seed gave different tallies")
        digests[f"{label} out"], digests[f"{label} steps"] = sha256(out), sha256(steps)
        rowsum = out.sum(1).max().item()
        if not (bool(torch.isfinite(out).all()) and rowsum <= 1.0 + 1e-4):
            raise AssertionError(f"boxmc {label}: row sum {rowsum} > 1 + 1e-4 or non-finite")
        ms = cuda_ms(lambda: ct.boxmc_trace(rows, "3_10", ldir), 3)
        nsteps = int(steps.sum().item())
        util = nsteps / (32 * ct.last_warp_trips())
        log(f"boxmc {label}: 4096 entries (thick corner in the last {len(corner)} rows) in "
            f"{ms:.2f} ms per launch, bit-identical on repeat, max row sum {rowsum:.6f}; "
            f"{4096 * ct.PHOTONS / ms * 1e3:.4e} photons/s, {nsteps:.4e} photon-steps = "
            f"{nsteps / ms * 1e3:.4e} photon-steps/s (longest entry {int(steps.max().item())}), "
            f"lane utilisation {100 * util:.1f}%, "
            f"{100 * k4_flops(nsteps, 4096) / F32_FLOPS_PER_S * 1e3 / ms:.2f}% of the operations "
            "floor's rate")

        # K4 against its plain version on the whole launch for the kernels line's entry, on a
        # launch of its first K4_PLAIN_ROWS rows for the other two: the plain version's time
        # is that of its longest walk, and the thick corner's rows (the last ones) walk ~1e6
        # steps (a row's photon keys depend on its place in the launch, so K4 runs it anew)
        sub, sub_steps = out, steps
        if label != "diffuse src 0":
            rows = rows[:K4_PLAIN_ROWS]
            sub, sub_steps = ct.boxmc_trace(rows, "3_10", ldir)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        outp, stp = ct.boxmc_trace_plain(rows, "3_10", ldir)
        e1.record()
        torch.cuda.synchronize()
        plain_ms = e0.elapsed_time(e1)
        d = (sub - outp).abs()
        err, mean = d.max().item(), d.mean().item()
        log(f"boxmc {label} against plain on the same {len(rows)} rows: plain {plain_ms:.1f} ms; "
            f"max |K4 - plain| {err:.3e}, mean {mean:.3e}, "
            f"{int((d > 1e-5).sum().item())} of {d.numel()} tallies differ by more than 1e-5, "
            f"{int((sub != outp).sum().item())} differ at all; "
            f"photon-steps {int(sub_steps.sum().item())} vs {int(stp.sum().item())}")
        if not (err <= K4_TALLY_ATOL and mean <= K4_MEAN_ATOL):
            raise AssertionError(f"boxmc {label}: K4 disagrees with its plain version (per tally "
                                 f"{K4_TALLY_ATOL}, mean {K4_MEAN_ATOL})")
        if label == "diffuse src 0":
            bound = _report_entry("boxmc_trace (4096 production diffuse entries)", err, ms,
                                  plain_ms, 4096 * K4_BYTES_PER_ENTRY, k4_flops(nsteps, 4096))
            report = dict(bound, photons_per_s=4096 * ct.PHOTONS / ms * 1e3,
                          photon_steps_per_s=nsteps / ms * 1e3, lane_utilisation=util)
    check_digests("boxmc", digests, K4_DIGESTS, seed)
    return report


def _timed_lut(L, ct, fn):
    """Run fn() with every K4 launch bracketed by CUDA events and every
    `_trace_adaptive` call timed on the host: (result, wall s, device ms in
    K4, host s per table kind, photon-steps, warp loop trips)."""
    events, per_kind, counts = [], {"diffuse": 0.0, "direct": 0.0}, []
    trace, adaptive = ct.boxmc_trace, L._trace_adaptive

    def timed_trace(*a, **k):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = trace(*a, **k)
        e1.record()
        events.append((e0, e1))
        # the pass copies each launch's tallies back at once: these reads add no wait
        counts.append((int(out[1].sum().item()), ct.last_warp_trips()))
        return out

    def timed_adaptive(scheme, entries, src, ldir, *a, **k):
        t0 = time.time()
        out = adaptive(scheme, entries, src, ldir, *a, **k)
        per_kind["direct" if ldir else "diffuse"] += time.time() - t0
        return out

    ct.boxmc_trace, L._trace_adaptive = timed_trace, timed_adaptive
    try:
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    finally:
        ct.boxmc_trace, L._trace_adaptive = trace, adaptive
    nsteps, trips = (sum(c) for c in zip(*counts))
    return out, wall, sum(a.elapsed_time(b) for a, b in events), per_kind, nsteps, trips


def _check_rows(lut, label, atol):
    dsum = (lut.dir2dir.sum(-1) + lut.dir2diff.sum(-1)).max().item()
    fsum = lut.diff2diff.sum(-1).max().item()
    if not (dsum <= 1.0 + atol and fsum <= 1.0 + atol):
        raise AssertionError(f"{label}: row sums dir {dsum} diff {fsum} exceed 1 + {atol}")
    return dsum, fsum


def phase_lut(cuda_ops, ct, L, LUT, OptProp, Grid, PprtsSolver, sundir, seed):
    """The LUT generation path: a production-density 3_10 table through K4."""
    dir_axes, diff_axes = L.production_axes(True), L.production_axes(False)
    cuda_ops.reset_launch_counts()
    (lut, meta), wall, dev_ms, per_kind, nsteps, trips = _timed_lut(
        L, ct, lambda: L.create_production_lut(
            "3_10", dir_axes, diff_axes, max_rounds=LUT_ROUNDS, dir_max_rounds=LUT_ROUNDS,
            verbose=False, device="cuda"))
    launches = cuda_ops.LAUNCHES["boxmc_trace"]
    photons = meta["diff_photons_total"] + meta["dir_photons_total"]
    log(f"lut: 3_10 production axes (diffuse {diff_axes.tau.size}x{diff_axes.w0.size}x"
        f"{diff_axes.aspect.size}x{diff_axes.g.size}, direct {dir_axes.tau.size}x"
        f"{dir_axes.w0.size}x{dir_axes.aspect.size}x{dir_axes.g.size}x{dir_axes.phi.size}x"
        f"{dir_axes.theta.size}), {LUT_ROUNDS} rounds: {wall:.1f} s wall (diffuse table "
        f"{per_kind['diffuse']:.1f} s, direct {per_kind['direct']:.1f} s), {launches} K4 launches "
        f"busy {dev_ms / 1e3:.1f} s on the device = host share {100 * (1 - dev_ms / 1e3 / wall):.1f}%"
        f"; {photons:.4e} photons = {photons / wall:.4e} photons/s end to end; {nsteps:.4e} "
        f"photon-steps = {nsteps / dev_ms * 1e3:.4e} per device second, lane utilisation "
        f"{100 * nsteps / (32 * trips):.1f}%")
    log(f"lut meta: {json.dumps(meta)}")
    if launches == 0:
        raise AssertionError("K4 was not launched on the LUT path")
    dsum, fsum = _check_rows(lut, "lut", 1e-3)
    check_digests("lut", {k: sha256(getattr(lut, k)) for k in ("dir2dir", "dir2diff", "diff2diff")},
                  LUT_DIGESTS, seed)

    ref = LUT.load(LUT_PATH, device="cuda")
    zold = np.load(LUT_PATH)
    mold = json.loads(str(zold["meta_json"]))
    nent = int(np.prod(lut.diff2diff.shape[:4]))
    reps = 2  # 3_10's orbit-representative diffuse sources
    n_new = LUT_ROUNDS * ct.PHOTONS
    n_old = mold["diff_photons_total"] / (nent * reps)
    new, old = lut.diff2diff.double(), ref.diff2diff.double()
    p = torch.clamp(torch.maximum(new, old), min=1.0 / n_new, max=1.0)
    se = torch.sqrt(p * (1 - p) * (1.0 / n_new + 1.0 / n_old))
    within = ((new - old).abs() <= 5 * se).double().mean().item()
    bias = (new - old).mean().item()
    log(f"lut vs committed {os.path.basename(LUT_PATH)}: row sums dir {dsum:.6f} diff {fsum:.6f}; "
        f"diff2diff max |diff| {(new - old).abs().max().item():.4e}, {100 * within:.3f}% within 5 "
        f"combined standard errors ({n_new} vs {n_old:.0f} photons per entry), mean signed "
        f"difference {bias:.3e}")
    if not (within >= 0.999 and abs(bias) <= 1e-3):
        raise AssertionError("lut: the generated diff2diff disagrees with the committed table")

    outs = []
    for label, table in (("generated", lut), ("committed", ref)):
        solver, fields = make_solver(64, 64, seed, OptProp(table, device="cuda"), Grid,
                                     PprtsSolver, sundir)
        outs.append(solve_and_report(solver, fields, cuda_ops, f"lut solve ({label} table)")[0])
    errs = [(a - b).abs().max().item() for a, b in zip(*outs)]
    log(f"lut solve 64x64x{NZ}, generated vs committed table: max abs edir {errs[0]:.3e} edn "
        f"{errs[1]:.3e} eup {errs[2]:.3e} W/m2, abso {errs[3]:.3e} W/m3")
    if errs[0] > FLUX_ATOL:
        raise AssertionError(f"lut solve: edir differs by {errs[0]} W/m2 (> {FLUX_ATOL})")

    with tempfile.TemporaryDirectory() as ck:
        kw = dict(max_rounds=LUT_ROUNDS, dir_max_rounds=LUT_ROUNDS, verbose=False,
                  checkpoint_dir=ck, device="cuda")
        first, _ = L.create_production_lut("3_10", L.mockup_axes(True), L.mockup_axes(False), **kw)
        cuda_ops.reset_launch_counts()
        again, _ = L.create_production_lut("3_10", L.mockup_axes(True), L.mockup_axes(False), **kw)
        relaunched = cuda_ops.LAUNCHES["boxmc_trace"]
        same = all(torch.equal(getattr(first, k), getattr(again, k))
                   for k in ("dir2dir", "dir2diff", "diff2diff"))
    log(f"lut resume on mockup axes from its checkpoints: {relaunched} K4 launches, tables equal "
        f"{same}")
    if relaunched or not same:
        raise AssertionError("lut: resuming a finished pass relaunched K4 or changed the tables")
    return launches


# ---------------------------------------------------------------------------
# the other cube schemes (phases 21-24)
# ---------------------------------------------------------------------------

# this slice's schemes; each runs on its committed test table (the table the JAX
# package's own scheme tests use: tests/data/luts/LUT_<scheme>_*.npz)
SCHEMES = ("3_6", "3_16", "3_24", "3_30", "8_12", "8_16", "8_18")
SCHEME_LUT_DIR = os.path.join(REPO, "tests", "data", "luts")
WIDE_FIELD_ATOL = 1e-5  # random fields at more than 10 dofs: up to 30 groups per dst
BALANCE_RTOL = 0.06  # of the incoming beam: the JAX end-to-end gate (tests/test_scheme_e2e_all.py)
# iterations per sub-solve, by comparison: the float32 sums of the larger contractions
# round differently, and a BiCGStab residual that creeps along its tolerance crosses it a
# few steps earlier or later.  Over seeds 7-14 the largest gap was 2 for kernels against
# plain versions (in 56 scheme-seed pairs) and 6 for dense against orbit (3_30's thermal
# solve at seed 10: 21 against 15, fields within 6.5e-3 W/m2; PERF.md section 6): each slack is
# twice its largest reading
NITER_SLACK = {("kernels", "plain"): 4, ("dense", "kernels"): 12}
SPECTRAL_SCHEME = "3_30"  # phase 24's scheme: the widest
# phase 24's band chunk: at 8 its cold call runs out of the card's 80 GB (61.8 GiB in use at
# the failing allocation, PERF.md section 4)
SCHEME_CHUNK = 4
SCHEME_SPEC_N = 128  # columns per side of phase 24's spectral run


def scheme_opp(name, OptProp, LUT):
    """An OptProp on the scheme's committed test table, on the card."""
    (path,) = glob.glob(os.path.join(SCHEME_LUT_DIR, f"LUT_{name}_*.npz"))
    opp = OptProp(LUT.load(path, device="cuda"), device="cuda")
    if opp._solver_orbit_idx is None:
        raise AssertionError(f"{name}: the test table is not symmetrized (no orbit path)")
    return opp


def phase_kernels_by_scheme(cuda_ops, ptx, seed):
    """Phase 21: K1, K2 and K3 (float32 and bfloat16) of every instantiation
    against their plain versions on the card, at one band of 39 layers at
    256 x 256 and at a ragged batched shape, K1 and K2 also at phase 24's
    band chunk; times, bounds, plain times and (K2, K3) the one einsum at the
    band; registers, shared memory and spills."""
    from tenstream_tpu_torch.optprop.facade import diff_pair_orbits
    from tenstream_tpu_torch.streams import get_scheme

    rows = {}
    for name in cuda_ops.ORBIT_SCHEMES:
        scheme = get_scheme(name)
        idx, norb = diff_pair_orbits(scheme, with_mz=False)
        nd = scheme.ndiff
        atol = FIELD_ATOL if nd <= 10 else WIDE_FIELD_ATOL
        row = {"scheme": name, "nd": nd, "norb": norb}
        for ln in ptx:  # this table set's K1 and K2, and K3 at its dof count
            if f"Orbit_{name}E" in ln or f"Li{nd}ELb" in ln:
                log(f"schemes kernels {name} ptxas {ln}")
        for (B, z, x, y, tag) in ((1, NZ, NX, NY, "band"), (SCHEME_CHUNK, NZ_SOLVE, NX, NY, "chunk"),
                                  (3, 7, 33, 65, "ragged")):
            orb, u, w, alb, src = _k_inputs(B, z, x, y, norb, seed + z + x + nd, nd)
            k1, k2 = (scheme, idx, orb, u, w, alb), (scheme, idx, orb, src)
            Au, dots = cuda_ops.fused_A_dots(*k1)
            Au_p, dots_p = cuda_ops.fused_A_dots_plain(*k1)
            c = cuda_ops.orbit_contract(*k2)
            c_p = cuda_ops.orbit_contract_plain(idx, orb, src)
            torch.cuda.synchronize()
            e1 = (Au - Au_p).abs().max().item()
            d1 = ((dots - dots_p).abs() / dots_p.abs()).max().item()
            e2 = (c - c_p).abs().max().item()
            del Au, Au_p, c
            log(f"schemes kernels {name} (nd {nd}, norb {norb}) {tag} B={B} nz={z} nx={x} ny={y}: "
                f"K1 max abs {e1:.3e}, dots rel {d1:.3e}; K2 max abs {e2:.3e}")
            if not (e1 <= atol and d1 <= DOT_RTOL and e2 <= atol):
                raise AssertionError(f"schemes kernels {name}: a kernel disagrees with its plain "
                                     f"version at the {tag} shape (field atol {atol}, dot rtol "
                                     f"{DOT_RTOL})")
            if tag == "band":
                cost = _kernel_cost(cuda_ops, scheme, idx, B, z, x, y, norb)
                M = _orbit_group_tensor(cuda_ops, idx, norb)
                orb3, src3 = orb.view(B, norb, -1), src.view(B, nd, -1)
                lib_err = (torch.einsum("dos,boc,bsc->bdc", M, orb3, src3).view_as(c_p)
                           - c_p).abs().max().item()
                if not lib_err <= atol:
                    raise AssertionError(f"schemes kernels {name}: the K2 einsum disagrees")
                row["fused_A_dots"] = _report_entry(
                    f"fused_A_dots {name}", e1, cuda_ms(lambda: cuda_ops.fused_A_dots(*k1), 10),
                    cuda_ms(lambda: cuda_ops.fused_A_dots_plain(*k1), 2), *cost["fused_A_dots"])
                row["orbit_contract"] = _report_entry(
                    f"orbit_contract {name}", e2, cuda_ms(lambda: cuda_ops.orbit_contract(*k2), 10),
                    cuda_ms(lambda: cuda_ops.orbit_contract_plain(idx, orb, src), 2),
                    *cost["orbit_contract"],
                    cuda_ms(lambda: torch.einsum("dos,boc,bsc->bdc", M, orb3, src3), 2))
                del M, orb3, src3
            if tag == "chunk":  # phase 24's shape: a band chunk on the collapsed solve grid
                cost = _kernel_cost(cuda_ops, scheme, idx, B, z, x, y, norb)
                for kname, fn in (("fused_A_dots", lambda: cuda_ops.fused_A_dots(*k1)),
                                  ("orbit_contract", lambda: cuda_ops.orbit_contract(*k2))):
                    ms = cuda_ms(fn, 10)
                    bound = cost[kname][0] / HBM_BYTES_PER_S * 1e3
                    log(f"kernels timing {kname} {name} at B={B} nz={z}: {ms:.4f} ms (bound "
                        f"{bound:.4f} ms by bytes, {100 * bound / ms:.1f}% of the bound's rate)")
                    row[kname].update(chunk_ms=ms, chunk_bound_ms=bound)
            del orb, u, w, alb, src, c_p
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            cfg = cuda_ops.dense_launch_config(dtype, nd)
            log(f"schemes kernels {name} K3 launch {tag}: {cfg['threads']} threads and "
                f"{cfg['smem_bytes']} bytes of shared memory per block, {cfg['blocks_per_sm']} "
                f"blocks per SM")
            for (B, z, x_, y) in ((1, NZ, NX, NY), (3, 7, 13, 130)):
                c, x = k3_inputs(B, z, x_, y, dtype, seed, nd)
                out = k3_on_nan(cuda_ops, scheme, c, x)
                ref = cuda_ops.diffuse_apply_dense_plain(scheme, c, x)
                torch.cuda.synchronize()
                err = (out - ref).abs().max().item()
                del out, ref
                log(f"schemes kernels {name} K3 {tag} B={B} nz={z} nx={x_} ny={y}: max abs {err:.3e}")
                if not err <= atol:
                    raise AssertionError(f"schemes kernels {name}: K3 ({tag}) disagrees with its "
                                         f"plain version (field atol {atol})")
                if x_ == NX:
                    ms = cuda_ms(lambda: cuda_ops.diffuse_apply_dense(scheme, c, x), 10)
                    plain_ms = cuda_ms(lambda: cuda_ops.diffuse_apply_dense_plain(scheme, c, x), 2)
                    lib_ms = None
                    if dtype == torch.float32:
                        src = cuda_ops.gather_diff_src(scheme, x).contiguous()
                        lib_ms = cuda_ms(lambda: torch.einsum("bsdzxy,bszxy->bdzxy", c, src), 2)
                        del src
                    ncell, nface = z * x_ * y, (z + 1) * x_ * y
                    nbytes = B * (nd * nd * ncell * c.element_size() + 2 * nd * nface * 4)
                    row[f"diffuse_apply_dense_{tag}"] = _report_entry(
                        f"diffuse_apply_dense {name} ({tag})", err, ms, plain_ms, nbytes,
                        B * 2 * nd * nd * ncell, lib_ms)
                del c, x
                torch.cuda.empty_cache()
        rows[name] = row
    return rows


def solar_balance(solver, dz, theta):
    """|TOA up + column absorption + net surface flux - incoming beam| /
    incoming of the last solve's solar part (the JAX end-to-end gate)."""
    sol = solver.solutions[0]
    solver.solutions[0] = sol._replace(thermal=None)
    try:
        edir, edn, eup, abso = solver.get_result()
    finally:
        solver.solutions[0] = sol
    incoming = 1000.0 * float(np.cos(np.deg2rad(theta)))
    dzt = torch.as_tensor(dz, device=abso.device)[:, None, None]
    balance = (eup[0].mean() + (abso * dzt).sum(0).mean()
               + (edir[-1] + edn[-1] - eup[-1]).mean()).item()
    return abs(balance - incoming) / incoming


def phase_schemes(cuda_ops, OptProp, LUT, Grid, PprtsSolver, sundir, seed):
    """Phase 22: each scheme on phase 4's band at 256 x 256 x 39, a cold
    solar+thermal solve; K1/K2 launches per scheme."""
    dz = build_scene(NX, NY, seed)[0]
    launches = {}
    for name in SCHEMES:
        opp = scheme_opp(name, OptProp, LUT)
        solver, fields = make_solver(NX, NY, seed, opp, Grid, PprtsSolver, sundir)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_ops.reset_launch_counts()
        t0 = time.time()
        _, cold = solve_and_report(solver, fields, cuda_ops, f"schemes {name} cold")
        t_cold = time.time() - t0
        bal = solar_balance(solver, dz, SUN[1])
        got = dict(cuda_ops.LAUNCHES)
        log(f"schemes {name} (nd {opp.scheme.ndiff}) at {NX}x{NY}x{NZ}: cold {t_cold * 1e3:.1f} ms "
            f"(bicgstab+polish solar {cold[0]}+{cold[1]}, thermal {cold[2]}+{cold[3]}); solar "
            f"energy balance {100 * bal:.4f}% of the incoming beam; launches K1 {got['fused_A_dots']} K2 "
            f"{got['orbit_contract']} K3 {got['diffuse_apply_dense']}; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        if max(cold) >= 3000:
            raise AssertionError(f"schemes {name}: a solve reached 3000 iterations")
        if not bal < BALANCE_RTOL:
            raise AssertionError(f"schemes {name}: energy balance off by {100 * bal:.2f}%")
        if not (got["fused_A_dots"] and got["orbit_contract"]) or got["diffuse_apply_dense"]:
            raise AssertionError(f"schemes {name}: K1/K2 not launched, or K3 launched")
        launches[name] = got
        del solver, opp
        torch.cuda.empty_cache()
    return launches


def phase_schemes_parity(cuda_ops, ediff, OptProp, LUT, Grid, PprtsSolver, Options, sundir,
                         seed):
    """Phase 23: each scheme's 64 x 64 cloud scene through K1/K2, through
    their plain versions, and on dense coefficients through K3: the fields
    within 0.1 W/m2 and 1e-4 W/m3, iterations within NITER_SLACK of each
    comparison.  Returns
    K3's launches per scheme."""
    dense_launches = {}
    for name in SCHEMES:
        opp = scheme_opp(name, OptProp, LUT)
        runs = {}
        for label, plain, dense in (("kernels", False, False), ("plain", True, False),
                                    ("dense", False, True)):
            opts = Options({"pprts_orbit_coeffs": False}, read_env=False) if dense else None
            solver, fields = make_solver(64, 64, seed, opp, Grid, PprtsSolver, sundir, opts)
            cuda_ops.reset_launch_counts()
            with kernels_or_plain(cuda_ops, ediff, plain):
                runs[label] = solve_and_report(solver, fields, cuda_ops,
                                               f"schemes parity {name} {label}")
            got = dict(cuda_ops.LAUNCHES)
            want = {"kernels": (True, False), "plain": (False, False), "dense": (False, True)}
            if ((got["fused_A_dots"] > 0, got["diffuse_apply_dense"] > 0) != want[label]
                    or (got["orbit_contract"] > 0) != want[label][0]):
                raise AssertionError(f"schemes parity {name} {label}: launches {got}")
            if dense:
                dense_launches[name] = got["diffuse_apply_dense"]
        for a, b in (("kernels", "plain"), ("dense", "kernels")):
            _compare_solves(f"schemes parity {name} 64x64x{NZ} {a} vs {b}",
                            (runs[a][0], runs[b][0]))
            diff = max(abs(p - q) for p, q in zip(runs[a][1], runs[b][1]))
            slack = NITER_SLACK[(a, b)]
            log(f"schemes parity {name}: iterations (bicgstab, polish; solar, thermal) {a} "
                f"{runs[a][1]}, {b} {runs[b][1]}: " + ("equal" if not diff else f"{diff} apart")
                + f" (slack {slack})")
            if diff > slack:
                raise AssertionError(f"schemes parity {name}: iterations differ by more than "
                                     f"{slack}, {a} {runs[a][1]} vs {b} {runs[b][1]}")
        del opp, runs
    return dense_launches


def clouds_beyond_table(opp, gas, atm, lwc):
    """(beyond, cloud w0, the table's last w0): whether the clouds' solar
    single-scattering albedo (droplet optics at 10 um, delta-scaled as the
    solver's lookup sees it, the median over the cloud cells of each
    g-point, averaged over the g-points with the solar weights) lies above
    the last w0 of the table's axes, where the lookup clamps it."""
    cloud = lwc > 0
    dz = np.broadcast_to(atm.dz[:, None, None], lwc.shape)[cloud]
    lw = torch.as_tensor(lwc[cloud], device="cuda")
    _, w0, g = gas.cloud_optprops_gpt("sw", lw, torch.full_like(lw, 10.0),
                                      torch.as_tensor(dz, dtype=lw.dtype, device="cuda"))
    f = g * g
    w0_cloud = (w0 * (1 - f) / (1 - w0 * f)).median(dim=1).values
    weight = gas.solar(atm).weight.to(w0_cloud)
    w0_cloud = float((w0_cloud * weight).sum() / weight.sum())
    top = float(max(opp.lut.dir_axes.w0.max(), opp.lut.diff_axes.w0.max()))
    return w0_cloud > top, w0_cloud, top


def phase_spectral_scheme(cuda_ops, OptProp, LUT, seed, smi):
    """Phase 24: phase 12's full-spectrum run (ecCKD 32 + 32 on bench.py's
    scene, atm_collapse, the f32 warm cache) at SCHEME_SPEC_N x SCHEME_SPEC_N
    on a 3_30 solver in band chunks of SCHEME_CHUNK: a cold call."""
    opp = scheme_opp(SPECTRAL_SCHEME, OptProp, LUT)
    label = f"spectral {SPECTRAL_SCHEME}"
    n = SCHEME_SPEC_N
    log(f"{label}: band chunks of {SCHEME_CHUNK}; at 256x256 chunks of {CHUNK} do not fit the "
        f"card's 80 GB (61.8 GiB in use at the failing allocation, PERF.md section 4)")
    spec = make_spectral_solver(n, n, seed, opp)
    solver, atm, lwc, gas = spec
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cuda_ops.reset_launch_counts()
    res, cold, _ = spectral_solve(spec, lwc, cuda_ops, f"{label} cold", chunk=SCHEME_CHUNK)
    launches = dict(cuda_ops.LAUNCHES)
    log(f"{label}: {n}x{n}x{NZ}, atm_collapse {K_COLLAPSE}, ecCKD {NGPT}+{NGPT}, band chunks of "
        f"{SCHEME_CHUNK}: wall cold {cold * 1e3:.1f} ms = {n * n / cold:.1f} columns/s ({smi}); launches {launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    # a table whose w0 axis ends below the clouds' w0 clamps them to its last w0, and they
    # absorb as such clouds do, some 200-400 K/day; the JAX package gives the same on the same
    # table (tools/torch_heating_rates.py --lut); the clear air stays within the table
    beyond, w0_cloud, w0_top = clouds_beyond_table(opp, gas, atm, lwc)
    log(f"{label}: the clouds' solar w0 {w0_cloud:.6f}, the table's w0 axis ends at {w0_top:.6f}: "
        + ("every cloud cell is exempt from the heating-rate bound" if beyond
           else "only cloud tops are exempt"))
    check_spectral_result(label, res, atm, lwc, gas.solar(atm).weight, exempt_clouds=beyond)
    if not (launches["fused_A_dots"] and launches["orbit_contract"]):
        raise AssertionError(f"{label}: K1/K2 not launched")
    del spec, solver, res
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# the wedge-mesh solvers (phases 25-27): plain PyTorch on the card, no kernel
# ---------------------------------------------------------------------------

WEDGE_PHOTONS = 4000  # the committed full-density table (default_axes, 4000 photons)
WEDGE_ALBEDO = 0.15
WEDGE_BALANCE_RTOL = 0.01  # of the incoming beam: the JAX gate (tests/test_plexrt.py:80)
WEDGE_EDIR_RTOL = 1e-5  # TOA edir = edirTOA x mu
WEDGE_CHUNK = 8
WEDGE_18_8 = 64  # columns per side of the 18_8 solve on its test table
WEDGE_ROT = 16  # columns per side of the rotation check
WEDGE_ROT_ANGLE = 33.0
WEDGE_PROFILE_STEPS = 25  # fixed-point steps of phase 26's profiled chunk
# The solvers' defaults (n_inner 24, BiCGStab, diff_iters 300/1000) do not solve bench.py's
# column, in the JAX package or the port (tools/torch_wedge_column.py, ROADMAP section 3): 24
# side-exchange sweeps carry 20.7% of a transparent beam through its 2.5 km layers of 100 m
# cells, and BiCGStab stops at its stall limit far above its tolerance.  The gated solves use
# the solvers' own options that do: 128 sweeps (the transparent beam to 7.4e-5 of itself) and
# the fixed point, which converges in ~900 steps.
WEDGE_EXACT = dict(n_inner=128, diff_solver="fixedpoint", diff_iters=3000)


def wedge_opp(device="cuda"):
    """The committed full-density 5_8 table, resolved by its cache key."""
    from tenstream_tpu_torch.plexrt.optprop import (WedgeOptProp, default_axes,
                                                    load_or_create_wedge_lut, wedge_lut_path)

    d = default_axes()
    lut = load_or_create_wedge_lut(d, None, WEDGE_PHOTONS, device=device)
    name = os.path.basename(wedge_lut_path(d, lut.faxes, WEDGE_PHOTONS))
    return WedgeOptProp(lut), name


def wedge_opp_18_8(device="cuda"):
    """The committed 18_8 test table (the JAX package's `tests/test_wedge_schemes.py`)."""
    from tenstream_tpu_torch.plexrt.optprop import WedgeAxes, WedgeOptProp, load_or_create_wedge_lut

    axes = WedgeAxes(tau=np.array([1e-10, 0.5, 2.0, 8.0], np.float32),
                     w0=np.array([0.0, 0.7, 0.99999], np.float32),
                     aspect=np.array([0.5, 1.0, 2.0], np.float32),
                     g=np.array([0.0, 0.5], np.float32),
                     phi=np.linspace(0.0, 360.0, 5).astype(np.float32),
                     theta=np.array([0.0, 40.0, 75.0], np.float32))
    return WedgeOptProp(load_or_create_wedge_lut(axes, None, 1000, SCHEME_LUT_DIR, scheme="18_8",
                                                 device=device))


def both_orientations(a):
    """A column field (nz, nx, ny) on both triangles of every rectangle."""
    return np.ascontiguousarray(np.broadcast_to(a[:, None], (a.shape[0], 2) + a.shape[1:]))


def icon_cells(a):
    """(nz, 2, nx, ny) -> the cell order of `trimesh_from_structured`,
    c = 2 (i ny + j) + o."""
    return np.ascontiguousarray(np.moveaxis(a, 1, -1).reshape(a.shape[0], -1))


def wedge_scene(n, seed):
    """Phase 4's band (bench.py's column, its cloud blocks) on both
    orientations: dz, (kabs, ksca, g) (nz, 2, n, n), planck (nz+1, 2, n, n)."""
    dz, kabs, ksca, g, planck = build_scene(n, n, seed)
    return dz, tuple(both_orientations(a) for a in (kabs, ksca, g)), both_orientations(planck)


def wedge_solves(solver, fields, planck, label, gate=True, budget=None):
    """A solar solve (no emission) and a thermal solve of one band, timed
    together: (solar solution, thermal solution, wall [s], text, lateral
    escape [W/m2]).  Every solve must stop by the solver's own rule
    (tolerance, stall exit or diff_iters); with `gate`, at its tolerance
    below diff_iters.  With `budget`, the solar solve is `budget(solver)`
    -> (solution, lateral escape)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver.set_optical_properties(WEDGE_ALBEDO, *fields)
    sol_s, lateral = (budget(solver) if budget is not None else
                      (solver.solve(lthermal=False, lsolar=True, edirTOA=1000.0), 0.0))
    solver.set_optical_properties(WEDGE_ALBEDO, *fields, planck=planck)
    sol_t = solver.solve(lthermal=True, lsolar=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for what, sol in (("solar", sol_s), ("thermal", sol_t)):
        stopped = sol.niter_diff <= solver.diff_iters and np.isfinite(sol.diff_res)
        converged = sol.diff_res <= sol.diff_tol and sol.niter_diff < solver.diff_iters
        if not stopped or (gate and not converged):
            raise AssertionError(f"{label} {what}: niter {sol.niter_diff}, res {sol.diff_res}, "
                                 f"tol {sol.diff_tol}, diff_iters {solver.diff_iters}")
    text = (f"niter solar {sol_s.niter_diff} (res/tol {sol_s.diff_res / sol_s.diff_tol:.4g}), "
            f"thermal {sol_t.niter_diff} (res/tol {sol_t.diff_res / sol_t.diff_tol:.4g})")
    return sol_s, sol_t, wall, text, lateral


def solver_dz(solver):
    return solver.grid.dz if hasattr(solver, "grid") else solver.dz


def wedge_balance(label, solver, res_s, mu, lateral=0.0, gate=True):
    """The solar solve's energy budget [W/m2 of the domain]: TOA up +
    absorbed + surface net (+ lateral escape) against the incoming beam,
    within WEDGE_BALANCE_RTOL (with `gate`); TOA edir = 1000 mu within
    WEDGE_EDIR_RTOL; finite fields."""
    edir, edn, eup, abso = res_s
    for name, a in zip(("edir", "edn", "eup", "abso"), res_s):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{label}: non-finite {name}")
    incoming = 1000.0 * mu
    toa = edir[0].mean().item()
    dzv = torch.as_tensor(solver_dz(solver), device=abso.device).reshape(
        (-1,) + (1,) * (abso.dim() - 1))
    bal = (eup[0].mean() + (abso * dzv).sum(0).mean()
           + (edir[-1] + edn[-1] - eup[-1]).mean()).item() + lateral
    off = abs(bal - incoming) / incoming
    log(f"{label}: TOA edir {toa:.4f} W/m2 (1000 mu {incoming:.4f}); surface edir "
        f"{edir[-1].mean().item():.4f}; balance {bal:.4f} W/m2 of the incoming {incoming:.4f}"
        + (f" (lateral escape {lateral:.4f} counted)" if lateral else "")
        + f": {100 * off:.4f}% off" + ("" if gate else " (not gated: the solvers' defaults)"))
    if abs(toa - incoming) > WEDGE_EDIR_RTOL * incoming:
        raise AssertionError(f"{label}: TOA edir {toa} is not 1000 mu = {incoming}")
    if gate and off > WEDGE_BALANCE_RTOL:
        raise AssertionError(f"{label}: energy balance {bal} off the incoming {incoming} by more "
                             f"than {WEDGE_BALANCE_RTOL:.0%}")


def wedge_profile(label, run):
    """`run()` timed, then under torch.profiler: (its result, the
    unprofiled wall [s]), logging the device busy share of that wall and
    the kernels launched."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _, by_name = device_kernels(run)
    busy = sum(t for t, _ in by_name.values())
    n = sum(k for _, k in by_name.values())
    if busy == 0:
        log(f"{label}: the profiler recorded no device time; busy share not measured")
        return out, wall
    log(f"{label}: device busy {busy:.1f} ms in {n} kernel launches = "
        f"{100 * busy / (wall * 1e3):.1f}% of the unprofiled wall {wall * 1e3:.1f} ms")
    for name, (t, k) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]:
        log(f"{label}   {t:9.2f} ms {k:7d} launches  {name[:90]}")
    return out, wall


def no_cube_kernels(cuda_ops, label):
    if any(cuda_ops.LAUNCHES.values()):
        raise AssertionError(f"{label}: the wedge path launched cube kernels {cuda_ops.LAUNCHES}")


def wedge_runs(label, make, fields, planck, mu, smi, budget=None):
    """The wedge band on the solvers' defaults (twice, the second run also
    profiled) and on WEDGE_EXACT (gated: converged, energy balance);
    `budget(solver)` gives the solar solution and its lateral escape
    [W/m2].  Returns (defaults solver, its thermal solution, the exact
    solar result, the exact solver, its solar and thermal solutions)."""
    solver = make()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    run = lambda: wedge_solves(solver, fields, planck, label, gate=False)
    sol_s, sol_t, wall, text, _ = run()
    log(f"{label} defaults run 1: wall {wall * 1e3:.1f} ms; {text}")
    (sol_s, sol_t, _, text, _), wall2 = wedge_profile(f"{label} defaults run 2 profile", run)
    log(f"{label} defaults run 2: wall {wall2 * 1e3:.1f} ms; {text}")
    check_finite(f"{label} thermal", solver.get_result(sol_t))
    wedge_balance(f"{label} defaults solar", solver, solver.get_result(sol_s), mu, gate=False)
    log(f"{label} defaults: walls {wall * 1e3:.1f} / {wall2 * 1e3:.1f} ms ({smi}); peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    out = (solver, sol_t)

    solver = make(**WEDGE_EXACT)
    torch.cuda.reset_peak_memory_stats()
    sol_s, sol_t, wall, text, lateral = wedge_solves(solver, fields, planck, f"{label} exact",
                                                     budget=budget)
    log(f"{label} {WEDGE_EXACT}: wall {wall * 1e3:.1f} ms; {text}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    check_finite(f"{label} exact thermal", solver.get_result(sol_t))
    exact = solver.get_result(sol_s)
    wedge_balance(f"{label} exact solar", solver, exact, mu, lateral=lateral)
    return out + (exact, solver, sol_s, sol_t)


def phase_wedge(cuda_ops, wopp, seed, smi):
    """Phase 25: the structured wedge solver (5_8) at 256 x 256 x 39 on the
    committed full-density table (`wopp`: wedge_opp()); then 18_8 on its
    test table at 64 x 64.  Returns the 5_8 WEDGE_EXACT solar solve for
    phase 29: (domain-mean TOA eup, surface edir + edn per column, the two
    triangles averaged), and that solve's fields and niter for phase 32
    (`wedge_reference`)."""
    from tenstream_tpu_torch.plexrt.mesh import fish_mesh
    from tenstream_tpu_torch.plexrt.solver import PlexrtSolver
    from tenstream_tpu_torch.pprts.sun import sundir_from_angles

    opp, name = wopp
    dz, fields, planck = wedge_scene(NX, seed)
    sun = sundir_from_angles(*SPECTRAL_SUN)
    mu = float(np.cos(np.deg2rad(SPECTRAL_SUN[1])))
    label = f"wedge 5_8 {NX}x{NY}x{NZ}"
    log(f"{label}: {2 * NX * NY} triangle columns, table {name}, sun {SPECTRAL_SUN}, albedo "
        f"{WEDGE_ALBEDO}; each run a solar (edirTOA 1000 W/m2) and a thermal solve")

    def make(**kw):
        s = PlexrtSolver(fish_mesh(NZ, NX, NY, 100.0, 100.0, dz), opp, **kw)
        s.set_angles(sun)
        return s

    cuda_ops.reset_launch_counts()
    runs = wedge_runs(label, make, fields, planck, mu, smi)
    edir, edn, eup, _ = runs[2]
    # phase 29's yardstick: the WEDGE_EXACT solar solve, the two triangles of
    # every rectangle averaged
    exact = (eup[0].mean().item(), (edir[-1] + edn[-1]).mean(0).cpu())
    ref = wedge_reference(*runs[3:])
    del edir, edn, eup, runs
    no_cube_kernels(cuda_ops, label)
    torch.cuda.empty_cache()

    n = WEDGE_18_8
    dz, fields, planck = wedge_scene(n, seed)
    label = f"wedge 18_8 {n}x{n}x{NZ} (its test table, tests/data/luts)"
    s18 = PlexrtSolver(fish_mesh(NZ, n, n, 100.0, 100.0, dz), wedge_opp_18_8(), **WEDGE_EXACT)
    s18.set_angles(sun)
    sol_s, sol_t, wall, text, _ = wedge_solves(s18, fields, planck, label)
    log(f"{label} {WEDGE_EXACT}: wall {wall * 1e3:.1f} ms; {text}")
    check_finite(f"{label} thermal", s18.get_result(sol_t))
    wedge_balance(f"{label} solar", s18, s18.get_result(sol_s), mu)
    torch.cuda.empty_cache()
    return exact, ref


def wedge_reference(solver, sol_s, sol_t, nca=False):
    """A WEDGE_EXACT run's solar and thermal fields (on the host), niter
    and (with `nca`) the NCA of its thermal solve: what phase 32 holds
    the decomposed runs to."""
    out = dict(solar=[a.cpu() for a in solver.get_result(sol_s)],
               thermal=[a.cpu() for a in solver.get_result(sol_t)[1:]],
               niter=(sol_s.niter_diff, sol_t.niter_diff))
    if nca:
        out["nca"] = solver.nca_absorption(sol_t).cpu()
    return out


def check_wedge_spectral(label, res, atm, lwc2, weight):
    """Phase 12's gates on a wedge spectral result (no atm_collapse):
    finite fields, TOA edir = the sum of the solar weights x mu within 1%,
    heating rates below HR_MAX outside the cloud tops."""
    from tenstream_tpu_torch.atm import abso2hr

    check_finite(label, res)
    check_toa(label, res.edir, weight, float(np.cos(np.deg2rad(SPECTRAL_SUN[1]))))
    col = (slice(None),) + (None,) * (res.abso.dim() - 1)
    hr = abso2hr(res.abso, atm.play[col], atm.tlay[col])
    cloud = torch.as_tensor(lwc2 > 0, device=hr.device)
    top = cloud[1:] & ~cloud[:-1]
    hr_other = max(hr[1:].abs()[~top].max().item(), hr[0].abs().max().item())
    log(f"{label}: heating rates max |{hr.abs().max().item():.2f}| K/day; cloud-top cells up to "
        f"{hr[1:].abs()[top].max().item():.2f} K/day, every other cell up to {hr_other:.2f} K/day")
    if not (bool(torch.isfinite(hr).all()) and hr_other < HR_MAX):
        raise AssertionError(f"{label}: heating rates non-finite or above {HR_MAX} K/day outside "
                             "the cloud tops")


def wedge_specint(solver, atm, lwc2, gas, label, lthermal=True, first=None, lsolar=True, **kw):
    """One solar (+ thermal) `specint_plexrt` call: (result, wall [s], text
    on the lanes' niter and res/tol per chunk, lanes above tolerance).
    Every lane must stop by the solver's own rule.  With a dict `first`, the
    first chunk of each spectrum is kept there ("solar" / "thermal": its
    solution and wall [s])."""
    from tenstream_tpu_torch.spectral.specint_plexrt import specint_plexrt

    chunks = []
    lanes = solver.solve_lanes
    sync = torch.cuda.synchronize if solver.device.type == "cuda" else (lambda: None)

    def seen(*a, **k):
        kind = "solar" if a[1] else "thermal"
        keep = first is not None and kind not in first
        if keep:
            sync()
            t0 = time.perf_counter()
        sol = lanes(*a, **k)
        if keep:
            sync()
            first[kind] = (sol, time.perf_counter() - t0)
        ratio = (sol.diff_res / sol.diff_tol).tolist()
        chunks.append((sol.niter_diff.tolist(), ratio))
        if max(chunks[-1][0]) > solver.diff_iters or not np.isfinite(ratio).all():
            raise AssertionError(f"{label}: a lane did not stop by the solver's rule: {chunks[-1]}")
        return sol

    solver.solve_lanes = seen
    try:
        sync()
        t0 = time.perf_counter()
        res = specint_plexrt(solver, atm, WEDGE_ALBEDO, lthermal, lsolar, specint=gas, lwc=lwc2,
                             **kw)
        sync()
        wall = time.perf_counter() - t0
    finally:
        del solver.solve_lanes
    above = sum(r > 1.0 for _, rs in chunks for r in rs)
    text = (f"niter per chunk (solar, then thermal) {[n for n, _ in chunks]}; {above} of "
            f"{sum(len(n) for n, _ in chunks)} lanes stopped above their tolerance (largest "
            f"res/tol {max(r for _, rs in chunks for r in rs):.4g})")
    return res, wall, text, above


def phase_wedge_spectral(cuda_ops, opp, seed, smi):
    """Phase 26: `specint_plexrt`, ecCKD 32 + 32, on phase 25's scene with
    bench.py's cloud field on both orientations, WEDGE_EXACT, band chunks
    of WEDGE_CHUNK: one cold call, gated, then the first thermal chunk
    profiled over WEDGE_PROFILE_STEPS steps.  Returns the cold call's first
    chunk of each spectrum, reduced as `specint_plexrt(max_gpt=WEDGE_CHUNK)`
    reduces them, with their walls: phase 32 (a)'s undecomposed run.
    No perturbed step: the wedge spectral path has no warm start (as in the
    JAX package), so a step repeats the cold call's work (PERF.md)."""
    from tenstream_tpu_torch.plexrt.mesh import fish_mesh
    from tenstream_tpu_torch.plexrt.solver import PlexrtSolver
    from tenstream_tpu_torch.pprts.sun import sundir_from_angles
    from tenstream_tpu_torch.spectral.ecckd import EcckdGasOptics

    atm, lwc = build_bench_atm(NX, NY, seed)
    lwc2 = both_orientations(lwc)
    gas = EcckdGasOptics(n_gpt=NGPT)
    solver = PlexrtSolver(fish_mesh(atm.nlay, NX, NY, 100.0, 100.0, atm.dz.astype(np.float32)),
                          opp, **WEDGE_EXACT)
    solver.set_angles(sundir_from_angles(*SPECTRAL_SUN))
    label = f"wedge spectral {NX}x{NY}x{atm.nlay}"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cuda_ops.reset_launch_counts()
    first = {}
    res, wall, text, above = wedge_specint(solver, atm, lwc2, gas, f"{label} cold",
                                           band_chunk=WEDGE_CHUNK, first=first)
    (sol_s, wall_s), (sol_t, wall_t) = first["solar"], first["thermal"]
    area = solver.areas()
    # the sums and order of specint_plexrt's accumulation: solar, then thermal
    chunk_ref = ([a.cpu() for a in (sol_s.edir.sum(0) / area,
                                    (sol_s.edn.sum(0) + sol_t.edn.sum(0)) / area,
                                    (sol_s.eup.sum(0) + sol_t.eup.sum(0)) / area,
                                    sol_s.abso.sum(0) + sol_t.abso.sum(0))],
                 wall_s + wall_t, (sol_s.niter_diff.tolist(), sol_t.niter_diff.tolist()))
    del first, sol_s, sol_t
    log(f"{label} cold ({WEDGE_EXACT}): {text}")
    if above:
        raise AssertionError(f"{label}: {above} lanes above their tolerance")
    check_wedge_spectral(f"{label} cold", res, atm, lwc2, gas.solar(atm).weight)
    no_cube_kernels(cuda_ops, label)
    log(f"{label}: ecCKD {NGPT}+{NGPT} in chunks of {WEDGE_CHUNK}: wall {wall * 1e3:.1f} ms = "
        f"{2 * NX * NY / wall:.1f} triangle columns/s ({smi}); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; K1-K4 launches 0")
    del res, solver
    # the busy share of the fixed point's steady state: the first thermal chunk (no direct
    # sweep before its diffuse steps), its lanes stopped after WEDGE_PROFILE_STEPS steps
    # (not gated)
    solver = PlexrtSolver(fish_mesh(atm.nlay, NX, NY, 100.0, 100.0, atm.dz.astype(np.float32)),
                          opp, **{**WEDGE_EXACT, "diff_iters": WEDGE_PROFILE_STEPS})
    solver.set_angles(sundir_from_angles(*SPECTRAL_SUN))
    wedge_profile(f"{label} profile (the first thermal chunk, {WEDGE_PROFILE_STEPS} steps)",
                  lambda: wedge_specint(solver, atm, lwc2, gas, label, lsolar=False,
                                        band_chunk=WEDGE_CHUNK, max_gpt=WEDGE_CHUNK))
    del solver
    torch.cuda.empty_cache()
    return chunk_ref


def icon_budget(solver, edir_toa=1000.0):
    """A solar solve of a PlexrtSolverIcon with its lateral escape [W/m2 of
    the domain]: the direct and diffuse side outflow through open
    boundaries, read off the solve by wrapping the direct sweep and the
    diffuse iteration."""
    import tenstream_tpu_torch.plexrt.solver as solver_mod

    seen = {}
    sweep, iterate = solver._solve_edir, solver_mod.iterate_diffuse

    def sweep_seen(*a):
        out = sweep(*a)
        seen["escaped"] = out[3]
        return out

    def iterate_seen(*a):
        out = iterate(*a)
        seen["F"] = out[1]
        return out

    solver._solve_edir, solver_mod.iterate_diffuse = sweep_seen, iterate_seen
    try:
        sol = solver.solve(lthermal=False, lsolar=True, edirTOA=edir_toa)
    finally:
        del solver._solve_edir
        solver_mod.iterate_diffuse = iterate
    area = solver._area.sum().item()
    lateral = (seen["escaped"].sum() + (seen["F"][0].sum(dim=(0, 1))
                                        * (1.0 - solver._ex_mask)).sum()).item() / area
    return sol, lateral


def phase_wedge_icon(cuda_ops, opp, seed, smi):
    """Phase 27: an ICON grid file of trimesh_from_structured(256, 256)
    written and read back, solved by PlexrtSolverIcon on phase 25's scene
    (defaults timed, NCA, and the gated solve with its lateral escape); the
    rotation check at 16 x 16; card against CPU on crops for both wedge
    solvers (the CPU sides in a process of their own from the phase's
    start).  Returns the mesh read back and the gated solve's fields,
    niter and NCA for phase 32."""
    with tempfile.TemporaryDirectory() as tmp:
        cpu_side = start_wedge_crops_cpu(seed, tmp)
        try:
            return _wedge_icon(cuda_ops, opp, seed, smi, cpu_side)
        finally:
            if cpu_side[0].poll() is None:
                cpu_side[0].kill()
                cpu_side[0].wait()


def _wedge_icon(cuda_ops, opp, seed, smi, cpu_side):
    from tenstream_tpu_torch.plexrt import icon
    from tenstream_tpu_torch.plexrt.solver_unstructured import PlexrtSolverIcon
    from tenstream_tpu_torch.pprts.sun import sundir_from_angles

    mu = float(np.cos(np.deg2rad(SPECTRAL_SUN[1])))
    sun = sundir_from_angles(*SPECTRAL_SUN)
    t0 = time.perf_counter()
    mesh0 = icon.trimesh_from_structured(NX, NY, 100.0, 100.0)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "icon_grid.nc")
        icon.write_icon_grid(path, mesh0)
        size = os.path.getsize(path)
        mesh = icon.read_icon_grid(path)
    if not (np.array_equal(mesh.nbr, mesh0.nbr) and np.array_equal(mesh.nbr_side, mesh0.nbr_side)):
        raise AssertionError("ICON grid file: topology changed in the round trip")
    label = f"wedge ICON {mesh.ncell} cells x {NZ}"
    log(f"{label}: grid written ({size / 1e6:.1f} MB) and read back in "
        f"{time.perf_counter() - t0:.1f} s, topology equal")
    dz, fields, planck = wedge_scene(NX, seed)
    fields = tuple(icon_cells(a) for a in fields)
    planck = icon_cells(planck)

    def make(**kw):
        s = PlexrtSolverIcon(mesh, dz, opp, **kw)
        s.set_angles(sun)
        return s

    cuda_ops.reset_launch_counts()
    solver, sol_t, _, xsolver, xsol_s, xsol_t = wedge_runs(label, make, fields, planck, mu, smi,
                                                          budget=icon_budget)
    ref = wedge_reference(xsolver, xsol_s, xsol_t, nca=True)
    del xsolver, xsol_s, xsol_t
    solver.set_optical_properties(WEDGE_ALBEDO, *fields, planck=planck)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nca = solver.nca_absorption(sol_t)
    torch.cuda.synchronize()
    nca_ms = (time.perf_counter() - t0) * 1e3
    if not bool(torch.isfinite(nca).all()):
        raise AssertionError(f"{label}: non-finite NCA absorption")
    log(f"{label}: NCA {nca_ms:.1f} ms, |abso| up to {nca.abs().max().item():.4e} W/m3 (the 1-D "
        f"thermal solve's {sol_t.abso.abs().max().item():.4e})")
    no_cube_kernels(cuda_ops, label)
    del solver, sol_t, nca
    torch.cuda.empty_cache()

    # rotating mesh and sun together leaves every flux the same
    # (tests/test_plexrt_icon.py::test_rotation_invariance and its gates)
    n = WEDGE_ROT
    base = icon.trimesh_from_structured(n, n, 100.0, 100.0)
    rot = icon.rotate_mesh(base, WEDGE_ROT_ANGLE)
    dzr, fr, _ = wedge_scene(n, seed)
    fr = tuple(icon_cells(a) for a in fr)
    outs = []
    for m, phi in ((base, SPECTRAL_SUN[0]), (rot, SPECTRAL_SUN[0] - WEDGE_ROT_ANGLE)):
        s = PlexrtSolverIcon(m, dzr, opp, **WEDGE_EXACT)
        s.set_optical_properties(WEDGE_ALBEDO, *fr)
        s.set_angles(wedge_sundir(phi, SPECTRAL_SUN[1]))
        outs.append(s.get_result(s.solve(lthermal=False, lsolar=True, edirTOA=1000.0)))
    errs = []
    for name, a, b, rtol, atol in zip(("edir", "edn", "eup", "abso"), *outs,
                                      (1e-4, 1e-3, 1e-3, 2e-3), (1e-3, 1e-2, 1e-2, 1e-7)):
        bad = ((a - b).abs() > atol + rtol * b.abs()).sum().item()
        errs.append(f"{name} {(a - b).abs().max().item():.3e}")
        if bad:
            raise AssertionError(f"rotation check {n}x{n}: {name} differs in {bad} cells")
    log(f"wedge ICON rotation by {WEDGE_ROT_ANGLE} deg at {n}x{n} ({WEDGE_EXACT}): max |diff| "
        + ", ".join(errs) + " (the JAX test's gates held)")

    wedge_card_vs_cpu(seed, cpu_side)
    return mesh, ref


def wedge_sundir(phi_deg, theta_deg):
    """Photon direction for a sun at azimuth phi (from +y toward +x, the
    wedge tests' convention) and zenith theta."""
    p, t = np.deg2rad(phi_deg), np.deg2rad(theta_deg)
    return np.array([np.sin(p) * np.sin(t), np.cos(p) * np.sin(t), -np.cos(t)])


def wedge_crop_runs(seed, dev):
    """Phase 27's crops of both wedge solvers on `dev`: [(label, n, run)] with
    `run()` giving the crop's fields, monochromatic solar+thermal on
    WEDGE_EXACT (converged solves; a stall exit's iterate is not
    reproducible across devices), and through specint_plexrt (max_gpt 8):
    the fish solver's solar and thermal lanes on WEDGE_EXACT (CROP), the
    ICON solver's one chunk of 8 solar lanes on its default BiCGStab
    (n_inner 128; ICON_CROP), every lane converged."""
    from tenstream_tpu_torch.plexrt import icon
    from tenstream_tpu_torch.plexrt.mesh import fish_mesh
    from tenstream_tpu_torch.plexrt.solver import PlexrtSolver
    from tenstream_tpu_torch.plexrt.solver_unstructured import PlexrtSolverIcon
    from tenstream_tpu_torch.pprts.sun import sundir_from_angles
    from tenstream_tpu_torch.spectral.ecckd import EcckdGasOptics
    from tenstream_tpu_torch.spectral.specint_plexrt import specint_plexrt

    opp = wedge_opp(dev)[0]

    def scene(n):
        dz, fields, planck = wedge_scene(n, seed)
        atm, lwc = build_bench_atm(n, n, seed)
        return dz, fields, planck, atm, both_orientations(lwc)

    def solver(kind, n, dzv, **kw):
        if kind == "fish":
            s = PlexrtSolver(fish_mesh(len(dzv), n, n, 100.0, 100.0, dzv), opp, **kw)
        else:
            s = PlexrtSolverIcon(icon.trimesh_from_structured(n, n, 100.0, 100.0), dzv, opp, **kw)
        s.set_angles(sundir_from_angles(*SPECTRAL_SUN))
        return s

    def mono(kind, n):
        cells = (lambda a: a) if kind == "fish" else icon_cells
        dz, fields, planck, _, _ = scene(n)
        s = solver(kind, n, dz, **WEDGE_EXACT)
        s.set_optical_properties(WEDGE_ALBEDO, *(cells(a) for a in fields), planck=cells(planck))
        return s.get_result(s.solve(lthermal=True, lsolar=True, edirTOA=1000.0))

    def fish_spectral(n):
        *_, atm, lwc2 = scene(n)
        s = solver("fish", n, atm.dz.astype(np.float32), **WEDGE_EXACT)
        return specint_plexrt(s, atm, WEDGE_ALBEDO, True, True, specint=EcckdGasOptics(n_gpt=NGPT),
                              lwc=lwc2, max_gpt=WEDGE_CHUNK, band_chunk=WEDGE_CHUNK)

    def icon_spectral(n):
        *_, atm, lwc2 = scene(n)
        # the default diffuse solver's lanes: the crop's first solar chunk, on which every
        # BiCGStab lane of the ICON solver converges (its open boundary lets the diffuse
        # light out; the fish mesh's periodic column stalls, ROADMAP section 3)
        s = solver("icon", n, atm.dz.astype(np.float32), n_inner=WEDGE_EXACT["n_inner"])
        label = f"wedge icon specint_plexrt BiCGStab on {dev}"
        res, _, text, above = wedge_specint(s, atm, icon_cells(lwc2), EcckdGasOptics(n_gpt=NGPT),
                                            label, lthermal=False, max_gpt=WEDGE_CHUNK,
                                            band_chunk=WEDGE_CHUNK)
        log(f"{label}: {text}")
        if above:
            raise AssertionError(f"{label}: {above} lanes above their tolerance")
        return res

    runs = []
    for kind, spectral, n, what in (
            ("fish", fish_spectral, CROP, "fixed point, solar + thermal"),
            ("icon", icon_spectral, ICON_CROP, "BiCGStab, solar")):
        runs.append((f"wedge {kind} monochromatic", CROP, lambda k=kind: mono(k, CROP)))
        runs.append((f"wedge {kind} specint_plexrt ({what}, max_gpt {WEDGE_CHUNK})", n,
                     lambda f=spectral, m=n: f(m)))
    return runs


def wedge_crops_cpu(path_out: str, seed: str) -> None:
    """The CPU sides of phase 27's crops, run in a process of its own while the
    card works: each crop's fields to path_out."""
    out = {}
    for k, (_, n, run) in enumerate(wedge_crop_runs(int(seed), "cpu")):
        with cpu_threads(n):
            t0 = time.perf_counter()
            fields = [a for a in run() if a is not None]
            out[f"{k}_wall"] = np.asarray(time.perf_counter() - t0)
        for q, a in enumerate(fields):
            out[f"{k}_{q}"] = a.numpy()
    np.savez(path_out, **out)


def start_wedge_crops_cpu(seed, tmp):
    """Start `wedge_crops_cpu` in a process of its own: (process, its npz)."""
    path = os.path.join(tmp, "wedge_crops_cpu.npz")
    proc = subprocess.Popen([sys.executable, "-c", "import sys, chip_smoke; "
                             "chip_smoke.wedge_crops_cpu(*sys.argv[1:])", path, str(seed)],
                            cwd=REPO)
    return proc, path


def wedge_card_vs_cpu(seed, cpu_side):
    """Both wedge solvers on crops on the card, held to the same crops on the
    CPU (`cpu_side`: the process of `start_wedge_crops_cpu` and its npz) with
    phase 19's gates."""
    proc, path = cpu_side
    runs = wedge_crop_runs(seed, "cuda")
    cards = []
    for label, n, run in runs:
        with cpu_threads(n):
            cards.append(tuple(a.cpu() for a in run() if a is not None))
    try:
        if proc.wait(timeout=900) != 0:
            raise AssertionError(f"wedge crops: the CPU side failed (exit {proc.returncode})")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    z = np.load(path)
    for k, ((label, n, _), card) in enumerate(zip(runs, cards)):
        cpu = tuple(torch.as_tensor(z[f"{k}_{q}"]) for q in range(len(card)))
        hold_crop(f"{label} (the CPU's {float(z[f'{k}_wall']):.1f} s in a process of its own)",
                  (card, cpu), n)


# ---------------------------------------------------------------------------
# wedge tables (phase 28): the wedge photon tracer, plain PyTorch on the card
# ---------------------------------------------------------------------------

TRACE_APEX = (0.5, 0.866)  # a near-equilateral cell, (a)'s shape
TRACE_PHOTONS = 400  # (a) and (d)
ICON_PHOTONS = 2000  # examples/ex_plexrt_icon.py's wedge_lut_for_mesh(mesh, n_photons=2000)
SHAPED_N = 16  # columns per side of (d)'s distorted mesh


def trace_axes():
    """(a)'s axes: two values per axis, three phi (tests/test_torch_wedge_tables.py's)."""
    from tenstream_tpu_torch.plexrt.optprop import WedgeAxes

    f = lambda *v: np.array(v, np.float32)
    return WedgeAxes(f(0.5, 4.0), f(0.5, 0.99), f(0.5, 1.0), f(0.0, 0.85),
                     np.linspace(0.0, 360.0, 3).astype(np.float32), f(20.0, 60.0))


def _lut_on(lut, device):
    return lut._replace(**{k: getattr(lut, k).to(device)
                           for k in ("dir2dir", "dir2diff", "diff2diff")})


def check_wedge_table(label, lut):
    for k in ("dir2dir", "dir2diff", "diff2diff"):
        t = getattr(lut, k)
        if not bool(torch.isfinite(t).all()) or t.sum(-1).max().item() > 1.0 + 1e-3:
            raise AssertionError(f"{label}: {k} has non-finite entries or row sums above 1")


def phase_wedge_tables(cuda_ops, seed, smi):
    """Phase 28: wedge table creation on the card.  (a) create_wedge_lut at
    TRACE_APEX on trace_axes() at 400 photons, on the card and on the CPU
    from one seed: every coefficient within 2 photons' weight + 1e-5; (b) the
    ICON user's table, wedge_lut_for_mesh(trimesh_equilateral(256, 256, 100),
    n_photons=2000) traced on the card (test_axes at the mean apex): wall,
    photons/s, photon-steps/s, the live share per step, peak memory, the
    busy share, finite rows within 1; (c) PlexrtSolverIcon on that mesh with
    (b)'s table, phase 25's scene on WEDGE_EXACT: converged, TOA edir, the
    solar balance with the lateral escape, and (ungated) the flux difference
    from the canonical test table (tests/data/luts, the same axes): the shape
    effect; (d) WedgeOptPropShaped (four corner tables at (a)'s axes traced on
    the card by wedge_optprop_for_mesh) on a distorted 16 x 16 mesh, solved
    on the card and on the CPU with the same tables: phase 19's crop gates;
    (e) K1-K4 launch 0 times."""
    from tenstream_tpu_torch.plexrt import icon
    from tenstream_tpu_torch.plexrt import optprop as W
    from tenstream_tpu_torch.plexrt import wedge_boxmc
    from tenstream_tpu_torch.plexrt.solver_unstructured import PlexrtSolverIcon
    from tenstream_tpu_torch.pprts.sun import sundir_from_angles

    cuda_ops.reset_launch_counts()
    sun = sundir_from_angles(*SPECTRAL_SUN)
    mu = float(np.cos(np.deg2rad(SPECTRAL_SUN[1])))

    # (a) the tracer on the card against the CPU
    a = trace_axes()
    fa = W.WedgeAxes(a.tau, a.w0, a.aspect, a.g)
    luts = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        luts[dev] = W.create_wedge_lut(a, fa, TRACE_PHOTONS, seed=seed, apex=TRACE_APEX,
                                       device=dev)
        if dev == "cuda":
            torch.cuda.synchronize()
        log(f"wedge tables (a) create_wedge_lut on {dev}: {time.perf_counter() - t0:.2f} s")
    diffs = [(getattr(luts["cuda"], k).cpu() - getattr(luts["cpu"], k)).abs()
             for k in ("dir2dir", "dir2diff", "diff2diff")]
    d = torch.cat([x.reshape(-1) for x in diffs])
    bound = 2.0 / TRACE_PHOTONS + 1e-5
    log(f"wedge tables (a) card vs CPU at apex {TRACE_APEX}, {TRACE_PHOTONS} photons: "
        f"{int((d > 0).sum())} of {d.numel()} coefficients differ at all, max "
        f"{d.max().item():.3e} (gate {bound:.3e}), {int((d > 1e-5).sum())} by more than 1e-5")
    if d.max().item() > bound:
        raise AssertionError("wedge tables (a): card and CPU tables differ by more than two "
                             "photons' weight")

    # (b) the ICON user's table
    mesh = icon.trimesh_equilateral(NX, NY, 100.0)
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        wedge_boxmc.reset_stats()
        t0 = time.perf_counter()
        lut = W.wedge_lut_for_mesh(mesh, n_photons=ICON_PHOTONS, basename=tmp, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stats = dict(wedge_boxmc.STATS)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check_wedge_table("wedge tables (b)", lut)
    # the busy share on the table's diffuse sources, timed and then traced again under
    # torch.profiler (the whole table would put ~10^6 launches into one trace)
    diffuse = lambda: W._trace_jobs([(lut.faxes, src, False, 100 + src) for src in range(W.NDIFF)],
                                    ICON_PHOTONS, apex=lut.apex, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    diffuse()
    torch.cuda.synchronize()
    wall_diff = time.perf_counter() - t0
    _, by_name = device_kernels(diffuse)
    busy = sum(t for t, _ in by_name.values())
    live = np.asarray(stats["live"], np.float64)
    label = f"wedge tables (b) wedge_lut_for_mesh(trimesh_equilateral({NX}, {NY}))"
    log(f"{label}: apex ({lut.apex[0]:.4f}, {lut.apex[1]:.4f}), {lut.dir2dir[..., 0, 0].numel()} "
        f"direct x {W.n_dir_src()} sources + {lut.diff2diff[..., 0, 0].numel()} diffuse x "
        f"{W.NDIFF}, {stats['photons']} photons in {wall:.2f} s = {stats['photons'] / wall:.4g} "
        f"photons/s, {stats['photon_steps']} photon-steps = {stats['photon_steps'] / wall:.4g}/s "
        f"({smi}); {stats['steps']} steps, live share per step mean "
        f"{live.mean() / stats['photons']:.4f} (first 10 steps "
        f"{live[:10].sum() / live.sum():.3f} of the photon-steps); peak device memory "
        f"{peak:.2f} GiB")
    log(f"{label}: its diffuse sources alone {wall_diff * 1e3:.1f} ms; under torch.profiler "
        f"device busy {busy:.1f} ms in {sum(n for _, n in by_name.values())} kernel launches = "
        f"{100 * busy / (wall_diff * 1e3):.1f}% of that wall")

    # (c) the solve on that table, against the canonical table of the same axes
    dz, fields, planck = wedge_scene(NX, seed)
    fields = tuple(icon_cells(x) for x in fields)
    planck = icon_cells(planck)
    solver = PlexrtSolverIcon(mesh, dz, W.WedgeOptProp(lut), **WEDGE_EXACT)
    solver.set_angles(sun)
    label = f"wedge tables (c) ICON {mesh.ncell} cells x {NZ} on (b)'s table"
    torch.cuda.reset_peak_memory_stats()
    sol_s, sol_t, wall, text, lateral = wedge_solves(solver, fields, planck, label,
                                                     budget=icon_budget)
    res = solver.get_result(sol_s)
    log(f"{label} {WEDGE_EXACT}: wall {wall * 1e3:.1f} ms; {text}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; param-phi map "
        f"{'on' if solver._use_param_phi else 'off'}")
    check_finite(f"{label} thermal", solver.get_result(sol_t))
    wedge_balance(f"{label} solar", solver, res, mu, lateral=lateral)
    del solver, sol_s, sol_t
    canon = W.WedgeOptProp(W.load_or_create_wedge_lut(W.test_axes(), None, 1500, SCHEME_LUT_DIR,
                                                      device="cuda"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the shape warning: the point of the comparison
        solver = PlexrtSolverIcon(mesh, dz, canon, **WEDGE_EXACT)
    solver.set_angles(sun)
    solver.set_optical_properties(WEDGE_ALBEDO, *fields)
    sol_c, lateral_c = icon_budget(solver)
    res_c = solver.get_result(sol_c)
    parts = []
    for name, x, y in zip(("edir", "edn", "eup", "abso"), res, res_c):
        parts.append(f"{name} max |diff| {(x - y).abs().max().item():.4g}, domain mean "
                     f"{x.mean().item():.4f} vs {y.mean().item():.4f}")
    log(f"wedge tables (c) shape effect (ungated): (b)'s table vs the canonical test table "
        f"(test_axes, 1500 photons, the param-phi map on): " + "; ".join(parts)
        + f"; lateral escape {lateral:.4f} vs {lateral_c:.4f} W/m2")
    del solver, res, res_c, sol_c, canon, lut
    torch.cuda.empty_cache()

    # (d) shape-blended tables on a distorted mesh, card against CPU
    base = icon.trimesh_from_structured(SHAPED_N, SHAPED_N, 100.0, 100.0)
    rng = np.random.default_rng(2)
    dmesh = icon.trimesh_from_points(base.verts + rng.uniform(-18.0, 18.0, base.verts.shape),
                                     base.tris)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        shaped = W.wedge_optprop_for_mesh(dmesh, a, n_photons=TRACE_PHOTONS, basename=tmp,
                                          device="cuda")
        torch.cuda.synchronize()
        t_tab = time.perf_counter() - t0
    if not isinstance(shaped, W.WedgeOptPropShaped) or len(shaped.luts) != 4:
        raise AssertionError("wedge tables (d): the distorted mesh did not get 4 blended tables")
    opps = {"cuda": shaped, "cpu": W.WedgeOptPropShaped([_lut_on(l, "cpu") for l in shaped.luts])}
    dzs, fs, ps = wedge_scene(SHAPED_N, seed)
    fs, ps = tuple(icon_cells(x) for x in fs), icon_cells(ps)
    log(f"wedge tables (d): 4 corner tables at apexes "
        + ", ".join(f"({x:.3f}, {y:.3f})" for x, y in shaped.apexes)
        + f" traced on the card in {t_tab:.2f} s")

    def shaped_run(dev):
        s = PlexrtSolverIcon(dmesh, dzs, opps[dev], **WEDGE_EXACT)
        s.set_angles(sun)
        s.set_optical_properties(WEDGE_ALBEDO, *fs, planck=ps)
        return s.get_result(s.solve(lthermal=True, lsolar=True, edirTOA=1000.0))

    with cpu_threads(SHAPED_N):
        card_vs_cpu(f"wedge tables (d) WedgeOptPropShaped {SHAPED_N}x{SHAPED_N} distorted",
                    shaped_run, n=SHAPED_N)
    no_cube_kernels(cuda_ops, "wedge tables")


MC_PHOTONS = 2 ** 24  # 256 per column at 256 x 256
MC_PROFILE_STEPS = 32  # steps of the MC's profiled window (its first, fullest steps)
MC_CROP_PHOTONS = 256 * CROP * CROP
MC_CROP_RTOL = 1e-4  # card vs CPU: every tally within 1e-4 of its field's largest value
MC_EUP_TOL, MC_DN_TOL = 0.04, 0.05  # x edirTOA x mu: tests/test_mcdmda.py:87-95
MC_CC_MIN = {"3_10": 0.8, "wedge": 0.85}  # tests/test_mcdmda.py:92, tests/test_plexrt.py:198
MC_BLOCK = 4  # columns per side of the blocks the surface fields are summed over


def mc_scene(n, seed):
    """Phase 29's scene: phase 4's band at n x n (dz, kabs, ksca, g)."""
    dz, kabs, ksca, g, _ = build_scene(n, n, seed)
    return dz, kabs, ksca, g


def mc_crop_cpu(path_in: str, path_out: str) -> None:
    """Phase 29 (a)'s CPU crop, run in a process of its own beside the card's
    MC: solve_mcdmda on the CPU (one thread) from the npz at path_in, the
    tallies and niter to path_out."""
    from tenstream_tpu_torch.core.prng import Threefry
    from tenstream_tpu_torch.pprts import mcdmda

    torch.set_num_threads(1)
    z = np.load(path_in)
    t0 = time.perf_counter()
    r = mcdmda.solve_mcdmda(Threefry.from_seed(int(z["seed"])), z["kabs"], z["ksca"], z["g"],
                            z["dz"], 100.0, 100.0, float(z["albedo"]), z["sun"], 1000.0,
                            n_photons=int(z["n"]), device="cpu")
    np.savez(path_out, niter=r.niter, wall=time.perf_counter() - t0,
             **{k: getattr(r, k).numpy() for k in r._fields[:4]})


def phase_mcdmda(cuda_ops, seed, smi):
    """Phase 29 (a): the domain Monte Carlo (plain PyTorch, no kernel) on
    phase 4's band at 256 x 256 x 39, albedo 0.15, sun (120, 40), edirTOA
    1000, 2^24 photons: wall, photons/s, photon-steps/s, the live share
    per step, niter, leftover, peak memory, the busy share of its first
    MC_PROFILE_STEPS steps (profiled); its energy closes within 1%; an 8 x 8
    crop with the same key on the card and on the CPU: every tally within
    1e-4 of its field's largest value; K1-K4 launch 0 times.  Returns the
    MC's result (on the card)."""
    from tenstream_tpu_torch.core.prng import Threefry
    from tenstream_tpu_torch.pprts import mcdmda
    from tenstream_tpu_torch.pprts.sun import sundir_from_angles

    cuda_ops.reset_launch_counts()
    dz, kabs, ksca, g = mc_scene(NX, seed)
    sun = sundir_from_angles(*SPECTRAL_SUN)
    mu = float(np.cos(np.deg2rad(SPECTRAL_SUN[1])))
    run = lambda n, max_iter=4000, crop=None: mcdmda.solve_mcdmda(
        Threefry.from_seed(seed), *(a if crop is None else a[:, :crop, :crop]
                                    for a in (kabs, ksca, g)),
        dz, 100.0, 100.0, WEDGE_ALBEDO, sun, 1000.0, n_photons=n, max_iter=max_iter, device="cuda")
    label = f"mcdmda {NX}x{NY}x{NZ}"
    with tempfile.TemporaryDirectory() as tmp:
        # the crop's CPU side runs in a process of its own while the card works
        crop_in, crop_out = os.path.join(tmp, "in.npz"), os.path.join(tmp, "out.npz")
        np.savez(crop_in, **{k: a[:, :CROP, :CROP] for k, a in
                             (("kabs", kabs), ("ksca", ksca), ("g", g))},
                 dz=dz, sun=sun, albedo=WEDGE_ALBEDO, seed=seed, n=MC_CROP_PHOTONS)
        proc = subprocess.Popen([sys.executable, "-c", "import sys, chip_smoke; "
                                 "chip_smoke.mc_crop_cpu(*sys.argv[1:])", crop_in, crop_out],
                                cwd=REPO)
        try:
            mc, crop_card = _mcdmda_card(run, label, dz, mu, smi)
            if proc.wait(timeout=600) != 0:
                raise AssertionError(f"{label}: the CPU crop failed (exit {proc.returncode})")
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        z = np.load(crop_out)
        crop_cpu = {k: torch.as_tensor(z[k]) for k in mc._fields[:4]}
        log(f"{label} {CROP}x{CROP} crop on the CPU (a process of its own, one thread): "
            f"{MC_CROP_PHOTONS} photons, niter {int(z['niter'])}, {float(z['wall']):.2f} s")
    errs = []
    for name in mc._fields[:4]:
        a, b = getattr(crop_card, name).cpu(), crop_cpu[name]
        errs.append((a - b).abs().max().item() / max(b.abs().max().item(), 1e-30))
    log(f"{label} {CROP}x{CROP} crop, card vs CPU with one key: max |diff| / field max "
        + ", ".join(f"{n} {e:.3e}" for n, e in zip(mc._fields[:4], errs))
        + f"; niter {crop_card.niter} vs {int(z['niter'])}")
    if max(errs) > MC_CROP_RTOL or crop_card.niter != int(z["niter"]):
        raise AssertionError(f"{label}: card and CPU differ on the crop")
    no_cube_kernels(cuda_ops, label)
    return mc


def _mcdmda_card(run, label, dz, mu, smi):
    """Phase 29 (a) on the card: the MC at full size (timed, then its first
    steps profiled), its energy gate, and the crop: (result, crop result)."""
    from tenstream_tpu_torch.pprts import mcdmda

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mcdmda.reset_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mc = run(MC_PHOTONS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = dict(mcdmda.STATS)
    live = np.asarray(stats["live"], np.float64)
    log(f"{label}: {MC_PHOTONS} photons, albedo {WEDGE_ALBEDO}, sun {SPECTRAL_SUN}: wall "
        f"{wall:.2f} s = {MC_PHOTONS / wall:.4g} photons/s, {stats['photon_steps']} "
        f"photon-steps = {stats['photon_steps'] / wall:.4g}/s ({smi}); niter {mc.niter}, "
        f"leftover {mc.leftover.item():.3e}; live share per step mean "
        f"{live.mean() / MC_PHOTONS:.4f} (first 10 steps {live[:10].sum() / live.sum():.3f} of "
        f"the photon-steps, {int((live < 1000).sum())} steps under 1000 live photons); peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    wedge_profile(f"{label} first {MC_PROFILE_STEPS} steps",
                  lambda: run(MC_PHOTONS, MC_PROFILE_STEPS))
    for name in mc._fields[:4]:
        if not bool(torch.isfinite(getattr(mc, name)).all()):
            raise AssertionError(f"{label}: non-finite {name}")
    dzt = torch.as_tensor(dz, device="cuda")[:, None, None]
    parts = (mc.eup_toa.mean().item(), (mc.abso * dzt).sum(0).mean().item(),
             mc.sfc_absorbed.mean().item())
    incoming = 1000.0 * mu
    off = abs(sum(parts) - incoming) / incoming
    log(f"{label}: energy TOA up {parts[0]:.4f} + absorbed {parts[1]:.4f} + surface absorbed "
        f"{parts[2]:.4f} = {sum(parts):.4f} W/m2 of the incoming {incoming:.4f}: {100 * off:.4f}% "
        f"off (gate 1%); surface edn {mc.edn_srfc.mean().item():.4f} W/m2")
    if off > 0.01:
        raise AssertionError(f"{label}: the MC's energy is {100 * off:.3f}% off")
    t0 = time.perf_counter()
    crop = run(MC_CROP_PHOTONS, crop=CROP)
    torch.cuda.synchronize()
    log(f"{label} {CROP}x{CROP} crop on the card: {MC_CROP_PHOTONS} photons, niter "
        f"{crop.niter}, {time.perf_counter() - t0:.2f} s")
    return mc, crop


def _blocks(a):
    """(n, n) -> (n / MC_BLOCK, n / MC_BLOCK) sums."""
    n = a.shape[0] // MC_BLOCK
    return a.reshape(n, MC_BLOCK, n, MC_BLOCK).sum((1, 3))


def mc_compare(label, mc, eup_mean, dn_map, mu, cc_min, gate_cc=True):
    """A solver's solar solve against the MC: domain-mean TOA eup within
    MC_EUP_TOL x 1000 mu, domain-mean surface edir + edn within MC_DN_TOL x
    1000 mu, and (with gate_cc) the surface field's correlation, summed over
    MC_BLOCK x MC_BLOCK columns, above cc_min."""
    mc_eup = mc.eup_toa.mean().item()
    mc_dn = mc.edn_srfc.double().cpu()
    dn = dn_map.double().cpu()
    d_eup, d_dn = eup_mean - mc_eup, dn.mean().item() - mc_dn.mean().item()
    x, y = _blocks(mc_dn).reshape(-1).numpy(), _blocks(dn).reshape(-1).numpy()
    cc = float(np.corrcoef(x, y)[0, 1])
    log(f"{label} vs MC: TOA eup {eup_mean:.4f} vs {mc_eup:.4f} ({d_eup:+.4f}, gate "
        f"{MC_EUP_TOL * 1000 * mu:.2f}); surface edir+edn {dn.mean().item():.4f} vs "
        f"{mc_dn.mean().item():.4f} ({d_dn:+.4f}, gate {MC_DN_TOL * 1000 * mu:.2f}); correlation "
        f"of the {MC_BLOCK}x{MC_BLOCK}-column sums {cc:.4f} "
        + (f"(gate > {cc_min})" if gate_cc else f"(not gated: the JAX test's {cc_min}, which the "
           "JAX wedge solver misses on this band too, tools/torch_mc_column.py, ROADMAP §3)"))
    if (abs(d_eup) > MC_EUP_TOL * 1000 * mu or abs(d_dn) > MC_DN_TOL * 1000 * mu
            or (gate_cc and not cc > cc_min)):
        raise AssertionError(f"{label}: the solver misses the Monte Carlo")


def phase_mcdmda_solvers(cuda_ops, opp, mc, wedge_exact, seed):
    """Phase 29 (b): the solar solves of the same band against the MC: the
    3_10 PprtsSolver on the production LUT through K1/K2, and phase 25's
    PlexrtSolver 5_8 WEDGE_EXACT solve (its fish mesh repeats the cube field
    on both triangles)."""
    from tenstream_tpu_torch.pprts.grid import Grid
    from tenstream_tpu_torch.pprts.solver import PprtsSolver
    from tenstream_tpu_torch.pprts.sun import sundir_from_angles

    mu = float(np.cos(np.deg2rad(SPECTRAL_SUN[1])))
    dz, kabs, ksca, g = mc_scene(NX, seed)
    solver = PprtsSolver(Grid.create(NZ, NX, NY, 100.0, 100.0, dz, device="cuda"), opp)
    solver.set_angles(sundir_from_angles(*SPECTRAL_SUN))
    solver.set_optical_properties(WEDGE_ALBEDO, kabs, ksca, g)
    cuda_ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol = solver.solve(lthermal=False, lsolar=True, edirTOA=1000.0)
    edir, edn, eup, _ = solver.get_result()
    torch.cuda.synchronize()
    log(f"mcdmda 3_10 solar solve {NX}x{NY}x{NZ}: {(time.perf_counter() - t0) * 1e3:.1f} ms, "
        f"bicgstab {sol.niter_bicgstab} + polish {sol.niter_polish}, res/tol "
        f"{sol.diff_res / sol.diff_tol:.4f}, launches {dict(cuda_ops.LAUNCHES)}")
    if not sol.diff_res <= 1.5 * sol.diff_tol:
        raise AssertionError("mcdmda 3_10 solve: not converged")
    for name in ("fused_A_dots", "orbit_contract"):
        if cuda_ops.LAUNCHES[name] == 0:
            raise AssertionError(f"mcdmda 3_10 solve: {name} was not launched")
    mc_compare("mcdmda 3_10 (production LUT)", mc, eup[0].mean().item(), edir[-1] + edn[-1], mu,
               MC_CC_MIN["3_10"])
    mc_compare(f"mcdmda wedge 5_8 {WEDGE_EXACT} (phase 25)", mc, wedge_exact[0], wedge_exact[1],
               mu, MC_CC_MIN["wedge"], gate_cc=False)


ANN_PATH = os.path.join(REPO, "data", "ann", "ANN_3_10_production.npz")
# the committed net's settings, but 75 epochs of its 150: (d) took 20.8-31.2 s at 150 and
# 18.7 s at 100 with a diff2diff off-grid error of 3.4e-3 against the gate's 0.01
ANN_HIDDEN, ANN_EPOCHS, ANN_BATCH = (128, 128, 128), 75, 8192
ANN_COEFF_TOL = 0.01  # mean |err| against the LUT: tests/test_ann.py:98, 103


def ann_draws(fa, device, n=512):
    """tests/test_ann.py::test_production_ann_committed's draws."""
    rng = np.random.default_rng(11)
    tau = np.exp(rng.uniform(np.log(fa.tau[0] + 1e-12), np.log(fa.tau[-1]), n))
    w0 = rng.uniform(fa.w0[0], fa.w0[-1], n)
    asp = np.exp(rng.uniform(np.log(fa.aspect[0]), np.log(fa.aspect[-1]), n))
    g = rng.uniform(fa.g[0], fa.g[-1], n)
    return [torch.as_tensor(a.astype(np.float32), device=device) for a in (tau, w0, g, asp)]


def phase_ann(cuda_ops, ediff, opp, seed, smi):
    """Phase 30: the ANN coefficient backend.  (a) the committed net on the
    card against the LUT facade on the 512 draws of
    test_production_ann_committed: diffuse and dir2diff mean |err| below
    0.01, dir2dir (both closed form) within 1e-5; (b) phase 4's band at 256
    x 256 x 39 through PprtsSolver(grid, ann), solar + thermal, cold, then
    warm with the cloud field rolled one cell: walls, K3 launches, peak
    memory; every lane at res <= 1.5 tol and niter < 3000, K3 launched and
    K1/K2 not; edir equal to the LUT solve's within 1e-4 x edirTOA (the
    domain-mean edn / eup differences printed, not gated); (c) an 8 x 8 crop
    through K3 and through its plain version (equal iterations) and on the
    CPU (phase 19's gates); (d) tools/train_ann.train on the production LUT
    with the committed net's settings but ANN_EPOCHS: wall, losses, off-grid mean |err|
    against the LUT below 0.01 for diff2diff and dir2diff.  Returns K3's
    launches in (b)."""
    from tenstream_tpu_torch.optprop.ann import AnnOptProp
    from tenstream_tpu_torch.pprts.grid import Grid
    from tenstream_tpu_torch.pprts.solver import PprtsSolver
    from tenstream_tpu_torch.pprts.sun import sundir_from_angles
    from tenstream_tpu_torch.tools import train_ann

    ann = AnnOptProp.load(ANN_PATH, device="cuda")
    sundir = sundir_from_angles(*SUN)

    # (a) coefficients
    args = ann_draws(opp.lut.diff_axes, "cuda")
    e_diff = (opp.diff_coeffs(*args) - ann.diff_coeffs(*args)).abs().mean().item()
    t_lut, s_lut = opp.dir_coeffs(*args, 25.0, 45.0)
    t_ann, s_ann = ann.dir_coeffs(*args, 25.0, 45.0)
    e_dd = (t_lut - t_ann).abs().max().item()
    e_df = (s_lut - s_ann).abs().mean().item()
    log(f"ann (a) committed net vs LUT facade on 512 draws: diff2diff mean |err| {e_diff:.4e}, "
        f"dir2diff mean |err| {e_df:.4e} (gates {ANN_COEFF_TOL}), dir2dir max |diff| {e_dd:.3e} "
        f"(gate 1e-5)")
    if not (e_diff < ANN_COEFF_TOL and e_df < ANN_COEFF_TOL and e_dd <= 1e-5):
        raise AssertionError("ann (a): the committed net misses the LUT")

    # (b) the solve at full size, then the LUT solve of the same band
    solver, fields = make_solver(NX, NY, seed, ann, Grid, PprtsSolver, sundir)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cuda_ops.reset_launch_counts()
    t0 = time.perf_counter()
    out, iters = solve_and_report(solver, fields, cuda_ops, "ann (b) cold")
    t_cold = time.perf_counter() - t0
    kabs, ksca, g, planck = fields
    rolled = tuple(np.roll(a, 1, axis=1) for a in (kabs, ksca, g)) + (planck,)
    t0 = time.perf_counter()
    _, iters_w = solve_and_report(solver, rolled, cuda_ops, "ann (b) warm")
    t_warm = time.perf_counter() - t0
    launches = dict(cuda_ops.LAUNCHES)
    log(f"ann (b) {NX}x{NY}x{NZ} solar+thermal through PprtsSolver(grid, AnnOptProp): cold "
        f"{t_cold * 1e3:.1f} ms, warm (rolled) {t_warm * 1e3:.1f} ms ({smi}); launches "
        f"{launches}; peak device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    if max(iters + iters_w) >= 3000:
        raise AssertionError("ann (b): a solve reached 3000 iterations")
    if launches["diffuse_apply_dense"] == 0 or launches["fused_A_dots"] or launches["orbit_contract"]:
        raise AssertionError(f"ann (b): K3 must run and K1/K2 not: {launches}")
    del solver
    lut_solver, _ = make_solver(NX, NY, seed, opp, Grid, PprtsSolver, sundir)
    ref, _ = solve_and_report(lut_solver, fields, cuda_ops, "ann (b) LUT solve")
    del lut_solver
    e_edir = (out[0] - ref[0]).abs().max().item()
    log(f"ann (b) against the LUT solve of the same band: edir max |diff| {e_edir:.3e} W/m2 "
        f"(gate {1e-4 * 1000.0:.1f}); domain means edn {out[1].mean().item():.4f} vs "
        f"{ref[1].mean().item():.4f}, eup {out[2].mean().item():.4f} vs "
        f"{ref[2].mean().item():.4f} W/m2 (not gated)")
    if e_edir > 1e-4 * 1000.0:
        raise AssertionError("ann (b): edir differs from the LUT solve's")
    del out, ref
    torch.cuda.empty_cache()

    # (c) an 8 x 8 crop: K3 against its plain version, the card against the CPU
    crop = tuple(a[..., :CROP, :CROP] for a in fields)
    dz = build_scene(CROP, CROP, seed)[0]

    def crop_solver(dev):
        s = PprtsSolver(Grid.create(NZ, CROP, CROP, 100.0, 100.0, dz, device=dev),
                        AnnOptProp.load(ANN_PATH, device=dev))
        s.set_angles(sundir)
        return s

    outs, its = [], []
    for plain in (False, True):
        with kernels_or_plain(cuda_ops, ediff, plain):
            o, it = solve_and_report(crop_solver("cuda"), crop, cuda_ops,
                                     f"ann (c) crop {'plain' if plain else 'K3'}")
        outs.append(o)
        its.append(it)
    _compare_solves(f"ann (c) {CROP}x{CROP} K3 vs plain", outs)
    if its[0] != its[1]:
        raise AssertionError(f"ann (c): iteration counts differ, {its[0]} vs {its[1]}")

    def crop_run(dev):
        s = crop_solver(dev)
        s.set_optical_properties(0.15, *crop[:3], planck=crop[3])
        sol = s.solve(lthermal=True, lsolar=True, edirTOA=1000.0)
        for part in (sol, sol.thermal):
            if not part.diff_res <= 1.5 * part.diff_tol:
                raise AssertionError(f"ann (c) crop on {dev}: not converged")
        return s.get_result()

    with cpu_threads(CROP):
        card_vs_cpu("ann (c)", crop_run)

    # (d) training with the committed net's settings, ANN_EPOCHS epochs
    with tempfile.TemporaryDirectory() as tmp:
        _, rep = train_ann.train(LUT_PATH, ANN_HIDDEN, ANN_EPOCHS, ANN_BATCH, seed=0,
                                 device="cuda", out=os.path.join(tmp, "ann.npz"),
                                 log=lambda *a: log("ann (d)", *a))
    err = rep["errors"]
    log(f"ann (d) tools/train_ann.train hidden {ANN_HIDDEN}, {ANN_EPOCHS} epochs, batch "
        f"{ANN_BATCH}: {rep['wall']:.2f} s ({smi}); losses dir {rep['dir_loss']:.4e} diff "
        f"{rep['diff_loss']:.4e}; off-grid mean |err| diff2diff {err['diff2diff'][0]:.4e}, "
        f"dir2diff {err['dir2diff'][0]:.4e} (gates {ANN_COEFF_TOL})")
    if not (err["diff2diff"][0] < ANN_COEFF_TOL and err["dir2diff"][0] < ANN_COEFF_TOL):
        raise AssertionError("ann (d): the trained net misses the LUT")
    return launches["diffuse_apply_dense"]


# ---------------------------------------------------------------------------
# phase 31: the cube solver and the main path decomposed over ranks
# ---------------------------------------------------------------------------

DECOMP_N = 64  # 31 (b): phase 13's 64 x 64 scene ...
DECOMP_LAYOUT = (2, 2)  # ... in 2 x 2 blocks of 32 x 32, one process each, all on cuda:0
DECOMP_TIMEOUT = 420.0  # [s] for the four ranks of 31 (b)
BLOCK_N = 128  # the strong-scaling block (256 x 256 on 2 x 2 cards), timed in 31 (c)


def _free_port() -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _wrap_pad(t):
    """t (..., nx, ny) with its periodic one-cell ring: what `Mesh.pad`
    gives a rank that is its own neighbour."""
    t = torch.cat([t[..., -1:, :], t, t[..., :1, :]], dim=-2)
    return torch.cat([t[..., -1:], t, t[..., :1]], dim=-1).contiguous()


def _random_ring(t, seed):
    """t padded by a one-cell ring of other random values (a neighbour's)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    p = torch.rand(tuple(t.shape[:-2]) + (t.shape[-2] + 2, t.shape[-1] + 2), device="cuda",
                   generator=g) * float(t.max())
    p[..., 1:-1, 1:-1] = t
    return p.contiguous()


@contextlib.contextmanager
def halo_or_plain(cuda_ops, ediff, plain: bool):
    """Run the block on K1-K3 or (plain) on their plain PyTorch versions, in
    halo mode on a mesh, on the card either way."""
    saved = (ediff.fused_A_dots, cuda_ops.orbit_contract, cuda_ops.diffuse_apply_dense)
    if plain:
        ediff.fused_A_dots = (lambda scheme, idx, orb, u, w, alb, halo=False:
                              cuda_ops.fused_A_dots_plain(scheme, idx, orb, u, w, alb, halo))
        cuda_ops.orbit_contract = (lambda scheme, idx, orb, src:
                                   cuda_ops.orbit_contract_plain(idx, orb, src))
        cuda_ops.diffuse_apply_dense = cuda_ops.diffuse_apply_dense_plain
    try:
        yield
    finally:
        ediff.fused_A_dots, cuda_ops.orbit_contract, cuda_ops.diffuse_apply_dense = saved


def phase_decomposed_main(cuda_ops, opp, seed, smi, steps):
    """31 (a): the main path at full width through the decomposed code: a
    one-rank NCCL group, phase 12's solver set-up on a `Mesh`, and phase
    12's first three steps (cold, warm identical, perturbed), each held to
    phase 12's: the same niter in every band and fields within the kernel
    gates (the largest differences printed, and whether they are 0).
    Returns its kernel launches and those in halo mode."""
    import torch.distributed as dist

    from tenstream_tpu_torch.parallel.mesh import init_distributed, make_mesh

    init_distributed(f"localhost:{_free_port()}", num_processes=1, process_id=0, device="cuda")
    try:
        mesh = make_mesh(1, 1)
        spec = make_spectral_solver(NX, NY, seed, opp)
        solver, atm, lwc, gas = spec
        solver.set_mesh(mesh)
        log(f"decomposed: {mesh}, {dist.get_backend()} group; phase 12's {NX}x{NY}x{NZ} "
            f"spectral run through the halo path")
        torch.cuda.reset_peak_memory_stats()
        cuda_ops.reset_launch_counts()
        walls = []
        for k, (label, (ref, ref_iters)) in enumerate(zip(("cold", "warm identical",
                                                          "perturbed 1"), steps)):
            if k == 2:
                lwc = np.roll(lwc, 1, axis=1)
            res, wall, _ = spectral_solve(spec, lwc, cuda_ops, f"decomposed {label}",
                                          report_chunks=False)
            walls.append(wall)
            errs = [(a.cpu() - b).abs().max().item() for a, b in zip(res, ref)]
            iters = _band_niters(solver)
            differ = {b: (iters[b], ref_iters.get(b)) for b in iters
                      if iters[b] != ref_iters.get(b)}
            log(f"decomposed {label} vs phase 12: max abs edir {errs[0]:.3e} edn {errs[1]:.3e} "
                f"eup {errs[2]:.3e} W/m2, abso {errs[3]:.3e} W/m3 (all 0: {max(errs) == 0.0}); "
                f"niter equal in {len(iters) - len(differ)} of {len(iters)} bands")
            if max(errs[:3]) > FLUX_ATOL or errs[3] > ABSO_ATOL:
                raise AssertionError(f"decomposed {label}: differs from phase 12 beyond the gates")
            if differ or iters.keys() != ref_iters.keys():
                raise AssertionError(f"decomposed {label}: per-band niter differ {differ}")
        launches, halo = dict(cuda_ops.LAUNCHES), dict(cuda_ops.HALO_LAUNCHES)
        check_spectral_result("decomposed", res, atm, lwc, gas.solar(atm).weight)
        log(f"decomposed: walls {', '.join(f'{w * 1e3:.1f} ms' for w in walls)}, perturbed "
            f"{NX * NY / walls[2]:.1f} columns/s ({smi}); launches {launches}, in halo mode "
            f"{halo}; peak device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        if halo["fused_A_dots"] == 0 or halo["fused_A_dots"] != launches["fused_A_dots"]:
            raise AssertionError("decomposed: K1 must run in halo mode only, and did not")
        if launches["orbit_contract"] == 0:
            raise AssertionError("decomposed: K2 was not launched")
        del spec, solver, res
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return launches, halo


def _decomposed_fields(seed):
    dz, kabs, ksca, g, planck = build_scene(DECOMP_N, DECOMP_N, seed)
    return dz, (kabs, ksca, g, planck)


def decomposed_rank(rank: int, port: int, out: str, seed: int) -> None:
    """31 (b), one rank of the 2 x 2 gloo group on cuda:0: the 64 x 64
    cloud band solar + thermal on orbit coefficients (K1/K2) and on dense
    ones (K3), each through the kernels' halo mode and through their plain
    versions; writes this rank's blocks, iterations and launches."""
    import torch.distributed as dist

    from tenstream_tpu_torch.core.config import Options
    from tenstream_tpu_torch.optprop.facade import OptProp
    from tenstream_tpu_torch.optprop.lut import LUT
    from tenstream_tpu_torch.parallel.mesh import init_distributed, make_mesh, shard_fields
    from tenstream_tpu_torch.pprts import cuda_ops, ediff
    from tenstream_tpu_torch.pprts.grid import Grid
    from tenstream_tpu_torch.pprts.solver import PprtsSolver
    from tenstream_tpu_torch.pprts.sun import sundir_from_angles

    nxp, nyp = DECOMP_LAYOUT
    init_distributed(f"localhost:{port}", num_processes=nxp * nyp, process_id=rank,
                     device="cuda", backend="gloo")
    mesh = make_mesh(nxp, nyp)
    cuda_ops.load_extension()
    opp = OptProp(LUT.load(LUT_PATH, device="cuda"), device="cuda")
    dz, fields = _decomposed_fields(seed)
    blocks = shard_fields(mesh, *fields)
    result = {}
    for kind in ("orbit", "dense"):
        for plain in (False, True):
            opts = Options({"pprts_orbit_coeffs": kind == "orbit"}, read_env=False)
            solver = PprtsSolver(Grid.create(dz.size, DECOMP_N, DECOMP_N, 100.0, 100.0, dz,
                                             device="cuda"), opp, options=opts)
            solver.set_mesh(mesh)
            solver.set_angles(sundir_from_angles(*SUN))
            solver.set_optical_properties(0.15, *blocks[:3], planck=blocks[3])
            tag = f"{kind}_{'plain' if plain else 'kernels'}"
            cuda_ops.reset_launch_counts()
            t0 = time.perf_counter()
            with halo_or_plain(cuda_ops, ediff, plain):
                sol = solver.solve(lthermal=True, lsolar=True, edirTOA=1000.0)
                fluxes = solver.get_result()
            torch.cuda.synchronize()
            result[tag + "_wall"] = np.asarray(time.perf_counter() - t0)
            for name, a in zip(("edir", "edn", "eup", "abso"), fluxes):
                result[f"{tag}_{name}"] = a.cpu().numpy()
            result[tag + "_niter"] = np.asarray([sol.niter_diff, sol.thermal.niter_diff])
            result[tag + "_launches"] = np.asarray(
                [cuda_ops.LAUNCHES[k] for k in ("fused_A_dots", "orbit_contract",
                                                "diffuse_apply_dense")]
                + [cuda_ops.HALO_LAUNCHES[k] for k in ("fused_A_dots", "diffuse_apply_dense")])
    np.savez(out, **result)
    dist.barrier()
    dist.destroy_process_group()


def phase_decomposed_ranks(cuda_ops, opp, Grid, PprtsSolver, Options, sundir, seed):
    """31 (b): real neighbours on one card.  Four processes form a 2 x 2
    gloo group, each on cuda:0 (NCCL takes one rank per card), with blocks
    of 32 x 32 of the 64 x 64 cloud scene; each solves one solar + thermal
    band on orbit coefficients (K1 / K2) and on dense ones (K3) through the
    kernels' halo mode and through their plain versions.  Both are held to
    the one-rank solve (this process, no mesh, the kernels) and to each
    other: fluxes within 0.1 W/m2, absorption within 1e-4 W/m3, niter per
    sub-solve within NITER_SLACK.  Returns K3's launches in halo mode."""
    ref = {}
    for kind in ("orbit", "dense"):
        opts = Options({"pprts_orbit_coeffs": kind == "orbit"}, read_env=False)
        dz, fields = _decomposed_fields(seed)
        solver = PprtsSolver(Grid.create(dz.size, DECOMP_N, DECOMP_N, 100.0, 100.0, dz,
                                         device="cuda"), opp, options=opts)
        solver.set_angles(sundir)
        o, it = solve_and_report(solver, fields, cuda_ops, f"decomposed one-rank {kind}")
        ref[kind] = ([a.cpu().numpy() for a in o], (it[0] + it[1], it[2] + it[3]))
    nxp, nyp = DECOMP_LAYOUT
    outs, wall = spawn_ranks("--decomposed-rank", nxp * nyp, seed, DECOMP_TIMEOUT, "decomposed")
    glob_ = lambda key: np.concatenate(
        [np.concatenate([outs[px * nyp + py][key] for py in range(nyp)], axis=-1)
         for px in range(nxp)], axis=-2)
    k3_halo = 0
    for kind in ("orbit", "dense"):
        got = {}
        for mode in ("kernels", "plain"):
            tag = f"{kind}_{mode}"
            fields = [glob_(f"{tag}_{n}") for n in ("edir", "edn", "eup", "abso")]
            iters = tuple(int(v) for v in outs[0][tag + "_niter"])
            if any(tuple(int(v) for v in o[tag + "_niter"]) != iters for o in outs):
                raise AssertionError(f"decomposed {tag}: the ranks report other niter")
            launches = sum(o[tag + "_launches"] for o in outs)
            got[mode] = (fields, iters)
            walls = max(float(o[tag + "_wall"]) for o in outs)
            log(f"decomposed 2x2 {tag}: niter solar/thermal {iters}, wall {walls * 1e3:.1f} ms, "
                f"launches over the ranks K1 {launches[0]} K2 {launches[1]} K3 {launches[2]}, in "
                f"halo mode K1 {launches[3]} K3 {launches[4]}")
            # K1 and K3 launch in halo mode only; K2 beside K1 on the orbit path
            if mode == "plain":
                ok = not any(launches)
            elif kind == "orbit":
                ok = (launches[3] > 0 and launches[3] == launches[0] and launches[1] > 0
                      and launches[2] == 0)
            else:
                ok = launches[4] > 0 and launches[4] == launches[2] and launches[0] == 0
                k3_halo = int(launches[4])
            if not ok:
                raise AssertionError(f"decomposed {tag}: wrong kernel launches {launches}")
        for (a, b), (fa, ia), (fb, ib) in (
                (("kernels", "one rank"), got["kernels"], ref[kind]),
                (("kernels", "plain"), got["kernels"], got["plain"])):
            errs = [float(np.abs(x - y).max()) for x, y in zip(fa, fb)]
            dn = max(abs(x - y) for x, y in zip(ia, ib))
            log(f"decomposed 2x2 {kind} {a} vs {b}: max abs edir {errs[0]:.3e} edn {errs[1]:.3e} "
                f"eup {errs[2]:.3e} W/m2, abso {errs[3]:.3e} W/m3; niter {ia} vs {ib}")
            if max(errs[:3]) > FLUX_ATOL or errs[3] > ABSO_ATOL:
                raise AssertionError(f"decomposed {kind} {a} vs {b}: beyond the gates")
            if dn > NITER_SLACK[("kernels", "plain")]:
                raise AssertionError(f"decomposed {kind} {a} vs {b}: niter {ia} vs {ib}")
    log(f"decomposed 2x2 on one card: {wall:.1f} s for the four ranks (start-up included)")
    return k3_halo


def phase_halo_kernels(cuda_ops, scheme, idx, nx, ny):
    """31 (c): K1 and K3 in halo mode against their periodic launches at the
    same block (a periodic ring: equal bit for bit) and against their plain
    halo versions (a random ring), timed beside the periodic launch: K1 at
    the main path's band chunk (a one-rank block of 256 x 256) and at the
    strong-scaling block (128 x 128), K3 at the single-band urban shape and
    at phase 31 (b)'s 32 x 32 block; K2 timed at the 128 x 128 block."""
    norb = int(idx.max()) + 1
    nd = scheme.ndiff
    report = {"fused_A_dots": {}, "diffuse_apply_dense": {}, "orbit_contract": {}}
    for (B, z, x, y, tag) in ((CHUNK, NZ_SOLVE, nx, ny, "main"),
                              (CHUNK, NZ_SOLVE, BLOCK_N, BLOCK_N, "block")):
        orb, u, w, alb, src = _k_inputs(B, z, x, y, norb, seed=z + x + 1)
        Au, dots = cuda_ops.fused_A_dots(scheme, idx, orb, u, w, alb)
        op, up = _wrap_pad(orb), _wrap_pad(u)
        Au_h, dots_h = cuda_ops.fused_A_dots(scheme, idx, op, up, w, alb, halo=True)
        same = bool(torch.equal(Au, Au_h) and torch.equal(dots, dots_h))
        opr, upr = _random_ring(orb, 5), _random_ring(u, 6)
        Au_r, dots_r = cuda_ops.fused_A_dots(scheme, idx, opr, upr, w, alb, halo=True)
        Au_p, dots_p = cuda_ops.fused_A_dots_plain(scheme, idx, opr, upr, w, alb, halo=True)
        err = (Au_r - Au_p).abs().max().item()
        derr = ((dots_r - dots_p).abs() / dots_p.abs()).max().item()
        del Au, Au_h, Au_r, Au_p
        log(f"kernels halo K1 {tag} B={B} nz={z} {x}x{y}: periodic ring equal to the periodic "
            f"launch bit for bit: {same}; random ring vs plain max abs {err:.3e}, dots rel "
            f"{derr:.3e}")
        if not (same and err <= FIELD_ATOL and derr <= DOT_RTOL):
            raise AssertionError(f"K1's halo mode at {tag}: not the periodic launch, or not its "
                                 "plain version")
        groups = cuda_ops.orbit_groups(idx)
        per_cell = sum(len(ss) + 1 for gd in groups for _, ss in gd)
        nxy, pxy = x * y, (x + 2) * (y + 2)
        nbytes = 4 * B * (nd * (z + 1) * pxy + 2 * nd * (z + 1) * nxy + norb * z * pxy + nxy + 2)
        flops = B * (z * nxy * per_cell + (z + 1) * nxy * nd * 5)
        periodic_ms = cuda_ms(lambda: cuda_ops.fused_A_dots(scheme, idx, orb, u, w, alb), 20)
        args = (scheme, idx, opr, upr, w, alb)
        e = _report_entry(f"fused_A_dots halo mode ({tag}, B={B} nz={z} {x}x{y})", err,
                          cuda_ms(lambda: cuda_ops.fused_A_dots(*args, halo=True), 20),
                          cuda_ms(lambda: cuda_ops.fused_A_dots_plain(*args, halo=True), 3),
                          nbytes, flops)
        pad_ms = cuda_ms(lambda: _wrap_pad(u), 20)
        log(f"kernels halo K1 {tag}: periodic launch {periodic_ms:.4f} ms; the ring of u on one "
            f"card (two cat copies) {pad_ms:.4f} ms")
        if tag == "main":
            report["fused_A_dots"].update(e, periodic_ms=periodic_ms)
        else:
            report["fused_A_dots"].update({f"block{BLOCK_N}_{k}": v for k, v in e.items()},
                                          **{f"block{BLOCK_N}_periodic_ms": periodic_ms})
            cost = _kernel_cost(cuda_ops, scheme, idx, B, z, x, y, norb)["orbit_contract"]
            k2 = _report_entry(f"orbit_contract at the {x}x{y} block", 0.0,
                               cuda_ms(lambda: cuda_ops.orbit_contract(scheme, idx, orb, src), 20),
                               cuda_ms(lambda: cuda_ops.orbit_contract_plain(idx, orb, src), 3),
                               *cost)
            report["orbit_contract"] = {f"block{BLOCK_N}_{k}": k2[k]
                                        for k in ("ms", "plain_ms", "bound_ms")}
        del orb, u, w, alb, src, op, up, opr, upr
        torch.cuda.empty_cache()
    cshift, _ = cuda_ops._shift_tables(scheme)
    for (B, z, x, y, tag) in ((1, URBAN_NZ, nx, ny, "single"), (1, NZ, 32, 32, "block")):
        c, xf = k3_inputs(B, z, x, y, torch.float32, seed=11)
        ref = cuda_ops.diffuse_apply_dense(scheme, c, xf)
        own = (xf[..., 0, :].contiguous(), xf[..., :, 0].contiguous())
        torch.full_like(xf, float("nan"))
        out, ox, oy = cuda_ops.diffuse_apply_dense(scheme, c, xf, halo=own)
        for d, (_, cx, cy) in enumerate(cshift):
            if cx == -1:
                out[:, d, :, 0, :] = ox[:, d]
            elif cy == -1:
                out[:, d, :, :, 0] = oy[:, d]
        same = bool(torch.equal(out, ref))
        g = torch.Generator(device="cuda").manual_seed(12)
        hal = (torch.rand((B, nd, z + 1, y), device="cuda", generator=g),
               torch.rand((B, nd, z + 1, x), device="cuda", generator=g))
        torch.full_like(xf, float("nan"))
        got = cuda_ops.diffuse_apply_dense(scheme, c, xf, halo=hal)
        want = cuda_ops.diffuse_apply_dense_plain(scheme, c, xf, halo=hal)
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
        log(f"kernels halo K3 {tag} B={B} nz={z} {x}x{y}: own planes folded back equal to the "
            f"periodic launch bit for bit: {same}; other halo planes vs plain max abs {err:.3e}")
        if not (same and err <= FIELD_ATOL):
            raise AssertionError(f"K3's halo mode at {tag}: not the periodic launch, or not its "
                                 "plain version")
        ncell, nface = z * x * y, (z + 1) * x * y
        edge = 4 * B * nd * (z + 1) * (x + y)
        nbytes = B * (nd * nd * ncell * 4 + 2 * nd * nface * 4) + 2 * edge
        periodic_ms = cuda_ms(lambda: cuda_ops.diffuse_apply_dense(scheme, c, xf), 20)
        e = _report_entry(f"diffuse_apply_dense halo mode ({tag}, B={B} nz={z} {x}x{y})", err,
                          cuda_ms(lambda: cuda_ops.diffuse_apply_dense(scheme, c, xf, halo=hal),
                                  20),
                          cuda_ms(lambda: cuda_ops.diffuse_apply_dense_plain(scheme, c, xf,
                                                                             halo=hal), 3),
                          nbytes, B * 2 * nd * nd * ncell)
        log(f"kernels halo K3 {tag}: periodic launch {periodic_ms:.4f} ms")
        if tag == "single":
            report["diffuse_apply_dense"].update(e, periodic_ms=periodic_ms)
        else:
            report["diffuse_apply_dense"].update({f"block32_{k}": v for k, v in e.items()},
                                                 block32_periodic_ms=periodic_ms)
        del c, xf, ref, out, ox, oy, got, want
        torch.cuda.empty_cache()
    return report


# ---------------------------------------------------------------------------
# phase 32: the wedge solvers decomposed; phase 33: the port's C bridge
# ---------------------------------------------------------------------------

WEDGE_DECOMP_N = 64  # 32 (b): phase 25's band at 64 x 64 ...
WEDGE_DECOMP_LAYOUT = (2, 2)  # ... in 2 x 2: fish blocks of 32 x 32, 2048 ICON cells per rank
# ... on WEDGE_EXACT with 16 inner steps of the direct sweep, not 128: each step is one
# exchange, which gloo stages through the host (~5 ms on one card shared by four ranks), and
# (b) holds the ranks to one rank on the same options, not the sweep to its exact limit
WEDGE_DECOMP_OPTS = {**WEDGE_EXACT, "n_inner": 16}
CAPI_TIMEOUT = 600.0  # [s] for each demo process of phase 33
CAPI_PPRTS_N = 8  # the JAX demo's 8 x 8 x 8 grid (capi/demo_pprts.c)
CAPI_SLAB_N = 256  # bench.py's slab for the bridge's specint, at bench.py's width
CAPI_GAS_N = 16  # the slab's corner on which ecCKD on the card is held to ecCKD on the host


def spawn_ranks(flag: str, world: int, seed: int, timeout: float, label: str):
    """Start this script `world` times with `flag R --port P --out F` (one
    rank each) and return each rank's npz as a dict, in rank order, and the
    wall [s]; a rank that hangs past `timeout` is killed and fails it."""
    port = _free_port()
    with tempfile.TemporaryDirectory() as tmp:
        procs, logs = [], []
        for r in range(world):
            lg = open(os.path.join(tmp, f"rank{r}.log"), "w")
            logs.append(lg)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--seed", str(seed), flag, str(r),
                 "--port", str(port), "--out", os.path.join(tmp, f"rank{r}.npz")], cwd=REPO,
                stdout=lg, stderr=subprocess.STDOUT))
        t0 = time.perf_counter()
        try:
            for p in procs:
                p.wait(timeout=max(1.0, timeout - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for lg in logs:
                lg.close()
        wall = time.perf_counter() - t0
        codes = [p.returncode for p in procs]
        if any(c != 0 for c in codes):
            for r in range(world):
                with open(os.path.join(tmp, f"rank{r}.log")) as fh:
                    log(f"{label} rank {r} (exit {codes[r]}):\n" + fh.read()[-4000:])
            raise AssertionError(f"{label} ranks: exit codes {codes} (killed after "
                                 f"{timeout:.0f} s where a rank hung)")
        return [dict(np.load(os.path.join(tmp, f"rank{r}.npz"))) for r in range(world)], wall


def decomposed_wedge(solver, fields, planck, pmesh, label, nca=True):
    """Phase 25's gated solar and thermal solves (`wedge_solves`) of a
    solver: its solar fields, its thermal (edn, eup, abso), niter, the NCA
    of the thermal solve and, with a mesh, the exchanges and all-reduces of
    each solve."""
    seen = {}

    def solar(s):
        if pmesh is not None:
            pmesh.reset_stats()
        sol = s.solve(lthermal=False, lsolar=True, edirTOA=1000.0)
        if pmesh is not None:
            seen.update(pmesh.stats)
        return sol, 0.0

    sol_s, sol_t, wall, text, _ = wedge_solves(solver, fields, planck, label, budget=solar)
    out = wedge_reference(solver, sol_s, sol_t, nca=nca)
    out.update(wall=wall, text=text)
    if pmesh is not None:
        out["stats"] = (dict(seen), {k: pmesh.stats[k] - seen[k] for k in seen})
    return out


def hold_wedge(label, got, want, exact: bool):
    """Fields, niter and NCA of a decomposed run against the undecomposed
    one: bit for bit (`exact`), else within the cube's gates (0.1 W/m2, 1e-4
    W/m3) and equal fixed-point niter."""
    errs = _max_diffs(got["solar"] + got["thermal"], want["solar"] + want["thermal"])
    nca = _max_diffs([got["nca"]], [want["nca"]])[0] if "nca" in want else 0.0
    flux = max(errs[:3] + errs[4:6])
    abso = max(errs[3], errs[6], nca)
    log(f"{label}: max abs solar edir {errs[0]:.3e} edn {errs[1]:.3e} eup {errs[2]:.3e} W/m2, "
        f"abso {errs[3]:.3e} W/m3; thermal edn {errs[4]:.3e} eup {errs[5]:.3e} W/m2, abso "
        f"{errs[6]:.3e} W/m3; NCA {nca:.3e} W/m3 (all 0: {max(errs + [nca]) == 0.0}); niter "
        f"{got['niter']} against {want['niter']}")
    if got["niter"] != want["niter"]:
        raise AssertionError(f"{label}: niter {got['niter']} against {want['niter']}")
    if exact and max(errs + [nca]) != 0.0:
        raise AssertionError(f"{label}: not bit for bit the undecomposed run")
    if flux > FLUX_ATOL or abso > ABSO_ATOL:
        raise AssertionError(f"{label}: beyond the gates (0.1 W/m2, 1e-4 W/m3)")


def _max_diffs(got, want):
    return [float((a.cpu() - b.cpu()).abs().max()) for a, b in zip(got, want)]


def _exchanges(stats) -> str:
    return ", ".join(f"{what}: {s['exchanges']} exchanges ({s['messages']} messages to other "
                     f"ranks), {s['reductions']} all-reduces" for what, s in
                     zip(("solar", "thermal"), stats))


def phase_wedge_decomposed(cuda_ops, opp, seed, smi, fish_ref, icon_mesh, icon_ref, chunk_ref):
    """32 (a): the wedge path at full width on a one-rank NCCL group: phase
    25's WEDGE_EXACT band on the 256 x 256 x 39 fish mesh and phase 27's
    gated ICON solve with NCA, each through `set_mesh` and held bit for bit
    to that phase's run (kept in memory); then `specint_plexrt` (ecCKD, the
    first chunk of 8 g-points of each spectrum, max_gpt 8) decomposed, held
    bit for bit to the same two chunks of phase 26's undecomposed call
    (`chunk_ref`, reduced as the call reduces them; not run a second time).
    Walls beside each other, the exchanges per solve, K1-K4 never
    launched: returns the launch counts (all 0)."""
    import torch.distributed as dist

    from tenstream_tpu_torch.parallel.mesh import init_distributed, make_mesh, shard_fields
    from tenstream_tpu_torch.plexrt.mesh import fish_mesh
    from tenstream_tpu_torch.plexrt.solver import PlexrtSolver
    from tenstream_tpu_torch.plexrt.solver_unstructured import PlexrtSolverIcon
    from tenstream_tpu_torch.pprts.sun import sundir_from_angles
    from tenstream_tpu_torch.spectral.ecckd import EcckdGasOptics

    sun = sundir_from_angles(*SPECTRAL_SUN)
    init_distributed(f"localhost:{_free_port()}", num_processes=1, process_id=0, device="cuda")
    try:
        pmesh = make_mesh(1, 1)
        cuda_ops.reset_launch_counts()
        dz, fields, planck = wedge_scene(NX, seed)
        label = f"wedge decomposed fish {NX}x{NY}x{NZ} ({pmesh}, {WEDGE_EXACT})"
        solver = PlexrtSolver(fish_mesh(NZ, NX, NY, 100.0, 100.0, dz), opp, **WEDGE_EXACT)
        solver.set_angles(sun)
        solver.set_mesh(pmesh)
        blocks = shard_fields(pmesh, *fields, planck)
        run = decomposed_wedge(solver, blocks[:3], blocks[3], pmesh, label, nca=False)
        log(f"{label}: wall {run['wall'] * 1e3:.1f} ms (phase 25's exact run took its "
            f"WEDGE_EXACT wall above); {run['text']}; {_exchanges(run['stats'])}")
        hold_wedge(f"{label} vs phase 25", run, fish_ref, exact=True)
        del solver, run, blocks
        torch.cuda.empty_cache()

        label = f"wedge decomposed ICON {icon_mesh.ncell} cells x {NZ} ({pmesh}, {WEDGE_EXACT})"
        solver = PlexrtSolverIcon(icon_mesh, dz, opp, **WEDGE_EXACT)
        solver.set_angles(sun)
        solver.set_mesh(pmesh)
        blocks = shard_fields(pmesh, *(icon_cells(a) for a in fields), icon_cells(planck),
                              cell_axis=-1)
        run = decomposed_wedge(solver, blocks[:3], blocks[3], pmesh, label)
        log(f"{label}: wall {run['wall'] * 1e3:.1f} ms; {run['text']}; "
            f"{_exchanges(run['stats'])}")
        hold_wedge(f"{label} vs phase 27", run, icon_ref, exact=True)
        del solver, run, blocks
        torch.cuda.empty_cache()

        atm, lwc = build_bench_atm(NX, NY, seed)
        gas = EcckdGasOptics(n_gpt=NGPT)
        label = f"wedge decomposed spectral {NX}x{NY}x{atm.nlay}"
        solver = PlexrtSolver(fish_mesh(atm.nlay, NX, NY, 100.0, 100.0, atm.dz.astype(np.float32)),
                              opp, **WEDGE_EXACT)
        solver.set_angles(sun)
        solver.set_mesh(pmesh)
        (lwc2,) = shard_fields(pmesh, both_orientations(lwc))
        pmesh.reset_stats()
        first = {}
        res, wall, text, above = wedge_specint(solver, atm, lwc2, gas, label, first=first,
                                               band_chunk=WEDGE_CHUNK, max_gpt=WEDGE_CHUNK)
        if above:
            raise AssertionError(f"{label}: {above} lanes above their tolerance")
        want, want_wall, want_iters = chunk_ref
        iters = tuple(first[k][0].niter_diff.tolist() for k in ("solar", "thermal"))
        errs = _max_diffs(res, want)
        log(f"{label}, ecCKD the first {WEDGE_CHUNK} g-points of each spectrum ({WEDGE_EXACT}): "
            f"{wall * 1e3:.1f} ms decomposed against phase 26's same two chunks "
            f"{want_wall * 1e3:.1f} ms ({smi}); {text}; {pmesh.stats['exchanges']} exchanges, "
            f"{pmesh.stats['reductions']} all-reduces; max abs edir {errs[0]:.3e} edn "
            f"{errs[1]:.3e} eup {errs[2]:.3e} W/m2, abso {errs[3]:.3e} W/m3 (all 0: "
            f"{max(errs) == 0.0}); lanes' niter equal: {iters == want_iters}")
        if iters != want_iters or max(errs) != 0.0:
            raise AssertionError(f"{label}: not bit for bit phase 26's first chunks")
        del solver, res, first
        no_cube_kernels(cuda_ops, "wedge decomposed")
        launches = dict(cuda_ops.LAUNCHES)
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return launches


def wedge_decomposed_rank(rank: int, port: int, out: str, seed: int) -> None:
    """32 (b), one rank of the 2 x 2 gloo group on cuda:0: phase 25's band
    at 64 x 64 on WEDGE_DECOMP_OPTS on the fish mesh (this rank's 32 x 32 block)
    and on the ICON mesh (its 2048 cells), solar and thermal with NCA;
    writes this rank's fields, niter, exchanges and walls."""
    import torch.distributed as dist

    from tenstream_tpu_torch.parallel.mesh import init_distributed, make_mesh, shard_fields
    from tenstream_tpu_torch.plexrt import icon
    from tenstream_tpu_torch.plexrt.mesh import fish_mesh
    from tenstream_tpu_torch.plexrt.solver import PlexrtSolver
    from tenstream_tpu_torch.plexrt.solver_unstructured import PlexrtSolverIcon
    from tenstream_tpu_torch.pprts import cuda_ops
    from tenstream_tpu_torch.pprts.sun import sundir_from_angles

    nxp, nyp = WEDGE_DECOMP_LAYOUT
    init_distributed(f"localhost:{port}", num_processes=nxp * nyp, process_id=rank,
                     device="cuda", backend="gloo")
    pmesh = make_mesh(nxp, nyp)
    opp = wedge_opp()[0]
    n = WEDGE_DECOMP_N
    dz, fields, planck = wedge_scene(n, seed)
    result = {}
    for kind in ("fish", "icon"):
        if kind == "fish":
            solver = PlexrtSolver(fish_mesh(NZ, n, n, 100.0, 100.0, dz), opp, **WEDGE_DECOMP_OPTS)
            blocks = shard_fields(pmesh, *fields, planck)
        else:
            solver = PlexrtSolverIcon(icon.trimesh_from_structured(n, n, 100.0, 100.0), dz, opp,
                                      **WEDGE_DECOMP_OPTS)
            blocks = shard_fields(pmesh, *(icon_cells(a) for a in fields), icon_cells(planck),
                                  cell_axis=-1)
        solver.set_angles(sundir_from_angles(*SPECTRAL_SUN))
        solver.set_mesh(pmesh)
        cuda_ops.reset_launch_counts()
        run = decomposed_wedge(solver, blocks[:3], blocks[3], pmesh, f"wedge 2x2 {kind}")
        for name, a in zip(("edir", "edn", "eup", "abso", "t_edn", "t_eup", "t_abso", "nca"),
                           run["solar"] + run["thermal"] + [run["nca"]]):
            result[f"{kind}_{name}"] = a.numpy()
        result[kind + "_niter"] = np.asarray(run["niter"])
        result[kind + "_wall"] = np.asarray(run["wall"])
        result[kind + "_stats"] = np.asarray([[s[k] for k in ("exchanges", "messages",
                                                              "reductions")]
                                              for s in run["stats"]])
        result[kind + "_launches"] = np.asarray(sum(cuda_ops.LAUNCHES.values()))
    np.savez(out, **result)
    dist.barrier()
    dist.destroy_process_group()


def phase_wedge_decomposed_ranks(cuda_ops, opp, seed):
    """32 (b): real neighbours on one card.  Four processes in a 2 x 2 gloo
    group on cuda:0 solve phase 25's band at 64 x 64 on WEDGE_DECOMP_OPTS on the
    fish mesh (blocks of 32 x 32) and on the ICON mesh (2048 cells each),
    solar and thermal with NCA; each held to this process's one-rank solve
    with the cube's gates (0.1 W/m2, 1e-4 W/m3, NCA 1e-4 W/m3) and equal
    fixed-point niter."""
    from tenstream_tpu_torch.plexrt import icon
    from tenstream_tpu_torch.plexrt.mesh import fish_mesh
    from tenstream_tpu_torch.plexrt.solver import PlexrtSolver
    from tenstream_tpu_torch.plexrt.solver_unstructured import PlexrtSolverIcon
    from tenstream_tpu_torch.pprts.sun import sundir_from_angles

    n = WEDGE_DECOMP_N
    dz, fields, planck = wedge_scene(n, seed)
    sun = sundir_from_angles(*SPECTRAL_SUN)
    refs = {}
    for kind in ("fish", "icon"):
        if kind == "fish":
            solver = PlexrtSolver(fish_mesh(NZ, n, n, 100.0, 100.0, dz), opp, **WEDGE_DECOMP_OPTS)
            f, p = fields, planck
        else:
            solver = PlexrtSolverIcon(icon.trimesh_from_structured(n, n, 100.0, 100.0), dz, opp,
                                      **WEDGE_DECOMP_OPTS)
            f, p = tuple(icon_cells(a) for a in fields), icon_cells(planck)
        solver.set_angles(sun)
        refs[kind] = decomposed_wedge(solver, f, p, None, f"wedge one-rank {kind} {n}x{n}")
    nxp, nyp = WEDGE_DECOMP_LAYOUT
    outs, wall = spawn_ranks("--wedge-rank", nxp * nyp, seed, DECOMP_TIMEOUT, "wedge 2x2")
    for kind in ("fish", "icon"):
        if kind == "fish":
            glob_ = lambda key: torch.as_tensor(np.concatenate(
                [np.concatenate([outs[px * nyp + py][key] for py in range(nyp)], axis=-1)
                 for px in range(nxp)], axis=-2))
        else:
            glob_ = lambda key: torch.as_tensor(np.concatenate([o[key] for o in outs], axis=-1))
        iters = [tuple(int(v) for v in o[kind + "_niter"]) for o in outs]
        if len(set(iters)) != 1:
            raise AssertionError(f"wedge 2x2 {kind}: the ranks report other niter {iters}")
        got = dict(solar=[glob_(f"{kind}_{k}") for k in ("edir", "edn", "eup", "abso")],
                   thermal=[glob_(f"{kind}_{k}") for k in ("t_edn", "t_eup", "t_abso")],
                   nca=glob_(kind + "_nca"), niter=iters[0])
        hold_wedge(f"wedge 2x2 gloo {kind} vs one rank", got, refs[kind], exact=False)
        stats = outs[0][kind + "_stats"]
        launches = sum(int(o[kind + "_launches"]) for o in outs)
        log(f"wedge 2x2 gloo {kind} {n}x{n}: wall {max(float(o[kind + '_wall']) for o in outs) * 1e3:.1f}"
            f" ms against one rank's {refs[kind]['wall'] * 1e3:.1f} ms; rank 0 solar {stats[0][0]} "
            f"exchanges ({stats[0][1]} messages), {stats[0][2]} all-reduces; thermal "
            f"{stats[1][0]} / {stats[1][1]} / {stats[1][2]}; K1-K4 launches over the ranks "
            f"{launches}")
        if launches:
            raise AssertionError(f"wedge 2x2 {kind}: the wedge path launched cube kernels")
    log(f"wedge 2x2 on one card: {wall:.1f} s for the four ranks (start-up included)")


def capi_slab(n, seed):
    """bench.py's slab at n x n for the C bridge: plev, tlev (nz+1, n, n)
    [Pa, K] and its liquid water (nz, n, n) converted to g/kg with the air
    density the bridge computes back."""
    from tenstream_tpu_torch.core.types import R_DRY_AIR

    atm, lwc = build_bench_atm(n, n, seed)
    shape = (atm.nlay + 1, n, n)
    plev = np.broadcast_to(np.asarray(atm.plev, np.float32)[:, None, None], shape).copy()
    tlev = np.broadcast_to(np.asarray(atm.tlev, np.float32)[:, None, None], shape).copy()
    p, t = plev.astype(np.float64), tlev.astype(np.float64)
    rho = (0.5 * (p[:-1] + p[1:])) / (R_DRY_AIR * 0.5 * (t[:-1] + t[1:]))
    return plev, tlev, (lwc / rho).astype(np.float32)


def hold_gas_optics_device(plev, tlev):
    """ecCKD's gas optics on the card against the same on the host, bit for
    bit, on the slab's CAPI_GAS_N x CAPI_GAS_N corner merged as the bridge
    merges it: the bridge builds its backend on the card."""
    from tenstream_tpu_torch.atm import setup_tenstr_atm
    from tenstream_tpu_torch.spectral.ecckd import EcckdGasOptics

    c = (slice(None), slice(0, CAPI_GAS_N), slice(0, CAPI_GAS_N))
    atm = setup_tenstr_atm(plev[c].astype(np.float64), tlev[c].astype(np.float64))
    host, card = EcckdGasOptics(n_gpt=NGPT), EcckdGasOptics(n_gpt=NGPT, device="cuda")
    same = all(torch.equal(getattr(getattr(host, kind)(atm), k),
                           getattr(getattr(card, kind)(atm), k).cpu())
               for kind, keys in (("solar", ("tau", "w0", "weight")),
                                  ("thermal", ("tau", "planck")))
               for k in keys)
    log(f"capi ecCKD {NGPT}+{NGPT} gas optics on the card vs the host, {CAPI_GAS_N}x"
        f"{CAPI_GAS_N} columns of {atm.nlay} merged layers: bit for bit {same}")
    if not same:
        raise AssertionError("ecCKD on the card differs from ecCKD on the host")


def phase_capi(cuda_ops, seed, smi):
    """33: the port's C bridge on the card.  Builds the library and demos
    with cc (`capi/build.py`); runs `demo_pprts --solver 3_10` on the card and
    holds its fields bit for bit to the same solve through the Python API
    here; runs `demo_specint` on bench.py's slab at CAPI_SLAB_N x CAPI_SLAB_N
    x 39 (its plev, tlev and liquid water in g/kg; ecCKD; 3_10 on the mockup
    table the bridge loads) and holds it bit for bit to `bridge.specint`
    called here.  The two demo processes start together (demo_pprts's 8 x 8
    x 8 solve beside demo_specint's start-up); this process touches the card
    only after both have ended.  Prints the walls of both, their peak device
    memory and their K1/K2 launches; returns the demo's specint call's
    launches."""
    from tenstream_tpu_torch.capi import bridge
    from tenstream_tpu_torch.capi.build import build
    from tenstream_tpu_torch.optprop.facade import OptProp
    from tenstream_tpu_torch.optprop.lut import load_or_create_lut, mockup_axes
    from tenstream_tpu_torch.pprts.grid import Grid
    from tenstream_tpu_torch.pprts.solver import PprtsSolver
    from tenstream_tpu_torch.pprts.sun import sundir_from_angles

    t0 = time.perf_counter()
    paths = build()
    log(f"capi: library and demos built in {time.perf_counter() - t0:.1f} s into "
        f"{os.path.relpath(os.path.dirname(paths['lib']), REPO)}")
    n_slab = CAPI_SLAB_N
    plev, tlev, lwc = capi_slab(n_slab, seed)
    nz = lwc.shape[0]
    hold_gas_optics_device(plev, tlev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        slab = os.path.join(tmp, "slab.bin")
        with open(slab, "wb") as fh:
            fh.write(np.asarray([nz, n_slab, n_slab], np.int32).tobytes())
            fh.write(np.asarray([100.0, 100.0], np.float64).tobytes())
            for a in (plev, tlev, lwc):
                fh.write(a.tobytes())

        def start(name, *args):
            """The demo's process, logging its calls to a file of its own."""
            calls = os.path.join(tmp, f"{name}.jsonl")
            env = dict(os.environ, TENSTREAM_TPU_TORCH_CAPI_LOG=calls)
            proc = subprocess.Popen([paths[name], *args], env=env, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
            return name, args, calls, proc, time.perf_counter()

        def finish(run):
            name, args, calls, proc, t0 = run
            try:
                stdout, stderr = proc.communicate(timeout=CAPI_TIMEOUT)
            except subprocess.TimeoutExpired:
                proc.kill()
                stdout, stderr = proc.communicate()
            wall = time.perf_counter() - t0
            if proc.returncode:
                raise AssertionError(f"capi {name}: exit {proc.returncode}\n{stdout}\n"
                                     f"{stderr[-4000:]}")
            with open(calls) as fh:
                call = json.loads(fh.read().splitlines()[-1])
            flags = " ".join(a for a in args if "/" not in a)
            log(f"capi {name} {flags}: {stdout.strip()}; process {wall:.1f} s, its "
                f"{call['call']} call {call['wall_s'] * 1e3:.1f} ms, peak device memory "
                f"{call['peak_gib']:.2f} GiB, launches {call['launches']}")
            return call

        out_pprts, out_spec = os.path.join(tmp, "pprts.bin"), os.path.join(tmp, "spec.bin")
        runs = [start("demo_pprts", "--solver", "3_10", "--out", out_pprts),
                start("demo_specint", "--solver", "3_10", "--specint", "ecckd", "--in", slab,
                      "--out", out_spec)]
        try:
            call_pprts = finish(runs[0])
            call = finish(runs[1])
        finally:
            for run in runs:
                if run[3].poll() is None:
                    run[3].kill()
                    run[3].communicate()

        n = CAPI_PPRTS_N
        raw = np.fromfile(out_pprts, np.float32)
        lev = (n + 1) * n * n
        got = [raw[k * lev:(k + 1) * lev] for k in range(3)] + [raw[3 * lev:]]
        lut = load_or_create_lut("3_10", mockup_axes(True), mockup_axes(False), n_photons=2000,
                                 device="cuda")
        solver = PprtsSolver(Grid.create(n, n, n, 100.0, 100.0, np.full(n, 100.0, np.float32),
                                         device="cuda"), OptProp(lut, device="cuda"))
        solver.set_angles(sundir_from_angles(180.0, 40.0))
        ones = np.ones((n, n, n), np.float32)
        solver.set_optical_properties(0.2, 1e-4 * ones, 1e-3 * ones, 0.5 * ones)
        cuda_ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver.solve(lthermal=False, lsolar=True, edirTOA=1364.0)
        want = [a.reshape(-1).cpu().numpy() for a in solver.get_result()]
        wall = time.perf_counter() - t0
        errs = [float(np.abs(a - b).max()) for a, b in zip(got, want)]
        log(f"capi demo_pprts against the Python API's solve ({wall * 1e3:.1f} ms, launches "
            f"{dict(cuda_ops.LAUNCHES)}): max abs edir {errs[0]:.3e} edn {errs[1]:.3e} eup "
            f"{errs[2]:.3e} W/m2, abso {errs[3]:.3e} W/m3 (all 0: {max(errs) == 0.0})")
        if max(errs) != 0.0 or call_pprts["launches"]["fused_A_dots"] == 0:
            raise AssertionError("capi demo_pprts: not bit for bit the Python API's solve, or "
                                 "no K1 launch")
        del solver

        n = n_slab
        raw = np.fromfile(out_spec, np.float32)
        nzm = int(raw[:1].view(np.int32)[0])
        lev = (nzm + 1) * n * n
        got = [raw[1 + k * lev:1 + (k + 1) * lev] for k in range(3)] + [raw[1 + 3 * lev:]]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cuda_ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = bridge.specint(nz, n, n, 100.0, 100.0, 180.0, 40.0, 0.1, 0.25, "ecckd", "3_10",
                             plev.tobytes(), tlev.tobytes(), lwc.tobytes(),
                             np.full(lwc.shape, 10.0, np.float32).tobytes(), None, None, 1, 1)
        wall = time.perf_counter() - t0
        bridge.destroy()
        want = [np.frombuffer(b, np.float32) for b in res[1:]]
        errs = [float(np.abs(a - b).max()) for a, b in zip(got, want)]
        chunk = bridge._band_chunk(torch.device("cuda"), (nzm + 1) * n * n)
        log(f"capi specint on bench.py's slab {n}x{n}x{nz} (merged to {nzm} layers), ecCKD, "
            f"3_10, chunks of {chunk}: the demo's call {call['wall_s'] * 1e3:.1f} ms (K1 "
            f"{call['launches']['fused_A_dots']}, K2 {call['launches']['orbit_contract']}), "
            f"bridge.specint here {wall * 1e3:.1f} ms (K1 {cuda_ops.LAUNCHES['fused_A_dots']}, "
            f"K2 {cuda_ops.LAUNCHES['orbit_contract']}), {smi}; peak device memory here "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; max abs edir {errs[0]:.3e} "
            f"edn {errs[1]:.3e} eup {errs[2]:.3e} W/m2, abso {errs[3]:.3e} W/m3 (all 0: "
            f"{max(errs) == 0.0})")
        if res[0] != nzm or max(errs) != 0.0:
            raise AssertionError("capi specint: the demo is not bit for bit bridge.specint")
        if not all(np.isfinite(a).all() for a in want):
            raise AssertionError("capi specint: non-finite fields")
        if call["launches"]["fused_A_dots"] == 0 or call["launches"]["orbit_contract"] == 0:
            raise AssertionError("capi specint: K1 or K2 not launched")
    torch.cuda.empty_cache()
    return call["launches"]


def instantiation_rows(cuda_ops, by_scheme, scheme_launches, dense_launches, main_launches,
                       spectral_launches):
    """Per kernel, its instantiations: (scheme, nd, norb, ms, bound_ms,
    plain_ms, library_ms, launches; K1/K2 also chunk_ms, chunk_bound_ms).
    Launches: 3_10's on the main path (K1/K2, phase 12) and the urban
    spectral path (K3, phase 14); the other sets' on phase 22 (K1/K2) and
    phase 23's dense solves (K3), summed over the schemes that share a set;
    `launches_spectral`: 3_30's K1/K2 on phase 24."""
    from tenstream_tpu_torch.optprop.facade import diff_pair_orbits
    from tenstream_tpu_torch.streams import get_scheme

    owner = {}
    for name in ("3_10", "8_10") + SCHEMES:
        s = get_scheme(name)
        idx, norb = diff_pair_orbits(s, with_mz=False)
        owner[name] = cuda_ops.ORBIT_SCHEMES[cuda_ops._orbit_instantiation(s, idx, norb)]
    out = {"fused_A_dots": [], "orbit_contract": [], "diffuse_apply_dense": []}
    for name, row in by_scheme.items():
        sharing = [n for n in SCHEMES if owner[n] == name]
        for kname, key in (("fused_A_dots", "fused_A_dots"), ("orbit_contract", "orbit_contract"),
                           ("diffuse_apply_dense", "diffuse_apply_dense_f32")):
            if name == "3_10":
                n = main_launches[kname]
            elif kname == "diffuse_apply_dense":
                n = sum(dense_launches[s] for s in sharing)
            else:
                n = sum(scheme_launches[s][kname] for s in sharing)
            r = row[key]
            entry = dict(scheme=name, shared_by=[s for s in owner if owner[s] == name and s != name],
                         nd=row["nd"], norb=row["norb"], ms=r["ms"], bound_ms=r["bound_ms"],
                         plain_ms=r["plain_ms"], library_ms=r["library_ms"], launches=n)
            if kname == "diffuse_apply_dense":
                bf = row["diffuse_apply_dense_bf16"]
                entry.update(ms_bf16=bf["ms"], bound_ms_bf16=bf["bound_ms"])
            else:
                entry.update(chunk_ms=r["chunk_ms"], chunk_bound_ms=r["chunk_bound_ms"])
                if name == SPECTRAL_SCHEME:
                    entry["launches_spectral"] = spectral_launches[kname]
            out[kname].append(entry)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=7)
    # one rank of phase 31 (b), started by the script itself
    ap.add_argument("--decomposed-rank", type=int, default=None, help=argparse.SUPPRESS)
    # one rank of phase 32 (b)
    ap.add_argument("--wedge-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.decomposed_rank is not None:
        if not torch.cuda.is_available():
            sys.exit(2)
        decomposed_rank(args.decomposed_rank, args.port, args.out, args.seed)
        return
    if args.wedge_rank is not None:
        if not torch.cuda.is_available():
            sys.exit(2)
        wedge_decomposed_rank(args.wedge_rank, args.port, args.out, args.seed)
        return

    name, smi = phase_device()
    from tenstream_tpu_torch.core.config import Options
    from tenstream_tpu_torch.optprop.facade import OptProp
    from tenstream_tpu_torch.optprop.lut import LUT
    from tenstream_tpu_torch.pprts import cuda_ops, ediff
    from tenstream_tpu_torch.pprts.buildings import Buildings
    from tenstream_tpu_torch.pprts.grid import Grid
    from tenstream_tpu_torch.pprts.solver import PprtsSolver
    from tenstream_tpu_torch.pprts.sun import sundir_from_angles

    from tenstream_tpu_torch.boxmc import cuda_tracer
    from tenstream_tpu_torch.optprop import lut as lutgen

    walls, clock = {}, [time.perf_counter()]

    def lap(label):
        now = time.perf_counter()
        walls[label] = round(now - clock[0], 1)
        clock[0] = now

    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        # the wedge phases launch no kernel: they run while the kernels build
        built = ex.submit(phase_build, cuda_ops)
        wopp = wedge_opp()
        wedge_exact, fish_ref = phase_wedge(cuda_ops, wopp, args.seed, smi)
        lap("25 wedge")
        wopp = wopp[0]
        chunk_ref = phase_wedge_spectral(cuda_ops, wopp, args.seed, smi)
        lap("26 wedge spectral")
        icon_mesh, icon_ref = phase_wedge_icon(cuda_ops, wopp, args.seed, smi)
        torch.cuda.empty_cache()
        lap("27 wedge ICON")
        wedge_launches = phase_wedge_decomposed(cuda_ops, wopp, args.seed, smi, fish_ref,
                                                icon_mesh, icon_ref, chunk_ref)
        del fish_ref, icon_mesh, icon_ref, chunk_ref
        lap("32a wedge decomposed")
        phase_wedge_decomposed_ranks(cuda_ops, wopp, args.seed)
        del wopp
        torch.cuda.empty_cache()
        lap("32b wedge decomposed ranks")
        phase_wedge_tables(cuda_ops, args.seed, smi)
        torch.cuda.empty_cache()
        lap("28 wedge tables")
        mc = phase_mcdmda(cuda_ops, args.seed, smi)
        torch.cuda.empty_cache()
        lap("29a mcdmda")
        ptx = log_build(built.result())
    lap("2 build (its wait after 25-29a)")
    opp = OptProp(LUT.load(LUT_PATH, device="cuda"), device="cuda")
    idx = opp._solver_orbit_idx
    sundir = sundir_from_angles(*SUN)
    report = phase_kernels(cuda_ops, opp.scheme, idx, NX, NY)
    report["diffuse_apply_dense"] = phase_kernel_dense(cuda_ops, opp.scheme, NX, NY,
                                                       args.seed)
    lap("3 kernels")
    phase_main(cuda_ops, opp, Grid, PprtsSolver, sundir, args.seed)
    lap("4 cloud")
    phase_parity(cuda_ops, ediff, opp, Grid, PprtsSolver, sundir, args.seed)
    phase_urban(cuda_ops, opp, Grid, PprtsSolver, Buildings, sundir_from_angles, args.seed)
    phase_urban_parity(cuda_ops, ediff, opp, Grid, PprtsSolver, Buildings, sundir, args.seed)
    phase_dense_vs_orbit(cuda_ops, opp, Grid, PprtsSolver, Options, sundir, args.seed)
    lap("5-8 parity, urban")
    launches, spec, steps = phase_spectral(cuda_ops, opp, args.seed, smi)
    phase_spectral_parity(cuda_ops, ediff, opp, args.seed)
    lap("12-13 spectral")
    profile_main(opp, Grid, PprtsSolver, sundir, args.seed)
    profile_urban(opp, Grid, PprtsSolver, Buildings, sundir_from_angles, args.seed)
    profile_spectral(spec)
    del spec
    torch.cuda.empty_cache()
    lap("9 profile")
    _, decomp_halo = phase_decomposed_main(cuda_ops, opp, args.seed, smi, steps)
    del steps
    lap("31a decomposed main path")
    k3_halo = phase_decomposed_ranks(cuda_ops, opp, Grid, PprtsSolver, Options, sundir, args.seed)
    halo_report = phase_halo_kernels(cuda_ops, opp.scheme, idx, NX, NY)
    report["orbit_contract"].update(halo_report["orbit_contract"])
    torch.cuda.empty_cache()
    lap("31b-c decomposed ranks, halo kernels")
    capi_launches = phase_capi(cuda_ops, args.seed, smi)
    lap("33 capi")
    launches["diffuse_apply_dense"] = phase_urban_spectral(
        cuda_ops, opp, args.seed, smi, report["diffuse_apply_dense"])["diffuse_apply_dense"]
    torch.cuda.empty_cache()
    phase_urban_spectral_parity(cuda_ops, ediff, opp, args.seed)
    lap("14-15 urban spectral")
    phase_options(cuda_ops, ediff, opp, args.seed)
    phase_terrain(cuda_ops, ediff, opp)
    torch.cuda.empty_cache()
    lap("16-17 options, terrain")
    means_3d = phase_gas_optics(cuda_ops, opp, args.seed, smi)
    phase_oned(args.seed, smi, means_3d)
    phase_gas_optics_parity(cuda_ops, ediff, opp, args.seed)
    torch.cuda.empty_cache()
    lap("18-20 gas optics, oned")
    by_scheme = phase_kernels_by_scheme(cuda_ops, ptx, args.seed)
    scheme_launches = phase_schemes(cuda_ops, OptProp, LUT, Grid, PprtsSolver, sundir, args.seed)
    dense_launches = phase_schemes_parity(cuda_ops, ediff, OptProp, LUT, Grid, PprtsSolver,
                                          Options, sundir, args.seed)
    spectral_launches = phase_spectral_scheme(cuda_ops, OptProp, LUT, args.seed, smi)
    lap("21-24 schemes")
    phase_mcdmda_solvers(cuda_ops, opp, mc, wedge_exact, args.seed)
    del mc
    torch.cuda.empty_cache()
    lap("29b mcdmda solvers")
    ann_launches = phase_ann(cuda_ops, ediff, opp, args.seed, smi)
    torch.cuda.empty_cache()
    lap("30 ann")
    insts = instantiation_rows(cuda_ops, by_scheme, scheme_launches, dense_launches, launches,
                               spectral_launches)
    report["boxmc_trace"] = phase_boxmc(cuda_tracer, lutgen, args.seed)
    launches["boxmc_trace"] = phase_lut(cuda_ops, cuda_tracer, lutgen, LUT, OptProp, Grid,
                                        PprtsSolver, sundir, args.seed)
    lap("10-11 boxmc, lut")

    kernels = []
    for kname, (tag, source, line, replaces) in KERNELS.items():
        kernels.append(dict(name=f"{tag} {kname}", route="cuda", source=source,
                            kernel=f"{source}:{line}", replaces=replaces,
                            launches=launches[kname], **report[kname]))
        if kname in insts:
            kernels[-1]["instantiations"] = insts[kname]
        if kname == "diffuse_apply_dense":
            kernels[-1]["launches_ann"] = ann_launches  # phase 30 (b): the ANN path
        # phase 32 (a): the decomposed wedge path launches none; phase 33: the C bridge's
        # specint in its demo's process
        kernels[-1]["launches_wedge_decomposed"] = wedge_launches[kname]
        kernels[-1]["launches_capi"] = capi_launches[kname]
    # the halo modes: K1's launches on phase 31 (a)'s decomposed main path, K3's on 31 (b)'s
    # dense solves; times from 31 (c)
    for kname, n in (("fused_A_dots", decomp_halo["fused_A_dots"]),
                     ("diffuse_apply_dense", k3_halo)):
        tag, source, line, replaces = KERNELS[kname]
        kernels.append(dict(name=f"{tag} {kname} (halo mode)", route="cuda", source=source,
                            kernel=f"{source}:{line}", replaces=replaces, launches=n,
                            **halo_report[kname]))
    log(f"phase walls [s]: {json.dumps(walls)}, total {sum(walls.values()):.1f}")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
