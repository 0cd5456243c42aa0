"""Vegetation optical properties (port of
`tenstream_tpu/spectral/vegetation.py`; reference
`rrtmg/rrtmg/vegetation_optprop.F90`): spectral albedo curves of plant
materials (bark, grass, leaf; sampled from the public USGS spectral
library), averaged over a wavelength range, for the `extra_tau / extra_w0
/ extra_g` inputs of `specint_pprts`.

Vegetation enters the solve as per-cell extinction tau = LAD * dz (leaf
area density) with single-scattering albedo = the range-averaged material
albedo (reference `pprts_specint_tree.F90:209-305`).  Host numpy only.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

# wavelength [um] -> albedo sample points (USGS spectral library)
VEG_TYPES: Dict[str, Tuple[np.ndarray, np.ndarray]] = {
    # WhitebarkPine YNP-WB-1 frst AVIRISb RTGC
    "bark": (
        np.array([0.419, 0.547, 0.676, 0.695, 0.743, 0.772, 0.915, 0.954,
                  1.069, 1.175, 1.264, 1.304, 1.424, 1.483, 1.663, 1.812,
                  1.99, 2.249, 2.478]),
        np.array([0.013, 0.029, 0.023, 0.033, 0.113, 0.128, 0.144, 0.138,
                  0.158, 0.129, 0.146, 0.142, 0.057, 0.056, 0.091, 0.078,
                  0.043, 0.052, 0.033]),
    ),
    # LawnGrass GDS91b shifted 3nm BECKa AREF
    "grass": (
        np.array([0.205, 0.403, 0.499, 0.515, 0.527, 0.543, 0.563, 0.591,
                  0.679, 0.688, 0.694, 0.708, 0.714, 0.72, 0.736, 0.746,
                  0.754, 0.76, 0.775, 0.807, 0.914, 0.933, 0.957, 0.976,
                  1.068, 1.104, 1.128, 1.144, 1.154, 1.179, 1.204, 1.258,
                  1.299, 1.318, 1.353, 1.374, 1.398, 1.404, 1.408, 1.423,
                  1.448, 1.474, 1.592, 1.634, 1.676, 1.716, 1.772, 1.835,
                  1.855, 1.865, 1.885, 1.895, 1.915, 1.935, 2.015, 2.125,
                  2.215, 2.265, 2.466, 2.656, 2.688, 2.752, 2.784, 2.816,
                  2.944, 2.976]),
        np.array([0.02, 0.027, 0.041, 0.06, 0.085, 0.095, 0.089, 0.064,
                  0.039, 0.049, 0.072, 0.172, 0.224, 0.287, 0.485, 0.588,
                  0.637, 0.66, 0.686, 0.7, 0.704, 0.695, 0.663, 0.659,
                  0.699, 0.693, 0.671, 0.619, 0.593, 0.574, 0.572, 0.594,
                  0.575, 0.537, 0.452, 0.395, 0.224, 0.197, 0.181, 0.154,
                  0.142, 0.153, 0.304, 0.336, 0.344, 0.327, 0.285, 0.277,
                  0.242, 0.205, 0.1, 0.066, 0.043, 0.042, 0.079, 0.144,
                  0.168, 0.155, 0.054, 0.029, 0.013, 0.003, 0.02, 0.0,
                  0.012, 0.003]),
    ),
    # Aspen_Leaf-A DW92-2 BECKa AREF
    "leaf": (
        np.array([0.353, 0.499, 0.519, 0.531, 0.553, 0.597, 0.688, 0.694,
                  0.7, 0.708, 0.728, 0.734, 0.74, 0.751, 0.769, 0.851,
                  0.949, 1.084, 1.198, 1.244, 1.303, 1.333, 1.378, 1.384,
                  1.408, 1.423, 1.448, 1.468, 1.534, 1.592, 1.647, 1.7,
                  1.772, 1.835, 1.855, 1.865, 1.895, 1.905, 1.945, 2.155,
                  2.235, 2.285, 2.496, 2.56, 2.592]),
        np.array([0.032, 0.039, 0.053, 0.076, 0.087, 0.053, 0.037, 0.045,
                  0.073, 0.135, 0.332, 0.379, 0.411, 0.442, 0.458, 0.46,
                  0.444, 0.438, 0.398, 0.403, 0.398, 0.375, 0.322, 0.305,
                  0.181, 0.141, 0.124, 0.126, 0.199, 0.247, 0.268, 0.263,
                  0.233, 0.233, 0.217, 0.192, 0.058, 0.038, 0.029, 0.111,
                  0.127, 0.093, 0.031, 0.025, 0.031]),
    ),
}


def _frac_loc(grid: np.ndarray, x: float) -> float:
    """Fractional index of x in a sorted grid (reference
    `find_real_location`), clamped to [0, len-1]."""
    i = float(np.interp(x, grid, np.arange(len(grid), dtype=np.float64)))
    return min(max(i, 0.0), float(len(grid) - 1))


def get_albedo_for_range(veg_name: str, lambda_min_um: float,
                         lambda_max_um: float) -> float:
    """Mean material albedo over [lambda_min, lambda_max] (um):
    equidistant sampling in fractional-index space, matching the
    reference (`vegetation_optprop.F90:186-215` — coarse on purpose,
    the RT convolution dominates any residual quadrature error)."""
    if lambda_min_um > lambda_max_um:
        raise ValueError("lambda_min must be <= lambda_max")
    lam, alb = VEG_TYPES[veg_name]
    lstart = _frac_loc(lam, lambda_min_um)
    lend = _frac_loc(lam, lambda_max_um)
    nsample = 1 + int(np.ceil(lend - lstart))
    fidx = np.linspace(lstart, lend, nsample)
    return float(np.interp(fidx, np.arange(len(alb)), alb).mean())


def mix_material(tau0, w0_0, tau_add, w0_add):
    """Optical-depth-weighted single-scattering-albedo mix when stacking
    materials in one cell (reference `pprts_specint_tree.F90:265-269`)."""
    tau = tau0 + tau_add
    w0 = np.where(tau > 0, (w0_0 * tau0 + w0_add * tau_add) / np.maximum(tau, 1e-30), 0.0)
    return tau, w0
