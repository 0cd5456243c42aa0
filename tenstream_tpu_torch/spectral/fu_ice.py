"""Fu ice-cloud optical properties (port of `tenstream_tpu/spectral/fu_ice.py`;
reference `repwvl/fu_ice.F90`): the Fu (1996) solar and Fu et al. (1998)
thermal band parameterizations with the effective-diameter conversion
De = reff / 0.64952.

Inputs follow the framework's cloud conventions: reice in [um];
tau = kext * iwc * dz with kext in [1/m per (g/m3)].  The per-cell work
runs in float64 on the effective-radius field's device, the arithmetic of
the JAX package's float64 numpy.
"""

from __future__ import annotations

import os
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from tenstream_tpu_torch.atm import DATA_DIR

_MAX_DE = 155.0  # um (reference MaxEffectiveRadius bound on De)
_MAX_G = 0.99
_PATH = os.path.join(DATA_DIR, "repwvl", "fu_ice_general.npz")


@lru_cache(maxsize=2)
def _load(path: str = _PATH) -> dict:
    z = np.load(path)
    return {k: z[k] for k in z.files}


def fu_ice_coeffs(wvl_um: np.ndarray, solar: bool):
    """Band coefficients at the requested wavelengths (nearest band below,
    like the reference's `find_real_location` and floor lookup):
    (ext, ssa, asy, abs), ssa None for thermal, abs None for solar."""
    z = _load()
    key = "fu96" if solar else "fu98"
    wb = z[f"{key}_wvl"]
    idx = np.clip(np.searchsorted(wb, wvl_um) - 1, 0, wb.size - 1)
    if solar:
        return z["fu96_ext"][idx], z["fu96_ssa"][idx], z["fu96_asy"][idx], None
    return z["fu98_ext"][idx], None, z["fu98_asy"][idx], z["fu98_abs"][idx]


def fu_ice_optprop(wvl_um, reice_um, solar: bool) -> Tuple[torch.Tensor, ...]:
    """(kext [1/m per g/m3], w0, g), float64 tensors of shape (nwvl,) +
    reice.shape on reice's device (numpy input: on the CPU).  Solar: Fu96
    eq. 3.9a-c; thermal: Fu98 (`fu_ice.F90:332-378, 423-460`)."""
    wvl_um = np.atleast_1d(np.asarray(wvl_um, np.float64))
    reice = torch.as_tensor(reice_um).to(torch.float64)
    dev = reice.device
    de = torch.clamp(torch.clamp(reice / 0.64952, max=_MAX_DE), min=1e-3)[None]
    ext, ssa, asy, ab = (None if c is None else torch.as_tensor(c, dtype=torch.float64, device=dev)
                         for c in fu_ice_coeffs(wvl_um, solar))
    nd = reice.dim()
    col = lambda c: c.reshape((c.shape[0],) + (1,) * nd)

    def poly3(c):
        return col(c[:, 0]) + de * (col(c[:, 1]) + de * (col(c[:, 2]) + de * col(c[:, 3])))

    if solar:
        kext = col(ext[:, 0]) + col(ext[:, 1]) / de
        w0 = 1.0 - poly3(ssa)
    else:
        inv = 1.0 / de
        kext = col(ext[:, 0]) + inv * (col(ext[:, 1]) + inv * col(ext[:, 2]))
        w0 = 1.0 - inv * poly3(ab)
    g = torch.clamp(poly3(asy), max=_MAX_G)
    return torch.clamp(kext, min=0.0), torch.clamp(w0, 0.0, 1.0), torch.clamp(g, 0.0, _MAX_G)
