"""Column-wise 1-D solver drivers for `PprtsSolver` (port of
`tenstream_tpu/pprts/oned.py`; reference `src/pprts_1D_solvers.F90`,
`twostream`:55 and `schwarz`:418, dispatched by `solve_pprts`,
`src/pprts.F90:2606-2652`).  The reference loops over columns; here the
batched column solvers run the whole grid at once.

Results are in [W/m2] on the levels and [W/m3] per layer, so `get_result`
returns them as they are.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tenstream_tpu_torch.core.types import TINY
from tenstream_tpu_torch.ops.schwarzschild import schwarzschild
from tenstream_tpu_torch.ops.twostream import delta_eddington_twostream


def solve_twostream_columns(kabs, ksca, g, dz3d, mu0, incSolar_tilted, albedo2d, planck=None,
                            planck_srfc=None
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(S, Edn, Eup, abso [W/m3]) for every column; incSolar_tilted is the
    irradiance on the tilted plane (the caller applies mu on output)."""
    dtau = (kabs + ksca) * dz3d
    w0 = ksca / torch.clamp(kabs + ksca, min=TINY)
    S, Edn, Eup = delta_eddington_twostream(dtau, w0, g, mu0, incSolar_tilted, albedo2d,
                                            planck=planck, planck_srfc=planck_srfc)
    net = (S[:-1] - S[1:]) + (Edn[:-1] - Edn[1:]) + (Eup[1:] - Eup[:-1])
    return S, Edn, Eup, net / dz3d


def solve_schwarzschild_columns(kabs, dz3d, albedo2d, planck, planck_srfc=None, nmu: int = 2
                                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(Edn, Eup, abso [W/m3]): thermal only, no scattering."""
    Edn, Eup = schwarzschild(kabs * dz3d, albedo2d, planck, nmu=nmu, srfc_emission=planck_srfc)
    net = (Edn[:-1] - Edn[1:]) + (Eup[1:] - Eup[:-1])
    return Edn, Eup, net / dz3d
