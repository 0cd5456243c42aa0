"""Precision policy and physical constants (port of
`tenstream_tpu/core/types.py`).

The port computes in float32 throughout (`ireals`); complex work in the
preconditioner is complex64.
"""

from __future__ import annotations

import numpy as np
import torch

ireals = torch.float32
icomplex = torch.complex64

EPS = float(np.finfo(np.float32).eps)
TINY = float(np.finfo(np.float32).tiny)

PI = float(np.pi)

K_BOLTZMANN = 1.380649e-23  # [J/K]
C_SPEED_OF_LIGHT = 299792458.0  # [m/s]
H_PLANCK = 6.62607015e-34  # [J s]
STEFAN_BOLTZMANN = 5.670374419e-8  # [W/m2/K4]
R_DRY_AIR = 287.058  # [J/kg/K]
R_WATER_VAPOUR = 461.52  # [J/kg/K]
CP_DRY_AIR = 1004.64  # [J/kg/K]
GRAV = 9.80665  # [m/s2]
AVOGADRO = 6.02214076e23
MOLMASS_DRY_AIR = 28.9644e-3  # [kg/mol]
MOLMASS_H2O = 18.0153e-3  # [kg/mol]
EARTH_RADIUS = 6371.0e3  # [m]
SOLAR_CONSTANT = 1361.0  # [W/m2] total solar irradiance

