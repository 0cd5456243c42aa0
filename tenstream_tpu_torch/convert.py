"""Carry the JAX package's state into the port.

The port's "weights" are the LUT tables.  `lut_from_arrays` takes any
object with the JAX `LUT`'s attributes (`scheme`, `dir_axes`,
`diff_axes`, `dir2dir`, `dir2diff`, `diff2diff`; arrays convertible with
numpy) and returns the port's `LUT` on `device`, so both packages can
solve with identical tables; the tables pass through unchanged, a
diff2diff table that is not symmetrized included (the port's `OptProp`
then keeps the dense coefficient form, as the JAX one does).
`wedge_lut_from_arrays` does the same for a JAX `WedgeLUT` (the wedge
solvers' tables), `buildings_from_arrays` for the fields of a JAX
`Buildings` (`buildings_from_object` reads them off the object, `temp`
included), `atmosphere_from_arrays` for an `Atmosphere` (the
spectral driver's input, host float64 arrays that pass through as
copies), and `ann_from_arrays` for a trained `AnnOptProp` (its layer
arrays and losses).
"""

from __future__ import annotations

import numpy as np
import torch

from tenstream_tpu_torch.atm import Atmosphere
from tenstream_tpu_torch.optprop.ann import AnnOptProp
from tenstream_tpu_torch.optprop.lut import LUT, LUTAxes
from tenstream_tpu_torch.plexrt.optprop import WedgeAxes, WedgeLUT
from tenstream_tpu_torch.pprts.buildings import Buildings


def _axes(a, direct: bool) -> LUTAxes:
    f = lambda v: np.asarray(v, np.float32)
    if direct:
        return LUTAxes(f(a.tau), f(a.w0), f(a.aspect), f(a.g), f(a.phi), f(a.theta))
    return LUTAxes(f(a.tau), f(a.w0), f(a.aspect), f(a.g))


def lut_from_arrays(obj, device="cuda") -> LUT:
    t = lambda v: torch.as_tensor(np.asarray(v, np.float32), device=device)
    return LUT(
        scheme=str(obj.scheme),
        dir_axes=_axes(obj.dir_axes, True),
        diff_axes=_axes(obj.diff_axes, False),
        dir2dir=t(obj.dir2dir),
        dir2diff=t(obj.dir2diff),
        diff2diff=t(obj.diff2diff),
    )


def wedge_lut_from_arrays(obj, device="cuda") -> WedgeLUT:
    """The port's `WedgeLUT` on `device` from any object with a JAX
    `WedgeLUT`'s fields (`daxes`, `faxes`, `dir2dir`, `dir2diff`,
    `diff2diff`, `scheme`, `apex`): both packages then solve with the same
    tables."""
    t = lambda v: torch.as_tensor(np.asarray(v, np.float32), device=device)
    f = lambda v: None if v is None else np.asarray(v, np.float32)
    ax = lambda a: WedgeAxes(f(a.tau), f(a.w0), f(a.aspect), f(a.g), f(a.phi), f(a.theta))
    return WedgeLUT(ax(obj.daxes), ax(obj.faxes), t(obj.dir2dir), t(obj.dir2diff),
                    t(obj.diff2diff), str(obj.scheme), tuple(float(v) for v in obj.apex))


def buildings_from_arrays(solid, albedo, planck=None, temp=None, device="cuda") -> Buildings:
    """The port's `Buildings` on `device` from array-likes (the fields of
    a JAX `Buildings` converted with numpy)."""
    f = lambda v: None if v is None else torch.as_tensor(np.array(v, np.float32), device=device)
    return Buildings(torch.as_tensor(np.array(solid, bool), device=device), float(albedo),
                     f(planck), f(temp))


def buildings_from_object(obj, device="cuda") -> Buildings:
    """The port's `Buildings` from any object with the JAX `Buildings`'
    fields (`solid`, `albedo`, `planck`, `temp`): the face temperature the
    spectral integration reads carries over, as does a static Planck."""
    return buildings_from_arrays(obj.solid, obj.albedo, planck=obj.planck, temp=obj.temp,
                                 device=device)


def atmosphere_from_arrays(obj) -> Atmosphere:
    """The port's `Atmosphere` from any object with the JAX `Atmosphere`'s
    fields (plev, tlev, zlev, gases and the optional cloud fields)."""
    opt = lambda v: None if v is None else np.array(v)
    return Atmosphere(
        plev=np.array(obj.plev), tlev=np.array(obj.tlev), zlev=np.array(obj.zlev),
        gases={k: np.array(v) for k, v in obj.gases.items()},
        lwc=opt(obj.lwc), reliq=opt(obj.reliq), iwc=opt(obj.iwc), reice=opt(obj.reice),
        cfrac=opt(obj.cfrac), skin_temperature=opt(obj.skin_temperature))


def ann_from_arrays(obj, device="cuda") -> AnnOptProp:
    """The port's `AnnOptProp` on `device` from any object with a JAX
    `AnnOptProp`'s fields (`scheme`, its name or a scheme with `.name`;
    `_dir_params` / `_diff_params`, lists of (w, b) arrays; `dir_loss`,
    `diff_loss`): both packages then evaluate the same net."""
    layers = lambda ps: [(np.asarray(w, np.float32), np.asarray(b, np.float32)) for w, b in ps]
    return AnnOptProp.from_params(getattr(obj.scheme, "name", obj.scheme),
                                  layers(obj._dir_params), layers(obj._diff_params),
                                  float(obj.dir_loss), float(obj.diff_loss), device)
