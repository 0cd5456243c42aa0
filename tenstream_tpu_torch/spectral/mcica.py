"""McICA stochastic subcolumns for partial cloudiness (port of
`tenstream_tpu/spectral/mcica.py`; reference
`rrtmg/rrtm_lw/mcica_subcol_gen_lw.f90` / `..._sw.f90`, the Raisanen et
al. 2004 generator): every g-point sees one random binary subcolumn drawn
from the layer cloud fractions, and the in-cloud condensate is the layer
mean over the fraction.

The random numbers come from `core.prng.Threefry`, which draws what
`jax.random.uniform` draws from the same key, so the masks equal the JAX
package's bit for bit.  The maximum-random overlap is a loop over z; every
other step is vectorised over (gpt, nx, ny).

On a rank's (x, y) block of a decomposed domain (`block=`) each column
draws the numbers of its global position (the generator is counter
based), so a block's masks equal the same columns' masks of the
undecomposed draw bit for bit.
"""

from __future__ import annotations

import torch

from tenstream_tpu_torch.core.prng import Threefry, uniform_keys
from tenstream_tpu_torch.core.types import ireals


def _block_uniform(key: Threefry, ngpt: int, f: torch.Tensor, block) -> torch.Tensor:
    """The (ngpt, nlay, nx, ny) numbers of `key.uniform((ngpt, nlay, NX,
    NY))` at this block's columns: block = ((x slice, y slice), (NX, NY))."""
    (sx, sy), (gnx, gny) = block
    ar = lambda a, b: torch.arange(a, b, dtype=torch.int64, device=f.device)
    g = ar(0, ngpt)[:, None, None, None]
    k = ar(0, f.shape[0])[None, :, None, None]
    i = ar(sx.start, sx.stop)[None, None, :, None]
    j = ar(sy.start, sy.stop)[None, None, None, :]
    counters = ((g * f.shape[0] + k) * gnx + i) * gny + j
    return uniform_keys(key.words(f.device), counters)


def mcica_subcolumns(key: Threefry, cld_frac: torch.Tensor, ngpt: int,
                     overlap: str = "maxrand", block=None) -> torch.Tensor:
    """(ngpt, nlay, ...) boolean cloud masks on `cld_frac`'s device.

    cld_frac (nlay, ...) in [0, 1]; overlap 'maxrand' (the reference
    default, icld=2), 'max' or 'random'.  With block = ((x slice, y
    slice), (NX, NY)), cld_frac (nlay, nx, ny) is that block of a global
    (nlay, NX, NY) field and the masks are that block's of its draw."""
    if overlap not in ("maxrand", "max", "random"):
        raise ValueError(f"unknown overlap {overlap!r}")
    f = torch.clamp(torch.as_tensor(cld_frac, dtype=ireals), 0.0, 1.0)
    if block is None:
        u = key.uniform((ngpt,) + tuple(f.shape), device=f.device)
    else:
        u = _block_uniform(key, ngpt, f, block)
    if overlap == "random":
        x = u
    elif overlap == "max":
        x = u[:, :1].expand_as(u)
    else:
        # Raisanen eq. 14: a subcolumn cloudy in the layer above keeps its
        # number, a clear one draws afresh below the layer above's fraction
        f_above = torch.cat([torch.zeros_like(f[:1]), f[:-1]], dim=0)
        xs, x_prev = [], u[:, 0]
        for k in range(f.shape[0]):
            clear_above = 1.0 - f_above[k]
            x_prev = torch.where(x_prev > clear_above, x_prev, u[:, k] * clear_above)
            xs.append(x_prev)
        x = torch.stack(xs, dim=1)
    return x > (1.0 - f)[None]


def mcica_condensate(key: Threefry, cld_frac, lwc, ngpt: int,
                     overlap: str = "maxrand") -> torch.Tensor:
    """Per-g-point condensate (ngpt, nlay, ...): the layer-mean `lwc` over
    the cloud fraction in the cloudy subcolumns, zero elsewhere
    (reference `generate_stochastic_clouds`)."""
    f = torch.as_tensor(cld_frac, dtype=ireals)
    mask = mcica_subcolumns(key, f, ngpt, overlap)
    incloud = torch.as_tensor(lwc, dtype=ireals, device=f.device) / torch.clamp(f, 1e-6, 1.0)
    return torch.where(mask, incloud[None], torch.zeros((), dtype=ireals, device=f.device))
