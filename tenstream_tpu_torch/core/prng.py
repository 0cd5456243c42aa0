"""A counter-based threefry2x32 generator equal, bit for bit, to the JAX
package's `jax.random` with the default `threefry2x32` implementation in
its partitionable mode (`jax_threefry_partitionable=True`, the default of
the JAX versions the package runs under).

    key = Threefry.from_seed(712).fold_in(0)
    u = key.uniform((ngpt, nlay, nx, ny), device="cuda")  # float32 in [0, 1)

- `from_seed(s)` is `PRNGKey(s)`: the key words (s >> 32, s & 0xffffffff).
- `fold_in(d)` is threefry2x32(key, (0, d)).
- `bits(shape)` hashes the 64-bit counter i = 0..prod(shape)-1 of each
  element in row-major order as the word pair (i >> 32, i & 0xffffffff)
  and returns the xor of the two output words (the partitionable layout;
  the classic layout hashed the two halves of the flat counter range).
- `uniform(shape)` maps 32 random bits to float32 as JAX does: the top 23
  bits become the mantissa of a number in [1, 2), minus 1; with bounds it
  returns max(minval, f * (maxval - minval) + minval), as JAX does.
- `normal(shape)` is `jax.random.normal(key, shape, float32)`: sqrt(2) *
  erfinv(u) of u uniform in (nextafter(-1, 0), 1), with XLA's float32
  erfinv (Giles' polynomials, their products and sums as one rounding);
  it differs from JAX's by at most a few ulp (its log1p is not XLA's).
- `split(n)` is `jax.random.split(key, n)` in the partitionable mode
  (`_threefry_split_foldlike`): child i is the output word pair of
  threefry2x32(key, (i >> 32, i & 0xffffffff)).

Batched keys are int64 tensors of shape (..., 2) (`Threefry.words`,
`split_keys`, `fold_in_keys`, `uniform_keys`): each key hashes its own
counters, as `jax.vmap` over keys does.

The words are held in int64 tensors masked to 32 bits, so the generator
runs on the CPU and the card alike with torch's integer ops.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0, k1, x0: torch.Tensor,
                 x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 20-round threefry2x32 hash of the word pairs (x0, x1) (int64
    tensors holding uint32 values) under the key (k0, k1): ints, or int64
    tensors that broadcast against the counters."""
    ks = (k0 & _MASK, k1 & _MASK, (k0 ^ k1 ^ 0x1BD11BDA) & _MASK)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


class Threefry:
    """An immutable threefry2x32 key (two uint32 words)."""

    def __init__(self, k0: int, k1: int):
        self.key = (int(k0) & _MASK, int(k1) & _MASK)

    @classmethod
    def from_seed(cls, seed: int) -> "Threefry":
        """`jax.random.PRNGKey(seed)`."""
        seed = int(seed)
        return cls((seed >> 32) & _MASK if seed >= 0 else 0, seed & _MASK)

    def split(self, n: int = 2) -> Tuple["Threefry", ...]:
        """`jax.random.split(key, n)`."""
        w = split_keys(self.words(), n)
        return tuple(Threefry(int(a), int(b)) for a, b in w.tolist())

    def words(self, device="cpu") -> torch.Tensor:
        """The key as an int64 tensor of shape (2,)."""
        return torch.tensor(self.key, dtype=torch.int64, device=device)

    def fold_in(self, data: int) -> "Threefry":
        """`jax.random.fold_in(key, data)`."""
        x0 = torch.zeros(1, dtype=torch.int64)
        x1 = torch.full((1,), int(data) & _MASK, dtype=torch.int64)
        y0, y1 = threefry2x32(*self.key, x0, x1)
        return Threefry(int(y0[0]), int(y1[0]))

    def bits(self, shape: Sequence[int], device="cuda") -> torch.Tensor:
        """`jax.random.bits(key, shape, uint32)` as int64 values in [0, 2^32)."""
        n = math.prod(shape)
        count = torch.arange(n, dtype=torch.int64, device=device)
        y0, y1 = threefry2x32(*self.key, count >> 32, count & _MASK)
        return (y0 ^ y1).reshape(tuple(shape))

    def uniform(self, shape: Sequence[int], device="cuda", minval: float = 0.0,
                maxval: float = 1.0) -> torch.Tensor:
        """`jax.random.uniform(key, shape, float32, minval, maxval)`."""
        return to_uniform(self.bits(shape, device), minval, maxval)

    def normal(self, shape: Sequence[int], device="cuda") -> torch.Tensor:
        """`jax.random.normal(key, shape, float32)`."""
        lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
        return erfinv(self.uniform(shape, device, lo, 1.0)) * float(np.float32(math.sqrt(2.0)))


def to_uniform(bits: torch.Tensor, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """32 random bits -> float32 in [minval, maxval) as JAX maps them."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    if minval == 0.0 and maxval == 1.0:
        return f
    lo = torch.tensor(minval, dtype=torch.float32, device=f.device)
    span = torch.tensor(maxval, dtype=torch.float32, device=f.device) - lo
    # XLA contracts f * span + lo into one fused multiply-add: the float64
    # product of two float32 values is exact, so one rounding of the float64
    # sum gives the fused result
    fused = (f.double() * span.double() + lo.double()).float()
    return torch.maximum(lo, fused)


# XLA's ErfInv32: Giles, "Approximating the erfinv function", single precision
_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                  0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                  0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """float32 erfinv of |x| < 1 as XLA evaluates it (`lax.erf_inv`)."""
    w = -torch.log1p(-(x * x).double()).float()
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, w.double().sqrt().float() - 3.0).double()
    coef = lambda i: torch.where(lt, float(np.float32(_ERFINV_W_LT_5[i])),
                                 float(np.float32(_ERFINV_W_GE_5[i]))).double()
    p = coef(0)
    for i in range(1, len(_ERFINV_W_LT_5)):
        p = (coef(i) + p * w).float().double()  # one rounding: XLA contracts it
    return p.float() * x


def split_keys(keys: torch.Tensor, n: int = 2) -> torch.Tensor:
    """`jax.random.split` of each key in keys (..., 2): (..., n, 2)."""
    i = torch.arange(n, dtype=torch.int64, device=keys.device)
    y0, y1 = threefry2x32(keys[..., 0:1], keys[..., 1:2], i >> 32, i & _MASK)
    return torch.stack([y0, y1], dim=-1)


def fold_in_keys(keys: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """`jax.random.fold_in(key, d)` for keys (..., 2) and int data that
    broadcast: (..., 2)."""
    d = torch.as_tensor(data, dtype=torch.int64, device=keys.device) & _MASK
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def uniform_keys(keys: torch.Tensor, counters: torch.Tensor, minval: float = 0.0,
                 maxval: float = 1.0) -> torch.Tensor:
    """Element i of `jax.random.uniform(key, shape, minval=, maxval=)` for
    each key of keys (..., 2) and each flat index i of counters (int64),
    broadcast against each other."""
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1], counters >> 32, counters & _MASK)
    return to_uniform(y0 ^ y1, minval, maxval)
