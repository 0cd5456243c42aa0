"""Neural-network transfer-coefficient backend (LUT alternative): the port
of `tenstream_tpu/optprop/ann.py` (reference `src/optprop_ANN.F90`, an MLP
predicting the 3_10 transfer coefficients from (tau, w0, aspect, g[, phi,
theta]), selected with `-pprts_use_ANN`).

The net is trained on a generated LUT (`AnnOptProp(lut, ...)`, or
`python -m tenstream_tpu_torch.tools.train_ann`), persisted in the JAX
package's npz layout (either package loads the other's file), and
evaluated as a stack of float32 matrix products (TF32 off on the card).
API-compatible with `OptProp` (`dir_coeffs` / `diff_coeffs`, `scheme`,
`device`), so `PprtsSolver` takes either backend; a net has no orbit
channels, so the solver keeps the dense coefficient form (kernel K3 on
the card).

Training follows JAX's: the He-normal init from the port's threefry
(`prng.Threefry.normal`), full-batch Adam for small tables, shuffled
minibatch Adam with optax's cosine decay (`alpha` 1e-2) otherwise.  The
shuffle is `jax.random.permutation`'s: one or two rounds of sorting the
rows by 32 random bits (`_permutation`; a stable sort, where XLA's sort
leaves the order of equal keys to itself).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tenstream_tpu_torch.core import prng
from tenstream_tpu_torch.core.types import ireals
from tenstream_tpu_torch.ops.disort import _true_float32
from tenstream_tpu_torch.optprop.lut import LUT
from tenstream_tpu_torch.streams import StreamScheme, get_scheme

Params = List[Tuple[torch.Tensor, torch.Tensor]]


def _mlp_init(key: prng.Threefry, sizes: Sequence[int], device="cuda") -> Params:
    """He-normal weights and zero biases, float32, as JAX draws them."""
    params = []
    for i in range(len(sizes) - 1):
        key, k1 = key.split()
        w = k1.normal((sizes[i], sizes[i + 1]), device) * float(np.float32(math.sqrt(2.0 / sizes[i])))
        params.append((w, torch.zeros(sizes[i + 1], dtype=torch.float32, device=w.device)))
    return params


def _mlp_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    for w, b in params[:-1]:
        x = F.gelu(x @ w + b, approximate="tanh")  # jax.nn.gelu's default
    w, b = params[-1]
    return torch.sigmoid(x @ w + b)  # coefficients live in [0, 1]


def _features(tau, w0, aspect, g, phi=None, theta=None) -> torch.Tensor:
    f = [torch.log10(torch.clamp(tau, min=1e-12)), w0, torch.log(torch.clamp(aspect, min=1e-3)), g]
    if phi is not None:
        f += [phi / 90.0, theta / 90.0]
    shape = f[0].shape
    return torch.stack([torch.as_tensor(v, dtype=ireals, device=f[0].device).expand(shape)
                        for v in f], dim=-1)


def _permutation(key: prng.Threefry, n: int, device) -> torch.Tensor:
    """`jax.random.permutation(key, n)`: ceil(3 ln n / ln(2^32 - 1)) rounds,
    each sorting by `bits(subkey, (n,))` of the next `split`."""
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    x = torch.arange(n, device=device)
    for _ in range(rounds):
        key, sub = key.split()
        x = x[torch.argsort(sub.bits((n,), device), stable=True)]
    return x


def _cosine_decay(lr: float, steps: int, alpha: float = 1e-2):
    """optax.cosine_decay_schedule(lr, steps, alpha)."""
    return lambda t: lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * min(t, steps) / steps))
                           + alpha)


def _fit(params: Params, X: torch.Tensor, Y: torch.Tensor, epochs: int, lr: float = 3e-3,
         batch: Optional[int] = None, key: Optional[prng.Threefry] = None) -> Tuple[Params, float]:
    """Adam from `params`: full-batch when `batch` is None or covers the
    table (the loss returned is the last step's, before its update), else
    shuffled minibatches with cosine decay (the last epoch's mean loss)."""
    params = [(w.detach().clone().requires_grad_(), b.detach().clone().requires_grad_())
              for w, b in params]
    flat = [t for wb in params for t in wb]
    n = X.shape[0]
    full = batch is None or batch >= n
    steps_per_epoch = 1 if full else n // batch
    # one fused kernel per step on the card: the update's rounding is not
    # optax's either way
    opt = torch.optim.Adam(flat, lr=lr, betas=(0.9, 0.999), eps=1e-8, fused=X.is_cuda)
    sched = None if full else _cosine_decay(lr, epochs * steps_per_epoch)
    loss = float("nan")
    step = 0
    with _true_float32():
        for _ in range(epochs):
            if full:
                rows = [None]
            else:
                key, ke = key.split()
                perm = _permutation(ke, n, X.device)[: steps_per_epoch * batch]
                rows = perm.reshape(steps_per_epoch, batch)
            losses = []
            for r in rows:
                xb, yb = (X, Y) if r is None else (X[r], Y[r])
                if sched is not None:
                    for group in opt.param_groups:
                        group["lr"] = sched(step)
                opt.zero_grad(set_to_none=True)
                lb = torch.mean((_mlp_apply(params, xb) - yb) ** 2)
                lb.backward()
                opt.step()
                losses.append(lb.detach())
                step += 1
            loss = float(torch.stack(losses).mean())
    return [(w.detach(), b.detach()) for w, b in params], loss


def _train(key: prng.Threefry, X, Y, hidden=(64, 64), epochs=400, lr=3e-3,
           batch=None) -> Tuple[Params, float]:
    """JAX `_train`: `key, kinit = split(key)`, the init from kinit, then
    `_fit` (minibatch epochs shuffle with keys split from `key`)."""
    sizes = [X.shape[-1], *hidden, Y.shape[-1]]
    key, kinit = key.split()
    return _fit(_mlp_init(kinit, sizes, X.device), X, Y, epochs, lr, batch, key)


class AnnOptProp:
    """MLP coefficient backend trained on a LUT (JAX `AnnOptProp`); `save` /
    `load` persist it in the JAX package's npz layout."""

    def __init__(self, lut: Optional[LUT], scheme: Optional[StreamScheme] = None,
                 hidden=(64, 64), epochs=400, seed=0, batch=None, device="cuda"):
        self.device = torch.device(device)
        if lut is None:  # constructed by load() / from_params()
            self.scheme = scheme
            return
        self.scheme = scheme or get_scheme(lut.scheme)
        nd, nf = self.scheme.ndir, self.scheme.ndiff
        k1, k2 = prng.Threefry.from_seed(seed).split()
        grid = lambda axes: [torch.as_tensor(g.ravel(), dtype=ireals, device=self.device)
                             for g in np.meshgrid(*axes, indexing="ij")]
        tab = lambda t: torch.as_tensor(t, dtype=torch.float32, device=self.device)

        da = lut.dir_axes
        Xd = _features(*grid((da.tau, da.w0, da.aspect, da.g, da.phi, da.theta)))
        Yd = torch.cat([tab(lut.dir2dir).reshape(-1, nd * nd),
                        tab(lut.dir2diff).reshape(-1, nd * nf)], dim=-1)
        self._dir_params, self.dir_loss = _train(k1, Xd, Yd, hidden, epochs, batch=batch)

        fa = lut.diff_axes
        Xf = _features(*grid((fa.tau, fa.w0, fa.aspect, fa.g)))
        Yf = tab(lut.diff2diff).reshape(-1, nf * nf)
        self._diff_params, self.diff_loss = _train(k2, Xf, Yf, hidden, epochs, batch=batch)
        self.device = self._diff_params[0][0].device

    @classmethod
    def from_params(cls, scheme: str, dir_params, diff_params, dir_loss: float = float("nan"),
                    diff_loss: float = float("nan"), device="cuda") -> "AnnOptProp":
        """A net from its layer arrays ((w, b) pairs, array-likes)."""
        self = cls(None, scheme=get_scheme(str(scheme)), device=device)
        t = lambda a: torch.tensor(np.asarray(a, np.float32), device=self.device)
        self._dir_params = [(t(w), t(b)) for w, b in dir_params]
        self._diff_params = [(t(w), t(b)) for w, b in diff_params]
        self.dir_loss, self.diff_loss = float(dir_loss), float(diff_loss)
        self.device = self._diff_params[0][0].device
        return self

    # persistence ------------------------------------------------------------
    def save(self, path: str) -> None:
        """Write the params to npz (layer arrays + scheme + losses)."""
        arrs = {"scheme": np.asarray(self.scheme.name)}
        for tag, params, loss in (("dir", self._dir_params, self.dir_loss),
                                  ("diff", self._diff_params, self.diff_loss)):
            arrs[f"{tag}_nlayers"] = np.asarray(len(params))
            arrs[f"{tag}_loss"] = np.asarray(loss)
            for i, (w, b) in enumerate(params):
                arrs[f"{tag}_w{i}"] = w.detach().cpu().numpy()
                arrs[f"{tag}_b{i}"] = b.detach().cpu().numpy()
        np.savez_compressed(path, **arrs)

    @classmethod
    def load(cls, path: str, device="cuda") -> "AnnOptProp":
        z = np.load(path)
        layers = lambda tag: [(z[f"{tag}_w{i}"], z[f"{tag}_b{i}"])
                              for i in range(int(z[f"{tag}_nlayers"]))]
        return cls.from_params(str(z["scheme"]), layers("dir"), layers("diff"),
                               float(z["dir_loss"]), float(z["diff_loss"]), device)

    # facade-compatible API -------------------------------------------------
    def _net(self, params: Params, X: torch.Tensor) -> torch.Tensor:
        with torch.no_grad(), _true_float32():
            return _mlp_apply(params, X)

    def dir_coeffs(self, tauz, w0, g, aspect, phi_deg, theta_deg, switch_x=False,
                   switch_y=False) -> Tuple[torch.Tensor, torch.Tensor]:
        """(dir2dir, dir2diff) with shapes (ndir, ndir) + B and (ndir, ndiff) + B."""
        nd, nf = self.scheme.ndir, self.scheme.ndiff
        ang = lambda a: torch.as_tensor(a, dtype=ireals, device=tauz.device)
        X = _features(tauz, w0, aspect, g, ang(phi_deg), ang(theta_deg))
        Y = self._net(self._dir_params, X)
        from tenstream_tpu_torch.boxmc.direct_transmission import (
            dir2dir_analytic,
            supports_scheme,
        )

        lead = tuple(X.shape[:-1])
        if supports_scheme(self.scheme.name):
            # the exact closed-form direct backbone, as the LUT facade's: the
            # net only carries the scattered source term
            c_dd = dir2dir_analytic(self.scheme.name, tauz, aspect, phi_deg, theta_deg).to(ireals)
        else:
            c_dd = Y[..., : nd * nd].reshape(lead + (nd, nd))
        c_dd = torch.movedim(c_dd, (-2, -1), (0, 1))
        c_df = torch.movedim(Y[..., nd * nd:].reshape(lead + (nd, nf)), (-2, -1), (0, 1))
        if switch_x or switch_y:
            # the sun-octant unfolding of OptProp.dir_coeffs: p on both dir
            # dims, p / q on dir2diff src / dst
            q = torch.as_tensor(self.scheme.diff_switch_perm(switch_x, switch_y),
                                device=c_df.device)
            p = torch.as_tensor(self.scheme.dir_switch_perm(switch_x, switch_y),
                                device=c_df.device)
            c_dd = c_dd[p][:, p]
            c_df = c_df[p][:, q]
        return c_dd, c_df

    def diff_coeffs(self, tauz, w0, g, aspect) -> torch.Tensor:
        """diff2diff: (ndiff, ndiff) + B [src, dst]."""
        nf = self.scheme.ndiff
        X = _features(tauz, w0, aspect, g)
        Y = self._net(self._diff_params, X)
        return torch.movedim(Y.reshape(tuple(X.shape[:-1]) + (nf, nf)), (-2, -1), (0, 1))
