"""Lookup tables of BoxMC transfer coefficients: loading and generation
(port of `tenstream_tpu/optprop/lut.py`).

Parity: reference `src/optprop_LUT.F90` (load/create tables, the
per-scheme parameter spaces in `src/optprop_base.F90:147-330`, axis
presets in `src/optprop_parameters.F90:53-245`) and the offline generator
`src/createLUT.F90`.

The npz format is the JAX package's: `LUT.save` here and there write the
same keys, and `LUT.load` of either package reads what the other saved.
Loaded and generated tables live on the caller's `device` as float32
tensors; the axes stay numpy (they are tiny and read on the host).  Table
layout is (n_tau, n_w0, n_aspect, n_g[, n_phi, n_theta], src, dst).

Generation keeps the tables in host numpy, as the JAX package does, and
traces entries in chunks of up to 4096 on `device`: through K4
(`boxmc.cuda_tracer`, plain PyTorch on a CPU device) for the schemes it
represents, else through the general tracer (`boxmc.tracer`).

Seeds.  The JAX package derives its streams from threefry keys; here
every stream comes from an integer seed by one fixed rule,

    fold(seed, data) = splitmix64 finalizer of ((seed mod 2^32) * 2^32
                       + (data mod 2^32)), keeping the low 31 bits,

applied where the JAX package applies `jax.random.fold_in`:

  - `create_lut(seed=12345)`: direct source s traces with fold(seed, s),
    diffuse source s with fold(seed, 100 + s);
  - `create_production_lut(seed=20260817)` and `_trace_adaptive`: round r
    of source s uses fold(seed, 7919 * r + s), and the slice starting at
    active entry lo uses fold(round seed, lo);
  - `_trace_entries(seed)`: on the K4 route the chunk starting at entry lo
    has seed + lo (the kernel's seed column is (seed + lo + 977 * src) mod
    2^22); on the general route the chunk's generator is seeded with
    fold(seed, lo).

On the K4 route `_trace_entries` does not hand `max_iter` to the tracer,
which then walks to its default of 3000: the JAX package does the same
(`tenstream_tpu/optprop/lut.py:332-335`, ROADMAP faults found), and the
port copies it so both make the same tables.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from tenstream_tpu_torch.boxmc.cuda_tracer import MAX_BATCH, kernel_refusal, run_boxmc_cuda
from tenstream_tpu_torch.boxmc.direct_transmission import dir2dir_table, supports_scheme
from tenstream_tpu_torch.boxmc.schemes import get_box_scheme
from tenstream_tpu_torch.boxmc.tracer import run_boxmc
from tenstream_tpu_torch.streams import SCHEMES

# Axis presets, reduced-but-log-spaced versions of the reference presets
# (`src/optprop_parameters.F90`: preset_tau31 spans 1e-10..100,
# preset_w020 crowds toward 1, preset_aspect23 spans 0.02..7.45,
# preset_g6 spans 0..0.85).
PRESET_TAU15 = np.array(
    [1e-10, 1e-5, 1e-4, 1e-3, 3e-3, 1e-2, 3e-2, 1e-1, 0.3, 0.7, 1.5, 3.0, 7.0, 20.0, 100.0],
    np.float32,
)
PRESET_W010 = np.array(
    [0.0, 0.3, 0.55, 0.7, 0.8, 0.88, 0.93, 0.97, 0.99, 0.99999], np.float32
)
PRESET_ASPECT13 = np.array(
    [0.02, 0.042, 0.075, 0.133, 0.237, 0.422, 0.75, 1.0, 1.25, 1.953, 3.052, 4.768, 7.451],
    np.float32,
)
PRESET_G4 = np.array([0.0, 0.25, 0.5, 0.85], np.float32)
PRESET_PHI7 = np.linspace(0.0, 90.0, 7).astype(np.float32)
PRESET_THETA10 = np.linspace(0.0, 90.0, 10).astype(np.float32)

# Reference production presets (`src/optprop_parameters.F90`):
# preset_tau31 (:144), preset_w020 (:188), preset_aspect23 (:106),
# preset_g6 (:243); phi/theta 19 points over [0, 90]
# (`src/optprop_base.F90:230-243`, LUT_3_10 entry).
PRESET_TAU31 = np.array(
    [1e-10, 3.62266272998e-07, 7.04565803675e-06, 4.47545500233e-05,
     0.000172126759821, 0.000495994753047, 0.00119161313679,
     0.00251026980343, 0.00480799264297, 0.00856221891924,
     0.0143961482731, 0.0231530284254, 0.0358868239775,
     0.0541358315379, 0.079959118223, 0.11623968405, 0.167882053841,
     0.246414427244, 0.350199325489, 0.502459974196, 0.759082408765,
     1.08083180518, 1.5415157991, 2.19832932733, 3.04549626819,
     4.27145477454, 6.16953841432, 9.43719309835, 15.7335501106,
     29.5819342206, 100.0], np.float32)
PRESET_TAU20 = np.array(
    [1e-10, 2.33773213401e-06, 5.40185638224e-05, 0.000365962943669,
     0.00145415861897, 0.00431514105527, 0.0105306225135,
     0.0225104907999, 0.044534085216, 0.0835690735283,
     0.152160041198, 0.271322429414, 0.492503225042,
     0.91860742252, 1.60959133986, 2.79337830498, 4.89077663742,
     9.35922562367, 21.643468069, 100.0], np.float32)
PRESET_W020 = np.array(
    [0.0, 0.152960717624, 0.295085090042, 0.416951893959, 0.521358613652,
     0.610087211908, 0.684967634054, 0.747886390181, 0.800286677013,
     0.84336972609, 0.878674797098, 0.906377786525, 0.928097831502,
     0.943463164595, 0.954135786554, 0.963824066888, 0.972632134967,
     0.981529289348, 0.990759644674, 0.99999], np.float32)
PRESET_ASPECT23 = np.array(
    [0.02, 0.032, 0.042, 0.056, 0.075, 0.1, 0.133, 0.178, 0.237,
     0.316, 0.422, 0.562, 0.75, 1.0, 1.25, 1.562, 1.953, 2.441,
     3.052, 3.815, 4.768, 5.96, 7.451], np.float32)
PRESET_G6 = np.array([0.0, 0.2424, 0.4137, 0.5717, 0.7144, 0.85], np.float32)
PRESET_PHI19 = np.linspace(0.0, 90.0, 19).astype(np.float32)
PRESET_THETA19 = np.linspace(0.0, 90.0, 19).astype(np.float32)

_CACHE_VERSION = 2  # the JAX package's: file names of cached tables match
_SLICE = 16384  # entries traced between two Welford merges / checkpoints


def fold(seed: int, data: int) -> int:
    """The module's seed rule (see the docstring): a 31-bit seed from
    (seed, data)."""
    m64 = (1 << 64) - 1
    x = (((seed & 0xFFFFFFFF) << 32) | (data & 0xFFFFFFFF)) + 0x9E3779B97F4A7C15 & m64
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & m64
    x = (x ^ (x >> 27)) * 0x94D049BB133111EB & m64
    return (x ^ (x >> 31)) & 0x7FFFFFFF


@dataclass(frozen=True)
class LUTAxes:
    tau: np.ndarray
    w0: np.ndarray
    aspect: np.ndarray
    g: np.ndarray
    phi: Optional[np.ndarray] = None  # direct tables only
    theta: Optional[np.ndarray] = None

    def cache_key(self, scheme: str, kind: str, n_photons: int) -> str:
        h = hashlib.sha1()
        payload = {
            "version": _CACHE_VERSION,
            "scheme": scheme,
            "kind": kind,
            "n_photons": n_photons,
            "axes": [np.asarray(a).tolist() for a in (self.tau, self.w0, self.aspect, self.g)]
            + ([np.asarray(self.phi).tolist(), np.asarray(self.theta).tolist()]
               if self.phi is not None else []),
        }
        h.update(json.dumps(payload).encode())
        return h.hexdigest()[:16]


@dataclass
class LUT:
    """One table pair for a scheme: direct (T & S) and diffuse (S).

    dir2dir: (ntau, nw0, nasp, ng, nphi, ntheta, ndir, ndir) [src, dst]
    dir2diff: (..., ndir, ndiff); diff2diff: (ntau, nw0, nasp, ng, ndiff, ndiff)
    """

    scheme: str
    dir_axes: LUTAxes
    diff_axes: LUTAxes
    dir2dir: torch.Tensor
    dir2diff: torch.Tensor
    diff2diff: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.diff2diff.device

    def save(self, path: str, meta: Optional[dict] = None) -> None:
        """Write the JAX package's npz layout (its `LUT.load` reads it)."""
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        extra = {} if meta is None else {"meta_json": np.asarray(json.dumps(meta))}
        host = lambda t: np.asarray(torch.as_tensor(t).detach().cpu().numpy(), np.float32)
        np.savez_compressed(
            path,
            scheme=self.scheme,
            dir2dir=host(self.dir2dir),
            dir2diff=host(self.dir2diff),
            diff2diff=host(self.diff2diff),
            **{f"dir_{k}": np.asarray(v) for k, v in dataclasses.asdict(self.dir_axes).items()
               if v is not None},
            **{f"diff_{k}": np.asarray(v) for k, v in dataclasses.asdict(self.diff_axes).items()
               if v is not None},
            **extra,
        )

    @staticmethod
    def load(path: str, device="cuda") -> "LUT":
        z = np.load(path, allow_pickle=False)
        dir_axes = LUTAxes(z["dir_tau"], z["dir_w0"], z["dir_aspect"], z["dir_g"],
                           z["dir_phi"], z["dir_theta"])
        diff_axes = LUTAxes(z["diff_tau"], z["diff_w0"], z["diff_aspect"], z["diff_g"])
        t = lambda k: torch.as_tensor(np.asarray(z[k], np.float32), device=device)
        return LUT(
            scheme=str(z["scheme"]),
            dir_axes=dir_axes,
            diff_axes=diff_axes,
            dir2dir=t("dir2dir"),
            dir2diff=t("dir2diff"),
            diff2diff=t("diff2diff"),
        )


def _lut_on(scheme, dir_axes, diff_axes, dir2dir, dir2diff, diff2diff, device) -> LUT:
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return LUT(scheme, dir_axes, diff_axes, t(dir2dir), t(dir2diff), t(diff2diff))


def perm_group(perms):
    """Closure of the given permutations under composition."""
    n = len(perms[0])
    group = {tuple(range(n))}
    frontier = [tuple(p) for p in perms]
    while frontier:
        new = []
        for p in frontier:
            if p in group:
                continue
            group.add(p)
            for q in list(group):
                for a, b in ((p, q), (q, p)):
                    c = tuple(a[i] for i in b)
                    if c not in group:
                        new.append(c)
        frontier = new
    return [np.asarray(p) for p in sorted(group)]


def symmetrize_tables(scheme: str, dir2dir, dir2diff, diff2diff, phi_grid):
    """Average numpy tables over the cube symmetry group: the x/y/z mirrors
    and the x<->y exchange for diffuse, the phi -> 90 - phi mirror with the
    x<->y exchange for direct tables on a phi axis symmetric about 45 deg.
    Exact for dx == dy cells (`src/pprts.F90:459`); reduces MC variance by
    the group order."""
    if scheme not in SCHEMES:
        return dir2dir, dir2diff, diff2diff
    sch = SCHEMES[scheme]
    p = sch.diff_mirror_perms()

    group = perm_group([p["mx"], p["my"], p["mz"], p["mxy"]])
    acc = np.zeros_like(diff2diff)
    for g in group:
        acc += diff2diff[..., g, :][..., :, g]
    diff2diff = acc / len(group)

    if np.allclose(phi_grid + phi_grid[::-1], 90.0, atol=1e-3):
        pd = np.asarray(sch.dir_mirror_perm_xy())
        pf = np.asarray(p["mxy"])
        dd_m = dir2dir[:, :, :, :, ::-1][..., pd, :][..., :, pd]
        df_m = dir2diff[:, :, :, :, ::-1][..., pd, :][..., :, pf]
        dir2dir = 0.5 * (dir2dir + dd_m)
        dir2diff = 0.5 * (dir2diff + df_m)
    return dir2dir, dir2diff, diff2diff


def default_axes(direct: bool) -> LUTAxes:
    if direct:
        return LUTAxes(PRESET_TAU15, PRESET_W010, PRESET_ASPECT13, PRESET_G4, PRESET_PHI7,
                       PRESET_THETA10)
    return LUTAxes(PRESET_TAU15, PRESET_W010, PRESET_ASPECT13, PRESET_G4)


def production_axes(direct: bool) -> LUTAxes:
    """Production parameter space: the full reference density for the
    diffuse table (tau31 x w020 x aspect23 x g6); the direct table keeps
    the tau/w0/aspect/g presets with phi7 x theta10 (dir2dir comes from the
    closed form at the exact per-solve angles, so only the smooth dir2diff
    block uses the tabulated angles)."""
    if direct:
        return LUTAxes(PRESET_TAU15, PRESET_W010, PRESET_ASPECT13, PRESET_G4, PRESET_PHI7,
                       PRESET_THETA10)
    return LUTAxes(PRESET_TAU31, PRESET_W020, PRESET_ASPECT23, PRESET_G6)


def mockup_axes(direct: bool) -> LUTAxes:
    """Tiny parameter space for tests (reference `LUT_mockup`,
    `src/optprop_base.F90:453-486`)."""
    tau = np.array([1e-10, 0.03, 0.3, 2.0, 20.0], np.float32)
    w0 = np.array([0.0, 0.5, 0.9, 0.99999], np.float32)
    aspect = np.array([0.1, 0.5, 1.0, 2.0], np.float32)
    g = np.array([0.0, 0.5], np.float32)
    if direct:
        phi = np.array([0.0, 45.0, 90.0], np.float32)
        theta = np.array([0.0, 40.0, 80.0], np.float32)
        return LUTAxes(tau, w0, aspect, g, phi, theta)
    return LUTAxes(tau, w0, aspect, g)


def _entry_grid(axes: LUTAxes, direct: bool) -> np.ndarray:
    dims = [axes.tau, axes.w0, axes.aspect, axes.g]
    if direct:
        dims += [axes.phi, axes.theta]
    mesh = np.meshgrid(*dims, indexing="ij")
    return np.stack([m.ravel() for m in mesh], axis=-1).astype(np.float32)  # (N, 4 or 6)


def _shape(axes: LUTAxes, direct: bool) -> Tuple[int, ...]:
    dims = (axes.tau, axes.w0, axes.aspect, axes.g) + ((axes.phi, axes.theta) if direct else ())
    return tuple(len(a) for a in dims)


def _trace_entries(
    scheme: str,
    entries: np.ndarray,
    src: int,
    ldir: bool,
    n_photons: int,
    seed: int,
    chunk: int = MAX_BATCH,
    use_kernel: Optional[bool] = None,
    max_iter: int = 3000,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """BoxMC for a list of parameter entries (N, 4 or 6) -> numpy (T (N,
    ndir), S (N, ndiff)).

    K4 traces the entries (photon count fixed at its 5120) unless
    `use_kernel` is False or K4 refuses the scheme; the general tracer
    takes the rest with `n_photons`, cost-sorted and with the walk cap of
    600 on thick chunks, as the JAX package's vmapped tracer does."""
    if use_kernel is not False and kernel_refusal(scheme, ldir) is None:
        params = np.zeros((entries.shape[0], 8), np.float32)
        params[:, : entries.shape[1]] = entries
        Ts, Ss = [], []
        for lo in range(0, entries.shape[0], chunk):
            # max_iter is not passed: the reference's K4 route walks to 3000
            T, S = run_boxmc_cuda(params[lo:lo + chunk], scheme, src, ldir, seed=seed + lo,
                                  device=device)
            Ts.append(T.cpu().numpy())
            Ss.append(S.cpu().numpy())
        return np.concatenate(Ts, 0), np.concatenate(Ss, 0)

    direct_cols = entries.shape[1] == 6
    n = entries.shape[0]
    # cost-sorted chunking: a chunk walks until its slowest entry's photons
    # die, so grouping entries by tau * w0 lets the cheap majority finish
    order = np.argsort(entries[:, 0] * entries[:, 1], kind="stable") if n > 64 else np.arange(n)
    ordered = entries[order]
    sub = max(1, min(chunk, (1 << 21) // max(1, n_photons)))  # photons in flight per call
    Ts, Ss = [], []
    for lo in range(0, n, chunk):
        part = ordered[lo:lo + chunk]
        # chunks dominated by the thick conservative corner get a reduced cap
        thick = float(np.median(part[:, 0] * part[:, 1])) > 10.0
        gen = torch.Generator(device=device).manual_seed(fold(seed, lo))
        for a in range(0, part.shape[0], sub):
            p = torch.as_tensor(part[a:a + sub], device=device)
            phi = p[:, 4] if direct_cols else 0.0
            theta = p[:, 5] if direct_cols else 0.0
            T, S = run_boxmc(gen, scheme, src, ldir, p[:, 0], p[:, 1], p[:, 3], p[:, 2], phi,
                             theta, n_photons=n_photons,
                             max_iter=min(600, max_iter) if thick else max_iter)
            Ts.append(T.cpu().numpy())
            Ss.append(S.cpu().numpy())
    T, S = np.concatenate(Ts, 0), np.concatenate(Ss, 0)
    inv = np.empty_like(order)
    inv[order] = np.arange(n)
    return T[inv], S[inv]


def create_lut(
    scheme: str,
    dir_axes: Optional[LUTAxes] = None,
    diff_axes: Optional[LUTAxes] = None,
    n_photons: int = 10000,
    seed: int = 12345,
    verbose: bool = False,
    checkpoint_path: Optional[str] = None,
    use_kernel: Optional[bool] = None,
    device="cuda",
) -> LUT:
    """Generate all tables for a scheme (reference `createLUT`,
    `src/optprop_LUT.F90:591`).  With `checkpoint_path`, per-source
    partial tables are written after each source so interrupted runs
    resume (LUT_dump_interval checkpointing, :625-796).  Tracing runs on
    `device`, and so do the returned tables."""
    box = get_box_scheme(scheme)
    dir_axes = dir_axes or default_axes(True)
    diff_axes = diff_axes or default_axes(False)
    dshape, fshape = _shape(dir_axes, True), _shape(diff_axes, False)
    dir_entries = _entry_grid(dir_axes, True)
    diff_entries = _entry_grid(diff_axes, False)

    dir2dir = np.zeros(dshape + (box.ndir, box.ndir), np.float32)
    dir2diff = np.zeros(dshape + (box.ndir, box.ndiff), np.float32)
    diff2diff = np.zeros(fshape + (box.ndiff, box.ndiff), np.float32)

    def _ckpt():
        if checkpoint_path:
            os.makedirs(os.path.dirname(os.path.abspath(checkpoint_path)), exist_ok=True)
            np.savez_compressed(checkpoint_path, dir2dir=dir2dir, dir2diff=dir2diff,
                                diff2diff=diff2diff)

    if checkpoint_path and os.path.exists(checkpoint_path):
        ck = np.load(checkpoint_path)
        if ck["dir2dir"].shape == dir2dir.shape:
            dir2dir, dir2diff, diff2diff = (ck["dir2dir"].copy(), ck["dir2diff"].copy(),
                                            ck["diff2diff"].copy())

    def _validate(T, S, what):
        if not (np.isfinite(T).all() and np.isfinite(S).all()):
            raise FloatingPointError(f"non-finite BoxMC tallies in {what}")
        worst = (T.sum(-1) + S.sum(-1)).max()
        if worst > 1.0 + 1e-3:
            raise FloatingPointError(f"energy creation in {what}: max row sum {worst}")

    kw = dict(use_kernel=use_kernel, device=device)
    for src in range(box.ndir):
        if dir2dir[..., src, :].sum() > 0:
            continue  # resumed from checkpoint
        T, S = _trace_entries(scheme, dir_entries, src, True, n_photons, fold(seed, src), **kw)
        _validate(T, S, f"dir src {src}")
        dir2dir[..., src, :] = T.reshape(dshape + (box.ndir,))
        dir2diff[..., src, :] = S.reshape(dshape + (box.ndiff,))
        if verbose:
            print(f"[lut:{scheme}] direct src {src + 1}/{box.ndir} done", flush=True)
        _ckpt()

    for src in range(box.ndiff):
        if diff2diff[..., src, :].sum() > 0:
            continue
        T, S = _trace_entries(scheme, diff_entries, src, False, n_photons, fold(seed, 100 + src),
                              **kw)
        _validate(T, S, f"diff src {src}")
        diff2diff[..., src, :] = S.reshape(fshape + (box.ndiff,))
        if verbose:
            print(f"[lut:{scheme}] diffuse src {src + 1}/{box.ndiff} done", flush=True)
        _ckpt()

    tables = symmetrize_tables(scheme, dir2dir, dir2diff, diff2diff, np.asarray(dir_axes.phi))
    return _lut_on(scheme, dir_axes, diff_axes, *tables, device)


def _take_lock(checkpoint_path: str) -> None:
    """Advisory lock: two processes adaptively tracing one checkpoint lose
    each other's updates (last writer wins per slice)."""
    lock = checkpoint_path + ".lock"
    os.makedirs(os.path.dirname(checkpoint_path) or ".", exist_ok=True)
    try:
        fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        os.write(fd, str(os.getpid()).encode())
        os.close(fd)
    except FileExistsError:
        try:
            other = int(open(lock).read().strip() or 0)
            os.kill(other, 0)  # raises if dead
            raise RuntimeError(
                f"checkpoint {checkpoint_path} is locked by live pid {other}; "
                "refusing concurrent adaptive tracing (lost-update hazard)")
        except (ProcessLookupError, ValueError, PermissionError):
            with open(lock, "w") as f:  # stale lock: take it over
                f.write(str(os.getpid()))


def _trace_adaptive(
    scheme: str,
    entries: np.ndarray,
    src: int,
    ldir: bool,
    seed: int,
    *,
    stddev_atol: float,
    stddev_rtol: float,
    round_photons: int = 5120,
    min_rounds: int = 4,
    max_rounds: int = 64,
    chunk: int = MAX_BATCH,
    use_kernel: Optional[bool] = None,
    conv_cols: Optional[slice] = None,
    checkpoint_path: Optional[str] = None,
    verbose: bool = False,
    max_iter: int = 3000,
    row_atol: float = 1e-4,
    device="cuda",
):
    """Per-entry adaptive Monte Carlo with the reference's convergence
    criterion (`std_update`, `src/boxmc.F90:968-996`; tolerances
    `src/optprop_parameters.F90:255-259`): converged when for every
    coefficient the standard error of the mean is < atol AND (mean <
    max(atol, 1e-5) OR sem/mean < rtol), plus the JAX package's row-sum
    criterion: the SEM of the summed scattered energy (over `conv_cols`)
    must satisfy sem_row < max(row_atol, rtol * row_sum), with a Poisson
    floor sqrt(row / photons) on sem_row.

    Rounds of `round_photons` photons are traced per still-active entry,
    in slices of `_SLICE` entries with a Welford merge (and a checkpoint)
    after each.  Returns (T, S, rounds, sem) with T/S the across-round
    means."""
    box = get_box_scheme(scheme)
    N = entries.shape[0]
    nT = box.ndir if ldir else 0
    width = nT + box.ndiff

    mean = np.zeros((N, width), np.float64)
    m2 = np.zeros((N, width), np.float64)
    rounds = np.zeros((N,), np.int64)

    if checkpoint_path:
        _take_lock(checkpoint_path)
    if checkpoint_path and os.path.exists(checkpoint_path):
        ck = np.load(checkpoint_path)
        if ck["mean"].shape == mean.shape:
            mean, m2, rounds = ck["mean"], ck["m2"], ck["rounds"]

    cols = conv_cols if conv_cols is not None else slice(None)

    def _unconverged():
        n = np.maximum(rounds, 1)[:, None].astype(np.float64)
        sem = np.sqrt(np.maximum(m2, 0.0) / n) / np.sqrt(n)
        m = mean
        relvar = np.where(m >= max(stddev_atol, 1e-5), sem / np.maximum(m, 1e-30), 0.0)
        bad = (sem[:, cols] >= stddev_atol) | (relvar[:, cols] >= stddev_rtol)
        # multinomial dst splits are negatively correlated, so the
        # sum of variances is a conservative row-sem estimate
        row = m[:, cols].sum(axis=1)
        sem_row = np.sqrt((sem[:, cols] ** 2).sum(axis=1))
        nphot = np.maximum(rounds, 1).astype(np.float64) * round_photons
        sem_row = np.maximum(sem_row, np.sqrt(np.maximum(row, 0.0) / nphot))
        bad_row = sem_row >= np.maximum(row_atol, stddev_rtol * row)
        return bad.any(axis=1) | bad_row | (rounds < min_rounds)

    try:
        _trace_adaptive_loop(
            scheme, entries, src, ldir, seed, mean, m2, rounds, _unconverged, max_rounds,
            round_photons, chunk, use_kernel, max_iter, checkpoint_path, verbose, N, device)
    finally:
        if checkpoint_path:
            try:
                os.remove(checkpoint_path + ".lock")
            except OSError:
                pass

    n = np.maximum(rounds, 1)[:, None].astype(np.float64)
    sem = np.sqrt(np.maximum(m2, 0.0) / n) / np.sqrt(n)
    return (mean[:, :nT].astype(np.float32), mean[:, nT:].astype(np.float32), rounds,
            sem.astype(np.float32))


def _trace_adaptive_loop(scheme, entries, src, ldir, seed, mean, m2, rounds, _unconverged,
                         max_rounds, round_photons, chunk, use_kernel, max_iter,
                         checkpoint_path, verbose, N, device):
    """Rounds in slices: a slice re-traced after an interruption merges
    extra independent samples, which the per-entry round counts account
    for."""
    while True:
        active = np.nonzero(_unconverged() & (rounds < max_rounds))[0]
        if active.size == 0:
            break
        r = int(rounds[active].min())
        rseed = fold(seed, 7919 * r + src)
        for lo in range(0, active.size, _SLICE):
            sl = active[lo:lo + _SLICE]
            T, S = _trace_entries(
                scheme, entries[sl], src, ldir, round_photons, fold(rseed, lo), chunk=chunk,
                use_kernel=use_kernel, max_iter=max_iter, device=device)
            c = np.concatenate([T, S], axis=-1).astype(np.float64) if ldir else S.astype(np.float64)
            rounds[sl] += 1
            nr = rounds[sl, None].astype(np.float64)
            delta = c - mean[sl]
            mean[sl] += delta / nr
            m2[sl] += delta * (c - mean[sl])
            if checkpoint_path:
                os.makedirs(os.path.dirname(os.path.abspath(checkpoint_path)), exist_ok=True)
                np.savez_compressed(checkpoint_path, mean=mean, m2=m2, rounds=rounds)
            if verbose and active.size > _SLICE:
                print(f"[lut:{scheme}] {'dir' if ldir else 'diff'} src {src} round {r + 1}: "
                      f"{min(lo + _SLICE, active.size)}/{active.size} traced", flush=True)
        if verbose:
            print(f"[lut:{scheme}] {'dir' if ldir else 'diff'} src {src} round {r + 1}: "
                  f"{active.size}/{N} entries active", flush=True)


def _diff_orbits(scheme: str):
    """Orbit representatives of the diffuse sources under the cube
    symmetry group, plus for every source a group permutation mapping it
    onto its representative: (reps, assign) with assign[s] = (rep, perm)
    such that table[s, d] = table[rep, perm[d]]."""
    sch = SCHEMES[scheme]
    p = sch.diff_mirror_perms()
    group = perm_group([p["mx"], p["my"], p["mz"], p["mxy"]])
    assign = {}
    reps = []
    for s in range(sch.ndiff):
        found = None
        for g in group:
            if int(g[s]) in reps:
                found = (int(g[s]), g)
                break
        if found is None:
            reps.append(s)
            found = (s, np.arange(sch.ndiff))
        assign[s] = found
    return reps, assign


def _clamp_and_gate(dir2dir, dir2diff, diff2diff, meta, limit, what):
    """Physical conservation clamp (scale each dir2diff row into the
    exact budget 1 - sum(dir2dir), never up) and the energy gate
    (reference `src/optprop_LUT.F90:1489-1504`)."""
    budget = np.maximum(1.0 - dir2dir.sum(-1), 0.0)
    s_sum = dir2diff.sum(-1)
    scale = np.where(s_sum > budget, budget / np.maximum(s_sum, 1e-30), 1.0)
    dir2diff = dir2diff * scale[..., None]
    viol = float(max((dir2dir.sum(-1) + dir2diff.sum(-1) - 1.0).max(), 0.0))
    violf = float(max((diff2diff.sum(-1) - 1.0).max(), 0.0))
    meta["energy_violation_dir"] = viol
    meta["energy_violation_diff"] = violf
    if max(viol, violf) > limit:
        raise FloatingPointError(
            f"energy creation in {what} tables: dir {viol:.2e} diff {violf:.2e}")
    return dir2diff, scale


def _rep_rows_to_table(scheme, rep_rows, fshape, ndiff):
    reps, assign = _diff_orbits(scheme)
    diff2diff = np.zeros(fshape + (ndiff, ndiff), np.float32)
    for s in range(ndiff):
        rep, g = assign[s]
        diff2diff[..., s, :] = rep_rows[rep][..., np.asarray(g)]
    return diff2diff


def create_production_lut(
    scheme: str,
    dir_axes: Optional[LUTAxes] = None,
    diff_axes: Optional[LUTAxes] = None,
    *,
    stddev_atol: float = 5e-4,
    stddev_rtol: float = 5e-2,
    dir_stddev_atol: float = 3e-3,
    max_rounds: int = 64,
    dir_max_rounds: int = 64,
    round_photons: int = 5120,
    checkpoint_dir: Optional[str] = None,
    use_kernel: Optional[bool] = None,
    verbose: bool = True,
    max_iter: int = 1500,
    seed: int = 20260817,
    device="cuda",
) -> Tuple[LUT, dict]:
    """Production-grade table generation, the JAX package's upgrades over
    `create_lut`: dir2dir from the closed form (`boxmc.direct_transmission`)
    where the scheme has one, so the direct MC only converges the dir2diff
    columns (dir_stddev_atol, 6x the reference's 5e-4 because the final
    symmetrization averages 2-4 samples per coefficient); adaptive per-entry
    convergence to the reference's criteria; only orbit-representative
    diffuse sources traced, and direct sources only for phi <= 45 (the phi
    -> 90 - phi mirror with the x<->y exchange fills the rest); the
    achieved tolerances in the returned meta.  `max_iter` caps walks on the
    general route only (see the module docstring).  Returns (lut, meta),
    the tables on `device`."""
    box = get_box_scheme(scheme)
    dir_axes = dir_axes or production_axes(True)
    diff_axes = diff_axes or production_axes(False)
    ck = (lambda name: os.path.join(checkpoint_dir, name) if checkpoint_dir else None)
    # sub-face direct schemes (8_*) have no closed form: their MC T fills dir2dir
    have_closed_form = supports_scheme(scheme)
    meta: dict = {"scheme": scheme, "stddev_atol": stddev_atol, "stddev_rtol": stddev_rtol}
    kw = dict(round_photons=round_photons, use_kernel=use_kernel, verbose=verbose,
              max_iter=max_iter, device=device)

    # ---------------- diffuse table: orbit reps + adaptive MC ----------
    fshape = _shape(diff_axes, False)
    diff_entries = _entry_grid(diff_axes, False)
    reps, _ = _diff_orbits(scheme)
    rep_rows, sems, rounds_all = {}, [], []
    for srep in reps:
        _, S, rounds, sem = _trace_adaptive(
            scheme, diff_entries, srep, False, seed, stddev_atol=stddev_atol,
            stddev_rtol=stddev_rtol, max_rounds=max_rounds,
            checkpoint_path=ck(f"diff_src{srep}.npz"), **kw)
        rep_rows[srep] = S.reshape(fshape + (box.ndiff,))
        sems.append(sem)
        rounds_all.append(rounds)
    diff2diff = _rep_rows_to_table(scheme, rep_rows, fshape, box.ndiff)
    sems = np.concatenate(sems, 0)
    rounds_cat = np.concatenate(rounds_all, 0)
    meta["diff_sem_max"] = float(sems.max())
    meta["diff_sem_median"] = float(np.median(sems))
    meta["diff_rounds_mean"] = float(rounds_cat.mean())
    meta["diff_photons_total"] = float(rounds_cat.sum() * round_photons)

    # ---------------- direct: closed-form dir2dir + MC dir2diff --------
    dshape = _shape(dir_axes, True)
    nphi = len(dir_axes.phi)
    phi_sym = bool(np.allclose(dir_axes.phi + dir_axes.phi[::-1], 90.0, atol=1e-3))
    nphi_lo = (nphi + 1) // 2 if phi_sym else nphi
    lo_axes = LUTAxes(dir_axes.tau, dir_axes.w0, dir_axes.aspect, dir_axes.g,
                      dir_axes.phi[:nphi_lo], dir_axes.theta)
    lo_shape = dshape[:4] + (nphi_lo, dshape[5])
    dir_entries = _entry_grid(lo_axes, True)

    dir2diff = np.zeros(dshape + (box.ndir, box.ndiff), np.float32)
    dir2dir_mc = None if have_closed_form else np.zeros(dshape + (box.ndir, box.ndir), np.float32)
    sems, rounds_all = [], []
    for src in range(box.ndir):
        T, S, rounds, sem = _trace_adaptive(
            scheme, dir_entries, src, True, seed, stddev_atol=dir_stddev_atol,
            stddev_rtol=stddev_rtol, max_rounds=dir_max_rounds,
            # with a closed-form T only the S columns gate convergence
            conv_cols=(slice(box.ndir, None) if have_closed_form else None),
            checkpoint_path=ck(f"dir_src{src}.npz"), **kw)
        dir2diff[:, :, :, :, :nphi_lo, :, src, :] = S.reshape(lo_shape + (box.ndiff,))
        if dir2dir_mc is not None:
            dir2dir_mc[:, :, :, :, :nphi_lo, :, src, :] = T.reshape(lo_shape + (box.ndir,))
        sems.append(sem[:, box.ndir:] if have_closed_form else sem)
        rounds_all.append(rounds)
    if phi_sym and nphi_lo < nphi:
        # mirror-fill phi > 45: phi -> 90-phi with the x<->y exchange of
        # both src and dst streams (see symmetrize_tables)
        sch = SCHEMES[scheme]
        pd = np.asarray(sch.dir_mirror_perm_xy())
        pf = np.asarray(sch.diff_mirror_perms()["mxy"])
        for i in range(nphi_lo, nphi):
            j = nphi - 1 - i
            dir2diff[:, :, :, :, i] = dir2diff[:, :, :, :, j][..., pd, :][..., :, pf]
            if dir2dir_mc is not None:
                dir2dir_mc[:, :, :, :, i] = dir2dir_mc[:, :, :, :, j][..., pd, :][..., :, pd]
    sems = np.concatenate(sems, 0)
    rounds_cat = np.concatenate(rounds_all, 0)
    meta["dir_sem_max"] = float(sems.max())
    meta["dir_sem_median"] = float(np.median(sems))
    meta["dir_rounds_mean"] = float(rounds_cat.mean())
    meta["dir_photons_total"] = float(rounds_cat.sum() * round_photons)
    meta["dir2dir_source"] = "closed_form" if have_closed_form else "mc"

    if have_closed_form:
        dd = dir2dir_table(scheme, dir_axes.tau, dir_axes.aspect, dir_axes.phi, dir_axes.theta)
        dir2dir = np.broadcast_to(dd[:, None, :, None], dshape + (box.ndir, box.ndir)).copy()
    else:
        dir2dir = dir2dir_mc

    dir2dir, dir2diff, diff2diff = symmetrize_tables(scheme, dir2dir, dir2diff, diff2diff,
                                                     np.asarray(dir_axes.phi))
    # dir2dir is exact while dir2diff is MC: the clamp removes the only way
    # the table can create energy, so the gate checks real defects
    dir2diff, scale = _clamp_and_gate(dir2dir, dir2diff, diff2diff, meta,
                                      5 * dir_stddev_atol, "generated")
    nclamped = int((scale < 1.0).sum())
    if nclamped:
        meta["dir2diff_rows_clamped"] = nclamped
        meta["dir2diff_clamp_min_scale"] = float(scale.min())
    return _lut_on(scheme, dir_axes, diff_axes, dir2dir, dir2diff, diff2diff, device), meta


def compose_production_lut(
    scheme: str,
    donor_path: str,
    checkpoint_dir: str,
    diff_axes: Optional[LUTAxes] = None,
    round_photons: int = 5120,
    device="cuda",
) -> Tuple[LUT, dict]:
    """Staged delivery: a production table from the converged diffuse
    checkpoints plus a donor LUT's direct tables (dir2dir regenerated in
    closed form on the donor's axes where the scheme has one, else the
    donor's MC block).  Each table carries its own axes, so the mixed
    densities interpolate correctly."""
    box = get_box_scheme(scheme)
    diff_axes = diff_axes or production_axes(False)
    fshape = _shape(diff_axes, False)
    nent = int(np.prod(fshape))
    reps, _ = _diff_orbits(scheme)
    meta: dict = {"scheme": scheme, "composed_from": os.path.basename(donor_path)}

    rep_rows, sems, rounds_all = {}, [], []
    for srep in reps:
        ckp = os.path.join(checkpoint_dir, f"diff_src{srep}.npz")
        ck = np.load(ckp)
        mean, m2, rounds = ck["mean"], ck["m2"], ck["rounds"]
        if mean.shape[0] != nent or not (rounds >= 1).all():
            raise RuntimeError(
                f"diffuse checkpoint {ckp} incomplete: "
                f"{int((rounds >= 1).sum())}/{nent} entries have >=1 round")
        n = np.maximum(rounds, 1)[:, None].astype(np.float64)
        sems.append((np.sqrt(np.maximum(m2, 0.0) / n) / np.sqrt(n)).astype(np.float32))
        rounds_all.append(rounds)
        rep_rows[srep] = mean.astype(np.float32).reshape(fshape + (box.ndiff,))
    diff2diff = _rep_rows_to_table(scheme, rep_rows, fshape, box.ndiff)
    sems_cat = np.concatenate(sems, 0)
    rounds_cat = np.concatenate(rounds_all, 0)
    meta["diff_sem_max"] = float(sems_cat.max())
    meta["diff_sem_median"] = float(np.median(sems_cat))
    meta["diff_rounds_mean"] = float(rounds_cat.mean())
    meta["diff_photons_total"] = float(rounds_cat.sum() * round_photons)

    donor = LUT.load(donor_path, device="cpu")
    dir_axes = donor.dir_axes
    dshape = _shape(dir_axes, True)
    if supports_scheme(scheme):
        dd = dir2dir_table(scheme, dir_axes.tau, dir_axes.aspect, dir_axes.phi, dir_axes.theta)
        dir2dir = np.broadcast_to(dd[:, None, :, None], dshape + (box.ndir, box.ndir)).copy()
    else:
        # quadrant-resolved direct schemes (8_*): stage the donor's MC block
        meta["dir2dir_from_donor_mc"] = True
        dir2dir = donor.dir2dir.numpy().copy()
    dir2diff = donor.dir2diff.numpy().copy()

    dir2dir, dir2diff, diff2diff = symmetrize_tables(scheme, dir2dir, dir2diff, diff2diff,
                                                     np.asarray(dir_axes.phi))
    dir2diff, _ = _clamp_and_gate(dir2dir, dir2diff, diff2diff, meta, 2.5e-2, "composed")
    return _lut_on(scheme, dir_axes, diff_axes, dir2dir, dir2diff, diff2diff, device), meta


def lut_basename() -> str:
    return os.environ.get(
        "TENSTREAM_TPU_LUT_DIR",
        os.path.join(os.path.dirname(__file__), "..", "..", "data", "luts"))


def load_or_create_lut(
    scheme: str,
    dir_axes: Optional[LUTAxes] = None,
    diff_axes: Optional[LUTAxes] = None,
    n_photons: int = 10000,
    basename: Optional[str] = None,
    verbose: bool = False,
    use_kernel: Optional[bool] = None,
    device="cuda",
) -> LUT:
    """Disk-cached table access (reference `lut_basename`,
    `src/optprop_parameters.F90:38`): the file name carries the JAX
    package's cache key, so either package finds the other's tables."""
    dir_axes = dir_axes or default_axes(True)
    diff_axes = diff_axes or default_axes(False)
    base = basename or lut_basename()
    tag = (dir_axes.cache_key(scheme, "dir", n_photons)[:8]
           + diff_axes.cache_key(scheme, "diff", n_photons)[:8])
    path = os.path.abspath(os.path.join(base, f"LUT_{scheme}_{tag}.npz"))
    if os.path.exists(path):
        return LUT.load(path, device=device)
    lut = create_lut(scheme, dir_axes, diff_axes, n_photons, verbose=verbose,
                     checkpoint_path=path + ".partial.npz", use_kernel=use_kernel, device=device)
    lut.save(path)
    try:
        os.remove(path + ".partial.npz")
    except OSError:
        pass
    return lut
