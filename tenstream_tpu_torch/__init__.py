"""tenstream_tpu_torch — the PyTorch/CUDA port of `tenstream_tpu`.

The package mirrors the JAX package's layout (`core/`, `ops/`,
`optprop/`, `boxmc/`, `pprts/`, `plexrt/`, `spectral/`, `parallel/`,
`utils/`, `streams.py`, and `capi/` for the JAX package's top-level `capi/`)
so each module's counterpart is easy to find.  `parallel/` decomposes the
cube solver, the wedge solvers and both full-spectrum integrations over a
`torch.distributed` group (one process per GPU, each rank an (x, y) block,
or a range of an ICON mesh's cells); `capi/` is the C API a C or Fortran
host model links (`capi/build.py` compiles it at first use); `utils/` holds the file formats (scene dumps, NetCDF, XDMF,
HDF5) and `utils/chip.py`'s device probe and watchdogs.  It imports torch and numpy only.  Every
entry point takes an explicit `device` (default ``"cuda"``); on a CUDA
device the diffuse solve runs through the hand-written kernels in
`pprts/cuda_ops.py`, on the CPU through their plain PyTorch versions.

Everything computes in float32 (`core.types.ireals`).  TF32 is switched
off for matrix products and convolutions on import: the LUT one-hot
contraction and the preconditioner's DFTs are float32 matmuls whose
inputs must not be rounded to 10 mantissa bits.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

from tenstream_tpu_torch.core.config import Options  # noqa: E402,F401
