"""The port's stream-scheme tables equal the JAX package's, for every
scheme; the port package and `chip_smoke.py` import neither JAX nor the
JAX package; every entry point that creates tensors defaults to the card;
`Options` keeps its scoping and strict parsing."""

import inspect
import os
import re

import numpy as np
import pytest

from tenstream_tpu import streams as jstreams
from tenstream_tpu_torch import streams as tstreams
import torch_jax_cache  # noqa: F401  (one XLA compile per program per run)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_ARRAYS = ("dir_src_offsets", "diff_axis", "diff_inward", "dir_axis", "difftop_weights",
           "diffside_weights", "diffside_bsrc_top", "diff_inv_dof", "dir_mirror_perm_xy")


@pytest.mark.parametrize("name", sorted(jstreams.SCHEMES))
def test_scheme_tables_equal(name):
    js, ts = jstreams.get_scheme(name), tstreams.get_scheme(name)
    assert (ts.name, ts.ndir, ts.ndiff) == (js.name, js.ndir, js.ndiff)
    for grp in ("dirtop", "dirside", "difftop", "diffside"):
        a, b = getattr(js, grp), getattr(ts, grp)
        assert (b.dof, b.streams, b.area_divider) == (a.dof, a.streams, a.area_divider), grp
    for attr in _ARRAYS:
        np.testing.assert_array_equal(np.asarray(getattr(ts, attr)()),
                                      np.asarray(getattr(js, attr)()), err_msg=attr)
    for sx in (False, True):
        for sy in (False, True):
            np.testing.assert_array_equal(ts.diff_switch_perm(sx, sy), js.diff_switch_perm(sx, sy))
            np.testing.assert_array_equal(ts.dir_switch_perm(sx, sy), js.dir_switch_perm(sx, sy))
    jm, tm = js.diff_mirror_perms(), ts.diff_mirror_perms()
    assert sorted(jm) == sorted(tm)
    for k in jm:
        np.testing.assert_array_equal(np.asarray(tm[k]), np.asarray(jm[k]), err_msg=k)


def test_scheme_registry_equal():
    assert sorted(tstreams.SCHEMES) == sorted(jstreams.SCHEMES)
    with pytest.raises(KeyError):
        tstreams.get_scheme("no_such_scheme")


def _port_sources():
    pkg = os.path.join(REPO, "tenstream_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith((".py", ".cu", ".cpp", ".h")):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_imports_no_jax():
    bad = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|tenstream_tpu)(\.|\s|$)", re.M)
    hits = []
    for path in _port_sources():
        with open(path) as fh:
            for m in bad.finditer(fh.read()):
                hits.append(f"{os.path.relpath(path, REPO)}: {m.group(0).strip()}")
    assert not hits, hits


def test_port_sources_walk_finds_kernels_and_scripts():
    """The import check above reads the CUDA sources and `chip_smoke.py` too."""
    rel = {os.path.relpath(p, REPO) for p in _port_sources()}
    for f in ("tenstream_tpu_torch/pprts/buildings.py", "tenstream_tpu_torch/ops/twostream.py",
              "tenstream_tpu_torch/csrc/dense_ops.cu", "tenstream_tpu_torch/csrc/dense_ops.h",
              "tenstream_tpu_torch/csrc/boxmc_ops.cu", "tenstream_tpu_torch/csrc/boxmc_ops.h",
              "tenstream_tpu_torch/boxmc/schemes.py", "tenstream_tpu_torch/boxmc/tracer.py",
              "tenstream_tpu_torch/boxmc/cuda_tracer.py", "tenstream_tpu_torch/optprop/lut.py",
              "tenstream_tpu_torch/tools/create_lut.py", "tenstream_tpu_torch/csrc/bind.cpp",
              "tenstream_tpu_torch/csrc/orbit_3_10.h",
              "tenstream_tpu_torch/core/prng.py", "tenstream_tpu_torch/spectral/mcica.py",
              "tenstream_tpu_torch/pprts/adaptive.py", "tenstream_tpu_torch/pprts/geometric.py",
              "tenstream_tpu_torch/pprts/postprocess.py",
              "tenstream_tpu_torch/spectral/vegetation.py", "tenstream_tpu_torch/convert.py",
              "tenstream_tpu_torch/utils/io.py", "tenstream_tpu_torch/utils/hdf5reader.py",
              "tenstream_tpu_torch/ops/krylov.py", "tenstream_tpu_torch/plexrt/mesh.py",
              "tenstream_tpu_torch/plexrt/icon.py", "tenstream_tpu_torch/plexrt/param_phi.py",
              "tenstream_tpu_torch/plexrt/optprop.py", "tenstream_tpu_torch/plexrt/solver.py",
              "tenstream_tpu_torch/plexrt/solver_unstructured.py",
              "tenstream_tpu_torch/plexrt/nca.py", "tenstream_tpu_torch/spectral/specint_plexrt.py",
              "chip_smoke.py"):
        assert f in rel, f


def test_chip_smoke_names_its_kernels():
    """`chip_smoke.py`'s kernel table points at the four kernels: each
    source exists, the line it names holds the kernel's name, the TPU
    kernel it replaces is where it says, and each wrapper counts launches."""
    import importlib.util

    from tenstream_tpu_torch.boxmc import cuda_tracer
    from tenstream_tpu_torch.pprts import cuda_ops

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert sorted(chip_smoke.KERNELS) == sorted(cuda_ops.LAUNCHES)
    names = {"fused_A_dots": ("fused_A_kernel", "_fused_A_kernel"),
             "orbit_contract": ("orbit_contract_kernel", "_contract_kernel"),
             "diffuse_apply_dense": ("diffuse_apply_dense_kernel", "def _kernel"),
             "boxmc_trace": ("boxmc_trace_kernel", "def kernel")}
    for wrapper, (tag, source, line, replaces) in chip_smoke.KERNELS.items():
        mod = cuda_tracer if wrapper == "boxmc_trace" else cuda_ops
        assert callable(getattr(mod, wrapper)) and callable(getattr(mod, wrapper + "_plain"))
        with open(os.path.join(REPO, source)) as fh:
            assert names[wrapper][0] in fh.read().splitlines()[line - 1], (wrapper, line)
        tpu_file, tpu_line = replaces.split(":")
        with open(os.path.join(REPO, tpu_file)) as fh:
            assert names[wrapper][1] in fh.read().splitlines()[int(tpu_line) - 1], wrapper


def test_entry_points_default_to_the_card():
    """Every entry point that creates tensors runs on the card unless the
    caller asks for the CPU; `Buildings` follows its solver's device
    (`tests/test_torch_buildings.py`)."""
    from tenstream_tpu_torch import convert
    from tenstream_tpu_torch.boxmc import cuda_tracer
    from tenstream_tpu_torch.optprop import lut
    from tenstream_tpu_torch.optprop.facade import OptProp
    from tenstream_tpu_torch.plexrt import nca, optprop, wedge_boxmc
    from tenstream_tpu_torch.pprts.grid import Grid

    for fn in (optprop.load_or_create_wedge_lut, optprop.wedge_lut_for_mesh,
               optprop.create_wedge_lut, optprop.wedge_optprop_for_mesh,
               wedge_boxmc.run_wedge_boxmc,
               convert.wedge_lut_from_arrays, nca.NcaTables.load, Grid.create, lut.LUT.load, OptProp.__init__, convert.lut_from_arrays,
               convert.buildings_from_arrays, convert.buildings_from_object, lut.create_lut, lut.create_production_lut,
               lut.compose_production_lut, lut.load_or_create_lut, cuda_tracer.run_boxmc_cuda):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn


def test_options_scoping_and_strict_parsing():
    from tenstream_tpu.core.config import Options as JOptions
    from tenstream_tpu_torch.core.config import Options

    vals = {"ksp_rtol": "1e-6", "solar_ksp_rtol": 1e-3, "flag": "yes", "n": "4"}
    for O in (JOptions, Options):
        o = O(vals, read_env=False)
        assert o.get_float("ksp_rtol", 0.0) == 1e-6
        assert o.scoped("solar_").get_float("ksp_rtol", 0.0) == 1e-3
        assert o.scoped("thermal_").get_float("ksp_rtol", 0.0) == 1e-6
        assert o.get_bool("flag") is True and o.get_int("n", 0) == 4
    o = Options({"flag": "maybe", "n": "4.5", "b": True}, read_env=False)
    for call in (lambda: o.get_bool("flag"), lambda: o.get_int("n", 0),
                 lambda: o.get_float("b", 0.0)):
        with pytest.raises(ValueError):
            call()
    o = Options(option_string="-ksp_max_it 20 -diff_precond line", read_env=False)
    assert o.get_int("ksp_max_it", 0) == 20 and o.get("diff_precond") == "line"
