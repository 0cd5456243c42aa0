"""The port's stream-scheme tables equal the JAX package's, for every
scheme; the port package and `chip_smoke.py` import neither JAX nor the
JAX package; `Options` keeps its scoping and strict parsing."""

import os
import re

import numpy as np
import pytest

from tenstream_tpu import streams as jstreams
from tenstream_tpu_torch import streams as tstreams

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
