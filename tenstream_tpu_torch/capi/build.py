"""Builds the port's C library (`libtenstream_tpu_torch.so`) and its two
demos from the sources beside this file into
`tenstream_tpu_torch/_build/capi/`, at first use: `build()` compiles with
`cc` when a source, the checkout's path or the interpreter changed, and
returns the paths of what it built.  The library embeds the interpreter
that runs `build()` (its include and link flags are what `python3-config
--includes` and `python3-config --ldflags --embed` give for it, read from
its `sysconfig`), so the C host imports the same torch.

    python -m tenstream_tpu_torch.capi.build     # prints the paths
"""

from __future__ import annotations

import fcntl
import hashlib
import json
import os
import shutil
import subprocess
import sys
import sysconfig

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = os.path.dirname(HERE)
REPO = os.path.dirname(PKG)
OUT = os.path.join(PKG, "_build", "capi")
LIB = "libtenstream_tpu_torch.so"
DEMOS = ("demo_pprts", "demo_specint")
SOURCES = ("tenstream_tpu_torch.h", "tenstream_tpu_torch_capi.c") + tuple(d + ".c" for d in DEMOS)


def python_flags():
    """(compile flags, link flags) that embed this interpreter's Python;
    raises where its installation has no shared libpython to link."""
    get = sysconfig.get_config_var
    incs = {sysconfig.get_paths()["include"], sysconfig.get_paths()["platinclude"]}
    libdir, ldlib = get("LIBDIR"), get("LDLIBRARY") or ""
    if not (libdir and ldlib.endswith(".so") and os.path.exists(os.path.join(libdir, ldlib))):
        raise RuntimeError(f"no shared libpython to embed ({libdir}/{ldlib}): the C API needs a "
                           "Python built with --enable-shared")
    link = [f"-L{libdir}", f"-lpython{get('LDVERSION')}"] + (get("LIBS") or "").split() + \
        (get("SYSLIBS") or "").split() + [f"-Wl,-rpath,{libdir}"]
    return [f"-I{i}" for i in sorted(incs)], link


def _stamp(cflags, lflags, cc) -> str:
    h = hashlib.sha256(json.dumps([REPO, sys.executable, cflags, lflags, cc]).encode())
    for f in SOURCES:
        with open(os.path.join(HERE, f), "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()


def build(out_dir: str = OUT, cc: str = None) -> dict:
    """The library and the demos, built if stale: {"lib": path, "demo_pprts":
    path, "demo_specint": path}.  Safe to call from several processes at
    once (a file lock; the first builds, the others wait and reuse it)."""
    cc = cc or os.environ.get("CC") or shutil.which("cc") or "cc"
    cflags, lflags = python_flags()
    os.makedirs(out_dir, exist_ok=True)
    paths = {"lib": os.path.join(out_dir, LIB)}
    paths.update({d: os.path.join(out_dir, d) for d in DEMOS})
    stamp = _stamp(cflags, lflags, cc)
    stamp_path = os.path.join(out_dir, "stamp")
    with open(os.path.join(out_dir, "lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            with open(stamp_path) as fh:
                fresh = fh.read() == stamp and all(os.path.exists(p) for p in paths.values())
        except OSError:
            fresh = False
        if not fresh:
            defs = [f"-DTT_REPO_ROOT={json.dumps(REPO)}", f"-DTT_PYTHON={json.dumps(sys.executable)}"]
            _run([cc, "-O2", "-fPIC", "-Wall", "-shared"] + cflags + defs
                 + ["-o", paths["lib"], os.path.join(HERE, "tenstream_tpu_torch_capi.c")] + lflags)
            procs = [subprocess.Popen(
                [cc, "-O2", "-Wall", f"-I{HERE}", "-o", paths[d], os.path.join(HERE, d + ".c"),
                 f"-L{out_dir}", "-ltenstream_tpu_torch", "-Wl,-rpath,$ORIGIN"],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for d in DEMOS]
            for p in procs:
                log = p.communicate()[0]
                if p.returncode:
                    raise RuntimeError(f"building a C API demo failed:\n{log}")
            with open(stamp_path, "w") as fh:
                fh.write(stamp)
    return paths


def _run(cmd):
    p = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if p.returncode:
        raise RuntimeError(f"building the C API failed ({' '.join(cmd)}):\n{p.stdout}")


if __name__ == "__main__":
    print(json.dumps(build(), indent=1))
