"""JAX's persistent compilation cache for one run of the test suite.

Nearly all of a port parity test's time is XLA compiling its JAX reference,
and a program is compiled again wherever a test builds a new JAX solver,
driver or tracer with the same configuration: in another test of the file,
or in another file that a different pytest-xdist worker runs.  Importing
this module (the port's test files that call JAX do) points JAX's
persistent cache at a directory that the workers of one run share, keyed by
pytest-xdist's run id (by this process's id outside xdist), under the
system's temporary directory: each distinct program is compiled once per
run.  Every program is cached, however short its compile: the workers
compile the same small programs (eager operations on the same shapes, the
small jitted helpers) over and over, and the tier-1 run's summed test time
fell by about a tenth when they shared them too.  The cache holds compiled
executables only; every reference is still computed by the JAX package
inside the test, and nothing carries over between runs."""

import os
import tempfile

import jax

_RUN = os.environ.get("PYTEST_XDIST_TESTRUNUID") or f"pid{os.getpid()}"
CACHE_DIR = os.path.join(tempfile.gettempdir(), f"tenstream-tests-jax-cache-{_RUN}")

jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
