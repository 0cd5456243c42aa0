"""The port's C API (the counterpart of the JAX package's `capi/`):
`tenstream_tpu_torch.h` declares it, `tenstream_tpu_torch_capi.c` embeds
CPython and calls `bridge.py`, `build.py` compiles the library and the
demos `demo_pprts.c` / `demo_specint.c` at first use."""
