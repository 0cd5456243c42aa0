"""Full-spectrum integration (port of `tenstream_tpu/spectral/`)."""

from tenstream_tpu_torch.spectral.specint import specint_pprts  # noqa: F401
