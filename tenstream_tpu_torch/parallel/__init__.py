"""Domain decomposition over a `torch.distributed` process group (port of
`tenstream_tpu/parallel/`)."""

from tenstream_tpu_torch.parallel.mesh import (  # noqa: F401
    GhostExchange,
    Mesh,
    cell_partition,
    gather_to_host,
    init_distributed,
    make_mesh,
    scatter_global,
    shard_fields,
)
