"""Ranks as a ("data", "model") mesh, the correspondence split over
ranks, and the B-clip batched step."""

from devc_tpu_torch.parallel.mesh import (
    data_sharding,
    make_mesh,
    replicated,
    shard_batch,
)
