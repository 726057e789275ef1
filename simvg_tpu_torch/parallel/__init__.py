"""Multi-process training and evaluation (``--distributed``): the mesh,
the parameter layout and the data-axis sums (``mesh.py``)."""

from .mesh import (FSDP_MIN_SIZE, SeqShard, Sharded, create_mesh,
                   full_tensor, init_distributed, local,
                   param_partition_spec, shard_model, shard_of)

__all__ = ["FSDP_MIN_SIZE", "SeqShard", "Sharded", "create_mesh",
           "full_tensor", "init_distributed", "local",
           "param_partition_spec", "shard_model", "shard_of"]
