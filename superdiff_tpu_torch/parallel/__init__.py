"""The parallel tier (port of ``superdiff_tpu/parallel``): a mesh of named
axes over ``torch.distributed`` ranks, data and ensemble placement,
Megatron tensor parallelism of the SD UNet, ring attention and the GPipe
schedule, every collective written out (NCCL on the card, gloo on the
CPU)."""

from . import distributed
from .mesh import (
    make_mesh,
    data_sharding,
    replicated,
    ensemble_sharding,
    shard_batch,
    local_mesh_for_testing,
)
from .pp import pipeline, pipeline_local
from .sp import ring_attention, ring_attention_local
from .tp import (make_ensemble_tp_mesh, make_tp_mesh, place_tp,
                 sd_tp_shardings, sd_tp_shardings_stacked)

__all__ = [
    "make_mesh",
    "data_sharding",
    "replicated",
    "ensemble_sharding",
    "shard_batch",
    "local_mesh_for_testing",
    "pipeline",
    "pipeline_local",
    "ring_attention",
    "ring_attention_local",
    "make_ensemble_tp_mesh",
    "make_tp_mesh",
    "place_tp",
    "sd_tp_shardings",
    "sd_tp_shardings_stacked",
]
