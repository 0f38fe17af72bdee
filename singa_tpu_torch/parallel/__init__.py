"""singa_tpu_torch.parallel — the device mesh and its collectives, the
multi-process bootstrap, the sharding rules, tensor parallelism, the
pipeline schedule and the memory planner, ported from
``singa_tpu/parallel`` over ``torch.distributed`` (NCCL on the card,
gloo on the CPU).

A mesh has any of the reference's axes: ``data``, ``model`` (Megatron
layers), ``seq`` (ring attention), ``pipe`` (``pipeline``,
``layer.PipelineStack``) and ``expert`` (``layer.MoE``'s experts cut by
its rules).  ``planner.plan_train_step`` plans a model's per-device
bytes on a mesh of any size without allocating.
"""

from . import mesh
from . import communicator
from . import distributed
from . import spmd
from . import pipeline
from . import planner
from .mesh import (make_mesh, set_mesh, current_mesh, data_parallel_mesh,
                   mesh_shape, pipeline_mesh)
from .distributed import (init_distributed, finalize_distributed,
                          global_mesh, local_batch)
from .planner import plan_train_step

__all__ = ["mesh", "communicator", "distributed", "spmd", "pipeline",
           "planner", "make_mesh", "set_mesh", "current_mesh",
           "data_parallel_mesh", "mesh_shape", "pipeline_mesh",
           "init_distributed", "finalize_distributed", "global_mesh",
           "local_batch", "plan_train_step"]
