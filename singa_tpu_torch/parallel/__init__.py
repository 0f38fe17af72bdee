"""singa_tpu_torch.parallel — the 1-D data-parallel mesh, its
collectives and the multi-process bootstrap, ported from
``singa_tpu/parallel`` over ``torch.distributed`` (NCCL on the card,
gloo on the CPU).

The reference's ``pipeline``, ``planner`` (``plan_train_step``) and the
sharding rules of ``spmd`` drive its GSPMD path over multi-axis meshes
(tensor, sequence, expert and pipeline parallelism); they come with the
next distribution slice.
"""

from . import mesh
from . import communicator
from . import distributed
from . import spmd
from .mesh import (make_mesh, set_mesh, current_mesh, data_parallel_mesh,
                   mesh_shape)
from .distributed import (init_distributed, finalize_distributed,
                          global_mesh, local_batch)

__all__ = ["mesh", "communicator", "distributed", "spmd",
           "make_mesh", "set_mesh", "current_mesh", "data_parallel_mesh",
           "mesh_shape", "init_distributed", "finalize_distributed",
           "global_mesh", "local_batch"]
