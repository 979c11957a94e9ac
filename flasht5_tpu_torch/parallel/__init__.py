"""Training across ranks: meshes, sharding rules, the data-, tensor- and
pipeline-parallel steps, on `torch.distributed`.

The counterpart of `flasht5_tpu/parallel/`: one process a card, the
default process group joined first (`distributed.initialize_multihost`),
a `DeviceMesh` where the JAX package has mesh axes, collectives placed by
hand where GSPMD and `shard_map` place them there (NCCL between cards,
gloo between CPU processes).
"""

from flasht5_tpu_torch.parallel.mesh import make_mesh, make_pp_mesh, use_mesh
from flasht5_tpu_torch.parallel.sharding import (gather_params, param_pspecs,
                                                 shard_params)
from flasht5_tpu_torch.parallel.train_step import (make_train_step,
                                                   sharded_train_step)

__all__ = [
    "make_mesh",
    "make_pp_mesh",
    "use_mesh",
    "param_pspecs",
    "shard_params",
    "gather_params",
    "make_train_step",
    "sharded_train_step",
]
