"""Data parallelism: the rendezvous, the global-batch BatchNorm, the data
axis and the DDP wrap (the counterpart of ``udp_pose_tpu/parallel``).

The reference scales with DataParallel or DDP+NCCL (deep_hrnet/tools/
train.py:116, RSN/cvpack/.../engine.py:52-66); the JAX package with a
sharded mesh whose BatchNorm statistics span the global batch.  Here one
process drives one card under ``torchrun`` (NCCL), the step is wrapped
in DDP, and the BatchNorms all-reduce their statistics so that a step is
the JAX package's global-batch step.  The engines' ``mesh=`` drives
several local cards from one process.  ``TPU.PP`` pipelines a
multi-stage RSN over a model axis of ``STAGE_NUM`` devices a rank
(:mod:`.pipeline`); tensor parallelism (``TPU.TP``) over a model axis >
1 is not ported yet.
"""

from .batchnorm import GlobalBatchNorm2d, convert_batchnorm
from .mesh import (Mesh, broadcast_parameters, data_axis_size, data_parallel,
                   make_mesh, padded_rows, refuse_model_axis, replicate,
                   shard_rows)
from .multihost import (barrier, gather_eval_results, initialize, is_writer,
                        process_group, process_shard_info,
                        rendezvous_from_env)

__all__ = ["GlobalBatchNorm2d", "convert_batchnorm", "Mesh",
           "broadcast_parameters", "data_axis_size", "data_parallel",
           "make_mesh", "padded_rows", "refuse_model_axis",
           "replicate", "shard_rows", "barrier", "gather_eval_results",
           "initialize", "is_writer", "process_group", "process_shard_info",
           "rendezvous_from_env"]
