"""The data axis, row sharding and the data-parallel wrap (port of
``udp_pose_tpu/parallel/mesh.py``).

The JAX package's mesh is ``('data', 'model')`` over devices; a step
sharded over ``data`` replicates the parameters and splits the batch.
Here the trainer's and the evaluator's data axis is the world of a
``torch.distributed`` group (one process a card,
:func:`.multihost.process_shard_info`), and a :class:`Mesh` is the local
cards one serving process drives (the engines' ``mesh=``).  The model
axis is 1: pipeline and tensor parallelism (``TPU.PP``, ``TPU.TP``) are
not ported yet.
"""

from __future__ import annotations

import copy
import itertools
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.distributed as dist

from ..utils.platform import resolve_device
from .multihost import process_shard_info


@dataclass(frozen=True)
class Mesh:
    """The data axis of an engine: the local cards one process drives,
    one a member."""
    devices: Tuple[torch.device, ...]
    size: int


def make_mesh(devices) -> Mesh:
    """The data axis over ``devices``, an engine's local cards (e.g.
    ``["cuda:0", "cuda:1"]``)."""
    devs = tuple(resolve_device(d) for d in devices)
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return Mesh(devs, len(devs))


def data_axis_size(cfg) -> int:
    """The data-parallel width a run of ``cfg`` trains at, the world size
    of the process group (1 without one): ``TPU.MESH.DATA`` is -1 or
    that size; ``TPU.MESH.MODEL`` > 1 (pipeline or tensor parallelism)
    is not ported yet."""
    world = process_shard_info()[1]
    if cfg.TPU.MESH.MODEL > 1:
        raise NotImplementedError(
            f"TPU.MESH.MODEL {cfg.TPU.MESH.MODEL}: the model axis (TPU.PP "
            "pipeline parallelism, TPU.TP tensor parallelism) is not "
            "ported yet")
    if cfg.TPU.MESH.DATA not in (-1, world):
        raise ValueError(f"TPU.MESH.DATA {cfg.TPU.MESH.DATA}: this run has "
                         f"{world} rank(s); give -1 or {world}")
    return world


def padded_rows(n: int, count: int) -> int:
    """``n`` rounded up to a multiple of ``count``."""
    return -(-n // count) * count


def shard_rows(n: int, index: int, count: int) -> slice:
    """Member ``index``'s contiguous rows of ``n`` split over ``count``
    (``n`` a multiple of ``count``): the JAX batch sharding's split."""
    if n % count:
        raise ValueError(f"{n} rows do not split over {count}")
    per = n // count
    return slice(index * per, (index + 1) * per)


def replicate(module: torch.nn.Module, device) -> torch.nn.Module:
    """A copy of ``module`` on ``device`` with its own tensors (an int8
    model's packed weights with the rest; its launch plans, which hold
    the original's addresses, start empty): an engine's replica on one
    card of its mesh."""
    copy_ = copy.deepcopy(module).to(device)
    for m in copy_.modules():
        if hasattr(m, "launch_plans"):
            m.launch_plans = {}
    return copy_


def broadcast_parameters(module: torch.nn.Module, src: int = 0,
                         group=None):
    """Every rank's parameters and buffers set to rank ``src``'s, so that
    all start from one initialisation (the JAX package replicates one
    init)."""
    for t in itertools.chain(module.parameters(), module.buffers()):
        dist.broadcast(t.data, src, group=group)


def data_parallel(model: torch.nn.Module, group=None):
    """``model`` for a data-parallel step: its BatchNorms converted to the
    global batch's (:func:`.batchnorm.convert_batchnorm`, in place), its
    tensors broadcast from rank 0, wrapped in
    ``DistributedDataParallel`` (gradients averaged over the ranks).
    Buffers are not broadcast each step: the global statistics keep every
    rank's running stats equal.  Every parameter of the ported models
    takes a gradient each step, so unused parameters are not searched."""
    from torch.nn.parallel import DistributedDataParallel

    from ..models.quantize import FakeQuantConv2d
    from .batchnorm import convert_batchnorm
    convert_batchnorm(model, group)
    for m in model.modules():
        if isinstance(m, FakeQuantConv2d):
            # QAT's dynamic activation grid: the global batch's amax
            m.amax_group = dist.group.WORLD if group is None else group
    broadcast_parameters(model, group=group)
    device = next(model.parameters()).device
    return DistributedDataParallel(
        model, device_ids=[device.index] if device.type == "cuda" else None,
        broadcast_buffers=False, init_sync=False, process_group=group)

