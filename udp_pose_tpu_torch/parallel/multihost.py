"""The rendezvous and the collectives of a data-parallel run (port of
``udp_pose_tpu/parallel/multihost.py``).

One process drives one card, as ``torchrun`` starts them.  The process
group is described by torchrun's variables (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``)
or by the JAX CLIs' contract (``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``,
``JAX_COORDINATOR`` as ``host:port``), so that a launch script written
for the JAX package carries over.  On the card the backend is NCCL and
the process's card is ``cuda:LOCAL_RANK``; gloo only when the caller
asked for the CPU.  Nothing falls back: a failed rendezvous raises, and
so do more local ranks than visible cards (NCCL refuses two ranks on one
card).
"""

from __future__ import annotations

import contextlib
import os
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..utils.platform import resolve_device


class Rendezvous(NamedTuple):
    """Where this process sits in the group, and how to reach it."""
    rank: int
    world: int
    local_rank: int
    local_world: int
    init_method: Optional[str]      # tcp://host:port, or None when unset


def rendezvous_from_env(environ=None) -> Optional[Rendezvous]:
    """The group the environment describes (torchrun's variables first,
    then the JAX CLIs'), or None for a plain single-process run."""
    env = os.environ if environ is None else environ
    if "RANK" in env and "WORLD_SIZE" in env:
        world = int(env["WORLD_SIZE"])
        local_rank = int(env.get("LOCAL_RANK", "0"))
        port = env.get("MASTER_PORT")
        return Rendezvous(
            int(env["RANK"]), world, local_rank,
            int(env.get("LOCAL_WORLD_SIZE", str(local_rank + 1))),
            f"tcp://{env.get('MASTER_ADDR', 'localhost')}:{port}"
            if port else None)
    n = int(env.get("JAX_NUM_PROCESSES", "1") or "1")
    if n > 1:
        # the JAX contract runs one process per host
        return Rendezvous(
            int(env.get("JAX_PROCESS_ID", "0") or "0"), n,
            int(env.get("LOCAL_RANK", "0")),
            int(env.get("LOCAL_WORLD_SIZE", "1")),
            f"tcp://{env.get('JAX_COORDINATOR', 'localhost:12321')}")
    if env.get("JAX_MULTIHOST"):
        raise RuntimeError("JAX_MULTIHOST asks for TPU metadata "
                           "autodetection; on cards give JAX_NUM_PROCESSES, "
                           "JAX_PROCESS_ID and JAX_COORDINATOR, or launch "
                           "with torchrun")
    return None


def initialize(device="cuda", environ=None, init_method=None):
    """Join the process group the environment describes and return this
    process's device (``cuda:LOCAL_RANK``, made the current card; the CPU
    when ``device`` is the CPU), or None when the environment describes
    no group.  ``init_method`` replaces the address the environment gives
    (a test's ``file://`` rendezvous)."""
    rdv = rendezvous_from_env(environ)
    if rdv is None:
        return None
    init_method = init_method or rdv.init_method
    if init_method is None:
        raise RuntimeError("RANK and WORLD_SIZE are set but MASTER_PORT is "
                           "not: no address to meet the other ranks at")
    if not 0 <= rdv.rank < rdv.world or rdv.local_rank >= rdv.local_world:
        raise ValueError(f"rank {rdv.rank} of {rdv.world}, local rank "
                         f"{rdv.local_rank} of {rdv.local_world}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        if rdv.local_world > cards:
            raise RuntimeError(
                f"{rdv.local_world} ranks on this host but {cards} visible "
                "card(s): NCCL takes one card a rank")
        dev = torch.device("cuda", rdv.local_rank)
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", init_method=init_method,
                                world_size=rdv.world, rank=rdv.rank,
                                device_id=dev)
    else:
        dist.init_process_group("gloo", init_method=init_method,
                                world_size=rdv.world, rank=rdv.rank)
    return dev


@contextlib.contextmanager
def process_group(device="cuda"):
    """:func:`initialize` for the length of a ``with`` block, which gets
    the process's device (None without a group); the group is destroyed
    as the block ends."""
    dev = initialize(device)
    try:
        yield dev
    finally:
        if dev is not None:
            dist.destroy_process_group()


def process_shard_info():
    """(shard_index, num_shards): this process's rank and the world size,
    (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_writer() -> bool:
    """Whether this process writes the run's files (rank 0)."""
    return process_shard_info()[0] == 0


def collective_device() -> torch.device:
    """Where this process's collectives take their tensors: its card for
    NCCL, the CPU for gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier():
    """Wait for every rank (nothing without a process group)."""
    if process_shard_info()[1] > 1:
        dev = collective_device()
        dist.barrier(device_ids=[dev.index] if dev.type == "cuda" else None)


def gather_eval_results(x: np.ndarray) -> np.ndarray:
    """All-gather of one host array of this rank's eval results: (world,
    *x.shape), rank-major (the JAX ``process_allgather``; the reference's
    pickled all_gather, RSN/lib/utils/comm.py:47-87).  Every rank passes
    the same shape; the array travels through the collective's device
    (the card under NCCL)."""
    t = torch.from_numpy(np.ascontiguousarray(x)).to(collective_device())
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return torch.stack(parts).cpu().numpy()
