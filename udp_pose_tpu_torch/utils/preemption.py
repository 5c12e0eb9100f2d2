"""Preemption-safe training (port of ``udp_pose_tpu/utils/preemption.py``).

A machine that is about to be reclaimed (a spot instance, a maintenance
event, a scheduler's time limit) announces it with ``SIGTERM`` and a
short grace window.  The reference recovers only from its last epoch or
checkpoint period (deep_hrnet tools/train.py:169-179 AUTO_RESUME; RSN
engine.py:82-84 ``--continue``).  Here a signal handler sets a flag; the
train loops poll it after every step, save a checkpoint and return, and
``AUTO_RESUME`` then goes on exactly where the run stopped: the epoch's
batch plan is seeded by the epoch, so a mid-epoch resume rebuilds the
epoch's batches and throws away the prefix the run had taken, and RSN's
iteration loop resumes at the next iteration.

With more than one process, acting on a local flag would split the
processes (one leaves the step loop while the rest enter a collective
and wait): the flag is OR-reduced over the ``torch.distributed`` process
group, and callers act only on that, at a step every process reaches.
"""

from __future__ import annotations

import signal

import torch


class PreemptionGuard:
    """Installs a handler for ``signals`` (``SIGTERM``) that sets a flag;
    :meth:`should_stop` reports it.  Install it from the main thread, and
    :meth:`restore` the previous handlers when the run ends.

    One process: :meth:`should_stop` is the local flag (a bool read:
    poll it every step).  Several: call it with ``sync=True`` at a step
    every process reaches (a collective); calls with ``sync=False``
    return False, so that no process acts alone."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._flag = False
        self._prev = {}
        for s in signals:
            self._prev[s] = signal.signal(s, self._handle)

    def _handle(self, signum, frame):
        self._flag = True

    @property
    def preempted(self) -> bool:
        """This process's flag; informational only."""
        return self._flag

    def should_stop(self, num_shards: int = 1, sync: bool = True) -> bool:
        if num_shards <= 1:
            return self._flag
        if not sync:
            return False
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError(f"should_stop over {num_shards} processes "
                               "needs an initialised torch.distributed "
                               "process group")
        device = "cuda" if dist.get_backend() == "nccl" else "cpu"
        flag = torch.tensor([int(self._flag)], dtype=torch.int32,
                            device=device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())

    def restore(self):
        """Reinstall the previous handlers."""
        for s, h in self._prev.items():
            signal.signal(s, h)
        self._prev = {}
