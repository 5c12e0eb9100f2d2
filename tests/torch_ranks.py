"""Spawned ranks for the port's data-parallel CPU tests.

:class:`Ranks` starts ``world`` processes with ``spawn``, joins them
in a gloo group over a ``file://`` rendezvous in the test's temporary
directory (no TCP port, so parallel test workers cannot clash), runs one
of the scenario functions below in each and returns their results in
rank order.  This module imports torch and the port only: a rank starts
without JAX.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import time
import traceback
import uuid

import torch


class Ranks:
    """``fn(rank, world, tmp, *args)`` started in ``world`` spawned
    processes, joined in a gloo group (``group`` False: one process and no
    group, the plain single-process run); :meth:`results` waits for
    them."""

    def __init__(self, fn, world, tmp, *args, group=True):
        self.tmp, self.tag = str(tmp), uuid.uuid4().hex[:8]
        ctx = mp.get_context("spawn")
        self.procs = [ctx.Process(target=_rank, args=(
            fn, r, world, self.tmp, self.tag, args, group))
            for r in range(world)]
        for p in self.procs:
            p.start()

    def results(self, timeout=180.0):
        """Their return values in rank order.  A rank that fails fails
        the call with its traceback (the others are terminated); so does
        the timeout."""
        deadline = time.monotonic() + timeout
        try:
            while any(p.is_alive() for p in self.procs):
                if (any(p.exitcode not in (None, 0) for p in self.procs)
                        or time.monotonic() > deadline):
                    break
                time.sleep(0.05)
        finally:
            for p in self.procs:
                if p.is_alive():
                    p.terminate()
                p.join(timeout=30)
        errors = []
        for r, p in enumerate(self.procs):
            err = os.path.join(self.tmp, f"{self.tag}-rank{r}.err")
            if os.path.exists(err):
                with open(err) as f:
                    errors.append(f"rank {r}:\n{f.read()}")
            elif p.exitcode != 0:
                errors.append(f"rank {r}: exit code {p.exitcode}")
        if errors:
            raise RuntimeError("\n".join(errors))
        return [torch.load(os.path.join(self.tmp, f"{self.tag}-rank{r}.pt"),
                           weights_only=False)
                for r in range(len(self.procs))]


def _rank(fn, rank, world, tmp, tag, args, group):
    import torch.distributed as dist

    from udp_pose_tpu_torch.parallel import initialize
    torch.set_num_threads(1)
    # a spawned process defaults to spawning its own children; a rank
    # that torchrun starts forks its loader's workers
    mp.set_start_method("fork", force=True)
    try:
        if group:
            initialize("cpu", {"RANK": str(rank), "WORLD_SIZE": str(world),
                               "LOCAL_RANK": str(rank),
                               "LOCAL_WORLD_SIZE": str(world)},
                       init_method=f"file://{tmp}/{tag}-rdzv")
        try:
            result = fn(rank, world, tmp, *args)
        finally:
            if group:
                dist.destroy_process_group()
        torch.save(result, os.path.join(tmp, f"{tag}-rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmp, f"{tag}-rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


# ------------------------------------------------------------- scenarios
def batchnorm_halves(rank, world, tmp, x, dy, weight, bias):
    """A :class:`GlobalBatchNorm2d` in train mode on this rank's rows of
    the float64 NCHW ``x``, backward of ``sum(out · dy)``: (out, dx,
    dweight, dbias, running_mean, running_var)."""
    from udp_pose_tpu_torch.parallel import GlobalBatchNorm2d
    rows = slice(rank * len(x) // world, (rank + 1) * len(x) // world)
    bn = GlobalBatchNorm2d(x.shape[1]).double().train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
    xr = torch.from_numpy(x[rows]).requires_grad_(True)
    out = bn(xr)
    (out * torch.from_numpy(dy[rows])).sum().backward()
    return [t.detach().numpy() for t in (out, xr.grad, bn.weight.grad,
                                         bn.bias.grad, bn.running_mean,
                                         bn.running_var)]


def hrnet_step(rank, world, tmp, cfg, state_dict, batch):
    """One data-parallel float64 train step of the model of ``cfg`` from
    ``state_dict`` on this rank's rows of ``batch``: (global loss, state
    dict after the step)."""
    from udp_pose_tpu_torch.core.loss import make_loss_fn
    from udp_pose_tpu_torch.core.train import (create_train_state,
                                               make_train_step)
    from udp_pose_tpu_torch.models import build_model
    from udp_pose_tpu_torch.parallel import data_parallel
    model = build_model(cfg, device="cpu", train=True).double()
    model.load_state_dict(state_dict)
    state = create_train_state(cfg, model, steps_per_epoch=10)
    state.ddp = data_parallel(state.model)
    n = len(batch["image"]) // world
    rows = {k: torch.from_numpy(v[rank * n:(rank + 1) * n]).double()
            for k, v in batch.items()}
    metrics = make_train_step(make_loss_fn(cfg))(state, rows)
    return float(metrics["loss"]), {k: v.numpy() for k, v in
                                    model.state_dict().items()}


def device_aug_rows(rank, world, tmp, cfg, batch, epoch=1, step=2):
    """Step ``step`` of epoch ``epoch`` of ``DATASET.DEVICE_AUG`` on this
    rank's rows of the raw ``batch`` (the global one), with the draws the
    trainer makes (``step_draws`` over the global batch, the rank and
    world of ``process_shard_info``): (crops, target, weight) in numpy."""
    from udp_pose_tpu_torch.data import device_pipeline as dp
    from udp_pose_tpu_torch.parallel import process_shard_info
    shard, shards = process_shard_info()
    assert (shard, shards) == (rank, world if shards > 1 else 1)
    pairs = [[1, 2], [3, 4], [5, 6], [7, 8], [9, 10], [11, 12], [13, 14],
             [15, 16]]
    canvas_hw = batch["canvas"].shape[1:3]
    aug = dp.make_device_augment(cfg, 17, pairs, tuple(range(11)),
                                 canvas_hw)
    n = len(batch["canvas"]) // shards
    rows = {k: v[shard * n:(shard + 1) * n] for k, v in batch.items()}
    draws = dp.step_draws(aug, epoch, step, len(batch["canvas"]), "cpu",
                          shard, shards)
    return [t.numpy() for t in aug(dp.upload_raw(rows, "cpu"), draws)]


class FlagAt:
    """A guard flagged from its ``at``-th poll on (0: never), polled the
    way ``train.run`` polls a ``PreemptionGuard``."""

    def __init__(self, at):
        from udp_pose_tpu_torch.utils.preemption import PreemptionGuard
        self.guard, self.at, self.polls = PreemptionGuard(signals=()), at, 0

    def should_stop(self, num_shards=1, sync=True):
        self.polls += 1
        if self.at and self.polls >= self.at:
            self.guard._flag = True
        return self.guard.should_stop(num_shards, sync)


def train_run(rank, world, tmp, cfg, flag_at=0):
    """``train.run`` of a fresh seeded model of ``cfg`` on this rank, its
    files under ``<tmp>/rank<rank>``, the guard on rank 1 flagged from its
    ``flag_at``-th poll: (record, state dict before and after the run,
    the files it left).
    The loader's workers fork, as the trainer's do (no JAX here).  The
    train model computes in float64."""
    from udp_pose_tpu_torch import train as train_cli
    from udp_pose_tpu_torch.data import build_dataset
    from udp_pose_tpu_torch.models import build_model
    out = os.path.join(tmp, f"rank{rank}" if world > 1 else "alone")
    os.makedirs(out, exist_ok=True)
    # float64 weights and activations (the loss stays float32): in float32
    # this small net at 2 rows a rank amplifies rounding step by step, so
    # a run's order of sums would decide its weights after a few steps
    torch.set_default_dtype(torch.float64)
    model = build_model(cfg, device="cpu", train=True)
    model.register_forward_pre_hook(
        lambda module, args: tuple(a.double() for a in args))
    init = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    record = train_cli.run(
        cfg, model, build_dataset(cfg, is_train=True),
        build_dataset(cfg, is_train=False), out, "cpu",
        guard=FlagAt(flag_at if rank == 1 else 0))
    sd = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    return record, init, sd, sorted(_files(out))


def eval_run(rank, world, tmp, cfg, weights):
    """``test.run`` of ``weights`` on this rank's shard: (name_values,
    perf)."""
    from udp_pose_tpu_torch import test as test_cli
    from udp_pose_tpu_torch.data import build_dataset
    out = os.path.join(tmp, f"test-rank{rank}")
    os.makedirs(out, exist_ok=True)
    return test_cli.run(cfg, weights, build_dataset(cfg, is_train=False),
                        out, "cpu")


def _files(root):
    for d, _, names in os.walk(root):
        for n in names:
            yield os.path.relpath(os.path.join(d, n), root)

