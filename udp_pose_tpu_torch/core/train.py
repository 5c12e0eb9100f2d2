"""Optimizer, LR schedule and train step (port of ``udp_pose_tpu/core/
train.py``).

Optimizer parity with the reference ``get_optimizer`` (deep_hrnet/lib/
utils/utils.py:60-76: adam takes only the LR, dropping WD; sgd is weight
decay, then momentum) and MultiStepLR (tools/train.py:181-184), stepped
once per train step at the epoch boundaries, as the JAX package's optax
schedule is.  Parameters stay float32; with ``TPU.DTYPE bfloat16`` the
forward runs under ``torch.autocast`` and the loss sees the float32 NCHW
output (the JAX package computes it on the float32 cast, :107).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Dict

import torch
from torch.profiler import record_function

from .infer import IMAGENET_MEAN, IMAGENET_STD, normalize_images


def multistep_lr(optimizer, lr_step_epochs, lr_factor, steps_per_epoch):
    """MultiStepLR over train steps: the LR is multiplied by ``lr_factor``
    from step ``e * steps_per_epoch`` on, for each ``e`` in
    ``lr_step_epochs`` (the JAX package's ``optax.
    piecewise_constant_schedule``: step ``k`` of the optimizer, counted
    from 0, runs at the LR of ``k`` scheduler steps)."""
    milestones = sorted({int(e) * int(steps_per_epoch)
                         for e in lr_step_epochs})
    return torch.optim.lr_scheduler.MultiStepLR(optimizer, milestones,
                                                gamma=lr_factor)


def make_optimizer(cfg, params, steps_per_epoch: int):
    """(optimizer, scheduler) of ``cfg.TRAIN`` over ``params``: adam at
    LR with no weight decay, or sgd with momentum, WD and nesterov."""
    params = list(params)
    if cfg.TRAIN.OPTIMIZER == "sgd":
        opt = torch.optim.SGD(params, lr=cfg.TRAIN.LR,
                              momentum=cfg.TRAIN.MOMENTUM,
                              weight_decay=cfg.TRAIN.WD,
                              nesterov=cfg.TRAIN.NESTEROV)
    elif cfg.TRAIN.OPTIMIZER == "adam":
        opt = torch.optim.Adam(params, lr=cfg.TRAIN.LR)
    else:
        raise ValueError(f"unknown TRAIN.OPTIMIZER {cfg.TRAIN.OPTIMIZER!r}: "
                         "'adam' or 'sgd'")
    return opt, multistep_lr(opt, cfg.TRAIN.LR_STEP, cfg.TRAIN.LR_FACTOR,
                             steps_per_epoch)


@dataclass
class TrainState:
    """The model with its float32 master weights and BN running stats,
    its optimizer and scheduler, and the number of steps taken.  Under
    data parallelism ``ddp`` is ``model`` wrapped by :func:`..parallel.
    data_parallel`, through which the step runs."""
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: Any
    step: int = 0
    ddp: Any = None


def step_forward(state: TrainState):
    """The module a train step calls: the DDP wrap where there is one."""
    return state.model if state.ddp is None else state.ddp


def global_means(state: TrainState, metrics):
    """``metrics``' scalar device tensors as means over the ranks under
    data parallelism (one all-reduce; each rank's loss is the mean over
    its rows, and every rank holds as many, so the mean of the ranks'
    is the global batch's); as they are otherwise."""
    if state.ddp is None:
        return metrics
    import torch.distributed as dist
    names = list(metrics)
    packed = torch.stack([metrics[k] for k in names])
    dist.all_reduce(packed, group=state.ddp.process_group)
    packed /= dist.get_world_size(state.ddp.process_group)
    return dict(zip(names, packed.unbind()))


def trained_model(cfg, model):
    """What a train state of ``model`` (from ``models.build_model(cfg,
    train=True)``) trains: with ``TPU.QAT int8`` a
    :class:`..models.quantize.FakeQuantModel` over ``model``'s own
    parameters and buffers (quantisation-aware training), so ``model``'s
    state dict is the trained one; else ``model``."""
    if cfg.TPU.QAT == "int8":
        from ..models.quantize import FakeQuantModel
        return FakeQuantModel(model)
    if cfg.TPU.QAT:
        raise ValueError(f"unknown TPU.QAT mode {cfg.TPU.QAT!r}")
    return model


def create_train_state(cfg, model, steps_per_epoch: int) -> TrainState:
    """The train state of :func:`trained_model` with ``cfg.TRAIN``'s
    optimizer and schedule."""
    model = trained_model(cfg, model)
    opt, sched = make_optimizer(cfg, model.parameters(), steps_per_epoch)
    return TrainState(model=model, optimizer=opt, scheduler=sched)


def upload_batch(batch, device, keys=("target", "target_weight"),
                 mean=IMAGENET_MEAN, std=IMAGENET_STD
                 ) -> Dict[str, torch.Tensor]:
    """A host batch of :func:`..data.base.collate` → the tensors the train
    step takes: uint8 images uploaded (a quarter of float32's bytes) and
    normalised on the device with ``mean`` and ``std``, and the arrays
    named in ``keys`` (targets and weights; RSN's ``labels`` and
    ``valid``), in the profiler range ``train/upload``."""
    with record_function("train/upload"):
        image = torch.as_tensor(batch["image"]).to(device)
        return {"image": normalize_images(image, mean, std),
                **{k: torch.as_tensor(batch[k]).to(device) for k in keys}}


def make_train_step(loss_fn, with_output: bool = False):
    """Build ``step(state, batch) -> metrics``.

    ``batch``: image (B, H, W, 3) float32 normalised, target (B, C, Ht,
    Wt), target_weight (B, J), on the model's device.  One forward in
    train mode (the model sees the NCHW view of the NHWC images, so
    channels-last), the loss on its float32 NCHW output, backward, an
    optimizer and a scheduler step.  Updates ``state`` in place; the
    metrics are device tensors (``loss`` and the loss's aux terms; with
    ``with_output`` also the NCHW output), read by the caller only when
    it needs them.  The phases run in ``torch.profiler`` ranges
    ``train/forward``, ``train/backward`` and ``train/optimizer``.  Under
    data parallelism (``state.ddp``) the forward runs through the DDP
    wrap, which averages the gradients over the ranks, and the loss
    metrics are the global batch's (:func:`global_means`); the output
    holds this rank's rows.
    """

    def step(state: TrainState, batch):
        model = state.model
        model.train()
        x = batch["image"].permute(0, 3, 1, 2)
        dtype = getattr(model, "dtype", torch.float32)
        ctx = (torch.autocast(x.device.type, dtype=dtype)
               if dtype != torch.float32 else contextlib.nullcontext())
        with record_function("train/forward"):
            with ctx:
                out = step_forward(state)(x)
            out = out.float()
            loss, aux = loss_fn(out, batch["target"], batch["target_weight"])
        state.optimizer.zero_grad(set_to_none=True)
        with record_function("train/backward"):
            loss.backward()
        with record_function("train/optimizer"):
            state.optimizer.step()
            state.scheduler.step()
        state.step += 1
        metrics = global_means(state, {
            "loss": loss.detach(), **{k: v.detach() for k, v in aux.items()}})
        if with_output:
            metrics["output"] = out.detach()
        return metrics

    return step
