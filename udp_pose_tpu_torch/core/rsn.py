"""RSN's schedule, optimizer, train step and inference graph.

Port of ``udp_pose_tpu/core/rsn.py`` (parity: RSN/exps/*/train.py, the
iteration loop and its warmup-linear-decay LR :76; solver.py:8-31, Adam
with weight decay and the LambdaLR; test.py:74-116, the flip test and
``get_results``).  The step is the port's train step (float32 masters,
the compute dtype under ``torch.autocast``) with RSN's inputs: the BGR
images normalised with RSN's BGR constants, the stage outputs, the
five-kernel label pyramid and the visibility.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import torch
from torch.profiler import record_function

from ..ops.rsn_decode import rsn_decode
from .infer import RSN_BGR_MEAN, RSN_BGR_STD, make_infer_fn
from .loss import rsn_multi_stage_loss
from .train import TrainState, global_means, step_forward, trained_model

# what an RSN train step reads of a batch besides the image
RSN_BATCH_KEYS = ("labels", "valid")


def warmup_linear_decay(base_lr, warmup_iters, max_iters,
                        warmup_factor=0.1):
    """RSN solver.py:22-31: the LR at step ``k`` (counted from 0) rises
    linearly from ``warmup_factor · base_lr`` over ``warmup_iters`` steps,
    then falls linearly to 0 at ``max_iters`` and stays there (also when
    the warmup ends at ``max_iters``, as in one epoch of epoch mode,
    where the JAX expression divides 0 by 0 at the step after the
    last)."""
    def factor(step):
        if step < warmup_iters:
            return warmup_factor + (1 - warmup_factor) * step / warmup_iters
        if step >= max_iters:
            return 0.0
        return 1.0 - (step - warmup_iters) / float(max_iters - warmup_iters)

    def sched(step):
        return base_lr * factor(step)

    sched.factor = factor
    return sched


def make_rsn_optimizer(params, base_lr, weight_decay, max_iters,
                       warmup_iters=1000):
    """(optimizer, scheduler): Adam with ``weight_decay`` added to the
    gradient (RSN solver.py:8-19; the JAX package's ``add_decayed_weights``
    then ``adam``, so L2, not AdamW), its LR a ``LambdaLR`` of
    :func:`warmup_linear_decay` stepped once a train step: step ``k``
    runs at the schedule's value at ``k``, as optax evaluates it at the
    update count before the update."""
    opt = torch.optim.Adam(list(params), lr=base_lr,
                           weight_decay=weight_decay)
    factor = warmup_linear_decay(base_lr, warmup_iters, max_iters).factor
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, factor)


def create_rsn_train_state(cfg, model, base_lr, max_iters,
                           warmup_iters) -> TrainState:
    """The train state of an RSN from ``models.build_model(cfg,
    train=True)`` (QAT as :func:`.train.trained_model`) with
    :func:`make_rsn_optimizer`."""
    model = trained_model(cfg, model)
    opt, sched = make_rsn_optimizer(model.parameters(), base_lr,
                                    cfg.TRAIN.WD, max_iters, warmup_iters)
    return TrainState(model=model, optimizer=opt, scheduler=sched)


def upload_rsn_batch(batch, device):
    """A host batch of the RSN datasets → the step's tensors: the u8 BGR
    images normalised on the device with RSN's constants, the labels and
    the visibility (:func:`.train.upload_batch`)."""
    from .train import upload_batch
    return upload_batch(batch, device, RSN_BATCH_KEYS, RSN_BGR_MEAN,
                        RSN_BGR_STD)


def make_rsn_train_step(stage_num: int, ohkm=True, topk=8,
                        coarse_to_fine=True):
    """Build ``step(state, batch) -> metrics``.  ``batch``: image (B, H,
    W, 3) float32 normalised, labels (B, 5, J, h, w), valid (B, J, 1), on
    the model's device.  One forward in train mode (every stage's four
    outputs, at least float32 for the loss), :func:`..core.loss.
    rsn_multi_stage_loss`, backward, an optimizer and a scheduler step;
    ``state`` is updated in place and ``metrics["loss"]`` is a device
    tensor.  Profiler ranges and data parallelism as in
    :func:`.train.make_train_step`."""

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
            outputs = [[o.to(torch.promote_types(o.dtype, torch.float32))
                        for o in stage] for stage in out]
            loss = rsn_multi_stage_loss(outputs, batch["valid"],
                                        batch["labels"], stage_num,
                                        ohkm=ohkm, topk=topk,
                                        coarse_to_fine=coarse_to_fine)
        state.optimizer.zero_grad(set_to_none=True)
        with record_function("train/backward"):
            loss.backward()
        with record_function("train/optimizer"):
            state.optimizer.step()
            state.scheduler.step()
        state.step += 1
        return global_means(state, {"loss": loss.detach()})

    return step


def make_rsn_infer_fn(model, *, flip_test=True, flip_pairs: Sequence,
                      kernel=5, shifts=(0.25,), input_size_hw=(256, 192),
                      flip_mode="fold"):
    """Build ``infer(images, center, scale) -> (preds, maxvals, hm)``:
    :func:`.infer.make_infer_fn` on (B, H, W, 3) u8 BGR crops normalised
    with RSN's constants, the flip un-done with :func:`..ops.flip.
    flip_back`, and :func:`..ops.rsn_decode.rsn_decode` as the decode
    (RSN test.py:74-116)."""
    def decode(hm, center, scale):
        return rsn_decode(hm, center, scale, kernel=kernel, shifts=shifts,
                          input_size_hw=input_size_hw)

    return make_infer_fn(model, flip_test=flip_test, flip_pairs=flip_pairs,
                         flip_mode=flip_mode, mean=RSN_BGR_MEAN,
                         std=RSN_BGR_STD, decode=decode)


def make_rsn_infer_fn_from_cfg(model, cfg, flip_pairs, flip_test=None):
    """:func:`make_rsn_infer_fn` with the test kernel and shifts of the
    dataset (``RSN_MPII`` for MPII, else ``RSN_COCO``), the input size
    and flip options of ``cfg`` (``udp_pose_tpu/core/validate.py:43-53``);
    ``flip_test``, where given, overrides ``TEST.FLIP_TEST``."""
    from ..data.rsn import RSN_COCO, RSN_MPII
    attr = RSN_MPII if cfg.DATASET.DATASET == "mpii" else RSN_COCO
    w, h = cfg.MODEL.IMAGE_SIZE
    return make_rsn_infer_fn(
        model, flip_test=(cfg.TEST.FLIP_TEST if flip_test is None
                          else flip_test), flip_pairs=flip_pairs,
        kernel=attr["test_gaussian_kernel"],
        shifts=tuple(attr["test_shift_ratios"]), input_size_hw=(h, w),
        flip_mode=cfg.TEST.get("FLIP_MODE", "fold"))
