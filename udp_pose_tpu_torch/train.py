"""Training entry point of the PyTorch port (port of ``tools/train.py``
for every ported model and dataset, in epoch mode and in RSN's iteration
mode):

    python -m udp_pose_tpu_torch.train --cfg <experiment.yaml> \
        [--device cpu] [KEY VALUE ...]

Each epoch runs the train steps (train-time PCK at ``PRINT_FREQ``, but
for RSN), the flip-test validation of :mod:`.core.validate`, then rolls
the checkpoint ``checkpoint.pth`` and writes ``model_best.pth`` when the
AP improved; ``final_state.pth`` follows the last epoch.  An RSN with
``TRAIN.MAX_ITER`` > 0 trains for iterations instead (:func:`run`),
writing ``iter-<N>.pth`` and ``iter-last.pth`` every checkpoint period,
and validates once at the end.  ``AUTO_RESUME`` goes on from the rolling
checkpoint (``iter-last.pth`` in iteration mode), also from one saved
in the middle of an epoch when ``SIGTERM`` stopped the run
(:mod:`.utils.preemption`); ``TPU.CKPT_BACKEND orbax`` rolls the
checkpoint asynchronously with retention (:mod:`.utils.orbax_ckpt`);
``MODEL.PRETRAINED`` grafts a partial ``.pth`` or ``.msgpack`` onto the
fresh model (:mod:`.utils.checkpoint`); ``DEBUG.DEBUG`` writes debug
images (:mod:`.utils.vis`); ``DATASET.DEVICE_AUG`` moves the crop, the
augmentation and the targets onto the card (:mod:`.data.
device_pipeline`); ``TRAIN.RESUME``, which the JAX trainer
reads nowhere, is ignored.  The weights are torch state dicts in the
reference key names, which ``UdpPosePipeline(cfg, weights=...)`` and
``serve --weights`` load with ``strict=True``.  Runs on the card unless
given ``--device cpu``.

Under ``torchrun`` (or the JAX CLIs' ``JAX_NUM_PROCESSES``,
``JAX_PROCESS_ID``, ``JAX_COORDINATOR``) every process trains on its own
card, NCCL between them (gloo with ``--device cpu``)::

    torchrun --nproc_per_node N -m udp_pose_tpu_torch.train --cfg <yaml>

The global batch is ``TRAIN.BATCH_SIZE_PER_GPU`` × N, each rank loads
its shard of it, the BatchNorm statistics are the global batch's and
the gradients are averaged (:mod:`.parallel`), so the run follows the
JAX package's sharded step; rank 0 alone logs and writes files.

``TPU.PP True TPU.MESH.MODEL <STAGE_NUM>`` on a multi-stage RSN trains
its stages as a GPipe pipeline over ``STAGE_NUM`` cards a process
(:mod:`.parallel.pipeline`, ``TPU.PP_MICROBATCHES`` microbatches), stage
``s`` of rank ``r`` on ``cuda:local_rank·STAGE_NUM + s``; the weights
and checkpoints keep the plain RSN's keys::

    python -m udp_pose_tpu_torch.train --cfg configs/coco/4xrsn50_384x288.yaml \
        TPU.PP True TPU.MESH.MODEL 4 TPU.PP_MICROBATCHES 4
    torchrun --nproc_per_node 2 -m udp_pose_tpu_torch.train --cfg <yaml> \
        TPU.PP True TPU.MESH.MODEL 4        # 8 cards: 2 data × 4 stages

The host needs that many cards; :func:`run` takes ``model_devices=``
(``["cuda:0"] * 4``: every stage on one card).
"""

from __future__ import annotations

import argparse
import logging
import os
import time
from typing import NamedTuple

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

def check_parallel_config(cfg):
    """The JAX trainer's guards on ``TPU.PP``, ``TPU.TP`` and the model
    axis.  ``TPU.QAT int8`` with ``TPU.PP`` raises ``ValueError`` whatever
    the mesh (``tools/train.py:81-88``).  On a ``TPU.MESH.MODEL`` > 1,
    ``TPU.PP`` on an RSN pipelines its stages (the model axis must equal
    ``STAGE_NUM``, else ``ValueError``), ``TPU.PP`` with ``TPU.TP`` there
    raises ``ValueError`` and ``TPU.TP`` ``NotImplementedError``
    (:func:`.parallel.mesh.refuse_model_axis`); any other model trains
    the plain step, as the JAX trainer, which sets its pipelined step
    only for RSN (``:181``).  On a model axis of 1 the JAX trainer takes
    neither the pipelined step nor the tensor-parallel sharding (``:181``,
    ``:213``) and trains the plain step, and so does the port."""
    from .parallel import refuse_model_axis
    from .parallel.pipeline import stage_count, uses_pipeline
    if cfg.TPU.QAT == "int8" and cfg.TPU.PP:
        # the JAX pipeline stages bypass the fake-quant wrapper: training
        # would run in full precision while claiming QAT
        raise ValueError("TPU.QAT is not supported together with TPU.PP "
                         "(the pipeline stages bypass the fake-quant "
                         "wrapper); train QAT with dp/tp sharding instead")
    refuse_model_axis(cfg)
    if uses_pipeline(cfg):
        stage_count(cfg)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train a keypoint network "
                                            "(PyTorch port)")
    p.add_argument("--cfg", required=True, type=str)
    p.add_argument("--modelDir", type=str, default="")
    p.add_argument("--logDir", type=str, default="")
    p.add_argument("--dataDir", type=str, default="")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    p.add_argument("opts", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def set_cudnn(cfg):
    """The reference's cuDNN switches (tools/train.py:87-89)."""
    torch.backends.cudnn.benchmark = cfg.CUDNN.BENCHMARK
    torch.backends.cudnn.deterministic = cfg.CUDNN.DETERMINISTIC
    torch.backends.cudnn.enabled = cfg.CUDNN.ENABLED


def main(argv=None):
    args = parse_args(argv)
    from .config import default_config, update_config
    from .parallel import is_writer, process_group
    from .utils.platform import resolve_device
    device = resolve_device(args.device)
    cfg = default_config()
    update_config(cfg, args)
    check_parallel_config(cfg)
    # torchrun's (or the JAX CLIs') variables: join the process group,
    # on the first card of this process's local rank (TPU.MESH.MODEL
    # cards a rank)
    with process_group(args.device,
                       cards_per_rank=max(cfg.TPU.MESH.MODEL, 1)) as dp_device:
        return _main(cfg, args, device if dp_device is None else dp_device,
                     is_writer())


def _main(cfg, args, device, writer):
    from .parallel.pipeline import (model_devices_for, stage_count,
                                    uses_pipeline)
    # the pipelined step's cards, refused before anything is built when
    # the host has too few
    model_devices = (model_devices_for(device, stage_count(cfg))
                     if uses_pipeline(cfg) else None)
    from .data import build_dataset
    from .models import build_model
    from .utils.logging import create_logger
    _, final_output_dir, _ = create_logger(cfg, args.cfg, "train",
                                           write=writer)
    logger.info(f"device: {device}"
                + (f" ({torch.cuda.get_device_name(device)})"
                   if device.type == "cuda" else ""))
    set_cudnn(cfg)
    model = build_model(cfg, device=device, train=True)
    train_ds = build_dataset(cfg, is_train=True)
    val_ds = build_dataset(cfg, is_train=False)
    # a SIGTERM (a reclaimed machine, `kill -TERM`) checkpoints at the
    # next step boundary and returns; AUTO_RESUME goes on from there
    from .utils.preemption import PreemptionGuard
    guard = PreemptionGuard()
    try:
        return run(cfg, model, train_ds, val_ds, final_output_dir, device,
                   guard=guard, model_devices=model_devices)
    finally:
        guard.restore()


class RSNSchedule(NamedTuple):
    """How long an RSN trains and at what LR."""
    max_iters: int
    ckpt_period: int          # 0: no iteration checkpoints (epoch mode)
    base_lr: float
    warmup_iters: int


def rsn_schedule(cfg, steps_per_epoch: int, n_dev: int = 1) -> RSNSchedule:
    """RSN's schedule on ``n_dev`` cards (``tools/train.py:157-183``).
    Iteration mode (``TRAIN.MAX_ITER`` > 0) scales the
    ``ITER_BASELINE_DEVICES``-device recipe to ``n_dev`` devices: the
    iteration count and checkpoint period by ``ITER_BASELINE_DEVICES /
    n_dev``, the LR up by ``n_dev`` (RSN train.py:36-38, solver.py:11),
    the warmup ``WARMUP_ITERS``.  Epoch mode: ``steps_per_epoch ·
    END_EPOCH`` steps at ``LR``, a warmup of min(1000,
    steps_per_epoch)."""
    t = cfg.TRAIN
    if t.MAX_ITER > 0:
        scale = t.ITER_BASELINE_DEVICES / n_dev
        return RSNSchedule(max(int(t.MAX_ITER * scale), 2),
                           max(int(t.CHECKPOINT_PERIOD * scale), 1),
                           t.LR * n_dev, t.WARMUP_ITERS)
    return RSNSchedule(max(steps_per_epoch * t.END_EPOCH, 2), 0, t.LR,
                       min(1000, steps_per_epoch))


def infinite_batches(dataset, batch_size, shuffle, epoch_batches,
                     group_ids=None, skip=0, shard_index=0, num_shards=1):
    """RSN's endless batch stream (the IterationBasedBatchSampler, cvpack
    iteration_based_batch_sampler.py:5-31): epoch ``p`` = 0, 1, ... in
    turn, each its epoch-seeded plan through ``epoch_batches(p)``; yields
    (epoch, step in epoch, batch).  ``skip`` goes past the batches a
    preempted run took (``tools/train.py:342-375``): whole epochs by the
    plan sizes alone, with no sample built (each epoch's generators are
    seeded anew, so nothing is lost), the partial epoch by building its
    prefix and throwing it away, so that the draws of the in-process
    loader's one generator replay and the stream goes on as the
    uninterrupted run's.  ``batch_size`` and the plans are this shard's
    of ``num_shards`` (a pipelined step's plans are as long).
    Raises when an epoch's plan holds no batch."""
    from .data.base import epoch_plan_size
    p = 0
    while True:
        size = epoch_plan_size(dataset, batch_size, shuffle=shuffle, seed=p,
                               group_ids=group_ids, shard_index=shard_index,
                               num_shards=num_shards)
        if not size:
            raise RuntimeError(
                f"epoch {p} produced no batches (dataset size "
                f"{len(dataset)} < batch {batch_size}?)")
        if skip >= size:
            skip -= size
            p += 1
            continue
        batches = epoch_batches(p)
        try:
            for j, batch in enumerate(batches):
                if j >= skip:
                    yield p, j, batch
        finally:
            _close(batches)
        skip = 0
        p += 1


def _close(batches):
    """Stop a loader early: the prefetch thread and the worker processes
    shut down now, not when the generator is collected."""
    close = getattr(batches, "close", None)
    if close is not None:
        close()


def run(cfg, model, train_ds, val_ds, out_dir, device="cuda", guard=None,
        model_devices=None):
    """Train ``model`` (from ``build_model(cfg, train=True)``) on
    ``train_ds`` and validate it on ``val_ds``: for epochs
    ``TRAIN.BEGIN_EPOCH`` to ``TRAIN.END_EPOCH``, validating after each
    and rolling the checkpoint, or, for an RSN with ``TRAIN.MAX_ITER`` >
    0, for the iterations of :func:`rsn_schedule` over endless
    epoch-seeded batches (:func:`infinite_batches`), with an iteration
    checkpoint every checkpoint period and after the last iteration, then
    one validation.  With ``WORKERS`` > 0 the batches come from that many
    worker processes (:mod:`.data.worker_loader`, augmentation seeded per
    record) through the pinned one-ahead upload of :mod:`.data.prefetch`;
    else, or with ``ASPECT_RATIO_GROUPING``, they are built in this
    process.

    ``DATASET.DEVICE_AUG`` (not for RSN): the loaders build raw samples
    on ``DATASET.DEVICE_AUG_CANVAS`` canvases (:class:`.data.
    device_pipeline.RawSampleView`), uploaded as uint8; on the device,
    step ``i`` of epoch ``e`` draws its augmentation from a generator
    seeded by (1234, e, i) alone and crops, masks and encodes the targets
    there (:func:`.data.device_pipeline.step_draws`), each rank of a
    data-parallel run the global batch's draws, its rows taken; the
    train-time PCK reads these targets and ``DEBUG.DEBUG`` writes no
    train images.  Validation is unchanged.

    ``MODEL.PRETRAINED`` is grafted onto ``model`` first
    (:func:`.utils.checkpoint.load_pretrained`).  ``AUTO_RESUME`` restores
    the model, the optimizer, the scheduler and the step from the
    rolling checkpoint (``TPU.CKPT_BACKEND``: ``checkpoint.pth``, or the
    latest ``orbax/<step>/``) or from ``iter-last.pth``, and goes on from
    the epoch (and step in it) or iteration after the saved one.
    ``guard`` (a :class:`.utils.preemption.PreemptionGuard`) is polled
    after every step: once it says stop, the run saves a checkpoint to go
    on from (in epoch mode a mid-epoch one), closes its loaders and
    returns, with no validation and no ``final_state.pth``.

    Returns a record of the run: per step its epoch, step in the epoch,
    iteration, loss, LR, the seconds spent waiting for the batch
    (``load_s``) and the whole iteration (``iter_s``, host clock; no
    per-step synchronise); per validation its seconds, crop count and
    AP; the last ``name_values``, the best AP, the checkpoints written
    and whether the guard stopped the run (``preempted``).

    In a ``torch.distributed`` process group (:func:`main` under
    ``torchrun``) the run is data-parallel over the group's ranks, each
    on its own ``device``: a global batch of ``TRAIN.BATCH_SIZE_PER_GPU``
    × world rows, each rank loading its shard (``TPU.MESH.DATA`` -1 or
    the world size), the BatchNorm statistics of the global batch and
    the gradients averaged (:func:`..parallel.data_parallel`); RSN's
    iteration mode scales by the world size (:func:`rsn_schedule`); the
    guard is polled over every rank at ``PRINT_FREQ`` steps; validation
    decodes a shard a rank and gathers; rank 0 alone writes files, and
    every rank loads a checkpoint it resumes from.

    ``TPU.PP`` on an RSN over a ``TPU.MESH.MODEL`` of ``STAGE_NUM``
    (:func:`.parallel.pipeline.uses_pipeline`): ``model``'s stem and
    stages move onto ``model_devices`` (default: ``STAGE_NUM`` cards from
    ``device`` on, or the CPU that many times; a list may repeat a card)
    and the step is the GPipe step of :mod:`.parallel.pipeline` with
    ``TPU.PP_MICROBATCHES`` microbatches; in a process group each rank
    drives its own ``model_devices``, loads its rows of every microbatch
    and averages gradients and stage running stats over one group a
    model index.  Validation, checkpoints and weight files are those of
    the plain RSN.  Any other model on a model axis > 1 trains the plain
    step on ``device``."""
    from .core.accuracy import pck_accuracy
    from .core.loss import make_loss_fn
    from .core.rsn import (RSN_BATCH_KEYS, create_rsn_train_state,
                           make_rsn_train_step, upload_rsn_batch)
    from .core.infer import normalize_images
    from .core.train import create_train_state, make_train_step, upload_batch
    from .core.validate import serving_copy, validate
    from .data.base import aspect_ratio_group_ids, epoch_loader
    from .data.prefetch import device_prefetch
    from .data.worker_loader import worker_loader
    from .models import build_model
    from .parallel import (data_axis_size, data_parallel, is_writer,
                           process_shard_info)
    from .parallel import pipeline as pp
    from .utils import checkpoint as ckpt
    from .utils.logging import AverageMeter, print_name_value
    from .utils.platform import resolve_device
    from .utils.vis import save_debug_images

    check_parallel_config(cfg)
    is_rsn = cfg.MODEL.NAME == "rsn"
    if cfg.DATASET.DEVICE_AUG and is_rsn:
        raise ValueError("DATASET.DEVICE_AUG covers the deep_hrnet "
                         "pipeline (gaussian/offset targets); the RSN "
                         "multi-kernel label pyramid still builds on "
                         "the host: unset DEVICE_AUG for rsn")
    device = resolve_device(device)
    n_dev = data_axis_size(cfg)
    shard_index, num_shards = process_shard_info()
    writer = is_writer()
    pipelined = pp.uses_pipeline(cfg)
    n_micro, train_device = 1, device
    if pipelined:
        n_stages = pp.stage_count(cfg)
        n_micro = int(cfg.TPU.PP_MICROBATCHES)
        model_devices = ([resolve_device(d) for d in model_devices]
                         if model_devices is not None
                         else pp.model_devices_for(device, n_stages))
        pp.place_stages(model, model_devices)
        train_device = next(model.top.parameters()).device
        global_rows = cfg.TRAIN.BATCH_SIZE_PER_GPU * n_dev
        if global_rows % (n_micro * n_dev):
            raise ValueError(f"batch {global_rows} not divisible by "
                             f"n_micro*n_data={n_micro * n_dev}")
        logger.info(f"=> pipeline-parallel over {n_stages} stages "
                    f"({n_micro} microbatches) on "
                    f"{[str(d) for d in model_devices]}")
    elif cfg.TPU.MESH.MODEL > 1:
        logger.info(f"TPU.MESH.MODEL {cfg.TPU.MESH.MODEL}: the plain step of "
                    f"{cfg.MODEL.NAME} does not use the model axis; its "
                    f"other {cfg.TPU.MESH.MODEL - 1} card(s) a rank go "
                    "unused")
    if cfg.MODEL.INIT_WEIGHTS and cfg.MODEL.PRETRAINED:
        # the reference's model.init_weights(PRETRAINED) (tools/train.py:
        # 91-116): a partial or backbone-only file onto the fresh init
        n = ckpt.load_pretrained(model, cfg.MODEL.PRETRAINED, cfg)
        logger.info(f"=> loaded pretrained {cfg.MODEL.PRETRAINED} "
                    f"({n} leaves)")
    # this rank loads its share of the global batch over every rank
    batch_size = cfg.TRAIN.BATCH_SIZE_PER_GPU
    global_batch = batch_size * n_dev
    steps_per_epoch = max(len(train_ds) // global_batch, 1)
    if num_shards > 1:
        logger.info(f"data parallel: rank {shard_index} of {num_shards}, "
                    f"global batch {global_batch}, local {batch_size}")
    sched = None
    if is_rsn:
        sched = rsn_schedule(cfg, steps_per_epoch, n_dev)
        state = create_rsn_train_state(cfg, model, sched.base_lr,
                                       sched.max_iters, sched.warmup_iters)
        if pipelined:
            groups = (pp.PipelineGroups(model_devices)
                      if dist.is_initialized() else None)
            if groups is not None:
                pp.data_parallel_stages(model, groups)
            step_fn = pp.make_pipelined_rsn_train_step(
                cfg, model_devices, n_micro, ohkm=cfg.LOSS.USE_OHKM,
                topk=cfg.LOSS.TOPK, groups=groups)
        else:
            step_fn = make_rsn_train_step(
                cfg.MODEL.EXTRA.get("STAGE_NUM", 1), ohkm=cfg.LOSS.USE_OHKM,
                topk=cfg.LOSS.TOPK)
        upload, keys = upload_rsn_batch, ("image",) + RSN_BATCH_KEYS
    else:
        state = create_train_state(cfg, model, steps_per_epoch)
        step_fn = make_train_step(make_loss_fn(cfg), with_output=True)
        upload, keys = upload_batch, ("image", "target", "target_weight")
    device_augment, train_iter_ds = None, train_ds
    if cfg.DATASET.DEVICE_AUG:
        # the host only decodes onto a canvas; the crop, the augmentation,
        # AID and the targets run on the device (tools/train.py:102-118)
        from .data import device_pipeline as dp
        canvas_w, canvas_h = cfg.DATASET.DEVICE_AUG_CANVAS
        canvas_hw = (int(canvas_h), int(canvas_w))
        device_augment = dp.make_device_augment(
            cfg, train_ds.num_joints, train_ds.flip_pairs,
            train_ds.upper_body_ids, canvas_hw)
        train_iter_ds = dp.RawSampleView(train_ds, canvas_hw)
        keys = dp.CANVAS_KEYS
        logger.info(f"=> on-device augmentation (canvas {canvas_hw}, host "
                    "residue = decode + pad)")

        def upload(batch, device, epoch, i):
            raw = dp.upload_raw(batch, device)
            draws = dp.step_draws(device_augment, epoch, i, global_batch,
                                  device, shard_index, num_shards)
            images, target, weight = device_augment(raw, draws)
            return {"image": normalize_images(images), "target": target,
                    "target_weight": weight}
    else:
        host_upload = upload

        def upload(batch, device, epoch, i):
            return host_upload(batch, device)
    if dist.is_initialized() and not pipelined:
        # a process group: the step runs through DDP with the global
        # batch's BatchNorm, every rank from rank 0's tensors
        state.ddp = data_parallel(state.model)
    iter_mode = is_rsn and cfg.TRAIN.MAX_ITER > 0
    eval_model = build_model(cfg, device=device)
    # QAT validates through the fake-quant grid too; the wrapper shares
    # eval_model's tensors, which serving_copy refreshes each validation
    eval_net = eval_model
    if cfg.TPU.QAT == "int8":
        from .models.quantize import FakeQuantModel
        eval_net = FakeQuantModel(eval_model)
        logger.info("=> QAT int8: training through the fake-quant grid")
    # the rolling checkpoint: checkpoint.pth written in this thread, or
    # the asynchronous backend with retention (utils/orbax_ckpt.py)
    backend = None
    if cfg.TPU.CKPT_BACKEND == "orbax":
        from .utils.orbax_ckpt import OrbaxBackend
        backend = OrbaxBackend(out_dir, max_to_keep=cfg.TPU.CKPT_MAX_TO_KEEP)
        logger.info("=> orbax-role checkpoint backend (asynchronous "
                    f"commit, {cfg.TPU.CKPT_MAX_TO_KEEP} kept)")
    elif cfg.TPU.CKPT_BACKEND != "msgpack":
        raise ValueError(f"unknown TPU.CKPT_BACKEND "
                         f"{cfg.TPU.CKPT_BACKEND!r}")

    def resume(iter_mode):
        if backend is not None:
            from .utils.orbax_ckpt import load_any
            return load_any(backend, model, state, iter_mode, device)
        if iter_mode:
            return ckpt.load_iter_checkpoint(out_dir, model, state, device)
        return ckpt.load_checkpoint(out_dir, model, state, device)

    group_ids = (aspect_ratio_group_ids(train_ds)
                 if cfg.DATASET.ASPECT_RATIO_GROUPING else None)
    # WORKERS > 0: worker processes and the pinned prefetch, as the JAX
    # package's grain loader; grouped batches keep the in-process loader
    # (tools/train.py:285-299)
    workers = cfg.WORKERS > 0 and group_ids is None
    if cfg.WORKERS > 0 and not workers:
        logger.warning("ASPECT_RATIO_GROUPING needs the in-process loader; "
                       "ignoring WORKERS > 0 for grouping")

    def epoch_batches(epoch):
        if workers:
            return device_prefetch(
                worker_loader(train_iter_ds, batch_size, seed=epoch,
                              shuffle=cfg.TRAIN.SHUFFLE,
                              num_workers=cfg.WORKERS,
                              shard_index=shard_index,
                              num_shards=num_shards,
                              as_tensors=device_augment is not None,
                              n_micro=n_micro),
                train_device, keys=keys)
        train_iter_ds.seed(epoch)
        return epoch_loader(train_iter_ds, batch_size,
                            shuffle=cfg.TRAIN.SHUFFLE,
                            seed=epoch, group_ids=group_ids,
                            shard_index=shard_index, num_shards=num_shards,
                            n_micro=n_micro)

    def stop(i):
        # over several ranks the flag is OR-reduced (a collective every
        # rank reaches) at the steps that already wait for the card
        return guard is not None and guard.should_stop(
            num_shards, sync=i % cfg.PRINT_FREQ == 0)

    record = {"steps": [], "validations": [], "best_perf": 0.0,
              "name_values": None, "checkpoints": [], "preempted": False}

    def validated(epoch):
        t0 = time.perf_counter()
        serving_copy(model, eval_model)
        name_values, perf = validate(cfg, val_ds, eval_net,
                                     out_dir if writer else "",
                                     shard_index=shard_index,
                                     num_shards=num_shards)
        record["validations"].append({
            "epoch": epoch, "seconds": time.perf_counter() - t0,
            "crops": len(val_ds), "perf": perf})
        print_name_value(logger, name_values, cfg.MODEL.NAME)
        record["name_values"] = name_values
        return perf

    def stepped(epoch, i, iteration, batch, t_iter):
        """One train step and its record entry, whose ``iter_s`` the
        caller sets at the end of the iteration; returns the metrics and
        the step's device batch."""
        t_loaded = time.perf_counter()
        lr = state.optimizer.param_groups[0]["lr"]
        device_batch = upload(batch, train_device, epoch, i)
        metrics = step_fn(state, device_batch)
        record["steps"].append({
            "epoch": epoch, "step": i, "iteration": iteration,
            "loss": metrics["loss"], "lr": lr, "load_s": t_loaded - t_iter})
        return metrics, device_batch

    def rows(batch):
        return len(batch["image" if device_augment is None else "canvas"])

    def iteration_ended(t_iter):
        t_end = time.perf_counter()
        record["steps"][-1]["iter_s"] = t_end - t_iter
        return t_end

    if iter_mode:
        # iteration-based RSN training (tools/train.py:320-420)
        logger.info(f"iteration mode: {sched.max_iters} iters (x"
                    f"{cfg.TRAIN.ITER_BASELINE_DEVICES / n_dev:g} of "
                    f"{cfg.TRAIN.MAX_ITER}), lr {sched.base_lr}, ckpt every "
                    f"{sched.ckpt_period}")

        def save_iter(it):
            if backend is not None:
                path = backend.save(model, state, {"iteration": int(it)})
            else:
                path = ckpt.save_iter_checkpoint(out_dir, model, state, it)
            record["checkpoints"].append(path)

        start_iter = resume(True) if cfg.AUTO_RESUME else 0
        if start_iter:
            logger.info(f"=> resumed at iteration {start_iter}")
        stream = infinite_batches(train_ds, batch_size, cfg.TRAIN.SHUFFLE,
                                  epoch_batches, group_ids, skip=start_iter,
                                  shard_index=shard_index,
                                  num_shards=num_shards)
        loss_sum = None
        t_iter = time.perf_counter()
        try:
            for it in range(start_iter, sched.max_iters):
                epoch, i, batch = next(stream)
                step_loss = stepped(epoch, i, it, batch, t_iter)[0]["loss"]
                # summed on the device: no per-step wait for the card
                loss_sum = (step_loss if loss_sum is None
                            else loss_sum + step_loss)
                if it % cfg.PRINT_FREQ == 0:
                    secs = max(time.perf_counter() - t_iter, 1e-9)
                    logger.info(
                        f"Iter [{it}/{sched.max_iters}] Speed "
                        f"{rows(batch) / secs:.1f}/s Loss "
                        f"{float(step_loss):.4f} (avg "
                        f"{float(loss_sum) / (it - start_iter + 1):.4f}) lr "
                        f"{record['steps'][-1]['lr']:.6g} ETA "
                        f"{(sched.max_iters - it) * secs / 3600:.2f}h")
                if (it + 1) % sched.ckpt_period == 0:
                    save_iter(it)
                t_iter = iteration_ended(t_iter)
                if stop(it):
                    save_iter(it)
                    record["preempted"] = True
                    logger.info(f"=> preempted: saved iteration checkpoint "
                                f"{it}; exiting")
                    break
        finally:
            stream.close()
        if not record["preempted"]:
            save_iter(sched.max_iters - 1)
            record["best_perf"] = validated(record["steps"][-1]["epoch"])
    else:
        begin_epoch, best_perf, resume_skip = cfg.TRAIN.BEGIN_EPOCH, 0.0, 0
        if cfg.AUTO_RESUME:
            resumed = resume(False)
            if resumed != (0, 0.0, 0):
                begin_epoch, best_perf, resume_skip = resumed
                logger.info(f"=> resumed at epoch {begin_epoch}" + (
                    f" step {resume_skip} (mid-epoch preemption save)"
                    if resume_skip else ""))
        for epoch in range(begin_epoch, cfg.TRAIN.END_EPOCH):
            loss_sum, loss_cnt = None, 0
            acc_meter = AverageMeter()
            skip = resume_skip if epoch == begin_epoch else 0
            batches = epoch_batches(epoch)
            t_iter = time.perf_counter()
            try:
                for i, batch in enumerate(batches):
                    if i < skip:
                        # a mid-epoch resume replays the epoch through
                        # the loader the run uses and throws away the
                        # batches the saved run took: the worker
                        # loader's (WORKERS > 0) are seeded per record
                        # and would come out the same unbuilt, but the
                        # in-process loader draws each epoch's samples
                        # from one generator, whose draws must replay
                        # for the continuation to be exact
                        continue
                    metrics, device_batch = stepped(epoch, i, state.step,
                                                    batch, t_iter)
                    step_loss = metrics["loss"]
                    loss_sum = (step_loss if loss_sum is None
                                else loss_sum + step_loss)
                    loss_cnt += 1
                    if i % cfg.PRINT_FREQ == 0:
                        if not is_rsn:
                            # train-time PCK@0.5 on the heatmap argmax,
                            # against the device targets under DEVICE_AUG
                            hm = metrics["output"].detach().cpu().numpy()
                            tgt = torch.as_tensor(
                                device_batch["target"]).cpu().numpy()
                            if cfg.MODEL.TARGET_TYPE == "offset":
                                hm, tgt = hm[:, ::3], tgt[:, ::3]
                            _, avg_acc, cnt, pred = pck_accuracy(hm, tgt)
                            acc_meter.update(avg_acc, cnt)
                            if (cfg.DEBUG.DEBUG and writer
                                    and device_augment is None):
                                save_debug_images(
                                    cfg, batch["image"], batch["joints"],
                                    batch["joints_vis"], tgt, hm,
                                    os.path.join(out_dir,
                                                 f"train_{epoch}_{i}"),
                                    pred_joints=pred * 4)
                        speed = rows(batch) / max(
                            time.perf_counter() - t_iter, 1e-9)
                        logger.info(
                            f"Epoch [{epoch}][{i}/{steps_per_epoch}] "
                            f"Speed {speed:.1f}/s Loss "
                            f"{float(step_loss) * 1e5:.1f}e-5 (avg "
                            f"{float(loss_sum) / loss_cnt * 1e5:.1f}e-5) "
                            f"Acc {acc_meter.val:.3f} ({acc_meter.avg:.3f})")
                    t_iter = iteration_ended(t_iter)
                    if stop(i):
                        record["preempted"] = True
                        break
            finally:
                _close(batches)
            if record["preempted"]:
                # the state has taken i + 1 batches of this epoch: a
                # resume begins it again and skips them
                meta = {"epoch": epoch - 1, "perf": best_perf,
                        "step_in_epoch": i + 1}
                if backend is not None:
                    record["checkpoints"].append(
                        backend.save(model, state, meta))
                else:
                    ckpt.save_checkpoint(out_dir, model, state, **meta)
                    record["checkpoints"].append(
                        os.path.join(out_dir, ckpt.CHECKPOINT))
                logger.info(f"=> preempted: saved mid-epoch checkpoint "
                            f"(epoch {epoch} step {i + 1}); exiting")
                break
            perf = validated(epoch)
            # the reference rolls the epoch's AP as "perf" (not the best),
            # and a resume takes it as the best so far
            best = perf > best_perf
            best_perf = max(best_perf, perf)
            if backend is not None:
                record["checkpoints"].append(backend.save(
                    model, state, {"epoch": epoch, "perf": perf}))
                if best:
                    ckpt.save_weights(os.path.join(out_dir,
                                                   "model_best.pth"), model)
            else:
                ckpt.save_checkpoint(out_dir, model, state, epoch, perf,
                                     is_best=best)
                record["checkpoints"].append(
                    os.path.join(out_dir, ckpt.CHECKPOINT))
        record["best_perf"] = best_perf
    if not record["preempted"]:
        ckpt.save_weights(os.path.join(out_dir, "final_state.pth"), model)
        logger.info(f"=> saved final state to {out_dir}")
    if backend is not None:
        backend.wait()
    record["steps"] = [dict(s, loss=float(s["loss"]))
                       for s in record["steps"]]
    return record


if __name__ == "__main__":
    main()
